"""Model FLOPs of the window's local SGD over the traced window's seconds
at the H100's float32 peak, in %: three forward passes' FLOPs of every
sample a client trained on (drop-last batches; padding members and rows,
FedPSA's sketch passes and evaluation not counted), at the published
shapes' per-sample forward FLOPs."""
from fedbench import arith


def read(rec):
    tr = rec["trace"]
    if tr is None or tr["busy_s"] <= 0.0:
        return None
    w = rec["cfg"]["world"]
    sizes = rec["sizes"]
    samples = sum(s["lanes"] * arith.trained_samples(
        int(sizes[c]), int(w["local_epochs"]), int(w["batch_size"]))
        for s in rec["sims"] for _, _, c in s["receive_log"])
    flops = 3.0 * arith.forward_flops_per_sample(rec["cfg"]) * samples
    return 100.0 * flops / (tr["window_s"] * arith.F32_FLOPS_PER_S)
