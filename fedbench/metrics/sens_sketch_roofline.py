"""``sens_sketch``'s share of its roofline, in %: the least time the
window's sketch rows need (each row's bound by the frozen cost, the INT32
pipe's for the CNNs) over the kernel's summed device time. Rows: every
lane's client updates, its aggregations and its initial global model."""
from fedbench import arith
from fedbench.trace import kernel_seconds


def read(rec):
    tr, mix = rec["trace"], rec["mix"]
    if tr is None or mix["policy"] != "fedpsa":
        return None
    secs = kernel_seconds(tr, "sens_sketch")
    if secs <= 0.0:
        return None
    rows = sum(s["lanes"] * (s["dispatches"] + s["versions"] + 1)
               for s in rec["sims"])
    per_row = arith.bound_s(arith.sens_sketch_cost(
        1, rec["cfg"]["d"], mix["psa"]["sketch_k"]))
    return 100.0 * rows * per_row / secs
