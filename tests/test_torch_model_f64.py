"""Which side strays from float64 in the paper models' forward, on the CPU.

``tests/test_torch_model.py::test_forward_loss_grads_match_reference`` holds
the port's float32 logits to the reference's at rtol 1e-5 / atol 1e-6. Here
the port's forward runs in float64 at full width (the reference's own
initial parameters, converted, and the same numpy batch), and each float32
side is held to it: the port's logits and the reference's, each within half
of that parity limit of the float64 logits. Half and half add up to the
parity limit, so either side straying past its half shows here first, and
names the side. The port's CPU convolution runs through ATen's native
im2col-and-GEMM path (``models/member_math.MemberConv2d``): through oneDNN,
CIFAR-100's logits sat at 0.92 of the limit from float64 on one torch
thread, the reference's at 0.37. Run as a script, this file prints those
shares (``python tests/test_torch_model_f64.py``, with ``PYTHONPATH=src``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget
from repro.models import model as RM
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.models import model as TM
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6    # test_forward_loss_grads_match_reference's
MODELS = ["paper-synthetic-mlp", "paper-mnist-cnn", "paper-fmnist-linear",
          "paper-cifar10-cnn", "paper-cifar100-cnn"]


def _logits(name):
    """(reference f32, port f32, port float64) logits of ``name`` at full
    width on the reference's own init and a numpy batch of 12."""
    rcfg, tcfg = rget(name), tget(name)
    rp = RM.init_params(jax.random.PRNGKey(3), rcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, rp))
    rng = np.random.RandomState(0)
    shape = (12,) + (tuple(rcfg.input_hw) if rcfg.family == "cnn"
                     else (rcfg.input_hw[0],))
    x = rng.randn(*shape).astype(np.float32)
    fwd = RM.cnn_forward if rcfg.family == "cnn" else RM.mlp_forward
    ref32 = np.asarray(fwd(rp, jnp.asarray(x), rcfg), np.float64)
    port32 = TM.forward(tp, torch.from_numpy(x), tcfg).double().numpy()
    tp64 = {k: {kk: leaf.double() for kk, leaf in v.items()}
            for k, v in tp.items()}
    exact = TM.forward(tp64, torch.from_numpy(x).double(), tcfg)
    assert exact.dtype == torch.float64
    return ref32, port32, exact.numpy()


@pytest.mark.parametrize("name", MODELS)
def test_float32_logits_each_within_half_the_parity_limit(name):
    ref32, port32, exact = _logits(name)
    half = 0.5 * (RTOL * np.abs(exact) + ATOL)
    shares = {side: float((np.abs(got - exact) / half).max())
              for side, got in (("port", port32), ("reference", ref32))}
    assert max(shares.values()) <= 1.0, shares
    assert shares["port"] > 0


def _report():
    """Print, on one torch thread and on the default count, each side's
    worst logit as a share of the full parity limit from float64, the
    port's share against the reference's logits, and the port's share with
    its CPU convolution through oneDNN instead, for comparison."""
    import torch.nn.functional as F

    def onednn_conv(x, w, groups=1, padding=0):
        with torch.backends.mkldnn.flags(enabled=True):
            return F.conv2d(x, w, padding=padding, groups=groups)

    def share(got, want):
        return float((np.abs(got - want)
                      / (RTOL * np.abs(want) + ATOL)).max())

    for threads in (1, torch.get_num_threads()):
        torch.set_num_threads(threads)
        for name in MODELS:
            ref32, port32, exact = _logits(name)
            native = TM.member_conv2d
            TM.member_conv2d = onednn_conv
            try:
                onednn = _logits(name)[1]
            finally:
                TM.member_conv2d = native
            print(f"{threads} thread(s) {name}: share of the parity limit "
                  f"from float64: reference {share(ref32, exact):.3f}, port "
                  f"{share(port32, exact):.3f} (through oneDNN "
                  f"{share(onednn, exact):.3f}); port against reference "
                  f"{share(port32, ref32):.3f} (through oneDNN "
                  f"{share(onednn, ref32):.3f})")


if __name__ == "__main__":
    _report()
