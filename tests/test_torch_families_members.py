"""The recurrent, MoE and hybrid LMs with a member axis (the cohort
engine's wave) against the JAX reference under ``jax.vmap``, on the CPU.

``loss_fn`` with ``members=True`` and its gradient, at smoke size
(``xlstm-350m-smoke``, ``qwen2-moe-a2.7b-smoke``, ``jamba-v0.1-52b-smoke``,
``arctic-480b-smoke``), two members each with its own parameters (the
reference's init, converted) and tokens, in both member-math modes
(``"grouped"``: every ``member_dot`` site through ``grouped_matmul``'s plain
version): the per-member losses within rtol 1e-5 and the gradients within
the multi-step tolerance 1e-4 x max(1, max|ref leaf|). The member-batched
products sum in another order than the single model's, and through ten
steps of the mLSTM's exponential gates ``wq``'s gradient then sits 1.0e-5
x max(1, max|ref|) from the reference's, where the port and the reference
sit 1.3e-5 and 6.5e-6 from a float64 run of the port (xlstm-350m-smoke,
measured on the CPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.common.sharding import SINGLE_DEVICE_RULES as R
from repro.configs import get_config as rget
from repro.models import model as RM
from repro_torch.configs import get_config as tget
from repro_torch.models import member_math
from test_torch_families_grad import SMOKES, _batch, _close_tree, _port, \
    _ref_init
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("mode", ["vmap", "grouped"])
@pytest.mark.parametrize("arch", SMOKES)
def test_member_loss_and_grad_match_reference(arch, mode):
    rcfg, tcfg = rget(arch), tget(arch)
    rp = _ref_init(arch, 2, members=2)
    batch = _batch(rcfg, (2, 2, 10), 4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_l, want_g = jax.vmap(jax.value_and_grad(
        lambda p, b: RM.loss_fn(p, b, rcfg, R)))(rp, jb)
    with member_math.routing(mode):
        got_l, got_g = _port(tcfg, rp, batch, members=True)
    assert got_l.shape == (2,)
    np.testing.assert_allclose(got_l.detach().numpy(), np.asarray(want_l),
                               rtol=1e-5)
    _close_tree(got_g, want_g, tol=1e-4)
