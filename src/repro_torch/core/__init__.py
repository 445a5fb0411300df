"""FedPSA's core in the port: sensitivity (Eq. 3-8), sketch (Eq. 11-15),
thermometer (Eq. 16-18), aggregation (Eq. 19-20 and the baselines'
staleness functions) and psa (Algorithm 1).

The sensitivity function is exported as ``compute_sensitivity`` only: the
bare name stays the submodule ``core.sensitivity``, which callers import.
The ``psa`` names load on first use: ``core.psa`` imports ``kernels.ops``,
which imports ``core.sketch``, so an eager import here would close that
cycle whenever ``kernels.ops`` is imported first.
"""
from repro_torch.core.sensitivity import (
    first_order_sensitivity,
    fisher_diagonal,
    sensitivity as compute_sensitivity,
    sensitivity_from_parts,
)
from repro_torch.core.sketch import (
    DEFAULT_K,
    cosine,
    dense_projection,
    pcg_hash,
    rademacher_row,
    sketch_leaf,
    sketch_tree,
)
from repro_torch.core.thermometer import (
    ThermometerState,
    current_mean,
    init_thermometer,
    is_full,
    push,
    temperature,
)
from repro_torch.core.aggregation import (
    aggregate_buffer,
    aggregate_flat,
    psa_weights,
    staleness_constant,
    staleness_hinge,
    staleness_polynomial,
    uniform_weights,
)
_PSA_NAMES = ("PSAConfig", "PSAInfo", "PSAState", "buffer_full",
              "client_sketch", "init_state", "server_aggregate",
              "server_receive", "server_step")


def __getattr__(name: str):
    if name in _PSA_NAMES:
        from repro_torch.core import psa
        return getattr(psa, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
