"""``fed-lm-ssm-smoke`` through ``run_algorithm``, port against a live
reference run, on the CPU.

fedasync and fedpsa on the fed-lm world (``tests/torch_fedlm_families.py``:
240 sequences of 16 tokens, 6 clients, horizon 2,000), from the
reference's legacy-threefry init: the port on the three engine settings
(sequential; cohort with ``member_kernel`` "vmap" and "grouped") against
the reference's sequential run at the golden suite's ``RTOL=1e-4,
ATOL=1e-3``, versions, dispatches, dropped and launched exact; the
committed init and digest fixtures against the reference.
"""
import numpy as np
import pytest

from repro.launch.train import build_task as r_build_task
from repro_torch.convert import load_npz_params, params_to_numpy
from repro_torch.core.psa import PSAConfig
from repro_torch.federated.simulator import SimConfig, run_algorithm
from repro_torch.launch.train import build_task as t_build_task
from torch_fedlm_families import (ENGINES, PSA, POLICIES, SIM, build_world,
                                  check_fixture, check_run, init_path,
                                  reference_init, reference_run)
from torch_threads import one_torch_thread  # noqa: F401

FAMILY = "ssm"


@pytest.fixture(scope="module")
def live():
    world = build_world(r_build_task, FAMILY)
    return {name: reference_run(FAMILY, name, world) for name in POLICIES}


@pytest.fixture(scope="module")
def port_world():
    return build_world(t_build_task, FAMILY)


def test_init_fixture_is_the_reference_init():
    got = params_to_numpy(load_npz_params(init_path(FAMILY)))
    want = reference_init(FAMILY)

    def walk(g, w, path):
        assert set(g) == set(w), path
        for k in w:
            if isinstance(w[k], dict):
                walk(g[k], w[k], path + (k,))
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=str(path))

    walk(got, want, ())


@pytest.mark.parametrize("name", POLICIES)
def test_fixture_is_the_reference_run(live, name):
    check_fixture(FAMILY, name, live[name])


@pytest.mark.parametrize("engine,mk", ENGINES)
@pytest.mark.parametrize("name", POLICIES)
def test_fed_lm_ssm_matches_live_reference(live, port_world, name, engine,
                                           mk):
    cfg, clients, test, calib = port_world
    kw = (dict(psa_cfg=PSAConfig(**PSA), calib_batch=calib)
          if name == "fedpsa" else {})
    res = run_algorithm(name, cfg, load_npz_params(init_path(FAMILY)),
                        clients, test,
                        SimConfig(device="cpu", engine=engine,
                                  member_kernel=mk, record_trajectory=True,
                                  **SIM), **kw)
    assert res.engine == engine and res.local_steps > 0
    if engine == "cohort":
        assert res.cohorts > 0
    check_run(res, live[name])
