"""Digests of the models that a run evaluates, for the port's tests.

``run_fedavg`` returns no digest stream of its own, and its accuracies move
in steps of one test sample, so a wrong aggregation (uniform instead of
data-size weights, a wrong prox term) can leave them unchanged. This
context manager wraps both packages' evaluation builders so that each
evaluation also records the ``(||w||_2, probe . w)`` digest of the model it
is given, in call order:

    with eval_digests() as seen:
        ...   # runs of either package
    seen["ref"], seen["port"]   # lists of [norm, probe . w]
"""
import contextlib

import numpy as np
from jax.flatten_util import ravel_pytree

from repro.federated import simulator as rsim
from repro_torch.common.tree import FlatSpec
from repro_torch.federated import simulator as tsim


def _reference_flat(params) -> np.ndarray:
    return np.asarray(ravel_pytree(params)[0], np.float32)


def _port_flat(params) -> np.ndarray:
    return FlatSpec(params).flatten(params).detach().cpu().numpy()


@contextlib.contextmanager
def eval_digests():
    seen = {"ref": [], "port": []}

    def wrap(build, key, flat):
        def wrapped(*a, **kw):
            evaluate = build(*a, **kw)

            def recorded(params):
                w = flat(params)
                seen[key].append(
                    tsim.make_digest_fn(w.size)(w[None])[0].tolist())
                return evaluate(params)

            return recorded

        return wrapped

    saved = rsim._make_eval, tsim._build_eval
    rsim._make_eval = wrap(saved[0], "ref", _reference_flat)
    tsim._build_eval = wrap(saved[1], "port", _port_flat)
    try:
        yield seen
    finally:
        rsim._make_eval, tsim._build_eval = saved
