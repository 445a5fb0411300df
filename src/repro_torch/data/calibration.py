"""Shared calibration batch D_b (paper §5.2 / Table 5).

The server constructs one small batch, broadcasts it once, and every client
evaluates its sensitivity on it. ``source="gaussian"`` uses pure N(0,1)
noise inputs with uniform labels; on a token dataset it draws uniform token
ids, and ``"real"`` samples held-out sequences (labels mirror the tokens;
the loss shifts them causally). A copy of the reference's
``repro.data.calibration``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.synthetic import SyntheticClassification


def make_calibration_batch(ds: SyntheticClassification, batch_size: int = 64,
                           source: str = "gaussian", seed: int = 123) -> dict:
    rng = np.random.RandomState(seed)
    if np.issubdtype(ds.x.dtype, np.integer):
        if source == "real":
            idx = rng.choice(len(ds), size=min(batch_size, len(ds)),
                             replace=False)
            toks = ds.x[idx].astype(np.int32)
        elif source == "gaussian":
            toks = rng.randint(0, ds.num_classes,
                               size=(batch_size,) + ds.x.shape[1:]
                               ).astype(np.int32)
        else:
            raise ValueError(f"unknown calibration source {source!r}")
        return {"tokens": toks, "labels": toks.copy()}
    if source == "real":
        idx = rng.choice(len(ds), size=batch_size, replace=False)
        return {"x": ds.x[idx].astype(np.float32), "y": ds.y[idx].astype(np.int32)}
    if source == "gaussian":
        shape = (batch_size,) + ds.x.shape[1:]
        return {
            "x": rng.randn(*shape).astype(np.float32),
            "y": rng.randint(0, ds.num_classes, size=batch_size).astype(np.int32),
        }
    raise ValueError(f"unknown calibration source {source!r}")
