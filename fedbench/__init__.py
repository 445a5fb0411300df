"""The benchmark of ``repro_torch``: FedPSA's asynchronous simulation on
one NVIDIA H100, in client updates (receives) per wall second.

Run from the repository root::

    python3 -m fedbench.run --workload cifar10-cnn.fedpsa --seed 7 \\
        --seconds 30 --trace 0

``BENCHMARK.json`` names the cells; each cell's configuration
(``configs/<name>.json``), traffic mix (``traffic/<name>.json``),
comparison limits (``limits/<workload>.json``) and per-layer metric readers
(``metrics/<metric>.py``) are found by those names, so a new cell, mix or
metric is a new file. Nothing here imports ``jax`` or the JAX package
``repro``; ``reference/`` imports nothing of ``repro_torch`` either.
"""
