"""PyTorch/CUDA port of the FedPSA reproduction (``repro`` is the JAX reference).

The package mirrors ``repro``'s module names. It imports ``torch`` and
``numpy`` only: the numpy host layers it needs (data generation, the event
timeline, latency and scheduling) are its own copies, pinned to the
reference output-for-output by ``tests/test_torch_*.py``.

Ported so far (see ROADMAP.md for the rest): the sequential
``run_algorithm`` for ``fedpsa`` and ``fedbuff`` on the paper's image
models, with the two Pallas kernels on that path (``buffer_agg``,
``sens_sketch``) rewritten as CUDA C++ for Hopper (``csrc/``).
"""
