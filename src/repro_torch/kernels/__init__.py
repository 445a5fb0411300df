"""The port's hand-written CUDA C++ kernels for Hopper (``csrc/``), one
module each, every wrapper beside its plain-torch version:

* ``sens_sketch``     — Eq. 8 sensitivity with the on-the-fly Rademacher
  sketch (``sens_sketch``, ``sens_sketch_rows``; ``*_plain``)
* ``buffer_agg``      — the Eq. 20 buffered apply (``buffer_agg``)
* ``flash_attention`` — causal GQA attention forward and backward
  (``flash_attention``, ``flash_attention_bwd``)
* ``grouped_matmul``  — the cohort's member GEMMs (``grouped_matmul``)

``ops`` holds the tree-level entry points and the launch counts. A CUDA
tensor launches the kernel or raises; a CPU tensor runs the plain version.
The wrappers are not re-exported here: each one's name is its module's.
"""
from repro_torch.kernels import (buffer_agg, flash_attention, grouped_matmul,
                                 ops, sens_sketch)
