"""PyTorch/CUDA port of the FedPSA reproduction (``repro`` is the JAX reference).

The package mirrors ``repro``'s module names and namespaces
(``repro_torch.federated``, ``core``, ``common``, ``kernels``,
``checkpoint``, ``data``, and ``models`` with ``ssm`` and ``moe``). It imports ``torch`` and ``numpy`` only: the
numpy host layers it needs (data generation, the event timeline, latency
and scheduling) are its own copies, pinned to the reference output for
output by ``tests/test_torch_*.py``.

What runs, on one H100 by default (``device="cpu"`` runs the kernels'
plain versions): ``federated.run_algorithm`` for synchronous FedAvg and
the seven async policies on the paper's image models and on the token LM
families (dense, moe, ssm and hybrid: ``fed-lm-smoke``, its ssm and moe
siblings and the assigned configs, with a sliding window and ``remat`` none, full or dots), on the sequential and the cohort
engines, over streamed client populations, with checkpoint/resume;
``federated.run_sweep``'s lanes; the mesh-sharded server with
data-parallel waves over ``torch.distributed`` (``SimConfig.mesh``); and
the LMs' prefill and decode (``launch.serve``), the vision and audio
frontends; the legacy class-based servers (``federated.legacy``); and the
reference's examples as ``python -m repro_torch.examples.<name>``
(quickstart, paper_protocol, pretrain_lm). The reference's four Pallas
kernels and the attention backward are hand-written CUDA C++ for Hopper
(``csrc/``). The dry-run and cost tooling runs on the CPU with no card:
the production meshes and their per-architecture rules
(``launch.mesh.rules_for``), the assigned input shapes
(``configs.shapes``), and ``launch.dryrun``, which traces every step on
meta tensors laid out on the mesh and counts its per-device cost op by op
(``launch.op_cost``, in place of the reference's HLO cost analysis).
"""
