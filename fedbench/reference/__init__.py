"""The plain reference of a cell: FedPSA's asynchronous simulation written
out again in plain PyTorch and NumPy, one client update at a time.

It imports nothing of the program (``repro_torch``), nor ``jax`` nor the
JAX package ``repro``, and takes no tensor the program made: from the
benchmark's own inputs (``fedbench.world``) it works out again the event
timeline, each client's batches, the local SGD of the paper's CNN, the
FedPSA sketches and weights or FedAsync's mixing, and the global model.
"""
