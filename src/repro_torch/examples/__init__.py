"""End-to-end drivers of the port, run as ``python -m
repro_torch.examples.<name>`` (the reference keeps its own under
``examples/``)."""
