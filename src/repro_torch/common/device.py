"""Device resolution shared by the port's entry points (the FL simulator
and the LM server)."""
from __future__ import annotations

import torch


def setup_device(name: str) -> torch.device:
    """Resolve a ``--device`` / ``SimConfig.device`` name. A CUDA request
    without a card raises: the port never moves a run to the CPU on its
    own."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={name!r} was requested but torch sees no CUDA "
                f"device; pass device='cpu' to run the plain CPU path")
        # cuDNN runs float32 convolutions in TF32 by default (about three
        # decimal digits), which pushes the CNN convs outside the golden
        # tolerance; parity runs in full float32.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        # Checkpoint/resume promises that a resumed run equals the unbroken
        # one, and a sweep lane that it equals its standalone run: both need
        # bit-reproducible convolutions, so cuDNN may pick only
        # deterministic algorithms, and no autotuning (which may pick
        # another algorithm from one process to the next).
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return dev
