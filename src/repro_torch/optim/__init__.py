"""Hand-rolled optimizers over parameter trees, the reference's
``repro.optim``: ``(init, update)`` pairs whose updates are added to the
parameters, and learning-rate schedules on host step counts."""
from repro_torch.optim.sgd import sgd, sgd_momentum
from repro_torch.optim.adamw import adamw
from repro_torch.optim.schedule import (constant_lr, cosine_decay,
                                        exponential_decay, warmup_cosine)
from repro_torch.optim.base import (Optimizer, apply_updates,
                                    clip_by_global_norm)
