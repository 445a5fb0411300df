from repro_torch.checkpoint.store import (latest_step, load_pytree,
                                          load_train_state, save_pytree,
                                          save_train_state)
