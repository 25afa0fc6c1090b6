from repro_torch.optim.adamw import (AdamWConfig, clip_by_global_norm,
                                     global_norm, init_state, update)

__all__ = ["AdamWConfig", "clip_by_global_norm", "global_norm",
           "init_state", "update"]
