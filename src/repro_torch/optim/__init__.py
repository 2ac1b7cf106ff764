from .adamw import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                    clip_by_global_norm, compress_grads)
from .schedule import cosine_schedule

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "compress_grads", "cosine_schedule"]
