from repro_torch.optim.adam import AdamWState, adamw_init, adamw_update, global_norm
from repro_torch.optim.schedules import cosine_warmup

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_warmup", "global_norm"]
