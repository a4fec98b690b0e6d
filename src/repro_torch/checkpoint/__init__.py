from repro_torch.checkpoint.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.checkpoint.placement import load_arrays, place_rows, place_state

__all__ = [
    "AsyncCheckpointer",
    "latest_step",
    "restore_checkpoint",
    "save_checkpoint",
    "load_arrays",
    "place_state",
    "place_rows",
]
