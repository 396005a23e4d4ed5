"""AdamW with its schedule, the ZeRO-1 moment specs and the int8 gradient
compression (counterpart of src/repro/optim/)."""
from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    decay_by_rank,
    global_norm,
    opt_state_pspecs,
)
from repro_torch.optim.compression import (
    compress_int8,
    decompress_int8,
    ef_compress_update,
)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup_cosine

__all__ = [n for n in dir() if not n.startswith("_")]
