from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedule import cosine_schedule, constant_schedule
from repro_torch.optim.compression import int8_ef_compress, int8_ef_init

__all__ = ["AdamW", "cosine_schedule", "constant_schedule",
           "int8_ef_compress", "int8_ef_init"]
