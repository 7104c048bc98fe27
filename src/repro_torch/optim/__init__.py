from .optimizers import (Optimizer, adafactor, adamw,  # noqa: F401
                         clip_by_global_norm, global_norm)
from .schedules import cosine_schedule, linear_warmup  # noqa: F401
