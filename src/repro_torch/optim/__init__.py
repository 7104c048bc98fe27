from .optimizers import (Optimizer, adafactor, adamw,  # noqa: F401
                         clip_scale, global_norm)
from .schedules import cosine_schedule, linear_warmup  # noqa: F401
