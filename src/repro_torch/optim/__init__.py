from .optimizers import (  # noqa: F401
    Optimizer, adafactor, adamw, default_optimizer_for, global_norm, sgd)
from .schedules import constant, warmup_cosine  # noqa: F401
