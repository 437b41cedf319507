from .optimizers import (  # noqa: F401
    Optimizer, adafactor, adamw, chain_clip, default_optimizer_for,
    global_norm, opt_state_specs, sgd)
from .schedules import constant, warmup_cosine  # noqa: F401
