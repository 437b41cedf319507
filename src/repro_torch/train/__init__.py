from .trainer import NonFiniteDivergence, Trainer, TrainerConfig  # noqa: F401
