"""Training: the port of ``repro.train`` (the train step and its state)."""
from .step import TrainState, make_train_step  # noqa: F401
