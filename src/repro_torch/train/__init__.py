"""Training: the port of ``repro.train`` (the train step and its state)."""
from .step import (  # noqa: F401
    TrainState, gradients, make_train_step, state_logical_axes, state_spec,
)
