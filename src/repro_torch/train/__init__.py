"""Training runtime: train state, the train step, fault-tolerant loop (mirrors
:mod:`repro.train`)."""

from repro_torch.train.state import TrainState, make_train_step  # noqa: F401
from repro_torch.train.loop import TrainLoopConfig, run_training  # noqa: F401
