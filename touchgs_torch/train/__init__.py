"""Fused Adam and the training loop."""
from touchgs_torch.train.trainer import Trainer, TrainState, make_train_step  # noqa: F401
