from .losses import accuracy, masked_cross_entropy, mse, rollout_mse
from .loop import MetricsLogger, make_train_step
from .optim import Rprop, adam, rprop

__all__ = ["accuracy", "masked_cross_entropy", "mse", "rollout_mse",
           "MetricsLogger", "make_train_step", "Rprop", "adam", "rprop"]
