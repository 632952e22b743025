from .losses import (accuracy, edm_weighted_mse, masked_cross_entropy, mse,
                     rollout_mse, weighted_mse)
from .loop import MetricsLogger, make_train_step
from .optim import Rprop, adam, adamw, rprop

__all__ = ["accuracy", "edm_weighted_mse", "masked_cross_entropy", "mse",
           "rollout_mse", "weighted_mse", "MetricsLogger", "make_train_step", "Rprop",
           "adam", "adamw", "rprop"]
