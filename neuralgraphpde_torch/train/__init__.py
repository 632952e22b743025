from .losses import mse, rollout_mse
from .optim import Rprop, rprop

__all__ = ["mse", "rollout_mse", "Rprop", "rprop"]
