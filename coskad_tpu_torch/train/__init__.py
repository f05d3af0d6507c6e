from .loop import Trainer
from .state import TrainState

__all__ = ["Trainer", "TrainState"]
