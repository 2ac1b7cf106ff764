"""The fault-tolerant training loop (the port of ``repro.train``)."""
from .loop import TrainLoopConfig, train_loop

__all__ = ["TrainLoopConfig", "train_loop"]
