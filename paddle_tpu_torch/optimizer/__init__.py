"""Optimizers (counterpart of ``paddle_tpu/optimizer``): the fourteen
optimizers of the JAX package with its exact update math, parameter
groups, ``multi_precision`` master weights, and the ``lr`` schedulers.
Adam and AdamW update every float32 parameter on the card in one fused
CUDA launch (``kernels/fused_adam.py``)."""
from . import lr
from .lbfgs import LBFGS
from .optimizer import Optimizer
from .optimizers import (ASGD, SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
                         Lamb, Momentum, NAdam, RAdam, RMSProp, Rprop)

__all__ = ["lr", "Optimizer", "LBFGS", "ASGD", "SGD", "Adadelta", "Adagrad",
           "Adam", "Adamax", "AdamW", "Lamb", "Momentum", "NAdam", "RAdam",
           "RMSProp", "Rprop"]
