"""Optimizers (counterpart of ``paddle_tpu/optimizer``): ``Adam`` and
``AdamW`` with the JAX package's exact update math. The package's other
optimizers and its ``lr`` schedulers come with a later slice: naming one
raises NotImplementedError."""
from .optimizer import Optimizer
from .optimizers import Adam, AdamW

__all__ = ["Optimizer", "Adam", "AdamW"]

#: in ``paddle_tpu.optimizer`` but not carried by this slice of the port
LATER = ("SGD", "Momentum", "Adagrad", "RMSProp", "Lamb", "Adamax",
         "Adadelta", "NAdam", "RAdam", "ASGD", "Rprop", "LBFGS", "lr")


def __getattr__(name):
    if name in LATER:
        raise NotImplementedError(
            f"paddle_tpu_torch.optimizer.{name} comes with a later slice of "
            f"the port; this slice carries Adam and AdamW with float "
            f"learning rates")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
