"""Parameter + ParamAttr (counterpart of ``paddle_tpu/framework/param_attr.py``).

A ``Parameter`` is a surface ``Tensor`` whose ``_data`` is a leaf torch
tensor that requires grad when ``trainable``; unlike a torch tensor, its
``name`` is writable. An optimizer given a Parameter updates that leaf
and names it by ``name``.
"""
from __future__ import annotations

from ..core.tensor import Tensor


class ParamAttr:
    """name, initializer, learning rate, regularizer and trainable of a
    parameter."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if attr is False:
            return False
        if isinstance(attr, dict):
            return ParamAttr(**attr)
        return ParamAttr(initializer=attr)


class Parameter(Tensor):
    """A trainable Tensor (stop_gradient=False by default)."""

    def __init__(self, data, trainable=True, name=None, optimize_attr=None,
                 regularizer=None, need_clip=True, learning_rate=1.0,
                 place=None):
        super().__init__(data, place=place, stop_gradient=not trainable,
                         name=name)
        self.persistable = True
        self.trainable = trainable
        self.optimize_attr = optimize_attr or {"learning_rate": learning_rate}
        self.regularizer = regularizer
        self.need_clip = need_clip
        self.is_distributed = False

    def initialize(self):
        """Run the initializer deferred by ``LazyGuard`` (no-op
        otherwise)."""
        init = self.__dict__.pop("_lazy_initializer", None)
        if init is not None:
            init(self)
        return self

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()

    __str__ = __repr__
