"""paddle.incubate.autograd (counterpart of
``paddle_tpu/incubate/autograd/__init__.py``): the functional AD of
``paddle.autograd`` (``vjp``, ``jvp``, ``Jacobian``, ``Hessian``),
``forward_grad``, ``grad`` and the prim switches. torch autograd has no
primitive-lowering mode to switch, so the switches are recorded for
``prim_enabled()``, as the JAX package records them."""
from __future__ import annotations

from ...autograd.functional import Hessian, Jacobian, jvp, vjp  # noqa: F401

__all__ = ["vjp", "jvp", "Jacobian", "Hessian", "enable_prim",
           "disable_prim", "prim_enabled", "forward_grad", "grad"]

_prim_enabled = False


def enable_prim():
    global _prim_enabled
    _prim_enabled = True


def disable_prim():
    global _prim_enabled
    _prim_enabled = False


def prim_enabled():
    return _prim_enabled


def forward_grad(outputs, inputs, grad_inputs=None):
    """Forward-mode derivative of the function ``outputs`` at ``inputs``
    along ``grad_inputs`` (ones by default): the tangents of ``jvp``. The
    static-program form (``outputs`` a tensor) has no eager counterpart
    and is refused, as in the JAX package."""
    if not callable(outputs):
        raise TypeError("forward_grad expects a function for outputs (the "
                        "static-program form is not supported)")
    xs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    if grad_inputs is None:
        from ...core.dispatch import wrap
        import torch
        vs = [wrap(torch.ones_like(x._data)) for x in xs]
    else:
        vs = list(grad_inputs) if isinstance(grad_inputs, (list, tuple)) \
            else [grad_inputs]
    _, tangents = jvp(outputs, xs if len(xs) > 1 else xs[0],
                      vs if len(vs) > 1 else vs[0])
    return tangents


def grad(outputs, inputs, grad_outputs=None):
    """Reverse-mode gradients, the contract of ``paddle.grad``."""
    from ...autograd.functional import grad as _grad
    return _grad(outputs, inputs, grad_outputs)
