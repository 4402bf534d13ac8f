"""Functional optimizers (counterpart of
``paddle_tpu/incubate/optimizer/functional.py``): ``minimize_bfgs`` /
``minimize_lbfgs`` of a scalar function, over the port's ``LBFGS``
(``optimizer/lbfgs.py``) with a strong-Wolfe line search. BFGS is L-BFGS
with a history as long as the iterations, as in the JAX package."""
from __future__ import annotations

import torch

__all__ = ["minimize_bfgs", "minimize_lbfgs"]


def _minimize(objective_func, initial_position, max_iters, tolerance_grad,
              tolerance_change, history_size):
    from ...core.dispatch import wrap
    from ...framework.misc import create_parameter
    from ...optimizer import LBFGS

    x = create_parameter(list(initial_position.shape),
                         initial_position.dtype)
    with torch.no_grad():
        x._data.copy_(initial_position._data)
    opt = LBFGS(learning_rate=1.0, max_iter=max_iters,
                tolerance_grad=tolerance_grad,
                tolerance_change=tolerance_change, history_size=history_size,
                line_search_fn="strong_wolfe", parameters=[x])

    def closure():
        loss = objective_func(x)
        loss.backward()
        return loss

    loss = opt.step(closure)
    g = x._data.grad
    grad_norm = float(g.abs().max()) if g is not None else 0.0
    dev = x._data.device
    return (wrap(torch.tensor(grad_norm <= tolerance_grad, device=dev)),
            wrap(torch.tensor(opt._n_evals, dtype=torch.int64, device=dev)),
            x, wrap(g.detach().clone() if g is not None
                    else torch.zeros_like(x._data)),
            wrap(loss.to(dev)),
            wrap(torch.eye(x._data.numel(), dtype=torch.float32,
                           device=dev)))


def minimize_bfgs(objective_func, initial_position, max_iters=50,
                  tolerance_grad=1e-7, tolerance_change=1e-9,
                  initial_inverse_hessian_estimate=None, line_search_fn=
                  "strong_wolfe", max_line_search_iters=50,
                  initial_step_length=1.0, dtype="float32", name=None):
    """BFGS minimization of ``objective_func(x)``. Returns (is_converge,
    num_func_calls, position, gradient, objective_value,
    inverse_hessian_estimate — the identity, as in the JAX package)."""
    return _minimize(objective_func, initial_position, max_iters,
                     tolerance_grad, tolerance_change,
                     history_size=max(max_iters, 50))


def minimize_lbfgs(objective_func, initial_position, history_size=100,
                   max_iters=50, tolerance_grad=1e-8,
                   tolerance_change=1e-8, initial_inverse_hessian_estimate
                   =None, line_search_fn="strong_wolfe",
                   max_line_search_iters=50, initial_step_length=1.0,
                   dtype="float32", name=None):
    """L-BFGS minimization; the return structure of minimize_bfgs."""
    return _minimize(objective_func, initial_position, max_iters,
                     tolerance_grad, tolerance_change, history_size)
