"""L-BFGS (counterpart of ``paddle_tpu/optimizer/lbfgs.py``).

Quasi-Newton with a bounded curvature history (two-loop recursion) and an
optional strong-Wolfe line search (``_strong_wolfe``, ``_zoom``,
:128-170). It works on the flattened parameter vector and needs a closure
that re-evaluates the loss (and calls ``backward``), so it overrides
``step`` wholesale. History vectors stay on the parameters' device; the
control flow (line search, convergence tests) runs on host scalars, like
the JAX package's.
"""
from __future__ import annotations

import torch

from .optimizer import Optimizer, _decay_value


def _flatten(tensors):
    return torch.cat([t.detach().reshape(-1) for t in tensors])


def _dot(a, b) -> float:
    return float(torch.dot(a, b))


class LBFGS(Optimizer):
    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        if line_search_fn not in (None, "strong_wolfe"):
            raise ValueError("only 'strong_wolfe' line search is supported")
        self.max_iter = max_iter
        self.max_eval = max_eval if max_eval is not None \
            else max_iter * 5 // 4
        self.tolerance_grad = tolerance_grad
        self.tolerance_change = tolerance_change
        self.history_size = history_size
        self.line_search_fn = line_search_fn
        self._s_hist: list = []
        self._y_hist: list = []
        self._rho_hist: list = []
        self._prev_flat_grad = None
        self._n_evals = 0

    # -- flat-vector <-> parameter list ----------------------------------
    def _params(self):
        return [p for g in self._param_groups for p in g["params"]
                if p.requires_grad]

    @torch.no_grad()
    def _set_flat_params(self, flat):
        off = 0
        for p in self._params():
            n = p.numel()
            p.copy_(flat[off:off + n].reshape(p.shape))
            off += n

    def _gather_flat_grad(self):
        return torch.cat([torch.zeros(max(p.numel(), 1), dtype=p.dtype,
                                      device=p.device)
                          if p.grad is None else p.grad.reshape(-1)
                          for p in self._params()])

    def _eval(self, closure, flat_x):
        """Set params to flat_x, run closure -> (loss value, flat grad).

        weight_decay adds the L2 term to both loss and gradient (so the
        line search sees the regularised objective); grad_clip runs on the
        per-parameter grads through the standard clip interface before
        flattening."""
        self._set_flat_params(flat_x)
        self.clear_grad()
        with torch.enable_grad():
            loss = closure()
        self._n_evals += 1
        if self._grad_clip is not None:
            params = [p for p in self._params() if p.grad is not None]
            clipped = self._grad_clip.clip_grads([p.grad for p in params])
            for p, g in zip(params, clipped):
                p.grad = g
        loss_val = float(loss)
        flat_grad = self._gather_flat_grad()
        coeff = _decay_value(self._weight_decay)
        if coeff:
            loss_val += 0.5 * coeff * _dot(flat_x, flat_x)
            flat_grad = flat_grad + coeff * flat_x
        return loss_val, flat_grad

    # -- search direction -------------------------------------------------
    def _direction(self, flat_grad):
        q = flat_grad
        alphas = []
        for s, y, rho in zip(reversed(self._s_hist), reversed(self._y_hist),
                             reversed(self._rho_hist)):
            a = rho * _dot(s, q)
            alphas.append(a)
            q = q - a * y
        if self._s_hist:
            s, y = self._s_hist[-1], self._y_hist[-1]
            gamma = _dot(s, y) / max(_dot(y, y), 1e-10)
            r = gamma * q
        else:
            r = q
        for (s, y, rho), a in zip(
                zip(self._s_hist, self._y_hist, self._rho_hist),
                reversed(alphas)):
            b = rho * _dot(y, r)
            r = r + (a - b) * s
        return -r

    def _push_history(self, s, y):
        ys = _dot(y, s)
        if ys > 1e-10:
            self._s_hist.append(s)
            self._y_hist.append(y)
            self._rho_hist.append(1.0 / ys)
            if len(self._s_hist) > self.history_size:
                self._s_hist.pop(0)
                self._y_hist.pop(0)
                self._rho_hist.pop(0)

    # -- strong Wolfe line search ------------------------------------------
    def _strong_wolfe(self, closure, x, t, d, f0, g0, gtd0,
                      c1=1e-4, c2=0.9, max_ls=25):
        f_prev, t_prev = f0, 0.0
        f_new, g_new = f0, g0
        for _ in range(max_ls):
            f_new, g_new = self._eval(closure, x + t * d)
            gtd_new = _dot(g_new, d)
            if f_new > f0 + c1 * t * gtd0 or (t_prev > 0 and
                                              f_new >= f_prev):
                return self._zoom(closure, x, d, f0, gtd0, t_prev, t,
                                  f_prev, f_new, c1, c2, max_ls)
            if abs(gtd_new) <= -c2 * gtd0:
                return t, f_new, g_new
            if gtd_new >= 0:
                return self._zoom(closure, x, d, f0, gtd0, t, t_prev,
                                  f_new, f_prev, c1, c2, max_ls)
            t_prev, f_prev = t, f_new
            t = min(t * 2.0, 1e10)
        return t, f_new, g_new

    def _zoom(self, closure, x, d, f0, gtd0, lo, hi, f_lo, f_hi,
              c1, c2, max_ls):
        f_new, g_new, t = f_lo, None, lo
        for _ in range(max_ls):
            t = 0.5 * (lo + hi)
            f_new, g_new = self._eval(closure, x + t * d)
            gtd_new = _dot(g_new, d)
            if f_new > f0 + c1 * t * gtd0 or f_new >= f_lo:
                hi, f_hi = t, f_new
            else:
                if abs(gtd_new) <= -c2 * gtd0:
                    return t, f_new, g_new
                if gtd_new * (hi - lo) >= 0:
                    hi, f_hi = lo, f_lo
                lo, f_lo = t, f_new
            if abs(hi - lo) < 1e-9:
                break
        if g_new is None:
            f_new, g_new = self._eval(closure, x + t * d)
        return t, f_new, g_new

    # -- main loop ---------------------------------------------------------
    @torch.no_grad()
    def step(self, closure=None):
        """One L-BFGS optimisation step; ``closure`` re-evaluates the loss
        and its gradients. Returns the final loss as a 0-d f32 tensor."""
        if closure is None:
            raise ValueError("LBFGS.step requires a closure")
        lr = self.get_lr()
        self._n_evals = 0
        x = _flatten(self._params())
        loss, flat_grad = self._eval(closure, x)
        if float(flat_grad.abs().max()) <= self.tolerance_grad:
            return torch.tensor(loss, dtype=torch.float32)

        for _ in range(self.max_iter):
            if self._prev_flat_grad is not None:
                self._push_history(x - self._prev_x,
                                   flat_grad - self._prev_flat_grad)
            d = self._direction(flat_grad)
            self._prev_x, self._prev_flat_grad = x, flat_grad
            gtd = _dot(flat_grad, d)
            if gtd > -1e-12:  # not a descent direction; reset history
                self._s_hist, self._y_hist, self._rho_hist = [], [], []
                d = -flat_grad
                gtd = _dot(flat_grad, d)
            t = lr if self._s_hist else min(
                1.0, 1.0 / max(float(flat_grad.abs().sum()), 1e-10)) * lr
            if self.line_search_fn == "strong_wolfe":
                t, loss_new, grad_new = self._strong_wolfe(
                    closure, x, t, d, loss, flat_grad, gtd)
                x_new = x + t * d
            else:
                x_new = x + t * d
                loss_new, grad_new = self._eval(closure, x_new)
            if abs(loss_new - loss) < self.tolerance_change or \
                    float((x_new - x).abs().max()) < self.tolerance_change:
                x, loss, flat_grad = x_new, loss_new, grad_new
                break
            x, loss, flat_grad = x_new, loss_new, grad_new
            if float(flat_grad.abs().max()) <= self.tolerance_grad:
                break
            if self._n_evals >= self.max_eval:
                break
        self._set_flat_params(x)
        return torch.tensor(loss, dtype=torch.float32)
