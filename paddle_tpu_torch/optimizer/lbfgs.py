"""L-BFGS (mirrors ``paddle_tpu/optimizer/lbfgs.py``).

Closure-based, full-batch quasi-Newton: the two-loop recursion over an
(s, y) history of ``history_size`` pairs, then a step of the rate along
the direction or, with ``line_search_fn="strong_wolfe"``, a strong-Wolfe
line search (bracket, then bisecting zoom). Works on the parameters
flattened to one float32 vector; each evaluation re-runs ``closure``,
which computes the loss, calls ``backward`` and returns the loss. The
loop reads losses and dot products on the host, as the JAX package's
does. Parameters are updated in their own dtype (no master copies).
"""

from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["LBFGS"]


class LBFGS(Optimizer):
    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._params = list(self._parameter_list)
        self.max_iter = max_iter
        self.max_eval = max_eval if max_eval is not None \
            else max_iter * 5 // 4
        self.tolerance_grad = tolerance_grad
        self.tolerance_change = tolerance_change
        self.history_size = history_size
        self.line_search_fn = line_search_fn
        self._s_hist = []
        self._y_hist = []
        self._rho = []
        self._n_evals = 0

    # -- flat-vector helpers -------------------------------------------

    def _gather_flat_grad(self):
        return torch.cat([
            (p.grad if p.grad is not None else torch.zeros_like(p))
            .float().reshape(-1) for p in self._params])

    @torch.no_grad()
    def _add_to_params(self, step_size, direction):
        off = 0
        for p in self._params:
            n = p.numel()
            upd = direction[off:off + n].view_as(p)
            p.copy_(p.float() + step_size * upd)
            off += n

    def _clone_params(self):
        return [p.detach().clone() for p in self._params]

    @torch.no_grad()
    def _restore_params(self, saved):
        for p, t in zip(self._params, saved):
            p.copy_(t)

    def _eval(self, closure):
        self._n_evals += 1
        self.clear_grad()
        with torch.enable_grad():
            loss = closure()
        return float(loss.detach()), self._gather_flat_grad()

    # -- the step ------------------------------------------------------

    def step(self, closure=None):
        if closure is None:
            raise ValueError("LBFGS.step requires a closure that "
                             "re-evaluates the model")
        lr = self.get_lr()

        loss, flat_grad = self._eval(closure)
        if float(flat_grad.abs().max()) <= self.tolerance_grad:
            return torch.tensor(loss, dtype=torch.float32)

        for _ in range(self.max_iter):
            # two-loop recursion
            q = -flat_grad
            alphas = []
            for s, y, rho in zip(reversed(self._s_hist),
                                 reversed(self._y_hist),
                                 reversed(self._rho)):
                a = rho * torch.dot(s, q)
                q = q - a * y
                alphas.append(a)
            if self._y_hist:
                y, s = self._y_hist[-1], self._s_hist[-1]
                q = q * (torch.dot(s, y) /
                         torch.clamp_min(torch.dot(y, y), 1e-20))
            for (s, y, rho), a in zip(
                    zip(self._s_hist, self._y_hist, self._rho),
                    reversed(alphas)):
                b = rho * torch.dot(y, q)
                q = q + (a - b) * s
            direction = q

            gtd = float(torch.dot(flat_grad, direction))
            if gtd > -self.tolerance_change:
                break

            if self.line_search_fn == "strong_wolfe":
                t, loss, new_grad = self._strong_wolfe(
                    closure, loss, flat_grad, direction, lr, gtd)
            else:
                t = lr
                self._add_to_params(t, direction)
                loss, new_grad = self._eval(closure)

            s = t * direction
            ydiff = new_grad - flat_grad
            sy = float(torch.dot(s, ydiff))
            if sy > 1e-10:
                self._s_hist.append(s)
                self._y_hist.append(ydiff)
                self._rho.append(1.0 / sy)
                if len(self._s_hist) > self.history_size:
                    self._s_hist.pop(0)
                    self._y_hist.pop(0)
                    self._rho.pop(0)
            flat_grad = new_grad

            if float(flat_grad.abs().max()) <= self.tolerance_grad:
                break
            if float(s.abs().max()) <= self.tolerance_change:
                break
            if self._n_evals >= self.max_eval:
                break

        return torch.tensor(loss, dtype=torch.float32)

    def _strong_wolfe(self, closure, f0, g0, d, t, gtd, c1=1e-4, c2=0.9,
                      max_ls=25):
        """Strong-Wolfe line search from step ``t``: double it until the
        sufficient-decrease or curvature condition brackets a step, then
        ``_zoom``. Leaves the parameters at the chosen step and returns
        (step, loss, flat grad) evaluated there."""
        saved = self._clone_params()

        def phi(alpha):
            self._restore_params(saved)
            self._add_to_params(alpha, d)
            f, g = self._eval(closure)
            return f, g, float(torch.dot(g, d))

        alpha_prev, f_prev = 0.0, f0
        alpha = t
        result = None
        for _ in range(max_ls):
            f_new, g_new, dg_new = phi(alpha)
            if f_new > f0 + c1 * alpha * gtd or \
                    (result is not None and f_new >= f_prev):
                result = self._zoom(phi, alpha_prev, alpha, f0, gtd,
                                    f_prev, c1, c2)
                break
            if abs(dg_new) <= -c2 * gtd:
                result = (alpha, f_new, g_new)
                break
            if dg_new >= 0:
                result = self._zoom(phi, alpha, alpha_prev, f0, gtd,
                                    f_new, c1, c2)
                break
            alpha_prev, f_prev = alpha, f_new
            alpha *= 2.0
            result = (alpha_prev, f_prev, g_new)
        if result is None:
            result = (alpha, f_new, g_new)
        a = result[0]
        self._restore_params(saved)
        self._add_to_params(a, d)
        f, g = self._eval(closure)
        return a, f, g

    @staticmethod
    def _zoom(phi, lo, hi, f0, gtd, f_lo, c1, c2, iters=10):
        best = None
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            f_mid, g_mid, dg_mid = phi(mid)
            best = (mid, f_mid, g_mid)
            if f_mid > f0 + c1 * mid * gtd or f_mid >= f_lo:
                hi = mid
            else:
                if abs(dg_mid) <= -c2 * gtd:
                    return mid, f_mid, g_mid
                if dg_mid * (hi - lo) >= 0:
                    hi = lo
                lo, f_lo = mid, f_mid
        return best
