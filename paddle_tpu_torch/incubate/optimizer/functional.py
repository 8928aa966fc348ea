"""Functional quasi-Newton minimizers (port of
``paddle_tpu/incubate/optimizer/functional.py``): ``minimize_bfgs`` and
``minimize_lbfgs``.

The objective takes a tensor and returns a scalar (or a tensor it sums);
autograd gives each evaluation's gradient.  A host-side loop drives the
iteration with a bracketing strong-Wolfe line search (Nocedal & Wright,
algorithms 3.5 / 3.6), the same iteration and the same returned flags as
the JAX package's.
"""

from __future__ import annotations

import torch

from ... import to_dtype

__all__ = ["minimize_bfgs", "minimize_lbfgs"]


def _value_and_grad(objective_func, dtype):
    def vg(x):
        x = x.detach().requires_grad_(True)
        f = torch.as_tensor(objective_func(x)).to(dtype).sum()
        g, = torch.autograd.grad(f, x)
        return f.detach(), g.detach()

    return vg


def _dot(a, b) -> float:
    return float(torch.dot(a, b))


def _strong_wolfe(vg, x, d, f0, g0, alpha0, max_iters, c1=1e-4, c2=0.9):
    """Returns ``(alpha, f_new, g_new, evaluations)``."""
    dphi0 = _dot(g0, d)
    if dphi0 >= 0:           # not a descent direction: no step
        return 0.0, f0, g0, 0

    def phi(a):
        f, g = vg(x + a * d)
        return float(f), g, _dot(g, d)

    def zoom(lo, f_lo, hi, evals):
        for _ in range(max_iters):
            a = 0.5 * (lo + hi)
            f_a, g_a, dphi_a = phi(a)
            evals += 1
            if f_a > f0 + c1 * a * dphi0 or f_a >= f_lo:
                hi = a
            else:
                if abs(dphi_a) <= -c2 * dphi0:
                    return a, f_a, g_a, evals
                if dphi_a * (hi - lo) >= 0:
                    hi = lo
                lo, f_lo = a, f_a
        f_a, g_a, _ = phi(lo)
        return lo, f_a, g_a, evals + 1

    a_prev, f_prev = 0.0, f0
    a = alpha0
    evals = 0
    for i in range(max_iters):
        f_a, g_a, dphi_a = phi(a)
        evals += 1
        if f_a > f0 + c1 * a * dphi0 or (i > 0 and f_a >= f_prev):
            return zoom(a_prev, f_prev, a, evals)
        if abs(dphi_a) <= -c2 * dphi0:
            return a, f_a, g_a, evals
        if dphi_a >= 0:
            return zoom(a, f_a, a_prev, evals)
        a_prev, f_prev = a, f_a
        a *= 2.0
    return a_prev if a_prev > 0 else a, f_a, g_a, evals


def _minimize(objective_func, initial_position, *, lbfgs, history_size, max_iters,
              tolerance_grad, tolerance_change, h0, max_ls_iters, alpha0, dtype):
    dt = to_dtype(dtype)
    x0 = torch.as_tensor(initial_position)
    shape = x0.shape
    x = x0.detach().to(dt).reshape(-1).clone()
    n = x.shape[0]
    vg = _value_and_grad(objective_func, dt)
    f, g = vg(x)
    n_evals = 1
    H = (torch.eye(n, dtype=dt, device=x.device) if h0 is None
         else torch.as_tensor(h0).to(dtype=dt, device=x.device))
    s_hist, y_hist = [], []
    converged = False
    for _ in range(max_iters):
        if float(g.abs().max()) < tolerance_grad:
            converged = True
            break
        if lbfgs:
            # two-loop recursion over the curvature history
            q = g
            alphas = []
            for s, y in reversed(list(zip(s_hist, y_hist))):
                rho = 1.0 / _dot(y, s)
                a = rho * _dot(s, q)
                alphas.append((a, rho))
                q = q - a * y
            gamma = 1.0
            if s_hist:
                gamma = float(torch.dot(s_hist[-1], y_hist[-1])
                              / torch.dot(y_hist[-1], y_hist[-1]))
            r = gamma * q
            for (a, rho), (s, y) in zip(reversed(alphas), zip(s_hist, y_hist)):
                b = rho * _dot(y, r)
                r = r + (a - b) * s
            d = -r
        else:
            d = -(H @ g)
        alpha, f_new, g_new, e = _strong_wolfe(vg, x, d, float(f), g, alpha0, max_ls_iters)
        n_evals += e
        if alpha == 0.0:
            break
        s = alpha * d
        y = g_new - g
        x_new = x + s
        if float(s.abs().max()) < tolerance_change:
            x, f, g = x_new, f_new, g_new
            converged = True
            break
        sy = _dot(s, y)
        if sy > 1e-10:
            if lbfgs:
                s_hist.append(s)
                y_hist.append(y)
                if len(s_hist) > history_size:
                    s_hist.pop(0)
                    y_hist.pop(0)
            else:       # BFGS inverse-Hessian update
                rho = 1.0 / sy
                V = torch.eye(n, dtype=dt, device=x.device) - rho * torch.outer(s, y)
                H = V @ H @ V.T + rho * torch.outer(s, s)
        x, f, g = x_new, f_new, g_new
    res = (torch.tensor(converged), torch.tensor(n_evals), x.reshape(shape),
           torch.as_tensor(f, dtype=dt), g.reshape(shape))
    return res if lbfgs else res + (H,)


def minimize_bfgs(objective_func, initial_position, max_iters=50, tolerance_grad=1e-7,
                  tolerance_change=1e-9, initial_inverse_hessian_estimate=None,
                  line_search_fn="strong_wolfe", max_line_search_iters=50,
                  initial_step_length=1.0, dtype="float32", name=None):
    """Returns ``(is_converge, num_func_calls, position, objective_value,
    objective_gradient, inverse_hessian_estimate)``."""
    if line_search_fn != "strong_wolfe":
        raise ValueError("only line_search_fn='strong_wolfe' is supported")
    return _minimize(objective_func, initial_position, lbfgs=False, history_size=0,
                     max_iters=max_iters, tolerance_grad=tolerance_grad,
                     tolerance_change=tolerance_change, h0=initial_inverse_hessian_estimate,
                     max_ls_iters=max_line_search_iters, alpha0=initial_step_length,
                     dtype=dtype)


def minimize_lbfgs(objective_func, initial_position, history_size=100, max_iters=50,
                   tolerance_grad=1e-8, tolerance_change=1e-8,
                   initial_inverse_hessian_estimate=None, line_search_fn="strong_wolfe",
                   max_line_search_iters=50, initial_step_length=1.0, dtype="float32",
                   name=None):
    """Returns ``(is_converge, num_func_calls, position, objective_value,
    objective_gradient)``."""
    if line_search_fn != "strong_wolfe":
        raise ValueError("only line_search_fn='strong_wolfe' is supported")
    if initial_inverse_hessian_estimate is not None:
        raise ValueError("L-BFGS keeps an implicit inverse-Hessian; pass "
                         "initial_inverse_hessian_estimate to minimize_bfgs")
    return _minimize(objective_func, initial_position, lbfgs=True, history_size=history_size,
                     max_iters=max_iters, tolerance_grad=tolerance_grad,
                     tolerance_change=tolerance_change, h0=None,
                     max_ls_iters=max_line_search_iters, alpha0=initial_step_length,
                     dtype=dtype)
