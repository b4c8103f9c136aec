# Frozen copy of cafempc_tpu_torch/solver/penalty.py, the port's plain path, for the
# benchmark's reference: imports point into benchmark/reference/plain.
"""Relaxed-Barrier (ReB) and Augmented-Lagrangian (AL) penalty math
(port of `cafempc_tpu/solver/penalty.py`).

Mirrors the reference formulas (ConstraintsBase.h:194-425).  Every
function works on the trailing constraint axis and broadcasts over any
leading dimensions (scenarios, knots): ``g``/``h`` [..., nc] with an
``active`` 0/1 mask; inactive entries contribute exactly zero.  Where the
JAX version takes one knot (and the solver vmaps it), these take the whole
[B, N, nc] stack at once.
"""
import torch


def reb_barrier(g, delta, active):
    """Relaxed log-barrier value per constraint (unweighted)."""
    on = active > 0
    g = torch.where(on, g, torch.ones_like(g))
    quad = 0.5 * (torch.square((g - 2.0 * delta) / delta) - 1.0) \
        - torch.log(delta)
    # guard log(g) for g<=0 (the quadratic branch is selected there)
    log_term = -torch.log(torch.where(g > delta, g, torch.ones_like(g)))
    barr = torch.where(g > delta, log_term, quad)
    return torch.where(on, barr, torch.zeros_like(barr))


def reb_barrier_d(g, delta, active):
    """(barr', barr'') per constraint."""
    on = active > 0
    g = torch.where(on, g, torch.ones_like(g))
    d1 = torch.where(g > delta, -1.0 / g, (g - 2.0 * delta) / (delta * delta))
    d2 = torch.where(g > delta, 1.0 / (g * g), 1.0 / (delta * delta))
    z = torch.zeros_like(g)
    return torch.where(on, d1, z), torch.where(on, d2, z)


def reb_cost(g, delta, eps_w, active):
    """Sum_i eps_i * barr(g_i) over the last axis.  Caller multiplies by
    dt (SinglePhase.cpp:394-402)."""
    return torch.sum(eps_w * reb_barrier(g, delta, active), dim=-1)


def reb_partials(g, gx, gu, gy, delta, eps_w, active):
    """Gauss-Newton gradients/Hessians of the folded barrier w.r.t x,u,y.

    g [..., nc]; gx [..., nc, xs], gu [..., nc, us], gy [..., nc, ys]
    (linear constraints, gxx = 0).  Returns (grad_x, grad_u, grad_y,
    hess_x, hess_u, hess_y)."""
    d1, d2 = reb_barrier_d(g, delta, active)
    w1 = eps_w * d1
    w2 = eps_w * d2

    def grad(J):
        return torch.einsum("...ci,...c->...i", J, w1)

    def hess(J):
        return torch.einsum("...ci,...c,...cj->...ij", J, w2, J)

    return grad(gx), grad(gu), grad(gy), hess(gx), hess(gu), hess(gy)


def reb_update_params(g, delta, eps_w, active, thresh, beta_relax,
                      beta_weight, delta_min):
    """Per-(knot, constraint) adaptive update: only entries with
    g <= -thresh (violated) are updated (ConstraintsBase.h:194-209)."""
    upd = (active > 0) & (g <= -thresh)
    eps_new = torch.where(upd, eps_w * beta_weight, eps_w)
    delta_new = torch.where(upd, torch.maximum(delta * beta_relax, delta_min),
                            delta)
    return delta_new, eps_new


def al_cost(h, lam, sigma, active):
    """Sum_i 0.5*sigma_i*h_i^2 + lambda_i*h_i over the last axis
    (ConstraintsBase.h:400-411)."""
    h = torch.where(active > 0, h, torch.zeros_like(h))
    return torch.sum(0.5 * sigma * h * h + lam * h, dim=-1)


def al_partials(h, hx, lam, sigma, active):
    """AL gradient/Hessian (ConstraintsBase.h:412-425), mirroring the
    reference's Hessian sum (sigma*(1+h)+lambda) hx hx^T exactly.
    h [..., nc], hx [..., nc, xs]."""
    on = active > 0
    h = torch.where(on, h, torch.zeros_like(h))
    gw = (sigma * h + lam) * on
    hw = (sigma * (1.0 + h) + lam) * on
    grad = torch.einsum("...ci,...c->...i", hx, gw)
    hess = torch.einsum("...ci,...c,...cj->...ij", hx, hw, hx)
    return grad, hess


def al_update_params(h, lam, sigma, active, thresh, beta, sigma_max):
    """Per-constraint schedule (ConstraintsBase.h:375-391):
    |h| < thresh: no-op; |h| > 0.005: sigma <- min(sigma*beta, sigma_max);
    else: lambda += h*sigma."""
    habs = torch.abs(torch.where(active > 0, h, torch.zeros_like(h)))
    bump = (habs >= thresh) & (habs > 0.005)
    lag = (habs >= thresh) & (habs <= 0.005)
    sigma_new = torch.where(
        bump, torch.minimum(sigma * beta, sigma_max), sigma)
    lam_new = torch.where(lag, lam + h * sigma, lam)
    return lam_new, sigma_new
