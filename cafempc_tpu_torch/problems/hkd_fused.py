"""Solver-facing fused forward and LQ paths for the HKD problem (port of
`cafempc_tpu/problems/hkd_fused.py`).

``make_hkd_fused_forward()`` returns

    fused_forward(plan, pen, tr, x0, eps, plain_ops=False)
        -> (tr2, (cq, g, h), cost, feas, maxp, maxt, ok)

with eps a per-scenario [B] tensor: one launch of the `ops.hkd_trial`
kernel in place of the solver's rollout + cost_terms + cost_from_terms +
dyn_feas.  ``make_hkd_fused_lq()`` returns

    fused_lq(plan, pen, tr, plain_ops=False) -> tr

one launch of the `ops.hkd_lq` kernel in place of the solver's generic
lq_approx.  `plain_ops=True` runs the kernels' plain PyTorch twins.

Two inputs of the kernels do not depend on eps: the per-knot constant
table of the plan, and the search-direction control offset
dUK = dU + K dX[:-1] (the generic path applies K to X - Xbar in every
trial).  XLA hoists them out of the JAX loops; here each hook keeps the
last one it computed and reuses it while it is called with the same plan
(once per solve) and the same direction tensors (once per line search).
The solver never modifies these tensors in place.
"""
import torch

from cafempc_tpu_torch.ops import hkd_lq as hkd_lq_mod
from cafempc_tpu_torch.ops import hkd_table
from cafempc_tpu_torch.ops import hkd_trial as hkd_trial_mod
from cafempc_tpu_torch.problems.hkd_problem import (MU_FRIC,
                                                    _footreg_weights,
                                                    _tracking_weights)


def plan_consts(plan, dtype):
    """Plan-derived per-knot constants shared by the fused forward and
    fused LQ paths (JAX package `_plan_consts`, hkd_fused.py:159-180)."""
    sd, kd = plan.step, plan.knot
    q_w, r, _ = _tracking_weights(sd.contact)
    _, _, qf_t = _tracking_weights(kd.contact)
    c3 = sd.contact.repeat_interleave(3, dim=-1)
    return dict(
        q_w=q_w, r_w=r.expand(q_w.shape), qf_t=qf_t,
        qfoot_r=_footreg_weights(sd.contact),
        qfoot_t=_footreg_weights(kd.contact),
        prelref_r=sd.pf_ref - sd.com_ref.repeat(1, 4),
        prelref_t=kd.pf_ref - kd.com_ref.repeat(1, 4),
        c3=c3, swing3=1.0 - c3,
        td4=(1.0 - sd.contact) * sd.contact_next,
        lo4=sd.contact * (1.0 - sd.contact_next),
        run_m=sd.active * (1.0 - sd.is_reset),
        # prev_act[k] = active[k-1]
        prev_act=torch.cat([torch.ones(1, dtype=dtype,
                                       device=sd.active.device), sd.active]),
        term_m=kd.active * kd.is_terminal)


def knot_table(plan):
    """The plan's constant table for the fused kernels (`ops.hkd_table`)."""
    sd, kd = plan.step, plan.knot
    cc = plan_consts(plan, sd.dt.dtype)
    return hkd_table.pack(dict(
        cc, xref_s=sd.x_ref, uref_s=sd.u_ref, dt=sd.dt,
        is_reset=sd.is_reset, act=sd.active, xref_k=kd.x_ref,
        k_act=kd.active))


class _LastValue:
    """fn's value at the last key, recomputed when any key tensor is not
    the same object as before (the key is held, so its ids stay unique)."""

    def __init__(self, fn):
        self.fn, self.key, self.value = fn, None, None

    def __call__(self, *key):
        if self.key is None or any(a is not b
                                   for a, b in zip(key, self.key)):
            self.value = self.fn(*key)
            self.key = key
        return self.value


def _penalties(pen, dtype):
    return (pen.reb_delta, pen.reb_eps, pen.reb_active.to(dtype),
            pen.al_lambda, pen.al_sigma, pen.al_active.to(dtype))


def make_hkd_fused_forward():
    """Returns fused_forward(plan, pen, tr, x0, eps, plain_ops=False) for
    make_solver(..., fused_forward=...)."""
    table = _LastValue(knot_table)
    direction = _LastValue(lambda dU, K, dX: (
        dU + torch.einsum("bkij,bkj->bki", K, dX[:, :-1])).contiguous())

    def fused_forward(plan, pen, tr, x0, eps, plain_ops=False):
        dtype = tr.Xbar.dtype
        trial = (hkd_trial_mod.hkd_trial_reference if plain_ops
                 else hkd_trial_mod.hkd_trial)
        eps = torch.as_tensor(eps, dtype=dtype, device=x0.device).expand(
            x0.shape[0]).contiguous()
        (X, U, Xsim, Defect, g, h, cq, cost, feas, maxp, maxt,
         okf) = trial(eps, x0, tr.Xbar, tr.dX, tr.Ubar,
                      direction(tr.dU, tr.K, tr.dX), *_penalties(pen, dtype),
                      table(plan), MU_FRIC)
        tr2 = tr._replace(X=X, U=U, Xsim=Xsim, Defect=Defect)
        return tr2, (cq, g, h), cost, feas, maxp, maxt, okf > 0.5

    return fused_forward


def make_hkd_fused_lq():
    """Returns fused_lq(plan, pen, tr, plain_ops=False) for
    make_solver(..., fused_lq=...): every per-knot linearization (dynamics
    and reset Jacobians, ReB-folded running-cost partials, AL-folded
    terminal partials) in one kernel launch.  C, D, ly, lyy and lux stay
    zero."""
    table = _LastValue(knot_table)

    def fused_lq(plan, pen, tr, plain_ops=False):
        lq = hkd_lq_mod.hkd_lq_reference if plain_ops else hkd_lq_mod.hkd_lq
        A, B, lx, lu, lxx, luu, phix, phixx = lq(
            tr.X, tr.U, *_penalties(pen, tr.Xbar.dtype), table(plan),
            MU_FRIC)
        return tr._replace(A=A, B=B, lx=lx, lu=lu, lxx=lxx, luu=luu,
                           phix=phix, phixx=phixx)

    return fused_lq
