"""Fused HKD line-search trial: the CUDA kernel's wrapper and its plain
PyTorch twin.

Replaces the Pallas kernel `cafempc_tpu/ops/fused_hkd_trial.py::
fused_hkd_trial` (pallas_call at fused_hkd_trial.py:416), reached in the
JAX package through `problems/hkd_fused.py::_trial_op`.  The kernel itself
is `csrc/hkd_trial.cu`.

One whole line-search trial at a per-scenario step eps [B]
(SinglePhase.cpp:182-262):
  X = Xbar + eps dX, U = Ubar + eps dUK (dUK = dU + K dX, eps-free);
  Xsim[0] = x0, Xsim[k+1] = the HKD step (or reset map) of X[k], U[k]
  where step k is active, else X[k+1]; Defect = k_act (Xsim - X);
  g the friction-pyramid values of U, h the foot heights of X;
  cq the tracking and foot-placement cost, cost = cq plus the ReB and AL
  penalties; feas = |Defect|; maxp = min(0, min active g);
  maxt = max active |h|; ok = Xsim finite and max_k k_act |Xsim_k|^2 < 1e12.

The reset map is applied at every reset step, as in the generic solver
path (which refuses a plan with more reset steps than its `max_resets`
when it gathers them).  dt is used exactly:
the Pallas kernel rounds its flag table, dt included, to float32 even in
float64 (fused_hkd_trial.py:421); the JAX fallback and the generic path do
not, and neither does this port.

Shapes: eps [B], x0 [B,24], Xbar/dX [B,N+1,24], Ubar/dUK [B,N,24],
reb_delta/reb_eps/reb_act [B,N,20], al_lam/al_sig/al_act [B,N+1,4],
table [N+1, hkd_table.NCOLS], mu the friction coefficient.  Returns
X [B,N+1,24], U [B,N,24], Xsim, Defect [B,N+1,24], g [B,N,20],
h [B,N+1,4] and cq, cost, feas, maxp, maxt, ok [B] (ok 1.0 / 0.0).

`hkd_trial` dispatches on the tensors' device: CUDA tensors launch the
kernel (a build or launch failure raises), CPU tensors run
`hkd_trial_reference`.  `hkd_trial.launches` counts kernel launches.  The
kernel stages a scenario in one CTA's shared memory, so on the card it
takes N <= 401 in float64 and N <= 804 in float32 (the bench plan has 112).
"""
import torch

from cafempc_tpu_torch.models import hkd
from cafempc_tpu_torch.ops import _ext, hkd_table
from cafempc_tpu_torch.ops.hkd_lq import friction_values
from cafempc_tpu_torch.solver import penalty

OK_NORM_LIMIT = 1e12   # max squared state norm of an acceptable trial
MAX_SMEM = 232448      # bytes of shared memory one CTA can have (H100)


def smem_bytes(N, itemsize):
    """Shared memory of the kernel's CTA for one scenario of N steps: X,
    Xsim [N+1, 24] and U [N, 24] staged, plus a reduction scratch of 7
    values for each of up to 16 warps (csrc/hkd_trial.cu::trial_smem)."""
    return (2 * (N + 1) * 24 + N * 24 + 16 * 7) * itemsize


def hkd_trial_reference(eps, x0, Xbar, dX, Ubar, dUK, reb_delta, reb_eps,
                        reb_act, al_lam, al_sig, al_act, table, mu):
    """Plain PyTorch twin of the trial kernel: the batched form of the JAX
    package's `_trial_op` fallback (problems/hkd_fused.py:34-107)."""
    c = hkd_table.unpack(table)
    e = eps[:, None, None]
    X = Xbar + e * dX
    U = Ubar + e * dUK
    Xs = X[:, :-1]
    xn = torch.where(c["is_reset"][:, None] > 0,
                     hkd.reset_map_td_lo(Xs, c["td4"], c["lo4"]),
                     hkd.dynamics(Xs, U, c["dt"], c["c3"][:, 0::3]))
    xn = torch.where(c["prev_act"][1:, None] > 0, xn, X[:, 1:])
    Xsim = torch.cat([x0[:, None], xn], dim=1)
    ka = c["k_act"][:, None]
    Defect = (Xsim - X) * ka
    ok = torch.isfinite(Xsim).all(dim=(1, 2)) & (
        torch.sum((Xsim * ka) ** 2, dim=-1).amax(dim=1) < OK_NORM_LIMIT)

    # running cost
    dx = Xs - c["xref_s"]
    du = U - c["uref_s"]
    prel = X[..., 12:24] - X[..., 3:6].repeat(1, 1, 4)
    d_r = prel[:, :-1] - c["prelref_r"]
    l = 0.5 * torch.sum(c["q_w"] * dx * dx, -1) \
        + 0.5 * torch.sum(c["r_w"] * du * du, -1) \
        + 0.5 * torch.sum(c["qfoot_r"] * d_r * d_r, -1)
    rm = c["run_m"] * c["dt"]
    cq = torch.sum(rm * l, 1)
    # terminal cost
    dxt = X - c["xref_k"]
    d_t = prel - c["prelref_t"]
    phi = 0.5 * torch.sum(c["qf_t"] * dxt * dxt, -1) \
        + 10.0 * torch.sum(c["qfoot_t"] * d_t * d_t, -1)
    tm = c["term_m"]
    cq = cq + torch.sum(tm * phi, 1)

    # constraints + penalties
    g = friction_values(U, mu)
    cost = cq + torch.sum(rm * penalty.reb_cost(g, reb_delta, reb_eps,
                                                reb_act), 1)
    h = hkd.foot_heights(X)
    cost = cost + torch.sum(tm * penalty.al_cost(h, al_lam, al_sig, al_act),
                            1)
    g_act = (reb_act > 0) & (c["run_m"][:, None] > 0)
    maxp = torch.clamp(torch.where(g_act, g, torch.zeros_like(g))
                       .amin(dim=(1, 2)), max=0.0)
    h_act = (al_act > 0) & (tm[:, None] > 0)
    maxt = torch.where(h_act, h.abs(), torch.zeros_like(h)).amax(dim=(1, 2))
    feas = torch.sqrt(torch.sum(Defect ** 2, dim=(1, 2)))
    return (X, U, Xsim, Defect, g, h, cq, cost, feas, maxp, maxt,
            ok.to(X.dtype))


def _check(eps, x0, Xbar, dX, Ubar, dUK, reb_delta, reb_eps, reb_act,
           al_lam, al_sig, al_act, table):
    Bsz, NK = Xbar.shape[:2]
    N = NK - 1
    want = dict(eps=(Bsz,), x0=(Bsz, 24), Xbar=(Bsz, NK, 24),
                dX=(Bsz, NK, 24), Ubar=(Bsz, N, 24), dUK=(Bsz, N, 24),
                reb_delta=(Bsz, N, 20), reb_eps=(Bsz, N, 20),
                reb_act=(Bsz, N, 20), al_lam=(Bsz, NK, 4),
                al_sig=(Bsz, NK, 4), al_act=(Bsz, NK, 4),
                table=(NK, hkd_table.NCOLS))
    got = dict(eps=eps, x0=x0, Xbar=Xbar, dX=dX, Ubar=Ubar, dUK=dUK,
               reb_delta=reb_delta, reb_eps=reb_eps, reb_act=reb_act,
               al_lam=al_lam, al_sig=al_sig, al_act=al_act, table=table)
    hkd_table.check_operands("hkd_trial", got, want, Xbar)


def hkd_trial(eps, x0, Xbar, dX, Ubar, dUK, reb_delta, reb_eps, reb_act,
              al_lam, al_sig, al_act, table, mu):
    """One HKD line-search trial; CUDA tensors run the hand kernel, CPU
    tensors the plain twin."""
    args = (eps, x0, Xbar, dX, Ubar, dUK, reb_delta, reb_eps, reb_act,
            al_lam, al_sig, al_act, table)
    _check(*args)
    if Xbar.device.type == "cpu":
        return hkd_trial_reference(*args, mu)
    Bsz, NK = Xbar.shape[:2]
    N = NK - 1
    if smem_bytes(N, Xbar.element_size()) > MAX_SMEM:
        raise ValueError(f"hkd_trial: no kernel for N={N} in {Xbar.dtype}: "
                         "a scenario's X, U and Xsim must fit in one CTA's "
                         f"{MAX_SMEM} bytes of shared memory")
    if Xbar.device.type != "cuda":
        raise ValueError(f"hkd_trial: no kernel for device {Xbar.device}")
    # the kernel moves rows 16 bytes at a time, so a view that does not
    # start on a 16-byte boundary is copied
    ins = [t.contiguous() for t in args]
    ins = [t if t.data_ptr() % 16 == 0 else t.clone() for t in ins]
    outs = [torch.empty_like(Xbar), Xbar.new_empty(Bsz, N, 24),
            torch.empty_like(Xbar), torch.empty_like(Xbar),
            Xbar.new_empty(Bsz, N, 20), Xbar.new_empty(Bsz, NK, 4)] \
        + [Xbar.new_empty(Bsz) for _ in range(6)]
    _ext.launch("hkd_trial", Xbar.dtype, Bsz, N, 24, 24, ins, outs,
                doubles=(mu,))
    hkd_trial.launches += 1
    return tuple(outs)


hkd_trial.launches = 0
