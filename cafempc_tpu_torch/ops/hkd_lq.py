"""Fused HKD LQ approximation: the CUDA kernel's wrapper and its plain
PyTorch twin.

Replaces the Pallas kernel `cafempc_tpu/ops/fused_hkd_lq.py::fused_hkd_lq`
(pallas_call at fused_hkd_lq.py:521), reached in the JAX package through
`problems/hkd_fused.py::_lq_op`.  The kernel itself is `csrc/hkd_lq.cu`.

Every per-knot linearization of the HKD problem (SinglePhase.cpp:265-320):
  * A = I + dt Fx and B = dt Fu from the closed-form dynamics partials, or
    on a reset step the reset-map Jacobian and B = 0; both scaled by the
    step's `act`;
  * running-cost lx, lu, lxx, luu: tracking, the foot-placement
    regularization on stance legs and the Gauss-Newton terms of the ReB
    friction-pyramid barrier, scaled by run_m dt;
  * terminal phix, phixx: tracking, the terminal foot-placement term and
    the AL touchdown-height terms, scaled by term_m.
lux is identically zero for HKD.

Shapes (batch-leading, the layout the sweep reads): X [B,N+1,24],
U [B,N,24], reb_delta/reb_eps/reb_act [B,N,20], al_lam/al_sig/al_act
[B,N+1,4], table [N+1, hkd_table.NCOLS] (the per-knot constants, shared by
the batch), mu the friction coefficient.  Returns A, B [B,N,24,24],
lx, lu [B,N,24], lxx, luu [B,N,24,24], phix [B,N+1,24],
phixx [B,N+1,24,24], dense and contiguous.

`hkd_lq` dispatches on the tensors' device: CUDA tensors launch the
kernel (a build or launch failure raises), CPU tensors run
`hkd_lq_reference`.  `hkd_lq.launches` counts kernel launches.
"""
import torch

from cafempc_tpu_torch.models import hkd
from cafempc_tpu_torch.ops import _ext, hkd_table
from cafempc_tpu_torch.solver import penalty


def facets(mu, like):
    """The friction-pyramid facets [5, 3] of one leg: g = F f gives
    [fz, -fx + mu fz, fx + mu fz, -fy + mu fz, fy + mu fz]
    (HKDConstraints.cpp:17-53)."""
    return torch.tensor([[0.0, 0.0, 1.0], [-1.0, 0.0, mu], [1.0, 0.0, mu],
                         [0.0, -1.0, mu], [0.0, 1.0, mu]], dtype=like.dtype,
                        device=like.device)


def friction_values(U, mu):
    """g [..., 20] of the controls' ground forces U[..., 0:12]."""
    return torch.einsum("fi,...li->...lf", facets(mu, U),
                        U[..., 0:12].unflatten(-1, (4, 3))).flatten(-2)


def facet_jacobian(mu, like):
    """d g / d u [20, 24]: the facets block-diagonal per leg."""
    gu = torch.zeros(20, 24, dtype=like.dtype, device=like.device)
    for leg in range(4):
        gu[5 * leg:5 * leg + 5, 3 * leg:3 * leg + 3] = facets(mu, like)
    return gu


def foot_placement_jacobian(like):
    """d prel / dx [12, 24] of the feet relative to the CoM: identity on
    each leg's qdummy columns minus the CoM-position tile."""
    E = torch.zeros(12, 24, dtype=like.dtype, device=like.device)
    E[:, 12:24] = torch.eye(12, dtype=like.dtype, device=like.device)
    E[:, 3:6] -= torch.eye(3, dtype=like.dtype, device=like.device).repeat(
        4, 1)
    return E


def hkd_lq_reference(X, U, reb_delta, reb_eps, reb_act, al_lam, al_sig,
                     al_act, table, mu):
    """Plain PyTorch twin of the LQ kernel: the batched form of the JAX
    package's `_lq_op` fallback (problems/hkd_fused.py:219-283)."""
    c = hkd_table.unpack(table)
    Bsz, N = U.shape[:2]
    Xs = X[:, :-1]
    contact = c["c3"][:, 0::3]
    A_d, B_d = hkd.dynamics_partials(Xs, U, c["dt"], contact)
    P = hkd.reset_map_partial_td_lo(Xs, c["td4"], c["lo4"])
    isr = c["is_reset"][:, None, None] > 0
    act = c["act"][:, None, None]
    A = torch.where(isr, P, A_d) * act
    Bm = torch.where(isr, torch.zeros_like(B_d), B_d) * act

    # running-cost partials (HKDCost.h:8-100)
    lx = c["q_w"] * (Xs - c["xref_s"])
    lu = c["r_w"] * (U - c["uref_s"])
    lxx = torch.diag_embed(c["q_w"])
    luu = torch.diag_embed(c["r_w"])
    E = foot_placement_jacobian(X)
    D = c["c3"][:, :, None] * E                          # [N, 12, 24]
    prel = X[..., 12:24] - X[..., 3:6].repeat(1, 1, 4)
    d_r = prel[:, :-1] - c["prelref_r"]
    lx = lx + torch.einsum("kji,bkj->bki", D, c["qfoot_r"] * d_r)
    lxx = lxx + torch.einsum("kji,kj,kjl->kil", D, c["qfoot_r"], D)
    # ReB friction-pyramid Gauss-Newton terms (constant facet Jacobian)
    gu = facet_jacobian(mu, X)
    g = friction_values(U, mu)
    d1, d2 = penalty.reb_barrier_d(g, reb_delta, reb_act)
    lu = lu + (reb_eps * d1) @ gu
    luu = luu + torch.einsum("bkf,fi,fj->bkij", reb_eps * d2, gu, gu)
    rm = c["run_m"] * c["dt"]
    lx = lx * rm[:, None]
    lu = lu * rm[:, None]
    lxx = (lxx * rm[:, None, None]).expand(Bsz, N, 24, 24)
    luu = luu * rm[:, None, None]

    # terminal partials + AL touchdown (HKDConstraints.cpp:68-160); qfoot_t
    # carries the contact mask, so E goes unmasked
    phix = c["qf_t"] * (X - c["xref_k"])
    phixx = torch.diag_embed(c["qf_t"])
    d_t = prel - c["prelref_t"]
    phix = phix + 20.0 * torch.einsum("ji,bkj->bki", E, c["qfoot_t"] * d_t)
    phixx = phixx + 20.0 * torch.einsum("kj,ji,jl->kil", c["qfoot_t"], E, E)
    ag, ah = penalty.al_partials(hkd.foot_heights(X),
                                 hkd.touchdown_height_partials(X), al_lam,
                                 al_sig, al_act)
    tm = c["term_m"]
    phix = (phix + ag) * tm[:, None]
    phixx = (phixx + ah) * tm[:, None, None]
    return tuple(t.contiguous() for t in (A, Bm, lx, lu, lxx, luu, phix,
                                          phixx))


def _check(X, U, reb_delta, reb_eps, reb_act, al_lam, al_sig, al_act,
           table):
    Bsz, NK = X.shape[:2]
    N = NK - 1
    want = dict(X=(Bsz, NK, 24), U=(Bsz, N, 24), reb_delta=(Bsz, N, 20),
                reb_eps=(Bsz, N, 20), reb_act=(Bsz, N, 20),
                al_lam=(Bsz, NK, 4), al_sig=(Bsz, NK, 4), al_act=(Bsz, NK, 4),
                table=(NK, hkd_table.NCOLS))
    got = dict(X=X, U=U, reb_delta=reb_delta, reb_eps=reb_eps,
               reb_act=reb_act, al_lam=al_lam, al_sig=al_sig, al_act=al_act, table=table)
    hkd_table.check_operands("hkd_lq", got, want, X)


def hkd_lq(X, U, reb_delta, reb_eps, reb_act, al_lam, al_sig, al_act,
           table, mu):
    """HKD LQ approximation; CUDA tensors run the hand kernel, CPU tensors
    the plain twin."""
    args = (X, U, reb_delta, reb_eps, reb_act, al_lam, al_sig, al_act,
            table)
    _check(*args)
    if X.device.type == "cpu":
        return hkd_lq_reference(*args, mu)
    if X.device.type != "cuda":
        raise ValueError(f"hkd_lq: no kernel for device {X.device}")
    Bsz, NK = X.shape[:2]
    N = NK - 1
    mat = X.new_empty(Bsz, N, 24, 24)
    outs = [mat, torch.empty_like(mat), X.new_empty(Bsz, N, 24),
            X.new_empty(Bsz, N, 24), torch.empty_like(mat),
            torch.empty_like(mat), X.new_empty(Bsz, NK, 24),
            X.new_empty(Bsz, NK, 24, 24)]
    _ext.launch("hkd_lq", X.dtype, Bsz, N, 24, 24,
                [t.contiguous() for t in args], outs, doubles=(mu,))
    hkd_lq.launches += 1
    return tuple(outs)


hkd_lq.launches = 0
