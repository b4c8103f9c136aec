"""The plain PyTorch Riccati backward sweep of the benchmark's reference: a
frozen copy of `cafempc_tpu_torch/ops/sweep.py`'s twin (`sweep_reference`,
the hand kernel's pivot rule), with no kernel.  `sweep` is the twin, so
the copied solver runs it whatever its keywords ask for."""
import torch

PIVOT_SHIFT = 1e-9    # Cholesky of Quu - 1e-9 I (fused_sweep.py:125)
PIVOT_FLOOR = 1e-30   # rsqrt(max(d, 1e-30)) (fused_sweep.py:129)
MAX_XS = 40           # csrc/sweep.cu kMaxXs: the f64 working set fits a block
MAX_US = 32           # csrc/sweep.cu kMaxUs: one warp lane per row of Quu
ROW_ALIGN = 16        # bytes: the unit and alignment of a bulk copy


def cholesky_pivot_rule(Quu):
    """Batched Cholesky factor of `Quu` [..., n, n] with the Pallas
    kernel's PSD rule (fused_sweep.py:121-139): the pivot
    d_j = Quu_jj - 1e-9 - sum_k L_jk^2 counts as positive only if d_j > 0,
    and column j is scaled by rsqrt(max(d_j, 1e-30)), so the diagonal is
    L_jj = (Quu_jj - sum_k L_jk^2) / sqrt(d_j).  Returns (L, ok [...])."""
    n = Quu.shape[-1]
    L = torch.zeros_like(Quu)
    ok = torch.ones(Quu.shape[:-2], dtype=torch.bool, device=Quu.device)
    for j in range(n):
        Lj = L[..., j, :j]
        d = Quu[..., j, j] - PIVOT_SHIFT - torch.sum(Lj * Lj, -1)
        ok = ok & (d > 0)
        dj = torch.rsqrt(torch.clamp(d, min=PIVOT_FLOOR))
        v = Quu[..., j:, j] - (L[..., j:, :j] @ Lj.unsqueeze(-1)).squeeze(-1)
        L[..., j:, j] = v * dj.unsqueeze(-1)
    return L, ok


def cho_solve(L, R):
    """Solve (L L^T) X = R for lower-triangular L [..., n, n], R [..., n, m]."""
    Y = torch.linalg.solve_triangular(L, R, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), Y, upper=True)


def sweep_reference(A, Bm, lx, lu, lxx, luu, lux, phix_T, phixx_T, defect,
                    w, reg):
    """Plain PyTorch twin of the sweep kernel: same semantics, one batched
    step at a time (see the module docstring for shapes)."""
    Bsz, N, xs = lx.shape
    us = lu.shape[-1]
    I_x = torch.eye(xs, dtype=A.dtype, device=A.device)
    I_u = torch.eye(us, dtype=A.dtype, device=A.device)
    regm = reg[:, None, None]
    G1, H1 = phix_T, phixx_T
    ok = torch.ones(Bsz, dtype=torch.bool, device=A.device)
    dv = torch.zeros(Bsz, dtype=A.dtype, device=A.device)
    wb = w > 0
    outs = []
    for k in reversed(range(N)):
        Ak, Bk = A[:, k], Bm[:, k]
        AkT, BkT = Ak.transpose(-1, -2), Bk.transpose(-1, -2)
        Gn = G1 + (H1 @ defect[:, k + 1, :, None])[..., 0]
        HA = H1.transpose(-1, -2) @ Ak
        HB = H1.transpose(-1, -2) @ Bk
        Qx = lx[:, k] + (AkT @ Gn[..., None])[..., 0]
        Qxx_base = lxx[:, k] + AkT @ HA
        Qu = lu[:, k] + (BkT @ Gn[..., None])[..., 0]
        Qxx = Qxx_base + regm * I_x
        Qxx = 0.5 * (Qxx + Qxx.transpose(-1, -2))
        Quu = luu[:, k] + BkT @ HB + regm * I_u
        Qux = lux[:, k] + BkT @ HA
        L, ok_k = cholesky_pivot_rule(Quu)
        X = -cho_solve(L, torch.cat([Qu[..., None], Qux], dim=-1))
        dU, K = X[..., 0], X[..., 1:]
        G_dyn = Qx + (Qux.transpose(-1, -2) @ dU[..., None])[..., 0]
        H_dyn = Qxx + Qux.transpose(-1, -2) @ K
        H_dyn = 0.5 * (H_dyn + H_dyn.transpose(-1, -2))
        wk = wb[k]
        G1 = torch.where(wk, Qx, G_dyn)
        H1 = torch.where(wk, Qxx_base, H_dyn)
        dv = dv + torch.where(wk, 0.0, torch.sum(Qu * dU, -1))
        ok = ok & (ok_k | wk)
        outs.append((G1, H1, torch.where(wk, 0.0, K),
                     torch.where(wk, 0.0, dU), torch.where(wk, 0.0, Qu),
                     torch.where(wk, I_u, Quu), torch.where(wk, 0.0, Qux)))
    G, H, K, dU, Qu, Quu, Qux = (torch.stack(o[::-1], dim=1)
                                 for o in zip(*outs))
    return (G, H, K, dU, Qu, Quu, Qux, ok.to(A.dtype),
            torch.stack([dv, -dv], dim=-1))


sweep = sweep_reference
