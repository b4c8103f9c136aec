"""Fused HS-DDP Riccati backward sweep: the CUDA kernel's wrapper and its
plain PyTorch twin.

Replaces the Pallas kernel `cafempc_tpu/ops/fused_sweep.py::
fused_backward_sweep` (pallas_call at fused_sweep.py:288), reached in the
JAX package through `ops/sweep_bridge.py::sweep_op`.  The kernel itself is
`csrc/sweep.cu`.

Per scenario the whole N-step recursion runs in reverse; per step k:
  dynamics step (w=0):   Gn = G' + H' d_{k+1}; Q-expansion; reg on Qxx and
                         Quu; Cholesky of Quu - 1e-9 I with the Pallas
                         kernel's pivot rule; K, dU; value update; dV sums;
  transform step (w=1):  G = lx + A^T Gn, H = lxx + A^T H' A (the caller
                         merges phix/phixx into the lx/lxx streams), with
                         K, dU, Qu, Qux zero and Quu = I.

Shapes (batch-leading): A [B,N,xs,xs], Bm [B,N,xs,us], lx [B,N,xs],
lu [B,N,us], lxx [B,N,xs,xs], luu [B,N,us,us], lux [B,N,us,xs],
phix_T [B,xs], phixx_T [B,xs,xs], defect [B,N+1,xs] (entry k+1 is used at
step k), w [N] int32, reg [B].  Returns G [B,N,xs], H [B,N,xs,xs],
K [B,N,us,xs], dU [B,N,us], Qu [B,N,us], Quu [B,N,us,us], Qux [B,N,us,xs],
ok [B] (1.0 / 0.0), dv [B,2] = (sum Qu.dU, -sum Qu.dU).

`sweep` dispatches on the tensors' device: CUDA tensors launch the
kernel (a build or launch failure raises), CPU tensors run
`sweep_reference`.  `sweep.launches` counts kernel launches.  Widths the
kernel does not take (xs > 40 or us > 32) raise `ValueError` on every
device; so do, on every device but the CPU, rows of xs or us values that
are not a multiple of 16 bytes (the kernel copies its operands into
shared memory by bulk copies, which move whole 16-byte units).
"""
import torch

from cafempc_tpu_torch.ops import _ext

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


def _check(A, Bm, lx, lu, lxx, luu, lux, phix_T, phixx_T, defect, w, reg):
    Bsz, N, xs = lx.shape
    us = lu.shape[-1]
    if not (1 <= xs <= MAX_XS and 1 <= us <= MAX_US and N >= 1):
        raise ValueError(f"sweep: no kernel for xs={xs}, us={us}, N={N} "
                         f"(it takes 1 <= xs <= {MAX_XS}, 1 <= us <= "
                         f"{MAX_US}, N >= 1)")
    row_bytes = (xs * A.element_size(), us * A.element_size())
    if A.device.type != "cpu" and any(n % ROW_ALIGN for n in row_bytes):
        raise ValueError(f"sweep: no kernel for xs={xs}, us={us} in "
                         f"{A.dtype}: the kernel takes rows of a multiple "
                         f"of {ROW_ALIGN} bytes")
    want = dict(A=(Bsz, N, xs, xs), Bm=(Bsz, N, xs, us), lx=(Bsz, N, xs),
                lu=(Bsz, N, us), lxx=(Bsz, N, xs, xs), luu=(Bsz, N, us, us),
                lux=(Bsz, N, us, xs), phix_T=(Bsz, xs),
                phixx_T=(Bsz, xs, xs), defect=(Bsz, N + 1, xs), reg=(Bsz,))
    got = dict(A=A, Bm=Bm, lx=lx, lu=lu, lxx=lxx, luu=luu, lux=lux,
               phix_T=phix_T, phixx_T=phixx_T, defect=defect, reg=reg)
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"sweep: {name} has shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
        if t.dtype != A.dtype or t.device != A.device:
            raise ValueError(f"sweep: {name} is {t.dtype} on {t.device}, "
                             f"expected {A.dtype} on {A.device}")
    if tuple(w.shape) != (N,) or w.dtype != torch.int32 \
            or w.device != A.device:
        raise ValueError("sweep: w must be int32 [N] on the operands' device")


def sweep(A, Bm, lx, lu, lxx, luu, lux, phix_T, phixx_T, defect, w, reg):
    """Riccati backward sweep; CUDA tensors run the hand kernel, CPU
    tensors the plain twin."""
    args = (A, Bm, lx, lu, lxx, luu, lux, phix_T, phixx_T, defect, w, reg)
    _check(*args)
    if A.device.type == "cpu":
        return sweep_reference(*args)
    if A.device.type != "cuda":
        raise ValueError(f"sweep: no kernel for device {A.device}")
    Bsz, N, xs = lx.shape
    us = lu.shape[-1]
    # a view that does not start on a 16-byte boundary is copied, since a
    # bulk copy reads from 16-byte aligned addresses only
    ins = [t.contiguous() for t in args]
    ins = [t if t.data_ptr() % ROW_ALIGN == 0 else t.clone() for t in ins]
    G = A.new_empty(Bsz, N, xs)
    H = A.new_empty(Bsz, N, xs, xs)
    K = A.new_empty(Bsz, N, us, xs)
    dU = A.new_empty(Bsz, N, us)
    Qu = A.new_empty(Bsz, N, us)
    Quu = A.new_empty(Bsz, N, us, us)
    Qux = A.new_empty(Bsz, N, us, xs)
    ok = A.new_empty(Bsz)
    dv = A.new_empty(Bsz, 2)
    _ext.launch("sweep", A.dtype, Bsz, N, xs, us, ins,
                [G, H, K, dU, Qu, Quu, Qux, ok, dv])
    sweep.launches += 1
    return G, H, K, dU, Qu, Quu, Qux, ok, dv


sweep.launches = 0
