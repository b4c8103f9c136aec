"""Fused linear rollout: the CUDA kernel's wrapper and its plain PyTorch
twin.

Replaces the Pallas kernel `cafempc_tpu/ops/fused_linroll.py::
fused_linear_rollout` (pallas_call at fused_linroll.py:73), reached in the
JAX package through `linroll_op`.  The kernel itself is `csrc/linroll.cu`.

    dx_{k+1} = M_k dx_k + c_k,  dx_0 = dx0;  returns dX[1:]

M [B,N,xs,xs], c [B,N,xs], dx0 [B,xs] -> [B,N,xs].  The caller assembles
M = A + BK on dynamics steps and the reset partial (or 0) otherwise.

`linroll` dispatches on device: CUDA tensors launch the kernel (a build or
launch failure raises), CPU tensors run `linroll_reference`.
`linroll.launches` counts kernel launches.  Widths the kernel does not take
(xs > 40) and plans of no step raise `ValueError` on every device; so do,
on every device but the CPU, other dtypes than float32 and float64 and rows
of xs values that are not a multiple of 16 bytes (the kernel brings each
knot's operands into shared memory by bulk copies, which move whole
16-byte units).  The solver calls linroll beside the sweep, whose limits
are the same (`ops/sweep.py`).
"""
import torch

from cafempc_tpu_torch.ops import _ext

MAX_XS = 40       # csrc/linroll.cu kMaxXs: lane r owns rows r and r + 32
ROW_ALIGN = 16    # bytes: the unit and alignment of a bulk copy
DTYPES = (torch.float32, torch.float64)


def linroll_reference(M, c, dx0):
    """Plain PyTorch twin of the linroll kernel."""
    dx = dx0
    out = []
    for k in range(M.shape[1]):
        dx = (M[:, k] @ dx.unsqueeze(-1)).squeeze(-1) + c[:, k]
        out.append(dx)
    return torch.stack(out, dim=1)


def _check(M, c, dx0):
    Bsz, N, xs = c.shape
    for name, t, shape in (("M", M, (Bsz, N, xs, xs)), ("c", c, (Bsz, N, xs)),
                           ("dx0", dx0, (Bsz, xs))):
        if tuple(t.shape) != shape:
            raise ValueError(f"linroll: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != M.dtype or t.device != M.device:
            raise ValueError(f"linroll: {name} is {t.dtype} on {t.device}, "
                             f"expected {M.dtype} on {M.device}")
    if not (1 <= xs <= MAX_XS and N >= 1):
        raise ValueError(f"linroll: no kernel for xs={xs}, N={N} (it takes "
                         f"1 <= xs <= {MAX_XS}, N >= 1)")
    if M.device.type == "cpu":
        return
    if M.dtype not in DTYPES:
        raise ValueError(f"linroll: no kernel for dtype {M.dtype}")
    if xs * M.element_size() % ROW_ALIGN:
        raise ValueError(f"linroll: no kernel for xs={xs} in {M.dtype}: the "
                         f"kernel takes rows of a multiple of {ROW_ALIGN} "
                         "bytes")


def linroll(M, c, dx0):
    """Affine rollout; CUDA tensors run the hand kernel, CPU tensors the
    plain twin."""
    _check(M, c, dx0)
    if M.device.type == "cpu":
        return linroll_reference(M, c, dx0)
    if M.device.type != "cuda":
        raise ValueError(f"linroll: no kernel for device {M.device}")
    Bsz, N, xs = c.shape
    # a view that does not start on a 16-byte boundary is copied, since a
    # bulk copy reads from 16-byte aligned addresses only
    ins = [t.contiguous() for t in (M, c, dx0)]
    ins = [t if t.data_ptr() % ROW_ALIGN == 0 else t.clone() for t in ins]
    out = M.new_empty(Bsz, N, xs)
    _ext.launch("linroll", M.dtype, Bsz, N, xs, 0, ins, [out])
    linroll.launches += 1
    return out


linroll.launches = 0
