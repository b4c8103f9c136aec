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
`linroll.launches` counts kernel launches.
"""
import torch

from cafempc_tpu_torch.ops import _ext


def linroll_reference(M, c, dx0):
    """Plain PyTorch twin of the linroll kernel."""
    dx = dx0
    out = []
    for k in range(M.shape[1]):
        dx = (M[:, k] @ dx.unsqueeze(-1)).squeeze(-1) + c[:, k]
        out.append(dx)
    return torch.stack(out, dim=1)


def linroll(M, c, dx0):
    """Affine rollout; CUDA tensors run the hand kernel, CPU tensors the
    plain twin."""
    Bsz, N, xs = c.shape
    for name, t, shape in (("M", M, (Bsz, N, xs, xs)), ("c", c, (Bsz, N, xs)),
                           ("dx0", dx0, (Bsz, xs))):
        if tuple(t.shape) != shape:
            raise ValueError(f"linroll: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != M.dtype or t.device != M.device:
            raise ValueError(f"linroll: {name} is {t.dtype} on {t.device}, "
                             f"expected {M.dtype} on {M.device}")
    if M.device.type == "cpu":
        return linroll_reference(M, c, dx0)
    if M.device.type != "cuda":
        raise ValueError(f"linroll: no kernel for device {M.device}")
    out = M.new_empty(Bsz, N, xs)
    _ext.launch("linroll", M.dtype, Bsz, N, xs, 0,
                [M.contiguous(), c.contiguous(), dx0.contiguous()], [out])
    linroll.launches += 1
    return out


linroll.launches = 0
