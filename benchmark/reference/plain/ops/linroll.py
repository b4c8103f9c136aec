"""The plain PyTorch linear rollout of the benchmark's reference: a frozen
copy of `cafempc_tpu_torch/ops/linroll.py`'s twin, with no kernel.
`linroll` is the twin."""
import torch


def linroll_reference(M, c, dx0):
    """Plain PyTorch twin of the linroll kernel."""
    dx = dx0
    out = []
    for k in range(M.shape[1]):
        dx = (M[:, k] @ dx.unsqueeze(-1)).squeeze(-1) + c[:, k]
        out.append(dx)
    return torch.stack(out, dim=1)


linroll = linroll_reference
