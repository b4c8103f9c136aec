"""numpy <-> torch for plans, penalties, trajectories and solver results.

Both packages solve the same inputs: a plan, penalties and an initial
trajectory built on the host in numpy go to the port with `from_numpy`,
and any port result (a NamedTuple tree of tensors, e.g. `SolveResult`)
comes back with `to_numpy` for comparison with the JAX package's.
"""
import numpy as np
import torch


def from_numpy(tree, device, dtype):
    """Arrays (and nested NamedTuples and tuples of them) -> tensors on
    `device` (always copies); floating arrays take `dtype`, integer and
    bool arrays keep their kind."""
    if isinstance(tree, tuple):
        vals = [from_numpy(v, device, dtype) for v in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*vals)
        return type(tree)(vals)
    a = np.asarray(tree)
    if a.dtype.kind == "f":
        return torch.tensor(a, dtype=dtype, device=device)
    return torch.tensor(a, device=device)


def to_numpy(tree):
    """Tensors (and nested NamedTuples and tuples of them) -> numpy arrays
    on the host."""
    if isinstance(tree, tuple):
        vals = [to_numpy(v) for v in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*vals)
        return type(tree)(vals)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)
