# Frozen copy of cafempc_tpu_torch/convert.py, the port's plain path, for the
# benchmark's reference: imports point into benchmark/reference/plain.
"""numpy <-> torch for plans, penalties, trajectories, solver results and
model constants.

Both packages solve the same inputs: a plan, penalties and an initial
trajectory built on the host in numpy go to the port with `from_numpy`,
and any port result (a NamedTuple tree of tensors, e.g. `SolveResult`)
comes back with `to_numpy` for comparison with the JAX package's;
`scenario` takes one scenario out of a batched result.  The
whole-body models cross with `rbda_model_from_numpy` and
`lane_model_from_numpy`, so that both packages can run one model edited in
memory.
"""
import numpy as np
import torch

from benchmark.reference.plain.models import rbda


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


def scenario(tree, b):
    """Scenario `b` of a NamedTuple tree of batched arrays or tensors
    [B, ...] (e.g. a SolveResult or a SolverState): each leaf's row b."""
    if isinstance(tree, tuple):
        vals = [scenario(v, b) for v in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*vals)
        return type(tree)(vals)
    return tree[b]


def rbda_model_from_numpy(m, device, dtype):
    """The port's `rbda.RBDAModel` from the JAX package's RBDAModel whose
    array leaves are numpy (e.g. `jax.tree.map(np.asarray, m)`)."""
    return rbda.make_model(m.parent, m.jtype, m.axis, m.R_tree, m.p_tree,
                           m.mass, m.com, m.inertia, m.frame_dof, m.frame_R,
                           m.frame_p, m.has_mass, device, dtype)


def lane_model_from_numpy(m, device, dtype):
    """The port's lane model (an `rbda.RBDAModel`) from the JAX package's
    WBLaneModel, whose leaves are numpy."""
    mb = set(int(b) for b in m.mb_idx)
    return rbda.make_model(m.parent, m.jtype, m.axis, m.R_tree, m.p_tree,
                           m.mass, m.com, m.inertia, m.frame_dof, m.frame_R,
                           m.frame_p, [b in mb for b in range(len(m.parent))],
                           device, dtype)
