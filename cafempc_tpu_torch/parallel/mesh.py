"""Scenario-batched solving, on one device or over a device mesh (port of
`cafempc_tpu/parallel/mesh.py`).

In the JAX package the per-scenario solve is vmapped and, over a mesh,
shard_mapped.  Here the solver is batched natively, so without a mesh the
batched solver is the solver itself, built with the same keywords and
defaults.  A `Mesh` names devices on axes: over its "scenario" axis the
batch is split into equal shards, each solved on its own device, and
where it also has a "knot" axis the backward Riccati sweep of each shard
runs knot-sharded over that axis's devices (`parallel/knot_riccati.py`).

One process drives the mesh, with no collective library: the shards'
inputs are copied to their devices and the results gathered onto the
first.  The solver syncs the host at each of its loop tests, so the
shards' solves run one after another; what a shard launches between two
syncs may overlap on the devices with nothing else.  The knot blocks of
one sweep are launched without a sync, so blocks on different devices may
overlap.  A device may appear more than once in a mesh (e.g. four blocks
of a knot axis on one card).
"""
import numpy as np
import torch

from cafempc_tpu_torch.solver.hsddp import make_solver


class Mesh:
    """Devices on named axes (the counterpart of jax.sharding.Mesh):
    `devices` an array of torch.device, one dimension per name of
    `axis_names`; `shape` maps each axis name to its size."""

    def __init__(self, devices, axis_names):
        devs = np.empty(np.shape(devices), dtype=object)
        for i, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            devs[i] = torch.device(d)
        axis_names = tuple(axis_names)
        if devs.ndim != len(axis_names):
            raise ValueError(f"Mesh: {devs.ndim} device dimensions, "
                             f"{len(axis_names)} axis names")
        self.devices = devs
        self.axis_names = axis_names

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self):
        return f"Mesh({self.shape}, {self.devices.ravel().tolist()})"


def visible_devices(devices=None, need=None):
    """`devices` as torch.devices, or by default the visible CUDA devices;
    raises without any (there is no CPU fallback), and ValueError when
    fewer than `need`."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("no CUDA device is visible: a mesh takes the "
                               "visible CUDA devices, or explicit devices= "
                               "(e.g. [torch.device('cpu')] * 8)")
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        devs = [torch.device(d) for d in devices]
    if need is not None and len(devs) < need:
        raise ValueError(f"need {need} devices, have {len(devs)}")
    return devs


def scenario_mesh(n_devices=None, axis_name="scenario", devices=None):
    """1D mesh over the first `n_devices` of `devices` (default: every
    visible CUDA device)."""
    devs = visible_devices(devices, n_devices)
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs, dtype=object), (axis_name,))


def scenario_knot_mesh(n_scenario, n_knot, axis_name="scenario",
                       knot_axis_name="knot", devices=None):
    """2D (scenario, knot) mesh: scenario shards, each with its backward
    sweep knot-sharded along the second axis (row i of the mesh holds shard
    i's knot blocks)."""
    need = n_scenario * n_knot
    devs = visible_devices(devices, need)
    return Mesh(np.array(devs[:need], dtype=object).reshape(n_scenario,
                                                            n_knot),
                (axis_name, knot_axis_name))


class Shards(tuple):
    """One tensor's parts over a mesh's scenario shards, the i-th on shard
    i's device: pieces of its leading dim (`shard_batch`) or whole copies
    (`replicate`)."""


def _tree_map(fn, tree):
    if isinstance(tree, Shards) or torch.is_tensor(tree):
        return fn(tree)
    vals = [_tree_map(fn, t) for t in tree]
    return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)


def shard_rows(mesh, axis_name="scenario", knot_axis_name="knot"):
    """[(device, knot devices)] per scenario shard: the shard solves on the
    first device of its row, and its sweep's knot blocks sit on the row's
    devices along `knot_axis_name` (one device without that axis)."""
    names = mesh.axis_names
    if axis_name not in names or not set(names) <= {axis_name,
                                                    knot_axis_name}:
        raise ValueError(f"mesh axes {names}: expected ({axis_name!r},) or "
                         f"({axis_name!r}, {knot_axis_name!r})")
    devs = mesh.devices
    if knot_axis_name not in names:
        return [(d, [d]) for d in devs]
    if names.index(axis_name) == 1:
        devs = devs.T
    return [(row[0], list(row)) for row in devs]


def _shard_devices(mesh, axis_name):
    """The device of each scenario shard: along `axis_name`, the first
    device of the other axes."""
    ax = mesh.axis_names.index(axis_name)
    return list(np.moveaxis(mesh.devices, ax, 0).reshape(
        mesh.shape[axis_name], -1)[:, 0])


def shard_batch(tree, mesh, axis_name="scenario"):
    """Split the leading (scenario) dim of every tensor of a tree into the
    mesh's scenario shards, each moved to its shard's device (`Shards`
    leaves).  The batch must divide evenly, as under shard_map."""
    devs = _shard_devices(mesh, axis_name)

    def split(t):
        if isinstance(t, Shards):
            return t
        if t.shape[0] % len(devs):
            raise ValueError(f"shard_batch: a batch of {t.shape[0]} does "
                             f"not split into {len(devs)} equal shards")
        return Shards(p.to(d) for p, d in zip(t.chunk(len(devs)), devs))
    return _tree_map(split, tree)


def replicate(tree, mesh, axis_name="scenario"):
    """A copy of every tensor of a tree on each scenario shard's device
    (`Shards` leaves)."""
    devs = _shard_devices(mesh, axis_name)
    return _tree_map(lambda t: t if isinstance(t, Shards)
                     else Shards(t.to(d) for d in devs), tree)


def _part(tree, i, n, device, split):
    """Shard i of n of a tree on `device`: a `Shards` leaf's part i, or a
    tensor's i-th piece of its leading dim (split) or the whole tensor."""
    def part(t):
        if isinstance(t, Shards):
            return t[i].to(device)
        if split and n > 1:
            if t.shape[0] % n:
                raise ValueError(f"a batch of {t.shape[0]} does not split "
                                 f"into {n} equal scenario shards")
            t = t.chunk(n)[i]
        return t.to(device)
    return _tree_map(part, tree)


def make_batched_solver(fns, opts, *, all_shooting=True, mesh=None,
                        axis_name="scenario", trim_output=True,
                        knot_axis_name="knot", **solver_kwargs):
    """Returns solve_batch(plan, pen_b, x0_b, Xbar_b, Ubar_b), the same
    call as the JAX package's: plan shared, the rest with a leading
    scenario dim.  `fns` is a ProblemFns or a SegmentedFns; the other
    keywords go to `solver.hsddp.make_solver` with the JAX defaults (masked
    resets, the exact sequential sweep, the scan linear rollout, the
    batched line search), e.g. `fused_riccati=True,
    parallel_line_search=False, max_resets=16` for the kernel path, and
    `fused_forward` / `fused_lq` for the HKD hooks of problems/hkd_fused.py.
    trim_output=False returns the final SolverState.

    mesh: a `Mesh` (`scenario_mesh`, `scenario_knot_mesh`).  The batch is
    split into equal shards over `axis_name` and shard i is solved on its
    row's first device; where the mesh's `knot_axis_name` axis is larger
    than 1, each shard's backward sweep runs knot-sharded over its row
    (make_solver's knot_axis, which excludes fused_riccati).  The inputs
    may be tensors (split and copied at each call) or `shard_batch` /
    `replicate` trees.  One result in scenario order on the first shard's
    device.  Unlike the JAX package, where every knot rank recomputes the
    non-sweep stages, each shard's other stages run once; the shards run
    one after another (module docstring)."""
    if mesh is None:
        return make_solver(fns, opts, all_shooting=all_shooting,
                           trim_output=trim_output, **solver_kwargs)
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh: expected a parallel.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    rows = shard_rows(mesh, axis_name, knot_axis_name)
    n_knot = mesh.shape.get(knot_axis_name, 1)
    solvers = []
    for _, knot_devs in rows:
        kw = dict(solver_kwargs)
        if n_knot > 1:
            kw.update(knot_axis=knot_axis_name, knot_shards=n_knot,
                      knot_devices=knot_devs)
        solvers.append(make_solver(fns, opts, all_shooting=all_shooting,
                                   trim_output=trim_output, **kw))
    n = len(rows)

    def solve_batch(plan, pen_b, x0_b, Xbar_b, Ubar_b):
        outs = []
        for i, ((dev, _), solve) in enumerate(zip(rows, solvers)):
            outs.append(solve(_part(plan, i, n, dev, False),
                              *[_part(a, i, n, dev, True)
                                for a in (pen_b, x0_b, Xbar_b, Ubar_b)]))
        if n == 1:
            return outs[0]
        first = rows[0][0]
        return _gather(outs, first)

    return solve_batch


def _gather(outs, device):
    """Concatenate the shards' result trees along the scenario dim on
    `device`."""
    if torch.is_tensor(outs[0]):
        return torch.cat([o.to(device) for o in outs], 0)
    vals = [_gather(parts, device) for parts in zip(*outs)]
    return type(outs[0])(*vals) if hasattr(outs[0], "_fields") \
        else type(outs[0])(vals)


def broadcast_batch(tree, batch):
    """Repeat an unbatched tensor, or a NamedTuple of them (e.g.
    PenaltyParams), along a new leading scenario dim of size `batch`."""
    if hasattr(tree, "_fields"):
        return type(tree)(*[broadcast_batch(t, batch) for t in tree])
    return tree.unsqueeze(0).expand((batch,) + tuple(tree.shape)).contiguous()
