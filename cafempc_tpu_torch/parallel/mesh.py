"""Scenario-batched solving on one device (port of
`cafempc_tpu/parallel/mesh.py::make_batched_solver`).

In the JAX package the per-scenario solve is vmapped (and shard_mapped
over a device mesh); here the solver is batched natively, so the batched
solver is the solver itself, built with the same keywords and defaults.
Device meshes (scenario and knot sharding) are not ported yet.
"""
from cafempc_tpu_torch.solver.hsddp import make_solver


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
    trim_output=False returns the final SolverState.  A `mesh` (and with
    it `axis_name` / `knot_axis_name`) raises NotImplementedError."""
    if mesh is not None:
        raise NotImplementedError(
            f"mesh: the ({axis_name!r}, {knot_axis_name!r}) device meshes "
            f"are not ported yet (ROADMAP queue 1 step 8); the batched "
            f"solver runs on one device")
    return make_solver(fns, opts, all_shooting=all_shooting,
                       trim_output=trim_output, **solver_kwargs)


def broadcast_batch(tree, batch):
    """Repeat an unbatched tensor, or a NamedTuple of them (e.g.
    PenaltyParams), along a new leading scenario dim of size `batch`."""
    if hasattr(tree, "_fields"):
        return type(tree)(*[broadcast_batch(t, batch) for t in tree])
    return tree.unsqueeze(0).expand((batch,) + tuple(tree.shape)).contiguous()
