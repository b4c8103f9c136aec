"""Scenario-batched solving on one device (port of
`cafempc_tpu/parallel/mesh.py::make_batched_solver`).

In the JAX package the per-scenario solve is vmapped (and shard_mapped
over a device mesh); here the solver is batched natively, so the batched
solver is the solver itself.  Device meshes (scenario and knot sharding)
are not ported yet.
"""
from cafempc_tpu_torch.solver.hsddp import make_solver


def make_batched_solver(fns, opts, *, all_shooting=True, mesh=None,
                        trim_output=True, parallel_line_search=False,
                        fused_riccati=True, fused_forward=None,
                        fused_lq=None, **solver_kwargs):
    """Returns solve_batch(plan, pen_b, x0_b, Xbar_b, Ubar_b), the same
    call as the JAX package's: plan shared, the rest with a leading
    scenario dim.  `fns` is a ProblemFns or a SegmentedFns.  The keyword
    arguments name the JAX configuration; the port runs all-shooting,
    sequential line search and the fused sweep and linear rollout, and
    raises for a variant it has not ported.  trim_output=False returns the
    final SolverState; `fused_forward` and `fused_lq` (e.g. the HKD hooks
    of problems/hkd_fused.py) go to make_solver."""
    if not (all_shooting and fused_riccati) \
            or parallel_line_search or mesh is not None:
        raise NotImplementedError(
            "ported: all_shooting=True, parallel_line_search=False, "
            "fused_riccati=True, mesh=None")
    return make_solver(fns, opts, fused_forward=fused_forward,
                       fused_lq=fused_lq, trim_output=trim_output,
                       **solver_kwargs)


def broadcast_batch(tree, batch):
    """Repeat an unbatched tensor, or a NamedTuple of them (e.g.
    PenaltyParams), along a new leading scenario dim of size `batch`."""
    if hasattr(tree, "_fields"):
        return type(tree)(*[broadcast_batch(t, batch) for t in tree])
    return tree.unsqueeze(0).expand((batch,) + tuple(tree.shape)).contiguous()
