# Frozen copy of cafempc_tpu_torch/solver/plan.py, the port's plain path, for the
# benchmark's reference: imports point into benchmark/reference/plain.
"""Flat, statically-shaped multi-phase knot plans (port of
`cafempc_tpu/solver/plan.py`).

The multi-phase problem is flattened into fixed-size per-step / per-knot
arrays: each of the ``N`` step slots is a dynamics step, a reset step
(phase boundary) or inactive padding; phase-terminal knots carry terminal
costs and AL terminal constraints.  Plans are built on the host in numpy
(`problems/hkd_problem.build_hkd_plan`) and moved to the device with
`host_plan_to_device`.  The plan is shared by every scenario of a batch,
so its tensors carry no batch dimension; `PenaltyParams` are per scenario
and carry a leading batch dimension inside the solver.
"""
from typing import NamedTuple

import torch

from benchmark.reference.plain.convert import from_numpy


class StepData(NamedTuple):
    """Per-step arrays; leading dim = n_steps (padded)."""
    active: torch.Tensor        # [N] 1.0 if the step is used
    is_reset: torch.Tensor      # [N] 1.0 if reset step (phase boundary)
    dt: torch.Tensor            # [N]
    t: torch.Tensor             # [N] plan-relative time of the step start
    contact: torch.Tensor       # [N, 4] stance mask during the step
    contact_next: torch.Tensor  # [N, 4] next-phase contact (reset steps)
    x_ref: torch.Tensor         # [N, xs]
    u_ref: torch.Tensor         # [N, us]
    y_ref: torch.Tensor         # [N, ys]
    pf_ref: torch.Tensor        # [N, 12] reference foot placements
    com_ref: torch.Tensor       # [N, 3] reference CoM position
    vf_ref: torch.Tensor        # [N, 12] reference foot velocities
    ref_contact: torch.Tensor   # [N, 4] contact of the reference record at t
    model_id: torch.Tensor      # [N] 0 = primary model, 1 = tail model
    model_switch: torch.Tensor  # [N] 1 at the cascade model-switch reset
    q_diag: torch.Tensor        # [N, xs] per-step tracking weights (or [N,0])
    r_diag: torch.Tensor        # [N, us] per-step control weights (or [N,0])


class KnotData(NamedTuple):
    """Per-knot arrays; leading dim = n_steps + 1."""
    active: torch.Tensor        # [N+1]
    is_terminal: torch.Tensor   # [N+1] phase-terminal (incl. final knot)
    td_mask: torch.Tensor       # [N+1, 4] touchdown legs at this knot
    contact: torch.Tensor       # [N+1, 4] contact of the phase ending here
    ref_contact: torch.Tensor   # [N+1, 4] reference-record contact at t
    model_id: torch.Tensor      # [N+1] model owning this knot
    qf_diag: torch.Tensor       # [N+1, xs] per-knot terminal weights
    x_ref: torch.Tensor         # [N+1, xs] terminal state reference
    pf_ref: torch.Tensor        # [N+1, 12]
    com_ref: torch.Tensor       # [N+1, 3]
    t: torch.Tensor             # [N+1]


class KnotPlan(NamedTuple):
    step: StepData
    knot: KnotData

    @property
    def n_steps(self):
        return self.step.active.shape[0]


class PenaltyParams(NamedTuple):
    """AL / ReB parameter state (updated across outer iterations).

    Unbatched: reb_*: [N, n_pcon]; al_*: [N+1, n_tcon]; reb_delta_min and
    al_sigma_max scalar or [n_con].  Inside the solver every field carries
    a leading scenario dimension B.
    """
    reb_delta: torch.Tensor
    reb_eps: torch.Tensor
    reb_active: torch.Tensor
    reb_delta_min: torch.Tensor
    al_lambda: torch.Tensor
    al_sigma: torch.Tensor
    al_active: torch.Tensor
    al_sigma_max: torch.Tensor


def host_plan_to_device(plan_np, device, dtype):
    """Convert a host-side (numpy) KnotPlan or PenaltyParams to tensors on
    `device`; float arrays take `dtype`, integer arrays keep their kind."""
    return from_numpy(plan_np, device, dtype)
