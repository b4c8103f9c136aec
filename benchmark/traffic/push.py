"""Traffic `push`: `batched`'s closed loop of back-to-back batched HS-DDP
solves, on start states pushed in one slice of the state only.

Workload parameters: `batch`, `pool`, `warmup`, `profile_units` and the
check as in `batched`; `push_states` [lo, hi] and `push_sigma`: each
start state is the problem's nominal start with N(0, push_sigma^2) added
to entries lo:hi (the barrel roll's body linear velocity is 18:21) and
nothing added elsewhere.  The nominal start must not depend on the gait
(a trajectory optimization's fixed start).

The pool is `batched`'s own draw on the card from the seed, with a
per-entry sigma that is zero outside the pushed slice; the window, the
sample that the check compares, the reference, the numbers, the control
and the planted fault are `batched`'s.
"""
import types

import torch

from benchmark.traffic import batched
from benchmark.traffic.batched import (control, fault,  # noqa: F401
                                       numbers, reference)


def run(ctx):
    wl = ctx.params
    lo, hi = wl["push_states"]
    n = len(ctx.problem.nominal_x0(ctx.cfg, None))
    sigma = torch.zeros(n, dtype=torch.float64, device=ctx.device)
    sigma[lo:hi] = wl["push_sigma"]
    params = dict(wl, x0_sigma=sigma, gait_seconds=None)
    return batched.run(types.SimpleNamespace(**dict(vars(ctx),
                                                    params=params)))
