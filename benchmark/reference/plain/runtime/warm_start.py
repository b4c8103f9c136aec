# Frozen copy of cafempc_tpu_torch/runtime/warm_start.py, the port's plain path, for the
# benchmark's reference: imports point into benchmark/reference/plain.
"""Time-aligned warm start of the MPC runtime (numpy only; counterpart of
`cafempc_tpu/runtime/warm_start.py`).

The plan is rebuilt on the host every MPC step, so the previous solution
is mapped onto the new plan by absolute knot time (+ model id).  Per model
segment: one sort of the old knot times + one searchsorted over the new
ones.  Duplicated phase-boundary times (the pre-reset terminal knot and the
post-reset phase-start knot share a time) are told apart by the
is_terminal flag: terminal knots take terminal sources and phase-start
knots take post-reset sources, the pairing the reference's shifted phase
deques preserve (HKDProblem.cpp:117-222).  Knots with no same-flag source
(window-truncation edges) fall back to matching time and contact tuple.
"""
import numpy as np


def warm_start_indices(old_knot, old_shift, new_knot, new_shift):
    """Index mapping (src, dst) of old plan knots onto new plan knots by
    absolute time + model id (+ is_terminal tie-break at duplicated
    phase-boundary times).  Plan-determined only: the same mapping applies
    to every scenario of a batch."""
    old_t = np.asarray(old_knot.t) + old_shift
    old_active = np.asarray(old_knot.active) > 0
    old_model = np.asarray(old_knot.model_id)
    old_term = np.asarray(old_knot.is_terminal) > 0
    new_t = np.asarray(new_knot.t) + new_shift
    new_active = np.asarray(new_knot.active) > 0
    new_model = np.asarray(new_knot.model_id)
    new_term = np.asarray(new_knot.is_terminal) > 0
    # contact tuple as a small integer key (for the fallback pass)
    old_ck = (np.asarray(old_knot.contact) > 0.5) @ (1 << np.arange(4))
    new_ck = (np.asarray(new_knot.contact) > 0.5) @ (1 << np.arange(4))
    srcs, dsts = [], []
    matched = np.zeros(new_t.shape[0], bool)

    def run(oi, nj):
        """Match new knots nj against old candidates oi by time; the last
        candidate (ordered by time, then index) wins."""
        if not len(oi) or not len(nj):
            return
        order = np.lexsort((oi, old_t[oi]))
        oi_s = oi[order]
        ot_s = old_t[oi][order]
        hi = np.searchsorted(ot_s, new_t[nj] + 1e-6, side="right")
        ok = hi > 0
        hit = np.clip(hi - 1, 0, len(ot_s) - 1)
        ok &= np.abs(ot_s[hit] - new_t[nj]) < 1e-6
        srcs.append(oi_s[hit[ok]])
        dsts.append(nj[ok])
        matched[nj[ok]] = True

    for m in np.unique(new_model[new_active]):
        om = old_active & (old_model == m)
        nm = new_active & (new_model == m)
        # pass 1: same is_terminal flag
        for f in (False, True):
            run(np.where(om & (old_term == f))[0],
                np.where(nm & (new_term == f) & ~matched)[0])
        # pass 2: knots without a same-flag source, matched only to an
        # equal contact tuple so that no post-reset knot takes a pre-reset
        # state (or the reverse)
        for ck in np.unique(new_ck[nm & ~matched]):
            run(np.where(om & (old_ck == ck))[0],
                np.where(nm & ~matched & (new_ck == ck))[0])
    if not srcs:
        return np.zeros(0, int), np.zeros(0, int)
    return np.concatenate(srcs), np.concatenate(dsts)


def time_aligned_warm_start(old_knot, old_shift, oXb, oUb,
                            new_knot, new_shift, Xbar0, Ubar0):
    """Map (oXb, oUb) from the old plan's knots onto the new plan's.

    old_knot/new_knot: KnotData of host numpy arrays;
    old_shift/new_shift: absolute time of each plan's t=0.
    Returns (Xb, Ub): copies of Xbar0/Ubar0 with matched rows replaced.
    """
    src, dst = warm_start_indices(old_knot, old_shift, new_knot,
                                  new_shift)
    Xb, Ub = Xbar0.copy(), Ubar0.copy()
    Xb[dst] = oXb[src]
    # terminal knots double as reset steps in the flat layout; a reset step
    # carries no control, so it neither seeds nor is seeded with a Ubar row
    new_term = np.asarray(new_knot.is_terminal) > 0
    old_term = np.asarray(old_knot.is_terminal) > 0
    um = ((dst < len(Ub)) & (src < len(oUb))
          & ~new_term[dst] & ~old_term[src])
    Ub[dst[um]] = oUb[src[um]]
    return Xb, Ub
