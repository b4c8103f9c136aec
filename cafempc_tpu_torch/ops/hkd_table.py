"""The per-knot constant table read by the fused HKD LQ and trial kernels.

The Pallas kernels take the plan-derived constants (JAX package
`problems/hkd_fused.py::_plan_consts` plus the plan's references) as
fourteen per-knot operands and the step flags as a scalar-prefetch table.
Here they are packed once per solve into one dense [N+1, NCOLS] tensor:
row k holds the step-k columns (zero on row N, which has no step) and the
knot-k columns.  `csrc/hkd_common.cuh` (`namespace col`) holds the same
layout for the kernels; the kernels are compared with the twins, which
read the table through `unpack`, so a drift between the two shows.
"""
# (name, width); the first block is per step (rows 0..N-1), the second
# per knot (rows 0..N)
STEP_COLUMNS = (("xref_s", 24), ("uref_s", 24), ("q_w", 24), ("r_w", 24),
                ("qfoot_r", 12), ("prelref_r", 12), ("c3", 12),
                ("swing3", 12), ("td4", 4), ("lo4", 4), ("dt", 1),
                ("run_m", 1), ("is_reset", 1), ("act", 1))
KNOT_COLUMNS = (("xref_k", 24), ("qf_t", 24), ("qfoot_t", 12),
                ("prelref_t", 12), ("prev_act", 1), ("k_act", 1),
                ("term_m", 1))


def _offsets():
    out, at = {}, 0
    for name, width in STEP_COLUMNS + KNOT_COLUMNS:
        out[name] = (at, width)
        at += width
    return out, at


OFFSETS, NCOLS = _offsets()
_STEP = {name for name, _ in STEP_COLUMNS}


def pack(columns):
    """Pack a dict of the named columns (step columns [N, w] or [N], knot
    columns [N+1, w] or [N+1]) into the [N+1, NCOLS] table."""
    n_knots = columns["k_act"].shape[0]
    like = columns["k_act"]
    table = like.new_zeros(n_knots, NCOLS)
    for name, (at, width) in OFFSETS.items():
        v = columns[name].reshape(columns[name].shape[0], width)
        table[:v.shape[0], at:at + width] = v
    return table


def unpack(table):
    """The named columns as views of `table`: step columns [N, w], knot
    columns [N+1, w]; width-1 columns drop their last axis."""
    n_steps = table.shape[0] - 1
    out = {}
    for name, (at, width) in OFFSETS.items():
        v = table[:n_steps if name in _STEP else None, at:at + width]
        out[name] = v[:, 0] if width == 1 else v
    return out


def check_operands(op, got, want, like):
    """Raise unless each tensor got[name] has shape want[name] and the
    dtype and device of `like`."""
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{op}: {name} has shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
        if t.dtype != like.dtype or t.device != like.device:
            raise ValueError(f"{op}: {name} is {t.dtype} on {t.device}, "
                             f"expected {like.dtype} on {like.device}")
