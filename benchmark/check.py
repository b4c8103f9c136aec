"""The numbers that decide `correct`: the program's answers against the
plain reference's (`benchmark/reference/plain`), each number beside the
limit that the workload file states.

`sample` draws what is compared from the seed; `batched_numbers` and
`replan_numbers` reduce answers to the numbers.  A program answer that
failed (no success or a non-finite cost) where the reference succeeded
reads infinite; an answer the reference itself fails on is left out.
"""
import math

import numpy as np


def sample(seed, n_units, n_pick, must=()):
    """n_pick distinct unit indices of range(n_units), drawn from the
    seed, with the indices in `must` always among them; sorted."""
    rng = np.random.default_rng(seed)
    pick = set(i for i in must if 0 <= i < n_units)
    rest = [i for i in range(n_units) if i not in pick]
    extra = max(0, min(n_pick - len(pick), len(rest)))
    pick.update(int(i) for i in rng.choice(rest, size=extra, replace=False))
    return sorted(pick)


def rel_gap(got, want):
    """|got - want| / |want|, or infinity where got is not finite."""
    if not math.isfinite(got):
        return math.inf
    return abs(got - want) / max(abs(want), 1e-300)


def norm_gap(got, want):
    """max |got - want| over max |want| (at least 1e-12)."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    if not np.isfinite(got).all():
        return math.inf
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-12))


def second_largest(values):
    """The second-largest of values (the largest where there is one):
    one scenario cannot move it, two can."""
    s = sorted(values, reverse=True)
    return s[1] if len(s) > 1 else (s[0] if s else math.inf)


def batched_numbers(cost_p, ok_p, cost_r, ok_r, X_p, X_r, K_p, K_r,
                    last_rows):
    """Numbers of a batched cell.  cost_*, ok_* [S] over the sampled
    scenarios; X_*, K_*: the trajectories and feedback gains of the rows
    `last_rows` of the sample (the window's last solve).  Returns
    {name: value}: the worst relative cost gap; the worst normalized gap
    of a trajectory and of a gain sequence; and the second-largest of
    each over the last solve's scenarios (`traj_gap_2nd`,
    `gain_gap_2nd`), which the rare scenario whose f32 Riccati sweep
    amplifies rounding at one knot cannot move and a fault in two
    scenarios does.  A scenario the program failed and the reference
    solved reads infinite; one the reference failed is left out."""
    cost_gap, n = 0.0, 0
    for cp, op, cr, orf in zip(cost_p, ok_p, cost_r, ok_r):
        if not (orf and math.isfinite(cr)):
            continue
        n += 1
        cost_gap = max(cost_gap, rel_gap(cp, cr) if op else math.inf)
    traj, gain = [], []
    for i in last_rows:
        if ok_r[i] and math.isfinite(cost_r[i]):
            traj.append(norm_gap(X_p[i], X_r[i]) if ok_p[i] else math.inf)
            gain.append(norm_gap(K_p[i], K_r[i]) if ok_p[i] else math.inf)
    return dict(cost_gap=cost_gap if n else math.inf,
                traj_gap=max(traj, default=math.inf),
                gain_gap=max(gain, default=math.inf),
                traj_gap_2nd=second_largest(traj),
                gain_gap_2nd=second_largest(gain), compared=n)


def replan_numbers(pairs):
    """Numbers of a replan cell from [(program answer, reference answer)]
    of the sampled updates: the worst relative cost gap and the worst
    normalized gap of a command-tape field."""
    cost_gap, tape_gap, n = 0.0, 0.0, 0
    for p, r in pairs:
        if not (r["success"] and math.isfinite(r["cost"])):
            continue
        n += 1
        if not p["success"]:
            cost_gap = tape_gap = math.inf
            continue
        cost_gap = max(cost_gap, rel_gap(p["cost"], r["cost"]))
        for k, want in r["tape"].items():
            tape_gap = max(tape_gap, norm_gap(p["tape"][k], want))
    return dict(cost_gap=cost_gap if n else math.inf, tape_gap=tape_gap,
                compared=n)


def verdict(numbers, limits):
    """({name: {"value", "limit"}}, correct): every limited number at or
    under its limit (a NaN fails)."""
    checks = {k: {"value": numbers[k], "limit": lim}
              for k, lim in limits.items()}
    ok = all(v["value"] <= v["limit"] for v in checks.values())
    return checks, ok
