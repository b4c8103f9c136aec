"""`hkd_lq_roofline`: the same as the sweep's, around each
call of the fused LQ hook, with its bytes (the trajectory and penalties
it reads, the plan, the fields it writes; the bound is the bytes')."""
WRAPPERS = ("profile", "mark.hkd_lq")


def read(rec):
    calls = rec.get("marks", {}).get("hkd_lq")
    if not calls:
        return None
    return 100.0 * sum(b for b, _ in calls) / sum(d for _, d in calls)
