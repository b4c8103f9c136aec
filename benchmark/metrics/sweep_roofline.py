"""`sweep_roofline`: least time over measured time of the
work launched inside each `ops.sweep.sweep` call of the profiled solves,
summed over the calls.  The least time is the larger of the call's
tensor inputs read once plus its outputs written once at the HBM peak,
and `roofline.sweep_flops` at the f32 (f64) peak; the measured time is
the device time of the ops between the call's two markers."""
WRAPPERS = ("profile", "mark.sweep")


def read(rec):
    calls = rec.get("marks", {}).get("sweep")
    if not calls:
        return None
    return 100.0 * sum(b for b, _ in calls) / sum(d for _, d in calls)
