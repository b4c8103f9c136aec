"""`device.idle_pct.batched`: 100 (1 - busy / wall) over the profiled
batched solves; busy is the union of the device ops' intervals."""
WRAPPERS = ("profile",)


def read(rec):
    p = rec.get("profile")
    if not p or "n_solves" not in rec:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
