"""`device.launches.batched`: kernel launches (copies and fills not
counted) a profiled batched solve."""
WRAPPERS = ("profile",)


def read(rec):
    p = rec.get("profile")
    if not p or "n_solves" not in rec:
        return None
    return p["launches"]
