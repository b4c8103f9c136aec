"""`stage.lq_ms`: stream ms a batched solve spanned by the LQ stage's
calls (the fused LQ hook, or every segment's partial callables), from
CUDA events recorded around each call in the window, with no sync."""
WRAPPERS = ("lq_events",)


def read(rec):
    ms, n = rec.get("lq_ms"), rec.get("n_solves")
    return sum(ms) / n if ms and n else None
