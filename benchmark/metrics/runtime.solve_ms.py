"""`runtime.solve_ms`: median over the window's updates of the runtime's
own span `timing["solve_ms"]` (the B=1 solve, synced on both sides)."""
import statistics

WRAPPERS = ()


def read(rec):
    t = rec.get("timing")
    return statistics.median(x["solve_ms"] for x in t) if t else None
