"""`runtime.build_ms`: median over the window's updates of the runtime's
own span `timing["build_ms"]` (host plan build, warm start and the copy
to the card; runtime/mpc.py and runtime/mhpc_runtime.py)."""
import statistics

WRAPPERS = ()


def read(rec):
    t = rec.get("timing")
    return statistics.median(x["build_ms"] for x in t) if t else None
