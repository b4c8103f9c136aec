"""`hsddp.ls_iters`: line-search trials a batched solve, summed over its
scenarios (`SolveResult.info.ls_iters`), mean over the window's solves.
The counter stays on the card until the window has closed."""
WRAPPERS = ()


def read(rec):
    ls = rec.get("ls_iters")
    return sum(ls) / len(ls) if ls else None
