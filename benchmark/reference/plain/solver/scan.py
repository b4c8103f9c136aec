# Frozen copy of cafempc_tpu_torch/solver/scan.py, the port's plain path, for the
# benchmark's reference: imports point into benchmark/reference/plain.
"""Associative scan over tuples of tensors (the counterpart of
`jax.lax.associative_scan`, which PyTorch has no stable form of).

The recursion is lax.associative_scan's own: combine adjacent pairs, scan
the half-length result, then combine each odd prefix with the next even
element and interleave.  So every prefix is the same tree of `fn` calls as
in JAX, and a non-commutative `fn` (a matrix product, a Riccati element
composition) associates the same way.
"""
import torch


def _slice(t, dim, start, stop=None, step=1):
    return t[(slice(None),) * dim + (slice(start, stop, step),)]


def _interleave(a, b, dim):
    """a[0], b[0], a[1], b[1], ... along dim (len(a) is len(b) or one
    more)."""
    n = a.shape[dim] + b.shape[dim]
    shape = list(a.shape)
    shape[dim] = n
    out = a.new_empty(shape)
    _slice(out, dim, 0, None, 2).copy_(a)
    _slice(out, dim, 1, None, 2).copy_(b)
    return out


def associative_scan(fn, elems, dim=0, reverse=False):
    """Inclusive scan of the tuple of tensors `elems` along `dim` under the
    associative `fn(a, b) -> c` (tuples of the same structure, `a` the
    earlier prefix in scan order).  reverse=True scans from the last
    element, as lax.associative_scan(..., reverse=True): `fn` then gets the
    later suffix first."""
    elems = tuple(elems)
    n = elems[0].shape[dim]
    if any(e.shape[dim] != n for e in elems):
        raise ValueError("associative_scan: every tensor needs the same "
                         f"length along dim {dim}; got "
                         f"{[tuple(e.shape) for e in elems]}")
    if reverse:
        elems = tuple(e.flip(dim) for e in elems)

    def scan(elems):
        n = elems[0].shape[dim]
        if n < 2:
            return elems
        reduced = fn(tuple(_slice(e, dim, 0, -1, 2) for e in elems),
                     tuple(_slice(e, dim, 1, None, 2) for e in elems))
        odd = scan(tuple(reduced))
        rest = tuple(_slice(e, dim, 2, None, 2) for e in elems)
        if n == 2:
            even = rest
        elif n % 2 == 0:
            even = fn(tuple(_slice(e, dim, 0, -1) for e in odd), rest)
        else:
            even = fn(odd, rest)
        even = tuple(torch.cat([_slice(e, dim, 0, 1), r], dim)
                     for e, r in zip(elems, even))
        return tuple(_interleave(a, b, dim) for a, b in zip(even, odd))

    out = scan(elems)
    if reverse:
        out = tuple(e.flip(dim) for e in out)
    return out
