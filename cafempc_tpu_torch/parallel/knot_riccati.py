"""Knot-axis (sequence-parallel) Riccati sweep over devices (port of
`cafempc_tpu/parallel/knot_riccati.py`).

The associative-scan sweep (`solver/hsddp.py` `backward_sweep_parallel`)
writes the backward pass as a suffix composition of linear-fractional-
transform elements, an associative op, so distributing it is a two-level
scan:

  1. the knot axis is cut into P contiguous blocks, and each block's
     suffixes are scanned within the block (reset transforms compose like
     any other element, so phase boundaries inside or between blocks are
     handled alike).  The blocks that share a device run as one scan with
     the block index as a leading tensor dimension;
  2. the P block composites (one LFT element each) are gathered onto
     every device that holds a block; there each block's tail transform,
     the composites of all later blocks folded later-first, is applied to
     the block's suffixes.

One process drives every device: in place of JAX's `all_gather` over a
mesh axis, the composites are copied to each device.  The work a device
is given is launched without a host sync, so blocks on different devices
may overlap on the devices; the host issues them one after another.
Every tensor is batch-leading ([B, knots, ...]), as elsewhere in the port.
"""
import numpy as np
import torch

from cafempc_tpu_torch.parallel.mesh import Mesh, visible_devices
from cafempc_tpu_torch.solver.hsddp import lft_combine, riccati_lft_elements
from cafempc_tpu_torch.solver.scan import associative_scan


def knot_mesh(n_devices=None, axis="knot", devices=None):
    """A one-axis mesh over `devices` (default: the visible CUDA devices;
    a device may appear more than once), cut to the first `n_devices`."""
    devs = visible_devices(devices, n_devices)
    return Mesh(np.array(devs[:n_devices] if n_devices else devs,
                         dtype=object), (axis,))


def _identity_elem(xs, lead, dtype, device):
    """Identity LFT element with leading dims `lead`: composing it as the
    later factor leaves any element unchanged."""
    I = torch.eye(xs, dtype=dtype, device=device).expand(
        tuple(lead) + (xs, xs))
    z = torch.zeros(tuple(lead) + (xs,), dtype=dtype, device=device)
    zM = torch.zeros(tuple(lead) + (xs, xs), dtype=dtype, device=device)
    return (I, z, zM, z, zM)


def pad_elements(elems, mult):
    """Pad the knot axis (dim 1) of elements [B, N1, ...] to a multiple of
    `mult` with identity elements, appended after the terminal element (no-
    ops for every real suffix).  Returns (elements, N1)."""
    Bsz, N = elems[0].shape[:2]
    pad = (-N) % mult
    if pad == 0:
        return elems, N
    ident = _identity_elem(elems[0].shape[-1], (Bsz, pad), elems[0].dtype,
                           elems[0].device)
    return tuple(torch.cat([e, p], 1) for e, p in zip(elems, ident)), N


def tail_transforms(composites):
    """Block composites [B, P, ...] -> tail transforms [B, P, ...]: T_p is
    the composition of the composites of blocks p+1 .. P-1, folded from the
    identity later-first (T_{P-1} is the identity), as each device of the
    JAX package folds the gathered composites."""
    Bsz, P = composites[0].shape[:2]
    T = _identity_elem(composites[0].shape[-1], (Bsz,), composites[0].dtype,
                       composites[0].device)
    Ts = [None] * P
    for p in reversed(range(P)):
        Ts[p] = T
        T = lft_combine(T, tuple(c[:, p] for c in composites))
    return tuple(torch.stack(parts, 1) for parts in zip(*Ts))


def sharded_suffix_GH(elems, devices):
    """(G, H) at every knot from the suffix composition of LFT elements
    [B, NK, ...], the knot axis cut into len(devices) contiguous blocks
    (NK a multiple of it), block p scanned on devices[p].  Returns (G [B,
    NK, xs], H [B, NK, xs, xs]) on the elements' device."""
    devices = [torch.device(d) for d in devices]
    P = len(devices)
    Bsz, NK = elems[0].shape[:2]
    if NK % P:
        raise ValueError(f"sharded_suffix_GH: {NK} knots do not split into "
                         f"{P} blocks; pad them first (pad_elements)")
    blk = NK // P
    blocks = tuple(e.reshape((Bsz, P, blk) + e.shape[2:]) for e in elems)
    groups = {}                    # device -> its blocks, in knot order
    for p, d in enumerate(devices):
        groups.setdefault(d, []).append(p)
    # level 1: each device scans the suffixes within each of its blocks
    suf = {}
    for d, idx in groups.items():
        local = tuple(b[:, idx].to(d) for b in blocks)
        suf[d] = associative_scan(lft_combine, local, dim=2, reverse=True)
    # level 2: the P composites onto every device, the tail transforms
    # applied to the device's own blocks
    G = elems[0].new_empty((Bsz, P, blk) + elems[3].shape[2:])
    H = elems[0].new_empty((Bsz, P, blk) + elems[4].shape[2:])
    for d, idx in groups.items():
        comps = [None] * P
        for d2, idx2 in groups.items():
            for j, p in enumerate(idx2):
                comps[p] = tuple(s[:, j, 0].to(d) for s in suf[d2])
        comps = tuple(torch.stack(parts, 1) for parts in zip(*comps))
        T = tuple(t[:, idx, None].expand_as(s)
                  for t, s in zip(tail_transforms(comps), suf[d]))
        out = lft_combine(T, suf[d])
        sel = torch.tensor(idx, device=G.device)
        G.index_copy_(1, sel, out[3].to(G.device))
        H.index_copy_(1, sel, out[4].to(H.device))
    return G.reshape((Bsz, NK) + G.shape[3:]), \
        H.reshape((Bsz, NK) + H.shape[3:])


def sharded_riccati_GH(A, B, C, D, lx, lu, ly, lxx, luu, lux, lyy, phix,
                       phixx, defect, w, reg, mesh, axis="knot"):
    """The whole knot-sharded value sweep: build the LFT elements (the
    in-solver parallel sweep's own), pad them to the mesh axis, run the
    two-level suffix scan, unpad.  Operands batch-leading as in the
    solver's TrajState, w [N] bool, reg a number or [B].  Returns (G [B,
    N+1, xs], H [B, N+1, xs, xs]), the sequential backward sweep's value
    function, with the defect correction at the initial knot."""
    if not torch.is_tensor(reg):
        reg = torch.full((A.shape[0],), float(reg), dtype=A.dtype,
                         device=A.device)
    elems, _ = riccati_lft_elements(A, B, C, D, lx, lu, ly, lxx, luu, lux,
                                    lyy, phix, phixx, defect, w, reg)
    if tuple(mesh.axis_names) != (axis,):
        raise ValueError(f"expected a one-axis mesh ({axis!r},); got the "
                         f"axes {mesh.axis_names}")
    devices = list(mesh.devices)
    elems_p, N1 = pad_elements(elems, len(devices))
    G, H = sharded_suffix_GH(elems_p, devices)
    G, H = G[:, :N1].clone(), H[:, :N1]
    G[:, 0] = G[:, 0] + (H[:, 0] @ defect[:, 0, :, None])[..., 0]
    return G, H
