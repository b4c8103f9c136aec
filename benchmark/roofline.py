"""Byte, operation and peak arithmetic of the kernels' roofline shares.

Copied from `chip_smoke.py` (`PEAK_BYTES`, `PEAK_F32`, `PEAK_F64`,
`nbytes`, `bound`, `sweep_flops`), so that later changes to that script
or to the port do not move the yardstick.  The peaks are NVIDIA's
published H100 SXM figures at its 700 W limit: HBM bytes/s, and float32
and float64 FLOP/s outside the tensor cores (an FMA counts 2).
"""
import torch

PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_F64 = 34e12
PEAKS = {torch.float32: PEAK_F32, torch.float64: PEAK_F64}
PEAK_NOTE = ("published H100 SXM peaks: 3.35 TB/s HBM, 67 TFLOP/s f32 and "
             "34 TFLOP/s f64 outside the tensor cores, at 700 W")


def nbytes(inputs, outputs):
    """Bytes a kernel must move: each tensor input read once, each output
    written once."""
    return sum(t.numel() * t.element_size() for t in (*inputs, *outputs)
               if torch.is_tensor(t))


def bound(n_bytes, flops, peak=PEAK_F32):
    """(least ms on the card, which bound) from bytes over the HBM rate
    and operations over the CUDA cores' peak for their type (`peak`)."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sweep_flops_counts(Bsz, N, xs, us, n_tr):
    """Operations of one Riccati sweep over Bsz scenarios of N steps, n_tr
    of them transform steps (an FMA is 2)."""
    # H'^T [A B], Gn, [Qx Qu], Qxx, Qux, Quu, Cholesky, 1 + xs solves,
    # G and H updates
    dyn = (xs * xs * (xs + us) + xs * xs + (xs + us) * xs + xs ** 3
           + 2 * us * xs * xs + us * us * xs + us ** 3 / 6
           + (1 + xs) * us * us + xs * us)
    tr = 2 * xs ** 3 + 2 * xs * xs    # H'^T A, Gn, Qx, Qxx
    return 2.0 * Bsz * ((N - n_tr) * dyn + n_tr * tr)


def sweep_flops(ins):
    """Operations of one sweep on these operands (an FMA is 2), counting
    dynamics and transform steps from this run's w (ins[10])."""
    A, lu, w = ins[0], ins[3], ins[10]
    Bsz, N, xs = A.shape[:3]
    return sweep_flops_counts(Bsz, N, xs, lu.shape[-1], int((w > 0).sum()))
