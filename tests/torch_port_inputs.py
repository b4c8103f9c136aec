"""Seeded numpy operands shared by the port's kernel tests (numpy only,
so the GPU tests can run where jax is not installed)."""
import numpy as np


def make_inputs(rng, Bsz, N, xs, us, w_idx, luu_shift, fail=()):
    """Seeded sweep operands [Bsz, ...] (numpy), cost streams already
    merged (transform steps carry phix/phixx rows)."""
    def mk(shape, s):
        return rng.normal(size=(Bsz,) + shape) * s

    def spd(n, shift):
        M = rng.normal(size=(Bsz, N, n, n))
        return 0.2 * np.einsum("bkij,bkmj->bkim", M, M) + shift * np.eye(n)

    w = np.zeros(N, np.int32)
    w[list(w_idx)] = 1
    luu = spd(us, luu_shift)
    k_fail = max(k for k in range(N) if not w[k])
    for b in fail:                     # a dynamics step with Quu < 0
        luu[b, k_fail] = -10.0 * np.eye(us)
    M = rng.normal(size=(Bsz, xs, xs))
    return dict(
        A=np.eye(xs) + mk((N, xs, xs), 0.1), Bm=mk((N, xs, us), 0.3),
        lx=mk((N, xs), 0.4), lu=mk((N, us), 0.4), lxx=spd(xs, 0.5),
        luu=luu, lux=mk((N, us, xs), 0.05), phix_T=mk((xs,), 0.4),
        phixx_T=0.2 * np.einsum("bij,bmj->bim", M, M) + 0.5 * np.eye(xs),
        defect=mk((N + 1, xs), 0.01), w=w,
        reg=rng.uniform(0.01, 0.05, Bsz))
