"""Port of the fused linear rollout (cafempc_tpu_torch.ops.linroll)
against the JAX package, f64 on CPU, atol 1e-12: the Pallas kernel in
interpret mode at a small width, and the un-batched `linroll_op` scan at
the HKD width (xs=24)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cafempc_tpu.ops.fused_linroll import fused_linear_rollout, linroll_op
from cafempc_tpu_torch.ops import linroll as lr

TOL = 1e-12


def _inputs(rng, Bsz, N, xs):
    return (rng.normal(size=(Bsz, N, xs, xs)) * 0.4,
            rng.normal(size=(Bsz, N, xs)) * 0.1, rng.normal(size=(Bsz, xs)))


def test_small_width_matches_pallas_kernel():
    rng = np.random.default_rng(21)
    Bsz, N, xs, L = 3, 9, 6, 128
    M, c, dx0 = _inputs(rng, Bsz, N, xs)

    def lane(x):
        x = np.moveaxis(x, 0, -1)
        return jnp.asarray(np.concatenate(
            [x, np.repeat(x[..., :1], L - Bsz, axis=-1)], axis=-1))

    want = np.moveaxis(np.asarray(
        fused_linear_rollout(lane(M), lane(c), lane(dx0)))[..., :Bsz], -1, 0)
    got = lr.linroll(*(torch.as_tensor(a) for a in (M, c, dx0)))
    assert np.abs(got.numpy() - want).max() < TOL


@pytest.mark.parametrize("N", [1, 112])
def test_hkd_width_matches_scan(N):
    rng = np.random.default_rng(22 + N)
    M, c, dx0 = _inputs(rng, 2, N, 24)
    M *= 0.4    # keep the 112-step products bounded
    got = lr.linroll(*(torch.as_tensor(a) for a in (M, c, dx0)))
    op = jax.jit(linroll_op)
    for b in range(2):
        want = np.asarray(op(jnp.asarray(M[b]), jnp.asarray(c[b]),
                             jnp.asarray(dx0[b])))
        assert np.abs(got[b].numpy() - want).max() < TOL

