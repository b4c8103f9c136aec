"""Port of the fused Riccati backward sweep (cafempc_tpu_torch.ops.sweep)
against the JAX package, f64 on CPU.

* Small width (xs=6, us=3, N=8, two transform steps): `sweep_reference`
  against the Pallas kernel `fused_backward_sweep` in interpret mode, with
  one scenario whose Quu fails the pivot test, so the `ok` flags must
  agree.  Same PSD rule on both sides.
* HKD width (xs=us=24): against the JAX package's un-batched `sweep_op`
  (a lax.scan; the Pallas kernel takes minutes to compile in interpret mode
  at this width).  `sweep_op` factors Quu - 1e-9 I exactly, while the
  Pallas kernel and the port scale the diagonal by rsqrt(d) (a relative
  difference of 1e-9 / d); the inputs keep every pivot d >= 200, so the
  two agree to the stated tolerance.

Tolerance atol 1e-9 on G, H, K, dU, dv; `ok` equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from cafempc_tpu.ops.fused_sweep import fused_backward_sweep
from cafempc_tpu.ops.sweep_bridge import sweep_op
from cafempc_tpu_torch.ops import sweep as sw
from torch_port_inputs import make_inputs

TOL = 1e-9
LANES = 128


def run_port(d):
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    return sw.sweep(t["A"], t["Bm"], t["lx"], t["lu"], t["lxx"], t["luu"],
                    t["lux"], t["phix_T"], t["phixx_T"], t["defect"],
                    t["w"], t["reg"])


def test_small_width_matches_pallas_kernel():
    rng = np.random.default_rng(11)
    Bsz, N, xs, us = 3, 8, 6, 3
    d = make_inputs(rng, Bsz, N, xs, us, w_idx=(2, 5), luu_shift=0.5,
                    fail=(2,))

    def lane(x):
        x = np.moveaxis(x, 0, -1)
        pad = np.repeat(x[..., :1], LANES - Bsz, axis=-1)
        return jnp.asarray(np.concatenate([x, pad], axis=-1))

    reg = np.concatenate([d["reg"], np.repeat(d["reg"][:1], LANES - Bsz)])
    out = fused_backward_sweep(
        *(lane(d[k]) for k in ("A", "Bm", "lx", "lu", "lxx", "luu", "lux",
                               "phix_T", "phixx_T", "defect")),
        jnp.asarray(d["w"]), jnp.asarray(reg))
    want = [np.moveaxis(np.asarray(o)[..., :Bsz], -1, 0) for o in out]
    got = run_port(d)
    ok = want[7][:, 0] > 0.5
    assert list(ok) == [True, True, False]
    assert torch.equal(got[7] > 0.5, torch.as_tensor(ok))
    for i in (0, 1, 2, 3, 4, 5, 6):     # G, H, K, dU, Qu, Quu, Qux
        assert np.abs(got[i].numpy()[ok] - want[i][ok]).max() < TOL
    assert np.abs(got[8].numpy()[ok] - want[8][ok]).max() < TOL


def test_hkd_width_matches_scan_sweep():
    rng = np.random.default_rng(12)
    Bsz, N, xs, us = 3, 20, 24, 24
    d = make_inputs(rng, Bsz, N, xs, us, w_idx=(4, 9, 10, 15),
                    luu_shift=200.0)
    got = run_port(d)
    op = jax.jit(sweep_op)
    for b in range(Bsz):
        want = op(*(jnp.asarray(d[k][b]) for k in (
            "A", "Bm", "lx", "lu", "lxx", "luu", "lux", "phix_T", "phixx_T",
            "defect")), jnp.asarray(d["w"]), jnp.asarray(d["reg"][b]))
        assert float(got[7][b]) == float(want[7]) == 1.0
        for i in (0, 1, 2, 3, 8):       # G, H, K, dU, dv
            assert np.abs(got[i][b].numpy() - np.asarray(want[i])).max() \
                < TOL


def test_cholesky_pivot_rule_flags_nonpositive_pivots():
    """The PSD flag is d_j > 0 with d_j = Quu_jj - 1e-9 - sum L_jk^2."""
    Q = torch.eye(3, dtype=torch.float64).repeat(3, 1, 1)
    Q[1, 2, 2] = 1e-9           # d = 0: not ok
    Q[2, 2, 2] = 2e-9           # d = 1e-9 > 0: ok
    L, ok = sw.cholesky_pivot_rule(Q)
    assert ok.tolist() == [True, False, True]
    assert torch.allclose(L[0], torch.eye(3, dtype=torch.float64),
                          atol=1e-8)

