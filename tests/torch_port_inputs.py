"""Seeded numpy operands shared by the port's kernel tests (numpy only,
so the GPU tests can run where jax is not installed), and a fixture that
runs a test module's torch work on one intra-op thread."""
import numpy as np
import pytest
import torch


@pytest.fixture(scope="module")
def one_torch_thread():
    """One torch intra-op thread for the module, restored after it: the
    suite runs several workers on the same cores, and torch's default of a
    thread per core then oversubscribes them (batched 36 x 36 solves ran
    ~100x slower than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


HKD_TRIAL_IN = ("eps", "x0", "X", "dX", "U", "dUK", "reb_delta", "reb_eps",
                "reb_act", "al_lam", "al_sig", "al_act")
HKD_LQ_IN = ("X", "U") + HKD_TRIAL_IN[6:]


def hkd_operands(plan_np, pen_np, Xbar0, Ubar0, n_scen, seed):
    """Seeded per-scenario operands of the fused HKD LQ and trial kernels
    (numpy): states and controls jittered from the plan's, ground forces
    spread across the relaxed barrier's threshold (both branches active),
    penalties perturbed, AL terms on at half the terminal knots' legs, a
    search direction with per-scenario eps in (0, 1], and scenario 1 blown
    up at knot 3 so that its trial is not ok."""
    rng = np.random.default_rng(seed)
    NK = Xbar0.shape[0]
    N = NK - 1

    def rep(a):
        return np.broadcast_to(a, (n_scen,) + a.shape).copy()

    term = plan_np.knot.is_terminal[None, :, None] > 0
    d = dict(
        X=rep(Xbar0) + rng.normal(0, 0.05, (n_scen, NK, 24)),
        U=rep(Ubar0) + rng.normal(0, 0.3, (n_scen, N, 24)),
        reb_delta=rep(pen_np.reb_delta)
        * rng.uniform(1.0, 1.5, (n_scen, N, 20)),
        reb_eps=rep(pen_np.reb_eps) * rng.uniform(1.0, 2.0, (n_scen, N, 20)),
        reb_act=rep(pen_np.reb_active),
        al_lam=rng.normal(0, 1.0, (n_scen, NK, 4)),
        al_sig=rep(pen_np.al_sigma) * rng.uniform(1.0, 2.0, (n_scen, NK, 4)),
        al_act=np.maximum(rep(pen_np.al_active),
                          term & (rng.uniform(size=(n_scen, NK, 4)) < 0.5)
                          ).astype(float),
        eps=rng.uniform(0.05, 1.0, n_scen),
        dX=rng.normal(0, 0.02, (n_scen, NK, 24)),
        dUK=rng.normal(0, 0.1, (n_scen, N, 24)))
    d["x0"] = d["X"][:, 0] + rng.normal(0, 0.01, (n_scen, 24))
    if n_scen > 1:
        d["dX"][1, 3] = 1e7
    return d
