"""The port's trajectory logging (`utils/traj_logging.py`) writes the same
four files as the JAX package's, byte for byte, for a solver state with a
value gradient and for a trimmed result without one, on plans with and
without inactive padding; `load_log` reads them back alike."""
from typing import Any, NamedTuple

import numpy as np
import pytest

from cafempc_tpu.utils import traj_logging as jlog
from cafempc_tpu_torch.convert import scenario
from cafempc_tpu_torch.utils import traj_logging

FILES = ("state_log.txt", "control_log.txt", "cost_log.txt",
         "value_grad_log.txt")


class _Info(NamedTuple):
    cost_buf: Any
    n_entries: Any


class _Traj(NamedTuple):
    Xbar: Any
    Ubar: Any
    G: Any


class _State(NamedTuple):
    traj: _Traj
    info: _Info


class _Result(NamedTuple):
    Xbar: Any
    Ubar: Any
    info: _Info


class _Step(NamedTuple):
    active: Any
    is_reset: Any


class _Plan(NamedTuple):
    step: _Step


def _inputs(kind, padded, B=2):
    """A batched state or result of B scenarios over a plan of 3 phases (2
    reset steps), with 4 inactive padding steps if `padded`."""
    rng = np.random.default_rng(5)
    N = 24
    active = np.ones(N)
    if padded:
        active[-4:] = 0.0
    is_reset = np.zeros(N)
    is_reset[[6, 13]] = 1.0
    X = rng.normal(0, 1e3, (B, N + 1, 36)) * rng.random((B, N + 1, 36))
    U = rng.normal(0, 1.0, (B, N, 12))
    info = _Info(rng.normal(0, 1e4, (B, 64)), np.full(B, 9))
    if kind == "state":
        tree = _State(_Traj(X, U, rng.normal(0, 1e-3, (B, N + 1, 36))), info)
    else:
        tree = _Result(X, U, info)
    return tree, _Plan(_Step(active, is_reset))


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("kind", ["state", "result"])
def test_log_files_match_jax_byte_for_byte(tmp_path, kind, padded):
    tree, plan = _inputs(kind, padded)
    s = scenario(tree, 1)
    traj_logging.log_trajectory_sequence(tmp_path / "port", s, plan)
    jlog.log_trajectory_sequence(tmp_path / "jax", s, plan)
    for f in FILES:
        got = (tmp_path / "port" / f).read_bytes()
        assert got == (tmp_path / "jax" / f).read_bytes(), f
        if f == "state_log.txt":
            # knots [0, 6], [7, 13], [14, 24] (padded: [14, 20])
            assert got.count(b"\n") == (21 if padded else 25)
    for f in FILES[:2]:
        np.testing.assert_array_equal(
            traj_logging.load_log(tmp_path / "port", f),
            jlog.load_log(tmp_path / "jax", f))
