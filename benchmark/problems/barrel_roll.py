"""The `barrel_roll` problem: the 6-phase barrel-roll trajectory
optimization (BASELINE config 4) on the synthetic quadruped and the
synthetic barrel-roll settings.

Inputs the benchmark makes itself and hands to both sides: the settings
directory (written by the plain copy of
`reference/synthetic.write_synthetic_br_settings`, read by both sides'
plan builders), the URDF (`problems/mhpc.py`'s `Models`) and the nominal
start state (`initial_state()`, BarrelRollTO.cpp:100-112).  The "gait"
of the traffic drivers is the settings directory: the plan is the same
fixed 1.25 s roll whatever the duration asked for.

The configuration's `settings` state the plan as it is run (switching
times, dt, steps, constraint counts); both sides' plans are checked
against them when they are built.
"""
import tempfile

from benchmark.problems.mhpc import Models
from benchmark.reference.plain.reference import synthetic as ref_syn


def ref_br():
    from benchmark.reference.plain.problems import barrel_roll
    return barrel_roll


class Settings:
    """The synthetic barrel-roll settings, written once into a temporary
    directory that lives as long as this object."""

    def __init__(self):
        self._tmp = tempfile.TemporaryDirectory()
        self.dir = ref_syn.write_synthetic_br_settings(self._tmp.name)


# ---------------- inputs the benchmark makes ------------------------------
def make_gait(cfg, duration=None):
    return Settings()


def nominal_x0(cfg, gait):
    return ref_br().initial_state()


def make_models():
    return Models()


def _plan(mod, cfg, gait):
    """Numpy (plan, pen, Xbar0, Ubar0) of one side's builder `mod` on the
    settings, checked against the configuration."""
    plan_np, pen_np, Xbar0, Ubar0, meta = mod.build_barrel_roll_plan(
        gait.dir)
    s = cfg["settings"]
    got = dict(switching_times=list(meta["switching_times"]), dt=mod.DT,
               n_steps=len(plan_np.step.active), n_path_con=mod.N_PCON,
               n_td_con=mod.N_TCON)
    if got != {k: s[k] for k in got}:
        raise ValueError(f"the barrel-roll plan {got} is not the "
                         f"configuration's {s}")
    return plan_np, pen_np, Xbar0, Ubar0


# ---------------- the program (the port) ----------------------------------
def program_batched(cfg, gait, device, dtype, batch, models):
    from cafempc_tpu_torch import convert
    from cafempc_tpu_torch.parallel.mesh import broadcast_batch
    from cafempc_tpu_torch.problems import barrel_roll as br
    from cafempc_tpu_torch.solver.options import SolverOptions
    b = cfg["batched"]
    plan, pen, Xbar0, Ubar0 = convert.from_numpy(
        _plan(br, cfg, gait), device, dtype)
    fns = br.make_barrel_roll_fns(models.port(device, dtype),
                                  cfg["settings"]["bg_alpha"])
    return dict(plan=plan, pen=broadcast_batch(pen, batch),
                Xbar0=broadcast_batch(Xbar0, batch),
                Ubar0=broadcast_batch(Ubar0, batch), fns=fns, hooks={},
                opts=SolverOptions(**b["opts"]), solver_kw=dict(b["solver"]))


# ---------------- the plain reference -------------------------------------
def reference_batched(cfg, gait, device, dtype, x0, models):
    from benchmark.reference.plain import convert
    from benchmark.reference.plain.solver.hsddp import make_solver
    from benchmark.reference.plain.solver.options import SolverOptions
    mod = ref_br()
    b = cfg["batched"]
    plan, pen, Xbar0, Ubar0 = convert.from_numpy(
        _plan(mod, cfg, gait), device, dtype)
    S = x0.shape[0]

    def rep(t):
        return t.unsqueeze(0).expand((S,) + tuple(t.shape)).contiguous()
    fns = mod.make_barrel_roll_fns(models.reference(device, dtype),
                                   cfg["settings"]["bg_alpha"])
    solve = make_solver(fns, SolverOptions(**b["opts"]), **b["solver"])
    res = solve(plan, type(pen)(*[rep(t) for t in pen]),
                x0.to(device, dtype), rep(Xbar0), rep(Ubar0))
    return (res.cost.double().cpu().numpy(), res.success.cpu().numpy(),
            res.Xbar.double().cpu().numpy(), res.K.double().cpu().numpy())
