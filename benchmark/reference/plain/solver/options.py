# Frozen copy of cafempc_tpu_torch/solver/options.py, the port's plain path, for the
# benchmark's reference: imports point into benchmark/reference/plain.
"""HS-DDP solver options (counterpart of `cafempc_tpu/solver/options.py`).

Field-for-field mirror of the reference HSDDP_OPTION struct
(HSDDPSolver/common/HSDDP_CompoundTypes.h:13-55) plus a loader for the
boost-property-tree ``.info`` files the reference ships
(HSDDP_CompoundTypes.h:57-82).  Real-time budgeting is done by the
iteration caps (max_*_iter_runtime), as in the JAX package.
"""
import dataclasses
import re


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    alpha: float = 0.1                 # line-search step shrink factor
    gamma: float = 0.01                # expected-cost-reduction scale
    update_penalty: float = 8.0        # AL sigma growth
    update_relax: float = 0.1          # ReB delta shrink
    update_regularization: float = 2.0
    update_ReB: float = 7.0            # ReB weight growth
    max_DDP_iter: int = 3
    max_AL_iter: int = 2
    max_DDP_iter_runtime: int = 1
    max_AL_iter_runtime: int = 2
    cost_thresh: float = 1e-3
    tconstr_thresh: float = 1e-3
    pconstr_thresh: float = 1e-3
    dynamics_feas_thresh: float = 1e-3
    merit_rho: float = 1e4
    merit_scale: float = 0.2
    merit_offset: float = 10.0
    AL_active: bool = True
    ReB_active: bool = True
    smooth_active: bool = False
    MS: bool = True                    # multiple shooting
    nsteps_per_node: int = 1
    # --- framework extensions (not in the reference struct) ---
    ls_eps_min: float = 1e-3           # line-search termination (MultiPhaseDDP.cpp:108)
    reg_max: float = 1e2               # regularization abort (MultiPhaseDDP.cpp:153)
    reg_min_init: float = 1e-3

    def runtime(self):
        """Runtime-capped variant (MHPCLocomotion.cpp:86-87 pattern)."""
        return dataclasses.replace(
            self, max_DDP_iter=self.max_DDP_iter_runtime,
            max_AL_iter=self.max_AL_iter_runtime)


def load_solver_options(fname: str) -> SolverOptions:
    """Parse the reference's ``ddp_setting.info`` format (a boost
    property-tree info file with a single ``ddp { key value ... }`` block);
    keys it does not name keep their defaults."""
    with open(fname) as fh:
        body = re.search(r"ddp\s*\{(.*?)\}", fh.read(), re.S)
    if body is None:
        raise ValueError(f"no ddp block in {fname}")
    kv = {}
    for line in body.group(1).splitlines():
        parts = line.split(";")[0].split()
        if len(parts) == 2:
            kv[parts[0]] = parts[1]
    fields = {}
    for f in dataclasses.fields(SolverOptions):
        if f.name not in kv or f.name in ("ls_eps_min", "reg_max",
                                          "reg_min_init"):
            continue
        v = kv[f.name]
        if f.type in (bool, "bool"):
            fields[f.name] = v.lower() in ("1", "true")
        elif f.type in (int, "int"):
            fields[f.name] = int(v)
        else:
            fields[f.name] = float(v)
    return SolverOptions(**fields)
