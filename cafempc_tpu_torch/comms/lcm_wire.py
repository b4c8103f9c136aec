"""LCM message marshalling from the LCM wire specification: big-endian
fields behind a 64-bit type hash (port of `cafempc_tpu/comms/lcm_wire.py`).

The eleven message schemas mirror the reference's `lcmtypes/*.lcm` field
for field; they are the contract with the simulator and the low-level
whole-body controller.  A type's hash is lcmgen's struct hash, and its
encoding is byte for byte the JAX package's: array fields are packed with
numpy (a float64 -> float32 cast rounds as C does, float -> int truncates
as `int()` does), scalars with `struct`.  Decoding returns the JAX
package's Python types: scalars as int / float / bool, arrays as float64
or int64 numpy arrays.
"""
import struct

import numpy as np

_PRIM_FMT = {
    "int8_t": "b", "int16_t": "h", "int32_t": "i", "int64_t": "q",
    "float": "f", "double": "d", "boolean": "b", "byte": "B",
}
# big-endian numpy dtypes of the primitive types
_PRIM_DTYPE = {typ: np.dtype(">" + fmt) for typ, fmt in _PRIM_FMT.items()}


class Field:
    def __init__(self, name, typ, dims=()):
        self.name = name
        self.typ = typ
        self.dims = tuple(dims)   # ints (const) or str (variable field)


def _hash_update(v, c):
    v = ((v << 8) ^ (v >> 55)) + (c & 0xFF)
    return v & 0xFFFFFFFFFFFFFFFF


def _hash_string(v, s):
    v = _hash_update(v, len(s))
    for ch in s.encode():
        v = _hash_update(v, ch)
    return v


def compute_base_hash(fields):
    """lcmgen's struct hash: per member its name, its primitive type name,
    its dimensionality, then per dimension the mode and the size string."""
    v = 0x12345678
    for f in fields:
        v = _hash_string(v, f.name)
        if f.typ in _PRIM_FMT:
            v = _hash_string(v, f.typ)
        v = _hash_update(v, len(f.dims))
        for d in f.dims:
            if isinstance(d, int):
                v = _hash_update(v, 0)            # LCM_CONST
                v = _hash_string(v, str(d))
            else:
                v = _hash_update(v, 1)            # LCM_VAR
                v = _hash_string(v, d)
    return v


def _rotate(h):
    return ((h << 1) + ((h >> 63) & 1)) & 0xFFFFFFFFFFFFFFFF


def _signed64(v):
    return v - (1 << 64) if v >= (1 << 63) else v


def _cast(typ, x):
    if typ in ("float", "double"):
        return float(x)
    return int(x)


class LCMType:
    """Base of the declarative message types; subclasses define FIELDS."""
    FIELDS = ()

    def __init__(self, **kw):
        for f in self.FIELDS:
            setattr(self, f.name, kw.get(f.name, self._zero(f)))

    @staticmethod
    def _zero(f):
        if not f.dims:
            return 0 if f.typ not in ("float", "double") else 0.0
        return None  # set by the caller or by decode

    @classmethod
    def type_hash(cls):
        # every schema here is primitive-only: hash = rotate(base)
        return _rotate(compute_base_hash(cls.FIELDS))

    def _shape(self, f):
        return tuple(d if isinstance(d, int) else int(getattr(self, d))
                     for d in f.dims)

    def encode(self):
        out = [struct.pack(">q", _signed64(self.type_hash()))]
        for f in self.FIELDS:
            val = getattr(self, f.name)
            if not f.dims:
                out.append(struct.pack(">" + _PRIM_FMT[f.typ],
                                       _cast(f.typ, val)))
                continue
            arr = np.broadcast_to(np.asarray(val), self._shape(f))
            out.append(arr.astype(_PRIM_DTYPE[f.typ]).tobytes())
        return b"".join(out)

    @classmethod
    def decode(cls, data):
        (h,) = struct.unpack_from(">q", data, 0)
        if (h & 0xFFFFFFFFFFFFFFFF) != cls.type_hash():
            raise ValueError(
                f"{cls.__name__}: hash mismatch "
                f"{h & 0xFFFFFFFFFFFFFFFF:#x} != {cls.type_hash():#x}")
        off = 8
        msg = cls()
        for f in cls.FIELDS:
            dt = _PRIM_DTYPE[f.typ]
            if not f.dims:
                (v,) = struct.unpack_from(">" + _PRIM_FMT[f.typ], data, off)
                off += dt.itemsize
                setattr(msg, f.name, bool(v) if f.typ == "boolean" else v)
                continue
            shape = msg._shape(f)
            n = int(np.prod(shape))
            a = np.frombuffer(data, dt, n, off).reshape(shape)
            off += n * dt.itemsize
            setattr(msg, f.name, a.astype(
                np.float64 if f.typ in ("float", "double") else np.int64))
        return msg


# ------------------------------------------------------------------
# Message schemas: field-for-field mirrors of lcmtypes/*.lcm
# ------------------------------------------------------------------

class hkd_data_lcmt(LCMType):
    """lcmtypes/hkd_data_lcmt.lcm"""
    FIELDS = (
        Field("reset_mpc", "boolean"), Field("MS", "boolean"),
        Field("mpctime", "double"), Field("contact", "int32_t", (4,)),
        Field("p", "float", (3,)), Field("vWorld", "float", (3,)),
        Field("rpy", "float", (3,)), Field("omegaBody", "float", (3,)),
        Field("qJ", "float", (12,)),
        Field("foot_placements", "float", (12,)),
    )


class hkd_command_lcmt(LCMType):
    """lcmtypes/hkd_command_lcmt.lcm"""
    FIELDS = (
        Field("N_mpcsteps", "int32_t"),
        Field("mpc_times", "double", (10,)),
        Field("hkd_controls", "float", (10, 24)),
        Field("des_body_state", "float", (10, 12)),
        Field("contacts", "int32_t", (10, 4)),
        Field("statusTimes", "double", (10, 4)),
        Field("foot_placement", "float", (12,)),
        Field("feedback", "float", (10, 12, 12)),
        Field("solve_time", "float"),
    )


class MHPC_Data_lcmt(LCMType):
    """lcmtypes/MHPC_Data_lcmt.lcm"""
    FIELDS = (
        Field("reset_mpc", "boolean"), Field("MS", "boolean"),
        Field("mpctime", "double"),
        Field("pos", "float", (3,)), Field("eul", "float", (3,)),
        Field("qJ", "float", (12,)), Field("vWorld", "float", (3,)),
        Field("eulrate", "float", (3,)), Field("qJd", "float", (12,)),
    )


class MHPC_Command_lcmt(LCMType):
    """lcmtypes/MHPC_Command_lcmt.lcm: the command tape with the local
    Q-expansion (Qu/Quu/Qux) and gains for the downstream controller."""
    FIELDS = (
        Field("N_mpcsteps", "int32_t"),
        Field("mpc_times", "float", ("N_mpcsteps",)),
        Field("torque", "float", ("N_mpcsteps", 12)),
        Field("eul", "float", ("N_mpcsteps", 3)),
        Field("pos", "float", ("N_mpcsteps", 3)),
        Field("qJ", "float", ("N_mpcsteps", 12)),
        Field("vWorld", "float", ("N_mpcsteps", 3)),
        Field("eulrate", "float", ("N_mpcsteps", 3)),
        Field("qJd", "float", ("N_mpcsteps", 12)),
        Field("GRF", "float", ("N_mpcsteps", 12)),
        Field("feedback", "float", ("N_mpcsteps", 432)),
        Field("Qu", "float", ("N_mpcsteps", 12)),
        Field("Quu", "float", ("N_mpcsteps", 144)),
        Field("Qux", "float", ("N_mpcsteps", 432)),
        Field("contacts", "int32_t", ("N_mpcsteps", 4)),
        Field("statusTimes", "float", ("N_mpcsteps", 4)),
    )


class solver_info_lcmt(LCMType):
    """lcmtypes/solver_info_lcmt.lcm"""
    FIELDS = (
        Field("n_iter", "int32_t"), Field("n_ls_iter", "int32_t"),
        Field("n_reg_iter", "int32_t"), Field("solve_time", "float"),
        Field("cost", "float"), Field("dyn_feas", "float"),
        Field("ineq_violation", "float"), Field("eq_violation", "float"),
    )


class solver_intermtraj_lcmt(LCMType):
    """lcmtypes/solver_intermtraj_lcmt.lcm"""
    FIELDS = (
        Field("tau_sz", "int32_t"), Field("x_sz", "int32_t"),
        Field("u_sz", "int32_t"),
        Field("x_tau", "float", ("tau_sz", "x_sz")),
        Field("u_tau", "float", ("tau_sz", "u_sz")),
    )


class opt_sol_lcmt(LCMType):
    """lcmtypes/opt_sol_lcmt.lcm"""
    FIELDS = (
        Field("N", "int32_t"),
        Field("contacts", "int32_t", ("N", 4)),
        Field("qdummy", "float", ("N", 12)),
    )


class wbTraj_lcmt(LCMType):
    """lcmtypes/wbTraj_lcmt.lcm (planned-trajectory visualization)."""
    FIELDS = (
        Field("sz", "int32_t"), Field("wb_sz", "int32_t"),
        Field("time", "double", ("sz",)),
        Field("pos", "double", ("sz", 3)),
        Field("eul", "double", ("sz", 3)),
        Field("vWorld", "double", ("sz", 3)),
        Field("eulrate", "double", ("sz", 3)),
        Field("qJ", "double", ("sz", 12)),
        Field("qJd", "double", ("sz", 12)),
        Field("torque", "double", ("sz", 12)),
        Field("defect", "double", ("sz",)),
        Field("hg", "double", ("sz", 3)),
        Field("dhg", "double", ("sz", 3)),
        Field("contact", "int32_t", ("sz", 4)),
    )


class visualize_quadState_lcmt(LCMType):
    """lcmtypes/visualize_quadState_lcmt.lcm"""
    FIELDS = (
        Field("pos", "float", (3,)), Field("eul", "float", (3,)),
        Field("vWorld", "float", (3,)), Field("eulrate", "float", (3,)),
        Field("qJ", "float", (12,)), Field("qJd", "float", (12,)),
        Field("pFoot", "float", (12,)), Field("Jc", "float", (12, 18)),
        Field("qJdd", "float", (12,)), Field("torque", "float", (12,)),
    )


class visualize_quadTraj_lcmt(LCMType):
    """lcmtypes/visualize_quadTraj_lcmt.lcm"""
    FIELDS = (
        Field("len", "int16_t"), Field("WB_plan_dur", "float"),
        Field("SRB_plan_dur", "float"), Field("WB_dt", "float"),
        Field("SRB_dt", "float"),
        Field("pos", "float", ("len", 3)),
        Field("eul", "float", ("len", 3)),
        Field("vWorld", "float", ("len", 3)),
        Field("eulrate", "float", ("len", 3)),
        Field("qJ", "float", ("len", 12)),
        Field("pFoot", "float", ("len", 12)),
        Field("torque", "float", ("len", 12)),
        Field("grf", "float", ("len", 12)),
        Field("feas", "float", ("len",)),
    )


class hkd_problem_data_lcm_t(LCMType):
    """lcmtypes/hkd_problem_data_lcm_t.lcm"""
    FIELDS = (
        Field("n_timesteps", "int32_t"),
        Field("contacts", "float", (4, "n_timesteps")),
        Field("times", "float", ("n_timesteps",)),
        Field("pos_r", "float", (3, "n_timesteps")),
        Field("eul_r", "float", (3, "n_timesteps")),
        Field("vel_r", "float", (3, "n_timesteps")),
        Field("omega_r", "float", (3, "n_timesteps")),
        Field("qdummy_r", "float", (12, "n_timesteps")),
        Field("pos", "float", (3, "n_timesteps")),
        Field("eul", "float", (3, "n_timesteps")),
        Field("vel", "float", (3, "n_timesteps")),
        Field("omega", "float", (3, "n_timesteps")),
        Field("qdummy", "float", (12, "n_timesteps")),
    )


ALL_TYPES = [hkd_data_lcmt, hkd_command_lcmt, MHPC_Data_lcmt,
             MHPC_Command_lcmt, solver_info_lcmt, solver_intermtraj_lcmt,
             opt_sol_lcmt, wbTraj_lcmt, visualize_quadState_lcmt,
             visualize_quadTraj_lcmt, hkd_problem_data_lcm_t]


def f32_cast(msg):
    """The message as a receiver decodes it: `decode(encode())`, so float
    fields carry the schema's float32 rounding."""
    return type(msg).decode(msg.encode())
