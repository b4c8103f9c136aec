"""Build and bind the hand-written CUDA kernels of `csrc/`.

The kernels are compiled at first use by `nvcc` for `sm_90a`, one nvcc
process per source, all started together, and linked into one shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds) bound with `ctypes`.  The library lands in
`ops/_build/`, named by a hash of the sources and flags, so an edited
source is rebuilt and a stale library is never loaded.  Nothing here runs
at import: the CPU-only tests import every module.

A missing `nvcc`, a failed build or a launch that returns a CUDA error
raises; callers never fall back to the plain PyTorch twins.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("sweep.cu", "linroll.cu", "hkd_lq.cu", "hkd_trial.cu")
HEADERS = ("hkd_common.cuh", "tma.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

# per kernel: leading int arguments (batch, N[, xs[, us]]), then double
# arguments (the friction coefficient), then tensor operands
_N_INTS = {"sweep": 4, "linroll": 3, "hkd_lq": 2, "hkd_trial": 2}
_N_DOUBLES = {"sweep": 0, "linroll": 0, "hkd_lq": 1, "hkd_trial": 1}
_N_POINTERS = {"sweep": 21, "linroll": 4, "hkd_lq": 17, "hkd_trial": 25}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_LIB = None


def nvcc_path():
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc,
    or `nvcc` on PATH."""
    homes = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
             "/usr/local/cuda"]
    for home in filter(None, homes):
        cand = os.path.join(home, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels cannot be built")
    return found


def _library_path():
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libcafempc_kernels_{h.hexdigest()[:16]}.so"


def build(force=False):
    """Compile the kernels unless an up-to-date library exists (always,
    with `force`).  Returns (library path, build seconds, compiler log)."""
    so = _library_path()
    if so.exists() and not force:
        return so, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    tmp = so.with_name(f"{tag}.tmp")
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(CSRC / s),
                                   "-o", str(o)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        for s, p, out in zip(SOURCES, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s} ({p.returncode}):\n"
                                   f"{out}")
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    log = "".join(logs)
    os.replace(tmp, so)
    return so, seconds, log + link.stdout + link.stderr


def library():
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        so, _, _ = build()
        lib = ctypes.CDLL(str(so))
        for kernel, n_int in _N_INTS.items():
            for suffix in _SUFFIX.values():
                fn = getattr(lib, f"cafempc_{kernel}_{suffix}")
                fn.argtypes = ([ctypes.c_int] * n_int
                               + [ctypes.c_double] * _N_DOUBLES[kernel]
                               + [ctypes.c_void_p] * (_N_POINTERS[kernel]
                                                      + 1))
                fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def launch(kernel, dtype, batch, n_steps, xs, us, inputs, outputs,
           doubles=()):
    """Launch `kernel` on the current CUDA stream of the operands' device.
    Inputs and outputs must be contiguous CUDA tensors; `doubles` are the
    kernel's scalar arguments.  Raises on a CUDA error reported by the
    launch."""
    if dtype not in _SUFFIX:
        raise ValueError(f"{kernel}: no kernel for dtype {dtype}")
    tensors = list(inputs) + list(outputs)
    if len(tensors) != _N_POINTERS[kernel]:
        raise ValueError(f"{kernel}: expected {_N_POINTERS[kernel]} "
                         f"operands, got {len(tensors)}")
    for t in tensors:
        if not (t.is_cuda and t.is_contiguous()):
            raise ValueError(f"{kernel}: operands must be contiguous CUDA "
                             "tensors")
    if len(doubles) != _N_DOUBLES[kernel]:
        raise ValueError(f"{kernel}: expected {_N_DOUBLES[kernel]} scalar "
                         f"arguments, got {len(doubles)}")
    fn = getattr(library(), f"cafempc_{kernel}_{_SUFFIX[dtype]}")
    ints = [batch, n_steps, xs, us][:_N_INTS[kernel]]
    device = tensors[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*ints, *[float(d) for d in doubles],
                 *[t.data_ptr() for t in tensors], stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                           f"{err}")
