"""ctypes binding of the C++ LCM-UDPM transport `native/lcm_transport.cpp`
(port of `cafempc_tpu/comms/native.py`), and the build of the C++ command
consumer `native/hkd_command_listener.cpp`.

Both are compiled with `g++` at first use into `comms/_build/`, named by a
hash of their sources and flags, so an edited source is rebuilt and a
stale binary is never loaded.  A missing `g++` or a failed build raises
with the compiler's output: the caller chose this transport, and nothing
hands it `udpm.UDPMulticast` instead.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from cafempc_tpu_torch.comms.udpm import DEFAULT_ADDR

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17")
_LIB = None


def _gxx():
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH: the native LCM transport "
                           "cannot be built")
    return found


def _build(name, sources, extra=()):
    """Compile `sources` (files of native/) into BUILD_DIR/<name>-<hash>
    unless it exists; returns its path."""
    h = hashlib.sha256(" ".join((*CXX_FLAGS, *extra)).encode())
    for s in sources:
        h.update((NATIVE_DIR / s).read_bytes())
    stem, suffix = os.path.splitext(name)
    out = BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}{suffix}"
    if out.exists():
        return out
    gxx = _gxx()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *CXX_FLAGS, *extra, "-o", str(tmp),
                           *(str(NATIVE_DIR / s) for s in sources)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}) building {name}:"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def build_transport():
    """The shared library of the C++ transport (built on first use)."""
    return _build("liblcm_transport.so", ["lcm_transport.cpp"],
                  ("-shared",))


def build_listener():
    """The C++ consumer `hkd_command_listener [n_msgs]`: subscribes to
    "mpc_command", decodes hkd_command_lcmt with its own schema hash and
    prints `ok: N commands decoded` after n_msgs (built on first use)."""
    return _build("hkd_command_listener",
                  ["hkd_command_listener.cpp", "lcm_transport.cpp"])


def _load():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_transport()))
        lib.lcmt_create.restype = ctypes.c_void_p
        lib.lcmt_create.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                    ctypes.c_int]
        lib.lcmt_publish.restype = ctypes.c_int
        lib.lcmt_publish.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_char_p, ctypes.c_int]
        lib.lcmt_poll.restype = ctypes.c_int
        lib.lcmt_poll.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_int, ctypes.c_char_p,
                                  ctypes.c_int, ctypes.c_double]
        lib.lcmt_destroy.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


class NativeUDPMulticast:
    """The interface of `udpm.UDPMulticast`, backed by the C++ transport.
    `handle` returns True for each complete message it received."""

    def __init__(self, addr=DEFAULT_ADDR, ttl=0):
        self.lib = _load()
        self.h = self.lib.lcmt_create(addr[0].encode(), addr[1], ttl)
        if not self.h:
            raise OSError("native LCM transport: socket setup failed")
        self.handlers = {}
        self._chan_buf = ctypes.create_string_buffer(256)
        self._buf = ctypes.create_string_buffer(4 * 1024 * 1024)

    def publish(self, channel, payload):
        data = bytes(payload)
        if self.lib.lcmt_publish(self.h, channel.encode(), data,
                                 len(data)) != 0:
            raise OSError(f"native LCM transport: publish on {channel} "
                          "failed")

    def subscribe(self, channel, handler):
        self.handlers.setdefault(channel, []).append(handler)

    def handle(self, timeout=0.1):
        n = self.lib.lcmt_poll(self.h, self._chan_buf, 256, self._buf,
                               len(self._buf), timeout)
        if n < 0:
            return False
        channel = self._chan_buf.value.decode()
        data = self._buf.raw[:n]
        for h in self.handlers.get(channel, []):
            h(channel, data)
        return True

    def close(self):
        if self.h:
            self.lib.lcmt_destroy(self.h)
            self.h = None
