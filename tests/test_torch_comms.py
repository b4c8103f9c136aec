"""The port's LCM wire types and transports against the JAX package's.

For every one of the eleven message types, on fields made from a numpy
seed: the type hash and the encoded bytes equal the JAX package's, each
package decodes the other's bytes, and the LC02 / LC03 datagrams of the
two `publish`es are byte-equal (captured by patching `socket.sendto`).
Over UDP multicast on loopback (skipped where multicast is unavailable, as
tests/test_comms.py skips): round trips through the port's Python
transport, between it and the JAX package's, and, where g++ exists,
through the port's native transport both ways.  These endpoints use port
17667 of the reference's group, so that tests/test_comms.py, which may run
beside them on 7667, never handles their datagrams; channels carry the
test's pid.
"""
import os
import shutil
import socket
import time

import numpy as np
import pytest

from cafempc_tpu.comms import lcm_wire as jw
from cafempc_tpu.comms import udpm as judpm
from cafempc_tpu_torch.comms import lcm_wire as w
from cafempc_tpu_torch.comms import native
from cafempc_tpu_torch.comms import udpm

ADDR = (udpm.DEFAULT_ADDR[0], 17667)
NAMES = [cls.__name__ for cls in w.ALL_TYPES]
FRAGMENTED = "wbTraj_lcmt_300"     # a wbTraj_lcmt of 139,216 bytes
CASES = NAMES + [FRAGMENTED]


def _pair(name, seed=0):
    """(port message, JAX message) of one type with the same fields from
    the seed; variable dimensions 3 (300 rows for the fragmented case)."""
    cls_name, n = (("wbTraj_lcmt", 300) if name == FRAGMENTED else (name, 3))
    cls, jcls = getattr(w, cls_name), getattr(jw, cls_name)
    rng = np.random.default_rng(seed)
    fields = {}
    for f in cls.FIELDS:
        if not f.dims:
            fields[f.name] = (n if f.typ.startswith("int") else True
                              if f.typ == "boolean" else float(rng.normal()))
    probe = cls(**fields)
    for f in cls.FIELDS:
        if f.dims:
            shape = probe._shape(f)
            fields[f.name] = (rng.integers(-9, 9, shape)
                              if f.typ.startswith("int")
                              or f.typ == "boolean"
                              else rng.normal(size=shape) * 10.0)
    return cls(**fields), jcls(**fields)


def _same_fields(a, b):
    for f in type(a).FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f.name)),
                                      np.asarray(getattr(b, f.name)), f.name)


@pytest.mark.parametrize("name", NAMES)
def test_type_hash_matches_jax(name):
    assert getattr(w, name).type_hash() == getattr(jw, name).type_hash()


@pytest.mark.parametrize("name", CASES)
def test_encoding_matches_jax(name):
    msg, jmsg = _pair(name)
    assert msg.encode() == jmsg.encode()


@pytest.mark.parametrize("name", CASES)
def test_each_package_decodes_the_others_bytes(name):
    msg, jmsg = _pair(name)
    mine, theirs = type(msg).decode(jmsg.encode()), \
        type(jmsg).decode(msg.encode())
    _same_fields(mine, theirs)
    assert mine.encode() == jmsg.encode()
    for f in type(msg).FIELDS:      # the JAX package's python types
        assert type(getattr(mine, f.name)) is type(getattr(theirs, f.name))


def test_decode_refuses_another_type():
    msg, _ = _pair("solver_info_lcmt")
    with pytest.raises(ValueError, match="hash mismatch"):
        w.MHPC_Data_lcmt.decode(msg.encode())


def _multicast(make):
    try:
        return make()
    except OSError:
        pytest.skip("multicast unavailable")


@pytest.mark.parametrize("name", CASES)
def test_datagrams_match_jax(name, monkeypatch):
    """The two publishes send the same datagrams (LC02, or LC03 fragments
    with the channel on the first) to the same address."""
    sent = []
    monkeypatch.setattr(socket.socket, "sendto",
                        lambda self, data, addr: sent.append((data, addr)))
    msg, _ = _pair(name)
    data = msg.encode()
    out = {}
    for key, cls in (("port", udpm.UDPMulticast),
                     ("jax", judpm.UDPMulticast)):
        t = _multicast(lambda: cls(ADDR))
        t.seq = 41
        sent.clear()
        t.publish("chan", data)
        t.close()
        out[key] = list(sent)
    assert out["port"] == out["jax"]
    assert len(out["port"]) == (3 if name == FRAGMENTED else 1)
    magic = udpm.MAGIC_LONG if name == FRAGMENTED else udpm.MAGIC_SHORT
    assert out["port"][0][0][:4] == magic.to_bytes(4, "big")


def _transport(kind):
    if kind == "native":
        if shutil.which("g++") is None:
            pytest.skip("no g++")
        return _multicast(lambda: native.NativeUDPMulticast(ADDR))
    cls = udpm.UDPMulticast if kind == "port" else judpm.UDPMulticast
    return _multicast(lambda: cls(ADDR))


def _roundtrip(tx, rx, channel, data):
    got = []
    rx.subscribe(channel, lambda _c, d: got.append(d))
    tx.publish(channel, data)
    t_end = time.monotonic() + 5.0
    while not got and time.monotonic() < t_end:
        rx.handle(0.05)
    if not got:
        pytest.skip("multicast loopback not received")
    return got[0]


WAYS = [("port", "port"), ("jax", "port"), ("port", "jax"),
        ("native", "port"), ("port", "native"), ("native", "jax"),
        ("jax", "native")]


@pytest.mark.parametrize("tx_kind,rx_kind", WAYS)
def test_loopback_round_trip_of_every_type(tx_kind, rx_kind):
    """Every type, and one message in LC03 fragments, from one transport
    to the other through typed endpoints; decoded fields and bytes equal
    the message sent."""
    tx, rx = _transport(tx_kind), _transport(rx_kind)
    try:
        for name in CASES:
            msg, _ = _pair(name, seed=1)
            channel = f"torch_comms_{os.getpid()}_{tx_kind}_{rx_kind}_{name}"
            got = _roundtrip(tx, rx, channel, msg.encode())
            assert got == msg.encode(), name
            _same_fields(type(msg).decode(got), w.f32_cast(msg))
    finally:
        tx.close()
        rx.close()


def test_typed_endpoint_delivers_decoded_messages():
    ep = udpm.LCMEndpoint(_transport("port"))
    got = []
    channel = f"torch_comms_{os.getpid()}_typed"
    ep.subscribe(channel, w.solver_info_lcmt, lambda _c, m: got.append(m))
    msg, _ = _pair("solver_info_lcmt")
    ep.publish(channel, msg)
    t_end = time.monotonic() + 5.0
    while not got and time.monotonic() < t_end:
        ep.handle(0.05)
    ep.close()
    if not got:
        pytest.skip("multicast loopback not received")
    _same_fields(got[0], w.f32_cast(msg))
