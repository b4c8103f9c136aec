"""LCM-UDPM transport: UDP-multicast pub/sub with the LCM datagram framing,
short LC02 and fragmented LC03 messages (port of
`cafempc_tpu/comms/udpm.py`).

The default endpoint is the reference's udpm://239.255.76.67:7667
(common/utilities.h:303-306) with ttl 0, so datagrams never leave the
host, and multicast loopback on.  `LCMEndpoint` takes its transport as an
argument: this one, or the C++ transport of `comms/native.py`, which
frames datagrams the same way.  Nothing swaps one for the other.
"""
import select
import socket
import struct
import threading

MAGIC_SHORT = 0x4C433032   # "LC02"
MAGIC_LONG = 0x4C433033    # "LC03"
FRAGMENT_SIZE = 60000
DEFAULT_ADDR = ("239.255.76.67", 7667)


def frame(seq, channel, data):
    """The datagrams of one message: a single LC02 datagram, or LC03
    fragments with the channel on fragment 0."""
    chan = channel.encode() + b"\x00"
    if len(chan) + len(data) + 8 <= FRAGMENT_SIZE:
        return [struct.pack(">II", MAGIC_SHORT, seq) + chan + data]
    sizes = [min(FRAGMENT_SIZE - 20 - len(chan), len(data))]
    off = sizes[0]
    while off < len(data):
        sizes.append(min(FRAGMENT_SIZE - 20, len(data) - off))
        off += sizes[-1]
    pkts, off = [], 0
    for i, sz in enumerate(sizes):
        hdr = struct.pack(">IIIIHH", MAGIC_LONG, seq, len(data), off, i,
                          len(sizes))
        pkts.append(hdr + (chan if i == 0 else b"") + data[off:off + sz])
        off += sz
    return pkts


class UDPMulticast:
    def __init__(self, addr=DEFAULT_ADDR, ttl=0):
        self.addr = addr
        self.seq = 0
        self.tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.tx.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, ttl)
        self.tx.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_LOOP, 1)
        self.rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.rx.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                           8 * 1024 * 1024)
        self.rx.bind(("", addr[1]))
        mreq = struct.pack("4sl", socket.inet_aton(addr[0]),
                           socket.INADDR_ANY)
        self.rx.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP,
                           mreq)
        self.handlers = {}
        self._frags = {}
        self._lock = threading.Lock()

    def publish(self, channel, payload):
        data = bytes(payload)
        with self._lock:
            seq = self.seq
            self.seq += 1
        for pkt in frame(seq, channel, data):
            self.tx.sendto(pkt, self.addr)

    def subscribe(self, channel, handler):
        self.handlers.setdefault(channel, []).append(handler)

    def handle(self, timeout=0.1):
        """Wait up to `timeout` s for one datagram; True when it completed
        a message (dispatched to the channel's handlers)."""
        r, _, _ = select.select([self.rx], [], [], timeout)
        if not r:
            return False
        pkt, src = self.rx.recvfrom(65535)
        return self._process(pkt, src)

    def _process(self, pkt, src):
        (magic,) = struct.unpack_from(">I", pkt, 0)
        if magic == MAGIC_SHORT:
            end = pkt.index(b"\x00", 8)
            self._dispatch(pkt[8:end].decode(), pkt[end + 1:])
            return True
        if magic != MAGIC_LONG:
            return False
        seq, msg_sz, frag_off, frag_no, n_frag = struct.unpack_from(
            ">IIIHH", pkt, 4)
        key = (src, seq)
        body = pkt[20:]
        st = self._frags.setdefault(key, [None, bytearray(msg_sz), 0])
        if frag_no == 0:
            end = body.index(b"\x00")
            st[0] = body[:end].decode()
            body = body[end + 1:]
        st[1][frag_off:frag_off + len(body)] = body
        st[2] += 1
        if st[2] == n_frag and st[0] is not None:
            del self._frags[key]
            self._dispatch(st[0], bytes(st[1]))
            return True
        return False

    def _dispatch(self, channel, data):
        for h in self.handlers.get(channel, []):
            h(channel, data)

    def close(self):
        self.tx.close()
        self.rx.close()


class LCMEndpoint:
    """Typed pub/sub over a transport (`UDPMulticast`, `native.
    NativeUDPMulticast`, or any object with publish(channel, bytes),
    subscribe(channel, handler), handle(timeout) and close()): the
    counterpart of the reference's lcm::LCM usage."""

    def __init__(self, transport):
        self.t = transport

    def publish(self, channel, msg):
        self.t.publish(channel, msg.encode())

    def subscribe(self, channel, msg_type, callback):
        def h(chan, data):
            callback(chan, msg_type.decode(data))
        self.t.subscribe(channel, h)

    def handle(self, timeout=0.1):
        return self.t.handle(timeout)

    def close(self):
        self.t.close()
