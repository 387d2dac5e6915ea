"""NIC enumeration + weighted reachability (≙ opal/mca/if + reachable).

The reference enumerates interfaces (opal/mca/if, SURVEY.md §2.2) and
scores (local interface, remote peer) pairs so every process dials a peer
over the best mutually-routable link (opal/mca/reachable/weighted — kind/
bandwidth-based weights). TPU hosts usually expose one DCN NIC plus
loopback, but multi-NIC hosts (separate storage / control networks) need
the same discipline: advertise the address of the interface most likely to
carry job traffic, not whatever the hostname resolves to.

``interfaces()``    — up IPv4 interfaces from /sys/class/net + SIOCGIFADDR
``weight(i, host)`` — weighted score: link state, address kind (private
                      beats public beats loopback for DCN traffic),
                      same-subnet-as-target bonus, /sys speed bonus
``best_address(host)`` — the address to advertise for traffic toward
                      ``host`` (tcp transport's modex entry)

The port's copy of ``ompi_tpu/p2p/reachable.py``.
"""

from __future__ import annotations

import os
import socket
import struct
from dataclasses import dataclass

from ..core.hwtopo import _read  # shared /sys reader
from typing import List, Optional

SIOCGIFADDR = 0x8915
SIOCGIFNETMASK = 0x891B


def _ioctl_addr(sock: socket.socket, name: str, req: int) -> Optional[str]:
    import fcntl
    try:
        res = fcntl.ioctl(sock.fileno(), req,
                          struct.pack("256s", name[:15].encode()))
        return socket.inet_ntoa(res[20:24])
    except OSError:
        return None


@dataclass
class Iface:
    name: str
    addr: str
    netmask: str
    up: bool
    loopback: bool
    speed_mbps: int       # -1 = unknown


def interfaces() -> List[Iface]:
    """Enumerate IPv4-configured interfaces (up or not)."""
    out: List[Iface] = []
    try:
        names = sorted(os.listdir("/sys/class/net"))
    except OSError:
        names = [n for _i, n in socket.if_nameindex()]
    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        for name in names:
            addr = _ioctl_addr(probe, name, SIOCGIFADDR)
            if addr is None:
                continue
            mask = _ioctl_addr(probe, name, SIOCGIFNETMASK) or "255.255.255.255"
            state = _read(f"/sys/class/net/{name}/operstate") or "unknown"
            # loopback reports state "unknown" but is always usable
            lo = addr.startswith("127.")
            speed = _read(f"/sys/class/net/{name}/speed")
            out.append(Iface(
                name=name, addr=addr, netmask=mask,
                up=lo or state in ("up", "unknown"),
                loopback=lo,
                speed_mbps=int(speed) if speed and speed.lstrip("-").isdigit()
                else -1))
    finally:
        probe.close()
    return out


def _ip_u32(addr: str) -> int:
    return struct.unpack("!I", socket.inet_aton(addr))[0]


def _is_private(addr: str) -> bool:
    u = _ip_u32(addr)
    return ((u >> 24) == 10 or
            (u >> 20) == (172 << 4 | 1) or       # 172.16/12
            (u >> 16) == (192 << 8 | 168))       # 192.168/16


def _resolve(target: Optional[str]) -> Optional[str]:
    if not target:
        return None
    try:
        return socket.gethostbyname(target)
    except OSError:
        return None


def weight(iface: Iface, target: Optional[str] = None) -> int:
    """Score an interface for carrying traffic toward ``target`` (a
    hostname or IP; resolved here — callers scoring many interfaces should
    resolve once and pass the IP, as best_address does). Ladder
    (reachable/weighted's CQ kinds, adapted): down links are unusable;
    same-subnet beats kind; private beats public beats loopback-for-remote;
    link speed breaks ties."""
    if not iface.up:
        return -1
    target_ip = _resolve(target)
    if target_ip is not None and target_ip.startswith("127."):
        # single-host job: loopback is THE right link
        return 1000 if iface.loopback else 10
    score = 0
    if target_ip is not None and not iface.loopback:
        mask = _ip_u32(iface.netmask)
        if (_ip_u32(iface.addr) & mask) == (_ip_u32(target_ip) & mask):
            score += 500                     # same subnet: directly routable
    if iface.loopback:
        score += 1                           # useless for remote targets
    elif _is_private(iface.addr):
        score += 100                         # cluster/DCN fabric address
    else:
        score += 50                          # public/other
    if iface.speed_mbps > 0:
        # log-ish bonus: 1G→+9, 10G→+13, 100G→+16 (breaks kind ties only)
        score += max(0, iface.speed_mbps.bit_length())
    return score


def best_address(target: Optional[str] = None) -> Optional[str]:
    """Address to advertise for traffic toward ``target`` (None = any
    remote peer); None when nothing scores positive. Resolves the target
    once, not per interface."""
    target = _resolve(target)
    cands = [(weight(i, target), i) for i in interfaces()]
    cands = [(w, i) for w, i in cands if w > 0]
    if not cands:
        return None
    cands.sort(key=lambda wi: (-wi[0], wi[1].name))
    return cands[0][1].addr
