"""Host hardware topology (hwloc-lite) + rank CPU binding.

≙ the reference's hwloc glue (opal/mca/hwloc — SURVEY.md §2.2 row 24) and
the binding role PRRTE plays at launch (§3.4): Open MPI discovers the
machine tree (packages → cores → PUs, caches, NUMA nodes) through hwloc and
binds each rank to a computed cpuset. TPU hosts are simple (one or two CPU
packages feeding 4–8 chips), so a /sys parser covers the discovery the
reference needs a vendored library for:

  * ``topology()``     — Machine(packages → cores → pus) + NUMA nodes +
                         shared-cache summary from /sys/devices/system
  * ``bind_plan(n)``   — per-local-rank cpusets: ranks spread across
                         packages first, then cores (the reference's
                         ``--map-by package --bind-to core`` default logic)
  * ``bind_self(cpus)``— sched_setaffinity on the calling process; the
                         runtime applies OMPI_TPU_BIND_CPUS at init, the
                         launcher computes it per rank (--bind-to)

Degrades gracefully: on hosts without the /sys layout (or with one visible
CPU) everything reports a single-PU machine and binding is a no-op.

The port's copy of ``ompi_tpu/core/hwtopo.py``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

_SYS_CPU = "/sys/devices/system/cpu"
_SYS_NODE = "/sys/devices/system/node"


def _read(path: str) -> Optional[str]:
    try:
        with open(path) as fh:
            return fh.read().strip()
    except OSError:
        return None


def _parse_cpulist(text: str) -> List[int]:
    """'0-3,8,10-11' → [0,1,2,3,8,10,11] (the /sys cpulist format)."""
    out: List[int] = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            lo, hi = part.split("-")
            out.extend(range(int(lo), int(hi) + 1))
        else:
            out.append(int(part))
    return out


@dataclass
class Core:
    id: int
    package: int
    pus: List[int] = field(default_factory=list)   # hardware threads


@dataclass
class Package:
    id: int
    cores: List[Core] = field(default_factory=list)


@dataclass
class Machine:
    packages: List[Package]
    numa_nodes: Dict[int, List[int]]               # node id → cpulist
    shared_caches: List[dict]                      # level/size_kb/cpus

    @property
    def n_pus(self) -> int:
        return sum(len(c.pus) for p in self.packages for c in p.cores)

    @property
    def n_cores(self) -> int:
        return sum(len(p.cores) for p in self.packages)

    def summary(self) -> str:
        lines = [f"machine: {len(self.packages)} package(s), "
                 f"{self.n_cores} core(s), {self.n_pus} PU(s), "
                 f"{len(self.numa_nodes)} NUMA node(s)"]
        for p in self.packages:
            cores = ", ".join(
                f"core{c.id}[{','.join(map(str, c.pus))}]" for c in p.cores)
            lines.append(f"  package {p.id}: {cores}")
        for cache in self.shared_caches:
            lines.append(f"  L{cache['level']} {cache['size_kb']}KB shared "
                         f"by cpus {cache['cpus']}")
        return "\n".join(lines)


_topology_cache: Optional[Machine] = None


def topology(refresh: bool = False) -> Machine:
    """Discover (and cache) the host topology from /sys."""
    global _topology_cache
    if _topology_cache is not None and not refresh:
        return _topology_cache
    online = _read(f"{_SYS_CPU}/online")
    cpus = _parse_cpulist(online) if online else \
        sorted(os.sched_getaffinity(0))
    pkgs: Dict[int, Package] = {}
    cores: Dict[tuple, Core] = {}
    for cpu in cpus:
        base = f"{_SYS_CPU}/cpu{cpu}/topology"
        pkg_id = int(_read(f"{base}/physical_package_id") or 0)
        core_id = int(_read(f"{base}/core_id") or cpu)
        pkg = pkgs.setdefault(pkg_id, Package(pkg_id))
        core = cores.get((pkg_id, core_id))
        if core is None:
            core = cores[(pkg_id, core_id)] = Core(core_id, pkg_id)
            pkg.cores.append(core)
        core.pus.append(cpu)
    numa: Dict[int, List[int]] = {}
    try:
        for entry in sorted(os.listdir(_SYS_NODE)):
            if entry.startswith("node") and entry[4:].isdigit():
                lst = _read(f"{_SYS_NODE}/{entry}/cpulist")
                if lst:
                    numa[int(entry[4:])] = _parse_cpulist(lst)
    except OSError:
        pass
    # walk EVERY cpu's cache dirs: a cache shared only within another
    # package never appears under cpu0 (dedup by (level, shared-set))
    caches: List[dict] = []
    seen = set()
    for cpu in cpus:
        idx_dir = f"{_SYS_CPU}/cpu{cpu}/cache"
        try:
            entries = sorted(os.listdir(idx_dir))
        except OSError:
            continue
        for entry in entries:
            if not entry.startswith("index"):
                continue
            level = _read(f"{idx_dir}/{entry}/level")
            size = _read(f"{idx_dir}/{entry}/size") or "0K"
            shared = _read(f"{idx_dir}/{entry}/shared_cpu_list") or ""
            if level is None or len(_parse_cpulist(shared)) <= 1:
                continue                      # only report SHARED caches
            key = (level, shared)
            if key in seen:
                continue
            seen.add(key)
            kb = int(size[:-1]) * (1024 if size.endswith("M") else 1) \
                if size[:-1].isdigit() else 0
            caches.append({"level": int(level), "size_kb": kb,
                           "cpus": shared})
    caches.sort(key=lambda c: (c["level"], c["cpus"]))
    _topology_cache = Machine(sorted(pkgs.values(), key=lambda p: p.id),
                              numa, caches)
    for p in _topology_cache.packages:
        p.cores.sort(key=lambda c: c.id)
    return _topology_cache


def bind_plan(n_ranks: int, policy: str = "core") -> List[List[int]]:
    """Per-local-rank cpusets.

    ``core``: ranks round-robin across packages, then take whole cores in
    order (both hardware threads) — the reference's default ``--map-by
    package --bind-to core`` spread. With more ranks than cores, cores are
    shared in round-robin. ``package``: each rank gets all PUs of one
    package (round-robin). ``none``: empty sets (no binding).
    """
    if policy == "none" or n_ranks <= 0:
        return [[] for _ in range(max(n_ranks, 0))]
    mach = topology()
    if policy == "package":
        return [[pu for c in mach.packages[i % len(mach.packages)].cores
                 for pu in c.pus] for i in range(n_ranks)]
    # interleave cores across packages: p0c0, p1c0, p0c1, p1c1, ...
    per_pkg = [list(p.cores) for p in mach.packages]
    order: List[Core] = []
    i = 0
    while any(per_pkg):
        lane = per_pkg[i % len(per_pkg)]
        if lane:
            order.append(lane.pop(0))
        i += 1
    if not order:
        return [[] for _ in range(n_ranks)]
    return [list(order[r % len(order)].pus) for r in range(n_ranks)]


def bind_self(cpus: List[int]) -> bool:
    """Bind the calling process; False if unsupported/rejected."""
    if not cpus:
        return False
    try:
        os.sched_setaffinity(0, cpus)
        return True
    except (OSError, AttributeError):
        return False


def apply_env_binding(environ=None) -> Optional[List[int]]:
    """Honor OMPI_TPU_BIND_CPUS ('3,7' style, set by the launcher's
    --bind-to); returns the applied cpuset or None."""
    env = environ if environ is not None else os.environ
    spec = env.get("OMPI_TPU_BIND_CPUS", "")
    if not spec:
        return None
    cpus = _parse_cpulist(spec)
    return cpus if bind_self(cpus) else None
