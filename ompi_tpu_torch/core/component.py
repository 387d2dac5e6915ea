"""Framework/component registry with priority-based selection.

TPU-native re-design of Open MPI's Modular Component Architecture (MCA):
  * component identity + open/query/close contract:
      reference opal/mca/mca.h:282-344 (mca_base_component_2_1_0_t)
  * generic framework open/selection:
      reference opal/mca/base/mca_base_framework.c:161 (mca_base_framework_open)
  * include/exclude component lists via the framework-named variable
    (``--mca coll nccl,basic`` or ``--mca coll ^nccl``):
      reference opal/mca/base/mca_base_components_select.c semantics
  * priority-based winner selection with per-function fallback stacking for
    collectives: reference ompi/mca/coll/base/coll_base_comm_select.c:233,385,456

Python components are classes registered with the ``@component`` decorator;
native (C++) components can be registered at import time by their ctypes
binding modules — the registry is language-agnostic: anything exposing
``name``/``priority``/``query()`` participates.

The port's copy of ``ompi_tpu/core/component.py``.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import var as _var
from .output import output


class Component:
    """Base class for components. Subclass and override.

    ``query(scope)`` returns ``(priority, module)`` where ``module`` carries the
    framework-specific function table, or ``(None, None)`` to decline —
    mirroring the reference's query returning priority + module
    (mca.h:282-344; coll query contract coll_base_comm_select.c:385).
    """

    name: str = "base"
    framework: str = ""
    priority: int = 0

    def open(self) -> bool:
        """One-time component init; return False to disqualify."""
        return True

    def close(self) -> None:
        pass

    def query(self, scope: Any) -> Tuple[Optional[int], Optional[Any]]:
        return self.priority, None


class Framework:
    def __init__(self, name: str) -> None:
        self.name = name
        self.components: Dict[str, Component] = {}
        self._open_lock = threading.Lock()
        self._opened: set = set()       # per-component open() tracking
        self._disqualified: set = set()
        self._selection_var = _var.register(
            name, "", "select", default="",
            type=str, level=2,
            help=f"Comma list of {name} components to enable "
                 f"(prefix '^' to exclude instead; empty = all).",
        )

    def register(self, comp: Component) -> None:
        comp.framework = self.name
        self.components[comp.name] = comp

    def _requested(self) -> Tuple[Optional[List[str]], List[str]]:
        """Parse the selection variable → (include_list|None, exclude_list)."""
        spec = (_var.get(f"{self.name}_select", "") or "").strip()
        if not spec:
            return None, []
        if spec.startswith("^"):
            return None, [s.strip() for s in spec[1:].split(",") if s.strip()]
        return [s.strip() for s in spec.split(",") if s.strip()], []

    def available(self) -> List[Component]:
        """Open + filter components per include/exclude lists."""
        include, exclude = self._requested()
        out = []
        for comp in self.components.values():
            if include is not None and comp.name not in include:
                continue
            with self._open_lock:   # open() is one-time even under races
                if comp.name in exclude or comp.name in self._disqualified:
                    continue
                if comp.name not in self._opened:
                    try:
                        ok = comp.open()
                    except Exception as exc:  # self-disqualifies on error
                        output.verbose(1, self.name,
                                       f"component {comp.name} failed "
                                       f"open(): {exc}")
                        ok = False
                    if not ok:
                        output.verbose(
                            1, self.name,
                            f"component {comp.name} declined open(); "
                            f"disqualified")
                        self._disqualified.add(comp.name)
                        continue
                    self._opened.add(comp.name)
            out.append(comp)
        return out

    def select(self, scope: Any = None) -> Tuple[Component, Any]:
        """Single-winner selection: highest query() priority wins
        (mca_base_framework.c:161 + select semantics)."""
        best: Tuple[int, Optional[Component], Any] = (-1, None, None)
        for comp in self.available():
            pri, module = comp.query(scope)
            if pri is None:
                continue
            if pri > best[0]:
                best = (pri, comp, module)
        if best[1] is None:
            raise RuntimeError(f"no usable component in framework '{self.name}'")
        output.verbose(10, self.name, f"selected component '{best[1].name}' pri={best[0]}")
        return best[1], best[2]

    def select_all(self, scope: Any = None) -> List[Tuple[int, Component, Any]]:
        """All willing components, highest priority first — used by coll's
        per-function fallback stacking (coll_base_comm_select.c:456)."""
        rows = []
        for comp in self.available():
            pri, module = comp.query(scope)
            if pri is not None:
                rows.append((pri, comp, module))
        rows.sort(key=lambda r: -r[0])
        return rows


class _FrameworkRegistry:
    def __init__(self) -> None:
        self._frameworks: Dict[str, Framework] = {}
        self._lock = threading.RLock()

    def framework(self, name: str) -> Framework:
        with self._lock:
            fw = self._frameworks.get(name)
            if fw is None:
                fw = Framework(name)
                self._frameworks[name] = fw
            return fw

    def all_frameworks(self) -> List[Framework]:
        return sorted(self._frameworks.values(), key=lambda f: f.name)


frameworks = _FrameworkRegistry()


def component(framework_name: str, name: str, priority: int = 0) -> Callable:
    """Class decorator registering a Component subclass into a framework."""

    def wrap(cls):
        inst = cls()
        inst.name = name
        inst.priority = priority if inst.priority == 0 else inst.priority
        _var.register(framework_name, name, "priority", inst.priority, type=int,
                      level=5, help=f"Selection priority of {framework_name}/{name}.")
        inst.priority = _var.get(f"{framework_name}_{name}_priority", inst.priority)
        frameworks.framework(framework_name).register(inst)
        cls._instance = inst
        return cls

    return wrap
