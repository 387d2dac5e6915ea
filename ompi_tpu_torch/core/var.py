"""MCA-style variable (configuration/flag) system.

TPU-native re-design of Open MPI's MCA variable system
(reference: opal/mca/base/mca_base_var.c:1-2292, opal/mca/base/mca_base_var.h:121-135).

Semantics kept from the reference:
  * every tunable is registered with a full name ``<framework>_<component>_<name>``,
    a type, a help string, a *level* (1-9, user → developer), and a *scope*
    (whether it may change after init);
  * value sources have a strict precedence:
        DEFAULT < FILE < ENV < CLI < OVERRIDE
    (reference: mca_base_var.h:121-135 ``mca_base_var_source_t``);
  * params files (``$HOME/.ompi_tpu/params.conf`` plus an optional file named by
    ``OMPI_TPU_PARAMS_FILE``; reference: mca_base_var.c:406-416);
  * environment variables use the prefix ``OMPI_TPU_`` (reference env prefix
    ``OMPI_MCA_``);
  * CLI ``--mca name value`` handled by the launcher (control/launch.py).

Nothing here is TPU-specific; this is the substrate every framework
(coll, transport, accelerator, ...) registers its knobs into, and what the
``tpu_info`` tool dumps (reference: ompi/tools/ompi_info/).

The port's copy of ``ompi_tpu/core/var.py``.
"""

from __future__ import annotations

import enum
import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

ENV_PREFIX = "OMPI_TPU_"
PARAMS_BASENAME = "params.conf"


class VarSource(enum.IntEnum):
    """Value source, ordered by precedence (low wins-over nothing)."""

    DEFAULT = 0
    FILE = 1
    ENV = 2
    CLI = 3
    OVERRIDE = 4


class VarScope(enum.Enum):
    CONSTANT = "constant"      # never changes
    READONLY = "readonly"      # set before init only
    LOCAL = "local"            # may differ across ranks
    ALL = "all"                # freely settable at any time


_CONVERTERS: Dict[type, Callable[[str], Any]] = {
    int: lambda s: int(s, 0),
    float: float,
    str: str,
    bool: lambda s: s.strip().lower() in ("1", "true", "yes", "on", "y", "t"),
}


@dataclass
class Variable:
    name: str                    # full name: framework_component_varname
    default: Any
    type: type
    help: str = ""
    level: int = 9               # 1 = end-user basic ... 9 = developer
    scope: VarScope = VarScope.ALL
    choices: Optional[List[Any]] = None
    _value: Any = None
    _source: VarSource = VarSource.DEFAULT

    @property
    def value(self) -> Any:
        return self._value

    @property
    def source(self) -> VarSource:
        return self._source


class VarRegistry:
    """Process-wide registry; a singleton lives at ``ompi_tpu_torch.core.var.registry``."""

    def __init__(self) -> None:
        self._vars: Dict[str, Variable] = {}
        self._lock = threading.RLock()
        self._file_values: Optional[Dict[str, str]] = None
        self._cli_values: Dict[str, str] = {}
        self._watchers: Dict[str, List[Callable[[Any], None]]] = {}

    # -- change notification ------------------------------------------------

    def watch(self, name: str, fn: Callable[[Any], None]) -> None:
        """Call ``fn(new_value)`` whenever ``name``'s resolved value
        CHANGES (set_override, set_cli/clear_cli, reset_cache).  This is
        how modules that cache a variable into a plain attribute for a
        zero-cost hot path (``trace.enabled``) stay coherent with MPI_T
        cvar writes without putting a registry lookup on that path."""
        with self._lock:
            self._watchers.setdefault(name, []).append(fn)

    def _notify(self, name: str, old: Any, new: Any) -> None:
        if old == new:
            return
        for fn in self._watchers.get(name, []):
            fn(new)

    # -- registration -------------------------------------------------------

    def register(
        self,
        framework: str,
        component: str,
        name: str,
        default: Any,
        type: Optional[type] = None,
        help: str = "",
        level: int = 9,
        scope: VarScope = VarScope.ALL,
        choices: Optional[List[Any]] = None,
    ) -> Variable:
        """Register a variable and resolve its value from all sources.

        Mirrors mca_base_var_register (mca_base_var.c): registration is
        idempotent — re-registering returns the existing variable.
        """
        parts = [p for p in (framework, component, name) if p]
        full = "_".join(parts)
        with self._lock:
            if full in self._vars:
                return self._vars[full]
            vtype = type if type is not None else (default.__class__ if default is not None else str)
            var = Variable(name=full, default=default, type=vtype, help=help,
                           level=level, scope=scope, choices=choices)
            self._resolve(var)
            self._vars[full] = var
            return var

    # -- value resolution ---------------------------------------------------

    def _load_files(self) -> Dict[str, str]:
        if self._file_values is not None:
            return self._file_values
        values: Dict[str, str] = {}
        paths = []
        home = os.path.expanduser("~")
        paths.append(os.path.join(home, ".ompi_tpu", PARAMS_BASENAME))
        extra = os.environ.get(ENV_PREFIX + "PARAMS_FILE")
        if extra:
            paths.append(extra)
        for path in paths:
            try:
                with open(path) as fh:
                    for line in fh:
                        line = line.strip()
                        if not line or line.startswith("#"):
                            continue
                        if "=" in line:
                            k, v = line.split("=", 1)
                            values[k.strip()] = v.strip()
            except OSError:
                continue
        self._file_values = values
        return values

    def _convert(self, var: Variable, raw: str) -> Any:
        conv = _CONVERTERS.get(var.type, var.type)
        try:
            return conv(raw)
        except (ValueError, TypeError) as exc:
            raise ValueError(
                f"variable {var.name} (e.g. env {ENV_PREFIX}{var.name}): "
                f"cannot parse {raw!r} as {var.type.__name__}: {exc}"
            ) from None

    def _resolve(self, var: Variable) -> None:
        old = var._value
        var._value, var._source = var.default, VarSource.DEFAULT
        fv = self._load_files()
        if var.name in fv:
            var._value, var._source = self._convert(var, fv[var.name]), VarSource.FILE
        env = os.environ.get(ENV_PREFIX + var.name)
        if env is not None:
            var._value, var._source = self._convert(var, env), VarSource.ENV
        if var.name in self._cli_values:
            var._value, var._source = (
                self._convert(var, self._cli_values[var.name]),
                VarSource.CLI,
            )
        if var.choices is not None and var._value not in var.choices and var._value is not None:
            raise ValueError(
                f"variable {var.name}: value {var._value!r} not in {var.choices!r}"
            )
        self._notify(var.name, old, var._value)

    # -- mutation -----------------------------------------------------------

    def set_cli(self, name: str, value: str) -> None:
        """Record a ``--mca name value`` CLI assignment (re-resolves if registered)."""
        with self._lock:
            self._cli_values[name] = value
            if name in self._vars:
                self._resolve(self._vars[name])

    def clear_cli(self, name: str) -> None:
        """Drop a CLI assignment, falling back to lower-precedence sources."""
        with self._lock:
            self._cli_values.pop(name, None)
            if name in self._vars:
                self._resolve(self._vars[name])

    def set_override(self, name: str, value: Any) -> None:
        """Programmatic override — the highest-precedence source."""
        with self._lock:
            var = self._vars.get(name)
            if var is None:
                raise KeyError(f"unknown variable: {name}")
            if var.scope is VarScope.CONSTANT:
                raise PermissionError(f"variable {name} is constant")
            old = var._value
            var._value, var._source = value, VarSource.OVERRIDE
            self._notify(name, old, value)

    # -- introspection (MPI_T cvar analog; reference ompi/mpi/tool/) --------

    def get(self, name: str, default: Any = None) -> Any:
        var = self._vars.get(name)
        return default if var is None else var.value

    def lookup(self, name: str) -> Optional[Variable]:
        return self._vars.get(name)

    def all_vars(self, max_level: int = 9) -> List[Variable]:
        return sorted(
            (v for v in self._vars.values() if v.level <= max_level),
            key=lambda v: v.name,
        )

    def reset_cache(self) -> None:
        """Drop cached file values and re-resolve (test helper)."""
        with self._lock:
            self._file_values = None
            for var in self._vars.values():
                self._resolve(var)


registry = VarRegistry()


def register(framework: str, component: str, name: str, default: Any, **kw: Any) -> Variable:
    return registry.register(framework, component, name, default, **kw)


def get(name: str, default: Any = None) -> Any:
    return registry.get(name, default)


def watch(name: str, fn: Callable[[Any], None]) -> None:
    return registry.watch(name, fn)
