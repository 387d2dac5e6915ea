"""Core substrate: variable/config system, component registry, output,
progress engine — the analog of Open MPI's OPAL layer (reference: opal/).

The port's copy of ``ompi_tpu/core/__init__.py``.
"""

from . import var
from .component import Component, component, frameworks
from .output import output, show_help
from .progress import progress, progress_engine

__all__ = [
    "var",
    "Component",
    "component",
    "frameworks",
    "output",
    "show_help",
    "progress",
    "progress_engine",
]
