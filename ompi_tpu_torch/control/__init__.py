"""Control plane: bootstrap (identity / modex KV / fence / events) and the
``tpurun`` launcher — the analog of Open MPI's PMIx + PRRTE boundary.

The port's copy of ``ompi_tpu/control/__init__.py``.
"""

from .bootstrap import Bootstrap, BootstrapError, LocalBootstrap  # noqa: F401
from .tcp import Coordinator, TcpBootstrap  # noqa: F401


def from_environment() -> Bootstrap:
    """Build this process's Bootstrap from the tpurun environment contract,
    or a size-1 LocalBootstrap for singleton init (the reference supports
    running MPI programs without mpirun — SURVEY.md §4)."""
    import os

    coord = os.environ.get("OMPI_TPU_COORD")
    if coord:
        host, _, port = coord.rpartition(":")
        rank = int(os.environ["OMPI_TPU_RANK"])
        return TcpBootstrap((host, int(port)), rank)
    return LocalBootstrap.create_job(1, "singleton")[0]
