"""CLI entry point: ``python -m ompi_tpu_torch.tools.tpurun -np N prog [args...]``
(≙ mpirun, ompi/tools/mpirun/main.c).

The port's copy of ``ompi_tpu/tools/tpurun.py``.
"""

import sys

from ..control.launch import main

if __name__ == "__main__":
    sys.exit(main())
