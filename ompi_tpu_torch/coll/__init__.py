"""Collectives framework (≙ ompi/mca/coll). Importing the package registers
the in-tree components: basic, self, tuned and nccl.

The port's copy of ``ompi_tpu/coll/__init__.py``.
"""

from .framework import COLL_FUNCTIONS, CollModule, CollTable, attach_coll  # noqa: F401
from . import basic  # noqa: F401  (register coll/basic)
from . import selfcoll  # noqa: F401  (register coll/self)
from . import tuned  # noqa: F401  (register coll/tuned)
from . import nccl  # noqa: F401  (register coll/nccl)
