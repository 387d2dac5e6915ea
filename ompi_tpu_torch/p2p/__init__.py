"""Point-to-point stack: transports (≙ btl), matching + protocol (≙ pml/ob1),
requests (≙ ompi/request).

The port's copy of ``ompi_tpu/p2p/__init__.py``.
"""

from .request import (  # noqa: F401
    ANY_SOURCE,
    ANY_TAG,
    CompletedRequest,
    Request,
    Status,
    wait_all,
    wait_any,
)
from .transport import AM_COLL, AM_FT, AM_OSC, AM_P2P, Transport, TransportLayer  # noqa: F401
from .pml import P2P, TruncateError  # noqa: F401
