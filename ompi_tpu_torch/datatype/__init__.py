"""Datatype engine: typed layouts + pack/unpack convertor (≙ opal/datatype +
ompi/datatype in the reference).

The port's copy of ``ompi_tpu/datatype/__init__.py``.
"""

from .datatype import (  # noqa: F401
    BOOL,
    BYTE,
    COMPLEX64,
    COMPLEX128,
    DOUBLE,
    FLOAT,
    FLOAT16,
    FLOAT32,
    FLOAT64,
    INT,
    INT8,
    INT16,
    INT32,
    INT64,
    LONG,
    UINT8,
    UINT16,
    UINT32,
    UINT64,
    Datatype,
    Segment,
    from_numpy,
)

try:
    from .datatype import BFLOAT16, FLOAT8_E4M3, FLOAT8_E5M2  # noqa: F401
except ImportError:  # pragma: no cover
    pass

from .convertor import Convertor, pack, unpack  # noqa: F401
