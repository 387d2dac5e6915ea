"""Typed memory-layout descriptions (datatypes).

TPU-native re-design of the reference's two-level datatype engine
(opal/datatype/ — ~14 kLoC — plus MPI semantics in ompi/datatype/):

  * predefined types map onto numpy dtypes (including bfloat16, the TPU-native
    compute type, via ml_dtypes — something the reference has no equivalent of);
  * derived types (contiguous / vector / indexed / hindexed / struct / subarray /
    resized: reference ompi/datatype/ompi_datatype_create_*.c) are normalized at
    commit() into a flat list of (byte_offset, numpy dtype, count) segments per
    element — the analog of the reference's optimized description
    (opal_datatype_optimize.c);
  * size vs extent vs lb/ub semantics follow MPI: ``size`` is bytes of actual
    data, ``extent`` the span a consecutive element advances by (resized can
    change it).

Device notes: contiguous datatypes are the fast path and map 1:1 onto device
tensors with zero reshaping; non-contiguous layouts on a CUDA tensor are
packed on the card by the accelerator component's index gather, and on the
host by the convertor (reference packs on host too: opal_convertor.c:245).

The port's copy of ``ompi_tpu/datatype/datatype.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

try:  # bfloat16 & friends: TPU-native types
    import ml_dtypes

    _BFLOAT16 = np.dtype(ml_dtypes.bfloat16)
    _FLOAT8_E4M3 = np.dtype(ml_dtypes.float8_e4m3fn)
    _FLOAT8_E5M2 = np.dtype(ml_dtypes.float8_e5m2)
except ImportError:  # pragma: no cover
    _BFLOAT16 = _FLOAT8_E4M3 = _FLOAT8_E5M2 = None


@dataclass(frozen=True)
class Segment:
    """One contiguous typed run within a single datatype element."""

    offset: int          # byte offset from element start
    dtype: np.dtype      # numpy dtype of the run
    count: int           # number of dtype items in the run

    @property
    def nbytes(self) -> int:
        return self.dtype.itemsize * self.count


class Datatype:
    """An MPI-style datatype: committed layout + size/extent bookkeeping."""

    def __init__(
        self,
        segments: Sequence[Segment],
        extent: int,
        name: str = "derived",
        lb: int = 0,
        predefined_np: Optional[np.dtype] = None,
    ) -> None:
        self.segments: List[Segment] = sorted(segments, key=lambda s: s.offset)
        self.extent = extent
        self.lb = lb
        self.name = name
        self.committed = predefined_np is not None
        self.np_dtype = predefined_np  # set for predefined/contiguous-homogeneous
        self.size = sum(s.nbytes for s in self.segments)

    # -- predicates ---------------------------------------------------------

    @property
    def is_contiguous(self) -> bool:
        """True when one packed element is a single run exactly filling extent."""
        if not self.segments or self.lb != 0:
            return False
        off = self.lb
        for s in self.segments:
            if s.offset != off:
                return False
            off += s.nbytes
        return off - self.lb == self.size and self.extent == self.size

    @property
    def is_homogeneous(self) -> bool:
        return len({s.dtype for s in self.segments}) == 1

    def base_np_dtype(self) -> np.dtype:
        """The numpy dtype for homogeneous types (needed by reductions)."""
        if self.np_dtype is not None:
            return self.np_dtype
        if not self.is_homogeneous:
            raise TypeError(f"datatype {self.name} is not homogeneous")
        return self.segments[0].dtype

    def commit(self) -> "Datatype":
        """Coalesce adjacent same-dtype segments (opal_datatype_optimize.c)."""
        if self.committed:
            return self
        merged: List[Segment] = []
        for s in self.segments:
            if (
                merged
                and merged[-1].dtype == s.dtype
                and merged[-1].offset + merged[-1].nbytes == s.offset
            ):
                prev = merged.pop()
                merged.append(Segment(prev.offset, prev.dtype, prev.count + s.count))
            else:
                merged.append(s)
        self.segments = merged
        self.committed = True
        return self

    def __repr__(self) -> str:
        return f"Datatype({self.name}, size={self.size}, extent={self.extent})"

    # -- derived-type constructors (ompi/datatype/ompi_datatype_create_*.c) --

    def dup(self, name: Optional[str] = None) -> "Datatype":
        d = Datatype(list(self.segments), self.extent, name or self.name, self.lb,
                     self.np_dtype)
        d.committed = self.committed
        return d

    @staticmethod
    def contiguous(count: int, base: "Datatype", name: str = "contig") -> "Datatype":
        segs = []
        for i in range(count):
            for s in base.segments:
                segs.append(Segment(i * base.extent + s.offset, s.dtype, s.count))
        np_dt = base.np_dtype if base.is_contiguous else None
        return Datatype(segs, count * base.extent, name, base.lb, None if count != 1 else np_dt).commit()

    @staticmethod
    def vector(count: int, blocklength: int, stride: int, base: "Datatype",
               name: str = "vector", stride_in_bytes: bool = False) -> "Datatype":
        """count blocks of blocklength base-elements, start-to-start stride
        (in base extents, or bytes for hvector)."""
        sb = stride if stride_in_bytes else stride * base.extent
        segs = []
        for i in range(count):
            for j in range(blocklength):
                for s in base.segments:
                    segs.append(Segment(i * sb + j * base.extent + s.offset,
                                        s.dtype, s.count))
        # MPI extent of vector: from lb to ub of the laid-out blocks
        last_block_end = (count - 1) * sb + blocklength * base.extent
        return Datatype(segs, last_block_end, name).commit()

    @staticmethod
    def indexed(blocklengths: Sequence[int], displacements: Sequence[int],
                base: "Datatype", name: str = "indexed",
                disp_in_bytes: bool = False) -> "Datatype":
        segs = []
        ub = 0
        for blen, disp in zip(blocklengths, displacements):
            db = disp if disp_in_bytes else disp * base.extent
            for j in range(blen):
                for s in base.segments:
                    segs.append(Segment(db + j * base.extent + s.offset,
                                        s.dtype, s.count))
            ub = max(ub, db + blen * base.extent)
        return Datatype(segs, ub, name).commit()

    @staticmethod
    def struct(blocklengths: Sequence[int], displacements: Sequence[int],
               types: Sequence["Datatype"], name: str = "struct") -> "Datatype":
        segs = []
        ub = 0
        for blen, disp, t in zip(blocklengths, displacements, types):
            for j in range(blen):
                for s in t.segments:
                    segs.append(Segment(disp + j * t.extent + s.offset,
                                        s.dtype, s.count))
            ub = max(ub, disp + blen * t.extent)
        return Datatype(segs, ub, name).commit()

    @staticmethod
    def subarray(sizes: Sequence[int], subsizes: Sequence[int],
                 starts: Sequence[int], base: "Datatype",
                 order_c: bool = True, name: str = "subarray") -> "Datatype":
        """n-dim subarray of a larger array (ompi_datatype_create_darray/subarray)."""
        if not order_c:
            sizes, subsizes, starts = sizes[::-1], subsizes[::-1], starts[::-1]
        ndim = len(sizes)
        strides = [0] * ndim           # byte stride per dim (C order)
        stride = base.extent
        for d in range(ndim - 1, -1, -1):
            strides[d] = stride
            stride *= sizes[d]
        segs: List[Segment] = []

        def rec(dim: int, off: int) -> None:
            if dim == ndim - 1:
                start = off + starts[dim] * strides[dim]
                for j in range(subsizes[dim]):
                    for s in base.segments:
                        segs.append(Segment(start + j * base.extent + s.offset,
                                            s.dtype, s.count))
                return
            for i in range(subsizes[dim]):
                rec(dim + 1, off + (starts[dim] + i) * strides[dim])

        rec(0, 0)
        full_extent = int(np.prod(sizes)) * base.extent
        return Datatype(segs, full_extent, name).commit()

    @staticmethod
    def resized(base: "Datatype", lb: int, extent: int,
                name: str = "resized") -> "Datatype":
        d = Datatype(list(base.segments), extent, name, lb, base.np_dtype)
        d.committed = base.committed
        return d


def _predef(np_dtype, name: str) -> Datatype:
    dt = np.dtype(np_dtype)
    return Datatype([Segment(0, dt, 1)], dt.itemsize, name, predefined_np=dt)


# Predefined types (reference: ompi/datatype/ompi_datatype_module.c tables).
INT8 = _predef(np.int8, "int8")
UINT8 = _predef(np.uint8, "uint8")
INT16 = _predef(np.int16, "int16")
UINT16 = _predef(np.uint16, "uint16")
INT32 = _predef(np.int32, "int32")
UINT32 = _predef(np.uint32, "uint32")
INT64 = _predef(np.int64, "int64")
UINT64 = _predef(np.uint64, "uint64")
FLOAT16 = _predef(np.float16, "float16")
FLOAT32 = _predef(np.float32, "float32")
FLOAT64 = _predef(np.float64, "float64")
COMPLEX64 = _predef(np.complex64, "complex64")
COMPLEX128 = _predef(np.complex128, "complex128")
BYTE = _predef(np.uint8, "byte")
BOOL = _predef(np.bool_, "bool")
if _BFLOAT16 is not None:
    BFLOAT16 = _predef(_BFLOAT16, "bfloat16")
    FLOAT8_E4M3 = _predef(_FLOAT8_E4M3, "float8_e4m3")
    FLOAT8_E5M2 = _predef(_FLOAT8_E5M2, "float8_e5m2")

# Aliases with MPI spellings
INT = INT32
LONG = INT64
FLOAT = FLOAT32
DOUBLE = FLOAT64

_BY_NP: dict = {}
for _t in (INT8, UINT8, INT16, UINT16, INT32, UINT32, INT64, UINT64, FLOAT16,
           FLOAT32, FLOAT64, COMPLEX64, COMPLEX128, BOOL):
    _BY_NP[_t.np_dtype] = _t
if _BFLOAT16 is not None:
    _BY_NP[_BFLOAT16] = BFLOAT16
    _BY_NP[_FLOAT8_E4M3] = FLOAT8_E4M3
    _BY_NP[_FLOAT8_E5M2] = FLOAT8_E5M2


def from_numpy(dtype) -> Datatype:
    """Map a numpy dtype (incl. bfloat16/fp8) to the predefined Datatype.
    Structured dtypes (e.g. MAXLOC value/index pairs, ≙ MPI_DOUBLE_INT) map
    to an on-the-fly struct datatype."""
    dt = np.dtype(dtype)
    try:
        return _BY_NP[dt]
    except KeyError:
        pass
    if dt.fields:
        segs = []
        for fname, (fdt, off) in dt.fields.items():
            if fdt.subdtype is not None:
                base, shape = fdt.subdtype
                segs.append(Segment(off, base, int(np.prod(shape))))
            else:
                segs.append(Segment(off, fdt, 1))
        d = Datatype(segs, dt.itemsize, f"struct:{dt}")
        d.np_dtype = dt
        return d.commit()
    raise TypeError(f"no predefined datatype for numpy dtype {dt}")
