"""Pack/unpack convertor.

Re-design of opal/datatype/opal_convertor.c (pack entry :245): turns
(buffer, datatype, count) into a contiguous packed byte stream and back,
with support for *partial* (positioned) packing — the property segmented /
pipelined collectives and the rendezvous protocol rely on — and external32
(big-endian canonical) representation for heterogeneous peers.

Differences from the reference, by design:
  * the unit of user data is a numpy array (or anything exposing the buffer
    protocol).  Device tensors never reach this layer: the accelerator
    component packs them on the card by an index gather
    (accelerator/torchacc.py) and only the packed stream crosses to the
    host;
  * contiguous fast path is a single memoryview copy (no per-segment loop).

The port's copy of ``ompi_tpu/datatype/convertor.py``, without the C++
segment walker of ``native/convertor.cpp`` (it comes with the rest of
``native/``).
"""

from __future__ import annotations

from typing import List

import numpy as np

from .datatype import Datatype


def _as_bytes_view(buf) -> memoryview:
    """A writable flat uint8 view of the user buffer."""
    if isinstance(buf, np.ndarray):
        if not buf.flags["C_CONTIGUOUS"]:
            raise ValueError("user buffers must be C-contiguous numpy arrays")
        return buf.reshape(-1).view(np.uint8).data
    return memoryview(buf).cast("B")


class Convertor:
    """Positioned pack/unpack over (buf, datatype, count).

    The packed stream layout is: for element e in [0, count), for segment s in
    datatype.segments, the s.nbytes bytes at ``e*extent + s.offset``.
    ``position`` indexes into that stream, enabling arbitrary-boundary
    segmentation (reference: opal_convertor_set_position).
    """

    def __init__(self, buf, datatype: Datatype, count: int,
                 external32: bool = False) -> None:
        self.buf = buf
        self.dt = datatype
        self.count = count
        self.external32 = external32
        self.packed_size = datatype.size * count
        self.position = 0
        # per-element cumulative packed offsets of each segment
        self._cum: List[int] = [0]
        for s in datatype.segments:
            self._cum.append(self._cum[-1] + s.nbytes)

    # -- internals ----------------------------------------------------------

    def _iter_ranges(self, position: int, size: int):
        """Yield (raw_byte_offset, packed_offset, nbytes, dtype) runs covering
        [position, position+size) of the packed stream."""
        dt = self.dt
        esize = dt.size
        end = min(position + size, self.packed_size)
        pos = position
        import bisect
        while pos < end:
            elem, rem = divmod(pos, esize)
            si = bisect.bisect_right(self._cum, rem) - 1
            s = dt.segments[si]
            intra = rem - self._cum[si]
            n = min(s.nbytes - intra, end - pos)
            raw = elem * dt.extent + s.offset + intra
            yield raw, pos, n, s.dtype
            pos += n

    def _swap(self, arr: np.ndarray, dtype: np.dtype) -> np.ndarray:
        """external32 byte order is big-endian (MPI 'external32')."""
        if dtype.itemsize == 1 or not self.external32:
            return arr
        return arr.reshape(-1, dtype.itemsize)[:, ::-1].reshape(-1)

    # -- API ----------------------------------------------------------------

    def pack(self, max_bytes: int | None = None) -> bytes:
        """Pack from the current position, advancing it; returns ≤ max_bytes."""
        if max_bytes is None:
            max_bytes = self.packed_size - self.position
        src = _as_bytes_view(self.buf)
        out = np.empty(min(max_bytes, self.packed_size - self.position), np.uint8)
        if self.dt.is_contiguous and not self.external32:
            n = len(out)
            out[:] = np.frombuffer(src, np.uint8,
                                   count=n, offset=self.position)
            self.position += n
            return out.tobytes()
        written = 0
        for raw, pos, n, sdt in self._iter_ranges(self.position, len(out)):
            chunk = np.frombuffer(src, np.uint8, count=n, offset=raw)
            if self.external32 and n % sdt.itemsize == 0:
                chunk = self._swap(chunk, sdt)
            out[written:written + n] = chunk
            written += n
        self.position += written
        return out[:written].tobytes()

    def unpack(self, data: bytes) -> int:
        """Unpack bytes at the current position, advancing it; returns consumed."""
        dst = _as_bytes_view(self.buf)
        src = np.frombuffer(data, np.uint8)
        if self.dt.is_contiguous and not self.external32:
            n = min(len(src), self.packed_size - self.position)
            dst[self.position:self.position + n] = src[:n]
            self.position += n
            return n
        consumed = 0
        for raw, pos, n, sdt in self._iter_ranges(self.position, len(src)):
            chunk = src[consumed:consumed + n]
            if self.external32 and n % sdt.itemsize == 0:
                chunk = self._swap(chunk, sdt)
            np.frombuffer(dst, np.uint8)[raw:raw + n] = chunk
            consumed += n
        self.position += consumed
        return consumed

    def set_position(self, position: int) -> None:
        if not 0 <= position <= self.packed_size:
            raise ValueError(f"position {position} outside [0, {self.packed_size}]")
        self.position = position


def pack(buf, datatype: Datatype, count: int, external32: bool = False) -> bytes:
    """One-shot full pack."""
    return Convertor(buf, datatype, count, external32).pack()


def unpack(data: bytes, buf, datatype: Datatype, count: int,
           external32: bool = False) -> int:
    """One-shot full unpack."""
    return Convertor(buf, datatype, count, external32).unpack(data)
