"""accelerator/torch — the CUDA-tensor accelerator component.

Plays the role of accelerator/cuda (opal/mca/accelerator/cuda/
accelerator_cuda.c:26,74): buffer interrogation, device↔host staging
(``tensor.cpu()`` out, ``torch.from_numpy(...).to(device)`` in), and
device-side pack/unpack of non-contiguous datatypes.  Chunked asynchronous
staging with completion events comes when something can overlap with it
(ROADMAP P7, with shm).

Which tensors are "device": a tensor on ``cuda``; and a tensor on ``cpu``
only while this process has joined the gloo device plane
(``init_device_plane(device="cpu")``), the CPU tests' stand-in for the
card.  Any other CPU tensor is a host buffer.

Device pack (vs the reference's host-only convertor,
opal/datatype/opal_convertor.c:245): for a homogeneous derived datatype whose
segment offsets and extent are item-aligned, the element-index map is built
once (cached on the datatype and, per device, as a device tensor); one index
gather packs the element stream on the card and only the packed (smaller)
result crosses to the host.  Unpack is the mirrored index scatter after one
H2D of the packed stream.  Datatypes that don't satisfy the alignment
constraints fall back to full staging + the host convertor.

The port of ``ompi_tpu/accelerator/jaxacc.py``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .base import AcceleratorModule, AddrInfo

try:  # numpy has no bfloat16 of its own
    import ml_dtypes

    _NP_BF16: Optional[np.dtype] = np.dtype(ml_dtypes.bfloat16)
except ImportError:  # pragma: no cover
    _NP_BF16 = None


def np_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype (bfloat16 through ml_dtypes)."""
    if dtype == torch.bfloat16:
        if _NP_BF16 is None:
            raise TypeError("staging bfloat16 to numpy needs ml_dtypes")
        return _NP_BF16
    return torch.empty(0, dtype=dtype).numpy().dtype


def _bits(t: torch.Tensor) -> torch.Tensor:
    """bfloat16 as its int16 bits (same bytes; torch's numpy bridge has no
    bfloat16)."""
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _is_device(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    return (t.device.type == "cpu" and dist.is_available()
            and dist.is_initialized() and dist.get_backend() == "gloo")


def _index_map(dt, count: int) -> Optional[np.ndarray]:
    """Item-index gather map for (datatype, count), or None when the type
    isn't expressible as an item-aligned gather. Cached on the datatype the
    same way the convertor caches its segment table."""
    cache = getattr(dt, "_dev_idx", None)
    if cache is None:
        cache = dt._dev_idx = {}
    if count in cache:
        return cache[count]
    if not dt.is_homogeneous:
        cache[count] = None
        return None
    item = dt.segments[0].dtype.itemsize
    if dt.extent % item:
        cache[count] = None
        return None
    one: List[int] = []
    for s in dt.segments:
        if s.offset % item:
            cache[count] = None
            return None
        start = s.offset // item
        one.extend(range(start, start + s.count))
    stride = dt.extent // item
    idx = (np.asarray(one, np.int64)[None, :]
           + (np.arange(count, dtype=np.int64) * stride)[:, None]).ravel()
    cache[count] = idx
    return idx


def _device_index_map(dt, count: int,
                      device: torch.device) -> Optional[torch.Tensor]:
    """The gather map as a device tensor, cached per (count, device):
    without this every pack/unpack re-uploads the host index array — a
    hidden H2D on the supposedly device-only path."""
    idx = _index_map(dt, count)
    if idx is None:
        return None
    cache = getattr(dt, "_dev_idx_on", None)
    if cache is None:
        cache = dt._dev_idx_on = {}
    key = (count, str(device))
    hit = cache.get(key)
    if hit is None:
        hit = cache[key] = torch.as_tensor(idx, device=device)
    return hit


class TorchAccelerator(AcceleratorModule):
    name = "torch"

    # -- interrogation (accelerator.h:171 check_addr) -----------------------
    def check_addr(self, buf) -> Optional[AddrInfo]:
        if not isinstance(buf, torch.Tensor) or not _is_device(buf):
            return None
        index = buf.device.index if buf.device.index is not None else 0
        return AddrInfo(platform=buf.device.type, device_ids=[index],
                        nbytes=buf.numel() * buf.element_size(),
                        dtype=np_dtype(buf.dtype), shape=tuple(buf.shape))

    # -- transfers (accelerator.h:265 memcpy) -------------------------------
    def memcpy_d2h(self, arr: torch.Tensor) -> np.ndarray:
        """The whole tensor as a host array of its own (blocking)."""
        host = _bits(arr.detach()).to("cpu", copy=True).numpy()
        return host.view(np_dtype(arr.dtype))

    def memcpy_h2d(self, host: np.ndarray, like=None):
        """A host array onto ``like``'s device (the card when None)."""
        device = like.device if like is not None else torch.device("cuda")
        h = np.ascontiguousarray(host)
        if _NP_BF16 is not None and h.dtype == _NP_BF16:
            return torch.from_numpy(h.view(np.int16)).to(
                device).view(torch.bfloat16)
        return torch.from_numpy(h).to(device)

    # -- device pack/unpack + pml staging -----------------------------------
    def pack_device(self, arr: torch.Tensor, datatype, count):
        """Gather the packed element stream on the device; None if the
        datatype can't be expressed as an item-aligned gather."""
        idx = _index_map(datatype, count)
        if idx is None:
            return None
        flat = arr.reshape(-1)
        if idx.size and idx[-1] >= flat.numel():
            return None   # datatype describes more extent than the tensor has
        return flat[_device_index_map(datatype, count, flat.device)]

    def stage_out(self, buf, datatype, count) -> bytes:
        from ..datatype import Convertor

        if datatype is None or datatype.is_contiguous:
            flat = buf.reshape(-1)
            if count is not None:
                item = buf.element_size()
                esize = datatype.size if datatype is not None else item
                flat = flat[:(esize * count) // item]
            return self.memcpy_d2h(flat).tobytes()
        packed = self.pack_device(buf, datatype, count)
        if packed is not None:
            return self.memcpy_d2h(packed).tobytes()
        host = self.memcpy_d2h(buf)          # full staging fallback
        return Convertor(np.ascontiguousarray(host), datatype, count).pack()

    def stage_in(self, data: bytes, template: torch.Tensor, datatype, count):
        from ..datatype import Convertor

        if not template.is_contiguous():
            raise ValueError("a receive into a device tensor needs a "
                             "contiguous tensor")
        flat = template.view(-1)
        if datatype is None or datatype.is_contiguous:
            host = np.frombuffer(data, np_dtype(template.dtype))
            # a short message fills the front and keeps the tail
            flat[:host.size].copy_(self.memcpy_h2d(host, like=template))
            return template
        idx = _index_map(datatype, count)
        if idx is not None and (not idx.size or idx[-1] < flat.numel()):
            vals = np.frombuffer(data, datatype.base_np_dtype())
            if vals.size == idx.size:
                idx_dev = _device_index_map(datatype, count, flat.device)
            else:                      # short message: front of the stream
                idx_dev = torch.as_tensor(idx[:vals.size],
                                          device=flat.device)
            flat[idx_dev] = self.memcpy_h2d(vals, like=template).to(
                template.dtype)
            return template
        host = np.ascontiguousarray(self.memcpy_d2h(template))  # full staging
        Convertor(host, datatype, count).unpack(data)
        template.copy_(self.memcpy_h2d(host, like=template))
        return template
