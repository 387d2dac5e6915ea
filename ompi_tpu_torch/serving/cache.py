"""Paged KV cache — fixed-size pages, block tables, head-sharded over tp.

Counterpart of ``ompi_tpu/serving/cache.py``.  The cache is the serving
tier's only large mutable state: per layer one K and one V page pool.
The reference holds them in the canonical dim-0 layout ``(tp, n_pages,
page_size, heads/tp, head_dim)``; here each process holds its own row of
it, a ``(1, n_pages, page_size, heads/tp, head_dim)`` tensor on the comm's
device, so a sequence's pages live on every rank at once (each rank its
heads' slice) and the paged-attention gather is purely local.

Page bookkeeping (free list, per-slot block tables, sequence lengths) is
host-side integer state: admitting or evicting a sequence moves NO cache
data — the pages stay where they are and only the block-table rows
change.  The pools are written only in place, by the engine's page write
(``index_put_``), so cache data never crosses to the host during serving.

Admission reserves ``ceil((prompt_len + max_new) / page_size)`` pages up
front: decode can then never fault mid-sequence, and the admission check
IS the backpressure signal the continuous-batching scheduler polls.  Page
0 is a reserved scratch page — inactive batch slots write their masked
garbage there so the scatter never lands on a live sequence's pages.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch


class PagedKVCache:
    """Block-table paged KV storage over one DeviceComm (tp axis)."""

    def __init__(self, dc, n_layers: int, n_heads: int, head_dim: int, *,
                 n_pages: int = 64, page_size: int = 16,
                 max_seqs: int = 8, max_pages_per_seq: Optional[int] = None,
                 dtype: torch.dtype = torch.float32) -> None:
        if n_heads % dc.n:
            raise ValueError(
                f"PagedKVCache: n_heads={n_heads} not divisible by the "
                f"{dc.n}-way tp axis")
        if n_pages < 2:
            raise ValueError("PagedKVCache: need >= 2 pages (page 0 is "
                             "the reserved scratch page)")
        self.dc = dc
        self.n_layers = int(n_layers)
        self.heads_local = n_heads // dc.n
        self.head_dim = int(head_dim)
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.max_seqs = int(max_seqs)
        self.max_pages_per_seq = int(
            max_pages_per_seq if max_pages_per_seq is not None
            else n_pages - 1)
        self.dtype = dtype
        shape = (1, self.n_pages, self.page_size, self.heads_local,
                 self.head_dim)
        self.k: List[torch.Tensor] = [
            torch.zeros(shape, dtype=dtype, device=dc.device)
            for _ in range(self.n_layers)]
        self.v: List[torch.Tensor] = [
            torch.zeros(shape, dtype=dtype, device=dc.device)
            for _ in range(self.n_layers)]
        # host-side page bookkeeping (page 0 reserved as scratch)
        self._free: List[int] = list(range(self.n_pages - 1, 0, -1))
        self.block_tables = np.zeros((self.max_seqs,
                                      self.max_pages_per_seq), np.int32)
        self.seq_lens = np.zeros(self.max_seqs, np.int32)
        self.slot_live = np.zeros(self.max_seqs, bool)
        self._slot_pages: List[List[int]] = [[] for _ in
                                             range(self.max_seqs)]

    # -- admission / eviction (host integers only — zero cache traffic) ----

    def pages_needed(self, prompt_len: int, max_new: int) -> int:
        return max(1, math.ceil((prompt_len + max_new) / self.page_size))

    def can_admit(self, prompt_len: int, max_new: int) -> bool:
        need = self.pages_needed(prompt_len, max_new)
        return (need <= len(self._free)
                and need <= self.max_pages_per_seq
                and not self.slot_live.all())

    def admit(self, prompt_len: int, max_new: int) -> int:
        """Reserve a slot + its pages; returns the slot id."""
        need = self.pages_needed(prompt_len, max_new)
        if need > self.max_pages_per_seq:
            raise ValueError(
                f"sequence needs {need} pages > max_pages_per_seq="
                f"{self.max_pages_per_seq}")
        if need > len(self._free):
            raise RuntimeError(f"out of KV pages ({need} needed, "
                               f"{len(self._free)} free)")
        free_slots = np.flatnonzero(~self.slot_live)
        if free_slots.size == 0:
            raise RuntimeError("no free batch slot")
        slot = int(free_slots[0])
        pages = [self._free.pop() for _ in range(need)]
        self._slot_pages[slot] = pages
        self.block_tables[slot, :] = 0
        self.block_tables[slot, :need] = pages
        self.seq_lens[slot] = 0
        self.slot_live[slot] = True
        return slot

    def release(self, slot: int) -> None:
        self._free.extend(reversed(self._slot_pages[slot]))
        self._slot_pages[slot] = []
        self.block_tables[slot, :] = 0
        self.seq_lens[slot] = 0
        self.slot_live[slot] = False

    # -- per-step index helpers --------------------------------------------

    def position_index(self, slot: int, pos: int) -> Tuple[int, int]:
        """(page id, in-page offset) of sequence position ``pos``."""
        return (int(self.block_tables[slot, pos // self.page_size]),
                pos % self.page_size)

    def write_indices(self, slots: np.ndarray,
                      positions: np.ndarray) -> Tuple[np.ndarray,
                                                      np.ndarray]:
        """Vectorized (page_idx, offset) for one position per slot;
        positions < 0 (inactive slots) land on the scratch page 0, and so
        do positions past the slot's block table: a speculative window
        may run k − 1 rows past the pages its request reserved, and the
        reference's clamp into the table's last page would overwrite
        live rows of that page (ROADMAP Queue 3)."""
        slots = np.asarray(slots, np.int64)
        positions = np.asarray(positions, np.int64)
        page_slot = np.where(positions >= 0,
                             positions // self.page_size, -1)
        live = (page_slot >= 0) & (page_slot < self.max_pages_per_seq)
        p = np.where(live, positions, 0)
        page_idx = self.block_tables[slots, np.where(live, page_slot, 0)]
        page_idx = np.where(live, page_idx, 0).astype(np.int32)
        offset = np.where(live, p % self.page_size, 0).astype(np.int32)
        return page_idx, offset

    @property
    def pages_used(self) -> int:
        return (self.n_pages - 1) - len(self._free)

    @property
    def live_slots(self) -> np.ndarray:
        return np.flatnonzero(self.slot_live)
