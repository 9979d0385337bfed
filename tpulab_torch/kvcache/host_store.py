"""Host-memory KV tier: budgeted, LRU, page-granular store (the port of
``tpulab/kvcache/host_store.py``).

The serving stack's KV pages live on the card
(:class:`~tpulab_torch.engine.paged.PagedKVPool`); this module is the
tier BELOW it — host RAM holding KV snapshots that device pressure pushed
out (preempted lanes, evicted prefix-cache entries).  It is deliberately
dumb: keys map to CPU tensors, an LRU order and a hard byte budget.  All
tiering *policy* lives in
:class:`~tpulab_torch.kvcache.offload.KVOffloadManager`.

Each entry is a block of a
:class:`~tpulab_torch.cuda.allocators.HostRawAllocator` (page-locked
when the tier feeds a CUDA pool, so restores copy to the card
asynchronously).  Entries are torch tensors, so a bf16 payload needs no
numpy dtype.

Thread safety: one lock.  The transfer collector thread writes (swap-out
completions land here), the scheduler thread reads.  ``get`` and
``peek`` return a *copy*, never the stored block: an eviction from
another thread frees the block, and a view must not outlive it.  ``pop``
hands the block itself over (the entry is gone, so nothing aliases it).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Optional

import torch

from tpulab_torch.cuda.allocators import HostRawAllocator


class _Entry:
    __slots__ = ("addr", "tensor", "nbytes")

    def __init__(self, addr: int, tensor: torch.Tensor, nbytes: int):
        self.addr = addr
        self.tensor = tensor
        self.nbytes = nbytes


class HostKVStore:
    """Budgeted LRU store for KV page payloads (module docstring).

    ``budget_bytes`` caps resident payload bytes; inserting past it
    evicts cold entries first, and a single payload larger than the whole
    budget is refused (``put`` returns False — the caller's drop path,
    identical to not having a host tier for that entry).  ``pinned``
    selects page-locked blocks (for a tier in front of a CUDA pool);
    ``allocator`` overrides the block source.
    """

    def __init__(self, budget_bytes: int, allocator=None,
                 pinned: bool = False):
        if budget_bytes <= 0:
            raise ValueError("budget_bytes must be > 0")
        self.budget_bytes = int(budget_bytes)
        self._alloc = allocator or HostRawAllocator(pinned)
        self._entries: "OrderedDict[Any, _Entry]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        # -- counters -----------------------------------------------------
        self.puts = 0          # payloads stored
        self.hits = 0          # get/pop found the key
        self.misses = 0        # get/pop did not
        self.evictions = 0     # LRU entries pushed out by budget pressure
        self.drops = 0         # payloads refused (larger than the budget)
        self.peeks = 0         # non-LRU export reads

    # -- sizing --------------------------------------------------------------
    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes

    @property
    def headroom_bytes(self) -> int:
        """Bytes storable right now WITHOUT evicting."""
        with self._lock:
            return max(0, self.budget_bytes - self._bytes)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._entries

    # -- the tier ------------------------------------------------------------
    def put(self, key, tensor: torch.Tensor) -> bool:
        """Store a copy of ``tensor`` under ``key`` (replacing any
        incumbent), evicting LRU entries until it fits.  False = refused
        (payload exceeds the whole budget): the entry is simply NOT in
        the tier, which callers treat as the drop-and-recompute path."""
        nbytes = tensor.numel() * tensor.element_size()
        with self._lock:
            if nbytes > self.budget_bytes:
                self.drops += 1
                return False
            old = self._entries.pop(key, None)
            if old is not None:
                self._free_locked(old)
            while self._bytes + nbytes > self.budget_bytes and self._entries:
                _, cold = self._entries.popitem(last=False)
                self._free_locked(cold)
                self.evictions += 1
            addr, block = self._alloc.allocate_array(tensor.shape,
                                                     tensor.dtype)
            block.copy_(tensor)
            self._entries[key] = _Entry(addr, block, nbytes)
            self._bytes += nbytes
            self.puts += 1
            return True

    def get(self, key) -> Optional[torch.Tensor]:
        """A COPY of the payload (and an LRU touch), or None."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return e.tensor.clone()

    def peek(self, key) -> Optional[torch.Tensor]:
        """A COPY of the payload WITHOUT the LRU touch and outside the
        hit/miss counts (an export read must not look like local reuse);
        counted in ``peeks``."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return None
            self.peeks += 1
            return e.tensor.clone()

    def pop(self, key) -> Optional[torch.Tensor]:
        """Remove the entry and hand over its block — the one-shot read of
        a preemption snapshot (a restored lane's host copy is dead
        weight)."""
        with self._lock:
            e = self._entries.pop(key, None)
            if e is None:
                self.misses += 1
                return None
            self.hits += 1
            return self._free_locked(e)

    def remove(self, key) -> bool:
        with self._lock:
            e = self._entries.pop(key, None)
            if e is None:
                return False
            self._free_locked(e)
            return True

    def clear(self) -> None:
        with self._lock:
            for e in self._entries.values():
                self._free_locked(e)
            self._entries.clear()

    def _free_locked(self, e: _Entry) -> torch.Tensor:
        self._bytes -= e.nbytes
        return self._alloc.deallocate_node(e.addr)
