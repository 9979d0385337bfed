"""Host-memory parameter tier: budgeted, LRU store for weight trees (the
port of ``tpulab/modelstore/host_store.py``).

The multi-model serving mode (:mod:`tpulab_torch.modelstore`) keeps only
the *hot* models' weights on the card; every other registered model's
parameters live here — host RAM, budgeted, LRU — the tier
:class:`~tpulab_torch.kvcache.host_store.HostKVStore` provides for KV
pages, generalized from one tensor per key to a whole weight tree
(transformer layer dicts, int8 ``{"w_int8", "scale"}`` entries, the
compiled models' placed trees: nested dicts, lists and tuples of
tensors).

Every leaf is a block of a
:class:`~tpulab_torch.cuda.allocators.HostRawAllocator`: page-locked when
the store feeds a CUDA device (so a swap-in copies to the card
asynchronously), plain otherwise (a CPU-only PyTorch refuses
``pin_memory``).  A leaf keeps its strides when its layout is dense (a
channels-last convolution weight comes back channels-last).  ``get``
returns a *copy* (an LRU eviction from another thread frees the blocks,
and a view must not outlive them); ``pop`` hands the blocks themselves
over (the entry is gone, so nothing aliases them); ``put(adopt=True)``
takes over a tree the caller owns exclusively, such as the private
page-locked copy a swap-out fetched, instead of copying it a second time.
All *policy* (which model to demote, when to promote) lives in
:class:`~tpulab_torch.modelstore.multiplexer.WeightMultiplexer`.

Thread safety: one lock — the transfer collector thread lands swap-outs
here while acquire paths read and pop.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, List, Optional, Tuple

import torch

from tpulab_torch.cuda.allocators import HostRawAllocator

#: default host-tier budget for cold weights (bytes; tpulab's value)
DEFAULT_HOST_BUDGET = 1 << 30


def tree_flatten(tree: Any) -> Tuple[List[torch.Tensor], Callable]:
    """A weight tree's tensor leaves and the function that rebuilds the
    tree from a list of new leaves (``jax.tree_util``'s walk for the
    trees the port's models use).  A tree is a tensor or a (nested) dict,
    list or tuple of them; any other leaf (a Python number, None) is
    carried over as it is."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda leaves: leaves[0]
    if isinstance(tree, dict):
        keys, items = list(tree), list(tree.values())
    elif isinstance(tree, (list, tuple)):
        keys, items = None, list(tree)
    else:
        return [], lambda leaves: tree
    cls = type(tree)
    leaves: List[torch.Tensor] = []
    parts = []          # (leaf count, rebuild): never the leaves
    for v in items:
        sub, fn = tree_flatten(v)
        leaves += sub
        parts.append((len(sub), fn))

    def rebuild(new: List[Any]) -> Any:
        out, i = [], 0
        for n, fn in parts:
            out.append(fn(new[i:i + n]))
            i += n
        return dict(zip(keys, out)) if keys is not None else cls(out)

    return leaves, rebuild


def tree_nbytes(tree: Any) -> int:
    """Total leaf bytes of a weight tree (int8 leaves at their stored
    width)."""
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0])


class _Entry:
    __slots__ = ("addrs", "rebuild", "nbytes")

    def __init__(self, addrs: List[int], rebuild: Callable, nbytes: int):
        self.addrs = addrs
        self.rebuild = rebuild
        self.nbytes = nbytes


class HostParamStore:
    """Budgeted LRU store for model weight trees (module docstring).

    ``budget_bytes`` caps resident parameter bytes; inserting past it
    evicts cold models first, and a single model larger than the whole
    budget is refused (``put`` returns False — the caller's lost-weights
    path: the next swap-in does a cold rebuild instead).  Blocks are
    page-locked when CUDA is available; ``allocator`` overrides the block
    source.
    """

    def __init__(self, budget_bytes: int = DEFAULT_HOST_BUDGET,
                 allocator=None):
        if budget_bytes <= 0:
            raise ValueError("budget_bytes must be > 0")
        self.budget_bytes = int(budget_bytes)
        self._alloc = allocator or HostRawAllocator(torch.cuda.is_available())
        self._entries: "OrderedDict[Any, _Entry]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        # -- counters (tpulab's names) ---------------------------------------
        self.puts = 0          # param trees stored
        self.hits = 0          # get/pop found the key
        self.misses = 0        # get/pop did not
        self.evictions = 0     # LRU models pushed out by budget pressure
        self.drops = 0         # param trees refused (larger than budget)

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

    def keys(self) -> List[Any]:
        """Resident keys, coldest first."""
        with self._lock:
            return list(self._entries)

    # -- the tier ------------------------------------------------------------
    def put(self, key, tree: Any, adopt: bool = False) -> bool:
        """Store the weight tree under ``key`` (replacing any incumbent),
        evicting LRU entries until it fits.  False = refused (the tree
        exceeds the whole budget) — the model is simply NOT in the tier and
        its next swap-in cold-rebuilds.  ``adopt=True``: the caller hands
        its host tensors over (they become the store's blocks, uncopied;
        the caller must not use them afterwards)."""
        leaves, rebuild = tree_flatten(tree)
        nbytes = sum(t.numel() * t.element_size() for t in leaves)
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
            addrs = []
            for t in leaves:
                if adopt and t.device.type == "cpu":
                    addrs.append(self._alloc.adopt(t))
                else:
                    addr, block = self._alloc.allocate_like(t)
                    block.copy_(t)
                    addrs.append(addr)
            self._entries[key] = _Entry(addrs, rebuild, nbytes)
            self._bytes += nbytes
            self.puts += 1
            return True

    def _blocks(self, e: _Entry) -> List[torch.Tensor]:
        return [self._alloc.buffer(a) for a in e.addrs]

    def get(self, key) -> Optional[Any]:
        """A COPY of the weight tree (and an LRU touch), or None."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return e.rebuild([b.clone() for b in self._blocks(e)])

    def pop(self, key) -> Optional[Any]:
        """Remove the entry and hand over its blocks as the tree — the
        swap-in read (a model is in exactly one tier at a time: promoting
        it to the card removes the host copy; the eviction path writes it
        back)."""
        with self._lock:
            e = self._entries.pop(key, None)
            if e is None:
                self.misses += 1
                return None
            self.hits += 1
            return e.rebuild(self._free_locked(e))

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

    def _free_locked(self, e: _Entry) -> List[torch.Tensor]:
        """Drop an entry's blocks from the allocator's gauge; returns
        them (their memory goes back once the last reference dies)."""
        self._bytes -= e.nbytes
        return [self._alloc.deallocate_node(a) for a in e.addrs]
