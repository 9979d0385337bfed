"""Paged KV cache + continuous batching — the port of
``tpulab/engine/paged.py`` (the ragged and the split dispatch plans).

K/V live in a global pool of fixed-size pages (fused ``(L, P, 2, S, Hkv,
D)`` layout, page 0 reserved as scratch); sessions own block tables of
page ids; a scheduler thread advances every active session through one
of two plans:

- the ragged plan (``ragged=True``, the default): fused mixed rounds
  (:func:`paged_mixed_step` over :func:`paged_ragged_forward`) carry
  prompt chunks and decode tokens of all lanes in one forward;
- the split plan (``ragged=False``): each new prompt runs one full-prompt
  causal forward (:func:`paged_prefill`, flash attention when
  ``prefill_flash``), and prefix-cache tails and chunks of long prompts
  run :func:`paged_extend` against the resident context.

Decode runs K-token blocks (:func:`paged_decode_block`, K chained
:func:`paged_decode_step` calls with on-device sampling and stop masks:
one host sync per K tokens) under both plans, or, with a draft model
(``draft_params``), speculative blocks (:func:`paged_speculative_block`:
K draft steps through a second page table on the same pool, one target
verify forward, acceptance on the device: up to K+1 tokens a sync).

Every paged attention call goes through
:func:`tpulab_torch.ops.ragged_attention.ragged_paged_attention`, and the
split plan's full-prompt attention through
:func:`tpulab_torch.ops.flash_attention.flash_attention` — hand-written
Hopper kernels for CUDA tensors, their plain versions for CPU tensors.
JAX donates the pool through each jitted step; the port writes it IN
PLACE (``index_put_`` into ``pool.kv``).  Writes of invalid positions all
land on scratch page 0, which is harmless only because nothing ever
reads page 0 as live data.

With ``kv_offload`` the batcher rides the host KV tier
(:mod:`tpulab_torch.kvcache`): a preempted lane's pages are snapshotted
to host memory and restored at resume with no prefill, and an evicted
prefix-cache page is demoted to the host tier and promoted back on the
next hit.  ``submit(export_digest=...)`` and :meth:`ContinuousBatcher.
submit_shipped` are the two halves of disaggregated serving
(:mod:`tpulab_torch.disagg`).

Pages may store a narrower dtype than the compute path
(``kv_dtype=torch.float8_e4m3fn``, ``float8_e5m2``, ``float16``): every
write rounds through
:func:`to_kv_dtype`, tpulab's cast bit for bit, and the kernels read the
narrow pages themselves.  Weight-only int8 trees serve unchanged: the
forwards dequantize through ``qmat``.

With ``hbm`` (an :class:`~tpulab_torch.hbm.HBMArbiter`) the batcher is
the arbiter's KV tenant: its page store grows on a ladder when queued
work wants pages (the arbiter may evict a cold model to supply them) and
shrinks when another tenant presses it (idle lanes demote through the
host tier first), and each program records its scratch per shape key.

The observability plane rides along when attached: ``trace`` (a
ChromeTraceRecorder: queue / prefill / decode / swap spans on the lane's
row), ``metrics`` (latency distributions at the source), ``flight`` (one
wide event per request) and ``arm_profile`` (a ``torch.profiler``
capture over the next scheduler passes, the Debug RPC's
``profile_ticks``).  The fault sites are tpulab's: ``engine.prefill`` at
each prefill start, ``engine.step`` at each decode tick (k per K-block,
once for a mixed round carrying decode lanes) and ``engine.verify``.

With ``kv_publish`` (requires ``kv_offload``) the batcher is an owner of
the fleet KV fabric (:mod:`tpulab_torch.kvfabric`): each finished first
prefill of the split plan snapshots its prompt pages to the host tier
under ``("fab", digest)`` beside the prefill's f32 logits row under
``("fablog", digest)``, which the ``FetchKV`` RPC serves to routed-astray
fetchers.  As in tpulab, the ragged plan publishes nothing (its mixed
rounds never fetch a host-visible logits row).

With ``mesh`` (a ``{"model": M}`` mesh over M ranks, one process per
card) the batcher serves tensor-parallel (:mod:`tpulab_torch.engine.
sharded`): every rank constructs the same batcher; each holds its
Megatron shards of the weights and its KV heads of the pool, and the
programs take ``tensor_parallel=``.  Rank 0 of the axis schedules and
takes requests; the others replay its device operations, a
:class:`~tpulab_torch.modelstore.BatcherAdapter`'s weight swaps
included.  Both plans, int8 trees and ``kv_publish`` run under a mesh;
on the card the split plan's prompt attention is the flash kernel on
each rank's own query heads.

PyTorch runs eagerly, so tpulab's ``_jit`` / ``_JIT_MEMO`` have no
counterpart.  The XLA-gather escape hatch (``use_kernel=False``) is not
ported: it raises ``NotImplementedError``.

tpulab's bench rows of this module close it:
:func:`benchmark_decode_dispatch`, :func:`benchmark_speculative_decode`,
:func:`benchmark_ragged_attention`, :func:`benchmark_llm_decode`,
:func:`benchmark_decode_kernel_vs_gather` and
:func:`benchmark_decode_kernel_sweep` (``benchmark_sharded_decode`` is in
:mod:`tpulab_torch.engine.sharded`).  Their gather comparator
(:func:`_gather_decode_step`) is theirs alone.
"""

from __future__ import annotations

import functools
import logging
import os
import threading
import time as _time
from collections import OrderedDict
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from tpulab_torch import chaos
from tpulab_torch.core.deadline import Deadline, DeadlineExceeded
from tpulab_torch.cuda.allocators import DeviceRawAllocator
from tpulab_torch.cuda.platform import resolve_device
from tpulab_torch.engine.prng import device_sample_tokens
from tpulab_torch.models.transformer import (
    _add, _dense_ffn, _embed, _lm_head, _mm, _rmsnorm, _tree, apply_rope,
    causal_attention, qmat, repeat_kv, split_qkv,
    transformer_forward_collect_kv, weight_shape)
from tpulab_torch.ops.flash_attention import make_flash_attention_fn
from tpulab_torch.ops.ragged_attention import (KV_CODE, check_built,
                                               pool_bytes,
                                               ragged_paged_attention)

_log = logging.getLogger("tpulab_torch.engine")


class PagedKVPool:
    """Global paged K/V storage + free-page accounting (host side).

    Under a ``mesh`` (a ``model`` axis of M ranks) the page payloads shard
    on the KV-heads dim (:func:`~tpulab_torch.parallel.sharding.
    kv_pool_sharding`): ``kv`` is this rank's plain local store ``(L, P,
    2, S, Hkv/M, D)``, rank r holding heads ``[r*Hkv/M, (r+1)*Hkv/M)``,
    while page ids, refcounts and the free list stay logical, kept by the
    coordinator (rank 0 of the axis).  Its page gathers and scatters
    (:meth:`gather_pages`, :meth:`scatter_pages`) and :meth:`reset` are
    collective: the coordinator publishes each on the pool's
    :class:`~tpulab_torch.engine.sharded.MeshChannel` and the followers
    replay it in :meth:`follow`."""

    def __init__(self, n_pages: int, page_size: int, n_layers: int,
                 n_heads: int, head_dim: int, dtype=torch.bfloat16,
                 device=None, allocator=None, mesh=None):
        #: the mesh the page payloads shard over (None: one device)
        self.mesh = mesh
        #: the payloads' placements under the mesh (tpulab's kv_sharding)
        self.kv_sharding = None
        self._tp = None
        #: the coordinator's descriptors to the followers (None: no mesh)
        self.channel = None
        shards = 1
        if mesh is not None:
            from tpulab_torch.engine.sharded import MeshChannel, mesh_device
            from tpulab_torch.parallel.mesh import axis_size
            from tpulab_torch.parallel.sharding import kv_pool_sharding
            from tpulab_torch.parallel.tensor_parallel import TensorParallel
            if "model" not in (mesh.mesh_dim_names or ()):
                raise ValueError("pool mesh needs a 'model' axis")
            shards = axis_size(mesh, "model")
            if n_heads % shards:
                raise ValueError(
                    f"pool KV heads ({n_heads}) not divisible by the mesh "
                    f"model axis ({shards}) — page payloads shard on the "
                    "KV-heads dim")
            self.device = mesh_device(mesh)
            if device is not None and resolve_device(device) != self.device:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{self.device}")
            self.kv_sharding = kv_pool_sharding(mesh)
            self._tp = TensorParallel(mesh)
            self.channel = MeshChannel(self._tp)
        else:
            self.device = resolve_device(device)
        self.n_pages = n_pages
        self.page_size = page_size
        self.n_layers = n_layers
        self.n_shards = shards
        # FUSED page layout: a page's K rows ([.., 0, ..]) and V rows
        # ([.., 1, ..]) are adjacent, so one layer's pool is one
        # contiguous (P, 2, S, Hkv, D) tensor for the kernel
        self._shape = (n_layers, n_pages, 2, page_size, n_heads // shards,
                       head_dim)
        self._dtype = dtype
        self._alloc = allocator or DeviceRawAllocator(self.device)
        self._kv_addr, self._kv = self._alloc.allocate_array(self._shape,
                                                             dtype)
        # page 0 is RESERVED as scratch: inactive/padded lanes scatter
        # their (masked-out) K/V there, so it must never hold live data
        self._free: List[int] = list(range(1, n_pages))
        self._refs: Dict[int, int] = {}
        self._lock = threading.Lock()
        #: allocate lowest page ids first (the HBM arbiter arms this):
        #: live data packs toward page 0, so the TOP of the store stays
        #: contiguously free and :meth:`shrink` can return real bytes
        self.prefer_low_pages = False

    @property
    def coordinator(self) -> bool:
        """Does this rank keep the pool's logical state (always, without a
        mesh)?"""
        return self.channel is None or self.channel.coordinator

    @property
    def logical_shape(self):
        """The whole store's shape, every rank's KV heads together."""
        s = self._shape
        return s[:4] + (s[4] * self.n_shards,) + s[5:]

    @property
    def kv(self) -> torch.Tensor:
        return self._kv

    @kv.setter
    def kv(self, value: torch.Tensor) -> None:
        self._kv = self._alloc.replace(self._kv_addr, value)

    @property
    def dtype(self):
        return self._dtype

    @property
    def hbm_bytes(self) -> int:
        """Tracked device bytes of this pool's page store: the LOGICAL
        figure under a mesh (every shard's), as tpulab counts it; each
        rank holds :attr:`hbm_bytes_per_shard`."""
        return self.hbm_bytes_per_shard * self.n_shards

    @property
    def hbm_bytes_per_shard(self) -> int:
        """This rank's device bytes of the page store."""
        return (self._alloc.node_size(self._kv_addr)
                if self._kv_addr is not None else 0)

    @property
    def page_nbytes(self) -> int:
        """Bytes one logical page costs (every layer's K+V rows)."""
        return self.hbm_bytes // max(1, self.n_pages)

    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    def reset(self) -> None:
        """Zero the store and forget every page (recovery after a failed
        step; the store is rewritten in place, so zeroing suffices).
        Under a mesh the coordinator's reset zeroes every rank's shard."""
        if self.channel is not None:
            self.channel.run("reset", self._reset_local)
        else:
            self._reset_local()
        with self._lock:
            self._free = list(range(1, self.n_pages))
            self._refs.clear()

    def close(self) -> None:
        """Drop the page store (the allocator's gauge falls to 0)."""
        if self._kv_addr is not None:
            self._alloc.deallocate_node(self._kv_addr)
            self._kv_addr = None
            self._kv = None

    # -- the payloads of pages (the host KV tier's gathers and scatters) -----
    def _index(self, pages: List[int]) -> torch.Tensor:
        return torch.as_tensor(pages, dtype=torch.long).to(self.device)

    def gather_pages(self, pages: List[int]) -> Optional[torch.Tensor]:
        """``kv[:, pages]`` of the whole store ``(L, n, 2, S, Hkv, D)``, on
        the caller's stream.  Under a mesh every rank's KV heads are
        gathered to the coordinator in rank order (collective: the
        coordinator publishes it); followers get None."""
        if self.channel is not None:
            return self.channel.run("gather", self._gather, list(pages))
        return self._gather(pages)

    def _gather(self, pages: List[int]) -> Optional[torch.Tensor]:
        local = pool_bytes(self._kv).index_select(1, self._index(pages))
        if self._tp is None or self._tp.size == 1:
            return local.view(self._dtype)
        tp = self._tp
        parts = ([torch.empty_like(local) for _ in range(tp.size)]
                 if tp.rank == 0 else None)
        dist.gather(local, parts, dst=dist.get_global_rank(tp.group, 0),
                    group=tp.group)
        if tp.rank != 0:
            return None
        return torch.cat(parts, dim=4).view(self._dtype)

    def scatter_pages(self, pages: List[int],
                      data: Optional[torch.Tensor]) -> None:
        """``kv[:, pages] = data`` in place, on the caller's stream;
        ``data`` holds the whole store's heads ``(L, n, 2, S, Hkv, D)``,
        on the host (a page-locked source copies asynchronously) or the
        device.  Under a mesh the coordinator scatters each rank its KV
        heads (collective: the coordinator publishes it; followers pass
        None).  An fp8 pool is written through its bytes."""
        if self.channel is not None:
            self.channel.run("scatter", lambda p: self._scatter(p, data),
                             list(pages))
        else:
            self._scatter(pages, data)

    def _scatter(self, pages: List[int],
                 data: Optional[torch.Tensor]) -> None:
        idx = self._index(pages)
        raw = pool_bytes(self._kv)
        if self._tp is None or self._tp.size == 1:
            raw.index_copy_(1, idx, pool_bytes(
                data.to(self.device, non_blocking=True)))
            return
        tp = self._tp
        local = torch.empty((raw.shape[0], len(pages)) + raw.shape[2:],
                            dtype=raw.dtype, device=self.device)
        parts = None
        if tp.rank == 0:
            full = pool_bytes(data.to(self.device, non_blocking=True))
            parts = [c.contiguous() for c in full.chunk(tp.size, dim=4)]
        dist.scatter(local, parts, src=dist.get_global_rank(tp.group, 0),
                     group=tp.group)
        raw.index_copy_(1, idx, local)

    def follow(self, ops: Optional[Dict[str, Any]] = None) -> None:
        """Follower: replay the coordinator's operations on this rank's
        shard until it publishes ``"stop"`` (:meth:`stop_followers`).
        ``ops`` adds operations by name (the batcher's programs).  An
        operation that raises is fatal to the mesh: the replay ends with
        :class:`~tpulab_torch.engine.sharded.MeshFailure`, and the
        coordinator's next collective and fetch fail."""
        if self.channel is None or self.coordinator:
            raise RuntimeError("follow() runs on the followers of a mesh "
                               "pool")
        table = {"reset": self._reset_local, "gather": self._gather,
                 "scatter": lambda pages: self._scatter(pages, None)}
        table.update(ops or {})
        while True:
            op, args, kw = self.channel.next()
            if op == "stop":
                return
            self.channel.run(op, table[op], *args, **kw)

    def stop_followers(self) -> None:
        """Coordinator: end the followers' :meth:`follow`."""
        if self.channel is not None:
            self.channel.stop()

    def _reset_local(self) -> None:
        self._kv.zero_()

    def allocate_page(self) -> Optional[int]:
        with self._lock:
            if not self._free:
                return None
            if self.prefer_low_pages:
                page = min(self._free)
                self._free.remove(page)
            else:
                page = self._free.pop()
            self._refs[page] = 1
            return page

    def add_ref(self, page: int) -> None:
        """Share an allocated page (prefix caching)."""
        with self._lock:
            if page not in self._refs:
                raise ValueError(f"add_ref on non-live page {page}")
            self._refs[page] += 1

    def release_pages(self, pages: List[int]) -> None:
        """Drop one reference per page; a page frees at count 0."""
        with self._lock:
            for p in pages:
                if not p:
                    continue  # the scratch page never re-enters
                n = self._refs.get(p, 1) - 1
                if n <= 0:
                    self._refs.pop(p, None)
                    self._free.append(p)
                else:
                    self._refs[p] = n

    def refcount(self, page: int) -> int:
        with self._lock:
            return self._refs.get(page, 0)

    # -- elastic capacity (the HBM economy, tpulab_torch.hbm) ---------------
    # Under an arbiter the batcher grows the store when a KV burst wins
    # bytes from the other tenants and shrinks it when a model's residency
    # squeezes KV back.  Both re-materialize the store through the tracked
    # allocator's replace() slot, so the gauge (and the ledger claim
    # mirroring it) follows the tracked byte count exactly.  Page ids are
    # STABLE: grow appends ids, shrink only drops contiguously free ids off
    # the top — no live block table is ever remapped.  Each briefly holds
    # the old and the new store (a copy the ledger does not see), and the
    # old store's memory stays reserved by PyTorch's caching allocator
    # after it is freed.  Scheduler-thread only, with no block in flight
    # (the old store is freed on the scheduler's stream, after every
    # forward enqueued there has read it).
    def shrinkable_pages(self) -> int:
        """Free pages contiguously at the TOP of the store."""
        with self._lock:
            free = set(self._free)
            n, p = 0, self.n_pages - 1
            while p >= 1 and p in free:
                n += 1
                p -= 1
            return n

    def grow(self, extra_pages: int) -> int:
        """Append ``extra_pages`` zeroed pages (ids stay stable)."""
        extra = int(extra_pages)
        if extra <= 0:
            return 0
        n = self.n_pages
        new = torch.empty((self._shape[0], n + extra) + self._shape[2:],
                          dtype=self._dtype, device=self.device)
        dst = pool_bytes(new)      # fp8 stores: through a byte view
        dst[:, :n].copy_(pool_bytes(self._kv))
        dst[:, n:].zero_()
        self.kv = new
        with self._lock:
            self._free.extend(range(self.n_pages, self.n_pages + extra))
            self.n_pages += extra
            self._shape = (self._shape[0], self.n_pages) + self._shape[2:]
        return extra

    def shrink(self, drop_pages: int) -> int:
        """Drop up to ``drop_pages`` contiguously free pages off the top;
        never page 0, never a live id.  Returns the pages dropped."""
        with self._lock:
            free = set(self._free)
            k, p = 0, self.n_pages - 1
            while p >= 1 and p in free and k < int(drop_pages):
                k += 1
                p -= 1
            if k == 0:
                return 0
            cut = self.n_pages - k
            self._free = [q for q in self._free if q < cut]
            self.n_pages = cut
            self._shape = (self._shape[0], cut) + self._shape[2:]
        self.kv = self._kv[:, :cut].clone()
        return k


def _gather_attend(q, k_layer, v_layer, tables, qpos, compute_dtype):
    """Dense-gather paged attention: tpulab's own XLA fallback math, kept
    as a reference the tests hold the ragged kernel family against.

    q (B, M, H, D); k_layer/v_layer (P, S, Hkv, D); tables (B, MP);
    qpos (B, M) global position of each query (context j visible iff
    j <= qpos).  Returns (B, M, H*D) in ``compute_dtype``."""
    b, m, h, d = q.shape
    mp = tables.shape[1]
    page_size = k_layer.shape[1]
    tl = tables.long()
    k_ctx = repeat_kv(k_layer[tl].reshape(b, mp * page_size, -1, d), h)
    v_ctx = repeat_kv(v_layer[tl].reshape(b, mp * page_size, -1, d), h)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k_ctx.float()) / np.sqrt(d)
    j = torch.arange(mp * page_size, device=q.device)
    mask = j[None, None, :] <= qpos[:, :, None]
    scores = torch.where(mask[:, None], scores,
                         torch.tensor(-1e30, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(compute_dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs,
                        v_ctx.to(compute_dtype)).reshape(b, m, h * d)


#: |x| above this rounds past e4m3's largest finite value (448)
_E4M3_ROUND_LIMIT = 464.0


def _sign(x: torch.Tensor) -> torch.Tensor:
    """Each element's sign bit (uint8 0 or 1), read from its bits: the
    card's ``torch.signbit`` does not read a NaN's."""
    ints = {4: torch.int32, 2: torch.int16, 1: torch.int8}[x.element_size()]
    return (x.view(ints) < 0).to(torch.uint8)


def _f16_nan_bits(x: torch.Tensor) -> torch.Tensor:
    """The f16 NaN jnp's cast gives for each element of an f32 or bf16
    ``x`` (int16 bits): the sign, the quiet bit and the top mantissa bits
    of the source's payload."""
    if x.dtype == torch.float32:
        b = x.view(torch.int32)
        code = (((b >> 16) & 0x8000) | 0x7E00
                | ((b & 0x7FFFFF) >> 13))
    else:
        b = x.view(torch.int16).to(torch.int32) & 0xFFFF
        code = (b & 0x8000) | 0x7E00 | ((b & 0x7F) << 3)
    return torch.where(code >= 0x8000, code - 0x10000, code).to(torch.int16)


def to_kv_dtype(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` cast to a pool's page dtype as tpulab casts it (``x.astype(
    kv_pool.dtype)``), with the same bits on the CPU and on the card.
    ``Tensor.to`` gives jnp's bits for every number but not everywhere
    for NaN, whose code jnp takes from the source dtype and ``.to`` from
    the device (the card's makes every f16 NaN 0x7FFF and drops the sign
    of an fp8 NaN from f16).  So NaN (and what rounds to it) gets jnp's
    code here:

    - ``float8_e4m3fn``: round to nearest even; NaN (0x7F, 0xFF when
      negative) where x is NaN, +-inf or |x| > 464, where ``.to``
      saturates to +-448;
    - ``float8_e5m2``: an f32 NaN is 0x7E under its sign, a bf16 or f16
      NaN 0x7F;
    - ``float16``: an f32 or bf16 NaN keeps its sign and the top of its
      payload, quieted (:func:`_f16_nan_bits`).

    Other dtypes take a plain ``.to``."""
    if dtype == torch.float8_e4m3fn:
        bits = x.to(dtype).view(torch.uint8)
        nan = (_sign(x) << 7) | 0x7F
        return torch.where((x.abs() > _E4M3_ROUND_LIMIT) | torch.isnan(x),
                           nan, bits).view(dtype)
    if dtype == torch.float8_e5m2:
        bits = x.to(dtype).view(torch.uint8)
        nan = ((_sign(x) << 7) | 0x7E
               if x.dtype == torch.float32 else torch.tensor(
                   0x7F, dtype=torch.uint8, device=x.device))
        return torch.where(torch.isnan(x), nan, bits).view(dtype)
    if dtype == torch.float16 and x.dtype in (torch.float32,
                                              torch.bfloat16):
        bits = x.to(dtype).view(torch.int16)
        return torch.where(torch.isnan(x), _f16_nan_bits(x),
                           bits).view(dtype)
    return x.to(dtype)


def _write_kv(kv_pool, layer, page_idx, slot_idx, k, v):
    """Scatter new K/V rows into their pages, in place (JAX donates and
    rebuilds the pool here), each cast by :func:`to_kv_dtype`.  Every
    pool write of the batcher's programs goes through here."""
    raw = pool_bytes(kv_pool)
    raw[layer, :, 0][page_idx, slot_idx] = pool_bytes(
        to_kv_dtype(k, kv_pool.dtype))
    raw[layer, :, 1][page_idx, slot_idx] = pool_bytes(
        to_kv_dtype(v, kv_pool.dtype))


def _attend(q, kv_pool, layer, tables, q_lens, kv_lens, compute_dtype):
    """One layer's attention through the ragged kernel family (the kernel
    on CUDA, its plain version on CPU).  Returns (B, M, H*D) in
    ``compute_dtype``."""
    b, m, h, d = q.shape
    out = ragged_paged_attention(q.contiguous(), kv_pool[layer], tables,
                                 q_lens, kv_lens)
    return out.to(compute_dtype).reshape(b, m, h * d)


def _embed_in(params, tokens, compute_dtype, tp):
    """The token rows: this rank's vocab rows summed over the axis under
    ``tp`` (a :class:`~tpulab_torch.parallel.tensor_parallel.
    TensorParallel`)."""
    if tp is None:
        return _embed(params, tokens, compute_dtype)
    return tp.embed(params["embed"], tokens, compute_dtype)


def _qkv(p, h, b, m, n_heads, n_kv, head_dim, compute_dtype, tp):
    """The layer's q (B, M, Hq, D) and new K/V (B, M, Hkv, D).  Under
    ``tp`` the column-sharded projection is all-gathered (the fused
    ``wqkv`` columns are not head groups) and this rank keeps its query
    heads ``[r*Hq/M, ...)`` and KV heads ``[r*Hkv/M, ...)``: the heads of
    its pool shard, under its rows of ``wo``."""
    qkv = _mm(h, qmat(p["wqkv"], compute_dtype))
    if tp is None:
        return split_qkv(qkv, b, m, n_heads, n_kv, head_dim)
    q, k, v = split_qkv(tp.gather_last(qkv), b, m, n_heads, n_kv, head_dim)
    hq, hk = n_heads // tp.size, n_kv // tp.size
    return (q[:, :, tp.rank * hq:(tp.rank + 1) * hq],
            k[:, :, tp.rank * hk:(tp.rank + 1) * hk],
            v[:, :, tp.rank * hk:(tp.rank + 1) * hk])


def _residual(x, y, tp):
    """``x + y`` of a row-parallel partial product ``y``: summed over the
    axis under ``tp`` first."""
    return _add(x, y if tp is None else tp.reduce(y))


def _ffn_block(p, x, compute_dtype, tp):
    """The post-attention half of a layer: norm, FFN, residual (the FFN's
    ``w2`` partial sums reduced under ``tp``)."""
    h2 = _rmsnorm(x, p["ln2"]["scale"])
    y = _dense_ffn(p, h2, compute_dtype)
    return x + (y if tp is None else tp.reduce(y)).to(x.dtype)


def _vocab(params, x, tp):
    """f32 logits over the whole vocab: this rank's columns all-gathered
    under ``tp`` (every rank then picks the same token)."""
    logits = _lm_head(params, x)
    return logits if tp is None else tp.gather_last(logits)


def _pick(logits, temps, seeds, positions):
    """On-device pick + its log-probability (no host sync)."""
    next_tokens = device_sample_tokens(logits, temps, seeds, positions)
    logprobs = torch.log_softmax(logits.float(), dim=-1).gather(
        1, next_tokens[:, None])[:, 0]
    return next_tokens, logprobs


def paged_decode_step(params, kv_pool, tables, lengths, tokens, active,
                      n_heads: int, n_layers: int, compute_dtype,
                      n_kv_heads: Optional[int] = None,
                      rope_theta: Optional[float] = None,
                      temps=None, seeds=None, tensor_parallel=None):
    """One batched decode tick over the paged pool (written in place).

    kv_pool (L, P, 2, S, Hkv, D); tables (B, MP) int32 page ids (padded
    rows repeat page 0); lengths (B,) current position per lane;
    tokens (B,); active (B,) bool.  Returns logits (B, vocab) f32, or
    with ``temps (B,)`` + ``seeds (B, 2)`` the device-sampled
    ``(next_tokens (B,) int64, logprobs (B,) f32, logits)``.

    ``tensor_parallel`` (a :class:`~tpulab_torch.parallel.
    tensor_parallel.TensorParallel`) runs the tick on this rank's
    Megatron shards of ``params`` and its KV-heads shard of the pool;
    every program of this module takes it the same way.  The logits are
    the whole vocab on every rank."""
    return _decode_step(params, kv_pool, tables, lengths, tokens, active,
                        n_heads, n_layers, compute_dtype, n_kv_heads,
                        rope_theta, temps, seeds, tensor_parallel, _attend)


def _gather_layer(q, kv_pool, layer, tables, q_lens, kv_lens,
                  compute_dtype):
    """:func:`_attend`'s signature over :func:`_gather_attend` (tpulab's
    XLA fallback math; float pages only)."""
    qpos = ((kv_lens - q_lens).long()[:, None]
            + torch.arange(q.shape[1], device=q.device)[None, :])
    return _gather_attend(q, kv_pool[layer, :, 0], kv_pool[layer, :, 1],
                          tables, qpos, compute_dtype)


def _gather_decode_step(params, kv_pool, tables, lengths, tokens, active,
                        n_heads: int, n_layers: int, compute_dtype,
                        n_kv_heads: Optional[int] = None,
                        rope_theta: Optional[float] = None):
    """:func:`paged_decode_step` with attention through the dense gather:
    the comparator of :func:`benchmark_decode_kernel_vs_gather` only.  No
    batcher or program reaches it (decisions: use_kernel=False)."""
    return _decode_step(params, kv_pool, tables, lengths, tokens, active,
                        n_heads, n_layers, compute_dtype, n_kv_heads,
                        rope_theta, None, None, None, _gather_layer)


def _decode_step(params, kv_pool, tables, lengths, tokens, active, n_heads,
                 n_layers, compute_dtype, n_kv_heads, rope_theta, temps,
                 seeds, tensor_parallel, attend):
    tp = tensor_parallel
    n_kv = n_kv_heads or n_heads
    b = tokens.shape[0]
    page_size = kv_pool.shape[3]
    mp = tables.shape[1]
    x = _embed_in(params, tokens, compute_dtype, tp)[:, None, :]
    d_model = x.shape[-1]
    head_dim = d_model // n_heads
    lengths = lengths.long()
    # write target per lane; JAX clamps an out-of-range gather silently,
    # PyTorch would raise a device-side assert — clamp explicitly
    col = (lengths // page_size).clamp(0, mp - 1)
    page_idx = tables.gather(1, col[:, None])[:, 0].long()
    safe_page = torch.where(active, page_idx, 0)
    safe_slot = torch.where(active, lengths % page_size, 0)
    q_lens = torch.ones_like(lengths, dtype=torch.int32)
    kv_lens = (lengths + 1).to(torch.int32)       # a count, not a position
    for layer in range(n_layers):
        p = params[f"layer{layer}"]
        h = _rmsnorm(x, p["ln1"]["scale"])
        q, knew, vnew = _qkv(p, h, b, 1, n_heads, n_kv, head_dim,
                             compute_dtype, tp)
        if rope_theta:
            q = apply_rope(q, lengths[:, None], rope_theta)
            knew = apply_rope(knew, lengths[:, None], rope_theta)
        _write_kv(kv_pool, layer, safe_page, safe_slot, knew[:, 0],
                  vnew[:, 0])
        attn = attend(q, kv_pool, layer, tables, q_lens, kv_lens,
                      compute_dtype)
        x = _residual(x, _mm(attn, qmat(p["wo"], compute_dtype)), tp)
        x = _ffn_block(p, x, compute_dtype, tp)
    x = _rmsnorm(x, params["final_norm"]["scale"])
    logits = _vocab(params, x[:, 0], tp)
    # inactive lanes emit neutral logits (argmax 0) — callers mask on active
    logits = torch.where(active[:, None], logits, 0.0)
    if temps is None:
        return logits
    next_tokens, logprobs = _pick(logits, temps, seeds, lengths)
    return next_tokens, logprobs, logits


def paged_decode_block(params, kv_pool, tables, lengths, tokens, active,
                       temps, seeds, steps_rem, stop_ids,
                       n_heads: int, n_layers: int, compute_dtype,
                       k: int = 8,
                       n_kv_heads: Optional[int] = None,
                       rope_theta: Optional[float] = None,
                       tensor_parallel=None):
    """K chained decode ticks with on-device sampling and a per-lane stop
    mask, enqueued without a host sync (tpulab scans the same body).

    A lane is live while active, with steps remaining and no stop token
    emitted; a stop token is emitted as the lane's last token, after
    which its writes go to scratch and its position freezes.  The caller
    pre-allocates every page the block can reach.  Returns ``(tokens
    (B, K), logprobs (B, K), emitted (B, K) prefix mask, lengths,
    last_tokens, live, steps_rem)`` — the last four are the device carry
    a follow-up block chains from."""
    lens, toks = lengths.long(), tokens.long()
    live, rem = active, steps_rem.long()
    out_t, out_lp, out_em = [], [], []
    for _ in range(k):
        nt, lp, _logits = paged_decode_step(
            params, kv_pool, tables, lens, toks, live, n_heads=n_heads,
            n_layers=n_layers, compute_dtype=compute_dtype,
            n_kv_heads=n_kv_heads, rope_theta=rope_theta, temps=temps,
            seeds=seeds, tensor_parallel=tensor_parallel)
        emitted = live
        nt = torch.where(live, nt, toks)          # dead lanes hold position
        lens = lens + emitted.long()
        rem = rem - emitted.long()
        hit_stop = (nt[:, None] == stop_ids).any(dim=1)
        live = live & (rem > 0) & ~hit_stop
        toks = nt
        out_t.append(nt)
        out_lp.append(lp)
        out_em.append(emitted)
    return (torch.stack(out_t, 1), torch.stack(out_lp, 1),
            torch.stack(out_em, 1), lens, toks, live, rem)


def paged_speculative_block(params, draft_params, kv_pool, tables,
                            draft_tables, lengths, tokens, active, temps,
                            seeds, steps_rem, stop_ids,
                            n_heads: int, n_layers: int,
                            draft_n_heads: int, draft_n_layers: int,
                            compute_dtype, k: int = 4,
                            n_kv_heads: Optional[int] = None,
                            draft_n_kv_heads: Optional[int] = None,
                            rope_theta: Optional[float] = None,
                            tensor_parallel=None):
    """Speculative decode: draft-propose, target-verify and per-lane
    accept, enqueued without a host sync (the pool is written in place).

    The draft proposes through a SECOND page table on the same pool:
    ``k + 1`` single-token :func:`paged_decode_step` calls (the last
    proposal is discarded, so a fully accepted round leaves no hole in
    the draft KV); a lane is active in step i only while ``i <
    steps_rem``.  The target verifies ``[cur, d_0 .. d_{k-1}]`` in ONE
    :func:`paged_ragged_forward` (``q_lens = min(k+1, steps_rem)`` on
    active lanes, 0 elsewhere), and picks its own choice at every
    position with the plain stream's (seed, position) key, so the emitted
    tokens are exactly the non-speculative stream.  Each lane emits the
    agreeing prefix plus the target's correction (or bonus), truncated
    after a stop token and at the steps budget.  The draft samples
    through the same function on its own logits.

    The caller reserves BOTH tables for positions ``lengths .. lengths +
    k``.  Returns ``(tokens (B, k+1), logprobs (B, k+1), emitted (B, k+1)
    prefix mask, lengths, last_tokens, live, steps_rem, drafted (B,),
    accepted (B,))``."""
    lens, toks = lengths.long(), tokens.long()
    rem = steps_rem.long()
    props = []
    tok = toks
    for i in range(k + 1):
        tok, _lp, _logits = paged_decode_step(
            draft_params, kv_pool, draft_tables, lens + i, tok,
            active & (i < rem), n_heads=draft_n_heads,
            n_layers=draft_n_layers, compute_dtype=compute_dtype,
            n_kv_heads=draft_n_kv_heads, rope_theta=rope_theta,
            temps=temps, seeds=seeds, tensor_parallel=tensor_parallel)
        props.append(tok)
    drafts = torch.stack(props[:k], 1)                        # (B, k)
    # position j's write is real only while the lane can still emit
    # token j (query j consumes writes 0..j only)
    seq = torch.cat([toks[:, None], drafts], 1)               # (B, k+1)
    q_lens = torch.where(active, rem.clamp_min(0).clamp_max(k + 1), 0)
    logits = paged_ragged_forward(
        params, kv_pool, tables, seq, q_lens, lens + q_lens,
        n_heads=n_heads, n_layers=n_layers, compute_dtype=compute_dtype,
        n_kv_heads=n_kv_heads, rope_theta=rope_theta,
        tensor_parallel=tensor_parallel)                      # (B, k+1, V)
    b, w, vocab = logits.shape
    pos = lens[:, None] + torch.arange(w, device=lens.device)[None, :]
    flat = logits.reshape(b * w, vocab)
    cand = device_sample_tokens(
        flat, temps.repeat_interleave(w), seeds.repeat_interleave(w, 0),
        pos.reshape(-1)).reshape(b, w)
    lps = torch.log_softmax(flat.float(), dim=-1).gather(
        1, cand.reshape(-1, 1))[:, 0].reshape(b, w)
    # accept on device: the agreeing prefix + the correction, cut after
    # the first stop token and at the steps budget
    agree = (drafts == cand[:, :k]).long()
    acc = torch.cumprod(agree, 1).sum(1)                      # (B,)
    hit = (cand[:, :, None] == stop_ids[:, None, :]).any(2)   # (B, k+1)
    any_hit = hit.any(1)
    first_stop = hit.long().argmax(1)
    stop_cap = torch.where(any_hit, first_stop + 1, k + 1)
    n = torch.minimum(torch.minimum(acc + 1, stop_cap), rem)
    n = torch.where(active, n, 0)
    emitted = torch.arange(w, device=n.device)[None, :] < n[:, None]
    last = cand.gather(1, (n - 1).clamp_min(0)[:, None])[:, 0]
    rem = rem - n
    live = active & (rem > 0) & ~(any_hit & (stop_cap <= n))
    drafted = torch.where(active, k, 0)
    accepted = torch.where(active, torch.minimum(acc, n), 0)
    return (cand, lps, emitted, lens + n, torch.where(n > 0, last, toks),
            live, rem, drafted, accepted)


def paged_ragged_forward(params, kv_pool, tables, seq, q_lens, kv_lens,
                         n_heads: int, n_layers: int, compute_dtype,
                         n_kv_heads: Optional[int] = None,
                         rope_theta: Optional[float] = None,
                         last_only: bool = False, tensor_parallel=None):
    """One fused multi-token forward over ragged per-lane segments.

    seq (B, M) left-packed: lane b's valid tokens are ``seq[b,
    :q_lens[b]]``, token j at position ``kv_lens[b] - q_lens[b] + j``.
    Per layer the valid positions' K/V scatter into the lane's pages
    first (invalid ones to scratch page 0), then attention walks the
    lane's block table under global causality.  ``last_only`` runs the
    vocab head on each lane's last valid position only: logits (B,
    vocab); otherwise (B, M, vocab) with invalid rows garbage."""
    tp = tensor_parallel
    n_kv = n_kv_heads or n_heads
    b, m = seq.shape
    page_size = kv_pool.shape[3]
    mp = tables.shape[1]
    x = _embed_in(params, seq, compute_dtype, tp)         # (B, M, D)
    d_model = x.shape[-1]
    head_dim = d_model // n_heads
    ar = torch.arange(m, device=seq.device)
    q_lens_l, kv_lens_l = q_lens.long(), kv_lens.long()
    valid = ar[None, :] < q_lens_l[:, None]
    pos = (kv_lens_l - q_lens_l)[:, None] + ar[None, :]
    col = (pos // page_size).clamp(0, mp - 1)
    page_idx = torch.where(valid, tables.gather(1, col).long(), 0)
    slot_idx = torch.where(valid, pos % page_size, 0)
    q_lens32, kv_lens32 = q_lens.to(torch.int32), kv_lens.to(torch.int32)
    for layer in range(n_layers):
        p = params[f"layer{layer}"]
        h = _rmsnorm(x, p["ln1"]["scale"])
        q, knew, vnew = _qkv(p, h, b, m, n_heads, n_kv, head_dim,
                             compute_dtype, tp)
        if rope_theta:
            q = apply_rope(q, pos, rope_theta)
            knew = apply_rope(knew, pos, rope_theta)
        _write_kv(kv_pool, layer, page_idx, slot_idx, knew, vnew)
        attn = _attend(q, kv_pool, layer, tables, q_lens32, kv_lens32,
                       compute_dtype)
        x = _residual(x, _mm(attn, qmat(p["wo"], compute_dtype)), tp)
        x = _ffn_block(p, x, compute_dtype, tp)
    if last_only:
        last = (q_lens_l - 1).clamp_min(0)
        xl = x.gather(1, last[:, None, None].expand(b, 1, d_model))[:, 0]
        return _vocab(params, _rmsnorm(xl, params["final_norm"]["scale"]),
                      tp)
    x = _rmsnorm(x, params["final_norm"]["scale"])
    return _vocab(params, x, tp)


def paged_mixed_step(params, kv_pool, tables, seq, q_lens, kv_lens,
                     temps, seeds, n_heads: int, n_layers: int,
                     compute_dtype,
                     n_kv_heads: Optional[int] = None,
                     rope_theta: Optional[float] = None,
                     tensor_parallel=None):
    """One mixed prefill+decode round: a ragged forward plus each lane's
    pick on its last valid position (position ``kv_lens - 1``), so one
    request is one (seed, position)-keyed stream whichever dispatch kind
    served it.  Returns ``(next_tokens (B,), logprobs (B,), last_logits
    (B, vocab))``."""
    last = paged_ragged_forward(
        params, kv_pool, tables, seq, q_lens, kv_lens, n_heads=n_heads,
        n_layers=n_layers, compute_dtype=compute_dtype,
        n_kv_heads=n_kv_heads, rope_theta=rope_theta, last_only=True,
        tensor_parallel=tensor_parallel)
    pos_last = (kv_lens.long() - 1).clamp_min(0)
    next_tokens, logprobs = _pick(last, temps, seeds, pos_last)
    return next_tokens, logprobs, last


def paged_prefill(params, kv_pool, tables, tokens, valid_len,
                  n_heads: int, n_layers: int, compute_dtype,
                  n_kv_heads: Optional[int] = None,
                  rope_theta: Optional[float] = None,
                  attention_fn=None, tensor_parallel=None):
    """Fused prefill: ONE causal forward over the (padded) prompt, with each
    layer's K/V scattered into the lane's pages (in place).

    tokens (1, T_pad) (padded tail arbitrary); valid_len the prompt length
    (int or 0-d tensor); tables (MP,) this lane's page ids.  Padded
    positions write to the scratch page 0.  ``attention_fn`` takes (B, T,
    H, D) q and K/V repeated to H; ``None`` means the flash kernel
    (:func:`make_flash_attention_fn`) on CUDA tensors and dense causal
    attention, tpulab's default, on the CPU.  The final norm and vocab
    head run on the last valid position only; returns its logits
    (vocab,) f32 (the whole vocab under ``tensor_parallel``, where each
    rank writes its KV heads)."""
    tp = tensor_parallel
    page_size = kv_pool.shape[3]
    t_pad = tokens.shape[1]
    if attention_fn is None:
        attention_fn = (make_flash_attention_fn(causal=True)
                        if tokens.is_cuda else causal_attention)
    logits, kvs = transformer_forward_collect_kv(
        params, tokens, n_heads=n_heads, n_layers=n_layers,
        compute_dtype=compute_dtype, n_kv_heads=n_kv_heads,
        rope_theta=rope_theta, attention_fn=attention_fn,
        last_index=valid_len - 1, tensor_parallel=tp)
    if tp is not None:
        logits = tp.gather_last(logits)
        hk = kv_pool.shape[4]
        kvs = [(k[:, :, tp.rank * hk:(tp.rank + 1) * hk],
                v[:, :, tp.rank * hk:(tp.rank + 1) * hk]) for k, v in kvs]
    pos = torch.arange(t_pad, device=tokens.device)
    valid = pos < valid_len
    # JAX clamps an out-of-range gather; PyTorch would fault — clamp
    col = (pos // page_size).clamp(max=tables.shape[0] - 1)
    page_idx = torch.where(valid, tables.long()[col], 0)
    slot_idx = torch.where(valid, pos % page_size, 0)
    for layer, (k, v) in enumerate(kvs):
        _write_kv(kv_pool, layer, page_idx, slot_idx, k[0], v[0])
    return logits[0]


def paged_extend(params, kv_pool, tables, tokens, start, valid_total,
                 n_heads: int, n_layers: int, compute_dtype,
                 n_kv_heads: Optional[int] = None,
                 rope_theta: Optional[float] = None, tensor_parallel=None):
    """Chunked/tail prefill against EXISTING paged context.

    One forward over the tail tokens at positions ``start ..
    valid_total-1`` of a lane whose positions ``[0, start)`` are already
    in the pool (prefix-cache hits, earlier chunks, or a draft table's
    resident context).  tokens (1, M_pad) (padded tail arbitrary);
    tables (MP,) covering all of it.  ``start`` need not be page-aligned
    (the draft warm-up starts mid-page): positions come from ``kv_lens -
    q_lens``.  The tail writes every page it covers, so a caller sharing
    prefix pages (the prefix cache) starts the tail at or after the last
    shared page's end, as the page-granular cache does.  It is the
    ragged forward of one lane with ``q_lens = valid_total - start`` and
    ``kv_lens = valid_total``: per layer the tail's K/V scatter first,
    then attention walks the whole block table under global causality —
    the function of tpulab's gather-after-scatter, through the ragged
    kernel family.  Returns the last valid token's logits (vocab,) f32."""
    dev = tokens.device
    q_lens = torch.as_tensor([valid_total - start], device=dev)
    kv_lens = torch.as_tensor([valid_total], device=dev)
    return paged_ragged_forward(
        params, kv_pool, tables[None], tokens, q_lens, kv_lens,
        n_heads=n_heads, n_layers=n_layers, compute_dtype=compute_dtype,
        n_kv_heads=n_kv_heads, rope_theta=rope_theta, last_only=True,
        tensor_parallel=tensor_parallel)[0]


class PrefixCache:
    """Prompt prefix cache over the paged pool (full-page granularity).

    Maps a digest of ``prompt[:(i+1)*S]`` to the page holding that span's
    K/V; a hit shares the page (``add_ref``) and prefills only the tail.
    Only FULL prompt pages enter the cache and the last prompt token is
    never served from it, so shared pages are read-only by construction.
    LRU eviction under pool pressure; scheduler-thread only.

    Host-tier hooks (set by the batcher with ``kv_offload``):
    ``on_evict(digest, page)`` fires on pressure eviction BEFORE the page
    is released (the demotion window); ``promote_fn(digest) ->
    Optional[page]`` may resurrect a demoted entry during ``lookup`` (the
    returned page's one pool reference belongs to the cache)."""

    def __init__(self, pool: PagedKVPool):
        self._pool = pool
        self._entries: "OrderedDict[bytes, int]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.on_evict = None
        self.promote_fn = None
        self.host_promotions = 0  # lookup pages served from the host tier

    @staticmethod
    def _digests(prompt: np.ndarray, page_size: int, n_pages: int):
        import hashlib
        out = []
        raw = np.ascontiguousarray(prompt, np.int32)
        h = hashlib.blake2b(digest_size=16)
        for i in range(n_pages):
            h.update(raw[i * page_size:(i + 1) * page_size].tobytes())
            out.append(h.copy().digest())
        return out

    def lookup(self, prompt: np.ndarray, page_size: int):
        """Longest cached full-page prefix: ``(shared_pages, digests)``;
        shared pages are ref-bumped for the caller."""
        t = len(prompt)
        cacheable = max(0, (t - 1) // page_size)
        digests = self._digests(prompt, page_size, t // page_size)
        shared: List[int] = []
        for i in range(cacheable):
            page = self._entries.get(digests[i])
            if page is None and self.promote_fn is not None:
                page = self.promote_fn(digests[i])
                if page is not None:
                    self._entries[digests[i]] = page
                    self.host_promotions += 1
            if page is None:
                break
            self._entries.move_to_end(digests[i])
            self._pool.add_ref(page)
            shared.append(page)
        return shared, digests

    def coverage(self, prompt, page_size: int) -> int:
        """Cached-page count of ``prompt``'s full-page prefix WITHOUT the
        lookup's side effects (no LRU touch, no ref bump, no host-tier
        promotion) — the fleet KV fabric's local-hit probe: deciding
        whether a remote pull is worth it must not perturb the cache it
        measures.  Advisory: the RPC thread calls it while the scheduler
        mutates entries, so the answer can be one tick stale, which
        costs work (a skipped or a redundant pull), never correctness."""
        t = len(prompt)
        cacheable = max(0, (t - 1) // page_size)
        if cacheable == 0:
            return 0
        digests = self._digests(np.asarray(prompt, np.int32), page_size,
                                cacheable)
        n = 0
        for d in digests:
            if d not in self._entries:
                break
            n += 1
        return n

    def count_lookup(self, n_shared: int, n_full_pages: int) -> None:
        self.hits += n_shared
        self.misses += max(0, n_full_pages - n_shared)

    def insert(self, digests: List[bytes], pages: List[int]) -> None:
        """Publish full prompt pages (one extra pool ref each)."""
        for dig, page in zip(digests, pages):
            if dig in self._entries:
                self._entries.move_to_end(dig)
                continue
            self._pool.add_ref(page)
            self._entries[dig] = page

    def evict_one(self) -> bool:
        if not self._entries:
            return False
        _, page = self._entries.popitem(last=False)
        self._pool.release_pages([page])
        return True

    def evict_for_alloc(self) -> bool:
        """Evict the coldest entry whose page would actually free."""
        for dig, page in self._entries.items():
            if self._pool.refcount(page) == 1:
                del self._entries[dig]
                if self.on_evict is not None:
                    # the demotion's gather is enqueued before the release
                    # below, so a recycled page's later writes follow it
                    # (the hook degrades on its own; a device error in it
                    # goes to the scheduler's recovery path)
                    self.on_evict(dig, page)
                self._pool.release_pages([page])
                return True
        return False

    def clear(self) -> None:
        while self.evict_one():
            pass

    def drop_all(self) -> None:
        """Forget every entry without touching the pool (after reset)."""
        self._entries.clear()

    def __len__(self) -> int:
        return len(self._entries)


class SamplingParams:
    """Token selection policy (greedy by default) — tpulab's, copied.

    ``device=False``: host temperature / top-k / top-p sampling with a
    per-request numpy PRNG (needs the logits row every token).
    ``device=True``: Gumbel-max temperature sampling on the device, keyed
    by (seed, position); top-k/top-p are host-only."""

    __slots__ = ("temperature", "top_k", "top_p", "device", "seed", "_rng")

    def __init__(self, temperature: float = 0.0, top_k: int = 0,
                 seed: Optional[int] = None, device: bool = False,
                 top_p: float = 0.0):
        if temperature < 0:
            raise ValueError("temperature must be >= 0")
        if not 0.0 <= top_p <= 1.0:
            raise ValueError("top_p must be in [0, 1]")
        if device and (top_k > 0 or 0.0 < top_p < 1.0):
            raise ValueError("device sampling does not support top_k/top_p "
                             "(per-lane truncation is not a static shape); "
                             "use host sampling")
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.device = device
        if seed is None:
            seed = int(np.random.default_rng().integers(
                0, 2**64, dtype=np.uint64))
        self.seed = int(seed)
        self._rng = np.random.default_rng(seed)

    def pick(self, logits: np.ndarray) -> int:
        """Select the next token from a (vocab,) logits row."""
        if self.temperature == 0.0:
            return int(logits.argmax())
        z = logits.astype(np.float64) / self.temperature
        if self.top_k > 0 and self.top_k < z.shape[0]:
            kth = np.partition(z, -self.top_k)[-self.top_k]
            z = np.where(z >= kth, z, -np.inf)
        z = z - z.max()
        p = np.exp(z)
        p /= p.sum()
        if 0.0 < self.top_p < 1.0:
            order = np.argsort(p)[::-1]
            csum = np.cumsum(p[order])
            cut = int(np.searchsorted(csum, self.top_p)) + 1
            mask = np.zeros_like(p, dtype=bool)
            mask[order[:cut]] = True
            p = np.where(mask, p, 0.0)
            p /= p.sum()
        return int(self._rng.choice(z.shape[0], p=p))


class _PagedRequest:
    __slots__ = ("prompt", "steps", "future", "tokens_out", "pages",
                 "length", "pending_prompt", "on_token", "cancelled",
                 "sampling", "priority", "resumed", "admit_seq",
                 "stop_tokens", "want_logprobs", "logprobs_out", "deadline",
                 "pf_started", "pf_digests", "pf_shared",
                 "t_submit", "t_prefill0", "t_last",
                 "draft_pages", "draft_len", "spec_enabled", "spec_ewma",
                 "spec_drafted", "spec_accepted", "spec_probe_in",
                 "spec_probing", "kv_handle", "export_digest",
                 "t_resume0", "resume_kind", "trace_id", "tenant", "lane",
                 "fl", "pf_t0", "t_first", "chunk_t0", "chunk_start",
                 "batch")

    def __init__(self, prompt: np.ndarray, steps: int, on_token=None,
                 sampling: Optional[SamplingParams] = None,
                 priority: int = 0, stop_tokens=None,
                 logprobs: bool = False, deadline: Optional[float] = None,
                 trace_id: Optional[str] = None,
                 tenant: Optional[str] = None, batch: bool = False):
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.steps = steps
        self.future: Future = Future()
        self.tokens_out: List[int] = []
        self.pages: List[int] = []
        self.length = 0
        self.pending_prompt = list(self.prompt)
        self.on_token = on_token
        self.cancelled = False
        self.sampling = sampling or SamplingParams()
        self.priority = priority
        #: offline batch lane: ranks below every online request at any
        #: priority and is the first preemption victim
        self.batch = bool(batch)
        self.resumed = False       # preempted mid-decode: resume skips the
        #                            prefill pick (already emitted)
        self.admit_seq = -1
        self.stop_tokens = frozenset(int(t) for t in (stop_tokens or ()))
        self.want_logprobs = logprobs
        self.logprobs_out: List[float] = []
        self.deadline = deadline   # absolute monotonic expiry or None
        # speculative decode lane state (the draft's second page table)
        self.draft_pages: List[int] = []  # draft KV page ids (never shared)
        self.draft_len = 0         # context positions the draft KV covers
        self.spec_enabled = True   # False: plain blocks (a verify trip
        #                            degrades for the rest of the request;
        #                            an acceptance-EWMA degrade is transient
        #                            — see spec_probe_in)
        self.spec_probe_in = None  # plain dispatches until the next probe
        #                            block re-tries speculation (None: no
        #                            probe scheduled)
        self.spec_probing = False  # the next/current spec dispatch is a
        #                            probe: its acceptance decides recovery
        self.spec_ewma = 1.0       # rolling acceptance (optimistic start)
        self.spec_drafted = 0      # draft proposals verified for this lane
        self.spec_accepted = 0     # of those, emitted (accepted) ones
        # ragged plan: multi-round chunked-prefill state
        self.pf_started = False
        self.pf_digests = None
        self.pf_shared = 0
        # host KV tier: the snapshot a resume restores (a preemption's or a
        # shipped one), and the disagg export key
        self.kv_handle = None
        self.export_digest: Optional[bytes] = None
        # a resume in progress: its start and kind ("swap_in" or
        # "re_prefill"), read at the next emitted token
        self.t_resume0: Optional[float] = None
        self.resume_kind: Optional[str] = None
        # request-lifecycle telemetry (trace spans, flight recorder)
        self.trace_id = trace_id
        #: flight-recorder / debugz attribution only (never scheduled on)
        self.tenant = tenant
        self.lane = -1             # last lane held (-1: never admitted)
        #: flight-recorder detail (None: recorder disarmed)
        self.fl: Optional[dict] = None
        self.pf_t0: Optional[float] = None    # this prefill's start
        self.t_submit = _time.perf_counter()
        self.t_prefill0: Optional[float] = None  # first prefill start
        self.t_first: Optional[float] = None     # first emitted token
        self.t_last: Optional[float] = None      # latest emitted token
        self.chunk_t0: Optional[float] = None    # open decode-chunk start
        self.chunk_start = 0                     # its first token index

    def finished(self) -> bool:
        """steps exhausted, or the last emitted token is a stop token."""
        return bool(self.tokens_out) and (
            len(self.tokens_out) >= self.steps
            or self.tokens_out[-1] in self.stop_tokens)


def _prefill_attention(prefill_flash: Optional[bool], device_type: str,
                       mesh) -> bool:
    """Whether the split plan's full-prompt forward attends through the
    flash kernel: always on the card (``prefill_flash=False``, plain
    attention there, is refused; under a mesh each rank runs the kernel
    on its own query heads, the function tpulab's dense prefill computes
    under the mesh), dense causal attention by default on the CPU.  An
    explicit ``prefill_flash=True`` under a mesh keeps tpulab's
    refusal."""
    if mesh is not None and prefill_flash:
        raise ValueError(
            "the flash prefill kernel is single-device; mesh serving "
            "prefills through the dense or ragged paths (prefill_flash "
            "must be False or None)")
    if prefill_flash is False and device_type == "cuda":
        raise NotImplementedError(
            "prefill_flash=False (dense prompt attention) is not "
            "carried to tpulab_torch on the card: it would route the "
            "split plan's prompt attention to plain math (ROADMAP, "
            "decisions: prefill_flash=False)")
    if prefill_flash is None:
        return device_type == "cuda"
    return bool(prefill_flash)


def _dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


class ContinuousBatcher:
    """Continuous-batching scheduler over the paged pool.

    ``submit(prompt, steps) -> Future[list[int]]``; a scheduler thread
    advances up to ``lanes`` requests.  Prompts enter by one of two plans:

    - ragged (``ragged=None`` or ``True``): pending prompts and decode
      lanes advance together in fused mixed rounds
      (:func:`paged_mixed_step`);
    - split (``ragged=False``, tpulab's legacy split dispatch, token-exact
      against the ragged plan): each new prompt runs one full-prompt
      forward (:func:`paged_prefill`, flash attention when
      ``prefill_flash`` — always on CUDA, by default off on the CPU), and
      prefix-cache tails and chunks of prompts longer than
      ``prefill_chunk`` run :func:`paged_extend`.

    Decode-only lanes then advance in adaptive K-token blocks
    (:func:`paged_decode_block`, one host sync per block, the next block
    dispatched ahead while the host emits), or K=1 ticks when a
    host-sampled lane is present.  With ``draft_params`` (a draft tree or
    :class:`~tpulab_torch.models.transformer.Transformer` of the target's
    KV geometry, e.g. :func:`~tpulab_torch.models.transformer.
    early_exit_draft`, and ``draft_n_layers``) decode-only batches whose
    lanes are all eligible run speculative blocks instead
    (:func:`paged_speculative_block`), with the same tokens.  Priority
    preemption evicts the weakest lane, which resumes by re-prefilling
    prompt + generated tokens (exact tokens) or, with ``kv_offload``, by
    restoring its KV snapshot from host memory.

    ``params`` is a :class:`~tpulab_torch.models.transformer.Transformer`
    or a tpulab-keyed tree of tensors, float or weight-only int8
    (:func:`~tpulab_torch.models.quantization.quantize_transformer_params`).
    ``kv_dtype`` (``None``: the compute dtype) is the pages' dtype:
    float32, bfloat16, float16, float8_e4m3fn or float8_e5m2, written
    through :func:`to_kv_dtype` and upcast by the kernels as they read.
    ``compute_dtype`` (``None``: bfloat16) is float32, bfloat16 or
    float16 on the card; a CUDA batcher refuses at construction a dtype
    or head dim its kernels are not built for.
    ``device=None`` means the CUDA card (raises without one); tests pass
    ``device="cpu"``.

    ``mesh`` (a ``{"model": M}`` mesh, :func:`~tpulab_torch.parallel.
    make_mesh`; every rank of the axis constructs the batcher with the
    same arguments) serves tensor-parallel: ``params`` is the whole tree
    (cut leaf by leaf before it moves) or a tree of DTensors
    (:func:`~tpulab_torch.engine.sharded.init_transformer_shards`,
    :func:`~tpulab_torch.models.convert.shard_from_numpy`), and the pool
    shards on KV heads.  Rank 0 (``is_coordinator``) takes requests; the
    other ranks replay its operations until its :meth:`shutdown`, and
    their own :meth:`shutdown` waits for that.  Under a mesh ``hbm=`` and
    ``prefill_flash=True`` are refused, as tpulab refuses them.
    """

    #: the marker the Generate RPC dispatches on (streaming via
    #: ``on_token``, sampling, priority, logprobs, disaggregation)
    continuous_batching = True

    #: fused-decode block sizes the adaptive K snaps onto (tpulab's menu;
    #: re-tuning on the card is a later PR)
    BLOCK_K_MENU = (1, 2, 4, 8, 16)
    #: max prefill tokens one mixed round carries per lane (tpulab's cap)
    RAGGED_CHUNK_CAP = 256

    def __init__(self, params, n_heads: int, n_layers: int,
                 pool: Optional[PagedKVPool] = None, lanes: int = 4,
                 max_len: int = 256, page_size: int = 16,
                 n_pages: int = 0, compute_dtype=None, device=None,
                 use_kernel: Optional[bool] = None,
                 n_kv_heads: Optional[int] = None,
                 rope_theta: Optional[float] = None,
                 prefix_cache: bool = False,
                 prefill_chunk: Optional[int] = None,
                 kv_dtype=None,
                 prefill_flash: Optional[bool] = None,
                 trace=None, metrics=None,
                 decode_block: int = 8,
                 kv_offload=None,
                 draft_params=None,
                 draft_n_layers: Optional[int] = None,
                 draft_n_heads: Optional[int] = None,
                 draft_n_kv_heads: Optional[int] = None,
                 spec_accept_floor: float = 0.35,
                 mesh=None, hbm=None, flight=None,
                 ragged: Optional[bool] = None,
                 kv_publish: bool = False):
        compute_dtype = compute_dtype or torch.bfloat16
        if use_kernel is False:
            raise NotImplementedError(
                "use_kernel=False (tpulab's XLA-gather escape hatch of the "
                "split dispatch) is not carried to tpulab_torch: on the "
                "card it would route decode attention to plain math "
                "(ROADMAP, decisions: use_kernel=False); ragged=False "
                "selects the split plan on the kernels")
        if mesh is None and pool is not None:
            mesh = getattr(pool, "mesh", None)   # tpulab: the pool's mesh
        if mesh is not None and hbm is not None:
            # tpulab itself refuses an elastic pool under a mesh (its
            # per-shard grow/shrink accounting is untested)
            raise NotImplementedError(
                "an HBM-arbiter-armed batcher (the HBM economy's elastic "
                "pool) under a mesh is not supported, as in tpulab: serve "
                "the arbiter single-device, or the mesh without an arbiter "
                "(hbm=None)")
        # decided before a mesh is touched (device=None means the card)
        prefill_flash = _prefill_attention(
            prefill_flash,
            (mesh.device_type if mesh is not None
             else pool.device.type if pool is not None
             else torch.device(device or "cuda").type), mesh)
        if mesh is not None and pool is not None and pool.mesh is not mesh:
            raise ValueError("provided pool was built on a different mesh "
                             "than the batcher's")
        # the page dtypes the kernels read
        if kv_dtype is not None and kv_dtype not in KV_CODE:
            raise NotImplementedError(
                f"kv_dtype={_dtype_name(kv_dtype)}: no kernel reads such "
                "pages; pages store float32, bfloat16, float16, "
                "float8_e4m3fn or float8_e5m2")
        # pages may store a NARROWER dtype than the compute path: writes
        # round on scatter (to_kv_dtype), the kernels upcast as they read,
        # and attention math stays f32
        kv_dtype = kv_dtype or compute_dtype
        if (pool is not None and kv_dtype != compute_dtype
                and pool.dtype != kv_dtype):
            raise ValueError(
                f"kv_dtype={_dtype_name(kv_dtype)} conflicts with the "
                f"provided pool's dtype {_dtype_name(pool.dtype)}")
        tree = _tree(params)
        if decode_block < 1:
            raise ValueError("decode_block must be >= 1")
        n_kv = n_kv_heads or n_heads
        #: the ``{"model": M}`` mesh this batcher serves over (None: one
        #: device); ``tp`` its axis and Megatron operators
        self.mesh = mesh
        self.tp = None
        if mesh is not None:
            from tpulab_torch.engine.sharded import (check_head_split,
                                                     mesh_device)
            from tpulab_torch.parallel.tensor_parallel import TensorParallel
            self.tp = TensorParallel(mesh)
            check_head_split(n_heads, n_kv, self.tp.size)
            if device is not None and resolve_device(device) != \
                    mesh_device(mesh):
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh_device(mesh)}")
            device = mesh_device(mesh)
        self.device = (pool.device if pool is not None
                       else resolve_device(device))
        if self.device.type == "cuda":
            check_built(compute_dtype, kv_dtype,
                        weight_shape(tree["layer0"]["wqkv"])[0] // n_heads)
        self.lanes = lanes
        self.max_len = max_len
        self.page_size = page_size
        self.max_pages = (max_len + page_size - 1) // page_size
        d_model = weight_shape(tree["layer0"]["wqkv"])[0]
        self.vocab = int(tree["embed"].shape[0])
        if draft_params is not None:
            dtree = _tree(draft_params)
            dl = draft_n_layers or n_layers
            dh = draft_n_heads or n_heads
            dkv = draft_n_kv_heads or (n_kv if draft_n_heads is None else dh)
            if (weight_shape(dtree["layer0"]["wqkv"])[0] // dh
                    != d_model // n_heads
                    or dkv != n_kv):
                raise ValueError(
                    "draft model KV geometry (head_dim, n_kv_heads) must "
                    "match the target's — both write the shared paged pool")
            if dl > n_layers:
                raise ValueError("draft_n_layers must be <= n_layers (the "
                                 "draft shares the pool's layer axis)")
            if self.tp is not None:
                check_head_split(dh, dkv, self.tp.size)
        self._owns_pool = pool is None
        self.pool = pool or PagedKVPool(
            n_pages or self.max_pages * lanes + 1, page_size, n_layers,
            n_kv, d_model // n_heads, kv_dtype, self.device, mesh=mesh)
        #: rank 0 of the mesh's ``model`` axis (or no mesh): this rank
        #: schedules and takes ``submit``; a follower replays its device
        #: operations (engine/sharded.py)
        self.is_coordinator = self.pool.coordinator
        # the HBM economy (tpulab_torch.hbm): with an arbiter the batcher
        # is the KV TENANT — the page store becomes elastic (a KV burst
        # wins bytes from cold models through the arbiter's pressure
        # protocol; a hot model's acquire squeezes idle KV down to the
        # host tier), and every program records its scratch with the
        # ledger.  Set before the programs are built so scratch measuring
        # can wrap them.
        self.hbm = hbm
        #: the programs' one scratch claim (a ScratchGroup; None without
        #: scratch measuring)
        self.scratch = None
        self._hbm_reclaim_bytes = 0  # outstanding arbiter reclaim target
        self.hbm_grows = 0           # pool grow ops granted by the arbiter
        self.hbm_shrinks = 0         # pool shrink ops under pressure
        self.hbm_demotions = 0       # lanes demoted (preempted) by pressure
        #: elastic pool sizes snap to a geometric ladder off the initial
        #: size (n0, 2*n0, 4*n0, ...): tpulab bounds its compiled shapes so;
        #: the port keeps the ladder, so both packages resize alike
        self._hbm_pool_base = self.pool.n_pages
        self._hbm_starved_passes = 0  # hold-and-wait breaker streak
        if hbm is not None:
            self.pool.prefer_low_pages = True
        from tpulab_torch.modelstore.host_store import tree_nbytes
        #: the served tree's bytes, every rank's shards together (tpulab's
        #: ``tree_nbytes`` of its global arrays)
        self.tree_bytes = tree_nbytes(tree)
        #: the weights; ``None`` while a
        #: :class:`~tpulab_torch.modelstore.BatcherAdapter` has them
        #: swapped out (the batcher must be idle then)
        #: under a mesh: this rank's Megatron shards only
        self.params = self._place(tree)
        #: a follower's host copy of its shards while its coordinator's
        #: adapter has the weights swapped out (:meth:`_op_weights_out`)
        self._host_params = None
        self.n_layers = n_layers
        self._step_kw = dict(n_heads=n_heads, n_layers=n_layers,
                             compute_dtype=compute_dtype,
                             n_kv_heads=n_kv, rope_theta=rope_theta,
                             tensor_parallel=self.tp)
        #: dispatch plan: fused mixed rounds (ragged) or per-prompt prefill
        #: forwards then decode (split)
        self.ragged = True if ragged is None else bool(ragged)
        #: the split plan's full-prompt forward attends through the flash
        #: kernel; a failure there fails the requests (the scheduler's
        #: recovery path) and leaves this as set
        self.prefill_flash = prefill_flash
        self._prefill = self._program(self._build_prefill(
            self.prefill_flash))
        self._extend = self._program(functools.partial(paged_extend,
                                                       **self._step_kw))
        self._mixed_step = self._program(functools.partial(
            paged_mixed_step, **self._step_kw))
        self._decode_block = self._program(functools.partial(
            paged_decode_block, **self._step_kw))
        self._decode_step = self._program(functools.partial(
            paged_decode_step, **self._step_kw))
        # -- speculative decoding: a draft model riding the SAME pool
        #    through a second per-lane page table.  ``draft_params`` arms
        #    it: each dispatch drafts K tokens per lane, verifies them in
        #    one target forward and emits up to K+1 accepted tokens,
        #    exactly the non-speculative stream (greedy and device
        #    sampled).  Host-sampled lanes never speculate; a lane whose
        #    acceptance EWMA falls under ``spec_accept_floor`` degrades to
        #    plain blocks (with periodic probes), a verify trip for the
        #    rest of its request.
        self._spec: Optional[Dict[str, Any]] = None
        self.spec_accept_floor = float(spec_accept_floor)
        self.spec_dispatches = 0        # speculative decode dispatches
        self.spec_fallbacks = 0         # lanes degraded to plain blocks
        self.spec_draft_prefills = 0    # draft-table warm-up forwards
        self.spec_tokens_drafted = 0    # proposals verified by the target
        self.spec_tokens_accepted = 0   # of those, emitted (accepted)
        self.spec_probes = 0            # probe blocks re-trying a lane
        self.spec_probe_recoveries = 0  # probes whose lane stayed
        #                                 speculative
        #: draft forwards (K+1 per speculative dispatch, one per warm-up):
        #: the ragged kernel runs ``draft_n_layers`` times in each
        self.draft_forward_steps = 0
        if draft_params is not None:
            self._spec = {"params": self._place(dtree)}
            self._spec_kw = dict(n_heads=n_heads, n_layers=n_layers,
                                 draft_n_heads=dh, draft_n_layers=dl,
                                 compute_dtype=compute_dtype,
                                 n_kv_heads=n_kv, draft_n_kv_heads=dkv,
                                 rope_theta=rope_theta,
                                 tensor_parallel=self.tp)
            # one program for every K (PyTorch runs eagerly: nothing to
            # compile per draft length)
            self._spec_block = self._program(functools.partial(
                paged_speculative_block, **self._spec_kw), skip=(0, 1, 2))
            # draft-table warm-up: one draft forward over whatever context
            # tail the second table is missing (never synced)
            self._draft_extend = self._program(functools.partial(
                paged_extend, n_heads=dh, n_layers=dl,
                compute_dtype=compute_dtype, n_kv_heads=dkv,
                rope_theta=rope_theta, tensor_parallel=self.tp))
        self.decode_block = min(int(decode_block), self.BLOCK_K_MENU[-1])
        self._pending_block: Optional[Dict[str, Any]] = None
        #: the last decode block's device carry and sampling state, which
        #: a dispatched-ahead block chains from (kept on every rank)
        self._chain = None
        self._step_ewma_s = 0.0
        # -- dispatch/sync accounting ------------------------------------
        self.decode_dispatches = 0   # device dispatches (mixed + decode)
        self.decode_host_syncs = 0   # blocking device->host decode fetches
        #: prompt fills of the split plan (one per prompt, chunked or not;
        #: stays 0 under the ragged plan — prompts ride mixed rounds)
        self.prefill_dispatches = 0
        self.ragged_dispatches = 0   # dispatches through the kernel family
        self.dispatch_kinds: Dict[str, int] = {"decode": 0, "verify": 0,
                                               "mixed": 0}
        #: forwards whose attention is the ragged kernel family (1 per
        #: mixed round, K=1 tick or extend chunk, K per block): the kernel
        #: runs ``n_layers`` times in each
        self.forward_steps = 0
        #: full-prompt forwards of the split plan (:func:`paged_prefill`):
        #: with ``prefill_flash`` the flash kernel runs ``n_layers`` times
        #: in each
        self.prefill_forwards = 0
        #: prompt fills under either plan: a first prefill or the
        #: re-prefill of a resume (the split plan's ``prefill_dispatches``;
        #: under the ragged plan, the prompts that start their mixed
        #: rounds).  A resume restored from the host tier adds nothing.
        self.prompt_fills = 0
        self.prefix_cache = PrefixCache(self.pool) if prefix_cache else None
        # the host KV tier: None/False = off; True = a manager with the
        # default host budget; an int = budget bytes; a KVOffloadManager =
        # bring your own (shared store / transfer engine).  On, a
        # preemption swaps the lane's KV to host memory and its resume
        # swaps it back (no re-prefill), and prefix-cache eviction demotes
        # to / promotes from the host tier.
        self._owns_offload = False
        if (kv_offload is None or kv_offload is False
                or not self.is_coordinator):
            # followers replay the tier's gathers and scatters through
            # the pool; the host tier itself is the coordinator's
            self.kv_offload = None
        else:
            from tpulab_torch.kvcache import (DEFAULT_HOST_BUDGET,
                                              KVOffloadManager)
            if isinstance(kv_offload, KVOffloadManager):
                self.kv_offload = kv_offload
            else:
                budget = (DEFAULT_HOST_BUDGET if kv_offload is True
                          else int(kv_offload))
                self.kv_offload = KVOffloadManager(self.pool, budget)
                self._owns_offload = True
        if self.kv_offload is not None and self.prefix_cache is not None:
            self.prefix_cache.on_evict = self._demote_prefix
            self.prefix_cache.promote_fn = self._promote_prefix
        # fleet KV fabric publish (tpulab_torch.kvfabric): finished FIRST
        # prefills export their prompt-only KV to the host tier under
        # ("fab", content_digest) — the same write-behind swap_out
        # preemption uses — plus the prefill's last-position logits row
        # under ("fablog", digest), so a FetchKV RPC can serve both to
        # the digest's routed-astray fetchers without evicting this
        # replica's own copy.  Requires kv_offload (the host tier IS the
        # export buffer).  Publishes ride the split plan's prefill only:
        # the ragged plan's mixed rounds never fetch a host-visible
        # logits row (tpulab's documented limitation).
        if kv_publish and (kv_offload is None or kv_offload is False):
            raise ValueError("kv_publish requires kv_offload")
        self.kv_publish = bool(kv_publish)
        self._fab_handles: "OrderedDict[bytes, Any]" = OrderedDict()
        self._fab_lock = threading.Lock()
        self.kv_publishes = 0  # prompt snapshots exported to the fabric
        #: rolling prefill throughput (tokens/s, EWMA) — the fabric's
        #: cost gate weighs a remote fetch's wire time against simply
        #: recomputing the prompt here (0.0 until the first prefill)
        self.prefill_ewma_tok_s = 0.0
        if prefill_chunk is not None:
            if prefill_chunk < page_size:
                raise ValueError("prefill_chunk must be >= page_size")
            prefill_chunk -= prefill_chunk % page_size
        self.prefill_chunk = prefill_chunk
        #: optional :class:`~tpulab_torch.utils.tracing.ChromeTraceRecorder`:
        #: queue / prefill / decode-chunk / swap spans per request on the
        #: lane's row, and the ``decode_block`` counter per fused dispatch
        self.trace = trace
        #: optional metrics sink (:class:`~tpulab_torch.utils.metrics.
        #: GenerationMetrics`): TTFT / inter-token / queue-wait / e2e
        #: observed per request at the source
        self.metrics = metrics
        #: optional :class:`~tpulab_torch.obs.FlightRecorder`: one wide
        #: event per request; completion attaches the engine's summary to
        #: the future as ``_tpulab_flight`` (requests whose event the RPC
        #: layer assembles, ``flight_owner="rpc"``, are not recorded
        #: twice).  The recorder observes and never steers.
        self.flight = flight
        #: the Debug RPC's on-demand ``torch.profiler`` capture
        #: (:meth:`arm_profile`), driven by the scheduler thread only
        self._profile: Optional[Dict[str, Any]] = None
        #: the last finished capture: its directory, the forward steps
        #: (and draft forward steps) it covered, or the error that ended it
        self.last_profile: Optional[Dict[str, Any]] = None
        #: seconds the last :meth:`debug_state` held the scheduler lock
        self.debug_lock_hold_s = 0.0
        self._queue: List[_PagedRequest] = []
        self._requests: Dict[Future, _PagedRequest] = {}
        self._active: List[Optional[_PagedRequest]] = [None] * lanes
        self._admit_counter = 0
        self.preemptions = 0
        #: preemptions whose victim was a batch-class lane
        self.batch_preemptions = 0
        if self.hbm is not None:
            # register as the KV tenant AFTER kv_offload is settled (the
            # reclaimable estimate reads it) and claim the page store's
            # tracked bytes — the ledger now mirrors the allocator gauge
            from tpulab_torch.hbm import KV_TENANT
            self.hbm.register(KV_TENANT, reclaim=self._hbm_reclaim,
                              reclaimable=self._hbm_reclaimable,
                              gauge=lambda: self.pool.hbm_bytes)
            self.hbm.mirror_claim(KV_TENANT, "pool", self.pool.hbm_bytes)
        self.completed_requests = 0
        self.tokens_generated = 0
        self._cv = threading.Condition()
        self._shutdown = False
        self._thread = threading.Thread(
            target=self._run if self.is_coordinator else self._follow,
            name="cbatch" if self.is_coordinator else "cbatch-follower",
            daemon=True)
        self._thread.start()

    # -- public -------------------------------------------------------------
    def submit(self, prompt, steps: int, on_token=None,
               sampling: Optional[SamplingParams] = None,
               priority: int = 0, stop_tokens=None,
               logprobs: bool = False, deadline=None,
               export_digest: Optional[bytes] = None,
               trace_id: Optional[str] = None,
               tenant: Optional[str] = None,
               flight_owner: Optional[str] = None,
               request_class: str = "online") -> Future:
        """Queue one generation request (tpulab's contract).

        ``on_token(token, index)`` streams tokens (``(token, index,
        logprob)`` with ``logprobs=True``, which also resolves the future
        to ``(tokens, logprobs)``); ``stop_tokens`` end generation with
        the stop token emitted last; ``priority`` orders admission and
        arms preemption; ``deadline`` (a Deadline or seconds) bounds the
        request.  ``export_digest`` (requires ``kv_offload``) snapshots
        the finished request's KV to the host tier under ``("ship",
        digest)`` when its lane is released — the prefill-replica half of
        disaggregated serving: submit with ``steps=1`` and the snapshot
        covers exactly the prompt.  The export
        :class:`~tpulab_torch.kvcache.SwapHandle` lands on the future as
        ``_tpulab_kv_export`` (tpulab's name; None when the swap
        degraded) before it resolves.

        ``trace_id`` tags the request's spans in the attached ``trace``
        recorder; ``tenant`` tags it for flight-recorder and debugz
        attribution; ``flight_owner="rpc"`` marks the wide event as
        assembled by the RPC layer (the engine still attaches its summary
        to the future as ``_tpulab_flight`` but records nothing).

        ``request_class`` is ``"online"`` (the default) or ``"batch"``, the
        offline batch lane: a batch request queues behind every online
        request whatever its priority, is the first preemption victim when
        an online arrival needs its lane or pages, and its ``on_token``
        hook (a checkpoint sink, not an interactive consumer) never
        shrinks the fused-decode block."""
        if request_class not in ("online", "", "batch"):
            raise ValueError(f"unknown request_class {request_class!r} "
                             "(want 'online' or 'batch')")
        self._check_coordinator("submit")
        deadline = self._check_request(prompt, steps, deadline)
        if export_digest is not None and self.kv_offload is None:
            raise ValueError("export_digest requires kv_offload")
        req = _PagedRequest(prompt, steps, on_token=on_token,
                            sampling=sampling, priority=priority,
                            stop_tokens=stop_tokens, logprobs=logprobs,
                            deadline=deadline, trace_id=trace_id,
                            tenant=tenant, batch=request_class == "batch")
        req.export_digest = export_digest
        if self.flight is not None or flight_owner:
            self._fl_arm(req, flight_owner)
        with self._cv:
            if self._shutdown:
                raise RuntimeError("ContinuousBatcher is shut down")
            self._enqueue_locked(req, front_of_class=False)
            self._requests[req.future] = req
            self._cv.notify()
        return req.future

    def _check_coordinator(self, what: str) -> None:
        if not self.is_coordinator:
            raise RuntimeError(
                f"{what} on a follower rank: rank 0 of the mesh's 'model' "
                "axis schedules and takes requests")
        if self.pool.channel is not None:
            self.pool.channel.check()

    def _check_request(self, prompt, steps: int, deadline):
        """Reject a malformed request at the host boundary; returns the
        deadline as an absolute monotonic time (or None)."""
        flat = np.asarray(prompt).reshape(-1)
        if isinstance(deadline, Deadline):
            deadline = deadline.expiry
        elif deadline is not None:
            deadline = _time.monotonic() + float(deadline)
        if len(flat) == 0:
            raise ValueError("empty prompt")
        if steps < 1:
            raise ValueError("steps must be >= 1")
        if len(flat) + steps > self.max_len:
            raise ValueError(f"prompt+steps exceeds max_len {self.max_len}")
        if flat.min() < 0 or flat.max() >= self.vocab:
            # an out-of-range id would fault the embedding gather on the
            # card; reject at the host boundary
            raise ValueError(f"prompt token ids outside [0, {self.vocab})")
        return deadline

    def submit_shipped(self, prompt, steps: int, first_token: int, handle,
                       on_token=None,
                       sampling: Optional[SamplingParams] = None,
                       priority: int = 0, stop_tokens=None,
                       deadline=None, trace_id: Optional[str] = None,
                       tenant: Optional[str] = None,
                       flight_owner: Optional[str] = None) -> Future:
        """Admit a request whose prompt KV arrived SHIPPED from a prefill
        replica — the decode-replica half of disaggregated serving
        (tpulab's contract).

        ``handle`` is the resident host-tier snapshot a
        :class:`~tpulab_torch.disagg.KVShipper` import minted (None = the
        shipment was lost: the request still admits and prefills
        locally), and ``first_token`` the prefill replica's index-0 pick,
        emitted to ``on_token`` here so the stream the consumer sees is a
        unified replica's.  Admission restores the snapshot through
        ``KVOffloadManager.restore``: the lane starts decoding with ZERO
        prefill dispatches.  Every degraded shipment (lost, corrupt,
        chaos-tripped, budget-refused, restore failure) falls back to the
        exact local prefill, which recomputes the same KV.

        Host-sampled requests (``temperature > 0`` without device
        sampling) are rejected: their PRNG stream is keyed by draw order,
        which does not survive the replica hop; greedy and device-sampled
        streams are keyed by (seed, position) and do."""
        self._check_coordinator("submit_shipped")
        deadline = self._check_request(prompt, steps, deadline)
        n_prompt = np.asarray(prompt).size
        if not 0 <= int(first_token) < self.vocab:
            raise ValueError(
                f"shipped first token outside [0, {self.vocab})")
        sp = sampling or SamplingParams()
        if sp.temperature > 0.0 and not sp.device:
            raise ValueError(
                "shipped-KV admission requires greedy or device sampling "
                "(host-side PRNG streams do not survive the replica hop)")
        if handle is not None and self.kv_offload is None:
            raise ValueError("shipped-KV admission requires kv_offload")
        if handle is not None and handle.length != n_prompt:
            raise ValueError(
                f"shipment covers {handle.length} positions, prompt has "
                f"{n_prompt}")
        req = _PagedRequest(prompt, steps, on_token=on_token, sampling=sp,
                            priority=priority, stop_tokens=stop_tokens,
                            deadline=deadline, trace_id=trace_id,
                            tenant=tenant)
        if self.flight is not None or flight_owner:
            self._fl_arm(req, flight_owner)
        # the first-token pick happened on the prefill replica: seed the
        # lane as a resume (a degraded restore then re-prefills and
        # DISCARDS its pick, exactly like a preemption resume)
        req.tokens_out.append(int(first_token))
        req.kv_handle = handle
        req.resumed = True
        self._emit(req, int(first_token), 0, None)
        with self._cv:
            self.tokens_generated += 1
            if self._shutdown:
                raise RuntimeError("ContinuousBatcher is shut down")
            if not req.finished():
                self._enqueue_locked(req, front_of_class=False)
                self._requests[req.future] = req
                self._cv.notify()
                return req.future
            self._discard_handle(req)
            self.completed_requests += 1
        # steps == 1, or the first token is a stop token
        self._flight_complete(req)
        req.future.set_result(self._result_of(req))
        return req.future

    def cancel(self, future: Future) -> None:
        """Abort a submitted request (freed at the next tick boundary)."""
        with self._cv:
            req = self._requests.get(future)
            if req is not None:
                req.cancelled = True
                if req in self._queue:  # never started: finish immediately
                    self._queue.remove(req)
                    self._requests.pop(future, None)
                    self._discard_handle(req)
        if req is not None and req not in self._active and not future.done():
            future.cancel()

    def shutdown(self) -> None:
        """Finish the queued and active requests, then stop.  Under a mesh
        the coordinator's shutdown then ends every follower's replay; a
        follower's returns when that has happened."""
        with self._cv:
            self._shutdown = True
            self._cv.notify()
        self._thread.join(timeout=30 if self.is_coordinator else None)
        if self.is_coordinator and not self._thread.is_alive():
            self.pool.stop_followers()
        if not self._thread.is_alive() and self.prefix_cache is not None:
            self.prefix_cache.on_evict = None  # shutdown clear != pressure
            self.prefix_cache.clear()
        if self._owns_offload and not self._thread.is_alive():
            self.kv_offload.close()  # settle write-behind, free the tier
        if self._owns_pool and not self._thread.is_alive():
            self.pool.close()
            if self.hbm is not None:
                from tpulab_torch.hbm import KV_TENANT
                self.hbm.release(KV_TENANT, "pool")
        if self.scratch is not None and not self._thread.is_alive():
            self.scratch.release()

    @property
    def active_lanes(self) -> int:
        with self._cv:
            return sum(r is not None for r in self._active)

    @property
    def queued_requests(self) -> int:
        with self._cv:
            return len(self._queue)

    @property
    def spec_acceptance(self) -> float:
        """Lifetime draft acceptance rate (accepted / drafted)."""
        return self.spec_tokens_accepted / max(1, self.spec_tokens_drafted)

    def debug_state(self) -> Dict[str, Any]:
        """Live scheduler introspection (one snapshot under the scheduler
        lock): lanes, queue, the elastic pool and its ladder position,
        dispatch counters, speculation and prefix-cache state (tpulab's
        keys where the port has the field)."""
        now = _time.perf_counter()
        with self._cv:
            t_lock = _time.perf_counter()
            lanes = []
            for lane, req in enumerate(self._active):
                if req is None:
                    lanes.append({"lane": lane, "state": "idle"})
                    continue
                lanes.append({
                    "lane": lane,
                    "state": "prefill" if req.pending_prompt else "decode",
                    "request_class": "batch" if req.batch else "online",
                    "tenant": req.tenant, "priority": req.priority,
                    "trace_id": req.trace_id,
                    "age_s": round(now - req.t_submit, 6),
                    "tokens": len(req.tokens_out), "steps": req.steps,
                    "prompt_tokens": int(len(req.prompt)),
                    "pages": len(req.pages),
                    "draft_pages": len(req.draft_pages),
                    "cancelled": req.cancelled})
            queue_head = [{"tenant": q.tenant, "priority": q.priority,
                           "age_s": round(now - q.t_submit, 6),
                           "prompt_tokens": int(len(q.prompt)),
                           "steps": q.steps} for q in self._queue[:16]]
            queued = len(self._queue)
            profile_armed = self._profile is not None
            self.debug_lock_hold_s = _time.perf_counter() - t_lock
        pool = self.pool
        rung, size = 0, self._hbm_pool_base
        while size and size * 2 <= pool.n_pages:
            size *= 2
            rung += 1
        out: Dict[str, Any] = {
            "kind": "paged",
            "lanes": lanes,
            "queued_requests": queued,
            "queue_head": queue_head,
            "pool": {"n_pages": pool.n_pages,
                     "free_pages": pool.free_pages,
                     "page_size": pool.page_size,
                     "page_nbytes": pool.page_nbytes,
                     "hbm_bytes": pool.hbm_bytes,
                     "elastic": self.hbm is not None,
                     "ladder_base": self._hbm_pool_base,
                     "ladder_rung": rung,
                     "grows": self.hbm_grows,
                     "shrinks": self.hbm_shrinks},
            "dispatch": {"decode_block": self.decode_block,
                         "decode_dispatches": self.decode_dispatches,
                         "decode_host_syncs": self.decode_host_syncs,
                         "prefill_dispatches": self.prefill_dispatches,
                         "ragged": self.ragged,
                         "ragged_dispatches": self.ragged_dispatches,
                         "kinds": dict(self.dispatch_kinds),
                         "preemptions": self.preemptions,
                         "batch_preemptions": self.batch_preemptions,
                         "forward_steps": self.forward_steps,
                         "draft_forward_steps": self.draft_forward_steps,
                         "completed_requests": self.completed_requests,
                         "tokens_generated": self.tokens_generated},
            "profile_armed": profile_armed,
        }
        if self.hbm is not None:
            out["hbm_pressure_events"] = self.hbm.pressure_events
        if self._spec is not None:
            out["spec"] = {"dispatches": self.spec_dispatches,
                           "fallbacks": self.spec_fallbacks,
                           "tokens_drafted": self.spec_tokens_drafted,
                           "tokens_accepted": self.spec_tokens_accepted,
                           "acceptance": round(self.spec_acceptance, 4),
                           "probes": self.spec_probes,
                           "probe_recoveries": self.spec_probe_recoveries}
        pc = self.prefix_cache
        if pc is not None:
            out["prefix_cache"] = {"entries": len(pc), "hits": pc.hits,
                                   "misses": pc.misses,
                                   "host_promotions": pc.host_promotions}
        return out

    @property
    def admission_cost_factor(self) -> float:
        """Cost multiplier an admission frontend applies to this engine's
        requests: a speculative request holds a second page table and
        burns draft and verify compute on rejected proposals."""
        return 2.0 if self._spec is not None else 1.0

    # -- telemetry (no-ops without a recorder or metrics sink) ---------------
    #: decode tokens per trace span when tokens arrive one a dispatch (a
    #: fused block closes its own span)
    TRACE_DECODE_CHUNK = 8

    def _span(self, name: str, lane: int, t0: float, dur: float,
              req: _PagedRequest, **extra) -> None:
        """One request-lifecycle span on the lane's trace row."""
        tr = self.trace
        if tr is None:
            return
        if req.trace_id:
            extra["trace_id"] = req.trace_id
        tr.add_span(name, t0, dur, tid=lane, lane=lane, **extra)

    def _flush_decode_chunk(self, req: _PagedRequest, lane: int,
                            now: float, **extra) -> None:
        """Close the open decode-chunk span at ``now`` and start the next
        (a K-block passes ``block=K``: block-sized decode spans)."""
        n = len(req.tokens_out)
        if req.chunk_t0 is not None and n > req.chunk_start:
            self._span("decode", lane, req.chunk_t0, now - req.chunk_t0,
                       req, first=req.chunk_start,
                       tokens=n - req.chunk_start, **extra)
        req.chunk_t0 = now
        req.chunk_start = n

    #: per-request detail lists stay bounded: a pathological request must
    #: not turn its own wide event into a leak
    FLIGHT_DETAIL_CAP = 1024

    @staticmethod
    def _fl_arm(req: _PagedRequest, owner: Optional[str]) -> None:
        """Attach the per-request flight detail (armed path only)."""
        req.fl = {"owner": owner, "blocks": [], "itl": [],
                  "swap_outs": 0, "swap_ins": 0, "preempts": 0,
                  "pages_peak": 0, "chaos0": chaos.fired_snapshot()}

    def _fl_block(self, req: _PagedRequest, k: int, n: int,
                  dt: Optional[float]) -> None:
        """One decode dispatch's part of the wide event: block size K,
        tokens emitted, the per-token latency spread over them."""
        fl = req.fl
        if fl is None:
            return
        if len(fl["blocks"]) < self.FLIGHT_DETAIL_CAP:
            fl["blocks"].append((k, n))
        if dt is not None and len(fl["itl"]) < self.FLIGHT_DETAIL_CAP:
            fl["itl"].append((dt, n))
        pages = len(req.pages) + len(req.draft_pages)
        if pages > fl["pages_peak"]:
            fl["pages_peak"] = pages

    def _fl_pages(self, req: _PagedRequest) -> None:
        fl = req.fl
        if fl is not None:
            pages = len(req.pages) + len(req.draft_pages)
            if pages > fl["pages_peak"]:
                fl["pages_peak"] = pages

    def _flight_summary(self, req: _PagedRequest,
                        outcome: str) -> Dict[str, Any]:
        """The engine's half of the wide event (tpulab's fields; the RPC
        layer adds admission, status and transport fields)."""
        now = _time.perf_counter()
        ev: Dict[str, Any] = {
            "kind": "paged", "outcome": outcome, "tenant": req.tenant,
            "request_class": "batch" if req.batch else "online",
            "priority": req.priority, "trace_id": req.trace_id,
            "prompt_tokens": int(len(req.prompt)), "steps": req.steps,
            "tokens": len(req.tokens_out),
            "t_submit": req.t_submit, "t_prefill0": req.t_prefill0,
            "t_first": req.t_first, "t_last": req.t_last,
            "e2e_s": now - req.t_submit, "lane": req.lane,
            "pages": len(req.pages),
        }
        if req.t_prefill0 is not None:
            ev["queue_wait_s"] = req.t_prefill0 - req.t_submit
        if req.t_first is not None:
            ev["ttft_s"] = req.t_first - req.t_submit
        if req.spec_drafted:
            ev["spec_drafted"] = req.spec_drafted
            ev["spec_accepted"] = req.spec_accepted
            ev["spec_acceptance"] = round(
                req.spec_accepted / req.spec_drafted, 4)
        fl = req.fl
        if fl is not None:
            ev["pages_peak"] = max(fl["pages_peak"], len(req.pages))
            ev["block_ks"] = [k for k, _n in fl["blocks"]]
            ev["preempts"] = fl["preempts"]
            ev["swap_outs"] = fl["swap_outs"]
            ev["swap_ins"] = fl["swap_ins"]
            if fl["itl"]:
                itl = np.repeat([d for d, _ in fl["itl"]],
                                [n for _, n in fl["itl"]])
                ev["itl_ms"] = {
                    "p50": round(float(np.percentile(itl, 50)) * 1e3, 4),
                    "p99": round(float(np.percentile(itl, 99)) * 1e3, 4),
                    "max": round(float(itl.max()) * 1e3, 4),
                    "n": int(itl.size)}
            trips = {}
            for point, n in chaos.fired_snapshot().items():
                d = n - fl["chaos0"].get(point, 0)
                if d > 0:
                    trips[point] = d
            if trips:
                ev["chaos_trips"] = trips
        if self.hbm is not None:
            ev["hbm_pressure_events"] = self.hbm.pressure_events
        return ev

    def _flight_complete(self, req: _PagedRequest,
                         outcome: str = "SUCCESS") -> None:
        """Completion hook at every future-resolution site: attach the
        engine summary to the future BEFORE it resolves and record it,
        unless the RPC layer owns this request's wide event."""
        fr = self.flight
        if fr is None and req.fl is None:
            return
        ev = self._flight_summary(req, outcome)
        req.future._tpulab_flight = ev
        owner = req.fl.get("owner") if req.fl is not None else None
        if fr is not None and owner != "rpc":
            fr.observe(ev)

    # -- debugz: the on-demand profiler capture -------------------------------
    def arm_profile(self, ticks: int, log_dir: Optional[str] = None) -> str:
        """Arm ``torch.profiler`` around the next ``ticks`` scheduler
        passes (the Debug RPC's ``profile_ticks``).  The capture starts at
        the next pass the scheduler thread runs and stops after ``ticks``
        passes, CPU and (on a CUDA batcher) CUDA activity, and exports a
        Chrome trace as ``trace.json`` into the returned directory.  The
        forward steps it covered land in :attr:`last_profile`.

        One capture runs per process (:func:`tpulab_torch.utils.tracing.
        claim_profiler`): arming while this batcher or any other profiler
        session, on any thread, holds it raises RuntimeError, and a CUDA
        batcher whose torch cannot trace CUDA activity raises rather than
        capture the CPU alone.  A CUDA capture that covered forward steps
        but holds no device event sets ``last_profile["error"]``."""
        from tpulab_torch.utils import tracing
        if int(ticks) < 1:
            raise ValueError("profile_ticks must be >= 1")
        cuda = self.device.type == "cuda"
        if cuda:
            from torch.profiler import ProfilerActivity
            tracing.cuda_activity_requested([ProfilerActivity.CUDA])
        if log_dir is None:
            import tempfile
            log_dir = tempfile.mkdtemp(prefix="tpulab_torch-profile-")
        owner = ("batcher", id(self))
        with self._cv:
            if self._profile is not None or not tracing.claim_profiler(
                    owner):
                raise RuntimeError("a profiler capture is already armed")
            self._profile = {"remaining": int(ticks), "dir": log_dir,
                             "active": None, "owner": owner, "cuda": cuda}
            self._cv.notify()
        return log_dir

    def _profile_step(self, done: bool = False) -> None:
        """Scheduler-thread capture bookkeeping: start the armed capture,
        count one pass, stop at zero (or at shutdown with ``done``).  The
        forward-step counters are read at the exact start and stop, on
        the thread that dispatches every forward; the stop waits for the
        device first, so a block dispatched inside the window is traced
        whole."""
        prof = self._profile
        if prof is None:
            return
        from tpulab_torch.utils import tracing
        if prof["active"] is None and not done:
            from torch.profiler import ProfilerActivity, profile
            if tracing.profiler_running():   # started after the claim
                self._profile = None
                tracing.release_profiler(prof["owner"])
                self.last_profile = {
                    "dir": prof["dir"], "forward_steps": 0,
                    "draft_forward_steps": 0,
                    "error": "another profiler session started first"}
                _log.error("profiler capture not started: %s",
                           self.last_profile["error"])
                return
            acts = [ProfilerActivity.CPU]
            if prof["cuda"]:
                acts.append(ProfilerActivity.CUDA)
            p = profile(activities=acts)
            p.start()
            prof["active"] = p
            prof["fs0"] = (self.forward_steps, self.draft_forward_steps)
            return  # the NEXT passes are captured; the arming pass is free
        prof["remaining"] -= 1
        if prof["remaining"] > 0 and not done:
            return
        self._profile = None
        p = prof["active"]
        out = {"dir": prof["dir"], "forward_steps": 0,
               "draft_forward_steps": 0}
        try:
            if p is not None:
                if prof["cuda"]:
                    torch.cuda.synchronize(self.device)
                fs0, dfs0 = prof["fs0"]
                out["forward_steps"] = self.forward_steps - fs0
                out["draft_forward_steps"] = (self.draft_forward_steps
                                              - dfs0)
                p.stop()
                path = os.path.join(prof["dir"], "trace.json")
                p.export_chrome_trace(path)
                out["trace"] = path
                out["device_events"] = tracing.device_event_count(p)
                if (prof["cuda"] and not out["device_events"]
                        and out["forward_steps"]
                        + out["draft_forward_steps"]):
                    out["error"] = (
                        f"the capture covered {out['forward_steps']} "
                        "forward steps but traced no CUDA activity")
                    _log.error("profiler capture: %s", out["error"])
        except Exception as e:  # noqa: BLE001 - a capture must not kill
            _log.exception("profiler capture failed")   # the scheduler
            out["error"] = f"{type(e).__name__}: {e}"
        finally:
            tracing.release_profiler(prof["owner"])
            self.last_profile = out

    def _resolve(self, completed: List[_PagedRequest]) -> None:
        for req in completed:
            if not req.future.done():
                self._flight_complete(req)
                req.future.set_result(self._result_of(req))
                self.completed_requests += 1
                if self.metrics is not None:
                    self.metrics.observe_e2e(_time.perf_counter()
                                             - req.t_submit)

    # -- scheduler ----------------------------------------------------------
    @staticmethod
    def _rank(req: _PagedRequest):
        """Scheduling rank ``(class, priority)``: every online request
        outranks every batch request; within a class, priority."""
        return (0 if req.batch else 1, req.priority)

    def _enqueue_locked(self, req: _PagedRequest,
                        front_of_class: bool) -> None:
        """Queue by rank (online before batch, higher priority first, FIFO
        within a class); ``front_of_class`` puts a preempted request ahead
        of its equals."""
        rank = self._rank(req)
        for i, q in enumerate(self._queue):
            if (self._rank(q) < rank
                    or (front_of_class and self._rank(q) == rank)):
                self._queue.insert(i, req)
                return
        self._queue.append(req)

    def _alloc_page(self) -> Optional[int]:
        """Pool page, evicting cold prefix-cache entries under pressure."""
        page = self.pool.allocate_page()
        while (page is None and self.prefix_cache is not None
               and self.prefix_cache.evict_for_alloc()):
            page = self.pool.allocate_page()
        return page

    # -- host KV tier (kv_offload) -------------------------------------------
    def _demote_prefix(self, digest: bytes, page: int) -> None:
        """PrefixCache.on_evict hook: spill the evicted page host-side."""
        self.kv_offload.demote(digest, page, self.pool.kv)

    def _promote_prefix(self, digest: bytes) -> Optional[int]:
        """PrefixCache.promote_fn hook: resurrect a demoted entry into a
        fresh pool page (a plain allocate: promotion must not evict OTHER
        device entries and thrash the cache against itself)."""
        mgr = self.kv_offload
        if not mgr.has_prefix(digest):
            return None
        page = self.pool.allocate_page()
        if page is None:
            return None
        if mgr.promote(digest, page, self.pool.kv) is None:
            self.pool.release_pages([page])
            return None
        return page

    def _try_swap_in(self, req: _PagedRequest, t: int,
                     lane: int) -> Optional[bool]:
        """Restore a resume's host-tier snapshot into freshly allocated
        pages instead of re-prefilling.  ``t`` is the resume length, by
        construction the snapshot's covered positions.  True = restored
        (the lane decodes next); False = page-starved (pages released,
        snapshot kept, retry later); None = the swap degraded (snapshot
        consumed): the caller re-prefills."""
        handle = req.kv_handle
        while len(req.pages) < handle.n_pages:
            page = self._alloc_page()
            if page is None:
                self.pool.release_pages(req.pages)
                req.pages = []
                return False
            req.pages.append(page)
        t0 = _time.perf_counter()
        # the restore writes the pool in place on this thread's stream,
        # ahead of the lane's next forward
        restored = self.kv_offload.restore(handle, req.pages[:handle.n_pages],
                                           self.pool.kv)
        req.kv_handle = None
        if restored is None:
            self.pool.release_pages(req.pages)
            req.pages = []
            return None
        req.length = t
        req.pending_prompt = []
        req.pf_started = False
        req.resumed = False     # the last pick happened before preemption
        req.t_resume0, req.resume_kind = t0, "swap_in"
        now = _time.perf_counter()
        if req.fl is not None:
            req.fl["swap_ins"] += 1
        self._fl_pages(req)
        self._span("swap_in", lane, t0, now - t0, req,
                   pages=handle.n_pages, tokens=t)
        req.chunk_t0 = now        # decode chunks restart here
        req.chunk_start = len(req.tokens_out)
        return True

    def _discard_handle(self, req: _PagedRequest) -> None:
        """Drop a never-to-be-restored snapshot (cancel, expiry, failure)
        so it stops holding host-tier budget."""
        if req.kv_handle is not None:
            if self.kv_offload is not None:
                self.kv_offload.discard(req.kv_handle)
            req.kv_handle = None

    def _admit_to_lane_locked(self, lane: int) -> bool:
        page = self._alloc_page()
        if page is None:
            return False
        req = self._queue.pop(0)
        req.pages.append(page)
        req.admit_seq = self._admit_counter
        self._admit_counter += 1
        req.lane = lane
        self._active[lane] = req
        return True

    def _admit_locked(self) -> None:
        # elastic-regime hold-and-wait breaker (tpulab_torch.hbm): while
        # the scheduler is in a starvation streak WITH live page-holders,
        # feed the pages freed by _hbm_break_hoard_locked to those holders
        # instead of re-admitting; with no holders at all (right after a
        # squeeze emptied every lane) admission must proceed
        if not (self.hbm is not None and self._hbm_starved_passes >= 2
                and any(r is not None for r in self._active)):
            for lane in range(self.lanes):
                if self._active[lane] is None and self._queue:
                    if not self._admit_to_lane_locked(lane):
                        break
        # preemption: while the queue head strictly outranks the weakest
        # active request whose release frees a page, evict it (batch lanes
        # first, then most recently admitted first within a rank) and
        # admit the head
        while self._queue:
            head = self._rank(self._queue[0])
            victims = [(self._rank(req) + (-req.admit_seq, lane))
                       for lane, req in enumerate(self._active)
                       if req is not None and self._rank(req) < head
                       and any(self.pool.refcount(p) == 1
                               for p in req.pages)]
            if not victims:
                return
            lane = min(victims)[-1]
            self._preempt_locked(lane)
            if not self._admit_to_lane_locked(lane):
                return

    def _preempt_locked(self, lane: int) -> None:
        """Evict the lane's request and re-queue it for an exact-token
        resume (re-prefill of prompt + generated, minus the last token).
        With ``kv_offload`` the lane's live pages are first snapshotted to
        the host tier (only the gather is enqueued here, on this stream
        and after any dispatched-ahead block); the resume then restores
        them with no prefill, and the re-prefill is the fallback of a
        degraded swap.  A mid-prompt lane is never snapshotted: its
        partial KV does not match the resume length."""
        req = self._active[lane]
        self._fl_pages(req)
        if req.fl is not None:
            req.fl["preempts"] += 1
        if (self.kv_offload is not None and req.length > 0
                and not req.pending_prompt):
            t_sw0 = _time.perf_counter()
            needed = (req.length + self.page_size - 1) // self.page_size
            req.kv_handle = self.kv_offload.swap_out(
                req.pages[:needed], req.length, self.pool.kv)
            if req.kv_handle is not None:
                if req.fl is not None:
                    req.fl["swap_outs"] += 1
                self._span("swap_out", lane, t_sw0,
                           _time.perf_counter() - t_sw0, req,
                           pages=needed, tokens=req.length)
        self.pool.release_pages(req.pages)
        req.pages = []
        # the draft table is regenerated at resume (one warm-up forward),
        # so its pages go home now
        if req.draft_pages:
            self.pool.release_pages(req.draft_pages)
            req.draft_pages = []
        req.draft_len = 0
        if req.tokens_out:
            req.pending_prompt = (list(req.prompt)
                                  + list(req.tokens_out[:-1]))
            req.resumed = True
        else:
            req.pending_prompt = list(req.prompt)
        req.length = 0
        req.pf_started = False
        self._active[lane] = None
        self._enqueue_locked(req, front_of_class=True)
        self.preemptions += 1
        if req.batch:
            self.batch_preemptions += 1

    # -- HBM economy (tpulab_torch.hbm): the KV tenant ---------------------
    #: bound on how long a blocking grow request waits for a write-behind
    #: model eviction to land (only paid when every lane is starved — the
    #: scheduler had nothing else to do anyway); tpulab's value
    HBM_GROW_TIMEOUT_S = 0.5

    def _page_nbytes(self) -> int:
        return max(1, self.pool.page_nbytes)

    def _hbm_ladder_down(self, total: int) -> int:
        """Largest ladder size (base * 2^k) <= ``total`` (base floor)."""
        size = self._hbm_pool_base
        while size * 2 <= total:
            size *= 2
        return size

    def _hbm_reclaimable(self) -> int:
        """Non-mutating estimate of the KV bytes pressure could free:
        pages already contiguously free at the top of the store, plus idle
        prefix-cache pages, plus live-but-idle lane KV the host tier could
        absorb (demotion needs ``kv_offload``: without the tier a preempted
        lane re-prefills, which frees pages but burns recompute, so it is
        not advertised as cheap headroom)."""
        pages = self.pool.shrinkable_pages()
        if self.prefix_cache is not None:
            pages += len(self.prefix_cache)
        if self.kv_offload is not None:
            with self._cv:
                lane_pages = sum(len(r.pages) for r in self._active
                                 if r is not None)
            pages = pages + min(lane_pages,
                                self.kv_offload.headroom_pages())
        return pages * self._page_nbytes()

    def _hbm_reclaim(self, nbytes: int) -> int:
        """Arbiter pressure hook (foreign thread): record the target and
        wake the scheduler — demotion, preemption and shrink run at the
        next tick boundary, where no dispatched block is in flight.
        Returns the bytes this tenant expects to free (its promise)."""
        est = min(int(nbytes), self._hbm_reclaimable())
        if est <= 0:
            return 0
        with self._cv:
            self._hbm_reclaim_bytes = max(self._hbm_reclaim_bytes,
                                          int(nbytes))
            self._cv.notify()
        return est

    def _service_hbm_locked(self) -> None:
        """Serve an outstanding arbiter reclaim at the tick boundary:
        demote idle prefix-cache KV to the host tier, preempt live-but-idle
        lanes (their KV swaps out through the preemption path, and the
        resumed stream is exact), then shrink the page store's top and
        release the bytes to the ledger.  Only runs with no
        dispatched-ahead block in flight."""
        need = self._hbm_reclaim_bytes
        if not need or self.hbm is None or self._pending_block is not None:
            return
        from tpulab_torch.hbm import KV_TENANT
        pn = self._page_nbytes()
        target = (need + pn - 1) // pn
        # snap the post-shrink total onto the size ladder: free at least
        # the target, landing on the largest ladder size at or below what
        # remains
        target = max(target, self.pool.n_pages
                     - self._hbm_ladder_down(
                         max(1, self.pool.n_pages - target)))
        # 1) idle KV first: cold prefix-cache entries demote for free
        while (self.pool.shrinkable_pages() < target
               and self.prefix_cache is not None
               and self.prefix_cache.evict_for_alloc()):
            pass
        # 2) live-but-idle lanes: preempt coldest-priority, least-progress
        # first — with kv_offload their KV demotes to the host tier and the
        # resume is recompute-free; without it the resume re-prefills
        while self.pool.shrinkable_pages() < target:
            victims = [(req.priority, -req.admit_seq, lane)
                       for lane, req in enumerate(self._active)
                       if req is not None]
            if not victims:
                break
            _, _, lane = min(victims)
            self._preempt_locked(lane)
            self.hbm_demotions += 1
        dropped = self.pool.shrink(target)
        self._hbm_reclaim_bytes = 0
        if dropped:
            self.hbm_shrinks += 1
            self.hbm.mirror_claim(KV_TENANT, "pool", self.pool.hbm_bytes)

    def _hbm_break_hoard_locked(self) -> None:
        """Preempt the most recently admitted lane when every lane is
        starved with nothing free — the hold-and-wait breaker of the
        elastic regime.  The victim resumes exactly."""
        if self.pool.free_pages > 0:
            return
        active = [(req.admit_seq, lane)
                  for lane, req in enumerate(self._active)
                  if req is not None and req.pages]
        if len(active) < 2:
            return  # one holder is not a hold-and-wait cycle
        _, lane = max(active)
        self._preempt_locked(lane)
        self.hbm_demotions += 1
        # the starvation streak stays up until a tick makes real progress:
        # admission is suppressed meanwhile (_admit_locked), so the victim
        # cannot re-admit and re-form the cycle first

    def _hbm_maybe_grow(self, block: bool) -> bool:
        """Per-tick grow probe (scheduler thread, no locks held): when
        queued or starved requests want more pages than the pool holds,
        ask the arbiter for the bytes — the pressure protocol may evict a
        cold model to supply them.  ``block=True`` (every lane starved)
        waits briefly for write-behind evictions to land; probes are free
        and retried next tick otherwise."""
        if self.hbm is None:
            return False
        with self._cv:
            if self._hbm_reclaim_bytes or self._pending_block is not None:
                return False  # being squeezed (or a block in flight)
            ps = self.page_size
            want = 0
            for req in self._queue[:self.lanes]:
                if req.kv_handle is not None:
                    want += req.kv_handle.n_pages + 1
                else:
                    t = len(req.pending_prompt) or (len(req.prompt)
                                                    + len(req.tokens_out))
                    want += (t + req.steps - len(req.tokens_out)
                             + ps - 1) // ps + 1
            for req in self._active:
                if req is None:
                    continue
                if req.pending_prompt:  # starved prefill / pending resume
                    want += max(0, (len(req.pending_prompt) + ps - 1) // ps
                                + 1 - len(req.pages))
                else:  # decoding: pages its remaining appends will write
                    need = (req.length + req.steps - len(req.tokens_out)
                            + ps - 1) // ps
                    want += max(0, need - len(req.pages))
            deficit = want - self.pool.free_pages
        if deficit <= 0:
            return False
        from tpulab_torch.hbm import KV_TENANT
        pn = self._page_nbytes()
        # ask only for what the economy could plausibly supply (free
        # headroom + what pressure could evict), snapped onto the size
        # ladder: the smallest rung covering the demand we can afford,
        # else the largest affordable step toward it
        avail = (max(0, self.hbm.free_hbm_bytes)
                 + self.hbm.reclaimable_bytes(exclude=KV_TENANT))
        n = self.pool.n_pages
        affordable = n + avail // pn
        target = self._hbm_pool_base
        while target < n + deficit and target * 2 <= affordable:
            target *= 2
        pages = target - n
        if pages <= 0:
            return False  # static-budget degrade: queue on today's pool
        granted = self.hbm.request(
            KV_TENANT, ("pool", "grow"), pages * pn,
            timeout=self.HBM_GROW_TIMEOUT_S if block else 0.0,
            probe=not block)
        if not granted:
            return False
        with self._cv:
            if self._pending_block is None:
                self.pool.grow(pages)
                self.hbm_grows += 1
            # consolidate: fold the grant into the pool claim (mirror
            # first so the total never dips below the tracked bytes)
            self.hbm.mirror_claim(KV_TENANT, "pool", self.pool.hbm_bytes)
            self.hbm.release(KV_TENANT, ("pool", "grow"))
            self._cv.notify()
        return True

    def _run(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        # inference_mode is thread-local: enter it on the scheduler thread
        with torch.inference_mode():
            self._loop()

    # -- the device operations (replayed by a mesh's followers) -------------
    def _place(self, tree):
        """A served tree on this batcher's device: under a mesh, this
        rank's Megatron shards only (:func:`~tpulab_torch.engine.sharded.
        local_params`)."""
        if self.mesh is None:
            return _tree_to(tree, self.device)
        from tpulab_torch.engine.sharded import local_params
        return local_params(tree, self.mesh, self.device)

    def _follow(self) -> None:
        """A follower's thread: replay the coordinator's operations on
        this rank's shards until its shutdown, or until the mesh fails
        (then ``mesh_failure`` says why)."""
        from tpulab_torch.engine.sharded import MeshFailure
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        try:
            with torch.inference_mode():
                self.pool.follow({"prefill": self._op_prefill,
                                  "extend": self._op_extend,
                                  "mixed": self._op_mixed,
                                  "block": self._op_block,
                                  "step": self._op_step,
                                  "spec": self._op_spec,
                                  "weights_out": self._op_weights_out,
                                  "weights_in": self._op_weights_in})
        except MeshFailure:
            _log.exception("follower rank %d: the mesh failed; replay ends",
                           self.tp.rank)

    @property
    def mesh_failure(self) -> Optional[str]:
        """Why this batcher's mesh failed (None while it serves, and
        without a mesh): a failed mesh runs nothing more."""
        ch = self.pool.channel
        return None if ch is None else ch.failure

    def _launch(self, op: str, *args, **kw):
        """Run device operation ``op`` on host arguments; under a mesh the
        coordinator first publishes it to the followers (host values
        only), which replay it on their shards in this order
        (:meth:`~tpulab_torch.engine.sharded.MeshChannel.run`)."""
        fn = getattr(self, f"_op_{op}")
        if self.pool.channel is not None:
            return self.pool.channel.run(op, fn, *args, **kw)
        return fn(*args, **kw)

    def _op_prefill(self, tables, tokens, t):
        return self._prefill(self.params, self.pool.kv, self._to_dev(tables),
                             self._to_dev(tokens), t)

    def _op_extend(self, tables, tokens, start, end, draft=False):
        fn, params = ((self._draft_extend, self._spec["params"]) if draft
                      else (self._extend, self.params))
        return fn(params, self.pool.kv, self._to_dev(tables),
                  self._to_dev(tokens), start, end)

    def _op_mixed(self, *host):
        return self._mixed_step(self.params, self.pool.kv,
                                *(self._to_dev(a) for a in host))

    def _op_block(self, tables, k, state=None):
        """A K-step decode block from host ``state`` (lengths, tokens,
        active, temps, seeds, steps left, stop ids) or, with None, chained
        from the last block's device carry (dispatch-ahead).  Returns the
        block's (tokens, logprobs, emitted)."""
        if state is None:
            (lengths, tokens, active, rem), host = self._chain
        else:
            lengths, tokens, active, temps, seeds, rem, stops = (
                self._to_dev(a) for a in state)
            host = (temps, seeds, stops)
        temps, seeds, stops = host
        toks, lps, ems, *carry = self._decode_block(
            self.params, self.pool.kv, self._to_dev(tables), lengths,
            tokens, active, temps, seeds, rem, stops, k=k)
        self._chain = (tuple(carry), host)
        return toks, lps, ems

    def _op_step(self, tables, lengths, tokens, active, temps=None,
                 seeds=None):
        args = (self.params, self.pool.kv, self._to_dev(tables),
                self._to_dev(lengths), self._to_dev(tokens),
                self._to_dev(active))
        if temps is None:
            return self._decode_step(*args)
        return self._decode_step(*args, temps=self._to_dev(temps),
                                 seeds=self._to_dev(seeds))

    def _op_spec(self, k, *host):
        return self._spec_block(self.params, self._spec["params"],
                                self.pool.kv,
                                *(self._to_dev(a) for a in host), k=k)

    def _op_weights_out(self) -> None:
        """A follower's replay of its coordinator's weight swap-out (a
        :class:`~tpulab_torch.modelstore.BatcherAdapter` detach): this
        rank's shards copied to its own host memory, page-locked on the
        card, and its device tensors dropped.  Nothing crosses ranks."""
        if self.params is None:
            raise RuntimeError("weights swapped out twice")
        from tpulab_torch.cuda.transfer import host_like
        from tpulab_torch.parallel.sharding import map_tree

        pinned = self.device.type == "cuda"
        self._host_params = map_tree(
            lambda t: host_like(t, pinned).copy_(t)
            if isinstance(t, torch.Tensor) else t, self.params)
        self.params = None

    def _op_weights_in(self, builder=None) -> None:
        """A follower's replay of its coordinator's weight swap-in: its
        host copy restored onto its device or, with ``builder`` (a cold
        rebuild: the coordinator's host tier lost the tree), the built
        tree cut to this rank's shards.  The host copy is dropped either
        way; with neither, the swap-in raises (fatal to the mesh)."""
        if builder is not None:
            self._host_params = None
            built = builder()
            params = self._place(_tree(getattr(built, "params", built)))
        elif self._host_params is None:
            raise RuntimeError("no host copy of this rank's weights to "
                               "swap in")
        else:
            from tpulab_torch.cuda.allocators import place_tree
            params = place_tree(self._host_params, self.device)
            self._host_params = None
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self.params = params

    def _loop(self) -> None:
        while True:
            with self._cv:
                while (not self._shutdown and not self._queue
                       and not any(self._active)
                       and not self._hbm_reclaim_bytes):
                    self._cv.wait()
                if (self._shutdown and not self._queue
                        and not any(self._active)):
                    self._profile_step(done=True)  # close an open capture
                    return
                # HBM arbiter pressure: serve an outstanding reclaim at the
                # tick boundary (dispatch-ahead is suppressed while one is
                # pending, and the service waits out a block still in
                # flight, so in-flight decode pages are never victims)
                self._service_hbm_locked()
                # cancellation + deadline sweep, before the next step
                swept, expired = [], []
                now = _time.monotonic()
                for lane, req in enumerate(self._active):
                    if req is None:
                        continue
                    if req.cancelled:
                        self._release_lane_locked(lane, req)
                        swept.append(req)
                    elif req.deadline is not None and now >= req.deadline:
                        self._release_lane_locked(lane, req)
                        expired.append(req)
                if self._queue:
                    still = []
                    for req in self._queue:
                        if req.deadline is not None and now >= req.deadline:
                            self._requests.pop(req.future, None)
                            self._discard_handle(req)
                            expired.append(req)
                        else:
                            still.append(req)
                    self._queue[:] = still
                self._admit_locked()
                snapshot = list(self._active)
            self._profile_step()   # the Debug RPC's capture bookkeeping
            for req in swept:
                self._flight_complete(req, "CANCELLED")
                if not req.future.done():
                    req.future.cancel() or req.future.set_exception(
                        RuntimeError("generation cancelled"))
            for req in expired:
                if self.metrics is not None:
                    self.metrics.note_deadline_expired()
                self._flight_complete(req, "DEADLINE_EXCEEDED")
                if not req.future.done():
                    req.future.set_exception(DeadlineExceeded(
                        "generation deadline exceeded "
                        f"({len(req.tokens_out)}/{req.steps} tokens)"))
            try:
                if self.ragged:
                    prefilled = self._ragged_round(snapshot)
                else:
                    prefilled = False
                    for lane, req in enumerate(snapshot):
                        if req is not None and req.pending_prompt:
                            prefilled |= self._do_prefill(req, lane)
                if prefilled:
                    # a steps==1 request can complete at prefill
                    done_reqs = []
                    with self._cv:
                        for lane, req in enumerate(self._active):
                            if (req is not None and not req.pending_prompt
                                    and req.finished()):
                                self._release_lane_locked(lane, req)
                                done_reqs.append(req)
                        self._admit_locked()
                        snapshot = list(self._active)
                    self._resolve(done_reqs)
                progressed = self._tick(snapshot) or prefilled
                if self.hbm is not None:
                    # KV-burst side of the economy: queued or starved demand
                    # asks the arbiter for pool bytes (a cold model may be
                    # evicted to supply them); a cheap probe a tick,
                    # blocking only when every lane is starved anyway
                    self._hbm_maybe_grow(block=not progressed)
                if not progressed:
                    if self.hbm is not None:
                        # hold-and-wait breaker: lanes are sized for the
                        # GROWN pool, so a denied grow can strand several
                        # partial page-holders.  After two fully starved
                        # passes with nothing free, preempt the newest lane
                        # (exact resume) so the eldest can finish
                        self._hbm_starved_passes += 1
                        if self._hbm_starved_passes >= 2:
                            with self._cv:
                                self._hbm_break_hoard_locked()
                    # every lane starved (pool pressure): back off
                    with self._cv:
                        self._cv.wait(timeout=0.01)
                else:
                    self._hbm_starved_passes = 0
            except Exception as e:  # noqa: BLE001 - fail active requests
                _log.exception("scheduler step failed; failing the active "
                               "requests and resetting the pool")
                self._pending_block = None
                self._fail_requests(e, queued=False)
                if self.prefix_cache is not None:
                    self.prefix_cache.drop_all()
                if self.mesh_failure is None:
                    try:
                        self.pool.reset()
                        continue
                    except Exception as e2:  # noqa: BLE001 - see below
                        if self.mesh_failure is None:
                            raise
                        e = e2
                # a failed mesh runs nothing more: every request fails and
                # the scheduler ends (submit raises from now on)
                self._fail_requests(e, queued=True)
                return

    def _fail_requests(self, e: BaseException, queued: bool) -> None:
        """Fail every active request with ``e`` (and, with ``queued``,
        every queued one), returning their lanes."""
        with self._cv:
            for lane, req in enumerate(self._active):
                if req is not None:
                    if not req.future.done():
                        self._flight_complete(req, "INTERNAL")
                        req.future.set_exception(e)
                    self._requests.pop(req.future, None)
                    self._discard_handle(req)
                    self._active[lane] = None
            if queued:
                for req in self._queue:
                    if not req.future.done():
                        self._flight_complete(req, "INTERNAL")
                        req.future.set_exception(e)
                    self._requests.pop(req.future, None)
                    self._discard_handle(req)
                self._queue[:] = []

    # -- split dispatch plan (per-prompt prefill forwards) --------------------
    def _program(self, fn, skip=(0, 1)):
        """``fn`` (a program over the batcher's static config), wrapped to
        record its scratch once per shape key when an arbiter measures
        scratch (tpulab's ``_jit`` wraps its jits in ``MeasuredJit`` the
        same way); ``skip``: the weights and page-store arguments, left
        out of the key.  Unarbitrated batchers get ``fn`` itself."""
        if self.hbm is None or not self.hbm.measure_scratch:
            return fn
        from tpulab_torch.hbm import MeasuredJit, ScratchGroup
        if self.scratch is None:
            # the programs run one at a time on the scheduler thread: one
            # claim, the largest key's (tpulab_torch.hbm.scratch)
            self.scratch = ScratchGroup(self.hbm, ("batcher", id(self)))
        name = getattr(getattr(fn, "func", fn), "__name__", "program")
        return MeasuredJit(fn, self.hbm, name, skip=skip,
                           group=self.scratch)

    def _build_prefill(self, flash: bool):
        """The full-prompt prefill program; ``flash`` selects the flash
        attention kernel for the prompt's causal attention."""
        attn_fn = (make_flash_attention_fn(causal=True) if flash
                   else causal_attention)
        return functools.partial(paged_prefill, attention_fn=attn_fn,
                                 **self._step_kw)

    def _do_prefill(self, req: _PagedRequest, lane: int = 0) -> bool:
        """Fill the whole prompt's KV pages and pick the first token.  One
        full-prompt forward per pow2 length bucket; with a prefix cache
        the shared full-page prefix is reused and only the tail runs
        (:func:`paged_extend`); with ``prefill_chunk`` long prompts run in
        page-aligned chunks.  A resume holding a host-tier snapshot
        restores it instead (True, no forward) unless the swap degrades.
        False (retry later) when the pool cannot yet supply the prompt's
        pages."""
        if req.cancelled or req.length != 0:   # swept / already started
            return False
        t = len(req.pending_prompt)
        if req.kv_handle is not None:
            swapped = self._try_swap_in(req, t, lane)
            if swapped is not None:
                return swapped
        prompt = np.asarray(req.pending_prompt, np.int32)
        shared: List[int] = []
        digests: List[bytes] = []
        if self.prefix_cache is not None:
            shared, digests = self.prefix_cache.lookup(prompt,
                                                       self.page_size)
        # shared prefix pages first, then private pages (the admission
        # page + extras) for the tail and the decode writes
        req.pages = shared + req.pages
        needed = (t + self.page_size - 1) // self.page_size
        while len(req.pages) < needed:
            page = self._alloc_page()
            if page is None:
                # page pressure: release partial holdings before retrying —
                # two starved prefills must not hold-and-wait each other
                self.pool.release_pages(req.pages)
                req.pages = []
                return False
            req.pages.append(page)
        start = len(shared) * self.page_size
        tables = np.zeros((self.max_pages,), np.int32)
        tables[:len(req.pages)] = req.pages
        # pages secured: the queue wait ends here (first prefill only — a
        # preemption resume re-prefills but left the queue once already)
        t_pf0 = _time.perf_counter()
        if req.t_prefill0 is None:
            req.t_prefill0 = t_pf0
            self._span("queue_wait", lane, req.t_submit,
                       t_pf0 - req.t_submit, req)
            if self.metrics is not None:
                self.metrics.observe_queue_wait(t_pf0 - req.t_submit)
        if req.resumed:
            req.t_resume0, req.resume_kind = t_pf0, "re_prefill"
        # chaos: the prefill fault site (tpulab's place): an error takes
        # the scheduler's recovery path, a delay is a slow prefill
        chaos.trip("engine.prefill")
        self.prefill_dispatches += 1
        self.prompt_fills += 1
        if start == 0 and (self.prefill_chunk is None
                           or t <= self.prefill_chunk):
            t_pad = 1 << (t - 1).bit_length()   # pow2 length bucket
            tokens = np.zeros((1, t_pad), np.int64)
            tokens[0, :t] = prompt
            last = self._launch("prefill", tables, tokens, t)
            self.prefill_forwards += 1
        else:
            # tail (and/or chunked) prefill against resident context
            chunk = self.prefill_chunk or (t - start)
            while start < t:
                m = min(chunk, t - start)
                m_pad = 1 << (m - 1).bit_length()
                tokens = np.zeros((1, m_pad), np.int64)
                tokens[0, :m] = prompt[start:start + m]
                last = self._launch("extend", tables, tokens, start,
                                    start + m)
                self.forward_steps += 1
                start += m
        req.length = t
        req.pending_prompt = []
        self._fl_pages(req)
        was_resumed = req.resumed
        if was_resumed:
            # preemption resume: the fed tail ends at tokens_out[-2]; the
            # last emitted token was picked before eviction — discard these
            # logits and continue decoding
            req.resumed = False
        else:
            tok, lp = self._first_token(req, last, t)
            req.tokens_out.append(tok)
            self.tokens_generated += 1
            if req.want_logprobs:
                req.logprobs_out.append(lp)
            self._emit(req, tok, 0, lp)
        # the prefill span closes after the first-token pick (its fetch
        # is the fence that makes the device time real)
        t_pf1 = _time.perf_counter()
        self._span("prefill", lane, t_pf0, t_pf1 - t_pf0, req,
                   prompt_tokens=t, cached_pages=len(shared))
        req.chunk_t0 = t_pf1
        req.chunk_start = len(req.tokens_out)
        if not was_resumed:
            req.t_first = req.t_last = t_pf1
            if self.metrics is not None:
                self.metrics.observe_ttft(t_pf1 - req.t_submit)
        if self.prefix_cache is not None and not was_resumed:
            # count each logical request once and publish first-prefill
            # pages only: full prompt pages are immutable from here on
            self.prefix_cache.count_lookup(len(shared), len(digests))
            self.prefix_cache.insert(digests, req.pages[:len(digests)])
        dt = t_pf1 - t_pf0
        if dt > 0:
            # rolling prefill throughput — the fabric cost gate's
            # recompute-time estimate (see kv_publish in __init__)
            inst = t / dt
            self.prefill_ewma_tok_s = (
                inst if self.prefill_ewma_tok_s == 0.0
                else 0.7 * self.prefill_ewma_tok_s + 0.3 * inst)
        if self.kv_publish and not was_resumed and req.export_digest is None:
            self._fab_publish(req, prompt, t, last)
        return True

    #: published fabric snapshots kept addressable (digest -> handle);
    #: beyond this the oldest export is forgotten — its store entries
    #: removed — so the fabric can never squat the whole host tier
    FAB_PUBLISH_CAP = 32

    def _fab_publish(self, req: _PagedRequest, prompt: np.ndarray, t: int,
                     last_logits: torch.Tensor) -> None:
        """Export a finished first prefill to the fleet KV fabric
        (:mod:`tpulab_torch.kvfabric`): the prompt's pages snapshot to the
        host tier under ``("fab", digest)`` through the same write-behind
        swap_out the preemption path uses (the gather is enqueued HERE,
        before any decode write into the tail page, so stream order makes
        the snapshot prompt-only), and the last-position logits row
        (f32) lands beside it under ``("fablog", digest)`` so a fetcher
        picks the first token under its OWN sampling seed.  Best-effort
        end to end: a degraded swap, a budget-refused put or a
        mid-flight eviction all surface as an honest FetchKV NOT_FOUND —
        never a wrong answer."""
        from tpulab_torch.disagg.wire import prompt_digest
        digest = prompt_digest(prompt)
        with self._fab_lock:
            if digest in self._fab_handles:
                self._fab_handles.move_to_end(digest)
                return
        n_pages = (t + self.page_size - 1) // self.page_size
        handle = self.kv_offload.swap_out(
            req.pages[:n_pages], t, self.pool.kv, key=("fab", digest))
        if handle is None:
            return
        if not self.kv_offload.store.put(
                ("fablog", digest),
                last_logits.float().reshape(-1).cpu()):
            self.kv_offload.discard(handle)
            return
        self.kv_publishes += 1
        with self._fab_lock:
            self._fab_handles[digest] = handle
            self._fab_handles.move_to_end(digest)
            while len(self._fab_handles) > self.FAB_PUBLISH_CAP:
                old_dig, old_h = self._fab_handles.popitem(last=False)
                self.kv_offload.discard(old_h)
                self.kv_offload.store.remove(("fablog", old_dig))

    def fab_handle(self, digest: bytes):
        """The published fabric snapshot for ``digest`` (a resident or
        still-in-flight :class:`~tpulab_torch.kvcache.offload.SwapHandle`),
        or None — the FetchKV server's lookup.  Thread-safe: the RPC
        thread reads while the scheduler publishes / evicts.  A hit bumps
        the publish-registry LRU (fabric-popular digests stay addressable)
        WITHOUT touching the host store's own recency — the store read
        goes through ``peek``."""
        with self._fab_lock:
            h = self._fab_handles.get(digest)
            if h is not None:
                self._fab_handles.move_to_end(digest)
            return h

    def _first_token(self, req: _PagedRequest, last, t: int):
        """The prompt's first token from its last logits row (one host
        copy): device-sampled at position t-1 — the same (seed, position)
        stream as the decode ticks — or picked on the host.  Returns
        ``(token, logprob or None)``; the logprob is the f32 log-softmax
        of the row, as in the decode programs."""
        sp = req.sampling
        row = last.float()
        on_device = sp.device and sp.temperature > 0.0
        pick = row
        if on_device:
            dev = row.device
            pick = device_sample_tokens(
                row[None], torch.tensor([sp.temperature], device=dev),
                torch.tensor([self._seed_words(sp)], device=dev),
                torch.tensor([t - 1], device=dev))
        parts = [pick]
        if req.want_logprobs:
            parts.append(torch.log_softmax(row, dim=-1))
        host = self._to_host(*parts)
        tok = int(host[0][0]) if on_device else sp.pick(host[0])
        return tok, (float(host[1][tok]) if req.want_logprobs else None)

    # -- ragged dispatch plan (mixed prefill+decode rounds) ------------------
    def _ragged_prefill_start(self, req: _PagedRequest, lane: int) -> bool:
        """Prefix-cache lookup + secure EVERY page the full prompt needs
        (all-or-nothing, so two starved prefills never hold-and-wait).
        False = page-starved (retry later)."""
        prompt = np.asarray(req.pending_prompt, np.int32)
        t = len(prompt)
        shared: List[int] = []
        digests: List[bytes] = []
        if self.prefix_cache is not None:
            shared, digests = self.prefix_cache.lookup(prompt,
                                                       self.page_size)
        req.pages = shared + req.pages
        needed = (t + self.page_size - 1) // self.page_size
        while len(req.pages) < needed:
            page = self._alloc_page()
            if page is None:
                self.pool.release_pages(req.pages)
                req.pages = []
                return False
            req.pages.append(page)
        req.pf_digests = digests
        req.pf_shared = len(shared)
        req.length = len(shared) * self.page_size
        del req.pending_prompt[:req.length]
        req.pf_started = True
        self.prompt_fills += 1
        now = req.pf_t0 = _time.perf_counter()
        if req.resumed:
            req.t_resume0, req.resume_kind = now, "re_prefill"
        if req.t_prefill0 is None:
            req.t_prefill0 = now
            self._span("queue_wait", lane, req.t_submit,
                       now - req.t_submit, req)
            if self.metrics is not None:
                self.metrics.observe_queue_wait(req.t_prefill0
                                                - req.t_submit)
        # chaos: the prefill fault site, once per prefill start (as in
        # _do_prefill: an error takes the scheduler's recovery path)
        chaos.trip("engine.prefill")
        return True

    def _to_dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(arr).to(self.device)

    def _fetch(self, *tensors) -> List[np.ndarray]:
        """:meth:`_to_host`, counted in ``decode_host_syncs``."""
        self.decode_host_syncs += 1
        return self._to_host(*tensors)

    def _to_host(self, *tensors) -> List[np.ndarray]:
        """ONE blocking device->host copy of several device tensors, each
        returned as a numpy array of its own dtype and shape (packed as
        float64, which holds token ids, f32 values and masks exactly).
        Under a mesh that failed meanwhile it raises instead: an aborted
        collective leaves no result to trust."""
        host = torch.cat([t.reshape(-1).to(torch.float64)
                          for t in tensors]).cpu()
        if self.pool.channel is not None:
            self.pool.channel.check()
        out, i = [], 0
        for t in tensors:
            n = t.numel()
            out.append(host[i:i + n].reshape(t.shape).to(t.dtype).numpy())
            i += n
        return out

    @staticmethod
    def _seed_words(sp: SamplingParams):
        return (sp.seed & 0xFFFFFFFF, (sp.seed >> 32) & 0xFFFFFFFF)

    def _ragged_round(self, snapshot) -> bool:
        """One fused mixed round: every prefilling lane advances one prompt
        chunk and — with no dispatched-ahead block in flight — every
        decoding lane one token, in ONE :func:`paged_mixed_step`.  No-op
        without pending prompts.  A resume holding a host-tier snapshot
        restores it instead of joining the round.  True when any lane
        progressed."""
        segs: List = []
        restored = False
        for lane, req in enumerate(snapshot):
            if req is None or not req.pending_prompt or req.cancelled:
                continue
            if req.kv_handle is not None:
                swapped = self._try_swap_in(req, len(req.pending_prompt),
                                            lane)
                if swapped is not None:
                    restored |= swapped
                    continue     # restored, or page-starved: retry later
            if not req.pf_started and not self._ragged_prefill_start(
                    req, lane):
                continue
            segs.append((lane, req))
        if not segs:
            return restored
        decode_parts: List = []
        if self._pending_block is None:
            for lane, req in enumerate(snapshot):
                if (req is None or req.pending_prompt or req.cancelled
                        or not req.tokens_out):
                    continue
                need = req.length // self.page_size + 1
                new: List[int] = []
                while len(req.pages) < need:
                    page = self._alloc_page()
                    if page is None:
                        break
                    req.pages.append(page)
                    new.append(page)
                if len(req.pages) < need:
                    for _ in new:    # starved: return the partial take
                        self.pool.release_pages([req.pages.pop()])
                    continue
                decode_parts.append((lane, req))
        cap = min(self.prefill_chunk or self.RAGGED_CHUNK_CAP,
                  self.RAGGED_CHUNK_CAP)
        chunks: Dict[int, int] = {}
        m_max = 1
        for lane, req in segs:
            c = min(len(req.pending_prompt), cap)
            chunks[lane] = c
            m_max = max(m_max, c)
        m_pad = 1 << (m_max - 1).bit_length()   # pow2 width bucket
        b = self.lanes
        tables = np.zeros((b, self.max_pages), np.int32)
        seq = np.zeros((b, m_pad), np.int64)
        q_lens = np.zeros((b,), np.int32)
        kv_lens = np.zeros((b,), np.int32)
        temps = np.zeros((b,), np.float32)
        seeds = np.zeros((b, 2), np.int64)
        host_lanes: List[int] = []
        lane_reqs: Dict[int, _PagedRequest] = {}
        for lane, req in segs:
            c = chunks[lane]
            lane_reqs[lane] = req
            seq[lane, :c] = req.pending_prompt[:c]
            q_lens[lane] = c
            kv_lens[lane] = req.length + c
            tables[lane, :len(req.pages)] = req.pages
            sp = req.sampling
            if c == len(req.pending_prompt) and not req.resumed \
                    and sp.temperature > 0.0:
                # final chunk: this round's pick IS the first token
                if sp.device:
                    temps[lane] = sp.temperature
                    seeds[lane] = self._seed_words(sp)
                else:
                    host_lanes.append(lane)
        for lane, req in decode_parts:
            lane_reqs[lane] = req
            seq[lane, 0] = req.tokens_out[-1]
            q_lens[lane] = 1
            kv_lens[lane] = req.length + 1
            tables[lane, :len(req.pages)] = req.pages
            sp = req.sampling
            if sp.temperature > 0.0:
                if sp.device:
                    temps[lane] = sp.temperature
                    seeds[lane] = self._seed_words(sp)
                else:
                    host_lanes.append(lane)
        if decode_parts:
            # decode lanes advance one tick this round: the decode fault
            # site (tpulab's place)
            chaos.trip("engine.step")
        t0 = _time.perf_counter()
        nt_dev, lp_dev, last_dev = self._launch(
            "mixed", tables, seq, q_lens, kv_lens, temps, seeds)
        self.decode_dispatches += 1
        self.forward_steps += 1
        self._note_dispatch("mixed")
        # one fetch: picks, logprobs and ONLY the host-sampled rows
        rows_dev = (last_dev[self._to_dev(np.asarray(host_lanes))]
                    if host_lanes else last_dev[:0])
        next_tokens, logprobs_arr, rows = self._fetch(nt_dev, lp_dev,
                                                      rows_dev)
        for i, lane in enumerate(host_lanes):
            req = lane_reqs[lane]
            next_tokens[lane] = req.sampling.pick(rows[i])
            if req.want_logprobs:
                row = rows[i].astype(np.float32)
                row = row - row.max()
                logprobs_arr[lane] = float(
                    row[next_tokens[lane]]
                    - np.log(np.exp(row).sum()))
        now = _time.perf_counter()
        self._step_ewma_s = (0.8 * self._step_ewma_s + 0.2 * (now - t0)
                             if self._step_ewma_s else now - t0)
        emits: List = []
        completed: List = []
        with self._cv:
            for lane, req in segs:
                if self._active[lane] is not req or req.cancelled:
                    continue
                c = chunks[lane]
                req.length += c
                del req.pending_prompt[:c]
                self._fl_pages(req)
                if req.pending_prompt:
                    continue         # mid-prompt: nothing emitted yet
                was_resumed = req.resumed
                if was_resumed:
                    # the pick happened before preemption: discard this
                    # round's (stateless) sample and continue decoding
                    req.resumed = False
                else:
                    tok = int(next_tokens[lane])
                    req.tokens_out.append(tok)
                    self.tokens_generated += 1
                    lp = None
                    if req.want_logprobs:
                        lp = float(logprobs_arr[lane])
                        req.logprobs_out.append(lp)
                    emits.append((req, tok, len(req.tokens_out) - 1, lp))
                self._span("prefill", lane, req.pf_t0, now - req.pf_t0,
                           req, prompt_tokens=req.length,
                           cached_pages=req.pf_shared)
                req.chunk_t0 = now
                req.chunk_start = len(req.tokens_out)
                if not was_resumed:
                    req.t_first = req.t_last = now
                    if self.metrics is not None:
                        self.metrics.observe_ttft(now - req.t_submit)
                if self.prefix_cache is not None and not was_resumed:
                    self.prefix_cache.count_lookup(req.pf_shared,
                                                   len(req.pf_digests))
                    self.prefix_cache.insert(
                        req.pf_digests, req.pages[:len(req.pf_digests)])
                req.pf_started = False
            for lane, req in decode_parts:
                if self._active[lane] is not req or req.cancelled:
                    continue
                self._probe_countdown_locked(req)
                req.length += 1
                tok = int(next_tokens[lane])
                req.tokens_out.append(tok)
                self.tokens_generated += 1
                dt = (now - req.t_last) if req.t_last is not None else None
                if self.metrics is not None and dt is not None:
                    self.metrics.observe_itl(dt)
                self._fl_block(req, 1, 1, dt)
                req.t_last = now
                lp = None
                if req.want_logprobs:
                    lp = float(logprobs_arr[lane])
                    req.logprobs_out.append(lp)
                emits.append((req, tok, len(req.tokens_out) - 1, lp))
                done = req.finished()
                if (done or len(req.tokens_out) - req.chunk_start
                        >= self.TRACE_DECODE_CHUNK):
                    self._flush_decode_chunk(req, lane, now)
                if done:
                    self._release_lane_locked(lane, req)
                    completed.append(req)
            self._admit_locked()
        # user callbacks and future resolution OUTSIDE the scheduler lock
        for req, tok, i, lp in emits:
            self._emit(req, tok, i, lp)
        self._resolve(completed)
        return True

    def _emit(self, req: _PagedRequest, token: int, index: int,
              logprob: Optional[float] = None) -> None:
        """``on_token(tok, i)``, or ``on_token(tok, i, logprob)`` iff the
        request asked for logprobs.  The first token after a resume also
        reports the resume's time (its start to this emit) and kind to
        ``metrics.observe_resume(seconds, kind)`` where the sink has it."""
        if req.t_resume0 is not None:
            t0, req.t_resume0 = req.t_resume0, None
            observe = getattr(self.metrics, "observe_resume", None)
            if observe is not None:
                observe(_time.perf_counter() - t0, req.resume_kind)
        if req.on_token is not None:
            try:
                if req.want_logprobs:
                    req.on_token(token, index, logprob)
                else:
                    req.on_token(token, index)
            except Exception:  # noqa: BLE001 - a consumer hook
                _log.exception("on_token hook failed")

    def _note_dispatch(self, kind: str) -> None:
        self.dispatch_kinds[kind] += 1
        self.ragged_dispatches += 1   # every dispatch runs the kernel family

    # -- fused decode dispatch ----------------------------------------------
    def _tight_slack_s(self) -> float:
        est = self._step_ewma_s or 0.005
        return min(1.0, max(0.05, 2.0 * self.decode_block * est))

    def _pick_block_k(self, decode_lanes) -> int:
        """Adaptive K: host-sampled lane -> 1; deadline-tight lane or a
        streaming consumer without queue pressure -> <= 2; otherwise the
        ``decode_block`` ceiling, never longer than the largest remaining
        budget needs; snapped down onto BLOCK_K_MENU."""
        kmax = self.decode_block
        if kmax <= 1:
            return 1
        now = _time.monotonic()
        want = kmax
        streaming = False
        max_rem = 1
        for _lane, req in decode_lanes:
            sp = req.sampling
            if sp.temperature > 0.0 and not sp.device:
                return 1
            if (req.deadline is not None
                    and req.deadline - now < self._tight_slack_s()):
                want = min(want, 2)
            if req.on_token is not None and not req.batch:
                # a batch lane's on_token is a checkpoint sink, not an
                # interactive consumer: it never drags the block to K<=2
                streaming = True
            max_rem = max(max_rem, req.steps - len(req.tokens_out))
        if streaming and not self._queue:
            want = min(want, 2)
        cover = next((m for m in self.BLOCK_K_MENU if m >= max_rem),
                     self.BLOCK_K_MENU[-1])
        k = min(want, cover)
        return max(m for m in self.BLOCK_K_MENU if m <= k)

    def _reserve_block_pages(self, decode_lanes, k: int):
        """Pre-allocate every page the next K appends write, per lane;
        under pool pressure the block shrinks to what every lane covers.
        Returns ``(k_eff, [(lane, req, new_pages), ...])``."""
        parts = []
        cap = k
        for lane, req in decode_lanes:
            appends_want = max(1, min(k, req.steps - len(req.tokens_out)))
            need = (req.length + appends_want - 1) // self.page_size + 1
            new: List[int] = []
            while len(req.pages) < need:
                page = self._alloc_page()
                if page is None:
                    break
                req.pages.append(page)
                new.append(page)
            covered = len(req.pages) * self.page_size - req.length
            appends = min(appends_want, covered)
            if appends <= 0:
                for _ in new:
                    self.pool.release_pages([req.pages.pop()])
                continue
            if appends < appends_want:
                cap = min(cap, appends)
            parts.append((lane, req, new))
        if not parts:
            return k, []
        k_eff = max(m for m in self.BLOCK_K_MENU if m <= max(1, cap))
        if k_eff < k:
            for _lane, req, new in parts:
                appends_eff = max(1, min(k_eff,
                                         req.steps - len(req.tokens_out)))
                need = (req.length + appends_eff - 1) // self.page_size + 1
                while len(req.pages) > need and new:
                    self.pool.release_pages([req.pages.pop()])
                    new.pop()
        return k_eff, parts

    # -- speculative lane policy ----------------------------------------------
    #: per-dispatch smoothing of a lane's acceptance EWMA
    SPEC_EWMA_DECAY = 0.5
    #: plain dispatches a transiently degraded lane (acceptance EWMA under
    #: the floor) waits before one speculative PROBE block re-tries it;
    #: verify-trip degrades never probe
    SPEC_PROBE_INTERVAL = 4

    def _spec_eligible(self, req: _PagedRequest) -> bool:
        """May this lane ride a speculative dispatch?  Host-sampled lanes
        never do (their picks need the logits row on the host every
        token); degraded lanes stay plain until a probe re-arms them."""
        sp = req.sampling
        if sp.temperature > 0.0 and not sp.device:
            return False
        return req.spec_enabled

    def _degrade_spec(self, req: _PagedRequest,
                      probe: bool = False) -> None:
        """Drop the lane to plain blocks; its draft pages go straight back
        to the pool.  ``probe=True`` (the acceptance-EWMA and pool-pressure
        paths) schedules a re-try after ``SPEC_PROBE_INTERVAL`` plain
        dispatches; ``probe=False`` (verify trips) stays plain for the
        rest of the request."""
        if req.spec_enabled:
            req.spec_enabled = False
            self.spec_fallbacks += 1
        req.spec_probe_in = self.SPEC_PROBE_INTERVAL if probe else None
        req.spec_probing = False
        if req.draft_pages:
            self.pool.release_pages(req.draft_pages)
            req.draft_pages = []
        req.draft_len = 0

    def _probe_countdown_locked(self, req: _PagedRequest) -> None:
        """One plain dispatch elapsed for a transiently degraded lane; at
        zero the lane re-enters speculation as a PROBE with its EWMA reset
        to the floor, so the probe block's own acceptance decides."""
        if (self._spec is None or req.spec_enabled
                or req.spec_probe_in is None):
            return
        req.spec_probe_in -= 1
        if req.spec_probe_in > 0:
            return
        req.spec_probe_in = None
        req.spec_enabled = True
        req.spec_probing = True
        req.spec_ewma = self.spec_accept_floor
        self.spec_probes += 1

    def _reserve_spec_pages(self, decode_lanes, k: int):
        """Target + draft page reservation for one speculative block,
        which writes positions ``length .. length + k`` on BOTH tables.
        Target pages are reserved first; a draft-table shortfall shrinks
        the block's k and never takes target pages; pages past the
        (shrunk) horizon go back to the pool.  Returns ``(kd, [(lane,
        req, new_target, new_draft), ...])``; ``kd == 0``: the pool
        cannot support speculation now (the target reservations stay for
        the plain path, the draft takes are returned)."""
        parts = []
        cap = k + 1                   # min covered appends across lanes
        for lane, req in decode_lanes:
            rem = req.steps - len(req.tokens_out)
            want = max(1, min(k + 1, rem))
            need = (req.length + want - 1) // self.page_size + 1
            new_t: List[int] = []
            while len(req.pages) < need:
                page = self._alloc_page()
                if page is None:
                    break
                req.pages.append(page)
                new_t.append(page)
            cov_t = len(req.pages) * self.page_size - req.length
            if cov_t <= 0:
                for _ in new_t:   # starved: return the partial take
                    self.pool.release_pages([req.pages.pop()])
                continue
            new_d: List[int] = []
            while len(req.draft_pages) < need:
                page = self._alloc_page()
                if page is None:
                    break
                req.draft_pages.append(page)
                new_d.append(page)
            cov_d = len(req.draft_pages) * self.page_size - req.length
            # only a coverage shortfall shrinks the block: a step budget
            # under k+1 is the device-side steps mask's business
            if cov_t < want:
                cap = min(cap, cov_t)
            if cov_d < want:
                cap = min(cap, cov_d)
            parts.append((lane, req, new_t, new_d))
        if not parts or cap < 2:
            # not even one proposal + its verify write: hand the draft
            # takes back; target reservations stay for plain blocks
            for _lane, req, _new_t, new_d in parts:
                for _ in new_d:
                    self.pool.release_pages([req.draft_pages.pop()])
            return 0, []
        kd = max(m for m in self.BLOCK_K_MENU if m <= cap - 1)
        for _lane, req, new_t, new_d in parts:
            rem = req.steps - len(req.tokens_out)
            want = max(1, min(kd + 1, rem))
            need = (req.length + want - 1) // self.page_size + 1
            while len(req.pages) > need and new_t:
                self.pool.release_pages([req.pages.pop()])
                new_t.pop()
            while len(req.draft_pages) > need and new_d:
                self.pool.release_pages([req.draft_pages.pop()])
                new_d.pop()
        return kd, parts

    def _plan_decode(self, snapshot):
        """This dispatch's decode lanes, mode, block size and reservations.
        The dispatch is speculative iff a draft model is armed and EVERY
        lane is eligible (one program serves the batch); otherwise, or
        when the pool cannot cover the draft tables, it is a plain
        block."""
        decode_lanes = [(lane, req) for lane, req in enumerate(snapshot)
                        if req is not None and not req.cancelled
                        and not req.pending_prompt and req.tokens_out]
        if not decode_lanes:
            return None
        k = self._pick_block_k(decode_lanes)
        if (self._spec is not None
                and all(self._spec_eligible(r) for _, r in decode_lanes)):
            kd, parts = self._reserve_spec_pages(decode_lanes, k)
            if kd >= 1 and parts:
                return {"k": kd, "parts": parts, "mode": "spec"}
        k, parts = self._reserve_block_pages(decode_lanes, k)
        if not parts and any(req.draft_pages for _, req in decode_lanes):
            # every lane page-starved while draft tables hold pages: the
            # draft KV is regenerable, so release the draft tables as a
            # transient degrade (arming the probe countdown) and retry
            # plain; without this target and draft tables can deadlock
            # holding every page
            for _lane, req in decode_lanes:
                if req.draft_pages:
                    self._degrade_spec(req, probe=True)
            k, parts = self._reserve_block_pages(
                decode_lanes, self._pick_block_k(decode_lanes))
        if not parts:
            return None  # every lane page-starved: caller backs off
        return {"k": k, "parts": parts, "mode": "plain"}

    def _tick(self, snapshot) -> bool:
        """Consume the dispatched-ahead block if one is in flight, else
        plan + dispatch + consume.  False when no decode lane progressed."""
        if self._pending_block is not None:
            stash, self._pending_block = self._pending_block, None
            return self._consume_block(stash)
        plan = self._plan_decode(snapshot)
        if plan is None:
            return False
        if plan["mode"] == "spec":
            stash = self._dispatch_spec_block(plan["parts"], plan["k"])
            if stash is not None:
                return self._consume_spec_block(stash)
            # a verify trip before dispatch: the lanes just degraded, so
            # this tick runs plain (their target pages are reserved)
            lanes = [(lane, req) for lane, req, _nt, _nd in plan["parts"]]
            k, parts = self._reserve_block_pages(
                lanes, self._pick_block_k(lanes))
            if not parts:
                return False
            plan = {"k": k, "parts": parts, "mode": "plain"}
        if plan["k"] == 1:
            return self._tick_single(plan["parts"])
        return self._consume_block(
            self._dispatch_block(plan["parts"], plan["k"]))

    def _dispatch_block(self, parts, k: int, chain: bool = False):
        """Enqueue one K-step decode block (no host sync).  ``chain``
        continues from the previous block's device-resident state
        (dispatch-ahead)."""
        b = self.lanes
        tables = np.zeros((b, self.max_pages), np.int32)
        lane_reqs = {}
        for lane, req, _new in parts:
            lane_reqs[lane] = req
            tables[lane, :len(req.pages)] = req.pages
        state = None
        if not chain:
            lengths = np.zeros((b,), np.int64)
            tokens = np.zeros((b,), np.int64)
            active = np.zeros((b,), bool)
            temps = np.zeros((b,), np.float32)
            seeds = np.zeros((b, 2), np.int64)
            rem = np.zeros((b,), np.int64)
            n_stop = max((len(r.stop_tokens) for _, r, _ in parts),
                         default=0)
            width = (1 << (n_stop - 1).bit_length()) if n_stop > 1 else 1
            stops = np.full((b, width), -1, np.int64)  # ids >= 0: pad safe
            for lane, req, _new in parts:
                lengths[lane] = req.length
                tokens[lane] = req.tokens_out[-1]
                active[lane] = True
                rem[lane] = req.steps - len(req.tokens_out)
                sp = req.sampling
                if sp.device and sp.temperature > 0.0:
                    temps[lane] = sp.temperature
                    seeds[lane] = self._seed_words(sp)
                if req.stop_tokens:
                    st = sorted(req.stop_tokens)
                    stops[lane, :len(st)] = st
            state = (lengths, tokens, active, temps, seeds, rem, stops)
        # chaos: the decode fault site, tripped once per decode TICK (k
        # times a block, as tpulab does): a schedule written against
        # per-token serving keeps its meaning under fused blocks, and an
        # error fails the in-flight requests and resets the pool
        for _ in range(k):
            chaos.trip("engine.step")
        t0 = _time.perf_counter()
        dev = self._launch("block", tables, k, state)
        self.decode_dispatches += 1
        self.forward_steps += k
        self._note_dispatch("decode")
        return {"k": k, "lane_reqs": lane_reqs, "dev": dev, "t0": t0}

    def _consume_block(self, stash) -> bool:
        """Fetch a dispatched block (ONE host sync for up to K tokens per
        lane), emit its tokens, and dispatch the next block ahead of the
        emit callbacks when the lane set is unchanged."""
        k = stash["k"]
        toks, lps, ems = self._fetch(*stash["dev"])
        now = _time.perf_counter()
        self._step_ewma_s = (
            0.8 * self._step_ewma_s + 0.2 * ((now - stash["t0"]) / k)
            if self._step_ewma_s else (now - stash["t0"]) / k)
        emits: List = []
        completed: List = []
        clean = True
        emitted_total = 0
        with self._cv:
            for lane, req in stash["lane_reqs"].items():
                if self._active[lane] is not req or req.cancelled:
                    # released or preempted since dispatch: discard
                    clean = False
                    continue
                self._probe_countdown_locked(req)
                n = int(ems[lane].sum())   # prefix mask: first n are valid
                if n == 0:
                    continue
                emitted_total += n
                dt = (now - req.t_last) / n if req.t_last is not None \
                    else None
                for j in range(n):
                    tok = int(toks[lane, j])
                    req.length += 1
                    req.tokens_out.append(tok)
                    self.tokens_generated += 1
                    if self.metrics is not None and dt is not None:
                        self.metrics.observe_itl(dt)
                    lp = float(lps[lane, j]) if req.want_logprobs else None
                    if req.want_logprobs:
                        req.logprobs_out.append(lp)
                    emits.append((req, tok, len(req.tokens_out) - 1, lp))
                req.t_last = now
                self._fl_block(req, k, n, dt)
                self._flush_decode_chunk(req, lane, now, block=k)
                if req.finished():
                    self._release_lane_locked(lane, req)
                    completed.append(req)
            self._admit_locked()
        if self.trace is not None and emitted_total:
            self.trace.add_counter("decode_block", now,
                                   tokens=emitted_total, k=k)
        # dispatch-ahead: same lanes, same K -> enqueue block N+1 from the
        # device carry BEFORE running block N's callbacks
        if (clean and not completed and k > 1
                and self._pending_block is None and not self._shutdown
                and not self._hbm_reclaim_bytes):
            lanes_now = list(stash["lane_reqs"].items())
            # a lane that just re-armed speculation (a probe countdown
            # expiring above) must go back through _plan_decode: a plain
            # chain-ahead here would starve the probe forever
            spec_next = (self._spec is not None
                         and all(self._spec_eligible(r)
                                 for _, r in lanes_now))
            if not spec_next and self._pick_block_k(lanes_now) == k:
                k2, parts2 = self._reserve_block_pages(lanes_now, k)
                if k2 == k and len(parts2) == len(lanes_now):
                    self._pending_block = self._dispatch_block(
                        parts2, k, chain=True)
        for req, tok, i, lp in emits:
            self._emit(req, tok, i, lp)
        self._resolve(completed)
        return True

    # -- speculative decode dispatch ----------------------------------------
    def _warm_draft(self, req: _PagedRequest) -> None:
        """Bring the lane's draft KV up to the target context (positions
        ``[draft_len, length)``): one draft forward over the missing tail
        through the second table (``start`` need not be page-aligned),
        never synced.  Runs at first speculative entry, after a preemption
        resume and after plain-block interludes."""
        t = req.length
        if req.draft_len >= t:
            return
        ctx = np.concatenate([req.prompt,
                              np.asarray(req.tokens_out[:-1], np.int32)])
        start = req.draft_len
        m = t - start
        tokens = np.zeros((1, 1 << (m - 1).bit_length()), np.int64)
        tokens[0, :m] = ctx[start:t]
        tables = np.zeros((self.max_pages,), np.int32)
        tables[:len(req.draft_pages)] = req.draft_pages
        self._launch("extend", tables, tokens, start, t, draft=True)
        req.draft_len = t
        self.spec_draft_prefills += 1
        self.draft_forward_steps += 1

    def _dispatch_spec_block(self, parts, k: int):
        """Enqueue one speculative dispatch (draft, verify and on-device
        accept).  Returns None when the ``engine.verify`` fault site trips:
        the lanes degrade to plain blocks for the rest of their requests
        and NOTHING was dispatched, so no token is emitted twice or lost."""
        try:
            tripped = chaos.trip("engine.verify")
        except chaos.ChaosError:
            tripped = "error"
        if tripped is not None:
            for _lane, req, _nt, _nd in parts:
                self._degrade_spec(req)
            return None
        for _lane, req, _nt, _nd in parts:
            self._warm_draft(req)
        b = self.lanes
        tables = np.zeros((b, self.max_pages), np.int32)
        dtables = np.zeros((b, self.max_pages), np.int32)
        lengths = np.zeros((b,), np.int64)
        tokens = np.zeros((b,), np.int64)
        active = np.zeros((b,), bool)
        temps = np.zeros((b,), np.float32)
        seeds = np.zeros((b, 2), np.int64)
        rem = np.zeros((b,), np.int64)
        n_stop = max((len(r.stop_tokens) for _, r, _nt, _nd in parts),
                     default=0)
        width = (1 << (n_stop - 1).bit_length()) if n_stop > 1 else 1
        stops = np.full((b, width), -1, np.int64)  # ids >= 0: pad safe
        lane_reqs = {}
        for lane, req, _nt, _nd in parts:
            lane_reqs[lane] = req
            tables[lane, :len(req.pages)] = req.pages
            dtables[lane, :len(req.draft_pages)] = req.draft_pages
            lengths[lane] = req.length
            tokens[lane] = req.tokens_out[-1]
            active[lane] = True
            rem[lane] = req.steps - len(req.tokens_out)
            sp = req.sampling
            if sp.device and sp.temperature > 0.0:
                temps[lane] = sp.temperature
                seeds[lane] = self._seed_words(sp)
            if req.stop_tokens:
                st = sorted(req.stop_tokens)
                stops[lane, :len(st)] = st
        t0 = _time.perf_counter()
        toks, lps, ems, _len, _tok, _live, _rem, drafted, accepted = \
            self._launch("spec", k, tables, dtables, lengths, tokens,
                         active, temps, seeds, rem, stops)
        self.decode_dispatches += 1
        self.spec_dispatches += 1
        self.forward_steps += 1
        self.draft_forward_steps += k + 1
        self._note_dispatch("verify")
        return {"k": k, "lane_reqs": lane_reqs,
                "dev": (toks, lps, ems, drafted, accepted), "t0": t0}

    def _consume_spec_block(self, stash) -> bool:
        """Fetch a speculative dispatch (ONE host sync for up to K+1
        accepted tokens per lane), update each lane's acceptance EWMA and
        emit.  Rejected proposals are counted (``spec_tokens_*``) but
        never emitted and never enter ``tokens_generated``.  A speculative
        block is never chained ahead."""
        k = stash["k"]
        toks, lps, ems, drafted, accepted = self._fetch(*stash["dev"])
        now = _time.perf_counter()
        self._step_ewma_s = (
            0.8 * self._step_ewma_s + 0.2 * ((now - stash["t0"]) / (k + 1))
            if self._step_ewma_s else (now - stash["t0"]) / (k + 1))
        emits: List = []
        completed: List = []
        emitted_total = 0
        accepted_total = 0
        with self._cv:
            for lane, req in stash["lane_reqs"].items():
                if self._active[lane] is not req or req.cancelled:
                    continue  # released since dispatch: block discarded
                d, a = int(drafted[lane]), int(accepted[lane])
                self.spec_tokens_drafted += d
                self.spec_tokens_accepted += a
                req.spec_drafted += d
                req.spec_accepted += a
                accepted_total += a
                rate = a / d if d else 0.0
                req.spec_ewma = (self.SPEC_EWMA_DECAY * req.spec_ewma
                                 + (1.0 - self.SPEC_EWMA_DECAY) * rate)
                if req.spec_probing:
                    # this dispatch WAS the probe: its acceptance decides
                    req.spec_probing = False
                    if req.spec_ewma >= self.spec_accept_floor:
                        self.spec_probe_recoveries += 1
                if req.spec_ewma < self.spec_accept_floor:
                    self._degrade_spec(req, probe=True)
                n = int(ems[lane].sum())   # prefix mask: first n are valid
                if n == 0:
                    continue
                emitted_total += n
                dt = (now - req.t_last) / n if req.t_last is not None \
                    else None
                for j in range(n):
                    tok = int(toks[lane, j])
                    req.length += 1
                    req.tokens_out.append(tok)
                    self.tokens_generated += 1
                    if self.metrics is not None and dt is not None:
                        self.metrics.observe_itl(dt)
                    lp = float(lps[lane, j]) if req.want_logprobs else None
                    if req.want_logprobs:
                        req.logprobs_out.append(lp)
                    emits.append((req, tok, len(req.tokens_out) - 1, lp))
                req.t_last = now
                if req.draft_pages:
                    # the block's own draft writes cover every accepted
                    # position (k+1 draft steps: no holes)
                    req.draft_len = req.length
                self._fl_block(req, k, n, dt)
                self._flush_decode_chunk(req, lane, now, block=k,
                                         accepted=a)
                if req.finished():
                    self._release_lane_locked(lane, req)
                    completed.append(req)
            self._admit_locked()
        if self.trace is not None and emitted_total:
            self.trace.add_counter("decode_block", now,
                                   tokens=emitted_total, k=k,
                                   accepted=accepted_total)
        for req, tok, i, lp in emits:
            self._emit(req, tok, i, lp)
        self._resolve(completed)
        return True

    def _tick_single(self, parts) -> bool:
        """K=1 decode tick (host-sampled lanes present, or
        decode_block=1): one dispatch + one fetch per token."""
        b = self.lanes
        tables = np.zeros((b, self.max_pages), np.int32)
        lengths = np.zeros((b,), np.int64)
        tokens = np.zeros((b,), np.int64)
        active = np.zeros((b,), bool)
        temps = np.zeros((b,), np.float32)
        seeds = np.zeros((b, 2), np.int64)
        host_lanes = []
        want_logp = False
        lane_reqs = {}
        for lane, req, _new in parts:
            lane_reqs[lane] = req
            tokens[lane] = req.tokens_out[-1]
            tables[lane, :len(req.pages)] = req.pages
            lengths[lane] = req.length
            active[lane] = True
            want_logp |= req.want_logprobs
            sp = req.sampling
            if sp.temperature > 0.0:
                if sp.device:
                    temps[lane] = sp.temperature
                    seeds[lane] = self._seed_words(sp)
                else:
                    host_lanes.append(lane)
        # chaos: the decode-tick fault site (an error fails the in-flight
        # requests and resets the pool; a delay slows every lane's step)
        chaos.trip("engine.step")
        t0 = _time.perf_counter()
        args = (tables, lengths, tokens, active)
        logprobs_arr = None
        if temps.any() or want_logp:
            tok_dev, logp_dev, logits = self._launch("step", *args,
                                                     temps=temps,
                                                     seeds=seeds)
        else:
            logits = self._launch("step", *args)
            tok_dev, logp_dev = logits.argmax(-1), None
        self.decode_dispatches += 1
        self.forward_steps += 1
        self._note_dispatch("decode")
        rows_dev = (logits[self._to_dev(np.asarray(host_lanes))]
                    if host_lanes else logits[:0])
        if logp_dev is None:
            next_tokens, rows = self._fetch(tok_dev, rows_dev)
        else:
            next_tokens, logprobs_arr, rows = self._fetch(tok_dev, logp_dev,
                                                          rows_dev)
        for i, lane in enumerate(host_lanes):
            next_tokens[lane] = lane_reqs[lane].sampling.pick(rows[i])
            if logprobs_arr is not None:
                row = rows[i].astype(np.float32)
                row = row - row.max()
                logprobs_arr[lane] = float(
                    row[next_tokens[lane]]
                    - np.log(np.exp(row).sum()))
        emits: List = []
        completed: List = []
        now = _time.perf_counter()
        self._step_ewma_s = (0.8 * self._step_ewma_s + 0.2 * (now - t0)
                             if self._step_ewma_s else now - t0)
        with self._cv:
            for lane, req in lane_reqs.items():
                if req.cancelled:
                    continue  # the _run sweep releases it next round
                self._probe_countdown_locked(req)
                req.length += 1
                req.tokens_out.append(int(next_tokens[lane]))
                self.tokens_generated += 1
                dt = (now - req.t_last) if req.t_last is not None else None
                if self.metrics is not None and dt is not None:
                    self.metrics.observe_itl(dt)
                self._fl_block(req, 1, 1, dt)
                req.t_last = now
                lp = (float(logprobs_arr[lane])
                      if logprobs_arr is not None else None)
                if req.want_logprobs:
                    req.logprobs_out.append(lp)
                emits.append((req, req.tokens_out[-1],
                              len(req.tokens_out) - 1, lp))
                done = req.finished()
                if (done or len(req.tokens_out) - req.chunk_start
                        >= self.TRACE_DECODE_CHUNK):
                    self._flush_decode_chunk(req, lane, now)
                if done:
                    self._release_lane_locked(lane, req)
                    completed.append(req)
            self._admit_locked()
        for req, tok, i, lp in emits:
            self._emit(req, tok, i, lp)
        self._resolve(completed)
        return True

    @staticmethod
    def _result_of(req: _PagedRequest):
        toks = list(req.tokens_out[:req.steps])
        if req.want_logprobs:
            return toks, list(req.logprobs_out[:len(toks)])
        return toks

    def _release_lane_locked(self, lane: int, req: _PagedRequest) -> None:
        if (req.export_digest is not None and self.kv_offload is not None
                and not req.cancelled and req.length > 0
                and req.finished()):
            # disagg export: snapshot the finished KV BEFORE the pages are
            # released (the same window as a preemption swap-out); the
            # shipper's export wait is the write-behind fence
            needed = (req.length + self.page_size - 1) // self.page_size
            req.future._tpulab_kv_export = self.kv_offload.swap_out(
                req.pages[:needed], req.length, self.pool.kv,
                key=("ship", req.export_digest))
        self.pool.release_pages(req.pages)
        if req.draft_pages:
            self.pool.release_pages(req.draft_pages)
            req.draft_pages = []
        self._discard_handle(req)   # a cancelled resume never restores
        self._active[lane] = None
        self._requests.pop(req.future, None)


def _tree_to(tree, device):
    """The param tree with every tensor on ``device`` (no copy when it is
    already there)."""
    return {k: (_tree_to(v, device) if isinstance(v, dict) else
                v.to(device)) for k, v in tree.items()}


# -- the bench rows (tpulab's ``benchmark_*`` of this module) ---------------
def _bench_tree(params, device, vocab, d_model, n_heads, n_layers, d_ff,
                n_kv_heads=None, tie_embeddings=True, seed=0):
    """A row's weights: ``params`` (a tree or a :class:`~tpulab_torch.
    models.transformer.Transformer`) as given, else tpulab's draw for the
    row on ``device`` (f32, gelu: tpulab's shapes and scale, the port's
    generator's values)."""
    if params is not None:
        return _tree(params)
    from tpulab_torch.models.transformer import init_transformer_params
    return init_transformer_params(
        vocab, d_model, n_heads, n_layers, d_ff, seed=seed,
        n_kv_heads=n_kv_heads, tie_embeddings=tie_embeddings, device=device)


def _error(e: BaseException) -> str:
    return f"{type(e).__name__}: {str(e)[:160]}"


def _timed_decode_tok_s(step, params_dev, kv0, tables, lengths, tokens,
                        active, lanes: int, iters: int) -> float:
    """Best-of-2 tokens/s of ``iters`` chained decode steps.  tpulab chains
    them in one ``lax.scan`` dispatch over a donated pool; the port runs
    them back to back, eagerly, on the pool's device, each writing the
    pool in place, and fences each pass with ONE host fetch of the logits
    trace (``logits[0, 0]`` of every step).  One warm pass first."""
    def run_n():
        trace = [step(params_dev, kv0, tables, lengths, tokens, active)[0, 0]
                 for _ in range(iters)]
        torch.stack(trace).cpu()

    with torch.inference_mode():
        run_n()
        best = float("inf")
        for _ in range(2):
            t0 = _time.perf_counter()
            run_n()
            best = min(best, _time.perf_counter() - t0)
    return lanes * iters / best


def _decode_inputs(lanes, mp, ctx, dev):
    """The timed rows' fixed decode state: lane b owns pages ``b*mp+1 ..
    (b+1)*mp``, every lane at position ``ctx - 2``, token 0, active."""
    tables = torch.arange(1, lanes * mp + 1, dtype=torch.int32,
                          device=dev).reshape(lanes, mp)
    lengths = torch.full((lanes,), ctx - 2, dtype=torch.int32, device=dev)
    tokens = torch.zeros((lanes,), dtype=torch.long, device=dev)
    active = torch.ones((lanes,), dtype=torch.bool, device=dev)
    return tables, lengths, tokens, active


def benchmark_decode_kernel_vs_gather(n_heads: int = 8, n_layers: int = 4,
                                      d_model: int = 1024,
                                      page_size: int = 32, lanes: int = 8,
                                      ctx: int = 2048, iters: int = 256,
                                      dtype=None, autotune: bool = False,
                                      params=None, device=None
                                      ) -> Dict[str, Any]:
    """tokens/s of :func:`paged_decode_step` through the ragged kernel
    (kernel 1, via :func:`_attend`) against the same step with attention
    through tpulab's XLA-gather math in plain PyTorch
    (:func:`_gather_attend`), at one (lanes, context) geometry (tpulab's
    bench row; :func:`_timed_decode_tok_s` times both).

    The gather step is private to this row: no batcher or program takes
    it (decisions: use_kernel=False).  ``kernel_geom`` is the geometry
    the kernel side's launches ran, ``"<body> x<splits>"`` as the
    wrapper records it (``launches_by_geom``; the most launched one), or
    ``"plain"`` on the CPU, where the wrapper runs its plain version.
    tpulab's ``autotune`` over the TPU kernel's ``g_pages`` x ``nbuf`` is
    VMEM geometry and is not carried: ``autotune=True`` raises."""
    if autotune:
        raise NotImplementedError(
            "autotune (tpulab's g_pages x nbuf sweep of the TPU kernel's "
            "VMEM geometry) is not carried to tpulab_torch (ROADMAP, "
            "decisions: g_pages / nbuf); the CUDA kernel picks its own "
            "split-KV count")
    dtype = dtype or torch.bfloat16
    dev = resolve_device(device)
    mp = ctx // page_size
    params = _tree_to(_bench_tree(params, dev, 256, d_model, n_heads,
                                  n_layers, 4 * d_model), dev)
    inputs = _decode_inputs(lanes, mp, ctx, dev)
    row: Dict[str, Any] = {"b": lanes, "ctx": ctx}

    def timed(step_fn):
        pool = PagedKVPool(lanes * mp + 1, page_size, n_layers, n_heads,
                           d_model // n_heads, dtype, dev)
        try:
            step = functools.partial(step_fn, n_heads=n_heads,
                                     n_layers=n_layers, compute_dtype=dtype)
            return _timed_decode_tok_s(step, params, pool.kv, *inputs,
                                       lanes, iters), None
        except Exception as e:
            return 0.0, _error(e)
        finally:
            pool.close()

    before = dict(ragged_paged_attention.launches_by_geom)
    row["kernel_tok_s"], err = timed(paged_decode_step)
    if err:
        row["kernel_error"] = err
    ran = {g: n - before.get(g, 0)
           for g, n in ragged_paged_attention.launches_by_geom.items()
           if n > before.get(g, 0)}
    row["gather_tok_s"], err = timed(_gather_decode_step)
    if err:
        row["gather_error"] = err
    if dev.type == "cuda":
        # what the kernel side's launches ran (the queries' dtype picks the
        # body: f32 params lift them to f32 whatever ``dtype``)
        row["kernel_geom"] = max(ran, key=ran.get, default="none")
    else:
        row["kernel_geom"] = "plain"
    return row


def benchmark_decode_kernel_sweep(
        combos=((8, 2048), (32, 2048), (8, 8192), (8, 16384)),
        n_heads: int = 8, n_layers: int = 4, d_model: int = 1024,
        page_size: int = 32, dtype=None, params=None,
        device=None) -> List[Dict[str, Any]]:
    """:func:`benchmark_decode_kernel_vs_gather` across (lanes, context),
    where the gather's O(B x ctx) materialization grows and the kernel's
    page walk should pull ahead (tpulab's row).  Iteration counts scale
    inversely with per-step work, as tpulab's; no autotune (decisions)."""
    return [benchmark_decode_kernel_vs_gather(
        n_heads=n_heads, n_layers=n_layers, d_model=d_model,
        page_size=page_size, lanes=lanes, ctx=ctx,
        iters=max(16, int(256 * (8 * 2048) / (lanes * ctx))), dtype=dtype,
        params=params, device=device) for lanes, ctx in combos]


def _bench_prompts(n, prompt_len, vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, (prompt_len,), np.int32)
            for _ in range(n)]


def benchmark_decode_dispatch(ks=(1, 4, 8, 16), lanes: int = 4,
                              steps: int = 48, prompt_len: int = 8,
                              d_model: int = 64, n_heads: int = 4,
                              n_layers: int = 2, vocab: int = 256,
                              dtype=None, n_kv_heads: Optional[int] = None,
                              rope_theta: Optional[float] = None,
                              params=None, device=None) -> Dict[str, Any]:
    """Served tokens/s and host-sync accounting of the ContinuousBatcher
    across fused-decode block sizes K (tpulab's bench ``decode_dispatch``
    row).

    The same submit -> result workload runs at each K after one warm run;
    per K the row records tok/s, decode dispatches, blocking host syncs
    and syncs per token, plus greedy token parity against the K=1 run.
    The batchers take the split plan (``ragged=False``): tpulab's row
    runs its batcher's default, which below ``KERNEL_AUTO_MIN_CTX`` is
    the split plan on every backend; the port's decodes through kernel 1
    and, on the card, prefills through kernel 2."""
    dtype = dtype or torch.float32
    dev = resolve_device(device)
    params = _bench_tree(params, dev, vocab, d_model, n_heads, n_layers,
                         4 * d_model, n_kv_heads)
    prompts = _bench_prompts(lanes, prompt_len, vocab)
    max_len = prompt_len + steps + 8
    row: Dict[str, Any] = {"lanes": lanes, "steps": steps, "k": {}}
    base_tokens = None
    for k in ks:
        cb = ContinuousBatcher(params, n_heads=n_heads, n_layers=n_layers,
                               lanes=lanes, max_len=max_len, page_size=8,
                               compute_dtype=dtype, decode_block=k,
                               n_kv_heads=n_kv_heads, rope_theta=rope_theta,
                               ragged=False, device=dev)
        try:
            for f in [cb.submit(p, steps) for p in prompts]:
                f.result(timeout=600)
            d0, s0 = cb.decode_dispatches, cb.decode_host_syncs
            tg0 = cb.tokens_generated
            t0 = _time.perf_counter()
            futs = [cb.submit(p, steps) for p in prompts]
            outs = [list(f.result(timeout=600)) for f in futs]
            dt = _time.perf_counter() - t0
            toks = cb.tokens_generated - tg0
            entry = {
                "tok_s": toks / max(dt, 1e-9),
                "dispatches": cb.decode_dispatches - d0,
                "host_syncs": cb.decode_host_syncs - s0,
                "syncs_per_token": (cb.decode_host_syncs - s0)
                / max(toks, 1),
            }
            if base_tokens is None:
                base_tokens = outs
            else:
                entry["parity_vs_k1"] = outs == base_tokens
            row["k"][str(k)] = entry
        except Exception as e:  # one K's failure must not sink the row
            row["k"][str(k)] = {"error": _error(e)}
        finally:
            cb.shutdown()
    k1 = row["k"].get("1", {})
    best = max((e for e in row["k"].values() if "tok_s" in e),
               key=lambda e: e["tok_s"], default=None)
    if best is not None and k1.get("tok_s"):
        row["best_tok_s"] = best["tok_s"]
        row["uplift_vs_k1"] = best["tok_s"] / k1["tok_s"]
    return row


def _scaled_tail(tree, first: int, n_layers: int, tail_scale: float):
    """``tree`` with layers ``first ..``'s ``wo`` / ``w2`` times
    ``tail_scale`` as NEW tensors (the caller's tree is not touched)."""
    out = dict(tree)
    for i in range(first, n_layers):
        layer = dict(tree[f"layer{i}"])
        for w in ("wo", "w2"):
            layer[w] = layer[w] * tail_scale
        out[f"layer{i}"] = layer
    return out


def _warm_block_sizes(cb, k: int, spec: bool) -> None:
    """Run every ``BLOCK_K_MENU`` size <= k of the mode's block once on a
    zero throwaway pool, all lanes inactive (tpulab pre-compiles them so;
    the port has no compile, but the sizes' first launches stay out of the
    timed window).  K=1 plain decode runs the single step, already warm."""
    lanes = cb.lanes
    dev = cb.device
    i32 = functools.partial(torch.zeros, (lanes,), dtype=torch.int32,
                            device=dev)
    tables = torch.zeros((lanes, cb.max_pages), dtype=torch.int32,
                         device=dev)
    state = (tables, i32(), i32(), torch.zeros((lanes,), dtype=torch.bool,
                                               device=dev))
    extra = (torch.zeros((lanes,), dtype=torch.float32, device=dev),
             torch.zeros((lanes, 2), dtype=torch.int64, device=dev), i32(),
             torch.full((lanes, 1), -1, dtype=torch.int32, device=dev))
    with torch.inference_mode():
        for m in cb.BLOCK_K_MENU:
            if m > k or (m == 1 and not spec):
                continue
            zkv = torch.zeros_like(cb.pool.kv)
            if spec:
                out = paged_speculative_block(
                    cb.params, cb._spec["params"], zkv, tables, *state,
                    *extra, k=m, **cb._spec_kw)
            else:
                out = paged_decode_block(cb.params, zkv, *state, *extra,
                                         k=m, **cb._step_kw)
            out[0].cpu()
            del zkv


def benchmark_speculative_decode(k: int = 8, lanes: int = 2,
                                 steps: int = 48, prompt_len: int = 8,
                                 d_model: int = 64, n_heads: int = 4,
                                 n_layers: int = 4, draft_layers: int = 1,
                                 vocab: int = 256,
                                 tail_scale: float = 0.05,
                                 dtype=None,
                                 n_kv_heads: Optional[int] = None,
                                 rope_theta: Optional[float] = None,
                                 params=None, device=None
                                 ) -> Dict[str, Any]:
    """tok/s, tokens per dispatch, host syncs and acceptance of speculative
    decode blocks against plain K-blocks through the SAME ContinuousBatcher
    workload (tpulab's bench ``speculative_decode`` row; the split plan,
    as :func:`benchmark_decode_dispatch`).

    The draft is the target's first ``draft_layers`` layers (early exit)
    with the later layers' ``wo`` / ``w2`` scaled by ``tail_scale``: the
    trained-model emulation (raw random tail layers pin acceptance to 0).
    The scaled matrices are new tensors; ``params`` is left as it was.
    Before each timed window every ``BLOCK_K_MENU`` size <= k of the mode
    runs once (:func:`_warm_block_sizes`).  Greedy parity of the two modes
    is recorded."""
    dtype = dtype or torch.float32
    dev = resolve_device(device)
    params = _scaled_tail(
        _bench_tree(params, dev, vocab, d_model, n_heads, n_layers,
                    4 * d_model, n_kv_heads),
        draft_layers, n_layers, tail_scale)
    from tpulab_torch.models.transformer import early_exit_draft
    draft = early_exit_draft(params, draft_layers)
    prompts = _bench_prompts(lanes, prompt_len, vocab)
    max_len = prompt_len + steps + 8
    row: Dict[str, Any] = {"lanes": lanes, "steps": steps, "k": k,
                           "draft_layers": draft_layers}
    outs: Dict[str, Any] = {}
    for mode in ("plain", "spec"):
        cb = ContinuousBatcher(
            params, n_heads=n_heads, n_layers=n_layers, lanes=lanes,
            max_len=max_len, page_size=8, compute_dtype=dtype,
            decode_block=k, n_pages=2 * lanes * ((max_len + 7) // 8) + 1,
            draft_params=draft if mode == "spec" else None,
            draft_n_layers=draft_layers, n_kv_heads=n_kv_heads,
            rope_theta=rope_theta, ragged=False, device=dev)
        try:
            for f in [cb.submit(p, steps) for p in prompts]:
                f.result(timeout=600)
            _warm_block_sizes(cb, k, mode == "spec")
            d0, s0 = cb.decode_dispatches, cb.decode_host_syncs
            tg0 = cb.tokens_generated
            dr0, ac0 = cb.spec_tokens_drafted, cb.spec_tokens_accepted
            t0 = _time.perf_counter()
            futs = [cb.submit(p, steps) for p in prompts]
            outs[mode] = [list(f.result(timeout=600)) for f in futs]
            dt = _time.perf_counter() - t0
            toks = cb.tokens_generated - tg0
            entry = {
                "tok_s": toks / max(dt, 1e-9),
                "dispatches": cb.decode_dispatches - d0,
                "host_syncs": cb.decode_host_syncs - s0,
                # emitted tokens only: rejected proposals never count
                "tokens_per_dispatch": toks / max(1, cb.decode_dispatches
                                                  - d0),
                "syncs_per_token": (cb.decode_host_syncs - s0)
                / max(toks, 1),
            }
            if mode == "spec":
                drafted = cb.spec_tokens_drafted - dr0
                accepted = cb.spec_tokens_accepted - ac0
                entry["drafted"] = drafted
                entry["accepted"] = accepted
                entry["acceptance"] = accepted / max(1, drafted)
                entry["fallbacks"] = cb.spec_fallbacks
            row[mode] = entry
        except Exception as e:  # one mode's failure must not sink the row
            row[mode] = {"error": _error(e)}
        finally:
            cb.shutdown()
    if "tok_s" in row.get("plain", {}) and "tok_s" in row.get("spec", {}):
        row["parity"] = outs["spec"] == outs["plain"]
        row["uplift"] = row["spec"]["tok_s"] / max(row["plain"]["tok_s"],
                                                   1e-9)
    return row


def benchmark_ragged_attention(lanes: int = 3, steps: int = 24,
                               prompt_len: int = 12, d_model: int = 64,
                               n_heads: int = 4, n_layers: int = 2,
                               vocab: int = 256, kernel: bool = True,
                               dtype=None, n_kv_heads: Optional[int] = None,
                               rope_theta: Optional[float] = None,
                               params=None, device=None) -> Dict[str, Any]:
    """Dispatch / host-sync accounting and served tok/s of the ragged
    dispatch plan across batch-raggedness shapes (tpulab's bench
    ``ragged_attention`` row).

    Three windows through the same submit -> result harness:
    ``all_prefill`` (``lanes`` simultaneous steps=1 prompts: the ragged
    plan folds their prefills into one dispatch), ``all_decode`` (the
    K-block regime) and ``mixed`` (prompts arriving mid-decode).  Modes:
    ``legacy``, the split plan (``ragged=False``: flash prefill, kernel 2,
    and kernel 1 decode on the card), and with ``kernel`` the ragged plan
    on kernel 1 (``ragged_kernel``), whose token parity against legacy is
    recorded.  tpulab's ``ragged`` mode (the ragged plan over XLA-gather
    attention) is not carried (ROADMAP, decisions: use_kernel=False), so
    ``prefill_fold`` reads ``ragged_kernel``'s ``all_prefill``."""
    import threading as _threading

    dtype = dtype or torch.float32
    dev = resolve_device(device)
    params = _bench_tree(params, dev, vocab, d_model, n_heads, n_layers,
                         4 * d_model, n_kv_heads)
    prompts = _bench_prompts(lanes, prompt_len, vocab)
    max_len = prompt_len + steps + 8
    modes = [("legacy", dict(ragged=False))]
    if kernel:
        modes.append(("ragged_kernel", dict(ragged=True)))
    row: Dict[str, Any] = {"lanes": lanes, "steps": steps,
                           "prompt_len": prompt_len}
    outs: Dict[str, Dict[str, Any]] = {}
    for mode, kw in modes:
        cb = ContinuousBatcher(params, n_heads=n_heads, n_layers=n_layers,
                               lanes=lanes, max_len=max_len, page_size=8,
                               compute_dtype=dtype, decode_block=8,
                               n_kv_heads=n_kv_heads, rope_theta=rope_theta,
                               device=dev, **kw)
        entry: Dict[str, Any] = {}
        got: Dict[str, Any] = {}
        try:
            for f in [cb.submit(p, steps) for p in prompts]:
                f.result(timeout=600)
            cb.submit(prompts[0], 1).result(timeout=600)

            def window(name, fn):
                d0 = (cb.decode_dispatches + cb.prefill_dispatches,
                      cb.decode_host_syncs, cb.tokens_generated)
                t0 = _time.perf_counter()
                got[name] = fn()
                dt = _time.perf_counter() - t0
                toks = cb.tokens_generated - d0[2]
                entry[name] = {
                    "tok_s": toks / max(dt, 1e-9),
                    "dispatches": (cb.decode_dispatches
                                   + cb.prefill_dispatches - d0[0]),
                    "host_syncs": cb.decode_host_syncs - d0[1],
                    "syncs_per_token": (cb.decode_host_syncs - d0[1])
                    / max(toks, 1),
                }

            def all_prefill():
                futs = [cb.submit(p, 1) for p in prompts]
                return [list(f.result(timeout=600)) for f in futs]

            def all_decode():
                futs = [cb.submit(p, steps) for p in prompts]
                return [list(f.result(timeout=600)) for f in futs]

            def mixed():
                evt = _threading.Event()
                f0 = cb.submit(prompts[0], steps, on_token=lambda t, i: (
                    evt.set() if i == 2 else None))
                evt.wait(60)
                rest = [cb.submit(p, steps // 2) for p in prompts[1:]]
                return ([list(f0.result(timeout=600))]
                        + [list(f.result(timeout=600)) for f in rest])

            window("all_prefill", all_prefill)
            window("all_decode", all_decode)
            window("mixed", mixed)
            entry["ragged_dispatches"] = cb.ragged_dispatches
            entry["dispatch_kinds"] = dict(cb.dispatch_kinds)
            outs[mode] = got
            row[mode] = entry
        except Exception as e:  # one mode's failure must not sink the row
            row[mode] = {"error": _error(e)}
        finally:
            cb.shutdown()
    base = outs.get("legacy")
    if base and "ragged_kernel" in outs:
        # every window's token values are deterministic across plans
        row["ragged_kernel"]["parity"] = outs["ragged_kernel"] == base
        row["prefill_fold"] = {
            "legacy_dispatches": row["legacy"]["all_prefill"]["dispatches"],
            "ragged_dispatches":
                row["ragged_kernel"]["all_prefill"]["dispatches"]}
    return row


def benchmark_llm_decode(n_heads: int = 16, n_kv_heads: int = 4,
                         n_layers: int = 8, d_model: int = 1024,
                         d_ff: int = 4096, vocab: int = 8192,
                         page_size: int = 16, lanes: int = 8,
                         ctx: int = 1024, iters: int = 64,
                         dtype=None, rope_theta: Optional[float] = None,
                         params=None, device=None) -> Dict[str, Any]:
    """Paged decode tokens/s with bf16 against weight-only int8 (W8A16)
    weights at a Llama-ish GQA geometry (tpulab's bench ``llm_decode``
    row): small-batch decode reads every weight per step, so int8 is the
    latency lever it measures.  Timed as
    :func:`benchmark_decode_kernel_vs_gather` times (``_timed_decode_tok_s``).
    tpulab's row decodes through its XLA gather (``use_kernel=False``);
    :func:`paged_decode_step` has no gather path, so the port's runs
    kernel 1.  The int8 tree is quantized from the bf16 one
    (:func:`~tpulab_torch.models.quantization.quantize_transformer_params`);
    every float leaf of both is bf16, the head untied as tpulab's."""
    from tpulab_torch.models.quantization import (quantize_transformer_params,
                                                  transformer_param_bytes)

    dtype = dtype or torch.bfloat16
    dev = resolve_device(device)

    def to_bf16(tree):
        # every float leaf; int8 payloads pass through untouched
        return {k: (to_bf16(v) if isinstance(v, dict) else
                    v.to(torch.bfloat16) if v.is_floating_point() else v)
                for k, v in tree.items()}

    mp = ctx // page_size
    params = _tree_to(_bench_tree(params, dev, vocab, d_model, n_heads,
                                  n_layers, d_ff, n_kv_heads,
                                  tie_embeddings=False), dev)
    inputs = _decode_inputs(lanes, mp, ctx, dev)
    row: Dict[str, Any] = {"b": lanes, "ctx": ctx,
                           "layers": n_layers, "d_model": d_model}
    step = functools.partial(paged_decode_step, n_heads=n_heads,
                             n_layers=n_layers, compute_dtype=dtype,
                             n_kv_heads=n_kv_heads, rope_theta=rope_theta)
    for label in ("bf16", "int8"):
        pool = PagedKVPool(lanes * mp + 1, page_size, n_layers, n_kv_heads,
                           d_model // n_heads, dtype, dev)
        p = None
        try:
            p = to_bf16(params if label == "bf16" else
                        quantize_transformer_params(params))
            row[f"{label}_tok_s"] = _timed_decode_tok_s(
                step, p, pool.kv, *inputs, lanes, iters)
            row[f"{label}_param_mb"] = transformer_param_bytes(p) / 2**20
        except Exception as e:
            row[f"{label}_tok_s"] = 0.0
            row[f"{label}_error"] = _error(e)
        finally:
            pool.close()
            del p
    return row
