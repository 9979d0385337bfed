"""Sharded serving on ``torch.distributed``: the paged engine on a
``{"model": M}`` mesh, one process per card (the port of tpulab's
``ContinuousBatcher(mesh=)`` / ``PagedKVPool(mesh=)``).

tpulab runs one program over M devices and lets XLA insert the
collectives.  The port runs M processes.  Rank 0 of the ``model`` axis is
the COORDINATOR: it owns the scheduler, the page tables, the refcounts
and the prefix cache, and takes ``submit``.  The other ranks are
FOLLOWERS: they hold their shards of the weights and of the page store
and replay each of the coordinator's device operations on them, in the
coordinator's order, so every collective meets its partners.

:class:`MeshChannel` carries the coordinator's tick descriptors: before
it launches a device operation, the coordinator publishes ``(op, host
arguments)`` (tables, lengths, tokens, seeds, page lists; never a device
tensor) under a sequence number in a ``TCPStore`` that it serves itself,
and each follower reads them in order.  The channel is host to host: the
coordinator never waits on a follower to publish, and its host-sync count
per block stays what it is at ``mesh=None``.  A dispatched-ahead decode
block chains from the previous block's device carry on every rank (each
rank keeps its own copy; the picks are made over the all-gathered vocab,
so every rank holds the same carry).

A failure inside a replicated operation, on any rank, is fatal to the
mesh (:meth:`MeshChannel.run`): the rank that raises records why in the
store and aborts its process group.  A watcher thread on that record
aborts the group of the coordinator and, over NCCL, of every follower
in turn, so a collective or a device sync waiting on the lost rank ends
on every rank (a gloo partner's collective fails as the lost rank's
connections close; an NCCL partner would wait for the group's timeout).
The coordinator's watcher also tells idle followers to end their
replay.  The coordinator's fetches then refuse to return results, and
every later operation raises :class:`MeshFailure`.  The batcher fails
every request it holds and takes no more.  A follower whose coordinator
died sees the store's connection close and raises.

The ranks of one ``model`` axis share a host (tensor parallelism spans
one NVLink domain): the channel listens on 127.0.0.1.

Also here: :func:`local_params` (this rank's Megatron shards of a served
tree), :func:`init_transformer_shards` (tpulab's random weights cut leaf by
leaf on this rank's card, for widths no rank could hold whole) and
:func:`benchmark_sharded_decode` (tpulab's bench row).
"""

from __future__ import annotations

import atexit
import contextlib
import datetime
import logging
import pickle
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

_log = logging.getLogger("tpulab_torch.engine")

#: a follower waits this long for the coordinator's next descriptor (an
#: idle server publishes nothing; a dead coordinator closes the socket)
FOLLOWER_WAIT = datetime.timedelta(days=365)
#: the coordinator's store refuses a client that takes longer to connect
STORE_TIMEOUT = datetime.timedelta(seconds=300)
#: seconds between a watcher's looks at the store (it never blocks inside
#: a store call, so it can end before the interpreter finalizes)
WATCH_POLL_S = 0.05

#: channels whose watcher thread runs
_WATCHED: set = set()
_WATCHED_LOCK = threading.Lock()


@atexit.register
def _end_watchers() -> None:
    """End every watcher before the interpreter finalizes: a daemon thread
    inside a store call then (its coordinator's store closing as that
    process exits) aborts the process."""
    with _WATCHED_LOCK:
        channels = list(_WATCHED)
    for ch in channels:
        ch._closing = True
    for ch in channels:
        ch._watcher.join(timeout=1.0)


class MeshFailure(RuntimeError):
    """A rank of a ``model`` axis failed inside a replicated operation:
    the ranks' states may differ, so the mesh runs nothing more."""


def abort_group(group) -> None:
    """End ``group``'s collectives on this rank, pending ones included: a
    partner's collective then fails instead of waiting for the group's
    timeout (gloo sees its connections close; NCCL aborts the
    communicator).  Torch builds with no abort destroy the group."""
    from torch.distributed import distributed_c10d as c10d
    try:
        c10d._abort_process_group(group)
    except (AttributeError, NotImplementedError, RuntimeError):
        dist.destroy_process_group(group)


def mesh_device(mesh) -> torch.device:
    """The device this rank's shards live on: its current card under
    NCCL, the CPU under gloo."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def check_head_split(n_heads: int, n_kv_heads: int, n_model: int,
                     model_axis: str = "model") -> None:
    """tpulab's refusal of a head count the ``model`` axis does not
    divide: the ragged kernel runs on each rank's own heads."""
    if n_heads % n_model or n_kv_heads % n_model:
        raise ValueError(
            f"query heads ({n_heads}) and KV heads ({n_kv_heads}) must "
            f"divide the mesh {model_axis!r} axis ({n_model}) — the ragged "
            "kernel shards on the heads dim")


class MeshChannel:
    """The coordinator's tick descriptors to the followers of one
    ``model`` axis (module docstring).  Every rank of the axis constructs
    it together (the coordinator broadcasts its store's port)."""

    def __init__(self, tp):
        self.tp = tp
        self.coordinator = tp.rank == 0
        self.n_followers = tp.size - 1
        #: why the mesh failed (None while it serves)
        self.failure: Optional[str] = None
        self._seq = 0
        self._lock = threading.Lock()
        self._aborted = False
        self._closing = False
        self._store = None
        if not self.n_followers:
            return
        port = [0]
        if self.coordinator:
            self._store = dist.TCPStore("127.0.0.1", 0, None, True,
                                        wait_for_workers=False,
                                        timeout=STORE_TIMEOUT)
            port = [self._store.port]
        dist.broadcast_object_list(port, src=dist.get_global_rank(
            tp.group, 0), group=tp.group)
        if self.coordinator:
            # every follower is connected before the channel is used (or
            # dropped: the store lives in this process)
            self._wait_count("joined", self.n_followers)
        else:
            self._store = dist.TCPStore("127.0.0.1", port[0], None, False,
                                        wait_for_workers=False,
                                        timeout=STORE_TIMEOUT)
            self._store.add("joined", 1)
            self._store.set_timeout(FOLLOWER_WAIT)
        if not self.coordinator and dist.get_backend(tp.group) == "gloo":
            # a gloo follower's collective fails as soon as the failed
            # rank's connections close: it needs no watcher
            return
        # the watcher's own connection: a follower's main thread blocks in
        # its reads
        watch = dist.TCPStore("127.0.0.1", port[0], None, False,
                              wait_for_workers=False, timeout=FOLLOWER_WAIT)
        self._watcher = threading.Thread(target=self._watch, args=(watch,),
                                         name="mesh-watch", daemon=True)
        with _WATCHED_LOCK:
            _WATCHED.add(self)
        self._watcher.start()

    def _wait_count(self, key: str, n: int) -> None:
        deadline = time.monotonic() + STORE_TIMEOUT.total_seconds()
        while self._store.add(key, 0) < n:
            if time.monotonic() > deadline:
                raise TimeoutError(f"mesh channel: {self._store.add(key, 0)}"
                                   f" of {n} followers reached {key!r}")
            time.sleep(0.001)
        self._store.set(key, "0")

    def _watch(self, store) -> None:
        """The coordinator, and a follower over NCCL: wait for another
        rank's failure (:meth:`fail`); then mark the mesh failed and abort
        this rank's group, so a collective or a sync waiting on the lost
        rank ends.  The coordinator also publishes ``"abort"``, which ends
        the replay of a follower waiting for its next operation.  A clean
        :meth:`stop` wakes it with an empty reason."""
        try:
            while not store.check(["failed"]):
                if self._closing:
                    return
                time.sleep(WATCH_POLL_S)
            why = store.get("failed").decode()
        except Exception:  # noqa: BLE001 - the store closed: process exit
            return
        finally:
            with _WATCHED_LOCK:
                _WATCHED.discard(self)
        if why and self.failure is None:
            self.failure = why
            _log.error("mesh failed: %s", why)
            try:
                if self.coordinator:
                    self._publish("abort", why)
            finally:
                self._abort()

    def _abort(self) -> None:
        """Abort this rank's group, once."""
        with self._lock:
            if self._aborted:
                return
            self._aborted = True
        abort_group(self.tp.group)

    def check(self) -> None:
        """Raise :class:`MeshFailure` once the mesh has failed."""
        if self.failure is not None:
            raise MeshFailure(self.failure)

    def run(self, op: str, fn, *args, **kw):
        """``fn(*args, **kw)``, replicated: the coordinator publishes
        ``op`` with the arguments first.  Under followers an exception
        inside is fatal to the mesh (:meth:`fail`) and comes out as
        :class:`MeshFailure`; with none, it passes through as it is."""
        self.publish(op, *args, **kw)
        if not self.n_followers:
            return fn(*args, **kw)
        try:
            return fn(*args, **kw)
        except Exception as e:
            why = (f"{'coordinator' if self.coordinator else 'follower'} "
                   f"rank {self.tp.rank}: {op} failed: "
                   f"{type(e).__name__}: {e}")
            self.fail(why)
            raise MeshFailure(self.failure) from e

    def fail(self, why: str) -> None:
        """Mark the mesh failed and abort this rank's group.  ``why`` goes
        to the store, where every other rank's watcher reads it; the
        coordinator also tells every follower to end its replay.  A
        failure already recorded keeps its reason."""
        try:
            if self.failure is None:
                self.failure = why
                _log.error("mesh failed: %s", why)
                self._store.set("failed", why)
                if self.coordinator:
                    self._publish("abort", why)
        finally:
            self._abort()   # once, whoever recorded the failure first

    def publish(self, op: str, *args, **kw) -> None:
        """Coordinator: queue ``op(*args, **kw)`` for every follower (host
        values only); raises :class:`MeshFailure` once the mesh has
        failed.  A no-op without followers, and on a follower (which is
        replaying the operation it read)."""
        if not self.n_followers or not self.coordinator:
            return
        self.check()
        self._publish(op, *args, **kw)

    def _publish(self, op: str, *args, **kw) -> None:
        blob = pickle.dumps((op, args, kw), protocol=pickle.HIGHEST_PROTOCOL)
        with self._lock:
            self._seq += 1
            self._store.multi_set(
                [f"{r}/{self._seq}" for r in range(1, self.tp.size)],
                [blob] * self.n_followers)

    def next(self):
        """Follower: the coordinator's next ``(op, args, kw)``, in order
        (blocks while the coordinator is idle).  Reading ``"stop"``
        acknowledges it (:meth:`stop`); reading ``"abort"`` (the
        coordinator's :meth:`fail`) aborts this rank's group and raises
        :class:`MeshFailure`."""
        self._seq += 1
        key = f"{self.tp.rank}/{self._seq}"
        blob = self._store.get(key)
        self._store.delete_key(key)
        msg = pickle.loads(blob)
        if msg[0] == "stop":
            self._store.add("stopped", 1)
        elif msg[0] == "abort":
            self.failure = self.failure or msg[1][0]
            self._abort()
            raise MeshFailure(self.failure)
        return msg

    def stop(self) -> None:
        """Coordinator: publish ``"stop"`` and return once every follower
        has read it (the store lives in this process: it must outlast
        their last read); then end the watcher and the store.  Nothing to
        stop once the mesh has failed (the followers ended their
        replay)."""
        if not self.n_followers or self.failure is not None:
            return
        self.publish("stop")
        self._wait_count("stopped", self.n_followers)
        # wake every watcher with no reason (a failure, set first, stays)
        self._store.compare_set("failed", "", "")
        # the store's server ends now, while the interpreter runs: a server
        # still alive when the process finalizes aborts it (seen on the
        # card, the coordinator rank exiting -6 after its work was done)
        self._watcher.join(timeout=1.0)
        self._store = None


def local_params(tree: Dict[str, Any], mesh, device) -> Dict[str, Any]:
    """This rank's Megatron shards of a served tree, on ``device``: a tree
    of DTensors gives its local shards; a tree of whole tensors (on the
    host or the card) is cut leaf by leaf BEFORE it moves, so only the
    shard reaches the device.  Placements are tpulab's rules
    (:func:`~tpulab_torch.parallel.sharding.transformer_param_shardings`).
    Weight-only int8 trees are refused under a mesh."""
    from torch.distributed.tensor import DTensor

    from tpulab_torch.parallel.sharding import (local_slice,
                                                transformer_param_shardings)

    def walk(node):
        if isinstance(node, dict):
            if "w_int8" in node:
                raise NotImplementedError(
                    "weight-only int8 trees under a mesh are not ported to "
                    "tpulab_torch (ROADMAP queue 1, parallelism, item 5: "
                    "the sharded batcher's later items)")
            for v in node.values():
                walk(v)
    walk(tree)
    rules = transformer_param_shardings(tree, mesh)

    def leaf(x, placements):
        if not isinstance(x, torch.Tensor):
            return x
        if isinstance(x, DTensor):
            if tuple(x.placements) != tuple(placements):
                raise ValueError(f"a DTensor leaf laid out {x.placements}, "
                                 f"want tpulab's {placements}")
            return x.to_local().to(device)
        return local_slice(x, mesh, placements).to(device).contiguous()

    from tpulab_torch.parallel.sharding import map_tree
    return map_tree(leaf, tree, rules)


def init_transformer_shards(mesh, vocab: int, d_model: int, n_heads: int,
                            n_layers: int, d_ff: int, seed: int = 0,
                            n_kv_heads: Optional[int] = None,
                            ffn: str = "gelu", tie_embeddings: bool = True,
                            dtype=torch.bfloat16) -> Dict[str, Any]:
    """:func:`~tpulab_torch.models.transformer.init_transformer_params`'s
    weights (the same draws from the same seeded generator, on this rank's
    device), cut to this rank's Megatron shards leaf by leaf: each whole
    leaf lives only while its shard is copied out, so no rank ever holds
    the whole tree.  Returns a tree of DTensors (their local shards are
    what :class:`~tpulab_torch.engine.paged.ContinuousBatcher` serves)."""
    from torch.distributed.tensor import DTensor

    from tpulab_torch.parallel.sharding import (_contiguous_strides,
                                                _param_spec, local_slice,
                                                named_sharding)

    dev = mesh_device(mesh)
    n_kv = n_kv_heads or n_heads
    if n_heads % n_kv:
        raise ValueError(f"n_heads {n_heads} not divisible by "
                         f"n_kv_heads {n_kv}")
    head_dim = d_model // n_heads
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def cut(path, full):
        placements = named_sharding(mesh, *_param_spec(path, "model"))
        local = local_slice(full, mesh, placements).clone(
            memory_format=torch.contiguous_format)
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=full.shape,
                                  stride=_contiguous_strides(full.shape))

    def normal(path, *shape):
        w = torch.empty(shape, dtype=dtype, device=dev)
        return cut(path, w.normal_(0.0, 0.02, generator=gen))

    def ones(path, n):
        return cut(path, torch.ones((n,), dtype=dtype, device=dev))

    # init_transformer_params's draw order: embed, each layer's wqkv, wo,
    # w1, w2 (w3), then lm_head
    tree: Dict[str, Any] = {"embed": normal("/embed", vocab, d_model),
                            "final_norm": {"scale": ones(
                                "/final_norm/scale", d_model)}}
    for i in range(n_layers):
        pre = f"/layer{i}/"
        layer = {"ln1": {"scale": ones(pre + "ln1/scale", d_model)},
                 "ln2": {"scale": ones(pre + "ln2/scale", d_model)},
                 "wqkv": normal(pre + "wqkv", d_model,
                                (n_heads + 2 * n_kv) * head_dim),
                 "wo": normal(pre + "wo", d_model, d_model),
                 "w1": normal(pre + "w1", d_model, d_ff),
                 "w2": normal(pre + "w2", d_ff, d_model)}
        if ffn == "swiglu":
            layer["w3"] = normal(pre + "w3", d_model, d_ff)
        tree[f"layer{i}"] = layer
    if not tie_embeddings:
        tree["lm_head"] = normal("/lm_head", d_model, vocab)
    return tree


def benchmark_sharded_decode(model_shards: int = 2, lanes: int = 4,
                             steps: int = 32, prompt_len: int = 8,
                             d_model: int = 64, n_heads: int = 4,
                             n_layers: int = 2, vocab: int = 256,
                             decode_block: int = 8, dtype=None,
                             n_kv_heads: Optional[int] = None,
                             d_ff: Optional[int] = None, ffn: str = "gelu",
                             tie_embeddings: bool = True,
                             rope_theta: Optional[float] = None,
                             page_size: int = 8,
                             max_len: Optional[int] = None,
                             single: bool = True,
                             mesh=None) -> Optional[Dict[str, Any]]:
    """Served tok/s and host-sync accounting of ONE ContinuousBatcher
    workload on a ``{"model": M}`` mesh against ``mesh=None`` (tpulab's
    bench ``sharded_decode`` row).

    Every rank of the job calls it (one process per card, the group
    open); the coordinator returns the row, the followers None.
    ``single=True`` builds the whole tree (seed 0) on every rank
    and serves it twice: alone on the coordinator, then sharded; the row
    holds greedy and device-sampled parity.  ``single=False`` draws each
    rank's shards on its own card (:func:`init_transformer_shards`: no
    rank holds the whole tree) and serves the workload twice on the mesh;
    ``repeat_parity`` says the second run gave the same tokens.  Each mode
    warms once, then times the same ``lanes`` requests.  The second mode's
    timed drive runs under a CUDA ``torch.profiler`` session: its
    ``busy`` is the share of that wall the coordinator's card spent in
    kernels (None for the first mode, and on the CPU: not measured)."""
    from tpulab_torch.engine.paged import ContinuousBatcher, SamplingParams
    from tpulab_torch.models.transformer import init_transformer_params
    from tpulab_torch.parallel.mesh import axis_index, make_mesh

    dtype = dtype or torch.float32
    d_ff = d_ff or 4 * d_model
    if mesh is None:
        mesh = make_mesh({"model": model_shards})
    coordinator = axis_index(mesh, "model") == 0
    dev = mesh_device(mesh)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, (prompt_len,), np.int32)
               for _ in range(lanes)]
    max_len = max_len or prompt_len + steps + 8
    geo = dict(n_heads=n_heads, n_layers=n_layers, n_kv_heads=n_kv_heads,
               rope_theta=rope_theta, lanes=lanes, max_len=max_len,
               page_size=page_size, compute_dtype=dtype,
               decode_block=decode_block, device=dev)
    row: Dict[str, Any] = {"lanes": lanes, "steps": steps,
                           "mesh": {"model": model_shards},
                           "decode_block": decode_block}
    if single:
        params = init_transformer_params(
            vocab, d_model, n_heads, n_layers, d_ff, n_kv_heads=n_kv_heads,
            ffn=ffn, tie_embeddings=tie_embeddings, device=dev, dtype=dtype)
        modes = (("single", None), ("sharded", mesh))
    else:
        params = init_transformer_shards(
            mesh, vocab, d_model, n_heads, n_layers, d_ff,
            n_kv_heads=n_kv_heads, ffn=ffn, tie_embeddings=tie_embeddings,
            dtype=dtype)
        modes = (("sharded", mesh), ("again", mesh))
    outs: Dict[str, Any] = {}
    sampled: Dict[str, Any] = {}
    for mode, m in modes:
        if m is None and not coordinator:
            continue
        cb = ContinuousBatcher(params, mesh=m, **geo)
        try:
            if not cb.is_coordinator:
                continue
            for f in [cb.submit(p, steps) for p in prompts]:
                f.result(timeout=3600)
            d0, s0 = cb.decode_dispatches, cb.decode_host_syncs
            tg0, fw0 = cb.tokens_generated, cb.forward_steps
            with _busy_window(dev, mode == modes[-1][0]) as busy:
                t0 = time.perf_counter()
                futs = [cb.submit(p, steps) for p in prompts]
                outs[mode] = [list(f.result(timeout=3600)) for f in futs]
                dt = time.perf_counter() - t0
            toks = cb.tokens_generated - tg0
            row[mode] = {
                "tok_s": toks / max(dt, 1e-9),
                "wall_s": dt,
                "dispatches": cb.decode_dispatches - d0,
                "host_syncs": cb.decode_host_syncs - s0,
                "forward_steps": cb.forward_steps - fw0,
                "syncs_per_token": (cb.decode_host_syncs - s0)
                / max(toks, 1),
                "busy": busy.share(dt),
            }
            sampled[mode] = list(cb.submit(
                prompts[0], steps,
                sampling=SamplingParams(temperature=0.8, seed=1234,
                                        device=True)).result(timeout=3600))
            row[mode]["forward_steps_total"] = cb.forward_steps
        finally:
            cb.shutdown()
    if not coordinator:
        return None
    a, b = (m for m, _ in modes)
    row["parity" if single else "repeat_parity"] = outs[b] == outs[a]
    row["sampled_parity" if single else "repeat_sampled_parity"] = (
        sampled[b] == sampled[a])
    # the sharding contract is per dispatch: every dispatch costs one
    # blocking fetch in both modes
    row["one_sync_per_dispatch"] = all(
        row[m]["host_syncs"] == row[m]["dispatches"] for m, _ in modes)
    if single:
        row["uplift"] = row["sharded"]["tok_s"] / max(
            row["single"]["tok_s"], 1e-9)
    return row


class _Busy:
    def __init__(self):
        self.prof = None

    def share(self, wall_s: float) -> Optional[float]:
        """The union of the device kernels' intervals over ``wall_s``
        (None off the card: not measured)."""
        if self.prof is None:
            return None
        from tpulab_torch.utils.tracing import device_busy_ms
        return device_busy_ms(self.prof) / 1e3 / max(wall_s, 1e-9)


@contextlib.contextmanager
def _busy_window(dev, on: bool):
    """With ``on``, a CUDA ``torch.profiler`` session around the timed
    drive on the card (the kernels of the scheduler thread included);
    nothing on the CPU."""
    busy = _Busy()
    if dev.type != "cuda" or not on:
        yield busy
        return
    from torch.profiler import ProfilerActivity

    from tpulab_torch.utils.tracing import profiler_session
    with profiler_session(activities=[ProfilerActivity.CUDA]) as prof:
        yield busy
    busy.prof = prof
