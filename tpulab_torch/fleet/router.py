"""Prefix-affinity fleet routing: rendezvous (HRW) hashing over the
prompt-prefix digest, with load-aware spill-over (the port of
``tpulab/fleet/router.py``: digests and rankings equal tpulab's byte for
byte).

The reference scales out behind an L7 balancer (examples/99's envoy) whose
default policies are load-only — fine for stateless dense inference, wrong
for LLM serving where every replica carries a ref-counted prefix cache
(engine/paged.py ``PrefixCache``): a returning user landing on a random
replica re-prefills a prompt some other replica already holds, so
fleet-wide prefix-cache hit rates collapse as the fleet widens (ROADMAP
item 1).  This module is the routing half of the fleet layer: requests
whose prompts share a prefix hash to the same *home* replica, so the
fleet behaves like one large prefix cache instead of N cold ones.

Why rendezvous (highest-random-weight) hashing rather than the modulo
hash the first-cut affinity used: membership changes.  An autoscaler adds
and drains replicas (tpulab/fleet/autoscaler.py); under ``hash % N`` a
membership change remaps ~every digest, evicting the whole fleet's cache
warmth at once, while HRW moves only the ~1/N of digests whose winning
member left (or whose new winner just joined) — each (digest, member)
pair scores independently, so removing a member only re-homes the
digests it was winning.  The router *measures* that contract: it keeps a
bounded sample of recently routed digests and counts how many re-home on
each membership change (``ring_moves``), so "scale-down evicted the
fleet's warmth" is an observable regression, not a guess.

Affinity is a PREFERENCE, not a pin (the same contract the in-set
affinity always had): the winner is skipped — *spilled* — when its
reported load gauges say it is hot (local inflight beyond
``inflight_slack`` over the least-loaded member, server-reported queue
depth at/over ``spill_queue_depth``, free HBM under
``min_free_hbm_bytes``; the gauges ``poll_load`` already refreshes), and
the request falls to the next hash rank.  A hot prefix therefore warms a
*stable second* replica rather than hot-spotting its home.  Breaker-open,
draining and retired replicas are excluded from the ring by the caller
(:meth:`tpulab_torch.rpc.replica.GenerationReplicaSet._pick_affine`) — a
draining replica must finish what it has, never gain work.

The ``fleet.route`` chaos trip point (tpulab_torch.chaos, docs/ROBUSTNESS.md)
sits at the head of the affinity decision: ``error`` fails that routing
decision and the pick degrades to the existing load-based selection;
``drop`` disables affinity for that request (same fallback, distinct
evidence) — either way the request is served, affinity can only ever be
forgone, never strand traffic.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Sequence

__all__ = ["prefix_digest", "PrefixAffinityRouter"]


def prefix_digest(prompt: Sequence[int], affinity_tokens: int = 32) -> bytes:
    """Digest of the first ``affinity_tokens`` token ids — the same
    token-prefix hashing discipline the in-engine prefix cache uses
    (engine/paged.py ``PrefixCache._digests``: blake2b over token bytes),
    so two prompts that would share cache pages also share a home."""
    h = hashlib.blake2b(digest_size=16)
    for t in prompt[:affinity_tokens]:
        h.update(int(t).to_bytes(4, "little", signed=True))
    return h.digest()


class PrefixAffinityRouter:
    """Rendezvous-hash ranking of fleet members per prompt digest, plus
    the spill policy and the ring-movement observability.

    Pure policy object: it never talks to replicas — the replica set
    hands it digests, member keys and load gauges and applies the
    returned ranking.  Thread-safe (one lock around the sample map);
    counters are plain ints for test assertions, mirrored to an optional
    :class:`tpulab_torch.utils.metrics.ReplicaSetMetrics`."""

    #: bounded sample of recently routed digests (digest -> last home);
    #: the measurement base for ``ring_moves`` on membership changes
    SAMPLE_CAP = 512

    def __init__(self, affinity_tokens: int = 32, inflight_slack: int = 2,
                 spill_queue_depth: Optional[int] = None,
                 min_free_hbm_bytes: int = 0, metrics=None):
        self.affinity_tokens = int(affinity_tokens)
        #: winner skipped when its local inflight exceeds the least-loaded
        #: member's by more than this (the original affinity_slack rule)
        self.inflight_slack = int(inflight_slack)
        #: winner skipped when its server-reported queue depth
        #: (StatusResponse.queued_requests via poll_load) reaches this;
        #: None disables the signal
        self.spill_queue_depth = spill_queue_depth
        #: winner skipped when its reported free_hbm_bytes (arbiter
        #: replicas only; None = replica reports no arbiter) is below
        #: this; 0 disables the signal
        self.min_free_hbm_bytes = int(min_free_hbm_bytes)
        self._metrics = metrics
        self._lock = threading.Lock()
        self._members: frozenset = frozenset()
        self._homes: "OrderedDict[bytes, str]" = OrderedDict()
        #: requests that landed on their affinity winner
        self.affinity_hits = 0
        #: requests whose winner was skipped for load (spilled to a
        #: lower hash rank)
        self.affinity_spills = 0
        #: sampled digests re-homed by membership changes (the HRW
        #: minimal-movement contract, measured)
        self.ring_moves = 0

    # -- the hash -----------------------------------------------------------
    @staticmethod
    def _score(digest: bytes, member: str) -> int:
        h = hashlib.blake2b(digest, digest_size=8)
        h.update(member.encode())
        return int.from_bytes(h.digest(), "little")

    def rank(self, digest: bytes, members: Sequence[str]) -> List[str]:
        """Members ordered by rendezvous score for ``digest`` (rank 0 =
        the affinity winner).  Deterministic: ties (astronomically rare)
        break on the member key itself."""
        return sorted(members,
                      key=lambda m: (self._score(digest, m), m),
                      reverse=True)

    def ranked(self, digest: bytes,
               members: Optional[Iterable[str]] = None) -> List[str]:
        """The one public HRW ranking every consumer shares: replica-set
        picks (`_pick_affine`/`_hedge_pick`), the disagg handoff's home
        resolution and the fleet KV fabric all key off THIS ordering — re-deriving it per call site risks the orderings
        drifting apart, and then "the fabric's home" is not "the
        router's home".

        ``members`` defaults to the membership last recorded by
        :meth:`note_membership`.  Member keys are canonicalized (sorted)
        before scoring so callers need not pre-sort: identical member
        SETS always produce the identical ranking."""
        if members is None:
            with self._lock:
                members = self._members
        return self.rank(digest, sorted(members))

    # -- membership / movement accounting -----------------------------------
    def note_membership(self, members: Iterable[str]) -> int:
        """Record the current ring membership; on a change, re-home the
        sampled digests and count how many moved (the rendezvous
        minimal-movement contract, measured).  Returns the move count."""
        ms = frozenset(members)
        with self._lock:
            if ms == self._members:
                return 0
            moves = 0
            if self._members and ms:
                ordered = sorted(ms)
                for dig, home in self._homes.items():
                    new_home = self.rank(dig, ordered)[0]
                    if new_home != home:
                        self._homes[dig] = new_home
                        moves += 1
            self._members = ms
            self.ring_moves += moves
        if moves and self._metrics is not None \
                and hasattr(self._metrics, "note_ring_moves"):
            self._metrics.note_ring_moves(moves)
        return moves

    def _remember(self, digest: bytes, home: str) -> None:
        with self._lock:
            self._homes[digest] = home
            self._homes.move_to_end(digest)
            while len(self._homes) > self.SAMPLE_CAP:
                self._homes.popitem(last=False)

    # -- the spill policy ---------------------------------------------------
    def should_spill(self, inflight: int, min_inflight: int,
                     queue_depth: int,
                     free_hbm_bytes: Optional[int]) -> bool:
        """True when a ranked member is too hot to take affinity traffic
        right now: the request falls to the next hash rank instead
        (affinity must never create a hot spot)."""
        if inflight > min_inflight + self.inflight_slack:
            return True
        if (self.spill_queue_depth is not None
                and queue_depth >= self.spill_queue_depth):
            return True
        if (self.min_free_hbm_bytes > 0 and free_hbm_bytes is not None
                and free_hbm_bytes < self.min_free_hbm_bytes):
            return True
        return False

    # -- outcome accounting (called by the replica set) ---------------------
    def note_routed(self, digest: bytes, picked: str, winner: str,
                    spilled: bool) -> None:
        """One affinity routing outcome: ``picked`` landed the request,
        ``winner`` was rank 0, ``spilled`` says the winner was skipped
        for load."""
        self._remember(digest, winner)
        m = self._metrics
        if picked == winner:
            with self._lock:
                self.affinity_hits += 1
            if m is not None and hasattr(m, "note_affinity"):
                m.note_affinity(hit=True)
        elif spilled:
            with self._lock:
                self.affinity_spills += 1
            if m is not None and hasattr(m, "note_affinity"):
                m.note_affinity(hit=False)

    def snapshot(self) -> Dict[str, int]:
        """Counters for tests/debugz."""
        with self._lock:
            return {"affinity_hits": self.affinity_hits,
                    "affinity_spills": self.affinity_spills,
                    "ring_moves": self.ring_moves,
                    "sampled_digests": len(self._homes),
                    "members": len(self._members)}
