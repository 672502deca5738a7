"""Prefix-cache-aware multi-replica routing.

A copy of scaletorch_tpu/serving/router.py over the port's logger: the
chunk hashes and the rendezvous choice are the reference's, byte for
byte.

With N engine replicas behind one gateway, WHERE a request lands decides
whether its prompt prefix is a radix-tree hit or a cold prefill: the
replica that served the last request with this system prompt already
holds those pages (inference/kv_cache.RadixPrefixCache), every other
replica would prefill them again. So the routing key IS the radix tree's
chunk identity — the page-aligned token chunks of the prompt, hashed
cumulatively (chunk i's hash folds in chunk i-1's), which makes two
prompts collide exactly when they share a page-aligned prefix, the same
granularity at which the tree can share pages.

Routing walks the request's chunk-hash chain through a learned
owner map (deepest known hash wins — the replica that most recently
served the LONGEST matching prefix), falls back to rendezvous (highest-
random-weight) hashing on the first chunk for cold prefixes — so
repeats of a brand-new system prompt still converge on one replica
without any coordination — and on the full prompt for sub-page prompts.

Replica health rides the exit-code contract (docs/fault_tolerance.md):
``report_exit(replica, code)`` with 0 = clean drain (leaves rotation
quietly), 42/43/44 or any other non-zero = dead (ejected, its owner-map
entries lazily dropped, its in-flight work the gateway's to abort). The
same slice-to-slice page-affinity key is the substrate the MPMD
disaggregation direction needs (ROADMAP: page handoff between slices).

Pure host-side stdlib — no torch; the gateway and the tests drive it
directly.
"""

from __future__ import annotations

import hashlib
import math
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from scaletorch_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

# Exit codes that mean "replica crashed" (the 0/42/43/44 contract;
# anything non-zero ejects, these get named in the log line).
CRASH_EXIT_CODES = {
    42: "training divergence",
    43: "hang watchdog",
    44: "serving stall watchdog",
}


def page_chunk_hashes(prompt: Sequence[int], page_size: int,
                      *, max_chunks: int = 32) -> List[str]:
    """Cumulative hashes of the prompt's page-aligned chunks — the
    routing key chain. ``hashes[i]`` identifies the first ``(i+1) *
    page_size`` tokens, so a shared system prompt shares a hash PREFIX
    of the chain exactly as it shares a page-aligned path in the radix
    tree. Only full pages hash (the tree only registers frozen full
    pages); ``max_chunks`` caps the chain — prefix reuse lives at the
    head of the prompt, and an unbounded chain would make the owner map
    O(prompt) per request."""
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    out: List[str] = []
    h = hashlib.sha1()
    n_full = min(len(prompt) // page_size, max_chunks)
    for c in range(n_full):
        chunk = prompt[c * page_size:(c + 1) * page_size]
        h.update(b"|".join(str(t).encode() for t in chunk) + b";")
        out.append(h.hexdigest())
    return out


def _rendezvous(key: str, replicas: Sequence[str]) -> str:
    """Highest-random-weight hash: stable under replica set changes —
    only the keys owned by a removed replica move."""
    return max(
        replicas,
        key=lambda r: hashlib.sha1(f"{key}@{r}".encode()).digest(),
    )


def _hash_unit(key: str, replica: str) -> float:
    """Deterministic uniform in (0, 1) for one (key, replica) pair —
    the rendezvous hash as a float, for weighting."""
    digest = hashlib.sha1(f"{key}@{replica}".encode()).digest()
    return (int.from_bytes(digest[:8], "big") + 1) / float(2**64 + 2)


def _weighted_rendezvous(key: str, weights: Dict[str, float]) -> str:
    """Weighted HRW (Schindelhauer/Schomaker logarithmic method): pick
    ``argmax -w_r / ln(u_r)``. Reduces to plain rendezvous for equal
    weights and keeps HRW's minimal-disruption property — only the
    share proportional to a weight change moves."""
    best, best_score = None, None
    for replica, weight in weights.items():
        u = _hash_unit(key, replica)
        score = -max(weight, 1e-6) / math.log(u)
        if best_score is None or score > best_score \
                or (score == best_score and replica < best):
            best, best_score = replica, score
    return best


@dataclass
class ReplicaState:
    """Router-side view of one replica."""

    replica_id: str
    healthy: bool = True
    exit_code: Optional[int] = None
    dispatched: int = 0
    routed_by_prefix: int = 0    # landed via a learned owner-map entry
    routed_by_headroom: int = 0  # placed by the free-page weighting
    rejoins: int = 0             # restarts that re-entered rotation
    extra: dict = field(default_factory=dict)


class PrefixAwareRouter:
    """Route requests to the replica whose radix tree holds their
    prefix; rendezvous-hash cold prefixes; eject dead replicas.

    ``prefix_aware=False`` degrades to consistent hashing of the FULL
    prompt — the baseline the acceptance test beats: identical prompts
    still stick, but prompts sharing only a *prefix* scatter, so the
    per-replica radix trees never concentrate a shared system prompt.
    """

    def __init__(
        self,
        replica_ids: Sequence[str],
        page_size: int,
        *,
        prefix_aware: bool = True,
        max_tracked_prefixes: int = 65536,
        max_chunks: int = 32,
        headroom_spread: float = 0.25,
        headroom_floor: float = 0.10,
    ) -> None:
        if not replica_ids:
            raise ValueError("router needs at least one replica")
        if len(set(replica_ids)) != len(replica_ids):
            raise ValueError(f"duplicate replica ids: {list(replica_ids)}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self.prefix_aware = prefix_aware
        self.max_chunks = max_chunks
        # page-headroom-aware placement: when the fleet's free-page
        # fractions diverge by >= headroom_spread, cold prefixes pick
        # by WEIGHTED rendezvous (weight = free fraction) and a prefix-
        # affine target squeezed under headroom_floor while another
        # replica has real room is overridden — affinity must not pack
        # a replica into page exhaustion while its peers sit empty
        self.headroom_spread = headroom_spread
        self.headroom_floor = headroom_floor
        self.replicas: Dict[str, ReplicaState] = {
            rid: ReplicaState(replica_id=rid) for rid in replica_ids}
        # chunk hash -> replica id, LRU-bounded (move_to_end on touch)
        self._owners: "OrderedDict[str, str]" = OrderedDict()
        self._max_tracked = max_tracked_prefixes

    # -- membership --------------------------------------------------------
    def alive(self) -> List[str]:
        return [rid for rid, st in self.replicas.items() if st.healthy]

    def mark_dead(self, replica_id: str,
                  exit_code: Optional[int] = None) -> None:
        """Eject a replica (exit-code contract or an observed failure).
        Its owner-map entries are dropped so sticky prefixes re-route
        to a survivor on their next arrival."""
        st = self.replicas[replica_id]
        if not st.healthy:
            return
        st.healthy = False
        st.exit_code = exit_code
        reason = CRASH_EXIT_CODES.get(exit_code, "unhealthy") \
            if exit_code is not None else "unhealthy"
        logger.warning(
            "router: replica %s ejected (%s%s); %d remain",
            replica_id, reason,
            f", exit {exit_code}" if exit_code is not None else "",
            len(self.alive()),
        )
        stale = [k for k, v in self._owners.items() if v == replica_id]
        for k in stale:
            del self._owners[k]

    def rejoin(self, replica_id: str) -> None:
        """Return a restarted replica to rotation. It re-enters with no
        owner-map entries (``mark_dead``/``report_exit`` dropped them
        at death) — cold, unless the gateway's best-effort warmup
        lands, in which case ``learn_owner`` re-teaches the warmed
        chains and affinity resumes without waiting on live traffic."""
        st = self.replicas[replica_id]
        if st.healthy:
            return
        st.healthy = True
        st.exit_code = None
        st.rejoins += 1
        logger.info("router: replica %s rejoined rotation "
                    "(%d alive)", replica_id, len(self.alive()))

    def learn_owner(self, prompt: Sequence[int], replica_id: str) -> None:
        """Teach the owner map that ``replica_id`` holds this prompt's
        page-aligned prefix — the warm-rejoin path: a restarted replica
        that imported a donor's chains owns them NOW, so post-restart
        affinity resumes immediately instead of re-learning from (and
        cold-prefilling) live traffic. Overwrites any previous owner:
        the warmed replica is the freshest holder and the deepest-owner
        rule keeps routing correct for longer chains."""
        if not self.prefix_aware:
            return
        st = self.replicas.get(replica_id)
        if st is None or not st.healthy:
            return
        for h in page_chunk_hashes(prompt, self.page_size,
                                   max_chunks=self.max_chunks):
            self._owners[h] = replica_id
            self._owners.move_to_end(h)
        while len(self._owners) > self._max_tracked:
            self._owners.popitem(last=False)

    def report_exit(self, replica_id: str, exit_code: int) -> None:
        """Apply the 0/42/43/44 exit-code contract: 0 is a clean drain
        (the replica leaves rotation without alarm), anything else is a
        crash ejection."""
        if exit_code == 0:
            st = self.replicas[replica_id]
            st.healthy = False
            st.exit_code = 0
            stale = [k for k, v in self._owners.items() if v == replica_id]
            for k in stale:
                del self._owners[k]
            logger.info("router: replica %s drained cleanly (exit 0)",
                        replica_id)
        else:
            self.mark_dead(replica_id, exit_code)

    # -- routing -----------------------------------------------------------
    def route(self, prompt: Sequence[int],
              headroom: Optional[Dict[str, float]] = None) -> str:
        """Pick the replica for one request and learn from the choice.
        Raises ``NoReplicaAvailable`` when every replica is gone.

        ``headroom`` maps replica id -> free-page FRACTION (the
        ``page_pool_free`` gauge already riding replica metrics). While
        the fleet is balanced it changes nothing — prefix affinity and
        plain rendezvous decide. When the pools DIVERGE (spread >=
        ``headroom_spread``), cold placements weight the rendezvous
        choice by free fraction, and a prefix-affine target squeezed
        under ``headroom_floor`` (while some replica still has more
        than the floor free) is re-placed by the same weighting — a
        popular prefix must not ride affinity into page exhaustion."""
        alive = self.alive()
        if not alive:
            raise NoReplicaAvailable("no healthy replica in rotation")
        chain = (
            page_chunk_hashes(prompt, self.page_size,
                              max_chunks=self.max_chunks)
            if self.prefix_aware else []
        )
        hr = {r: headroom[r] for r in alive
              if headroom is not None and r in headroom}
        imbalanced = (len(hr) >= 2
                      and max(hr.values()) - min(hr.values())
                      >= self.headroom_spread)
        chosen: Optional[str] = None
        via_prefix = False
        via_headroom = False
        # deepest learned owner wins: the replica whose tree holds the
        # LONGEST registered prefix of this prompt
        for h in reversed(chain):
            owner = self._owners.get(h)
            if owner is not None and self.replicas[owner].healthy:
                chosen = owner
                via_prefix = True
                break
        if via_prefix and imbalanced \
                and hr.get(chosen, 1.0) < self.headroom_floor \
                and max(hr.values()) >= self.headroom_floor:
            # affinity override: the owner is nearly out of pages and a
            # peer has real room — a cold prefill beats a shed
            chosen = None
            via_prefix = False
        if chosen is None:
            # cold prefix: rendezvous on the FIRST chunk so future
            # requests sharing the head converge without coordination;
            # sub-page prompts (no chunks) key on the whole prompt.
            # prefix_aware=False keys on the whole prompt always — the
            # consistent-hash-only baseline.
            key = chain[0] if chain else "|".join(str(t) for t in prompt)
            if imbalanced:
                # a replica with no gauge yet (just rejoined, first
                # poll pending) weighs in at the fleet mean — neither
                # starved nor flooded until its numbers arrive
                mean_free = sum(hr.values()) / len(hr)
                chosen = _weighted_rendezvous(
                    key, {r: hr.get(r, mean_free) for r in alive})
                via_headroom = True
            else:
                chosen = _rendezvous(key, alive)
        st = self.replicas[chosen]
        st.dispatched += 1
        if via_prefix:
            st.routed_by_prefix += 1
        if via_headroom:
            st.routed_by_headroom += 1
        if self.prefix_aware:
            # the chosen replica's tree will hold every full page of
            # this prompt once its prefill registers — learn the chain
            for h in chain:
                self._owners[h] = chosen
                self._owners.move_to_end(h)
            while len(self._owners) > self._max_tracked:
                self._owners.popitem(last=False)
        return chosen

    # -- metrics -----------------------------------------------------------
    def snapshot(self) -> Dict[str, float]:
        """Flat numeric gauges for the gateway metrics surface."""
        alive = self.alive()
        dispatched = sum(s.dispatched for s in self.replicas.values())
        by_prefix = sum(s.routed_by_prefix for s in self.replicas.values())
        by_headroom = sum(
            s.routed_by_headroom for s in self.replicas.values())
        rejoins = sum(s.rejoins for s in self.replicas.values())
        snap: Dict[str, float] = {
            "router_replicas_alive": float(len(alive)),
            "router_replicas_dead": float(
                len(self.replicas) - len(alive)),
            "router_dispatched": float(dispatched),
            "router_routed_by_prefix": float(by_prefix),
            "router_routed_by_headroom": float(by_headroom),
            "router_rejoins": float(rejoins),
            "router_prefix_route_rate": (
                by_prefix / dispatched if dispatched else 0.0),
            "router_tracked_prefixes": float(len(self._owners)),
        }
        for rid, st in self.replicas.items():
            snap[f"router_dispatched_{rid}"] = float(st.dispatched)
        return snap


class NoReplicaAvailable(RuntimeError):
    """Every replica is dead or drained — the gateway answers 503."""
