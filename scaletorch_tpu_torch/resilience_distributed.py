"""Resilience across the training loop's threads and processes:
coordinated control decisions, elastic membership, the hang watchdog and
crash reports (counterpart of scaletorch_tpu/resilience_distributed.py).

  * ``DecisionBus`` — the object-collective pair every coordinated
    decision rides: ``torch.distributed`` object collectives over a gloo
    group (never NCCL), whose timeout bounds every wait; injectable, so
    tests can hand in any transport.
  * ``CoordinatedResilience`` — the layer the trainer talks to for every
    control decision. With more than one process (and ``ft_coordinate``)
    process 0 forms each decision from the gathered observations and
    broadcasts it, and every process executes the same action: one
    process's SIGTERM becomes a collective emergency save at one step,
    one process's NaN a fleet-wide skip, rollback or abort. With one
    process it passes through to the local ``ResilienceManager``.
  * ``ElasticCoordinator`` — the membership epoch state machine (steady →
    suspect → shrink → steady → grow) over a ``FileMembershipStore`` in
    the checkpoint directory: a collective that loses a participant
    raises ``PeerLostError``, the survivors agree a new epoch through a
    write-once epoch record, and the trainer re-forms its process group,
    rebuilds the mesh with dp absorbing the change and restores the
    newest checkpoint; a relaunched rank parks at the rejoin barrier and
    is readmitted at a checkpoint boundary. ``FileBus`` is the
    deadline-bounded file transport of the reference, with its file
    formats.
  * ``HangWatchdog`` — a background heartbeat thread. The train loop (or
    the engine) beats it at each phase; if no beat lands within the
    timeout it dumps every Python thread's stack, writes a crash report
    and exits with ``WATCHDOG_EXIT_CODE`` so a launcher restarts the job
    instead of waiting forever. It can fire while the main thread is
    blocked in a CUDA synchronisation only if that wait releases the GIL.
  * ``write_crash_report`` — one JSON post-mortem per abort path
    (sentinel abort, rollback budget exhausted, watchdog fired).

Exit-code contract (``launch.py`` reads it):

  * 0   — graceful, including a preempted run that saved its state
  * 42  — ``TrainingDivergedError`` (sentinel abort / budget exhausted)
  * 43  — hang watchdog fired, or ``ElasticRemeshError`` (restartable:
          state is on disk up to the last periodic or emergency
          checkpoint)
  * 44  — serving stall watchdog fired (``inference/resilience.py``
          ``make_serving_watchdog``: a wedged ``InferenceEngine.step()``)
  * 130 — operator KeyboardInterrupt
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import sys
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from scaletorch_tpu_torch.env import env_override
from scaletorch_tpu_torch.resilience import (
    ResilienceManager,
    TrainingDivergedError,
)
from scaletorch_tpu_torch.utils.logger import get_logger

DIVERGED_EXIT_CODE = 42
WATCHDOG_EXIT_CODE = 43
# a wedged InferenceEngine.step() (serving watchdog, inference/resilience.py)
SERVING_STALL_EXIT_CODE = 44


# --------------------------------------------------------------------------
# Decision transport
# --------------------------------------------------------------------------


@dataclass
class DecisionBus:
    """The collective pair every coordinated control decision rides.

    ``default(group)`` is the ``dist.py`` object collectives over a gloo
    group (the mesh's ``host_group()``); the group's timeout bounds every
    wait, so a dead peer surfaces as an exception, not a hang. Tests may
    inject any pair with the same contracts."""

    num_processes: int
    process_index: int
    all_gather: Callable[[Any], List[Any]]
    broadcast: Callable[[list], list]  # broadcast_object_list contract

    @classmethod
    def default(cls, group: Any = None) -> "DecisionBus":
        from scaletorch_tpu_torch import dist as stdist

        return cls(
            num_processes=stdist.process_count(group),
            process_index=stdist.process_index(group),
            all_gather=lambda obj: stdist.all_gather_object(obj, group=group),
            broadcast=lambda objs, src=0: stdist.broadcast_object_list(
                objs, src=src, group=group),
        )

    @property
    def is_main(self) -> bool:
        return self.process_index == 0

    def broadcast_from_main(self, obj: Any) -> Any:
        """Process 0's ``obj`` on every process (others' input is
        ignored)."""
        out = self.broadcast([obj if self.is_main else None])
        return out[0]

    def agree_all(self, flag: bool) -> bool:
        """True iff EVERY process contributed True."""
        return all(bool(x) for x in self.all_gather(bool(flag)))

    def agree_any(self, flag: bool) -> bool:
        """True iff ANY process contributed True."""
        return any(bool(x) for x in self.all_gather(bool(flag)))


# --------------------------------------------------------------------------
# Elastic membership (survive host loss by remeshing, not restarting)
# --------------------------------------------------------------------------


class PeerLostError(RuntimeError):
    """A collective lost a participant: a peer's contribution never
    landed within the deadline, or the transport reported the peer gone
    (a reset or closed gloo connection, a timed-out collective).
    With ``elastic`` the trainer's outer loop catches it and runs the
    membership recovery; otherwise it propagates."""

    def __init__(self, message: str, missing: tuple = ()) -> None:
        super().__init__(message)
        self.missing = tuple(missing)


class ElasticRemeshError(RuntimeError):
    """Elastic continuation is impossible (membership below
    ``elastic_min_hosts``, an un-shrinkable mesh, no epoch agreement or
    rendezvous within the deadline, a parked rank never admitted).
    ``train.py`` maps it to the restartable exit code 43, so the
    launcher's fleet restart takes over where remeshing gave up."""


@dataclass(frozen=True)
class MembershipView:
    """One membership epoch: which launch ranks are in the fleet."""

    epoch: int
    members: tuple  # sorted launch ranks

    @property
    def num_hosts(self) -> int:
        return len(self.members)

    def bus_index(self, rank: int) -> int:
        """This rank's process index WITHIN the epoch (process 0 of an
        epoch is its lowest surviving launch rank)."""
        return self.members.index(rank)


def _read_json(path: str) -> Optional[dict]:
    """A missing, torn or half-written file reads as None."""
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, ValueError):
        return None
    return obj if isinstance(obj, dict) else None


class FileMembershipStore:
    """Membership rendezvous over a shared directory (``<checkpoint_dir>/
    membership``). Four surfaces, each a per-rank file written
    atomically, in the reference's names and formats:

      * epoch records ``epoch_<n>.json`` — write-once (hard-link
        publish): the FIRST proposal for an epoch wins and every rank
        adopts what the record says, never its own guess;
      * alive posts ``alive_e<n>_r<rank>.json`` — one per suspect round;
      * rejoin requests ``rejoin_r<rank>.json`` — the park barrier;
      * heartbeats ``heartbeat_r<rank>.json`` — liveness for operators,
        refreshed at most once per ``heartbeat_seconds``.

    A relaunched FLEET (not a relaunched rank) clears this directory
    first: stale epoch records would park ranks the dead epoch excluded
    (``launch.py`` does so before every fleet launch)."""

    def __init__(self, directory: str) -> None:
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _publish(self, name: str, record: dict, *, exclusive: bool) -> bool:
        """Write ``record`` to ``name`` atomically. ``exclusive`` uses a
        hard-link publish so the first writer wins (epoch records);
        otherwise the newest write wins (per-rank files)."""
        tmp = os.path.join(
            self.directory, f".tmp_{name}_{os.getpid()}_{threading.get_ident()}"
        )
        final = os.path.join(self.directory, name)
        try:
            with open(tmp, "w") as f:
                json.dump(record, f)
            if exclusive:
                try:
                    os.link(tmp, final)
                except FileExistsError:
                    return False
                finally:
                    os.unlink(tmp)
                return True
            os.replace(tmp, final)
            return True
        except OSError as exc:
            get_logger().error(
                f"membership store write {name} failed: {exc!r}")
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False

    # -- epoch records -------------------------------------------------------
    def propose_epoch(self, record: dict) -> bool:
        """Publish a write-once epoch record; False when an epoch with
        this number already exists (the race loser adopts the winner)."""
        return self._publish(
            f"epoch_{int(record['epoch']):08d}.json", record, exclusive=True)

    def epoch(self, n: int) -> Optional[dict]:
        return _read_json(
            os.path.join(self.directory, f"epoch_{int(n):08d}.json"))

    def latest_epoch(self) -> Optional[dict]:
        best: Optional[dict] = None
        try:
            names = os.listdir(self.directory)
        except OSError:
            return None
        for name in names:
            if not (name.startswith("epoch_") and name.endswith(".json")):
                continue
            rec = _read_json(os.path.join(self.directory, name))
            if rec is not None and (
                    best is None or rec.get("epoch", -1) > best["epoch"]):
                best = rec
        return best

    # -- suspect rounds ------------------------------------------------------
    def post_alive(self, epoch: int, rank: int, step: Optional[int]) -> None:
        self._publish(
            f"alive_e{int(epoch):08d}_r{int(rank)}.json",
            {"rank": int(rank), "epoch": int(epoch), "step": step,
             "time": time.time()},
            exclusive=False,
        )

    def _ranks_with_prefix(self, prefix: str) -> List[int]:
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for name in names:
            if name.startswith(prefix) and name.endswith(".json"):
                try:
                    out.append(int(name[len(prefix):-len(".json")]))
                except ValueError:
                    continue
        return sorted(out)

    def alive_set(self, epoch: int) -> set:
        return set(self._ranks_with_prefix(f"alive_e{int(epoch):08d}_r"))

    # -- rejoin mailbox ------------------------------------------------------
    def request_rejoin(self, rank: int) -> None:
        self._publish(
            f"rejoin_r{int(rank)}.json",
            {"rank": int(rank), "time": time.time()}, exclusive=False)

    def pending_rejoins(self) -> List[int]:
        return self._ranks_with_prefix("rejoin_r")

    def clear_rejoin(self, rank: int) -> None:
        try:
            os.unlink(os.path.join(self.directory, f"rejoin_r{int(rank)}.json"))
        except OSError:
            pass

    # -- heartbeats ----------------------------------------------------------
    def heartbeat(self, rank: int, *, step: Optional[int],
                  epoch: int) -> None:
        self._publish(
            f"heartbeat_r{int(rank)}.json",
            {"rank": int(rank), "step": step, "epoch": int(epoch),
             "time": time.time()},
            exclusive=False,
        )

    def rendezvous(self, epoch: int) -> str:
        """The ``file://`` address the members of ``epoch`` form their
        process group at (a ``FileStore`` named by the epoch)."""
        return "file://" + os.path.join(
            os.path.abspath(self.directory), f"rdzv_e{int(epoch):08d}")


class FileBus:
    """Deadline-bounded object collectives over the membership store's
    directory, in member order. Each collective is one sequence number
    per epoch: every member publishes ``col_e<epoch>_s<seq>_r<rank>.json``
    and polls for its peers' files; a peer whose file never lands within
    ``deadline`` raises ``PeerLostError`` naming the missing ranks."""

    def __init__(self, directory: str, *, epoch: int, members: tuple,
                 rank: int, deadline: float, poll: float = 0.005) -> None:
        self.directory = directory
        self.epoch = int(epoch)
        self.members = tuple(members)
        self.rank = int(rank)
        self.deadline = float(deadline)
        self.poll = float(poll)
        self._seq = 0
        os.makedirs(directory, exist_ok=True)

    def _path(self, seq: int, rank: int) -> str:
        return os.path.join(
            self.directory,
            f"col_e{self.epoch:08d}_s{seq:08d}_r{rank}.json")

    def _exchange(self, payload: Any) -> List[Any]:
        seq = self._seq
        self._seq += 1
        tmp = self._path(seq, self.rank) + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"v": payload}, f)
        os.replace(tmp, self._path(seq, self.rank))
        deadline = time.monotonic() + self.deadline
        out: Dict[int, Any] = {self.rank: payload}
        while len(out) < len(self.members):
            for rank in self.members:
                if rank in out:
                    continue
                rec = _read_json(self._path(seq, rank))
                if rec is not None:
                    out[rank] = rec.get("v")
            if len(out) == len(self.members):
                break
            if time.monotonic() >= deadline:
                missing = tuple(r for r in self.members if r not in out)
                raise PeerLostError(
                    f"collective e{self.epoch} s{seq} lost rank(s) "
                    f"{list(missing)}: no contribution within "
                    f"{self.deadline:g}s", missing=missing)
            time.sleep(self.poll)
        # everyone has read seq-1 before writing seq, so once seq is
        # complete our own seq-1 file has no remaining readers
        if seq > 0:
            try:
                os.unlink(self._path(seq - 1, self.rank))
            except OSError:
                pass
        return [out[r] for r in self.members]

    def all_gather(self, obj: Any) -> List[Any]:
        return self._exchange(obj)

    def broadcast(self, objs: list, src: int = 0) -> list:
        gathered = self._exchange(list(objs))
        return list(gathered[src])


# gloo raises its transport failures (a reset connection, a timed-out
# send or receive, a pair closed after a timeout) as plain RuntimeErrors:
# they are told apart by their origin, gloo's transport layer, not by
# words a bug's message could contain as well
_GLOO_TRANSPORT = ("gloo/transport/", "Application timeout caused pair "
                   "closure")


def is_transport_error(exc: BaseException) -> bool:
    """Whether ``exc``, raised by a collective, means a peer is lost: a
    ``PeerLostError``, a broken barrier, a timeout, a reset or refused
    connection, c10d's backend, network and store errors, or a failure of
    gloo's transport. Any other error (an NCCL usage error, a bug) is
    not, and propagates as itself."""
    import torch.distributed as dist

    if isinstance(exc, (PeerLostError, threading.BrokenBarrierError,
                        TimeoutError, ConnectionError)):
        return True
    if isinstance(exc, (dist.DistBackendError, dist.DistNetworkError,
                        dist.DistStoreError)):
        return True
    return (type(exc) is RuntimeError
            and any(m in str(exc) for m in _GLOO_TRANSPORT))


def _elastic_wrap(fn: Callable) -> Callable:
    """Translate transport-native participant loss (a broken barrier, a
    reset gloo connection, a collective timeout) into ``PeerLostError``
    so the trainer's outer loop catches ONE exception type regardless of
    transport."""

    def call(*args):
        try:
            return fn(*args)
        except PeerLostError:
            raise
        except (threading.BrokenBarrierError, TimeoutError, OSError,
                RuntimeError) as exc:
            # the reference's types, and gloo's and c10d's own failures
            if not (isinstance(exc, OSError) or is_transport_error(exc)):
                raise
            raise PeerLostError(f"collective transport failed: {exc!r}") \
                from exc

    return call


def elastic_decision_bus(view: MembershipView, rank: int,
                         raw: DecisionBus) -> DecisionBus:
    """A ``DecisionBus`` over one membership epoch, with participant
    loss normalised to ``PeerLostError``."""
    return DecisionBus(
        num_processes=view.num_hosts,
        process_index=view.bus_index(rank),
        all_gather=_elastic_wrap(raw.all_gather),
        broadcast=_elastic_wrap(raw.broadcast),
    )


def file_bus_factory(store: FileMembershipStore, deadline: float
                     ) -> Callable[[MembershipView, int], DecisionBus]:
    """The reference's transport for an epoch: a ``FileBus`` over
    ``<store>/collective``."""

    def factory(view: MembershipView, rank: int) -> DecisionBus:
        fb = FileBus(
            os.path.join(store.directory, "collective"),
            epoch=view.epoch, members=view.members, rank=rank,
            deadline=deadline,
        )
        return DecisionBus(
            num_processes=view.num_hosts,
            process_index=view.bus_index(rank),
            all_gather=fb.all_gather,
            broadcast=fb.broadcast,
        )

    return factory


class ElasticCoordinator:
    """The membership epoch state machine: steady → suspect → shrink →
    steady → grow.

    Detection is the bounded deadline on every epoch-bus collective
    (``PeerLostError``); agreement is a write-once epoch record in the
    shared ``FileMembershipStore`` — the first proposal for an epoch
    wins and every rank adopts what the RECORD says (the
    host-0-agreed-and-broadcast idiom mapped onto shared storage, so no
    rank ever acts on a locally-divergent membership guess). Grow
    decisions additionally ride the live epoch bus (``maybe_grow``), so
    every member switches topology at the same checkpoint boundary.

    The coordinator owns membership only; the trainer owns what a
    transition *means* (rebuild mesh/loader, restore from the latest
    checkpoint onto the new topology — trainer.py's remesh-and-resume
    outer loop)."""

    def __init__(
        self,
        *,
        rank: int,
        num_hosts: int,
        store: FileMembershipStore,
        bus_factory: Callable[[MembershipView, int], DecisionBus],
        min_hosts: int = 1,
        deadline_seconds: float = 10.0,
        heartbeat_seconds: float = 2.0,
        join_timeout: float = 600.0,
        exporter: Any = None,
        poll: float = 0.02,
        relaunched: bool = False,
        suspect_seconds: Optional[float] = None,
    ) -> None:
        self.rank = int(rank)
        self.store = store
        self.min_hosts = int(min_hosts)
        self.deadline_seconds = float(deadline_seconds)
        # the roll call of a suspect round (the deadline by default); a
        # transport whose survivors detect the loss up to one deadline
        # apart gives it longer, so no late detector is shed
        self.suspect_seconds = float(suspect_seconds if suspect_seconds
                                     is not None else deadline_seconds)
        self.heartbeat_seconds = float(heartbeat_seconds)
        self.join_timeout = float(join_timeout)
        self._bus_factory = bus_factory
        self._exporter = exporter
        self._poll = float(poll)
        self._bus: Optional[DecisionBus] = None
        self._last_beat = -math.inf
        self.pending_bootstrap = False
        self._counters: Dict[str, float] = {
            "elastic_epochs_adopted": 0.0,
            "elastic_peer_loss_events": 0.0,
            "elastic_suspect_rounds": 0.0,
            "elastic_shrinks": 0.0,
            "elastic_grows": 0.0,
            "elastic_hosts_lost": 0.0,
            "elastic_hosts_rejoined": 0.0,
            "elastic_evictions": 0.0,
        }
        latest = self.store.latest_epoch()
        if latest is None:
            self.view = MembershipView(0, tuple(range(int(num_hosts))))
            self.state = "steady"
            # host-local bookkeeping: publish the founding record so a
            # later relauncher can tell "fresh fleet" from "evicted"
            # (write-once — every founding rank proposing is harmless)
            self.store.propose_epoch({
                "epoch": 0, "members": list(self.view.members),
                "reason": "found", "step": None,
            })
            self._emit("steady", step=None, lost=(), joined=())
        else:
            members = tuple(sorted(int(r) for r in latest["members"]))
            if relaunched:
                # this rank's previous process is gone, whether or not
                # the fleet has shed it yet
                members = tuple(r for r in members if r != self.rank)
            self.view = MembershipView(int(latest["epoch"]), members)
            if self.rank in members:
                self.state = "steady"
            else:
                # a relaunched replacement host: park at the rejoin
                # barrier until a grow epoch admits us
                self.state = "parked"

    # -- wiring ---------------------------------------------------------------

    @classmethod
    def from_config(cls, cfg, *, rank: int, num_hosts: int,
                    exporter: Any = None,
                    store: Optional[FileMembershipStore] = None,
                    bus_factory: Optional[Callable] = None,
                    relaunched: bool = False,
                    suspect_seconds: Optional[float] = None,
                    ) -> "ElasticCoordinator":
        directory = os.path.join(cfg.checkpoint_dir, "membership")
        store = store or FileMembershipStore(directory)
        deadline = float(getattr(cfg, "elastic_deadline_seconds", 10.0))

        if bus_factory is None:
            bus_factory = file_bus_factory(store, deadline)

        return cls(
            rank=rank, num_hosts=num_hosts, store=store,
            bus_factory=bus_factory,
            min_hosts=int(getattr(cfg, "elastic_min_hosts", 1)),
            deadline_seconds=deadline,
            heartbeat_seconds=float(
                getattr(cfg, "elastic_heartbeat_seconds", 2.0)),
            exporter=exporter,
            relaunched=relaunched,
            suspect_seconds=suspect_seconds,
        )

    @property
    def bus(self) -> DecisionBus:
        """The decision bus of the CURRENT epoch (participant loss
        normalised to ``PeerLostError``); rebuilt lazily after every
        adopted transition."""
        if self._bus is None:
            self._bus = elastic_decision_bus(
                self.view, self.rank, self._bus_factory(self.view, self.rank))
        return self._bus

    @property
    def parked(self) -> bool:
        return self.state == "parked"

    @property
    def needs_join(self) -> bool:
        """True when this host must (re)enter the fleet before training:
        parked at the rejoin barrier, or admitted but not yet restored
        onto the fleet's checkpoint (``pending_bootstrap``)."""
        return self.state == "parked" or self.pending_bootstrap

    # -- steady-state ---------------------------------------------------------

    def beat(self, step: Optional[int] = None) -> None:
        """Operator-visible liveness: refresh this rank's heartbeat file
        at most once per ``heartbeat_seconds`` (called from the train
        loop's step boundary — cheap, host-local)."""
        now = time.monotonic()
        if now - self._last_beat >= self.heartbeat_seconds:
            self._last_beat = now
            self.store.heartbeat(
                self.rank, step=step, epoch=self.view.epoch)

    # -- transitions ----------------------------------------------------------

    def _emit(self, transition: str, *, step: Optional[int],
              lost: tuple, joined: tuple) -> None:
        if self._exporter is not None:
            self._exporter.emit("membership", {
                "transition": transition,
                "epoch": self.view.epoch,
                "members": list(self.view.members),
                "num_hosts": self.view.num_hosts,
                "rank": self.rank,
                "lost": sorted(lost),
                "joined": sorted(joined),
                "step": step,
            })

    def _adopt(self, record: dict, *, transition: str,
               step: Optional[int]) -> None:
        old = self.view
        members = tuple(sorted(int(r) for r in record["members"]))
        self.view = MembershipView(int(record["epoch"]), members)
        self._bus = None
        self.state = "steady"
        lost = tuple(r for r in old.members if r not in members)
        joined = tuple(r for r in members if r not in old.members)
        self._counters["elastic_epochs_adopted"] += 1
        self._counters["elastic_hosts_lost"] += len(lost)
        self._counters["elastic_hosts_rejoined"] += len(joined)
        if transition == "shrink":
            self._counters["elastic_shrinks"] += 1
        elif transition == "grow":
            self._counters["elastic_grows"] += 1
        get_logger().warning(
            f"membership epoch {old.epoch} -> {self.view.epoch} "
            f"({transition}): members {list(members)}"
            + (f", lost {list(lost)}" if lost else "")
            + (f", joined {list(joined)}" if joined else "")
        )
        self._emit(transition, step=step, lost=lost, joined=joined)

    def on_peer_lost(self, step: Optional[int],
                     exc: Optional[BaseException] = None) -> MembershipView:
        """Membership recovery after a broken collective. Returns the
        view that includes this host — either the shrink epoch the
        survivors agreed, or (when THIS host was the one evicted: it
        hung past the deadline and the fleet moved on) the grow epoch
        that readmits it after parking at the rejoin barrier. Raises
        ``ElasticRemeshError`` when the fleet cannot continue."""
        self._counters["elastic_peer_loss_events"] += 1
        self.state = "suspect"
        self._emit("suspect", step=step, lost=(), joined=())
        get_logger().warning(
            f"rank {self.rank}: peer lost at step {step} "
            f"({exc!r}); entering suspect round for epoch "
            f"{self.view.epoch}"
        )
        latest = self.store.latest_epoch()
        if latest is not None and int(latest["epoch"]) > self.view.epoch:
            # the fleet already moved on without us (we were the hung
            # host): adopt if readmitted, else park at the rejoin barrier
            members = tuple(sorted(int(r) for r in latest["members"]))
            if self.rank not in members:
                return self._park_and_rejoin(step)
            self._adopt(latest, transition="shrink", step=step)
            return self.view
        # suspect round: every survivor announces itself, waits out the
        # deadline, and the FIRST epoch proposal published wins — every
        # rank adopts the record, never its own locally-observed set
        self._counters["elastic_suspect_rounds"] += 1
        self.store.post_alive(self.view.epoch, self.rank, step)
        deadline = time.monotonic() + self.suspect_seconds
        alive: set = set()
        while True:
            alive = self.store.alive_set(self.view.epoch) \
                & set(self.view.members)
            if alive == set(self.view.members):
                break  # everyone answered: spurious loss, remesh in place
            if time.monotonic() >= deadline:
                break
            time.sleep(self._poll)
        if not alive:
            alive = {self.rank}  # store I/O failed: at least we are here
        target = self.view.epoch + 1
        if self.rank == min(alive):
            self.store.propose_epoch({
                "epoch": target, "members": sorted(alive),
                "reason": "shrink", "step": step,
            })
        record = self._await_epoch(target)
        if record is None:
            raise ElasticRemeshError(
                f"no epoch {target} record appeared within the deadline "
                f"after a suspect round (alive={sorted(alive)}) — "
                "falling back to a fleet restart"
            )
        members = tuple(sorted(int(r) for r in record["members"]))
        if self.rank not in members:
            return self._park_and_rejoin(step)
        if len(members) < self.min_hosts:
            self._adopt(record, transition="shrink", step=step)
            raise ElasticRemeshError(
                f"membership epoch {record['epoch']} has "
                f"{len(members)} host(s) < --elastic_min_hosts="
                f"{self.min_hosts} — falling back to a fleet restart"
            )
        self._adopt(record, transition="shrink", step=step)
        return self.view

    def _await_epoch(self, n: int) -> Optional[dict]:
        deadline = time.monotonic() + self.suspect_seconds * 2
        while True:
            record = self.store.epoch(n)
            if record is not None:
                return record
            if time.monotonic() >= deadline:
                return None
            time.sleep(self._poll)

    def _park_and_rejoin(self, step: Optional[int]) -> MembershipView:
        self._counters["elastic_evictions"] += 1
        self.state = "parked"
        self._emit("parked", step=step, lost=(self.rank,), joined=())
        get_logger().warning(
            f"rank {self.rank}: evicted from the fleet (epoch moved on "
            "without us); parking at the rejoin barrier"
        )
        return self.join(step=step)

    def join(self, step: Optional[int] = None) -> MembershipView:
        """Park at the rejoin barrier: post a rejoin request and wait
        for a grow epoch that admits this rank (published by the fleet
        at a checkpoint boundary), then adopt it. Pre-admitted callers
        (``maybe_grow`` already readmitted us) return immediately."""
        if self.state != "parked":
            return self.view
        self.store.request_rejoin(self.rank)
        deadline = time.monotonic() + self.join_timeout
        while True:
            latest = self.store.latest_epoch()
            if (latest is not None
                    and int(latest["epoch"]) > self.view.epoch
                    and self.rank in [int(r) for r in latest["members"]]):
                self._adopt(latest, transition="join", step=step)
                self.pending_bootstrap = True
                return self.view
            if time.monotonic() >= deadline:
                raise ElasticRemeshError(
                    f"rank {self.rank} parked at the rejoin barrier for "
                    f"{self.join_timeout:g}s without being admitted — "
                    "giving up (fleet gone or grow boundary never reached)"
                )
            time.sleep(self._poll)

    def maybe_grow(self, step: Optional[int] = None
                   ) -> Optional[MembershipView]:
        """Agreed scale-up at a checkpoint boundary. The epoch's host 0
        reads the rejoin mailbox and the decision rides the epoch bus —
        every member learns the SAME joiner set at the SAME boundary —
        then the grow epoch record admits the parked hosts. Returns the
        new view, or ``None`` when nobody is waiting."""
        decision = self.bus.broadcast_from_main(
            {"joiners": self.store.pending_rejoins(),
             "epoch": self.view.epoch + 1}
            if self.bus.is_main else None
        )
        joiners = [int(r) for r in (decision or {}).get("joiners", ())
                   if int(r) not in self.view.members]
        if not joiners:
            return None
        record = {
            "epoch": int(decision["epoch"]),
            "members": sorted(set(self.view.members) | set(joiners)),
            "reason": "grow", "step": step,
        }
        if self.bus.is_main:
            self.store.propose_epoch(record)
            for rank in joiners:
                self.store.clear_rejoin(rank)
        self._adopt(record, transition="grow", step=step)
        return self.view

    def counters(self) -> Dict[str, float]:
        return dict(self._counters)


# --------------------------------------------------------------------------
# Coordinated decisions
# --------------------------------------------------------------------------


def hang_timeout_from_config(cfg) -> float:
    return float(env_override(
        "SCALETORCH_TPU_FT_HANG_TIMEOUT",
        getattr(cfg, "ft_hang_timeout", 0.0),
    ))


def coordinate_from_config(cfg) -> bool:
    return bool(env_override(
        "SCALETORCH_TPU_FT_COORDINATE",
        getattr(cfg, "ft_coordinate", True),
    ))


def _sentinel_state(sentinel) -> Optional[tuple]:
    """What a sentinel's next verdict depends on besides the loss; equal
    on every host whose sentinel observed the same agreed losses."""
    if sentinel is None:
        return None
    return (sentinel.ema, sentinel.consecutive, sentinel.total_anomalies,
            sentinel.nonfinite_losses, sentinel.loss_spikes,
            sentinel.rollbacks)


class CoordinatedResilience:
    """Process-0-forms, broadcast-executes layer over
    ``ResilienceManager``.

    With one process (or ``--ft_coordinate false``) this is a transparent
    pass-through to the local manager; with more, every control decision
    runs one gather per optimizer step on the ``DecisionBus`` (a gloo
    group, never the NCCL training group):

      1. each host contributes ``{loss?, forced, stop}`` (the loss only
         on sentinel-sampled steps, so non-sampled steps move one bool)
         and its sentinel's state;
      2. host 0's decision is a function of the observations — the
         *worst* loss across hosts (any non-finite wins, else the max)
         feeds the sentinel, any host's stop flag arms the collective
         stop — and of the sentinel's state. Every host holds the same
         state (each observes the same agreed loss), so every host forms
         host 0's decision ``{action, loss, stop, abort?}`` from the same
         gather, with no broadcast;
      3. every host executes the identical action. Only when the gathered
         sentinel states differ (a drifted host) does host 0 form the
         decision alone and broadcast it: the other hosts replay the
         agreed loss through their own sentinel, and a drifted host that
         disagrees with the broadcast action logs and obeys host 0.

    A rollback additionally agrees on the restore OUTCOME: all hosts
    restored → proceed; none → downgrade to skip; a mixed result means
    the fleet state has diverged and every host raises identically.
    """

    def __init__(
        self,
        manager: ResilienceManager,
        *,
        bus: Optional[DecisionBus] = None,
        enabled: bool = True,
    ) -> None:
        self.manager = manager
        self.enabled = enabled
        self._bus = bus
        self._bus_probed = bus is not None
        self._warned_disagreement = False
        # stop flag agreed by the LAST after_step decision (same gather —
        # the boundary poll reuses it instead of a second collective)
        self._stop_agreed: Optional[bool] = None
        # optional telemetry.StragglerDetector: per-host step/data-fetch
        # times ride the SAME observation gather (zero new collectives)
        # and host 0 reduces them into the fleet summary + counters
        self.straggler = None

    @classmethod
    def from_config(cls, cfg, manager: ResilienceManager, *,
                    bus: Optional[DecisionBus] = None
                    ) -> "CoordinatedResilience":
        return cls(manager, bus=bus, enabled=coordinate_from_config(cfg))

    @property
    def bus(self) -> Optional[DecisionBus]:
        # probe the runtime exactly once — this sits on the per-step hot
        # path (should_stop/after_step -> coordinated -> bus). Without a
        # bus handed in, the default group carries it only when it is
        # gloo: object collectives never ride NCCL
        if not self._bus_probed and self.enabled:
            self._bus_probed = True
            import torch.distributed as dist

            if (dist.is_initialized() and dist.get_world_size() > 1
                    and dist.get_backend() == "gloo"):
                self._bus = DecisionBus.default()
        return self._bus

    @property
    def coordinated(self) -> bool:
        return (self.enabled and self.bus is not None
                and self.bus.num_processes > 1)

    def rebind_bus(self, bus: Optional[DecisionBus]) -> None:
        """Swap the decision transport onto a new membership epoch
        (elastic remesh). Clears the cached stop flag: the first loop
        boundary of the new epoch pays one fresh ``agree_any`` gather,
        which is also how the rejoined host and the survivors align
        their first collective."""
        self._bus = bus
        self._bus_probed = True
        self._stop_agreed = None

    # -- stop agreement ----------------------------------------------------

    def should_stop(self) -> bool:
        """Collective stop poll: any host's preemption request stops every
        host at the SAME step boundary (the one-sided emergency save that
        would wedge the checkpoint's collectives can no longer happen). The stop
        flag normally rides the previous ``after_step`` decision's gather
        — one collective round per step total; only a boundary with no
        prior decision (the first loop iteration) pays its own gather."""
        if not self.coordinated:
            return self.manager.stop_requested
        agreed = self._stop_agreed
        self._stop_agreed = None
        if agreed is None:
            agreed = self.bus.agree_any(self.manager.stop_requested)
        return agreed

    def verify_agreement(self, name: str, value: Any) -> None:
        """Assert every host holds the identical ``value`` (e.g. the
        emergency-checkpoint step) — a mismatch means the lockstep
        invariant broke and entering a collective save would wedge, so
        every host raises the same error instead."""
        if not self.coordinated:
            return
        values = self.bus.all_gather(value)
        if any(v != values[0] for v in values[1:]):
            raise TrainingDivergedError(
                f"multi-host disagreement on {name}: per-host values "
                f"{values} — refusing to enter a cross-host collective "
                "from divergent states"
            )

    # -- per-step decision -------------------------------------------------

    def after_step(
        self,
        step: int,
        metrics: Dict[str, Any],
        *,
        rollback: Optional[Callable[[], bool]] = None,
        position: Optional[int] = None,
        telemetry: Optional[Dict[str, Any]] = None,
    ) -> tuple:
        """Coordinated replacement for ``ResilienceManager.after_step``;
        same ``(metrics, action)`` contract. ``position`` is this host's
        absolute data-stream position: a host-local skip of an unreadable
        region (data/dataloader.py) silently desyncs the stream — every
        later gradient averages mismatched batches — so positions ride
        the same gather and any disagreement aborts the fleet loudly.
        ``telemetry`` is this host's per-step timing observation
        (``{step_time, data_fetch_time}``): it rides the same gather and
        feeds host 0's ``StragglerDetector`` — the straggler layer costs
        zero collectives of its own."""
        mgr = self.manager
        if not self.coordinated:
            return mgr.after_step(step, metrics, rollback=rollback)

        metrics = mgr.injector.corrupt_metrics(step, metrics)
        # injected faults fire BEFORE the observation gather so a
        # one-host SIGTERM rides THIS decision's stop flag (collective
        # stop at the next boundary), and an injected hang stalls this
        # host inside the collective — exactly the dead-peer shape the
        # watchdog exists for
        mgr.injector.maybe_sigterm(step)
        mgr.injector.maybe_hang(step)
        # elastic drills: a killed host never reaches the gather below
        # (its peers' bounded collective raises PeerLostError and the
        # trainer's remesh-and-resume loop takes over); a hung host
        # stalls HERE and finds the fleet moved on when it wakes
        mgr.injector.maybe_kill(step)
        mgr.injector.maybe_elastic_hang(step)
        forced = mgr.injector.nan_fired_step == step
        sampled = (
            mgr.sentinel is not None and mgr.sentinel_frequency > 0
            and (forced or step % mgr.sentinel_frequency == 0)
        )
        local = {
            "loss": float(metrics["loss"]) if sampled else None,
            "forced": forced,
            "stop": mgr.stop_requested,
            "position": position,
            "telemetry": telemetry,
            "sentinel": _sentinel_state(mgr.sentinel),
        }
        observations = self.bus.all_gather(local)
        if self.bus.is_main and self.straggler is not None:
            self.straggler.observe(
                step, [o.get("telemetry") for o in observations])
        if all(o["sentinel"] == observations[0]["sentinel"]
               for o in observations):
            # every host forms host 0's decision from the same gather
            decision = self._form_decision(step, observations)
            replay = False
        else:
            decision = (self._form_decision(step, observations)
                        if self.bus.is_main else None)
            decision = self.bus.broadcast_from_main(decision)
            replay = not self.bus.is_main
        # cache the agreed stop flag for the boundary poll (one
        # collective round per step; abort below makes it moot)
        self._stop_agreed = bool(decision.get("stop"))
        action = self._execute_decision(step, decision, rollback,
                                        replay=replay)
        return metrics, action

    def _form_decision(self, step: int, observations: List[dict]) -> dict:
        """Host 0's decision from the per-host observations (its sentinel
        observes the agreed loss)."""
        mgr = self.manager
        positions = {o.get("position") for o in observations
                     if o.get("position") is not None}
        if len(positions) > 1:
            return {
                "abort": (
                    f"data stream desynced across hosts at step {step}: "
                    f"per-host loader positions {sorted(positions)} — a "
                    "host-local skip of an unreadable region left the "
                    "fleet training on mismatched batches"
                ),
                "action": "ok", "loss": None,
                "stop": any(o["stop"] for o in observations),
            }
        losses = [o["loss"] for o in observations if o["loss"] is not None]
        stop_any = any(o["stop"] for o in observations)
        agreed_loss: Optional[float] = None
        if losses:
            nonfinite = [x for x in losses if not math.isfinite(x)]
            agreed_loss = nonfinite[0] if nonfinite else max(losses)
        decision: Dict[str, Any] = {
            "action": "ok", "loss": agreed_loss, "stop": stop_any,
        }
        if agreed_loss is None or mgr.sentinel is None:
            return decision
        try:
            action = mgr.sentinel.observe(agreed_loss, step)
            if action == "rollback":
                mgr.sentinel.ensure_rollback_budget()
            decision["action"] = action
        except TrainingDivergedError as exc:
            decision["abort"] = str(exc)
        return decision

    def _execute_decision(
        self,
        step: int,
        decision: dict,
        rollback: Optional[Callable[[], bool]],
        *,
        replay: bool,
    ) -> str:
        mgr = self.manager
        loss = decision.get("loss")
        action = decision.get("action", "ok")
        # After a broadcast decision, non-main hosts replay the AGREED
        # loss through their own sentinel so EMA / consecutive / counters
        # follow host 0's; a drifted host's local verdict never overrides
        # the broadcast.
        if replay and loss is not None and mgr.sentinel is not None:
            try:
                local_action = mgr.sentinel.observe(loss, step)
            except TrainingDivergedError:
                local_action = "abort"
            expected = "abort" if "abort" in decision else action
            if local_action != expected and not self._warned_disagreement:
                self._warned_disagreement = True
                get_logger().warning(
                    f"host {self.bus.process_index} sentinel disagrees at "
                    f"step {step} (local {local_action!r} vs broadcast "
                    f"{expected!r}): obeying host 0"
                )
        if "abort" in decision:
            raise TrainingDivergedError(decision["abort"])
        if action == "rollback":
            restored = bool(rollback()) if rollback is not None else False
            outcomes = self.bus.all_gather(restored)
            if all(outcomes):
                if mgr.sentinel is not None:
                    mgr.sentinel.note_rollback()
            elif not any(outcomes):
                get_logger().warning(
                    "coordinated rollback requested but no host restored "
                    "a checkpoint: skipping the anomalous step instead"
                )
                action = "skip"
            else:
                # some hosts restored, some did not: params now differ
                # across the fleet — continuing would train a franken-model
                raise TrainingDivergedError(
                    f"rollback diverged across hosts at step {step}: "
                    f"per-host restore outcomes {outcomes}"
                )
        if action == "skip" and loss is not None:
            get_logger().warning(
                f"anomalous loss {loss} at step {step}: batch skipped "
                "fleet-wide (the in-step guard rejected the update if it "
                "was non-finite)"
            )
        return action

    def counters(self) -> Dict[str, float]:
        return self.manager.counters()

    def straggler_counters(self) -> Dict[str, float]:
        """Straggler counters for the metrics extras ({} when the
        detector is not attached — single-process runs have no fleet to
        compare). Non-zero only on host 0, the host whose console line
        and ring buffer a multi-host run reads anyway."""
        if self.straggler is None:
            return {}
        return self.straggler.counters()


# --------------------------------------------------------------------------
# Hang watchdog
# --------------------------------------------------------------------------


def dump_thread_stacks() -> Dict[str, str]:
    """Formatted Python stacks of every live thread, keyed by name —
    the first thing a hang post-mortem needs (which frame is sitting
    inside the wedged wait?)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: Dict[str, str] = {}
    for ident, frame in sys._current_frames().items():
        name = names.get(ident, f"thread-{ident}")
        out[name] = "".join(traceback.format_stack(frame))
    return out


class HangWatchdog:
    """Background heartbeat monitor: no ``beat()`` within ``timeout``
    seconds → dump thread stacks + crash report, then ``exit_fn(43)``.

    The default ``exit_fn`` is ``os._exit`` on purpose: a hang usually
    means the main thread is wedged (a dead device, a stuck read), and a
    polite ``sys.exit`` from a daemon thread would never unwind it —
    the launcher's restart policy is the recovery path, and state is on
    disk up to the last checkpoint. Tests inject a recorder instead.

    The watchdog is a Python thread, so it runs only when the main thread
    releases the GIL; a CUDA synchronisation (``torch.cuda.synchronize``,
    ``.item()``) releases it while it waits.
    """

    def __init__(
        self,
        timeout: float,
        *,
        poll_interval: Optional[float] = None,
        crash_report: Optional[Callable[[dict], Optional[str]]] = None,
        exit_fn: Callable[[int], None] = os._exit,
        exit_code: int = WATCHDOG_EXIT_CODE,
    ) -> None:
        if timeout <= 0:
            raise ValueError(f"watchdog timeout must be > 0, got {timeout}")
        self.timeout = timeout
        self.poll_interval = (
            poll_interval if poll_interval is not None
            else max(0.05, min(timeout / 4.0, 5.0))
        )
        self.crash_report = crash_report
        self.exit_fn = exit_fn
        self.exit_code = exit_code
        self.fired = False
        self.last_step: Optional[int] = None
        self.last_phase: str = "start"
        self._last_beat = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self, step: Optional[int] = None, phase: str = "step") -> None:
        """Record progress (cheap; called from the train loop's phases)."""
        if step is not None:
            self.last_step = step
        self.last_phase = phase
        self._last_beat = time.monotonic()

    def start(self) -> "HangWatchdog":
        self._last_beat = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, name="scaletorch-hang-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(1.0, self.poll_interval * 4))
            self._thread = None

    def __enter__(self) -> "HangWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval):
            stalled = time.monotonic() - self._last_beat
            if stalled < self.timeout:
                continue
            self.fired = True
            info = {
                "reason": (
                    f"hang watchdog: no training progress for "
                    f"{stalled:.1f}s (timeout {self.timeout:g}s); last "
                    f"phase {self.last_phase!r} at step {self.last_step}"
                ),
                "step": self.last_step,
                "phase": self.last_phase,
                "stalled_seconds": stalled,
                "timeout": self.timeout,
                "exit_code": self.exit_code,
                "thread_stacks": dump_thread_stacks(),
            }
            get_logger().error(info["reason"])
            if self.crash_report is not None:
                try:
                    self.crash_report(info)  # logs its own path
                except Exception as exc:  # the exit below must still run
                    get_logger().error(f"crash report failed: {exc!r}")
            self.exit_fn(self.exit_code)
            return  # injected exit_fn (tests) does not terminate us


# --------------------------------------------------------------------------
# Crash reports
# --------------------------------------------------------------------------


def config_fingerprint(cfg) -> Dict[str, Any]:
    """Stable digest + the identity fields a post-mortem reads first."""
    try:
        import dataclasses as _dc

        d = {k: repr(v) for k, v in sorted(_dc.asdict(cfg).items())}
    except Exception:
        d = {"repr": repr(cfg)}
    digest = hashlib.sha256(
        json.dumps(d, sort_keys=True).encode()
    ).hexdigest()[:16]
    keys = ("model_type", "total_train_steps", "seed", "divergence_policy",
            "data_parallel_size", "tensor_parallel_size",
            "pipeline_parallel_size", "context_parallel_size",
            "expert_parallel_size")
    return {
        "sha256": digest,
        **{k: getattr(cfg, k) for k in keys if hasattr(cfg, k)},
    }


def write_crash_report(
    reason: str,
    step: Optional[int],
    *,
    directory: str = "results",
    config: Any = None,
    monitor_records: Optional[List[dict]] = None,
    last_metrics: Optional[List[dict]] = None,
    counters: Optional[Dict[str, float]] = None,
    thread_stacks: Optional[Dict[str, str]] = None,
    span_tail: Optional[List[dict]] = None,
    process_index: int = 0,
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    """Persist a JSON post-mortem; returns the path. Never raises to the
    caller's caller — an abort path must abort, not crash inside its own
    diagnostics (I/O errors are logged and an empty path returned).
    ``span_tail`` is the telemetry tracer's newest span events — the
    host-side timeline right up to the fault, next to the monitor ring
    buffer."""
    suffix = f"_proc{process_index}" if process_index else ""
    path = os.path.join(
        directory, f"crash_report_step{step if step is not None else 'NA'}"
        f"{suffix}.json"
    )
    report = {
        "reason": reason,
        "step": step,
        "time": time.time(),
        "process_index": process_index,
        "config_fingerprint": (
            config_fingerprint(config) if config is not None else None
        ),
        "counters": counters or {},
        "last_metrics": last_metrics or [],
        "monitor_records": monitor_records or [],
        "span_timeline_tail": span_tail or [],
        "thread_stacks": thread_stacks or {},
        **(extra or {}),
    }
    try:
        os.makedirs(directory, exist_ok=True)
        with open(path, "w") as f:
            json.dump(report, f, indent=1, default=repr)
    except OSError as exc:
        get_logger().error(f"could not write crash report {path}: {exc!r}")
        return ""
    get_logger().error(f"crash report written to {path}")
    return path
