"""Launcher of the port's ranks on one node, with per-rank elastic
relaunch (counterpart of scripts/launch_multihost.sh with ``ELASTIC=1``).

    python -m scaletorch_tpu_torch.launch --nproc 4 --elastic \
        --membership-dir CKPT/membership --max-restarts 1 -- \
        python -m scaletorch_tpu_torch.train --elastic true \
            --checkpoint_dir CKPT --resume auto --data_parallel_size 4 ...

starts ``--nproc`` processes, one a card, each with ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and ``COORDINATOR_ADDRESS`` (a ``file://``
rendezvous under ``--rdzv-dir``, no TCP port), and supervises them. The
exit codes keep their meaning (``resilience_distributed``): 0 done, 42
diverged (never restarted; it vetoes every pending restart), 43 a hang
watchdog or an elastic remesh that gave up, 44 a serving stall, 130
interrupted.

With ``--elastic`` a rank that exits with any other code (a crash, a
signal, 43) is relaunched alone, up to ``--max-restarts`` times, with
``TORCHELASTIC_RESTART_COUNT`` set: the trainer then parks at the
rejoin barrier and the fleet readmits it at its next checkpoint
boundary, while the other ranks go on. torchrun's agent stops or
restarts the whole group on one worker's failure, so it cannot do this.
A fleet that is down with ranks unfinished (the elastic layer gave up:
``ElasticRemeshError``, 43) is relaunched, up to ``--max-restarts``
times, each after the membership directory is cleared; the ranks resume
from the newest checkpoint. That is the path of an NCCL run, whose
group cannot be re-formed in place: a survivor blocked on the lost peer
is ended by NCCL's watchdog at the group's timeout (a signal: relaunched
like a crash), a relaunched rank exits 43 at once, and the fleet, once
down, restarts. An elastic launch turns off NCCL's debug dump on a
watchdog timeout (``ELASTIC_NCCL_ENV``, unless the caller's environment
sets the variables): waiting for the dump would add its wait (60 s) to
every survivor's end after a lost peer. Without ``--elastic`` a failure ends the launch; a
fired watchdog (43) relaunches the whole fleet, up to
``--max-restarts`` times.

Over several nodes (``--nnodes N --node-rank i``, one launcher a node,
started by hand or by ``scaletorch_tpu_torch.tools.launch_hosts`` over a
hosts file), node ``i`` starts ranks ``i·nproc .. i·nproc + nproc - 1``
(``RANK = node_rank·nproc + local_rank``, ``WORLD_SIZE = nnodes·nproc``)
and every node meets at the same ``file://`` rendezvous, so
``--rdzv-dir`` must be a directory all nodes share (the membership
directory must be shared too). With ``--elastic`` a node's launcher
relaunches its own ranks as on one node, each up to ``--max-restarts``
times: the per-rank budget is kept here and nowhere else. It never
relaunches its fleet and never clears the membership directory: those
decisions span nodes and belong to whoever started the nodes
(``launch_hosts``); its exit code is its ranks' (the first non-zero).

Every wait is bounded by ``--timeout`` seconds, after which every rank
is killed and the launch exits 124. The launcher's own events go to
stderr, one line each, and, with ``--events FILE``, as JSON lines to
FILE (each with its wall time: a drill reads the relaunch time there).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

DIVERGED_EXIT = 42
WATCHDOG_EXIT = 43
SERVING_STALL_EXIT = 44
INTERRUPTED_EXIT = 130
TIMEOUT_EXIT = 124
# exits that end a rank for good: done, diverged, interrupted
_FINAL = (0, DIVERGED_EXIT, INTERRUPTED_EXIT)
# an elastic rank blocked on a lost peer is ended by NCCL's watchdog at
# the group's timeout: no debug dump, and no wait for one, first
ELASTIC_NCCL_ENV = {"TORCH_NCCL_DUMP_ON_TIMEOUT": "0",
                    "TORCH_NCCL_WAIT_TIMEOUT_DUMP_MILSEC": "0"}


class Launcher:
    """The processes of one launch and their supervision."""

    def __init__(self, command: List[str], nproc: int, *, rdzv_dir: str,
                 elastic: bool, max_restarts: int,
                 membership_dir: Optional[str], timeout: float,
                 log_dir: Optional[str] = None,
                 events: Optional[str] = None, poll: float = 0.1,
                 nnodes: int = 1, node_rank: int = 0) -> None:
        if not 0 <= node_rank < nnodes:
            raise ValueError(f"node rank {node_rank} outside 0..{nnodes - 1}")
        self.command = command
        self.nproc = nproc
        self.nnodes = nnodes
        self.node_rank = node_rank
        self.rdzv_dir = os.path.abspath(rdzv_dir)
        self.elastic = elastic
        self.max_restarts = max_restarts
        self.membership_dir = membership_dir
        self.timeout = timeout
        self.log_dir = log_dir
        self.events = events
        self.poll = poll
        self.procs: Dict[int, subprocess.Popen] = {}
        self.tries: Dict[int, int] = {r: 0 for r in range(nproc)}
        self.done: Dict[int, int] = {}
        self._logs: list = []

    def _global(self, rank: int) -> int:
        return self.node_rank * self.nproc + rank

    def emit(self, event: str, **fields) -> None:
        record = {"event": event, "time": time.time(), **fields}
        print(f"[launch] {json.dumps(record)}", file=sys.stderr, flush=True)
        if self.events:
            with open(self.events, "a") as f:
                f.write(json.dumps(record) + "\n")

    def _start(self, rank: int, fleet: int) -> None:
        """Start local rank ``rank`` (global ``node_rank·nproc + rank``)."""
        env = {**os.environ,
               "RANK": str(self._global(rank)),
               "WORLD_SIZE": str(self.nnodes * self.nproc),
               "LOCAL_RANK": str(rank),
               "LOCAL_WORLD_SIZE": str(self.nproc),
               "NODE_RANK": str(self.node_rank),
               "COORDINATOR_ADDRESS": "file://" + os.path.join(
                   self.rdzv_dir, f"store_f{fleet}"),
               "TORCHELASTIC_RESTART_COUNT": str(self.tries[rank])}
        for name in ("MASTER_ADDR", "MASTER_PORT"):
            env.pop(name, None)
        if self.elastic:
            for name, value in ELASTIC_NCCL_ENV.items():
                env.setdefault(name, value)
        out = None
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            out = open(os.path.join(
                self.log_dir,
                f"rank{self._global(rank)}_f{fleet}_try{self.tries[rank]}"
                ".log"), "w")
            self._logs.append(out)
        self.procs[rank] = subprocess.Popen(
            self.command, env=env, stdout=out,
            stderr=subprocess.STDOUT if out else None)
        self.emit("start", rank=self._global(rank), fleet=fleet,
                  attempt=self.tries[rank],
                  pid=self.procs[rank].pid)

    def _start_fleet(self, fleet: int) -> None:
        if (self.nnodes == 1 and self.membership_dir
                and os.path.isdir(self.membership_dir)):
            # a fresh fleet: stale epoch records would park its ranks
            shutil.rmtree(self.membership_dir)
        os.makedirs(self.rdzv_dir, exist_ok=True)
        self.done.clear()
        for rank in range(self.nproc):
            self.tries[rank] = 0
            self._start(rank, fleet)

    def kill_all(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
        for p in self.procs.values():
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass

    def run(self) -> int:
        deadline = time.monotonic() + self.timeout
        fleet = 0
        self._start_fleet(fleet)
        try:
            while True:
                if time.monotonic() >= deadline:
                    self.emit("timeout", seconds=self.timeout)
                    self.kill_all()
                    return TIMEOUT_EXIT
                for rank, p in list(self.procs.items()):
                    rc = p.poll()
                    if rc is None:
                        continue
                    del self.procs[rank]
                    self.emit("exit", rank=self._global(rank), code=rc)
                    if rc == DIVERGED_EXIT:
                        self.kill_all()
                        return rc
                    if rc in _FINAL:
                        self.done[rank] = rc
                    elif self.elastic and self.tries[rank] < self.max_restarts:
                        self.tries[rank] += 1
                        self.emit("relaunch", rank=self._global(rank),
                                  attempt=self.tries[rank])
                        self._start(rank, fleet)
                    elif not self.elastic and rc != WATCHDOG_EXIT:
                        self.kill_all()
                        return rc
                    else:
                        self.done[rank] = rc
                if self.procs:
                    time.sleep(self.poll)
                    continue
                codes = [self.done.get(r, 1) for r in range(self.nproc)]
                if all(c == 0 for c in codes):
                    self.emit("finished")
                    return 0
                # the whole fleet is down with ranks unfinished (elastic),
                # or a watchdog fired (not): a fleet relaunch, on one node
                # only (over nodes it is the fan-out's decision)
                again = (self.nnodes == 1 and fleet < self.max_restarts
                         and (self.elastic or WATCHDOG_EXIT in codes))
                if again:
                    fleet += 1
                    self.emit("fleet_restart", fleet=fleet, codes=codes)
                    self._start_fleet(fleet)
                    continue
                return next(c for c in codes if c != 0)
        except KeyboardInterrupt:
            self.kill_all()
            return INTERRUPTED_EXIT
        finally:
            for f in self._logs:
                f.close()


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" not in argv:
        raise SystemExit("usage: launch.py [options] -- command ...")
    cut = argv.index("--")
    parser = argparse.ArgumentParser(prog="scaletorch_tpu_torch.launch")
    parser.add_argument("--nproc", type=int, required=True,
                        help="ranks on this node")
    parser.add_argument("--nnodes", type=int, default=1)
    parser.add_argument("--node-rank", type=int, default=0)
    parser.add_argument("--rdzv-dir", default=None,
                        help="directory of the file:// rendezvous "
                             "(default: <membership-dir>/../rdzv or ./rdzv)")
    parser.add_argument("--elastic", action="store_true")
    parser.add_argument("--max-restarts", type=int, default=0)
    parser.add_argument("--membership-dir", default=None)
    parser.add_argument("--timeout", type=float, default=3600.0)
    parser.add_argument("--log-dir", default=None)
    parser.add_argument("--events", default=None)
    args = parser.parse_args(argv[:cut])
    rdzv = args.rdzv_dir or (
        os.path.join(os.path.dirname(os.path.abspath(args.membership_dir)),
                     "rdzv") if args.membership_dir else "rdzv")
    launcher = Launcher(argv[cut + 1:], args.nproc, rdzv_dir=rdzv,
                        elastic=args.elastic, max_restarts=args.max_restarts,
                        membership_dir=args.membership_dir,
                        timeout=args.timeout, log_dir=args.log_dir,
                        events=args.events, nnodes=args.nnodes,
                        node_rank=args.node_rank)
    signal.signal(signal.SIGTERM, lambda *_: (launcher.kill_all(),
                                              sys.exit(143)))
    return launcher.run()


if __name__ == "__main__":
    sys.exit(main())
