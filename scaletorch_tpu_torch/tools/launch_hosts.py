"""Start the port's launcher on every host of a hosts file and supervise
the fleet (counterpart of the reference's ``scripts/launch_multihost.sh``).

    python -m scaletorch_tpu_torch.tools.launch_hosts hosts.txt --nproc 8 \\
        --rdzv-dir /shared/job/rdzv --max-restarts 2 -- \\
        python -m scaletorch_tpu_torch.train --data_parallel_size 16 \\
            --checkpoint_dir /shared/job/ckpt --resume auto ...

The hosts file lists one host a line (``#`` comments and blank lines
ignored; ``scaletorch_tpu_torch.tools.group_hosts`` writes one in rack
order). Host ``i`` runs ``python -m scaletorch_tpu_torch.launch --nnodes
N --node-rank i --nproc P`` through ``--rsh`` (default ``ssh``, one
command string: ``--rsh "ssh -p 2222"``), from ``--workdir`` (default:
this directory), so every rank of the job meets at one ``file://``
rendezvous under ``--rdzv-dir``: a directory every host must share, as
the membership directory must be. A fresh sub-directory serves each
fleet launch. Each host's output goes to ``--log-dir``.

The restart policy is the reference's:

  * by default, a fleet-wide restart: a host whose ranks exited 43 (a
    hang watchdog fired on a dead collective) makes the whole fleet
    stop and start again, up to ``--max-restarts`` times (the ranks
    resume from the newest checkpoint with ``--resume auto``);
  * with ``--elastic`` (the ranks run ``--elastic``), each host's
    launcher relaunches its own failed ranks, each up to
    ``--max-restarts`` times, a relaunched rank parking at the rejoin
    barrier: that launcher keeps the per-rank budget, and the fan-out
    relaunches no host alone. A fleet that is all down with hosts
    unfinished (a rank out of its budget, or the elastic layer gave up)
    is relaunched once, whole;
  * in both modes exit 42 (training diverged) is never restarted and
    vetoes every pending restart;
  * ``--membership-dir`` is cleared (through host 0, which must see the
    shared filesystem) before every full-fleet launch, and only then: a
    rank its host's launcher relaunches needs the live epoch chain.

Every wait is bounded by ``--timeout`` seconds, after which every host's
launcher is stopped and the fan-out exits 124. SIGTERM or SIGINT stops
the fleet. Events go to stderr, one line each, and as JSON lines to
``--events FILE``.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

DIVERGED_EXIT = 42
WATCHDOG_EXIT = 43
TIMEOUT_EXIT = 124
INTERRUPTED_EXIT = 130
DEFAULT_RSH = "ssh -o BatchMode=yes -o StrictHostKeyChecking=no"


def read_hosts(path: str) -> List[str]:
    """The hosts of a hosts file, in order (first column of each line)."""
    hosts = []
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if line and not line.startswith("#"):
                hosts.append(line.split()[0])
    return hosts


class HostFleet:
    """One launcher a host, started through ``rsh`` and supervised."""

    def __init__(self, hosts: List[str], command: List[str], *, nproc: int,
                 rdzv_dir: str, rsh: str = DEFAULT_RSH,
                 workdir: Optional[str] = None, elastic: bool = False,
                 max_restarts: int = 0,
                 membership_dir: Optional[str] = None,
                 timeout: float = 3600.0, log_dir: Optional[str] = None,
                 events: Optional[str] = None, python: str = "python3",
                 poll: float = 0.2) -> None:
        if not hosts:
            raise ValueError("the hosts file lists no host")
        self.hosts = hosts
        self.command = command
        self.nproc = nproc
        self.rdzv_dir = os.path.abspath(rdzv_dir)
        self.rsh = shlex.split(rsh)
        self.workdir = os.path.abspath(workdir or os.getcwd())
        self.elastic = elastic
        self.max_restarts = max_restarts
        self.membership_dir = membership_dir
        self.timeout = timeout
        self.log_dir = log_dir
        self.events = events
        self.python = python
        self.poll = poll
        self.tag = f"st_{int(time.time())}_{os.getpid()}"
        self.procs: Dict[int, subprocess.Popen] = {}
        self._logs: list = []

    # -- events ----------------------------------------------------------------
    def emit(self, event: str, **fields) -> None:
        record = {"event": event, "time": time.time(), **fields}
        print(f"[launch_hosts] {json.dumps(record)}", file=sys.stderr,
              flush=True)
        if self.events:
            with open(self.events, "a") as f:
                f.write(json.dumps(record) + "\n")

    # -- one host --------------------------------------------------------------
    def _pid_file(self, i: int) -> str:
        return os.path.join(self.rdzv_dir, "pids", f"{self.tag}_node{i}.pid")

    def _remote(self, host: str, script: str) -> List[str]:
        return self.rsh + [host, script]

    def node_script(self, i: int, fleet: int) -> str:
        """The shell command host ``i`` runs: its launcher, as node ``i``."""
        launch = [self.python, "-m", "scaletorch_tpu_torch.launch",
                  "--nnodes", str(len(self.hosts)), "--node-rank", str(i),
                  "--nproc", str(self.nproc),
                  "--rdzv-dir", os.path.join(self.rdzv_dir, f"fleet{fleet}"),
                  "--timeout", str(self.timeout)]
        if self.elastic:
            launch += ["--elastic", "--max-restarts", str(self.max_restarts)]
        pid_file = self._pid_file(i)
        return (f"cd {shlex.quote(self.workdir)} && "
                f"mkdir -p {shlex.quote(os.path.dirname(pid_file))} && "
                f"echo $$ > {shlex.quote(pid_file)} && "
                f"exec {shlex.join(launch + ['--'] + self.command)}")

    def start(self, i: int, fleet: int) -> None:
        out = None
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            out = open(os.path.join(
                self.log_dir,
                f"node{i}_{self.hosts[i]}_f{fleet}.log"), "w")
            self._logs.append(out)
        self.procs[i] = subprocess.Popen(
            self._remote(self.hosts[i], self.node_script(i, fleet)),
            stdout=out, stderr=subprocess.STDOUT if out else None,
            stdin=subprocess.DEVNULL)
        self.emit("start", node=i, host=self.hosts[i], fleet=fleet)

    def stop(self, i: int) -> None:
        """Stop host ``i``'s launcher (it kills its ranks on SIGTERM) and
        the local ``rsh`` process."""
        p = self.procs.pop(i, None)
        pid_file = shlex.quote(self._pid_file(i))
        subprocess.run(self._remote(
            self.hosts[i],
            f"kill $(cat {pid_file} 2>/dev/null) 2>/dev/null; "
            f"rm -f {pid_file}"),
            stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL, timeout=60, check=False)
        if p is not None and p.poll() is None:
            p.terminate()
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=30)

    def stop_all(self) -> None:
        for i in list(self.procs):
            self.stop(i)

    # -- the fleet -------------------------------------------------------------
    def start_fleet(self, fleet: int) -> None:
        if self.membership_dir:
            # a fresh fleet founds epoch 0 itself; cleared through host 0,
            # which sees the shared filesystem
            self.emit("clear_membership", directory=self.membership_dir)
            subprocess.run(self._remote(
                self.hosts[0],
                f"rm -rf -- {shlex.quote(self.membership_dir)}"),
                stdin=subprocess.DEVNULL, timeout=60, check=False)
        for i in range(len(self.hosts)):
            self.start(i, fleet)

    def _reap(self) -> Dict[int, int]:
        """Exit codes of the hosts that ended since the last look."""
        ended = {}
        for i, p in list(self.procs.items()):
            rc = p.poll()
            if rc is not None:
                del self.procs[i]
                ended[i] = rc
                self.emit("exit", node=i, host=self.hosts[i], code=rc)
        return ended

    def run(self) -> int:
        deadline = time.monotonic() + self.timeout
        try:
            if self.elastic:
                return self._run_elastic(deadline)
            return self._run_fleet(deadline)
        except KeyboardInterrupt:
            self.stop_all()
            return INTERRUPTED_EXIT
        finally:
            for f in self._logs:
                f.close()

    def _timed_out(self, deadline: float) -> bool:
        if time.monotonic() < deadline:
            return False
        self.emit("timeout", seconds=self.timeout)
        self.stop_all()
        return True

    def _run_fleet(self, deadline: float) -> int:
        attempt = 0
        while True:
            self.start_fleet(attempt)
            codes: Dict[int, int] = {}
            while self.procs:
                if self._timed_out(deadline):
                    return TIMEOUT_EXIT
                codes.update(self._reap())
                if self.procs:
                    time.sleep(self.poll)
            ordered = [codes[i] for i in range(len(self.hosts))]
            failed = [c for c in ordered if c != 0]
            if not failed:
                self.emit("finished")
                return 0
            # a dead collective wedges the survivors too: relaunch the
            # whole fleet; a diverged host vetoes it
            if (WATCHDOG_EXIT in failed and DIVERGED_EXIT not in failed
                    and attempt < self.max_restarts):
                attempt += 1
                self.emit("fleet_restart", fleet=attempt, codes=ordered)
                continue
            return failed[-1]

    def _run_elastic(self, deadline: float) -> int:
        fleet = 0
        while True:
            self.start_fleet(fleet)
            done = set()
            while self.procs:
                if self._timed_out(deadline):
                    return TIMEOUT_EXIT
                for i, rc in self._reap().items():
                    if rc == 0:
                        done.add(i)
                    elif rc == DIVERGED_EXIT:
                        self.stop_all()
                        return rc
                if self.procs:
                    time.sleep(self.poll)
            if len(done) == len(self.hosts):
                self.emit("finished")
                return 0
            # the whole fleet is down with hosts unfinished (a rank out of
            # its budget, or the elastic layer gave up): one fleet-wide
            # relaunch
            if fleet < 1 and self.max_restarts > 0:
                fleet += 1
                self.emit("fleet_restart", fleet=fleet)
                continue
            return WATCHDOG_EXIT


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" not in argv:
        raise SystemExit("usage: launch_hosts HOSTS_FILE [options] -- "
                         "command ...")
    cut = argv.index("--")
    parser = argparse.ArgumentParser(
        prog="python -m scaletorch_tpu_torch.tools.launch_hosts")
    parser.add_argument("hosts_file")
    parser.add_argument("--nproc", type=int, required=True,
                        help="ranks a host (one a card)")
    parser.add_argument("--rdzv-dir", required=True,
                        help="a directory every host shares: the file:// "
                             "rendezvous of each fleet launch")
    parser.add_argument("--rsh", default=DEFAULT_RSH,
                        help="the remote shell: called as RSH HOST COMMAND")
    parser.add_argument("--workdir", default=None,
                        help="the checkout's root on every host "
                             "(default: this directory)")
    parser.add_argument("--python", default="python3",
                        help="the interpreter on the hosts")
    parser.add_argument("--elastic", action="store_true")
    parser.add_argument("--max-restarts", type=int, default=0)
    parser.add_argument("--membership-dir", default=None)
    parser.add_argument("--timeout", type=float, default=3600.0)
    parser.add_argument("--log-dir", default=None)
    parser.add_argument("--events", default=None)
    args = parser.parse_args(argv[:cut])
    if not argv[cut + 1:]:
        raise SystemExit("no command given after --")
    fleet = HostFleet(
        read_hosts(args.hosts_file), argv[cut + 1:], nproc=args.nproc,
        rdzv_dir=args.rdzv_dir, rsh=args.rsh, workdir=args.workdir,
        elastic=args.elastic, max_restarts=args.max_restarts,
        membership_dir=args.membership_dir, timeout=args.timeout,
        log_dir=args.log_dir, events=args.events, python=args.python)

    def _stop(signum, _frame):
        fleet.stop_all()
        sys.exit(128 + signum)

    signal.signal(signal.SIGTERM, _stop)
    return fleet.run()


if __name__ == "__main__":
    sys.exit(main())
