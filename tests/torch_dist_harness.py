"""Run a case of ``tests/torch_dist_cases.py`` in gloo processes (the CPU
tests of the port's parallel modules).

``run_ranks(tmp_path, world, case, payload)`` pickles ``payload`` under
``tmp_path``, starts ``world`` fresh interpreters (``python -m
tests.torch_dist_cases``), which import no JAX (each asserts it) and
meet at a ``FileStore`` under ``tmp_path`` (no TCP port, so parallel test
workers cannot collide), and returns each rank's result in rank order.
Every wait is bounded: the process group's own timeout, and ``timeout``
seconds for the whole run, after which every rank is killed and the
test fails with their output. The ranks run one CPU thread each; ``env``
adds variables (``TORCH_DIST_CASE_TIMEOUT_S`` shortens the process
group's timeout).
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parents[1]
DEFAULT_TIMEOUT_S = 240.0


def run_ranks(tmp_path, world: int, case: str, payload=None,
              timeout: float = DEFAULT_TIMEOUT_S,
              env: Optional[dict] = None) -> list:
    tmp = Path(tmp_path) / f"ranks-{case}-{time.monotonic_ns()}"
    tmp.mkdir(parents=True)
    with open(tmp / "payload.pkl", "wb") as f:
        pickle.dump(payload, f)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           **(env or {})}
    for name in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                 "LOCAL_RANK"):
        env.pop(name, None)
    procs = []
    logs = []
    for rank in range(world):
        log = open(tmp / f"log_{rank}.txt", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.torch_dist_cases", case,
             str(rank), str(world), str(tmp)],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [p for p in procs if p.poll() is None]
        for p in hung:
            p.kill()
        for p in hung:
            p.wait(timeout=30)
        for log in logs:
            log.close()
    outputs = [(tmp / f"log_{r}.txt").read_text() for r in range(world)]
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if hung or failed:
        detail = "\n".join(f"--- rank {r} (rc {procs[r].returncode}) ---\n"
                           f"{outputs[r][-4000:]}" for r in range(world))
        what = (f"timed out after {timeout:.0f} s" if hung
                else f"ranks {failed} failed")
        raise AssertionError(f"{case} on {world} ranks {what}\n{detail}")
    results = []
    for rank in range(world):
        with open(tmp / f"out_{rank}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results
