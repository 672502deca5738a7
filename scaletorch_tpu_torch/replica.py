"""One engine replica as its own process, behind the replica wire.

Counterpart of the reference's ``scripts/replica.py``: the serve entry's
replica supervisor (``python -m scaletorch_tpu_torch.serve
--serve_replica_procs N``) launches one of these per replica. It builds
the model and engine with the serve entry's flags (on the CUDA card
unless ``--device cpu``; no card for ``cuda`` is an error), wraps the
engine in an ``EngineWorker``, serves it through a ``ReplicaServer``
(serving/remote.py) and prints ``READY port=<n>`` (or ``READY
uds=<path>``) once the socket is bound. On the card it opens its own CUDA
context, captures its own graphs and loads the kernels already built
under ``build/kernels``.

Exit codes (the supervisor's contract):
  * 0  — drain: SIGTERM/SIGINT or ``POST /v1/drain``; in-flight requests
    finish first;
  * 44 — the armed serving watchdog saw the step loop stall;
  * anything else — a crash (a SIGKILL reads as -9), restarted with
    backoff.
"""

from __future__ import annotations

import argparse
import asyncio
import signal
import sys
import time
from typing import List, Optional

from scaletorch_tpu_torch.serve import add_model_args, build_engine, build_model


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_model_args(p)
    p.add_argument("--replica_id", default="r0")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="0 = ephemeral; the bound port rides the "
                        "READY line.")
    p.add_argument("--uds", default="",
                   help="Bind a unix-domain socket at this path instead "
                        "of TCP; READY then reads 'READY uds=<path>'.")
    p.add_argument("--watchdog_timeout_s", type=float, default=120.0,
                   help="Serving stall watchdog (exit 44); <= 0 "
                        "disarms it.")
    p.add_argument("--crash_report_dir", default="results")
    p.add_argument("--drain_timeout_s", type=float, default=30.0)
    # warm-transfer drills (donor side, fired by ReplicaServer while
    # streaming /warm; env SCALETORCH_TPU_FT_GW_WARM_* wins when present)
    p.add_argument("--ft_gw_warm_donor_crash_at", type=int, default=0,
                   help="SIGKILL this process after streaming the k-th "
                        "warm chunk.")
    p.add_argument("--ft_gw_warm_corrupt_chunk_at", type=int, default=0,
                   help="Flip bytes in the k-th warm chunk after "
                        "checksumming.")
    return p.parse_args(argv)


async def _serve(args, worker) -> None:
    from scaletorch_tpu_torch.inference.resilience import (
        ServingFaultInjector,
    )
    from scaletorch_tpu_torch.serving.remote import ReplicaServer

    injector = ServingFaultInjector.from_config(args)
    server = ReplicaServer(
        worker, host=args.host, port=args.port,
        uds=args.uds or None,
        injector=injector if injector.active else None)
    await server.start()
    # the drain handlers go in before READY: a supervisor may signal as
    # soon as it reads the line
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, server.request_drain)
    if args.uds:
        print(f"READY uds={args.uds}", flush=True)
    else:
        print(f"READY port={server.port}", flush=True)
    await server.wait_drain()
    print("draining replica...", flush=True)
    # stop admissions but keep ticking: in-flight submit streams must
    # deliver their terminal `done` events before the loop goes away
    worker.shutdown(drain=True)
    deadline = time.monotonic() + args.drain_timeout_s
    while worker.inflight > 0 and time.monotonic() < deadline:
        await asyncio.sleep(0.02)
    await server.close()


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    from scaletorch_tpu_torch.inference.resilience import (
        make_serving_watchdog,
    )
    from scaletorch_tpu_torch.serving.gateway import EngineWorker

    cfg, model = build_model(args)
    engine = build_engine(args, cfg, model)
    watchdog = None
    if args.watchdog_timeout_s > 0:
        watchdog = make_serving_watchdog(
            engine, args.watchdog_timeout_s,
            crash_report_dir=args.crash_report_dir)
        watchdog.start()
    worker = EngineWorker(engine, replica_id=args.replica_id).start()
    try:
        asyncio.run(_serve(args, worker))
    finally:
        worker.shutdown(drain=True)
        worker.join(timeout=args.drain_timeout_s)
        if watchdog is not None:
            watchdog.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
