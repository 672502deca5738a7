"""Launch the serving gateway over one or more engine replicas.

Counterpart of the reference's ``scripts/serve.py``, over the port's
engine: every decode of a paged engine on the card runs the
hand-written paged-decode kernel inside its captured step. It runs on
the CUDA card unless ``--device cpu`` is given, and fails (never falls
back) when asked for ``cuda`` with none present.

The production shape is ``--model_name_or_path`` + HF safetensors (read
by the port's ``utils/hf_interop``); ``--preset <name>`` draws random
weights at a ``models/presets.py`` width (``qwen3-0.6b`` on the card);
the hermetic shape is ``--preset tiny``: the reference's tiny Llama
widths with weights drawn from a ``torch.Generator`` seeded with
``--param_seed``, so a second process rebuilds the EXACT same model and
can compare streamed tokens bit for bit.

Prints ``READY port=<port>`` on stdout once the socket is bound.
SIGTERM/SIGINT drain gracefully — in-flight streams finish, queued
requests end ``aborted``, replicas stop at refcount-clean page pools —
and the process exits 0 (the exit-code contract's "clean drain").
After the drain it prints ``KERNEL_LAUNCHES {...}``: this process's
launch counts of the hand-written kernels (``ops/_build.launch_counts``;
a replica process reports its own on its ``/metrics``).

Examples (from the root of a checkout)
--------------------------------------
  # tiny deterministic model on the CPU, paged cache, two replicas:
  python -m scaletorch_tpu_torch.serve --device cpu --preset tiny \\
      --serve_replicas 2 --serve_port 8000

  # Qwen3-0.6B's width on the card, two replica processes:
  python -m scaletorch_tpu_torch.serve --preset qwen3-0.6b \\
      --serve_replica_procs 2 --max_slots 8 --max_seq 2048 \\
      --prefill_len 512

  # talk to it:
  curl -N -X POST http://127.0.0.1:8000/v1/generate \\
      -d '{"prompt": [1, 2, 3], "max_new_tokens": 8}'
  curl http://127.0.0.1:8000/healthz
  curl http://127.0.0.1:8000/metrics
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import subprocess
import sys
from typing import Any, Dict, List, Optional

import torch

from scaletorch_tpu_torch.ops import _build

TINY = dict(
    vocab_size=64, hidden_size=32, intermediate_size=64,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the root of the checkout: a replica child runs ``-m`` from here
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def add_model_args(p: argparse.ArgumentParser) -> None:
    """The model and engine flags the serve entry and every replica
    process share (a replica is spawned with the same values)."""
    p.add_argument("--preset", default="tiny",
                   help="'tiny' (deterministic tiny Llama from "
                        "--param_seed) or a models/presets.py name "
                        "(random init unless --model_name_or_path).")
    p.add_argument("--model_name_or_path", default=None,
                   help="HF checkpoint dir for real weights "
                        "(utils/hf_interop.load_hf_params).")
    p.add_argument("--param_seed", type=int, default=0)
    p.add_argument("--dtype", default=None, choices=sorted(DTYPES),
                   help="Compute and KV dtype (default: float32 for "
                        "'tiny', the preset config's otherwise).")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="Where the engines run; 'cuda' fails without a "
                        "card.")
    p.add_argument("--max_slots", type=int, default=4)
    p.add_argument("--max_seq", type=int, default=128)
    p.add_argument("--prefill_len", type=int, default=64)
    p.add_argument("--cache_layout", default="paged",
                   choices=("dense", "paged"))
    p.add_argument("--page_size", type=int, default=16)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_model_args(p)
    p.add_argument("--disagg", default="",
                   help="Disaggregated prefill/decode serving "
                        "(inference/disagg.py): 'P:D' splits the visible "
                        "cards into a P-card prefill slice and a D-card "
                        "decode slice (one card: both slices on it, "
                        "'1:1'); 'auto' sizes the split from the port's "
                        "per-phase memory rows. Paged layout only; "
                        "in-process replicas only (not "
                        "--serve_replica_procs).")
    p.add_argument("--serve_host", default="127.0.0.1")
    p.add_argument("--serve_port", type=int, default=8000)
    p.add_argument("--serve_replicas", type=int, default=1)
    p.add_argument("--serve_replica_procs", type=int, default=0,
                   help="> 0: run N replicas as CHILD PROCESSES "
                        "(python -m scaletorch_tpu_torch.replica each) "
                        "behind the replica supervisor — independent "
                        "failure domains with auto-restart — instead of "
                        "--serve_replicas in-process worker threads.")
    p.add_argument("--replica_watchdog_timeout_s", type=float,
                   default=120.0,
                   help="Each replica child's serving stall watchdog "
                        "(exit 44); <= 0 disarms it.")
    p.add_argument("--supervisor_backoff_base_s", type=float, default=0.5)
    p.add_argument("--supervisor_backoff_max_s", type=float, default=30.0)
    p.add_argument("--supervisor_flap_window_s", type=float, default=60.0)
    p.add_argument("--supervisor_flap_max_restarts", type=int, default=5)
    p.add_argument("--serve_tenants", default="",
                   help="'name:weight[:rate[:burst]],...' "
                        "(config.ServingArguments grammar)")
    p.add_argument("--serve_default_weight", type=float, default=1.0)
    p.add_argument("--serve_max_backlog", type=int, default=256)
    p.add_argument("--serve_free_page_watermark", type=float, default=0.05)
    p.add_argument("--serve_default_ttl_s", type=float, default=0.0)
    p.add_argument("--telemetry_dir", default=None,
                   help="Observability root: gateway_metrics/access/"
                        "latency_histograms JSONL (telemetry/export.py "
                        "schema), one shared Chrome trace "
                        "(serve.trace.json — gateway + every in-process "
                        "replica on one timeline, request spans "
                        "correlated by W3C trace id), and SIGUSR1 live "
                        "snapshots.")
    p.add_argument("--slo_path", default="",
                   help="SLO file in serving/slo.json's grammar (that "
                        "file holds the checked-in presets); /healthz "
                        "then carries a live 'slo' verdict for "
                        "--slo_preset.")
    p.add_argument("--slo_preset", default="tiny",
                   help="Preset name inside --slo_path (default tiny).")
    # gateway fault drills (ServingFaultInjector.from_config reads the
    # same field names; env SCALETORCH_TPU_FT_GW_* wins when present)
    p.add_argument("--ft_gw_tenant_storm_at", type=int, default=0)
    p.add_argument("--ft_gw_tenant_storm_count", type=int, default=8)
    p.add_argument("--ft_gw_replica_down_at", type=int, default=0)
    p.add_argument("--ft_gw_replica_crash_at", type=int, default=0,
                   help="SIGKILL the replica serving the k-th dispatch "
                        "(process mode; in-process degrades to thread "
                        "death).")
    p.add_argument("--ft_gw_replica_hang_at", type=int, default=0,
                   help="Stall the replica serving the k-th dispatch "
                        "so its watchdog exits 44.")
    p.add_argument("--ft_gw_warm_donor_crash_at", type=int, default=0,
                   help="SIGKILL the warm-transfer donor after it "
                        "streams the k-th /warm chunk (process mode).")
    p.add_argument("--ft_gw_warm_corrupt_chunk_at", type=int, default=0,
                   help="Flip bytes in the k-th /warm chunk after "
                        "checksumming — the recipient must drop it and "
                        "keep the rest.")
    p.add_argument("--serve_replica_uds", default="",
                   help="Directory for per-replica unix-domain sockets: "
                        "process-mode replicas bind <dir>/<rid>.sock "
                        "instead of a TCP port (the warm-transfer wire "
                        "and dispatch both ride the socket).")
    return p.parse_args(argv)


def build_model(args):
    """(cfg, model) — deterministic for a preset + ``--param_seed``;
    ``--device cuda`` raises without a card."""
    from scaletorch_tpu_torch.models import (
        LlamaConfig,
        LlamaForCausalLM,
        Qwen3MoEConfig,
        Qwen3MoEForCausalLM,
        model_config,
    )
    from scaletorch_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    dtype = DTYPES[args.dtype] if args.dtype else None
    if args.preset == "tiny":
        cfg = LlamaConfig(dtype=dtype or torch.float32, **TINY)
    else:
        cfg = model_config(args.preset,
                           **({"dtype": dtype} if dtype else {}))
    moe = isinstance(cfg, Qwen3MoEConfig)
    if args.model_name_or_path:
        from scaletorch_tpu_torch.utils.hf_interop import load_hf_params

        params = load_hf_params(args.model_name_or_path, cfg, device=device)
    else:
        if moe:
            from scaletorch_tpu_torch.models.qwen3_moe import init_params
        else:
            from scaletorch_tpu_torch.models.llama import init_params
        gen = torch.Generator(device=device)
        gen.manual_seed(args.param_seed)
        params = init_params(cfg, gen, device)
    cls = Qwen3MoEForCausalLM if moe else LlamaForCausalLM
    return cfg, cls.from_params(params, cfg, device=device)


def disagg_devices(args) -> List[str]:
    """The devices a disaggregated engine splits: every visible card
    (the one card listed twice, so ``'1:1'`` puts both slices on it),
    or the CPU twice."""
    if args.device == "cpu":
        return ["cpu", "cpu"]
    cards = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return cards * 2 if len(cards) == 1 else cards


def build_engine(args, cfg, model, tracer=None):
    from scaletorch_tpu_torch.inference import (
        DisaggregatedEngine,
        InferenceEngine,
        SamplingParams,
    )

    kw = dict(
        max_slots=args.max_slots, max_seq=args.max_seq,
        prefill_len=args.prefill_len,
        sampling=SamplingParams(temperature=0.0),
        cache_layout=args.cache_layout, page_size=args.page_size,
        strict_submit=False,
        tracer=tracer,
    )
    if getattr(args, "disagg", ""):
        from scaletorch_tpu_torch.inference.disagg import parse_disagg_spec

        return DisaggregatedEngine(
            model, cfg, devices=disagg_devices(args),
            disagg_split=parse_disagg_spec(args.disagg), **kw)
    return InferenceEngine(model, cfg, device=args.device, **kw)


def replica_command(args, replica_id: str) -> List[str]:
    """The command line of one replica child: this serve invocation's
    model and engine flags."""
    cmd = [sys.executable, "-m", "scaletorch_tpu_torch.replica",
           "--preset", args.preset,
           "--param_seed", str(args.param_seed),
           "--device", args.device,
           "--max_slots", str(args.max_slots),
           "--max_seq", str(args.max_seq),
           "--prefill_len", str(args.prefill_len),
           "--cache_layout", args.cache_layout,
           "--page_size", str(args.page_size),
           "--replica_id", replica_id,
           "--port", "0",
           "--watchdog_timeout_s", str(args.replica_watchdog_timeout_s)]
    if args.dtype:
        cmd += ["--dtype", args.dtype]
    if args.model_name_or_path:
        cmd += ["--model_name_or_path", args.model_name_or_path]
    if args.serve_replica_uds:
        cmd += ["--uds", os.path.join(args.serve_replica_uds,
                                      f"{replica_id}.sock")]
    if args.ft_gw_warm_donor_crash_at:
        cmd += ["--ft_gw_warm_donor_crash_at",
                str(args.ft_gw_warm_donor_crash_at)]
    if args.ft_gw_warm_corrupt_chunk_at:
        cmd += ["--ft_gw_warm_corrupt_chunk_at",
                str(args.ft_gw_warm_corrupt_chunk_at)]
    return cmd


def make_replica_spawner(args):
    """``(replica_id) -> Popen`` launching ``python -m
    scaletorch_tpu_torch.replica`` with this serve invocation's
    model/engine flags — the supervisor's spawn_fn. stdout is piped (the
    supervisor reads ``READY port=``), stderr is inherited so replica
    logs land in the parent's stream."""

    def spawn(replica_id: str):
        return subprocess.Popen(replica_command(args, replica_id),
                                stdout=subprocess.PIPE, text=True,
                                cwd=REPO_ROOT)

    return spawn


def build_replica_fleet(args, exporter=None):
    """Process mode: spawn ``--serve_replica_procs`` replica children
    under a ``ReplicaSupervisor``, each fronted by a
    ``RemoteEngineWorker``. Returns ``(workers, supervisor)``."""
    from scaletorch_tpu_torch.serving.remote import RemoteEngineWorker
    from scaletorch_tpu_torch.serving.supervisor import ReplicaSupervisor

    if args.serve_replica_uds:
        os.makedirs(args.serve_replica_uds, exist_ok=True)

    def worker_factory(replica_id: str, port, proc):
        # READY gave either a TCP port (int) or a UDS path (str)
        if isinstance(port, str):
            return RemoteEngineWorker(
                "127.0.0.1", 0, replica_id=replica_id, proc=proc,
                uds=port).start()
        return RemoteEngineWorker(
            "127.0.0.1", port, replica_id=replica_id, proc=proc).start()

    supervisor = ReplicaSupervisor(
        make_replica_spawner(args),
        [f"r{i}" for i in range(args.serve_replica_procs)],
        worker_factory=worker_factory,
        backoff_base_s=args.supervisor_backoff_base_s,
        backoff_max_s=args.supervisor_backoff_max_s,
        flap_window_s=args.supervisor_flap_window_s,
        flap_max_restarts=args.supervisor_flap_max_restarts,
        exporter=exporter,
    )
    workers = supervisor.start()
    return workers, supervisor


def build_gateway(args):
    from scaletorch_tpu_torch.inference.resilience import (
        ServingFaultInjector,
    )
    from scaletorch_tpu_torch.serving.admission import parse_tenant_spec
    from scaletorch_tpu_torch.serving.gateway import ServingGateway

    # ONE tracer shared by the gateway and every in-process replica
    # engine: the asyncio thread, the EngineWorker threads and the tick
    # loops all write the same Chrome trace, correlated by trace id.
    # (Process-mode replicas live in other processes — the trace covers
    # the gateway side only there.)
    tracer = None
    exporter = None
    if args.telemetry_dir:
        from scaletorch_tpu_torch.telemetry.export import TelemetryExporter
        from scaletorch_tpu_torch.telemetry.spans import SpanTracer

        tracer = SpanTracer(
            os.path.join(args.telemetry_dir, "serve.trace.json"),
            role="serve")
        exporter = TelemetryExporter(
            os.path.join(args.telemetry_dir, "gateway_events.jsonl"))
    slo_targets = None
    if args.slo_path:
        from scaletorch_tpu_torch.serving.slo import load_slo, preset_targets

        slo_targets = preset_targets(load_slo(args.slo_path),
                                     args.slo_preset)
    supervisor = None
    if args.serve_replica_procs > 0:
        engines, supervisor = build_replica_fleet(args, exporter=exporter)
    else:
        cfg, model = build_model(args)
        engines = {
            f"r{i}": build_engine(args, cfg, model, tracer=tracer)
            for i in range(args.serve_replicas)
        }
    injector = ServingFaultInjector.from_config(args)
    return ServingGateway(
        engines,
        supervisor=supervisor,
        host=args.serve_host, port=args.serve_port,
        tenants=parse_tenant_spec(args.serve_tenants),
        default_weight=args.serve_default_weight,
        max_backlog=args.serve_max_backlog,
        free_page_watermark=args.serve_free_page_watermark,
        default_ttl_s=args.serve_default_ttl_s,
        injector=injector if injector.active else None,
        exporter=exporter,
        tracer=tracer,
        slo_targets=slo_targets,
    )


def snapshot_payload(gateway) -> Dict[str, Any]:
    """A running gateway's live state (the SIGUSR1 snapshot): span
    tail, per-replica engine snapshots + histogram state, gateway gauges
    and per-tenant latency histograms."""
    payload: Dict[str, Any] = {
        "gateway": gateway.snapshot(),
        "slo": gateway.slo_status(),
        "tenant_histograms": gateway.hists.to_record(),
        "replicas": {
            rid: {
                "alive": worker.alive,
                "metrics": worker.gauges(),
                # remote workers have no in-process engine: their
                # histogram state lives in the child; the gauges above
                # are the polled snapshot
                "histograms": (
                    worker.engine.metrics.histogram_state()
                    if getattr(worker, "engine", None) is not None
                    else None),
            }
            for rid, worker in gateway.workers.items()
        },
    }
    if gateway.supervisor is not None:
        payload["supervisor"] = gateway.supervisor.status()
    if gateway.tracer is not None:
        payload["span_timeline_tail"] = gateway.tracer.tail(128)
    return payload


async def _main(args) -> int:
    gateway = build_gateway(args)
    snapshotter = None
    if args.telemetry_dir:
        from scaletorch_tpu_torch.telemetry.profiling import LiveSnapshotter

        snapshotter = LiveSnapshotter(
            args.telemetry_dir, lambda: snapshot_payload(gateway))
        snapshotter.install()
    await gateway.start()
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    print(f"READY port={gateway.port}", flush=True)
    serve = asyncio.ensure_future(gateway.serve_forever())
    await stop.wait()
    print("draining gateway...", flush=True)
    await gateway.stop(drain=True)
    if gateway.supervisor is not None:
        # the drain above already made every replica exit 0 ("drained",
        # never restarted); this reaps the children and the monitor
        await loop.run_in_executor(
            None, lambda: gateway.supervisor.stop(drain=True))
    serve.cancel()
    if snapshotter is not None:
        snapshotter.uninstall()
    if gateway.tracer is not None:
        # terminate the trace file AFTER the replicas drained (their
        # worker threads emit into it until join) so it is valid JSON
        gateway.tracer.close()
    if gateway.exporter is not None:
        gateway.exporter.close()
    print("KERNEL_LAUNCHES " + json.dumps(dict(_build.launch_counts)),
          flush=True)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    from scaletorch_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    resolve_device(args.device)  # no card for 'cuda': fail here, at once
    if args.disagg:
        if args.cache_layout != "paged":
            raise SystemExit(
                "--disagg requires --cache_layout paged (the page is "
                "the handoff unit)")
        if args.serve_replica_procs > 0:
            raise SystemExit(
                "--disagg runs in-process replicas only; drop "
                "--serve_replica_procs")
    return asyncio.run(_main(args))


if __name__ == "__main__":
    sys.exit(main())
