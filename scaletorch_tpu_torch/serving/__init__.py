"""The serving front door: async HTTP gateway over the inference engine.

Counterpart of scaletorch_tpu/serving/: how a client reaches the port's
engine (the paged cache with radix prefix sharing, the terminal-outcome
taxonomy and drain discipline, the metrics surfaces) over a socket:

  * ``protocol``  — the versioned wire schema: ``POST /v1/generate``
    bodies, SSE ``token``/``done`` framing, the warm-transfer frames,
    and the single outcome -> HTTP-status mapping that extends the
    engine's conservation invariant to the wire.
  * ``admission`` — tenant-fair admission: weighted fair queueing over
    tenants (token-cost SFQ — a flooding tenant cannot starve the
    rest), per-tenant token buckets, and shed-before-latency
    backpressure driven by the engine's live page-pool gauges.
  * ``router``    — prefix-cache-aware multi-replica routing: the radix
    tree's page-aligned chunk hashes are the routing key, rendezvous
    hashing covers cold prefixes, replica health rides the
    0/42/43/44 exit-code contract.
  * ``slo``       — checked-in latency / error-budget targets
    (``slo.json``) and their evaluation.
  * ``gateway``   — the stdlib-only asyncio HTTP/1.1 server with SSE
    token streaming, the ``EngineWorker`` thread bridging the
    synchronous engine (push-per-tick via the engine's ``on_tokens``
    hook — zero recaptures), ``/metrics`` (Prometheus) and
    ``/healthz``.
  * ``remote``    — the replica wire: ``ReplicaServer`` in a replica
    process, ``RemoteEngineWorker`` in the gateway, warm rejoin.
  * ``supervisor`` — spawns, probes and restarts replica processes.

``protocol``, ``admission``, ``slo``, ``router`` and ``supervisor`` are
copies of the reference's standard-library modules (router and
supervisor over the port's logger). Everything resolves LAZILY (PEP
562): clients that only talk the wire schema or validate a tenant spec
(config.py's CLI parse) must not pay a torch import — only touching
``gateway`` symbols loads the engine side.

``python -m scaletorch_tpu_torch.serve`` is the launcher and
``python -m scaletorch_tpu_torch.replica`` a replica process.
"""

import importlib

_EXPORTS = {
    # admission (stdlib)
    "AdmissionController": "admission",
    "TenantConfig": "admission",
    "TokenBucket": "admission",
    "WeightedFairQueue": "admission",
    "parse_tenant_spec": "admission",
    # protocol (stdlib)
    "PROTOCOL_VERSION": "protocol",
    "STATUS_BY_OUTCOME": "protocol",
    "GenerateRequest": "protocol",
    "ProtocolError": "protocol",
    "parse_generate_request": "protocol",
    "parse_sse_stream": "protocol",
    "parse_traceparent": "protocol",
    "make_traceparent": "protocol",
    "new_trace_id": "protocol",
    "new_span_id": "protocol",
    # slo (stdlib)
    "load_slo": "slo",
    "preset_targets": "slo",
    "evaluate_slo": "slo",
    "format_report": "slo",
    # router (pulls the framework logger)
    "NoReplicaAvailable": "router",
    "PrefixAwareRouter": "router",
    "page_chunk_hashes": "router",
    # remote replica transport (stdlib at import; the client side pulls
    # the engine lazily only when it reconstructs a RequestResult)
    "RemoteEngineWorker": "remote",
    "ReplicaServer": "remote",
    # supervisor (stdlib)
    "ReplicaSupervisor": "supervisor",
    # gateway (pulls the engine, i.e. torch)
    "EngineWorker": "gateway",
    "GatewayMetrics": "gateway",
    "ServingGateway": "gateway",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module_name = _EXPORTS.get(name)
    if module_name is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{module_name}")
    return getattr(module, name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
