"""Process-isolated replica transport: the ``EngineWorker`` seam on a wire.

Counterpart of scaletorch_tpu/serving/remote.py. Each replica process
(``python -m scaletorch_tpu_torch.replica``) opens its own CUDA context,
builds its own engine and captures its own graphs; the kernels it loads
are the ones already built under ``build/kernels``.

The gateway talks to replicas through the ``EngineWorker`` bridge —
submit/cancel in, token-push/terminal-result out. This module cuts that
seam at a process boundary so each replica engine runs in its OWN child
process (one failure domain, one GIL, one compile cache per replica):

  * ``ReplicaServer`` — the child-process half: a small asyncio HTTP/1.1
    server over ONE worker (the existing ``gateway.EngineWorker``
    driving a real engine, or any object with the same surface),
    speaking the ``protocol.py`` v:1 wire schema. SSE token push reuses
    the exact framing of ``POST /v1/generate``, extended with a
    ``submitted`` event carrying the engine-assigned request id (the
    gateway's cancel path needs it before the first token).

  * ``RemoteEngineWorker`` — the gateway-process half: satisfies the
    ``EngineWorker`` interface (``submit``/``cancel``/``gauges``/
    ``alive``/``exit_code``/``tick_listeners``/``shutdown``/``join``/
    ``stall``/``kill``) so the dispatcher, WFQ admission and router are
    untouched — a replica is a replica whether it lives on a worker
    thread or behind a socket. Each submit owns one HTTP connection and
    one reader thread; callbacks fire on that thread exactly like
    ``EngineWorker`` callbacks fire on the worker thread, so the
    gateway's ``call_soon_threadsafe`` trampolines work unchanged.

Wire schema (all JSON bodies carry ``v: 1``; the SSE framing is
``protocol.format_sse_event``):

  ``POST /v1/submit``    generate-request body (+ ``trace_id``, the
                         internal hop's correlation key) -> SSE stream:
                         ``submitted`` (request_id), ``token``*, exactly
                         one ``done`` (result payload + additive
                         ``queue_wait_s``/``prefill_s``/``prefix_hit``).
                         The server watches the socket: a gateway that
                         dies mid-stream has its request cancelled and
                         its pages released, same as a dropped SSE
                         client at the front door.
  ``POST /v1/cancel``    {"request_id", "detail"} — abort one request;
                         its ``aborted`` terminal rides the submit
                         stream, never this response.
  ``POST /v1/drain``     begin graceful drain; the entrypoint exits 0
                         once in-flight requests finish (the exit-code
                         contract's "clean drain" — no restart).
  ``POST /v1/hang``      {"seconds"} — drill: stall the worker's step
                         loop so the serving watchdog fires exit 44.
  ``GET  /healthz``      pid, liveness, page_size, inflight, warm/prefix
                         page gauges.
  ``GET  /metrics``      the live ``EngineMetrics`` snapshot (flat
                         gauges) + pid + ``decode_compile_count``, and
                         (additive) the prefill compile count and the
                         process's kernel launch counts per decode
                         replay and in all.
  ``GET  /prefix_map``   warm-rejoin donor half: the radix-tree
                         snapshot (token chains, page ids, page-aligned
                         chunk hashes, per-page refcount/frozen state).
  ``POST /warm``         warm-rejoin donor half: stream the requested
                         FROZEN pages' K/V bytes as length-prefixed
                         checksummed frames (``protocol.WARM_HEADER``);
                         resumable via ``start_chunk``. The donor
                         serves from refcount-retained host snapshots —
                         its pool and its conservation never move.
  ``POST /v1/warm_start`` warm-rejoin recipient half: given a ranked
                         donor list, pull ``/prefix_map`` + ``/warm``
                         from the first donor that answers (retry with
                         backoff, then the next peer, then cold),
                         import the pages, and answer with a summary.
                         Runs on an executor thread CONCURRENTLY with
                         serving — a warming replica keeps admitting.

The wire is transport-agnostic: ``ReplicaServer(uds=...)`` listens on a
unix domain socket instead of TCP (``--serve_replica_uds``), and
``RemoteEngineWorker(uds=...)`` connects to one — same schema, no port.

Failure semantics: a replica killed ``-9`` mid-stream closes every
submit socket; each reader thread synthesizes exactly one ``aborted``
terminal for its request, so the gateway's conservation invariant
(``http_requests_received == sum(outcomes)``) holds through the crash.
The health poller notices the dead child within a poll interval and
flips ``alive`` so the dispatcher stops feeding it; the supervisor
(serving/supervisor.py) owns the restart.

Dtype names on the wire: the warm-rejoin frames (``/prefix_map`` and
frame 0 of ``/warm``) carry the REFERENCE's names (``"float32"``,
``"bfloat16"``), not ``str(torch.dtype)``: the engine's warm export
writes them (``inference/engine.py:dtype_name``) and its import accepts
either spelling, so frame 0 of a port replica is byte-for-byte what a
reference replica sends for the same pool.

Pure stdlib — no torch at module level: the wire half is importable by
lightweight test replicas; ``RequestResult`` is imported lazily only
when a terminal payload is reconstructed.
"""

from __future__ import annotations

import asyncio
import http.client
import json
import os
import signal
import socket
import threading
import time
from typing import (
    Any,
    Callable,
    Dict,
    Iterator,
    List,
    Optional,
    Tuple,
)

from scaletorch_tpu_torch.serving import protocol
from scaletorch_tpu_torch.serving.protocol import GenerateRequest, ProtocolError
from scaletorch_tpu_torch.serving.router import page_chunk_hashes
from scaletorch_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 413: "Payload Too Large",
    500: "Internal Server Error", 503: "Service Unavailable",
}

MAX_BODY_BYTES = 8 * 2**20
MAX_HEADER_LINES = 100
HEADER_TIMEOUT_S = 30.0

# The hang drill's default stall: longer than any sane watchdog timeout,
# so the watchdog (not the stall running out) ends the replica.
DEFAULT_HANG_S = 3600.0


# --------------------------------------------------------------------------
# Child-process half: the replica server
# --------------------------------------------------------------------------


class ReplicaServer:
    """One engine worker behind the v:1 wire schema (child process side).

    ``worker`` is duck-typed to the ``gateway.EngineWorker`` surface:
    ``submit(req, on_tokens, on_done, ttl_s=, on_submitted=)``,
    ``cancel(request_id, detail)``, ``gauges()``, ``stall(seconds)``,
    ``alive``, ``inflight``, ``page_size`` — a test replica can serve a
    fake worker without importing torch. The server owns no admission, no
    router, no tenant state: those live in the gateway; a replica is
    pure engine + wire.
    """

    def __init__(self, worker: Any, *, host: str = "127.0.0.1",
                 port: int = 0, uds: Optional[str] = None,
                 injector: Any = None) -> None:
        self.worker = worker
        self._host = host
        self._requested_port = port
        self.port: Optional[int] = None
        self.uds = uds
        # warm-transfer fault drills (donor side): duck-typed to
        # ``ServingFaultInjector.take_gw_warm_donor_crash`` /
        # ``take_gw_warm_corrupt_chunk`` — None means no drills armed
        self.injector = injector
        self._server: Optional[asyncio.AbstractServer] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._drain_event: Optional[asyncio.Event] = None
        self.draining = False
        # open submit streams (loop-thread only): close() waits for
        # them so a draining replica never snaps a terminal mid-write
        self._streams = 0

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> "ReplicaServer":
        self._loop = asyncio.get_running_loop()
        self._drain_event = asyncio.Event()
        if self.uds:
            if os.path.exists(self.uds):
                os.unlink(self.uds)  # a stale socket from a kill -9'd life
            self._server = await asyncio.start_unix_server(
                self._handle_connection, path=self.uds)
            logger.info("replica server on uds %s (pid %d)",
                        self.uds, os.getpid())
        else:
            self._server = await asyncio.start_server(
                self._handle_connection, self._host, self._requested_port)
            self.port = self._server.sockets[0].getsockname()[1]
            logger.info("replica server on http://%s:%d (pid %d)",
                        self._host, self.port, os.getpid())
        return self

    async def wait_drain(self) -> None:
        """Block until a drain is requested (``POST /v1/drain`` or the
        entrypoint's SIGTERM handler calling ``request_drain``)."""
        await self._drain_event.wait()

    def request_drain(self) -> None:
        """Begin draining (idempotent; loop-thread only — signal
        handlers installed via ``loop.add_signal_handler`` qualify)."""
        self.draining = True
        if self._drain_event is not None:
            self._drain_event.set()

    async def close(self, *, stream_timeout_s: float = 10.0) -> None:
        """Stop accepting and wait for open submit streams to flush
        their terminal events (the worker's ``inflight`` can hit zero
        a beat before the ``done`` frame is written)."""
        deadline = time.monotonic() + stream_timeout_s
        while self._streams > 0 and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    # -- HTTP plumbing -----------------------------------------------------
    async def _read_request(
        self, reader: asyncio.StreamReader
    ) -> Optional[Tuple[str, str, Dict[str, str], bytes]]:
        line = await asyncio.wait_for(
            reader.readline(), timeout=HEADER_TIMEOUT_S)
        if not line.strip():
            return None
        parts = line.decode("latin-1").split()
        if len(parts) < 2:
            return None
        method, path = parts[0].upper(), parts[1]
        headers: Dict[str, str] = {}
        for _ in range(MAX_HEADER_LINES):
            raw = await asyncio.wait_for(
                reader.readline(), timeout=HEADER_TIMEOUT_S)
            if raw in (b"\r\n", b"\n", b""):
                break
            key, _, value = raw.decode("latin-1").partition(":")
            headers[key.strip().lower()] = value.strip()
        try:
            length = int(headers.get("content-length", "0") or "0")
        except ValueError:
            raise ProtocolError("invalid Content-Length") from None
        if length < 0 or length > MAX_BODY_BYTES:
            raise ProtocolError(f"bad body length {length}", status=413)
        body = await reader.readexactly(length) if length else b""
        return method, path, headers, body

    async def _respond_json(self, writer: asyncio.StreamWriter,
                            status: int, payload: Dict[str, Any]) -> None:
        body = json.dumps(payload).encode()
        head = (f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}\r\n"
                "Content-Type: application/json\r\n"
                f"Content-Length: {len(body)}\r\n"
                "Connection: close\r\n\r\n").encode()
        writer.write(head + body)
        await writer.drain()

    async def _handle_connection(self, reader: asyncio.StreamReader,
                                 writer: asyncio.StreamWriter) -> None:
        try:
            request = await self._read_request(reader)
            if request is None:
                return
            method, path, _headers, body = request
            route = path.split("?")[0].rstrip("/") or "/"
            if route == "/v1/submit" and method == "POST":
                await self._handle_submit(reader, writer, body)
            elif route == "/v1/cancel" and method == "POST":
                await self._handle_cancel(writer, body)
            elif route == "/v1/drain" and method == "POST":
                self.request_drain()
                await self._respond_json(writer, 200, {
                    "v": protocol.PROTOCOL_VERSION, "draining": True})
            elif route == "/v1/hang" and method == "POST":
                await self._handle_hang(writer, body)
            elif route == "/healthz" and method == "GET":
                await self._respond_json(writer, 200, self.health_payload())
            elif route == "/metrics" and method == "GET":
                await self._respond_json(writer, 200, self.metrics_payload())
            elif route == "/prefix_map" and method == "GET":
                await self._handle_prefix_map(writer)
            elif route == "/warm" and method == "POST":
                await self._handle_warm(writer, body)
            elif route == "/v1/warm_start" and method == "POST":
                await self._handle_warm_start(writer, body)
            else:
                await self._respond_json(
                    writer, 404, {"detail": f"no route {method} {path!r}"})
        except (ConnectionError, asyncio.IncompleteReadError,
                asyncio.TimeoutError):
            pass
        except ProtocolError as exc:
            try:
                await self._respond_json(writer, exc.status,
                                         {"detail": str(exc)})
            except Exception:
                pass
        except Exception:
            logger.exception("replica connection handler failed")
            try:
                await self._respond_json(writer, 500,
                                         {"detail": "internal error"})
            except Exception:
                pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    # -- endpoint payloads -------------------------------------------------
    def health_payload(self) -> Dict[str, Any]:
        try:
            gauges = self.worker.gauges()
        except Exception:
            gauges = {}
        return {
            "v": protocol.PROTOCOL_VERSION,
            "pid": os.getpid(),
            "alive": bool(self.worker.alive),
            "draining": self.draining,
            "page_size": getattr(self.worker, "page_size", None),
            "inflight": self.worker.inflight,
            "warm_pages": gauges.get("warm_pages_total", 0),
            "prefix_pages": gauges.get("prefix_pages", 0),
        }

    def metrics_payload(self) -> Dict[str, Any]:
        """The live gauges, the compile counts and, additively, this
        process's kernel launch counts (``ops/_build.launch_counts``)
        with the decode step's replays and launches per replay: what
        shows from outside the process that its decode ran the
        kernels."""
        from scaletorch_tpu_torch.ops import _build

        engine = getattr(self.worker, "engine", None)
        decode = getattr(engine, "_decode", None)
        return {
            "v": protocol.PROTOCOL_VERSION,
            "pid": os.getpid(),
            "alive": bool(self.worker.alive),
            "gauges": self.worker.gauges(),
            "decode_compile_count": getattr(
                engine, "decode_compile_count", None),
            "prefill_compile_count": getattr(
                engine, "prefill_compile_count", None),
            "kernel_launches": dict(_build.launch_counts),
            "decode_replays": getattr(decode, "replays", None),
            "decode_launches_per_replay": dict(
                getattr(decode, "captured_launches", {})),
        }

    # -- endpoints ---------------------------------------------------------
    async def _handle_cancel(self, writer: asyncio.StreamWriter,
                             body: bytes) -> None:
        try:
            obj = json.loads(body.decode("utf-8"))
            request_id = int(obj["request_id"])
        except (ValueError, KeyError, TypeError, UnicodeDecodeError):
            raise ProtocolError(
                "cancel body must carry an integer 'request_id'") from None
        detail = str(obj.get("detail") or "cancelled by gateway")
        self.worker.cancel(request_id, detail)
        await self._respond_json(writer, 200, {
            "v": protocol.PROTOCOL_VERSION, "request_id": request_id})

    async def _handle_hang(self, writer: asyncio.StreamWriter,
                           body: bytes) -> None:
        try:
            obj = json.loads(body.decode("utf-8")) if body.strip() else {}
            seconds = float(obj.get("seconds", DEFAULT_HANG_S))
        except (ValueError, UnicodeDecodeError):
            raise ProtocolError("hang body must be JSON") from None
        # answer FIRST: the stall wedges the worker thread, not this one
        await self._respond_json(writer, 200, {
            "v": protocol.PROTOCOL_VERSION, "stalling_s": seconds})
        logger.warning("replica hang drill: stalling the step loop %gs "
                       "(the serving watchdog should fire exit 44)",
                       seconds)
        self.worker.stall(seconds)

    # -- warm rejoin endpoints ---------------------------------------------
    async def _handle_prefix_map(self,
                                 writer: asyncio.StreamWriter) -> None:
        """Donor: snapshot the radix tree. The engine read runs on an
        executor thread (it round-trips through the worker inbox, a
        blocking wait the event loop must not make)."""
        fn = getattr(self.worker, "prefix_map", None)
        if fn is None:
            await self._respond_json(writer, 200, {
                "v": protocol.PROTOCOL_VERSION, "page_size": None,
                "chains": [], "pages": {}})
            return
        loop = asyncio.get_running_loop()
        payload = await loop.run_in_executor(None, fn)
        payload["v"] = protocol.PROTOCOL_VERSION
        page_size = payload.get("page_size")
        if page_size:
            for chain in payload.get("chains", []):
                chain["hashes"] = page_chunk_hashes(
                    chain["tokens"], page_size,
                    max_chunks=len(chain["pages"]))
        await self._respond_json(writer, 200, payload)

    async def _handle_warm(self, writer: asyncio.StreamWriter,
                           body: bytes) -> None:
        """Donor: stream the requested frozen pages as checksummed
        frames. Frame 0 carries the pool meta (dtype/shape); page
        frames are 1-based over the REQUEST's page order so a resume at
        ``start_chunk`` re-aligns by position; a terminal
        ``WARM_END_INDEX`` frame marks clean completion (its absence
        means this donor died mid-transfer)."""
        try:
            obj = json.loads(body.decode("utf-8")) if body.strip() else {}
            pages = [int(p) for p in obj.get("pages", [])]
            start_chunk = max(1, int(obj.get("start_chunk", 1)))
        except (ValueError, TypeError, UnicodeDecodeError):
            raise ProtocolError(
                "warm body must carry integer 'pages'") from None
        exporter = getattr(self.worker, "export_prefix_pages", None)
        if exporter is None:
            raise ProtocolError("replica has no paged prefix state",
                                status=404)
        loop = asyncio.get_running_loop()
        meta, contents = await loop.run_in_executor(None, exporter, pages)
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: application/octet-stream\r\n"
                     b"Cache-Control: no-cache\r\n"
                     b"Connection: close\r\n\r\n")
        meta_payload = dict(meta)
        meta_payload["v"] = protocol.PROTOCOL_VERSION
        meta_payload["pages"] = pages
        writer.write(protocol.encode_warm_frame(
            0, json.dumps(meta_payload).encode("utf-8")))
        await writer.drain()
        injector = self.injector
        for i, page in enumerate(pages):
            index = i + 1
            if index < start_chunk:
                continue  # the recipient already holds this chunk
            k_bytes, v_bytes = contents.get(page, (b"", b""))
            frame = protocol.encode_warm_frame(
                index,
                protocol.encode_warm_page_payload(page, k_bytes, v_bytes))
            if injector is not None \
                    and injector.take_gw_warm_corrupt_chunk(index):
                frame = protocol.corrupt_warm_frame(frame)
            writer.write(frame)
            await writer.drain()
            if injector is not None \
                    and injector.take_gw_warm_donor_crash(index):
                # the drill IS the donor dying mid-transfer: no flush,
                # no goodbye — the recipient sees a snapped stream
                os.kill(os.getpid(), signal.SIGKILL)
        writer.write(protocol.encode_warm_frame(
            protocol.WARM_END_INDEX, b""))
        await writer.drain()

    async def _handle_warm_start(self, writer: asyncio.StreamWriter,
                                 body: bytes) -> None:
        """Recipient: pull prefix state from the given donors (ranked
        best-first by the gateway) and import it. Blocks THIS request
        only — the pull runs on an executor thread, the event loop
        keeps serving submits, so warming never delays readiness or
        admissions."""
        try:
            obj = json.loads(body.decode("utf-8")) if body.strip() else {}
            donors = list(obj.get("donors", []))
            backoff_s = float(obj.get("backoff_s", 0.2))
            attempts = int(obj.get("attempts_per_donor", 2))
        except (ValueError, TypeError, UnicodeDecodeError):
            raise ProtocolError("warm_start body must be JSON") from None
        if getattr(self.worker, "import_prefix_pages", None) is None:
            await self._respond_json(writer, 200, {
                "v": protocol.PROTOCOL_VERSION, "status": "unsupported",
                "pages": 0, "chains": []})
            return
        loop = asyncio.get_running_loop()
        summary = await loop.run_in_executor(
            None,
            lambda: pull_warm_state(
                self.worker, donors, attempts_per_donor=attempts,
                backoff_s=backoff_s))
        summary["v"] = protocol.PROTOCOL_VERSION
        await self._respond_json(writer, 200, summary)

    async def _handle_submit(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter,
                             body: bytes) -> None:
        req = protocol.parse_generate_request(body)
        trace_id = req.extra.pop("trace_id", None)
        if isinstance(trace_id, str) and trace_id:
            req.trace_id = trace_id
        loop = self._loop
        chan: "asyncio.Queue[Tuple[str, Any]]" = asyncio.Queue()

        def _push(kind: str, payload: Any) -> None:
            try:
                loop.call_soon_threadsafe(chan.put_nowait, (kind, payload))
            except RuntimeError:
                pass  # loop closed during shutdown

        self.worker.submit(
            req,
            lambda rid, toks: _push("token", (rid, toks)),
            lambda result: _push("done", result),
            ttl_s=req.ttl_s,
            on_submitted=lambda rid: _push("submitted", rid),
        )
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-cache\r\n"
                     b"Connection: close\r\n\r\n")
        await writer.drain()
        disconnect = asyncio.ensure_future(self._watch_disconnect(reader))
        request_id: Optional[int] = None
        self._streams += 1
        try:
            while True:
                get = asyncio.ensure_future(chan.get())
                done, _ = await asyncio.wait(
                    {get, disconnect}, return_when=asyncio.FIRST_COMPLETED)
                if disconnect in done and get not in done:
                    get.cancel()
                    # the gateway died mid-stream: stop decoding, free
                    # the pages, swallow the terminal (nobody listens)
                    await self._reap_disconnected(chan, request_id)
                    return
                kind, payload = get.result()
                if kind == "submitted":
                    request_id = payload
                    writer.write(protocol.format_sse_event("submitted", {
                        "v": protocol.PROTOCOL_VERSION,
                        "request_id": payload}))
                elif kind == "token":
                    rid, token_ids = payload
                    request_id = rid
                    writer.write(protocol.format_sse_event(
                        "token", protocol.token_payload(rid, token_ids)))
                elif kind == "done":
                    writer.write(protocol.format_sse_event(
                        "done", _done_payload(req, payload)))
                    await writer.drain()
                    return
                await writer.drain()
        except (ConnectionError, OSError):
            await self._reap_disconnected(chan, request_id)
        finally:
            self._streams -= 1
            if not disconnect.done():
                disconnect.cancel()

    async def _reap_disconnected(self, chan: "asyncio.Queue",
                                 request_id: Optional[int]) -> None:
        """Cancel an orphaned request (its gateway is gone) and consume
        its channel until the terminal shows up — pages released, the
        engine's conservation intact."""
        cancelled = False
        if request_id is not None:
            cancelled = True
            self.worker.cancel(request_id, "gateway connection lost")
        while True:
            kind, payload = await chan.get()
            if kind == "done":
                return
            rid = payload if kind == "submitted" else payload[0]
            if not cancelled:
                cancelled = True
                self.worker.cancel(rid, "gateway connection lost")

    async def _watch_disconnect(self, reader: asyncio.StreamReader) -> None:
        try:
            while True:
                chunk = await reader.read(4096)
                if not chunk:
                    return
        except (ConnectionError, asyncio.CancelledError):
            return


def _done_payload(req: GenerateRequest, result: Any) -> Dict[str, Any]:
    """The submit stream's terminal event: the standard result payload
    plus the engine's latency attribution (additive, ``v`` stays 1) so
    the gateway's access records and histograms survive the hop."""
    payload = protocol.result_payload(
        result.request_id, outcome=result.outcome,
        finish_reason=result.finish_reason,
        token_ids=list(result.tokens), prompt_tokens=len(req.prompt),
        detail=result.detail, trace_id=result.trace_id)
    payload["queue_wait_s"] = result.queue_wait_s
    payload["prefill_s"] = result.prefill_s
    payload["prefix_hit"] = bool(result.prefix_hit)
    return payload


# --------------------------------------------------------------------------
# Warm-transfer client (recipient side)
# --------------------------------------------------------------------------


class _UDSHTTPConnection(http.client.HTTPConnection):
    """``http.client`` over a unix domain socket — the v:1 wire is
    transport-agnostic; only ``connect()`` differs."""

    def __init__(self, path: str,
                 timeout: Optional[float] = None) -> None:
        super().__init__("localhost", timeout=timeout)
        self.uds_path = path

    def connect(self) -> None:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        if self.timeout is not None:
            sock.settimeout(self.timeout)
        sock.connect(self.uds_path)
        self.sock = sock


def _donor_connection(donor: Dict[str, Any],
                      timeout: float) -> http.client.HTTPConnection:
    if donor.get("uds"):
        return _UDSHTTPConnection(str(donor["uds"]), timeout=timeout)
    return http.client.HTTPConnection(
        str(donor.get("host", "127.0.0.1")), int(donor["port"]),
        timeout=timeout)


def _donor_label(donor: Dict[str, Any]) -> str:
    if donor.get("replica"):
        return str(donor["replica"])
    if donor.get("uds"):
        return str(donor["uds"])
    return f"{donor.get('host', '127.0.0.1')}:{donor.get('port')}"


def _transfer_pages(
    donor: Dict[str, Any], page_order: List[int], start_chunk: int,
    contents: Dict[int, Tuple[bytes, bytes]], *, timeout: float,
) -> Tuple[int, int, bool]:
    """One ``POST /warm`` round: read frames into ``contents`` until
    the terminal frame or the stream snaps. Returns ``(chunks_dropped,
    next_start_chunk, completed)`` — a checksum mismatch drops that
    chunk and keeps reading (the stream framing is still sound); a
    truncated/garbled stream stops and reports where to resume."""
    dropped = 0
    next_start = start_chunk
    conn = _donor_connection(donor, timeout)
    try:
        conn.request(
            "POST", "/warm",
            body=json.dumps({"v": protocol.PROTOCOL_VERSION,
                             "pages": page_order,
                             "start_chunk": start_chunk}).encode(),
            headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            return dropped, next_start, False
        while True:
            frame = protocol.read_warm_frame(resp)
            if frame is None:
                return dropped, next_start, False  # snapped mid-stream
            index, payload, checksum_ok = frame
            if index == protocol.WARM_END_INDEX:
                return dropped, next_start, True
            if index == 0:
                continue  # meta frame: the caller already has the map
            if not checksum_ok:
                dropped += 1           # drop THIS chunk, keep the rest
                next_start = index + 1
                continue
            try:
                page_id, k_bytes, v_bytes = \
                    protocol.decode_warm_page_payload(payload)
            except ProtocolError:
                dropped += 1
                next_start = index + 1
                continue
            if k_bytes or v_bytes:
                contents[page_id] = (k_bytes, v_bytes)
            next_start = index + 1
    finally:
        conn.close()


def pull_warm_state(
    worker: Any, donors: List[Dict[str, Any]], *,
    attempts_per_donor: int = 2, backoff_s: float = 0.2,
    connect_timeout_s: float = 10.0,
) -> Dict[str, Any]:
    """Warm this replica's prefix cache from the first donor that
    delivers (the recipient half of warm rejoin; blocking — run on an
    executor thread). Strictly best-effort, degrading exactly as the
    fleet does: a donor that dies mid-transfer is retried with backoff
    (resuming from the last good chunk), then the next peer; corrupt
    chunks are dropped individually; with no live peers — or nothing to
    give — the replica serves cold, today's behavior."""
    started = time.monotonic()
    summary: Dict[str, Any] = {
        "status": "cold", "donor": None, "pages": 0, "chains": [],
        "chunks_dropped": 0, "attempts": 0, "elapsed_s": 0.0,
    }
    for donor in donors:
        label = _donor_label(donor)
        pmap: Optional[Dict[str, Any]] = None
        for attempt in range(attempts_per_donor):
            summary["attempts"] += 1
            try:
                conn = _donor_connection(donor, connect_timeout_s)
                try:
                    conn.request("GET", "/prefix_map")
                    resp = conn.getresponse()
                    body = resp.read()
                    if resp.status != 200:
                        raise http.client.HTTPException(
                            f"/prefix_map -> {resp.status}")
                    pmap = json.loads(body.decode("utf-8"))
                finally:
                    conn.close()
                break
            except (OSError, http.client.HTTPException, ValueError):
                time.sleep(backoff_s * (2 ** attempt))
        if pmap is None:
            logger.warning("warm pull: donor %s unreachable, trying "
                           "the next peer", label)
            continue
        chains = pmap.get("chains") or []
        if not chains:
            continue  # a live donor with an empty map: nothing to give
        page_order: List[int] = []
        seen = set()
        for chain in chains:
            for page in chain.get("pages", []):
                if page not in seen:
                    seen.add(page)
                    page_order.append(int(page))
        contents: Dict[int, Tuple[bytes, bytes]] = {}
        dropped = 0
        start_chunk = 1
        completed = False
        for attempt in range(attempts_per_donor):
            try:
                delta, start_chunk, completed = _transfer_pages(
                    donor, page_order, start_chunk, contents,
                    timeout=connect_timeout_s)
                dropped += delta
            except (OSError, http.client.HTTPException):
                pass
            if completed:
                break
            time.sleep(backoff_s * (2 ** attempt))
        summary["chunks_dropped"] += dropped
        if not contents and not completed:
            logger.warning("warm pull: donor %s died mid-transfer with "
                           "nothing delivered, trying the next peer",
                           label)
            continue
        try:
            result = worker.import_prefix_pages(
                [(c["tokens"], c["pages"]) for c in chains], contents,
                dtype=pmap.get("dtype"),
                page_shape=pmap.get("page_shape", []),
                page_size=pmap.get("page_size"))
        except Exception:
            logger.exception("warm pull: import from donor %s failed; "
                             "trying the next peer", label)
            continue
        if result.get("pages", 0) > 0 or completed:
            summary.update(
                status="warmed" if completed else "partial",
                donor=label, pages=result.get("pages", 0),
                chains=result.get("chains", []))
            break
    summary["elapsed_s"] = round(time.monotonic() - started, 4)
    return summary


# --------------------------------------------------------------------------
# Gateway-process half: the remote worker
# --------------------------------------------------------------------------


def _iter_sse(fp: Any) -> Iterator[Tuple[str, Dict[str, Any]]]:
    """Incrementally decode SSE frames from a blocking file-like —
    the streaming twin of ``protocol.parse_sse_stream`` (which needs
    the whole byte string up front)."""
    event, data = "message", None
    while True:
        raw = fp.readline()
        if not raw:
            return  # EOF: the replica is gone
        line = raw.decode("utf-8").rstrip("\r\n")
        if not line:
            if data is not None:
                yield event, json.loads(data)
            event, data = "message", None
            continue
        if line.startswith("event:"):
            event = line[len("event:"):].strip()
        elif line.startswith("data:"):
            data = line[len("data:"):].strip()


class RemoteEngineWorker:
    """An ``EngineWorker``-shaped handle on a replica child process.

    The dispatcher, admission and router code see the exact
    ``EngineWorker`` surface; underneath, each ``submit`` opens one
    HTTP connection to the replica and a reader thread pumps its SSE
    events into the gateway's callbacks (which trampoline themselves
    onto the event loop, same as worker-thread callbacks). A background
    poller keeps a gauge snapshot fresh (``gauges()`` never blocks the
    event loop) and flips ``alive`` when the child stops answering or
    its process exits — the crash signal the dispatcher and supervisor
    act on. Exactly-one-terminal is guaranteed per submit: a snapped
    stream (kill -9, watchdog exit, network error) synthesizes one
    ``aborted`` result.
    """

    def __init__(self, host: str, port: int, *, replica_id: str,
                 proc: Any = None,
                 uds: Optional[str] = None,
                 poll_interval_s: float = 0.1,
                 connect_timeout_s: float = 10.0,
                 ready_timeout_s: float = 60.0,
                 max_probe_failures: int = 3) -> None:
        self.replica_id = replica_id
        self.proc = proc
        self.alive = False
        self.exit_code: Optional[int] = None
        self.pid: Optional[int] = getattr(proc, "pid", None)
        self.page_size: Optional[int] = None
        self.tick_listeners: List[Callable[[], None]] = []
        self._host = host
        self._port = port
        self._uds = uds
        self.poll_interval_s = poll_interval_s
        self.connect_timeout_s = connect_timeout_s
        self.ready_timeout_s = ready_timeout_s
        self.max_probe_failures = max_probe_failures
        self._gauges: Dict[str, float] = {}
        self._inflight_lock = threading.Lock()
        self._inflight: Dict[int, bool] = {}
        self._stop = threading.Event()
        self._probe = threading.Event()
        self._poller = threading.Thread(
            target=self._poll_loop, name=f"remote-poll-{replica_id}",
            daemon=True)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "RemoteEngineWorker":
        """Block until the replica answers ``/healthz`` (it already
        printed READY, so this is one round-trip), learn its pid and
        page size, then start the health/gauge poller."""
        deadline = time.monotonic() + self.ready_timeout_s
        last: Optional[BaseException] = None
        while time.monotonic() < deadline:
            proc = self.proc
            if proc is not None and proc.poll() is not None:
                raise RuntimeError(
                    f"replica {self.replica_id} exited rc="
                    f"{proc.returncode} before serving /healthz")
            try:
                health = self._get_json("/healthz")
                self.pid = health.get("pid", self.pid)
                if self.page_size is None:
                    self.page_size = health.get("page_size")
                break
            except (OSError, http.client.HTTPException, ValueError) as exc:
                last = exc
                time.sleep(0.05)
        else:
            where = self._uds or f"{self._host}:{self._port}"
            raise TimeoutError(
                f"replica {self.replica_id} at {where} "
                f"never answered /healthz: {last}")
        self.alive = True
        self._poller.start()
        return self

    @property
    def address(self) -> Dict[str, Any]:
        """Where a PEER reaches this replica (the donor entry the
        gateway hands a warming recipient)."""
        if self._uds:
            return {"uds": self._uds, "replica": self.replica_id}
        return {"host": self._host, "port": self._port,
                "replica": self.replica_id}

    def warm_start(self, donors: List[Dict[str, Any]], *,
                   backoff_s: float = 0.2,
                   timeout_s: float = 300.0) -> Optional[Dict[str, Any]]:
        """Ask the replica to warm itself from ``donors`` (ranked
        best-first). Blocking until the replica's pull finishes (run
        from an executor); returns the summary payload, or None when
        the replica is unreachable / the warm path is unsupported."""
        try:
            conn = self._connection(timeout=timeout_s)
            try:
                conn.request(
                    "POST", "/v1/warm_start",
                    body=json.dumps({
                        "v": protocol.PROTOCOL_VERSION,
                        "donors": donors,
                        "backoff_s": backoff_s}).encode(),
                    headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                body = resp.read()
                if resp.status != 200:
                    return None
                return json.loads(body.decode("utf-8"))
            finally:
                conn.close()
        except (OSError, http.client.HTTPException, ValueError):
            return None

    def shutdown(self, *, drain: bool = True) -> None:
        """Ask the replica to drain and exit 0. Non-blocking (the
        supervisor/gateway ``join`` to wait); without ``drain`` the
        child is killed outright."""
        if not drain:
            self.kill()
            return
        threading.Thread(
            target=self._post_json_quiet, args=("/v1/drain", {"drain": True}),
            name=f"remote-drain-{self.replica_id}", daemon=True).start()

    def join(self, timeout: Optional[float] = None) -> None:
        proc = self.proc
        if proc is not None:
            try:
                rc = proc.wait(timeout)
            except Exception:
                return
            if self.exit_code is None:
                self.exit_code = rc
            self.alive = False
            return
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        while self.alive and (deadline is None
                              or time.monotonic() < deadline):
            time.sleep(0.02)

    def fail(self, detail: str = "replica marked dead") -> None:
        """The ``gw_replica_down`` drill surface: process-level death."""
        self.kill()

    def kill(self) -> None:
        """SIGKILL the child (the crash drill / hard ejection). The
        poller and the per-request readers observe the death and close
        out state; the supervisor reaps the exit code."""
        proc = self.proc
        if proc is not None and proc.poll() is None:
            proc.kill()
        else:
            self.alive = False
        self._probe.set()

    def stall(self, seconds: float = DEFAULT_HANG_S) -> None:
        """The hang drill: wedge the replica's step loop so its serving
        watchdog fires (exit 44)."""
        threading.Thread(
            target=self._post_json_quiet,
            args=("/v1/hang", {"seconds": seconds}),
            name=f"remote-hang-{self.replica_id}", daemon=True).start()

    # -- EngineWorker surface ----------------------------------------------
    def submit(self, req: GenerateRequest,
               on_tokens: Callable[[int, List[int]], None],
               on_done: Callable[[Any], None],
               *, ttl_s: Optional[float] = None,
               on_submitted: Optional[Callable[[int], None]] = None,
               ) -> None:
        threading.Thread(
            target=self._stream_request,
            args=(req, ttl_s, on_tokens, on_done, on_submitted),
            name=f"remote-req-{self.replica_id}", daemon=True).start()

    def cancel(self, request_id: int, detail: str) -> None:
        threading.Thread(
            target=self._post_json_quiet,
            args=("/v1/cancel",
                  {"request_id": request_id, "detail": detail}),
            name=f"remote-cancel-{self.replica_id}", daemon=True).start()

    def gauges(self) -> Dict[str, float]:
        return dict(self._gauges)

    @property
    def inflight(self) -> int:
        with self._inflight_lock:
            return len(self._inflight)

    # -- internals ---------------------------------------------------------
    def _connection(
        self, timeout: Optional[float] = None,
    ) -> http.client.HTTPConnection:
        t = self.connect_timeout_s if timeout is None else timeout
        if self._uds:
            return _UDSHTTPConnection(self._uds, timeout=t)
        return http.client.HTTPConnection(self._host, self._port,
                                          timeout=t)

    def _get_json(self, path: str) -> Dict[str, Any]:
        conn = self._connection()
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                raise http.client.HTTPException(
                    f"GET {path} -> {resp.status}")
            return json.loads(body.decode("utf-8"))
        finally:
            conn.close()

    def _post_json_quiet(self, path: str, obj: Dict[str, Any]) -> None:
        try:
            conn = self._connection()
            try:
                conn.request(
                    "POST", path, body=json.dumps(obj).encode(),
                    headers={"Content-Type": "application/json"})
                conn.getresponse().read()
            finally:
                conn.close()
        except (OSError, http.client.HTTPException, ValueError):
            pass  # a dead replica can't be cancelled/drained — fine

    def _track(self, request_id: int, present: bool) -> None:
        if request_id < 0:
            return
        with self._inflight_lock:
            if present:
                self._inflight[request_id] = True
            else:
                self._inflight.pop(request_id, None)

    def _fire_tick(self) -> None:
        for listener in self.tick_listeners:
            try:
                listener()
            except Exception:
                pass

    def _make_result(self, req: GenerateRequest, *, request_id: int,
                     outcome: str, finish_reason: str, tokens: List[int],
                     detail: Optional[str],
                     queue_wait_s: Optional[float] = None,
                     prefill_s: Optional[float] = None,
                     prefix_hit: bool = False) -> Any:
        from scaletorch_tpu_torch.inference.engine import RequestResult

        return RequestResult(
            request_id=request_id, prompt=list(req.prompt),
            tokens=list(tokens), finish_reason=finish_reason,
            outcome=outcome, detail=detail, queue_wait_s=queue_wait_s,
            prefill_s=prefill_s, prefix_hit=prefix_hit,
            trace_id=req.trace_id)

    def _stream_request(self, req: GenerateRequest,
                        ttl_s: Optional[float],
                        on_tokens: Callable[[int, List[int]], None],
                        on_done: Callable[[Any], None],
                        on_submitted: Optional[Callable[[int], None]],
                        ) -> None:
        body = json.dumps({
            "v": protocol.PROTOCOL_VERSION,
            "prompt": list(req.prompt),
            "max_new_tokens": req.max_new_tokens,
            "eos_id": req.eos_id,
            "seed": req.seed,
            "ttl_s": ttl_s,
            "tenant": req.tenant,
            "stream": True,
            "trace_id": req.trace_id,
        }).encode()
        request_id = -1
        terminal = False
        partial: List[int] = []
        conn = self._connection()
        try:
            conn.request("POST", "/v1/submit", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            if resp.status != 200:
                detail = resp.read().decode("utf-8", "replace")[:200]
                terminal = True
                on_done(self._make_result(
                    req, request_id=-1, outcome="rejected",
                    finish_reason="rejected", tokens=[],
                    detail=f"replica refused submit "
                           f"({resp.status}): {detail}"))
                return
            # headers arrived under the connect timeout; token gaps are
            # bounded by the engine-side TTL and the serving watchdog,
            # not by a socket timeout (a long prefill must not look
            # like a dead replica)
            if conn.sock is not None:
                conn.sock.settimeout(None)
            for event, payload in _iter_sse(resp):
                if event == "submitted":
                    request_id = payload["request_id"]
                    self._track(request_id, True)
                    if on_submitted is not None:
                        on_submitted(request_id)
                elif event == "token":
                    request_id = payload["request_id"]
                    toks = list(payload["token_ids"])
                    partial.extend(toks)
                    on_tokens(request_id, toks)
                    self._fire_tick()
                elif event == "done":
                    terminal = True
                    self._track(request_id, False)
                    on_done(self._make_result(
                        req, request_id=payload["request_id"],
                        outcome=payload["outcome"],
                        finish_reason=payload["finish_reason"],
                        tokens=payload["token_ids"],
                        detail=payload.get("detail"),
                        queue_wait_s=payload.get("queue_wait_s"),
                        prefill_s=payload.get("prefill_s"),
                        prefix_hit=bool(payload.get("prefix_hit"))))
                    self._fire_tick()
                    return
        except (OSError, http.client.HTTPException, ValueError,
                KeyError) as exc:
            logger.warning("replica %s stream broke: %s",
                           self.replica_id, exc)
        finally:
            conn.close()
            if not terminal:
                # the stream snapped without a terminal (kill -9,
                # watchdog exit, network fault): synthesize EXACTLY ONE
                # aborted result so the gateway's conservation holds
                self._track(request_id, False)
                on_done(self._make_result(
                    req, request_id=request_id, outcome="aborted",
                    finish_reason="aborted", tokens=partial,
                    detail=f"replica {self.replica_id} connection lost "
                           f"mid-stream"))
                self._probe.set()  # re-probe NOW: likely a dead child
                self._fire_tick()

    def _mark_dead(self, exit_code: Optional[int]) -> None:
        if self.exit_code is None:
            self.exit_code = exit_code
        self.alive = False
        self._fire_tick()

    def _poll_loop(self) -> None:
        failures = 0
        while not self._stop.is_set():
            if self._probe.wait(self.poll_interval_s):
                self._probe.clear()
            if self._stop.is_set():
                return
            proc = self.proc
            if proc is not None and proc.poll() is not None:
                self._mark_dead(proc.returncode)
                return
            try:
                data = self._get_json("/metrics")
            except (OSError, http.client.HTTPException, ValueError):
                failures += 1
                if failures >= self.max_probe_failures:
                    self._mark_dead(
                        proc.returncode if proc is not None else None)
                    return
                continue
            failures = 0
            self._gauges = {
                k: v for k, v in data.get("gauges", {}).items()
                if isinstance(v, (int, float))}
            # (pid is NOT refreshed here: it was learned in start() and
            # cannot change while this child lives — a restart swaps the
            # whole worker, so mutation stays confined to start())
            self._fire_tick()

    def stop_polling(self) -> None:
        """Tear down the poller (supervisor replacement path)."""
        self._stop.set()
        self._probe.set()
        # ident is None until start(): join() before then raises
        if self._poller.ident is not None:
            self._poller.join(timeout=5.0)
