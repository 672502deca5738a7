"""Wire schema of the serving gateway: requests, responses, SSE events.

A copy of scaletorch_tpu/serving/protocol.py (standard library only):
names, grammar and every byte on the wire are the reference's, and the
port imports nothing of the JAX package.

Versioned exactly like the telemetry JSONL envelope (one integer ``v``
carried on every payload; additive fields keep it, renames/removals/
semantic changes bump it — the policy of telemetry/export.py). Pure
stdlib, no torch: the schema is shared by the gateway (server side), the
smoke client (chip_smoke.py's gateway phases) and the tests, and none of them
should pay a device runtime import to talk JSON.

The HTTP layer speaks the engine's terminal-outcome taxonomy: every request
that reaches the gateway ends in exactly one of
``inference.resilience.TERMINAL_OUTCOMES`` and every outcome maps to
exactly one HTTP status (``STATUS_BY_OUTCOME``), so the engine's
conservation invariant ``requests == sum(outcomes)`` extends to the
wire — ``http_requests_received == sum(outcomes over HTTP responses)``.

SSE stream grammar (``POST /v1/generate`` with ``stream: true``):

    event: token                     one per engine tick with new tokens
    data: {"v":1,"request_id":7,"token_ids":[421]}

    event: done                      exactly one, closes the stream
    data: {"v":1,"request_id":7,"outcome":"ok","finish_reason":"length",
           "token_ids":[...],"detail":null,
           "usage":{"prompt_tokens":4,"completion_tokens":16}}

A non-``ok`` terminal rides a ``done`` event too (``outcome`` says
what happened, partial ``token_ids`` attached) — a stream, once open,
always ends with exactly one ``done``.
"""

from __future__ import annotations

import hashlib
import json
import re
import secrets
import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# Bump on renames/removals/semantic changes; additive fields keep it.
PROTOCOL_VERSION = 1

# The single outcome -> HTTP status mapping (non-streaming responses;
# streaming responses commit 200 at stream open and carry the outcome on
# the final `done` event instead). `shed` answers 429 with a Retry-After
# header so well-behaved clients back off before latency degrades.
# The keys mirror ``inference.resilience.TERMINAL_OUTCOMES`` exactly —
# asserted by test_protocol, NOT imported here: this module stays pure
# stdlib so wire clients (the smoke script, config's tenant-spec parse)
# never pay a torch import to talk JSON.
STATUS_BY_OUTCOME: Dict[str, int] = {
    "ok": 200,
    "shed": 429,
    "timeout": 504,
    "rejected": 503,
    "quarantined": 500,
    "aborted": 503,
}

# Protocol violations (malformed JSON, bad fields) are client errors —
# they still map onto the taxonomy (outcome `rejected`) so conservation
# holds, but answer 400, not 503: the request never reached admission.
BAD_REQUEST_STATUS = 400

DEFAULT_TENANT = "default"


# --------------------------------------------------------------------------
# W3C trace context (traceparent)
# --------------------------------------------------------------------------
#
# The gateway accepts a standard ``traceparent`` request header
# (https://www.w3.org/TR/trace-context/), threads the 128-bit trace id
# through the engine as the request's span-correlation key, and echoes
# a ``traceparent`` response header carrying the same trace id with the
# gateway's own span id as the new parent. A request without the header
# — or with a malformed one — gets a FRESH trace id: bad tracing input
# from a client must degrade to "uncorrelated", never to an error
# (fuzz-tested in tests/serving/test_protocol.py).

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})"
    r"(?:-.*)?$")


def parse_traceparent(header: Optional[str]) -> Optional[Tuple[str, str]]:
    """``traceparent`` header -> ``(trace_id, parent_span_id)``, or
    None for absent/malformed input (the caller mints a fresh trace).
    Per spec: lowercase hex only, version ``ff`` is invalid, all-zero
    trace/span ids are invalid, and a version above ``00`` may carry
    extra ``-``-delimited fields (accepted, ignored) while version
    ``00`` must have exactly four."""
    if not header or not isinstance(header, str):
        return None
    match = _TRACEPARENT_RE.match(header.strip())
    if match is None:
        return None
    version, trace_id, span_id, _flags = match.groups()
    if version == "ff":
        return None
    if version == "00" and header.strip().count("-") != 3:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


def new_trace_id() -> str:
    """Random 128-bit lowercase-hex trace id (never all-zero)."""
    while True:
        tid = secrets.token_hex(16)
        if tid != "0" * 32:
            return tid


def new_span_id() -> str:
    """Random 64-bit lowercase-hex span id (never all-zero)."""
    while True:
        sid = secrets.token_hex(8)
        if sid != "0" * 16:
            return sid


def make_traceparent(trace_id: str, span_id: Optional[str] = None,
                     *, sampled: bool = True) -> str:
    """Format a version-00 ``traceparent`` (the response-header echo)."""
    return (f"00-{trace_id}-{span_id or new_span_id()}-"
            f"{'01' if sampled else '00'}")


class ProtocolError(ValueError):
    """A request that violates the wire schema. ``status`` is the HTTP
    answer — 400 by default, e.g. 413 for an oversized body."""

    def __init__(self, message: str,
                 status: int = BAD_REQUEST_STATUS) -> None:
        super().__init__(message)
        self.status = status


@dataclass
class GenerateRequest:
    """Body of ``POST /v1/generate``.

    ``prompt`` is a non-empty list of token ids (the gateway serves
    tokens, not text — tokenization is the client's, matching the
    engine's contract). ``tenant`` scopes fairness/rate limiting (the
    ``x-tenant`` header is the fallback); ``stream`` selects SSE
    streaming (default) vs a single JSON response; ``ttl_s`` is the
    request deadline (None = the gateway's default). ``trace_id`` is
    NOT a body field: the gateway sets it from the ``traceparent``
    header (or mints one) and it rides here so the worker bridge can
    hand it to ``engine.submit``.
    """

    prompt: List[int]
    max_new_tokens: int = 64
    eos_id: Optional[int] = None
    seed: int = 0
    ttl_s: Optional[float] = None
    tenant: str = DEFAULT_TENANT
    stream: bool = True
    trace_id: Optional[str] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    @property
    def cost(self) -> int:
        """The WFQ/token-bucket service cost: the tokens this request
        can touch (prompt read + generation budget)."""
        return len(self.prompt) + self.max_new_tokens


def parse_generate_request(
    body: bytes, *, header_tenant: Optional[str] = None
) -> GenerateRequest:
    """Validate a request body into a ``GenerateRequest``; raises
    ``ProtocolError`` (HTTP 400) with a client-actionable message."""
    try:
        obj = json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise ProtocolError(f"body is not valid JSON: {exc}") from None
    if not isinstance(obj, dict):
        raise ProtocolError(
            f"body must be a JSON object, got {type(obj).__name__}")

    prompt = obj.get("prompt")
    if (not isinstance(prompt, list) or not prompt
            or not all(isinstance(t, int) and not isinstance(t, bool)
                       for t in prompt)):
        raise ProtocolError(
            "'prompt' must be a non-empty array of integer token ids")

    def _int(name: str, default: int, minimum: int) -> int:
        v = obj.get(name, default)
        if not isinstance(v, int) or isinstance(v, bool) or v < minimum:
            raise ProtocolError(
                f"'{name}' must be an integer >= {minimum}, got {v!r}")
        return v

    max_new = _int("max_new_tokens", 64, 1)
    seed = _int("seed", 0, 0)
    eos_id = obj.get("eos_id")
    if eos_id is not None and (not isinstance(eos_id, int)
                               or isinstance(eos_id, bool)):
        raise ProtocolError(f"'eos_id' must be an integer, got {eos_id!r}")
    ttl_s = obj.get("ttl_s")
    if ttl_s is not None:
        if not isinstance(ttl_s, (int, float)) or isinstance(ttl_s, bool) \
                or ttl_s <= 0:
            raise ProtocolError(
                f"'ttl_s' must be a positive number, got {ttl_s!r}")
        ttl_s = float(ttl_s)
    tenant = obj.get("tenant", header_tenant or DEFAULT_TENANT)
    if not isinstance(tenant, str) or not tenant:
        raise ProtocolError(
            f"'tenant' must be a non-empty string, got {tenant!r}")
    stream = obj.get("stream", True)
    if not isinstance(stream, bool):
        raise ProtocolError(f"'stream' must be a boolean, got {stream!r}")
    known = {"prompt", "max_new_tokens", "eos_id", "seed", "ttl_s",
             "tenant", "stream"}
    return GenerateRequest(
        prompt=list(prompt), max_new_tokens=max_new, eos_id=eos_id,
        seed=seed, ttl_s=ttl_s, tenant=tenant, stream=stream,
        extra={k: v for k, v in obj.items() if k not in known},
    )


# --------------------------------------------------------------------------
# Server -> client payloads
# --------------------------------------------------------------------------


def result_payload(request_id: int, *, outcome: str, finish_reason: str,
                   token_ids: List[int], prompt_tokens: int,
                   detail: Optional[str] = None,
                   trace_id: Optional[str] = None) -> Dict[str, Any]:
    """The terminal record of one request — the ``done`` SSE event's
    data and the whole body of a non-streaming response. ``trace_id``
    (additive, v stays 1) lets a client join its response to the
    server-side trace and access log."""
    return {
        "v": PROTOCOL_VERSION,
        "request_id": request_id,
        "outcome": outcome,
        "finish_reason": finish_reason,
        "token_ids": token_ids,
        "detail": detail,
        "trace_id": trace_id,
        "usage": {
            "prompt_tokens": prompt_tokens,
            "completion_tokens": len(token_ids),
        },
    }


def token_payload(request_id: int, token_ids: List[int]) -> Dict[str, Any]:
    return {
        "v": PROTOCOL_VERSION,
        "request_id": request_id,
        "token_ids": token_ids,
    }


def error_payload(message: str, *, outcome: str = "rejected",
                  retry_after_s: Optional[float] = None) -> Dict[str, Any]:
    """Body of a non-200 JSON response (shed/rejected before a request
    id exists)."""
    payload: Dict[str, Any] = {
        "v": PROTOCOL_VERSION,
        "outcome": outcome,
        "detail": message,
    }
    if retry_after_s is not None:
        payload["retry_after_s"] = retry_after_s
    return payload


# --------------------------------------------------------------------------
# SSE framing
# --------------------------------------------------------------------------


def format_sse_event(event: str, payload: Dict[str, Any]) -> bytes:
    """One Server-Sent-Events frame: ``event:`` + single-line ``data:``
    (the payload is JSON, which never embeds a raw newline)."""
    return (f"event: {event}\ndata: {json.dumps(payload)}\n\n"
            ).encode("utf-8")


def parse_sse_stream(raw: bytes) -> List[Tuple[str, Dict[str, Any]]]:
    """Decode a full SSE byte stream into ``(event, payload)`` pairs —
    the client half of ``format_sse_event`` (smoke script + tests)."""
    events: List[Tuple[str, Dict[str, Any]]] = []
    for frame in raw.decode("utf-8").split("\n\n"):
        if not frame.strip():
            continue
        name, data = "message", None
        for line in frame.split("\n"):
            if line.startswith("event:"):
                name = line[len("event:"):].strip()
            elif line.startswith("data:"):
                payload = line[len("data:"):].strip()
                data = json.loads(payload) if payload else None
        if data is not None:
            events.append((name, data))
    return events


def stream_tokens(events: List[Tuple[str, Dict[str, Any]]]) -> List[int]:
    """Concatenate a stream's ``token`` events — must equal the ``done``
    event's ``token_ids`` bit-exactly (the acceptance oracle)."""
    out: List[int] = []
    for name, payload in events:
        if name == "token":
            out.extend(payload["token_ids"])
    return out


# --------------------------------------------------------------------------
# Warm-transfer framing (POST /warm response stream)
# --------------------------------------------------------------------------
#
# The warm-rejoin path streams frozen KV pages donor -> recipient as a
# sequence of length-prefixed binary frames over one HTTP response body
# (chunked transfer is overkill: the connection closes at end-of-stream
# anyway, and a snapped socket is a first-class failure mode the frames
# must survive). Frame layout:
#
#     !4s  magic     b"STWM"
#     !I   index     0 = JSON meta frame; 1..N = page frames (index i
#                    carries the i-th entry of the request's ``pages``
#                    list, so a resume at ``start_chunk`` re-aligns by
#                    position); 0xFFFFFFFF = clean end-of-stream marker
#                    (its absence means the donor died mid-transfer)
#     !I   payload_len
#     !32s sha256(payload)  per-chunk checksum: a mismatch drops THIS
#                    chunk only, the rest of the stream stays usable
#
# Page-frame payload: ``!III page_id len_k len_v`` + k_bytes + v_bytes.
# A page the donor no longer holds frozen ships as a zero-content frame
# (lengths 0) so indices stay aligned for resume.

WARM_MAGIC = b"STWM"
WARM_END_INDEX = 0xFFFFFFFF
WARM_HEADER = struct.Struct("!4sII32s")
WARM_PAGE_HEADER = struct.Struct("!III")
# a page frame is bounded by pool geometry; 256 MiB is far beyond any
# real page and cheap insurance against a garbage length field
MAX_WARM_PAYLOAD = 256 * 2**20


def encode_warm_frame(index: int, payload: bytes) -> bytes:
    """One warm-transfer frame: header (magic, index, length, sha256)
    followed by the payload bytes."""
    digest = hashlib.sha256(payload).digest()
    return WARM_HEADER.pack(WARM_MAGIC, index, len(payload),
                            digest) + payload


def corrupt_warm_frame(frame: bytes) -> bytes:
    """The ``--ft_gw_warm_corrupt_chunk_at`` drill: flip the last
    payload byte AFTER checksumming, so the recipient's per-chunk
    verification must catch it. Frames with an empty payload corrupt
    the checksum itself instead."""
    out = bytearray(frame)
    out[-1] ^= 0xFF
    return bytes(out)


def encode_warm_page_payload(page_id: int, k_bytes: bytes,
                             v_bytes: bytes) -> bytes:
    """Page-frame payload: id + both cache halves (k then v)."""
    return WARM_PAGE_HEADER.pack(
        page_id, len(k_bytes), len(v_bytes)) + k_bytes + v_bytes


def decode_warm_page_payload(
        payload: bytes) -> Tuple[int, bytes, bytes]:
    """Inverse of ``encode_warm_page_payload``; raises ProtocolError on
    a malformed payload (lengths not adding up)."""
    if len(payload) < WARM_PAGE_HEADER.size:
        raise ProtocolError("warm page payload too short")
    page_id, len_k, len_v = WARM_PAGE_HEADER.unpack_from(payload)
    if WARM_PAGE_HEADER.size + len_k + len_v != len(payload):
        raise ProtocolError(
            f"warm page payload length mismatch for page {page_id}")
    k = payload[WARM_PAGE_HEADER.size:WARM_PAGE_HEADER.size + len_k]
    v = payload[WARM_PAGE_HEADER.size + len_k:]
    return page_id, k, v


def read_warm_frame(fp: Any) -> Optional[Tuple[int, bytes, bool]]:
    """Read exactly one frame off a blocking file-like (``resp.read``
    semantics: may return short on EOF). Returns ``(index, payload,
    checksum_ok)``, or ``None`` on EOF / a truncated or garbled header
    — the caller treats that as a snapped stream and resumes from the
    last good chunk."""
    header = _read_exact(fp, WARM_HEADER.size)
    if header is None:
        return None
    magic, index, length, digest = WARM_HEADER.unpack(header)
    if magic != WARM_MAGIC or length > MAX_WARM_PAYLOAD:
        return None
    payload = _read_exact(fp, length) if length else b""
    if payload is None:
        return None
    ok = hashlib.sha256(payload).digest() == digest
    return index, payload, ok


def _read_exact(fp: Any, n: int) -> Optional[bytes]:
    chunks = []
    remaining = n
    while remaining > 0:
        chunk = fp.read(remaining)
        if not chunk:
            return None
        chunks.append(chunk)
        remaining -= len(chunk)
    return b"".join(chunks)
