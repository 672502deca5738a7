"""ST7xx — the deep tier's audit of the port's entry points.

PyTorch counterpart of the reference's ``analysis/jaxpr_audit.py``. The
reference traced and compiled each registered entry point on virtual
CPU meshes and read the jaxpr and the HLO. The port has no compiled
program: it RUNS each entry once, on the device asked for (the card by
default), with the collective recorder on (``recorder.py``), after one
warm-up call. A mesh entry runs in this one process under the ``fake``
process group at the entry's world size (one rank's shards, every
collective issued and recorded, no peer), so a single card or the CPU
audits a dp2 x cp2 x tp2 step. The checks:

ST700  entry point failed to build or run (the audit itself is part of
       the contract: a manifest entry that stops running is a finding,
       not a skip)
ST701  wire-dtype mismatch on the quantized axis: the entry pins an int8
       gradient all-reduce on an axis, but collectives over that axis
       move non-int8 payloads above 4096 elements, or no int8 at all
ST702  the in-place contract is lost: a parameter, optimizer-state,
       cache or pool tensor the entry updates in place left its storage
       (its ``data_ptr()`` changed across the call), so the call held a
       second copy of it (the port's twin of lost donation)
ST703  a collective over an axis the schedule hoists (the single
       gradient reduction after accumulation) ran INSIDE the microbatch
       loop, once per microbatch instead of once per step
ST704  a single collective result exceeds the entry's replication cap
       (several times the parameter bytes): a large intermediate
       replicated across the mesh

Each entry's builder lives NEXT TO the entry point it audits
(``parallel/spmd.audit_entry``, ``trainer/train_step.audit_entry``,
``inference/decode.audit_entry_prefill`` / ``_decode`` /
``_paged_decode``, ``inference/disagg.audit_entry_prefill_slice`` /
``_decode_slice``) and returns a plain dict: its pinned contract fields
and ``setup(device)``; the runtime modules never import the analyzer.
This module is imported by the ``--tier deep`` / ``--tier memory`` CLI
path and its tests only.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import importlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .core import Finding
from .recorder import Collective, CollectiveRecorder, mesh_axis_names

# (entry name, module, builder attr): the registered audit entries. The
# name is declared here (and echoed by the builder) so --entries can
# filter BEFORE running any builder.
MANIFEST: Tuple[Tuple[str, str, str], ...] = (
    ("spmd_train_step", "scaletorch_tpu_torch.parallel.spmd",
     "audit_entry"),
    ("declarative_train_step", "scaletorch_tpu_torch.trainer.train_step",
     "audit_entry"),
    ("prefill_step", "scaletorch_tpu_torch.inference.decode",
     "audit_entry_prefill"),
    ("decode_step", "scaletorch_tpu_torch.inference.decode",
     "audit_entry_decode"),
    ("paged_decode_step", "scaletorch_tpu_torch.inference.decode",
     "audit_entry_paged_decode"),
    ("disagg_prefill_slice", "scaletorch_tpu_torch.inference.disagg",
     "audit_entry_prefill_slice"),
    ("disagg_decode_slice", "scaletorch_tpu_torch.inference.disagg",
     "audit_entry_decode_slice"),
)

# Payloads at or below this many elements over the quantized axis are
# sidecar traffic (the per-block fp32 scales, scalar loss/metric means)
# and exempt from the ST701 wire-dtype check.
_SMALL_ELEMS = 4096

_WIRE_DTYPE = {"int8": "int8", "bf16": "bfloat16", "fp32": "float32"}


class NoDeviceError(RuntimeError):
    """The device asked for is not there (a usage error at the CLI)."""


def check_device(device: str) -> torch.device:
    """``device`` as a ``torch.device``; "cuda" without a card raises:
    the deep and memory tiers never fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoDeviceError(
            "no CUDA device: the deep and memory tiers run on the card "
            "(pass --device cpu for the CPU run)")
    return dev


# -- entry loading ------------------------------------------------------------

def load_entries(
    names: Optional[Sequence[str]] = None,
) -> Tuple[List[dict], List[Finding]]:
    """Build the manifest's entry dicts; builder failures become ST700
    findings instead of crashing the whole audit."""
    entries: List[dict] = []
    errors: List[Finding] = []
    known = [name for name, _, _ in MANIFEST]
    if names:
        for n in sorted(set(names) - set(known)):
            errors.append(Finding(
                file="scaletorch_tpu_torch/analysis/entry_audit.py", line=1,
                code="ST700", severity="error",
                message=f"unknown audit entry {n!r}; known: {sorted(known)}",
            ))
    for name, mod_name, attr in MANIFEST:
        if names and name not in names:
            continue  # scoped runs never execute unselected builders
        try:
            mod = importlib.import_module(mod_name)
            entry = getattr(mod, attr)()
        except Exception as exc:
            errors.append(Finding(
                file=mod_name.replace(".", "/") + ".py", line=1,
                code="ST700", severity="error",
                message=f"audit entry builder {mod_name}.{attr} failed: "
                        f"{exc!r}",
            ))
            continue
        if entry["name"] != name:
            errors.append(Finding(
                file=mod_name.replace(".", "/") + ".py", line=1,
                code="ST700", severity="error",
                message=(
                    f"audit entry builder {mod_name}.{attr} returned name "
                    f"{entry['name']!r} but the manifest registers it as "
                    f"{name!r}"
                ),
            ))
            continue
        entries.append(entry)
    return entries, errors


# -- the shared run -----------------------------------------------------------

@dataclasses.dataclass
class RunEntry:
    """One manifest entry run once, measured: the shared substrate of
    the deep tier (ST7xx/ST8xx, this module) and the memory tier
    (ST10xx, ``memory.py``), so ``--tier deep,memory`` runs each entry
    once for both."""

    entry: dict
    device: str
    records: List[Collective]
    # name -> (data_ptr before, data_ptr after, bytes)
    inplace: Dict[str, Tuple[int, int, int]]
    launches: Dict[str, int]
    memory: Any             # memory.MemoryRun
    seconds: float


@contextlib.contextmanager
def fake_world(world: int):
    """One process standing for a world of ``world`` ranks (rank 0):
    the ``fake`` process group, whose collectives return at once."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError(
            "a process group is already initialised in this process; the "
            "audit's fake world needs its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _loop_marker(path: Optional[str], rec: CollectiveRecorder,
                 microbatches: Optional[int]):
    """Wrap the entry's microbatch selector (``module.function(batch,
    a)``) so the recorder knows which microbatch runs."""
    if not path:
        yield
        return
    mod_name, attr = path.rsplit(".", 1)
    mod = importlib.import_module(mod_name)
    original = getattr(mod, attr)

    def marked(batch, a, *args, **kwargs):
        rec.microbatch = a
        return original(batch, a, *args, **kwargs)

    rec.microbatches = microbatches
    setattr(mod, attr, marked)
    try:
        yield
    finally:
        setattr(mod, attr, original)
        rec.microbatch = None


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_entry(entry: dict, device: str = "cuda"
              ) -> Tuple[Optional[RunEntry], List[Finding]]:
    """Build one entry on ``device`` and run it: a warm-up call, then one
    measured call with the collective recorder and the memory tier's
    observers on. Failures become ST700 findings, in which case the
    RunEntry is None."""
    import time

    from scaletorch_tpu_torch.ops import _build
    from scaletorch_tpu_torch.parallel.mesh import using_mesh_manager

    from . import memory

    dev = check_device(device)
    name, file = entry["name"], entry["file"]
    world = int(entry.get("world_size", 1))
    grad = bool(entry.get("grad", False))
    try:
        with contextlib.ExitStack() as stack:
            if world > 1:
                stack.enter_context(fake_world(world))
            stack.enter_context(using_mesh_manager(None))
            if not grad:
                stack.enter_context(torch.no_grad())
            prepared = entry["setup"](dev)
            mm = prepared.get("mesh")
            if mm is not None:
                stack.callback(mm.destroy)
            prepared["call"]()  # warm-up: first-use builds and buffers
            _sync(dev)
            rec = CollectiveRecorder(mesh_axis_names(mm) if mm else {})
            inplace = prepared.get("inplace", {})
            before = {k: (t.data_ptr(), t.untyped_storage().nbytes())
                      for k, t in inplace.items()}
            held = [t.untyped_storage() for t in inplace.values()]
            launches0 = collections.Counter(_build.launch_counts)
            t0 = time.perf_counter()
            with _loop_marker(entry.get("loop_marker"), rec,
                              entry.get("microbatches")):
                mem = memory.measure(prepared, dev, rec)
            seconds = time.perf_counter() - t0
            del held
            after = {k: t.data_ptr() for k, t in inplace.items()}
            launches = collections.Counter(_build.launch_counts) - launches0
    except Exception as exc:
        return None, [Finding(
            file=file, line=1, code="ST700", severity="error",
            message=f"audit entry {name!r} failed to build or run on "
                    f"{dev.type}: {exc!r}",
        )]
    return RunEntry(
        entry=entry, device=dev.type, records=list(rec.records),
        inplace={k: (before[k][0], after[k], before[k][1]) for k in before},
        launches=dict(launches), memory=mem, seconds=seconds,
    ), []


# -- the audit ----------------------------------------------------------------

def audit_run(run: RunEntry) -> Tuple[List[Finding], dict]:
    """The ST7xx checks and the comm report of a measured entry."""
    entry = run.entry
    findings: List[Finding] = []
    findings.extend(check_wire_dtype(entry, run.records))
    findings.extend(check_inplace(entry, run.inplace))
    findings.extend(check_hoisting(entry, run.records))
    findings.extend(check_replication(entry, run.records))
    return findings, comm_report(run.records)


# -- checks -------------------------------------------------------------------

def check_wire_dtype(entry: dict, cols: List[Collective]) -> List[Finding]:
    qa = entry.get("quantized_axis")
    if not qa:
        return []
    axis, cfg_dtype = qa
    want = _WIRE_DTYPE.get(cfg_dtype, cfg_dtype)
    if want == "float32":
        return []  # nothing quantized to verify
    on_axis = [c for c in cols if axis in c.axes]
    out: List[Finding] = []
    for c in on_axis:
        if c.elems > _SMALL_ELEMS and c.dtype != want:
            out.append(Finding(
                file=entry["file"], line=1, code="ST701", severity="error",
                message=(
                    f"entry {entry['name']!r}: configured {cfg_dtype} wire "
                    f"on axis {axis!r}, but the step runs `{c.op}` over "
                    f"{c.axis} with {c.elems} {c.dtype} elements — the "
                    "quantized all-reduce was silently bypassed (wire "
                    f"bytes ~{4 if want == 'int8' else 2}x over budget on "
                    "the data-parallel edge)"
                ),
            ))
    if not any(c.dtype == want for c in on_axis):
        out.append(Finding(
            file=entry["file"], line=1, code="ST701", severity="error",
            message=(
                f"entry {entry['name']!r}: configured {cfg_dtype} wire on "
                f"axis {axis!r}, but no {want} collective over that axis "
                "ran at all — the quantized path is not on the step's path"
            ),
        ))
    return out


def check_inplace(entry: dict,
                  inplace: Dict[str, Tuple[int, int, int]]) -> List[Finding]:
    if not entry.get("expect_inplace"):
        return []
    moved = sorted(k for k, (before, after, _) in inplace.items()
                   if before != after)
    if not moved:
        return []
    shown = ", ".join(moved[:4]) + (" ..." if len(moved) > 4 else "")
    return [Finding(
        file=entry["file"], line=1, code="ST702", severity="error",
        message=(
            f"entry {entry['name']!r} updates its parameters / optimizer "
            f"state / cache in place, but {len(moved)} of them left their "
            f"storage across one call ({shown}) — the in-place update was "
            "lost (the step holds a second copy of those buffers)"
        ),
    )]


def check_hoisting(entry: dict, cols: List[Collective]) -> List[Finding]:
    hoisted = set(entry.get("hoisted_axes", ()))
    if not hoisted:
        return []
    out: List[Finding] = []
    for c in cols:
        bad = hoisted & set(c.axes)
        if c.in_loop and bad:
            out.append(Finding(
                file=entry["file"], line=1, code="ST703", severity="error",
                message=(
                    f"entry {entry['name']!r}: `{c.op}` over {sorted(bad)} "
                    "runs INSIDE the microbatch loop — the schedule "
                    "reduces this axis once per step after accumulation, "
                    "not once per microbatch"
                ),
            ))
    return out


def check_replication(entry: dict, cols: List[Collective]) -> List[Finding]:
    cap_mb = entry.get("max_collective_result_mb")
    if not cap_mb:
        return []
    out: List[Finding] = []
    for c in cols:
        mb = c.result_bytes / 1e6
        if mb > cap_mb:
            out.append(Finding(
                file=entry["file"], line=1, code="ST704", severity="error",
                message=(
                    f"entry {entry['name']!r}: a `{c.op}` result is "
                    f"{mb:.2f} MB (> cap {cap_mb:.2f} MB, several times "
                    "the parameter bytes) — a large intermediate is being "
                    "replicated across the mesh instead of staying sharded"
                ),
            ))
    return out


# -- comm report (budget backend) ---------------------------------------------

def comm_report(cols: List[Collective]) -> dict:
    """Per-mesh-axis counts and payload, and per-(op, dtype) wire bytes:
    the two ledgers the comm budget pins (the reference's keys: axis
    groups, and ``op:dtype`` in HLO dtype names)."""
    axes: Dict[str, Dict[str, float]] = {}
    wire: Dict[str, Dict[str, float]] = {}
    total = 0.0
    for c in cols:
        key = ",".join(sorted(c.axes)) or "<unnamed>"
        slot = axes.setdefault(key, {"count": 0, "payload_mb": 0.0})
        slot["count"] += 1
        slot["payload_mb"] += c.bytes / 1e6
        slot = wire.setdefault(f"{c.op}:{c.hlo_dtype}",
                               {"count": 0, "wire_mb": 0.0})
        slot["count"] += 1
        slot["wire_mb"] += c.wire_bytes / 1e6
        total += c.wire_bytes / 1e6
    for slot in axes.values():
        slot["payload_mb"] = round(slot["payload_mb"], 4)
    for slot in wire.values():
        slot["wire_mb"] = round(slot["wire_mb"], 4)
    return {"axes": axes, "hlo": wire, "total_wire_mb": round(total, 4)}
