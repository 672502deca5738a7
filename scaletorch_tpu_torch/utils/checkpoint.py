"""Training checkpoints: save and resume of the parameters, the optimizer
state of any of the port's optimizers (its ``count`` included; bf16
leaves stay bf16), the step and a JSON ``extra``
(counterpart of scaletorch_tpu/utils/checkpoint.py).

Each step is a directory ``<directory>/<step>`` written by
``torch.distributed.checkpoint`` (DCP), plus ``extra.json``. A step is
written under a temporary name and renamed when complete, so a partial
write is never the latest step.

``save`` first copies the state into host buffers (pinned when it lives
on the card; allocated once and reused) and waits for that copy once,
so the training step that follows may update the parameters and state
in place; with ``async_save`` a writer thread then writes the snapshot
while training goes on. Every write runs under ``retry_with_backoff``;
a save that still fails is logged and training goes on without it. A
failed asynchronous write is reported by the next ``wait``, which turns
the manager synchronous and writes the snapshot once more. ``keep_n``
keeps the newest steps. ``verify`` reads back each saved step's tree
(names, shapes, dtypes) and retires a step that differs.
``load_latest`` restores the newest readable step into the live
tensors, in place: it reads into host buffers first, so a step that
fails to read leaves the live state untouched, falls back to the step
before and retires the unreadable ones.

With a process group (``group``, and the ``mesh`` the live shards lie
on; one process too) every leaf is saved as a global
``DTensor`` over a CPU ``DeviceMesh`` of the mesh's shape: ``Shard(dim)``
over the axes that split it (tp, pp, ep, from ``split_dims``),
``Replicate`` over dp and cp, so DCP writes each distinct shard once and
a rank's bytes on disk are about 1/(its replica count) of the step. The
DCP collectives run over ``group``, a gloo group of the checkpoint's own
(the writer thread uses nothing else). Over more than one process
(a ``decision_bus`` of more than one) every decision is agreed on the
bus, as the reference's ``_coordinated_save``/``_coordinated_load``:
whether the step is already listed (all: a symmetric no-op; some: the
stale copy is retired and every rank saves), each attempt's outcome
(retry, degrade to synchronous and give-up in lockstep; exhausted
retries return False on every rank), the step list of rank 0 and each
restore attempt (``ok`` / ``retriable`` / ``fatal``: a step unreadable
anywhere falls back to the previous step everywhere). A restore reads
the global tensors onto the live layout (``target_mesh``: dp4 → dp2, one
card → tp2 x dp2, tp2 → one card). ``extra.json`` records the stacked
layer layout (``layout``: the pp padding or interleave); a restore onto
another stacked layout raises ``CheckpointLayoutError`` and loads
nothing. A transport error under a save or a restore (a lost peer) is
raised as itself, never agreed, retried or counted against the step.
Without a group the manager writes plain tensors in one
process, no collective; either kind of step restores through the other.

``fault_injector`` (the trainer passes its ``FaultInjector``) makes the
first ``ft_fail_saves`` write attempts fail, which drills the retries;
over processes the failure is raised inside DCP's write, which DCP
reports to every rank.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import time
import warnings
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import torch

from scaletorch_tpu_torch.resilience import retry_with_backoff
from scaletorch_tpu_torch.utils.logger import get_logger

Tree = Dict[str, Any]

EXTRA_FILE = "extra.json"
_TMP_PREFIX = ".tmp-"
# the stacked layer layout of a run whose layer axis is the model's order
PLAIN_LAYOUT = {"stacked": "plain"}


def layout_key(layout: Dict[str, Any]) -> Dict[str, Any]:
    """A stacked layout as it decides the rows: the virtual stages count
    only for ``interleaved`` (a padded or plain split ignores them)."""
    key = dict(layout)
    if key.get("stacked") != "interleaved":
        key.pop("vpp", None)
    return key


class CheckpointLayoutError(ValueError):
    """The checkpoint's stacked layer axis is padded or ordered for
    another pipeline layout: restoring it would read pad rows or permuted
    layers."""


def _flatten(tree: Tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    flat: Dict[str, torch.Tensor] = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            flat.update(_flatten(value, f"{name}."))
        else:
            flat[name] = value
    return flat


def _map(fn, tree: Tree, prefix: str = "") -> Tree:
    """``fn(name, leaf)`` over a nested tree, names dotted."""
    return {k: _map(fn, v, f"{prefix}{k}.") if isinstance(v, dict)
            else fn(f"{prefix}{k}", v) for k, v in tree.items()}


def _causes(exc: BaseException) -> list:
    return [f[0] if isinstance(f, tuple) else f
            for f in getattr(exc, "failures", {}).values()]


def _dcp_call(name: str, state: Tree, path: str, *, group: Any = None,
              writer: Any = None) -> None:
    """``torch.distributed.checkpoint.save`` or ``load`` of ``state`` at
    ``path``: in one process without ``group``, else over ``group`` (a
    collective). Its ``CheckpointException`` (a ``BaseException``) comes
    out as an ``OSError`` when the failure under it was one, so the
    retries see it, else as a ``RuntimeError``."""
    import torch.distributed.checkpoint as dcp

    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*torch.distributed is "
                                "disabled, unavailable or uninitialized.*")
        kw = {} if group is None else {"process_group": group}
        try:
            if name == "save":
                dcp.save(state, storage_writer=writer
                         or dcp.FileSystemWriter(path), **kw)
            else:
                dcp.load(state, storage_reader=dcp.FileSystemReader(path),
                         **kw)
        except dcp.api.CheckpointException as exc:
            causes = _causes(exc)
            kind = (OSError if any(isinstance(c, OSError) for c in causes)
                    else RuntimeError)
            raise kind(f"checkpoint {name} at {path} failed: "
                       f"{causes!r}") from None


def _raise_lost_peer(exc: Exception) -> None:
    """Raise ``exc`` when a peer was lost under it (a transport error of
    the checkpoint's collectives): the group cannot carry an agreed retry
    (gloo closes a pair that timed out), and a checkpoint that was not
    read is not unreadable. The trainer's elastic loop, or the run's end,
    takes it from there."""
    from scaletorch_tpu_torch.resilience_distributed import (
        is_transport_error,
    )

    if is_transport_error(exc):
        raise exc


def _failing_writer(path: str, fail):
    """A ``FileSystemWriter`` whose ``write_data`` raises an ``OSError``
    when ``fail()`` says so (the injected save failure over processes:
    DCP gathers it and every rank's save fails alike)."""
    import torch.distributed.checkpoint as dcp

    class Writer(dcp.FileSystemWriter):
        def write_data(self, plan, planner):
            if fail():
                raise OSError("injected checkpoint save failure")
            return super().write_data(plan, planner)

    return Writer(path)


class CheckpointManager:
    """Step-indexed checkpoints with retention, resume and retries."""

    def __init__(
        self,
        directory: str,
        keep_n: int = 3,
        async_save: bool = False,
        retries: int = 3,
        retry_base_delay: float = 0.5,
        fault_injector: Optional[Any] = None,
        verify: bool = False,
        *,
        decision_bus: Optional[Any] = None,
        mesh: Optional[Any] = None,
        split_dims: Optional[Dict[str, Dict[str, int]]] = None,
        group: Optional[Any] = None,
        layout: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._keep_n = keep_n
        self._async = async_save
        self.retries = retries
        self.retry_base_delay = retry_base_delay
        # any object whose take_save_failure() returns True to fail a write
        self._injector = fault_injector
        self._verify = verify
        # resilience_distributed.DecisionBus: the agreement between
        # processes; None (or one process) is the one-process manager
        self._bus = (decision_bus if decision_bus is not None
                     and decision_bus.num_processes > 1 else None)
        self._mesh = mesh
        self._split_dims = split_dims or {}
        self._group = group
        if group is not None:
            # DCP's modules load here, not in the first save or restore:
            # a rank admitted by an elastic grow restores at once with
            # ranks that loaded them long ago, inside the group's timeout
            import torch.distributed.checkpoint  # noqa: F401
        # the process-group path: global tensors over ``group`` (a group
        # of one process included)
        self._global = (group is not None and mesh is not None
                        and mesh.mesh is not None)
        self._layout = dict(layout or PLAIN_LAYOUT)
        self._dcp_meshes: Dict[Tuple[int, ...], Any] = {}
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pending: Optional[Tuple[int, Future, Any]] = None
        self._buffers: Dict[str, torch.Tensor] = {}
        # seconds of each save: {"step", "blocking_s", "total_s"} (total_s
        # appears when its write has finished), and of the latest restore
        self.saves: List[Dict[str, float]] = []
        self.last_restore: Dict[str, float] = {}

    @property
    def _coordinated(self) -> bool:
        return self._bus is not None

    @property
    def _is_main(self) -> bool:
        return self._bus is None or self._bus.is_main

    # -- listing --------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> List[int]:
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit()
                      and os.path.isdir(self._step_dir(int(name))))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _listed(self, step: int) -> bool:
        """Whether this process's view of the directory lists ``step``."""
        return os.path.exists(self._step_dir(step))

    def delete(self, step: int) -> None:
        shutil.rmtree(self._step_dir(step))

    def step_bytes(self, step: int) -> int:
        """Bytes on disk of one saved step."""
        root = self._step_dir(step)
        return sum(os.path.getsize(os.path.join(d, f))
                   for d, _, files in os.walk(root) for f in files)

    def rank_bytes(self, step: int, rank: int) -> int:
        """Bytes of the data files process ``rank`` wrote for ``step``
        (DCP names them ``__<rank>_<i>.distcp``)."""
        return sum(os.path.getsize(p) for p in glob.glob(os.path.join(
            self._step_dir(step), f"__{rank}_*.distcp")))

    # -- global tensors over processes ----------------------------------------
    def _dcp_mesh(self, mm):
        """A CPU ``DeviceMesh`` of ``mm``'s shape over the default group's
        ranks: the DTensors' metadata (placements, offsets); DCP's own
        collectives run over the checkpoint's group."""
        from torch.distributed.device_mesh import DeviceMesh

        from scaletorch_tpu_torch.parallel.mesh import MESH_AXES

        shape = tuple(mm.shape)
        if shape not in self._dcp_meshes:
            self._dcp_meshes[shape] = DeviceMesh(
                "cpu", torch.arange(mm.world_size).view(shape),
                mesh_dim_names=MESH_AXES, _init_backend=False)
        return self._dcp_meshes[shape]

    def _param_name(self, name: str) -> Optional[str]:
        """The parameter a leaf of the saved tree belongs to: ``params.X``
        and ``opt_state.<state>.X`` (an optimizer state mirrors the
        parameter tree) are ``X``."""
        parts = name.split(".")
        for start in (1, 2):
            cand = ".".join(parts[start:])
            if cand in self._split_dims:
                return cand
        return None

    def _placements(self, mm, name: str, t: torch.Tensor,
                    param_shapes: Dict[str, tuple]) -> list:
        """Per mesh axis: ``Shard(dim)`` where the leaf's parameter splits
        on that axis (a factored optimizer statistic reduced over the
        split dim keeps it as size 1 and is ``Replicate``), else
        ``Replicate``."""
        from torch.distributed.tensor import Replicate, Shard

        from scaletorch_tpu_torch.parallel.mesh import MESH_AXES

        pname = self._param_name(name)
        dims = self._split_dims.get(pname, {}) if pname else {}
        pshape = param_shapes.get(pname)
        out = []
        for axis in MESH_AXES:
            d = dims.get(axis)
            if d is None or mm.axis_size(axis) == 1 or t.dim() <= d:
                out.append(Replicate())
            elif tuple(t.shape) == pshape or t.shape[d] != 1:
                out.append(Shard(d))
            else:
                out.append(Replicate())
        return out

    def _to_global(self, tree: Tree, mm) -> Tree:
        """Every leaf of ``{"params", "opt_state"}`` (host tensors) as a
        DTensor over ``mm``'s layout."""
        from torch.distributed.tensor import DTensor

        mesh = self._dcp_mesh(mm)
        shapes = {n[len("params."):]: tuple(t.shape)
                  for n, t in _flatten(tree["params"], "params.").items()}
        return _map(lambda name, t: DTensor.from_local(
            t, mesh, self._placements(mm, name, t, shapes),
            run_check=False), tree)

    # -- save -----------------------------------------------------------------
    def _snapshot(self, params: Tree, opt_state: Tree) -> Tree:
        """The state copied into host buffers, with one wait for the
        copies: after it returns the live tensors may change."""
        on_card = False

        def copy(name: str, t: torch.Tensor) -> torch.Tensor:
            nonlocal on_card
            buf = self._buffers.get(name)
            if (buf is None or buf.shape != t.shape
                    or buf.dtype != t.dtype):
                buf = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                                  pin_memory=t.is_cuda)
                self._buffers[name] = buf
            buf.copy_(t.detach(), non_blocking=t.is_cuda)
            on_card |= t.is_cuda
            return buf

        snap = _map(copy, {"params": params, "opt_state": opt_state})
        if on_card:
            torch.cuda.synchronize()
        return snap

    def _write(self, step: int, snap: Tree, extra: Dict[str, Any]) -> None:
        tmp = os.path.join(self.directory, f"{_TMP_PREFIX}{step}")
        meta = {"step": step, "extra": extra, "layout": self._layout}
        if self._global:
            # over processes rank 0 cleared a stale tmp before the
            # agreement that led here; DCP's save returns only once every
            # rank's data and rank 0's metadata are written, or fails on
            # every rank
            if not self._coordinated and os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp, exist_ok=True)
            fail = (self._injector.take_save_failure
                    if self._injector is not None else (lambda: False))
            _dcp_call("save", self._to_global(snap, self._mesh), tmp,
                      group=self._group, writer=_failing_writer(tmp, fail))
            if self._is_main:
                self._commit(step, tmp, meta)
            return
        if (self._injector is not None
                and self._injector.take_save_failure()):
            raise OSError(f"injected checkpoint save failure (step {step})")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        _dcp_call("save", snap, tmp)
        self._commit(step, tmp, meta)

    def _commit(self, step: int, tmp: str, meta: Dict[str, Any]) -> None:
        with open(os.path.join(tmp, EXTRA_FILE), "w") as f:
            json.dump(meta, f)
        os.rename(tmp, self._step_dir(step))
        self._retain()

    def _clear_tmp(self, step: int) -> None:
        tmp = os.path.join(self.directory, f"{_TMP_PREFIX}{step}")
        if self._is_main and os.path.exists(tmp):
            shutil.rmtree(tmp, ignore_errors=True)

    def _retain(self) -> None:
        if not self._keep_n or self._keep_n <= 0:
            return
        for old in self.all_steps()[:-self._keep_n]:
            self.delete(old)

    def save(self, step: int, params: Tree, opt_state: Tree,
             extra: Optional[Dict[str, Any]] = None) -> bool:
        """Save ``step``; returns False (never raises for a failed write)
        when every attempt failed or the step already exists (``delete``
        it first to replace it). With ``async_save`` the write goes on
        in the background once the snapshot is taken."""
        t0 = time.perf_counter()
        self.wait()
        if self._coordinated:
            self._clear_tmp(step)
            views = self._bus.all_gather(self._listed(step))
            if all(views):
                get_logger().warning(
                    f"checkpoint step {step} already exists; not saved")
                return False
            if any(views):
                # a stale listing on some process: retire the copy, and
                # let every process see the retirement before the save
                if self._bus.is_main and self._listed(step):
                    self.delete(step)
                self._bus.all_gather(True)
        elif self._listed(step):
            get_logger().warning(
                f"checkpoint step {step} already exists; not saved")
            return False
        snap = self._snapshot(params, opt_state)
        extra = dict(extra or {})
        timing = {"step": step}

        def write() -> None:
            retry_with_backoff(
                lambda: self._write(step, snap, extra),
                retries=self.retries, base_delay=self.retry_base_delay,
                retriable=(OSError,),
                describe=f"checkpoint save (step {step})")
            timing["total_s"] = time.perf_counter() - t0

        def write_once() -> None:
            self._write(step, snap, extra)
            timing["total_s"] = time.perf_counter() - t0

        if self._async:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="checkpoint")
            # over processes the writer makes one attempt; the outcome is
            # agreed (and retried in lockstep) by the next wait()
            job = write_once if self._coordinated else write
            self._pending = (step, self._pool.submit(job), (snap, extra,
                                                            timing))
            saved = True
        elif self._coordinated:
            saved = self._coordinated_write(step, snap, extra, timing, t0)
        else:
            try:
                write()
                saved = True
            except Exception as exc:
                get_logger().error(
                    f"checkpoint save at step {step} failed after "
                    f"retries: {exc!r}; training continues without it")
                saved = False
        timing["blocking_s"] = time.perf_counter() - t0
        self.saves.append(timing)
        if saved and self._verify:
            saved = self._verify_after_save(step, params, opt_state)
        return saved

    def _coordinated_write(self, step: int, snap: Tree,
                           extra: Dict[str, Any], timing: dict,
                           t0: float) -> bool:
        """The reference's ``_coordinated_save``: every process attempts,
        the outcomes are all-gathered, and retry, degrade and give-up
        happen on every process together."""
        for attempt_no in range(self.retries + 1):
            err: Optional[Exception] = None
            try:
                self._write(step, snap, extra)
            except Exception as exc:
                _raise_lost_peer(exc)
                err = exc
            statuses = self._bus.all_gather("err" if err is not None
                                            else "saved")
            if all(s == "saved" for s in statuses):
                timing["total_s"] = time.perf_counter() - t0
                return True
            if err is not None:
                get_logger().warning(
                    f"checkpoint save (step {step}) attempt "
                    f"{attempt_no + 1}/{self.retries + 1} failed locally: "
                    f"{err!r}")
            if attempt_no >= self.retries:
                break
            self._retire_partial(step)
            time.sleep(self.retry_base_delay * (2 ** attempt_no))
        get_logger().error(
            f"coordinated checkpoint save at step {step} failed on at "
            "least one process after retries; training continues without "
            "this checkpoint")
        return False

    def _retire_partial(self, step: int) -> None:
        """Before every process attempts ``step`` again: rank 0 retires a
        committed copy and any partial write, and every process waits
        until it has."""
        if self._bus.is_main and self._listed(step):
            self.delete(step)
        self._clear_tmp(step)
        self._bus.all_gather(True)

    def wait(self) -> bool:
        """Wait for an asynchronous write. If it failed, the manager turns
        synchronous and writes the same snapshot once more, with the same
        retries; False when that fails too (logged). Over processes the
        outcome is agreed first, and every process degrades together."""
        if self._pending is None:
            return True
        step, future, job = self._pending
        self._pending = None
        err: Optional[BaseException] = None
        try:
            future.result()
        except Exception as exc:
            if self._coordinated:
                _raise_lost_peer(exc)
            err = exc
        if self._coordinated:
            snap, extra, timing = job
            t0 = time.perf_counter() - timing.get("blocking_s", 0.0)
            if self._bus.agree_all(err is None):
                return True
            get_logger().error(
                f"async checkpoint write of step {step} failed on at least "
                f"one process ({err!r} here); saving synchronously from "
                "now on, on every process")
            self._async = False
            self._retire_partial(step)
            return self._coordinated_write(step, snap, extra, timing, t0)
        if err is None:
            return True
        get_logger().error(
            f"async checkpoint write of step {step} failed: {err!r}; "
            "saving synchronously from now on")
        self._async = False
        snap, extra, timing = job
        try:
            retry_with_backoff(
                lambda: self._write(step, snap, extra),
                retries=self.retries, base_delay=self.retry_base_delay,
                retriable=(OSError,),
                describe=f"checkpoint save (step {step})")
            return True
        except Exception as exc:
            get_logger().error(
                f"checkpoint save at step {step} failed after retries: "
                f"{exc!r}; training continues without it")
            return False

    # -- verification ---------------------------------------------------------
    def _verify_after_save(self, step: int, params: Tree,
                           opt_state: Tree) -> bool:
        if not self.wait():
            return False
        mismatch = self._verify_mismatch(step, params, opt_state)
        ok = mismatch is None
        if self._coordinated:
            ok = self._bus.agree_all(ok)
        if ok:
            return True
        if mismatch:
            get_logger().error(f"checkpoint at step {step} failed post-save "
                               f"verification: {mismatch}; retiring it")
        if self._is_main and os.path.exists(self._step_dir(step)):
            self.delete(step)
        if self._coordinated:
            self._bus.all_gather(True)
        return False

    def _expected_shapes(self, params: Tree, opt_state: Tree
                         ) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
        live = {"params": params, "opt_state": opt_state}
        if not self._global:
            return {n: (tuple(t.shape), t.dtype)
                    for n, t in _flatten(live).items()}
        glob_tree = self._to_global(_map(lambda n, t: t.detach().to(
            "meta"), live), self._mesh)
        return {n: (tuple(t.shape), t.dtype)
                for n, t in _flatten(glob_tree).items()}

    def _verify_mismatch(self, step: int, params: Tree,
                         opt_state: Tree) -> Optional[str]:
        """None when the saved tree matches the live one (global shapes
        over processes); else what differs."""
        import torch.distributed.checkpoint as dcp

        try:
            md = dcp.FileSystemReader(
                self._step_dir(step)).read_metadata().state_dict_metadata
        except Exception as exc:
            return f"metadata unreadable ({exc!r})"
        live = self._expected_shapes(params, opt_state)
        if sorted(md) != sorted(live):
            return (f"tree structure differs (saved {len(md)} leaves vs "
                    f"{len(live)})")
        for name, (shape, dt) in live.items():
            entry = md[name]
            size = tuple(getattr(entry, "size", ()))
            dtype = getattr(getattr(entry, "properties", None), "dtype", None)
            if size != shape:
                return f"{name}: shape {size} on disk vs {shape}"
            if dtype != dt:
                return f"{name}: dtype {dtype} on disk vs {dt}"
        return None

    # -- restore --------------------------------------------------------------
    def _read_meta(self, step: int) -> Dict[str, Any]:
        with open(os.path.join(self._step_dir(step), EXTRA_FILE)) as f:
            meta = json.load(f)
        if meta.get("step") != step:
            raise ValueError(f"{EXTRA_FILE} of step {step} names step "
                             f"{meta.get('step')}")
        return meta

    def layout_mismatch(self, step: int) -> Optional[str]:
        """Why ``step``'s stacked layer layout is not this run's (None
        when it is, or when its ``extra.json`` is unreadable: the restore
        attempt reports that)."""
        try:
            saved = self._read_meta(step).get("layout", PLAIN_LAYOUT)
        except (OSError, ValueError):
            return None
        if layout_key(saved) == layout_key(self._layout):
            return None
        return (f"checkpoint step {step} holds the stacked layer axis in "
                f"layout {saved}, this run's is {self._layout}: the pp "
                "padding or interleave differs, so its layers would load "
                "as pad rows or in another order; restore at the saved "
                "pipeline layout, or convert the checkpoint offline with "
                "python -m scaletorch_tpu_torch.tools.convert_layer_storage"
                f" --ckpt {self.directory} --out NEW_DIR --to "
                f"{self._layout.get('stacked', 'plain')}"
                + (f" --pp {self._layout['pp']}"
                   if "pp" in self._layout else "")
                + (f" --vpp {self._layout['vpp']}"
                   if self._layout.get("stacked") == "interleaved" else ""))

    def _restore_step(self, step: int, params: Tree, opt_state: Tree,
                      mesh: Any = None) -> Dict[str, Any]:
        """Read ``step`` into fresh host buffers (the live layout's
        DTensors over processes), then copy it into the live tensors."""
        live = {"params": params, "opt_state": opt_state}
        staged = _map(lambda n, t: torch.empty(t.shape, dtype=t.dtype,
                                               device="cpu"), live)
        if self._global:
            _dcp_call("load", self._to_global(staged, mesh or self._mesh),
                      self._step_dir(step), group=self._group)
        else:
            _dcp_call("load", staged, self._step_dir(step))
        meta = self._read_meta(step)
        src = _flatten(staged)
        with torch.no_grad():
            for name, t in _flatten(live).items():
                t.copy_(src[name])
        return {"params": params, "opt_state": opt_state,
                "extra": meta.get("extra", {}), "step": step}

    def _refuse_layout(self, step: int) -> None:
        """Raise ``CheckpointLayoutError`` on every process when ``step``
        was saved at another stacked layout."""
        why = self.layout_mismatch(step)
        if self._coordinated:
            whys = [w for w in self._bus.all_gather(why) if w]
            why = whys[0] if whys else None
        if why:
            raise CheckpointLayoutError(why)

    def _retire_unreadable(self, unreadable: List[int]) -> None:
        """Delete unreadable newer steps, by rank 0 alone over
        processes (the directory is shared)."""
        if not self._is_main:
            return
        for bad in unreadable:
            try:
                self.delete(bad)
                get_logger().warning(
                    f"deleted unreadable checkpoint at step {bad}")
            except OSError as exc:
                get_logger().error(
                    f"could not delete unreadable checkpoint at step "
                    f"{bad}: {exc!r}")

    def load_latest(self, params: Tree, opt_state: Tree, *,
                    target_mesh: Any = None) -> Optional[Dict[str, Any]]:
        """Restore the newest readable step into ``params`` and
        ``opt_state`` (in place) and return ``{"params", "opt_state",
        "extra", "step"}``; an unreadable step falls back to the one
        before and is deleted once an older step restores. None when no
        step restores. ``target_mesh`` (a ``MeshManager``) is the layout
        the live shards lie on when it is not the manager's own (an
        elastic remesh); the checkpoint itself holds global tensors."""
        self.wait()
        if target_mesh is not None:
            self._mesh = target_mesh
        t0 = time.perf_counter()
        steps = sorted(self.all_steps(), reverse=True)
        if self._coordinated:
            # rank 0's listing is authoritative
            steps = self._bus.broadcast_from_main(steps)
            out = self._coordinated_load(steps, params, opt_state)
        else:
            out = self._local_load(steps, params, opt_state)
        if out is not None:
            self.last_restore = {"step": out["step"],
                                 "seconds": time.perf_counter() - t0}
        return out

    def _local_load(self, steps: List[int], params: Tree,
                    opt_state: Tree) -> Optional[Dict[str, Any]]:
        unreadable: List[int] = []
        for step in steps:
            self._refuse_layout(step)
            try:
                out = retry_with_backoff(
                    lambda: self._restore_step(step, params, opt_state),
                    retries=self.retries, base_delay=self.retry_base_delay,
                    retriable=(OSError,),
                    describe=f"checkpoint restore (step {step})")
            except Exception as exc:
                get_logger().warning(
                    f"checkpoint at step {step} failed to restore "
                    f"({exc!r}); falling back to the previous checkpoint")
                unreadable.append(step)
                continue
            self._retire_unreadable(unreadable)
            return out
        return None

    def _coordinated_load(self, steps: List[int], params: Tree,
                          opt_state: Tree) -> Optional[Dict[str, Any]]:
        unreadable: List[int] = []
        for step in steps:
            self._refuse_layout(step)
            for attempt_no in range(self.retries + 1):
                err: Optional[Exception] = None
                out = None
                try:
                    out = self._restore_step(step, params, opt_state)
                except Exception as exc:
                    _raise_lost_peer(exc)
                    err = exc
                statuses = self._bus.all_gather(
                    "ok" if err is None
                    else ("retriable" if isinstance(err, OSError)
                          else "fatal"))
                if all(s == "ok" for s in statuses):
                    self._retire_unreadable(unreadable)
                    if unreadable:  # every process sees the retirement
                        self._bus.all_gather(True)
                    return out
                if err is not None:
                    get_logger().warning(
                        f"checkpoint restore (step {step}) attempt "
                        f"{attempt_no + 1}/{self.retries + 1} failed "
                        f"locally: {err!r}")
                if "fatal" in statuses or attempt_no >= self.retries:
                    unreadable.append(step)
                    get_logger().warning(
                        f"checkpoint at step {step} unreadable on at least "
                        "one process; falling back to the previous "
                        "checkpoint on every process")
                    break
                time.sleep(self.retry_base_delay * (2 ** attempt_no))
        return None

    def close(self) -> None:
        self.wait()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        self._buffers.clear()

    def detach(self) -> None:
        """Collective-free teardown for an elastic remesh: the bus and the
        group this manager agrees over may be broken (a peer died), so the
        agreed ``wait`` could not finish. Drain the writer locally,
        swallowing its error; the successor manager on the new epoch's
        group takes over."""
        if self._pending is not None:
            step, future, _ = self._pending
            self._pending = None
            try:
                future.result()
            except Exception as exc:
                get_logger().warning(
                    f"detach: async write of step {step} failed (peer loss "
                    f"in flight): {exc!r}")
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        self._buffers.clear()
