"""Training checkpoints: save and resume of the parameters, the optimizer
state of any of the port's optimizers (its ``count`` included; bf16
leaves stay bf16), the step and a JSON ``extra``
(counterpart of scaletorch_tpu/utils/checkpoint.py at one process).

Each step is a directory ``<directory>/<step>`` written by
``torch.distributed.checkpoint`` (no process group: one writer), so a
later multi-process run can reshard through the same files, plus
``extra.json``. A step is written under a temporary name and renamed
when complete, so a partial write is never the latest step.

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

``fault_injector`` (the trainer passes its ``FaultInjector``) makes the
first ``ft_fail_saves`` write attempts fail, which drills the retries.
The coordinated multi-process paths and restoring onto another mesh
wait for ROADMAP Queue 1 item 6.
"""

from __future__ import annotations

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


def _flatten(tree: Tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    flat: Dict[str, torch.Tensor] = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            flat.update(_flatten(value, f"{name}."))
        else:
            flat[name] = value
    return flat


def _map(fn, tree: Tree) -> Tree:
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _dcp_call(name: str, state: Tree, path: str) -> None:
    """``torch.distributed.checkpoint.save`` or ``load`` of ``state`` at
    ``path`` in one process. Its ``CheckpointException`` (a
    ``BaseException``) comes out as an ``OSError`` when the failure under
    it was one, so the retries see it, else as a ``RuntimeError``."""
    import torch.distributed.checkpoint as dcp

    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*torch.distributed is "
                                "disabled, unavailable or uninitialized.*")
        try:
            if name == "save":
                dcp.save(state, storage_writer=dcp.FileSystemWriter(path))
            else:
                dcp.load(state, storage_reader=dcp.FileSystemReader(path))
        except dcp.api.CheckpointException as exc:
            causes = [f[0] if isinstance(f, tuple) else f
                      for f in exc.failures.values()]
            kind = (OSError if any(isinstance(c, OSError) for c in causes)
                    else RuntimeError)
            raise kind(f"checkpoint {name} at {path} failed: "
                       f"{causes!r}") from None


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
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pending: Optional[Tuple[int, Future, Any]] = None
        self._buffers: Dict[str, torch.Tensor] = {}
        # seconds of each save: {"step", "blocking_s", "total_s"} (total_s
        # appears when its write has finished), and of the latest restore
        self.saves: List[Dict[str, float]] = []
        self.last_restore: Dict[str, float] = {}

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

    def delete(self, step: int) -> None:
        shutil.rmtree(self._step_dir(step))

    def step_bytes(self, step: int) -> int:
        """Bytes on disk of one saved step."""
        root = self._step_dir(step)
        return sum(os.path.getsize(os.path.join(d, f))
                   for d, _, files in os.walk(root) for f in files)

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

        def walk(tree: Tree, prefix: str) -> Tree:
            return {k: walk(v, f"{prefix}{k}.") if isinstance(v, dict)
                    else copy(f"{prefix}{k}", v) for k, v in tree.items()}

        snap = walk({"params": params, "opt_state": opt_state}, "")
        if on_card:
            torch.cuda.synchronize()
        return snap

    def _write(self, step: int, snap: Tree, extra: Dict[str, Any]) -> None:
        if (self._injector is not None
                and self._injector.take_save_failure()):
            raise OSError(f"injected checkpoint save failure (step {step})")
        tmp = os.path.join(self.directory, f"{_TMP_PREFIX}{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        _dcp_call("save", snap, tmp)
        with open(os.path.join(tmp, EXTRA_FILE), "w") as f:
            json.dump({"step": step, "extra": extra}, f)
        os.rename(tmp, self._step_dir(step))
        self._retain()

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
        if os.path.exists(self._step_dir(step)):
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

        if self._async:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="checkpoint")
            self._pending = (step, self._pool.submit(write), write)
            saved = True
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

    def wait(self) -> bool:
        """Wait for an asynchronous write. If it failed, the manager turns
        synchronous and writes the same snapshot once more, with the same
        retries; False when that fails too (logged)."""
        if self._pending is None:
            return True
        step, future, write = self._pending
        self._pending = None
        try:
            future.result()
            return True
        except Exception as exc:
            get_logger().error(
                f"async checkpoint write of step {step} failed: {exc!r}; "
                "saving synchronously from now on")
            self._async = False
        try:
            write()
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
        if mismatch is None:
            return True
        get_logger().error(f"checkpoint at step {step} failed post-save "
                           f"verification: {mismatch}; retiring it")
        if os.path.exists(self._step_dir(step)):
            self.delete(step)
        return False

    def _verify_mismatch(self, step: int, params: Tree,
                         opt_state: Tree) -> Optional[str]:
        """None when the saved tree matches the live one; else what
        differs."""
        import torch.distributed.checkpoint as dcp

        try:
            md = dcp.FileSystemReader(
                self._step_dir(step)).read_metadata().state_dict_metadata
        except Exception as exc:
            return f"metadata unreadable ({exc!r})"
        live = _flatten({"params": params, "opt_state": opt_state})
        if sorted(md) != sorted(live):
            return (f"tree structure differs (saved {len(md)} leaves vs "
                    f"{len(live)})")
        for name, t in live.items():
            entry = md[name]
            size = tuple(getattr(entry, "size", ()))
            dtype = getattr(getattr(entry, "properties", None), "dtype", None)
            if size != tuple(t.shape):
                return f"{name}: shape {size} on disk vs {tuple(t.shape)}"
            if dtype != t.dtype:
                return f"{name}: dtype {dtype} on disk vs {t.dtype}"
        return None

    # -- restore --------------------------------------------------------------
    def _restore_step(self, step: int, params: Tree, opt_state: Tree
                      ) -> Dict[str, Any]:
        """Read ``step`` into fresh host buffers, then copy it into the
        live tensors."""
        live = {"params": params, "opt_state": opt_state}
        staged = _map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                            device="cpu"), live)
        _dcp_call("load", staged, self._step_dir(step))
        with open(os.path.join(self._step_dir(step), EXTRA_FILE)) as f:
            meta = json.load(f)
        if meta.get("step") != step:
            raise ValueError(f"{EXTRA_FILE} of step {step} names step "
                             f"{meta.get('step')}")
        src = _flatten(staged)
        with torch.no_grad():
            for name, t in _flatten(live).items():
                t.copy_(src[name])
        return {"params": params, "opt_state": opt_state,
                "extra": meta.get("extra", {}), "step": step}

    def load_latest(self, params: Tree, opt_state: Tree
                    ) -> Optional[Dict[str, Any]]:
        """Restore the newest readable step into ``params`` and
        ``opt_state`` (in place) and return ``{"params", "opt_state",
        "extra", "step"}``; an unreadable step falls back to the one
        before and is deleted once an older step restores. None when no
        step restores."""
        self.wait()
        t0 = time.perf_counter()
        unreadable: List[int] = []
        for step in sorted(self.all_steps(), reverse=True):
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
            for bad in unreadable:
                self.delete(bad)
                get_logger().warning(
                    f"deleted unreadable checkpoint at step {bad}")
            self.last_restore = {"step": step,
                                 "seconds": time.perf_counter() - t0}
            return out
        return None

    def close(self) -> None:
        self.wait()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        self._buffers.clear()
