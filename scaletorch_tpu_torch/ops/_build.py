"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is one CUDA C++ source ``csrc/<name>.cu`` with a plain
``extern "C"`` interface. It is compiled by ``nvcc`` for ``sm_90a`` into
``build/kernels/lib<name>-<digest>.so`` at the root of the checkout, at
first use, and loaded with ``ctypes`` (no PyTorch headers are compiled,
so a build takes seconds). The digest covers the sources and the flags,
so an edited source is rebuilt and a stale library is never loaded.

``launch_counts`` is the per-kernel launch counter: a wrapper adds one
where it launches its kernel and nowhere else, so a run can show that
its main path went through the kernels. A CUDA graph's replay calls no
wrapper: the engine's captured steps (``inference/decode.py``'s
``StaticStep``) take back the launches their capture only recorded and
add them again on every replay, so the counts keep meaning launches on
the card.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

# one source per kernel library; every one is built by ``build()``
KERNEL_SOURCES = ("paged_decode", "flash_fwd", "flash_bwd", "grouped_mlp_fwd",
                  "grouped_mlp_bwd")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills into the log
)

launch_counts: "collections.Counter[str]" = collections.Counter()

_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    launch_counts.clear()


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc`` or the one
    on ``PATH``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for cand in candidates:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc was not found (looked in $CUDA_HOME/bin, "
            "/usr/local/cuda/bin and PATH); the CUDA kernels are built "
            "from source on the machine that has the card")
    return found


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    h = hashlib.sha256()
    h.update((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def nvcc_command(name: str, output: Path) -> list:
    return [find_nvcc(), *NVCC_FLAGS, "-o", str(output),
            str(CSRC_DIR / f"{name}.cu")]


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, float]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together. Returns the wall seconds of each
    compile (0.0 for a library already built). Raises with the compiler's
    output if any compile fails; the log of each compile (ptxas's
    register and spill report included) stays in ``build/kernels/``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds: Dict[str, float] = {}
    running = []
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log_path = BUILD_DIR / f"{name}.log"
        with open(log_path, "w") as log:
            proc = subprocess.Popen(nvcc_command(name, tmp), stdout=log,
                                    stderr=subprocess.STDOUT)
        running.append((name, proc, tmp, out, log_path, time.monotonic()))
    failed = []
    for name, proc, tmp, out, log_path, t0 in running:
        rc = proc.wait()
        seconds[name] = time.monotonic() - t0
        if rc != 0:
            failed.append(f"{name} (nvcc exit {rc}):\n{log_path.read_text()}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return seconds


_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_FRAME = re.compile(r"(\d+) bytes stack frame, "
                          r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGISTERS = re.compile(r"Used (\d+) registers")


def kernel_resources(log_text: str) -> Dict[str, Dict[str, int]]:
    """Registers, stack frame and spill bytes of each kernel (by mangled
    name) from the ``ptxas -v`` report in a compile log: ``{"registers",
    "stack_frame", "spill_stores", "spill_loads"}``."""
    found: Dict[str, Dict[str, int]] = {}
    entry = None
    for line in log_text.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            entry = found.setdefault(m.group(1), {})
            continue
        if entry is None:
            continue
        m = _PTXAS_FRAME.search(line)
        if m:
            entry["stack_frame"] = int(m.group(1))
            entry["spill_stores"] = int(m.group(2))
            entry["spill_loads"] = int(m.group(3))
        m = _PTXAS_REGISTERS.search(line)
        if m:
            entry["registers"] = int(m.group(1))
    return found


def short_kernel_names(mangled: Iterable[str]) -> Dict[str, str]:
    """Mangled kernel name -> ``name<template args>`` through ``c++filt``
    (the mangled name itself where ``c++filt`` is missing)."""
    mangled = list(mangled)
    tool = shutil.which("c++filt")
    if tool is None or not mangled:
        return {m: m for m in mangled}
    lines = subprocess.run([tool], input="\n".join(mangled), text=True,
                           capture_output=True, check=True).stdout.splitlines()
    short = {}
    for m, full in zip(mangled, lines):
        full = full.replace("(anonymous namespace)::", "")
        short[m] = full.split("(", 1)[0].split(" ", 1)[-1]
    return short


def build_resources(names: Iterable[str] = KERNEL_SOURCES
                    ) -> Dict[str, Dict[str, Dict[str, int]]]:
    """Per source, each kernel's registers, stack frame and spill bytes
    from the log of its last compile in ``build/kernels/<source>.log``."""
    out = {}
    for name in names:
        found = kernel_resources((BUILD_DIR / f"{name}.log").read_text())
        short = short_kernel_names(found)
        out[name] = {short[m]: res for m, res in found.items()}
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def cuda_error_string(lib: ctypes.CDLL, code: int) -> str:
    fn = lib.st_cuda_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(code).decode()
