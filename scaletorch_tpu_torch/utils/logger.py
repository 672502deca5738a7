"""Process-aware colored logger (counterpart of scaletorch_tpu/utils/logger.py).

The main process logs at INFO to stdout (plus an optional file); every
other rank logs ERROR only, so a multi-process launch does not print N
copies of every line. ``log_format='json'`` swaps every handler to one
JSON object per line.

The rank comes from the launcher's environment (``RANK`` and friends):
the port has no runtime to ask before ``torch.distributed`` is up.
"""

from __future__ import annotations

import json
import logging
import os
import sys
from typing import Optional

_COLORS = {
    logging.DEBUG: "\x1b[36m",     # cyan
    logging.INFO: "\x1b[32m",      # green
    logging.WARNING: "\x1b[33m",   # yellow
    logging.ERROR: "\x1b[31m",     # red
    logging.CRITICAL: "\x1b[35m",  # magenta
}
_RESET = "\x1b[0m"

# Where launchers put the process rank (torchrun, SLURM, Open MPI).
RANK_DISCOVERY_VARS = ("RANK", "PROCESS_ID", "SLURM_PROCID",
                       "OMPI_COMM_WORLD_RANK")


def _process_index() -> int:
    for var in RANK_DISCOVERY_VARS:
        v = os.environ.get(var)
        if v not in (None, ""):
            try:
                return int(v)
            except ValueError:
                pass
    return 0


class ColorfulFormatter(logging.Formatter):
    def __init__(self, process_index: int, use_color: bool = True) -> None:
        super().__init__()
        self.process_index = process_index
        self.use_color = use_color

    def format(self, record: logging.LogRecord) -> str:
        level = record.levelname
        if self.use_color:
            color = _COLORS.get(record.levelno, "")
            level = f"{color}{level}{_RESET}"
        prefix = (
            f"[{self.formatTime(record, '%Y-%m-%d %H:%M:%S')}]"
            f"[proc {self.process_index}][{level}]"
        )
        return f"{prefix} {record.getMessage()}"


class JsonFormatter(logging.Formatter):
    """One JSON object per line. A record attached as
    ``extra={"structured_record": {...}}`` is emitted as is (plus the
    ts/level/proc envelope); any other message is wrapped as ``msg``."""

    def __init__(self, process_index: int) -> None:
        super().__init__()
        self.process_index = process_index

    def format(self, record: logging.LogRecord) -> str:
        base = {
            "ts": self.formatTime(record, "%Y-%m-%dT%H:%M:%S"),
            "level": record.levelname,
            "proc": self.process_index,
        }
        structured = getattr(record, "structured_record", None)
        if isinstance(structured, dict):
            return json.dumps({**base, **structured}, default=repr)
        return json.dumps({**base, "msg": record.getMessage()}, default=repr)


def _make_formatter(log_format: str, process_index: int,
                    use_color: bool) -> logging.Formatter:
    if log_format == "json":
        return JsonFormatter(process_index)
    return ColorfulFormatter(process_index, use_color)


def get_logger(
    name: str = "scaletorch_tpu_torch",
    log_file: Optional[str] = None,
    level: int = logging.INFO,
    log_format: str = "text",
) -> logging.Logger:
    """The named logger, configured once (stdout handler, rank-aware
    level); a later call that names a new ``log_file`` adds it."""
    logger = logging.getLogger(name)
    process_index = _process_index()
    if not getattr(logger, "_scaletorch_configured", False):
        logger.setLevel(level if process_index == 0 else logging.ERROR)
        logger.propagate = False
        use_color = sys.stdout.isatty() and os.environ.get("NO_COLOR") is None
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(
            _make_formatter(log_format, process_index, use_color))
        logger.addHandler(handler)
        logger._scaletorch_log_files = set()  # type: ignore[attr-defined]
        logger._scaletorch_configured = True  # type: ignore[attr-defined]
    files = logger._scaletorch_log_files  # type: ignore[attr-defined]
    if log_file is not None and log_file not in files and process_index == 0:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(_make_formatter(log_format, process_index, False))
        logger.addHandler(fh)
        files.add(log_file)
    return logger
