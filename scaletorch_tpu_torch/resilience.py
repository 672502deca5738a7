"""Retriable I/O (the ``retry_with_backoff`` part of
scaletorch_tpu/resilience.py). The data loader's step-batch reads and the
checkpoint manager's saves and restores run under it. The sentinel, the
preemption handler, fault injection and the elastic paths are still to
port (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import random
import time
from typing import Any, Callable, Tuple

from scaletorch_tpu_torch.utils.logger import get_logger


def retry_with_backoff(
    fn: Callable[[], Any],
    *,
    retries: int = 3,
    base_delay: float = 0.5,
    max_delay: float = 8.0,
    jitter: float = 0.5,
    retriable: Tuple[type, ...] = (Exception,),
    describe: str = "operation",
    sleep: Callable[[float], None] = time.sleep,
) -> Any:
    """Run ``fn`` with exponential backoff and jitter on a retriable
    failure. ``retries`` counts RE-tries: at most ``retries + 1``
    attempts; the last failure re-raises. The delay is ``base_delay *
    2**attempt`` capped at ``max_delay``, scaled by a uniform ``[1, 1 +
    jitter]`` factor so workers restarted together do not hit shared
    storage in lockstep."""
    attempt = 0
    while True:
        try:
            return fn()
        except retriable as exc:
            if attempt >= retries:
                raise
            delay = min(max_delay, base_delay * (2 ** attempt))
            delay *= 1.0 + random.random() * max(jitter, 0.0)
            get_logger().warning(
                f"{describe} failed (attempt {attempt + 1}/{retries + 1}): "
                f"{exc!r}; retrying in {delay:.2f}s")
            sleep(delay)
            attempt += 1
