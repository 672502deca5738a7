"""Serving outcome taxonomy (the part of scaletorch_tpu/inference/
resilience.py the engine needs; fault injection and the stall watchdog
come in a later slice).

Every submitted request ends in exactly one of ``TERMINAL_OUTCOMES``:

  - ``ok``          finished normally (eos / length / max_seq)
  - ``timeout``     per-request deadline exceeded, queued or mid-decode
  - ``shed``        dropped oldest-first by bounded admission
  - ``rejected``    failed validation at submit under ``strict_submit=False``
  - ``quarantined`` the slot's logits went non-finite
  - ``aborted``     the engine gave up: ``run(max_steps)`` exhausted,
                    ``drain()``, or ``cancel()``
"""

from __future__ import annotations

__all__ = ["TERMINAL_OUTCOMES", "EngineDraining"]

TERMINAL_OUTCOMES = (
    "ok", "timeout", "shed", "rejected", "quarantined", "aborted",
)


class EngineDraining(RuntimeError):
    """Raised by ``submit()`` (strict mode) once ``drain()`` has stopped
    admissions — the serving loop is shutting down."""
