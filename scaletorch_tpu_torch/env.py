"""Environment-variable registry of the port (counterpart of
scaletorch_tpu/env.py): one place that declares every runtime toggle the
package reads, with its default and parser, so no module reaches for
``os.environ`` ad hoc.

The names are the reference's ``SCALETORCH_TPU_*`` names, with the same
defaults: they are the users' interface, shared by both packages. Only
the names some module of the port reads are registered here, so
``env_snapshot`` reports no setting that the port ignores.
``env_override`` is the present-wins contract of the fault-injection and
telemetry knobs: a variable that is SET (an explicit 0 or empty value
included) overrides the config field, so a restarted job can arm or
cancel a drill without a config edit.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Tuple

_REGISTRY: Dict[str, Tuple[str, Callable[[str], Any]]] = {}


def _as_bool(v: str) -> bool:
    return v.lower() in ("1", "true", "yes", "on")


def register_env(name: str, default: str,
                 parser: Callable[[str], Any] = str) -> None:
    """Declare an environment variable the package reads."""
    _REGISTRY[name] = (default, parser)


def get_env(name: str) -> Any:
    """A registered variable's value: the parser over the environment's
    string, or over the default when unset."""
    if name not in _REGISTRY:
        raise KeyError(
            f"env var {name!r} is not registered; call register_env first")
    default, parser = _REGISTRY[name]
    return parser(os.environ.get(name, default))


def env_snapshot() -> Dict[str, Any]:
    """Every registered variable's current value (for logs and
    diagnostics)."""
    return {k: get_env(k) for k in sorted(_REGISTRY)}


def env_override(name: str, fallback: Any) -> Any:
    """The registered variable when it is SET (an explicit 0 or empty
    value included), else ``fallback`` (usually the config field)."""
    if os.environ.get(name) is not None:
        return get_env(name)
    return fallback


# ---- core toggles -----------------------------------------------------------
register_env("FLASH_ATTEN", "1", _as_bool)        # the flash kernels K1-K3
register_env("CONTEXT_PARALLEL", "0", _as_bool)   # ring attention
# the plain attention path instead of the flash kernels (name kept from
# the reference, where the kernels are Pallas kernels); the reference's
# A/B gate, read where ``"auto"`` resolves to a backend
register_env("SCALETORCH_TPU_DISABLE_PALLAS", "0", _as_bool)
# The reference's SCALETORCH_TPU_FORCE_PALLAS has no counterpart: it
# overrides TPU detection there, and the port has none to override
# (``flash`` on a CUDA tensor always launches K1-K3).
# sequence chunk of the fused LM head + cross-entropy (bounds the live
# fp32 [B, C, V] logits)
register_env("SCALETORCH_TPU_CE_CHUNK", "1024", int)
# the grouped-MLP kernels K5-K7 for the MoE experts (default off, as in
# the reference)
register_env("SCALETORCH_TPU_GROUPED_MLP_KERNEL", "0", _as_bool)

# ---- training fault injection (resilience.FaultInjector) --------------------
register_env("SCALETORCH_TPU_FT_NAN_STEP", "0", int)
register_env("SCALETORCH_TPU_FT_FAIL_SAVES", "0", int)
register_env("SCALETORCH_TPU_FT_SIGTERM_STEP", "0", int)
register_env("SCALETORCH_TPU_FT_SLOW_STEP_STEP", "0", int)
register_env("SCALETORCH_TPU_FT_SLOW_STEP_SECONDS", "0.5", float)
register_env("SCALETORCH_TPU_FT_SIGTERM_HOST", "-1", int)
register_env("SCALETORCH_TPU_FT_HANG_STEP", "0", int)
register_env("SCALETORCH_TPU_FT_BAD_BATCH_STEP", "0", int)
register_env("SCALETORCH_TPU_FT_HANG_TIMEOUT", "0", float)
register_env("SCALETORCH_TPU_FT_COORDINATE", "1", _as_bool)
register_env("SCALETORCH_TPU_FT_KILL_HOST_STEP", "0", int)
register_env("SCALETORCH_TPU_FT_KILL_HOST", "-1", int)
register_env("SCALETORCH_TPU_FT_HOST_HANG_ELASTIC", "0", int)

# ---- serving fault injection (inference/resilience.ServingFaultInjector) ----
# steps are 1-based decode steps of the engine's lifetime
register_env("SCALETORCH_TPU_FT_SERVE_NAN_STEP", "0", int)
register_env("SCALETORCH_TPU_FT_SERVE_NAN_SLOT", "0", int)
register_env("SCALETORCH_TPU_FT_SERVE_SLOW_STEP", "0", int)
register_env("SCALETORCH_TPU_FT_SERVE_SLOW_SECONDS", "30", float)
register_env("SCALETORCH_TPU_FT_SERVE_SUBMIT_STORM_STEP", "0", int)
register_env("SCALETORCH_TPU_FT_SERVE_SUBMIT_STORM_COUNT", "8", int)
register_env("SCALETORCH_TPU_FT_SERVE_DEADLINE_STORM_STEP", "0", int)
# gateway drills: plain counters of the injector, read by the gateway
# (its counting unit is 1-based HTTP requests, not decode steps)
register_env("SCALETORCH_TPU_FT_GW_TENANT_STORM_AT", "0", int)
register_env("SCALETORCH_TPU_FT_GW_TENANT_STORM_COUNT", "8", int)
register_env("SCALETORCH_TPU_FT_GW_REPLICA_DOWN_AT", "0", int)
register_env("SCALETORCH_TPU_FT_GW_REPLICA_CRASH_AT", "0", int)
register_env("SCALETORCH_TPU_FT_GW_REPLICA_HANG_AT", "0", int)
register_env("SCALETORCH_TPU_FT_GW_WARM_DONOR_CRASH_AT", "0", int)
register_env("SCALETORCH_TPU_FT_GW_WARM_CORRUPT_CHUNK_AT", "0", int)

# ---- telemetry (present-wins; an explicitly EMPTY dir turns it off) ---------
register_env("SCALETORCH_TPU_TELEMETRY_DIR", "", str)
register_env("SCALETORCH_TPU_PROFILE_STEPS", "", str)
