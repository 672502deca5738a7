"""Serving on the GPU: KV-cache decode with continuous batching.

  * ``kv_cache``   — dense and paged KV layouts, the page allocator, the
    radix prefix cache and the paged-cache adapter ``PagedKVIO``;
  * ``decode``     — the prefill / decode steps (dense and paged),
    ``StaticStep`` (a step over static buffers, captured once as a CUDA
    graph on the card) and the teacher-forced parity harnesses;
  * ``sampling``   — greedy / temperature / top-k / top-p;
  * ``engine``     — ``InferenceEngine``: continuous batching over a
    fixed-slot batch;
  * ``resilience`` — the terminal-outcome taxonomy, the serving fault
    injector and the serving stall watchdog;
  * ``disagg``    — disaggregated prefill/decode serving: a prefill
    slice and a decode slice, a page pool each, prompt pages handed off
    through a ``PageHandoffChannel``.
"""

from scaletorch_tpu_torch.inference.kv_cache import (  # noqa: F401
    KVCache,
    MLACache,
    PageAllocator,
    PagedKVCache,
    PagedKVIO,
    RadixPrefixCache,
    ceil_div,
    init_kv_cache,
    init_mla_cache,
    init_paged_kv_cache,
    kv_cache_bytes,
    kv_cache_shape,
    paged_kv_cache_shape,
)
from scaletorch_tpu_torch.inference.sampling import (  # noqa: F401
    SamplingParams,
    sample,
)
from scaletorch_tpu_torch.inference.decode import (  # noqa: F401
    StaticStep,
    make_decode_step,
    make_fill_slots_step,
    make_paged_decode_step,
    make_paged_prefill_step,
    make_prefill_step,
    resolve_forward_cached,
    teacher_forced_decode,
    teacher_forced_decode_paged,
)
from scaletorch_tpu_torch.inference.resilience import (  # noqa: F401
    SERVING_STALL_EXIT_CODE,
    TERMINAL_OUTCOMES,
    EngineDraining,
    ServingFaultInjector,
    make_serving_watchdog,
)
from scaletorch_tpu_torch.inference.engine import (  # noqa: F401
    EngineMetrics,
    InferenceEngine,
    Request,
    RequestResult,
)
from scaletorch_tpu_torch.inference.disagg import (  # noqa: F401
    DisaggMetrics,
    DisaggregatedEngine,
    HandoffError,
    PageHandoffChannel,
    parse_disagg_spec,
    plan_slice_split,
)
