"""The attention-variant library: MHA / MQA / GQA / MLA (counterpart of
scaletorch_tpu/models/attention/). A self-contained family beside the
production decoders: each variant is an ``init(generator) -> params`` and
``apply(params, x)`` pair over one ``AttentionConfig``; MLA adds a
latent-only KV cache (``init_cache`` / ``prefill`` / ``decode``)."""

from scaletorch_tpu_torch.models.attention.base import AttentionConfig  # noqa: F401
from scaletorch_tpu_torch.models.attention.variants import (  # noqa: F401
    GroupQueryAttention,
    MultiHeadAttention,
    MultiHeadLatentAttention,
    MultiQueryAttention,
)
