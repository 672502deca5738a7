"""Named architecture presets (copy of scaletorch_tpu/models/presets.py).

Field values match the published HF configs for Qwen/Qwen3-*; the MoE
presets match Qwen/Qwen3-30B-A3B's shape family. Each preset is a kwargs
dict; ``model_config`` turns it into the port's config class.
"""

from __future__ import annotations

from typing import Any, Dict

_QWEN3_COMMON = dict(
    model_type="qwen3",
    vocab_size=151936,
    num_key_value_heads=8,
    head_dim=128,
    rope_theta=1e6,
    rms_norm_eps=1e-6,
    max_position_embeddings=40960,
)

MODEL_PRESETS: Dict[str, Dict[str, Any]] = {
    "qwen3-0.6b": dict(
        _QWEN3_COMMON,
        hidden_size=1024,
        intermediate_size=3072,
        num_hidden_layers=28,
        num_attention_heads=16,
        tie_word_embeddings=True,
    ),
    "qwen3-1.7b": dict(
        _QWEN3_COMMON,
        hidden_size=2048,
        intermediate_size=6144,
        num_hidden_layers=28,
        num_attention_heads=16,
        tie_word_embeddings=True,
    ),
    "qwen3-4b": dict(
        _QWEN3_COMMON,
        hidden_size=2560,
        intermediate_size=9728,
        num_hidden_layers=36,
        num_attention_heads=32,
        tie_word_embeddings=True,
    ),
    "qwen3-8b": dict(
        _QWEN3_COMMON,
        hidden_size=4096,
        intermediate_size=12288,
        num_hidden_layers=36,
        num_attention_heads=32,
        tie_word_embeddings=False,
    ),
    "qwen3-14b": dict(
        _QWEN3_COMMON,
        hidden_size=5120,
        intermediate_size=17408,
        num_hidden_layers=40,
        num_attention_heads=40,
        tie_word_embeddings=False,
    ),
    "qwen3-32b": dict(
        _QWEN3_COMMON,
        hidden_size=5120,
        intermediate_size=25600,
        num_hidden_layers=64,
        num_attention_heads=64,
        tie_word_embeddings=False,
    ),
    # Qwen3-30B-A3B: 128 experts, top-8, 3.3B active of 30.5B total.
    "qwen3-30b-a3b": dict(
        model_type="qwen3_moe",
        vocab_size=151936,
        hidden_size=2048,
        intermediate_size=6144,
        moe_intermediate_size=768,
        num_hidden_layers=48,
        num_attention_heads=32,
        num_key_value_heads=4,
        head_dim=128,
        rope_theta=1e6,
        rms_norm_eps=1e-6,
        max_position_embeddings=40960,
        tie_word_embeddings=False,
        num_experts=128,
        num_experts_per_tok=8,
    ),
    # Single-v5e-chip MoE (same shape family as qwen3-30b-a3b, scaled to
    # fit 16 GB with bf16 master weights): E=64/top-8 keeps the
    # large-expert-count dispatch regime where the index form wins
    # (tools/bench_moe_dispatch.py measures it on-chip).
    "moe-mid": dict(
        model_type="qwen3_moe",
        vocab_size=32768,
        hidden_size=1024,
        intermediate_size=3072,
        moe_intermediate_size=384,
        num_hidden_layers=12,
        num_attention_heads=16,
        num_key_value_heads=4,
        head_dim=64,
        rope_theta=1e6,
        rms_norm_eps=1e-6,
        max_position_embeddings=40960,
        tie_word_embeddings=False,
        num_experts=64,
        num_experts_per_tok=8,
    ),
    # Downscaled MoE for 8-chip correctness/system sweeps (same shape
    # family as qwen3-30b-a3b; fits a CPU-device mesh).
    "moe-tiny": dict(
        model_type="qwen3_moe",
        vocab_size=4096,
        hidden_size=256,
        intermediate_size=512,
        moe_intermediate_size=192,
        num_hidden_layers=4,
        num_attention_heads=8,
        num_key_value_heads=4,
        head_dim=32,
        rope_theta=1e6,
        max_position_embeddings=8192,
        tie_word_embeddings=True,
        num_experts=8,
        num_experts_per_tok=2,
    ),
    # Downscaled dense model for 8-chip correctness/system sweeps.
    "dense-tiny": dict(
        model_type="qwen3",
        vocab_size=4096,
        hidden_size=256,
        intermediate_size=512,
        num_hidden_layers=4,
        num_attention_heads=8,
        num_key_value_heads=4,
        head_dim=32,
        rope_theta=1e6,
        max_position_embeddings=8192,
        tie_word_embeddings=True,
    ),
}


def preset(name: str) -> Dict[str, Any]:
    try:
        return dict(MODEL_PRESETS[name.lower()])
    except KeyError:
        raise KeyError(
            f"unknown model preset {name!r}; available: "
            f"{', '.join(sorted(MODEL_PRESETS))}"
        ) from None


def model_config(name: str, **overrides: Any):
    """The port's config for a preset (``Qwen3Config`` for
    ``model_type="qwen3"``, ``Qwen3MoEConfig`` for ``"qwen3_moe"``), with
    ``overrides`` (e.g. ``dtype``, ``num_hidden_layers``) applied on top.
    Every preset field must be a field of the class: none is dropped."""
    from scaletorch_tpu_torch.models.qwen3 import Qwen3Config
    from scaletorch_tpu_torch.models.qwen3_moe import Qwen3MoEConfig

    kw = preset(name)
    model_type = kw.pop("model_type")
    classes = {"qwen3": Qwen3Config, "qwen3_moe": Qwen3MoEConfig}
    if model_type not in classes:
        raise TypeError(f"preset {name!r} is a {model_type!r} model; the "
                        f"port has {sorted(classes)}")
    kw.update(overrides)
    return classes[model_type](**kw)
