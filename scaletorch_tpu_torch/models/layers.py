"""Model building blocks: initialisers, RMSNorm, SwiGLU, RoPE, SDPA,
cross entropy.

PyTorch counterparts of scaletorch_tpu/models/layers.py with the same
casts, because the casts decide the numbers:

  * ``rms_norm`` computes in fp32 and casts back to the input dtype;
  * cos/sin are computed in fp32 and cast to q's dtype *before* the
    multiply;
  * attention scores come out of the matmul in q's dtype, are upcast to
    fp32, masked with ``finfo(float32).min``, softmaxed in fp32, and the
    probabilities are cast back to q's dtype before P·V.

``rms_norm`` and ``swiglu`` carry the reference's memory-lean custom
VJPs as ``torch.autograd.Function``s: each saves only its original-dtype
inputs and recomputes the fp32 internals in the backward. Their forwards
are the serving path's, unchanged.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


# ---- initialisation -----------------------------------------------------------
def init_generator(generator: Optional[torch.Generator],
                   device: torch.device) -> torch.Generator:
    """``generator``, or a fresh one on ``device`` seeded with 0: the
    default draw of the port's ``init_params`` and samplers."""
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    return generator


def fan_in_uniform(generator: torch.Generator, shape: Tuple[int, ...],
                   fan_in: int, dtype: torch.dtype = torch.float32, *,
                   device=None) -> Tensor:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) drawn from ``generator`` on the
    generator's device, then put on ``device`` (None: left there), so one
    CPU generator draws the same weights for the CPU and the card."""
    bound = 1.0 / math.sqrt(fan_in)
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    out.uniform_(-bound, bound, generator=generator)
    return out if device is None else out.to(device)


def normal_init(generator: torch.Generator, shape: Tuple[int, ...],
                std: float = 0.02, dtype: torch.dtype = torch.float32, *,
                device=None) -> Tensor:
    """N(0, std²) drawn from ``generator``, placed as ``fan_in_uniform``
    places its draw."""
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    out.normal_(0.0, std, generator=generator)
    return out if device is None else out.to(device)


# ---- RMSNorm / SwiGLU ---------------------------------------------------------
def _rms_norm_fwd_math(x: Tensor, weight: Tensor, eps: float) -> Tensor:
    x32 = x.float()
    variance = torch.mean(x32 * x32, dim=-1, keepdim=True)
    inv = torch.rsqrt(variance + eps)
    return (x32 * inv * weight.float()).to(x.dtype)


class _RMSNorm(torch.autograd.Function):
    """Saves the ORIGINAL-dtype ``x`` and ``weight`` only; the backward
    recomputes the fp32 internals (reference ``_rms_norm_bwd``)."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _rms_norm_fwd_math(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        x32 = x.float()
        variance = torch.mean(x32 * x32, dim=-1, keepdim=True)
        inv = torch.rsqrt(variance + ctx.eps)
        xhat = x32 * inv
        g32 = g.float()
        gw = g32 * weight.float()
        # d/dx of xhat·w: (1/rms)·(g·w − xhat·mean(g·w·xhat)) over the axis
        dx = inv * (gw - xhat * torch.mean(gw * xhat, dim=-1, keepdim=True))
        # the weight broadcasts over every leading axis of x
        lead = tuple(range(x.ndim - weight.ndim))
        dw = torch.sum(g32 * xhat, dim=lead) if lead else g32 * xhat
        return dx.to(x.dtype), dw.to(weight.dtype), None


def rms_norm(x: Tensor, weight: Tensor, eps: float = 1e-6) -> Tensor:
    """RMSNorm over the last axis with fp32 internals; ``weight``
    broadcasts over the leading axes (per-head q/k norms pass a [Dh]
    weight against [B, S, H, Dh] activations)."""
    return _RMSNorm.apply(x, weight, float(eps))


class _SwiGLU(torch.autograd.Function):
    """Saves only (gate, up) and recomputes the elementwise pieces in
    fp32 in the backward (reference ``_swiglu_bwd``)."""

    @staticmethod
    def forward(ctx, gate, up):
        ctx.save_for_backward(gate, up)
        return F.silu(gate) * up

    @staticmethod
    def backward(ctx, ct):
        gate, up = ctx.saved_tensors
        g32 = gate.float()
        s = torch.sigmoid(g32)
        silu = g32 * s
        dsilu = s + silu * (1.0 - s)  # d/dg [g·sigmoid(g)]
        ct32 = ct.float()
        dgate = (ct32 * up.float() * dsilu).to(gate.dtype)
        dup = (ct32 * silu).to(up.dtype)
        return dgate, dup


def swiglu(gate: Tensor, up: Tensor) -> Tensor:
    """``silu(gate) * up`` with a memory-lean backward."""
    return _SwiGLU.apply(gate, up)


# ---- RoPE ---------------------------------------------------------------------
def get_cos_sin(
    seq_len: int,
    head_dim: int,
    rope_theta: float = 10000.0,
    dtype: torch.dtype = torch.float32,
    positions: Optional[Tensor] = None,
    *,
    device: Optional[torch.device] = None,
) -> Tuple[Tensor, Tensor]:
    """Rotary cos/sin tables ``[seq, head_dim]``, or ``[B, S, head_dim]``
    for 2-D ``positions`` (the decode path's per-slot absolute
    positions). Inverse frequencies over even dims, angles duplicated
    across the two halves (the HF convention)."""
    if positions is not None:
        device = positions.device
    inv_freq = 1.0 / (
        rope_theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                    device=device) / head_dim)
    )
    if positions is None:
        positions = torch.arange(seq_len, dtype=torch.float32, device=device)
    else:
        positions = positions.to(torch.float32)
    freqs = positions[..., None] * inv_freq          # [..., S, Dh/2]
    emb = torch.cat([freqs, freqs], dim=-1)          # [..., S, Dh]
    return emb.cos().to(dtype), emb.sin().to(dtype)


def rotate_half(x: Tensor) -> Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary_pos_emb(
    q: Tensor, k: Tensor, cos: Tensor, sin: Tensor
) -> Tuple[Tensor, Tensor]:
    """q/k: [B, H, S, Dh]; cos/sin: [S, Dh] or per-batch [B, S, Dh]."""
    if cos.ndim == 3:
        cos = cos[:, None, :, :].to(q.dtype)
        sin = sin[:, None, :, :].to(q.dtype)
    else:
        cos = cos[None, None, :, :].to(q.dtype)
        sin = sin[None, None, :, :].to(q.dtype)
    q_rot = q * cos + rotate_half(q) * sin
    k_rot = k * cos + rotate_half(k) * sin
    return q_rot, k_rot


# ---- attention ----------------------------------------------------------------
def repeat_kv(k: Tensor, n_rep: int) -> Tensor:
    """GQA KV head expansion [B, Hkv, S, D] -> [B, Hkv*n_rep, S, D]."""
    if n_rep == 1:
        return k
    b, h_kv, s, d = k.shape
    return k[:, :, None].expand(b, h_kv, n_rep, s, d).reshape(
        b, h_kv * n_rep, s, d)


def sdpa_attention(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    bias: Optional[Tensor] = None,
) -> Tensor:
    """Plain scaled-dot-product attention with an fp32 softmax.

    q: [B, Hq, S, D]; k/v: [B, Hkv, Skv, D] (GQA expanded here). The
    causal mask is bottom-right aligned (``tril(k=Skv-Sq)``) with
    ``finfo(float32).min``, as in the reference."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    n_rep = q.shape[1] // k.shape[1]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    scores = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    if causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        mask = torch.ones(s_q, s_k, dtype=torch.bool,
                          device=q.device).tril(s_k - s_q)
        scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def sdpa_attention_with_lse(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[Tensor, Tensor]:
    """SDPA that also returns the log-sum-exp ``[B, H, S]`` (fp32): the
    ring merge's building block. Masked with ``-inf``; a row with no
    visible key has lse ``-inf`` and output 0."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    n_rep = q.shape[1] // k.shape[1]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    scores = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    if causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        mask = torch.ones(s_q, s_k, dtype=torch.bool,
                          device=q.device).tril(s_k - s_q)
        scores = scores.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)
    finite = torch.isfinite(lse)
    probs = torch.exp(scores - torch.where(finite, lse, 0.0)[..., None])
    probs = torch.where(finite[..., None], probs, 0.0).to(q.dtype)
    return torch.matmul(probs, v), lse


def cached_sdpa_attention(
    q: Tensor,
    k_cache: Tensor,
    v_cache: Tensor,
    q_positions: Tensor,
    *,
    scale: Optional[float] = None,
) -> Tensor:
    """SDPA against a fixed-size KV cache with absolute-position masking.

    q: [B, Hq, S, D]; k_cache/v_cache: [B, Hkv, S_max, D]; q_positions:
    [B, S]. The query at position p attends cache entries j <= p.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    n_rep = q.shape[1] // k_cache.shape[1]
    k = repeat_kv(k_cache, n_rep)
    v = repeat_kv(v_cache, n_rep)
    scores = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    key_idx = torch.arange(k_cache.shape[2], device=q.device)
    visible = key_idx[None, None, :] <= q_positions[:, :, None]  # [B,S,S_max]
    scores.masked_fill_(~visible[:, None], torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def write_kv_cache(
    cache: Tensor,
    new: Tensor,
    starts: Tensor,
    write_mask: Optional[Tensor] = None,
) -> Tensor:
    """Write ``new`` [B, H, S, D] into ``cache`` [B, H, S_max, D] at the
    per-slot offsets ``starts`` [B], IN PLACE, and return ``cache``.

    Offsets clamp to [0, S_max - S] as ``lax.dynamic_update_slice``
    clamps them in the JAX package. ``write_mask`` [B] bool keeps the
    unlisted slots' bytes untouched (continuous batching admits new
    requests without perturbing live ones).
    """
    b, _, s, _ = new.shape
    starts = starts.to(torch.long).clamp(0, cache.shape[2] - s)
    rows = torch.arange(b, device=cache.device)[:, None]             # [B,1]
    cols = starts[:, None] + torch.arange(s, device=cache.device)    # [B,S]
    # advanced indices split by a slice put their broadcast dims first:
    # the indexed view is [B, S, H, D]
    vals = new.to(cache.dtype).transpose(1, 2)
    if write_mask is not None:
        vals = torch.where(write_mask.view(b, 1, 1, 1), vals,
                           cache[rows, :, cols, :])
    cache[rows, :, cols, :] = vals
    return cache


# ---- losses -------------------------------------------------------------------
def cross_entropy_loss(
    logits: Tensor,
    targets: Tensor,
    ignore_index: int = -100,
) -> Tensor:
    """Token-mean cross entropy with ``ignore_index`` masking, fp32
    internally. logits: [..., V]; targets: [...] integer."""
    logits = logits.float()
    mask = targets != ignore_index
    safe = torch.where(mask, targets, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / mask.sum().clamp_min(1)
