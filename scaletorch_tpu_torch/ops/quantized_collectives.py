"""The int8 block-scaled gradient all-reduce (counterpart of
scaletorch_tpu/ops/quantized_collectives.py).

The gradient mean over one data axis runs with int8 on the wire and fp32
accumulation, in two legs:

    quantize (per-block absmax scales)
      -> reduce-scatter as int8 + scales (one ``all_to_all_single`` each)
      -> dequantize + SUM IN FP32 over the source ranks, in index order
      -> re-quantize the reduced chunk
      -> all-gather as int8 + scales
      -> dequantize

Wire bytes a rank for N fp32 elements over n ranks: a ring all-reduce
moves 2·N·(n-1)/n·4; this path 2·N·(n-1)/n·1 + 2·(N/block)·(n-1)/n·4
(``wire_bytes``). The reduction is deterministic: the chunk bounds depend
only on (n, block size) and the fp32 sum adds the source ranks' chunks in
index order on the rank that owns the chunk, never in an order the
communication library picks, so two runs agree bit for bit.

The arithmetic is the reference's as XLA compiles it, so the two agree
bit for bit: the scale is absmax · float32(1/127) and the mean a product
with float32(1/n) (XLA multiplies by a constant divisor's reciprocal),
and the sum over source ranks is a chain of fused multiply-adds
(dequantize fused into the reduction: one rounding an addition). The
fused step adds the exact int8 x fp32 product to the running fp32 sum in
fp64 and rounds once to fp32, which is the FMA's result whenever the two
addends lie within 2^22 of each other.

These are plain torch ops over a ``torch.distributed`` group (the
reference computes them outside any Pallas kernel); ``group`` None is one
rank.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from scaletorch_tpu_torch.parallel.mesh import group_size

Tensor = torch.Tensor

DEFAULT_BLOCK_SIZE = 256
_QMAX = 127.0  # symmetric int8

GRAD_ALLREDUCE_DTYPES = ("fp32", "bf16", "int8")


def quantize_blockwise(x: Tensor, block_size: int = DEFAULT_BLOCK_SIZE
                       ) -> Tuple[Tensor, Tensor]:
    """[M] (M % block_size == 0) -> (int8 [M/B, B], fp32 scales [M/B]).

    Symmetric per-block absmax: scale = absmax·(1/127), q =
    round(x/scale) (half to even, as ``jnp.round``). An all-zero block gets
    scale 1.0."""
    if x.ndim != 1 or x.shape[0] % block_size:
        raise ValueError(
            f"quantize_blockwise wants 1-D input padded to a multiple of "
            f"block_size={block_size}, got shape {tuple(x.shape)}")
    blocks = x.float().reshape(-1, block_size)
    absmax = blocks.abs().amax(dim=-1)
    scales = torch.where(absmax > 0, absmax * (1.0 / _QMAX),
                         torch.ones_like(absmax))
    q = torch.clamp(torch.round(blocks / scales[:, None]), -_QMAX, _QMAX)
    return q.to(torch.int8), scales


def dequantize_blockwise(q: Tensor, scales: Tensor) -> Tensor:
    """(int8 [..., nB, B], fp32 [..., nB]) -> fp32 [..., nB*B]."""
    deq = q.float() * scales[..., None]
    return deq.reshape(*q.shape[:-2], q.shape[-2] * q.shape[-1])


def _padded_len(n: int, ranks: int, block_size: int) -> int:
    unit = ranks * block_size
    return -(-n // unit) * unit


def _all_to_all(x: Tensor, group) -> Tensor:
    x = x.contiguous()  # before empty_like, which keeps a view's strides
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _all_gather(x: Tensor, group, n: int) -> Tensor:
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=0)


def quantized_pmean(x: Tensor, group, *,
                    block_size: int = DEFAULT_BLOCK_SIZE,
                    mean: bool = True) -> Tensor:
    """Block-scaled int8 all-reduce (mean) of ``x`` over ``group``: any
    shape and dtype in, fp32 of the same shape out, int8 on the wire."""
    n = group_size(group)
    shape = x.shape
    flat = x.float().reshape(-1)
    padded = _padded_len(flat.numel(), n, block_size)
    if padded != flat.numel():
        flat = torch.cat([flat, flat.new_zeros(padded - flat.numel())])
    chunk = padded // n  # this rank's owned chunk, a multiple of the block

    # leg 1: reduce-scatter in int8, rank r receives every rank's chunk r
    q, s = quantize_blockwise(flat, block_size)
    q = q.reshape(n, chunk // block_size, block_size)
    s = s.reshape(n, chunk // block_size)
    if n > 1:
        q, s = _all_to_all(q, group), _all_to_all(s, group)
    # source ranks in index order, each product fused into its addition
    owned = dequantize_blockwise(q[:1], s[:1])[0]
    for i in range(1, n):
        exact = (q[i].double() * s[i].double()[:, None]).reshape(-1)
        owned = (owned.double() + exact).float()
    if mean:
        owned = owned * (1.0 / n)

    # leg 2: all-gather in int8 of the requantized owned chunk
    q2, s2 = quantize_blockwise(owned, block_size)
    if n > 1:
        q2, s2 = _all_gather(q2, group, n), _all_gather(s2, group, n)
    out = dequantize_blockwise(q2, s2)
    return out[:x.numel()].reshape(shape)


def reduced_pmean(x: Tensor, group, dtype: str, *,
                  block_size: int = DEFAULT_BLOCK_SIZE) -> Tensor:
    """The mean over ``group`` in the wire format ``dtype``: 'fp32' a
    plain all-reduce, 'bf16' one in bf16 (the mean rounded to bf16), 'int8'
    ``quantized_pmean``. fp32 out."""
    n = group_size(group)
    if dtype == "fp32":
        out = x.float().clone()
        if n > 1:
            dist.all_reduce(out, group=group)
        return out / n
    if dtype == "bf16":
        wire = x.to(torch.bfloat16).contiguous().clone()
        if n > 1:
            dist.all_reduce(wire, group=group)
        return (wire / n).float()
    if dtype == "int8":
        return quantized_pmean(x, group, block_size=block_size)
    raise ValueError(f"grad_allreduce_dtype must be one of "
                     f"{GRAD_ALLREDUCE_DTYPES}, got {dtype!r}")


def quantized_pmean_tree(grads: Sequence[Tensor], group, *,
                         dtype: str = "int8",
                         block_size: int = DEFAULT_BLOCK_SIZE
                         ) -> List[Tensor]:
    """The mean of every tensor of ``grads`` over ``group``. int8: ONE
    fused pair of collectives over the leaves raveled into one fp32
    vector, each leaf padded to a block boundary (a small leaf never shares
    an absmax block with a large neighbour); fp32 and bf16: one mean a
    leaf."""
    grads = list(grads)
    if not grads:
        return grads
    if dtype != "int8":
        return [reduced_pmean(g, group, dtype, block_size=block_size)
                for g in grads]
    segs = []
    for g in grads:
        v = g.float().reshape(-1)
        rem = -v.numel() % block_size
        segs.append(torch.cat([v, v.new_zeros(rem)]) if rem else v)
    red = quantized_pmean(torch.cat(segs), group, block_size=block_size)
    out, off = [], 0
    for g, seg in zip(grads, segs):
        out.append(red[off:off + g.numel()].reshape(g.shape))
        off += seg.numel()
    return out


def wire_bytes(numel: int, ranks: int, dtype: str,
               block_size: int = DEFAULT_BLOCK_SIZE) -> float:
    """Bytes a rank sends for the mean of ``numel`` fp32 elements over
    ``ranks`` ranks: a ring all-reduce of 4 (fp32) or 2 (bf16) bytes an
    element, or the two int8 legs with their fp32 scales."""
    if ranks <= 1:
        return 0.0
    share = (ranks - 1) / ranks
    if dtype == "int8":
        padded = _padded_len(numel, ranks, block_size)
        return 2.0 * padded * share + 2.0 * (padded / block_size) * share * 4
    width = {"fp32": 4, "bf16": 2}[dtype]
    return 2.0 * numel * share * width
