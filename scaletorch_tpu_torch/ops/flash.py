"""Flash attention: the CUDA kernels K1-K3, their plain versions, the VJP.

PyTorch counterpart of scaletorch_tpu/ops/pallas/flash.py. Three kernels,
written by hand for Hopper:

  * **K1** ``flash_forward`` (``csrc/flash_fwd.cu``): O and the fp32
    log-sum-exp by online softmax over key tiles; replaces ``_fwd_kernel``.
  * **K2** ``flash_dq`` (``csrc/flash_bwd.cu``): dQ from the saved LSE and
    ``delta = rowsum(dO * O)``; replaces ``_dq_kernel``.
  * **K3** ``flash_dkv`` (``csrc/flash_bwd.cu``): dK and dV, summed over
    the query tiles and the n_rep query heads of each KV head; replaces
    ``_dkv_kernel``.

Each wrapper launches its kernel on a CUDA tensor (or raises) and computes
its plain version (``flash_forward_ref``, ``flash_dq_ref``,
``flash_dkv_ref``) on a CPU tensor. The plain versions repeat the kernels'
arithmetic and casts (fp32 scores scaled after the product, masked logits
-1e30, p rounded to v's dtype before P·V, ``l`` floored at 1e-30; ds
rounded to k's dtype for dQ; p to dO's and ds to q's dtype for dK/dV),
materialising the scores one chunk of query rows at a time.

K/V stay unexpanded ``[B, Hkv, S, D]``: query head h reads KV head
``h // n_rep``. ``flash_attention`` is the differentiable op
(``_FlashAttention``); its forward calls K1 through the dispatcher op
``scaletorch_tpu_torch::flash_forward`` (``FLASH_FORWARD_OP``), whose
outputs a selective-checkpoint policy can save.
``flash_forward_with_lse`` and ``flash_block_backward`` are the raw,
non-differentiable entries that ring attention composes.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from scaletorch_tpu_torch.models.layers import repeat_kv
from scaletorch_tpu_torch.ops import _build

Tensor = torch.Tensor

FWD_LIBRARY = "flash_fwd"
BWD_LIBRARY = "flash_bwd"
# launch-count names, one per kernel
K1_NAME = "flash_fwd"
K2_NAME = "flash_dq"
K3_NAME = "flash_dkv"

# the head dims K1-K3 are built for (every preset's: 32, 64, 128; 16 for
# the reference examples' narrow heads: moe, pipeline, longctx)
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
NEG_INF = -1e30  # large-negative instead of -inf: keeps masked rows NaN-free

# fp32 score bytes one chunk of the plain versions may hold
_REF_CHUNK_BYTES = 1 << 28

_kernels = {}


def _pick_block(seq: int, preferred: int) -> int:
    """The reference's block rule: the largest power-of-two fraction of
    ``preferred`` (at most ``seq``) that divides ``seq``. The plain
    versions take their query chunks by it."""
    block = min(preferred, seq)
    while seq % block:
        block //= 2
    return max(block, 1)


def _scale(q: Tensor, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _query_chunks(q: Tensor, k: Tensor):
    b, hq, sq, _ = q.shape
    rows = max(1, _REF_CHUNK_BYTES // (4 * b * hq * k.shape[2]))
    step = _pick_block(sq, rows)
    for r0 in range(0, sq, step):
        yield r0, min(r0 + step, sq)


def _scores(qc: Tensor, kf: Tensor, r0: int, causal: bool,
            scale: float) -> Tensor:
    """fp32 scores of query rows r0.. against all keys, scaled after the
    product, masked (row >= col, counted from 0 of each sequence) to
    -1e30."""
    s = torch.matmul(qc.float(), kf.transpose(-1, -2)) * scale
    if causal:
        rows = torch.arange(r0, r0 + qc.shape[2], device=qc.device)
        cols = torch.arange(kf.shape[2], device=qc.device)
        s = s.masked_fill(cols[None, :] > rows[:, None], NEG_INF)
    return s


def flash_forward_ref(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                      scale: Optional[float] = None) -> Tuple[Tensor, Tensor]:
    """K1's plain version: (out in q's dtype, lse fp32 [B, Hq, Sq])."""
    scale = _scale(q, scale)
    n_rep = q.shape[1] // k.shape[1]
    kf = repeat_kv(k, n_rep).float()
    vr = repeat_kv(v, n_rep)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    for r0, r1 in _query_chunks(q, k):
        s = _scores(q[:, :, r0:r1], kf, r0, causal, scale)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        acc = torch.matmul(p.to(v.dtype).float(), vr.float())
        out[:, :, r0:r1] = (acc / l).to(q.dtype)
        lse[:, :, r0:r1] = (m + torch.log(l))[..., 0]
    return out, lse


def _probs_and_ds(q, kf, vf, dout, lse, delta, r0, r1, causal, scale):
    """P and dS (fp32) of query rows r0..r1 against the expanded fp32
    keys and values."""
    s = _scores(q[:, :, r0:r1], kf, r0, causal, scale)
    p = torch.exp(s - lse[:, :, r0:r1, None])
    dp = torch.matmul(dout[:, :, r0:r1].float(), vf.transpose(-1, -2))
    ds = p * (dp - delta[:, :, r0:r1, None]) * scale
    return p, ds


def flash_dq_ref(q: Tensor, k: Tensor, v: Tensor, dout: Tensor, lse: Tensor,
                 delta: Tensor, *, causal: bool,
                 scale: Optional[float] = None) -> Tensor:
    """K2's plain version: dQ in q's dtype."""
    scale = _scale(q, scale)
    n_rep = q.shape[1] // k.shape[1]
    kf = repeat_kv(k, n_rep).float()
    vf = repeat_kv(v, n_rep).float()
    dq = torch.empty_like(q)
    for r0, r1 in _query_chunks(q, k):
        _, ds = _probs_and_ds(q, kf, vf, dout, lse, delta, r0, r1, causal,
                              scale)
        dq[:, :, r0:r1] = torch.matmul(ds.to(k.dtype).float(),
                                       kf).to(q.dtype)
    return dq


def flash_dkv_ref(q: Tensor, k: Tensor, v: Tensor, dout: Tensor,
                  lse: Tensor, delta: Tensor, *, causal: bool,
                  scale: Optional[float] = None) -> Tuple[Tensor, Tensor]:
    """K3's plain version: (dK, dV) in k's and v's dtypes, summed over the
    n_rep query heads of each KV head in fp32."""
    scale = _scale(q, scale)
    b, hkv, skv, d = k.shape
    n_rep = q.shape[1] // hkv
    kf = repeat_kv(k, n_rep).float()
    vf = repeat_kv(v, n_rep).float()
    dk = torch.zeros(b, q.shape[1], skv, d, dtype=torch.float32,
                     device=q.device)
    dv = torch.zeros_like(dk)
    for r0, r1 in _query_chunks(q, k):
        p, ds = _probs_and_ds(q, kf, vf, dout, lse, delta, r0, r1, causal,
                              scale)
        dv += torch.matmul(p.to(dout.dtype).float().transpose(-1, -2),
                           dout[:, :, r0:r1].float())
        dk += torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                           q[:, :, r0:r1].float())
    dk = dk.view(b, hkv, n_rep, skv, d).sum(dim=2).to(k.dtype)
    dv = dv.view(b, hkv, n_rep, skv, d).sum(dim=2).to(v.dtype)
    return dk, dv


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _entry(library: str, symbol: str, n_pointers: int):
    key = (library, symbol)
    if key not in _kernels:
        lib = _build.load(library)
        fn = getattr(lib, symbol)
        fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _kernels[key] = (lib, fn)
    return _kernels[key]


def _check_qkv(q: Tensor, k: Tensor, v: Tensor, **more: Tensor) -> None:
    for name, t in {"k": k, "v": v, **more}.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernels take float32 or bfloat16, got {q.dtype}")
    for name, t in {"k": k, "v": v, **more}.items():
        want = torch.float32 if name in ("lse", "delta") else q.dtype
        if t.dtype != want:
            raise TypeError(f"{name} is {t.dtype}, want {want}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(
            f"want q [B, Hq, S, D] and k, v [B, Hkv, S, D]; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    if hq % k.shape[1]:
        raise ValueError(
            f"query heads {hq} not a multiple of kv heads {k.shape[1]}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {d} unsupported; the kernels are built "
                         f"for {SUPPORTED_HEAD_DIMS}")
    if sq < 1 or k.shape[2] < 1:
        raise ValueError("empty sequence")
    if "dout" in more and more["dout"].shape != q.shape:
        raise ValueError(f"dout {tuple(more['dout'].shape)} != q "
                         f"{tuple(q.shape)}")
    for name in ("lse", "delta"):
        if name in more and more[name].shape != (b, hq, sq):
            raise ValueError(f"{name} must be [B, Hq, Sq] = {(b, hq, sq)}, "
                             f"got {tuple(more[name].shape)}")


def _ready(t: Tensor) -> Tensor:
    """Contiguous and 16-byte aligned (the kernels load 16-byte vectors)."""
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


def _launch(lib, fn, name, args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: "
            f"{_build.cuda_error_string(lib, rc)} (cudaError {rc})")
    _build.launch_counts[name] += 1


def _dims(q: Tensor, k: Tensor):
    b, hq, sq, d = q.shape
    return b, hq, k.shape[1], sq, k.shape[2], d


@torch.library.custom_op("scaletorch_tpu_torch::flash_forward",
                         mutates_args=(), device_types="cpu")
def _flash_forward_op(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                      scale: float) -> Tuple[Tensor, Tensor]:
    """K1 as a dispatcher op (so a selective-checkpoint policy can save its
    outputs, the counterpart of the reference's ``attn_out`` and
    ``attn_lse`` names). On the CPU: the plain version."""
    return flash_forward_ref(q, k, v, causal=causal, scale=scale)


@_flash_forward_op.register_kernel("cuda")
def _flash_forward_cuda(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                        scale: float) -> Tuple[Tensor, Tensor]:
    _check_qkv(q, k, v)
    q, k, v = _ready(q), _ready(k), _ready(v)
    lib, fn = _entry(FWD_LIBRARY, "st_flash_fwd", 5)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _launch(lib, fn, K1_NAME,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), *_dims(q, k), scale, int(causal),
             _DTYPE_CODES[q.dtype], stream))
    return out, lse


@_flash_forward_op.register_fake
def _flash_forward_fake(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                        scale: float) -> Tuple[Tensor, Tensor]:
    return (torch.empty_like(q),
            q.new_empty(q.shape[:3], dtype=torch.float32))


FLASH_FORWARD_OP = torch.ops.scaletorch_tpu_torch.flash_forward.default


def flash_forward(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                  scale: Optional[float] = None) -> Tuple[Tensor, Tensor]:
    """K1: (out [B, Hq, Sq, D] in q's dtype, lse [B, Hq, Sq] fp32), through
    the dispatcher op ``scaletorch_tpu_torch::flash_forward``.

    On a CUDA tensor this launches the hand-written kernel (or raises);
    on a CPU tensor it computes the plain version; another device has no
    kernel and raises."""
    return FLASH_FORWARD_OP(q, k, v, bool(causal), _scale(q, scale))


def flash_dq(q: Tensor, k: Tensor, v: Tensor, dout: Tensor, lse: Tensor,
             delta: Tensor, *, causal: bool,
             scale: Optional[float] = None) -> Tensor:
    """K2: dQ in q's dtype (CUDA: the kernel; CPU: the plain version)."""
    if q.device.type == "cpu":
        return flash_dq_ref(q, k, v, dout, lse, delta, causal=causal,
                            scale=scale)
    _check_qkv(q, k, v, dout=dout, lse=lse, delta=delta)
    q, k, v, dout = _ready(q), _ready(k), _ready(v), _ready(dout)
    lse, delta = _ready(lse), _ready(delta)
    lib, fn = _entry(BWD_LIBRARY, "st_flash_bwd_dq", 7)
    dq = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _launch(lib, fn, K2_NAME,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *_dims(q, k),
             _scale(q, scale), int(causal), _DTYPE_CODES[q.dtype], stream))
    return dq


def flash_dkv(q: Tensor, k: Tensor, v: Tensor, dout: Tensor, lse: Tensor,
              delta: Tensor, *, causal: bool,
              scale: Optional[float] = None) -> Tuple[Tensor, Tensor]:
    """K3: (dK, dV) [B, Hkv, Skv, D] (CUDA: the kernel; CPU: the plain
    version)."""
    if q.device.type == "cpu":
        return flash_dkv_ref(q, k, v, dout, lse, delta, causal=causal,
                             scale=scale)
    _check_qkv(q, k, v, dout=dout, lse=lse, delta=delta)
    q, k, v, dout = _ready(q), _ready(k), _ready(v), _ready(dout)
    lse, delta = _ready(lse), _ready(delta)
    lib, fn = _entry(BWD_LIBRARY, "st_flash_bwd_dkv", 8)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _launch(lib, fn, K3_NAME,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             *_dims(q, k), _scale(q, scale), int(causal),
             _DTYPE_CODES[q.dtype], stream))
    return dk, dv


def attention_delta(out: Tensor, dout: Tensor) -> Tensor:
    """``rowsum(dO * O)`` in fp32 [B, Hq, S]: the backward's per-row
    constant, computed outside the kernels as the reference computes it in
    XLA."""
    return torch.sum(dout.float() * out.float(), dim=-1)


# ---------------------------------------------------------------------------
# the differentiable op
# ---------------------------------------------------------------------------
class _FlashAttention(torch.autograd.Function):
    """Forward: K1 (the dispatcher op), saving (q, k, v, out, lse).
    Backward: delta in plain torch, then K2 and K3. Under the
    ``save_attn`` remat policy the recomputed forward takes K1's saved
    (out, lse) instead of launching it again."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_forward(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_block_backward(q, k, v, out, lse, dout,
                                          causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    scale: Optional[float] = None) -> Tensor:
    """q [B, Hq, S, D]; k, v [B, Hkv, Skv, D]; Hq % Hkv == 0 (GQA).
    Counterpart of ``pallas_flash_attention``; the tiles are the kernels'
    own, so there are no block arguments."""
    if q.shape[1] % k.shape[1]:
        raise ValueError(
            f"query heads {q.shape[1]} not a multiple of kv heads {k.shape[1]}")
    return _FlashAttention.apply(q, k, v, causal, _scale(q, scale))


def flash_forward_with_lse(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                           scale: Optional[float] = None
                           ) -> Tuple[Tensor, Tensor]:
    """Raw K1 forward returning ``(out, lse)``. NOT differentiable: the
    caller (ring attention) owns the VJP."""
    if q.shape[1] % k.shape[1]:
        raise ValueError(
            f"query heads {q.shape[1]} not a multiple of kv heads {k.shape[1]}")
    with torch.no_grad():
        return flash_forward(q, k, v, causal=causal, scale=_scale(q, scale))


def flash_block_backward(q: Tensor, k: Tensor, v: Tensor, out: Tensor,
                         lse: Tensor, dout: Tensor, *, causal: bool,
                         scale: Optional[float] = None
                         ) -> Tuple[Tensor, Tensor, Tensor]:
    """Gradients of one K/V block against a GLOBAL softmax statistic:
    ``out``/``lse`` are the final merged output and log-sum-exp, so the
    returned (dq, dk, dv) are this block's additive contribution. dk/dv
    come back unexpanded [B, Hkv, S, D]. Not differentiable."""
    if q.shape[1] % k.shape[1]:
        raise ValueError(
            f"query heads {q.shape[1]} not a multiple of kv heads {k.shape[1]}")
    scale = _scale(q, scale)
    with torch.no_grad():
        delta = attention_delta(out, dout)
        dq = flash_dq(q, k, v, dout, lse, delta, causal=causal, scale=scale)
        dk, dv = flash_dkv(q, k, v, dout, lse, delta, causal=causal,
                           scale=scale)
    return dq, dk, dv
