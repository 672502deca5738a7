"""Paged-decode attention and the paged-cache KV primitives.

PyTorch counterpart of scaletorch_tpu/ops/pallas/paged_attention.py.
The paged KV cache keeps one global pool of fixed-size pages
``[n_pages, Hkv, page_size, D]`` per layer; each decode slot owns a page
table ``[max_pages]`` int32 mapping logical page ``t // page_size`` to a
physical pool page. Three implementations of attention against it:

  * **the CUDA kernel** (``paged_decode_attention`` on a CUDA tensor):
    one query token per slot, written by hand for Hopper in
    ``csrc/paged_decode.cu``. It replaces the Pallas kernel
    ``_paged_decode_kernel`` and reads only the live pages. It cuts each
    slot's keys into splits of ``keys_per_split()`` keys (``split_plan``:
    from the shapes alone), computes each split's softmax state on its own
    CTA, and the last CTA of a (slot, KV head) merges the live splits in
    a fixed order, through an fp32 workspace that the wrapper allocates
    and a buffer of counters that it keeps per (device, stream).
  * **its plain version** (``paged_decode_attention_ref``): the gather
    of both pools, the ``seq_limit`` crop, then ``cached_sdpa_attention``
    — what the JAX dispatcher's fallback does at S = 1. The CPU path and
    the tests use it; with a card present, nothing on the main path does.
    ``paged_decode_split_ref`` models the kernel's split and merge in
    plain PyTorch for the tests.
  * **the gather path** for prefill (S > 1) in ``paged_attention``.

Writes (``paged_write_kv``) scatter token ``t`` to ``(table[b, t //
page_size], t % page_size)`` IN PLACE. Masked-off slots and positions
beyond the table go to the reserved TRASH page 0, so the write is
unconditional and no shape ever depends on the data.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from scaletorch_tpu_torch.models.layers import cached_sdpa_attention
from scaletorch_tpu_torch.ops import _build

Tensor = torch.Tensor

# Page 0 is reserved: never allocated, present in page tables only as
# the sentinel for "no page here" (table padding, masked-off writes).
TRASH_PAGE = 0

KERNEL_NAME = "paged_decode"
# the geometries K4 is built for: every preset's head_dim (32, 64, 128),
# the audit entries' and the examples' 16, and every n_rep up to 8 (the
# presets use 2, 4, 5 and 8)
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
SUPPORTED_N_REP = tuple(range(1, 9))
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MASKED = -1e30  # the Pallas kernel's mask value

_kernel_fn = None
# (device, stream) -> int32 counters of the splits of each (slot, KV head)
# that have finished, zero between calls (the kernel's last split of a
# (slot, head) resets its own). A captured step's warm-up creates its
# capture stream's buffer outside the graph's pool, and the graph keeps
# using it on every replay.
_split_counters: dict = {}


# ---------------------------------------------------------------------------
# paged cache primitives
# ---------------------------------------------------------------------------
def paged_gather_kv(pool: Tensor, page_tables: Tensor) -> Tensor:
    """pool [n_pages, Hkv, page_size, D], page_tables [B, max_pages] ->
    the dense view [B, Hkv, max_pages * page_size, D]."""
    view = pool[page_tables.long()]  # [B, max_pages, Hkv, page_size, D]
    b, mp, h, p, d = view.shape
    return view.permute(0, 2, 1, 3, 4).reshape(b, h, mp * p, d)


def paged_write_targets(
    positions: Tensor,
    page_tables: Tensor,
    page_size: int,
    write_mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """(pages, offsets) [B, S] int64 where the tokens at ``positions``
    [B, S] land: ``(table[b, t // page_size], t % page_size)``, with
    masked-off slots and positions past the table sent to TRASH."""
    max_pages = page_tables.shape[1]
    positions = positions.long()
    logical = positions // page_size
    offsets = positions % page_size
    valid = logical < max_pages
    pages = torch.take_along_dim(
        page_tables.long(), logical.clamp(max=max_pages - 1), dim=1)
    if write_mask is not None:
        valid = valid & write_mask[:, None]
    return torch.where(valid, pages, TRASH_PAGE), offsets


def paged_write_kv(
    pool: Tensor,
    new: Tensor,
    positions: Tensor,
    page_tables: Tensor,
    page_size: int,
    write_mask: Optional[Tensor] = None,
    *,
    targets: Optional[Tuple[Tensor, Tensor]] = None,
) -> Tensor:
    """Scatter ``new`` [B, H, S, D] into ``pool`` [n_pages, H, page_size,
    D] at the absolute ``positions`` [B, S] through ``page_tables`` [B,
    max_pages], IN PLACE, and return ``pool``. ``write_mask`` [B] bool
    redirects the unlisted slots' writes to the TRASH page; positions
    past the table's reach go there too. Duplicate targets occur only on
    the TRASH page, whose contents nothing reads unmasked. ``targets``
    passes ``paged_write_targets``' result when it is already known."""
    if targets is None:
        targets = paged_write_targets(positions, page_tables, page_size,
                                      write_mask)
    pages, offsets = targets
    # advanced indices split by a slice put their broadcast dims first:
    # the indexed view is [B, S, H, D]
    pool[pages, :, offsets, :] = new.to(pool.dtype).transpose(1, 2)
    return pool


# ---------------------------------------------------------------------------
# the decode kernel and its plain version
# ---------------------------------------------------------------------------
def paged_decode_attention_ref(
    q: Tensor,
    pool_k: Tensor,
    pool_v: Tensor,
    page_tables: Tensor,
    positions: Tensor,
    *,
    scale: Optional[float] = None,
    seq_limit: Optional[int] = None,
) -> Tensor:
    """The kernel's plain version: q [B, Hq, D] against the pools ->
    [B, Hq, D], keys at positions <= ``positions[b]``."""
    out = _gather_attention(q[:, :, None, :], pool_k, pool_v, page_tables,
                            positions[:, None], scale=scale,
                            seq_limit=seq_limit)
    return out[:, :, 0, :]


def _gather_attention(q, pool_k, pool_v, page_tables, q_positions, *,
                      scale, seq_limit):
    """The gather path: the dense view of both pools, cropped to
    ``seq_limit``, then ``cached_sdpa_attention``."""
    k = paged_gather_kv(pool_k, page_tables)
    v = paged_gather_kv(pool_v, page_tables)
    if seq_limit is not None and k.shape[2] > seq_limit:
        k = k[:, :, :seq_limit, :]
        v = v[:, :, :seq_limit, :]
    return cached_sdpa_attention(q, k, v, q_positions, scale=scale)


# ---------------------------------------------------------------------------
# the split plan and its plain model
# ---------------------------------------------------------------------------
def split_plan(max_pages: int, page_size: int, keys_per_split: int) -> int:
    """Splits of every slot's key range: ``ceil(max_pages * page_size /
    keys_per_split)``. A function of the shapes alone, so the kernel's
    grid and workspace never depend on the positions."""
    return -(-(max_pages * page_size) // keys_per_split)


def workspace_shape(batch: int, num_q_heads: int, head_dim: int,
                    splits: int) -> Tuple[int, int, int, int]:
    """The kernel's fp32 workspace: per split and query row, the partial
    softmax state ``(m, l, acc[head_dim])``."""
    return (splits, batch, num_q_heads, head_dim + 2)


def paged_decode_split_ref(
    q: Tensor,
    pool_k: Tensor,
    pool_v: Tensor,
    page_tables: Tensor,
    positions: Tensor,
    *,
    keys_per_split: int,
    scale: Optional[float] = None,
) -> Tensor:
    """The kernel's split and merge in plain PyTorch (for the tests), with
    splits of ``keys_per_split`` keys: each split's unnormalised state
    ``m = max s``, ``l = sum p``, ``acc = p V`` over its keys (a split
    with no visible key counts as ``m = -1e30, l = 0, acc = 0``), then
    ``M = max m``, ``L = sum l e^(m - M)``, ``out = sum acc e^(m - M) /
    max(L, 1e-30)``. Scores in fp32, scaled after the
    product; p rounded to the cache dtype before P V."""
    b, hq, d = q.shape
    _, hkv, page_size, _ = pool_k.shape
    max_pages = page_tables.shape[1]
    n_rep = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    splits = split_plan(max_pages, page_size, keys_per_split)
    pad = splits * keys_per_split - max_pages * page_size

    def by_split(pool):  # [B, Hkv, splits, keys_per_split, D]
        dense = paged_gather_kv(pool, page_tables)
        dense = torch.nn.functional.pad(dense, (0, 0, 0, pad))
        return dense.view(b, hkv, splits, keys_per_split, d)

    k, v = by_split(pool_k), by_split(pool_v)
    qg = q.view(b, hkv, n_rep, d)
    s = torch.einsum("bhrd,bhskd->bhsrk", qg.float(), k.float()) * scale
    key = torch.arange(splits * keys_per_split, device=q.device)
    last = positions.long().clamp(max=max_pages * page_size - 1)
    visible = (key[None, :] <= last[:, None]).view(
        b, 1, splits, 1, keys_per_split)
    s = torch.where(visible, s, torch.full_like(s, _MASKED))
    m = s.amax(dim=-1)                                     # [B,Hkv,S,R]
    p = torch.where(visible, torch.exp(s - m[..., None]),
                    torch.zeros_like(s))
    l = p.sum(dim=-1)
    acc = torch.einsum("bhsrk,bhskd->bhsrd", p.to(pool_v.dtype).float(),
                       v.float())
    big_m = m.amax(dim=2, keepdim=True)
    w = torch.exp(m - big_m)
    big_l = (l * w).sum(dim=2)
    out = (acc * w[..., None]).sum(dim=2) / big_l.clamp(min=1e-30)[..., None]
    return out.reshape(b, hq, d).to(q.dtype)


def _counters(device: torch.device, stream: int, n: int) -> Tensor:
    """At least ``n`` zeroed counters, one buffer per (device, stream):
    two streams never share one."""
    buf = _split_counters.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _split_counters[(device, stream)] = buf
    return buf


def _load_kernel():
    global _kernel_fn
    if _kernel_fn is None:
        lib = _build.load(KERNEL_NAME)
        fn = lib.st_paged_decode_attention
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong]
                       + [ctypes.c_void_p] + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        kps = lib.st_paged_decode_keys_per_split
        kps.restype = ctypes.c_int
        _kernel_fn = (lib, fn, kps())
    return _kernel_fn


def keys_per_split() -> int:
    """Keys of one split: the kernel's compile-time constant, read from
    the built library (which this builds on first use)."""
    return _load_kernel()[2]


def _check_kernel_inputs(q, pool_k, pool_v, page_tables, positions) -> None:
    tensors = {"q": q, "pool_k": pool_k, "pool_v": pool_v,
               "page_tables": page_tables, "positions": positions}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        # q and the pools are read with vector loads of up to 16 bytes;
        # the int32 tables and positions element by element
        align = 16 if t.is_floating_point() else t.element_size()
        if t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {q.dtype}")
    if pool_k.dtype != q.dtype or pool_v.dtype != q.dtype:
        raise TypeError(
            f"q ({q.dtype}) and the pools ({pool_k.dtype}, {pool_v.dtype}) "
            "must share one dtype")
    if page_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError("page_tables and positions must be int32")
    if q.ndim != 3 or pool_k.ndim != 4 or pool_k.shape != pool_v.shape:
        raise ValueError(
            f"want q [B, Hq, D] and pools [n_pages, Hkv, page_size, D]; got "
            f"{tuple(q.shape)}, {tuple(pool_k.shape)}, {tuple(pool_v.shape)}")
    b, hq, d = q.shape
    _, hkv, _, dp = pool_k.shape
    if dp != d:
        raise ValueError(f"head dim of q ({d}) != the pools' ({dp})")
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"head_dim {d} unsupported; the kernel is built for "
            f"{SUPPORTED_HEAD_DIMS}")
    if hq // hkv not in SUPPORTED_N_REP:
        raise ValueError(
            f"{hq // hkv} query heads per kv head unsupported; the kernel "
            f"is built for {SUPPORTED_N_REP}")
    if page_tables.ndim != 2 or page_tables.shape[0] != b:
        raise ValueError(
            f"page_tables must be [B={b}, max_pages], got "
            f"{tuple(page_tables.shape)}")
    if positions.shape != (b,):
        raise ValueError(f"positions must be [B={b}], got "
                         f"{tuple(positions.shape)}")


def paged_decode_attention(
    q: Tensor,
    pool_k: Tensor,
    pool_v: Tensor,
    page_tables: Tensor,
    positions: Tensor,
    *,
    scale: Optional[float] = None,
) -> Tensor:
    """One-token paged attention: q [B, Hq, D] against the page pools
    [n_pages, Hkv, page_size, D] through ``page_tables`` [B, max_pages]
    int32, keys at positions <= ``positions`` [B] int32 -> [B, Hq, D].

    On a CUDA tensor this launches the hand-written kernel (or raises);
    on a CPU tensor it computes the kernel's plain version. The kernel's
    grid and its fp32 workspace follow from the shapes alone: nothing is
    read back from the card.
    """
    if q.device.type == "cpu":
        return paged_decode_attention_ref(
            q, pool_k, pool_v, page_tables, positions, scale=scale)
    _check_kernel_inputs(q, pool_k, pool_v, page_tables, positions)
    b, hq, d = q.shape
    _, hkv, page_size, _ = pool_k.shape
    max_pages = page_tables.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    lib, fn, kps = _load_kernel()
    out = torch.empty_like(q)
    splits = split_plan(max_pages, page_size, kps)
    workspace = torch.empty(workspace_shape(b, hq, d, splits),
                            dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    counters = _counters(q.device, stream, b * hkv)
    rc = fn(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
            page_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
            workspace.data_ptr(), workspace.numel() * 4,
            counters.data_ptr(), counters.numel(), b, hq, hkv, d,
            page_size, max_pages, float(scale), _DTYPE_CODES[q.dtype],
            stream)
    if rc != 0:
        raise RuntimeError(
            f"paged-decode kernel launch failed: "
            f"{_build.cuda_error_string(lib, rc)} (cudaError {rc})")
    _build.launch_counts[KERNEL_NAME] += 1
    return out


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------
def paged_attention(
    q: Tensor,
    pool_k: Tensor,
    pool_v: Tensor,
    page_tables: Tensor,
    q_positions: Tensor,
    *,
    page_size: int,
    seq_limit: Optional[int] = None,
    scale: Optional[float] = None,
    kernel: Optional[bool] = None,
) -> Tensor:
    """Attention against the paged cache. q: [B, Hq, S, D]; q_positions:
    [B, S] absolute positions.

    ``kernel=None`` takes the CUDA kernel for single-token decode on a
    CUDA tensor, and the gather path (``paged_gather_kv`` +
    ``cached_sdpa_attention``) for prefill (S > 1) and on the CPU.
    ``kernel=True`` forces the kernel and raises where it cannot run;
    ``kernel=False`` forces the gather path. ``seq_limit`` crops the
    gathered view to the engine's ``max_seq`` so the gather path has
    exactly the dense layout's operand shapes (the paged == dense
    bit-identity contract). ``page_size`` is carried for the JAX
    signature; the pools' shape holds it.
    """
    s = q.shape[2]
    use_kernel = kernel
    if use_kernel is None:
        use_kernel = s == 1 and q.is_cuda
    if use_kernel:
        if not q.is_cuda:
            raise ValueError(
                "the paged-decode kernel runs on a CUDA tensor only; "
                "pass kernel=None or kernel=False on the CPU")
        if s != 1:
            raise ValueError(
                f"the paged-decode kernel serves single-token queries; "
                f"got S={s} (prefill goes through the gather path)")
        out = paged_decode_attention(
            q[:, :, 0, :].contiguous(), pool_k, pool_v, page_tables,
            q_positions[:, 0].to(torch.int32).contiguous(), scale=scale)
        return out[:, :, None, :]
    return _gather_attention(q, pool_k, pool_v, page_tables, q_positions,
                             scale=scale, seq_limit=seq_limit)
