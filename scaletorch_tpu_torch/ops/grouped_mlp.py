"""Grouped per-expert SwiGLU MLP: the CUDA kernels K5-K7, their plain
versions and the VJP.

PyTorch counterpart of scaletorch_tpu/ops/pallas/grouped_mlp.py. Each
expert applies its own gate/up/down projections to its capacity slots
``x [E, G, C, H]``; the slots of each (expert, group) are filled as a
prefix of ``counts [E, G]`` rows, and the kernels skip every slot tile
past it. Rows at or past the count come out as structural zeros.

  * **K5** ``grouped_mlp_forward`` (``csrc/grouped_mlp_fwd.cu``): h =
    swiglu(x Wg, x Wu) rounded to x's dtype, then h Wd; replaces
    ``_kernel``.
  * **K6** ``grouped_mlp_dx`` (``csrc/grouped_mlp_bwd.cu``): dx = dG Wg^T
    + dU Wu^T; replaces ``_dx_kernel``.
  * **K7** ``grouped_mlp_dw`` (same source): dWg, dWu, dWd summed over
    the groups and the filled slots, with dO masked past the count;
    replaces ``_dw_kernel``.
  * ``grouped_mlp_block_grads``: s, dG and dU (the TPU kernels'
    ``_block_grads``, rounded to x's dtype as they round them), computed
    once per backward in a pass of the same source and read by K6 and K7.

Each wrapper launches its kernel on a CUDA tensor (or raises) and
computes its plain version on a CPU tensor. The plain versions repeat the
kernels' arithmetic: fp32 products, the rounding of h, s, dG and dU to
x's dtype, rows past the count masked. ``masked_grouped_mlp`` (K5's) is
also the reference's dense off-TPU path. ``grouped_swiglu_mlp`` is the
differentiable op (``_GroupedSwiGLU``).

The kernels take widths H and I that are multiples of 64 (Qwen3-30B-A3B:
2048 and 768) and any capacity C; they pick their own tiles, so there are
no block arguments.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from scaletorch_tpu_torch.ops import _build

Tensor = torch.Tensor
Grads = Tuple[Tensor, Tensor, Tensor]

FWD_LIBRARY = "grouped_mlp_fwd"
BWD_LIBRARY = "grouped_mlp_bwd"
# launch-count names: one per kernel, and the shared backward pass
K5_NAME = "grouped_mlp_fwd"
K6_NAME = "grouped_mlp_dx"
K7_NAME = "grouped_mlp_dw"
GRADS_NAME = "grouped_mlp_grads"

WIDTH_MULTIPLE = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_kernels = {}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _row_mask(counts: Tensor, cap: int) -> Tensor:
    """[E, G, C, 1] bool: slot c of (e, g) holds a row (c < count)."""
    slots = torch.arange(cap, device=counts.device)
    return (slots[None, None, :] < counts[..., None])[..., None]


def _masked(t: Tensor, mask: Tensor) -> Tensor:
    return torch.where(mask, t, torch.zeros((), dtype=t.dtype,
                                            device=t.device))


def masked_grouped_mlp(x: Tensor, counts: Tensor, wg: Tensor, wu: Tensor,
                       wd: Tensor) -> Tensor:
    """K5's plain version: rows past the count masked to 0 on the way in
    and out; gate/up/down in fp32, h rounded to x's dtype between them.
    Differentiable by autograd."""
    mask = _row_mask(counts, x.shape[2])
    xf = _masked(x, mask).float()
    gate = torch.matmul(xf, wg.float()[:, None])
    up = torch.matmul(xf, wu.float()[:, None])
    h = (F.silu(gate) * up).to(x.dtype)
    out = torch.matmul(h.float(), wd.float()[:, None])
    return _masked(out, mask).to(x.dtype)


def grouped_mlp_block_grads_ref(x: Tensor, counts: Tensor, wg: Tensor,
                                wu: Tensor, wd: Tensor, dout: Tensor
                                ) -> Grads:
    """(s, dG, dU) [E, G, C, I] in x's dtype: the recomputed gate/up, the
    gradient through Wd and swiglu, with x and dO masked past the count
    (the TPU dW kernel's dO mask)."""
    mask = _row_mask(counts, x.shape[2])
    xf = _masked(x, mask).float()
    g = torch.matmul(xf, wg.float()[:, None])
    u = torch.matmul(xf, wu.float()[:, None])
    sig = torch.sigmoid(g)
    silu = g * sig
    ds = torch.matmul(_masked(dout, mask).float(),
                      wd.float().transpose(-1, -2)[:, None])
    du = ds * silu
    dg = ds * u * (sig * (1.0 + g * (1.0 - sig)))
    return (silu * u).to(x.dtype), dg.to(x.dtype), du.to(x.dtype)


def grouped_mlp_dx_ref(x: Tensor, counts: Tensor, wg: Tensor, wu: Tensor,
                       wd: Tensor, dout: Tensor,
                       grads: Optional[Grads] = None) -> Tensor:
    """K6's plain version: dx in x's dtype, zero past the count."""
    if grads is None:
        grads = grouped_mlp_block_grads_ref(x, counts, wg, wu, wd, dout)
    _, dg, du = grads
    dx = (torch.matmul(dg.float(), wg.float().transpose(-1, -2)[:, None])
          + torch.matmul(du.float(), wu.float().transpose(-1, -2)[:, None]))
    return _masked(dx, _row_mask(counts, x.shape[2])).to(x.dtype)


def grouped_mlp_dw_ref(x: Tensor, counts: Tensor, wg: Tensor, wu: Tensor,
                       wd: Tensor, dout: Tensor,
                       grads: Optional[Grads] = None
                       ) -> Tuple[Tensor, Tensor, Tensor]:
    """K7's plain version: (dWg, dWu, dWd) in the weights' dtype, summed
    in fp32 over the groups and the slots below the count."""
    if grads is None:
        grads = grouped_mlp_block_grads_ref(x, counts, wg, wu, wd, dout)
    s, dg, du = grads
    mask = _row_mask(counts, x.shape[2])
    xf = _masked(x, mask).float()
    dof = _masked(dout, mask).float()
    dwg = torch.einsum("egch,egci->ehi", xf, _masked(dg, mask).float())
    dwu = torch.einsum("egch,egci->ehi", xf, _masked(du, mask).float())
    dwd = torch.einsum("egci,egch->eih", _masked(s, mask).float(), dof)
    return dwg.to(wg.dtype), dwu.to(wu.dtype), dwd.to(wd.dtype)


def slot_fill_counts(dispatch: Tensor) -> Tensor:
    """[G, N, E, C] (or [N, E, C]) dispatch one-hots -> [E, G] int32 fill
    counts: capacity dispatch fills slots as a prefix, so the count is the
    number of occupied slots."""
    if dispatch.ndim == 3:
        dispatch = dispatch[None]
    return dispatch.sum(dim=(1, 3)).to(torch.int32).T.contiguous()


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _entry(library: str, symbol: str, n_pointers: int):
    key = (library, symbol)
    if key not in _kernels:
        lib = _build.load(library)
        fn = getattr(lib, symbol)
        fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _kernels[key] = (lib, fn)
    return _kernels[key]


def dw_resident_rows() -> int:
    """Rows of an expert (its filled 64-row slot tiles over all groups)
    that bf16 K7 keeps resident in shared memory; past it, K7 streams
    them. Read from the built kernel library."""
    fn = _build.load(BWD_LIBRARY).st_grouped_mlp_bwd_resident_rows
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def _check(x: Tensor, counts: Tensor, wg: Tensor, wu: Tensor, wd: Tensor,
           dout: Optional[Tensor] = None) -> None:
    tensors = {"counts": counts, "wg": wg, "wu": wu, "wd": wd}
    if dout is not None:
        tensors["dout"] = dout
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernels take float32 or bfloat16, got {x.dtype}")
    for name, t in tensors.items():
        want = torch.int32 if name == "counts" else x.dtype
        if t.dtype != want:
            raise TypeError(f"{name} is {t.dtype}, want {want}")
    if x.ndim != 4:
        raise ValueError(f"want x [E, G, C, H], got {tuple(x.shape)}")
    e, g, _, h = x.shape
    i = wg.shape[-1]
    want_shapes = {"counts": (e, g), "wg": (e, h, i), "wu": (e, h, i),
                   "wd": (e, i, h), "dout": tuple(x.shape)}
    for name, t in tensors.items():
        if tuple(t.shape) != want_shapes[name]:
            raise ValueError(f"{name} is {tuple(t.shape)}, want "
                             f"{want_shapes[name]}")
    if h % WIDTH_MULTIPLE or i % WIDTH_MULTIPLE:
        raise ValueError(f"H {h} and I {i} must be multiples of "
                         f"{WIDTH_MULTIPLE} for the kernels")
    if e * g > 65535:
        raise ValueError(f"E * G = {e * g} > 65535 (the grid's limit)")


def _ready(t: Tensor) -> Tensor:
    """Contiguous and 16-byte aligned (the kernels load 16-byte vectors)."""
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


def _launch(lib, fn, name: str, args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: "
            f"{_build.cuda_error_string(lib, rc)} (cudaError {rc})")
    _build.launch_counts[name] += 1


def _tail(x: Tensor, wg: Tensor):
    """The shape and dtype arguments every entry ends with."""
    e, g, c, h = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return (e, g, c, h, wg.shape[-1], _DTYPE_CODES[x.dtype], stream)


def _workspace(x: Tensor, wg: Tensor) -> Tensor:
    e, g, c, _ = x.shape
    return torch.empty(e, g, c, wg.shape[-1], dtype=x.dtype, device=x.device)


def grouped_mlp_forward(x: Tensor, counts: Tensor, wg: Tensor, wu: Tensor,
                        wd: Tensor) -> Tensor:
    """K5: out [E, G, C, H] in x's dtype, zero past each count.

    On a CUDA tensor this launches the hand-written kernel (or raises);
    on a CPU tensor it computes the plain version."""
    if x.device.type == "cpu":
        return masked_grouped_mlp(x, counts, wg, wu, wd)
    _check(x, counts, wg, wu, wd)
    x, counts, wg, wu, wd = (_ready(t) for t in (x, counts, wg, wu, wd))
    lib, fn = _entry(FWD_LIBRARY, "st_grouped_mlp_fwd", 7)
    h_ws = _workspace(x, wg)
    out = torch.empty_like(x)
    _launch(lib, fn, K5_NAME,
            (x.data_ptr(), counts.data_ptr(), wg.data_ptr(), wu.data_ptr(),
             wd.data_ptr(), h_ws.data_ptr(), out.data_ptr(), *_tail(x, wg)))
    return out


def grouped_mlp_block_grads(x: Tensor, counts: Tensor, wg: Tensor,
                            wu: Tensor, wd: Tensor, dout: Tensor) -> Grads:
    """(s, dG, dU) [E, G, C, I] in x's dtype for K6 and K7 (CUDA: the
    kernel's grads pass; CPU: the plain version). Rows of tiles past the
    count are left unwritten: K6 and K7 never read them."""
    if x.device.type == "cpu":
        return grouped_mlp_block_grads_ref(x, counts, wg, wu, wd, dout)
    _check(x, counts, wg, wu, wd, dout)
    x, counts, wg, wu, wd, dout = (
        _ready(t) for t in (x, counts, wg, wu, wd, dout))
    lib, fn = _entry(BWD_LIBRARY, "st_grouped_mlp_bwd_grads", 9)
    s, dg, du = (_workspace(x, wg) for _ in range(3))
    _launch(lib, fn, GRADS_NAME,
            (x.data_ptr(), counts.data_ptr(), wg.data_ptr(), wu.data_ptr(),
             wd.data_ptr(), dout.data_ptr(), s.data_ptr(), dg.data_ptr(),
             du.data_ptr(), *_tail(x, wg)))
    return s, dg, du


def grouped_mlp_dx(x: Tensor, counts: Tensor, wg: Tensor, wu: Tensor,
                   wd: Tensor, dout: Tensor,
                   grads: Optional[Grads] = None) -> Tensor:
    """K6: dx [E, G, C, H] in x's dtype, zero past each count (CUDA: the
    kernel; CPU: the plain version). ``grads`` passes the (s, dG, dU) of
    ``grouped_mlp_block_grads`` when they are already computed."""
    if x.device.type == "cpu":
        return grouped_mlp_dx_ref(x, counts, wg, wu, wd, dout, grads)
    if grads is None:
        grads = grouped_mlp_block_grads(x, counts, wg, wu, wd, dout)
    _check(x, counts, wg, wu, wd, dout)
    counts, wg, wu = _ready(counts), _ready(wg), _ready(wu)
    _, dg, du = (_ready(t) for t in grads)
    lib, fn = _entry(BWD_LIBRARY, "st_grouped_mlp_bwd_dx", 6)
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    _launch(lib, fn, K6_NAME,
            (counts.data_ptr(), wg.data_ptr(), wu.data_ptr(), dg.data_ptr(),
             du.data_ptr(), dx.data_ptr(), *_tail(x, wg)))
    return dx


def grouped_mlp_dw(x: Tensor, counts: Tensor, wg: Tensor, wu: Tensor,
                   wd: Tensor, dout: Tensor,
                   grads: Optional[Grads] = None
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """K7: (dWg, dWu, dWd) in the weights' dtype (CUDA: the kernel; CPU:
    the plain version). ``grads`` as for ``grouped_mlp_dx``."""
    if x.device.type == "cpu":
        return grouped_mlp_dw_ref(x, counts, wg, wu, wd, dout, grads)
    if grads is None:
        grads = grouped_mlp_block_grads(x, counts, wg, wu, wd, dout)
    _check(x, counts, wg, wu, wd, dout)
    x, counts, dout = _ready(x), _ready(counts), _ready(dout)
    s, dg, du = (_ready(t) for t in grads)
    lib, fn = _entry(BWD_LIBRARY, "st_grouped_mlp_bwd_dw", 9)
    dwg, dwu, dwd = (torch.empty(w.shape, dtype=w.dtype, device=w.device)
                     for w in (wg, wu, wd))
    _launch(lib, fn, K7_NAME,
            (x.data_ptr(), counts.data_ptr(), dout.data_ptr(), s.data_ptr(),
             dg.data_ptr(), du.data_ptr(), dwg.data_ptr(), dwu.data_ptr(),
             dwd.data_ptr(), *_tail(x, wg)))
    return dwg, dwu, dwd


# ---------------------------------------------------------------------------
# the differentiable op
# ---------------------------------------------------------------------------
class _GroupedSwiGLU(torch.autograd.Function):
    """Forward: K5, saving its inputs. Backward: the grads pass once, then
    K6 and K7 (their plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, x, counts, wg, wu, wd):
        ctx.save_for_backward(x, counts, wg, wu, wd)
        return grouped_mlp_forward(x, counts, wg, wu, wd)

    @staticmethod
    def backward(ctx, dout):
        x, counts, wg, wu, wd = ctx.saved_tensors
        dout = dout.contiguous()
        grads = grouped_mlp_block_grads(x, counts, wg, wu, wd, dout)
        dx = grouped_mlp_dx(x, counts, wg, wu, wd, dout, grads)
        dwg, dwu, dwd = grouped_mlp_dw(x, counts, wg, wu, wd, dout, grads)
        return dx, None, dwg, dwu, dwd


def grouped_swiglu_mlp(x: Tensor, counts: Tensor, wg: Tensor, wu: Tensor,
                       wd: Tensor) -> Tensor:
    """x [E, G, C, H] capacity slots (prefix-filled per (e, g)); counts
    [E, G] int32; wg/wu [E, H, I]; wd [E, I, H] -> [E, G, C, H], rows at
    or past the count zero. Differentiable in x and the weights.
    Counterpart of the reference's ``grouped_swiglu_mlp``; the tiles are
    the kernels' own, so there are no block arguments."""
    return _GroupedSwiGLU.apply(x, counts.to(torch.int32), wg, wu, wd)
