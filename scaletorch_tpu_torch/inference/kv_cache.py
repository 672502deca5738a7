"""KV-cache containers in the models' stacked layout (PyTorch port).

Counterpart of scaletorch_tpu/inference/kv_cache.py:

  * dense: ``KVCache``, one buffer pair ``[L, B, Hkv, S_max, D]`` (GPT-MoE:
    ``[L, B, H, S_max, D]``);
  * ``MLACache``: MLA attention's latent-only buffer ``[B, S_max, R]``;
  * paged: ``PagedKVCache``, a global pool of fixed-size pages
    ``[L, n_pages, Hkv, page_size, D]`` plus per-slot page tables
    (``[B, max_pages]`` int32, TRASH_PAGE-padded). ``PageAllocator``
    (host-side free list + refcounts) and ``RadixPrefixCache``
    (page-granular radix tree over token chunks) keep the bookkeeping,
    with the JAX package's class and method names and logic line for
    line; ``PagedKVIO`` adapts the model's cached forward to the pool.

The buffers are written in place by the steps (the counterpart of the
JAX package's donation), so a pool keeps its ``data_ptr()`` for the
engine's lifetime.

Over a serving mesh (a ``parallel.mesh.MeshManager`` of tp and dp ranks,
one process each) a rank holds its shard of each buffer:
``kv_cache_specs`` / ``paged_kv_cache_specs`` name the mesh axis of each
dim (the reference's ``PartitionSpec`` entries: KV heads over tp, as the
column-parallel k/v projections split them; dense slots optionally over
``batch_axis``; the page axis never), ``kv_cache_shardings`` /
``paged_kv_cache_shardings`` bind them to a mesh (``CacheSharding``: the
rank's local shape), and ``init_kv_cache`` / ``init_paged_kv_cache`` /
``kv_cache_bytes`` take one to allocate and count only the rank's shard.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from scaletorch_tpu_torch.ops.paged_attention import (
    TRASH_PAGE,
    paged_attention,
    paged_write_kv,
    paged_write_targets,
)
from scaletorch_tpu_torch.utils.device import DeviceLike, resolve_device

Tensor = torch.Tensor


class KVCache(NamedTuple):
    """Stacked per-layer cache buffers, each [L, B, Hkv, S_max, D]; unpacks
    as the plain ``(k, v)`` pair the cached forward consumes."""

    k: Tensor
    v: Tensor


class PagedKVCache(NamedTuple):
    """Stacked page pools, each [L, n_pages, Hkv, page_size, D]. Which
    slot owns which page lives host-side (``PageAllocator`` + the
    engine's page tables) and reaches the device as data."""

    k: Tensor
    v: Tensor


class MLACache(NamedTuple):
    """Latent-only cache [B, S_max, kv_rank] of MLA attention
    (``models/attention``)."""

    latent: Tensor


def kv_cache_shape(cfg, batch: int, max_seq: int) -> Tuple[int, ...]:
    """[L, B, Hkv, S_max, D] for a Llama-family config, or [L, B, H,
    S_max, D] for GPT-MoE (full per-head K/V)."""
    if hasattr(cfg, "num_key_value_heads"):
        return (cfg.num_hidden_layers, batch, cfg.num_key_value_heads,
                max_seq, cfg.actual_head_dim)
    if hasattr(cfg, "n_layer"):  # GPTMoEConfig
        return (cfg.n_layer, batch, cfg.n_head, max_seq, cfg.head_dim)
    raise TypeError(f"no KV-cache layout known for config {type(cfg).__name__}")


def ceil_div(a: int, b: int) -> int:
    """Page-count rounding, shared by every pages-for-N-tokens site."""
    return -(-a // b)


Spec = Tuple[Optional[str], ...]


class CacheSharding(NamedTuple):
    """A cache buffer's ``spec`` (the mesh axis of each dim, None:
    whole) on ``mesh`` (a ``MeshManager``): each rank holds the slice of
    its coordinates."""

    mesh: Any
    spec: Spec

    def local_shape(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        out = []
        for size, axis in zip(shape, self.spec):
            n = 1 if axis is None else self.mesh.axis_size(axis)
            if size % n:
                raise ValueError(
                    f"cache dim of size {size} does not split over {axis}="
                    f"{n}")
            out.append(size // n)
        return tuple(out)


def kv_cache_specs(*, tp_axis: Optional[str] = "tp",
                   batch_axis: Optional[str] = None) -> KVCache:
    """The axis of each dim of the dense pair ``[L, B, Hkv, S_max, D]``:
    KV heads over ``tp_axis`` (the column-parallel k/v projections' split,
    so the decode never re-shards), slots over ``batch_axis``; layer,
    sequence and head_dim whole (the reference's ``kv_cache_specs``)."""
    spec = (None, batch_axis, tp_axis, None, None)
    return KVCache(k=spec, v=spec)


def kv_cache_shardings(mesh, *, tp_axis: Optional[str] = "tp",
                       batch_axis: Optional[str] = None) -> KVCache:
    """``kv_cache_specs`` on ``mesh``."""
    specs = kv_cache_specs(tp_axis=tp_axis, batch_axis=batch_axis)
    return KVCache(k=CacheSharding(mesh, specs.k),
                   v=CacheSharding(mesh, specs.v))


def paged_kv_cache_specs(*, tp_axis: Optional[str] = "tp") -> PagedKVCache:
    """The axis of each dim of the pools ``[L, n_pages, Hkv, page_size,
    D]``: KV heads over ``tp_axis``; the page axis whole (any page must be
    reachable from any slot's table)."""
    spec = (None, None, tp_axis, None, None)
    return PagedKVCache(k=spec, v=spec)


def paged_kv_cache_shardings(mesh, *, tp_axis: Optional[str] = "tp"
                             ) -> PagedKVCache:
    """``paged_kv_cache_specs`` on ``mesh``."""
    specs = paged_kv_cache_specs(tp_axis=tp_axis)
    return PagedKVCache(k=CacheSharding(mesh, specs.k),
                        v=CacheSharding(mesh, specs.v))


def _local(shape: Tuple[int, ...], sharding) -> Tuple[int, ...]:
    """The rank's shape of a buffer (a ``CacheSharding`` or a pair of
    them; None: whole)."""
    if sharding is None:
        return shape
    if not isinstance(sharding, CacheSharding):
        sharding = sharding[0]
    return sharding.local_shape(shape)


def paged_kv_cache_shape(cfg, num_pages: int, page_size: int
                         ) -> Tuple[int, ...]:
    """[L, n_pages, Hkv, page_size, D] (page 0 is the reserved TRASH page
    — size the pool with it)."""
    l, _, h, _, d = kv_cache_shape(cfg, 1, 1)
    return (l, num_pages, h, page_size, d)


def kv_cache_bytes(
    cfg,
    batch: int,
    max_seq: int,
    dtype: Optional[torch.dtype] = None,
    *,
    layout: str = "dense",
    page_size: Optional[int] = None,
    num_pages: Optional[int] = None,
    sharding: Any = None,
) -> int:
    """Total cache footprint (both buffers) a rank holds. ``dense`` is the
    per-slot ``[L, B, Hkv, S_max, D]`` pair; ``paged`` is the pool pair —
    pass ``page_size`` and ``num_pages`` (None sizes the dense-equivalent
    pool ``batch * ceil(max_seq / page_size)`` + trash). ``sharding``
    (the layout's ``*_shardings``): the rank's shard; None: all of it."""
    if layout == "paged":
        if not page_size or page_size < 1:
            raise ValueError(
                f"paged layout needs page_size >= 1, got {page_size}")
        if num_pages is None:
            num_pages = batch * ceil_div(max_seq, page_size) + 1
        shape = paged_kv_cache_shape(cfg, num_pages, page_size)
    elif layout == "dense":
        shape = kv_cache_shape(cfg, batch, max_seq)
    else:
        raise ValueError(f"unknown cache layout {layout!r}")
    dt = dtype or getattr(cfg, "dtype", torch.bfloat16)
    n = 1
    for d in _local(shape, sharding):
        n *= d
    return 2 * n * dt.itemsize


def init_kv_cache(cfg, batch: int, max_seq: int, *,
                  dtype: Optional[torch.dtype] = None,
                  device: DeviceLike = None,
                  sharding: Optional[KVCache] = None) -> KVCache:
    """Zeroed dense cache in the model's compute dtype; with ``sharding``
    (``kv_cache_shardings``) only this rank's shard is allocated."""
    shape = kv_cache_shape(cfg, batch, max_seq)
    dt = dtype or getattr(cfg, "dtype", torch.bfloat16)
    dev = resolve_device(device)
    sk, sv = sharding if sharding is not None else (None, None)
    return KVCache(k=torch.zeros(_local(shape, sk), dtype=dt, device=dev),
                   v=torch.zeros(_local(shape, sv), dtype=dt, device=dev))


def init_paged_kv_cache(cfg, num_pages: int, page_size: int, *,
                        dtype: Optional[torch.dtype] = None,
                        device: DeviceLike = None,
                        sharding: Optional[PagedKVCache] = None
                        ) -> PagedKVCache:
    """Zeroed page pool in the model's compute dtype; with ``sharding``
    (``paged_kv_cache_shardings``) only this rank's KV heads."""
    shape = paged_kv_cache_shape(cfg, num_pages, page_size)
    dt = dtype or getattr(cfg, "dtype", torch.bfloat16)
    dev = resolve_device(device)
    sk, sv = sharding if sharding is not None else (None, None)
    return PagedKVCache(
        k=torch.zeros(_local(shape, sk), dtype=dt, device=dev),
        v=torch.zeros(_local(shape, sv), dtype=dt, device=dev))


def init_mla_cache(attn_cfg, batch: int, max_seq: int, *,
                   dtype: Optional[torch.dtype] = None,
                   device: DeviceLike = None) -> MLACache:
    """Zeroed latent cache of an ``AttentionConfig`` with MLA ranks, on
    ``device`` (None: the CUDA card)."""
    from scaletorch_tpu_torch.models.attention import MultiHeadLatentAttention

    return MLACache(latent=MultiHeadLatentAttention(attn_cfg).init_cache(
        batch, max_seq, dtype, device=device))


class PageAllocator:
    """Host-side page bookkeeping: free list + per-page refcounts.

    Page ids are indices into the device pool; page ``TRASH_PAGE`` (0)
    is reserved at construction and never handed out. A page is either
    FREE (on the free list, refcount 0) or ALLOCATED (refcount >= 1):
    ``alloc`` hands out pages at refcount 1, ``retain`` adds a
    reference (a prefix-sharing slot, the radix tree), ``release``
    drops one and returns the page to the free list at zero. Double
    release and foreign retain raise — the conservation invariant
    (free + allocated == capacity, every allocated page's refcount >= 1)
    is property-tested across randomized admit/retire/quarantine
    schedules.
    """

    def __init__(self, num_pages: int,
                 reserved: Tuple[int, ...] = (TRASH_PAGE,)) -> None:
        if num_pages < len(reserved) + 1:
            raise ValueError(
                f"page pool needs at least {len(reserved) + 1} pages "
                f"({len(reserved)} reserved), got {num_pages}"
            )
        self.num_pages = num_pages
        self.reserved = tuple(reserved)
        self._free: deque[int] = deque(
            p for p in range(num_pages) if p not in reserved)
        self._ref: Dict[int, int] = {}

    @property
    def capacity(self) -> int:
        """Allocatable pages (pool minus reserved)."""
        return self.num_pages - len(self.reserved)

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return len(self._ref)

    def refcount(self, page: int) -> int:
        """0 for free pages."""
        return self._ref.get(page, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` fresh pages at refcount 1, or None (allocation is
        all-or-nothing — a partially admitted request would leak)."""
        if n < 0:
            raise ValueError(f"alloc needs n >= 0, got {n}")
        if n > len(self._free):
            return None
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def retain(self, page: int) -> None:
        if page not in self._ref:
            raise ValueError(f"retain of unallocated page {page}")
        self._ref[page] += 1

    def release(self, page: int) -> None:
        count = self._ref.get(page)
        if count is None:
            raise ValueError(f"double free of page {page}")
        if count == 1:
            del self._ref[page]
            self._free.append(page)
        else:
            self._ref[page] = count - 1

    def check_conservation(self) -> None:
        """Raise unless free + allocated == capacity and every allocated
        page holds a positive refcount (the property tests' oracle)."""
        if len(self._free) + len(self._ref) != self.capacity:
            raise AssertionError(
                f"page leak: {len(self._free)} free + {len(self._ref)} "
                f"allocated != capacity {self.capacity}"
            )
        bad = [p for p, c in self._ref.items() if c < 1]
        if bad:
            raise AssertionError(f"non-positive refcounts: {bad}")
        overlap = set(self._free) & set(self._ref)
        if overlap:
            raise AssertionError(f"pages both free and allocated: {overlap}")


class _RadixNode:
    __slots__ = ("children", "page", "last_used")

    def __init__(self, page: int = TRASH_PAGE) -> None:
        self.children: Dict[Tuple[int, ...], "_RadixNode"] = {}
        self.page = page
        self.last_used = 0


class RadixPrefixCache:
    """Page-granular radix tree over token prefixes.

    Each edge is one full ``page_size`` token chunk; a node owns the pool
    page holding that chunk's K/V. Prefix sharing is copy-on-write *at
    the page boundary*: only FULLY-FROZEN prompt pages (every position
    written at prefill, never written again) are ever registered, so a
    shared page is immutable by construction — a partially-filled
    boundary page is re-prefilled into the new request's own page
    instead of being split.

    The tree holds ONE allocator reference per registered page
    (``retain`` at insert); slots sharing the page add their own. A node
    is evictable only when no slot references its page (allocator
    refcount back down to the tree's single reference) — eviction is
    LRU over leaves, releasing the tree's reference so the page returns
    to the free list at refcount 0.
    """

    def __init__(self, page_size: int,
                 retain: Callable[[int], None],
                 release: Callable[[int], None],
                 refcount: Callable[[int], int]) -> None:
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self._retain = retain
        self._release = release
        self._refcount = refcount
        self.root = _RadixNode()
        self._clock = 0

    def _chunks(self, tokens) -> List[Tuple[int, ...]]:
        p = self.page_size
        return [tuple(tokens[i:i + p])
                for i in range(0, (len(tokens) // p) * p, p)]

    def __len__(self) -> int:
        count = 0
        stack = [self.root]
        while stack:
            node = stack.pop()
            count += len(node.children)
            stack.extend(node.children.values())
        return count

    def match(self, tokens) -> Tuple[int, List[int]]:
        """Longest page-aligned cached prefix of ``tokens``:
        (matched token count — a multiple of page_size — and the page
        ids, root-first). Touches the matched path's LRU clocks. The
        caller must ``retain`` every returned page before anything else
        can evict."""
        self._clock += 1
        node = self.root
        pages: List[int] = []
        for chunk in self._chunks(tokens):
            child = node.children.get(chunk)
            if child is None:
                break
            child.last_used = self._clock
            pages.append(child.page)
            node = child
        return len(pages) * self.page_size, pages

    def insert(self, tokens, pages: List[int]) -> int:
        """Register ``tokens`` (length a multiple of page_size) held in
        ``pages`` (one per chunk, root-first). Chunks already present
        keep their existing page (first writer wins — concurrent
        admissions of the same prompt each computed identical K/V, the
        duplicate copy stays private to its slot); new nodes take one
        allocator reference on their page. Returns the number of new
        nodes."""
        chunks = self._chunks(tokens)
        if len(chunks) != len(pages) or len(tokens) % self.page_size:
            raise ValueError(
                f"insert needs page-aligned tokens and one page per "
                f"chunk: {len(tokens)} tokens, {len(pages)} pages"
            )
        self._clock += 1
        node = self.root
        created = 0
        for chunk, page in zip(chunks, pages):
            child = node.children.get(chunk)
            if child is None:
                child = _RadixNode(page=page)
                node.children[chunk] = child
                self._retain(page)
                created += 1
            child.last_used = self._clock
            node = child
        return created

    def chains(self) -> List[Tuple[List[int], List[int]]]:
        """Snapshot every root-to-leaf path as ``(tokens, pages)`` —
        the donor half of warm rejoin. Leaf chains subsume their
        ancestors (the recipient re-inserts prefixes for free), so the
        list is the minimal set that reconstructs the tree. Pure read:
        no LRU touch, no refcount change — the caller decides which
        pages to retain for how long."""
        out: List[Tuple[List[int], List[int]]] = []
        stack: List[Tuple[_RadixNode, List[int], List[int]]] = [
            (self.root, [], [])]
        while stack:
            node, tokens, pages = stack.pop()
            if not node.children and pages:
                out.append((tokens, pages))
                continue
            for chunk, child in node.children.items():
                stack.append((child, tokens + list(chunk),
                              pages + [child.page]))
        return out

    def registered_pages(self) -> List[int]:
        """Every page the tree currently holds a reference on (the
        frozen set a donor may stream; anything else is mutable slot
        state and must never leave the process)."""
        pages: List[int] = []
        stack = [self.root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                pages.append(child.page)
                stack.append(child)
        return pages

    def evict(self, n_pages: int) -> int:
        """Free up to ``n_pages`` pages by pruning LRU leaves whose page
        no live slot references (allocator refcount == 1, the tree's
        own). Returns how many were released. Inner nodes become
        evictable once their children go — the loop re-scans until the
        target is met or nothing more can move."""
        freed = 0
        while freed < n_pages:
            leaves: List[Tuple[int, _RadixNode, Tuple[int, ...],
                               _RadixNode]] = []
            stack = [self.root]
            while stack:
                node = stack.pop()
                for chunk, child in node.children.items():
                    if child.children:
                        stack.append(child)
                    elif self._refcount(child.page) == 1:
                        leaves.append((child.last_used, id(child), chunk,
                                       node))
                    # leaves with live slot references are pinned
            if not leaves:
                break
            leaves.sort()
            for _, _, chunk, parent in leaves:
                child = parent.children.pop(chunk)
                self._release(child.page)
                freed += 1
                if freed >= n_pages:
                    break
        return freed


class PagedKVIO:
    """Paged-cache adapter for the model's cached forward: the dense path
    writes with ``write_kv_cache`` and attends with
    ``cached_sdpa_attention``; with a ``kv_io`` the forward writes and
    attends through this object against the page pool. ``seq_limit``
    crops the gather path's view to the engine's ``max_seq`` (the
    paged == dense bit-identity contract); ``kernel`` goes to
    ``paged_attention``'s dispatcher (None = the CUDA kernel for
    single-token decode on the card, the gather path elsewhere).

    One adapter serves one forward call: every layer writes at the same
    positions, so the write targets are computed once and reused."""

    def __init__(self, page_tables: Tensor, page_size: int, *,
                 seq_limit: Optional[int] = None,
                 kernel: Optional[bool] = None) -> None:
        self.page_tables = page_tables
        self.page_size = page_size
        self.seq_limit = seq_limit
        self.kernel = kernel
        self._targets_for: Optional[Tuple[Tensor, Optional[Tensor]]] = None
        self._targets: Optional[Tuple[Tensor, Tensor]] = None

    def write(self, pool: Tensor, new: Tensor, positions: Tensor,
              write_mask: Optional[Tensor]) -> Tensor:
        key = self._targets_for
        if key is None or key[0] is not positions or key[1] is not write_mask:
            self._targets = paged_write_targets(
                positions, self.page_tables, self.page_size, write_mask)
            self._targets_for = (positions, write_mask)
        return paged_write_kv(pool, new, positions, self.page_tables,
                              self.page_size, write_mask,
                              targets=self._targets)

    def attend(self, q: Tensor, pool_k: Tensor, pool_v: Tensor,
               q_positions: Tensor) -> Tensor:
        return paged_attention(
            q, pool_k, pool_v, self.page_tables, q_positions,
            page_size=self.page_size, seq_limit=self.seq_limit,
            kernel=self.kernel,
        )
