"""Topology-aware CP backend selection (counterpart of
scaletorch_tpu/parallel/cp_select.py; its arithmetic is copied, the port
imports nothing of the JAX package).

``resolve_cp_backend('auto', ...)`` picks the ring (zigzag by default)
or Ulysses from what the choice depends on:

  * topology: does the cp ring cross a host boundary? Counted from the
    host of each rank of the torch mesh (``cp_cross_host_hops``); every
    rank on one host gives 0 hops;
  * model geometry: Ulysses needs cp to divide both head counts, and its
    wire bytes scale with (Hq + Hkv)/cp where the ring's scale with
    Hkv·(cp-1)/cp (un-expanded GQA K/V);
  * sequence length: Ulysses ranks run full-sequence attention over
    their heads, so an extreme S prefers the ring's (S/cp)² blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

# Ring hops overlap with per-hop attention compute; ulysses' all-to-alls
# are exposed on the critical path. On ICI we therefore keep the ring
# unless ulysses moves at least this factor fewer bytes (the byte model
# alone would flip to ulysses at ~1x, which wall-clock does not support —
# the same compiled-cost-vs-silicon caveat as resolve_moe_dispatch).
ICI_ULYSSES_BYTE_MARGIN = 2.0

# Past this sequence length ulysses' full-S rows (and its S x S/heads
# score tiles on non-flash paths) dominate the memory budget; the ring's
# (S/cp)^2 locality wins regardless of wire bytes.
EXTREME_SEQ_THRESHOLD = 32768


@dataclasses.dataclass(frozen=True)
class CPChoice:
    backend: str  # 'ring' | 'ulysses'
    layout: str   # 'zigzag' | 'contiguous' (ring's causal balance; ulysses
                  # owns whole heads and is balanced in contiguous layout)
    reason: str

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def ring_wire_bytes(cp: int, seq: int, num_kv_heads: int, head_dim: int,
                    bytes_per_el: int = 2) -> float:
    """Per-device forward wire bytes of ring attention: K and V shards
    (UN-expanded GQA heads — ops/ring_attention.py) circulate cp-1 hops."""
    return 2.0 * (cp - 1) * (seq / cp) * num_kv_heads * head_dim * bytes_per_el


def ulysses_wire_bytes(cp: int, seq: int, num_q_heads: int,
                       num_kv_heads: int, head_dim: int,
                       bytes_per_el: int = 2) -> float:
    """Per-device forward wire bytes of ulysses: four tiled all-to-alls
    (q, k, v scatter + output gather), each moving (cp-1)/cp of its local
    [B, H, S/cp, D] array (ops/ulysses.py)."""
    per_el = (cp - 1) / cp * (seq / cp) * head_dim * bytes_per_el
    return per_el * (2 * num_q_heads + 2 * num_kv_heads)


def cp_cross_host_hops(mm, hosts: Sequence[str]) -> int:
    """How many host boundaries the cp ring crosses: the most, over every
    cp ring of the mesh ``mm``, of the host changes around it.
    ``hosts[r]`` is global rank r's host (``dist.all_gather_object`` of
    ``socket.gethostname()``). 0: the whole ring stays on one host."""
    if mm.cp == 1:
        return 0
    worst = 0
    for ring in mm.axis_rank_sets(("cp",)):
        names = [hosts[r] for r in ring]
        hops = sum(1 for i in range(len(names))
                   if names[i] != names[(i + 1) % len(names)])
        worst = max(worst, hops)
    return worst


def resolve_cp_backend(
    requested: str,
    mm=None,
    *,
    cp: int,
    num_q_heads: int,
    num_kv_heads: Optional[int],
    seq_len: int,
    cross_host_hops: Optional[int] = None,
    hosts: Optional[Sequence[str]] = None,
    layout: str = "zigzag",
) -> CPChoice:
    """'auto' -> the CP attention backend the topology and geometry favor.

    ``mm`` and ``hosts`` (each global rank's host) supply the host-hop
    signal (``cp_cross_host_hops``); pass ``cross_host_hops`` directly
    instead for a mesh-free resolution. An explicit ``requested`` backend
    is always honored."""
    num_kv_heads = num_kv_heads or num_q_heads
    if requested != "auto":
        lay = layout if requested == "ring" else "contiguous"
        return CPChoice(requested, lay, "explicitly requested")
    if cp <= 1:
        return CPChoice("ring", layout, "cp=1: degenerate (no CP exchange)")
    if num_q_heads % cp or num_kv_heads % cp:
        return CPChoice(
            "ring", layout,
            f"ulysses needs cp ({cp}) to divide heads "
            f"(Hq={num_q_heads}, Hkv={num_kv_heads}); ring scales to any cp",
        )
    if cross_host_hops is None:
        cross_host_hops = (cp_cross_host_hops(mm, hosts)
                           if mm is not None and hosts is not None else 0)
    if cross_host_hops > 0:
        return CPChoice(
            "ulysses", "contiguous",
            f"cp ring crosses {cross_host_hops} host boundaries (DCN): "
            "2 fused all-to-alls beat cp-1 serialized DCN ring hops",
        )
    if seq_len > EXTREME_SEQ_THRESHOLD:
        return CPChoice(
            "ring", layout,
            f"extreme sequence ({seq_len} > {EXTREME_SEQ_THRESHOLD}): "
            "ring keeps (S/cp)^2 attention tiles; ulysses ranks would run "
            "full-sequence rows",
        )
    head_dim = 1  # ratio is head_dim-independent
    ratio = (
        ring_wire_bytes(cp, seq_len, num_kv_heads, head_dim)
        / max(ulysses_wire_bytes(cp, seq_len, num_q_heads, num_kv_heads,
                                 head_dim), 1e-9)
    )
    if ratio >= ICI_ULYSSES_BYTE_MARGIN:
        return CPChoice(
            "ulysses", "contiguous",
            f"head-heavy geometry: ring would move {ratio:.2f}x the wire "
            f"bytes (cp·Hkv/(Hq+Hkv) = {ratio:.2f} >= "
            f"{ICI_ULYSSES_BYTE_MARGIN})",
        )
    return CPChoice(
        "ring", layout,
        f"ICI ring with overlapped hops (ulysses byte advantage "
        f"{ratio:.2f}x < {ICI_ULYSSES_BYTE_MARGIN}x margin): the "
        "long-context default",
    )
