"""PyTorch port, Ulysses context parallelism (``ops/ulysses.py``) in 4
gloo processes against the JAX package's ``ulysses_attention`` under
``shard_map`` (``impl='xla'``), and the CP backend choice
(``parallel/cp_select.py``) against the reference's on the same inputs.

Ulysses at cp 2 (dp 2 x cp 2) and cp 4, GQA (8 query heads on 4 kv
heads): output and the gradients of q, k, v for a fixed cotangent, each
rank's sequence shard against the reference's. The port's inner
attention is K1-K3's plain versions here. Tolerance, fp32: atol 1e-5
(two all-to-alls move values exactly; the attention sums in another
order).

``resolve_cp_backend``: every decision and reason equal over a grid of
cp, heads, sequence lengths, host hops, requests and layouts; the port
counts the ring's host hops from each rank's host name.
"""

import itertools

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from scaletorch_tpu.ops.ulysses import ulysses_attention as julysses
from scaletorch_tpu.parallel import cp_select as jsel
from scaletorch_tpu.parallel.mesh import MeshManager as JMesh
from scaletorch_tpu_torch.parallel import cp_select as tsel
from scaletorch_tpu_torch.parallel.mesh import MeshManager
from tests.torch_dist_harness import run_ranks

B, HQ, HKV, S, D = 2, 8, 4, 32, 16
QKV = P(None, None, "cp", None)
RUNS = [dict(mesh={"cp": 4}, backend="ulysses"),
        dict(mesh={"dp": 2, "cp": 2}, backend="ulysses")]


def inputs(seed=1):
    rng = np.random.default_rng(seed)
    shape = {"q": (B, HQ, S, D), "k": (B, HKV, S, D), "v": (B, HKV, S, D),
             "do": (B, HQ, S, D)}
    return {n: rng.standard_normal(s).astype(np.float32)
            for n, s in shape.items()}


def reference(x, cp):
    mm = JMesh(cp=cp, devices=jax.devices()[:cp])

    def body(q, k, v, do):
        def loss(q, k, v):
            o = julysses(q, k, v, causal=True, axis="cp", impl="xla")
            return (o * do).sum(), o

        (_, o), g = jax.value_and_grad(loss, (0, 1, 2), has_aux=True)(
            q, k, v)
        return (o, *g)

    f = jax.jit(jax.shard_map(body, mesh=mm.mesh, in_specs=(QKV,) * 4,
                              out_specs=(QKV,) * 4))
    return [np.asarray(t) for t in f(x["q"], x["k"], x["v"], x["do"])]


def test_ulysses_matches_the_reference(tmp_path):
    x = inputs()
    res = run_ranks(tmp_path, 4, "cp_attention", {**x, "runs": RUNS})
    for i, run in enumerate(RUNS):
        cp = run["mesh"]["cp"]
        want = reference(x, cp)
        w = S // cp
        for rank, out in enumerate(r[i] for r in res):
            c = rank % cp
            for name, full in zip(("o", "dq", "dk", "dv"), want):
                np.testing.assert_allclose(
                    out[name], full[:, :, c * w:(c + 1) * w], atol=1e-5,
                    err_msg=f"{run} {name}")


def test_ulysses_refuses_heads_cp_does_not_divide():
    import torch

    from scaletorch_tpu_torch.ops.ulysses import ulysses_attention
    from scaletorch_tpu_torch.parallel.mesh import using_mesh_manager

    q = torch.zeros(1, 6, 4, 8)
    with using_mesh_manager(MeshManager(cp=4)):
        with pytest.raises(ValueError, match="divide both"):
            ulysses_attention(q, q[:, :2], q[:, :2])


GRID = list(itertools.product(
    ["auto", "ring", "ulysses"], [1, 2, 4, 8], [(16, 8), (16, 16), (32, 4),
                                                (12, None)],
    [8192, 65536], [0, 2], ["zigzag", "contiguous"]))


@pytest.mark.parametrize("requested", ["auto", "ring", "ulysses"])
def test_resolve_cp_backend_matches_the_reference(requested):
    for req, cp, (hq, hkv), seq, hops, layout in GRID:
        if req != requested:
            continue
        kw = dict(cp=cp, num_q_heads=hq, num_kv_heads=hkv, seq_len=seq,
                  cross_host_hops=hops, layout=layout)
        assert (tsel.resolve_cp_backend(req, None, **kw).as_dict()
                == jsel.resolve_cp_backend(req, None, **kw).as_dict())
    for cp, seq in itertools.product([2, 4, 8], [4096, 8192]):
        assert tsel.ring_wire_bytes(cp, seq, 8, 128) == jsel.ring_wire_bytes(
            cp, seq, 8, 128)
        assert (tsel.ulysses_wire_bytes(cp, seq, 16, 8, 128)
                == jsel.ulysses_wire_bytes(cp, seq, 16, 8, 128))


def test_host_hops_come_from_each_ranks_host():
    mm = MeshManager(dp=2, cp=4)
    one_host = ["h0"] * 8
    assert tsel.cp_cross_host_hops(mm, one_host) == 0
    # ranks 0-3 (dp 0's ring) on h0, 4-7 on h1: the rings stay on a host
    assert tsel.cp_cross_host_hops(mm, ["h0"] * 4 + ["h1"] * 4) == 0
    # each cp ring split over two hosts: two crossings around the ring
    split = ["h0", "h0", "h1", "h1"] * 2
    assert tsel.cp_cross_host_hops(mm, split) == 2
    assert tsel.cp_cross_host_hops(MeshManager(dp=8), split) == 0
    kw = dict(cp=4, num_q_heads=16, num_kv_heads=8, seq_len=8192)
    assert tsel.resolve_cp_backend("auto", mm, hosts=split,
                                   **kw).backend == "ulysses"
    assert tsel.resolve_cp_backend(
        "auto", mm, hosts=one_host, **kw).as_dict() == (
        jsel.resolve_cp_backend("auto", None, cross_host_hops=0,
                                **kw).as_dict())
