"""PyTorch port, ring attention (``ops/ring_attention.py``) in 4 gloo
processes against the JAX package's ``ring_attention`` under
``shard_map`` on the virtual CPU devices (``impl='xla'``).

Contiguous and zigzag layouts at cp 2 (a dp 2 x cp 2 mesh: both dp rows
run the same ring) and cp 4, GQA (4 query heads on 2 kv heads): the
output and the gradients of q, k and v for a fixed cotangent, each rank's
shard against the reference's shard (the zigzag inputs permuted into
stripe order on both sides). The port's blocks run the plain versions of
K1-K3 here (the kernels on the card); the reference its XLA softmax.

Tolerance, fp32: atol 1e-5 on the output and the gradients (the blocks'
sums and the LSE merges run in another order; the reference's own ring
tests hold it to SDPA at 2e-5).
"""

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from scaletorch_tpu.ops.ring_attention import ring_attention as jring
from scaletorch_tpu.parallel.mesh import MeshManager as JMesh
from scaletorch_tpu.parallel.zigzag import zigzag_order
from tests.torch_dist_harness import run_ranks

B, HQ, HKV, S, D = 2, 4, 2, 32, 16
QKV = P(None, None, "cp", None)
RUNS = [dict(mesh={"cp": 4}, backend="ring", layout="contiguous"),
        dict(mesh={"cp": 4}, backend="ring", layout="zigzag"),
        dict(mesh={"dp": 2, "cp": 2}, backend="ring", layout="contiguous"),
        dict(mesh={"dp": 2, "cp": 2}, backend="ring", layout="zigzag")]
ATOL = 1e-5


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    shape = {"q": (B, HQ, S, D), "k": (B, HKV, S, D), "v": (B, HKV, S, D),
             "do": (B, HQ, S, D)}
    return {n: rng.standard_normal(s).astype(np.float32)
            for n, s in shape.items()}


def reference(x, cp, layout):
    """(o, dq, dk, dv) of the JAX ring over cp devices, in the layout's
    token order."""
    if layout == "zigzag":
        order = zigzag_order(S, cp)
        x = {n: np.take(a, order, axis=2) for n, a in x.items()}
    mm = JMesh(cp=cp, devices=jax.devices()[:cp])

    def body(q, k, v, do):
        def loss(q, k, v):
            o = jring(q, k, v, "cp", True, None, "xla", False, layout)
            return (o * do).sum(), o

        (_, o), g = jax.value_and_grad(loss, (0, 1, 2), has_aux=True)(
            q, k, v)
        return (o, *g)

    f = jax.jit(jax.shard_map(body, mesh=mm.mesh, in_specs=(QKV,) * 4,
                              out_specs=(QKV,) * 4))
    return [np.asarray(t) for t in f(x["q"], x["k"], x["v"], x["do"])]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    x = inputs()
    return x, run_ranks(tmp_path_factory.mktemp("ring"), 4, "cp_attention",
                        {**x, "runs": RUNS})


@pytest.mark.parametrize("i", range(len(RUNS)),
                         ids=[f"cp{r['mesh']['cp']}-{r['layout']}"
                              for r in RUNS])
def test_ring_attention_matches_the_reference(ranks, i):
    x, res = ranks
    run = RUNS[i]
    cp = run["mesh"]["cp"]
    want = reference(x, cp, run["layout"])
    for rank, out in enumerate(r[i] for r in res):
        c = rank % cp  # tp 1, ep 1: cp is the fastest axis left
        w = S // cp
        for name, full in zip(("o", "dq", "dk", "dv"), want):
            np.testing.assert_allclose(out[name], full[:, :, c * w:(c + 1) * w],
                                       atol=ATOL, err_msg=f"{run} {name}")


def test_ring_layout_guards():
    import torch

    from scaletorch_tpu_torch.ops import ring_attention as tra
    from scaletorch_tpu_torch.parallel import mesh as tmesh

    q = torch.zeros(1, 2, 6, 8)
    k = torch.zeros(1, 1, 6, 8)
    with pytest.raises(NotImplementedError, match="causal-only"):
        tra.ring_attention(q, k, k, causal=False)
    with pytest.raises(ValueError, match="unknown cp layout"):
        tra.ring_attention(q, k, k, layout="stripes")
    with pytest.raises(ValueError, match="even local sequence"):
        tra.ring_attention(q[:, :, :5], k[:, :, :5], k[:, :, :5],
                           layout="zigzag")
    # one rank: the ring is the diagonal block alone, K1's plain version
    from scaletorch_tpu_torch.ops.flash import flash_attention

    with tmesh.using_mesh_manager(tmesh.MeshManager(cp=1)):
        q = torch.randn(1, 2, 6, 8, requires_grad=True)
        k = torch.randn(1, 1, 6, 8, requires_grad=True)
        got = tra.ring_attention(q, k, k, layout="zigzag")
        want = flash_attention(q, k, k, causal=True)
        assert torch.allclose(got, want, atol=1e-6)
        g1 = torch.autograd.grad(got.sum(), (q, k))
        g2 = torch.autograd.grad(want.sum(), (q, k))
        for a, b in zip(g1, g2):
            assert torch.allclose(a, b, atol=1e-6)
