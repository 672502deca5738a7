"""PyTorch port, the int8 gradient all-reduce (``ops/quantized_collectives.
py``) against the JAX package's ``quantized_collectives``.

``quantize_blockwise`` / ``dequantize_blockwise`` bit for bit on one
process against the compiled reference (all-zero blocks, ties at .5, the
clip); ``quantized_pmean`` and
``quantized_pmean_tree`` in 2 and 4 gloo processes bit for bit against the
reference op under ``shard_map`` on as many virtual CPU devices, on the
same per-rank arrays (sizes that pad, a zero rank, mixed magnitudes), and
two calls equal bit for bit. The reference's int8 *step* is not the
yardstick (its step tests fail on this jax, ROADMAP Queue 3): the port's
int8 step is held to its own fp32 step in ``tests/test_torch_pp_ep_
trainer.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from scaletorch_tpu.ops import quantized_collectives as jq
from scaletorch_tpu_torch.ops import quantized_collectives as tq
from tests.torch_dist_harness import run_ranks

BLOCK = 32


def arrays(world: int) -> dict:
    rng = np.random.default_rng(world)
    per = {
        "odd_len": [rng.standard_normal(1000).astype(np.float32)
                    for _ in range(world)],
        "matrix": [rng.standard_normal((17, 24)).astype(np.float32) * 10 ** r
                   for r in range(world)],
        "zero_rank": [np.zeros(300, np.float32) if r == 0 else
                      rng.standard_normal(300).astype(np.float32)
                      for r in range(world)],
    }
    tree = [[rng.standard_normal(shape).astype(np.float32) * scale
             for _ in range(world)]
            for shape, scale in (((5, 7), 1e-4), ((300,), 1.0),
                                 ((3, 3, 3), 1e-1))]
    return {"arrays": per, "tree": tree, "block": BLOCK}


def test_quantize_roundtrip_bit_for_bit():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(8 * BLOCK).astype(np.float32)
    x[:BLOCK] = 0.0                      # an all-zero block: scale 1.0
    x[BLOCK:2 * BLOCK] = np.linspace(-127, 127, BLOCK) / 127 * 3.5
    x[2 * BLOCK] = 0.5 * (3.5 / 127)     # ties round to even
    # the reference as it runs in a step: compiled (the scale is absmax
    # times 1/127, the constant's reciprocal)
    qj, sj = jax.jit(lambda v: jq.quantize_blockwise(v, BLOCK))(
        jnp.asarray(x))
    qt, st = tq.quantize_blockwise(torch.from_numpy(x), BLOCK)
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert st[0].item() == 1.0
    np.testing.assert_array_equal(
        tq.dequantize_blockwise(qt, st).numpy(),
        np.asarray(jq.dequantize_blockwise(qj, sj)))
    with pytest.raises(ValueError, match="block_size"):
        tq.quantize_blockwise(torch.zeros(BLOCK + 1), BLOCK)


def reference(world: int, payload: dict) -> dict:
    mesh = Mesh(np.array(jax.devices()[:world]), ("dp",))

    def over_ranks(fn, per_rank):
        stacked = jnp.stack([jnp.asarray(a) for a in per_rank])
        f = jax.shard_map(lambda x: fn(x[0])[None], mesh=mesh,
                          in_specs=P("dp"), out_specs=P("dp"))
        return np.asarray(jax.jit(f)(stacked))

    out = {name: over_ranks(lambda x: jq.quantized_pmean(
        x, "dp", block_size=BLOCK), per)
        for name, per in payload["arrays"].items()}
    leaves = [jnp.stack([jnp.asarray(a) for a in per])
              for per in payload["tree"]]
    f = jax.shard_map(
        lambda *xs: [y[None] for y in jq.quantized_pmean_tree(
            [x[0] for x in xs], "dp", dtype="int8", block_size=BLOCK)],
        mesh=mesh, in_specs=P("dp"), out_specs=P("dp"))
    out["tree"] = [np.asarray(y) for y in jax.jit(f)(*leaves)]
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_quantized_pmean_bit_for_bit_against_the_reference(tmp_path, world):
    payload = arrays(world)
    ranks = run_ranks(tmp_path, world, "quantized", payload)
    want = reference(world, payload)
    for rank, out in enumerate(ranks):
        for name in payload["arrays"]:
            got, repeat_equal = out[name]
            assert repeat_equal, name
            np.testing.assert_array_equal(got, want[name][rank],
                                          err_msg=name)
        for got, ref in zip(out["tree"], want["tree"]):
            np.testing.assert_array_equal(got, ref[rank])
    # the small-magnitude leaf keeps its own absmax block
    assert np.abs(ranks[0]["tree"][0]).max() > 0


def test_wire_bytes_and_the_fp32_and_bf16_means():
    n = 1 << 20
    fp32 = tq.wire_bytes(n, 4, "fp32")
    int8 = tq.wire_bytes(n, 4, "int8", 256)
    assert fp32 == 2 * n * 0.75 * 4
    assert fp32 / int8 == pytest.approx(4 / (1 + 4 / 256))
    assert tq.wire_bytes(n, 1, "int8") == 0.0
    x = torch.randn(10)
    assert torch.equal(tq.reduced_pmean(x, None, "fp32"), x)
    assert torch.equal(tq.reduced_pmean(x, None, "bf16"),
                       x.to(torch.bfloat16).float())
    with pytest.raises(ValueError, match="grad_allreduce_dtype"):
        tq.reduced_pmean(x, None, "fp8")
