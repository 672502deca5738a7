"""PyTorch port, FSDP (``parallel/fsdp.py``) in 2 and 4 gloo processes
against the JAX package's ``parallel/fsdp.py`` and its replicated step.

  * ``fsdp_param_specs`` picks the reference's dim on its ``TestSpecs``
    tree and on the model's tree, for 2, 4 and 8 ranks.
  * The reference's ``TestFsdpTraining`` cases, on its model (vocab 256,
    hidden 64, 2 layers) and batches (8 rows of 16 tokens): 3 AdamW
    steps of ``setup_fsdp``'s step at 2 and 4 ranks (and at 2 ranks
    with gradient checkpointing, each layer gathered again when it is
    recomputed) against the reference's replicated ``make_train_step``
    on one device, losses within rtol 2e-4 (the reference's own limit);
    a rank stores 1/N of each leaf of at least 4096 elements and of its
    AdamW state, and the shards gathered are the parameters; bf16
    parameters train a step, finite, and stay bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scaletorch_tpu.config import ScaleTorchTPUArguments as JArgs
from scaletorch_tpu.models.llama import LlamaConfig as JLlamaConfig
from scaletorch_tpu.models.llama import forward as jforward
from scaletorch_tpu.models.llama import init_params as jinit
from scaletorch_tpu.parallel.fsdp import fsdp_param_specs as jspecs
from scaletorch_tpu.trainer.optimizer import create_optimizer as jcreate
from scaletorch_tpu.trainer.train_step import make_train_step as jstep
from scaletorch_tpu_torch.models.convert import flatten_params
from scaletorch_tpu_torch.parallel import fsdp as tfsdp
from tests.torch_dist_harness import run_ranks

ARCH = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            head_dim=16, max_position_embeddings=64)
TRAIN_CFG = dict(total_train_steps=10, learning_rate=1e-3, warmup_steps=0)
ROWS, SEQ, STEPS = 8, 16, 3
RUNS = {2: [dict(dtype="float32", steps=STEPS),
            dict(dtype="float32", steps=STEPS, gc=True),
            dict(dtype="bfloat16", steps=1)],
        4: [dict(dtype="float32", steps=STEPS)]}


def batch(seed):
    """The reference test's ``_batch(seed=...)``, with the positions the
    port's step takes."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, ARCH["vocab_size"], (1, ROWS, SEQ + 1))
    return {"input_ids": ids[:, :, :-1].astype(np.int32),
            "target_ids": ids[:, :, 1:].astype(np.int32),
            "position_ids": np.arange(SEQ, dtype=np.int32)[None]}


def reference_losses(params):
    cfg = JLlamaConfig(**ARCH, dtype=jnp.float32)
    tx = jcreate(JArgs(**TRAIN_CFG), include_clip=False)[0]
    step = jstep(jforward, cfg, tx, donate=False)
    p = jax.tree.map(jnp.asarray, params)
    o = tx.init(p)
    losses = []
    for i in range(STEPS):
        b = batch(i)
        p, o, m = step(p, o, {k: jnp.asarray(b[k])
                              for k in ("input_ids", "target_ids")})
        losses.append(float(m["loss"]))
    return losses


@pytest.fixture(scope="module")
def setup():
    cfg = JLlamaConfig(**ARCH, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jinit(jax.random.key(0), cfg))
    return params, reference_losses(params)


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    params, _ = setup
    payload = {"arch": ARCH, "params": params, "train_cfg": TRAIN_CFG,
               "batches": [batch(i) for i in range(STEPS)]}
    return {world: run_ranks(tmp_path_factory.mktemp(f"fsdp{world}"), world,
                             "fsdp", {**payload, "runs": runs},
                             timeout=150.0)
            for world, runs in RUNS.items()}


def test_specs_are_the_references():
    params = {"w": np.zeros((2, 64, 128)), "emb": np.zeros((250, 64)),
              "norm": np.zeros((7,))}
    got = tfsdp.fsdp_param_specs(params, 8)
    want = jspecs({k: jnp.zeros(v.shape) for k, v in params.items()}, 8)
    assert got == {"w": 2, "emb": 1, "norm": None}
    for k, spec in want.items():
        assert got[k] == (spec.index("fsdp") if "fsdp" in tuple(spec)
                          else None), k


@pytest.mark.parametrize("n", [2, 4, 8])
def test_specs_match_on_the_model_tree(setup, n):
    params, _ = setup
    got = flatten_params(tfsdp.fsdp_param_specs(params, n))
    want = flatten_params(jax.tree.map(
        lambda s: s.index("fsdp") if "fsdp" in tuple(s) else None,
        jspecs(jax.tree.map(jnp.asarray, params), n),
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)))
    assert got == want


@pytest.mark.parametrize("world,run", [(2, 0), (2, 1), (4, 0)])
def test_matches_replicated_and_shards_storage(setup, ranks, world, run):
    params, want = setup
    outs = [r[run] for r in ranks[world]]
    for out in outs:
        np.testing.assert_allclose(out["losses"], want, rtol=2e-4)
    assert all(o["losses"] == outs[0]["losses"] for o in outs)
    full = flatten_params(params)
    specs = flatten_params(tfsdp.fsdp_param_specs(params, world))
    for name, leaf in full.items():
        if leaf.size >= 4096:
            assert specs[name] is not None, name
            assert outs[0]["numel"][name] * world == leaf.size, name
            for moment in ("mu", "nu"):
                assert (outs[0]["state_numel"][f"{moment}.{name}"] * world
                        == leaf.size), (moment, name)
    # the shards are the parameters' slices: concatenated, a full tree
    for name, dim in specs.items():
        shards = [flatten_params(o["params"])[name] for o in outs]
        whole = (shards[0] if dim is None
                 else np.concatenate(shards, axis=dim))
        assert whole.shape == full[name].shape, name
        if dim is None:
            for s in shards[1:]:
                assert np.array_equal(s, shards[0]), name


def test_bf16_params_supported(ranks):
    for r in ranks[2]:
        out = r[2]
        assert np.isfinite(out["losses"][0])
        assert out["dtypes"] == ["torch.bfloat16"]
