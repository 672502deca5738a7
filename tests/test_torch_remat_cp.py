"""PyTorch port, selective remat under context parallelism: every remat
policy of ``models/llama.resolve_remat_policy`` with the cp backends
(``ops/ring_attention.py``, contiguous and zigzag, and ``ops/ulysses.py``)
at cp 2, in 2 gloo processes, against ``nothing_saveable`` at the same
layout and against the JAX package.

Each backend runs as one dispatcher op, so a policy keeps it (``save_attn``)
or recomputes it whole with its exchanges in order (the dots policies):

  * the loss and every gradient leaf of each policy equal
    ``nothing_saveable``'s at the same layout bit for bit, on every rank;
  * the loss and the gradients are within ``chip_smoke.TRAIN_PARITY``
    (|Δloss| <= 1e-4; each leaf within 1e-3 of its largest entry) of
    ``jax.value_and_grad`` of the JAX model on one device (a policy
    decides what is kept, not the result), and the loss and grad norm of
    the reference's ``make_spmd_train_step`` with the same backend,
    layout and policy on its cp-2 mesh are too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scaletorch_tpu.models import llama as jllama
from scaletorch_tpu.parallel.mesh import MeshManager as JMesh
from scaletorch_tpu.parallel.spmd import make_spmd_train_step, shard_params
from scaletorch_tpu.parallel.zigzag import zigzag_batch
from scaletorch_tpu.trainer.optimizer import create_optimizer as jcreate
from scaletorch_tpu_torch.config import ScaleTorchTPUArguments
from tests.test_torch_tensor_parallel import ARCH, CE_CHUNK, model_case
from tests.torch_dist_harness import run_ranks

TRAIN_PARITY = {"loss_abs": 1e-4, "grad_rel": 1e-3}
POLICIES = ("nothing_saveable", "dots_saveable",
            "dots_with_no_batch_dims_saveable", "save_attn")
LAYOUTS = {"ring_contiguous": dict(backend="ring", layout="contiguous"),
           "ring_zigzag": dict(backend="ring", layout="zigzag"),
           "ulysses": dict(backend="ulysses")}
CASES = [(lay, pol) for lay in LAYOUTS for pol in POLICIES]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    params, batch, loss, grads = model_case()
    runs = [dict(mesh={"cp": 2}, gc=True, remat_policy=pol, **LAYOUTS[lay])
            for lay, pol in CASES]
    res = run_ranks(tmp_path_factory.mktemp("remat_cp"), 2, "tp_model",
                    {"arch": ARCH, "params": params, "batch": batch,
                     "ce_chunk": CE_CHUNK, "runs": runs}, timeout=180.0)
    return params, batch, loss, grads, {
        case: [r[i] for r in res] for i, case in enumerate(CASES)}


@pytest.mark.parametrize("layout,policy", CASES)
def test_policy_is_nothing_saveable_bit_for_bit(results, layout, policy):
    *_, res = results
    for got, base in zip(res[(layout, policy)],
                         res[(layout, "nothing_saveable")]):
        assert got["loss"] == base["loss"]
        assert set(got["grads"]) == set(base["grads"])
        for name, g in base["grads"].items():
            assert np.array_equal(got["grads"][name], g), name


def reference_metrics(params, batch, layout, policy):
    """Loss and grad norm of the reference's mesh step (one AdamW step)
    with the backend, layout and policy at cp 2."""
    jcfg = jllama.LlamaConfig(**ARCH, dtype=jnp.float32)
    mm = JMesh(cp=2, devices=jax.devices()[:2])
    cfg = ScaleTorchTPUArguments(learning_rate=1e-3, total_train_steps=1,
                                 warmup_steps=0)
    tx, _ = jcreate(cfg, include_clip=False)
    kw = LAYOUTS[layout]
    step, p_specs, o_specs = make_spmd_train_step(
        mm, jllama.forward, jcfg, tx, params,
        attention_backend=kw["backend"],
        cp_layout=kw.get("layout", "contiguous"),
        gradient_checkpointing=True, remat_policy=policy, donate=False)
    host = zigzag_batch(batch, 2) if kw.get("layout") == "zigzag" else batch
    _, _, m = step(shard_params(mm, params, p_specs),
                   shard_params(mm, tx.init(params), o_specs), host)
    return float(m["loss"]), float(m["grad_norm"])


@pytest.mark.parametrize("layout,policy", CASES)
def test_policy_matches_the_jax_step(results, layout, policy, monkeypatch):
    monkeypatch.setenv("SCALETORCH_TPU_CE_CHUNK", str(CE_CHUNK))
    params, batch, loss, grads, res = results
    want_loss, want_norm = reference_metrics(params, batch, layout, policy)
    assert abs(want_loss - loss) <= TRAIN_PARITY["loss_abs"]
    for out in res[(layout, policy)]:
        assert abs(out["loss"] - want_loss) <= TRAIN_PARITY["loss_abs"]
        assert set(out["grads"]) == set(grads)
        norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                           for g in out["grads"].values()))
        assert norm == pytest.approx(want_norm, rel=TRAIN_PARITY["grad_rel"])
        for name, want in grads.items():
            scale = float(np.abs(want).max()) or 1.0
            err = float(np.abs(out["grads"][name] - want).max())
            assert err <= TRAIN_PARITY["grad_rel"] * scale, (name, err)
