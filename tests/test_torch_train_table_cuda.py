"""PyTorch port, the rest of the single-chip training table on the card, at
2 layers of Qwen3-0.6B's width through the flash kernels (K1-K3):

  * each optimizer (AdamW, Adam, SGD, LAMB, Adafactor) with bf16 masters
    takes finite steps, its state in bf16;
  * each remat policy gives ``nothing_saveable``'s loss and gradients bit
    for bit (K2 and K3 are deterministic, and the recompute repeats the
    same ops), in fp32 and bf16;
  * under ``save_attn`` K1 launches once per layer a step (twice under
    ``nothing_saveable``), K2 and K3 once each;
  * an Adafactor run resumed from a checkpoint equals the straight run
    bit for bit.

Every test needs a CUDA card and skips without one (decided in a
fixture, at run time). The file imports no JAX, so it runs on the GPU
machine:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_train_table_cuda.py
"""

import pytest
import torch

from scaletorch_tpu_torch.benchmark import make_bench_args
from scaletorch_tpu_torch.models import model_config
from scaletorch_tpu_torch.models import llama as tllama
from scaletorch_tpu_torch.ops import _build
from scaletorch_tpu_torch.ops import flash as tf
from scaletorch_tpu_torch.trainer.optimizer import OPTIMIZERS, tree_leaves
from scaletorch_tpu_torch.trainer.train_step import make_loss_fn
from scaletorch_tpu_torch.trainer.trainer import Trainer

pytestmark = pytest.mark.cuda

LAYERS, SEQ = 2, 1024


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the train step runs the CUDA flash "
                    "kernels K1-K3")


def row(**extra):
    return make_bench_args("qwen3-0.6b", seq=SEQ, gc=True,
                           extra={"num_hidden_layers": LAYERS, **extra})


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_each_optimizer_trains_bf16_masters(cuda, optimizer):
    trainer = Trainer(row(param_dtype="bfloat16", optimizer_name=optimizer))
    assert all(p.dtype == torch.bfloat16 and p.is_cuda
               for p in tree_leaves(trainer.params))
    state = [t for k, v in trainer.opt_state.items() if k != "count"
             for t in tree_leaves(v)]
    assert state and all(t.dtype == torch.bfloat16 for t in state)
    losses = [float(trainer.step()["loss"]) for _ in range(3)]
    assert all(torch.isfinite(torch.tensor(losses))), losses
    assert int(trainer.opt_state["count"]) == 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_policy_equals_nothing_saveable(cuda, dtype):
    cfg = model_config("qwen3-0.6b", dtype=dtype,
                       num_hidden_layers=LAYERS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = tllama.init_params(cfg, gen, "cuda", requires_grad=True)
    tokens = torch.randint(0, cfg.vocab_size, (1, SEQ + 1), generator=gen,
                           device="cuda")
    mb = {"input_ids": tokens[:, :-1], "target_ids": tokens[:, 1:],
          "position_ids": torch.arange(SEQ, device="cuda")}
    leaves = tree_leaves(params)
    runs = {}
    for policy in tllama.REMAT_POLICIES:
        loss_fn = make_loss_fn(cfg, attention_backend="flash",
                               gradient_checkpointing=True,
                               remat_policy=policy)
        _build.reset_launch_counts()
        loss, _ = loss_fn(params, mb)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        runs[policy] = (loss.detach(), grads, dict(_build.launch_counts))
    base_loss, base, _ = runs["nothing_saveable"]
    for policy, (loss, grads, launches) in runs.items():
        assert torch.equal(loss, base_loss), policy
        for g, b in zip(grads, base):
            assert torch.equal(g, b), policy
        k1 = LAYERS if policy == "save_attn" else 2 * LAYERS
        assert launches == {tf.K1_NAME: k1, tf.K2_NAME: LAYERS,
                            tf.K3_NAME: LAYERS}, (policy, launches)


def test_adafactor_resume_is_bit_exact(cuda, tmp_path):
    def cfg(**kw):
        return row(param_dtype="bfloat16", optimizer_name="adafactor",
                   checkpoint_dir=str(tmp_path), **kw)

    a = Trainer(cfg())
    batches = iter(a.loader)
    head = [next(batches) for _ in range(2)]
    tail = [next(batches) for _ in range(2)]
    for batch in head:
        a.step(batch)
    assert a.save_checkpoint()
    a.checkpoint_manager.wait()
    tail_a = [float(a.step(batch)["loss"]) for batch in tail]
    b = Trainer(cfg(resume="must"))
    assert b.global_step == 2 and int(b.opt_state["count"]) == 2
    tail_b = [float(b.step(batch)["loss"]) for batch in tail]
    assert tail_a == tail_b
    for x, y in zip(tree_leaves(b.params) + tree_leaves(b.opt_state),
                    tree_leaves(a.params) + tree_leaves(a.opt_state)):
        assert x.dtype == y.dtype and torch.equal(x.detach(), y.detach())
    a.close()
    b.close()
