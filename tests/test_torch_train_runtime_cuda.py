"""PyTorch port, the training runtime on the card.

  * An asynchronous checkpoint of parameters and AdamW moments on the
    card keeps the values it was handed while AdamW updates them in place
    after ``save()`` returns (the snapshot goes to pinned host memory
    before the next step).
  * At 2 layers through the flash kernels (K1-K3), 4 straight steps from
    a local ``.jsonl`` equal 2 steps + an asynchronous save + a fresh
    ``Trainer`` with ``resume="must"`` + 2 steps: the restored step,
    loader position and AdamW count exactly, the learning rates exactly,
    the losses and val losses within the spread of two straight runs
    (0 when they agree bit for bit).
  * A bf16 HF export of parameters on the card reads back equal to the
    source rounded to bf16, bit for bit, and a ``Trainer`` loading it
    gives the first loss of one handed those rounded parameters.

Every test needs a CUDA card and skips without one (decided in a
fixture, at run time). The file imports no JAX, so it runs on the GPU
machine:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_train_runtime_cuda.py
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from scaletorch_tpu_torch.config import ScaleTorchTPUArguments
from scaletorch_tpu_torch.models import Qwen3Config
from scaletorch_tpu_torch.models import llama as tllama
from scaletorch_tpu_torch.ops import _build
from scaletorch_tpu_torch.ops import flash as tf
from scaletorch_tpu_torch.trainer.optimizer import AdamW, tree_leaves
from scaletorch_tpu_torch.trainer.trainer import Trainer
from scaletorch_tpu_torch.utils import hf_interop
from scaletorch_tpu_torch.utils.checkpoint import CheckpointManager

pytestmark = pytest.mark.cuda

ARCH = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=32, max_position_embeddings=512,
            tie_word_embeddings=True, rope_theta=1e6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the train step runs the CUDA flash "
                    "kernels and the snapshot copies from the card")


class ByteTokenizer:
    eos_token_id = 1

    def __call__(self, text, add_special_tokens=False):
        return {"input_ids": [b + 2 for b in text.encode()]}


def write_jsonl(path, n_docs, seed):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n_docs):
            f.write(json.dumps({"text": "".join(
                chr(97 + int(c)) for c in rng.integers(0, 26, 300))}) + "\n")
    return str(path)


def test_async_snapshot_against_in_place_adamw(cuda, tmp_path):
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = Qwen3Config(**ARCH, dtype=torch.bfloat16)
    params = tllama.init_params(cfg, gen, "cuda", requires_grad=True)
    opt = AdamW(lambda count: 1e-2)
    opt_state = opt.init(params)

    def update():
        grads = {k: ({kk: torch.randn(vv.shape, device="cuda", generator=gen)
                      for kk, vv in v.items()} if isinstance(v, dict)
                     else torch.randn(v.shape, device="cuda", generator=gen))
                 for k, v in params.items()}
        opt.update(grads, opt_state, params)

    update()
    want = [t.detach().cpu().clone()
            for t in tree_leaves(params) + tree_leaves(opt_state)]
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    assert mgr.save(1, params, opt_state)
    for _ in range(4):  # in-place AdamW steps while the writer runs
        update()
    assert mgr.wait()
    out = mgr.load_latest(params, opt_state)
    assert out["step"] == 1 and int(opt_state["count"]) == 1
    got = tree_leaves(params) + tree_leaves(opt_state)
    for a, b in zip(got, want):
        assert torch.equal(a.detach().cpu(), b)
    mgr.close()


def runtime_cfg(tmp_path, **kw):
    base = dict(model_type="qwen3", **ARCH, sequence_length=256,
                micro_batch_size=2, dtype="bfloat16",
                gradient_checkpointing=True, attention_backend="flash",
                total_train_steps=4, warmup_steps=1, max_grad_norm=1.0,
                dataset_name=write_jsonl(tmp_path / "train.jsonl", 40, 0),
                eval_dataset_name=write_jsonl(tmp_path / "val.jsonl", 8, 1),
                eval_frequency=2, eval_steps=2, save_frequency=2,
                keep_n_checkpoints=1, async_checkpointing=True,
                log_frequency=1)
    return ScaleTorchTPUArguments(**{**base, **kw})


def readings(trainer, steps):
    by_step = {r["step"]: r for r in trainer.history}
    return ([by_step[s]["loss"] for s in steps],
            [by_step[s]["lr"] for s in steps],
            [by_step[s].get("val_loss") for s in steps if s % 2 == 0])


def test_resume_at_two_layers(cuda, tmp_path):
    runs = []
    for i in range(2):
        t = Trainer(runtime_cfg(tmp_path,
                                checkpoint_dir=str(tmp_path / f"a{i}")),
                    tokenizer=ByteTokenizer())
        t.train()
        runs.append(readings(t, [3, 4]))
        t.close()
    spread = max(abs(a - b) for a, b in zip(runs[0][0] + runs[0][2],
                                            runs[1][0] + runs[1][2]))
    cfg = runtime_cfg(tmp_path, checkpoint_dir=str(tmp_path / "b"))
    first = Trainer(cfg, tokenizer=ByteTokenizer())
    first.train(num_steps=2)
    first.close()
    del first
    torch.cuda.empty_cache()
    _build.reset_launch_counts()
    resumed = Trainer(dataclasses.replace(cfg, resume="must"),
                      tokenizer=ByteTokenizer())
    assert resumed.global_step == 2 and resumed.loader.position == 2
    assert int(resumed.opt_state["count"]) == 2
    resumed.train()
    loss, lr, val = readings(resumed, [3, 4])
    assert lr == runs[0][1]
    diff = max(abs(a - b) for a, b in zip(loss + val, runs[0][0] + runs[0][2]))
    assert diff <= spread, (diff, spread)
    # 2 train steps (K1 twice a layer under GC) and one eval of 2 batches
    layers = ARCH["num_hidden_layers"]
    want = {tf.K1_NAME: 2 * 2 * layers + 2 * layers,
            tf.K2_NAME: 2 * layers, tf.K3_NAME: 2 * layers}
    got = {k: _build.launch_counts.get(k, 0) for k in want}
    assert got == want


def test_bf16_hf_round_trip(cuda, tmp_path):
    cfg = Qwen3Config(**ARCH, dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = tllama.init_params(cfg, gen, "cuda")
    hf_interop.save_hf_params(str(tmp_path), params, cfg, dtype="bfloat16",
                              max_shard_bytes=64 * 1024)
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"model_type": "qwen3", **ARCH}, f)
    back = hf_interop.load_hf_params(str(tmp_path), cfg, device="cuda")
    rounded = {k: ({kk: vv.to(torch.bfloat16).float()
                    for kk, vv in v.items()} if isinstance(v, dict)
                   else v.to(torch.bfloat16).float())
               for k, v in params.items()}
    for a, b in zip(tree_leaves(back), tree_leaves(rounded)):
        assert torch.equal(a, b)
    kw = dict(model_type="qwen3", sequence_length=128, synthetic_data=True,
              dtype="bfloat16", attention_backend="flash")
    loaded = Trainer(ScaleTorchTPUArguments(
        **kw, model_name_or_path=str(tmp_path), load_pretrained_weights=True))
    handed = Trainer(ScaleTorchTPUArguments(**kw, **ARCH))
    with torch.no_grad():
        for dst, src in zip(tree_leaves(handed.params), tree_leaves(rounded)):
            dst.copy_(src)
    batch = next(iter(handed.loader))
    assert float(loaded.step(batch)["loss"]) == float(
        handed.step(batch)["loss"])
