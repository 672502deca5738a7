"""PyTorch port, the runtime on the card, at 2 layers.

  * A SIGTERM drill through ``Trainer.train()`` leaves an emergency
    checkpoint at its step (a periodic asynchronous save in flight is
    drained first), and a ``resume="must"`` run's losses and learning
    rates equal a straight run's within the spread of two straight runs.
  * A NaN under ``divergence_policy="rollback"`` restores in place: every
    parameter and optimizer state tensor keeps its storage, the run
    reaches its last step with finite losses, one rollback, K1/K2/K3
    2L/L/L a step throughout.
  * The hang watchdog fires (a recording exit with 43) while the main
    thread waits in ``torch.cuda.synchronize()`` on a stall of the card.
  * A graphed paged engine takes a NaN poison (one request quarantined,
    the others a clean run's tokens) and, fresh, a warm prefix import
    (the donor's tokens); one capture of each step and no static buffer
    moved in every engine.

Every test needs a CUDA card and skips without one (decided in a
fixture, at run time). The file imports no JAX, so it runs on the GPU
machine:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_runtime_cuda.py
"""

import json
import time

import numpy as np
import pytest
import torch

from scaletorch_tpu_torch.config import ScaleTorchTPUArguments
from scaletorch_tpu_torch.inference import (
    InferenceEngine,
    SamplingParams,
    ServingFaultInjector,
)
from scaletorch_tpu_torch.models import LlamaForCausalLM, Qwen3Config
from scaletorch_tpu_torch.models import llama as tllama
from scaletorch_tpu_torch.ops import _build
from scaletorch_tpu_torch.ops import flash as tf
from scaletorch_tpu_torch.resilience_distributed import (
    WATCHDOG_EXIT_CODE,
    HangWatchdog,
)
from scaletorch_tpu_torch.trainer.optimizer import tree_leaves
from scaletorch_tpu_torch.trainer.trainer import Trainer

pytestmark = pytest.mark.cuda

ARCH = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=32, max_position_embeddings=512,
            tie_word_embeddings=True, rope_theta=1e6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the train step runs the CUDA flash "
                    "kernels and the engine captures CUDA graphs")


class ByteTokenizer:
    eos_token_id = 1

    def __call__(self, text, add_special_tokens=False):
        return {"input_ids": [b + 2 for b in text.encode()]}


@pytest.fixture
def corpus(tmp_path):
    rng = np.random.default_rng(0)
    path = tmp_path / "train.jsonl"
    with open(path, "w") as f:
        for _ in range(32):
            letters = rng.integers(97, 123, 1024, dtype=np.uint8)
            f.write(json.dumps({"text": letters.tobytes().decode()}) + "\n")
    return str(path)


def cfg_for(corpus, **kw):
    base = dict(model_type="qwen3", **ARCH, dataset_name=corpus,
                sequence_length=256, dtype="bfloat16",
                gradient_checkpointing=True, total_train_steps=6,
                log_frequency=1, async_checkpointing=True,
                keep_n_checkpoints=1, checkpoint_retry_base_delay=0.05)
    return ScaleTorchTPUArguments(**{**base, **kw})


def flash_log(trainer):
    log = []
    inner = trainer.step_fn

    def counted(*args):
        before = dict(_build.launch_counts)
        out = inner(*args)
        log.append({k: _build.launch_counts[k] - before.get(k, 0)
                    for k in (tf.K1_NAME, tf.K2_NAME, tf.K3_NAME)})
        return out

    trainer.step_fn = counted
    return log


def losses(trainer, steps):
    by = {r["step"]: r for r in trainer.history}
    return [by[s]["loss"] for s in steps], [by[s]["lr"] for s in steps]


def test_sigterm_checkpoint_and_resume(cuda, corpus, tmp_path):
    straight = []
    for _ in range(2):
        t = Trainer(cfg_for(corpus), tokenizer=ByteTokenizer())
        t.train()
        straight.append(losses(t, range(1, 7)))
        t.close()
    spread = max(abs(a - b) for a, b in zip(straight[0][0], straight[1][0]))
    ckpt = str(tmp_path / "ckpt")
    t = Trainer(cfg_for(corpus, checkpoint_dir=ckpt, save_frequency=2,
                        ft_sigterm_at_step=3), tokenizer=ByteTokenizer())
    t.train()
    assert t.preempted and t.emergency_checkpoint_saved
    assert t.global_step == 3 and t.checkpoint_manager.latest_step() == 3
    assert set(t.emergency_timing) == {"drain_s", "blocking_s", "write_s",
                                       "total_s"}
    t.close()
    t = Trainer(cfg_for(corpus, checkpoint_dir=ckpt, save_frequency=2,
                        resume="must"), tokenizer=ByteTokenizer())
    assert t.global_step == 3 and t.loader.position == 3
    t.train()
    got, lr = losses(t, range(4, 7))
    assert lr == straight[0][1][3:]
    assert max(abs(a - b) for a, b in zip(got, straight[0][0][3:])) <= spread
    t.close()


def test_rollback_restores_in_place(cuda, corpus, tmp_path):
    t = Trainer(cfg_for(corpus, checkpoint_dir=str(tmp_path / "ckpt"),
                        save_frequency=2, ft_nan_at_step=5,
                        divergence_policy="rollback"),
                tokenizer=ByteTokenizer())
    before = [x.data_ptr() for x in
              tree_leaves(t.params) + tree_leaves(t.opt_state)]
    log = flash_log(t)
    t.train()
    assert t.global_step == 6 and [r["step"] for r in t.history] == [
        1, 2, 3, 4, 5, 6]
    assert all(np.isfinite(r["loss"]) for r in t.history)
    c = t.resilience.counters()
    assert c["rollbacks"] == 1 and c["nonfinite_losses"] == 1
    assert [x.data_ptr() for x in
            tree_leaves(t.params) + tree_leaves(t.opt_state)] == before
    layers = ARCH["num_hidden_layers"]
    assert log == [{tf.K1_NAME: 2 * layers, tf.K2_NAME: layers,
                    tf.K3_NAME: layers}] * 7
    t.close()


@pytest.mark.parametrize("wait", ["synchronize", "item"])
def test_watchdog_fires_during_a_device_stall(cuda, wait):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(50_000_000)
    end.record()
    end.synchronize()
    per_s = 50_000_000 / (start.elapsed_time(end) / 1e3)
    fired, stacks = [], []

    def report(info):
        stacks.append(info["thread_stacks"].get("MainThread", ""))

    probe = torch.zeros(1, device="cuda")
    wd = HangWatchdog(0.5, poll_interval=0.05, crash_report=report,
                      exit_fn=lambda code: fired.append(
                          (code, time.monotonic())))
    with wd:
        t0 = time.monotonic()
        torch.cuda._sleep(int(1.5 * per_s))
        if wait == "synchronize":
            torch.cuda.synchronize()
        else:
            probe.add(1).item()
        t1 = time.monotonic()
    assert len(fired) == 1 and fired[0][0] == WATCHDOG_EXIT_CODE
    assert t0 < fired[0][1] < t1  # while the main thread was blocked
    assert wait in stacks[0]


def static_pointers(eng):
    ptrs = {f"{step}.{name}": buf.data_ptr()
            for step in ("_prefill", "_decode")
            for name, buf in getattr(eng, step).inputs.items()}
    ptrs.update(k=eng.cache.k.data_ptr(), v=eng.cache.v.data_ptr(),
                tables=eng._tables_dev.data_ptr())
    return ptrs


@pytest.fixture
def model(cuda):
    cfg = Qwen3Config(**ARCH, qk_norm=True, dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tllama.init_params(cfg, gen, "cuda")
    return LlamaForCausalLM.from_params(params, cfg), cfg


def engine(model, **kw):
    m, cfg = model
    return InferenceEngine(m, cfg, max_slots=4, max_seq=128, prefill_len=64,
                           sampling=SamplingParams(temperature=0.0),
                           cache_layout="paged", page_size=16, **kw)


def prompts(n=8, seed=3):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 256, 32).tolist()
    return [prefix + rng.integers(0, 256, int(rng.integers(1, 30))).tolist()
            for _ in range(n)]


def served(eng, ps, new_tokens=16):
    ptrs = static_pointers(eng)
    ids = [eng.submit(p, max_new_tokens=new_tokens) for p in ps]
    res = eng.run()
    assert eng.decode_compile_count == eng.prefill_compile_count == 1
    assert static_pointers(eng) == ptrs
    eng.allocator.check_conservation()
    return [res[i] for i in ids]


def test_graphed_poison_and_warm_import(model):
    with torch.inference_mode():
        clean = served(engine(model), prompts())
        # the second wave (requests 4-7) is decoding at step 20
        bad = served(engine(model, injector=ServingFaultInjector(
            nan_logits_at_step=20, nan_logits_slot=1)), prompts())
        quarantined = [i for i, r in enumerate(bad)
                       if r.outcome == "quarantined"]
        assert len(quarantined) == 1
        assert all(bad[i].tokens == clean[i].tokens for i in range(8)
                   if i not in quarantined)
        donor = engine(model)
        served(donor, prompts())
        again = served(donor, prompts())
        pmap = donor.export_prefix_map()
        pages = [p for c in pmap["chains"] for p in c["pages"]]
        _, contents = donor.export_prefix_pages(pages)
        recipient = engine(model)
        ptrs = static_pointers(recipient)
        got = recipient.import_prefix_pages(
            [(c["tokens"], c["pages"]) for c in pmap["chains"]], contents,
            dtype=pmap["dtype"], page_shape=pmap["page_shape"],
            page_size=pmap["page_size"])
        assert got["pages"] == len(set(pages))
        assert static_pointers(recipient) == ptrs
        warm = served(recipient, prompts())
        assert recipient.metrics.prefix_hits == 8
        assert [r.tokens for r in warm] == [r.tokens for r in again]
