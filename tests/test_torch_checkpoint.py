"""PyTorch port, the checkpoint manager (``utils/checkpoint.py``) against
the JAX package's (orbax): the same saves leave the same steps under
``keep_n``, and the same corrupt latest step falls back to the same
earlier step and is retired. Inside the port: a round trip is bit-exact
(parameters, AdamW's moments and ``count``, the step and ``extra``), a
truncated or corrupt latest step falls back and retires itself, an
injected ``OSError`` is retried, an asynchronous save keeps the
values it was handed while the parameters are updated in place after it
returns, and a run resumed with each optimizer (fp32 and bf16 masters)
equals a straight one. Every comparison is exact (tolerance 0).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from scaletorch_tpu.utils.checkpoint import CheckpointManager as JManager
from scaletorch_tpu_torch.trainer.optimizer import AdamW, tree_leaves
from scaletorch_tpu_torch.utils.checkpoint import CheckpointManager


class FailSaves:
    """Fail the first ``n`` save attempts (the reference's injector
    contract)."""

    def __init__(self, n):
        self.n = n

    def take_save_failure(self):
        if self.n > 0:
            self.n -= 1
            return True
        return False


def state(seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = {"embed_tokens": torch.randn(16, 8, generator=gen),
              "layers": {"q_proj": torch.randn(2, 8, 8, generator=gen),
                         "input_layernorm": torch.randn(2, 8, generator=gen)},
              "norm": torch.randn(8, generator=gen)}
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    opt = AdamW(lambda count: 1e-3)
    opt_state = opt.init(params)
    grads = {k: ({kk: torch.randn_like(vv) for kk, vv in v.items()}
                 if isinstance(v, dict) else torch.randn_like(v))
             for k, v in params.items()}
    opt.update(grads, opt_state, params)  # nonzero moments, count 1
    return params, opt_state


def snapshot(params, opt_state):
    return [t.detach().clone() for t in
            tree_leaves(params) + tree_leaves(opt_state)]


def bump(params, opt_state):
    with torch.no_grad():
        for t in tree_leaves(params) + tree_leaves(opt_state):
            t.add_(1)


def assert_state(params, opt_state, want):
    got = tree_leaves(params) + tree_leaves(opt_state)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a.detach(), b)


def manager(tmp_path, **kw):
    kw = {"retry_base_delay": 0.0, **kw}
    return CheckpointManager(str(tmp_path), **kw)


@pytest.mark.parametrize("async_save", [False, True])
def test_round_trip_is_bit_exact(tmp_path, async_save):
    params, opt_state = state()
    want = snapshot(params, opt_state)
    mgr = manager(tmp_path, async_save=async_save)
    extra = {"tokens_seen": 1234, "loader_position": 7, "note": [1, "a"]}
    assert mgr.save(5, params, opt_state, extra=extra)
    assert mgr.wait()
    assert mgr.all_steps() == [5] and mgr.latest_step() == 5
    assert mgr.step_bytes(5) > 0
    bump(params, opt_state)
    out = mgr.load_latest(params, opt_state)
    assert out["step"] == 5 and out["extra"] == extra
    assert out["params"] is params and out["opt_state"] is opt_state
    assert int(opt_state["count"]) == 1
    assert all(t.requires_grad for t in tree_leaves(params))
    assert_state(params, opt_state, want)
    assert not mgr.save(5, params, opt_state)  # the step exists
    mgr.close()


@pytest.mark.parametrize("async_save", [False, True])
@pytest.mark.parametrize("keep_n", [1, 2, 0])
def test_keep_n_keeps_the_reference_steps(tmp_path, keep_n, async_save):
    params, opt_state = state()
    ours = manager(tmp_path / "port", keep_n=keep_n, async_save=async_save)
    for step in (1, 2, 3, 4):
        assert ours.save(step, params, opt_state)
    ours.wait()
    tree = {"w": np.arange(4, dtype=np.float32)}
    theirs = JManager(str(tmp_path / "ref"), keep_n=keep_n or None,
                      retry_base_delay=0.0)
    for step in (1, 2, 3, 4):
        assert theirs.save(step, params=tree, opt_state=tree)
    theirs.wait()
    assert ours.all_steps() == theirs.all_steps()
    theirs.close()


def corrupt(step_dir, how):
    if how == "truncated":
        data = next(f for f in sorted(os.listdir(step_dir))
                    if f.endswith(".distcp"))
        path = os.path.join(step_dir, data)
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
    elif how == "metadata":
        with open(os.path.join(step_dir, ".metadata"), "wb") as f:
            f.write(b"not a checkpoint")
    else:
        os.remove(os.path.join(step_dir, "extra.json"))


@pytest.mark.parametrize("how", ["truncated", "metadata", "extra"])
def test_corrupt_latest_falls_back_and_retires(tmp_path, how):
    params, opt_state = state()
    mgr = manager(tmp_path, retries=1)
    assert mgr.save(1, params, opt_state, extra={"tokens_seen": 10})
    want = snapshot(params, opt_state)
    bump(params, opt_state)
    assert mgr.save(2, params, opt_state, extra={"tokens_seen": 20})
    corrupt(os.path.join(str(tmp_path), "2"), how)
    bump(params, opt_state)
    out = mgr.load_latest(params, opt_state)
    assert out["step"] == 1 and out["extra"] == {"tokens_seen": 10}
    assert_state(params, opt_state, want)
    assert mgr.all_steps() == [1]  # the unreadable step is retired
    assert mgr.save(2, params, opt_state)
    assert mgr.all_steps() == [1, 2]


def test_fallback_matches_the_reference(tmp_path):
    """Both managers: steps 1 and 2, step 2's payload broken, restore."""
    params, opt_state = state()
    ours = manager(tmp_path / "port", retries=0)
    theirs = JManager(str(tmp_path / "ref"), retries=0, retry_base_delay=0.0)
    tree = {"w": np.arange(4, dtype=np.float32)}
    for step in (1, 2):
        assert ours.save(step, params, opt_state, extra={"s": step})
        assert theirs.save(step, params={"w": tree["w"] * step},
                           opt_state=tree, extra={"s": step})
    theirs.wait()
    corrupt(str(tmp_path / "port" / "2"), "truncated")
    shutil.rmtree(next(p for p in (tmp_path / "ref" / "2").iterdir()
                       if "param" in p.name))
    a = ours.load_latest(params, opt_state)
    b = theirs.load_latest(params=tree, opt_state=tree)
    assert a["step"] == b["step"] == 1 and a["extra"] == b["extra"]
    assert ours.all_steps() == theirs.all_steps() == [1]
    assert manager(tmp_path / "empty").load_latest(params, opt_state) is None
    theirs.close()


@pytest.mark.parametrize("async_save", [False, True])
def test_injected_oserror_is_retried(tmp_path, async_save):
    params, opt_state = state()
    mgr = manager(tmp_path / "ok", retries=3, async_save=async_save,
                  fault_injector=FailSaves(2))
    assert mgr.save(1, params, opt_state) and mgr.wait()
    assert mgr.all_steps() == [1]
    assert not os.listdir(tmp_path / "ok")[0].startswith(".tmp")
    lost = manager(tmp_path / "lost", retries=1, async_save=async_save,
                   fault_injector=FailSaves(100))
    saved = lost.save(1, params, opt_state)
    assert saved is async_save  # an async failure shows in wait()
    if async_save:
        assert not lost.wait()
    assert lost.all_steps() == []
    assert lost._async is False  # a failed async write turns it sync


def test_failed_async_write_is_written_again_synchronously(tmp_path):
    params, opt_state = state()
    want = snapshot(params, opt_state)
    # 2 failures: the writer thread's 2 attempts (retries=1) fail, the
    # synchronous rewrite in wait() succeeds
    mgr = manager(tmp_path, retries=1, async_save=True,
                  fault_injector=FailSaves(2))
    assert mgr.save(3, params, opt_state)
    bump(params, opt_state)
    assert mgr.wait() and mgr.all_steps() == [3] and mgr._async is False
    mgr.load_latest(params, opt_state)
    assert_state(params, opt_state, want)


def test_async_snapshot_survives_in_place_updates(tmp_path):
    params, opt_state = state()
    mgr = manager(tmp_path, async_save=True)
    want = snapshot(params, opt_state)
    assert mgr.save(1, params, opt_state)
    for _ in range(3):  # steps after save() returned, before the write ends
        bump(params, opt_state)
    assert mgr.saves[-1]["blocking_s"] >= 0
    assert mgr.wait() and mgr.saves[-1]["total_s"] >= 0
    out = mgr.load_latest(params, opt_state)
    assert out["step"] == 1 and mgr.last_restore["step"] == 1
    assert_state(params, opt_state, want)


def test_verify_retires_a_step_that_differs(tmp_path):
    params, opt_state = state()
    mgr = manager(tmp_path, verify=True)
    assert mgr.save(1, params, opt_state) and mgr.all_steps() == [1]
    other = {**params, "norm": torch.zeros(9)}
    assert "norm" in mgr._verify_mismatch(1, other, opt_state)
    extra_leaf = {**params, "lm_head": torch.zeros(2)}
    assert "structure" in mgr._verify_mismatch(1, extra_leaf, opt_state)
    with open(os.path.join(str(tmp_path), "1", "extra.json")) as f:
        assert json.load(f)["step"] == 1
    # a save whose tree reads back differently is retired at once
    mgr._verify_mismatch = lambda step, p, o: "differs"
    assert not mgr.save(2, params, opt_state)
    assert mgr.all_steps() == [1]


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("optimizer", ["adamw", "adam", "sgd", "lamb",
                                       "adafactor"])
def test_resumed_run_equals_a_straight_one(tmp_path, optimizer, param_dtype):
    """Every optimizer's state (AdamW's and LAMB's moments, SGD's trace,
    Adafactor's keepdims statistics), in fp32 and with bf16 masters:
    ``Trainer`` A takes 2 steps, saves, takes 2 more; B resumes from the
    save (``resume="must"``) and takes the same 2: parameters, state and
    losses equal A's bit for bit. The model's widths (128) put
    Adafactor's factored branch on its embedding and MLP leaves."""
    from scaletorch_tpu_torch.config import ScaleTorchTPUArguments
    from scaletorch_tpu_torch.trainer.trainer import Trainer

    def cfg(**kw):
        return ScaleTorchTPUArguments(
            model_type="qwen3", hidden_size=128, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=32, vocab_size=256,
            max_position_embeddings=64, tie_word_embeddings=True,
            sequence_length=16, micro_batch_size=2, total_train_steps=4,
            warmup_steps=1, dtype="float32", param_dtype=param_dtype,
            optimizer_name=optimizer, synthetic_data=True,
            checkpoint_dir=str(tmp_path), log_frequency=1, **kw)

    a = Trainer(cfg(), device="cpu")
    batches = iter(a.loader)
    head = [next(batches) for _ in range(2)]
    tail = [next(batches) for _ in range(2)]
    for batch in head:
        a.step(batch)
    assert a.save_checkpoint()
    a.checkpoint_manager.wait()
    tail_a = [float(a.step(batch)["loss"]) for batch in tail]
    b = Trainer(cfg(resume="must"), device="cpu")
    assert b.global_step == 2
    tail_b = [float(b.step(batch)["loss"]) for batch in tail]
    assert tail_a == tail_b
    want = tree_leaves(a.params) + tree_leaves(a.opt_state)
    got = tree_leaves(b.params) + tree_leaves(b.opt_state)
    assert len(got) == len(want)
    dtype = torch.bfloat16 if param_dtype == "bfloat16" else torch.float32
    assert all(t.dtype == dtype for t in tree_leaves(b.params))
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x.detach(), y.detach())
    if optimizer == "adafactor":
        assert tuple(b.opt_state["v_row"]["embed_tokens"].shape) == (1, 128)
        assert tuple(b.opt_state["v_col"]["embed_tokens"].shape) == (256, 1)
    assert int(b.opt_state["count"]) == 4
    a.close()
    b.close()
