"""PyTorch port, the reference's four gradient-checkpointing policies.

``nothing_saveable`` recomputes each layer whole; ``dots_saveable``,
``dots_with_no_batch_dims_saveable`` and ``save_attn`` run each layer
under ``torch.utils.checkpoint`` with a selective policy. For Qwen3 (the
``flash`` and ``sdpa`` backends) and Qwen3-MoE (the einsum path and the
grouped-MLP kernels' plain versions), in fp32 on the CPU:

  * the loss and every gradient equal ``nothing_saveable``'s bit for bit
    (the recompute repeats the same ops) and the JAX package's under the
    same policy (loss rtol 1e-6, gradients within 1e-5 of each leaf's
    largest entry);
  * under ``save_attn`` K1 (the ``flash_forward`` op, here its plain
    version) runs once per layer per step, against twice under
    ``nothing_saveable``;
  * the bytes a policy keeps for the backward (the selective checkpoint's
    cache, read after the forward) are ordered ``nothing_saveable`` (0)
    < ``dots_with_no_batch_dims_saveable`` <= ``dots_saveable``, and
    ``save_attn`` keeps K1's out and lse per layer.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaletorch_tpu.models import llama as jllama
from scaletorch_tpu.models import qwen3_moe as jmoe
from scaletorch_tpu_torch.models import llama as tllama
from scaletorch_tpu_torch.models import params_from_numpy
from scaletorch_tpu_torch.models import qwen3_moe as tmoe
from scaletorch_tpu_torch.ops import flash as tflash
from scaletorch_tpu_torch.trainer.optimizer import tree_leaves
from tests.test_torch_one_thread import one_torch_thread  # noqa: F401


POLICIES = tllama.REMAT_POLICIES
DENSE = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, head_dim=32, max_position_embeddings=256,
             qk_norm=True, tie_word_embeddings=True, rope_theta=1e6)
MOE = dict(DENSE, intermediate_size=96, moe_intermediate_size=48,
           num_experts=4, num_experts_per_tok=2, capacity_factor=1.25,
           tie_word_embeddings=False)
SEQ, ROWS = 32, 2


def setup(family, kernel=False):
    """(JAX forward, JAX config, port module, port config, JAX params,
    port params) for one family."""
    if family == "qwen3":
        jcfg = jllama.LlamaConfig(**DENSE, dtype=jnp.float32)
        tcfg = tllama.LlamaConfig(**DENSE, dtype=torch.float32)
        jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
        jmod, tmod = jllama, tllama
    else:
        jcfg = jmoe.Qwen3MoEConfig(**MOE, dtype=jnp.float32)
        tcfg = tmoe.Qwen3MoEConfig(**MOE, dtype=torch.float32,
                                   use_grouped_mlp_kernel=kernel)
        jparams = jmoe.init_params(jax.random.PRNGKey(0), jcfg)
        jmod, tmod = jmoe, tmoe
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jmod, jcfg, tmod, tcfg, jparams, tparams


def ids():
    rng = np.random.default_rng(7)
    return rng.integers(0, DENSE["vocab_size"], (ROWS, SEQ)).astype(np.int32)


def torch_loss(tmod, tcfg, tparams, policy, backend):
    out = tmod.forward(tparams, torch.from_numpy(ids()), tcfg,
                       attention_backend=backend, gradient_checkpointing=True,
                       remat_policy=policy)
    logits = out if torch.is_tensor(out) else out[0]
    aux = 0.0 if torch.is_tensor(out) else out[1]
    return logits.float().square().mean() + aux


def torch_loss_and_grads(tmod, tcfg, tparams, policy, backend):
    loss = torch_loss(tmod, tcfg, tparams, policy, backend)
    grads = torch.autograd.grad(loss, tree_leaves(tparams))
    return loss.detach(), [g.numpy() for g in grads]


def jax_loss_and_grads(jmod, jcfg, jparams, policy, backend):
    def loss_fn(p):
        out = jmod.forward(p, jnp.asarray(ids()), jcfg,
                           attention_backend=backend,
                           gradient_checkpointing=True, remat_policy=policy)
        logits, aux = (out, 0.0) if not isinstance(out, tuple) else out[:2]
        return jnp.mean(jnp.square(logits.astype(jnp.float32))) + aux

    loss, grads = jax.value_and_grad(loss_fn)(jparams)
    return float(loss), grads


CASES = [("qwen3", "flash", False), ("qwen3", "sdpa", False),
         ("qwen3_moe", "flash", False), ("qwen3_moe", "flash", True)]
CASE_IDS = ["qwen3-flash", "qwen3-sdpa", "moe-einsum", "moe-kernel"]


@pytest.mark.parametrize("policy", POLICIES[1:])
@pytest.mark.parametrize("family,backend,kernel", CASES, ids=CASE_IDS)
def test_policy_equals_nothing_saveable_and_the_jax_gradients(
        family, backend, kernel, policy):
    jmod, jcfg, tmod, tcfg, jparams, tparams = setup(family, kernel)
    base_loss, base = torch_loss_and_grads(tmod, tcfg, tparams,
                                           "nothing_saveable", backend)
    loss, grads = torch_loss_and_grads(tmod, tcfg, tparams, policy, backend)
    assert torch.equal(loss, base_loss)
    for g, b in zip(grads, base):
        np.testing.assert_array_equal(g, b)
    jloss, jgrads = jax_loss_and_grads(
        jmod, jcfg, jparams, policy,
        "flash" if backend == "flash" else "sdpa")
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-6)
    want = {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    names = [jax.tree_util.keystr(path) for path, _ in
             jax.tree_util.tree_flatten_with_path(
                 jax.tree.map(np.asarray, jparams))[0]]
    port = dict(zip(_port_names(tparams), grads))
    assert sorted(port) == sorted(names)
    for name in names:
        scale = max(float(np.max(np.abs(want[name]))), 1e-30)
        assert np.max(np.abs(port[name] - want[name])) <= 1e-5 * scale, name


def _port_names(tree, prefix=""):
    out = []
    for key, value in tree.items():
        if isinstance(value, dict):
            out.extend(_port_names(value, f"{prefix}['{key}']"))
        else:
            out.append(f"{prefix}['{key}']")
    return out


@pytest.mark.parametrize("family", ["qwen3", "qwen3_moe"])
def test_save_attn_runs_the_flash_forward_once_per_layer(family,
                                                         monkeypatch):
    _, _, tmod, tcfg, _, tparams = setup(family)
    calls = collections.Counter()
    plain = tflash.flash_forward_ref

    def counted(*args, **kwargs):
        calls["flash_forward"] += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(tflash, "flash_forward_ref", counted)
    layers = tcfg.num_hidden_layers
    for policy, want in (("nothing_saveable", 2 * layers),
                         ("save_attn", layers),
                         ("dots_saveable", 2 * layers)):
        calls.clear()
        torch_loss_and_grads(tmod, tcfg, tparams, policy, "flash")
        assert calls["flash_forward"] == want, policy


def _cache_bytes(storage) -> int:
    """Bytes of the distinct tensors in a selective checkpoint's cache."""
    seen = {}

    def walk(obj):
        if torch.is_tensor(obj):
            st = obj.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
        elif isinstance(obj, dict):
            for v in obj.values():
                walk(v)
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                walk(v)
        elif torch.is_tensor(getattr(obj, "val", None)):
            walk(obj.val)

    walk(storage)
    return sum(seen.values())


@pytest.mark.parametrize("family,backend", [("qwen3", "flash"),
                                            ("qwen3", "sdpa"),
                                            ("qwen3_moe", "flash")])
def test_saved_bytes_are_ordered(family, backend, monkeypatch):
    import torch.utils.checkpoint as tuc

    _, _, tmod, tcfg, _, tparams = setup(family)
    made = []
    real = tuc.create_selective_checkpoint_contexts

    def recording(*args, **kwargs):
        ctx = real(*args, **kwargs)
        made.append(ctx[0])
        return ctx

    monkeypatch.setattr(tuc, "create_selective_checkpoint_contexts",
                        recording)
    saved = {}
    for policy in POLICIES:
        made.clear()
        loss = torch_loss(tmod, tcfg, tparams, policy, backend)
        saved[policy] = sum(_cache_bytes(m.storage) for m in made)
        assert len(made) == (0 if policy == "nothing_saveable"
                             else tcfg.num_hidden_layers)
        del loss
    assert saved["nothing_saveable"] == 0
    assert 0 < saved["dots_with_no_batch_dims_saveable"] <= saved[
        "dots_saveable"], saved
    if backend == "sdpa":  # the attention's batched products are dots
        assert saved["dots_with_no_batch_dims_saveable"] < saved[
            "dots_saveable"]
    # save_attn: out [B, Hq, S, D] in the compute dtype, per layer; with
    # flash also the fp32 lse [B, Hq, S]
    heads, dh = tcfg.num_attention_heads, tcfg.actual_head_dim
    per_layer = ROWS * heads * SEQ * dh * 4
    if backend == "flash":
        per_layer += ROWS * heads * SEQ * 4
    assert saved["save_attn"] == tcfg.num_hidden_layers * per_layer


def test_policies_are_the_reference_names_and_unknown_ones_raise():
    assert set(POLICIES) == {
        "nothing_saveable", "dots_saveable",
        "dots_with_no_batch_dims_saveable", "save_attn"}
    assert tllama.resolve_remat_policy("nothing_saveable") is None
    for name in POLICIES:
        jllama.resolve_remat_policy(name)
    with pytest.raises(ValueError, match="unknown remat_policy"):
        tllama.resolve_remat_policy("everything")
    params = setup("qwen3")[5]
    with pytest.raises(ValueError, match="unknown remat_policy"):
        tllama.forward(params, torch.zeros(1, 4, dtype=torch.int32),
                       tllama.LlamaConfig(**DENSE, dtype=torch.float32),
                       gradient_checkpointing=True, remat_policy="dots")
