"""PyTorch port, Hugging Face safetensors interop against the JAX
package's ``utils/hf_interop.py``.

Tiny Llama (untied), Qwen3 (tied) and Qwen3-MoE (untied, interleaved
dense/sparse) checkpoints written by the reference's ``save_hf_params``
in fp32, in bf16 and sharded load in the port equal to the reference's
load carried across with ``models/convert.py``, exactly (tolerance 0).
The port's export loads in the reference exactly, reads the same through
the ``safetensors`` package as the reference's own export of the same
tree, and shards the same way. A checkpoint built by ``transformers``
gives the same logits in the port within 1e-4 (fp32), as the reference's
golden test holds it. An engine built from a reference-written
checkpoint serves the reference engine's greedy tokens (a divergence
only where the JAX logits' top-2 margin is below 1e-4). ``from_hf``
gives the reference's fields from the parsed ``config.json``, and the
``config.json`` the port writes (``hf_config_dict``) reads back as the
same config in both and, with the port's export, loads in
``transformers`` with the port's logits (1e-4).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.torch
import torch
import transformers

from scaletorch_tpu.inference import InferenceEngine as JaxEngine
from scaletorch_tpu.inference import SamplingParams as JaxSampling
from scaletorch_tpu.models import llama as jllama
from scaletorch_tpu.models import qwen3 as jqwen3
from scaletorch_tpu.models import qwen3_moe as jmoe
from scaletorch_tpu.utils import hf_interop as jhf
from scaletorch_tpu_torch.inference import InferenceEngine, SamplingParams
from scaletorch_tpu_torch.models import (
    LlamaForCausalLM,
    params_from_numpy,
    params_to_numpy,
)
from scaletorch_tpu_torch.models import llama as tllama
from scaletorch_tpu_torch.models import qwen3 as tqwen3
from scaletorch_tpu_torch.models import qwen3_moe as tmoe
from scaletorch_tpu_torch.models.convert import flatten_params
from scaletorch_tpu_torch.utils import hf_interop as thf

DENSE = dict(vocab_size=64, hidden_size=32, intermediate_size=48,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, head_dim=8, max_position_embeddings=128)
MOE = dict(DENSE, num_hidden_layers=3, moe_intermediate_size=24,
           num_experts=4, num_experts_per_tok=2, mlp_only_layers=(1,))
FAMILIES = {
    "llama": (jllama.LlamaConfig, tllama.LlamaConfig,
              dict(DENSE, tie_word_embeddings=False), jllama.init_params),
    "qwen3": (jqwen3.Qwen3Config, tqwen3.Qwen3Config,
              dict(DENSE, tie_word_embeddings=True), jllama.init_params),
    "qwen3_moe": (jmoe.Qwen3MoEConfig, tmoe.Qwen3MoEConfig, MOE,
                  jmoe.init_params),
}
# fp32, bf16, and fp32 cut into shards of at most 6 KiB
EXPORTS = {"fp32": ("float32", 5 * 1024 ** 3),
           "bf16": ("bfloat16", 5 * 1024 ** 3),
           "sharded": ("float32", 6 * 1024)}


def family(name, seed=0):
    jcls, tcls, kw, init = FAMILIES[name]
    jcfg = jcls(**kw, dtype=jnp.float32)
    tcfg = tcls(**kw, dtype=torch.float32)
    params = init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, params


def assert_trees_equal(ours, theirs_np):
    a, b = flatten_params(ours), flatten_params(theirs_np)
    assert sorted(a) == sorted(b)
    for key in a:
        got = a[key].detach().cpu().numpy()
        assert got.dtype == np.float32 and got.shape == b[key].shape, key
        assert got.tobytes() == np.asarray(b[key], np.float32).tobytes(), key


@pytest.mark.parametrize("export", list(EXPORTS))
@pytest.mark.parametrize("name", list(FAMILIES))
def test_reference_checkpoint_loads_exactly(tmp_path, name, export):
    jcfg, tcfg, params = family(name)
    dtype, shard = EXPORTS[export]
    out = jhf.save_hf_params(str(tmp_path), params, jcfg, dtype=dtype,
                             max_shard_bytes=shard)
    assert out.endswith("index.json") == (export == "sharded")
    theirs = jax.tree.map(np.asarray, jhf.load_hf_params(str(tmp_path), jcfg))
    ours = thf.load_hf_params(str(tmp_path), tcfg, device="cpu")
    # the reference's load carried across as the port carries a JAX tree
    assert_trees_equal(ours, params_to_numpy(params_from_numpy(theirs,
                                                               "cpu")))
    assert ("lm_head" in ours) == (not tcfg.tie_word_embeddings)
    assert thf.hf_checkpoint_layer_names(str(tmp_path)) == \
        jhf.hf_checkpoint_layer_names(str(tmp_path))


def safetensors_files(path):
    return sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))


@pytest.mark.parametrize("export", list(EXPORTS))
@pytest.mark.parametrize("name", list(FAMILIES))
def test_port_export_reads_as_the_reference_export(tmp_path, name, export):
    jcfg, tcfg, params = family(name, seed=3)
    dtype, shard = EXPORTS[export]
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    ours_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    thf.save_hf_params(ours_dir, tparams, tcfg, dtype=dtype,
                       max_shard_bytes=shard)
    jhf.save_hf_params(ref_dir, params, jcfg, dtype=dtype,
                       max_shard_bytes=shard)
    files = safetensors_files(ours_dir)
    assert files == safetensors_files(ref_dir)
    assert (len(files) > 1) == (export == "sharded")
    if export == "sharded":
        index = "model.safetensors.index.json"
        with open(os.path.join(ours_dir, index)) as f, \
                open(os.path.join(ref_dir, index)) as g:
            assert json.load(f) == json.load(g)
    for fname in files:
        ours = safetensors.torch.load_file(os.path.join(ours_dir, fname))
        theirs = safetensors.torch.load_file(os.path.join(ref_dir, fname))
        assert sorted(ours) == sorted(theirs)
        own = thf.SafetensorsFile(os.path.join(ours_dir, fname))
        for key in ours:
            assert ours[key].dtype == theirs[key].dtype
            assert torch.equal(ours[key], theirs[key]), key
            assert torch.equal(own.get_tensor(key), ours[key]), key
        own.close()
    # and the reference reads the port's export back exactly
    back = jax.tree.map(np.asarray, jhf.load_hf_params(ours_dir, jcfg))
    ref = jax.tree.map(np.asarray, jhf.load_hf_params(ref_dir, jcfg))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b), back, ref)


def test_missing_tensor_raises(tmp_path):
    jcfg, tcfg, params = family("qwen3")
    jhf.save_hf_params(str(tmp_path), params, jcfg)
    deeper = dataclasses.replace(tcfg, num_hidden_layers=3)
    with pytest.raises(KeyError, match="not found"):
        thf.load_hf_params(str(tmp_path), deeper, device="cpu")
    with pytest.raises(FileNotFoundError, match="local"):
        thf.load_hf_params(str(tmp_path / "nothing"), tcfg, device="cpu")


def test_untied_config_without_a_head_takes_the_embedding(tmp_path):
    jcfg, tcfg, params = family("qwen3")  # tied: the file has no lm_head
    jhf.save_hf_params(str(tmp_path), params, jcfg)
    untied_j = dataclasses.replace(jcfg, tie_word_embeddings=False)
    untied_t = dataclasses.replace(tcfg, tie_word_embeddings=False)
    with pytest.warns(UserWarning, match="lm_head"):
        ours = thf.load_hf_params(str(tmp_path), untied_t, device="cpu")
    with pytest.warns(UserWarning, match="lm_head"):
        theirs = jax.tree.map(np.asarray,
                              jhf.load_hf_params(str(tmp_path), untied_j))
    assert_trees_equal(ours, theirs)


def test_transformers_qwen3_logits_match(tmp_path):
    hf_cfg = transformers.Qwen3Config(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, max_position_embeddings=128, rope_theta=10000.0,
        rms_norm_eps=1e-6, tie_word_embeddings=True,
        attn_implementation="eager")
    torch.manual_seed(1)
    model = transformers.Qwen3ForCausalLM(hf_cfg).eval()
    path = str(tmp_path / "qwen3")
    model.save_pretrained(path, safe_serialization=True)
    cfg = tqwen3.Qwen3Config.from_hf(thf.read_hf_config(path),
                                     dtype=torch.float32)
    assert cfg.tie_word_embeddings and cfg.qk_norm and cfg.head_dim == 16
    params = thf.load_hf_params(path, cfg, device="cpu")
    assert "lm_head" not in params
    ids = torch.arange(2 * 16).reshape(2, 16) % cfg.vocab_size
    with torch.no_grad():
        theirs = model(ids).logits.float()
        ours = tllama.forward(params, ids, cfg).float()
    assert float((ours - theirs).abs().max()) <= 1e-4


@pytest.mark.parametrize("name", ["llama", "qwen3"])
def test_port_export_loads_in_transformers(tmp_path, name):
    """The port's fp32 export with ``hf_config_dict``'s config.json is a
    checkpoint ``transformers`` loads, with the port's logits (1e-4)."""
    _, tcfg, params = family(name, seed=4)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    thf.save_hf_params(str(tmp_path), tparams, tcfg)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(thf.hf_config_dict(tcfg, "float32"), f)
    model = transformers.AutoModelForCausalLM.from_pretrained(
        str(tmp_path), attn_implementation="eager").eval()
    ids = torch.arange(2 * 16).reshape(2, 16) % tcfg.vocab_size
    with torch.no_grad():
        theirs = model(ids).logits.float()
        ours = tllama.forward(tparams, ids, tcfg).float()
    assert float((ours - theirs).abs().max()) <= 1e-4


@pytest.mark.parametrize("name", list(FAMILIES))
def test_hf_config_dict_reads_back(tmp_path, name):
    """``from_hf`` of ``hf_config_dict`` is the config again, in the port
    and, through ``transformers.AutoConfig``, in the reference."""
    jcfg, tcfg, _ = family(name)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(thf.hf_config_dict(tcfg), f)
    ours = type(tcfg).from_hf(thf.read_hf_config(str(tmp_path)),
                              dtype=torch.float32)
    theirs = type(jcfg).from_hf(
        transformers.AutoConfig.from_pretrained(str(tmp_path)),
        dtype=jnp.float32)
    for f in dataclasses.fields(tcfg):
        if f.name in ("dtype", "param_dtype"):
            continue
        assert getattr(ours, f.name) == getattr(tcfg, f.name), f.name
        assert getattr(theirs, f.name) == getattr(tcfg, f.name), f.name


def hf_config_objects():
    return {
        "llama": (transformers.LlamaConfig(
            vocab_size=96, hidden_size=32, intermediate_size=80,
            num_hidden_layers=3, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=256,
            rope_theta=5e5, rms_norm_eps=1e-5), jllama.LlamaConfig,
            tllama.LlamaConfig),
        "qwen3": (transformers.Qwen3Config(
            vocab_size=96, hidden_size=32, intermediate_size=80,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, tie_word_embeddings=True),
            jqwen3.Qwen3Config, tqwen3.Qwen3Config),
        "qwen3_moe": (transformers.Qwen3MoeConfig(
            vocab_size=96, hidden_size=32, intermediate_size=80,
            moe_intermediate_size=24, num_hidden_layers=4,
            num_attention_heads=4, num_key_value_heads=2, head_dim=8,
            num_experts=6, num_experts_per_tok=2, mlp_only_layers=[0],
            decoder_sparse_step=2, norm_topk_prob=False),
            jmoe.Qwen3MoEConfig, tmoe.Qwen3MoEConfig),
    }


@pytest.mark.parametrize("name", ["llama", "qwen3", "qwen3_moe"])
def test_from_hf_fields_equal_the_reference(tmp_path, name):
    hf, jcls, tcls = hf_config_objects()[name]
    hf.save_pretrained(str(tmp_path))
    parsed = thf.read_hf_config(str(tmp_path))
    theirs = jcls.from_hf(hf, dtype=jnp.float32)
    for source in (parsed, hf):  # the parsed config.json, or the object
        ours = tcls.from_hf(source, dtype=torch.float32)
        for f in dataclasses.fields(ours):
            if f.name in ("dtype", "param_dtype"):
                continue
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    overridden = tcls.from_hf(parsed, num_hidden_layers=2,
                              dtype=torch.float32)
    assert overridden.num_hidden_layers == 2


KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
          head_dim=16, max_position_embeddings=256, tie_word_embeddings=True,
          rope_theta=1e6)
ENGINE = dict(max_slots=3, max_seq=32, prefill_len=16, page_size=4,
              num_pages=24, cache_layout="paged")
MARGIN = 1e-4


def test_engine_from_a_reference_checkpoint_serves_its_tokens(tmp_path):
    jcfg = jqwen3.Qwen3Config(**KW, dtype=jnp.float32)
    tcfg = tqwen3.Qwen3Config(**KW, dtype=torch.float32)
    jhf.save_hf_params(str(tmp_path), jllama.init_params(
        jax.random.PRNGKey(5), jcfg), jcfg, dtype="bfloat16")
    jparams = jhf.load_hf_params(str(tmp_path), jcfg)
    model = LlamaForCausalLM.from_params(
        thf.load_hf_params(str(tmp_path), tcfg, device="cpu"), tcfg,
        device="cpu")
    rng = np.random.default_rng(9)
    prompts = [(rng.integers(0, 128, n).tolist(), m)
               for n, m in ((5, 8), (11, 6), (3, 10), (8, 7))]
    je = JaxEngine(jparams, jcfg, sampling=JaxSampling(temperature=0.0),
                   **ENGINE)
    te = InferenceEngine(model, tcfg, sampling=SamplingParams(
        temperature=0.0), device="cpu", **ENGINE)
    results = []
    for eng in (je, te):
        ids = [eng.submit(p, max_new_tokens=m) for p, m in prompts]
        eng.run()
        results.append([eng.result(i) for i in ids])
    for j, t in zip(*results):
        assert j.outcome == t.outcome == "ok"
        if j.tokens != t.tokens:
            k = next(i for i, (a, b) in enumerate(zip(j.tokens, t.tokens))
                     if a != b)
            logits = np.asarray(jllama.forward(
                jparams, jnp.asarray([j.prompt + j.tokens[:k]], jnp.int32),
                jcfg))[0, -1]
            top = np.sort(logits)[-2:]
            assert top[1] - top[0] < MARGIN, (j.request_id, k)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_bf16_masters_load_and_export_bit_for_bit(tmp_path, name):
    """bf16 master weights: a reference bf16 checkpoint loads into bf16
    leaves bit for bit (the reference's bf16 load, carried across); the
    port's bf16 export of them reads back bit for bit, through the port
    and through ``safetensors``; an fp32 export of bf16 masters widens
    exactly, and loading it into bf16 masters gives the same bits."""
    jcfg, tcfg, params = family(name)
    jhf.save_hf_params(str(tmp_path / "ref"), params, jcfg,
                       dtype="bfloat16")
    bcfg = dataclasses.replace(tcfg, param_dtype=torch.bfloat16)
    ours = thf.load_hf_params(str(tmp_path / "ref"), bcfg, device="cpu")
    theirs = jhf.load_hf_params(
        str(tmp_path / "ref"),
        dataclasses.replace(jcfg, param_dtype=jnp.bfloat16))
    flat, ref = flatten_params(ours), flatten_params(theirs)
    assert sorted(flat) == sorted(ref)
    for key, leaf in flat.items():
        assert leaf.dtype == torch.bfloat16, key
        want = torch.from_numpy(np.asarray(ref[key], np.float32))
        assert torch.equal(leaf.float(), want), key
    for dtype in ("bfloat16", "float32"):
        out = tmp_path / dtype
        thf.save_hf_params(str(out), ours, bcfg, dtype=dtype)
        again = flatten_params(thf.load_hf_params(str(out), bcfg,
                                                  device="cpu"))
        for key, leaf in flat.items():
            assert again[key].dtype == torch.bfloat16
            assert torch.equal(again[key].view(torch.int16),
                               leaf.view(torch.int16)), (dtype, key)
        files = sorted(p for p in os.listdir(out)
                       if p.endswith(".safetensors"))
        tensors = safetensors.torch.load_file(str(out / files[0]))
        want_dtype = (torch.bfloat16 if dtype == "bfloat16"
                      else torch.float32)
        assert all(t.dtype == want_dtype for t in tensors.values())
