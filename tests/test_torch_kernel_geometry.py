"""PyTorch port, the head geometries the attention kernels are built for.

Every preset of ``models/presets.py`` is served by the paged-decode kernel
K4 and trained through the flash kernels K1-K3 on the card, so the
wrappers' input checks (which run before any launch, and so hold on CPU
tensors too) must accept each preset's n_rep and head_dim: n_rep 2, 4, 5
and 8, head_dim 32, 64 and 128 (K4 is built for every n_rep of 1 to 8).
K1-K3 are also built for head_dim 16, the heads of the moe, pipeline and
long-context examples (K4 is not: no example serves at D 16). Outside
the built set (head_dim 48, 256; 16 for K4; K4's n_rep past 8) they still
raise, with no quiet fallback.

The plain versions (what the kernels are held against on the card) at the
new geometries, n_rep 5 (qwen3-14b: 40 query over 8 KV heads) and
head_dim 32 (dense-tiny, moe-tiny), against the JAX package's Pallas
kernels in interpret mode: fp32, max abs 1e-5 for paged decode and 2e-5
for flash (the same limits as ``test_torch_paged_attention.py`` and
``test_torch_flash.py``; the two sum in other orders).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaletorch_tpu.ops.pallas import flash as jflash
from scaletorch_tpu_torch.models.presets import MODEL_PRESETS, model_config
from scaletorch_tpu_torch.ops import flash as tflash

jpa = importlib.import_module("scaletorch_tpu.ops.pallas.paged_attention")
tpa = importlib.import_module("scaletorch_tpu_torch.ops.paged_attention")

PAGE = 4
PAGED_ATOL = 1e-5
FLASH_ATOL = 2e-5


def geometry(name):
    cfg = model_config(name)
    hq, hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    return hq, hkv, cfg.actual_head_dim


def paged_inputs(hq, hkv, d, dtype=torch.float32, b=2, max_pages=3):
    """CPU tensors shaped as the engine hands them to K4."""
    q = torch.zeros(b, hq, d, dtype=dtype)
    pool = torch.zeros(b * max_pages + 1, hkv, PAGE, d, dtype=dtype)
    tables = torch.arange(1, b * max_pages + 1, dtype=torch.int32)
    positions = torch.tensor([0, max_pages * PAGE - 1], dtype=torch.int32)
    return (q, pool, pool.clone(), tables.view(b, max_pages).contiguous(),
            positions)


def flash_inputs(hq, hkv, d, dtype=torch.float32, b=1, s=8):
    return (torch.zeros(b, hq, s, d, dtype=dtype),
            torch.zeros(b, hkv, s, d, dtype=dtype),
            torch.zeros(b, hkv, s, d, dtype=dtype))


def test_presets_cover_the_new_geometries():
    seen = {geometry(name) for name in MODEL_PRESETS}
    assert {hq // hkv for hq, hkv, _ in seen} == {2, 4, 5, 8}
    assert {d for _, _, d in seen} == {32, 64, 128}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", sorted(MODEL_PRESETS))
def test_paged_decode_checks_accept_every_preset(name, dtype):
    hq, hkv, d = geometry(name)
    assert hq // hkv in tpa.SUPPORTED_N_REP and d in tpa.SUPPORTED_HEAD_DIMS
    tpa._check_kernel_inputs(*paged_inputs(hq, hkv, d, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", sorted(MODEL_PRESETS))
def test_flash_checks_accept_every_preset(name, dtype):
    hq, hkv, d = geometry(name)
    q, k, v = flash_inputs(hq, hkv, d, dtype)
    stats = torch.zeros(q.shape[:3])
    tflash._check_qkv(q, k, v)
    tflash._check_qkv(q, k, v, dout=q.clone(), lse=stats, delta=stats)


@pytest.mark.parametrize("head_dim", [16, 48, 256])
def test_paged_decode_checks_reject_unbuilt_head_dims(head_dim):
    with pytest.raises(ValueError, match="head_dim"):
        tpa._check_kernel_inputs(*paged_inputs(8, 4, head_dim))


@pytest.mark.parametrize("hq,hkv", [(9, 1), (32, 2), (36, 4)])
def test_paged_decode_checks_reject_n_rep_past_eight(hq, hkv):
    with pytest.raises(ValueError, match="query heads per kv head"):
        tpa._check_kernel_inputs(*paged_inputs(hq, hkv, 64))


@pytest.mark.parametrize("head_dim", [48, 256])
def test_flash_checks_reject_unbuilt_head_dims(head_dim):
    with pytest.raises(ValueError, match="head_dim"):
        tflash._check_qkv(*flash_inputs(8, 4, head_dim))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (1, 1), (4, 2)])
def test_flash_checks_accept_the_examples_head_dim_16(hq, hkv, dtype):
    """The long-context example's heads (4 of D 16; one a rank under
    Ulysses cp4) and a grouped case pass the launch checks."""
    q, k, v = flash_inputs(hq, hkv, 16, dtype)
    stats = torch.zeros(q.shape[:3])
    assert 16 in tflash.SUPPORTED_HEAD_DIMS
    tflash._check_qkv(q, k, v)
    tflash._check_qkv(q, k, v, dout=q.clone(), lse=stats, delta=stats)


def pool_and_tables(n_rep, d, seed, b=3, hkv=2, max_pages=6):
    """Shuffled physical pages, positions at 0, a page boundary and the
    last slot (``test_torch_paged_attention.py``'s problem at any D)."""
    rng = np.random.default_rng(seed)
    n_pages = b * max_pages + 2
    pool_k = rng.standard_normal((n_pages, hkv, PAGE, d)).astype(np.float32)
    pool_v = rng.standard_normal((n_pages, hkv, PAGE, d)).astype(np.float32)
    tables = (rng.permutation(n_pages - 2) + 1).astype(np.int32)
    q = rng.standard_normal((b, hkv * n_rep, d)).astype(np.float32)
    positions = np.array([0, PAGE, max_pages * PAGE - 1], np.int32)
    return q, pool_k, pool_v, tables.reshape(b, max_pages), positions


@pytest.mark.parametrize("n_rep,head_dim", [(5, 32), (5, 128), (1, 32),
                                            (8, 32)])
def test_paged_decode_plain_version_matches_pallas(n_rep, head_dim):
    arrays = pool_and_tables(n_rep, head_dim, seed=n_rep + head_dim)
    out_j = np.asarray(jpa.pallas_paged_decode_attention(
        *(jnp.asarray(a) for a in arrays), interpret=True))
    out_t = tpa.paged_decode_attention(*(torch.from_numpy(a)
                                         for a in arrays))
    assert out_t.shape == arrays[0].shape
    np.testing.assert_allclose(out_t.numpy(), out_j, atol=PAGED_ATOL,
                               rtol=PAGED_ATOL)


@pytest.mark.parametrize("n_rep,head_dim", [(5, 32), (5, 64), (2, 32),
                                            (1, 16), (4, 16)])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_plain_versions_match_pallas(n_rep, head_dim, causal):
    """K1-K3's plain versions (the port's op on CPU tensors), forward and
    gradients, against the Pallas kernels in interpret mode."""
    rng = np.random.default_rng(7 * n_rep + head_dim)
    hkv, s = 2, 96

    def rnd(heads):
        return rng.standard_normal((1, heads, s, head_dim)).astype(np.float32)

    q, k, v, g = rnd(hkv * n_rep), rnd(hkv), rnd(hkv), rnd(hkv * n_rep)
    out_j, vjp = jax.vjp(
        lambda a, b, c: jflash.pallas_flash_attention(
            a, b, c, causal=causal, block_q=64, block_kv=64, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_j = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out_t = tflash.flash_attention(*leaves, causal=causal)
    out_t.backward(torch.from_numpy(g))
    for got, want in zip([out_t] + [t.grad for t in leaves],
                         (out_j,) + tuple(grads_j)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=FLASH_ATOL, rtol=0)
