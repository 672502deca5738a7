"""PyTorch port, GPT-MoE on the card.

  * a 2-layer GPT-MoE at the minGPT heads (4 heads of 32) served by the
    paged engine, its decode through the CUDA paged-decode kernel (K4),
    against the same engine on the gather path: greedy tokens equal at
    the dropless capacity factor 4.0; one capture of each step; K4 2
    launches a decode replay (one a layer), none in the prefill;
  * ``sorted_moe_forward`` at world 1 on the card against its dense
    per-token loop;
  * the model zoo's draws and MLA's latent cache default to the card.

Every test needs a CUDA card and skips without one (decided in a
fixture, at run time). The file imports no JAX, so it runs on the GPU
machine:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_gpt_moe_cuda.py
"""

import pytest
import torch
import torch.nn.functional as F

from scaletorch_tpu_torch.inference import (
    InferenceEngine,
    SamplingParams,
    init_mla_cache,
)
from scaletorch_tpu_torch.models import attention as att
from scaletorch_tpu_torch.models import gpt_moe as tg
from scaletorch_tpu_torch.models import lenet
from scaletorch_tpu_torch.ops import _build
from scaletorch_tpu_torch.ops import paged_attention as pa
from scaletorch_tpu_torch.parallel import expert_parallel as tep

pytestmark = pytest.mark.cuda

CFG = tg.GPTMoEConfig(block_size=128, vocab_size=65, n_layer=2, n_head=4,
                      n_embd=128, num_experts=8, top_k=2,
                      capacity_factor=4.0)
ENGINE = dict(max_slots=4, max_seq=128, prefill_len=64, page_size=16,
              cache_layout="paged", sampling=SamplingParams(temperature=0.0))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the engine captures CUDA graphs "
                    "and K4 is CUDA C++ built for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def served(model, paged_kernel):
    gen = torch.Generator().manual_seed(3)
    _build.launch_counts.clear()
    eng = InferenceEngine(model, CFG, paged_kernel=paged_kernel, **ENGINE)
    ids = [eng.submit(torch.randint(0, 65, (n,), generator=gen).tolist(),
                      max_new_tokens=24) for n in (5, 17, 40, 33, 9, 60)]
    results = eng.run()
    assert eng.decode_compile_count == eng.prefill_compile_count == 1
    assert all(results[i].outcome == "ok" for i in ids)
    return [results[i].tokens for i in ids], eng


def test_paged_engine_through_k4_equals_the_gather_path(cuda):
    # random weights at the init's std answer with one token: scale them
    model = tg.GPTMoEForCausalLM.from_params(tg.scale_matrices(
        tg.init_params(torch.Generator(device="cuda").manual_seed(0), CFG),
        10.0), CFG, cuda)
    gather, _ = served(model, False)
    assert not _build.launch_counts[pa.KERNEL_NAME]
    kernel, eng = served(model, None)
    assert kernel == gather
    assert any(len(set(t)) > 1 for t in kernel)
    assert eng._decode.captured_launches[pa.KERNEL_NAME] == CFG.n_layer
    assert not eng._prefill.captured_launches[pa.KERNEL_NAME]


def test_sorted_moe_forward_at_world_one(cuda):
    gen = torch.Generator(device="cuda").manual_seed(1)
    n, h, i, e, k = 96, 128, 256, 4, 2
    x = torch.randn(n, h, device=cuda, generator=gen)
    ws = [torch.randn(s, device=cuda, generator=gen) * 0.05
          for s in ((e, h, i), (e, h, i), (e, i, h))]
    gate_idx = torch.randint(0, e, (n, k), device=cuda, generator=gen)
    gate_w = torch.rand(n, k, device=cuda, generator=gen)
    got = tep.sorted_moe_forward(x, gate_idx, gate_w, *ws, axis=None,
                                 num_experts=e)
    want = torch.zeros_like(x, dtype=torch.float64)
    g, u, d = (w.double() for w in ws)
    for j in range(k):
        sel = gate_idx[:, j]
        xd = x.double()
        hid = F.silu(torch.einsum("nh,nhi->ni", xd, g[sel])) * torch.einsum(
            "nh,nhi->ni", xd, u[sel])
        want += gate_w[:, j, None].double() * torch.einsum(
            "ni,nih->nh", hid, d[sel])
    torch.testing.assert_close(got.double(), want, atol=1e-4, rtol=0)


def test_the_zoo_defaults_to_the_card(cuda):
    """GPT-MoE's and LeNet's draws and MLA's latent cache land on the card
    when no device is named; one CPU generator draws the same weights for
    the card and the CPU."""
    def draw(**kw):
        return tg.init_params(torch.Generator().manual_seed(0), CFG, **kw)

    card, cpu = draw(), draw(device="cpu")
    for name in ("wte", "wpe", "ln_f"):
        assert card[name].is_cuda
        assert torch.equal(card[name].cpu(), cpu[name])
    assert all(t.is_cuda for t in card["layers"].values())
    assert all(t.is_cuda for t in lenet.init_params().values())
    acfg = att.AttentionConfig(embed_dim=64, num_heads=4, kv_lora_rank=16)
    mla = att.MultiHeadLatentAttention(acfg)
    assert all(t.is_cuda for t in mla.init().values())
    assert mla.init_cache(2, 8).is_cuda
    assert init_mla_cache(acfg, 2, 8).latent.is_cuda
