"""PyTorch port, the hand-written CUDA paged-decode kernel on the card.

Every test here needs a CUDA card and skips without one (decided in a
fixture, at run time). The file imports no JAX, so it runs on the GPU
machine, where the repository's conftest (which sets JAX up) cannot load:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_paged_decode_cuda.py

Tolerances: fp32 2e-5 (the kernel and its plain version sum in other
orders); bf16 2e-2 (the plain version rounds the scores to bf16 before
the softmax, the kernel keeps them in fp32).
"""

import importlib

import pytest
import torch

from scaletorch_tpu_torch.inference import InferenceEngine, SamplingParams
from scaletorch_tpu_torch.models import LlamaConfig, init_params
from scaletorch_tpu_torch.ops import _build

tpa = importlib.import_module("scaletorch_tpu_torch.ops.paged_attention")

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the paged-decode kernel is CUDA C++ "
                    "built with nvcc for sm_90a and has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def inputs(dev, dtype, head_dim, n_rep, b=5, hkv=2, page=16, max_pages=9):
    """Shuffled pages; positions at 0, both sides of a page boundary, the
    table's last key and one past the table's reach."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1000 * n_rep + head_dim)
    n_pages = b * max_pages + 1
    pool_k = torch.randn(n_pages, hkv, page, head_dim, generator=gen,
                         device=dev).to(dtype)
    pool_v = torch.randn(n_pages, hkv, page, head_dim, generator=gen,
                         device=dev).to(dtype)
    q = torch.randn(b, hkv * n_rep, head_dim, generator=gen,
                    device=dev).to(dtype)
    tables = (torch.randperm(n_pages - 1, generator=gen, device=dev) + 1)
    tables = tables.to(torch.int32).view(b, max_pages).contiguous()
    last = max_pages * page - 1
    positions = torch.tensor([0, page - 1, page, last, last + 5],
                             dtype=torch.int32, device=dev)
    return q, pool_k, pool_v, tables, positions


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
def test_kernel_matches_plain_version(cuda, dtype, head_dim, n_rep):
    args = inputs(cuda, dtype, head_dim, n_rep)
    before = _build.launch_counts[tpa.KERNEL_NAME]
    out = tpa.paged_decode_attention(*args)
    ref = tpa.paged_decode_attention_ref(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts[tpa.KERNEL_NAME] == before + 1
    assert out.dtype == dtype and out.shape == args[0].shape
    assert torch.isfinite(out).all()
    assert float((out.float() - ref.float()).abs().max()) <= TOL[dtype]


def test_dispatcher_sends_decode_to_the_kernel(cuda):
    q, pk, pv, tables, positions = inputs(cuda, torch.float32, 64, 2)
    before = _build.launch_counts[tpa.KERNEL_NAME]
    out = tpa.paged_attention(q[:, :, None], pk, pv, tables,
                              positions[:, None], page_size=16)
    gather = tpa.paged_attention(q[:, :, None], pk, pv, tables,
                                 positions[:, None], page_size=16,
                                 kernel=False)
    torch.cuda.synchronize()
    assert _build.launch_counts[tpa.KERNEL_NAME] == before + 1
    assert float((out - gather).abs().max()) <= TOL[torch.float32]
    with pytest.raises(ValueError, match="single-token"):
        tpa.paged_attention(q[:, :, None].expand(-1, -1, 2, -1), pk, pv,
                            tables, positions[:, None].expand(-1, 2),
                            page_size=16, kernel=True)


def test_unsupported_shapes_raise_before_launch(cuda):
    q, pk, pv, tables, positions = inputs(cuda, torch.float32, 64, 2)
    with pytest.raises(ValueError, match="head_dim"):
        tpa.paged_decode_attention(q[..., :32].contiguous(),
                                   pk[..., :32].contiguous(),
                                   pv[..., :32].contiguous(), tables,
                                   positions)
    with pytest.raises(TypeError, match="int32"):
        tpa.paged_decode_attention(q, pk, pv, tables.long(), positions)


def test_engine_kernel_and_gather_path_agree(cuda):
    cfg = LlamaConfig(vocab_size=256, hidden_size=128, intermediate_size=256,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, head_dim=64, qk_norm=True,
                      tie_word_embeddings=True, dtype=torch.float32)
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    prompts = [[(7 * i + j) % 256 for j in range(5 + 3 * i)]
               for i in range(5)]
    runs = []
    for kernel in (None, False):
        eng = InferenceEngine(params, cfg, max_slots=3, max_seq=64,
                              prefill_len=32, page_size=16,
                              cache_layout="paged", paged_kernel=kernel,
                              sampling=SamplingParams(temperature=0.0))
        _build.reset_launch_counts()
        ids = [eng.submit(p, max_new_tokens=12) for p in prompts]
        with torch.inference_mode():
            results = eng.run()
        launches = _build.launch_counts[tpa.KERNEL_NAME]
        runs.append(([results[i].tokens for i in ids], launches,
                      eng.metrics.decode_steps))
        eng.allocator.check_conservation()
    (tok_k, launches_k, steps), (tok_g, launches_g, _) = runs
    assert tok_k == tok_g
    assert launches_k == cfg.num_hidden_layers * steps
    assert launches_g == 0
