"""PyTorch port, the hand-written CUDA paged-decode kernel on the card.

The kernel against its plain version at every geometry it is built for
(head_dim 16, 32, 64 and 128; n_rep 1 to 8, which covers every preset's:
dense-tiny's D 32, qwen3-14b's n_rep 5; and the audit entries' D 16), at contexts that span several
of its key splits (page sizes 1, 4, 16 and 64) and at one slot of 32768
keys; two calls equal bit for bit, on one stream and on two; a slot's
output the same bits alone and inside a batch of 8; and the paged
engine through the kernel against
the gather path at n_rep 2 / D 64 and n_rep 5 / D 32.
Every test here needs a CUDA card and skips without one (decided in a
fixture, at run time). The file imports no JAX, so it runs on the GPU
machine, where the repository's conftest (which sets JAX up) cannot load:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_paged_decode_cuda.py

Tolerances: fp32 2e-5 (the kernel and its plain version sum in other
orders); bf16 2e-2 (the plain version rounds the scores to bf16 before
the softmax, the kernel keeps them in fp32). Where contexts span several
splits, the worst slot's relative L2 error is held too: 1e-4 fp32, 3e-2
bf16, and 1e-2 bf16 at 32768 keys, where a dropped 16-key page moves a
slot's output by about 2% (that test checks that such a control fails).
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
SLOT_REL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
SLOT_REL_32768 = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the paged-decode kernel is CUDA C++ "
                    "built with nvcc for sm_90a and has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def inputs(dev, dtype, head_dim, n_rep, b=5, hkv=2, page=16, max_pages=9,
           positions=None):
    """Shuffled pages; positions at 0, both sides of a page boundary, the
    table's last key and one past the table's reach (``positions``
    replaces them, one per slot)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1000 * n_rep + head_dim)
    if positions is not None:
        b = len(positions)
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
    if positions is None:
        positions = [0, page - 1, page, last, last + 5]
    positions = torch.tensor(positions, dtype=torch.int32, device=dev)
    return q, pool_k, pool_v, tables, positions


def slot_rel_max(out, ref):
    """The largest relative L2 error of one slot's output [Hq, D]."""
    diff = (out.float() - ref.float()).flatten(1).norm(dim=1)
    return float((diff / ref.float().flatten(1).norm(dim=1)).max())


def errors(args):
    """The kernel against its plain version: (max abs, worst slot's
    relative L2 error), and the kernel's output."""
    out = tpa.paged_decode_attention(*args)
    ref = tpa.paged_decode_attention_ref(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    return float((out.float() - ref.float()).abs().max()), \
        slot_rel_max(out, ref), out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
@pytest.mark.parametrize("n_rep", [1, 2, 3, 4, 5, 6, 7, 8])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("n_rep,head_dim", [(1, 64), (5, 128), (8, 32),
                                            (2, 16)])
@pytest.mark.parametrize("page", [1, 4, 16, 64])
def test_contexts_across_several_splits(cuda, dtype, n_rep, head_dim, page):
    """Positions on both sides of split boundaries, in the fourth split,
    at the table's last key and past it: tiles straddle pages at every
    page size, and slots of one batch span 1 to 5 splits."""
    kps = tpa.keys_per_split()
    max_pages = -(-(4 * kps + 100) // page)
    last = max_pages * page - 1
    args = inputs(cuda, dtype, head_dim, n_rep, page=page,
                  max_pages=max_pages,
                  positions=[0, kps - 1, kps, kps + 1, 3 * kps + 17, last,
                             last + 5])
    abs_err, slot_rel, _ = errors(args)
    assert abs_err <= TOL[dtype]
    assert slot_rel <= SLOT_REL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_two_calls_equal_bit_for_bit(cuda, dtype):
    args = inputs(cuda, dtype, 128, 8, page=16, max_pages=64,
                  positions=[5, 300, 1023, 700, 1000])
    first = tpa.paged_decode_attention(*args)
    second = tpa.paged_decode_attention(*args)
    assert torch.equal(first, second)


def test_each_stream_has_its_counters_and_leaves_them_zero(cuda):
    """The last split of a (slot, head) resets its counter: a call on a
    second stream (its own counters) gives the same bits, and every
    counter is 0 afterwards."""
    args = inputs(cuda, torch.bfloat16, 64, 4, page=16, max_pages=64,
                  positions=[1000, 300, 5, 1023])
    first = tpa.paged_decode_attention(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        second = tpa.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    streams = {key for key in tpa._split_counters if key[0] == first.device}
    assert len(streams) >= 2
    for buf in tpa._split_counters.values():
        assert int(buf.abs().sum()) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_a_slot_alone_and_in_a_batch_agree_bit_for_bit(cuda, dtype):
    q, pk, pv, tables, positions = inputs(
        cuda, dtype, 128, 2, page=16, max_pages=80,
        positions=[0, 15, 256, 511, 700, 1279, 1000, 1300])
    batch = tpa.paged_decode_attention(q, pk, pv, tables, positions)
    for i in range(q.shape[0]):
        alone = tpa.paged_decode_attention(
            q[i:i + 1].contiguous(), pk, pv, tables[i:i + 1].contiguous(),
            positions[i:i + 1].contiguous())
        assert torch.equal(alone[0], batch[i]), f"slot {i}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_one_slot_of_32768_keys(cuda, dtype):
    """Qwen3-0.6B's heads (16 / 8, D 128), page 16, the whole table; the
    plain version without the slot's middle page must fail the worst-slot
    check."""
    q, pk, pv, tables, positions = args = inputs(
        cuda, dtype, 128, 2, hkv=8, page=16, max_pages=2048,
        positions=[32767])
    abs_err, slot_rel, out = errors(args)
    assert abs_err <= TOL[dtype]
    assert slot_rel <= SLOT_REL_32768[dtype]
    dropped = tables.clone()
    dropped[0, 1024:-1] = tables[0, 1025:]
    control = tpa.paged_decode_attention_ref(q, pk, pv, dropped,
                                             positions - 16)
    assert slot_rel_max(out, control) > SLOT_REL_32768[dtype]


def test_a_short_workspace_is_refused(cuda):
    q, pk, pv, tables, positions = inputs(cuda, torch.float32, 64, 2,
                                          max_pages=40)
    lib, fn, kps = tpa._load_kernel()
    b, hq, d = q.shape
    splits = tpa.split_plan(40, 16, kps)
    assert splits > 1
    need = 4 * splits * b * hq * (d + 2)
    work = torch.empty(need // 4, device=cuda)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    counters = torch.zeros(b * 2, dtype=torch.int32, device=cuda)

    def call(nbytes):
        return fn(q.data_ptr(), pk.data_ptr(), pv.data_ptr(),
                  tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
                  work.data_ptr(), nbytes, counters.data_ptr(),
                  counters.numel(), b, hq, 2, d, 16, 40, 0.125, 0, stream)

    assert call(need - 4) != 0
    assert call(need) == 0
    torch.cuda.synchronize()


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
        tpa.paged_decode_attention(q[..., :48].contiguous(),
                                   pk[..., :48].contiguous(),
                                   pv[..., :48].contiguous(), tables,
                                   positions)
    with pytest.raises(ValueError, match="query heads per kv head"):
        tpa.paged_decode_attention(torch.cat([q] * 5, dim=1), pk, pv, tables,
                                   positions)
    with pytest.raises(TypeError, match="int32"):
        tpa.paged_decode_attention(q, pk, pv, tables.long(), positions)


@pytest.mark.parametrize("heads,head_dim", [((4, 2), 64), ((10, 2), 32)],
                         ids=["n_rep2_d64", "n_rep5_d32"])
def test_engine_kernel_and_gather_path_agree(cuda, heads, head_dim):
    cfg = LlamaConfig(vocab_size=256, hidden_size=128, intermediate_size=256,
                      num_hidden_layers=2, num_attention_heads=heads[0],
                      num_key_value_heads=heads[1], head_dim=head_dim,
                      qk_norm=True, tie_word_embeddings=True,
                      dtype=torch.float32)
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
