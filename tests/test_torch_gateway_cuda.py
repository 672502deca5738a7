"""PyTorch port, the serving gateway over graphed engines on the card.

An in-process ``ServingGateway`` drives the paged engine from its
``EngineWorker`` thread, a thread other than the one that captured the
engine's CUDA graphs. At small widths that the kernels take (head_dim
32):

  * the SSE-streamed greedy tokens equal the same engine driven
    directly, bit for bit, and every request ends in one ``done``;
  * each step is still captured once (replays from the worker thread
    make no second capture), and the paged-decode kernel (K4) ran on the
    main path: its launches equal warm-ups + layers x decode replays;
  * a disaggregated engine (``"1:1"``, both slices on the card) behind
    the gateway streams the colocated engine's tokens, K4 on its decode
    pool.

Every test needs a CUDA card and skips without one (decided in a
fixture, at run time). The file imports no JAX, so it runs on the GPU
machine:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_gateway_cuda.py
"""

import json
import urllib.request

import pytest
import torch

from scaletorch_tpu_torch.inference import (
    DisaggregatedEngine,
    InferenceEngine,
    SamplingParams,
)
from scaletorch_tpu_torch.models import LlamaConfig
from scaletorch_tpu_torch.models import llama as tllama
from scaletorch_tpu_torch.ops import _build
from scaletorch_tpu_torch.serving.gateway import ServingGateway
from scaletorch_tpu_torch.serving.protocol import (
    parse_sse_stream,
    stream_tokens,
)

pytestmark = pytest.mark.cuda

KW = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
          head_dim=32, qk_norm=True, max_position_embeddings=512)
ENGINE = dict(max_slots=4, max_seq=64, prefill_len=32, page_size=8,
              cache_layout="paged", sampling=SamplingParams(temperature=0.0))
PROMPTS = [[1, 2, 3], [9] * 17, [9] * 17 + [4, 5], [7, 8, 9, 10, 11]]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the engine captures CUDA graphs "
                    "and its kernels are CUDA C++ built for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def model():
    cfg = LlamaConfig(**KW, dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    return cfg, tllama.LlamaForCausalLM.from_params(
        tllama.init_params(cfg, gen, "cuda"), cfg)


def direct_tokens(m, cfg, prompt, n):
    eng = InferenceEngine(m, cfg, **ENGINE)
    rid = eng.submit(prompt, max_new_tokens=n)
    return eng.run()[rid].tokens


def stream(port, prompt, n):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps({"prompt": prompt, "max_new_tokens": n}).encode(),
        method="POST")
    events = parse_sse_stream(urllib.request.urlopen(req, timeout=120).read())
    dones = [d for e, d in events if e == "done"]
    assert len(dones) == 1 and dones[0]["outcome"] == "ok"
    return stream_tokens(events)


@pytest.mark.parametrize("disaggregated", [False, True],
                         ids=["colocated", "disagg_1_1"])
def test_sse_tokens_equal_the_direct_engine(cuda, disaggregated):
    cfg, m = model()
    want = [direct_tokens(m, cfg, p, 12) for p in PROMPTS]
    _build.reset_launch_counts()
    if disaggregated:
        eng = DisaggregatedEngine(m, cfg, devices=["cuda:0", "cuda:0"],
                                  disagg_split="1:1", **ENGINE)
    else:
        eng = InferenceEngine(m, cfg, **ENGINE)
    warm = _build.launch_counts["paged_decode"]
    gw = ServingGateway(eng, port=0).start_in_thread()
    try:
        got = [stream(gw.port, p, 12) for p in PROMPTS]
    finally:
        gw.stop_sync()
    gw.metrics.check_conservation()
    assert got == want
    assert eng.decode_compile_count == eng.prefill_compile_count == 1
    assert eng._decode.captures == eng._prefill.captures == 1
    per_replay = eng._decode.captured_launches["paged_decode"]
    assert per_replay == cfg.num_hidden_layers
    replays = eng._decode.replays
    assert replays > 0
    assert _build.launch_counts["paged_decode"] == \
        warm + per_replay * replays
    if disaggregated:
        assert eng.metrics.handoffs == len(PROMPTS)
        eng.check_conservation()
    else:
        eng.allocator.check_conservation()
