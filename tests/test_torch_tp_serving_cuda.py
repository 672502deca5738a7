"""PyTorch port, serving over a tensor-parallel mesh on the cards.

On two cards (skipped, in a fixture, with fewer): ``torch.distributed.run``
of this file's rank side, one rank a card over NCCL: Qwen3-0.6B's width
cut to 2 layers, fp32, random weights drawn by ``init_weights_`` from
one seed, served by a paged engine over tp2 (its steps captured as CUDA
graphs with the all-reduces inside) and by the one-card engine on every
rank: the greedy tokens of 4 requests equal, on both ranks; one capture
of each step; K4 once a layer per decode replay; and the teacher-forced
logits of the tp2 model (paged, through K4) within 1e-3 of one card's.

The file imports no JAX, so it runs on the GPU machine, where the
repository's conftest cannot load:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_tp_serving_cuda.py
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
MODEL, LAYERS, TP = "qwen3-0.6b", 2, 2
PARITY = 1e-3  # max |dlogit|, fp32 (chip_smoke.PARITY_TOLERANCE)
TIMEOUT_S = 600


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA cards: the engine captures its steps as CUDA "
                    "graphs and K4 is CUDA C++ built for sm_90a")
    if torch.cuda.device_count() < TP:
        pytest.skip(f"needs {TP} cards: one rank a card over NCCL")


def rank_side(out_dir: str) -> None:
    """One rank: the tp2 engine and the one-card engine on this card."""
    sys.path.insert(0, str(ROOT))
    from scaletorch_tpu_torch import dist as stdist
    from scaletorch_tpu_torch.inference import (
        InferenceEngine,
        SamplingParams,
        teacher_forced_decode_paged,
    )
    from scaletorch_tpu_torch.inference.kv_cache import (
        paged_kv_cache_shardings,
    )
    from scaletorch_tpu_torch.models import LlamaForCausalLM, model_config
    from scaletorch_tpu_torch.ops import _build
    from scaletorch_tpu_torch.parallel.mesh import (
        MeshManager,
        using_mesh_manager,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    stdist.init_distributed("env")
    dev = torch.device("cuda", stdist.local_rank())
    cfg = model_config(MODEL, dtype=torch.float32, num_hidden_layers=LAYERS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen,
                             device=dev).tolist() for n in (5, 17, 40, 64)]
    tokens = torch.randint(0, cfg.vocab_size, (2, 48), generator=gen,
                           device=dev)
    out = {}
    for which in ("one_card", "tp2"):
        mm = MeshManager(tp=TP, device_type="cuda") if which == "tp2" \
            else None
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        model = LlamaForCausalLM(cfg, dev, mesh=mm).init_weights_(gen)
        _build.reset_launch_counts()
        eng = InferenceEngine(model, cfg, max_slots=4, max_seq=256,
                              prefill_len=64,
                              sampling=SamplingParams(temperature=0.0),
                              cache_layout="paged", page_size=16, device=dev,
                              mesh=mm)
        ids = [eng.submit(p, max_new_tokens=16) for p in prompts]
        results = eng.run()
        with using_mesh_manager(mm), torch.inference_mode():
            logits = teacher_forced_decode_paged(
                model, cfg, tokens, page_size=16,
                sharding=paged_kv_cache_shardings(mm) if mm else None)
        out[which] = {
            "tokens": [results[i].tokens for i in ids],
            "outcomes": [results[i].outcome for i in ids],
            "compiles": [eng.prefill_compile_count,
                         eng.decode_compile_count],
            "k4_per_replay": eng._decode.captured_launches.get(
                "paged_decode", 0),
            "logits": logits}
        del eng, model
        if mm is not None:
            mm.destroy()
    diff = float((out["tp2"]["logits"] - out["one_card"]["logits"])
                 .abs().max())
    mine = {k: {n: v for n, v in r.items() if n != "logits"}
            for k, r in out.items()}
    mine["logits_max_abs"] = diff
    ranks = stdist.all_gather_object(mine)
    if stdist.process_index() == 0:
        with open(os.path.join(out_dir, "result.json"), "w") as f:
            json.dump(ranks, f)
    stdist.shutdown_distributed()


def test_tp2_serving_matches_one_card(two_cards, tmp_path):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={TP}", str(Path(__file__).resolve()),
           "--rank-side", str(tmp_path)]
    proc = subprocess.Popen(cmd, cwd=ROOT, start_new_session=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        log, _ = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        pytest.fail(f"no end within {TIMEOUT_S} s:\n{log.decode()[-4000:]}")
    assert proc.returncode == 0, log.decode()[-4000:]
    ranks = json.loads((tmp_path / "result.json").read_text())
    assert len(ranks) == TP
    for r in ranks:
        assert r["tp2"]["outcomes"] == ["ok"] * 4
        assert r["tp2"]["tokens"] == r["one_card"]["tokens"]
        assert r["tp2"]["tokens"] == ranks[0]["tp2"]["tokens"]
        assert r["tp2"]["compiles"] == [1, 1]
        assert r["tp2"]["k4_per_replay"] == LAYERS
        assert r["logits_max_abs"] <= PARITY


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-side"]:
        rank_side(sys.argv[2])
