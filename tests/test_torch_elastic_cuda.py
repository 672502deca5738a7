"""PyTorch port, elastic recovery on the cards.

On two cards (skipped, in a fixture, with fewer): this file's rank side
under ``scaletorch_tpu_torch.launch --elastic``, one rank a card over
NCCL: Qwen3-0.6B's width cut to 2 layers at dp2, bf16 compute, a save
every 2 steps. Rank 1 is SIGKILLed inside the backward of step 4, so
rank 0 waits in the step's NCCL gradient all-reduce. An NCCL group is
not re-formed in place (``dist.can_reform_in_process``): NCCL's watchdog
ends rank 0 at the group's timeout (the elastic deadline, then its debug
dump's wait), the relaunched ranks give up at once (exit 43), and the
launcher restarts both ranks, which resume from step 2. Both end at step
6 with identical parameters, and rank 0's first process ended within
the watchdog's bound.

The file imports no JAX, so it runs on the GPU machine, where the
repository's conftest cannot load:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_elastic_cuda.py
"""

import hashlib
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
MODEL, LAYERS, SEQ, STEPS = "qwen3-0.6b", 2, 1024, 6
DEADLINE_S, TIMEOUT_S = 10.0, 900
# rank 0's end after the kill: the watchdog's deadline, then its debug
# dump's wait (60 s by default), the process's teardown
DETECT_LIMIT_S = DEADLINE_S + 60.0 + 30.0


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA cards: the ranks train through the CUDA "
                    "flash kernels over NCCL")
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 cards: one rank a card over NCCL")


def rank_side(directory: str) -> int:
    """One rank (``RANK``/``WORLD_SIZE`` from the launcher)."""
    sys.path.insert(0, str(ROOT))
    from scaletorch_tpu_torch import dist as stdist
    from scaletorch_tpu_torch.benchmark import make_bench_args
    from scaletorch_tpu_torch.models.convert import flatten_params
    from scaletorch_tpu_torch.resilience_distributed import (
        ElasticRemeshError,
    )
    from scaletorch_tpu_torch.trainer.optimizer import tree_leaves
    from scaletorch_tpu_torch.trainer.trainer import Trainer

    rank = int(os.environ["RANK"])
    cfg = make_bench_args(MODEL, seq=SEQ, gc=True, extra=dict(
        num_hidden_layers=LAYERS, data_parallel_size=2,
        distributed_launcher="env", elastic=True, resume="auto",
        checkpoint_dir=os.path.join(directory, "ckpt"), save_frequency=2,
        total_train_steps=STEPS, elastic_deadline_seconds=DEADLINE_S))
    try:
        t = Trainer(cfg)
    except ElasticRemeshError:  # a relaunched rank: no group re-forms
        os._exit(43)
    # the kill fires once, in the first process of rank 1
    marker = os.path.join(directory, "armed")
    if rank == 1 and not os.path.exists(marker):
        open(marker, "w").close()

        def die(grad):
            if t.global_step == 3:
                with open(os.path.join(directory, "killed_at"), "w") as f:
                    f.write(str(time.time()))
                os.kill(os.getpid(), signal.SIGKILL)
            return grad

        tree_leaves(t.params)[0].register_hook(die)
    resumed = t.global_step
    try:
        t.train()
    except ElasticRemeshError:  # the launcher restarts the fleet
        os._exit(43)
    digest = {n: hashlib.sha256(
        p.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8)
        .numpy().tobytes()).hexdigest()
        for n, p in flatten_params(t.params).items()}
    result = {"rank": rank, "attempt": stdist.restart_count(),
              "resumed": resumed, "step": t.global_step,
              "view": [t.elastic.view.epoch, list(t.elastic.view.members)],
              "counters": t.elastic.counters(), "digest": digest}
    t.close()
    with open(os.path.join(directory, f"result_r{rank}.json"), "w") as f:
        json.dump(result, f)
    stdist.shutdown_distributed()
    return 0


def test_a_kill_inside_the_backward_restarts_the_fleet(two_cards, tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "0,1"}
    cmd = [sys.executable, "-m", "scaletorch_tpu_torch.launch", "--nproc",
           "2", "--elastic", "--max-restarts", "1", "--membership-dir",
           str(tmp_path / "ckpt" / "membership"), "--rdzv-dir",
           str(tmp_path / "rdzv"), "--timeout", str(TIMEOUT_S),
           "--events", str(tmp_path / "events.jsonl"), "--",
           sys.executable, os.path.abspath(__file__), "--rank",
           str(tmp_path)]
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=TIMEOUT_S + 60)
    assert proc.returncode == 0, proc.stderr[-4000:]
    events = [json.loads(line) for line in
              (tmp_path / "events.jsonl").read_text().splitlines()]
    fin = {}
    for p in tmp_path.glob("result_r*.json"):
        r = json.loads(p.read_text())
        fin[r["rank"]] = r
    assert sorted(fin) == [0, 1], sorted(fin)
    for r in fin.values():
        assert (r["resumed"], r["step"], r["view"]) == (2, STEPS, [0, [0, 1]])
    assert fin[0]["digest"] == fin[1]["digest"]
    assert len([e for e in events if e["event"] == "fleet_restart"]) == 1
    killed = float((tmp_path / "killed_at").read_text())
    rank0_end = next(e["time"] for e in events
                     if e["event"] == "exit" and e["rank"] == 0)
    assert rank0_end - killed <= DETECT_LIMIT_S, rank0_end - killed


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_side(sys.argv[2]))
