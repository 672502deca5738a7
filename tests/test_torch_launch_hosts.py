"""PyTorch port, launching over several nodes, on the CPU.

* ``launch.py --nnodes 2``: two node launchers on this host (one rank
  each) train the same run as one ``--nproc 2`` launch, 2 dp steps over
  gloo: the checkpoints they save are equal (fp32, rtol 1e-5, atol
  1e-6); that launch's training CLI runs with ``--log_format json``, and
  every line it prints is a JSON object, the step records among them.
* ``tools/launch_hosts.py`` over a hosts file with a stand-in for ``ssh``
  (it runs the command here and records the host): the reference's
  restart policy (``scripts/launch_multihost.sh``): a host whose ranks
  exit 43 relaunches the whole fleet (the membership directory cleared
  before every fleet launch), exit 42 is never restarted and vetoes a
  pending restart; under ``--elastic`` a host's launcher relaunches its
  failed rank alone (the membership directory kept), ``--max-restarts
  M`` times in all, and the fan-out relaunches no host alone: a fleet
  down with a rank out of its budget is relaunched once, whole (one
  rank a host, and two); the ranks' ``RANK`` / ``WORLD_SIZE`` are
  ``node_rank·nproc + local_rank`` / ``nnodes·nproc``.
* The converter over the training CLI: a pp2 afab run's step-2
  checkpoint, converted to the interleaved layout, resumes under
  ``interleaved`` and matches an uninterrupted interleaved run after 2
  more steps (fp32, rtol 1e-5, atol 1e-6; the stream is a corpus file,
  whose position a resume restores, read by the CLI's ``Trainer`` with a
  letter tokenizer object); its resume without the conversion is
  refused.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from scaletorch_tpu_torch.tools import convert_layer_storage as conv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--model_type", "qwen3", "--vocab_size", "64", "--hidden_size",
        "32", "--intermediate_size", "64", "--num_hidden_layers", "4",
        "--num_attention_heads", "4", "--num_key_value_heads", "2",
        "--head_dim", "8", "--sequence_length", "16", "--dtype", "float32",
        "--param_dtype", "float32", "--learning_rate", "1e-3",
        "--async_checkpointing", "false", "--log_frequency", "100"]
ENV = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
for _name in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
              "LOCAL_RANK", "COORDINATOR_ADDRESS"):
    ENV.pop(_name, None)


def train_cmd(ckpt, steps, *extra, save=None):
    data = [] if "--dataset_name" in extra else ["--synthetic_data", "true"]
    return [sys.executable, "-m", "scaletorch_tpu_torch.train", "--device",
            "cpu", "--checkpoint_dir", str(ckpt), "--save_frequency",
            str(save or steps), "--total_train_steps", str(steps), *TINY,
            *data, *extra]


def start(nproc, cmd, *launch_args, timeout=240):
    """A launch of ``cmd`` (``launch.py --nproc``), running."""
    return subprocess.Popen(
        [sys.executable, "-m", "scaletorch_tpu_torch.launch", "--nproc",
         str(nproc), "--timeout", str(timeout), *launch_args, "--", *cmd],
        cwd=ROOT, env=ENV, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def finish(*procs):
    """Wait for launches started together; each one's output."""
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return logs


def saved(ckpt, step):
    state, meta = conv.read_step(os.path.join(str(ckpt), str(step)))
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[prefix + k] = v.numpy()

    walk(state, "")
    return flat, meta


def assert_close(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_two_nodes_equal_one_launch_of_two(tmp_path):
    dp = ["--data_parallel_size", "2"]
    one = start(2, train_cmd(tmp_path / "one", 2, *dp, "--log_format",
                             "json", "--log_frequency", "1"),
                "--rdzv-dir", str(tmp_path / "rdzv_one"))
    nodes = [start(1, train_cmd(tmp_path / "two", 2, *dp), "--nnodes", "2",
                   "--node-rank", str(i), "--rdzv-dir",
                   str(tmp_path / "rdzv_two")) for i in range(2)]
    one_log, *logs = finish(one, *nodes)
    # --log_format json: rank 0's lines are JSON objects, the step
    # records among them (the launcher's own lines are its events)
    records = [json.loads(ln) for ln in one_log.splitlines()
               if ln.strip() and not ln.startswith("[launch] ")]
    steps = [r for r in records if "loss" in r and "step" in r]
    assert [r["step"] for r in steps] == [1, 2]
    for r in steps:
        assert {"ts", "level", "proc", "lr", "grad_norm"} <= set(r)
        assert np.isfinite(r["loss"])
    a, meta_a = saved(tmp_path / "one", 2)
    b, meta_b = saved(tmp_path / "two", 2)
    assert meta_a["layout"] == meta_b["layout"] == {"stacked": "plain"}
    assert_close(a, b)
    # node 1's rank was global rank 1 of a world of 2
    starts = [json.loads(line.split("[launch] ", 1)[1]) for log in logs
              for line in log.splitlines() if "[launch] " in line
              and '"start"' in line]
    assert sorted(s["rank"] for s in starts) == [0, 1]


# a rank of a run fed from a corpus file (a stream whose position a
# resume restores; the synthetic stream starts again), tokenized by
# letters: the training CLI's run, with a tokenizer object in place of
# one loaded by name
LETTER_RANK = """\
import sys
from scaletorch_tpu_torch.config import parse_args
from scaletorch_tpu_torch.trainer.trainer import Trainer


class Letters:
    eos_token_id = 1

    def __call__(self, text, add_special_tokens=False):
        return {"input_ids": [2 + ord(c) - 97 for c in text]}


trainer = Trainer(parse_args(sys.argv[1:]), device="cpu",
                  tokenizer=Letters())
trainer.train()
trainer.close()
"""


def letter_data(root):
    """(the rank script, its data flags): a corpus of seeded letter
    strings."""
    (root / "rank.py").write_text(LETTER_RANK)
    rng = np.random.default_rng(3)
    with open(root / "train.jsonl", "w") as f:
        for _ in range(40):
            text = "".join(chr(97 + c) for c in rng.integers(0, 26, 40))
            f.write(json.dumps({"text": text}) + "\n")
    return str(root / "rank.py"), ["--dataset_name",
                                   str(root / "train.jsonl")]


def letter_cmd(script, ckpt, steps, *extra, save=None):
    return [sys.executable, script, *train_cmd(ckpt, steps, *extra,
                                               save=save)[5:]]


def test_converted_checkpoint_resumes_under_interleaved(tmp_path):
    script, data = letter_data(tmp_path)
    pp = ["--pipeline_parallel_size", "2", "--gradient_accumulation_steps",
          "2", *data]
    inter = pp + ["--pp_engine", "interleaved", "--pp_virtual_stages", "2"]
    # the schedule spans 4 steps in every run: the afab run is cut at
    # its step-2 checkpoint
    finish(start(2, letter_cmd(script, tmp_path / "afab", 4, *pp,
                               "--pp_engine", "afab", save=2),
                 "--rdzv-dir", str(tmp_path / "r1")),
           start(2, letter_cmd(script, tmp_path / "straight", 4, *inter),
                 "--rdzv-dir", str(tmp_path / "r2")))
    assert conv.main(["--ckpt", str(tmp_path / "afab"), "--step", "2",
                      "--out", str(tmp_path / "conv"), "--to",
                      "interleaved", "--pp", "2", "--vpp", "2"]) == 0
    finish(start(2, letter_cmd(script, tmp_path / "conv", 4, *inter,
                               "--resume", "must"),
                 "--rdzv-dir", str(tmp_path / "r3")))
    a, meta_a = saved(tmp_path / "conv", 4)
    b, meta_b = saved(tmp_path / "straight", 4)
    assert meta_a["layout"] == meta_b["layout"]
    assert meta_a["layout"]["stacked"] == "interleaved"
    assert_close(a, b)
    # without the conversion the interleaved run refuses the afab step
    from scaletorch_tpu_torch.utils.checkpoint import CheckpointManager

    why = CheckpointManager(str(tmp_path / "afab"),
                            layout=meta_b["layout"]).layout_mismatch(2)
    assert "scaletorch_tpu_torch.tools.convert_layer_storage" in why


# ---- the fan-out over hosts ---------------------------------------------------
RSH = """\
import os, subprocess, sys
host, script = sys.argv[1], sys.argv[2]
with open(os.environ["RSH_LOG"], "a") as f:
    f.write(host + " " + script.replace("\\n", " ") + "\\n")
sys.exit(subprocess.call(["sh", "-c", script]))
"""

# a rank: records its identity and its fleet launch, then exits with the
# code its global rank's script names for this run (the last one repeats)
RANK = """\
import json, os, sys
d = sys.argv[1]
rank = os.environ["RANK"]
path = os.path.join(d, f"rank{rank}.count")
n = int(open(path).read()) if os.path.exists(path) else 0
open(path, "w").write(str(n + 1))
record = {k: os.environ[k] for k in (
    "RANK", "WORLD_SIZE", "LOCAL_RANK", "NODE_RANK",
    "TORCHELASTIC_RESTART_COUNT")}
record["fleet"] = os.path.basename(os.path.dirname(
    os.environ["COORDINATOR_ADDRESS"]))
with open(os.path.join(d, "ranks.jsonl"), "a") as f:
    f.write(json.dumps(record) + "\\n")
codes = [int(c) for c in open(os.path.join(d, f"codes{rank}")).read().split()]
sys.exit(codes[min(n, len(codes) - 1)])
"""


def fan_out(tmp_path, codes, *args, nproc=1):
    """Run ``launch_hosts`` over two hosts ``h0``/``h1`` of ``nproc``
    ranks each; global rank ``r`` exits with ``codes[r]`` (a list: one
    code a run)."""
    for name, text in (("rsh.py", RSH), ("rank.py", RANK)):
        (tmp_path / name).write_text(text)
    (tmp_path / "hosts.txt").write_text("# rack-a\nh0\nh1\n")
    for rank, seq in enumerate(codes):
        (tmp_path / f"codes{rank}").write_text(" ".join(map(str, seq)))
    member = tmp_path / "membership"
    member.mkdir()
    (member / "epoch_7.json").write_text("{}")
    res = subprocess.run(
        [sys.executable, "-m", "scaletorch_tpu_torch.tools.launch_hosts",
         str(tmp_path / "hosts.txt"), "--nproc", str(nproc),
         "--rdzv-dir", str(tmp_path / "rdzv"),
         "--rsh", f"{sys.executable} {tmp_path / 'rsh.py'}",
         "--python", sys.executable, "--workdir", ROOT,
         "--membership-dir", str(member), "--timeout", "120",
         "--events", str(tmp_path / "events.jsonl"), *args, "--",
         sys.executable, str(tmp_path / "rank.py"), str(tmp_path)],
        cwd=ROOT, env={**ENV, "RSH_LOG": str(tmp_path / "rsh.log")},
        capture_output=True, text=True, timeout=180)
    events = [json.loads(line) for line in
              open(tmp_path / "events.jsonl")]
    ranks = [json.loads(line) for line in open(tmp_path / "ranks.jsonl")]
    return res, events, ranks


def starts(events):
    return [(e["node"], e["fleet"]) for e in events if e["event"] == "start"]


def test_fan_out_restarts_the_fleet_on_43(tmp_path):
    res, events, ranks = fan_out(tmp_path, [[0], [43, 0]],
                                 "--max-restarts", "1")
    assert res.returncode == 0, res.stderr[-3000:]
    assert starts(events) == [(0, 0), (1, 0), (0, 1), (1, 1)]
    assert sum(e["event"] == "clear_membership" for e in events) == 2
    assert not (tmp_path / "membership").exists()
    assert sorted((r["RANK"], r["WORLD_SIZE"], r["LOCAL_RANK"])
                  for r in ranks) == [("0", "2", "0")] * 2 + \
        [("1", "2", "0")] * 2
    # each host was reached through the stand-in, as itself
    hosts = [line.split()[0] for line in open(tmp_path / "rsh.log")]
    assert hosts.count("h0") >= 2 and hosts.count("h1") >= 2


@pytest.mark.parametrize("codes", [[[0], [42]], [[43], [42]]],
                         ids=["42", "42_vetoes_43"])
def test_fan_out_never_restarts_42(tmp_path, codes):
    res, events, _ = fan_out(tmp_path, codes, "--max-restarts", "3")
    assert res.returncode == 42, res.stderr[-3000:]
    assert starts(events) == [(0, 0), (1, 0)]
    assert not any(e["event"] == "fleet_restart" for e in events)


def test_fan_out_gives_up_after_max_restarts(tmp_path):
    res, events, _ = fan_out(tmp_path, [[0], [43]], "--max-restarts", "1")
    assert res.returncode == 43
    assert [e["fleet"] for e in events if e["event"] == "fleet_restart"] \
        == [1]


def test_elastic_fan_out_relaunches_the_failed_rank_alone(tmp_path):
    # host 1's rank fails once: its launcher relaunches it, and it
    # finishes; the fan-out starts each host once
    res, events, ranks = fan_out(tmp_path, [[0], [1, 0]], "--elastic",
                                 "--max-restarts", "1")
    assert res.returncode == 0, res.stderr[-3000:]
    assert starts(events) == [(0, 0), (1, 0)]
    # cleared once, before the fleet launch; never before the relaunch
    assert sum(e["event"] == "clear_membership" for e in events) == 1
    # the relaunched rank starts as a relaunch (it parks)
    node1 = [r for r in ranks if r["NODE_RANK"] == "1"]
    assert [r["TORCHELASTIC_RESTART_COUNT"] for r in node1] == ["0", "1"]


@pytest.mark.parametrize("nproc", [1, 2])
def test_elastic_rank_budget_is_max_restarts(tmp_path, nproc):
    # the last rank fails 3 times: at --max-restarts 2 its host's
    # launcher relaunches it twice and gives up once its other rank has
    # finished; the fan-out relaunches no host alone, and the fleet, down
    # with that rank unfinished, is relaunched once, whole, where it
    # finishes
    world = 2 * nproc
    codes = [[0]] * (world - 1) + [[1, 1, 1, 0]]
    res, events, ranks = fan_out(tmp_path, codes, "--elastic",
                                 "--max-restarts", "2", nproc=nproc)
    assert res.returncode == 0, res.stderr[-3000:]
    assert starts(events) == [(0, 0), (1, 0), (0, 1), (1, 1)]
    assert [e["fleet"] for e in events if e["event"] == "fleet_restart"] \
        == [1]
    assert sum(e["event"] == "clear_membership" for e in events) == 2
    runs = {(r["RANK"], r["fleet"]): [] for r in ranks}
    for r in ranks:
        runs[(r["RANK"], r["fleet"])].append(r["TORCHELASTIC_RESTART_COUNT"])
    last = str(world - 1)
    # 2 relaunches in all in the first fleet, none after the fleet's
    assert runs.pop((last, "fleet0")) == ["0", "1", "2"]
    assert runs.pop((last, "fleet1")) == ["0"]
    assert runs == {(str(r), f"fleet{f}"): ["0"] for r in range(world - 1)
                    for f in (0, 1)}
