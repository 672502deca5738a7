"""PyTorch port, the operator's tools (``scaletorch_tpu_torch/tools/``)
against the reference's, on the CPU at small sizes.

* ``convert_layer_storage``: on seeded numpy trees (parameters and an
  AdamW or Adafactor state, factored statistics and size-1 placeholders
  included), the port's conversion equals the reference's
  ``_permute_layers_subtrees`` / ``_interleaved_layer_order`` (and its
  ``pad_stacked_params`` / ``unpad_stacked_params`` for the padded
  split) applied to the same arrays, exactly, in both directions; its
  refusals; the checkpoint's layout refusal names the tool.
* ``verify_weights``: its self-test passes, with the ``transformers``
  comparison run; a checkpoint with a tensor dropped and one with a NaN
  weight fail; the reference's ``verify_one`` gives the same verdicts
  on the same three directories.
* ``slo_check``: the reference's CLI inputs (``tests/serving/
  test_slo.py``) give the same exit codes and reports from both tools,
  and the port's file is the reference's code up to the package name
  and the default SLO path.
* ``gateway_smoke``: the smoke at the tiny preset passes, single
  process, as the two-replica fleet drill and over ``--disagg 1:1``;
  the serve process reports its own kernel launch counts.
* ``group_hosts``: the reference's cases give the reference's output.
* The trainer's wandb run (a stand-in module sees strictly increasing
  steps and one ``finish()``; an unimportable one warns and training
  completes) and its logging fields, the reference's (``--log_format
  json`` through the CLI is ``tests/test_torch_launch_hosts.py``'s).
"""

import ast
import contextlib
import dataclasses
import io
import json
import logging
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from scaletorch_tpu import config as jconfig
from scaletorch_tpu.parallel import pipeline_parallel as jpp
from scaletorch_tpu.telemetry.histogram import LogHistogram
from scaletorch_tpu_torch import config as tconfig
from scaletorch_tpu_torch.tools import convert_layer_storage as conv
from scaletorch_tpu_torch.tools import group_hosts as tgroup
from scaletorch_tpu_torch.tools import slo_check as tslo_check
from scaletorch_tpu_torch.tools import verify_weights as tverify
from scaletorch_tpu_torch.trainer.factored import Adafactor
from scaletorch_tpu_torch.utils.checkpoint import (
    CheckpointLayoutError,
    CheckpointManager,
)
from tests.test_torch_one_thread import one_torch_thread  # noqa: F401


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tools import convert_layer_storage as jconv  # noqa: E402
from tools import slo_check as jslo_check  # noqa: E402


def _load_script(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jgroup = _load_script("group_hosts")


# ---- convert_layer_storage -------------------------------------------------
def _params(num_layers):
    rng = np.random.default_rng(num_layers)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"embed_tokens": r(64, 16), "final_norm": r(16),
            "layers": {"wq": r(num_layers, 16, 32),
                       "w_up": r(num_layers, 128, 256),
                       "input_norm": r(num_layers, 16)}}


def _state(params, optimizer):
    """A seeded optimizer state of the port's structure."""
    rng = np.random.default_rng(7)
    if optimizer == "adamw":
        like = {k: _map_np(lambda a: rng.standard_normal(a.shape)
                           .astype(np.float32), params)
                for k in ("mu", "nu")}
        return {"count": np.asarray(3, np.int64), **like}
    init = Adafactor(lambda _: 1e-3).init(_to_torch(params))
    state = _map_np(lambda a: rng.standard_normal(a.shape).astype(
        np.float32) if a.ndim else a, _to_np(init))
    return state


def _map_np(fn, tree):
    return {k: _map_np(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _to_torch(tree):
    return _map_np(lambda a: torch.from_numpy(np.array(a)), tree)


def _to_np(tree):
    return _map_np(lambda t: t.numpy().copy(), tree)


def _ref_pad(tree, num_layers, pp, inverse=False):
    """The reference's pad (or unpad) of every stacked leaf under a
    ``layers`` key, size-1 leaves passed through."""
    rows = num_layers if not inverse else \
        pp * jpp.padded_stage_counts(num_layers, pp)[1]
    fn = jpp.unpad_stacked_params if inverse else jpp.pad_stacked_params

    def walk(node, in_layers):
        if isinstance(node, dict):
            return {k: walk(v, in_layers or k == "layers")
                    for k, v in node.items()}
        if in_layers and node.ndim >= 1 and node.shape[0] == rows:
            return np.asarray(fn({"w": node}, num_layers, pp)["w"])
        return node

    return walk(tree, False)


def _reference(tree, case, num_layers, to_plain):
    if case == "interleaved":
        order = jpp._interleaved_layer_order(num_layers, 2, 2)
        idx = np.argsort(order) if to_plain else np.asarray(order)
        return jconv._permute_layers_subtrees(tree, idx, num_layers)
    return _ref_pad(tree, num_layers, 2, inverse=to_plain)


LAYOUTS = {"interleaved": (4, {"stacked": "interleaved", "pp": 2, "vpp": 2,
                               "layers": 4}),
           "padded": (3, {"stacked": "afab", "pp": 2, "vpp": 1,
                          "layers": 3})}


def _assert_trees_equal(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        if isinstance(ours[k], dict):
            _assert_trees_equal(ours[k], theirs[k])
        else:
            np.testing.assert_array_equal(np.asarray(ours[k]),
                                          np.asarray(theirs[k]))


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("case", sorted(LAYOUTS))
@pytest.mark.parametrize("direction", ["from_plain", "to_plain"])
def test_conversion_matches_the_reference(tmp_path, case, optimizer,
                                          direction):
    num_layers, layout = LAYOUTS[case]
    params = _params(num_layers)
    state = _state(params, optimizer)
    if direction == "to_plain":
        params = _reference(params, case, num_layers, to_plain=False)
        state = _reference(state, case, num_layers, to_plain=False)
        saved, to = layout, "plain"
    else:
        saved, to = None, layout["stacked"]
    CheckpointManager(str(tmp_path / "src"), layout=saved).save(
        5, _to_torch(params), _to_torch(state), extra={"tokens_seen": 9})
    done = conv.convert(str(tmp_path / "src"), str(tmp_path / "out"), to,
                        pp=2, vpp=2 if case == "interleaved" else None)
    assert done["step"] == 5 and done["layers"] == num_layers
    got, meta = conv.read_step(str(tmp_path / "out" / "5"))
    assert meta["extra"] == {"tokens_seen": 9}
    assert meta["layout"] == (layout if to != "plain"
                              else {"stacked": "plain"})
    want_p = _reference(params, case, num_layers, direction == "to_plain")
    want_s = _reference(state, case, num_layers, direction == "to_plain")
    _assert_trees_equal(_to_np(got["params"]), want_p)
    _assert_trees_equal(_to_np(got["opt_state"]), want_s)


def test_conversion_refusals(tmp_path, capsys):
    params = _params(4)
    CheckpointManager(str(tmp_path / "src")).save(
        1, _to_torch(params), _to_torch(_state(params, "adamw")))
    src, out = str(tmp_path / "src"), str(tmp_path / "out")
    # the target equals the saved layout (afab at an even split is plain)
    for argv in (["--to", "plain"], ["--to", "afab", "--pp", "2"]):
        assert conv.main(["--ckpt", src, "--out", out, *argv]) == 1
        assert "already in layout" in capsys.readouterr().err
    assert conv.main(["--ckpt", src, "--out", out, "--to", "interleaved",
                      "--pp", "2"]) == 1
    assert "--vpp" in capsys.readouterr().err
    # a non-uniform stack
    bad = dict(params, layers=dict(params["layers"],
                                   extra=np.zeros((3, 2), np.float32)))
    CheckpointManager(str(tmp_path / "bad")).save(
        1, _to_torch(bad), _to_torch(_state(bad, "adamw")))
    assert conv.main(["--ckpt", str(tmp_path / "bad"), "--out", out,
                      "--to", "interleaved", "--pp", "2", "--vpp", "2"]) == 1
    assert "non-uniform" in capsys.readouterr().err


def test_layout_refusal_names_the_converter(tmp_path):
    params = _params(4)
    torch_params = _to_torch(params)
    torch_state = _to_torch(_state(params, "adamw"))
    CheckpointManager(str(tmp_path / "c")).save(2, torch_params, torch_state)
    interleaved = LAYOUTS["interleaved"][1]
    mgr = CheckpointManager(str(tmp_path / "c"), layout=interleaved)
    with pytest.raises(CheckpointLayoutError,
                       match="scaletorch_tpu_torch.tools.convert_layer_"
                             "storage .*--to interleaved --pp 2 --vpp 2"):
        mgr.load_latest(torch_params, torch_state)
    assert conv.main(["--ckpt", str(tmp_path / "c"), "--out",
                      str(tmp_path / "v"), "--to", "interleaved", "--pp",
                      "2", "--vpp", "2"]) == 0
    got = CheckpointManager(str(tmp_path / "v"), layout=interleaved
                            ).load_latest(torch_params, torch_state)
    assert got["step"] == 2
    # the padded split ignores the virtual stages it records
    padded = dict(LAYOUTS["padded"][1])
    mgr = CheckpointManager(str(tmp_path / "p"), layout=padded)
    mgr.save(1, _to_torch(_params(3)), {})
    assert CheckpointManager(str(tmp_path / "p"),
                             layout=dict(padded, vpp=0)
                             ).layout_mismatch(1) is None


# ---- verify_weights ---------------------------------------------------------
@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """The self-test's checkpoint, the same with one tensor dropped, and
    with one NaN weight."""
    from scaletorch_tpu_torch.utils import hf_interop

    root = tmp_path_factory.mktemp("hf")
    good = tverify.write_synthetic(str(root / "good"))
    out = {"good": good}
    for name in ("dropped", "nan"):
        d = root / name
        d.mkdir()
        with open(os.path.join(good, "config.json")) as f:
            (d / "config.json").write_text(f.read())
        tensors, handles = hf_interop._open_shards(good)
        entries = []
        for key in sorted(tensors):
            t = tensors[key].get_tensor(key).clone()
            if name == "dropped" and key.endswith("layers.1.mlp.up_proj"
                                                  ".weight"):
                continue
            if name == "nan" and key.endswith("layers.0.self_attn.q_proj"
                                              ".weight"):
                t[0, 0] = float("nan")
            entries.append((key, t))
        for h in handles:
            h.close()
        assert len(entries) == len(tensors) - (name == "dropped")
        from safetensors.torch import save_file

        save_file(dict(entries), str(d / "model.safetensors"))
        out[name] = str(d)
    return out


def _verdict(fn, *args, **kw):
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            return bool(fn(*args, **kw))
    except Exception:
        return False


def test_verify_weights_synthetic_runs_the_transformers_comparison(
        monkeypatch, capsys):
    monkeypatch.setenv("USE_TF", "0")
    assert tverify.main(["--synthetic", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for line in ("forward: PASS", "backward: PASS",
                 "logits vs transformers: PASS", "RESULT: OK"):
        assert line in out


def test_verify_weights_verdicts_match_the_reference(hf_dirs, monkeypatch):
    monkeypatch.setenv("USE_TF", "0")
    from tools import verify_weights as jverify

    # the transformers comparison runs in the self-test above
    ours = {k: _verdict(tverify.verify_one, d, compare_hf=False,
                        device="cpu") for k, d in hf_dirs.items()}
    theirs = {k: _verdict(jverify.verify_one, d, compare_hf=False)
              for k, d in hf_dirs.items()}
    assert ours == theirs == {"good": True, "dropped": False, "nan": False}


def test_verify_weights_fails_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tverify.main(["--synthetic"])


# ---- slo_check --------------------------------------------------------------
def _access(outcome="ok", **kw):
    record = {"v": 1, "kind": "access", "time": 0.0, "proc": 0,
              "tenant": "default", "outcome": outcome, "status": 200,
              "trace_id": "ab" * 16, "queue_wait_s": 0.01,
              "ttft_s": 0.2, "e2e_s": 0.5, "tokens": 4,
              "prefix_hit": False, "replica": "r0"}
    record.update(kw)
    return record


def _hist(*values):
    h = LogHistogram()
    for v in values:
        h.observe(v)
    return h


def _prom(series, ok=None):
    from scaletorch_tpu.telemetry.export import render_families

    fams = [{"name": "request_ttft_seconds", "type": "histogram",
             "series": series}]
    if ok is not None:
        fams.append({"name": "http_ok", "type": "counter",
                     "samples": [(None, ok)]})
    return render_families(fams)


# the reference's tests/serving/test_slo.py TestSloCheckCLI inputs:
# (JSONL events or None, /metrics text or None, preset)
SLO_CASES = {
    "green_access": ([_access() for _ in range(3)], None, "tiny"),
    "violation": ([_access(), _access(outcome="timeout", status=504)],
                  None, "tiny"),
    "histograms_cover_tpot": ([
        _access(), {"v": 1, "kind": "latency_histograms", "time": 0,
                    "proc": 0, "tpot": {"default": _hist(*[8.0] * 50)
                                        .to_dict()}}], None, "tiny"),
    "cumulative_snapshots": ([
        _access(),
        {"v": 1, "kind": "latency_histograms", "time": 0, "proc": 0,
         "tpot": {"default": _hist(*[0.5] * 32).to_dict()}},
        {"v": 1, "kind": "latency_histograms", "time": 1, "proc": 0,
         "tpot": {"default": _hist(*([0.5] * 32 + [0.01] * 968))
                  .to_dict()}}], None, "production"),
    "refusals": ([_access(e2e_s=5.0),
                  *[_access(outcome="shed", status=429, e2e_s=0.0001)
                    for _ in range(50)]], None, "tiny"),
    "aborted_ttft": ([_access(), _access(outcome="aborted", status=503,
                                         ttft_s=0.9, e2e_s=1.0)],
                     None, "tiny"),
    "gateway_metrics_outcomes": ([
        {"v": 1, "kind": "gateway_metrics", "time": 0, "proc": 0,
         "http_ok": 5, "http_timeout": 5}], None, "tiny"),
    "prom_scrape": (None, _prom([({"tenant": "default"},
                                  _hist(0.1, 0.2, 0.4))], ok=3), "tiny"),
    "prom_brace_tenant": (None, _prom([({"tenant": "a}b"},
                                        _hist(0.1, 0.1)),
                                       ({"tenant": "ok"},
                                        _hist(0.2, 0.2))], ok=4),
                          "production"),
    "usage_no_input": (None, None, "tiny"),
    "usage_bad_preset": ([_access()], None, "nope"),
    "usage_bad_jsonl": ("{not json\n", None, "tiny"),
    "usage_missing_file": ("missing", None, "tiny"),
}

# the exit codes the reference's tests assert
SLO_EXIT_CODES = {"green_access": 0, "violation": 1,
                  "histograms_cover_tpot": 1, "gateway_metrics_outcomes": 1,
                  "prom_scrape": 0}


def _slo_argv(tmp_path, case):
    events, prom, preset = SLO_CASES[case]
    argv = ["--slo", os.path.join(REPO, "tools", "slo.json"),
            "--preset", preset]
    if events == "missing":
        argv.append(str(tmp_path / "missing.jsonl"))
    elif isinstance(events, str):
        (tmp_path / "bad.jsonl").write_text(events)
        argv.append(str(tmp_path / "bad.jsonl"))
    elif events is not None:
        with open(tmp_path / "events.jsonl", "w") as f:
            for e in events:
                f.write(json.dumps(e) + "\n")
        argv.append(str(tmp_path / "events.jsonl"))
    if prom is not None:
        (tmp_path / "metrics.txt").write_text(prom)
        argv += ["--prom", str(tmp_path / "metrics.txt")]
    return argv


def _run_slo(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("case", list(SLO_CASES))
def test_slo_check_matches_the_reference(tmp_path, capsys, case):
    argv = _slo_argv(tmp_path, case)
    ours = _run_slo(tslo_check.main, argv, capsys)
    theirs = _run_slo(jslo_check.main, argv, capsys)
    assert ours == theirs
    if case in SLO_EXIT_CODES:
        assert ours[0] == SLO_EXIT_CODES[case]
    elif case.startswith("usage"):
        assert ours[0] == 2
    if case == "green_access":
        # the port's default SLO file is the reference's tools/slo.json
        assert _run_slo(tslo_check.main, argv[2:], capsys) == theirs


def _fn_dumps(path, package):
    """Each top-level node's syntax tree without docstrings, with the
    package mapped, the ``--slo`` default blanked and the reference's
    path preamble (``REPO``, ``sys.path``) left out."""
    tree = ast.parse(open(path).read())
    out = []
    for node in tree.body:
        if isinstance(node, ast.Expr) and isinstance(node.value,
                                                     ast.Constant):
            continue  # the module docstring
        src = ast.unparse(node)
        if src.startswith(("REPO =", "sys.path.insert")):
            continue
        for sub in ast.walk(node):
            body = getattr(sub, "body", None)
            if (isinstance(body, list) and body
                    and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                sub.body = body[1:] or [ast.Pass()]
            if (isinstance(sub, ast.Call) and sub.args
                    and isinstance(sub.args[0], ast.Constant)
                    and sub.args[0].value == "--slo"):
                sub.keywords = [k for k in sub.keywords
                                if k.arg not in ("default", "help")]
            if isinstance(sub, ast.ImportFrom) and sub.module:
                sub.module = sub.module.replace(package, "PKG")
                sub.names = [a for a in sub.names
                             if a.name != "DEFAULT_SLO_PATH"]
        out.append(ast.dump(node))
    return out


def test_slo_check_is_the_reference_code():
    ours = _fn_dumps(os.path.join(REPO, "scaletorch_tpu_torch", "tools",
                                  "slo_check.py"), "scaletorch_tpu_torch")
    theirs = _fn_dumps(os.path.join(REPO, "tools", "slo_check.py"),
                       "scaletorch_tpu")
    assert ours == theirs


# ---- group_hosts --------------------------------------------------------------
HOST_CASES = {
    "reference_case": ["t1v-n-abc-w-0", "10.0.0.1 rack-b", "t1v-n-abc-w-1",
                       "10.0.0.2 rack-b", "bare-host"],
    "already_grouped": ["# rack-a", "h1", "h2", "", "# rack-b", "h3",
                        "h4 rack-a"],
    "explicit_beats_worker_name": ["t1v-x-w-0 rack-z", "t1v-x-w-1",
                                   "gpu-node-7"],
}


@pytest.mark.parametrize("case", list(HOST_CASES))
def test_group_hosts_matches_the_reference(case):
    lines = HOST_CASES[case]
    ours, theirs = tgroup.group_hosts(lines), jgroup.group_hosts(lines)
    assert ours == theirs
    assert tgroup.render(ours) == jgroup.render(theirs)
    assert tgroup.rank_assignment(ours) == jgroup.rank_assignment(theirs)
    assert tgroup.group_hosts(tgroup.render(ours).splitlines()) == ours


def test_group_hosts_cli_writes_the_reference_file(tmp_path):
    hosts = tmp_path / "hosts.txt"
    hosts.write_text("\n".join(HOST_CASES["reference_case"]) + "\n")
    outs = []
    for module in ("scaletorch_tpu_torch.tools.group_hosts", None):
        dst = tmp_path / f"out{len(outs)}.txt"
        cmd = ([sys.executable, "-m", module] if module else
               [sys.executable, os.path.join(REPO, "scripts",
                                             "group_hosts.py")])
        res = subprocess.run(cmd + [str(hosts), "-o", str(dst)], cwd=REPO,
                             capture_output=True, text=True, timeout=60)
        assert res.returncode == 0, res.stderr
        outs.append((dst.read_text(), res.stderr))
    assert outs[0] == outs[1]


# ---- gateway_smoke ------------------------------------------------------------
@pytest.mark.parametrize("mode", [[], ["--procs", "2"],
                                  ["--disagg", "1:1"]],
                         ids=["single", "procs2", "disagg"])
def test_gateway_smoke_passes_at_the_tiny_preset(tmp_path, monkeypatch,
                                                 mode):
    from scaletorch_tpu_torch.tools import gateway_smoke

    # the serve process and its replicas: one intra-op thread each
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with contextlib.redirect_stdout(io.StringIO()) as log:
        got = gateway_smoke.run(["--device", "cpu", "--telemetry_dir",
                                 str(tmp_path / "telemetry"), *mode])
    assert got["tokens_equal_direct"] and got["drain_exit_code"] == 0, \
        log.getvalue()[-2000:]
    assert got["slo_check_exit_code"] == 0
    assert len(got["tokens"]) == gateway_smoke.MAX_NEW
    if mode[:1] == ["--procs"]:
        assert "warm rejoin OK" in log.getvalue()
        assert got["warmed"] != got["donor"]
    else:
        assert "trace correlation OK" in log.getvalue()
        # the serve process's own launch counts, printed after its drain
        # (the CPU runs the kernels' plain versions: none counted)
        assert got["serve_kernel_launches"].get("paged_decode", 0) == 0


def test_gateway_smoke_fails_without_a_card():
    from scaletorch_tpu_torch.tools import gateway_smoke

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gateway_smoke.run([])


# ---- the trainer's logging flags -------------------------------------------------
TINY = ["--model_type", "qwen3", "--vocab_size", "64", "--hidden_size",
        "32", "--intermediate_size", "64", "--num_hidden_layers", "2",
        "--num_attention_heads", "4", "--num_key_value_heads", "2",
        "--head_dim", "8", "--sequence_length", "16", "--synthetic_data",
        "true", "--dtype", "float32", "--param_dtype", "float32",
        "--learning_rate", "1e-3"]


def test_logging_fields_are_the_references():
    ours = {f.name: f for f in dataclasses.fields(tconfig.LoggingArguments)}
    theirs = {f.name: f for f in dataclasses.fields(jconfig.LoggingArguments)}
    assert list(ours) == list(theirs)
    for key, f in ours.items():
        assert f.default == theirs[key].default, key
    for value in ("text", "json", "yaml"):
        results = []
        for mod in (tconfig, jconfig):
            try:
                mod.ScaleTorchTPUArguments(log_format=value)
                results.append("ok")
            except ValueError as exc:
                results.append(str(exc))
        assert results[0] == results[1], value


class _StandInWandb:
    def __init__(self):
        self.logged, self.finished, self.init_kw = [], 0, None

    def init(self, **kw):
        self.init_kw = kw
        return self

    def log(self, record, step):
        self.logged.append((step, dict(record)))

    def finish(self):
        self.finished += 1


def _tiny_trainer(**kw):
    from scaletorch_tpu_torch.trainer.trainer import Trainer

    cfg = tconfig.parse_args(TINY + ["--total_train_steps", "3"])
    return Trainer(dataclasses.replace(cfg, **kw), device="cpu")


def test_wandb_run_logs_increasing_steps_and_finishes(monkeypatch):
    stand_in = _StandInWandb()
    monkeypatch.setitem(sys.modules, "wandb",
                        types.SimpleNamespace(init=stand_in.init))
    t = _tiny_trainer(wandb_project="proj", wandb_run_name="run")
    try:
        t.train(3)
        # a rollback moves the step back: no step is logged twice
        t.global_step = 1
        t.train(1)
    finally:
        t.close()
        t.close()
    assert stand_in.init_kw["project"] == "proj"
    assert stand_in.init_kw["name"] == "run"
    assert stand_in.init_kw["config"]["wandb_project"] == "proj"
    steps = [s for s, _ in stand_in.logged]
    assert steps == [1, 2, 3]
    assert all("loss" in r for _, r in stand_in.logged)
    assert stand_in.finished == 1


def test_wandb_unavailable_warns_and_trains(monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "wandb", None)  # any import fails
    t = _tiny_trainer(wandb_project="proj")
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    t.logger.addHandler(handler)
    try:
        last = t.train(2)
    finally:
        t.logger.removeHandler(handler)
        t.close()
    assert t._wandb is None and t.global_step == 2
    assert np.isfinite(last["loss"])
    # the warning was logged at construction, before the handler: build
    # again with the handler on the package's logger
    logger = logging.getLogger("scaletorch_tpu_torch")
    logger.addHandler(handler)
    try:
        _tiny_trainer(wandb_project="proj").close()
    finally:
        logger.removeHandler(handler)
    assert any("wandb requested but unavailable" in r.getMessage()
               for r in records)
