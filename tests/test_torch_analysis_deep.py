"""The port's analyzer, deep and memory tiers on the CPU.

The seven audit entries run once each on the CPU (``--device cpu``; the
mesh entries under the ``fake`` process group at world 8, one rank's
shards), with the collective recorder and the dispatch liveness
estimator on, and audit clean against the checked-in budgets (written on
the card: another torch and another memory source there, so budget drift
reads as warnings here, which do not gate). The inference entries issue
no collective; the train entries carry int8 on the dp axis, and the
declarative entry's wire bytes equal the reference's checked-in comm
budget row. Each of the reference's injected regressions trips the code
the reference's test trips: fp32 wire (ST701 + ST802), a lost in-place
update (ST702 + ST1002), a dp collective inside the microbatch loop
(ST703), a low replication cap (ST704), a doctored, missing or
malformed budget (ST801-ST803 / ST1001, exit 2), an fp32 residual in a
bf16 entry (ST1003), surviving residuals (ST1004), a shrunken pool
(ST1005); torch-version and source drift downgrade to warnings. The
disaggregated slice programs, run small, write the ``slices`` rows that
``plan_slice_split`` reads (the audit rows size nothing). The
fake world keeps the path: the declarative entry at world 2 records the
same (op, dtype, axis, bytes) sequence on the fake group and on a real
2-process gloo world.
"""

import copy
import json
from pathlib import Path

import pytest
import torch

from scaletorch_tpu_torch.analysis import budget as tbudget
from scaletorch_tpu_torch.analysis import entry_audit as ea
from scaletorch_tpu_torch.analysis import memory as tmemory
from scaletorch_tpu_torch.analysis.__main__ import main as tmain
from scaletorch_tpu_torch.inference import decode as tdecode
from scaletorch_tpu_torch.inference import disagg as tdisagg
from scaletorch_tpu_torch.trainer import train_step as ttrain_step
from tests.torch_dist_harness import run_ranks

REPO = Path(__file__).resolve().parents[1]
# the AST tiers' path for the CLI runs here (the deep and memory tiers
# run the entries whatever the path; the port's AST run is its own test)
AST_PATH = str(REPO / "tests" / "analysis" / "fixtures" / "clean.py")
INFERENCE = ("prefill_step", "decode_step", "paged_decode_step",
             "disagg_prefill_slice", "disagg_decode_slice")
TRAIN = ("spmd_train_step", "declarative_train_step")


def run(entry):
    r, findings = ea.run_entry(entry, "cpu")
    assert r is not None, [f.render() for f in findings]
    return r


@pytest.fixture(scope="module")
def full_run():
    entries, findings = ea.load_entries()
    assert not findings
    return {e["name"]: run(e) for e in entries}


def codes(findings, severity="error"):
    return sorted({f.code for f in findings if f.severity == severity})


def same_torch(doc):
    """The budget as if this torch had written it (errors, not drift)."""
    doc = copy.deepcopy(doc)
    doc["torch"] = torch.__version__
    for row in doc["entries"].values():
        row["torch"] = torch.__version__
    return doc


def test_every_entry_audits_clean(full_run):
    assert set(full_run) == {name for name, _, _ in ea.MANIFEST}
    comm, mem = {}, {}
    for name, r in full_run.items():
        fs, comm[name] = ea.audit_run(r)
        fs2, mem[name], _ = tmemory.audit_run_memory(r)
        assert fs + fs2 == [], [f.render() for f in fs + fs2]
    fs, err = tbudget.check_budget_path(comm, tbudget.DEFAULT_BUDGET)
    assert err is None and codes(fs) == [], [f.render() for f in fs]
    fs, err = tmemory.check_hbm_budget_path(mem, tmemory.DEFAULT_HBM_BUDGET)
    assert err is None and codes(fs) == [], [f.render() for f in fs]


def test_cli_deep_memory_tier_exits_zero_on_the_cpu(capsys):
    assert tmain([AST_PATH, "--tier", "deep,memory", "--device", "cpu",
                  "--entries",
                  "prefill_step,paged_decode_step"]) == 0
    capsys.readouterr()


def test_inference_entries_record_zero_collectives(full_run):
    for name in INFERENCE:
        assert full_run[name].records == [], name


@pytest.mark.parametrize("name", TRAIN)
def test_train_entries_carry_int8_on_dp(full_run, name):
    on_dp = [c for c in full_run[name].records if "dp" in c.axes]
    assert any(c.dtype == "int8" for c in on_dp)
    assert all(c.dtype == "int8" for c in on_dp if c.elems > 4096)
    assert not any(c.in_loop for c in on_dp)


def test_declarative_wire_bytes_equal_the_reference_budget(full_run):
    ref = json.loads((REPO / "tools" / "comm_budget.json").read_text())
    want = ref["entries"]["declarative_train_step"]
    _, got = ea.audit_run(full_run["declarative_train_step"])
    assert got["hlo"] == want["hlo"]
    assert got["total_wire_mb"] == want["total_wire_mb"]


def test_entries_filter_skips_unselected_builders():
    entries, findings = ea.load_entries(["prefill_step", "no_such_entry"])
    assert [e["name"] for e in entries] == ["prefill_step"]
    assert codes(findings) == ["ST700"]


def test_fp32_wire_trips_st701_and_st802():
    r = run(ttrain_step.audit_entry(grad_allreduce_dtype="fp32"))
    fs, report = ea.audit_run(r)
    assert "ST701" in codes(fs)
    doc = same_torch(tbudget.load_budget(tbudget.DEFAULT_BUDGET))
    fs = tbudget.check_budget({"declarative_train_step": report}, doc)
    assert "ST802" in codes(fs)


def test_lost_inplace_update_trips_st702_and_st1002():
    r = run(ttrain_step.audit_entry(donate=False))
    fs, _ = ea.audit_run(r)
    assert codes(fs) == ["ST702"]
    fs, _, _ = tmemory.audit_run_memory(r)
    assert codes(fs) == ["ST1002"]


def test_dp_collective_inside_the_microbatch_loop_trips_st703(monkeypatch):
    import torch.distributed as dist

    from scaletorch_tpu_torch.parallel import mesh as pmesh

    original = ttrain_step._micro

    def per_microbatch_reduce(batch, a):
        mb = original(batch, a)
        dist.all_reduce(mb["input_ids"].float(),
                        group=pmesh.axis_group("dp"))
        return mb

    monkeypatch.setattr(ttrain_step, "_micro", per_microbatch_reduce)
    fs, _ = ea.audit_run(run(ttrain_step.audit_entry()))
    assert codes(fs) == ["ST703"]


def test_low_replication_cap_trips_st704():
    entry = ttrain_step.audit_entry()
    entry["max_collective_result_mb"] = 0.01
    fs, _ = ea.audit_run(run(entry))
    assert codes(fs) == ["ST704"]


def test_comm_budget_gate(full_run, tmp_path):
    reports = {n: ea.audit_run(r)[1] for n, r in full_run.items()}
    doc = same_torch(tbudget.load_budget(tbudget.DEFAULT_BUDGET))
    assert codes(tbudget.check_budget(reports, doc)) == []
    doctored = copy.deepcopy(doc)
    row = doctored["entries"]["declarative_train_step"]
    row["hlo"]["all-gather:s8"]["wire_mb"] /= 4
    del row["hlo"]["all-to-all:s8"]
    assert codes(tbudget.check_budget(reports, doctored)) == \
        ["ST801", "ST802"]
    del doctored["entries"]["prefill_step"]
    assert "ST803" in codes(tbudget.check_budget(reports, doctored))
    drift = copy.deepcopy(doctored)
    drift["torch"] = "0.0"
    fs = tbudget.check_budget(reports, drift)
    assert codes(fs) == ["ST803"] and codes(fs, "warning") == \
        ["ST801", "ST802"]
    (tmp_path / "bad.json").write_text("{not json")
    for path in (tmp_path / "missing.json", tmp_path / "bad.json"):
        fs, err = tbudget.check_budget_path(reports, path)
        assert fs == [] and err


def test_hbm_budget_gate(full_run):
    reports = {n: tmemory.audit_run_memory(r)[1] for n, r in full_run.items()}
    doc = same_torch(tmemory.load_hbm_budget(tmemory.DEFAULT_HBM_BUDGET))
    for name, now in reports.items():
        doc["entries"][name].update(now)  # this source's numbers
    assert tmemory.check_hbm_budget(reports, doc) == []
    doctored = copy.deepcopy(doc)
    doctored["entries"]["paged_decode_step"]["peak_mb"] = 0.0
    doctored["entries"]["decode_step"]["inplace_mb"] = 5.0
    fs = tmemory.check_hbm_budget(reports, doctored)
    assert codes(fs) == ["ST1001"] and len(fs) == 2
    missing = copy.deepcopy(doc)
    del missing["entries"]["prefill_step"]
    assert codes(tmemory.check_hbm_budget(reports, missing)) == ["ST1001"]
    for key, value in (("torch", "0.0"), ("source", "cuda")):
        drift = copy.deepcopy(doctored)
        for row in drift["entries"].values():
            row[key] = value
        fs = tmemory.check_hbm_budget(reports, drift)
        assert codes(fs) == [] and codes(fs, "warning") == ["ST1001"]


def test_cli_budget_usage_errors_exit_two(tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text("[1, 2")
    base = [AST_PATH, "--device", "cpu", "--entries", "prefill_step"]
    assert tmain(["--tier", "deep", *base, "--budget",
                  str(tmp_path / "none.json")]) == 2
    assert tmain(["--tier", "memory", *base, "--hbm-budget", str(bad)]) == 2
    assert tmain([AST_PATH, "--tier", "deep", "--entries",
                  "prefill_step"]) == 2 \
        or torch.cuda.is_available()
    assert "no CUDA device" in capsys.readouterr().err \
        or torch.cuda.is_available()


def test_scoped_write_merges_into_existing(tmp_path, capsys):
    path = tmp_path / "hbm.json"
    path.write_text(tmemory.DEFAULT_HBM_BUDGET.read_text())
    assert tmain([AST_PATH, "--tier", "memory", "--device", "cpu",
                  "--entries", "decode_step", "--hbm-budget", str(path),
                  "--write-hbm-budget"]) == 0
    doc = json.loads(path.read_text())
    rows = doc["entries"]
    assert len(rows) == len(ea.MANIFEST)
    assert rows["decode_step"]["source"] == "dispatch"
    # the card's slice rows are carried over, not measured on the CPU
    assert doc["slices"] == json.loads(
        tmemory.DEFAULT_HBM_BUDGET.read_text())["slices"]
    capsys.readouterr()


def test_slice_rows_size_plan_slice_split(tmp_path):
    """The two slice programs at a small width run through the memory
    tier; written as the budget's ``slices``, they size the split, and
    the audit ``entries`` alone size nothing."""
    cfg = tdecode.audit_cfg()
    shape = {"max_slots": 2, "max_seq": 32, "prefill_len": 16,
             "page_size": 8}
    rows = {}
    for entry in tdisagg.slice_budget_entries(cfg, **shape):
        r = run(entry)
        assert set(r.inplace) == {"pool.k", "pool.v"}
        assert all(before == after for before, after, _ in
                   r.inplace.values())
        rows[entry["name"]] = {**tmemory.memory_report(r), **entry["shape"]}
    prefill, decode = rows["disagg_prefill_slice"], rows["disagg_decode_slice"]
    assert prefill["model"] == "custom" and prefill["max_seq"] == 32
    # the decode pool holds whole sequences, the prefill pool prompts
    assert decode["argument_mb"] > prefill["argument_mb"]
    path = tmp_path / "hbm.json"
    tmemory.write_hbm_budget(path, {}, slices=rows)
    w_p, w_d = prefill["peak_mb"], decode["peak_mb"]
    for n in (2, 5, 8):
        n_p = max(1, min(n - 1, int(round(n * w_p / (w_p + w_d)))))
        assert tdisagg.plan_slice_split(n, budget_path=str(path)) == \
            (n_p, n - n_p)
    path.write_text(json.dumps({"entries": rows}))
    assert tdisagg.plan_slice_split(8, budget_path=str(path)) == (4, 4)


def test_bf16_entry_without_injection_is_clean():
    r = run(tdecode.audit_entry_decode(compute_dtype="bf16"))
    fs, _, _ = tmemory.audit_run_memory(r)
    assert fs == [], [f.render() for f in fs]


def test_fp32_residual_in_a_bf16_entry_trips_st1003():
    r = run(tdecode.audit_entry_decode(compute_dtype="bf16",
                                       fp32_residual=True))
    fs, _, _ = tmemory.audit_run_memory(r)
    assert codes(fs) == ["ST1003"]
    assert "decode.py" in fs[0].message and "forward_fn" in fs[0].message


def _remat_entry(checkpointed: bool):
    """A small MLP's forward and backward: under a checkpoint policy its
    saved activations must stay at the inputs' scale."""

    def setup(device):
        gen = torch.Generator().manual_seed(0)
        x = torch.randn(64, 256, generator=gen, requires_grad=True)
        ws = [torch.randn(256, 256, generator=gen, requires_grad=True)
              for _ in range(4)]

        def block(h):
            for w in ws:
                h = torch.tanh(h @ w)
            return h

        def call():
            h = (torch.utils.checkpoint.checkpoint(block, x,
                                                   use_reentrant=False)
                 if checkpointed else block(x))
            return torch.autograd.grad(h.sum(), [x, *ws])

        return {"call": call, "arguments": [x, *ws]}

    return {"name": "remat", "file": "tests/remat.py", "world_size": 1,
            "grad": True, "remat_policy": "nothing_saveable",
            "residual_cap_mb": 0.1, "setup": setup}


@pytest.mark.parametrize("checkpointed", [True, False],
                         ids=["checkpointed", "surviving"])
def test_surviving_residuals_trip_st1004(checkpointed):
    fs, _, _ = tmemory.audit_run_memory(run(_remat_entry(checkpointed)))
    assert codes(fs) == ([] if checkpointed else ["ST1004"])


def test_shrunken_pool_trips_st1005():
    r = run(tdecode.audit_entry_paged_decode(pool_pages=5))
    fs, _, _ = tmemory.audit_run_memory(r)
    assert "ST1005" in codes(fs)


def test_fake_world_records_what_a_gloo_world_records(tmp_path):
    r = run(ttrain_step.audit_entry(world=2))
    fake = [(c.op, c.dtype, c.axis, c.bytes) for c in r.records]
    ranks = run_ranks(tmp_path, 2, "audit_record", {"world": 2})
    assert fake and ranks[0] == ranks[1] == fake
