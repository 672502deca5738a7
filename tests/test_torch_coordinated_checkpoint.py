"""PyTorch port, the coordinated and resharding checkpoint and the HF
export of sharded parameters, over real gloo processes (tiny Qwen3 and
Qwen3-MoE, fp32):

* the reference's ``TestCoordinatedCheckpoints`` cases
  (tests/test_resilience_distributed.py) at 2 processes, each held to the
  outcome the reference fixes: a one-rank save failure retried in
  lockstep ``(True, [1])``, exhausted retries ``False`` on both ranks, a
  mixed saved/skipped view converging on ``True``, a corrupt newest step
  falling back to step 1 on both ranks;
* the reshards, bit for bit against the saved global tensors (the
  counterpart of tests/test_elastic.py's dp4 -> dp2 -> dp4 round trip):
  dp4 -> dp2 -> dp4, a one-process checkpoint restored at tp2 x dp2 (each
  rank holds ``shard_numpy_params``' slice), a tp2 checkpoint restored by
  one process (the ``gather_params`` of the shards);
* a pp2 checkpoint of an uneven (padded) layer split refused at pp1 with
  its reason, loading nothing;
* the bytes each rank writes: about 1/(its replica count) of its shards;
* ``Trainer.export_hf`` at tp2, pp2 (uneven afab, and interleaved) and
  ep2, byte-equal to the one-process export of the same parameters.

The one-process sides run in this process; every multi-process wait is
bounded (``tests/torch_dist_harness.run_ranks``).
"""

import os

import numpy as np
import pytest

from scaletorch_tpu_torch.models.convert import (
    flatten_params,
    gather_params,
    shard_numpy_params,
)
from scaletorch_tpu_torch.parallel.mesh import MeshManager, using_mesh_manager
from scaletorch_tpu_torch.trainer.trainer import build_model_config
from scaletorch_tpu_torch.utils.checkpoint import CheckpointLayoutError
from tests.torch_dist_harness import run_ranks
from tests.torch_dist_runtime import cfg_of, trainer_job

MOE = dict(model_type="qwen3_moe", num_experts=4, num_experts_per_tok=2,
           moe_intermediate_size=32, moe_capacity_factor=2.0)
# (world, parallel config) of each sharded export, and its model
EXPORTS = {
    "tp2": dict(tensor_parallel_size=2),
    "pp2_uneven": dict(pipeline_parallel_size=2, num_hidden_layers=3,
                       gradient_accumulation_steps=2),
    "pp2_interleaved": dict(pipeline_parallel_size=2, num_hidden_layers=4,
                            pp_engine="interleaved", pp_virtual_stages=2,
                            gradient_accumulation_steps=2),
    "ep2": dict(expert_parallel_size=2, **MOE),
}
# wide enough that a tensor's bytes dwarf DCP's per-item overhead
WIDE = dict(hidden_size=128, intermediate_size=256, head_dim=32)
PARALLEL = ("tensor_parallel_size", "pipeline_parallel_size",
            "expert_parallel_size", "data_parallel_size", "pp_engine",
            "pp_virtual_stages")


def one_process(job):
    with using_mesh_manager(None):
        return trainer_job(job)


def assert_trees_equal(a, b):
    assert sorted(a) == sorted(b)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def nest(flat):
    out = {}
    for name, a in flat.items():
        node = out
        parts = name.split(".")
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = a
    return out


def test_checkpoint_protocol_agrees_like_the_reference(tmp_path):
    res = run_ranks(tmp_path, 2, "checkpoint_protocol",
                    {"dir": str(tmp_path / "ckpt")})
    assert [r["lockstep"] for r in res] == [(True, [1])] * 2
    assert [r["exhausted"] for r in res] == [False, False]
    assert [r["mixed"] for r in res] == [True, True]
    # the fleet lands on ONE step, the newest readable everywhere; the
    # unreadable step is retired
    assert [r["corrupt"] for r in res] == [(1, 1.0, [1])] * 2


@pytest.fixture(scope="module")
def reshards(tmp_path_factory):
    """Every save and restore of the reshard, layout and export cases:
    three launches and the one-process sides."""
    tmp = tmp_path_factory.mktemp("reshard")
    d = {k: str(tmp / k) for k in ("dp", "one", "tp2", "pp2")}
    one = one_process({"cfg": dict(checkpoint_dir=d["one"]), "steps": 2,
                       "save": True})
    first = run_ranks(tmp, 4, "trainer_jobs", {"jobs": [
        {"cfg": dict(data_parallel_size=4, checkpoint_dir=d["dp"]),
         "steps": 2, "save": True},
        {"cfg": dict(tensor_parallel_size=2, data_parallel_size=2,
                     checkpoint_dir=d["one"], resume="must"),
         "steps": 1, "save": True},
        {"cfg": dict(WIDE, tensor_parallel_size=2, data_parallel_size=2,
                     checkpoint_dir=str(tmp / "wide")),
         "steps": 1, "save": True}]})
    exports = {name: str(tmp / "export" / name) for name in EXPORTS}
    second = run_ranks(tmp, 2, "trainer_jobs", {"jobs": [
        {"cfg": dict(data_parallel_size=2, checkpoint_dir=d["dp"],
                     resume="must"), "steps": 1, "save": True},
        {"cfg": dict(tensor_parallel_size=2, checkpoint_dir=d["tp2"]),
         "steps": 2, "save": True},
        {"cfg": dict(EXPORTS["pp2_uneven"], checkpoint_dir=d["pp2"]),
         "steps": 1, "save": True},
        *[{"cfg": cfg, "export": exports[name]}
          for name, cfg in EXPORTS.items()]]})
    third = run_ranks(tmp, 4, "trainer_jobs", {"jobs": [
        {"cfg": dict(data_parallel_size=4, checkpoint_dir=d["dp"],
                     resume="must")}]})
    return {"tmp": tmp, "dirs": d, "one": one, "first": first,
            "second": second, "third": third, "exports": exports}


def test_dp4_dp2_dp4_round_trip_is_bitwise(reshards):
    dp4 = [r[0] for r in reshards["first"]]
    dp2 = [r[0] for r in reshards["second"]]
    back = [r[0] for r in reshards["third"]]
    assert all(r["saved"] for r in dp4 + dp2)
    for r in dp2:
        # the dp4 step-2 state, restored onto two processes
        assert r["step0"] == 2
        assert_trees_equal(r["params0"], dp4[0]["params"])
        assert_trees_equal(r["state0"], dp4[0]["state"])
    for r in back:
        # the dp2 step-3 state, restored onto four again
        assert r["step0"] == 3
        assert_trees_equal(r["params0"], dp2[0]["params"])
        assert_trees_equal(r["state0"], dp2[0]["state"])


def test_one_process_checkpoint_restores_at_tp2_dp2(reshards):
    one = reshards["one"]
    cfg = build_model_config(cfg_of())
    mm = MeshManager(tp=2, dp=2)
    full = nest(one["params"])
    for r in (j[1] for j in reshards["first"]):
        assert r["step0"] == 2
        want = flatten_params(shard_numpy_params(full, cfg, mm, r["rank"]))
        assert_trees_equal(r["params0"], want)
        for key in ("mu", "nu"):
            state = nest({n[len(key) + 1:]: a for n, a in one["state"].items()
                          if n.startswith(key + ".")})
            got = {n[len(key) + 1:]: a for n, a in r["state0"].items()
                   if n.startswith(key + ".")}
            assert_trees_equal(got, flatten_params(
                shard_numpy_params(state, cfg, mm, r["rank"])))


def test_tp2_checkpoint_restores_in_one_process(reshards):
    shards = [r[1] for r in reshards["second"]]
    cfg = build_model_config(cfg_of())
    mm = MeshManager(tp=2)
    want = flatten_params(gather_params(
        [nest(r["params"]) for r in shards], cfg, mm))
    got = one_process({"cfg": dict(checkpoint_dir=reshards["dirs"]["tp2"],
                                   resume="must")})
    assert got["step0"] == 2
    assert_trees_equal(got["params0"], want)


def test_changed_stacked_layout_is_refused(reshards):
    with pytest.raises(CheckpointLayoutError, match="layout"):
        one_process({"cfg": dict(
            num_hidden_layers=3, checkpoint_dir=reshards["dirs"]["pp2"],
            resume="must")})


def test_each_rank_writes_its_share_once(reshards):
    # tp2 x dp2: every shard has 2 replicas (a leaf whole on every rank,
    # 4); DCP writes each once, shared among its holders
    runs = [r[2] for r in reshards["first"]]
    total = runs[0]["step_bytes"]
    assert sum(r["rank_bytes"] for r in runs) <= total
    for r in runs:
        local = sum(a.nbytes for a in r["params"].values()) + sum(
            a.nbytes for n, a in r["state"].items() if n != "count")
        assert 0.8 * local / 2 <= r["rank_bytes"] <= 1.2 * local / 2, (
            r["rank"], r["rank_bytes"], local)


@pytest.mark.parametrize("name", list(EXPORTS))
def test_sharded_hf_export_is_byte_equal(reshards, tmp_path, name):
    index = 3 + list(EXPORTS).index(name)
    cfg = {k: v for k, v in EXPORTS[name].items() if k not in PARALLEL}
    one = one_process({"cfg": cfg, "export": str(tmp_path / "one")})
    sharded = reshards["exports"][name]
    assert reshards["second"][0][index]["export"]
    files = sorted(os.listdir(tmp_path / "one"))
    assert files == sorted(os.listdir(sharded))
    assert one["export"]
    for f in files:
        with open(tmp_path / "one" / f, "rb") as a, \
                open(os.path.join(sharded, f), "rb") as b:
            assert a.read() == b.read(), f
