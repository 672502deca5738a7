"""PyTorch port, elastic membership and remesh, against the reference
(tests/test_elastic.py):

* the membership primitives (``FileMembershipStore``, ``FileBus``,
  ``MembershipView``, ``_elastic_wrap``), the ``ElasticCoordinator``
  state machine, ``elastic_mesh_kwargs``, the loaders' dp change and
  ``remap_loader_position``, and the config's ``--elastic`` matrix: the
  same calls through both packages, the same results (the files each
  store writes, byte for byte);
* the kill drill, 4 real gloo processes under
  ``scaletorch_tpu_torch.launch --elastic``: rank 2 SIGKILLed after step
  3 (at the step boundary, or inside step 4's backward, where its peers
  wait in the gradients' all-reduce), the survivors shrink to dp3 and
  restore step 2, the relaunched rank
  parks and is readmitted at the step-4 checkpoint boundary, the run ends
  at step 6 with every rank's parameters identical, the epochs 0 -> 1 ->
  2 and the counters of the reference's drill; the dp3 segment (steps 3
  and 4) is bit for bit a fresh dp3 run restored from the same step-2
  checkpoint;
* the hang drill: rank 2 stalls past the deadline, the survivors evict
  it and finish, and the wedged rank parks and aborts loudly
  (``ElasticRemeshError``, exit 43) within its join deadline.

Every wait has a deadline: the launcher's and the harness's timeouts, the
process group's (``elastic_deadline_seconds``), the coordinator's.
"""

import json
import os
import pickle
import shutil
import subprocess
import sys
import threading
from functools import partial
from pathlib import Path

import numpy as np
import pytest

from scaletorch_tpu import config as jconfig
from scaletorch_tpu import resilience_distributed as jrd
from scaletorch_tpu.data import dataloader as jdl
from scaletorch_tpu.parallel import mesh as jmesh
from scaletorch_tpu_torch import config as tconfig
from scaletorch_tpu_torch import resilience_distributed as trd
from scaletorch_tpu_torch.data import dataloader as tdl
from scaletorch_tpu_torch.parallel import mesh as tmesh
from scaletorch_tpu_torch.telemetry import read_jsonl
from scaletorch_tpu_torch.telemetry.export import TelemetryExporter
from tests.test_elastic import run_threads, wait_until
from tests.torch_dist_harness import run_ranks
from tests.torch_dist_runtime import trainer_job

ROOT = Path(__file__).resolve().parents[1]
SIDES = {"port": trd, "ref": jrd}
DEADLINE = 5.0
HANG_S = 3 * DEADLINE + 6.0


# ---- primitives ----------------------------------------------------------------
def _store_ops(mod, directory):
    store = mod.FileMembershipStore(str(directory))
    first = store.propose_epoch(
        {"epoch": 1, "members": [0, 1], "reason": "shrink", "step": 3})
    second = store.propose_epoch(
        {"epoch": 1, "members": [9], "reason": "shrink", "step": 3})
    store.propose_epoch(
        {"epoch": 2, "members": [0], "reason": "shrink", "step": 4})
    store.post_alive(3, 0, step=5)
    store.post_alive(3, 2, step=5)
    store.post_alive(4, 1, step=9)
    store.request_rejoin(7)
    store.request_rejoin(4)
    store.clear_rejoin(4)
    store.clear_rejoin(4)
    out = {"first": first, "second": second, "e1": store.epoch(1),
           "latest": store.latest_epoch()["epoch"],
           "alive": sorted(store.alive_set(3)),
           "rejoins": store.pending_rejoins()}
    files = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name)) as f:
            rec = json.load(f)
        rec.pop("time", None)  # a wall clock
        files[name] = rec
    return out, files


def test_membership_store_writes_the_reference_files(tmp_path):
    port = _store_ops(trd, tmp_path / "port")
    ref = _store_ops(jrd, tmp_path / "ref")
    assert port == ref
    assert port[0]["e1"]["members"] == [0, 1]  # the first writer won


def test_file_bus_and_view_match_the_reference(tmp_path):
    got = {}
    for side, mod in SIDES.items():
        d = tmp_path / side
        fbs = {r: mod.FileBus(str(d), epoch=0, members=(1, 3), rank=r,
                              deadline=5.0) for r in (1, 3)}
        gathered, errors = run_threads(
            {r: partial(fb.all_gather, f"v{r}") for r, fb in fbs.items()})
        assert errors == {}
        bcast, errors = run_threads(
            {r: partial(fb.broadcast, [f"payload{r}"])
             for r, fb in fbs.items()})
        assert errors == {}
        lone = mod.FileBus(str(d / "lone"), epoch=2, members=(0, 5), rank=0,
                           deadline=0.2)
        with pytest.raises(mod.PeerLostError) as ei:
            lone.all_gather("x")
        view = mod.MembershipView(3, (0, 2, 5))
        bus = mod.elastic_decision_bus(view, 5, mod.DecisionBus(
            num_processes=3, process_index=2,
            all_gather=lambda obj: [obj] * 3, broadcast=lambda objs: objs))

        def broken(*_):
            raise threading.BrokenBarrierError()

        with pytest.raises(mod.PeerLostError):
            mod._elastic_wrap(broken)("x")
        got[side] = (gathered, bcast, ei.value.missing,
                     [view.bus_index(r) for r in (0, 2, 5)], view.num_hosts,
                     bus.process_index, bus.is_main,
                     sorted(os.listdir(d / "lone")))
    assert got["port"] == got["ref"]


def test_a_reset_gloo_connection_is_a_lost_peer():
    import torch.distributed as dist

    err = RuntimeError("[gloo/transport/tcp/pair.cc:537] Read error: "
                       "Connection reset by peer")

    def broken(*_):
        raise err

    with pytest.raises(trd.PeerLostError):
        trd._elastic_wrap(broken)("x")

    def bug(*_):
        raise RuntimeError("shape mismatch in my own code")

    with pytest.raises(RuntimeError, match="shape mismatch"):
        trd._elastic_wrap(bug)("x")
    # a lost peer by its type or its origin (gloo's transport), never by
    # words a deterministic error's message may hold as well
    lost = [err, RuntimeError("Application timeout caused pair closure"),
            dist.DistBackendError("NCCL communicator was aborted"),
            dist.DistNetworkError("connection to the store failed"),
            ConnectionResetError(104, "Connection reset by peer"),
            TimeoutError("collective"), trd.PeerLostError("gone")]
    not_lost = [
        RuntimeError("NCCL error: invalid usage (run with NCCL_DEBUG=WARN)"),
        RuntimeError("the peer tensor has a bad shape"),
        RuntimeError("aborted: socket count timed out in my own code"),
        ValueError("[gloo/transport/] in a ValueError"),
        FileNotFoundError("no such checkpoint")]
    assert [trd.is_transport_error(e) for e in lost] == [True] * len(lost)
    assert [trd.is_transport_error(e) for e in not_lost] == [False] * len(
        not_lost)


# ---- the coordinator's state machine, both sides ---------------------------------
def _coord(mod, store, rank, *, num_hosts=3, deadline=0.4, **kw):
    return mod.ElasticCoordinator(
        rank=rank, num_hosts=num_hosts, store=store,
        bus_factory=mod.file_bus_factory(store, deadline)
        if mod is trd else _ref_factory(store, deadline),
        deadline_seconds=deadline, **kw)


def _ref_factory(store, deadline):
    from tests.test_elastic import file_bus_factory

    return file_bus_factory(store, deadline)


def _machine(mod, tmp):
    out = {}
    store = mod.FileMembershipStore(str(tmp / "found"))
    c = _coord(mod, store, 0)
    out["found"] = (c.view.epoch, c.view.members, c.state, c.needs_join,
                    store.epoch(0)["reason"], _coord(mod, store, 1).state)

    store = mod.FileMembershipStore(str(tmp / "shrink"))
    coords = {r: _coord(mod, store, r) for r in (0, 1)}
    res, err = run_threads(
        {r: partial(c.on_peer_lost, 5) for r, c in coords.items()},
        timeout=30.0)
    out["shrink"] = (err, {r: (v.epoch, v.members) for r, v in res.items()},
                     {r: c.counters() for r, c in coords.items()},
                     store.epoch(1)["step"])

    store = mod.FileMembershipStore(str(tmp / "spurious"))
    coords = {r: _coord(mod, store, r) for r in range(3)}
    res, err = run_threads(
        {r: partial(c.on_peer_lost, 7) for r, c in coords.items()},
        timeout=30.0)
    out["spurious"] = (err, sorted((v.epoch, v.members)
                                   for v in res.values()),
                       coords[0].counters()["elastic_hosts_lost"])

    store = mod.FileMembershipStore(str(tmp / "floor"))
    coords = {r: _coord(mod, store, r, min_hosts=3) for r in (0, 1)}
    _, err = run_threads(
        {r: partial(c.on_peer_lost, 5) for r, c in coords.items()},
        timeout=30.0)
    out["floor"] = sorted((r, type(e).__name__, "elastic_min_hosts" in str(e))
                          for r, e in err.items())

    store = mod.FileMembershipStore(str(tmp / "grow"))
    store.propose_epoch({"epoch": 0, "members": [0, 1], "reason": "found",
                         "step": None})
    store.propose_epoch({"epoch": 1, "members": [0], "reason": "shrink",
                         "step": 3})
    c0 = _coord(mod, store, 0, num_hosts=2, deadline=5.0)
    c1 = _coord(mod, store, 1, num_hosts=2, deadline=5.0)
    empty = c0.maybe_grow(step=4)
    got = {}
    th = threading.Thread(target=lambda: got.update(v=c1.join(step=4)),
                          daemon=True)
    th.start()
    wait_until(lambda: store.pending_rejoins() == [1], what="rejoin")
    view = c0.maybe_grow(step=4)
    th.join(10.0)
    assert not th.is_alive()
    out["grow"] = (empty, (view.epoch, view.members),
                   (got["v"].epoch, got["v"].members),
                   store.pending_rejoins(), c0.counters(), c1.counters(),
                   c1.pending_bootstrap)

    store = mod.FileMembershipStore(str(tmp / "timeout"))
    store.propose_epoch({"epoch": 0, "members": [0], "reason": "found",
                         "step": None})
    c = _coord(mod, store, 1, num_hosts=2, join_timeout=0.3)
    with pytest.raises(mod.ElasticRemeshError, match="rejoin barrier"):
        c.join(step=1)
    out["timeout"] = c.parked
    return out


def test_coordinator_state_machine_matches_the_reference(tmp_path):
    port = _machine(trd, tmp_path / "port")
    ref = _machine(jrd, tmp_path / "ref")
    assert port == ref
    assert port["shrink"][1] == {0: (1, (0, 1)), 1: (1, (0, 1))}


def test_a_relaunched_rank_parks_until_the_grow(tmp_path):
    # the fleet has not shed the rank yet: a relaunch still parks, and
    # only a later epoch that lists it admits it
    store = trd.FileMembershipStore(str(tmp_path))
    store.propose_epoch({"epoch": 0, "members": [0, 1], "reason": "found",
                         "step": None})
    c = _coord(trd, store, 1, num_hosts=2, relaunched=True,
               join_timeout=10.0)
    assert c.parked and c.view == trd.MembershipView(0, (0,))
    got = {}
    th = threading.Thread(target=lambda: got.update(v=c.join(step=2)),
                          daemon=True)
    th.start()
    wait_until(lambda: store.pending_rejoins() == [1], what="rejoin")
    store.propose_epoch({"epoch": 1, "members": [0], "reason": "shrink",
                         "step": 3})
    store.propose_epoch({"epoch": 2, "members": [0, 1], "reason": "grow",
                         "step": 4})
    th.join(10.0)
    assert got["v"] == trd.MembershipView(2, (0, 1))


def test_membership_records_use_the_known_kind(tmp_path):
    exp = TelemetryExporter(str(tmp_path / "e.jsonl"), process_index=0)
    store = trd.FileMembershipStore(str(tmp_path / "m"))
    c = trd.ElasticCoordinator(rank=0, num_hosts=2, store=store,
                               bus_factory=trd.file_bus_factory(store, 1.0),
                               exporter=exp)
    exp.close()
    assert [e["kind"] for e in read_jsonl(str(tmp_path / "e.jsonl"))] == [
        "membership"]
    assert c.counters()["elastic_epochs_adopted"] == 0


# ---- geometry, loaders, config ----------------------------------------------------
@pytest.mark.parametrize("kw,before,after", [
    (dict(dp=8, pp=1, cp=1, ep=1, tp=2), 4, 2),
    (dict(dp=4, pp=1, cp=1, ep=1, tp=2), 2, 4),
    (dict(dp=6, pp=1, cp=1, ep=1, tp=2), 4, 3),
    (dict(dp=8, pp=1, cp=1, ep=1, tp=2), 4, 0),
    (dict(dp=4, pp=1, cp=1, ep=1, tp=1), 4, 3),
])
def test_elastic_mesh_kwargs_match_the_reference(kw, before, after):
    outs = []
    for mod in (tmesh, jmesh):
        try:
            outs.append(mod.elastic_mesh_kwargs(
                kw, hosts_before=before, hosts_after=after))
        except mod.MeshShrinkError as exc:
            outs.append(("refused", str(exc)))
    assert outs[0] == outs[1]


def _rows(n=64, seq=8):
    return np.tile(np.arange(n, dtype=np.int32)[:, None], (1, seq + 1))


def test_loaders_change_dp_like_the_reference():
    for pos in range(0, 9):
        for old in (2, 3, 4, 8):
            for new in (2, 3, 4, 8):
                assert tdl.remap_loader_position(
                    pos, old_samples_per_step=old, new_samples_per_step=new
                ) == jdl.remap_loader_position(
                    pos, old_samples_per_step=old, new_samples_per_step=new)
    outs = []
    for mod in (tdl, jdl):
        loader = mod.MicroBatchDataLoader(
            _rows(n=8), micro_batch_size=1, gradient_accumulation_steps=1,
            data_parallel_size=2, seed=7)
        errs = []
        for dp in (0, 16):
            try:
                loader.set_data_parallel_size(dp)
            except ValueError as exc:
                errs.append(str(exc))
        loader.set_data_parallel_size(4)
        big = mod.MicroBatchDataLoader(
            _rows(), micro_batch_size=1, gradient_accumulation_steps=1,
            data_parallel_size=4, seed=7)
        it = iter(big)
        for _ in range(3):
            next(it)
        big.set_data_parallel_size(2)
        big.set_state(mod.remap_loader_position(
            3, old_samples_per_step=4, new_samples_per_step=2))
        syn = mod.SyntheticDataLoader(
            vocab_size=16, sequence_length=8, micro_batch_size=2,
            gradient_accumulation_steps=1, data_parallel_size=2)
        syn.set_data_parallel_size(4)
        outs.append((errs, loader.samples_per_step, big.position,
                     next(iter(big))["input_ids"].tolist(),
                     syn.global_batch_size))
    assert outs[0] == outs[1]


ELASTIC_CASES = [
    dict(num_processes=4, data_parallel_size=8, elastic_min_hosts=2),
    dict(),
    dict(resume="off"),
    dict(resume="must"),
    dict(num_processes=2, data_parallel_size=2, elastic_min_hosts=4),
    dict(num_processes=4, data_parallel_size=6),
    dict(ft_kill_host_at_step=-1),
    dict(ft_host_hang_elastic=-2),
    dict(ft_kill_host=-5),
    dict(ft_host_hang_seconds=0.0),
    dict(elastic_min_hosts=0),
    dict(elastic_heartbeat_seconds=0.0),
    dict(elastic_deadline_seconds=-1.0),
    dict(ft_kill_host=-1),
]


@pytest.mark.parametrize("kw", ELASTIC_CASES)
def test_elastic_config_matrix_matches_the_reference(tmp_path, kw):
    outs = []
    for cls in (tconfig.ScaleTorchTPUArguments,
                jconfig.ScaleTorchTPUArguments):
        base = dict(elastic=True, resume="auto")
        if kw:  # the empty case: no checkpoint directory at all
            base["checkpoint_dir"] = str(tmp_path)
        try:
            cfg = cls(**{**base, **kw})
            outs.append(("ok", cfg.elastic, cfg.resume))
        except ValueError as exc:
            outs.append(("ValueError", str(exc).split(":")[0]))
    assert outs[0][0] == outs[1][0]
    if outs[0][0] == "ok":
        assert outs[0] == outs[1]


# ---- the drills over real processes ------------------------------------------------
def _launch(directory: Path, drill: dict, *, max_restarts: int,
            timeout: float = 150.0, nproc: int = 4,
            codes: tuple = (0, 43)) -> int:
    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / "drill.json", "w") as f:
        json.dump(drill, f)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "scaletorch_tpu_torch.launch",
           "--nproc", str(nproc), "--elastic", "--max-restarts",
           str(max_restarts),
           "--membership-dir", os.path.join(drill["cfg"]["checkpoint_dir"],
                                            "membership"),
           "--rdzv-dir", str(directory / "rdzv"), "--timeout", str(timeout),
           "--log-dir", str(directory / "logs"),
           "--events", str(directory / "events.jsonl"), "--",
           sys.executable, "-m", "tests.torch_dist_runtime", "elastic_rank",
           str(directory)]
    proc = subprocess.run(cmd, cwd=ROOT, env=env, timeout=timeout + 60,
                          capture_output=True, text=True)
    if proc.returncode not in codes:
        logs = "\n".join(
            f"--- {p.name}\n{p.read_text()[-3000:]}"
            for p in sorted((directory / "logs").glob("*.log")))
        raise AssertionError(f"launch exited {proc.returncode}\n"
                             f"{proc.stderr[-3000:]}\n{logs}")
    return proc.returncode


def _results(directory: Path) -> dict:
    out = {}
    for p in directory.glob("result_r*_a*.pkl"):
        with open(p, "rb") as f:
            r = pickle.load(f)
        out[(r["rank"], r["attempt"])] = r
    return out


def _drill_cfg(ckpt: Path, telem: Path, **kw) -> dict:
    return {**dict(data_parallel_size=4, elastic=True, resume="auto",
                   checkpoint_dir=str(ckpt), telemetry_dir=str(telem),
                   elastic_deadline_seconds=DEADLINE,
                   elastic_heartbeat_seconds=0.2), **kw}


def _transitions(telem: Path, rank: int) -> list:
    path = telem / f"events_proc{rank}.jsonl"
    return [e["transition"] for e in read_jsonl(str(path))
            if e.get("kind") == "membership"
            and e["transition"] != "steady"]


# where rank 2 dies: at the step-3 boundary through the injector (its
# peers learn of it on the decision bus), or inside step 4's backward
# (they learn of it in the gradients' all-reduce)
KILLS = {
    "boundary": dict(cfg=dict(ft_kill_host_at_step=3, ft_kill_host=2)),
    "backward": dict(kill_in_backward={"rank": 2, "after": 3}),
}


@pytest.fixture(scope="module", params=sorted(KILLS))
def kill_drill(request, tmp_path_factory):
    kill = KILLS[request.param]
    tmp = tmp_path_factory.mktemp("kill")
    ckpt, telem = tmp / "ckpt", tmp / "telem"
    drill = {"cfg": _drill_cfg(ckpt, telem, **kill.get("cfg", {})),
             "grow_at": 4, "rejoin_wait_s": 60.0}
    if "kill_in_backward" in kill:
        drill["kill_in_backward"] = kill["kill_in_backward"]
    code = _launch(tmp / "drill", drill, max_restarts=1)
    return tmp, code, _results(tmp / "drill"), request.param


def test_kill_drill_shrinks_restores_and_regrows(kill_drill):
    tmp, code, res, where = kill_drill
    assert code == 0
    finishers = [res[(0, 0)], res[(1, 0)], res[(3, 0)], res[(2, 1)]]
    assert (2, 0) not in res  # SIGKILLed before it could write
    for r in finishers:
        assert r["step"] == 6
        assert r["view"] == (2, [0, 1, 2, 3])
        for name, a in finishers[0]["params"].items():
            np.testing.assert_array_equal(r["params"][name], a, err_msg=name)
    # the counters of the reference's test_kill_drill_shrink_restore_
    # regrow_bitwise
    c0 = res[(0, 0)]["counters"]
    assert c0 == {"elastic_epochs_adopted": 2.0,
                  "elastic_peer_loss_events": 1.0,
                  "elastic_suspect_rounds": 1.0, "elastic_shrinks": 1.0,
                  "elastic_grows": 1.0, "elastic_hosts_lost": 1.0,
                  "elastic_hosts_rejoined": 1.0, "elastic_evictions": 0.0}
    cb = res[(2, 1)]["counters"]
    assert (cb["elastic_epochs_adopted"], cb["elastic_hosts_rejoined"],
            cb["elastic_evictions"]) == (1.0, 1.0, 0.0)
    telem = tmp / "telem"
    for rank in (0, 1, 3):
        assert _transitions(telem, rank) == ["suspect", "shrink", "grow"]
    assert _transitions(telem, 2) == ["join"]
    store = trd.FileMembershipStore(str(tmp / "ckpt" / "membership"))
    assert [store.epoch(n)["reason"] for n in (0, 1, 2)] == [
        "found", "shrink", "grow"]
    assert store.epoch(1)["members"] == [0, 1, 3]
    assert store.pending_rejoins() == []
    assert os.path.exists(os.path.join(store.directory, "heartbeat_r0.json"))
    # the survivors restored step 2 at the shrink, and every member step 4
    # at the grow
    epochs = [e for e in res[(0, 0)]["timeline"] if e["event"] == "epoch"]
    assert [(e["epoch"], e["step"]) for e in epochs] == [(1, 2), (2, 4)]
    assert res[(0, 0)]["steps"] == [2, 4, 6]
    # the survivors learned of the loss where it happened: on the
    # decision bus at the boundary, in the training step's collective
    # otherwise
    for rank in (0, 1, 3):
        lost = next(e for e in res[(rank, 0)]["timeline"]
                    if e["event"] == "peer_lost")
        assert lost["step"] == 3
        on_bus = "collective transport failed" in lost["error"]
        assert on_bus == (where == "boundary"), lost


@pytest.mark.parametrize("kill_drill", ["boundary"], indirect=True)
def test_kill_drill_dp3_segment_is_a_fresh_dp3_restore(kill_drill, tmp_path):
    tmp, _, res, _ = kill_drill
    src = tmp / "ckpt"
    for step in (2, 4):
        dst = tmp_path / f"only{step}"
        dst.mkdir()
        shutil.copytree(src / str(step), dst / str(step))
    fresh = run_ranks(tmp_path, 3, "dp_segment", {
        "cfg": dict(data_parallel_size=3, checkpoint_dir=str(
            tmp_path / "only2")), "until": 4})
    from scaletorch_tpu_torch.parallel.mesh import using_mesh_manager

    with using_mesh_manager(None):
        drill = trainer_job({"cfg": dict(checkpoint_dir=str(
            tmp_path / "only4"), resume="must")})
    assert drill["step0"] == 4
    for r in fresh:
        assert r["start"] == 2
        for name, a in drill["params0"].items():
            np.testing.assert_array_equal(r["params"][name], a, err_msg=name)
        for name, a in drill["state0"].items():
            np.testing.assert_array_equal(r["state"][name], a, err_msg=name)


def test_hang_drill_evicts_the_wedged_rank(tmp_path):
    ckpt, telem = tmp_path / "ckpt", tmp_path / "telem"
    # the stall outlasts detection (one deadline) and the survivors'
    # roll call (two), and leaves them time to finish
    code = _launch(tmp_path / "drill", {
        "cfg": _drill_cfg(ckpt, telem, ft_host_hang_elastic=3,
                          ft_kill_host=2,
                          ft_host_hang_seconds=HANG_S),
        "join_timeout": 3.0}, max_restarts=0)
    res = _results(tmp_path / "drill")
    assert code == 43
    wedged = res[(2, 0)]
    assert "rejoin barrier" in wedged["remesh_error"]
    assert wedged["counters"]["elastic_evictions"] == 1.0
    survivors = [res[(r, 0)] for r in (0, 1, 3)]
    for r in survivors:
        assert r["step"] == 6 and r["view"] == (1, [0, 1, 3])
        for name, a in survivors[0]["params"].items():
            np.testing.assert_array_equal(r["params"][name], a, err_msg=name)
        assert r["counters"]["elastic_hosts_lost"] == 1.0
    for rank in (0, 1, 3):
        assert _transitions(telem, rank) == ["suspect", "shrink"]
    assert _transitions(telem, 2) == ["suspect", "parked"]
    # once it found its group gone, the wedged rank gave up within its
    # join deadline (3 s)
    assert wedged["timeline"][0]["event"] == "peer_lost"
    wedged_s = wedged["end"] - wedged["timeline"][0]["time"]
    assert wedged_s < 3.0 + 5.0, wedged_s


def test_a_repeated_loss_with_every_rank_alive_raises_its_error(tmp_path):
    # a deterministic error that reads as a lost peer: the roll call finds
    # every member alive and remeshes in place, at most
    # MAX_SPURIOUS_REMESHES times at one step; then the error itself ends
    # every rank, where an uncapped loop would restore and fail forever
    from scaletorch_tpu_torch.trainer.trainer import MAX_SPURIOUS_REMESHES

    ckpt, telem = tmp_path / "ckpt", tmp_path / "telem"
    code = _launch(tmp_path / "drill", {
        "cfg": _drill_cfg(ckpt, telem, data_parallel_size=2),
        "fail_step_after": 3}, max_restarts=0, nproc=2, codes=(1,))
    assert code == 1
    res = _results(tmp_path / "drill")
    rounds = float(MAX_SPURIOUS_REMESHES)
    for rank in (0, 1):
        r = res[(rank, 0)]
        assert r["error"].startswith("RuntimeError("), r["error"]
        assert "injected on every rank" in r["error"]
        c = r["counters"]
        assert (c["elastic_peer_loss_events"], c["elastic_suspect_rounds"],
                c["elastic_hosts_lost"]) == (rounds, rounds, 0.0)
        assert r["view"] == (MAX_SPURIOUS_REMESHES, [0, 1])
        assert r["step"] == 3
