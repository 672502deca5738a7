"""The rank side of the multi-process runtime's gloo tests (coordinated
decisions, the coordinated and resharding checkpoint, the sharded HF
export, elastic drills). ``tests/torch_dist_cases.py`` serves these
cases too (``python -m tests.torch_dist_cases CASE RANK WORLD DIR``), so
they run under ``tests/torch_dist_harness.run_ranks``; the elastic drills
run this module directly under ``scaletorch_tpu_torch.launch``
(``python -m tests.torch_dist_runtime elastic_rank DIR``). Nothing here
imports JAX (the rank processes check it); the tests import the helpers
to run the same jobs in one process.
"""

from __future__ import annotations

import json
import os
import pickle
import signal
import sys
import time

import numpy as np
import torch

from scaletorch_tpu_torch import dist as stdist
from scaletorch_tpu_torch.models.convert import flatten_params
from scaletorch_tpu_torch.trainer.optimizer import tree_leaves

ARCH = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            head_dim=16, max_position_embeddings=128,
            tie_word_embeddings=True, rope_theta=10000.0)
# the fleet drills' run: tiny Qwen3 in fp32, one row per dp rank
BASE = dict(model_type="qwen3", **ARCH, synthetic_data=True,
            sequence_length=16, dtype="float32", micro_batch_size=1,
            total_train_steps=6, save_frequency=2, learning_rate=1e-2,
            checkpoint_retry_base_delay=0.01, log_frequency=1000,
            sentinel_frequency=1, async_checkpointing=False)


def cfg_of(**kw):
    from scaletorch_tpu_torch.config import ScaleTorchTPUArguments

    return ScaleTorchTPUArguments(**{**BASE, **kw})


def tree_np(tree) -> dict:
    return {n: t.detach().to(torch.float32).numpy().copy()
            for n, t in flatten_params(tree).items()}


def state_np(state) -> dict:
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update({f"{k}.{n}": a for n, a in tree_np(v).items()})
        else:
            out[k] = v.detach().to(torch.float32).numpy().copy()
    return out


def token_loader(dp: int, seed: int = 5):
    """A loader that counts its position (the synthetic stream has none),
    over seeded token rows, so a restore re-seats the stream."""
    from scaletorch_tpu_torch.data.dataloader import MicroBatchDataLoader

    tokens = np.random.default_rng(seed).integers(
        0, ARCH["vocab_size"], size=(96, BASE["sequence_length"] + 1)
    ).astype(np.int32)
    return MicroBatchDataLoader(tokens, micro_batch_size=1,
                                gradient_accumulation_steps=1,
                                data_parallel_size=dp, seed=7)


# ---- coordinated decisions ----------------------------------------------------
def _fleet_run(scenario: dict, rank: int) -> dict:
    from scaletorch_tpu_torch.resilience import TrainingDivergedError
    from scaletorch_tpu_torch.trainer.trainer import Trainer

    kw = {**scenario["cfg"], **scenario.get("per_rank", {}).get(rank, {})}
    t = Trainer(cfg_of(**kw), device="cpu")
    out = {"coordinated": t.coordinator.coordinated,
           "straggler": t.coordinator.straggler is not None}
    try:
        t.train()
        out["diverged"] = None
    except TrainingDivergedError as exc:
        out["diverged"] = str(exc)
    finally:
        t.close()
    out.update(
        preempted=t.preempted, step=t.global_step,
        saved=t.emergency_checkpoint_saved,
        latest=t.checkpoint_manager.latest_step(),
        steps=t.checkpoint_manager.all_steps(),
        rollbacks=t.resilience.counters()["rollbacks"],
        skew=t._loader_skew, counters=t.resilience.counters(),
        params=tree_np(t.params),
        history=[{k: v for k, v in r.items()
                  if k.startswith("straggler")} for r in t.history])
    return out


def case_coordinated_fleet(payload):
    """Every scenario in turn on this fleet: a Trainer each, its own
    checkpoint directory."""
    rank = stdist.process_index()
    return {name: _fleet_run(sc, rank)
            for name, sc in payload["scenarios"].items()}


def case_straggler_protocol(payload):
    """The reference's straggler drill on the real bus: each rank
    'steps' by sleeping (one rank longer) and reports its time through
    ``after_step``; rank 0's detector names the slow rank."""
    from scaletorch_tpu_torch.parallel import mesh as tmesh
    from scaletorch_tpu_torch.resilience import ResilienceManager
    from scaletorch_tpu_torch.resilience_distributed import (
        CoordinatedResilience,
        DecisionBus,
    )
    from scaletorch_tpu_torch.telemetry import StragglerDetector

    mm = tmesh.MeshManager(dp=stdist.process_count(), device_type="cpu")
    bus = DecisionBus.default(mm.host_group())
    coord = CoordinatedResilience(
        ResilienceManager.from_config(cfg_of(sentinel_frequency=1)), bus=bus)
    if bus.is_main:
        coord.straggler = StragglerDetector(factor=2.0, patience=2,
                                            log_frequency=1)
    actions = []
    for step in range(1, 6):
        t0 = time.perf_counter()
        time.sleep(payload["slow_s"] if bus.process_index
                   == payload["slow"] else payload["fast_s"])
        dt = time.perf_counter() - t0
        _, action = coord.after_step(
            step, {"loss": 1.0},
            telemetry={"step_time": dt, "data_fetch_time": 0.0})
        actions.append(action)
    summary = (coord.straggler.last_summary
               if coord.straggler is not None else None)
    return {"actions": actions, "counters": coord.straggler_counters(),
            "summary": summary}


# ---- the coordinated checkpoint protocol ----------------------------------------
def _cm(directory, **kw):
    from scaletorch_tpu_torch.parallel import mesh as tmesh
    from scaletorch_tpu_torch.resilience_distributed import DecisionBus
    from scaletorch_tpu_torch.utils.checkpoint import CheckpointManager

    mm = tmesh.MeshManager(dp=stdist.process_count(), device_type="cpu")
    kw.setdefault("retry_base_delay", 0.01)
    kw.setdefault("async_save", False)
    return CheckpointManager(directory, decision_bus=DecisionBus.default(
        mm.host_group()), mesh=mm, split_dims={"w": {}},
        group=mm.checkpoint_group(), **kw)


def _tree(x=1.0):
    return {"w": torch.full((2, 3), x, dtype=torch.float32)}


def case_checkpoint_protocol(payload):
    """The reference's four TestCoordinatedCheckpoints cases, each in a
    directory of its own under ``payload['dir']``."""
    from scaletorch_tpu_torch.resilience import FaultInjector

    rank = stdist.process_index()
    root = payload["dir"]
    out = {}

    inj = FaultInjector(fail_saves=1 if rank == 0 else 0)
    cm = _cm(os.path.join(root, "lockstep"), retries=3, fault_injector=inj)
    ok = cm.save(1, params=_tree(), opt_state=_tree())
    cm.wait()
    out["lockstep"] = (ok, cm.all_steps())

    inj = FaultInjector(fail_saves=100 if rank == 1 else 0)
    cm = _cm(os.path.join(root, "exhausted"), retries=1, fault_injector=inj)
    out["exhausted"] = cm.save(1, params=_tree(), opt_state=_tree())

    # rank 0's listing already shows step 1 (a list-after-write lag on a
    # shared filesystem); its peer's does not
    cm = _cm(os.path.join(root, "mixed"), retries=2)
    if rank == 0:
        stale = iter([True])
        real = cm._listed
        cm._listed = lambda step: next(stale, None) or real(step)
    ok = cm.save(1, params=_tree(), opt_state=_tree())
    cm.wait()
    out["mixed"] = ok

    cm = _cm(os.path.join(root, "corrupt"), retries=0)
    for step in (1, 2):
        assert cm.save(step, params=_tree(step), opt_state=_tree())
    cm.wait()
    stdist.barrier()
    if rank == 0:  # one data file of the newest step goes missing
        victim = sorted(f for f in os.listdir(cm._step_dir(2))
                        if f.endswith(".distcp"))[0]
        os.unlink(os.path.join(cm._step_dir(2), victim))
    stdist.barrier()
    live, state = _tree(0.0), _tree(0.0)
    got = cm.load_latest(params=live, opt_state=state)
    out["corrupt"] = (got["step"] if got else None, float(live["w"][0, 0]),
                      cm.all_steps())
    return out


# ---- trainers: save, resume, reshard, export ----------------------------------
def trainer_job(job: dict) -> dict:
    """A Trainer of ``job['cfg']`` (restored at construction under
    ``resume``: ``params0``/``state0`` are the restored tensors): train
    ``steps``, optionally save (the per-rank bytes of the step), and an HF
    export when ``export`` names a directory."""
    from scaletorch_tpu_torch.trainer.trainer import Trainer

    rank = stdist.process_index()
    t = Trainer(cfg_of(**job["cfg"]), device="cpu")
    out = {"rank": rank, "coords": t.mm.my_coords.as_tuple(),
           "step0": t.global_step,
           "params0": tree_np(t.params), "state0": state_np(t.opt_state)}
    out["losses"] = [float(t.step()["loss"])
                     for _ in range(job.get("steps", 0))]
    if job.get("save"):
        out["saved"] = t.save_checkpoint()
        t.checkpoint_manager.wait()
        out["rank_bytes"] = t.checkpoint_manager.rank_bytes(t.global_step,
                                                            rank)
        out["step_bytes"] = t.checkpoint_manager.step_bytes(t.global_step)
    if job.get("export"):
        out["export"] = t.export_hf(job["export"], dtype="float32")
    out.update(params=tree_np(t.params), state=state_np(t.opt_state),
               step=t.global_step)
    t.close()
    return out


def case_trainer_jobs(payload):
    """``trainer_job`` of each job in turn on this fleet."""
    return [trainer_job(job) for job in payload["jobs"]]


# ---- elastic drills ----------------------------------------------------------
def _rank_result(path: str, result: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(result, f)
    os.replace(tmp, path)


def elastic_rank(directory: str) -> int:
    """One rank of an elastic drill under ``scaletorch_tpu_torch.launch``
    (``RANK``/``WORLD_SIZE``/``COORDINATOR_ADDRESS`` from it): the
    Trainer of ``directory/drill.json``'s config over a loader that counts
    its position, the kill drill's SIGKILL as the kill delivery (or, with
    ``kill_in_backward``, a SIGKILL inside the backward of the step after
    ``after``; or, with ``fail_step_after``, a step that fails on every
    rank with a transport-like error), and, at
    a grow boundary the drill names, a bounded wait for the relaunched
    rank's rejoin request (so the readmission lands at that boundary
    however long the relaunch took). Writes ``result_r<rank>_a<attempt>
    .pkl``; exits 43 on ``ElasticRemeshError``."""
    from scaletorch_tpu_torch.resilience_distributed import (
        WATCHDOG_EXIT_CODE,
        ElasticRemeshError,
    )
    from scaletorch_tpu_torch.trainer.trainer import Trainer

    with open(os.path.join(directory, "drill.json")) as f:
        drill = json.load(f)
    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    attempt = stdist.restart_count()
    t0 = time.time()
    t = Trainer(cfg_of(**drill["cfg"]), device="cpu")
    t.resilience.injector.deliver_kill = lambda: os.kill(os.getpid(),
                                                         signal.SIGKILL)
    kill = drill.get("kill_in_backward")
    if kill and kill["rank"] == rank and attempt == 0:
        # SIGKILLed while its peers run the same step: inside the
        # backward, before the gradients' all-reduce
        def die(grad):
            if t.global_step == kill["after"]:
                os.kill(os.getpid(), signal.SIGKILL)
            return grad

        tree_leaves(t.params)[0].register_hook(die)
    fail = drill.get("fail_step_after")
    if fail is not None:
        # every rank's step fails at the same step, every time, with an
        # error that reads as gloo's transport: a loss with every member
        # alive, again and again
        make = t._make_step_fn

        def failing_step_fn():
            step_fn = make()

            def step(*args):
                if t.global_step == fail:
                    raise RuntimeError("[gloo/transport/tcp/pair.cc:0] "
                                       "injected on every rank")
                return step_fn(*args)

            return step

        t._make_step_fn = failing_step_fn
        t.step_fn = failing_step_fn()
    if drill.get("join_timeout"):
        t.elastic.join_timeout = float(drill["join_timeout"])
    t.loader = token_loader(t.mesh_kwargs["dp"])
    grow_at = drill.get("grow_at")
    if grow_at:
        grow = t._maybe_elastic_grow

        def gated_grow():
            # every rank waits for the same file, so none sits in a
            # collective meanwhile
            if t.global_step == grow_at:
                deadline = time.monotonic() + drill["rejoin_wait_s"]
                while (not t.elastic.store.pending_rejoins()
                       and time.monotonic() < deadline):
                    time.sleep(0.02)
            grow()

        t._maybe_elastic_grow = gated_grow
    result = {"rank": rank, "attempt": attempt, "start": t0}
    code = 0
    try:
        t.train()
    except ElasticRemeshError as exc:
        result["remesh_error"] = str(exc)
        code = WATCHDOG_EXIT_CODE
    except RuntimeError as exc:
        if fail is None:
            raise
        result["error"] = repr(exc)
        code = 1
    result.update(step=t.global_step, params=tree_np(t.params),
                  state=state_np(t.opt_state), view=(
                      t.elastic.view.epoch, list(t.elastic.view.members)),
                  counters=t.elastic.counters(),
                  timeline=t.elastic_timeline,
                  steps=t.checkpoint_manager.all_steps() if code == 0
                  else None, end=time.time())
    if code == 0:
        t.close()
    _rank_result(os.path.join(directory, f"result_r{rank}_a{attempt}.pkl"),
                 result)
    stdist.shutdown_distributed()
    return code


def case_dp_segment(payload):
    """A fresh fleet restored from a copied checkpoint, over the drill's
    loader, trained to ``payload['until']``: the yardstick of the
    drill's shrunken segment."""
    from scaletorch_tpu_torch.trainer.trainer import Trainer

    t = Trainer(cfg_of(**payload["cfg"]), device="cpu")
    t.loader = token_loader(t.mesh_kwargs["dp"])
    assert t.load_checkpoint(required=True)
    start = t.global_step
    while t.global_step < payload["until"]:
        t.step()
    out = {"start": start, "params": tree_np(t.params),
           "state": state_np(t.opt_state)}
    t.close()
    return out


CASES = {name[len("case_"):]: fn for name, fn in globals().items()
         if name.startswith("case_")}


if __name__ == "__main__":
    assert "jax" not in sys.modules, "a rank process imported JAX"
    if sys.argv[1] != "elastic_rank":
        raise SystemExit(f"unknown entry {sys.argv[1]!r}")
    sys.exit(elastic_rank(sys.argv[2]))
