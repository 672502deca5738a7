"""PyTorch port, coordinated control decisions over real processes: the
port's ``Trainer`` in 4 gloo processes (tiny Qwen3, fp32) against the
outcomes the reference's ``TestMultiHostTrainer``
(tests/test_resilience_distributed.py) fixes for its 4 simulated hosts
over ``FakeBus``:

* SIGTERM delivered to rank 2 alone after step 3: every rank saves one
  emergency checkpoint at step 3 and stops, ``(True, 3, True, 3)``;
* a NaN loss on rank 1 alone under ``rollback``: every rank rolls back,
  ``(6, 1.0, 1, [2, 4, 6])``;
* a NaN on rank 0 under ``abort``: every rank raises
  ``TrainingDivergedError`` and leaves a crash report;
* the straggler drill of tests/test_telemetry.py on the real bus: rank
  0's detector names the slowed rank; the trainer attaches it on a
  coordinated run.

The control runs the parent's per-process decisions (``ft_coordinate``
false) under the same one-rank SIGTERM: rank 2 enters the emergency save
alone while its peers enter step 4, so the run fails its bounded waits
(the process group's timeout is cut to 8 s) or ends ranks at different
steps. Every wait is bounded (``tests/torch_dist_harness.run_ranks``).
"""

import glob
import json

import numpy as np
import pytest

from tests.torch_dist_harness import run_ranks

WORLD = 4


def _scenarios(tmp_path, **common):
    def where(name):
        return dict(checkpoint_dir=str(tmp_path / name / "ckpt"),
                    crash_report_dir=str(tmp_path / name / "crash"),
                    data_parallel_size=WORLD, **common)

    return {
        "sigterm": {"cfg": dict(where("sigterm"), ft_sigterm_at_step=3,
                                ft_sigterm_host=2, straggler_factor=2.0,
                                log_frequency=1)},
        "rollback": {"cfg": dict(where("rollback"),
                                 divergence_policy="rollback"),
                     "per_rank": {1: dict(ft_nan_at_step=3)}},
        "abort": {"cfg": dict(where("abort"), divergence_policy="abort"),
                  "per_rank": {0: dict(ft_nan_at_step=3)}},
    }


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("coordinated")
    res = run_ranks(tmp, WORLD, "coordinated_fleet",
                    {"scenarios": _scenarios(tmp)})
    return tmp, res


def test_one_rank_sigterm_is_a_collective_emergency_save(fleet):
    _, res = fleet
    got = [(r["sigterm"]["preempted"], r["sigterm"]["step"],
            r["sigterm"]["saved"], r["sigterm"]["latest"]) for r in res]
    # the reference's test_one_host_sigterm_collective_emergency_save
    assert got == [(True, 3, True, 3)] * WORLD
    assert all(r["sigterm"]["coordinated"] for r in res)
    for r in res[1:]:
        for name, a in r["sigterm"]["params"].items():
            np.testing.assert_array_equal(a, res[0]["sigterm"]["params"][name])


def test_one_rank_nan_rolls_back_the_fleet(fleet):
    _, res = fleet
    got = [(r["rollback"]["step"], r["rollback"]["rollbacks"],
            r["rollback"]["skew"], r["rollback"]["steps"]) for r in res]
    # the reference's test_rollback_decision_identical_on_all_hosts
    assert got == [(6, 1.0, 1, [2, 4, 6])] * WORLD
    assert len({json.dumps(r["rollback"]["counters"], sort_keys=True)
                for r in res}) == 1


def test_abort_is_lockstep_and_leaves_crash_reports(fleet):
    tmp, res = fleet
    assert all(r["abort"]["diverged"] for r in res)
    assert all(r["abort"]["step"] == 3 for r in res)
    # the reference's test_abort_is_lockstep_and_leaves_crash_reports
    reports = sorted(glob.glob(str(tmp / "abort" / "crash" / "*.json")))
    assert len(reports) == WORLD
    body = json.loads(open(reports[0]).read())
    assert body["step"] == 3
    assert body["counters"]["nonfinite_losses"] == 1.0
    assert body["config_fingerprint"]["divergence_policy"] == "abort"


def test_stragglers_flag_the_slowed_rank_on_rank_0(tmp_path, fleet):
    slow = 2
    res = run_ranks(tmp_path, WORLD, "straggler_protocol",
                    {"slow": slow, "slow_s": 0.08, "fast_s": 0.005})
    assert all(r["actions"] == ["ok"] * 5 for r in res)
    # the reference's test_fakebus_delayed_host_surfaces_in_straggler_report
    assert res[0]["summary"]["step_time_argmax_host"] == slow
    assert res[0]["counters"]["straggler_host"] == slow
    assert res[0]["counters"]["straggler_flags"] >= 1
    assert res[1]["counters"] == {}
    # the Trainer attaches the detector on a coordinated run, and rank 0's
    # records carry its counters
    _, fleet_res = fleet
    assert all(r["sigterm"]["straggler"] for r in fleet_res)
    assert "straggler_flags" in fleet_res[0]["sigterm"]["history"][-1]


def test_control_per_process_decisions_desync_the_fleet(tmp_path):
    """The parent's arm: each rank decides alone. Rank 2 stops after step
    3 and enters a collective save its peers never join."""
    scenario = _scenarios(tmp_path, ft_coordinate=False)["sigterm"]
    try:
        res = run_ranks(tmp_path, WORLD, "coordinated_fleet",
                        {"scenarios": {"sigterm": scenario}}, timeout=90,
                        env={"TORCH_DIST_CASE_TIMEOUT_S": "8"})
    except AssertionError as exc:
        assert "failed" in str(exc) or "timed out" in str(exc)
        return
    steps = {r["sigterm"]["step"] for r in res}
    assert len(steps) > 1, f"the control did not show the fault: {steps}"


@pytest.mark.parametrize("drift", [False, True])
def test_a_step_is_one_gather_and_a_drifted_rank_obeys_rank_0(drift):
    # the reference's test_drifted_host_obeys_host0_broadcast (and its
    # undrifted twin) through both packages over the reference's FakeBus
    # threads: the same actions and sentinel counters on every host. The
    # port forms host 0's decision on every host from the one gather
    # while the sentinels agree, and falls back to host 0's broadcast
    # when one has drifted
    from scaletorch_tpu import resilience as jres
    from scaletorch_tpu import resilience_distributed as jrd
    from scaletorch_tpu_torch import resilience as tres
    from scaletorch_tpu_torch import resilience_distributed as trd
    from tests.test_resilience_distributed import run_hosts

    def run(res, rd):
        calls = []

        def host(i, bus):
            def gather(obj):
                calls.append("gather")
                return bus.all_gather(obj)

            def broadcast(objs, src=0):
                calls.append("broadcast")
                return bus.broadcast(objs)

            mgr = res.ResilienceManager(
                sentinel=res.DivergenceSentinel(policy="skip",
                                                spike_factor=2.0),
                injector=res.FaultInjector(), sentinel_frequency=1)
            mgr.sentinel.ema = 100.0 if drift and i == 1 else 1.0
            coord = rd.CoordinatedResilience(mgr, bus=rd.DecisionBus(
                num_processes=2, process_index=i, all_gather=gather,
                broadcast=broadcast))
            _, action = coord.after_step(5, {"loss": 3.0})
            return action, mgr.sentinel.counters()

        results, errors = run_hosts(2, host)
        assert errors == [None, None]
        return results, sorted(calls)

    port, port_calls = run(tres, trd)
    ref, ref_calls = run(jres, jrd)
    assert port == ref
    assert [a for a, _ in port] == ["skip", "skip"]
    assert ref_calls == ["broadcast"] * 2 + ["gather"] * 2
    assert port_calls == (ref_calls if drift else ["gather"] * 2)
