"""PyTorch port, the resilience layer on the CPU, held to the JAX
package's: the same inputs through both modules must give the same
decisions.

* ``DivergenceSentinel``: seeded loss streams with NaNs, infs and spikes
  under each policy give equal actions, counters, EMAs and raised
  errors; the rollback budget aborts before the excess restore.
* ``FaultInjector`` and ``ResilienceManager`` built ``from_config`` on
  the same config and environment have equal fields and take equal
  ``maybe_*``/``take_*`` decisions over steps 1-20 (the SIGTERM, hang and
  kill drills delivered through recorders).
* ``PreemptionHandler`` on a real SIGTERM (raised only while it is
  installed), the second-SIGINT escape, uninstall restoring the previous
  handlers.
* ``HangWatchdog`` fires within its timeout and poll interval on a
  stalled main thread, writes a crash report with the thread stacks and
  the config fingerprint, and calls a recording ``exit_fn`` with 43 (each
  wait bounded, at most 2 s); ``config_fingerprint`` and the crash report
  layout match the reference's.
* The env registry holds only names the port reads, each with the
  reference's value; the resilience / telemetry config fields, their
  defaults and their validation match the reference's; a value that asks
  for more than one process is refused.
"""

import dataclasses
import json
import os
import signal
import threading
import time

import numpy as np
import pytest

from scaletorch_tpu import config as jconfig
from scaletorch_tpu import env as jenv
from scaletorch_tpu import resilience as jres
from scaletorch_tpu import resilience_distributed as jdist
from scaletorch_tpu_torch import config as tconfig
from scaletorch_tpu_torch import env as tenv
from scaletorch_tpu_torch import resilience as tres
from scaletorch_tpu_torch import resilience_distributed as tdist


def loss_stream(seed, n=40):
    """A decaying loss with NaNs, infs and spikes at seeded steps."""
    rng = np.random.default_rng(seed)
    losses = 4.0 * np.exp(-np.arange(n) / 30) + rng.normal(0, 0.02, n)
    for i in rng.choice(n, 6, replace=False):
        losses[i] = rng.choice([np.nan, np.inf, -np.inf, losses[i] * 5.0])
    return [float(x) for x in losses]


def run_sentinel(mod, policy, losses, **kw):
    s = mod.DivergenceSentinel(policy=policy, **kw)
    out = []
    for step, loss in enumerate(losses, 1):
        try:
            action = s.observe(loss, step)
            if action == "rollback":
                s.ensure_rollback_budget()
                s.note_rollback()
            out.append(action)
        except mod.TrainingDivergedError as exc:
            out.append(f"raise: {exc}")
            break
    return out, s.counters(), s.ema, s.consecutive


@pytest.mark.parametrize("policy", ["skip", "rollback", "abort"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kw", [
    dict(),
    dict(spike_factor=2.0),
    dict(spike_factor=1.5, max_consecutive_anomalies=0, max_rollbacks=2),
    dict(spike_factor=3.0, ema_beta=0.5, max_consecutive_anomalies=2),
])
def test_sentinel_matches_the_reference(policy, seed, kw):
    losses = loss_stream(seed)
    assert (run_sentinel(tres, policy, losses, **kw)
            == run_sentinel(jres, policy, losses, **kw))


def test_sentinel_rejects_an_unknown_policy():
    for mod in (tres, jres):
        with pytest.raises(ValueError, match="divergence policy"):
            mod.DivergenceSentinel(policy="retry")


FT = dict(ft_nan_at_step=4, ft_fail_saves=2, ft_sigterm_at_step=6,
          ft_hang_at_step=8, ft_hang_seconds=0.01, ft_bad_batch_at_step=3,
          ft_slow_step_at_step=5, ft_slow_step_seconds=0.01,
          ft_kill_host_at_step=11, divergence_policy="rollback",
          sentinel_frequency=3, loss_spike_factor=2.5)


@pytest.mark.parametrize("env", [
    {},
    {"SCALETORCH_TPU_FT_NAN_STEP": "7", "SCALETORCH_TPU_FT_FAIL_SAVES": "0"},
    {"SCALETORCH_TPU_FT_SIGTERM_STEP": "2",
     "SCALETORCH_TPU_FT_SLOW_STEP_SECONDS": "0.02",
     "SCALETORCH_TPU_FT_BAD_BATCH_STEP": "9"},
])
def test_injector_and_manager_match_the_reference(monkeypatch, env):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    decisions = []
    for mod, cfgmod in ((tres, tconfig), (jres, jconfig)):
        cfg = cfgmod.ScaleTorchTPUArguments(**FT)
        mgr = mod.ResilienceManager.from_config(cfg)
        inj = mgr.injector
        fields = {f.name: getattr(inj, f.name)
                  for f in dataclasses.fields(inj) if f.repr}
        events = []
        inj.host_index = 0
        inj.deliver_signal = lambda s, ev=events: ev.append(("signal", s))
        inj.deliver_kill = lambda ev=events: ev.append(("kill",))
        mgr.preemption = mod.PreemptionHandler()  # never installed
        trace = []
        for step in range(1, 21):
            loss = 2.0 + 0.01 * step
            metrics, action = mgr.after_step(
                step, {"loss": loss},
                rollback=lambda: step % 2 == 0)
            inj.maybe_slow_step(step)
            inj.maybe_kill(step)
            trace.append((step, action, str(metrics["loss"]),
                          inj.take_bad_read(step), inj.take_save_failure(),
                          list(events)))
        decisions.append((fields, trace, mgr.counters(),
                          mgr.sentinel_frequency, inj.active))
    assert decisions[0] == decisions[1]


def test_manager_follows_the_log_frequency_and_can_be_off():
    for mod, cfgmod in ((tres, tconfig), (jres, jconfig)):
        cfg = cfgmod.ScaleTorchTPUArguments(log_frequency=5)
        assert mod.ResilienceManager.from_config(cfg).sentinel_frequency == 5
        off = cfgmod.ScaleTorchTPUArguments(sentinel_frequency=0)
        mgr = mod.ResilienceManager.from_config(off)
        assert mgr.sentinel is None and mgr.counters() == {}


def test_preemption_handler_on_real_signals():
    prev = signal.getsignal(signal.SIGTERM)
    h = tres.PreemptionHandler().install()
    try:
        signal.raise_signal(signal.SIGTERM)
        assert h.requested and h.signum == signal.SIGTERM
        with pytest.raises(tres.PreemptionRequested):
            h.check()
        signal.raise_signal(signal.SIGINT)  # one SIGINT stays graceful
        with pytest.raises(KeyboardInterrupt):
            signal.raise_signal(signal.SIGINT)
    finally:
        h.uninstall()
    assert signal.getsignal(signal.SIGTERM) is prev
    with tres.PreemptionHandler() as h2:
        h2.trigger()
        assert h2.requested
    assert signal.getsignal(signal.SIGTERM) is prev


def test_hang_watchdog_fires_on_a_stalled_main_thread(tmp_path):
    exits, fired = [], threading.Event()
    cfg = tconfig.ScaleTorchTPUArguments(seed=3)

    def report(info):
        path = tdist.write_crash_report(
            info["reason"], info["step"], directory=str(tmp_path),
            config=cfg, thread_stacks=info["thread_stacks"],
            monitor_records=[{"step": 1}], span_tail=[{"name": "x"}])
        fired.set()
        return path

    wd = tdist.HangWatchdog(0.2, poll_interval=0.05, crash_report=report,
                            exit_fn=exits.append)
    with wd:
        wd.beat(step=7, phase="step_dispatch")
        t0 = time.monotonic()
        assert fired.wait(timeout=2.0)
        latency = time.monotonic() - t0
    assert exits == [tdist.WATCHDOG_EXIT_CODE] and wd.fired
    # the timeout and a poll interval, with slack for a loaded machine
    assert latency < 2.0
    with open(tmp_path / "crash_report_step7.json") as f:
        rep = json.load(f)
    assert "MainThread" in rep["thread_stacks"]
    assert "fired.wait" in rep["thread_stacks"]["MainThread"]
    # the identity fields (the parallel sizes too) read as the reference's
    ours = rep["config_fingerprint"]
    theirs = jdist.config_fingerprint(jconfig.ScaleTorchTPUArguments(seed=3))
    assert set(ours) == set(theirs) == {
        "sha256", "model_type", "total_train_steps", "seed",
        "divergence_policy", "data_parallel_size", "tensor_parallel_size",
        "pipeline_parallel_size", "context_parallel_size",
        "expert_parallel_size"}
    assert all(ours[k] == theirs[k] for k in ours if k != "sha256")
    assert rep["monitor_records"] == [{"step": 1}]
    assert rep["span_timeline_tail"] == [{"name": "x"}]
    theirs = json.load(open(jdist.write_crash_report(
        "r", 7, directory=str(tmp_path / "ref"))))
    assert sorted(theirs) == sorted(rep)
    with pytest.raises(ValueError):
        tdist.HangWatchdog(0)


def test_a_beating_watchdog_never_fires():
    exits = []
    wd = tdist.HangWatchdog(1.0, poll_interval=0.05, exit_fn=exits.append)
    with wd:
        for _ in range(8):
            wd.beat(phase="step_boundary")
            time.sleep(0.05)
    assert not wd.fired and exits == []


def test_coordinated_resilience_is_the_local_manager():
    cfg = tconfig.ScaleTorchTPUArguments(ft_nan_at_step=2,
                                         sentinel_frequency=1)
    mgr = tres.ResilienceManager.from_config(cfg)
    coord = tdist.CoordinatedResilience.from_config(cfg, mgr)
    assert not coord.coordinated and coord.enabled
    assert coord.should_stop() is False
    coord.verify_agreement("step", 3)
    _, action = coord.after_step(2, {"loss": 1.0}, position=2)
    assert action == "skip" and coord.counters() == mgr.counters()
    assert coord.straggler_counters() == {}
    assert (tdist.DIVERGED_EXIT_CODE, tdist.WATCHDOG_EXIT_CODE,
            tdist.SERVING_STALL_EXIT_CODE) == (
        jdist.DIVERGED_EXIT_CODE, jdist.WATCHDOG_EXIT_CODE,
        jdist.SERVING_STALL_EXIT_CODE)


@pytest.mark.parametrize("env", [{}, {"SCALETORCH_TPU_FT_HANG_TIMEOUT": "2.5",
                                      "SCALETORCH_TPU_FT_COORDINATE": "0"}])
def test_config_readers_match_the_reference(monkeypatch, env):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    t = tconfig.ScaleTorchTPUArguments(ft_hang_timeout=1.0)
    j = jconfig.ScaleTorchTPUArguments(ft_hang_timeout=1.0)
    assert tdist.hang_timeout_from_config(t) == \
        jdist.hang_timeout_from_config(j)
    assert tdist.coordinate_from_config(t) == \
        jdist.coordinate_from_config(j)
    # the port registers a subset of the reference's names (those it
    # reads); on each of them the two registries give the same value
    port, ref = tenv.env_snapshot(), jenv.env_snapshot()
    assert set(port) <= set(ref)
    assert port == {name: ref[name] for name in port}


def test_every_registered_env_name_is_read_by_the_port():
    # a registered name no module reads is a setting that env_snapshot
    # reports and the port ignores
    package = os.path.dirname(tenv.__file__)
    sources = ""
    for folder, _, files in os.walk(package):
        for name in files:
            path = os.path.join(folder, name)
            if name.endswith(".py") and path != tenv.__file__:
                with open(path) as f:
                    sources += f.read()
    unread = [name for name in tenv.env_snapshot()
              if f'"{name}"' not in sources]
    assert unread == []


def field_defaults(cls):
    return {f.name: f.default for f in dataclasses.fields(cls)}


@pytest.mark.parametrize("name", ["ResilienceArguments",
                                  "TelemetryArguments"])
def test_runtime_fields_match_the_reference(name):
    assert field_defaults(getattr(tconfig, name)) == \
        field_defaults(getattr(jconfig, name))


@pytest.mark.parametrize("kw,match", [
    (dict(divergence_policy="retry"), "divergence_policy"),
    (dict(loss_spike_factor=0.5), "loss_spike_factor"),
    (dict(loss_ema_beta=1.0), "loss_ema_beta"),
    (dict(sentinel_frequency=-2), "sentinel_frequency"),
    (dict(ft_nan_at_step=-1), "ft_nan_at_step"),
    (dict(ft_hang_timeout=-1.0), "ft_hang_timeout"),
    (dict(ft_hang_seconds=0.0), "ft_hang_seconds"),
    (dict(ft_serve_submit_storm_count=0), "ft_serve_submit_storm_count"),
    (dict(profile_on_slow_step=0.5), "profile_on_slow_step"),
    (dict(profile_steps="3"), "profile_steps"),
    (dict(profile_steps="2:4"), "telemetry directory"),
    (dict(straggler_factor=1.0), "straggler_factor"),
    (dict(trace_max_events=0), "trace_max_events"),
])
def test_runtime_validation_matches_the_reference(kw, match):
    for cls in (tconfig.ScaleTorchTPUArguments,
                jconfig.ScaleTorchTPUArguments):
        with pytest.raises(ValueError, match=match):
            cls(**kw)


@pytest.mark.parametrize("kw", [dict(elastic=True), dict(ft_sigterm_host=1),
                                dict(ft_kill_host=2),
                                dict(ft_host_hang_elastic=3)])
def test_multi_process_values_are_refused(kw):
    # the port validates the multi-process values as the reference does:
    # both accept, or both raise the same ValueError
    outcomes = []
    for cls in (tconfig.ScaleTorchTPUArguments,
                jconfig.ScaleTorchTPUArguments):
        try:
            cfg = cls(**kw)
            outcomes.append(("ok", {k: getattr(cfg, k) for k in kw}))
        except ValueError as exc:
            outcomes.append(("ValueError", str(exc)))
    assert outcomes[0] == outcomes[1]
    # elastic without a checkpoint directory is refused; the drill
    # targets of one process are accepted
    assert outcomes[0][0] == ("ValueError" if "elastic" in kw else "ok")


def test_cli_parses_the_runtime_flags(tmp_path):
    cfg = tconfig.parse_args([
        "--divergence_policy", "rollback", "--ft_nan_at_step", "5",
        "--handle_preemption", "false", "--telemetry_dir", str(tmp_path),
        "--profile_steps", "2:4", "--ft_hang_timeout", "30"])
    assert (cfg.divergence_policy, cfg.ft_nan_at_step, cfg.handle_preemption,
            cfg.profile_steps, cfg.ft_hang_timeout) == (
        "rollback", 5, False, "2:4", 30.0)
    assert os.fspath(tmp_path) == cfg.telemetry_dir
