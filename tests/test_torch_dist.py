"""PyTorch port, the multi-process bootstrap (``scaletorch_tpu_torch/
dist.py``) against the JAX package's ``scaletorch_tpu/dist.py``.

Launcher discovery (torchrun, SLURM and MPI variables, their order, the
stale ``WORLD_SIZE`` that must not flip a single process) gives the
reference's answer for the same environment; the rendezvous reads the
same names. The object collectives run in 4 gloo processes
(``tests/torch_dist_harness.py``: a FileStore rendezvous, bounded waits,
no JAX in the ranks) and at one process against the reference's
single-process identities. Exact comparisons: no arithmetic.
"""

import pytest

from scaletorch_tpu import dist as jdist
from scaletorch_tpu_torch import dist as tdist
from tests.torch_dist_harness import run_ranks

LAUNCH_VARS = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
               "MASTER_ADDR", "MASTER_PORT", "SLURM_NTASKS", "SLURM_PROCID",
               "SLURM_STEP_NODELIST", "SLURM_NODELIST",
               "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK",
               "JAX_NUM_PROCESSES", "NUM_PROCESSES", "WORLD_SIZE",
               "JAX_PROCESS_ID", "PROCESS_ID", "RANK", "LOCAL_RANK")

ENVIRONMENTS = {
    "none": {},
    "stale_world_size": {"WORLD_SIZE": "8"},
    "torchrun": {"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "29501",
                 "WORLD_SIZE": "4", "RANK": "2", "LOCAL_RANK": "2"},
    "jax_names": {"JAX_COORDINATOR_ADDRESS": "h:1234",
                  "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "1"},
    "slurm_one_task": {"SLURM_NTASKS": "1", "SLURM_PROCID": "0"},
    "slurm": {"SLURM_NTASKS": "4", "SLURM_PROCID": "3",
              "SLURM_STEP_NODELIST": "gpu[03-04,9],x1"},
    "mpi": {"OMPI_COMM_WORLD_SIZE": "2", "OMPI_COMM_WORLD_RANK": "1",
            "MASTER_ADDR": ""},
    "torchrun_over_slurm": {"MASTER_ADDR": "a", "SLURM_NTASKS": "4"},
}


@pytest.fixture
def environ(monkeypatch):
    for name in LAUNCH_VARS:
        monkeypatch.delenv(name, raising=False)

    def set_env(values):
        for k, v in values.items():
            monkeypatch.setenv(k, v)

    return set_env


@pytest.mark.parametrize("env", list(ENVIRONMENTS))
def test_infer_launcher_matches_the_reference(environ, env):
    environ(ENVIRONMENTS[env])
    assert tdist.infer_launcher() == jdist.infer_launcher()


def test_rendezvous_reads_each_launchers_variables(environ):
    environ(ENVIRONMENTS["torchrun"])
    assert tdist._rendezvous("env", None, None, None) == (
        "tcp://10.0.0.1:29501", 4, 2)
    assert tdist.local_rank() == 2
    # flags win over the environment; a URL is used as it is
    assert tdist._rendezvous("env", "file:///tmp/s", 2, 0) == (
        "file:///tmp/s", 2, 0)
    environ({"MASTER_ADDR": "", "JAX_COORDINATOR_ADDRESS": "h:1234",
             "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "1"})
    assert tdist._rendezvous("env", None, None, None) == (
        "tcp://h:1234", 2, 1)
    environ(ENVIRONMENTS["slurm"])
    assert tdist._slurm_first_host() == "gpu03"
    assert tdist._rendezvous("slurm", None, None, None)[1:] == (4, 3)
    environ(ENVIRONMENTS["mpi"])
    assert tdist._rendezvous("mpi", "m:1", None, None) == ("tcp://m:1", 2, 1)


def test_bootstrap_refuses_what_it_cannot_resolve(environ):
    assert tdist.init_distributed("none") is False
    assert tdist.init_distributed("auto", device="cpu") is False
    with pytest.raises(ValueError, match="launcher must be"):
        tdist.init_distributed("pbs", device="cpu")
    with pytest.raises(ValueError, match="coordinator_address"):
        tdist.init_distributed("env", device="cpu")
    with pytest.raises(ValueError, match="coordinator_address"):
        jdist.init_distributed("env")


def test_one_process_identities_match_the_reference():
    obj = {"a": [1, 2], "b": ("x", None)}
    assert tdist.all_gather_object(obj) == jdist.all_gather_object(obj)
    assert tdist.gather_object(5) == jdist.gather_object(5) == [5]
    assert (tdist.broadcast_object_list([1, {"k": 2}])
            == jdist.broadcast_object_list([1, {"k": 2}]))
    assert tdist.process_index() == jdist.process_index() == 0
    assert tdist.process_count() == jdist.process_count() == 1
    assert tdist.is_main_process() and not tdist.is_distributed()
    tdist.barrier()


def test_object_collectives_over_four_gloo_processes(tmp_path):
    res = run_ranks(tmp_path, 4, "dist")
    gathered = [{"rank": r, "sq": r * r} for r in range(4)]
    for r, out in enumerate(res):
        assert out["index"] == r and out["count"] == 4
        assert out["main"] == (r == 0) and out["distributed"]
        assert out["backend"] == "gloo"
        assert out["gathered"] == gathered
        assert out["rooted"] == ([f"r{i}" for i in range(4)] if r == 1
                                 else None)
        assert out["broadcast"] == ["mine-0", 0]
        # a length mismatch is refused on every rank but the source
        assert (out["refused"] is None) == (r == 0)
