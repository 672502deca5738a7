"""PyTorch port, the examples' mains on the CPU (``--device cpu``).

  * minGPT (``scaletorch_tpu_torch.examples.mingpt.train_mingpt``), dense
    and ``--use_moe true``, a few dozen steps at block 64: the eval NLL
    falls between its two evals and ends below ln(vocab), and a sample is
    printed;
  * MNIST (``scaletorch_tpu_torch.examples.mnist.train_mnist``) with
    ``--limit_steps``: a finite last loss and the test accuracy printed;
  * their mesh arms over 2 gloo ranks: minGPT's and MNIST's data
    parallelism and MNIST's ``--fsdp`` give one device's losses within
    1e-5 (``--fsdp`` holding a slice of each leaf whose leading dim
    splits), and a ``--data_parallel`` other than the world is refused;
  * the port's ``build_model_config`` refuses ``lenet``, ``gpt_moe`` and
    ``mingpt`` and names the example mains.
The steps themselves are held to the JAX package's in
``tests/test_torch_gpt_moe.py`` (three minGPT steps against its optax
chain) and ``tests/test_torch_lenet.py`` (three Adadelta + StepLR
steps).
"""

import importlib
import math
import re

import numpy as np
import pytest

from scaletorch_tpu_torch.config import ScaleTorchTPUArguments
from scaletorch_tpu_torch.examples.mingpt import train_mingpt
from scaletorch_tpu_torch.examples.mnist import train_mnist
from scaletorch_tpu_torch.trainer.trainer import build_model_config
from tests.test_torch_one_thread import one_torch_thread  # noqa: F401
from tests.torch_dist_harness import run_ranks


MINGPT = ["--device", "cpu", "--block_size", "64", "--batch_size", "16",
          "--eval_interval", "20", "--eval_batches", "2",
          "--sample_tokens", "8"]
MNIST = ["--device", "cpu", "--epochs", "1", "--batch_size", "64",
         "--limit_steps", "6", "--log_interval", "1000"]
LOSS_TOL = 1e-5


@pytest.mark.parametrize("moe", [False, True])
def test_mingpt_learns(moe, capsys):
    argv = MINGPT + ["--steps", "40"]
    if moe:
        argv += ["--use_moe", "true"]
    last = train_mingpt.main(argv)
    out = capsys.readouterr().out
    evals = [float(v) for v in re.findall(r"eval_nll ([0-9.]+)", out)]
    vocab = int(re.search(r"vocab=(\d+)", out).group(1))
    assert len(evals) == 2 and evals[-1] == pytest.approx(last, abs=1e-4)
    assert evals[1] < evals[0] < math.log(vocab) + 0.5
    assert last < math.log(vocab)
    assert "sample:" in out and "device=cpu" in out


def test_mnist_runs_to_a_finite_loss(capsys):
    last = train_mnist.main(["--device", "cpu", "--epochs", "1",
                             "--batch_size", "64", "--limit_steps", "8",
                             "--log_interval", "1000"])
    assert math.isfinite(last) and last < 3.0
    assert "test acc" in capsys.readouterr().out


MESH_ARMS = {
    "mingpt_dp2": ("mingpt.train_mingpt", MINGPT + ["--steps", "4"]),
    "mnist_dp2": ("mnist.train_mnist", MNIST),
    "mnist_fsdp2": ("mnist.train_mnist", MNIST + ["--fsdp"]),
}


@pytest.fixture(scope="module")
def mesh_arms(tmp_path_factory):
    """Each arm's losses on one device (this process) and over 2 gloo
    ranks, and what each rank holds."""
    runs = [{"module": mod, "argv": argv + ["--data_parallel", "2"],
             "keep": ["losses", "world"] + (["sharded", "param_numel"]
                                            if "mnist" in mod else [])}
            for mod, argv in MESH_ARMS.values()]
    res = run_ranks(tmp_path_factory.mktemp("mesh_arms"), 2, "example_run",
                    {"runs": runs}, timeout=180.0)
    out = {}
    for i, (name, (mod, argv)) in enumerate(MESH_ARMS.items()):
        one = importlib.import_module(
            f"scaletorch_tpu_torch.examples.{mod}").run(argv)
        out[name] = (one, [r[i] for r in res])
    return out


@pytest.mark.parametrize("name", sorted(MESH_ARMS))
def test_the_mesh_arms_run(mesh_arms, name):
    one, ranks = mesh_arms[name]
    for out in ranks:
        assert out["world"] == 2
        np.testing.assert_allclose(out["losses"], one["losses"],
                                   atol=LOSS_TOL, rtol=0)
        if name == "mnist_fsdp2":
            assert out["sharded"] and out["param_numel"] < one["param_numel"]


@pytest.mark.parametrize("main", [train_mingpt.main, train_mnist.main])
def test_a_data_parallel_other_than_the_world_is_refused(main):
    with pytest.raises(ValueError, match="world size 1"):
        main(["--device", "cpu", "--data_parallel", "2"])


@pytest.mark.parametrize("model_type,example", [
    ("lenet", "scaletorch_tpu_torch.examples.mnist.train_mnist"),
    ("gpt_moe", "scaletorch_tpu_torch.examples.mingpt.train_mingpt"),
    ("mingpt", "scaletorch_tpu_torch.examples.mingpt.train_mingpt"),
])
def test_trainer_points_example_models_to_their_mains(model_type, example):
    cfg = ScaleTorchTPUArguments(model_type=model_type)
    with pytest.raises(ValueError, match=re.escape(example)):
        build_model_config(cfg)
