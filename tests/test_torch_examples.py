"""PyTorch port, the examples' mains on the CPU (``--device cpu``).

  * minGPT (``scaletorch_tpu_torch.examples.mingpt.train_mingpt``), dense
    and ``--use_moe true``, a few dozen steps at block 64: the eval NLL
    falls between its two evals and ends below ln(vocab), and a sample is
    printed;
  * MNIST (``scaletorch_tpu_torch.examples.mnist.train_mnist``) with
    ``--limit_steps``: a finite last loss and the test accuracy printed;
  * one device only: ``--data_parallel 2`` (both) and ``--fsdp`` (MNIST)
    raise, naming ROADMAP's examples-over-the-mesh item;
  * the port's ``build_model_config`` refuses ``lenet``, ``gpt_moe`` and
    ``mingpt`` and names the example mains.
The steps themselves are held to the JAX package's in
``tests/test_torch_gpt_moe.py`` (three minGPT steps against its optax
chain) and ``tests/test_torch_lenet.py`` (three Adadelta + StepLR
steps).
"""

import math
import re

import pytest

from scaletorch_tpu_torch.config import ScaleTorchTPUArguments
from scaletorch_tpu_torch.examples.mingpt import train_mingpt
from scaletorch_tpu_torch.examples.mnist import train_mnist
from scaletorch_tpu_torch.trainer.trainer import build_model_config

MINGPT = ["--device", "cpu", "--block_size", "64", "--batch_size", "16",
          "--eval_interval", "20", "--eval_batches", "2",
          "--sample_tokens", "8"]


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


@pytest.mark.parametrize("main,argv", [
    (train_mingpt.main, ["--data_parallel", "2"]),
    (train_mnist.main, ["--data_parallel", "2"]),
    (train_mnist.main, ["--fsdp"]),
])
def test_more_than_one_device_is_refused(main, argv):
    with pytest.raises(ValueError, match="ROADMAP item 9c"):
        main(["--device", "cpu"] + argv)


@pytest.mark.parametrize("model_type,example", [
    ("lenet", "scaletorch_tpu_torch.examples.mnist.train_mnist"),
    ("gpt_moe", "scaletorch_tpu_torch.examples.mingpt.train_mingpt"),
    ("mingpt", "scaletorch_tpu_torch.examples.mingpt.train_mingpt"),
])
def test_trainer_points_example_models_to_their_mains(model_type, example):
    cfg = ScaleTorchTPUArguments(model_type=model_type)
    with pytest.raises(ValueError, match=re.escape(example)):
        build_model_config(cfg)
