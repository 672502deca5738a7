"""PyTorch port, the attention backend's A/B gate and ``flash_jax``.

The reference's ``SCALETORCH_TPU_DISABLE_PALLAS`` gate
(``scaletorch_tpu/ops/flash_attention.py``) is in the port's env
registry with the reference's parsing and default. The ``flash``
backend, asked for by name, goes through ``ops.flash.flash_attention``
(K1-K3 on the card, their plain versions here) whatever the gate says;
DISABLE, set by the caller, sends ``"auto"`` to the plain ``sdpa`` path
in ``resolve_attention_backend``. The reference's
``SCALETORCH_TPU_FORCE_PALLAS`` overrides TPU detection, which the port
does not have: it is not registered, and at any value it changes no
path. ``flash_jax`` is the A/B partner registered under the reference's
name: the ``sdpa`` backend behind the reference's head-count check,
held to ``flash`` at 2e-5 (fp32, two summation orders).
"""

import numpy as np
import pytest
import torch

import scaletorch_tpu.env as jenv
import scaletorch_tpu_torch.env as tenv
from scaletorch_tpu_torch.models import registry as tregistry
from scaletorch_tpu_torch.models.layers import sdpa_attention
from scaletorch_tpu_torch.ops import flash as tflash

FORCE, DISABLE = "SCALETORCH_TPU_FORCE_PALLAS", "SCALETORCH_TPU_DISABLE_PALLAS"
VALUES = [None, "1", "0", "true", "no"]


@pytest.fixture
def qkv():
    rng = np.random.default_rng(3)
    shapes = ((1, 4, 24, 16), (1, 2, 24, 16), (1, 2, 24, 16))
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in shapes]


@pytest.fixture
def flash_calls(monkeypatch):
    for name in (FORCE, DISABLE):
        monkeypatch.delenv(name, raising=False)
    calls = []
    original = tflash.flash_attention

    def counted(*args, **kwargs):
        calls.append(1)
        return original(*args, **kwargs)

    monkeypatch.setattr(tflash, "flash_attention", counted)
    return calls


def set_or_unset(monkeypatch, name, value):
    if value is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)


@pytest.mark.parametrize("value", VALUES)
def test_gates_parse_as_the_reference(monkeypatch, value):
    set_or_unset(monkeypatch, DISABLE, value)
    assert tenv.get_env(DISABLE) == jenv.get_env(DISABLE)


def test_no_gate_takes_the_kernels_path(qkv, flash_calls):
    out = tregistry.get_attention_backend("flash")(*qkv, causal=True)
    assert len(flash_calls) == 1
    torch.testing.assert_close(out, sdpa_attention(*qkv, causal=True),
                               atol=2e-5, rtol=0)


def test_disable_takes_the_plain_path(qkv, flash_calls, monkeypatch):
    monkeypatch.setenv("SCALETORCH_TPU_DISABLE_PALLAS", "1")
    assert tregistry.resolve_attention_backend("auto") == "sdpa"
    out = tregistry.get_attention_backend(
        tregistry.resolve_attention_backend("auto"))(*qkv, causal=False)
    assert flash_calls == []
    assert torch.equal(out, sdpa_attention(*qkv, causal=False))
    # a backend asked for by name stays that backend: flash is K1-K3
    assert tregistry.resolve_attention_backend("flash") == "flash"
    tregistry.get_attention_backend("flash")(*qkv, causal=False)
    assert len(flash_calls) == 1


def test_force_is_not_registered():
    with pytest.raises(KeyError):
        tenv.get_env(FORCE)
    assert FORCE not in tenv.env_snapshot()


@pytest.mark.parametrize("value", VALUES)
def test_force_changes_no_path(qkv, flash_calls, monkeypatch, value):
    set_or_unset(monkeypatch, FORCE, value)
    assert tregistry.resolve_attention_backend("auto") == "flash"
    out = tregistry.get_attention_backend("flash")(*qkv)
    assert len(flash_calls) == 1
    torch.testing.assert_close(out, sdpa_attention(*qkv, causal=True),
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_jax_is_sdpa_over_expanded_heads(qkv, flash_calls, causal):
    jax_like = tregistry.get_attention_backend("flash_jax")(*qkv,
                                                            causal=causal)
    flash = tregistry.get_attention_backend("flash")(*qkv, causal=causal)
    torch.testing.assert_close(jax_like, flash, atol=2e-5, rtol=0)
    with pytest.raises(ValueError, match="multiple"):
        tregistry.get_attention_backend("flash_jax")(qkv[0][:, :3], *qkv[1:])
