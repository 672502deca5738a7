"""PyTorch port: the model zoo's entry points run on the card unless the
caller asks for the CPU.

Each entry (GPT-MoE's, LeNet's and the attention variants' parameter
draws, MLA's latent caches) is called without a device and with a CPU
generator. With a card visible the result lies on it; without one the
call raises the port's "no CUDA device" error instead of building on
the CPU. Asked for ``device="cpu"``, the same draw lands on the CPU with
the values it would have on the card. The file imports no JAX.
"""

import pytest
import torch

from scaletorch_tpu_torch.inference import init_mla_cache
from scaletorch_tpu_torch.models import gpt_moe, lenet
from scaletorch_tpu_torch.models import attention as att

GPT = gpt_moe.GPTMoEConfig(block_size=16, vocab_size=11, n_layer=1,
                           n_head=2, n_embd=16, num_experts=2, top_k=1)
ATT = att.AttentionConfig(embed_dim=16, num_heads=2, kv_lora_rank=4)


def leaves(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if hasattr(out, "latent"):
        return [out.latent]
    if isinstance(out, dict):
        return [t for v in out.values() for t in leaves(v)]
    return list(out)


ENTRIES = {
    "gpt_moe.init_params": lambda g, **kw: gpt_moe.init_params(g, GPT, **kw),
    "GPTMoE.init": lambda g, **kw: gpt_moe.GPTMoE(GPT).init(g, **kw),
    "lenet.init_params": lambda g, **kw: lenet.init_params(g, **kw),
    "LeNet.init": lambda g, **kw: lenet.LeNet().init(g, **kw),
    **{f"{cls.__name__}.init": (lambda g, cls=cls, **kw: cls(ATT).init(g, **kw))
       for cls in (att.MultiHeadAttention, att.MultiQueryAttention,
                   att.GroupQueryAttention, att.MultiHeadLatentAttention)},
    "MultiHeadLatentAttention.init_cache": lambda g, **kw:
        att.MultiHeadLatentAttention(ATT).init_cache(2, 8, **kw),
    "init_mla_cache": lambda g, **kw: init_mla_cache(ATT, 2, 8, **kw),
}


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_the_default_is_the_card(name):
    entry = ENTRIES[name]
    if torch.cuda.is_available():
        assert all(t.is_cuda for t in leaves(entry(
            torch.Generator().manual_seed(0))))
        assert all(t.is_cuda for t in leaves(entry(None)))
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry(torch.Generator().manual_seed(0))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry(None)


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_asked_for_the_cpu_the_draw_lands_there(name):
    entry = ENTRIES[name]
    got = leaves(entry(torch.Generator().manual_seed(0), device="cpu"))
    again = leaves(entry(None, device="cpu"))
    assert got and all(t.device.type == "cpu" for t in got)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
