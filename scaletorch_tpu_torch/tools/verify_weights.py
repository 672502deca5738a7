"""Verify that HF checkpoints load into the port and run.

Counterpart of the reference's ``tools/verify_weights.py``. For each
checkpoint directory (``config.json`` + safetensors): read it through
``utils/hf_interop.load_hf_params``, check the parameter count and the
weight tying, run a forward (finite logits) and a backward (a finite
loss, a gradient for every leaf), and, where ``transformers`` can be
imported, compare the logits with its model token for token on the CPU
(rtol = atol = 2e-3, fp32; a mismatch fails). Where it cannot be
imported (the card's machine has no ``transformers``) the comparison is
skipped with one printed line and the other checks still decide.

The forward and the backward run on the CUDA card through the
hand-written flash kernels (K1 forward, K2/K3 backward) unless
``--device cpu`` is given; without a card ``cuda`` is an error.

Usage (from the root of a checkout):
    python -m scaletorch_tpu_torch.tools.verify_weights /path/to/Qwen3-0.6B
    python -m scaletorch_tpu_torch.tools.verify_weights --synthetic \\
        --device cpu     # writes its own checkpoint, no download

Exit codes: 0 every checkpoint passed, 1 a failure (its traceback is
printed).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import traceback
from typing import List, Optional

import numpy as np
import torch

from scaletorch_tpu_torch.utils.device import DeviceLike, resolve_device

RTOL = ATOL = 2e-3
# the reference's self-test model (tools/verify_weights.py:99-134)
SYNTHETIC_HF_CONFIG = {
    "model_type": "qwen3", "vocab_size": 128, "hidden_size": 32,
    "intermediate_size": 64, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2,
    "head_dim": 16, "tie_word_embeddings": False,
    "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
    "max_position_embeddings": 128,
    "architectures": ["Qwen3ForCausalLM"],
}


def model_of(path: str):
    """(config, forward) of a checkpoint directory, at fp32."""
    from scaletorch_tpu_torch.models import llama, qwen3_moe
    from scaletorch_tpu_torch.models.qwen3 import Qwen3Config
    from scaletorch_tpu_torch.utils.hf_interop import read_hf_config

    hf = read_hf_config(path)
    kw = dict(dtype=torch.float32, param_dtype=torch.float32)
    mt = hf.get("model_type")
    if mt == "qwen3_moe":
        return qwen3_moe.Qwen3MoEConfig.from_hf(hf, **kw), qwen3_moe.forward
    if mt == "qwen3":
        return Qwen3Config.from_hf(hf, **kw), llama.forward
    return llama.LlamaConfig.from_hf(hf, **kw), llama.forward


def _logits(out):
    return out[0] if isinstance(out, tuple) else out


def verify_one(path: str, compare_hf: bool = True,
               device: DeviceLike = None) -> bool:
    """Every check on one checkpoint directory; raises on the first
    failure, True when all pass."""
    from scaletorch_tpu_torch.utils.hf_interop import load_hf_params

    dev = resolve_device(device)
    print(f"\n{'=' * 60}\nVerifying {path} on {dev}\n{'=' * 60}")
    cfg, fwd = model_of(path)
    params = load_hf_params(path, cfg, device=dev)
    leaves = _leaves(params)
    n = sum(t.numel() for t in leaves)
    print(f"  params: {n / 1e6:.1f}M (computed {cfg.num_params() / 1e6:.1f}M)")
    assert n == cfg.num_params(), "parameter count mismatch"
    if cfg.tie_word_embeddings:
        assert "lm_head" not in params
        print("  tie check: PASS (head reads the embedding)")

    ids_np = (np.arange(2 * 16, dtype=np.int64).reshape(2, 16)
              % cfg.vocab_size)
    ids = torch.from_numpy(ids_np).to(dev)
    with torch.no_grad():
        logits = _logits(fwd(params, ids, cfg, attention_backend="flash"))
    assert bool(torch.isfinite(logits).all()), "non-finite logits"
    print(f"  forward: PASS (shape={tuple(logits.shape)}, finite)")

    for t in leaves:
        t.requires_grad_(True)
    out = _logits(fwd(params, ids, cfg, attention_backend="flash"))
    lp = torch.log_softmax(out.float(), dim=-1)
    loss = -torch.gather(lp[:, :-1], -1, ids[:, 1:, None]).mean()
    loss.backward()
    loss = loss.detach()
    assert bool(torch.isfinite(loss)), f"non-finite loss {float(loss)}"
    missing = sum(t.grad is None for t in leaves)
    assert missing == 0, f"{missing} of {len(leaves)} leaves got no gradient"
    print(f"  backward: PASS (loss={float(loss):.3f}, {len(leaves)} grad "
          "leaves)")

    if compare_hf:
        try:
            from transformers import AutoModelForCausalLM
        except ImportError as exc:
            print(f"  logits vs transformers: SKIPPED ({exc!r})")
        else:
            model = AutoModelForCausalLM.from_pretrained(
                path, attn_implementation="eager",
                torch_dtype=torch.float32).eval()
            with torch.no_grad():
                theirs = model(torch.from_numpy(ids_np)).logits
            np.testing.assert_allclose(
                logits.float().cpu().numpy(), theirs.float().numpy(),
                rtol=RTOL, atol=ATOL)
            print("  logits vs transformers: PASS")
    print("  RESULT: OK")
    return True


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def write_synthetic(path: str, seed: int = 0) -> str:
    """A checkpoint of the reference self-test's model, written by the
    port's exporter (random weights from ``seed``) with its minimal
    ``config.json``."""
    from scaletorch_tpu_torch.models.llama import init_params
    from scaletorch_tpu_torch.models.qwen3 import Qwen3Config
    from scaletorch_tpu_torch.utils.hf_interop import save_hf_params

    cfg = Qwen3Config.from_hf(SYNTHETIC_HF_CONFIG, dtype=torch.float32,
                              param_dtype=torch.float32)
    gen = torch.Generator().manual_seed(seed)
    params = init_params(cfg, gen, "cpu")
    save_hf_params(path, params, cfg)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(SYNTHETIC_HF_CONFIG, f)
    return path


def synthetic_self_test(device: DeviceLike = None,
                        compare_hf: bool = True) -> bool:
    """The port's exporter -> the verifier, in a temporary directory."""
    with tempfile.TemporaryDirectory() as d:
        return verify_one(write_synthetic(d), compare_hf=compare_hf,
                          device=device)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m scaletorch_tpu_torch.tools.verify_weights",
        description=__doc__.split("\n")[0])
    ap.add_argument("paths", nargs="*", help="HF checkpoint dirs")
    ap.add_argument("--synthetic", action="store_true",
                    help="verify a checkpoint the port's exporter writes")
    ap.add_argument("--no_hf_compare", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the forward and backward run; 'cuda' "
                         "fails without a card")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # no card for 'cuda': fail here, at once
    ok = True
    if args.synthetic or not args.paths:
        try:
            synthetic_self_test(args.device,
                                compare_hf=not args.no_hf_compare)
        except Exception:
            traceback.print_exc()
            ok = False
    for path in args.paths:
        try:
            verify_one(path, compare_hf=not args.no_hf_compare,
                       device=args.device)
        except Exception:
            traceback.print_exc()
            ok = False
    print(f"\n{'=' * 60}\nAll verification complete: "
          f"{'OK' if ok else 'FAILURES'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
