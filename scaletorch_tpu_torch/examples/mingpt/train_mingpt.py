#!/usr/bin/env python
"""minGPT char-LM training example (dense or MoE) on the GPU.

Counterpart of examples/mingpt/train_mingpt.py with its flags and
defaults: a small GPT (block 128, 4 layers, 4 heads, n_embd 128;
``--use_moe true``: 8 experts, top-2, noisy routing) trained on character
windows with AdamW (optax's: decay 1e-4 on every leaf), a global-norm
clip at 1.0 and a warmup-cosine schedule from 0 to 0, a periodic eval
NLL, and a sampled continuation at the end. ``main`` returns the last
eval NLL.

It runs on the CUDA card unless ``--device cpu`` is passed, on one
device: ``--data_parallel`` above 1 raises (the examples over the mesh
are ROADMAP item 9c).

Usage:
    python -m scaletorch_tpu_torch.examples.mingpt.train_mingpt --steps 300
    python -m scaletorch_tpu_torch.examples.mingpt.train_mingpt \
        --data_path shakespeare.txt --use_moe true --steps 2000
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import numpy as np
import torch

MESH_ITEM = ("data parallelism in the examples is not ported: the examples "
             "over the mesh are ROADMAP item 9c")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_path", default=None)
    ap.add_argument("--block_size", type=int, default=128)
    ap.add_argument("--n_layer", type=int, default=4)
    ap.add_argument("--n_head", type=int, default=4)
    ap.add_argument("--n_embd", type=int, default=128)
    ap.add_argument("--use_moe", type=lambda s: s.lower() in ("1", "true"),
                    default=False)
    ap.add_argument("--num_experts", type=int, default=8)
    ap.add_argument("--top_k", type=int, default=2)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--eval_interval", type=int, default=100)
    ap.add_argument("--eval_batches", type=int, default=8)
    ap.add_argument("--sample_tokens", type=int, default=64)
    ap.add_argument("--data_parallel", type=int, default=0,
                    help="dp degree; 0 or 1 = this one device")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def warmup_cosine(lr: float, warmup: int, steps: int):
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, max(steps,
    warmup + 1)): linear from 0, then a cosine to 0."""
    from scaletorch_tpu_torch.trainer.lr_scheduler import (
        cosine_decay_schedule,
        join_schedules,
        linear_schedule,
    )

    decay_steps = max(steps, warmup + 1)
    return join_schedules(
        [linear_schedule(0.0, lr, warmup),
         cosine_decay_schedule(lr, decay_steps - warmup)], [warmup])


def loss_fn(params, x, y, cfg, generator=None):
    """(NLL + the routing aux loss, NLL) of a batch; ``generator`` turns
    on noisy routing."""
    from scaletorch_tpu_torch.models import gpt_moe

    logits, aux = gpt_moe.forward(
        params, x, cfg, generator=generator if cfg.use_moe else None,
        return_aux=True)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, y.long()[..., None]).mean()
    return nll + aux, nll


def make_steps(cfg, optimizer):
    """(train_step, eval_step) over a parameter tree: the step clips the
    gradient of ``loss_fn`` by the global norm at 1.0 and applies
    ``optimizer`` in place."""
    from scaletorch_tpu_torch.trainer.optimizer import tree_leaves, tree_map
    from scaletorch_tpu_torch.trainer.train_step import (
        clip_scale,
        global_grad_norm,
    )

    def train_step(params, state, x, y, generator):
        loss, nll = loss_fn(params, x, y, cfg, generator)
        leaves = tree_leaves(params)
        # without noise the noise projection is unused: JAX's gradient of
        # it is zero, and AdamW still decays it
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
            leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
        scale = clip_scale(global_grad_norm(grads), 1.0)
        it = iter(g * scale for g in grads)
        optimizer.update(tree_map(lambda _: next(it), params), state, params)
        return nll.detach()

    @torch.no_grad()
    def eval_step(params, x, y):
        return loss_fn(params, x, y, cfg)[1]

    return train_step, eval_step


def run(argv=None) -> Dict[str, Any]:
    """Train and sample; returns the last eval NLL and every eval's, the
    last train NLL, the training tokens/s and ms a step (the evals left
    out), and the sample."""
    args = parse_args(argv)
    if args.data_parallel > 1:
        raise ValueError(f"--data_parallel {args.data_parallel}: {MESH_ITEM}")

    from scaletorch_tpu_torch.examples.mingpt.char_dataset import (
        load_dataset,
    )
    from scaletorch_tpu_torch.models import gpt_moe
    from scaletorch_tpu_torch.trainer.optimizer import AdamW, tree_leaves
    from scaletorch_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    ds, source = load_dataset(args.data_path, args.block_size)
    print(f"corpus={source} chars={len(ds.text)} vocab={ds.vocab_size}")
    cfg = gpt_moe.GPTMoEConfig(
        block_size=args.block_size, vocab_size=ds.vocab_size,
        n_layer=args.n_layer, n_head=args.n_head, n_embd=args.n_embd,
        use_moe=args.use_moe, num_experts=args.num_experts, top_k=args.top_k)
    # one CPU generator: the same initial weights on the CPU and the card
    params = gpt_moe.init_params(torch.Generator().manual_seed(0), cfg,
                                 device=dev)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    n_params = sum(leaf.numel() for leaf in tree_leaves(params))
    print(f"model: {n_params / 1e6:.2f}M params, moe={cfg.use_moe}, "
          f"device={dev}")

    optimizer = AdamW(warmup_cosine(args.lr, args.warmup, args.steps))
    state = optimizer.init(params)
    train_step, eval_step = make_steps(cfg, optimizer)

    rng = np.random.default_rng(0)
    train_it = ds.batches("train", args.batch_size, rng)
    test_it = ds.batches("test", args.batch_size, rng)
    noise = torch.Generator(device=dev).manual_seed(1)

    def put(a):
        return torch.from_numpy(a).to(dev, non_blocking=True)

    evals_seen, train_nll, train_s = [], float("nan"), 0.0
    t0 = time.perf_counter()
    for step in range(1, args.steps + 1):
        x, y = next(train_it)
        nll = train_step(params, state, put(x), put(y), noise)
        if step % args.eval_interval == 0 or step == args.steps:
            train_nll = float(nll)  # waits for the device
            train_s += time.perf_counter() - t0
            evals = [float(eval_step(params, put(ex), put(ey)))
                     for ex, ey in (next(test_it)
                                    for _ in range(args.eval_batches))]
            evals_seen.append(sum(evals) / len(evals))
            tok_s = step * args.batch_size * args.block_size / train_s
            print(f"step {step}/{args.steps} train_nll {train_nll:.4f} "
                  f"eval_nll {evals_seen[-1]:.4f} tok/s {tok_s:,.0f} dp=1")
            t0 = time.perf_counter()

    prompt = torch.from_numpy(ds.encode(ds.text[:16])[None, :]).to(dev)
    out = gpt_moe.generate(
        params, prompt, cfg, max_new_tokens=args.sample_tokens,
        temperature=0.8, generator=torch.Generator(device=dev).manual_seed(2))
    sample = ds.decode(out[0].cpu().numpy())
    print("sample:", repr(sample))
    tokens = args.steps * args.batch_size * args.block_size
    return {"eval_nll": evals_seen[-1] if evals_seen else float("inf"),
            "evals": evals_seen,
            "train_nll": train_nll,
            "tokens_per_s": tokens / train_s if train_s else 0.0,
            "step_ms": 1e3 * train_s / max(args.steps, 1), "sample": sample,
            "device": str(dev)}


def main(argv=None) -> float:
    return run(argv)["eval_nll"]


if __name__ == "__main__":
    main()
