"""Convert a training checkpoint between stacked layer layouts.

Counterpart of the reference's ``tools/convert_layer_storage.py`` over
the port's checkpoints (``utils/checkpoint.py``). A pipeline run keeps
the stacked ``[L, ...]`` layer axis in its own layout: padded to
``pp·slots`` rows for an uneven ``afab``/``memory_chunked`` split, or in
the rank-major virtual-stage order of ``interleaved``; a run without pp
(or with an even split) keeps the model's order (``plain``). Each step's
``extra.json`` records that layout, and a resume at another one is
refused (``CheckpointLayoutError``, which names this tool). The tool
rewrites one step offline:

    python -m scaletorch_tpu_torch.tools.convert_layer_storage \\
        --ckpt ckpts --out ckpts_vpp2 --to interleaved --pp 2 --vpp 2
    python -m scaletorch_tpu_torch.tools.convert_layer_storage \\
        --ckpt ckpts_vpp2 --out ckpts_plain --to plain

Every stacked-layer leaf (any leaf under a key named ``layers``) of the
parameters AND of the optimizer state is taken back to the model's
order (``pipeline_parallel.stage_layer_unlayout`` of the saved layout)
and then into the target's (``stage_layer_layout``): the moments of
Adam, LAMB and SGD and Adafactor's factored statistics keep the layer
axis first, so the same rows move. A leaf whose leading dim is 1 (a
placeholder, or a statistic reduced over the layer axis) passes
through, as the reference's does; any other leading dim is a
non-uniform stack and is refused, and so is a target equal to the saved
layout. The tool reads and writes on the CPU, in one process; the
output restores at any mesh, as every checkpoint of the port does.

Exit codes: 0 converted, 1 refused (the message says why).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from scaletorch_tpu_torch.parallel.pipeline_parallel import (
    stage_layer_layout,
    stage_layer_unlayout,
)
from scaletorch_tpu_torch.utils.checkpoint import (
    EXTRA_FILE,
    PLAIN_LAYOUT,
    CheckpointManager,
    _dcp_call,
    layout_key,
)

ENGINES = ("afab", "memory_chunked", "interleaved")
TARGETS = ("plain",) + ENGINES
Tree = Dict[str, Any]


class ConversionError(ValueError):
    """The checkpoint cannot be converted as asked."""


def layout_of(num_layers: int, pp: int, engine: str, vpp: int = 1
              ) -> Dict[str, Any]:
    """The ``layout`` a Trainer at (pp, engine, vpp) records for
    ``num_layers`` stacked layers (``Trainer._stacked_layout``)."""
    if engine == "plain" or stage_layer_layout(num_layers, pp, engine,
                                               vpp) is None:
        return dict(PLAIN_LAYOUT)
    return {"stacked": engine, "pp": pp, "vpp": vpp, "layers": num_layers}


def _fns(layout: Dict[str, Any]) -> Tuple[Optional[Callable],
                                          Optional[Callable]]:
    """(to model order, from model order) of one stacked leaf."""
    if layout.get("stacked", "plain") == "plain":
        return None, None
    args = (layout["layers"], layout["pp"], layout["stacked"],
            layout.get("vpp", 1))
    return stage_layer_unlayout(*args), stage_layer_layout(*args)


def _stack_rows(layout: Dict[str, Any], num_layers: int) -> int:
    """Rows of the stacked axis in ``layout``."""
    _, to = _fns(layout)
    if to is None:
        return num_layers
    return int(to(torch.zeros(num_layers)).shape[0])


def stacked_rows(params: Tree) -> int:
    """The leading dim every leaf under ``params['layers']`` shares
    (refused when they differ)."""
    leads = {int(t.shape[0]) for t in _leaves(params["layers"])}
    if len(leads) != 1:
        raise ConversionError(
            f"non-uniform stacked-layer leading dims {sorted(leads)}: the "
            "conversion needs a uniform stack")
    return leads.pop()


def _leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def convert_tree(tree: Tree, saved: Dict[str, Any],
                 target: Dict[str, Any], num_layers: int) -> Tree:
    """Every leaf under a ``layers`` key with the saved stack's rows,
    re-blocked from ``saved`` to ``target``; leaves of leading dim 1 and
    everything outside a ``layers`` subtree unchanged."""
    unlayout, _ = _fns(saved)
    _, layout = _fns(target)
    rows = _stack_rows(saved, num_layers)

    def move(x: torch.Tensor) -> torch.Tensor:
        if unlayout is not None:
            x = unlayout(x)
        if layout is not None:
            x = layout(x)
        return x

    def walk(node: Any, in_layers: bool) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, in_layers or k == "layers")
                    for k, v in node.items()}
        if in_layers and isinstance(node, torch.Tensor) and node.dim() >= 1:
            if node.shape[0] == rows:
                return move(node).contiguous()
            if node.shape[0] == 1:
                return node
            raise ConversionError(
                f"stacked-layer leaf with leading dim {node.shape[0]} != "
                f"{rows} rows of the saved stack: cannot re-block a "
                "non-uniform stack")
        return node

    return walk(tree, False)


def _nest(flat: Dict[str, torch.Tensor]) -> Tree:
    out: Tree = {}
    for name, t in flat.items():
        node = out
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t
    return out


def read_step(step_dir: str) -> Tuple[Tree, Dict[str, Any]]:
    """({"params", "opt_state"} as host tensors, the step's extra.json)
    of one saved step, whichever way it was written (one process, or
    global tensors over a process group)."""
    import torch.distributed.checkpoint as dcp

    meta_md = dcp.FileSystemReader(step_dir).read_metadata()
    staged = {}
    for name, md in meta_md.state_dict_metadata.items():
        size = getattr(md, "size", None)
        if size is None:
            raise ConversionError(f"{name}: not a tensor in {step_dir}")
        staged[name] = torch.empty(tuple(size), dtype=md.properties.dtype)
    state = _nest(staged)
    _dcp_call("load", state, step_dir)
    with open(os.path.join(step_dir, EXTRA_FILE)) as f:
        meta = json.load(f)
    return state, meta


def _steps(directory: str) -> List[int]:
    return sorted(int(n) for n in os.listdir(directory)
                  if n.isdigit() and os.path.isdir(os.path.join(directory, n)))


def convert(ckpt: str, out: str, to: str, pp: Optional[int] = None,
            vpp: Optional[int] = None, step: Optional[int] = None
            ) -> Dict[str, Any]:
    """Write ``ckpt``'s ``step`` (default: its newest) into ``out`` at the
    target layout; returns what was done."""
    steps = _steps(ckpt) if os.path.isdir(ckpt) else []
    if not steps:
        raise ConversionError(f"no checkpoints in {ckpt}")
    step = steps[-1] if step is None else step
    if step not in steps:
        raise ConversionError(f"no step {step} in {ckpt} (steps {steps})")
    state, meta = read_step(os.path.join(ckpt, str(step)))
    saved = dict(meta.get("layout", PLAIN_LAYOUT))
    rows = stacked_rows(state["params"])
    if saved.get("stacked", "plain") == "plain":
        num_layers = rows
    else:
        num_layers = int(saved["layers"])
        if rows != _stack_rows(saved, num_layers):
            raise ConversionError(
                f"the saved stack has {rows} rows, its layout {saved} "
                f"gives {_stack_rows(saved, num_layers)}")
    if to == "plain":
        target = dict(PLAIN_LAYOUT)
    else:
        if not pp or pp < 2:
            raise ConversionError(f"--to {to} needs --pp >= 2")
        if to == "interleaved" and not vpp:
            raise ConversionError("--to interleaved needs --vpp")
        target = layout_of(num_layers, pp, to, vpp or 1)
    if layout_key(saved) == layout_key(target):
        raise ConversionError(
            f"checkpoint step {step} is already in layout {saved}")
    params = convert_tree(state["params"], saved, target, num_layers)
    opt_state = convert_tree(state["opt_state"], saved, target, num_layers)
    manager = CheckpointManager(out, keep_n=0, layout=target)
    saved_ok = manager.save(step, params, opt_state, extra=meta.get("extra"))
    manager.close()
    if not saved_ok:
        raise ConversionError(
            f"step {step} was not written into {out}: it holds that step "
            "already, or every write attempt failed")
    return {"step": step, "from": saved, "to": target,
            "layers": num_layers, "out": os.path.abspath(out)}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m scaletorch_tpu_torch.tools.convert_layer_storage",
        description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", required=True, help="source checkpoint dir")
    ap.add_argument("--out", required=True, help="destination dir")
    ap.add_argument("--step", type=int, default=None,
                    help="step to convert (default: the newest)")
    ap.add_argument("--to", required=True, choices=TARGETS,
                    help="the target layout: the model's order, or the "
                         "layout of a run with this pp_engine")
    ap.add_argument("--pp", type=int, default=None,
                    help="pipeline_parallel_size of the target run")
    ap.add_argument("--vpp", type=int, default=None,
                    help="pp_virtual_stages of an interleaved target")
    args = ap.parse_args(argv)
    try:
        done = convert(args.ckpt, args.out, args.to, pp=args.pp,
                       vpp=args.vpp, step=args.step)
    except ConversionError as exc:
        print(f"convert_layer_storage: {exc}", file=sys.stderr)
        return 1
    print(f"step {done['step']}: {done['from']} -> {done['to']} "
          f"(L={done['layers']}) written to {done['out']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
