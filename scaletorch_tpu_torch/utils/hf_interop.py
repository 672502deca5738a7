"""Hugging Face safetensors interop (counterpart of
scaletorch_tpu/utils/hf_interop.py): load a HF Llama / Qwen3 /
Qwen3-MoE checkpoint into the port's parameter tree and export the tree
back in HF layout.

The tree stacks layers on axis 0 and stores projections ``[in, out]``;
HF stores one tensor per layer (and per expert) as ``[out, in]``, so
every projection transposes on the way in and out. The MoE keys
(``router``, ``expert_*``) stack over the sparse layers and the dense
SwiGLU keys over the dense ones, as ``models/convert.py`` stacks them.
With ``tie_word_embeddings`` the file has no ``lm_head``.

The safetensors reader and writer are the port's own (the card's machine
has no ``safetensors`` package): an 8-byte little-endian header length,
the JSON header (``dtype``, ``shape``, ``data_offsets`` relative to the
end of the header, ``__metadata__``) padded with spaces to 8 bytes, then
the data. ``load_hf_params`` reads one tensor at a time and copies it
into its device leaf, so host memory peaks at one tensor;
``save_hf_params`` writes one tensor at a time, in shards of at most
``max_shard_bytes`` with the standard ``model.safetensors.index.json``;
``hf_config_dict`` gives the ``config.json`` beside them.
"""

from __future__ import annotations

import json
import math
import os
import re
import struct
import warnings
from typing import Any, BinaryIO, Dict, List, Optional, Tuple

import torch

from scaletorch_tpu_torch.utils.device import DeviceLike, resolve_device

Params = Dict[str, Any]

# ours -> (HF template, transpose). {i} = layer index, {e} = expert index.
_LAYER_MAP = {
    "input_layernorm": ("model.layers.{i}.input_layernorm.weight", False),
    "q_proj": ("model.layers.{i}.self_attn.q_proj.weight", True),
    "k_proj": ("model.layers.{i}.self_attn.k_proj.weight", True),
    "v_proj": ("model.layers.{i}.self_attn.v_proj.weight", True),
    "o_proj": ("model.layers.{i}.self_attn.o_proj.weight", True),
    "q_norm": ("model.layers.{i}.self_attn.q_norm.weight", False),
    "k_norm": ("model.layers.{i}.self_attn.k_norm.weight", False),
    "post_attention_layernorm": (
        "model.layers.{i}.post_attention_layernorm.weight", False),
    "gate_proj": ("model.layers.{i}.mlp.gate_proj.weight", True),
    "up_proj": ("model.layers.{i}.mlp.up_proj.weight", True),
    "down_proj": ("model.layers.{i}.mlp.down_proj.weight", True),
    "router": ("model.layers.{i}.mlp.gate.weight", True),
    "expert_gate_proj": (
        "model.layers.{i}.mlp.experts.{e}.gate_proj.weight", True),
    "expert_up_proj": (
        "model.layers.{i}.mlp.experts.{e}.up_proj.weight", True),
    "expert_down_proj": (
        "model.layers.{i}.mlp.experts.{e}.down_proj.weight", True),
}

_TOP_MAP = {
    "embed_tokens": ("model.embed_tokens.weight", False),
    "norm": ("model.norm.weight", False),
    "lm_head": ("lm_head.weight", True),
}

_MOE_KEYS = ("router", "expert_gate_proj", "expert_up_proj",
             "expert_down_proj")
_DENSE_MLP_KEYS = ("gate_proj", "up_proj", "down_proj")

# ---- safetensors ------------------------------------------------------------
_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


def read_safetensors_header(f: BinaryIO) -> Tuple[Dict[str, Any], int]:
    """(header dict, byte offset of the data) of an open file."""
    f.seek(0)
    (n,) = struct.unpack("<Q", f.read(8))
    header = json.loads(f.read(n))
    return header, 8 + n


class SafetensorsFile:
    """One ``.safetensors`` file, read a tensor at a time."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._f = open(path, "rb")
        header, self._data_start = read_safetensors_header(self._f)
        self.metadata = header.pop("__metadata__", None)
        self.entries = header

    def keys(self) -> List[str]:
        return list(self.entries)

    def get_tensor(self, name: str) -> torch.Tensor:
        """The tensor as stored (dtype and shape from the header), in a
        buffer of its own on the host."""
        entry = self.entries[name]
        begin, end = entry["data_offsets"]
        self._f.seek(self._data_start + begin)
        raw = bytearray(self._f.read(end - begin))
        if len(raw) != end - begin:
            raise OSError(f"{self.path}: {name} is truncated")
        dtype = _DTYPES[entry["dtype"]]
        if not raw:
            return torch.empty(entry["shape"], dtype=dtype)
        return torch.frombuffer(raw, dtype=dtype).reshape(entry["shape"])

    def close(self) -> None:
        self._f.close()


def write_safetensors(path: str, entries: List[Tuple[str, Tuple[int, ...],
                                                     torch.dtype, Any]],
                      metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``entries`` = [(name, shape, dtype, produce)] where
    ``produce()`` returns the tensor; each is produced and written in turn,
    so only one tensor is held at a time."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    offset = 0
    for name, shape, dtype, _ in entries:
        nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        header[name] = {"dtype": _DTYPE_NAMES[dtype], "shape": list(shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name, shape, dtype, produce in entries:
            t = produce().contiguous()
            if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
                raise ValueError(f"{name}: produced {tuple(t.shape)} "
                                 f"{t.dtype}, planned {tuple(shape)} {dtype}")
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)


# ---- the checkpoint's files -------------------------------------------------
def _open_shards(path: str) -> Tuple[Dict[str, SafetensorsFile],
                                     List[SafetensorsFile]]:
    """(tensor name -> its file, the open files) of a local checkpoint: a
    directory with ``model.safetensors.index.json`` or ``*.safetensors``
    files, or one file."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"checkpoint path {path!r} does not exist; expected a local "
            ".safetensors file or a directory holding them (nothing is "
            "fetched from a hub)")
    if os.path.isdir(path):
        index = os.path.join(path, "model.safetensors.index.json")
        if os.path.exists(index):
            with open(index) as f:
                files = sorted(set(json.load(f)["weight_map"].values()))
        else:
            files = sorted(f for f in os.listdir(path)
                           if f.endswith(".safetensors"))
        files = [os.path.join(path, f) for f in files]
    else:
        files = [path]
    handles = [SafetensorsFile(f) for f in files]
    tensors = {name: h for h in handles for name in h.keys()}
    return tensors, handles


def _is_moe(cfg) -> bool:
    return hasattr(cfg, "num_experts")


def _layer_ids_for(cfg, key: str) -> List[int]:
    """HF layer index of each row of our stacked leaf ``key``: the MoE
    keys stack over the sparse layers, the dense MLP keys of a MoE model
    over the dense ones, every other key over all layers."""
    full = list(range(cfg.num_hidden_layers))
    if not _is_moe(cfg):
        return full
    sparse = list(cfg.sparse_layer_ids())
    if key in _MOE_KEYS:
        return sparse
    if key in _DENSE_MLP_KEYS:
        return [i for i in full if i not in sparse]
    return full


def _param_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """Flat name -> shape of the parameter tree of ``cfg``."""
    if _is_moe(cfg):
        from scaletorch_tpu_torch.models import qwen3_moe

        return {n: s for n, (s, _) in qwen3_moe.param_shapes(cfg).items()}
    from scaletorch_tpu_torch.models import llama

    return {n: s for n, (s, _) in llama._param_shapes(cfg).items()}


def load_hf_params(path: str, cfg, *, device: DeviceLike = None,
                   param_dtype: Optional[torch.dtype] = None) -> Params:
    """Read a HF Llama / Qwen3 / Qwen3-MoE safetensors checkpoint into the
    port's parameter tree: leaves of ``param_dtype`` (default
    ``cfg.param_dtype``) on ``device`` (None = the CUDA card). Each HF
    tensor is read alone, moved to the device, transposed there where it
    must be and copied into its row of the stacked leaf. A missing tensor
    raises ``KeyError``; an untied config whose file lacks ``lm_head``
    warns and takes the transposed embedding."""
    dev = resolve_device(device)
    pd = param_dtype or cfg.param_dtype
    tensors, handles = _open_shards(path)

    def read(name: str, transpose: bool, want: Tuple[int, ...]
             ) -> torch.Tensor:
        if name not in tensors:
            raise KeyError(f"{name} not found in checkpoint at {path} "
                           f"({len(tensors)} tensors present)")
        t = tensors[name].get_tensor(name).to(dev)
        t = t.T if transpose else t
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{name}: shape {tuple(t.shape)} (ours) != "
                             f"the config's {tuple(want)}")
        return t

    params: Params = {"layers": {}}
    try:
        with torch.no_grad():
            for flat, shape in _param_shapes(cfg).items():
                leaf = torch.empty(shape, dtype=pd, device=dev)
                if not flat.startswith("layers."):
                    template, transpose = _TOP_MAP[flat]
                    if flat == "lm_head" and template not in tensors:
                        warnings.warn(
                            f"config has tie_word_embeddings=False but "
                            f"{template!r} is missing from the checkpoint "
                            f"at {path}; falling back to the transposed "
                            "embedding table (tied head). If the "
                            "checkpoint really has an untied head, check "
                            "its tensor names.", stacklevel=2)
                        template, transpose = _TOP_MAP["embed_tokens"][0], True
                    leaf.copy_(read(template, transpose, shape))
                    params[flat] = leaf
                    continue
                key = flat[len("layers."):]
                template, transpose = _LAYER_MAP[key]
                for r, i in enumerate(_layer_ids_for(cfg, key)):
                    if "{e}" in template:
                        for e in range(shape[1]):
                            leaf[r, e].copy_(read(template.format(i=i, e=e),
                                                  transpose, shape[2:]))
                    else:
                        leaf[r].copy_(read(template.format(i=i), transpose,
                                           shape[1:]))
                params["layers"][key] = leaf
    finally:
        for h in handles:
            h.close()
    return params


def save_hf_params(path: str, params: Params, cfg, *,
                   dtype: str = "float32",
                   max_shard_bytes: int = 5 * 1024 ** 3) -> str:
    """Write the parameter tree (fp32 or bf16 masters) as a HF-layout
    safetensors checkpoint in fp32 or bf16 (round to nearest even; a bf16
    leaf is written bit for bit). Above ``max_shard_bytes`` in
    all, the sharded layout: ``model-0000x-of-0000N.safetensors`` filled
    greedily in HF order, plus ``model.safetensors.index.json``. Returns
    the file's path, or the index's when sharded."""
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"dtype must be float32|bfloat16, got {dtype!r}")
    out_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    n_stacked = params["layers"]["input_layernorm"].shape[0]
    if n_stacked != cfg.num_hidden_layers:
        raise ValueError(f"params carry {n_stacked} stacked layers but the "
                         f"config has {cfg.num_hidden_layers}")
    os.makedirs(path, exist_ok=True)

    # (name, transpose, leaf, index into the leaf) in the reference's
    # order: the top leaves, then the layer keys as its init inserts them
    # (the order of _param_shapes), whatever the order of the tree's keys
    layer_keys = [n[len("layers."):] for n in _param_shapes(cfg)
                  if n.startswith("layers.")]
    if sorted(layer_keys) != sorted(params["layers"]):
        raise ValueError(f"params['layers'] has {sorted(params['layers'])}; "
                         f"the config needs {sorted(layer_keys)}")
    plan: List[Tuple[str, bool, torch.Tensor, tuple]] = []
    for key in ("embed_tokens", "norm", "lm_head"):
        if key in params:
            template, transpose = _TOP_MAP[key]
            plan.append((template, transpose, params[key], ()))
    for key in layer_keys:
        stacked = params["layers"][key]
        template, transpose = _LAYER_MAP[key]
        ids = _layer_ids_for(cfg, key)
        if len(ids) != stacked.shape[0]:
            raise ValueError(
                f"layers[{key!r}] stacks {stacked.shape[0]} rows but the "
                f"config maps it to {len(ids)} layers")
        for r, i in enumerate(ids):
            if "{e}" in template:
                for e in range(stacked.shape[1]):
                    plan.append((template.format(i=i, e=e), transpose,
                                 stacked, (r, e)))
            else:
                plan.append((template.format(i=i), transpose, stacked, (r,)))

    def entry(name, transpose, leaf, idx):
        shape = tuple(leaf.shape[len(idx):])
        shape = shape[::-1] if transpose else shape

        def produce():
            # one cast, from the leaf's own dtype: bf16 masters export to
            # bf16 unchanged, fp32 ones round to nearest even
            v = leaf.detach()[idx] if idx else leaf.detach()
            v = v.to("cpu")
            return (v.T if transpose else v).to(out_dtype)

        return name, shape, out_dtype, produce

    entries = [entry(*p) for p in plan]
    esize = torch.empty((), dtype=out_dtype).element_size()
    nbytes = {e[0]: math.prod(e[1]) * esize for e in entries}
    total = sum(nbytes.values())
    meta = {"format": "pt"}
    if total <= max_shard_bytes:
        out = os.path.join(path, "model.safetensors")
        write_safetensors(out, entries, meta)
        return out
    shards: List[list] = [[]]
    size = 0
    for e in entries:
        if shards[-1] and size + nbytes[e[0]] > max_shard_bytes:
            shards.append([])
            size = 0
        shards[-1].append(e)
        size += nbytes[e[0]]
    weight_map: Dict[str, str] = {}
    for k, shard in enumerate(shards, start=1):
        fname = f"model-{k:05d}-of-{len(shards):05d}.safetensors"
        write_safetensors(os.path.join(path, fname), shard, meta)
        weight_map.update({e[0]: fname for e in shard})
    index = os.path.join(path, "model.safetensors.index.json")
    with open(index, "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=0)
    return index


_HF_LAYER_RE = re.compile(r"model\.layers\.(\d+)\.")


def _hf_leaf_order(params: Params, cfg) -> List[str]:
    """The flat leaf names in the order ``save_hf_params`` reads them."""
    top = [k for k in ("embed_tokens", "norm", "lm_head") if k in params]
    layers = [n for n in _param_shapes(cfg) if n.startswith("layers.")]
    return top + layers


class _GatheredLeaf:
    """A leaf ``save_hf_params`` reads on rank 0: its global shape, and
    its value gathered from the owners of its shards when first read."""

    def __init__(self, name: str, shape: Tuple[int, ...], dtype, gather):
        self.name, self.shape, self.dtype = name, torch.Size(shape), dtype
        self._gather = gather

    def detach(self) -> torch.Tensor:
        return self._gather(self.name)


def save_hf_params_sharded(path: str, params: Params, cfg, mm, *,
                           group: Any, unlayout=None,
                           dtype: str = "float32",
                           max_shard_bytes: int = 5 * 1024 ** 3) -> str:
    """``save_hf_params`` of parameters split over ``mm``'s tp, pp and ep
    axes, called by every rank: rank 0 writes the files, byte-equal to a
    one-card export of the same parameters. Leaf by leaf, in the order
    ``save_hf_params`` reads them, the ranks at dp = cp = 0 send their
    shard to rank 0 over ``group`` (gloo), which concatenates the shards
    along their split dims and puts a stacked leaf back in model order
    (``unlayout``: the pp padding dropped, the interleave undone), so
    rank 0 holds one gathered leaf at a time beyond its own shards.
    Returns rank 0's path ('' elsewhere)."""
    import torch.distributed as dist

    from scaletorch_tpu_torch.models.convert import flatten_params
    from scaletorch_tpu_torch.parallel.mesh import MeshCoords
    from scaletorch_tpu_torch.parallel.tensor_parallel import shard_dims

    dims = shard_dims(cfg)
    flat = flatten_params(params)
    order = _hf_leaf_order(params, cfg)
    split = {n: [a for a in ("pp", "ep", "tp")
                 if a in dims[n] and mm.axis_size(a) > 1] for n in order}
    owners = [r for r in range(mm.world_size)
              if mm.coords(r).dp == 0 and mm.coords(r).cp == 0]
    rank = dist.get_rank()
    me = mm.coords(rank)

    def as_bytes(t: torch.Tensor) -> torch.Tensor:
        return t.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8)

    def send(i: int, name: str) -> None:
        if rank in owners and rank != 0:
            dist.send(as_bytes(flat[name]), dst=0, group=group, tag=i)

    def global_shape(name: str) -> Tuple[int, ...]:
        shape = list(flat[name].shape)
        for a in split[name]:
            shape[dims[name][a]] *= mm.axis_size(a)
        if unlayout is not None and name.startswith("layers."):
            shape[0] = cfg.num_hidden_layers
        return tuple(shape)

    def write() -> str:
        """Rank 0: gather each leaf from its owners and write the
        shards."""
        state = {"next": 0}

        def gather(name: str) -> torch.Tensor:
            # a stacked leaf is read once per layer: the last one is kept
            if state.get("name") == name:
                return state["leaf"]
            state.pop("leaf", None)
            i = order.index(name)
            if i != state["next"]:
                raise RuntimeError(f"export read {name!r} out of order (leaf "
                                   f"{i}, expected {state['next']})")
            state["next"] += 1
            local = flat[name].detach().to("cpu")
            pieces = {0: local}
            for r in owners[1:]:
                buf = torch.empty(local.numel() * local.element_size(),
                                  dtype=torch.uint8)
                dist.recv(buf, src=r, group=group, tag=i)
                pieces[r] = buf.view(local.dtype).view(local.shape)

            def build(coords: Dict[str, int], axes: List[str]) -> torch.Tensor:
                if not axes:
                    r = mm.rank_of(MeshCoords(dp=0, cp=0, **{
                        a: coords.get(a, 0) for a in ("pp", "ep", "tp")}))
                    return pieces[r]
                axis, rest = axes[0], axes[1:]
                return torch.cat([build({**coords, axis: j}, rest)
                                  for j in range(mm.axis_size(axis))],
                                 dim=dims[name][axis])

            leaf = build({}, split[name])
            if unlayout is not None and name.startswith("layers."):
                leaf = unlayout(leaf)
            state.update(name=name, leaf=leaf)
            return leaf

        assert me.dp == 0 and me.cp == 0
        lazy: Params = {}
        for name in order:
            node = lazy
            parts = name.split(".")
            for key in parts[:-1]:
                node = node.setdefault(key, {})
            node[parts[-1]] = _GatheredLeaf(name, global_shape(name),
                                            flat[name].dtype, gather)
        out = save_hf_params(path, lazy, cfg, dtype=dtype,
                             max_shard_bytes=max_shard_bytes)
        if state["next"] != len(order):
            raise RuntimeError(f"export read {state['next']} of "
                               f"{len(order)} leaves")
        return out

    # every rank reaches the one barrier after the branch (the owners
    # once their sends are posted, rank 0 once the shards are written)
    if rank != 0:
        for i, name in enumerate(order):
            send(i, name)
        out = ""
    else:
        out = write()
    dist.barrier(group=group)
    return out


def hf_checkpoint_layer_names(path: str) -> Dict[int, list]:
    """The checkpoint's tensor names grouped by layer index."""
    tensors, handles = _open_shards(path)
    by_layer: Dict[int, list] = {}
    for name in tensors:
        m = _HF_LAYER_RE.match(name)
        if m:
            by_layer.setdefault(int(m.group(1)), []).append(name)
    for h in handles:
        h.close()
    return by_layer


def hf_config_dict(cfg, dtype: str = "bfloat16") -> Dict[str, Any]:
    """The HF ``config.json`` of a port config: the architecture fields
    that ``from_hf`` reads back, under HF's model type (``qwen3_moe``
    for a MoE config, ``qwen3`` with per-head q/k norms, else
    ``llama``)."""
    model_type = ("qwen3_moe" if _is_moe(cfg)
                  else "qwen3" if cfg.qk_norm else "llama")
    out = {
        "architectures": [{"llama": "LlamaForCausalLM",
                           "qwen3": "Qwen3ForCausalLM",
                           "qwen3_moe": "Qwen3MoeForCausalLM"}[model_type]],
        "model_type": model_type,
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_hidden_layers,
        "num_attention_heads": cfg.num_attention_heads,
        "num_key_value_heads": cfg.num_key_value_heads,
        "head_dim": cfg.actual_head_dim,
        "max_position_embeddings": cfg.max_position_embeddings,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_norm_eps,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "hidden_act": "silu",
        "torch_dtype": dtype,
    }
    if _is_moe(cfg):
        out.update(num_experts=cfg.num_experts,
                   num_experts_per_tok=cfg.num_experts_per_tok,
                   moe_intermediate_size=cfg.moe_intermediate_size,
                   norm_topk_prob=cfg.norm_topk_prob,
                   mlp_only_layers=list(cfg.mlp_only_layers),
                   decoder_sparse_step=cfg.decoder_sparse_step)
    return out


def read_hf_config(path: str) -> Dict[str, Any]:
    """The parsed ``config.json`` of a checkpoint directory (or of the
    directory that holds a checkpoint file)."""
    folder = path if os.path.isdir(path) else os.path.dirname(path)
    with open(os.path.join(folder, "config.json")) as f:
        return json.load(f)
