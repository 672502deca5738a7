"""The rank side of the port's gloo tests: ``python -m
tests.torch_dist_cases CASE RANK WORLD DIR`` joins a gloo group at a
FileStore under DIR, runs ``CASES[CASE](payload)`` on the pickled
payload and pickles the result to ``DIR/out_RANK.pkl``. Started by
``tests/torch_dist_harness.run_ranks``. It imports no JAX, and checks
that none was imported before and after the case.
"""

from __future__ import annotations

import os
import pickle
import sys

assert "jax" not in sys.modules, "a rank process imported JAX"

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from scaletorch_tpu_torch import dist as stdist  # noqa: E402
from scaletorch_tpu_torch.models import llama  # noqa: E402
from scaletorch_tpu_torch.models.convert import (  # noqa: E402
    flatten_params,
    params_from_numpy,
    params_to_numpy,
    shard_numpy_params,
)
from scaletorch_tpu_torch.parallel import mesh as tmesh  # noqa: E402

INIT_TIMEOUT_S = 120.0


def _mesh(payload) -> tmesh.MeshManager:
    return tmesh.setup_mesh_manager(**payload["mesh"], device_type="cpu")


def _t(a, grad=False) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_(True) if grad else t


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy().copy()


# ---- dist -----------------------------------------------------------------------
def case_dist(payload):
    rank = stdist.process_index()
    stdist.barrier()
    gathered = stdist.all_gather_object({"rank": rank, "sq": rank * rank})
    rooted = stdist.gather_object(f"r{rank}", dst=1)
    objs = [f"mine-{rank}", rank] if rank == 0 else [None, None]
    stdist.broadcast_object_list(objs, src=0)
    refused = None
    try:
        stdist.broadcast_object_list([1, 2, 3] if rank else [1, 2], src=0)
    except ValueError as exc:
        refused = str(exc)
    return {"index": rank, "count": stdist.process_count(),
            "main": stdist.is_main_process(),
            "distributed": stdist.is_distributed(), "gathered": gathered,
            "rooted": rooted, "broadcast": objs, "refused": refused,
            "backend": dist.get_backend()}


# ---- mesh -----------------------------------------------------------------------
def case_mesh(payload):
    out = []
    for shape in payload["shapes"]:
        mm = tmesh.MeshManager(**shape, device_type="cpu")
        groups = {axis: dist.get_process_group_ranks(mm.group(axis))
                  for axis in tmesh.MESH_AXES}
        groups["data"] = dist.get_process_group_ranks(
            mm.group(tmesh.DATA_AXES))
        out.append({"coords": mm.my_coords.as_tuple(), "groups": groups,
                    "ring": mm.cp_ring_peers(),
                    "mesh_shape": tuple(mm.mesh.shape)})
    return out


# ---- tensor parallel ----------------------------------------------------------------
def case_tp_ops(payload):
    from scaletorch_tpu_torch.parallel import tensor_parallel as ttp

    mm = _mesh(payload)
    r, tp = mm.axis_rank("tp"), mm.tp
    out = {}
    # region functions: y = f(x), loss = sum(y * w)
    x = _t(payload["x"], grad=True)
    y = ttp.copy_to_tensor_parallel_region(x) * (r + 1)
    (g_copy,) = torch.autograd.grad(y.sum(), x)
    x2 = _t(payload["x"] * (r + 1), grad=True)
    red = ttp.reduce_from_tensor_parallel_region(x2)
    (g_red,) = torch.autograd.grad((red * red).sum(), x2)
    x3 = _t(payload["x"] + r, grad=True)
    gat = ttp.gather_from_tensor_parallel_region(x3)
    w = torch.arange(gat.numel(), dtype=gat.dtype).view_as(gat)
    (g_gat,) = torch.autograd.grad((gat * w).sum(), x3)
    out.update(copy_grad=_np(g_copy), reduce=_np(red), reduce_grad=_np(g_red),
               gather=_np(gat), gather_grad=_np(g_gat))
    # vocab-parallel embedding and cross entropy on this rank's shard
    v = payload["table"].shape[0]
    table = _t(payload["table"][r * v // tp:(r + 1) * v // tp], grad=True)
    emb = ttp.vocab_parallel_embedding(_t(payload["ids"]), table)
    (g_table,) = torch.autograd.grad((emb * _t(payload["emb_w"])).sum(),
                                     table)
    out.update(emb=_np(emb), table_grad=_np(g_table))
    logits = payload["logits"]
    vl = logits.shape[-1] // tp
    for name, targets in payload["targets"].items():
        lg = _t(logits[..., r * vl:(r + 1) * vl], grad=True)
        loss = ttp.vocab_parallel_cross_entropy(lg, _t(targets), axis="tp")
        (g,) = torch.autograd.grad(loss, lg)
        out[f"ce_{name}"] = float(loss)
        out[f"ce_grad_{name}"] = _np(g)
    hidden = _t(payload["hidden"], grad=True)
    head = _t(payload["head"][:, r * vl:(r + 1) * vl], grad=True)
    h_in = ttp.copy_to_tensor_parallel_region(hidden)
    loss = ttp.fused_vocab_parallel_cross_entropy(
        h_in, head, _t(payload["targets"]["ign"]), axis="tp", chunk_size=5)
    gh, gw = torch.autograd.grad(loss, (hidden, head))
    out.update(fused=float(loss), fused_hidden_grad=_np(gh),
               fused_head_grad=_np(gw))
    # column / row linear, gathered
    xa = _t(payload["xa"], grad=True)
    wa = _t(payload["wa"][:, r * payload["wa"].shape[1] // tp:
                          (r + 1) * payload["wa"].shape[1] // tp], grad=True)
    col = ttp.column_parallel_linear(xa, wa, gather_output=True)
    wb = payload["wb"]
    wb_l = _t(wb[r * wb.shape[0] // tp:(r + 1) * wb.shape[0] // tp],
              grad=True)
    k = col.shape[-1] // tp
    row = ttp.row_parallel_linear(col[..., r * k:(r + 1) * k], wb_l)
    gx, gwa, gwb = torch.autograd.grad((row * row).sum(), (xa, wa, wb_l))
    out.update(linear=_np(row), linear_x_grad=_np(gx), linear_wa_grad=_np(gwa),
               linear_wb_grad=_np(gwb))
    return out


def _model_cfg(payload):
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    return llama.LlamaConfig(**payload["arch"],
                             dtype=dt[payload.get("dtype", "float32")])


def case_tp_model(payload):
    """Loss and local gradients of the decoder + fused CE over the mesh
    (tp, sp, cp backends), for every run in ``payload['runs']``."""
    from scaletorch_tpu_torch.parallel.spmd import (
        local_batch,
        make_spmd_grad_fn,
    )
    from scaletorch_tpu_torch.trainer.optimizer import tree_leaves

    os.environ["SCALETORCH_TPU_CE_CHUNK"] = str(payload["ce_chunk"])
    cfg = _model_cfg(payload)
    results = []
    for run in payload["runs"]:
        mm = tmesh.setup_mesh_manager(**run["mesh"], device_type="cpu")
        params = params_from_numpy(
            shard_numpy_params(payload["params"], cfg, mm, mm.rank), "cpu")
        grads_fn = make_spmd_grad_fn(
            mm, cfg, attention_backend=run["backend"],
            gradient_checkpointing=run.get("gc", False),
            remat_policy=run.get("remat_policy", "nothing_saveable"),
            sequence_parallel=run.get("sp", False),
            cp_layout=run.get("layout", "contiguous"))
        batch = local_batch(payload["batch"], mm,
                            zigzag=run.get("layout") == "zigzag"
                            and run["backend"] == "ring")
        loss, grads = grads_fn(params, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
        names = list(flatten_params(params))
        assert len(names) == len(tree_leaves(params))
        results.append({"loss": float(loss),
                        "grads": {n: _np(g) for n, g in zip(names, grads)}})
    return results


# ---- context parallel -----------------------------------------------------------
def _cp_local(a, mm, layout):
    """This rank's sequence shard of a full [B, H, S, D] array."""
    from scaletorch_tpu_torch.parallel.zigzag import zigzag_order

    if layout == "zigzag":
        a = np.take(a, zigzag_order(a.shape[2], mm.cp), axis=2)
    w = a.shape[2] // mm.cp
    c = mm.axis_rank("cp")
    return np.ascontiguousarray(a[:, :, c * w:(c + 1) * w])


def case_cp_attention(payload):
    from scaletorch_tpu_torch.ops.ring_attention import ring_attention
    from scaletorch_tpu_torch.ops.ulysses import ulysses_attention

    out = []
    for run in payload["runs"]:
        mm = tmesh.setup_mesh_manager(**run["mesh"], device_type="cpu")
        layout = run.get("layout", "contiguous")
        q, k, v, do = (_t(_cp_local(payload[n], mm, layout), grad=n != "do")
                       for n in ("q", "k", "v", "do"))
        if run["backend"] == "ring":
            o = ring_attention(q, k, v, "cp", True, None, layout)
        else:
            o = ulysses_attention(q, k, v, causal=True)
        dq, dk, dv = torch.autograd.grad((o * do).sum(), (q, k, v))
        out.append({n: _np(t) for n, t in
                    (("o", o), ("dq", dq), ("dk", dk), ("dv", dv))})
    return out


# ---- the train step -------------------------------------------------------------
def case_spmd_steps(payload):
    from scaletorch_tpu_torch.config import ScaleTorchTPUArguments
    from scaletorch_tpu_torch.data.dataloader import device_batch
    from scaletorch_tpu_torch.parallel.spmd import (
        local_batch,
        make_spmd_eval_step,
        make_spmd_train_step,
    )
    from scaletorch_tpu_torch.trainer.optimizer import create_optimizer

    os.environ["SCALETORCH_TPU_CE_CHUNK"] = str(payload["ce_chunk"])
    cfg = _model_cfg(payload)
    out = []
    for run in payload["runs"]:
        mm = tmesh.setup_mesh_manager(**run["mesh"], device_type="cpu")
        tcfg = ScaleTorchTPUArguments(**payload["train_cfg"])
        opt, _ = create_optimizer(tcfg)
        params = params_from_numpy(
            shard_numpy_params(payload["params"], cfg, mm, mm.rank), "cpu")
        state = opt.init(params)
        step = make_spmd_train_step(
            mm, cfg, opt, attention_backend=run["backend"],
            gradient_checkpointing=run.get("gc", False),
            sequence_parallel=run.get("sp", False),
            max_grad_norm=tcfg.max_grad_norm,
            cp_layout=run.get("layout", "contiguous"),
            grad_allreduce_dtype=run.get("wire", "fp32"))
        zigzag = run.get("layout") == "zigzag" and run["backend"] == "ring"
        metrics = []
        for b in run["batches"]:
            lb = device_batch(local_batch(b, mm, zigzag=zigzag), "cpu")
            params, state, m = step(params, state, lb)
            metrics.append({k: float(v) for k, v in m.items()})
        evaluate = make_spmd_eval_step(mm, cfg,
                                       attention_backend=run["backend"],
                                       sequence_parallel=run.get("sp", False),
                                       cp_layout=run.get("layout",
                                                         "contiguous"))
        val = float(evaluate(params, device_batch(
            local_batch(run["batches"][0], mm, zigzag=zigzag), "cpu")))
        out.append({"metrics": metrics, "val": val,
                    "params": params_to_numpy(params)})
    return out


# ---- the Trainer's guards over the mesh -------------------------------------------
def case_trainer_guards(payload):
    from scaletorch_tpu_torch.config import ScaleTorchTPUArguments
    from scaletorch_tpu_torch.trainer.trainer import Trainer

    def cfg(**kw):
        return ScaleTorchTPUArguments(**{**payload["base"], **kw})

    out = {}
    for name, kw in payload["refused"].items():
        try:
            Trainer(cfg(**kw), device="cpu")
            out[name] = None
        except (ValueError, NotImplementedError) as exc:
            out[name] = f"{type(exc).__name__}: {exc}"
    for name, kw in payload.get("built", {}).items():
        out[name] = float(Trainer(cfg(**kw), device="cpu").step()["loss"])
    trainer = Trainer(cfg(context_parallel_size=2), device="cpu")
    out["auto"] = trainer.attention_backend
    out["zigzag"] = trainer._zigzag_cp
    out["world"] = trainer.world
    out["rank_logs"] = trainer.logger.level
    out["loss"] = float(trainer.step()["loss"])
    # a save and a resume at dp2, over a loader that counts its position:
    # the resumed step's loss is the straight run's, on both ranks
    from tests.torch_dist_runtime import token_loader

    dp2 = Trainer(cfg(data_parallel_size=2), device="cpu")
    dp2.loader = token_loader(2)
    dp2.step()
    out["save"] = dp2.save_checkpoint()
    straight = float(dp2.step()["loss"])
    dp2.close()
    resumed = Trainer(cfg(data_parallel_size=2), device="cpu")
    resumed.loader = token_loader(2)
    assert resumed.load_checkpoint(required=True)
    out["resume"] = (resumed.global_step, float(resumed.step()["loss"]),
                     straight)
    resumed.close()
    return out


# ---- pipeline and expert parallelism, the int8 wire ------------------------------
def _arch_cfg(arch: dict):
    """A dense Llama/Qwen3 config, or a Qwen3-MoE one when the arch names
    experts; fp32 compute."""
    if "num_experts" in arch:
        from scaletorch_tpu_torch.models.qwen3_moe import Qwen3MoEConfig

        return Qwen3MoEConfig(**arch, dtype=torch.float32)
    return llama.LlamaConfig(**arch, dtype=torch.float32)


def _stats(m) -> dict:
    return {k: float(v) for k, v in m.items()}


def case_mesh_steps(payload):
    """For every run: the step's first gradients (``make_spmd_grad_fn``,
    with ``grads``), the metrics of a step on each of the run's batches
    (the optimizer of the run's or the payload's ``train_cfg``), the eval
    loss of the first batch and the final parameters, each rank's
    shards, over the run's mesh, pipeline schedule and wire format."""
    from scaletorch_tpu_torch.config import ScaleTorchTPUArguments
    from scaletorch_tpu_torch.data.dataloader import device_batch
    from scaletorch_tpu_torch.parallel.pipeline_parallel import (
        stage_layer_layout,
    )
    from scaletorch_tpu_torch.parallel.spmd import (
        local_batch,
        make_spmd_eval_step,
        make_spmd_grad_fn,
        make_spmd_train_step,
    )
    from scaletorch_tpu_torch.parallel.tensor_parallel import shard_dims
    from scaletorch_tpu_torch.trainer.optimizer import create_optimizer

    os.environ["SCALETORCH_TPU_CE_CHUNK"] = str(payload["ce_chunk"])
    out = []
    for run in payload["runs"]:
        model = payload["models"][run["model"]]
        cfg = _arch_cfg(model["arch"])
        mm = tmesh.setup_mesh_manager(**run["mesh"], device_type="cpu")
        engine, vpp = run.get("engine", "afab"), run.get("vpp", 1)
        layout = stage_layer_layout(cfg.num_hidden_layers, mm.pp, engine,
                                    vpp)
        params = params_from_numpy(shard_numpy_params(
            model["params"], cfg, mm, mm.rank, layout=layout), "cpu")
        kw = dict(attention_backend=run.get("backend", "sdpa"),
                  gradient_checkpointing=run.get("gc", False),
                  sequence_parallel=run.get("sp", False),
                  pp_engine=engine, pp_vpp=vpp)
        wire = dict(grad_allreduce_dtype=run.get("wire", "fp32"),
                    grad_allreduce_axis=run.get("wire_axis", "dp"),
                    grad_allreduce_block_size=payload.get("block", 256))
        batches = [device_batch(local_batch(b, mm), "cpu")
                   for b in run["batches"]]
        res = {}
        if run.get("grads"):
            grads_fn = make_spmd_grad_fn(mm, cfg, **kw, **wire)
            loss, grads = grads_fn(params, batches[0])
            res["loss0"] = float(loss)
            res["stats0"] = _stats(grads_fn.stats)
            res["grads0"] = [_np(g) for g in grads]
        tcfg = ScaleTorchTPUArguments(**run.get("train_cfg",
                                                payload["train_cfg"]))
        # the Trainer's layout of the shards; ``local_stats``: none, so an
        # Adafactor takes its statistics over the local shard (a control)
        layout_kw = ({} if run.get("local_stats")
                     else dict(shard_dims=shard_dims(cfg), mesh=mm))
        opt, _ = create_optimizer(tcfg, **layout_kw)
        state = opt.init(params)
        step = make_spmd_train_step(mm, cfg, opt,
                                    max_grad_norm=tcfg.max_grad_norm,
                                    **kw, **wire)
        res["metrics"] = []
        for b in batches:
            params, state, m = step(params, state, b)
            res["metrics"].append(_stats(m))
        evaluate = make_spmd_eval_step(
            mm, cfg, attention_backend=kw["attention_backend"],
            sequence_parallel=kw["sequence_parallel"], pp_engine=engine,
            pp_vpp=vpp)
        res["val"] = float(evaluate(params, batches[0]))
        res["params"] = params_to_numpy(params)
        out.append(res)
    return out


def case_ep_ops(payload):
    """The exchange to and from experts (a function of the slots, its
    gradient), ``exchange_slot_counts``, and ``moe_block``'s output, aux,
    stats and gradients on this rank's tokens, for every mesh in
    ``payload['runs']``."""
    from scaletorch_tpu_torch.models import qwen3_moe
    from scaletorch_tpu_torch.parallel import expert_parallel as tep

    cfg = _arch_cfg(payload["arch"])
    out = []
    for run in payload["runs"]:
        mm = tmesh.setup_mesh_manager(**run["mesh"], device_type="cpu")
        c = mm.my_coords
        res = {}
        with tmesh.using_mesh_manager(mm):
            slots = _t(payload["slots"][c.ep], grad=True)
            got = tep._exchange_to_experts(slots, "ep")
            back = tep._exchange_from_experts(got * 2.0, "ep")
            (g,) = torch.autograd.grad((back * _t(payload["w_back"])).sum()
                                       + (got * got).sum(), slots)
            res.update(to_experts=_np(got), round_trip=_np(back),
                       slots_grad=_np(g))
            res["counts"] = tep.exchange_slot_counts(
                _t(payload["counts"][c.ep]), "ep").numpy().copy()
            # moe_block on this rank's rows (and, under SP, its sequence
            # slice) with this rank's expert / tp shards of the layer
            layer = shard_numpy_params({"layers": payload["layer"]}, cfg,
                                       mm, mm.rank)["layers"]
            layer = {k: _t(v[0], grad=True) for k, v in layer.items()}
            rows = payload["x"].shape[0] // mm.ep
            x = payload["x"][c.ep * rows:(c.ep + 1) * rows]
            sp = run.get("sp", False)
            if sp:
                w = x.shape[1] // mm.tp
                x = x[:, c.tp * w:(c.tp + 1) * w]
            x = _t(np.ascontiguousarray(x), grad=True)
            y, aux, stats = qwen3_moe.moe_block(
                x, layer, cfg, ep_axis="ep" if mm.ep > 1 else None,
                tp_axis="tp" if mm.tp > 1 else None, sequence_parallel=sp)
            dy = payload["dy"][c.ep * rows:(c.ep + 1) * rows]
            if sp:
                dy = dy[:, c.tp * w:(c.tp + 1) * w]
            obj = (y * _t(np.ascontiguousarray(dy))).sum() + 10.0 * aux
            names = list(layer)
            grads = torch.autograd.grad(obj, [x] + [layer[n] for n in names])
            res.update(y=_np(y), aux=float(aux), stats=_stats(stats),
                       x_grad=_np(grads[0]),
                       layer_grads={n: _np(gr) for n, gr in
                                    zip(names, grads[1:])})
        out.append(res)
    return out


def case_quantized(payload):
    """``quantized_pmean`` of this rank's array over the world, twice
    (for equal bits), and ``quantized_pmean_tree`` of its leaves."""
    from scaletorch_tpu_torch.ops import quantized_collectives as tq

    rank = dist.get_rank()
    group = dist.group.WORLD
    out = {}
    for name, per_rank in payload["arrays"].items():
        x = torch.from_numpy(per_rank[rank])
        a = tq.quantized_pmean(x, group, block_size=payload["block"])
        b = tq.quantized_pmean(x, group, block_size=payload["block"])
        out[name] = (a.numpy().copy(), bool(torch.equal(a, b)))
    tree = [torch.from_numpy(t[rank]) for t in payload["tree"]]
    out["tree"] = [t.numpy().copy() for t in tq.quantized_pmean_tree(
        tree, group, dtype="int8", block_size=payload["block"])]
    return out


# ---- tensor-parallel serving --------------------------------------------------------
class _SkewedClock:
    """The ``time`` module with ``monotonic`` ``offset`` seconds ahead."""

    def __init__(self, real) -> None:
        self._real, self.offset = real, 0.0

    def monotonic(self) -> float:
        return self._real.monotonic() + self.offset

    def __getattr__(self, name):
        return getattr(self._real, name)


def case_tp_serving(payload):
    """For every run: an ``InferenceEngine`` over the run's mesh (this
    rank's shards of the full weights) serving the run's schedule, with
    what every rank must agree on: tokens and outcomes per request, the
    compile counts, the local cache shape, page conservation; and the
    teacher-forced logits of the mesh's model over ``payload['tokens']``.
    ``skew``: the rank whose clock jumps ahead once the requests are in
    (a TTL passes there first)."""
    from scaletorch_tpu_torch.inference import engine as teng
    from scaletorch_tpu_torch.inference.decode import (
        teacher_forced_decode,
        teacher_forced_decode_paged,
    )
    from scaletorch_tpu_torch.inference.kv_cache import (
        kv_cache_shardings,
        paged_kv_cache_shardings,
    )
    from scaletorch_tpu_torch.inference.sampling import SamplingParams

    out = []
    for run in payload["runs"]:
        cfg = llama.LlamaConfig(**payload["archs"][run["arch"]],
                                dtype=torch.float32)
        mm = tmesh.setup_mesh_manager(**run["mesh"], device_type="cpu")
        params = payload["params"][run["arch"]]
        layout = run.get("layout", "dense")
        eng = teng.InferenceEngine(
            params, cfg, max_slots=2, max_seq=run["max_seq"], prefill_len=8,
            sampling=SamplingParams(temperature=0.0), cache_layout=layout,
            page_size=4, mesh=mm, batch_axis=run.get("batch_axis"),
            donate_cache=False, device="cpu")
        clock = _SkewedClock(teng.time)
        teng.time = clock
        try:
            ids = [eng.submit(list(p), max_new_tokens=n,
                              **({"ttl_s": run["ttl_s"]} if "ttl_s" in run
                                 else {}))
                   for p, n in run["schedule"]]
            if run.get("skew") == mm.rank:
                clock.offset = 1000.0
            results = eng.run()
        finally:
            teng.time = clock._real
        res = {"tokens": [results[i].tokens for i in ids],
               "outcomes": [results[i].outcome for i in ids],
               "compiles": (eng.prefill_compile_count,
                            eng.decode_compile_count),
               "cache_shape": tuple(eng.cache.k.shape),
               "embed_shape": tuple(eng.model.embed_tokens.shape)}
        if eng.allocator is not None:
            eng.allocator.check_conservation()
            eng.radix.evict(eng.num_pages)
            res["pages_free"] = (eng.allocator.free_count
                                 == eng.allocator.capacity)
        if "tokens" in payload and "skew" not in run:
            toks = torch.from_numpy(payload["tokens"])
            with tmesh.using_mesh_manager(mm), torch.inference_mode():
                if layout == "paged":
                    logits = teacher_forced_decode_paged(
                        eng.model, cfg, toks, page_size=4, prefill_len=3,
                        sharding=paged_kv_cache_shardings(mm))
                else:
                    logits = teacher_forced_decode(
                        eng.model, cfg, toks, prefill_len=3,
                        sharding=kv_cache_shardings(mm))
            res["logits"] = _np(logits)
        out.append(res)
        del eng
        mm.destroy()
    return out


def case_moe_mesh_serving(payload):
    """For every run: a paged Qwen3-MoE ``InferenceEngine`` over the run's
    tp x ep mesh (this rank's slices of the full weights) serving the
    payload's schedule: tokens and outcomes per request, the compile
    counts, the local cache and expert shapes, page conservation; and the
    teacher-forced logits of the mesh's model over ``payload['tokens']``."""
    from scaletorch_tpu_torch.inference import engine as teng
    from scaletorch_tpu_torch.inference.decode import (
        teacher_forced_decode_paged,
    )
    from scaletorch_tpu_torch.inference.kv_cache import (
        paged_kv_cache_shardings,
    )
    from scaletorch_tpu_torch.inference.sampling import SamplingParams
    from scaletorch_tpu_torch.models.qwen3_moe import Qwen3MoEConfig

    out = []
    for run in payload["runs"]:
        cfg = Qwen3MoEConfig(**payload["kw"], dtype=torch.float32,
                             use_grouped_mlp_kernel=run.get("kernel", False))
        mm = tmesh.setup_mesh_manager(**run["mesh"], device_type="cpu")
        eng = teng.InferenceEngine(
            payload["params"], cfg, **payload["engine"],
            sampling=SamplingParams(temperature=0.0), mesh=mm,
            device="cpu")
        ids = [eng.submit(list(p), max_new_tokens=n)
               for p, n in payload["schedule"]]
        results = eng.run()
        eng.allocator.check_conservation()
        res = {"tokens": [results[i].tokens for i in ids],
               "outcomes": [results[i].outcome for i in ids],
               "compiles": (eng.prefill_compile_count,
                            eng.decode_compile_count),
               "prefix_hits": eng.metrics.prefix_hits,
               "cache_shape": tuple(eng.cache.k.shape),
               "expert_shape": tuple(
                   eng.model.layers["expert_gate_proj"].shape[1:]),
               "first_expert": eng.model.first_expert}
        toks = torch.from_numpy(payload["tokens"])
        with tmesh.using_mesh_manager(mm), torch.inference_mode():
            logits = teacher_forced_decode_paged(
                eng.model, cfg, toks, page_size=payload["engine"]["page_size"],
                prefill_len=3, sharding=paged_kv_cache_shardings(mm))
        res["logits"] = _np(logits)
        out.append(res)
        del eng
        mm.destroy()
    return out


def case_gpt_moe_mesh_serving(payload):
    """For every run: a GPT-MoE ``InferenceEngine`` over the run's tp (x
    dp) mesh (this rank's slices of the full weights) serving the
    payload's schedule: tokens and outcomes per request, the compile
    counts, the local cache and expert shapes; and the teacher-forced
    logits of the mesh's model over ``payload['tokens']`` (paged)."""
    from scaletorch_tpu_torch.inference import engine as teng
    from scaletorch_tpu_torch.inference.decode import (
        teacher_forced_decode_paged,
    )
    from scaletorch_tpu_torch.inference.kv_cache import (
        paged_kv_cache_shardings,
    )
    from scaletorch_tpu_torch.inference.sampling import SamplingParams
    from scaletorch_tpu_torch.models.gpt_moe import GPTMoEConfig

    cfg = GPTMoEConfig(**payload["kw"])
    out = []
    for run in payload["runs"]:
        mm = tmesh.setup_mesh_manager(**run["mesh"], device_type="cpu")
        eng = teng.InferenceEngine(
            payload["params"], cfg, **{**payload["engine"], **run["engine"]},
            sampling=SamplingParams(temperature=0.0), mesh=mm,
            batch_axis=run.get("batch_axis"), device="cpu")
        ids = [eng.submit(list(p), max_new_tokens=n)
               for p, n in payload["schedule"]]
        results = eng.run()
        res = {"tokens": [results[i].tokens for i in ids],
               "outcomes": [results[i].outcome for i in ids],
               "compiles": (eng.prefill_compile_count,
                            eng.decode_compile_count),
               "cache_shape": tuple(eng.cache.k.shape),
               "qkv_shape": tuple(eng.model.layers["attn_qkv"].shape),
               "expert_shapes": (
                   tuple(eng.model.layers["expert_fc"].shape),
                   tuple(eng.model.layers["expert_proj"].shape))}
        if run.get("logits"):
            toks = torch.from_numpy(payload["tokens"])
            with tmesh.using_mesh_manager(mm), torch.inference_mode():
                logits = teacher_forced_decode_paged(
                    eng.model, cfg, toks,
                    page_size=payload["engine"]["page_size"], prefill_len=3,
                    sharding=paged_kv_cache_shardings(mm))
            res["logits"] = _np(logits)
        out.append(res)
        del eng
        mm.destroy()
    return out


def case_example_run(payload):
    """Each of ``payload['runs']`` in turn on this rank: an example's
    ``run(argv)`` (``module`` under ``scaletorch_tpu_torch.examples``),
    and the result's keys listed in ``keep``."""
    import importlib

    out = []
    for run in payload["runs"]:
        mod = importlib.import_module(
            f"scaletorch_tpu_torch.examples.{run['module']}")
        res = mod.run(run["argv"])
        out.append({k: res[k] for k in run["keep"]})
    return out


def case_imagenet_example(payload):
    """The ImageNet example's ``run`` on this rank (the gloo group is the
    data-parallel group): its losses, validation numbers and the final
    parameters and BN state in the JAX layout."""
    from scaletorch_tpu_torch.examples.imagenet import dist_train
    from scaletorch_tpu_torch.models.convert import resnet_to_jax

    out = dist_train.run(payload["argv"])
    return {"world": out["world"], "losses": out["losses"],
            "val": out["val"],
            "trees": resnet_to_jax(out["params"], out["bn_state"])}


# ---- FSDP -------------------------------------------------------------------------
def case_fsdp(payload):
    """For every run: ``setup_fsdp`` over the world (fp32 or bf16
    parameters, the payload's optimizer), a step on each global batch
    (this rank's rows), and what the rank stores: its losses, the
    elements of its parameters and optimizer state, its shards."""
    from scaletorch_tpu_torch.config import ScaleTorchTPUArguments
    from scaletorch_tpu_torch.data.dataloader import device_batch
    from scaletorch_tpu_torch.parallel.fsdp import local_numel, setup_fsdp
    from scaletorch_tpu_torch.parallel.spmd import local_batch
    from scaletorch_tpu_torch.trainer.optimizer import create_optimizer

    out = []
    for run in payload["runs"]:
        dtype = {"float32": torch.float32,
                 "bfloat16": torch.bfloat16}[run["dtype"]]
        cfg = llama.LlamaConfig(**payload["arch"], dtype=dtype,
                                param_dtype=dtype)
        opt, _ = create_optimizer(ScaleTorchTPUArguments(
            **payload["train_cfg"]))
        step, params, state, mesh = setup_fsdp(
            cfg, payload["params"], opt, device="cpu", dtype=dtype,
            gradient_checkpointing=run.get("gc", False),
            attention_backend=run.get("backend", "sdpa"))
        losses = []
        for b in payload["batches"][:run["steps"]]:
            params, state, m = step(params, state, device_batch(
                local_batch(b, mesh), "cpu"))
            losses.append(float(m["loss"]))
            assert float(m["update_skipped"]) == 0.0
        state_trees = {k: v for k, v in state.items() if k != "count"}
        out.append({
            "losses": losses,
            "dtypes": sorted({str(t.dtype) for t in
                              flatten_params(params).values()}),
            "numel": {n: int(t.numel())
                      for n, t in flatten_params(params).items()},
            "state_numel": {f"{k}.{n}": int(t.numel())
                            for k, tree in state_trees.items()
                            for n, t in flatten_params(tree).items()},
            "param_numel": local_numel(params),
            "params": params_to_numpy(params)})
    return out


def case_sort_dispatch(payload):
    """The sort-based exchange over an ep group of the whole world, for
    each chunk capacity in ``payload['capacities']``: this rank's
    ``sort_dispatch_tokens`` outputs and dropped rows, the round trip of
    the received rows doubled, and ``sorted_moe_forward`` with the
    gradients of sum(out²) over its rows and its experts."""
    from scaletorch_tpu_torch.parallel import expert_parallel as tep

    ep = dist.get_world_size()
    mm = tmesh.setup_mesh_manager(ep=ep, device_type="cpu")
    r = mm.my_coords.ep
    e = payload["num_experts"]
    el = e // ep

    def rows(a):
        n = a.shape[0] // ep
        return _t(np.ascontiguousarray(a[r * n:(r + 1) * n]))

    out = []
    with tmesh.using_mesh_manager(mm):
        for cap in payload["capacities"]:
            recv, local, valid, meta = tep.sort_dispatch_tokens(
                rows(payload["flat_x"]), rows(payload["flat_ids"]),
                axis="ep", num_experts=e, chunk_capacity=cap)
            back = tep.sort_gather_tokens(recv * 2.0, meta, axis="ep")
            x = rows(payload["x"]).requires_grad_(True)
            ws = [_t(w[r * el:(r + 1) * el], grad=True)
                  for w in payload["w"]]
            y = tep.sorted_moe_forward(
                x, rows(payload["gate_idx"]), rows(payload["gate_w"]), *ws,
                axis="ep", num_experts=e, chunk_capacity=cap)
            grads = torch.autograd.grad((y * y).sum(), [x] + ws)
            out.append({"recv": _np(recv), "local": local.numpy().copy(),
                        "valid": valid.numpy().copy(),
                        "dropped": int(meta["dropped_rows"]),
                        "back": _np(back), "y": _np(y),
                        "grads": [_np(g) for g in grads]})
    return out


CASES = {name[len("case_"):]: fn for name, fn in globals().items()
         if name.startswith("case_")}
# the multi-process runtime's cases (coordinated decisions, checkpoints,
# exports, elastic yardsticks)
from tests import torch_dist_runtime  # noqa: E402

CASES.update(torch_dist_runtime.CASES)


def main(argv) -> int:
    case, rank, world, tmp = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    # a case may ask for a shorter timeout of every collective (a control
    # that must fail its waits in bounded time)
    stdist.init_distributed(
        "env", coordinator_address=f"file://{tmp}/store",
        num_processes=world, process_id=rank, device="cpu",
        timeout_s=float(os.environ.get("TORCH_DIST_CASE_TIMEOUT_S",
                                       INIT_TIMEOUT_S)))
    with open(os.path.join(tmp, "payload.pkl"), "rb") as f:
        payload = pickle.load(f)
    try:
        result = CASES[case](payload)
        stdist.barrier()
    finally:
        stdist.shutdown_distributed()
    assert "jax" not in sys.modules, "a rank process imported JAX"
    with open(os.path.join(tmp, f"out_{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
