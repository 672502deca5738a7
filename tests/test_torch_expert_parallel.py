"""PyTorch port, MoE routing and token movement against the JAX package's
``parallel/expert_parallel.py`` (single device).

The same numpy logits and tokens go through both. Routing decisions are
integers and must be EXACTLY equal (expert ids, queue slots, fill counts,
which choices are dropped); weights, dispatch/combine tensors, moved rows
and the aux scalars agree to 1e-6 (fp32 softmax and sums in another
order). Both movement forms are checked, with a capacity that drops
choices and one that does not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaletorch_tpu.ops.pallas import grouped_mlp as jgm
from scaletorch_tpu.parallel import expert_parallel as jep
from scaletorch_tpu_torch.ops import grouped_mlp as tgm
from scaletorch_tpu_torch.parallel import expert_parallel as tep

N, E, K, H = 32, 8, 2, 16
ATOL = 1e-6


def logits_and_x(seed=0, groups=None):
    rng = np.random.default_rng(seed)
    lead = () if groups is None else (groups,)
    logits = rng.standard_normal(lead + (N, E)).astype(np.float32)
    x = rng.standard_normal(lead + (N, H)).astype(np.float32)
    return logits, x


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def test_expert_capacity_matches():
    for args in [(64, 8, 2, 1.0), (64, 8, 2, 1.25), (4, 64, 1, 1.0),
                 (8, 2, 1, 100.0), (1, 128, 8, 16.0), (512, 128, 8, 16.0),
                 (4096, 128, 8, 1.25)]:
        assert tep.expert_capacity(*args) == jep.expert_capacity(*args)
    assert tep.expert_capacity(1, 128, 8, 16.0) == 1
    assert tep.expert_capacity(4096, 128, 8, 1.25) == 320


@pytest.mark.parametrize("cf", [8.0, 0.5], ids=["dropless", "drops"])
@pytest.mark.parametrize("normalize", [True, False])
def test_indexed_routing_is_exactly_the_reference(cf, normalize):
    logits, _ = logits_and_x()
    cap = jep.expert_capacity(N, E, K, cf)
    want, jaux = jep.top_k_routing_indexed(jnp.asarray(logits), K, cap,
                                           normalize_weights=normalize)
    got, taux = tep.top_k_routing_indexed(torch.from_numpy(logits), K, cap,
                                          normalize_weights=normalize)
    for name in ("expert_idx", "slot"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
        assert got[name].dtype == torch.int32
    close(got["weight"], want["weight"])
    for name in ("aux_loss", "z_loss", "expert_load", "dropped_fraction"):
        close(taux[name], jaux[name])
    dropped = float(taux["dropped_fraction"])
    assert (dropped > 0) == (cf < 1)
    np.testing.assert_array_equal(
        tep.slot_fill_counts_indexed(got, E, cap).numpy(),
        np.asarray(jep.slot_fill_counts_indexed(want, E, cap)))


@pytest.mark.parametrize("cf", [8.0, 0.5], ids=["dropless", "drops"])
def test_one_hot_routing_is_exactly_the_reference(cf):
    logits, _ = logits_and_x(seed=1)
    cap = jep.expert_capacity(N, E, K, cf)
    jd, jc, jaux = jep.top_k_routing(jnp.asarray(logits), K, cap)
    td, tc, taux = tep.top_k_routing(torch.from_numpy(logits), K, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    close(tc, jc)
    for name in jaux:
        close(taux[name], jaux[name])
    np.testing.assert_array_equal(tgm.slot_fill_counts(td).numpy(),
                                  np.asarray(jgm.slot_fill_counts(jd)))


def test_ties_go_to_the_lower_expert():
    logits = np.zeros((4, E), np.float32)
    logits[:, 5] = 1.0
    cap = jep.expert_capacity(4, E, K, 8.0)
    want, _ = jep.top_k_routing_indexed(jnp.asarray(logits), K, cap)
    got, _ = tep.top_k_routing_indexed(torch.from_numpy(logits), K, cap)
    for name in ("expert_idx", "slot"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
    assert got["expert_idx"].tolist() == [[5, 0]] * 4


@pytest.mark.parametrize("mode", ["index", "einsum"])
@pytest.mark.parametrize("cf", [8.0, 0.5], ids=["dropless", "drops"])
def test_route_dispatch_combine_match(mode, cf):
    """route_tokens -> dispatch_routed -> combine_routed over two groups
    (the model's batch rows), as ``moe_block`` runs them."""
    logits, x = logits_and_x(seed=2, groups=2)
    cap = jep.expert_capacity(N, E, K, cf)
    jstates, jauxes, jslots, jys = [], [], [], []
    for g in range(2):  # the reference vmaps routing over the groups
        st, ax = jep.route_tokens(jnp.asarray(logits[g]), K, cap, mode=mode)
        jstates.append(st)
        jauxes.append(ax)
    jstate = {k: jnp.stack([s[k] for s in jstates]) for k in jstates[0]}
    jslots = jep.dispatch_routed(jnp.asarray(x), jstate, mode=mode,
                                 num_experts=E, capacity=cap)
    tstate, taux = tep.route_tokens(torch.from_numpy(logits), K, cap,
                                    mode=mode)
    tslots = tep.dispatch_routed(torch.from_numpy(x), tstate, mode=mode,
                                 num_experts=E, capacity=cap)
    assert tuple(tslots.shape) == (E, 2 * cap, H)
    close(tslots, jslots)
    for name in jauxes[0]:
        want = np.stack([np.asarray(a[name]) for a in jauxes])
        close(taux[name], want)
    # the expert outputs: any function of the slots; combine them back
    out = np.tanh(np.asarray(jslots)) + 0.5
    jy = jep.combine_routed(jnp.asarray(out), jstate, mode=mode,
                            num_experts=E, capacity=cap)
    ty = tep.combine_routed(torch.from_numpy(out), tstate, mode=mode,
                            num_experts=E, capacity=cap)
    close(ty, jy, atol=1e-5)
    np.testing.assert_array_equal(
        tep.routed_fill_counts(tstate, mode=mode, num_experts=E,
                               capacity=cap).numpy(),
        np.asarray(jep.routed_fill_counts(jstate, mode=mode, num_experts=E,
                                          capacity=cap)))


def test_index_dispatch_drops_rows_past_capacity():
    """A capacity of 1 drops most choices: the dropped rows land nowhere
    (``mode='drop'``), the kept ones in their slots, the rest is zero."""
    logits, x = logits_and_x(seed=4)
    routing, aux = tep.top_k_routing_indexed(torch.from_numpy(logits), K, 1)
    slots = tep.dispatch_tokens_indexed(torch.from_numpy(x), routing,
                                        num_experts=E, capacity=1)
    want = jep.dispatch_tokens_indexed(
        jnp.asarray(x), {k: jnp.asarray(v.numpy()) for k, v in
                         routing.items()}, num_experts=E, capacity=1)
    close(slots, want)
    assert float(aux["dropped_fraction"]) > 0.5
    kept = int((routing["slot"] < 1).sum())
    assert int((slots.abs().sum(-1) > 0).sum()) == kept <= E


def test_moe_mlp_paths_match_the_reference():
    rng = np.random.default_rng(5)
    cap, groups, i = 4, 2, 12
    x = rng.standard_normal((E, groups * cap, H)).astype(np.float32)
    w = [(rng.standard_normal(s) * 0.2).astype(np.float32)
         for s in ((E, H, i), (E, H, i), (E, i, H))]
    counts = rng.integers(0, cap + 1, (E, groups)).astype(np.int32)
    want = jep.moe_mlp(jnp.asarray(x), *map(jnp.asarray, w))
    got = tep.moe_mlp(torch.from_numpy(x), *map(torch.from_numpy, w))
    close(got, want, atol=1e-5)
    want = jep.moe_mlp(jnp.asarray(x), *map(jnp.asarray, w),
                       slot_counts=jnp.asarray(counts), capacity=cap)
    got = tep.moe_mlp(torch.from_numpy(x), *map(torch.from_numpy, w),
                      slot_counts=torch.from_numpy(counts), capacity=cap)
    close(got, want, atol=1e-5)


def test_modes_and_axes():
    assert tep.resolve_moe_dispatch("auto", 128) == "index"
    assert tep.resolve_moe_dispatch("einsum", 4) == "einsum"
    with pytest.raises(ValueError, match="dispatch mode"):
        tep.route_tokens(torch.zeros(4, E), K, 2, mode="sort")
    # an expert-parallel axis names a mesh axis: without a mesh it raises,
    # on a mesh of one rank the exchange is the identity
    from scaletorch_tpu_torch.parallel import mesh as tmesh

    x, d = torch.randn(4, H), torch.rand(4, E, 2)
    with pytest.raises(RuntimeError, match="needs a mesh"):
        with tmesh.using_mesh_manager(None):
            tep.dispatch_tokens(x, d, axis="ep")
    with tmesh.using_mesh_manager(tmesh.MeshManager()):
        assert torch.equal(tep.dispatch_tokens(x, d, axis="ep"),
                           tep.dispatch_tokens(x, d))

    class Cfg:
        num_experts = 8

    tep.validate_ep_divisibility(Cfg, 4)
    with pytest.raises(ValueError, match="not divisible"):
        tep.validate_ep_divisibility(Cfg, 3)
