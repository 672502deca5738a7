"""PyTorch port, the zero-drop sort-based MoE dispatch
(``parallel/expert_parallel.py``) against the JAX package.

  * ``sorted_dispatch_reference``: the reference's invariants (grouped by
    expert, stable within a group, counts summing to N) and equal to
    JAX's;
  * ``sorted_moe_forward`` at ``axis=None`` (the world-1 no-op) on the
    reference's skewed problem, against JAX's and a dense loop: <= 1e-5,
    with the ``RuntimeWarning`` above 4 local experts;
  * over ep 1, 2 and 4 in gloo processes (one start per world size;
    a named axis of one rank still goes through the exchange), against
    the JAX functions under ``shard_map`` on the same inputs:
    ``sort_dispatch_tokens``' received rows, local ids and valid mask
    equal, ``dropped_rows`` equal, the round trip, and
    ``sorted_moe_forward``'s output and the gradients of sum(out²)
    (<= 1e-5), at the zero-drop default and at a chunk capacity small
    enough to drop (dropped rows come back as exact zeros).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from scaletorch_tpu.parallel import expert_parallel as jep
from scaletorch_tpu_torch.parallel import expert_parallel as tep
from tests.torch_dist_harness import run_ranks

TOL = 1e-5
E, K, N, H, I = 8, 2, 64, 16, 32
SMALL_CAP = 16  # below the skewed sends to rank 0 at ep 2 and ep 4
CAPACITIES = (None, SMALL_CAP)


def problem(seed=0):
    """The reference's skewed problem: most mass on experts 0-1."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, H)).astype(np.float32)
    w = [(rng.standard_normal(s) * 0.1).astype(np.float32)
         for s in ((E, H, I), (E, H, I), (E, I, H))]
    p = np.array([.4, .3, .1, .05, .05, .04, .03, .03])
    gate_idx = rng.choice(E, size=(N, K), p=p).astype(np.int32)
    gate_w = rng.random((N, K)).astype(np.float32)
    return x, gate_idx, gate_w, w


def dense_reference(x, gate_idx, gate_w, w):
    gp, up, dn = (a.astype(np.float64) for a in w)
    out = np.zeros(x.shape, np.float64)
    for n in range(x.shape[0]):
        for j in range(gate_idx.shape[1]):
            e = gate_idx[n, j]
            g, u = x[n] @ gp[e], x[n] @ up[e]
            out[n] += gate_w[n, j] * ((g / (1 + np.exp(-g)) * u) @ dn[e])
    return out


def test_sorted_dispatch_reference_invariants():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((40, 4)).astype(np.float32)
    ids = rng.integers(0, 6, 40).astype(np.int32)
    got = tep.sorted_dispatch_reference(torch.from_numpy(x),
                                        torch.from_numpy(ids), 6)
    want = jep.sorted_dispatch_reference(jnp.asarray(x), jnp.asarray(ids), 6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    sorted_x, idx, counts = (t.numpy() for t in got)
    assert counts.sum() == 40
    assert (np.diff(ids[idx]) >= 0).all()  # grouped by expert
    for e in range(6):  # stable within a group
        assert (np.diff(idx[ids[idx] == e]) > 0).all()
    np.testing.assert_array_equal(sorted_x, x[idx])


def test_world_one_matches_the_jax_and_dense_forward():
    x, gi, gw, w = problem()
    with pytest.warns(RuntimeWarning, match="E_local=8"):
        got = tep.sorted_moe_forward(
            torch.from_numpy(x), torch.from_numpy(gi), torch.from_numpy(gw),
            *map(torch.from_numpy, w), axis=None, num_experts=E).numpy()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = np.asarray(jep.sorted_moe_forward(
            jnp.asarray(x), jnp.asarray(gi), jnp.asarray(gw),
            *map(jnp.asarray, w), axis=None, num_experts=E))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, dense_reference(x, gi, gw, w), atol=TOL,
                               rtol=0)


def jax_reference(ep: int, payload: dict, cap) -> dict:
    mesh = Mesh(np.array(jax.devices()[:ep]), ("ep",))

    def dispatch(fx, ids):
        recv, local, valid, meta = jep.sort_dispatch_tokens(
            fx, ids, axis="ep", num_experts=E, chunk_capacity=cap)
        back = jep.sort_gather_tokens(recv * 2.0, meta, axis="ep")
        return recv, local, valid, meta["dropped_rows"][None], back

    spec = P("ep")
    recv, local, valid, dropped, back = jax.jit(jax.shard_map(
        dispatch, mesh=mesh, in_specs=(spec, spec), out_specs=(spec,) * 5))(
        payload["flat_x"], payload["flat_ids"])

    def moe(x, gi, gw, g, u, d):
        return jep.sorted_moe_forward(x, gi, gw, g, u, d, axis="ep",
                                      num_experts=E, chunk_capacity=cap)

    f = jax.shard_map(moe, mesh=mesh, in_specs=(spec,) * 6, out_specs=spec)
    gi, gw = payload["gate_idx"], payload["gate_w"]
    y = jax.jit(f)(payload["x"], gi, gw, *payload["w"])
    grads = jax.jit(jax.grad(
        lambda x, g, u, d: jnp.sum(f(x, gi, gw, g, u, d) ** 2),
        argnums=(0, 1, 2, 3)))(payload["x"], *payload["w"])
    per = recv.shape[0] // ep

    def split(a, n):
        a = np.asarray(a)
        return [a[r * n:(r + 1) * n] for r in range(ep)]

    el = E // ep
    return {"recv": split(recv, per), "local": split(local, per),
            "valid": split(valid, per),
            "dropped": np.asarray(dropped).tolist(),
            "back": split(back, 2 * N // ep), "y": split(y, N // ep),
            "grads": [split(grads[0], N // ep)]
            + [split(g, el) for g in grads[1:]]}


@pytest.fixture(scope="module")
def payload():
    x, gi, gw, w = problem()
    return {"num_experts": E, "capacities": CAPACITIES,
            "flat_x": np.repeat(x, K, axis=0), "flat_ids": gi.reshape(-1),
            "x": x, "gate_idx": gi, "gate_w": gw, "w": w}


@pytest.mark.parametrize("ep", [1, 2, 4])
def test_sort_dispatch_over_ep_matches_the_jax_exchange(ep, payload,
                                                        tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        ranks = run_ranks(tmp_path, ep, "sort_dispatch", payload)
        for c, cap in enumerate(CAPACITIES):
            want = jax_reference(ep, payload, cap)
            got = [r[c] for r in ranks]
            assert [g["dropped"] for g in got] == want["dropped"]
            # every rank's skewed send to rank 0 overflows the small slab,
            # at ep 1 too
            assert (sum(want["dropped"]) > 0) == (cap is not None)
            for r, g in enumerate(got):
                what = f"ep{ep} cap {cap} rank {r}"
                np.testing.assert_array_equal(g["valid"], want["valid"][r],
                                              err_msg=what)
                np.testing.assert_array_equal(g["local"], want["local"][r],
                                              err_msg=what)
                np.testing.assert_array_equal(g["recv"], want["recv"][r],
                                              err_msg=what)
                np.testing.assert_array_equal(g["back"], want["back"][r],
                                              err_msg=what)
                np.testing.assert_allclose(g["y"], want["y"][r], atol=TOL,
                                           rtol=0, err_msg=what)
                for i, gr in enumerate(g["grads"]):
                    np.testing.assert_allclose(
                        gr, want["grads"][i][r], atol=TOL, rtol=0,
                        err_msg=f"{what} grad {i}")
    # zero-drop: the exchange loses nothing, so it is the dense function
    y = np.concatenate([r[0]["y"] for r in ranks])
    np.testing.assert_allclose(
        y, dense_reference(payload["x"], payload["gate_idx"],
                           payload["gate_w"], payload["w"]), atol=TOL,
        rtol=0)
    # rows past a slab come back as exact zeros: twice a row or nothing
    flat = payload["flat_x"].reshape(ep, -1, H)
    for r, rank in enumerate(ranks):
        back = rank[1]["back"]
        lost = ~np.isclose(back, 2.0 * flat[r]).all(axis=1)
        assert (back[lost] == 0.0).all()
        assert lost.sum() == rank[1]["dropped"]
