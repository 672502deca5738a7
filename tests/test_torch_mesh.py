"""PyTorch port, the 5-axis mesh (``scaletorch_tpu_torch/parallel/
mesh.py``) against the JAX package's ``MeshManager`` on the virtual CPU
devices.

The grid arithmetic (rank decomposition with tp fastest, the cp ring's
neighbours, the pp chain) is compared rank by rank; the process groups
the port builds in 4 gloo processes (``init_device_mesh`` per axis, the
fused ``("dp", "cp")`` group) hold the same ranks as the reference
mesh's slices along each axis, with the reference given
``devices=jax.devices()[:world]`` so device i is rank i. Exact
comparisons: no arithmetic.
"""

import jax
import numpy as np
import pytest

from scaletorch_tpu.parallel import mesh as jmesh
from scaletorch_tpu_torch.parallel import mesh as tmesh
from tests.torch_dist_harness import run_ranks

GEOMETRIES = [dict(dp=2, cp=2, tp=2), dict(dp=8), dict(pp=2, ep=2, tp=2),
              dict(tp=8), dict(dp=2, pp=2, cp=2), dict(cp=4, tp=2),
              dict(dp=2, tp=2), dict(cp=4)]
GLOO_SHAPES = [dict(dp=2, tp=2), dict(cp=2, tp=2), dict(dp=2, cp=2),
               dict(cp=4), dict(tp=4)]


def reference(shape):
    world = int(np.prod(list(shape.values())))
    return jmesh.MeshManager(**shape, devices=jax.devices()[:world])


def reference_rank_sets(jm, axes):
    """The ranks of each group over ``axes`` of the reference mesh
    (device i = rank i), as sorted tuples."""
    ids = {d.id: i for i, d in enumerate(jax.devices())}
    grid = np.vectorize(lambda d: ids[d.id])(jm.mesh.devices)
    dims = [jmesh.MESH_AXES.index(a) for a in axes]
    rest = [i for i in range(grid.ndim) if i not in dims]
    moved = np.transpose(grid, rest + dims)
    return sorted(tuple(sorted(g)) for g in
                  moved.reshape(-1, int(np.prod([grid.shape[d]
                                                 for d in dims]))).tolist())


@pytest.mark.parametrize("shape", GEOMETRIES,
                         ids=lambda s: "x".join(f"{k}{v}" for k, v in
                                                s.items()))
def test_grid_math_matches_the_reference(shape):
    jm, tm = reference(shape), tmesh.MeshManager(**shape)
    assert tm.shape == jm.shape and tm.world_size == jm.world_size
    assert tm.mesh is None and tm.group("tp") is None
    for r in range(tm.world_size):
        assert tm.coords(r).as_tuple() == jm.coords(r).as_tuple()
        assert tm.rank_of(tm.coords(r)) == r
    for c in range(tm.cp):
        assert tm.cp_send_rank(c) == jm.cp_send_rank(c)
        assert tm.cp_recv_rank(c) == jm.cp_recv_rank(c)
    for p in range(tm.pp):
        assert tm.pp_next_rank(p) == jm.pp_next_rank(p)
        assert tm.pp_prev_rank(p) == jm.pp_prev_rank(p)
        assert tm.pp_is_first_stage(p) == jm.pp_is_first_stage(p)
        assert tm.pp_is_last_stage(p) == jm.pp_is_last_stage(p)
    assert tm.cp_ring_permutation() == jm.cp_ring_permutation()
    assert tm.pp_fwd_permutation() == jm.pp_fwd_permutation()
    assert tm.pp_bwd_permutation() == jm.pp_bwd_permutation()
    for axes in [(a,) for a in tmesh.MESH_AXES] + [tmesh.DATA_AXES]:
        got = sorted(tuple(g) for g in tm.axis_rank_sets(axes))
        assert got == reference_rank_sets(jm, axes)


def test_validation_and_the_process_wide_manager():
    with pytest.raises(ValueError, match=">= 1"):
        tmesh.MeshManager(tp=0)
    with pytest.raises(ValueError, match="out of range"):
        tmesh.MeshManager(tp=8).coords(8)
    with pytest.raises(ValueError, match="needs a process group"):
        tmesh.MeshManager(tp=2, device_type="cpu")
    tmesh.reset_mesh_manager()
    assert not tmesh.mesh_manager
    with pytest.raises(RuntimeError, match="not initialised"):
        tmesh.mesh_manager.tp
    with pytest.raises(RuntimeError, match="needs a mesh"):
        tmesh.axis_group("tp")
    assert tmesh.axis_group(None) is None
    mm = tmesh.setup_mesh_manager(tp=1, device_type="cpu")
    assert tmesh.mesh_manager and tmesh.mesh_manager.tp == 1
    assert tmesh.current_mesh_manager() is mm and mm.mesh is None
    assert tmesh.axis_group("tp") is None  # one rank: no group
    tmesh.reset_mesh_manager()


def test_groups_over_four_gloo_processes(tmp_path):
    res = run_ranks(tmp_path, 4, "mesh", {"shapes": GLOO_SHAPES})
    for i, shape in enumerate(GLOO_SHAPES):
        jm = reference(shape)
        sets = {axis: reference_rank_sets(jm, (axis,))
                for axis in tmesh.MESH_AXES}
        sets["data"] = reference_rank_sets(jm, tmesh.DATA_AXES)
        for rank, out in enumerate(r[i] for r in res):
            assert out["coords"] == jm.coords(rank).as_tuple()
            assert out["mesh_shape"] == jm.shape
            for name, groups in sets.items():
                mine = [g for g in groups if rank in g]
                assert [tuple(out["groups"][name])] == mine, name
            c = jm.coords(rank)
            send = jm.rank_of(jmesh.MeshCoords(
                c.dp, c.pp, jm.cp_send_rank(c.cp), c.ep, c.tp))
            recv = jm.rank_of(jmesh.MeshCoords(
                c.dp, c.pp, jm.cp_recv_rank(c.cp), c.ep, c.tp))
            assert tuple(out["ring"]) == (send, recv)
