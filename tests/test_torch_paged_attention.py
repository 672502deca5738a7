"""PyTorch port, paged attention: the page scatter/gather against the JAX
package's (byte-equal), the paged-decode kernel's plain version against
the Pallas kernel in interpret mode and against the gather fallback
(fp32, atol 1e-5), the dispatcher's routing, the kernel wrapper's input
checks. The CUDA kernel itself is tested on the card by
``test_torch_paged_decode_cuda.py``, which imports no JAX so that it runs
on the GPU machine."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaletorch_tpu_torch.ops import _build

jpa = importlib.import_module("scaletorch_tpu.ops.pallas.paged_attention")
tpa = importlib.import_module("scaletorch_tpu_torch.ops.paged_attention")

PAGE = 4


def make_pool_and_tables(n_rep, seed=0, b=3, hkv=2, d=16, max_pages=6):
    """Shuffled physical pages, a pool with one spare page past the
    tables, and positions at 0, a page boundary and the last slot."""
    rng = np.random.default_rng(seed)
    n_pages = b * max_pages + 2
    pool_k = rng.standard_normal((n_pages, hkv, PAGE, d)).astype(np.float32)
    pool_v = rng.standard_normal((n_pages, hkv, PAGE, d)).astype(np.float32)
    tables = (rng.permutation(n_pages - 2) + 1).astype(np.int32)
    tables = tables.reshape(b, max_pages)
    q = rng.standard_normal((b, hkv * n_rep, d)).astype(np.float32)
    positions = np.array([0, PAGE, max_pages * PAGE - 1], np.int32)
    return q, pool_k, pool_v, tables, positions


def t(x):
    return torch.from_numpy(np.array(x))


class TestPagedWrite:
    @pytest.mark.parametrize("mask", [None, [True, False, True]])
    def test_matches_jax_and_writes_in_place(self, mask):
        _, pool, _, tables, _ = make_pool_and_tables(1, seed=1)
        rng = np.random.default_rng(2)
        new = rng.standard_normal((3, 2, 5, 16)).astype(np.float32)
        positions = (np.array([0, 3, 17])[:, None]
                     + np.arange(5)[None, :]).astype(np.int32)
        wm = None if mask is None else np.array(mask)
        out_j = np.asarray(jpa.paged_write_kv(
            jnp.asarray(pool), jnp.asarray(new), jnp.asarray(positions),
            jnp.asarray(tables), PAGE,
            None if wm is None else jnp.asarray(wm)))
        pool_t = t(pool)
        ptr = pool_t.data_ptr()
        out_t = tpa.paged_write_kv(pool_t, t(new), t(positions), t(tables),
                                   PAGE, None if wm is None else t(wm))
        assert out_t is pool_t and pool_t.data_ptr() == ptr
        # byte-equal outside the TRASH page (duplicate writes land there
        # in an order neither framework specifies)
        np.testing.assert_array_equal(out_t.numpy()[1:], out_j[1:])

    def test_layout_token_t_lands_at_its_page_and_offset(self):
        pool = torch.zeros(8, 2, PAGE, 3)
        tables = torch.tensor([[5, 2], [7, 1]], dtype=torch.int32)
        new = torch.arange(2 * 2 * 3 * 3, dtype=torch.float32).view(2, 2, 3, 3)
        positions = torch.tensor([[2, 3, 4], [0, 1, 2]], dtype=torch.int32)
        tpa.paged_write_kv(pool, new, positions, tables, PAGE)
        for b in range(2):
            for s in range(3):
                p = int(positions[b, s])
                page = int(tables[b, p // PAGE])
                assert torch.equal(pool[page, :, p % PAGE], new[b, :, s])

    def test_masked_slot_and_positions_past_the_table_go_to_trash(self):
        pool = torch.zeros(8, 1, PAGE, 2)
        tables = torch.tensor([[5, 2], [7, 1]], dtype=torch.int32)
        new = torch.ones(2, 1, 1, 2)
        # slot 0 is masked off; slot 1 writes past its two pages
        tpa.paged_write_kv(pool, new, torch.tensor([[1], [9]]), tables, PAGE,
                           torch.tensor([False, True]))
        touched = pool.abs().sum(dim=(1, 2, 3)).nonzero().flatten().tolist()
        assert touched == [tpa.TRASH_PAGE]


def test_gather_is_byte_equal_to_jax():
    _, pool, _, tables, _ = make_pool_and_tables(1, seed=3)
    out_j = np.asarray(jpa.paged_gather_kv(jnp.asarray(pool),
                                           jnp.asarray(tables)))
    out_t = tpa.paged_gather_kv(t(pool), t(tables))
    assert out_t.shape == (3, 2, 6 * PAGE, 16)
    np.testing.assert_array_equal(out_t.numpy(), out_j)


@pytest.mark.parametrize("n_rep", [1, 2, 4])
def test_plain_version_matches_pallas_kernel_in_interpret_mode(n_rep):
    q, pk, pv, tables, positions = make_pool_and_tables(n_rep, seed=n_rep)
    out_j = np.asarray(jpa.pallas_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tables), jnp.asarray(positions), interpret=True))
    out_t = tpa.paged_decode_attention_ref(t(q), t(pk), t(pv), t(tables),
                                           t(positions))
    np.testing.assert_allclose(out_t.numpy(), out_j, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n_rep", [1, 2, 4])
def test_plain_version_matches_jax_gather_fallback(n_rep):
    q, pk, pv, tables, positions = make_pool_and_tables(n_rep, seed=10 + n_rep)
    out_j = np.asarray(jpa.paged_attention(
        jnp.asarray(q)[:, :, None], jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tables), jnp.asarray(positions)[:, None],
        page_size=PAGE, seq_limit=22, kernel=False))[:, :, 0]
    out_t = tpa.paged_decode_attention_ref(t(q), t(pk), t(pv), t(tables),
                                           t(positions), seq_limit=22)
    np.testing.assert_allclose(out_t.numpy(), out_j, atol=1e-5, rtol=1e-5)


class TestDispatch:
    def test_cpu_decode_takes_the_gather_path(self):
        q, pk, pv, tables, positions = make_pool_and_tables(2, seed=20)
        before = _build.launch_counts[tpa.KERNEL_NAME]
        out = tpa.paged_attention(t(q)[:, :, None], t(pk), t(pv), t(tables),
                                  t(positions)[:, None], page_size=PAGE)
        ref = tpa.paged_decode_attention_ref(t(q), t(pk), t(pv), t(tables),
                                             t(positions))
        assert torch.equal(out[:, :, 0], ref)
        assert _build.launch_counts[tpa.KERNEL_NAME] == before

    def test_wrapper_on_cpu_is_the_plain_version(self):
        q, pk, pv, tables, positions = make_pool_and_tables(2, seed=21)
        args = (t(q), t(pk), t(pv), t(tables), t(positions))
        assert torch.equal(tpa.paged_decode_attention(*args),
                           tpa.paged_decode_attention_ref(*args))

    def test_kernel_true_on_cpu_raises(self):
        q, pk, pv, tables, positions = make_pool_and_tables(2, seed=22)
        with pytest.raises(ValueError, match="CUDA"):
            tpa.paged_attention(t(q)[:, :, None], t(pk), t(pv), t(tables),
                                t(positions)[:, None], page_size=PAGE,
                                kernel=True)

    def test_prefill_goes_through_gather_and_matches_jax(self):
        rng = np.random.default_rng(23)
        _, pk, pv, tables, _ = make_pool_and_tables(2, seed=23)
        q = rng.standard_normal((3, 4, 5, 16)).astype(np.float32)
        pos = (np.array([0, 4, 10])[:, None] + np.arange(5)).astype(np.int32)
        out_j = np.asarray(jpa.paged_attention(
            jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
            jnp.asarray(tables), jnp.asarray(pos), page_size=PAGE,
            kernel=False))
        out_t = tpa.paged_attention(t(q), t(pk), t(pv), t(tables), t(pos),
                                    page_size=PAGE)
        np.testing.assert_allclose(out_t.numpy(), out_j, atol=1e-5, rtol=1e-5)


class TestKernelInputChecks:
    """The wrapper's checks run before any launch, so they hold on CPU
    tensors too."""

    def args(self, **over):
        q, pk, pv, tables, positions = make_pool_and_tables(2, seed=30,
                                                            d=64)
        a = dict(q=t(q), pool_k=t(pk), pool_v=t(pv), page_tables=t(tables),
                 positions=t(positions))
        a.update(over)
        return a

    def test_valid_inputs_pass(self):
        tpa._check_kernel_inputs(**self.args())

    def test_int32_views_at_any_element_offset_pass(self):
        """The engine hands the kernel rows of one packed int32 upload."""
        a = self.args()
        packed = torch.zeros(1 + 2 * 3, dtype=torch.int32)
        packed[1:4] = a["positions"]
        a["positions"] = packed[1:4]
        assert a["positions"].data_ptr() % 16
        tpa._check_kernel_inputs(**a)

    @pytest.mark.parametrize("case,exc", [
        ("float16", TypeError), ("mixed_dtype", TypeError),
        ("int64_tables", TypeError), ("head_dim", ValueError),
        ("ragged_gqa", ValueError), ("n_rep", ValueError),
        ("noncontiguous", ValueError), ("batch", ValueError),
        ("misaligned_q", ValueError),
    ])
    def test_rejects(self, case, exc):
        a = self.args()
        if case == "float16":
            a = {k: v.half() if v.is_floating_point() else v
                 for k, v in a.items()}
        elif case == "mixed_dtype":
            a["pool_v"] = a["pool_v"].to(torch.bfloat16)
        elif case == "int64_tables":
            a["page_tables"] = a["page_tables"].long()
        elif case == "head_dim":  # 48: between the built 32 and 64
            a["q"], a["pool_k"], a["pool_v"] = (
                a["q"][..., :48].contiguous(),
                a["pool_k"][..., :48].contiguous(),
                a["pool_v"][..., :48].contiguous())
        elif case == "ragged_gqa":
            a["q"] = a["q"][:, :3].contiguous()
        elif case == "n_rep":
            a["q"] = torch.zeros(3, 18, 64)  # 9 per kv head, past the built 8
        elif case == "noncontiguous":
            a["q"] = a["q"].transpose(0, 1).contiguous().transpose(0, 1)
        elif case == "batch":
            a["positions"] = a["positions"][:2]
        elif case == "misaligned_q":
            a["q"] = torch.zeros(a["q"].numel() + 1)[1:].view(a["q"].shape)
        with pytest.raises(exc):
            tpa._check_kernel_inputs(**a)
