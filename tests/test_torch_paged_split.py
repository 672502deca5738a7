"""PyTorch port, the paged-decode kernel's split plan and its plain model.

The CUDA kernel (``csrc/paged_decode.cu``) cuts each slot's keys into
splits of 256 keys and merges their softmax states. Here, on the CPU: the
plan is a function of the shapes alone (so a slot's splits do not depend
on the batch) that covers every key with no empty split;
``paged_decode_split_ref`` (the plain model of the split and merge)
agrees with the Pallas kernel in interpret mode and with the plain
version (fp32, atol/rtol 1e-5) at page sizes that divide a split and
that do not, and at positions on both sides of a split boundary, at the
table's last key and past it; in bf16 at 32768 keys it tells a dropped
page from sound output under the card checks' limit. The kernel itself
is tested on the card by ``test_torch_paged_decode_cuda.py``.
"""

import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jpa = importlib.import_module("scaletorch_tpu.ops.pallas.paged_attention")
tpa = importlib.import_module("scaletorch_tpu_torch.ops.paged_attention")

# the kernel's keys per split (``kKeysPerSplit``; the card tests read it
# from the built library, which this CPU file cannot build)
KPS = 256


def make_inputs(n_rep, d, page, seed, hkv=1, extra_keys=40, positions=None):
    """A table just past one split (``KPS + extra_keys`` keys), shuffled
    pages, and by default the positions 0, KPS - 1, KPS, KPS + 1, the
    table's last key and one past it."""
    rng = np.random.default_rng(seed)
    max_pages = -(-(KPS + extra_keys) // page)
    last = max_pages * page - 1
    if positions is None:
        positions = [0, KPS - 1, KPS, KPS + 1, last, last + 1]
    b = len(positions)
    n_pages = b * max_pages + 2
    pool_k = rng.standard_normal((n_pages, hkv, page, d)).astype(np.float32)
    pool_v = rng.standard_normal((n_pages, hkv, page, d)).astype(np.float32)
    tables = (rng.permutation(n_pages - 2) + 1).astype(np.int32)
    tables = tables[:b * max_pages].reshape(b, max_pages)
    q = rng.standard_normal((b, hkv * n_rep, d)).astype(np.float32)
    return q, pool_k, pool_v, tables, np.array(positions, np.int32)


def t(x):
    return torch.from_numpy(np.array(x))


class TestPlan:
    @pytest.mark.parametrize("max_pages,page,want", [
        (1, 1, 1), (256, 1, 1), (257, 1, 2), (128, 16, 8), (99, 3, 2),
        (2048, 16, 128), (5, 64, 2)])
    def test_splits_come_from_the_shapes(self, max_pages, page, want):
        assert tpa.split_plan(max_pages, page, KPS) == want
        assert tpa.split_plan(max_pages, page, 1) == max_pages * page

    @pytest.mark.parametrize("keys_per_split", [1, 16, 128, 256, 512])
    def test_splits_cover_every_key_and_none_is_empty(self, keys_per_split):
        for max_pages in (1, 2, 7, 99, 128, 2048):
            for page in (1, 3, 4, 16, 64):
                keys = max_pages * page
                splits = tpa.split_plan(max_pages, page, keys_per_split)
                assert (splits - 1) * keys_per_split < keys
                assert keys <= splits * keys_per_split

    def test_a_slots_splits_do_not_depend_on_the_batch(self):
        """The plan reads no batch size and no position, so every slot of
        any batch gets the same splits; only the workspace's batch axis
        grows with B."""
        assert list(inspect.signature(tpa.split_plan).parameters) == [
            "max_pages", "page_size", "keys_per_split"]
        splits = tpa.split_plan(128, 16, KPS)
        for b in (1, 2, 8, 64):
            assert tpa.workspace_shape(b, 16, 128, splits) == (
                splits, b, 16, 130)

    def test_workspace_shape(self):
        assert tpa.workspace_shape(8, 16, 128, 8) == (8, 8, 16, 130)


@pytest.mark.parametrize("page", [1, 3, 4, 16, 64])
@pytest.mark.parametrize("n_rep,d", [(1, 32), (5, 32), (8, 32), (1, 128),
                                     (5, 128), (8, 128)])
def test_split_model_matches_pallas_kernel_and_plain_version(page, n_rep, d):
    q, pk, pv, tables, positions = make_inputs(n_rep, d, page,
                                               seed=100 * page + 10 * n_rep
                                               + d)
    args = (t(q), t(pk), t(pv), t(tables), t(positions))
    split = tpa.paged_decode_split_ref(*args,
                                       keys_per_split=KPS).numpy()
    plain = tpa.paged_decode_attention_ref(*args).numpy()
    pallas = np.asarray(jpa.pallas_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tables), jnp.asarray(positions), interpret=True))
    np.testing.assert_allclose(split, pallas, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(split, plain, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("keys_per_split", [1, 16, 48])
def test_split_model_with_many_splits_matches_plain_version(keys_per_split):
    """Small splits: up to 297 partial states merged per slot."""
    q, pk, pv, tables, positions = make_inputs(4, 32, 3, seed=keys_per_split,
                                               hkv=2)
    args = (t(q), t(pk), t(pv), t(tables), t(positions))
    split = tpa.paged_decode_split_ref(*args, keys_per_split=keys_per_split)
    plain = tpa.paged_decode_attention_ref(*args)
    np.testing.assert_allclose(split.numpy(), plain.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_split_model_rounds_p_to_the_cache_dtype():
    """bf16: the model rounds p before P V as the kernel does; it agrees
    with the plain version within the card tests' bf16 limit."""
    q, pk, pv, tables, positions = make_inputs(2, 64, 16, seed=7, hkv=2)
    args = (t(q).bfloat16(), t(pk).bfloat16(), t(pv).bfloat16(),
            t(tables), t(positions))
    split = tpa.paged_decode_split_ref(*args, keys_per_split=KPS)
    plain = tpa.paged_decode_attention_ref(*args)
    assert split.dtype == torch.bfloat16
    assert float((split.float() - plain.float()).abs().max()) <= 2e-2


def test_split_model_sees_a_dropped_page_at_32768_keys():
    """One slot of 32768 keys at Qwen3-0.6B's heads in bf16: the model
    against the plain version reads a worst-slot relative error under the
    card checks' 1e-2 limit for that row, and against the plain version
    without the slot's middle page (one of 2048) over it. Prints both."""
    gen = torch.Generator().manual_seed(0)
    page, pages = 16, 2048
    pk = torch.randn(pages + 1, 8, page, 128, generator=gen).bfloat16()
    pv = torch.randn(pages + 1, 8, page, 128, generator=gen).bfloat16()
    q = torch.randn(1, 16, 128, generator=gen).bfloat16()
    tables = (torch.randperm(pages, generator=gen) + 1).to(torch.int32)
    tables = tables.view(1, pages)
    positions = torch.tensor([pages * page - 1], dtype=torch.int32)
    split = tpa.paged_decode_split_ref(q, pk, pv, tables, positions,
                                       keys_per_split=KPS)
    dropped = tables.clone()
    dropped[0, pages // 2:-1] = tables[0, pages // 2 + 1:]

    def slot_rel(ref):
        diff = (split.float() - ref.float()).flatten(1).norm(dim=1)
        return float((diff / ref.float().flatten(1).norm(dim=1)).max())

    sound = slot_rel(tpa.paged_decode_attention_ref(q, pk, pv, tables,
                                                    positions))
    control = slot_rel(tpa.paged_decode_attention_ref(q, pk, pv, dropped,
                                                      positions - page))
    print(f"worst slot: sound {sound:.4g}, one page dropped {control:.4g}")
    assert sound < 1e-2 < control
