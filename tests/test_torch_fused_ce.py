"""PyTorch port, the chunked fused LM head + cross entropy
(``parallel/tensor_parallel.py`` with ``axis=None``) against the JAX
package's ``fused_vocab_parallel_cross_entropy(axis=None)``: the loss and
its gradients with respect to the hidden states and the head weight, on
the same numpy inputs, with several chunks, a ragged tail chunk and
ignored targets.

Tolerances: fp32 atol/rtol 1e-5 (the chunk sums run in another order);
bf16 hidden states and head atol/rtol 2e-2 (the bf16 logits round at
one ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaletorch_tpu.models import layers as jlayers
from scaletorch_tpu.parallel import tensor_parallel as jtp
from scaletorch_tpu_torch.parallel import tensor_parallel as ttp

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, S, H, V = 2, 10, 24, 53


def inputs(seed, ignored):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((B, S, H)).astype(np.float32)
    head = (0.3 * rng.standard_normal((H, V))).astype(np.float32)
    targets = rng.integers(0, V, (B, S)).astype(np.int32)
    targets.reshape(-1)[rng.permutation(B * S)[:ignored]] = -100
    return hidden, head, targets


def assert_close(t, j, dtype):
    np.testing.assert_allclose(
        t.detach().float().numpy(), np.asarray(j, np.float32),
        atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("chunk", [4, 5, 10, 1024],
                         ids=["ragged_tail", "even", "one", "default"])
@pytest.mark.parametrize("ignored", [0, 6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ce_value_and_grads(dtype, ignored, chunk):
    jdt, tdt = DTYPES[dtype]
    hidden, head, targets = inputs(chunk + ignored, ignored)
    loss_j, vjp = jax.vjp(
        lambda h, w: jtp.fused_vocab_parallel_cross_entropy(
            h, w, jnp.asarray(targets), axis=None, chunk_size=chunk),
        jnp.asarray(hidden, jdt), jnp.asarray(head, jdt))
    dh_j, dw_j = vjp(jnp.float32(1.0))
    ht = torch.from_numpy(hidden).to(tdt).requires_grad_()
    wt = torch.from_numpy(head).to(tdt).requires_grad_()
    loss_t = ttp.fused_vocab_parallel_cross_entropy(
        ht, wt, torch.from_numpy(targets), axis=None, chunk_size=chunk)
    loss_t.backward()
    assert loss_t.dtype == torch.float32 and loss_t.ndim == 0
    assert_close(loss_t, loss_j, dtype)
    assert_close(ht.grad, dh_j, dtype)
    assert_close(wt.grad, dw_j, dtype)


def test_chunks_are_recomputed_not_stored():
    """With several chunks, autograd keeps no [.., V] logits: what the
    forward saves is the hidden chunks, the head and the targets."""
    hidden, head, targets = inputs(0, 0)
    ht = torch.from_numpy(hidden).requires_grad_()
    wt = torch.from_numpy(head).requires_grad_()
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        ttp.fused_vocab_parallel_cross_entropy(
            ht, wt, torch.from_numpy(targets), chunk_size=4)
    assert shapes and all(V not in s for s in shapes if s != (H, V))


@pytest.mark.parametrize("ignored", [0, 6, B * S], ids=lambda n: f"ign{n}")
def test_vocab_parallel_cross_entropy_matches(ignored):
    hidden, head, targets = inputs(7, ignored)
    logits = hidden @ head
    want = jtp.vocab_parallel_cross_entropy(
        jnp.asarray(logits), jnp.asarray(targets), axis=None)
    got = ttp.vocab_parallel_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(targets))
    assert_close(got, want, "float32")
    # and the plain token-mean cross entropy is the same function
    assert_close(got, jlayers.cross_entropy_loss(jnp.asarray(logits),
                                                 jnp.asarray(targets)),
                 "float32")


def test_tensor_parallel_axis_is_refused():
    # a tp axis needs a mesh (the tp arms: tests/test_torch_tensor_parallel.py);
    # none is installed here, whatever an earlier test in this process (a
    # Trainer) left behind
    from scaletorch_tpu_torch.parallel.mesh import using_mesh_manager

    hidden, head, targets = inputs(0, 0)
    with using_mesh_manager(None), pytest.raises(
            RuntimeError, match="axis='tp' needs a mesh"):
        ttp.fused_vocab_parallel_cross_entropy(
            torch.from_numpy(hidden), torch.from_numpy(head),
            torch.from_numpy(targets), axis="tp")
