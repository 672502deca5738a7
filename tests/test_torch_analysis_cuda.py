"""PyTorch port, the analyzer's memory tier and K4 at head_dim 16 on the
card.

The memory tier over the seven audit entries on the card (the mesh
entries under the ``fake`` process group) exits 0 against the
checked-in ``scaletorch_tpu_torch/hbm_budget.json``, whose rows were
measured there, and its ``slices`` rows (the two disaggregated slice
programs at the served width) measure the same again; the inference
entries' paged decode launches K4 once a layer. K4 at the audit entries' head_dim 16 (every n_rep of 1-8, fp32
and bf16) against its plain version at K4's limits (2e-5 fp32, 2e-2
bf16). Every test needs a CUDA card and skips without one (decided in a
fixture). The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_analysis_cuda.py
"""

import importlib

import pytest
import torch

from scaletorch_tpu_torch.analysis import entry_audit as ea
from scaletorch_tpu_torch.analysis import memory as tmemory
from scaletorch_tpu_torch.analysis.__main__ import main as tmain
from scaletorch_tpu_torch.inference import decode as tdecode
from scaletorch_tpu_torch.ops import _build

tpa = importlib.import_module("scaletorch_tpu_torch.ops.paged_attention")

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the memory tier measures the card's "
                    "allocator and K4 is CUDA C++ with no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_memory_tier_is_clean_against_the_card_budget(cuda, capsys):
    assert tmain(["scaletorch_tpu_torch/analysis/core.py", "--tier",
                  "memory"]) == 0, capsys.readouterr()


def test_slice_rows_match_the_card_budget(cuda):
    """The slice rows plan_slice_split reads, measured again at the
    served width, agree with the checked-in ones within the budget's
    tolerance."""
    doc = tmemory.load_hbm_budget(tmemory.DEFAULT_HBM_BUDGET)
    tol = doc["tolerance_pct"] / 100
    rows = tmemory.measure_slice_rows("cuda")
    assert set(rows) == set(doc["slices"])
    for name, row in rows.items():
        want = doc["slices"][name]
        assert row["source"] == want["source"] == "cuda"
        assert abs(row["peak_mb"] - want["peak_mb"]) <= tol * want["peak_mb"]


def test_paged_decode_entry_launches_k4_once_a_layer(cuda):
    run, findings = ea.run_entry(tdecode.audit_entry_paged_decode(), "cuda")
    assert run is not None, [f.render() for f in findings]
    assert run.memory.source == "cuda"
    assert run.launches == {tpa.KERNEL_NAME: 2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("n_rep", [1, 2, 3, 4, 5, 6, 7, 8])
def test_k4_at_head_dim_16(cuda, dtype, n_rep):
    gen = torch.Generator(device=cuda).manual_seed(16 + n_rep)
    b, hkv, page, pages = 2, 2, 8, 4
    pool_k = torch.randn(b * pages + 1, hkv, page, 16, generator=gen,
                         device=cuda).to(dtype)
    pool_v = torch.randn(pool_k.shape, generator=gen,
                         device=cuda).to(dtype)
    q = torch.randn(b, hkv * n_rep, 16, generator=gen,
                    device=cuda).to(dtype)
    tables = (torch.arange(b * pages, dtype=torch.int32, device=cuda)
              + 1).view(b, pages)
    positions = torch.tensor([13, 31], dtype=torch.int32, device=cuda)
    before = _build.launch_counts[tpa.KERNEL_NAME]
    out = tpa.paged_decode_attention(q, pool_k, pool_v, tables, positions)
    ref = tpa.paged_decode_attention_ref(q, pool_k, pool_v, tables,
                                         positions)
    torch.cuda.synchronize()
    assert _build.launch_counts[tpa.KERNEL_NAME] == before + 1
    assert float((out.float() - ref.float()).abs().max()) <= TOL[dtype]
