"""PyTorch port, kernel build plumbing: the nvcc command targets sm_90a
with a plain C interface, the library name follows the sources and the
flags, every kernel source named is present, a host without nvcc gets a
clear error, and ``chip_smoke.py`` refuses to run without a card."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from scaletorch_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parents[1]


def test_every_kernel_source_exists_and_exports_a_c_entry():
    for name in _build.KERNEL_SOURCES:
        src = (_build.CSRC_DIR / f"{name}.cu").read_text()
        assert 'extern "C"' in src
        assert "cudaGetLastError()" in src


def test_nvcc_command_targets_hopper(monkeypatch):
    monkeypatch.setattr(_build, "find_nvcc", lambda: "/opt/nvcc")
    out = _build.BUILD_DIR / "libx.so"
    cmd = _build.nvcc_command("paged_decode", out)
    assert cmd[0] == "/opt/nvcc"
    joined = " ".join(cmd)
    assert "arch=compute_90a,code=sm_90a" in joined
    for flag in ("-std=c++17", "-O3", "-shared", "-fPIC"):
        assert flag in cmd
    assert cmd[-1].endswith("csrc/paged_decode.cu")
    assert cmd[cmd.index("-o") + 1] == str(out)


def test_library_path_follows_sources_and_flags(monkeypatch):
    first = _build.library_path("paged_decode")
    assert first == _build.library_path("paged_decode")
    assert first.parent == ROOT / "build" / "kernels"
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("paged_decode") != first


def test_missing_nvcc_is_a_clear_error(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("this host has a CUDA toolkit")
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        _build.find_nvcc()


def test_launch_counts_reset():
    _build.launch_counts["probe"] += 2
    _build.reset_launch_counts()
    assert _build.launch_counts["probe"] == 0


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no CUDA device" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "scaletorch_tpu_torch" in out.stderr


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120flash_fwd_mma_kernelILi128EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiiiiifb' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120flash_fwd_mma_kernelILi128EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiiiiifb
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 412 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121flash_fwd_fp32_kernelILi64EEEvPKfS2_S2_PfS3_iiiifb' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121flash_fwd_fp32_kernelILi64EEEvPKfS2_S2_PfS3_iiiifb
    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 404 bytes cmem[0]
"""


def test_ptxas_report_gives_registers_and_spills_per_kernel():
    found = _build.kernel_resources(PTXAS_LOG)
    assert list(found.values()) == [
        {"stack_frame": 0, "spill_stores": 0, "spill_loads": 0,
         "registers": 168},
        {"stack_frame": 8, "spill_stores": 8, "spill_loads": 4,
         "registers": 255}]
    names = _build.short_kernel_names(found)
    assert set(names) == set(found)
    if any(n != m for m, n in names.items()):  # c++filt is on the host
        assert sorted(names.values()) == ["flash_fwd_fp32_kernel<64>",
                                          "flash_fwd_mma_kernel<128>"]


def test_build_resources_reads_each_source_log(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    (tmp_path / "flash_fwd.log").write_text(PTXAS_LOG)
    out = _build.build_resources(["flash_fwd"])
    assert list(out) == ["flash_fwd"]
    assert sorted(r["registers"] for r in out["flash_fwd"].values()) == [
        168, 255]
