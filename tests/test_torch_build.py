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


class FakeEvent:
    def __init__(self, name, corr, on_card, ns=0, annotation=False, at=50):
        self._name, self._corr, self._card = name, corr, on_card
        self._ns, self._annotation, self._at = ns, annotation, at

    def name(self):
        return self._name

    def correlation_id(self):
        return self._corr

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._card
                else torch.autograd.DeviceType.CPU)

    def duration_ns(self):
        return self._ns

    def start_ns(self):
        return self._at

    def end_ns(self):
        return self._at + self._ns

    def is_user_annotation(self):
        return self._annotation


def test_chip_smoke_counts_lost_kernel_records(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke

    def trace(replay_kernels, launched):
        # the window's span covers host times 0..100; each replay: K4
        # then other kernels, 1 µs each; each launch outside a graph: one
        # 2 µs kernel. Before the span: a lead launch that lost its
        # record, and one whose id an operator in the span also has.
        span = chip_smoke.WINDOW_SPAN
        events = [FakeEvent(span, 0, False, 100, at=0),
                  FakeEvent(span, 1, True, 10 ** 9, True, at=0),
                  FakeEvent("aten::mm", 6, False),
                  FakeEvent("cudaLaunchKernel", 5, False, at=-10),
                  FakeEvent("cudaLaunchKernel", 6, False, at=-10),
                  FakeEvent("lead", 6, True, 5000)]
        for corr, n in enumerate(replay_kernels, start=10):
            events.append(FakeEvent("cudaGraphLaunch", corr, False))
            events += [FakeEvent("paged_decode" if i == 0 else f"k{i}",
                                 corr, True, 1000) for i in range(n)]
        for corr, recorded in enumerate(launched, start=100):
            events.append(FakeEvent("cudaLaunchKernel", corr, False))
            if recorded:
                events.append(FakeEvent("gemm", corr, True, 2000))
        return chip_smoke.trace_records(events)

    whole = trace([3, 3, 3], [True, True])
    assert whole["window"] == {
        "us": 13.0, "kernels": 11, "k4_us": 3.0, "k4": 3, "k5": 0,
        "by_name": {"paged_decode": (3, 3000), "k1": (3, 3000),
                    "k2": (3, 3000), "gemm": (2, 4000)}}
    assert (whole["launches_lost"], whole["replay_kernels_lost"],
            whole["whole"], whole["k4_per_whole_replay"]) == (0, 0, 3, [1])
    # a replay that lost two records counts as the mean whole one
    lossy = trace([3, 1, 3], [True, True])
    assert lossy["replay_kernels_lost"] == 2 and lossy["whole"] == 2
    for key in ("us", "kernels", "k4_us", "k4", "k5"):
        assert lossy["window"][key] == whole["window"][key]
    assert lossy["k4_per_partial_replay_max"] == 1
    assert trace([3, 3], [True, False, False])["launches_lost"] == 2
    empty = trace([], [])
    assert empty["window"]["us"] == 0 and empty["whole"] == 0
