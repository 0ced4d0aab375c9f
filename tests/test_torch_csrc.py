"""The kernel build and launch plumbing (smartbft_tpu_torch/csrc): ptxas
report parsing, a loud failure without nvcc, launch counters and the
launch-error check.  No card needed."""

import threading

import pytest

from smartbft_tpu_torch import csrc

PTXAS = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z18comb_verify_kernel' for 'sm_90a'
ptxas info    : Function properties for _Z18comb_verify_kernel
    512 bytes stack frame, 8 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 180 registers, used 0 barriers, 512 bytes cumulative stack size
"""


def test_parse_ptxas_report():
    assert csrc.parse_ptxas(PTXAS) == {
        "stack_bytes": 512, "spill_store_bytes": 8, "spill_load_bytes": 16,
        "registers": 180}


def test_parse_ptxas_reads_static_shared_memory():
    line = ("ptxas info    : Used 168 registers, used 1 barriers, 22912 bytes "
            "smem, 400 bytes cmem[0]\n")
    assert csrc.parse_ptxas(PTXAS + line) == {
        "stack_bytes": 512, "spill_store_bytes": 8, "spill_load_bytes": 16,
        "registers": 168, "shared_bytes": 22912}


def test_parse_ptxas_keeps_the_kernel_frame_and_sums_callee_spills():
    """A kernel that calls device functions: ptxas reports the kernel's
    frame before its register line and each callee's after it; the
    kernel's frame stays, the callees' spills are summed apart."""
    log = PTXAS + (
        "ptxas info    : Function properties for _ZN4b3816fp_mulE\n"
        "    0 bytes stack frame, 136 bytes spill stores, 136 bytes spill "
        "loads\n"
        "ptxas info    : Function properties for _ZN4b3818fp12_mulE\n"
        "    0 bytes stack frame, 756 bytes spill stores, 932 bytes spill "
        "loads\n")
    assert csrc.parse_ptxas(log) == {
        "stack_bytes": 512, "spill_store_bytes": 8, "spill_load_bytes": 16,
        "registers": 180, "callee_spill_store_bytes": 892,
        "callee_spill_load_bytes": 1068}


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(csrc.os.path, "isfile",
                        lambda p: False if p.endswith("nvcc") else True)
    with pytest.raises(csrc.KernelBuildError, match="nvcc not found"):
        csrc.build(force=True)


def test_sources_and_flags_target_hopper():
    assert set(csrc.SOURCES) == {"cuda_comb", "cuda_ecdsa", "cuda_ed25519",
                                 "cuda_eddsa", "cuda_bls"}
    assert "ed25519_comb_group.cuh" in csrc.HEADERS
    assert {"bls381_field.cuh", "bls381_group.cuh",
            "bls381_pairing.cuh"} <= set(csrc.HEADERS)
    assert "arch=compute_90a,code=sm_90a" in csrc.NVCC_FLAGS
    # every header is a build dependency, and every header a source
    # includes is listed
    root = csrc._DIR
    for name in list(csrc.SOURCES.values()) + list(csrc.HEADERS):
        with open(f"{root}/{name}") as f:
            for line in f:
                if line.startswith('#include "'):
                    assert line.split('"')[1] in csrc.HEADERS, (name, line)


def test_a_variant_builds_its_source_with_its_define(monkeypatch, tmp_path):
    """A variant (the generic kernel at another group size) is its
    source compiled with one more -D flag, into a library of its own."""
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        f'echo "$@" > "{tmp_path}/args"\n'
        'while [ "$1" != "-o" ]; do shift; done\n'
        'touch "$2"\n'
        'echo "ptxas info    : Used 96 registers"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(csrc, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(csrc, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(csrc, "build_report", {})
    report = csrc.build(names=["cuda_ecdsa_g4"], force=True)
    args = (tmp_path / "args").read_text().split()
    assert "-DECDSA_GROUP=4" in args
    assert args[-1].endswith("cuda_ecdsa.cu")
    assert report["cuda_ecdsa_g4"]["registers"] == 96
    assert (tmp_path / "build" / "libcuda_ecdsa_g4.so").exists()
    assert set(csrc.VARIANTS) == {"cuda_comb_g4", "cuda_ecdsa_g4",
                                  "cuda_ed25519_g2", "cuda_eddsa_g2",
                                  "cuda_bls_g6", "cuda_bls_miller"}
    csrc.build(names=["cuda_ed25519_g2"], force=True)
    args = (tmp_path / "args").read_text().split()
    assert "-DED_COMB_GROUP=2" in args and args[-1].endswith("cuda_ed25519.cu")
    csrc.build(names=["cuda_eddsa_g2"], force=True)
    args = (tmp_path / "args").read_text().split()
    assert "-DEDDSA_GROUP=2" in args and args[-1].endswith("cuda_eddsa.cu")
    csrc.build(names=["cuda_comb_g4"], force=True)
    args = (tmp_path / "args").read_text().split()
    assert "-DCOMB_GROUP=4" in args and args[-1].endswith("cuda_comb.cu")
    csrc.build(names=["cuda_bls_g6"], force=True)
    args = (tmp_path / "args").read_text().split()
    assert "-DBLS_GROUP=6" in args and args[-1].endswith("cuda_bls.cu")
    csrc.build(names=["cuda_bls_miller"], force=True)
    args = (tmp_path / "args").read_text().split()
    assert "-DBLS_MILLER_ONLY=1" in args and args[-1].endswith("cuda_bls.cu")


def test_launch_counter_is_thread_safe():
    c = csrc.LaunchCounter("k")

    def work():
        for _ in range(1000):
            c.add(3)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert (c.launches, c.lanes) == (4000, 12000)
    c.reset()
    assert (c.launches, c.lanes) == (0, 0)


def test_launch_error_raises():
    csrc.check(0, "ok")
    with pytest.raises(RuntimeError, match="cudaError 9"):
        csrc.check(9, "comb_verify")
