"""kernels/build.py without a GPU: one nvcc call over every source with the
sm_90a target, a library cached by the sources' hash, and a build that
fails or finds no nvcc raises and leaves no library behind. nvcc is a
stand-in script here."""
import os
import stat

import pytest

from contrastboundary_tpu_torch.kernels import build


def _fake_nvcc(tmp_path, body):
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return home


@pytest.fixture
def build_root(tmp_path, monkeypatch):
    root = tmp_path / "_build"
    monkeypatch.setattr(build, "BUILD_ROOT", root)
    return root


def test_one_nvcc_call_over_all_sources_then_cached(tmp_path, build_root, monkeypatch):
    log = tmp_path / "calls.txt"
    # record the arguments, then create the file named after -o
    home = _fake_nvcc(tmp_path, f'echo "$@" >> {log}\nwhile [ "$1" != "-o" ]; do shift; done\ntouch "$2"\n')
    monkeypatch.setenv("CUDA_HOME", str(home))
    out = build.build()
    assert out.exists() and out.parent.parent == build_root
    assert out.parent.name == build.source_hash()
    args = log.read_text().split()
    assert "arch=compute_90a,code=sm_90a" in args and "-shared" in args
    assert [a for a in args if a.endswith(".cu")] == [str(build.CSRC / s) for s in build.SOURCES]
    assert build.build() == out
    assert len(log.read_text().splitlines()) == 1  # second call reuses the library


def test_failed_build_raises_and_leaves_no_library(tmp_path, build_root, monkeypatch):
    home = _fake_nvcc(tmp_path, 'echo "error: no such intrinsic" >&2\nexit 1\n')
    monkeypatch.setenv("CUDA_HOME", str(home))
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        build.build()
    assert not any(p.is_file() for p in build_root.rglob("*"))


def test_missing_nvcc_raises(tmp_path, build_root, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "nowhere"))
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert not build_root.exists()
