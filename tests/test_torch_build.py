"""kernels/build.py without a GPU: one nvcc compile of each source with the
sm_90a target, all started together, and one link into a library cached by
the sources' hash; a build that fails or finds no nvcc raises and leaves no
library (and no object) behind. nvcc is a stand-in script here."""
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


def test_one_nvcc_compile_a_source_then_one_link_cached_by_hash(tmp_path, build_root, monkeypatch):
    """One compile call a source (-c, the sm_90a target), then one link
    call over their objects (-shared); a second build reuses the library."""
    log = tmp_path / "calls.txt"
    # record the arguments, then create the file named after -o
    home = _fake_nvcc(tmp_path, f'echo "$@" >> {log}\nwhile [ "$1" != "-o" ]; do shift; done\ntouch "$2"\n')
    monkeypatch.setenv("CUDA_HOME", str(home))
    out = build.build()
    assert out.exists() and out.parent.parent == build_root
    assert out.parent.name == build.source_hash()
    calls = [line.split() for line in log.read_text().splitlines()]
    compiles = [c for c in calls if "-c" in c]
    links = [c for c in calls if "-shared" in c]
    assert len(calls) == len(build.SOURCES) + 1 and len(links) == 1
    assert all("arch=compute_90a,code=sm_90a" in c for c in calls)
    assert sorted(a for c in compiles for a in c if a.endswith(".cu")) == sorted(
        str(build.CSRC / s) for s in build.SOURCES)
    objects = sorted(c[c.index("-o") + 1] for c in compiles)
    assert sorted(a for a in links[0] if a.endswith(".o")) == objects
    assert not any(p.name.endswith(".o") for p in out.parent.iterdir())  # objects removed
    assert build.build() == out
    assert len(log.read_text().splitlines()) == len(calls)  # second call reuses the library


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


def test_every_source_is_built_and_every_entry_is_bound():
    """The build compiles every .cu file, the hash covers every .cuh header,
    and each C entry point a wrapper calls has its ctypes signature."""
    assert sorted(build.SOURCES) == sorted(p.name for p in build.CSRC.glob("*.cu"))
    # the headers the sources include are part of the library's hash
    assert sorted(build.HEADERS) == sorted(p.name for p in build.CSRC.glob("*.cuh"))
    text = "".join((build.CSRC / s).read_text() for s in build.SOURCES)
    for name in build.SIGNATURES:
        assert f'extern "C" int {name}(' in text, name
    assert set(build.SIGNATURES) == {
        "cbl_win_topk", "cbl_window_gather", "cbl_window_gather_bwd",
        "cbl_stats_fwd", "cbl_stats_bwd", "cbl_pt_attn_fwd", "cbl_pt_attn_bwd",
        "cbl_tile2_fwd", "cbl_tile2_bwd", "cbl_tile_fwd", "cbl_tile_bwd", "cbl_gather_rows",
        "cbl_fps",
    }


def test_every_entry_binds_each_of_its_parameters():
    """Each C entry's ctypes signature has one argtype a parameter of its
    declaration: ctypes passes arguments beyond the argtypes unconverted
    (a pointer cut to an int) instead of refusing them."""
    text = "".join((build.CSRC / s).read_text() for s in build.SOURCES)
    for name, argtypes in build.SIGNATURES.items():
        start = text.index(f'extern "C" int {name}(') + len(f'extern "C" int {name}(')
        params = text[start:text.index(")", start)].split(",")
        assert len(params) == len(argtypes), name


def test_a_header_change_rebuilds(tmp_path, monkeypatch):
    """Editing a header the sources include changes the library's hash."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in build.SOURCES + build.HEADERS:
        (csrc / name).write_bytes((build.CSRC / name).read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build.source_hash()
    (csrc / build.HEADERS[0]).write_text((csrc / build.HEADERS[0]).read_text() + "\n// edited\n")
    assert build.source_hash() != before
