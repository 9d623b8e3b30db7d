"""The port's kernel build cache: a library is named by a digest of its
CUDA source and of every shared header in ``csrc/``, so editing a header
rebuilds every source and editing one source rebuilds only that one. Runs
on the CPU (no nvcc needed: only the library paths are computed)."""

import shutil

import pytest

pytest.importorskip("torch")

from elastic_tpu_agent_torch import kernels  # noqa: E402


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, copy)
    monkeypatch.setattr(kernels, "CSRC", copy)
    return copy


def _paths(csrc):
    return {src.name: kernels._library_path(src)
            for src in sorted(kernels.CSRC.glob("*.cu"))}


def test_library_paths_follow_sources_and_headers(csrc):
    before = _paths(csrc)
    assert len(before) >= 3 and list(csrc.glob("*.cuh"))
    assert before == _paths(csrc)          # deterministic

    header = csrc / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after_header = _paths(csrc)
    assert all(after_header[n] != before[n] for n in before)

    src = csrc / "flash_bwd.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after_src = _paths(csrc)
    changed = {n for n in before if after_src[n] != after_header[n]}
    assert changed == {"flash_bwd.cu"}


def test_a_new_header_changes_every_library_path(csrc):
    before = _paths(csrc)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    after = _paths(csrc)
    assert all(after[n] != before[n] for n in before)
