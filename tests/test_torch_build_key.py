"""The kernels' build key and the weight gradients' row chunks, on the CPU.

A library's name hashes its ``.cu`` source, every shared ``csrc/*.cuh`` header
and the nvcc flags (``kernels/build.py``): an edited header must not load a
stale build. ``wgrad_chunk`` sets the row chunks of the vector-attention weight
gradients: a multiple of the tensor-core core's stage, at least 256 rows, at
most WGRAD_CHUNKS chunks.
"""

import pytest

from simple3dformer_tpu_torch.kernels import build
from simple3dformer_tpu_torch.kernels import vector_attention as va


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A source tree of two kernels and a shared header, built into tmp_path."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "one.cu").write_text('#include "shared.cuh"\n__global__ void one() {}\n')
    (src / "two.cu").write_text("__global__ void two() {}\n")
    (src / "shared.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    return src


def test_an_unchanged_tree_keeps_its_library(csrc):
    first = build.library_path("one")
    assert build.library_path("one") == first
    assert first.parent == build.BUILD_DIR and first.name.startswith("libone-")
    assert build.library_path("two") != first
    assert not build.BUILD_DIR.exists()  # naming a library builds nothing


@pytest.mark.parametrize("edit", ["header", "new header", "source"])
def test_an_edit_renames_the_library(csrc, edit):
    before = {name: build.library_path(name) for name in ("one", "two")}
    if edit == "header":
        (csrc / "shared.cuh").write_text("#pragma once\n// changed\n")
    elif edit == "new header":
        (csrc / "other.cuh").write_text("#pragma once\n")
    else:
        (csrc / "one.cu").write_text('#include "shared.cuh"\n__global__ void one(int) {}\n')
    after = {name: build.library_path(name) for name in ("one", "two")}
    assert after["one"] != before["one"]
    # a header may be included by any source: every library's key takes it
    assert (after["two"] != before["two"]) == (edit != "source")


def test_header_names_are_part_of_the_key(csrc):
    before = build.library_path("one")
    (csrc / "shared.cuh").rename(csrc / "renamed.cuh")
    assert build.library_path("one") != before


@pytest.mark.parametrize("rows", [1, 255, 256, 4096, 16320, 16 * 4 * 4, 64 * 4 * 4,
                                  64 * 16 * 16, 64 * 64 * 16, 64 * 256 * 16, 64 * 1024 * 16,
                                  64 * 1024 * 16 + 7, 2 ** 31 - 1])
def test_wgrad_chunk_rule(rows):
    chunk = va.wgrad_chunk(rows)
    assert chunk % va.WGRAD_STEP == 0 and chunk >= 256
    assert -(-rows // chunk) <= va.WGRAD_CHUNKS
    # the smallest such chunk: one step less would need more chunks or go under 256
    assert chunk == 256 or -(-rows // (chunk - va.WGRAD_STEP)) > va.WGRAD_CHUNKS
