"""The kernels' build cache (``repro_torch/kernels/build.py``) on the CPU:
a library's name covers its source and every header the source includes,
so an edited header never loads a stale library. Nothing is compiled."""
import shutil

import pytest

from repro_torch.kernels import build

HEADER = "common/hopper.cuh"
ATTENTION_HEADER = "flash_attention/csrc/attention_tc.cuh"


@pytest.fixture
def kernels_copy(tmp_path, monkeypatch):
    """A copy of the kernel sources, which build.py reads in its place."""
    root = tmp_path / "kernels"
    shutil.copytree(build._PKG, root,
                    ignore=shutil.ignore_patterns("*.py", "__pycache__"))
    monkeypatch.setattr(build, "_PKG", root)
    return root


def test_tensor_core_kernels_include_the_shared_header():
    for name in ("flash_attention", "flash_attention_bwd", "moe_gmm"):
        files = build._included(build._PKG / build.SOURCES[name])
        assert (build._PKG / HEADER).resolve() in files, name
    for name in ("rmsnorm", "ssd_scan", "wkv6"):
        assert len(build._included(build._PKG / build.SOURCES[name])) == 1


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_bwd",
                                  "moe_gmm"])
def test_library_name_changes_with_the_header(kernels_copy, name):
    before = {n: build._target(n)[1].name for n in build.SOURCES}
    header = kernels_copy / HEADER
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: build._target(n)[1].name for n in build.SOURCES}
    assert after[name] != before[name]
    for other in ("rmsnorm", "ssd_scan", "wkv6"):   # no include: unchanged
        assert after[other] == before[other]


def test_library_name_changes_with_the_source(kernels_copy):
    before = build._target("moe_gmm")[1].name
    src = kernels_copy / build.SOURCES["moe_gmm"]
    src.write_bytes(src.read_bytes() + b"\n")
    assert build._target("moe_gmm")[1].name != before


def test_flash_libraries_change_with_their_tile_header(kernels_copy):
    """The forward and the backward share attention_tc.cuh, which includes
    hopper.cuh: an edit to it renames both flash libraries and no other."""
    before = {n: build._target(n)[1].name for n in build.SOURCES}
    header = kernels_copy / ATTENTION_HEADER
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: build._target(n)[1].name for n in build.SOURCES}
    changed = {n for n in build.SOURCES if after[n] != before[n]}
    assert changed == {"flash_attention", "flash_attention_bwd"}
