"""The kernels' build keys: a library is named by the hash of its source,
of every shared header under ``csrc/`` and of the compiler flags, so that
an edit to any of them builds anew. No compiler is needed: the paths are
computed, nothing is built."""

import shutil

import pytest

from fleetx_tpu_torch.ops import _build

SOURCES = ("decode_attention", "flash_attention", "ce_loss")


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A temporary copy of ``csrc`` that ``_build`` reads in place of the
    package's own."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


@pytest.mark.parametrize("name", SOURCES)
def test_editing_a_shared_header_changes_every_library_path(csrc_copy, name):
    before = _build._lib_path(name)
    assert before == _build._lib_path(name)  # unchanged sources: reused
    header = csrc_copy / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build._lib_path(name) != before


def test_editing_a_source_changes_only_its_own_library_path(csrc_copy):
    before = {name: _build._lib_path(name) for name in SOURCES}
    src = csrc_copy / "flash_attention.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = {name: _build._lib_path(name) for name in SOURCES}
    assert after["flash_attention"] != before["flash_attention"]
    assert {n: after[n] for n in ("decode_attention", "ce_loss")} == {
        n: before[n] for n in ("decode_attention", "ce_loss")}


def test_a_new_header_changes_the_library_paths(csrc_copy):
    before = _build._lib_path("ce_loss")
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    assert _build._lib_path("ce_loss") != before


def test_the_tma_kernels_share_the_hopper_header_and_b8_has_no_source():
    """ce_loss.cu and flash_attention.cu take their TMA, mbarrier and
    wgmma helpers from ``hopper.cuh``; B8 runs in the decode template, so
    ``paged_decode.cu`` is gone."""
    for name in ("ce_loss", "flash_attention"):
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "hopper.cuh"' in text, name
        assert "cuTensorMapEncodeTiled\", &ptr" not in text, name
    assert sorted(p.name for p in _build.CSRC.glob("*.cu")) == sorted(
        f"{name}.cu" for name in SOURCES)
