"""The kernels' build cache and the int8 / int4 step wrapper's shape checks
and constants, on the CPU (no ``nvcc`` needed): a library is named by a
hash of its source and of every shared header, so an edit of
``csrc/sync.cuh`` or ``csrc/w8a16.cuh`` rebuilds each source that may
include it, and an edit of one source rebuilds that source alone.
"""

import os
import re
import shutil

import pytest
import torch

from csm_tpu_torch import CSMConfig
from csm_tpu_torch.ops import _build, bb_kernel

SOURCES = ("bb_decode_q", "fused_decoder", "flash_fwd")


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, dst)
    monkeypatch.setattr(_build, "CSRC", str(dst))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    return dst


@pytest.mark.parametrize("header", ["sync.cuh", "w8a16.cuh", "hopper.cuh"])
def test_a_header_edit_renames_every_library(csrc_copy, header):
    before = {n: _build._target(n) for n in SOURCES}
    with open(os.path.join(csrc_copy, header), "a") as f:
        f.write("\n// edited\n")
    after = {n: _build._target(n) for n in SOURCES}
    assert all(before[n] != after[n] for n in SOURCES)


def test_a_source_edit_renames_its_library_alone(csrc_copy):
    before = {n: _build._target(n) for n in SOURCES}
    with open(os.path.join(csrc_copy, "bb_decode_q.cu"), "a") as f:
        f.write("\n// edited\n")
    after = {n: _build._target(n) for n in SOURCES}
    assert [n for n in SOURCES if before[n] != after[n]] == ["bb_decode_q"]


@pytest.mark.parametrize("python,c", [
    ("TRACE_SLOTS", r"constexpr int TRACE_SLOTS = (\d+);"),
    ("_REFUSED", r"REFUSED_SHAPES = (\d+),"),
])
def test_the_wrapper_constants_match_the_kernel_source(python, c):
    """The item trace's int64 per item and the first refusal code are read
    the same by the wrapper and by csrc/bb_decode_q.cu."""
    with open(os.path.join(_build.CSRC, "bb_decode_q.cu")) as f:
        found = re.findall(c, f.read())
    assert found == [str(getattr(bb_kernel, python))]


@pytest.mark.parametrize("kw,match", [
    (dict(B=33), "outside"),
    (dict(nq=32, nkv=3), "GQA"),
    (dict(hd=48), "head_dim"),
    (dict(n_head=2051), "multiples of 128"),
    (dict(int4=True, D=2176), "multiples of 256"),
])
def test_q_shape_checks_name_the_limit(kw, match):
    args = dict(int4=False, B=1, D=2048, Fi=8192, nq=32, nkv=8, hd=64, n_head=2176)
    bb_kernel._check_q_shapes("bb_decode_step_q", **args)  # CSM-1B is taken
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        bb_kernel._check_q_shapes("bb_decode_step_q", **args)


def test_stage_trace_needs_the_kernel():
    cfg = CSMConfig.tiny()
    with pytest.raises(ValueError, match="stage_ns"):
        bb_kernel.bb_decode_step_q({"w": {}, "s": {}}, cfg, torch.zeros((1, 8)), None, None, None,
                                   None, None, stage_ns=torch.zeros((4,), dtype=torch.int64))
