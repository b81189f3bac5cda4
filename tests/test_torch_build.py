"""The kernels' build cache and the backbone step's and the fused codebook
loop's wrappers' shape checks and constants, on the CPU (no ``nvcc``
needed): a library is named by a
hash of its source and of every shared header, so an edit of a header
(``csrc/bb_step.cuh``, ``csrc/sync.cuh``, ...) rebuilds each source that may
include it, and an edit of one source rebuilds that source alone.
"""

import os
import re
import shutil

import pytest
import torch

from csm_tpu_torch import CSMConfig
from csm_tpu_torch.ops import _build, bb_kernel
from csm_tpu_torch.ops import fused_decoder as fd

SOURCES = ("bb_decode", "bb_decode_q", "fused_decoder", "flash_fwd")


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, dst)
    monkeypatch.setattr(_build, "CSRC", str(dst))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    return dst


@pytest.mark.parametrize("header", ["sync.cuh", "w8a16.cuh", "hopper.cuh", "bb_step.cuh"])
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


def _with_headers(source: str) -> str:
    """A source's text and that of the repository headers it includes."""
    with open(os.path.join(_build.CSRC, source)) as f:
        text = f.read()
    for header in re.findall(r'#include "(\w+\.cuh)"', text):
        text += _with_headers(header)
    return text


@pytest.mark.parametrize("source", ["bb_decode.cu", "bb_decode_q.cu"])
@pytest.mark.parametrize("python,c", [
    ("TRACE_SLOTS", r"constexpr int TRACE_SLOTS = (\d+);"),
    ("_REFUSED", r"REFUSED_SHAPES = (\d+),"),
])
def test_the_wrapper_constants_match_the_kernel_source(python, c, source):
    """The item trace's int64 per item and the first refusal code are read
    the same by the wrapper and by each backbone step's source (through the
    header it includes)."""
    found = re.findall(c, _with_headers(source))
    assert found == [str(getattr(bb_kernel, python))]


@pytest.mark.parametrize("kw,match", [
    (dict(B=33), "outside"),
    (dict(nq=32, nkv=3), "GQA"),
    (dict(hd=48), "head_dim"),
    (dict(n_head=2051), "multiples of 128"),
    (dict(bits=4, D=2176), "multiples of 256"),
])
def test_q_shape_checks_name_the_limit(kw, match):
    args = dict(bits=8, B=1, D=2048, Fi=8192, nq=32, nkv=8, hd=64, n_head=2176)
    bb_kernel._check_shapes("bb_decode_step_q", **args)  # CSM-1B is taken
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        bb_kernel._check_shapes("bb_decode_step_q", **args)


@pytest.mark.parametrize("kw,match", [
    (dict(B=9), "unsupported B=9, outside 1..8"),
    (dict(B=0), "outside 1..8"),
    (dict(nq=32, nkv=3), "GQA"),
    (dict(nq=36, nkv=4), "at most 8"),
    (dict(hd=48), "head_dim"),
    (dict(n_head=2051), "multiples of 128"),
    (dict(Fi=8224), "of 64"),
    (dict(nq=5, nkv=5, hd=16), "multiples of 64"),
    (dict(B=8, D=16512), "tile sums of squares"),
])
def test_exact_shape_checks_name_the_limit(kw, match):
    """The exact tier's limits: B <= 8 (one 8-column operand), whole bf16
    chunks of 64 K rows.  CSM-1B and the small GPU-test config are taken."""
    bb_kernel._check_shapes("bb_decode_step", 16, B=8, D=256, Fi=512, nq=4, nkv=2, hd=64,
                            n_head=256)
    args = dict(B=1, D=2048, Fi=8192, nq=32, nkv=8, hd=64, n_head=2176)
    bb_kernel._check_shapes("bb_decode_step", 16, **args)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        bb_kernel._check_shapes("bb_decode_step", 16, **args)


@pytest.mark.parametrize("wrapper,bundle", [("bb_decode_step_q", {"w": {}, "s": {}}),
                                            ("bb_decode_step", {})])
def test_stage_trace_needs_the_kernel(wrapper, bundle):
    """The int8 and the exact wrapper: a trace asked for on the CPU raises."""
    cfg = CSMConfig.tiny()
    with pytest.raises(ValueError, match="stage_ns"):
        getattr(bb_kernel, wrapper)(bundle, cfg, torch.zeros((1, 8)), None, None, None, None,
                                    None, stage_ns=torch.zeros((4,), dtype=torch.int64))


@pytest.mark.parametrize("python,c", [
    ("TRACE_SLOTS", r"constexpr int TRACE_SLOTS = (\d+);"),
    ("_REFUSED", r"REFUSED_SHAPES = (\d+),"),
    ("PASS_EXTRA", r"constexpr int PASS_EXTRA = (\d+);"),
    ("SYNC_OUT", r"constexpr int SYNC_OUT = (\d+);"),
    ("MAX_CHUNKED_B", r"constexpr int B_MAX = (\d+);"),
    ("DRAW_VPT", r"constexpr int DRAW_VPT = (\d+);"),
])
def test_the_fused_wrapper_constants_match_the_kernel_source(python, c):
    """The item trace's int64 per item, the first refusal code, a pass's
    stages besides its layers', the counters' first word, the batch limit and
    the draw's logits a thread are read the same by the fused loop's wrapper
    and by its source (through the headers it includes)."""
    found = re.findall(c, _with_headers("fused_decoder.cu"))
    assert found == [str(getattr(fd, python))]


def test_the_fused_stage_count_matches_the_kernel_source():
    """``stage_count`` is the kernel's ``fd_stage_count`` plus block 0's start."""
    text = _with_headers("fused_decoder.cu")
    assert "return 1 + N * (5 * L + PASS_EXTRA);" in text
    assert fd.stage_count(32, 4) == 2 + 32 * (5 * 4 + fd.PASS_EXTRA)


_FD_CSM = dict(B=1, N=32, D=1024, Fi=8192, nq=8, nkv=2, hd=128, Va_pad=2176, head_kind=0)


@pytest.mark.parametrize("kw,match", [
    (dict(B=33), "unsupported B=33, outside 1..32"),
    (dict(B=0), "outside 1..32"),
    (dict(N=65), "outside 2..64"),
    (dict(nq=8, nkv=3), "GQA"),
    (dict(nq=36, nkv=4), "at most 8"),
    (dict(hd=48), "head_dim"),
    (dict(Va_pad=2051), "multiples of 128"),
    (dict(D=1088), "multiples of 128"),
    (dict(Fi=8256), "multiples of 128"),
    (dict(Va_pad=4224), "more than 4096"),
    (dict(nq=3, nkv=3, hd=32), "whole weight chunks"),
    (dict(head_kind=None), "bf16, int8 or f32"),
])
def test_fused_shape_checks_name_the_limit(kw, match):
    """The fused loop's limits: B <= 32 (four 8-row blocks an operand), at most
    64 positions, GQA groups of at most 8, heads that tile 128 columns, whole
    128-column tiles and int8 chunks.  CSM-1B's decoder and the small GPU-test
    config are taken."""
    fd._check_shapes(**_FD_CSM)
    fd._check_shapes(B=32, N=32, D=128, Fi=256, nq=2, nkv=1, hd=64, Va_pad=128, head_kind=2)
    args = dict(_FD_CSM)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        fd._check_shapes(**args)


@pytest.mark.parametrize("trace", ["stage_ns", "item_ns"])
def test_fused_trace_needs_the_kernel(trace):
    """A stage or item trace asked of the fused loop on the CPU raises: the
    plain version has no trace."""
    cfg = CSMConfig.tiny()
    with pytest.raises(ValueError, match="stage_ns and item_ns need the kernel"):
        fd.fused_decode_codebooks({}, cfg, torch.zeros((1, 8)), None, None, None, None, False,
                                  **{trace: torch.zeros((4,), dtype=torch.int64)})
