"""Every ``extern "C"`` function of the port's CUDA sources against the
``ctypes`` signature its wrapper sets: the same number of arguments, each of
the same kind (pointer, ``int``, ``long long``, ``float``), and the same
return type.  ``ctypes`` does not check a call against the C declaration, so
a wrong count or kind shows only on the card, as a launch that fails or a
pointer cut to 32 bits.  ``_build.load`` is stubbed: no ``nvcc`` is needed.
"""

import ctypes
import os
import re

import pytest

from csm_tpu_torch.ops import _build, bb_kernel, flash_attention, fused_decoder

_FUNC = re.compile(r"(?:^|\n)(int|long long|const char\*)\s+(\w+)\(([^)]*)\)\s*\{")
_CTYPES = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_longlong: "long long",
           ctypes.c_float: "float", ctypes.c_char_p: "const char*"}


def _kind(param: str) -> str:
    if "*" in param:
        return "pointer"
    for kind in ("long long", "float", "int"):
        if re.search(rf"\b{kind}\b", param):
            return kind
    raise ValueError(f"unknown C parameter type: {param!r}")


def _c_functions():
    """``{(source, function): (return kind, [argument kinds])}`` of every
    ``extern "C"`` block in ``csrc/*.cu``."""
    out = {}
    for name in sorted(os.listdir(_build.CSRC)):
        if not name.endswith(".cu"):
            continue
        with open(os.path.join(_build.CSRC, name)) as f:
            text = f.read()
        for block in re.findall(r'extern "C" \{(.*?)\}\s*// extern "C"', text, re.S):
            for ret, fn, params in _FUNC.findall(block):
                args = [p for p in (x.strip() for x in params.split(",")) if p]
                out[(name[:-3], fn)] = (ret, [_kind(a) for a in args])
    return out


C_FUNCTIONS = _c_functions()


def _bound_signatures(monkeypatch):
    """``{(source, function): (restype, argtypes)}`` as the wrappers set them."""
    bound = {}

    class FakeLib:
        pass

    def fake_load(name, signatures):
        lib = FakeLib()
        for fn, (argtypes, restype) in signatures.items():
            bound[(name, fn)] = (restype, list(argtypes))
            setattr(lib, fn, None)
        return lib

    monkeypatch.setattr(_build, "load", fake_load)
    for getter in (flash_attention._fwd_lib, flash_attention._bwd_lib, bb_kernel._lib,
                   bb_kernel._lib_q, fused_decoder._lib):
        getter()
    return bound


def test_every_source_has_c_functions():
    sources = {src for src, _ in C_FUNCTIONS}
    assert sources == {"flash_fwd", "flash_bwd", "bb_decode", "bb_decode_q", "fused_decoder"}


@pytest.mark.parametrize("source,fn", sorted(C_FUNCTIONS))
def test_wrapper_signature_matches_the_c_declaration(monkeypatch, source, fn):
    ret, kinds = C_FUNCTIONS[(source, fn)]
    bound = _bound_signatures(monkeypatch)
    assert (source, fn) in bound, f"no wrapper sets a signature for {source}.{fn}"
    restype, argtypes = bound[(source, fn)]
    assert _CTYPES[restype] == ret, (restype, ret)
    assert [_CTYPES[a] for a in argtypes] == kinds
