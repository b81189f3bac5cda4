"""Every ``extern "C"`` function of the port's CUDA sources against the
``ctypes`` signature its wrapper sets: the same number of arguments, each of
the same kind (pointer, ``int``, ``long long``, ``float``), and the same
return type.  ``ctypes`` does not check a call against the C declaration, so
a wrong count or kind shows only on the card, as a launch that fails or a
pointer cut to 32 bits.  ``_build.load`` is stubbed: no ``nvcc`` is needed.
The native audio library's functions (``native/*.cpp``) are held against
``csm_tpu_torch.native.SIGNATURES`` the same way, type for type.
"""

import ctypes
import os
import re

import pytest

from csm_tpu_torch import native
from csm_tpu_torch.ops import _build, bb_kernel, flash_attention, fused_decoder, ssm

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
                   bb_kernel._lib_q, fused_decoder._lib, ssm._lib):
        getter()
    return bound


def test_every_source_has_c_functions():
    sources = {src for src, _ in C_FUNCTIONS}
    assert sources == {"flash_fwd", "flash_bwd", "bb_decode", "bb_decode_q", "fused_decoder",
                       "ssm_step"}


@pytest.mark.parametrize("source,fn", sorted(C_FUNCTIONS))
def test_wrapper_signature_matches_the_c_declaration(monkeypatch, source, fn):
    ret, kinds = C_FUNCTIONS[(source, fn)]
    bound = _bound_signatures(monkeypatch)
    assert (source, fn) in bound, f"no wrapper sets a signature for {source}.{fn}"
    restype, argtypes = bound[(source, fn)]
    assert _CTYPES[restype] == ret, (restype, ret)
    assert [_CTYPES[a] for a in argtypes] == kinds


# The native audio library: each C parameter type against its exact ctypes
# type (pointers by what they point to).
_float_p = ctypes.POINTER(ctypes.c_float)
_NATIVE_TYPES = {
    "const char*": ctypes.c_char_p, "float**": ctypes.POINTER(_float_p),
    "float*": _float_p, "const float*": _float_p, "int*": ctypes.POINTER(ctypes.c_int),
    "long*": ctypes.POINTER(ctypes.c_long), "int": ctypes.c_int, "long": ctypes.c_long,
    "void": None,
}
_NATIVE_FUNC = re.compile(r"(?:^|\n)(int|long|void)\s+(\w+)\(([^)]*)\)\s*\{")


def _param_type(param: str) -> str:
    """``const float* data`` -> ``const float*``."""
    param = " ".join(param.split())
    name = re.search(r"(\w+)$", param).group(1)
    return param[: -len(name)].replace(" *", "*").strip()


def _native_functions():
    """``{function: (return type, [parameter types])}`` of every function
    defined in an ``extern "C"`` block of ``native/*.cpp`` (static helpers
    inside a block are not exported and are left out)."""
    out = {}
    for name in native.SOURCES:
        with open(os.path.join(os.path.dirname(native.__file__), name)) as f:
            text = f.read()
        # a block ends at its ``}  // extern "C"`` with no other block opened
        # before it (codecs.cpp opens two unmarked ones around declarations)
        blocks = re.findall(r'extern "C" \{((?:(?!extern "C" \{).)*?)\}\s*// extern "C"', text,
                            re.S)
        for block in blocks:
            for ret, fn, params in _NATIVE_FUNC.findall(block):
                assert fn not in out, f"{fn} defined twice"
                out[fn] = (ret, [_param_type(p) for p in params.split(",") if p.strip()])
    return out


NATIVE_FUNCTIONS = _native_functions()


def test_native_signatures_cover_every_exported_function():
    assert set(NATIVE_FUNCTIONS) == set(native.SIGNATURES)
    assert {"audio_read", "wav_write", "resample_poly", "resample_poly_len"} <= set(NATIVE_FUNCTIONS)


@pytest.mark.parametrize("fn", sorted(NATIVE_FUNCTIONS))
def test_native_signature_matches_the_c_declaration(fn):
    ret, params = NATIVE_FUNCTIONS[fn]
    argtypes, restype = native.SIGNATURES[fn]
    assert restype is _NATIVE_TYPES[ret], (fn, restype, ret)
    assert len(argtypes) == len(params), (fn, argtypes, params)
    for a, p in zip(argtypes, params):
        assert a is _NATIVE_TYPES[p], (fn, a, p)
