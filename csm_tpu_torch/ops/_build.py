"""Build and load the port's CUDA kernels.

Each ``csm_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` on first use
into its own shared library with a plain C interface, loaded with
``ctypes``.  The library's file name carries a hash of the source, of the
shared headers it may include and of the flags, so an edited kernel is
rebuilt and a stale one is never loaded.
Outputs go to ``csm_tpu_torch/_build/`` (listed in ``.gitignore``), with the
compiler's ``-Xptxas -v`` report beside each library.

Nothing here runs at import: the CPU tests import every module, and a host
without a GPU usually has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}


def _tool(name: str) -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", name),
        shutil.which(name),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"{name} not found: the CUDA kernels are built on the GPU host")


def _target(name: str) -> str:
    """The library's path, named by a hash of the source, the shared headers
    (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for src in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start ``nvcc`` for one source, or return None if it is built."""
    out = _target(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    log = open(out[:-3] + ".log", "w")
    cmd = [_tool("nvcc"), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return proc, log, tmp, out, cmd


def _finish(name: str, job) -> None:
    proc, log, tmp, out, cmd = job
    rc = proc.wait()
    log.close()
    if rc != 0:
        with open(out[:-3] + ".log") as f:
            report = f.read()
        raise RuntimeError(f"nvcc failed for {name} (rc={rc}): {' '.join(cmd)}\n{report}")
    os.replace(tmp, out)


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the given kernels, one ``nvcc`` each, all started together.
    Returns ``{name: path of the library}``."""
    names = list(names)
    jobs = {n: _start(n) for n in names}
    errors: List[str] = []
    for n, job in jobs.items():
        if job is not None:
            try:
                _finish(n, job)
            except RuntimeError as e:  # report every failed source, then raise
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: _target(n) for n in names}


def ptxas_report(name: str) -> str:
    """The compiler's register / shared-memory report for a built kernel."""
    path = _target(name)[:-3] + ".log"
    with open(path) as f:
        return f.read()


def sass_by_function(names: Iterable[str]) -> Dict[str, str]:
    """``{mangled function name: its SASS}`` over the built libraries of the
    given kernels (``cuobjdump -sass``), to check which instructions a
    kernel was compiled to (``HGMMA`` for wgmma)."""
    lines: Dict[str, List[str]] = {}
    for path in build(names).values():
        text = subprocess.run([_tool("cuobjdump"), "-sass", path], capture_output=True,
                              text=True, check=True).stdout
        body = None
        for line in text.splitlines():
            if "Function :" in line:
                body = lines.setdefault(line.split("Function :", 1)[1].strip(), [])
            elif body is not None:
                body.append(line)
    return {fn: "\n".join(body) for fn, body in lines.items()}


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process.
    ``signatures`` maps each ``extern "C"`` function to ``(argtypes,
    restype)``, set once, when the library is loaded."""
    lib = _loaded.get(name)
    if lib is None:
        path = build([name])[name]
        lib = ctypes.CDLL(path)
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return lib


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
