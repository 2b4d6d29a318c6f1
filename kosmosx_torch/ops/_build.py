"""Build and load the hand-written CUDA kernels in ``kosmosx_torch/csrc``.

The sources are compiled at first use with ``nvcc`` for ``sm_90a``, one
``nvcc`` per source, all started together, and linked into one shared
library with a plain C interface, loaded with ``ctypes``. The library lands
in ``kosmosx_torch/_build/<hash>/`` (listed in ``.gitignore``), keyed by a
hash of the sources, their headers and the flags, so an unchanged tree does
not rebuild.
Importing this module builds nothing and needs no ``nvcc``: only
``library()`` does, and only the CUDA branch of a kernel wrapper calls it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "decode_attention.cu",
           "w8_matmul.cu", "tile_rate.cu")
HEADERS = ("flash_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")
LIB_NAME = "libkosmosx_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the entry points (csrc/*.cu, ``extern "C"``): every
# pointer and the stream are c_void_p so ctypes never truncates them
_SIGNATURES = {
    "kx_flash_fwd": [_P] * 12 + [_I] * 7 + [_F, _P],
    "kx_flash_bwd_dkv": [_P] * 15 + [_I] * 7 + [_F, _F, _P],
    "kx_flash_bwd_dq": [_P] * 14 + [_I] * 7 + [_F, _F, _P],
    "kx_decode_attention": [_P] * 7 + [_I] * 6 + [_P],
    "kx_w8_matmul": [_P] * 5 + [_I] * 5 + [_P],
    "kx_w8_matmul_stacked": [_P] * 6 + [_I] * 6 + [_P],
    "kx_tile_rate": [_P] * 4 + [_I] * 3 + [_P],
}


def find_nvcc() -> str:
    """``nvcc`` on ``PATH``, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``); raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    candidate = home / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels of kosmosx_torch are built with it at first use")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / source_hash()


def _compile(out_dir: Path) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / f"{Path(s).stem}.o" for s in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(SOURCES, objs)]
        outputs = [proc.communicate()[0] for proc in procs]
        log = "".join(f"== {s}\n{out}" for s, out in zip(SOURCES, outputs))
        failed = [s for s, proc in zip(SOURCES, procs) if proc.returncode]
        if not failed:
            tmp_lib = Path(tmp) / LIB_NAME
            link = subprocess.run(
                [nvcc, "-shared", *map(str, objs), "-o", str(tmp_lib)],
                capture_output=True, text=True, check=False)
            log += f"== link\n{link.stdout}{link.stderr}"
            if link.returncode:
                failed = ["link"]
        (out_dir / "build.log").write_text(log)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{log[-4000:]}")
        os.replace(tmp_lib, out_dir / LIB_NAME)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this tree has not built it."""
    out_dir = build_dir()
    path = out_dir / LIB_NAME
    if not path.is_file():
        _compile(out_dir)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.kx_error_string.argtypes = [ctypes.c_int]
    lib.kx_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (its
    ``cudaGetLastError()`` right after the launch)."""
    if err != 0:
        msg = lib.kx_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
