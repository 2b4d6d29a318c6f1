"""ctypes binding of the host-side packing kernel (``packing.cpp``), the
port's own copy of kosmosx_tpu/data/native/.

The shared library is built with ``g++`` at first use into
``kosmosx_torch/_build/native-<hash>/`` (listed in ``.gitignore``), keyed by
a hash of the source, so an unchanged tree does not rebuild.
``pack_blocks`` has a numpy version with the same semantics
(``pack_blocks_np``), which the binding takes where the library cannot be
built or loaded, as JAX's does; ``native_available()`` says which one runs.
The numpy version doubles as the test oracle.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "packing.cpp"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "_build"
_LIB_NAME = "libkosmosx_data.so"
_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the library of this source and these flags lands."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_CXX_FLAGS).encode())
    return _BUILD_ROOT / f"native-{digest.hexdigest()[:16]}" / _LIB_NAME


def _build(path: Path) -> bool:
    """Compile packing.cpp into ``path`` (written under a temporary name,
    then renamed, so a concurrent build never loads half a file)."""
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
        os.close(fd)
        res = subprocess.run(["g++", *_CXX_FLAGS, "-o", tmp, str(_SRC)],
                             capture_output=True, text=True, timeout=120)
        if res.returncode != 0:
            logger.warning("native packing build failed: %s", res.stderr)
            os.unlink(tmp)
            return False
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError) as e:  # no g++, RO fs, ...
        logger.warning("native packing build unavailable: %s", e)
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            logger.warning("native packing load failed: %s", e)
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.ksx_pack_blocks.restype = ctypes.c_int64
        lib.ksx_pack_blocks.argtypes = [
            i32p, i64p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
            i32p, ctypes.c_int64, i32p, ctypes.c_int64, i32p, i64p]
        _lib = lib
        return _lib


def native_available() -> bool:
    """True when the shared library is built and loaded (building it now
    if it is not)."""
    return _load() is not None


def _i32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


# -- pack_blocks: docs (each + EOS) after ``carry``, cut into seq_len rows --

def pack_blocks_np(docs: Sequence[np.ndarray], seq_len: int, eos_id: int,
                   carry: Optional[np.ndarray] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """((N, seq_len) int32 blocks, the remainder) of ``carry`` followed by
    every doc and an EOS after each."""
    parts: List[np.ndarray] = []
    if carry is not None and len(carry):
        parts.append(np.asarray(carry, np.int32))
    eos = np.asarray([eos_id], np.int32)
    for d in docs:
        parts.append(np.asarray(d, np.int32).ravel())
        parts.append(eos)
    stream = np.concatenate(parts) if parts else np.zeros((0,), np.int32)
    n = len(stream) // seq_len
    blocks = stream[:n * seq_len].reshape(n, seq_len).copy()
    return blocks, stream[n * seq_len:].copy()


def pack_blocks(docs: Sequence[np.ndarray], seq_len: int, eos_id: int,
                carry: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """``pack_blocks_np`` through the library."""
    lib = _load()
    if lib is None:
        return pack_blocks_np(docs, seq_len, eos_id, carry)
    flat_docs = [np.ascontiguousarray(np.asarray(d, np.int32).ravel())
                 for d in docs]
    lens = np.asarray([len(d) for d in flat_docs], np.int64)
    flat = (np.concatenate(flat_docs) if flat_docs
            else np.zeros((0,), np.int32))
    carry_a = (np.ascontiguousarray(np.asarray(carry, np.int32).ravel())
               if carry is not None else np.zeros((0,), np.int32))
    if len(carry_a) >= seq_len:  # the C entry takes a carry below seq_len
        return pack_blocks_np(docs, seq_len, eos_id, carry_a)
    total = int(len(carry_a) + len(flat) + len(flat_docs))
    max_blocks = total // seq_len
    out = np.empty((max_blocks, seq_len), np.int32)
    tail = np.empty((seq_len,), np.int32)
    tail_len = np.zeros((1,), np.int64)
    n = lib.ksx_pack_blocks(_i32(flat), _i64(lens), len(flat_docs),
                            eos_id, seq_len, _i32(carry_a), len(carry_a),
                            _i32(out), max_blocks, _i32(tail), _i64(tail_len))
    if n < 0:  # the C entry's guard on its arguments
        return pack_blocks_np(docs, seq_len, eos_id, carry_a)
    return out[:n], tail[:int(tail_len[0])].copy()

