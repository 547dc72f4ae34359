"""ctypes binding for the C++ TFRecord codec (``tfrecord_codec.cc``).

A port of ``tensorflowonspark_tpu/native/tfrecord_native.py``.  What
differs: the library builds with ``g++`` at first use into
``tensorflowonspark_torch/_build/libtfrecord-<hash>.so`` (the hash covers
the source and the flags, so an edited source builds anew), through a
per-process temporary name and an atomic ``os.replace`` as
:mod:`tensorflowonspark_torch.kernels._build` does for the CUDA sources —
never beside the source, and never in the JAX package's directory.  A
missing compiler, a failed build or a library that does not load raises
with the reason: nothing drops to a Python codec behind the caller's back
(:mod:`tensorflowonspark_torch.tfrecord` uses Python only when
``TFOS_DISABLE_NATIVE=1`` asks for it).  Nothing builds at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import mmap
import os
import shutil
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "tfrecord_codec.cc")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib_state: list = []  # [CDLL] once loaded


def library_path() -> str:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libtfrecord-{h.hexdigest()[:16]}.so")


def compile_library(out: str) -> str:
    """Compile the codec into ``out`` (through a temporary name of this
    process, moved into place when the compiler succeeds).  Raises when
    there is no ``g++`` or the build fails."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native TFRecord codec "
                           "builds at first use with g++")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, _SRC],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed on {_SRC} (exit {proc.returncode}):"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    if _lib_state:
        return _lib_state[0]
    with _lock:
        if _lib_state:
            return _lib_state[0]
        path = library_path()
        if not os.path.exists(path):
            compile_library(path)
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise RuntimeError(
                f"native TFRecord codec {path} does not load: {e}") from e
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.tfr_write.restype = ctypes.c_long
        lib.tfr_write.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, u64p, ctypes.c_long]
        lib.tfr_index.restype = ctypes.c_long
        lib.tfr_index.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
            ctypes.POINTER(u64p), ctypes.POINTER(u64p)]
        lib.tfr_free.argtypes = [ctypes.c_void_p]
        lib.tfr_masked_crc.restype = ctypes.c_uint
        lib.tfr_masked_crc.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        _lib_state.append(lib)
        return lib


def load() -> ctypes.CDLL:
    """The loaded codec, built first if needed.  Raises with the reason
    when it cannot be built or loaded."""
    return _load()


def masked_crc(data: bytes) -> int:
    data = bytes(data)
    return _load().tfr_masked_crc(data, len(data))


def write_records(path: str, records) -> int:
    """One C call per file: payloads are concatenated host-side."""
    lib = _load()
    records = [bytes(r) for r in records]
    blob = b"".join(records)
    n = len(records)
    lengths = (ctypes.c_uint64 * n)(*[len(r) for r in records])
    # fresh file semantics (tfr_write appends, matching Hadoop part writers)
    if os.path.exists(path):
        os.remove(path)
    written = lib.tfr_write(path.encode(), blob, lengths, n)
    if written != n:
        raise IOError(f"native TFRecord write to {path} failed")
    return written


def read_records(path: str, verify: bool = True):
    """mmap the file, index+verify in C, slice payloads in Python.

    MAP_PRIVATE copy-on-write mapping instead of ``f.read()`` so multi-GB
    part files never materialise fully in executor heap; pages stream
    through the page cache as the C indexer scans them.
    """
    lib = _load()
    with open(path, "rb") as f:
        try:
            mm = mmap.mmap(f.fileno(), 0, flags=mmap.MAP_PRIVATE,
                           prot=mmap.PROT_READ | mmap.PROT_WRITE)
        except ValueError:  # zero-length file: no records
            return
    try:
        size = len(mm)
        carr = (ctypes.c_char * size).from_buffer(mm)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        offsets, lengths = u64p(), u64p()
        try:
            n = lib.tfr_index(ctypes.addressof(carr), size, int(verify),
                              ctypes.byref(offsets), ctypes.byref(lengths))
            if n == -1:
                raise IOError(f"{path}: corrupt record crc")
            if n == -2:
                raise IOError(f"{path}: truncated record")
            for i in range(n):
                off, length = offsets[i], lengths[i]
                yield mm[off:off + length]
        finally:
            lib.tfr_free(offsets)
            lib.tfr_free(lengths)
            del carr  # release the buffer export before mm.close()
    finally:
        mm.close()
