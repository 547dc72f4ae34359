"""Build the port's CUDA kernels at first use and load them with ``ctypes``.

Every ``tensorflowonspark_torch/csrc/<name>.cu`` compiles on its own into
``tensorflowonspark_torch/_build/<name>-<hash>.so``: a shared library with
a plain C interface, built by ``nvcc`` for ``sm_90a`` (Hopper).  The hash
covers the source bytes and the compiler flags, so an edited source builds
anew and a stale library is never loaded.  The compiler writes to a name of
its own per process and ``os.replace`` moves the result into place, so two
executor processes building at once never load a half-written file.

Nothing here runs at import: this module imports on a host without
``nvcc`` (the CPU tests do), and only :func:`load` / :func:`build_all`
need the toolkit.  A missing compiler or a failed build raises.

Both look in the persistent store first (``compile_cache``, when
``TFOS_COMPILE_CACHE_DIR`` is set): a library found there, digest
verified, is copied into ``_build/`` under a temporary name and moved into
place, and ``nvcc`` is never looked for; a fresh build is written to the
store for the rest of the fleet.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[tuple, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def sources() -> list[str]:
    """Names (without ``.cu``) of every kernel source in ``csrc/``."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def source_hash(name: str, defines: tuple = ()) -> str:
    """Hash of one source and the flags (and ``-D`` macros) it is built
    with."""
    h = hashlib.sha256()
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        h.update(f.read())
    h.update(" ".join(_flags(defines)).encode())
    return h.hexdigest()[:16]


def _flags(defines: tuple) -> tuple:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def library_path(name: str, defines: tuple = ()) -> str:
    return os.path.join(BUILD_DIR, f"{name}-{source_hash(name, defines)}.so")


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on ``PATH``, or
    ``/usr/local/cuda/bin/nvcc``.  Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc") or "", DEFAULT_NVCC]
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin):"
        " the port's CUDA kernels build only where the CUDA toolkit is "
        "installed")


def _cached(name: str, defines: tuple = ()) -> bool:
    """Whether ``name``'s library is in ``_build/``, after a look in the
    persistent store (which copies a hit there)."""
    from tensorflowonspark_torch import compile_cache

    out = library_path(name, defines)
    if os.path.exists(out):
        return True
    os.makedirs(BUILD_DIR, exist_ok=True)
    return compile_cache.fetch(os.path.basename(out), out)


def _start(name: str, nvcc: str,
           defines: tuple = ()) -> tuple[subprocess.Popen, str, str]:
    out = library_path(name, defines)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = [nvcc, *_flags(defines), "-o", tmp,
           os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job: tuple[subprocess.Popen, str, str]) -> None:
    from tensorflowonspark_torch import compile_cache

    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    compile_cache.store(out)


def build_all(names=None, defines: tuple = ()) -> list[str]:
    """Compile every source (or ``names``) that has no up-to-date library
    (in ``_build/`` or the persistent store), with ``defines`` as ``-D``
    macros, all ``nvcc`` processes started together.  Returns the library
    paths."""
    names = sources() if names is None else list(names)
    missing = [n for n in names if not _cached(n, defines)]
    nvcc = find_nvcc() if missing else None
    jobs = {n: _start(n, nvcc, defines) for n in missing}
    failures = []
    for n, job in jobs.items():
        try:
            _finish(n, job)
        except RuntimeError as e:  # finish the other builds, then raise all
            failures.append(str(e))
    if failures:
        raise RuntimeError("\n".join(failures))
    return [library_path(n, defines) for n in names]


def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built with ``defines`` as
    ``-D`` macros), built first if needed."""
    with _LOCK:
        lib = _LIBS.get((name, defines))
        if lib is None:
            path = library_path(name, defines)
            if not _cached(name, defines):
                _finish(name, _start(name, find_nvcc(), defines))
            lib = ctypes.CDLL(path)
            _LIBS[(name, defines)] = lib
        return lib
