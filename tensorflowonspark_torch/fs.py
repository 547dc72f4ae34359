"""Filesystem abstraction so record I/O works on remote filesystems.

A copy of ``tensorflowonspark_tpu/fs.py`` with its imports rewritten.

Reference anchor: the reference's record I/O rides Hadoop's FileSystem API
(``dfutil.py`` → ``saveAsNewAPIHadoopFile`` → HDFS; ``SURVEY.md §3.5``), so
``hdfs://`` paths work everywhere.  The TPU rebuild has no JVM; this module
is the equivalent seam:

- plain paths and ``file://`` → local filesystem (zero new dependencies);
- ``gs://`` / ``hdfs://`` / ``s3://`` / … → `fsspec <https://filesystem-spec
  .readthedocs.io>`_ when importable (it ships with orbax/tensorstore),
  with a clear error naming the missing backend otherwise;
- test/mock schemes via :func:`register` (used by the round-trip tests).

Checkpoints already delegate URI handling to Orbax/tensorstore
(``ckpt.py``); with this module the TFRecord layer (``tfrecord.py``,
``dfutil.py``, ``readers.py``) consumes the same ``TFNode.hdfs_path``
outputs.
"""

from __future__ import annotations

import builtins
import glob as _glob_mod
import os
import re
from typing import IO

_SCHEME_RE = re.compile(r"^([a-zA-Z][a-zA-Z0-9+.-]*)://")

#: scheme -> filesystem object (mock/test injection point)
_REGISTRY: dict[str, "FileSystem"] = {}


class FileSystem:
    """Minimal interface the record layer needs (open/list/exists/mkdir)."""

    def open(self, path: str, mode: str = "rb") -> IO:
        raise NotImplementedError

    def listdir(self, path: str) -> list[str]:
        """Entry names (not full paths) of a directory."""
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def makedirs(self, path: str) -> None:
        raise NotImplementedError

    def glob(self, pattern: str) -> list[str]:
        """Full paths matching a glob pattern (sorted)."""
        raise NotImplementedError


class LocalFS(FileSystem):
    """Plain paths and ``file://`` URIs."""

    @staticmethod
    def _strip(path: str) -> str:
        if path.startswith("file://"):
            return path[len("file://"):] or "/"
        return path

    def open(self, path: str, mode: str = "rb") -> IO:
        # builtins: the module-level fs.open convenience shadows the builtin
        return builtins.open(self._strip(path), mode)

    def listdir(self, path: str) -> list[str]:
        return sorted(os.listdir(self._strip(path)))

    def exists(self, path: str) -> bool:
        return os.path.exists(self._strip(path))

    def makedirs(self, path: str) -> None:
        os.makedirs(self._strip(path), exist_ok=True)

    def glob(self, pattern: str) -> list[str]:
        prefix = "file://" if pattern.startswith("file://") else ""
        return sorted(prefix + p for p in _glob_mod.glob(self._strip(pattern)))


class FsspecFS(FileSystem):
    """Any scheme fsspec knows (gs, s3, hdfs, …); paths keep their scheme."""

    def __init__(self, scheme: str):
        import fsspec

        self.scheme = scheme
        try:
            self._fs = fsspec.filesystem(scheme)
        except (ImportError, ValueError) as e:
            raise OSError(
                f"cannot access {scheme}:// paths: fsspec has no usable "
                f"backend for this scheme here ({e}); install the protocol "
                f"package (e.g. gcsfs for gs://, pyarrow for hdfs://) or "
                f"register a filesystem via tensorflowonspark_torch.fs.register"
            ) from e

    def _qualify(self, path: str) -> str:
        return path if _SCHEME_RE.match(path) else f"{self.scheme}://{path}"

    def open(self, path: str, mode: str = "rb") -> IO:
        return self._fs.open(path, mode)

    def listdir(self, path: str) -> list[str]:
        entries = self._fs.ls(path, detail=False)
        return sorted(os.path.basename(e.rstrip("/")) for e in entries)

    def exists(self, path: str) -> bool:
        return self._fs.exists(path)

    def makedirs(self, path: str) -> None:
        self._fs.makedirs(path, exist_ok=True)

    def glob(self, pattern: str) -> list[str]:
        return sorted(self._qualify(p) for p in self._fs.glob(pattern))


_LOCAL = LocalFS()


def register(scheme: str, fs: FileSystem) -> None:
    """Install ``fs`` for ``scheme://`` paths (tests, custom backends)."""
    _REGISTRY[scheme] = fs


def unregister(scheme: str) -> None:
    _REGISTRY.pop(scheme, None)


def get_fs(path: str) -> FileSystem:
    """The filesystem responsible for ``path``."""
    m = _SCHEME_RE.match(path)
    if m is None or m.group(1) == "file":
        return _LOCAL
    scheme = m.group(1)
    if scheme in _REGISTRY:
        return _REGISTRY[scheme]
    try:
        import fsspec  # noqa: F401
    except ImportError:
        raise OSError(
            f"cannot access {scheme}:// paths: fsspec is not installed; "
            f"register a filesystem via tensorflowonspark_torch.fs.register "
            f"or use local/file:// paths"
        ) from None
    return FsspecFS(scheme)


def local_path(path: str) -> str | None:
    """The plain local path when ``path`` is local, else ``None``.

    Lets callers with an optimized local fast path (mmap, the native C++
    codec) keep it without scheme-awareness of their own.
    """
    m = _SCHEME_RE.match(path)
    if m is None:
        return path
    if m.group(1) == "file":
        return LocalFS._strip(path)
    return None


# -- module-level conveniences (the record layer's actual call surface) ------


def open(path: str, mode: str = "rb") -> IO:  # noqa: A001 shadow intended
    return get_fs(path).open(path, mode)


def listdir(path: str) -> list[str]:
    return get_fs(path).listdir(path)


def exists(path: str) -> bool:
    return get_fs(path).exists(path)


def makedirs(path: str) -> None:
    get_fs(path).makedirs(path)


def glob(pattern: str) -> list[str]:
    return get_fs(pattern).glob(pattern)


def join(base: str, *parts: str) -> str:
    """Scheme-preserving path join (posix separators for remote URIs)."""
    if _SCHEME_RE.match(base):
        return "/".join([base.rstrip("/"), *(p.strip("/") for p in parts)])
    return os.path.join(base, *parts)
