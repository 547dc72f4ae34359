"""Persistent, fleet-shared store of the port's compiled kernel libraries,
on the ``fs.py`` seam.

Reference anchor: ``tensorflowonspark_tpu/compile_cache.py``, which points
JAX's persistent compilation cache at a shared directory so that one
replica compiles and the fleet loads.  What the port compiles ahead of
running is different: the ``nvcc``-built ``.so`` libraries of
``kernels/_build.py`` (a few seconds each with the whole toolkit; nothing
on a host without it).  This module keeps them in the same kind of store:

- **Backing store**: a directory resolved through
  :mod:`tensorflowonspark_torch.fs`.  Plain local paths and ``file://``
  hold the entries directly; any remote scheme (``hdfs://``, ``gs://``, a
  registered test scheme) rides a local **spool**: entries are pulled from
  the remote namespace when the cache is configured and pushed as new
  builds land, so one executor builds and the fleet loads.
- **Content-addressed, topology-fenced keys**: an entry's name is the
  library's own file name, ``<source>-<hash>.so``, whose hash covers the
  source bytes and the compiler flags (``_build.source_hash``), so an
  edited kernel can never collide with an old one.  Every entry lives
  under a *topology namespace* (``torch<ver>-cuda<ver>-<device
  name>-sm<cc>``): a library built for another card or toolkit is never
  even listed.  Each entry carries a ``.sha256`` sidecar written *after*
  the payload; a reader verifies it and **rejects a corrupt or
  half-written entry** (counted in
  ``serving_compile_cache_disk_corrupt_total``) instead of loading it,
  then builds the library afresh and writes it over the bad one.
- **Observability**: disk hits / writes / corrupt-rejections counters,
  under the reference's names (``obs/fleet.py`` reads them).

Configuration, as the reference's: ``TFOS_COMPILE_CACHE_DIR=<path-or-uri>``
enables; ``TFOS_COMPILE_CACHE=0`` force-disables even when a dir is set;
``TFOS_COMPILE_CACHE_SPOOL`` overrides the local spool root for remote
namespaces.  Every fresh build is written: each takes seconds of ``nvcc``.  :func:`ensure` runs where the
reference calls it (``Trainer`` construction, the serving model load) and
at every library build or load (``kernels/_build.py``); it is a no-op when
unconfigured.

What has no counterpart here: the reference's JAX monitoring-event
listeners (a library load is this module's own call, so it counts its
hits and writes directly) and its ``_unlatch_jax_cache`` (nothing latches
a cache decision).  The compiled step's CUDA graphs
(``parallel.train.CompiledStep``) cannot be serialised at all: each
process captures its own, after loading its libraries from here.
"""

from __future__ import annotations

import hashlib
import logging
import os
import re
import threading
import time
from typing import Any

logger = logging.getLogger(__name__)

#: the kind of file an entry is: a kernel library
ENTRY_SUFFIX = ".so"

_LOCK = threading.Lock()
_SYNC_LOCK = threading.Lock()
_INSTRUMENTS = None

_STATE: dict[str, Any] = {
    "attempted": False,     # one configure attempt per process
    "namespace": None,      # logical cache namespace (root/topology), or None
    "active_dir": None,     # the local dir entries are read and written in
    "remote_ns": None,      # set only for remote roots
    "spool": None,          # local spool backing a remote namespace
    "pushed": set(),        # spool entry names verified to exist remotely
    "sync_scheduled": False,  # a delayed background push is pending
    "error": None,          # why configuration failed, if it did
}


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


def cache_root() -> str | None:
    """The configured cache root (path or URI), or None when disabled."""
    if os.environ.get("TFOS_COMPILE_CACHE", "1").strip().lower() in (
            "0", "false"):
        return None
    root = os.environ.get("TFOS_COMPILE_CACHE_DIR", "").strip()
    if not root or root.lower() in ("0", "off", "none"):
        return None
    return root


def enabled() -> bool:
    return cache_root() is not None


def active() -> bool:
    """True once :func:`ensure` has configured the cache in this process."""
    return _STATE["namespace"] is not None


def topology_key(device_name: str | None = None,
                 capability: tuple[int, int] | None = None) -> str:
    """The topology namespace an entry set is valid for:
    ``torch<ver>-cuda<ver>-<device name>-sm<major><minor>``, from card 0
    unless ``device_name``/``capability`` are given; ``...-cpu-sm0`` on a
    host without a card.  The file name's hash already covers the source
    and flags; the namespace makes a library built for another card or
    toolkit structurally invisible, as the reference's does for another
    backend."""
    import torch

    if device_name is None or capability is None:
        if torch.cuda.is_available():
            device_name = device_name or torch.cuda.get_device_name(0)
            capability = capability or torch.cuda.get_device_capability(0)
        else:
            device_name = device_name or "cpu"
            capability = capability or (0, 0)
    major, minor = capability
    raw = (f"torch{torch.__version__}-cuda{torch.version.cuda or 'none'}"
           f"-{device_name}-sm{major}{minor if major else ''}")
    return re.sub(r"[^A-Za-z0-9_.+-]+", "-", raw)


def ensure() -> str | None:
    """Configure the store for this process (idempotent).

    Returns the logical namespace in use, or None when disabled or
    unconfigurable.  Never raises: a cache problem must not take down a
    trainer or a model load — the process just builds its libraries as it
    always did, and the reason lands in :func:`stats`."""
    with _LOCK:
        if _STATE["attempted"]:
            return _STATE["namespace"]
        root = cache_root()
        if root is None:
            return None
        _STATE["attempted"] = True
        try:
            _configure(root)
        except Exception as e:  # pragma: no cover - env-specific failures
            _STATE["error"] = f"{type(e).__name__}: {e}"[:300]
            _STATE["namespace"] = None
            logger.warning("kernel library cache disabled: cannot "
                           "configure %r: %s", root, e)
        return _STATE["namespace"]


def _configure(root: str) -> None:
    from tensorflowonspark_torch import fs

    namespace = fs.join(root, topology_key())
    local = fs.local_path(namespace)
    if local is not None:
        os.makedirs(local, exist_ok=True)
        active_dir = local
    else:
        fs.makedirs(namespace)
        spool = _spool_dir(namespace)
        os.makedirs(spool, exist_ok=True)
        _STATE["remote_ns"] = namespace
        _STATE["spool"] = spool
        active_dir = spool
        pulled = pull_entries(namespace, spool, pushed=_STATE["pushed"])
        logger.info("kernel library cache %s: pulled %d entries to spool "
                    "%s (%d corrupt rejected)", namespace, pulled["pulled"],
                    spool, pulled["corrupt"])
    _STATE["namespace"] = namespace
    _STATE["active_dir"] = active_dir
    logger.info("kernel library cache at %s (local dir %s)", namespace,
                active_dir)


def _spool_dir(namespace: str) -> str:
    root = os.environ.get("TFOS_COMPILE_CACHE_SPOOL")
    if not root:
        import tempfile

        root = os.path.join(tempfile.gettempdir(), "tfos-compile-spool")
    tag = hashlib.sha256(namespace.encode()).hexdigest()[:16]
    return os.path.join(root, tag)


def disable() -> None:
    """Tear the configuration down (tests, A/B runs): the next
    :func:`ensure` re-reads the environment."""
    with _LOCK:
        _STATE.update(attempted=False, namespace=None, active_dir=None,
                      remote_ns=None, spool=None, error=None,
                      sync_scheduled=False)
        _STATE["pushed"] = set()


# ---------------------------------------------------------------------------
# Entries: what kernels/_build.py calls
# ---------------------------------------------------------------------------


def _digest(payload: bytes) -> str:
    return hashlib.sha256(payload).hexdigest()


def fetch(name: str, dest: str) -> bool:
    """Copy the entry ``name`` (a library's file name) to ``dest`` when the
    store holds it with a matching digest: written under a temporary name
    beside ``dest`` and moved into place with ``os.replace``, so a
    concurrent loader never sees half a file.  Returns whether it did (a
    disk hit).  An entry whose digest differs from its sidecar is rejected
    and counted, never copied."""
    if ensure() is None:
        return False
    src = os.path.join(_STATE["active_dir"], name)
    try:
        with open(src + ".sha256", "rb") as f:
            want = f.read().decode("ascii", "replace").strip()
        with open(src, "rb") as f:
            payload = f.read()
    except OSError:
        return False  # absent, or its sidecar not written yet
    if _digest(payload) != want:
        _instruments()[2].inc()
        logger.warning("kernel library cache: REJECTED corrupt entry %s "
                       "(digest mismatch): building it instead", src)
        return False
    tmp = f"{dest}.tmp{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, dest)
    _instruments()[0].inc()
    return True


def store(path: str) -> bool:
    """Write the freshly built library at ``path`` into the store (payload,
    then its sidecar); a remote namespace is pushed soon after, off the
    caller's thread.  Returns whether it wrote."""
    if ensure() is None:
        return False
    name = os.path.basename(path)
    with open(path, "rb") as f:
        payload = f.read()
    dst = os.path.join(_STATE["active_dir"], name)
    try:
        _write_atomic(dst, payload)
        _write_atomic(dst + ".sha256", _digest(payload).encode("ascii"))
    except OSError as e:
        logger.warning("kernel library cache: cannot write %s: %s", dst, e)
        return False
    # a rewritten entry (a corrupt one replaced) must be pushed again
    _STATE["pushed"].discard(name)
    _instruments()[1].inc()
    sync_async()
    return True


def _write_atomic(dst: str, payload: bytes) -> None:
    tmp = f"{dst}.tmp{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, dst)


# ---------------------------------------------------------------------------
# Remote sync (the fs.py seam)
# ---------------------------------------------------------------------------


def pull_entries(remote_ns: str, spool: str,
                 pushed: set | None = None) -> dict:
    """Copy remote entries into the local spool, digest-verified.

    Only ``*.so`` entries WITH a matching ``.sha256`` sidecar are
    accepted: the sidecar is written after the payload (see
    :func:`push_entries`), so a half-written entry simply has no sidecar
    yet and is skipped — and a corrupt payload (truncated write, bit rot)
    fails the digest and is **rejected loudly** (warning +
    ``serving_compile_cache_disk_corrupt_total``) instead of being
    loaded.  Returns ``{"pulled", "corrupt", "skipped"}``."""
    from tensorflowonspark_torch import fs

    pulled = corrupt = skipped = 0
    try:
        names = fs.listdir(remote_ns)
    except Exception as e:
        logger.warning("kernel library cache: cannot list %s: %s",
                       remote_ns, e)
        return {"pulled": 0, "corrupt": 0, "skipped": 0}
    have = set(os.listdir(spool)) if os.path.isdir(spool) else set()
    for name in sorted(names):
        if not name.endswith(ENTRY_SUFFIX):
            continue
        src = fs.join(remote_ns, name)
        if name in have:
            # already spooled: mark pushed only when the remote sidecar
            # matches our bytes, so a half-written or divergent remote
            # entry is overwritten by the next sync (repair)
            if pushed is not None:
                try:
                    with fs.open(src + ".sha256", "rb") as f:
                        want = f.read().decode("ascii", "replace").strip()
                    with open(os.path.join(spool, name), "rb") as f:
                        if _digest(f.read()) == want:
                            pushed.add(name)
                except Exception:
                    pass
            continue
        try:
            # sidecar FIRST: the writer's order is payload-then-sidecar,
            # so a readable sidecar proves the payload write finished
            with fs.open(src + ".sha256", "rb") as f:
                want = f.read().decode("ascii", "replace").strip()
            with fs.open(src, "rb") as f:
                payload = f.read()
        except Exception:
            skipped += 1  # mid-write elsewhere, or a transient failure
            continue
        if _digest(payload) != want:
            corrupt += 1
            _instruments()[2].inc()
            logger.warning(
                "kernel library cache: REJECTED corrupt entry %s (digest "
                "mismatch) — building locally instead of loading a "
                "damaged library (the local build replaces it on the next "
                "sync)", src)
            continue
        _write_atomic(os.path.join(spool, name), payload)
        _write_atomic(os.path.join(spool, name + ".sha256"),
                      want.encode("ascii"))
        if pushed is not None:
            pushed.add(name)  # verified remote copy: never echo it back
        pulled += 1
    return {"pulled": pulled, "corrupt": corrupt, "skipped": skipped}


def push_entries(spool: str, remote_ns: str, pushed: set) -> int:
    """Copy new spool entries to the remote namespace through fs.py:
    payload first, digest sidecar second, so a reader never loads a
    half-done write."""
    from tensorflowonspark_torch import fs

    n = 0
    if not os.path.isdir(spool):
        return 0
    for name in sorted(os.listdir(spool)):
        if not name.endswith(ENTRY_SUFFIX) or name in pushed:
            continue
        with open(os.path.join(spool, name), "rb") as f:
            payload = f.read()
        dst = fs.join(remote_ns, name)
        try:
            with fs.open(dst, "wb") as f:
                f.write(payload)
            with fs.open(dst + ".sha256", "wb") as f:
                f.write(_digest(payload).encode("ascii"))
        except Exception as e:
            logger.warning("kernel library cache: cannot push %s: %s", dst,
                           e)
            continue
        pushed.add(name)
        n += 1
    return n


def sync() -> int:
    """Push spool entries that are not yet remote; no-op for local roots."""
    with _SYNC_LOCK:
        if not _STATE["remote_ns"]:
            return 0
        n = push_entries(_STATE["spool"], _STATE["remote_ns"],
                         _STATE["pushed"])
        if n:
            logger.info("kernel library cache: pushed %d new entries to %s",
                        n, _STATE["remote_ns"])
            try:
                from tensorflowonspark_torch.obs import journal as _journal

                _journal.emit("compile_cache.spool", entries=n,
                              remote_ns=str(_STATE["remote_ns"])[:200])
            except Exception:  # pragma: no cover - best effort
                pass
        return n


def sync_async(delay_s: float = 0.5) -> None:
    """Schedule a :func:`sync` off the building thread, slightly delayed so
    a burst of builds (``build_all``'s parallel ones) goes in one pass.
    At most one sync is scheduled at a time; the flag clears before the
    push runs, so an entry landing mid-push schedules a fresh pass."""
    if not _STATE["remote_ns"]:
        return
    with _LOCK:
        if _STATE.get("sync_scheduled"):
            return
        _STATE["sync_scheduled"] = True

    def _run():
        time.sleep(delay_s)
        with _LOCK:
            _STATE["sync_scheduled"] = False
        try:
            sync()
        except Exception:  # pragma: no cover - never fail a build path
            logger.warning("kernel library cache: background sync failed",
                           exc_info=True)

    threading.Thread(target=_run, name="tfos-compile-cache-sync",
                     daemon=True).start()


# ---------------------------------------------------------------------------
# Counters
# ---------------------------------------------------------------------------


def _instruments():
    global _INSTRUMENTS
    if _INSTRUMENTS is None:
        from tensorflowonspark_torch import obs

        _INSTRUMENTS = (
            obs.counter(
                "serving_compile_cache_disk_hits_total",
                "kernel libraries loaded from the persistent compile cache "
                "(copied from the store instead of built with nvcc)"),
            obs.counter(
                "serving_compile_cache_disk_writes_total",
                "kernel libraries written to the persistent compile cache "
                "(each one is a build some other process can now skip)"),
            obs.counter(
                "serving_compile_cache_disk_corrupt_total",
                "persistent-cache entries REJECTED (digest mismatch: a "
                "truncated or damaged entry)"))
    return _INSTRUMENTS


def stats() -> dict[str, Any]:
    """JSON-able cache state (``/healthz``, ``chip_smoke.py``).  Reads the
    counters with ``Registry.peek``, so a process with the cache off
    publishes no phantom 0 series."""
    from tensorflowonspark_torch import obs

    reg = obs.get_registry()

    def val(name: str) -> int:
        inst = reg.peek(name)
        return int(inst.value) if inst is not None else 0

    return {
        "enabled": enabled(),
        "dir": cache_root(),
        "namespace": _STATE["namespace"],
        "remote": bool(_STATE["remote_ns"]),
        "error": _STATE["error"],
        "disk_hits": val("serving_compile_cache_disk_hits_total"),
        "disk_writes": val("serving_compile_cache_disk_writes_total"),
        "disk_corrupt": val("serving_compile_cache_disk_corrupt_total"),
    }
