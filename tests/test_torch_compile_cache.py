"""The port's persistent store of kernel libraries (``compile_cache``) and
``kernels/_build.py``'s use of it, on the CPU.

A stand-in toolkit does the building: an ``nvcc`` script that hands a
plain-C++ source to ``g++``, so ``_build`` runs its real path (start,
finish, ``os.replace``, store) and ``ctypes`` loads a real library.  The
card builds the real kernels the same way (``chip_smoke.py`` phase 16(f)).
"""

import ctypes
import io
import os
import shutil
import stat
import sys

import pytest

from tensorflowonspark_torch import compile_cache, fs, obs
from tensorflowonspark_torch.kernels import _build

_FIND_NVCC = _build.find_nvcc
SOURCE = 'extern "C" int tfos_answer(void) { return %d; }\n'

FAKE_NVCC = """#!%s
import subprocess, sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
src = [a for a in args if a.endswith(".cu")][0]
sys.exit(subprocess.call(["g++", "-x", "c++", "-shared", "-fPIC", "-O1",
                          "-o", out, src]))
"""


class MemFS(fs.FileSystem):
    """In-memory filesystem for a mock scheme (``mock://…``)."""

    def __init__(self):
        self.files: dict[str, bytes] = {}
        self.dirs: set[str] = set()

    def open(self, path, mode="rb"):
        if "w" in mode:
            outer = self

            class W(io.BytesIO):
                def close(self_inner):
                    outer.files[path] = self_inner.getvalue()
                    super().close()

            return W()
        if path not in self.files:
            raise FileNotFoundError(path)
        return io.BytesIO(self.files[path])

    def listdir(self, path):
        prefix = path.rstrip("/") + "/"
        return sorted({p[len(prefix):].split("/")[0]
                       for p in list(self.files) + list(self.dirs)
                       if p.startswith(prefix)})

    def exists(self, path):
        return path in self.files or path in self.dirs

    def makedirs(self, path):
        self.dirs.add(path)

    def glob(self, pattern):
        import fnmatch

        return sorted(p for p in self.files if fnmatch.fnmatch(p, pattern))

    def remove(self, path):
        self.files.pop(path, None)


def _counter(name):
    inst = obs.get_registry().peek(name)
    return int(inst.value) if inst is not None else 0


def _counts():
    return {k: _counter(f"serving_compile_cache_disk_{k}_total")
            for k in ("hits", "writes", "corrupt")}


def _delta(before):
    now = _counts()
    return {k: now[k] - before[k] for k in now}


@pytest.fixture()
def toolkit(tmp_path, monkeypatch):
    """A kernel source tree, an empty ``_build`` and a stand-in ``nvcc``
    under ``$CUDA_HOME``; the cache off until a test sets its env."""
    if shutil.which("g++") is None:
        pytest.fail("g++ is needed to build the stand-in libraries")
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "answer.cu").write_text(SOURCE % 42)
    cuda = tmp_path / "cuda" / "bin"
    cuda.mkdir(parents=True)
    nvcc = cuda / "nvcc"
    nvcc.write_text(FAKE_NVCC % sys.executable)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build1"))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    for var in ("TFOS_COMPILE_CACHE_DIR", "TFOS_COMPILE_CACHE",
                "TFOS_COMPILE_CACHE_SPOOL"):
        monkeypatch.delenv(var, raising=False)
    compile_cache.disable()
    yield tmp_path
    compile_cache.disable()


def _fresh_process(monkeypatch, tmp_path, build_dir, nvcc=False):
    """What a second executor sees: an empty ``_build``, no library loaded,
    the cache configured anew and (unless ``nvcc``) no compiler."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / build_dir))
    monkeypatch.setattr(_build, "_LIBS", {})
    compile_cache.disable()

    def no_nvcc():
        raise AssertionError("nvcc looked for although the cache holds the "
                             "library")

    monkeypatch.setattr(_build, "find_nvcc", _FIND_NVCC if nvcc else no_nvcc)


def test_topology_key_fences_card_and_toolkit():
    import torch

    key = compile_cache.topology_key("NVIDIA H100 80GB HBM3", (9, 0))
    assert key == (f"torch{torch.__version__}-cuda"
                   f"{torch.version.cuda or 'none'}-NVIDIA-H100-80GB-HBM3"
                   f"-sm90")
    assert key != compile_cache.topology_key("NVIDIA A100-SXM4-80GB", (8, 0))
    assert "/" not in key and " " not in key
    if not torch.cuda.is_available():
        assert compile_cache.topology_key().endswith("-cpu-sm0")


def test_enable_and_disable_by_environment(tmp_path, monkeypatch):
    monkeypatch.delenv("TFOS_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("TFOS_COMPILE_CACHE_DIR", raising=False)
    compile_cache.disable()
    assert compile_cache.cache_root() is None and not compile_cache.enabled()
    assert compile_cache.ensure() is None and not compile_cache.active()
    for off in ("0", "off", "none", ""):
        monkeypatch.setenv("TFOS_COMPILE_CACHE_DIR", off)
        assert compile_cache.cache_root() is None
    monkeypatch.setenv("TFOS_COMPILE_CACHE_DIR", str(tmp_path / "cc"))
    assert compile_cache.cache_root() == str(tmp_path / "cc")
    monkeypatch.setenv("TFOS_COMPILE_CACHE", "0")
    assert not compile_cache.enabled()
    monkeypatch.delenv("TFOS_COMPILE_CACHE")
    namespace = compile_cache.ensure()
    try:
        assert namespace == os.path.join(str(tmp_path / "cc"),
                                         compile_cache.topology_key())
        assert os.path.isdir(namespace) and compile_cache.active()
        assert compile_cache.ensure() == namespace  # idempotent
        assert compile_cache.stats()["namespace"] == namespace
    finally:
        compile_cache.disable()
    assert not compile_cache.active()


def test_build_writes_the_store_and_a_second_process_loads_without_nvcc(
        toolkit, monkeypatch):
    monkeypatch.setenv("TFOS_COMPILE_CACHE_DIR", str(toolkit / "cc"))
    before = _counts()
    paths = _build.build_all()
    assert [os.path.basename(p) for p in paths] == [
        f"answer-{_build.source_hash('answer')}.so"]
    assert _delta(before) == {"hits": 0, "writes": 1, "corrupt": 0}
    entry = os.path.join(compile_cache.ensure(), os.path.basename(paths[0]))
    assert os.path.exists(entry) and os.path.exists(entry + ".sha256")

    _fresh_process(monkeypatch, toolkit, "build2")
    lib = _build.load("answer")
    assert lib.tfos_answer() == 42
    assert _delta(before) == {"hits": 1, "writes": 1, "corrupt": 0}
    assert not [f for f in os.listdir(toolkit / "build2") if ".tmp" in f]
    # build_all finds it too, and still looks for no compiler
    _fresh_process(monkeypatch, toolkit, "build3")
    assert os.path.basename(_build.build_all()[0]) == os.path.basename(
        paths[0])
    assert _delta(before)["hits"] == 2


def test_an_edited_source_is_a_new_entry(toolkit, monkeypatch):
    monkeypatch.setenv("TFOS_COMPILE_CACHE_DIR", str(toolkit / "cc"))
    first = os.path.basename(_build.build_all()[0])
    (toolkit / "csrc" / "answer.cu").write_text(SOURCE % 7)
    _fresh_process(monkeypatch, toolkit, "build2", nvcc=True)
    assert _build.load("answer").tfos_answer() == 7
    assert sorted(f for f in os.listdir(compile_cache.ensure())
                  if f.endswith(".so")) == sorted(
        [first, os.path.basename(_build.library_path("answer"))])


def test_a_corrupt_entry_is_rejected_and_rebuilt(toolkit, monkeypatch):
    monkeypatch.setenv("TFOS_COMPILE_CACHE_DIR", str(toolkit / "cc"))
    path = _build.build_all()[0]
    entry = os.path.join(compile_cache.ensure(), os.path.basename(path))
    with open(entry, "r+b") as f:
        f.seek(64)
        f.write(b"\xff" * 16)
    before = _counts()
    _fresh_process(monkeypatch, toolkit, "build2", nvcc=True)
    assert _build.load("answer").tfos_answer() == 42  # built, not loaded
    assert _delta(before) == {"hits": 0, "writes": 1, "corrupt": 1}
    # the rebuild replaced the bad entry: the next process loads it
    _fresh_process(monkeypatch, toolkit, "build3")
    assert _build.load("answer").tfos_answer() == 42
    assert _delta(before) == {"hits": 1, "writes": 1, "corrupt": 1}


def test_every_fresh_build_is_written_and_an_off_cache_writes_none(
        toolkit, monkeypatch):
    """A build of a second or less is written all the same (every kernel
    library is worth storing); with ``TFOS_COMPILE_CACHE=0`` nothing is
    written, looked up or counted."""
    monkeypatch.setenv("TFOS_COMPILE_CACHE_DIR", str(toolkit / "cc"))
    monkeypatch.setenv("TFOS_COMPILE_CACHE", "0")
    before = _counts()
    _build.build_all()
    assert compile_cache.ensure() is None
    assert _delta(before) == {"hits": 0, "writes": 0, "corrupt": 0}
    assert not os.path.exists(toolkit / "cc")
    monkeypatch.delenv("TFOS_COMPILE_CACHE")
    _fresh_process(monkeypatch, toolkit, "build2", nvcc=True)
    _build.build_all()
    assert _delta(before) == {"hits": 0, "writes": 1, "corrupt": 0}
    assert [f for f in os.listdir(compile_cache.ensure())
            if f.endswith(".so")] == [os.path.basename(
                _build.library_path("answer"))]


def test_remote_namespace_pushes_and_pulls_through_fs(toolkit, monkeypatch):
    mem = MemFS()
    fs.register("mock", mem)
    try:
        monkeypatch.setenv("TFOS_COMPILE_CACHE_DIR", "mock://bucket/cc")
        monkeypatch.setenv("TFOS_COMPILE_CACHE_SPOOL", str(toolkit / "sp1"))
        name = os.path.basename(_build.build_all()[0])
        assert compile_cache.stats()["remote"]
        assert compile_cache.sync() == 1
        ns = f"mock://bucket/cc/{compile_cache.topology_key()}"
        assert set(mem.files) == {f"{ns}/{name}", f"{ns}/{name}.sha256"}
        assert compile_cache.sync() == 0  # nothing new

        # a second executor: its own spool, no compiler
        monkeypatch.setenv("TFOS_COMPILE_CACHE_SPOOL", str(toolkit / "sp2"))
        before = _counts()
        _fresh_process(monkeypatch, toolkit, "build2")
        assert _build.load("answer").tfos_answer() == 42
        assert _delta(before) == {"hits": 1, "writes": 0, "corrupt": 0}

        # a damaged remote payload is rejected on pull and never loaded
        mem.files[f"{ns}/{name}"] = mem.files[f"{ns}/{name}"][:100]
        monkeypatch.setenv("TFOS_COMPILE_CACHE_SPOOL", str(toolkit / "sp3"))
        before = _counts()
        _fresh_process(monkeypatch, toolkit, "build3", nvcc=True)
        assert _build.load("answer").tfos_answer() == 42
        assert _delta(before) == {"hits": 0, "writes": 1, "corrupt": 1}
        # the local build repairs the remote entry
        assert compile_cache.sync() == 1
        assert len(mem.files[f"{ns}/{name}"]) > 100

        # a payload with no sidecar yet (mid-write elsewhere) is skipped
        spool = toolkit / "sp4"
        spool.mkdir()
        mem.files[f"{ns}/other-0.so"] = b"half"
        got = compile_cache.pull_entries(ns, str(spool), pushed=set())
        assert got == {"pulled": 1, "corrupt": 0, "skipped": 1}
    finally:
        fs.unregister("mock")


def test_counters_carry_the_names_obs_fleet_reads():
    import inspect

    from tensorflowonspark_torch.obs import fleet

    src = inspect.getsource(fleet)
    assert "serving_compile_cache_disk_hits_total" in src
    names = {i.name for i in compile_cache._instruments()}
    assert names == {"serving_compile_cache_disk_hits_total",
                     "serving_compile_cache_disk_writes_total",
                     "serving_compile_cache_disk_corrupt_total"}
    assert set(compile_cache.stats()) >= {"disk_hits", "disk_writes",
                                          "disk_corrupt", "namespace",
                                          "enabled", "remote", "error"}


def test_public_surface_matches_the_reference():
    for name in ("cache_root", "enabled", "active", "topology_key", "ensure",
                 "disable", "pull_entries", "push_entries", "sync",
                 "sync_async", "stats"):
        assert callable(getattr(compile_cache, name)), name


def test_loaded_library_is_a_real_ctypes_library(toolkit, monkeypatch):
    """The hit is a loadable library, not a copy left half-written: every
    byte equals the built one's."""
    monkeypatch.setenv("TFOS_COMPILE_CACHE_DIR", str(toolkit / "cc"))
    built = _build.build_all()[0]
    with open(built, "rb") as f:
        payload = f.read()
    _fresh_process(monkeypatch, toolkit, "build2")
    lib = _build.load("answer")
    assert isinstance(lib, ctypes.CDLL)
    with open(_build.library_path("answer"), "rb") as f:
        assert f.read() == payload
