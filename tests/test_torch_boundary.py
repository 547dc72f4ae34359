"""The PyTorch port's import boundary and device rule.

The port (``tensorflowonspark_torch``) and ``chip_smoke.py`` must never
import JAX or the JAX package; only the parity tests import both.  A CUDA
request where there is no card raises instead of running on the CPU.
"""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

from tensorflowonspark_torch import util

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "tensorflowonspark_torch")
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorflowonspark_tpu")

_IMPORT_ALL = r"""
import importlib, json, pkgutil, sys
import tensorflowonspark_torch as pkg
names = sorted(m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                     pkg.__name__ + "."))
for n in names:
    importlib.import_module(n)
import chip_smoke
banned = %r
print(json.dumps({"modules": names, "banned": sorted(
    m for m in sys.modules if m.split(".")[0] in banned)}))
""" % (BANNED,)


def test_importing_every_port_module_loads_nothing_of_jax():
    env = {k: v for k, v in os.environ.items() if not k.startswith("TFOS_")}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    import json

    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    assert doc["banned"] == []
    for name in ("pipeline", "serving", "shapes", "ckpt", "compat",
                 "saved_model", "compile_cache",
                 "readers", "sql_compat", "util", "models.resnet",
                 "models.widedeep", "embedding", "kernels.sparse_adagrad",
                 "kernels.group_norm", "kernels._build", "sparkapi.context",
                 "TFCluster", "TFSparkNode", "TFNode", "TFManager",
                 "reservation", "shm", "marker", "metrics", "fs",
                 "chip_info", "gpu_info", "health", "trainer",
                 "parallel.train", "parallel.distributed", "obs.trace",
                 "obs.registry", "obs.flight", "obs.journal", "obs.ledger",
                 "obs.fleet", "obs.httpd", "obs.anomaly", "obs.chrome",
                 "tfrecord", "dfutil", "native.tfrecord_native",
                 "examples.resnet_spark", "examples.criteo_pipeline",
                 "models.mnist", "models.cifar", "models.mobilenet",
                 "models.inception", "examples.mnist_spark",
                 "examples.cifar10_spark", "models.bert",
                 "examples.bert_squad"):
        assert f"tensorflowonspark_torch.{name}" in doc["modules"]


def _python_files():
    yield os.path.join(REPO, "chip_smoke.py")
    for root, _dirs, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


@pytest.mark.parametrize("path", sorted(_python_files()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_source_line_imports_jax(path):
    """Statically, so imports inside functions count too."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in BANNED, (path, node.lineno, name)


def test_select_device_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv(util.DEVICE_ENV, raising=False)
    with pytest.raises(RuntimeError, match="is_available"):
        util.select_device()
    with pytest.raises(RuntimeError, match="is_available"):
        util.select_device("cuda")
    assert util.select_device("cpu") == torch.device("cpu")
    monkeypatch.setenv(util.DEVICE_ENV, "cpu")
    assert util.select_device() == torch.device("cpu")
    # an explicit argument wins over the environment
    with pytest.raises(RuntimeError, match="is_available"):
        util.select_device("cuda:0")
    with pytest.raises(RuntimeError, match="unsupported device"):
        util.select_device("meta")


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """No card (hidden with ``CUDA_VISIBLE_DEVICES``), or no repo around
    the script: a non-zero exit and no result line."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    else:
        cwd = REPO
        env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
