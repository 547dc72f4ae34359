"""The port's ``TFModel.transform`` slice against the JAX package's forward.

The port runs on its own local Spark substrate (spawned executors) with
``TFOS_TORCH_DEVICE=cpu``; the reference is the JAX package's tiny ResNet
forward on the same weights (converted) and the same images.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from tensorflowonspark_torch import (ckpt, compat, pipeline, serving, shapes,
                                     sparkapi, util)
from tensorflowonspark_torch.models import resnet as port
from tensorflowonspark_tpu.models import resnet as ref


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    """One intra-op thread (and OMP_NUM_THREADS=1 for spawned executors):
    the suite runs in several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _weights(norm, seed=0):
    """(flax module, variables, port state) for the tiny config: numpy
    draws in the shapes of the JAX init (``jax.eval_shape``, no compile)."""
    module = ref.make_model(ref.Config.tiny(norm))
    shapes_ = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), np.zeros((1, 16, 16, 3), np.float32)))
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            std = np.sqrt(2 / np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) * std).astype(np.float32)
        if "var" in name:
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (float("scale" in name) + 0.1 * rng.randn(*s.shape)).astype(
            np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes_)
    state = port.params_from_flax(variables["params"],
                                  variables.get("batch_stats"))
    return module, variables, state


def _jax_scores(module, variables, images):
    return np.asarray(jax.jit(module.apply)(variables, images))


def _images(n, seed=1):
    return np.random.RandomState(seed).rand(n, 16, 16, 3).astype(np.float32)


def _executor_state(_):
    from tensorflowonspark_torch import serving as s

    return [{k[1]: sorted(v) for k, v in s._SEEN_SHAPES.items()}]


def test_transform_matches_jax_forward(tmp_path, monkeypatch):
    """23 rows in ragged partitions (7, 8, 8) over two spawned executors,
    batch 8 with buckets [4, 8]: every row scored, in order, as the JAX
    forward scores it."""
    monkeypatch.setenv(util.DEVICE_ENV, "cpu")
    module, variables, state = _weights("group")
    export = str(tmp_path / "export")
    compat.export_saved_model(state, export)
    images = _images(23)
    sc = sparkapi.LocalSparkContext("local[2]")
    try:
        spark = sparkapi.LocalSparkSession(sc)
        df = spark.createDataFrame(
            [{"id": i, "image": images[i]} for i in range(23)]).repartition(3)
        assert [len(p) for p in df.rdd._partitions] == [7, 8, 8]
        out = (pipeline.TFModel().setModelName("resnet50")
               .setExportDir(export).setBatchSize(8).setBucketSizes([4, 8])
               .setInputMapping({"image": "image"}).transform(df))
        assert out.columns == ["prediction"]
        rows = out.collect()
        seen = sc.parallelize([0, 1], 2).mapPartitions(
            _executor_state).collect()
    finally:
        sc.stop()
    # collect() keeps partition order on the local substrate: row i is id i
    got = np.array([r.prediction for r in rows])
    want = _jax_scores(module, variables, images)
    assert got.shape == want.shape == (23, 10)
    # f32 both sides (measured max abs ~5e-7)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # every partition padded to the 8-row bucket: one signature per executor
    want_sig = shapes.enumerate_signatures(
        {"image": ((16, 16, 3), np.float32)}, [8])
    assert [d["model:resnet50"] for d in seen] == [want_sig, want_sig]


@pytest.mark.parametrize("norm", ["group", "batch"])
def test_run_model_buckets_and_norm_choice(tmp_path, monkeypatch, norm):
    """In process: 11 rows at batch 8 → chunks of 8 and 3, padded to the
    buckets 8 and 4 and masked back; an export with ``collections`` serves
    the BatchNorm config.  Signatures seen == the ladder's."""
    monkeypatch.setenv(util.DEVICE_ENV, "cpu")
    module, variables, state = _weights(norm, seed=3)
    assert ("collections" in state) == (norm == "batch")
    export = str(tmp_path / "export")
    compat.export_saved_model(state, export)
    images = _images(11, seed=4)
    rows = [sparkapi.Row(id=i, image=images[i]) for i in range(11)]
    run = pipeline._RunModel(export, "resnet50", None, 8,
                             {"image": "image"}, None, ["id", "image"],
                             bucket_sizes=[4])
    out = list(run(iter(rows)))
    got = np.array([r.prediction for r in out])
    np.testing.assert_allclose(got, _jax_scores(module, variables, images),
                               rtol=1e-5, atol=1e-5)
    model = pipeline._MODEL_CACHE[run._cache_key][1]
    assert model.norm.batch == (norm == "batch")
    assert serving._SEEN_SHAPES[run._cache_key] == set(
        shapes.enumerate_signatures({"image": ((16, 16, 3), np.float32)},
                                    (4, 8)))


def test_warmup_runs_every_bucket(tmp_path, monkeypatch):
    monkeypatch.setenv(util.DEVICE_ENV, "cpu")
    _module, _variables, state = _weights("group", seed=5)
    export = str(tmp_path / "export")
    compat.export_saved_model(state, export)
    tfm = (pipeline.TFModel().setModelName("resnet50").setExportDir(export)
           .setBatchSize(8).setBucketSizes([2, 4]))
    assert tfm.warmup() == [2, 4, 8]
    key = pipeline.model_cache_key(export, "resnet50")
    assert serving._SEEN_SHAPES[key] == set(shapes.enumerate_signatures(
        shapes.model_specs("resnet50", tiny=True), (2, 4, 8)))


def test_cuda_request_without_card_raises(tmp_path, monkeypatch):
    """No fallback: a transform asked to run on a missing card fails."""
    monkeypatch.delenv(util.DEVICE_ENV, raising=False)
    monkeypatch.setattr(util.torch.cuda, "is_available", lambda: False)
    _module, _variables, state = _weights("group")
    compat.export_saved_model(state, str(tmp_path))
    rows = [sparkapi.Row(image=_images(1)[0])]
    run = pipeline._RunModel(str(tmp_path), "resnet50", None, 8,
                             {"image": "image"}, None, ["image"])
    with pytest.raises(RuntimeError, match="is_available"):
        list(run(iter(rows)))


def test_export_round_trip(tmp_path):
    state = {"params": {"conv.weight": np.arange(6, dtype=np.float32)
                        .reshape(2, 3), "head.bias": np.zeros(4, np.float32)},
             "collections": {"batch_stats": {"norm.mean": np.ones(3)}}}
    path = compat.export_saved_model(state, str(tmp_path))
    assert path == os.path.join(str(tmp_path), "model")
    back = ckpt.load_pytree(path)
    assert back.keys() == state.keys()
    for group in ("params", "collections"):
        flat_a = dict(ckpt._flatten(state[group]))
        flat_b = dict(ckpt._flatten(back[group]))
        assert flat_a.keys() == flat_b.keys()
        for k in flat_a:
            assert isinstance(flat_b[k], np.ndarray)
            np.testing.assert_array_equal(flat_a[k], flat_b[k])
            assert flat_a[k].dtype == flat_b[k].dtype
    with pytest.raises(ValueError, match="holds"):
        ckpt.save_pytree({"a/b": np.zeros(1)}, str(tmp_path / "bad"))


def test_is_tiny_detects_the_export_geometry():
    """The export's geometry picks the config ``TFModel`` rebuilds:
    ``resnet.config_from_state`` (the rule moved there from the
    pipeline) — tiny or full by the parameter shapes, BatchNorm where the
    export carries statistics."""
    tiny = port.state_of(port.make_model(port.Config.tiny()))
    with torch.device("meta"):  # shapes only
        full = dict(port.ResNet(port.Config()).named_parameters())
    assert port.config_from_state(tiny) == port.Config.tiny()
    assert port.config_from_state({"params": full}) == port.Config()
    batch = port.state_of(port.make_model(port.Config.tiny("batch")))
    assert port.config_from_state(batch) == port.Config.tiny("batch")
