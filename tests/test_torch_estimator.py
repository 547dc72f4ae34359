"""``TFEstimator.fit`` → ``TFModel.transform`` for the tiny wide&deep, on
the local Spark substrate, on the CPU.

The same code ``chip_smoke.py`` drives on the card at full width
(``chip_smoke.criteo_train_fn``, a port of ``examples/criteo/
criteo_pipeline.py::train_fun``, and ``chip_smoke.fit_and_score``): two
executors form a gloo group (``TFOS_TORCH_DISTRIBUTED=1``) and train from
the DataFrame's partitions through ``DataFeed``; the chief exports; the
returned ``TFModel`` scores the DataFrame from the export.  Real processes:
executors, their managers and the spawned trainers.
"""

import os
import sys

import cloudpickle
import numpy as np
import pytest
import torch

import chip_smoke
from tensorflowonspark_torch import ckpt, pipeline, sparkapi
from tensorflowonspark_torch.models import widedeep

cloudpickle.register_pickle_by_value(sys.modules[__name__])
cloudpickle.register_pickle_by_value(chip_smoke)

ROWS = 64  # 32 a partition
BATCH = 8
LR = 1e-2


@pytest.fixture()
def sc(monkeypatch):
    """Two executors on the CPU (they inherit the environment at start);
    the pickled feed transport leaves nothing in /dev/shm, where other
    tests check for segments."""
    monkeypatch.setenv("TFOS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("TFOS_TORCH_DISTRIBUTED", "1")
    monkeypatch.setenv("TFOS_FEED_SHM", "0")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ctx = sparkapi.LocalSparkContext("local[2]", "torch-estimator-test")
    yield ctx
    ctx.stop()


def _replay(rows, table_update):
    """One process stepping the global batches: batch i is rank 0's i-th
    batch then rank 1's (partition r feeds rank r)."""
    import dataclasses

    from tensorflowonspark_torch.trainer import Trainer

    config = dataclasses.replace(widedeep.Config.tiny(), table_lr=LR * 10,
                                 table_update=table_update)
    t = Trainer("wide_deep", config=config, learning_rate=LR, device="cpu")
    half = ROWS // 2
    losses = []
    for lo in range(0, half, BATCH):
        part = rows[lo:lo + BATCH] + rows[half + lo:half + lo + BATCH]
        losses.append(float(t.step(chip_smoke.rows_to_batch(part))))
    return losses


@pytest.mark.parametrize("table_update", ["dense", "sparse"])
def test_fit_then_transform_the_tiny_wide_deep(sc, tmp_path, table_update):
    torch.set_num_threads(1)
    rows = chip_smoke.synth_criteo(ROWS, widedeep.Config.tiny().hash_buckets,
                                   seed=0)
    df = sparkapi.LocalSparkSession(sc).createDataFrame(
        rows, ["dense", "cat", "label"]).repartition(2)
    export_dir = str(tmp_path / "export")
    cluster, published, scored = chip_smoke.fit_and_score(
        sc, df, {"lr": LR, "tiny": True, "table_update": table_update},
        BATCH, 2, export_dir)

    steps = ROWS // 2 // BATCH
    for node in published:
        assert node["state"] == "finished"
        assert node["device"] == "cpu"
        # the CPU runs the plain table update: no kernel launch
        assert node["launches"] == {"group": 0, "sparse": 0, "combine": 0}
        assert len(node["losses"]) == steps
    assert published[0]["losses"] == published[1]["losses"]  # all-reduced
    np.testing.assert_allclose(published[0]["losses"],
                               _replay(rows, table_update), rtol=1e-5)
    assert cluster.metrics()["total_examples_per_sec"] > 0

    # the chief's export: params and tables, no accumulators
    state = ckpt.load_pytree(os.path.join(export_dir, "model"))
    assert sorted(state["collections"]) == ["embedding"]
    served = widedeep.load_state(widedeep.make_model(
        widedeep.config_from_state(state)), state)
    want = widedeep.make_forward_fn(served, served.config)(
        served, {k: torch.from_numpy(v)
                 for k, v in chip_smoke.rows_to_batch(rows).items()})
    got = np.array([r.ctr for r in scored])  # partition order = row order
    assert got.shape == (ROWS,)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-6)


def test_estimator_params_reach_train_fn_and_model():
    """``merge_args``: the params set on the estimator and ``tf_args`` (which
    win) in one namespace; ``_copyValues``: the values the model shares."""
    est = (pipeline.TFEstimator(lambda args, ctx: None,
                                tf_args={"lr": 0.5, "batch_size": 3})
           .setBatchSize(8).setEpochs(2).setExportDir("/x")
           .setModelName("wide_deep"))
    args = est.merge_args()
    assert (args.lr, args.batch_size, args.epochs, args.export_dir) == \
        (0.5, 3, 2, "/x")
    assert args.master_node == "chief" and args.cluster_size == 1
    model = est._copyValues(pipeline.TFModel())
    assert model.getExportDir() == "/x" and model.getBatchSize() == 8
    assert model.getModelName() == "wide_deep"
