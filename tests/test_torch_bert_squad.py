"""The port's ``examples/bert_squad.py`` on CPU executors: ``synth_squad``
against the JAX example's, ``main`` (``--tiny``, two executors,
``InputMode.SPARK``) with each node's published loss and steps, its
self-describing export served by ``TFModel.transform`` against the
forward in process, and the reference's mesh flags beyond data
parallelism refused."""

import importlib.util
import os
import types

import numpy as np
import pytest
import torch

from tensorflowonspark_torch import ckpt, pipeline
from tensorflowonspark_torch.examples import bert_squad
from tensorflowonspark_torch.models import bert
from tensorflowonspark_torch.sparkapi import (LocalSparkContext,
                                              LocalSparkSession)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: served f32 logits against the forward in process: the same ops on
#: batches of another size
SCORES_ABS = 1e-5
ROWS, SEQ, BATCH = 40, 64, 8


@pytest.fixture()
def cpu_env(monkeypatch):
    monkeypatch.setenv("TFOS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    pipeline._MODEL_CACHE.clear()


def _reference_example():
    path = os.path.join(REPO, "examples", "bert", "bert_squad.py")
    spec = importlib.util.spec_from_file_location("ref_bert_squad", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("args", [(30, 128, 64, 0), (7, 30522, 384, 5)])
def test_synth_squad_equals_the_reference(args):
    want = _reference_example().synth_squad(*args)
    got = bert_squad.synth_squad(*args)
    assert got == want
    for ids, types_, mask, s, e in got:
        length = sum(mask)
        assert ids[length - 1] != 0 and not any(ids[length:])
        assert length // 2 <= s <= e < length  # labels inside the row


def test_unsupported_mesh_flags_raise():
    for flags in (["--tp", "2"], ["--sp", "2"], ["--pp", "2"],
                  ["--fsdp", "4"], ["--ep", "2", "--moe_experts", "4"],
                  ["--moe_experts", "2"]):
        with pytest.raises(NotImplementedError, match="item 6"):
            bert_squad.main(flags + ["--tiny"])
    args = bert_squad.parse_args(["--tp", "2"])
    with pytest.raises(NotImplementedError, match="--tp"):
        bert_squad.map_fun(args, types.SimpleNamespace())
    bert_squad.check_parallelism(bert_squad.parse_args(["--dp", "2"]))


def _serve(export_dir, rows):
    """``TFModel.transform`` of ``rows`` (3 partitions) on two executors
    from the export alone: the two output columns in row order."""
    sc = LocalSparkContext("local-cluster[2,1,1024]", "bert-serving")
    try:
        df = LocalSparkSession(sc).createDataFrame(
            [dict(zip(bert_squad.COLUMNS[:3], r[:3])) for r in rows]
        ).repartition(3)
        model = (pipeline.TFModel(device="cpu").setExportDir(export_dir)
                 .setBatchSize(4).setInputMapping(
                     {c: c for c in bert_squad.COLUMNS[:3]}))
        out = model.transform(df).collect()
    finally:
        sc.stop()
    assert len(out) == len(rows)
    assert set(out[0].asDict()) == {"output_0", "output_1"}
    return (np.asarray([r.output_0 for r in out]),
            np.asarray([r.output_1 for r in out]))


def test_main_trains_on_two_executors_and_the_export_serves(tmp_path,
                                                            cpu_env):
    export = str(tmp_path / "export")
    out = bert_squad.main(["--tiny", "--cluster_size", "2", "--epochs", "2",
                           "--num_samples", str(ROWS), "--seq_len",
                           str(SEQ), "--batch_size", str(BATCH),
                           "--model_dir", export])
    assert sorted(out) == ["chief:0", "worker:0"]
    # 20 rows a partition and epoch: 2 full batches, the tail dropped
    assert [n["steps"] for n in out.values()] == [4, 4]
    assert all(np.isfinite(n["final_loss"]) for n in out.values())

    rows = bert_squad.synth_squad(9, bert.Config.tiny().vocab_size, SEQ,
                                  seed=3)
    rows.append(([0] * SEQ, [0] * SEQ, [0] * SEQ, 0, 0))  # all padding
    start, end = _serve(export, rows)
    state = ckpt.load_pytree(os.path.join(export, "model"))
    config = bert.config_from_state(state)
    assert config == bert.Config.tiny()
    model = bert.load_state(bert.make_model(config), state).eval()
    batch = {c: torch.tensor([r[i] for r in rows])
             for i, c in enumerate(bert_squad.COLUMNS[:3])}
    want = bert.make_forward_fn(model, config)(model, batch)
    for got, w in zip((start, end), want):
        assert got.shape == (len(rows), SEQ)
        np.testing.assert_allclose(got, w.numpy(), rtol=0, atol=SCORES_ABS)
    assert np.all(start[-1] == np.float32(bert.MASKED))
