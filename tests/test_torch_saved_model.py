"""Self-describing exports of the port (``tensorflowonspark_torch.
saved_model``): a ``torch.export`` forward beside the weights, served with
no model code.

Ports of the jax-free cases of ``tests/test_saved_model.py`` (their names
kept), with a torch toy forward that exists only in this module; the
fault the remote cache key had (a re-export to the same ``://`` path kept
serving the old model); the JAX package's serialized forward against the
port's on the same weights and inputs (tiny ResNet in bf16, relative L2
2e-2: the two frameworks round at other places; tiny wide&deep in f32,
1e-5); and the exported ResNet's graph, which must call
``tfos.group_norm_act`` at every norm site and hold no plain group-norm
op (on the card that op is the kernel).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tensorflowonspark_torch import (TFNode, ckpt, compat, fs, pipeline,
                                     saved_model, util)
from tensorflowonspark_torch.models import resnet, widedeep

from test_torch_ckpt import MemFS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv(util.DEVICE_ENV, "cpu")
    yield
    torch.set_num_threads(threads)


def _toy_forward():
    """A forward that exists only inside this test module, not a zoo
    entry."""

    def fwd(state, batch):
        p = state["params"]
        h = torch.tanh(batch["x"] @ p["w"] + p["b"])
        return {"score": h.sum(dim=-1), "hidden": h}

    return fwd


def _toy_state(seed=0):
    rng = np.random.RandomState(seed)
    return {"params": {"w": rng.randn(5, 3).astype(np.float32),
                       "b": rng.randn(3).astype(np.float32)}}


def _expect(fwd, state, x):
    t = {"params": {k: torch.from_numpy(v)
                    for k, v in state["params"].items()}}
    with torch.no_grad():
        return {k: v.numpy() for k, v in fwd(
            t, {"x": torch.from_numpy(np.asarray(x, np.float32))}).items()}


def _export_toy(d, **kw):
    compat.export_saved_model(
        _toy_state(**kw), d, forward_fn=_toy_forward(),
        example_batch={"x": np.zeros((2, 5), np.float32)})


def test_export_forward_polymorphic_roundtrip(tmp_path):
    fwd, state = _toy_forward(), _toy_state()
    d = str(tmp_path / "exp")
    _export_toy(d)
    assert saved_model.has_forward(d)
    fn, sig = saved_model.load_forward(d)
    assert sig["format"] == saved_model.FORMAT
    assert sig["batch"] == "polymorphic"
    # any batch size serves, 1 included (torch specializes 0 and 1 unless
    # the export's example batch is larger)
    for n in (1, 4, 7):
        x = np.random.RandomState(n).randn(n, 5).astype(np.float32)
        out = fn(state, {"x": x})
        expect = _expect(fwd, state, x)
        np.testing.assert_allclose(out["score"].numpy(), expect["score"],
                                   atol=1e-6)
        np.testing.assert_allclose(out["hidden"].numpy(), expect["hidden"],
                                   atol=1e-6)


def test_one_row_example_still_exports_a_symbolic_batch(tmp_path):
    """torch.export specializes a dimension of size 1: a one-row example
    batch (the MNIST example's) still gives a polymorphic program, not one
    the loader calls a row at a time."""
    fwd, state = _toy_forward(), _toy_state()
    d = str(tmp_path / "exp")
    compat.export_saved_model(state, d, forward_fn=fwd,
                              example_batch={"x": np.zeros((1, 5),
                                                           np.float32)})
    fn, sig = saved_model.load_forward(d)
    assert sig["batch"] == "polymorphic"
    assert sig["inputs"] == [{"name": "x", "shape": [None, 5],
                              "dtype": "float32"}]
    for n in (1, 7):
        x = np.random.RandomState(n).randn(n, 5).astype(np.float32)
        out = fn(state, {"x": x})
        expect = _expect(fwd, state, x)
        np.testing.assert_allclose(out["score"].numpy(), expect["score"],
                                   atol=1e-6)


def test_signature_records_io(tmp_path):
    d = str(tmp_path / "exp")
    saved_model.export_forward(
        _toy_forward(), _toy_state(), {"x": np.zeros((2, 5), np.float32)}, d,
        model_name="custom")
    sig = saved_model.read_signature(d)
    assert sig["model_name"] == "custom"
    assert sig["inputs"] == [
        {"name": "x", "shape": [None, 5], "dtype": "float32"}]
    # the forward's own output order, each with its batch flag
    assert [(o["name"], o["shape"], o["dtype"], o["batched"])
            for o in sig["outputs"]] == [
        ("score", [None], "float32", True),
        ("hidden", [None, 3], "float32", True)]
    assert sig["platforms"] == ["cpu", "cuda"]
    assert len(sig["export_id"]) == 32


def test_fixed_batch_export_chunk_pads(tmp_path):
    fwd, state = _toy_forward(), _toy_state()
    d = str(tmp_path / "exp")
    saved_model.export_forward(fwd, state,
                               {"x": np.zeros((4, 5), np.float32)}, d,
                               poly_batch=False)
    fn, sig = saved_model.load_forward(d)
    assert sig["batch"] == 4
    for n in (2, 4, 7):  # 7 rows: two chunks, the tail padded and cut
        x = np.random.RandomState(n).randn(n, 5).astype(np.float32)
        out = fn(state, {"x": x})
        assert tuple(out["score"].shape) == (n,)
        np.testing.assert_allclose(out["score"].numpy(),
                                   _expect(fwd, state, x)["score"], atol=1e-6)


def test_fixed_batch_handles_batch_independent_outputs(tmp_path):
    def fwd(state, batch):
        h = batch["x"] @ state["params"]["w"]
        return {"score": h.sum(dim=-1),
                "temperature": torch.full((), 2.5),
                "bias_vec": state["params"]["b"] * 1.0}  # (3,), no batch

    state = _toy_state()
    d = str(tmp_path / "exp")
    saved_model.export_forward(fwd, state,
                               {"x": np.zeros((4, 5), np.float32)}, d,
                               poly_batch=False)
    fn, sig = saved_model.load_forward(d)
    assert sig["batch"] == 4
    out = fn(state, {"x": np.random.RandomState(0).randn(7, 5)})
    assert tuple(out["score"].shape) == (7,)
    assert float(out["temperature"]) == 2.5
    np.testing.assert_allclose(out["bias_vec"].numpy(),
                               state["params"]["b"], atol=1e-6)


def test_fixed_batch_respects_signature_batched_flags(tmp_path):
    """A batch-independent output whose leading dim coincides with the
    fixed batch round-trips unchanged: the signature's flags, not a shape
    heuristic, decide what is concatenated across chunks."""

    def fwd(state, batch):
        h = batch["x"] @ state["params"]["w"]
        return {"score": h.sum(dim=-1),
                "wT_slice": state["params"]["w"].T[:4] * 1.0}  # (4, 5)

    state = {"params": {"w": np.random.RandomState(3)
                        .randn(5, 4).astype(np.float32)}}
    d = str(tmp_path / "exp")
    saved_model.export_forward(fwd, state,
                               {"x": np.zeros((4, 5), np.float32)}, d,
                               poly_batch=False)
    fn, sig = saved_model.load_forward(d)
    assert {o["name"]: o.get("batched") for o in sig["outputs"]} == {
        "score": True, "wT_slice": False}
    out = fn(state, {"x": np.random.RandomState(0).randn(11, 5)})
    assert tuple(out["score"].shape) == (11,)
    np.testing.assert_allclose(out["wT_slice"].numpy(),
                               state["params"]["w"].T[:4], atol=1e-6)


def test_scalar_input_signature_keeps_true_shape(tmp_path):
    def fwd(state, batch):
        return {"y": batch["x"] * batch["scale"] @ state["params"]["w"]}

    state = {"params": {"w": np.eye(5, 2, dtype=np.float32)}}
    d = str(tmp_path / "exp")
    saved_model.export_forward(
        fwd, state, {"x": np.zeros((4, 5), np.float32),
                     "scale": np.float32(2.0)}, d)
    sig = saved_model.read_signature(d)
    assert sig["batch"] == "polymorphic"
    shapes = {i["name"]: i["shape"] for i in sig["inputs"]}
    assert shapes == {"x": [None, 5], "scale": []}
    fn, _ = saved_model.load_forward(d)
    out = fn(state, {"x": np.ones((3, 5), np.float32),
                     "scale": np.float32(3.0)})
    np.testing.assert_allclose(out["y"].numpy(), np.full((3, 2), 3.0))


def test_remote_reexport_invalidates_model_cache():
    """Re-exporting to the SAME remote path changes the executor cache
    token (the signature's fingerprint embeds a fresh export_id)."""
    mem = MemFS()
    fs.register("mock", mem)
    try:
        fwd, state = _toy_forward(), _toy_state()
        example = {"x": np.zeros((2, 5), np.float32)}
        d = "mock://models/exp"
        saved_model.export_forward(fwd, state, example, d)
        t1 = pipeline._cache_token(d, d)
        assert t1 == pipeline._cache_token(d, d)  # stable between reads
        saved_model.export_forward(fwd, state, example, d)  # same path
        assert pipeline._cache_token(d, d) != t1
        # weights-only remote export: the documented 0.0, no crash
        assert pipeline._cache_token("mock://models/nothing",
                                     "mock://models/nothing") == 0.0
    finally:
        fs.unregister("mock")


def test_remote_reexport_serves_the_new_scores():
    """The fault the constant remote cache key had: an executor that
    served a ``://`` export goes on serving it after a re-export with new
    weights to the same path.  The second transform must serve the new
    scores."""
    mem = MemFS()
    fs.register("mock", mem)
    pipeline._MODEL_CACHE.clear()
    try:
        d = "mock://models/reexport"
        x = np.random.RandomState(4).randn(6, 5).astype(np.float32)
        rows = [{"x": x[i].tolist()} for i in range(6)]
        scores = []
        for seed in (0, 1):
            _export_toy(d, seed=seed)
            run = pipeline._RunModel(
                export_dir=d, model_name=None, predict_fn=None,
                batch_size=4, input_mapping={"x": "x"},
                output_mapping={"score": "score"}, columns=["x"],
                device="cpu")
            got = np.array([float(r["score"]) for r in run(iter(rows))])
            np.testing.assert_allclose(
                got, _expect(_toy_forward(), _toy_state(seed), x)["score"],
                atol=1e-5)
            scores.append(got)
        assert not np.allclose(scores[0], scores[1])
        assert len([k for k in pipeline._MODEL_CACHE
                    if k[0] == "mock://models/reexport/model"]) == 1
    finally:
        pipeline._MODEL_CACHE.clear()
        fs.unregister("mock")


def test_tfnode_export_rejects_typo_kwargs(tmp_path):
    d = str(tmp_path / "exp")
    with pytest.raises(TypeError, match="exmaple_batch"):
        TFNode.export_saved_model(_toy_state(), d, forward_fn=_toy_forward(),
                                  exmaple_batch={"x": np.zeros((2, 5))})
    # the documented legacy TF kwargs are no-ops, not errors
    out = TFNode.export_saved_model(_toy_state(), d, tag_set="serve",
                                    as_text=False)
    assert os.path.isdir(out)
    assert not saved_model.has_forward(d)


def test_weights_only_export_has_no_forward(tmp_path):
    d = str(tmp_path / "exp")
    compat.export_saved_model(_toy_state(), d)
    assert not saved_model.has_forward(d)
    assert saved_model.signature_fingerprint(d) is None
    with pytest.raises(FileNotFoundError):
        saved_model.read_signature(d)
    with pytest.raises(FileNotFoundError):
        saved_model.load_forward(d)


def test_corrupt_artifacts_fail_loudly(tmp_path):
    d = str(tmp_path / "exp")
    _export_toy(d)
    fdir = os.path.join(d, "saved_forward")
    with open(os.path.join(fdir, "forward.pt2"), "rb") as f:
        blob = f.read()
    with open(os.path.join(fdir, "forward.pt2"), "wb") as f:
        f.write(blob[: len(blob) // 3])  # truncated program
    with pytest.raises(Exception):
        saved_model.load_forward(d)
    with open(os.path.join(fdir, "forward.pt2"), "wb") as f:
        f.write(blob)
    with open(os.path.join(fdir, "signature.json"), "wb") as f:
        f.write(b"{not json")
    with pytest.raises(ValueError):  # json.JSONDecodeError is a ValueError
        saved_model.read_signature(d)
    with pytest.raises(ValueError):
        saved_model.load_forward(d)


def test_export_forward_requires_example_batch(tmp_path):
    with pytest.raises(ValueError, match="example_batch"):
        compat.export_saved_model(_toy_state(), str(tmp_path / "e"),
                                  forward_fn=_toy_forward())
    assert not os.path.exists(tmp_path / "e")


def test_get_meta_graph_def_carries_signature(tmp_path):
    d = str(tmp_path / "exp")
    _export_toy(d)
    meta = pipeline.get_meta_graph_def(d)
    assert meta["params/w"] == {"shape": (5, 3), "dtype": "float32"}
    sig = meta["__signature__"]
    assert sig["inputs"][0]["name"] == "x"
    assert {o["name"] for o in sig["outputs"]} == {"score", "hidden"}
    d2 = str(tmp_path / "weights_only")
    compat.export_saved_model(_toy_state(), d2)
    assert "__signature__" not in pipeline.get_meta_graph_def(d2)


def test_wrap_state_forward_arities():
    calls = []

    def plain(params, batch):
        calls.append(("plain", params))
        return batch["x"]

    def stateful(params, collections, batch):
        calls.append(("stateful", params, collections))
        return batch["x"]

    stateful.stateful = True

    serve = saved_model.wrap_state_forward(plain)
    serve({"params": {"w": 1}}, {"x": 0})
    assert calls[-1] == ("plain", {"w": 1})
    serve({"w": 2}, {"x": 0})  # bare params tree
    assert calls[-1] == ("plain", {"w": 2})
    serve_s = saved_model.wrap_state_forward(stateful)
    serve_s({"params": {"w": 1}, "collections": {"bn": 3}}, {"x": 0})
    assert calls[-1] == ("stateful", {"w": 1}, {"bn": 3})
    serve_s({"params": {"w": 1}}, {"x": 0})  # collections default to {}
    assert calls[-1] == ("stateful", {"w": 1}, {})

    # with a model: params and every collection's leaves bound by name
    class M(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(2))
            self.register_buffer("table", torch.zeros(2))

    def zoo(model, batch):
        return batch["x"] * model.w + model.table

    serve_m = saved_model.wrap_state_forward(zoo, M())
    out = serve_m({"params": {"w": torch.tensor([2.0, 3.0])},
                   "collections": {"emb": {"table": torch.ones(2)}}},
                  {"x": torch.ones(2)})
    assert out.tolist() == [3.0, 4.0]
    out = serve_m({"w": torch.tensor([1.0, 1.0])}, {"x": torch.ones(2)})
    assert out.tolist() == [1.0, 1.0]  # the model's own buffer


def test_pad_batch_is_the_one_padding_convention():
    from tensorflowonspark_torch import serving

    batch = {"x": np.ones((3, 2), np.float32), "n": np.float32(1.0),
             "big": np.zeros((5, 2))}
    out = saved_model.pad_batch(batch, 4)
    assert out["x"].shape == (4, 2)
    np.testing.assert_array_equal(out["x"][3], 0.0)
    assert out["n"].shape == ()  # 0-d carries no batch axis
    assert out["big"].shape == (5, 2)  # already ≥ target: untouched
    t = saved_model.pad_batch({"x": torch.ones(3, 2)}, 4)["x"]
    assert t.shape == (4, 2) and t[3].abs().sum() == 0
    served = serving.pad_columns(batch, 4)
    assert all(np.array_equal(served[k], out[k]) for k in out)


def test_tfmodel_transform_serves_non_zoo_export(tmp_path, monkeypatch):
    """``TFModel.transform`` with NO model_name and NO predict_fn: the
    forward comes from the artifact alone, on two spawned executors."""
    from tensorflowonspark_torch.pipeline import TFModel
    from tensorflowonspark_torch.sparkapi import (LocalSparkContext,
                                                  LocalSparkSession)

    fwd, state = _toy_forward(), _toy_state()
    d = str(tmp_path / "exp")
    _export_toy(d)
    sc = LocalSparkContext("local-cluster[2,1,1024]", "saved-model-test")
    try:
        spark = LocalSparkSession(sc)
        x = np.random.RandomState(3).randn(10, 5).astype(np.float32)
        df = spark.createDataFrame(
            [(x[i].tolist(),) for i in range(10)], ["x"]).repartition(2)
        model = (TFModel().setExportDir(d).setBatchSize(4)
                 .setInputMapping({"x": "x"})
                 .setOutputMapping({"score": "score", "hidden": "hidden"}))
        out = model.transform(df).collect()
        assert len(out) == 10
        got = np.asarray(sorted(float(r.score) for r in out), np.float32)
        want = np.asarray(sorted(_expect(fwd, state, x)["score"]),
                          np.float32)
        np.testing.assert_allclose(got, want, atol=1e-5)
    finally:
        sc.stop()


def test_explicit_predict_fn_beats_serialized_forward(tmp_path):
    d = str(tmp_path / "exp")
    _export_toy(d)

    def custom(params, batch):
        return {"score": np.full(len(batch["x"]), 42.0, np.float32)}

    key = pipeline.model_cache_key(d, "resnet50", custom)
    assert key[1] == custom.__qualname__
    assert pipeline.model_cache_key(d, "resnet50")[1] == "saved_forward"
    rm = pipeline._RunModel(export_dir=d, model_name=None, predict_fn=custom,
                            batch_size=4, input_mapping={"x": "x"},
                            output_mapping=None, columns=["x"], device="cpu")
    out = list(rm(iter([{"x": [0.0] * 5} for _ in range(3)])))
    assert [float(r["score"]) for r in out] == [42.0, 42.0, 42.0]


def test_saved_model_cli_show_and_run(tmp_path):
    fwd, state = _toy_forward(), _toy_state()
    d = str(tmp_path / "exp")
    _export_toy(d)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    show = subprocess.run(
        [sys.executable, "-m", "tensorflowonspark_torch.saved_model", "show",
         "--dir", d], capture_output=True, text=True, timeout=300, env=env,
        cwd=REPO)
    assert show.returncode == 0, show.stderr[-2000:]
    assert f'"format": "{saved_model.FORMAT}"' in show.stdout
    assert "params/w: float32[5, 3]" in show.stdout

    x = np.random.RandomState(5).randn(3, 5).astype(np.float32)
    np.savez(tmp_path / "in.npz", x=x)
    out_npz = str(tmp_path / "out.npz")
    run = subprocess.run(
        [sys.executable, "-m", "tensorflowonspark_torch.saved_model", "run",
         "--dir", d, "--inputs", str(tmp_path / "in.npz"), "--outputs",
         out_npz, "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert run.returncode == 0, run.stderr[-2000:]
    with np.load(out_npz) as z:
        np.testing.assert_allclose(z["score"], _expect(fwd, state,
                                                       x)["score"],
                                   atol=1e-6)
    weights_only = str(tmp_path / "w")
    compat.export_saved_model(state, weights_only)
    run = subprocess.run(
        [sys.executable, "-m", "tensorflowonspark_torch.saved_model", "run",
         "--dir", weights_only, "--inputs", str(tmp_path / "in.npz"),
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        env=env, cwd=REPO)
    assert run.returncode == 2 and "weights-only" in run.stderr


_EXPORTER_SCRIPT = r"""
import sys
import numpy as np
import torch
sys.path.insert(0, {repo!r})
from tensorflowonspark_torch import compat

# a private model only this subprocess ever knows about
def secret_model(state, batch):
    z = batch["feat"] @ state["params"]["proj"]
    return {{"out": torch.relu(z).mean(dim=-1)}}

rng = np.random.RandomState(42)
state = {{"params": {{"proj": rng.randn(8, 4).astype(np.float32)}}}}
compat.export_saved_model(
    state, {export_dir!r}, forward_fn=secret_model,
    example_batch={{"feat": np.zeros((2, 8), np.float32)}})
x = rng.randn(5, 8).astype(np.float32)
t = {{"params": {{"proj": torch.from_numpy(state["params"]["proj"])}}}}
expect = secret_model(t, {{"feat": torch.from_numpy(x)}})["out"].numpy()
np.savez({npz!r}, x=x, expect=expect)
"""


def test_serving_without_model_code(tmp_path):
    """Export in a subprocess whose model code this process never
    imports; serve here from the artifact alone."""
    export_dir = str(tmp_path / "exp")
    npz = str(tmp_path / "io.npz")
    script = tmp_path / "exporter.py"
    script.write_text(_EXPORTER_SCRIPT.format(repo=REPO,
                                              export_dir=export_dir, npz=npz))
    subprocess.run([sys.executable, str(script)], check=True,
                   capture_output=True, timeout=300)
    data = np.load(npz)
    state = ckpt.load_pytree(os.path.join(export_dir, "model"))
    fn, sig = saved_model.load_forward(export_dir)
    assert [i["name"] for i in sig["inputs"]] == ["feat"]
    np.testing.assert_allclose(fn(state, {"feat": data["x"]})["out"].numpy(),
                               data["expect"], atol=1e-6)


# ---------------------------------------------------------------------------
# The zoo's exports: the graph, the batch, and the JAX package's forward
# ---------------------------------------------------------------------------


def _norm_sites(config) -> int:
    """GroupNorm calls of one forward: the stem's, and 3 a block plus the
    projection's where a block changes shape."""
    model = resnet.ResNet(config)
    return 1 + sum(3 + (b.conv3 is not None) for b in model.blocks)


def _program(export_dir):
    with fs.open(os.path.join(export_dir, "saved_forward", "forward.pt2"),
                 "rb") as f:
        import io

        return torch.export.load(io.BytesIO(f.read()))


def test_exported_resnet_calls_the_group_norm_op_at_every_site(tmp_path):
    """Trap (a): the export records ``tfos.group_norm_act`` once a norm
    site, so the device's implementation runs inside the program (the
    kernel on the card), and no plain group-norm arithmetic; the program
    holds no weights."""
    from tensorflowonspark_torch.trainer import Trainer

    config = resnet.Config.tiny()
    t = Trainer("resnet50", config=config, device="cpu")
    d = str(tmp_path / "exp")
    t.export(d)
    program = _program(d)
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets.count("tfos.group_norm_act.default") == _norm_sites(
        config) == 9
    assert not [x for x in targets if "group_norm" in x and "tfos" not in x]
    assert not [x for x in targets if "var_mean" in x or "rsqrt" in x
                or "batch_norm" in x]
    assert not program.state_dict and not program.constants
    assert program.example_inputs is None
    blob = os.path.getsize(os.path.join(d, "saved_forward", "forward.pt2"))
    weights = os.path.getsize(os.path.join(d, "model", "pytree.npz"))
    print(f"forward.pt2 {blob} bytes, model/ {weights} bytes")


@pytest.mark.parametrize("name", ["resnet50", "wide_deep"])
def test_trainer_export_serves_a_batch_of_one_and_a_ragged_tail(tmp_path,
                                                                 name):
    """Trap (f): exported at a batch of 2, the program serves 1 and 5 rows
    as the trainer's own forward does, bit for bit on the CPU."""
    from tensorflowonspark_torch.trainer import Trainer

    lib = resnet if name == "resnet50" else widedeep
    config = lib.Config.tiny()
    t = Trainer(name, config=config, device="cpu")
    t.step(lib.example_batch(config, 8))
    d = str(tmp_path / "exp")
    path = t.export(d)
    fn, sig = saved_model.load_forward(d)
    assert sig["batch"] == "polymorphic" and sig["model_name"] == name
    state = ckpt.load_pytree(path)
    assert "embedding_opt" not in state.get("collections", {})
    for n in (1, 5):
        batch = {k: v for k, v in lib.example_batch(config, n, seed=n).items()
                 if k != "label"}
        torch.testing.assert_close(fn(state, batch), t.predict(batch),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("name", ["resnet50", "inception_v3"])
def test_batch_norm_export_serves_the_running_statistics(tmp_path,
                                                        monkeypatch, name):
    """A ``norm="batch"`` trainer's export: its state carries every
    running statistic under ``collections/batch_stats``, and
    ``TFModel.transform``'s executor function (``_RunModel``) serves it,
    by the serialized forward and by model name, with the bits of the
    trainer's ``predict`` (eval mode over the running statistics), on a
    ragged tail of 5 rows padded to the bucket of 8."""
    from tensorflowonspark_torch import sparkapi, util
    from tensorflowonspark_torch.models import inception
    from tensorflowonspark_torch.trainer import Trainer

    monkeypatch.setenv(util.DEVICE_ENV, "cpu")
    lib = resnet if name == "resnet50" else inception
    config = dataclasses.replace(lib.Config.tiny(), norm="batch")
    t = Trainer(name, config=config, device="cpu")
    for i in range(2):
        t.step(lib.example_batch(config, 8, seed=i))
    d = str(tmp_path / "exp")
    path = t.export(d)
    state = ckpt.load_pytree(path)
    stats = state["collections"]["batch_stats"]
    assert sorted(stats) == sorted(k for k, _ in t.model.named_buffers())
    weights_only = str(tmp_path / "weights")
    compat.export_saved_model(state, weights_only)
    images = lib.example_batch(config, 13, seed=5)["image"]
    want = torch.cat([t.predict({"image": images[:8]}),
                      t.predict({"image": np.concatenate(
                          [images[8:], np.zeros_like(images[:3])])})[:5]])
    rows = [sparkapi.Row(id=i, image=images[i]) for i in range(13)]
    for export, model_name in ((d, None), (weights_only, name)):
        run = pipeline._RunModel(export, model_name, None, 8,
                                 {"image": "image"}, None, ["id", "image"])
        got = torch.tensor(np.array([r.prediction
                                     for r in run(iter(rows))]))
        assert torch.equal(got, want), model_name


def test_resnet_forward_matches_the_jax_packages_serialized_forward(
        tmp_path):
    """The JAX package exports its tiny ResNet (bf16 compute); the port
    exports the same weights; both serialized forwards score the same
    images."""
    import jax

    from tensorflowonspark_tpu import ckpt as jax_ckpt
    from tensorflowonspark_tpu import saved_model as jax_saved_model
    from tensorflowonspark_tpu.models import resnet as ref
    from tensorflowonspark_tpu.trainer import Trainer as JaxTrainer

    config = dataclasses.replace(ref.Config.tiny(), dtype="bfloat16")
    jd, pd = str(tmp_path / "jax"), str(tmp_path / "port")
    JaxTrainer("resnet50", config=config, seed=0).export(jd)
    jax_state = jax_ckpt.load_pytree(os.path.join(jd, "model"))
    jax_fn, _ = jax_saved_model.load_forward(jd)

    port_config = resnet.Config(**dataclasses.asdict(config))
    state = resnet.params_from_flax(jax_state["params"])
    compat.export_saved_model(
        state, pd, forward_fn=saved_model.wrap_state_forward(
            resnet.serving_forward, resnet.make_serving_model(port_config)),
        example_batch={"image": np.zeros((2, 16, 16, 3), np.float32)})
    fn, _ = saved_model.load_forward(pd)
    images = np.random.RandomState(7).rand(5, 16, 16, 3).astype(np.float32)
    want = np.asarray(jax.device_get(jax_fn(jax_state, {"image": images})))
    got = fn(ckpt.load_pytree(os.path.join(pd, "model")),
             {"image": images}).numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"resnet bf16 serialized forwards: rel L2 {rel:.2e}")
    assert got.shape == want.shape == (5, 10)
    assert rel <= 2e-2


def test_wide_deep_forward_matches_the_jax_packages_serialized_forward(
        tmp_path):
    import jax

    from tensorflowonspark_tpu import ckpt as jax_ckpt
    from tensorflowonspark_tpu import saved_model as jax_saved_model
    from tensorflowonspark_tpu.models import widedeep as ref
    from tensorflowonspark_tpu.trainer import Trainer as JaxTrainer

    config = ref.Config.tiny()
    jt = JaxTrainer("wide_deep", config=config, seed=0)
    jt.step(ref.example_batch(config, 16))  # tables off their init
    jd, pd = str(tmp_path / "jax"), str(tmp_path / "port")
    jt.export(jd)
    jax_state = jax_ckpt.load_pytree(os.path.join(jd, "model"))
    jax_fn, _ = jax_saved_model.load_forward(jd)

    port_config = widedeep.Config(**dataclasses.asdict(config))
    state = widedeep.params_from_flax(jax_state["params"],
                                      jax_state["collections"])
    compat.export_saved_model(
        state, pd, forward_fn=saved_model.wrap_state_forward(
            widedeep.serving_forward,
            widedeep.make_serving_model(port_config)),
        example_batch={k: v for k, v in widedeep.example_batch(
            port_config, 2).items() if k != "label"})
    fn, _ = saved_model.load_forward(pd)
    batch = {k: v for k, v in ref.example_batch(config, 9, seed=5).items()
             if k != "label"}
    want = np.asarray(jax.device_get(jax_fn(jax_state, batch)))
    got = fn(ckpt.load_pytree(os.path.join(pd, "model")), batch).numpy()
    print(f"wide&deep serialized forwards: max |diff| "
          f"{np.abs(got - want).max():.2e}")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_warmup_reads_row_shapes_from_the_signature(tmp_path):
    from tensorflowonspark_torch import serving

    d = str(tmp_path / "exp")
    _export_toy(d)
    pipeline._MODEL_CACHE.clear()
    try:
        model = pipeline.TFModel(device="cpu").setExportDir(d).setBatchSize(
            8).setBucketSizes([4, 8])
        assert model.warmup() == [4, 8]
        [key] = list(pipeline._MODEL_CACHE)
        assert key[1] == "saved_forward"
        assert sorted(s[0][1] for s in serving._SEEN_SHAPES[key]) == [
            (4, 5), (8, 5)]
    finally:
        pipeline._MODEL_CACHE.clear()


def test_signature_json_is_plain_json(tmp_path):
    d = str(tmp_path / "exp")
    _export_toy(d)
    with open(os.path.join(d, "saved_forward", "signature.json")) as f:
        assert json.load(f)["format"] == saved_model.FORMAT


# ---------------------------------------------------------------------------
# infer_embed, the in-process endpoint of the C-ABI shim (ports of the
# reference's tests/test_saved_model.py cases, their names kept), and its
# parity with the JAX package's on the same weights
# ---------------------------------------------------------------------------


def test_infer_embed_serves_self_describing_export(tmp_path):
    from tensorflowonspark_torch import infer_embed

    fwd, state = _toy_forward(), _toy_state()
    d = str(tmp_path / "exp")
    _export_toy(d)
    h = infer_embed.load(d)  # note: NO model_name
    try:
        assert infer_embed.input_names(h) == "x"
        x = np.random.RandomState(1).randn(6, 5).astype(np.float32)
        infer_embed.set_input(h, "x", x.tobytes(), (6, 5), 0)
        infer_embed.run(h)
        assert infer_embed.output_shape(h) == (6,)
        got = np.frombuffer(infer_embed.get_output(h), np.float32)
        np.testing.assert_allclose(got, _expect(fwd, state, x)["score"],
                                   atol=1e-6)
        # every named output, the signature's declared order first
        names = [infer_embed.output_name(h, i)
                 for i in range(infer_embed.output_count(h))]
        assert sorted(names) == ["hidden", "score"]
        assert infer_embed.output_shape(h, "hidden") == (6, 3)
        np.testing.assert_allclose(
            np.frombuffer(infer_embed.get_output(h, "hidden"),
                          np.float32).reshape(6, 3),
            _expect(fwd, state, x)["hidden"], atol=1e-6)
        with pytest.raises(KeyError, match="unknown output"):
            infer_embed.get_output(h, "nope")
        with pytest.raises(IndexError):
            infer_embed.output_name(h, 5)
        with pytest.raises(KeyError, match="unknown input"):
            infer_embed.set_input(h, "y", x.tobytes(), (6, 5), 0)
        with pytest.raises(ValueError, match="not set before run"):
            infer_embed.run(h)
    finally:
        infer_embed.close(h)


def test_infer_embed_buckets_drifting_batch_sizes(tmp_path, monkeypatch):
    from tensorflowonspark_torch import infer_embed, serving

    monkeypatch.delenv("TFOS_INFER_BUCKETS", raising=False)
    fwd, state = _toy_forward(), _toy_state()
    d = str(tmp_path / "exp")
    _export_toy(d)
    h = infer_embed.load(d)
    rng = np.random.RandomState(7)
    try:
        for n in (3, 5, 6, 7, 9, 11, 13):  # 7 distinct sizes
            x = rng.randn(n, 5).astype(np.float32)
            infer_embed.set_input(h, "x", x.tobytes(), (n, 5), 0)
            infer_embed.run(h)
            assert infer_embed.output_shape(h) == (n,)  # sliced, not padded
            got = np.frombuffer(infer_embed.get_output(h), np.float32)
            np.testing.assert_allclose(got, _expect(fwd, state, x)["score"],
                                       atol=1e-6)
        # the first TWO distinct sizes (3, 5) run at their true shape, the
        # per-example evidence; then everything pads to 8 and 16
        assert len(serving._SEEN_SHAPES[("infer_embed", h)]) == 4
    finally:
        infer_embed.close(h)
    assert ("infer_embed", h) not in serving._SEEN_SHAPES


def test_infer_embed_never_pads_aggregating_forward(tmp_path, monkeypatch):
    from tensorflowonspark_torch import infer_embed

    monkeypatch.delenv("TFOS_INFER_BUCKETS", raising=False)

    def fwd(state, batch):
        # a mean over the batch axis: zero padding rows would skew it
        return {"pooled": torch.tanh(batch["x"] @ state["params"]["w"]
                                     ).mean(dim=0)}

    state = _toy_state()  # w: (5, 3) → pooled dim 3
    d = str(tmp_path / "exp")
    compat.export_saved_model(state, d, forward_fn=fwd,
                              example_batch={"x": np.zeros((2, 5),
                                                           np.float32)})
    h = infer_embed.load(d)
    rng = np.random.RandomState(11)
    w = torch.from_numpy(state["params"]["w"])
    try:
        # n=3 first: the pooled dim equals the batch size (one
        # coincidence must not enable padding); n=5 disables it
        for n in (3, 5, 4):
            x = rng.randn(n, 5).astype(np.float32)
            infer_embed.set_input(h, "x", x.tobytes(), (n, 5), 0)
            infer_embed.run(h)
            assert infer_embed.output_shape(h) == (3,)
            got = np.frombuffer(infer_embed.get_output(h), np.float32)
            want = torch.tanh(torch.from_numpy(x) @ w).mean(dim=0).numpy()
            np.testing.assert_allclose(got, want, atol=1e-6)
    finally:
        infer_embed.close(h)


def test_infer_embed_bucketing_opt_out(tmp_path, monkeypatch):
    from tensorflowonspark_torch import infer_embed, serving

    monkeypatch.setenv("TFOS_INFER_BUCKETS", "0")
    fwd, state = _toy_forward(), _toy_state()
    d = str(tmp_path / "exp")
    _export_toy(d)
    h = infer_embed.load(d)
    try:
        x = np.random.RandomState(1).randn(3, 5).astype(np.float32)
        infer_embed.set_input(h, "x", x.tobytes(), (3, 5), 0)
        infer_embed.run(h)
        assert infer_embed.output_shape(h) == (3,)
        got = np.frombuffer(infer_embed.get_output(h), np.float32)
        np.testing.assert_allclose(got, _expect(fwd, state, x)["score"],
                                   atol=1e-6)
        assert ("infer_embed", h) not in serving._SEEN_SHAPES
    finally:
        infer_embed.close(h)


def test_infer_embed_weights_only_needs_model_name(tmp_path):
    from tensorflowonspark_torch import infer_embed

    d = str(tmp_path / "exp")
    compat.export_saved_model(_toy_state(), d)
    with pytest.raises(ValueError, match="weights-only"):
        infer_embed.load(d)


def test_infer_embed_weights_only_serves_by_model_name(tmp_path):
    """A weights-only zoo export and ``model_name``: the zoo's forward at
    the config the weights imply, its input names from the zoo's example
    batch, the f32 output contract."""
    from tensorflowonspark_torch import infer_embed

    config = widedeep.Config.tiny()
    model = widedeep.make_model(config, seed=3)
    d = str(tmp_path / "exp")
    compat.export_saved_model(widedeep.state_of(model), d)
    h = infer_embed.load(d, "wide_deep")
    try:
        assert infer_embed.input_names(h) == "dense,cat"
        batch = widedeep.example_batch(config, 5, seed=2)
        for name, code in (("dense", 0), ("cat", 1)):
            infer_embed.set_input(h, name, batch[name].tobytes(),
                                  batch[name].shape, code)
        infer_embed.run(h)
        got = np.frombuffer(infer_embed.get_output(h), np.float32)
        with torch.no_grad():
            want = widedeep.serving_forward(model.eval(), {
                k: torch.from_numpy(v) for k, v in batch.items()}).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)
    finally:
        infer_embed.close(h)


def test_infer_embed_matches_the_jax_packages_infer_embed(tmp_path,
                                                          monkeypatch):
    """The JAX package's tiny GroupNorm ResNet (f32), exported by its
    ``Trainer``; the same weights exported by the port: both packages'
    ``infer_embed`` score the same seeded rows at drifting batch sizes
    (their bucketing included) within the f32 tolerance of the TFModel
    parity test (rtol and atol 1e-5)."""
    from tensorflowonspark_torch import infer_embed
    from tensorflowonspark_tpu import ckpt as jax_ckpt
    from tensorflowonspark_tpu import infer_embed as ref_embed
    from tensorflowonspark_tpu.models import resnet as ref
    from tensorflowonspark_tpu.trainer import Trainer as JaxTrainer

    monkeypatch.delenv("TFOS_INFER_BUCKETS", raising=False)
    config = ref.Config.tiny()
    jd, pd = str(tmp_path / "jax"), str(tmp_path / "port")
    JaxTrainer("resnet50", config=config, seed=0).export(jd)
    jax_state = jax_ckpt.load_pytree(os.path.join(jd, "model"))
    port_config = resnet.Config(**dataclasses.asdict(config))
    compat.export_saved_model(
        resnet.params_from_flax(jax_state["params"]), pd,
        forward_fn=saved_model.wrap_state_forward(
            resnet.serving_forward, resnet.make_serving_model(port_config)),
        example_batch={"image": np.zeros((2, 16, 16, 3), np.float32)})
    hj, hp = ref_embed.load(jd), infer_embed.load(pd)
    rng = np.random.RandomState(13)
    try:
        assert ref_embed.input_names(hj) == infer_embed.input_names(hp)
        for n in (1, 3, 5, 6):
            x = rng.rand(n, 16, 16, 3).astype(np.float32)
            outs = []
            for mod, h in ((ref_embed, hj), (infer_embed, hp)):
                mod.set_input(h, "image", x.tobytes(), x.shape, 0)
                mod.run(h)
                assert mod.output_shape(h) == (n, 10)
                outs.append(np.frombuffer(mod.get_output(h), np.float32))
            np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5,
                                       atol=1e-5, err_msg=f"{n} rows")
    finally:
        ref_embed.close(hj)
        infer_embed.close(hp)
