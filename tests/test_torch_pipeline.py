"""The port's serving planes against the JAX package's: the
``TFModel.transform`` slice and the token-level decode tier.

The port runs on its own local Spark substrate (spawned executors) with
``TFOS_TORCH_DEVICE=cpu``; the reference is the JAX package's tiny ResNet
forward on the same weights (converted) and the same images.  The decode
tier's section below says what it holds.
"""

import functools
import json
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from tensorflowonspark_torch import (ckpt, compat, decode, online, pipeline,
                                     serving, shapes, sparkapi, util)
from tensorflowonspark_torch.models import resnet as port
from tensorflowonspark_torch.models import tinylm
from tensorflowonspark_tpu import decode as ref_decode
from tensorflowonspark_tpu import online as ref_online
from tensorflowonspark_tpu import shapes as ref_shapes
from tensorflowonspark_tpu.models import resnet as ref
from tensorflowonspark_tpu.models import tinylm as ref_tinylm


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


# ---------------------------------------------------------------------------
# The decode tier (``tensorflowonspark_torch.decode``), the token-level
# serving plane
# ---------------------------------------------------------------------------
#
# Ported from the reference's ``tests/test_decode.py`` and
# ``tests/test_decode_prefill.py`` (less speculation and the mesh router,
# which wait for their slices), plus the parity the port owes: the CPU
# ``DecodeEngine``'s greedy streams equal the JAX ``DecodeEngine``'s on the
# same weights (``tinylm.params_from_flax``) over a mixed workload with
# shared prefixes and a mid-page copy-on-write.  Every engine a test makes
# is held at teardown to the KV-pool contract: no leaked page, the
# conservation law, and pools whose bytes and storage (``data_ptr``) never
# moved — the captured graphs on the card write them in place.  On the card
# the engine captures each signature into a CUDA graph; here a stand-in
# graph backend (``StandInGraphs``) exercises the capture-and-replay
# bookkeeping.

DECODE_CFG = tinylm.Config.tiny()


class StandInGraphs:
    """The engine's graph backend on the CPU: a capture runs the step
    once (its writes to the pools are the ones the eager call just made,
    so they change nothing) and keeps it; a replay reruns it on the
    static inputs and copies its output into the captured output tensor,
    as a real replay overwrites it in place."""

    def __init__(self):
        self.captured = 0

    def capture(self, fn):
        out = fn()
        self.captured += 1
        return {"fn": fn, "out": out}, out

    @staticmethod
    def replay(graph):
        out = graph["fn"]()
        if out is not None:
            graph["out"].copy_(out)


@pytest.fixture
def make_engine():
    """Engine factory with the KV-pool hygiene contract enforced at
    teardown for EVERY engine a test creates, after stop()."""
    engines = []

    def _make(**kw):
        defaults = dict(max_seqs=4, page_size=8, max_len=64,
                        max_prompt_len=24, device="cpu")
        defaults.update(kw)
        eng = decode.DecodeEngine(DECODE_CFG, **defaults)
        engines.append((eng, eng.kv_pool_bytes, eng._kp.data_ptr(),
                        eng._vp.data_ptr()))
        return eng

    yield _make
    for eng, pool_bytes, kptr, vptr in engines:
        eng.stop()
        assert eng.pool.used_pages == 0, "leaked KV pages"
        assert eng.pool.free_pages == eng.num_pages - 1
        assert eng.pool.shared_pages == 0  # no orphaned references
        eng.pool.check_invariant()
        assert eng.kv_pool_bytes == pool_bytes, "device pool grew"
        assert (eng._kp.data_ptr(), eng._vp.data_ptr()) == (kptr, vptr)
        assert tuple(eng._kp.shape) == tinylm.kv_pool_shape(
            eng.config, eng.num_pages, eng.page_size)
        assert tuple(eng._vp.shape) == tuple(eng._kp.shape)


def _prompts(n, lo=3, hi=24, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, DECODE_CFG.vocab_size,
                        size=(lo + (i * (hi - lo)) // max(1, n - 1),)
                        ).astype(np.int32) for i in range(n)]


def _family(prefix_len, tail_len, n, seed=11):
    """``n`` prompts sharing an identical ``prefix_len``-token prefix
    with distinct ``tail_len``-token tails."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, DECODE_CFG.vocab_size, size=(prefix_len,))
    return [np.concatenate([
        prefix, rng.randint(0, DECODE_CFG.vocab_size, size=(tail_len,))]
    ).astype(np.int32) for _ in range(n)]


def _run_all(eng, prompts, max_new, concurrent=False):
    if not concurrent:
        return [eng.submit(p, max_new_tokens=max_new).result()
                for p in prompts]
    out = [None] * len(prompts)

    def run(i):
        out[i] = eng.submit(prompts[i], max_new_tokens=max_new).result()

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    return out


def _slow_decode(eng, seconds=0.02):
    """Meter the engine's decode step (the reference's slow ``_decode_jit``)."""
    real = eng._call

    def slow(kind, v):
        if kind == "decode":
            time.sleep(seconds)
        return real(kind, v)

    eng._call = slow


# -- pool + ladder units ------------------------------------------------------


def test_paged_pool_alloc_free_and_trash_page_reserved():
    pool = decode.PagedKVPool(5)
    assert pool.free_pages == 4  # page 0 is the trash page, never handed out
    a = pool.alloc(2)
    assert 0 not in a and len(set(a)) == 2
    b = pool.alloc(2)
    assert not set(a) & set(b)
    assert not pool.can_alloc(1)
    with pytest.raises(RuntimeError):
        pool.alloc(1)
    pool.free(a)
    assert pool.free_pages == 2
    with pytest.raises(ValueError):
        pool.free(a)  # double free is loud
    with pytest.raises(ValueError):
        pool.free([0])  # the trash page is not freeable
    assert pool.peak_used == 4


def test_pool_refcounts_make_shared_double_free_impossible():
    pool = decode.PagedKVPool(6)
    pages = pool.alloc(2)
    pool.share(pages)
    assert pool.shared_pages == 2 and pool.logical_pages == 4
    assert pool.used_pages == 2
    pool.free(pages)
    assert pool.used_pages == 2 and pool.shared_pages == 0
    pool.free(pages)
    assert pool.used_pages == 0 and pool.free_pages == 5
    with pytest.raises(ValueError):
        pool.free(pages)
    pool.check_invariant()


def test_pool_duplicate_free_validated_before_mutation():
    pool = decode.PagedKVPool(4)
    (p,) = pool.alloc(1)
    with pytest.raises(ValueError):
        pool.free([p, p])
    assert pool.refcount(p) == 1 and pool.used_pages == 1
    pool.free([p])
    pool.check_invariant()


def test_pool_share_validates_and_trash_page_protected():
    pool = decode.PagedKVPool(4)
    with pytest.raises(ValueError):
        pool.share([0])
    with pytest.raises(ValueError):
        pool.share([1])
    pages = pool.alloc(1)
    pool.share(pages)
    pool.free(pages + pages)
    assert pool.invariant()["ok"]


@pytest.mark.parametrize("args,kwargs", [
    ((24,), {}), ((8,), {}), ((5,), {}), ((100,), {"min_bucket": 16}),
    ((60,), {"cap": 60}), ((64,), {"cap": 64})])
def test_prefill_buckets_ladder_is_the_references(args, kwargs):
    assert shapes.prefill_buckets(*args, **kwargs) == \
        ref_shapes.prefill_buckets(*args, **kwargs)


@pytest.mark.parametrize("args,kwargs", [
    ((24, 8), {"max_chunk": 16}), ((24, 8), {}), ((8, 8), {}), ((5, 8), {}),
    ((100, 8), {"max_chunk": 20}), ((100, 8), {"max_chunk": 3}),
    ((64, 16), {"max_chunk": 64}), ((64, 16), {"max_chunk": 32})])
def test_prefill_chunks_ladder_is_the_references(args, kwargs):
    assert shapes.prefill_chunks(*args, **kwargs) == \
        ref_shapes.prefill_chunks(*args, **kwargs)


def test_ladders_refuse_what_the_reference_refuses():
    assert shapes.prefill_buckets(24) == (8, 16, 32)
    assert shapes.prefill_chunks(24, 8, max_chunk=16) == (8, 16)
    assert shapes.pow2_bucket(33) == ref_shapes.pow2_bucket(33) == 64
    for call in (lambda s: s.prefill_buckets(0),
                 lambda s: s.prefill_buckets(100, cap=64),
                 lambda s: s.prefill_chunks(0, 8),
                 lambda s: s.prefill_chunks(8, 0),
                 lambda s: s.spec_ladder(0)):
        for mod in (shapes, ref_shapes):
            with pytest.raises(ValueError):
                call(mod)


def test_shed_window_and_rejected_are_the_references():
    ours, theirs = online.ShedWindow(10.0), ref_online.ShedWindow(10.0)
    for t, shed in ((100.0, False), (101.0, True), (112.0, True),
                    (125.0, False), (131.0, True)):
        ours.note(shed, now=t)
        theirs.note(shed, now=t)
        assert ours.snapshot(now=t + 0.5) == theirs.snapshot(now=t + 0.5)
    e = online.Rejected("full", retry_after_s=0.25)
    assert isinstance(e, RuntimeError) and e.retry_after_s == 0.25
    assert online.Rejected("x").retry_after_s == \
        ref_online.Rejected("x").retry_after_s


def test_sampling_params_and_dist_are_the_references():
    rng = np.random.RandomState(0)
    logits = rng.randn(64).astype(np.float32)
    for kw in ({}, {"temperature": 0.7}, {"temperature": 1.3, "top_k": 5},
               {"temperature": 0.9, "top_p": 0.8},
               {"temperature": 1.0, "top_k": 10, "top_p": 0.5, "seed": 3}):
        sp, rsp = decode.SamplingParams(**kw), ref_decode.SamplingParams(**kw)
        assert all(getattr(sp, k) == getattr(rsp, k) for k in (
            "temperature", "top_k", "top_p", "seed", "greedy"))
        if not sp.greedy:
            assert np.array_equal(decode._sampling_dist(logits, sp),
                                  ref_decode._sampling_dist(logits, rsp))
    for bad in ({"temperature": -1}, {"top_k": -1}, {"top_p": 0.0}):
        with pytest.raises(ValueError):
            decode.SamplingParams(**bad)


def test_module_signatures_count_the_references():
    """Geometry alone gives one signature per rung (or bucket), the decode
    step and the COW copy: as many as the reference's."""
    for kw in ({"prefill_chunks": (8, 16), "share_prefixes": True},
               {"prefill_chunks": (16,), "share_prefixes": False},
               {"prefill_buckets": (8, 16, 32)},
               {"prefill_chunks": (8, 16), "share_prefixes": True,
                "spec_ladder": (1, 2, 4), "spec_drafter": "ngram"},
               {"prefill_chunks": (8, 16), "share_prefixes": True,
                "spec_ladder": (1, 2), "spec_drafter": "model"},
               {"prefill_chunks": (16,), "share_prefixes": False,
                "spec_ladder": (1,), "spec_drafter": "model"}):
        ours = decode.enumerate_signatures(max_seqs=4, pages_per_seq=8, **kw)
        theirs = ref_decode.enumerate_signatures(max_seqs=4,
                                                 pages_per_seq=8, **kw)
        assert len(set(ours)) == len(ours) == len(theirs)


def test_observe_compile_seconds_feeds_the_histogram():
    from tensorflowonspark_torch import obs

    hist = obs.histogram("serving_compile_seconds", buckets=(
        0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0, 120.0,
        float("inf")))
    before = hist.count
    serving.observe_compile_seconds(0.2)
    assert hist.count == before + 1


# -- construction ------------------------------------------------------------


def test_engine_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.delenv("TFOS_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        decode.DecodeEngine(DECODE_CFG)
    eng = decode.DecodeEngine(DECODE_CFG, device="cpu")
    assert eng.device == torch.device("cpu") and eng._graphs is None
    assert all(t.device.type == "cpu" for t in eng._params.values())
    eng.stop()


def test_spec_requires_chunked_prefill():
    with pytest.raises(ValueError, match="chunked prefill"):
        decode.DecodeEngine(DECODE_CFG, max_seqs=2, page_size=8, max_len=64,
                            max_prompt_len=24, prefill_chunk=0,
                            spec_tokens=4, device="cpu")


def test_spec_engine_from_the_environment(monkeypatch, make_engine):
    """``TFOS_SPEC_TOKENS`` / ``TFOS_SPEC_DRAFTER`` build a speculating
    engine, as the reference reads them; 0 is the single-token engine."""
    monkeypatch.setenv("TFOS_SPEC_TOKENS", "4")
    monkeypatch.setenv("TFOS_SPEC_DRAFTER", "model")
    eng = make_engine()
    assert (eng.spec_tokens, eng.spec_ladder, eng.spec_drafter) == (
        4, (1, 2, 4), "model")
    assert isinstance(eng._drafter, decode._ModelDrafter)
    assert eng._drafter.config == tinylm.Config.draft_for(DECODE_CFG)
    monkeypatch.delenv("TFOS_SPEC_DRAFTER")
    assert make_engine().spec_drafter == "ngram"
    monkeypatch.setenv("TFOS_SPEC_TOKENS", "0")
    off = make_engine()
    assert (off.spec_tokens, off.spec_drafter, off._drafter) == (
        0, "off", None)
    with pytest.raises(ValueError, match="drafter kind"):
        make_engine(spec_tokens=2, spec_drafter="oracle")
    with pytest.raises(ValueError, match="vocab"):
        make_engine(spec_tokens=2, spec_drafter="model",
                    draft_config=tinylm.Config(vocab_size=32))
    with pytest.raises(ValueError, match="max_len"):
        make_engine(spec_tokens=2, spec_drafter="model",
                    draft_config=tinylm.Config(
                        vocab_size=64, dim=32, n_layers=1, n_heads=2,
                        head_dim=16, mlp_dim=64, max_len=32))


def test_non_greedy_sampling_is_refused(make_engine):
    """A greedy engine refuses sampling with the reference's message,
    which names ``spec_tokens``."""
    eng = make_engine()
    eng.start()
    with pytest.raises(ValueError, match="spec_tokens"):
        eng.submit([1, 2, 3], max_new_tokens=2,
                   sampling=decode.SamplingParams(temperature=0.8))
    greedy = decode.SamplingParams(temperature=0.0)
    assert eng.submit([1, 2, 3], max_new_tokens=3, sampling=greedy
                      ).result() == eng.submit([1, 2, 3],
                                               max_new_tokens=3).result()


# -- decode semantics ---------------------------------------------------------


def test_incremental_paged_decode_matches_full_forward(make_engine):
    """Prefill + per-token decode through page tables gives EXACTLY the
    greedy continuation the full teacher-forced forward predicts."""
    eng = make_engine()
    eng.start()
    params = eng._params
    for prompt in _prompts(3, lo=3, hi=20):
        got = eng.submit(prompt, max_new_tokens=8).result()
        seq = [int(t) for t in prompt]
        want = []
        for _ in range(8):
            logits = tinylm.apply_tokens(params, torch.tensor([seq]), DECODE_CFG)
            want.append(int(torch.argmax(logits[0, -1])))
            seq.append(want[-1])
        assert got == want


@pytest.mark.parametrize("share", [True, False])
def test_concurrent_decode_matches_sequential(make_engine, share):
    eng = make_engine(max_seqs=4, share_prefixes=share)
    eng.warmup()
    eng.start()
    prompts = _prompts(8)
    seq_out = _run_all(eng, prompts, 10)
    assert _run_all(eng, prompts, 10, concurrent=True) == seq_out


@pytest.mark.parametrize("chunk", [16, 0], ids=["chunked", "legacy"])
def test_zero_new_signatures_after_warmup(make_engine, chunk):
    """warmup() runs and captures exactly the enumerated set (the ladder,
    the one decode step, the COW copy when sharing); steady-state serving
    (varied prompt and generation lengths, admissions, retirements, prefix
    hits and COW copies) meets no new signature and only replays."""
    graphs = StandInGraphs()
    eng = make_engine(prefill_chunk=chunk, graphs=graphs)
    eng.warmup()
    enumerated = set(eng.enumerate_signatures())
    if eng.chunked_prefill:
        expected = len(eng.prefill_chunks) + 1 + int(eng.share_prefixes)
    else:
        expected = len(eng.prefill_buckets) + 1
    assert len(enumerated) == expected
    assert serving._SEEN_SHAPES[eng.cache_key] == enumerated
    assert eng.captures == graphs.captured == eng.eager_calls == expected
    assert eng.replays == 0
    eng.start()
    for i, p in enumerate(_prompts(6)):
        eng.submit(p, max_new_tokens=3 + 2 * i).result()
    rng = np.random.RandomState(43)
    base = rng.randint(0, DECODE_CFG.vocab_size, size=(16,)).astype(np.int32)
    eng.submit(base, max_new_tokens=3).result()
    eng.submit(np.concatenate([base[:12], [1, 2, 3]]).astype(np.int32),
               max_new_tokens=3).result()  # mid-page COW when sharing
    assert serving._SEEN_SHAPES[eng.cache_key] == enumerated
    assert eng.captures == graphs.captured == eng.eager_calls == expected
    assert eng.replays > 0
    st = eng.stats()["compile_cache"]
    assert (st["signatures"], st["captures"], st["replays"]) == (
        expected, expected, eng.replays)
    if eng.share_prefixes:
        assert eng.stats()["admission"]["kv"]["cow_copies_total"] >= 1


def test_a_signature_met_before_warmup_is_captured_then(make_engine):
    """Without warmup() each signature's first sighting runs eagerly
    (its output serves the request) and is captured; later ones replay,
    with the same tokens as an engine without graphs."""
    graphs = StandInGraphs()
    eng = make_engine(graphs=graphs)
    plain = make_engine()
    eng.start()
    plain.start()
    prompts = _prompts(4, lo=3, hi=20)
    assert _run_all(eng, prompts, 6) == _run_all(plain, prompts, 6)
    assert eng.captures == eng.eager_calls == len(
        serving._SEEN_SHAPES[eng.cache_key])
    assert eng.replays > 0 and plain.captures == plain.replays == 0


def test_stale_static_inputs_change_the_tokens(make_engine):
    """The planted fault of chip_smoke.py 17(b): replays whose static
    inputs are not refreshed serve wrong tokens, so the gate sees it."""
    good = make_engine(graphs=StandInGraphs())
    bad = make_engine(graphs=StandInGraphs())
    for eng in (good, bad):
        eng.warmup()
    bad._refresh = lambda staged, arrays: None
    good.start()
    bad.start()
    prompts = _prompts(3, lo=5, hi=20)
    assert _run_all(bad, prompts, 6) != _run_all(good, prompts, 6)


def test_submits_from_many_threads_under_a_short_switch_interval(
        make_engine):
    """Stress: more submitting threads than cores against the engine's
    loop, the interpreter switching threads every 10 µs: every stream is
    its sequential run's, every request counted once, no page lost."""
    import os
    import sys

    eng = make_engine(max_seqs=4, share_prefixes=True)
    eng.start()
    prompts = (_family(prefix_len=16, tail_len=3, n=6, seed=83)
               + _prompts(6, lo=2, hi=20, seed=84))
    want = _run_all(eng, prompts, 5)
    requests0 = int(eng._requests_total.value)
    n = 2 * (os.cpu_count() or 4)
    jobs = [prompts[i % len(prompts)] for i in range(n)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got = _run_all(eng, jobs, 5, concurrent=True)
    finally:
        sys.setswitchinterval(old)
    assert got == [want[i % len(prompts)] for i in range(n)]
    assert int(eng._requests_total.value) - requests0 == n
    deadline = time.time() + 10
    while eng.pool.used_pages > eng._registry.pinned_pages and \
            time.time() < deadline:
        time.sleep(0.01)
    assert eng.pool.used_pages == eng._registry.pinned_pages
    eng.pool.check_invariant()


def test_eos_retires_early_and_frees_slot(make_engine):
    eng = make_engine()
    eng.start()
    prompt = _prompts(1)[0]
    toks = eng.submit(prompt, max_new_tokens=12).result()
    eos = toks[-1]
    first = toks.index(eos)
    eng.eos_id = eos
    toks2 = eng.submit(prompt, max_new_tokens=12).result()
    assert toks2 == toks[: first + 1]
    assert eng.pool.used_pages == 0


# -- admission, cancellation, shutdown ---------------------------------------


def test_admission_sheds_loudly_and_validates(make_engine):
    eng = make_engine(max_pending_requests=0)
    eng.start()
    with pytest.raises(online.Rejected) as ei:
        eng.submit([1, 2, 3], max_new_tokens=2)
    assert ei.value.retry_after_s > 0
    assert int(eng._shed_total.value) >= 1
    assert eng.stats()["admission"]["shed_window"]["shed"] >= 1
    eng2 = make_engine()
    eng2.start()
    with pytest.raises(ValueError):
        eng2.submit([], max_new_tokens=2)
    with pytest.raises(ValueError):
        eng2.submit(list(range(25)), max_new_tokens=2)
    with pytest.raises(ValueError):
        eng2.submit([1, 2], max_new_tokens=0)
    with pytest.raises(ValueError):
        eng2.submit([1, 2], max_new_tokens=63)
    with pytest.raises(ValueError):
        eng2.submit([DECODE_CFG.vocab_size + 5], max_new_tokens=2)
    assert len(eng2.submit([1, 2, 3], max_new_tokens=2).result()) == 2


def test_unsatisfiable_request_refused_not_queued(make_engine):
    eng = make_engine(num_pages=5)  # 4 allocatable pages = 32 tokens
    eng.start()
    with pytest.raises(ValueError, match="KV pages worst-case"):
        eng.submit([1, 2, 3, 4, 5, 6, 7, 8], max_new_tokens=40)
    assert len(eng.submit([1, 2, 3], max_new_tokens=4).result()) == 4


def test_cancel_mid_stream_frees_pages(make_engine):
    eng = make_engine(max_seqs=2)
    eng.start()
    victim = eng.submit(_prompts(1)[0], max_new_tokens=40)
    it = victim.tokens(timeout=30)
    next(it)
    next(it)
    other = eng.submit([5, 6, 7], max_new_tokens=6)
    victim.cancel()
    assert other.result() == eng.submit([5, 6, 7], max_new_tokens=6).result()
    deadline = time.time() + 10
    while eng.pool.used_pages and time.time() < deadline:
        time.sleep(0.01)
    assert eng.pool.used_pages == 0
    assert int(eng._cancelled_total.value) >= 1


def test_stop_fails_inflight_loudly(make_engine):
    eng = make_engine(max_seqs=1)
    eng.start()
    streams = [eng.submit(p, max_new_tokens=38)
               for p in _prompts(3, lo=3, hi=20)]
    results = []

    def consume(s):
        try:
            results.append(("ok", s.result(timeout=30)))
        except Exception as e:
            results.append(("err", type(e).__name__))

    threads = [threading.Thread(target=consume, args=(s,))
               for s in streams]
    for t in threads:
        t.start()
    eng.stop()
    for t in threads:
        t.join(timeout=30)
    assert len(results) == 3
    assert any(kind == "err" for kind, _ in results)
    assert eng.state == "stopped"
    with pytest.raises(RuntimeError):
        eng.submit([1], max_new_tokens=1)


def test_cancel_mid_prefill_frees_shared_and_exclusive_pages(make_engine):
    eng = make_engine(max_seqs=2, prefill_chunk=8)
    eng.start()
    prompts = _family(prefix_len=16, tail_len=8, n=6, seed=53)
    eng.submit(prompts[0], max_new_tokens=2).result()  # register prefix
    survivors = []
    for i, p in enumerate(prompts[1:]):
        s = eng.submit(p, max_new_tokens=12)
        if i % 2:
            s.cancel()
        else:
            survivors.append((p, s))
    want = [eng.submit(p, max_new_tokens=12).result()
            for p, _ in survivors]
    assert [s.result(timeout=60) for _, s in survivors] == want
    deadline = time.time() + 10
    while eng.pool.used_pages and time.time() < deadline:
        time.sleep(0.01)
    eng.pool.check_invariant()
    assert eng.stats()["admission"]["kv"]["invariant"]["ok"]


def test_stop_mid_flight_keeps_invariant(make_engine):
    eng = make_engine(max_seqs=2, prefill_chunk=8)
    eng.start()
    streams = [eng.submit(p, max_new_tokens=30)
               for p in _family(prefix_len=16, tail_len=8, n=5, seed=61)]
    results = []

    def consume(s):
        try:
            results.append(("ok", s.result(timeout=30)))
        except Exception as e:
            results.append(("err", type(e).__name__))

    threads = [threading.Thread(target=consume, args=(s,))
               for s in streams]
    for t in threads:
        t.start()
    eng.stop()
    for t in threads:
        t.join(timeout=30)
    assert len(results) == 5
    assert any(kind == "err" for kind, _ in results)
    assert eng.pool.used_pages == 0
    eng.pool.check_invariant()


# -- chunked prefill and prefix sharing --------------------------------------


def test_chunked_prefill_token_exact_vs_legacy(make_engine):
    legacy = make_engine(prefill_chunk=0)
    chunked = make_engine(prefill_chunk=16)
    assert not legacy.chunked_prefill and chunked.chunked_prefill
    legacy.start()
    chunked.start()
    prompts = _prompts(8, lo=1, hi=24, seed=7)
    assert _run_all(chunked, prompts, 8) == _run_all(legacy, prompts, 8)


def test_shared_prefix_token_exact_and_sublinear_alloc(make_engine):
    legacy = make_engine(prefill_chunk=0)
    chunked = make_engine(prefill_chunk=16)
    legacy.start()
    chunked.start()
    prompts = _family(prefix_len=16, tail_len=4, n=6)
    assert _run_all(chunked, prompts, 6) == _run_all(legacy, prompts, 6)
    st = chunked.stats()
    assert st["engine"]["prefix_registry"]["hits"] == len(prompts) - 1
    kv = st["admission"]["kv"]
    assert kv["prefix_hits_total"] >= len(prompts) - 1
    assert kv["shared_pages_total"] >= 2 * (len(prompts) - 1)
    assert chunked.pool.alloc_total < legacy.pool.alloc_total
    assert kv["invariant"]["ok"]


def test_prefix_diverging_mid_page_cow_copies(make_engine):
    legacy = make_engine(prefill_chunk=0)
    chunked = make_engine(prefill_chunk=16)
    legacy.start()
    chunked.start()
    rng = np.random.RandomState(23)
    base = rng.randint(0, DECODE_CFG.vocab_size, size=(16,)).astype(np.int32)
    fork = np.concatenate([
        base[:12], rng.randint(0, DECODE_CFG.vocab_size, size=(8,))]
    ).astype(np.int32)
    for p in (base, fork):
        assert (chunked.submit(p, max_new_tokens=6).result()
                == legacy.submit(p, max_new_tokens=6).result())
    st = chunked.stats()
    assert st["engine"]["prefix_registry"]["hits"] >= 1
    assert st["admission"]["kv"]["cow_copies_total"] >= 1
    assert (chunked.submit(base, max_new_tokens=6).result()
            == legacy.submit(base, max_new_tokens=6).result())


def test_concurrent_shared_prefix_matches_sequential(make_engine):
    eng = make_engine(max_seqs=4)
    eng.start()
    prompts = _family(prefix_len=16, tail_len=6, n=8, seed=31)
    seq = _run_all(eng, prompts, 8)
    assert _run_all(eng, prompts, 8, concurrent=True) == seq


def test_legacy_mode_forces_sharing_off(make_engine):
    eng = make_engine(prefill_chunk=0, share_prefixes=True)
    assert not eng.chunked_prefill and not eng.share_prefixes
    assert len(eng.enumerate_signatures()) == len(eng.prefill_buckets) + 1


# -- parity with the JAX engine ------------------------------------------------


def _mixed_workload():
    """Singletons of mixed lengths, a prefix family, and a fork of the
    family's prefix diverging mid-page (a COW copy)."""
    rng = np.random.RandomState(97)
    prompts = _prompts(5, lo=1, hi=24, seed=98)
    family = _family(prefix_len=16, tail_len=5, n=3, seed=99)
    fork = np.concatenate([family[0][:12], rng.randint(
        0, DECODE_CFG.vocab_size, size=(7,))]).astype(np.int32)
    return prompts + family + [fork]


@pytest.mark.parametrize("chunk", [16, 0], ids=["chunked", "legacy"])
def test_streams_equal_the_jax_engine(make_engine, chunk):
    """The port's CPU engine and the JAX engine on the same weights give
    the same greedy streams, token for token, over the mixed workload:
    prefix hits and a mid-page COW in the chunked engine."""
    ref_params = ref_tinylm.init_params(ref_tinylm.Config.tiny(), seed=5)
    params = tinylm.params_from_flax(jax.tree_util.tree_map(
        np.asarray, dict(ref_params)))
    geometry = dict(max_seqs=4, page_size=8, max_len=64, max_prompt_len=24,
                    prefill_chunk=chunk)
    prompts = _mixed_workload()
    ref_eng = ref_decode.DecodeEngine(ref_tinylm.Config.tiny(), ref_params,
                                      **geometry)
    ref_eng.start()
    try:
        want = _run_all(ref_eng, prompts, 10)
    finally:
        ref_eng.stop()
    eng = make_engine(params=params, **geometry)
    eng.start()
    assert _run_all(eng, prompts, 10) == want
    if chunk:
        kv = eng.stats()["admission"]["kv"]
        assert kv["prefix_hits_total"] >= 2 and kv["cow_copies_total"] >= 1


# -- speculation and seeded sampling ------------------------------------------
#
# The reference's ``tests/test_decode_spec.py`` at its sizes and bounds, and
# the port held to the reference where the two can run the same inputs: the
# ladder, the controller, the n-gram drafter and the token choice on equal
# logits exactly, the speculating engines' greedy streams token for token.


@pytest.mark.parametrize("k", [1, 2, 4, 6, 8, 13])
def test_spec_ladder_is_the_references(k):
    assert shapes.spec_ladder(k) == ref_shapes.spec_ladder(k)
    assert shapes.spec_ladder(k)[-1] == k


def test_spec_controller_is_the_references():
    """The adaptive-k law on the reference's own sequence of windows
    (``tests/test_decode_spec.py:82-116``): the port's controller and the
    reference's agree on k, shifts and acceptance after every note."""
    lo = decode.SPEC_WINDOW_MIN_PROPOSED
    assert (lo, decode.SPEC_ACCEPT_LOW, decode.SPEC_ACCEPT_HIGH,
            decode.SPEC_WINDOW_S) == (
        ref_decode.SPEC_WINDOW_MIN_PROPOSED, ref_decode.SPEC_ACCEPT_LOW,
        ref_decode.SPEC_ACCEPT_HIGH, ref_decode.SPEC_WINDOW_S)
    ours = decode._SpecController((1, 2, 4), window_s=30.0)
    theirs = ref_decode._SpecController((1, 2, 4), window_s=30.0)
    notes = [(lo, 0, 100.0), (lo - 1, 0, 101.0), (1, 0, 102.0),
             (lo, 0, 103.0), (lo, lo, 104.0), (lo, lo, 140.0),
             (100, 50, 141.0), (lo - 1, 0, 200.0)]
    want_k = [2, 2, 1, 1, 1, 2, 2, 2]
    for (p, a, now), k in zip(notes, want_k):
        ours.note(p, a, now=now)
        theirs.note(p, a, now=now)
        assert (ours.k, ours.shifts, ours.acceptance(now=now)) == (
            theirs.k, theirs.shifts, theirs.acceptance(now=now))
        assert ours.k == k
    assert ours.shifts == 3
    assert ours.acceptance(now=200.0) == 0.0
    assert ours.acceptance(now=300.0) is None  # window drained
    with pytest.raises(ValueError):
        decode._SpecController(())


def test_ngram_proposals_are_the_references():
    """``_NgramDrafter._propose_one`` on seeded histories (short random
    ones, ones with planted repeats, a single token) equals the
    reference's for every k."""
    rng = np.random.RandomState(5)
    hists = [[7], [3, 3], [1, 2, 1]]
    for n in range(60):
        h = list(rng.randint(0, 6 if n % 2 else 64, size=(2 + n,)))
        if n % 3 == 0:
            h += h[: 1 + n % 5]  # a repeat the lookup can find
        hists.append([int(t) for t in h])
    hit = 0
    for h in hists:
        for k in (1, 2, 4, 8):
            got = decode._NgramDrafter._propose_one(h, k)
            assert got == ref_decode._NgramDrafter._propose_one(h, k)
            hit += bool(got)
    assert hit > 100  # not vacuous


def test_choose_token_draws_the_references():
    """On the same float32 logits the port's token choice is the
    reference's, draw for draw, over 1,000 (seed, position, draft)
    triples: greedy, temperature with top-k and top-p, drafts of high and
    low mass and none (the same ``default_rng([seed, position])``)."""
    rng = np.random.RandomState(11)
    V = DECODE_CFG.vocab_size
    n_same = 0
    for i in range(1000):
        logits = (rng.randn(V) * (0.5 + 2 * rng.rand())).astype(np.float32)
        kw = [{}, {"temperature": 0.8, "top_p": 0.9},
              {"temperature": 1.2, "top_k": 5},
              {"temperature": 0.5, "top_k": 1}][i % 4]
        seed, pos = int(rng.randint(0, 2 ** 31)), int(rng.randint(0, 4096))
        draft = [None, int(np.argmax(logits)), int(rng.randint(V))][i % 3]
        ours = decode._DecodeRequest(np.asarray([1], np.int32), 4, None,
                                     sampling=decode.SamplingParams(
                                         seed=seed, **kw))
        theirs = ref_decode._DecodeRequest(
            np.asarray([1], np.int32), 4, None,
            sampling=ref_decode.SamplingParams(seed=seed, **kw))
        got = decode.DecodeEngine._choose_token(None, ours, logits, pos,
                                                draft)
        want = ref_decode.DecodeEngine._choose_token(None, theirs, logits,
                                                     pos, draft)
        assert got == want, (i, kw, seed, pos, draft)
        n_same += got == draft
    assert 0 < n_same < 1000


def test_rejection_sampling_preserves_target_distribution():
    """The speculative-sampling law at the token choice: for a high-mass
    draft, a low-mass draft and none, 20,000 position-keyed draws match
    ``_sampling_dist`` within total variation 0.03, and a draft is kept
    with its own probability within 0.02 (the reference's bounds)."""
    sp = decode.SamplingParams(temperature=0.8, top_p=0.9, seed=71)
    rng = np.random.RandomState(73)
    logits = (rng.randn(DECODE_CFG.vocab_size) * 2.0).astype(np.float32)
    p = decode._sampling_dist(logits, sp)
    req = decode._DecodeRequest(np.asarray([1], np.int32), 4, None,
                                sampling=sp)
    kept = np.flatnonzero(p)
    for draft in (int(p.argmax()), int(kept[p[kept].argmin()]), None):
        counts = np.zeros(DECODE_CFG.vocab_size)
        n = 20000
        for pos in range(n):
            counts[decode.DecodeEngine._choose_token(None, req, logits, pos,
                                                     draft)] += 1
        tv = 0.5 * np.abs(counts / n - p).sum()
        assert tv < 0.03, (draft, tv)
        if draft is not None:
            assert counts[draft] / n == pytest.approx(p[draft], abs=0.02)


@pytest.mark.parametrize("drafter", ["ngram", "model"])
def test_spec_streams_equal_the_jax_spec_engine(make_engine, drafter):
    """Greedy speculation at spec_tokens=4 over the mixed workload (prefix
    hits, a mid-page COW), on the reference's weights and, for the model
    drafter, the reference drafter's weights: the port's streams equal the
    JAX speculating engine's and the port's single-token engine's, token
    for token, and the verify steps took drafts."""
    ref_params = ref_tinylm.init_params(ref_tinylm.Config.tiny(), seed=5)
    params = tinylm.params_from_flax(jax.tree_util.tree_map(
        np.asarray, dict(ref_params)))
    geometry = dict(max_seqs=4, page_size=8, max_len=64, max_prompt_len=24)
    prompts = _mixed_workload()
    ref_eng = ref_decode.DecodeEngine(ref_tinylm.Config.tiny(), ref_params,
                                      spec_tokens=4, spec_drafter=drafter,
                                      **geometry)
    draft = {}
    if drafter == "model":
        draft = {"draft_params": tinylm.params_from_flax(
            jax.tree_util.tree_map(np.asarray, dict(
                ref_eng._drafter._params)))}
    ref_eng.start()
    try:
        want = _run_all(ref_eng, prompts, 10)
    finally:
        ref_eng.stop()
    base = make_engine(params=params, **geometry)
    base.start()
    assert _run_all(base, prompts, 10) == want
    eng = make_engine(params=params, spec_tokens=4, spec_drafter=drafter,
                      **geometry, **draft)
    p0 = int(eng._spec_proposed_total.value)  # process-wide: a delta
    eng.start()
    assert _run_all(eng, prompts, 10) == want
    kv = eng.stats()["admission"]["kv"]
    assert kv["prefix_hits_total"] >= 2 and kv["cow_copies_total"] >= 1
    assert int(eng._spec_proposed_total.value) > p0


def test_greedy_ngram_spec_emits_more_than_a_token_a_step(make_engine):
    """The reference's headline mechanism: the n-gram engine's greedy
    streams equal the single-token engine's while its verify steps emit
    more than one token each on average."""
    base = make_engine()
    spec = make_engine(spec_tokens=4, spec_drafter="ngram")
    assert spec.spec_ladder == (1, 2, 4)
    base.start()
    spec.start()
    s0 = int(spec._spec_steps_total.value)
    e0 = int(spec._spec_emitted_total.value)
    a0 = int(spec._spec_accepted_total.value)
    prompts = _prompts(8, lo=3, hi=24)
    assert _run_all(spec, prompts, 20) == _run_all(base, prompts, 20)
    assert int(spec._spec_accepted_total.value) > a0
    assert 0.0 <= spec.stats()["admission"]["kv"]["spec_acceptance_rate"] \
        <= 1.0
    steps = int(spec._spec_steps_total.value) - s0
    assert (int(spec._spec_emitted_total.value) - e0) / steps > 1.0


def test_model_drafter_perfect_and_cold_stay_token_exact(make_engine):
    """With the target's own weights the model drafter predicts the
    verify outcome (acceptance >= 0.95, the reference's bound); with other
    weights the streams stay exact anyway, and the controller moves k."""
    params = tinylm.init_params(DECODE_CFG, seed=0)
    base = make_engine(params=params)
    base.start()
    prompts = _prompts(6, lo=3, hi=20, seed=17)
    want = _run_all(base, prompts, 16)
    perfect = make_engine(params=params, spec_tokens=4,
                          spec_drafter="model", draft_config=DECODE_CFG,
                          draft_params=params)
    perfect.start()
    assert _run_all(perfect, prompts, 16, concurrent=True) == want
    assert perfect.stats()["admission"]["kv"]["spec_acceptance_rate"] \
        >= 0.95
    cold = make_engine(params=params, spec_tokens=4, spec_drafter="model",
                       draft_params=tinylm.init_params(
                           tinylm.Config.draft_for(DECODE_CFG), seed=99))
    cold.start()
    assert _run_all(cold, prompts, 16) == want
    assert cold.stats()["engine"]["spec"]["shifts"] >= 1


def test_none_drafter_is_the_single_token_engine(make_engine):
    base = make_engine()
    spec = make_engine(spec_tokens=1, spec_drafter="none")
    base.start()
    spec.start()
    p0 = int(spec._spec_proposed_total.value)
    prompts = _prompts(4, seed=37)
    assert _run_all(spec, prompts, 10) == _run_all(base, prompts, 10)
    assert int(spec._spec_proposed_total.value) == p0
    assert spec.stats()["admission"]["kv"]["spec_acceptance_rate"] is None


def test_adaptive_controller_drops_k_on_cold_drafter(make_engine):
    """Drafts that are always wrong drive acceptance to zero: k walks down
    the captured ladder to its floor, meeting no new signature, and the
    streams stay exact."""
    base = make_engine()
    spec = make_engine(spec_tokens=4, spec_drafter="ngram",
                       graphs=StandInGraphs())
    base.start()
    spec.warmup()
    enumerated = set(spec.enumerate_signatures())

    def garbage(engine, rows, k):
        return {r.slot: [(int(engine._tokens[r.slot]) + 1)
                         % DECODE_CFG.vocab_size] * k for r in rows}

    spec._drafter.propose_all = garbage
    spec.start()
    prompts = _prompts(6, lo=5, hi=20, seed=41)
    assert _run_all(spec, prompts, 16) == _run_all(base, prompts, 16)
    sp = spec.stats()["engine"]["spec"]
    assert sp["k"] == 1 and sp["shifts"] >= 2
    assert spec.stats()["admission"]["kv"]["spec_acceptance_rate"] == 0.0
    assert serving._SEEN_SHAPES[spec.cache_key] == enumerated


@pytest.mark.parametrize("drafter", ["ngram", "model"])
def test_zero_new_signatures_with_spec_on(make_engine, drafter):
    """warmup() captures one verify step a ladder rung (no single-token
    decode step) and, for the model drafter, its chunk rungs, decode step
    and COW copy under ``draft_`` keys; serving (mixed lengths, shared
    prefixes, a mirrored COW) meets nothing new and only replays."""
    graphs = StandInGraphs()
    eng = make_engine(spec_tokens=4, spec_drafter=drafter, graphs=graphs)
    eng.warmup()
    enumerated = set(eng.enumerate_signatures())
    share = int(eng.share_prefixes)
    expected = len(eng.prefill_chunks) + len(eng.spec_ladder) + share
    if drafter == "model":
        expected += len(eng.prefill_chunks) + 1 + share
    assert len(enumerated) == expected
    assert serving._SEEN_SHAPES[eng.cache_key] == enumerated
    assert eng.captures == graphs.captured == eng.eager_calls == expected
    eng.start()
    for p in _prompts(5, lo=1, hi=24, seed=53):
        eng.submit(p, max_new_tokens=8).result()
    base = np.asarray(_family(16, 4, 2, seed=59)[0])
    eng.submit(base, max_new_tokens=4).result()
    eng.submit(np.concatenate([base[:12], [1, 2, 3]]).astype(np.int32),
               max_new_tokens=4).result()  # mid-page COW, mirrored
    assert serving._SEEN_SHAPES[eng.cache_key] == enumerated
    assert eng.captures == eng.eager_calls == expected
    assert eng.replays > 0
    assert eng.stats()["admission"]["kv"]["cow_copies_total"] >= 1


def test_seeded_sampling_replays_and_top_k_1_is_greedy(make_engine):
    """The same sampled request replays token for token on a fresh
    engine, other seeds decorrelate, temperature 0 is greedy, and top_k=1
    (a point mass: the rejection rule's last branch) is greedy too."""
    prompt = _prompts(1, seed=61)[0]
    streams = {}
    for seed in (5, 5, 6, 7):
        eng = make_engine(spec_tokens=2, spec_drafter="ngram")
        eng.start()
        sp = decode.SamplingParams(temperature=0.9, top_p=0.95, seed=seed)
        streams.setdefault(seed, []).append(eng.submit(
            prompt, max_new_tokens=16, sampling=sp).result(timeout=60))
        eng.stop()
    assert streams[5][0] == streams[5][1]
    assert len({tuple(v[0]) for v in streams.values()}) > 1
    eng = make_engine(spec_tokens=4, spec_drafter="ngram")
    eng.start()
    p = _prompts(1, seed=67)[0]
    want = eng.submit(p, max_new_tokens=12).result()
    for sp in (decode.SamplingParams(temperature=0.0, seed=9),
               decode.SamplingParams(temperature=0.8, top_k=1, seed=9)):
        assert eng.submit(p, max_new_tokens=12, sampling=sp).result() \
            == want


def test_spec_sampling_distribution_matches_none_drafter(make_engine):
    """The same sampled workload through a speculating engine and the
    ``none`` drafter gives per-position marginals within total variation
    0.35 over 200 seeds (the reference's size and bound)."""
    spec = make_engine(spec_tokens=2, spec_drafter="ngram")
    plain = make_engine(spec_tokens=1, spec_drafter="none")
    spec.start()
    plain.start()
    p0 = int(spec._spec_proposed_total.value)
    prompt = _prompts(1, seed=79)[0]
    n, new = 200, 5
    a = np.zeros((new, DECODE_CFG.vocab_size))
    b = np.zeros((new, DECODE_CFG.vocab_size))
    for seed in range(n):
        sp = decode.SamplingParams(temperature=0.7, top_p=0.9, seed=seed)
        for eng, acc in ((spec, a), (plain, b)):
            toks = eng.submit(prompt, max_new_tokens=new,
                              sampling=sp).result(timeout=60)
            for j, t in enumerate(toks):
                acc[j, t] += 1
    assert int(spec._spec_proposed_total.value) > p0  # not vacuous
    for j in range(new):
        tv = 0.5 * np.abs(a[j] / n - b[j] / n).sum()
        assert tv < 0.35, (j, tv)


def test_cancel_mid_speculation_rewinds_and_frees(make_engine):
    """A cancel landing between propose and verify retires the victim at
    the step boundary with every page freed and the pool's law intact,
    while the survivor's stream stays exact."""
    base = make_engine(max_seqs=2, share_prefixes=False)
    base.start()
    spec = make_engine(max_seqs=2, spec_tokens=4, spec_drafter="ngram",
                       share_prefixes=False)
    prompts = _prompts(2, lo=8, hi=12, seed=97)
    want = base.submit(prompts[1], max_new_tokens=24).result()
    state = {"victim": None, "armed": False}
    real = spec._call

    def chaotic(kind, v):
        if kind == "verify" and state["armed"] and state["victim"]:
            state["victim"].cancel()  # between propose and verify
            state["armed"] = False
        return real(kind, v)

    spec._call = chaotic
    spec.start()
    victim = spec.submit(prompts[0], max_new_tokens=40)
    next(victim.tokens(timeout=30))  # prefill done, speculation underway
    state.update(victim=victim, armed=True)
    survivor = spec.submit(prompts[1], max_new_tokens=24)
    assert survivor.result(timeout=60) == want
    deadline = time.time() + 10
    while spec.pool.used_pages and time.time() < deadline:
        time.sleep(0.01)
    assert spec.pool.used_pages == 0
    spec.pool.check_invariant()
    assert not state["armed"], "the hook never fired mid-speculation"


def test_stop_mid_speculation_keeps_invariant(make_engine):
    eng = make_engine(max_seqs=2, spec_tokens=4, spec_drafter="model")
    real = eng._call

    def slow(kind, v):
        if kind == "verify":
            time.sleep(0.02)
        return real(kind, v)

    eng._call = slow
    eng.start()
    streams = [eng.submit(p, max_new_tokens=38)
               for p in _prompts(4, lo=3, hi=20, seed=101)]
    results = []

    def consume(s):
        try:
            results.append(("ok", s.result(timeout=30)))
        except Exception as e:
            results.append(("err", type(e).__name__))

    threads = [threading.Thread(target=consume, args=(s,)) for s in streams]
    for t in threads:
        t.start()
    eng.stop()
    for t in threads:
        t.join(timeout=30)
    assert len(results) == 4 and any(k == "err" for k, _ in results)
    assert eng.pool.used_pages == 0
    eng.pool.check_invariant()


def test_spec_stats_and_flight_stages(make_engine):
    """The ``spec`` blocks of stats(), the SLO snapshot and /healthz's kv
    block carry the reference's keys at live values, and a speculating
    engine records ``speculate`` and ``verify`` flight stages and no
    ``decode``."""
    from tensorflowonspark_torch.obs import flight

    eng = make_engine(spec_tokens=4, spec_drafter="ngram")
    eng.start()
    rec = flight.recorder("decode")
    rec.reset()
    for p in _prompts(3, seed=83):
        eng.submit(p, max_new_tokens=16).result()
    snap = rec.snapshot()
    assert snap["stages_s"].get("speculate", 0) > 0
    assert snap["stages_s"].get("verify", 0) > 0
    assert "decode" not in snap["stages_s"]
    assert snap["verdict"] in flight.VERDICTS
    assert 0.0 <= eng.slo_snapshot()["spec_acceptance_rate"] <= 1.0
    st = eng.stats()
    assert st["engine"]["spec"] == {
        "spec_tokens": 4, "drafter": "ngram", "ladder": [1, 2, 4],
        "k": eng._spec_ctl.k, "shifts": eng._spec_ctl.shifts}
    kv = st["admission"]["kv"]
    assert kv["spec_proposed_total"] >= kv["spec_accepted_total"] > 0
    assert kv["spec_k"] in (1, 2, 4)
    theirs = ref_decode.DecodeEngine(ref_tinylm.Config.tiny(), max_seqs=4,
                                     page_size=8, max_len=64,
                                     max_prompt_len=24, spec_tokens=4)
    try:
        ref_doc = theirs.stats()
    finally:
        theirs.stop()
    assert set(ref_doc["engine"]["spec"]) == set(st["engine"]["spec"])
    assert set(ref_doc["admission"]["kv"]) <= set(kv)
    assert set(ref_doc["slo"]) <= set(st["slo"])


def test_http_sampling_quartet_reaches_engine(make_engine):
    import http.client

    eng = make_engine(spec_tokens=2, spec_drafter="ngram")
    eng.start()
    srv = decode.DecodeHTTPServer(eng)
    greedy = make_engine(max_seqs=2)
    greedy.start()
    srv2 = decode.DecodeHTTPServer(greedy)
    try:
        host, port = srv.start()
        conn = http.client.HTTPConnection(host, port, timeout=30)
        body = json.dumps({"prompt": [1, 2, 3, 4], "max_new_tokens": 8,
                           "stream": False, "temperature": 0.9,
                           "top_p": 0.95, "seed": 11}).encode()
        outs = []
        for _ in range(2):
            conn.request("POST", "/v1/generate", body=body)
            r = conn.getresponse()
            assert r.status == 200
            outs.append(json.loads(r.read())["tokens"])
        assert outs[0] == outs[1] and len(outs[0]) == 8
        want = eng.submit([1, 2, 3, 4], max_new_tokens=8,
                          sampling=decode.SamplingParams(
                              temperature=0.9, top_p=0.95, seed=11)).result()
        assert outs[0] == want
        # a sampling request on an engine without speculation: 400
        h2, p2 = srv2.start()
        c2 = http.client.HTTPConnection(h2, p2, timeout=30)
        c2.request("POST", "/v1/generate", body=body)
        r2 = c2.getresponse()
        assert r2.status == 400 and b"spec_tokens" in r2.read()
    finally:
        srv.stop()
        srv2.stop()


# -- observability -----------------------------------------------------------


def test_flight_plane_and_slo_windows(make_engine):
    from tensorflowonspark_torch.obs import flight

    eng = make_engine()
    eng.start()
    rec = flight.recorder("decode")
    rec.reset()
    for p in _prompts(3):
        eng.submit(p, max_new_tokens=6).result()
    snap = rec.snapshot()
    assert snap["stages_s"].get("prefill_chunk", 0) > 0
    assert snap["stages_s"].get("decode", 0) > 0
    assert snap["verdict"] in flight.VERDICTS
    slo = eng.slo_snapshot()
    assert slo["samples"] >= 3
    assert slo["ttft_p99_ms"] > 0
    assert slo["itl_p99_ms"] > 0
    assert slo["ttft_slo_ms"] == decode.DEFAULT_TTFT_SLO_MS
    st = eng.stats()
    assert st["admission"]["slo"] == eng.slo_snapshot()
    assert st["engine"]["kv_pages_total"] == eng.num_pages - 1
    assert st["tokens_total"] >= 18


def test_healthz_compile_cache_block_and_uptime(make_engine):
    eng = make_engine()
    st = eng.stats()
    cc = st["compile_cache"]
    for key in ("dir", "disk_hits", "signatures", "captures", "replays",
                "eager_calls"):
        assert key in cc
    assert st["uptime_s"] is None
    assert st["engine"]["device"] == "cpu"
    eng.start()
    st = eng.stats()
    assert st["uptime_s"] is not None and st["uptime_s"] >= 0.0


def test_stats_keep_the_references_schema(make_engine):
    """/healthz keeps the reference's keys (the mesh router reads them),
    speculation's at their off values."""
    ours = make_engine().stats()
    theirs = ref_decode.DecodeEngine(ref_tinylm.Config.tiny(), max_seqs=4,
                                     page_size=8, max_len=64,
                                     max_prompt_len=24)
    try:
        ref_doc = theirs.stats()
    finally:
        theirs.stop()
    for block in (None, "engine", "admission", "slo"):
        a = ours if block is None else ours[block]
        b = ref_doc if block is None else ref_doc[block]
        assert set(b) <= set(a), (block, set(b) - set(a))
    assert set(ref_doc["admission"]["kv"]) <= set(ours["admission"]["kv"])
    assert ours["engine"]["spec"]["spec_tokens"] == 0


def test_per_token_spans_on_retained_trace(make_engine, monkeypatch):
    from tensorflowonspark_torch.obs import trace as trace_lib

    monkeypatch.setenv("TFOS_TRACE_SAMPLE", "1")
    eng = make_engine()
    eng.start()
    ctx = trace_lib.TraceContext(trace_lib.new_trace_id(),
                                 trace_lib.new_span_id())
    stream = eng.submit(_prompts(1)[0], max_new_tokens=6, trace_ctx=ctx)
    assert stream.trace_id == ctx.trace_id
    stream.result()
    deadline = time.time() + 5
    entry = None
    while entry is None and time.time() < deadline:
        for e in trace_lib.get_trace_store().to_doc()["retained"]:
            if e.get("trace_id") == ctx.trace_id:
                entry = e
        time.sleep(0.01)
    assert entry is not None, "armed decode request was not retained"
    names = [s["name"] for s in entry["spans"]]
    assert "prefill_chunk" in names and "queue" in names
    assert names.count("token") == 5
    token_spans = [s for s in entry["spans"] if s["name"] == "token"]
    assert [s["attrs"]["index"] for s in token_spans] == [1, 2, 3, 4, 5]


def test_journal_records_the_slot_lifecycle(make_engine):
    from tensorflowonspark_torch.obs import journal

    eng = make_engine()
    eng.start()
    rng = np.random.RandomState(71)
    base = rng.randint(0, DECODE_CFG.vocab_size, size=(16,)).astype(np.int32)
    eng.submit(base, max_new_tokens=2).result()
    eng.submit(np.concatenate([base[:12], [4, 5]]).astype(np.int32),
               max_new_tokens=2, tenant="t2").result()
    events = journal.get_journal().tail(10000)
    kinds = {e["type"] for e in events
             if e["attrs"].get("tenant") == "t2"}
    assert {"decode.admit", "decode.cow_copy", "decode.prefill",
            "decode.retire"} <= kinds


def test_http_streaming_healthz_metrics(make_engine):
    import http.client

    from tensorflowonspark_torch.obs.httpd import validate_prometheus_text

    eng = make_engine()
    eng.start()
    srv = decode.DecodeHTTPServer(eng)
    try:
        host, port = srv.start()
        conn = http.client.HTTPConnection(host, port, timeout=30)
        conn.request("POST", "/v1/generate", body=json.dumps(
            {"prompt": [1, 2, 3, 4], "max_new_tokens": 5}).encode())
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Transfer-Encoding") == "chunked"
        lines = [json.loads(ln) for ln in
                 resp.read().decode().strip().splitlines()]
        assert [d["token"] for d in lines[:-1]] == lines[-1]["tokens"]
        assert lines[-1]["done"] is True and lines[-1]["n"] == 5
        assert lines[-1]["tokens"] == eng.submit(
            [1, 2, 3, 4], max_new_tokens=5).result()
        conn.request("POST", "/v1/generate", body=json.dumps(
            {"prompt": [1, 2, 3, 4], "max_new_tokens": 5,
             "stream": False}).encode())
        r2 = conn.getresponse()
        assert r2.status == 200
        assert json.loads(r2.read())["tokens"] == lines[-1]["tokens"]
        conn.request("GET", "/healthz")
        h = conn.getresponse()
        doc = json.loads(h.read())
        assert h.status == 200
        adm = doc["admission"]
        assert adm["admission_schema"] == 1
        assert {"ttft_p99_ms", "itl_p99_ms", "ttft_slo_ms",
                "itl_slo_ms", "samples"} <= set(adm["slo"])
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
        assert validate_prometheus_text(text) == []
        assert "decode_ttft_seconds_bucket" in text
        assert "decode_itl_seconds_bucket" in text
        conn.request("POST", "/v1/generate", body=b'{"prompt": []}')
        r = conn.getresponse()
        assert r.status == 400
        r.read()
        conn.request("POST", "/v1/generate", body=json.dumps(
            {"prompt": [1], "temperature": 0.5}).encode())
        r = conn.getresponse()
        assert r.status == 400  # sampling waits for speculation
        r.read()
        eng.max_pending_requests = 0
        conn.request("POST", "/v1/generate", body=json.dumps(
            {"prompt": [1], "max_new_tokens": 1}).encode())
        r = conn.getresponse()
        assert r.status == 429
        assert int(r.getheader("Retry-After")) >= 1
        r.read()
        eng.max_pending_requests = 128
    finally:
        srv.stop()


def test_http_nonstream_timeout_cancels_generation(make_engine):
    import http.client

    eng = make_engine()
    _slow_decode(eng)
    eng.start()
    srv = decode.DecodeHTTPServer(eng)
    try:
        host, port = srv.start()
        cancelled0 = int(eng._cancelled_total.value)
        conn = http.client.HTTPConnection(host, port, timeout=30)
        conn.request("POST", "/v1/generate", body=json.dumps(
            {"prompt": [1, 2, 3], "max_new_tokens": 50,
             "stream": False, "timeout_s": 0.1}).encode())
        resp = conn.getresponse()
        assert resp.status == 504
        resp.read()
        deadline = time.time() + 10
        while time.time() < deadline and (
                int(eng._cancelled_total.value) == cancelled0
                or eng.pool.used_pages):
            time.sleep(0.05)
        assert int(eng._cancelled_total.value) > cancelled0
        assert eng.pool.used_pages == 0
    finally:
        srv.stop()


def test_http_client_disconnect_cancels_generation(make_engine):
    import socket as socket_mod

    eng = make_engine()
    _slow_decode(eng)
    eng.start()
    srv = decode.DecodeHTTPServer(eng)
    try:
        host, port = srv.start()
        cancelled0 = int(eng._cancelled_total.value)
        body = json.dumps({"prompt": [1, 2, 3],
                           "max_new_tokens": 50}).encode()
        sock = socket_mod.create_connection((host, port), timeout=10)
        sock.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Type: application/json\r\n"
                     b"Content-Length: %d\r\n\r\n" % len(body) + body)
        f = sock.makefile("rb")
        assert b"200" in f.readline()
        while b'"token"' not in f.readline():
            pass
        sock.shutdown(socket_mod.SHUT_RDWR)
        f.close()
        sock.close()
        deadline = time.time() + 10
        while time.time() < deadline and (
                int(eng._cancelled_total.value) == cancelled0
                or eng.pool.used_pages):
            time.sleep(0.05)
        assert int(eng._cancelled_total.value) > cancelled0, \
            "disconnect did not cancel the generation"
        assert eng.pool.used_pages == 0
    finally:
        srv.stop()


def test_healthz_503_when_stopped(make_engine):
    import http.client

    eng = make_engine()
    eng.start()
    srv = decode.DecodeHTTPServer(eng)
    try:
        host, port = srv.start()
        eng.stop()
        conn = http.client.HTTPConnection(host, port, timeout=10)
        conn.request("GET", "/healthz")
        assert conn.getresponse().status == 503
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# The online serving tier (``tensorflowonspark_torch.online``)
# ---------------------------------------------------------------------------
#
# Ported from the reference's ``tests/test_online.py`` (each case keeps its
# name, with a torch ``predict_fn``), plus the parity the port owes: the
# same seeded requests through the JAX package's ``OnlineServer`` and the
# port's, on the same weights (``params_from_flax``), and the captured
# forward's host side with a stand-in graph backend.  Online tests wait on
# events with generous timeouts, never on tight wall-clock bounds.

import urllib.error  # noqa: E402
import urllib.request  # noqa: E402

from tensorflowonspark_torch import health, infer_embed  # noqa: E402
from tensorflowonspark_torch.obs import flight as port_flight  # noqa: E402
from tensorflowonspark_torch.parallel import train as port_train  # noqa: E402

ONLINE_W = np.arange(20, dtype=np.float32).reshape(4, 5) / 10.0


def _online_predict(p, b):
    return {"score": b["features"] @ torch.as_tensor(p["w"])}


@pytest.fixture()
def online_export(tmp_path, monkeypatch):
    monkeypatch.setenv(util.DEVICE_ENV, "cpu")
    d = str(tmp_path / "export")
    compat.export_saved_model({"params": {"w": ONLINE_W}}, d)
    return d


def _online_server(export_dir, tenants=("a",), batch_size=8,
                   bucket_sizes=(2, 8), flush_ms=10.0,
                   predict_fn=_online_predict, warmup=None, **kw):
    srv = online.OnlineServer()
    for name in tenants:
        srv.add_tenant(
            name, export_dir=export_dir, predict_fn=predict_fn,
            batch_size=batch_size, bucket_sizes=list(bucket_sizes),
            flush_ms=flush_ms, warmup=warmup,
            warmup_example={"features": np.zeros(4, np.float32)}, **kw)
    return srv.start()


def _online_rows(n, seed=0):
    return np.random.RandomState(seed).rand(n, 4).astype(np.float32)


def _gated(gate):
    def predict(p, b):
        gate.wait(timeout=30.0)
        return _online_predict(p, b)
    return predict


def _fill_to_bound(srv, start_one, tenant="a", row_bytes=16):
    """Start requests (``start_one()`` each) until ``tenant``'s pending
    bytes leave no room for another row: a gated forward holds one batch
    and the staged queue the next ones, so how many that takes depends on
    how the coalescer happened to merge them.  Returns the count."""
    def full():
        t = srv.stats()["tenants"][tenant]
        return t["pending_bytes"] + row_bytes > t["max_pending_bytes"]

    n, deadline = 0, time.monotonic() + 30.0
    while not full() and time.monotonic() < deadline:
        start_one()
        n += 1
        time.sleep(0.02)
    assert full()
    return n


def _post(url, doc, headers=None, timeout=30.0):
    req = urllib.request.Request(
        url, data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read().decode())


def test_deadline_flush_single_request(online_export):
    srv = _online_server(online_export, flush_ms=20.0)
    try:
        x = _online_rows(1)
        out = srv.submit("a", {"features": x}, timeout=30.0)
        np.testing.assert_allclose(out["score"], x @ ONLINE_W, rtol=1e-6)
    finally:
        srv.stop()


def test_full_bucket_flushes_before_deadline(online_export):
    """Four single rows fill the 4-row bucket: they flush without waiting
    out a deadline that never comes (an hour)."""
    srv = _online_server(online_export, batch_size=4, bucket_sizes=(4,),
                         flush_ms=3_600_000.0)
    try:
        gate = threading.Event()
        results = {}

        def go(i):
            results[i] = srv.submit("a", {"features": _online_rows(
                1, seed=i)}, timeout=60.0)
            if len(results) == 4:
                gate.set()

        threads = [threading.Thread(target=go, args=(i,), daemon=True)
                   for i in range(4)]
        for t in threads:
            t.start()
        assert gate.wait(60.0)
        for i, out in results.items():
            np.testing.assert_allclose(
                out["score"], _online_rows(1, seed=i) @ ONLINE_W, rtol=1e-6)
    finally:
        srv.stop()


def test_scatter_correct_when_batch_mixes_tenants(online_export):
    srv = _online_server(online_export, tenants=("a", "b"), flush_ms=100.0)
    try:
        batches_before = port_flight.recorder("online").batches
        xa, xb = _online_rows(2, seed=1), _online_rows(3, seed=2)
        results = {}

        def go(tenant, x):
            results[tenant] = srv.submit(tenant, {"features": x},
                                         timeout=30.0)

        ta = threading.Thread(target=go, args=("a", xa))
        tb = threading.Thread(target=go, args=("b", xb))
        ta.start(), tb.start()
        ta.join(30.0), tb.join(30.0)
        np.testing.assert_allclose(results["a"]["score"], xa @ ONLINE_W,
                                   rtol=1e-6)
        np.testing.assert_allclose(results["b"]["score"], xb @ ONLINE_W,
                                   rtol=1e-6)
        assert port_flight.recorder("online").batches - batches_before <= 2
        stats = srv.stats()
        assert stats["tenants"]["a"]["requests_total"] >= 1
        assert stats["tenants"]["b"]["requests_total"] >= 1
    finally:
        srv.stop()


def test_shed_under_pressure_returns_rejection_not_hang(online_export):
    gate = threading.Event()
    srv = _online_server(online_export, predict_fn=_gated(gate),
                         flush_ms=1.0, warmup=False,
                         max_pending_mb=4 * 16 / (1 << 20))
    try:
        from tensorflowonspark_torch import obs

        shed_before = obs.counter("online_shed_total").value
        threads, results = [], []

        def go():
            try:
                results.append(srv.submit("a", {"features": _online_rows(1)},
                                          timeout=60.0))
            except online.Rejected:
                results.append("shed")

        def start_one():
            threads.append(threading.Thread(target=go, daemon=True))
            threads[-1].start()

        saw_shed = False
        n = _fill_to_bound(srv, start_one)
        try:
            srv.submit("a", {"features": _online_rows(1)}, timeout=0.5)
        except online.Rejected as e:
            saw_shed = True
            assert e.retry_after_s > 0
        gate.set()
        for t in threads:
            t.join(timeout=30.0)
        assert saw_shed or "shed" in results
        assert obs.counter("online_shed_total").value - shed_before >= 1
        assert len(results) == n
        for r in results:
            assert r == "shed" or "score" in r
    finally:
        gate.set()
        srv.stop()


def test_per_tenant_isolation_backlog_cannot_starve_neighbor(online_export):
    busy = threading.Event()

    def slowish(p, b):
        time.sleep(0.01)
        busy.set()
        return _online_predict(p, b)

    srv = _online_server(online_export, tenants=("a", "b"), batch_size=4,
                         bucket_sizes=(4,), flush_ms=2.0, warmup=False,
                         predict_fn=slowish)
    try:
        stop_flood = threading.Event()
        flooded = []

        def flood():
            while not stop_flood.is_set():
                try:
                    flooded.append(srv.submit(
                        "a", {"features": _online_rows(1)}, timeout=30.0))
                except online.Rejected:
                    time.sleep(0.002)

        floods = [threading.Thread(target=flood, daemon=True)
                  for _ in range(6)]
        for t in floods:
            t.start()
        assert busy.wait(timeout=30.0)  # the backlog exists
        out = srv.submit("b", {"features": _online_rows(2, seed=7)},
                         timeout=30.0)
        stop_flood.set()
        for t in floods:
            t.join(timeout=30.0)
        np.testing.assert_allclose(out["score"],
                                   _online_rows(2, seed=7) @ ONLINE_W,
                                   rtol=1e-6)
        assert len(flooded) > 0
    finally:
        srv.stop()


def test_oversize_request_and_unknown_tenant_rejected(online_export):
    srv = _online_server(online_export, batch_size=8)
    try:
        with pytest.raises(KeyError):
            srv.submit("nope", {"features": _online_rows(1)})
        with pytest.raises(ValueError, match="split it client-side"):
            srv.submit("a", {"features": _online_rows(9)})
        with pytest.raises(ValueError, match="unknown request field"):
            srv.submit("a", {"features": _online_rows(1), "bogus": [1]})
        with pytest.raises(ValueError, match="rows have shape"):
            srv.submit("a", {"features": np.zeros((1, 7), np.float32)})
    finally:
        srv.stop()


def test_specless_shape_mismatch_fails_batch_not_server(online_export):
    """Two spec-less requests with incompatible row shapes: the mismatched
    one fails (in the coalesced batch's assembly, or in the forward), and
    the server keeps serving afterwards."""
    srv = online.OnlineServer()
    srv.add_tenant("a", export_dir=online_export, predict_fn=_online_predict,
                   batch_size=8, bucket_sizes=[8], flush_ms=100.0,
                   input_mapping={"features": "features"}, warmup=False)
    srv.start()
    try:
        outcomes = {}

        def go(i, width):
            try:
                outcomes[i] = srv.submit(
                    "a", {"features": np.zeros((1, width), np.float32)},
                    timeout=30.0)
            except RuntimeError as e:
                outcomes[i] = e

        threads = [threading.Thread(target=go, args=(0, 4)),
                   threading.Thread(target=go, args=(1, 7))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert len(outcomes) == 2
        assert isinstance(outcomes[1], RuntimeError), outcomes
        x = _online_rows(1)
        out = srv.submit("a", {"features": x}, timeout=30.0)
        np.testing.assert_allclose(out["score"], x @ ONLINE_W, rtol=1e-6)
    finally:
        srv.stop()


def test_different_output_mapping_gets_its_own_batches(online_export):
    srv = _online_server(online_export, tenants=("a",))
    srv.add_tenant("renamed", export_dir=online_export,
                   predict_fn=_online_predict, batch_size=8,
                   bucket_sizes=[2, 8], flush_ms=10.0,
                   input_mapping={"features": "features"},
                   output_mapping={"score": "prob"},
                   warmup_example={"features": np.zeros(4, np.float32)})
    try:
        x = _online_rows(1)
        out_a = srv.submit("a", {"features": x}, timeout=30.0)
        out_r = srv.submit("renamed", {"features": x}, timeout=30.0)
        assert "score" in out_a
        assert "prob" in out_r and "score" not in out_r
        np.testing.assert_allclose(out_r["prob"], x @ ONLINE_W, rtol=1e-6)
        assert srv.stats()["models_loaded"] == 2
    finally:
        srv.stop()


def test_stop_fails_pending_requests_loudly(online_export):
    gate = threading.Event()
    srv = _online_server(online_export, predict_fn=_gated(gate),
                         flush_ms=1.0, warmup=False)
    errors = []

    def go():
        try:
            srv.submit("a", {"features": _online_rows(1)}, timeout=30.0)
            errors.append(None)
        except RuntimeError as e:
            errors.append(e)

    threads = [threading.Thread(target=go, daemon=True) for _ in range(4)]
    try:
        for t in threads:
            t.start()
        deadline = time.time() + 30
        while srv.stats()["requests_total"] < 4 and time.time() < deadline:
            time.sleep(0.005)
    finally:
        gate.set()
        srv.stop()
    for t in threads:
        t.join(timeout=30.0)
    assert len(errors) == 4
    assert srv.state == "stopped"
    with pytest.raises(RuntimeError, match="not serving"):
        srv.submit("a", {"features": _online_rows(1)})


def test_forward_error_propagates_to_every_caller(online_export):
    from tensorflowonspark_torch import obs

    def broken(p, b):
        raise ValueError("kaboom")

    srv = _online_server(online_export, predict_fn=broken, flush_ms=1.0,
                         warmup=False)
    try:
        with pytest.raises(RuntimeError, match="kaboom"):
            srv.submit("a", {"features": _online_rows(1)}, timeout=30.0)
        assert obs.counter("online_errors_total").value >= 1
    finally:
        srv.stop()


def test_warm_on_load_precompiles_every_bucket(online_export):
    from tensorflowonspark_torch import obs

    compiles = obs.counter("serving_compiles_total")
    warmed = obs.counter("serving_compile_warmed_total")
    c0, w0 = compiles.value, warmed.value
    srv = _online_server(online_export, bucket_sizes=(2, 8), warmup=True)
    try:
        assert compiles.value - c0 == 2  # == len(buckets)
        assert warmed.value - w0 == 2  # both met before any request
        out = srv.submit("a", {"features": _online_rows(1)}, timeout=30.0)
        np.testing.assert_allclose(out["score"], _online_rows(1) @ ONLINE_W,
                                   rtol=1e-6)
        assert compiles.value - c0 == 2  # the request hit a warmed shape
    finally:
        srv.stop()


def test_warmup_true_without_shapes_raises(online_export):
    srv = online.OnlineServer()
    with pytest.raises(ValueError, match="warmup"):
        srv.add_tenant("a", export_dir=online_export,
                       predict_fn=_online_predict,
                       input_mapping={"features": "features"}, warmup=True)


def test_online_flight_plane_records_stages(online_export):
    srv = _online_server(online_export, flush_ms=1.0)
    rec = port_flight.recorder("online")
    before = rec.batches
    try:
        for i in range(3):
            srv.submit("a", {"features": _online_rows(1, seed=i)},
                       timeout=30.0)
    finally:
        srv.stop()
    assert rec.batches > before
    snap = rec.snapshot()
    assert {"wait", "compute", "reply"} <= set(snap["stages_s"])
    assert "coalesce" in snap["overlapped_stages_s"]
    assert port_flight.classify({"reply": 1.0}) == "emit_bound"
    assert port_flight.classify({"coalesce": 1.0}) == "ingest_bound"


def test_http_predict_metrics_healthz_pipeline(online_export):
    from tensorflowonspark_torch.obs import httpd

    srv = _online_server(online_export, flush_ms=2.0)
    http = online.OnlineHTTPServer(srv)
    http.start()
    try:
        x = _online_rows(2, seed=3)
        status, doc = _post(http.url("/v1/predict"),
                            {"tenant": "a",
                             "inputs": {"features": x.tolist()}})
        assert status == 200 and doc["rows"] == 2
        np.testing.assert_allclose(np.asarray(doc["outputs"]["score"]),
                                   x @ ONLINE_W, rtol=1e-5)
        assert doc["latency_ms"] > 0
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(http.url("/v1/predict"),
                  {"tenant": "nope", "inputs": {"features": x.tolist()}})
        assert ei.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(http.url("/v1/predict"), {"tenant": "a"})
        assert ei.value.code == 400
        with urllib.request.urlopen(http.url("/metrics"), timeout=30) as r:
            text = r.read().decode()
        assert "online_requests_total" in text
        assert "online_request_seconds_bucket" in text
        assert 'tenant="a"' in text
        assert "online_request_seconds_a" not in text
        assert httpd.validate_prometheus_text(text) == []
        with urllib.request.urlopen(http.url("/healthz"), timeout=30) as r:
            health_doc = json.loads(r.read().decode())
        assert r.status == 200
        assert health_doc["state"] == "serving"
        assert health_doc["tenants"]["a"]["latency_p99_ms"] is not None
        adm = health_doc["admission"]
        assert adm["admission_schema"] == 1
        assert adm["pending_bytes"] >= 0 and adm["max_pending_bytes"] > 0
        assert 0.0 <= adm["saturation"] <= 1.0
        assert set(adm["shed_window"]) == {"window_s", "offered", "shed",
                                           "shed_rate"}
        with urllib.request.urlopen(http.url("/pipeline"), timeout=30) as r:
            pipe = json.loads(r.read().decode())
        assert pipe["planes"]["online"]["verdict"] in port_flight.VERDICTS
    finally:
        http.stop()
        srv.stop()


def test_http_shed_maps_to_429_with_retry_after(online_export):
    gate = threading.Event()
    srv = _online_server(online_export, predict_fn=_gated(gate),
                         flush_ms=1.0, warmup=False,
                         max_pending_mb=3 * 16 / (1 << 20))
    http = online.OnlineHTTPServer(srv)
    http.start()
    try:
        x = _online_rows(1)

        def fire():
            try:
                _post(http.url("/v1/predict"),
                      {"tenant": "a", "inputs": {"features": x.tolist()}})
            except urllib.error.HTTPError:
                pass

        _fill_to_bound(
            srv, lambda: threading.Thread(target=fire, daemon=True).start())
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(http.url("/v1/predict"),
                  {"tenant": "a", "inputs": {"features": x.tolist()},
                   "timeout_s": 1.0})
        assert ei.value.code == 429
        assert float(ei.value.headers["Retry-After"]) > 0
        assert "shed" in json.loads(ei.value.read().decode())["error"]
    finally:
        gate.set()
        http.stop()
        srv.stop()


def test_healthz_503_after_stop(online_export):
    srv = _online_server(online_export)
    http = online.OnlineHTTPServer(srv)
    http.start()
    try:
        srv.stop()
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(http.url("/healthz"), timeout=30)
        assert ei.value.code == 503
    finally:
        http.stop()


def _check_trace():
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import check_trace

    return check_trace


def test_request_tracing_e2e_http(online_export, monkeypatch):
    from tensorflowonspark_torch.obs import httpd
    from tensorflowonspark_torch.obs import trace as trace_lib

    check_trace = _check_trace()
    monkeypatch.setenv("TFOS_TRACE_SAMPLE", "0")
    monkeypatch.setenv("TFOS_TRACE_ARM", "1")
    store = trace_lib.get_trace_store()
    store.clear()
    srv = online.OnlineServer()
    for name, slo in (("slow", 0.0), ("fast", 60_000.0)):
        srv.add_tenant(
            name, export_dir=online_export, predict_fn=_online_predict,
            batch_size=8, bucket_sizes=[2, 8], flush_ms=5.0, slo_ms=slo,
            warmup_example={"features": np.zeros(4, np.float32)})
    srv.start()
    http = online.OnlineHTTPServer(srv)
    http.start()
    try:
        ctx = trace_lib.TraceContext.new()
        x = _online_rows(1, seed=11)
        status, doc = _post(
            http.url("/v1/predict"),
            {"tenant": "slow", "inputs": {"features": x.tolist()}},
            headers={"traceparent": ctx.traceparent()})
        assert status == 200 and doc["trace_id"] == ctx.trace_id
        _post(http.url("/v1/predict"),
              {"tenant": "fast",
               "inputs": {"features": _online_rows(1, seed=12).tolist()}})
        deadline = time.perf_counter() + 30.0
        while True:
            with urllib.request.urlopen(http.url("/debug/requests"),
                                        timeout=30) as r:
                debug = json.loads(r.read().decode())
            if debug["committed"] >= 2 or time.perf_counter() > deadline:
                break
            time.sleep(0.01)
        assert check_trace.validate_requests_doc(debug) == []
        traces = {t["trace_id"]: t for t in debug["retained"]}
        mine = traces[ctx.trace_id]
        assert mine["retained"] == "slo_breach" and mine["status"] == "ok"
        assert mine["parent_span_id"] == ctx.span_id
        spans = {s["name"]: s for s in mine["spans"]}
        assert set(spans) == {"admission", "queue", "coalesce", "forward",
                              "reply", "online.request"}
        coalesce = spans["coalesce"]["attrs"]
        assert coalesce["flush"] in ("deadline", "full_bucket",
                                     "engine_idle")
        assert coalesce["bucket"] in (2, 8) and coalesce["batch_id"] >= 1
        assert 0.0 <= coalesce["pad_waste"] < 1.0
        assert coalesce["batch_mates"] == []
        assert spans["forward"]["attrs"]["batch_id"] == coalesce["batch_id"]
        assert all((t["spans"][-1]["attrs"] or {}).get("tenant") != "fast"
                   for t in debug["retained"])
        req = urllib.request.Request(
            http.url("/metrics"),
            headers={"Accept": "application/openmetrics-text"})
        with urllib.request.urlopen(req, timeout=30) as r:
            om = r.read().decode()
        assert httpd.validate_openmetrics_text(om) == []
        assert any("online_request_seconds_bucket" in ln
                   and 'tenant="slow"' in ln
                   for ln in om.splitlines() if ctx.trace_id in ln)
        with urllib.request.urlopen(http.url("/metrics"), timeout=30) as r:
            classic = r.read().decode()
        assert httpd.validate_prometheus_text(classic) == []
        assert ctx.trace_id not in classic
    finally:
        http.stop()
        srv.stop()
        store.clear()


def test_batch_mates_cross_reference(online_export, monkeypatch):
    from tensorflowonspark_torch.obs import trace as trace_lib

    check_trace = _check_trace()
    monkeypatch.setenv("TFOS_TRACE_SAMPLE", "0")
    monkeypatch.setenv("TFOS_TRACE_ARM", "1")
    store = trace_lib.get_trace_store()
    store.clear()
    gate = threading.Event()
    srv = _online_server(online_export, predict_fn=_gated(gate),
                         flush_ms=250.0, warmup=False, slo_ms=0.0)
    try:
        results = []

        def go(seed):
            results.append(srv.submit(
                "a", {"features": _online_rows(1, seed=seed)}, timeout=30.0))

        t1 = threading.Thread(target=go, args=(1,), daemon=True)
        t1.start()
        deadline = time.perf_counter() + 30.0
        # request 1 drained into the stalled batch
        while (srv.stats()["tenants"]["a"]["pending_rows"] != 0
               or srv._inflight < 1) and time.perf_counter() < deadline:
            time.sleep(0.005)
        t2 = threading.Thread(target=go, args=(2,), daemon=True)
        t3 = threading.Thread(target=go, args=(3,), daemon=True)
        t2.start(), t3.start()
        deadline = time.perf_counter() + 30.0
        while srv.stats()["tenants"]["a"]["pending_rows"] < 2 \
                and time.perf_counter() < deadline:
            time.sleep(0.005)
        gate.set()
        for t in (t1, t2, t3):
            t.join(timeout=30.0)
        assert len(results) == 3
        retained = store.recent(limit=10)
        assert check_trace.validate_requests_doc(retained) == []
        mates = [t for t in retained if any(
            (s.get("attrs") or {}).get("batch_mates") for s in t["spans"])]
        assert len(mates) >= 2
        ids = {t["trace_id"] for t in mates}
        for t in mates:
            co = next(s for s in t["spans"] if s["name"] == "coalesce")
            listed = set(co["attrs"]["batch_mates"])
            assert listed and listed <= (ids - {t["trace_id"]})
    finally:
        gate.set()
        srv.stop()
        store.clear()


def test_shed_and_error_requests_are_tail_retained(online_export,
                                                   monkeypatch):
    from tensorflowonspark_torch.obs import trace as trace_lib

    check_trace = _check_trace()
    monkeypatch.setenv("TFOS_TRACE_SAMPLE", "0")
    store = trace_lib.get_trace_store()
    store.clear()
    gate = threading.Event()
    srv = _online_server(online_export, predict_fn=_gated(gate),
                         flush_ms=1.0, warmup=False, slo_ms=60_000.0,
                         max_pending_mb=3 * 16 / (1 << 20))

    def swallow():
        try:
            srv.submit("a", {"features": _online_rows(1)}, timeout=60.0)
        except Exception:
            pass

    try:
        _fill_to_bound(
            srv, lambda: threading.Thread(target=swallow, daemon=True).start())
        with pytest.raises(online.Rejected):
            srv.submit("a", {"features": _online_rows(1)}, timeout=0.5)
    finally:
        gate.set()
        srv.stop()
    sheds = [t for t in store.recent(limit=50) if t["status"] == "shed"]
    assert sheds and sheds[0]["retained"] == "shed"
    admission = next(s for s in sheds[0]["spans"]
                     if s["name"] == "admission")
    assert admission["attrs"]["outcome"] == "shed"
    assert admission["attrs"]["max_pending_bytes"] > 0
    assert check_trace.validate_requests_doc(sheds) == []
    store.clear()


def test_tracing_disabled_by_env_retains_nothing(online_export,
                                                 monkeypatch):
    from tensorflowonspark_torch.obs import trace as trace_lib

    monkeypatch.setenv("TFOS_TRACE_REQUESTS", "0")
    store = trace_lib.get_trace_store()
    store.clear()
    srv = _online_server(online_export, flush_ms=1.0, slo_ms=0.0)
    try:
        out = srv.submit("a", {"features": _online_rows(1)}, timeout=30.0)
        assert "score" in out
        assert store.committed == 0 and store.recent() == []
    finally:
        srv.stop()


def test_healthz_reports_shed_window_and_slo(online_export):
    srv = _online_server(online_export, flush_ms=2.0)
    try:
        srv.submit("a", {"features": _online_rows(1)}, timeout=30.0)
        doc = srv.stats()["tenants"]["a"]
        assert doc["slo_ms"] == 20.0  # default: 10 × flush_ms
        win = doc["shed_window"]
        assert win["offered"] >= 1 and win["shed"] == 0
        assert win["shed_rate"] == 0.0 and win["window_s"] > 0
    finally:
        srv.stop()


def test_shed_window_rate_rises_and_tumbles():
    win = online._ShedWindow(interval_s=10.0)
    now = 1000.0
    for _ in range(8):
        win.note(shed=False, now=now)
    for _ in range(2):
        win.note(shed=True, now=now)
    snap = win.snapshot(now=now)
    assert snap["offered"] == 10 and snap["shed"] == 2
    assert snap["shed_rate"] == 0.2
    assert win.snapshot(now=now + 10.0)["offered"] == 10
    snap = win.snapshot(now=now + 20.0)
    assert snap["offered"] == 0 and snap["shed_rate"] == 0.0


def test_remove_tenant_evicts_metric_series(online_export):
    from tensorflowonspark_torch import obs

    srv = _online_server(online_export, tenants=("a", "b"))
    try:
        srv.submit("a", {"features": _online_rows(1)}, timeout=30.0)
        text = obs.get_registry().to_prometheus()
        assert 'online_tenant_requests_total{tenant="a"}' in text
        srv.remove_tenant("a")
        text = obs.get_registry().to_prometheus()
        assert 'online_tenant_requests_total{tenant="a"}' not in text
        with pytest.raises(KeyError):
            srv.submit("a", {"features": _online_rows(1)})
        assert "score" in srv.submit("b", {"features": _online_rows(1)},
                                     timeout=30.0)
    finally:
        srv.stop()


def test_legacy_name_mangled_series_never_published(online_export):
    from tensorflowonspark_torch import obs

    srv = _online_server(online_export, tenants=("gone",))
    try:
        srv.submit("gone", {"features": _online_rows(1)}, timeout=30.0)
        text = obs.get_registry().to_prometheus()
        assert 'online_tenant_requests_total{tenant="gone"}' in text
        for legacy in ("online_requests_gone_total", "online_shed_gone_total",
                       "online_request_seconds_gone"):
            assert legacy not in text
        srv.remove_tenant("gone")
        assert 'tenant="gone"' not in obs.get_registry().to_prometheus()
    finally:
        srv.stop()


def test_stats_admission_block_aggregates_tenants(online_export):
    srv = _online_server(online_export, tenants=("a", "b"),
                         max_pending_mb=1.0)
    try:
        srv.submit("a", {"features": _online_rows(2)}, timeout=30.0)
        srv.submit("b", {"features": _online_rows(1)}, timeout=30.0)
        doc = srv.stats()
        adm, tenants = doc["admission"], doc["tenants"].values()
        assert adm["admission_schema"] == 1
        for k in ("max_pending_bytes", "pending_bytes", "pending_rows"):
            assert adm[k] == sum(t[k] for t in tenants)
        w = adm["shed_window"]
        assert w["offered"] == sum(t["shed_window"]["offered"]
                                   for t in tenants)
        assert w["offered"] >= 2 and w["shed"] == 0 and w["shed_rate"] == 0
        assert adm["saturation"] == pytest.approx(
            adm["pending_bytes"] / adm["max_pending_bytes"], abs=1e-4)
        assert doc["uptime_s"] is not None and doc["uptime_s"] >= 0.0
    finally:
        srv.stop()


def test_timeout_commit_not_double_counted_by_late_reply(online_export,
                                                         monkeypatch):
    from tensorflowonspark_torch.obs import trace as trace_lib

    monkeypatch.setenv("TFOS_TRACE_SAMPLE", "0")
    monkeypatch.setenv("TFOS_TRACE_ARM", "1")
    store = trace_lib.get_trace_store()
    store.clear()
    gate = threading.Event()
    srv = _online_server(online_export, predict_fn=_gated(gate),
                         flush_ms=1.0, warmup=False, slo_ms=60_000.0)
    try:
        with pytest.raises(TimeoutError):
            srv.submit("a", {"features": _online_rows(1)}, timeout=0.3)
        gate.set()
        deadline = time.perf_counter() + 30.0
        while store.committed < 1 and time.perf_counter() < deadline:
            time.sleep(0.01)
        # the late reply's bookkeeping: wait for the batch to be answered
        deadline = time.perf_counter() + 30.0
        while srv._inflight and time.perf_counter() < deadline:
            time.sleep(0.01)
        time.sleep(0.05)
        assert store.committed == 1
        retained = store.recent()
        assert len(retained) == 1 and retained[0]["status"] == "timeout"
    finally:
        gate.set()
        srv.stop()
        store.clear()


def test_healthz_surfaces_compile_cache_state(online_export):
    """The reference's ``test_shapes.py`` case: ``/healthz`` carries the
    ``compile_cache`` block (the store's state, the signature counters,
    ``warm_ratio``), JSON-able."""
    srv = online.OnlineServer()
    try:
        cc = srv.stats()["compile_cache"]
        for k in ("enabled", "dir", "namespace", "disk_hits",
                  "disk_writes", "compiles_total", "in_process_hits",
                  "true_misses", "warm_ratio", "warmed"):
            assert k in cc, k
        json.dumps(srv.stats())
    finally:
        srv.stop()


def _closed_loop(submit, n, clients=4):
    """``submit(j)`` for rows 0..n-1 from ``clients`` threads, each sending
    its rows one at a time: the replies by row."""
    replies, errors = {}, []

    def client(c):
        for j in range(c, n, clients):
            try:
                replies[j] = submit(j)
            except Exception as e:  # surfaced below
                errors.append(e)

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    return replies


def test_online_replies_match_the_jax_online_tier(tmp_path, monkeypatch):
    """The slice end to end on the CPU: the JAX package's tiny GroupNorm
    ResNet and tiny wide&deep, exported by its ``Trainer``; the same
    weights carried into the port (``params_from_flax``) and exported by
    the port; both served as two tenants, warmed on load, by the
    reference's ``OnlineServer`` and the port's, to the same seeded
    single-row requests from concurrent clients.  Every reply agrees
    within the f32 tolerance of the TFModel parity test above (rtol and
    atol 1e-5)."""
    import dataclasses

    from tensorflowonspark_torch import saved_model
    from tensorflowonspark_torch.models import widedeep as port_wd
    from tensorflowonspark_tpu import ckpt as jax_ckpt
    from tensorflowonspark_tpu.models import widedeep as ref_wd
    from tensorflowonspark_tpu.trainer import Trainer as JaxTrainer

    monkeypatch.setenv(util.DEVICE_ENV, "cpu")
    rcfg, wcfg = ref.Config.tiny(), ref_wd.Config.tiny()
    exports = {}
    jr = JaxTrainer("resnet50", config=rcfg, seed=0)
    jw = JaxTrainer("wide_deep", config=wcfg, seed=0)
    jw.step(ref_wd.example_batch(wcfg, 16))  # tables off their init
    for name, jt, lib, plib in (("resnet", jr, ref, port),
                                ("ctr", jw, ref_wd, port_wd)):
        jd, pd = str(tmp_path / f"jax_{name}"), str(tmp_path / f"port_{name}")
        jt.export(jd)
        st = jax_ckpt.load_pytree(os.path.join(jd, "model"))
        pcfg = plib.Config(**dataclasses.asdict(jt.config))
        state = (plib.params_from_flax(st["params"]) if name == "resnet"
                 else plib.params_from_flax(st["params"], st["collections"]))
        compat.export_saved_model(
            state, pd, forward_fn=saved_model.wrap_state_forward(
                plib.serving_forward, plib.make_serving_model(pcfg)),
            example_batch={k: v for k, v in plib.example_batch(
                pcfg, 2).items() if k != "label"})
        exports[name] = (jd, pd)
    tenants = {"resnet": dict(input_mapping={"image": "image"},
                              batch_size=8, bucket_sizes=[4, 8]),
               "ctr": dict(input_mapping={"dense": "dense", "cat": "cat"},
                           batch_size=8, bucket_sizes=[4, 8], flush_ms=5.0)}
    rows = {"resnet": {"image": _images(12, seed=9)},
            "ctr": {k: v for k, v in ref_wd.example_batch(
                wcfg, 16, seed=9).items() if k != "label"}}
    replies = {}
    for side, mod in (("jax", ref_online), ("port", online)):
        srv = mod.OnlineServer()
        for name, kw in tenants.items():
            srv.add_tenant(name, export_dir=exports[name][side == "port"],
                           **kw)
        srv.start()
        try:
            for name, cols in rows.items():
                n = len(next(iter(cols.values())))
                replies[(side, name)] = _closed_loop(
                    lambda j, name=name, cols=cols, srv=srv: srv.submit(
                        name, {k: v[j:j + 1] for k, v in cols.items()},
                        timeout=60.0), n)
        finally:
            srv.stop()
    for name in rows:
        got, want = replies[("port", name)], replies[("jax", name)]
        assert sorted(got) == sorted(want)
        for j in want:
            assert sorted(got[j]) == sorted(want[j])
            for col in want[j]:
                np.testing.assert_allclose(
                    np.asarray(got[j][col], np.float32),
                    np.asarray(want[j][col], np.float32),
                    rtol=1e-5, atol=1e-5, err_msg=f"{name} row {j}")


# -- serving.note_rows and cache_health (reference tests/test_serving.py) ---


def test_note_rows_derives_padding_waste_ratio_gauge():
    from tensorflowonspark_torch import obs

    serving.note_rows(24, 32)
    rows = obs.counter("serving_rows_total").value
    padded = obs.counter("serving_padded_rows_total").value
    gauge = obs.gauge("serving_padding_waste_ratio").value
    assert gauge == pytest.approx(padded / (rows + padded))
    serving.note_rows(32, 32)  # a full batch moves the ratio down
    assert obs.gauge("serving_padding_waste_ratio").value < gauge


def test_padding_waste_warning_fires_once_over_threshold(monkeypatch):
    from tensorflowonspark_torch import obs

    monkeypatch.setattr(serving, "_PAD_WASTE_WARNED", False)
    monkeypatch.setenv("TFOS_SERVING_PAD_WASTE_WARN", "0.000001")
    tracer = obs.get_tracer()

    def fired():
        return sum(1 for e in tracer.snapshot()
                   if e["name"] == "serving.padding_waste")

    before = fired()
    serving.note_rows(1, serving._PAD_WARN_MIN_ROWS)
    serving.note_rows(1, serving._PAD_WARN_MIN_ROWS)
    assert fired() == before + 1 and serving._PAD_WASTE_WARNED is True
    attrs = [e for e in tracer.snapshot()
             if e["name"] == "serving.padding_waste"][-1]["attrs"]
    assert attrs["ratio"] > 0
    assert {"threshold", "rows", "padded"} <= set(attrs)
    serving.note_rows(1, serving._PAD_WARN_MIN_ROWS)
    assert fired() == before + 1  # warned once


def test_padding_waste_warning_respects_min_volume(monkeypatch):
    from tensorflowonspark_torch import obs

    monkeypatch.setattr(serving, "_PAD_WASTE_WARNED", False)
    monkeypatch.setenv("TFOS_SERVING_PAD_WASTE_WARN", "0.000001")
    monkeypatch.setattr(serving, "_PAD_WARN_MIN_ROWS", 10**12)
    tracer = obs.get_tracer()
    before = sum(1 for e in tracer.snapshot()
                 if e["name"] == "serving.padding_waste")
    serving.note_rows(1, 64)
    assert sum(1 for e in tracer.snapshot()
               if e["name"] == "serving.padding_waste") == before
    assert serving._PAD_WASTE_WARNED is False


def test_cache_health_counts_warmed_hits_and_true_misses():
    """``warm_ratio`` = (hits + warmed) / (hits + warmed + true misses):
    a signature a warmup met (captured on the card) is warm; one a
    request met first is a true miss, settled by the first call's timing
    (or the thread's next ``note_compile`` when it was never timed)."""
    key = ("cache_health_test", object())
    before = serving.cache_health()
    a = {"x": np.zeros((4, 3), np.float32)}
    b = {"x": np.zeros((8, 3), np.float32)}
    assert serving.note_compile(key, a, warm=True)
    serving.observe_compile_seconds(0.01)
    assert not serving.note_compile(key, a)  # a hit
    assert serving.note_compile(key, b)  # met by a request
    serving.observe_compile_seconds(0.02)
    c = {"x": np.zeros((2, 3), np.float32)}
    assert serving.note_compile(key, c)  # never timed: settles below
    assert not serving.note_compile(key, a)
    after = serving.cache_health()
    serving.forget(key)
    delta = {k: after[k] - before[k] for k in (
        "compiles_total", "in_process_hits", "warmed", "true_misses")}
    assert delta == {"compiles_total": 3, "in_process_hits": 2,
                     "warmed": 1, "true_misses": 2}
    warm = after["in_process_hits"] + after["warmed"]
    assert after["warm_ratio"] == round(warm / (warm + after["true_misses"]),
                                        4)
    json.dumps(after)


# -- the serving health probe (reference pipeline.py:903-944) ---------------


@pytest.mark.parametrize("device,env,want", [
    ("cpu", None, False), ("cuda", None, True),
    ("cpu", "1", True), ("cuda", "0", False),
    ("cuda", "false", False), ("cpu", "yes", True)])
def test_should_probe_serving(monkeypatch, device, env, want):
    if env is None:
        monkeypatch.delenv("TFOS_HEALTH_PROBE", raising=False)
    else:
        monkeypatch.setenv("TFOS_HEALTH_PROBE", env)
    assert health.should_probe_serving(device) is want


@pytest.fixture()
def fresh_probe_memo(monkeypatch):
    monkeypatch.setattr(pipeline, "_SERVING_PROBED", False)
    monkeypatch.setattr(pipeline, "_SERVING_PROBE_ERROR", None)
    monkeypatch.setenv(util.DEVICE_ENV, "cpu")


def test_failing_probe_is_memoized_and_raised_on_every_call(
        monkeypatch, fresh_probe_memo):
    calls = []

    def probe(timeout_s):
        # the memo is set only after the probe returns
        calls.append(pipeline._SERVING_PROBED)
        return "device health probe hung for 1s (card wedged?)"

    monkeypatch.setattr(health, "probe_chip_health", probe)
    monkeypatch.setenv("TFOS_HEALTH_PROBE", "1")
    for _ in range(3):
        with pytest.raises(RuntimeError, match="wedged"):
            pipeline.single_node_env()
    assert calls == [False]


def test_probe_that_raises_is_memoized_like_a_failed_verdict(
        monkeypatch, fresh_probe_memo):
    calls = []

    def probe(timeout_s):
        calls.append(timeout_s)
        raise OSError("spawn failed")

    monkeypatch.setattr(health, "probe_chip_health", probe)
    monkeypatch.setenv("TFOS_HEALTH_PROBE", "1")
    monkeypatch.setenv("TFOS_HEALTH_PROBE_TIMEOUT_S", "7.5")
    for _ in range(2):
        with pytest.raises(RuntimeError, match="raised unexpectedly"):
            pipeline.single_node_env()
    assert calls == [7.5]


def test_healthy_probe_runs_once_and_cpu_probes_nothing(
        monkeypatch, fresh_probe_memo):
    calls = []
    monkeypatch.setattr(health, "probe_chip_health",
                        lambda timeout_s: calls.append(1))
    monkeypatch.delenv("TFOS_HEALTH_PROBE", raising=False)
    assert pipeline.single_node_env() == torch.device("cpu")
    assert calls == [] and pipeline._SERVING_PROBED is False
    monkeypatch.setenv("TFOS_HEALTH_PROBE", "1")
    for _ in range(3):
        assert pipeline.single_node_env() == torch.device("cpu")
    assert calls == [1] and pipeline._SERVING_PROBED is True


def test_serving_probe_runs_the_real_watchdogged_child(
        monkeypatch, fresh_probe_memo):
    """Forced on the CPU, the real probe (a fresh child's numpy matmul)
    passes once and is not run again."""
    monkeypatch.setenv("TFOS_HEALTH_PROBE", "1")
    assert pipeline.single_node_env() == torch.device("cpu")
    assert pipeline._SERVING_PROBED and pipeline._SERVING_PROBE_ERROR is None


# -- the captured serving forward's host side --------------------------------


class StandInForwardGraphs:
    """``CapturedForward``'s graph backend on the CPU: CPU tensors count as
    the card's; a capture runs the forward once and keeps its outputs as
    the static outputs; a replay reruns it on the static inputs and
    overwrites the static outputs in place, as a CUDA graph replay does.
    ``pools_of_captures`` records the pool each capture went into."""

    def __init__(self):
        self.pools = 0
        self.pools_of_captures = []

    def reset(self):
        self.pools += 1

    @staticmethod
    def device_leaf(leaf):
        return isinstance(leaf, torch.Tensor)

    def applies(self, batch):
        return any(isinstance(t, torch.Tensor)
                   for t in shapes.leaves(batch))

    def capture(self, fn):
        self.pools_of_captures.append(self.pools)
        out = fn()
        return {"fn": fn, "out": out}, out

    @staticmethod
    def replay(graph):
        new = graph["fn"]()
        with torch.inference_mode():
            for dst, src in zip(shapes.leaves(graph["out"]),
                                shapes.leaves(new)):
                if isinstance(dst, torch.Tensor):
                    dst.copy_(src)


def _doubling(params, batch):
    return {"y": batch["x"] * params["scale"]}


def test_captured_forward_eager_then_capture_then_replay():
    graphs = StandInForwardGraphs()
    fwd = port_train.CapturedForward(_doubling, {"scale": 2.0},
                                     graphs=graphs)
    xs = [torch.full((4, 3), float(i)) for i in range(4)]
    actions = []
    replayed0 = port_train.replayed_forwards
    for x in xs:
        out = fwd({"x": x}, take=fwd.hold)
        actions.append(fwd.last)
        assert torch.equal(out["y"], x * 2.0)
    assert actions == ["eager", "capture", "replay", "replay"]
    assert (fwd.captures, fwd.replays, fwd.eager_calls) == (1, 3, 1)
    assert port_train.replayed_forwards - replayed0 == 2
    # another signature starts over, and is captured in a pool of its own
    fwd({"x": torch.ones(2, 3)})
    assert fwd.last == "eager"
    fwd({"x": torch.ones(2, 3)})
    assert fwd.last == "capture"
    assert len(set(graphs.pools_of_captures)) == 2
    # warm captures at once; a CPU-only backend runs the forward as it is
    warm = port_train.CapturedForward(_doubling, {"scale": 2.0},
                                      graphs=StandInForwardGraphs())
    assert torch.equal(warm.warm({"x": xs[1]})["y"], xs[1] * 2.0)
    assert warm.last == "capture" and warm.eager_calls == 1
    assert warm.graph_of({"x": xs[2]}) is not None
    assert len(warm.capture_seconds) == 1
    cpu = port_train.CapturedForward(_doubling, {"scale": 2.0})
    cpu({"x": xs[1]})
    cpu({"x": xs[1]})
    assert cpu.last == "cpu" and cpu.captures == 0
    bad = port_train.CapturedForward(_doubling, {"scale": 2.0},
                                     graphs=StandInForwardGraphs())
    with pytest.raises(TypeError, match="on the card"):
        bad._capture(("sig",), bad._state, {"x": np.zeros(2)})


def test_a_replay_hands_back_its_static_outputs_and_take_copies_them():
    """Without ``take`` a replay's outputs are the graph's static ones,
    which the next replay overwrites; ``take`` runs on them before another
    call can replay (``hold`` copies, ``serving.to_host`` reads them to
    the host)."""
    fwd = port_train.CapturedForward(_doubling, {"scale": 3.0},
                                     graphs=StandInForwardGraphs())
    fwd.warm({"x": torch.zeros(4, 3)})
    static = fwd({"x": torch.ones(4, 3)})
    held = fwd({"x": torch.full((4, 3), 2.0)}, take=fwd.hold)
    host = fwd({"x": torch.full((4, 3), 5.0)}, take=serving.to_host)
    assert torch.equal(static["y"], torch.full((4, 3), 15.0))  # overwritten
    assert torch.equal(held["y"], torch.full((4, 3), 6.0))
    assert isinstance(host["y"], np.ndarray)
    np.testing.assert_array_equal(host["y"], np.full((4, 3), 15.0))


def test_a_predict_fn_runs_eagerly_on_every_call():
    """A user's ``predict_fn`` is never captured (the reference runs it as
    given): where graphs apply, each call still runs it, so host logic in
    it sees every batch."""
    calls = []

    def counting(params, batch):
        calls.append(int(batch["x"].shape[0]))
        return _doubling(params, batch)

    graphs = StandInForwardGraphs()
    fwd = port_train.CapturedForward(counting, {"scale": 2.0},
                                     graphs=graphs, capture=False)
    fwd.warm({"x": torch.zeros(4, 3)})
    for i in range(4):
        out = fwd({"x": torch.full((4, 3), float(i))})
        assert torch.equal(out["y"], torch.full((4, 3), 2.0 * i))
    assert calls == [4] * 5
    assert (fwd.captures, fwd.replays, fwd.eager_calls) == (0, 0, 5)
    assert graphs.pools_of_captures == [] and fwd.last == "eager"


def _run_model_on_stand_in(tmp_path, monkeypatch, n=40, hold=None):
    """``_RunModel`` over ``n`` rows of a tiny zoo MLP's export (a forward
    the port owns, so it is captured) at batch 8, its forward a
    ``CapturedForward`` over the stand-in graphs (so every batch after the
    second replays): the emitted logits, each row's own logits from the
    eager forward, and the captured forward."""
    from tensorflowonspark_torch.models import mnist

    monkeypatch.setenv(util.DEVICE_ENV, "cpu")
    monkeypatch.setenv("TFOS_SERVING_PREFETCH", "2")
    config = mnist.Config.tiny()
    d = str(tmp_path / "mlp")
    compat.export_saved_model(
        mnist.state_of(mnist.make_model(config, seed=3)), d)
    run = pipeline._RunModel(d, "mnist_mlp", None, 8, {"image": "image"},
                             None, ["image"], bucket_sizes=[8])
    fn, params = run._load()
    serving.forget(run._cache_key)
    fwd = serving.captured(run._cache_key, fn, params,
                           graphs=StandInForwardGraphs())
    if hold is not None:
        monkeypatch.setattr(port_train.CapturedForward, "hold",
                            staticmethod(hold))
    x = np.random.RandomState(21).rand(
        n, config.image_size ** 2).astype(np.float32)
    out = list(run(iter([{"image": x[i]} for i in range(n)])))
    serving.forget(run._cache_key)
    want = fn(params, {"image": torch.as_tensor(x)}).numpy()
    return np.array([r.prediction for r in out]), want, fwd


def test_one_batch_behind_emit_keeps_each_batchs_rows(tmp_path,
                                                      monkeypatch):
    """The emit runs one batch behind the forward, and a replay overwrites
    the static outputs: the rows of batch N must survive batch N+1's
    replay.  Against the stand-in graphs every row's logits are its own;
    with the copy out planted away (``hold`` handing back the static
    outputs) batch N emits batch N+1's rows."""
    got, want, fwd = _run_model_on_stand_in(tmp_path, monkeypatch)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert fwd.replays >= 3 and fwd.last == "replay"
    bad, want, _ = _run_model_on_stand_in(tmp_path, monkeypatch,
                                          hold=lambda outputs: outputs)
    assert not np.allclose(bad, want, rtol=1e-6, atol=1e-6)
    # batch 3 (a replay) was read after batch 4's replay: its rows are 4's
    np.testing.assert_allclose(bad[16:24], want[24:32], rtol=1e-6,
                               atol=1e-6)


def test_run_model_books_the_serve_flight_plane_and_ledger(tmp_path,
                                                           monkeypatch):
    from tensorflowonspark_torch.obs import ledger as ledger_mod

    rec = port_flight.recorder("serve")
    before = rec.batches
    led = ledger_mod.get_ledger()
    _run_model_on_stand_in(tmp_path, monkeypatch, n=24)
    assert rec.batches - before >= 2
    snap = rec.snapshot()
    assert {"wait", "compute", "emit"} <= set(snap["stages_s"])
    assert {"ingest", "pad", "stage"} <= set(snap["overlapped_stages_s"])
    assert "mnist_mlp" in json.dumps(led.summary())


def test_a_request_time_bucket_is_captured_at_its_second_sighting(
        tmp_path, monkeypatch):
    """A bucket no warmup met: its first batch runs eagerly (a true miss,
    counted once through note_compile), its second is captured, the rest
    replay; compiles equal signatures."""
    from tensorflowonspark_torch import obs

    compiles = obs.counter("serving_compiles_total")
    misses = obs.counter("serving_compile_cache_misses_total")
    c0, m0 = compiles.value, misses.value
    got, want, fwd = _run_model_on_stand_in(tmp_path, monkeypatch, n=32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (fwd.eager_calls, fwd.captures, fwd.replays) == (1, 1, 3)
    assert compiles.value - c0 == 1 and misses.value - m0 == 1


def test_run_model_serves_a_predict_fn_eagerly(tmp_path, monkeypatch):
    """Through ``_RunModel`` a ``predict_fn``'s forward is not captured
    (``_RunModel.captured``), even where graphs would apply: every batch
    calls it."""
    monkeypatch.setenv(util.DEVICE_ENV, "cpu")
    d = str(tmp_path / "toy")
    compat.export_saved_model({"params": {"w": ONLINE_W}}, d)
    batches = []

    def predict(p, b):
        batches.append(int(b["features"].shape[0]))
        return _online_predict(p, b)

    run = pipeline._RunModel(d, None, predict, 8, {"features": "features"},
                             None, ["features"], bucket_sizes=[8])
    fn, params = run._load()
    assert not run.captured().capture
    serving.forget(run._cache_key)
    fwd = serving.captured(run._cache_key, fn, params,
                           graphs=StandInForwardGraphs(), capture=False)
    x = _online_rows(40, seed=4)
    out = list(run(iter([{"features": x[i]} for i in range(40)])))
    serving.forget(run._cache_key)
    np.testing.assert_allclose([r.score for r in out], x @ ONLINE_W,
                               rtol=1e-6)
    assert batches == [8] * 5
    assert (fwd.captures, fwd.replays, fwd.eager_calls) == (0, 0, 5)


def test_warm_buckets_captures_every_bucket(tmp_path, monkeypatch):
    monkeypatch.setenv(util.DEVICE_ENV, "cpu")
    key = ("warm_buckets_test", object())
    params = {"scale": 2.0}
    fwd = serving.captured(key, _doubling, params,
                           graphs=StandInForwardGraphs())
    specs = {"x": ((3,), np.float32)}
    serving.warm_buckets(fwd, specs, (2, 4), key, torch.device("cpu"))
    assert fwd.captures == 2 and fwd.eager_calls == 2
    assert serving._SEEN_SHAPES[key] == set(
        shapes.enumerate_signatures(specs, (2, 4)))
    assert serving.captured(key, _doubling, params) is fwd
    # new params under the key (a re-export) make a new captured forward
    assert serving.captured(key, _doubling, {"scale": 2.0}) is not fwd
    serving.forget(key)
    assert key not in serving._CAPTURED and key not in serving._SEEN_SHAPES
