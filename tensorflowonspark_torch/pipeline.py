"""Spark ML pipeline integration: ``TFModel`` (batch inference).

Reference anchor: ``tensorflowonspark_tpu/pipeline.py`` (``TFParams`` +
``Has*`` param mixins, ``TFModel.transform(df)`` →
``df.rdd.mapPartitions(_RunModel)`` with a per-executor cached model).

The port serves by ``model_name``: the export holds weights only
(``compat.export_saved_model``), and each executor rebuilds the zoo model,
loads the weights once into ``_MODEL_CACHE`` and moves it to its device.
Per partition the bucketed serving data plane runs: columnar ingest → pad
to a bucket → stage onto the device on a pump thread (batch N+1 while
batch N computes) → forward → masked emit one batch behind.

Device rule: ``TFModel(device=...)``; unset, each executor reads
``TFOS_TORCH_DEVICE`` (inherited from the driver) and otherwise runs on
``cuda``, raising where there is no card (``util.select_device``).

Not ported yet: ``TFEstimator`` and all training, the self-describing
serialized forward, the obs spans / flight recorder / cost ledger of the
reference's ``_RunModel.__call__``, the persistent compile cache and the
serving health probe.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Sequence

import torch

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Param system (pyspark.ml.param protocol subset)
# ---------------------------------------------------------------------------


class Param:
    """A named parameter with documentation and an optional default."""

    def __init__(self, name: str, doc: str, default: Any = None):
        self.name = name
        self.doc = doc
        self.default = default

    def __repr__(self) -> str:  # pragma: no cover - debug only
        return f"Param({self.name!r})"


class Params:
    """Holds param values; mirrors ``pyspark.ml.param.Params``."""

    def __init__(self):
        self._paramMap: dict[str, Any] = {}

    @classmethod
    def _params(cls) -> dict[str, Param]:
        out = {}
        for klass in cls.__mro__:
            for k, v in vars(klass).items():
                if isinstance(v, Param):
                    out.setdefault(k, v)
        return out

    def _set(self, name: str, value: Any) -> "Params":
        if name not in self._params():
            raise KeyError(f"unknown param {name!r}")
        self._paramMap[name] = value
        return self

    def getOrDefault(self, name: str) -> Any:
        if name in self._paramMap:
            return self._paramMap[name]
        params = self._params()
        if name not in params:
            raise KeyError(f"unknown param {name!r}")
        return params[name].default

    def isDefined(self, name: str) -> bool:
        return name in self._paramMap or self._params()[name].default is not None

    def extractParamMap(self) -> dict[str, Any]:
        return {k: self.getOrDefault(k) for k in self._params()}


def _make_has(mixin_name: str, param_name: str, doc: str, default: Any = None):
    """Build a ``Has<X>`` mixin with ``set<X>``/``get<X>`` accessors."""
    suffix = mixin_name[3:]  # strip "Has"

    def setter(self, value):
        return self._set(param_name, value)

    def getter(self):
        return self.getOrDefault(param_name)

    return type(mixin_name, (Params,), {
        param_name: Param(param_name, doc, default),
        f"set{suffix}": setter,
        f"get{suffix}": getter,
    })


HasBatchSize = _make_has("HasBatchSize", "batch_size", "records per batch", 100)
HasInputMapping = _make_has(
    "HasInputMapping", "input_mapping",
    "dict: DataFrame column -> model input name", None)
HasOutputMapping = _make_has(
    "HasOutputMapping", "output_mapping",
    "dict: model output name -> DataFrame column", None)
HasModelDir = _make_has("HasModelDir", "model_dir",
                        "directory for training checkpoints", None)
HasExportDir = _make_has("HasExportDir", "export_dir",
                         "directory for the exported model", None)
HasSignatureDefKey = _make_has(
    "HasSignatureDefKey", "signature_def_key",
    "exported signature to use (parity; zoo models expose one forward)",
    "serving_default")
HasTagSet = _make_has("HasTagSet", "tag_set",
                      "SavedModel tag set (parity; unused by the export)",
                      "serve")
HasModelName = _make_has(
    "HasModelName", "model_name",
    "tensorflowonspark_torch.models zoo name used to rebuild the model at "
    "transform time (the export holds weights only)", None)
HasBucketSizes = _make_has(
    "HasBucketSizes", "bucket_sizes",
    "serving batch-shape buckets: every inference batch is zero-padded up "
    "to the smallest of these row counts (padded rows masked out of the "
    "output).  Default None = just [batch_size]", None)


class TFParams(Params):
    """Base class carrying the opaque ``tf_args`` namespace."""

    def __init__(self, tf_args: Any = None):
        super().__init__()
        self.tf_args = tf_args


# ---------------------------------------------------------------------------
# Model (transformer)
# ---------------------------------------------------------------------------

#: per-executor-process singleton: {cache_key: (forward, params, export
#: param specs)}; the key holds the export path's mtime, so a re-export
#: invalidates it
_MODEL_CACHE: dict[tuple, tuple[Callable, Any, dict]] = {}


class TFModel(TFParams, HasBatchSize, HasInputMapping, HasOutputMapping,
              HasModelDir, HasExportDir, HasSignatureDefKey, HasTagSet,
              HasModelName, HasBucketSizes):
    """Spark ML ``Model``: embarrassingly-parallel inference over a DataFrame.

    No cluster is formed; each executor loads the exported model once and
    maps its partitions.  The forward is an explicit ``predict_fn`` (a
    picklable ``f(params, inputs_dict) -> outputs`` over the export's
    ``params`` dict of numpy arrays and tensors on the device) or the zoo
    model named by ``model_name``.  ``device`` as in
    :func:`tensorflowonspark_torch.util.select_device`.
    """

    def __init__(self, tf_args: Any = None,
                 predict_fn: Callable[[Any, dict], Any] | None = None,
                 device: str | None = None):
        super().__init__(tf_args)
        self.predict_fn = predict_fn
        self.device = device

    def transform(self, df):
        return self._transform(df)

    def _run_model(self, columns, backend, bucket_sizes) -> "_RunModel":
        export_dir = self.getOrDefault("export_dir") or self.getOrDefault(
            "model_dir")
        if not export_dir:
            raise ValueError("TFModel needs export_dir or model_dir")
        return _RunModel(
            export_dir=export_dir,
            model_name=self.getOrDefault("model_name"),
            predict_fn=self.predict_fn,
            batch_size=self.getOrDefault("batch_size"),
            input_mapping=self.getOrDefault("input_mapping"),
            output_mapping=self.getOrDefault("output_mapping"),
            columns=columns, backend=backend, bucket_sizes=bucket_sizes,
            device=self.device)

    def warmup(self, buckets: Sequence[int] | None = None,
               example: dict | None = None) -> list[int]:
        """Load the model into this process's ``_MODEL_CACHE`` and run one
        all-zeros forward per bucket of the ladder
        (``shapes.resolve_buckets(batch_size, buckets or bucket_sizes)``),
        so the first real partition pays neither the load nor the first
        kernel build.  Row shapes come from ``example`` (input name → ONE
        row) or, serving by ``model_name``, from the zoo's example batch.
        Returns the bucket sizes warmed."""
        from tensorflowonspark_torch import serving, shapes, sql_compat

        bucket_sizes = (list(buckets) if buckets
                        else self.getOrDefault("bucket_sizes"))
        ladder = shapes.resolve_buckets(self.getOrDefault("batch_size"),
                                        bucket_sizes)
        if example is None and not self.getOrDefault("model_name"):
            raise ValueError(
                "warmup needs input shapes: pass example= (model input name "
                "→ one example row) or set model_name so the zoo's example "
                "batch supplies them")
        run_model = self._run_model([], sql_compat.SPARKAPI, bucket_sizes)
        fn, params = run_model._load()
        if example is not None:
            specs = shapes.input_specs(example)
        else:
            specs = shapes.policy_specs(self.getOrDefault("model_name"),
                                        run_model._export_specs)
        serving.warm_buckets(fn, params, specs, ladder, run_model._cache_key,
                             run_model._device)
        logger.info("warmed %s for buckets %s", run_model.export_dir,
                    list(ladder))
        return list(ladder)

    def _transform(self, df):
        from tensorflowonspark_torch import sql_compat

        backend = sql_compat.backend_of(df)
        run_model = self._run_model(df.columns, backend,
                                    self.getOrDefault("bucket_sizes"))
        session = sql_compat.session_of(df)
        out_names = list((self.getOrDefault("output_mapping") or
                          {"prediction": "prediction"}).values())
        # Lazy distributed transform.  The exact output schema comes from
        # scoring ONE sampled row on the driver at its own (1-row) shape.
        # Where the driver cannot read the export (a path only executors
        # see), one row is scored on an executor instead.
        sample = df.rdd.take(1)
        if not sample:
            fields = [(n, "double") for n in out_names]
            return sql_compat.create_dataframe(
                _rdd_of(df, []), fields, backend, session)
        try:
            first_out = next(iter(run_model.sampler()(iter(sample))))
        except OSError as e:
            logger.info(
                "driver-side schema sampling unavailable (%s); sampling on "
                "an executor", e)
            first_out = df.rdd.mapPartitions(run_model.sampler()).take(1)[0]
        fields = sql_compat.infer_fields(first_out)
        out_rdd = df.rdd.mapPartitions(run_model)
        if backend == sql_compat.SPARKAPI:
            # the local substrate has no storage manager; cache so repeated
            # actions don't re-run inference (real pyspark: user's choice)
            out_rdd = out_rdd.cache()
        return sql_compat.create_dataframe(out_rdd, fields, backend, session)


def model_cache_key(export_dir: str, model_name: str | None = None,
                    predict_fn: Callable | None = None) -> tuple:
    """The ``_MODEL_CACHE`` identity of a model artifact:
    ``(resolved path, forward id, mtime)``, computable without loading."""
    import os

    path = export_dir
    model_sub = os.path.join(path, "model")
    if os.path.isdir(model_sub):
        path = model_sub  # layout written by compat.export_saved_model
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        mtime = 0.0
    if predict_fn is not None:
        fn_id = getattr(predict_fn, "__qualname__", None)
    else:
        fn_id = f"model:{model_name}" if model_name else None
    return (path, fn_id, mtime)


def _cache_insert(key: tuple, entry: tuple) -> None:
    """Insert into ``_MODEL_CACHE``, evicting entries for older versions of
    the same export path (and their shape tracking), so re-exports replace
    instead of accumulating for the life of the executor."""
    from tensorflowonspark_torch import serving

    stale = [k for k in _MODEL_CACHE if k[0] == key[0] and k[2] != key[2]]
    for k in stale:
        _MODEL_CACHE.pop(k, None)
        serving.forget(k)
        logger.info("evicted stale model cache entry %s (re-export)", k)
    _MODEL_CACHE[key] = entry


class _RunModel:
    """The ``mapPartitions`` closure of ``TFModel.transform``.

    Picklable by construction (plain attributes); the loaded model lives in
    the per-process ``_MODEL_CACHE``.
    """

    def __init__(self, export_dir, model_name, predict_fn, batch_size,
                 input_mapping, output_mapping, columns, backend="sparkapi",
                 bucket_sizes=None, device=None):
        self.export_dir = export_dir
        self.model_name = model_name
        self.predict_fn = predict_fn
        self.batch_size = batch_size or 100
        self.input_mapping = input_mapping
        self.output_mapping = output_mapping
        self.columns = list(columns)
        self.backend = backend
        self.bucket_sizes = list(bucket_sizes) if bucket_sizes else None
        self.device = device
        self.sample_rows = None  # sampler(): score only the first N rows
        # set by _load() on the executor
        self._cache_key = None
        self._device = None
        self._export_specs = None  # shapes of the export's params

    def sampler(self) -> "_RunModel":
        """A copy that scores only the FIRST row of its partition."""
        import copy

        clone = copy.copy(self)
        clone.sample_rows = 1
        return clone

    # -- executor-side ------------------------------------------------------

    def _load(self):
        key = model_cache_key(self.export_dir, self.model_name,
                              self.predict_fn)
        self._cache_key = key
        self._device = single_node_env(self.device)
        if key not in _MODEL_CACHE:
            _cache_insert(key, self._load_uncached(key[0]))
        fn, params, self._export_specs = _MODEL_CACHE[key]
        return fn, params

    def _load_uncached(self, path):
        """``(forward, params, export specs)``: the forward, what it takes
        as params (the model on the device, or the export's params for a
        ``predict_fn``), and the shapes of the export's params."""
        from tensorflowonspark_torch import ckpt, shapes

        state = ckpt.load_pytree(path)
        params = state.get("params", state)
        specs = {k: shapes.TensorSpec(v.shape, v.dtype)
                 for k, v in params.items()}
        if self.predict_fn is not None:
            return self.predict_fn, params, specs
        if not self.model_name:
            raise ValueError("TFModel needs model_name or predict_fn")
        import dataclasses

        from tensorflowonspark_torch import models as model_zoo

        lib = model_zoo.get_model(self.model_name)
        config = lib.Config.tiny() if _is_tiny(params, lib) else lib.Config()
        if state.get("collections"):
            config = dataclasses.replace(config, norm="batch")
        model = lib.load_state(lib.make_model(config), state)
        model = model.to(self._device).eval()
        logger.info("executor loaded %s from %s onto %s", self.model_name,
                    self.export_dir, self._device)
        return lib.make_forward_fn(model, config), model, specs

    def __call__(self, iterator):
        import itertools

        from tensorflowonspark_torch import readers, serving, shapes

        fn, params = self._load()
        in_map = self.input_mapping or {c: c for c in self.columns}
        out_map = self.output_mapping  # may be None → auto names

        if self.sample_rows:
            iterator = itertools.islice(iterator, self.sample_rows)
        if self.sample_rows or not serving.bucketing_enabled():
            # exact-shape mode: schema sampling scores its row at its own
            # size; TFOS_SERVING_BUCKETS=0 turns padding off
            buckets = ()
        else:
            buckets = shapes.resolve_buckets(self.batch_size,
                                             self.bucket_sizes)
        stage = serving.stager(self._device)
        depth = serving.prefetch_depth()

        def staged_batches():
            # runs on the pump thread: columnar ingest → pad to a bucket
            # shape → copy to the device, for batch N+1 while the loop
            # below computes batch N (depth 0: inline)
            for n, cols in serving.ingest_chunks(
                    iterator, self.batch_size, in_map, self.columns):
                bucket = shapes.choose_bucket(n, buckets)
                if bucket > n:
                    cols = serving.pad_columns(cols, bucket)
                yield n, bucket, stage(cols)

        def scored_batches():
            # emit lags the forward by one batch: CUDA launches are
            # asynchronous, so batch N+1's forward is queued on the card
            # before the emit of batch N blocks on its device-to-host copy
            # and builds Rows
            pending = None
            for n, fed, batch in readers.prefetched(staged_batches, depth):
                serving.note_compile(self._cache_key, batch)
                outputs = fn(params, batch)
                if pending is not None:
                    yield serving.emit_rows(
                        _name_outputs(pending[0], out_map), pending[1],
                        self.backend, fed_rows=pending[2])
                pending = (outputs, n, fed)
            if pending is not None:
                yield serving.emit_rows(
                    _name_outputs(pending[0], out_map), pending[1],
                    self.backend, fed_rows=pending[2])

        # one generator-frame resume per BATCH; the per-row hops through
        # the emitted lists stay C-level inside chain.from_iterable
        return itertools.chain.from_iterable(scored_batches())


def _name_outputs(outputs, out_map) -> dict:
    """Model outputs (tensor | tuple | dict) → ordered {column: array}."""
    if isinstance(outputs, dict):
        named = outputs
    elif isinstance(outputs, (tuple, list)):
        named = {f"output_{i}": o for i, o in enumerate(outputs)}
    else:
        named = {"prediction": outputs}
    if out_map:
        named = {out_map.get(k, k): v for k, v in named.items()}
    return named


def _is_tiny(params: dict, lib) -> bool:
    """Do the export's parameter shapes match the zoo's ``Config.tiny()``?
    Lets transform serve test-sized and full-sized exports without the
    caller passing a config."""
    tiny = lib.make_model(lib.Config.tiny())
    tiny_shapes = sorted(tuple(p.shape) for p in tiny.parameters())
    return tiny_shapes == sorted(tuple(getattr(v, "shape", ()))
                                 for v in params.values())


def single_node_env(device: str | None = None) -> torch.device:
    """The device an executor serves on (see ``util.select_device``).  The
    reference's chip-health probe here is not ported yet."""
    from tensorflowonspark_torch import util

    return util.select_device(device)


def _spark_context_of(df):
    rdd = df.rdd
    sc = getattr(rdd, "_sc", None) or getattr(rdd, "context", None)
    if sc is None:
        raise ValueError("cannot find SparkContext on DataFrame.rdd")
    return sc


def _rdd_of(df, rows):
    """Parallelize materialized result rows, keeping df's partition count."""
    return _spark_context_of(df).parallelize(
        rows, max(1, df.rdd.getNumPartitions())
    )
