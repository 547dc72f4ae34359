"""Spark ML pipeline integration: ``TFEstimator`` (training) and
``TFModel`` (batch inference).

Reference anchor: ``tensorflowonspark_tpu/pipeline.py`` (``TFParams`` +
``Has*`` param mixins, ``TFEstimator.fit(df)`` → ``TFCluster.run`` →
``cluster.train(df.rdd.map(list))`` → ``TFModel``, and
``TFModel.transform(df)`` → ``df.rdd.mapPartitions(_RunModel)`` with a
per-executor cached model).

Which forward an executor serves, in the reference's precedence: an
explicit ``predict_fn``; else the export's serialized forward
(``saved_model.load_forward``: a self-describing export serves with no
model code, the state loaded onto the executor's device); else the zoo
model of ``model_name``, rebuilt, loaded and moved to the device.  Each
executor keeps what it loaded in ``_MODEL_CACHE``, keyed by
:func:`model_cache_key`.  Per partition the bucketed serving data plane
runs: columnar ingest → pad to a bucket → stage onto the device on a pump
thread (batch N+1 while batch N computes) → forward → masked emit one
batch behind.

Device rule: ``TFModel(device=...)``; unset, each executor reads
``TFOS_TORCH_DEVICE`` (inherited from the driver) and otherwise runs on
``cuda``, raising where there is no card (``util.select_device``).

The executor's model load configures the persistent compile cache first
(``compile_cache.ensure()``: the kernel libraries from a fleet's shared
store).  Not ported yet: the flight recorder and cost ledger of the
reference's ``_RunModel.__call__`` and the serving health probe.
"""

from __future__ import annotations

import argparse
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

    def _copyValues(self, to: "Params") -> "Params":
        """Copy explicitly-set values for params the target also declares."""
        shared = to._params().keys() & self._paramMap.keys()
        for k in shared:
            to._paramMap[k] = self._paramMap[k]
        return to

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
HasEpochs = _make_has("HasEpochs", "epochs", "number of epochs", 1)
HasSteps = _make_has("HasSteps", "steps", "max training steps", 1000)
HasClusterSize = _make_has("HasClusterSize", "cluster_size",
                           "number of nodes", 1)
HasNumPS = _make_has(
    "HasNumPS", "num_ps",
    "reference parameter-server count; there are no parameter servers "
    "(recorded on the node context as ctx.num_ps)", 0)
HasInputMode = _make_has("HasInputMode", "input_mode",
                         "InputMode.SPARK or InputMode.TENSORFLOW", None)
HasProtocol = _make_has(
    "HasProtocol", "protocol",
    "reference grpc|grpc+verbs knob; the tensor plane is torch.distributed "
    "(NCCL on cards, gloo on the CPU) here", "grpc")
HasReaders = _make_has("HasReaders", "readers", "parallel file readers", 1)
HasTensorboard = _make_has("HasTensorboard", "tensorboard",
                           "launch TensorBoard on one node", False)
HasTFRecordDir = _make_has("HasTFRecordDir", "tfrecord_dir",
                           "TFRecord export dir for DataFrame input", None)
HasMasterNode = _make_has("HasMasterNode", "master_node",
                          "job name of the chief node", "chief")
HasGraceSecs = _make_has("HasGraceSecs", "grace_secs",
                         "grace period on shutdown", 30)
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

    def merge_args(self) -> argparse.Namespace:
        """Spark ML params + ``tf_args`` → one ``argparse.Namespace``.

        Params explicitly set (or defaulted) become attributes; ``tf_args``
        entries win on conflict so CLI users keep full control.
        """
        merged = dict(self.extractParamMap())
        ta = self.tf_args
        if ta is None:
            pass
        elif isinstance(ta, argparse.Namespace):
            merged.update(vars(ta))
        elif isinstance(ta, dict):
            merged.update(ta)
        elif isinstance(ta, (list, tuple)):  # raw argv: keep as-is for parity
            merged["argv"] = list(ta)
        else:
            merged.update({k: v for k, v in vars(ta).items()
                           if not k.startswith("_")})
        return argparse.Namespace(**merged)


# ---------------------------------------------------------------------------
# Estimator
# ---------------------------------------------------------------------------


class TFEstimator(TFParams, HasBatchSize, HasEpochs, HasSteps, HasClusterSize,
                  HasNumPS, HasInputMode, HasInputMapping, HasOutputMapping,
                  HasModelDir, HasExportDir, HasSignatureDefKey, HasTagSet,
                  HasProtocol, HasReaders, HasTensorboard, HasTFRecordDir,
                  HasMasterNode, HasGraceSecs, HasModelName):
    """Spark ML ``Estimator`` that trains ``train_fn`` on a cluster.

    ``train_fn(args, ctx)`` is a ``TFCluster`` ``map_fun``; ``args`` is
    :meth:`merge_args`.  ``fit(df)`` runs the cluster, feeds it the
    DataFrame's rows (``InputMode.SPARK``, the default) for ``epochs``,
    shuts it down and returns a :class:`TFModel` carrying the values set
    here (``export_dir``, ``model_name``, ...), to serve what ``train_fn``
    exported.
    """

    def __init__(self, train_fn: Callable, tf_args: Any = None):
        super().__init__(tf_args)
        self.train_fn = train_fn

    def fit(self, df) -> "TFModel":
        return self._fit(df)

    def _fit(self, df) -> "TFModel":
        from tensorflowonspark_torch import TFCluster, obs

        sc = _spark_context_of(df)
        args = self.merge_args()
        input_mode = self.getOrDefault("input_mode")
        # None test, not falsy-or: legacy int InputMode.TENSORFLOW is 0
        input_mode = (TFCluster.InputMode.SPARK if input_mode is None
                      else TFCluster.InputMode(input_mode))

        logger.info("TFEstimator.fit: cluster_size=%d input_mode=%s",
                    self.getOrDefault("cluster_size"), input_mode)
        with obs.span("pipeline.fit",
                      cluster_size=self.getOrDefault("cluster_size")):
            cluster = TFCluster.run(
                sc, self.train_fn, args,
                num_executors=self.getOrDefault("cluster_size"),
                num_ps=self.getOrDefault("num_ps"),
                tensorboard=self.getOrDefault("tensorboard"),
                input_mode=input_mode,
                master_node=self.getOrDefault("master_node"),
            )
            if input_mode is TFCluster.InputMode.SPARK:
                cluster.train(df.rdd.map(list),
                              num_epochs=self.getOrDefault("epochs"))
            cluster.shutdown(grace_secs=self.getOrDefault("grace_secs"))

        model = TFModel(tf_args=self.tf_args)
        self._copyValues(model)
        return model


# ---------------------------------------------------------------------------
# Model (transformer)
# ---------------------------------------------------------------------------

#: per-executor-process singleton: {cache_key: (forward, params, export
#: param specs, signature or None)}; the key holds the export's cache
#: token (mtime, or the signature's fingerprint), so a re-export
#: invalidates it
_MODEL_CACHE: dict[tuple, tuple[Callable, Any, dict, Any]] = {}


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
        row), else a self-describing export's signature, else, serving by
        ``model_name``, the zoo's example batch.  Returns the bucket sizes
        warmed."""
        from tensorflowonspark_torch import serving, shapes, sql_compat

        bucket_sizes = (list(buckets) if buckets
                        else self.getOrDefault("bucket_sizes"))
        ladder = shapes.resolve_buckets(self.getOrDefault("batch_size"),
                                        bucket_sizes)
        run_model = self._run_model([], sql_compat.SPARKAPI, bucket_sizes)
        fn, params = run_model._load()
        if example is not None:
            specs = shapes.input_specs(example=example)
        elif run_model._signature is not None:
            specs = shapes.input_specs(signature=run_model._signature)
        elif self.getOrDefault("model_name"):
            specs = shapes.policy_specs(self.getOrDefault("model_name"),
                                        run_model._export_specs)
        else:
            raise ValueError(
                "warmup needs input shapes: pass example= (model input name "
                "→ one example row), serve a self-describing export, or set "
                "model_name so the zoo's example batch supplies them")
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


def _cache_token(path: str, export_dir: str):
    """Cache-invalidation token for the per-executor model cache.

    A local export: its weights directory's mtime (a re-export renames a
    new file into it).  A remote (``fs``) export has no trustworthy mtime,
    and a constant would serve a re-export to the same path from the stale
    cache for the life of the executor, so the signature JSON is
    fingerprinted: it embeds a fresh ``export_id`` per export.  A
    weights-only remote export has no signature and keeps 0.0 (re-export
    those to a new path)."""
    import os

    from tensorflowonspark_torch import saved_model

    if "://" not in path:
        try:
            return os.path.getmtime(path)
        except OSError:
            return 0.0
    fp = saved_model.signature_fingerprint(export_dir)
    return fp if fp is not None else 0.0


def _weights_path(export_dir: str) -> str:
    """Where an export's weights are: ``export_dir/model`` in the layout
    ``compat.export_saved_model`` writes, else ``export_dir`` itself."""
    import os

    from tensorflowonspark_torch import fs

    model_sub = fs.join(export_dir, "model")
    if "://" in export_dir:
        return (model_sub if fs.exists(fs.join(model_sub, "pytree.npz"))
                else export_dir)
    return model_sub if os.path.isdir(model_sub) else export_dir


def model_cache_key(export_dir: str, model_name: str | None = None,
                    predict_fn: Callable | None = None) -> tuple:
    """The ``_MODEL_CACHE`` identity of a model artifact:
    ``(weights path, forward id, cache-invalidation token)``, computable
    without loading.  The forward id follows the reference's precedence:
    an explicit ``predict_fn`` beats the export's serialized forward
    (``"saved_forward"``), which beats ``model_name`` (namespaced
    ``model:<name>``, so no name collides with it)."""
    from tensorflowonspark_torch import saved_model

    path = _weights_path(export_dir)
    token = _cache_token(path, export_dir)
    if predict_fn is None and saved_model.has_forward(export_dir):
        fn_id = "saved_forward"
    elif predict_fn is not None:
        fn_id = getattr(predict_fn, "__qualname__", None)
    else:
        fn_id = f"model:{model_name}" if model_name else None
    return (path, fn_id, token)


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
        self._export_specs = None  # the export's tree of shapes
        self._signature = None  # a self-describing export's signature

    def sampler(self) -> "_RunModel":
        """A copy that scores only the FIRST row of its partition."""
        import copy

        clone = copy.copy(self)
        clone.sample_rows = 1
        return clone

    # -- executor-side ------------------------------------------------------

    def _load(self):
        from tensorflowonspark_torch import compile_cache

        # the kernel libraries' shared store, before the forward loads
        # (and builds or loads) them
        compile_cache.ensure()
        key = model_cache_key(self.export_dir, self.model_name,
                              self.predict_fn)
        self._cache_key = key
        self._device = single_node_env(self.device)
        if key not in _MODEL_CACHE:
            from tensorflowonspark_torch import obs

            with obs.span("serving.model_load", export_dir=self.export_dir,
                          fn=key[1] or "?"):
                _cache_insert(key, self._load_uncached(
                    key[0], serialized=key[1] == "saved_forward"))
        fn, params, self._export_specs, self._signature = _MODEL_CACHE[key]
        return fn, params

    def _load_uncached(self, path, serialized: bool):
        """``(forward, params, export specs, signature)``: the forward,
        what it takes as params (the export's state on the device for a
        serialized forward, the model on the device for a zoo model, the
        export's params for a ``predict_fn``), the shapes of the export's
        tree and a self-describing export's signature (else None)."""
        from tensorflowonspark_torch import ckpt, saved_model

        state = ckpt.load_pytree(path)
        specs = _spec_tree(state)
        if serialized:
            # a self-describing export: served from the artifact alone
            fn, signature = saved_model.load_forward(self.export_dir,
                                                     self._device)
            logger.info("executor loaded the serialized forward of %s onto "
                        "%s", self.export_dir, self._device)
            return (fn, saved_model.state_on_device(state, self._device),
                    specs, signature)
        params = state.get("params", state)
        if self.predict_fn is not None:
            return self.predict_fn, params, specs, None
        if not self.model_name:
            raise ValueError("TFModel needs model_name or predict_fn (or "
                             "a self-describing export)")
        from tensorflowonspark_torch import models as model_zoo

        lib = model_zoo.get_model(self.model_name)
        config = lib.config_from_state(state)
        model = lib.load_state(lib.make_model(config), state)
        model = model.to(self._device).eval()
        logger.info("executor loaded %s from %s onto %s", self.model_name,
                    self.export_dir, self._device)
        return lib.make_forward_fn(model, config), model, specs, None

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


def _spec_tree(tree: dict) -> dict:
    """``tree`` with a ``shapes.TensorSpec`` in place of each array."""
    from tensorflowonspark_torch import shapes

    return {k: _spec_tree(v) if isinstance(v, dict)
            else shapes.TensorSpec(v.shape, v.dtype) for k, v in tree.items()}


def get_meta_graph_def(export_dir: str, tag_set: str = "serve") -> dict:
    """Describe an export: weight leaf names → ``{"shape", "dtype"}``, plus,
    for a self-describing export, its serving signature (input and output
    names, dtypes, shapes) under the reserved ``"__signature__"`` key: the
    MetaGraphDef's signature_def.

    Reference anchor: ``tensorflowonspark_tpu/pipeline.py::
    get_meta_graph_def``."""
    del tag_set  # parity only
    from tensorflowonspark_torch import ckpt, saved_model

    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (str(k),))
            else:
                flat["/".join(prefix + (str(k),))] = {
                    "shape": tuple(v.shape), "dtype": str(v.dtype)}

    walk(ckpt.load_pytree(_weights_path(export_dir)), ())
    try:
        signature = saved_model.read_signature(export_dir)
    except FileNotFoundError:
        return flat  # weights-only export: the leaf listing is all there is
    if "__signature__" in flat:  # a (pathological) leaf of that name wins
        logger.warning(
            "export %s has a '__signature__' leaf; omitting the serving "
            "signature from get_meta_graph_def", export_dir)
    else:
        flat["__signature__"] = signature
    return flat


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
