"""DataFrame ↔ TFRecord and Parquet conversion.

A copy of ``tensorflowonspark_tpu/dfutil.py`` with its imports rewritten:
the port never imports the JAX package.  Reference anchor:
``tensorflowonspark/dfutil.py`` (``saveAsTFRecords``, ``loadTFRecords``,
``toTFExample``, ``fromTFExample``, ``infer_schema``).  The same on-disk
format (TFRecord-framed ``tf.train.Example``) is written directly from the
executors through :mod:`tensorflowonspark_torch.tfrecord` — no jar, no JVM
round-trip, one ``part-r-NNNNN`` file per partition as Hadoop would lay
out.  ``pyarrow`` is imported inside the Parquet functions only, so the
module imports where it is absent.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Iterable

from tensorflowonspark_torch import fs, tfrecord

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Row → Example
# ---------------------------------------------------------------------------


def toTFExample(dtypes: list[tuple[str, str]]):
    """``mapPartitions`` closure: Rows → serialized ``tf.train.Example``.

    Reference anchor: ``dfutil.py::toTFExample`` — Spark simpleString dtypes
    pick the feature kind: integral → Int64List, fractional → FloatList,
    string/binary → BytesList; ``array<...>`` of the same.
    """
    return _ToTFExample(dtypes)


class _ToTFExample:
    def __init__(self, dtypes: list[tuple[str, str]]):
        self.dtypes = [(name, str(dt)) for name, dt in dtypes]
        self.index = {name: i for i, (name, _) in enumerate(self.dtypes)}

    def __call__(self, iterator) -> Iterable[bytes]:
        for row in iterator:
            yield encode_row(row, self.dtypes, self.index)


def encode_row(row, dtypes: list[tuple[str, str]],
               index: dict[str, int] | None = None) -> bytes:
    if index is None:
        index = {name: i for i, (name, _) in enumerate(dtypes)}
    by_position = isinstance(row, (list, tuple))
    features: dict[str, tuple[int, list]] = {}
    for name, dt in dtypes:
        value = row[index[name]] if by_position else row[name]
        elem = dt[6:-1] if dt.startswith("array<") else dt
        values = list(value) if dt.startswith("array<") else [value]
        if elem in ("tinyint", "smallint", "int", "bigint", "long", "boolean"):
            features[name] = (tfrecord.INT64_LIST, [int(v) for v in values])
        elif elem in ("float", "double") or elem.startswith("decimal"):
            features[name] = (tfrecord.FLOAT_LIST, [float(v) for v in values])
        elif elem == "string":
            features[name] = (tfrecord.BYTES_LIST,
                              [str(v).encode() for v in values])
        elif elem == "binary":
            features[name] = (tfrecord.BYTES_LIST,
                              [bytes(v) for v in values])
        else:
            raise TypeError(f"column {name!r}: unsupported dtype {dt!r}")
    return tfrecord.encode_example(features)


# ---------------------------------------------------------------------------
# Example → Row
# ---------------------------------------------------------------------------


def fromTFExample(data: bytes, binary_features: list[str] | None = None,
                  backend: str = "sparkapi"):
    """Serialized Example → Row (single-element lists unwrap to scalars).

    Reference anchor: ``dfutil.py::fromTFExample``.  ``binary_features``
    names BytesList columns that stay ``bytes``; other BytesList columns
    decode as utf-8 strings (the reference's convention).  ``backend``
    selects pyspark vs the local substrate for the produced Row.
    """
    from tensorflowonspark_torch import sql_compat

    binary = set(binary_features or [])
    decoded = tfrecord.decode_example(data)
    names, values = [], []
    for name in sorted(decoded):
        kind, vals = decoded[name]
        if kind == tfrecord.BYTES_LIST and name not in binary:
            vals = [v.decode() for v in vals]
        elif kind == tfrecord.BYTES_LIST:
            vals = [bytes(v) for v in vals]
        names.append(name)
        values.append(vals[0] if len(vals) == 1 else list(vals))
    return sql_compat.make_row(names, values, backend)


def _infer_fields(example: bytes,
                  binary_features: list[str] | None = None
                  ) -> list[tuple[str, str]]:
    """[(name, simpleString)] schema of one serialized Example."""
    binary = set(binary_features or [])
    decoded = tfrecord.decode_example(example)
    fields = []
    for name in sorted(decoded):
        kind, vals = decoded[name]
        if kind == tfrecord.INT64_LIST:
            elem = "bigint"
        elif kind == tfrecord.FLOAT_LIST:
            elem = "float"
        else:
            elem = "binary" if name in binary else "string"
        dt = f"array<{elem}>" if len(vals) != 1 else elem
        fields.append((name, dt))
    return fields


def infer_schema(example: bytes, binary_features: list[str] | None = None,
                 backend: str = "sparkapi"):
    """Schema (StructType) of a serialized Example.

    Reference anchor: ``dfutil.py::infer_schema`` — samples one record.
    """
    from tensorflowonspark_torch import sql_compat

    return sql_compat.struct_type(
        _infer_fields(example, binary_features), backend
    )


# ---------------------------------------------------------------------------
# Save / load
# ---------------------------------------------------------------------------


def saveAsTFRecords(df, output_dir: str) -> None:
    """Write ``df`` as TFRecord files, one ``part-r-NNNNN`` per partition.

    Reference anchor: ``dfutil.py::saveAsTFRecords`` (via
    ``saveAsNewAPIHadoopFile``; same directory layout, no JVM here).

    ``output_dir`` may carry a scheme (``hdfs://``, ``gs://``, …).  Like the
    reference's Hadoop output format, the directory must be a **shared**
    filesystem visible to every executor: each partition's part file is
    written from the executor that holds it.  A plain local path on a
    multi-host cluster would scatter part files across hosts' local disks —
    use a scheme-qualified shared path there.
    """
    fs.makedirs(output_dir)
    dtypes = df.dtypes
    df.rdd.mapPartitionsWithIndex(
        _SavePartition(output_dir, dtypes)
    ).count()  # count() forces the job; one small int returns per partition
    logger.info("saved TFRecords to %s", output_dir)


class _SavePartition:
    def __init__(self, output_dir: str, dtypes):
        self.output_dir = output_dir
        self.dtypes = dtypes

    def __call__(self, pindex: int, iterator):
        path = fs.join(self.output_dir, f"part-r-{pindex:05d}")
        n = tfrecord.write_records(
            path, _ToTFExample(self.dtypes)(iterator)
        )
        yield n


def loadTFRecords(sc, input_dir: str,
                  binary_features: list[str] | None = None):
    """Load a TFRecord directory back into a DataFrame.

    Reference anchor: ``dfutil.py::loadTFRecords`` (Hadoop input format +
    ``infer_schema`` from one sampled record).
    """
    from tensorflowonspark_torch import sql_compat

    backend = sql_compat.backend_of(sc)
    files = sorted(
        fs.join(input_dir, f)
        for f in fs.listdir(input_dir)
        if f.startswith("part-") or f.endswith(".tfrecord")
    )
    if not files:
        raise FileNotFoundError(f"no TFRecord part files in {input_dir}")
    sample = None  # first file may be an empty partition's part file
    for f in files:
        sample = next(iter(tfrecord.read_records(f)), None)
        if sample is not None:
            break
    if sample is None:
        raise ValueError(f"all TFRecord part files in {input_dir} are empty")
    fields = _infer_fields(sample, binary_features)
    rows = sc.parallelize(files, len(files)).mapPartitions(
        _LoadPartition(binary_features, backend)
    )
    return sql_compat.create_dataframe(rows, fields, backend)


class _LoadPartition:
    def __init__(self, binary_features, backend="sparkapi"):
        self.binary_features = binary_features
        self.backend = backend

    def __call__(self, iterator):
        for path in iterator:
            for payload in tfrecord.read_records(path):
                yield fromTFExample(payload, self.binary_features, self.backend)


# ---------------------------------------------------------------------------
# Parquet (Arrow columnar) save / load
# ---------------------------------------------------------------------------

_ARROW_TYPES = {
    "tinyint": "int8", "smallint": "int16", "int": "int32",
    "bigint": "int64", "long": "int64", "boolean": "bool_",
    "float": "float32", "double": "float64",
    "string": "string", "binary": "binary",
}


def _arrow_schema(dtypes: list[tuple[str, str]]):
    """Spark simpleString dtypes → pyarrow schema."""
    import pyarrow as pa

    fields = []
    for name, dt in dtypes:
        dt = str(dt)
        elem = dt[6:-1] if dt.startswith("array<") else dt
        if elem.startswith("decimal"):
            elem = "double"
        try:
            typ = getattr(pa, _ARROW_TYPES[elem])()
        except KeyError:
            raise TypeError(f"column {name!r}: unsupported dtype {dt!r}")
        if dt.startswith("array<"):
            typ = pa.list_(typ)
        fields.append(pa.field(name, typ))
    return pa.schema(fields)


def _parquet_fields(schema) -> list[tuple[str, str]]:
    """pyarrow schema → [(name, simpleString)] (inverse of _arrow_schema)."""
    import pyarrow as pa

    back: dict[str, str] = {}
    for simple, attr in _ARROW_TYPES.items():
        # first writer wins: canonical simpleString for aliased types
        # (int64 → "bigint", not "long")
        back.setdefault(str(getattr(pa, attr)()), simple)
    fields = []
    for f in schema:
        typ, wrap = f.type, False
        if pa.types.is_list(typ) or pa.types.is_large_list(typ):
            typ, wrap = typ.value_type, True
        name = back.get(str(typ))
        if name is None:
            raise TypeError(f"column {f.name!r}: unsupported Parquet type "
                            f"{f.type}")
        fields.append((f.name, f"array<{name}>" if wrap else name))
    return fields


def saveAsParquet(df, output_dir: str) -> None:
    """Write ``df`` as Parquet, one ``part-r-NNNNN.parquet`` per partition.

    The Arrow-columnar sibling of :func:`saveAsTFRecords` (``SURVEY.md
    §2.2``: "columnar (Arrow/Parquet)→HBM path, the idiomatic 2026
    choice") — pairs with :func:`tensorflowonspark_torch.readers.
    parquet_batches` for row-loop-free training input.  Same shared-
    filesystem requirement as :func:`saveAsTFRecords`.
    """
    fs.makedirs(output_dir)
    dtypes = [(name, str(dt)) for name, dt in df.dtypes]
    df.rdd.mapPartitionsWithIndex(
        _SaveParquetPartition(output_dir, dtypes)
    ).count()
    logger.info("saved Parquet to %s", output_dir)


class _SaveParquetPartition:
    #: rows buffered per Arrow batch — streams like the TFRecord sibling
    #: instead of materializing the whole partition in Python lists
    CHUNK_ROWS = 4096

    def __init__(self, output_dir: str, dtypes: list[tuple[str, str]]):
        self.output_dir = output_dir
        self.dtypes = dtypes

    def __call__(self, pindex: int, iterator):
        import pyarrow as pa
        import pyarrow.parquet as pq

        schema = _arrow_schema(self.dtypes)
        index = {name: i for i, (name, _) in enumerate(self.dtypes)}
        # decimal columns carry decimal.Decimal objects pyarrow won't
        # coerce to float64 — convert while accumulating
        decimal_cols = {
            name for name, dt in self.dtypes
            if (dt[6:-1] if dt.startswith("array<") else dt)
            .startswith("decimal")
        }

        def _cell(row, name, by_position):
            v = row[index[name]] if by_position else row[name]
            if name in decimal_cols and v is not None:
                return ([float(e) for e in v] if isinstance(v, (list, tuple))
                        else float(v))
            return v

        path = fs.join(self.output_dir, f"part-r-{pindex:05d}.parquet")
        local = fs.local_path(path)
        sink = local if local is not None else fs.open(path, "wb")
        total = 0
        try:
            with pq.ParquetWriter(sink, schema) as writer:
                columns: dict[str, list] = {n: [] for n, _ in self.dtypes}
                for row in iterator:
                    by_position = isinstance(row, (list, tuple))
                    for name, _ in self.dtypes:
                        columns[name].append(_cell(row, name, by_position))
                    total += 1
                    if total % self.CHUNK_ROWS == 0:
                        writer.write_batch(
                            pa.record_batch(columns, schema=schema))
                        columns = {n: [] for n, _ in self.dtypes}
                if next(iter(columns.values()), []):
                    writer.write_batch(
                        pa.record_batch(columns, schema=schema))
        finally:
            if local is None:
                sink.close()
        yield total


def loadParquet(sc, input_dir: str):
    """Load a Parquet directory back into a DataFrame (schema from the
    Parquet footer — no record sampling needed, unlike TFRecords)."""
    import pyarrow.parquet as pq

    from tensorflowonspark_torch import sql_compat

    backend = sql_compat.backend_of(sc)
    files = sorted(
        fs.join(input_dir, f)
        for f in fs.listdir(input_dir)
        if f.endswith(".parquet")
    )
    if not files:
        raise FileNotFoundError(f"no .parquet part files in {input_dir}")
    local = fs.local_path(files[0])
    if local is not None:
        schema = pq.read_schema(local)
    else:
        with fs.open(files[0], "rb") as f:
            schema = pq.read_schema(f)
    fields = _parquet_fields(schema)
    rows = sc.parallelize(files, len(files)).mapPartitions(
        _LoadParquetPartition(fields, backend)
    )
    return sql_compat.create_dataframe(rows, fields, backend)


class _LoadParquetPartition:
    def __init__(self, fields: list[tuple[str, str]], backend="sparkapi"):
        self.fields = fields
        self.backend = backend

    def __call__(self, iterator):
        import pyarrow.parquet as pq

        from tensorflowonspark_torch import sql_compat

        names = [name for name, _ in self.fields]
        for path in iterator:
            local = fs.local_path(path)
            if local is not None:
                table = pq.read_table(local)
            else:
                with fs.open(path, "rb") as f:
                    table = pq.read_table(f)
            for record in table.to_pylist():
                yield sql_compat.make_row(
                    names, [record[n] for n in names], self.backend
                )
