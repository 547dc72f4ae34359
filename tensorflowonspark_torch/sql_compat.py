"""Backend-neutral SQL helpers: real pyspark OR the bundled local substrate.

The portable layers (``pipeline.py``, ``dfutil.py``) must not hard-import
:mod:`tensorflowonspark_torch.sparkapi` — under real pyspark they have to
produce genuine pyspark ``Row``/``DataFrame`` objects (SURVEY.md §2.2 row 4:
"py4j / Spark JVM kept as-is").  Every helper here dispatches on the backend
of the object actually flowing through (`type(obj).__module__`), so the same
closure works executor-side on either substrate.

Types cross the boundary as Spark *simpleString* names (``"bigint"``,
``"array<double>"`` …) — the one schema vocabulary both backends share.

A copy of ``tensorflowonspark_tpu/sql_compat.py`` with its imports
rewritten: the port never imports the JAX package.
"""

from __future__ import annotations

from typing import Any, Sequence

SPARKAPI = "sparkapi"
PYSPARK = "pyspark"


def backend_of(obj: Any) -> str:
    """Which SQL backend does this DataFrame/RDD/Row/SparkContext belong to?"""
    mod = type(obj).__module__ or ""
    return PYSPARK if mod.startswith("pyspark") else SPARKAPI


def make_row(names: Sequence[str], values: Sequence[Any], backend: str):
    """A Row with ordered named fields on the given backend."""
    if backend == PYSPARK:
        from pyspark.sql import Row

        return Row(*names)(*values)  # Row factory: field order preserved
    from tensorflowonspark_torch.sparkapi.sql import Row

    return Row.from_fields(list(names), list(values))


def row_maker(names: Sequence[str], backend: str):
    """A reusable ``values -> Row`` factory for one output schema.

    The serving emit path builds one Row per scored example; going through
    :func:`make_row` costs a fresh names-list copy per row.  The factory
    shares ONE schema object across the whole batch: pyspark's own ``Row``
    factory (``Row(*names)``), or a direct ``__new__`` construction on the
    substrate.  ``values`` may be any sequence; the factory owns the copy
    (substrate Row equality relies on ``_values`` being a list)."""
    if backend == PYSPARK:
        from pyspark.sql import Row

        factory = Row(*names)
        return lambda values: factory(*values)
    from tensorflowonspark_torch.sparkapi.sql import Row

    shared = list(names)
    new = Row.__new__

    def make(values, _new=new, _Row=Row, _shared=shared):
        r = _new(_Row)
        r._fields = _shared
        r._values = list(values)
        return r

    return make


def arrow_batch_columns(item: Any, columns: Sequence[str] | None = None
                        ) -> dict[str, Any] | None:
    """Columnar fast path: a pyarrow ``RecordBatch``/``Table`` → numpy columns.

    Real pyspark can hand partitions to Python as Arrow batches
    (``df.mapInArrow`` / the Arrow-backed serializers); those carry their
    columns as contiguous buffers, so the serving ingest can slice them
    straight into model inputs with no per-row work.  Returns
    ``{column_name: np.ndarray}`` for Arrow-shaped ``item``s (restricted to
    ``columns`` when given — absent names are simply omitted, the caller
    owns the missing-column error), or None for anything else (plain
    Rows/tuples/dicts take the row path).  Arrow list columns come back as
    object arrays of python lists — same values the row path would see.
    """
    typename = type(item).__name__
    if typename not in ("RecordBatch", "Table"):
        return None
    mod = type(item).__module__ or ""
    if not mod.startswith("pyarrow"):
        return None
    import numpy as np

    names = list(item.schema.names)
    wanted = names if columns is None else [c for c in columns if c in names]
    out = {}
    for name in wanted:
        col = item.column(name)
        if hasattr(col, "combine_chunks"):  # Table: ChunkedArray
            col = col.combine_chunks()
        arr = _arrow_dense_list(col)
        if arr is None:
            try:
                arr = col.to_numpy(zero_copy_only=False)
            except (TypeError, ValueError):
                arr = None  # nested types on older pyarrow: objects below
        if arr is None or arr.dtype == object:
            # list columns of uniform length stack into a dense (n, k)
            # array — the shape a model input needs; genuinely ragged ones
            # stay object arrays (same values the row path would see)
            vals = col.to_pylist() if arr is None else list(arr)
            try:
                dense = np.asarray(vals)
                if dense.dtype == object:
                    raise ValueError("ragged")
                arr = dense
            except ValueError:
                arr = np.empty(len(vals), dtype=object)
                arr[:] = vals
        out[name] = arr
    return out


def _arrow_dense_list(col) -> Any:
    """``(n, k)`` zero-copy view of a (fixed-size) list column, or None.

    pyspark hands ``array<T>`` columns over Arrow as list arrays whose
    values already sit in ONE contiguous child buffer — so a null-free,
    uniform-length column densifies with a reshape, not n per-row
    conversions (the difference between Arrow ingest being a fast path
    and a slow detour).  Ragged lengths, nulls, or non-primitive items
    return None: the caller's general conversion handles those."""
    import numpy as np
    import pyarrow.types as patypes

    t = col.type
    if col.null_count:
        return None
    try:
        if patypes.is_fixed_size_list(t):
            k = int(t.list_size)
        elif patypes.is_list(t) or patypes.is_large_list(t):
            widths = np.diff(col.offsets.to_numpy(zero_copy_only=True))
            if widths.size == 0 or (widths != widths[0]).any():
                return None  # ragged
            k = int(widths[0])
        else:
            return None
        flat = col.flatten()
        if flat.null_count:
            return None
        return flat.to_numpy(zero_copy_only=True).reshape(len(col), k)
    except (TypeError, ValueError):
        return None


def row_fields(row: Any) -> tuple[list[str], list[Any]]:
    """(names, values) of a Row from either backend (or a dict)."""
    if isinstance(row, dict):
        return list(row.keys()), list(row.values())
    fields = getattr(row, "__fields__", None)
    if fields is not None:  # pyspark attribute / sparkapi method
        names = list(fields() if callable(fields) else fields)
        return names, [row[n] for n in names]
    raise TypeError(f"cannot extract fields from row {type(row)!r}")


def infer_fields(row: Any) -> list[tuple[str, str]]:
    """[(name, simpleString type)] inferred from one row's python values."""
    from tensorflowonspark_torch.sparkapi.sql import infer_type

    names, values = row_fields(row)
    return [(n, infer_type(v)) for n, v in zip(names, values)]


def _pyspark_type(simple: str):
    from pyspark.sql import types as T

    if simple.startswith("array<") and simple.endswith(">"):
        return T.ArrayType(_pyspark_type(simple[6:-1]))
    atomic = {
        "tinyint": T.ByteType, "smallint": T.ShortType, "int": T.IntegerType,
        "integer": T.IntegerType, "bigint": T.LongType, "long": T.LongType,
        "float": T.FloatType, "double": T.DoubleType, "string": T.StringType,
        "binary": T.BinaryType, "boolean": T.BooleanType,
    }
    if simple in atomic:
        return atomic[simple]()
    if simple.startswith("decimal"):
        return T.DoubleType()
    raise TypeError(f"unsupported simpleString type {simple!r}")


def struct_type(fields: Sequence[tuple[str, str]], backend: str):
    """A StructType from [(name, simpleString)] on the given backend."""
    if backend == PYSPARK:
        from pyspark.sql import types as T

        return T.StructType(
            [T.StructField(n, _pyspark_type(dt), True) for n, dt in fields]
        )
    from tensorflowonspark_torch.sparkapi.sql import StructField, StructType

    return StructType([StructField(n, dt) for n, dt in fields])


def create_dataframe(rdd, fields: Sequence[tuple[str, str]], backend: str,
                     session: Any = None):
    """A DataFrame over ``rdd`` with the given schema, lazily evaluated."""
    schema = struct_type(fields, backend)
    if backend == PYSPARK:
        if session is None:
            from pyspark.sql import SparkSession

            session = SparkSession.builder.getOrCreate()
        return session.createDataFrame(rdd, schema)
    from tensorflowonspark_torch.sparkapi.sql import DataFrame

    return DataFrame(rdd, schema)


def session_of(df: Any):
    """The SparkSession a DataFrame belongs to (None on the substrate)."""
    s = getattr(df, "sparkSession", None)
    if s is not None:
        return s
    ctx = getattr(df, "sql_ctx", None)
    return getattr(ctx, "sparkSession", None)
