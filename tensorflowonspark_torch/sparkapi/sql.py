"""DataFrame/Row/schema subset for the local Spark substrate.

Covers what the ML pipeline layer and the TFRecord converter need
(``SURVEY.md §2.1`` — ``pipeline.py``, ``dfutil.py``): ``createDataFrame``,
``df.rdd``, ``df.dtypes``, ``df.schema``, ``df.columns``, ``select``,
``collect``, ``count``.  Types use Spark's ``simpleString`` names
(``bigint``, ``double``, ``string``, ``binary``, ``array<double>``, …) so
schema-driven code is portable to real pyspark.
"""

from __future__ import annotations

from typing import Any, Iterable, Sequence

import numpy as np


class Row:
    """Ordered named fields with attribute and index access (pyspark.sql.Row).

    ``__slots__`` because Rows are the unit of every collect/transform:
    no per-instance ``__dict__`` halves construction cost and memory on
    the serving emit path (millions of Rows), and pickling still works
    (protocol-2 slot state)."""

    __slots__ = ("_fields", "_values")

    def __init__(self, **kwargs: Any):
        self._fields = list(kwargs.keys())
        self._values = list(kwargs.values())

    @classmethod
    def from_fields(cls, fields: Sequence[str], values: Sequence[Any]) -> "Row":
        r = cls.__new__(cls)
        r._fields = list(fields)
        r._values = list(values)
        return r

    def __getattr__(self, name: str) -> Any:
        # only reached when normal lookup fails (field names, or slots not
        # yet set mid-unpickle).  object.__getattribute__ bypasses this
        # hook, so an unset slot raises cleanly instead of recursing.
        try:
            fields = object.__getattribute__(self, "_fields")
            values = object.__getattribute__(self, "_values")
        except AttributeError:
            raise AttributeError(name) from None
        try:
            return values[fields.index(name)]
        except ValueError:
            raise AttributeError(name) from None

    def __getitem__(self, key):
        if isinstance(key, str):
            return getattr(self, key)
        return self._values[key]

    def __len__(self) -> int:
        return len(self._values)

    def __iter__(self):
        return iter(self._values)

    def asDict(self) -> dict[str, Any]:
        return dict(zip(self._fields, self._values))

    def __fields__(self) -> list[str]:
        return list(self._fields)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Row)
            and self._fields == other._fields
            and self._values == other._values
        )

    def __hash__(self) -> int:  # pyspark Row is a tuple subclass — hashable
        return hash((tuple(self._fields), tuple(map(_hashable, self._values))))

    def __repr__(self) -> str:
        kv = ", ".join(f"{f}={v!r}" for f, v in zip(self._fields, self._values))
        return f"Row({kv})"


def _hashable(v: Any):
    if isinstance(v, list):
        return tuple(v)
    if isinstance(v, np.ndarray):
        return (v.shape, v.tobytes())
    return v


class StructField:
    def __init__(self, name: str, dataType: str, nullable: bool = True):
        self.name = name
        self.dataType = dataType  # Spark simpleString, e.g. "bigint"
        self.nullable = nullable

    def __repr__(self) -> str:  # pragma: no cover - debug only
        return f"StructField({self.name!r}, {self.dataType!r})"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, StructField)
            and (self.name, self.dataType) == (other.name, other.dataType)
        )

    def __hash__(self) -> int:
        return hash((self.name, self.dataType))


class StructType:
    def __init__(self, fields: Sequence[StructField]):
        self.fields = list(fields)

    @property
    def names(self) -> list[str]:
        return [f.name for f in self.fields]

    def __iter__(self):
        return iter(self.fields)

    def __len__(self) -> int:
        return len(self.fields)

    def __eq__(self, other) -> bool:
        return isinstance(other, StructType) and self.fields == other.fields

    def __hash__(self) -> int:
        return hash(tuple(self.fields))

    def __repr__(self) -> str:  # pragma: no cover - debug only
        return f"StructType({self.fields!r})"


def infer_type(value: Any) -> str:
    """Map a python value to a Spark simpleString type name."""
    if isinstance(value, bool):
        return "boolean"
    if isinstance(value, (int, np.integer)):
        return "bigint"
    if isinstance(value, (float, np.floating)):
        return "double"
    if isinstance(value, str):
        return "string"
    if isinstance(value, (bytes, bytearray)):
        return "binary"
    if isinstance(value, np.ndarray):
        return f"array<{'bigint' if np.issubdtype(value.dtype, np.integer) else 'double'}>"
    if isinstance(value, (list, tuple)):
        if not value:
            return "array<double>"
        return f"array<{infer_type(value[0])}>"
    raise TypeError(f"cannot infer Spark type for {type(value)!r}")


def infer_schema(row: Any, names: Sequence[str] | None = None) -> StructType:
    if isinstance(row, Row):
        names = row.__fields__()
        values = list(row)
    elif isinstance(row, dict):
        names = list(row.keys())
        values = list(row.values())
    else:
        values = list(row)
        names = list(names) if names else [f"_{i + 1}" for i in range(len(values))]
    return StructType(
        [StructField(n, infer_type(v)) for n, v in zip(names, values)]
    )


class DataFrame:
    def __init__(self, rdd, schema: StructType):
        self._rdd = rdd  # RDD of Row
        self.schema = schema

    @property
    def rdd(self):
        return self._rdd

    @property
    def columns(self) -> list[str]:
        return self.schema.names

    @property
    def dtypes(self) -> list[tuple[str, str]]:
        return [(f.name, f.dataType) for f in self.schema.fields]

    def select(self, *cols: str) -> "DataFrame":
        names = [c for group in cols for c in (group if isinstance(group, (list, tuple)) else [group])]
        fields = {f.name: f for f in self.schema.fields}
        new_schema = StructType([fields[n] for n in names])
        new_rdd = self._rdd.map(_SelectRow(names))
        return DataFrame(new_rdd, new_schema)

    def collect(self) -> list[Row]:
        return self._rdd.collect()

    def count(self) -> int:
        return self._rdd.count()

    def take(self, n: int) -> list[Row]:
        return self._rdd.take(n)

    def head(self, n: int = 1):
        rows = self.take(n)
        return rows[0] if n == 1 and rows else rows

    def limit(self, n: int) -> "DataFrame":
        sc = self._rdd._sc
        return DataFrame(sc.parallelize(self.take(n)), self.schema)

    def repartition(self, n: int) -> "DataFrame":
        return DataFrame(self._rdd.repartition(n), self.schema)


class _SelectRow:
    def __init__(self, names: list[str]):
        self.names = names

    def __call__(self, row: Row) -> Row:
        return Row.from_fields(self.names, [row[n] for n in self.names])


class _ToRow:
    def __init__(self, names: list[str]):
        self.names = names

    def __call__(self, rec: Any) -> Row:
        if isinstance(rec, Row):
            return rec
        if isinstance(rec, dict):
            return Row.from_fields(self.names, [rec[n] for n in self.names])
        return Row.from_fields(self.names, list(rec))


class LocalSparkSession:
    """``pyspark.sql.SparkSession`` subset over :class:`LocalSparkContext`."""

    def __init__(self, sc):
        self.sparkContext = sc

    @classmethod
    def builder_for(cls, master: str = "local[2]", app_name: str = "tfos-torch"):
        from tensorflowonspark_torch.sparkapi.context import LocalSparkContext

        return cls(LocalSparkContext(master, app_name))

    def createDataFrame(self, data, schema: StructType | Sequence[str] | None = None
                        ) -> DataFrame:
        from tensorflowonspark_torch.sparkapi.rdd import RDD

        if isinstance(data, RDD):
            rows_rdd = data
            sample = None
        else:
            data = list(data)
            if not data and not isinstance(schema, StructType):
                raise ValueError("cannot create DataFrame from empty data without rows")
            sample = data[0] if data else None
            rows_rdd = None

        if isinstance(schema, StructType):
            st = schema
        else:
            if sample is None and rows_rdd is not None:
                sample = rows_rdd.first()  # only pay a sample job for inference
            if schema is not None:  # list of column names
                st = infer_schema(sample, names=list(schema))
            else:
                st = infer_schema(sample)

        to_row = _ToRow(st.names)
        if rows_rdd is None:
            rows_rdd = self.sparkContext.parallelize([to_row(r) for r in data])
        else:
            rows_rdd = rows_rdd.map(to_row)
        return DataFrame(rows_rdd, st)

    def stop(self) -> None:
        self.sparkContext.stop()


def get_spark_session(master: str | None = None, app_name: str = "tfos-torch"):
    """Real ``SparkSession`` when pyspark is available, else the local one."""
    try:
        from pyspark.sql import SparkSession

        b = SparkSession.builder.appName(app_name)
        if master:
            b = b.master(master)
        return b.getOrCreate()
    except ImportError:
        return LocalSparkSession.builder_for(master or "local[2]", app_name)
