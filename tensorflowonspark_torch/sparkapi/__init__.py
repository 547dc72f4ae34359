"""Spark-compatible execution substrate.

The reference framework runs *on top of* Apache Spark (``SURVEY.md §0``): Spark
is the resource manager, task scheduler, and data substrate, reached through
the public PySpark API (``sc.parallelize(...).foreachPartition``,
``rdd.mapPartitions``, ``df.rdd``, …).  This package provides that API subset
two ways:

- **Real PySpark**, when importable: :func:`get_spark_context` /
  :func:`get_spark_session` simply return pyspark objects, and every
  framework module keeps working because it only touches the public subset.
- **The bundled local substrate** otherwise: :class:`LocalSparkContext` runs
  each partition task in one of N persistent, separate executor *processes*
  (spawn), mirroring Spark ``local-cluster[N, cores, mem]`` semantics — the
  mode the reference's own integration tests rely on (``SURVEY.md §4``).
  Closures are cloudpickled, results return over a shared queue, failures
  propagate driver-side with the executor traceback and **no task retry**
  (``spark.task.maxFailures=1``, the setting the reference documents as
  required for SPMD training).

This is not a Spark reimplementation — no shuffle, no lineage recovery, no
storage levels.  It is the contract surface the orchestration layer needs,
with real process isolation where it matters.

A copy of ``tensorflowonspark_tpu/sparkapi`` with its imports
rewritten: the port never imports the JAX package.
"""

from tensorflowonspark_torch.sparkapi.context import (  # noqa: F401
    Broadcast,
    LocalSparkContext,
    SparkConf,
    get_spark_context,
)
from tensorflowonspark_torch.sparkapi.rdd import RDD  # noqa: F401
from tensorflowonspark_torch.sparkapi.sql import (  # noqa: F401
    DataFrame,
    LocalSparkSession,
    Row,
    StructField,
    StructType,
    get_spark_session,
)


def have_pyspark() -> bool:
    try:
        import pyspark  # noqa: F401

        return True
    except ImportError:
        return False
