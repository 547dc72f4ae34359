"""The port's example scripts, run as modules from the repository root.

- :mod:`.resnet_spark` — ResNet-50 data-parallel training in
  ``InputMode.TENSORFLOW``, each node reading its TFRecord shard
  (port of ``examples/imagenet/resnet_spark.py``).
- :mod:`.criteo_pipeline` — Criteo wide&deep through the Spark ML pipeline
  (``--input spark``) or over Parquet in ``InputMode.TENSORFLOW``
  (``--input parquet``), then scored by ``TFModel.transform`` (port of
  ``examples/criteo/criteo_pipeline.py``).

Importing them runs nothing: each script acts only under
``if __name__ == "__main__"``.
"""
