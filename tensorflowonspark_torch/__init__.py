"""PyTorch/CUDA port of ``tensorflowonspark_tpu``.

The JAX package stays the reference; this package reproduces its surface
slice by slice on PyTorch, with hand-written Hopper kernels where the JAX
package relied on a TPU kernel or an XLA fusion.  It never imports ``jax``
or ``tensorflowonspark_tpu``: modules it needs from there are copied.

Device rule: entry points take ``device=``.  With no argument they run on
``cuda``; ``device="cpu"`` or ``TFOS_TORCH_DEVICE=cpu`` (inherited by
executor processes) selects the CPU.  A ``cuda`` request on a host without
a card raises — nothing falls back to the CPU
(:func:`tensorflowonspark_torch.util.select_device`).

Ported so far: ResNet-50 batch inference through
``pipeline.TFModel.transform``, and ResNet-50 data-parallel training
through ``TFCluster.run`` → ``TFNode.DataFeed`` → ``trainer.Trainer.step``
(``InputMode.SPARK``), both with the fused GroupNorm kernel and its
backward (``kernels/group_norm.py``, ``csrc/group_norm.cu``,
``csrc/group_norm_bwd.cu``); Criteo wide&deep through
``pipeline.TFEstimator.fit`` with the AdaGrad table kernels
(``csrc/sparse_adagrad.cu``); and ``InputMode.TENSORFLOW``, each node
reading its own TFRecord or Parquet files (``tfrecord``, ``dfutil``,
``readers``, the native codec in ``native/``), as the port's
``examples/resnet_spark.py`` and ``examples/criteo_pipeline.py`` launch
both models.
"""
