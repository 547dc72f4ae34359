"""Native (C++) runtime pieces of the port, loaded with ``ctypes``.

- :mod:`.tfrecord_native` — the TFRecord codec (``tfrecord_codec.cc``, a
  copy of ``tensorflowonspark_tpu/native/tfrecord_codec.cc``), built with
  ``g++`` at first use into ``tensorflowonspark_torch/_build/``.
"""
