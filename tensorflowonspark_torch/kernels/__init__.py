"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
twin (the CPU path and the reference ``chip_smoke.py`` holds it against).

- :mod:`.group_norm` — fused GroupNorm (+residual) (+ReLU), forward and
  backward.
- :mod:`._build` — ``nvcc`` build of ``csrc/*.cu`` into ``_build/`` at
  first use, loaded with ``ctypes``.
"""
