"""The benchmark of the PyTorch/CUDA port (``lipsync_tpu_torch``): see
``run.py`` and ``BENCHMARK.json``."""
