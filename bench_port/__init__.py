"""Benchmark of the PyTorch and CUDA port on one H100 (``run.py``)."""
