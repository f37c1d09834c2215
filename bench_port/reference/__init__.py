"""The plain references of the benchmark's entries: plain PyTorch and
NumPy, importing nothing of the program under test."""
