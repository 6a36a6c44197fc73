"""The benchmark harness of the PyTorch and CUDA port (see hmmbench/README.md)."""
