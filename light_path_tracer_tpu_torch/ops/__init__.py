"""Tracing ops: the plain PyTorch Kerr loop, the CUDA kernel wrapper and
the batch driver."""
