"""How the plain PyTorch loops pass a Python-number divisor or exponent,
so that on the card they compute what the CUDA kernels compute.

On a CUDA tensor PyTorch multiplies by the reciprocal of a Python-number
divisor (x / c becomes x * (1 / c)) and expands the exponents 2, 3, -1
and -2 of x ** c into products, where the kernels divide and call pow.
With a 0-dim tensor operand on the tensor's device it divides and calls
pow, as the kernels do. On the CPU the plain loops keep the Python
number: PyTorch there divides by it as it divides by a tensor, and its
products for the small integer powers are what the JAX package's XLA
computes, so the CPU arithmetic that the parity tests hold against JAX is
the Python-number form. tests/test_torch_operands.py holds on the CPU
which of these operations the tensor form leaves bit for bit the same.
"""

from __future__ import annotations

import torch


def kernel_operand(x, like):
    """Divisor or exponent x for arithmetic with the tensor `like`: the
    Python float on the CPU, elsewhere a 0-dim tensor of `like`'s dtype
    on its device."""
    if like.device.type == "cpu":
        return float(x)
    return torch.full((), float(x), dtype=like.dtype, device=like.device)
