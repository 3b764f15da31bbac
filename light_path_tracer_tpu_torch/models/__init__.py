"""Spacetime metric model families (Kerr, Schwarzschild and
Reissner-Nordstrom so far)."""

from light_path_tracer_tpu_torch.models.base import Metric
from light_path_tracer_tpu_torch.models.kerr import Kerr
from light_path_tracer_tpu_torch.models.reissner_nordstrom import (
    ReissnerNordstrom)
from light_path_tracer_tpu_torch.models.schwarzschild import Schwarzschild


def make_metric(M: float = 1.0, a: float = 0.0,
                Q: float = 0.0, eps3: float = 0.0) -> Metric:
    """Metric selection, with the JAX package's precedence: eps3 ->
    Johannsen-Psaltis, a and Q -> Kerr-Newman, a -> Kerr,
    Q -> Reissner-Nordstrom, else Schwarzschild.

    Kerr-Newman and Johannsen-Psaltis are not ported yet and raise.
    """
    if eps3 != 0 or (a != 0 and Q != 0):
        family = "Johannsen-Psaltis" if eps3 != 0 else "Kerr-Newman"
        raise NotImplementedError(
            f"{family} is not ported to the PyTorch package yet; it "
            f"follows in later slices of the port (ROADMAP.md, Queue 1)")
    if a != 0:
        return Kerr(M=M, a=a)
    if Q != 0:
        return ReissnerNordstrom(M=M, Q=Q)
    return Schwarzschild(M=M)


__all__ = ["Metric", "Kerr", "Schwarzschild", "ReissnerNordstrom",
           "make_metric"]
