"""Spacetime metric model families: Schwarzschild, Reissner-Nordstrom,
Kerr, Kerr-Newman and Johannsen-Psaltis."""

from light_path_tracer_tpu_torch.models.base import Metric
from light_path_tracer_tpu_torch.models.johannsen_psaltis import (
    JohannsenPsaltis)
from light_path_tracer_tpu_torch.models.kerr import Kerr, TracedKerr
from light_path_tracer_tpu_torch.models.kerr_newman import KerrNewman
from light_path_tracer_tpu_torch.models.reissner_nordstrom import (
    ReissnerNordstrom)
from light_path_tracer_tpu_torch.models.schwarzschild import Schwarzschild


def make_metric(M: float = 1.0, a: float = 0.0,
                Q: float = 0.0, eps3: float = 0.0) -> Metric:
    """Metric selection, with the JAX package's precedence: eps3 ->
    Johannsen-Psaltis (exclusive with Q), a and Q -> Kerr-Newman,
    a -> Kerr, Q -> Reissner-Nordstrom, else Schwarzschild."""
    if eps3 != 0:
        if Q != 0:
            raise ValueError("eps3 (Johannsen-Psaltis) and Q (charge) "
                             "are mutually exclusive")
        return JohannsenPsaltis(M=M, a=a, eps3=eps3)
    if a != 0 and Q != 0:
        return KerrNewman(M=M, a=a, Q=Q)
    if a != 0:
        return Kerr(M=M, a=a)
    if Q != 0:
        return ReissnerNordstrom(M=M, Q=Q)
    return Schwarzschild(M=M)


__all__ = ["Metric", "Kerr", "TracedKerr", "KerrNewman", "JohannsenPsaltis",
           "Schwarzschild", "ReissnerNordstrom", "make_metric"]
