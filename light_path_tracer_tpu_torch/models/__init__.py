"""Spacetime metric model families (Kerr so far)."""

from light_path_tracer_tpu_torch.models.base import Metric
from light_path_tracer_tpu_torch.models.kerr import Kerr


def make_metric(M: float = 1.0, a: float = 0.0,
                Q: float = 0.0, eps3: float = 0.0) -> Metric:
    """Metric selection, with the JAX package's precedence: eps3 ->
    Johannsen-Psaltis, a and Q -> Kerr-Newman, a -> Kerr,
    Q -> Reissner-Nordstrom, else Schwarzschild.

    Only Kerr (a != 0) is ported. The other families raise instead of
    returning Kerr(a=0): the JAX package traces a = 0 on a different code
    path (the Schwarzschild orbit tracer), so a Kerr stand-in would not
    be the same computation.
    """
    if eps3 != 0 or Q != 0 or a == 0:
        family = ("Johannsen-Psaltis" if eps3 != 0
                  else "Kerr-Newman" if a != 0
                  else "Reissner-Nordstrom" if Q != 0
                  else "Schwarzschild")
        raise NotImplementedError(
            f"{family} is not ported to the PyTorch package yet; it "
            f"follows in later slices of the port (ROADMAP.md, Queue 1)")
    return Kerr(M=M, a=a)


__all__ = ["Metric", "Kerr", "make_metric"]
