"""Metric base class.

Metrics are small frozen dataclasses of Python floats. Scalar,
configuration-time geometry (horizon, capture radius, alpha_crit) runs on
the host in float64 NumPy; the per-ray hot path is batched over torch
tensors, structure-of-arrays, on whatever device the tensors live.
"""

from __future__ import annotations

import abc
import dataclasses


@dataclasses.dataclass(frozen=True)
class Metric(abc.ABC):
    """Base class for spacetime metrics (geometric units, G = c = 1)."""

    is_spherically_symmetric: bool = dataclasses.field(
        default=False, init=False, repr=False)

    @abc.abstractmethod
    def capture_radius(self) -> float:
        """Inner stopping radius for integration (host-side scalar)."""

    @abc.abstractmethod
    def alpha_crit(self, r_obs, theta_obs=None, device=None) -> float:
        """Critical viewing angle in radians (host-side scalar). device:
        where a family without a closed form traces its bisection (None:
        the card); closed forms ignore it."""
