"""The port's surface trace under Hairer's DOP853 pair against the JAX
package's XLA loop: tests/test_torch_surface.py's Kerr case and criteria
(float64 within 1e-9 relative with identical statuses; float32 within
1e-3 of the largest value of JAX's float64 trace, p99, as JAX's own
float32 is) in both dtypes with the time component. A file of its own:
JAX compiles each DOP853 loop for ~15-20 s on this host.
"""

import pytest
import torch

from test_torch_surface import check_kerr


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_surface_trace_kerr_dop853_matches_jax(dtype):
    check_kerr("dop853", dtype, True)
