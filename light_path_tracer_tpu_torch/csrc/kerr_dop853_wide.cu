// The DOP853 wide disk instances of the Kerr ray kernel (entry
// lpt_kerr_dp45_wide_dop853): kerr_dp45_wide.cu built with Hairer's DOP853
// 8(5,3) pair of kerr_dop853.cuh. A translation unit of its own, linked
// into the DOP853 library (ops/cuda/_build.py).

#define LPT_DOP853 1
#include "kerr_dp45_wide.cu"
