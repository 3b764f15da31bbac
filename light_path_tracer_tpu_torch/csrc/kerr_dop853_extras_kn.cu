// The DOP853 Kerr-Newman instances of the volumetric (thin, self-absorbed) and
// spectral forms of the extras kernel (entries lpt_kerr_dp45_extras_kn_dop853
// and its _describe twin): kerr_dp45_extras_kn.cu built with Hairer's DOP853
// 8(5,3) pair of kerr_dop853.cuh, linked into the DOP853 library
// (ops/cuda/_build.py).

#define LPT_DOP853 1
#include "kerr_dp45_extras_kn.cu"
