// The float64 DOP853 instances of the polarized (Stokes) form of the Kerr
// extras kernel (entries lpt_kerr_dp45_stokes_dop853_f64): see
// kerr_dop853_stokes.cu.

#define LPT_DOUBLE 1
#include "kerr_dop853_stokes.cu"
