// The Kerr-Newman broad instances of the DP45 extras kernel (entry
// lpt_kerr_dp45_broad_kn): kerr_dp45_broad.cu built with LPT_KN, so the
// geodesic and the flow carry the charge (kerr_dp45_extras.cuh).

#define LPT_KN 1
#define LPT_INFIX _kn
#include "kerr_dp45_broad.cu"
