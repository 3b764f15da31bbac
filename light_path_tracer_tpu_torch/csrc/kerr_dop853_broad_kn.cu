// The DOP853 Kerr-Newman broad instances of the extras kernel (entry
// lpt_kerr_dp45_broad_kn_dop853): kerr_dp45_broad_kn.cu with Hairer's pair.

#define LPT_DOP853 1
#include "kerr_dp45_broad_kn.cu"
