// The float64 DOP853 Kerr-Newman instances of the photon-ring order forms of
// the extras kernel (entries lpt_kerr_dp45_orders_kn_dop853_f64 and its
// _describe twin): see kerr_dop853_orders_kn.cu.

#define LPT_DOUBLE 1
#include "kerr_dop853_orders_kn.cu"
