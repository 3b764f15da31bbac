// The float64 DOP853 instances of the photon-ring order forms of the Kerr
// extras kernel (entries lpt_kerr_dp45_orders_dop853_f64): see
// kerr_dop853_orders.cu.

#define LPT_DOUBLE 1
#include "kerr_dop853_orders.cu"
