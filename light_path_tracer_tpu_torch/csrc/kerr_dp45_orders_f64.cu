// The float64 instances of the photon-ring order forms of the Kerr DP45
// extras kernel (entry lpt_kerr_dp45_orders_f64): see kerr_dp45_orders.cu.
// Their own translation unit, so nvcc builds them beside the float ones.

#define LPT_DOUBLE 1
#include "kerr_dp45_orders.cu"
