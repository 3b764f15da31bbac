// The float64 instances of the Kerr DP45 ray kernel (shadow and disk
// variants; entries lpt_kerr_dp45_f64, lpt_kerr_dp45_disk_f64): see
// kerr_dp45.cu for what they compute, what they replace and what bounds
// them. Their own translation unit, so nvcc builds them beside the float
// ones.

#define LPT_DOUBLE 1
#include "kerr_dp45.cu"
