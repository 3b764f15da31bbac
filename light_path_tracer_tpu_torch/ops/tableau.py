"""Dormand-Prince 4(5) Butcher tableau.

Standard DP45 coefficients (the same values as
`light_path_tracer_tpu.ops.tableau` and scipy's RK45): 7 stages with FSAL
(stage 7 of an accepted step is stage 1 of the next), a 5th-order
propagating solution, and a 4th-order embedded error estimator E. The
CUDA kernel (csrc/kerr_dp45.cu) rounds these same double values to float.
"""

# Stage coefficient rows (a_ij)
A21 = 1.0 / 5.0
A31, A32 = 3.0 / 40.0, 9.0 / 40.0
A41, A42, A43 = 44.0 / 45.0, -56.0 / 15.0, 32.0 / 9.0
A51, A52, A53, A54 = (19372.0 / 6561.0, -25360.0 / 2187.0,
                      64448.0 / 6561.0, -212.0 / 729.0)
A61, A62, A63, A64, A65 = (9017.0 / 3168.0, -355.0 / 33.0,
                           46732.0 / 5247.0, 49.0 / 176.0,
                           -5103.0 / 18656.0)

# 5th-order solution weights (b_i; b2 = b7 = 0)
B1, B3, B4, B5, B6 = (35.0 / 384.0, 500.0 / 1113.0, 125.0 / 192.0,
                      -2187.0 / 6784.0, 11.0 / 84.0)

# Embedded 4th-order error-estimator weights (e_i = b_i - b*_i; e2 = 0)
E1, E3, E4, E5, E6, E7 = (71.0 / 57600.0, -71.0 / 16695.0, 71.0 / 1920.0,
                          -17253.0 / 339200.0, 22.0 / 525.0, -1.0 / 40.0)
