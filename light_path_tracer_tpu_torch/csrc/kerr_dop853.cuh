// Hairer's DOP853 8(5,3) embedded pair for the Kerr ray kernel
// (kerr_dp45.cu) and the extras kernel (kerr_dp45_extras.cuh): the tableau
// and one attempt's stages and error norm over N state components. A
// source that defines LPT_DOP853 before including kerr_dp45_common.cuh
// compiles its kernels with this pair (kDop853); the kerr_dop853*.cu
// files do, each including its DP45 sibling.
//
// Replaces the method="dop853" branches of the Pallas kernels' shared
// body, light_path_tracer_tpu/ops/kerr_trace.py dp45_integrate (the stages
// at :855-867, the error scale at :908-923, the estimator at :925-956, the
// exponent at :1003); the plain PyTorch version is the same branch of
// light_path_tracer_tpu_torch/ops/kerr_trace.py dp45_integrate. Numerics
// as there, in the instance's scalar type: the coefficients are the
// double values of ops/tableau.py (rounded once to float in the float
// instances), every stage sum is the left fold c0 k0 + c1 k1 + ... then
// times h, Hairer's combined estimator is h |e5|^2 / sqrt(N (|e5|^2 +
// 0.01 |e3|^2)) over the RMS-scaled components, a non-finite value of
// which is a hard reject (infinity), and float32's error scale is
// increment-aware over the maximum |k| of all 13 stages.
//
// Registers: the sums of the solution (B) and of both estimators (E5, E3)
// read stages 0 and 5..11, and the float32 scale every stage. Each is
// accumulated as its stage is made, in index order, so the roundings are
// those of the left fold, and the maximum is a running one. Row 2 is the
// last reader of stage 1, row 4 of stage 2, row 11 of stages 3..10; no
// stage outlives its last reader, and the end stage's evaluation runs with
// only y, k1, y5 and the four accumulators live. The wider extras
// instances spill all the same (chip_smoke.py prints every instance's
// registers and spills).

#pragma once

#include "kerr_dp45_common.cuh"

namespace {

// The DOP853 tableau (ops/tableau.py D853_A, D853_B, D853_E5, D853_E3):
// a<r>_<j> is row r's weight of stage j, b<j>, e5_<j> and e3_<j> the
// weights of the solution and the two estimators.
template <class T>
struct Tab853 {
  static constexpr T a1_0 = T(0.05260015195876773);
  static constexpr T a2_0 = T(0.0197250569845379);
  static constexpr T a2_1 = T(0.0591751709536137);
  static constexpr T a3_0 = T(0.02958758547680685);
  static constexpr T a3_2 = T(0.08876275643042054);
  static constexpr T a4_0 = T(0.2413651341592667);
  static constexpr T a4_2 = T(-0.8845494793282861);
  static constexpr T a4_3 = T(0.924834003261792);
  static constexpr T a5_0 = T(0.037037037037037035);
  static constexpr T a5_3 = T(0.17082860872947386);
  static constexpr T a5_4 = T(0.12546768756682242);
  static constexpr T a6_0 = T(0.037109375);
  static constexpr T a6_3 = T(0.17025221101954405);
  static constexpr T a6_4 = T(0.06021653898045596);
  static constexpr T a6_5 = T(-0.017578125);
  static constexpr T a7_0 = T(0.03709200011850479);
  static constexpr T a7_3 = T(0.17038392571223998);
  static constexpr T a7_4 = T(0.10726203044637328);
  static constexpr T a7_5 = T(-0.015319437748624402);
  static constexpr T a7_6 = T(0.008273789163814023);
  static constexpr T a8_0 = T(0.6241109587160757);
  static constexpr T a8_3 = T(-3.3608926294469414);
  static constexpr T a8_4 = T(-0.868219346841726);
  static constexpr T a8_5 = T(27.59209969944671);
  static constexpr T a8_6 = T(20.154067550477894);
  static constexpr T a8_7 = T(-43.48988418106996);
  static constexpr T a9_0 = T(0.47766253643826434);
  static constexpr T a9_3 = T(-2.4881146199716677);
  static constexpr T a9_4 = T(-0.590290826836843);
  static constexpr T a9_5 = T(21.230051448181193);
  static constexpr T a9_6 = T(15.279233632882423);
  static constexpr T a9_7 = T(-33.28821096898486);
  static constexpr T a9_8 = T(-0.020331201708508627);
  static constexpr T a10_0 = T(-0.9371424300859873);
  static constexpr T a10_3 = T(5.186372428844064);
  static constexpr T a10_4 = T(1.0914373489967295);
  static constexpr T a10_5 = T(-8.149787010746927);
  static constexpr T a10_6 = T(-18.52006565999696);
  static constexpr T a10_7 = T(22.739487099350505);
  static constexpr T a10_8 = T(2.4936055526796523);
  static constexpr T a10_9 = T(-3.0467644718982196);
  static constexpr T a11_0 = T(2.273310147516538);
  static constexpr T a11_3 = T(-10.53449546673725);
  static constexpr T a11_4 = T(-2.0008720582248625);
  static constexpr T a11_5 = T(-17.9589318631188);
  static constexpr T a11_6 = T(27.94888452941996);
  static constexpr T a11_7 = T(-2.8589982771350235);
  static constexpr T a11_8 = T(-8.87285693353063);
  static constexpr T a11_9 = T(12.360567175794303);
  static constexpr T a11_10 = T(0.6433927460157636);
  static constexpr T b0 = T(0.054293734116568765);
  static constexpr T b5 = T(4.450312892752409);
  static constexpr T b6 = T(1.8915178993145003);
  static constexpr T b7 = T(-5.801203960010585);
  static constexpr T b8 = T(0.3111643669578199);
  static constexpr T b9 = T(-0.1521609496625161);
  static constexpr T b10 = T(0.20136540080403034);
  static constexpr T b11 = T(0.04471061572777259);
  static constexpr T e5_0 = T(0.01312004499419488);
  static constexpr T e5_5 = T(-1.2251564463762044);
  static constexpr T e5_6 = T(-0.4957589496572502);
  static constexpr T e5_7 = T(1.6643771824549864);
  static constexpr T e5_8 = T(-0.35032884874997366);
  static constexpr T e5_9 = T(0.3341791187130175);
  static constexpr T e5_10 = T(0.08192320648511571);
  static constexpr T e5_11 = T(-0.022355307863886294);
  static constexpr T e3_0 = T(-0.18980075407240762);
  static constexpr T e3_5 = T(4.450312892752409);
  static constexpr T e3_6 = T(1.8915178993145003);
  static constexpr T e3_7 = T(-5.801203960010585);
  static constexpr T e3_8 = T(-0.4226823213237919);
  static constexpr T e3_9 = T(-0.1521609496625161);
  static constexpr T e3_10 = T(0.20136540080403034);
  static constexpr T e3_11 = T(0.02265179219836082);
};

template <class T>
__device__ __forceinline__ T inf_() {
  if constexpr (kSingle<T>) return __int_as_float(0x7f800000);
  else return __longlong_as_double(0x7ff0000000000000LL);
}

// One DOP853 attempt's stages from (y, k1) with step h (h_eff): the eleven
// new stages, y5 (the 8th-order solution) and the FSAL end stage kend =
// rhs(y5); returns the error norm and sets finite_ok (y5 finite with
// r > 0). rhs(y, out) is the right-hand side over the N components;
// atol and rtol the lane's tolerances. kMu: the mu chart, whose component
// 1 takes mu_scale_floor in the error scale.
template <bool kMu = false, class T, int N, class Rhs>
__device__ __forceinline__ T dop853_stages(const T (&y)[N], const T (&k1)[N],
                                           T h, T atol, T rtol, Rhs&& rhs,
                                           T (&y5)[N], T (&kend)[N],
                                           bool& finite_ok) {
  using K = Tab853<T>;
  T yt[N], s1[N], s2[N], s3[N], s4[N], s5[N], s6[N], s7[N], s8[N], s9[N],
      s10[N], s11[N];
  T bsum[N], e5[N], e3[N], kmag[N];
#pragma unroll
  for (int c = 0; c < N; ++c) {
    bsum[c] = K::b0 * k1[c];
    e5[c] = K::e5_0 * k1[c];
    e3[c] = K::e3_0 * k1[c];
    kmag[c] = abs_(k1[c]);
  }
  // A new stage joins the running maximum |k| (float32's error scale),
  // and one that the sums read joins them too.
  auto track = [&](const T (&s)[N]) {
    if constexpr (kSingle<T>) {
#pragma unroll
      for (int c = 0; c < N; ++c) kmag[c] = jmax(kmag[c], abs_(s[c]));
    }
  };
  auto add = [&](const T (&s)[N], T b, T w5, T w3) {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      bsum[c] = bsum[c] + b * s[c];
      e5[c] = e5[c] + w5 * s[c];
      e3[c] = e3[c] + w3 * s[c];
    }
    track(s);
  };
  // stage 1
#pragma unroll
  for (int c = 0; c < N; ++c)
    yt[c] = y[c] + h * (K::a1_0 * k1[c]);
  rhs(yt, s1);
  track(s1);
  // stage 2
#pragma unroll
  for (int c = 0; c < N; ++c)
    yt[c] = y[c] + h * (K::a2_0 * k1[c] + K::a2_1 * s1[c]);
  rhs(yt, s2);
  track(s2);
  // stage 3
#pragma unroll
  for (int c = 0; c < N; ++c)
    yt[c] = y[c] + h * (K::a3_0 * k1[c] + K::a3_2 * s2[c]);
  rhs(yt, s3);
  track(s3);
  // stage 4
#pragma unroll
  for (int c = 0; c < N; ++c)
    yt[c] = y[c] + h * (K::a4_0 * k1[c] + K::a4_2 * s2[c] + K::a4_3 * s3[c]);
  rhs(yt, s4);
  track(s4);
  // stage 5
#pragma unroll
  for (int c = 0; c < N; ++c)
    yt[c] = y[c] + h * (K::a5_0 * k1[c] + K::a5_3 * s3[c] + K::a5_4 * s4[c]);
  rhs(yt, s5);
  add(s5, K::b5, K::e5_5, K::e3_5);
  // stage 6
#pragma unroll
  for (int c = 0; c < N; ++c)
    yt[c] = y[c] + h * (K::a6_0 * k1[c] + K::a6_3 * s3[c] + K::a6_4 * s4[c] +
                        K::a6_5 * s5[c]);
  rhs(yt, s6);
  add(s6, K::b6, K::e5_6, K::e3_6);
  // stage 7
#pragma unroll
  for (int c = 0; c < N; ++c)
    yt[c] = y[c] + h * (K::a7_0 * k1[c] + K::a7_3 * s3[c] + K::a7_4 * s4[c] +
                        K::a7_5 * s5[c] + K::a7_6 * s6[c]);
  rhs(yt, s7);
  add(s7, K::b7, K::e5_7, K::e3_7);
  // stage 8
#pragma unroll
  for (int c = 0; c < N; ++c)
    yt[c] = y[c] + h * (K::a8_0 * k1[c] + K::a8_3 * s3[c] + K::a8_4 * s4[c] +
                        K::a8_5 * s5[c] + K::a8_6 * s6[c] + K::a8_7 * s7[c]);
  rhs(yt, s8);
  add(s8, K::b8, K::e5_8, K::e3_8);
  // stage 9
#pragma unroll
  for (int c = 0; c < N; ++c)
    yt[c] = y[c] + h * (K::a9_0 * k1[c] + K::a9_3 * s3[c] + K::a9_4 * s4[c] +
                        K::a9_5 * s5[c] + K::a9_6 * s6[c] + K::a9_7 * s7[c] +
                        K::a9_8 * s8[c]);
  rhs(yt, s9);
  add(s9, K::b9, K::e5_9, K::e3_9);
  // stage 10
#pragma unroll
  for (int c = 0; c < N; ++c)
    yt[c] = y[c] + h * (K::a10_0 * k1[c] + K::a10_3 * s3[c] + K::a10_4 * s4[c] +
                        K::a10_5 * s5[c] + K::a10_6 * s6[c] + K::a10_7 * s7[c] +
                        K::a10_8 * s8[c] + K::a10_9 * s9[c]);
  rhs(yt, s10);
  add(s10, K::b10, K::e5_10, K::e3_10);
  // stage 11
#pragma unroll
  for (int c = 0; c < N; ++c)
    yt[c] = y[c] + h * (K::a11_0 * k1[c] + K::a11_3 * s3[c] + K::a11_4 * s4[c] +
                        K::a11_5 * s5[c] + K::a11_6 * s6[c] + K::a11_7 * s7[c] +
                        K::a11_8 * s8[c] + K::a11_9 * s9[c] +
                        K::a11_10 * s10[c]);
  rhs(yt, s11);
  add(s11, K::b11, K::e5_11, K::e3_11);
#pragma unroll
  for (int c = 0; c < N; ++c) y5[c] = y[c] + h * bsum[c];
  rhs(y5, kend);
  finite_ok = all_finite(y5) && (y5[0] > T(0.0));

  // error scale (increment-aware over all 13 stages in float32) and
  // Hairer's combined estimator over the N components
  T e5_sq = T(0.0), e3_sq = T(0.0);
#pragma unroll
  for (int c = 0; c < N; ++c) {
    T mag = jmax(abs_(y[c]), abs_(y5[c]));
    if (kMu && c == 1) mag = mu_scale_floor(mag);
    if constexpr (kSingle<T>) mag = mag + h * jmax(kmag[c], abs_(kend[c]));
    const T scale = atol + rtol * mag;
    const T r5 = finite_ok ? e5[c] / scale : T(0.0);
    const T r3 = finite_ok ? e3[c] / scale : T(0.0);
    e5_sq = e5_sq + r5 * r5;
    e3_sq = e3_sq + r3 * r3;
  }
  const T denom = e5_sq + T(0.01) * e3_sq;
  const T err = h * e5_sq / sqrt_(jmax(static_cast<T>(N) * denom, T(1e-30)));
  // A stage can overflow where y5 stays finite (the large A coefficients
  // probe far from y): a non-finite norm is a hard reject.
  return is_finite_f(err) ? err : inf_<T>();
}

}  // namespace
