#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/, holds each kernel against its
plain PyTorch version on the card, drives three paths through the entry
points a user calls (the 1024^2 Kerr a=0.9 shadow, the 1024^2
Schwarzschild shadow and the 512^2 Schwarzschild lensed render) and
checks what they produce, then the config-4 thin-disk render, the 1024^2
volumetric hot-flow and spectral renders, the polarized, flare-movie and
order-decomposition renders, the card's arithmetic peak rates, config
5, the 4k Kerr shadow at 4 jittered samples a pixel, the Kerr-Newman
and Johannsen-Psaltis metrics through the Kerr kernel, Hairer's
DOP853 pair and linear event location through the Kerr and extras
kernels, the mu chart's hybrid tracer and charged volumetric scenes,
the disk family, tilted, warped and multi-plane disks, and spectra,
movies, ring orders, crossing slots and planes of any width (the broad
instances), the lens-map products on the surface kernel, and the
sequences (camera pans, spin sweeps, flybys) through the Kerr kernel's
run-time (M, a, r_obs) with the panoramas and the stellar surface, and
the render server (serve.py) answering requests on the card.
Phases:
  1. machine: card name and power limit, torch and nvcc versions;
  2. build: nvcc for sm_90a without FMA contraction (-fmad=false), with
     the build time and each kernel instance's registers and spills; for
     each extras instance also the blocks of 128 threads an SM holds
     (the runtime's occupancy query) and its functor's block bound (the
     DOP853 library builds in a child process at the lowest CPU priority
     beside phases 11 on, and phase 22 waits for it);
  3. kernel vs plain version: 4,096 random rays (status agreement > 0.99,
     p99 |d final_alpha| < 2e-3 on stable escaped rays), a 128^2 image
     (shadow masks agree on >= 99.5% of pixels), and the main path's
     524,288 rays at 1024^2 (same gates), each with both times, the
     kernel alone by CUDA events (a spin kernel queued ahead hides the
     host's dispatch), the mean attempts and the lane efficiency
     (attempts over 32 x the warp step sum);
  4. main path: render_shadow once to warm up and 3 more times; the kernel
     launch counter must grow and the plain loop's stay at 0; the shadow
     must be the Kerr D inside the alpha_crit circle; then 3 frames under
     torch.profiler: launches, device ms and busy share a frame (the
     busy share only from a profile that kept a record of every Kerr
     kernel launch the wrappers counted, taken up to 3 times; else
     null).
  5. orbit kernel vs plain version, Schwarzschild and Reissner-Nordstrom
     Q=0.6: 4,096 random rays in [0.2, 4] alpha_crit plus an alpha = 0
     lane, then the 1,048,576 rays of the 1024^2 grid (status agreement
     > 0.999, p99 |d final_alpha| < 1e-4 on stable escaped rays, the
     alpha = 0 lane INVALID), each with both times and both n_steps;
  6. config 1: the 1024^2 Schwarzschild shadow through render_shadow,
     warm-up and 3 runs; 1,048,576 traced rays, the orbit kernel launched
     and its plain loop not; captured pixels 0.98-1.02 x the analytic
     alpha_crit disk, none outside 1.01 alpha_crit;
  7. config 2: the 512^2 Schwarzschild lensed render through
     render_scene, warm-up and 3 runs, with every stage's time; a finite
     (512, 512, 3) float32 image whose black pixels are the captured rays;
     then a 64^2 render on the card against the CPU (shadow masks >= 99 %,
     bilinear image RMSE < 1e-3 on pixels of winding < 2).
  8. disk kernel vs plain version: 4,096 random rays (alpha in [0.01,
     0.12] rad, theta_obs = 80 deg), opaque and then translucent with
     momenta, and the 1,048,576 rays of the 1024^2 config-4 grid with
     both versions capped at 512 attempts (status and n_hits agreement
     > 0.99; on rays hit in both, median |d r_hits[0]| < 1e-3 M and p99
     < 0.1 M; median |d final_alpha| < 1e-4 on escaped no-hit rays), each
     with both times and both n_steps;
  9. two-pass drivers: on the 1024^2 disk grid, aligned and offset by a
     quarter pixel, trace_disk_rays_two_pass equals the single pass bitwise
     (status, n_hits, r_hits, phi_hits, final_alpha) whenever at most
     `slots` rays are unconverged, with both times; the disk driver over
     the kernel and over the plain loop on phase 8's 4,096 rays (phase 8's
     gates); trace_rays_kerr_two_pass on the main-path rays with
     pass1_steps = 64, bitwise against the single pass and over the plain
     loop; then render_shadow with two_pass=True equals phase 4's image;
 10. config 4: the 1024^2 Kerr a=0.9 thin-disk render through render_disk,
     warm-up and 3 runs; the disk kernel launched (through the two-pass
     driver) and its plain loop not; a finite (1024, 1024) float32 image in
     [0, 1] with disk pixels and captured rays, its brighter half > 2x the
     dimmer (Doppler beaming); then a 64^2 render on the card against the
     CPU (disk masks >= 99 %, median |d image| < 1e-3 on disk pixels).
 11. extras kernel vs plain version: 4,096 random rays (alpha in [0.3, 4]
     alpha_crit, theta_obs = 80 deg, max_steps 1000, sat_window 512), the
     thin, absorbed (alpha0 0.5), jet (beta 0.6, index -1), 2-band
     (0.5/2, q 2) and 3-band (0.1/1/10, q 3) spectral forms (status
     agreement > 0.99, p99 |d tau| < 1e-3, p99 |d emission| / max per
     band < 1e-3, or < 2x the plain loop's own float32 gap from its
     float64 result on the same rays where that is larger), with both
     times and both n_steps;
 12. the 1024^2 volumetric scene (a = 0.9, theta_obs = 80 deg, FOV 16 deg,
     default RIAFConfig): the kernel's single pass against the two-pass
     drivers bitwise (thin and 3-band spectral; default first pass and a
     256-attempt one), the rays the saturation and frozen-state exits
     ended and the slowest rays; the plain loop against the kernel on the
     256^2 grid of the scene for each of phase 13's four paths, both
     capped at 512 attempts (phase 11's gates; the float64 run that
     widens a bar only for the 3-band form); both drivers (thin and
     3-band) over the kernel and over the plain loop on phase 11's rays,
     capped at 512;
 13. the four volumetric paths through render_volumetric and
     render_volumetric_spectrum at 1024^2 (thin, absorbed alpha0 0.3, jet
     beta 0.6, 3-band spectral 0.1/1/10), warm-up and 3 runs each: two
     kernel launches per driver call and no plain loop, finite images in
     [0, 1], the thin torus's Doppler crescent (half ratio > 2), absorbed
     emission below the thin, the SSA turnover and the growing
     photosphere of the spectrum; then 64^2 renders on the card against
     the CPU, the thin image and each band of the 3-band spectrum
     (emission masks >= 99 %, median |d image| < 1e-4).
 14. the Stokes, movie and order forms of the extras kernel vs the plain
     loop: Stokes (toroidal and vertical field, four per-ray aux
     constants), Movie<8> thin and absorbed (alpha0 0.3, spot_amp 8, eight
     frames over one blob period) and Order<3> thin and absorbed, on
     phase 11's 4,096 random rays with max_steps 1000 and sat_window 512
     (the plain loop costs ~10-40 ms an iteration, whatever the batch),
     against the plain loop in float32 and (Stokes, movie) float64; then
     the five forms of phase 15 on the scene's 256^2 grid, the Stokes
     and absorbed order forms at the main path's window, both capped at
     2,048 attempts (the lanes that reach that cap again with sat_window
     512, where the exits must end them in both), the movie and thin
     order forms with sat_window 256 capped at 512 (their plain loops
     take 60-105 s at 2,048 attempts);
     then each form's single pass on the 1024^2 scene (its time, the
     exits' counts and the slowest rays) with the two-pass driver
     bitwise against it. Gates: status agreement > 0.99; every
     Stokes and movie extra p99 |d| / max < 1e-3 (Q and U against
     max |I|), or < 2x the plain loop's own float32 gap from float64.
     A two-order form joins the random rays: its open-ended last bucket
     takes every later crossing.
     The order buckets are not held per ray (floor(m) switches where m
     sits within rounding of an integer after a crossing: a coin flip
     per ray and crossing) but every order on its own: its flux within
     max(3 %, 3 / sqrt(rays that carry it)) of its own plain flux, more
     than 40 % of its carriers with the same bucket value, the flux
     moved between orders < max(1 %, 1 / sqrt(carriers of order 0)) of
     the total, the buckets' sum per ray within 1e-3 of the largest
     (p99), the winding's p95 |dm| < 5e-3; the aux two-pass driver
     bitwise against the single pass, over the kernel and over the plain
     loop;
 15. the polarized, movie (thin and absorbed) and decomposed renders
     through render_polarized_volumetric, render_volumetric_movie and
     render_volumetric_decomposed at 1024^2 (a = 0.9, theta_obs = 80 deg,
     FOV 16 deg, psi = 0; eight frames over one period with spot_amp 8;
     three orders), warm-up and 3 runs each: two kernel launches per
     driver call and no plain loop; the light curve varies over the
     period and is flat with spot_amp 0; the orders sum to the thin image
     within 1e-3 of its peak on 99.9 % of the pixels (fewer than 1e-3 of
     them above it, each placed: an exit lane, the shadow's rim, or by
     its plane crossings) and in total flux within 1e-4 (the two traces
     carry other states and so take other steps) and their flux falls
     with order; pol_frac
     <= p0 and Q even, U odd under the top-bottom mirror at theta_obs =
     90 deg; then 64^2 renders on the card against the CPU, the absorbed
     movie and decomposition too, every order by phase 14's gates;
 16. the peak probe (its FMAs written out as fmaf / fma, which
     -fmad=false leaves fused): the chains against the same recurrence in
     torch
     (k = 64: float32 and float64 within 4 k ulp, sinf within 4 ulp, the
     eight-chain library forms within 4 k ulp of their sum) and the
     card's FP32 FMA (one chain and eight a thread), FP64 FMA, mixed and
     sinf rates from the marginal time between chain lengths 2,048 and
     8,192, and the rates of exp, pow, the IEEE division, sqrt, sin and
     cos in float32 and float64, eight chains a thread, between shorter
     lengths (peak_probe.CHAIN_LENGTHS).
 17. the float64 instances against the plain float64 loop: the Kerr and
     disk kernels on 1,024 of phases 3's and 8's rays, the orbit kernel
     on 1,024 rays and the alpha = 0 lane (Schwarzschild and RN), every
     extras form on phase 11's and 14's 4,096 rays against the float64
     plain runs those phases queued. Gates: statuses > 0.999; p99 |d
     final_alpha| < 1e-6 rad on stable escaped rays (orbit < 1e-8);
     disk median |d r_hits[0]| < 1e-6 M; extras p99 |d| / max < 1e-6
     (tau against max(1, max |tau|)); the orders by phase 14's flux
     gates; and every extras form but Stokes bitwise its plain loop (its
     kernel sums the Levi-Civita contraction in another order; phase 22
     holds the DOP853 ones alike). Then every entry-point family in float64 at
     64^2 on the card against the CPU (render_shadow, render_scene,
     render_shadow_aa, render_disk, render_volumetric, _spectrum, _movie
     thin and absorbed, _decomposed, render_polarized_volumetric): only
     float64 instances launch, no float32 one and no plain loop; shadow
     pixels equal on 99.9 % (with AA too), masks 99.9 %, lensed RMSE
     < 1e-6, median |d image| < 1e-6, Stokes medians < 1e-8 of the peak,
     orders by flux. Then the float32
     kernel against the float64 one on the 1024^2 main-path rays: status
     agreement > 0.99, final-alpha RMSE on rays escaped in both, read
     against the north star's 1e-3 rad, and both times.
 18. the exact-cycle exit: each ray kernel with the exit and with it off
     (`_cycle_exit=False`, which grinds every attempt) on the aligned and
     quarter-offset 1024^2 config-4 disk grids, the 1024^2 Kerr shadow,
     and the volumetric scene's 1024^2 and 256^2 grids for the thin,
     absorbed, jet, 3-band, Stokes, movie and order forms at window
     2,048 (scripts/torch_cycle_census.py): every output bitwise equal
     (state or extras, status, final alpha, half-orbits, flags, per-ray
     attempts, warp step sum), with the lanes counted by kind (exact
     cycle and its period, frozen with a moving lambda, ground without
     freezing) and both times; the 256^2 order lane (171, 129).
 19. the reference's rays and the Kerr kernel's booking: config 4's rays
     (959, 510..512) of the aligned grid end as JAX ends them (escaped,
     no hit, 51, 51 and 17 attempts; with FMA contraction 511 froze), the
     quarter-offset grid's seven lanes that froze with contraction, capped
     at 1,000 attempts, as the plain loop on the CPU ends them (status,
     hits, attempts; two lanes still end otherwise, ROADMAP Queue 3 #1,
     and are printed, not gated), the 256^2 order lane (171, 129)
     captured as in the plain loop (its attempts printed); the in-kernel
     extraction against finalize_angles on the main path's final states
     (statuses, half-orbits and NaN masks equal, final alpha within 1e-6
     rad, 1e-13 in float64); the warp step sum the Kerr kernel books
     (each warp adds its largest attempt count) equal to torch's from the
     per-ray attempts, and its unconverged flags to the raw statuses, on
     the main path's 524,288 rays (float32 and float64) and on the
     aligned and quarter-offset config-4 grids, with the wrapper's time
     (CUDA events).
 20. config 5 (bench.py:168-226): the 2160x3840 Kerr a=0.9 shadow at 4
     jittered samples (aa_offsets(4)) with the mirror fold, 16,604,160
     traced rays, through render_shadow_aa: a warm-up and 3 timed runs
     (best precompute, rays/s as bench.py's kerr_a0.9_4k_aa4_rays_per_sec
     and traced rays/s); the Kerr kernel and its two-pass driver launched,
     the plain loop not; every pixel a coverage k/4, the mirror rows exact
     copies, no pixel with a captured sample beyond 1.01 alpha_crit, every
     fractional pixel beside another value and under 1 % of them; 3
     frames under torch.profiler. Then the 16.6M stacked rays as one
     batch, in pass-sized chunks and in difficulty-sorted chunks: without
     two-pass bitwise equal, with the slowest rays' attempts; with
     two-pass ('auto', on above 2M rays) each call's rays still running
     after pass 1 against the two-pass driver's 8,192 slots, bitwise
     equal where no chunk overflows (where one does, the rays that keep
     their first-pass result and the pixels that change are printed, as
     the JAX semantics allow). The kernel, its driver (first pass 256)
     and the driver over the plain loop on ~42k of the stacked rays, both
     capped at 512 attempts: 4,096 random rays a pass-sized chunk, the 64
     slowest of each pass-sized and each sorted chunk, and three columns
     each side of the polar axis in every row (phase 4's gates on the
     random rays, the columns and the whole sample; on the slowest rays,
     where float32 is chaotic, statuses > 0.99, every exit-ended lane's
     status equal, and the same rays in float64 by phase 17's gates);
     the exit-ended lanes at 200,000 attempts bitwise equal with the
     exit off; the kernel and the driver a pass-sized chunk (CUDA
     events), their own kernels-line entries, and the attempts split by
     |alpha / alpha_crit - 1| against the main path's, with each one's
     ns an attempt and lane efficiency. render_shadow_adaptive at a 5 % budget
     equals the uniform image while no two-pass call overflows and the
     budget covers the edge set. The four AA entry points at 48x64 on
     the card against the CPU, both capped at 4,096 attempts: shadow
     images equal on >= 99 %, lensed (bilinear) RMSE < 1e-3 on pixels of
     winding < 2 (for the adaptive render, on pixels refined on both
     sides or neither).
 21. Kerr-Newman (a = 0.6, Q = 0.6) and Johannsen-Psaltis (a = 0.9,
     eps3 = 2; the JAX repo's chip smoke's scenes) through the Kerr
     kernel's family instances: Johannsen-Psaltis's alpha_crit_traced on
     the card as every JP frame runs it (16 azimuths, 26 iterations;
     the float64 kernel, the whole call's time by CUDA events, its
     launches and attempts) within 1e-9 rad of the same call on the
     CPU's plain loop, which runs in a process of its own through the
     phase; each family's
     instance at full depth on 4,096 random rays in [0.2, 4] alpha_crit,
     1,024 of them in float64 and the 524,288 main-path rays of its
     1024^2 frame (both times, the kernel alone, attempts, lane
     efficiency, slowest ray) against the plain loop by phase 3's gates in float32
     and phase 17's in float64; Kerr-Newman at Q = 0 bitwise the
     Kerr kernel on the main-path rays; the Kerr-Newman disk variant on
     phase 8's kind of rays (phase 8's gates; float64 phase 17's). Then
     the paths at 1024^2, each with its counts set to 0 before it: the
     shadow of each family (warm-up and 3 runs, best rays/s by bench.py's
     rule, 3 frames under torch.profiler), the lensed, AA and adaptive
     renders, and config 4's disk with Q = 0.6 at a = 0.6 (warm-up and 3
     runs): the kernel or its driver launched and no plain loop; the
     Kerr-Newman shadow inside the same-spin Kerr shadow. Then 64^2
     renders on the card against the CPU (shadow in float32 and float64,
     lensed, 4x AA; the charged disk in float32 and float64), both
     sides' Johannsen-Psaltis renders taking the card's alpha_crit.
 22. DOP853 (Hairer's 8(5,3) pair, csrc/kerr_dop853*.cu, built beside
     phases 11 on) and linear event location: the DOP853 library's build
     time and every instance's registers, spills and blocks an SM; every
     DOP853 instance against the plain DOP853 loop on the card, the
     random rays capped at 64 attempts in both: the Kerr shadow on phase
     3's 4,096 random rays with Hermite and linear events (phase 3's
     gates) and 1,024 of them in float64 (phase 17's), the
     1024^2 main-path rays with both capped at 64 attempts (phase 3's),
     the Kerr-Newman and Johannsen-Psaltis instances on phase 21's kinds
     of rays, the disk variant on phase 8's rays (opaque; translucent
     with momenta; float64; Kerr-Newman) and the config-4 grid capped at
     64 (phase 8's gates), the extras forms of phases 11 and 14 (but
     the jet, VolThin's instance again, the 2-band spectrum, on no path,
     and the vertical-field Stokes) on 4,096 random rays capped at 128
     attempts (sat_window 512, which the cap keeps from firing), float32 by
     phases 11 and 14's gates (the plain loop's own float32 gap from its
     float64 run raising a bar as there) and float64 by phase 17's (the
     orders by their flux gates); the DOP853 launch and its DP45 twin
     alone at full depth in turns on the main-path rays, config 4's grid
     and the 1024^2 volumetric scene (thin and 3-band), with attempts a
     ray, lane efficiency and the slowest ray (the main path's traced
     alone in both pairs and dtypes); then the paths at 1024^2 with
     integrator="dop853", each with its counts set to 0 before it and
     read after (only DOP853 instances launch, no DP45 one and no plain
     loop): the Kerr shadow (warm-up and 3 runs, phase 4's image gates
     on its captured rays; its INVALID rays, black pixels too, must end
     INVALID in the plain float32 loop on the card and not in float64: a
     float32 DOP853 step can land within ~4e-5 rad of the polar axis,
     whose next stages overflow until h falls below h_min, ROADMAP
     Queue 3 #8; 3 frames under torch.profiler), the shadow with linear
     events (its
     pixels equal to Hermite's on 99.9 %), lensed, 4x AA and adaptive,
     the Kerr-Newman and Johannsen-Psaltis shadows, config 4's disk
     (warm-up and 3 runs, its Doppler ratio above 2, profiled), the
     volumetric thin, absorbed, 3-band, 8-frame movie (thin and absorbed),
     decomposed and polarized renders; and the 64^2 float64 renders
     (shadow, disk, volumetric thin on the card against the CPU: shadow
     pixels and masks equal on 99.9 %, median |d image| < 1e-6; the other
     families on the card for their float64 launches).
 23. the mu = cos(theta) chart and charged volumetric scenes: each mu
     instance of the Kerr kernel (csrc/kerr_dp45_mu.cu and its f64 and
     DOP853 siblings; Kerr a = 0.9 and Kerr-Newman a = 0.6, Q = 0.6) on
     4,096 random rays in float32 and 1,024 in float64, both capped at
     256 attempts, with the hybrid's poison mask, bitwise equal to the
     plain mu loop on the card (every output and the unconverged flags);
     the CUDA hybrid (trace_rays_kerr_hybrid, the Pallas backend's
     semantics) on config 3's 1024^2 main-path rays and a Kerr-Newman
     frame, capped at 256, bitwise equal to the same driver over the plain
     loop, and (Kerr) equal to the plain hybrid with the XLA semantics on
     every ray its first pass left converged, with its poison and
     re-trace counts and pass A/B times; render_shadow with
     formulation="mu" at 1024^2 (warm-up and 3 runs: best rays/s, the mu
     instance, the theta instance and the hybrid launched, no plain loop)
     held to the theta render by the JAX package's rule (statuses equal
     on > 99 % of the rays, p99 |d final_alpha| < 1e-3 on stable escaped
     rays; pixels equal on > 99 %), and the mu and theta kernels alone
     at full depth on the same work (the main-path rays pass A
     integrates in mu, neither poisoned nor booked) with their warp step
     sums, lane efficiency and both bounds; every Kerr-Newman extras
     instance of a main path (thin, absorbed, 3-band spectral, 8-frame
     movie thin and absorbed, 3 orders thin and absorbed; float32 and
     float64; DP45 and DOP853) on 4,096 random rays capped at 128, its
     inputs built before the timed calls, bitwise equal to its plain loop
     on the card in float32 and float64 (the float64 instances' pow,
     csrc/lpt_pow_f64.cu, is built with contraction, as PyTorch builds
     its own); the 1024^2 charged
     volumetric renders (thin, absorbed, jet, 3-band, 8-frame movie thin
     and absorbed, 3 orders; each with its counts set to 0 before it: the
     extras kernel launched and no plain loop; the movie's spot period
     the charged Keplerian one), each timed; the 64^2 float64 mu shadow
     and charged thin image on the card against the CPU (pixels equal on
     99.9 %; masks 99.9 %, median |d image| < 1e-6). The plain loops and
     the CPU renders run in P23_WORKERS child processes side by side,
     after every timed kernel run of the phase;
 24. the rest of the disk family through the disk kernel: the wide
     instances (5-8 crossing slots, csrc/kerr_dp45_wide.cu and its f64 and
     DOP853 siblings; each pair, dtype, family and momentum) on phase 8's
     4,096 rays, their last 1,024 moved just outside the critical curve
     (bisection on the shadow kernel, then 1 + eps), with the
     decomposition's recorder (every plane crossing): slots 0-3, the
     status, final_alpha and min(n_hits, 4) bitwise the 4-slot instance's,
     then against the plain loop on the card by phase 8's gates on every
     slot (bitwise reported), 9 slots launching the plane recorder (no wide
     launch); the 1024^2 config-4 grid with the decomposition's recorder
     and 6 slots, kernel against the plain loop (in its child), both capped
     at GRID_STEPS: phase 8's gates on every slot, bitwise reported; the
     1024^2 translucent grid with 4, 6 and 8 slots (time, launches,
     attempts a ray); every disk render at 1024^2 through its entry point,
     warm-up and 3 runs (decomposed 3 and 6 orders, 32 frames over an
     orbit, disk AA x4, composite and composite AA x4, line profile, light
     curve of 64 samples, polarization, Q-U loop of 32), the disk kernel
     counted and the plain loop not, each with its rays/s and a frame's
     device time and launches, and the JAX package's own physics checks
     (decomposed total against the translucent trace, periodic frames, the
     opaque composite blocking and the translucent one adding, the stacked
     composite AA equal to its loop, Doppler horns and the flat-law total
     under supersampling, a periodic and beamed light curve, a closed Q-U
     loop); then each mode at 64^2 on the card against the CPU (masks >= 99
     %, median |d| < 1e-3 on disk pixels; 1-D outputs within 1e-3 of their
     largest value, the Q-U loop's Q and U of the largest I, each curve
     read against I's largest value and its own), and the Q-U loop pixel by
     pixel (where the curves part, how far Q cancels, the pixels that carry
     the gap, and how far a loop rotated by chi in place of 2 chi would
     sit: it must exceed 1e-2 of I's largest).
 25. tilted, warped and two-plane disks and crossing times through the
     disk kernel's plane recorder (csrc/kerr_planes.cuh: the instances of
     kerr_dp45_planes.cu and its f64 and DOP853 siblings, Kerr and
     Kerr-Newman), the moving camera and the image-domain observables:
     every instance on phase 24's rays with three plane sets (one tilted
     opaque plane; an equatorial disk and a tilted ring, opaque, with
     crossing times; a warped and a tilted translucent plane with
     crossing times and momenta, 6 slots), both capped at P25_STEPS,
     bitwise its plain loop (in its child) in every output of every
     plane, with ptxas's registers and spills and the blocks an SM holds;
     each set on config 4's 1024^2 grid (float32 DP45 Kerr, what the
     1024^2 renders launch), both capped at GRID_STEPS, bitwise the same
     way; phase 24's plane (kind 0, no crossing times) through the plane
     recorder bitwise the wide instance and timed against it, on that
     grid with 6 slots and on phase 24's rays with its slots;
     the equatorial plane through the plane recorder bitwise the disk
     variant; at 1024^2 through
     the entry points, warm-up and 3 runs, a tilted disk (30 deg, line of
     nodes at 45 deg), a warped one (warp radius 10), the CLI's --disk2,
     a 64-point retarded-time light curve, and a moving camera (boost
     0.5 c forward) on the blackbody disk, the main-path shadow, the
     lens, the volumetric and the spectral renders, each with its
     launches by kernel and no plain loop; the physics checks (a tilt of
     0, one plane and an empty second plane bitwise the untilted render,
     a periodic delayed curve, a bluer moving disk and a smaller moving
     shadow, the Schwarzschild silhouette's first visibility null giving
     2 alpha_crit within 5 %); each mode at 64^2 on the card against the
     CPU (phase 24's gates; the shadow and lens on <= 1 % of pixels).
 26. any width: the broad library's build (at nice 19 beside phases 11
     on) with each broad instance's registers, spills and blocks an SM;
     every broad extras form (spectral, movie thin and absorbed, orders
     thin and absorbed) at the narrow widths (3 bands, 8 frames, 4
     orders) bitwise its compiled instance on phase 8's first 1,024
     rays in every pair, dtype and family, and on the 1024^2 volumetric
     grid (Kerr, DP45, float32, one launch capped at 4,096) timed
     against it in turns; volumetric --movie 16 --centroid at 1024^2
     through the CLI, a 1024^2 render of three translucent planes and
     the 9-order disk decomposition, each with its launches (the broad
     extras, the broad plane recorder, the plane recorder) and no plain
     loop; every broad instance (40: 2 pairs x 2 dtypes x 2 families x
     5 forms, as 6 wide cases: 12 and 40 bands with the saturation exit
     on, 16 frames thin and absorbed, 6 orders thin and absorbed) on the
     1,024 rays against the plain loop on the card, bitwise (orders by
     the order gate where a plain bucket flips), capped at 64 with a
     saturation window of 16 (some ray must end by it); the 12-slot
     equatorial plane and three planes (equatorial, tilted, warped;
     crossing times) on phase 24's Kerr rays, capped at 200, bitwise
     their plain loop, DP45 and DOP853, float32 and float64; each broad
     instance timed alone on the quiet card, the disk checks in turns
     against the instance each extends (8 slots through the wide
     instance, the first two planes through the plane recorder).
 27. the surface kernel and the lens-map products: the surface library's
     build (at nice 19 beside phases 11 on) with its instances'
     registers and spills; every surface instance (24: 2 pairs x 2
     dtypes x 3 families, Kerr a 0.9, Kerr-Newman a 0 Q 0.6 and
     Johannsen-Psaltis, x with and without the time component) on 4,096
     random rays, capped at 2,000, bitwise its plain loop on the card;
     the map modes' 512^2 grid (float32, and float64 with the time
     component), capped at 512, bitwise its plain loop; each mode of
     the `shadow --rings` / `lens` CLI (the ring layers of a shadow and
     of a lensed render, magnification, caustics, microlens, arrival
     time in float32 and float64, shear, find-images) at 64^2 on the
     card against the CPU (float32 maps p99 |d| < 1e-3 of the largest,
     magnification and shear on pixels with a finite 3x3 neighbourhood;
     float64 1e-9; the ring masks on >= 99 %; the same images), then at
     the CLI's 512^2 through its entry point, best of 3 frames after a
     warm-up, with its launches (the Kerr kernel for the ring layers and
     magnification, the surface kernel for the rest) and no plain loop,
     then once through the CLI itself (its files written, its launches,
     no plain loop), and the caustics frame under torch.profiler; each instance on a
     path of its own (find-images and the float32 arrival-time map at
     512^2 for each pair and family);
 28. run-time (M, a, r_obs) (dynamic_params): the theta and mu
     instances with (M, a) = (1, 0.99) and with (M, a, r_obs) = (1, 0.9,
     73.5) on phase 8's 4,096 rays, capped at 500, bitwise their plain
     loop on the card; the 1024^2 flyby frame (20 M, 0.5 c) through the
     hybrid, capped at 512, bitwise the same driver over the plain loop,
     with its passes alone; a dynamic (M, a) = (1, 0.9) frame against the
     static shadow with the mirror fold off (pixels equal on > 99 %,
     JAX's bar); each mode (pan, spin, flyby shadow and lensed frames,
     the panoramas at a 0.9 and 0, the star and its pulse profile) at 64^2
     on the card against the CPU (p28_check); then through the CLI a user
     runs, each with its counts zeroed just before and read just after:
     `animate` an 8-frame 1024^2 pan of 2 deg across the hole's column
     (Kerr a 0.9) and an 8-frame flyby 200 M -> 20 M with the boost
     ramped to 0.5 c (every frame's launches and ms, the PNG frames, the
     launches the same on every frame), `pano --grid-sky --height 1024`
     at a 0.9 (the Kerr kernel) and a 0 (the orbit kernel), `star --size
     1024`, `star --pulse-profile 64 --light-travel-delay` at 128^2; the
     spin sweep a = 0, 0.5, 0.9, 0.99 at 1024^2 through
     render_param_sequence; a flyby frame under torch.profiler.
 29. the paths that run no kernel of their own, plain PyTorch on the
     card with their blocks of steps replayed as CUDA graphs
     (ops/graphs.py): through the CLI, with the counts zeroed just
     before and read just after, `ray --no-plot` and `plot` (its ten
     default angles: the Kerr kernel at a = 0.9, the orbit kernel at
     a = 0; whether matplotlib drew the figure is printed), `orbit
     --no-plot --npz` at its defaults (peri 8, apo 16, 6,000 steps) for
     a = 0 and 0.9 and `shadow --integrator rk4 --a 0.9 --size 1024`
     (these two in children on the card, queued at phase 23);
     the ten angles in float64 through trace_ray (the kernels) and
     trace_ray_trajectories on Kerr a 0.9 and Schwarzschild against the
     same calls on the CPU (equal outcomes and windings; final alpha
     within 1e-6 rad and the recorded paths within 1e-7 of their
     scale, with equal sample counts, on the rays outside 0.9-1.1
     alpha_crit, whose float64 sin / cos ulps grow as e^(pi winding)
     near the critical curve, printed for the rest); each orbit's
     precession equal to the CPU's within 1e-8 rad and the Schwarzschild
     advance within 2e-3 of the exact radial quadrature; the RK4 1024^2
     frame against the DP45 kernel's by tests/test_integrators.py's bars
     (status agreement >= 95 % away from alpha_crit, median |d alpha| <
     5e-3, p90 < 3e-2), its time, iterations and device kernels an
     iteration (torch.profiler); `shadow --metric-py
     examples/user_metric_torch.py:hayward --size 512` and
     `:rotating_hayward --a 0.9 --size 512` (in a child on the card,
     queued at phase 23: each bisects its alpha_crit on the plain loop),
     the 512^2 frames' traces, and the closure identity
     CustomMetric(kerr_covariant(1, 0.9)) at 512^2 against the Kerr
     kernel (phase 3's gates), each also at 64^2 against the CPU (masks
     >= 99 %, final alpha p99 < 1e-3 rad where finite in both); the fit
     (in a child on the card): fit_scene_params from a = 0.35 to 0.7 on
     the 32 x 32 fan of tests/test_diff.py's fit (r_obs 20, theta_obs 80
     deg, n_steps 1024) within 1e-4, d(mean alpha)/da by autograd within
     1e-4 relative of a central difference.
 30. the render server (serve.py): make_server("127.0.0.1", 0,
     RenderService(device="cuda")) on a thread; /healthz (devices 1,
     platform "gpu"); each mode at its published width, cold then warm
     as npy and then as PNG, its counts zeroed just before each request
     and read just after: the 1024^2 Kerr a 0.9 shadow (config 3: the
     Kerr kernel), the 512^2 Schwarzschild lens with a seeded 512^2 PNG
     background as image_b64 (config 2: the orbit kernel), the 1024^2
     disk (config 4: the disk kernel and its driver), the 1024^2 thin
     volumetric (a 0.9, theta_obs 80 deg, FOV 16 deg: the extras kernel
     and its driver), the 512^2 caustics map and the 1024^2 star (the
     surface kernel); each npy body bitwise the direct call on the card
     (caustics, whose index_add_ atomics sum in no fixed order: bitwise
     or within 1e-5 of each bin), its kernels launched and no plain
     loop; the shadow's PNG reply the npy reply's encoding; 400 for a
     bad mode and a custom_metric; with the render lock held, a
     deadline_s of 0.2 gets 503, /healthz answers within 1 s, and a
     request beyond max_queue gets 503 with Retry-After; the offline
     `request` CLI's bytes equal to the HTTP body; then
     checkpoint.cached_precompute on the shadow's scene (a miss, then a
     hit, the tables bitwise), a chunked precompute (65,536-ray chunks)
     stopped by a raising put after 3 chunks and resumed (3 chunks read
     back, 5 traced, bitwise the fresh run, no chunk file left), and the
     chunked trace with progress="live" bitwise the fresh run. Each
     request's seconds, X-Render-Seconds and launches are printed, with
     the direct call's seconds and the encodings'. No CPU render: the
     earlier phases hold these pipelines against the CPU.
The plain loops of phases 11-15, 17, 19-22 and 24-29 and their CPU
renders run in PLAIN_WORKERS child processes (PlainPool), queued at the
start of phase 11 (phases 11-15) and of phases 17, 18 (phase 19's
quarter-offset lanes), 21, 22, 23 (also phase 29's), 24 (also phase
27's), 25 and 26 (also phase 28's), and when phase 20 has drawn its
sample, while
the
parent runs its kernels; the plain_ms of those phases is the call's time
in its child, beside the other children's work on the card. A kernel
time that cuda_ms takes while a child has a call on the card is taken
again for the kernels line by the same call once the pool is closed
(retime_entries: "ms" the quiet time, "ms_beside_plain_loops" the
first).
Each path's launch counters are set to 0 just before it and read just
after (float32 and float64 instances count apart: `.launches`,
`.launches_f64`; the DOP853 instances on `.launches_dop853` and
`.launches_dop853_f64`). The second-to-last line is a JSON object of per-kernel
results: beside each kernel's time stand its flops-only bound `bound_ms`
(the larger of its flops over the H100's published 67 TFLOP/s float32
rate, 34 TFLOP/s for the float64 instances, and its bytes over 3.35
TB/s, from this run's per-ray attempt counts and the flops per attempt
counted from the CUDA sources with the library functions left out), the
counted bound `bound_counted_ms` (every operation of an attempt by kind,
`ops`, each at the rate phase 16 measured for it, a flop at no less than
half the published peak, ops/cuda/bounds.py), the slowest ray's attempts
with the time that ray takes when traced alone, and for the extras
kernel the instance it launched with its registers, spills (bytes, from
ptxas's report of the loaded library's build; null where that build kept
none), blocks an SM and block bound. The config-5 entries
(kerr_dp45_config5, trace_rays_kerr_two_pass_config5) time a launch on
a pass-sized chunk; their plain_ms is the plain loop's on phase 20's
sample (plain_rays, plain_max_steps), and their bounds count the
attempts of every ray but the exit-ended lanes, which the exit books at
200,000 without making them (attempts_booked counts them too). Phase
21's entries (kerr_dp45_kn, kerr_dp45_jp, trace_disk_rays_kn and their
_f64 twins) count their launches on its paths (the float64 ones on the
64^2 float64 renders) and their bounds with each family's operations
(bounds.kerr_work); alpha_crit_jp_f64 is the bisection as the 1024^2
JP shadow path runs it: its float64 launches there, the whole call's
time, the CPU's plain loop on the same call as plain_ms (plain_on
"cpu"), its bound from the attempts of all its launches. Phase 22's
entries (kerr_dop853*, trace_disk_rays_dop853*, kerr_dop853_extras_*,
float64 twins *_f64) count their launches on its 1024^2 paths (the
float64 ones on the 64^2 float64 renders) and their bounds with
bounds.kerr_work / extras_work(method="dop853"); the main path's and
config 4's entries time both versions capped at 64 attempts and carry
the full-depth launch beside its DP45 twin (`full_depth`). Phase 23's
entries (kerr_dp45_mu, kerr_dop853_mu and their _kn and _f64 twins,
kerr_dp45_extras_kn_* and kerr_dop853_extras_kn_* for each main-path
form and dtype, trace_rays_kerr_hybrid) count their launches on the path
that runs each (the float32 mu and charged paths at 1024^2 and 256^2,
the float64 ones at 64^2; mu with integrator="dop853" where the pair is
DOP853), time the kernel on (a) and (d)'s random rays against the plain
loop's time in its child process, and carry bitwise_plain; the
kerr_dp45_mu entry also the mu and theta kernels alone at full depth on
the same main-path rays with both bounds and their ratios. Phase 24's
entry (kerr_dp45_disk_wide) counts the wide instance's launches on its
renders and times it on the random rays (float32 DP45, Kerr, momenta)
against the plain loop in its child. Phase 25's entry
(kerr_dp45_planes) counts the plane recorder's launches on its renders,
times the float32 DP45 Kerr instance on the translucent set against its
plain loop in its child, bounds it with the probe's attempts, accepted
attempts and recorded crossings (bounds.planes_work), and carries every
instance's time, plain time and bitwise result and their ptxas figures.
Phase 26's entries: kerr_dp45_broad (the broad movie thin, Kerr, DP45,
float32: the launches of the --movie 16 path, its time and plain time
on the 1,024 rays, its bound from bounds.broad_work and the probe's
attempts, bound_state_ms the wide state's memory traffic alone; every
instance's time, plain time and bitwise result, the 1024^2 width-8
ratios, the resources and the paths), kerr_dp45_broad_planes (the
three-plane recorder, DP45 float32, with the three-plane render's
launches; bounded as phase 25's entry). Phase 27's entries
(kerr_surface_<pair>_<dtype>_<family>[_time], one an instance) count
their launches on the instance's own paths, time the instance on the
4,096 rays (the float32 and the float64-with-time Kerr DP45 ones on the
512^2 grid) against the plain loop in its child, and bound it with the
probe's attempts (bounds.surface_work). Phase 28's entries
(kerr_dp45_dynamic, kerr_dp45_mu_dynamic: the theta and mu instances
with run-time parameters; trace_rays_kerr_hybrid_dynamic: the driver)
count their launches on the flyby and spin-sweep paths (the dynamic_
counters), time each instance alone on the 4,096 rays with (M, a,
r_obs) (m_a_ms: with (M, a); static_twin_ms: the static Kerr(1, 0.99)
instance on the same rays, in turns) and the driver on the 1024^2 flyby
frame, against the plain loop in its child. Phase 29 adds no entry: its
paths launch no kernel of their own (the ray and plot paths' launches of
the Kerr and orbit kernels are counted and required there); nor does
phase 30: its requests launch the kernels of the earlier entries
(counted and required there).
The last line is {"ok": true,
"device": {...}}. Exit code 0 iff every phase
passed; without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from light_path_tracer_tpu_torch.ops.cuda import bounds  # noqa: E402
from light_path_tracer_tpu_torch.ops.cuda.bounds import (  # noqa: E402
    extras_work, kerr_work, orbit_work)

R_OBS = 100.0
LAMBDA_MAX = 5000.0
GATE_STEPS = 20000
KERNEL_SOURCE = "light_path_tracer_tpu_torch/csrc/kerr_dp45.cu"
REPLACES = "light_path_tracer_tpu/ops/pallas/kerr_trace_kernel.py:40"
ORBIT_SOURCE = "light_path_tracer_tpu_torch/csrc/schwarzschild_rk4.cu"
ORBIT_REPLACES = ("light_path_tracer_tpu/ops/pallas/"
                  "schwarzschild_kernel.py:30")
DRIVER_SOURCE = "light_path_tracer_tpu_torch/ops/cuda/kerr_trace_kernel.py"
JAX_KERNELS = "light_path_tracer_tpu/ops/pallas/kerr_trace_kernel.py"
THETA_DISK = float(np.radians(80.0))


class SmokeFailure(Exception):
    pass


def require(ok, what):
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


class LateMs(float):
    """A time that cuda_ms took while PlainPool children had plain loops
    on the card: the milliseconds, with the call and its repeats, so that
    kernel_entry can have the call timed again once the card is quiet
    (retime_entries)."""

    def __new__(cls, ms, fn, repeats):
        obj = super().__new__(cls, ms)
        obj.fn, obj.repeats = fn, repeats
        return obj


def _frozen(fn):
    """fn with the values its free variables hold now (a lambda made in a
    loop reads the loop's variables when it runs, not when it was made)."""
    import types
    if not getattr(fn, "__closure__", None):
        return fn
    cells = []
    for cell in fn.__closure__:
        try:
            cells.append(types.CellType(cell.cell_contents))
        except ValueError:                     # a variable not yet bound
            cells.append(cell)
    out = types.FunctionType(fn.__code__, fn.__globals__, fn.__name__,
                             fn.__defaults__, tuple(cells))
    out.__kwdefaults__ = fn.__kwdefaults__
    return out


def cuda_ms(fn, repeats):
    """Mean device time of fn() over `repeats` calls, by CUDA events; a
    LateMs when PlainPool children have plain loops on the card."""
    import torch
    beside = PlainPool.card_busy()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / repeats
    return (LateMs(ms, _frozen(fn), repeats) if beside else ms), out


# Cycles of the spin kernel queued ahead of a timed launch (~5 ms at the
# H100's 1.98 GHz), and the most that kernel_alone_ms spins.
SPIN_CYCLES = 10_000_000
SPIN_MAX = 640_000_000


def kernel_alone_ms(fn, repeats):
    """Mean device time of fn()'s own device work (one kernel launch and
    its wrapper's fills), by CUDA events: a spin kernel (torch.cuda._sleep)
    queued ahead of each call keeps the stream busy while the host
    prepares the launch, so the events bracket the work and not the
    host's dispatch. A call whose start event had already passed when fn
    returned on the host is timed again with a spin four times longer.
    (torch.profiler on the card can drop a launch's record.)"""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    spin, total, done = SPIN_CYCLES, 0.0, 0
    while done < repeats:
        torch.cuda.synchronize()
        torch.cuda._sleep(spin)
        start.record()
        fn()
        stop.record()
        hidden = not start.query()
        torch.cuda.synchronize()
        if hidden:
            total += start.elapsed_time(stop)
            done += 1
        else:
            require(spin < SPIN_MAX, "kernel_alone_ms: the host's dispatch "
                    f"outlasts a spin of {spin} cycles")
            spin *= 4
    return total / repeats


def kerr_launches():
    """Launches of the Kerr kernel's shadow and disk variants counted by
    their wrappers, both dtypes: the records torch.profiler names
    kerr_dp45_kernel."""
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    return sum(f.launches + f.launches_f64 for f in (
        kk.trace_rays_kerr_cuda, kk.trace_disk_rays_cuda))


def device_profile(fn, reps, key="", count=None, tries=3):
    """Per call of fn, over `reps` calls after a warm-up (itself under the
    profiler, so that no profile carries the profiler's start), by
    torch.profiler: the wall ms (host clock, the profiler included), the
    device ms of every device activity, the kernel launches (copies and fills left out), the
    device's busy share of the wall time, and the launches of the kernels
    whose name holds `key` with their mean device ms a launch.
    count: a function returning the launches the wrappers counted of the
    kernels `key` names. torch.profiler on the card can drop a launch's
    record, and a dropped record leaves its time out of device_ms, so the
    profile is taken again, up to `tries` times, until it keeps as many
    `key` records as the wrappers counted ("complete"; without `count`,
    at least one). Where it never does, busy is None (not measured); the
    kernel's mean is over the records it kept, and None if it kept
    none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):
        fn()       # the warm-up; a process's first session starts CUPTI
    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        counted = count() if count else 0
        start = time.perf_counter()
        with profile(activities=activities) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3 / reps
        counted = count() - counted if count else None
        device_us = key_us = 0.0
        launches = key_launches = 0
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", 0.0) or getattr(
                ev, "cuda_time_total", 0.0)
            if ev.device_type.name != "CUDA" or us <= 0.0:
                continue
            device_us += us
            if "Memcpy" in ev.key or "Memset" in ev.key:
                continue
            launches += ev.count
            if key and key in ev.key:
                key_us += us
                key_launches += ev.count
        complete = (key_launches == counted if count
                    else key_launches > 0 or not key)
        if complete:
            break
    device_ms = device_us / 1e3 / reps
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                launches=launches / reps,
                busy=device_ms / wall_ms if complete else None,
                kernel_ms=(key_us / 1e3 / key_launches if key_launches
                           else None),
                kernel_launches=key_launches / reps,
                counted_launches=None if counted is None else counted / reps,
                complete=complete, tries=attempt)


# The child processes that run the plain loops of phases 11-15, 17, 21,
# 22 and 24 (and their CPU renders) beside the parent: the plain loop is
# host-bound, one process a core; two of the card's host's 8 cores stay
# with the parent and the libraries that build at nice 19.
PLAIN_WORKERS = 6


def _moved(x, device):
    """x with every tensor in it (nested in tuples, named tuples, lists
    and dicts) moved to `device`."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_moved(v, device) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_moved(v, device) for v in x)
    if isinstance(x, dict):
        return {k: _moved(v, device) for k, v in x.items()}
    return x


def _plain_init():
    import torch
    torch.set_num_threads(1)
    if torch.cuda.is_available():
        torch.cuda.set_device(0)


def _sync():
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _plain_job(name, args, kw, device):
    """In a child of PlainPool: `name` (a function of this file, or
    "module:function") called with the arguments' tensors moved to
    `device`; returns (seconds of the call, synchronised, outputs with
    their tensors on the CPU)."""
    import importlib
    if ":" in name:
        module, _, attr = name.partition(":")
        fn = getattr(importlib.import_module(module), attr)
    else:
        fn = globals()[name]
    args, kw = _moved(args, device), _moved(kw, device)
    _sync()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    _sync()
    return time.perf_counter() - t0, _moved(out, "cpu")


class PlainPool:
    """PLAIN_WORKERS child processes (spawned, one thread each) that run
    plain-loop calls on the card, or CPU renders, while the parent times
    its kernels: submit() queues a call with its arguments' tensors copied
    to the CPU and returns a job; result(job, dev) waits and returns (the
    call's milliseconds in its child, its outputs on `dev`). The
    arguments travel by pickle, so a call names its transfer functions by
    what builds them. close() ends every child."""

    started = []

    def __init__(self, workers=PLAIN_WORKERS):
        import concurrent.futures
        import multiprocessing
        self.pool = concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"),
            initializer=_plain_init)
        self.card_jobs = []
        PlainPool.started.append(self)

    def submit(self, name, *args, on="cuda", **kw):
        """Queue name(*args, **kw) with the tensors on `on` ("cuda", or
        "cpu" for a CPU render)."""
        job = self.pool.submit(_plain_job, name, _moved(args, "cpu"),
                               _moved(kw, "cpu"), on)
        if on != "cpu":
            self.card_jobs.append(job)
        return job

    @classmethod
    def card_busy(cls):
        """Whether a child runs, or has queued, a call on the card."""
        return any(not job.done() for pool in cls.started
                   for job in pool.card_jobs)

    @staticmethod
    def result(job, dev):
        seconds, out = job.result()
        return seconds * 1e3, _moved(out, dev)

    def close(self):
        procs = list((self.pool._processes or {}).values())
        self.pool.shutdown(wait=False, cancel_futures=True)
        for proc in procs:
            if proc.is_alive():
                proc.kill()
            proc.join()

    @classmethod
    def stop_all(cls):
        for pool in cls.started:
            pool.close()


def plain_job(pool, kind, metric, *args, **kw):
    """Queue the plain loop of both_versions (kind "kerr"), disk_both
    ("disk") or orbit_both ("orbit") on the same arguments to `pool`."""
    name = {"kerr": "kerr_trace_kernel:trace_rays_kerr_plain",
            "disk": "kerr_trace_kernel:trace_disk_rays_plain",
            "orbit": "schwarzschild_kernel:trace_rays_schwarzschild_plain"}
    lead = ((R_OBS,) + args[:2] + (np.pi / 2,) + args[2:3]
            + (LAMBDA_MAX,) + args[3:] if kind == "kerr"
            else (R_OBS,) + args[:2] + (THETA_DISK, LAMBDA_MAX) + args[2:]
            if kind == "disk" else (R_OBS,) + args)
    return pool.submit("light_path_tracer_tpu_torch.ops.cuda." + name[kind],
                       metric, *lead, **kw)


def compare(rk, rp, alphas, ac):
    """Kernel result rk against plain result rp on the same rays: status
    agreement, and |d final_alpha| on stable escaped rays (escaped in
    both, |alpha - alpha_crit| > 0.05 alpha_crit)."""
    sk, sp = rk.status.cpu().numpy(), rp.status.cpu().numpy()
    fk, fp = rk.final_alpha.cpu().numpy(), rp.final_alpha.cpu().numpy()
    al = alphas.cpu().numpy().astype(np.float64)
    stable = (sk == 1) & (sp == 1) & (np.abs(al - ac) > 0.05 * ac)
    d = np.abs(fk[stable] - fp[stable]).astype(np.float64)
    return dict(status_agree=float((sk == sp).mean()),
                mask_agree=float((np.isnan(fk) == np.isnan(fp)).mean()),
                p99=float(np.percentile(d, 99)) if d.size else 0.0,
                max_abs=float(d.max()) if d.size else 0.0,
                stable=int(stable.sum()), captured=int((sk == -1).sum()))


def both_versions(label, metric, alphas, thetas, refine, max_steps,
                  kernel_repeats, job=None, **kw):
    """Run kernel and plain version on the same CUDA rays; print both.
    kw (method, event_interp) goes to both; job: the plain run queued to
    a PlainPool (plain_job's), else it runs here."""
    import torch
    from light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel import (
        trace_rays_kerr_cuda, trace_rays_kerr_plain)
    args = (metric, R_OBS, alphas, thetas, np.pi / 2, refine, LAMBDA_MAX,
            max_steps)
    ms, rk = cuda_ms(lambda: trace_rays_kerr_cuda(*args, **kw),
                     kernel_repeats)
    plain_ms, rp = (PlainPool.result(job, alphas.device) if job is not None
                    else cuda_ms(lambda: trace_rays_kerr_plain(*args, **kw),
                                 1))
    cmp = compare(rk, rp, alphas, metric.alpha_crit(R_OBS))
    probe = {}
    trace_rays_kerr_cuda(*args, probe=probe, **kw)
    cmp.update(attempts_stats(probe["attempts"], lambda i: (
        trace_rays_kerr_cuda(metric, R_OBS, alphas[i:i + 1],
                             thetas[i:i + 1], np.pi / 2, refine[i:i + 1],
                             LAMBDA_MAX, max_steps, **kw))))
    cmp.update(ms=ms, plain_ms=plain_ms, n=int(alphas.numel()),
               n_steps_kernel=int(rk.n_steps), n_steps_plain=int(rp.n_steps))
    # The kernel alone (device time) beside the wrapper, and how busy its
    # lanes were: attempts over 32 x the warp step sum.
    cmp["kernel_ms"] = kernel_alone_ms(lambda: trace_rays_kerr_cuda(
        *args, **kw), kernel_repeats)
    cmp["attempts_mean"] = cmp["attempts_sum"] / cmp["n"]
    cmp["lane_efficiency"] = cmp["attempts_sum"] / (32 * cmp["n_steps_kernel"])
    print(f"  {label}: {json.dumps(cmp)}", flush=True)
    torch.cuda.synchronize()
    cmp["attempts"] = probe["attempts"]
    return cmp


def orbit_both(label, metric, alphas, kernel_repeats, job=None):
    """Orbit kernel and plain version on the same CUDA rays; print both,
    with the kernel's per-ray step statistics; job: the plain run queued
    to a PlainPool, else it runs here."""
    import torch
    from light_path_tracer_tpu_torch.ops.cuda.schwarzschild_kernel import (
        trace_rays_schwarzschild_cuda, trace_rays_schwarzschild_plain)
    ms, rk = cuda_ms(lambda: trace_rays_schwarzschild_cuda(
        metric, R_OBS, alphas), kernel_repeats)
    plain_ms, rp = (PlainPool.result(job, alphas.device) if job is not None
                    else cuda_ms(lambda: trace_rays_schwarzschild_plain(
                        metric, R_OBS, alphas), 1))
    _, steps = trace_rays_schwarzschild_cuda(metric, R_OBS, alphas,
                                             return_steps=True)
    st = steps.cpu().numpy()
    cmp = compare(rk, rp, alphas, metric.alpha_crit(R_OBS))
    warps = np.pad(st, (0, -st.size % 32)).reshape(-1, 32).max(axis=1)
    cmp.update(attempts_stats(steps, lambda i: (
        trace_rays_schwarzschild_cuda(metric, R_OBS, alphas[i:i + 1]))))
    cmp.update(ms=ms, plain_ms=plain_ms, n=int(alphas.numel()),
               n_steps_kernel=int(rk.n_steps), n_steps_plain=int(rp.n_steps),
               steps_mean=float(st.mean()), steps_max=int(st.max()),
               lane_efficiency=float(st.sum() / (32.0 * warps.sum())))
    print(f"  {label}: {json.dumps(cmp)}", flush=True)
    torch.cuda.synchronize()
    return cmp, rk


def disk_compare(rk, rp):
    """Disk kernel result rk against plain result rp on the same rays:
    status and n_hits agreement, |d r_hits[0]| on rays hit in both, and
    |d final_alpha| on rays escaped with no hit in both."""
    sk, sp = rk.status.cpu().numpy(), rp.status.cpu().numpy()
    nk, npl = rk.n_hits.cpu().numpy(), rp.n_hits.cpu().numpy()
    both = (nk > 0) & (npl > 0)
    d = np.abs(rk.r_hits[0].cpu().numpy()[both]
               - rp.r_hits[0].cpu().numpy()[both]).astype(np.float64)
    fk, fp = rk.final_alpha.cpu().numpy(), rp.final_alpha.cpu().numpy()
    free = (nk == 0) & (npl == 0) & np.isfinite(fk) & np.isfinite(fp)
    dfa = np.abs(fk[free] - fp[free]).astype(np.float64)
    return dict(status_agree=float((sk == sp).mean()),
                nhits_agree=float((nk == npl).mean()),
                hit=int(both.sum()), two_hits=int((nk >= 2).sum()),
                median_dr=float(np.median(d)) if d.size else 0.0,
                p99_dr=float(np.percentile(d, 99)) if d.size else 0.0,
                max_dr=float(d.max()) if d.size else 0.0,
                free=int(free.sum()),
                median_dfa=float(np.median(dfa)) if dfa.size else 0.0)


def disk_both(label, metric, alphas, thetas, max_steps, plane, max_hits,
              kernel_repeats, record_momentum=False, method="dp45",
              job=None):
    """Disk kernel and plain version on the same CUDA rays; print both,
    and require the phase-8 gates; job: the plain run queued to a
    PlainPool (plain_job's), else it runs here."""
    import torch
    from light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel import (
        trace_disk_rays_cuda, trace_disk_rays_plain)
    args = (metric, R_OBS, alphas, thetas, THETA_DISK, LAMBDA_MAX,
            max_steps, plane, max_hits)
    kw = dict(record_momentum=record_momentum, method=method)
    ms, rk = cuda_ms(lambda: trace_disk_rays_cuda(*args, **kw),
                     kernel_repeats)
    plain_ms, rp = (PlainPool.result(job, alphas.device) if job is not None
                    else cuda_ms(lambda: trace_disk_rays_plain(*args, **kw),
                                 1))
    cmp = disk_compare(rk, rp)
    if record_momentum:
        both = ((rk.n_hits > 0) & (rp.n_hits > 0)).cpu()
        cmp["median_dpr"] = float(
            (rk.pr_hits[0].cpu() - rp.pr_hits[0].cpu()).abs()[both]
            .median())
    probe = {}
    trace_disk_rays_cuda(*args, probe=probe, **kw)
    cmp.update(attempts_stats(probe["attempts"], lambda i: (
        trace_disk_rays_cuda(metric, R_OBS, alphas[i:i + 1],
                             thetas[i:i + 1], *args[4:], **kw))))
    cmp.update(ms=ms, plain_ms=plain_ms, n=int(alphas.numel()),
               n_steps_kernel=int(rk.n_steps), n_steps_plain=int(rp.n_steps))
    print(f"  {label}: {json.dumps(cmp)}", flush=True)
    torch.cuda.synchronize()
    require(cmp["status_agree"] > 0.99 and cmp["nhits_agree"] > 0.99
            and cmp["median_dr"] < 1e-3 and cmp["p99_dr"] < 0.1
            and cmp["median_dfa"] < 1e-4, f"{label} gate: {cmp}")
    cmp["attempts"] = probe["attempts"]
    return cmp


def same_bits(a, b):
    """Bitwise equality of two float or int tensors (NaN == NaN)."""
    import torch
    if a.dtype.is_floating_point:
        view = torch.int64 if a.dtype == torch.float64 else torch.int32
        a, b = a.view(view), b.view(view)
    return bool(torch.equal(a, b))


def disk_bitwise(r1, r2):
    fields = [(r1.status, r2.status), (r1.n_hits, r2.n_hits),
              (r1.final_alpha, r2.final_alpha)]
    fields += list(zip(r1.r_hits, r2.r_hits)) + list(zip(r1.phi_hits,
                                                         r2.phi_hits))
    return all(same_bits(a, b) for a, b in fields)


def kernel_label(mangled):
    """A short name for a kernel instance in ptxas's report."""
    import re
    real = {"f": "float", "d": "double"}
    m = re.search(r"kerr_(dp45|dop853)_kernelI([fd])Li(\d)ELb(\d)ELi(\d)"
                  r"ELb(\d)E(?:Lb(\d)E)?", mangled)
    if m:
        # the mu chart's instances (csrc/kerr_dp45_mu.cu) carry ",mu=1"
        mu = ",mu=1" if m.group(7) == "1" else ""
        return (f"kerr_{m.group(1)}<{real[m.group(2)]},family={m.group(3)},"
                f"disk={m.group(4)},hits={m.group(5)},"
                f"momentum={m.group(6)}{mu}>")
    m = re.search(r"kerr_(dp45|dop853)_planes(_list)?_kernelI([fd])Li(\d)E",
                  mangled)
    if m:
        # the broad plane recorder's kernel (any number of planes)
        return (f"kerr_{m.group(1)}_planes{m.group(2) or ''}"
                f"<{real[m.group(3)]},family={m.group(4)}>")
    m = re.search(r"kerr_(dp45|dop853)_broad_kernelINS_\d+(Broad[A-Za-z]+)I"
                  r"(\w*?)([fd])EE[fd]Li(\d)E", mangled)
    if m:
        args = ["absorbing=" + v for v in re.findall(r"Lb(\d)E",
                                                      m.group(3))]
        args.append(real[m.group(4)])
        kn = "_kn" if m.group(5) == "1" else ""
        return (f"kerr_{m.group(1)}_broad{kn}<{m.group(2)}"
                f"<{','.join(args)}>>")
    m = re.search(r"kerr_(dp45|dop853)_extras_kernelINS_\d+([A-Za-z]+)I"
                  r"(\w*?)([fd])EE", mangled)
    if m:
        args = [v if k == "i" else ("absorbing=" + v)
                for k, v in re.findall(r"L([ib])(\d+)E", m.group(3))]
        args.append(real[m.group(4)])
        # the Kerr-Newman instances (csrc/*_kn.cu): family 1
        fam = re.search(r"EE[fd]Li(\d)E", mangled[m.start(3):])
        kn = "_kn" if fam and fam.group(1) == "1" else ""
        return (f"kerr_{m.group(1)}_extras{kn}<{m.group(2)}"
                f"<{','.join(args)}>>")
    m = re.search(r"kerr_(dp45|dop853)_surface_kernelI([fd])Li(\d)ELb(\d)E",
                  mangled)
    if m:
        return (f"kerr_{m.group(1)}_surface<{real[m.group(2)]},"
                f"family={m.group(3)},time={m.group(4)}>")
    m = re.search(r"orbit_rk4_kernelILb(\d)E([fd])", mangled)
    if m:
        return f"orbit_rk4<charged={m.group(1)},{real[m.group(2)]}>"
    m = re.search(r"\d+(fma8?_chain_kernel|mix_chain_kernel|"
                  r"sin_chain_kernel)(I[fd])?", mangled)
    if m:
        kind = {"If": "<float>", "Id": "<double>", None: ""}[m.group(2)]
        return f"peak_probe::{m.group(1)}{kind}"
    m = re.search(r"op8_chain_kernelINS_\d+(\w+?)StepE([fd])", mangled)
    if m:
        return (f"peak_probe::op8_chain_kernel<{m.group(1)},"
                f"{real[m.group(2)]}>")
    return mangled


def extras_resources(report, method="dp45", families=("", "_kn")):
    """Fill RESOURCES for every extras instance of the pair and of
    `families` ("" Kerr, "_kn" Kerr-Newman): what the
    runtime reports for the card (volumetric_kernel.describe_instance:
    registers, local memory, blocks an SM) and ptxas's spills (report:
    ptxas_report's rows of the loaded library's build; the spill fields
    are None where that build left no report); fails if an instance is
    missing or no block fits an SM."""
    import re
    from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk
    ptx = {name: spill for name, _regs, spill in report}
    for label, entry, form, variant, dtype in [
            x for fam in families for x in vk.extras_instances(method, fam)]:
        require(label in ptx or not ptx, f"ptxas reported no {label}")
        d = vk.describe_instance(entry, form, variant, dtype, method)
        nums = dict((k, int(v)) for v, k in re.findall(
            r"(\d+) bytes (stack frame|spill stores|spill loads)",
            ptx.get(label, "")))
        require(d["blocks_per_sm"] > 0, f"{label}: {d}")
        RESOURCES[label] = dict(
            registers=d["registers"],
            spill_stores=nums.get("spill stores"),
            spill_loads=nums.get("spill loads"),
            stack_bytes=nums.get("stack frame"),
            local_bytes=d["local_bytes"], blocks_per_sm=d["blocks_per_sm"],
            min_blocks=d["min_blocks"])


def ptxas_report(log):
    """(kernel, registers, spill line) for each entry in nvcc's log."""
    import re
    rows, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kernel_label(m.group(1))
        elif "spill" in line:
            spill = line.strip()
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), spill))
            name, spill = None, ""
    return rows


def attempts_stats(attempts, alone):
    """Sum and maximum of a launch's per-ray attempt counts, and the time
    the slowest ray takes when it is traced alone: alone(i) runs the same
    wrapper on ray i only."""
    import torch
    a = attempts.to(torch.int64)
    i = int(a.argmax())
    ms, _ = cuda_ms(lambda: alone(i), 3)
    return dict(attempts_sum=int(a.sum()), slowest_attempts=int(a[i]),
                slowest_alone_ms=ms)


def driver_attempts(attempts, pass1_steps):
    """Attempts a two-pass driver spends on rays whose single-pass counts
    are `attempts`: the first pass up to its cap, then the unconverged
    rays again from the start."""
    import torch
    a = attempts.to(torch.int64)
    return int(torch.clamp(a, max=pass1_steps).sum() + a[a > pass1_steps]
               .sum())


# Each extras instance's resources, filled in phase 2: label (as
# kernel_label names it) -> registers, spills, local memory, blocks an SM
# and block bound.
RESOURCES = {}


def kernel_entry(name, source, replaces, launches, max_abs_err, ms,
                 plain_ms, n, bytes_per_ray, work, stats=None,
                 instance=None):
    """One entry of the kernels line. work: the operations this run's
    inputs need (bounds.Work: per-ray attempts times one attempt's, in the
    instance's scalar type); bound_ms is the flops-only bound at the
    published peak of that type (the counted bound joins once phase 16
    has measured the card's rates); stats: attempts_stats of the timed
    call (a kernel's own single launch; a driver's entry has none);
    instance: the extras instance it launched, whose resources (phase 2)
    the entry carries."""
    n_bytes = n * bytes_per_ray
    bound, by = bounds.flops_bound_ms(work, n_bytes)
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches,
             "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound, "bound_by": by, "library_ms": None,
             "rays": n, "flops": work.flops, "flops_type": work.dtype,
             "ops": work.ops, "bytes": n_bytes}
    if stats:
        entry.update({k: stats[k] for k in ("slowest_attempts",
                                            "slowest_alone_ms")
                      if k in stats})
    if instance:
        entry.update(instance=instance, **RESOURCES.get(instance, {}))
    if isinstance(ms, LateMs):
        LATE_ENTRIES.append((entry, ms))
    return entry


# The kernels-line entries whose ms was taken beside the children's plain
# loops on the card, with that time's call: retime_entries times each
# again once the pool is closed.
LATE_ENTRIES = []


def retime_entries(card):
    """Each entry of LATE_ENTRIES timed again by the same call and the
    same number of repeats on the quiet card: "ms" is the new time and
    "ms_beside_plain_loops" the one taken beside the children."""
    import concurrent.futures
    concurrent.futures.wait([job for pool in PlainPool.started
                             for job in pool.card_jobs], timeout=60)
    require(not PlainPool.card_busy(), "retime_entries: the children "
            "still have calls on the card")
    rows = {}
    for entry, late in LATE_ENTRIES:
        ms, _out = cuda_ms(late.fn, late.repeats)
        del _out
        entry.update(ms=ms, ms_beside_plain_loops=float(late))
        rows[entry["name"]] = [ms, float(late)]
    print(f"kernels-line times taken again on the quiet card (ms, then "
          f"beside the plain loops): {json.dumps(rows)} on {card}",
          flush=True)


THETA_VOL = float(np.radians(80.0))
VOL_SOURCE = "light_path_tracer_tpu_torch/csrc/kerr_dp45_extras.cu"
VOL_JAX = "light_path_tracer_tpu/ops/pallas/volumetric_kernel.py"
VOL_DRIVERS = "light_path_tracer_tpu_torch/ops/cuda/kerr_trace_kernel.py"
# Sizes of phases 11-13: random rays, the scene's grid, the plain loop's
# grid and the card-vs-CPU check.
VOL_RAYS = 4096
VOL_DIM = (1024, 1024)
VOL_PLAIN_DIM = (256, 256)
VOL_CHECK_DIM = (64, 64)
# Attempt cap and exits' window of phase 11: the cap above the exits'
# ~600 attempts at sat_window 512 (the plain loop costs ~10-40 ms an
# iteration, and a lane that never ends runs to the cap: the 3-band
# form's slowest lane needs 2,110, so the cap sets its plain loop's time);
# phase 12's driver check runs without the exits, capped at DRIVER_STEPS.
VOL_STEPS = 1000
VOL_WINDOW = 512
DRIVER_STEPS = 512
# Attempt cap of phase 12's 256^2 grid, kernel and plain loop alike.
GRID_STEPS = 512


def volumetric_forms():
    """Phase 11's forms: (RIAFConfig, spectral bands or None)."""
    from light_path_tracer_tpu_torch.volumetric import RIAFConfig
    return {"thin": (RIAFConfig(), None),
            "absorbed": (RIAFConfig(alpha0=0.5), None),
            "jet": (RIAFConfig(profile="jet", jet_beta=0.6, index=-1.0),
                    None),
            "spectral 2-band": (RIAFConfig(g_power=4.0, alpha0=1.0,
                                           opacity_index=2.0), (0.5, 2.0)),
            "spectral 3-band": scene_forms()["spectral 3-band"]}


def scene_forms():
    """The four paths of phases 12 and 13 (the rows of the JAX package's
    scripts/newmodes_bench.py): (RIAFConfig, spectral bands or None)."""
    from light_path_tracer_tpu_torch.volumetric import RIAFConfig
    return {"volumetric thin": (RIAFConfig(), None),
            "volumetric absorbed": (RIAFConfig(alpha0=0.3), None),
            "volumetric jet b=0.6": (RIAFConfig(profile="jet", jet_beta=0.6,
                                                index=-1.0), None),
            "spectral 3-band": (RIAFConfig(g_power=4.0, alpha0=1.0,
                                           opacity_index=3.0),
                                (0.1, 1.0, 10.0))}


def extras_trace(metric, riaf, freqs, alphas, thetas, max_steps, kernel,
                 **kw):
    """One volumetric or spectral trace through the kernel wrapper
    (kernel=True), its plain loop (False) or a two-pass driver (kw
    `driver`); returns (result, [emission-like extras], [tau-like])."""
    from light_path_tracer_tpu_torch import volumetric
    from light_path_tracer_tpu_torch.ops import kerr_trace
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk
    driver = kw.pop("driver", False)
    args = (metric, R_OBS, alphas, thetas, THETA_VOL)
    if freqs:
        tf = volumetric.make_spectral_transfer(metric, riaf, freqs)
        plain = kerr_trace.trace_rays_spectral
        fn = vk.trace_rays_spectral_cuda if kernel else plain
        if driver:
            kw["trace_fn"] = fn
            fn = kk.trace_rays_spectral_two_pass
        res = fn(*args, tf, len(freqs), LAMBDA_MAX, max_steps, **kw)
        return res, list(res.emission), [res.tau_hat]
    em, ab = volumetric.make_transfer_fns(metric, riaf)
    plain = kerr_trace.trace_rays_volumetric
    fn = vk.trace_rays_volumetric_cuda if kernel else plain
    if driver:
        kw["trace_fn"] = fn
        fn = kk.trace_rays_volumetric_two_pass
    res = fn(*args, em, LAMBDA_MAX, max_steps, absorption_fn=ab, **kw)
    return res, [res.emission], [res.optical_depth]


def extras_compare(a, b):
    """Result a = (res, em, tau) against result b on the same rays:
    status agreement, p99 |d emission| / max(|b|) per band (and the
    largest), max |d emission|, p99 |d tau|."""
    sk, sp = a[0].status.cpu().numpy(), b[0].status.cpu().numpy()
    ok = sk == sp
    out = dict(status_agree=float(ok.mean()), p99_em_bands=[],
               max_abs_em=0.0, p99_tau=0.0)
    for xk, xp in zip(a[1], b[1]):
        xk = xk.cpu().numpy().astype(np.float64)
        xp = xp.cpu().numpy().astype(np.float64)
        d = np.abs(xk - xp)[ok]
        scale = max(np.abs(xp).max(), 1e-30)
        out["p99_em_bands"].append(float(np.percentile(d, 99)) / scale)
        out["max_abs_em"] = max(out["max_abs_em"], float(d.max()))
    out["p99_em"] = max(out["p99_em_bands"])
    for xk, xp in zip(a[2], b[2]):
        d = np.abs(xk.cpu().numpy().astype(np.float64)
                   - xp.cpu().numpy().astype(np.float64))[ok]
        out["p99_tau"] = max(out["p99_tau"], float(np.percentile(d, 99)))
    return out


def f32_gap(metric, riaf, freqs, alphas, thetas, max_steps, plain32,
            job64=None, **kw):
    """The plain loop's own float32 result plain32 against its float64
    result on the same rays (extras_compare's numbers), and that float64
    result with its time (phase 17 holds the float64 kernel against it);
    job64: that float64 run queued to a PlainPool, else it runs here."""
    if job64 is not None:
        ms, rp64 = PlainPool.result(job64, alphas.device)
    else:
        ms, rp64 = cuda_ms(lambda: extras_trace(
            metric, riaf, freqs, alphas.double(), thetas.double(),
            max_steps, False, **kw), 1)
    return extras_compare(plain32, rp64), (rp64, ms)


def extras_gate(what, g, gap=None):
    """Phase 11's gates on kernel-vs-plain numbers g: status agreement
    > 0.99, p99 |d tau| < 1e-3, and p99 |d emission| / max per band
    below 1e-3, or below twice the plain loop's own float32 gap from
    float64 on the same rays (gap, where given) if that is larger: two
    float32 results each within e of the float64 one are within 2e of
    each other. (The 0.1 band of the 3-band spectrum, q 3, carries
    f^(1-q) = 100 times tau_hat's rounding.)"""
    if gap:
        g["f32_gap_em_bands"] = gap["p99_em_bands"]
        g["f32_gap_tau"] = gap["p99_tau"]
    g["em_bars"] = [max(1e-3, 2.0 * e) for e in g.get(
        "f32_gap_em_bands", [0.0] * len(g["p99_em_bands"]))]
    require(g["status_agree"] > 0.99
            and all(p < b for p, b in zip(g["p99_em_bands"], g["em_bars"]))
            and g["p99_tau"] < 1e-3, f"{what} gate: {g}")


def extras_bitwise(a, b):
    ra, rb = a[0], b[0]
    pairs = [(ra.status, rb.status), (ra.final_alpha, rb.final_alpha),
             (ra.n_half_orbits, rb.n_half_orbits)]
    pairs += list(zip(a[1], b[1])) + list(zip(a[2], b[2]))
    return all(same_bits(x, y) for x, y in pairs)


def grinders(probe, width):
    """Rays the saturation (flag 2) or frozen-state (flag 4) exit ended,
    and the rays that ran longest, from a kernel probe."""
    att = probe["attempts"].cpu().numpy()
    fl = probe["flags"].cpu().numpy()
    ended = (fl & 6) != 0
    top = np.argsort(att)[-5:][::-1]
    return dict(
        exited=int(ended.sum()),
        saturation_exits=int(((fl & 2) != 0).sum()),
        frozen_exits=int(((fl & 4) != 0).sum()),
        exit_attempts=([int(att[ended].min()), int(att[ended].max())]
                       if ended.any() else []),
        attempts_mean=float(att.mean()),
        attempts_p999=float(np.percentile(att, 99.9)),
        attempts_max=int(att.max()),
        slowest=[dict(row=int(i // width), col=int(i % width),
                      attempts=int(att[i]), flags=int(fl[i]))
                 for i in top])


def volumetric_phases(dev, card, pool):
    """Phases 11-13; returns the kernels-line entries of the extras kernel
    and its drivers. Their plain loops and CPU renders run in `pool`'s
    children, queued at the start."""
    import torch
    from light_path_tracer_tpu_torch import camera, volumetric
    from light_path_tracer_tpu_torch.models import Kerr
    from light_path_tracer_tpu_torch.ops import kerr_trace
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk
    from light_path_tracer_tpu_torch.utils.config import (RenderConfig,
                                                          SceneConfig)

    # -- 11. extras kernel vs plain version -----------------------------
    kerr = Kerr(M=1.0, a=0.9)
    ac = kerr.alpha_crit(R_OBS, THETA_VOL)
    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=dev)
    al = torch.tensor(rng.uniform(0.3 * ac, 4 * ac, VOL_RAYS), **f32)
    th = torch.tensor(rng.uniform(-np.pi, np.pi, VOL_RAYS), **f32)
    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=R_OBS, theta_obs=THETA_VOL,
                        vertical_fov_deg=16.0)
    cfg = RenderConfig()
    d256 = VOL_PLAIN_DIM
    fov256 = camera.fov_from_vertical(scene.vertical_fov, d256)
    al256 = camera.build_alpha_lookup(d256, fov256, **f32).reshape(-1)
    th256 = camera.build_theta_lookup(d256, fov256, **f32).reshape(-1)
    d64 = VOL_CHECK_DIM
    freqs3 = scene_forms()["spectral 3-band"][1]
    riaf3 = scene_forms()["spectral 3-band"][0]
    jobs = {}
    for label, (riaf, freqs) in volumetric_forms().items():
        for k, (a, t) in enumerate(((al, th), (al.double(), th.double()))):
            jobs[11, label, k] = pool.submit(
                "extras_trace", kerr, riaf, freqs, a, t, VOL_STEPS, False,
                sat_window=VOL_WINDOW)
    for label, (riaf, freqs) in scene_forms().items():
        for k, (a, t) in enumerate(((al256, th256), (al256.double(),
                                                      th256.double()))):
            if k == 0 or freqs:
                jobs[12, label, k] = pool.submit(
                    "extras_trace", kerr, riaf, freqs, a, t, GRID_STEPS,
                    False, sat_window=2048)
    for label in ("thin", "spectral 3-band"):
        riaf, freqs = volumetric_forms()[label]
        jobs["driver", label] = pool.submit(
            "extras_trace", kerr, riaf, freqs, al, th, DRIVER_STEPS, False,
            driver=True, pass1_steps=64)
    volumetric_module = "light_path_tracer_tpu_torch.volumetric:"
    jobs["vol64"] = pool.submit(volumetric_module + "render_volumetric",
                                scene, d64, cfg, device="cpu", on="cpu")
    jobs["spec64"] = pool.submit(
        volumetric_module + "render_volumetric_spectrum", scene, d64,
        freqs3, cfg, riaf3, device="cpu", on="cpu")
    jobs14 = queue_phase14(pool, kerr, al, th, al256, th256)
    print(f"extras kernel vs plain version (f32 'fast', {VOL_RAYS} random "
          f"rays, max_steps {VOL_STEPS}, sat_window {VOL_WINDOW}):",
          flush=True)
    g11, gap11, plain64 = {}, {}, {}
    for label, (riaf, freqs) in volumetric_forms().items():
        probe = {}
        ms, rk = cuda_ms(lambda: extras_trace(
            kerr, riaf, freqs, al, th, VOL_STEPS, True,
            sat_window=VOL_WINDOW, probe=probe), 3)
        plain_ms, rp = PlainPool.result(jobs[11, label, 0], dev)
        g = extras_compare(rk, rp)
        g.update(ms=ms, plain_ms=plain_ms, n_steps_kernel=int(rk[0].n_steps),
                 n_steps_plain=int(rp[0].n_steps),
                 kernel_attempts=grinders(probe, VOL_RAYS)["slowest"][:2])
        g.update(attempts_stats(probe["attempts"], lambda i: extras_trace(
            kerr, riaf, freqs, al[i:i + 1], th[i:i + 1], VOL_STEPS, True,
            sat_window=VOL_WINDOW)))
        gap11[label], plain64[label] = f32_gap(
            kerr, riaf, freqs, al, th, VOL_STEPS, rp,
            job64=jobs[11, label, 1])
        g11[label] = g
        extras_gate(f"phase 11 {label}", g, gap11[label])
        print(f"  {label}: {json.dumps(g)}", flush=True)
        g["attempts"] = probe["attempts"]

    # -- 12. the 1024^2 scene: single pass vs drivers --------------------
    dim = VOL_DIM
    fov = camera.fov_from_vertical(scene.vertical_fov, dim)
    al12 = camera.build_alpha_lookup(dim, fov, **f32).reshape(-1)
    th12 = camera.build_theta_lookup(dim, fov, **f32).reshape(-1)
    forms12 = {"thin": scene_forms()["volumetric thin"],
               "spectral 3-band": scene_forms()["spectral 3-band"]}
    print(f"{dim[0]}^2 scene (a=0.9, theta_obs 80 deg, FOV 16 deg), kernel "
          f"single pass vs two-pass driver:", flush=True)
    g12 = {}
    for label, (riaf, freqs) in forms12.items():
        probe = {}
        kw = dict(sat_window=2048)
        one_ms, one = cuda_ms(lambda: extras_trace(
            kerr, riaf, freqs, al12, th12, 200000, True, **kw), 3)
        extras_trace(kerr, riaf, freqs, al12, th12, 200000, True, probe=probe,
                     **kw)
        two_ms, two = cuda_ms(lambda: extras_trace(
            kerr, riaf, freqs, al12, th12, 200000, True, driver=True, **kw),
            3)
        row = dict(single_ms=one_ms, two_pass_ms=two_ms,
                   bitwise_equal=extras_bitwise(one, two),
                   n_steps_single=int(one[0].n_steps),
                   n_steps_two_pass=int(two[0].n_steps),
                   over_4096_attempts=int(probe["attempts"].gt(4096).sum()))
        row.update(grinders(probe, dim[1]))
        if label == "thin":
            thin_exited = (probe["flags"] & 6).ne(0).cpu().numpy()
        p256 = {}
        extras_trace(kerr, riaf, freqs, al12, th12, 256, True, probe=p256,
                     **kw)
        n_unc = int((p256["flags"] & 1).sum())
        two256 = extras_trace(kerr, riaf, freqs, al12, th12, 200000, True,
                              driver=True, pass1_steps=256, **kw)
        row.update(unconverged_256=n_unc,
                   bitwise_equal_pass1_256=extras_bitwise(one, two256))
        g12[label] = row
        print(f"  {label}: {json.dumps(row)}", flush=True)
        require(row["bitwise_equal"] and (row["bitwise_equal_pass1_256"]
                                          or n_unc > 1024),
                f"phase 12 {label}: the driver differs from the single pass")
        del one, two, two256
    # The plain loop against the kernel on the 256^2 grid of the scene,
    # for each of phase 13's four paths, both capped at GRID_STEPS
    # attempts, below the exits' ~2,150 (the plain loop costs 10-50 ms an
    # iteration, so it never runs the 1024^2 grid in full; phase 11 and
    # the drivers check the exits).
    g256 = {}
    for label, (riaf, freqs) in scene_forms().items():
        ms256, rk = cuda_ms(lambda: extras_trace(
            kerr, riaf, freqs, al256, th256, GRID_STEPS, True,
            sat_window=2048), 3)
        plain256, rp = PlainPool.result(jobs[12, label, 0], dev)
        g = extras_compare(rk, rp)
        g.update(ms=ms256, plain_ms=plain256,
                 n_steps_kernel=int(rk[0].n_steps),
                 n_steps_plain=int(rp[0].n_steps))
        g256[label] = g
        # The float64 run only where a bar needs it: the 3-band form.
        gap = (f32_gap(kerr, riaf, freqs, al256, th256, GRID_STEPS, rp,
                       job64=jobs[12, label, 1])[0] if freqs else None)
        extras_gate(f"phase 12 256^2 {label}", g, gap)
        print(f"  {label}, {d256[0]}^2 grid, both capped at {GRID_STEPS}: "
              f"{json.dumps(g)}", flush=True)
    # Both drivers over the kernel and over the plain loop, on phase
    # 11's 4,096 rays with a 64-attempt first pass, capped at
    # DRIVER_STEPS attempts (the plain loop costs ~10-30 ms an iteration).
    drv = {}
    for label in ("thin", "spectral 3-band"):
        riaf, freqs = volumetric_forms()[label]
        k_ms, rk = cuda_ms(lambda: extras_trace(
            kerr, riaf, freqs, al, th, DRIVER_STEPS, True, driver=True,
            pass1_steps=64), 3)
        p_ms, rp = PlainPool.result(jobs["driver", label], dev)
        probe = {}
        single = extras_trace(kerr, riaf, freqs, al, th, DRIVER_STEPS, True,
                              probe=probe)
        g = extras_compare(rk, rp)
        g.update(ms=k_ms, plain_ms=p_ms, bitwise_equal=extras_bitwise(
            single, rk), attempts_sum=driver_attempts(probe["attempts"],
                                                      64))
        drv[label] = g
        extras_gate(f"phase 12 {label} driver", g, gap11[label])
        print(f"  {label} driver, {VOL_RAYS} random rays, pass1_steps 64, "
              f"kernel vs plain loop: {json.dumps(g)}", flush=True)
        require(g["bitwise_equal"], f"phase 12 {label} driver differs "
                f"from the single pass")
    del al12, th12, rk, rp

    # -- 13. the four paths through the entry points ----------------------
    paths = {label: riaf for label, (riaf, _f) in scene_forms().items()}
    counters = (vk.trace_rays_volumetric_cuda, vk.trace_rays_aux_cuda,
                kk.trace_rays_volumetric_two_pass,
                kk.trace_rays_spectral_two_pass,
                kerr_trace.trace_rays_volumetric,
                kerr_trace.trace_rays_spectral, kerr_trace.trace_rays_aux)
    launches = {"volumetric": 0, "spectral": 0, "vol_driver": 0,
                "spec_driver": 0}
    totals = {}
    for label, riaf in paths.items():
        spectral = label.startswith("spectral")
        for c in counters:
            c.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)

        def render():
            if spectral:
                return volumetric.render_volumetric_spectrum(
                    scene, dim, freqs3, cfg, riaf, device="cuda")
            return volumetric.render_volumetric(scene, dim, cfg, riaf,
                                                device="cuda")
        img, st = render()                                   # warmup
        runs = []
        for _ in range(3):
            img, st = render()
            runs.append(dict(st["timings"]))
        best = max(st["traced_rays"] / t["precompute"] for t in runs)
        n_kernel = (vk.trace_rays_aux_cuda if spectral
                    else vk.trace_rays_volumetric_cuda).launches
        n_driver = (kk.trace_rays_spectral_two_pass if spectral
                    else kk.trace_rays_volumetric_two_pass).launches
        n_plain = sum(c.launches for c in counters[4:])
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        launches["spectral" if spectral else "volumetric"] += n_kernel
        launches["spec_driver" if spectral else "vol_driver"] += n_driver
        row = dict(kernel_launches=n_kernel, driver_calls=n_driver,
                   plain_loop_calls=n_plain, best_rays_per_s=best,
                   peak_mib=peak, captured=st["captured"],
                   integrator_steps=st["integrator_steps"],
                   timings=runs)
        require(n_kernel == 8 and n_driver == 4 and n_plain == 0,
                f"{label}: {n_kernel} kernel launches, {n_driver} driver "
                f"calls, {n_plain} plain calls")
        require(st["traced_rays"] == dim[0] * dim[1]
                and bool(torch.isfinite(img).all())
                and float(img.min()) >= 0.0 and float(img.max()) <= 1.0,
                f"{label}: bad image")
        em = st["emission"]
        if spectral:
            flux, rad = st["flux"], st["mean_radius_rad"]
            row.update(flux=flux.tolist(), mean_radius_rad=rad.tolist())
            require(flux[1] > 2.0 * flux[0] and flux[1] > 2.0 * flux[2]
                    and rad[0] > rad[1] > rad[2],
                    f"{label}: no SSA turnover: flux {flux}, radii {rad}")
        else:
            h = dim[1] // 2
            left, right = em[:, 1:h].sum(), em[:, h + 1:].sum()
            row.update(emission_total=st["emission_total"],
                       half_ratio=float(max(left, right)
                                        / max(min(left, right), 1e-30)),
                       tau_max=st["tau_max"])
            totals[label] = st["emission_total"]
            require(np.isfinite(em).all() and st["emission_total"] > 0,
                    f"{label}: emission not finite and positive")
            if label == "volumetric thin":
                thin_map = em
        print(f"{label} {dim[0]}^2: {json.dumps(row)}; best {best:,.0f} "
              f"rays/s on {card}", flush=True)
        if label == "volumetric thin":
            require(row["half_ratio"] > 2.0,
                    f"no Doppler crescent: half ratio {row['half_ratio']}")
    require(totals["volumetric absorbed"] < totals["volumetric thin"],
            f"absorbed emission {totals['volumetric absorbed']} is not "
            f"below the thin {totals['volumetric thin']}")

    og, sg = volumetric.render_volumetric(scene, d64, cfg, device="cuda")
    oc, sc = PlainPool.result(jobs["vol64"], "cpu")[1]
    mask_agree = float(((sg["emission"] > 0) == (sc["emission"] > 0)).mean())
    d = float((og.cpu() - oc).abs().median())
    print(f"volumetric check, 64^2 card vs CPU: emission masks agree "
          f"{mask_agree:.4f}, median |d image| {d:.3e}", flush=True)
    require(mask_agree >= 0.99 and d < 1e-4,
            f"64^2 volumetric card vs CPU: masks {mask_agree}, median {d}")
    og, sg = volumetric.render_volumetric_spectrum(scene, d64, freqs3, cfg,
                                                   riaf3, device="cuda")
    oc, sc = PlainPool.result(jobs["spec64"], "cpu")[1]
    masks = [float(((sg["emission"][b] > 0) == (sc["emission"][b] > 0))
                   .mean()) for b in range(len(freqs3))]
    meds = [float((og[b].cpu() - oc[b]).abs().median())
            for b in range(len(freqs3))]
    print(f"spectral check, 64^2 card vs CPU, per band: emission masks "
          f"agree {masks}, median |d image| {meds}", flush=True)
    require(min(masks) >= 0.99 and max(meds) < 1e-4,
            f"64^2 spectral card vs CPU: masks {masks}, medians {meds}")

    thin, spec = g11["thin"], g11["spectral 3-band"]
    n_bands = len(freqs3)
    thin_work = extras_work("thin")
    spec_work = extras_work("spectral", n_bands)
    thin_inst = "kerr_dp45_extras<VolThin<float>>"
    spec_inst = f"kerr_dp45_extras<Spectral<{n_bands},float>>"
    state = dict(kerr=kerr, al=al, th=th, scene=scene, cfg=cfg,
                 thin_emission=thin_map, thin_exited=thin_exited,
                 plain64_11=plain64, al256=al256, th256=th256,
                 jobs14=jobs14)
    return [
        kernel_entry("kerr_dp45_extras", VOL_SOURCE, f"{VOL_JAX}:53",
                     launches["volumetric"], thin["max_abs_em"], thin["ms"],
                     thin["plain_ms"], VOL_RAYS, 8 + 4 * 5,
                     thin["attempts_sum"] * thin_work, thin, thin_inst),
        kernel_entry("trace_rays_volumetric_two_pass", VOL_DRIVERS,
                     f"{VOL_JAX}:209", launches["vol_driver"],
                     drv["thin"]["max_abs_em"], drv["thin"]["ms"],
                     drv["thin"]["plain_ms"], VOL_RAYS, 8 + 4 * 5,
                     drv["thin"]["attempts_sum"] * thin_work,
                     instance=thin_inst),
        kernel_entry("kerr_dp45_extras_spectral", VOL_SOURCE,
                     f"{VOL_JAX}:276", launches["spectral"],
                     spec["max_abs_em"], spec["ms"], spec["plain_ms"],
                     VOL_RAYS, 8 + 4 * (5 + n_bands),
                     spec["attempts_sum"] * spec_work, spec, spec_inst),
        kernel_entry("trace_rays_spectral_two_pass", VOL_DRIVERS,
                     f"{VOL_JAX}:476", launches["spec_driver"],
                     drv["spectral 3-band"]["max_abs_em"],
                     drv["spectral 3-band"]["ms"],
                     drv["spectral 3-band"]["plain_ms"], VOL_RAYS,
                     8 + 4 * (5 + n_bands),
                     drv["spectral 3-band"]["attempts_sum"] * spec_work,
                     instance=spec_inst)
    ], state


STOKES_SOURCE = "light_path_tracer_tpu_torch/csrc/kerr_dp45_stokes.cu"
MOVIE_SOURCE = "light_path_tracer_tpu_torch/csrc/kerr_dp45_movie_{}.cu"
ORDER_SOURCE = "light_path_tracer_tpu_torch/csrc/kerr_dp45_orders.cu"
PROBE_SOURCE = "light_path_tracer_tpu_torch/csrc/peak_probe.cu"
# Phase 14's depth: the plain loop costs ~10 ms an iteration whatever the
# batch, so its runs are capped here (above the exits' ~600 attempts) and
# the exits' window is short.
AUX_STEPS = 1000
AUX_WINDOW = 512
# The 256^2 grid's forms with (attempt cap, sat_window): the main path's
# window with the cap at 2,048, except the movie and thin order forms,
# whose plain loops cost 30-50 ms an iteration (60-105 s at 2,048 on an
# H100's host, 19-26 s at 1,024 or 768 with the exits' window at 512,
# where most of their lanes end): capped at 512 with the window at 256.
GRID_FORMS = {"stokes toroidal": (2048, 2048), "movie thin": (512, 256),
              "movie absorbed": (512, 256), "order thin": (512, 256),
              "order absorbed": (2048, 2048)}
N_FRAMES = 8
N_ORDERS = 3
P0 = 0.7


def aux_forms(metric, al, th, stokes=True):
    """Phase 14's forms on rays (al, th): label -> (transfer_fn, n_extras,
    aux, sat_monitor, the form as bounds.extras_work takes it); without
    the Stokes forms (Kerr-only) when not `stokes`."""
    from light_path_tracer_tpu_torch import polarization, volumetric
    from light_path_tracer_tpu_torch.disk import keplerian_omega
    period = 2.0 * np.pi / abs(keplerian_omega(1.0, 0.9, 6.0, True))
    times = tuple(period * k / N_FRAMES for k in range(N_FRAMES))
    forms = {}
    aux = (polarization.camera_constants(metric, R_OBS, THETA_VOL, al, th)
           if stokes else ())
    for field in ("toroidal", "vertical") if stokes else ():
        forms[f"stokes {field}"] = (
            polarization.make_polarized_volumetric_transfer(
                metric, volumetric.RIAFConfig(), field, P0), 3, aux,
            (0, 1, 2), dict(kind="stokes", field=field))
    for a0 in (0.0, 0.3):
        ab = int(a0 > 0)
        riaf = volumetric.RIAFConfig(spot_amp=8.0, alpha0=a0)
        name = "absorbed" if ab else "thin"
        forms[f"movie {name}"] = (
            volumetric.make_movie_transfer(metric, riaf, times),
            1 + ab + N_FRAMES, (),
            tuple(range(1 + ab, 1 + ab + N_FRAMES)),
            dict(kind="movie", width=N_FRAMES, absorbing=bool(ab)))
        riaf = volumetric.RIAFConfig(alpha0=a0)
        forms[f"order {name}"] = (
            volumetric.make_order_transfer(metric, riaf, N_ORDERS),
            1 + ab + N_ORDERS, (),
            tuple(range(1 + ab, 1 + ab + N_ORDERS)),
            dict(kind="order", width=N_ORDERS, absorbing=bool(ab)))
    return forms


def order2_form(metric):
    """Phase 14's two-order form: the open-ended last bucket takes every
    later crossing."""
    from light_path_tracer_tpu_torch import volumetric
    return (volumetric.make_order_transfer(metric, volumetric.RIAFConfig(),
                                           2),
            3, (), (1, 2), dict(kind="order", width=2))


def aux_plain(metric, label, al, th, max_steps, f64=False, **kw):
    """A phase-14 form's plain loop as a PlainPool job: the form built
    from the float32 rays (al, th) as aux_forms builds it (its camera
    constants in float32), traced on those rays or, with f64, on their
    float64 copies."""
    form = (order2_form(metric) if label == "order x2 thin"
            else aux_forms(metric, al, th)[label])
    if f64:
        al, th = al.double(), th.double()
    return aux_trace(metric, form, al, th, max_steps, False, **kw)


def queue_phase14(pool, kerr, al, th, al256, th256):
    """Phase 14's and 15's plain loops and CPU renders, queued to `pool`;
    returns the jobs by key."""
    jobs = {}
    for label in aux_forms(kerr, al, th):
        kw = dict(sat_window=AUX_WINDOW)
        jobs[14, label, 0] = pool.submit("aux_plain", kerr, label, al, th,
                                         AUX_STEPS, **kw)
        # float64: phase 14's bars, and phase 17's reference.
        jobs[14, label, 1] = pool.submit("aux_plain", kerr, label, al, th,
                                         AUX_STEPS, f64=True, **kw)
    jobs[14, "order x2 thin", 0] = pool.submit(
        "aux_plain", kerr, "order x2 thin", al, th, AUX_STEPS,
        sat_window=AUX_WINDOW)
    for label, (cap, window) in GRID_FORMS.items():
        jobs[14, "256", label] = pool.submit("aux_plain", kerr, label, al256,
                                             th256, cap, sat_window=window)
    jobs[14, "driver"] = pool.submit("aux_plain", kerr, "stokes toroidal",
                                     al, th, AUX_STEPS, driver=True,
                                     pass1_steps=64)
    for label in P15_PATHS + ("decomposed x3 absorbed",):
        jobs[15, label] = pool.submit("p15_render", label, VOL_CHECK_DIM,
                                      "cpu", on="cpu")
    return jobs


P15_PATHS = ("polarized", "movie 8-frame", "movie 8-frame absorbed",
             "decomposed x3")


def p15_render(label, dim, device):
    """Phase 15's render `label` of the 1024^2 scene's frame at `dim` on
    `device`."""
    from light_path_tracer_tpu_torch import polarization, volumetric
    from light_path_tracer_tpu_torch.utils.config import (RenderConfig,
                                                          SceneConfig)
    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=R_OBS, theta_obs=THETA_VOL,
                        vertical_fov_deg=16.0)
    cfg = RenderConfig()
    R = volumetric.RIAFConfig
    alpha0 = 0.3 if label.endswith("absorbed") else 0.0
    if label == "polarized":
        return polarization.render_polarized_volumetric(
            scene, dim, cfg, R(), p0=P0, device=device)
    if label.startswith("movie"):
        period = 2.0 * np.pi / abs(volumetric.keplerian_omega(
            1.0, 0.9, 6.0, True))
        times = tuple(period * k / N_FRAMES for k in range(N_FRAMES))
        return volumetric.render_volumetric_movie(
            scene, dim, times, cfg, R(spot_amp=8.0, alpha0=alpha0),
            device=device)
    return volumetric.render_volumetric_decomposed(
        scene, dim, cfg, R(alpha0=alpha0), n_orders=N_ORDERS, device=device)


def extras_label(desc, real="float"):
    """The extras instance (as kernel_label names it) of a phase-14 form's
    bounds description."""
    kind, width = desc["kind"], desc.get("width", 0)
    ab = int(desc.get("absorbing", False))
    args = {"stokes": "", "movie": f"{width},absorbing={ab},",
            "order": f"{width},absorbing={ab},"}[kind]
    return f"kerr_dp45_extras<{kind.capitalize()}<{args}{real}>>"


def aux_trace(metric, form, al, th, max_steps, kernel, **kw):
    """One trace of a phase-14 form through the kernel wrapper
    (kernel=True), the plain loop (False) or the aux two-pass driver (kw
    `driver`) on rays of either precision; returns ExtrasResult."""
    from light_path_tracer_tpu_torch.ops import kerr_trace
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk
    tf, n_extras, aux, monitor, _work = form
    driver = kw.pop("driver", False)
    aux = tuple(a.to(al.dtype) for a in aux)
    plain_tf = tf if aux else (lambda y, pt, pp, _aux: tf(y, pt, pp))
    fn = vk.trace_rays_aux_cuda if kernel else kerr_trace.trace_rays_aux
    use = tf if kernel else plain_tf
    if driver:
        kw["trace_fn"] = fn
        fn = kk.trace_rays_aux_two_pass
    return fn(metric, R_OBS, al, th, THETA_VOL, use, n_extras, aux,
              LAMBDA_MAX, max_steps, sat_monitor=monitor, **kw)


def aux_compare(rk, rp, label, width=N_ORDERS):
    """Kernel result rk against plain result rp: status agreement and,
    per extra, p99 |d| / max |plain| on rays of equal status (the Stokes
    Q and U against max |I|). For the order forms (`width` buckets, the
    last extras) also: p99 of the
    buckets' sum per ray against the largest sum; each order's flux
    against its own plain flux (flux_rel) and the largest move against
    the total (flux_shift); and, per order, of the rays that carry it in
    the plain loop (that bucket above 5 % of the ray's sum, the sum above
    1e-3 of the largest) the share whose kernel bucket sits within 1 % of
    the ray's sum (bucket_match, of `carriers` rays)."""
    ok = (rk.status == rp.status).cpu().numpy()
    xk = np.stack([e.double().cpu().numpy() for e in rk.extras])
    xp = np.stack([e.double().cpu().numpy() for e in rp.extras])
    scales = np.maximum(np.abs(xp).max(axis=1), 1e-30)
    if label.startswith("stokes"):
        scales[:] = scales[0]
    d = np.abs(xk - xp)[:, ok]
    out = dict(status_agree=float(ok.mean()),
               p99=(np.percentile(d, 99, axis=1) / scales).tolist(),
               max_abs=float(d.max()))
    if label.startswith("order"):
        out.update(order_numbers(xk[-width:][:, ok], xp[-width:][:, ok]))
        out["p95_m"] = float(np.percentile(d[0], 95))
    return out


def order_numbers(bk, bp):
    """aux_compare's numbers of the order buckets bk (kernel) against bp
    (plain), each (orders, rays)."""
    sk, sp = bk.sum(axis=0), bp.sum(axis=0)
    fk, fp = bk.sum(axis=1), bp.sum(axis=1)
    carry = (sp > 1e-3 * sp.max()) & (bp > 0.05 * sp)
    near = np.abs(bk - bp) < 0.01 * sp
    carriers = carry.sum(axis=1)
    return dict(
        p99_sum=float(np.percentile(np.abs(sk - sp), 99)
                      / max(sp.max(), 1e-30)),
        flux_kernel=fk.tolist(), flux_plain=fp.tolist(),
        flux_rel=(np.abs(fk - fp) / fp).tolist(),
        flux_shift=float(np.abs(fk - fp).max() / fp.sum()),
        carriers=carriers.tolist(),
        bucket_match=((near & carry).sum(axis=1)
                      / np.maximum(carriers, 1)).tolist())


def order_gate(g):
    """The order buckets' gates on order_numbers g. After a crossing m
    sits within rounding of an integer, so floor(m) puts the stretch of
    path up to the next crossing in either neighbour: a coin flip per ray
    and crossing, and single rays differ. Every order is still held on
    its own, with bars that follow the coin flips' 1 / sqrt(rays)
    (neighbouring rays flip alike, so the factors are 2.5-3x the largest
    readings on the H100): its flux within max(3 %, 3 / sqrt(carriers))
    of its own plain flux, at least 20 carriers, of which more than 40 %
    have the same bucket value; the flux moved between orders at most
    max(1 %, 1 / sqrt(carriers of order 0)) of the total; the buckets'
    sum per ray within 1e-3 of the largest (p99)."""
    n = np.maximum(np.asarray(g["carriers"], dtype=np.float64), 1.0)
    g["flux_bars"] = np.maximum(0.03, 3.0 / np.sqrt(n)).tolist()
    g["flux_shift_bar"] = float(max(0.01, 1.0 / np.sqrt(n[0])))
    return (g["p99_sum"] < 1e-3 and g["flux_shift"] < g["flux_shift_bar"]
            and all(r < b for r, b in zip(g["flux_rel"], g["flux_bars"]))
            and min(g["carriers"]) >= 20 and min(g["bucket_match"]) > 0.4)


def aux_gate(what, g, gap=None):
    """Phase 14's gates on kernel-vs-plain numbers g; gap: the plain
    loop's own float32-vs-float64 numbers on the same rays, which raise a
    bar of 1e-3 to twice the gap where given. The order forms' buckets
    are held by order_gate, their winding by its p95."""
    if "p99_sum" in g:
        if gap:
            g["f32_gap_flux_rel"] = gap["flux_rel"]
            g["f32_gap_flux_shift"] = gap["flux_shift"]
        require(g["status_agree"] > 0.99 and order_gate(g)
                and g["p95_m"] < 5e-3, f"{what} gate: {g}")
        return
    n = len(g["p99"])
    g["bars"] = [max(1e-3, 2.0 * e) for e in (gap["p99"] if gap
                                              else [0.0] * n)]
    if gap:
        g["f32_gap"] = gap["p99"]
    require(g["status_agree"] > 0.99
            and all(p < b for p, b in zip(g["p99"], g["bars"])),
            f"{what} gate: {g}")


def aux_both(what, metric, label, form, al, th, max_steps, window,
             f64=True, repeats=3, method="dp45", jobs=None):
    """Kernel and plain loop (float32, and with f64 the float64 run that
    sets the bars) of one form on the same rays; prints and gates;
    returns the numbers with the kernel's per-ray attempts. jobs: the
    plain runs (float32, float64 or None) queued to a PlainPool, else
    they run here."""
    kw = dict(sat_window=window, method=method)
    probe = {}
    ms, rk = cuda_ms(lambda: aux_trace(metric, form, al, th, max_steps, True,
                                       probe=probe, **kw), repeats)
    if jobs is not None:
        plain_ms, rp = PlainPool.result(jobs[0], al.device)
    else:
        plain_ms, rp = cuda_ms(lambda: aux_trace(
            metric, form, al, th, max_steps, False, **kw), 1)
    width = len(form[3])
    g = aux_compare(rk, rp, label, width)
    g.update(ms=ms, plain_ms=plain_ms, n_steps_kernel=int(rk.n_steps),
             n_steps_plain=int(rp.n_steps),
             exits=int((probe["flags"] & 6).ne(0).sum()),
             bitwise_plain=all(same_bits(x, y) for x, y in zip(
                 aux_outputs(rk), aux_outputs(rp))))
    # The Stokes kernel sums the Levi-Civita contraction in the plain
    # loop's order: bitwise its plain loop in either pair.
    require(g["bitwise_plain"] or not label.startswith("stokes"),
            f"{what} {label}: the Stokes kernel is not bitwise its plain "
            f"loop: {g}")
    g.update(attempts_stats(probe["attempts"], lambda i: aux_trace(
        metric, (form[0], form[1], tuple(a[i:i + 1] for a in form[2]),
                 form[3], form[4]), al[i:i + 1], th[i:i + 1], max_steps,
        True, **kw)))
    gap = plain64 = None
    if f64:
        plain64 = (PlainPool.result(jobs[1], al.device) if jobs is not None
                   else cuda_ms(lambda: aux_trace(
                       metric, form, al.double(), th.double(), max_steps,
                       False, **kw), 1))
        gap = aux_compare(rp, plain64[1], label, width)
    aux_gate(f"{what} {label}", g, gap)
    print(f"  {label}: {json.dumps(g)}", flush=True)
    g["attempts"] = probe["attempts"]
    g["plain64"] = plain64
    return g


def aux_exits(metric, label, form, al, th, lanes):
    """The lanes of a capped run that reached the cap, again with the
    exits' window at AUX_WINDOW and twice that as the cap, in the kernel
    and in the plain loop: the exits must end every lane in both. (The
    status may differ: a lane that freezes in the kernel need not freeze
    in the plain loop, whose products are not contracted to FMA.)"""
    if lanes.numel() == 0:
        print(f"  {label}: no lane reached the cap", flush=True)
        return
    sub = (form[0], form[1], tuple(a[lanes] for a in form[2]), form[3],
           form[4])
    probe = {}
    kw = dict(sat_window=AUX_WINDOW, return_unconverged=True)
    rk, uk = aux_trace(metric, sub, al[lanes], th[lanes], 2 * AUX_WINDOW,
                       True, probe=probe, **kw)
    rp, up = aux_trace(metric, sub, al[lanes], th[lanes], 2 * AUX_WINDOW,
                       False, **kw)
    row = dict(lanes=int(lanes.numel()),
               kernel_exits=int((probe["flags"] & 6).ne(0).sum()),
               kernel_attempts=[int(probe["attempts"].min()),
                                int(probe["attempts"].max())],
               kernel_capped=int(uk.sum()), plain_capped=int(up.sum()),
               status_agree=float((rk.status == rp.status).float().mean()))
    print(f"  {label}, the {row['lanes']} lanes at the cap, sat_window "
          f"{AUX_WINDOW}, capped at {2 * AUX_WINDOW}: {json.dumps(row)}",
          flush=True)
    require(row["kernel_exits"] > 0 and row["kernel_capped"] == 0
            and row["plain_capped"] == 0,
            f"phase 14 {label}: the exits do not end the frozen lanes")


def aux_scene(metric, label, form, al, th, width):
    """A form's single pass on the 1024^2 scene's rays at the main path's
    depth and window, with the exits' counts and the slowest rays, and
    its two-pass driver bitwise against it; prints; returns the row, the
    single-pass result and the probe."""
    import torch
    kw = dict(sat_window=2048)
    one_ms, one = cuda_ms(lambda: aux_trace(metric, form, al, th, 200000,
                                            True, **kw), 3)
    probe = {}
    aux_trace(metric, form, al, th, 200000, True, probe=probe, **kw)
    two_ms, two = cuda_ms(lambda: aux_trace(metric, form, al, th, 200000,
                                            True, driver=True, **kw), 3)
    same = all(same_bits(a, b) for a, b in zip(
        (one.status, one.final_alpha, *one.extras),
        (two.status, two.final_alpha, *two.extras)))
    two256 = aux_trace(metric, form, al, th, 200000, True, driver=True,
                       pass1_steps=256, **kw)
    same256 = all(same_bits(a, b) for a, b in zip(
        (one.status, one.final_alpha, *one.extras),
        (two256.status, two256.final_alpha, *two256.extras)))
    n_unc = int(probe["attempts"].gt(256).sum())
    row = dict(single_ms=one_ms, two_pass_ms=two_ms, bitwise_equal=same,
               over_256_attempts=n_unc, bitwise_equal_pass1_256=same256,
               n_steps_single=int(one.n_steps),
               attempts_sum=int(probe["attempts"].to(torch.int64).sum()))
    row.update(grinders(probe, width))
    print(f"  {label}: {json.dumps(row)}", flush=True)
    require(same and (same256 or n_unc > 1024),
            f"phase 14 {label}: the driver differs from the single pass on "
            f"the scene")
    return row, one, probe


def new_mode_phases(dev, card, state):
    """Phases 14 and 15; returns the kernels-line entries of the Stokes,
    movie and order forms and of the aux driver."""
    import torch
    from light_path_tracer_tpu_torch import (camera, polarization,
                                             volumetric)
    from light_path_tracer_tpu_torch.ops import kerr_trace
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk
    from light_path_tracer_tpu_torch.utils.config import SceneConfig

    kerr, al, th = state["kerr"], state["al"], state["th"]
    scene, cfg = state["scene"], state["cfg"]
    jobs = state["jobs14"]
    f32 = dict(dtype=torch.float32, device=dev)

    # -- 14. Stokes, movie and order forms vs the plain loop -------------
    print(f"aux, movie and order forms vs plain version (f32 'fast', "
          f"{VOL_RAYS} random rays, max_steps {AUX_STEPS}, sat_window "
          f"{AUX_WINDOW}):", flush=True)
    forms = aux_forms(kerr, al, th)
    g14 = {label: aux_both("phase 14", kerr, label, form, al, th, AUX_STEPS,
                           AUX_WINDOW, f64=not label.startswith("order"),
                           jobs=(jobs[14, label, 0], jobs[14, label, 1]))
           for label, form in forms.items()}
    state.update(g14=g14, forms14=forms)
    # Two orders: the open-ended last bucket takes every later crossing
    # (2 % of the flux), so a last bucket that is closed breaks the sum.
    aux_both("phase 14", kerr, "order x2 thin", order2_form(kerr), al, th,
             AUX_STEPS, AUX_WINDOW, f64=False,
             jobs=(jobs[14, "order x2 thin", 0], None))
    d256 = VOL_PLAIN_DIM
    al256, th256 = state["al256"], state["th256"]
    forms256 = aux_forms(kerr, al256, th256)
    print(f"  the scene's {d256[0]}^2 grid, kernel and plain loop capped "
          f"alike (attempt cap, sat_window): {json.dumps(GRID_FORMS)}",
          flush=True)
    for label, (cap, window) in GRID_FORMS.items():
        g = aux_both(f"phase 14 {d256[0]}^2", kerr, label, forms256[label],
                     al256, th256, cap, window, f64=False,
                     jobs=(jobs[14, "256", label], None))
        if window > AUX_WINDOW:
            aux_exits(kerr, label, forms256[label], al256, th256,
                      g["attempts"].ge(cap).nonzero().reshape(-1))
    # Each form's single pass on the 1024^2 scene, as phase 12 has it for
    # the thin and 3-band forms: the kernel time that sets phase 15's
    # frames, and who sets it.
    dim = VOL_DIM
    fov = camera.fov_from_vertical(scene.vertical_fov, dim)
    al15 = camera.build_alpha_lookup(dim, fov, **f32).reshape(-1)
    th15 = camera.build_theta_lookup(dim, fov, **f32).reshape(-1)
    forms15 = aux_forms(kerr, al15, th15)
    print(f"  {dim[0]}^2 scene, kernel single pass (max_steps 200000, "
          f"sat_window 2048) vs two-pass driver:", flush=True)
    scene14 = {}
    for label in GRID_FORMS:
        row, one, probe = aux_scene(kerr, label, forms15[label], al15, th15,
                                    dim[1])
        scene14[label] = row
        if label == "order thin":
            order_one = dict(
                exited=(probe["flags"] & 6).ne(0).cpu().numpy(),
                status=one.status.cpu().numpy(),
                winding=one.extras[0].cpu().numpy())
        del one, probe
    del al15, th15, forms15
    # The Mosaic reject limit cycle of ROADMAP Queue 3: the 256^2 order
    # decomposition's pixel (171, 129), in the kernel and the plain loop.
    lane = 171 * d256[1] + 129
    probe = {}
    sl = slice(lane, lane + 1)
    order = forms256["order thin"]
    aux_trace(kerr, order, al256[sl], th256[sl], 200000, True,
              sat_window=2048, probe=probe)
    res_p, unconv_p = aux_trace(kerr, order, al256[sl].cpu(),
                                th256[sl].cpu(), 6000, False,
                                sat_window=2048, return_unconverged=True)
    print(f"  order decomposition, {d256[0]}^2 pixel (171, 129), alpha "
          f"{float(al256[lane]):.6f}: kernel attempts "
          f"{int(probe['attempts'][0])}, flags {int(probe['flags'][0])} "
          f"(2 saturation exit, 4 frozen-state exit); plain loop on the "
          f"CPU n_steps {int(res_p.n_steps)} of 6000, status "
          f"{int(res_p.status[0])}, step-capped {bool(unconv_p[0])}",
          flush=True)
    # The aux driver over the kernel and over the plain loop, bitwise
    # against the single pass, with a 64-attempt first pass.
    stokes = forms["stokes toroidal"]
    k_ms, rk = cuda_ms(lambda: aux_trace(kerr, stokes, al, th, AUX_STEPS,
                                         True, driver=True, pass1_steps=64),
                       3)
    p_ms, rp = PlainPool.result(jobs[14, "driver"], dev)
    probe = {}
    single = aux_trace(kerr, stokes, al, th, AUX_STEPS, True, probe=probe)
    _r, unc = aux_trace(kerr, stokes, al, th, 64, True,
                        return_unconverged=True)
    same = all(same_bits(a, b) for a, b in zip(
        (single.status, single.final_alpha, *single.extras),
        (rk.status, rk.final_alpha, *rk.extras)))
    g_drv = aux_compare(rk, rp, "stokes toroidal")
    g_drv.update(ms=k_ms, plain_ms=p_ms, bitwise_equal=same,
                 unconverged_64=int(unc.sum()),
                 attempts_sum=driver_attempts(probe["attempts"], 64))
    print(f"  aux driver (Stokes), {VOL_RAYS} random rays, pass1_steps 64, "
          f"kernel vs plain loop: {json.dumps(g_drv)}", flush=True)
    require(same and 0 < g_drv["unconverged_64"] <= 1024,
            "the aux driver differs from the single pass")
    require(g_drv["status_agree"] > 0.99 and max(g_drv["p99"]) < 1e-3,
            f"aux driver kernel vs plain gate: {g_drv}")

    # -- 15. the three renders through their entry points -----------------
    dim = VOL_DIM
    period = 2.0 * np.pi / abs(volumetric.keplerian_omega(1.0, 0.9, 6.0,
                                                           True))
    times = tuple(period * k / N_FRAMES for k in range(N_FRAMES))
    paths = {label: functools.partial(p15_render, label)
             for label in P15_PATHS}
    drivers = (kk.trace_rays_aux_two_pass, kk.trace_rays_spectral_two_pass)
    plains = (kerr_trace.trace_rays_aux, kerr_trace.trace_rays_spectral)
    launches, outs = {}, {}
    for label, render in paths.items():
        for c in (vk.trace_rays_aux_cuda, *drivers, *plains):
            c.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        out = render(dim, "cuda")                            # warmup
        runs = []
        for _ in range(3):
            out = render(dim, "cuda")
            runs.append(dict(out[-1]["timings"]))
        st = out[-1]
        best = max(st["total_rays"] / t["precompute"] for t in runs)
        n_kernel = vk.trace_rays_aux_cuda.launches
        n_driver = sum(c.launches for c in drivers)
        n_plain = sum(c.launches for c in plains)
        launches[label] = n_kernel
        launches[label + " driver"] = drivers[0].launches
        outs[label] = out
        row = dict(kernel_launches=n_kernel, driver_calls=n_driver,
                   plain_loop_calls=n_plain, best_rays_per_s=best,
                   peak_mib=torch.cuda.max_memory_allocated(dev) / 2**20,
                   captured=st["captured"],
                   integrator_steps=st["integrator_steps"], timings=runs)
        require(n_kernel == 8 and n_driver == 4 and n_plain == 0,
                f"{label}: {n_kernel} kernel launches, {n_driver} driver "
                f"calls, {n_plain} plain calls")
        require(st["total_rays"] == dim[0] * dim[1]
                and st["integrator_steps"] > 0, f"{label}: bad stats")
        if label == "polarized":
            _evpa, frac, inten, _st = out
            bright = inten > 1e-3 * inten.max()
            row.update(pol_frac_max=float(frac[bright].max()),
                       pol_frac_mean=float(frac[bright].mean()),
                       q_over_i=float(np.abs(st["Q"]).max() / inten.max()))
            require(np.isfinite(inten).all() and inten.max() > 0
                    and row["pol_frac_max"] <= P0 + 1e-4
                    and row["q_over_i"] > 0.05,
                    f"polarized: {row}")
        elif label.startswith("movie"):
            frames = out[0]
            lc = st["light_curve"]
            row.update(light_curve=lc.tolist(), t_max=st["t_max"],
                       modulation=float((lc.max() - lc.min())
                                        / (lc.max() + lc.min())))
            require(tuple(frames.shape) == (N_FRAMES, *dim)
                    and bool(torch.isfinite(frames).all())
                    and float(frames.min()) >= 0.0
                    and float(frames.max()) <= 1.0
                    and row["modulation"] > 0.01, f"{label}: {row}")
        else:
            layers = out[0]
            flux = st["flux_per_order"]
            total = layers.sum(dim=0).cpu().numpy()
            thin = state["thin_emission"]
            # The two traces carry other states (6 and 9 components), so
            # their error norms and steps differ. The pixels above the
            # bar are placed: on the near-axis lanes that either trace's
            # saturation or frozen-state exit ended (they leave at
            # another point of their path), within two pixels of a
            # captured ray, or by the ray's plane crossings.
            err = np.abs(total - thin) / thin.max()
            over = err > 1e-3
            exited = (state["thin_exited"] | order_one["exited"]).reshape(dim)
            shadow = (order_one["status"] != 1).reshape(dim)
            rim = np.zeros(dim, dtype=bool)
            for dy in range(-2, 3):
                for dx in range(-2, 3):
                    rim |= np.roll(shadow, (dy, dx), axis=(0, 1))
            crossings = np.rint(order_one["winding"]).reshape(dim)
            rest = over & ~exited & ~rim
            where = {"exit lanes": over & exited,
                     "shadow rim": over & ~exited & rim,
                     "three or more crossings": rest & (crossings >= 3),
                     "two crossings": rest & (crossings == 2),
                     "fewer crossings": rest & (crossings < 2)}
            placed = {}
            for name, mask in where.items():
                rows, cols = np.nonzero(mask)
                placed[name] = dict(
                    pixels=int(mask.sum()),
                    rows=[int(rows.min()), int(rows.max())] if rows.size
                    else [],
                    cols=[int(cols.min()), int(cols.max())] if cols.size
                    else [],
                    max=float(err[mask].max()) if rows.size else 0.0)
            row.update(flux_per_order=flux, gamma=st["gamma_estimates"],
                       partition_p999=float(np.percentile(err, 99.9)),
                       partition_p9999=float(np.percentile(err, 99.99)),
                       partition_over_1e3=int(over.sum()),
                       partition_over_1e3_placed=placed,
                       exit_lanes=int(exited.sum()),
                       rim_pixels=int(rim.sum()),
                       pixels_by_crossings=[int((crossings == k).sum())
                                            for k in range(4)],
                       partition_max=float(err.max()),
                       flux_total_rel=float(abs(total.sum() / thin.sum()
                                                - 1.0)))
            require(bool(torch.isfinite(layers).all())
                    and flux[0] > flux[1] > flux[2] > 0
                    and row["partition_p999"] < 1e-3
                    and row["partition_over_1e3"] < 1e-3 * over.size
                    and row["flux_total_rel"] < 1e-4, f"{label}: {row}")
        print(f"{label} {dim[0]}^2: {json.dumps(row)}; best {best:,.0f} "
              f"rays/s on {card}", flush=True)
    require(all(a < b for a, b in zip(
        outs["movie 8-frame absorbed"][1]["light_curve"],
        outs["movie 8-frame"][1]["light_curve"])),
        "absorption does not dim every movie frame")
    _f, st0 = volumetric.render_volumetric_movie(
        scene, dim, times, cfg, volumetric.RIAFConfig(spot_amp=0.0),
        device="cuda")
    lc0 = st0["light_curve"]
    flat = float((lc0.max() - lc0.min()) / lc0.max())
    print(f"movie with spot_amp 0: light curve spread {flat:.3e}",
          flush=True)
    require(flat == 0.0, f"a stationary flow's light curve varies: {flat}")
    scene90 = SceneConfig(M=1.0, a=0.9, r_obs_mult=R_OBS,
                          vertical_fov_deg=16.0)
    _e, _p, i90, s90 = polarization.render_polarized_volumetric(
        scene90, VOL_PLAIN_DIM, cfg, device="cuda")
    h = VOL_PLAIN_DIM[0]
    top, bottom = slice(1, h // 2), slice(h - 1, h // 2, -1)
    sym = {k: float(np.abs(s90[k][top] - sign * s90[k][bottom]).max()
                    / i90.max())
           for k, sign in (("I", 1.0), ("Q", 1.0), ("U", -1.0))}
    print(f"polarized {h}^2 at theta_obs 90 deg, mirror residuals / peak: "
          f"{json.dumps(sym)}", flush=True)
    require(max(sym.values()) < 0.02, f"no mirror symmetry: {sym}")

    d64 = VOL_CHECK_DIM
    checks = {}
    paths["decomposed x3 absorbed"] = functools.partial(
        p15_render, "decomposed x3 absorbed")
    for label, render in paths.items():
        og = render(d64, "cuda")
        oc = PlainPool.result(jobs[15, label], "cpu")[1]
        if label == "polarized":
            peak = oc[2].max()
            checks[label] = {k: float(np.median(np.abs(og[3][k] - oc[3][k]))
                                      / peak) for k in "IQU"}
            ok = max(checks[label].values()) < 1e-5
        elif label.startswith("movie"):
            checks[label] = dict(median=float(
                (og[0].cpu() - oc[0]).abs().median()))
            ok = checks[label]["median"] < 1e-4
        else:
            # Every order on its own, by phase 14's gates.
            checks[label] = order_numbers(
                og[0].cpu().numpy().astype(np.float64).reshape(N_ORDERS, -1),
                oc[0].numpy().astype(np.float64).reshape(N_ORDERS, -1))
            ok = order_gate(checks[label])
        require(ok, f"64^2 {label} card vs CPU: {checks[label]}")
    print(f"new modes check, 64^2 card vs CPU: {json.dumps(checks)}",
          flush=True)

    jax_file = VOL_JAX
    entries = []
    for label, name, source, path in (
            ("stokes toroidal", "kerr_dp45_stokes", STOKES_SOURCE,
             "polarized"),
            ("movie thin", "kerr_dp45_movie_thin",
             MOVIE_SOURCE.format("thin"), "movie 8-frame"),
            ("movie absorbed", "kerr_dp45_movie_absorbed",
             MOVIE_SOURCE.format("absorbed"), "movie 8-frame absorbed"),
            ("order thin", "kerr_dp45_orders", ORDER_SOURCE,
             "decomposed x3")):
        g, form = g14[label], forms[label]
        entries.append(kernel_entry(
            name, source, f"{jax_file}:276", launches[path], g["max_abs"],
            g["ms"], g["plain_ms"], VOL_RAYS,
            8 + 4 * len(form[2]) + 4 * (form[1] + 4),
            g["attempts_sum"] * extras_work(**form[4]), g,
            extras_label(form[4])))
        row = scene14[label]
        entries[-1].update(scene_single_ms=row["single_ms"],
                           scene_attempts_max=row["attempts_max"],
                           scene_exited=row["exited"])
    entries.append(kernel_entry(
        "trace_rays_aux_two_pass", VOL_DRIVERS, f"{jax_file}:421",
        launches["polarized driver"], g_drv["max_abs"], g_drv["ms"],
        g_drv["plain_ms"], VOL_RAYS, 8 + 16 + 4 * 7,
        g_drv["attempts_sum"] * extras_work(**stokes[4]),
        instance=extras_label(stokes[4])))
    return entries


def probe_phase(dev, card):
    """Phase 16; returns (the probe's kernels-line entry, the measured
    rates)."""
    import torch
    from light_path_tracer_tpu_torch.ops.cuda import peak_probe
    print("peak probe, kernel vs the same recurrence in torch (k = 64, "
          "4,097 elements):", flush=True)
    worst = {}
    for form, (_index, dtype, _ops) in peak_probe.FORMS.items():
        x = torch.linspace(0.1, 0.9, 4097, dtype=dtype, device=dev)
        got = peak_probe.chain_cuda(x, 64, form)
        want = peak_probe.chain_plain(x, 64, form)
        ulp = torch.finfo(dtype).eps
        bar = (4 * ulp if form == "sin"
               else 4 * 64 * ulp * float(want.abs().max()))
        worst[form] = float((got - want).abs().max())
        require(worst[form] <= bar, f"probe {form}: |d| {worst[form]} > "
                f"{bar}")
    print(f"  max |d|: {json.dumps(worst)}", flush=True)
    peak_probe.chain_cuda.launches = 0
    rates = peak_probe.measure_rates(dev)
    n_launch = peak_probe.chain_cuda.launches
    tera = {f: r["rate"] / 1e12 for f, r in rates.items()}
    library = ", ".join(f"{f[:-2]} {tera[f] * 1e3:.1f}" for f in rates
                        if f[:-4] in peak_probe.LIBRARY_FORMS)
    print(f"peak rates on {card} (marginal between two chain lengths, "
          f"{peak_probe.N_ELEMENTS} elements): FP32 FMA "
          f"{tera['fma32']:.2f} TFLOP/s (one chain a thread), "
          f"{tera['fma32x8']:.2f} TFLOP/s (eight), FP64 FMA "
          f"{tera['fma64']:.2f} TFLOP/s, mixed {tera['mix']:.2f} TFLOP/s, "
          f"sinf {tera['sin'] * 1e3:.1f} Gsin/s; library calls (eight "
          f"chains a thread, G calls/s): {library}; {json.dumps(rates)}",
          flush=True)
    require(n_launch == 12 * len(rates), f"probe launches {n_launch}")
    require(rates["fma32x8"]["rate"] > rates["fma64"]["rate"] > 1e12
            and all(tera[f] > 1e-3 for f in rates),
            f"implausible rates: {tera}")
    # The plain version at the timed shape, with a short chain.
    x = torch.full((peak_probe.N_ELEMENTS,), 0.5, device=dev)
    k_plain = 64
    plain_ms, _ = cuda_ms(lambda: peak_probe.chain_plain(x, k_plain,
                                                         "fma32x8"), 1)
    kernel_ms, _ = cuda_ms(lambda: peak_probe.chain_cuda(x, k_plain,
                                                         "fma32x8"), 5)
    entry = kernel_entry(
        "peak_probe", PROBE_SOURCE, "scripts/roofline.py:80", n_launch,
        worst["fma32x8"], kernel_ms, plain_ms, peak_probe.N_ELEMENTS, 8,
        bounds.Work(16 * k_plain * peak_probe.N_ELEMENTS,
                    {"flop": 8 * k_plain * peak_probe.N_ELEMENTS}))
    return entry, rates


F64_RAYS = 1024
F64_SOURCE = "light_path_tracer_tpu_torch/csrc/{}_f64.cu"


def f64_extras_gate(what, g, tau_scale=1.0):
    """Phase 17's gates on float64 kernel-vs-plain extras numbers g:
    status agreement > 0.999, every extra's p99 |d| / max < 1e-6 (tau
    against max(1, max |tau|))."""
    p99 = g.get("p99_em_bands", g.get("p99"))
    tau = g.get("p99_tau", 0.0) / max(tau_scale, 1.0)
    require(g["status_agree"] > 0.999 and max(p99) < 1e-6 and tau < 1e-6,
            f"phase 17 {what} gate: {g}")


def aux_outputs(res):
    """An aux-form result's outputs for a bitwise comparison."""
    return [res.status, res.final_alpha, *res.extras]


def f64_bitwise_gate(what, label, g, same):
    """Every float64 extras instance equals its plain float64 loop bit for
    bit (their float64 pow, csrc/lpt_pow_f64.cu, is built as PyTorch
    builds its own; the Stokes form's kernel sums the Levi-Civita
    contraction in the plain loop's order)."""
    g["bitwise_plain"] = same
    require(same, f"{what} {label}: the float64 kernel is not bitwise its "
            f"plain loop: {g}")


def f64_counters():
    """Every kernel wrapper and plain loop whose counts phase 17 reads."""
    from light_path_tracer_tpu_torch.ops import kerr_trace as tk
    from light_path_tracer_tpu_torch.ops import schwarzschild_trace as st
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    from light_path_tracer_tpu_torch.ops.cuda import schwarzschild_kernel
    from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk
    kernels = dict(kerr=kk.trace_rays_kerr_cuda, disk=kk.trace_disk_rays_cuda,
                   orbit=schwarzschild_kernel.trace_rays_schwarzschild_cuda,
                   volumetric=vk.trace_rays_volumetric_cuda,
                   aux=vk.trace_rays_aux_cuda)
    plains = (tk.trace_rays_kerr, tk.trace_disk_rays_kerr, tk.trace_rays_aux,
              tk.trace_rays_volumetric, tk.trace_rays_spectral,
              st.trace_rays_schwarzschild)
    return kernels, plains


# Phase 17's float64 renders at 64^2 (each entry-point family), run on
# the card in the parent and on the CPU in PlainPool's children.
P17_RENDERS = ("shadow", "shadow aa", "lensed", "disk", "volumetric",
               "spectrum", "movie", "movie absorbed", "decomposed",
               "polarized")


def p17_families(scene_v):
    """label -> (the kernel wrapper's key in f64_counters, render(device))
    of phase 17's float64 renders; scene_v: the volumetric scene of phase
    11."""
    from light_path_tracer_tpu_torch import (aa, disk, pipeline,
                                             polarization, volumetric)
    from light_path_tracer_tpu_torch.utils.config import (RenderConfig,
                                                          SceneConfig)
    cfg = RenderConfig(dtype="float64")
    d64 = (64, 64)
    scene_k = SceneConfig(M=1.0, a=0.9, vertical_fov_deg=12.0)
    scene_s = SceneConfig(M=1.0, r_obs_mult=R_OBS, vertical_fov_deg=12.0)
    scene_d = SceneConfig(M=1.0, a=0.9, r_obs_mult=R_OBS,
                          theta_obs=THETA_DISK)
    src = np.random.default_rng(4).random((64, 64, 3)).astype(np.float32)
    period = 2.0 * np.pi / abs(volumetric.keplerian_omega(1.0, 0.9, 6.0,
                                                           True))
    times = tuple(period * k / 3 for k in range(3))
    riaf3, freqs3 = scene_forms()["spectral 3-band"]
    blob = volumetric.RIAFConfig(spot_amp=8.0)
    return {
        "shadow": ("kerr", lambda device: pipeline.render_shadow(
            scene_k, d64, cfg, device=device)),
        "shadow aa": ("kerr", lambda device: aa.render_shadow_aa(
            scene_k, d64, cfg, aa_samples=4, device=device)),
        "lensed": ("orbit", lambda device: pipeline.render_scene(
            scene_s, src, RenderConfig(dtype="float64",
                                       sampling="bilinear"),
            device=device)),
        "disk": ("disk", lambda device: disk.render_disk(
            scene_d, d64, cfg, device=device)),
        "volumetric": ("volumetric", lambda device: (
            volumetric.render_volumetric(scene_v, d64, cfg, device=device))),
        "spectrum": ("aux", lambda device: (
            volumetric.render_volumetric_spectrum(
                scene_v, d64, freqs3, cfg, riaf3, device=device))),
        "movie": ("aux", lambda device: volumetric.render_volumetric_movie(
            scene_v, d64, times, cfg, blob, device=device)),
        "movie absorbed": ("aux", lambda device: (
            volumetric.render_volumetric_movie(
                scene_v, d64, times, cfg,
                volumetric.RIAFConfig(spot_amp=8.0, alpha0=0.3),
                device=device))),
        "decomposed": ("aux", lambda device: (
            volumetric.render_volumetric_decomposed(
                scene_v, d64, cfg, n_orders=N_ORDERS, device=device))),
        "polarized": ("aux", lambda device: (
            polarization.render_polarized_volumetric(
                scene_v, d64, cfg, device=device)))}


def p17_render64(label, scene_v, device):
    """One of phase 17's float64 64^2 renders on `device`."""
    return p17_families(scene_v)[label][1](device)


def float64_phase(dev, card, ctx):
    """Phase 17: every float64 kernel instance against the plain float64
    loop, the float64 renders of every entry-point family on the card
    against the CPU (the float64 path: its launches are the f64 entries'
    counts), and the float32 kernel against the float64 one on the main
    path's rays. Returns the kernels-line entries of the float64
    instances."""
    import torch
    from light_path_tracer_tpu_torch import camera, pipeline
    from light_path_tracer_tpu_torch.models import (Kerr, ReissnerNordstrom,
                                                    Schwarzschild)
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    from light_path_tracer_tpu_torch.utils.config import (RenderConfig,
                                                          SceneConfig)
    kerr = Kerr(M=1.0, a=0.9)
    n = F64_RAYS
    rows = {}
    print(f"float64 kernel instances vs the plain float64 loop (gates: "
          f"status > 0.999; p99 |d final_alpha| < 1e-6 rad, orbit 1e-8; "
          f"extras p99 |d| / max < 1e-6; disk median |d r_hits[0]| < 1e-6 "
          f"M; orders by flux):", flush=True)
    # The plain float64 loops of the Kerr, disk and orbit checks, queued
    # to the children first.
    pool = ctx["pool"]
    al, th, rf = (x[:n] for x in ctx["kerr_rays"])
    al_d, th_d = (x[:n].double() for x in ctx["disk_rays"])
    orbits = {}
    for metric in (Schwarzschild(M=1.0), ReissnerNordstrom(M=1.0, Q=0.6)):
        ac_o = metric.alpha_crit(R_OBS)
        rng = np.random.default_rng(1)
        orbits[metric] = torch.tensor(np.concatenate(
            [[0.0], rng.uniform(0.2 * ac_o, 4 * ac_o, n)]),
            dtype=torch.float64, device=dev)
    jobs = dict(
        kerr=plain_job(pool, "kerr", kerr, al.double(), th.double(), rf,
                       GATE_STEPS),
        disk=plain_job(pool, "disk", kerr, al_d, th_d, GATE_STEPS,
                       ctx["opaque"], 2),
        **{type(mt).__name__: plain_job(pool, "orbit", mt, a)
           for mt, a in orbits.items()})
    for label in P17_RENDERS:
        jobs["cpu", label] = pool.submit("p17_render64", label,
                                         ctx["state"]["scene"], "cpu",
                                         on="cpu")
    g = both_versions(f"Kerr, {n} random rays", kerr, al.double(),
                      th.double(), rf, GATE_STEPS, 5, job=jobs["kerr"])
    require(g["status_agree"] > 0.999 and g["p99"] < 1e-6,
            f"phase 17 Kerr gate: {g}")
    rows["kerr"] = g
    g = disk_both(f"disk, {n} random rays, opaque", kerr, al_d, th_d,
                  GATE_STEPS, ctx["opaque"], 2, 5, job=jobs["disk"])
    require(g["status_agree"] > 0.999 and g["nhits_agree"] > 0.999
            and g["median_dr"] < 1e-6, f"phase 17 disk gate: {g}")
    rows["disk"] = g
    for metric, al_o in orbits.items():
        label = type(metric).__name__
        g, rk = orbit_both(f"{label} {n + 1} rays", metric, al_o, 20,
                           job=jobs[label])
        require(g["status_agree"] > 0.999 and g["p99"] < 1e-8
                and int(rk.status[0]) == 0, f"phase 17 {label} gate: {g}")
        rows.setdefault("orbit", g)

    # The extras forms on phase 11's and phase 14's rays, against the
    # plain float64 runs those phases made.
    st = ctx["state"]
    al_v, th_v = st["al"].double(), st["th"].double()
    for label, (riaf, freqs) in volumetric_forms().items():
        rp64, plain_ms = st["plain64_11"][label]
        probe = {}
        ms, rk = cuda_ms(lambda: extras_trace(
            kerr, riaf, freqs, al_v, th_v, VOL_STEPS, True,
            sat_window=VOL_WINDOW, probe=probe), 3)
        g = extras_compare(rk, rp64)
        g.update(ms=ms, plain_ms=plain_ms,
                 attempts_sum=int(probe["attempts"].to(torch.int64).sum()),
                 slowest_attempts=int(probe["attempts"].max()))
        tau = max((float(t.abs().max()) for t in rp64[2]), default=1.0)
        g["bitwise_plain"] = extras_bitwise(rk, rp64)
        print(f"  {label}, {VOL_RAYS} rays: {json.dumps(g)}", flush=True)
        f64_extras_gate(label, g, tau)
        f64_bitwise_gate("phase 17", label, g, g["bitwise_plain"])
        rows[label] = g
    forms = ctx["state"]["forms14"]
    for label, form in forms.items():
        form = (form[0], form[1], tuple(a.double() for a in form[2]),
                *form[3:])
        width = len(form[3])
        kw = dict(sat_window=AUX_WINDOW)
        plain64 = st["g14"][label]["plain64"]
        if plain64 is None:
            plain64 = PlainPool.result(st["jobs14"][14, label, 1], dev)
        plain_ms, rp64 = plain64
        probe = {}
        ms, rk = cuda_ms(lambda: aux_trace(kerr, form, al_v, th_v, AUX_STEPS,
                                           True, probe=probe, **kw), 3)
        g = aux_compare(rk, rp64, label, width)
        g.update(ms=ms, plain_ms=plain_ms,
                 attempts_sum=int(probe["attempts"].to(torch.int64).sum()),
                 slowest_attempts=int(probe["attempts"].max()),
                 bitwise_plain=bitwise_list(aux_outputs(rk),
                                            aux_outputs(rp64)))
        print(f"  {label}, {VOL_RAYS} rays: {json.dumps(g)}", flush=True)
        if label.startswith("order"):
            require(g["status_agree"] > 0.999 and order_gate(g)
                    and g["p95_m"] < 5e-3, f"phase 17 {label} gate: {g}")
        else:
            f64_extras_gate(label, g)
        f64_bitwise_gate("phase 17", label, g, g["bitwise_plain"])
        rows[label] = g

    # The entry points in float64 at 64^2, on the card and on the CPU:
    # the card's renders launch only float64 instances and no plain loop.
    # The CPU renders run in the children (queued at this phase's start).
    kernels, plains = f64_counters()
    families = p17_families(ctx["state"]["scene"])
    f64_launches, checks = {}, {}
    for label, (kernel, render) in families.items():
        for c in (*kernels.values(), *plains):
            c.launches = 0
            if hasattr(c, "launches_f64"):
                c.launches_f64 = 0
        og = render("cuda")
        torch.cuda.synchronize()
        n64 = kernels[kernel].launches_f64
        n32 = sum(c.launches for c in kernels.values())
        n_plain = sum(c.launches for c in plains)
        f64_launches[label] = n64
        require(n64 > 0 and n32 == 0 and n_plain == 0,
                f"phase 17 {label} float64 render: {n64} float64 launches, "
                f"{n32} float32, {n_plain} plain")
        _ms, oc = PlainPool.result(jobs["cpu", label], "cpu")
        if label in ("shadow", "shadow aa"):
            c = dict(pixels_equal=float((og[0].cpu() == oc[0]).float()
                                        .mean()))
            ok = c["pixels_equal"] >= 0.999
        elif label == "lensed":
            calm = ((og.precompute.winding.cpu().to(torch.int32) < 2)
                    & (oc.precompute.winding.to(torch.int32) < 2))
            masks = (torch.isnan(og.precompute.final_alpha).cpu()
                     == torch.isnan(oc.precompute.final_alpha))
            c = dict(mask_agree=float(masks.float().mean()),
                     rmse=float(((og.image.cpu() - oc.image)[calm] ** 2)
                                .mean().sqrt()))
            ok = c["mask_agree"] >= 0.999 and c["rmse"] < 1e-6
        elif label == "disk":
            mg, mc = og[0].cpu() > 0, oc[0] > 0
            both = mg & mc
            c = dict(mask_agree=float((mg == mc).float().mean()),
                     median=float((og[0].cpu() - oc[0]).abs()[both]
                                  .median()))
            ok = c["mask_agree"] >= 0.999 and c["median"] < 1e-6
        elif label == "decomposed":
            c = order_numbers(
                og[0].cpu().numpy().astype(np.float64).reshape(N_ORDERS, -1),
                oc[0].numpy().astype(np.float64).reshape(N_ORDERS, -1))
            ok = order_gate(c)
        elif label == "polarized":
            peak = oc[2].max()
            c = {k: float(np.median(np.abs(og[3][k] - oc[3][k])) / peak)
                 for k in "IQU"}
            ok = max(c.values()) < 1e-8
        else:
            c = dict(median=float((og[0].cpu() - oc[0]).abs().median()),
                     max=float((og[0].cpu() - oc[0]).abs().max()))
            ok = c["median"] < 1e-6
        c["float64_launches"] = n64
        checks[label] = c
        require(ok, f"phase 17 64^2 float64 {label} card vs CPU: {c}")
    print(f"float64 renders, 64^2 card vs CPU: {json.dumps(checks)}",
          flush=True)

    # The float32 kernel against the float64 one on the main path's rays:
    # the north star's final-alpha bar (1e-3 rad RMSE).
    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=R_OBS)
    dim = ctx["main_dim"]
    fov = camera.fov_from_vertical(scene.vertical_fov, dim)
    res = {}
    for dtype in ("float32", "float64"):
        al_m, th_m, rf_m, _rows = pipeline.trace_inputs(
            scene, RenderConfig(dtype=dtype), dim, fov, dev)
        ms, r = cuda_ms(lambda: kk.trace_rays_kerr_cuda(
            kerr, R_OBS, al_m, th_m, np.pi / 2, rf_m, LAMBDA_MAX, 200000), 3)
        probe = {}
        kk.trace_rays_kerr_cuda(kerr, R_OBS, al_m, th_m, np.pi / 2, rf_m,
                                LAMBDA_MAX, 200000, probe=probe)
        res[dtype] = (r, ms, probe["attempts"])
    (r32, ms32, a32), (r64, ms64, a64) = res["float32"], res["float64"]
    s32, s64 = r32.status.cpu().numpy(), r64.status.cpu().numpy()
    esc = (s32 == 1) & (s64 == 1)
    d = (r32.final_alpha.double() - r64.final_alpha).cpu().numpy()[esc]
    main = dict(rays=int(s32.size), status_agree=float((s32 == s64).mean()),
                escaped_both=int(esc.sum()),
                final_alpha_rmse=float(np.sqrt(np.mean(d * d))),
                final_alpha_max=float(np.abs(d).max()),
                ms_float32=ms32, ms_float64=ms64, ratio=ms64 / ms32,
                attempts_sum_float32=int(a32.to(torch.int64).sum()),
                attempts_sum_float64=int(a64.to(torch.int64).sum()),
                slowest_float64=int(a64.max()))
    main["meets_1e-3_rad"] = main["final_alpha_rmse"] < 1e-3
    print(f"float32 vs float64 kernel, {dim[0]}^2 main-path rays: "
          f"{json.dumps(main)} on {card}", flush=True)
    require(main["status_agree"] > 0.99
            and np.isfinite(main["final_alpha_rmse"]),
            f"float32 vs float64 on the main path: {main}")

    # The float64 instances' kernels-line entries: the launches of the
    # float64 renders, the times of the comparisons above, the bounds in
    # float64.
    shadow_work = kerr_work("float64")
    k, dk, ok_ = rows["kerr"], rows["disk"], rows["orbit"]
    jv = f"{VOL_JAX}"
    entries = [
        kernel_entry("kerr_dp45_f64", F64_SOURCE.format("kerr_dp45"),
                     REPLACES, f64_launches["shadow"], k["max_abs"], k["ms"],
                     k["plain_ms"], k["n"], 17 + 16,
                     k["attempts_sum"] * shadow_work, k),
        kernel_entry("kerr_dp45_disk_f64", F64_SOURCE.format("kerr_dp45"),
                     f"{JAX_KERNELS}:316", f64_launches["disk"],
                     dk["max_dr"], dk["ms"], dk["plain_ms"], dk["n"],
                     16 + 28 + 32, dk["attempts_sum"] * shadow_work, dk),
        kernel_entry("schwarzschild_rk4_f64",
                     F64_SOURCE.format("schwarzschild_rk4"), ORBIT_REPLACES,
                     f64_launches["lensed"], ok_["max_abs"], ok_["ms"],
                     ok_["plain_ms"], ok_["n"], 8 + 20,
                     ok_["attempts_sum"] * orbit_work(dtype="float64"),
                     ok_)]
    n_bands = len(scene_forms()["spectral 3-band"][1])
    for label, name, fam, desc, nbytes in (
            ("thin", "kerr_dp45_extras_f64", "volumetric",
             dict(kind="thin"), 16 + 8 + 13),
            ("spectral 3-band", "kerr_dp45_extras_spectral_f64", "spectrum",
             dict(kind="spectral", width=n_bands),
             16 + 8 * (1 + n_bands) + 13)):
        g = rows[label]
        inst = ("kerr_dp45_extras<VolThin<double>>" if label == "thin" else
                f"kerr_dp45_extras<Spectral<{n_bands},double>>")
        entries.append(kernel_entry(
            name, F64_SOURCE.format("kerr_dp45_extras"), f"{jv}:53"
            if label == "thin" else f"{jv}:276", f64_launches[fam],
            g["max_abs_em"], g["ms"], g["plain_ms"], VOL_RAYS, nbytes,
            g["attempts_sum"] * extras_work(**desc, dtype="float64"), g,
            inst))
    for label, name, fam in (
            ("stokes toroidal", "kerr_dp45_stokes", "polarized"),
            ("movie thin", "kerr_dp45_movie_thin", "movie"),
            ("movie absorbed", "kerr_dp45_movie_absorbed", "movie absorbed"),
            ("order thin", "kerr_dp45_orders", "decomposed")):
        g, form = rows[label], forms[label]
        entries.append(kernel_entry(
            f"{name}_f64", F64_SOURCE.format(name), f"{jv}:276",
            f64_launches[fam], g["max_abs"], g["ms"], g["plain_ms"],
            VOL_RAYS, 16 + 8 * len(form[2]) + 8 * form[1] + 13,
            g["attempts_sum"] * extras_work(**form[4], dtype="float64"), g,
            extras_label(form[4], "double")))
    return entries


def cycle_phase(card):
    """Phase 18: the exact-cycle exit bitwise against the run with the
    exit off, and the lanes counted by kind, on the config-4 grids, the
    1024^2 Kerr shadow, the volumetric scene's 1024^2 and 256^2 grids for
    every form of phases 12 and 14, and the 256^2 order lane (171, 129)
    (scripts/torch_cycle_census.py). Returns the census rows."""
    import torch
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "scripts"))
    from torch_cycle_census import census
    print(f"exact-cycle exit vs exit off, bitwise, on {card}:", flush=True)
    rows = census(torch.device("cuda", 0))
    bad = [k for k, r in rows.items() if not r.get("bitwise_equal", True)]
    require(not bad, f"the cycle exit changed the outputs of {bad}")
    return rows


# The rays that nvcc's contraction of a*b + c into FMA ended otherwise
# than the reference (ROADMAP Queue 3 #1, #4), now built without it: row
# 959 of config 4's aligned grid, pinned to JAX's (status, n_hits,
# attempts) by tests/test_torch_config4_ray.py; the quarter-offset grid's
# lanes that froze on the card with contraction and the 256^2 order
# decomposition's lane (171, 129) (Order<3>, thin), each held to the plain
# loop on the CPU, which tests/test_torch_config4_ray.py and
# tests/test_torch_orders.py pin to JAX.
ALIGNED_PINS = {(959, 511): (1, 0, 51), (959, 510): (1, 0, 51),
                (959, 512): (1, 0, 17)}
# The quarter-offset lanes, capped at QUARTER_CAP attempts in both (three
# run to the cap in the plain loop and in JAX). OPEN_LANES end otherwise
# on the card than in the plain loop (ROADMAP Queue 3 #1): printed, not
# gated; so is the order lane's attempt count (captured in 148 on the
# card, 144 in the plain loop, 150 in JAX: Queue 3 #4, #6).
QUARTER_LANES = ((181, 512), (233, 512), (447, 512), (450, 512),
                 (798, 512), (950, 511), (978, 511))
OPEN_LANES = ((233, 512), (447, 512))
QUARTER_CAP = 1000
ORDER_LANE = (171, 129)


def p19_grid(offset, dev):
    """Config 4's 1024^2 (alpha, theta) grid at a pixel offset, float32 on
    `dev`, flattened."""
    import torch
    from light_path_tracer_tpu_torch import camera
    dim = (1024, 1024)
    fov4 = camera.fov_from_vertical(np.radians(40.0), dim)
    f32 = dict(dtype=torch.float32, device=dev)
    return (camera.build_alpha_lookup(dim, fov4, pixel_offset=offset,
                                      **f32).reshape(-1),
            camera.build_theta_lookup(dim, fov4, pixel_offset=offset,
                                      **f32).reshape(-1))


def p19_plane():
    """Config 4's opaque equatorial disk plane."""
    from light_path_tracer_tpu_torch import disk
    return (disk.r_isco(1.0, 0.9), disk.DiskConfig().r_out,
            float(np.pi / 2), True)


def p19_lane_plain(al, th, max_steps):
    """The plain loop on one config-4 lane (phase 19), in a PlainPool
    child on the CPU: (status, n_hits, n_steps)."""
    from light_path_tracer_tpu_torch.models import Kerr
    from light_path_tracer_tpu_torch.ops import kerr_trace
    rp = kerr_trace.trace_disk_rays_kerr(
        Kerr(M=1.0, a=0.9), R_OBS, al, th, THETA_DISK, LAMBDA_MAX,
        max_steps, p19_plane(), 2)
    return int(rp.status[0]), int(rp.n_hits[0]), int(rp.n_steps)


def queue_phase19(pool, dev):
    """Phase 19's plain loops on the QUARTER_LANES, one lane a job on the
    CPU in PlainPool's children (queued at phase 18's start; four of the
    seven run to QUARTER_CAP, which held the parent ~60 s)."""
    al, th = p19_grid((0.25, 0.25), dev)
    return {(r, c): pool.submit("p19_lane_plain",
                                al[r * 1024 + c:r * 1024 + c + 1],
                                th[r * 1024 + c:r * 1024 + c + 1],
                                QUARTER_CAP, on="cpu")
            for r, c in QUARTER_LANES}


def reference_phase(dev, card, lane_jobs):
    """Phase 19: the rays of ALIGNED_PINS, QUARTER_LANES and ORDER_LANE on
    the card against their pins; the in-kernel extraction against
    finalize_angles on the main path's final states; the Kerr kernel's
    warp step sum and unconverged flags against torch's from the probe,
    on the main path's 524,288 rays (float32 and float64) and on the
    aligned and quarter-offset config-4 grids, with the wrapper's time.
    lane_jobs: queue_phase19's plain loops on the QUARTER_LANES."""
    import torch
    from light_path_tracer_tpu_torch import camera, volumetric
    from light_path_tracer_tpu_torch.models import Kerr
    from light_path_tracer_tpu_torch.ops import kerr_trace
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    from light_path_tracer_tpu_torch.pipeline import trace_inputs
    from light_path_tracer_tpu_torch.utils.config import (RenderConfig,
                                                          SceneConfig)
    kerr = Kerr(M=1.0, a=0.9)
    dim = (1024, 1024)
    f32 = dict(dtype=torch.float32, device=dev)
    plane = p19_plane()
    grids = {label: p19_grid(off, dev) for label, off in (
        ("aligned", (0.0, 0.0)), ("quarter-offset", (0.25, 0.25)))}
    print(f"the reference's rays on the card, and the Kerr kernel's "
          f"booking, on {card}:", flush=True)

    def disk_ray(label, r, c, max_steps, plain):
        al, th = grids[label]
        i = r * dim[1] + c
        pr = {}
        rk = kk.trace_disk_rays_cuda(kerr, R_OBS, al[i:i + 1], th[i:i + 1],
                                     THETA_DISK, LAMBDA_MAX, max_steps,
                                     plane, 2, probe=pr)
        row = dict(grid=label, ray=(r, c), max_steps=max_steps,
                   status=int(rk.status[0]), n_hits=int(rk.n_hits[0]),
                   attempts=int(pr["attempts"][0]))
        if plain:
            _ms, row["plain"] = PlainPool.result(lane_jobs[r, c], "cpu")
            row["open"] = (r, c) in OPEN_LANES
        print(f"  {json.dumps(row)}", flush=True)
        return row

    for (r, c), pin in ALIGNED_PINS.items():
        row = disk_ray("aligned", r, c, 200000, False)
        require((row["status"], row["n_hits"], row["attempts"]) == pin,
                f"phase 19: config-4 ray ({r}, {c}) ends as {row}, not as "
                f"JAX's (status, n_hits, attempts) {pin}")
    d = (256, 256)
    fov = camera.fov_from_vertical(np.radians(16.0), d)
    lane = ORDER_LANE[0] * d[1] + ORDER_LANE[1]
    al = camera.build_alpha_lookup(d, fov, **f32).reshape(-1)[lane:lane + 1]
    th = camera.build_theta_lookup(d, fov, **f32).reshape(-1)[lane:lane + 1]
    order = volumetric.make_order_transfer(kerr, volumetric.RIAFConfig(), 3)
    form = (order, 4, (), (1, 2, 3), 0)
    probe = {}
    rk = aux_trace(kerr, form, al, th, 200000, True, sat_window=2048,
                   probe=probe)
    rp = aux_trace(kerr, form, al.cpu(), th.cpu(), 6000, False,
                   sat_window=2048)
    row = dict(ray=ORDER_LANE, status=int(rk.status[0]),
               attempts=int(probe["attempts"][0]),
               flags=int(probe["flags"][0]),
               plain=(int(rp.status[0]), int(rp.n_steps)))
    print(f"  256^2 order decomposition lane: {json.dumps(row)}", flush=True)
    require(row["status"] == row["plain"][0] == -1,
            f"phase 19: the order lane {ORDER_LANE} ends as {row}, not "
            f"captured as in the plain loop")

    # The in-kernel extraction against finalize_angles on the kernel's own
    # final states (the probe's raw state, status and p_phi).
    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=R_OBS)
    cfg = RenderConfig()
    fov = camera.fov_from_vertical(scene.vertical_fov, dim)
    al, th, rf, _rows = trace_inputs(scene, cfg, dim, fov, dev)
    for dtype in (torch.float32, torch.float64):
        a, t = al.to(dtype), th.to(dtype)
        probe = {}
        res = kk.trace_rays_kerr_cuda(kerr, R_OBS, a, t, np.pi / 2, rf,
                                      LAMBDA_MAX, cfg.max_steps,
                                      probe=probe)
        fa, nh, st = kerr_trace.finalize_angles(
            kerr, probe["state"], torch.full_like(a, -1.0), probe["p_phi"],
            probe["raw_status"])
        both = torch.isfinite(fa) & torch.isfinite(res.final_alpha)
        d_alpha = float((fa - res.final_alpha)[both].abs().max())
        row = dict(dtype=str(dtype), status_equal=bool(torch.equal(
                       st, res.status)),
                   n_half_equal=bool(torch.equal(
                       nh, res.n_half_orbits)),
                   nan_equal=bool(torch.equal(torch.isnan(fa), torch.isnan(
                       res.final_alpha))),
                   bitwise=same_bits(fa, res.final_alpha),
                   max_abs_d_alpha=d_alpha)
        print(f"  in-kernel extraction vs finalize_angles, main-path rays: "
              f"{json.dumps(row)}", flush=True)
        bar = 1e-6 if dtype == torch.float32 else 1e-13
        require(row["status_equal"] and row["n_half_equal"]
                and row["nan_equal"] and d_alpha <= bar,
                f"phase 19: the in-kernel extraction differs from "
                f"finalize_angles: {row}")

    # The kernel's warp step sum and flags against torch's from the probe.
    cases = [(f"main-path rays {tag}", lambda pr, dt=dt: (
        kk.trace_rays_kerr_cuda(kerr, R_OBS, al.to(dt), th.to(dt), np.pi / 2,
                                rf, LAMBDA_MAX, cfg.max_steps, probe=pr,
                                return_unconverged=True)))
             for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64"))]
    for label, (ga, gt) in grids.items():
        cases.append((f"config-4 {label} grid f32",
                      lambda pr, ga=ga, gt=gt: kk.trace_disk_rays_cuda(
                          kerr, R_OBS, ga, gt, THETA_DISK, LAMBDA_MAX,
                          200000, plane, 2, return_unconverged=True,
                          probe=pr)))
    rows = {}
    for label, run in cases:
        pr = {}
        res, unc = run(pr)
        ms, _ = cuda_ms(lambda: run(None), 3)
        row = dict(wrapper_ms=ms, warp_step_sum=int(res.n_steps),
                   warp_step_sum_torch=int(kerr_trace.warp_step_sum(
                       pr["attempts"])),
                   flags_equal=bool(torch.equal(
                       unc, pr["raw_status"] == kerr_trace.RUNNING)))
        rows[label] = row
        print(f"  Kerr kernel's booking, {label}: {json.dumps(row)}",
              flush=True)
        require(row["flags_equal"] and row["warp_step_sum"]
                == row["warp_step_sum_torch"],
                f"phase 19: the Kerr kernel's warp step sum or flags differ "
                f"from torch's on {label}: {row}")

    # Last, so that the lanes' plain loops in the children have run.
    for r, c in QUARTER_LANES:
        row = disk_ray("quarter-offset", r, c, QUARTER_CAP, True)
        require(row["open"] or (row["status"], row["n_hits"],
                                row["attempts"]) == tuple(row["plain"]),
                f"phase 19: quarter-offset lane ({r}, {c}) ends as {row}, "
                f"not as the plain loop")
    return rows


# Config 5 (bench.py:168-226): the 4k Kerr a=0.9 shadow at 4 jittered
# samples a pixel with the mirror fold, 4 x 1,081 x 3,840 = 16,604,160
# traced rays; the small grid and the CPU side's attempt cap of its
# card-vs-CPU check.
DIM5 = (2160, 3840)
AA5 = 4
SMALL5 = (48, 64)
SMALL5_STEPS = 4096
# The sample of the stacked rays that phase 20 holds against the plain
# loop: SAMPLE5 random rays a pass-sized chunk, the SLOWEST5 slowest of
# each pass-sized and each sorted chunk, and the AXIS5 columns each side
# of the polar axis in every row; both sides capped at SAMPLE5_STEPS
# attempts (the plain loop costs ~15 ms an iteration whatever the batch,
# and a lane that never ends runs to the cap in it; only the exit-ended
# lanes pass 512 attempts), the driver's first pass at SAMPLE5_PASS1.
SAMPLE5 = 4096
SLOWEST5 = 64
AXIS5 = 3
SAMPLE5_STEPS = 512
SAMPLE5_PASS1 = 256
# |alpha / alpha_crit - 1| bands of phase 20's split of the attempts.
BANDS5 = (0.0, 0.02, 0.1, 0.5, float("inf"))


def attempt_split(alphas, attempts, ac, groups):
    """Rays and attempts by |alpha / alpha_crit - 1| band (BANDS5) in each
    group (name -> bool mask): each band's share of the group's rays and
    its mean attempts a ray."""
    rel = (alphas.double() / ac - 1.0).abs()
    a = attempts.double()
    out = {}
    for name, mask in groups.items():
        total = max(int(mask.sum()), 1)
        bands = []
        for lo, hi in zip(BANDS5[:-1], BANDS5[1:]):
            m = mask & (rel >= lo) & (rel < hi)
            k = int(m.sum())
            bands.append(dict(band=[lo, hi if hi != float("inf") else None],
                              ray_share=k / total,
                              mean_attempts=float(a[m].mean()) if k else 0.0))
        out[name] = dict(rays=int(mask.sum()),
                         mean_attempts=float(a[mask].mean()), bands=bands)
    return out


def p20_plain_driver(*args):
    """Phase 20's two-pass driver over the plain loop on the sample (a
    PlainPool job)."""
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    return kk.trace_rays_kerr_two_pass(*args, pass1_steps=SAMPLE5_PASS1,
                                       trace_fn=kk.trace_rays_kerr_plain)


def config5_phase(dev, card, main, pool):
    """Phase 20: config 5 through render_shadow_aa, the chunk rule on the
    card, the Kerr kernel and its driver against the plain loop on a
    sample of config 5's own rays, adaptive against uniform AA, and the
    AA entry points on the card against the CPU. main: the 1024^2 main
    path's rays, refine flags, per-ray attempts and kernel ms (phase 3),
    for the split of the attempts. The plain loop and the driver over it
    run on the sample in PlainPool's children, queued when the sample is
    drawn and read at the phase's end. Returns the config-5 render's
    launches of the Kerr kernel and of its driver, and their kernels-line
    entries at config 5's shapes."""
    import torch
    from light_path_tracer_tpu_torch import aa, adaptive, camera
    from light_path_tracer_tpu_torch.ops import kerr_trace
    from light_path_tracer_tpu_torch.ops.batch import (difficulty_order,
                                                       trace_batch)
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    from light_path_tracer_tpu_torch.utils.config import (RenderConfig,
                                                          SceneConfig)
    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=R_OBS)
    cfg = RenderConfig()
    metric = scene.metric()
    height, width = DIM5
    rows = height // 2 + 1
    offsets = aa.aa_offsets(AA5)
    fov = camera.fov_from_vertical(scene.vertical_fov, DIM5)
    kernel, driver = kk.trace_rays_kerr_cuda, kk.trace_rays_kerr_two_pass
    plain = kerr_trace.trace_rays_kerr
    slots = kk.SLOTS

    def render():
        return aa.render_shadow_aa(scene, DIM5, cfg, aa_samples=AA5,
                                   device="cuda")

    # -- (a) the render: a warm-up and 3 timed runs ----------------------
    kernel.launches = driver.launches = plain.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    img, st = render()
    runs = []
    for _ in range(3):
        img, st = render()
        runs.append(st["timings"]["precompute"])
    launches = dict(kernel=kernel.launches, driver=driver.launches)
    plains = plain.launches
    best = min(runs)
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    print(f"config 5 (4k Kerr a=0.9, {AA5}x AA): kernel launches "
          f"{launches['kernel']}, two-pass driver calls "
          f"{launches['driver']}, plain-loop calls {plains}, traced_rays "
          f"{st['traced_rays']}, precompute of each run (s) "
          f"{json.dumps(runs)}, peak device memory {peak:.1f} MiB",
          flush=True)
    print(f"config 5: best precompute {best:.4f} s, "
          f"kerr_a0.9_4k_aa4_rays_per_sec {height * width * AA5 / best:,.0f}"
          f", traced rays/s {st['traced_rays'] / best:,.0f} on {card}",
          flush=True)
    require(launches["kernel"] > 0 and launches["driver"] > 0
            and plains == 0, f"config 5: {launches} kernel launches and "
            f"driver calls, {plains} plain calls")
    require(st["traced_rays"] == AA5 * rows * width,
            f"config 5 traced_rays {st['traced_rays']}")
    require(tuple(img.shape) == DIM5 and img.dtype == torch.float32
            and bool(torch.isfinite(img).all()), "config 5: bad image")
    quarters = img * AA5
    require(bool(torch.equal(quarters, quarters.round()))
            and float(img.min()) >= 0.0 and float(img.max()) <= 1.0,
            "config 5: a pixel is not a coverage k/4")
    require(bool(torch.equal(img[rows:], img[1:height - rows + 1].flip(0))),
            "config 5: the mirror rows are not copies")
    ac = metric.alpha_crit(R_OBS)
    alpha = camera.build_alpha_lookup(DIM5, fov, device=dev)
    outside = int(((img < 1.0) & (alpha >= 1.01 * ac)).sum())
    frac = (img > 0.0) & (img < 1.0)
    n_frac = int(frac.sum())
    lonely = int((frac & (adaptive._neighbor_max_diff(img) == 0.0)).sum())
    share = n_frac / img.numel()
    print(f"config 5 image: captured-sample px {int((img < 1.0).sum())}, "
          f"outside 1.01 alpha_crit {outside}; fractional px {n_frac} "
          f"({share:.5f} of the image), of them with no other value beside "
          f"them {lonely}", flush=True)
    require(outside == 0, f"config 5: {outside} pixels with a captured "
            f"sample outside 1.01 alpha_crit")
    require(lonely == 0 and share < 0.01,
            f"config 5: {lonely} fractional pixels inside a flat region, "
            f"fractional share {share:.5f}")
    del alpha
    frame = device_profile(render, 3, "kerr_dp45", kerr_launches)
    print(f"config 5 frame under torch.profiler (3 frames): "
          f"{json.dumps(frame)}", flush=True)

    # -- (b) the chunk rule: one batch, pass-sized chunks, sorted chunks --
    al, th = aa._stacked_grids(metric, scene, cfg, DIM5, fov, offsets,
                               trace_rows=rows, device=dev)
    al, th = al.reshape(-1), th.reshape(-1)
    n, chunk = al.numel(), rows * width
    ways = {"one batch": dict(chunk_size=None),
            "pass-sized chunks": dict(chunk_size=chunk,
                                      sort_by_difficulty=False),
            "sorted chunks": dict(chunk_size=chunk,
                                  sort_by_difficulty=True)}

    def trace(kw, two_pass):
        return trace_batch(metric, R_OBS, al, th, scene.theta_obs,
                           max_steps=cfg.max_steps, two_pass=two_pass, **kw)

    single = {label: cuda_ms(lambda: trace(kw, False), 1)
              for label, kw in ways.items()}
    ref = single["one batch"][1]
    bitwise = {label: all(same_bits(a, b) for a, b in zip(r[:3], ref[:3]))
               for label, (_ms, r) in single.items()}
    probe = {}
    zeros = torch.zeros(n, dtype=torch.bool, device=dev)
    kernel(metric, R_OBS, al, th, scene.theta_obs, zeros, LAMBDA_MAX,
           cfg.max_steps, probe=probe)
    attempts = probe["attempts"].to(torch.int64)
    # The lanes the exact-cycle exit ended (period in bits 21-30 of the
    # census), among those above the first pass's cap.
    long = attempts > cfg.pass1_steps
    exited = (probe["cycles"] >> 21) & 1023 > 0
    cycled = int((long & exited).sum())
    del probe
    order = difficulty_order(metric, R_OBS, scene.theta_obs, al)
    top = torch.topk(attempts, 5)
    slowest = [{"pass": i // chunk, "row": i % chunk // width,
                "col": i % width, "attempts": a}
               for a, i in zip(top.values.tolist(), top.indices.tolist())]
    _, unconv = kernel(metric, R_OBS, al, th, scene.theta_obs, zeros,
                       LAMBDA_MAX, cfg.pass1_steps, return_unconverged=True)
    stragglers = {"one batch": [int(unconv.sum())],
                  "pass-sized chunks": unconv.reshape(-1, chunk).sum(1)
                  .tolist(),
                  "sorted chunks": unconv[order].reshape(-1, chunk).sum(1)
                  .tolist()}
    max_attempts = {"pass-sized chunks": attempts.reshape(-1, chunk)
                    .amax(1).tolist(),
                    "sorted chunks": attempts[order].reshape(-1, chunk)
                    .amax(1).tolist()}
    row_b = {label: dict(ms=ms, bitwise_equal=bitwise[label],
                         unconverged_after_pass1=stragglers[label],
                         max_attempts=max_attempts.get(
                             label, [int(attempts.max())]))
             for label, (ms, _r) in single.items()}
    print(f"config 5 chunk rule, {n} stacked rays, two_pass=False: "
          f"{json.dumps(row_b)}; slowest rays {json.dumps(slowest)}; rays "
          f"above {cfg.pass1_steps} attempts {int(long.sum())}, of them "
          f"ended by the exact-cycle exit {cycled}", flush=True)
    require(all(bitwise.values()), f"config 5: the chunkings differ "
            f"bitwise without two-pass: {bitwise}")
    del single

    def coverage(res):
        fa = aa._mirror_fill(res.final_alpha.reshape(AA5, rows, width),
                             height)
        return (~torch.isnan(fa)).to(torch.float64).sum(0)

    exact = coverage(ref)
    row_2 = {}
    for label, kw in ways.items():
        ms, r = cuda_ms(lambda: trace(kw, "auto"), 1)
        over = sum(max(0, c - slots) for c in stragglers[label])
        same = all(same_bits(a, b) for a, b in zip(r[:3], ref[:3]))
        row_2[label] = dict(ms=ms, bitwise_equal=same,
                            rays_kept_from_pass1=over,
                            pixels_changed=int((coverage(r) != exact).sum()))
        require(same or over > 0, f"config 5: {label} with two-pass "
                f"differs from the single pass with no chunk above {slots} "
                f"unconverged rays")
    uniform_changed = int((img * AA5 != exact).sum())
    print(f"config 5 chunk rule, two_pass='auto' (slots {slots}): "
          f"{json.dumps(row_2)}; the render's pixels off the exact image "
          f"{uniform_changed} on {card}", flush=True)
    del ref, exact

    # -- (b2) the kernel and its driver against the plain loop on a sample
    # of the stacked rays, both capped at SAMPLE5_STEPS ------------------
    gen = torch.Generator().manual_seed(5)
    ac = metric.alpha_crit(R_OBS, scene.theta_obs)
    rand = torch.cat([c * chunk + torch.randint(0, chunk, (SAMPLE5,),
                                                generator=gen)
                      for c in range(AA5)]).to(dev)
    cols = torch.arange(width // 2 - AXIS5, width // 2 + AXIS5)
    axis = (torch.arange(AA5 * rows)[:, None] * width
            + cols[None, :]).reshape(-1).to(dev)
    slow = []
    for c in range(AA5):
        part = slice(c * chunk, (c + 1) * chunk)
        slow.append(c * chunk + attempts[part].topk(SLOWEST5).indices)
        slow.append(order[part][attempts[order[part]].topk(SLOWEST5)
                                .indices])
    slow = torch.cat(slow)
    ex = torch.nonzero(exited)[:, 0]
    idx = torch.unique(torch.cat([rand, axis, slow, ex]))
    subsets = {name: torch.isin(idx, sub) for name, sub in
               (("random", rand), ("polar-axis columns", axis),
                ("slowest", slow), ("exit-ended", ex))}
    subsets["all"] = torch.ones_like(subsets["random"])
    s_args = (metric, R_OBS, al[idx], th[idx], scene.theta_obs,
              zeros[:idx.numel()], LAMBDA_MAX, SAMPLE5_STEPS)
    job_s = pool.submit("light_path_tracer_tpu_torch.ops.cuda."
                        "kerr_trace_kernel:trace_rays_kerr_plain", *s_args)
    job_d = pool.submit("p20_plain_driver", *s_args)
    probe = {}
    rk = kernel(*s_args, probe=probe)
    rd = driver(*s_args, pass1_steps=SAMPLE5_PASS1)
    sl = idx[subsets["slowest"]]
    x64 = (metric, R_OBS, al[sl].double(), th[sl].double(), scene.theta_obs,
           zeros[:sl.numel()], LAMBDA_MAX, SAMPLE5_STEPS)
    r64, p64 = kernel(*x64), kk.trace_rays_kerr_plain(*x64)
    g64 = compare(r64, p64, al[sl], ac)
    ended_capped = int((((probe["cycles"] >> 21) & 1023) > 0).sum())
    e = subsets["exit-ended"]
    d64_lanes = dict(f64_captured=int(
        (r64.status[e[subsets["slowest"]]] == -1).sum()))
    al_idx = al[idx]
    del r64, p64

    def sample_gates():
        """(b2)'s gates, once the children have run the plain loop and the
        driver over it on the sample: (row_s, g_drv, plain ms of both)."""
        s_plain_ms, rp = PlainPool.result(job_s, dev)
        d_plain_ms, rdp = PlainPool.result(job_d, dev)
        return (*b2_gates(rp, rdp), s_plain_ms, d_plain_ms)

    def b2_gates(rp, rdp):
        """Phase 4's rules on the random rays, the polar-axis columns and
        the whole sample. On the slowest rays float32 is chaotic: the
        exit-ended lanes freeze under the cap in both versions, at states
        that sin and cos rounded apart on a few of them, and a few other
        slow rays end apart so (ROADMAP Queue 3). There float32 is held by
        status (the exit-ended lanes lane by lane), and float64, where both
        versions end every one of these rays, by phase 17's rules."""
        def part(r, m):
            return r._replace(final_alpha=r.final_alpha[m],
                              status=r.status[m])

        row_s = {name: compare(part(rk, m), part(rp, m), al_idx[m], ac)
                 for name, m in subsets.items()}
        g_drv = compare(rd, rdp, al_idx, ac)
        pairs = list(zip(rk.status[e].tolist(), rp.status[e].tolist()))
        status_pairs = {f"{k}/{q}": pairs.count((k, q))
                        for k, q in set(pairs)}
        d_e = (rk.final_alpha[e] - rp.final_alpha[e]).abs()
        exit_row = dict(
            f32_status_pairs=status_pairs,
            f32_frozen_by_the_exit=ended_capped,
            f32_lanes_d_alpha_above_1e_3=int((d_e > 1e-3).sum()),
            f32_max_abs_d_alpha=float(d_e.max()), **d64_lanes)
        driver_same = all(same_bits(a, b) for a, b in zip(rd[:3], rk[:3]))
        print(f"config 5 kernel vs plain loop on {idx.numel()} of its "
              f"stacked rays, both capped at {SAMPLE5_STEPS} attempts: "
              f"{json.dumps(row_s)}; the {ex.numel()} exit-ended lanes "
              f"{json.dumps(exit_row)}; the slowest set in float64 "
              f"{json.dumps(g64)}; driver (pass1_steps {SAMPLE5_PASS1}) "
              f"bitwise equal to the single pass {driver_same}, against "
              f"the driver over the plain loop {json.dumps(g_drv)}",
              flush=True)
        for name in ("random", "polar-axis columns", "all"):
            g = row_s[name]
            require(g["status_agree"] > 0.99 and g["p99"] < 2e-3,
                    f"config 5 kernel vs plain loop, {name}: {g}")
        require(g_drv["status_agree"] > 0.99 and g_drv["p99"] < 2e-3,
                f"config 5 driver vs the driver over the plain loop: "
                f"{g_drv}")
        require(row_s["slowest"]["status_agree"] > 0.99
                and row_s["exit-ended"]["status_agree"] == 1.0,
                f"config 5: the slowest rays end otherwise in the plain "
                f"loop: {row_s['slowest']}, exit-ended {exit_row}")
        require(g64["status_agree"] > 0.999 and g64["p99"] < 1e-6,
                f"config 5: the slowest rays in float64: {g64}")
        require(driver_same, "config 5: the driver differs from the single "
                "pass on the sample")
        return row_s, g_drv

    # The exit-ended lanes at full depth with the exit and without it
    # (every attempt ground): bitwise equal, as phase 18 holds its grids.
    x_args = (metric, R_OBS, al[ex], th[ex], scene.theta_obs,
              zeros[:ex.numel()], LAMBDA_MAX, cfg.max_steps)
    p_on, p_off = {}, {}
    on_ms, r_on = cuda_ms(lambda: kernel(*x_args, probe=p_on), 1)
    off_ms, r_off = cuda_ms(lambda: kernel(*x_args, probe=p_off,
                                           _cycle_exit=False), 1)
    ground = (all(same_bits(a, b) for a, b in zip(r_on[:3], r_off[:3]))
              and torch.equal(p_on["attempts"], p_off["attempts"])
              and same_bits(p_on["state"], p_off["state"]))
    print(f"config 5 exit-ended lanes ({ex.numel()}) at {cfg.max_steps} "
          f"attempts: exit on {on_ms:.2f} ms, off {off_ms:.2f} ms, bitwise "
          f"equal {ground}", flush=True)
    require(ground, "config 5: the exit-ended lanes differ with the exit "
            "off")
    del r_on, r_off, p_on, p_off, probe

    # -- the Kerr kernel and its driver at config 5's shape: a launch a
    # pass-sized chunk (CUDA events, the four chunks in a row), against
    # the work of the rays the exit did not end (the exit books 200,000
    # attempts a lane that it never makes) ---------------------------
    parts = [(al[s:s + chunk], th[s:s + chunk]) for s in range(0, n, chunk)]
    zc = zeros[:chunk]
    k_ms, _ = cuda_ms(lambda: [kernel(
        metric, R_OBS, a, t, scene.theta_obs, zc, LAMBDA_MAX,
        cfg.max_steps) for a, t in parts], 1)
    d_ms, _ = cuda_ms(lambda: [driver(
        metric, R_OBS, a, t, scene.theta_obs, zc, LAMBDA_MAX,
        cfg.max_steps, pass1_steps=cfg.pass1_steps) for a, t in parts], 1)
    k_ms, d_ms = k_ms / AA5, d_ms / AA5
    made = attempts.masked_fill(exited, 0)
    slowest = attempts_stats(attempts, lambda i: kernel(
        metric, R_OBS, al[i:i + 1], th[i:i + 1], scene.theta_obs,
        zeros[:1], LAMBDA_MAX, cfg.max_steps))
    shadow_work = kerr_work()
    sample = dict(plain_rays=int(idx.numel()),
                  plain_max_steps=SAMPLE5_STEPS,
                  attempts_booked=int(attempts.sum()) // AA5,
                  exit_ended=int(exited.sum()))
    work_k = int(made.sum()) // AA5 * shadow_work
    work_d = driver_attempts(made, cfg.pass1_steps) // AA5 * shadow_work

    # The attempts split by |alpha / alpha_crit - 1|: config 5's rays
    # (those the exit did not end) against the main path's, refined and
    # not; and each kernel's ns an attempt.
    split = attempt_split(al, made, ac, {"config 5": ~exited})
    m_al, m_rf, m_at = main["alphas"], main["refine"], main["attempts"]
    split.update(attempt_split(m_al, m_at, ac, {
        "1024^2 main path": torch.ones_like(m_rf),
        "1024^2 refined columns": m_rf, "1024^2 other columns": ~m_rf}))
    ns = {"config 5": k_ms * 1e6 / (int(made.sum()) / AA5),
          "1024^2 main path": main["ms"] * 1e6 / int(m_at.sum())}
    busy = {"config 5": int(made.sum()) / (32 * int(
                kerr_trace.warp_step_sum(made))),
            "1024^2 main path": int(m_at.sum()) / (32 * int(
                kerr_trace.warp_step_sum(m_at)))}
    print(f"config 5 kernel a pass-sized chunk ({chunk} rays): {k_ms:.3f} "
          f"ms, driver {d_ms:.3f} ms; ns an attempt {json.dumps(ns)}; lane "
          f"efficiency (the exit-ended lanes left out) {json.dumps(busy)}; "
          f"attempts by |alpha/alpha_crit - 1| band {json.dumps(split)} on "
          f"{card}", flush=True)
    del al, th, zeros, order, attempts, made, exited, parts

    # -- (c) adaptive against uniform AA ----------------------------------
    adaptive.render_shadow_adaptive(scene, DIM5, cfg, aa_samples=AA5,
                                    refine_frac=0.05, device="cuda")
    img_a, st_a = adaptive.render_shadow_adaptive(
        scene, DIM5, cfg, aa_samples=AA5, refine_frac=0.05, device="cuda")
    al_r, th_r = adaptive._refine_angles(st_a["refined_idx"], DIM5, fov,
                                         offsets, scene, torch.float32)
    _, unc_r = kernel(metric, R_OBS, al_r.reshape(-1), th_r.reshape(-1),
                      scene.theta_obs,
                      torch.zeros(al_r.numel(), dtype=torch.bool,
                                  device=dev),
                      LAMBDA_MAX, cfg.pass1_steps, return_unconverged=True)
    unc = dict(base=stragglers["pass-sized chunks"][0],
               refine=int(unc_r.sum()))
    overflow = (max(stragglers["pass-sized chunks"]) > slots
                or max(unc.values()) > slots)
    covered = st_a["edge_pixels"] <= st_a["refined_pixels"]
    differ = int((img_a != img).sum())
    t_a = st_a["timings"]
    print(f"config 5 adaptive (5 % budget): traced_rays "
          f"{st_a['traced_rays']}, edge_pixels {st_a['edge_pixels']}, "
          f"refined_pixels {st_a['refined_pixels']}, unconverged after "
          f"pass 1 {json.dumps(unc)}, stages (s) {json.dumps(t_a)}, "
          f"traced rays/s {st_a['traced_rays'] / t_a['total']:,.0f}, "
          f"pixels off the uniform image {differ} on {card}", flush=True)
    require(differ == 0 or overflow or not covered,
            f"config 5: adaptive differs from uniform AA on {differ} "
            f"pixels with the edge set covered and no overflow")
    del img_a, al_r, th_r, unc_r, img

    # -- (d) the AA entry points on the card against the CPU --------------
    cfg_s = RenderConfig(max_steps=SMALL5_STEPS)
    src = np.random.default_rng(5).random(SMALL5 + (3,)).astype(np.float32)
    cfg_b = RenderConfig(max_steps=SMALL5_STEPS, sampling="bilinear")
    fov_s = camera.fov_from_vertical(scene.vertical_fov, SMALL5)
    checks = {}
    for label, fn in (("shadow aa", aa.render_shadow_aa),
                      ("shadow adaptive", adaptive.render_shadow_adaptive)):
        og, _ = fn(scene, SMALL5, cfg_s, device="cuda")
        oc, _ = fn(scene, SMALL5, cfg_s, device="cpu")
        checks[label] = dict(pixels_equal=float(
            (og.cpu() == oc).float().mean()))
    calm = None
    for device in ("cuda", "cpu"):
        nh = aa._trace_all_passes(metric, scene, cfg_b, SMALL5, fov_s,
                                  offsets, device)[1].cpu()
        quiet = nh.amax(0) < 2
        calm = quiet if calm is None else calm & quiet
    for label, fn in (("scene aa", aa.render_scene_aa),
                      ("scene adaptive", adaptive.render_scene_adaptive)):
        og, sg = fn(scene, src, cfg_b, device="cuda")
        oc, sc = fn(scene, src, cfg_b, device="cpu")
        keep = calm.clone()
        c = {}
        if "refined_idx" in sg:
            # A pixel refined on one side only carries another sample
            # set: a tie-break at the budget's edge, not an error.
            ref_g = torch.zeros(SMALL5[0] * SMALL5[1], dtype=torch.bool)
            ref_c = torch.zeros_like(ref_g)
            ref_g[sg["refined_idx"].cpu()] = True
            ref_c[sc["refined_idx"]] = True
            one_side = (ref_g != ref_c).reshape(SMALL5)
            c["refined_one_side"] = int(one_side.sum())
            keep &= ~one_side
        d = (og.cpu() - oc)[keep]
        c.update(calm_px=int(keep.sum()), rmse=float((d ** 2).mean().sqrt()))
        checks[label] = c
    print(f"config 5 check, {SMALL5[0]}x{SMALL5[1]} card vs CPU "
          f"(max_steps {SMALL5_STEPS}): {json.dumps(checks)}", flush=True)
    require(all(checks[k]["pixels_equal"] >= 0.99
                for k in ("shadow aa", "shadow adaptive"))
            and all(checks[k]["rmse"] < 1e-3
                    for k in ("scene aa", "scene adaptive")),
            f"config 5 card vs CPU: {checks}")

    # -- (b2)'s gates, the sample's plain loops read from the children ----
    row_s, g_drv, s_plain_ms, d_plain_ms = sample_gates()
    print(f"config 5 sample: plain ms {s_plain_ms:.1f} (single pass), "
          f"{d_plain_ms:.1f} (driver), each in its child", flush=True)
    entries = [
        kernel_entry("kerr_dp45_config5", KERNEL_SOURCE, REPLACES,
                     launches["kernel"], row_s["all"]["max_abs"], k_ms,
                     s_plain_ms, chunk, 9 + 12, work_k, slowest),
        kernel_entry("trace_rays_kerr_two_pass_config5", DRIVER_SOURCE,
                     f"{JAX_KERNELS}:257", launches["driver"],
                     g_drv["max_abs"], d_ms, d_plain_ms, chunk, 9 + 12,
                     work_d)]
    for entry in entries:
        entry.update(sample)
    return launches, entries


# Phase 21: Kerr-Newman and Johannsen-Psaltis through the Kerr kernel.
# The scenes are the JAX repo's chip smoke's (scripts/chip_smoke.py:138,
# :154) in config 3's frame, and config 4's disk with a charge.
KN_ARGS = dict(M=1.0, a=0.6, Q=0.6)
JP_ARGS = dict(M=1.0, a=0.9, eps3=2.0)


class cpu_alpha_crit:
    """Johannsen-Psaltis's alpha_crit (JP_ARGS, R_OBS, theta_obs 90 deg) at
    the depth every frame runs it (16 azimuths, 26 iterations) on the
    CPU's plain loop, in a process of its own beside the card's work (it
    takes ~50 s); result() waits for (alpha_crit, seconds). Leaving the
    block stops the process."""

    CODE = ("import json, time, numpy as np, torch; "
            "torch.set_num_threads(2); "
            "from light_path_tracer_tpu_torch.models import JohannsenPsaltis; "
            "m = JohannsenPsaltis(**{args}); t = time.perf_counter(); "
            "v = m.alpha_crit({r_obs}, np.pi / 2, device='cpu'); "
            "print(json.dumps([v, time.perf_counter() - t]))")

    def __enter__(self):
        self.proc = subprocess.Popen(
            [sys.executable, "-c", self.CODE.format(args=JP_ARGS,
                                                    r_obs=R_OBS)],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        return self

    def result(self):
        out, err = self.proc.communicate(timeout=300)
        require(self.proc.returncode == 0,
                f"the CPU's JP alpha_crit failed: {err[-2000:]}")
        value, seconds = json.loads(out.strip().splitlines()[-1])
        return value, seconds

    def __exit__(self, *exc):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.communicate()


class card_alpha_crit:
    """Within the block, JohannsenPsaltis.alpha_crit returns `value`: the
    64^2 renders of the card-vs-CPU checks take the card's bisection of
    step (a), on both sides (the full one on the CPU plain loop costs ~50
    s a frame, and on the card it would join the float64 shadow's
    launch count; the image does not depend on it, it orders chunks and
    fills the stats)."""

    def __init__(self, value):
        self.value = value

    def __enter__(self):
        from light_path_tracer_tpu_torch.models import JohannsenPsaltis
        self.cls, self.orig = JohannsenPsaltis, JohannsenPsaltis.alpha_crit
        JohannsenPsaltis.alpha_crit = lambda _self, *a, **k: self.value

    def __exit__(self, *exc):
        self.cls.alpha_crit = self.orig


def families_phase(dev, card, cpu_ac, pool):
    """Phase 21: Kerr-Newman (a = 0.6, Q = 0.6) and Johannsen-Psaltis
    (a = 0.9, eps3 = 2) through the Kerr kernel: each family's instance
    against the plain loop (phase 3's gates in float32, phase 17's in
    float64), the Kerr-Newman disk variant (phase 8's), Q = 0 bitwise the
    Kerr kernel, Johannsen-Psaltis's bisection on the card against the
    CPU, the 1024^2 shadow, lensed, AA and adaptive renders and the
    charged thin disk through the entry points (each path with its
    counts set to 0 before it and read after), and 64^2 card-vs-CPU
    renders. Returns the kernels-line entries."""
    import torch
    from light_path_tracer_tpu_torch import aa, adaptive, camera, pipeline
    from light_path_tracer_tpu_torch import disk as disk_mod
    from light_path_tracer_tpu_torch.models import (JohannsenPsaltis, Kerr,
                                                    KerrNewman)
    from light_path_tracer_tpu_torch.models.numeric import alpha_crit_traced
    from light_path_tracer_tpu_torch.ops import kerr_trace as tk
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    from light_path_tracer_tpu_torch.utils.config import (RenderConfig,
                                                          SceneConfig)
    kernel, disk_kernel = kk.trace_rays_kerr_cuda, kk.trace_disk_rays_cuda
    drivers = (kk.trace_rays_kerr_two_pass, kk.trace_disk_rays_two_pass)
    plains = (tk.trace_rays_kerr, tk.trace_disk_rays_kerr)
    counters = (kernel, disk_kernel) + drivers + plains

    def zero():
        for c in counters:
            c.launches = 0
            if hasattr(c, "launches_f64"):
                c.launches_f64 = 0

    def counts():
        return dict(kernel=kernel.launches, kernel_f64=kernel.launches_f64,
                    disk=disk_kernel.launches,
                    disk_f64=disk_kernel.launches_f64,
                    kerr_driver=drivers[0].launches,
                    disk_driver=drivers[1].launches,
                    plain=sum(c.launches for c in plains))

    t_phase = time.perf_counter()
    kn, jp = KerrNewman(**KN_ARGS), JohannsenPsaltis(**JP_ARGS)
    fams = {"kn": (kn, dict(a=0.6, Q=0.6)), "jp": (jp, dict(a=0.9,
                                                          eps3=2.0))}
    cfg = RenderConfig()
    dim = (1024, 1024)
    fov = camera.fov_from_vertical(np.radians(40.0), dim)
    f32 = dict(dtype=torch.float32, device=dev)
    print("Kerr-Newman and Johannsen-Psaltis through the Kerr kernel:",
          flush=True)

    # -- (a) Johannsen-Psaltis's alpha_crit: the float64 kernel -----------
    # The bisection every JP frame runs, timed whole by CUDA events (27
    # launches of 16 rays, a host sync each); a run with the probe gives
    # its attempts. The CPU's value comes from cpu_ac at the phase's end.
    zero()
    ac_jp = jp.alpha_crit(R_OBS, np.pi / 2, device="cuda")
    require(kernel.launches_f64 > 0 and kernel.launches == 0,
            "JP alpha_crit did not run the float64 kernel")
    ac_ms, _ = cuda_ms(lambda: jp.alpha_crit(R_OBS, np.pi / 2,
                                             device="cuda"), 3)
    launch_probes = []
    alpha_crit_traced(jp, R_OBS, np.pi / 2, device="cuda",
                      probe=launch_probes)
    att = torch.cat([p["attempts"] for p in launch_probes]).to(torch.int64)
    bis = dict(ms=ac_ms, n=int(att.numel()), launches=len(launch_probes),
               attempts_sum=int(att.sum()), slowest_attempts=int(att.max()),
               n_steps=sum(int(p["n_steps"]) for p in launch_probes))
    bis.update(attempts_mean=bis["attempts_sum"] / bis["n"],
               lane_efficiency=bis["attempts_sum"] / (32 * bis["n_steps"]))
    print(f"  JP alpha_crit_traced on the card: {ac_jp:.15f} rad, "
          f"{json.dumps(bis)} (16 azimuths, 26 iterations; a launch fills "
          f"16 lanes of a warp, so lane efficiency is at most 0.5)",
          flush=True)
    acs = {"kn": kn.alpha_crit(R_OBS), "jp": ac_jp}

    # -- (b) each family's instance against the plain loop ----------------
    # The plain loops of (b) and (d), queued to the children first.
    n, m = 4096, F64_RAYS
    rays, jobs = {}, {}
    for name, (metric, kw) in fams.items():
        ac = acs[name]
        rng = np.random.default_rng(21)
        al = torch.tensor(rng.uniform(0.2 * ac, 4 * ac, n), **f32)
        th = torch.tensor(rng.uniform(-np.pi, np.pi, n), **f32)
        rf = torch.tensor(rng.random(n) < 0.2, device=dev)
        scene = SceneConfig(M=1.0, r_obs_mult=R_OBS, **kw)
        main = pipeline.trace_inputs(scene, cfg, dim, fov, dev)[:3]
        rays[name] = (al, th, rf, main)
        jobs[name] = (
            plain_job(pool, "kerr", metric, al, th, rf, GATE_STEPS),
            plain_job(pool, "kerr", metric, al[:m].double(),
                      th[:m].double(), rf[:m], GATE_STEPS),
            plain_job(pool, "kerr", metric, *main, cfg.max_steps))
    rng = np.random.default_rng(8)
    al_d = torch.tensor(rng.uniform(0.01, 0.12, 4096), **f32)
    th_d = torch.tensor(rng.uniform(-np.pi, np.pi, 4096), **f32)
    plane = (disk_mod.r_isco(1.0, 0.6, Q=0.6), 20.0, np.pi / 2, True)
    disk_jobs = (
        plain_job(pool, "disk", kn, al_d, th_d, GATE_STEPS, plane, 2),
        plain_job(pool, "disk", kn, al_d[:F64_RAYS].double(),
                  th_d[:F64_RAYS].double(), GATE_STEPS, plane, 2))
    rows = {}
    for name, (metric, kw) in fams.items():
        al, th, rf, (al_m, th_m, rf_m) = rays[name]
        g = both_versions(f"{name} {n} random rays", metric, al, th, rf,
                          GATE_STEPS, 5, job=jobs[name][0])
        require(g["status_agree"] > 0.99 and g["p99"] < 2e-3,
                f"{name} 4096-ray gate: {g}")
        g64 = both_versions(f"{name} {m} random rays, float64", metric,
                            al[:m].double(), th[:m].double(), rf[:m],
                            GATE_STEPS, 3, job=jobs[name][1])
        require(g64["status_agree"] > 0.999 and g64["p99"] < 1e-6,
                f"{name} float64 gate: {g64}")
        gm = both_versions(f"{name} 1024^2 main-path rays", metric, al_m,
                           th_m, rf_m, cfg.max_steps, 3, job=jobs[name][2])
        require(gm["status_agree"] > 0.99 and gm["p99"] < 2e-3
                and gm["mask_agree"] >= 0.995, f"{name} 1024^2 gate: {gm}")
        rows[name] = dict(random=g, f64=g64, main=gm)

    # -- (c) Kerr-Newman at Q = 0 is the Kerr kernel, bitwise -------------
    scene_k = SceneConfig(M=1.0, a=0.9, r_obs_mult=R_OBS)
    al_k, th_k, rf_k, _ = pipeline.trace_inputs(scene_k, cfg, dim, fov, dev)
    pk, pq = {}, {}
    args_k = (R_OBS, al_k, th_k, np.pi / 2, rf_k, LAMBDA_MAX, cfg.max_steps)
    rk = kernel(Kerr(M=1.0, a=0.9), *args_k, probe=pk)
    rq = kernel(KerrNewman(M=1.0, a=0.9, Q=0.0), *args_k, probe=pq)
    same = (all(same_bits(a, b) for a, b in zip(rk, rq))
            and same_bits(pk["state"], pq["state"])
            and same_bits(pk["attempts"], pq["attempts"]))
    print(f"  KN Q=0 on the 1024^2 main-path rays bitwise the Kerr kernel: "
          f"{same}", flush=True)
    require(same, "KN at Q = 0 differs from the Kerr kernel")
    del al_k, th_k, rf_k, rk, rq, pk, pq

    # -- (d) the Kerr-Newman disk variant -----------------------------------
    gd = disk_both("kn disk, 4096 random rays, opaque", kn, al_d, th_d,
                   GATE_STEPS, plane, 2, 5, job=disk_jobs[0])
    gd64 = disk_both(f"kn disk, {F64_RAYS} random rays, float64", kn,
                     al_d[:F64_RAYS].double(), th_d[:F64_RAYS].double(),
                     GATE_STEPS, plane, 2, 3, job=disk_jobs[1])
    require(gd64["status_agree"] > 0.999 and gd64["nhits_agree"] > 0.999
            and gd64["median_dr"] < 1e-6, f"kn disk float64 gate: {gd64}")

    # -- (e) the paths at 1024^2 through the entry points -----------------
    src = np.random.default_rng(5).random(dim + (3,)).astype(np.float32)
    paths, images = {}, {}
    for name, (metric, kw) in fams.items():
        scene = SceneConfig(M=1.0, r_obs_mult=R_OBS, **kw)
        zero()
        img, st = pipeline.render_shadow(scene, dim, cfg, device="cuda")
        best = None
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img, st = pipeline.render_shadow(scene, dim, cfg, device="cuda")
            frame_s = time.perf_counter() - t0
            rps = st["traced_rays"] / st["timings"]["precompute"]
            best = rps if best is None else max(best, rps)
        c = counts()
        require(c["kernel"] >= 4 and c["plain"] == 0,
                f"{name} shadow path: {c}")
        require(img.shape == dim and bool(torch.isfinite(img).all())
                and st["traced_rays"] == 524288, f"{name} shadow image")
        images[name] = img
        frame = device_profile(lambda: pipeline.render_shadow(
            scene, dim, cfg, device="cuda"), 3, "kerr_dp45", kerr_launches)
        paths[f"{name} shadow"] = dict(
            counts=c, best_rays_per_s=best, frame_s=frame_s,
            timings=st["timings"], alpha_crit=st["alpha_crit"],
            integrator_steps=st["integrator_steps"],
            captured=int((img == 0).sum()), profile=frame)
        print(f"  {name} 1024^2 shadow: {json.dumps(paths[name + ' shadow'])}"
              f" on {card}", flush=True)
        for label, render in (
                ("lens", lambda: pipeline.render_scene(
                    scene, src, RenderConfig(sampling="bilinear"),
                    device="cuda")),
                ("aa4", lambda: aa.render_shadow_aa(
                    scene, dim, cfg, aa_samples=4, device="cuda")),
                ("adaptive4", lambda: adaptive.render_shadow_adaptive(
                    scene, dim, cfg, aa_samples=4, device="cuda"))):
            zero()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = render()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            c = counts()
            img_l = out.image if label == "lens" else out[0]
            require(c["kernel"] >= 1 and c["plain"] == 0
                    and bool(torch.isfinite(img_l).all()),
                    f"{name} {label} path: {c}")
            paths[f"{name} {label}"] = dict(counts=c, wall_s=wall)
            print(f"  {name} 1024^2 {label}: {json.dumps(paths[name + ' ' + label])}",
                  flush=True)
    # The charged shadow lies inside the same-spin Kerr shadow.
    img_k06, _ = pipeline.render_shadow(
        SceneConfig(M=1.0, a=0.6, r_obs_mult=R_OBS), dim, cfg, device="cuda")
    cap_kn, cap_k = images["kn"] == 0, img_k06 == 0
    outside = int((cap_kn & ~cap_k).sum())
    print(f"  KN shadow {int(cap_kn.sum())} px, Kerr a=0.6 shadow "
          f"{int(cap_k.sum())} px, KN captured outside Kerr's: {outside}",
          flush=True)
    require(0 < int(cap_kn.sum()) < int(cap_k.sum()) and outside == 0,
            "the KN shadow does not lie inside the same-spin Kerr shadow")

    scene_d = SceneConfig(M=1.0, a=0.6, Q=0.6, r_obs_mult=R_OBS,
                          theta_obs=THETA_DISK)
    disk_cfg = disk_mod.DiskConfig()
    zero()
    img_d, st_d = disk_mod.render_disk(scene_d, dim, cfg, disk_cfg,
                                       device="cuda")
    best_d = None
    for _ in range(3):
        img_d, st_d = disk_mod.render_disk(scene_d, dim, cfg, disk_cfg,
                                           device="cuda")
        rps = st_d["traced_rays"] / st_d["timings"]["precompute"]
        best_d = rps if best_d is None else max(best_d, rps)
    c_disk = counts()
    require(c_disk["disk"] >= 8 and c_disk["disk_driver"] >= 4
            and c_disk["plain"] == 0, f"kn disk path: {c_disk}")
    require(bool(torch.isfinite(img_d).all()) and st_d["disk_pixels"] > 0
            and st_d["captured"] > 0, "kn disk image")
    frame_d = device_profile(lambda: disk_mod.render_disk(
        scene_d, dim, cfg, disk_cfg, device="cuda"), 3, "kerr_dp45",
        kerr_launches)
    paths["kn disk"] = dict(counts=c_disk, best_rays_per_s=best_d,
                            r_isco=st_d["r_isco"],
                            disk_pixels=st_d["disk_pixels"],
                            captured=st_d["captured"], profile=frame_d)
    print(f"  kn 1024^2 disk: {json.dumps(paths['kn disk'])} on {card}",
          flush=True)

    # -- (f) 64^2 renders on the card against the CPU ----------------------
    d64 = (64, 64)
    src64 = np.random.default_rng(6).random(d64 + (3,)).astype(np.float32)
    cfg64 = RenderConfig(dtype="float64")
    f64_counts = {}
    for name, (metric, kw) in fams.items():
        scene = SceneConfig(M=1.0, r_obs_mult=R_OBS, vertical_fov_deg=12.0,
                            **kw)
        checks = {}
        for label, render, f64 in (
                ("shadow", lambda d: pipeline.render_shadow(
                    scene, d64, cfg, device=d)[0], False),
                ("shadow f64", lambda d: pipeline.render_shadow(
                    scene, d64, cfg64, device=d)[0], True),
                ("lens", lambda d: pipeline.render_scene(
                    scene, src64, RenderConfig(sampling="bilinear"),
                    device=d), False),
                ("aa4", lambda d: aa.render_shadow_aa(
                    scene, d64, cfg, aa_samples=4, device=d)[0], False)):
            zero()
            with card_alpha_crit(acs[name]):
                og = render("cuda")
            torch.cuda.synchronize()
            c = counts()
            if f64:
                f64_counts[name] = c["kernel_f64"]
                require(c["kernel_f64"] > 0 and c["kernel"] == 0
                        and c["plain"] == 0, f"{name} f64 64^2 path: {c}")
            with card_alpha_crit(acs[name]):
                oc = render("cpu")
            if label == "lens":
                wg = og.precompute.winding.to(torch.int32).cpu()
                wc = oc.precompute.winding.to(torch.int32)
                calm = (wg < 2) & (wc < 2)
                diff = (og.image.cpu() - oc.image)[calm]
                mask = float((torch.isnan(og.precompute.final_alpha.cpu())
                              == torch.isnan(oc.precompute.final_alpha))
                             .float().mean())
                checks[label] = dict(mask_agree=mask, rmse=float(
                    diff.double().pow(2).mean().sqrt()))
                ok = mask >= 0.99 and checks[label]["rmse"] < 1e-3
            else:
                agree = float((og.cpu() == oc).float().mean())
                checks[label] = dict(pixels_agree=agree)
                ok = agree >= (0.999 if f64 else 0.99)
            require(ok, f"{name} 64^2 {label} card vs CPU: {checks[label]}")
        print(f"  {name} 64^2 card vs CPU: {json.dumps(checks)}", flush=True)
    zero()
    cfg_d64 = RenderConfig(dtype="float64")
    og, _ = disk_mod.render_disk(scene_d, d64, cfg_d64, disk_cfg,
                                 device="cuda")
    f64_counts["kn disk"] = disk_kernel.launches_f64
    require(disk_kernel.launches_f64 > 0 and disk_kernel.launches == 0,
            f"kn disk f64 path: {counts()}")
    oc, _ = disk_mod.render_disk(scene_d, d64, cfg_d64, disk_cfg,
                                 device="cpu")
    og32, _ = disk_mod.render_disk(scene_d, d64, cfg, disk_cfg,
                                   device="cuda")
    oc32, _ = disk_mod.render_disk(scene_d, d64, cfg, disk_cfg,
                                   device="cpu")
    on = (og32.cpu() > 0) & (oc32 > 0)
    disk_check = dict(
        f64_max=float((og.cpu() - oc).abs().max()),
        f32_mask_agree=float(((og32.cpu() > 0) == (oc32 > 0)).float()
                             .mean()),
        f32_median=float((og32.cpu() - oc32).abs()[on].median()))
    print(f"  kn disk 64^2 card vs CPU: {json.dumps(disk_check)}",
          flush=True)
    require(disk_check["f64_max"] < 1e-6
            and disk_check["f32_mask_agree"] >= 0.99
            and disk_check["f32_median"] < 1e-3,
            f"kn disk 64^2 card vs CPU: {disk_check}")
    # Johannsen-Psaltis's alpha_crit at full depth, card against CPU.
    t0 = time.perf_counter()
    ac_cpu, ac_cpu_s = cpu_ac.result()
    d_ac = abs(ac_jp - ac_cpu)
    print(f"  JP alpha_crit at full depth: card {ac_jp:.15f}, CPU "
          f"{ac_cpu:.15f} ({ac_cpu_s:.1f} s in its own process, "
          f"{time.perf_counter() - t0:.1f} s waited for), |d| {d_ac:.3e} "
          f"rad", flush=True)
    require(d_ac < 1e-9, f"JP alpha_crit card {ac_jp} vs CPU {ac_cpu}")
    print(f"phase 21: {time.perf_counter() - t_phase:.1f} s", flush=True)

    # -- the kernels-line entries ------------------------------------------
    # Bytes a ray as phases 3, 8 and 17 count them: the shadow's alpha,
    # theta and refine byte in, final_alpha, n_half and status out; the
    # disk's p_phi, n_hits and two slots of (r, phi) hits too.
    shadow_bytes = {"float32": 9 + 12, "float64": 17 + 16}
    disk_bytes = {"float32": 8 + 20 + 16, "float64": 16 + 28 + 32}

    def entry(name, g, launches, family, dtype, disk=False):
        source = (KERNEL_SOURCE if dtype == "float32"
                  else F64_SOURCE.format("kerr_dp45"))
        replaces = f"{JAX_KERNELS}:316" if disk else REPLACES
        per_ray = (disk_bytes if disk else shadow_bytes)[dtype]
        e = kernel_entry(name, source, replaces, launches,
                         g["max_dr" if disk else "max_abs"], g["ms"],
                         g["plain_ms"], g["n"], per_ray,
                         g["attempts_sum"] * bounds.kerr_work(dtype, family),
                         g)
        e.update({k: g[k] for k in ("kernel_ms", "attempts_mean",
                                    "lane_efficiency") if k in g})
        return e

    # The bisection as the JP shadow path runs it: its float64 launches on
    # the 1024^2 path, the whole call's time, the CPU's plain loop on the
    # same call (in cpu_ac's process), its bound from this run's attempts.
    bisection = kernel_entry(
        "alpha_crit_jp_f64", F64_SOURCE.format("kerr_dp45"), REPLACES,
        paths["jp shadow"]["counts"]["kernel_f64"], d_ac, bis["ms"],
        ac_cpu_s * 1e3, bis["n"], shadow_bytes["float64"],
        bis["attempts_sum"] * bounds.kerr_work("float64",
                                               "johannsen_psaltis"), bis)
    bisection.update(plain_on="cpu", calls=bis["launches"],
                     attempts_mean=bis["attempts_mean"],
                     lane_efficiency=bis["lane_efficiency"])
    return [
        entry("kerr_dp45_kn", rows["kn"]["main"],
              paths["kn shadow"]["counts"]["kernel"], "kerr_newman",
              "float32"),
        entry("kerr_dp45_jp", rows["jp"]["main"],
              paths["jp shadow"]["counts"]["kernel"], "johannsen_psaltis",
              "float32"),
        entry("trace_disk_rays_kn", gd, c_disk["disk"], "kerr_newman",
              "float32", disk=True),
        entry("kerr_dp45_kn_f64", rows["kn"]["f64"], f64_counts["kn"],
              "kerr_newman", "float64"),
        entry("kerr_dp45_jp_f64", rows["jp"]["f64"], f64_counts["jp"],
              "johannsen_psaltis", "float64"),
        entry("trace_disk_rays_kn_f64", gd64, f64_counts["kn disk"],
              "kerr_newman", "float64", disk=True),
        bisection]


# Phase 22: Hairer's DOP853 pair and linear event location through the Kerr
# and extras kernels (csrc/kerr_dop853*.cu, the DOP853 library).
D853_SOURCE = "light_path_tracer_tpu_torch/csrc/kerr_dop853{}.cu"
# The plain loop's attempt cap on the 1024^2 grids (kernel and plain loop
# alike): a float32 DOP853 lane of the main path runs ~8,800 attempts, and
# the plain loop costs ~15-60 ms an iteration whatever the batch.
D853_GRID_STEPS = 64
# The attempt cap of phase 22's random rays, kernel and plain loop alike:
# the Kerr and disk rays (their slowest DOP853 lanes take ~100-550
# attempts) and the extras forms (mean ~22-30 attempts, slowest ~90-300,
# the plain loop ~50-400 ms an iteration), whose exits' window (512) it
# does not reach.
D853_RAY_STEPS = 64
D853_AUX_STEPS = 128


class background_build:
    """Builds a kernel library (ops/cuda/_build.py) in a child process at
    the lowest CPU priority (nice 19, which its nvcc processes inherit),
    from the moment it is made, so the earlier phases' host work keeps
    its cores; result() waits for the child, loads the library it built
    and returns (library, the child's build seconds). stop_all() ends
    every child still running, with its nvcc processes."""

    started = []
    CODE = ("import json, sys; sys.path.insert(0, {root!r}); "
            "from light_path_tracer_tpu_torch.ops.cuda import _build; "
            "lib = _build.load_library({library!r}); "
            "print(json.dumps(lib.build_seconds))")

    def __init__(self, library):
        root = os.path.dirname(os.path.abspath(__file__))
        self.library = library
        self.proc = subprocess.Popen(
            [sys.executable, "-c", self.CODE.format(root=root,
                                                    library=library)],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, start_new_session=True,
            preexec_fn=lambda: os.nice(19))
        background_build.started.append(self)

    def result(self):
        from light_path_tracer_tpu_torch.ops.cuda import _build
        out, err = self.proc.communicate()
        require(self.proc.returncode == 0, f"the {self.library} library's "
                f"build failed: {err[-4000:]}")
        build_s = json.loads(out.strip().splitlines()[-1])
        return _build.load_library(self.library), build_s

    @classmethod
    def stop_all(cls):
        import signal
        for b in cls.started:
            if b.proc.poll() is None:
                os.killpg(b.proc.pid, signal.SIGKILL)
            b.proc.communicate()


def d853_counters():
    """The wrappers, drivers and plain loops whose counts phase 22 reads:
    (kernel wrappers by name, drivers, plain loops)."""
    from light_path_tracer_tpu_torch.ops import kerr_trace as tk
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk
    kernels = dict(kerr=kk.trace_rays_kerr_cuda,
                   disk=kk.trace_disk_rays_cuda,
                   volumetric=vk.trace_rays_volumetric_cuda,
                   aux=vk.trace_rays_aux_cuda)
    drivers = dict(kerr_driver=kk.trace_rays_kerr_two_pass,
                   disk_driver=kk.trace_disk_rays_two_pass,
                   volumetric_driver=kk.trace_rays_volumetric_two_pass,
                   aux_driver=kk.trace_rays_aux_two_pass,
                   spectral_driver=kk.trace_rays_spectral_two_pass)
    plains = (tk.trace_rays_kerr, tk.trace_disk_rays_kerr,
              tk.trace_rays_volumetric, tk.trace_rays_spectral,
              tk.trace_rays_aux)
    return kernels, drivers, plains


def d853_zero():
    from light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel import (
        zero_counters)
    kernels, drivers, plains = d853_counters()
    for c in kernels.values():
        zero_counters(c)
    for c in (*drivers.values(), *plains):
        c.launches = 0


def d853_counts():
    """Each kernel's DOP853 launches (float32, float64) and DP45 ones, the
    drivers' calls and the plain loops' calls since d853_zero."""
    kernels, drivers, plains = d853_counters()
    out = {}
    for name, c in kernels.items():
        out[name] = c.launches_dop853
        out[name + "_f64"] = c.launches_dop853_f64
        out[name + "_dp45"] = c.launches + c.launches_f64
    out.update({name: c.launches for name, c in drivers.items()})
    out["plain"] = sum(c.launches for c in plains)
    return out


def d853_path(label, render, want, runs=1, card=""):
    """Drive one path with integrator="dop853": counts set to 0, a warm-up
    and `runs` timed calls (CUDA-synchronised wall seconds), counts read;
    want: the counter that must have grown (every DP45 launch and plain
    call must stay 0). Returns (last output, row)."""
    import torch
    d853_zero()
    out = render()
    walls = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = render()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    c = d853_counts()
    dp45 = sum(v for k, v in c.items() if k.endswith("_dp45"))
    require(c[want] >= 1 + runs and dp45 == 0 and c["plain"] == 0,
            f"phase 22 {label}: {c}")
    row = dict(counts=c, wall_s=min(walls))
    print(f"  {label}: {json.dumps(row)} on {card}", flush=True)
    return out, row


def d853_grid(label, trace, n, probe_key="attempts"):
    """A DOP853 launch and its DP45 twin on the same 1024^2 rays, in turns
    (DP45, DOP853, DOP853, DP45), each alone by CUDA events behind the spin
    kernel: their times, attempts a ray, slowest ray and lane efficiency
    (attempts over 32 x the warp step sum). trace(method, **kw) -> result
    with n_steps."""
    import torch
    rows = {"dp45": dict(ms=[]), "dop853": dict(ms=[])}
    for method in ("dp45", "dop853", "dop853", "dp45"):
        rows[method]["ms"].append(kernel_alone_ms(
            lambda: trace(method), 1))
    for method, row in rows.items():
        probe = {}
        res = trace(method, probe=probe)
        a = probe[probe_key].to(torch.int64)
        row.update(ms=float(np.median(row["ms"])), n=n,
                   attempts_sum=int(a.sum()),
                   attempts_mean=float(a.double().mean()),
                   slowest_attempts=int(a.max()),
                   slowest_ray=int(a.argmax()),
                   n_steps=int(res.n_steps),
                   lane_efficiency=int(a.sum()) / (32 * int(res.n_steps)))
    print(f"  {label}, each alone (median of 2 turns): "
          f"{json.dumps(rows)}", flush=True)
    return rows


def dop853_phase(dev, card, ctx):
    """Phase 22: the DOP853 library's build and resources; every DOP853
    instance against the plain loop on the card (the Kerr shadow on phase
    3's kinds of rays, its Kerr-Newman and Johannsen-Psaltis instances,
    linear event location, the disk variant on phase 8's, the extras forms
    on phases 11's and 14's) in float32 and float64 by phases 3, 8, 11,
    14 and 17's gates; the DOP853 and DP45 launches side by side on the
    main-path, config-4 and volumetric grids; the paths at 1024^2 through
    the entry points with integrator="dop853" (each with its counts set to
    0 before it and read after: only DOP853 instances launch, no DP45 one
    and no plain loop); 64^2 renders on the card against the CPU in
    float64. Returns the kernels-line entries."""
    import torch
    from light_path_tracer_tpu_torch import (aa, adaptive, camera, disk,
                                             pipeline, polarization,
                                             volumetric)
    from light_path_tracer_tpu_torch.models import (JohannsenPsaltis, Kerr,
                                                    KerrNewman)
    from light_path_tracer_tpu_torch.ops import kerr_trace as tk
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    from light_path_tracer_tpu_torch.utils.config import (RenderConfig,
                                                          SceneConfig)
    t_phase = time.perf_counter()
    D = dict(method="dop853")
    f32 = dict(dtype=torch.float32, device=dev)
    print(f"DOP853 and linear event location (phase 22) on {card}:",
          flush=True)
    # (d)'s plain loops, queued to the children first: phase 11's rays.
    kerr_v = Kerr(M=1.0, a=0.9)
    acv = kerr_v.alpha_crit(R_OBS, THETA_VOL)
    rng = np.random.default_rng(0)
    al_v = torch.tensor(rng.uniform(0.3 * acv, 4 * acv, VOL_RAYS), **f32)
    th_v = torch.tensor(rng.uniform(-np.pi, np.pi, VOL_RAYS), **f32)
    forms11 = volumetric_forms()
    forms11.pop("jet")      # VolThin's instance, as the thin form
    forms11.pop("spectral 2-band")   # on no path; the card tests hold it
    pool, jobs = ctx["pool"], {}
    for label, (riaf, freqs) in forms11.items():
        for k, (a, t) in enumerate(((al_v, th_v),
                                    (al_v.double(), th_v.double()))):
            jobs[label, k] = pool.submit(
                "extras_trace", kerr_v, riaf, freqs, a, t, D853_AUX_STEPS,
                False, sat_window=AUX_WINDOW, **D)
    aux_labels = [label for label in aux_forms(kerr_v, al_v, th_v)
                  if label != "stokes vertical"]
    for label in aux_labels:
        for k in (0, 1):
            jobs[label, k] = pool.submit(
                "aux_plain", kerr_v, label, al_v, th_v, D853_AUX_STEPS,
                f64=bool(k), sat_window=AUX_WINDOW, **D)

    # -- (a) the DOP853 library: its build and every instance's resources
    lib, build_s = ctx["build"].result()
    print(f"  DOP853 library: built in {build_s:.2f} s by a child process "
          f"at nice 19 beside phases 11 on -> "
          f"{os.path.basename(lib._name)}", flush=True)
    report = ptxas_report(lib.build_log)
    extras_resources(report, "dop853")
    for name, regs, spill in report:
        r = RESOURCES.get(name)
        more = (f"; {r['blocks_per_sm']} blocks an SM (block bound "
                f"{r['min_blocks']})" if r else "")
        print(f"  ptxas: {name}: {regs} registers; {spill}{more}",
              flush=True)
    kerr_res = {name: dict(registers=regs, spill=spill)
                for name, regs, spill in report
                if name.startswith("kerr_dop853<")}

    # -- (b) the Kerr instances against the plain loop --------------------
    kerr = Kerr(M=1.0, a=0.9)
    ac = kerr.alpha_crit(R_OBS)
    alphas, thetas, refine = ctx["kerr_rays"]
    g = {}
    for label, kw in (("hermite", D), ("linear",
                                       dict(D, event_interp="linear"))):
        g[label] = both_versions(f"DOP853 {label}, 4096 random rays",
                                 kerr, alphas, thetas, refine, D853_RAY_STEPS,
                                 5, **kw)
        require(g[label]["status_agree"] > 0.99 and g[label]["p99"] < 2e-3,
                f"phase 22 DOP853 {label} 4096-ray gate: {g[label]}")
        m = F64_RAYS
        g[label + " f64"] = both_versions(
            f"DOP853 {label}, {m} random rays, float64", kerr,
            alphas[:m].double(), thetas[:m].double(), refine[:m],
            D853_RAY_STEPS, 3, **kw)
        require(g[label + " f64"]["status_agree"] > 0.999
                and g[label + " f64"]["p99"] < 1e-6,
                f"phase 22 DOP853 {label} float64 gate: {g[label + ' f64']}")
    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=R_OBS)
    cfg = RenderConfig()
    dim = ctx["main_dim"]
    fov = camera.fov_from_vertical(scene.vertical_fov, dim)
    al_m, th_m, rf_m, _rows = pipeline.trace_inputs(scene, cfg, dim, fov,
                                                    dev)
    g["main"] = both_versions(
        f"DOP853 1024^2 main-path rays, both capped at {D853_GRID_STEPS}",
        kerr, al_m, th_m, rf_m, D853_GRID_STEPS, 3, **D)
    require(g["main"]["status_agree"] > 0.99 and g["main"]["p99"] < 2e-3
            and g["main"]["mask_agree"] >= 0.995,
            f"phase 22 DOP853 main-path gate: {g['main']}")
    main_args = (kerr, R_OBS, al_m, th_m, np.pi / 2, rf_m, LAMBDA_MAX,
                 cfg.max_steps)
    grid_main = d853_grid("Kerr shadow, 1024^2 main-path rays, full depth",
                          lambda method, **kw: kk.trace_rays_kerr_cuda(
                              *main_args, method=method, **kw),
                          int(al_m.numel()))
    slow = grid_main["dop853"]["slowest_ray"]
    one = dict(alpha=float(al_m[slow]), theta=float(th_m[slow]),
               refine=bool(rf_m[slow]))
    for dtype in (torch.float32, torch.float64):
        for method in ("dp45", "dop853"):
            probe = {}
            kk.trace_rays_kerr_cuda(
                kerr, R_OBS, al_m[slow:slow + 1].to(dtype),
                th_m[slow:slow + 1].to(dtype), np.pi / 2,
                rf_m[slow:slow + 1], LAMBDA_MAX, cfg.max_steps,
                method=method, probe=probe)
            one[f"{method} {str(dtype)[6:]}"] = dict(
                attempts=int(probe["attempts"][0]),
                status=int(probe["raw_status"][0]),
                cycles=int(probe["cycles"][0]))
    one["alone_ms"] = cuda_ms(lambda: kk.trace_rays_kerr_cuda(
        kerr, R_OBS, al_m[slow:slow + 1], th_m[slow:slow + 1], np.pi / 2,
        rf_m[slow:slow + 1], LAMBDA_MAX, cfg.max_steps, **D), 3)[0]
    print(f"  the main path's slowest DOP853 ray, alone: {json.dumps(one)}",
          flush=True)

    fam = {"kn": (KerrNewman(**KN_ARGS), "kerr_newman"),
           "jp": (JohannsenPsaltis(**JP_ARGS), "johannsen_psaltis")}
    # Johannsen-Psaltis's alpha_crit as phase 21 takes it (the card's DP45
    # bisection, outside every counted path); Kerr-Newman's is the host's.
    acs = {"kn": fam["kn"][0].alpha_crit(R_OBS),
           "jp": fam["jp"][0].alpha_crit(R_OBS, np.pi / 2, device="cuda")}
    for name, (metric, _family) in fam.items():
        acf = acs[name]
        rng = np.random.default_rng(21)
        al = torch.tensor(rng.uniform(0.2 * acf, 4 * acf, 4096), **f32)
        th = torch.tensor(rng.uniform(-np.pi, np.pi, 4096), **f32)
        rf = torch.tensor(rng.random(4096) < 0.2, device=dev)
        g[name] = both_versions(f"DOP853 {name} 4096 random rays", metric,
                                al, th, rf, D853_RAY_STEPS, 5, **D)
        require(g[name]["status_agree"] > 0.99 and g[name]["p99"] < 2e-3,
                f"phase 22 DOP853 {name} gate: {g[name]}")
        g[name + " f64"] = both_versions(
            f"DOP853 {name} {F64_RAYS} random rays, float64", metric,
            al[:F64_RAYS].double(), th[:F64_RAYS].double(), rf[:F64_RAYS],
            D853_RAY_STEPS, 3, **D)
        require(g[name + " f64"]["status_agree"] > 0.999
                and g[name + " f64"]["p99"] < 1e-6,
                f"phase 22 DOP853 {name} float64 gate: {g[name + ' f64']}")

    # -- (c) the disk variant against the plain loop ----------------------
    al_d, th_d = ctx["disk_rays"]
    gd = {}
    gd["opaque"] = disk_both("DOP853 disk, 4096 random rays, opaque", kerr,
                             al_d, th_d, D853_RAY_STEPS, ctx["opaque"], 2, 5,
                             **D)
    translucent = ctx["opaque"][:3] + (False,)
    gd["momenta"] = disk_both(
        "DOP853 disk, 4096 random rays, translucent, momenta", kerr, al_d,
        th_d, D853_RAY_STEPS, translucent, 2, 5, record_momentum=True, **D)
    gd["f64"] = disk_both(f"DOP853 disk, {F64_RAYS} random rays, float64",
                          kerr, al_d[:F64_RAYS].double(),
                          th_d[:F64_RAYS].double(), D853_RAY_STEPS,
                          ctx["opaque"], 2, 3, **D)
    require(gd["f64"]["status_agree"] > 0.999
            and gd["f64"]["nhits_agree"] > 0.999
            and gd["f64"]["median_dr"] < 1e-6,
            f"phase 22 DOP853 disk float64 gate: {gd['f64']}")
    kn = fam["kn"][0]
    plane_kn = (disk.r_isco(1.0, 0.6, Q=0.6), 20.0, np.pi / 2, True)
    gd["kn"] = disk_both("DOP853 kn disk, 4096 random rays, opaque", kn,
                         al_d, th_d, D853_RAY_STEPS, plane_kn, 2, 5, **D)
    scene4 = SceneConfig(M=1.0, a=0.9, r_obs_mult=R_OBS,
                         theta_obs=THETA_DISK)
    fov4 = camera.fov_from_vertical(scene4.vertical_fov, dim)
    al4 = camera.build_alpha_lookup(dim, fov4, **f32).reshape(-1)
    th4 = camera.build_theta_lookup(dim, fov4, **f32).reshape(-1)
    gd["grid"] = disk_both(
        f"DOP853 1024^2 config-4 grid, max_steps {D853_GRID_STEPS}", kerr,
        al4, th4, D853_GRID_STEPS, ctx["opaque"], 2, 3, **D)
    disk_args = (kerr, R_OBS, al4, th4, THETA_DISK, LAMBDA_MAX,
                 cfg.max_steps, ctx["opaque"], 2)
    grid_disk = d853_grid("disk, 1024^2 config-4 grid, full depth",
                          lambda method, **kw: kk.trace_disk_rays_cuda(
                              *disk_args, method=method, **kw),
                          int(al4.numel()))
    del al4, th4

    # -- (d) the extras forms against the plain loop ----------------------
    print(f"  DOP853 extras kernel vs plain loop ({VOL_RAYS} random rays, "
          f"max_steps {D853_AUX_STEPS}, sat_window {AUX_WINDOW}; float32, "
          f"then float64 on the same rays):", flush=True)
    ge = {}
    for label, (riaf, freqs) in forms11.items():
        kw = dict(sat_window=AUX_WINDOW, **D)
        probe = {}
        ms, rk = cuda_ms(lambda: extras_trace(
            kerr, riaf, freqs, al_v, th_v, D853_AUX_STEPS, True, probe=probe,
            **kw), 3)
        plain_ms, rp = PlainPool.result(jobs[label, 0], dev)
        e = extras_compare(rk, rp)
        e.update(ms=ms, plain_ms=plain_ms, n_steps_kernel=int(rk[0].n_steps))
        e.update(attempts_stats(probe["attempts"], lambda i: extras_trace(
            kerr, riaf, freqs, al_v[i:i + 1], th_v[i:i + 1], D853_AUX_STEPS,
            True, **kw)))
        gap, (rp64, plain64_ms) = f32_gap(kerr, riaf, freqs, al_v, th_v,
                                          D853_AUX_STEPS, rp,
                                          job64=jobs[label, 1])
        extras_gate(f"phase 22 DOP853 {label}", e, gap)
        p64 = {}
        ms64, rk64 = cuda_ms(lambda: extras_trace(
            kerr, riaf, freqs, al_v.double(), th_v.double(), D853_AUX_STEPS,
            True, probe=p64, **kw), 3)
        e64 = extras_compare(rk64, rp64)
        e64.update(ms=ms64, plain_ms=plain64_ms, attempts_sum=int(
            p64["attempts"].to(torch.int64).sum()))
        tau = max(float(t.abs().max()) for t in rp64[2])
        f64_extras_gate(f"DOP853 {label}", e64, tau)
        f64_bitwise_gate("phase 22 DOP853", label, e64,
                         extras_bitwise(rk64, rp64))
        ge[label], ge[label + " f64"] = e, e64
        print(f"    {label}: {json.dumps(e)}\n    {label} float64: "
              f"{json.dumps(e64)}", flush=True)
    forms = aux_forms(kerr, al_v, th_v)
    forms.pop("stokes vertical")
    for label, form in forms.items():
        e = aux_both("phase 22 DOP853", kerr, label, form, al_v, th_v,
                     D853_AUX_STEPS, AUX_WINDOW,
                     jobs=(jobs[label, 0], jobs[label, 1]), **D)
        p64 = {}
        ms64, rk64 = cuda_ms(lambda: aux_trace(
            kerr, form, al_v.double(), th_v.double(), D853_AUX_STEPS, True,
            sat_window=AUX_WINDOW, probe=p64, **D), 3)
        e64 = aux_compare(rk64, e["plain64"][1], label, len(form[3]))
        e64.update(ms=ms64, plain_ms=e["plain64"][0], attempts_sum=int(
            p64["attempts"].to(torch.int64).sum()))
        if label.startswith("order"):
            require(e64["status_agree"] > 0.999 and order_gate(e64),
                    f"phase 22 DOP853 {label} float64 gate: {e64}")
        else:
            f64_extras_gate(f"DOP853 {label}", e64)
        f64_bitwise_gate("phase 22 DOP853", label, e64, bitwise_list(
            aux_outputs(rk64), aux_outputs(e["plain64"][1])))
        e.pop("plain64")
        ge[label], ge[label + " f64"] = e, e64
        print(f"    {label} float64: {json.dumps(e64)}", flush=True)
    del al_v, th_v

    scene_v = SceneConfig(M=1.0, a=0.9, r_obs_mult=R_OBS,
                          theta_obs=THETA_VOL, vertical_fov_deg=16.0)
    fov_v = camera.fov_from_vertical(scene_v.vertical_fov, VOL_DIM)
    al12 = camera.build_alpha_lookup(VOL_DIM, fov_v, **f32).reshape(-1)
    th12 = camera.build_theta_lookup(VOL_DIM, fov_v, **f32).reshape(-1)
    thin = scene_forms()["volumetric thin"]
    grid_vol = d853_grid(
        "volumetric thin, 1024^2 scene, one pass, full depth",
        lambda method, **kw: extras_trace(
            kerr, thin[0], None, al12, th12, 200000, True, method=method,
            sat_window=2048, **kw)[0], int(al12.numel()))
    riaf3, freqs3 = scene_forms()["spectral 3-band"]
    grid_aux = d853_grid(
        "spectral 3-band (the aux entry), 1024^2 scene, one pass",
        lambda method, **kw: extras_trace(
            kerr, riaf3, freqs3, al12, th12, 200000, True, method=method,
            sat_window=2048, **kw)[0], int(al12.numel()))
    del al12, th12

    # -- (e) the paths at 1024^2 through the entry points ----------------
    cfg_d = RenderConfig(integrator="dop853")
    paths = {}
    img, row = d853_path("1024^2 Kerr a=0.9 shadow", lambda:
                         pipeline.render_shadow(scene, dim, cfg_d,
                                                device="cuda"),
                         "kerr", runs=3, card=card)
    img, st = img
    black = img == 0.0
    alpha = camera.build_alpha_lookup(dim, fov, device=dev)
    n_disk = int((alpha < ac).sum())
    ratio = int(black.sum()) / max(n_disk, 1)
    # The image's black pixels are the rays not escaped: captured, or
    # INVALID. Phase 4's gate counts every black pixel outside 1.01
    # alpha_crit; here the captured rays are held to it, and each INVALID
    # ray must end INVALID in the plain float32 loop too (the kernel
    # computes what its plain version does) and not in float64: a float32
    # DOP853 step can land within ~4e-5 rad of the polar axis, its next
    # stages overflow and the hard rejects shrink h below h_min (ROADMAP
    # Queue 3 #8).
    st_rays = kk.trace_rays_kerr_cuda(*main_args, **D).status
    outside_rays = al_m >= 1.01 * ac
    invalid = st_rays == 0
    inv_idx = torch.nonzero(invalid)[:64, 0]
    inv_args = (kerr, R_OBS, al_m[inv_idx], th_m[inv_idx], np.pi / 2,
                rf_m[inv_idx], LAMBDA_MAX, cfg.max_steps)
    inv_plain = tk.trace_rays_kerr(*inv_args, **D).status
    inv_f64 = kk.trace_rays_kerr_cuda(
        kerr, R_OBS, al_m[inv_idx].double(), th_m[inv_idx].double(),
        *inv_args[4:], **D).status
    row.update(traced_rays=st["traced_rays"],
               integrator_steps=st["integrator_steps"],
               rays_per_s=st["traced_rays"] / st["timings"]["precompute"],
               black_ratio=ratio,
               black_outside=int((black & (alpha >= 1.01 * ac)).sum()),
               captured_outside_rays=int(((st_rays == -1)
                                          & outside_rays).sum()),
               invalid_rays=int(invalid.sum()),
               invalid_in_refine_band=int((invalid & rf_m).sum()),
               invalid_plain_status=inv_plain.tolist(),
               invalid_f64_status=inv_f64.tolist(),
               invalid_alpha_over_ac=(al_m[inv_idx].double() / ac).tolist(),
               invalid_theta=th_m[inv_idx].tolist(),
               profile=device_profile(lambda: pipeline.render_shadow(
                   scene, dim, cfg_d, device="cuda"), 3, "kerr_dop853",
                   lambda: kk.trace_rays_kerr_cuda.launches_dop853))
    print(f"  main path with DOP853: {json.dumps(row)}", flush=True)
    require(st["traced_rays"] == 524288 and bool(torch.isfinite(img).all())
            and 0.45 <= ratio <= 0.65 and row["captured_outside_rays"] == 0
            and all(v == 0 for v in row["invalid_plain_status"])
            and all(v != 0 for v in row["invalid_f64_status"]),
            f"phase 22 DOP853 shadow image: {row}")
    del al_m, th_m, rf_m
    paths["shadow"] = row
    img_lin, row = d853_path(
        "1024^2 shadow, linear events", lambda: pipeline.render_shadow(
            scene, dim, RenderConfig(integrator="dop853",
                                     event_interp="linear"),
            device="cuda"), "kerr", card=card)
    paths["shadow linear"] = row
    agree = float((img_lin[0] == img).float().mean())
    print(f"  linear against Hermite events, shadow pixels equal: {agree}",
          flush=True)
    require(agree >= 0.999, f"phase 22 linear shadow: {agree}")
    src = np.random.default_rng(5).random(dim + (3,)).astype(np.float32)
    for label, render in (
            ("lens", lambda: pipeline.render_scene(
                scene, src, RenderConfig(integrator="dop853",
                                         sampling="bilinear"),
                device="cuda")),
            ("aa4", lambda: aa.render_shadow_aa(
                scene, dim, cfg_d, aa_samples=4, device="cuda")),
            ("adaptive4", lambda: adaptive.render_shadow_adaptive(
                scene, dim, cfg_d, aa_samples=4, device="cuda"))):
        out, row = d853_path(f"1024^2 {label}", render, "kerr", card=card)
        img_l = out.image if label == "lens" else out[0]
        require(bool(torch.isfinite(img_l).all()), f"phase 22 {label}")
        paths[label] = row
    for name, (metric, _family) in fam.items():
        kw = dict(KN_ARGS) if name == "kn" else dict(JP_ARGS)
        scene_f = SceneConfig(r_obs_mult=R_OBS, **kw)
        with card_alpha_crit(acs[name]):
            out, row = d853_path(f"1024^2 {name} shadow", lambda:
                                 pipeline.render_shadow(
                                     scene_f, dim, cfg_d, device="cuda"),
                                 "kerr", card=card)
        require(bool(torch.isfinite(out[0]).all()), f"phase 22 {name}")
        paths[name] = row
    disk_cfg = disk.DiskConfig()
    out, row = d853_path("config 4, 1024^2 disk", lambda: disk.render_disk(
        scene4, dim, cfg_d, disk_cfg, device="cuda"), "disk", runs=3,
        card=card)
    img4, st4 = out
    left = float(img4[:, :512].double().sum())
    right = float(img4[:, 512:].double().sum())
    row.update(rays_per_s=st4["traced_rays"] / st4["timings"]["precompute"],
               disk_pixels=st4["disk_pixels"], captured=st4["captured"],
               half_ratio=max(left, right) / max(min(left, right), 1e-9),
               profile=device_profile(lambda: disk.render_disk(
                   scene4, dim, cfg_d, disk_cfg, device="cuda"), 3,
                   "kerr_dop853",
                   lambda: kk.trace_disk_rays_cuda.launches_dop853))
    require(row["counts"]["disk_driver"] >= 2 and row["half_ratio"] > 2.0
            and bool(torch.isfinite(img4).all())
            and float(img4.min()) >= 0.0 and float(img4.max()) <= 1.0,
            f"phase 22 DOP853 config 4: {row}")
    paths["disk"] = row
    print(f"  config 4 with DOP853: {json.dumps(row)}", flush=True)
    period = 2.0 * np.pi / abs(volumetric.keplerian_omega(1.0, 0.9, 6.0,
                                                           True))
    times = tuple(period * k / N_FRAMES for k in range(N_FRAMES))
    for label, want, render in (
            ("volumetric thin", "volumetric", lambda: (
                volumetric.render_volumetric(scene_v, VOL_DIM, cfg_d,
                                             device="cuda"))),
            ("volumetric absorbed", "volumetric", lambda: (
                volumetric.render_volumetric(
                    scene_v, VOL_DIM, cfg_d, volumetric.RIAFConfig(
                        alpha0=0.3), device="cuda"))),
            ("spectrum 3-band", "aux", lambda: (
                volumetric.render_volumetric_spectrum(
                    scene_v, VOL_DIM, freqs3, cfg_d, riaf3,
                    device="cuda"))),
            ("movie 8-frame", "aux", lambda: (
                volumetric.render_volumetric_movie(
                    scene_v, VOL_DIM, times, cfg_d,
                    volumetric.RIAFConfig(spot_amp=8.0), device="cuda"))),
            ("movie 8-frame absorbed", "aux", lambda: (
                volumetric.render_volumetric_movie(
                    scene_v, VOL_DIM, times, cfg_d,
                    volumetric.RIAFConfig(spot_amp=8.0, alpha0=0.3),
                    device="cuda"))),
            ("decomposed x3", "aux", lambda: (
                volumetric.render_volumetric_decomposed(
                    scene_v, VOL_DIM, cfg_d, n_orders=N_ORDERS,
                    device="cuda"))),
            ("polarized", "aux", lambda: (
                polarization.render_polarized_volumetric(
                    scene_v, VOL_DIM, cfg_d, p0=P0, device="cuda")))):
        out, row = d853_path(f"1024^2 {label}", render, want, card=card)
        paths[label] = row

    # -- (f) 64^2 renders on the card against the CPU, float64 -----------
    d64 = (64, 64)
    cfg64 = RenderConfig(dtype="float64", integrator="dop853")
    scene_s = SceneConfig(M=1.0, a=0.9, r_obs_mult=R_OBS,
                          vertical_fov_deg=12.0)
    checks, f64_launches = {}, {}
    times3 = times[:3]
    f64_paths = [
        ("shadow", "kerr_f64", True, lambda d: pipeline.render_shadow(
            scene_s, d64, cfg64, device=d)[0]),
        ("disk", "disk_f64", True, lambda d: disk.render_disk(
            scene4, d64, cfg64, device=d)[0]),
        ("volumetric thin", "volumetric_f64", True, lambda d: (
            volumetric.render_volumetric(scene_v, d64, cfg64,
                                         device=d)[0])),
        ("volumetric absorbed", "volumetric_f64", False, lambda d: (
            volumetric.render_volumetric(
                scene_v, d64, cfg64, volumetric.RIAFConfig(alpha0=0.3),
                device=d))),
        ("spectrum 3-band", "aux_f64", False, lambda d: (
            volumetric.render_volumetric_spectrum(
                scene_v, d64, freqs3, cfg64, riaf3, device=d))),
        ("movie 8-frame", "aux_f64", False, lambda d: (
            volumetric.render_volumetric_movie(
                scene_v, d64, times3, cfg64,
                volumetric.RIAFConfig(spot_amp=8.0), device=d))),
        ("movie 8-frame absorbed", "aux_f64", False, lambda d: (
            volumetric.render_volumetric_movie(
                scene_v, d64, times3, cfg64,
                volumetric.RIAFConfig(spot_amp=8.0, alpha0=0.3),
                device=d))),
        ("decomposed x3", "aux_f64", False, lambda d: (
            volumetric.render_volumetric_decomposed(
                scene_v, d64, cfg64, n_orders=N_ORDERS, device=d))),
        ("polarized", "aux_f64", False, lambda d: (
            polarization.render_polarized_volumetric(
                scene_v, d64, cfg64, p0=P0, device=d)))]
    for name in fam:
        kw = dict(KN_ARGS) if name == "kn" else dict(JP_ARGS)
        scene_f = SceneConfig(r_obs_mult=R_OBS, vertical_fov_deg=12.0, **kw)
        f64_paths.append((name, "kerr_f64", False, lambda d, s=scene_f: (
            pipeline.render_shadow(s, d64, cfg64, device=d))))
    for label, want, on_cpu, render in f64_paths:
        d853_zero()
        with card_alpha_crit(acs["jp"]):
            og = render("cuda")
        torch.cuda.synchronize()
        c = d853_counts()
        f64_launches[label] = c[want]
        n32 = sum(v for k, v in c.items() if k in ("kerr", "disk",
                                                     "volumetric", "aux"))
        require(c[want] > 0 and n32 == 0 and c["plain"] == 0
                and all(v == 0 for k, v in c.items()
                        if k.endswith("_dp45")),
                f"phase 22 float64 64^2 {label}: {c}")
        if not on_cpu:
            continue
        oc = render("cpu")
        if label == "shadow":
            checks[label] = dict(pixels_equal=float(
                (og.cpu() == oc).float().mean()))
            ok = checks[label]["pixels_equal"] >= 0.999
        else:
            mg, mc = og.cpu() > 0, oc > 0
            both = mg & mc
            checks[label] = dict(
                mask_agree=float((mg == mc).float().mean()),
                median=float((og.cpu() - oc).abs()[both].median()))
            ok = (checks[label]["mask_agree"] >= 0.999
                  and checks[label]["median"] < 1e-6)
        require(ok, f"phase 22 64^2 {label} card vs CPU: {checks[label]}")
    print(f"  64^2 float64 renders with DOP853, card vs CPU: "
          f"{json.dumps(checks)}; float64 launches of every 64^2 path "
          f"{json.dumps(f64_launches)}", flush=True)
    print(f"phase 22: {time.perf_counter() - t_phase:.1f} s", flush=True)

    # -- the kernels-line entries -----------------------------------------
    shadow_bytes = {"float32": 9 + 12, "float64": 17 + 16}
    disk_bytes = {"float32": 8 + 20 + 16, "float64": 16 + 28 + 32}

    codes = {"kerr": 0, "kerr_newman": 1, "johannsen_psaltis": 2}

    def kerr_entry(name, gg, launches, dtype, family="kerr", disk_=False,
                   grid=None, hits=(1, 0)):
        source = D853_SOURCE.format("" if dtype == "float32" else "_f64")
        replaces = f"{JAX_KERNELS}:316" if disk_ else REPLACES
        per_ray = (disk_bytes if disk_ else shadow_bytes)[dtype]
        work = bounds.kerr_work(dtype, family, "dop853")
        inst = (f"kerr_dop853<{'float' if dtype == 'float32' else 'double'},"
                f"family={codes[family]},disk={int(disk_)},hits={hits[0]},"
                f"momentum={hits[1]}>")
        e = _kerr_entry(name, source, replaces, gg, launches, per_ray, work,
                        grid, disk_)
        e.update(instance=inst, **kerr_res.get(inst, {}))
        return e

    def _kerr_entry(name, source, replaces, gg, launches, per_ray, work,
                    grid, disk_):
        # ms, plain_ms and the bounds of the kernel-vs-plain call gg (on
        # the 1024^2 grids both capped at D853_GRID_STEPS); grid: the same
        # rays at full depth, the DOP853 launch and its DP45 twin alone
        e = kernel_entry(name, source, replaces, launches,
                         gg["max_dr" if disk_ else "max_abs"], gg["ms"],
                         gg["plain_ms"], gg["n"], per_ray,
                         gg["attempts_sum"] * work, gg)
        e.update({k: gg[k] for k in ("kernel_ms", "attempts_mean",
                                     "lane_efficiency") if k in gg})
        if grid is not None:
            e.update(max_steps=D853_GRID_STEPS, full_depth=grid,
                     full_depth_bound_ms=bounds.flops_bound_ms(
                         grid["dop853"]["attempts_sum"] * work,
                         gg["n"] * per_ray)[0])
        return e

    kernels = [
        kerr_entry("kerr_dop853", g["main"], paths["shadow"]["counts"]
                   ["kerr"], "float32", grid=grid_main),
        kerr_entry("kerr_dop853_linear", g["linear"],
                   paths["shadow linear"]["counts"]["kerr"], "float32"),
        kerr_entry("kerr_dop853_f64", g["hermite f64"],
                   f64_launches["shadow"], "float64"),
        kerr_entry("kerr_dop853_kn", g["kn"], paths["kn"]["counts"]["kerr"],
                   "float32", "kerr_newman"),
        kerr_entry("kerr_dop853_jp", g["jp"], paths["jp"]["counts"]["kerr"],
                   "float32", "johannsen_psaltis"),
        kerr_entry("kerr_dop853_kn_f64", g["kn f64"], f64_launches["kn"],
                   "float64", "kerr_newman"),
        kerr_entry("kerr_dop853_jp_f64", g["jp f64"], f64_launches["jp"],
                   "float64", "johannsen_psaltis"),
        kerr_entry("trace_disk_rays_dop853", gd["grid"],
                   paths["disk"]["counts"]["disk"], "float32", disk_=True,
                   grid=grid_disk, hits=(2, 0)),
        kerr_entry("trace_disk_rays_dop853_f64", gd["f64"],
                   f64_launches["disk"], "float64", disk_=True,
                   hits=(2, 0))]
    kernels[0]["dp45_main_path_ms"] = grid_main["dp45"]["ms"]
    labels = {"thin": ("volumetric thin", "VolThin<{}>", "thin", 0, False),
              "absorbed": ("volumetric absorbed", "VolAbsorbed<{}>",
                           "absorbed", 0, False),
              "spectral 3-band": ("spectrum 3-band", "Spectral<3,{}>",
                                  "spectral", 3, False),
              "stokes toroidal": ("polarized", "Stokes<{}>", "stokes", 0,
                                  False),
              "movie thin": ("movie 8-frame", "Movie<8,absorbing=0,{}>",
                             "movie", N_FRAMES, False),
              "movie absorbed": ("movie 8-frame absorbed",
                                 "Movie<8,absorbing=1,{}>", "movie",
                                 N_FRAMES, True),
              "order thin": ("decomposed x3", "Order<3,absorbing=0,{}>",
                             "order", N_ORDERS, False),
              "order absorbed": (None, "Order<3,absorbing=1,{}>", "order",
                                 N_ORDERS, True)}
    for label, (path, inst, kind, width, ab) in labels.items():
        if path is None:
            continue
        for dtype, real, suffix in (("float32", "float", ""),
                                    ("float64", "double", " f64")):
            e = ge[label + suffix]
            src = D853_SOURCE.format(
                {"stokes": "_stokes", "order": "_orders",
                 "movie": "_movie_absorbed" if ab else "_movie_thin"}.get(
                     kind, "_extras") + ("_f64" if dtype == "float64"
                                         else ""))
            replaces = (f"{VOL_JAX}:53" if kind in ("thin", "absorbed")
                        else f"{VOL_JAX}:276")
            counter = "volumetric" if kind in ("thin", "absorbed") else "aux"
            launches = (paths[path]["counts"][counter] if dtype == "float32"
                        else f64_launches[path])
            n_extras = bounds.components(kind, width, ab) - 5
            work = bounds.extras_work(kind, width, ab, dtype=dtype,
                                      method="dop853")
            k = kernel_entry(
                f"kerr_dop853_extras_{label.replace(' ', '_')}"
                + ("_f64" if dtype == "float64" else ""), src, replaces,
                launches, e.get("max_abs_em", e.get("max_abs")), e["ms"],
                e["plain_ms"], VOL_RAYS,
                (8 if dtype == "float32" else 16) + (4 + n_extras) * (
                    4 if dtype == "float32" else 8),
                e["attempts_sum"] * work, e,
                instance=f"kerr_dop853_extras<{inst.format(real)}>")
            k["attempts_mean"] = e["attempts_sum"] / VOL_RAYS
            kernels.append(k)
    vol_main = kernels[[k["name"] for k in kernels].index(
        "kerr_dop853_extras_thin")]
    vol_main["scene_1024"] = grid_vol
    aux_main = kernels[[k["name"] for k in kernels].index(
        "kerr_dop853_extras_spectral_3-band")]
    aux_main["scene_1024"] = grid_aux
    return kernels



# Phase 23: the mu = cos(theta) chart (the hybrid tracer) through the Kerr
# kernel, and charged (Kerr-Newman) volumetric scenes through the extras
# kernel.
MU_SOURCE = "light_path_tracer_tpu_torch/csrc/kerr_{}_mu{}.cu"
KN_SOURCE = "light_path_tracer_tpu_torch/csrc/kerr_{}_{}_kn{}.cu"
HYBRID_REPLACES = "light_path_tracer_tpu/ops/kerr_trace.py:1269"
# The random rays of (a): float32, float64, and the attempt cap of both
# versions; (d)'s cap (the extras plain loop costs ~50-400 ms an
# iteration); the cap of (b)'s 1024^2 hybrid against the plain loop.
MU_RAYS, MU_RAYS_F64, MU_STEPS = 4096, 1024, 256
KN_STEPS = 128
HYB_STEPS = 256
# The children that run phase 23's plain loops on the card (and its CPU
# renders) side by side once its kernels are timed: the plain loop is
# host-bound, one process a core (the card's host has 8).
P23_WORKERS = 8
MU_FAMILIES = {"kerr": dict(M=1.0, a=0.9), "kerr_newman": KN_ARGS}
KN_FORMS = ("thin", "absorbed", "spectral 3-band", "movie thin",
            "movie absorbed", "order thin", "order absorbed")


def p23_metric(family):
    from light_path_tracer_tpu_torch.models import Kerr, KerrNewman
    if family == "kerr":
        return Kerr(**MU_FAMILIES["kerr"])
    return KerrNewman(**MU_FAMILIES["kerr_newman"])


def p23_mu_rays(family, dtype, dev):
    """(a)'s rays of a family: uniform in [0.3, 4] alpha_crit and over the
    screen azimuth, 20 % in the axis-refine band, with the hybrid's poison
    mask (the first pole-risk rays, which the mu instance starts
    INVALID)."""
    import torch
    from light_path_tracer_tpu_torch.ops import kerr_trace as tk
    m = p23_metric(family)
    ac = m.alpha_crit(R_OBS)
    n = MU_RAYS if dtype == "float32" else MU_RAYS_F64
    rng = np.random.default_rng(23)
    t = dict(dtype=getattr(torch, dtype), device=dev)
    al = torch.tensor(rng.uniform(0.3 * ac, 4 * ac, MU_RAYS)[:n], **t)
    th = torch.tensor(rng.uniform(-np.pi, np.pi, MU_RAYS)[:n], **t)
    rf = torch.tensor(rng.random(MU_RAYS)[:n] < 0.2, device=dev)
    poison = tk.hybrid_poison(m, R_OBS, al, th, np.pi / 2,
                              tk.hybrid_slots(n))
    return m, (m, R_OBS, al, th, np.pi / 2, rf, LAMBDA_MAX, MU_STEPS), poison


def p23_kn_rays(dtype, dev):
    """(d)'s 4,096 random rays of the charged scene (theta_obs 80 deg),
    in [0.3, 4] alpha_crit."""
    import torch
    m = p23_metric("kerr_newman")
    ac = m.alpha_crit(R_OBS, THETA_VOL)
    rng = np.random.default_rng(231)
    t = dict(dtype=getattr(torch, dtype), device=dev)
    return (m, torch.tensor(rng.uniform(0.3 * ac, 4 * ac, VOL_RAYS), **t),
            torch.tensor(rng.uniform(-np.pi, np.pi, VOL_RAYS), **t))


def p23_kn_call(form, dtype, method, kernel, dev):
    """One of (d)'s Kerr-Newman traces with its rays, metric, transfer and
    aux built once: returns call(**kw), which runs the kernel wrapper
    (kernel=True) or the plain loop alone (kw: probe) and returns the
    outputs as a list, the status first."""
    from light_path_tracer_tpu_torch import volumetric
    from light_path_tracer_tpu_torch.ops import kerr_trace
    from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk
    m, al, th = p23_kn_rays(dtype, dev)
    base = dict(sat_window=AUX_WINDOW, method=method)
    args = (m, R_OBS, al, th, THETA_VOL)

    def flat(res):
        return [res.status] + [y for x in res for y in (
            x if isinstance(x, tuple) else (x,))]

    if form in ("thin", "absorbed", "spectral 3-band"):
        riaf, freqs = volumetric_forms()[form]
        if freqs:
            tf = volumetric.make_spectral_transfer(m, riaf, freqs)
            fn = (vk.trace_rays_spectral_cuda if kernel
                  else kerr_trace.trace_rays_spectral)
            return lambda **kw: flat(fn(*args, tf, len(freqs), LAMBDA_MAX,
                                        KN_STEPS, **base, **kw))
        em, ab = volumetric.make_transfer_fns(m, riaf)
        fn = (vk.trace_rays_volumetric_cuda if kernel
              else kerr_trace.trace_rays_volumetric)
        return lambda **kw: flat(fn(*args, em, LAMBDA_MAX, KN_STEPS,
                                    absorption_fn=ab, **base, **kw))
    aux = aux_forms(m, al, th, stokes=False)[form]
    return lambda **kw: flat(aux_trace(m, aux, al, th, KN_STEPS, kernel,
                                       **base, **kw))


def p23_main_rays(family, dev):
    """The 1024^2 main-path rays (config 3's frame, the mirror fold) of a
    family."""
    from light_path_tracer_tpu_torch import camera, pipeline
    from light_path_tracer_tpu_torch.utils.config import (RenderConfig,
                                                          SceneConfig)
    scene = SceneConfig(r_obs_mult=R_OBS, **MU_FAMILIES[family])
    dim = (1024, 1024)
    fov = camera.fov_from_vertical(scene.vertical_fov, dim)
    al, th, rf, _rows = pipeline.trace_inputs(scene, RenderConfig(), dim,
                                              fov, dev)
    return (p23_metric(family), R_OBS, al, th, np.pi / 2, rf, LAMBDA_MAX,
            HYB_STEPS)


def p23_renders64(dev):
    """(e)'s 64^2 float64 renders on `dev`: the Kerr shadow with
    formulation="mu" and the charged thin volumetric image."""
    from light_path_tracer_tpu_torch import pipeline, volumetric
    from light_path_tracer_tpu_torch.utils.config import (RenderConfig,
                                                          SceneConfig)
    d64 = (64, 64)
    shadow = pipeline.render_shadow(
        SceneConfig(M=1.0, a=0.9, r_obs_mult=R_OBS, vertical_fov_deg=12.0),
        d64, RenderConfig(dtype="float64", formulation="mu"), device=dev)[0]
    vol = volumetric.render_volumetric(
        SceneConfig(r_obs_mult=R_OBS, theta_obs=THETA_VOL,
                    vertical_fov_deg=16.0, **KN_ARGS), d64,
        RenderConfig(dtype="float64"), device=dev)[0]
    return [shadow, vol]


def p23_job(job, dev):
    """One plain-side job of phase 23 on `dev`: its outputs (a list of
    tensors) and the seconds of the plain call alone (its inputs built
    before the clock starts). The kernel side computes the same inputs
    with the same functions."""
    import torch
    from light_path_tracer_tpu_torch.ops import kerr_trace as tk
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    kind = job[0]
    if kind == "mu":
        _family, dtype, method = job[1:]
        _m, args, poison = p23_mu_rays(_family, dtype, dev)

        def run():
            res, unc = tk.trace_rays_kerr(
                *args, formulation="mu", force_invalid=poison,
                method=method, return_unconverged=True)
            return list(res) + [unc]
    elif kind == "kn":
        run = p23_kn_call(*job[1:], False, dev)
    elif kind == "hybrid":
        args = p23_main_rays(job[1], dev)

        def run():
            out = list(kk.trace_rays_kerr_hybrid(
                *args, trace_fn=tk.trace_rays_kerr))
            if job[1] == "kerr":
                out += list(tk.trace_rays_kerr_hybrid(*args))
            return out
    else:
        def run():
            return p23_renders64("cpu")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return [o.cpu() for o in out], time.perf_counter() - t0


def p23_child(jobs_json, out_path):
    """A child's part of phase 23's plain loops: run each job on the card
    (the 64^2 renders on the CPU) and save {job index: (outputs,
    seconds)}."""
    import torch
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    done = {}
    for i, job in json.loads(jobs_json):
        done[i] = p23_job(tuple(job), dev)
    torch.save(done, out_path)


class p23_plain:
    """Runs phase 23's plain-side jobs in P23_WORKERS child processes,
    each job's outputs saved to a file of a temporary directory; result()
    waits and returns [(outputs, seconds)] in job order. Leaving the
    block stops every child still running."""

    def __init__(self, jobs):
        import tempfile
        self.jobs = jobs
        self.dir = tempfile.mkdtemp(prefix="lpt_p23_")
        root = os.path.dirname(os.path.abspath(__file__))
        parts = [[] for _ in range(P23_WORKERS)]
        for i, job in enumerate(jobs):
            parts[i % P23_WORKERS].append((i, job))
        self.procs = []
        for k, part in enumerate(parts):
            out = os.path.join(self.dir, f"part{k}.pt")
            code = (f"import sys; sys.path.insert(0, {root!r}); "
                    f"import chip_smoke; chip_smoke.p23_child("
                    f"{json.dumps(part)!r}, {out!r})")
            self.procs.append((out, subprocess.Popen(
                [sys.executable, "-c", code], cwd=root,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                start_new_session=True)))

    def __enter__(self):
        return self

    def result(self):
        import torch
        got = {}
        for out, proc in self.procs:
            _o, err = proc.communicate()
            require(proc.returncode == 0,
                    f"phase 23 plain-loop child failed: {err[-4000:]}")
            got.update(torch.load(out))
        return [got[i] for i in range(len(self.jobs))]

    def __exit__(self, *exc):
        import shutil
        import signal
        for _out, proc in self.procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
        shutil.rmtree(self.dir, ignore_errors=True)


def bitwise_list(a, b):
    """Every tensor of two output lists bitwise equal (NaN where NaN)."""
    return len(a) == len(b) and all(same_bits(x.cpu(), y.cpu())
                                    for x, y in zip(a, b))


def max_abs_list(a, b):
    """The largest |a - b| over the floating tensors of two output lists
    where both are finite (0.0 where they are bitwise equal)."""
    import torch
    worst = 0.0
    for x, y in zip(a, b):
        x, y = x.cpu(), y.cpu()
        if x.dtype.is_floating_point and x.numel():
            ok = torch.isfinite(x) & torch.isfinite(y)
            if ok.any():
                worst = max(worst, float((x[ok].double()
                                          - y[ok].double()).abs().max()))
    return worst


def p23_path(render, counters):
    """One path of phase 23 driven once with its counts set to 0 just
    before it: render() on the card, then {name: launches} of
    `counters` ({name: (wrapper, counter attribute)}) and the plain loops'
    calls ("plain")."""
    import torch
    from light_path_tracer_tpu_torch.ops import kerr_trace as tk
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    plains = (tk.trace_rays_kerr, tk.trace_rays_volumetric,
              tk.trace_rays_spectral, tk.trace_rays_aux)
    for fn, _attr in counters.values():
        kk.zero_counters(fn)
    for fn in plains:
        fn.launches = 0
    out = render()
    torch.cuda.synchronize()
    got = {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}
    got["plain"] = sum(fn.launches for fn in plains)
    require(got["plain"] == 0 and all(v > 0 for k, v in got.items()
                                      if k != "plain"),
            f"phase 23 path: {got}")
    return out, got


def mu_theta_same_work(margs, rates):
    """The mu kernel and the theta kernel alone at full depth on the same
    work: of the rays `margs` (trace_rays_kerr_cuda's first seven
    arguments), those that pass A integrates in mu to their end, neither
    poisoned nor booked by the exact-cycle exit (a booked lane's attempts
    are booked, not made; the hybrid re-traces both sets in theta), in
    their order. A launch's time follows each warp's slowest lane, so the
    warp step sum and the lane efficiency stand beside the attempts, and
    the ratios mu / theta of the time, the warp steps, the time a warp
    step and the counted bound (a whole, and an attempt) are returned
    with them."""
    import torch
    from light_path_tracer_tpu_torch.ops import kerr_trace as tk
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    poison_m = tk.hybrid_poison(margs[0], R_OBS, margs[2], margs[3],
                                np.pi / 2, tk.hybrid_slots(
                                    int(margs[2].numel())))
    probe = {}
    kk.trace_rays_kerr_cuda(*margs, 200000, formulation="mu",
                            force_invalid=poison_m, probe=probe)
    booked = probe["attempts"] >= 200000
    keep = ~poison_m & ~booked
    sargs = (margs[0], margs[1], margs[2][keep].contiguous(),
             margs[3][keep].contiguous(), margs[4],
             margs[5][keep].contiguous(), margs[6], 200000)
    n_keep = int(keep.sum())
    side = dict(rays=n_keep, poisoned=int(poison_m.sum()),
                booked=int((booked & ~poison_m).sum()))
    for chart, kw in (("theta", {}), ("mu", dict(formulation="mu"))):
        probe = {}
        res = kk.trace_rays_kerr_cuda(*sargs, probe=probe, **kw)
        att = probe["attempts"].to(torch.int64)
        a, ws = int(att.sum()), int(res.n_steps)
        work = a * kerr_work(chart=chart)
        nb = n_keep * (9 + 12)
        ms = kernel_alone_ms(lambda: kk.trace_rays_kerr_cuda(*sargs, **kw),
                             3)
        side[chart] = dict(
            kernel_ms=ms, attempts=a, booked_lanes=int((att >= 200000)
                                                       .sum()),
            warp_steps=ws, lane_efficiency=a / (32 * ws),
            ns_per_warp_step=1e6 * ms / ws,
            bound_ms=bounds.flops_bound_ms(work, nb)[0],
            bound_counted_ms=bounds.counted_bound_ms(work, nb, rates)[0])
    t, m_ = side["theta"], side["mu"]
    side["mu_over_theta"] = {
        k: m_[k] / t[k] for k in ("kernel_ms", "attempts", "warp_steps",
                                  "ns_per_warp_step", "bound_counted_ms")}
    side["mu_over_theta"]["bound_counted_per_attempt"] = (
        side["mu_over_theta"]["bound_counted_ms"]
        / side["mu_over_theta"]["attempts"])
    return side


def mu_phase(dev, card, ctx):
    """Phase 23: the mu chart's instances (Kerr and Kerr-Newman, float32
    and float64, DP45 and DOP853) bitwise against the plain mu loop on the
    card; the CUDA hybrid on the 1024^2 main path and a Kerr-Newman shadow
    against the plain loop through the same driver (and the plain hybrid
    with the XLA semantics), with its poison and re-trace counts and pass
    A/B times; render_shadow with formulation="mu" at 1024^2 against the
    theta render by the JAX package's rule; every Kerr-Newman extras
    instance of a main path (thin, absorbed, 3-band, 8-frame movie thin
    and absorbed, 3 orders thin and absorbed; float32 and float64; DP45
    and DOP853) bitwise against its plain loop on the card; the 1024^2
    charged volumetric renders; 64^2 float64 renders on the card against
    the CPU. The plain loops (and the CPU renders) run in child processes
    side by side after every timed kernel run. Returns the kernels-line
    entries."""
    import torch
    from light_path_tracer_tpu_torch import camera, pipeline, volumetric
    from light_path_tracer_tpu_torch.ops import kerr_trace as tk
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk
    from light_path_tracer_tpu_torch.utils.config import (RenderConfig,
                                                          SceneConfig)
    t_phase = time.perf_counter()
    print(f"the mu chart and charged volumetric scenes (phase 23) on "
          f"{card}:", flush=True)
    rates = ctx["rates"]
    lib, build_s = ctx["build"].result()
    print(f"  the DP45 mu and Kerr-Newman extras library: built in "
          f"{build_s:.2f} s by a child process at nice 19 beside phases 3 on"
          f" -> {os.path.basename(lib._name)}", flush=True)
    report = ptxas_report(lib.build_log)
    extras_resources(report, families=("_kn",))
    for name, regs, spill in report:
        r = RESOURCES.get(name)
        more = (f"; {r['blocks_per_sm']} blocks an SM (block bound "
                f"{r['min_blocks']})" if r else "")
        print(f"  ptxas: {name}: {regs} registers; {spill}{more}",
              flush=True)
    # Why the plain loops divide by (and raise to) tensors on the card:
    # PyTorch multiplies a CUDA tensor by the reciprocal of a Python-number
    # divisor and expands small integer powers into products, where the
    # kernels divide and call pow. Counted on 2^20 values in [0, 100).
    x = torch.rand(1 << 20, device=dev, generator=torch.Generator(
        device=dev).manual_seed(23)) * 100.0
    rewrites = {}
    for c in (5.0, float(np.pi)):
        k = torch.full((), c, device=dev)
        rewrites[f"x / {c:g}"] = dict(
            differ_from_tensor_divisor=int((x / c != x / k).sum()),
            differ_from_reciprocal_product=int((x / c != x * (1.0 / k))
                                               .sum()))
    for e in (3.0, 2.0, -1.0, 1.5):
        k = torch.full((), e, device=dev)
        rewrites[f"x ** {e:g}"] = dict(
            differ_from_tensor_exponent=int((x ** e != x ** k).sum()))
    print(f"  PyTorch's Python-number operands on the card: "
          f"{json.dumps(rewrites)}", flush=True)

    # -- (a) the mu instances: the kernel side, timed --------------------
    jobs, kern = [], {}
    for family in MU_FAMILIES:
        for dtype in ("float32", "float64"):
            for method in ("dp45", "dop853"):
                _m, args, poison = p23_mu_rays(family, dtype, dev)
                kw = dict(formulation="mu", force_invalid=poison,
                          method=method, return_unconverged=True)
                probe = {}
                res, unc = kk.trace_rays_kerr_cuda(*args, probe=probe, **kw)
                ms, _ = cuda_ms(lambda: kk.trace_rays_kerr_cuda(*args, **kw),
                                3)
                kern[("mu", family, dtype, method)] = dict(
                    out=[x for x in res] + [unc], ms=ms,
                    attempts=int(probe["attempts"].to(torch.int64).sum()),
                    n=int(args[2].numel()), poison=int(poison.sum()))
                jobs.append(("mu", family, dtype, method))

    # -- (d) the Kerr-Newman extras instances: the kernel side, timed -----
    for form in KN_FORMS:
        for dtype in ("float32", "float64"):
            for method in ("dp45", "dop853"):
                # the inputs built once, outside the timed calls
                call = p23_kn_call(form, dtype, method, True, dev)
                probe = {}
                out = call(probe=probe)
                ms, _ = cuda_ms(call, 3)
                kern[("kn", form, dtype, method)] = dict(
                    out=out, ms=ms, n=VOL_RAYS,
                    attempts=int(probe["attempts"].to(torch.int64).sum()))
                jobs.append(("kn", form, dtype, method))

    # -- (b) the CUDA hybrid on the 1024^2 main path ----------------------
    hyb = {}
    for family in MU_FAMILIES:
        args = p23_main_rays(family, dev)
        probe = {}
        res = kk.trace_rays_kerr_hybrid(*args, probe=probe)
        n = int(args[2].numel())
        poison, redo = probe["poison"], probe["redo"]
        idx, _dest = tk.stragglers(redo, tk.hybrid_slots(n))
        pa = {}
        ms_a = kernel_alone_ms(lambda: kk.trace_rays_kerr_cuda(
            *args, formulation="mu", force_invalid=poison,
            return_unconverged=True, probe=pa), 3)
        pb = {}
        ms_b = kernel_alone_ms(lambda: kk.trace_rays_kerr_cuda(
            args[0], R_OBS, args[2][idx], args[3][idx], np.pi / 2,
            args[5][idx], LAMBDA_MAX, HYB_STEPS, probe=pb), 3)
        ms, _ = cuda_ms(lambda: kk.trace_rays_kerr_hybrid(*args), 3)
        hyb[family] = dict(
            out=list(res), unconverged=probe["unconverged"].cpu(),
            row=dict(n=n, max_steps=HYB_STEPS, poison=int(poison.sum()),
                     retrace=int(redo.sum()),
                     unconverged=int(probe["unconverged"].sum()),
                     slots=tk.hybrid_slots(n), ms=ms, pass_a_ms=ms_a,
                     pass_b_ms=ms_b, attempts_a=int(pa["attempts"].to(
                         torch.int64).sum()),
                     attempts_b=int(pb["attempts"].to(torch.int64).sum()),
                     n_steps=int(res.n_steps)))
        jobs.append(("hybrid", family))
        print(f"  CUDA hybrid, {family} 1024^2 main-path rays, capped at "
              f"{HYB_STEPS}: {json.dumps(hyb[family]['row'])}", flush=True)

    # -- (c) render_shadow with formulation="mu" at 1024^2 ---------------
    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=R_OBS)
    dim = (1024, 1024)
    cfg_mu = RenderConfig(formulation="mu")

    def zero():
        kk.zero_counters(kk.trace_rays_kerr_cuda)
        kk.trace_rays_kerr_hybrid.launches = 0
        tk.trace_rays_kerr.launches = 0

    zero()
    img_mu, st = pipeline.render_shadow(scene, dim, cfg_mu, device="cuda")
    best = 0.0
    for _ in range(3):
        img_mu, st = pipeline.render_shadow(scene, dim, cfg_mu,
                                            device="cuda")
        best = max(best, st["traced_rays"] / st["timings"]["precompute"])
    f = kk.trace_rays_kerr_cuda
    path_mu = dict(mu_launches=f.launches_mu, theta_launches=f.launches,
                   hybrid_calls=kk.trace_rays_kerr_hybrid.launches,
                   plain=tk.trace_rays_kerr.launches, rays_per_s=best,
                   traced_rays=st["traced_rays"],
                   integrator_steps=st["integrator_steps"])
    require(path_mu["mu_launches"] >= 4 and path_mu["theta_launches"] >= 4
            and path_mu["hybrid_calls"] >= 4 and path_mu["plain"] == 0
            and st["traced_rays"] == 524288
            and bool(torch.isfinite(img_mu).all()),
            f"phase 23 mu shadow path: {path_mu}")
    img_th, _st = pipeline.render_shadow(scene, dim, RenderConfig(),
                                         device="cuda")
    # The JAX package's rule for the mu chart against theta
    # (tests/test_pallas.py:206-240): statuses equal on > 99 % of the rays,
    # p99 |d final_alpha| < 1e-3 on the stable escaped rays.
    margs = p23_main_rays("kerr", dev)[:7]
    r_mu = kk.trace_rays_kerr_hybrid(*margs, 200000)
    r_th = kk.trace_rays_kerr_cuda(*margs, 200000)
    cmp = compare(r_mu, r_th, margs[2], scene.metric().alpha_crit(R_OBS))
    path_mu.update(vs_theta=cmp, pixels_equal=float(
        (img_mu == img_th).float().mean()))
    print(f"  1024^2 shadow with formulation='mu': {json.dumps(path_mu)} on "
          f"{card}", flush=True)
    require(cmp["status_agree"] > 0.99 and cmp["p99"] < 1e-3
            and path_mu["pixels_equal"] > 0.99,
            f"phase 23 mu against theta: {path_mu}")
    side = mu_theta_same_work(margs, rates)
    print(f"  mu and theta kernels alone at full depth on the "
          f"{side['rays']} main-path rays pass A integrates in mu: "
          f"{json.dumps(side)}", flush=True)

    # -- (d') the 1024^2 charged volumetric renders ------------------------
    scene_kn = SceneConfig(r_obs_mult=R_OBS, theta_obs=THETA_VOL,
                           vertical_fov_deg=16.0, **KN_ARGS)
    period = 2.0 * np.pi / abs(volumetric.keplerian_omega(
        1.0, KN_ARGS["a"], 6.0, True, Q=KN_ARGS["Q"]))
    times = tuple(period * k / N_FRAMES for k in range(N_FRAMES))
    riaf3, freqs3 = scene_forms()["spectral 3-band"]
    R = volumetric.RIAFConfig
    paths = {}
    for label, render in (
            ("thin", lambda: volumetric.render_volumetric(
                scene_kn, VOL_DIM, RenderConfig(), device="cuda")),
            ("absorbed", lambda: volumetric.render_volumetric(
                scene_kn, VOL_DIM, RenderConfig(), R(alpha0=0.3),
                device="cuda")),
            ("jet", lambda: volumetric.render_volumetric(
                scene_kn, VOL_DIM, RenderConfig(),
                R(profile="jet", jet_beta=0.6, index=-1.0), device="cuda")),
            ("spectrum 3-band", lambda: (
                volumetric.render_volumetric_spectrum(
                    scene_kn, VOL_DIM, freqs3, RenderConfig(), riaf3,
                    device="cuda"))),
            ("movie 8-frame", lambda: volumetric.render_volumetric_movie(
                scene_kn, VOL_DIM, times, RenderConfig(), R(spot_amp=8.0),
                device="cuda")),
            ("movie 8-frame absorbed", lambda: (
                volumetric.render_volumetric_movie(
                    scene_kn, VOL_DIM, times, RenderConfig(),
                    R(spot_amp=8.0, alpha0=0.3), device="cuda"))),
            ("decomposed x3", lambda: (
                volumetric.render_volumetric_decomposed(
                    scene_kn, VOL_DIM, RenderConfig(), n_orders=N_ORDERS,
                    device="cuda")))):
        for c in (vk.trace_rays_volumetric_cuda, vk.trace_rays_aux_cuda):
            kk.zero_counters(c)
        plain0 = sum(c.launches for c in (tk.trace_rays_volumetric,
                                          tk.trace_rays_spectral,
                                          tk.trace_rays_aux))
        out = render()
        best = 0.0
        for _ in range(2):
            out = render()
            best = max(best, VOL_DIM[0] * VOL_DIM[1]
                       / out[1]["timings"]["precompute"])
        row = dict(volumetric=vk.trace_rays_volumetric_cuda.launches,
                   aux=vk.trace_rays_aux_cuda.launches,
                   plain=sum(c.launches for c in (
                       tk.trace_rays_volumetric, tk.trace_rays_spectral,
                       tk.trace_rays_aux)) - plain0, rays_per_s=best)
        img = out[0]
        require(row["volumetric"] + row["aux"] >= 6 and row["plain"] == 0
                and bool(torch.isfinite(img).all()),
                f"phase 23 charged {label}: {row}")
        if label == "movie 8-frame":
            row["spot_period"] = out[1]["spot_period"]
            require(abs(row["spot_period"] - period) < 1e-9 * period,
                    f"phase 23 charged movie period: {row}")
        paths[label] = row
        print(f"  1024^2 charged {label}: {json.dumps(row)} on {card}",
              flush=True)

    # -- (e) the other instances' paths, each counted; 64^2 float64 renders
    # on the card (against the CPU below)
    mu_paths = {}
    f = kk.trace_rays_kerr_cuda
    scene_kn_shadow = SceneConfig(r_obs_mult=R_OBS, **KN_ARGS)
    scene64 = dict(vertical_fov_deg=12.0, r_obs_mult=R_OBS)
    for family, sc in (("kerr", dict(M=1.0, a=0.9)), ("kerr_newman",
                                                      KN_ARGS)):
        for method in ("dp45", "dop853"):
            for dtype in ("float32", "float64"):
                key = (family, dtype, method)
                if key == ("kerr", "float32", "dp45"):
                    continue            # (c)'s path
                attr = kk.counter_name(getattr(torch, dtype), method, "mu")
                d = dim if dtype == "float32" else (64, 64)
                sce = (SceneConfig(r_obs_mult=R_OBS, **sc) if dtype ==
                       "float32" else SceneConfig(**scene64, **sc))
                cfg_p = RenderConfig(formulation="mu", integrator=method,
                                     dtype=dtype)
                out, got = p23_path(lambda: pipeline.render_shadow(
                    sce, d, cfg_p, device="cuda"), {"mu": (f, attr)})
                require(bool(torch.isfinite(out[0]).all()),
                        f"phase 23 mu path {key}")
                mu_paths[key] = got["mu"]
    mu_paths[("kerr", "float32", "dp45")] = path_mu["mu_launches"]
    card64 = p23_renders64("cuda")
    kn_paths = {}
    R = volumetric.RIAFConfig
    scene_kn64 = SceneConfig(r_obs_mult=R_OBS, theta_obs=THETA_VOL,
                             vertical_fov_deg=16.0, **KN_ARGS)
    forms = {"thin": ("volumetric", lambda sc, d, c: (
                 volumetric.render_volumetric(sc, d, c, device="cuda"))),
             "absorbed": ("volumetric", lambda sc, d, c: (
                 volumetric.render_volumetric(sc, d, c, R(alpha0=0.3),
                                              device="cuda"))),
             "spectral 3-band": ("aux", lambda sc, d, c: (
                 volumetric.render_volumetric_spectrum(
                     sc, d, freqs3, c, riaf3, device="cuda"))),
             "movie thin": ("aux", lambda sc, d, c: (
                 volumetric.render_volumetric_movie(
                     sc, d, times, c, R(spot_amp=8.0), device="cuda"))),
             "movie absorbed": ("aux", lambda sc, d, c: (
                 volumetric.render_volumetric_movie(
                     sc, d, times, c, R(spot_amp=8.0, alpha0=0.3),
                     device="cuda"))),
             "order thin": ("aux", lambda sc, d, c: (
                 volumetric.render_volumetric_decomposed(
                     sc, d, c, n_orders=N_ORDERS, device="cuda"))),
             "order absorbed": ("aux", lambda sc, d, c: (
                 volumetric.render_volumetric_decomposed(
                     sc, d, c, R(alpha0=0.3), n_orders=N_ORDERS,
                     device="cuda")))}
    wrappers = {"volumetric": vk.trace_rays_volumetric_cuda,
                "aux": vk.trace_rays_aux_cuda}
    for form, (which, render) in forms.items():
        for method in ("dp45", "dop853"):
            for dtype in ("float32", "float64"):
                # float32: 256^2 of the 1024^2 scene's frame (DP45's
                # 1024^2 paths are (d')'s, counted again here); float64
                # at 64^2
                d = (256, 256) if dtype == "float32" else (64, 64)
                cfg_p = RenderConfig(integrator=method, dtype=dtype)
                attr = kk.counter_name(getattr(torch, dtype), method)
                out, got = p23_path(lambda: render(scene_kn64, d, cfg_p),
                                    {"kn": (wrappers[which], attr)})
                require(bool(torch.isfinite(out[0]).all()),
                        f"phase 23 charged path {form} {method} {dtype}")
                kn_paths[(form, dtype, method)] = got["kn"]
    print(f"  mu and Kerr-Newman extras launches on their paths (float32 "
          f"at 1024^2 (mu) and 256^2 (extras), float64 at 64^2): "
          f"{json.dumps({' '.join(k): v for k, v in mu_paths.items()})}; "
          f"{json.dumps({' '.join(k): v for k, v in kn_paths.items()})}",
          flush=True)
    f64_launches = dict(mu=mu_paths[("kerr", "float64", "dp45")],
                        volumetric=kn_paths[("thin", "float64", "dp45")])
    jobs.append(("cpu64",))

    # -- the plain side, in child processes --------------------------------
    t_plain = time.perf_counter()
    with p23_plain(jobs) as plain:
        got = plain.result()
    plain_wall = time.perf_counter() - t_plain
    res = {}
    for job, (out, secs) in zip(jobs, got):
        res[job] = dict(out=out, s=secs)
    bad = []
    for key, k in kern.items():
        p = res[key]
        k["bitwise"] = bitwise_list(k["out"], p["out"])
        k["max_abs"] = max_abs_list(k["out"], p["out"])
        k["plain_ms"] = 1e3 * p["s"]
        # Every instance bitwise, the float64 Kerr-Newman extras too:
        # their pow is built as PyTorch builds its own.
        if not k["bitwise"]:
            bad.append(key)
    rows = {" ".join(key[1:]): dict(bitwise=k["bitwise"],
                                    max_abs=k["max_abs"], ms=k["ms"],
                                    plain_ms=k["plain_ms"],
                                    attempts=k["attempts"])
            for key, k in kern.items()}
    print(f"  mu and Kerr-Newman extras instances against their plain "
          f"loops on the card (mu: {MU_RAYS} rays float32, {MU_RAYS_F64} "
          f"float64, capped at {MU_STEPS}; extras: {VOL_RAYS} rays capped "
          f"at {KN_STEPS}): {json.dumps(rows)}", flush=True)
    require(not bad, f"phase 23: off their plain loop: {bad}")
    for family, h in hyb.items():
        p = res[("hybrid", family)]["out"]
        same = bitwise_list(h["out"], p[:4])
        h["row"].update(bitwise_plain_driver=same, plain_ms=1e3 * res[
            ("hybrid", family)]["s"])
        ok = same
        if family == "kerr":
            # the plain hybrid with the XLA semantics re-traces no
            # unconverged ray of pass A: equal on every other ray
            keep = ~h["unconverged"]
            h["row"]["equal_xla_off_unconverged"] = all(
                same_bits(a.cpu()[keep], b.cpu()[keep])
                for a, b in zip(h["out"][:3], p[4:7]))
            ok = ok and h["row"]["equal_xla_off_unconverged"]
        print(f"  CUDA hybrid against the plain loop through it, {family}: "
              f"{json.dumps(h['row'])}", flush=True)
        require(ok, f"phase 23 hybrid {family}: {h['row']}")
    cpu64 = res[("cpu64",)]["out"]
    shadow_eq = float((card64[0].cpu() == cpu64[0]).float().mean())
    mg, mc = card64[1].cpu() > 0, cpu64[1] > 0
    both = mg & mc
    vol_med = float((card64[1].cpu() - cpu64[1]).abs()[both].median())
    checks = dict(mu_shadow_pixels_equal=shadow_eq,
                  charged_thin_mask_agree=float((mg == mc).float().mean()),
                  charged_thin_median=vol_med, launches=f64_launches)
    print(f"  64^2 float64 renders, card vs CPU: {json.dumps(checks)}",
          flush=True)
    require(shadow_eq >= 0.999 and checks["charged_thin_mask_agree"] >= 0.999
            and vol_med < 1e-6, f"phase 23 64^2: {checks}")
    print(f"phase 23: {time.perf_counter() - t_phase:.1f} s (the plain side "
          f"in {P23_WORKERS} children: {plain_wall:.1f} s)", flush=True)

    # -- the kernels-line entries -----------------------------------------
    kernels = []
    short = {"kerr": "", "kerr_newman": "_kn"}
    for (kind, *rest), k in kern.items():
        if kind == "mu":
            family, dtype, method = rest
            pair = "dop853" if method == "dop853" else "dp45"
            name = (f"kerr_{pair}_mu{short[family]}"
                    + ("_f64" if dtype == "float64" else ""))
            src = MU_SOURCE.format(pair, "_f64" if dtype == "float64"
                                   else "")
            work = k["attempts"] * kerr_work(dtype, family, method, "mu")
            per_ray = 9 + 12 + 1 if dtype == "float32" else 17 + 16 + 1
            e = kernel_entry(name, src, REPLACES,
                             mu_paths[(family, dtype, method)], k["max_abs"],
                             k["ms"], k["plain_ms"], k["n"], per_ray, work)
            e.update(bitwise_plain=k["bitwise"], max_steps=MU_STEPS,
                     poisoned=k["poison"])
            if name == "kerr_dp45_mu":
                e.update(main_path=side["mu"], theta_main_path=side["theta"],
                         main_path_rays=side["rays"],
                         mu_over_theta=side["mu_over_theta"])
            kernels.append(e)
        else:
            form, dtype, method = rest
            pair = "dop853" if method == "dop853" else "dp45"
            kind_, width, ab = {
                "thin": ("thin", 0, False), "absorbed": ("absorbed", 0,
                                                         False),
                "spectral 3-band": ("spectral", 3, False),
                "movie thin": ("movie", N_FRAMES, False),
                "movie absorbed": ("movie", N_FRAMES, True),
                "order thin": ("order", N_ORDERS, False),
                "order absorbed": ("order", N_ORDERS, True)}[form]
            srcname = {"thin": "extras", "absorbed": "extras",
                       "spectral": "extras", "order": "orders",
                       "movie": "movie_absorbed" if ab else "movie_thin"}[
                           kind_]
            src = KN_SOURCE.format(pair, srcname,
                                   "_f64" if dtype == "float64" else "")
            replaces = (f"{VOL_JAX}:53" if kind_ in ("thin", "absorbed")
                        else f"{VOL_JAX}:276")
            launches = kn_paths[(form, dtype, method)]
            n_extras = bounds.components(kind_, width, ab) - 5
            size = 4 if dtype == "float32" else 8
            work = k["attempts"] * bounds.extras_work(
                kind_, width, ab, dtype=dtype, method=method,
                family="kerr_newman")
            real = "float" if dtype == "float32" else "double"
            inst = {"thin": "VolThin<{}>", "absorbed": "VolAbsorbed<{}>",
                    "spectral 3-band": "Spectral<3,{}>",
                    "movie thin": "Movie<8,absorbing=0,{}>",
                    "movie absorbed": "Movie<8,absorbing=1,{}>",
                    "order thin": "Order<3,absorbing=0,{}>",
                    "order absorbed": "Order<3,absorbing=1,{}>"}[form]
            e = kernel_entry(
                f"kerr_{pair}_extras_kn_{form.replace(' ', '_')}"
                + ("_f64" if dtype == "float64" else ""), src, replaces,
                launches, k["max_abs"], k["ms"], k["plain_ms"], VOL_RAYS,
                2 * size + (4 + n_extras) * size, work,
                instance=f"kerr_{pair}_extras_kn<{inst.format(real)}>")
            e.update(bitwise_plain=k["bitwise"], max_steps=KN_STEPS)
            kernels.append(e)
    h = hyb["kerr"]["row"]
    hk = kernel_entry("trace_rays_kerr_hybrid", DRIVER_SOURCE,
                      HYBRID_REPLACES, path_mu["hybrid_calls"], 0.0, h["ms"],
                      h["plain_ms"], h["n"], 9 + 12,
                      h["attempts_a"] * kerr_work(chart="mu")
                      + h["attempts_b"] * kerr_work())
    hk.update(hybrid=h, kerr_newman=hyb["kerr_newman"]["row"])
    kernels.append(hk)
    return kernels


# Phase 24: the rest of the disk family through the disk kernel: the
# wide instances (5-8 crossing slots, csrc/kerr_dp45_wide.cu and its
# siblings) and every render of the JAX package's disk kernel path.
WIDE_SOURCE = "light_path_tracer_tpu_torch/csrc/kerr_dp45_wide.cu"
WIDE_SLOTS = 8
WIDE_COMBOS = tuple((method, dtype, family, momentum)
                    for method in ("dp45", "dop853")
                    for dtype in ("float32", "float64")
                    for family in ("kerr", "kerr_newman")
                    for momentum in (False, True))
# The random rays' attempt cap, kernel and plain loop alike: a float32
# lane just outside the critical curve can freeze in an exact cycle,
# which the kernel books at once and the plain loop (~15 ms an
# iteration) grinds to the cap; the others end within ~430 attempts.
WIDE_STEPS = 1000
P24_DIM = (1024, 1024)
P24_CHECK = (64, 64)
P24_MODES = ("decomposed x3", "decomposed x6", "frames", "disk aa x4",
             "composite", "composite aa x4", "line profile", "light curve",
             "polarization", "qu loop")
# Frames over one orbit, light-curve samples over two, Q-U samples over
# one (both ends), and the line profile's bins (the 64^2 check's range
# fixed, so both devices bin alike).
P24_FRAMES, P24_CURVE, P24_QU = 32, 64, 32
P24_BINS, P24_CHECK_BINS, P24_CHECK_GLIM = 200, 40, (0.2, 1.6)


def p24_metric(family):
    from light_path_tracer_tpu_torch.models import Kerr, KerrNewman
    if family == "kerr":
        return Kerr(M=1.0, a=0.9)
    return KerrNewman(**KN_ARGS)


def p24_plane(_metric=None):
    """The photon-ring decomposition's recorder: translucent, every
    equatorial crossing out to the escape radius (r_in = 0), so near
    critical rays fill slots 5 and up."""
    return (0.0, 2.0 * R_OBS, float(np.pi / 2), False)


def p24_wide_rays(family, al_d, th_d, n_critical=1024):
    """Phase 8's random rays, the last n_critical of them moved just
    outside the family's critical curve: its boundary found at each
    screen angle by bisection on the shadow kernel's capture (32 steps
    from 0.3 to 3 alpha_crit), then raised by a factor 1 + eps, eps
    log-uniform in [1e-7, 1e-3] (a seed), so the rays wind before they
    escape and cross the plane up to 8 times."""
    import torch
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    m = p24_metric(family)
    ac = m.alpha_crit(R_OBS, THETA_DISK)
    th = th_d[-n_critical:]
    lo, hi = torch.full_like(th, 0.3 * ac), torch.full_like(th, 3.0 * ac)
    refine = torch.zeros_like(th, dtype=torch.bool)
    for _ in range(32):
        mid = 0.5 * (lo + hi)
        cap = kk.trace_rays_kerr_cuda(m, R_OBS, mid, th, THETA_DISK, refine,
                                      LAMBDA_MAX, GATE_STEPS).status == -1
        lo, hi = torch.where(cap, mid, lo), torch.where(cap, hi, mid)
    eps = np.random.default_rng(24).uniform(-7.0, -3.0, n_critical)
    al = hi * torch.tensor(1.0 + 10.0 ** eps, dtype=th.dtype,
                           device=th.device)
    return (torch.cat([al_d[:-n_critical], al]).contiguous(),
            th_d.contiguous())


def p24_wide_trace(family, al, th, slots, momentum, method, kernel=True,
                   **kw):
    """The translucent disk trace of phase 8's rays with `slots` slots,
    through the kernel wrapper or the plain loop (a PlainPool job)."""
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    m = p24_metric(family)
    fn = kk.trace_disk_rays_cuda if kernel else kk.trace_disk_rays_plain
    return fn(m, R_OBS, al, th, THETA_DISK, LAMBDA_MAX, WIDE_STEPS,
              p24_plane(m), slots, record_momentum=momentum, method=method,
              **kw)


def p24_scene():
    from light_path_tracer_tpu_torch.utils.config import SceneConfig
    return SceneConfig(M=1.0, a=0.9, r_obs_mult=R_OBS, theta_obs=THETA_DISK)


def p24_period():
    from light_path_tracer_tpu_torch.disk import HotSpot, keplerian_omega
    return abs(2.0 * np.pi / keplerian_omega(1.0, 0.9, HotSpot().r0, True))


def p24_background(dim):
    """The composite's background, made from a seed."""
    return np.random.default_rng(24).integers(0, 256, tuple(dim) + (3,),
                                              dtype=np.uint8)


def p24_render(mode, dim, device, check=False):
    """Phase 24's render `mode` of the config-4 scene at `dim` on `device`
    (check: the 64^2 comparison's line-profile bins); returns what the
    entry point returns."""
    from light_path_tracer_tpu_torch import disk as dm
    from light_path_tracer_tpu_torch import polarization, spectra
    from light_path_tracer_tpu_torch.utils.config import RenderConfig
    scene, cfg, P = p24_scene(), RenderConfig(), p24_period()
    kw = dict(device=device)
    if mode.startswith("decomposed"):
        return dm.render_disk_decomposed(scene, dim, cfg, dm.DiskConfig(),
                                         n_orders=int(mode[-1]), **kw)
    if mode == "frames":
        return dm.render_disk_frames(
            scene, dim, [P * k / P24_FRAMES for k in range(P24_FRAMES)],
            cfg, dm.DiskConfig(), **kw)
    if mode == "disk aa x4":
        return dm.render_disk_aa(scene, dim, cfg, dm.DiskConfig(),
                                 aa_samples=4, **kw)
    if mode.startswith("composite"):
        disk = dm.DiskConfig(spectrum="blackbody",
                             opaque="translucent" not in mode)
        if "aa" in mode:
            return dm.render_scene_with_disk_aa(
                scene, p24_background(dim), cfg, disk, aa_samples=4,
                display_encode=True, stacked="loop" not in mode, **kw)
        if "empty" in mode:
            disk = dataclasses.replace(disk, r_in=8.0, r_out=7.0)
        return dm.render_scene_with_disk(scene, p24_background(dim), cfg,
                                         disk, **kw)
    if mode.startswith("line profile"):
        flat = "flat" in mode
        disk = (dm.DiskConfig(emissivity_index=0.0, g_power=0.0) if flat
                else dm.DiskConfig())
        return spectra.line_profile(
            scene, dim, cfg, disk,
            n_bins=P24_CHECK_BINS if check or flat else P24_BINS,
            g_lim=P24_CHECK_GLIM if check or flat else None,
            rest_energy=1.0, aa_samples=4 if "x4" in mode else 1, **kw)
    if mode == "light curve":
        return spectra.hotspot_light_curve(
            scene, dim, [2.0 * P * k / P24_CURVE for k in range(P24_CURVE)],
            cfg, dm.DiskConfig(), **kw)
    if mode == "polarization":
        return polarization.render_polarization(scene, dim, cfg,
                                                dm.DiskConfig(), **kw)
    if mode == "qu loop":
        return polarization.hotspot_qu_loop(
            scene, dim, np.linspace(0.0, P, P24_QU), cfg, dm.DiskConfig(),
            **kw)
    raise ValueError(mode)


def p24_counters():
    """The disk kernel's wrapper, its driver and its plain loop."""
    from light_path_tracer_tpu_torch.ops import kerr_trace as tk
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    return kk.trace_disk_rays_cuda, kk.trace_disk_rays_two_pass, \
        tk.trace_disk_rays_kerr


def disk_launches():
    """Every launch of the disk kernel's wrapper counted so far (all
    pairs, dtypes and widths)."""
    import torch
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    fn = kk.trace_disk_rays_cuda
    return sum(getattr(fn, kk.counter_name(dtype, method, variant))
               for dtype in (torch.float32, torch.float64)
               for method in ("dp45", "dop853") for variant in kk.VARIANTS)


def p24_images(mode, out):
    """(image-like tensors, disk mask) of a render's output, for the 64^2
    comparison: the layers, frames or image, and where the disk is."""
    import torch
    if mode.startswith("decomposed"):
        return out[0], out[0].sum(dim=0) > 0
    if mode == "frames":
        return out[0], out[1]["emission"].sum(dim=0) > 0
    if mode == "polarization":
        inten = torch.from_numpy(out[2])
        return inten, inten > 0
    img = out[0]
    mask = (torch.as_tensor(out[1]["disk_mask"]) if "disk_mask" in out[1]
            else (img.sum(dim=-1) if img.dim() == 3 else img) > 0)
    return img, mask


def p24_check(mode, og, oc):
    """Phase 24's 64^2 gates, card output og against CPU output oc: the
    disk masks agree on >= 99 % and the median |d image| on disk pixels
    is < 1e-3 (EVPA modulo pi where both define it); the 1-D outputs
    within 1e-3 of their largest value, sample by sample (the Q-U loop's
    Q and U against the largest I, their flux scale: Q + iU sums I p
    exp(2 i chi), so |Q|, |U| <= I; each curve's gap is also reported
    against its own largest value)."""
    import torch
    if mode in ("line profile", "light curve", "qu loop"):
        names = ("I", "Q", "U") if mode == "qu loop" else ("flux",)
        scale = max(float(np.abs(oc[1]).max()), 1e-30)
        row = {}
        for name, a, b in zip(names, og[1:], oc[1:]):
            d = float(np.abs(a - b).max())
            row[f"{name}_rel_I"] = d / scale
            row[f"{name}_rel_own"] = d / max(float(np.abs(b).max()), 1e-30)
        row["max_rel"] = worst = max(row[f"{n}_rel_I"] for n in names)
        return row, worst < 1e-3
    ig, mg = p24_images(mode, og)
    ic, mc = p24_images(mode, oc)
    ig, mg = ig.cpu(), mg.cpu()
    agree = float((mg == mc).float().mean())
    both = mg & mc
    d = (ig.double() - ic.double()).abs()
    if mode.startswith("decomposed") or mode == "frames":
        d = d.amax(dim=0)
    if d.dim() == 3:
        d = d.amax(dim=-1)
    med = float(d[both].median()) if both.any() else 0.0
    row = dict(mask_agree=agree, median=med)
    if mode == "polarization":
        ok_ = np.isfinite(og[0]) & np.isfinite(oc[0])
        dev_ = np.abs(np.remainder(og[0][ok_] - oc[0][ok_] + np.pi / 2,
                                   np.pi) - np.pi / 2)
        row["evpa_median"] = float(np.median(dev_))
        med = max(med, row["evpa_median"])
    return row, agree >= 0.99 and med < 1e-3


def p24_qu_terms(dim, device):
    """The 64^2 Q-U loop's per-pixel terms as hotspot_qu_loop forms them
    (float64 NumPy arrays): I, the (samples, pixels) intensities; the
    weights p cos 2chi and p sin 2chi, and p cos chi and p sin chi (what a
    kernel that rotated by chi where it should by 2 chi would weigh with);
    each pixel's crossings and first crossing radius."""
    import torch
    from light_path_tracer_tpu_torch import disk as dm
    from light_path_tracer_tpu_torch import polarization as pol
    from light_path_tracer_tpu_torch.utils.config import RenderConfig
    from light_path_tracer_tpu_torch.utils.timing import StageTimer
    scene, cfg, disk = p24_scene(), RenderConfig(), dm.DiskConfig()
    res, r_in, hit, sin_xi, x, y, ok = pol._disk_polarization(
        scene, cfg, disk, "toroidal", dim, None, device,
        StageTimer(device), "p24_qu_terms")
    evpa, good = torch.atan2(x, -y), hit & ok
    terms = {f"{f.__name__}{n}": torch.where(
        good, sin_xi ** 2 * f(n * evpa), 0.0)
        for f in (torch.cos, torch.sin) for n in (2.0, 1.0)}
    pattern = dm.hotspot_pattern(dm.HotSpot(), scene.M, scene.a,
                                 disk.prograde)
    ts = torch.tensor(list(np.linspace(0.0, p24_period(), P24_QU)),
                      dtype=torch.float32, device=device)
    terms["I"] = torch.stack([dm.disk_emission(
        scene, disk, r_in, res.n_hits, res.r_hits, res.xi, pattern=pattern,
        phi_hits=res.phi_hits, t=t, xi_hits=res.xi_hits)[0] for t in ts])
    terms.update(n_hits=res.n_hits, r0=res.r_hits[0])
    return {k: v.double().cpu().numpy() for k, v in terms.items()}


def p24_qu_diagnosis(tg, tc):
    """Where the 64^2 Q-U loop's card terms tg and CPU terms tc part: at
    the sample where Q parts most, Q's, U's and I's gaps against I's
    largest value and against their own; how far Q cancels there (sum
    |q_px| / |Q|); the share of sum |d q_px| that its 4 largest pixels
    carry, with their crossings, |d r| and relative |d I|; and how far
    the loop of a kernel that rotated by chi in place of 2 chi would sit
    from the right one, against I's largest value (the gate's bar is
    1e-3)."""
    curves = {d: dict(I=t["I"].sum(1), Q=t["I"] @ t["cos2.0"],
                      U=t["I"] @ t["sin2.0"]) for d, t in (("g", tg),
                                                          ("c", tc))}
    i_max = float(np.abs(curves["c"]["I"]).max())
    k = int(np.argmax(np.abs(curves["g"]["Q"] - curves["c"]["Q"])))
    row = dict(sample=k)
    for name in ("I", "Q", "U"):
        gap = float(np.abs(curves["g"][name] - curves["c"][name]).max())
        row[f"{name}_rel_I"] = gap / i_max
        row[f"{name}_rel_own"] = gap / float(
            np.abs(curves["c"][name]).max())
    q_g, q_c = tg["I"][k] * tg["cos2.0"], tc["I"][k] * tc["cos2.0"]
    dq = np.abs(q_g - q_c)
    top = np.argsort(-dq)[:4]
    row.update(q_cancellation=float(np.abs(q_c).sum()
                                    / max(abs(q_c.sum()), 1e-30)),
               top4_share=float(dq[top].sum() / max(dq.sum(), 1e-30)),
               top4=[dict(pixel=int(p), n_hits=[int(tg["n_hits"][p]),
                                                int(tc["n_hits"][p])],
                          d_r0=float(abs(tg["r0"][p] - tc["r0"][p])),
                          d_I_rel=float(abs(tg["I"][k, p] - tc["I"][k, p])
                                        / max(tc["I"][k, p], 1e-30)))
                     for p in top])
    wrong = max(float(np.abs(tc["I"] @ tc[f"{f}1.0"]
                             - curves["c"][n]).max())
                for f, n in (("cos", "Q"), ("sin", "U")))
    row["chi_for_2chi_rel_I"] = wrong / i_max
    return row


def p24_grid_trace(al, th, slots, max_steps, kernel=True):
    """The decomposition's translucent recorder on the 1024^2 config-4
    grid, through the kernel wrapper or the plain loop (a PlainPool
    job)."""
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    kerr = p24_metric("kerr")
    fn = kk.trace_disk_rays_cuda if kernel else kk.trace_disk_rays_plain
    return fn(kerr, R_OBS, al, th, THETA_DISK, LAMBDA_MAX, max_steps,
              p24_plane(kerr), slots)


def disk_family_phase(dev, card, pool, ctx):
    """Phase 24; returns the kernels-line entry of the wide instances."""
    import torch
    t_phase = time.perf_counter()
    from light_path_tracer_tpu_torch import camera
    from light_path_tracer_tpu_torch import disk as dm
    from light_path_tracer_tpu_torch.ops.cuda import _build
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    al_d, th_d = ctx["disk_rays"]
    scene = p24_scene()
    fov = camera.fov_from_vertical(scene.vertical_fov, P24_DIM)
    grid = dict(dtype=torch.float32, device=dev)
    al4 = camera.build_alpha_lookup(P24_DIM, fov, **grid).reshape(-1)
    th4 = camera.build_theta_lookup(P24_DIM, fov, **grid).reshape(-1)
    # The plain loop on the 1024^2 grid with the decomposition's 6 slots,
    # capped as phase 8 caps its grid (the plain loop costs ~4 ms an
    # iteration at 1M rays), queued first.
    jobs = {"grid": pool.submit("p24_grid_trace", al4, th4, 6, GRID_STEPS,
                                kernel=False)}
    rays = {}
    for family in ("kerr", "kerr_newman"):
        al, th = p24_wide_rays(family, al_d, th_d)
        rays[family, "float32"] = (al, th)
        rays[family, "float64"] = (al.double(), th.double())
    jobs.update({combo: pool.submit("p24_wide_trace", combo[2],
                                    *rays[combo[2], combo[1]], WIDE_SLOTS,
                                    combo[3], combo[0], kernel=False)
                 for combo in WIDE_COMBOS})
    jobs.update({("cpu", mode): pool.submit("p24_render", mode, P24_CHECK,
                                            "cpu", check=True, on="cpu")
                 for mode in P24_MODES})
    jobs["cpu", "qu terms"] = pool.submit("p24_qu_terms", P24_CHECK, "cpu",
                                          on="cpu")
    for library in ("more", "dop853"):
        for name, regs, spill in ptxas_report(
                _build.load_library(library).build_log):
            if "hits=8" in name:
                print(f"  ptxas: {name}: {regs} registers; {spill} "
                      f"(block bound {5})", flush=True)

    # -- (a) the wide instances against the narrow ones and the plain loop
    print(f"wide disk instances ({WIDE_SLOTS} slots, the decomposition's "
          f"translucent recorder, {al_d.numel()} random rays, 1024 of them "
          f"just outside the critical curve): slots 0-3 against the 4-slot "
          f"instance, and against the plain loop (phase 8's gates):",
          flush=True)
    wide = {}
    for combo in WIDE_COMBOS:
        method, dtype, family, momentum = combo
        al, th = rays[family, dtype]
        args = (family, al, th)
        kw = dict(momentum=momentum, method=method)
        narrow = p24_wide_trace(*args, 4, **kw)
        probe = {}
        rk = p24_wide_trace(*args, WIDE_SLOTS, probe=probe, **kw)
        pairs = [(rk.status, narrow.status),
                 (rk.final_alpha, narrow.final_alpha),
                 (rk.n_hits.clamp(max=4), narrow.n_hits)]
        for field in ("r_hits", "phi_hits", "pr_hits", "pth_hits"):
            pairs += list(zip(getattr(rk, field)[:4],
                              getattr(narrow, field)))
        first4 = all(same_bits(a, b) for a, b in pairs)
        plain_ms, rp = PlainPool.result(jobs[combo], dev)
        g = disk_compare(rk, rp)
        g.update(first_slots_bitwise=first4,
                 plain_ms=plain_ms, bitwise_plain=disk_bitwise(rk, rp),
                 five_plus=int((rk.n_hits > 4).sum()),
                 max_n_hits=int(rk.n_hits.max()),
                 attempts_sum=int(probe["attempts"].to(torch.int64).sum()),
                 slowest_attempts=int(probe["attempts"].max()))
        label = f"{method} {dtype} {family}" + (" momenta" if momentum
                                                 else "")
        wide[combo] = g
        print(f"  {label}: {json.dumps(g)}", flush=True)
        require(first4 and g["status_agree"] > 0.99
                and g["nhits_agree"] > 0.99 and g["median_dr"] < 1e-3
                and g["p99_dr"] < 0.1 and g["median_dfa"] < 1e-4
                and g["five_plus"] > 0, f"phase 24 wide {label}: {g}")
        # Every slot, not only the first: the recorded radii of rays that
        # hit in both versions, slot by slot.
        for k in range(4, WIDE_SLOTS):
            hit = ((rk.n_hits > k) & (rp.n_hits > k)).cpu()
            if hit.any():
                dk = (rk.r_hits[k].cpu() - rp.r_hits[k].cpu()).abs()[hit]
                require(float(dk.double().median()) < 1e-3,
                        f"phase 24 wide {label} slot {k}: median |d r| "
                        f"{float(dk.double().median())}")
    # The 1024^2 grid with the decomposition's 6 slots (the path's own
    # rays and width) against the plain loop, both capped at GRID_STEPS
    # (every ray of this grid ends within ~180 attempts, so the cap
    # leaves the trace whole): phase 8's gates on every slot.
    rk = p24_grid_trace(al4, th4, 6, GRID_STEPS)
    grid_plain_ms, rp = PlainPool.result(jobs["grid"], dev)
    gg = disk_compare(rk, rp)
    nk, npl = rk.n_hits.cpu().numpy(), rp.n_hits.cpu().numpy()
    slot_rows = []
    for k in range(6):
        both = (nk > k) & (npl > k)
        d = np.abs(rk.r_hits[k].cpu().numpy()[both]
                   - rp.r_hits[k].cpu().numpy()[both]).astype(np.float64)
        slot_rows.append(dict(
            hit=int(both.sum()),
            median_dr=float(np.median(d)) if d.size else 0.0,
            p99_dr=float(np.percentile(d, 99)) if d.size else 0.0,
            max_dr=float(d.max()) if d.size else 0.0))
    gg.update(plain_ms=grid_plain_ms, bitwise_plain=disk_bitwise(rk, rp),
              slots=slot_rows, max_n_hits=int(rk.n_hits.max()),
              n=int(al4.numel()), max_steps=GRID_STEPS)
    print(f"  1024^2 translucent grid, 6 slots, both capped at "
          f"{GRID_STEPS}, kernel vs plain loop: {json.dumps(gg)}",
          flush=True)
    require(gg["status_agree"] > 0.99 and gg["nhits_agree"] > 0.99
            and gg["median_dfa"] < 1e-4
            and all(r["median_dr"] < 1e-3 and r["p99_dr"] < 0.1
                    for r in slot_rows), f"phase 24 1024^2 grid: {gg}")
    del rk, rp
    # Each wide instance against the 4-slot one on the same rays, timed
    # once the children have left the card (their plain loops would
    # share it).
    for combo, g in wide.items():
        method, dtype, family, momentum = combo
        args = (family, *rays[family, dtype])
        kw = dict(momentum=momentum, method=method)
        g["narrow_ms"] = kernel_alone_ms(
            lambda: p24_wide_trace(*args, 4, **kw), 3)
        g["ms"] = kernel_alone_ms(
            lambda: p24_wide_trace(*args, WIDE_SLOTS, **kw), 3)
    times = {" ".join(map(str, k)): [g["ms"], g["narrow_ms"]]
             for k, g in wide.items()}
    print(f"  kernel alone, wide (8 slots) against 4-slot, ms: "
          f"{json.dumps(times)}", flush=True)
    fn = kk.trace_disk_rays_cuda
    # Nine slots and more go to the plane recorder as one equatorial
    # plane (phase 26 holds 12 bitwise against the plain loop).
    before = (fn.launches_wide, fn.launches_planes)
    p24_wide_trace("kerr", al_d, th_d, WIDE_SLOTS + 1, False, "dp45")
    require((fn.launches_wide, fn.launches_planes)
            == (before[0], before[1] + 1),
            "max_hits above 8 on a CUDA tensor did not launch the plane "
            "recorder")

    # The 1024^2 translucent config-4 grid: 4, 6 and 8 slots.
    kerr = p24_metric("kerr")
    grid_rows = {}
    for slots in (4, 6, 8):
        call = functools.partial(
            fn, kerr, R_OBS, al4, th4, THETA_DISK, LAMBDA_MAX, 200000,
            p24_plane(kerr), slots)
        n0 = disk_launches()
        call()
        probe = {}
        res = call(probe=probe)
        grid_rows[slots] = dict(
            ms=kernel_alone_ms(call, 3), launches=disk_launches() - n0,
            attempts_per_ray=float(probe["attempts"].double().mean()),
            attempts_max=int(probe["attempts"].max()),
            n_hits_max=int(res.n_hits.max()),
            rays_with_5_plus=int((res.n_hits > 4).sum()))
    print(f"  1024^2 translucent grid, slots 4/6/8: "
          f"{json.dumps(grid_rows)} on {card}", flush=True)

    # -- (b) every render at 1024^2, warm-up and 3 runs ------------------
    wrapper, driver, plain = p24_counters()
    outs, rows = {}, {}
    for mode in P24_MODES:
        kk.zero_counters(wrapper)
        driver.launches = plain.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        render = functools.partial(p24_render, mode, P24_DIM, dev)
        out = render()
        runs = []
        for _ in range(3):
            out = render()
            runs.append(dict(out[-1]["timings"]))
        st = out[-1]
        row = dict(disk_launches=disk_launches(),
                   wide_launches=wrapper.launches_wide,
                   driver_calls=driver.launches,
                   plain_loop_calls=plain.launches,
                   best_rays_per_s=max(st["traced_rays"] / t["precompute"]
                                       for t in runs),
                   peak_mib=torch.cuda.max_memory_allocated(dev) / 2**20,
                   integrator_steps=st.get("integrator_steps"),
                   disk_pixels=st.get("disk_pixels"), timings=runs)
        require(row["disk_launches"] > 0 and row["plain_loop_calls"] == 0,
                f"phase 24 {mode}: {row}")
        if mode == "decomposed x6":
            require(row["wide_launches"] > 0, f"phase 24 {mode}: {row}")
        row["profile"] = device_profile(render, 1, "kerr_d", disk_launches)
        outs[mode], rows[mode] = out, row
        print(f"{mode} {P24_DIM[0]}^2: {json.dumps(row)}; best "
              f"{row['best_rays_per_s']:,.0f} rays/s on {card}", flush=True)
    path_wide = sum(r["wide_launches"] for r in rows.values())

    # The physics checks of the JAX package's own tests.
    checks = {}
    for n in (3, 6):
        layers, st = outs[f"decomposed x{n}"]
        flux = np.asarray(st["flux_per_order"])
        res = dm.trace_disk_rays(kerr, R_OBS, al4, th4, THETA_DISK,
                                 LAMBDA_MAX, 200000,
                                 dm.DiskConfig(opaque=False, max_hits=n))
        tot, _ = dm.disk_emission(scene, dm.DiskConfig(opaque=False,
                                                       max_hits=n),
                                  dm.r_isco(1.0, 0.9), res.n_hits,
                                  res.r_hits, res.xi)
        nz = flux[flux > 0]
        checks[f"decomposed x{n}"] = c = dict(
            flux=flux.tolist(), captured=st["captured"],
            captured_translucent=int((res.status == -1).sum()),
            total_rel=float(abs(flux.sum() / float(tot.double().sum())
                                - 1.0)),
            finite=bool(torch.isfinite(layers).all()))
        # The recorders differ where a ray's slots fill before its last
        # in-disk crossing: the decomposition's with crossings outside
        # the annulus (JAX's test allows for those critical-curve rays).
        require(c["finite"] and c["captured"] == c["captured_translucent"]
                and nz.size >= 2 and np.all(nz[:-1] > nz[1:])
                and c["total_rel"] < 5e-3, f"phase 24 decomposed: {c}")
    P = p24_period()
    cfg64 = dataclasses.replace(ctx["cfg"], dtype="float64")
    fr, _st = dm.render_disk_frames(scene, P24_DIM, [0.0, P / 2, P], cfg64,
                                    dm.DiskConfig(), device=dev)
    checks["frames"] = c = dict(
        half_orbit=float((fr[1] - fr[0]).abs().max()),
        full_orbit=float((fr[2] - fr[0]).abs().max()))
    require(c["half_orbit"] > 0.05 and c["full_orbit"] < 1e-6,
            f"phase 24 frames: {c}")
    img, st = outs["disk aa x4"]
    checks["disk aa x4"] = c = dict(traced=st["traced_rays"],
                                    disk_pixels=st["disk_pixels"])
    require(bool(torch.isfinite(img).all()) and float(img.min()) >= 0.0
            and float(img.max()) <= 1.0
            and st["traced_rays"] == 4 * P24_DIM[0] * P24_DIM[1],
            f"phase 24 disk aa: {c}")
    comp, st = outs["composite"]
    empty, _ = p24_render("composite empty", P24_DIM, dev)
    free = torch.as_tensor(~st["disk_mask"], device=dev)
    d = (comp - empty).abs().amax(dim=-1)
    trans, st_t = p24_render("composite translucent", P24_DIM, dev)
    base, _ = p24_render("composite translucent empty", P24_DIM, dev)
    checks["composite"] = c = dict(
        disk_pixels=st["disk_pixels"],
        free_unchanged=float((d[free] < 1e-6).float().mean()),
        translucent_adds=float((trans >= base - 1e-6).float().mean()))
    require(st["disk_pixels"] > 1000 and c["free_unchanged"] > 0.98
            and c["translucent_adds"] > 0.99, f"phase 24 composite: {c}")
    img_s, st_s = outs["composite aa x4"]
    img_l, st_l = p24_render("composite aa x4 loop", P24_DIM, dev)
    checks["composite aa x4"] = c = dict(
        max_abs_loop=float((img_s - img_l).abs().max()),
        masks_equal=bool(np.array_equal(st_s["disk_mask"],
                                        st_l["disk_mask"])),
        captured=[st_s["captured"], st_l["captured"]])
    require(c["max_abs_loop"] < 1e-6 and c["masks_equal"]
            and st_s["captured"] == st_l["captured"],
            f"phase 24 composite aa: {c}")
    g, f, st = outs["line profile"]
    seen = g[f > 0.01 * f.max()]
    _g1, f1, _s1 = p24_render("line profile flat", P24_DIM, dev)
    _g4, f4, _s4 = p24_render("line profile flat x4", P24_DIM, dev)
    checks["line profile"] = c = dict(
        blue=float(seen.max()), red=float(seen.min()),
        peak_g=float(g[np.argmax(f)]),
        flat_total_x4_rel=float(abs(f4.sum() / f1.sum() - 1.0)))
    require(c["blue"] > 1.15 and c["red"] < 0.65 and c["peak_g"] > 1.0
            and c["flat_total_x4_rel"] < 0.05, f"phase 24 line: {c}")
    _t, f, st = outs["light curve"]
    half = P24_CURVE // 2
    checks["light curve"] = c = dict(
        periodic_rel=float(np.abs(f[:half] / f[half:] - 1.0).max()),
        modulation=float(f.max() / f.min()))
    require(np.isfinite(f).all() and (f > 0).all()
            and c["periodic_rel"] < 1e-4 and c["modulation"] > 1.2,
            f"phase 24 light curve: {c}")
    evpa, frac, inten, st = outs["polarization"]
    good = np.isfinite(evpa)
    checks["polarization"] = c = dict(
        polarized_pixels=st["polarized_pixels"],
        evpa_range=[float(evpa[good].min()), float(evpa[good].max())],
        pol_frac_max=float(frac.max()))
    require(st["polarized_pixels"] > 1000
            and c["evpa_range"][0] > -np.pi / 2 - 1e-6
            and c["evpa_range"][1] <= np.pi / 2 + 1e-6
            and 0.0 <= float(frac.min()) and c["pol_frac_max"] <= 1.0,
            f"phase 24 polarization: {c}")
    _t, I, Q, U, st = outs["qu loop"]
    area = 0.5 * abs(np.sum(Q[:-1] * U[1:] - Q[1:] * U[:-1]))
    scale = max(Q.max() - Q.min(), U.max() - U.min())
    checks["qu loop"] = c = dict(
        closure_rel=float(max(abs(Q[0] - Q[-1]), abs(U[0] - U[-1]))
                          / max(abs(Q).max(), abs(U).max())),
        area_over_scale2=float(area / max(scale, 1e-30) ** 2))
    require((I > 0).all() and c["closure_rel"] < 1e-4
            and c["area_over_scale2"] > 0.05, f"phase 24 qu loop: {c}")
    print(f"phase 24 physics checks: {json.dumps(checks)}", flush=True)

    # -- (c) the same modes at 64^2 on the card against the CPU ---------
    check64 = {}
    for mode in P24_MODES:
        og = p24_render(mode, P24_CHECK, dev, check=True)
        oc = PlainPool.result(jobs["cpu", mode], "cpu")[1]
        check64[mode], ok = p24_check(mode, og, oc)
        require(ok, f"phase 24 64^2 {mode} card vs CPU: {check64[mode]}")
    print(f"phase 24 check, 64^2 card vs CPU: {json.dumps(check64)}",
          flush=True)
    qu = p24_qu_diagnosis(p24_qu_terms(P24_CHECK, dev),
                          PlainPool.result(jobs["cpu", "qu terms"],
                                           "cpu")[1])
    print(f"phase 24 Q-U loop, 64^2 card vs CPU, pixel by pixel: "
          f"{json.dumps(qu)}", flush=True)
    require(qu["chi_for_2chi_rel_I"] > 1e-2, f"phase 24 Q-U loop: the "
            f"gate would not tell chi from 2 chi: {qu}")
    print(f"phase 24: {time.perf_counter() - t_phase:.1f} s", flush=True)

    g = wide["dp45", "float32", "kerr", True]
    entry = kernel_entry(
        "kerr_dp45_disk_wide", WIDE_SOURCE, f"{JAX_KERNELS}:316", path_wide,
        max(g["max_dr"], max(r["max_dr"] for r in gg["slots"])), g["ms"],
        g["plain_ms"], int(al_d.numel()), 8 + 20 + 4 * 4 * WIDE_SLOTS,
        g["attempts_sum"] * kerr_work(), g)
    entry["grid_1024_6_slots"] = gg
    return [entry]


# Phase 25: tilted, warped and two-plane disks and crossing times through
# the disk kernel's plane recorder (csrc/kerr_planes.cuh, the instances of
# csrc/kerr_dp45_planes.cu and its siblings), the moving camera (boost)
# and the image-domain observables.
PLANES_SOURCE = "light_path_tracer_tpu_torch/csrc/kerr_dp45_planes.cu"
P25_INSTANCES = tuple((method, dtype, family)
                      for method in ("dp45", "dop853")
                      for dtype in ("float32", "float64")
                      for family in ("kerr", "kerr_newman"))
# The plane sets held bitwise against the plain loop: one flat tilted
# opaque plane; an equatorial opaque disk and a tilted opaque ring with
# the time recorder; a warped translucent disk and a tilted translucent
# plane with the time recorder and momenta, 6 slots each.
P25_SETS = ("tilt", "opaque", "translucent")
# The random rays' attempt cap, kernel and plain loop alike: the plain
# loop costs ~10-30 ms an iteration, and a lane that never ends runs to
# the cap in it (phase 24's 1,000 took 2-28 s a set).
P25_STEPS = 400
P25_TILT = (float(np.radians(30.0)), float(np.radians(45.0)))
P25_MODES = ("tilt", "warp", "disk2", "light curve delay", "boost disk",
             "boost shadow", "boost lens", "boost volumetric",
             "boost spectral")
P25_BOOST = (0.0, 0.0, 0.5)
P25_CURVE = 64


def p25_disks(name):
    """(DiskConfigs, record_time, record_momentum) of a plane set."""
    from light_path_tracer_tpu_torch.disk import DiskConfig
    tilt, az = P25_TILT
    if name == "tilt":
        return [DiskConfig(tilt=tilt, tilt_azimuth=az)], False, False
    if name == "opaque":
        return [DiskConfig(r_out=12.0),
                DiskConfig(r_in=14.0, r_out=24.0, tilt=tilt,
                           tilt_azimuth=az)], True, False
    return [DiskConfig(tilt=tilt, tilt_azimuth=az, warp_radius=10.0,
                       opaque=False, max_hits=6),
            DiskConfig(r_in=3.0, r_out=20.0, tilt=-np.radians(25.0),
                       tilt_azimuth=-1.0, opaque=False, max_hits=6)], \
        True, True


def p25_trace(family, al, th, name, method, kernel=True,
              max_steps=P25_STEPS, **kw):
    """Phase 25's plane set `name` on rays (al, th) through the kernel
    wrapper or the plain loop (a PlainPool job), capped at max_steps: a
    tuple of DiskTraceResult, one a plane."""
    from light_path_tracer_tpu_torch import disk as dm
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    m = p24_metric(family)
    disks, record_time, momentum = p25_disks(name)
    planes = [(dm._plane_of(d, m), dm._normal_of(d)) for d in disks]
    fn = kk.trace_disk_rays_cuda if kernel else kk.trace_disk_rays_plain
    out = fn(m, R_OBS, al, th, THETA_DISK, LAMBDA_MAX, max_steps,
             planes[0][0], max(d.max_hits for d in disks),
             record_momentum=momentum, method=method,
             disk_normal=planes[0][1], extra_disks=tuple(planes[1:]),
             record_time=record_time, **kw)
    return out if len(disks) > 1 else (out,)


def p25_fields(res):
    """Every output of a plane's DiskTraceResult as (name, tensor)."""
    rows = []
    for field in res._fields:
        v = getattr(res, field)
        if isinstance(v, tuple):
            rows += [(f"{field}[{k}]", x) for k, x in enumerate(v)]
        else:
            rows.append((field, v))
    return rows


def p25_bitwise(rk, rp):
    """Kernel records rk against plain records rp (tuples of planes):
    the names of the outputs that differ, and the largest |d| of each."""
    bad = {}
    for k, (a, b) in enumerate(zip(rk, rp)):
        for (name, x), (_n, y) in zip(p25_fields(a), p25_fields(b)):
            if not same_bits(x.to(y.device), y):
                d = (x.double().cpu() - y.double().cpu()).abs()
                bad[f"plane {k} {name}"] = float(d.nan_to_num().max())
    return bad


def p25_recorder_vs_wide(al, th, slots, max_steps, momentum, method):
    """Phase 24's translucent equatorial plane through the wide disk
    instance and through the plane recorder (kind 0, no time recorder) on
    rays (al, th) with `slots` slots: whether every output both write is
    bitwise the same, and each one's kernel-alone ms (mean of 3, in turns
    wide, planes, planes, wide)."""
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    kerr = p24_metric("kerr")
    plane = p24_plane(kerr)
    fns = dict(
        wide=lambda: kk.trace_disk_rays_cuda(
            kerr, R_OBS, al, th, THETA_DISK, LAMBDA_MAX, max_steps, plane,
            slots, record_momentum=momentum, method=method),
        planes=lambda: kk._trace_planes(
            kerr, R_OBS, al, th, THETA_DISK, LAMBDA_MAX, max_steps,
            [(plane, None)], slots, "fast", False, momentum, None, True,
            method, False, multi=False))
    a, b = fns["wide"](), fns["planes"]()
    fields = ("status", "n_hits", "final_alpha", "n_half", "xi",
              "n_steps", "r_hits", "phi_hits", "pr_hits", "pth_hits")
    same = all(len(getattr(a, f)) == len(getattr(b, f))
               and all(same_bits(x, y) for x, y in zip(getattr(a, f),
                                                       getattr(b, f)))
               if isinstance(getattr(a, f), tuple)
               else same_bits(getattr(a, f), getattr(b, f))
               for f in fields)
    ms = dict(wide=[], planes=[])
    for name in ("wide", "planes", "planes", "wide"):
        ms[name].append(kernel_alone_ms(fns[name], 3))
    return same, {k: float(np.mean(v)) for k, v in ms.items()}


def p25_scene(boost=(0.0, 0.0, 0.0), **kw):
    from light_path_tracer_tpu_torch.utils.config import SceneConfig
    base = dict(M=1.0, a=0.9, r_obs_mult=R_OBS, theta_obs=THETA_DISK)
    base.update(kw)
    return SceneConfig(boost=tuple(boost), **base)


def p25_render(mode, dim, device, boost=P25_BOOST):
    """Phase 25's render `mode` at `dim` on `device` through the user's
    entry point; returns (image or curve, stats) with stats carrying
    traced_rays and timings. `boost` is the moving modes' camera
    velocity (the static twin of a boosted mode takes (0, 0, 0))."""
    from light_path_tracer_tpu_torch import disk as dm
    from light_path_tracer_tpu_torch import pipeline, spectra, volumetric
    from light_path_tracer_tpu_torch.utils.config import RenderConfig
    cfg = RenderConfig()
    tilt, az = P25_TILT
    kw = dict(device=device)
    if mode == "tilt":
        return dm.render_disk(p25_scene(), dim, cfg,
                              dm.DiskConfig(tilt=tilt, tilt_azimuth=az), **kw)
    if mode == "warp":
        return dm.render_disk(p25_scene(), dim, cfg,
                              dm.DiskConfig(tilt=tilt, tilt_azimuth=az,
                                            warp_radius=10.0), **kw)
    if mode == "disk2":
        # the CLI's --disk2 defaults: an opaque ring out to 30 M tilted 25
        return dm.render_multi_disk(
            p25_scene(), dim, cfg,
            [dm.DiskConfig(), dm.DiskConfig(r_out=30.0,
                                            tilt=np.radians(25.0))], **kw)
    if mode == "light curve delay":
        P = p24_period()
        t, f, st = spectra.hotspot_light_curve(
            p25_scene(), dim, [2.0 * P * k / P25_CURVE
                               for k in range(P25_CURVE)],
            cfg, dm.DiskConfig(), light_travel_delay=True, **kw)
        return t, f, st
    if mode == "boost disk":
        return dm.render_disk(p25_scene(boost), dim, cfg,
                              dm.DiskConfig(spectrum="blackbody"), **kw)
    if mode == "boost shadow":
        # config 3's scene, a moving camera
        return pipeline.render_shadow(
            p25_scene(boost, theta_obs=float(np.pi / 2)), dim, cfg, **kw)
    if mode == "boost lens":
        # config 2's Schwarzschild lens at half the side
        src = np.random.default_rng(3).random(
            (dim[0] // 2, dim[1] // 2, 3)).astype(np.float32)
        out = pipeline.render_scene(p25_scene(boost, a=0.0,
                                              theta_obs=float(np.pi / 2)),
                                    src, cfg, **kw)
        return out.image, dict(traced_rays=out.precompute.traced_rays,
                               timings=out.timings)
    riaf, freqs = scene_forms()["volumetric thin" if mode.endswith(
        "volumetric") else "spectral 3-band"]
    scene = p25_scene(boost, theta_obs=THETA_VOL, vertical_fov_deg=16.0)
    if freqs is None:
        return volumetric.render_volumetric(scene, dim, cfg, riaf, **kw)
    return volumetric.render_volumetric_spectrum(scene, dim, freqs, cfg,
                                                 riaf, **kw)


def p25_counters():
    """(wrapper, counter name pairs) of every kernel a phase-25 render
    may launch, and the plain loops that none may call."""
    from light_path_tracer_tpu_torch.ops import kerr_trace as tk
    from light_path_tracer_tpu_torch.ops import schwarzschild_trace as st
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    from light_path_tracer_tpu_torch.ops.cuda import schwarzschild_kernel as sk
    from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk
    wrappers = dict(disk=kk.trace_disk_rays_cuda,
                    kerr=kk.trace_rays_kerr_cuda,
                    orbit=sk.trace_rays_schwarzschild_cuda,
                    volumetric=vk.trace_rays_volumetric_cuda,
                    aux=vk.trace_rays_aux_cuda,
                    spectral=vk.trace_rays_spectral_cuda)
    plain = (tk.trace_disk_rays_kerr, tk.trace_rays_kerr,
             tk.trace_rays_volumetric, tk.trace_rays_aux,
             tk.trace_rays_spectral, st.trace_rays_schwarzschild)
    return wrappers, plain


def p25_zero():
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    wrappers, plain = p25_counters()
    for fn in wrappers.values():
        if hasattr(fn, "launches_dop853"):
            kk.zero_counters(fn)
        else:
            fn.launches = fn.launches_f64 = 0
    for fn in plain:
        fn.launches = 0


def p25_counts():
    """Launches by wrapper (all pairs, dtypes and instance sets) and the
    plain loops' calls since p25_zero."""
    wrappers, plain = p25_counters()
    counts = {name: sum(v for k, v in vars(fn).items()
                        if k.startswith("launches"))
              for name, fn in wrappers.items()}
    import torch
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    counts["planes"] = sum(
        getattr(wrappers["disk"], kk.counter_name(dtype, method, "planes"))
        for dtype in (torch.float32, torch.float64)
        for method in ("dp45", "dop853"))
    counts["plain_loop_calls"] = sum(fn.launches for fn in plain)
    return counts


def p25_images(mode, out):
    """(image-like tensor, mask) of a phase-25 render for the 64^2
    comparison (the spectral bands stacked like frames)."""
    import torch
    img = out[0]
    if mode == "boost spectral":
        return img, img.sum(dim=0) > 0
    if mode in ("boost shadow", "boost lens"):
        return img, torch.ones(img.shape[:2], dtype=torch.bool,
                               device=img.device)
    return p24_images(mode, out)


def p25_check(mode, og, oc):
    """Phase 24's 64^2 gates on a phase-25 mode (the curve's as phase
    24's light curve, the spectral bands as its frames)."""
    if mode == "light curve delay":
        return p24_check("light curve", og, oc)
    ig, mg = p25_images(mode, og)
    ic, mc = p25_images(mode, oc)
    ig, mg = ig.cpu(), mg.cpu()
    agree = float((mg == mc).float().mean())
    both = mg & mc
    d = (ig.double() - ic.double()).abs()
    if mode == "boost spectral":
        d = d.amax(dim=0)
    if d.dim() == 3:
        d = d.amax(dim=-1)
    med = float(d[both].median()) if both.any() else 0.0
    row = dict(mask_agree=agree, median=med,
               max_abs=float(d.max()), differing=int((d > 0).sum()))
    # the shadow and the lens are held pixel by pixel as configs 1-3 are
    if mode in ("boost shadow", "boost lens"):
        return row, float((d > 1e-3).float().mean()) <= 0.01
    return row, agree >= 0.99 and med < 1e-3


def p25_blue(img):
    """Mean blue over mean red of a blackbody disk image's disk pixels."""
    disk = img.sum(dim=-1) > 0
    return float(img[..., 2][disk].double().mean()
                 / img[..., 0][disk].double().mean())


def p25_block_row(label, regs, spill):
    """A plane-recorder instance's ptxas figures and the blocks of 128
    threads an SM holds at those registers (65,536 / (128 x registers
    rounded up to 8), at most 16)."""
    import re
    nums = dict((k, int(v)) for v, k in re.findall(
        r"(\d+) bytes (stack frame|spill stores|spill loads)", spill))
    return dict(registers=regs, spill_stores=nums.get("spill stores"),
                spill_loads=nums.get("spill loads"),
                stack_bytes=nums.get("stack frame"),
                blocks_per_sm=min(16, 65536 // (128 * (-(-regs // 8) * 8))),
                min_blocks=5)


def tilted_phase(dev, card, pool, ctx):
    """Phase 25; returns the kernels-line entry of the plane-recorder
    instances."""
    import torch
    from light_path_tracer_tpu_torch import camera
    from light_path_tracer_tpu_torch import disk as dm
    from light_path_tracer_tpu_torch import observables
    from light_path_tracer_tpu_torch.ops.cuda import _build
    t_phase = time.perf_counter()
    al_d, th_d = ctx["disk_rays"]
    # The plain loops first (the children share the card): each plane set
    # on config 4's 1024^2 grid (float32, DP45, Kerr: what the 1024^2
    # renders launch), capped as phase 8 caps its grid, then the random
    # rays; then the CPU side of the 64^2 checks.
    fov = camera.fov_from_vertical(p24_scene().vertical_fov, P24_DIM)
    grid = dict(dtype=torch.float32, device=dev)
    al4 = camera.build_alpha_lookup(P24_DIM, fov, **grid).reshape(-1)
    th4 = camera.build_theta_lookup(P24_DIM, fov, **grid).reshape(-1)
    jobs = {("grid", name): pool.submit("p25_trace", "kerr", al4, th4, name,
                                        "dp45", kernel=False,
                                        max_steps=GRID_STEPS)
            for name in P25_SETS}
    rays = {}
    for family in ("kerr", "kerr_newman"):
        al, th = p24_wide_rays(family, al_d, th_d)
        rays[family, "float32"] = (al, th)
        rays[family, "float64"] = (al.double(), th.double())
    jobs.update({(inst, name): pool.submit("p25_trace", inst[2],
                                           *rays[inst[2], inst[1]], name,
                                           inst[0], kernel=False)
                 for inst in P25_INSTANCES for name in P25_SETS})
    jobs.update({("cpu", mode): pool.submit("p25_render", mode, P24_CHECK,
                                            "cpu", on="cpu")
                 for mode in P25_MODES})
    res_rows = {}
    for library in ("more", "dop853"):
        lib = _build.load_library(library)
        print(f"  {library} library: built in {lib.build_seconds:.1f} s "
              f"in this process", flush=True)
        for name, regs, spill in ptxas_report(lib.build_log):
            if "_planes<" in name:
                res_rows[name] = p25_block_row(name, regs, spill)
                print(f"  ptxas: {name}: {json.dumps(res_rows[name])}",
                      flush=True)

    # -- (a) every instance bitwise its plain loop -----------------------
    print(f"plane recorder ({len(P25_INSTANCES)} instances x "
          f"{len(P25_SETS)} plane sets, {al_d.numel()} rays, 1024 of them "
          f"just outside the critical curve, capped at {P25_STEPS}) "
          f"against the plain loop on the card, bitwise:", flush=True)
    rows = {}
    for inst in P25_INSTANCES:
        method, dtype, family = inst
        for name in P25_SETS:
            probe = {}
            rk = p25_trace(family, *rays[family, dtype], name, method,
                           probe=probe)
            plain_ms, rp = PlainPool.result(jobs[inst, name], dev)
            bad = p25_bitwise(rk, rp)
            row = dict(bitwise=not bad, differing=bad, plain_ms=plain_ms,
                       hits=[int((r.n_hits > 0).sum()) for r in rk],
                       slots_filled=[int(r.n_hits.max()) for r in rk],
                       attempts_sum=int(probe["attempts"].to(
                           torch.int64).sum()),
                       accepted_sum=int(probe["accepted"].to(
                           torch.int64).sum()),
                       crossings=[int(r.n_hits.to(torch.int64).sum())
                                  for r in rk])
            rows[inst, name] = row
            print(f"  {method} {dtype} {family} {name}: {json.dumps(row)}",
                  flush=True)
            require(not bad and all(h > 0 for h in row["hits"]),
                    f"phase 25 {inst} {name}: {row}")
    # Each plane set on the 1024^2 grid, kernel and plain loop both capped
    # at GRID_STEPS: every output of every plane bitwise.
    grid_rows = {}
    for name in P25_SETS:
        probe = {}
        rk = p25_trace("kerr", al4, th4, name, "dp45", max_steps=GRID_STEPS,
                       probe=probe)
        plain_ms, rp = PlainPool.result(jobs["grid", name], dev)
        bad = p25_bitwise(rk, rp)
        grid_rows[name] = row = dict(
            bitwise=not bad, differing=bad, plain_ms=plain_ms,
            hits=[int((r.n_hits > 0).sum()) for r in rk],
            slots_filled=[int(r.n_hits.max()) for r in rk],
            slowest_attempts=int(probe["attempts"].max()),
            n=int(al4.numel()), max_steps=GRID_STEPS)
        print(f"  1024^2 grid, dp45 float32 kerr {name}, both capped at "
              f"{GRID_STEPS}: {json.dumps(row)}", flush=True)
        require(not bad and all(h > 0 for h in row["hits"]),
                f"phase 25 1024^2 grid {name}: {row}")
    # The kernel alone once the children have left the card.
    for name in P25_SETS:
        grid_rows[name]["ms"] = kernel_alone_ms(
            lambda: p25_trace("kerr", al4, th4, name, "dp45",
                              max_steps=GRID_STEPS), 3)
    for inst in P25_INSTANCES:
        method, dtype, family = inst
        for name in ("tilt", "translucent"):
            args = (family, *rays[family, dtype], name, method)
            rows[inst, name]["ms"] = kernel_alone_ms(
                lambda: p25_trace(*args), 3)
    times = {" ".join(k[0]) + " " + k[1]: r["ms"] for k, r in rows.items()
             if "ms" in r}
    print(f"  kernel alone, ms: {json.dumps(times)} on {card}", flush=True)

    # The equatorial plane through the plane recorder (the time recorder
    # on) is the disk variant bitwise in every output both write.
    kerr = p24_metric("kerr")
    plane = (dm.r_isco(1.0, 0.9), 20.0, float(np.pi / 2), True)
    for method in ("dp45", "dop853"):
        for dtype in ("float32", "float64"):
            al, th = rays["kerr", dtype]
            kw = dict(method=method)
            a = kk_disk(kerr, al, th, plane, **kw)
            b = kk_disk(kerr, al, th, plane, record_time=True, **kw)
            same = all(same_bits(x, y) for x, y in (
                (a.status, b.status), (a.n_hits, b.n_hits),
                (a.final_alpha, b.final_alpha), (a.n_half, b.n_half),
                *zip(a.r_hits, b.r_hits), *zip(a.phi_hits, b.phi_hits)))
            require(same and len(b.t_hits) == 2,
                    f"phase 25: the equatorial plane recorder differs from "
                    f"the disk variant ({method} {dtype})")
    print("  the equatorial plane through the plane recorder equals the "
          "disk variant bitwise (both pairs, both dtypes)", flush=True)
    # The plane recorder with phase 24's plane (kind 0, no time recorder)
    # against the wide instance it could stand in for: on the 1024^2 grid
    # with the decomposition's 6 slots, and on phase 24's random rays with
    # its slots and momenta.
    al24, th24 = p24_wide_rays("kerr", al_d, th_d)
    vs_wide = {}
    for label, args in (
            ("1024^2 grid 6 slots", (al4, th4, 6, GRID_STEPS, False)),
            (f"phase 24 rays {WIDE_SLOTS} slots momenta",
             (al24, th24, WIDE_SLOTS, WIDE_STEPS, True))):
        for method in ("dp45", "dop853"):
            same, ms = p25_recorder_vs_wide(*args, method)
            vs_wide[f"{label} {method}"] = row = dict(bitwise=same, **ms)
            require(same, f"phase 25: the plane recorder's kind-0 plane "
                          f"differs from the wide instance ({label} "
                          f"{method}): {row}")
    print(f"  kind-0 plane recorder vs wide instance, kernel alone ms: "
          f"{json.dumps(vs_wide)} on {card}", flush=True)

    # -- (b) every mode at 1024^2 through its entry point ----------------
    outs, modes = {}, {}
    for mode in P25_MODES:
        p25_zero()
        torch.cuda.reset_peak_memory_stats(dev)
        render = functools.partial(p25_render, mode, P24_DIM, dev)
        out = render()
        runs = []
        for _ in range(3):
            out = render()
            runs.append(dict(out[-1]["timings"]))
        st = out[-1]
        row = dict(launches=p25_counts(),
                   best_rays_per_s=max(st["traced_rays"] / t["precompute"]
                                       for t in runs),
                   peak_mib=torch.cuda.max_memory_allocated(dev) / 2**20,
                   timings=runs)
        n = row["launches"]
        kernel = {"boost shadow": "kerr", "boost lens": "orbit",
                  "boost volumetric": "volumetric",
                  "boost spectral": "aux"}.get(mode, "disk")
        require(n[kernel] > 0 and n["plain_loop_calls"] == 0,
                f"phase 25 {mode}: {row}")
        if mode in ("tilt", "warp", "disk2", "light curve delay"):
            require(n["planes"] > 0, f"phase 25 {mode}: {row}")
        row["profile"] = device_profile(render, 1)
        outs[mode], modes[mode] = out, row
        print(f"{mode} {P24_DIM[0]}^2: {json.dumps(row)}; best "
              f"{row['best_rays_per_s']:,.0f} rays/s on {card}", flush=True)
    path_planes = sum(r["launches"]["planes"] for r in modes.values())

    # -- (c) the physics checks ------------------------------------------
    checks = {}
    scene = p25_scene()
    cfg = ctx["cfg"]
    still, _ = dm.render_disk(scene, P24_DIM, cfg, dm.DiskConfig(),
                              device=dev)
    tilt0, _ = dm.render_disk(scene, P24_DIM, cfg,
                              dm.DiskConfig(tilt=0.0), device=dev)
    single, _ = dm.render_multi_disk(scene, P24_DIM, cfg, [dm.DiskConfig()],
                                     device=dev)
    empty = dm.DiskConfig(r_in=8.0, r_out=7.0, opaque=False)
    with_empty, st_e = dm.render_multi_disk(
        scene, P24_DIM, cfg, [dm.DiskConfig(), empty], device=dev)
    checks["tilt 0, one plane, an empty second plane"] = c = dict(
        tilt0=same_bits(tilt0, still), single=same_bits(single, still),
        empty_second=same_bits(with_empty, still),
        empty_pixels=st_e["disk_pixels_per_plane"][1])
    require(all(c[k] for k in ("tilt0", "single", "empty_second"))
            and c["empty_pixels"] == 0, f"phase 25 planes: {c}")
    _t, f, st = outs["light curve delay"]
    half = P25_CURVE // 2
    checks["light curve delay"] = c = dict(
        periodic_rel=float(np.abs(f[:half] / f[half:] - 1.0).max()),
        modulation=float(f.max() / f.min()),
        delay_spread=st["delay_spread"])
    require(np.isfinite(f).all() and (f > 0).all()
            and c["periodic_rel"] < 1e-4 and c["delay_spread"] > 1.0,
            f"phase 25 light curve: {c}")
    img_b = outs["boost disk"][0]
    img_s, _ = p25_render("boost disk", P24_DIM, dev, boost=(0.0, 0.0, 0.0))
    checks["boost disk"] = c = dict(blue_over_red_moving=p25_blue(img_b),
                                    blue_over_red_still=p25_blue(img_s))
    require(c["blue_over_red_moving"] > c["blue_over_red_still"],
            f"phase 25 boosted disk: {c}")
    sh_b = outs["boost shadow"][0]
    sh_s, st_s = p25_render("boost shadow", P24_DIM, dev,
                            boost=(0.0, 0.0, 0.0))
    checks["boost shadow"] = c = dict(
        shadow_px_moving=int((sh_b == 0).sum()),
        shadow_px_still=int((sh_s == 0).sum()))
    require(0 < c["shadow_px_moving"] < c["shadow_px_still"],
            f"phase 25 boosted shadow: {c}")
    # The first null of the Schwarzschild silhouette's visibility gives
    # the shadow's diameter (2 alpha_crit) to 5 %.
    from light_path_tracer_tpu_torch import pipeline
    scene1 = p25_scene(a=0.0, theta_obs=float(np.pi / 2),
                       vertical_fov_deg=16.0)
    img1, st1 = pipeline.render_shadow(scene1, P24_DIM, cfg, device=dev)
    fov1 = camera.fov_from_vertical(scene1.vertical_fov, P24_DIM)
    est, b_null, _prof = observables.shadow_diameter(
        1.0 - img1, fov1, model="disk", pad=4)
    true_d = 2.0 * st1["alpha_crit"]
    checks["shadow diameter"] = c = dict(
        estimate_rad=est, true_rad=true_d, b_null=b_null,
        rel=abs(est / true_d - 1.0))
    require(np.isfinite(b_null) and c["rel"] < 0.05,
            f"phase 25 shadow diameter: {c}")
    print(f"phase 25 physics checks: {json.dumps(checks)}", flush=True)

    # -- (d) every mode at 64^2, the card against the CPU ----------------
    check64 = {}
    for mode in P25_MODES:
        og = p25_render(mode, P24_CHECK, dev)
        oc = PlainPool.result(jobs["cpu", mode], "cpu")[1]
        check64[mode], ok = p25_check(mode, og, oc)
        require(ok, f"phase 25 64^2 {mode} card vs CPU: {check64[mode]}")
    print(f"phase 25 check, 64^2 card vs CPU: {json.dumps(check64)}",
          flush=True)
    print(f"phase 25: {time.perf_counter() - t_phase:.1f} s", flush=True)

    # The entry: the DP45 float32 Kerr instance on the translucent set
    # (two planes, the time recorder, momenta), its bound from the
    # probe's attempts and accepted attempts and the recorded crossings.
    inst = ("dp45", "float32", "kerr")
    g = rows[inst, "translucent"]
    step, crossing = bounds.planes_work((2, 1), record_time=True)
    work = g["attempts_sum"] * kerr_work() + g["accepted_sum"] * step
    for count, per in zip(g["crossings"], crossing):
        work = work + count * per
    n = int(al_d.numel())
    # Bytes a ray: alpha, theta in; final_alpha, n_half, status, p_phi,
    # t_end out, and each plane's count and 6 slots of (r, phi, xi, t,
    # p_r, p_theta).
    entry = kernel_entry(
        "kerr_dp45_planes", PLANES_SOURCE, f"{JAX_KERNELS}:316",
        path_planes, 0.0, g["ms"], g["plain_ms"], n,
        8 + 20 + 2 * (4 + 6 * 6 * 4), work)
    entry.update(
        instances={" ".join(k[0]) + " " + k[1]: dict(
            ms=r.get("ms"), plain_ms=r["plain_ms"], bitwise=r["bitwise"],
            attempts_sum=r["attempts_sum"], accepted_sum=r["accepted_sum"],
            crossings=r["crossings"]) for k, r in rows.items()},
        resources=res_rows, grid_1024=grid_rows,
        recorder_vs_wide=vs_wide, renders_1024={
            m: dict(best_rays_per_s=r["best_rays_per_s"],
                    launches=r["launches"]) for m, r in modes.items()})
    return [entry]


# -- phase 26: the broad instances ------------------------------------------
BROAD_SOURCE = "light_path_tracer_tpu_torch/csrc/kerr_dp45_broad.cu"
BROAD_PLANES_SOURCE = ("light_path_tracer_tpu_torch/csrc/"
                       "kerr_dp45_broad_planes.cu")
# The wide forms held against the plain loop (label -> kind, width,
# absorbing), the narrow widths at which each broad form is held against
# its compiled twin, and the broad entry's form of each kind.
P26_FORMS = {"spectral 12": ("spectral", 12, False),
             "spectral 40": ("spectral", 40, False),
             "movie 16 thin": ("movie", 16, False),
             "movie 16 absorbed": ("movie", 16, True),
             "orders 6 thin": ("order", 6, False),
             "orders 6 absorbed": ("order", 6, True)}
P26_NARROW = {"spectral 3": ("spectral", 3, False),
              "movie 8 thin": ("movie", 8, False),
              "movie 8 absorbed": ("movie", 8, True),
              "orders 4 thin": ("order", 4, False),
              "orders 4 absorbed": ("order", 4, True)}
# The rays (phase 8's first 1,024), their attempt cap (kernel and plain
# loop alike: the plain loop costs ~40-300 ms an iteration at these
# widths, and the mean ray ends in ~25-50 attempts) and the saturation
# window, short enough that some rays end by the saturation exit within
# the cap (the spectra monitor every band, extras 1..n).
P26_RAYS = 1024
P26_STEPS = 64
P26_WINDOW = 16
# The disk checks: 12 equatorial slots (phase 24's plane, momenta), and
# three translucent planes (an equatorial disk, a tilted and a warped one,
# with the time recorder), on phase 24's Kerr rays capped at
# P26_DISK_STEPS; each timed against the instance it extends (8 slots
# through the wide instance, the first two planes through the plane
# recorder's PlaneSet).
P26_SLOTS = 12
P26_DISK_STEPS = 200
P26_DISK_SETS = ("12 slots", "three planes")
P26_DISK_INSTANCES = tuple((method, dtype) for method in ("dp45", "dop853")
                           for dtype in ("float32", "float64"))
P26_MOVIE = 16
# The two-pass drivers' first-pass cap over the extras kernel (the 1024^2
# grid's launches).
DRIVER_PASS1 = 4096
# The plane sets on which the broad recorder's PlaneList is timed against
# the PlaneSet instances it could stand in for (config 4's 1024^2 grid,
# capped at GRID_STEPS): phase 24's equatorial plane with the
# decomposition's 6 slots, and phase 25's sets.
P26_LIST_SETS = ("equatorial", "tilt", "opaque", "translucent")
# Bytes a ray of the broad movie: alpha, theta in; the 1 + P26_MOVIE
# extras, final_alpha, n_half and the status out, and the flags byte.
P26_MOVIE_BYTES = 8 + 4 * (1 + P26_MOVIE + 3) + 1


def p26_form(metric, label):
    """A phase-26 form as aux_forms gives one: (transfer_fn, n_extras,
    aux (), sat_monitor, the form as bounds takes it). Spectra: phase
    12's 3-band scene with `width` bands log-spaced over [0.1, 10]
    (width 3 is phase 12's own); movies: phase 14's blob, `width` frames
    over one period; orders: phase 14's flow."""
    from light_path_tracer_tpu_torch import volumetric
    from light_path_tracer_tpu_torch.disk import keplerian_omega
    kind, width, absorbing = {**P26_FORMS, **P26_NARROW}[label]
    ab = int(absorbing)
    desc = dict(kind=kind, width=width, absorbing=absorbing)
    if kind == "spectral":
        riaf, _freqs = scene_forms()["spectral 3-band"]
        freqs = tuple(float(f) for f in np.geomspace(0.1, 10.0, width))
        return (volumetric.make_spectral_transfer(metric, riaf, freqs),
                1 + width, (), tuple(range(1, 1 + width)), desc)
    riaf = volumetric.RIAFConfig(spot_amp=8.0 if kind == "movie" else 0.0,
                                 alpha0=0.3 if ab else 0.0)
    if kind == "movie":
        period = 2.0 * np.pi / abs(keplerian_omega(1.0, 0.9, 6.0, True))
        times = tuple(period * k / width for k in range(width))
        tf = volumetric.make_movie_transfer(metric, riaf, times)
    else:
        tf = volumetric.make_order_transfer(metric, riaf, width)
    return tf, 1 + ab + width, (), tuple(range(1 + ab, 1 + ab + width)), desc


def p26_broad_form(label):
    """The broad entry's form (volumetric_kernel.BROAD_FORMS) of a
    label's kind."""
    from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk
    kind, _width, absorbing = {**P26_FORMS, **P26_NARROW}[label]
    name = {"spectral": "spectral", "movie": "movie", "order": "orders"}[
        kind]
    if kind != "spectral":
        name += " absorbed" if absorbing else " thin"
    return vk.BROAD_FORMS.index(name)


def p26_trace(family, al, th, label, method, kernel=True,
              max_steps=P26_STEPS, sat_window=P26_WINDOW, **kw):
    """A phase-26 form on rays (al, th) through trace_rays_aux_cuda or
    the plain loop (a PlainPool job), capped at max_steps (P26_STEPS)
    with the saturation exit at sat_window (P26_WINDOW)."""
    m = p24_metric(family)
    return aux_trace(m, p26_form(m, label), al, th, max_steps, kernel,
                     method=method, sat_window=sat_window, **kw)


def p26_render_window():
    """The renders' saturation window (RenderConfig.sat_window): the one
    the main path's launches run with."""
    from light_path_tracer_tpu_torch.utils.config import RenderConfig
    return RenderConfig().sat_window


def p26_launch(family, al, th, label, method, broad,
               max_steps=P26_STEPS, sat_window=P26_WINDOW, probe=None):
    """A phase-26 form through the narrow instance of its width or, with
    `broad`, through the broad entry at the same width (one launch, no
    counter), capped at max_steps: an ExtrasResult."""
    from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk
    m = p24_metric(family)
    tf, n_extras, _aux, monitor, _desc = p26_form(m, label)
    entry, form, width = vk._family(tf.kernel, n_extras, 0)
    if broad:
        entry, form = vk.BROAD_ENTRY, p26_broad_form(label)
    return vk._launch(entry, m, R_OBS, al, th, THETA_VOL, LAMBDA_MAX,
                      max_steps, "fast", form, width, n_extras, tf.kernel,
                      sat_window, monitor, probe, True, (), method)[0]


def p26_extras_bitwise(a, b):
    """Every output of two ExtrasResults bit for bit."""
    return all(same_bits(x, y.to(x.device)) for x, y in zip(
        (*aux_outputs(a), a.n_half_orbits, a.n_steps),
        (*aux_outputs(b), b.n_half_orbits, b.n_steps)))


def p26_planes():
    """The three translucent planes of phase 26's check as DiskConfigs."""
    from light_path_tracer_tpu_torch.disk import DiskConfig
    tilt, az = P25_TILT
    return [DiskConfig(opaque=False, max_hits=6),
            DiskConfig(r_in=3.0, r_out=20.0, tilt=tilt, tilt_azimuth=az,
                       opaque=False, max_hits=6),
            DiskConfig(r_in=4.0, r_out=24.0, tilt=-np.radians(25.0),
                       tilt_azimuth=-1.0, warp_radius=10.0, opaque=False,
                       max_hits=6)]


def p26_disk(al, th, name, method, kernel=True, max_steps=P26_DISK_STEPS,
             **kw):
    """A phase-26 disk check (Kerr a = 0.9) on rays (al, th) through the
    disk wrapper or the plain loop (a PlainPool job), capped at
    max_steps: "12 slots" or "8 slots" of phase 24's plane with
    momenta, "three planes" or "two planes" (the first two) of
    p26_planes with the time recorder. A tuple of DiskTraceResult, one a
    plane."""
    from light_path_tracer_tpu_torch import disk as dm
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    m = p24_metric("kerr")
    fn = kk.trace_disk_rays_cuda if kernel else kk.trace_disk_rays_plain
    if name.endswith("slots"):
        return (fn(m, R_OBS, al, th, THETA_DISK, LAMBDA_MAX, max_steps,
                   p24_plane(m), int(name.split()[0]),
                   record_momentum=True, method=method, **kw),)
    planes = [(dm._plane_of(d, m), dm._normal_of(d)) for d in p26_planes()]
    planes = planes[:3 if name == "three planes" else 2]
    return fn(m, R_OBS, al, th, THETA_DISK, LAMBDA_MAX, max_steps,
              planes[0][0], 6, method=method, disk_normal=planes[0][1],
              extra_disks=tuple(planes[1:]), record_time=True, **kw)


def p26_disk_grid(dev):
    """Config 4's 1024^2 disk grid (phases 24 and 25), flattened, float32
    on `dev`."""
    import torch
    from light_path_tracer_tpu_torch import camera
    fov = camera.fov_from_vertical(p24_scene().vertical_fov, P24_DIM)
    grid = dict(dtype=torch.float32, device=dev)
    return (camera.build_alpha_lookup(P24_DIM, fov, **grid).reshape(-1),
            camera.build_theta_lookup(P24_DIM, fov, **grid).reshape(-1))


def queue_phase26_grids(pool, dev):
    """Phase 26's plain loops at the main paths' shapes, queued to `pool`
    ahead of the phase (each runs for tens of seconds in its child): the
    broad movie at P26_MOVIE frames on the 1024^2 volumetric grid (thin,
    the renders' saturation window) and the three planes on config 4's
    1024^2 disk grid, both capped at GRID_STEPS. Returns (jobs, the grids
    by name)."""
    grids = {"movie": p26_vol_grid(dev), "three planes": p26_disk_grid(dev)}
    jobs = {"movie": pool.submit(
        "p26_trace", "kerr", *grids["movie"], f"movie {P26_MOVIE} thin",
        "dp45", kernel=False, max_steps=GRID_STEPS,
        sat_window=p26_render_window()),
        "three planes": pool.submit(
            "p26_disk", *grids["three planes"], "three planes", "dp45",
            kernel=False, max_steps=GRID_STEPS)}
    return jobs, grids


def p26_list_vs_set(al, th, name, method):
    """A one- or two-plane set (P26_LIST_SETS) on rays (al, th), capped at
    GRID_STEPS, through the PlaneSet instance the wrapper picks and
    through the broad recorder's PlaneList: whether every output is
    bitwise the same, and each one's kernel-alone ms (mean of 3, in turns
    set, list, list, set)."""
    from light_path_tracer_tpu_torch import disk as dm
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    m = p24_metric("kerr")
    if name == "equatorial":
        planes, slots, record_time, momentum = ([(p24_plane(m), None)], 6,
                                                False, False)
    else:
        disks, record_time, momentum = p25_disks(name)
        planes = [(dm._plane_of(d, m), dm._normal_of(d)) for d in disks]
        slots = max(d.max_hits for d in disks)
    fns = {lane: functools.partial(
        kk._trace_planes, m, R_OBS, al, th, THETA_DISK, LAMBDA_MAX,
        GRID_STEPS, planes, slots, "fast", False, momentum, None, True,
        method, record_time, multi=True, plane_list=lane == "list")
        for lane in ("set", "list")}
    same = not p25_bitwise(fns["set"](), fns["list"]())
    ms = dict(set=[], list=[])
    for lane in ("set", "list", "list", "set"):
        ms[lane].append(kernel_alone_ms(fns[lane], 3))
    ms = {k: float(np.mean(v)) for k, v in ms.items()}
    return dict(bitwise=same, planes=len(planes), slots=slots,
                set_ms=ms["set"], list_ms=ms["list"],
                list_over_set=ms["list"] / ms["set"])


def queue_phase26(pool, dev, al_d, th_d):
    """Phase 26's plain loops, queued to `pool` (after phase 25's): every
    broad instance's forms on phase 8's first 1,024 rays, and the disk
    checks on phase 24's Kerr rays (its random ones and 1,024 just outside
    the critical curve). Returns (jobs, the rays by name)."""
    rays = {"extras": (al_d[:P26_RAYS].contiguous(),
                       th_d[:P26_RAYS].contiguous())}
    rays["disk"] = p24_wide_rays("kerr", al_d[:2048], th_d[:2048])
    jobs = {}
    for inst in P25_INSTANCES:
        method, dtype, family = inst
        al, th = rays["extras"]
        if dtype == "float64":
            al, th = al.double(), th.double()
        for label in P26_FORMS:
            jobs[inst, label] = pool.submit("p26_trace", family, al, th,
                                            label, method, kernel=False)
    for method, dtype in P26_DISK_INSTANCES:
        al, th = rays["disk"]
        if dtype == "float64":
            al, th = al.double(), th.double()
        for name in P26_DISK_SETS:
            jobs[method, dtype, name] = pool.submit(
                "p26_disk", al, th, name, method, kernel=False)
    return jobs, rays


def p26_counters():
    """(kernel wrappers by name, the plain loops) whose counts phase 26's
    paths read."""
    from light_path_tracer_tpu_torch.ops import kerr_trace as tk
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk
    return (dict(aux=vk.trace_rays_aux_cuda, disk=kk.trace_disk_rays_cuda,
                 kerr=kk.trace_rays_kerr_cuda,
                 volumetric=vk.trace_rays_volumetric_cuda),
            (tk.trace_rays_aux, tk.trace_rays_spectral,
             tk.trace_rays_volumetric, tk.trace_disk_rays_kerr,
             tk.trace_rays_kerr))


def p26_path(label, run, want, card):
    """Drive one path: every count set to 0 just before, run() once, the
    counts read just after; want: (wrapper, counter) that must have
    grown. Every plain loop must stay at 0. Returns (output, row)."""
    import torch
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    wrappers, plain = p26_counters()
    for fn in wrappers.values():
        kk.zero_counters(fn)
    for fn in plain:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {f"{name}.{k}": v for name, fn in wrappers.items()
              for k, v in sorted(vars(fn).items())
              if k.startswith("launches") and v}
    plain_calls = sum(fn.launches for fn in plain)
    row = dict(launches=counts, plain_loop_calls=plain_calls, wall_s=wall)
    print(f"  {label}: {json.dumps(row)} on {card}", flush=True)
    require(counts.get(f"{want[0]}.{want[1]}", 0) > 0 and plain_calls == 0,
            f"phase 26 {label}: {row}")
    return out, row


def broad_resources(report):
    """RESOURCES of every broad extras instance (both pairs, families and
    dtypes), as extras_resources fills the narrow ones'."""
    import re
    from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk
    ptx = {name: spill for name, _regs, spill in report}
    rows = {}
    for method in ("dp45", "dop853"):
        for label, entry, form, variant, dtype in [
                x for fam in ("", "_kn")
                for x in vk.broad_instances(method, fam)]:
            require(label in ptx or not ptx, f"ptxas reported no {label}")
            d = vk.describe_instance(entry, form, variant, dtype, method)
            nums = dict((k, int(v)) for v, k in re.findall(
                r"(\d+) bytes (stack frame|spill stores|spill loads)",
                ptx.get(label, "")))
            require(d["blocks_per_sm"] > 0, f"{label}: {d}")
            rows[label] = RESOURCES[label] = dict(
                registers=d["registers"],
                spill_stores=nums.get("spill stores"),
                spill_loads=nums.get("spill loads"),
                stack_bytes=nums.get("stack frame"),
                local_bytes=d["local_bytes"],
                blocks_per_sm=d["blocks_per_sm"],
                min_blocks=d["min_blocks"])
    return rows


def broad_phase(dev, card, pool, ctx):
    """Phase 26; returns the kernels-line entries of the broad extras
    instances and the broad plane recorder."""
    import tempfile
    import torch
    from light_path_tracer_tpu_torch import disk as dm
    from light_path_tracer_tpu_torch.cli import main as cli_main
    from light_path_tracer_tpu_torch.ops.cuda import _build
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    from light_path_tracer_tpu_torch.utils.config import RenderConfig
    t_phase = time.perf_counter()
    jobs, rays = ctx["jobs"], ctx["rays"]
    grid_jobs, grids = ctx["grid_jobs"], ctx["grids"]
    window = p26_render_window()
    lib, build_s = ctx["build"].result()
    print(f"  broad library: built in {build_s:.1f} s at nice 19 beside "
          f"phases 11 on ({len(_build._sources('broad'))} sources)",
          flush=True)
    report = ptxas_report(lib.build_log)
    list_rows = {}
    for name, regs, spill in report:
        if "_broad" in name or "_planes_list" in name:
            print(f"  ptxas: {name}: {regs} registers; {spill}", flush=True)
        if "_planes_list<" in name:
            list_rows[name] = p25_block_row(name, regs, spill)
    res_rows = broad_resources(report)
    print(f"  broad instances on the card: {json.dumps(res_rows)}",
          flush=True)

    # -- (a) each broad form at a narrow width against its compiled twin,
    # bitwise, on the 1,024 rays and on the 1024^2 volumetric grid (Kerr,
    # DP45, float32: the main path's instances; one launch each, capped at
    # the two-pass drivers' first pass; timed in (d) on the quiet card)
    al_x, th_x = rays["extras"]
    narrow_rows = {}
    for inst in P25_INSTANCES:
        method, dtype, family = inst
        al, th = ((al_x, th_x) if dtype == "float32"
                  else (al_x.double(), th_x.double()))
        for label in P26_NARROW:
            a = p26_launch(family, al, th, label, method, broad=False)
            b = p26_launch(family, al, th, label, method, broad=True)
            same = p26_extras_bitwise(a, b)
            narrow_rows[inst, label] = dict(bitwise=same)
            require(same, f"phase 26 {inst} {label}: the broad form is not "
                          f"bitwise its narrow instance")
    print(f"  every broad form at the narrow widths (spectral 3 bands, "
          f"movie 8 frames, orders 4) bitwise its narrow instance: "
          f"{len(narrow_rows)} pairs", flush=True)
    al_g, th_g = grids["movie"]
    grid_fns = {}
    for label in P26_NARROW:
        grid_fns[label] = fns = {
            broad: functools.partial(p26_launch, "kerr", al_g, th_g, label,
                                     "dp45", broad, DRIVER_PASS1)
            for broad in (False, True)}
        require(p26_extras_bitwise(fns[False](), fns[True]()),
                f"phase 26 1024^2 {label}: the broad form is not bitwise "
                f"its narrow instance")
    print("  every broad form at the narrow widths bitwise its narrow "
          "instance on the 1024^2 volumetric grid too", flush=True)

    # -- (b) the paths through the user's entry points --------------------
    paths = {}
    with tempfile.TemporaryDirectory(prefix="lpt_p26_") as out_dir:
        argv = ["volumetric", "--a", "0.9", "--theta-obs", "80", "--fov-v",
                "16", "--size", "1024", "--movie", str(P26_MOVIE),
                "--centroid", os.path.join(out_dir, "w.png"), "--output",
                os.path.join(out_dir, "m.png")]
        cli_main(argv)      # warm-up
        _, paths["movie"] = p26_path(
            f"volumetric --movie {P26_MOVIE} --centroid at 1024^2 "
            f"(the CLI)", lambda: cli_main(argv), ("aux", "launches_broad"),
            card)
        wrote = sorted(os.listdir(out_dir))
    require(len([f for f in wrote if f.startswith("m_")
                 and f.endswith(".png")]) == P26_MOVIE
            and "w.csv" in wrote, f"phase 26 movie: wrote {wrote}")
    scene = p24_scene()
    cfg = RenderConfig()
    (img3, st3), paths["three planes"] = p26_path(
        "render_multi_disk, three translucent planes, 1024^2",
        lambda: dm.render_multi_disk(scene, P24_DIM, cfg, p26_planes(),
                                     device=dev),
        ("disk", "launches_broad"), card)
    require(bool(torch.isfinite(img3).all())
            and all(p > 0 for p in st3["disk_pixels_per_plane"]),
            f"phase 26 three planes: {st3.get('disk_pixels_per_plane')}")
    (layers, st9), paths["orders 9"] = p26_path(
        "render_disk_decomposed, 9 orders (disk --decompose --orders 9), "
        "1024^2", lambda: dm.render_disk_decomposed(
            scene, P24_DIM, cfg, dm.DiskConfig(), n_orders=9, device=dev),
        ("disk", "launches_planes"), card)
    require(layers.shape[0] == 9 and bool(torch.isfinite(layers).all())
            and st9["flux_per_order"][0] > st9["flux_per_order"][1] > 0,
            f"phase 26 9 orders: {st9['flux_per_order']}")

    # -- (c) every broad instance against its plain loop on the card -----
    print(f"broad instances ({len(P25_INSTANCES)} pairs, dtypes and "
          f"families x {len(P26_FORMS)} forms, {P26_RAYS} rays, capped at "
          f"{P26_STEPS}, sat_window {P26_WINDOW}) against the plain loop, "
          f"bitwise:", flush=True)
    rows, sat_exits = {}, 0
    for inst in P25_INSTANCES:
        method, dtype, family = inst
        al, th = ((al_x, th_x) if dtype == "float32"
                  else (al_x.double(), th_x.double()))
        for label in P26_FORMS:
            probe = {}
            rk = p26_trace(family, al, th, label, method, probe=probe)
            plain_ms, rp = PlainPool.result(jobs[inst, label], dev)
            same = p26_extras_bitwise(rk, rp)
            fl = probe["flags"].cpu().numpy()
            row = dict(bitwise=same, plain_ms=plain_ms,
                       attempts_sum=int(probe["attempts"].to(
                           torch.int64).sum()),
                       saturation_exits=int(((fl & 2) != 0).sum()),
                       unconverged=int((fl & 1).sum()))
            kind, width, _ab = P26_FORMS[label]
            if kind == "order" and not same:
                # the plain loop's own buckets may flip at an edge
                xk = np.stack([e.double().cpu().numpy()
                               for e in rk.extras[-width:]])
                xp = np.stack([e.double().cpu().numpy()
                               for e in rp.extras[-width:]])
                g = order_numbers(xk, xp)
                row.update(order_gate=order_gate(g), **g)
                same = row["order_gate"]
            sat_exits += row["saturation_exits"]
            rows[inst, label] = row
            print(f"  {method} {dtype} {family} {label}: {json.dumps(row)}",
                  flush=True)
            require(same, f"phase 26 {inst} {label}: {row}")
    require(sat_exits > 0, "phase 26: no ray ended by the saturation "
                           "exit")
    print("  the equatorial 12 slots and the three planes against the "
          "plain loop, bitwise:", flush=True)
    al_k, th_k = rays["disk"]
    disk_rows = {}
    for method, dtype in P26_DISK_INSTANCES:
        al, th = ((al_k, th_k) if dtype == "float32"
                  else (al_k.double(), th_k.double()))
        for name in P26_DISK_SETS:
            probe = {}
            before = (kk.trace_disk_rays_cuda.launches_broad
                      + kk.trace_disk_rays_cuda.launches_broad_f64
                      + kk.trace_disk_rays_cuda.launches_broad_dop853
                      + kk.trace_disk_rays_cuda.launches_broad_dop853_f64)
            rk = p26_disk(al, th, name, method, probe=probe)
            broad = (kk.trace_disk_rays_cuda.launches_broad
                     + kk.trace_disk_rays_cuda.launches_broad_f64
                     + kk.trace_disk_rays_cuda.launches_broad_dop853
                     + kk.trace_disk_rays_cuda.launches_broad_dop853_f64
                     - before)
            plain_ms, rp = PlainPool.result(jobs[method, dtype, name], dev)
            bad = p25_bitwise(rk, rp)
            row = dict(bitwise=not bad, differing=bad, plain_ms=plain_ms,
                       broad_launches=broad,
                       hits=[int((r.n_hits > 0).sum()) for r in rk],
                       slots_filled=[int(r.n_hits.max()) for r in rk],
                       attempts_sum=int(probe["attempts"].to(
                           torch.int64).sum()),
                       accepted_sum=int(probe["accepted"].to(
                           torch.int64).sum()),
                       crossings=[int(r.n_hits.to(torch.int64).sum())
                                  for r in rk])
            disk_rows[method, dtype, name] = row
            print(f"  {method} {dtype} kerr {name}: {json.dumps(row)}",
                  flush=True)
            require(not bad and all(h > 0 for h in row["hits"])
                    and broad == (1 if name == "three planes" else 0),
                    f"phase 26 {method} {dtype} {name}: {row}")

    # -- the main paths' shapes: the broad movie at P26_MOVIE frames on the
    # 1024^2 volumetric grid (thin, the renders' saturation window) and the
    # three planes on config 4's 1024^2 disk grid, each against its plain
    # loop (children queued ahead of the phase), both capped at GRID_STEPS
    movie_label = f"movie {P26_MOVIE} thin"
    al4, th4 = grids["three planes"]
    grid_rows = {}
    probe = {}
    rk = p26_trace("kerr", al_g, th_g, movie_label, "dp45",
                   max_steps=GRID_STEPS, sat_window=window, probe=probe)
    plain_ms, rp = PlainPool.result(grid_jobs["movie"], dev)
    same = p26_extras_bitwise(rk, rp)
    fl = probe["flags"].cpu().numpy()
    att = probe["attempts"].to(torch.int64)
    grid_rows["movie"] = row = dict(
        bitwise=same, plain_ms=plain_ms, n=int(al_g.numel()),
        max_steps=GRID_STEPS, sat_window=window,
        attempts_sum=int(att.sum()), slowest_attempts=int(att.max()),
        unconverged=int((fl & 1).sum()),
        max_abs=max(float((x.double() - y.double()).abs().nan_to_num()
                          .max()) for x, y in zip(aux_outputs(rk),
                                                  aux_outputs(rp))))
    print(f"  1024^2 volumetric grid, dp45 float32 kerr {movie_label}, "
          f"both capped at {GRID_STEPS}: {json.dumps(row)}", flush=True)
    require(same, f"phase 26 1024^2 {movie_label}: {row}")
    probe = {}
    rk = p26_disk(al4, th4, "three planes", "dp45", max_steps=GRID_STEPS,
                  probe=probe)
    plain_ms, rp = PlainPool.result(grid_jobs["three planes"], dev)
    bad = p25_bitwise(rk, rp)
    grid_rows["three planes"] = row = dict(
        bitwise=not bad, differing=bad, plain_ms=plain_ms,
        n=int(al4.numel()), max_steps=GRID_STEPS,
        hits=[int((r.n_hits > 0).sum()) for r in rk],
        slots_filled=[int(r.n_hits.max()) for r in rk],
        attempts_sum=int(probe["attempts"].to(torch.int64).sum()),
        slowest_attempts=int(probe["attempts"].max()),
        accepted_sum=int(probe["accepted"].to(torch.int64).sum()),
        crossings=[int(r.n_hits.to(torch.int64).sum()) for r in rk])
    print(f"  1024^2 disk grid, dp45 float32 kerr three planes, both capped "
          f"at {GRID_STEPS}: {json.dumps(row)}", flush=True)
    require(not bad and all(h > 0 for h in row["hits"]),
            f"phase 26 1024^2 three planes: {row}")

    # -- (d) times on the quiet card: the narrow widths' broad forms
    # against their narrow twins on the 1024^2 grid in turns (narrow,
    # broad, broad, narrow), each broad instance and the broad plane
    # recorder alone, the main path's instance beside its plain time
    grid_ratio = {}
    for label, fns in grid_fns.items():
        ms = {False: [], True: []}
        for broad in (False, True, True, False):
            ms[broad].append(kernel_alone_ms(fns[broad], 1))
        grid_ratio[label] = dict(
            narrow_ms=float(np.mean(ms[False])),
            broad_ms=float(np.mean(ms[True])),
            broad_over_narrow=float(np.mean(ms[True]) / np.mean(ms[False])))
    # the broad movie at P26_MOVIE frames on the same grid, against the
    # narrow movie at 8 (the widest compiled one)
    movie = kernel_alone_ms(functools.partial(
        p26_launch, "kerr", al_g, th_g, movie_label, "dp45",
        True, DRIVER_PASS1), 2)
    grid_ratio[movie_label] = dict(
        broad_ms=movie,
        over_narrow_movie_8=movie / grid_ratio["movie 8 thin"]["narrow_ms"])
    print(f"  1024^2 volumetric grid (Kerr, DP45, float32, capped at "
          f"{DRIVER_PASS1}), broad against narrow, kernel alone in turns: "
          f"{json.dumps(grid_ratio)} on {card}", flush=True)
    # the main paths' launches alone: the movie and the three planes as
    # checked above (capped at GRID_STEPS), and the movie as the two-pass
    # driver's first pass launches it (capped at DRIVER_PASS1, the
    # renders' window), each with its probe's attempts
    grid_rows["movie"]["ms"] = kernel_alone_ms(functools.partial(
        p26_trace, "kerr", al_g, th_g, movie_label, "dp45",
        max_steps=GRID_STEPS, sat_window=window), 3)
    grid_rows["three planes"]["ms"] = kernel_alone_ms(functools.partial(
        p26_disk, al4, th4, "three planes", "dp45", max_steps=GRID_STEPS),
        3)
    probe = {}
    p26_launch("kerr", al_g, th_g, movie_label, "dp45", True, DRIVER_PASS1,
               window, probe)
    att = probe["attempts"].to(torch.int64)
    pass1 = dict(max_steps=DRIVER_PASS1, sat_window=window,
                 attempts_sum=int(att.sum()),
                 slowest_attempts=int(att.max()),
                 ms=kernel_alone_ms(functools.partial(
                     p26_launch, "kerr", al_g, th_g, movie_label, "dp45",
                     True, DRIVER_PASS1, window), 2))
    pass1["bound_ms"], pass1["bound_by"] = bounds.flops_bound_ms(
        pass1["attempts_sum"] * bounds.broad_work("movie", P26_MOVIE),
        int(al_g.numel()) * P26_MOVIE_BYTES)
    grid_rows["movie"]["pass1"] = pass1
    main_ms = {k: r["ms"] for k, r in grid_rows.items()}
    print(f"  the main paths' launches alone at 1024^2 (capped at "
          f"{GRID_STEPS}), ms: {json.dumps(main_ms)}; the movie as the "
          f"driver's first pass launches it: {json.dumps(pass1)} on {card}",
          flush=True)
    # the broad recorder's PlaneList against the PlaneSet instances on one
    # and two planes, in turns
    list_vs_set = {}
    for method in ("dp45", "dop853"):
        for name in P26_LIST_SETS:
            list_vs_set[f"{name} {method}"] = row = p26_list_vs_set(
                al4, th4, name, method)
            require(row["bitwise"], f"phase 26: the PlaneList differs from "
                                    f"the PlaneSet ({name} {method}): {row}")
    print(f"  PlaneList against PlaneSet on one and two planes (1024^2 disk "
          f"grid, capped at {GRID_STEPS}), kernel alone ms: "
          f"{json.dumps(list_vs_set)} on {card}", flush=True)
    for inst in P25_INSTANCES:
        method, dtype, family = inst
        al, th = ((al_x, th_x) if dtype == "float32"
                  else (al_x.double(), th_x.double()))
        for label in P26_FORMS:
            rows[inst, label]["ms"] = kernel_alone_ms(
                functools.partial(p26_trace, family, al, th, label, method),
                3)
    # each disk check against the instance it extends, in turns
    for method, dtype in P26_DISK_INSTANCES:
        al, th = ((al_k, th_k) if dtype == "float32"
                  else (al_k.double(), th_k.double()))
        for name, base in (("three planes", "two planes"),
                           ("12 slots", "8 slots")):
            ms = {name: [], base: []}
            for n in (base, name, name, base):
                ms[n].append(kernel_alone_ms(functools.partial(
                    p26_disk, al, th, n, method), 3))
            disk_rows[method, dtype, name].update(
                ms=float(np.mean(ms[name])), base=base,
                base_ms=float(np.mean(ms[base])),
                over_base=float(np.mean(ms[name]) / np.mean(ms[base])))
    pairs = {" ".join(k): [r["ms"], r["base_ms"]]
             for k, r in disk_rows.items()}
    print(f"  disk checks alone against the instance each extends, ms: "
          f"{json.dumps(pairs)} on {card}", flush=True)
    times = {" ".join(k[0]) + " " + k[1]: [r["ms"], r["plain_ms"]]
             for k, r in rows.items()}
    print(f"  kernel alone and plain loop, ms: {json.dumps(times)} on "
          f"{card}", flush=True)
    print(f"phase 26: {time.perf_counter() - t_phase:.1f} s", flush=True)

    # The entries, each timed, checked and bounded at its path's shape:
    # the broad movie (Kerr, DP45, float32) on the 1024^2 volumetric grid
    # with the CLI path's launches, and the broad plane recorder (float32
    # DP45) on the 1024^2 disk grid with the three-plane render's; both
    # capped at GRID_STEPS, their bounds from the probes' attempts.
    gm = grid_rows["movie"]
    entry = kernel_entry(
        "kerr_dp45_broad", BROAD_SOURCE, f"{VOL_JAX}:276",
        paths["movie"]["launches"].get("aux.launches_broad", 0),
        gm["max_abs"], gm["ms"], gm["plain_ms"], gm["n"], P26_MOVIE_BYTES,
        gm["attempts_sum"] * bounds.broad_work("movie", P26_MOVIE),
        gm, instance="kerr_dp45_broad<BroadMovie<absorbing=0,float>>")
    entry.update(
        max_steps=GRID_STEPS, sat_window=window, bitwise=gm["bitwise"],
        attempts_sum=gm["attempts_sum"], pass1=gm["pass1"],
        bound_state_ms=1e3 * gm["attempts_sum"] * bounds.broad_state_bytes(
            P26_MOVIE) / bounds.PEAK_BYTES,
        instances={" ".join(k[0]) + " " + k[1]: dict(
            ms=r["ms"], plain_ms=r["plain_ms"], bitwise=r["bitwise"],
            attempts_sum=r["attempts_sum"],
            saturation_exits=r["saturation_exits"])
            for k, r in rows.items()},
        narrow_width_bitwise=all(r["bitwise"] for r in narrow_rows.values()),
        grid_1024_broad_vs_narrow=grid_ratio, resources=res_rows,
        paths=paths, build_s=build_s)
    d = grid_rows["three planes"]
    step, crossing = bounds.planes_work((0, 1, 2), record_time=True)
    work = d["attempts_sum"] * kerr_work() + d["accepted_sum"] * step
    for count, per in zip(d["crossings"], crossing):
        work = work + count * per
    # Bytes a ray: alpha, theta in; final_alpha, n_half, status, p_phi,
    # t_end out, and each plane's count and 6 slots of (r, phi, t) (xi
    # too on the two planes with a normal).
    planes_entry = kernel_entry(
        "kerr_dp45_broad_planes", BROAD_PLANES_SOURCE, f"{JAX_KERNELS}:316",
        paths["three planes"]["launches"].get("disk.launches_broad", 0),
        0.0, d["ms"], d["plain_ms"], d["n"],
        8 + 20 + 3 * 4 + 6 * 4 * (3 + 3 + 2), work, d)
    planes_entry.update(
        max_steps=GRID_STEPS, bitwise=d["bitwise"],
        attempts_sum=d["attempts_sum"], accepted_sum=d["accepted_sum"],
        crossings=d["crossings"], resources=list_rows,
        list_vs_set=list_vs_set, instances={" ".join(k): dict(
            ms=r["ms"], plain_ms=r["plain_ms"], bitwise=r["bitwise"],
            base=r["base"], base_ms=r["base_ms"], over_base=r["over_base"],
            slots_filled=r["slots_filled"], crossings=r["crossings"])
            for k, r in disk_rows.items()})
    return [entry, planes_entry]


def p26_vol_grid(dev):
    """The 1024^2 volumetric scene's rays (phases 11-15: 16 deg vertical
    field of view), flattened, float32 on `dev`."""
    import torch
    from light_path_tracer_tpu_torch import camera
    fov = camera.fov_from_vertical(float(np.radians(16.0)), VOL_DIM)
    grid = dict(dtype=torch.float32, device=dev)
    return (camera.build_alpha_lookup(VOL_DIM, fov, **grid).reshape(-1),
            camera.build_theta_lookup(VOL_DIM, fov, **grid).reshape(-1))


def kk_disk(metric, al, th, plane, **kw):
    """The disk trace of `plane` (2 slots) through the kernel wrapper,
    capped as phase 25's random rays."""
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    return kk.trace_disk_rays_cuda(metric, R_OBS, al, th, THETA_DISK,
                                   LAMBDA_MAX, P25_STEPS, plane, 2, **kw)


# -- phase 27: the surface kernel and the lens-map products -------------

SURFACE_SOURCE = "light_path_tracer_tpu_torch/csrc/kerr_surface{}.cu"
# The JAX package's surface trace (an XLA loop there, no Pallas kernel).
SURFACE_REPLACES = "light_path_tracer_tpu/ops/kerr_trace.py:536"
P27_RAYS = 4096
# Attempt caps of the kernel-versus-plain runs: the 4,096 random rays,
# and the 512^2 grid (kernel and plain loop alike).
P27_STEPS = 2000
P27_GRID_STEPS = 512
# The CLI's --size default of the map modes, and the card-vs-CPU check.
P27_DIM = (512, 512)
P27_CHECK = (64, 64)
# The families of the surface kernel: Kerr, a charged a = 0 hole (the
# route of Reissner-Nordstrom scenes) and Johannsen-Psaltis.
P27_FAMILIES = {"kerr": dict(M=1.0, a=0.9),
                "kerr_newman": dict(M=1.0, a=0.0, Q=0.6),
                "johannsen_psaltis": JP_ARGS}
P27_INSTANCES = tuple((method, dtype, family, timed)
                      for method in ("dp45", "dop853")
                      for dtype in ("float32", "float64")
                      for family in P27_FAMILIES
                      for timed in (False, True))
# The 512^2 grid's instances held against the plain loop: the map modes'
# (float32, no time) and the arrival-time map's default (float64, time).
P27_GRID_INSTANCES = (("dp45", "float32", False), ("dp45", "float64", True))
# The modes at the CLI's size, and those checked card against CPU.
P27_MODES = ("rings", "scene_rings", "magnification", "caustics",
             "microlens", "time_delay", "time_delay_f64", "shear",
             "find_images")
# A point source of --find-images (degrees), about theta_E / 3 off the
# hole in the default scene.
P27_BETA = (4.0, 1.0)


def p27_metric(family):
    from light_path_tracer_tpu_torch.models import (JohannsenPsaltis, Kerr,
                                                    KerrNewman)
    cls = {"kerr": Kerr, "kerr_newman": KerrNewman,
           "johannsen_psaltis": JohannsenPsaltis}[family]
    return cls(**P27_FAMILIES[family])


def p27_rays(dev, dtype):
    """The 4,096 random rays: alpha in [0.01, 0.2] rad (alpha_crit ~0.05
    at r_obs = 100 M, so both captured and escaped rays), theta
    uniform."""
    import torch
    rng = np.random.default_rng(27)
    al = rng.uniform(0.01, 0.2, P27_RAYS)
    th = rng.uniform(-np.pi, np.pi, P27_RAYS)
    return (torch.tensor(al, dtype=getattr(torch, dtype), device=dev),
            torch.tensor(th, dtype=getattr(torch, dtype), device=dev))


def p27_trace(family, al, th, method, timed, kernel=True,
              max_steps=P27_STEPS, probe=None):
    """One surface trace of `family`'s metric at theta_obs 80 deg, the
    sphere at its capture radius: the CUDA wrapper (kernel) or the plain
    loop on the rays' device."""
    from light_path_tracer_tpu_torch.ops.cuda import surface_kernel as sk
    from light_path_tracer_tpu_torch.ops.kerr_trace import (
        trace_rays_surface)
    metric = p27_metric(family)
    args = (metric, R_OBS, al, th, THETA_DISK,
            float(metric.capture_radius()), LAMBDA_MAX, max_steps)
    kw = dict(method=method, record_time=timed)
    if kernel:
        return sk.trace_rays_surface_cuda(*args, probe=probe, **kw)
    return trace_rays_surface(*args, **kw)


def p27_grid(dev, dtype):
    """The 512^2 grid of the map modes' scene (Kerr a = 0.9, theta_obs
    90 deg, 40 deg FOV): alpha and theta, every pixel."""
    import torch
    from light_path_tracer_tpu_torch import camera
    fov = camera.fov_from_vertical(np.radians(40.0), P27_DIM)
    g = dict(dtype=getattr(torch, dtype), device=dev)
    return (camera.build_alpha_lookup(P27_DIM, fov, **g).reshape(-1),
            camera.build_theta_lookup(P27_DIM, fov, **g).reshape(-1))


def p27_grid_trace(al, th, method, timed, kernel=True, probe=None):
    """The map modes' surface trace of the 512^2 grid, capped at
    P27_GRID_STEPS attempts."""
    from light_path_tracer_tpu_torch.models import Kerr
    from light_path_tracer_tpu_torch.ops.cuda import surface_kernel as sk
    from light_path_tracer_tpu_torch.ops.kerr_trace import (
        trace_rays_surface)
    metric = Kerr(M=1.0, a=0.9)
    args = (metric, R_OBS, al, th, np.pi / 2,
            float(metric.capture_radius()), LAMBDA_MAX, P27_GRID_STEPS)
    kw = dict(method=method, record_time=timed)
    if kernel:
        return sk.trace_rays_surface_cuda(*args, probe=probe, **kw)
    return trace_rays_surface(*args, **kw)


def p27_bitwise(rk, rp):
    """Every field of two SurfaceResults bitwise (NaN == NaN)."""
    return all(same_bits(a.cpu(), b.cpu()) for a, b in zip(rk, rp))


def p27_max_abs(rk, rp):
    """The largest |difference| of the float fields where both are
    finite."""
    import torch
    worst = 0.0
    for a, b in zip(rk, rp):
        if not a.dtype.is_floating_point or a.dim() == 0:
            continue
        a, b = a.cpu().double(), b.cpu().double()
        ok = torch.isfinite(a) & torch.isfinite(b)
        if bool(ok.any()):
            worst = max(worst, float((a - b)[ok].abs().max()))
    return worst


def p27_scene(**kw):
    from light_path_tracer_tpu_torch.utils.config import SceneConfig
    return SceneConfig(**dict(dict(M=1.0, a=0.9, r_obs_mult=R_OBS), **kw))


def p27_render(mode, dim, device, method="dp45", scene_kw=None):
    """One map mode of the `lens` / `shadow` CLI through its entry point
    on `device`: (maps as float64 NumPy arrays by name, stats). The
    scene: Kerr a = 0.9 at r_obs 100 M, 40 deg FOV (the CLI's defaults
    but the spin); float32 'fast' but time_delay_f64 and the stencils of
    find_images."""
    from light_path_tracer_tpu_torch import images, pipeline
    from light_path_tracer_tpu_torch.utils.config import RenderConfig
    scene = p27_scene(**(scene_kw or {}))
    cfg = RenderConfig(integrator=method,
                       dtype="float64" if mode == "time_delay_f64"
                       else "float32")

    def arr(x):
        return np.asarray(x.cpu() if hasattr(x, "cpu") else x, np.float64)
    if mode == "rings":
        masks, comp, st = pipeline.render_rings(scene, dim, cfg,
                                                device=device)
        return {"masks": arr(masks), "composite": arr(comp)}, st
    if mode == "scene_rings":
        src = np.random.default_rng(5).random((*dim, 3)).astype(np.float32)
        layers, img, st = pipeline.render_scene_rings(scene, src, cfg,
                                                      device=device)
        return {"layers": arr(layers)}, st
    if mode == "magnification":
        mu, st = pipeline.render_magnification(scene, dim, cfg,
                                               device=device)
        return {"mu": arr(mu)}, st
    if mode == "caustics":
        a, _ext, st = pipeline.render_caustics(scene, dim, cfg,
                                               device=device)
        return {"A": arr(a)}, st
    if mode == "microlens":
        _u, curve, st = pipeline.render_microlens_curve(scene, dim, cfg,
                                                        device=device)
        return {"curve": arr(curve)}, st
    if mode in ("time_delay", "time_delay_f64"):
        tau, st = pipeline.render_time_delay(scene, dim, cfg, device=device)
        return {"tau": arr(tau), "beta_x": st.pop("beta_x"),
                "beta_y": st.pop("beta_y")}, st
    if mode == "shear":
        maps, st = pipeline.render_shear(scene, dim, cfg, device=device)
        return {k: arr(v) for k, v in maps.items()}, st
    imgs, st = images.find_point_images(
        scene, tuple(np.radians(P27_BETA)), resolution=dim, cfg=cfg,
        device=device)
    return {"images": np.array([[im.py, im.px, im.mu, im.tau, im.winding]
                                for im in imgs]).reshape(-1, 5)}, st


def p27_calm(*maps):
    """Pixels whose 3x3 neighbourhood is finite in every map."""
    ok = np.ones(maps[0].shape, bool)
    for m in maps:
        p = np.pad(np.isfinite(m), 1, constant_values=False)
        for dy in range(3):
            for dx in range(3):
                ok &= p[dy:dy + m.shape[0], dx:dx + m.shape[1]]
    return ok


def p27_check(mode, og, oc):
    """A 64^2 mode on the card against the CPU: the masks (rings) on
    >= 99 % of pixels; float32 maps p99 |d| < 1e-3 of the CPU map's
    largest value, the magnification and shear maps on pixels with a
    finite 3x3 neighbourhood in both, the finite masks on >= 99 %;
    float64 maps (time_delay_f64) the finite masks equal and p99 |d| <
    1e-9 of the largest value; find_images the same images within 1e-6
    px and mu, tau within 1e-6 relative."""
    row = {}
    for name, c in oc.items():
        g = og[name]
        if name == "images":
            ok = g.shape == c.shape and (g.size == 0 or (
                np.abs(g[:, :2] - c[:, :2]).max() < 1e-6
                and np.allclose(g[:, 2:4], c[:, 2:4], rtol=1e-6,
                                atol=1e-9)
                and np.array_equal(g[:, 4], c[:, 4])))
            row[name] = dict(n=int(c.shape[0]), ok=bool(ok))
            continue
        if name in ("masks", "composite", "layers"):
            agree = float((g == c).all(axis=0).mean() if name == "masks"
                          else (np.abs(g - c) < 1e-6).mean())
            row[name] = dict(agree=agree, ok=agree >= 0.99)
            continue
        f64 = mode == "time_delay_f64"
        sel = (p27_calm(g, c) if name in ("mu", "kappa", "gamma1", "gamma2",
                                          "omega", "gamma")
               else np.isfinite(g) & np.isfinite(c))
        scale = float(np.abs(c[sel]).max()) if sel.any() else 1.0
        d = np.abs(g - c)[sel] / max(scale, 1e-300)
        p99 = float(np.percentile(d, 99)) if d.size else 0.0
        mask = float((np.isfinite(g) == np.isfinite(c)).mean())
        ok = (mask == 1.0 and p99 < 1e-9) if f64 else (
            mask >= 0.99 and p99 < 1e-3)
        row[name] = dict(p99=p99, max=float(d.max()) if d.size else 0.0,
                         mask=mask, n=int(sel.sum()), ok=bool(ok))
    return row


def p27_counters():
    """The wrappers and plain loops the map modes run through."""
    from light_path_tracer_tpu_torch.ops import kerr_trace
    from light_path_tracer_tpu_torch.ops import schwarzschild_trace
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    from light_path_tracer_tpu_torch.ops.cuda import schwarzschild_kernel
    from light_path_tracer_tpu_torch.ops.cuda import surface_kernel as sk
    return dict(kerr=kk.trace_rays_kerr_cuda,
                orbit=schwarzschild_kernel.trace_rays_schwarzschild_cuda,
                surface=sk.trace_rays_surface_cuda,
                plain_surface=kerr_trace.trace_rays_surface,
                plain_kerr=kerr_trace.trace_rays_kerr,
                plain_orbit=schwarzschild_trace.trace_rays_schwarzschild)


def p27_zero():
    """Every count the map modes read, set to 0."""
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    from light_path_tracer_tpu_torch.ops.cuda import surface_kernel as sk
    c = p27_counters()
    kk.zero_counters(c["kerr"])
    sk.zero_counters()
    c["orbit"].launches = c["orbit"].launches_f64 = 0
    for k in ("plain_surface", "plain_kerr", "plain_orbit"):
        c[k].launches = 0


def p27_counts():
    """The counts since p27_zero: every surface instance's counter, the
    Kerr and orbit kernels' launches and the plain loops' calls."""
    from light_path_tracer_tpu_torch.ops.cuda import surface_kernel as sk
    c = p27_counters()
    out = sk.launches()
    out.update(kerr=c["kerr"].launches + c["kerr"].launches_f64,
               orbit=c["orbit"].launches + c["orbit"].launches_f64,
               plain=sum(c[k].launches for k in (
                   "plain_surface", "plain_kerr", "plain_orbit")))
    return out


def p27_counter(method, dtype, family, timed):
    """The launch counter of one surface instance."""
    import torch
    from light_path_tracer_tpu_torch.ops.cuda import surface_kernel as sk
    code = {"kerr": 0, "kerr_newman": 1, "johannsen_psaltis": 2}[family]
    return sk.instance_counter(getattr(torch, dtype), method, code, timed)


def p27_cli(tmp, size, device):
    """Each map mode through the CLI a user runs (`shadow --rings`, `lens
    --rings` on a random 8-bit source image, `lens --magnification`,
    `--shear`, `--caustics`, `--microlens`, `--time-delay` in float64,
    `--find-images`) at `size`, Kerr a = 0.9, writing into `tmp`: {mode:
    dict(rc, the files it should write that exist, the launches of the
    run (the counts zeroed just before, read just after))}."""
    from light_path_tracer_tpu_torch.cli import main as cli_main
    from light_path_tracer_tpu_torch.utils.save import write_png
    src = os.path.join(tmp, "src.png")
    write_png(src, (np.random.default_rng(5).random((size, size, 3))
                    * 255).astype(np.uint8))

    def out(name):
        return os.path.join(tmp, name)
    runs = {
        "shadow --rings": (["shadow", "--rings", "--output", out("r.png")],
                           ["r.png", "r_order0.png", "r_order3plus.png",
                            "r_shadow.png"]),
        "lens --rings": (["lens", "--rings", "--image", src, "--output",
                          out("l.png")],
                         ["l.png", "l_order0.png", "l_orderge3.png"]),
        "lens --magnification": (["lens", "--magnification",
                                  out("mu.png")], ["mu.png"]),
        "lens --shear": (["lens", "--shear", out("s.png")],
                         ["s_kappa.png", "s_gamma.png", "s_gamma1.png",
                          "s_omega.png", "s.npz"]),
        "lens --caustics": (["lens", "--caustics", out("c.png")],
                            ["c.png"]),
        "lens --microlens": (["lens", "--microlens", out("ml.csv")],
                             ["ml.csv"]),
        "lens --time-delay": (["lens", "--time-delay", out("t.png"),
                               "--dtype", "float64"], ["t.png"]),
        "lens --find-images": (["lens", "--find-images",
                                ",".join(str(b) for b in P27_BETA)], []),
    }
    rows = {}
    for mode, (argv, files) in runs.items():
        p27_zero()
        rc = cli_main([*argv, "--size", str(size), "--a", "0.9",
                       "--device", device])
        counts = p27_counts()
        rows[mode] = dict(rc=rc, files=sum(os.path.exists(out(f))
                                           for f in files),
                          want=len(files),
                          launches=sum(v for k, v in counts.items()
                                       if k != "plain"),
                          plain=counts["plain"])
    return rows


def queue_phase27(pool, dev):
    """Queue phase 27's plain loops on the card (each instance on the
    4,096 rays; the 512^2 grid for P27_GRID_INSTANCES) and its 64^2 CPU
    renders; returns the jobs by key."""
    jobs = {}
    for inst in P27_INSTANCES:
        method, dtype, family, timed = inst
        al, th = p27_rays(dev, dtype)
        jobs[inst] = pool.submit("p27_trace", family, al, th, method, timed,
                                 kernel=False)
    for method, dtype, timed in P27_GRID_INSTANCES:
        al, th = p27_grid(dev, dtype)
        jobs["grid", dtype] = pool.submit("p27_grid_trace", al, th, method,
                                          timed, kernel=False)
    for mode in P27_MODES:
        jobs["cpu", mode] = pool.submit("p27_render", mode, P27_CHECK,
                                        "cpu", on="cpu")
    return jobs


def surface_phase(dev, card, pool, ctx):
    """Phase 27; returns the kernels-line entries of the surface kernel's
    instances."""
    import tempfile
    import torch
    from light_path_tracer_tpu_torch.ops.cuda import _build
    t_phase = time.perf_counter()
    jobs = ctx["jobs"]
    lib, build_s = ctx["build"].result()
    print(f"  surface library: built in {build_s:.1f} s at nice 19 beside "
          f"phases 11 on ({len(_build._sources('surface'))} sources)",
          flush=True)
    for name, regs, spill in ptxas_report(lib.build_log):
        print(f"  ptxas: {name}: {regs} registers; {spill}", flush=True)

    # -- (a) every instance on the 4,096 random rays, bitwise its plain
    # loop on the card (the plain loop in a child)
    rows, kernel_rows = {}, {}
    for inst in P27_INSTANCES:
        method, dtype, family, timed = inst
        al, th = p27_rays(dev, dtype)
        probe = {}
        rk = p27_trace(family, al, th, method, timed, probe=probe)
        plain_ms, rp = PlainPool.result(jobs[inst], dev)
        same = p27_bitwise(rk, rp)
        att = probe["attempts"].to(torch.int64)
        st = rk.status.cpu()
        rows[inst] = dict(bitwise=same, plain_ms=plain_ms,
                          escaped=int((st == 1).sum()),
                          captured=int((st == -1).sum()),
                          attempts_sum=int(att.sum()),
                          slowest_attempts=int(att.max()))
        kernel_rows[inst] = (rk, rp, plain_ms, int(att.sum()),
                             _frozen(lambda: p27_trace(family, al, th,
                                                       method, timed)))
        require(same, f"phase 27 {inst}: the surface kernel is not "
                      f"bitwise its plain loop: {rows[inst]} "
                      f"max |d| {p27_max_abs(rk, rp)}")
        require(rows[inst]["escaped"] > 100 and rows[inst]["captured"] > 100,
                f"phase 27 {inst}: {rows[inst]}")
    print(f"  every surface instance bitwise its plain loop on the card "
          f"(4,096 rays, capped at {P27_STEPS}): "
          f"{json.dumps({str(k): v for k, v in rows.items()})}", flush=True)

    # -- (b) the 512^2 grid of the map modes, bitwise its plain loop
    grid_rows = {}
    for method, dtype, timed in P27_GRID_INSTANCES:
        al, th = p27_grid(dev, dtype)
        probe = {}
        rk = p27_grid_trace(al, th, method, timed, probe=probe)
        plain_ms, rp = PlainPool.result(jobs["grid", dtype], dev)
        same = p27_bitwise(rk, rp)
        att = probe["attempts"].to(torch.int64)
        grid_rows[dtype] = dict(bitwise=same, plain_ms=plain_ms,
                                attempts_sum=int(att.sum()),
                                slowest_attempts=int(att.max()),
                                at_cap=int((att >= P27_GRID_STEPS).sum()))
        kernel_rows["grid", dtype] = (
            rk, rp, plain_ms, int(att.sum()),
            _frozen(lambda: p27_grid_trace(al, th, method, timed)))
        require(same, f"phase 27 512^2 {dtype}: the surface kernel is not "
                      f"bitwise its plain loop: {grid_rows[dtype]}")
    print(f"  the 512^2 grid, capped at {P27_GRID_STEPS}, bitwise its plain "
          f"loop: {json.dumps(grid_rows)}", flush=True)

    # -- (c) each mode at 64^2 on the card against the CPU
    checks = {}
    for mode in P27_MODES:
        og, _ = p27_render(mode, P27_CHECK, "cuda")
        _ms, (oc, _st) = PlainPool.result(jobs["cpu", mode], "cpu")
        checks[mode] = p27_check(mode, og, oc)
        require(all(v["ok"] for v in checks[mode].values()),
                f"phase 27 64^2 {mode} card vs CPU: {checks[mode]}")
    print(f"  each mode at 64^2, card vs CPU: {json.dumps(checks)}",
          flush=True)

    # -- (d) each mode at the CLI's 512^2 through its entry point, warm-up
    # and 3 frames, the counts zeroed just before and read just after
    frames = {}
    for mode in P27_MODES:
        p27_render(mode, P27_DIM, "cuda")
        p27_zero()
        runs = []
        for _ in range(3):
            maps, st = p27_render(mode, P27_DIM, "cuda")
            runs.append(st["timings"])
        counts = p27_counts()
        t = min(runs, key=lambda r: r["total"])
        traced = st.get("traced_rays")
        frames[mode] = dict(
            frame_ms=1e3 * t["total"],
            precompute_ms=1e3 * t.get("precompute", 0.0),
            rays_per_s=traced / t["precompute"] if traced else None,
            traced_rays=traced,
            integrator_steps=st.get("integrator_steps"),
            counts={k: v for k, v in counts.items() if v})
        surface_modes = mode not in ("rings", "scene_rings", "magnification")
        launched = (sum(v for k, v in counts.items()
                        if k.startswith("launches")) if surface_modes
                    else counts["kerr"])
        require(launched >= 3 and counts["plain"] == 0,
                f"phase 27 {mode} at 512^2: kernel launches {launched}, "
                f"plain-loop calls {counts['plain']}")
        finite = [np.isfinite(v).mean() for v in maps.values()
                  if isinstance(v, np.ndarray) and v.size]
        require(all(f > 0.5 for f in finite),
                f"phase 27 {mode} at 512^2: finite shares {finite}")
    print(f"  each mode at 512^2 through its entry point (best of 3 after "
          f"a warm-up): {json.dumps(frames)} on {card}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        cli = p27_cli(tmp, P27_DIM[0], "cuda")
    print(f"  each mode through the CLI at 512^2: {json.dumps(cli)}",
          flush=True)
    require(all(r["rc"] == 0 and r["files"] == r["want"]
                and r["launches"] > 0 and r["plain"] == 0
                for r in cli.values()), f"phase 27 CLI: {cli}")
    require(frames["find_images"]["counts"] and len(
        p27_render("find_images", P27_DIM, "cuda")[0]["images"]) >= 1,
        "phase 27: find_images found no image at 512^2")
    prof = device_profile(lambda: p27_render("caustics", P27_DIM, "cuda"),
                          3, "surface", lambda: p27_counts()[
                              p27_counter("dp45", "float32", "kerr",
                                          False)])
    print(f"  the 512^2 caustics frame under torch.profiler (3 frames): "
          f"{json.dumps(prof)}", flush=True)

    # -- (e) each instance on a path of its own through the entry points:
    # find_images (the float32 coarse grid, float64 stencils with and
    # without the time) and the float32 arrival-time map, each pair and
    # family, at 512^2; then the kernels-line entries
    p27_zero()
    for method in ("dp45", "dop853"):
        for family, kw in (("kerr", {}), ("kerr_newman",
                                          dict(a=0.0, Q=0.6)),
                           ("johannsen_psaltis", dict(eps3=2.0))):
            for mode in ("find_images", "time_delay"):
                p27_render(mode, P27_DIM, "cuda", method=method,
                           scene_kw=kw)
    counts = p27_counts()
    print(f"  the instances' own paths (find_images and the float32 "
          f"arrival-time map at 512^2, each pair and family): "
          f"{json.dumps(counts)}", flush=True)
    require(counts["plain"] == 0, f"phase 27: plain-loop calls {counts}")
    # Each instance alone on the quiet card (phase 27's children are done).
    times = {key: kernel_alone_ms(row[4], 5)
             for key, row in kernel_rows.items()}
    print(f"  each instance alone (ms; 4,096 rays, the grid 512^2): "
          f"{json.dumps({str(k): v for k, v in times.items()})} on {card}",
          flush=True)
    entries = []
    suffix = {("dp45", "float32"): "", ("dp45", "float64"): "_f64",
              ("dop853", "float32"): "_dop853",
              ("dop853", "float64"): "_dop853_f64"}
    for inst in P27_INSTANCES:
        method, dtype, family, timed = inst
        key = ("grid", dtype) if (family == "kerr" and (
            method, dtype, timed) in P27_GRID_INSTANCES) else inst
        rk, rp, plain_ms, att, _fn = kernel_rows[key]
        ms = times[key]
        size = 4 if dtype == "float32" else 8
        entries.append(kernel_entry(
            f"kerr_surface_{method}_{dtype}_{family}"
            + ("_time" if timed else ""),
            SURFACE_SOURCE.format(suffix[method, dtype]), SURFACE_REPLACES,
            counts[p27_counter(method, dtype, family, timed)],
            p27_max_abs(rk, rp),
            ms, plain_ms, int(rk.status.numel()),
            2 * size + (5 + 2 + int(timed)) * size + 8,
            att * bounds.surface_work(dtype, family, method, timed)))
    print(f"  [{time.perf_counter() - t_phase:.1f} s] phase 27 done",
          flush=True)
    return entries


# -- phase 28: run-time (M, a, r_obs): pans, spin sweeps, flybys; the
# panoramas and the stellar surface ---------------------------------------

# The Kerr kernel with run-time scalars is row 1's tile kernel with its
# dynamic_params (SMEM (M, a) or (M, a, r_obs)); the hybrid driver over it
# carries them through both passes.
DYN_REPLACES = f"{JAX_KERNELS}:40"
DYN_HYBRID_REPLACES = "light_path_tracer_tpu/ops/kerr_trace.py:1309"
# (a)'s run-time parameters: (M, a) at the static r_obs 100, and (M, a,
# r_obs) with the radius a run-time value too; values whose float32 r_+
# the float64 form does not give exactly.
P28_DYN = {"m_a": (1.0, 0.99), "m_a_r": (1.0, 0.9, 73.5)}
P28_CHARTS = ("theta", "mu")
P28_RAYS = 4096
P28_STEPS = 500
# The main path's frames: 1024^2, Kerr a 0.9, theta_obs 90 deg; an 8-frame
# pan of 2 deg across the hole's column, a spin sweep, an 8-frame flyby
# 200 M -> 20 M with the boost ramped to 0.5 c.
P28_DIM = (1024, 1024)
P28_FRAMES = 8
P28_SPINS = (0.0, 0.5, 0.9, 0.99)
P28_FLY = (200.0, 20.0, 0.5)
# The 1024^2 flyby frame held against the plain loop through the same
# driver, capped at the first pass's 512 attempts.
P28_FRAME_STEPS = 512
# The panoramas (--height) and the stars (--size) of the CLI runs.
P28_PANO_H = 1024
P28_STAR = 1024
P28_PULSE = (64, 128)
# Card against CPU: the modes at 64^2 (the panorama 32 x 64), each
# sequence capped at 1,000 attempts a ray on both (the CPU's plain mu
# chart grinds rays beside the pole to the cap).
P28_CHECK = (64, 64)
P28_CHECK_STEPS = 1000
P28_MODES = ("pan", "spin", "flyby", "flyby_lensed", "pano_kerr",
             "pano_schwarzschild", "star", "pulse")


def p28_rays(dev):
    """Phase 8's 4,096 rays: alpha in [0.01, 0.12] rad, theta uniform."""
    import torch
    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.tensor(rng.uniform(0.01, 0.12, P28_RAYS), **f32),
            torch.tensor(rng.uniform(-np.pi, np.pi, P28_RAYS), **f32))


def p28_poison(form, al, th):
    """The hybrid's poison mask of the rays under P28_DYN[form]."""
    from light_path_tracer_tpu_torch.ops import kerr_trace as tk
    m, r = tk.traced_scalars(None, R_OBS, P28_DYN[form], al.dtype)
    return tk.hybrid_poison(m, r, al, th, np.pi / 2,
                            tk.hybrid_slots(al.numel()))


def p28_trace(chart, form, al, th, kernel=True, probe=None,
              max_steps=P28_STEPS, poison=None):
    """One trace with run-time parameters P28_DYN[form] (the metric and
    radius arguments placeholders) in `chart`: the CUDA wrapper (kernel)
    or the plain loop on the rays' device; the mu chart starts the
    hybrid's poison mask (p28_poison, unless given) INVALID. Returns
    (TraceResult, unconverged)."""
    import torch
    from light_path_tracer_tpu_torch.models import Kerr
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    kw = dict(formulation=chart, return_unconverged=True,
              dynamic_params=P28_DYN[form])
    if chart == "mu":
        kw["force_invalid"] = (p28_poison(form, al, th) if poison is None
                               else poison)
    args = (Kerr(M=1.0, a=0.0), R_OBS, al, th, np.pi / 2,
            torch.zeros(al.shape, dtype=torch.bool, device=al.device),
            LAMBDA_MAX, max_steps)
    if kernel:
        return kk.trace_rays_kerr_cuda(*args, probe=probe, **kw)
    return kk.trace_rays_kerr_plain(*args, **kw)


def p28_frame_rays(dev):
    """The flyby's last 1024^2 frame (r_obs 20 M, boost 0.5 c toward the
    hole): its float32 grids."""
    from light_path_tracer_tpu_torch import camera
    fov = camera.fov_from_vertical(np.radians(40.0), P28_DIM)
    al, th = camera.build_angle_lookups_dynamic(
        P28_DIM, fov, 0.0, 0.0, boost_dynamic=(0.0, 0.0, P28_FLY[2]),
        device=dev)
    return al.reshape(-1), th.reshape(-1)


def p28_frame_trace(al, th, kernel=True, probe=None):
    """That frame through the CUDA hybrid with run-time (M, a, r_obs),
    capped at P28_FRAME_STEPS, over the kernel or (kernel=False) the
    plain loop on the rays' device."""
    import torch
    from light_path_tracer_tpu_torch.models import Kerr
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    return kk.trace_rays_kerr_hybrid(
        Kerr(M=1.0, a=0.0), R_OBS, al, th, np.pi / 2,
        torch.zeros(al.shape, dtype=torch.bool, device=al.device),
        max(LAMBDA_MAX, 6.0 * P28_FLY[0]), P28_FRAME_STEPS,
        pass1_steps=P28_FRAME_STEPS, probe=probe,
        trace_fn=None if kernel else kk.trace_rays_kerr_plain,
        dynamic_params=(1.0, 0.9, P28_FLY[1]))


def p28_bitwise(ra, rb):
    """Two (TraceResult, unconverged) pairs bitwise, field by field."""
    return all(same_bits(a.cpu(), b.cpu()) for a, b in zip(
        tuple(ra[0]) + (ra[1],), tuple(rb[0]) + (rb[1],)))


def p28_scene(**kw):
    from light_path_tracer_tpu_torch.utils.config import SceneConfig
    return SceneConfig(**dict(dict(M=1.0, a=0.9, r_obs_mult=R_OBS), **kw))


def p28_render(mode, dim, device, max_steps=P28_CHECK_STEPS):
    """One phase-28 mode through its entry point on `device` at `dim`:
    a dict of float64 NumPy arrays (the shadow masks, images, final alpha,
    brightness or flux)."""
    import torch
    from light_path_tracer_tpu_torch import pano, sequence, star
    from light_path_tracer_tpu_torch.utils.config import RenderConfig

    def arr(x):
        return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x,
                          np.float64)
    kw = dict(max_steps=max_steps, device=device)
    if mode == "pan":
        f = sequence.render_sequence(p28_scene(), [(0.0, 0.01)],
                                     resolution=dim, **kw)
        return {"mask": arr(f[0])}
    if mode == "spin":
        f = sequence.render_param_sequence(p28_scene(a=0.0),
                                           [(0.0, 0.0, 1.0, 0.99)], dim, **kw)
        return {"mask": arr(f[0])}
    if mode in ("flyby", "flyby_lensed"):
        src = (np.random.default_rng(28).random((*dim, 3)).astype(np.float32)
               if mode == "flyby_lensed" else None)
        f = sequence.render_flyby(
            p28_scene(), [(0.01, 0.0, 40.0, (0.0, 0.0, 0.3))],
            source_image=src, resolution=dim, **kw)
        return {"image" if src is not None else "mask": arr(f[0])}
    if mode.startswith("pano"):
        h = dim[0] // 2
        out = pano.render_panorama(
            p28_scene(a=0.9 if mode == "pano_kerr" else 0.0),
            pano.grid_sky((h, 2 * h)), resolution=(h, 2 * h),
            device=device)
        return {"final_alpha": arr(out.final_alpha), "image": arr(out.image)}
    cfg = RenderConfig()
    if mode == "star":
        img, st = star.render_star(p28_scene(a=0.3), dim, cfg,
                                   device=device)
        return {"image": arr(img), "brightness": arr(st["brightness"])}
    _ph, flux, _st = star.pulse_profile(
        p28_scene(a=0.3), cfg, star.StarConfig(omega=0.05), n_phases=16,
        resolution=dim, light_travel_delay=True, device=device)
    return {"flux": arr(flux)}


def p28_check(mode, og, oc):
    """A 64^2 mode on the card against the CPU: shadow masks (and the
    panoramas' NaN masks) equal on >= 99 % of pixels; images median |d|
    < 1e-3 (a texel flip moves a pixel whole); final alpha p99 |d| <
    1e-3 rad where finite in both; the star's brightness p99 |d| < 1e-2
    of its largest (the spots' sigmoid edges steepen the float32
    rounding that parts the card from the CPU); the pulse's flux within
    1e-3 relative."""
    row = {}
    for name, c in oc.items():
        g = og[name]
        if name == "mask":
            agree = float((g == c).mean())
            row[name] = dict(agree=agree, ok=agree >= 0.99)
        elif name == "final_alpha":
            agree = float((np.isnan(g) == np.isnan(c)).mean())
            both = np.isfinite(g) & np.isfinite(c)
            p99 = float(np.percentile(np.abs(g - c)[both], 99))
            row[name] = dict(agree=agree, p99=p99,
                             ok=agree >= 0.99 and p99 < 1e-3)
        elif name == "image":
            med = float(np.median(np.abs(g - c)))
            row[name] = dict(median=med, ok=med < 1e-3)
        elif name == "brightness":
            d = np.abs(g - c) / max(float(np.abs(c).max()), 1e-300)
            p99 = float(np.percentile(d, 99))
            row[name] = dict(p99=p99, ok=p99 < 1e-2)
        else:
            rel = float(np.max(np.abs(g / c - 1.0)))
            row[name] = dict(max_rel=rel, ok=rel < 1e-3)
    return row


def p28_counters():
    """The wrappers and plain loops phase 28's paths run through."""
    from light_path_tracer_tpu_torch.ops import kerr_trace as tk
    from light_path_tracer_tpu_torch.ops import schwarzschild_trace as st
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    from light_path_tracer_tpu_torch.ops.cuda import schwarzschild_kernel
    from light_path_tracer_tpu_torch.ops.cuda import surface_kernel as sk
    return dict(kerr=kk.trace_rays_kerr_cuda, hybrid=kk.trace_rays_kerr_hybrid,
                orbit=schwarzschild_kernel.trace_rays_schwarzschild_cuda,
                surface=sk.trace_rays_surface_cuda,
                plain=(tk.trace_rays_kerr, tk.trace_rays_surface,
                       st.trace_rays_schwarzschild))


def p28_zero():
    """Every count phase 28's paths read, set to 0."""
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    from light_path_tracer_tpu_torch.ops.cuda import surface_kernel as sk
    c = p28_counters()
    kk.zero_counters(c["kerr"])
    sk.zero_counters()
    c["hybrid"].launches = 0
    c["orbit"].launches = c["orbit"].launches_f64 = 0
    for fn in c["plain"]:
        fn.launches = 0


def p28_counts():
    """The counts since p28_zero: the Kerr kernel's theta and mu launches
    and those with run-time parameters, the hybrid's calls, the orbit and
    surface kernels' launches and the plain loops' calls."""
    from light_path_tracer_tpu_torch.ops.cuda import surface_kernel as sk
    c = p28_counters()
    k = c["kerr"]
    return dict(theta=k.launches, mu=k.launches_mu,
                theta_dynamic=k.dynamic_launches,
                mu_dynamic=k.dynamic_launches_mu,
                hybrid=c["hybrid"].launches, orbit=c["orbit"].launches,
                surface=sum(sk.launches().values()),
                plain=sum(fn.launches for fn in c["plain"]))


def p28_cli(tmp, argv):
    """One CLI run on the card with the counts zeroed just before and read
    just after: (rc, counts, seconds, stdout's last lines)."""
    import contextlib
    import io
    from light_path_tracer_tpu_torch.cli import main as cli_main
    p28_zero()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main([*argv, "--device", "cuda"])
    secs = time.perf_counter() - t0
    return rc, p28_counts(), secs, buf.getvalue().strip().splitlines()


def queue_phase28(pool, dev):
    """Queue phase 28's plain loops on the card ((a)'s four traces, (b)'s
    1024^2 frame through the driver) and its 64^2 CPU renders; returns the
    jobs by key."""
    jobs = {}
    al, th = p28_rays(dev)
    for chart in P28_CHARTS:
        for form in P28_DYN:
            jobs[chart, form] = pool.submit("p28_trace", chart, form, al, th,
                                            kernel=False)
    fa, ft = p28_frame_rays(dev)
    jobs["frame"] = pool.submit("p28_frame_trace", fa, ft, kernel=False)
    for mode in P28_MODES:
        jobs["cpu", mode] = pool.submit("p28_render", mode, P28_CHECK, "cpu",
                                        on="cpu")
    return jobs


def dynamic_phase(dev, card, pool, ctx):
    """Phase 28; returns the kernels-line entries of the Kerr kernel with
    run-time parameters (theta and mu) and of the hybrid driver over it."""
    import tempfile
    import torch
    from light_path_tracer_tpu_torch import pipeline, sequence
    from light_path_tracer_tpu_torch.ops import kerr_trace as tk
    t_phase = time.perf_counter()
    jobs = ctx["jobs"]

    # -- (a) the dynamic launches on 4,096 rays, bitwise their plain loop
    al, th = p28_rays(dev)
    rows, kern = {}, {}
    for chart in P28_CHARTS:
        for form in P28_DYN:
            probe = {}
            # the mask built once, outside the timed launches
            poison = p28_poison(form, al, th) if chart == "mu" else None
            rk = p28_trace(chart, form, al, th, probe=probe, poison=poison)
            plain_ms, rp = PlainPool.result(jobs[chart, form], dev)
            same = p28_bitwise(rk, rp)
            att = probe["attempts"].to(torch.int64)
            st = rk[0].status.cpu()
            rows[f"{chart} {form}"] = dict(
                bitwise=same, plain_ms=plain_ms,
                escaped=int((st == 1).sum()), captured=int((st == -1).sum()),
                invalid=int((st == 0).sum()), attempts_sum=int(att.sum()),
                slowest_attempts=int(att.max()))
            kern[chart, form] = dict(
                plain_ms=plain_ms, attempts=int(att.sum()),
                fn=_frozen(lambda: p28_trace(chart, form, al, th,
                                             poison=poison)))
            require(same, f"phase 28 {chart} {form}: the dynamic launch is "
                          f"not bitwise its plain loop: "
                          f"{rows[f'{chart} {form}']}")
    print(f"  the dynamic launches on phase 8's 4,096 rays (capped at "
          f"{P28_STEPS}) bitwise their plain loop on the card: "
          f"{json.dumps(rows)}", flush=True)

    # -- (b) a 1024^2 flyby frame through the hybrid, bitwise the same
    # driver over the plain loop
    fa, ft = p28_frame_rays(dev)
    probe = {}
    rk = p28_frame_trace(fa, ft, probe=probe)
    plain_ms, rp = PlainPool.result(jobs["frame"], dev)
    same = all(same_bits(a.cpu(), b.cpu()) for a, b in zip(rk, rp))
    frame_ms, _ = cuda_ms(lambda: p28_frame_trace(fa, ft), 3)
    n = int(fa.numel())
    idx, _dest = tk.stragglers(probe["redo"], tk.hybrid_slots(n))
    fb, tb = fa[idx], ft[idx]
    pa, pb = {}, {}
    ms_a = kernel_alone_ms(lambda: p28_trace_pass(
        fa, ft, "mu", probe["poison"], pa), 3)
    ms_b = kernel_alone_ms(lambda: p28_trace_pass(fb, tb, "theta", None,
                                                  pb), 3)
    frame = dict(bitwise=same, n=n, ms=frame_ms, plain_ms=plain_ms,
                 pass_a_ms=ms_a, pass_b_ms=ms_b,
                 poison=int(probe["poison"].sum()),
                 retrace=int(probe["redo"].sum()),
                 unconverged=int(probe["unconverged"].sum()),
                 attempts_a=int(pa["attempts"].to(torch.int64).sum()),
                 attempts_b=int(pb["attempts"].to(torch.int64).sum()),
                 escaped=int((rk.status == 1).sum()),
                 captured=int((rk.status == -1).sum()))
    print(f"  the 1024^2 flyby frame (20 M, 0.5 c) through the hybrid, "
          f"capped at {P28_FRAME_STEPS}, against the plain loop through "
          f"it: {json.dumps(frame)} on {card}", flush=True)
    require(same and frame["captured"] > 0 and frame["escaped"] > 0,
            f"phase 28 1024^2 frame: {frame}")

    # -- (c) a dynamic frame at (M, a) = (1, 0.9) against the static
    # render_shadow with the mirror fold off (JAX's bar: > 99 %)
    from light_path_tracer_tpu_torch.utils.config import RenderConfig
    dyn = sequence.render_param_sequence(p28_scene(a=0.0),
                                         [(0.0, 0.0, 1.0, 0.9)], P28_DIM)[0]
    static, _st = pipeline.render_shadow(
        p28_scene(), P28_DIM, RenderConfig(use_tb_symmetry=False),
        device="cuda")
    agree = float((dyn == static).float().mean())
    print(f"  dynamic (M, a) = (1, 0.9) frame against the static shadow "
          f"(fold off), 1024^2: pixels equal {agree:.6f}", flush=True)
    require(agree > 0.99, f"phase 28 dynamic vs static: {agree}")

    # -- (d) each mode at 64^2 on the card against the CPU
    checks = {}
    for mode in P28_MODES:
        og = p28_render(mode, P28_CHECK, "cuda")
        _ms, oc = PlainPool.result(jobs["cpu", mode], "cpu")
        checks[mode] = p28_check(mode, og, oc)
        require(all(v["ok"] for v in checks[mode].values()),
                f"phase 28 64^2 {mode} card vs CPU: {checks[mode]}")
    print(f"  each mode at 64^2, card vs CPU: {json.dumps(checks)}",
          flush=True)

    # -- (e) the main path at full width through the entry points, each
    # path with its counts zeroed just before and read just after
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        def out(name):
            return os.path.join(tmp, name)
        runs = {
            "animate pan": ["animate", "--a", "0.9", "--size",
                            str(P28_DIM[0]), "--frames", str(P28_FRAMES),
                            "--pan-deg", "2", "--output", out("pan.gif")],
            "animate flyby": ["animate", "--a", "0.9", "--size",
                              str(P28_DIM[0]), "--frames", str(P28_FRAMES),
                              "--flyby", f"{P28_FLY[0]:g}:{P28_FLY[1]:g}",
                              "--boost-to", str(P28_FLY[2]),
                              "--output", out("fly.gif")],
            "pano a=0.9": ["pano", "--a", "0.9", "--grid-sky", "--height",
                           str(P28_PANO_H), "--output", out("p9.png")],
            "pano a=0": ["pano", "--grid-sky", "--height", str(P28_PANO_H),
                         "--output", out("p0.png")],
            "star": ["star", "--size", str(P28_STAR), "--output",
                     out("s.png")],
            "star pulse": ["star", "--pulse-profile", str(P28_PULSE[0]),
                           "--light-travel-delay", "--omega", "0.05",
                           "--size", str(P28_PULSE[1]), "--output",
                           out("pp.npz")]}
        for label, argv in runs.items():
            rc, counts, secs, lines = p28_cli(tmp, argv)
            row = dict(rc=rc, seconds=secs, counts=counts,
                       said=[l for l in lines if l.startswith(
                           ("Animation", "  launches", "Panorama", "Star",
                            "  surface", "Pulse", "  trace_throughput"))])
            if label.startswith("animate"):
                stem = out("pan" if label.endswith("pan") else "fly")
                rec = np.load(f"{stem}_frames.npz")
                row.update(frame_launches=[int(x) for x in rec["launches"]],
                           frame_ms=[float(x) for x in rec["ms"]],
                           files=sum(os.path.exists(f"{stem}_{k:03d}.png")
                                     for k in range(P28_FRAMES)))
                frames = rec["frames"]
                dark = [int((f == 0).sum()) for f in frames]
                row["shadow_px"] = dark
                require(row["files"] == P28_FRAMES
                        and len(set(row["frame_launches"][1:])) == 1
                        and min(row["frame_launches"]) > 0,
                        f"phase 28 {label}: {row}")
            paths[label] = row
            print(f"  {label}: {json.dumps(row)} on {card}", flush=True)
            require(rc == 0 and counts["plain"] == 0,
                    f"phase 28 {label}: {row}")
        pan, fly = paths["animate pan"], paths["animate flyby"]
        require(pan["counts"]["hybrid"] == P28_FRAMES
                and pan["counts"]["mu"] > 0 and pan["counts"]["theta"] > 0,
                f"phase 28 pan path: {pan}")
        require(fly["counts"]["mu_dynamic"] == P28_FRAMES
                and fly["counts"]["theta_dynamic"] == P28_FRAMES
                and fly["shadow_px"][-2] > fly["shadow_px"][0],
                f"phase 28 flyby path: {fly}")
        require(paths["pano a=0.9"]["counts"]["theta"] > 0
                and paths["pano a=0"]["counts"]["orbit"] > 0
                and paths["star"]["counts"]["surface"] > 0
                and paths["star pulse"]["counts"]["surface"] > 0,
                f"phase 28 pano / star paths: {paths}")
    # the spin sweep (no CLI of its own), through its entry point
    p28_zero()
    stats = []
    frames = sequence.render_param_sequence(
        p28_scene(a=0.0), [(0.0, 0.0, 1.0, a) for a in P28_SPINS], P28_DIM,
        frame_stats=stats)
    spin = dict(counts=p28_counts(),
                frame_launches=[s["launches"] for s in stats],
                frame_ms=[s["ms"] for s in stats],
                shadow_px=[int((f == 0).sum()) for f in frames])
    print(f"  spin sweep a = {list(P28_SPINS)} at 1024^2: "
          f"{json.dumps(spin)} on {card}", flush=True)
    require(spin["counts"]["mu_dynamic"] == len(P28_SPINS)
            and spin["counts"]["plain"] == 0
            and len(set(spin["frame_launches"])) == 1
            and not torch.equal(frames[0], frames[-1]),
            f"phase 28 spin sweep: {spin}")
    paths["spin"] = spin
    kerr = p28_counters()["kerr"]
    profs = {label: device_profile(run, 3, "kerr_dp45",
                                   lambda: kerr.launches + kerr.launches_mu)
             for label, run in (
                 ("pan", lambda: sequence.render_sequence(
                     p28_scene(), [(0.0, 0.0)], resolution=P28_DIM)),
                 ("spin a=0.99", lambda: sequence.render_param_sequence(
                     p28_scene(a=0.0), [(0.0, 0.0, 1.0, 0.99)], P28_DIM)),
                 ("flyby 20 M 0.5 c", lambda: sequence.render_flyby(
                     p28_scene(), [(P28_FLY[1], (0.0, 0.0, P28_FLY[2]))],
                     resolution=P28_DIM)))}
    print(f"  a 1024^2 frame of each sequence under torch.profiler (3 "
          f"frames): {json.dumps(profs)} on {card}", flush=True)

    # -- (f) the kernels-line entries: each dynamic instance alone on the
    # 4,096 rays against its plain loop in its child; the driver on the
    # 1024^2 frame
    # each beside its static twin: the same rays and (M, a) = (1, 0.99) at
    # r_obs 100 from a static Kerr (its scalars formed in float64), in turns
    from light_path_tracer_tpu_torch.models import Kerr
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    zeros = torch.zeros(al.shape, dtype=torch.bool, device=dev)
    twin_kw = {"theta": {}, "mu": dict(force_invalid=p28_poison("m_a", al,
                                                                 th))}
    twin = {chart: _frozen(lambda: kk.trace_rays_kerr_cuda(
        Kerr(M=1.0, a=0.99), R_OBS, al, th, np.pi / 2, zeros, LAMBDA_MAX,
        P28_STEPS, formulation=chart, return_unconverged=True,
        **twin_kw[chart])) for chart in P28_CHARTS}
    times, static = {}, {}
    for _turn in range(2):
        for key, k in kern.items():
            times.setdefault(key, []).append(kernel_alone_ms(k["fn"], 5))
        for chart, fn in twin.items():
            static.setdefault(chart, []).append(kernel_alone_ms(fn, 5))
    times = {key: float(np.median(v)) for key, v in times.items()}
    static = {chart: float(np.median(v)) for chart, v in static.items()}
    print(f"  each dynamic launch alone on the 4,096 rays (ms, median of 2 "
          f"turns): {json.dumps({f'{c} {f}': v for (c, f), v in times.items()})}"
          f"; the static (M, a) = (1, 0.99) twins: {json.dumps(static)} on "
          f"{card}", flush=True)
    launches = {chart: sum(p[f"{chart}_dynamic"] for p in (
        paths["animate flyby"]["counts"], spin["counts"]))
        for chart in P28_CHARTS}
    entries = []
    for chart, source in (("theta", KERNEL_SOURCE),
                          ("mu", MU_SOURCE.format("dp45", ""))):
        k = kern[chart, "m_a_r"]
        e = kernel_entry(
            "kerr_dp45" + ("_mu" if chart == "mu" else "") + "_dynamic",
            source, DYN_REPLACES, launches[chart], 0.0,
            times[chart, "m_a_r"], k["plain_ms"], P28_RAYS,
            9 + 12 + (1 if chart == "mu" else 0),
            k["attempts"] * kerr_work(chart=chart))
        e.update(bitwise_plain=True, max_steps=P28_STEPS,
                 dynamic_params=list(P28_DYN["m_a_r"]),
                 m_a_ms=times[chart, "m_a"],
                 m_a_plain_ms=kern[chart, "m_a"]["plain_ms"],
                 static_twin_ms=static[chart])
        entries.append(e)
    h = kernel_entry(
        "trace_rays_kerr_hybrid_dynamic", DRIVER_SOURCE, DYN_HYBRID_REPLACES,
        paths["animate flyby"]["counts"]["hybrid"]
        + spin["counts"]["hybrid"], 0.0, frame["ms"], frame["plain_ms"], n,
        9 + 12, frame["attempts_a"] * kerr_work(chart="mu")
        + frame["attempts_b"] * kerr_work())
    h.update(bitwise_plain=True, frame=frame)
    entries.append(h)
    print(f"  [{time.perf_counter() - t_phase:.1f} s] phase 28 done",
          flush=True)
    return entries


def p28_trace_pass(al, th, chart, poison, probe):
    """One pass of p28_frame_trace's hybrid alone: pass A (mu, the poison
    mask, capped) or pass B (theta on the re-trace slots)."""
    import torch
    from light_path_tracer_tpu_torch.models import Kerr
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    kw = dict(formulation=chart, probe=probe,
              dynamic_params=(1.0, 0.9, P28_FLY[1]))
    if chart == "mu":
        kw.update(force_invalid=poison, return_unconverged=True)
    return kk.trace_rays_kerr_cuda(
        Kerr(M=1.0, a=0.0), R_OBS, al, th, np.pi / 2,
        torch.zeros(al.shape, dtype=torch.bool, device=al.device),
        max(LAMBDA_MAX, 6.0 * P28_FLY[0]), P28_FRAME_STEPS, **kw)


# Phase 29: the paths that run no kernel of their own. The `plot` CLI's
# default angles (deg); its families; the `orbit` CLI's default orbit and
# the spins it runs at.
P29_ANGLES = (0.0, 2.0, 4.0, 5.0, 5.5, 5.97, 6.5, 8.0, 10.0, 15.0)
P29_FAMILIES = ("kerr", "schwarzschild")
P29_ORBIT = dict(peri=8.0, apo=16.0, steps=6000)
P29_SPINS = (0.0, 0.9)
P29_RK4_SIZE = 1024
# The user metrics of examples/user_metric_torch.py and their spins; the
# closure identity CustomMetric(kerr_covariant(1, 0.9)) beside them.
P29_EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "examples", "user_metric_torch.py")
P29_CUSTOM = {"hayward": 0.0, "rotating_hayward": 0.9, "closure": 0.9}
P29_CUSTOM_SIZE = 512
P29_CHECK = (64, 64)
# The fit: tests/test_diff.py's fit fan at 32 x 32.
P29_FIT = dict(r_obs=20.0, theta_obs=float(np.radians(80.0)), n_steps=1024,
               h_max=0.5, a=0.7, a0=0.35, side=32, lo=0.45, hi=1.0)


def p29_metric(name):
    """A phase-29 metric by name: Kerr a 0.9, Schwarzschild, a user metric
    of examples/user_metric_torch.py, or the closure identity."""
    from light_path_tracer_tpu_torch.models import (
        CustomMetric, Kerr, Schwarzschild, kerr_covariant, load_user_metric)
    if name == "kerr":
        return Kerr(M=1.0, a=0.9)
    if name == "schwarzschild":
        return Schwarzschild(M=1.0)
    if name == "closure":
        return CustomMetric(M=1.0, a=0.9, covariant_fn=kerr_covariant(1.0, 0.9),
                            label="closure")
    return load_user_metric(f"{P29_EXAMPLES}:{name}", M=1.0,
                            a=P29_CUSTOM[name])


def p29_paths(name, device):
    """The ten angles in float64 on `device`: trace_ray's (final alpha,
    winding, outcome) through trace_batch, and trace_ray_trajectories'
    outcomes and recorded paths (n_valid, 8)."""
    import torch
    from light_path_tracer_tpu_torch.trajectory import trace_ray_trajectories
    m = p29_metric(name)
    rays = [m.trace_ray(R_OBS, float(np.radians(d)), dtype=torch.float64,
                        device=device) for d in P29_ANGLES]
    trajs = trace_ray_trajectories(m, R_OBS, np.radians(P29_ANGLES),
                                   dtype=torch.float64, device=device)
    return dict(alpha=np.array([r[0] for r in rays]),
                n_half=np.array([r[1] for r in rays]),
                outcome=[r[2] for r in rays],
                path_outcome=[o for _t, o in trajs],
                paths=[None if t is None else
                       t.states[:int(t.n_valid)].cpu().numpy()
                       for t, _o in trajs])


def p29_paths_check(name, og, oc):
    """The card's p29_paths against the CPU's: equal outcomes everywhere;
    on the angles outside 0.9-1.1 alpha_crit equal windings, final alpha
    within 1e-6 rad and the recorded paths of equal length within 1e-7 of
    their largest |state|; the gaps of the near-critical angles printed."""
    ac = float(np.degrees(p29_metric(name).alpha_crit(R_OBS, device="cpu")))
    rows, ok = {}, og["outcome"] == oc["outcome"] and (
        og["path_outcome"] == oc["path_outcome"])
    for i, deg in enumerate(P29_ANGLES):
        stable = abs(deg - ac) > 0.1 * ac
        da = abs(og["alpha"][i] - oc["alpha"][i])
        pg, pc = og["paths"][i], oc["paths"][i]
        row = dict(outcome=og["outcome"][i], stable=stable,
                   d_alpha=None if np.isnan(da) else float(da),
                   n_half=[int(og["n_half"][i]), int(oc["n_half"][i])],
                   samples=[None if pg is None else len(pg),
                            None if pc is None else len(pc)])
        if pg is not None and pc is not None and len(pg) == len(pc):
            row["path_rel"] = float(np.abs(pg - pc).max()
                                    / np.abs(pc).max())
        if stable:
            ok = (ok and row["n_half"][0] == row["n_half"][1]
                  and (row["outcome"] != "escaped" or da < 1e-6)
                  and row["samples"][0] == row["samples"][1]
                  and row.get("path_rel", 0.0) < 1e-7)
        rows[f"{deg:g}"] = row
    return dict(alpha_crit_deg=ac, rays=rows), ok


def p29_quadrature(r_p, r_a, M=1.0):
    """The exact Schwarzschild periapsis advance per orbit [rad] by the
    radial quadrature: V(u) = E^2 - (1 - 2Mu)(1 + L^2 u^2) has the roots
    1/r_a, 1/r_p and 1/(2M) - 1/r_a - 1/r_p, and the substitution
    u = (u1 + u2)/2 - (u2 - u1)/2 cos(psi) leaves the smooth integrand
    1 / sqrt(2M (u3 - u))."""
    u1, u2 = 1.0 / r_a, 1.0 / r_p
    u3 = 1.0 / (2.0 * M) - u1 - u2
    psi = np.linspace(0.0, np.pi, 200001)
    u = 0.5 * (u1 + u2) - 0.5 * (u2 - u1) * np.cos(psi)
    return 2.0 * np.trapezoid(1.0 / np.sqrt(2.0 * M * (u3 - u)),
                              psi) - 2.0 * np.pi


def p29_cli(argv):
    """One CLI run in this process: (rc, seconds, stdout lines)."""
    import contextlib
    import io
    from light_path_tracer_tpu_torch.cli import main as cli_main
    buf = io.StringIO()
    _sync()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    _sync()
    return rc, time.perf_counter() - t0, buf.getvalue().strip().splitlines()


def p29_orbit(a, device, npz):
    """`orbit --no-plot` at its defaults and spin a on `device`, its
    numbers written to npz: (rc, seconds, lines, the npz's arrays)."""
    rc, secs, lines = p29_cli(
        ["orbit", "--no-plot", "--a", str(a), "--peri",
         str(P29_ORBIT["peri"]), "--apo", str(P29_ORBIT["apo"]), "--steps",
         str(P29_ORBIT["steps"]), "--device", str(device), "--npz", npz])
    rec = dict(np.load(npz)) if rc == 0 else {}
    return rc, secs, lines, rec


def p29_counters():
    """The counts phase 29's paths read: the Kerr kernel's and the orbit
    kernel's launches (both dtypes), the plain Kerr and orbit loops' and
    the fixed-step RK4 loop's calls."""
    from light_path_tracer_tpu_torch.ops import kerr_trace as tk
    from light_path_tracer_tpu_torch.ops import schwarzschild_trace as st
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    from light_path_tracer_tpu_torch.ops.cuda import schwarzschild_kernel
    from light_path_tracer_tpu_torch.ops.kerr_rk4 import trace_rays_kerr_rk4
    return dict(kerr=kk.trace_rays_kerr_cuda,
                orbit=schwarzschild_kernel.trace_rays_schwarzschild_cuda,
                plain=tk.trace_rays_kerr, plain_orbit=st.trace_rays_schwarzschild,
                rk4=trace_rays_kerr_rk4)


def p29_zero():
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    c = p29_counters()
    kk.zero_counters(c["kerr"])
    c["orbit"].launches = c["orbit"].launches_f64 = 0
    for key in ("plain", "plain_orbit", "rk4"):
        c[key].launches = 0


def p29_counts():
    c = p29_counters()
    k = c["kerr"]
    return dict(kerr=k.launches + k.launches_f64,
                orbit=c["orbit"].launches + c["orbit"].launches_f64,
                plain=c["plain"].launches,
                plain_orbit=c["plain_orbit"].launches, rk4=c["rk4"].launches)


def p29_rk4_cli(out):
    """`shadow --integrator rk4 --a 0.9 --size 1024` on the card, the
    counts zeroed just before and read just after: (rc, seconds, lines,
    counts)."""
    p29_zero()
    rc, secs, lines = p29_cli(
        ["shadow", "--integrator", "rk4", "--a", "0.9", "--size",
         str(P29_RK4_SIZE), "--device", "cuda", "--output", out])
    return rc, secs, lines, p29_counts()


def p29_custom_cli(name, out):
    """`shadow --metric-py examples/user_metric_torch.py:NAME --size 512`
    (with --a at the example's spin) on the card, the counts zeroed just
    before and read just after: (rc, seconds, lines, counts)."""
    p29_zero()
    rc, secs, lines = p29_cli(
        ["shadow", "--metric-py", f"{P29_EXAMPLES}:{name}", "--a",
         str(P29_CUSTOM[name]), "--size", str(P29_CUSTOM_SIZE), "--device",
         "cuda", "--output", out])
    return rc, secs, lines, p29_counts()


def p29_frame(name, dim, device, integrator="dp45"):
    """One frame's trace through precompute_final_alpha on `device`:
    (final alpha as float64 NumPy, integrator steps, seconds, the alpha
    grid). Kerr a = 0.9 unless `name` names a custom metric."""
    import torch
    from light_path_tracer_tpu_torch import camera
    from light_path_tracer_tpu_torch.pipeline import precompute_final_alpha
    from light_path_tracer_tpu_torch.utils.config import (RenderConfig,
                                                          SceneConfig)
    custom = None if name == "kerr" else p29_metric(name)
    a = 0.9 if custom is None else P29_CUSTOM[name]
    scene = SceneConfig(M=1.0, a=a, r_obs_mult=R_OBS, custom_metric=custom)
    fov = camera.fov_from_vertical(scene.vertical_fov, dim)
    _sync()
    t0 = time.perf_counter()
    pre = precompute_final_alpha(scene, RenderConfig(integrator=integrator),
                                 dim, fov, device=device)
    fa = pre.final_alpha.to(torch.float64).cpu().numpy()
    secs = time.perf_counter() - t0
    alpha = camera.build_alpha_lookup(dim, fov, device="cpu").numpy(
    ).astype(np.float64)
    return fa, int(pre.steps), secs, alpha


def p29_frame_check(fg, fc):
    """Two frames' final alpha: the masks (NaN = not escaped) equal on
    >= 99 % and p99 |d alpha| < 1e-3 rad where finite in both."""
    agree = float((np.isnan(fg) == np.isnan(fc)).mean())
    both = np.isfinite(fg) & np.isfinite(fc)
    p99 = float(np.percentile(np.abs(fg - fc)[both], 99))
    return dict(mask_agree=agree, p99=p99), agree >= 0.99 and p99 < 1e-3


def p29_fit():
    """fit_scene_params on the card from a = 0.35 on the 32 x 32 fan of
    data traced at a = 0.7, and d(mean alpha)/da at 0.6 by autograd and
    by a central difference (eps 1e-5)."""
    import torch
    from light_path_tracer_tpu_torch import diff
    f = P29_FIT
    al = np.linspace(f["lo"], f["hi"], f["side"])
    th = np.linspace(0.2, 2 * np.pi - 0.2, f["side"], endpoint=False)
    A, T = np.meshgrid(al, th)
    f64 = dict(dtype=torch.float64, device="cuda")
    al, th = torch.tensor(A.ravel(), **f64), torch.tensor(T.ravel(), **f64)
    kw = dict(n_steps=f["n_steps"], h_max=f["h_max"])
    observed, status = diff.trace_final_alpha_diff(
        1.0, f["a"], f["r_obs"], al, th, f["theta_obs"], **kw)
    _sync()
    t0 = time.perf_counter()
    fitted, history = diff.fit_scene_params(
        observed, al, th, {"a": f["a0"]},
        {"M": 1.0, "r_obs": f["r_obs"], "theta_obs": f["theta_obs"]},
        iters=20, **kw)
    _sync()
    secs = time.perf_counter() - t0

    def mean_alpha(a):
        fa, st = diff.trace_final_alpha_diff(1.0, a, f["r_obs"], al, th,
                                             f["theta_obs"], **kw)
        ok = st == 1
        return torch.where(ok, fa, torch.zeros_like(fa)).sum() / ok.sum()
    a = torch.tensor(0.6, requires_grad=True, **f64)
    _sync()
    t0 = time.perf_counter()
    (grad,) = torch.autograd.grad(mean_alpha(a), a)
    _sync()
    grad_s = time.perf_counter() - t0
    with torch.no_grad():
        fd = (float(mean_alpha(0.6 + 1e-5)) - float(mean_alpha(0.6 - 1e-5))
              ) / 2e-5
    return dict(fitted_a=fitted["a"], history=history,
                iterations=len(history) - 1, seconds=secs,
                s_per_iteration=secs / max(len(history) - 1, 1),
                escaped=int((status == 1).sum()), rays=int(al.numel()),
                grad=float(grad), grad_s=grad_s, central_difference=fd)


def queue_phase29(pool, dev):
    """Queue phase 29's CPU runs (the ten angles, the two orbits, the
    64^2 user-metric frames) and its runs in children on the card (the
    two orbits, the RK4 shadow and the two --metric-py CLIs, the fit):
    none of these launches a kernel of this package, and each is host-
    bound, so they run beside the parent's phases 23-28."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix="p29_")
    jobs = dict(tmp=tmp)
    for name in P29_FAMILIES:
        jobs["paths", name] = pool.submit("p29_paths", name, "cpu", on="cpu")
    for a in P29_SPINS:
        for device in ("cpu", "cuda"):
            jobs["orbit", a, device] = pool.submit(
                "p29_orbit", a, device,
                os.path.join(tmp, f"orbit_{device}_{a}.npz"), on=device)
    jobs["rk4_cli"] = pool.submit("p29_rk4_cli",
                                  os.path.join(tmp, "rk4.png"))
    for name in P29_CUSTOM:
        jobs["frame64", name] = pool.submit("p29_frame", name, P29_CHECK,
                                            "cpu", on="cpu")
    for name in ("hayward", "rotating_hayward"):
        jobs["cli", name] = pool.submit(
            "p29_custom_cli", name, os.path.join(tmp, f"{name}.png"))
    jobs["fit"] = pool.submit("p29_fit")
    return jobs


def paths_phase(dev, card, pool, ctx):
    """Phase 29: ray, plot and orbit, the fixed-step RK4, user metrics and
    the differentiable fit on the card (module docstring)."""
    import torch
    t_phase = time.perf_counter()
    jobs = ctx["jobs"]
    tmp = jobs["tmp"]
    try:
        import matplotlib  # noqa: F401
        figures = "matplotlib imports: the figures are drawn"
    except ImportError:
        figures = "matplotlib is not installed: no figure is drawn"
    print(f"  {figures}", flush=True)

    # -- (a) ray and plot through the CLI, counts zeroed around each
    runs = {"ray": ["ray", "--no-plot"],
            "ray a=0.9": ["ray", "--no-plot", "--a", "0.9"],
            "plot a=0.9": ["plot", "--a", "0.9", "--output",
                           os.path.join(tmp, "plot9.png")],
            "plot a=0": ["plot", "--output", os.path.join(tmp, "plot0.png")]}
    paths = {}
    for label, argv in runs.items():
        p29_zero()
        rc, secs, lines = p29_cli(argv + ["--device", "cuda"])
        row = dict(rc=rc, seconds=secs, counts=p29_counts(),
                   said=[l for l in lines if not l.startswith("Saved")])
        paths[label] = row
        print(f"  {label}: {json.dumps(row)} on {card}", flush=True)
        require(rc == 0 and row["counts"]["plain"] == 0
                and row["counts"]["plain_orbit"] == 0,
                f"phase 29 {label}: {row}")
    require(paths["plot a=0.9"]["counts"]["kerr"] == len(P29_ANGLES)
            and paths["plot a=0"]["counts"]["orbit"] == len(P29_ANGLES),
            f"phase 29 plot paths: {paths}")

    # -- (b) the ten angles in float64 on the card against the CPU
    for name in P29_FAMILIES:
        p29_zero()
        _sync()
        t0 = time.perf_counter()
        og = p29_paths(name, "cuda")
        secs = time.perf_counter() - t0
        counts = p29_counts()
        _ms, oc = PlainPool.result(jobs["paths", name], "cpu")
        row, ok = p29_paths_check(name, og, oc)
        row.update(seconds=secs, counts=counts)
        print(f"  float64 trace_ray and paths, {name}, card vs CPU: "
              f"{json.dumps(row)}", flush=True)
        require(ok and counts["plain"] == 0 and counts["plain_orbit"] == 0
                and counts["kerr"] + counts["orbit"] == len(P29_ANGLES),
                f"phase 29 {name} paths: {row}")

    # -- (c) orbit at its defaults for a = 0 and 0.9 (its child on the
    # card), against the CPU
    orbits = {}
    for a in P29_SPINS:
        _ms, (rc, secs, lines, rec) = PlainPool.result(
            jobs["orbit", a, "cuda"], "cpu")
        _ms, (rc_c, secs_c, _lines_c, rec_c) = PlainPool.result(
            jobs["orbit", a, "cpu"], "cpu")
        adv, adv_c = rec.get("periapsis_advance"), rec_c.get(
            "periapsis_advance")
        row = dict(rc=rc, seconds=secs, cpu_seconds=secs_c, said=lines,
                   samples=int(len(rec.get("states", ()))),
                   passages=None if adv is None else int(len(adv)))
        same = (rc == rc_c == 0 and adv is not None and adv_c is not None
                and len(adv) == len(adv_c))
        if same:
            row["d_precession_max"] = float(np.abs(adv - adv_c).max())
            row["h_residual"] = float(np.abs(rec["hamiltonian"] + 0.5).max())
        if a == 0.0 and adv is not None:
            exact = p29_quadrature(P29_ORBIT["peri"], P29_ORBIT["apo"])
            row.update(advance_mean=float(np.mean(adv)), exact=exact,
                       rel=float(abs(np.mean(adv) / exact - 1.0)))
            same = same and row["rel"] < 2e-3
        orbits[f"a={a:g}"] = row
        print(f"  orbit --no-plot a = {a:g} (its child on the card): "
              f"{json.dumps(row)} on {card}", flush=True)
        require(same and row["d_precession_max"] < 1e-8,
                f"phase 29 orbit a={a:g}: {row}")

    # -- (d) the fixed-step RK4 1024^2 shadow (the CLI in its child on
    # the card), its frame against the DP45 kernel's
    size = P29_RK4_SIZE
    _ms, (rc, secs, lines, counts) = PlainPool.result(jobs["rk4_cli"], "cpu")
    rk4_cli = dict(rc=rc, seconds=secs, counts=counts,
                   said=[l for l in lines if not l.startswith("Saved")])
    print(f"  shadow --integrator rk4 --a 0.9 --size {size} (its child on "
          f"the card): {json.dumps(rk4_cli)} on {card}", flush=True)
    require(rc == 0 and rk4_cli["counts"]["rk4"] == 1
            and rk4_cli["counts"]["kerr"] == 0
            and rk4_cli["counts"]["plain"] == 0, f"phase 29 rk4: {rk4_cli}")
    dim = (size, size)
    fr, steps_r, secs_r, alpha = p29_frame("kerr", dim, "cuda", "rk4")
    fd, steps_d, secs_d, _alpha = p29_frame("kerr", dim, "cuda")
    ac = p29_metric("kerr").alpha_crit(R_OBS)
    away = (alpha < 0.8 * ac) | (alpha > 1.2 * ac)
    both = np.isfinite(fr) & np.isfinite(fd)
    d = np.abs(fr - fd)[both]
    from light_path_tracer_tpu_torch.models import Kerr
    from light_path_tracer_tpu_torch.ops.kerr_rk4 import trace_rays_kerr_rk4
    from light_path_tracer_tpu_torch.pipeline import trace_inputs
    from light_path_tracer_tpu_torch.utils.config import (RenderConfig,
                                                          SceneConfig)
    from light_path_tracer_tpu_torch import camera
    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=R_OBS)
    al, th, rf, _rows = trace_inputs(scene, RenderConfig(), dim,
                                     camera.fov_from_vertical(
                                         scene.vertical_fov, dim), dev)
    capped = 16
    prof = device_profile(lambda: trace_rays_kerr_rk4(
        Kerr(M=1.0, a=0.9), R_OBS, al, th, np.pi / 2, rf, LAMBDA_MAX,
        capped), 1)
    rk4 = dict(status_agree_away=float((np.isfinite(fr) == np.isfinite(fd))
                                       [away].mean()),
               median=float(np.median(d)), p90=float(np.percentile(d, 90)),
               rk4_s=secs_r, rk4_iterations=steps_r, dp45_kernel_s=secs_d,
               dp45_warp_steps=steps_d,
               kernels_per_iteration=prof["launches"] / capped,
               profile_16_iterations=prof)
    rk4["kernels_per_frame"] = rk4["kernels_per_iteration"] * steps_r
    print(f"  RK4 1024^2 frame against the DP45 kernel's: {json.dumps(rk4)}"
          f" on {card}", flush=True)
    require(rk4["status_agree_away"] >= 0.95 and rk4["median"] < 5e-3
            and rk4["p90"] < 3e-2, f"phase 29 rk4 vs dp45: {rk4}")
    del al, th, rf

    # -- (e) user metrics: the 512^2 frames, the closure identity, 64^2
    # against the CPU, the --metric-py CLIs from their child
    custom = {}
    n = P29_CUSTOM_SIZE
    fk, _steps, _secs, alpha_c = p29_frame("kerr", (n, n), "cuda")
    for name in P29_CUSTOM:
        p29_zero()
        fg, steps, secs, _alpha = p29_frame(name, (n, n), "cuda")
        row = dict(seconds=secs, warp_steps=steps, counts=p29_counts(),
                   escaped=int(np.isfinite(fg).sum()))
        require(row["counts"]["kerr"] == 0 and row["counts"]["plain"] == 1,
                f"phase 29 {name} frame: {row}")
        if name == "closure":
            ac9 = p29_metric("kerr").alpha_crit(R_OBS)
            stable = np.abs(alpha_c - ac9) > 0.05 * ac9
            sk, sc = np.isfinite(fk), np.isfinite(fg)
            dd = np.abs(fk - fg)[sk & sc & stable]
            row.update(status_agree=float((sk == sc).mean()),
                       p99=float(np.percentile(dd, 99)))
            require(row["status_agree"] > 0.99 and row["p99"] < 2e-3,
                    f"phase 29 closure identity: {row}")
        og, _s, _t, _a = p29_frame(name, P29_CHECK, "cuda")
        _ms, (oc, _s2, _t2, _a2) = PlainPool.result(jobs["frame64", name],
                                                    "cpu")
        row["check64"], ok = p29_frame_check(og, oc)
        require(ok, f"phase 29 {name} 64^2 card vs CPU: {row}")
        custom[name] = row
        print(f"  {name} {n}^2 trace and 64^2 card vs CPU: "
              f"{json.dumps(row)} on {card}", flush=True)
    for name in ("hayward", "rotating_hayward"):
        _ms, (rc, secs, lines, counts) = PlainPool.result(jobs["cli", name],
                                                          "cpu")
        row = dict(rc=rc, seconds=secs, counts=counts,
                   said=[l for l in lines if not l.startswith("Saved")])
        print(f"  shadow --metric-py {name} --size {n} (its child on the "
              f"card): {json.dumps(row)}", flush=True)
        require(rc == 0 and counts["kerr"] == 0 and counts["plain"] >= 1,
                f"phase 29 --metric-py {name}: {row}")

    # -- (f) the fit, from its child on the card
    _ms, fit = PlainPool.result(jobs["fit"], "cpu")
    fit["grad_vs_fd"] = abs(fit["grad"] - fit["central_difference"]) / abs(
        fit["central_difference"])
    print(f"  fit_scene_params a {P29_FIT['a0']} -> {P29_FIT['a']} on the "
          f"{P29_FIT['side']}^2 fan (its child on the card): "
          f"{json.dumps(fit)}", flush=True)
    require(abs(fit["fitted_a"] - P29_FIT["a"]) < 1e-4
            and fit["grad_vs_fd"] < 1e-4, f"phase 29 fit: {fit}")
    print(f"  [{time.perf_counter() - t_phase:.1f} s] phase 29 done",
          flush=True)


P30_SIZE = 1024
P30_LENS = 512
P30_CAUSTICS = 512
P30_CHUNK = 65536
P30_CRASH_AFTER = 3


def p30_requests(png_b64):
    """The requests of phase 30 at the published widths (module
    docstring), each with its mode's kernels as its launch counts name
    them."""
    kerr = {"a": 0.9, "r_obs_mult": R_OBS, "theta_obs": 90.0,
            "vertical_fov_deg": 40.0}
    size = [P30_SIZE, P30_SIZE]
    return {
        "shadow": ({"mode": "shadow", "size": size, "scene": kerr,
                    "render": {"dtype": "float32", "precision": "fast"}},
                   ("kerr",)),
        "lens": ({"mode": "lens", "scene": {"r_obs_mult": R_OBS},
                  "image_b64": png_b64}, ("orbit",)),
        "disk": ({"mode": "disk", "size": size,
                  "scene": {"a": 0.9, "r_obs_mult": R_OBS,
                            "theta_obs": 80.0}, "disk": {}},
                 ("disk", "disk_driver")),
        "volumetric": ({"mode": "volumetric", "size": size,
                        "scene": {"a": 0.9, "r_obs_mult": R_OBS,
                                  "theta_obs": 80.0,
                                  "vertical_fov_deg": 16.0},
                        "riaf": {}}, ("volumetric", "vol_driver")),
        "caustics": ({"mode": "caustics", "size": [P30_CAUSTICS] * 2,
                      "scene": kerr}, ("surface",)),
        "star": ({"mode": "star", "size": size, "scene": {},
                  "star": {"spots": [[30.0, 0.0, 20.0, 1.0]]}},
                 ("surface",)),
    }


def p30_counters():
    """The wrappers and plain loops phase 30's modes run through."""
    from light_path_tracer_tpu_torch.ops import kerr_trace as tk
    from light_path_tracer_tpu_torch.ops import schwarzschild_trace as st
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    from light_path_tracer_tpu_torch.ops.cuda import schwarzschild_kernel
    from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk
    return dict(kerr=kk.trace_rays_kerr_cuda, disk=kk.trace_disk_rays_cuda,
                disk_driver=kk.trace_disk_rays_two_pass,
                orbit=schwarzschild_kernel.trace_rays_schwarzschild_cuda,
                volumetric=vk.trace_rays_volumetric_cuda,
                vol_driver=kk.trace_rays_volumetric_two_pass,
                plain=(tk.trace_rays_kerr, tk.trace_disk_rays_kerr,
                       tk.trace_rays_volumetric, tk.trace_rays_surface,
                       st.trace_rays_schwarzschild))


def p30_zero():
    """Every count phase 30 reads, set to 0."""
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    from light_path_tracer_tpu_torch.ops.cuda import surface_kernel as sk
    c = p30_counters()
    for k in ("kerr", "disk", "volumetric"):
        kk.zero_counters(c[k])
    sk.zero_counters()
    c["orbit"].launches = c["orbit"].launches_f64 = 0
    for fn in (c["disk_driver"], c["vol_driver"]) + c["plain"]:
        fn.launches = 0


def p30_counts():
    """The counts since p30_zero: each kernel's float32 DP45 launches,
    the drivers' calls and the plain loops' calls."""
    from light_path_tracer_tpu_torch.ops.cuda import surface_kernel as sk
    c = p30_counters()
    out = {k: c[k].launches for k in ("kerr", "disk", "disk_driver",
                                      "orbit", "volumetric", "vol_driver")}
    out.update(surface=sum(sk.launches().values()),
               plain=sum(fn.launches for fn in c["plain"]))
    return out


def p30_direct(mode, decoded, device="cuda"):
    """The direct call a user makes for a decoded request, outside the
    server: the image as NumPy."""
    from light_path_tracer_tpu_torch import disk, pipeline, star, volumetric
    (_mode, scene, cfg, dcfg, riaf, scfg, src, size, _dl) = decoded
    size = tuple(size) if size is not None else None
    if mode == "shadow":
        img, _ = pipeline.render_shadow(scene, size, cfg, device=device)
    elif mode == "lens":
        img = pipeline.render_scene(scene, src, cfg, device=device).image
    elif mode == "disk":
        img, _ = disk.render_disk(scene, size, cfg, dcfg, device=device)
    elif mode == "volumetric":
        img, _ = volumetric.render_volumetric(scene, size, cfg, riaf,
                                              device=device)
    elif mode == "caustics":
        img, _ext, _ = pipeline.render_caustics(
            scene, size, cfg, bins=max(size[0] // 2, 8), device=device)
    else:
        img, _ = star.render_star(scene, size, cfg, scfg, device=device)
    return img.cpu().numpy()


def p30_post(url, payload, path="/render"):
    """(status, body, headers, wall seconds) of one POST; non-2xx
    statuses returned."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            out = resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as err:
        out = err.code, err.read(), dict(err.headers)
    return out + (time.perf_counter() - t0,)


def p30_get(url, path):
    import urllib.request
    t0 = time.perf_counter()
    with urllib.request.urlopen(url + path, timeout=60) as resp:
        body = json.loads(resp.read())
    return body, time.perf_counter() - t0


def p30_npy(body):
    import io
    return np.load(io.BytesIO(body), allow_pickle=False)


def p30_same(a, b):
    """Bitwise equal arrays (NaN where NaN)."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and a.tobytes() == b.tobytes())


def p30_caustics_ok(got, want):
    """The caustics map deposits by index_add_, whose atomic float32 adds
    on the card sum in no fixed order: bitwise, or else within 1e-5 of
    each bin's value (or of the largest value's 1e-6) with equal zero
    bins."""
    if p30_same(got, want):
        return True, 0
    d = np.abs(got.astype(np.float64) - want)
    bar = np.maximum(1e-5 * np.abs(want), 1e-6 * np.abs(want).max())
    return bool((d <= bar).all() and ((got == 0) == (want == 0)).all()), \
        int((got != want).sum())


def p30_mode(url, mode, req, kernels, card):
    """One mode through the server: a cold and a warm npy request and a
    warm png one, each with its launches, against the direct call on the
    card (bitwise; caustics by p30_caustics_ok) and its time."""
    from light_path_tracer_tpu_torch import serve
    row = {}
    bodies = {}
    for label, fmt in (("cold", "npy"), ("warm", "npy"), ("png", "png")):
        p30_zero()
        status, body, hdr, wall = p30_post(url, dict(req, format=fmt))
        counts = p30_counts()
        require(status == 200, f"phase 30 {mode} {label}: {status} "
                f"{body[:400]!r}")
        bodies[label] = body
        row[label] = dict(seconds=wall,
                          render_seconds=float(hdr["X-Render-Seconds"]),
                          cache=hdr["X-Cache"], bytes=len(body),
                          counts=counts)
        require(counts["plain"] == 0 and all(counts[k] > 0
                                              for k in kernels),
                f"phase 30 {mode} {label}: launches {counts}")
    require(row["cold"]["cache"] == "cold" and row["warm"]["cache"] == "warm",
            f"phase 30 {mode}: X-Cache {row}")
    got = p30_npy(bodies["cold"])
    decoded = serve.decode_request(req)
    p30_zero()
    _sync()
    t0 = time.perf_counter()
    want = p30_direct(mode, decoded)
    row["direct_seconds"] = time.perf_counter() - t0
    row["direct_counts"] = p30_counts()
    t0 = time.perf_counter()
    for fmt in ("npy", "png"):
        serve._encode_image(serve._display_encode(mode, got, fmt), fmt)
        row[f"encode_{fmt}_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
    for label in ("cold", "warm", "png"):
        r = row[label]
        r["http_seconds"] = (r["seconds"] - r["render_seconds"]
                             - row["encode_npy_seconds" if label != "png"
                                   else "encode_png_seconds"])
    same_warm = p30_same(p30_npy(bodies["warm"]), got)
    if mode == "caustics":
        ok, differ = p30_caustics_ok(got, want)
        ok_warm, differ_warm = p30_caustics_ok(p30_npy(bodies["warm"]), got)
        row.update(bitwise_direct=differ == 0, bins_differ=differ,
                   bitwise_warm=differ_warm == 0)
        ok = ok and ok_warm
    else:
        ok = p30_same(got, want) and same_warm
        row.update(bitwise_direct=p30_same(got, want),
                   bitwise_warm=same_warm)
    row.update(shape=list(got.shape), dtype=str(got.dtype),
               finite=bool(np.isfinite(got).all()))
    print(f"  {mode}: {json.dumps(row)} on {card}", flush=True)
    require(ok, f"phase 30 {mode}: the reply differs from the direct call "
            f"on the card: {row}")
    return row, bodies


def p30_cache(tmp, card):
    """cached_precompute on the shadow request's scene (miss, hit), a
    chunked precompute stopped after P30_CRASH_AFTER chunks and resumed,
    and the chunked trace with the live bar, each against the fresh run
    bitwise."""
    import contextlib
    import io
    import torch
    from light_path_tracer_tpu_torch import camera
    from light_path_tracer_tpu_torch import checkpoint as ckpt
    from light_path_tracer_tpu_torch.pipeline import precompute_final_alpha
    from light_path_tracer_tpu_torch import serve
    req, _k = p30_requests("")["shadow"]
    _m, scene, cfg, *_rest = serve.decode_request(req)
    dim = (P30_SIZE, P30_SIZE)
    fov = camera.fov_from_vertical(scene.vertical_fov, dim)

    def same(a, b):
        return (torch.equal(a.final_alpha.isnan(), b.final_alpha.isnan())
                and torch.equal(a.final_alpha.nan_to_num(),
                                b.final_alpha.nan_to_num())
                and torch.equal(a.winding.to(torch.int32),
                                b.winding.to(torch.int32)))

    row = {}
    cache_dir = os.path.join(tmp, "lookup_cache")
    out = []
    for label in ("miss", "hit"):
        _sync()
        t0 = time.perf_counter()
        pre, hit = ckpt.cached_precompute(scene, cfg, dim, fov,
                                          cache_dir=cache_dir, device="cuda")
        _sync()
        row[label] = dict(hit=hit, seconds=time.perf_counter() - t0,
                          device=str(pre.final_alpha.device))
        out.append(pre)
    row["hit_equals_miss"] = same(*out)
    require(not row["miss"]["hit"] and row["hit"]["hit"]
            and row["hit_equals_miss"]
            and row["hit"]["device"].startswith("cuda"),
            f"phase 30 lookup cache: {row}")

    chunked = dataclasses.replace(cfg, chunk_size=P30_CHUNK)
    p30_zero()
    _sync()
    t0 = time.perf_counter()
    fresh = precompute_final_alpha(scene, chunked, dim, fov, device="cuda")
    _sync()
    row["fresh_seconds"] = time.perf_counter() - t0
    row["fresh_launches"] = p30_counts()["kerr"]
    n_chunks = -(-fresh.traced_rays // P30_CHUNK)

    class Stop(Exception):
        pass

    class CrashingStore(ckpt.ChunkStore):
        puts = 0

        def put(self, start, res):
            if CrashingStore.puts >= P30_CRASH_AFTER:
                raise Stop(f"stopped before chunk {start}")
            super().put(start, res)
            CrashingStore.puts += 1

    class CountingStore(ckpt.ChunkStore):
        hits = puts = 0

        def get(self, start):
            res = super().get(start)
            CountingStore.hits += res is not None
            return res

        def put(self, start, res):
            CountingStore.puts += 1
            super().put(start, res)

    resume_dir = os.path.join(tmp, "resume")
    store_cls = ckpt.ChunkStore
    try:
        ckpt.ChunkStore = CrashingStore
        try:
            ckpt.cached_precompute(scene, chunked, dim, fov,
                                   cache_dir=resume_dir, resume=True,
                                   device="cuda")
            stopped = False
        except Stop:
            stopped = True
        stored = sorted(f for f in os.listdir(resume_dir)
                        if f.startswith("chunks_"))
        ckpt.ChunkStore = CountingStore
        p30_zero()
        _sync()
        t0 = time.perf_counter()
        resumed, hit = ckpt.cached_precompute(
            scene, chunked, dim, fov, cache_dir=resume_dir, resume=True,
            device="cuda")
        _sync()
        row["resume_seconds"] = time.perf_counter() - t0
    finally:
        ckpt.ChunkStore = store_cls
    left = [f for f in os.listdir(resume_dir) if f.startswith("chunks_")]
    row.update(chunks=n_chunks, stopped=stopped, stored=len(stored),
               resume_hits=CountingStore.hits, resume_puts=CountingStore.puts,
               resume_launches=p30_counts()["kerr"], chunk_files_left=len(left),
               resumed_equals_fresh=same(resumed, fresh), resumed_hit=hit)
    require(stopped and len(stored) == P30_CRASH_AFTER
            and CountingStore.hits == P30_CRASH_AFTER
            and CountingStore.puts == n_chunks - P30_CRASH_AFTER
            and row["resume_launches"] == n_chunks - P30_CRASH_AFTER
            and not left and not hit and row["resumed_equals_fresh"],
            f"phase 30 chunk resume: {row}")

    bar = io.StringIO()
    _sync()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(bar):
        live = precompute_final_alpha(
            scene, dataclasses.replace(chunked, progress="live"), dim, fov,
            device="cuda")
    _sync()
    row.update(live_seconds=time.perf_counter() - t0,
               live_equals_fresh=same(live, fresh),
               live_bar=bar.getvalue().strip().split("\r")[-1])
    print(f"  lookup cache, chunk resume and the live bar on the 1024^2 "
          f"shadow scene: {json.dumps(row)} on {card}", flush=True)
    require(row["live_equals_fresh"]
            and f"{n_chunks}/{n_chunks}" in row["live_bar"],
            f"phase 30 live bar: {row}")
    return row


def serve_phase(dev, card):
    """Phase 30: the port's HTTP render server on the card (module
    docstring). No CPU render: the earlier phases hold each pipeline
    against the CPU."""
    import base64
    import shutil
    import tempfile
    import threading
    from light_path_tracer_tpu_torch import serve
    from light_path_tracer_tpu_torch.cli import main as cli_main
    from light_path_tracer_tpu_torch.utils.save import encode_png, read_png
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="lpt_p30_")
    bg = (np.random.default_rng(30).random((P30_LENS, P30_LENS, 3))
          * 255).astype(np.uint8)
    png_b64 = base64.b64encode(encode_png(bg)).decode()
    svc = serve.RenderService(device="cuda")
    server = serve.make_server("127.0.0.1", 0, svc)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    url = f"http://{host}:{port}"
    try:
        health, secs = p30_get(url, "/healthz")
        print(f"  /healthz: {json.dumps(health)} in {secs:.4f} s", flush=True)
        require(health == {"ok": True, "devices": 1, "platform": "gpu"},
                f"phase 30 /healthz: {health}")

        rows, bodies = {}, {}
        for mode, (req, kernels) in p30_requests(png_b64).items():
            rows[mode], bodies[mode] = p30_mode(url, mode, req, kernels,
                                                card)

        # The PNG reply decodes to the pixels of the npy reply's encoding.
        shadow = p30_npy(bodies["shadow"]["cold"])
        png_px = read_png(bodies["shadow"]["png"])
        want_px = read_png(serve._encode_image(shadow, "png")[0])
        require(png_px.shape == (P30_SIZE, P30_SIZE, 4)
                and np.array_equal(png_px, want_px)
                and np.array_equal(png_px[..., 0],
                                   shadow.astype(np.float32)),
                "phase 30: the shadow PNG reply is not the npy reply's "
                "encoding")

        # Client errors, the held lock: deadline, /healthz, overload.
        errors = {}
        for label, bad in (("bad mode", {"mode": "nope"}),
                           ("custom_metric", {"mode": "shadow", "scene": {
                               "custom_metric": "evil.py:f"}})):
            status, body, _h, _w = p30_post(url, bad)
            errors[label] = status
            require(status == 400, f"phase 30 {label}: {status} {body!r}")
        small = {"mode": "shadow", "size": [64, 64], "format": "npy"}
        require(svc._lock.acquire(timeout=60), "phase 30: the render lock")
        waiters = []
        try:
            status, body, _h, wall = p30_post(url, dict(small,
                                                        deadline_s=0.2))
            errors["deadline_s 0.2"] = dict(status=status, seconds=wall)
            require(status == 503 and json.loads(body)["error"]
                    == "deadline exceeded", f"phase 30 deadline: {status}")
            health, secs = p30_get(url, "/healthz")
            errors["healthz while held"] = secs
            require(health["ok"] and secs < 1.0,
                    f"phase 30 /healthz under the lock: {secs:.3f} s")
            results = []
            for _ in range(svc.max_queue):
                t = threading.Thread(target=lambda: results.append(
                    p30_post(url, dict(small, deadline_s=60.0))))
                t.start()
                waiters.append(t)
            for _ in range(500):
                if svc.stats()["waiting"] >= svc.max_queue:
                    break
                time.sleep(0.01)
            status, body, hdr, wall = p30_post(url, small)
            errors["overload"] = dict(status=status, seconds=wall,
                                      retry_after=hdr.get("Retry-After"),
                                      waiting=svc.stats()["waiting"])
            require(status == 503 and json.loads(body)["error"]
                    == "overloaded" and hdr.get("Retry-After") == "1",
                    f"phase 30 overload: {errors['overload']}")
        finally:
            svc._lock.release()
            for t in waiters:
                t.join(timeout=120)
        require(len(results) == svc.max_queue
                and all(r[0] == 200 for r in results),
                f"phase 30: the queued requests: {[r[0] for r in results]}")
        print(f"  errors and the held lock: {json.dumps(errors)}", flush=True)

        # The offline `request` CLI: the bytes of the HTTP body.
        req_path = os.path.join(tmp, "shadow.json")
        out_path = os.path.join(tmp, "shadow.npy")
        with open(req_path, "w") as fh:
            json.dump(dict(p30_requests("")["shadow"][0], format="npy"), fh)
        p30_zero()
        t0 = time.perf_counter()
        rc = cli_main(["request", req_path, "--output", out_path])
        cli_s = time.perf_counter() - t0
        with open(out_path, "rb") as fh:
            same_cli = fh.read() == bodies["shadow"]["cold"]
        cli_counts = p30_counts()
        print(f"  request CLI: rc {rc}, {cli_s:.3f} s, bytes equal to the "
              f"HTTP body {same_cli}, launches {json.dumps(cli_counts)}",
              flush=True)
        require(rc == 0 and same_cli and cli_counts["kerr"] > 0
                and cli_counts["plain"] == 0, "phase 30 request CLI")

        stats, _s = p30_get(url, "/stats")
        print(f"  /stats: {json.dumps(stats)}", flush=True)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    try:
        cache = p30_cache(tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  [{time.perf_counter() - t_phase:.1f} s] phase 30 done",
          flush=True)
    return dict(modes=rows, errors=errors, cache=cache)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from light_path_tracer_tpu_torch.models import (Kerr, ReissnerNordstrom,
                                                    Schwarzschild)
    from light_path_tracer_tpu_torch.ops import kerr_trace
    from light_path_tracer_tpu_torch.ops import schwarzschild_trace
    from light_path_tracer_tpu_torch.ops.cuda import _build
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel
    from light_path_tracer_tpu_torch.ops.cuda import schwarzschild_kernel
    from light_path_tracer_tpu_torch.pipeline import (render_scene,
                                                      render_shadow,
                                                      trace_inputs)
    from light_path_tracer_tpu_torch import camera
    from light_path_tracer_tpu_torch.utils.config import (RenderConfig,
                                                          SceneConfig)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()

    def stamp(phase):
        print(f"[{time.perf_counter() - t_start:.0f} s] phase {phase}",
              flush=True)

    # -- 1. machine ------------------------------------------------------
    card = card_line()
    print(card, flush=True)
    nvcc_ver = subprocess.run([_build._nvcc(), "--version"],
                              capture_output=True, text=True, timeout=60,
                              check=True).stdout.strip().splitlines()[-1]
    print(f"machine: {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__} (CUDA {torch.version.cuda}); nvcc: "
          f"{nvcc_ver}", flush=True)

    # -- 2. build --------------------------------------------------------
    stamp(2)
    t0 = time.perf_counter()
    lib = _build.load_library()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s -> {_build.library_path().name}",
          flush=True)
    extras_resources(ptxas_report(lib.build_log), families=("",))
    for name, regs, spill in ptxas_report(lib.build_log):
        r = RESOURCES.get(name)
        more = (f"; {r['blocks_per_sm']} blocks an SM (block bound "
                f"{r['min_blocks']})" if r else "")
        print(f"  ptxas: {name}: {regs} registers; {spill}{more}",
              flush=True)
    # The DP45 mu-chart and Kerr-Newman-extras instances (the "more"
    # library) build beside phases 3 on; phase 23 waits for them.
    more_build = background_build("more")

    # -- 3. kernel vs plain version ---------------------------------------
    stamp(3)
    metric = Kerr(M=1.0, a=0.9)
    ac = metric.alpha_crit(R_OBS)
    rng = np.random.default_rng(0)
    n = 4096
    f32 = dict(dtype=torch.float32, device=dev)
    alphas = torch.tensor(rng.uniform(0.3 * ac, 4 * ac, n), **f32)
    thetas = torch.tensor(rng.uniform(-np.pi, np.pi, n), **f32)
    refine = torch.tensor(rng.random(n) < 0.2, device=dev)
    print("kernel vs plain version (f32 'fast'):", flush=True)
    g4k = both_versions("4096 random rays", metric, alphas, thetas, refine,
                        GATE_STEPS, 5)
    require(g4k["status_agree"] > 0.99 and g4k["p99"] < 2e-3,
            f"4096-ray gate: {g4k}")

    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=R_OBS)
    cfg20k = RenderConfig(max_steps=GATE_STEPS)
    dim128 = (128, 128)
    fov128 = camera.fov_from_vertical(scene.vertical_fov, dim128)
    al, th, rf, _rows = trace_inputs(scene, cfg20k, dim128, fov128, dev)
    g128 = both_versions("128^2 image", metric, al, th, rf, GATE_STEPS, 5)
    require(g128["mask_agree"] >= 0.995,
            f"128^2 shadow masks agree on {g128['mask_agree']:.4f} < 0.995")

    cfg = RenderConfig()
    dim = (1024, 1024)
    fov = camera.fov_from_vertical(scene.vertical_fov, dim)
    al, th, rf, _rows = trace_inputs(scene, cfg, dim, fov, dev)
    gmain = both_versions("1024^2 main-path rays", metric, al, th, rf,
                          cfg.max_steps, 3)
    require(gmain["status_agree"] > 0.99 and gmain["p99"] < 2e-3
            and gmain["mask_agree"] >= 0.995, f"1024^2 gate: {gmain}")
    main_rays = dict(alphas=al, refine=rf, attempts=gmain["attempts"],
                     ms=gmain["ms"])
    del al, th, rf

    # -- 4. main path ------------------------------------------------------
    stamp(4)
    kerr_trace_kernel.trace_rays_kerr_cuda.launches = 0
    kerr_trace.trace_rays_kerr.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    img, stats = render_shadow(scene, dim, cfg, device="cuda")   # warmup
    best = None
    for _ in range(3):
        img, stats = render_shadow(scene, dim, cfg, device="cuda")
        rps = stats["traced_rays"] / stats["timings"]["precompute"]
        best = rps if best is None else max(best, rps)
    launches = kerr_trace_kernel.trace_rays_kerr_cuda.launches
    plain_calls = kerr_trace.trace_rays_kerr.launches
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20
    print(f"main path: kernel launches {launches}, plain-loop calls "
          f"{plain_calls}, traced_rays {stats['traced_rays']}, "
          f"integrator_steps {stats['integrator_steps']}, "
          f"timings {json.dumps(stats['timings'])}, peak device memory "
          f"{peak_mib:.1f} MiB", flush=True)
    require(launches >= 4, f"kernel launch counter is {launches} after "
            f"4 renders")
    require(plain_calls == 0, f"plain loop ran {plain_calls} times on the "
            f"main path")
    require(stats["traced_rays"] == 524288,
            f"traced_rays {stats['traced_rays']} != 524288")
    require(stats["integrator_steps"] > 0, "integrator_steps is 0")
    require(img.shape == dim and img.dtype == torch.float32
            and bool(torch.isfinite(img).all()), "bad image")

    analytic, _ = render_shadow(scene, dim, cfg, analytic=True,
                                device="cuda")
    captured = img == 0.0
    n_cap = int(captured.sum())
    n_disk = int((analytic == 0.0).sum())
    alpha = camera.build_alpha_lookup(dim, fov, device=dev)
    outside = int((captured & (alpha >= 1.01 * ac)).sum())
    ratio = n_cap / max(n_disk, 1)
    print(f"shadow: {n_cap} captured px, alpha_crit disk {n_disk} px, "
          f"ratio {ratio:.4f}, captured outside 1.01 alpha_crit: "
          f"{outside}", flush=True)
    require(0.45 <= ratio <= 0.65, f"captured/analytic ratio {ratio:.4f}")
    require(outside == 0, f"{outside} captured pixels outside the "
            f"1.01 alpha_crit circle")
    print(f"main path 1024^2 Kerr a=0.9 shadow: best {best:,.0f} rays/s "
          f"on {card}", flush=True)
    frame = device_profile(lambda: render_shadow(scene, dim, cfg,
                                                 device="cuda"), 3,
                           "kerr_dp45", kerr_launches)
    print(f"main path frame under torch.profiler (3 frames): "
          f"{json.dumps(frame)}", flush=True)

    # -- 5. orbit kernel vs plain version --------------------------------
    stamp(5)
    orbit_launch = schwarzschild_kernel.trace_rays_schwarzschild_cuda
    orbit_plain = schwarzschild_trace.trace_rays_schwarzschild
    print("orbit kernel vs plain version (f32):", flush=True)
    schw = Schwarzschild(M=1.0)
    for metric in (schw, ReissnerNordstrom(M=1.0, Q=0.6)):
        ac_o = metric.alpha_crit(R_OBS)
        rng = np.random.default_rng(1)
        al_o = torch.tensor(np.concatenate(
            [[0.0], rng.uniform(0.2 * ac_o, 4 * ac_o, 4096)]), **f32)
        g, rk = orbit_both(f"{type(metric).__name__} 4097 rays", metric,
                           al_o, 20)
        require(g["status_agree"] > 0.999 and g["p99"] < 1e-4,
                f"{type(metric).__name__} 4097-ray gate: {g}")
        require(int(rk.status[0]) == 0, "the alpha = 0 lane is not INVALID")
    dim1 = (1024, 1024)
    fov1 = camera.fov_from_vertical(np.radians(40.0), dim1)
    al_grid = camera.build_alpha_lookup(dim1, fov1, device=dev).reshape(-1)
    gorb, _ = orbit_both("Schwarzschild 1024^2 grid", schw, al_grid, 10)
    require(gorb["status_agree"] > 0.999 and gorb["p99"] < 1e-4,
            f"1024^2 orbit gate: {gorb}")
    del al_grid

    # -- 6. config 1: 1024^2 Schwarzschild shadow ---------------------------
    stamp(6)
    scene1 = SceneConfig(M=1.0, r_obs_mult=R_OBS)
    orbit_launch.launches = 0
    orbit_plain.launches = 0
    img1, st1 = render_shadow(scene1, dim1, cfg, device="cuda")   # warmup
    best1 = None
    for _ in range(3):
        img1, st1 = render_shadow(scene1, dim1, cfg, device="cuda")
        rps = st1["traced_rays"] / st1["timings"]["precompute"]
        best1 = rps if best1 is None else max(best1, rps)
    launches1, plain1 = orbit_launch.launches, orbit_plain.launches
    print(f"config 1: orbit kernel launches {launches1}, plain-loop calls "
          f"{plain1}, traced_rays {st1['traced_rays']}, integrator_steps "
          f"{st1['integrator_steps']}, timings "
          f"{json.dumps(st1['timings'])}", flush=True)
    require(launches1 >= 4 and plain1 == 0,
            f"config 1: {launches1} kernel launches, {plain1} plain calls")
    require(st1["traced_rays"] == 1024 * 1024,
            f"config 1 traced_rays {st1['traced_rays']}")
    require(img1.shape == dim1 and bool(torch.isfinite(img1).all()),
            "config 1: bad image")
    ac1 = schw.alpha_crit(R_OBS)
    alpha1 = camera.build_alpha_lookup(dim1, fov1, device=dev)
    cap1 = img1 == 0.0
    n_cap1, n_disk1 = int(cap1.sum()), int((alpha1 < ac1).sum())
    out1 = int((cap1 & (alpha1 >= 1.01 * ac1)).sum())
    ratio1 = n_cap1 / max(n_disk1, 1)
    print(f"config 1 shadow: {n_cap1} captured px, alpha_crit disk "
          f"{n_disk1} px, ratio {ratio1:.4f}, captured outside 1.01 "
          f"alpha_crit: {out1}; best {best1:,.0f} rays/s on {card}",
          flush=True)
    require(0.98 <= ratio1 <= 1.02, f"config 1 ratio {ratio1:.4f}")
    require(out1 == 0, f"config 1: {out1} captured px outside 1.01 "
            f"alpha_crit")
    del img1, alpha1, cap1

    # -- 7. config 2: 512^2 Schwarzschild lensed render ---------------------
    stamp(7)
    src = np.random.default_rng(3).random((512, 512, 3)).astype(np.float32)
    orbit_launch.launches = 0
    orbit_plain.launches = 0
    out2 = render_scene(scene1, src, cfg, device="cuda")        # warmup
    runs = []
    for _ in range(3):
        out2 = render_scene(scene1, src, cfg, device="cuda")
        runs.append(dict(out2.timings))
    launches2, plain2 = orbit_launch.launches, orbit_plain.launches
    best2 = min(runs, key=lambda t: t["total"])
    rps2 = max(out2.precompute.traced_rays / t["precompute"] for t in runs)
    img2 = out2.image
    black = (img2 == 0.0).all(dim=2)
    captured2 = torch.isnan(out2.precompute.final_alpha)
    magenta = torch.tensor([1.0, 0.0, 1.0], device=dev)
    n_magenta = int((img2 == magenta).all(dim=2).sum())
    print(f"config 2: orbit kernel launches {launches2}, plain-loop calls "
          f"{plain2}, traced_rays {out2.precompute.traced_rays}, best "
          f"frame {best2['total'] * 1e3:.3f} ms, precompute {rps2:,.0f} "
          f"rays/s, stages of the best frame (s) {json.dumps(best2)}, "
          f"black px {int(black.sum())}, captured rays "
          f"{int(captured2.sum())}, magenta px {n_magenta} on {card}",
          flush=True)
    require(launches2 >= 4 and plain2 == 0,
            f"config 2: {launches2} kernel launches, {plain2} plain calls")
    require(tuple(img2.shape) == (512, 512, 3)
            and img2.dtype == torch.float32
            and bool(torch.isfinite(img2).all()), "config 2: bad image")
    require(out2.precompute.traced_rays == 512 * 512,
            f"config 2 traced_rays {out2.precompute.traced_rays}")
    require(bool((black == captured2).all()),
            "config 2: black pixels are not the captured rays")

    small = np.random.default_rng(4).random((64, 64, 3)).astype(np.float32)
    cfg_bl = RenderConfig(sampling="bilinear")
    scene_s = SceneConfig(M=1.0, r_obs_mult=R_OBS, vertical_fov_deg=12.0)
    og = render_scene(scene_s, small, cfg_bl, device="cuda")
    oc = render_scene(scene_s, small, cfg_bl, device="cpu")
    mg = torch.isnan(og.precompute.final_alpha).cpu()
    mc = torch.isnan(oc.precompute.final_alpha)
    calm = ((og.precompute.winding.cpu().to(torch.int32) < 2)
            & (oc.precompute.winding.to(torch.int32) < 2))
    rmse = float(((og.image.cpu() - oc.image)[calm] ** 2).mean().sqrt())
    mask_agree = float((mg == mc).float().mean())
    print(f"config 2 check, 64^2 card vs CPU: shadow masks agree "
          f"{mask_agree:.4f}, bilinear RMSE (winding < 2) {rmse:.3e}",
          flush=True)
    require(mask_agree >= 0.99 and rmse < 1e-3,
            f"64^2 card vs CPU: masks {mask_agree:.4f}, RMSE {rmse:.3e}")

    # -- 8. disk kernel vs plain version ---------------------------------
    stamp(8)
    from light_path_tracer_tpu_torch import disk as disk_mod
    from light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel import (
        trace_disk_rays_cuda, trace_disk_rays_plain, trace_disk_rays_two_pass,
        trace_rays_kerr_plain, trace_rays_kerr_two_pass)
    kerr = Kerr(M=1.0, a=0.9)
    disk_cfg = disk_mod.DiskConfig()
    r_in = disk_mod.r_isco(1.0, 0.9)
    opaque = (r_in, disk_cfg.r_out, float(np.pi / 2), True)
    translucent = (r_in, disk_cfg.r_out, float(np.pi / 2), False)
    print("disk kernel vs plain version (f32 'fast'):", flush=True)
    rng = np.random.default_rng(0)
    al_d = torch.tensor(rng.uniform(0.01, 0.12, 4096), **f32)
    th_d = torch.tensor(rng.uniform(-np.pi, np.pi, 4096), **f32)
    disk_both("4096 random rays, opaque", kerr, al_d, th_d, GATE_STEPS,
              opaque, 2, 5)
    disk_both("4096 random rays, translucent, momenta", kerr, al_d, th_d,
              GATE_STEPS, translucent, 2, 5, record_momentum=True)
    scene4 = SceneConfig(M=1.0, a=0.9, r_obs_mult=R_OBS,
                         theta_obs=THETA_DISK)
    fov4 = camera.fov_from_vertical(scene4.vertical_fov, dim)
    grid4 = dict(dtype=torch.float32, device=dev)
    al4 = camera.build_alpha_lookup(dim, fov4, **grid4).reshape(-1)
    th4 = camera.build_theta_lookup(dim, fov4, **grid4).reshape(-1)
    # Capped at the first pass's 512 attempts, for both versions: a
    # near-axis ray of this grid can grind the whole 200,000-attempt
    # budget, and the plain loop costs ~10 ms an iteration at 1M rays.
    gdisk = disk_both("1024^2 config-4 grid, max_steps 512", kerr, al4,
                      th4, 512, opaque, 2, 3)

    # -- 9. two-pass drivers -----------------------------------------------
    stamp(9)
    print("two-pass drivers (pass1_steps 512, slots 8192 unless stated):",
          flush=True)
    drv = {}
    for label, offset in (("aligned", (0.0, 0.0)), ("quarter-pixel offset",
                                                    (0.25, 0.25))):
        al_o = camera.build_alpha_lookup(dim, fov4, pixel_offset=offset,
                                         **grid4).reshape(-1)
        th_o = camera.build_theta_lookup(dim, fov4, pixel_offset=offset,
                                         **grid4).reshape(-1)
        o_args = (kerr, R_OBS, al_o, th_o, THETA_DISK, LAMBDA_MAX,
                  cfg.max_steps, opaque, 2)
        one_ms, r1 = cuda_ms(lambda: trace_disk_rays_cuda(*o_args), 3)
        two_ms, r2 = cuda_ms(lambda: trace_disk_rays_two_pass(*o_args), 3)
        _, unc = trace_disk_rays_cuda(*o_args[:6], 512, opaque, 2,
                                      return_unconverged=True)
        n_unc = int(unc.sum())
        same = disk_bitwise(r1, r2)
        row = dict(single_ms=one_ms, two_pass_ms=two_ms, unconverged=n_unc,
                   bitwise_equal=same, n_steps_single=int(r1.n_steps),
                   n_steps_two_pass=int(r2.n_steps))
        drv[label] = row
        print(f"  disk 1024^2 {label}: {json.dumps(row)}", flush=True)
        require(same or n_unc > 8192, f"disk two-pass {label} differs from "
                f"the single pass with {n_unc} <= 8192 unconverged rays")
    # The driver over the kernel and over the plain loop, on phase 8's
    # 4,096 rays (max_steps 20,000, pass1_steps 64).
    r_args = (kerr, R_OBS, al_d, th_d, THETA_DISK, LAMBDA_MAX, GATE_STEPS,
              opaque, 2)
    two_ms_k, r2k = cuda_ms(lambda: trace_disk_rays_two_pass(
        *r_args, pass1_steps=64), 5)
    two_ms_p, r2p = cuda_ms(lambda: trace_disk_rays_two_pass(
        *r_args, pass1_steps=64, trace_fn=trace_disk_rays_plain), 1)
    probe_d = {}
    same = disk_bitwise(trace_disk_rays_cuda(*r_args, probe=probe_d), r2k)
    g_drv = disk_compare(r2k, r2p)
    g_drv.update(ms=two_ms_k, plain_ms=two_ms_p, bitwise_equal=same,
                 attempts_sum=driver_attempts(probe_d["attempts"], 64))
    print(f"  disk driver, 4096 random rays, pass1_steps 64, kernel vs "
          f"plain loop: {json.dumps(g_drv)}", flush=True)
    require(same, "disk two-pass differs from the single pass at 4096 rays")
    require(g_drv["status_agree"] > 0.99 and g_drv["nhits_agree"] > 0.99
            and g_drv["median_dr"] < 1e-3 and g_drv["p99_dr"] < 0.1,
            f"disk driver gate: {g_drv}")

    al3, th3, rf3, _rows = trace_inputs(scene, cfg, dim, fov, dev)
    k_args = (kerr, R_OBS, al3, th3, np.pi / 2, rf3, LAMBDA_MAX,
              cfg.max_steps)
    one_ms, k1 = cuda_ms(lambda: kerr_trace_kernel.trace_rays_kerr_cuda(
        *k_args), 3)
    two_ms, k2 = cuda_ms(lambda: trace_rays_kerr_two_pass(
        *k_args, pass1_steps=64), 3)
    _, unc = kerr_trace_kernel.trace_rays_kerr_cuda(
        *k_args[:7], 64, return_unconverged=True)
    n_unc = int(unc.sum())
    same = all(same_bits(a, b) for a, b in zip(k1[:3], k2[:3]))
    plain2_ms, k2p = cuda_ms(lambda: trace_rays_kerr_two_pass(
        *k_args, pass1_steps=64, trace_fn=trace_rays_kerr_plain), 1)
    g_k2 = compare(k2, k2p, al3, ac)
    kerr_row = dict(attempts_sum=driver_attempts(gmain["attempts"], 64),
                    single_ms=one_ms, two_pass_ms=two_ms, unconverged=n_unc,
                    bitwise_equal=same, n_steps_single=int(k1.n_steps),
                    n_steps_two_pass=int(k2.n_steps), plain_ms=plain2_ms,
                    kernel_vs_plain=g_k2)
    print(f"  Kerr shadow 1024^2 main-path rays, pass1_steps 64: "
          f"{json.dumps(kerr_row)}", flush=True)
    require(same or n_unc > 8192, f"Kerr two-pass differs from the single "
            f"pass with {n_unc} <= 8192 unconverged rays")
    require(g_k2["status_agree"] > 0.99 and g_k2["p99"] < 2e-3,
            f"Kerr driver kernel vs plain gate: {g_k2}")
    del al3, th3, rf3, k1, k2, k2p, r2k, r2p

    trace_rays_kerr_two_pass.launches = 0
    kerr_trace_kernel.trace_rays_kerr_cuda.launches = 0
    kerr_trace.trace_rays_kerr.launches = 0
    img_tp, st_tp = render_shadow(scene, dim, RenderConfig(
        two_pass=True, pass1_steps=64), device="cuda")
    launches_k2 = trace_rays_kerr_two_pass.launches
    print(f"  render_shadow two_pass=True: driver calls {launches_k2}, "
          f"kernel launches {kerr_trace_kernel.trace_rays_kerr_cuda.launches},"
          f" plain-loop calls {kerr_trace.trace_rays_kerr.launches}, "
          f"precompute {st_tp['timings']['precompute'] * 1e3:.3f} ms",
          flush=True)
    require(launches_k2 == 1 and kerr_trace.trace_rays_kerr.launches == 0
            and kerr_trace_kernel.trace_rays_kerr_cuda.launches == 2,
            "render_shadow two_pass=True did not run the driver over the "
            "kernel")
    require(bool(torch.equal(img_tp, img)) or n_unc > 8192,
            "render_shadow two_pass=True differs from the single pass")

    # -- 10. config 4: 1024^2 thin-disk render ------------------------------
    stamp(10)
    trace_disk_rays_cuda.launches = 0
    trace_disk_rays_two_pass.launches = 0
    kerr_trace.trace_disk_rays_kerr.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    img4, st4 = disk_mod.render_disk(scene4, dim, cfg, disk_cfg,
                                     device="cuda")          # warmup
    best4, runs4 = None, []
    for _ in range(3):
        img4, st4 = disk_mod.render_disk(scene4, dim, cfg, disk_cfg,
                                         device="cuda")
        runs4.append(dict(st4["timings"]))
        rps = st4["traced_rays"] / st4["timings"]["precompute"]
        best4 = rps if best4 is None else max(best4, rps)
    launches4 = trace_disk_rays_cuda.launches
    driver4 = trace_disk_rays_two_pass.launches
    plain4 = kerr_trace.trace_disk_rays_kerr.launches
    peak4 = torch.cuda.max_memory_allocated(dev) / 2**20
    print(f"config 4: disk kernel launches {launches4}, two-pass driver "
          f"calls {driver4}, plain-loop calls {plain4}, disk_pixels "
          f"{st4['disk_pixels']}, captured {st4['captured']}, "
          f"integrator_steps {st4['integrator_steps']}, stages of each run "
          f"(s) {json.dumps(runs4)}, peak device memory {peak4:.1f} MiB",
          flush=True)
    require(launches4 >= 8 and driver4 >= 4 and plain4 == 0,
            f"config 4: {launches4} kernel launches, {driver4} driver calls,"
            f" {plain4} plain calls")
    require(st4["traced_rays"] == 1024 * 1024,
            f"config 4 traced_rays {st4['traced_rays']}")
    require(tuple(img4.shape) == dim and img4.dtype == torch.float32
            and bool(torch.isfinite(img4).all())
            and float(img4.min()) >= 0.0 and float(img4.max()) <= 1.0,
            "config 4: bad image")
    require(st4["disk_pixels"] > 0 and st4["captured"] > 0,
            f"config 4: disk_pixels {st4['disk_pixels']}, captured "
            f"{st4['captured']}")
    left = float(img4[:, :512].double().sum())
    right = float(img4[:, 512:].double().sum())
    beaming = max(left, right) / max(min(left, right), 1e-9)
    print(f"config 4 image: halves {left:.1f} / {right:.1f}, ratio "
          f"{beaming:.3f}; best {best4:,.0f} rays/s on {card}", flush=True)
    require(beaming > 2.0, f"config 4: Doppler half ratio {beaming:.3f}")

    dim64 = (64, 64)
    og, _ = disk_mod.render_disk(scene4, dim64, cfg, disk_cfg, device="cuda")
    oc, _ = disk_mod.render_disk(scene4, dim64, cfg, disk_cfg, device="cpu")
    fov64 = camera.fov_from_vertical(scene4.vertical_fov, dim64)
    masks = []
    for device in ("cuda", "cpu"):
        g64 = dict(dtype=torch.float32, device=device)
        res64 = disk_mod.trace_disk_rays(
            kerr, R_OBS,
            camera.build_alpha_lookup(dim64, fov64, **g64).reshape(-1),
            camera.build_theta_lookup(dim64, fov64, **g64).reshape(-1),
            THETA_DISK, LAMBDA_MAX, cfg.max_steps, disk_cfg)
        masks.append((res64.n_hits > 0).cpu().reshape(dim64))
    mask_agree = float((masks[0] == masks[1]).float().mean())
    both = masks[0] & masks[1]
    d64 = float((og.cpu() - oc).abs()[both].median())
    print(f"config 4 check, 64^2 card vs CPU: disk masks agree "
          f"{mask_agree:.4f}, median |d image| on disk pixels {d64:.3e}",
          flush=True)
    require(mask_agree >= 0.99 and d64 < 1e-3,
            f"64^2 disk card vs CPU: masks {mask_agree:.4f}, median {d64}")

    # -- 11-13. the volumetric and spectral paths ------------------------
    stamp(11)
    # The DOP853 library builds beside phases 11 on (whose kernel-versus-
    # plain comparisons come first; the main-path, config 1, 2 and 4
    # timings are behind); phase 22 waits for it.
    dop853_build = background_build("dop853")
    # The broad instances (phase 26) and the surface kernel (phase 27)
    # build beside them.
    broad_build = background_build("broad")
    surface_build = background_build("surface")
    pool = PlainPool()
    vol_kernels, state = volumetric_phases(dev, card, pool)

    # -- 14-15. the Stokes, movie and order forms and their renders -------
    stamp(14)
    new_kernels = new_mode_phases(dev, card, state)

    # -- 16. the peak probe ------------------------------------------------
    stamp(16)
    probe_kernel, rates = probe_phase(dev, card)

    # -- 17. the float64 instances ----------------------------------------
    stamp(17)
    f64_kernels = float64_phase(dev, card, dict(
        pool=pool, kerr_rays=(alphas, thetas, refine),
        disk_rays=(al_d, th_d),
        opaque=opaque, state=state, main_dim=dim))

    # -- 18. the exact-cycle exit -------------------------------------------
    stamp(18)
    # Phase 19's plain loops on the quarter-offset lanes run beside
    # phases 18-19.
    jobs19 = queue_phase19(pool, dev)
    cycle_phase(card)

    # -- 19. the rays of the reference; the Kerr kernel's booking --------
    stamp(19)
    reference_phase(dev, card, jobs19)

    # -- 20. config 5: the 4k jittered-AA shadow -------------------------
    stamp(20)
    launches5, kernels5 = config5_phase(dev, card, main_rays, pool)

    # -- 21. Kerr-Newman and Johannsen-Psaltis ----------------------------
    stamp(21)
    with cpu_alpha_crit() as cpu_ac:
        family_kernels = families_phase(dev, card, cpu_ac, pool)

    # -- 22. DOP853 and linear event location -----------------------------
    stamp(22)
    d853_kernels = dop853_phase(dev, card, dict(
        build=dop853_build, pool=pool, kerr_rays=(alphas, thetas, refine),
        disk_rays=(al_d, th_d), opaque=opaque, main_dim=dim))

    # -- 23. the mu chart and charged volumetric scenes -------------------
    stamp(23)
    # Phase 26's plain loops at the main paths' 1024^2 shapes run beside
    # phases 23-25.
    grid_jobs26, grids26 = queue_phase26_grids(pool, dev)
    # Phase 29's CPU runs and its runs in children on the card beside
    # phases 23-28.
    jobs29 = queue_phase29(pool, dev)
    mu_kernels = mu_phase(dev, card, dict(rates=rates, build=more_build))

    # -- 24. the disk family: wide instances and every disk render --------
    stamp(24)
    # Phase 27's plain loops and 64^2 CPU renders run beside phases 24-26.
    jobs27 = queue_phase27(pool, dev)
    disk_kernels = disk_family_phase(dev, card, pool, dict(
        disk_rays=(al_d, th_d), cfg=cfg, dop853_build=dop853_build))

    # -- 25. tilted, warped and two-plane disks, crossing times, boost ----
    stamp(25)
    planes_kernels = tilted_phase(dev, card, pool, dict(
        disk_rays=(al_d, th_d), cfg=cfg))

    # -- 26. any width: the broad extras and plane-recorder instances ------
    stamp(26)
    jobs26, rays26 = queue_phase26(pool, dev, al_d, th_d)
    # Phase 28's plain loops and 64^2 CPU renders run beside phases 26-27.
    jobs28 = queue_phase28(pool, dev)
    broad_kernels = broad_phase(dev, card, pool, dict(
        build=broad_build, jobs=jobs26, rays=rays26, grid_jobs=grid_jobs26,
        grids=grids26))

    # -- 27. the surface kernel and the lens-map products ------------------
    stamp(27)
    surface_kernels = surface_phase(dev, card, pool, dict(
        build=surface_build, jobs=jobs27))

    # -- 28. run-time (M, a, r_obs): pans, spin sweeps, flybys; panoramas
    # and the stellar surface ----------------------------------------------
    stamp(28)
    dynamic_kernels = dynamic_phase(dev, card, pool, dict(jobs=jobs28))

    # -- 29. ray, plot, orbit, RK4, user metrics, the fit -----------------
    stamp(29)
    paths_phase(dev, card, pool, dict(jobs=jobs29))
    pool.close()

    # -- 30. the render server ----------------------------------------------
    stamp(30)
    serve_phase(dev, card)
    stamp("retime")
    retime_entries(card)
    stamp("end")

    shadow_work = kerr_work()
    # Bytes a ray: alpha, theta (and the refine byte) in; final_alpha,
    # n_half and the status out, plus p_phi, n_hits and two slots of
    # (r, phi) hits in the disk variant.
    kernels = [
        kernel_entry("kerr_dp45", KERNEL_SOURCE, REPLACES, launches,
                     gmain["max_abs"], gmain["ms"], gmain["plain_ms"],
                     gmain["n"], 9 + 12,
                     gmain["attempts_sum"] * shadow_work, gmain),
        kernel_entry("schwarzschild_rk4", ORBIT_SOURCE, ORBIT_REPLACES,
                     launches1 + launches2, gorb["max_abs"], gorb["ms"],
                     gorb["plain_ms"], gorb["n"], 4 + 13,
                     gorb["attempts_sum"] * orbit_work(), gorb),
        kernel_entry("kerr_dp45_disk", KERNEL_SOURCE, f"{JAX_KERNELS}:316",
                     launches4, gdisk["max_dr"], gdisk["ms"],
                     gdisk["plain_ms"], gdisk["n"], 8 + 20 + 16,
                     gdisk["attempts_sum"] * shadow_work, gdisk),
        kernel_entry("trace_disk_rays_two_pass", DRIVER_SOURCE,
                     f"{JAX_KERNELS}:416", driver4, g_drv["max_dr"],
                     two_ms_k, two_ms_p, int(al_d.numel()), 8 + 20 + 16,
                     g_drv["attempts_sum"] * shadow_work),
        kernel_entry("trace_rays_kerr_two_pass", DRIVER_SOURCE,
                     f"{JAX_KERNELS}:257", launches_k2,
                     g_k2["max_abs"], kerr_row["two_pass_ms"], plain2_ms,
                     gmain["n"], 9 + 12,
                     kerr_row["attempts_sum"] * shadow_work)]
    kernels += (kernels5 + vol_kernels + new_kernels + [probe_kernel]
                + f64_kernels + family_kernels + d853_kernels + mu_kernels
                + disk_kernels + planes_kernels + broad_kernels
                + surface_kernels + dynamic_kernels)
    # The counted bound: every operation by kind at the rate phase 16
    # measured for it (a flop at no less than the published rate).
    for k in kernels:
        ms, by, parts = bounds.counted_bound_ms(
            bounds.Work(k["flops"], k["ops"], k["flops_type"]), k["bytes"],
            rates)
        k.update(bound_counted_ms=ms, bound_counted_by=by,
                 bound_counted_ms_by_kind=parts)
    require(all(k["launches"] > 0 for k in kernels),
            f"a kernel was not launched on its path: "
            f"{[k['name'] for k in kernels if k['launches'] <= 0]}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)
    finally:
        PlainPool.stop_all()
        background_build.stop_all()
