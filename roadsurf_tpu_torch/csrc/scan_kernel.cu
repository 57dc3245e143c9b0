// Whole-forecast scan kernel for NVIDIA Hopper (sm_90a).
//
// Replaces roadsurf_tpu/ops/pallas_step.py:pallas_scan / _make_kernel (the
// Pallas TPU kernel) in three of its modes: K1, point-major (forcing
// [T, 16, P]); K2, slim (forcing [T, 11, P], a time-only traffic friction
// vector, per-point aux rows and the in-kernel post-coupling
// radiation-coefficient decay; pallas_step.py:362-374, :467-509); and K3,
// tile-major (forcing [n_tiles, T, 16 or 11, TP], each tile's steps one
// contiguous slab; pallas_step.py:387-398, :619-629), under either channel
// set, and in its redesigned form K3 fused, which reads no prepared
// forcing at all (below).  Plain version with the same semantics:
// roadsurf_tpu_torch/ops/scan_kernel.py:scan_reference (and, for K3
// fused, scan_fused_reference).
//
// What it computes, per road point, for every step t < nsteps of a chunk
// (pallas_step.py:411-568): the CheckValues failure flag; obs forcing of
// layers 1-2; precipitation into storage; the boundary-layer conductance
// fixed point (at most bl_iters iterations, carried 1/ustar); latent heat
// and evaporation with the one-exp Magnus esat; net radiation; the explicit
// L-layer conduction stencil with HStor; the melting limiter; the storage
// machine (water, snow, ice, secondary ice, deposit, wear, albedo, the
// very-cold flag); a commit masked by the failure flag; and an output row
// where the GLOBAL step (off + t) is a multiple of out_stride.
//
// What bounds it on this card: instruction issue, and on station data the
// divergence of the boundary-layer loop; not bytes.  A 1M x 64 K2 chunk
// moves 3.26 GB (0.97 ms at 3.35 TB/s) and needs 45 G float32 operations
// (0.68 ms at 67 TFLOP/s), yet a select-form body on the caller-order
// chunk takes 6.1 ms (0.5 TB/s; NVIDIA H100 80GB HBM3 at 700 W,
// chip_smoke.py phase 3e).  Each thread runs a serial chain, a time loop
// of about 1,600 SASS instructions: 30 IEEE divides a step (MUFU.RCP +
// refinement + FCHK + a slow-path call each, 16 of them in the stencil),
// a software logf and a sqrtf in every boundary-layer iteration.  A warp
// issues that chain once for 32 points and runs the fixed point (5-40
// iterations) until its slowest lane is done: with the points in the
// caller's order (random stations) a warp issues 13.85 iterations a
// point-step where a lane needs 5.79 (divergence 2.39); the grid chunk,
// whose raster order keeps neighbours in a warp, takes 4.2 ms.
//
// What the design does about it.  One thread per point in a 1-D grid of
// 128-thread blocks (a ragged edge is masked with p < P, so no padding):
// thousands of independent points in flight hide the latency of each
// thread's serial chain.  The profile (L+2 nodes) and the 13 live scalar
// rows stay in registers for the whole launch -- read once, written once --
// with every loop over layers unrolled at compile-time indices (a template
// on the register capacity LM, dispatched on nlayers) so the profile is not
// indexed at run time; the runtime output-depth node is picked with an
// unrolled bit-masked OR for the same reason.  Each thread leaves the
// boundary-layer loop on its own at convergence, which equals the TPU
// kernel's masked freeze.
//   Warp-coherent points: the production engine sorts each block of a
// station run by station (production.py, station_sorted), so a
// warp's lanes mostly share a station's forcing and leave the loop
// together (5.83 warp iterations a point-step for 5.79 a lane).
//   No work a lane does not use: the stable and unstable sides of the
// boundary-layer psi are a branch, not a select, so a warp whose lanes are
// all stable skips the unstable side's sqrtf and logf; the output cadence
// is a counter set once, not an integer modulo and divide each step (CUDA
// has no divide instruction); the forcing pointer steps by a constant; the
// three 1/x forms are the correctly rounded reciprocal __frcp_rn, the bits
// of the IEEE divide without its quotient refinement and range check.
// Every floating-point operation of every lane is the one it was, so the
// results are bit for bit those of the select form in any point order.
//   Registers: 64 for K1 and K2 at <16> (8 blocks of 128 threads an SM,
// half the warp slots), which scan_kernel's launch bound asks of ptxas at
// that instantiation since the body is shared with K5 (without it: 70, 7
// blocks, 4-7% slower); a minimum of 10 or 12 blocks caps them at 48 or
// 40 and spills more (PERF.md, Findings).  The TPU's double-buffered forcing DMA and its inner time
// chunk are dropped: the point-minor layout already coalesces the reads,
// and a step's loads are hidden behind the other warps' thousands of
// cycles of arithmetic.
//
// The slim mode (K2) is the template flag SLIM: the channel stride and
// positions change, TRF is one __ldg broadcast per step from the time-only
// vector (every thread of a step reads the same address), and the four aux
// rows are read once per thread before the time loop.  With `cofs` (a
// runtime flag, uniform across the launch) the radiation coefficients decay
// after each point's window end, computed per step from the aux rows.
//
// The tile-major mode (K3) is a runtime tile width `tp`, not a template:
// channel c of point p at step t is read at
//   forcing + ((p / tp) * T + t) * N * tp + c * tp + p % tp
// (64-bit), so point-major is the case tp = P, and K1, K2 and K3 share one
// body and one set of instantiations.  T is the forcing's allocated step
// count, not nsteps (a ragged last chunk has nsteps < T).  State, aux rows
// and outputs stay point-major in every mode, as in the TPU kernel.  A
// warp's 32 points lie in one tile (tp is a multiple of BLOCK), so a step's
// read of a channel stays one coalesced 128-byte line per warp.
//
// K3 fused (template flag FUSED, entries roadsurf_scan_fused and the fused
// form of roadsurf_scan_sharded) replaces the same TPU mode together with
// the XLA-side forcing prep the TPU needed before it
// (roadsurf_tpu/production.py's window_tm, forcing.prepare_window and the
// slim stack).  On the card that prep was the bottleneck, not the body: per
// 1M x 64 chunk of the NWP grid the eager torch prep took 54-59 ms and
// wrote a 2.95 GB [n_tiles, T, 11, TP] tensor that K3 read back in 3.8 ms.
// Every rule of the prep is elementwise per point and step, so here each
// thread builds its step's 11 channels in registers right before the step
// uses them: the grid part's gap-capped interpolation from the raw series
// rows (the segment lines of the chunk in dynamic shared memory, 2 floats
// a segment a channel a thread, a stage of FuseArgs::stage segments at a
// time: each line computed once a chunk, when the chunk's steps enter its
// stage), the station part's value by a gather at the point's station, the
// source-order merge, CheckValues, the wind floors, sky view (the sun's
// per-point part from time terms formed in float64 on the host, the
// horizon at the nearest degree, ModRadiation), relaxation in float64,
// the precipitation type, the obs forcing and coupling flags, and
// forcing_thermo.  Its bound is operations (the body's plus the prep's,
// about 0.7 ms a 1M x 64 chunk); it reads about 0.55-0.65 GB a chunk, the
// raw rows, state and parameters, instead of 3.26 GB plus the 2.95 GB the
// prep wrote.  What holds it back on this card is the instructions a warp
// issues a point-step (a time loop of about 3,600 SASS instructions, the
// body's 1,600 and the prep's; at 4 schedulers an SM the card issues
// about 1e12 warp instructions a second) and the latency of each lane's
// serial chain of expf/logf/acosf and IEEE divides, which only more warps
// an SM hide.  So the segment lines must never cost the SM a block: the
// host sizes the stage for each launch (ops/scan_kernel.py:stage_width,
// from cudaFuncGetAttributes, the occupancy call and the device's shared
// memory) to the widest power of two that leaves the SM the blocks the
// registers allow (5 at <16>, 96 registers); a grid whose SPAN fits in
// the width keeps its one layout (the hourly grid: SPAN 2).  With the
// SPAN-53 grid's 8 channels a stage of 16 took 128 KB a block and one
// block an SM, and ran 3.3 times slower than a stage of 4 (PERF.md,
// Findings).  The prep issues no work twice that it can form once: the
// step's segment, line offset, time offset and exact-time row once a step
// for every channel (GridStep; the compiler had repeated them for each of
// the ten unrolled channels), the merge branching once on the parts, and
// the per-point inputs (station row, sky view, relaxation differences,
// coupling window, predicates) once a lane before the time loop
// (PointPrep): 3,586 -> 3,213 SASS instructions a time loop, the hourly
// grid chunk 15% faster, bit for bit.  A grid that carries exactly the NWP
// grid's six channels runs an instantiation with that set compiled in
// (CS_NWP): no pointer test a step and the absent channels' work folded
// away, 2,894 instructions a time loop and no spills, the hourly grid
// chunk 7% faster again (PERF.md, Findings).  Each prep
// operation is written with __f*_rn intrinsics
// where torch rounds it on its own, a torch division by a Python scalar
// as its multiply by the reciprocal, precise expf/logf/sinf/cosf/acosf: on
// the card K3 fused equals K3 on the eager prep bit for bit
// (chip_smoke.py phase 3c).
//
// Numerics: float32 only, IEEE divide and sqrt, no fast math, no flush to
// zero, no contraction (built with -prec-div=true -prec-sqrt=true
// -ftz=false -fmad=false): each product and sum rounds on its own, in the
// plain version's order, and a division by a constant is a multiply by its
// correctly rounded reciprocal, as torch divides by a Python scalar on the
// card.  So every mode equals scan_reference on the card bit for bit
// (chip_smoke.py phases 3, 3b, 3c).  That matters beyond the last bit: the
// storage machine is discontinuous in rounding (Storage.f90).  Where a
// step's melt heat Q2Melt was computed from the snow itself, snow - mm is
// a rounding remainder; a positive one is worn into ice, which melts with
// the same mm, and the water takes the melt twice (a 0.054 mm jump, then
// kelvins of tsurf by day; tests/test_torch_scan_kernel.py,
// test_storage_runout_rounding_decides_the_melt).  A body with FMA
// contraction and true divisions parted from the plain version that way in
// 16,275 output elements of a 65,536-point day chunk, by up to 2.37 K.  The
// coefficient decay is written with __fmul_rn/__fsub_rn/__fdiv_rn/
// __fadd_rn and precise expf, as torch's forcing.cof_window rounds it (K2
// with cofs equals K1 fed cof_window's channels bit for bit).  There are
// no matrix products, so TF32 never arises.  min/max propagate NaN like
// torch.minimum/maximum.  Flat offsets are 64-bit: T * 16 * P passes 2^31
// at 128 steps x 1M points.

#include <cuda_runtime.h>
#include <stdint.h>

#define LMAX_ALL 32

// Mirror of ScanConsts in ops/scan_kernel.py (ints first, then floats, all
// 4 bytes: no padding).
struct ScanConsts {
  int L, lpad, out_stride, n_out, bl_iters, use_depth, depth_idx,
      force_snow, force_ice, melt_change;
  float dt, tph, depth_w;
  float vk, log_ustar, log_cond, log_mom, log_heat, stab_c, lvap, lfus, emiss,
      emiss_sb, dry1, dry2, t_lim_cold_h, t_lim_cold_l, max_por_mms,
      por_eva_f, w_wear_lim, w_wet_lim, damp_wear_f, min_wat_mms,
      max_wat_mms, t_lim_dew, wet_snow_form_r, t_lim_melt_snow, melt_heat,
      wet_snow_melt_r, t_lim_freeze, min_snow_mms, max_snow_mms,
      half_max_snow, t_lim_melt_ice, min_ice_mms, max_ice_mms,
      t_lim_melt_dep, min_dep_mms, max_dep_mms, alb_dry, alb_snow, alb_span;
  float dyc[LMAX_ALL], cond_dz[LMAX_ALL], wcont[LMAX_ALL];
};

// packed scalar rows (pallas_step.py:54-57)
enum {
  R_TSURF = 0, R_WAT, R_SNOW, R_ICE, R_ICE2, R_DEP, R_Q2MELT, R_T4MELT,
  R_EVAP, R_BLCOND, R_ALBEDO, R_VERYCOLD, R_FAILED, NROWS = 16
};
// forcing channels (pallas_step.py:63-67)
enum {
  C_TAIR = 0, C_VZ, C_EAIR, C_RAIN, C_SNOW, C_SW, C_LW, C_TSURF_OBS,
  C_VALID, C_TRF, C_SWCOF, C_LWCOF, C_INCPL, C_CPLOBS, C_AIRVCAP, NCH = 16
};
// forcing channel positions of a mode: K1 (all 16) or K2, the slim layout
// of SLIM_CHANNELS (pallas_step.py:75-78)
template <bool SLIM>
struct Ch {
  enum { TAIR = C_TAIR, VZ = C_VZ, EAIR = C_EAIR, RAIN = C_RAIN,
         SNOW = C_SNOW, SW = C_SW, LW = C_LW, TSURF_OBS = C_TSURF_OBS,
         VALID = C_VALID, INCPL = C_INCPL, AIRVCAP = C_AIRVCAP, N = NCH };
};
template <>
struct Ch<true> {
  enum { TAIR = 0, VZ, EAIR, RAIN, SNOW, SW, LW, TSURF_OBS, VALID, INCPL,
         AIRVCAP, N };
};
// aux rows of the slim mode
enum { A_SWCORR = 0, A_LWCORR, A_CEND, A_CPLOBS };
#define N_OUT_FIELDS 8
#define BLOCK 128

// NaN-propagating min/max (jnp.minimum / torch.minimum semantics)
__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Magnus over ice/water, one exp (pallas_step.py:95-101)
__device__ __forceinline__ float esat1(float t) {
  const float a = t < 0.0f ? 21.875f : 17.269f;
  const float b = t < 0.0f ? 265.5f : 237.3f;
  return 0.61078f * expf(a * t / (t + b));
}

// ---- the fused tile-major mode (K3 fused) -------------------------------
// RawForcing fields (forcing.py), the order of FuseArgs' pointer arrays
enum { F_TAIR = 0, F_TDEW, F_VZ, F_RHZ, F_PREC, F_SW, F_LW, F_SWDIR, F_LWNET,
       F_TSOBS, F_PPHASE, NRAW };
// The grid channel sets each fused kernel is instantiated for (template
// parameter CS).  CS_ANY tests a channel's pointer each step it is used;
// CS_NWP fixes at compile time the NWP grid's six channels (tair, vz, rhz,
// prec, sw and lw: the generator's grid, tools/gen_production.py
// --grid-source), so a step tests no pointer and the absent channels'
// work (their values, the dew point's completion from them, the
// precipitation phase) folds away.  The launch picks CS_NWP where the grid
// carries exactly those channels (chan_set), with or without stations.
enum { CS_ANY = 0, CS_NWP = 1 };
constexpr unsigned CS_NWP_MASK = (1u << F_TAIR) | (1u << F_VZ) |
                                 (1u << F_RHZ) | (1u << F_PREC) |
                                 (1u << F_SW) | (1u << F_LW);
// The segment lines a lane holds in shared memory at once: a stage of
// FuseArgs::stage consecutive segments of the window's SPAN (all of them
// when SPAN <= stage), the stage width a power of two chosen for each
// launch on the host (ops/scan_kernel.py:stage_width): the widest whose
// lines, nch * min(SPAN, stage) * 2 * BLOCK floats a block, still let the
// SM hold as many blocks as the kernel's registers allow.  A line depends
// only on its own segment and window (grid_segments), so a stage computed
// when a step enters it holds the same bits as the whole window's lines
// computed at once, whatever the width.
#define MISSING_F (-9999.9f)

// Mirror of FuseArgs in ops/scan_kernel.py (pointers, then ints, then
// floats and the double; checked by size before any launch).  One block's
// raw inputs of one chunk: the grid part's series rows and time machinery
// (GridExpander), the station part's series and index (StationExpander),
// the per-point parameters of the prep and the time-only vectors, all
// indexed by the GLOBAL step where they are time-only.
struct FuseArgs {
  const float* g[NRAW];        // grid rows [n_tiles, K, tp]; null: absent
  const float* trw;            // [K] raw times (s from the first sim step)
  const float* trel;           // [T_pad] sim step times (same origin)
  const int* pos;              // [T_pad] raw position of each step
  const int* pick;             // [T_pad] prec_phase's nearest raw row
  const unsigned char* tex;    // [T_pad] the step falls on a raw time
  const unsigned char* havep;  // [T_pad] a nearest row within the gap cap
  const float* s[NRAW];        // station series [S, T_pad] (prec_phase as
                               // int32); null: no station part
  const long long* sidx;       // [P] station of each point
  const unsigned char* sok;    // [P] the point has a station in radius
  const float* lat;            // per-point parameters [P]
  const float* lon;
  const float* sky;
  const float* hor;            // [P, hor_w] horizon angles
  const int* init_len;
  const int* cstart;
  const int* cend;
  const float* tr_relax;
  const float* vz_relax;
  const float* rh_relax;
  const float* ctsurf;
  const float* anc_t;          // relaxation anchors [P] (null: no relaxation)
  const float* anc_v;
  const float* anc_r;
  const int* hour;             // [T_pad] UTC hour
  const float* sun;            // [4, T_pad] sin_decl, cos_decl, stg, ra
  int has_grid, has_station, grid_last, K, KW, span, k0, lo, complete,
      s_tpad, hor_w, t_total, relax, coupling, force_tsurf, sky_on, flat_hor,
      sun_stride;
  float max_gap, calm_ngt, calm_day, night_on, night_off, min_prec, p_snow,
      p_rain, miss_i, alb_sur, dt_f;
  int stage;                   // segment lines a stage holds (a power of 2)
  double dt, p_snow_d, p_rain_d;
};

// Whether the grid carries channel c: fixed at compile time where CS fixes
// the set, else its pointer.
template <int CS>
__device__ __forceinline__ bool grid_has(const FuseArgs& a, int c) {
  return CS == CS_NWP ? ((CS_NWP_MASK >> c) & 1u) != 0 : a.g[c] != nullptr;
}

// One step's slim channels, prepared in registers.
struct StepIn {
  float tair, vz, eair, rain, snow, sw, lw, obs, valid, incpl, airvcap;
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return nmin(nmax(x, lo), hi);
}
__device__ __forceinline__ double nmaxd(double a, double b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ double nmind(double a, double b) {
  return (a < b || a != a) ? a : b;
}
// a torch float32 division by a Python scalar on the card: a multiply by
// the float reciprocal of the scalar (BinaryDivTrueKernel.cu)
__device__ __forceinline__ float div_s(float x, float b) {
  return __fmul_rn(x, __frcp_rn(b));
}

// Magnus over water at t >= 0, else ice (moisture.esat_air_convention)
__device__ __forceinline__ float esat_air(float t) {
  const float a = t >= 0.0f ? 17.269f : 21.875f;
  const float b = t >= 0.0f ? 237.3f : 265.5f;
  return __fmul_rn(0.61078f, expf(__fdiv_rn(__fmul_rn(a, t), __fadd_rn(t, b))));
}

// moisture.tdew_from_rh, each operation rounded as torch rounds it
__device__ __forceinline__ float tdew_from_rh(float t2m, float rh) {
  const float a = t2m >= 0.0f ? 17.269f : 21.875f;
  const float b = t2m >= 0.0f ? 237.3f : 265.5f;
  const float sat = __fmul_rn(
      0.61078f, expf(__fdiv_rn(__fmul_rn(a, t2m), __fadd_rn(t2m, b))));
  const float epr = __fmul_rn(__fmul_rn(0.01f, rh), sat);
  const float xx = logf(div_s(epr, 0.61078f));
  return __fdiv_rn(__fmul_rn(b, xx), __fsub_rn(a, xx));
}

// moisture.rh_from_tdew
__device__ __forceinline__ float rh_from_tdew(float t2m, float td) {
  return nmin(__fmul_rn(__fdiv_rn(esat_air(td), esat_air(t2m)), 100.0f),
              100.0f);
}

// The raw rows of the grid window the segment lines were computed on
// (GridExpander.plan): the raw position of its first step k0, its first
// raw row lo and its first step's time tr0.  K3 fused's window is its
// chunk's; K5 fused's is the window chunk of the lane's step.
struct GridRows {
  int k0, lo;
  float tr0;
};

// The segments a stage holds for each channel (its channel stride): the
// whole SPAN when it fits in one stage, so such a grid keeps one layout.
__host__ __device__ __forceinline__ int seg_cols(const FuseArgs& a) {
  return a.span < a.stage ? a.span : a.stage;
}

// Step tg's segment on window w (GridExpander.plan's s_t).
__device__ __forceinline__ int grid_seg(const FuseArgs& a, int tg,
                                        const GridRows& w) {
  return clampi(__ldg(a.pos + tg) - w.k0, 0, a.span - 1);
}

// The first segment of the stage holding segment st (st >= 0): a mask,
// the width being a power of two.
__device__ __forceinline__ int stage_of(const FuseArgs& a, int st) {
  return st & -a.stage;
}

// What every continuous channel's grid value at step tg shares, formed
// once a step (GridExpander.evaluate): the offset of the step's segment in
// its stage's lines, the step's time from the window's first step, and
// whether the step falls on a raw time whose row is in the window (then
// the row's offset in the point's column).
struct GridStep {
  int jo;           // float offset of the segment's alpha in seg
  float dtr;        // trel[tg] - tr0
  bool ex;          // an exact-time sample applies
  int64_t xrow;     // its row's offset in a column
};

__device__ __forceinline__ GridStep grid_step(const FuseArgs& a, int tg,
                                              const GridRows& w,
                                              int64_t tp) {
  const int st = grid_seg(a, tg, w);
  const int kg = w.k0 + st;
  return GridStep{2 * (st - stage_of(a, st)) * BLOCK,
                  __fsub_rn(__ldg(a.trel + tg), w.tr0),
                  __ldg(a.tex + tg) && kg < a.K,
                  (int64_t)(w.lo + clampi(kg - w.lo, 0, a.KW - 1)) * tp};
}

// The grid part's value of a continuous channel at step gs: its segment's
// line, or the exact-time valid sample.  col: the point's column of the
// channel's rows (row r at col[r * tp]); seg: the thread's (alpha, beta)
// of each segment of the stage holding the step's segment, BLOCK apart,
// computed on the step's window.
__device__ __forceinline__ float grid_value(const float* col,
                                            const float* seg,
                                            const GridStep& gs) {
  float res = __fadd_rn(seg[gs.jo], __fmul_rn(gs.dtr, seg[gs.jo + BLOCK]));
  if (gs.ex) {
    const float x = __ldg(col + gs.xrow);
    if (x > -9000.0f) res = x;
  }
  return res;
}

// The segment stage of one point (GridExpander.segments), for the
// segments s of the stage from s0: for each continuous channel the grid
// carries, the line through the last valid sample at or before row klm1
// and the next valid one at or after row kl, within the gap cap; stored in
// seg, segment s of channel ci at column ci * seg_cols + s - s0.
template <int CS>
__device__ void grid_segments(const FuseArgs& a, int64_t colbase, int64_t tp,
                              float* seg, const GridRows& w, int s0) {
  const float NEG = -3e38f, POS = 3e38f;
  const int cols = seg_cols(a);
  const int s_end = s0 + cols < a.span ? s0 + cols : a.span;
  int ci = 0;
  for (int c = 0; c < F_PPHASE; ++c) {
    if (!grid_has<CS>(a, c)) continue;
    const float* col = a.g[c] + colbase;
    for (int s = s0; s < s_end; ++s) {
      const int kg = w.k0 + s;
      const int kl = clampi(kg - w.lo, 0, a.KW - 1);
      const int klm1 = clampi(kg - w.lo - 1, 0, a.KW - 1);
      float t1 = NEG, v1 = 0.0f, t2 = POS, v2 = 0.0f;
      for (int k = klm1; k >= 0; --k) {
        const float v = __ldg(col + (int64_t)(w.lo + k) * tp);
        if (v > -9000.0f) {
          t1 = __ldg(a.trw + w.lo + k);
          v1 = v;
          break;
        }
      }
      for (int k = kl; k < a.KW; ++k) {
        const float v = __ldg(col + (int64_t)(w.lo + k) * tp);
        if (v > -9000.0f) {
          t2 = __ldg(a.trw + w.lo + k);
          v2 = v;
          break;
        }
      }
      const float gap = __fsub_rn(t2, t1);
      const bool have = (t1 > NEG * 0.5f) && (t2 < POS * 0.5f) &&
                        (gap <= a.max_gap) && (0 < kg) && (kg < a.K);
      const float invg = gap > 0.0f ? __frcp_rn(gap) : 0.0f;
      const float b = have ? __fmul_rn(__fsub_rn(v2, v1), invg) : 0.0f;
      const int j = ci * cols + s - s0;
      seg[(2 * j) * BLOCK] =
          have ? __fadd_rn(v1, __fmul_rn(__fsub_rn(w.tr0, t1), b))
               : MISSING_F;
      seg[(2 * j + 1) * BLOCK] = b;
    }
    ++ci;
  }
}

// Per-point terms of the sun position (physics/sun.py:sun_at_points) that
// do not change with the step.
struct SunPoint {
  float sin_lat, cos_lat, lonr;
};

__device__ __forceinline__ SunPoint sun_point(const FuseArgs& a, int p) {
  const float pi_f = (float)3.14159265358979323846;
  const float latr = div_s(__fmul_rn(__ldg(a.lat + p), pi_f), 180.0f);
  return SunPoint{sinf(latr), cosf(latr),
                  div_s(__fmul_rn(__ldg(a.lon + p), pi_f), 180.0f)};
}

// The prep's per-point inputs that do not change with the step, read once
// before a lane's time loop: the station row's start, the sky-view factor,
// the relaxation's three differences, the initialisation length and the
// coupling window, with the point's predicates in one flags word.
enum { PP_ST = 1, PP_SKY = 2, PP_RELAX = 4, PP_CPL = 8 };
struct PointPrep {
  int64_t srow;          // the station's first row (0: no station)
  float skyv, d_t, d_v, d_r;
  int init_len, cst, cen;
  unsigned flags;
};

__device__ __forceinline__ PointPrep point_prep(const FuseArgs& a, int p) {
  PointPrep q{};
  const bool st_ok = a.has_station && __ldg(a.sok + p);
  q.srow = st_ok ? (int64_t)__ldg(a.sidx + p) * a.s_tpad : 0;
  q.skyv = __ldg(a.sky + p);
  const bool sky_act = (q.skyv < 1.0f) && (q.skyv > -0.01f);
  bool relax_on = false;
  if (a.relax) {
    const float trl = __ldg(a.tr_relax + p), vrl = __ldg(a.vz_relax + p),
                rrl = __ldg(a.rh_relax + p);
    relax_on = trl >= -100.0f && trl <= 100.0f && vrl >= 0.0f &&
               vrl <= 100.0f && rrl >= 0.0f && rrl <= 110.0f;
    if (relax_on) {
      q.d_t = __fsub_rn(trl, __ldg(a.anc_t + p));
      q.d_v = __fsub_rn(vrl, __ldg(a.anc_v + p));
      q.d_r = __fsub_rn(rrl, __ldg(a.anc_r + p));
    }
  }
  q.init_len = __ldg(a.init_len + p);
  q.cst = __ldg(a.cstart + p);
  q.cen = __ldg(a.cend + p);
  const bool coupling_on =
      q.cen >= 1 && __ldg(a.ctsurf + p) > -100.0f && a.coupling;
  q.flags = (st_ok ? PP_ST : 0u) | (sky_act ? PP_SKY : 0u) |
            (relax_on ? PP_RELAX : 0u) | (coupling_on ? PP_CPL : 0u);
  return q;
}

// The prep of one step of one point, in registers: the raw values of the
// grid and station parts merged in source order (merge_windows), then
// forcing.prepare_window's rules and forcing_thermo, each operation
// rounded as torch rounds it on the card.  Relaxation promotes to float64
// as prepare_window does.
template <int CS>
__device__ __forceinline__ StepIn fused_prep(const FuseArgs& a, int p,
                                             int64_t colbase, int64_t tp,
                                             const float* seg,
                                             const GridRows& w, int tg,
                                             const SunPoint& sp,
                                             const PointPrep& q) {
  // ---- raw values (GridExpander._raw_window, StationExpander.window_tm)
  float raw[F_PPHASE];
  int pphase = -9999;
  const bool st_ok = (q.flags & PP_ST) != 0;
  const int64_t srow = st_ok ? q.srow + tg : 0;
  float gv[F_PPHASE];
  int gpp = -9999;
  if (a.has_grid) {
    const GridStep gs = grid_step(a, tg, w, tp);
    const int cstride = 2 * seg_cols(a) * BLOCK;
    int ci = 0;
#pragma unroll
    for (int c = 0; c < F_PPHASE; ++c) {
      gv[c] = MISSING_F;
      if (grid_has<CS>(a, c)) {
        gv[c] = grid_value(a.g[c] + colbase, seg + ci * cstride, gs);
        ++ci;
      }
    }
    gv[F_RHZ] = gv[F_RHZ] > -9000.0f ? clampf(gv[F_RHZ], 0.0f, 100.0f)
                                     : gv[F_RHZ];
    gv[F_PREC] = gv[F_PREC] > 100.0f ? MISSING_F : gv[F_PREC];
    if (grid_has<CS>(a, F_PPHASE)) {
      const float* col = a.g[F_PPHASE] + colbase;
      const int pc = __ldg(a.pos + tg);
      const float vex =
          __ldg(col + (int64_t)(w.lo + clampi(pc - w.lo, 0, a.KW - 1)) * tp);
      float res;
      if (__ldg(a.tex + tg) && vex > -9000.0f) {
        res = vex;
      } else if (__ldg(a.havep + tg)) {
        res = __ldg(col + (int64_t)(w.lo + clampi(__ldg(a.pick + tg) - w.lo,
                                                   0, a.KW - 1)) * tp);
      } else {
        res = MISSING_F;
      }
      gpp = res > -9000.0f ? (int)res : -9999;
    }
    if (a.complete) {
      // Tdew <-> RH completion (QueryDataSource.cpp:817-828)
      const float t_ = gv[F_TAIR], td = gv[F_TDEW], rh = gv[F_RHZ];
      const bool t_ok = t_ > -9000.0f;
      if (td <= -9000.0f && rh > -9000.0f && t_ok)
        gv[F_TDEW] = tdew_from_rh(t_, rh);
      if (rh <= -9000.0f && td > -9000.0f && t_ok)
        gv[F_RHZ] = rh_from_tdew(t_, td);
    }
  }
  // ---- the merge in source order (merge_windows), branching once on the
  // parts: a grid alone reads no station series
  if (a.has_grid && !a.has_station) {
#pragma unroll
    for (int c = 0; c < F_PPHASE; ++c) raw[c] = gv[c];
    pphase = gpp;
  } else {
#pragma unroll
    for (int c = 0; c < F_PPHASE; ++c) {
      const float thr = c == F_LWNET ? -1000.0f : -100.0f;
      const float sv = (a.s[c] != nullptr && st_ok) ? __ldg(a.s[c] + srow)
                                                    : MISSING_F;
      if (!a.has_grid) raw[c] = sv;
      else if (a.grid_last) raw[c] = gv[c] > thr ? gv[c] : sv;
      else raw[c] = sv > thr ? sv : gv[c];
    }
    const int spp =
        (a.s[F_PPHASE] != nullptr && st_ok)
            ? __ldg(reinterpret_cast<const int*>(a.s[F_PPHASE]) + srow)
            : -9999;
    if (!a.has_grid) pphase = spp;
    else if (a.grid_last) pphase = (float)gpp > -100.0f ? gpp : spp;
    else pphase = (float)spp > -100.0f ? spp : gpp;
  }

  // ---- forcing.prepare_window, one point and step
  const bool last = tg == a.t_total - 1;
  const float skyv = q.skyv;
  const bool sky_act = (q.flags & PP_SKY) != 0;
  const float tair = raw[F_TAIR], tdew = raw[F_TDEW], rhz = raw[F_RHZ];
  const float prec = raw[F_PREC], sw0 = raw[F_SW], lw0 = raw[F_LW];
  bool ok = tair >= -90.0f && tair <= 100.0f && tdew >= -90.0f &&
            tdew <= 100.0f && rhz >= -0.1f && rhz <= 120.0f &&
            raw[F_VZ] >= -1.0f && raw[F_VZ] <= 100.0f && sw0 >= -0.1f &&
            sw0 <= 4000.0f && lw0 >= -0.1f && lw0 <= 1000.0f &&
            prec >= -0.1f && prec <= 500.0f;
  const bool sky_ok = raw[F_SWDIR] >= -0.1f && raw[F_SWDIR] <= 4000.0f &&
                      raw[F_LWNET] >= -1000.0f && raw[F_LWNET] <= 1000.0f;
  ok = ok && (sky_ok || !sky_act);
  const bool valid = ok || last;
  float vz = tg == 0 ? nmax(raw[F_VZ], 0.4f) : raw[F_VZ];
  const float sw_dir = last ? raw[F_SWDIR] : nmin(raw[F_SWDIR], sw0);

  // sky view (physics/sun.py:sun_at_points, physics/radiation.py)
  float sw = sw0, lw = lw0;
  if (a.sky_on && sky_act) {
    const float pi_f = (float)3.14159265358979323846;
    const float two_pi = (float)(2.0 * 3.14159265358979323846);
    const float* sun = a.sun + tg;
    const float sd = __ldg(sun), cd = __ldg(sun + a.sun_stride);
    const float stg = __ldg(sun + 2 * a.sun_stride);
    const float ra = __ldg(sun + 3 * a.sun_stride);
    const float ha0 = __fsub_rn(__fadd_rn(stg, sp.lonr), ra);
    const float cosah = cosf(ha0);
    const float cos_elev = clampf(
        __fadd_rn(__fmul_rn(sd, sp.sin_lat),
                  __fmul_rn(__fmul_rn(cd, sp.cos_lat), cosah)),
        -1.0f, 1.0f);
    const float chi = acosf(cos_elev);
    float elev = __fsub_rn(90.0f, div_s(__fmul_rn(chi, 180.0f), pi_f));
    float ha = ha0 < 0.0f ? __fadd_rn(ha0, two_pi) : ha0;
    ha = ha > two_pi ? __fsub_rn(ha, two_pi) : ha;
    const float cosele =
        cosf(__fsub_rn((float)(3.14159265358979323846 / 2.0), chi));
    const bool small = fabsf(cosele) < 1e-4f;
    const float precos = clampf(
        __fdiv_rn(__fsub_rn(__fmul_rn(sd, sp.cos_lat),
                            __fmul_rn(__fmul_rn(cd, sp.sin_lat), cosah)),
                  small ? 1.0f : cosele),
        -1.0f, 1.0f);
    float azim = acosf(precos);
    azim = ha < pi_f ? __fsub_rn(two_pi, azim) : azim;
    float azim_deg = small ? MISSING_F : div_s(__fmul_rn(azim, 180.0f), pi_f);
    const bool up = elev > 0.0f;
    elev = up ? elev : MISSING_F;
    azim_deg = up ? azim_deg : MISSING_F;
    // modify_radiation (ModRadiation.f90:7-73)
    const float dif_sw = __fsub_rn(sw0, sw_dir);
    const float lw_sur = __fsub_rn(raw[F_LWNET], lw0);
    float horizon = 0.0f;
    if (!a.flat_hor) {
      long long ix = (long long)rintf(azim_deg) % 360;
      if (ix < 0) ix += 360;
      horizon = __ldg(a.hor + (int64_t)p * a.hor_w + clampi((int)ix, 0, 359));
    }
    const float shadow = horizon > elev ? 0.0f : 1.0f;
    const bool sun_up = elev > 0.0f;
    const float sw_dir_m = sun_up ? __fmul_rn(sw_dir, shadow) : sw_dir;
    const float sw_ref = __fadd_rn(__fmul_rn(a.alb_sur, sw_dir_m),
                                   __fmul_rn(a.alb_sur, dif_sw));
    const float one_m = __fsub_rn(1.0f, skyv);
    const float dif_m = __fadd_rn(__fmul_rn(skyv, dif_sw),
                                  __fmul_rn(one_m, sw_ref));
    sw = sun_up ? __fadd_rn(dif_m, sw_dir_m) : sw0;
    lw = __fadd_rn(__fmul_rn(skyv, lw0), __fmul_rn(one_m, -lw_sur));
  }

  // day/night wind floor (SetDayDependendVariables)
  const float hr = (float)__ldg(a.hour + tg);
  const bool night = (hr >= a.night_on) || (hr <= a.night_off);
  const float calm = night ? a.calm_ngt : a.calm_day;
  const float prec_step = __fmul_rn(div_s(prec, 3600.0f), a.dt_f);

  // relaxation (Relaxation.f90:10-47), the wind floor and the
  // precipitation type (calc_prec_type's Koistinen interpretation); with
  // relaxation on, tair, vz and rhz are float64 from the decay on, as in
  // prepare_window, until the final cast
  float tair_o, vz_o, rhz_o;
  bool snowy, rainy;
  if (a.relax) {
    double td_ = (double)tair, vd = (double)vz, rd = (double)rhz;
    const int t0r = q.init_len - 1;
    if (tg >= t0r + 1 && !last && (q.flags & PP_RELAX)) {
      const double decay = exp(__dmul_rn(
          -__dmul_rn(a.dt, (double)(tg - t0r)), 1.0 / (4.0 * 3600.0)));
      td_ = __dsub_rn(td_, __dmul_rn((double)q.d_t, decay));
      vd = __dsub_rn(vd, __dmul_rn((double)q.d_v, decay));
      rd = nmind(__dsub_rn(rd, __dmul_rn((double)q.d_r, decay)), 100.0);
    }
    vd = nmaxd(vd, (double)calm);
    const double pexp =
        __dsub_rn(__dsub_rn(22.0, __dmul_rn(2.7, td_)), __dmul_rn(0.2, rd));
    const double prain = __drcp_rn(__dadd_rn(exp(pexp), 1.0));
    snowy = prain < a.p_snow_d;
    rainy = prain > a.p_rain_d;
    tair_o = (float)td_;
    vz_o = (float)vd;
    rhz_o = (float)rd;
  } else {
    vz = nmax(vz, calm);
    const float pexp = __fsub_rn(__fsub_rn(22.0f, __fmul_rn(2.7f, tair)),
                                 __fmul_rn(0.2f, rhz));
    const float prain = __frcp_rn(__fadd_rn(expf(pexp), 1.0f));
    snowy = prain < a.p_snow;
    rainy = prain > a.p_rain;
    tair_o = tair;
    vz_o = vz;
    rhz_o = rhz;
  }
  // calc_prec_type (Cond.f90:143-249): the phase code where it is known
  const float half = __fmul_rn(prec_step, 0.5f);
  const bool use_phase = ((float)pphase > a.miss_i) && pphase >= 0 &&
                         pphase <= 6;
  float rain, snow;
  if (use_phase) {
    const bool rain_c = pphase == 0 || pphase == 1 || pphase == 4 ||
                        pphase == 5;
    const bool sleet_c = pphase == 2;
    const bool snow_c = pphase == 3 || pphase == 6;
    rain = rain_c ? prec_step : (sleet_c ? half : 0.0f);
    snow = snow_c ? prec_step : (sleet_c ? half : 0.0f);
  } else {
    rain = snowy ? 0.0f : (rainy ? prec_step : half);
    snow = snowy ? prec_step : (rainy ? 0.0f : half);
  }
  if (!(prec_step > a.min_prec)) {
    rain = 0.0f;
    snow = 0.0f;
  }

  // obs forcing of tsurf and the coupling-phase flag (InputOutput.f90:
  // 116-148)
  const int cst = q.cst, cen = q.cen;
  const bool force_phase = (tg + 1) <= q.init_len || a.force_tsurf;
  const bool coupling_on = (q.flags & PP_CPL) != 0;
  const bool before_window = !coupling_on || (tg + 1) < cst;
  const float obs_raw = raw[F_TSOBS];
  const bool forced = force_phase && obs_raw > -100.0f && before_window &&
                      !last;
  const int te = (tg == a.t_total - 1 && a.t_total >= 2) ? tg - 1 : tg;
  const bool in_cpl = coupling_on && (te + 1) >= cst && (te + 1) <= cen;

  // forcing_thermo (ops/scan_kernel.py): eair and rho_air * cp_air
  const float tak = __fadd_rn(tair_o, 273.15f);
  const float air_dens =
      __fmul_rn(__frcp_rn(__fmul_rn(287.05f, tak)), 100000.0f);
  const float d250 = __fsub_rn(tak, 250.0f);
  const float air_hcap =
      __fadd_rn(div_s(__fmul_rn(d250, d250), 3364.0f), 1005.0f);
  const float ea = tair_o < 0.0f ? 21.875f : 17.269f;
  const float eb = tair_o < 0.0f ? 265.5f : 237.3f;
  const float esat_a = __fmul_rn(
      0.61078f,
      expf(__fdiv_rn(__fmul_rn(ea, tair_o), __fadd_rn(tair_o, eb))));

  StepIn in;
  in.tair = tair_o;
  in.vz = vz_o;
  in.eair = __fmul_rn(nmin(__fmul_rn(0.01f, rhz_o), 1.0f), esat_a);
  in.rain = rain;
  in.snow = snow;
  in.sw = sw;
  in.lw = lw;
  in.obs = forced ? obs_raw : MISSING_F;
  in.valid = valid ? 1.0f : 0.0f;
  in.incpl = in_cpl ? 1.0f : 0.0f;
  in.airvcap = __fmul_rn(air_hcap, air_dens);
  return in;
}

// TsurfAve (pallas_step.py:211-215): (T1+T2)/2, or the interpolation at
// the configured output depth.  The runtime node index is resolved by an
// unrolled OR of bit patterns under all-ones/all-zero masks: a select chain
// (if k == idx) is folded back into a dynamic index by the compiler, which
// moves the whole profile to local memory (an 80-byte stack frame at
// LM = 16, ptxas -v).  Exactly one mask is all ones, so the result is the
// selected node's bits, whatever the other nodes hold (inf and NaN too).
template <int LM, bool DEPTH>
__device__ __forceinline__ float surf_ave(const float (&tmp)[LM + 3],
                                          const ScanConsts& c) {
  if (DEPTH) {
    unsigned ti = 0u, tj = 0u;
#pragma unroll
    for (int k = 1; k <= LM + 1; ++k) {
      const unsigned m = 0u - (unsigned)(k == c.depth_idx);
      ti |= __float_as_uint(tmp[k]) & m;
      tj |= __float_as_uint(tmp[k + 1]) & m;
    }
    const float fi = __uint_as_float(ti), fj = __uint_as_float(tj);
    return fi + c.depth_w * (fj - fi);
  }
  return (tmp[1] + tmp[2]) / 2.0f;
}

// A point's packed scalar state (the rows R_TSURF .. R_FAILED), in
// registers for the whole launch.
struct PointState {
  float tsurf, wat, snow, ice, ice2, dep, q2m, t4m, evap, blc, alb, vcold,
      failed;
};

__device__ __forceinline__ PointState load_state(const float* scal,
                                                 int64_t PP, int p) {
  PointState s;
  s.tsurf = scal[R_TSURF * PP + p];
  s.wat = scal[R_WAT * PP + p];
  s.snow = scal[R_SNOW * PP + p];
  s.ice = scal[R_ICE * PP + p];
  s.ice2 = scal[R_ICE2 * PP + p];
  s.dep = scal[R_DEP * PP + p];
  s.q2m = scal[R_Q2MELT * PP + p];
  s.t4m = scal[R_T4MELT * PP + p];
  s.evap = scal[R_EVAP * PP + p];
  s.blc = scal[R_BLCOND * PP + p];
  s.alb = scal[R_ALBEDO * PP + p];
  s.vcold = scal[R_VERYCOLD * PP + p];
  s.failed = scal[R_FAILED * PP + p];
  return s;
}

// The scalar rows written back; the rows past R_FAILED pass through.
__device__ __forceinline__ void store_state(const PointState& s,
                                            const float* scal0, float* scal,
                                            int64_t PP, int p) {
  scal[R_TSURF * PP + p] = s.tsurf;
  scal[R_WAT * PP + p] = s.wat;
  scal[R_SNOW * PP + p] = s.snow;
  scal[R_ICE * PP + p] = s.ice;
  scal[R_ICE2 * PP + p] = s.ice2;
  scal[R_DEP * PP + p] = s.dep;
  scal[R_Q2MELT * PP + p] = s.q2m;
  scal[R_T4MELT * PP + p] = s.t4m;
  scal[R_EVAP * PP + p] = s.evap;
  scal[R_BLCOND * PP + p] = s.blc;
  scal[R_ALBEDO * PP + p] = s.alb;
  scal[R_VERYCOLD * PP + p] = s.vcold;
  scal[R_FAILED * PP + p] = s.failed;
  for (int r = R_FAILED + 1; r < NROWS; ++r) scal[r * PP + p] = scal0[r * PP + p];
}

// The six output fields of a step, at `o` (field k at o[k * PP]).
__device__ __forceinline__ void store_fields(const PointState& s, float* o,
                                             int64_t PP) {
  o[0] = s.tsurf;
  o[1 * PP] = s.wat;
  o[2 * PP] = s.snow;
  o[3 * PP] = s.ice;
  o[4 * PP] = s.ice2;
  o[5 * PP] = s.dep;
}

// A division by a constant is a multiply by its correctly rounded float32
// reciprocal, as torch divides by a Python scalar on the card: the three
// reciprocals the step uses, formed once a thread.
struct StepRecip {
  float inv_dt, inv_vk, inv_melt;
};

__device__ __forceinline__ StepRecip step_recip(const ScanConsts& c) {
  return StepRecip{1.0f / c.dt, 1.0f / c.vk, 1.0f / c.melt_heat};
}

// The whole-scan kernel's step inputs (K1, K2, K3 and K3 fused): each
// channel read from the forcing where the body uses it, or taken from the
// channels K3 fused prepared in registers; TRF, the radiation coefficients
// and the coupling obs from the mode's own source.  The body calls these
// at the places the scan kernel's loop read them.
template <bool SLIM, bool FUSED>
struct ScanIn {
  using K = Ch<SLIM>;
  const float* f;    // the step's forcing at this point (not FUSED)
  int64_t fs;        // its channel stride
  StepIn v;          // FUSED: the prepared channels
  const float* trf;  // SLIM: the time-only traffic friction
  int tg, cofs, t_total;
  float dt, cof_red, a_swc, a_lwc, a_cend, a_obs;
#define IN_CH(NAME, X, FIELD)                                    \
  __device__ __forceinline__ float NAME() const {                \
    return FUSED ? v.FIELD : __ldg(f + K::X * fs);               \
  }
  IN_CH(tair, TAIR, tair)
  IN_CH(vz, VZ, vz)
  IN_CH(eair, EAIR, eair)
  IN_CH(rain, RAIN, rain)
  IN_CH(snow, SNOW, snow)
  IN_CH(sw, SW, sw)
  IN_CH(lw, LW, lw)
  IN_CH(obs, TSURF_OBS, obs)
  IN_CH(valid, VALID, valid)
  IN_CH(incpl, INCPL, incpl)
  IN_CH(airvcap, AIRVCAP, airvcap)
#undef IN_CH
  __device__ __forceinline__ float trf_fric() const {
    return SLIM ? __ldg(trf + tg) : __ldg(f + C_TRF * fs);
  }
  __device__ __forceinline__ float cplobs() const {
    return SLIM ? a_obs : __ldg(f + C_CPLOBS * fs);
  }
  __device__ __forceinline__ void rad_cofs(float& sw_cof,
                                           float& lw_cof) const {
    if (SLIM) {
      // K2's coefficients are 1, or with cofs the decay after the window
      // end (pallas_step.py:475-493): i_eff = tg + 1, but tg at the
      // lastValues step t_total - 1, compared in float32
      sw_cof = 1.0f;
      lw_cof = 1.0f;
      if (cofs) {
        const float i_eff =
            (float)((t_total >= 2 && tg == t_total - 1) ? tg : tg + 1);
        const float expo = __fdiv_rn(
            -__fsub_rn(__fmul_rn(dt, i_eff), __fmul_rn(dt, a_cend)), cof_red);
        const float dec = expf(nmin(expo, 0.0f));
        if ((i_eff >= a_cend) && (a_cend >= 1.0f)) {
          sw_cof = __fadd_rn(1.0f, __fmul_rn(a_swc, dec));
          lw_cof = __fadd_rn(1.0f, __fmul_rn(a_lwc, dec));
        }
      }
      // opaque to the optimiser, like K1's loaded channels: a coefficient
      // known to be 1 (or a select against 1) would let the products of
      // the net radiation be folded or split, and round unlike K1's
      asm("" : "+f"(sw_cof), "+f"(lw_cof));
    } else {
      sw_cof = __ldg(f + C_SWCOF * fs);
      lw_cof = __ldg(f + C_LWCOF * fs);
    }
  }
};

// One step of one point that has not failed (pallas_step.py:411-568), the
// body every kernel of this file runs: the CheckValues flag, obs forcing,
// precipitation, the boundary-layer fixed point, latent heat, net
// radiation, the conduction stencil with HStor, the melting limiter, the
// storage machine and the commit, on the profile `tmp` and the state `s`
// in registers.  `in` is the step's input source (ScanIn above, WinIn of
// the window kernel below).
template <int LM, bool DEPTH, class In>
__device__ __forceinline__ void step_body(const ScanConsts& c,
                                          const StepRecip& k, const In& in,
                                          float (&tmp)[LM + 3],
                                          PointState& s) {
  const int L = c.L;
  const float dt = c.dt;
  const float tph = c.tph;
  const float s2i = (float)(0.25 / 0.45);
  const float tair = in.tair();
  const bool abnormal = (s.tsurf < -100.0f) || (s.tsurf > 100.0f);
  const bool failed = (in.valid() < 0.5f) || abnormal;

  // SetCurrentValues + obs forcing
  const float obs = in.obs();
  tmp[0] = tair;
  if (obs > -100.0f) {
    tmp[1] = obs;
    tmp[2] = obs;
    s.tsurf = surf_ave<LM, DEPTH>(tmp, c);
  }
  const float tsurf = s.tsurf;

  // precipitation to storage
  float wat = s.wat + in.rain();
  float snow = s.snow + in.snow();
  float ice = s.ice, ice2 = s.ice2, dep = s.dep;

  // boundary-layer fixed point (pallas_step.py:104-172): each thread
  // stops at its own convergence, which equals the masked freeze
  const float vz = in.vz();
  const float air_vcap = in.airvcap();
  const float tak = tair + 273.15f;
  const float dt_ts = tsurf - tair;
  const float inv_kvz = __frcp_rn(c.vk * vz);
  const float inv_avt = __frcp_rn(air_vcap * tak);
  float bl = s.blc, psim = 0.0f, psih = 0.0f;
  for (int j = 0; j < c.bl_iters; ++j) {
    const float ustar_inv = (c.log_ustar + psim) * inv_kvz;
    const float bl_new = air_vcap * c.vk / ((c.log_cond + psih) * ustar_inv);
    float stab = c.stab_c * bl_new * dt_ts * inv_avt * ustar_inv *
                 ustar_inv * ustar_inv;
    stab = nmin(stab, 1.0f);
    // a branch, not a select: the unstable side's sqrt and log run only
    // where a lane takes it (a NaN stab is not stable, as the select had)
    if (stab > 0.0f) {
      psih = 4.7f * stab;
      psim = psih;
    } else {
      psih = -2.0f *
             logf((1.0f + sqrtf(nmax(1.0f - 16.0f * stab, 0.0f))) / 2.0f);
      psim = 0.6f * psih;
    }
    const bool newly = (fabsf(bl_new - bl) < 1e-3f) && (j + 1 >= 5);
    bl = bl_new;
    if (newly) break;
  }
  const float raero = nmin((c.log_mom + psim) * (c.log_heat + psih) *
                               (inv_kvz * k.inv_vk),
                           30.0f);
  const float psych_c = 0.1f * (0.00063f * tak + 0.47496f);
  const float wat_den = -0.0050f * tsurf * tsurf + 0.0079f * tsurf +
                        1000.0028f;
  const float esurf = esat1(tsurf);
  float le = air_vcap * (esurf - in.eair()) / (psych_c * raero);
  const float lheat = tsurf >= 0.0f ? c.lvap : c.lfus;
  float evap = le / (lheat * wat_den) * 1000.0f * dt;
  if ((le > 0.0f) && (wat <= 0.0f)) {
    le = 0.0f;
    evap = 0.0f;
  }

  // net radiation
  const float tk = tsurf + 273.15f;
  const float tk2 = tk * tk;
  float sw_cof, lw_cof;
  in.rad_cofs(sw_cof, lw_cof);
  const float rnet = (1.0f - s.alb) * in.sw() * sw_cof +
                     c.emiss * in.lw() * lw_cof - c.emiss_sb * tk2 * tk2;

  // conduction stencil + HStor (pallas_step.py:175-208), in place: layer
  // j's flux uses the old j and j+1, computed before j is overwritten
  const float t1a = (tmp[1] + 3.0f * tmp[2]) / 4.0f;
  float g_prev = rnet - le + in.trf_fric() + bl * (tmp[0] - tmp[1]);
  float hs1 = 0.0f;
#pragma unroll
  for (int j = 1; j <= LM; ++j) {
    if (j <= L) {
      const float tj = tmp[j];
      const float t2_ = tj * tj;
      const float roo =
          tj < 0.0f ? 920.0f : -0.0050f * t2_ + 0.0079f * tj + 1000.0028f;
      const float cw = tj < 0.0f
                           ? 2100.0f
                           : 0.0000102f * t2_ * t2_ - 0.0017169f * t2_ * tj +
                                 0.11516f * t2_ - 3.4739f * tj + 4217.2f;
      const float chwt = roo * cw;
      const float vsh = (j <= 2 ? c.dry1 : c.dry2) + c.wcont[j - 1] * chwt;
      if (j == 1) hs1 = vsh * c.dyc[0] * k.inv_dt;
      // -1/x as the negated correctly rounded reciprocal: the same bits
      // as the IEEE divide, without its quotient refinement and range
      // check
      const float cap_dz = -__frcp_rn(c.dyc[j - 1] * vsh);
      const float gflux = c.cond_dz[j - 1] * (tmp[j + 1] - tj);
      tmp[j] = tj + dt * cap_dz * (gflux - g_prev);
      g_prev = gflux;
    }
  }
  const float tna = (tmp[1] + 3.0f * tmp[2]) / 4.0f;
  const float hstor = hs1 * (tna - t1a);

  // melting limiter (pallas_step.py:218-241)
  const float q2m = s.q2m, t4m = s.t4m;
  const bool has_frozen = (snow > 0.0f) || (ice > 0.0f) || (ice2 > 0.0f);
  float q2 = has_frozen ? q2m : 0.0f;
  if (c.melt_change) {
    const bool in_cpl = in.incpl() > 0.5f;
    const bool guard = (hstor <= 0.00001f) || (tsurf <= t4m) ||
                       (q2m <= 0.0f) || (in_cpl && (in.cplobs() < t4m));
    const bool cold = guard && (tsurf < 0.5f);
    const bool hot = guard && (tsurf > 2.0f);
    const float qavail = hs1 * (tmp[1] - t4m);
    const bool pin = has_frozen && !cold && !hot;
    const bool all_used = q2m >= qavail;
    if (pin) {
      tmp[1] = all_used ? t4m + 0.01f : t4m + (qavail - q2m) / hs1;
      tmp[2] = t4m + 0.01f;
    }
    if (has_frozen && cold) q2 = 0.0f;
    if (has_frozen && hot) q2 = nmin(q2, qavail);
    if (pin && all_used) q2 = qavail;
  }
  const float tsurf_new = surf_ave<LM, DEPTH>(tmp, c);
  const float ts = tsurf_new;

  // WearFactors + RoadCond + CalcAlbedo (pallas_step.py:244-350)
  bool vcold = s.vcold > 0.5f;
  vcold = vcold && !(vcold && (ts > c.t_lim_cold_h));
  vcold = vcold || (!vcold && (ts < c.t_lim_cold_l));

  float snow_tran = nmax(0.45f * snow, 0.01f);
  snow_tran = (snow < 0.2f ? snow_tran * 3.0f : snow_tran) * tph;
  const float ice_wear = nmax((float)(1.1 * 2.0 * 0.145) * ice, 0.01f) * tph;
  const float ice_wear2 =
      nmax((float)(1.1 * 2.0 * 4.0 * 0.290) * ice2, 0.01f) * tph;
  const float dep_wear =
      nmax((float)(0.5 * 2.0 * 4.0 * 0.290) * dep, 0.01f) * tph;
  const float wat_wear = 10.0f * nmax(0.145f * wat, 0.06f) * tph;

  const bool bare =
      (snow <= 0.0f) && (ice <= 0.0f) && (dep <= 0.0f) && (ts > c.t_lim_dew);
  const float loss = wat > c.max_por_mms ? evap : c.por_eva_f * evap;
  if (bare) wat = wat - loss;
  if (wat > 0.0f) {
    const float ww = wat < c.w_wear_lim ? 0.0f : wat_wear;
    const float amt = wat > c.w_wet_lim ? ww : c.damp_wear_f * ww;
    wat = wat - amt;
  }
  if (wat < c.min_wat_mms) wat = 0.0f;
  wat = nmin(wat, c.max_wat_mms);
  const float srf_ext = nmax(wat - c.max_por_mms, 0.0f);

  const float rd = srf_ext + snow;
  const float wsr = rd > 0.001f ? srf_ext / rd : 0.0f;
  const bool snow_wet = (snow > 0.0f) && (wsr > c.wet_snow_form_r);
  if (snow > 0.0f) {
    ice = ice + dep;
    dep = 0.0f;
  }
  const float mm = 1000.0f * (q2 * dt) * k.inv_melt;
  {
    const bool has_snow = snow > 0.0f;
    const bool melt_f = has_snow && c.force_snow;
    const bool melts =
        has_snow && !melt_f && (q2 > 0.0f) && (ts >= c.t_lim_melt_snow);
    if (melt_f) {
      wat = wat + snow;
      snow = 0.0f;
    } else if (melts) {
      wat = wat + mm;
      snow = snow - mm;
    }
  }
  if (snow > 0.0f) {
    snow = snow - snow_tran;
    ice = ice + s2i * snow_tran;
    ice2 = ice2 + s2i * snow_tran;
  }
  {
    const bool wet_block = (snow > 0.0f) && snow_wet;
    if (wet_block && (wsr > c.wet_snow_melt_r)) {
      wat = wat + snow;
      snow = 0.0f;
    }
    if (wet_block && (ts < c.t_lim_freeze)) {
      const float amt2 = snow + wat;
      ice = ice + amt2;
      ice2 = ice2 + amt2;
      snow = 0.0f;
      wat = 0.0f;
    }
  }
  if (snow < c.min_snow_mms) snow = 0.0f;
  if (snow > c.max_snow_mms) snow = snow - c.half_max_snow;

  if ((ts < c.t_lim_freeze) && (wat > 0.0f)) {
    ice = ice + wat;
    ice2 = ice2 + wat;
    wat = 0.0f;
  }
  {
    const bool meltable = (snow <= 0.0f) && (ice > 0.0f);
    const bool melt_f = meltable && c.force_ice;
    const bool melts =
        meltable && !melt_f && (q2 > 0.0f) && (ts >= c.t_lim_melt_ice);
    if (melt_f) {
      wat = wat + ice;
      ice = 0.0f;
      ice2 = 0.0f;
    } else if (melts) {
      wat = wat + mm;
      ice = ice - mm;
      ice2 = ice2 - mm;
    }
  }
  if (ice > 0.0f) ice = ice - ice_wear;
  if (ice2 > 0.0f) ice2 = ice2 - ice_wear2;
  if (ice < c.min_ice_mms) ice = 0.0f;
  ice = nmin(ice, c.max_ice_mms);
  if (ice2 < c.min_ice_mms) ice2 = 0.0f;
  ice2 = nmin(ice2, c.max_ice_mms);

  if (evap < 0.0f) dep = dep - evap;
  if (ts > c.t_lim_melt_dep) {
    wat = wat + dep;
    dep = 0.0f;
  }
  if ((snow <= 0.0f) && (dep > 0.0f)) dep = dep - dep_wear;
  if (dep < c.min_dep_mms) dep = 0.0f;
  if (dep > c.max_dep_mms) wat = wat + dep - c.max_dep_mms;
  dep = nmin(dep, c.max_dep_mms);

  if (wat < c.min_wat_mms) wat = 0.0f;
  wat = nmin(wat, c.max_wat_mms);

  float q2n = 0.0f;
  float t4n = t4m;
  if (snow > 0.0f) {
    q2n = c.melt_heat * (snow * (1.0f / 1000.0f)) * k.inv_dt;
    t4n = c.t_lim_melt_snow;
  } else if (ice > 0.0f) {
    q2n = c.melt_heat * (ice * (1.0f / 1000.0f)) * k.inv_dt;
    t4n = c.t_lim_melt_ice;
  }
  q2n = nmax(q2n, 0.0f);

  const float ice_sum = nmax(0.5f * (ice + ice2) + dep, 0.0f);
  const bool snowy_a = (snow > 0.01f) && (snow > ice);
  const bool icy_a = (ice > 0.01f) || (dep > 0.01f);
  const float icy_alb = ice_sum < 1.5f
                            ? c.alb_dry + (ice_sum * (1.0f / 1.5f)) * c.alb_span
                            : c.alb_snow;

  // commit (this point was active): the profile was updated in place
  s.alb = snowy_a ? c.alb_snow : (icy_a ? icy_alb : c.alb_dry);
  s.tsurf = tsurf_new;
  s.wat = wat;
  s.snow = snow;
  s.ice = ice;
  s.ice2 = ice2;
  s.dep = dep;
  s.q2m = q2n;
  s.t4m = t4n;
  s.evap = evap;
  s.blc = bl;
  s.vcold = vcold ? 1.0f : 0.0f;
  s.failed = nmax(failed ? 1.0f : 0.0f, s.failed);
}

// LM: register capacity for the profile (nlayers <= LM).  tmp[k] holds
// profile row k for k < L + 3 (row L+1 climatology, row L+2 the first
// padded row, read only by the depth interpolation's w == 0 edge).
// DEPTH: a global output depth is configured (StepConfig.use_depth); the
// plain (T1+T2)/2 instantiation needs fewer registers.
// SLIM: K2 (trf [>= off + nsteps], aux [4, P], cofs, t_total, cof_red are
// read only there).  FUSED (with SLIM): K3 fused, the step's channels
// prepared in registers from the raw inputs of `fa` (forcing is not read);
// the segment lines live in dynamic shared memory, BLOCK floats apart.
//
// CS (FUSED): the grid channel set fixed at compile time, or CS_ANY.
//
// The body is scan_points, which scan_kernel runs.
template <int LM, bool DEPTH, bool SLIM, bool FUSED, int CS>
__device__ __forceinline__ void scan_points(
    const ScanConsts& c, const FuseArgs& fa, const float* __restrict__ tmp0,
    const float* __restrict__ scal0, const float* __restrict__ forcing,
    const float* __restrict__ trf, const float* __restrict__ aux,
    float* __restrict__ tmp_out, float* __restrict__ scal_out,
    float* __restrict__ out, int P, int tp, int T, int nsteps, int off,
    int out_base, int cofs, int t_total, float cof_red) {
  using K = Ch<SLIM>;
  extern __shared__ float seg_smem[];
  const int p = blockIdx.x * BLOCK + threadIdx.x;
  if (p >= P) return;
  const int64_t PP = P;
  const int L = c.L;
  // this point's forcing: its tile's slab, at its place in the tile; FS is
  // the channel stride (the tile width)
  const int64_t FS = tp;
  const int64_t tile = p / tp;
  const float* fpt =
      FUSED ? nullptr
            : forcing + tile * (int64_t)T * K::N * FS + (p - tile * FS);
  // K3 fused: the point's column in the grid's tile rows, the chunk's
  // first step time, the segment lines of the first stage and the sun's
  // per-point terms
  const int64_t colbase = tile * (int64_t)fa.K * FS + (p - tile * FS);
  float* seg = seg_smem + threadIdx.x;
  GridRows gw{fa.k0, fa.lo, 0.0f};
  int g_s0 = 0;
  SunPoint sp{0.0f, 0.0f, 0.0f};
  PointPrep pq{};
  if (FUSED) {
    pq = point_prep(fa, p);
    if (fa.has_grid) {
      gw.tr0 = __ldg(fa.trel + off);
      g_s0 = stage_of(fa, grid_seg(fa, off, gw));
      grid_segments<CS>(fa, colbase, FS, seg, gw, g_s0);
    }
    if (fa.sky_on) sp = sun_point(fa, p);
  }

  // K2's per-point aux rows, read once
  float a_swc = 0.0f, a_lwc = 0.0f, a_cend = 0.0f, a_obs = 0.0f;
  if (SLIM) {
    a_swc = aux[A_SWCORR * PP + p];
    a_lwc = aux[A_LWCORR * PP + p];
    a_cend = aux[A_CEND * PP + p];
    a_obs = aux[A_CPLOBS * PP + p];
  }

  float tmp[LM + 3];
#pragma unroll
  for (int k = 0; k < LM + 3; ++k)
    tmp[k] = (k < c.lpad && k < L + 3) ? tmp0[k * PP + p] : 0.0f;
  PointState s = load_state(scal0, PP, p);
  const StepRecip rk = step_recip(c);

  // the output cadence as a counter: the first step t whose global step
  // off + t is a multiple of out_stride, and its row; each hit moves both
  // on (no integer divide in the loop; unsigned, so the step past the last
  // hit cannot overflow)
  const int64_t first = ((int64_t)off + c.out_stride - 1) / c.out_stride;
  unsigned t_hit = (unsigned)(first * c.out_stride - off);
  int row_hit = (int)first - out_base;
  const int64_t f_step = FUSED ? 0 : (int64_t)K::N * FS;

  const float* f = fpt;
  for (int t = 0; t < nsteps; ++t, f += f_step) {
    const int tg = off + t;
    const bool hit = (unsigned)t == t_hit;
    const int row = row_hit;
    if (hit) {
      t_hit += (unsigned)c.out_stride;
      ++row_hit;
    }
    const bool failed_prev = s.failed > 0.5f;

    if (failed_prev) {
      // frozen point: state unchanged, R_FAILED stays set, output poisoned
      if (hit && row < c.n_out) {
        float* o = out + ((int64_t)row * N_OUT_FIELDS) * PP + p;
#pragma unroll
        for (int k = 0; k < 6; ++k) o[k * PP] = -9999.0f;
        o[6 * PP] = 0.0f;
        o[7 * PP] = 0.0f;
      }
      continue;
    }

    // K3 fused prepares the step's channels here, first the segment lines
    // of the next stage where the step enters it (the steps run forward and
    // every lane of a warp is at the same step, so each stage is entered
    // once, by the whole warp); the other modes read them from the forcing
    // where the body uses them
    StepIn in = {};
    if (FUSED) {
      if (fa.has_grid) {
        const int s0 = stage_of(fa, grid_seg(fa, tg, gw));
        if (s0 != g_s0) {
          g_s0 = s0;
          grid_segments<CS>(fa, colbase, FS, seg, gw, s0);
        }
      }
      in = fused_prep<CS>(fa, p, colbase, FS, seg, gw, tg, sp, pq);
    }
    const ScanIn<SLIM, FUSED> src{f,      FS,    in,    trf,   tg,
                                  cofs,   t_total, c.dt, cof_red, a_swc,
                                  a_lwc,  a_cend, a_obs};
    step_body<LM, DEPTH>(c, rk, src, tmp, s);

    if (hit && row < c.n_out) {
      float* o = out + ((int64_t)row * N_OUT_FIELDS) * PP + p;
      store_fields(s, o, PP);
      o[6 * PP] = 0.0f;
      o[7 * PP] = 0.0f;
    }
  }

  // write back: rows 0..L from registers, the rest passed through
#pragma unroll
  for (int k = 0; k <= LM; ++k)
    if (k <= L) tmp_out[k * PP + p] = tmp[k];
  for (int k = L + 1; k < c.lpad; ++k) tmp_out[k * PP + p] = tmp0[k * PP + p];
  store_state(s, scal0, scal_out, PP, p);
}

#define SCAN_KERNEL_PARAMS                                                  \
  const ScanConsts c, const FuseArgs fa, const float* __restrict__ tmp0,    \
      const float* __restrict__ scal0, const float* __restrict__ forcing,   \
      const float* __restrict__ trf, const float* __restrict__ aux,         \
      float* __restrict__ tmp_out, float* __restrict__ scal_out,            \
      float* __restrict__ out, int P, int tp, int T, int nsteps, int off,   \
      int out_base, int cofs, int t_total, float cof_red
#define SCAN_KERNEL_ARGS                                                    \
  c, fa, tmp0, scal0, forcing, trf, aux, tmp_out, scal_out, out, P, tp, T,  \
      nsteps, off, out_base, cofs, t_total, cof_red

// K1 and K2 at LM = 16 without an output depth (the station routes) ask
// ptxas for 8 blocks of 128 threads an SM.  Since the step body is shared
// with K5 (step_body), ptxas gives them 70 registers without that bound (7
// blocks an SM, 4-7% slower a station chunk) where the inline body had 64;
// with it, 64 and a few bytes of spills (PERF.md, Findings).  A minimum
// of 0 is no minimum: the other instantiations build as with the bound
// BLOCK alone, registers and SASS alike (a minimum of 1 does not).
template <int LM, bool DEPTH, bool SLIM, bool FUSED, int CS>
__global__ void __launch_bounds__(BLOCK,
                                  (LM == 16 && !DEPTH && !FUSED) ? 8 : 0)
    scan_kernel(SCAN_KERNEL_PARAMS) {
  scan_points<LM, DEPTH, SLIM, FUSED, CS>(SCAN_KERNEL_ARGS);
}

// The dynamic shared memory of a fused launch: one stage of segment lines
// of each continuous channel the grid carries, for each thread of a block,
// nch * min(SPAN, stage) KB.  The host sizes the stage so that this leaves
// the SM the blocks the registers allow (stage_width); a width past what a
// block may hold is refused at launch, never cut.
static size_t seg_bytes(const FuseArgs& fa) {
  if (!fa.has_grid) return 0;
  int nch = 0;
  for (int k = 0; k < F_PPHASE; ++k) nch += fa.g[k] != nullptr;
  return (size_t)nch * seg_cols(fa) * 2 * BLOCK * sizeof(float);
}

// The channel-set instantiation a fused launch of fa runs (CS_NWP where
// the grid carries exactly its channels).
static int chan_set(const FuseArgs& fa) {
  unsigned m = 0;
  for (int k = 0; k < NRAW; ++k) m |= fa.g[k] != nullptr ? 1u << k : 0u;
  return fa.has_grid && m == CS_NWP_MASK ? CS_NWP : CS_ANY;
}

// A fused launch's FuseArgs: a grid needs a SPAN and a stage width that is
// a power of two.
static bool fuse_ok(const FuseArgs* fa) {
  return fa != nullptr &&
         (!fa->has_grid || (fa->span >= 1 && fa->stage >= 1 &&
                            (fa->stage & (fa->stage - 1)) == 0));
}

// Dispatch on the layer bucket and the output-depth option; returns
// cudaGetLastError() after the launch (0 = ok).  FUSED takes its inputs
// from *fa (then forcing is null and T = nsteps) and its dynamic shared
// memory for the segment lines.
template <bool SLIM, bool FUSED>
static int launch(const ScanConsts* c, const FuseArgs* fa,
                  const float* tmp0, const float* scal0,
                  const float* forcing, const float* trf, const float* aux,
                  float* tmp_out, float* scal_out, float* out, int P,
                  int tp, int T, int nsteps, int off, int out_base, int cofs,
                  int t_total, float cof_red, void* stream) {
  if (P <= 0 || c->L < 1 || c->L > LMAX_ALL || tp <= 0 || P % tp != 0 ||
      (tp != P && tp % BLOCK != 0) || nsteps > T)
    return (int)cudaErrorInvalidValue;
  static const FuseArgs none = {};
  size_t smem = 0;
  if (FUSED) {
    if (!fuse_ok(fa)) return (int)cudaErrorInvalidValue;
    smem = seg_bytes(*fa);
  }
  const FuseArgs& args = FUSED ? *fa : none;
  const int cs = FUSED ? chan_set(*fa) : CS_ANY;
  const dim3 grid((P + BLOCK - 1) / BLOCK);
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH_CS(LM, DEPTH, CS)                                            \
  do {                                                                      \
    auto kern = scan_kernel<LM, DEPTH, SLIM, FUSED, CS>;                    \
    if (FUSED) {                                                            \
      cudaError_t e = cudaFuncSetAttribute(                                 \
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);    \
      if (e != cudaSuccess) return (int)e;                                  \
    }                                                                       \
    kern<<<grid, BLOCK, smem, s>>>(*c, args, tmp0, scal0, forcing, trf, aux, \
                                   tmp_out, scal_out, out, P, tp, T, nsteps, \
                                   off, out_base, cofs, t_total, cof_red);  \
  } while (0)
#define LAUNCH(LM, DEPTH)                                                   \
  do {                                                                      \
    if (cs == CS_NWP) LAUNCH_CS(LM, DEPTH, (FUSED ? CS_NWP : CS_ANY));      \
    else LAUNCH_CS(LM, DEPTH, CS_ANY);                                      \
  } while (0)
  if (c->L <= 16) {
    if (c->use_depth) LAUNCH(16, true); else LAUNCH(16, false);
  } else {
    if (c->use_depth) LAUNCH(32, true); else LAUNCH(32, false);
  }
#undef LAUNCH
#undef LAUNCH_CS
  return (int)cudaGetLastError();
}

// ---- K5, the coupling window (phase B of the coupled run) ---------------
//
// No Pallas counterpart: the JAX package compiles phase B as one jit
// (roadsurf_tpu/production.py:2041-2101), coupling.run_window_passes
// (roadsurf_tpu/coupling.py:466-690) as ONE lax.while_loop with one
// instance of the step graph, which XLA makes one device program.  This
// kernel is the port's counterpart of that program.  Plain version with
// the same semantics: roadsurf_tpu_torch/ops/window_kernel.py:
// window_reference.
//
// What it computes: the global coupling window [ws, we_b] (1-based steps)
// of every point, exactly what run_window_passes does to that point, from
// the state after phase A: the first pass (an uncoupled point steps ws..
// we_b, a coupled one ws..end_i, with the snapshot, the coefficient reset
// and the coefficient choice at start_i, snowIceCheck inside its window and
// Coupling_control at end_i), up to 25 rewinds (restore, the coefficients
// from the choice, a re-run of start_i..end_i whose first step takes the
// pre-rewind row's CheckValues), and the tail end_i+1..we_b with the
// decayed coefficients.  Each step is the scan kernel's step_body; each
// step on an output row writes its slot (a later re-run overwrites it).
//
// What bounds it on this card: operations, not bytes.  A point reads its
// state and its window's forcing once a step it takes and writes its state
// once; the work is the steps the point actually takes, the first pass
// plus each re-run plus the tail, each a scan-kernel step.
//
// What the design does about it.  The TPU and XLA run the window pass by
// pass over all points, every point masked through every row of a pass.
// GPU threads branch on their own, so here each thread runs its own
// point's program counter (the per-point PC engine of coupling.run_coupled,
// coupling.py:9-14): the pass and the step index are registers, a pass
// ends where the point's own range ends, and a point that needs no rewind
// runs no re-run rows.  Lanes of a warp at different steps, or in
// different passes, still run the one step body together: a loop trip
// settles the lane's pass transitions (rewind or tail) and then runs one
// instance of step_body.  The profile and the state stay in registers as
// in K2; the snapshot, written once at start_i and read at each rewind,
// lives in shared memory, L+10 floats a lane (13 KB a block at LM 16), not
// in registers: in global scratch its 64-bit addressing cost ptxas 480
// SASS instructions and 8 bytes of spills, and K5 1-8% more time (PERF.md,
// PR 10).  It starts zeroed, as the plain version's does: a lane whose
// window starts before ws never saves it, and a rewind restores zeros.
// Coupling_control
// is float32 and branch-free as torch's (coupling.py:98-184), rounded as
// torch rounds it on the card.  MAX_RERUNS bounds a lane's rewinds as a
// guard only: the control fails a point at its 25th iteration, so no lane
// reaches it; the host reads the re-run counts and raises past it
// (run_production_coupled).
//
// Two sources of a step's forcing, the template flag FUSED:
//  * the table (K5; the station route, and the routes K3 fused does not
//    take): [W+1 rows, 16, R] in K1's channel layout read at the point's
//    column fidx: the station-rank prepared channels on the station route
//    (R = S+1, so the expanded window never exists), the prepared window
//    itself elsewhere (R = the slice's points);
//  * K5 fused (the routes whose phases A and C run K3 fused: a grid,
//    stations with sky view, a grid + station composite): no table.  On
//    those routes the table was the window's eager prep, 27 GB at 1M
//    points and most of phase B's time (PERF.md, PR 9), cut into point
//    slices to fit.  Here each step's channels come from fused_prep, K3
//    fused's prep in registers from the raw series rows (FuseArgs).  The
//    table route prepares the window in chunks of wtc rows from row ws-1,
//    and the grid's float32 interpolation evaluates each segment line from
//    its chunk's first step, so the lane computes its segment lines
//    (grid_segments, in dynamic shared memory as K3 fused's, a stage of
//    FuseArgs::stage segments at a time) on the raw rows of the window
//    chunk that holds its step (wrows: each window chunk's k0 and lo) and
//    again whenever its step enters another chunk or another stage:
//    forward, or back at a rewind; lanes of a warp at different chunks
//    never share lines, and the lane equals the table route bit for bit.
//    The rewind's CheckValues reads the forcing of row end_i, the row after
//    the pass's last step: the lane prepares it once, in a trip without a
//    step at its first rewind (its position is end_i + 1 then), and keeps
//    its valid flag in a register for every later rewind; that trip may
//    load row end_i's stage, and the re-run's first step loads its own.
//    Its bound is operations, the body's and the prep's; it reads the raw
//    rows of the window (the grid's KW rows of each window chunk, about
//    0.3 GB at 1M points) where K5 read a 27 GB table that eager torch ops
//    had written.  What holds it back is K3 fused's: the instructions a
//    lane step issues, and warps to hide their latency (128 registers at
//    <16>, 4 blocks an SM), plus divergence, lanes of a warp at different
//    passes.  Its stage width leaves the SM those 4 blocks beside the
//    static snapshot ((LM + 10) x BLOCK floats: 13 KB at <16>, 21.5 KB at
//    <32>); a narrower stage also recomputes fewer lines at a rewind.

#define M_FIRST 0
#define M_RERUN 1
#define M_TAIL 2
#define M_DONE 3
#define MAX_RERUNS 64
#define K0_F 273.16f   // Coupling_control works in Kelvin (coupling.py:49)

// Mirror of WinArgs in ops/window_kernel.py (pointers, then ints, then the
// float; checked by size before any launch).  Points [p0, p0 + n) of a
// block of P: per-point arrays of the block at p, fidx at j = p - p0.
// K5 fused reads no table and no fidx (null) but wrows, tp and wtc, and
// runs the whole block (p0 = 0, n = P).
struct WinArgs {
  const float* tmp0;            // [lpad, P] profile after phase A
  const float* scal0;           // [NROWS, P] packed state after phase A
  const float* table;           // [W1, NCH, R] forcing of rows ws-1 .. we_b
  const int* fidx;              // [n] each point's column of the table
  const float* trf;             // [W1] traffic friction of rows ws-1 .. we_b
  const int* cstart;            // [P] coupling_start
  const int* cend;              // [P] coupling_end
  const float* obs;             // [P] coupling obs
  const unsigned char* flags;   // [P] 1: coupled, 2: sky view active
  float* tmp_out;               // [lpad, P]
  float* scal_out;              // [NROWS, P]
  float* rows;                  // [n_out, 6, P] output rows, pre-filled
  float* sw_corr;               // [P]
  float* lw_corr;               // [P]
  unsigned char* cv_failed;     // [P] Coupling_failed
  int* reruns;                  // [P] rewinds of each point
  int* steps;                   // [P] steps each point took
  const int* wrows;             // [ceil(W1 / wtc), 2] each window chunk's
                                // (k0, lo) of the grid part (K5 fused)
  int P, p0, n, R, W1, ws, we_b, T, out_stride, first_hit, n_out;
  int tp, wtc;                  // K5 fused: tile width, window chunk rows
  float cof_red;
};

// Per-point coupling iteration state (coupling.CouplingVars).
struct CplVars {
  float sw_cof, lw_cof, sw_corr, lw_corr, radcoeff, radc_above, radc_below,
      radc_prev, t_above, t_below, tsurf_end1;
  int iterations;
  bool again, failed;
};

// Coupling_control (src/Coupling.f90:292-481; coupling.coupling_control),
// applied: each branch of torch's select form as its float32 operations.
__device__ __forceinline__ void coupling_control(float tsurf_c, float obs_c,
                                                 CplVars& cv) {
  const float t = tsurf_c + K0_F;
  const float ob = obs_c + K0_F;
  const int it = cv.iterations;
  const bool b_maxit = it == 25;
  const bool b_missing = !b_maxit && (ob < (float)(-100.0 + 273.16));
  const bool b_abn = !b_maxit && !b_missing && ((t < 170.0f) || (t > 400.0f));
  const bool prior = b_maxit || b_missing || b_abn;
  const bool b_above = !prior && (t - ob > 0.1f);
  const bool b_below = !prior && !b_above && (ob - t > 0.1f);
  const bool b_success = !(prior || b_above || b_below);
  const float tsurf_end1 = it == 0 ? t : cv.tsurf_end1;
  bool fail_any = b_maxit || b_missing || b_abn;
  const bool again_f = b_maxit ? (fabsf(tsurf_end1 - ob) < fabsf(t - ob))
                               : (b_missing || b_abn);
  // save-nearest updates (:366-375, :414-424)
  const bool upd_above =
      b_above && ((cv.t_above < -100.0f) || (cv.t_above - ob > t - ob));
  float t_above = upd_above ? t : cv.t_above;
  const float radc_above = upd_above ? cv.radcoeff : cv.radc_above;
  const bool upd_below =
      b_below && ((cv.t_below < -100.0f) || (cv.t_below - ob < t - ob));
  float t_below = upd_below ? t : cv.t_below;
  const float radc_below = upd_below ? cv.radcoeff : cv.radc_below;
  const bool have_both = (t_above > -100.0f) && (t_below > -100.0f);
  const float d_above = t_above - ob;
  const float d_below = ob - t_below;
  // torch compares |d| < 1e-300 in float32, where 1e-300 is 0: never true
  const float dsum = d_above + d_below;
  const float denom = fabsf(dsum) < (float)1e-300 ? 1.0f : dsum;
  const float secant = radc_above - d_above / denom * (radc_above - radc_below);
  const float rad_above = have_both ? secant : 0.5f * cv.radcoeff;
  const float rad_below = have_both ? secant : 2.0f * cv.radcoeff;
  float radcoeff = b_above ? rad_above : (b_below ? rad_below : cv.radcoeff);
  const bool stuck =
      (b_above || b_below) && (fabsf(radcoeff - cv.radc_prev) < 0.00005f);
  if (stuck) {
    t_above = -9999.0f;
    t_below = -9999.0f;
  }
  const bool too_small = b_above && (radcoeff < 0.01f);   // :400-408
  fail_any = fail_any || too_small;
  if (too_small) radcoeff = 1.0f;
  const float radc_prev = (b_above || b_below) ? radcoeff : cv.radc_prev;
  // success (:450-474): radcoeff > 3 resets the corrections, not failed
  const bool big = b_success && (cv.radcoeff > 3.0f);
  const float sw_cof_s = big ? 1.0f : cv.sw_cof;
  const float lw_cof_s = big ? 1.0f : cv.lw_cof;
  CplVars n;
  n.sw_cof = fail_any ? 1.0f : (b_success ? sw_cof_s : cv.sw_cof);
  n.lw_cof = fail_any ? 1.0f : (b_success ? lw_cof_s : cv.lw_cof);
  n.sw_corr = fail_any ? 0.0f : (b_success ? sw_cof_s - 1.0f : cv.sw_corr);
  n.lw_corr = fail_any ? 0.0f : (b_success ? lw_cof_s - 1.0f : cv.lw_corr);
  n.radcoeff = (fail_any || b_success) ? 1.0f : radcoeff;
  n.t_above = b_success ? -9999.0f : t_above;
  n.t_below = b_success ? -9999.0f : t_below;
  n.radc_above = b_success ? -9999.0f : radc_above;
  n.radc_below = b_success ? -9999.0f : radc_below;
  n.radc_prev = b_success ? 1.0f : radc_prev;
  n.tsurf_end1 = tsurf_end1;
  n.iterations = b_success ? 0 : it + 1;
  n.again = again_f || b_above || b_below;
  n.failed = (fail_any || (cv.failed && !b_success)) && !b_success;
  cv = n;
}

// snowIceCheck (src/Coupling.f90:259-289; physics/storage.snow_ice_check)
__device__ __forceinline__ void snow_ice_check(const ScanConsts& c, float ob,
                                               PointState& s) {
  if ((ob > c.t_lim_melt_snow) && (s.snow > 0.0f)) {
    s.wat = s.wat + s.snow;
    s.snow = 0.0f;
  }
  const bool warm_ice = ob > c.t_lim_melt_ice;
  if (warm_ice && (s.ice > 0.0f)) {
    s.wat = s.wat + s.ice;
    s.ice = 0.0f;
  }
  if (warm_ice && (s.ice2 > 0.0f)) s.ice2 = 0.0f;
  if ((ob > c.t_lim_melt_dep) && (s.dep > 0.0f)) {
    s.wat = s.wat + s.dep;
    s.dep = 0.0f;
  }
}

// The window kernel's step inputs: the forcing channels from the table row
// at the point's column (K1's layout), or with FUSED from the channels
// fused_prep made; CheckValues, the coupling-phase flag and the radiation
// coefficients from the lane's own program, the coupling obs and the row's
// traffic friction.
template <bool FUSED>
struct WinIn {
  const float* f;
  int64_t fs;
  StepIn v;
  float valid_v, trf_v, sw_cof, lw_cof, obs_v;
  bool incpl_v;
#define IN_CH(NAME, X, FIELD)                       \
  __device__ __forceinline__ float NAME() const {   \
    return FUSED ? v.FIELD : __ldg(f + X * fs);     \
  }
  IN_CH(tair, C_TAIR, tair)
  IN_CH(vz, C_VZ, vz)
  IN_CH(eair, C_EAIR, eair)
  IN_CH(rain, C_RAIN, rain)
  IN_CH(snow, C_SNOW, snow)
  IN_CH(sw, C_SW, sw)
  IN_CH(lw, C_LW, lw)
  IN_CH(obs, C_TSURF_OBS, obs)
  IN_CH(airvcap, C_AIRVCAP, airvcap)
#undef IN_CH
  __device__ __forceinline__ float valid() const { return valid_v; }
  __device__ __forceinline__ float incpl() const {
    return incpl_v ? 1.0f : 0.0f;
  }
  __device__ __forceinline__ float trf_fric() const { return trf_v; }
  __device__ __forceinline__ float cplobs() const { return obs_v; }
  __device__ __forceinline__ void rad_cofs(float& sw, float& lw) const {
    sw = sw_cof;
    lw = lw_cof;
    asm("" : "+f"(sw), "+f"(lw));
  }
};

template <int LM, bool DEPTH, bool FUSED, int CS>
__global__ void __launch_bounds__(BLOCK)
window_kernel(const ScanConsts c, const FuseArgs fa, const WinArgs a) {
  const int j = blockIdx.x * BLOCK + threadIdx.x;
  if (j >= a.n) return;
  const int p = a.p0 + j;
  const int64_t PP = a.P;
  const int L = c.L;
  // the profile rows the snapshot holds (rows 0 .. L+2 that exist)
  const int nsnap = L + 3 < c.lpad ? L + 3 : c.lpad;

  float tmp[LM + 3];
#pragma unroll
  for (int k = 0; k < LM + 3; ++k)
    tmp[k] = (k < c.lpad && k < L + 3) ? a.tmp0[k * PP + p] : 0.0f;
  PointState s = load_state(a.scal0, PP, p);
  const StepRecip rk = step_recip(c);

  const int si = a.cstart[p], ei = a.cend[p];
  const float ob = a.obs[p];
  const unsigned char fl = a.flags[p];
  const bool cpl = (fl & 1) != 0, sky = (fl & 2) != 0;
  const int64_t RS = a.R;                     // channel stride
  const int64_t row_stride = (int64_t)NCH * RS;
  const float* col = FUSED ? nullptr : a.table + __ldg(a.fidx + j);
  // the snapshot: row k of this lane at snap[k * BLOCK]
  __shared__ float snap_s[(LM + 10) * BLOCK];
  float* snap = snap_s + threadIdx.x;
#pragma unroll
  for (int k = 0; k < LM + 10; ++k) snap[k * BLOCK] = 0.0f;
  const float dt = c.dt;

  // K5 fused: the point's column in the grid's tile rows, its segment
  // lines (of the window chunk of table rows [w_lo, w_lo + wtc), the stage
  // from segment w_s0; none yet) and the sun's per-point terms
  extern __shared__ float seg_smem[];
  float* seg = seg_smem + threadIdx.x;
  const int64_t tile = FUSED ? p / a.tp : 0;
  const int64_t colbase =
      FUSED ? tile * (int64_t)fa.K * a.tp + (p - tile * a.tp) : 0;
  GridRows gw{0, 0, 0.0f};
  int w_lo = -2 * a.wtc, w_s0 = 0;
  SunPoint sp{0.0f, 0.0f, 0.0f};
  if (FUSED && fa.sky_on) sp = sun_point(fa, p);
  PointPrep pq{};
  if (FUSED) pq = point_prep(fa, p);
  // K5 fused: the forcing's CheckValues of row end_i, once prepared
  bool have_vrow = false;
  float vrow = 0.0f;

  CplVars cv{1.0f, 1.0f, 0.0f, 0.0f, 1.0f, -9999.0f, -9999.0f,
             1.0f, -9999.0f, -9999.0f, 0.0f, 0, false, ob < -100.0f};
  bool choice = false, vf = false;
  int mode = M_FIRST, i = a.ws;
  int hi = cpl ? (ei < a.we_b ? ei : a.we_b) : a.we_b;
  int nre = 0, nst = 0;

  for (;;) {
    // the pass transitions of run_window_passes for this point: past the
    // end of its pass, rewind (while its control asks) or go to the tail;
    // a failed point takes no step again
    bool prep_only = false;
    while (mode != M_DONE && (i > hi || s.failed > 0.5f)) {
      if (s.failed > 0.5f || mode == M_TAIL || nre > MAX_RERUNS) {
        mode = M_DONE;
      } else if (cv.again && cpl && ei + 1 < a.T) {
        if (FUSED && !have_vrow) {
          // row end_i is not prepared yet: a trip that only prepares it
          // (the lane stands at end_i + 1)
          prep_only = true;
          break;
        }
        // CheckValues of the pre-rewind row end_i on the pre-restore state
        const int vr = clampi(ei - (a.ws - 1), 0, a.W1 - 1);
        const float valid_row =
            FUSED ? vrow : __ldg(col + vr * row_stride + C_VALID * RS);
        vf = !(valid_row < 0.5f) &&
             !((s.tsurf < -100.0f) || (s.tsurf > 100.0f));
        // uploadDataForCoupling: not ice, not q2melt/t4melt/evap/blcond
#pragma unroll
        for (int k = 0; k < LM + 3; ++k)
          if (k < nsnap) tmp[k] = snap[k * BLOCK];
        s.tsurf = snap[(L + 3) * BLOCK];
        s.wat = snap[(L + 4) * BLOCK];
        s.snow = snap[(L + 5) * BLOCK];
        s.ice2 = snap[(L + 6) * BLOCK];
        s.dep = snap[(L + 7) * BLOCK];
        s.alb = snap[(L + 8) * BLOCK];
        s.vcold = snap[(L + 9) * BLOCK];
        cv.again = false;
        cv.sw_cof = choice ? cv.radcoeff : 1.0f;
        cv.lw_cof = choice ? 1.0f : cv.radcoeff;
        ++nre;
        mode = M_RERUN;
        i = si > a.ws ? si : a.ws;
        hi = ei;
      } else {
        mode = M_TAIL;
        i = ei + 1 > a.ws ? ei + 1 : a.ws;
        hi = cpl ? a.we_b : -1;
      }
    }
    if (mode == M_DONE) break;

    // K5 fused: the step's channels, prepared on the segment lines of the
    // window chunk holding table row i - ws (global row i - 1), in the
    // stage holding its segment: computed anew when the step enters another
    // window chunk or another stage (a rewind into an earlier chunk too,
    // whatever its stage)
    StepIn in = {};
    if (FUSED) {
      const int ri = i - a.ws;
      if (fa.has_grid) {
        const bool fresh = (unsigned)(ri - w_lo) >= (unsigned)a.wtc;
        if (fresh) {
          const int k = ri / a.wtc;
          w_lo = k * a.wtc;
          gw.k0 = __ldg(a.wrows + 2 * k);
          gw.lo = __ldg(a.wrows + 2 * k + 1);
          gw.tr0 = __ldg(fa.trel + (a.ws - 1) + w_lo);
        }
        const int s0 = stage_of(fa, grid_seg(fa, i - 1, gw));
        if (fresh || s0 != w_s0) {
          w_s0 = s0;
          grid_segments<CS>(fa, colbase, a.tp, seg, gw, s0);
        }
      }
      in = fused_prep<CS>(fa, p, colbase, a.tp, seg, gw, i - 1, sp, pq);
      if (prep_only) {
        vrow = in.valid;
        have_vrow = true;
        continue;
      }
    }

    // one step at (mode, i): table row i - ws holds global row i - 1
    const float* f = FUSED ? nullptr : col + (int64_t)(i - a.ws) * row_stride;
    bool incpl;
    if (mode == M_FIRST) {
      if (cpl && i == si) {
        if (cv.iterations == 0) {
          // saveDataForCoupling and the coefficient reset (:55-64)
#pragma unroll
          for (int k = 0; k < LM + 3; ++k)
            if (k < nsnap) snap[k * BLOCK] = tmp[k];
          snap[(L + 3) * BLOCK] = s.tsurf;
          snap[(L + 4) * BLOCK] = s.wat;
          snap[(L + 5) * BLOCK] = s.snow;
          snap[(L + 6) * BLOCK] = s.ice2;
          snap[(L + 7) * BLOCK] = s.dep;
          snap[(L + 8) * BLOCK] = s.alb;
          snap[(L + 9) * BLOCK] = s.vcold;
          cv.sw_cof = 1.0f;
          cv.lw_cof = 1.0f;
          cv.sw_corr = 0.0f;
          cv.lw_corr = 0.0f;
        }
        // the coefficient choice (:66-77) at the window-start row
        const float sw = FUSED ? in.sw : __ldg(f + C_SW * RS);
        const float lw = FUSED ? in.lw : __ldg(f + C_LW * RS);
        choice = (sw > lw) && !sky;
      }
      incpl = cpl && i >= si && i <= ei;
    } else {
      // a re-run's first step ran with the pre-rewind index: flag false
      incpl = mode == M_RERUN && i > si && i <= ei;
    }
    const float valid = (mode == M_RERUN && i == si)
                            ? (vf ? 1.0f : 0.0f)
                            : (FUSED ? in.valid : __ldg(f + C_VALID * RS));
    if (incpl) snow_ice_check(c, ob, s);
    float swc = cv.sw_cof, lwc = cv.lw_cof;
    if (mode == M_TAIL) {
      // the post-window decay (:82-88), IEEE division by the runtime tau
      const float expo = __fdiv_rn(
          -__fsub_rn(__fmul_rn(dt, (float)i), __fmul_rn(dt, (float)ei)),
          a.cof_red);
      const float dec = expf(nmin(expo, 0.0f));
      swc = __fadd_rn(1.0f, __fmul_rn(cv.sw_corr, dec));
      lwc = __fadd_rn(1.0f, __fmul_rn(cv.lw_corr, dec));
    }
    const WinIn<FUSED> win{f,   RS,  in, valid, __ldg(a.trf + (i - a.ws)),
                           swc, lwc, ob, incpl};
    step_body<LM, DEPTH>(c, rk, win, tmp, s);

    // SaveOutput (overwritten by a later re-run of the row)
    const int r = i - 1;
    if (r % a.out_stride == 0) {
      const int slot = (r - a.first_hit) / a.out_stride;
      if (slot >= 0 && slot < a.n_out)
        store_fields(s, a.rows + ((int64_t)slot * 6) * PP + p, PP);
    }
    // CheckEndCoupling (:98-118), never in the tail
    if (mode != M_TAIL && cpl && i == ei && !cv.failed && !(s.failed > 0.5f))
      coupling_control(s.tsurf, ob, cv);
    ++i;
    ++nst;
  }

  // write back: the profile rows the window can change from registers
  // (the snapshot restores rows 0 .. L+2), the rest passed through
#pragma unroll
  for (int k = 0; k < LM + 3; ++k)
    if (k < nsnap) a.tmp_out[k * PP + p] = tmp[k];
  for (int k = nsnap; k < c.lpad; ++k)
    a.tmp_out[k * PP + p] = a.tmp0[k * PP + p];
  store_state(s, a.scal0, a.scal_out, PP, p);
  a.sw_corr[p] = cv.sw_corr;
  a.lw_corr[p] = cv.lw_corr;
  a.cv_failed[p] = cv.failed ? 1 : 0;
  a.reruns[p] = nre;
  a.steps[p] = nst;
}

// K5 (FUSED false: the table) or K5 fused on `stream`: points [a->p0,
// a->p0 + a->n) of a->P; returns cudaGetLastError() after the launch (0 =
// ok).  K5 fused takes its inputs from *fa and *a's wrows, runs every
// point of the block, and its dynamic shared memory holds the segment lines.
// The default limit of 48 KB a block holds the static snapshot and the
// dynamic part together, so K5 fused always declares its dynamic part (the
// stage the host chose; a part past what a block may hold is refused).
template <bool FUSED>
static int launch_window(const ScanConsts* c, const FuseArgs* fa,
                         const WinArgs* a, void* stream) {
  if (a == nullptr || a->n <= 0 || a->p0 < 0 || a->p0 + a->n > a->P ||
      a->W1 < 2 || a->ws < 1 || a->we_b < a->ws ||
      a->we_b - a->ws + 2 != a->W1 || a->we_b > a->T - 1 ||
      a->out_stride < 1 || a->n_out < 1 || c->L < 1 || c->L > LMAX_ALL ||
      c->lpad < c->L + 2)
    return (int)cudaErrorInvalidValue;
  static const FuseArgs none = {};
  size_t smem = 0;
  if (FUSED) {
    if (!fuse_ok(fa) || a->p0 != 0 || a->n != a->P || a->tp <= 0 ||
        a->P % a->tp != 0 || a->tp % BLOCK != 0 || a->wtc < 1 ||
        (fa->has_grid && a->wrows == nullptr))
      return (int)cudaErrorInvalidValue;
    smem = seg_bytes(*fa);
  } else if (a->table == nullptr || a->fidx == nullptr || a->R <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const FuseArgs& args = FUSED ? *fa : none;
  const int cs = FUSED ? chan_set(*fa) : CS_ANY;
  const dim3 grid((a->n + BLOCK - 1) / BLOCK);
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH_WCS(LM, DEPTH, CS)                                           \
  do {                                                                      \
    auto kern = window_kernel<LM, DEPTH, FUSED, CS>;                        \
    if (FUSED) {                                                            \
      cudaError_t e = cudaFuncSetAttribute(                                 \
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);    \
      if (e != cudaSuccess) return (int)e;                                  \
    }                                                                       \
    kern<<<grid, BLOCK, smem, s>>>(*c, args, *a);                           \
  } while (0)
#define LAUNCH_W(LM, DEPTH)                                                 \
  do {                                                                      \
    if (cs == CS_NWP) LAUNCH_WCS(LM, DEPTH, (FUSED ? CS_NWP : CS_ANY));     \
    else LAUNCH_WCS(LM, DEPTH, CS_ANY);                                     \
  } while (0)
  if (c->L <= 16) {
    if (c->use_depth) LAUNCH_W(16, true); else LAUNCH_W(16, false);
  } else {
    if (c->use_depth) LAUNCH_W(32, true); else LAUNCH_W(32, false);
  }
#undef LAUNCH_W
#undef LAUNCH_WCS
  return (int)cudaGetLastError();
}

// occupancy_info: roadsurf_fused_info's figures for one instantiation.
template <class Kern>
static int occupancy_info(Kern kern, int dyn_smem, int* info) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kern);
  if (e != cudaSuccess) return (int)e;
  const cudaDeviceAttr attrs[3] = {
      cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrMaxSharedMemoryPerBlockOptin,
      cudaDevAttrReservedSharedMemoryPerBlock};
  for (int k = 0; k < 3; ++k) {
    e = cudaDeviceGetAttribute(info + 4 + k, attrs[k], dev);
    if (e != cudaSuccess) return (int)e;
  }
  if (dyn_smem < 0 || dyn_smem > info[5] - (int)fa.sharedSizeBytes)
    return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           dyn_smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(info + 2, kern, BLOCK,
                                                      0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(info + 3, kern, BLOCK,
                                                      (size_t)dyn_smem);
  info[0] = fa.numRegs;
  info[1] = (int)fa.sharedSizeBytes;
  return (int)e;
}


extern "C" {

// K1 on `stream`: forcing [T, 16, P] (tp = P), or K3 with 16 channels:
// [P / tp, T, 16, tp].
int roadsurf_scan(const ScanConsts* c, const float* tmp0, const float* scal0,
                  const float* forcing, float* tmp_out, float* scal_out,
                  float* out, int P, int tp, int T, int nsteps, int off,
                  int out_base, void* stream) {
  return launch<false, false>(c, nullptr, tmp0, scal0, forcing, nullptr,
                              nullptr, tmp_out, scal_out, out, P, tp, T,
                              nsteps, off, out_base, 0, 0, 1.0f, stream);
}

// K2 on `stream`: forcing [T, 11, P] (tp = P), or K3 slim: [P / tp, T, 11,
// tp]; trf [>= off + nsteps], aux [4, P]; cofs != 0 decays the radiation
// coefficients (t_total, cof_red).
int roadsurf_scan_slim(const ScanConsts* c, const float* tmp0,
                       const float* scal0, const float* forcing,
                       const float* trf, const float* aux, float* tmp_out,
                       float* scal_out, float* out, int P, int tp, int T,
                       int nsteps, int off, int out_base, int cofs,
                       int t_total, float cof_red, void* stream) {
  return launch<true, false>(c, nullptr, tmp0, scal0, forcing, trf, aux,
                             tmp_out, scal_out, out, P, tp, T, nsteps, off,
                             out_base, cofs, t_total, cof_red, stream);
}

// K3 fused on `stream`: K3 slim with each step's channels prepared in the
// kernel from the raw inputs of *fa (no forcing tensor); tile width tp,
// trf [>= off + nsteps], aux [4, P], cofs as roadsurf_scan_slim.
int roadsurf_scan_fused(const ScanConsts* c, const FuseArgs* fa,
                        const float* tmp0, const float* scal0,
                        const float* trf, const float* aux, float* tmp_out,
                        float* scal_out, float* out, int P, int tp,
                        int nsteps, int off, int out_base, int cofs,
                        int t_total, float cof_red, void* stream) {
  return launch<true, true>(c, fa, tmp0, scal0, nullptr, trf, aux, tmp_out,
                            scal_out, out, P, tp, nsteps, nsteps, off,
                            out_base, cofs, t_total, cof_red, stream);
}

// K4, the sharded launch.  Replaces
// roadsurf_tpu/parallel/sharding.py:pallas_scan_sharded (shard_map over the
// points axis of a device mesh, the kernel launched on each device's block,
// no collective).  It has no arithmetic of its own, so what bounds it is
// what bounds its blocks: the bytes of K1-K3 over the memory rate of the
// card a block lies on; several blocks on one card share that card.  The
// design keeps the host out of the way: one call for all blocks, each
// launch asynchronous on its block's stream, nothing synchronised.
// The points are split into n contiguous blocks,
// block b on device ordinal devices[b], and each block's chunk is one launch
// of the kernel above on streams[b] (a stream of that device).  Per block:
// the pointers of roadsurf_scan / roadsurf_scan_slim, its point count P[b]
// and its tile width tp[b]; trf and aux are read when slim != 0 (trf[b] is
// the copy of the time-only vector on that block's device).  With `fused`
// (an array of n FuseArgs, slim != 0) each block runs K3 fused on its own
// raw inputs fused[b] and forcing is not read.  The constants, the chunk
// geometry and the decay arguments are the same for every block.
// One host call, no synchronisation; the caller's device is restored.
// Returns the first CUDA error (0 = ok) and, through failed_block, the block
// it came from (-1 when it is not a block's: the device query or restore).
int roadsurf_scan_sharded(const ScanConsts* c, int n, const int* devices,
                          void* const* streams, const float* const* tmp0,
                          const float* const* scal0,
                          const float* const* forcing,
                          const float* const* trf, const float* const* aux,
                          float* const* tmp_out, float* const* scal_out,
                          float* const* out, const int* P, const int* tp,
                          int T, int nsteps, int off, int out_base, int slim,
                          int cofs, int t_total, float cof_red,
                          const FuseArgs* fused, int* failed_block) {
  *failed_block = -1;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  int caller = 0;
  cudaError_t err = cudaGetDevice(&caller);
  if (err != cudaSuccess) return (int)err;
  int rc = 0;
  for (int b = 0; b < n && rc == 0; ++b) {
    err = cudaSetDevice(devices[b]);
    if (err != cudaSuccess) {
      rc = (int)err;
    } else if (fused != nullptr) {
      rc = launch<true, true>(c, fused + b, tmp0[b], scal0[b], nullptr,
                              trf[b], aux[b], tmp_out[b], scal_out[b],
                              out[b], P[b], tp[b], nsteps, nsteps, off,
                              out_base, cofs, t_total, cof_red, streams[b]);
    } else if (slim) {
      rc = launch<true, false>(c, nullptr, tmp0[b], scal0[b], forcing[b],
                               trf[b], aux[b], tmp_out[b], scal_out[b],
                               out[b], P[b], tp[b], T, nsteps, off, out_base,
                               cofs, t_total, cof_red, streams[b]);
    } else {
      rc = launch<false, false>(c, nullptr, tmp0[b], scal0[b], forcing[b],
                                nullptr, nullptr, tmp_out[b], scal_out[b],
                                out[b], P[b], tp[b], T, nsteps, off,
                                out_base, 0, 0, 1.0f, streams[b]);
    }
    if (rc != 0) *failed_block = b;
  }
  err = cudaSetDevice(caller);
  if (rc == 0 && err != cudaSuccess) rc = (int)err;
  return rc;
}

// K5, the coupling window, on `stream` (WinArgs above).
int roadsurf_window(const ScanConsts* c, const WinArgs* a, void* stream) {
  return launch_window<false>(c, nullptr, a, stream);
}

// K5 fused on `stream`: the window of a whole block with each step's
// channels prepared in the kernel from the raw inputs of *fa.
int roadsurf_window_fused(const ScanConsts* c, const FuseArgs* fa,
                          const WinArgs* a, void* stream) {
  return launch_window<true>(c, fa, a, stream);
}

// The occupancy figures of the fused instantiation that a launch of *fa
// with nlayers layers runs (window: K5 fused, else K3 fused; its channel
// set, chan_set) on the current device, for the stage width rule
// (ops/scan_kernel.py:stage_width) and its reports: info[0] registers a
// thread, [1] static shared memory a block, [2] blocks an SM with no
// dynamic shared memory (what registers, warps and static shared memory
// allow), [3] blocks an SM at dyn_smem bytes of dynamic shared memory, [4]
// shared memory an SM, [5] the most a block may opt in to, [6] the shared
// memory reserved for each block, [7] the channel set (CS_ANY, CS_NWP).
// Returns a CUDA error (0 = ok); dyn_smem past what a block may hold is
// refused.
int roadsurf_fused_info(const FuseArgs* fa, int window, int nlayers,
                        int use_depth, int dyn_smem, int* info) {
  if (fa == nullptr || nlayers < 1 || nlayers > LMAX_ALL)
    return (int)cudaErrorInvalidValue;
  const int cs = chan_set(*fa);
  info[7] = cs;
#define INFO_CS(LM, DEPTH, CS)                                              \
  return window ? occupancy_info(window_kernel<LM, DEPTH, true, CS>,        \
                                 dyn_smem, info)                            \
                : occupancy_info(scan_kernel<LM, DEPTH, true, true, CS>,    \
                                 dyn_smem, info)
#define INFO(LM, DEPTH)                                                     \
  do {                                                                      \
    if (cs == CS_NWP) INFO_CS(LM, DEPTH, CS_NWP);                           \
    INFO_CS(LM, DEPTH, CS_ANY);                                             \
  } while (0)
  if (nlayers <= 16) {
    if (use_depth) INFO(16, true); else INFO(16, false);
  } else {
    if (use_depth) INFO(32, true); else INFO(32, false);
  }
#undef INFO
#undef INFO_CS
}

// sizeof(ScanConsts), sizeof(FuseArgs) and sizeof(WinArgs), checked
// against the ctypes mirrors before any launch
int roadsurf_consts_size(void) { return (int)sizeof(ScanConsts); }
int roadsurf_fuse_args_size(void) { return (int)sizeof(FuseArgs); }
int roadsurf_win_args_size(void) { return (int)sizeof(WinArgs); }

const char* roadsurf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
