// Whole-forecast scan kernel for NVIDIA Hopper (sm_90a).
//
// Replaces roadsurf_tpu/ops/pallas_step.py:pallas_scan / _make_kernel (the
// Pallas TPU kernel) in three of its modes: K1, point-major (forcing
// [T, 16, P]); K2, slim (forcing [T, 11, P], a time-only traffic friction
// vector, per-point aux rows and the in-kernel post-coupling
// radiation-coefficient decay; pallas_step.py:362-374, :467-509); and K3,
// tile-major (forcing [n_tiles, T, 16 or 11, TP], each tile's steps one
// contiguous slab; pallas_step.py:387-398, :619-629), under either channel
// set.  Plain version with the same semantics:
// roadsurf_tpu_torch/ops/scan_kernel.py:scan_reference.
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
//   Registers: about 64 at <16> (8 blocks of 128 threads an SM, half the
// warp slots); a minimum of 10 or 12 blocks in __launch_bounds__ caps them
// at 48 or 40 and spills, so the bound names no minimum (PERF.md,
// Findings).  The TPU's double-buffered forcing DMA and its inner time
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
// Numerics: float32 only, IEEE divide and sqrt, no fast math, no flush to
// zero (built with -prec-div=true -prec-sqrt=true -ftz=false); FMA
// contraction is allowed, except in the coefficient decay, which is
// written with __fmul_rn/__fsub_rn/__fdiv_rn/__fadd_rn and precise expf so
// that each product rounds on its own, as torch's forcing.cof_window does
// (K2 with cofs must equal K1 fed cof_window's channels bit for bit).
// There are no matrix products, so TF32 never arises.  min/max propagate
// NaN like torch.minimum/maximum.  Flat offsets are 64-bit: T * 16 * P
// passes 2^31 at 128 steps x 1M points.

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

// LM: register capacity for the profile (nlayers <= LM).  tmp[k] holds
// profile row k for k < L + 3 (row L+1 climatology, row L+2 the first
// padded row, read only by the depth interpolation's w == 0 edge).
// DEPTH: a global output depth is configured (StepConfig.use_depth); the
// plain (T1+T2)/2 instantiation needs fewer registers.
// SLIM: K2 (trf [>= off + nsteps], aux [4, P], cofs, t_total, cof_red are
// read only there).
template <int LM, bool DEPTH, bool SLIM>
__global__ void __launch_bounds__(BLOCK)
scan_kernel(const ScanConsts c, const float* __restrict__ tmp0,
            const float* __restrict__ scal0,
            const float* __restrict__ forcing,
            const float* __restrict__ trf, const float* __restrict__ aux,
            float* __restrict__ tmp_out, float* __restrict__ scal_out,
            float* __restrict__ out, int P, int tp, int T, int nsteps,
            int off, int out_base, int cofs, int t_total, float cof_red) {
  using K = Ch<SLIM>;
  const int p = blockIdx.x * BLOCK + threadIdx.x;
  if (p >= P) return;
  const int64_t PP = P;
  const int L = c.L;
  // this point's forcing: its tile's slab, at its place in the tile; FS is
  // the channel stride (the tile width)
  const int64_t FS = tp;
  const int64_t tile = p / tp;
  const float* fpt = forcing + tile * (int64_t)T * K::N * FS + (p - tile * FS);

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

  float tsurf = scal0[R_TSURF * PP + p];
  float wat = scal0[R_WAT * PP + p];
  float snow = scal0[R_SNOW * PP + p];
  float ice = scal0[R_ICE * PP + p];
  float ice2 = scal0[R_ICE2 * PP + p];
  float dep = scal0[R_DEP * PP + p];
  float q2m = scal0[R_Q2MELT * PP + p];
  float t4m = scal0[R_T4MELT * PP + p];
  float evap_s = scal0[R_EVAP * PP + p];
  float blc = scal0[R_BLCOND * PP + p];
  float alb = scal0[R_ALBEDO * PP + p];
  float vcold_f = scal0[R_VERYCOLD * PP + p];
  float failed_f = scal0[R_FAILED * PP + p];

  const float dt = c.dt;
  const float tph = c.tph;
  const float s2i = (float)(0.25 / 0.45);
  // the output cadence as a counter: the first step t whose global step
  // off + t is a multiple of out_stride, and its row; each hit moves both
  // on (no integer divide in the loop; unsigned, so the step past the last
  // hit cannot overflow)
  const int64_t first = ((int64_t)off + c.out_stride - 1) / c.out_stride;
  unsigned t_hit = (unsigned)(first * c.out_stride - off);
  int row_hit = (int)first - out_base;
  const int64_t f_step = (int64_t)K::N * FS;

  const float* f = fpt;
  for (int t = 0; t < nsteps; ++t, f += f_step) {
    const int tg = off + t;
    const bool hit = (unsigned)t == t_hit;
    const int row = row_hit;
    if (hit) {
      t_hit += (unsigned)c.out_stride;
      ++row_hit;
    }
    const bool failed_prev = failed_f > 0.5f;

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

    const float tair = __ldg(f + K::TAIR * FS);
    const bool abnormal = (tsurf < -100.0f) || (tsurf > 100.0f);
    const bool failed = (__ldg(f + K::VALID * FS) < 0.5f) || abnormal;

    // SetCurrentValues + obs forcing
    const float obs = __ldg(f + K::TSURF_OBS * FS);
    tmp[0] = tair;
    if (obs > -100.0f) {
      tmp[1] = obs;
      tmp[2] = obs;
      tsurf = surf_ave<LM, DEPTH>(tmp, c);
    }

    // precipitation to storage
    wat = wat + __ldg(f + K::RAIN * FS);
    snow = snow + __ldg(f + K::SNOW * FS);

    // boundary-layer fixed point (pallas_step.py:104-172): each thread
    // stops at its own convergence, which equals the masked freeze
    const float vz = __ldg(f + K::VZ * FS);
    const float air_vcap = __ldg(f + K::AIRVCAP * FS);
    const float tak = tair + 273.15f;
    const float dt_ts = tsurf - tair;
    const float inv_kvz = __frcp_rn(c.vk * vz);
    const float inv_avt = __frcp_rn(air_vcap * tak);
    float bl = blc, psim = 0.0f, psih = 0.0f;
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
                                 (inv_kvz / c.vk),
                             30.0f);
    const float psych_c = 0.1f * (0.00063f * tak + 0.47496f);
    const float wat_den = -0.0050f * tsurf * tsurf + 0.0079f * tsurf +
                          1000.0028f;
    const float esurf = esat1(tsurf);
    float le = air_vcap * (esurf - __ldg(f + K::EAIR * FS)) / (psych_c * raero);
    const float lheat = tsurf >= 0.0f ? c.lvap : c.lfus;
    float evap = le / (lheat * wat_den) * 1000.0f * dt;
    if ((le > 0.0f) && (wat <= 0.0f)) {
      le = 0.0f;
      evap = 0.0f;
    }

    // net radiation
    const float tk = tsurf + 273.15f;
    const float tk2 = tk * tk;
    float rnet;
    if (SLIM) {
      // K2's coefficients are 1, or with cofs the decay after the window
      // end (pallas_step.py:475-493): i_eff = tg + 1, but tg at the
      // lastValues step t_total - 1, compared in float32
      float sw_cof = 1.0f, lw_cof = 1.0f;
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
      // known to be 1 (or a select against 1) would let the products below
      // be folded or split, and round unlike K1's contracted expression
      asm("" : "+f"(sw_cof), "+f"(lw_cof));
      rnet = (1.0f - alb) * __ldg(f + K::SW * FS) * sw_cof +
             c.emiss * __ldg(f + K::LW * FS) * lw_cof - c.emiss_sb * tk2 * tk2;
    } else {
      rnet = (1.0f - alb) * __ldg(f + C_SW * FS) * __ldg(f + C_SWCOF * FS) +
             c.emiss * __ldg(f + C_LW * FS) * __ldg(f + C_LWCOF * FS) -
             c.emiss_sb * tk2 * tk2;
    }

    // conduction stencil + HStor (pallas_step.py:175-208), in place: layer
    // j's flux uses the old j and j+1, computed before j is overwritten
    const float t1a = (tmp[1] + 3.0f * tmp[2]) / 4.0f;
    float g_prev = rnet - le +
                   (SLIM ? __ldg(trf + tg) : __ldg(f + C_TRF * FS)) +
                   bl * (tmp[0] - tmp[1]);
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
        if (j == 1) hs1 = vsh * c.dyc[0] / dt;
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
    const bool has_frozen = (snow > 0.0f) || (ice > 0.0f) || (ice2 > 0.0f);
    float q2 = has_frozen ? q2m : 0.0f;
    if (c.melt_change) {
      const bool in_cpl = __ldg(f + K::INCPL * FS) > 0.5f;
      const bool guard =
          (hstor <= 0.00001f) || (tsurf <= t4m) || (q2m <= 0.0f) ||
          (in_cpl && ((SLIM ? a_obs : __ldg(f + C_CPLOBS * FS)) < t4m));
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
    bool vcold = vcold_f > 0.5f;
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
    const float mm = 1000.0f * (q2 * dt) / c.melt_heat;
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
      q2n = c.melt_heat * (snow / 1000.0f) / dt;
      t4n = c.t_lim_melt_snow;
    } else if (ice > 0.0f) {
      q2n = c.melt_heat * (ice / 1000.0f) / dt;
      t4n = c.t_lim_melt_ice;
    }
    q2n = nmax(q2n, 0.0f);

    const float ice_sum = nmax(0.5f * (ice + ice2) + dep, 0.0f);
    const bool snowy_a = (snow > 0.01f) && (snow > ice);
    const bool icy_a = (ice > 0.01f) || (dep > 0.01f);
    const float icy_alb =
        ice_sum < 1.5f ? c.alb_dry + (ice_sum / 1.5f) * c.alb_span : c.alb_snow;
    alb = snowy_a ? c.alb_snow : (icy_a ? icy_alb : c.alb_dry);

    // commit (this point was active): the profile was updated in place
    tsurf = tsurf_new;
    q2m = q2n;
    t4m = t4n;
    evap_s = evap;
    blc = bl;
    vcold_f = vcold ? 1.0f : 0.0f;
    failed_f = nmax(failed ? 1.0f : 0.0f, failed_f);

    if (hit && row < c.n_out) {
      float* o = out + ((int64_t)row * N_OUT_FIELDS) * PP + p;
      o[0] = tsurf;
      o[1 * PP] = wat;
      o[2 * PP] = snow;
      o[3 * PP] = ice;
      o[4 * PP] = ice2;
      o[5 * PP] = dep;
      o[6 * PP] = 0.0f;
      o[7 * PP] = 0.0f;
    }
  }

  // write back: rows 0..L from registers, the rest passed through
#pragma unroll
  for (int k = 0; k <= LM; ++k)
    if (k <= L) tmp_out[k * PP + p] = tmp[k];
  for (int k = L + 1; k < c.lpad; ++k) tmp_out[k * PP + p] = tmp0[k * PP + p];
  scal_out[R_TSURF * PP + p] = tsurf;
  scal_out[R_WAT * PP + p] = wat;
  scal_out[R_SNOW * PP + p] = snow;
  scal_out[R_ICE * PP + p] = ice;
  scal_out[R_ICE2 * PP + p] = ice2;
  scal_out[R_DEP * PP + p] = dep;
  scal_out[R_Q2MELT * PP + p] = q2m;
  scal_out[R_T4MELT * PP + p] = t4m;
  scal_out[R_EVAP * PP + p] = evap_s;
  scal_out[R_BLCOND * PP + p] = blc;
  scal_out[R_ALBEDO * PP + p] = alb;
  scal_out[R_VERYCOLD * PP + p] = vcold_f;
  scal_out[R_FAILED * PP + p] = failed_f;
  for (int r = R_FAILED + 1; r < NROWS; ++r)
    scal_out[r * PP + p] = scal0[r * PP + p];
}

// Dispatch on the layer bucket and the output-depth option; returns
// cudaGetLastError() after the launch (0 = ok).
template <bool SLIM>
static int launch(const ScanConsts* c, const float* tmp0, const float* scal0,
                  const float* forcing, const float* trf, const float* aux,
                  float* tmp_out, float* scal_out, float* out, int P,
                  int tp, int T, int nsteps, int off, int out_base, int cofs,
                  int t_total, float cof_red, void* stream) {
  if (P <= 0 || c->L < 1 || c->L > LMAX_ALL || tp <= 0 || P % tp != 0 ||
      (tp != P && tp % BLOCK != 0) || nsteps > T)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((P + BLOCK - 1) / BLOCK);
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(LM, DEPTH)                                                  \
  scan_kernel<LM, DEPTH, SLIM><<<grid, BLOCK, 0, s>>>(                     \
      *c, tmp0, scal0, forcing, trf, aux, tmp_out, scal_out, out, P, tp, T, \
      nsteps, off, out_base, cofs, t_total, cof_red)
  if (c->L <= 16) {
    if (c->use_depth) LAUNCH(16, true); else LAUNCH(16, false);
  } else {
    if (c->use_depth) LAUNCH(32, true); else LAUNCH(32, false);
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}

extern "C" {

// K1 on `stream`: forcing [T, 16, P] (tp = P), or K3 with 16 channels:
// [P / tp, T, 16, tp].
int roadsurf_scan(const ScanConsts* c, const float* tmp0, const float* scal0,
                  const float* forcing, float* tmp_out, float* scal_out,
                  float* out, int P, int tp, int T, int nsteps, int off,
                  int out_base, void* stream) {
  return launch<false>(c, tmp0, scal0, forcing, nullptr, nullptr, tmp_out,
                       scal_out, out, P, tp, T, nsteps, off, out_base, 0, 0,
                       1.0f, stream);
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
  return launch<true>(c, tmp0, scal0, forcing, trf, aux, tmp_out, scal_out,
                      out, P, tp, T, nsteps, off, out_base, cofs, t_total,
                      cof_red, stream);
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
// the copy of the time-only vector on that block's device).  The constants,
// the chunk geometry and the decay arguments are the same for every block.
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
                          int* failed_block) {
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
    } else if (slim) {
      rc = launch<true>(c, tmp0[b], scal0[b], forcing[b], trf[b], aux[b],
                        tmp_out[b], scal_out[b], out[b], P[b], tp[b], T,
                        nsteps, off, out_base, cofs, t_total, cof_red,
                        streams[b]);
    } else {
      rc = launch<false>(c, tmp0[b], scal0[b], forcing[b], nullptr, nullptr,
                         tmp_out[b], scal_out[b], out[b], P[b], tp[b], T,
                         nsteps, off, out_base, 0, 0, 1.0f, streams[b]);
    }
    if (rc != 0) *failed_block = b;
  }
  err = cudaSetDevice(caller);
  if (rc == 0 && err != cudaSuccess) rc = (int)err;
  return rc;
}

// sizeof(ScanConsts), checked against the ctypes mirror before any launch
int roadsurf_consts_size(void) { return (int)sizeof(ScanConsts); }

const char* roadsurf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
