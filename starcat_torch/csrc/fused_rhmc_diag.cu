// Diagonal-Fisher Riemannian trajectory on Hopper (sm_90a), one thread
// block per chain, its pixel passes written as register-tiled block GEMMs
// in FP32 on the CUDA cores.
//
// Replaces the Pallas kernel B3 of starcat/pallas_rhmc_diag.py:
//   make_pallas_rhmc_diag_leapfrog (_rhmc_diag_kernel -> rhmc_diag_trajectory_tile)
// with the same call contract: theta, xi (C, K, 3); eps (C,); mask (K,) or
// (C, K); beta read from a device scalar; out theta', p' (C, K, 3) and h0,
// h1, u1, resid (C,).  Static n_steps and fixed_point_iters, jitter.
//
// Hamiltonian (per chain, theta = (K, 3) of (logit x, logit y, log f)):
//   H   = U_beta + 1/2 sum_a log g_a + 1/2 sum_a p_a^2 / g_a
//   g_a = (beta F_a + info_a) m + (1 - m) + jitter,  F_a = sum_p J_a^2 / lam
// and the closed-form dH/dtheta of the reference (module docstring of
// pallas_rhmc_diag.py): a theta-only part t1 = dU + W(1/(2g)) built once per
// position, plus W(-a^2/2) per momentum sweep, with
//   W(wt)_c = beta (2 sum_a wt_a C_ac - sum_p q_wt(p) J_c(p) / lam^2) + wt_c info'_c
//   C_ac    = sum_p J_a H_ac / lam   (within-star 3x3 per star, theta-only)
//   q_wt    = sum_a wt_a J_a^2       (one separable field per sweep).
// Per step: fixed_point_iters momentum sweeps (q field + one contraction),
// fixed_point_iters position sweeps (profiles, lam and the Fisher diagonal
// at the iterate), then one rebuild of everything theta-dependent, reused by
// the step's last momentum half-step and the next step's sweeps.
//
// What bounded it: latency, not work.  A 6 x 4 trajectory at 32x32 and
// K = 16 is about 4.4 M FMAs a chain, some 70 K clocks of FP32 work an SM at
// 256 chains, against 1.2 M clocks measured: each pass took one pixel or
// one star a thread with a serial loop over the other, one to three shared
// loads an FMA, runtime integer division and IEEE divisions in every
// profile element, ten stored profile sets, dead slots computed everywhere
// and, at 256 threads a chain, two blocks (16 warps) an SM to hide it.
//
// What the design does about it:
//   * the scene's rows sit in a compile-time tile of TR = 4, 16, 32 or 48
//     rows (the scene is transposed when its height exceeds 48, so its rows
//     are at most 48 and H W <= 48^2 is covered); every field and y-side
//     set is stored by column at the immediate stride TR, rows past H zero;
//   * only the live stars (m != 0) are passes' depth and output: the mask
//     is fixed along a trajectory, so the block lists them once at entry;
//     a dead slot keeps zero sums, metric 1 + jitter and zero momentum, and
//     its theta comes back bit for bit;
//   * the render and the q field are (Gy a)^T Gx register tiles, R rows x
//     one column a thread (R = TR 32 / threads, at least 1), with 1/lam,
//     rho = beta (D/lam - 1) and the log-likelihood (double), or q / lam^2,
//     as epilogues; the q field's operands are gy^2, gy'^2 (built once per
//     position) and gx^2 (a0 zs^2 + a2), a1 gx^2 (once per sweep);
//   * the contractions are field @ X(W, n nl): a thread holds TR / 8 rows
//     of one star's n column products, made in registers from gx as it is
//     loaded (gx, gx'; gx'^2, gx^2; and in a build gx gx', gx'' gx'), over
//     a run of columns; the epilogue forms the y-side products from gy and
//     sums over its rows, then a butterfly over the lanes that hold a
//     star's rows and the column runs added in shared memory in a fixed
//     order;
//     the star slots are 4, 8 or 16, the fewest that hold the live stars,
//     and the threads they leave take more column runs;
//   * only gx and gy are stored profile sets (and the q field's four
//     operand sets); the derivative profiles are made in registers;
//   * each sweep's per-element update (the momentum or position iterate,
//     the Picard delta's partial maxima by warp shuffles, the next sweep's
//     weights, written into a second buffer while the first is still read)
//     is the epilogue of the phase that computes it, not phases and block
//     barriers of its own;
//   * the render's, the q field's and the contractions' depth loops are
//     unrolled by two, so that a warp has two iterations' loads in flight;
//   * 256 threads a chain at every C, two blocks an SM (512 threads at one
//     chain an SM, cfg1's diagonal metric, measured no faster);
//     starcat_fused_rhmc_diag_layout reports the layout.
// Reductions run in a fixed order, so two runs on the same inputs give the
// same bits, and a chain the same bits alone or among others.
//
// What bounds it now: still latency.  Each pass costs 1.5-3 K cycles for
// 100-200 FMAs a thread (scripts/b3_pass_clocks.py), the rebuild's per-star
// phase runs in one warp, and cfg5's 256 chains give two 8-warp blocks an
// SM.
//
// Accuracy: no fast math (expf, logf, IEEE division and square root).  The
// log-likelihood and the energies sum in double, so h0 and h1 carry no
// float32 summation error over the pixels.  NaN propagates: the solver
// residual is a NaN-propagating max (fmaxf would drop it), so a chain that
// blows up reports NaN and the head rejects it as a solver failure.  A dead
// slot (m = 0) gets flux 0 by selection, not by multiplying exp(s) by 0, so
// an extreme theta in a dead slot cannot make NaN.
//
// Domain (checked by the wrapper): H*W <= 48*48, 1 <= K <= 16, and the
// block's shared memory (smem_floats) within the card's 227 KB.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxStars = 16;
constexpr int kS = kMaxStars;  // stride of the per-star result arrays
constexpr int kMaxRows = 48;   // the largest tile
constexpr int kThreads = 256;  // a chain's block: two blocks (16 warps) an SM

struct Params {
  const float* theta;   // (C, K, 3)
  const float* xi;      // (C, K, 3) standard normal
  const float* eps;     // (C,)
  const float* mask;    // (K,) with stride 0, or (C, K) with stride K
  int mask_stride;
  const float* beta;    // device scalar
  const float* image;   // (H, W)
  float* theta_out;
  float* p_out;
  float* h0_out;        // (C,)
  float* h1_out;
  float* u1_out;
  float* resid_out;
  int K, H, W, n_steps, fpi;
  float psf_sigma, psf_norm, background;
  float logf_mean, logf_sigma, lp_flux_const, jitter;
};

// How a block of kThreads threads tiles TR rows.
template <int TR>
struct Tile {
  static constexpr int kR = TR * 32 / kThreads > 1 ? TR * 32 / kThreads : 1;  // render rows
  static constexpr int kG = TR / kR;             // render row groups
  static constexpr int kCols = kThreads / kG;    // render columns a round
  static constexpr int kGc = TR < 8 ? TR : 8;    // contraction lanes over a star's rows
  static constexpr int kRc = TR / kGc;           // contraction rows a thread
  static constexpr int kSW = 32 / kGc;           // contraction stars a warp
};

// The scene as the block holds it: rows (at most 48) and columns, the
// scene transposed when its height exceeds 48.
__host__ __device__ inline void scene_tile(int H, int W, int* rows, int* cols, int* tr,
                                           bool* swap) {
  *swap = H > kMaxRows;
  *rows = *swap ? W : H;
  *cols = *swap ? H : W;
  *tr = *rows <= 4 ? 4 : (*rows <= 16 ? 16 : (*rows <= 32 ? 32 : 48));
}

// Star slots a contraction's rows hold for n stars: 4, 8 or 16, at least a
// warp's stars.
__host__ __device__ inline int star_slots(int n, int tr) {
  const int sw = 32 / (tr < 8 ? tr : 8);
  const int ns = n <= 4 ? 4 : (n <= 8 ? 8 : 16);
  return ns > sw ? ns : sw;
}

// mirrored by smem_bytes() in fused_rhmc_diag.py, which checks the domain
__host__ __device__ inline int smem_floats(int K, int H, int W) {
  int rows, cols, tr;
  bool swap;
  scene_tile(H, W, &rows, &cols, &tr, &swap);
  const int ldx = cols | 1;
  return 2 * tr * cols + 3 * K * (tr + ldx) + kThreads / 16 + 3 * kThreads
         + 9 * kS + kS + 21 * kS + 30 * kS + 12;
}

// Shapes of one launch in the block's orientation.
struct Dims {
  int K, H, W;   // H rows (<= TR), W columns
  int ldx;       // the x-side sets' row stride, W | 1
  int nl, ns;    // live stars; a contraction's star slots
  bool swap;     // the scene's rows are the block's columns
};

// Per-slot arrays index k (stride kS); compact (live-star) arrays index j,
// slot live[j]; per-element state index a = 3 k + t.
struct Smem {
  float *r1, *fld;                // (W, TR): pixel (h, w) at w TR + h
  float *gy, *qy0, *qy1;          // (K, TR), compact: gy, gy^2, gy'^2
  float *gx, *qx0, *qx1;          // (K, ldx), compact: gx and the q field's operands
  double* red;                    // kThreads / 32
  float *part;                    // 3 kThreads: the column runs' partial sums
  float *su, *sv, *w, *wcx, *wcy, *m;  // per slot
  float *cx, *cy, *cw;            // compact: x, y, flux
  int* live;                      // kS
  float *dot, *dd, *cten;         // per slot: (3, kS), (9, kS), (9, kS)
  float *th_b, *p_b, *ph, *th, *base, *g, *t1, *infod;  // 3 kS each
  float *wt, *wt2;                // 3 kS each: a sweep's weights and the next's
  float *scal;                    // u, h, the sweeps' delta partials, the live count
};

template <int TR>
__device__ inline Smem carve(float* base, const Dims& D) {
  Smem s;
  float* q = base;
  auto take = [&q](int n) { float* r = q; q += n; return r; };
  // the fields and y-side sets first (multiples of 4 floats each): every
  // vector they are read by is aligned, and so are the doubles after them
  s.r1 = take(TR * D.W); s.fld = take(TR * D.W);
  s.gy = take(D.K * TR); s.qy0 = take(D.K * TR); s.qy1 = take(D.K * TR);
  s.red = reinterpret_cast<double*>(take(kThreads / 16));
  s.gx = take(D.K * D.ldx); s.qx0 = take(D.K * D.ldx); s.qx1 = take(D.K * D.ldx);
  s.part = take(3 * kThreads);
  s.su = take(kS); s.sv = take(kS); s.w = take(kS); s.wcx = take(kS); s.wcy = take(kS);
  s.m = take(kS); s.cx = take(kS); s.cy = take(kS); s.cw = take(kS);
  s.live = reinterpret_cast<int*>(take(kS));
  s.dot = take(3 * kS); s.dd = take(9 * kS); s.cten = take(9 * kS);
  s.th_b = take(3 * kS); s.p_b = take(3 * kS); s.ph = take(3 * kS); s.th = take(3 * kS);
  s.base = take(3 * kS); s.g = take(3 * kS); s.t1 = take(3 * kS);
  s.infod = take(3 * kS); s.wt = take(3 * kS); s.wt2 = take(3 * kS);
  s.scal = take(12);
  return s;
}

// R consecutive floats, in the widest aligned vectors (p is a multiple of
// R floats from an aligned base).
template <int R>
__device__ __forceinline__ void ld_rows(const float* p, float (&v)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x; v[i + 1] = t.y; v[i + 2] = t.z; v[i + 3] = t.w;
    }
  } else if constexpr (R % 2 == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 2) {
      const float2 t = *reinterpret_cast<const float2*>(p + i);
      v[i] = t.x; v[i + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] = p[i];
  }
}

template <int R>
__device__ __forceinline__ void st_rows(float* p, const float (&v)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (R % 2 == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 2) *reinterpret_cast<float2*>(p + i) = make_float2(v[i], v[i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) p[i] = v[i];
  }
}

__device__ __forceinline__ double warp_sum_d(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block, in a fixed order; every thread gets the total.
__device__ double block_sum_d(double v, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum_d(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double tot = 0.0;
  for (int i = 0; i < kThreads / 32; ++i) tot += red[i];
  __syncthreads();
  return tot;
}

// max that propagates NaN from either side (fmaxf drops it)
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float warp_nanmax(float v) {
  for (int o = 16; o > 0; o >>= 1) v = nanmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float softplusf(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// Per-slot coefficients at theta `th` (3K), the live stars' positions and
// fluxes, and their profiles gx, gy (and with `build` the q field's y-side
// operands gy^2, gy'^2), zero past W and H.  Every thread of the block
// calls it; it ends synchronised.
template <int TR>
__device__ void profiles(const Params& P, const Smem& s, const Dims& D, const float* th,
                         const int* ci, bool build) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float sig = P.psf_sigma, inv_sig = 1.0f / sig;
  if (tid < D.K) {
    const int k = tid;
    const float su = sigmoidf(th[3 * k]), sv = sigmoidf(th[3 * k + 1]);
    const float m = s.m[k];
    const float w = (m != 0.0f) ? expf(th[3 * k + 2]) * m : 0.0f;
    s.su[k] = su; s.sv[k] = sv; s.w[k] = w;
    s.wcx[k] = w * (D.W * su * (1.0f - su));
    s.wcy[k] = w * (D.H * sv * (1.0f - sv));
    const int j = ci[k];
    if (j >= 0) {
      s.cx[j] = D.W * su; s.cy[j] = D.H * sv; s.cw[j] = w;
    }
  }
  __syncthreads();
  // a warp per star, its lanes over the columns and the tile's rows
  for (int j = warp; j < D.nl; j += kThreads / 32) {
    const float x = s.cx[j], y = s.cy[j];
    for (int col = lane; col < D.W; col += 32) {
      const float z = ((col + 0.5f) - x) / sig;
      s.gx[j * D.ldx + col] = expf(-0.5f * z * z) * P.psf_norm;
    }
    for (int h = lane; h < TR; h += 32) {
      float g = 0.0f, g1 = 0.0f;
      if (h < D.H) {
        const float z = ((h + 0.5f) - y) / sig;
        g = expf(-0.5f * z * z) * P.psf_norm;
        g1 = g * z * inv_sig;
      }
      s.gy[j * TR + h] = g;
      if (build) {
        s.qy0[j * TR + h] = g * g;
        s.qy1[j * TR + h] = g1 * g1;
      }
    }
  }
  __syncthreads();
}

// lam = bg + (Gy w)^T Gx -> s.r1 = 1/lam.  With `full`, also s.fld = beta
// (D/lam - 1) and the log-likelihood sum_p D log lam - lam (double),
// returned to every thread.  Rows past H get 0.  Ends synchronised.
template <int TR>
__device__ double render(const Params& P, const Smem& s, const Dims& D, float beta,
                         bool full) {
  using T = Tile<TR>;
  constexpr int R = T::kR;
  const int tid = threadIdx.x;
  const int h0 = (tid % T::kG) * R;
  double ll = 0.0;
  for (int col = tid / T::kG; col < D.W; col += T::kCols) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = P.background;
    const float* py = s.gy + h0;
    const float* px = s.gx + col;
#pragma unroll 2
    for (int j = 0; j < D.nl; ++j) {
      float y[R];
      ld_rows<R>(py, y);
      const float x = *px * s.cw[j];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(y[r], x, acc[r]);
      py += TR;
      px += D.ldx;
    }
    float r1[R], f[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int h = h0 + r;
      r1[r] = 0.0f;
      f[r] = 0.0f;
      if (h < D.H) {
        const float lam = acc[r];
        r1[r] = 1.0f / lam;
        if (full) {  // the image through the read-only path, in the block's orientation
          const float d = __ldg(P.image + (D.swap ? col * D.H + h : h * D.W + col));
          ll += static_cast<double>(d * logf(lam) - lam);
          f[r] = beta * (d * r1[r] - 1.0f);
        }
      }
    }
    st_rows<R>(s.r1 + col * TR + h0, r1);
    if (full) st_rows<R>(s.fld + col * TR + h0, f);
  }
  if (full) return block_sum_d(ll, s.red);  // synchronises
  __syncthreads();
  return 0.0;
}

// Contractions over the columns, M(H, n nl) = field @ X(W, n nl), then the
// sum over rows against the y-side products.  Modes:
//   kBuild: s.fld (rho) @ [gx, gx'] against gy, gy' -> dot; 1/lam @ [gx'^2,
//           gx gx', gx^2, gx'' gx'] against gy^2, gy'^2, gy' gy, gy'' gy'
//           -> d1..d9
//   kSolve: 1/lam @ [gx'^2, gx^2] against gy^2, gy'^2 -> d1, d6, d9
//   kField: s.fld (q / lam^2) @ [gx, gx'] against gy, gy' -> dot
// A thread holds TR / 8 rows (kRc) of one star's products over one run of
// columns; the kGc lanes of a star hold its rows, a warp kSW stars, ns / kSW
// warps a run's star slots, and the rest of the block further runs.  Ends
// synchronised.
enum { kBuild = 0, kSolve = 1, kField = 2 };

template <int TR, int MODE>
__device__ void contract(const Params& P, const Smem& s, const Dims& D) {
  using T = Tile<TR>;
  constexpr int kRc = T::kRc, kGc = T::kGc, kSW = T::kSW;
  constexpr int kF = MODE == kSolve ? 0 : 2;                          // field products
  constexpr int kL = MODE == kField ? 0 : (MODE == kBuild ? 4 : 2);   // 1/lam products
  constexpr int kSums = (kF ? 3 : 0) + (MODE == kBuild ? 9 : (MODE == kSolve ? 3 : 0));
  if (D.nl == 0) return;  // every sum stays 0
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = lane % kGc;
  const int nsw = D.ns / kSW;
  const int j = kSW * (warp % nsw) + lane / kGc;  // star slot, compact
  const int run = warp / nsw, runs = (kThreads / 32) / nsw;
  const int wbeg = run * D.W / runs, wend = (run + 1) * D.W / runs;
  const int h0 = rg * kRc;
  // a slot past the live stars computes the last live star's sums again,
  // which are never stored
  const int jc = min(j, D.nl - 1);
  const float sig = P.psf_sigma, inv_sig = 1.0f / sig, inv_sig2 = inv_sig * inv_sig;

  float aF[kF > 0 ? kF : 1][kRc], aL[kL > 0 ? kL : 1][kRc];
#pragma unroll
  for (int r = 0; r < kRc; ++r) {
#pragma unroll
    for (int o = 0; o < kF; ++o) aF[o][r] = 0.0f;
#pragma unroll
    for (int o = 0; o < kL; ++o) aL[o][r] = 0.0f;
  }
  const float xh = s.cx[jc] - 0.5f;  // z sigma = w - xh, exact near the star
  const float* pf = s.fld + wbeg * TR + h0;
  const float* pl = s.r1 + wbeg * TR + h0;
  const float* pg = s.gx + jc * D.ldx;
#pragma unroll 2
  for (int w = wbeg; w < wend; ++w) {
    const float gx = pg[w];
    const float zs = (static_cast<float>(w) - xh) * inv_sig2;  // z / sigma
    if constexpr (kF > 0) {
      float v[kRc];
      ld_rows<kRc>(pf, v);
      const float g1 = gx * zs;  // gx'
#pragma unroll
      for (int r = 0; r < kRc; ++r) {
        aF[0][r] = fmaf(v[r], gx, aF[0][r]);
        aF[1][r] = fmaf(v[r], g1, aF[1][r]);
      }
      pf += TR;
    }
    if constexpr (kL > 0) {
      float v[kRc], op[kL];
      ld_rows<kRc>(pl, v);
      const float t = gx * gx;
      if (MODE == kSolve) {
        op[0] = (t * zs) * zs;                          // gx'^2
        op[1] = t;                                      // gx^2
      } else {
        const float u = t * zs;                         // gx gx'
        op[0] = u * zs;                                 // gx'^2
        op[1] = u;
        op[2] = t;                                      // gx^2
        op[3] = u * fmaf(zs, zs, -inv_sig2);            // gx'' gx'
      }
#pragma unroll
      for (int o = 0; o < kL; ++o)
#pragma unroll
        for (int r = 0; r < kRc; ++r) aL[o][r] = fmaf(v[r], op[o], aL[o][r]);
      pl += TR;
    }
  }
  // the sum over rows against the y-side products
  float sums[kSums];
#pragma unroll
  for (int q = 0; q < kSums; ++q) sums[q] = 0.0f;
  {
    float gyv[kRc];
    ld_rows<kRc>(s.gy + jc * TR + h0, gyv);
    const float yh = s.cy[jc] - 0.5f;
#pragma unroll
    for (int r = 0; r < kRc; ++r) {
      const float gy = gyv[r];
      const float dy = static_cast<float>(h0 + r) - yh;  // z sigma
      const float zy = dy * inv_sig;
      const float gy1 = gy * (dy * inv_sig2);           // gy'
      if constexpr (kF > 0) {
        sums[0] = fmaf(gy, aF[1][r], sums[0]);          // du
        sums[1] = fmaf(gy1, aF[0][r], sums[1]);         // dv
        sums[2] = fmaf(gy, aF[0][r], sums[2]);          // ds
      }
      constexpr int o = kF ? 3 : 0;
      if constexpr (MODE == kSolve) {
        const float ya = gy * gy, yb = gy1 * gy1;
        sums[o] = fmaf(ya, aL[0][r], sums[o]);          // d1
        sums[o + 1] = fmaf(yb, aL[1][r], sums[o + 1]);  // d6
        sums[o + 2] = fmaf(ya, aL[1][r], sums[o + 2]);  // d9
      } else if constexpr (MODE == kBuild) {
        const float ya = gy * gy, yb = gy1 * gy1, yc = gy1 * gy;
        const float yd = yc * (zy * zy - 1.0f) * inv_sig2;  // gy'' gy'
        const float m1 = aL[0][r], m2 = aL[1][r], m3 = aL[2][r], m4 = aL[3][r];
        sums[o] = fmaf(ya, m1, sums[o]);
        sums[o + 1] = fmaf(ya, m4, sums[o + 1]);
        sums[o + 2] = fmaf(yb, m2, sums[o + 2]);
        sums[o + 3] = fmaf(ya, m2, sums[o + 3]);
        sums[o + 4] = fmaf(yc, m1, sums[o + 4]);
        sums[o + 5] = fmaf(yb, m3, sums[o + 5]);
        sums[o + 6] = fmaf(yd, m3, sums[o + 6]);
        sums[o + 7] = fmaf(yc, m3, sums[o + 7]);
        sums[o + 8] = fmaf(ya, m3, sums[o + 8]);
      }
    }
  }
  // a butterfly over the star's kGc lanes, then the runs in a fixed order
#pragma unroll
  for (int q = 0; q < kSums; ++q)
#pragma unroll
    for (int o = 1; o < kGc; o <<= 1) sums[q] += __shfl_xor_sync(0xffffffffu, sums[q], o);
  if (runs > 1) {
    if (run > 0 && rg == 0) {
#pragma unroll
      for (int q = 0; q < kSums; ++q) s.part[((run - 1) * kSums + q) * D.ns + j] = sums[q];
    }
    __syncthreads();
  }
  if (run == 0 && rg == 0 && j < D.nl) {
    const int k = s.live[j];
#pragma unroll
    for (int q = 0; q < kSums; ++q) {
      float v = sums[q];
      for (int i = 1; i < runs; ++i) v += s.part[((i - 1) * kSums + q) * D.ns + j];
      if (kF > 0 && q < 3) {
        s.dot[q * kS + k] = v;
      } else {
        const int e = q - (kF ? 3 : 0);
        // kSolve's three sums are d1, d6, d9
        const int slot = MODE == kSolve ? (e == 0 ? 0 : (e == 1 ? 5 : 8)) : e;
        s.dd[slot * kS + k] = v;
      }
    }
  }
  __syncthreads();
}

// g_a = (beta F_a + info_a) m + (1 - m) + jitter for element a = 3 k + t
// of star k, from d1, d6 or d9, and info'_a into *infod when given.
__device__ float metric_element(const Params& P, const Smem& s, int k, int t, float beta,
                                float* infod) {
  const float m = s.m[k];
  float f, info, dinfo;
  if (t == 0) {
    const float su = s.su[k];
    f = s.wcx[k] * s.wcx[k] * s.dd[k];
    info = 2.0f * su * (1.0f - su) * m;
    dinfo = info * (1.0f - 2.0f * su);
  } else if (t == 1) {
    const float sv = s.sv[k];
    f = s.wcy[k] * s.wcy[k] * s.dd[5 * kS + k];
    info = 2.0f * sv * (1.0f - sv) * m;
    dinfo = info * (1.0f - 2.0f * sv);
  } else {
    f = s.w[k] * s.w[k] * s.dd[8 * kS + k];
    info = m / (P.logf_sigma * P.logf_sigma);
    dinfo = 0.0f;
  }
  if (infod != nullptr) *infod = dinfo;
  return (beta * f + info) * m + (1.0f - m) + P.jitter;
}

// q = Qy0^T X0 + Qy1^T X1 times (1/lam)^2 into s.fld, with Qy0 = gy^2,
// Qy1 = gy'^2 (built with the profiles) and, from wt, X0 = gx^2 (a0 zs^2
// + a2), X1 = a1 gx^2, a = wt (w cx, w cy, w)^2: the old field's
// sum_k (gx gy)^2 (a0 zx^2 + a1 zy^2 + a2) / sigma^2-scaled.  Every thread
// calls it; it ends synchronised.
template <int TR>
__device__ void q_field(const Params& P, const Smem& s, const Dims& D, const float* wt) {
  using T = Tile<TR>;
  constexpr int R = T::kR;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float sig = P.psf_sigma, inv_sig = 1.0f / sig, inv_sig2 = inv_sig * inv_sig;
  for (int j = warp; j < D.nl; j += kThreads / 32) {
    const int k = s.live[j];
    const float a0 = wt[3 * k] * (s.wcx[k] * s.wcx[k]);
    const float a1 = wt[3 * k + 1] * (s.wcy[k] * s.wcy[k]);
    const float a2 = wt[3 * k + 2] * (s.w[k] * s.w[k]);
    const float xh = s.cx[j] - 0.5f;
    for (int col = lane; col < D.W; col += 32) {
      const float gx = s.gx[j * D.ldx + col];
      const float t = gx * gx;
      const float zs = (static_cast<float>(col) - xh) * inv_sig2;
      s.qx0[j * D.ldx + col] = t * fmaf(a0, zs * zs, a2);
      s.qx1[j * D.ldx + col] = a1 * t;
    }
  }
  __syncthreads();
  const int h0 = (tid % T::kG) * R;
  for (int col = tid / T::kG; col < D.W; col += T::kCols) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
    const float* py0 = s.qy0 + h0;
    const float* py1 = s.qy1 + h0;
    const float* px0 = s.qx0 + col;
    const float* px1 = s.qx1 + col;
#pragma unroll 2
    for (int j = 0; j < D.nl; ++j) {
      float y0[R], y1[R];
      ld_rows<R>(py0, y0);
      ld_rows<R>(py1, y1);
      const float x0 = *px0, x1 = *px1;
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(y1[r], x1, fmaf(y0[r], x0, acc[r]));
      py0 += TR; py1 += TR;
      px0 += D.ldx; px1 += D.ldx;
    }
    float r1[R];
    ld_rows<R>(s.r1 + col * TR + h0, r1);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = acc[r] * (r1[r] * r1[r]);
    st_rows<R>(s.fld + col * TR + h0, acc);
  }
  __syncthreads();
}

// What the thread of element a does with dH_a = t1_a + W(wt)_a:
//   kToT1      t1 = dH (a rebuild: t1 = dU + W(1/(2g)));
//   kSweep     a momentum sweep: p_h = p - eps/2 dH, and the Picard delta's
//              partial maxima into s.scal[2..5];
//   kHalfStep  the step's last half-step: p = p_h - eps/2 dH, p_h = p.
// Each then writes the next momentum sweep's weights, -(p_h / g)^2 / 2,
// into wt_next: the weights wt are read by the other elements of a star
// in the same phase.
enum { kToT1 = 0, kSweep = 1, kHalfStep = 2 };

// W(wt) of the module comment at the structs' theta (the q field into
// s.fld, its contraction, the C and info' terms) and the update UPD of
// each element, in one phase.  Every thread calls it; it ends synchronised.
template <int TR, int UPD>
__device__ void wt_terms(const Params& P, const Smem& s, const Dims& D, float beta,
                         float half_eps, const float* wt, float* wt_next) {
  const int tid = threadIdx.x;
  q_field<TR>(P, s, D, wt);
  contract<TR, kField>(P, s, D);
  float num = 0.0f, den = 0.0f;
  if (tid < 3 * D.K) {
    const int k = tid / 3, tc = tid - 3 * k;
    const float coef = tc == 0 ? s.wcx[k] : (tc == 1 ? s.wcy[k] : s.w[k]);
    const float cq = coef * s.dot[tc * kS + k];
    const float cterm = wt[3 * k] * s.cten[(0 * 3 + tc) * kS + k]
                        + wt[3 * k + 1] * s.cten[(1 * 3 + tc) * kS + k]
                        + wt[3 * k + 2] * s.cten[(2 * 3 + tc) * kS + k];
    const float dh = s.t1[tid] + (beta * (2.0f * cterm - cq) + wt[tid] * s.infod[tid]);
    float ph = s.ph[tid];
    if (UPD == kToT1) {
      s.t1[tid] = dh;
    } else if (UPD == kSweep) {
      const float pn = s.p_b[tid] - half_eps * dh;
      num = fabsf(pn - ph);
      den = fabsf(pn);
      ph = pn;
    } else {
      ph = ph - half_eps * dh;
      s.p_b[tid] = ph;
    }
    s.ph[tid] = ph;
    const float a = ph / s.g[tid];
    wt_next[tid] = -0.5f * a * a;
  }
  if (UPD == kSweep && tid < 64) {  // 3K <= 48: warps 0 and 1
    num = warp_nanmax(num);
    den = warp_nanmax(den);
    if ((tid & 31) == 0) {
      s.scal[2 + 2 * (tid >> 5)] = num;
      s.scal[3 + 2 * (tid >> 5)] = den;
    }
  }
  __syncthreads();
}

// Everything theta-dependent at s.th_b: profiles, 1/lam, U_beta (s.scal[0]),
// grad U_beta (into s.t1), the metric s.g, info' (s.infod), the C tensor,
// then t1 = grad U_beta + W(1/(2g)) (the weights 1/(2g) in wt) and the next
// momentum sweep's weights in wt_next.
template <int TR>
__device__ void build_structs(const Params& P, const Smem& s, const Dims& D, const int* ci,
                              float beta, float* wt, float* wt_next) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int K = D.K;
  profiles<TR>(P, s, D, s.th_b, ci, true);
  const double ll = render<TR>(P, s, D, beta, true);
  contract<TR, kBuild>(P, s, D);
  if (warp == 0) {
    double lp = 0.0;
    if (lane < K) {
      const int k = lane;
      const float u = s.th_b[3 * k], v = s.th_b[3 * k + 1], sl = s.th_b[3 * k + 2];
      const float m = s.m[k];
      const float lp_pos = -(softplusf(u) + softplusf(-u) + softplusf(v) + softplusf(-v));
      const float zf = (sl - P.logf_mean) / P.logf_sigma;
      const float lp_flux = -0.5f * zf * zf + P.lp_flux_const;
      lp = static_cast<double>((lp_pos + lp_flux) * m);
      const float su = s.su[k], sv = s.sv[k], w = s.w[k];
      const float cx = D.W * su * (1.0f - su), cy = D.H * sv * (1.0f - sv);
      const float g_u = (1.0f - 2.0f * su) * m;
      const float g_v = (1.0f - 2.0f * sv) * m;
      const float g_s = -zf / P.logf_sigma * m;
      const float* dd = s.dd;
      const float d1 = dd[k], d2 = dd[kS + k], d3 = dd[2 * kS + k], d4 = dd[3 * kS + k],
                  d5 = dd[4 * kS + k], d6 = dd[5 * kS + k], d7 = dd[6 * kS + k],
                  d8 = dd[7 * kS + k], d9 = dd[8 * kS + k];
      const float wcx = s.wcx[k], wcy = s.wcy[k];
      s.t1[3 * k] = -(wcx * s.dot[k] + g_u);  // grad U; t1 adds W(1/(2g)) below
      s.t1[3 * k + 1] = -(wcy * s.dot[kS + k] + g_v);
      s.t1[3 * k + 2] = -(w * s.dot[2 * kS + k] + g_s);
      const float wcxcy = w * cx * cy;
      const float f_u = wcx * wcx * d1, f_v = wcy * wcy * d6, f_s = w * w * d9;
      float* c = s.cten;  // C[ta][tc][k] at ((ta * 3 + tc) * kS + k)
      c[(0 * 3 + 0) * kS + k] = wcx * ((w * cx * (1.0f - 2.0f * su)) * d1 + (w * cx * cx) * d2);
      c[(1 * 3 + 0) * kS + k] = wcy * wcxcy * d3;
      c[(2 * 3 + 0) * kS + k] = w * wcx * d4;
      c[(0 * 3 + 1) * kS + k] = wcx * wcxcy * d5;
      c[(1 * 3 + 1) * kS + k] = wcy * ((w * cy * (1.0f - 2.0f * sv)) * d6 + (w * cy * cy) * d7);
      c[(2 * 3 + 1) * kS + k] = w * wcy * d8;
      c[(0 * 3 + 2) * kS + k] = f_u;
      c[(1 * 3 + 2) * kS + k] = f_v;
      c[(2 * 3 + 2) * kS + k] = f_s;
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const float g = metric_element(P, s, k, t, beta, s.infod + 3 * k + t);
        s.g[3 * k + t] = g;
        wt[3 * k + t] = 0.5f / g;
      }
    }
    lp = warp_sum_d(lp);
    if (lane == 0) s.scal[0] = static_cast<float>(-(static_cast<double>(beta) * ll + lp));
  }
  __syncthreads();
  wt_terms<TR, kToT1>(P, s, D, beta, 0.0f, wt, wt_next);
}

// A position sweep: the metric g(theta') at the iterate s.th (profiles,
// 1/lam and the Fisher diagonal; no C tensor, no q field), then, by the
// thread of each element a, g_a, theta'_a = base_a + eps/2 p_h,a / g_a
// (into s.th_b too on the last sweep) and the Picard delta's partial
// maxima into s.scal[6..9].  Every thread calls it; it ends synchronised.
template <int TR>
__device__ void position_sweep(const Params& P, const Smem& s, const Dims& D, const int* ci,
                               float beta, float half_eps, bool last) {
  const int tid = threadIdx.x;
  profiles<TR>(P, s, D, s.th, ci, false);
  render<TR>(P, s, D, beta, false);
  contract<TR, kSolve>(P, s, D);
  float num = 0.0f, den = 0.0f;
  if (tid < 3 * D.K) {
    const int k = tid / 3;
    const float g = metric_element(P, s, k, tid - 3 * k, beta, nullptr);
    const float tn = s.base[tid] + half_eps * (s.ph[tid] / g);
    num = fabsf(tn - s.th[tid]);
    den = fabsf(tn);
    s.th[tid] = tn;
    if (last) s.th_b[tid] = tn;
  }
  if (tid < 64) {  // 3K <= 48: warps 0 and 1
    num = warp_nanmax(num);
    den = warp_nanmax(den);
    if ((tid & 31) == 0) {
      s.scal[6 + 2 * (tid >> 5)] = num;
      s.scal[7 + 2 * (tid >> 5)] = den;
    }
  }
  __syncthreads();
}

// H = U + 1/2 sum log g + 1/2 sum p^2 / g at the structs' theta, momentum p.
__device__ float hamiltonian(const Smem& s, int d3, const float* p) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < 32) {
    double lg = 0.0, kin = 0.0;
    for (int a = lane; a < d3; a += 32) {
      lg += static_cast<double>(logf(s.g[a]));
      kin += static_cast<double>(p[a] * p[a] / s.g[a]);
    }
    lg = warp_sum_d(lg);
    kin = warp_sum_d(kin);
    if (lane == 0)
      s.scal[1] = static_cast<float>(static_cast<double>(s.scal[0]) + 0.5 * lg + 0.5 * kin);
  }
  __syncthreads();
  const float h = s.scal[1];
  __syncthreads();
  return h;
}

// Element a of the (K, 3) state in the block's orientation: the scene's
// x and y swap when it is transposed.
__device__ __forceinline__ int oriented(int a, bool swap) {
  const int t = a % 3;
  return swap && t < 2 ? a + 1 - 2 * t : a;
}

template <int TR>
__global__ void __launch_bounds__(kThreads, 2) fused_rhmc_diag_kernel(Params P) {
  extern __shared__ float4 smem4[];
  const int c = blockIdx.x, tid = threadIdx.x;
  const int K = P.K, d3 = 3 * K;
  Dims D;
  int rows, cols, tr;
  scene_tile(P.H, P.W, &rows, &cols, &tr, &D.swap);
  D.K = K; D.H = rows; D.W = cols; D.ldx = cols | 1;
  const Smem s = carve<TR>(reinterpret_cast<float*>(smem4), D);
  const float eps = P.eps[c];
  const float half_eps = 0.5f * eps;
  const float beta = *P.beta;
  __shared__ int ci[kMaxStars];  // a slot's compact index, -1 when dead

  // zero sums for the dead stars
  for (int i = tid; i < 12 * kS; i += kThreads) (i < 3 * kS ? s.dot[i] : s.dd[i - 3 * kS]) = 0.0f;
  if (tid < K) s.m[tid] = P.mask[c * P.mask_stride + tid];
  if (tid < d3) {
    const int a = oriented(tid, D.swap);
    s.th_b[a] = P.theta[c * d3 + tid];
    s.ph[a] = P.xi[c * d3 + tid];
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int k = 0; k < K; ++k) {
      ci[k] = s.m[k] != 0.0f ? n : -1;
      if (s.m[k] != 0.0f) s.live[n++] = k;
    }
    s.scal[10] = static_cast<float>(n);
  }
  __syncthreads();
  D.nl = static_cast<int>(s.scal[10]);
  D.ns = star_slots(D.nl, TR);

  // the weights of a phase and of the next, swapped after each W(wt) phase
  float* wt = s.wt;
  float* wt_next = s.wt2;
  auto swap = [&wt, &wt_next]() { float* t = wt; wt = wt_next; wt_next = t; };
  build_structs<TR>(P, s, D, ci, beta, wt, wt_next);
  swap();
  if (tid < d3) {  // p0 = sqrt(g) xi m; the first sweep's p_h and weights
    const float p0 = sqrtf(s.g[tid]) * s.ph[tid] * s.m[tid / 3];
    const float a = p0 / s.g[tid];
    s.p_b[tid] = p0;
    s.ph[tid] = p0;
    wt[tid] = -0.5f * a * a;
  }
  __syncthreads();
  const float h0 = hamiltonian(s, d3, s.p_b);

  float resid = 0.0f;
  for (int step = 0; step < P.n_steps; ++step) {
    // implicit momentum half-step: p_h = p - eps/2 dH/dtheta(theta, p_h)
    float d1 = 0.0f;
    for (int it = 0; it < P.fpi; ++it) {
      wt_terms<TR, kSweep>(P, s, D, beta, half_eps, wt, wt_next);
      swap();
    }
    if (P.fpi > 0) d1 = nanmax(s.scal[2], s.scal[4]) / (1.0f + nanmax(s.scal[3], s.scal[5]));
    // implicit position step: theta' = theta + eps/2 [g(theta)^-1 + g(theta')^-1] p_h
    if (tid < d3) {
      const float v0 = s.ph[tid] / s.g[tid];
      s.base[tid] = s.th_b[tid] + half_eps * v0;
      s.th[tid] = s.th_b[tid] + eps * v0;
      if (P.fpi == 0) s.th_b[tid] = s.th[tid];
    }
    __syncthreads();
    float d2 = 0.0f;
    for (int it = 0; it < P.fpi; ++it)
      position_sweep<TR>(P, s, D, ci, beta, half_eps, it == P.fpi - 1);
    if (P.fpi > 0) d2 = nanmax(s.scal[6], s.scal[8]) / (1.0f + nanmax(s.scal[7], s.scal[9]));
    // rebuild at theta' (s.th_b, written by the last sweep); reused by the
    // final half-step, h1 and the next step
    build_structs<TR>(P, s, D, ci, beta, wt, wt_next);
    swap();
    wt_terms<TR, kHalfStep>(P, s, D, beta, half_eps, wt, wt_next);
    swap();
    resid = nanmax(resid, nanmax(d1, d2));
  }
  const float h1 = hamiltonian(s, d3, s.p_b);

  if (tid < d3) {
    const int a = oriented(tid, D.swap);
    P.theta_out[c * d3 + tid] = s.th_b[a];
    P.p_out[c * d3 + tid] = s.p_b[a];
  }
  if (tid == 0) {
    P.h0_out[c] = h0;
    P.h1_out[c] = h1;
    P.u1_out[c] = s.scal[0];
    P.resid_out[c] = resid;
  }
}

cudaError_t device_sms(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return e;
}

template <int TR>
cudaError_t prepare(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fused_rhmc_diag_kernel<TR>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Launch (or, with blocks_per_sm, report the occupancy of) the kernel for
// the scene's tile.
template <int TR>
cudaError_t run(const Params& P, int C, size_t smem, cudaStream_t st, int* blocks_per_sm) {
  cudaError_t e = prepare<TR>(smem);
  if (e != cudaSuccess) return e;
  if (blocks_per_sm != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, fused_rhmc_diag_kernel<TR>, kThreads, smem);
  fused_rhmc_diag_kernel<TR><<<C, kThreads, smem, st>>>(P);
  return cudaGetLastError();
}

// The launch of C chains (or its occupancy), the tile from the scene.
cudaError_t dispatch(const Params& P, int C, cudaStream_t st, int* blocks_per_sm) {
  int rows, cols, tr;
  bool swap;
  scene_tile(P.H, P.W, &rows, &cols, &tr, &swap);
  const size_t smem = static_cast<size_t>(smem_floats(P.K, P.H, P.W)) * sizeof(float);
  switch (tr) {
    case 4: return run<4>(P, C, smem, st, blocks_per_sm);
    case 16: return run<16>(P, C, smem, st, blocks_per_sm);
    case 32: return run<32>(P, C, smem, st, blocks_per_sm);
    default: return run<48>(P, C, smem, st, blocks_per_sm);
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 on success).
int starcat_fused_rhmc_diag(
    const void* theta, const void* xi, const void* eps, const void* mask,
    int mask_stride, const void* beta, const void* image, void* theta_out,
    void* p_out, void* h0_out, void* h1_out, void* u1_out, void* resid_out,
    int C, int K, int H, int W, int n_steps, int fpi, float psf_sigma,
    float psf_norm, float background, float logf_mean, float logf_sigma,
    float lp_flux_const, float jitter, void* stream) {
  Params P;
  P.theta = static_cast<const float*>(theta);
  P.xi = static_cast<const float*>(xi);
  P.eps = static_cast<const float*>(eps);
  P.mask = static_cast<const float*>(mask);
  P.mask_stride = mask_stride;
  P.beta = static_cast<const float*>(beta);
  P.image = static_cast<const float*>(image);
  P.theta_out = static_cast<float*>(theta_out);
  P.p_out = static_cast<float*>(p_out);
  P.h0_out = static_cast<float*>(h0_out);
  P.h1_out = static_cast<float*>(h1_out);
  P.u1_out = static_cast<float*>(u1_out);
  P.resid_out = static_cast<float*>(resid_out);
  P.K = K;
  P.H = H;
  P.W = W;
  P.n_steps = n_steps;
  P.fpi = fpi;
  P.psf_sigma = psf_sigma;
  P.psf_norm = psf_norm;
  P.background = background;
  P.logf_mean = logf_mean;
  P.logf_sigma = logf_sigma;
  P.lp_flux_const = lp_flux_const;
  P.jitter = jitter;
  if (K < 1 || K > kMaxStars || H * W > kMaxRows * kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(P, C, static_cast<cudaStream_t>(stream), nullptr));
}

// The layout a launch of C chains takes: threads per block, the blocks an SM
// holds and the SMs the grid fills.  Returns a CUDA error code (0 on
// success).
int starcat_fused_rhmc_diag_layout(int C, int K, int H, int W, int* threads,
                                   int* blocks_per_sm, int* sms_filled) {
  Params P{};
  P.K = K;
  P.H = H;
  P.W = W;
  int sms = 0;
  cudaError_t e = device_sms(&sms);
  if (e == cudaSuccess) e = dispatch(P, C, nullptr, blocks_per_sm);
  if (e != cudaSuccess) return static_cast<int>(e);
  *threads = kThreads;
  *sms_filled = C < sms ? C : sms;
  return 0;
}

const char* starcat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
