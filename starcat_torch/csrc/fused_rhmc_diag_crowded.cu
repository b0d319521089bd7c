// Diagonal-Fisher Riemannian trajectory for crowded fields on Hopper
// (sm_90a), one thread block per chain.
//
// Replaces the Pallas kernel B4 of starcat/pallas_rhmc_diag.py:
//   make_pallas_rhmc_diag_mxu (_rhmc_diag_mxu_kernel -> rhmc_diag_trajectory_mxu)
// with B3's call contract (csrc/fused_rhmc_diag.cu): theta, xi (C, K, 3);
// eps (C,); mask (K,) or (C, K); beta read from a device scalar; out theta',
// p' (C, K, 3) and h0, h1, u1, resid (C,).  Static n_steps and
// fixed_point_iters, jitter.
//
// The Hamiltonian and its closed-form dH/dtheta are B3's (see the comment
// at the top of csrc/fused_rhmc_diag.cu):
//   H   = U_beta + 1/2 sum_a log g_a + 1/2 sum_a p_a^2 / g_a
//   g_a = (beta F_a + info_a) m + (1 - m) + jitter,  F_a = sum_p J_a^2 / lam
//   dH/dtheta = t1 + W(-a^2/2),  t1 = dU + W(1/(2g)) once per position,
//   W(wt)_c = beta (2 sum_a wt_a C_ac - sum_p q_wt J_c / lam^2) + wt_c info'_c
// with the same sweep order: fixed_point_iters momentum sweeps, then
// fixed_point_iters position sweeps, then one rebuild at the new position.
//
// What differs is the layout, because a crowded field does not fit B3's.
// B3 keeps the image, 1/lam, one working field and ten profile sets in
// shared memory: at 128x128 and K = 64 that is 192 KB of fields and 640 KB
// of profiles, against the 227 KB a block may hold.  Here a block holds
//   * two fields: 1/lam (r1) and the working field (rho, then q / lam^2),
//     64 KB each at 128x128;
//   * two profile sets, gx (K, W) and gy (K, H), 32 KB each at K = 64;
//     the derivative profiles g' = g z / sigma and g'' = g (z^2 - 1) /
//     sigma^2 and their squares are recomputed from g and z = (c + 1/2 -
//     x_k) / sigma where they are used, so each costs a few FMAs and no
//     storage;
//   * the (K, 3) state and the per-star scalars, 18 KB at K = 64;
// 210 KB in all (smem_floats), one block per SM.  The image is read
// through the read-only path (L2) in the render, the only place it is used.
//
// What bounds it on this card: operations.  Per chain and trajectory at
// 128x128, K = 64, 6 steps x 4 sweeps there are about 3e8 FMAs (the rebuild
// 6 K H W and each position sweep 3 K H W, each momentum sweep 5 K H W),
// against 1.5 KB of state in and out.  The row contractions give one warp
// to one star; each lane sums four columns down the rows, so the profile
// values of a row, loaded once and expanded into the derivative products,
// serve four columns.  The q field gives each thread one column of four
// rows, so each star's column terms are computed once for four pixels.
// 512 threads keep 16 warps in flight on the SM.
//
// Accuracy: no fast math (expf, logf, IEEE division and square root).  The
// log-likelihood, the prior and the energies sum in double: at 128x128 the
// log-likelihood is of order 7e5, where one float32 spacing is 0.06.  NaN
// propagates: the solver residual is a NaN-propagating max, so a chain that
// blows up reports NaN and the head rejects it as a solver failure.  A dead
// slot (m = 0) gets flux 0 by selection, not by multiplying exp(s) by 0, so
// an extreme theta in a dead slot cannot make NaN; its momentum is zero and
// its theta comes back unchanged bit for bit.
//
// Domain (checked by the wrapper): 1 <= K <= 128 and the block's shared
// memory (smem_floats) within the card's 227 KB: at 128x128, K <= 77.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;  // columns per lane in the row contractions
constexpr int kRows = 4;  // rows per thread in the q field

struct Params {
  const float* theta;   // (C, K, 3)
  const float* xi;      // (C, K, 3) standard normal
  const float* eps;     // (C,)
  const float* mask;    // (K,) with stride 0, or (C, K) with stride K
  int mask_stride;
  const float* beta;    // device scalar
  const float* image;   // (H, W), read through L2
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

// Per-star scalars, index k; per-element state, index a = 3 k + t.
struct Smem {
  // stars (K each); zx0, zy0: z at column / row 0, (1/2 - x) / sigma
  float *su, *sv, *x, *y, *w, *wcx, *wcy, *wcx2, *wcy2, *wcxx, *wcyy, *wcxcy;
  float *m, *zx0, *zy0;
  // contraction results per star
  float *dot, *dd;  // dot: (3, K); dd: (9, K)
  // elements (3K each)
  float *th_b, *p_b, *ph, *th, *base, *g, *gs, *t1, *infod, *wt, *grad_u;
  float *cten;      // (3, 3, K): C[ta][tc][k]
  float *aq;        // (3, K): the q field's per-star weights
  float *scal;      // u, h, delta scratch
  double* red;      // kWarps
  // fields (H W each) and profiles
  float *r1, *fld;
  float *gx;        // (K, W)
  float *gy;        // (K, H)
};

// mirrored by smem_bytes() in fused_rhmc_diag_crowded.py
__host__ __device__ inline int smem_floats(int K, int H, int W) {
  return 15 * K + 12 * K + 11 * 3 * K + 9 * K + 3 * K + 8 + 1 + 2 * kWarps
         + 2 * H * W + K * W + K * H;
}

__device__ inline Smem carve(float* base, int K, int H, int W) {
  Smem s;
  float* q = base;
  auto take = [&q](int n) { float* r = q; q += n; return r; };
  s.su = take(K); s.sv = take(K); s.x = take(K); s.y = take(K); s.w = take(K);
  s.wcx = take(K); s.wcy = take(K); s.wcx2 = take(K); s.wcy2 = take(K);
  s.wcxx = take(K); s.wcyy = take(K); s.wcxcy = take(K); s.m = take(K);
  s.zx0 = take(K); s.zy0 = take(K);
  s.dot = take(3 * K); s.dd = take(9 * K);
  s.th_b = take(3 * K); s.p_b = take(3 * K); s.ph = take(3 * K); s.th = take(3 * K);
  s.base = take(3 * K); s.g = take(3 * K); s.gs = take(3 * K); s.t1 = take(3 * K);
  s.infod = take(3 * K); s.wt = take(3 * K); s.grad_u = take(3 * K);
  s.cten = take(9 * K); s.aq = take(3 * K); s.scal = take(8);
  // the doubles start on an 8-byte boundary (one float of slack)
  if (reinterpret_cast<size_t>(q) & 7) q += 1;
  s.red = reinterpret_cast<double*>(take(2 * kWarps));
  s.r1 = take(H * W); s.fld = take(H * W);
  s.gx = take(K * W); s.gy = take(K * H);
  return s;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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
  for (int i = 0; i < kWarps; ++i) tot += red[i];
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

// Per-star coefficients and the two stored profile sets at theta `th`
// (3K).  Every thread of the block calls it; it ends synchronised.
__device__ void profiles(const Params& P, const Smem& s, const float* th) {
  const int tid = threadIdx.x;
  const int K = P.K, H = P.H, W = P.W;
  const float sig = P.psf_sigma;
  if (tid < K) {
    const int k = tid;
    const float su = sigmoidf(th[3 * k]), sv = sigmoidf(th[3 * k + 1]);
    const float cx = W * su * (1.0f - su), cy = H * sv * (1.0f - sv);
    const float cx2 = cx * (1.0f - 2.0f * su), cy2 = cy * (1.0f - 2.0f * sv);
    const float m = s.m[k];
    const float w = (m != 0.0f) ? expf(th[3 * k + 2]) * m : 0.0f;
    s.su[k] = su; s.sv[k] = sv;
    s.x[k] = W * su; s.y[k] = H * sv; s.w[k] = w;
    s.zx0[k] = (0.5f - W * su) / sig; s.zy0[k] = (0.5f - H * sv) / sig;
    s.wcx[k] = w * cx; s.wcy[k] = w * cy; s.wcx2[k] = w * cx2; s.wcy2[k] = w * cy2;
    s.wcxx[k] = w * cx * cx; s.wcyy[k] = w * cy * cy; s.wcxcy[k] = w * cx * cy;
  }
  __syncthreads();
  for (int i = tid; i < K * W; i += kThreads) {
    const int k = i / W, col = i - k * W;
    const float z = ((col + 0.5f) - s.x[k]) / sig;
    s.gx[i] = expf(-0.5f * z * z) * P.psf_norm;
  }
  for (int i = tid; i < K * H; i += kThreads) {
    const int k = i / H, row = i - k * H;
    const float z = ((row + 0.5f) - s.y[k]) / sig;
    s.gy[i] = expf(-0.5f * z * z) * P.psf_norm;
  }
  __syncthreads();
}

// lam -> s.r1 = 1/lam.  With `full`, also s.fld = beta (D/lam - 1) and the
// log-likelihood sum_p D log lam - lam (double), returned to every thread.
// Ends synchronised.
__device__ double render(const Params& P, const Smem& s, float beta, bool full) {
  const int tid = threadIdx.x;
  const int K = P.K, H = P.H, W = P.W;
  double ll = 0.0;
  for (int pix = tid; pix < H * W; pix += kThreads) {
    const int h = pix / W, col = pix - h * W;
    float lam = P.background;
    for (int k = 0; k < K; ++k) lam = lam + (s.gy[k * H + h] * s.w[k]) * s.gx[k * W + col];
    const float r1 = 1.0f / lam;
    s.r1[pix] = r1;
    if (full) {
      const float d = __ldg(P.image + pix);
      ll += static_cast<double>(d * logf(lam) - lam);
      s.fld[pix] = beta * (d * r1 - 1.0f);
    }
  }
  if (full) return block_sum_d(ll, s.red);  // synchronises
  __syncthreads();
  return 0.0;
}

// Row contractions, one warp per star, lanes over columns (kCols each) and
// a serial sum down the rows; y-side products from gy and z_y, x-side from
// gx and z_x.  Modes:
//   kBuild: s.fld (rho) against gy, gy' -> dot; 1/lam against gy^2, gy'^2,
//           gy' gy, gy'' gy' -> d1..d9
//   kSolve: 1/lam against gy^2, gy'^2 -> d1, d6, d9
//   kField: s.fld (q / lam^2) against gy, gy' -> dot
enum { kBuild = 0, kSolve = 1, kField = 2 };

template <int MODE>
__device__ void contract(const Params& P, const Smem& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = P.K, H = P.H, W = P.W;
  const float inv_sig = 1.0f / P.psf_sigma;
  const float inv_sig2 = inv_sig * inv_sig;
  for (int k = warp; k < K; k += kWarps) {
    const float* gyk = s.gy + k * H;
    const float zy0 = s.zy0[k], zx0 = s.zx0[k];
    float du = 0.f, dv = 0.f, ds = 0.f;
    float d1 = 0.f, d2 = 0.f, d3 = 0.f, d4 = 0.f, d5 = 0.f, d6 = 0.f,
          d7 = 0.f, d8 = 0.f, d9 = 0.f;
    for (int c0 = 0; c0 < W; c0 += 32 * kCols) {
      float rg[kCols], rg1[kCols], ra[kCols], rb[kCols], rc[kCols], rd[kCols];
      int col[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        rg[j] = rg1[j] = ra[j] = rb[j] = rc[j] = rd[j] = 0.f;
        col[j] = c0 + lane + 32 * j;
      }
      for (int h = 0; h < H; ++h) {
        const float gy = gyk[h];
        const float zy = fmaf(static_cast<float>(h), inv_sig, zy0);
        const float gy1 = gy * zy * inv_sig;             // gy'
        const float* frow = s.fld + h * W;
        const float* rrow = s.r1 + h * W;
        if (MODE != kSolve) {
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            const float q = col[j] < W ? frow[col[j]] : 0.f;
            rg[j] = fmaf(q, gy, rg[j]);
            rg1[j] = fmaf(q, gy1, rg1[j]);
          }
        }
        if (MODE != kField) {
          const float gysq = gy * gy, gy1sq = gy1 * gy1;
          float gy1gy = 0.f, gyd2gy1 = 0.f;
          if (MODE == kBuild) {
            gy1gy = gy1 * gy;
            gyd2gy1 = gy1gy * (zy * zy - 1.0f) * inv_sig2;  // gy'' gy'
          }
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            const float r = col[j] < W ? rrow[col[j]] : 0.f;
            ra[j] = fmaf(r, gysq, ra[j]);
            rb[j] = fmaf(r, gy1sq, rb[j]);
            if (MODE == kBuild) {
              rc[j] = fmaf(r, gy1gy, rc[j]);
              rd[j] = fmaf(r, gyd2gy1, rd[j]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        if (col[j] < W) {
          const float gx = s.gx[k * W + col[j]];
          const float zx = fmaf(static_cast<float>(col[j]), inv_sig, zx0);
          const float gx1 = gx * zx * inv_sig;
          if (MODE != kSolve) {
            du += gx1 * rg[j];
            dv += gx * rg1[j];
            ds += gx * rg[j];
          }
          if (MODE != kField) {
            const float gxsq = gx * gx, gx1sq = gx1 * gx1;
            d1 += gx1sq * ra[j];
            d6 += gxsq * rb[j];
            d9 += gxsq * ra[j];
            if (MODE == kBuild) {
              const float gxx1 = gx * gx1;
              const float gxd2 = gx * (zx * zx - 1.0f) * inv_sig2;
              d2 += (gxd2 * gx1) * ra[j];
              d3 += gxx1 * rb[j];
              d4 += gxx1 * ra[j];
              d5 += gx1sq * rc[j];
              d7 += gxsq * rd[j];
              d8 += gxsq * rc[j];
            }
          }
        }
      }
    }
    if (MODE != kSolve) {
      du = warp_sum(du); dv = warp_sum(dv); ds = warp_sum(ds);
      if (lane == 0) { s.dot[k] = du; s.dot[K + k] = dv; s.dot[2 * K + k] = ds; }
    }
    if (MODE != kField) {
      d1 = warp_sum(d1); d6 = warp_sum(d6); d9 = warp_sum(d9);
      if (MODE == kBuild) {
        d2 = warp_sum(d2); d3 = warp_sum(d3); d4 = warp_sum(d4);
        d5 = warp_sum(d5); d7 = warp_sum(d7); d8 = warp_sum(d8);
      }
      if (lane == 0) {
        s.dd[k] = d1; s.dd[5 * K + k] = d6; s.dd[8 * K + k] = d9;
        if (MODE == kBuild) {
          s.dd[K + k] = d2; s.dd[2 * K + k] = d3; s.dd[3 * K + k] = d4;
          s.dd[4 * K + k] = d5; s.dd[6 * K + k] = d7; s.dd[7 * K + k] = d8;
        }
      }
    }
  }
  __syncthreads();
}

// g = (beta F + info) m + (1 - m) + jitter for star k, from d1, d6, d9,
// into out[3k..3k+2], and info' into infod when given.  Run by thread k.
__device__ void diag_metric_star(const Params& P, const Smem& s, int k, float beta,
                                 float* out, float* infod) {
  const float m = s.m[k];
  const float su = s.su[k], sv = s.sv[k];
  const float f_u = s.wcx[k] * s.wcx[k] * s.dd[k];
  const float f_v = s.wcy[k] * s.wcy[k] * s.dd[5 * P.K + k];
  const float f_s = s.w[k] * s.w[k] * s.dd[8 * P.K + k];
  const float info_u = 2.0f * su * (1.0f - su) * m;
  const float info_v = 2.0f * sv * (1.0f - sv) * m;
  const float info_s = m / (P.logf_sigma * P.logf_sigma);
  out[3 * k] = (beta * f_u + info_u) * m + (1.0f - m) + P.jitter;
  out[3 * k + 1] = (beta * f_v + info_v) * m + (1.0f - m) + P.jitter;
  out[3 * k + 2] = (beta * f_s + info_s) * m + (1.0f - m) + P.jitter;
  if (infod != nullptr) {
    infod[3 * k] = info_u * (1.0f - 2.0f * su);
    infod[3 * k + 1] = info_v * (1.0f - 2.0f * sv);
    infod[3 * k + 2] = 0.0f;
  }
}

// W(wt) of the comment at the top into out (3K), from s.wt at the structs'
// theta: builds the q field into s.fld, contracts it, adds the C and info'
// terms.  Every thread calls it; it ends synchronised.
//   q = sum_k gy^2 (a0 gx'^2 + a2 gx^2) + gy'^2 a1 gx^2
//     = sum_k (gx gy)^2 (a2 + a0 zx^2 / sigma^2 + a1 zy^2 / sigma^2)
// with a_t = wt_t coef_t^2; s.aq holds a0 / sigma^2, a1 / sigma^2, a2.
__device__ void wt_terms(const Params& P, const Smem& s, float beta, const float* add,
                         float* out) {
  const int tid = threadIdx.x;
  const int K = P.K, H = P.H, W = P.W;
  const float inv_sig = 1.0f / P.psf_sigma;
  const float inv_sig2 = inv_sig * inv_sig;
  if (tid < K) {
    const int k = tid;
    s.aq[3 * k] = s.wt[3 * k] * (s.wcx[k] * s.wcx[k]) * inv_sig2;
    s.aq[3 * k + 1] = s.wt[3 * k + 1] * (s.wcy[k] * s.wcy[k]) * inv_sig2;
    s.aq[3 * k + 2] = s.wt[3 * k + 2] * (s.w[k] * s.w[k]);
  }
  __syncthreads();
  // one column of kRows rows per thread: a warp shares its rows (gy loads
  // are broadcasts) and reads consecutive columns of gx
  const int row_groups = (H + kRows - 1) / kRows;
  for (int item = tid; item < row_groups * W; item += kThreads) {
    const int hg = item / W, col = item - hg * W;
    const int h0 = hg * kRows;
    float q[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) q[r] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float gx = s.gx[k * W + col];
      const float zx = fmaf(static_cast<float>(col), inv_sig, s.zx0[k]);
      const float gxsq = gx * gx;
      const float a0 = s.aq[3 * k], a1 = s.aq[3 * k + 1], a2 = s.aq[3 * k + 2];
      const float cx = fmaf(a0, zx * zx, a2);
      const float zy0 = s.zy0[k];
      const float* gyk = s.gy + k * H;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int h = min(h0 + r, H - 1);
        const float gy = gyk[h];
        const float zy = fmaf(static_cast<float>(h), inv_sig, zy0);
        const float t = gxsq * (gy * gy);
        q[r] = fmaf(t, fmaf(a1, zy * zy, cx), q[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int h = h0 + r;
      if (h < H) {
        const float r1 = s.r1[h * W + col];
        s.fld[h * W + col] = q[r] * (r1 * r1);
      }
    }
  }
  __syncthreads();
  contract<kField>(P, s);
  if (tid < 3 * K) {
    const int k = tid / 3, tc = tid - 3 * k;
    const float coef = tc == 0 ? s.wcx[k] : (tc == 1 ? s.wcy[k] : s.w[k]);
    const float cq = coef * s.dot[tc * K + k];
    const float cterm = s.wt[3 * k] * s.cten[(0 * 3 + tc) * K + k]
                        + s.wt[3 * k + 1] * s.cten[(1 * 3 + tc) * K + k]
                        + s.wt[3 * k + 2] * s.cten[(2 * 3 + tc) * K + k];
    out[tid] = add[tid] + (beta * (2.0f * cterm - cq) + s.wt[tid] * s.infod[tid]);
  }
  __syncthreads();
}

// Everything theta-dependent at s.th_b: profiles, 1/lam, U_beta (s.scal[0]),
// grad U_beta, the metric s.g, info' (s.infod), the C tensor and t1.
__device__ void build_structs(const Params& P, const Smem& s, float beta) {
  const int tid = threadIdx.x;
  const int K = P.K;
  profiles(P, s, s.th_b);
  const double ll = render(P, s, beta, true);
  contract<kBuild>(P, s);
  double lp = 0.0;
  if (tid < K) {
    const int k = tid;
    const float u = s.th_b[3 * k], v = s.th_b[3 * k + 1], sl = s.th_b[3 * k + 2];
    const float m = s.m[k];
    const float lp_pos = -(softplusf(u) + softplusf(-u) + softplusf(v) + softplusf(-v));
    const float zf = (sl - P.logf_mean) / P.logf_sigma;
    const float lp_flux = -0.5f * zf * zf + P.lp_flux_const;
    lp = static_cast<double>((lp_pos + lp_flux) * m);
    const float g_u = (1.0f - 2.0f * s.su[k]) * m;
    const float g_v = (1.0f - 2.0f * s.sv[k]) * m;
    const float g_s = -zf / P.logf_sigma * m;
    const float* dd = s.dd;
    const float d1 = dd[k], d2 = dd[K + k], d3 = dd[2 * K + k], d4 = dd[3 * K + k],
                d5 = dd[4 * K + k], d6 = dd[5 * K + k], d7 = dd[6 * K + k],
                d8 = dd[7 * K + k], d9 = dd[8 * K + k];
    s.grad_u[3 * k] = -(s.wcx[k] * s.dot[k] + g_u);
    s.grad_u[3 * k + 1] = -(s.wcy[k] * s.dot[K + k] + g_v);
    s.grad_u[3 * k + 2] = -(s.w[k] * s.dot[2 * K + k] + g_s);
    const float wcx = s.wcx[k], wcy = s.wcy[k], w = s.w[k];
    const float f_u = wcx * wcx * d1, f_v = wcy * wcy * d6, f_s = w * w * d9;
    float* c = s.cten;  // C[ta][tc][k] at ((ta * 3 + tc) * K + k)
    c[(0 * 3 + 0) * K + k] = wcx * (s.wcx2[k] * d1 + s.wcxx[k] * d2);
    c[(1 * 3 + 0) * K + k] = wcy * s.wcxcy[k] * d3;
    c[(2 * 3 + 0) * K + k] = w * wcx * d4;
    c[(0 * 3 + 1) * K + k] = wcx * s.wcxcy[k] * d5;
    c[(1 * 3 + 1) * K + k] = wcy * (s.wcy2[k] * d6 + s.wcyy[k] * d7);
    c[(2 * 3 + 1) * K + k] = w * wcy * d8;
    c[(0 * 3 + 2) * K + k] = f_u;
    c[(1 * 3 + 2) * K + k] = f_v;
    c[(2 * 3 + 2) * K + k] = f_s;
    diag_metric_star(P, s, k, beta, s.g, s.infod);
  }
  lp = block_sum_d(lp, s.red);  // synchronises
  if (tid == 0) s.scal[0] = static_cast<float>(-(static_cast<double>(beta) * ll + lp));
  if (tid < 3 * K) s.wt[tid] = 0.5f / s.g[tid];
  __syncthreads();
  wt_terms(P, s, beta, s.grad_u, s.t1);
}

// dH/dtheta at the structs' theta and momentum p (3K) into out.
__device__ void dh_dtheta(const Params& P, const Smem& s, float beta, const float* p,
                          float* out) {
  const int tid = threadIdx.x;
  if (tid < 3 * P.K) {
    const float a = p[tid] / s.g[tid];
    s.wt[tid] = -0.5f * a * a;
  }
  __syncthreads();
  wt_terms(P, s, beta, s.t1, out);
}

// The metric at theta `th` into s.gs (profiles, 1/lam and the Fisher
// diagonal at th; no C tensor, no q field).
__device__ void diag_solve(const Params& P, const Smem& s, float beta, const float* th) {
  profiles(P, s, th);
  render(P, s, beta, false);
  contract<kSolve>(P, s);
  if (threadIdx.x < P.K) diag_metric_star(P, s, threadIdx.x, beta, s.gs, nullptr);
  __syncthreads();
}

// Relative sup-norm Picard delta max|x_new - x_old| / (1 + max|x_new|) over
// the 3K entries, NaN-propagating; returned to every thread.
__device__ float fp_delta(const Smem& s, int d3, const float* x_new, const float* x_old) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < 32) {
    float num = 0.0f, den = 0.0f;
    for (int a = lane; a < d3; a += 32) {
      num = nanmax(num, fabsf(x_new[a] - x_old[a]));
      den = nanmax(den, fabsf(x_new[a]));
    }
    num = warp_nanmax(num);
    den = warp_nanmax(den);
    if (lane == 0) s.scal[2] = num / (1.0f + den);
  }
  __syncthreads();
  const float d = s.scal[2];
  __syncthreads();
  return d;
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

__global__ void __launch_bounds__(kThreads) fused_rhmc_diag_crowded_kernel(Params P) {
  extern __shared__ float smem[];
  const int c = blockIdx.x, tid = threadIdx.x;
  const int K = P.K, H = P.H, W = P.W, d3 = 3 * K;
  const Smem s = carve(smem, K, H, W);
  const float eps = P.eps[c];
  const float half_eps = 0.5f * eps;
  const float beta = *P.beta;

  if (tid < K) s.m[tid] = P.mask[c * P.mask_stride + tid];
  if (tid < d3) {
    s.th_b[tid] = P.theta[c * d3 + tid];
    s.ph[tid] = P.xi[c * d3 + tid];
  }
  __syncthreads();

  build_structs(P, s, beta);
  if (tid < d3) s.p_b[tid] = sqrtf(s.g[tid]) * s.ph[tid] * s.m[tid / 3];
  __syncthreads();
  const float h0 = hamiltonian(s, d3, s.p_b);

  float resid = 0.0f;
  for (int step = 0; step < P.n_steps; ++step) {
    // implicit momentum half-step: p_h = p - eps/2 dH/dtheta(theta, p_h)
    if (tid < d3) s.ph[tid] = s.p_b[tid];
    __syncthreads();
    float d1 = 0.0f;
    for (int it = 0; it < P.fpi; ++it) {
      dh_dtheta(P, s, beta, s.ph, s.base);  // s.base as scratch for dH
      if (tid < d3) s.base[tid] = s.p_b[tid] - half_eps * s.base[tid];
      __syncthreads();
      d1 = fp_delta(s, d3, s.base, s.ph);
      if (tid < d3) s.ph[tid] = s.base[tid];
      __syncthreads();
    }
    // implicit position step: theta' = theta + eps/2 [g(theta)^-1 + g(theta')^-1] p_h
    if (tid < d3) {
      const float v0 = s.ph[tid] / s.g[tid];
      s.base[tid] = s.th_b[tid] + half_eps * v0;
      s.th[tid] = s.th_b[tid] + eps * v0;
    }
    __syncthreads();
    float d2 = 0.0f;
    for (int it = 0; it < P.fpi; ++it) {
      diag_solve(P, s, beta, s.th);
      if (tid < d3) s.gs[tid] = s.base[tid] + half_eps * (s.ph[tid] / s.gs[tid]);
      __syncthreads();
      d2 = fp_delta(s, d3, s.gs, s.th);
      if (tid < d3) s.th[tid] = s.gs[tid];
      __syncthreads();
    }
    // rebuild at theta'; reused by the final half-step, h1 and the next step
    if (tid < d3) s.th_b[tid] = s.th[tid];
    __syncthreads();
    build_structs(P, s, beta);
    dh_dtheta(P, s, beta, s.ph, s.base);
    if (tid < d3) s.p_b[tid] = s.ph[tid] - half_eps * s.base[tid];
    __syncthreads();
    resid = nanmax(resid, nanmax(d1, d2));
  }
  const float h1 = hamiltonian(s, d3, s.p_b);

  if (tid < d3) {
    P.theta_out[c * d3 + tid] = s.th_b[tid];
    P.p_out[c * d3 + tid] = s.p_b[tid];
  }
  if (tid == 0) {
    P.h0_out[c] = h0;
    P.h1_out[c] = h1;
    P.u1_out[c] = s.scal[0];
    P.resid_out[c] = resid;
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 on success).
int starcat_fused_rhmc_diag_crowded(
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

  const size_t smem = static_cast<size_t>(smem_floats(K, H, W)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_rhmc_diag_crowded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fused_rhmc_diag_crowded_kernel<<<C, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

const char* starcat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
