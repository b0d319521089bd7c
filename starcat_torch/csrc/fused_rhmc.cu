// Full-Fisher Riemannian trajectory on Hopper (sm_90a), one thread block
// per chain.
//
// Replaces the Pallas kernel B6 of starcat/pallas_rhmc.py:
//   make_pallas_rhmc_leapfrog (_rhmc_kernel -> rhmc_trajectory_tile)
// with the same call contract: theta, xi (C, K, 3); eps (C,); mask (K,) or
// (C, K); beta read from a device scalar; out theta', p' (C, K, 3) and h0,
// h1, u1, resid (C,).  Static n_steps and fixed_point_iters, jitter.
//
// Hamiltonian (per chain, D = 3K parameters packed type-major, a = t K + i
// for type t in (logit x, logit y, log f) of star i, as the reference packs
// them, so that p0 = L xi is the reference's momentum for the same xi):
//   H     = U_beta + 1/2 log det G + 1/2 p^T G^-1 p
//   G     = beta F + diag(info) + diag(1 - m) + jitter I
//   F_ab  = sum_p J_a(p) J_b(p) / lam(p),   J_a = coef_a Y_a(h) X_a(w)
// and the reference's closed-form dH/dtheta (module docstring of
// pallas_rhmc.py): with a = G^-1 p,
//   t1_c    = dU_c + beta sum_ab Ginv_ab S_acb - beta/2 sum_p q(p) J_c R2
//             + 1/2 Ginv_cc info'_c                       (once per position)
//   t2_c(a) = -beta sum_ab a_a a_b S_acb + beta/2 sum_p phi^2 J_c R2
//             - 1/2 a_c^2 info'_c                          (every sweep)
//   S_acb   = sum_p H_ac(p) J_b(p) R1(p),  q = sum_ab Ginv_ab J_a J_b,
//   phi     = sum_b a_b J_b,  R1 = 1/lam, R2 = 1/lam^2.
// The per-sweep S contraction is the reference's psi form: sum_p psi_c phi R1
// with psi_c = sum_a a_a H_ac, three row contractions per star.
//
// Per step: fixed_point_iters momentum sweeps (phi field, one contraction),
// fixed_point_iters position sweeps (profiles, lam, Fisher, Cholesky and two
// triangular solves at the iterate), then one rebuild of everything
// theta-dependent (Fisher and S, Cholesky, L^-1, G^-1, the q field, t1),
// reused by the step's last momentum half-step and the next step's sweeps.
//
// Layout: the chain's image, 1/lam and one working field (rho, then q, then
// phi), the six profile sets gx, gx', gx'', gy, gy', gy'', the raw pair
// contractions Sraw (18 K^2: the six distinct Hessian profiles of star i
// against the three Jacobian profiles of star j, from which both F and S are
// assembled), G / L, L^-1 and G^-1 (3 D^2) and the small state stay in shared
// memory: 4 (45 K^2 + 61 K + 3 H W + 3 K (H + W) + 8) bytes, 74.6 KB at
// 32x32 with K = 16 and 96.1 KB at 48x48.  Device memory sees theta, xi and
// the outputs once.
//
// The Fisher and S builds run one warp per star pair (i, j): lanes over
// columns accumulate sum_h Y_i(h) Y_j(h) R1(h, w) down the rows, then the
// W-length dots against X_i X_j reduce by warp shuffles.  A position sweep
// needs only F, so it takes the pairs i <= j and 4 row products; a rebuild
// takes every ordered pair and 6 row products, for S.  The q field is a
// quadratic form per pixel: J (3K values) in registers, G^-1 read by
// broadcast, K (K + 1) / 2 3x3 blocks.  The Cholesky is right-looking, one
// column per step; L^-1 is built row by row; both keep D = 3K <= 48.
//
// Accuracy: no fast math (expf, logf, IEEE division and square root).  The
// log-likelihood, log det G and the energies sum in double.  A non-positive
// pivot gives NaN (sqrtf of a negative number), which propagates to the
// residual, a NaN-propagating max, so the head rejects the chain as a solver
// failure.  A dead slot (m = 0) gets flux 0 by selection, so its Jacobian
// rows are exact zeros, G has an exact identity row there, its momentum is
// zero and its theta comes back bit for bit.
//
// Domain (checked by the wrapper): H*W <= 48*48, 1 <= K <= 16, and the
// block's shared memory (smem_floats) within the card's 227 KB.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStars = 16;

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

// Per-star scalars, index i; per-parameter vectors, index a = t K + i.
struct Smem {
  // stars (K each)
  float *su, *sv, *x, *y, *w, *wcx, *wcy, *wcx2, *wcy2, *wcxx, *wcyy, *wcxcy, *m;
  float *cu, *cv, *cs;  // a_a coef_a per star, for the phi field
  float *dots;          // (9, K) field contractions per star
  // parameters (D each)
  float *th_b, *p_b, *ph, *th, *base, *vec, *t1, *infod, *a, *ldiag, *dh, *rhs;
  float *scal;          // U, logdet, h, delta scratch
  // fields (H W each) and profiles
  float *img, *r1, *fld;
  float *gx, *gx1, *gx2;  // (K, W)
  float *gy, *gy1, *gy2;  // (K, H)
  float *sraw;            // (18, K, K): [(hp * 3 + tb) K + i] K + j
  float *gmat, *lw, *ginv;  // (D, D) each, row-major
};

// mirrored by smem_bytes() in fused_rhmc.py, which checks the domain
__host__ __device__ inline int smem_floats(int K, int H, int W) {
  return 45 * K * K + 61 * K + 3 * H * W + 3 * K * (H + W) + 8;
}

__device__ inline Smem carve(float* base, int K, int H, int W) {
  Smem s;
  float* q = base;
  const int D = 3 * K;
  auto take = [&q](int n) { float* r = q; q += n; return r; };
  s.su = take(K); s.sv = take(K); s.x = take(K); s.y = take(K); s.w = take(K);
  s.wcx = take(K); s.wcy = take(K); s.wcx2 = take(K); s.wcy2 = take(K);
  s.wcxx = take(K); s.wcyy = take(K); s.wcxcy = take(K); s.m = take(K);
  s.cu = take(K); s.cv = take(K); s.cs = take(K);
  s.dots = take(9 * K);
  s.th_b = take(D); s.p_b = take(D); s.ph = take(D); s.th = take(D);
  s.base = take(D); s.vec = take(D); s.t1 = take(D); s.infod = take(D);
  s.a = take(D); s.ldiag = take(D); s.dh = take(D); s.rhs = take(D);
  s.scal = take(8);
  s.img = take(H * W); s.r1 = take(H * W); s.fld = take(H * W);
  s.gx = take(K * W); s.gx1 = take(K * W); s.gx2 = take(K * W);
  s.gy = take(K * H); s.gy1 = take(K * H); s.gy2 = take(K * H);
  s.sraw = take(18 * K * K);
  s.gmat = take(D * D); s.lw = take(D * D); s.ginv = take(D * D);
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

// Block-wide sum of a per-thread double, returned to every thread.
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

// Per-star coefficients and the six profile sets at theta `th` (D, packed).
// Every thread of the block calls it; it ends synchronised.
__device__ void profiles(const Params& P, const Smem& s, const float* th) {
  const int tid = threadIdx.x;
  const int K = P.K, H = P.H, W = P.W;
  const float sig = P.psf_sigma;
  if (tid < K) {
    const int i = tid;
    const float su = sigmoidf(th[i]), sv = sigmoidf(th[K + i]);
    const float cx = W * su * (1.0f - su), cy = H * sv * (1.0f - sv);
    const float cx2 = cx * (1.0f - 2.0f * su), cy2 = cy * (1.0f - 2.0f * sv);
    const float m = s.m[i];
    const float w = (m != 0.0f) ? expf(th[2 * K + i]) * m : 0.0f;
    s.su[i] = su; s.sv[i] = sv;
    s.x[i] = W * su; s.y[i] = H * sv; s.w[i] = w;
    s.wcx[i] = w * cx; s.wcy[i] = w * cy; s.wcx2[i] = w * cx2; s.wcy2[i] = w * cy2;
    s.wcxx[i] = w * cx * cx; s.wcyy[i] = w * cy * cy; s.wcxcy[i] = w * cx * cy;
  }
  __syncthreads();
  const float sig2 = sig * sig;
  for (int n = tid; n < K * W; n += kThreads) {
    const int i = n / W, col = n - i * W;
    const float z = ((col + 0.5f) - s.x[i]) / sig;
    const float g = expf(-0.5f * z * z) * P.psf_norm;
    s.gx[n] = g; s.gx1[n] = g * z / sig; s.gx2[n] = g * (z * z - 1.0f) / sig2;
  }
  for (int n = tid; n < K * H; n += kThreads) {
    const int i = n / H, row = n - i * H;
    const float z = ((row + 0.5f) - s.y[i]) / sig;
    const float g = expf(-0.5f * z * z) * P.psf_norm;
    s.gy[n] = g; s.gy1[n] = g * z / sig; s.gy2[n] = g * (z * z - 1.0f) / sig2;
  }
  __syncthreads();
}

// lam -> s.r1 = 1/lam.  With `full`, also s.fld = beta (D/lam - 1) and the
// log-likelihood sum_p D log lam - lam (double), returned to every thread.
__device__ double render(const Params& P, const Smem& s, float beta, bool full,
                         double* red) {
  const int tid = threadIdx.x;
  const int K = P.K, H = P.H, W = P.W;
  double ll = 0.0;
  for (int pix = tid; pix < H * W; pix += kThreads) {
    const int h = pix / W, col = pix - h * W;
    float lam = P.background;
    for (int i = 0; i < K; ++i) lam = lam + (s.gy[i * H + h] * s.w[i]) * s.gx[i * W + col];
    const float r1 = 1.0f / lam;
    s.r1[pix] = r1;
    if (full) {
      const float d = s.img[pix];
      ll += static_cast<double>(d * logf(lam) - lam);
      s.fld[pix] = beta * (d * r1 - 1.0f);
    }
  }
  if (!full) {
    __syncthreads();
    return 0.0;
  }
  return block_sum_d(ll, red);  // synchronises
}

// Field contractions, one warp per star: lanes over columns sum the field
// against gy, gy', gy'' down the rows, then W-length dots by warp shuffles.
// Results per star i at s.dots[n K + i]:
//   n = 0..5: A1 = gx'.rg, A2 = gx''.rg, A3 = gx'.rg1, A4 = gx.rg1,
//             A5 = gx.rg2, A6 = gx.rg   for rg* = sum_h f1 gy*
//   n = 6..8: B1 = gx'.rb, B4 = gx.rb1, B6 = gx.rb  for rb* = sum_h f2 gy*
// Modes (f1, f2 at pixel p from s.fld and s.r1):
//   kGrad:  f1 = rho                       -> A1, A4, A6
//   kQ:     f1 = q / lam^2                 -> A1, A4, A6
//   kSweep: f1 = phi / lam, f2 = f1^2      -> A1..A6, B1, B4, B6
enum { kGrad = 0, kQ = 1, kSweep = 2 };

template <int MODE>
__device__ void contract(const Params& P, const Smem& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = P.K, H = P.H, W = P.W;
  for (int i = warp; i < K; i += kWarps) {
    const float *gy = s.gy + i * H, *gy1 = s.gy1 + i * H, *gy2 = s.gy2 + i * H;
    float a1 = 0.f, a2 = 0.f, a3 = 0.f, a4 = 0.f, a5 = 0.f, a6 = 0.f;
    float b1 = 0.f, b4 = 0.f, b6 = 0.f;
    for (int col = lane; col < W; col += 32) {
      float rg = 0.f, rg1 = 0.f, rg2 = 0.f, rb = 0.f, rb1 = 0.f;
      for (int h = 0; h < H; ++h) {
        const int pix = h * W + col;
        float f1 = s.fld[pix];
        if (MODE == kQ) {
          const float r = s.r1[pix];
          f1 = f1 * (r * r);
        } else if (MODE == kSweep) {
          f1 = f1 * s.r1[pix];
        }
        rg += f1 * gy[h];
        rg1 += f1 * gy1[h];
        if (MODE == kSweep) {
          rg2 += f1 * gy2[h];
          const float f2 = f1 * f1;
          rb += f2 * gy[h];
          rb1 += f2 * gy1[h];
        }
      }
      const int n = i * W + col;
      const float gx = s.gx[n], gx1 = s.gx1[n];
      a1 += gx1 * rg;
      a4 += gx * rg1;
      a6 += gx * rg;
      if (MODE == kSweep) {
        a2 += s.gx2[n] * rg;
        a3 += gx1 * rg1;
        a5 += gx * rg2;
        b1 += gx1 * rb;
        b4 += gx * rb1;
        b6 += gx * rb;
      }
    }
    a1 = warp_sum(a1); a4 = warp_sum(a4); a6 = warp_sum(a6);
    if (MODE == kSweep) {
      a2 = warp_sum(a2); a3 = warp_sum(a3); a5 = warp_sum(a5);
      b1 = warp_sum(b1); b4 = warp_sum(b4); b6 = warp_sum(b6);
    }
    if (lane == 0) {
      s.dots[i] = a1; s.dots[3 * K + i] = a4; s.dots[5 * K + i] = a6;
      if (MODE == kSweep) {
        s.dots[K + i] = a2; s.dots[2 * K + i] = a3; s.dots[4 * K + i] = a5;
        s.dots[6 * K + i] = b1; s.dots[7 * K + i] = b4; s.dots[8 * K + i] = b6;
      }
    }
  }
  __syncthreads();
}

// The six distinct Hessian profiles hp of star i, as (Y, X) indices into
// (gy, gy', gy'') and (gx, gx', gx''):
//   0 (gy, gx')  1 (gy, gx'')  2 (gy', gx')  3 (gy', gx)  4 (gy'', gx)  5 (gy, gx)
// and the three Jacobian profiles of type tb (u, v, s) as (Y, X):
//   u (gy, gx')  v (gy', gx)  s (gy, gx);  type t's own profile is hp = hp_of_type(t).
__device__ __forceinline__ int hp_of_type(int t) { return t == 0 ? 0 : (t == 1 ? 3 : 5); }

// Pair contractions, one warp per star pair (i, j):
//   Sraw[hp][tb][i][j] = sum_p Hprof_hp,i(p) Jprof_tb,j(p) / lam(p).
// FULL: every ordered pair and all 18 (hp, tb), for F and S.  Otherwise the
// pairs i <= j and only hp = hp_of_type(ta) (the 9 entries F needs), written to
// both (i, j) and, mirrored, (j, i).
template <bool FULL>
__device__ void pair_contract(const Params& P, const Smem& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = P.K, H = P.H, W = P.W, KK = K * K;
  const int n_units = FULL ? KK : K * (K + 1) / 2;
  for (int u = warp; u < n_units; u += kWarps) {
    int i, j;
    if (FULL) {
      i = u / K; j = u - i * K;
    } else {  // u -> (i, j), i <= j, row by row
      i = 0;
      int rem = u;
      while (rem >= K - i) { rem -= K - i; ++i; }
      j = i + rem;
    }
    const float *yi0 = s.gy + i * H, *yi1 = s.gy1 + i * H, *yi2 = s.gy2 + i * H;
    const float *yj0 = s.gy + j * H, *yj1 = s.gy1 + j * H;
    float acc[18];
#pragma unroll
    for (int n = 0; n < 18; ++n) acc[n] = 0.f;
    for (int col = lane; col < W; col += 32) {
      // T[yi][yj] = sum_h Yi(h) Yj(h) R1(h, col)
      float t00 = 0.f, t01 = 0.f, t10 = 0.f, t11 = 0.f, t20 = 0.f, t21 = 0.f;
      for (int h = 0; h < H; ++h) {
        const float r = s.r1[h * W + col];
        const float rb0 = r * yj0[h], rb1 = r * yj1[h];
        const float a0 = yi0[h], a1 = yi1[h];
        t00 += a0 * rb0; t01 += a0 * rb1;
        t10 += a1 * rb0; t11 += a1 * rb1;
        if (FULL) {
          const float a2 = yi2[h];
          t20 += a2 * rb0; t21 += a2 * rb1;
        }
      }
      const float T[3][2] = {{t00, t01}, {t10, t11}, {t20, t21}};
      const int ni = i * W + col, nj = j * W + col;
      const float xi[3] = {s.gx[ni], s.gx1[ni], s.gx2[ni]};
      const float xj[2] = {s.gx[nj], s.gx1[nj]};
#pragma unroll
      for (int hp = 0; hp < 6; ++hp) {
        if (!FULL && hp != 0 && hp != 3 && hp != 5) continue;
#pragma unroll
        for (int tb = 0; tb < 3; ++tb) {
          const int yh = hp == 4 ? 2 : ((hp == 2 || hp == 3) ? 1 : 0);
          const int xh = (hp == 0 || hp == 2) ? 1 : (hp == 1 ? 2 : 0);
          const int yb = tb == 1 ? 1 : 0;
          const int xb = tb == 0 ? 1 : 0;
          acc[hp * 3 + tb] += xi[xh] * xj[xb] * T[yh][yb];
        }
      }
    }
#pragma unroll
    for (int hp = 0; hp < 6; ++hp) {
      if (!FULL && hp != 0 && hp != 3 && hp != 5) continue;
#pragma unroll
      for (int tb = 0; tb < 3; ++tb) acc[hp * 3 + tb] = warp_sum(acc[hp * 3 + tb]);
    }
    if (lane == 0) {
      if (FULL) {
#pragma unroll
        for (int n = 0; n < 18; ++n) s.sraw[n * KK + i * K + j] = acc[n];
      } else {
#pragma unroll
        for (int ta = 0; ta < 3; ++ta) {
#pragma unroll
          for (int tb = 0; tb < 3; ++tb) {
            const float v = acc[hp_of_type(ta) * 3 + tb];
            s.sraw[(hp_of_type(ta) * 3 + tb) * KK + i * K + j] = v;
            s.sraw[(hp_of_type(tb) * 3 + ta) * KK + j * K + i] = v;
          }
        }
      }
    }
  }
  __syncthreads();
}

// coef_a of J_a for type t of star i: (w cx, w cy, w)
__device__ __forceinline__ float jcoef(const Smem& s, int t, int i) {
  return t == 0 ? s.wcx[i] : (t == 1 ? s.wcy[i] : s.w[i]);
}

// G = beta F + diag(info + (1 - m) + jitter) into s.gmat from s.sraw (F's
// nine entries per star pair), and info' into s.infod when `with_infod`.
__device__ void assemble_metric(const Params& P, const Smem& s, float beta,
                                bool with_infod) {
  const int tid = threadIdx.x;
  const int K = P.K, D = 3 * K, KK = K * K;
  for (int n = tid; n < D * D; n += kThreads) {
    const int ra = n / D, cb = n - ra * D;
    const int ta = ra / K, i = ra - ta * K, tb = cb / K, j = cb - tb * K;
    const float f = jcoef(s, ta, i) * jcoef(s, tb, j)
                    * s.sraw[(hp_of_type(ta) * 3 + tb) * KK + i * K + j];
    float g = beta * f;
    if (ra == cb) {
      const float m = s.m[i];
      const float info = ta == 0 ? 2.0f * s.su[i] * (1.0f - s.su[i]) * m
                       : (ta == 1 ? 2.0f * s.sv[i] * (1.0f - s.sv[i]) * m
                                  : m / (P.logf_sigma * P.logf_sigma));
      g = g + ((info + (1.0f - m)) + P.jitter);
      if (with_infod)
        s.infod[ra] = ta == 0 ? info * (1.0f - 2.0f * s.su[i])
                    : (ta == 1 ? info * (1.0f - 2.0f * s.sv[i]) : 0.0f);
    }
    s.gmat[n] = g;
  }
  __syncthreads();
}

// Right-looking Cholesky of s.gmat in place: the strict lower triangle of
// s.gmat holds L below the diagonal and s.ldiag its diagonal; the upper
// triangle is left as it was.  A non-positive pivot makes NaN that reaches
// every later column.  Returns log det G (double) to every thread.
__device__ double cholesky(const Params& P, const Smem& s, double* red) {
  const int tid = threadIdx.x;
  const int D = 3 * P.K;
  for (int j = 0; j < D; ++j) {
    const float ajj = s.gmat[j * D + j];
    const float dinv = 1.0f / sqrtf(ajj);
    for (int r = j + 1 + tid; r < D; r += kThreads) s.gmat[r * D + j] *= dinv;
    if (tid == 0) s.ldiag[j] = ajj * dinv;
    __syncthreads();
    const int n = D - j - 1;
    for (int e = tid; e < n * n; e += kThreads) {
      const int r = j + 1 + e / n, c = j + 1 + e % n;
      if (c <= r) s.gmat[r * D + c] -= s.gmat[r * D + j] * s.gmat[c * D + j];
    }
    __syncthreads();
  }
  double ld = 0.0;
  for (int j = tid; j < D; j += kThreads) ld += static_cast<double>(logf(s.ldiag[j]));
  return 2.0 * block_sum_d(ld, red);
}

// L^-1 row by row into s.lw (lower triangle), then G^-1 = L^-T L^-1 into
// s.ginv.
__device__ void inverse(const Params& P, const Smem& s) {
  const int tid = threadIdx.x;
  const int D = 3 * P.K;
  for (int r = 0; r < D; ++r) {
    for (int c = tid; c <= r; c += kThreads) {
      float acc = 0.0f;
      for (int k = c; k < r; ++k) acc += s.gmat[r * D + k] * s.lw[k * D + c];
      s.lw[r * D + c] = ((c == r ? 1.0f : 0.0f) - acc) / s.ldiag[r];
    }
    __syncthreads();
  }
  for (int n = tid; n < D * D; n += kThreads) {
    const int a = n / D, b = n - a * D;
    float acc = 0.0f;
    for (int k = a > b ? a : b; k < D; ++k) acc += s.lw[k * D + a] * s.lw[k * D + b];
    s.ginv[n] = acc;
  }
  __syncthreads();
}

// out = G^-1 p by forward and back substitution on the factor in s.gmat /
// s.ldiag (warp 0; s.rhs holds L^-1 p).  Ends synchronised.
__device__ void chol_solve(const Params& P, const Smem& s, const float* p, float* out) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int D = 3 * P.K;
  if (tid < 32) {
    for (int r = 0; r < D; ++r) {
      float acc = 0.0f;
      for (int k = lane; k < r; k += 32) acc += s.gmat[r * D + k] * s.rhs[k];
      acc = warp_sum(acc);
      if (lane == 0) s.rhs[r] = (p[r] - acc) / s.ldiag[r];
      __syncwarp();
    }
    for (int r = D - 1; r >= 0; --r) {
      float acc = 0.0f;
      for (int k = r + 1 + lane; k < D; k += 32) acc += s.gmat[k * D + r] * out[k];
      acc = warp_sum(acc);
      if (lane == 0) out[r] = (s.rhs[r] - acc) / s.ldiag[r];
      __syncwarp();
    }
  }
  __syncthreads();
}

// out = G^-1 p with the carried s.ginv (D threads).  Ends synchronised.
__device__ void ginv_matvec(const Params& P, const Smem& s, const float* p, float* out) {
  const int tid = threadIdx.x;
  const int D = 3 * P.K;
  if (tid < D) {
    float acc = 0.0f;
    for (int b = 0; b < D; ++b) acc += s.ginv[tid * D + b] * p[b];
    out[tid] = acc;
  }
  __syncthreads();
}

// q(p) = sum_ab Ginv_ab J_a(p) J_b(p) into s.fld: per pixel, the 3K Jacobian
// values in registers and the K (K + 1) / 2 3x3 blocks of G^-1 by broadcast.
__device__ void q_field(const Params& P, const Smem& s) {
  const int tid = threadIdx.x;
  const int K = P.K, H = P.H, W = P.W, D = 3 * K;
  for (int pix = tid; pix < H * W; pix += kThreads) {
    const int h = pix / W, col = pix - h * W;
    float J[3 * kMaxStars];
#pragma unroll
    for (int i = 0; i < kMaxStars; ++i) {
      if (i < K) {
        const float gy = s.gy[i * H + h], gy1 = s.gy1[i * H + h];
        const float gx = s.gx[i * W + col], gx1 = s.gx1[i * W + col];
        J[3 * i] = s.wcx[i] * gy * gx1;
        J[3 * i + 1] = s.wcy[i] * gy1 * gx;
        J[3 * i + 2] = s.w[i] * gy * gx;
      } else {
        J[3 * i] = J[3 * i + 1] = J[3 * i + 2] = 0.0f;
      }
    }
    float q = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxStars; ++i) {
      if (i < K) {
#pragma unroll
        for (int j = i; j < kMaxStars; ++j) {
          if (j < K) {
            float acc = 0.0f;
#pragma unroll
            for (int ta = 0; ta < 3; ++ta) {
              const float* row = s.ginv + (ta * K + i) * D;
              float racc = 0.0f;
#pragma unroll
              for (int tb = 0; tb < 3; ++tb) racc += row[tb * K + j] * J[3 * j + tb];
              acc += J[3 * i + ta] * racc;
            }
            q += (i == j) ? acc : 2.0f * acc;
          }
        }
      }
    }
    s.fld[pix] = q;
  }
  __syncthreads();
}

// phi(p) = sum_b a_b J_b(p) into s.fld, from the per-star a_b coef_b in
// s.cu, s.cv, s.cs.
__device__ void phi_field(const Params& P, const Smem& s) {
  const int tid = threadIdx.x;
  const int K = P.K, H = P.H, W = P.W;
  for (int pix = tid; pix < H * W; pix += kThreads) {
    const int h = pix / W, col = pix - h * W;
    float phi = 0.0f;
    for (int i = 0; i < K; ++i) {
      const float tx = s.cu[i] * s.gx1[i * W + col] + s.cs[i] * s.gx[i * W + col];
      phi = phi + s.gy[i * H + h] * tx;
      phi = phi + s.gy1[i * H + h] * (s.cv[i] * s.gx[i * W + col]);
    }
    s.fld[pix] = phi;
  }
  __syncthreads();
}

// Everything theta-dependent at s.th_b: profiles, 1/lam, U_beta (s.scal[0]),
// log det G (s.scal[1]), the factor L (s.gmat / s.ldiag), G^-1, info' and
// t1.  Every thread calls it; it ends synchronised.
__device__ void build_structs(const Params& P, const Smem& s, float beta, double* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = P.K, D = 3 * K, KK = K * K;
  profiles(P, s, s.th_b);
  const double ll = render(P, s, beta, true, red);
  contract<kGrad>(P, s);
  if (warp == 0) {
    double lp = 0.0;
    if (lane < K) {
      const int i = lane;
      const float u = s.th_b[i], v = s.th_b[K + i], sl = s.th_b[2 * K + i];
      const float m = s.m[i];
      const float lp_pos = -(softplusf(u) + softplusf(-u) + softplusf(v) + softplusf(-v));
      const float zf = (sl - P.logf_mean) / P.logf_sigma;
      const float lp_flux = -0.5f * zf * zf + P.lp_flux_const;
      lp = static_cast<double>((lp_pos + lp_flux) * m);
      // grad U_beta into t1, to which the metric terms are added below
      s.t1[i] = -(s.wcx[i] * s.dots[i] + (1.0f - 2.0f * s.su[i]) * m);
      s.t1[K + i] = -(s.wcy[i] * s.dots[3 * K + i] + (1.0f - 2.0f * s.sv[i]) * m);
      s.t1[2 * K + i] = -(s.w[i] * s.dots[5 * K + i] + (-zf / P.logf_sigma) * m);
    }
    lp = warp_sum_d(lp);
    if (lane == 0) s.scal[0] = static_cast<float>(-(static_cast<double>(beta) * ll + lp));
  }
  pair_contract<true>(P, s);  // synchronises, so t1 and scal[0] are visible
  assemble_metric(P, s, beta, true);
  const double logdet = cholesky(P, s, red);
  if (tid == 0) s.scal[1] = static_cast<float>(logdet);
  inverse(P, s);
  q_field(P, s);
  contract<kQ>(P, s);
  if (tid < D) {
    const int tc = tid / K, i = tid - tc * K;
    // sum_{a in star i} sum_b Ginv_ab S_acb with S assembled from Sraw:
    //   S[m][tb][i][j] = coef_tb,j sum_terms coefH_i Sraw[hp][tb][i][j]
    float sg = 0.0f;
    for (int ta = 0; ta < 3; ++ta) {
      // combo (ta, tc) -> its Hessian terms (coef, hp), from _H_TERMS
      int hp0, hp1 = -1;
      float c0, c1 = 0.0f;
      const int lo = ta < tc ? ta : tc, hi = ta < tc ? tc : ta;
      if (lo == 0 && hi == 0) { hp0 = 0; c0 = s.wcx2[i]; hp1 = 1; c1 = s.wcxx[i]; }
      else if (lo == 0 && hi == 1) { hp0 = 2; c0 = s.wcxcy[i]; }
      else if (lo == 0 && hi == 2) { hp0 = 0; c0 = s.wcx[i]; }
      else if (lo == 1 && hi == 1) { hp0 = 3; c0 = s.wcy2[i]; hp1 = 4; c1 = s.wcyy[i]; }
      else if (lo == 1 && hi == 2) { hp0 = 3; c0 = s.wcy[i]; }
      else { hp0 = 5; c0 = s.w[i]; }
      const float* grow = s.ginv + (ta * K + i) * D;
      for (int tb = 0; tb < 3; ++tb) {
        const float* r0 = s.sraw + (hp0 * 3 + tb) * KK + i * K;
        const float* r1 = hp1 >= 0 ? s.sraw + (hp1 * 3 + tb) * KK + i * K : nullptr;
        float acc = 0.0f;
        for (int j = 0; j < K; ++j) {
          float sv = c0 * r0[j];
          if (r1 != nullptr) sv = sv + c1 * r1[j];
          acc += grow[tb * K + j] * (jcoef(s, tb, j) * sv);
        }
        sg += acc;
      }
    }
    const float cq = jcoef(s, tc, i) * s.dots[(tc == 0 ? 0 : (tc == 1 ? 3 : 5)) * K + i];
    s.t1[tid] = s.t1[tid] + beta * sg - 0.5f * beta * cq
                + 0.5f * s.ginv[tid * D + tid] * s.infod[tid];
  }
  __syncthreads();
}

// dH/dtheta at the structs' theta and momentum p (D) into out: t1 + t2(a).
__device__ void dh_dtheta(const Params& P, const Smem& s, float beta, const float* p,
                          float* out) {
  const int tid = threadIdx.x;
  const int K = P.K, D = 3 * K;
  ginv_matvec(P, s, p, s.a);
  if (tid < K) {
    s.cu[tid] = s.a[tid] * s.wcx[tid];
    s.cv[tid] = s.a[K + tid] * s.wcy[tid];
    s.cs[tid] = s.a[2 * K + tid] * s.w[tid];
  }
  __syncthreads();
  phi_field(P, s);
  contract<kSweep>(P, s);
  if (tid < D) {
    const int tc = tid / K, i = tid - tc * K;
    const float* d = s.dots;
    const float a1 = d[i], a2 = d[K + i], a3 = d[2 * K + i], a4 = d[3 * K + i],
                a5 = d[4 * K + i], a6 = d[5 * K + i];
    const float huu = s.wcx2[i] * a1 + s.wcxx[i] * a2;
    const float huv = s.wcxcy[i] * a3;
    const float hus = s.wcx[i] * a1;
    const float hvv = s.wcy2[i] * a4 + s.wcyy[i] * a5;
    const float hvs = s.wcy[i] * a4;
    const float hss = s.w[i] * a6;
    const float au = s.a[i], av = s.a[K + i], as = s.a[2 * K + i];
    float sv, ct;
    if (tc == 0) {
      sv = au * huu + av * huv + as * hus;
      ct = s.wcx[i] * d[6 * K + i];
    } else if (tc == 1) {
      sv = au * huv + av * hvv + as * hvs;
      ct = s.wcy[i] * d[7 * K + i];
    } else {
      sv = au * hus + av * hvs + as * hss;
      ct = s.w[i] * d[8 * K + i];
    }
    const float ac = s.a[tid];
    out[tid] = s.t1[tid] + (-beta * sv + 0.5f * beta * ct - 0.5f * (ac * ac) * s.infod[tid]);
  }
  __syncthreads();
}

// G(th)^-1 p by a fresh metric build at th (profiles, 1/lam, F, Cholesky and
// two triangular solves; no S, no q, no t1) into out.
__device__ void fisher_solve(const Params& P, const Smem& s, float beta, const float* th,
                             const float* p, float* out, double* red) {
  profiles(P, s, th);
  render(P, s, beta, false, red);
  pair_contract<false>(P, s);
  assemble_metric(P, s, beta, false);
  cholesky(P, s, red);
  chol_solve(P, s, p, out);
}

// Relative sup-norm Picard delta max|x_new - x_old| / (1 + max|x_new|) over
// the D entries, NaN-propagating; returned to every thread.
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
    if (lane == 0) s.scal[3] = num / (1.0f + den);
  }
  __syncthreads();
  const float d = s.scal[3];
  __syncthreads();
  return d;
}

// H = U + 1/2 log det G + 1/2 p^T G^-1 p at the structs' theta, momentum p.
__device__ float hamiltonian(const Params& P, const Smem& s, const float* p) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int D = 3 * P.K;
  ginv_matvec(P, s, p, s.a);
  if (tid < 32) {
    double kin = 0.0;
    for (int a = lane; a < D; a += 32) kin += static_cast<double>(p[a] * s.a[a]);
    kin = warp_sum_d(kin);
    if (lane == 0)
      s.scal[2] = static_cast<float>(static_cast<double>(s.scal[0])
                                     + 0.5 * static_cast<double>(s.scal[1]) + 0.5 * kin);
  }
  __syncthreads();
  const float h = s.scal[2];
  __syncthreads();
  return h;
}

__global__ void __launch_bounds__(kThreads) fused_rhmc_kernel(Params P) {
  extern __shared__ float smem[];
  __shared__ double red[kWarps];
  const int c = blockIdx.x, tid = threadIdx.x;
  const int K = P.K, H = P.H, W = P.W, D = 3 * K;
  const Smem s = carve(smem, K, H, W);
  const float eps = P.eps[c];
  const float half_eps = 0.5f * eps;
  const float beta = *P.beta;

  for (int n = tid; n < H * W; n += kThreads) s.img[n] = P.image[n];
  if (tid < K) s.m[tid] = P.mask[c * P.mask_stride + tid];
  if (tid < D) {  // (K, 3) star-major in memory -> packed a = t K + i
    const int t = tid / K, i = tid - t * K;
    s.th_b[tid] = P.theta[c * D + 3 * i + t];
    s.vec[tid] = P.xi[c * D + 3 * i + t];
  }
  __syncthreads();

  build_structs(P, s, beta, red);
  // p0 = (L xi) m, L the factor of G(theta0) that build_structs left behind
  if (tid < D) {
    float acc = s.ldiag[tid] * s.vec[tid];
    for (int k = 0; k < tid; ++k) acc += s.gmat[tid * D + k] * s.vec[k];
    s.p_b[tid] = acc * s.m[tid % K];
  }
  __syncthreads();
  const float h0 = hamiltonian(P, s, s.p_b);

  float resid = 0.0f;
  for (int step = 0; step < P.n_steps; ++step) {
    // implicit momentum half-step: p_h = p - eps/2 dH/dtheta(theta, p_h)
    if (tid < D) s.ph[tid] = s.p_b[tid];
    __syncthreads();
    float d1 = 0.0f;
    for (int it = 0; it < P.fpi; ++it) {
      dh_dtheta(P, s, beta, s.ph, s.dh);
      if (tid < D) s.dh[tid] = s.p_b[tid] - half_eps * s.dh[tid];
      __syncthreads();
      d1 = fp_delta(s, D, s.dh, s.ph);
      if (tid < D) s.ph[tid] = s.dh[tid];
      __syncthreads();
    }
    // implicit position step: theta' = theta + eps/2 [G(theta)^-1 + G(theta')^-1] p_h
    ginv_matvec(P, s, s.ph, s.vec);
    if (tid < D) {
      s.base[tid] = s.th_b[tid] + half_eps * s.vec[tid];
      s.th[tid] = s.th_b[tid] + eps * s.vec[tid];
    }
    __syncthreads();
    float d2 = 0.0f;
    for (int it = 0; it < P.fpi; ++it) {
      fisher_solve(P, s, beta, s.th, s.ph, s.vec, red);
      if (tid < D) s.vec[tid] = s.base[tid] + half_eps * s.vec[tid];
      __syncthreads();
      d2 = fp_delta(s, D, s.vec, s.th);
      if (tid < D) s.th[tid] = s.vec[tid];
      __syncthreads();
    }
    // rebuild at theta'; reused by the final half-step, h1 and the next step
    if (tid < D) s.th_b[tid] = s.th[tid];
    __syncthreads();
    build_structs(P, s, beta, red);
    dh_dtheta(P, s, beta, s.ph, s.dh);
    if (tid < D) s.p_b[tid] = s.ph[tid] - half_eps * s.dh[tid];
    __syncthreads();
    resid = nanmax(resid, nanmax(d1, d2));
  }
  const float h1 = hamiltonian(P, s, s.p_b);

  if (tid < D) {
    const int t = tid / K, i = tid - t * K;
    P.theta_out[c * D + 3 * i + t] = s.th_b[tid];
    P.p_out[c * D + 3 * i + t] = s.p_b[tid];
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
int starcat_fused_rhmc(
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
        fused_rhmc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fused_rhmc_kernel<<<C, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

const char* starcat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
