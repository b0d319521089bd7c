// Full-Fisher Riemannian trajectory on crowded fields on Hopper (sm_90a):
// B6c, for the scenes kernel B6 (csrc/fused_rhmc.cu) does not take, up to
// 128 x 128 pixels and K <= 64 catalog slots.
//
// The JAX package runs the full metric beyond its Pallas kernel's gate on
// XLA (starcat/api.py:205, the smc and trans-d "rhmc" mutations); its
// type-major tile starcat/pallas_rhmc.py:rhmc_trajectory_tile computes the
// same function on any shape.  This kernel keeps B6's call contract and
// math exactly: theta, xi (C, K, 3); eps (C,); mask (K,) or (C, K); beta
// read from a device scalar; out theta', p' (C, K, 3) and h0, h1, u1,
// resid (C,); static n_steps and fixed_point_iters, jitter.  p0 = L xi with
// L the factor of G in type-major order (a = t K + i), the closed-form
// dH/dtheta split into t1 (once per position) and t2 (every sweep) as
// csrc/fused_rhmc.cu's header sets out, fixed Picard sweeps.
//
// What bounds it on this card.  The work is the star-pair contractions over
// the field: a rebuild's 18 profile pairs of both orders and the q field,
// a position sweep's Fisher pairs, K_live^2 / 2 pairs of H W pixels each
// (chip_smoke.rhmc_full_ops; at 45 live stars on 128 x 128, 6 x 4 steps,
// about 9 GFLOP a chain), so it is bound by float32 operations.  One
// chain's state is about 1.1 MB at K = 64 on 128 x 128, five times what a
// block's shared memory holds.  The design, simple first:
//   * a persistent grid: one 512-thread block an SM walks the chains c,
//     c + gridDim.x, ...; each block owns a slice of a workspace in device
//     memory that the wrapper allocates (work_floats a block), so the
//     memory does not grow with the chain count.  A chain writes every
//     workspace entry before it reads it: nothing of the previous chain is
//     read;
//   * shared memory holds what every pair pass reuses: 1/lam (H rows at a
//     stride of W rounded up to 4, zero past column W) and the row profiles
//     gy, gy', gy'' of every star; the column profiles, the working field,
//     the pair contractions and the dense matrices live in the workspace;
//   * the live stars are compacted at entry: a dead slot is an identity row
//     of G with zero momentum, so the passes, the factorisation and the
//     solves run over D = 3 K_live, and dead slots come back as they went
//     in (theta bit for bit, p = 0), their log det term added in closed
//     form;
//   * the pair passes give each star pair a group of L lanes (L the power of
//     two at or above the row's 4-column chunks, 32 at 128 columns): lane g
//     takes chunk g, holds the pair's row products against 1/lam on its 4
//     columns in registers (16-byte loads of 1/lam, the row profiles by
//     broadcast), then meets the column profiles, and the L lanes sum by
//     shuffles in a fixed order;
//   * the dense algebra is block-wide: G and L by columns (entry (r, c) at c
//     ld + r), a right-looking Cholesky in panels of kPanel columns factored
//     by warp 0, every warp on the trailing update, so loads along a column
//     are coalesced; L^-1 by columns, one a warp; G^-1 = L^-T L^-1.
//
// Accuracy: no fast math.  The log-likelihood, log det G and the energies
// sum in double.  A non-positive pivot gives NaN, which propagates to the
// residual, a NaN-propagating max, so the head rejects the chain as a solver
// failure.  Every sum runs in a fixed order that depends on the scene and
// the chain's live stars only, not on the chain count or the block, so a
// chain gives the same bits alone, among others and at any chain count.
//
// Domain (checked by the wrapper, fused_rhmc_crowded.py): H, W <= 128 and
// 1 <= K <= 64; the shared memory (smem_floats) then stays within 180 KB.
#include <cuda_runtime.h>

// the block's dynamic shared memory, which carve() divides
extern __shared__ __align__(16) float b6c_smem[];

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStars = 64;
constexpr int kMaxSide = 128;
constexpr int kPanel = 8;  // columns of a Cholesky panel
// rows of a (D + 1)-row factorisation a lane of warp 0 holds
constexpr int kRows = (3 * kMaxStars + 1 + 31) / 32;
constexpr unsigned kFull = 0xffffffffu;

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
  float* work;          // (gridDim.x, work_floats(K, H, W))
  int C, K, H, W, n_steps, fpi;
  float psf_sigma, psf_norm, background;
  float logf_mean, logf_sigma, lp_flux_const, jitter;
};

// row stride of the fields and column profiles: W rounded up to 4, so a
// 4-column chunk is one 16-byte load
__host__ __device__ inline int field_stride(int W) { return (W + 3) & ~3; }

// odd star stride of the row profiles: the stars of different lane groups
// fall in distinct shared-memory banks
__host__ __device__ inline int prof_ld(int n) { return n | 1; }

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// mirrored by smem_bytes() in fused_rhmc_crowded.py: 1/lam, the three row
// profile sets, 25 floats a star (coefficients, mask, phi coefficients, 9
// field contractions), 11 vectors of D and 8 of scratch
__host__ __device__ inline int smem_floats(int K, int H, int W) {
  return H * field_stride(W) + 3 * K * prof_ld(H) + 58 * K + 8;
}

// mirrored by workspace_bytes() in fused_rhmc_crowded.py: the working field,
// the three column profile sets, the 18 K^2 pair contractions, G / L (D + 1
// columns of D + 1), L^-1 and G^-1, G^-1's 3x3 star blocks padded to 12
__host__ __device__ inline int work_floats(int K, int H, int W) {
  const int fs = field_stride(W), D = 3 * K;
  return H * fs + 3 * K * fs + round4(18 * K * K) + round4((D + 1) * (D + 1))
         + 2 * round4(D * (D + 1)) + 12 * K * K;
}

// Per-star scalars, index i over the live stars; per-parameter vectors,
// index a = t K + i.
struct Work {
  // shared memory
  float* r1;                        // (H, fs): 1/lam, 0 past column W
  float *gy, *gy1, *gy2;            // (K, hp): star i's rows at i * hp
  float *su, *sv, *x, *y, *w, *wcx, *wcy, *wcx2, *wcy2, *wcxx, *wcyy, *wcxcy, *m;
  float *cu, *cv, *cs;              // a_a coef_a per star, for the phi field
  float* dots;                      // (9, K) field contractions per star
  float *th_b, *p_b, *ph, *th, *base, *vec, *t1, *infod, *a, *ldiag, *dh;
  float* scal;                      // U, logdet, h, delta scratch
  // the block's workspace in device memory
  float* fld;                       // (H, fs): rho, then q, then phi
  float *gx, *gx1, *gx2;            // (K, fs): star i's columns at i * fs, 0 past W
  float* sraw;                      // (18, K, K): [(hp * 3 + tb) K + i] K + j
  float* gmat;                      // G, then L: entry (r, c), r >= c, at c ld + r; row D a rhs
  float* lw;                        // L^-1: entry (k, c) at k ld + c
  float* ginv;                      // G^-1 (symmetric)
  float* gblk;                      // (K, K, 12): G^-1's 3x3 block of stars (i, j)
  int K, D, ld, fs, hp, n_dead;     // K, D: the chain's live stars and parameters
};

// Shared arrays sized for the K slots, workspace arrays at this block's
// slice; the chain's own K, D and ld are set per chain.
__device__ Work carve(const Params& P) {
  Work s;
  const int K = P.K, H = P.H, W = P.W, D = 3 * K;
  s.fs = field_stride(W);
  s.hp = prof_ld(H);
  int q = 0;
  auto take = [&q](int n) { float* r = b6c_smem + q; q += n; return r; };
  s.r1 = take(H * s.fs);  // first: 16-byte aligned rows
  s.gy = take(K * s.hp); s.gy1 = take(K * s.hp); s.gy2 = take(K * s.hp);
  s.su = take(K); s.sv = take(K); s.x = take(K); s.y = take(K); s.w = take(K);
  s.wcx = take(K); s.wcy = take(K); s.wcx2 = take(K); s.wcy2 = take(K);
  s.wcxx = take(K); s.wcyy = take(K); s.wcxcy = take(K); s.m = take(K);
  s.cu = take(K); s.cv = take(K); s.cs = take(K);
  s.dots = take(9 * K);
  s.th_b = take(D); s.p_b = take(D); s.ph = take(D); s.th = take(D);
  s.base = take(D); s.vec = take(D); s.t1 = take(D); s.infod = take(D);
  s.a = take(D); s.ldiag = take(D); s.dh = take(D);
  s.scal = take(8);
  float* wk = P.work + static_cast<size_t>(blockIdx.x) * work_floats(K, H, W);
  size_t o = 0;
  auto grab = [wk, &o](int n) { float* r = wk + o; o += n; return r; };
  s.fld = grab(H * s.fs);
  s.gx = grab(K * s.fs); s.gx1 = grab(K * s.fs); s.gx2 = grab(K * s.fs);
  s.sraw = grab(round4(18 * K * K));
  s.gmat = grab(round4((D + 1) * (D + 1)));
  s.lw = grab(round4(D * (D + 1)));
  s.ginv = grab(round4(D * (D + 1)));
  s.gblk = grab(12 * K * K);  // 16-byte aligned: every size before is a multiple of 4
  s.K = K; s.D = D; s.ld = D + 1; s.n_dead = 0;
  return s;
}

// type t of parameter a = t K + i, without a division
__device__ __forceinline__ int type_of(int a, int K) { return (a >= K) + (a >= 2 * K); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum_d(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// max that propagates NaN from either side (fmaxf drops it)
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float warp_nanmax(float v) {
  for (int o = 16; o > 0; o >>= 1) v = nanmax(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float softplusf(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
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
__device__ void profiles(const Params& P, const Work& s, const float* th) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = s.K, H = P.H, W = P.W, fs = s.fs, hp = s.hp;
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
  for (int i = warp; i < K; i += kWarps) {
    const float xs = s.x[i], ys = s.y[i];
    for (int col = lane; col < fs; col += 32) {
      const int n = i * fs + col;
      if (col < W) {
        const float z = ((col + 0.5f) - xs) / sig;
        const float g = expf(-0.5f * z * z) * P.psf_norm;
        s.gx[n] = g; s.gx1[n] = g * z / sig; s.gx2[n] = g * (z * z - 1.0f) / sig2;
      } else {
        s.gx[n] = 0.0f; s.gx1[n] = 0.0f; s.gx2[n] = 0.0f;
      }
    }
    for (int row = lane; row < H; row += 32) {
      const int n = i * hp + row;
      const float z = ((row + 0.5f) - ys) / sig;
      const float g = expf(-0.5f * z * z) * P.psf_norm;
      s.gy[n] = g; s.gy1[n] = g * z / sig; s.gy2[n] = g * (z * z - 1.0f) / sig2;
    }
  }
  __syncthreads();
}

// lam -> s.r1 = 1/lam (0 past column W).  With `full`, also s.fld = beta
// (D/lam - 1) and the log-likelihood sum_p D log lam - lam (double),
// returned to every thread.  Ends synchronised.
__device__ double render(const Params& P, const Work& s, float beta, bool full,
                         double* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = s.K, H = P.H, W = P.W, fs = s.fs, hp = s.hp;
  double ll = 0.0;
  for (int h = warp; h < H; h += kWarps) {
    for (int col = lane; col < fs; col += 32) {
      const int pix = h * fs + col;
      if (col >= W) {
        s.r1[pix] = 0.0f;
        continue;
      }
      float lam = P.background;
      for (int i = 0; i < K; ++i) lam = lam + (s.gy[i * hp + h] * s.w[i]) * s.gx[i * fs + col];
      const float r1 = 1.0f / lam;
      s.r1[pix] = r1;
      if (full) {
        const float d = P.image[h * W + col];
        ll += static_cast<double>(d * logf(lam) - lam);
        s.fld[pix] = beta * (d * r1 - 1.0f);
      }
    }
  }
  if (!full) {
    __syncthreads();
    return 0.0;
  }
  return block_sum_d(ll, red);  // synchronises
}

// Field contractions, one warp per star: lanes over columns sum the field
// against gy, gy', gy'' down the rows, then W-length dots by warp shuffles
// (csrc/fused_rhmc.cu's contract: the same modes and results at
// s.dots[n K + i]).
enum { kGrad = 0, kQ = 1, kSweep = 2 };

template <int MODE>
__device__ void contract(const Params& P, const Work& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = s.K, H = P.H, W = P.W, fs = s.fs, hp = s.hp;
  for (int i = warp; i < K; i += kWarps) {
    const float *gy = s.gy + i * hp, *gy1 = s.gy1 + i * hp, *gy2 = s.gy2 + i * hp;
    float a1 = 0.f, a2 = 0.f, a3 = 0.f, a4 = 0.f, a5 = 0.f, a6 = 0.f;
    float b1 = 0.f, b4 = 0.f, b6 = 0.f;
    for (int col = lane; col < W; col += 32) {
      float rg = 0.f, rg1 = 0.f, rg2 = 0.f, rb = 0.f, rb1 = 0.f;
      for (int h = 0; h < H; ++h) {
        const int pix = h * fs + col;
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
      const int n = i * fs + col;
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

// The six distinct Hessian profiles hp of a star and the three Jacobian
// profiles of type tb are csrc/fused_rhmc.cu's; type t's own profile is
// hp = hp_of_type(t).
__device__ __forceinline__ int hp_of_type(int t) { return t == 0 ? 0 : (t == 1 ? 3 : 5); }

// star pair of unordered index u, i <= j, without a division
__device__ __forceinline__ void pair_of(int u, int K, int& i, int& j) {
  i = 0;
  while (u >= K - i) { u -= K - i; ++i; }
  j = i + u;
}

// The lane groups of a pair pass: a group of 1 << lg lanes a star pair, the
// power of two at or above the n_chunks 4-column chunks of a row (at most
// 32: W <= 128).
struct PairLanes {
  int lg, g, slot, per_round, n_chunks;
};

__device__ __forceinline__ PairLanes pair_lanes(int fs) {
  PairLanes q;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  q.n_chunks = fs >> 2;
  q.lg = 0;
  while ((1 << q.lg) < q.n_chunks) ++q.lg;
  q.g = lane & ((1 << q.lg) - 1);
  q.slot = (warp << (5 - q.lg)) + (lane >> q.lg);
  q.per_round = kWarps << (5 - q.lg);
  return q;
}

// Pair contractions of a rebuild:
//   Sraw[hp][tb][i][j] = sum_p Hprof_hp,i(p) Jprof_tb,j(p) / lam(p)
// and Sraw[hp][tb][j][i], all 18 (hp, tb) of both orders, from 8 row
// products a pair (csrc/fused_rhmc.cu's pair_contract, by lane groups).
__device__ void pair_contract(const Params& P, const Work& s) {
  const int K = s.K, H = P.H, fs = s.fs, hp = s.hp, KK = K * K;
  const int n_pairs = K * (K + 1) / 2;
  const PairLanes q = pair_lanes(fs);
  for (int base = 0; base < n_pairs; base += q.per_round) {
    const int u = base + q.slot;
    const bool has = u < n_pairs;
    int i, j;
    pair_of(has ? u : 0, K, i, j);
    float acc[18], acm[18];  // (i, j) and (j, i)
#pragma unroll
    for (int n = 0; n < 18; ++n) acc[n] = acm[n] = 0.f;
    if (has && q.g < q.n_chunks) {
      const float *yi0 = s.gy + i * hp, *yi1 = s.gy1 + i * hp, *yi2 = s.gy2 + i * hp;
      const float *yj0 = s.gy + j * hp, *yj1 = s.gy1 + j * hp, *yj2 = s.gy2 + j * hp;
      const float* rcol = s.r1 + 4 * q.g;
      float t[8][4];
#pragma unroll
      for (int n = 0; n < 32; ++n) (&t[0][0])[n] = 0.f;
      for (int h = 0; h < H; ++h) {
        const float a0 = yi0[h], a1 = yi1[h], a2 = yi2[h];
        const float b0 = yj0[h], b1 = yj1[h], b2 = yj2[h];
        const float pr[8] = {a0 * b0, a0 * b1, a1 * b0, a1 * b1,
                             a2 * b0, a2 * b1, a0 * b2, a1 * b2};
        const float4 r4 = load4(rcol + h * fs);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float r = comp(r4, k);
#pragma unroll
          for (int m = 0; m < 8; ++m) t[m][k] += pr[m] * r;
        }
      }
      const int ci = i * fs + 4 * q.g, cj = j * fs + 4 * q.g;
      const float4 xi0 = load4(s.gx + ci), xi1 = load4(s.gx1 + ci), xi2 = load4(s.gx2 + ci);
      const float4 xj0 = load4(s.gx + cj), xj1 = load4(s.gx1 + cj), xj2 = load4(s.gx2 + cj);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float xi[3] = {comp(xi0, k), comp(xi1, k), comp(xi2, k)};
        const float xj[3] = {comp(xj0, k), comp(xj1, k), comp(xj2, k)};
        const float T[3][3] = {{t[0][k], t[1][k], t[6][k]},
                               {t[2][k], t[3][k], t[7][k]},
                               {t[4][k], t[5][k], 0.f}};
#pragma unroll
        for (int hq = 0; hq < 6; ++hq) {
          const int yh = hq == 4 ? 2 : ((hq == 2 || hq == 3) ? 1 : 0);
          const int xh = (hq == 0 || hq == 2) ? 1 : (hq == 1 ? 2 : 0);
#pragma unroll
          for (int tb = 0; tb < 3; ++tb) {
            const int yb = tb == 1 ? 1 : 0;
            const int xb = tb == 0 ? 1 : 0;
            acc[hq * 3 + tb] += xi[xh] * xj[xb] * T[yh][yb];
            acm[hq * 3 + tb] += xj[xh] * xi[xb] * T[yb][yh];
          }
        }
      }
    }
    for (int o = 1; o < (1 << q.lg); o <<= 1) {
#pragma unroll
      for (int n = 0; n < 18; ++n) {
        acc[n] += __shfl_xor_sync(kFull, acc[n], o);
        acm[n] += __shfl_xor_sync(kFull, acm[n], o);
      }
    }
    if (has && q.g == 0) {
#pragma unroll
      for (int n = 0; n < 18; ++n) {
        s.sraw[n * KK + i * K + j] = acc[n];
        if (i != j) s.sraw[n * KK + j * K + i] = acm[n];
      }
    }
  }
  __syncthreads();
}

// The Fisher pairs of a position sweep: the 9 entries F needs per star pair
// (hp = hp_of_type(ta) against tb) from 4 row products, written to (i, j)
// and, mirrored, (j, i).
__device__ void fisher_pairs(const Params& P, const Work& s) {
  const int K = s.K, H = P.H, fs = s.fs, hp = s.hp, KK = K * K;
  const int n_pairs = K * (K + 1) / 2;
  const PairLanes q = pair_lanes(fs);
  for (int base = 0; base < n_pairs; base += q.per_round) {
    const int u = base + q.slot;
    const bool has = u < n_pairs;
    int i, j;
    pair_of(has ? u : 0, K, i, j);
    float acc[9];
#pragma unroll
    for (int n = 0; n < 9; ++n) acc[n] = 0.f;
    if (has && q.g < q.n_chunks) {
      const float *yi0 = s.gy + i * hp, *yi1 = s.gy1 + i * hp;
      const float *yj0 = s.gy + j * hp, *yj1 = s.gy1 + j * hp;
      const float* rcol = s.r1 + 4 * q.g;
      float t[4][4];
#pragma unroll
      for (int n = 0; n < 16; ++n) (&t[0][0])[n] = 0.f;
      for (int h = 0; h < H; ++h) {
        const float a0 = yi0[h], a1 = yi1[h], b0 = yj0[h], b1 = yj1[h];
        const float pr[4] = {a0 * b0, a0 * b1, a1 * b0, a1 * b1};
        const float4 r4 = load4(rcol + h * fs);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float r = comp(r4, k);
#pragma unroll
          for (int m = 0; m < 4; ++m) t[m][k] += pr[m] * r;
        }
      }
      const int ci = i * fs + 4 * q.g, cj = j * fs + 4 * q.g;
      const float4 xi0 = load4(s.gx + ci), xi1 = load4(s.gx1 + ci);
      const float4 xj0 = load4(s.gx + cj), xj1 = load4(s.gx1 + cj);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float xi[2] = {comp(xi0, k), comp(xi1, k)};
        const float xj[2] = {comp(xj0, k), comp(xj1, k)};
#pragma unroll
        for (int ta = 0; ta < 3; ++ta) {
          const int yh = ta == 1 ? 1 : 0, xh = ta == 0 ? 1 : 0;  // hp_of_type(ta)
#pragma unroll
          for (int tb = 0; tb < 3; ++tb) {
            const int yb = tb == 1 ? 1 : 0, xb = tb == 0 ? 1 : 0;
            acc[ta * 3 + tb] += xi[xh] * xj[xb] * t[yh * 2 + yb][k];
          }
        }
      }
    }
    for (int o = 1; o < (1 << q.lg); o <<= 1) {
#pragma unroll
      for (int n = 0; n < 9; ++n) acc[n] += __shfl_xor_sync(kFull, acc[n], o);
    }
    if (has && q.g == 0) {
#pragma unroll
      for (int ta = 0; ta < 3; ++ta) {
#pragma unroll
        for (int tb = 0; tb < 3; ++tb) {
          const float v = acc[ta * 3 + tb];
          s.sraw[(hp_of_type(ta) * 3 + tb) * KK + i * K + j] = v;
          s.sraw[(hp_of_type(tb) * 3 + ta) * KK + j * K + i] = v;
        }
      }
    }
  }
  __syncthreads();
}

// coef_a of J_a for type t of star i: (w cx, w cy, w)
__device__ __forceinline__ float jcoef(const Work& s, int t, int i) {
  return t == 0 ? s.wcx[i] : (t == 1 ? s.wcy[i] : s.w[i]);
}

// The lower triangle of G = beta F + diag(info + (1 - m) + jitter) into
// s.gmat by columns from s.sraw (columns over warps, rows over lanes),
// info' into s.infod when `with_infod`, and `rhs` (D, or null) into row D,
// where the factorisation turns it into L^-1 rhs.  Ends synchronised.
__device__ void assemble_metric(const Params& P, const Work& s, float beta,
                                bool with_infod, const float* rhs) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = s.K, D = s.D, KK = K * K, ld = s.ld;
  for (int cb = warp; cb < D; cb += kWarps) {
    const int tb = type_of(cb, K), j = cb - tb * K;
    const float cbj = jcoef(s, tb, j);
    for (int ra = cb + lane; ra < D; ra += 32) {
      const int ta = type_of(ra, K), i = ra - ta * K;
      const float f = jcoef(s, ta, i) * cbj * s.sraw[(hp_of_type(ta) * 3 + tb) * KK + i * K + j];
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
      s.gmat[cb * ld + ra] = g;
    }
  }
  if (rhs != nullptr)
    for (int c = tid; c < D; c += kThreads) s.gmat[c * ld + D] = rhs[c];
  __syncthreads();
}

// Blocked right-looking Cholesky of the first D rows of s.gmat, stored by
// columns, in panels of kPanel columns: warp 0 factors a panel column by
// column in dot-product form (lane l keeps rows l + 32 q, q < kRows: s_r =
// G_rj - sum_k L_rk L_jk over the panel's earlier columns, the pivot s_jj
// from its owner by a shuffle), then every warp applies the panel to the
// trailing matrix (columns over warps, rows over lanes, so every load runs
// down a column), so a factorisation takes two block barriers a panel.  Each
// entry takes its updates in column order.  s.gmat then holds L on and below
// the diagonal and s.ldiag its diagonal.  Rows D .. nrows - 1 (a right-hand
// side b in row D) are reduced alongside, which leaves L^-1 b in row D.  A
// non-positive pivot makes NaN that reaches every later column.  With
// `logdet`, warp 0 writes log det G to s.scal[1], the dead slots' identity
// rows (diagonal `ldead` of L) included.  Every thread calls it; it ends
// synchronised but for s.scal[1].
__device__ void cholesky(const Work& s, int nrows, bool logdet, float ldead) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = s.D, ld = s.ld;
  float* A = s.gmat;
  for (int p0 = 0; p0 < D; p0 += kPanel) {
    const int p1 = p0 + kPanel < D ? p0 + kPanel : D;
    if (warp == 0) {
      for (int j = p0; j < p1; ++j) {
        float sv[kRows];
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          const int r = lane + 32 * q;
          float v = 0.0f;
          if (r >= j && r < nrows) {
            v = A[j * ld + r];
            for (int k = p0; k < j; ++k) v -= A[k * ld + r] * A[k * ld + j];
          }
          sv[q] = v;
        }
        float own = 0.0f;
#pragma unroll
        for (int q = 0; q < kRows; ++q)
          if (q == (j >> 5)) own = sv[q];
        const float sjj = __shfl_sync(kFull, own, j & 31);
        const float dinv = 1.0f / sqrtf(sjj);
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          const int r = lane + 32 * q;
          if (r > j && r < nrows) A[j * ld + r] = sv[q] * dinv;
        }
        if (lane == 0) s.ldiag[j] = sjj * dinv;
        __syncwarp();
      }
    }
    __syncthreads();
    if (p1 == D) break;  // nothing trails the last panel
    // the trailing update: A_rc -= sum over the panel of L_rk L_ck, r >= c
    for (int c = p1 + warp; c < D; c += kWarps) {
      for (int r = c + lane; r < nrows; r += 32) {
        float a = A[c * ld + r];
        for (int k = p0; k < p1; ++k) a -= A[k * ld + r] * A[k * ld + c];
        A[c * ld + r] = a;
      }
    }
    __syncthreads();
  }
  if (logdet && warp == 0) {
    double ld_sum = 0.0;
    for (int j = lane; j < D; j += 32) ld_sum += static_cast<double>(logf(s.ldiag[j]));
    ld_sum = warp_sum_d(ld_sum);
    if (lane == 0)
      s.scal[1] = static_cast<float>(
          2.0 * (ld_sum + 3.0 * s.n_dead * static_cast<double>(logf(ldead))));
  }
}

// out = G^-1 b by back substitution, L^T out = L^-1 b, in warp 0 after
// cholesky(nrows = D + 1) left L^-1 b in row D: out_k = (y_k - sum_{r > k}
// L_rk out_r) / L_kk, the sum down column k by lanes.  Ends synchronised.
__device__ void chol_solve(const Work& s, float* out) {
  const int D = s.D, ld = s.ld;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const float* A = s.gmat;
    for (int k = D - 1; k >= 0; --k) {
      float part = 0.0f;
      for (int r = k + 1 + lane; r < D; r += 32) part += A[k * ld + r] * out[r];
      part = warp_sum(part);
      if (lane == 0) out[k] = (A[k * ld + D] - part) / s.ldiag[k];
      __syncwarp();
    }
  }
  __syncthreads();
}

// L^-1 into s.lw (by rows, lower triangle), one column per warp at a time by
// forward substitution on L e_c, then G^-1 = L^-T L^-1 into s.ginv and its
// 3x3 star blocks into s.gblk.  Every thread calls it; it ends synchronised.
__device__ void inverse(const Work& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = s.K, D = s.D, ld = s.ld;
  const float* A = s.gmat;
  for (int c = warp; c < D; c += kWarps) {
    float acc[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) acc[q] = lane + 32 * q == c ? 1.0f : 0.0f;
    for (int k = c; k < D; ++k) {
      float own = 0.0f;
#pragma unroll
      for (int q = 0; q < kRows; ++q)
        if (q == (k >> 5)) own = acc[q];
      const float rk = __shfl_sync(kFull, own, k & 31);
      const float xk = rk / s.ldiag[k];
      if (lane == (k & 31)) s.lw[k * ld + c] = xk;
      const float* lk = A + k * ld;  // column k of L
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int r = lane + 32 * q;
        if (r > k && r < D) acc[q] -= lk[r] * xk;
      }
    }
  }
  __syncthreads();
  for (int a = warp; a < D; a += kWarps) {
    const int ta = type_of(a, K), i = a - ta * K;
    for (int b = lane; b < D; b += 32) {
      const int tb = type_of(b, K), j = b - tb * K;
      float acc = 0.0f;
      for (int k = a > b ? a : b; k < D; ++k) acc += s.lw[k * ld + a] * s.lw[k * ld + b];
      s.ginv[a * ld + b] = acc;
      s.gblk[(i * K + j) * 12 + ta * 3 + tb] = i == j ? acc : 2.0f * acc;  // see q_field
    }
  }
  __syncthreads();
}

// out = G^-1 p with the carried s.ginv (D threads; G^-1 is symmetric, so
// thread a runs down column a, and a warp's loads are contiguous).  Ends
// synchronised.
__device__ void ginv_matvec(const Work& s, const float* p, float* out) {
  const int tid = threadIdx.x;
  const int D = s.D, ld = s.ld;
  if (tid < D) {
    float acc = 0.0f;
    for (int b = 0; b < D; ++b) acc += s.ginv[b * ld + tid] * p[b];
    out[tid] = acc;
  }
  __syncthreads();
}

// q(p) = sum_ab Ginv_ab J_a(p) J_b(p) into s.fld by star tiles, as
// csrc/fused_rhmc.cu's q_field: a thread takes two pixels (rows h, h + 1 of
// one column) and, for each tile of kQTile stars i, holds their Jacobian
// values at both pixels, then walks the stars j >= the tile's first and adds
// J_i^T Ginv_ij J_j for the tile's i <= j (s.gblk holds the blocks i < j
// doubled).
constexpr int kQTile = 4;

__device__ void q_field(const Params& P, const Work& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = s.K, H = P.H, W = P.W, hp = s.hp, fs = s.fs;
  for (int h0 = 2 * warp; h0 < H; h0 += 2 * kWarps) {
    const int h1 = h0 + 1 < H ? h0 + 1 : h0;  // an odd last row is computed twice, written once
    for (int col = lane; col < W; col += 32) {
      float q0 = 0.0f, q1 = 0.0f;
      for (int i0 = 0; i0 < K; i0 += kQTile) {
        float ja[kQTile][3][2];  // J_(t, i0 + ii) at rows h0, h1
#pragma unroll
        for (int ii = 0; ii < kQTile; ++ii) {
          const int i = i0 + ii < K ? i0 + ii : K - 1;  // past the last star: never used
          const float cu = s.wcx[i] * s.gx1[i * fs + col];
          const float cv = s.wcy[i] * s.gx[i * fs + col];
          const float cs = s.w[i] * s.gx[i * fs + col];
          const float y0 = s.gy[i * hp + h0], y1 = s.gy[i * hp + h1];
          ja[ii][0][0] = cu * y0; ja[ii][0][1] = cu * y1;
          ja[ii][1][0] = cv * s.gy1[i * hp + h0]; ja[ii][1][1] = cv * s.gy1[i * hp + h1];
          ja[ii][2][0] = cs * y0; ja[ii][2][1] = cs * y1;
        }
        for (int j = i0; j < K; ++j) {
          const float cu = s.wcx[j] * s.gx1[j * fs + col];
          const float cv = s.wcy[j] * s.gx[j * fs + col];
          const float cs = s.w[j] * s.gx[j * fs + col];
          const float y0 = s.gy[j * hp + h0], y1 = s.gy[j * hp + h1];
          const float jb[3][2] = {{cu * y0, cu * y1},
                                  {cv * s.gy1[j * hp + h0], cv * s.gy1[j * hp + h1]},
                                  {cs * y0, cs * y1}};
#pragma unroll
          for (int ii = 0; ii < kQTile; ++ii) {
            const int i = i0 + ii;
            if (i > j) continue;
            const float* blk = s.gblk + (i * K + j) * 12;
            const float4 b0 = load4(blk), b1 = load4(blk + 4);
            const float b8 = blk[8];
            const float gb[9] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w, b8};
#pragma unroll
            for (int ta = 0; ta < 3; ++ta) {
              const float r0 = gb[ta * 3] * jb[0][0] + gb[ta * 3 + 1] * jb[1][0]
                               + gb[ta * 3 + 2] * jb[2][0];
              const float r1 = gb[ta * 3] * jb[0][1] + gb[ta * 3 + 1] * jb[1][1]
                               + gb[ta * 3 + 2] * jb[2][1];
              q0 += ja[ii][ta][0] * r0;
              q1 += ja[ii][ta][1] * r1;
            }
          }
        }
      }
      s.fld[h0 * fs + col] = q0;
      if (h1 != h0) s.fld[h1 * fs + col] = q1;
    }
  }
  __syncthreads();
}

// phi(p) = sum_b a_b J_b(p) into s.fld, from the per-star a_b coef_b in
// s.cu, s.cv, s.cs.
__device__ void phi_field(const Params& P, const Work& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = s.K, H = P.H, W = P.W, hp = s.hp, fs = s.fs;
  for (int h = warp; h < H; h += kWarps) {
    for (int col = lane; col < W; col += 32) {
      float phi = 0.0f;
      for (int i = 0; i < K; ++i) {
        const int nx = i * fs + col, ny = i * hp + h;
        const float tx = s.cu[i] * s.gx1[nx] + s.cs[i] * s.gx[nx];
        phi = phi + s.gy[ny] * tx;
        phi = phi + s.gy1[ny] * (s.cv[i] * s.gx[nx]);
      }
      s.fld[h * fs + col] = phi;
    }
  }
  __syncthreads();
}

// Everything theta-dependent at s.th_b: profiles, 1/lam, U_beta (s.scal[0]),
// log det G (s.scal[1]), the factor L (s.gmat / s.ldiag), G^-1, info' and
// t1.  Every thread calls it; it ends synchronised.
__device__ void build_structs(const Params& P, const Work& s, float beta, float ldead,
                              double* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = s.K, D = s.D, KK = K * K, ld = s.ld;
  profiles(P, s, s.th_b);
  const double ll = render(P, s, beta, true, red);
  pair_contract(P, s);
  assemble_metric(P, s, beta, true, nullptr);
  cholesky(s, D, true, ldead);
  contract<kGrad>(P, s);
  if (warp == 0) {
    double lp = 0.0;
    for (int i = lane; i < K; i += 32) {
      const float u = s.th_b[i], v = s.th_b[K + i], sl = s.th_b[2 * K + i];
      const float m = s.m[i];
      const float lp_pos = -(softplusf(u) + softplusf(-u) + softplusf(v) + softplusf(-v));
      const float zf = (sl - P.logf_mean) / P.logf_sigma;
      const float lp_flux = -0.5f * zf * zf + P.lp_flux_const;
      lp += static_cast<double>((lp_pos + lp_flux) * m);
      // grad U_beta into t1, to which the metric terms are added below
      s.t1[i] = -(s.wcx[i] * s.dots[i] + (1.0f - 2.0f * s.su[i]) * m);
      s.t1[K + i] = -(s.wcy[i] * s.dots[3 * K + i] + (1.0f - 2.0f * s.sv[i]) * m);
      s.t1[2 * K + i] = -(s.w[i] * s.dots[5 * K + i] + (-zf / P.logf_sigma) * m);
    }
    lp = warp_sum_d(lp);
    if (lane == 0) s.scal[0] = static_cast<float>(-(static_cast<double>(beta) * ll + lp));
  }
  inverse(s);  // synchronises, so t1 and scal[0] are visible
  q_field(P, s);
  contract<kQ>(P, s);
  // t1_c += beta sum_{a in star i} sum_b Ginv_ab S_acb - beta/2 sum_p q J_c R2
  //         + 1/2 Ginv_cc info'_c, one warp a parameter c, lanes over stars j,
  // with S assembled from Sraw: S[m][tb][i][j] = coef_tb,j sum_terms coefH_i
  // Sraw[hp][tb][i][j]
  for (int c = warp; c < D; c += kWarps) {
    const int tc = type_of(c, K), i = c - tc * K;
    float sg = 0.0f;
    for (int ta = 0; ta < 3; ++ta) {
      // combo (ta, tc) -> its Hessian terms (coef, hp)
      int hp0, hp1 = -1;
      float c0, c1 = 0.0f;
      const int lo = ta < tc ? ta : tc, hi = ta < tc ? tc : ta;
      if (lo == 0 && hi == 0) { hp0 = 0; c0 = s.wcx2[i]; hp1 = 1; c1 = s.wcxx[i]; }
      else if (lo == 0 && hi == 1) { hp0 = 2; c0 = s.wcxcy[i]; }
      else if (lo == 0 && hi == 2) { hp0 = 0; c0 = s.wcx[i]; }
      else if (lo == 1 && hi == 1) { hp0 = 3; c0 = s.wcy2[i]; hp1 = 4; c1 = s.wcyy[i]; }
      else if (lo == 1 && hi == 2) { hp0 = 3; c0 = s.wcy[i]; }
      else { hp0 = 5; c0 = s.w[i]; }
      const float* grow = s.ginv + (ta * K + i) * ld;
      for (int tb = 0; tb < 3; ++tb) {
        const float* q0 = s.sraw + (hp0 * 3 + tb) * KK + i * K;
        const float* q1 = hp1 >= 0 ? s.sraw + (hp1 * 3 + tb) * KK + i * K : nullptr;
        for (int j = lane; j < K; j += 32) {
          float sv = c0 * q0[j];
          if (q1 != nullptr) sv = sv + c1 * q1[j];
          sg += grow[tb * K + j] * (jcoef(s, tb, j) * sv);
        }
      }
    }
    sg = warp_sum(sg);
    if (lane == 0) {
      const float cq = jcoef(s, tc, i) * s.dots[(tc == 0 ? 0 : (tc == 1 ? 3 : 5)) * K + i];
      s.t1[c] = s.t1[c] + beta * sg - 0.5f * beta * cq
                + 0.5f * s.ginv[c * ld + c] * s.infod[c];
    }
  }
  __syncthreads();
}

// dH/dtheta at the structs' theta and momentum p (D) into out: t1 + t2(a).
__device__ void dh_dtheta(const Params& P, const Work& s, float beta, const float* p,
                          float* out) {
  const int tid = threadIdx.x;
  const int K = s.K, D = s.D;
  ginv_matvec(s, p, s.a);
  if (tid < K) {
    s.cu[tid] = s.a[tid] * s.wcx[tid];
    s.cv[tid] = s.a[K + tid] * s.wcy[tid];
    s.cs[tid] = s.a[2 * K + tid] * s.w[tid];
  }
  __syncthreads();
  phi_field(P, s);
  contract<kSweep>(P, s);
  if (tid < D) {
    const int tc = type_of(tid, K), i = tid - tc * K;
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

// G(th)^-1 p by a fresh metric build at th (profiles, 1/lam, F, Cholesky with
// p as its extra row, back substitution; no S, no q, no t1) into out.
__device__ void fisher_solve(const Params& P, const Work& s, float beta, const float* th,
                             const float* p, float* out, double* red) {
  profiles(P, s, th);
  render(P, s, beta, false, red);
  fisher_pairs(P, s);
  assemble_metric(P, s, beta, false, p);
  cholesky(s, s.D + 1, false, 0.0f);
  chol_solve(s, out);
}

// Relative sup-norm Picard delta max|x_new - x_old| / (1 + max|x_new|) over
// the D entries, NaN-propagating; returned to every thread.
__device__ float fp_delta(const Work& s, const float* x_new, const float* x_old) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < 32) {
    float num = 0.0f, den = 0.0f;
    for (int a = lane; a < s.D; a += 32) {
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
__device__ float hamiltonian(const Work& s, const float* p) {
  const int tid = threadIdx.x, lane = tid & 31;
  ginv_matvec(s, p, s.a);
  if (tid < 32) {
    double kin = 0.0;
    for (int a = lane; a < s.D; a += 32) kin += static_cast<double>(p[a] * s.a[a]);
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

// One block an SM walks the chains c = blockIdx.x, + gridDim.x, ...
__global__ void __launch_bounds__(kThreads, 1) fused_rhmc_crowded_kernel(Params P) {
  __shared__ double red[kWarps];
  __shared__ int live[kMaxStars];     // the chain's live slots, in order
  __shared__ float live_m[kMaxStars];
  __shared__ int n_live;
  const int tid = threadIdx.x, Ks = P.K, Ds = 3 * Ks;
  Work s = carve(P);
  // a dead slot's diagonal of L: its identity row of G plus the jitter,
  // factored as the kernel factors a pivot
  const float gdead = 1.0f + P.jitter;
  const float ldead = gdead * (1.0f / sqrtf(gdead));
  const float beta = *P.beta;

  for (int c = blockIdx.x; c < P.C; c += gridDim.x) {
    __syncthreads();  // the previous chain's outputs are written
    if (tid == 0) {
      int n = 0;
      for (int i = 0; i < Ks; ++i) {
        const float m = P.mask[c * P.mask_stride + i];
        if (m != 0.0f) {
          live[n] = i;
          live_m[n] = m;
          ++n;
        }
      }
      n_live = n;
    }
    // every slot as it went in, with momentum 0; the live ones are
    // overwritten at the end
    for (int n = tid; n < Ds; n += kThreads) {
      P.theta_out[c * Ds + n] = P.theta[c * Ds + n];
      P.p_out[c * Ds + n] = 0.0f;
    }
    __syncthreads();
    s.K = n_live;
    s.D = 3 * s.K;
    s.ld = s.D + 1;
    s.n_dead = Ks - s.K;
    const int K = s.K, D = s.D;
    const float eps = P.eps[c];
    const float half_eps = 0.5f * eps;
    if (tid < K) s.m[tid] = live_m[tid];
    if (tid < D) {  // (K, 3) star-major in memory -> packed a = t K + i over live stars
      const int t = type_of(tid, K), i = tid - t * K, slot = live[i];
      s.th_b[tid] = P.theta[c * Ds + 3 * slot + t];
      s.vec[tid] = P.xi[c * Ds + 3 * slot + t];
    }
    __syncthreads();

    build_structs(P, s, beta, ldead, red);
    // p0 = (L xi) m, L the factor of G(theta0) that build_structs left behind
    if (tid < D) {
      float acc = s.ldiag[tid] * s.vec[tid];
      for (int k = 0; k < tid; ++k) acc += s.gmat[k * s.ld + tid] * s.vec[k];
      s.p_b[tid] = acc * s.m[tid - type_of(tid, K) * K];
    }
    __syncthreads();
    const float h0 = hamiltonian(s, s.p_b);

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
        d1 = fp_delta(s, s.dh, s.ph);
        if (tid < D) s.ph[tid] = s.dh[tid];
        __syncthreads();
      }
      // implicit position step: theta' = theta + eps/2 [G(theta)^-1 + G(theta')^-1] p_h
      ginv_matvec(s, s.ph, s.vec);
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
        d2 = fp_delta(s, s.vec, s.th);
        if (tid < D) s.th[tid] = s.vec[tid];
        __syncthreads();
      }
      // rebuild at theta'; reused by the final half-step, h1 and the next step
      if (tid < D) s.th_b[tid] = s.th[tid];
      __syncthreads();
      build_structs(P, s, beta, ldead, red);
      dh_dtheta(P, s, beta, s.ph, s.dh);
      if (tid < D) s.p_b[tid] = s.ph[tid] - half_eps * s.dh[tid];
      __syncthreads();
      resid = nanmax(resid, nanmax(d1, d2));
    }
    const float h1 = hamiltonian(s, s.p_b);

    if (tid < D) {
      const int t = type_of(tid, K), i = tid - t * K, slot = live[i];
      P.theta_out[c * Ds + 3 * slot + t] = s.th_b[tid];
      P.p_out[c * Ds + 3 * slot + t] = s.p_b[tid];
    }
    if (tid == 0) {
      P.h0_out[c] = h0;
      P.h1_out[c] = h1;
      P.u1_out[c] = s.scal[0];
      P.resid_out[c] = resid;
    }
  }
}

// The current device's SM count into *sms; returns a CUDA error code.
cudaError_t device_sms(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return e;
}

// The kernel with its dynamic shared memory allowed.
cudaError_t prepare(size_t smem) {
  return cudaFuncSetAttribute(fused_rhmc_crowded_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

bool in_domain(int K, int H, int W) {
  return K >= 1 && K <= kMaxStars && H >= 1 && H <= kMaxSide && W >= 1 && W <= kMaxSide;
}

}  // namespace

extern "C" {

// Launches `grid` blocks on `stream`, each walking the chains blockIdx.x +
// n gridDim.x in its slice of `work` (grid x work_floats(K, H, W) floats,
// allocated by the caller); returns cudaGetLastError() (0 on success).
int starcat_fused_rhmc_crowded(
    const void* theta, const void* xi, const void* eps, const void* mask,
    int mask_stride, const void* beta, const void* image, void* theta_out,
    void* p_out, void* h0_out, void* h1_out, void* u1_out, void* resid_out,
    int C, int K, int H, int W, int n_steps, int fpi, float psf_sigma,
    float psf_norm, float background, float logf_mean, float logf_sigma,
    float lp_flux_const, float jitter, void* work, int grid, void* stream) {
  if (!in_domain(K, H, W) || C < 1 || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
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
  P.work = static_cast<float*>(work);
  P.C = C;
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = prepare(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  fused_rhmc_crowded_kernel<<<grid, kThreads, smem, st>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// The layout a launch of C chains takes: threads per block, the blocks an SM
// holds and the SMs the grid fills (a grid of min(C, SMs x blocks an SM)
// blocks).  Returns a CUDA error code (0 on success).
int starcat_fused_rhmc_crowded_layout(int C, int K, int H, int W, int* threads,
                                      int* blocks_per_sm, int* sms_filled) {
  if (!in_domain(K, H, W)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(smem_floats(K, H, W)) * sizeof(float);
  int sms = 0;
  cudaError_t e = device_sms(&sms);
  if (e == cudaSuccess) e = prepare(smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fused_rhmc_crowded_kernel,
                                                      kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  *threads = kThreads;
  *sms_filled = C < sms ? C : sms;
  return 0;
}

// The source's own sizes for K slots on an H x W scene, which the wrapper
// holds its mirrors to: shared memory a block and workspace floats a block.
int starcat_fused_rhmc_crowded_sizes(int K, int H, int W, int* smem_bytes, int* work_floats_out) {
  if (!in_domain(K, H, W)) return static_cast<int>(cudaErrorInvalidValue);
  *smem_bytes = smem_floats(K, H, W) * static_cast<int>(sizeof(float));
  *work_floats_out = work_floats(K, H, W);
  return 0;
}

const char* starcat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
