// Diagonal-Fisher Riemannian trajectory for crowded fields on Hopper
// (sm_90a), one thread block per chain, its pixel passes written as block
// GEMMs in FP32 on the CUDA cores.
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
// What bounded it: shared-memory loads feeding the FP32 pipes.  A chain's
// trajectory at 128x128, K = 64, 6 steps x 4 sweeps needs about 2.8e8 FMAs
// (538 operations per star and pixel) against 1.5 KB of state in and out,
// so it is bound by operations; but written as one star and one pixel at a
// time, each pixel pass takes one to three shared loads per FMA, while the
// SM serves one 32-lane load per clock against four warp FMAs.
//
// What the design does about it: every pixel pass is a block GEMM whose
// threads keep a register tile of the output and load 128-bit vectors, so
// one load feeds 4 to 16 FMAs, as the reference writes the passes as MXU
// dots (pallas_rhmc_diag.py:592-617, 677-700, 790-799):
//   * render, lam(H, W) = bg + (Gy w)^T Gx, depth the stars: 8 rows x 4
//     columns a thread; 1/lam and, in a build, rho = beta (D/lam - 1) and
//     the log-likelihood (double) are its epilogue;
//   * q field, q(H, W) = Gy^2 @ [Gx^2 (a2 + a0 zx^2)] + [a1 Gy^2 zy^2] @
//     Gx^2, depth 2 x the stars, with the per-star weights folded into the
//     operands, which are written for a chunk of stars into the working
//     field (free until the epilogue writes q / lam^2 there);
//   * contractions over columns, M(H, nK) = field @ X(W, nK), with the
//     x-side products (gx, gx'; gx'^2, gx^2; and in a build gx gx',
//     gx'' gx') made in registers from gx as it is loaded: 8 rows x S stars
//     x 2 products (S <= 4) or 8 rows x S stars x 4 products (S <= 2) a
//     thread, S no larger than the live stars need; the columns are split
//     in two halves over the block's two halves.  The epilogue is the sum
//     over rows against the y-side products (gy, gy'; gy^2, gy'^2, gy gy',
//     gy'' gy'): each thread's eight rows, then a shuffle over the 16 lanes
//     that hold a star's rows, then the two column halves added in shared
//     memory in a fixed order, so a run is deterministic.
// Every stride is a compile-time constant, so a GEMM's inner loop walks its
// operands with immediate offsets, and every star group runs the same loop
// (the group that straddles the last live star reads zero profiles past
// it), so no warp diverges into a second copy of a loop.  Only the live
// stars (m != 0) are GEMM depth and output columns: the mask is fixed
// along a trajectory, so the block lists them once; a dead star's
// contraction sums stay 0, so its metric is 1 + jitter and its share of h
// is 1/2 log(1 + jitter), as before.
//
// What bounds it now: the issue slots of the SM.  The GEMM loops are mostly
// FFMA, the rest loads, the x-side products and the loop; the passes are
// separated by block barriers and short per-star phases.  By SM cycles
// (scripts/b4_pass_clocks.py on an H100 at cfg4's shape) the q field and
// its contraction take about half, the metric solve's contraction and the
// render a third, the profiles and a build's other two contractions the
// rest.
//
// Shared memory (smem_floats, mirrored in fused_rhmc_diag_crowded.py):
//   * 1/lam and the working field (rho, then q / lam^2), stored by column,
//     pixel (h, w) at w kTile + h, 128 rows by W columns each (64 KB at
//     128x128; rows past H are zero);
//   * the profiles of the live stars, gx (K + 3, kGx = 132: stars one to
//     three apart sit in other banks; three zero rows past the live stars)
//     and gy (K, 128);
//   * the (K, 3) state and the per-star scalars, 55 K floats (the nine
//     contraction sums d1..d9 share storage with the C tensor built from
//     them: the thread of a star reads its sums before it writes its C);
// 210 KB at 128x128 and K = 64, one block per SM; K <= 78 at 128x128.  The
// image is read through the read-only path (L2) in the render, the only
// place it is used.  The passes take one tile of 128 x 128 pixels: H and W
// are at most 128.
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
// Domain (checked by the wrapper): 1 <= K <= 128, H and W at most 128, and
// the block's shared memory (smem_floats) within the card's 227 KB.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;        // H, W <= kTile; the fields' and gy's row stride
constexpr int kGx = kTile + 4;    // gx's stride: stars 1..3 apart sit in other banks
constexpr int kRecord = 4 * kTile;  // one star's q-field operands
constexpr int kPartFloats = 288;  // column-half partial sums: 9 x 32 or 3 x 64

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

// the working field, which also holds a chunk of the q field's operands
__host__ __device__ inline int fld_floats(int W) {
  return kTile * W > kRecord ? kTile * W : kRecord;
}

// mirrored by smem_bytes() in fused_rhmc_diag_crowded.py
__host__ __device__ inline int smem_floats(int K, int W) {
  return kTile * W + fld_floats(W) + (K + 3) * kGx + K * kTile + 2 * kWarps + 55 * K
         + kPartFloats + 8;
}

// Shapes of one launch; nl is the number of live stars.
struct Dims {
  int K, H, W, nl;
};

// Per-slot scalars index k; compact (live-star) scalars index j, slot
// live[j]; per-element state index a = 3 k + t.
struct Smem {
  float *r1, *fld;  // (W, kTile): pixel (h, w) at w kTile + h
  float *gx;        // (K + 3, kGx), compact; zero past the live stars
  float *gy;        // (K, kTile), compact
  double* red;      // kWarps
  float *su, *sv, *w, *wcx, *wcy, *m;  // per slot
  float *cw, *czx0, *czy0;             // compact: w, (1/2 - x) / sigma, (1/2 - y) / sigma
  float *ca;        // (3, K) compact: the q field's per-star weights
  int* live;        // K
  float *dot;       // per slot, (3, K)
  float *dd;        // per slot, (9, K): d1..d9, read into registers by the
  float *cten;      // thread of star k before it writes C[ta][tc][k] there
  float *th_b, *p_b, *ph, *th, *base, *g, *gs, *t1, *infod, *wt;  // 3K each
  float *part;      // kPartFloats
  float *scal;      // u, h, delta scratch
};

__device__ inline Smem carve(float* base, int K, int W) {
  Smem s;
  float* q = base;
  auto take = [&q](int n) { float* r = q; q += n; return r; };
  // the fields and profiles first: every float4 they are read by starts
  // on a 16-byte boundary
  s.r1 = take(kTile * W); s.fld = take(fld_floats(W));
  s.gx = take((K + 3) * kGx); s.gy = take(K * kTile);
  s.red = reinterpret_cast<double*>(take(2 * kWarps));
  s.su = take(K); s.sv = take(K); s.w = take(K); s.wcx = take(K); s.wcy = take(K);
  s.m = take(K);
  s.cw = take(K); s.czx0 = take(K); s.czy0 = take(K); s.ca = take(3 * K);
  s.live = reinterpret_cast<int*>(take(K));
  s.dot = take(3 * K); s.cten = take(9 * K); s.dd = s.cten;
  s.th_b = take(3 * K); s.p_b = take(3 * K); s.ph = take(3 * K); s.th = take(3 * K);
  s.base = take(3 * K); s.g = take(3 * K); s.gs = take(3 * K); s.t1 = take(3 * K);
  s.infod = take(3 * K); s.wt = take(3 * K);
  s.part = take(kPartFloats); s.scal = take(8);
  return s;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ float warp_sum16(float v) {  // over the 16 lanes of a half warp
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
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

// Per-star coefficients at theta `th` (3K) for every slot, the live stars'
// compact scalars and their profiles gx, gy, each kTile long (zero past W
// and H).  Every thread of the block calls it; it ends synchronised.
__device__ void profiles(const Params& P, const Smem& s, const Dims& D, const float* th) {
  const int tid = threadIdx.x;
  const int W = D.W, H = D.H;
  const float sig = P.psf_sigma;
  if (tid < D.K) {
    const int k = tid;
    const float su = sigmoidf(th[3 * k]), sv = sigmoidf(th[3 * k + 1]);
    const float m = s.m[k];
    const float w = (m != 0.0f) ? expf(th[3 * k + 2]) * m : 0.0f;
    s.su[k] = su; s.sv[k] = sv; s.w[k] = w;
    s.wcx[k] = w * (W * su * (1.0f - su));
    s.wcy[k] = w * (H * sv * (1.0f - sv));
  }
  if (tid < D.nl) {
    const int k = s.live[tid];
    const float su = sigmoidf(th[3 * k]), sv = sigmoidf(th[3 * k + 1]);
    s.cw[tid] = expf(th[3 * k + 2]) * s.m[k];
    s.czx0[tid] = (0.5f - W * su) / sig;
    s.czy0[tid] = (0.5f - H * sv) / sig;
  }
  __syncthreads();
  // a thread per column (row) of kTile, kThreads / kTile stars at a time
  const int pix = tid % kTile;
  // gx also zero in the three rows past the live stars, which the
  // contractions' last star group may read
#pragma unroll 4
  for (int j = tid / kTile; j < D.nl + 3; j += kThreads / kTile) {
    float v = 0.0f;
    if (j < D.nl && pix < W) {
      const float z = ((pix + 0.5f) - W * s.su[s.live[j]]) / sig;
      v = expf(-0.5f * z * z) * P.psf_norm;
    }
    s.gx[j * kGx + pix] = v;
  }
#pragma unroll 4
  for (int j = tid / kTile; j < D.nl; j += kThreads / kTile) {
    const float y = H * s.sv[s.live[j]];
    float v = 0.0f;
    if (pix < H) {
      const float z = ((pix + 0.5f) - y) / sig;
      v = expf(-0.5f * z * z) * P.psf_norm;
    }
    s.gy[j * kTile + pix] = v;
  }
  __syncthreads();
}

// The field passes' tiling: 8 rows x 4 columns a thread over the 128 x 128
// tile; a warp holds 4 row groups x 8 column groups, so its loads of either
// operand are one 128-byte line.  A thread past the columns does nothing; a
// thread past the rows writes zeros.
struct FieldTile {
  int h0, c0;
  bool active, rows;
};

__device__ __forceinline__ FieldTile field_tile(const Dims& D) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  FieldTile t;
  t.h0 = 8 * ((lane & 3) + 4 * (warp & 3));
  t.c0 = 4 * ((lane >> 2) + 8 * (warp >> 2));
  t.active = t.c0 < D.W;
  t.rows = t.h0 < D.H;
  return t;
}

// lam = bg + (Gy w)^T Gx -> s.r1 = 1/lam.  With `full`, also s.fld = beta
// (D/lam - 1) and the log-likelihood sum_p D log lam - lam (double),
// returned to every thread.  Rows past H get 0.  Ends synchronised.
__device__ double render(const Params& P, const Smem& s, const Dims& D, float beta,
                         bool full) {
  const FieldTile t = field_tile(D);
  double ll = 0.0;
  if (t.active) {
    float acc[4][8];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[c][r] = P.background;
    if (t.rows) {
      const float* py = s.gy + t.h0;
      const float* px = s.gx + t.c0;
      for (int j = 0; j < D.nl; ++j) {
        const float4 ya = ld4(py), yb = ld4(py + 4), xv = ld4(px);
        const float wj = s.cw[j];
        const float y[8] = {ya.x, ya.y, ya.z, ya.w, yb.x, yb.y, yb.z, yb.w};
        const float x[4] = {xv.x * wj, xv.y * wj, xv.z * wj, xv.w * wj};
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int r = 0; r < 8; ++r) acc[c][r] = fmaf(y[r], x[c], acc[c][r]);
        py += kTile;
        px += kGx;
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = t.c0 + c;
      if (col < D.W) {
        float r1[8], f[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int h = t.h0 + r;
          r1[r] = 0.0f;
          f[r] = 0.0f;
          if (h < D.H) {
            const float lam = acc[c][r];
            r1[r] = 1.0f / lam;
            if (full) {
              const float d = __ldg(P.image + h * D.W + col);
              ll += static_cast<double>(d * logf(lam) - lam);
              f[r] = beta * (d * r1[r] - 1.0f);
            }
          }
        }
        float* o = s.r1 + col * kTile + t.h0;
        st4(o, r1[0], r1[1], r1[2], r1[3]);
        st4(o + 4, r1[4], r1[5], r1[6], r1[7]);
        if (full) {
          float* fo = s.fld + col * kTile + t.h0;
          st4(fo, f[0], f[1], f[2], f[3]);
          st4(fo + 4, f[4], f[5], f[6], f[7]);
        }
      }
    }
  }
  if (full) return block_sum_d(ll, s.red);  // synchronises
  __syncthreads();
  return 0.0;
}

// Contractions over the columns, M(H, nK) = field @ X(W, nK), then the sum
// over rows against the y-side products.  Modes:
//   kField: s.fld (rho, or q / lam^2) @ [gx, gx'] against gy, gy' -> dot
//   kSolve: 1/lam @ [gx'^2, gx^2] against gy^2, gy'^2 -> d1, d6, d9
//   kBuild: 1/lam @ [gx'^2, gx gx', gx^2, gx'' gx'] against gy^2, gy'^2,
//           gy' gy, gy'' gy' -> d1..d9
// A thread holds 8 rows x S stars x kOps products over one half of the
// columns: rows 4 rg..4 rg+3 and 64 + 4 rg..64 + 4 rg+3, so that the 16
// lanes of a half warp read 256 contiguous bytes of a column; lanes 0-15
// and 16-31 of a warp hold the 128 rows of two star groups of S consecutive
// stars, and warps 0-7 and 8-15 the two column halves.  A pass takes 16 S
// stars.
enum { kBuild = 0, kSolve = 1, kField = 2 };

// One column's products of S stars into the register tile.
template <int MODE, int S, int kOps>
__device__ __forceinline__ void contract_column(float (&acc)[S][kOps][8], const float (&av)[8],
                                                const float (&gx)[S], const float (&zs)[S],
                                                float inv_sig2) {
#pragma unroll
  for (int i = 0; i < S; ++i) {
    float op[kOps];
    if (MODE == kField) {
      op[0] = gx[i];
      op[1] = gx[i] * zs[i];                          // gx'
    } else if (MODE == kSolve) {
      const float t = gx[i] * gx[i];
      op[0] = (t * zs[i]) * zs[i];                    // gx'^2
      op[1] = t;                                      // gx^2
    } else {
      const float t = gx[i] * gx[i];
      const float u = t * zs[i];                      // gx gx'
      op[0] = u * zs[i];                              // gx'^2
      op[1] = u;
      op[2] = t;                                      // gx^2
      op[3] = u * fmaf(zs[i], zs[i], -inv_sig2);      // gx'' gx'
    }
#pragma unroll
    for (int o = 0; o < kOps; ++o)
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[i][o][r] = fmaf(av[r], op[o], acc[i][o][r]);
  }
}

template <int MODE, int S>
__device__ void contract_block(const Params& P, const Smem& s, const Dims& D, int sb) {
  constexpr int kOps = MODE == kBuild ? 4 : 2;
  constexpr int kBlock = 16 * S;
  constexpr int kSums = MODE == kBuild ? 9 : 3;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = lane & 15;
  const int sg = 2 * (warp & 7) + (lane >> 4);
  const int half = warp >> 3;
  const int lo = 4 * rg;  // the second quad is lo + 64
  const int j0 = sb + S * sg;
  const int wmid = (D.W + 1) / 2;
  const int wbeg = half ? wmid : 0, wend = half ? D.W : wmid;
  const float inv_sig = 1.0f / P.psf_sigma;
  const float inv_sig2 = inv_sig * inv_sig;
  const float* A = MODE == kField ? s.fld : s.r1;
  float* out = MODE == kField ? s.dot : s.dd;

  float acc[S][kOps][8];
  float zs0[S];  // z / sigma at column 0
#pragma unroll
  for (int i = 0; i < S; ++i) {
    zs0[i] = s.czx0[min(j0 + i, D.nl - 1)] * inv_sig;
#pragma unroll
    for (int o = 0; o < kOps; ++o)
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[i][o][r] = 0.0f;
  }
  // rows past H are zero in the fields and in gy; a star group past the
  // live stars skips the columns, and the stars past the last live one in
  // the group that straddles it read zero profiles (their sums are never
  // stored)
  if (lo < D.H && j0 < D.nl) {
    const float* a = A + wbeg * kTile + lo;
    const float* g = s.gx + j0 * kGx + wbeg;
    float wf = static_cast<float>(wbeg);
#pragma unroll 1
    for (int w = wbeg; w < wend; ++w) {
      const float4 a0 = ld4(a), a1 = ld4(a + 64);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float gx[S], zs[S];
#pragma unroll
      for (int i = 0; i < S; ++i) {
        gx[i] = g[i * kGx];
        zs[i] = fmaf(wf, inv_sig2, zs0[i]);  // z / sigma
      }
      contract_column<MODE, S, kOps>(acc, av, gx, zs, inv_sig2);
      a += kTile;
      ++g;
      wf += 1.0f;
    }
  }
  // the sum over rows against the y-side products
  float sums[S][kSums];
#pragma unroll
  for (int i = 0; i < S; ++i) {
#pragma unroll
    for (int q = 0; q < kSums; ++q) sums[i][q] = 0.0f;
    if (lo < D.H && j0 < D.nl) {
      const int j = min(j0 + i, D.nl - 1);
      const float4 g0 = ld4(s.gy + j * kTile + lo), g1 = ld4(s.gy + j * kTile + lo + 64);
      const float gyv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float zy0 = s.czy0[j];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float gy = gyv[r];
        const float zy = fmaf(static_cast<float>(lo + r + (r < 4 ? 0 : 60)), inv_sig, zy0);
        const float gy1 = gy * zy * inv_sig;            // gy'
        if (MODE == kField) {
          sums[i][0] = fmaf(gy, acc[i][1][r], sums[i][0]);   // du
          sums[i][1] = fmaf(gy1, acc[i][0][r], sums[i][1]);  // dv
          sums[i][2] = fmaf(gy, acc[i][0][r], sums[i][2]);   // ds
        } else if (MODE == kSolve) {
          const float ya = gy * gy, yb = gy1 * gy1;
          sums[i][0] = fmaf(ya, acc[i][0][r], sums[i][0]);   // d1
          sums[i][1] = fmaf(yb, acc[i][1][r], sums[i][1]);   // d6
          sums[i][2] = fmaf(ya, acc[i][1][r], sums[i][2]);   // d9
        } else {
          const float ya = gy * gy, yb = gy1 * gy1, yc = gy1 * gy;
          const float yd = yc * (zy * zy - 1.0f) * inv_sig2;  // gy'' gy'
          const float m1 = acc[i][0][r], m2 = acc[i][1][r], m3 = acc[i][2][r],
                      m4 = acc[i][3][r];
          sums[i][0] = fmaf(ya, m1, sums[i][0]);
          sums[i][1] = fmaf(ya, m4, sums[i][1]);
          sums[i][2] = fmaf(yb, m2, sums[i][2]);
          sums[i][3] = fmaf(ya, m2, sums[i][3]);
          sums[i][4] = fmaf(yc, m1, sums[i][4]);
          sums[i][5] = fmaf(yb, m3, sums[i][5]);
          sums[i][6] = fmaf(yd, m3, sums[i][6]);
          sums[i][7] = fmaf(yc, m3, sums[i][7]);
          sums[i][8] = fmaf(ya, m3, sums[i][8]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kSums; ++q) sums[i][q] = warp_sum16(sums[i][q]);
  }
  // the two column halves, added in a fixed order
  if (half == 1 && rg == 0) {
#pragma unroll
    for (int i = 0; i < S; ++i)
#pragma unroll
      for (int q = 0; q < kSums; ++q) s.part[q * kBlock + S * sg + i] = sums[i][q];
  }
  __syncthreads();
  if (half == 0 && rg == 0) {
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int j = j0 + i;
      if (j < D.nl) {
        const int k = s.live[j];
#pragma unroll
        for (int q = 0; q < kSums; ++q) {
          const float v = sums[i][q] + s.part[q * kBlock + S * sg + i];
          // kSolve's three sums are d1, d6, d9
          const int slot = MODE == kSolve ? (q == 0 ? 0 : (q == 1 ? 5 : 8)) : q;
          out[slot * D.K + k] = v;
        }
      }
    }
  }
  __syncthreads();
}

// All live stars, in passes of 16 S stars, S as large as the registers
// allow (4 stars of 2 products, 2 of 4) and no larger than the stars left
// need, so that a pass computes few columns past the live stars.
template <int MODE>
__device__ void contract(const Params& P, const Smem& s, const Dims& D) {
  constexpr int kMaxS = MODE == kBuild ? 2 : 4;
  for (int sb = 0; sb < D.nl;) {
    const int S = min(kMaxS, (D.nl - sb + 15) / 16);
    if (S == 1) contract_block<MODE, 1>(P, s, D, sb);
    else if (S == 2) contract_block<MODE, 2>(P, s, D, sb);
    else if (S == 3) contract_block<MODE, (kMaxS >= 3 ? 3 : 1)>(P, s, D, sb);
    else contract_block<MODE, kMaxS>(P, s, D, sb);
    sb += 16 * S;
  }
}

// q = sum_k (gx gy)^2 (a2 + a0 zx^2 + a1 zy^2), with s.ca holding a0 /
// sigma^2, a1 / sigma^2, a2 (compact), written as
//   q = Gy^2 @ [Gx^2 (a2 + a0 zx^2)] + [a1 Gy^2 zy^2] @ Gx^2,
// times (1/lam)^2 into s.fld.  The operands of a chunk of stars are written
// into s.fld first, one kRecord per star: the rows Y0, Y1, then the columns
// X0, X1, kTile each.  Every thread calls it; it ends synchronised.
__device__ void q_field(const Params& P, const Smem& s, const Dims& D) {
  const int tid = threadIdx.x;
  const FieldTile t = field_tile(D);
  const int chunk = fld_floats(D.W) / kRecord;
  const float inv_sig = 1.0f / P.psf_sigma;
  float acc[4][8];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[c][r] = 0.0f;
  for (int j0 = 0; j0 < D.nl; j0 += chunk) {
    const int n = min(chunk, D.nl - j0);
    __syncthreads();  // s.fld's earlier readers are done
    // a thread per row and column of kTile, kThreads / kTile stars at a time
    const int pix = tid % kTile;
#pragma unroll 4
    for (int jj = tid / kTile; jj < n; jj += kThreads / kTile) {
      const int j = j0 + jj;
      float* rec = s.fld + jj * kRecord + pix;
      const float gy = s.gy[j * kTile + pix];
      const float zy = fmaf(static_cast<float>(pix), inv_sig, s.czy0[j]);
      const float ysq = gy * gy;
      rec[0] = ysq;
      rec[kTile] = s.ca[D.K + j] * (ysq * (zy * zy));
      const float gx = s.gx[j * kGx + pix];
      const float zx = fmaf(static_cast<float>(pix), inv_sig, s.czx0[j]);
      const float xsq = gx * gx;
      rec[2 * kTile] = xsq * fmaf(s.ca[j], zx * zx, s.ca[2 * D.K + j]);
      rec[3 * kTile] = xsq;
    }
    __syncthreads();
    if (t.active && t.rows) {
      const float* py = s.fld + t.h0;
      const float* px = s.fld + 2 * kTile + t.c0;
      for (int jj = 0; jj < n; ++jj) {
        const float4 p0 = ld4(py), p1 = ld4(py + 4);
        const float4 q0 = ld4(py + kTile), q1 = ld4(py + kTile + 4);
        const float4 u = ld4(px), v = ld4(px + kTile);
        const float ya[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
        const float yb[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
        const float xa[4] = {u.x, u.y, u.z, u.w};
        const float xb[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int r = 0; r < 8; ++r)
            acc[c][r] = fmaf(yb[r], xb[c], fmaf(ya[r], xa[c], acc[c][r]));
        py += kRecord;
        px += kRecord;
      }
    }
  }
  __syncthreads();  // the operands are read
  if (t.active) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = t.c0 + c;
      if (col < D.W) {
        // rows past H: acc is 0 there, and so is 1/lam
        const float4 a = ld4(s.r1 + col * kTile + t.h0), b = ld4(s.r1 + col * kTile + t.h0 + 4);
        float* o = s.fld + col * kTile + t.h0;
        st4(o, acc[c][0] * (a.x * a.x), acc[c][1] * (a.y * a.y), acc[c][2] * (a.z * a.z),
            acc[c][3] * (a.w * a.w));
        st4(o + 4, acc[c][4] * (b.x * b.x), acc[c][5] * (b.y * b.y),
            acc[c][6] * (b.z * b.z), acc[c][7] * (b.w * b.w));
      }
    }
  }
  __syncthreads();
}

// g = (beta F + info) m + (1 - m) + jitter for star k, from its d1, d6,
// d9, into out[3k..3k+2], and info' into infod when given.  Run by thread k.
__device__ void diag_metric_star(const Params& P, const Smem& s, int k, float beta,
                                 float d1, float d6, float d9, float* out, float* infod) {
  const float m = s.m[k];
  const float su = s.su[k], sv = s.sv[k];
  const float f_u = s.wcx[k] * s.wcx[k] * d1;
  const float f_v = s.wcy[k] * s.wcy[k] * d6;
  const float f_s = s.w[k] * s.w[k] * d9;
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
// terms (out may be add).  Every thread calls it; it ends synchronised.
__device__ void wt_terms(const Params& P, const Smem& s, const Dims& D, float beta,
                         const float* add, float* out) {
  const int tid = threadIdx.x;
  const int K = D.K;
  const float inv_sig = 1.0f / P.psf_sigma;
  const float inv_sig2 = inv_sig * inv_sig;
  if (tid < D.nl) {
    const int k = s.live[tid];
    s.ca[tid] = s.wt[3 * k] * (s.wcx[k] * s.wcx[k]) * inv_sig2;
    s.ca[K + tid] = s.wt[3 * k + 1] * (s.wcy[k] * s.wcy[k]) * inv_sig2;
    s.ca[2 * K + tid] = s.wt[3 * k + 2] * (s.w[k] * s.w[k]);
  }
  q_field(P, s, D);  // synchronises before it reads s.ca
  contract<kField>(P, s, D);
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
__device__ void build_structs(const Params& P, const Smem& s, const Dims& D, float beta) {
  const int tid = threadIdx.x;
  const int K = D.K;
  profiles(P, s, D, s.th_b);
  const double ll = render(P, s, D, beta, true);
  contract<kField>(P, s, D);  // rho -> dot
  contract<kBuild>(P, s, D);  // 1/lam -> d1..d9
  double lp = 0.0;
  if (tid < K) {
    const int k = tid;
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
    const float d1 = dd[k], d2 = dd[K + k], d3 = dd[2 * K + k], d4 = dd[3 * K + k],
                d5 = dd[4 * K + k], d6 = dd[5 * K + k], d7 = dd[6 * K + k],
                d8 = dd[7 * K + k], d9 = dd[8 * K + k];
    const float wcx = s.wcx[k], wcy = s.wcy[k];
    s.t1[3 * k] = -(wcx * s.dot[k] + g_u);  // grad U; t1 adds W(1/(2g)) below
    s.t1[3 * k + 1] = -(wcy * s.dot[K + k] + g_v);
    s.t1[3 * k + 2] = -(w * s.dot[2 * K + k] + g_s);
    const float wcxcy = w * cx * cy;
    const float f_u = wcx * wcx * d1, f_v = wcy * wcy * d6, f_s = w * w * d9;
    float* c = s.cten;  // C[ta][tc][k] at ((ta * 3 + tc) * K + k)
    c[(0 * 3 + 0) * K + k] = wcx * ((w * cx * (1.0f - 2.0f * su)) * d1 + (w * cx * cx) * d2);
    c[(1 * 3 + 0) * K + k] = wcy * wcxcy * d3;
    c[(2 * 3 + 0) * K + k] = w * wcx * d4;
    c[(0 * 3 + 1) * K + k] = wcx * wcxcy * d5;
    c[(1 * 3 + 1) * K + k] = wcy * ((w * cy * (1.0f - 2.0f * sv)) * d6 + (w * cy * cy) * d7);
    c[(2 * 3 + 1) * K + k] = w * wcy * d8;
    c[(0 * 3 + 2) * K + k] = f_u;
    c[(1 * 3 + 2) * K + k] = f_v;
    c[(2 * 3 + 2) * K + k] = f_s;
    diag_metric_star(P, s, k, beta, d1, d6, d9, s.g, s.infod);
  }
  lp = block_sum_d(lp, s.red);  // synchronises
  if (tid == 0) s.scal[0] = static_cast<float>(-(static_cast<double>(beta) * ll + lp));
  if (tid < 3 * K) s.wt[tid] = 0.5f / s.g[tid];
  __syncthreads();
  wt_terms(P, s, D, beta, s.t1, s.t1);
}

// dH/dtheta at the structs' theta and momentum p (3K) into out.
__device__ void dh_dtheta(const Params& P, const Smem& s, const Dims& D, float beta,
                          const float* p, float* out) {
  const int tid = threadIdx.x;
  if (tid < 3 * D.K) {
    const float a = p[tid] / s.g[tid];
    s.wt[tid] = -0.5f * a * a;
  }
  __syncthreads();
  wt_terms(P, s, D, beta, s.t1, out);
}

// The metric at theta `th` into s.gs (profiles, 1/lam and the Fisher
// diagonal at th; no C tensor, no q field).
__device__ void diag_solve(const Params& P, const Smem& s, const Dims& D, float beta,
                           const float* th) {
  profiles(P, s, D, th);
  render(P, s, D, beta, false);
  contract<kSolve>(P, s, D);
  if (threadIdx.x < D.K) {
    const int k = threadIdx.x;
    diag_metric_star(P, s, k, beta, s.dd[k], s.dd[5 * D.K + k], s.dd[8 * D.K + k], s.gs,
                     nullptr);
  }
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
  extern __shared__ float4 smem4[];
  const int c = blockIdx.x, tid = threadIdx.x;
  const int K = P.K, d3 = 3 * K;
  const Smem s = carve(reinterpret_cast<float*>(smem4), K, P.W);
  const float eps = P.eps[c];
  const float half_eps = 0.5f * eps;
  const float beta = *P.beta;

  if (tid < K) s.m[tid] = P.mask[c * P.mask_stride + tid];
  if (tid < d3) {
    s.th_b[tid] = P.theta[c * d3 + tid];
    s.ph[tid] = P.xi[c * d3 + tid];
  }
  // a dead star's contraction sums stay 0 (and so does its C, which
  // shares their storage)
  for (int i = tid; i < 12 * K; i += kThreads) (i < 3 * K ? s.dot[i] : s.dd[i - 3 * K]) = 0.0f;
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int k = 0; k < K; ++k)
      if (s.m[k] != 0.0f) s.live[n++] = k;
    s.scal[7] = static_cast<float>(n);
  }
  __syncthreads();
  Dims D;
  D.K = K; D.H = P.H; D.W = P.W;
  D.nl = static_cast<int>(s.scal[7]);

  build_structs(P, s, D, beta);
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
      dh_dtheta(P, s, D, beta, s.ph, s.base);  // s.base as scratch for dH
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
      diag_solve(P, s, D, beta, s.th);
      if (tid < d3) s.gs[tid] = s.base[tid] + half_eps * (s.ph[tid] / s.gs[tid]);
      __syncthreads();
      d2 = fp_delta(s, d3, s.gs, s.th);
      if (tid < d3) s.th[tid] = s.gs[tid];
      __syncthreads();
    }
    // rebuild at theta'; reused by the final half-step, h1 and the next step
    if (tid < d3) s.th_b[tid] = s.th[tid];
    __syncthreads();
    build_structs(P, s, D, beta);
    dh_dtheta(P, s, D, beta, s.ph, s.base);
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

  if (H > kTile || W > kTile) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(smem_floats(K, W)) * sizeof(float);
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
