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
// Beyond that one-tile domain (a side above 128 pixels, K > 128, or more
// shared memory than a block holds) the launch takes the wide path at the
// end of this file (namespace wide): the field in tiles of at most 128 x
// 128 pixels and the live stars in chunks of 64, the chain's state in a
// workspace in device memory.  Inside it, the launch takes the code above,
// unchanged.  The wide path takes a pixel's offset from a star as the exact
// difference of the pixel index and x - 1/2 (as B5 does), in the profiles,
// the contractions' derivative factors and the q field alike; the code
// above writes the factors' z / sigma as pixel / sigma^2 plus a per-star
// constant, whose roundings at pixel indices in the hundreds part the
// derivative's centre from the profile's by about 1e-5 pixels, and in an
// early-temperature SMC state at 256x256 that put dH/dtheta, and theta
// after a trajectory, several times farther from float64 than the float32
// plain version (scripts/b4_run_state_accuracy.py).
//
// Domain (checked by the wrapper): the one-tile path takes 1 <= K <= 128,
// H and W at most 128 and the block's shared memory (smem_floats) within
// the card's 227 KB; the wide path every other (H, W, K) with K >= 1,
// beyond the TPU kernels' VMEM gates too (the JAX package runs XLA there):
// its shared memory is fixed, and a chain's workspace slice, the chains'
// state, masks and the image are indexed in 64 bits.
#include <cuda_runtime.h>

#include <cstddef>

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
  float* work;          // the wide path's workspace: (C, wide::work_floats(K, H, W))
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

// ---------------------------------------------------------------------------
// The wide path: fields with a side above 128 pixels, and catalogs whose
// fields and profiles do not fit one block beside the state (K > 78 at
// 128x128), up to the TPU kernel's own domain.
//
// What changes: one block of 512 threads a chain walks the field in pixel
// tiles of at most 128 x 128 (tile i of a row-major grid of 128-pixel
// bands; the last band of each axis ragged) and the live stars in chunks of
// kChunk = 64, the GEMM layouts above unchanged within a tile.  A pass over
// the field becomes, tile by tile: the render adds every chunk's stars to
// lam in the same register tile, its epilogue writes 1/lam (and in a build
// rho) for the tile; then each chunk's contractions over the tile add their
// sums to the stars' sums in device memory.  The q field accumulates every
// chunk's operands in its register tile the same way before its epilogue.
// 1/lam of a build is kept in device memory, band by band (r1 in Work), for
// the momentum sweeps' q fields that follow it; a position sweep renders
// its own.  When one chunk holds the live stars, its profiles serve every
// pass of a tile; otherwise a chunk's are made again for each pass.
//
// The chain's state and per-star scalars live in device memory too (Work, a
// slice a chain of the launch's workspace: work_floats), every per-star
// phase a loop over the slots.  The tiles and chunks run in a fixed order
// and one thread adds a star's sums, so a run is deterministic and a chain's
// result does not depend on the others.  The shared memory is the tile's
// two fields, one chunk's profiles and scalars (smem_floats, 198 KB
// whatever the scene), one block an SM.
namespace wide {

constexpr int kChunk = 64;                    // live stars a chunk
constexpr int kRec = kTile * kTile / kRecord;  // q-field operand records the working field holds

// A pixel tile: rows r0 .. r0 + th - 1 and columns c0 .. c0 + tw - 1.
struct Geom {
  int r0, c0, th, tw;
};

__host__ __device__ inline int bands(int n) { return (n + kTile - 1) / kTile; }

__device__ inline Geom tile_geom(const Dims& D, int i) {
  const int nc = bands(D.W);
  const int tr = i / nc, tc = i - tr * nc;
  Geom t;
  t.r0 = tr * kTile;
  t.c0 = tc * kTile;
  t.th = min(kTile, D.H - t.r0);
  t.tw = min(kTile, D.W - t.c0);
  return t;
}

// A chain's slice of the workspace, in floats (mirrored by
// workspace_floats() in fused_rhmc_diag_crowded.py): 1/lam, kTile rows by W
// columns a band, and 49 K of state and per-star scalars, rounded up to 4.
__host__ __device__ inline size_t work_floats(int K, int H, int W) {
  return (static_cast<size_t>(bands(H)) * W * kTile + 49 * static_cast<size_t>(K) + 3)
         & ~static_cast<size_t>(3);
}

// mirrored by wide_smem_bytes() in fused_rhmc_diag_crowded.py
inline int smem_floats() {
  return 2 * kTile * kTile + (kChunk + 3) * kGx + kChunk * kTile + 2 * kWarps + kPartFloats
         + 7 * kChunk + 8;
}

// Per-slot arrays index k, per-element ones a = 3 k + t, as in Smem above.
struct Work {
  float* r1;  // band b's pixel (b kTile + h, w) at (b W + w) kTile + h
  float *su, *sv, *w, *wcx, *wcy, *m;
  float *dot, *dd, *cten;
  float *th_b, *p_b, *ph, *th, *base, *g, *gs, *t1, *infod, *wt;
  int* live;  // the live slots, in slot order
};

__device__ inline Work work_of(const Params& P, int c) {
  const int K = P.K;
  float* q = P.work + static_cast<size_t>(c) * work_floats(K, P.H, P.W);
  auto take = [&q](size_t n) { float* r = q; q += n; return r; };
  Work g;
  g.r1 = take(static_cast<size_t>(bands(P.H)) * P.W * kTile);
  g.su = take(K); g.sv = take(K); g.w = take(K); g.wcx = take(K); g.wcy = take(K);
  g.m = take(K);
  g.dot = take(3 * K); g.cten = take(9 * K); g.dd = g.cten;
  g.th_b = take(3 * K); g.p_b = take(3 * K); g.ph = take(3 * K); g.th = take(3 * K);
  g.base = take(3 * K); g.g = take(3 * K); g.gs = take(3 * K); g.t1 = take(3 * K);
  g.infod = take(3 * K); g.wt = take(3 * K);
  g.live = reinterpret_cast<int*>(take(K));
  return g;
}

struct Smem {
  float *r1, *fld;               // the tile's (kTile, kTile) by column: pixel (r0 + h, c0 + w) at w kTile + h
  float *gx, *gy;                // (kChunk + 3, kGx) and (kChunk, kTile), the chunk's live stars
  double* red;                   // kWarps
  float* part;                   // kPartFloats
  float *cw, *xh, *yh, *ca;      // the chunk's: w, x - 1/2, y - 1/2; ca (3, kChunk)
  int* live;                     // the chunk's slots
  float* scal;                   // u, h, delta scratch
};

__device__ inline Smem carve(float* base) {
  Smem s;
  float* q = base;
  auto take = [&q](int n) { float* r = q; q += n; return r; };
  s.r1 = take(kTile * kTile); s.fld = take(kTile * kTile);
  s.gx = take((kChunk + 3) * kGx); s.gy = take(kChunk * kTile);
  s.red = reinterpret_cast<double*>(take(2 * kWarps));
  s.part = take(kPartFloats);
  s.cw = take(kChunk); s.xh = take(kChunk); s.yh = take(kChunk); s.ca = take(3 * kChunk);
  s.live = reinterpret_cast<int*>(take(kChunk));
  s.scal = take(8);
  return s;
}

// The live slots (m != 0) in slot order into g.live, a ballot a warp over
// kThreads slots at a time; their count to every thread.  Ends synchronised.
__device__ int compact_live(const Work& g, int K, const Smem& s) {
  int* cnt = reinterpret_cast<int*>(s.part);  // kWarps counts
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int total = 0;
  for (int kb = 0; kb < K; kb += kThreads) {
    const int k = kb + tid;
    const bool on = k < K && g.m[k] != 0.0f;
    const unsigned b = __ballot_sync(0xffffffffu, on);
    if (lane == 0) cnt[warp] = __popc(b);
    __syncthreads();
    int off = total, seg = 0;
    for (int i = 0; i < kWarps; ++i) {
      if (i < warp) off += cnt[i];
      seg += cnt[i];
    }
    if (on) g.live[off + __popc(b & ((1u << lane) - 1u))] = k;
    total += seg;
    __syncthreads();
  }
  return total;
}

// profiles()'s per-slot coefficients at theta `th` for every slot.  Ends
// synchronised.
__device__ void star_coefs(const Work& g, const Dims& D, const float* th) {
  for (int k = threadIdx.x; k < D.K; k += kThreads) {
    const float su = sigmoidf(th[3 * k]), sv = sigmoidf(th[3 * k + 1]);
    const float m = g.m[k];
    const float w = (m != 0.0f) ? expf(th[3 * k + 2]) * m : 0.0f;
    g.su[k] = su; g.sv[k] = sv; g.w[k] = w;
    g.wcx[k] = w * (D.W * su * (1.0f - su));
    g.wcy[k] = w * (D.H * sv * (1.0f - sv));
  }
  __syncthreads();
}

// Live stars jb .. jb + n - 1 (n <= kChunk) on tile t: their slots and
// compact scalars and, with `qw`, the q field's weights from g.wt; their
// profiles gx over the tile's columns and gy over its rows, kTile long
// (zero past the tile, and gx in the three rows past the chunk).  Starts
// and ends synchronised.
__device__ void load_chunk(const Params& P, const Smem& s, const Work& g, const Dims& D,
                           const Geom& t, int jb, int n, bool qw) {
  const int tid = threadIdx.x;
  const float sig = P.psf_sigma;
  __syncthreads();  // the previous chunk's readers are done
  if (tid < n) {
    const int k = g.live[jb + tid];
    const float su = g.su[k], sv = g.sv[k];
    s.live[tid] = k;
    s.cw[tid] = g.w[k];
    s.xh[tid] = D.W * su - 0.5f;
    s.yh[tid] = D.H * sv - 0.5f;
    if (qw) {
      const float inv_sig = 1.0f / sig;
      const float inv_sig2 = inv_sig * inv_sig;
      s.ca[tid] = g.wt[3 * k] * (g.wcx[k] * g.wcx[k]) * inv_sig2;
      s.ca[kChunk + tid] = g.wt[3 * k + 1] * (g.wcy[k] * g.wcy[k]) * inv_sig2;
      s.ca[2 * kChunk + tid] = g.wt[3 * k + 2] * (g.w[k] * g.w[k]);
    }
  }
  __syncthreads();
  const int pix = tid % kTile;
#pragma unroll 4
  for (int j = tid / kTile; j < n + 3; j += kThreads / kTile) {
    float v = 0.0f;
    if (j < n && pix < t.tw) {
      const float z = (static_cast<float>(t.c0 + pix) - s.xh[j]) / sig;
      v = expf(-0.5f * z * z) * P.psf_norm;
    }
    s.gx[j * kGx + pix] = v;
  }
#pragma unroll 4
  for (int j = tid / kTile; j < n; j += kThreads / kTile) {
    float v = 0.0f;
    if (pix < t.th) {
      const float z = (static_cast<float>(t.r0 + pix) - s.yh[j]) / sig;
      v = expf(-0.5f * z * z) * P.psf_norm;
    }
    s.gy[j * kTile + pix] = v;
  }
  __syncthreads();
}

__device__ __forceinline__ FieldTile field_tile(const Geom& t) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  FieldTile f;
  f.h0 = 8 * ((lane & 3) + 4 * (warp & 3));
  f.c0 = 4 * ((lane >> 2) + 8 * (warp >> 2));
  f.active = f.c0 < t.tw;
  f.rows = f.h0 < t.th;
  return f;
}

// lam += (Gy w)^T Gx over the loaded chunk's n stars.
__device__ __forceinline__ void render_acc(float (&acc)[4][8], const Smem& s, const FieldTile& f,
                                           int n) {
  if (!f.active || !f.rows) return;
  const float* py = s.gy + f.h0;
  const float* px = s.gx + f.c0;
  for (int j = 0; j < n; ++j) {
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

// render()'s epilogue on tile t: 1/lam into s.r1 and, with `full`, beta
// (D/lam - 1) into s.fld and the tile's log-likelihood added to ll.  Rows
// past the tile get 0.  Ends synchronised.
__device__ void render_out(const Params& P, const Smem& s, const Dims& D, const Geom& t,
                           const FieldTile& f, const float (&acc)[4][8], float beta, bool full,
                           double& ll) {
  if (f.active) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = f.c0 + c;
      if (col < t.tw) {
        float r1[8], fv[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int h = f.h0 + r;
          r1[r] = 0.0f;
          fv[r] = 0.0f;
          if (h < t.th) {
            const float lam = acc[c][r];
            r1[r] = 1.0f / lam;
            if (full) {
              const float d = __ldg(P.image + static_cast<size_t>(t.r0 + h) * D.W + t.c0 + col);
              ll += static_cast<double>(d * logf(lam) - lam);
              fv[r] = beta * (d * r1[r] - 1.0f);
            }
          }
        }
        float* o = s.r1 + col * kTile + f.h0;
        st4(o, r1[0], r1[1], r1[2], r1[3]);
        st4(o + 4, r1[4], r1[5], r1[6], r1[7]);
        if (full) {
          float* fo = s.fld + col * kTile + f.h0;
          st4(fo, fv[0], fv[1], fv[2], fv[3]);
          st4(fo + 4, fv[4], fv[5], fv[6], fv[7]);
        }
      }
    }
  }
  __syncthreads();
}

// The tile's 1/lam between s.r1 and its band of g.r1 (tw columns of kTile).
__device__ void tile_r1(const Smem& s, const Work& g, const Dims& D, const Geom& t, bool store) {
  float4* gr = reinterpret_cast<float4*>(
      g.r1 + (static_cast<size_t>(t.r0 / kTile) * D.W + t.c0) * kTile);
  float4* sr = reinterpret_cast<float4*>(s.r1);
  for (int i = threadIdx.x; i < t.tw * kTile / 4; i += kThreads) {
    if (store) gr[i] = sr[i];
    else sr[i] = gr[i];
  }
}

// contract_block<MODE, S> on tile t for the loaded chunk's stars sb .. sb +
// 16 S - 1: the same register tiles, the columns and rows at the tile's
// offsets, the sums added to the stars' in out (device memory).
template <int MODE, int S>
__device__ void contract_block(const Params& P, const Smem& s, const Dims& D, const Geom& t,
                               int n, int sb, float* out) {
  constexpr int kOps = MODE == kBuild ? 4 : 2;
  constexpr int kBlock = 16 * S;
  constexpr int kSums = MODE == kBuild ? 9 : 3;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = lane & 15;
  const int sg = 2 * (warp & 7) + (lane >> 4);
  const int half = warp >> 3;
  const int lo = 4 * rg;  // the second quad is lo + 64
  const int j0 = sb + S * sg;
  const int wmid = (t.tw + 1) / 2;
  const int wbeg = half ? wmid : 0, wend = half ? t.tw : wmid;
  const float inv_sig = 1.0f / P.psf_sigma;
  const float inv_sig2 = inv_sig * inv_sig;
  const float* A = MODE == kField ? s.fld : s.r1;

  float acc[S][kOps][8];
  float xh[S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    xh[i] = s.xh[min(j0 + i, n - 1)];
#pragma unroll
    for (int o = 0; o < kOps; ++o)
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[i][o][r] = 0.0f;
  }
  const bool work = lo < t.th && j0 < n;
  if (work) {
    const float* a = A + wbeg * kTile + lo;
    const float* g = s.gx + j0 * kGx + wbeg;
    float wf = static_cast<float>(t.c0 + wbeg);
#pragma unroll 1
    for (int w = wbeg; w < wend; ++w) {
      const float4 a0 = ld4(a), a1 = ld4(a + 64);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float gx[S], zs[S];
#pragma unroll
      for (int i = 0; i < S; ++i) {
        gx[i] = g[i * kGx];
        zs[i] = (wf - xh[i]) * inv_sig2;  // exact difference: the profile's own z / sigma
      }
      contract_column<MODE, S, kOps>(acc, av, gx, zs, inv_sig2);
      a += kTile;
      ++g;
      wf += 1.0f;
    }
  }
  float sums[S][kSums];
#pragma unroll
  for (int i = 0; i < S; ++i) {
#pragma unroll
    for (int q = 0; q < kSums; ++q) sums[i][q] = 0.0f;
    if (work) {
      const int j = min(j0 + i, n - 1);
      const float4 g0 = ld4(s.gy + j * kTile + lo), g1 = ld4(s.gy + j * kTile + lo + 64);
      const float gyv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float yh = s.yh[j];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float gy = gyv[r];
        const float zy = (static_cast<float>(t.r0 + lo + r + (r < 4 ? 0 : 60)) - yh) * inv_sig;
        const float gy1 = gy * zy * inv_sig;
        if (MODE == kField) {
          sums[i][0] = fmaf(gy, acc[i][1][r], sums[i][0]);
          sums[i][1] = fmaf(gy1, acc[i][0][r], sums[i][1]);
          sums[i][2] = fmaf(gy, acc[i][0][r], sums[i][2]);
        } else if (MODE == kSolve) {
          const float ya = gy * gy, yb = gy1 * gy1;
          sums[i][0] = fmaf(ya, acc[i][0][r], sums[i][0]);
          sums[i][1] = fmaf(yb, acc[i][1][r], sums[i][1]);
          sums[i][2] = fmaf(ya, acc[i][1][r], sums[i][2]);
        } else {
          const float ya = gy * gy, yb = gy1 * gy1, yc = gy1 * gy;
          const float yd = yc * (zy * zy - 1.0f) * inv_sig2;
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
      if (j < n) {
        const int k = s.live[j];
#pragma unroll
        for (int q = 0; q < kSums; ++q) {
          const int slot = MODE == kSolve ? (q == 0 ? 0 : (q == 1 ? 5 : 8)) : q;
          out[slot * D.K + k] += sums[i][q] + s.part[q * kBlock + S * sg + i];
        }
      }
    }
  }
  __syncthreads();
}

// The loaded chunk's n stars on tile t, in passes as contract<MODE>.  Ends
// synchronised.
template <int MODE>
__device__ void contract(const Params& P, const Smem& s, const Dims& D, const Geom& t, int n,
                         float* out) {
  constexpr int kMaxS = MODE == kBuild ? 2 : 4;
  for (int sb = 0; sb < n;) {
    const int S = min(kMaxS, (n - sb + 15) / 16);
    if (S == 1) contract_block<MODE, 1>(P, s, D, t, n, sb, out);
    else if (S == 2) contract_block<MODE, 2>(P, s, D, t, n, sb, out);
    else if (S == 3) contract_block<MODE, (kMaxS >= 3 ? 3 : 1)>(P, s, D, t, n, sb, out);
    else contract_block<MODE, kMaxS>(P, s, D, t, n, sb, out);
    sb += 16 * S;
  }
}

// q_field() on tile t, s.r1 holding its 1/lam: every chunk loaded with its
// q weights, its operands written into s.fld kRec stars at a time and
// accumulated in the register tile; q / lam^2 into s.fld.  Returns the last
// chunk's count (its profiles stay loaded).  Ends synchronised.
__device__ int q_tile(const Params& P, const Smem& s, const Work& g, const Dims& D,
                      const Geom& t) {
  const int tid = threadIdx.x;
  const FieldTile f = field_tile(t);
  const float inv_sig = 1.0f / P.psf_sigma;
  float acc[4][8];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[c][r] = 0.0f;
  int n = 0;
  for (int jb = 0; jb < D.nl; jb += kChunk) {
    n = min(kChunk, D.nl - jb);
    load_chunk(P, s, g, D, t, jb, n, true);
    for (int j0 = 0; j0 < n; j0 += kRec) {
      const int m = min(kRec, n - j0);
      __syncthreads();  // s.fld's earlier readers are done
      const int pix = tid % kTile;
#pragma unroll 4
      for (int jj = tid / kTile; jj < m; jj += kThreads / kTile) {
        const int j = j0 + jj;
        float* rec = s.fld + jj * kRecord + pix;
        const float gy = s.gy[j * kTile + pix];
        const float zy = (static_cast<float>(t.r0 + pix) - s.yh[j]) * inv_sig;
        const float ysq = gy * gy;
        rec[0] = ysq;
        rec[kTile] = s.ca[kChunk + j] * (ysq * (zy * zy));
        const float gx = s.gx[j * kGx + pix];
        const float zx = (static_cast<float>(t.c0 + pix) - s.xh[j]) * inv_sig;
        const float xsq = gx * gx;
        rec[2 * kTile] = xsq * fmaf(s.ca[j], zx * zx, s.ca[2 * kChunk + j]);
        rec[3 * kTile] = xsq;
      }
      __syncthreads();
      if (f.active && f.rows) {
        const float* py = s.fld + f.h0;
        const float* px = s.fld + 2 * kTile + f.c0;
        for (int jj = 0; jj < m; ++jj) {
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
  }
  __syncthreads();  // the operands are read
  if (f.active) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = f.c0 + c;
      if (col < t.tw) {
        const float4 a = ld4(s.r1 + col * kTile + f.h0), b = ld4(s.r1 + col * kTile + f.h0 + 4);
        float* o = s.fld + col * kTile + f.h0;
        st4(o, acc[c][0] * (a.x * a.x), acc[c][1] * (a.y * a.y), acc[c][2] * (a.z * a.z),
            acc[c][3] * (a.w * a.w));
        st4(o + 4, acc[c][4] * (b.x * b.x), acc[c][5] * (b.y * b.y),
            acc[c][6] * (b.z * b.z), acc[c][7] * (b.w * b.w));
      }
    }
  }
  __syncthreads();
  return n;
}

// diag_metric_star() on the per-star scalars in device memory.
__device__ void metric_star(const Params& P, const Work& g, int k, float beta, float d1,
                            float d6, float d9, float* out, float* infod) {
  const float m = g.m[k];
  const float su = g.su[k], sv = g.sv[k];
  const float f_u = g.wcx[k] * g.wcx[k] * d1;
  const float f_v = g.wcy[k] * g.wcy[k] * d6;
  const float f_s = g.w[k] * g.w[k] * d9;
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

// wt_terms(): W(wt) into out from g.wt at the structs' theta, tile by tile
// (1/lam from g.r1).  Every thread calls it; it ends synchronised.
__device__ void wt_terms(const Params& P, const Smem& s, const Work& g, const Dims& D,
                         float beta, const float* add, float* out) {
  const int K = D.K;
  for (int a = threadIdx.x; a < 3 * K; a += kThreads) g.dot[a] = 0.0f;
  const int n_tiles = bands(D.H) * bands(D.W);
  for (int i = 0; i < n_tiles; ++i) {
    const Geom t = tile_geom(D, i);
    __syncthreads();  // s.r1's readers are done
    tile_r1(s, g, D, t, false);
    int n = q_tile(P, s, g, D, t);  // synchronises before it reads s.r1
    for (int jb = 0; jb < D.nl; jb += kChunk) {
      if (D.nl > kChunk) {
        n = min(kChunk, D.nl - jb);
        load_chunk(P, s, g, D, t, jb, n, false);
      }
      contract<kField>(P, s, D, t, n, g.dot);
    }
  }
  __syncthreads();
  for (int a = threadIdx.x; a < 3 * K; a += kThreads) {
    const int k = a / 3, tc = a - 3 * k;
    const float coef = tc == 0 ? g.wcx[k] : (tc == 1 ? g.wcy[k] : g.w[k]);
    const float cq = coef * g.dot[tc * K + k];
    const float cterm = g.wt[3 * k] * g.cten[(0 * 3 + tc) * K + k]
                        + g.wt[3 * k + 1] * g.cten[(1 * 3 + tc) * K + k]
                        + g.wt[3 * k + 2] * g.cten[(2 * 3 + tc) * K + k];
    out[a] = add[a] + (beta * (2.0f * cterm - cq) + g.wt[a] * g.infod[a]);
  }
  __syncthreads();
}

// build_structs() at g.th_b, tile by tile: U_beta into s.scal[0], and grad
// U_beta, the metric, info', the C tensor and t1 into the workspace, 1/lam
// into g.r1.
__device__ void build_structs(const Params& P, const Smem& s, const Work& g, const Dims& D,
                              float beta) {
  const int tid = threadIdx.x;
  const int K = D.K;
  star_coefs(g, D, g.th_b);
  for (int a = tid; a < 3 * K; a += kThreads) g.dot[a] = 0.0f;
  for (int a = tid; a < 9 * K; a += kThreads) g.dd[a] = 0.0f;
  const int n_tiles = bands(D.H) * bands(D.W);
  double ll = 0.0;
  for (int i = 0; i < n_tiles; ++i) {
    const Geom t = tile_geom(D, i);
    const FieldTile f = field_tile(t);
    float acc[4][8];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[c][r] = P.background;
    int n = 0;
    for (int jb = 0; jb < D.nl; jb += kChunk) {
      n = min(kChunk, D.nl - jb);
      load_chunk(P, s, g, D, t, jb, n, false);
      render_acc(acc, s, f, n);
    }
    __syncthreads();  // the last tile's contractions of s.r1 and s.fld are done
    render_out(P, s, D, t, f, acc, beta, true, ll);
    tile_r1(s, g, D, t, true);
    for (int jb = 0; jb < D.nl; jb += kChunk) {
      if (D.nl > kChunk) {
        n = min(kChunk, D.nl - jb);
        load_chunk(P, s, g, D, t, jb, n, false);
      }
      contract<kField>(P, s, D, t, n, g.dot);  // rho -> dot
      contract<kBuild>(P, s, D, t, n, g.dd);   // 1/lam -> d1..d9
    }
  }
  ll = block_sum_d(ll, s.red);  // synchronises
  double lp = 0.0;
  for (int k = tid; k < K; k += kThreads) {
    const float u = g.th_b[3 * k], v = g.th_b[3 * k + 1], sl = g.th_b[3 * k + 2];
    const float m = g.m[k];
    const float lp_pos = -(softplusf(u) + softplusf(-u) + softplusf(v) + softplusf(-v));
    const float zf = (sl - P.logf_mean) / P.logf_sigma;
    const float lp_flux = -0.5f * zf * zf + P.lp_flux_const;
    lp += static_cast<double>((lp_pos + lp_flux) * m);
    const float su = g.su[k], sv = g.sv[k], w = g.w[k];
    const float cx = D.W * su * (1.0f - su), cy = D.H * sv * (1.0f - sv);
    const float g_u = (1.0f - 2.0f * su) * m;
    const float g_v = (1.0f - 2.0f * sv) * m;
    const float g_s = -zf / P.logf_sigma * m;
    const float* dd = g.dd;
    const float d1 = dd[k], d2 = dd[K + k], d3 = dd[2 * K + k], d4 = dd[3 * K + k],
                d5 = dd[4 * K + k], d6 = dd[5 * K + k], d7 = dd[6 * K + k],
                d8 = dd[7 * K + k], d9 = dd[8 * K + k];
    const float wcx = g.wcx[k], wcy = g.wcy[k];
    g.t1[3 * k] = -(wcx * g.dot[k] + g_u);
    g.t1[3 * k + 1] = -(wcy * g.dot[K + k] + g_v);
    g.t1[3 * k + 2] = -(w * g.dot[2 * K + k] + g_s);
    const float wcxcy = w * cx * cy;
    const float f_u = wcx * wcx * d1, f_v = wcy * wcy * d6, f_s = w * w * d9;
    float* c = g.cten;
    c[(0 * 3 + 0) * K + k] = wcx * ((w * cx * (1.0f - 2.0f * su)) * d1 + (w * cx * cx) * d2);
    c[(1 * 3 + 0) * K + k] = wcy * wcxcy * d3;
    c[(2 * 3 + 0) * K + k] = w * wcx * d4;
    c[(0 * 3 + 1) * K + k] = wcx * wcxcy * d5;
    c[(1 * 3 + 1) * K + k] = wcy * ((w * cy * (1.0f - 2.0f * sv)) * d6 + (w * cy * cy) * d7);
    c[(2 * 3 + 1) * K + k] = w * wcy * d8;
    c[(0 * 3 + 2) * K + k] = f_u;
    c[(1 * 3 + 2) * K + k] = f_v;
    c[(2 * 3 + 2) * K + k] = f_s;
    metric_star(P, g, k, beta, d1, d6, d9, g.g, g.infod);
  }
  lp = block_sum_d(lp, s.red);  // synchronises
  if (tid == 0) s.scal[0] = static_cast<float>(-(static_cast<double>(beta) * ll + lp));
  for (int a = tid; a < 3 * K; a += kThreads) g.wt[a] = 0.5f / g.g[a];
  __syncthreads();
  wt_terms(P, s, g, D, beta, g.t1, g.t1);
}

// dh_dtheta(): dH/dtheta at the structs' theta and momentum p into out.
__device__ void dh_dtheta(const Params& P, const Smem& s, const Work& g, const Dims& D,
                          float beta, const float* p, float* out) {
  for (int a = threadIdx.x; a < 3 * D.K; a += kThreads) {
    const float v = p[a] / g.g[a];
    g.wt[a] = -0.5f * v * v;
  }
  __syncthreads();
  wt_terms(P, s, g, D, beta, g.t1, out);
}

// diag_solve(): the metric at theta `th` into g.gs, tile by tile.
__device__ void diag_solve(const Params& P, const Smem& s, const Work& g, const Dims& D,
                           float beta, const float* th) {
  const int K = D.K;
  star_coefs(g, D, th);
  for (int k = threadIdx.x; k < K; k += kThreads) {
    g.dd[k] = 0.0f;
    g.dd[5 * K + k] = 0.0f;
    g.dd[8 * K + k] = 0.0f;
  }
  const int n_tiles = bands(D.H) * bands(D.W);
  double unused = 0.0;
  for (int i = 0; i < n_tiles; ++i) {
    const Geom t = tile_geom(D, i);
    const FieldTile f = field_tile(t);
    float acc[4][8];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[c][r] = P.background;
    int n = 0;
    for (int jb = 0; jb < D.nl; jb += kChunk) {
      n = min(kChunk, D.nl - jb);
      load_chunk(P, s, g, D, t, jb, n, false);
      render_acc(acc, s, f, n);
    }
    __syncthreads();  // the last tile's contraction of s.r1 is done
    render_out(P, s, D, t, f, acc, beta, false, unused);
    for (int jb = 0; jb < D.nl; jb += kChunk) {
      if (D.nl > kChunk) {
        n = min(kChunk, D.nl - jb);
        load_chunk(P, s, g, D, t, jb, n, false);
      }
      contract<kSolve>(P, s, D, t, n, g.dd);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += kThreads)
    metric_star(P, g, k, beta, g.dd[k], g.dd[5 * K + k], g.dd[8 * K + k], g.gs, nullptr);
  __syncthreads();
}

// fp_delta() over the workspace's entries.
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

// hamiltonian() on the metric in the workspace.
__device__ float hamiltonian(const Smem& s, const Work& g, int d3, const float* p) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < 32) {
    double lg = 0.0, kin = 0.0;
    for (int a = lane; a < d3; a += 32) {
      lg += static_cast<double>(logf(g.g[a]));
      kin += static_cast<double>(p[a] * p[a] / g.g[a]);
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

// fused_rhmc_diag_crowded_kernel's trajectory on the workspace's state.
__global__ void __launch_bounds__(kThreads) fused_rhmc_diag_crowded_wide_kernel(Params P) {
  extern __shared__ float4 smem4[];
  const int c = blockIdx.x, tid = threadIdx.x;
  const int K = P.K, d3 = 3 * K;
  const size_t base = static_cast<size_t>(c) * d3;
  const Smem s = carve(reinterpret_cast<float*>(smem4));
  const Work g = work_of(P, c);
  const float eps = P.eps[c];
  const float half_eps = 0.5f * eps;
  const float beta = *P.beta;

  for (int k = tid; k < K; k += kThreads) g.m[k] = P.mask[static_cast<size_t>(c) * P.mask_stride + k];
  for (int a = tid; a < d3; a += kThreads) {
    g.th_b[a] = P.theta[base + a];
    g.ph[a] = P.xi[base + a];
  }
  __syncthreads();
  Dims D;
  D.K = K; D.H = P.H; D.W = P.W;
  D.nl = compact_live(g, K, s);

  build_structs(P, s, g, D, beta);
  for (int a = tid; a < d3; a += kThreads) g.p_b[a] = sqrtf(g.g[a]) * g.ph[a] * g.m[a / 3];
  __syncthreads();
  const float h0 = hamiltonian(s, g, d3, g.p_b);

  float resid = 0.0f;
  for (int step = 0; step < P.n_steps; ++step) {
    for (int a = tid; a < d3; a += kThreads) g.ph[a] = g.p_b[a];
    __syncthreads();
    float d1 = 0.0f;
    for (int it = 0; it < P.fpi; ++it) {
      dh_dtheta(P, s, g, D, beta, g.ph, g.base);
      for (int a = tid; a < d3; a += kThreads) g.base[a] = g.p_b[a] - half_eps * g.base[a];
      __syncthreads();
      d1 = fp_delta(s, d3, g.base, g.ph);
      for (int a = tid; a < d3; a += kThreads) g.ph[a] = g.base[a];
      __syncthreads();
    }
    for (int a = tid; a < d3; a += kThreads) {
      const float v0 = g.ph[a] / g.g[a];
      g.base[a] = g.th_b[a] + half_eps * v0;
      g.th[a] = g.th_b[a] + eps * v0;
    }
    __syncthreads();
    float d2 = 0.0f;
    for (int it = 0; it < P.fpi; ++it) {
      diag_solve(P, s, g, D, beta, g.th);
      for (int a = tid; a < d3; a += kThreads) g.gs[a] = g.base[a] + half_eps * (g.ph[a] / g.gs[a]);
      __syncthreads();
      d2 = fp_delta(s, d3, g.gs, g.th);
      for (int a = tid; a < d3; a += kThreads) g.th[a] = g.gs[a];
      __syncthreads();
    }
    for (int a = tid; a < d3; a += kThreads) g.th_b[a] = g.th[a];
    __syncthreads();
    build_structs(P, s, g, D, beta);
    dh_dtheta(P, s, g, D, beta, g.ph, g.base);
    for (int a = tid; a < d3; a += kThreads) g.p_b[a] = g.ph[a] - half_eps * g.base[a];
    __syncthreads();
    resid = nanmax(resid, nanmax(d1, d2));
  }
  const float h1 = hamiltonian(s, g, d3, g.p_b);

  for (int a = tid; a < d3; a += kThreads) {
    P.theta_out[base + a] = g.th_b[a];
    P.p_out[base + a] = g.p_b[a];
  }
  if (tid == 0) {
    P.h0_out[c] = h0;
    P.h1_out[c] = h1;
    P.u1_out[c] = s.scal[0];
    P.resid_out[c] = resid;
  }
}

}  // namespace wide

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 on success).  With a
// workspace (grid == C slices of wide::work_floats(K, H, W)) the launch
// takes the wide path, without one the one-tile path.
int starcat_fused_rhmc_diag_crowded(
    const void* theta, const void* xi, const void* eps, const void* mask,
    int mask_stride, const void* beta, const void* image, void* theta_out,
    void* p_out, void* h0_out, void* h1_out, void* u1_out, void* resid_out,
    int C, int K, int H, int W, int n_steps, int fpi, float psf_sigma,
    float psf_norm, float background, float logf_mean, float logf_sigma,
    float lp_flux_const, float jitter, void* work, int grid, void* stream) {
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
  P.work = static_cast<float*>(work);

  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (work != nullptr) {  // the wide path: a workspace slice a chain
    if (K < 1 || grid != C) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = static_cast<size_t>(wide::smem_floats()) * sizeof(float);
    const cudaError_t e = cudaFuncSetAttribute(
        wide::fused_rhmc_diag_crowded_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    wide::fused_rhmc_diag_crowded_wide_kernel<<<C, kThreads, smem, st>>>(P);
    return static_cast<int>(cudaGetLastError());
  }
  if (H > kTile || W > kTile) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(smem_floats(K, W)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_rhmc_diag_crowded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fused_rhmc_diag_crowded_kernel<<<C, kThreads, smem, st>>>(P);
  return static_cast<int>(cudaGetLastError());
}

const char* starcat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
