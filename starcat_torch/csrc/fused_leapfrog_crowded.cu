// Fused leapfrog trajectory for crowded fields on Hopper (sm_90a), one
// thread block per chain, its pixel passes written as block GEMMs in FP32
// on the CUDA cores.
//
// Replaces the Pallas kernel B5 of starcat/pallas_mxu.py:
//   make_pallas_leapfrog_mxu (_mxu_leapfrog_kernel -> _grad_eval_mxu)
// with B1's call contract (csrc/fused_leapfrog.cu): theta, p, grad_in
// (C, K, 3), eps (C,), inv_mass (K, 3), mask (K,) or (C, K), the step count
// from a device int32; out theta', p', u' (C,), grad' (C, K, 3).
//
// One gradient evaluation, per chain (theta (K, 3) = (logit x, logit y,
// log f)), the math of _grad_eval_mxu:
//   profiles  gx[k][w] and, scaled by the star's flux w_k = f_k m_k,
//             gyw[k][h] = gy w_k (K (H + W) expf)
//   render    lam = bg + sum_k gyw_k gx_k,  resid = D / lam - 1
//   loglik    sum D log lam - lam (double), on the final evaluation only
//   contract  per star: sum_pix resid gyw gx (flux), resid gyw gx z (x),
//             resid gyw z gx (y); the chain rule and the priors.
//
// What bounded it: shared-memory loads feeding the FP32 pipes.  At 128x128
// and K = 50 one evaluation is K H W FMAs for the render and 2 K H W for
// the contraction, about 2.5 M FMAs against a state of 3K floats per chain,
// so it is bound by operations; but written as one pixel (render) or one
// star (contraction) at a time, every FMA took one or two shared loads,
// while the SM serves one 32-lane load a clock against four warp FMAs.
//
// What the design does about it: both pixel passes are block GEMMs whose
// threads keep a register tile of the output and load 128-bit vectors, so
// one load feeds 4 to 16 FMAs, as the reference writes them as MXU dots
// (pallas_mxu.py:64-171):
//   * render, lam(H, W) = bg + Gyw^T Gx, depth the live stars: 8 rows x 4
//     columns a thread; resid = D / lam - 1 and, on the final evaluation,
//     the log-likelihood (double) are its epilogue;
//   * contraction over columns, M(H, 2 nl) = resid @ [gx, gx z / sigma],
//     the x-side product made in registers as gx is loaded: 8 rows x S
//     stars x 2 products a thread (S <= 4, no larger than the live stars
//     need), the columns split in two halves over the block's two halves
//     (one warp, at T = 32, takes them all).
//     The epilogue is the sum over rows against gyw (flux, x) and gyw z /
//     sigma (y), formed there from the one stored y set: each thread's
//     eight rows, a shuffle over the T / 8 lanes that hold a star's rows,
//     then the two column halves added in shared memory in a fixed order,
//     so a run is deterministic and a chain's result does not depend on
//     the others.
// The passes tile the scene in the smallest square of T = 32, 64 or 128
// pixels a side that holds it, with T^2 / 32 threads a chain (one warp,
// four, sixteen), so that a small scene fills its block's threads and an
// SM holds more of its chains (16 blocks at T = 32, 4 at 64).
// Every stride is a compile-time constant, so no inner loop divides at run
// time; every star group runs the same loop (the group that straddles the
// last live star reads zero profile rows past it), so no warp diverges into
// a clamped tail.  Only the live stars (m != 0) are GEMM depth and output
// columns: the mask is fixed along a trajectory, so the block lists them
// once at entry; a dead slot's contraction sums stay 0, so its gradient is
// exactly 0 and, with zero momentum, its theta comes back bit for bit.
//
// What bounds it now (scripts/b5_pass_clocks.py): the contraction, half
// the cycles, issues 64 star slots for K = 50 live stars; the render runs at
// about 37% of the FMA rate; one 16-warp block an SM (124 KB at K = 50).
//
// Shared memory (smem_floats, mirrored in fused_leapfrog_crowded.py):
//   * the residual field by column, pixel (h, w) at w T + h, T rows by W
//     columns (64 KB at 128x128; rows past H are zero);
//   * the live stars' profiles, gx (K + 3 rows of kGx = T + 4 floats, an
//     odd number of 16-byte bank groups, so the stars two lane groups load
//     sit in other banks; three zero rows past the live stars) and gyw
//     (K, T);
//   * the (K, 3) state and the per-star scalars, 20 K floats;
// 206 KB at 128x128 and K = 128, so every K <= 128 fits, one block per SM.
// The image is read through the read-only path (L2) in the render's
// epilogue, 16 bytes a load where W is a multiple of 4.  H and W are at
// most 128.
//
// Accuracy: no fast math (expf, logf, IEEE division).  The log-likelihood
// and the prior sum in double, so U carries no float32 summation error over
// the 16384 pixels.  A dead slot (m = 0) has flux 0 by selection, not
// exp(s) * 0, so an extreme theta in a dead slot cannot make NaN.
//
// Beyond that one-tile domain (a side above 128 pixels, or K > 128) the
// launch takes the wide path at the end of this file (namespace wide): the
// field in tiles of at most 128 x 128 pixels and the catalog in chunks of
// 128 slots, the chain's state in device memory.  Inside it, the launch
// takes the code above, unchanged.
//
// Domain (checked by the wrapper): the one-tile path takes 1 <= K <= 128
// and H, W at most 128; the wide path every other (H, W, K) with K >= 1,
// beyond the TPU kernel's VMEM gate too (the JAX package runs XLA there):
// its shared memory is fixed, and the chains' state, masks and the image
// are indexed in 64 bits.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

// The pixel tile of a launch: T x T pixels, T = 32, 64 or 128, the
// smallest that holds the scene, and the block that covers it.
template <int T>
struct Tile {
  static constexpr int kThreads = T * T / 32;   // 8 x 4 render pixels a thread
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kGx = T + 4;             // gx's stride: an odd number of 16-byte groups
  static constexpr int kRg = T / 8;             // contraction lanes over a star's rows
  static constexpr int kSgw = 32 / kRg;         // contraction star groups a warp
  static constexpr int kHalves = kWarps >= 2 ? 2 : 1;       // column splits over the warps
  static constexpr int kGroups = kSgw * kWarps / kHalves;   // star groups a pass
  static constexpr int kPartFloats = 3 * 4 * kGroups;       // column-half partial sums, S <= 4
};

constexpr int kMaxSide = 128;   // the one-tile path's sides
constexpr int kMaxStars = 128;  // and slots

struct Params {
  const float* theta;     // (C, K, 3)
  const float* p;         // (C, K, 3)
  const float* grad_in;   // (C, K, 3) or null: evaluate the entry gradient
  const float* eps;       // (C,)
  const float* inv_mass;  // (K, 3)
  const float* mask;      // (K,) with stride 0, or (C, K) with stride K
  int mask_stride;
  const float* image;     // (H, W), read through L2
  const int* n_steps;     // device scalar
  float* theta_out;
  float* p_out;
  float* u_out;           // (C,)
  float* grad_out;
  int K, H, W;
  float psf_sigma, psf_norm, background;
  float logf_mean, logf_sigma, lp_flux_const;
};

// The tile side for an H x W scene (mirrored by tile_side() in
// fused_leapfrog_crowded.py).
inline int tile_side(int H, int W) {
  const int m = H > W ? H : W;
  return m <= 32 ? 32 : (m <= 64 ? 64 : 128);
}

// mirrored by smem_bytes() in fused_leapfrog_crowded.py
template <int T>
int smem_floats(int K, int W) {
  using G = Tile<T>;
  return T * W + (K + 3) * G::kGx + K * T + 2 * G::kWarps + G::kPartFloats + 20 * K + 4;
}

// Shapes of one launch; nl is the number of live stars.
struct Dims {
  int K, H, W, nl;
};

// Per-slot arrays index k; compact (live-star) arrays index j, slot live[j].
struct Smem {
  float *fld;                        // (W, T): pixel (h, w) at w T + h
  float *gx;                         // (K + 3, kGx), compact; zero past the live stars
  float *gyw;                        // (K, T), compact
  double* red;                       // kWarps
  float *part;                       // kPartFloats
  float *theta, *p, *grad, *invm, *dl;  // 3K each, per slot
  float *mask;                       // K, per slot
  float *px, *py, *cw;               // K each, compact: x, y, flux
  int* live;                         // K
  float *scal;                       // u, the live count
};

template <int T>
__device__ inline Smem carve(float* base, int K, int W) {
  using G = Tile<T>;
  Smem s;
  float* q = base;
  auto take = [&q](int n) { float* r = q; q += n; return r; };
  // the field and the profiles first: every float4 they are read by starts
  // on a 16-byte boundary (T W, (K + 3) kGx and K T are multiples of 4),
  // and so does red
  s.fld = take(T * W);
  s.gx = take((K + 3) * G::kGx); s.gyw = take(K * T);
  s.red = reinterpret_cast<double*>(take(2 * G::kWarps));
  s.part = take(G::kPartFloats);
  s.theta = take(3 * K); s.p = take(3 * K); s.grad = take(3 * K);
  s.invm = take(3 * K); s.dl = take(3 * K);
  s.mask = take(K); s.px = take(K); s.py = take(K); s.cw = take(K);
  s.live = reinterpret_cast<int*>(take(K));
  s.scal = take(4);
  return s;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// Sum over groups of N consecutive lanes (N a power of two, at most 32).
template <int N>
__device__ __forceinline__ float lane_sum(float v) {
  for (int o = N / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum_d(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block, in a fixed order; every thread gets the total.
template <int T>
__device__ double block_sum_d(double v, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum_d(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double tot = 0.0;
  for (int i = 0; i < Tile<T>::kWarps; ++i) tot += red[i];
  __syncthreads();
  return tot;
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float softplusf(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// The live stars' positions and fluxes at s.theta and their profiles gx,
// gyw, each T long (zero past W and H).  Every thread of the block calls
// it; it ends synchronised.
template <int T>
__device__ void profiles(const Params& P, const Smem& s, const Dims& D) {
  constexpr int kThreads = Tile<T>::kThreads;
  const int tid = threadIdx.x;
  const float sig = P.psf_sigma;
  for (int j = tid; j < D.nl; j += kThreads) {
    const int k = s.live[j];
    s.px[j] = D.W * sigmoidf(s.theta[3 * k]);
    s.py[j] = D.H * sigmoidf(s.theta[3 * k + 1]);
    s.cw[j] = expf(s.theta[3 * k + 2]) * s.mask[k];
  }
  __syncthreads();
  // a thread per column (row) of T, kThreads / T stars at a time; gx also
  // zero in the three rows past the live stars, which the contraction's
  // last star group may read
  const int pix = tid % T;
#pragma unroll 4
  for (int j = tid / T; j < D.nl + 3; j += kThreads / T) {
    float v = 0.0f;
    if (j < D.nl && pix < D.W) {
      const float z = ((pix + 0.5f) - s.px[j]) / sig;
      v = expf(-0.5f * z * z) * P.psf_norm;
    }
    s.gx[j * Tile<T>::kGx + pix] = v;
  }
#pragma unroll 4
  for (int j = tid / T; j < D.nl; j += kThreads / T) {
    float v = 0.0f;
    if (pix < D.H) {
      const float z = ((pix + 0.5f) - s.py[j]) / sig;
      v = expf(-0.5f * z * z) * P.psf_norm * s.cw[j];
    }
    s.gyw[j * T + pix] = v;
  }
  __syncthreads();
}

// lam = bg + Gyw^T Gx -> s.fld = D / lam - 1 (0 in the rows past H), and
// with `with_u` the log-likelihood sum_p D log lam - lam (double), returned
// to every thread.  8 rows x 4 columns a thread over the T x T tile; a
// warp holds 4 row groups x 8 column groups, so its loads of either
// profile are one 128-byte line, and the warps hold T / 32 x T / 32 such
// blocks.  Ends synchronised.
template <int T>
__device__ double render(const Params& P, const Smem& s, const Dims& D, bool with_u) {
  constexpr int kB = T / 32;  // warp blocks a side
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h0 = 8 * ((lane & 3) + 4 * (warp % kB));
  const int c0 = 4 * ((lane >> 2) + 8 * (warp / kB));
  double ll = 0.0;
  if (c0 < D.W) {
    float acc[4][8];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[c][r] = P.background;
    if (h0 < D.H) {
      const float* py = s.gyw + h0;
      const float* px = s.gx + c0;
      for (int j = 0; j < D.nl; ++j) {
        const float4 ya = ld4(py), yb = ld4(py + 4), xv = ld4(px);
        const float y[8] = {ya.x, ya.y, ya.z, ya.w, yb.x, yb.y, yb.z, yb.w};
        const float x[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int r = 0; r < 8; ++r) acc[c][r] = fmaf(y[r], x[c], acc[c][r]);
        py += T;
        px += Tile<T>::kGx;
      }
    }
    // the image's rows, 16 bytes a load where the rows allow it
    float img[8][4];
    const bool vec = (D.W & 3) == 0;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int h = h0 + r;
      const float* row = P.image + h * D.W + c0;
      if (h < D.H && vec) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(row));
        img[r][0] = v.x; img[r][1] = v.y; img[r][2] = v.z; img[r][3] = v.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) img[r][c] = (h < D.H && c0 + c < D.W) ? __ldg(row + c) : 0.0f;
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c0 + c < D.W) {
        float res[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          res[r] = 0.0f;
          if (h0 + r < D.H) {
            const float lam = acc[c][r], d = img[r][c];
            res[r] = d / lam - 1.0f;
            if (with_u) ll += static_cast<double>(d * logf(lam) - lam);
          }
        }
        float* o = s.fld + (c0 + c) * T + h0;
        st4(o, res[0], res[1], res[2], res[3]);
        st4(o + 4, res[4], res[5], res[6], res[7]);
      }
    }
  }
  if (with_u) return block_sum_d<T>(ll, s.red);  // synchronises
  __syncthreads();
  return 0.0;
}

// The contraction of stars sb .. sb + kGroups S - 1 (compact): M(H, 2) =
// resid @ [gx, gx z / sigma] per star, then the sums over rows against gyw
// (M's two columns: flux, x) and gyw z / sigma (the first: y) into s.dl.
// A thread holds 8 rows x S stars x 2 products over its share of the
// columns: rows 4 rg..4 rg+3 and T/2 + 4 rg..T/2 + 4 rg+3, so that the kRg
// lanes that hold a star group read 16 kRg contiguous bytes of a column;
// a warp holds kSgw star groups of S consecutive stars, and, where the
// block has two warps or more, its two halves the two column halves.
template <int T, int S>
__device__ void contract_block(const Params& P, const Smem& s, const Dims& D, int sb) {
  using G = Tile<T>;
  constexpr int kBlock = G::kGroups * S;
  constexpr int kWh = G::kWarps / G::kHalves;  // warps a column half
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = lane % G::kRg;
  const int sg = G::kSgw * (warp % kWh) + lane / G::kRg;
  const int half = warp / kWh;
  const int lo = 4 * rg;  // the second quad is lo + T/2
  const int j0 = sb + S * sg;
  const int wmid = G::kHalves == 2 ? (D.W + 1) / 2 : D.W;
  const int wbeg = half ? wmid : 0, wend = half ? D.W : wmid;
  const float inv_sig = 1.0f / P.psf_sigma;
  const float inv_sig2 = inv_sig * inv_sig;

  float acc[S][2][8];
  float xh[S];  // x - 1/2: z sigma = w - xh, exact near the star
#pragma unroll
  for (int i = 0; i < S; ++i) {
    xh[i] = s.px[min(j0 + i, D.nl - 1)] - 0.5f;
#pragma unroll
    for (int o = 0; o < 2; ++o)
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[i][o][r] = 0.0f;
  }
  // rows past H are zero in the field and in gyw; a star group past the
  // live stars skips the columns, and the stars past the last live one in
  // the group that straddles it read zero profiles (their sums are never
  // stored)
  const bool work = lo < D.H && j0 < D.nl;
  if (work) {
    const float* a = s.fld + wbeg * T + lo;
    const float* g = s.gx + j0 * G::kGx + wbeg;
    float wf = static_cast<float>(wbeg);
#pragma unroll 1
    for (int w = wbeg; w < wend; ++w) {
      const float4 a0 = ld4(a), a1 = ld4(a + T / 2);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const float gx = g[i * G::kGx];
        const float gxz = gx * ((wf - xh[i]) * inv_sig2);  // gx z / sigma
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          acc[i][0][r] = fmaf(av[r], gx, acc[i][0][r]);
          acc[i][1][r] = fmaf(av[r], gxz, acc[i][1][r]);
        }
      }
      a += T;
      ++g;
      wf += 1.0f;
    }
  }
  // the sums over rows against the y-side products
  float sums[S][3];
#pragma unroll
  for (int i = 0; i < S; ++i) {
#pragma unroll
    for (int q = 0; q < 3; ++q) sums[i][q] = 0.0f;
    if (work) {
      const int j = min(j0 + i, D.nl - 1);
      const float4 g0 = ld4(s.gyw + j * T + lo), g1 = ld4(s.gyw + j * T + lo + T / 2);
      const float gyv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float yh = s.py[j] - 0.5f;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float dy = static_cast<float>(lo + r + (r < 4 ? 0 : T / 2 - 4)) - yh;  // z sigma
        sums[i][0] = fmaf(gyv[r], acc[i][0][r], sums[i][0]);                      // flux
        sums[i][1] = fmaf(gyv[r], acc[i][1][r], sums[i][1]);                      // x
        sums[i][2] = fmaf(gyv[r] * (dy * inv_sig2), acc[i][0][r], sums[i][2]);      // y
      }
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) sums[i][q] = lane_sum<G::kRg>(sums[i][q]);
  }
  // the two column halves, added in a fixed order
  if (G::kHalves == 2 && half == 1 && rg == 0) {
#pragma unroll
    for (int i = 0; i < S; ++i)
#pragma unroll
      for (int q = 0; q < 3; ++q) s.part[q * kBlock + S * sg + i] = sums[i][q];
  }
  if (G::kHalves == 2) __syncthreads();
  if (half == 0 && rg == 0) {
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int j = j0 + i;
      if (j < D.nl) {
        const int k = s.live[j];
#pragma unroll
        for (int q = 0; q < 3; ++q)
          s.dl[3 * k + q] = G::kHalves == 2 ? sums[i][q] + s.part[q * kBlock + S * sg + i]
                                            : sums[i][q];
      }
    }
  }
  __syncthreads();
}

// All live stars, in passes of kGroups S stars, S as large as the
// registers allow (4) and no larger than the stars left need, so that a
// pass computes few columns past the live stars.  Ends synchronised.
template <int T>
__device__ void contract(const Params& P, const Smem& s, const Dims& D) {
  constexpr int kG = Tile<T>::kGroups;
  for (int sb = 0; sb < D.nl;) {
    const int S = min(4, (D.nl - sb + kG - 1) / kG);
    if (S == 1) contract_block<T, 1>(P, s, D, sb);
    else if (S == 2) contract_block<T, 2>(P, s, D, sb);
    else if (S == 3) contract_block<T, 3>(P, s, D, sb);
    else contract_block<T, 4>(P, s, D, sb);
    sb += kG * S;
  }
}

// The chain rule to (ux, uy, s) and the priors, a slot at a time per
// thread, into s.grad and, with `with_u`, U = -(ll + log prior) into
// s.scal[0].  Every thread of the block calls it; it ends synchronised.
template <int T>
__device__ void chain_rule(const Params& P, const Smem& s, const Dims& D, bool with_u,
                           double ll) {
  const int tid = threadIdx.x;
  double lp = 0.0;
  for (int k = tid; k < D.K; k += Tile<T>::kThreads) {
    const float ux = s.theta[3 * k], uy = s.theta[3 * k + 1], sl = s.theta[3 * k + 2];
    const float m = s.mask[k];
    const float sx = sigmoidf(ux), sy = sigmoidf(uy);
    const float gl_ux = s.dl[3 * k + 1] * D.W * sx * (1.0f - sx);
    const float gl_uy = s.dl[3 * k + 2] * D.H * sy * (1.0f - sy);
    const float gl_s = s.dl[3 * k];
    const float zf = (sl - P.logf_mean) / P.logf_sigma;
    s.grad[3 * k] = -(gl_ux * m + (1.0f - 2.0f * sx) * m);
    s.grad[3 * k + 1] = -(gl_uy * m + (1.0f - 2.0f * sy) * m);
    s.grad[3 * k + 2] = -(gl_s * m + (-zf / P.logf_sigma) * m);
    if (with_u) {
      const float lp_pos = -(softplusf(ux) + softplusf(-ux) + softplusf(uy) + softplusf(-uy));
      const float lp_flux = -0.5f * zf * zf + P.lp_flux_const;
      lp += static_cast<double>((lp_pos + lp_flux) * m);
    }
  }
  if (with_u) {
    lp = block_sum_d<T>(lp, s.red);  // synchronises
    if (tid == 0) s.scal[0] = static_cast<float>(-(ll + lp));
  }
  __syncthreads();
}

// dU/dtheta at s.theta into s.grad and, when with_u, U into s.scal[0].
// Every thread of the block must call it (it synchronises).
template <int T>
__device__ void grad_eval(const Params& P, const Smem& s, const Dims& D, bool with_u) {
  profiles<T>(P, s, D);
  const double ll = render<T>(P, s, D, with_u);
  contract<T>(P, s, D);
  chain_rule<T>(P, s, D, with_u, ll);
}

// One chain a block; at most 512 threads a block and 128 registers a
// thread (the blocks an SM holds at the smaller tiles: 4 at 64, 16 at 32).
template <int T>
__global__ void __launch_bounds__(Tile<T>::kThreads, 512 / Tile<T>::kThreads)
    fused_leapfrog_crowded_kernel(Params P) {
  constexpr int kThreads = Tile<T>::kThreads;
  extern __shared__ float4 smem4[];
  const int c = blockIdx.x, tid = threadIdx.x;
  const int K = P.K, d3 = 3 * K;
  const Smem s = carve<T>(reinterpret_cast<float*>(smem4), K, P.W);
  const float eps = P.eps[c];
  // a device count cannot be checked on the host; a negative one acts as 0
  const int n = max(*P.n_steps, 0);
  const bool grad_in = P.grad_in != nullptr && n > 0;

  for (int a = tid; a < d3; a += kThreads) {
    s.theta[a] = P.theta[c * d3 + a];
    s.p[a] = P.p[c * d3 + a];
    s.invm[a] = P.inv_mass[a];
    if (grad_in) s.grad[a] = P.grad_in[c * d3 + a];
    s.dl[a] = 0.0f;  // a dead slot's sums stay 0
  }
  for (int k = tid; k < K; k += kThreads) s.mask[k] = P.mask[c * P.mask_stride + k];
  __syncthreads();
  if (tid == 0) {
    int nl = 0;
    for (int k = 0; k < K; ++k)
      if (s.mask[k] != 0.0f) s.live[nl++] = k;
    s.scal[1] = static_cast<float>(nl);
  }
  __syncthreads();
  Dims D;
  D.K = K; D.H = P.H; D.W = P.W;
  D.nl = static_cast<int>(s.scal[1]);

  // n == 0 returns (U, grad U) at theta; otherwise the entry gradient is
  // taken from grad_in or evaluated here, and only the final of the n
  // evaluations computes the log-likelihood for U.
  if (!grad_in) grad_eval<T>(P, s, D, n == 0);
  for (int step = 0; step < n; ++step) {
    for (int a = tid; a < d3; a += kThreads) {
      const float p_half = s.p[a] - 0.5f * eps * s.grad[a];
      s.p[a] = p_half;
      s.theta[a] = s.theta[a] + eps * s.invm[a] * p_half;
    }
    __syncthreads();
    grad_eval<T>(P, s, D, step == n - 1);
    for (int a = tid; a < d3; a += kThreads) s.p[a] = s.p[a] - 0.5f * eps * s.grad[a];
  }

  for (int a = tid; a < d3; a += kThreads) {
    P.theta_out[c * d3 + a] = s.theta[a];
    P.p_out[c * d3 + a] = s.p[a];
    P.grad_out[c * d3 + a] = s.grad[a];
  }
  if (tid == 0) P.u_out[c] = s.scal[0];
}

// The launch of C chains at tile T (or, with blocks_per_sm, its
// occupancy), its dynamic shared memory allowed.
template <int T>
cudaError_t run(const Params& P, int C, cudaStream_t st, int* blocks_per_sm) {
  const size_t smem = static_cast<size_t>(smem_floats<T>(P.K, P.W)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(fused_leapfrog_crowded_kernel<T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  if (blocks_per_sm != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, fused_leapfrog_crowded_kernel<T>, Tile<T>::kThreads, smem);
  fused_leapfrog_crowded_kernel<T><<<C, Tile<T>::kThreads, smem, st>>>(P);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The wide path: fields with a side above 128 pixels and catalogs of more
// than 128 slots, up to the TPU kernel's own domain.
//
// What changes: one block of 512 threads a chain, as at T = 128, walks the
// field in pixel tiles of at most 128 x 128 (tile i of a row-major grid of
// 128-pixel bands; the last band of each axis ragged) and the catalog in
// chunks of kChunk = 128 slots, whose live stars (m != 0) it compacts in
// slot order at each load (a ballot a warp).  For each gradient evaluation
// and tile, the render adds each chunk's stars to lam in the same register
// tile (8 rows x 4 columns a thread), its epilogue writes the tile's
// residual field and adds the tile's log-likelihood to a per-thread double;
// then each chunk's contraction over the tile adds its sums to the stars'
// sums in device memory.  When one chunk holds the catalog, its profiles
// serve both passes of a tile; otherwise a chunk's are made again for the
// contraction (K (T + T) exponentials against 3 K T T FMAs).
//
// The chain's state lives in device memory, in the launch's own outputs:
// theta in theta_out, p in p_out, grad in grad_out, where the contraction
// sums (flux, x, y) of a star sit until the chain rule turns them into its
// gradient in place.  The tiles and chunks run in a fixed order and one
// thread adds a star's sums, so a run is deterministic and a chain's result
// does not depend on the others; a dead slot's sums stay 0, so its gradient
// is 0 and, with zero momentum, its theta comes back bit for bit.  The
// shared memory is the tile's residual field, one chunk's profiles and
// per-star scalars (smem_floats, 200 KB whatever the scene), one block an SM.
//
// A star's position is made in double and kept as a float and its
// remainder (px + pxl), so a pixel's offset from it, (pixel - (px - 1/2))
// - pxl, is exact to float32's relative precision in the profiles and
// their derivatives alike.  A float32 x rounds the centre by up to 2^-17
// pixels beyond 128 pixels, and at a bright star's stiffness that moves the
// gradient more than the float32 sums do: at a ChEES run's last state on
// a 256x256 field the kernel with float32 centres, like its plain version,
// lay a median 2.4e-3 (relative to 1 + |g|) from float64 there
// (scripts/b5_run_state_accuracy.py --w2).
namespace wide {

constexpr int T = 128;
using G = Tile<T>;
constexpr int kThreads = G::kThreads;  // 512
constexpr int kChunk = 128;            // catalog slots a chunk

// A pixel tile: rows r0 .. r0 + th - 1 and columns c0 .. c0 + tw - 1.
struct Geom {
  int r0, c0, th, tw;
};

__host__ __device__ inline int tiles_across(int n) { return (n + T - 1) / T; }

__device__ inline Geom tile_geom(int H, int W, int i) {
  const int nc = (W + T - 1) / T;
  const int tr = i / nc, tc = i - tr * nc;
  Geom t;
  t.r0 = tr * T;
  t.c0 = tc * T;
  t.th = min(T, H - t.r0);
  t.tw = min(T, W - t.c0);
  return t;
}

// mirrored by wide_smem_bytes() in fused_leapfrog_crowded.py
inline int smem_floats() {
  return T * T + (kChunk + 3) * G::kGx + kChunk * T + 2 * G::kWarps + G::kPartFloats
         + 6 * kChunk + G::kWarps + 4;
}

struct Smem {
  float* fld;            // (T, T) by column: pixel (r0 + h, c0 + w) at w T + h
  float* gx;             // (kChunk + 3, kGx), the chunk's live stars; zero past them
  float* gyw;            // (kChunk, T)
  double* red;           // kWarps
  float* part;           // kPartFloats
  float *px, *py, *cw;   // kChunk each: the chunk's live stars' x, y and flux
  float *pxl, *pyl;      // kChunk each: x - px and y - py, to double precision
  int* live;             // kChunk: their slots
  int* cnt;              // kWarps: the compaction's counts by warp
  float* scal;           // u
};

__device__ inline Smem carve(float* base) {
  Smem s;
  float* q = base;
  auto take = [&q](int n) { float* r = q; q += n; return r; };
  s.fld = take(T * T);
  s.gx = take((kChunk + 3) * G::kGx); s.gyw = take(kChunk * T);
  s.red = reinterpret_cast<double*>(take(2 * G::kWarps));
  s.part = take(G::kPartFloats);
  s.px = take(kChunk); s.py = take(kChunk); s.cw = take(kChunk);
  s.pxl = take(kChunk); s.pyl = take(kChunk);
  s.live = reinterpret_cast<int*>(take(kChunk));
  s.cnt = reinterpret_cast<int*>(take(G::kWarps));
  s.scal = take(4);
  return s;
}

// The live slots of kb .. kb + kChunk - 1 in slot order into s.live, a
// slot a thread of the first kChunk / 32 warps; their count to every
// thread.  Ends synchronised.
__device__ int compact_chunk(const float* mask, int K, int kb, const Smem& s) {
  constexpr int kW = kChunk / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  bool on = false;
  unsigned b = 0u;
  if (warp < kW) {
    on = kb + tid < K && mask[kb + tid] != 0.0f;
    b = __ballot_sync(0xffffffffu, on);
    if (lane == 0) s.cnt[warp] = __popc(b);
  }
  __syncthreads();
  int n = 0, off = 0;
  for (int i = 0; i < kW; ++i) {
    if (i < warp) off += s.cnt[i];
    n += s.cnt[i];
  }
  if (on) s.live[off + __popc(b & ((1u << lane) - 1u))] = kb + tid;
  __syncthreads();
  return n;
}

// Chunk kb's live stars at theta on tile t: their slots, positions and
// fluxes, and their profiles gx over the tile's columns and gyw over its
// rows, T long (zero past the tile, and gx in the three rows past the live
// stars).  Returns their count to every thread; starts and ends
// synchronised.
__device__ int load_chunk(const Params& P, const Smem& s, const float* theta,
                          const float* mask, int kb, const Geom& t) {
  __syncthreads();  // the previous chunk's readers are done
  const int n = compact_chunk(mask, P.K, kb, s);
  const int tid = threadIdx.x;
  const float sig = P.psf_sigma;
  if (tid < n) {
    const int k = s.live[tid];
    const double xd = P.W / (1.0 + exp(-static_cast<double>(theta[3 * k])));
    const double yd = P.H / (1.0 + exp(-static_cast<double>(theta[3 * k + 1])));
    const float xf = static_cast<float>(xd), yf = static_cast<float>(yd);
    s.px[tid] = xf;
    s.py[tid] = yf;
    s.pxl[tid] = static_cast<float>(xd - xf);
    s.pyl[tid] = static_cast<float>(yd - yf);
    s.cw[tid] = expf(theta[3 * k + 2]) * mask[k];
  }
  __syncthreads();
  const int pix = tid % T;
#pragma unroll 4
  for (int j = tid / T; j < n + 3; j += kThreads / T) {
    float v = 0.0f;
    if (j < n && pix < t.tw) {
      const float z = (((static_cast<float>(t.c0 + pix) + 0.5f) - s.px[j]) - s.pxl[j]) / sig;
      v = expf(-0.5f * z * z) * P.psf_norm;
    }
    s.gx[j * G::kGx + pix] = v;
  }
#pragma unroll 4
  for (int j = tid / T; j < n; j += kThreads / T) {
    float v = 0.0f;
    if (pix < t.th) {
      const float z = (((static_cast<float>(t.r0 + pix) + 0.5f) - s.py[j]) - s.pyl[j]) / sig;
      v = expf(-0.5f * z * z) * P.psf_norm * s.cw[j];
    }
    s.gyw[j * T + pix] = v;
  }
  __syncthreads();
  return n;
}

// The thread's render pixels in a tile: rows h0 .. h0 + 7, columns c0 ..
// c0 + 3, as render<128> lays them out.
struct Px {
  int h0, c0;
};

__device__ __forceinline__ Px px_of() {
  constexpr int kB = T / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Px q;
  q.h0 = 8 * ((lane & 3) + 4 * (warp % kB));
  q.c0 = 4 * ((lane >> 2) + 8 * (warp / kB));
  return q;
}

// lam += Gyw^T Gx over the loaded chunk's n stars.
__device__ __forceinline__ void render_acc(float (&acc)[4][8], const Smem& s, const Geom& t,
                                           const Px& q, int n) {
  if (q.c0 >= t.tw || q.h0 >= t.th) return;
  const float* py = s.gyw + q.h0;
  const float* px = s.gx + q.c0;
  for (int j = 0; j < n; ++j) {
    const float4 ya = ld4(py), yb = ld4(py + 4), xv = ld4(px);
    const float y[8] = {ya.x, ya.y, ya.z, ya.w, yb.x, yb.y, yb.z, yb.w};
    const float x[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[c][r] = fmaf(y[r], x[c], acc[c][r]);
    py += T;
    px += G::kGx;
  }
}

// The tile's epilogue: s.fld = D / lam - 1 (0 in the rows past the tile)
// and, with `with_u`, the tile's sum_p D log lam - lam added to ll.  Ends
// synchronised.
__device__ void render_out(const Params& P, const Smem& s, const Geom& t, const Px& q,
                           const float (&acc)[4][8], bool with_u, double& ll) {
  if (q.c0 < t.tw) {
    float img[8][4];
    const bool vec = (P.W & 3) == 0;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int h = q.h0 + r;
      const float* row = P.image + static_cast<size_t>(t.r0 + h) * P.W + t.c0 + q.c0;
      if (h < t.th && vec) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(row));
        img[r][0] = v.x; img[r][1] = v.y; img[r][2] = v.z; img[r][3] = v.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          img[r][c] = (h < t.th && q.c0 + c < t.tw) ? __ldg(row + c) : 0.0f;
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (q.c0 + c < t.tw) {
        float res[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          res[r] = 0.0f;
          if (q.h0 + r < t.th) {
            const float lam = acc[c][r], d = img[r][c];
            res[r] = d / lam - 1.0f;
            if (with_u) ll += static_cast<double>(d * logf(lam) - lam);
          }
        }
        float* o = s.fld + (q.c0 + c) * T + q.h0;
        st4(o, res[0], res[1], res[2], res[3]);
        st4(o + 4, res[4], res[5], res[6], res[7]);
      }
    }
  }
  __syncthreads();
}

// contract_block<128, S> on tile t for the loaded chunk's stars sb .. sb +
// kGroups S - 1: the same register tiles, the columns and rows at the
// tile's offsets, the sums added to the stars' in dl (device memory, 3 a
// slot: flux, x, y).
template <int S>
__device__ void contract_block(const Params& P, const Smem& s, const Geom& t, int n, int sb,
                               float* dl) {
  constexpr int kBlock = G::kGroups * S;
  constexpr int kWh = G::kWarps / G::kHalves;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = lane % G::kRg;
  const int sg = G::kSgw * (warp % kWh) + lane / G::kRg;
  const int half = warp / kWh;
  const int lo = 4 * rg;  // the second quad is lo + T/2
  const int j0 = sb + S * sg;
  const int wmid = (t.tw + 1) / 2;
  const int wbeg = half ? wmid : 0, wend = half ? t.tw : wmid;
  const float inv_sig = 1.0f / P.psf_sigma;
  const float inv_sig2 = inv_sig * inv_sig;

  float acc[S][2][8];
  float xh[S], xl[S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    xh[i] = s.px[min(j0 + i, n - 1)] - 0.5f;
    xl[i] = s.pxl[min(j0 + i, n - 1)];
#pragma unroll
    for (int o = 0; o < 2; ++o)
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[i][o][r] = 0.0f;
  }
  const bool work = lo < t.th && j0 < n;
  if (work) {
    const float* a = s.fld + wbeg * T + lo;
    const float* g = s.gx + j0 * G::kGx + wbeg;
    float wf = static_cast<float>(t.c0 + wbeg);
#pragma unroll 1
    for (int w = wbeg; w < wend; ++w) {
      const float4 a0 = ld4(a), a1 = ld4(a + T / 2);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const float gx = g[i * G::kGx];
        const float gxz = gx * (((wf - xh[i]) - xl[i]) * inv_sig2);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          acc[i][0][r] = fmaf(av[r], gx, acc[i][0][r]);
          acc[i][1][r] = fmaf(av[r], gxz, acc[i][1][r]);
        }
      }
      a += T;
      ++g;
      wf += 1.0f;
    }
  }
  float sums[S][3];
#pragma unroll
  for (int i = 0; i < S; ++i) {
#pragma unroll
    for (int q = 0; q < 3; ++q) sums[i][q] = 0.0f;
    if (work) {
      const int j = min(j0 + i, n - 1);
      const float4 g0 = ld4(s.gyw + j * T + lo), g1 = ld4(s.gyw + j * T + lo + T / 2);
      const float gyv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float yh = s.py[j] - 0.5f, yl = s.pyl[j];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float dy = (static_cast<float>(t.r0 + lo + r + (r < 4 ? 0 : T / 2 - 4)) - yh) - yl;
        sums[i][0] = fmaf(gyv[r], acc[i][0][r], sums[i][0]);
        sums[i][1] = fmaf(gyv[r], acc[i][1][r], sums[i][1]);
        sums[i][2] = fmaf(gyv[r] * (dy * inv_sig2), acc[i][0][r], sums[i][2]);
      }
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) sums[i][q] = lane_sum<G::kRg>(sums[i][q]);
  }
  if (half == 1 && rg == 0) {
#pragma unroll
    for (int i = 0; i < S; ++i)
#pragma unroll
      for (int q = 0; q < 3; ++q) s.part[q * kBlock + S * sg + i] = sums[i][q];
  }
  __syncthreads();
  if (half == 0 && rg == 0) {
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int j = j0 + i;
      if (j < n) {
        const int k = s.live[j];
#pragma unroll
        for (int q = 0; q < 3; ++q) dl[3 * k + q] += sums[i][q] + s.part[q * kBlock + S * sg + i];
      }
    }
  }
  __syncthreads();
}

// The loaded chunk's n stars on tile t, in passes as contract<128>.  Ends
// synchronised.
__device__ void contract(const Params& P, const Smem& s, const Geom& t, int n, float* dl) {
  constexpr int kG = G::kGroups;
  for (int sb = 0; sb < n;) {
    const int S = min(4, (n - sb + kG - 1) / kG);
    if (S == 1) contract_block<1>(P, s, t, n, sb, dl);
    else if (S == 2) contract_block<2>(P, s, t, n, sb, dl);
    else if (S == 3) contract_block<3>(P, s, t, n, sb, dl);
    else contract_block<4>(P, s, t, n, sb, dl);
    sb += kG * S;
  }
}

// chain_rule<128> on the state in device memory: grad holds the sums on
// entry and the gradient on exit; with `with_u`, U = -(ll + log prior)
// into s.scal[0] (ll the thread's share).  Ends synchronised.
__device__ void chain_rule(const Params& P, const Smem& s, const float* theta,
                           const float* mask, float* grad, bool with_u, double ll) {
  const int tid = threadIdx.x;
  double lp = 0.0;
  for (int k = tid; k < P.K; k += kThreads) {
    const float ux = theta[3 * k], uy = theta[3 * k + 1], sl = theta[3 * k + 2];
    const float m = mask[k];
    const float d_s = grad[3 * k], d_x = grad[3 * k + 1], d_y = grad[3 * k + 2];
    const float sx = sigmoidf(ux), sy = sigmoidf(uy);
    const float gl_ux = d_x * P.W * sx * (1.0f - sx);
    const float gl_uy = d_y * P.H * sy * (1.0f - sy);
    const float zf = (sl - P.logf_mean) / P.logf_sigma;
    grad[3 * k] = -(gl_ux * m + (1.0f - 2.0f * sx) * m);
    grad[3 * k + 1] = -(gl_uy * m + (1.0f - 2.0f * sy) * m);
    grad[3 * k + 2] = -(d_s * m + (-zf / P.logf_sigma) * m);
    if (with_u) {
      const float lp_pos = -(softplusf(ux) + softplusf(-ux) + softplusf(uy) + softplusf(-uy));
      const float lp_flux = -0.5f * zf * zf + P.lp_flux_const;
      lp += static_cast<double>((lp_pos + lp_flux) * m);
    }
  }
  if (with_u) {
    ll = block_sum_d<T>(ll, s.red);  // synchronises
    lp = block_sum_d<T>(lp, s.red);
    if (tid == 0) s.scal[0] = static_cast<float>(-(ll + lp));
  }
  __syncthreads();
}

// dU/dtheta at theta into grad and, when with_u, U into s.scal[0], tile by
// tile and chunk by chunk.  Every thread of the block calls it.
__device__ void grad_eval(const Params& P, const Smem& s, const float* theta, const float* mask,
                          float* grad, bool with_u) {
  const int d3 = 3 * P.K;
  for (int a = threadIdx.x; a < d3; a += kThreads) grad[a] = 0.0f;  // the sums
  const bool one_chunk = P.K <= kChunk;
  const int n_tiles = tiles_across(P.H) * tiles_across(P.W);
  const Px q = px_of();
  double ll = 0.0;
  for (int i = 0; i < n_tiles; ++i) {
    const Geom t = tile_geom(P.H, P.W, i);
    float acc[4][8];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[c][r] = P.background;
    int n = 0;
    for (int kb = 0; kb < P.K; kb += kChunk) {
      n = load_chunk(P, s, theta, mask, kb, t);
      render_acc(acc, s, t, q, n);
    }
    render_out(P, s, t, q, acc, with_u, ll);
    for (int kb = 0; kb < P.K; kb += kChunk) {
      if (!one_chunk) n = load_chunk(P, s, theta, mask, kb, t);
      contract(P, s, t, n, grad);
    }
  }
  chain_rule(P, s, theta, mask, grad, with_u, ll);
}

// One chain a block of 512 threads; the step loop of
// fused_leapfrog_crowded_kernel on the state in device memory.
__global__ void __launch_bounds__(kThreads, 1) fused_leapfrog_crowded_wide_kernel(Params P) {
  extern __shared__ float4 smem4[];
  const int c = blockIdx.x, tid = threadIdx.x;
  const int d3 = 3 * P.K;
  const size_t base = static_cast<size_t>(c) * d3;
  const Smem s = carve(reinterpret_cast<float*>(smem4));
  float* theta = P.theta_out + base;
  float* p = P.p_out + base;
  float* grad = P.grad_out + base;
  const float* mask = P.mask + static_cast<size_t>(c) * P.mask_stride;
  const float eps = P.eps[c];
  const int n = max(*P.n_steps, 0);
  const bool grad_in = P.grad_in != nullptr && n > 0;

  for (int a = tid; a < d3; a += kThreads) {
    theta[a] = P.theta[base + a];
    p[a] = P.p[base + a];
    if (grad_in) grad[a] = P.grad_in[base + a];
  }
  __syncthreads();
  if (!grad_in) grad_eval(P, s, theta, mask, grad, n == 0);
  for (int step = 0; step < n; ++step) {
    for (int a = tid; a < d3; a += kThreads) {
      const float p_half = p[a] - 0.5f * eps * grad[a];
      p[a] = p_half;
      theta[a] = theta[a] + eps * P.inv_mass[a] * p_half;
    }
    __syncthreads();
    grad_eval(P, s, theta, mask, grad, step == n - 1);
    for (int a = tid; a < d3; a += kThreads) p[a] = p[a] - 0.5f * eps * grad[a];
  }
  if (tid == 0) P.u_out[c] = s.scal[0];
}

// The launch of C chains (or, with blocks_per_sm, its occupancy).
cudaError_t run(const Params& P, int C, cudaStream_t st, int* blocks_per_sm) {
  const size_t smem = static_cast<size_t>(smem_floats()) * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(fused_leapfrog_crowded_wide_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  if (blocks_per_sm != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, fused_leapfrog_crowded_wide_kernel, kThreads, smem);
  fused_leapfrog_crowded_wide_kernel<<<C, kThreads, smem, st>>>(P);
  return cudaGetLastError();
}

}  // namespace wide

// The one-tile path's domain (mirrored by one_tile() in
// fused_leapfrog_crowded.py); every other launch takes the wide path.
inline bool one_tile(int K, int H, int W) {
  return K <= kMaxStars && H <= kMaxSide && W <= kMaxSide;
}

// The launch (or its occupancy) at the scene's tile; the threads a block.
cudaError_t dispatch(const Params& P, int C, cudaStream_t st, int* threads, int* blocks_per_sm) {
  if (!one_tile(P.K, P.H, P.W)) {
    *threads = wide::kThreads;
    return wide::run(P, C, st, blocks_per_sm);
  }
  switch (tile_side(P.H, P.W)) {
    case 32:
      *threads = Tile<32>::kThreads;
      return run<32>(P, C, st, blocks_per_sm);
    case 64:
      *threads = Tile<64>::kThreads;
      return run<64>(P, C, st, blocks_per_sm);
    default:
      *threads = Tile<128>::kThreads;
      return run<128>(P, C, st, blocks_per_sm);
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 on success).
int starcat_fused_leapfrog_crowded(
    const void* theta, const void* p, const void* grad_in, const void* eps,
    const void* inv_mass, const void* mask, int mask_stride, const void* image,
    const void* n_steps, void* theta_out, void* p_out, void* u_out, void* grad_out,
    int C, int K, int H, int W, float psf_sigma, float psf_norm, float background,
    float logf_mean, float logf_sigma, float lp_flux_const, void* stream) {
  Params P;
  P.theta = static_cast<const float*>(theta);
  P.p = static_cast<const float*>(p);
  P.grad_in = static_cast<const float*>(grad_in);
  P.eps = static_cast<const float*>(eps);
  P.inv_mass = static_cast<const float*>(inv_mass);
  P.mask = static_cast<const float*>(mask);
  P.mask_stride = mask_stride;
  P.image = static_cast<const float*>(image);
  P.n_steps = static_cast<const int*>(n_steps);
  P.theta_out = static_cast<float*>(theta_out);
  P.p_out = static_cast<float*>(p_out);
  P.u_out = static_cast<float*>(u_out);
  P.grad_out = static_cast<float*>(grad_out);
  P.K = K;
  P.H = H;
  P.W = W;
  P.psf_sigma = psf_sigma;
  P.psf_norm = psf_norm;
  P.background = background;
  P.logf_mean = logf_mean;
  P.logf_sigma = logf_sigma;
  P.lp_flux_const = lp_flux_const;

  if (K < 1 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  int threads = 0;
  return static_cast<int>(dispatch(P, C, static_cast<cudaStream_t>(stream), &threads, nullptr));
}

// The layout a launch of C chains takes: threads per block, the blocks an SM
// holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the SMs the grid
// fills.  Returns a CUDA error code (0 on success).
int starcat_fused_leapfrog_crowded_layout(int C, int K, int H, int W, int* threads,
                                          int* blocks_per_sm, int* sms_filled) {
  Params P{};
  P.K = K;
  P.H = H;
  P.W = W;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = dispatch(P, C, nullptr, threads, blocks_per_sm);
  if (e != cudaSuccess) return static_cast<int>(e);
  *sms_filled = C < sms ? C : sms;
  return 0;
}

const char* starcat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
