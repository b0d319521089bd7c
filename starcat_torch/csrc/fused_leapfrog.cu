// Fused leapfrog trajectory on Hopper (sm_90a) for small scenes: a chain a
// warp, one fused row sweep a gradient evaluation.
//
// Replaces the two Pallas trajectory kernels of starcat/pallas_kernels.py:
//   B1  make_pallas_leapfrog      (_leapfrog_kernel, static step count)
//   B2  make_pallas_leapfrog_dyn  (_leapfrog_kernel_dyn, runtime step count)
// Both share one gradient evaluator (_grad_eval, pallas_kernels.py:81-178);
// here the step count always arrives through a pointer to a device int32, so
// B2's adapted step count is read without a host sync and B1's static L is
// written into that scalar by the Python wrapper.
//
// What one gradient evaluation computes, per chain (theta is (K, 3) with
// (logit x, logit y, log f)), the math of _grad_eval in its H-first order:
//   profiles  gx_k(w), and scaled by the star's flux w_k = f_k m_k the row
//             profiles gyw_k(h) = gy_k(h) w_k and gywz_k(h) = gyw_k(h) z_k(h)
//   render    lam = bg + sum_k gyw_k(h) gx_k(w), r = D / lam - 1
//   loglik    sum D log lam - lam (double), on the final evaluation only
//   contract  rgy_k(w) = sum_h r gyw_k, rdgy_k(w) = sum_h r gywz_k, then the
//             W-length dots against gx_k and gx_k z_x: flux, x and y sums
//   chain rule to the unconstrained coordinates, plus the priors.
//
// What bounds it on this card: work, not bytes.  Per evaluation and chain
// there are 3 K H W FMAs, H W divisions and K (H + W) expf against a state
// of 3K floats that device memory sees only on entry and exit.  At the
// flagship shape (1024 chains, K = 10, 32x32) there are 8 chains an SM, so
// the design removes what is not arithmetic (barriers, shared-memory round
// trips, runtime divisions, loops the compiler cannot unroll) and gives the
// SM enough warps to hide the latency of what is left.
//
// The design:
//   * a warp a chain, or two at the 32-column tile (Tile<>), kChainsPerBlock
//     chains a block: within a warp only __syncwarp; two warps of a chain
//     split the rows and add their sums once an evaluation through shared
//     memory (one 64-thread named barrier); the block's one __syncthreads
//     is after the image is staged;
//   * every star's state in registers: theta, p, grad U and inv_mass of star
//     k in lane k (of each of its chain's warps, which keep the same bits),
//     the leapfrog update, the chain rule and the priors there, on the
//     sigmoids of the profile step;
//   * compile-time tiles: a column tile of 16, 32 or 48 columns (Tile<>: CW
//     columns a lane, the warp's lanes in RS row groups, register tiles of
//     TR rows) and the star count padded to KP = 4, 8, 10, 12 or 16, so
//     every register array, stride and star loop is a constant; a scene wider
//     than 48 columns (H W <= 48^2 makes it shorter than 48 rows) is held
//     transposed;
//   * one fused row sweep an evaluation: a lane keeps gx_k(w) of every star
//     for its columns in registers, and for each tile of TR rows, the row
//     profiles loaded as 16-byte broadcasts from its warp's shared memory,
//     it renders lam, forms r (and, on the final evaluation, the
//     log-likelihood) and accumulates rgy_k and rdgy_k of every star, 2 KP
//     CW registers; no residual field is stored and nothing waits between
//     render and contraction;
//   * one transposing butterfly sums the 3 KP per-lane flux, x and y sums
//     over the warp, leaving star k's in lane k;
//   * the row profiles are held 48 rows at a time (a chunk), so a tall
//     scene needs no more shared memory than a 48-row one; the image is
//     staged once per block for all its chains, in the kernel's frame.
// A chain's result depends on nothing but its own inputs: every sum has a
// fixed order, the same in a launch of one chain or of many, on a rerun too.
//
// Dead slots: w_k = f_k m_k as in the reference, so a dead slot renders
// nothing, its sums and gradient are exactly 0 and, with zero momentum, its
// theta comes back bit for bit.  Lanes past K hold an empty slot (m = 0,
// w = 0); the padded stars' profiles are 0.
//
// Accuracy: build without --use_fast_math; expf, logf and IEEE division
// keep the gradient within the reference's 0.017 max abs of float64.  The
// log-likelihood and the prior sum in double, as in B3-B6.
//
// Domain (checked by the wrapper): H*W <= 48*48 and 1 <= K <= 16; the
// block's shared memory (smem_floats) is at most 42 KB there.
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 48;           // rows whose profiles a chain holds at once
constexpr int kMaxCols = 48;         // wider scenes are held transposed
constexpr int kChainsPerBlock = 4;
constexpr int kExch = 3 * 16 + 2;    // a warp's slot of its chain's exchange: 3 x 16 sums, ll

// The column tile: CW columns a lane, the warp's lanes in RS row groups (32 /
// RS lanes across a row, the groups taking alternate row tiles), so it spans
// CW * 32 / RS >= COLS columns; the sweep's register tile of TR rows; and
// WARPS warps a chain, which split the chunk's row tiles in contiguous runs.
// Two warps a chain win at the 32-column tile (1.21x at the flagship scene
// and the trans-d move), one at 16 (two: 0.96x at cfg0) and at 48 (two:
// 0.87x; at 167 registers a two-warp block of four chains leaves one block
// an SM) (scripts/b1_before_after.py, PERF.md).  Mirrored by column_tile()
// and warps_per_chain() in fused_leapfrog.py.
template <int COLS>
struct Tile;
template <>
struct Tile<16> { static constexpr int kCW = 1, kRS = 2, kTR = 8, kWarps = 1; };
template <>
struct Tile<32> { static constexpr int kCW = 1, kRS = 1, kTR = 8, kWarps = 2; };
template <>
struct Tile<48> { static constexpr int kCW = 2, kRS = 1, kTR = 4, kWarps = 1; };

// What follows from a tile: the threads a block and the rows of row
// profiles a warp holds.
template <int COLS>
struct Launch {
  static constexpr int kThreads = 32 * Tile<COLS>::kWarps * kChainsPerBlock;
  static constexpr int kRowsHeld = kChunk / Tile<COLS>::kWarps;
};

// The butterfly's star slots: a power of two >= KP.
template <int KP>
struct Slots { static constexpr int kN = KP <= 4 ? 4 : (KP <= 8 ? 8 : 16); };

struct Params {
  const float* theta;     // (C, K, 3)
  const float* p;         // (C, K, 3)
  const float* grad_in;   // (C, K, 3) or null: evaluate the entry gradient
  const float* eps;       // (C,)
  const float* inv_mass;  // (K, 3)
  const float* mask;      // (K,) with stride 0, or (C, K) with stride K
  int mask_stride;
  const float* image;     // (H, W)
  const int* n_steps;     // device scalar
  float* theta_out;
  float* p_out;
  float* u_out;           // (C,)
  float* grad_out;
  int K, H, W;
  float psf_sigma, psf_norm, background;
  float logf_mean, logf_sigma, lp_flux_const;
};

// The scene as the kernel holds it: Ht rows of Wt <= kMaxCols columns, the
// staged image's row stride, and whether it is the transposed scene.
struct Frame {
  int Ht, Wt, istr, swap;
};

// The staged image's row stride: >= Wt and 2 mod 4, so that two row groups
// reading rows 8 apart (Tile<16>) hit other banks.  Mirrored in fused_leapfrog.py.
inline int image_stride(int Wt) { return (Wt + 1) / 4 * 4 + 2; }

// The staged image's floats, to a multiple of 4 so that the row profiles
// after it start on a 16-byte boundary.
__host__ __device__ inline int image_floats(const Frame& F) {
  return (F.Ht * F.istr + 3) / 4 * 4;
}

inline Frame frame(int H, int W) {
  Frame F;
  F.swap = W > kMaxCols;
  F.Ht = F.swap ? W : H;
  F.Wt = F.swap ? H : W;
  F.istr = image_stride(F.Wt);
  return F;
}

inline int column_tile(int Wt) { return Wt <= 16 ? 16 : (Wt <= 32 ? 32 : 48); }

inline int star_pad(int K) {
  return K <= 4 ? 4 : (K <= 8 ? 8 : (K <= 10 ? 10 : (K <= 12 ? 12 : 16)));
}

// the warps' row profiles, after the image (mirrored by smem_bytes() in
// fused_leapfrog.py, with the exchange after them)
template <int COLS, int KP>
__host__ __device__ constexpr int profile_floats() {
  return kChainsPerBlock * Tile<COLS>::kWarps * 2 * KP * Launch<COLS>::kRowsHeld;
}

template <int COLS, int KP>
int smem_floats(const Frame& F) {
  constexpr int W = Tile<COLS>::kWarps;
  return image_floats(F) + profile_floats<COLS, KP>()
         + (W > 1 ? kChainsPerBlock * 2 * W * kExch : 0);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ double warp_sum_d(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float softplusf(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// The lanes' flux, x and y sums of SP star slots, summed over the warp and
// transposed: on return lane l holds star (l mod SP)'s in v[q][0].  Round b
// keeps the half of the slots whose bit b is the lane's and trades the other
// half with lane l ^ (1 << b); the rounds past log2 SP add the rest of the
// lanes.  The order is fixed, and the lanes of a star hold the same bits.
template <int SP>
__device__ __forceinline__ void transpose_sum(float (&v)[3][SP], int lane) {
  constexpr int kRounds = SP == 4 ? 2 : (SP == 8 ? 3 : 4);
#pragma unroll
  for (int b = 0; b < kRounds; ++b) {
    const bool hi = (lane >> b) & 1;
#pragma unroll
    for (int i = 0; i < SP / 2; ++i) {
      if (i >= (SP >> (b + 1))) continue;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float keep = hi ? v[q][2 * i + 1] : v[q][2 * i];
        const float send = hi ? v[q][2 * i] : v[q][2 * i + 1];
        v[q][i] = keep + __shfl_xor_sync(kFull, send, 1 << b);
      }
    }
  }
#pragma unroll
  for (int o = SP; o < 32; o <<= 1)
#pragma unroll
    for (int q = 0; q < 3; ++q) v[q][0] += __shfl_xor_sync(kFull, v[q][0], o);
}

// gx of every star at the lane's columns (0 past K and past Wt).
template <int COLS, int KP>
__device__ __forceinline__ void col_profiles(const Params& P, const Frame& F, int lane, float x,
                                             float (&gx)[KP][Tile<COLS>::kCW]) {
  constexpr int CW = Tile<COLS>::kCW, LR = 32 / Tile<COLS>::kRS;
  const float inv_sig = 1.0f / P.psf_sigma;
  const int j = lane % LR;
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const float xk = __shfl_sync(kFull, x, k);
#pragma unroll
    for (int q = 0; q < CW; ++q) {
      const int w = j + q * LR;
      const float z = ((w + 0.5f) - xk) * inv_sig;
      gx[k][q] = (k < P.K && w < F.Wt) ? expf(-0.5f * z * z) * P.psf_norm : 0.0f;
    }
  }
}

// How the chunk's (star, row) pairs of row profiles are dealt to the lanes:
// star fastest, pair idx = lane + 32 i.  Lane l's stars repeat with period
// kP = KP / gcd(32, KP) (1, 5 at KP = 10, 3 at 12), so it takes their rows
// and fluxes once; kU pairs a pass, independent, so that their expf overlap.
template <int KP>
struct RowDeal {
  static constexpr int kP = KP == 12 ? 3 : (KP == 10 ? 5 : 1);
  static constexpr int kU = kP > 1 ? kP : 4;
};

// The row profiles of the chunk of rows from h0 into the warp's gyw and
// gywz, TR nt rows (0 past Ht and for the padded stars); yk and wks are the
// rows and fluxes of the lane's stars (RowDeal).
template <int COLS, int KP>
__device__ __forceinline__ void row_profiles(const Params& P, const Frame& F, float* gyw,
                                             float* gywz, int lane, int h0, int nt,
                                             const float (&yk)[RowDeal<KP>::kP],
                                             const float (&wks)[RowDeal<KP>::kP]) {
  constexpr int kP = RowDeal<KP>::kP, kU = RowDeal<KP>::kU;
  constexpr int kHeld = Launch<COLS>::kRowsHeld;
  const int n = KP * Tile<COLS>::kTR * nt, rows = F.Ht - h0;
  const float inv_sig = 1.0f / P.psf_sigma;
  for (int i0 = 0; 32 * i0 < n; i0 += kU) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int idx = lane + 32 * (i0 + u), k = idx % KP, r = idx / KP;
      const float z = ((h0 + r) + 0.5f - yk[u % kP]) * inv_sig;
      const float e = expf(-0.5f * z * z) * P.psf_norm * wks[u % kP];
      const bool in = r < rows && k < P.K;
      if (idx < n) {
        gyw[k * kHeld + r] = in ? e : 0.0f;
        gywz[k * kHeld + r] = in ? e * z : 0.0f;
      }
    }
  }
  __syncwarp();
}

// The fused sweep of nt tiles of TR rows from h0: for each, lam at
// the lane's columns, r = D / lam - 1 (and, with `with_u`, the
// log-likelihood into ll), and rgy_k += r gyw_k, rdgy_k += r gywz_k for
// every star.  The lane's row group takes every RS-th tile.
template <int COLS, int KP>
__device__ __forceinline__ void sweep_rows(const Params& P, const Frame& F, const float* img,
                                           const float* gyw, const float* gywz, int lane,
                                           int h0, int nt, const float (&gx)[KP][Tile<COLS>::kCW],
                                           float (&rgy)[KP][Tile<COLS>::kCW],
                                           float (&rdgy)[KP][Tile<COLS>::kCW], bool with_u,
                                           double& ll) {
  constexpr int CW = Tile<COLS>::kCW, RS = Tile<COLS>::kRS, LR = 32 / RS;
  constexpr int kTR = Tile<COLS>::kTR, kHeld = Launch<COLS>::kRowsHeld;
  const int half = lane / LR, j = lane % LR;
  for (int t = half; t < nt; t += RS) {
    const int hb = kTR * t;
    float lam[CW][kTR];
#pragma unroll
    for (int q = 0; q < CW; ++q)
#pragma unroll
      for (int r = 0; r < kTR; ++r) lam[q][r] = P.background;
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      float av[kTR];
#pragma unroll
      for (int r = 0; r < kTR; r += 4) {
        const float4 a = ld4(gyw + k * kHeld + hb + r);
        av[r] = a.x; av[r + 1] = a.y; av[r + 2] = a.z; av[r + 3] = a.w;
      }
#pragma unroll
      for (int q = 0; q < CW; ++q)
#pragma unroll
        for (int r = 0; r < kTR; ++r) lam[q][r] = fmaf(av[r], gx[k][q], lam[q][r]);
    }
    float res[CW][kTR];
#pragma unroll
    for (int r = 0; r < kTR; ++r) {
      const int h = h0 + hb + r;
#pragma unroll
      for (int q = 0; q < CW; ++q) {
        const int w = j + q * LR;
        const bool in = h < F.Ht && w < F.Wt;
        const float d = in ? img[h * F.istr + w] : 0.0f;
        const float l = lam[q][r];
        res[q][r] = d / l - 1.0f;
        if (with_u && in) ll += static_cast<double>(d * logf(l) - l);
      }
    }
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      float av[kTR], bv[kTR];
#pragma unroll
      for (int r = 0; r < kTR; r += 4) {
        const float4 a = ld4(gyw + k * kHeld + hb + r);
        const float4 b = ld4(gywz + k * kHeld + hb + r);
        av[r] = a.x; av[r + 1] = a.y; av[r + 2] = a.z; av[r + 3] = a.w;
        bv[r] = b.x; bv[r + 1] = b.y; bv[r + 2] = b.z; bv[r + 3] = b.w;
      }
#pragma unroll
      for (int q = 0; q < CW; ++q) {
        float s = rgy[k][q], sz = rdgy[k][q];
#pragma unroll
        for (int r = 0; r < kTR; ++r) {
          s = fmaf(res[q][r], av[r], s);
          sz = fmaf(res[q][r], bv[r], sz);
        }
        rgy[k][q] = s;
        rdgy[k][q] = sz;
      }
    }
  }
  __syncwarp();
}

// The W-length dots: the lane's share of every star's flux, x and y sums
// (against gx_k and gx_k z_x at its columns), then summed over the warp by
// the transposing butterfly, star k's into lane k's v[q][0].
template <int COLS, int KP>
__device__ __forceinline__ void reduce_sums(const Params& P, int lane, float x,
                                            const float (&gx)[KP][Tile<COLS>::kCW],
                                            const float (&rgy)[KP][Tile<COLS>::kCW],
                                            const float (&rdgy)[KP][Tile<COLS>::kCW],
                                            float (&v)[3][Slots<KP>::kN]) {
  constexpr int CW = Tile<COLS>::kCW, LR = 32 / Tile<COLS>::kRS, SP = Slots<KP>::kN;
  const float inv_sig = 1.0f / P.psf_sigma;
  const int j = lane % LR;
#pragma unroll
  for (int k = 0; k < SP; ++k) {
    float fl = 0.0f, xs = 0.0f, ys = 0.0f;
    if (k < KP) {
      const float xk = __shfl_sync(kFull, x, k);
#pragma unroll
      for (int q = 0; q < CW; ++q) {
        const float zx = ((j + q * LR + 0.5f) - xk) * inv_sig;
        fl = fmaf(gx[k][q], rgy[k][q], fl);
        xs = fmaf(gx[k][q] * zx, rgy[k][q], xs);
        ys = fmaf(gx[k][q], rdgy[k][q], ys);
      }
    }
    v[0][k] = fl;
    v[1][k] = xs;
    v[2][k] = ys;
  }
  transpose_sum<SP>(v, lane);
}

// The chain rule to (u_col, u_row, s) and the priors, lane k for star k,
// on the sigmoids of the profile step, into g; with `with_u`, U = -(ll +
// log prior) summed over the warp in double into u.
template <int KP>
__device__ __forceinline__ void chain_rule(const Params& P, const Frame& F, int lane,
                                           const float (&th)[3], float m, float sx, float sy,
                                           const float (&v)[3][Slots<KP>::kN], bool with_u,
                                           double ll, float (&g)[3], float& u) {
  const float sig = P.psf_sigma;
  const float gl_c = v[1][0] / sig * F.Wt * sx * (1.0f - sx);
  const float gl_r = v[2][0] / sig * F.Ht * sy * (1.0f - sy);
  const float zf = (th[2] - P.logf_mean) / P.logf_sigma;
  g[0] = -(gl_c * m + (1.0f - 2.0f * sx) * m);
  g[1] = -(gl_r * m + (1.0f - 2.0f * sy) * m);
  g[2] = -(v[0][0] * m + (-zf / P.logf_sigma) * m);
  if (with_u) {
    double lp = 0.0;
    if (lane < P.K) {
      const float lp_pos = -(softplusf(th[0]) + softplusf(-th[0]) + softplusf(th[1])
                             + softplusf(-th[1]));
      const float lp_flux = -0.5f * zf * zf + P.lp_flux_const;
      lp = static_cast<double>((lp_pos + lp_flux) * m);
    }
    u = static_cast<float>(-(ll + warp_sum_d(lp)));
  }
}

// The warps of a chain add their sums: each writes its star sums and its
// log-likelihood to its slot of the chain's exchange (double-buffered by
// `par`, so one barrier an evaluation suffices), then every warp adds the
// slots in warp order, so that all hold the same bits.
template <int COLS, int KP>
__device__ __forceinline__ void exchange(float* xch, int lane, int wq, int par, int bar,
                                         float (&v)[3][Slots<KP>::kN], double& ll) {
  constexpr int SP = Slots<KP>::kN, kWarpsPerChain = Tile<COLS>::kWarps;
  float* slot = xch + (par * kWarpsPerChain + wq) * kExch;
  if (lane < SP) {
#pragma unroll
    for (int q = 0; q < 3; ++q) slot[3 * lane + q] = v[q][0];
  }
  if (lane == 0) *reinterpret_cast<double*>(slot + 48) = ll;
  asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(32 * kWarpsPerChain) : "memory");
  const float* base = xch + par * kWarpsPerChain * kExch;
  const int st = lane % SP;
  float a[3] = {0.0f, 0.0f, 0.0f};
  double l = 0.0;
#pragma unroll
  for (int w = 0; w < kWarpsPerChain; ++w) {
#pragma unroll
    for (int q = 0; q < 3; ++q) a[q] += base[w * kExch + 3 * st + q];
    l += *reinterpret_cast<const double*>(base + w * kExch + 48);
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) v[q][0] = a[q];
  ll = l;
}

// dU/dtheta at th (lane k: star k, in the kernel's frame) into g and, with
// `with_u`, U into u on every lane.  img is the block's staged image, gyw and
// gywz the warp's row profiles.  Every lane of the warp calls it.
template <int COLS, int KP>
__device__ __forceinline__ void grad_eval(const Params& P, const Frame& F, const float* img,
                                          float* gyw, float* gywz, float* xch, int lane, int wq,
                                          int par, int bar, const float (&th)[3], float m,
                                          bool with_u, float (&g)[3], float& u) {
  constexpr int CW = Tile<COLS>::kCW, SP = Slots<KP>::kN;
  // the lane's star: its position in the frame and its flux (0 past K)
  const float sx = sigmoidf(th[0]), sy = sigmoidf(th[1]);
  const float x = F.Wt * sx, y = F.Ht * sy;
  const float wk = lane < P.K ? expf(th[2]) * m : 0.0f;
  float gx[KP][CW];
  col_profiles<COLS, KP>(P, F, lane, x, gx);

  float rgy[KP][CW], rdgy[KP][CW];
#pragma unroll
  for (int k = 0; k < KP; ++k)
#pragma unroll
    for (int q = 0; q < CW; ++q) rgy[k][q] = rdgy[k][q] = 0.0f;
  double ll = 0.0;
  constexpr int kP = RowDeal<KP>::kP;
  float yk[kP], wks[kP];
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const int ks = (lane + 32 * i) % KP;
    yk[i] = __shfl_sync(kFull, y, ks);
    wks[i] = __shfl_sync(kFull, wk, ks);
  }
  // the chunk's row tiles split in contiguous runs between the chain's warps
  constexpr int kTR = Tile<COLS>::kTR, kWarps = Tile<COLS>::kWarps;
  for (int h0 = 0; h0 < F.Ht; h0 += kChunk) {
    const int nt = (min(kChunk, F.Ht - h0) + kTR - 1) / kTR;
    const int ntw = (nt + kWarps - 1) / kWarps;
    const int t0 = min(nt, wq * ntw), ntq = min(nt, t0 + ntw) - t0, hw = h0 + kTR * t0;
    row_profiles<COLS, KP>(P, F, gyw, gywz, lane, hw, ntq, yk, wks);
    sweep_rows<COLS, KP>(P, F, img, gyw, gywz, lane, hw, ntq, gx, rgy, rdgy, with_u, ll);
  }

  float v[3][SP];
  reduce_sums<COLS, KP>(P, lane, x, gx, rgy, rdgy, v);
  if (with_u) ll = warp_sum_d(ll);
  if (kWarps > 1) exchange<COLS, KP>(xch, lane, wq, par, bar, v, ll);
  chain_rule<KP>(P, F, lane, th, m, sx, sy, v, with_u, ll, g, u);
}

template <int COLS, int KP>
__global__ void __launch_bounds__(Launch<COLS>::kThreads)
    fused_leapfrog_kernel(Params P, Frame F, int C) {
  constexpr int kWarps = Tile<COLS>::kWarps, kHeld = Launch<COLS>::kRowsHeld;
  extern __shared__ float4 smem4[];
  float* img = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* gyw = img + image_floats(F) + warp * 2 * KP * kHeld;
  float* gywz = gyw + KP * kHeld;
  const int cw = warp / kWarps, wq = warp % kWarps;
  float* xch = img + image_floats(F) + profile_floats<COLS, KP>() + cw * 2 * kWarps * kExch;

  // the image in the kernel's frame, once for the block's chains
  for (int i = threadIdx.x; i < F.Ht * F.Wt; i += Launch<COLS>::kThreads) {
    const int h = i / F.Wt, w = i - h * F.Wt;
    img[h * F.istr + w] = P.image[F.swap ? w * F.Ht + h : i];
  }
  __syncthreads();
  const int c = blockIdx.x * kChainsPerBlock + cw;
  if (c >= C) return;

  // star k's state in lane k, its coordinates in the kernel's frame
  const int K = P.K, ca = F.swap, cb = 1 - F.swap;
  float th[3] = {0.0f, 0.0f, 0.0f}, p[3] = {0.0f, 0.0f, 0.0f}, g[3] = {0.0f, 0.0f, 0.0f};
  float im[3] = {0.0f, 0.0f, 0.0f}, m = 0.0f;
  const float eps = P.eps[c];
  // a device count cannot be checked on the host; a negative one acts as 0
  const int n = max(*P.n_steps, 0);
  const bool grad_in = P.grad_in != nullptr && n > 0;
  const int o = 3 * (c * K + lane);
  if (lane < K) {
    th[0] = P.theta[o + ca]; th[1] = P.theta[o + cb]; th[2] = P.theta[o + 2];
    p[0] = P.p[o + ca];      p[1] = P.p[o + cb];      p[2] = P.p[o + 2];
    im[0] = P.inv_mass[3 * lane + ca];
    im[1] = P.inv_mass[3 * lane + cb];
    im[2] = P.inv_mass[3 * lane + 2];
    if (grad_in) {
      g[0] = P.grad_in[o + ca]; g[1] = P.grad_in[o + cb]; g[2] = P.grad_in[o + 2];
    }
    m = P.mask[c * P.mask_stride + lane];
  }

  // n == 0 returns (U, grad U) at theta; otherwise the entry gradient is
  // taken from grad_in or evaluated here, and only the final of the n
  // evaluations computes the log-likelihood for U.
  // (step -1 is the entry evaluation; one call site keeps the code small)
  float u = 0.0f;
  for (int step = grad_in ? 0 : -1; step < n; ++step) {
    if (step >= 0) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        p[q] = p[q] - 0.5f * eps * g[q];
        th[q] = th[q] + eps * im[q] * p[q];
      }
    }
    const bool last = step == n - 1;
    const int par = step & 1;  // the exchange's buffer
    grad_eval<COLS, KP>(P, F, img, gyw, gywz, xch, lane, wq, par, 1 + cw, th, m, last, g, u);
    if (step >= 0) {
#pragma unroll
      for (int q = 0; q < 3; ++q) p[q] = p[q] - 0.5f * eps * g[q];
    }
  }

  if (wq == 0 && lane < K) {
    P.theta_out[o + ca] = th[0]; P.theta_out[o + cb] = th[1]; P.theta_out[o + 2] = th[2];
    P.p_out[o + ca] = p[0];      P.p_out[o + cb] = p[1];      P.p_out[o + 2] = p[2];
    P.grad_out[o + ca] = g[0];   P.grad_out[o + cb] = g[1];   P.grad_out[o + 2] = g[2];
  }
  if (wq == 0 && lane == 0) P.u_out[c] = u;
}

// The launch of C chains at one tile (or, with blocks_per_sm, its
// occupancy); the threads a block.
template <int COLS, int KP>
cudaError_t run(const Params& P, const Frame& F, int C, cudaStream_t st, int* blocks_per_sm,
                int* threads) {
  constexpr int kThreads = Launch<COLS>::kThreads;
  *threads = kThreads;
  // at most 42 KB over the domain: no opt-in above 48 KB is needed
  const size_t smem = static_cast<size_t>(smem_floats<COLS, KP>(F)) * sizeof(float);
  if (blocks_per_sm != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, fused_leapfrog_kernel<COLS, KP>, kThreads, smem);
  const int blocks = (C + kChainsPerBlock - 1) / kChainsPerBlock;
  fused_leapfrog_kernel<COLS, KP><<<blocks, kThreads, smem, st>>>(P, F, C);
  return cudaGetLastError();
}

template <int COLS>
cudaError_t run_stars(const Params& P, const Frame& F, int C, cudaStream_t st, int* bps,
                      int* threads) {
  switch (star_pad(P.K)) {
    case 4: return run<COLS, 4>(P, F, C, st, bps, threads);
    case 8: return run<COLS, 8>(P, F, C, st, bps, threads);
    case 10: return run<COLS, 10>(P, F, C, st, bps, threads);
    case 12: return run<COLS, 12>(P, F, C, st, bps, threads);
    default: return run<COLS, 16>(P, F, C, st, bps, threads);
  }
}

// The launch (or its occupancy) at the scene's column tile and star count.
cudaError_t dispatch(const Params& P, int C, cudaStream_t st, int* blocks_per_sm,
                     int* threads) {
  const Frame F = frame(P.H, P.W);
  switch (column_tile(F.Wt)) {
    case 16: return run_stars<16>(P, F, C, st, blocks_per_sm, threads);
    case 32: return run_stars<32>(P, F, C, st, blocks_per_sm, threads);
    default: return run_stars<48>(P, F, C, st, blocks_per_sm, threads);
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 on success).
int starcat_fused_leapfrog(
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

  if (K < 1 || K > 16 || H * W > kMaxCols * kMaxCols)
    return static_cast<int>(cudaErrorInvalidValue);
  int threads = 0;
  return static_cast<int>(dispatch(P, C, static_cast<cudaStream_t>(stream), nullptr, &threads));
}

// The layout a launch of C chains takes: threads per block (Tile<>::kWarps
// warps a chain, kChainsPerBlock chains), the blocks an SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the SMs the grid
// fills.  Returns a CUDA error code (0 on success).
int starcat_fused_leapfrog_layout(int C, int K, int H, int W, int* threads,
                                  int* blocks_per_sm, int* sms_filled) {
  Params P{};
  P.K = K;
  P.H = H;
  P.W = W;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = dispatch(P, C, nullptr, blocks_per_sm, threads);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (C + kChainsPerBlock - 1) / kChainsPerBlock;
  *sms_filled = blocks < sms ? blocks : sms;
  return 0;
}

const char* starcat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
