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
// What bounds it on this card.  The pixel work is small (K <= 16, H W <=
// 48^2: a few MFLOP per sweep; chip_smoke.py's bound is 4.85 ms for 4096
// chains of cfg3), so a chain is bound by latency: its serial dense algebra
// (D = 3K <= 48), the barriers between passes and shared-memory loads.
// scripts/b6_pass_clocks.py splits its cycles by pass.  The design:
//   * the Cholesky runs in panels of kPanel columns: warp 0 factors a panel
//     column by column in dot-product form (lanes over rows; the odd row
//     stride of the matrices keeps a column's entries in distinct banks),
//     then all warps apply it to the trailing matrix, so a factorisation
//     takes two block barriers a panel, not two a column.  In a position
//     sweep the momentum rides along as one more row, so the factorisation
//     is also the forward solve; the back solve runs in warp 0 with
//     shuffles.  L^-1 is solved one column per warp, all warps at once;
//     G^-1 = L^-T L^-1 by all threads;
//   * the pair contractions (the position sweep's Fisher pairs, a
//     rebuild's 18 profile pairs of both orders) give each unordered star
//     pair its own lanes, each a register tile of the pair's row products
//     against 1/lam on 4 columns, the profiles at an odd star stride so
//     that lanes of different pairs load a row in one wavefront;
//   * the q field by tiles of kQTile stars, two pixels a thread: no thread
//     holds more than one tile's Jacobian values;
//   * no runtime integer division in a per-pixel or per-entry loop: field
//     passes run rows over warps and columns over lanes, parameter loops
//     split a = t K + i by comparison; shared arrays are named by offsets
//     into one extern array (SPtr), so loads compile to LDS;
//   * at most 128 registers a thread, so that two 256-thread blocks (two
//     chains) share an SM and hide each other's latency;
//   * at most one chain an SM (cfg1's 64 chains on 132 SMs) gets 512
//     threads a chain instead: such a launch cannot fill the card two
//     blocks to an SM, so each chain takes more warps (threads_for).
//
// Layout: the chain's image, 1/lam and one working field (rho, then q, then
// phi), the six profile sets gx, gx', gx'', gy, gy', gy'' at the odd star
// strides wp = W | 1 and hp = H | 1, the raw pair contractions Sraw (18
// K^2: the six distinct Hessian profiles of star i against the three
// Jacobian profiles of star j, from which both F and S are assembled), G / L
// (D + 1 rows, the last the right-hand side of a solve), L^-1 and G^-1, each
// with the odd row stride ld = (D + 1) | 1, G^-1 again by 3x3 star blocks
// padded to 12 floats, and the small state stay in shared memory: 4 (30 K^2
// + 58 K + 3 H W + 3 K (hp + wp) + 8 + (3 D + 1) ld) bytes, 87.8 KB at 32x32
// with K = 16 (two chains an SM) and 109.3 KB at 48x48.  Device memory sees
// theta, xi and the outputs once.

// Accuracy: no fast math (expf, logf, IEEE division and square root).  The
// log-likelihood, log det G and the energies sum in double.  A non-positive
// pivot gives NaN (sqrtf of a negative number), which propagates to the
// residual, a NaN-propagating max, so the head rejects the chain as a solver
// failure.  A dead slot (m = 0) gets flux 0 by selection, so its Jacobian
// rows are exact zeros, G has an exact identity row there, its momentum is
// zero and its theta comes back bit for bit.  Every sum runs in a fixed
// order within a layout, so two runs on the same inputs give the same bits,
// and a chain gives the same bits alone or among others of one layout; the
// order depends on the block's thread count, so a chain's last bits differ
// between a launch of at most one chain an SM and one of more (within the
// kernel's tolerance against its plain version, tests/test_torch_cuda.py).
//
// Domain (checked by the wrapper): H*W <= 48*48, 1 <= K <= 16, and the
// block's shared memory (smem_floats) within the card's 227 KB.
#include <cuda_runtime.h>

// the block's dynamic shared memory, which Smem carves up
extern __shared__ __align__(16) float b6_smem[];

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kPanel = 8;  // columns of a Cholesky panel

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

// An array in the block's shared memory, by its offset: indexing it names
// b6_smem, so the compiler addresses it as shared memory (LDS/STS), not
// through a generic pointer.
struct SPtr {
  int off;
  __device__ __forceinline__ float& operator[](int i) const { return b6_smem[off + i]; }
  __device__ __forceinline__ SPtr operator+(int d) const { return SPtr{off + d}; }
};

// Per-star scalars, index i; per-parameter vectors, index a = t K + i.
struct Smem {
  SPtr gblk;             // (K, K, 12): G^-1's 3x3 block of stars (i, j), 16-byte aligned
  // stars (K each)
  SPtr su, sv, x, y, w, wcx, wcy, wcx2, wcy2, wcxx, wcyy, wcxcy, m;
  SPtr cu, cv, cs;  // a_a coef_a per star, for the phi field
  SPtr dots;          // (9, K) field contractions per star
  // parameters (D each)
  SPtr th_b, p_b, ph, th, base, vec, t1, infod, a, ldiag, dh;
  SPtr scal;          // U, logdet, h, delta scratch
  // fields (H W each) and profiles
  SPtr img, r1, fld;
  SPtr gx, gx1, gx2;  // (K, wp): star i's columns at i * wp
  SPtr gy, gy1, gy2;  // (K, hp): star i's rows at i * hp
  SPtr sraw;            // (18, K, K): [(hp * 3 + tb) K + i] K + j
  SPtr gmat;            // (D + 1, ld): G, then L below the diagonal; row D a rhs
  SPtr lw, ginv;       // (D, ld) each: L^-1 (lower), G^-1
  int ld, hp, wp;
};

// odd row stride of the matrices: a column's entries fall in distinct banks
__host__ __device__ inline int mat_ld(int D) { return (D + 1) | 1; }

// odd star stride of the profiles: one row (or column) of different stars
// falls in distinct banks, so lanes that hold different star pairs load it
// in one wavefront
__host__ __device__ inline int prof_ld(int n) { return n | 1; }

// mirrored by smem_bytes() in fused_rhmc.py, which checks the domain
__host__ __device__ inline int smem_floats(int K, int H, int W) {
  const int D = 3 * K;
  return 30 * K * K + 58 * K + 3 * H * W + 3 * K * (prof_ld(H) + prof_ld(W)) + 8
         + (3 * D + 1) * mat_ld(D);
}

__device__ inline Smem carve(int K, int H, int W) {
  Smem s;
  int q = 0;
  const int D = 3 * K;
  s.ld = mat_ld(D);
  s.hp = prof_ld(H);
  s.wp = prof_ld(W);
  auto take = [&q](int n) { const SPtr r{q}; q += n; return r; };
  s.gblk = take(12 * K * K);  // first: the base is 16-byte aligned
  s.su = take(K); s.sv = take(K); s.x = take(K); s.y = take(K); s.w = take(K);
  s.wcx = take(K); s.wcy = take(K); s.wcx2 = take(K); s.wcy2 = take(K);
  s.wcxx = take(K); s.wcyy = take(K); s.wcxcy = take(K); s.m = take(K);
  s.cu = take(K); s.cv = take(K); s.cs = take(K);
  s.dots = take(9 * K);
  s.th_b = take(D); s.p_b = take(D); s.ph = take(D); s.th = take(D);
  s.base = take(D); s.vec = take(D); s.t1 = take(D); s.infod = take(D);
  s.a = take(D); s.ldiag = take(D); s.dh = take(D);
  s.scal = take(8);
  s.img = take(H * W); s.r1 = take(H * W); s.fld = take(H * W);
  s.gx = take(K * s.wp); s.gx1 = take(K * s.wp); s.gx2 = take(K * s.wp);
  s.gy = take(K * s.hp); s.gy1 = take(K * s.hp); s.gy2 = take(K * s.hp);
  s.sraw = take(18 * K * K);
  s.gmat = take((D + 1) * s.ld); s.lw = take(D * s.ld); s.ginv = take(D * s.ld);
  return s;
}

__device__ __forceinline__ int nthreads() { return blockDim.x; }
__device__ __forceinline__ int nwarps() { return blockDim.x >> 5; }

// type t of parameter a = t K + i, without a division
__device__ __forceinline__ int type_of(int a, int K) { return (a >= K) + (a >= 2 * K); }

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
  for (int i = 0; i < nwarps(); ++i) tot += red[i];
  __syncthreads();
  return tot;
}

// Per-star coefficients and the six profile sets at theta `th` (D, packed).
// Every thread of the block calls it; it ends synchronised.
__device__ void profiles(const Params& P, const Smem& s, SPtr th) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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
  for (int i = warp; i < K; i += nwarps()) {
    const float xs = s.x[i], ys = s.y[i];
    for (int col = lane; col < W; col += 32) {
      const int n = i * s.wp + col;
      const float z = ((col + 0.5f) - xs) / sig;
      const float g = expf(-0.5f * z * z) * P.psf_norm;
      s.gx[n] = g; s.gx1[n] = g * z / sig; s.gx2[n] = g * (z * z - 1.0f) / sig2;
    }
    for (int row = lane; row < H; row += 32) {
      const int n = i * s.hp + row;
      const float z = ((row + 0.5f) - ys) / sig;
      const float g = expf(-0.5f * z * z) * P.psf_norm;
      s.gy[n] = g; s.gy1[n] = g * z / sig; s.gy2[n] = g * (z * z - 1.0f) / sig2;
    }
  }
  __syncthreads();
}

// lam -> s.r1 = 1/lam.  With `full`, also s.fld = beta (D/lam - 1) and the
// log-likelihood sum_p D log lam - lam (double), returned to every thread.
__device__ double render(const Params& P, const Smem& s, float beta, bool full,
                         double* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = P.K, H = P.H, W = P.W;
  double ll = 0.0;
  for (int h = warp; h < H; h += nwarps()) {
    for (int col = lane; col < W; col += 32) {
      const int pix = h * W + col;
      float lam = P.background;
      for (int i = 0; i < K; ++i) lam = lam + (s.gy[i * s.hp + h] * s.w[i]) * s.gx[i * s.wp + col];
      const float r1 = 1.0f / lam;
      s.r1[pix] = r1;
      if (full) {
        const float d = s.img[pix];
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
  for (int i = warp; i < K; i += nwarps()) {
    const SPtr gy = s.gy + i * s.hp, gy1 = s.gy1 + i * s.hp, gy2 = s.gy2 + i * s.hp;
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
      const int n = i * s.wp + col;
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

// The pair passes give each unordered star pair i <= j to S adjacent lanes
// (S a power of two, at most 8): lane g of the pair takes the 4-column
// chunks g, g + S, ... .  A lane's register tile is its pair's row products
// against 1/lam on its 4 columns, T[m][k] = sum_h P_m(h) R1(h, col_k), with
// P_m(h) = Ya_i(h) Yb_j(h) one of the pair's profile products: a row costs
// the pair's profile loads (one wavefront each: the odd star stride puts the
// stars of different lanes in distinct banks), four loads of 1/lam shared by
// every pair, and 4 FMAs a product.  Each chunk's T then meets the X
// profiles of its columns, and the S lanes of a pair sum by shuffles in a
// fixed order.  S is the widest split that still gives every pair its own
// lanes in one round (cfg1: 55 pairs, 512 threads, S = 8; cfg3: 136 pairs,
// 256 threads, S = 1, no shuffles), so a launch keeps its sums' order.

// log2 of S for n_pairs pairs over n_chunks 4-column chunks
__device__ __forceinline__ int pair_split_log2(int n_pairs, int n_chunks) {
  int ls = 0;
  while (ls < 3 && (2 << ls) <= n_chunks && (n_pairs << (ls + 1)) <= nthreads()) ++ls;
  return ls;
}

// star pair of unordered index u, i <= j, without a division
__device__ __forceinline__ void pair_of(int u, int K, int& i, int& j) {
  i = 0;
  while (u >= K - i) { u -= K - i; ++i; }
  j = i + u;
}

// Pair contractions of a rebuild:
//   Sraw[hp][tb][i][j] = sum_p Hprof_hp,i(p) Jprof_tb,j(p) / lam(p)
// and Sraw[hp][tb][j][i], all 18 (hp, tb) of both orders, for F and S, from
// 8 row products a pair (Ya of i, a in 0..2, with Yb of j, b in 0..1, and a
// in 0..1 with b = 2: T[b][a] is star j's a-profile against star i's
// b-profile).
__device__ void pair_contract(const Params& P, const Smem& s) {
  const int tid = threadIdx.x;
  const int K = P.K, H = P.H, W = P.W, KK = K * K, hp = s.hp, wp = s.wp;
  const int n_pairs = K * (K + 1) / 2, n_chunks = (W + 3) >> 2;
  const int ls = pair_split_log2(n_pairs, n_chunks), S = 1 << ls, g = tid & (S - 1);
  for (int base = 0; base < n_pairs; base += nthreads() >> ls) {
    const int u = base + (tid >> ls);
    int i, j;  // lanes past the last pair repeat it and write nothing
    pair_of(u < n_pairs ? u : n_pairs - 1, K, i, j);
    const SPtr yi0 = s.gy + i * hp, yi1 = s.gy1 + i * hp, yi2 = s.gy2 + i * hp;
    const SPtr yj0 = s.gy + j * hp, yj1 = s.gy1 + j * hp, yj2 = s.gy2 + j * hp;
    float acc[18], acm[18];  // (i, j) and (j, i)
#pragma unroll
    for (int n = 0; n < 18; ++n) acc[n] = acm[n] = 0.f;
    for (int c0 = 0; c0 < n_chunks; c0 += S) {
      const int col0 = (c0 + g) << 2;
      int cc[4];  // columns past W read the last one, and their X profiles are 0
#pragma unroll
      for (int k = 0; k < 4; ++k) cc[k] = col0 + k < W ? col0 + k : W - 1;
      float t[8][4];
#pragma unroll
      for (int n = 0; n < 32; ++n) (&t[0][0])[n] = 0.f;
      for (int h = 0; h < H; ++h) {
        const float a0 = yi0[h], a1 = yi1[h], a2 = yi2[h];
        const float b0 = yj0[h], b1 = yj1[h], b2 = yj2[h];
        const float pr[8] = {a0 * b0, a0 * b1, a1 * b0, a1 * b1,
                             a2 * b0, a2 * b1, a0 * b2, a1 * b2};
        const SPtr rrow = s.r1 + h * W;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float r = rrow[cc[k]];
#pragma unroll
          for (int m = 0; m < 8; ++m) t[m][k] += pr[m] * r;
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool in = col0 + k < W;
        const int ni = i * wp + cc[k], nj = j * wp + cc[k];
        const float xi[3] = {in ? s.gx[ni] : 0.f, in ? s.gx1[ni] : 0.f, in ? s.gx2[ni] : 0.f};
        const float xj[3] = {in ? s.gx[nj] : 0.f, in ? s.gx1[nj] : 0.f, in ? s.gx2[nj] : 0.f};
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
    for (int o = 1; o < S; o <<= 1) {
#pragma unroll
      for (int n = 0; n < 18; ++n) {
        acc[n] += __shfl_xor_sync(0xffffffffu, acc[n], o);
        acm[n] += __shfl_xor_sync(0xffffffffu, acm[n], o);
      }
    }
    if (u < n_pairs && g == 0) {
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
// (hp = hp_of_type(ta) against tb) from 4 row products (Ya of i against Yb
// of j, a, b in 0..1), written to (i, j) and, mirrored, (j, i).
__device__ void fisher_pairs(const Params& P, const Smem& s) {
  const int tid = threadIdx.x;
  const int K = P.K, H = P.H, W = P.W, KK = K * K, hp = s.hp, wp = s.wp;
  const int n_pairs = K * (K + 1) / 2, n_chunks = (W + 3) >> 2;
  const int ls = pair_split_log2(n_pairs, n_chunks), S = 1 << ls, g = tid & (S - 1);
  for (int base = 0; base < n_pairs; base += nthreads() >> ls) {
    const int u = base + (tid >> ls);
    int i, j;
    pair_of(u < n_pairs ? u : n_pairs - 1, K, i, j);
    const SPtr yi0 = s.gy + i * hp, yi1 = s.gy1 + i * hp;
    const SPtr yj0 = s.gy + j * hp, yj1 = s.gy1 + j * hp;
    float acc[9];
#pragma unroll
    for (int n = 0; n < 9; ++n) acc[n] = 0.f;
    for (int c0 = 0; c0 < n_chunks; c0 += S) {
      const int col0 = (c0 + g) << 2;
      int cc[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) cc[k] = col0 + k < W ? col0 + k : W - 1;
      float t[4][4];
#pragma unroll
      for (int n = 0; n < 16; ++n) (&t[0][0])[n] = 0.f;
      for (int h = 0; h < H; ++h) {
        const float a0 = yi0[h], a1 = yi1[h], b0 = yj0[h], b1 = yj1[h];
        const float pr[4] = {a0 * b0, a0 * b1, a1 * b0, a1 * b1};
        const SPtr rrow = s.r1 + h * W;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float r = rrow[cc[k]];
#pragma unroll
          for (int m = 0; m < 4; ++m) t[m][k] += pr[m] * r;
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool in = col0 + k < W;
        const int ni = i * wp + cc[k], nj = j * wp + cc[k];
        const float xi[2] = {in ? s.gx[ni] : 0.f, in ? s.gx1[ni] : 0.f};
        const float xj[2] = {in ? s.gx[nj] : 0.f, in ? s.gx1[nj] : 0.f};
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
    for (int o = 1; o < S; o <<= 1) {
#pragma unroll
      for (int n = 0; n < 9; ++n) acc[n] += __shfl_xor_sync(0xffffffffu, acc[n], o);
    }
    if (u < n_pairs && g == 0) {
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
__device__ __forceinline__ float jcoef(const Smem& s, int t, int i) {
  return t == 0 ? s.wcx[i] : (t == 1 ? s.wcy[i] : s.w[i]);
}

// The lower triangle of G = beta F + diag(info + (1 - m) + jitter) into
// s.gmat from s.sraw (F's nine entries per star pair), info' into s.infod
// when `with_infod`, and `rhs` (D, or offset -1: none) into row D, where the
// factorisation turns it into L^-1 rhs.
__device__ void assemble_metric(const Params& P, const Smem& s, float beta,
                                bool with_infod, SPtr rhs) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = P.K, D = 3 * K, KK = K * K, ld = s.ld;
  for (int ra = warp; ra < D; ra += nwarps()) {
    const int ta = type_of(ra, K), i = ra - ta * K;
    const float ca = jcoef(s, ta, i);
    const SPtr srow = s.sraw + hp_of_type(ta) * 3 * KK + i * K;
    for (int cb = lane; cb <= ra; cb += 32) {
      const int tb = type_of(cb, K), j = cb - tb * K;
      const float f = ca * jcoef(s, tb, j) * srow[tb * KK + j];
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
      s.gmat[ra * ld + cb] = g;
    }
  }
  if (rhs.off >= 0)
    for (int c = tid; c < D; c += nthreads()) s.gmat[D * ld + c] = rhs[c];
  __syncthreads();
}

// Blocked Cholesky of the first D rows of s.gmat, panels of kPanel columns:
// warp 0 factors a panel column by column in dot-product form (lane l keeps
// rows l and l + 32: s_r = G_rj - sum_k L_rk L_jk over the panel's earlier
// columns, the pivot s_jj from its owner by a shuffle), then every warp
// applies the panel to the trailing rows and columns (rows over warps,
// columns over lanes), so a factorisation takes two block barriers a panel
// instead of two a column.  Each entry takes its updates in column order,
// as a right-looking factorisation applies them.  s.gmat's strict lower
// triangle then holds L and s.ldiag its diagonal.  Rows D .. nrows - 1 (a
// right-hand side b in row D) are reduced alongside, which leaves L^-1 b in
// row D.  A non-positive pivot makes NaN that reaches every later column.
// With `logdet`, lane 0 writes log det G to s.scal[1].  Every thread calls
// it; it ends synchronised.
__device__ void cholesky(const Params& P, const Smem& s, int nrows, bool logdet) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = 3 * P.K, ld = s.ld;
  const int r0 = lane, r1 = lane + 32;
  const bool two = nrows > 32;  // warp 0 holds a second row a lane
  const SPtr A = s.gmat;
  const SPtr a0 = A + r0 * ld;
  const SPtr a1 = A + (two ? r1 : r0) * ld;
  for (int p0 = 0; p0 < D; p0 += kPanel) {
    const int p1 = p0 + kPanel < D ? p0 + kPanel : D;
    if (warp == 0) {
      for (int j = p0; j < p1; ++j) {
        const SPtr aj = A + j * ld;
        float s0 = 0.0f, s1 = 0.0f;
        if (r0 >= j && r0 < nrows) {
          s0 = a0[j];
          for (int k = p0; k < j; ++k) s0 -= a0[k] * aj[k];
        }
        if (two && r1 >= j && r1 < nrows) {
          s1 = a1[j];
          for (int k = p0; k < j; ++k) s1 -= a1[k] * aj[k];
        }
        const float sjj = __shfl_sync(0xffffffffu, j < 32 ? s0 : s1, j & 31);
        const float dinv = 1.0f / sqrtf(sjj);
        if (r0 > j && r0 < nrows) a0[j] = s0 * dinv;
        if (two && r1 > j && r1 < nrows) a1[j] = s1 * dinv;
        if (lane == 0) s.ldiag[j] = sjj * dinv;
        __syncwarp();
      }
    }
    __syncthreads();
    if (p1 == D) break;  // nothing trails the last panel
    // the trailing update: A_rc -= sum over the panel of L_rk L_ck, c <= r
    for (int r = p1 + warp; r < nrows; r += nwarps()) {
      const SPtr ar = A + r * ld;
      const int cmax = r < D - 1 ? r : D - 1;
      for (int c = p1 + lane; c <= cmax; c += 32) {
        const SPtr ac = A + c * ld;
        float a = ar[c];
        for (int k = p0; k < p1; ++k) a -= ar[k] * ac[k];
        A[r * ld + c] = a;
      }
    }
    __syncthreads();
  }
  if (logdet && warp == 0) {
    double ld_sum = 0.0;
    for (int j = lane; j < D; j += 32) ld_sum += static_cast<double>(logf(s.ldiag[j]));
    ld_sum = warp_sum_d(ld_sum);
    if (lane == 0) s.scal[1] = static_cast<float>(2.0 * ld_sum);
  }
}

// out = G^-1 b by back substitution, L^T out = L^-1 b, in warp 0 after
// cholesky(nrows = D + 1) left L^-1 b in row D: lane l keeps the running
// right-hand sides of rows l and l + 32; each step takes one unknown from
// its owner by a shuffle.  Ends synchronised.
__device__ void chol_solve(const Params& P, const Smem& s, SPtr out) {
  const int tid = threadIdx.x;
  const int D = 3 * P.K, ld = s.ld;
  if (tid < 32) {
    const int lane = tid, r0 = lane, r1 = lane + 32;
    const SPtr A = s.gmat;
    float acc0 = r0 < D ? A[D * ld + r0] : 0.0f;
    float acc1 = r1 < D ? A[D * ld + r1] : 0.0f;
    for (int k = D - 1; k >= 0; --k) {
      const float rk = __shfl_sync(0xffffffffu, k < 32 ? acc0 : acc1, k & 31);
      const float xk = rk / s.ldiag[k];
      if (lane == (k & 31)) out[k] = xk;
      const SPtr lk = A + k * ld;  // row k of L: L[k][r] for r < k
      if (r0 < k) acc0 -= lk[r0] * xk;
      if (r1 < k) acc1 -= lk[r1] * xk;
    }
  }
  __syncthreads();
}

// L^-1 into s.lw (lower triangle), one column per warp at a time by forward
// substitution on L e_c, then G^-1 = L^-T L^-1 into s.ginv.  Every thread
// calls it; it ends synchronised.
__device__ void inverse(const Params& P, const Smem& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = 3 * P.K, ld = s.ld;
  const int r0 = lane, r1 = lane + 32;
  const SPtr A = s.gmat;
  for (int c = warp; c < D; c += nwarps()) {
    float acc0 = r0 == c ? 1.0f : 0.0f, acc1 = r1 == c ? 1.0f : 0.0f;
    for (int k = c; k < D; ++k) {
      const float rk = __shfl_sync(0xffffffffu, k < 32 ? acc0 : acc1, k & 31);
      const float xk = rk / s.ldiag[k];
      if (lane == (k & 31)) s.lw[k * ld + c] = xk;
      if (r0 > k && r0 < D) acc0 -= A[r0 * ld + k] * xk;
      if (r1 > k && r1 < D) acc1 -= A[r1 * ld + k] * xk;
    }
  }
  __syncthreads();
  const int K = P.K;
  for (int a = warp; a < D; a += nwarps()) {
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

// out = G^-1 p with the carried s.ginv (D threads).  Ends synchronised.
__device__ void ginv_matvec(const Params& P, const Smem& s, SPtr p, SPtr out) {
  const int tid = threadIdx.x;
  const int D = 3 * P.K;
  if (tid < D) {
    const SPtr row = s.ginv + tid * s.ld;
    float acc = 0.0f;
    for (int b = 0; b < D; ++b) acc += row[b] * p[b];
    out[tid] = acc;
  }
  __syncthreads();
}

// q(p) = sum_ab Ginv_ab J_a(p) J_b(p) into s.fld, by star tiles: a thread
// takes two pixels (rows h, h + 1 of one column) and, for each tile of
// kQTile stars i, holds their Jacobian values at both pixels (6 kQTile
// floats), then walks the stars j >= the tile's first, forming J_j from the
// profiles in shared memory, and adds J_i^T Ginv_ij J_j for the tile's i <=
// j, G^-1's 3x3 block in three 16-byte broadcast loads (s.gblk holds the
// blocks i < j doubled, for the symmetric sum).  No thread holds more than
// one tile's Jacobian values.
constexpr int kQTile = 4;

__device__ void q_field(const Params& P, const Smem& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = P.K, H = P.H, W = P.W, hp = s.hp, wp = s.wp;
  for (int h0 = 2 * warp; h0 < H; h0 += 2 * nwarps()) {
    const int h1 = h0 + 1 < H ? h0 + 1 : h0;  // an odd last row is computed twice, written once
    for (int col = lane; col < W; col += 32) {
      float q0 = 0.0f, q1 = 0.0f;
      for (int i0 = 0; i0 < K; i0 += kQTile) {
        float ja[kQTile][3][2];  // J_(t, i0 + ii) at rows h0, h1
#pragma unroll
        for (int ii = 0; ii < kQTile; ++ii) {
          const int i = i0 + ii < K ? i0 + ii : K - 1;  // past the last star: never used
          const float cu = s.wcx[i] * s.gx1[i * wp + col];
          const float cv = s.wcy[i] * s.gx[i * wp + col];
          const float cs = s.w[i] * s.gx[i * wp + col];
          const float y0 = s.gy[i * hp + h0], y1 = s.gy[i * hp + h1];
          ja[ii][0][0] = cu * y0; ja[ii][0][1] = cu * y1;
          ja[ii][1][0] = cv * s.gy1[i * hp + h0]; ja[ii][1][1] = cv * s.gy1[i * hp + h1];
          ja[ii][2][0] = cs * y0; ja[ii][2][1] = cs * y1;
        }
        for (int j = i0; j < K; ++j) {
          const float cu = s.wcx[j] * s.gx1[j * wp + col];
          const float cv = s.wcy[j] * s.gx[j * wp + col];
          const float cs = s.w[j] * s.gx[j * wp + col];
          const float y0 = s.gy[j * hp + h0], y1 = s.gy[j * hp + h1];
          const float jb[3][2] = {{cu * y0, cu * y1},
                                  {cv * s.gy1[j * hp + h0], cv * s.gy1[j * hp + h1]},
                                  {cs * y0, cs * y1}};
#pragma unroll
          for (int ii = 0; ii < kQTile; ++ii) {
            const int i = i0 + ii;
            if (i > j) continue;
            const float4* blk = reinterpret_cast<const float4*>(&s.gblk[(i * K + j) * 12]);
            const float4 b0 = blk[0], b1 = blk[1], b2 = blk[2];
            const float gb[9] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w, b2.x};
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
      s.fld[h0 * W + col] = q0;
      if (h1 != h0) s.fld[h1 * W + col] = q1;
    }
  }
  __syncthreads();
}

// phi(p) = sum_b a_b J_b(p) into s.fld, from the per-star a_b coef_b in
// s.cu, s.cv, s.cs.
__device__ void phi_field(const Params& P, const Smem& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = P.K, H = P.H, W = P.W;
  for (int h = warp; h < H; h += nwarps()) {
    for (int col = lane; col < W; col += 32) {
      float phi = 0.0f;
      for (int i = 0; i < K; ++i) {
        const int nx = i * s.wp + col, ny = i * s.hp + h;
        const float tx = s.cu[i] * s.gx1[nx] + s.cs[i] * s.gx[nx];
        phi = phi + s.gy[ny] * tx;
        phi = phi + s.gy1[ny] * (s.cv[i] * s.gx[nx]);
      }
      s.fld[h * W + col] = phi;
    }
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
  pair_contract(P, s);
  assemble_metric(P, s, beta, true, SPtr{-1});
  cholesky(P, s, D, true);
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
  inverse(P, s);  // synchronises, so t1 and scal[0] are visible
  q_field(P, s);
  contract<kQ>(P, s);
  if (tid < D) {
    const int tc = type_of(tid, K), i = tid - tc * K, ld = s.ld;
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
      const SPtr grow = s.ginv + (ta * K + i) * ld;
      for (int tb = 0; tb < 3; ++tb) {
        const SPtr r0 = s.sraw + (hp0 * 3 + tb) * KK + i * K;
        const SPtr r1 = hp1 >= 0 ? s.sraw + (hp1 * 3 + tb) * KK + i * K : SPtr{-1};
        float acc = 0.0f;
        for (int j = 0; j < K; ++j) {
          float sv = c0 * r0[j];
          if (r1.off >= 0) sv = sv + c1 * r1[j];
          acc += grow[tb * K + j] * (jcoef(s, tb, j) * sv);
        }
        sg += acc;
      }
    }
    const float cq = jcoef(s, tc, i) * s.dots[(tc == 0 ? 0 : (tc == 1 ? 3 : 5)) * K + i];
    s.t1[tid] = s.t1[tid] + beta * sg - 0.5f * beta * cq
                + 0.5f * s.ginv[tid * ld + tid] * s.infod[tid];
  }
  __syncthreads();
}

// dH/dtheta at the structs' theta and momentum p (D) into out: t1 + t2(a).
__device__ void dh_dtheta(const Params& P, const Smem& s, float beta, SPtr p,
                          SPtr out) {
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
    const int tc = type_of(tid, K), i = tid - tc * K;
    const SPtr d = s.dots;
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
__device__ void fisher_solve(const Params& P, const Smem& s, float beta, SPtr th,
                             SPtr p, SPtr out, double* red) {
  const int D = 3 * P.K;
  profiles(P, s, th);
  render(P, s, beta, false, red);
  fisher_pairs(P, s);
  assemble_metric(P, s, beta, false, p);
  cholesky(P, s, D + 1, false);
  chol_solve(P, s, out);
}

// Relative sup-norm Picard delta max|x_new - x_old| / (1 + max|x_new|) over
// the D entries, NaN-propagating; returned to every thread.
__device__ float fp_delta(const Smem& s, int d3, SPtr x_new, SPtr x_old) {
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
__device__ float hamiltonian(const Params& P, const Smem& s, SPtr p) {
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

// NT threads a chain; at most 128 registers a thread either way (two
// 256-thread blocks or one 512-thread block an SM).
template <int NT>
__global__ void __launch_bounds__(NT, kMaxThreads / NT) fused_rhmc_kernel(Params P) {
  __shared__ double red[kMaxWarps];
  const int c = blockIdx.x, tid = threadIdx.x;
  const int K = P.K, H = P.H, W = P.W, D = 3 * K;
  const Smem s = carve(K, H, W);
  const float eps = P.eps[c];
  const float half_eps = 0.5f * eps;
  const float beta = *P.beta;

  for (int n = tid; n < H * W; n += NT) s.img[n] = P.image[n];
  if (tid < K) s.m[tid] = P.mask[c * P.mask_stride + tid];
  if (tid < D) {  // (K, 3) star-major in memory -> packed a = t K + i
    const int t = type_of(tid, K), i = tid - t * K;
    s.th_b[tid] = P.theta[c * D + 3 * i + t];
    s.vec[tid] = P.xi[c * D + 3 * i + t];
  }
  __syncthreads();

  build_structs(P, s, beta, red);
  // p0 = (L xi) m, L the factor of G(theta0) that build_structs left behind
  if (tid < D) {
    const SPtr row = s.gmat + tid * s.ld;
    float acc = s.ldiag[tid] * s.vec[tid];
    for (int k = 0; k < tid; ++k) acc += row[k] * s.vec[k];
    s.p_b[tid] = acc * s.m[tid - type_of(tid, K) * K];
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
    const int t = type_of(tid, K), i = tid - t * K;
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

// The launch's threads per chain, chosen from the chain count and the
// card's SM count: a launch of at most one chain an SM gives each chain 512
// threads (one block an SM); more chains take 256 threads each, two blocks
// an SM, so that up to two chains an SM still run in one wave.  A cluster of
// two CTAs a chain (half the pixel rows each, partial sums exchanged through
// distributed shared memory) put 128 SMs to work on cfg1's 64 chains and
// was slower (PERF.md), so a chain stays on one SM.
int threads_for(int C, int sms) { return C <= sms ? 512 : 256; }

// The current device's SM count into *sms; returns a CUDA error code.
cudaError_t device_sms(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return e;
}

// The kernel for `threads`, with its dynamic shared memory allowed.
template <int NT>
cudaError_t prepare(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fused_rhmc_kernel<NT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int NT>
cudaError_t launch(const Params& P, int C, size_t smem, cudaStream_t st) {
  const cudaError_t e = prepare<NT>(smem);
  if (e != cudaSuccess) return e;
  fused_rhmc_kernel<NT><<<C, NT, smem, st>>>(P);
  return cudaGetLastError();
}

// Blocks an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
template <int NT>
cudaError_t occupancy(size_t smem, int* blocks_per_sm) {
  const cudaError_t e = prepare<NT>(smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fused_rhmc_kernel<NT>,
                                                       NT, smem);
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int sms = 0;
  cudaError_t e = device_sms(&sms);
  if (e == cudaSuccess)
    e = threads_for(C, sms) == 512 ? launch<512>(P, C, smem, st) : launch<256>(P, C, smem, st);
  return static_cast<int>(e);
}

// The layout a launch of C chains takes: threads per block, the blocks an SM
// holds and the SMs the grid fills.  Returns a CUDA error code (0 on
// success).
int starcat_fused_rhmc_layout(int C, int K, int H, int W, int* threads,
                              int* blocks_per_sm, int* sms_filled) {
  const size_t smem = static_cast<size_t>(smem_floats(K, H, W)) * sizeof(float);
  int sms = 0;
  cudaError_t e = device_sms(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nt = threads_for(C, sms);
  e = nt == 512 ? occupancy<512>(smem, blocks_per_sm) : occupancy<256>(smem, blocks_per_sm);
  if (e != cudaSuccess) return static_cast<int>(e);
  *threads = nt;
  *sms_filled = C < sms ? C : sms;
  return 0;
}

const char* starcat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
