// One trans-dimensional sweep (transdim.transdim_sweep at the tempered
// Poisson likelihood beta log L) on Hopper (sm_90a): one launch a sweep,
// each chain computing only the move it keeps.
//
// Replaces no TPU kernel: the JAX package's sweep (starcat/transdim.py:
// transdim_sweep -> birth_death_step / birth_death_step_residual and
// split_merge_step) is XLA, and so was the port's plain version
// (starcat_torch/transdim.py), which computes, for every chain, birth and
// death and split and merge and then keeps one of the four.  Its contract:
// theta (C, K, 3), mask (C, K), tll (C,) the tempered log-likelihood, beta
// a device scalar, the image (H, W) and the sweep's draws (draw_sweep's
// tensors, read as they are); out theta', mask', tll' (C, K, 3), (C, K),
// (C,) and the move's accepted (bool), log alpha and move type (int64).
//
// A chain's move is chosen by its draws alone: u_sel picks birth/death or
// split/merge, u_move the half.  The kernel follows the plain code's rules
// for everything else: the slot choices are _gumbel_choice's argmax (the
// first index on ties, NaN greatest, as torch.argmax), the merge's second
// slot excludes the first; the proposal, the bounds, clamps, -inf guards
// and prior terms are the plain code's, written in its order of
// operations.  Where a move's guard fails (a birth at n = K, a death at
// n = 0, a split out of bounds, a merge of fewer than two stars or at a
// flux share outside the split's support) its log alpha is -inf and
// nothing is rendered.  Otherwise the chain renders only what that move
// needs: the proposed catalog's lam and its log-likelihood (a prior birth,
// any death, split or merge), with for a residual death the post-death
// residual's log-sum-exp and its log weight at the removed star's pixel;
// for a residual birth the current lam (kept in the workspace), the
// residual field's log-sum-exp, then the Gumbel pick over pixels, then
// the born star added to lam and the log-likelihood.  So a chain renders
// once, where the plain version renders six times (four with prior
// births).  Computing only the kept branch gives the outputs of computing
// all four and selecting.
//
// What bounds it: the render's FMAs (lam = bg + sum_k (gy_k w_k) gx_k over
// the proposed catalog's live stars) and the pixel passes' transcendental
// functions (log lam for the likelihood; for residual moves the log weight
// log(max(D - lam, 0) + floor) and its exponential in the log-sum-exp).
// At cfg4's shape (4096 chains, about 50 live stars on 128 x 128) that is
// about 5e10 operations a sweep against 1.6e5 floats of state.
//
// What the design does about it:
//   * the render is a register-tiled product of the profiles: a thread
//     keeps RT x CT pixels of a region in registers (8 x 8 on a 128 x 128
//     region, 16 x 16 threads a chain; 4 x 4 on a 32 x 32 region, 8 x 8
//     threads), the rows and columns strided by the thread grid so that a
//     warp's profile loads from shared memory are broadcasts or
//     consecutive; one load feeds 4 (or 2) FMAs;
//   * only the live stars of the proposed catalog are depth: warp 0 of a
//     chain lists them per chunk of at most 64 slots in slot order (a
//     ballot), with the move's overrides applied, and the chain computes
//     their profiles over the region's rows and columns into shared
//     memory;
//   * each pixel's transcendental functions run once, in the epilogue of
//     the render, on the lam held in registers; the sums (the
//     log-likelihood, the online log-sum-exp, the pixel argmax) go from
//     registers to a warp's shuffle tree to one value a warp, which one
//     pass adds in warp order, so every run gives the same bits; a
//     thread's own log-likelihood sum over its pixels, up to H W / 64
//     terms, is compensated (Kahan), so that a field of many regions
//     loses no more to rounding than one region does (a plain serial sum
//     of 576 terms a thread at 192 x 192 flipped 0.8% of the acceptances
//     against the plain version, where 128 x 128 flipped none);
//   * the layout follows the field: a field that pads to less area in
//     32 x 32 regions than in 128 x 128 ones runs 64 threads a chain, four
//     chains a block, else 256 threads and one chain a block; the chunk is
//     min(K, 64) slots.  A field larger than a region walks its regions, a
//     catalog larger than a chunk its chunks: nothing raises for size.
//
// Accuracy: float32 throughout, no fast math (expf, logf, IEEE division);
// the products and sums that the plain code writes as separate PyTorch
// operations round separately here (__fmul_rn and friends).  Sums run in
// another order than PyTorch's, so log alpha differs from the plain
// version's by the float32 rounding of two log-likelihood sums.  A dead
// slot contributes nothing by selection.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>

namespace {

constexpr int kMaxChunk = 64;     // slots a chunk of the star list
constexpr int kMaxGroups = 4;     // chains a block
constexpr int kMaxWarps = 8;      // warps a chain
constexpr int kBlock = 256;       // threads a block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kScalars = 20;

enum Kind { kBirth = 0, kDeath = 1, kSplit = 2, kMerge = 3 };
// what a chain's first pass does with each pixel's lam (bits)
constexpr int kLL = 1;      // sum D log lam - lam
constexpr int kLse = 2;     // the residual field's log-sum-exp
constexpr int kStore = 4;   // keep lam in the workspace (a residual birth)

struct Params {
  const float* theta;       // (C, K, 3)
  const float* mask;        // (C, K)
  const float* tll;         // (C,)
  const float* beta;        // device scalar
  const float* image;       // (H, W)
  const float* u_sel;       // (C,)
  const float* bd_u_move;   // (C,)
  const float* bd_g_slot;   // (C, K)
  const float* bd_star;     // prior births: (C, 3)
  const float* bd_g_pix;    // residual births: (C, H W)
  const float* bd_u_sub;    // residual births: (C, 2)
  const float* bd_z;        // residual births: (C,)
  const float* bd_u_acc;    // (C,)
  const float* sm_u_move;   // (C,)
  const float* sm_g_j;      // (C, K)
  const float* sm_g_d;      // (C, K)
  const float* sm_u_u;      // (C,)
  const float* sm_z_delta;  // (C, 2)
  const float* sm_u_acc;    // (C,)
  float* theta_out;
  float* mask_out;
  float* tll_out;
  float* log_alpha_out;
  unsigned char* accepted_out;
  long long* move_out;
  float* work;              // residual births: (C, H, W) lam
  int C, K, H, W, residual;
  // the scalars, in the order the wrapper passes them
  float psf_sigma, psf_norm, background, logf_mean, logf_sigma;
  float log_sigma_c, half_log_2pi;  // the flux prior's log(sigma) and log(2 pi) / 2
  float log_lam, log_area, split_sigma, log_q_norm, p_bd, fmin, resid_floor;
  float u_scale, u_lo, u_hi;        // (1 - 1e-4) - 1e-4, 1e-4, 1 - 1e-4
  float edge, x_hi, y_hi;           // the children's clip: 1e-3, W - 1e-3, H - 1e-3
};

// One chain's move, written by lane 0 of its warp 0, read by its threads.
struct Plan {
  int chain;          // -1 for a group past the last chain
  int kind, valid, role, n_over, accept;
  int slot[2], has_th[2], has_m[2];
  float th[2][3], m[2];
  int pixj;           // a residual death: the removed star's pixel
  float n;
  float extra[3];     // the split's or merge's terms besides the likelihood
  float ll, lse, logw_j, logq_pix;
};

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float logit(float p) { return logf(p / (1.0f - p)); }

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ bool is_nan(float v) { return v != v; }

// torch.argmax's order: NaN above everything, then the larger value, then
// the lower index
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  const bool an = is_nan(av), bn = is_nan(bv);
  if (an || bn) return (an && bn) ? ai < bi : an;
  if (av != bv) return av > bv;
  return ai < bi;
}

// log p(f) of the log-normal flux prior in constrained coordinates
// (transdim._log_flux_prior_constrained)
__device__ float log_flux_prior(const Params& P, float f) {
  const float s = logf(f);
  const float z = (s - P.logf_mean) / P.logf_sigma;
  return __fsub_rn(__fsub_rn(__fsub_rn(__fmul_rn(__fmul_rn(-0.5f, z), z), P.log_sigma_c),
                             P.half_log_2pi), s);
}

__device__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// the max that keeps NaN, symmetric in its arguments' values
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || is_nan(a)) ? a : b;
}

// (m, s) with s = sum exp(v - m) over what was pushed
__device__ __forceinline__ void lse_push(float& m, float& s, float v) {
  if (v > m) {
    s = s * expf(m - v) + 1.0f;
    m = v;
  } else {
    s += expf(v - m);
  }
}

__device__ __forceinline__ void lse_merge(float& m, float& s, float om, float os) {
  const float mm = nan_max(m, om);
  const float a = (m == -INFINITY) ? 0.0f : s * expf(m - mm);
  const float b = (om == -INFINITY) ? 0.0f : os * expf(om - mm);
  m = mm;
  s = a + b;
}

// the uniform choice among the slots with (alive ? m > 0 : m <= 0), but
// `exclude`, from the Gumbel row g: _gumbel_choice by the 32 lanes of a warp
__device__ int warp_choice(const float* g, const float* m, int K, bool alive, int exclude,
                           int wl) {
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int k = wl; k < K; k += 32) {
    const float w = alive ? m[k] : 1.0f - m[k];
    const float v = (w > 0.0f && k != exclude) ? g[k] : -INFINITY;
    if (better(v, k, bv, bi)) {
      bv = v;
      bi = k;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, bv, off);
    const int oi = __shfl_xor_sync(kFull, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  return bi;
}

// theta's constrained x, y and clamped flux of slot k
__device__ void star_of(const Params& P, const float* th, int k, float& x, float& y, float& f) {
  x = static_cast<float>(P.W) * sigmoid(th[3 * k]);
  y = static_cast<float>(P.H) * sigmoid(th[3 * k + 1]);
  f = fmaxf(expf(th[3 * k + 2]), P.fmin);
}

__device__ void unconstrain(const Params& P, float x, float y, float f, float* out) {
  out[0] = logit(x / static_cast<float>(P.W));
  out[1] = logit(y / static_cast<float>(P.H));
  out[2] = logf(f);
}

// A chain's move from its draws: warp 0 of the chain, all 32 lanes.
__device__ void plan_move(const Params& P, Plan& pl, int c, int wl) {
  if (c < 0) {
    if (wl == 0) {
      pl.chain = -1;
      pl.valid = pl.role = pl.n_over = pl.accept = 0;
      pl.kind = kBirth;
    }
    return;
  }
  const int K = P.K;
  const size_t row = static_cast<size_t>(c) * K;
  const float* m = P.mask + row;
  float ns = 0.0f;
  for (int k = wl; k < K; k += 32) ns += m[k];
  const float n = warp_sum(ns);  // a count: exact in any order
  const bool bd = P.u_sel[c] < P.p_bd;
  const bool first = (bd ? P.bd_u_move[c] : P.sm_u_move[c]) < 0.5f;
  int s1, s2 = -1;
  if (bd) {
    s1 = warp_choice(P.bd_g_slot + row, m, K, !first, -1, wl);
  } else {
    s1 = warp_choice(P.sm_g_j + row, m, K, true, -1, wl);
    s2 = warp_choice(P.sm_g_d + row, m, K, !first, first ? -1 : s1, wl);
  }
  if (wl != 0) return;

  const float* th = P.theta + row * 3;
  const float kf = static_cast<float>(K);
  const float Wf = static_cast<float>(P.W), Hf = static_cast<float>(P.H);
  pl.chain = c;
  pl.n = n;
  pl.n_over = 0;
  pl.pixj = -1;
  pl.accept = 0;
  pl.kind = bd ? (first ? kBirth : kDeath) : (first ? kSplit : kMerge);
  pl.slot[0] = s1;
  pl.slot[1] = s2;
  int role = kLL;
  if (pl.kind == kBirth) {
    pl.valid = n < kf;
    pl.has_th[0] = pl.has_m[0] = 1;
    pl.m[0] = 1.0f;
    if (P.residual) {
      role = kLse | kStore;  // the star comes from the pixel pick
    } else {
      for (int i = 0; i < 3; ++i) pl.th[0][i] = P.bd_star[static_cast<size_t>(c) * 3 + i];
      pl.n_over = 1;
    }
  } else if (pl.kind == kDeath) {
    pl.valid = n > 0.0f;
    pl.has_th[0] = 0;
    pl.has_m[0] = 1;
    pl.m[0] = 0.0f;
    pl.n_over = 1;
    if (P.residual) {
      role = kLL | kLse;
      const float xj = Wf * sigmoid(th[3 * s1]), yj = Hf * sigmoid(th[3 * s1 + 1]);
      const int px = static_cast<int>(clampf(floorf(xj), 0.0f, Wf - 1.0f));
      const int py = static_cast<int>(clampf(floorf(yj), 0.0f, Hf - 1.0f));
      pl.pixj = py * P.W + px;
    }
  } else {
    const float sig = P.split_sigma;
    float xa, ya, fa, xb, yb, fb;
    star_of(P, th, s1, xa, ya, fa);
    if (pl.kind == kSplit) {
      const float u = __fadd_rn(__fmul_rn(P.sm_u_u[c], P.u_scale), P.u_lo);
      const float d0 = __fmul_rn(sig, P.sm_z_delta[2 * static_cast<size_t>(c)]);
      const float d1 = __fmul_rn(sig, P.sm_z_delta[2 * static_cast<size_t>(c) + 1]);
      const float omu = 1.0f - u;
      const float x1 = __fadd_rn(xa, __fmul_rn(omu, d0)), y1 = __fadd_rn(ya, __fmul_rn(omu, d1));
      const float x2 = __fsub_rn(xa, __fmul_rn(u, d0)), y2 = __fsub_rn(ya, __fmul_rn(u, d1));
      const float f1 = __fmul_rn(u, fa), f2 = __fmul_rn(omu, fa);
      const bool in_bounds = x1 > 0.0f && x1 < Wf && x2 > 0.0f && x2 < Wf && y1 > 0.0f &&
                             y1 < Hf && y2 > 0.0f && y2 < Hf && f1 > P.fmin && f2 > P.fmin;
      pl.valid = n >= 1.0f && n < kf && in_bounds;
      unconstrain(P, clampf(x1, P.edge, P.x_hi), clampf(y1, P.edge, P.y_hi),
                  fmaxf(f1, P.fmin), pl.th[0]);
      unconstrain(P, clampf(x2, P.edge, P.x_hi), clampf(y2, P.edge, P.y_hi),
                  fmaxf(f2, P.fmin), pl.th[1]);
      pl.has_th[0] = pl.has_th[1] = 1;
      pl.has_m[0] = 0;
      pl.has_m[1] = 1;
      pl.m[1] = 1.0f;
      const float q0 = d0 / sig, q1 = d1 / sig;
      pl.extra[0] = __fsub_rn(__fadd_rn(__fadd_rn(-P.log_area, log_flux_prior(P, f1)),
                                        log_flux_prior(P, f2)),
                              log_flux_prior(P, fa));
      pl.extra[1] = logf(fa);
      pl.extra[2] = __fsub_rn(P.log_q_norm,
                              __fmul_rn(0.5f, __fadd_rn(__fmul_rn(q0, q0), __fmul_rn(q1, q1))));
    } else {
      star_of(P, th, s2, xb, yb, fb);
      const float fm = __fadd_rn(fa, fb);
      const float xm = __fadd_rn(__fmul_rn(fa, xa), __fmul_rn(fb, xb)) / fm;
      const float ym = __fadd_rn(__fmul_rn(fa, ya), __fmul_rn(fb, yb)) / fm;
      const float um = fa / fm;
      const float d0 = __fsub_rn(xa, xb), d1 = __fsub_rn(ya, yb);
      pl.valid = n >= 2.0f && um > P.u_lo && um < P.u_hi;
      unconstrain(P, clampf(xm, P.edge, P.x_hi), clampf(ym, P.edge, P.y_hi),
                  fmaxf(fm, P.fmin), pl.th[0]);
      pl.has_th[0] = 1;
      pl.has_m[0] = 0;
      pl.has_th[1] = 0;
      pl.has_m[1] = 1;
      pl.m[1] = 0.0f;
      const float q0 = d0 / sig, q1 = d1 / sig;
      pl.extra[0] = __fsub_rn(__fsub_rn(__fadd_rn(P.log_area, log_flux_prior(P, fm)),
                                        log_flux_prior(P, fa)),
                              log_flux_prior(P, fb));
      pl.extra[1] = logf(fmaxf(fm, P.fmin));
      pl.extra[2] = __fsub_rn(P.log_q_norm,
                              __fmul_rn(0.5f, __fadd_rn(__fmul_rn(q0, q0), __fmul_rn(q1, q1))));
    }
    pl.n_over = 2;
  }
  pl.role = pl.valid ? role : 0;
}

// The live stars of the proposed catalog among slots [k0, k1), in slot
// order, as (x, y, flux x mask): warp 0 of the chain, all 32 lanes.
__device__ void list_stars(const Params& P, const Plan& pl, int k0, int k1, float* ent,
                           int* count, int wl) {
  int cnt = 0;
  const bool on = pl.role != 0;
  const size_t row = static_cast<size_t>(pl.chain) * P.K;
  for (int base = k0; base < k1; base += 32) {
    const int k = base + wl;
    bool alive = false;
    float x = 0.0f, y = 0.0f, w = 0.0f;
    if (on && k < k1) {
      const float* t = P.theta + (row + k) * 3;
      float u0 = t[0], u1 = t[1], s = t[2], m = P.mask[row + k];
      for (int o = 0; o < pl.n_over; ++o) {
        if (pl.slot[o] != k) continue;
        if (pl.has_th[o]) {
          u0 = pl.th[o][0];
          u1 = pl.th[o][1];
          s = pl.th[o][2];
        }
        if (pl.has_m[o]) m = pl.m[o];
      }
      alive = m != 0.0f;
      x = static_cast<float>(P.W) * sigmoid(u0);
      y = static_cast<float>(P.H) * sigmoid(u1);
      w = __fmul_rn(expf(s), m);
    }
    const unsigned b = __ballot_sync(kFull, alive);
    if (alive) {
      const int pos = cnt + __popc(b & ((1u << wl) - 1u));
      ent[3 * pos] = x;
      ent[3 * pos + 1] = y;
      ent[3 * pos + 2] = w;
    }
    cnt += __popc(b);
  }
  if (wl == 0) *count = cnt;
}

// the normalised 1-D Gaussian profile at pixel centre `coord`
__device__ __forceinline__ float profile(const Params& P, float coord, float centre) {
  const float z = (coord - centre) / P.psf_sigma;
  return __fmul_rn(expf(__fmul_rn(__fmul_rn(-0.5f, z), z)), P.psf_norm);
}

// log(max(D - lam, 0) + floor): a pixel's residual log weight
__device__ __forceinline__ float log_weight(const Params& P, float d, float lam) {
  return logf(__fadd_rn(fmaxf(__fsub_rn(d, lam), 0.0f), P.resid_floor));
}

// D log lam - lam
__device__ __forceinline__ float ll_term(float d, float lam) {
  return __fsub_rn(__fmul_rn(d, logf(lam)), lam);
}

// s += v, compensated (Kahan): a thread adds up to H W / 64 pixels' terms,
// and its sum keeps the accuracy of a few additions at any field size
__device__ __forceinline__ void kahan_add(float& s, float& comp, float v) {
  const float y = __fsub_rn(v, comp);
  const float t = __fadd_rn(s, y);
  comp = __fsub_rn(__fsub_rn(t, s), y);
  s = t;
}

// Sums a, merges (m, s) log-sum-exp pairs over a chain's threads, the same
// values on every thread; a barrier for the whole block before and after.
template <int WARPS>
__device__ void chain_reduce(float (*red)[kMaxWarps][3], int g, int warp, int wl, float& a,
                             float& m, float& s) {
  a = warp_sum(a);
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_xor_sync(kFull, m, off), os = __shfl_xor_sync(kFull, s, off);
    lse_merge(m, s, om, os);
  }
  if (wl == 0) {
    red[g][warp][0] = a;
    red[g][warp][1] = m;
    red[g][warp][2] = s;
  }
  __syncthreads();
  a = red[g][0][0];
  m = red[g][0][1];
  s = red[g][0][2];
  for (int w = 1; w < WARPS; ++w) {
    a += red[g][w][0];
    lse_merge(m, s, red[g][w][1], red[g][w][2]);
  }
  __syncthreads();
}

// The argmax (v, i) and q beside it over a chain's threads.
template <int WARPS>
__device__ void chain_argmax(float (*red)[kMaxWarps][3], int (*redi)[kMaxWarps], int g,
                             int warp, int wl, float& v, int& i, float& q) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off), oq = __shfl_xor_sync(kFull, q, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
      q = oq;
    }
  }
  if (wl == 0) {
    red[g][warp][0] = v;
    red[g][warp][1] = q;
    redi[g][warp] = i;
  }
  __syncthreads();
  v = red[g][0][0];
  q = red[g][0][1];
  i = redi[g][0];
  for (int w = 1; w < WARPS; ++w) {
    if (better(red[g][w][0], redi[g][w], v, i)) {
      v = red[g][w][0];
      q = red[g][w][1];
      i = redi[g][w];
    }
  }
  __syncthreads();
}

// The sweep: TR x TC threads a chain, each holding RT x CT pixels of a
// region of (TR RT) x (TC CT) pixels, blockDim.x / (TR TC) chains a block,
// chunks of `kc` slots.
template <int TR, int TC, int RT, int CT>
__global__ void __launch_bounds__(kBlock, 2) sweep_kernel(const Params P, const int kc) {
  constexpr int T = TR * TC;
  constexpr int RH = TR * RT, RW = TC * CT;
  constexpr int WARPS = T / 32;
  static_assert(T % 32 == 0 && WARPS <= kMaxWarps, "a chain takes whole warps");
  __shared__ Plan plans[kMaxGroups];
  __shared__ float red[kMaxGroups][kMaxWarps][3];
  __shared__ int redi[kMaxGroups][kMaxWarps];
  __shared__ int counts[kMaxGroups];
  extern __shared__ float dyn[];

  const int lane = threadIdx.x % T, g = threadIdx.x / T;
  const int wl = lane & 31, warp = lane >> 5;
  const int tr = lane / TC, tc = lane % TC;
  const int c = blockIdx.x * (blockDim.x / T) + g;
  Plan& pl = plans[g];
  float* ent = dyn + static_cast<size_t>(g) * kc * (3 + RH + RW);
  float* wy = ent + 3 * kc;
  float* gx = wy + kc * RH;
  const int H = P.H, W = P.W;
  const size_t hw = static_cast<size_t>(H) * W;
  const int n_rr = (H + RH - 1) / RH, n_rc = (W + RW - 1) / RW;
  const int n_chunks = (P.K + kc - 1) / kc;

  if (warp == 0) plan_move(P, pl, c < P.C ? c : -1, wl);
  __syncthreads();
  const int role = pl.role;
  const bool birth_r = P.residual && pl.kind == kBirth && role != 0;
  const bool any_birth_r = __syncthreads_or(birth_r);
  float* lam_w = P.work + (birth_r ? static_cast<size_t>(c) * hw : 0);

  // pass 1: the proposed catalog's lam (a residual birth's: the current
  // catalog's), region by region, consumed in registers
  float ll = 0.0f, llc = 0.0f, lm = -INFINITY, ls = 0.0f;
  for (int rr = 0; rr < n_rr; ++rr) {
    for (int rc = 0; rc < n_rc; ++rc) {
      const int r0 = rr * RH, c0 = rc * RW;
      float acc[RT][CT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) acc[i][j] = 0.0f;
      for (int ch = 0; ch < n_chunks; ++ch) {
        __syncthreads();  // the previous chunk's profiles are read
        if (warp == 0) {
          list_stars(P, pl, ch * kc, min(P.K, (ch + 1) * kc), ent, &counts[g], wl);
        }
        __syncthreads();
        const int cnt = counts[g];
        for (int idx = lane; idx < cnt * RH; idx += T) {
          const int e = idx / RH, r = idx - e * RH, h = r0 + r;
          wy[e * RH + r] = (h < H) ? __fmul_rn(profile(P, h + 0.5f, ent[3 * e + 1]),
                                               ent[3 * e + 2])
                                   : 0.0f;
        }
        for (int idx = lane; idx < cnt * RW; idx += T) {
          const int e = idx / RW, r = idx - e * RW, w = c0 + r;
          gx[e * RW + r] = (w < W) ? profile(P, w + 0.5f, ent[3 * e]) : 0.0f;
        }
        __syncthreads();
        for (int e = 0; e < cnt; ++e) {
          float a[RT], b[CT];
#pragma unroll
          for (int i = 0; i < RT; ++i) a[i] = wy[e * RH + tr + i * TR];
#pragma unroll
          for (int j = 0; j < CT; ++j) b[j] = gx[e * RW + tc + j * TC];
#pragma unroll
          for (int i = 0; i < RT; ++i)
#pragma unroll
            for (int j = 0; j < CT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
      if (role == 0) continue;
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int h = r0 + tr + i * TR;
        if (h >= H) continue;
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          const int w = c0 + tc + j * TC;
          if (w >= W) continue;
          const int p = h * W + w;
          const float lam = P.background + acc[i][j];
          const float d = __ldg(P.image + p);
          if (role & kLL) kahan_add(ll, llc, ll_term(d, lam));
          if (role & kLse) {
            const float lw = log_weight(P, d, lam);
            lse_push(lm, ls, lw);
            if (p == pl.pixj) pl.logw_j = lw;
          }
          if (role & kStore) lam_w[p] = lam;
        }
      }
    }
  }
  chain_reduce<WARPS>(red, g, warp, wl, ll, lm, ls);
  if (lane == 0) {
    pl.ll = ll;
    pl.lse = lm + logf(ls);
  }

  if (any_birth_r) {
    // pass 2 (residual births): the pixel argmax of g_pix + log q, log q =
    // log w - lse
    __syncthreads();
    float bv = -INFINITY, bq = 0.0f;
    int bi = INT_MAX;
    if (birth_r) {
      const float lse = pl.lse;
      const float* gp = P.bd_g_pix + static_cast<size_t>(c) * hw;
      for (int h = tr; h < H; h += TR) {
        for (int w = tc; w < W; w += TC) {
          const int p = h * W + w;
          const float lq = __fsub_rn(log_weight(P, __ldg(P.image + p), lam_w[p]), lse);
          const float v = __fadd_rn(gp[p], lq);
          if (better(v, p, bv, bi)) {
            bv = v;
            bi = p;
            bq = lq;
          }
        }
      }
    }
    chain_argmax<WARPS>(red, redi, g, warp, wl, bv, bi, bq);
    if (lane == 0 && birth_r) {
      // the born star: the pixel, a uniform offset in it, a prior flux
      pl.logq_pix = bq;
      const float px = static_cast<float>(bi % W), py = static_cast<float>(bi / W);
      const float u0 = __fadd_rn(__fmul_rn(P.bd_u_sub[2 * static_cast<size_t>(c)], P.u_scale),
                                 P.u_lo);
      const float u1 = __fadd_rn(
          __fmul_rn(P.bd_u_sub[2 * static_cast<size_t>(c) + 1], P.u_scale), P.u_lo);
      const float s_new = __fadd_rn(P.logf_mean, __fmul_rn(P.logf_sigma, P.bd_z[c]));
      unconstrain(P, __fadd_rn(px, u0), __fadd_rn(py, u1), expf(s_new), pl.th[0]);
      pl.n_over = 1;
    }
    __syncthreads();
    // pass 3 (residual births): lam plus the born star, its log-likelihood
    float l3 = 0.0f, l3c = 0.0f, dm = -INFINITY, ds = 0.0f;
    if (birth_r) {
      const float x = static_cast<float>(W) * sigmoid(pl.th[0][0]);
      const float y = static_cast<float>(H) * sigmoid(pl.th[0][1]);
      const float f = expf(pl.th[0][2]);
      for (int h = tr; h < H; h += TR) {
        const float wyv = __fmul_rn(profile(P, h + 0.5f, y), f);
        for (int w = tc; w < W; w += TC) {
          const int p = h * W + w;
          const float lam = fmaf(wyv, profile(P, w + 0.5f, x), lam_w[p]);
          kahan_add(l3, l3c, ll_term(__ldg(P.image + p), lam));
        }
      }
    }
    chain_reduce<WARPS>(red, g, warp, wl, l3, dm, ds);
    if (lane == 0 && birth_r) pl.ll = l3;
  }

  // the acceptance, as the plain code writes it
  if (lane == 0 && pl.chain >= 0) {
    const float n = pl.n;
    const float t0 = P.tll[c];
    float la = -INFINITY, ll_new = 0.0f;
    if (pl.valid) {
      ll_new = __fmul_rn(*P.beta, pl.ll);
      const float dl = __fsub_rn(ll_new, t0);
      if (pl.kind == kBirth) {
        la = __fsub_rn(__fadd_rn(dl, P.log_lam), logf(n + 1.0f));
        if (P.residual) la = __fsub_rn(__fsub_rn(la, P.log_area), pl.logq_pix);
      } else if (pl.kind == kDeath) {
        la = __fsub_rn(__fadd_rn(dl, logf(fmaxf(n, 1.0f))), P.log_lam);
        if (P.residual) la = __fadd_rn(__fadd_rn(la, P.log_area), __fsub_rn(pl.logw_j, pl.lse));
      } else if (pl.kind == kSplit) {
        la = __fsub_rn(__fadd_rn(dl, P.log_lam), logf(n + 1.0f));
        la = __fsub_rn(__fadd_rn(__fadd_rn(la, pl.extra[0]), pl.extra[1]), pl.extra[2]);
      } else {
        la = __fadd_rn(__fsub_rn(dl, P.log_lam), logf(fmaxf(n, 1.0f)));
        la = __fadd_rn(__fsub_rn(__fadd_rn(la, pl.extra[0]), pl.extra[1]), pl.extra[2]);
      }
    }
    const bool bd = pl.kind <= kDeath;
    const float u = bd ? P.bd_u_acc[c] : P.sm_u_acc[c];
    const bool acc = logf(u) < la;
    pl.accept = acc;
    P.tll_out[c] = acc ? ll_new : t0;
    P.log_alpha_out[c] = la;
    P.accepted_out[c] = acc ? 1 : 0;
    P.move_out[c] = pl.kind;
  }
  __syncthreads();
  if (pl.chain < 0) return;
  // theta' and mask': the catalog, with the move's slots if it was accepted
  const size_t row = static_cast<size_t>(c) * P.K;
  const int n_over = pl.accept ? pl.n_over : 0;
  for (int idx = lane; idx < 3 * P.K; idx += T) {
    const int k = idx / 3;
    float v = P.theta[row * 3 + idx];
    for (int o = 0; o < n_over; ++o) {
      if (pl.slot[o] == k && pl.has_th[o]) v = pl.th[o][idx - 3 * k];
    }
    P.theta_out[row * 3 + idx] = v;
  }
  for (int k = lane; k < P.K; k += T) {
    float v = P.mask[row + k];
    for (int o = 0; o < n_over; ++o) {
      if (pl.slot[o] == k && pl.has_m[o]) v = pl.m[o];
    }
    P.mask_out[row + k] = v;
  }
}

// The launch layout (read by fused_transdim_sweep.launch_layout): a
// field that pads to less area in 32 x 32 regions than in 128 x 128 ones
// takes the small layout (8 x 8 threads a chain, 4 x 4 pixels a thread,
// four chains a block), else the large one (16 x 16 threads, 8 x 8 pixels,
// one chain a block).
struct Layout {
  bool small;
  int threads_per_chain, chains_per_block, region_rows, region_cols, chunk, smem_bytes, blocks;
};

Layout layout_of(int C, int K, int H, int W) {
  Layout L;
  const long long pad_small = ((H + 31) / 32) * 32LL * (((W + 31) / 32) * 32LL);
  const long long pad_large = ((H + 127) / 128) * 128LL * (((W + 127) / 128) * 128LL);
  L.small = pad_small < pad_large;
  L.threads_per_chain = L.small ? 64 : 256;
  L.chains_per_block = kBlock / L.threads_per_chain;
  L.region_rows = L.region_cols = L.small ? 32 : 128;
  L.chunk = K < kMaxChunk ? K : kMaxChunk;
  L.smem_bytes = static_cast<int>(sizeof(float)) * L.chains_per_block * L.chunk *
                 (3 + L.region_rows + L.region_cols);
  L.blocks = (C + L.chains_per_block - 1) / L.chains_per_block;
  return L;
}

template <int TR, int TC, int RT, int CT>
int launch(const Params& P, const Layout& L, cudaStream_t st) {
  auto kernel = sweep_kernel<TR, TC, RT, CT>;
  if (L.smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<L.blocks, kBlock, L.smem_bytes, st>>>(P, L.chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The layout of a launch: threads a chain, chains a block, region rows and
// columns, chunk, dynamic shared memory (bytes) and blocks, into out[7].
int starcat_fused_transdim_sweep_layout(int C, int K, int H, int W, int* out) {
  if (C < 1 || K < 1 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = layout_of(C, K, H, W);
  out[0] = L.threads_per_chain;
  out[1] = L.chains_per_block;
  out[2] = L.region_rows;
  out[3] = L.region_cols;
  out[4] = L.chunk;
  out[5] = L.smem_bytes;
  out[6] = L.blocks;
  return 0;
}

// Launches one sweep on `stream`; returns cudaGetLastError() (0 on
// success).  `scalars` (host memory) holds Params' floats in their order.
int starcat_fused_transdim_sweep(
    const void* theta, const void* mask, const void* tll, const void* beta, const void* image,
    const void* u_sel, const void* bd_u_move, const void* bd_g_slot, const void* bd_star,
    const void* bd_g_pix, const void* bd_u_sub, const void* bd_z, const void* bd_u_acc,
    const void* sm_u_move, const void* sm_g_j, const void* sm_g_d, const void* sm_u_u,
    const void* sm_z_delta, const void* sm_u_acc, void* theta_out, void* mask_out,
    void* tll_out, void* log_alpha_out, void* accepted_out, void* move_out, void* work, int C,
    int K, int H, int W, int residual, const float* scalars, int n_scalars, void* stream) {
  if (n_scalars != kScalars || C < 1 || K < 1 || H < 1 || W < 1 ||
      (residual && (bd_g_pix == nullptr || work == nullptr)) ||
      (!residual && bd_star == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params P;
  P.theta = static_cast<const float*>(theta);
  P.mask = static_cast<const float*>(mask);
  P.tll = static_cast<const float*>(tll);
  P.beta = static_cast<const float*>(beta);
  P.image = static_cast<const float*>(image);
  P.u_sel = static_cast<const float*>(u_sel);
  P.bd_u_move = static_cast<const float*>(bd_u_move);
  P.bd_g_slot = static_cast<const float*>(bd_g_slot);
  P.bd_star = static_cast<const float*>(bd_star);
  P.bd_g_pix = static_cast<const float*>(bd_g_pix);
  P.bd_u_sub = static_cast<const float*>(bd_u_sub);
  P.bd_z = static_cast<const float*>(bd_z);
  P.bd_u_acc = static_cast<const float*>(bd_u_acc);
  P.sm_u_move = static_cast<const float*>(sm_u_move);
  P.sm_g_j = static_cast<const float*>(sm_g_j);
  P.sm_g_d = static_cast<const float*>(sm_g_d);
  P.sm_u_u = static_cast<const float*>(sm_u_u);
  P.sm_z_delta = static_cast<const float*>(sm_z_delta);
  P.sm_u_acc = static_cast<const float*>(sm_u_acc);
  P.theta_out = static_cast<float*>(theta_out);
  P.mask_out = static_cast<float*>(mask_out);
  P.tll_out = static_cast<float*>(tll_out);
  P.log_alpha_out = static_cast<float*>(log_alpha_out);
  P.accepted_out = static_cast<unsigned char*>(accepted_out);
  P.move_out = static_cast<long long*>(move_out);
  P.work = static_cast<float*>(work);
  P.C = C;
  P.K = K;
  P.H = H;
  P.W = W;
  P.residual = residual;
  float* const fields[kScalars] = {
      &P.psf_sigma, &P.psf_norm, &P.background, &P.logf_mean, &P.logf_sigma,
      &P.log_sigma_c, &P.half_log_2pi, &P.log_lam, &P.log_area, &P.split_sigma,
      &P.log_q_norm, &P.p_bd, &P.fmin, &P.resid_floor, &P.u_scale,
      &P.u_lo, &P.u_hi, &P.edge, &P.x_hi, &P.y_hi};
  for (int i = 0; i < kScalars; ++i) *fields[i] = scalars[i];

  const Layout L = layout_of(C, K, H, W);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return L.small ? launch<8, 8, 4, 4>(P, L, st) : launch<16, 16, 8, 8>(P, L, st);
}

const char* starcat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
