// Full-Fisher Riemannian trajectory on crowded fields on Hopper (sm_90a):
// B6c, for the scenes kernel B6 (csrc/fused_rhmc.cu) does not take: every
// scene and every catalog of K >= 1 slots whose workspace fits the card.
// Two paths: the one-tile path (this header's first part) for fields up to
// 128 x 128 pixels and K <= 64, and the wide path (namespace wide, its note
// there) beyond it.
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
// What bounds it on this card.  The work is the star-pair terms over the
// field: a rebuild's 18 profile pairs of both orders and the q field, a
// position sweep's Fisher pairs.  A star's float32 profiles are exactly 0
// beyond about 14 sigma (22 pixels at sigma 1.5), so a pair has work only
// on the rows and columns where both stars' footprints overlap: at cfg4's
// 4096 particles of 30..64 stars on 128 x 128 that is under 2% of the
// every-pixel count (chip_smoke.rhmc_full_sparse_ops), and the dense
// algebra (D = 3 K_live <= 192: a Cholesky a sweep, L^-1 and G^-1 a
// rebuild), a chain of latencies, weighs as much.  One chain's state is
// about 0.74 MB at K = 64 on 128 x 128, so shared memory is reused by phase.
//
// Where each operand lives (the block's dynamic shared memory holds a
// phase region and the per-star and per-parameter vectors; the workspace is
// the block's slice of device memory that the wrapper allocates):
//   * field phase (profiles, render, the pair passes, the phi and q fields,
//     the contractions): shared 1/lam (H rows at the field stride), gy and
//     gy' interleaved and gx, gx' of every live star, each star's footprint
//     (the rows and columns where its profiles are not 0) and the live
//     stars in y order; during a rebuild's pair contractions gy'' takes the
//     place of gx, gx'; during a momentum sweep phi / lam takes 1/lam's
//     place until its contraction, after which 1/lam is rendered again.
//     The workspace holds the working field (rho, q), a copy of gx, gx',
//     gx'' and of gy'' (read once per column in the contractions' and pair
//     contractions' epilogues, and row by row in the momentum sweep's
//     contraction), the 18 K^2 pair sums, G^-1 and the q field's
//     coefficient table;
//   * dense phase (assembly, Cholesky, solves, L^-1): the same shared
//     region holds L (packed by columns, with the momentum's row in a
//     position sweep), then the Cholesky's column buffers and panel by
//     rows, or L^-1 (packed by columns); G^-1 = L^-T L^-1 goes to the
//     workspace for the matrix-vector products, the t1 terms and the q
//     field's coefficients;
//   * q field: while it runs, the 1/lam rows hold two stages of its GEMM
//     operands, and a ring of two coefficient chunks is fed from the
//     workspace by cp.async a chunk ahead of its use;
//   * the block's layout (offsets, strides, the chain's live stars) and the
//     chain's scalars and loop counters: shared memory, so that no thread
//     keeps an address or a counter in registers across the passes.
// No inner loop of a pixel pass or of the dense algebra reads the
// workspace; the rho and q contractions read the working field row by row
// from it.
//
// The passes:
//   * the q field q(p) = sum_ab Ginv_ab J_a(p) J_b(p) as a GEMM.  J_a of star
//     i factors into a column profile (gx' for x, gx for y and flux) and a
//     row term, so with G^-1's 3x3 block of stars (i, j) folded into nine
//     coefficients, q = sum over pairs i <= j and the four column-profile
//     combinations of T(row) X(col): a product of depth 4 per pair (about
//     2 K^2 operations a pixel against B6's 9 K^2), over only the pairs
//     whose footprints overlap.  Chunks of kQPairs pairs (depth kQK) are
//     written to shared memory, T from the row profiles and the
//     coefficients, X from the column profiles, double-buffered against the
//     product, and each thread holds a TR x TC register tile of pixels (4 x
//     8 up to 128 x 128, 2 x 4 where that fills the block); a warp skips
//     the pairs whose rows miss its own;
//   * the phi field the same way: a TR x TC tile a thread, the stars in
//     order, a warp skipping the stars whose rows miss its own;
//   * the Fisher pairs of a position sweep by 2 x 2 star tiles (stars
//     neighbouring in y): a lane group spans a row's 4-column chunks, each
//     lane holds the 16 row products of four star pairs against 1/lam on
//     its 4 columns (64 accumulators), over the rows of the pairs'
//     footprints; a pair whose footprints do not overlap writes 0;
//   * a rebuild's pair contractions one star pair a lane group (32
//     accumulators) over the pair's overlapping rows, their 18 sums of both
//     orders reduced in two halves;
//   * the render by 4 x 4 pixel tiles, the stars in order, a warp skipping
//     the stars whose rows miss its own; the contractions two stars a warp;
//   * the Cholesky in shared memory: for D >= kPanelMinD right-looking in
//     panels of 32 columns, a panel in registers (a column a lane) with one
//     block barrier a column, then a register-tiled trailing update; below
//     it by columns, one barrier a column; L^-1 a column a warp by forward
//     substitution; G^-1 = L^-T L^-1 by all threads, its lower half
//     computed and mirrored;
//   * a persistent grid of one 512-thread block an SM: blocks take chains
//     from a counter in the workspace's header (atomicAdd), so the blocks
//     with chains of few live stars take more of them.
// Every skipped term is an exact zero (a factor is a profile that is 0), so
// skipping it changes no bit of any sum.
//
// Accuracy: no fast math.  The log-likelihood, log det G and the energies
// sum in double.  A non-positive pivot gives NaN, which propagates to the
// residual, a NaN-propagating max, so the head rejects the chain as a solver
// failure.  Every sum runs in a fixed order that depends on the scene and
// the chain's live stars only, not on the chain count or the block, so a
// chain gives the same bits alone, among others and at any chain count.
//
// Domain (checked by the wrapper, fused_rhmc_crowded.py, and by in_domain
// here): the one-tile path for H, W <= 128 and 1 <= K <= 64, where the
// shared memory (smem_floats) stays within 216 KB; the wide path for every
// other scene and K >= 1, up to the card's memory (a block's slice is 22 GB
// at K = 10923 on 128 x 128 and fills an 80 GB card's free memory near
// K = 21,300), its offsets into the slice in 64 bits where they pass 2^31
// (the index helpers' note).  A launch whose fields and profiles pass 2^31
// floats of a slice (a field of about 10^9 pixels) returns an error
// (wide::fields_in_32_bits).
#include <cuda_runtime.h>

// the block's dynamic shared memory, which carve() divides
extern __shared__ __align__(16) float b6c_smem[];

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStars = 64;
constexpr int kMaxSide = 128;
// rows of a D-row column a lane holds in L^-1's forward substitution and the
// back substitution
constexpr int kRows = (3 * kMaxStars + 31) / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kQPairs = 8;            // star pairs of a q-field chunk
constexpr int kQK = 4 * kQPairs;      // its GEMM depth
constexpr int kCoef = 12;             // floats a pair in the q coefficient table
constexpr int kHeader = 4;            // workspace floats before the blocks' slices

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
  float* work;          // kHeader (the chain counter, 0 at launch), then
                        // (gridDim.x, work_floats(K, H, W)), 64-bit offsets
  int C, K, H, W, n_steps, fpi;
  float psf_sigma, psf_norm, background;
  float logf_mean, logf_sigma, lp_flux_const, jitter;
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// row stride of the fields and column profiles: W rounded up to 4, so a
// 4-column chunk is one 16-byte load
__host__ __device__ inline int field_stride(int W) { return round4(W); }

// odd star stride of the row profiles: the stars of different lane groups
// fall in distinct shared-memory banks
__host__ __device__ inline int prof_ld(int n) { return n | 1; }

// the q and phi fields' padded extent: rows to 4, columns to 8
__host__ __device__ inline int q_rows(int H) { return round4(H); }
__host__ __device__ inline int q_cols(int W) { return (W + 7) & ~7; }

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// one q-field operand stage: T (kQK, Hq), X (kQK, Wq) and its pairs' row
// ranges (first rows, then last rows)
__host__ __device__ inline int q_stage(int H, int W) {
  return kQK * (q_rows(H) + q_cols(W)) + 2 * kQPairs;
}

// the 1/lam slot: H rows at the field stride, or the q field's two operand
// stages where those are larger
__host__ __device__ inline int r1_slot(int H, int W) {
  return imax(H * field_stride(W), 2 * q_stage(H, W));
}

// the column profiles' slot (gx, gx'), which gy'' takes over in a rebuild
__host__ __device__ inline int gx_slot(int K, int H, int W) {
  return imax(2 * K * field_stride(W), round4(K * prof_ld(H)));
}

// The index helpers of the slice's large arrays.  Off is the offset type:
// int on the one-tile path (K <= 64: a slice of under 2^19 floats), long
// long on the wide path, whose products pass 2^31 - 1 within a block's
// slice where the card holds it (K up to about 21,300 at 128 x 128 on an
// 80 GB card):
//   * the 18 K^2 pair sums at plane_off(n, K) (plane 17's end passes 2^31 at
//     K = 10923);
//   * packed L and L^-1 (packed_l, col_off) and the dense D x D matrices by
//     rows (row_off), where D (D + 1) passes it: D = 46341, K = 15447;
//   * the q coefficient table (coef_off) and G^-1's 3 x 3 star blocks K D
//     rows apart (q_table), where 6 K^2 passes it: K = 18919.
// Each returns a plane's, a column's or a row's base offset, which the wide
// path takes once as a pointer outside its inner loops; the offsets inside
// stay in 32 bits (i K + j < K^2, a row below D + 1, col_step's k n): K^2
// < 2^31 for every K whose slice a card holds (18 K^2 floats alone pass
// 80 GB at K = 34,000).  The fields and profiles before the pair sums are
// addressed in 32 bits from the slice's start (wide::fields_in_32_bits);
// the wide kernel takes each chain's (K, 3) rows of theta, xi and the
// outputs at a 64-bit chain offset.

// L packed by columns with N1 = D + 1 rows (the momentum's row last):
// column c holds rows c .. D
template <typename Off = int>
__host__ __device__ inline Off packed_l(int D) { return (static_cast<Off>(D) + 1) * (D + 2) / 2; }

// L^-1 packed by columns, D rows
__host__ __device__ inline int packed_x(int D) { return D * (D + 1) / 2; }

// the Cholesky's scratch after L: two column buffers, then (16-byte
// aligned) a panel by rows, kPanelLd floats a row
constexpr int kPanelLd = 36;
__host__ __device__ inline int chol_prow(int D) { return round4(packed_l(D) + 2 * (D + 1)); }
__host__ __device__ inline int chol_scratch(int D) {
  return chol_prow(D) - packed_l(D) + kPanelLd * (D + 1);
}

// the phase region: the field phase's arrays or the dense phase's (L, then
// the Cholesky's scratch or L^-1)
__host__ __device__ inline int region_floats(int K, int H, int W) {
  const int field = r1_slot(H, W) + 2 * round4(K * prof_ld(H)) + gx_slot(K, H, W);
  const int D = 3 * K;
  return round4(imax(field, packed_l(D) + imax(packed_x(D), chol_scratch(D))));
}

// mirrored by smem_bytes() in fused_rhmc_crowded.py: the phase region, the
// q coefficient ring, 67 floats a star (25 per-star scalars, 12 vectors of
// D and 6 per-star ints) and 12 of per-chain scalars
__host__ __device__ inline int smem_floats(int K, int H, int W) {
  return region_floats(K, H, W) + 2 * kQPairs * kCoef + 67 * K + 12;
}

// the q coefficient table's pairs, whole chunks
__host__ __device__ inline int q_table_pairs(int K) {
  return (K * (K + 1) / 2 + kQPairs - 1) / kQPairs * kQPairs;
}

// mirrored by workspace_floats() in fused_rhmc_crowded.py: the working
// field, the three column profile sets, gy'', the 18 K^2 pair sums, G^-1
// (D x D) and the q coefficient table
__host__ __device__ inline long long work_floats(int K, int H, int W) {
  const int fs = field_stride(W), D = 3 * K;
  return H * fs + 3 * K * fs + round4(K * prof_ld(H)) + round4(18 * K * K) + round4(D * D)
         + kCoef * q_table_pairs(K);
}

// offset of packed column c with n rows (column c holds rows c .. n - 1)
template <typename Off = int>
__device__ __forceinline__ Off col_off(int c, int n) {
  return static_cast<Off>(c) * n - static_cast<Off>(c) * (c - 1) / 2;
}

// offset of plane n of the 18 K^2 pair sums, (n, i, j) at plane_off + i K + j
template <typename Off = int>
__device__ __forceinline__ Off plane_off(int n, int K) { return static_cast<Off>(n) * (K * K); }

// offset of row a of a D x D matrix by rows
template <typename Off = int>
__device__ __forceinline__ Off row_off(int a, int D) { return static_cast<Off>(a) * D; }

// offset of pair u's kCoef floats in the q coefficient table
template <typename Off = int>
__device__ __forceinline__ Off coef_off(int u) { return static_cast<Off>(u) * kCoef; }

// Per-star scalars, index i over the live stars; per-parameter vectors,
// index a = t K + i.
struct Work {
  // shared memory, field phase
  float* r1;                        // (H, fs): 1/lam, 0 past column W
  float* qbuf;                      // the q field's operand stages, over r1
  float* gyy;                       // (K, hp, 2): gy, gy' of star i's row h at 2 (i hp + h)
  float *gx, *gx1;                  // (K, fs): star i's columns at i * fs, 0 past W
  float* gy2;                       // (K, hp) over gx, gx' in a rebuild's pair pass
  // shared memory, dense phase (over the field phase's arrays)
  float* dense;                     // packed L (N1 = D + 1 rows), then packed L^-1
  float* qc;                        // (2, kQPairs, kCoef) q coefficient ring
  float *su, *sv, *x, *y, *w, *wcx, *wcy, *wcx2, *wcy2, *wcxx, *wcyy, *wcxcy, *m;
  float *cu, *cv, *cs;              // a_a coef_a per star, for the phi field
  float* dots;                      // (9, K) field contractions per star
  float *th_b, *p_b, *ph, *th, *base, *vec, *t1, *infod, *a, *ldiag, *dinv, *dh;
  float* scal;                      // U, logdet, h, delta scratch, the q field's pairs,
                                    // h0, the residual, the momentum sweeps' delta,
                                    // beta, eps
  int *ylo, *yhi;                   // the rows where star i's row profiles are not 0
  int *xlo, *xhi;                   // the columns where its column profiles are not 0
  int* ord;                         // the live stars by y, for grouping the pair passes
  int* qrow;                        // the q field's first pair of star i (scratch)
  // the block's workspace in device memory
  float* fld;                       // (H, fs): rho, then q, then phi
  float *gxg, *gx1g, *gx2g;         // (K, fs) copies of the column profiles
  float* gy2g;                      // (K, hp): gy''
  float* sraw;                      // (18, K, K): [(hp * 3 + tb) K + i] K + j
  float* ginv;                      // G^-1 (D x D, symmetric)
  float* qcoef;                     // (pairs, kCoef): 9 coefficients, i, j
  float* scratch;                   // the wide path's streamed Cholesky and L^-1 columns
  int K, D, fs, hp, Hq, Wq, n_dead; // K, D: the chain's live stars and parameters
};

// The block's layout, in shared memory rather than in every thread's
// registers: offsets of the shared arrays from b6c_smem and of the
// workspace arrays from the block's slice, the slice's own offset, the
// strides, and the chain's live stars.
enum {
  kLyFs, kLyHp, kLyHq, kLyWq, kLyGyy, kLyGx, kLyGx1, kLyQc, kLySmall,
  kLyGxg, kLyGx1g, kLyGx2g, kLyGy2g, kLySraw, kLyGinv, kLyQcoef, kLyK, kLyCount
};
__shared__ int b6c_lay[kLyCount];
__shared__ long long b6c_slice;     // the block's slice: its offset in the workspace
__shared__ double b6c_red[kWarps];  // block_sum_d's partial sums
__shared__ int b6c_chain;           // the block's chain
__shared__ int b6c_iter[2];         // the trajectory's step and the step's sweep

// The layout of the K slots into b6c_lay (one thread; the chain's K is set
// per chain).
__device__ void init_layout(const Params& P) {
  int* ly = b6c_lay;
  const int K = P.K, H = P.H, W = P.W, D = 3 * K;
  const int fs = field_stride(W), hp = prof_ld(H);
  ly[kLyFs] = fs;
  ly[kLyHp] = hp;
  ly[kLyHq] = q_rows(H);
  ly[kLyWq] = q_cols(W);
  // the phase region first (16-byte aligned); every offset a multiple of 4
  ly[kLyGyy] = r1_slot(H, W);
  ly[kLyGx] = ly[kLyGyy] + 2 * round4(K * hp);
  ly[kLyGx1] = ly[kLyGx] + K * fs;
  ly[kLyQc] = region_floats(K, H, W);
  ly[kLySmall] = ly[kLyQc] + 2 * kQPairs * kCoef;
  b6c_slice = kHeader + static_cast<long long>(blockIdx.x) * work_floats(K, H, W);
  ly[kLyGxg] = H * fs;
  ly[kLyGx1g] = ly[kLyGxg] + K * fs;
  ly[kLyGx2g] = ly[kLyGx1g] + K * fs;
  ly[kLyGy2g] = ly[kLyGx2g] + K * fs;
  ly[kLySraw] = ly[kLyGy2g] + round4(K * hp);
  ly[kLyGinv] = ly[kLySraw] + round4(18 * K * K);
  ly[kLyQcoef] = ly[kLyGinv] + round4(D * D);  // 16-byte aligned
  ly[kLyK] = K;
}

// The per-star scalars and per-parameter vectors at v (67 floats a slot of
// Ks: 25 per-star scalars, 12 vectors of 3 Ks, 12 per-chain scalars, 6
// per-star ints), in both paths' shared memory.
__device__ __forceinline__ void place_vectors(Work& s, float* v, int Ks) {
  const int Ds = 3 * Ks;
  s.su = v; s.sv = v + Ks; s.x = v + 2 * Ks; s.y = v + 3 * Ks; s.w = v + 4 * Ks;
  s.wcx = v + 5 * Ks; s.wcy = v + 6 * Ks; s.wcx2 = v + 7 * Ks; s.wcy2 = v + 8 * Ks;
  s.wcxx = v + 9 * Ks; s.wcyy = v + 10 * Ks; s.wcxcy = v + 11 * Ks; s.m = v + 12 * Ks;
  s.cu = v + 13 * Ks; s.cv = v + 14 * Ks; s.cs = v + 15 * Ks;
  s.dots = v + 16 * Ks;
  v += 25 * Ks;
  s.th_b = v; s.p_b = v + Ds; s.ph = v + 2 * Ds; s.th = v + 3 * Ds;
  s.base = v + 4 * Ds; s.vec = v + 5 * Ds; s.t1 = v + 6 * Ds; s.infod = v + 7 * Ds;
  s.a = v + 8 * Ds; s.ldiag = v + 9 * Ds; s.dinv = v + 10 * Ds; s.dh = v + 11 * Ds;
  s.scal = v + 12 * Ds;
  s.ylo = reinterpret_cast<int*>(v + 12 * Ds + 12);
  s.yhi = s.ylo + Ks;
  s.xlo = s.ylo + 2 * Ks;
  s.xhi = s.ylo + 3 * Ks;
  s.ord = s.ylo + 4 * Ks;
  s.qrow = s.ylo + 5 * Ks;
}

// The arrays at the block's layout and the chain's live stars.  Each pass
// makes its own, so that no address stays in registers across passes.
__device__ __forceinline__ Work make_work(const Params& P) {
  const int* ly = b6c_lay;
  const int Ks = P.K;
  Work s;
  s.fs = ly[kLyFs];
  s.hp = ly[kLyHp];
  s.Hq = ly[kLyHq];
  s.Wq = ly[kLyWq];
  float* sm = b6c_smem;
  s.r1 = sm;
  s.qbuf = sm;
  s.dense = sm;
  s.gyy = sm + ly[kLyGyy];
  s.gx = sm + ly[kLyGx];
  s.gx1 = sm + ly[kLyGx1];
  s.gy2 = s.gx;
  s.qc = sm + ly[kLyQc];
  place_vectors(s, sm + ly[kLySmall], P.K);
  float* g = P.work + b6c_slice;
  s.fld = g;
  s.gxg = g + ly[kLyGxg];
  s.gx1g = g + ly[kLyGx1g];
  s.gx2g = g + ly[kLyGx2g];
  s.gy2g = g + ly[kLyGy2g];
  s.sraw = g + ly[kLySraw];
  s.ginv = g + ly[kLyGinv];
  s.qcoef = g + ly[kLyQcoef];
  s.K = ly[kLyK];
  s.D = 3 * s.K;
  s.n_dead = Ks - s.K;
  return s;
}

// this thread's index, read afresh at each use: a value the compiler may not
// keep live across the passes (it would spill it)
__device__ __forceinline__ int thread_index() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
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

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// 16 bytes from device memory to shared memory, asynchronously
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's copies have landed (visible to the block after a barrier)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Block-wide sum of a per-thread double, returned to every thread.
__device__ double block_sum_d(double v) {
  double* red = b6c_red;
  const int lane = thread_index() & 31, warp = thread_index() >> 5;
  v = warp_sum_d(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double tot = 0.0;
  for (int i = 0; i < kWarps; ++i) tot += red[i];
  __syncthreads();
  return tot;
}

// Per-star coefficients and the profiles at theta `th` (D, packed): gy, gy',
// gx, gx' into shared memory and, with `copies`, gx, gx', gx'' and gy'' into
// the workspace.  Every thread of the block calls it; it ends synchronised.
__device__ void profiles(const Params& P, const Work& s, const float* th, bool copies) {
  const int tid = thread_index(), lane = tid & 31, warp = tid >> 5;
  const int K = s.K, H = P.H, W = P.W, fs = s.fs, hp = s.hp;
  const float sig = P.psf_sigma;
  for (int i = tid; i < K; i += kThreads) {
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
    int clo = W, chi = -1;
    for (int col = lane; col < fs; col += 32) {
      const int n = i * fs + col;
      float g = 0.0f, g1 = 0.0f, g2 = 0.0f;
      if (col < W) {
        const float z = ((col + 0.5f) - xs) / sig;
        g = expf(-0.5f * z * z) * P.psf_norm;
        g1 = g * z / sig;
        g2 = g * (z * z - 1.0f) / sig2;
      }
      s.gx[n] = g; s.gx1[n] = g1;
      if (copies) { s.gxg[n] = g; s.gx1g[n] = g1; s.gx2g[n] = g2; }
      if (g != 0.0f) {
        clo = min(clo, col);
        chi = max(chi, col);
      }
    }
    int lo = H, hi = -1;
    for (int row = lane; row < H; row += 32) {
      const int n = i * hp + row;
      const float z = ((row + 0.5f) - ys) / sig;
      const float g = expf(-0.5f * z * z) * P.psf_norm;
      s.gyy[2 * n] = g;
      s.gyy[2 * n + 1] = g * z / sig;
      if (copies) s.gy2g[n] = g * (z * z - 1.0f) / sig2;
      if (g != 0.0f) {
        lo = min(lo, row);
        hi = max(hi, row);
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(kFull, lo, o));
      hi = max(hi, __shfl_xor_sync(kFull, hi, o));
      clo = min(clo, __shfl_xor_sync(kFull, clo, o));
      chi = max(chi, __shfl_xor_sync(kFull, chi, o));
    }
    if (lane == 0) {
      s.ylo[i] = lo;
      s.yhi[i] = hi;
      s.xlo[i] = clo;
      s.xhi[i] = chi;
    }
  }
  __syncthreads();
  // the live stars by y (ties by index), which the pair passes group by
  for (int i = tid; i < K; i += kThreads) {
    const float yi = s.y[i];
    int rank = 0;
    for (int j = 0; j < K; ++j) {
      const float yj = s.y[j];
      rank += (yj < yi || (yj == yi && j < i)) ? 1 : 0;
    }
    s.ord[rank] = i;
  }
  __syncthreads();
}

// lam -> s.r1 = 1/lam (0 past column W), by 4 x 4 pixel tiles, the stars in
// order.  With `full`, also s.fld = beta (D/lam - 1) and the log-likelihood
// sum_p D log lam - lam (double), returned to every thread.  Ends
// synchronised.
__device__ double render(const Params& P, const Work& s, float beta, bool full) {
  const int tid = thread_index();
  const int K = s.K, H = P.H, W = P.W, fs = s.fs, hp = s.hp;
  const int cq = fs >> 2, n_tiles = ((H + 3) >> 2) * cq;
  double ll = 0.0;
  for (int t = tid; t < n_tiles; t += kThreads) {
    const int tr = t / cq;
    const int h0 = 4 * tr, c0 = 4 * (t - tr * cq);
    // the rows of the warp's tiles
    const int t0 = t & ~31, t1 = min(t0 + 31, n_tiles - 1);
    const int wlo = 4 * (t0 / cq), whi = 4 * (t1 / cq) + 3;
    int rows[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) rows[r] = h0 + r < H ? h0 + r : H - 1;  // past the last row: not written
    float lam[4][4];
#pragma unroll
    for (int n = 0; n < 16; ++n) (&lam[0][0])[n] = P.background;
    for (int i = 0; i < K; ++i) {
      // a star whose row profiles vanish on the warp's rows adds exact zeros
      if (s.yhi[i] < wlo || s.ylo[i] > whi) continue;
      const float wi = s.w[i];
      const float4 g = load4(s.gx + i * fs + c0);
      const float* gyi = s.gyy + 2 * i * hp;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float yw = gyi[2 * rows[r]] * wi;
#pragma unroll
        for (int k = 0; k < 4; ++k) lam[r][k] = lam[r][k] + yw * comp(g, k);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int h = h0 + r;
      if (h >= H) break;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int col = c0 + k, pix = h * fs + col;
        if (col >= W) {
          s.r1[pix] = 0.0f;
          continue;
        }
        const float r1 = 1.0f / lam[r][k];
        s.r1[pix] = r1;
        if (full) {
          const float d = P.image[h * W + col];
          ll += static_cast<double>(d * logf(lam[r][k]) - lam[r][k]);
          s.fld[pix] = beta * (d * r1 - 1.0f);
        }
      }
    }
  }
  if (!full) {
    __syncthreads();
    return 0.0;
  }
  return block_sum_d(ll);  // synchronises
}

// Field contractions, two stars a warp (neighbours in y order): lanes over
// columns (all of a lane's columns at once) sum the field, read once for
// both stars, against gy, gy', gy'' down the rows where either star's
// profiles are non-zero, then W-length dots against the column profiles'
// copies by warp shuffles (csrc/fused_rhmc.cu's contract: the same modes,
// sums in the same order and results at s.dots[n K + i]).  The field is
// rho (kGrad) or q (kQ, times 1/lam^2) in the workspace's working field, or
// phi / lam (kSweep) in shared memory, where phi_field leaves it.
enum { kGrad = 0, kQ = 1, kSweep = 2 };

template <int MODE>
__device__ void contract(const Params& P, const Work& s) {
  constexpr int kCols = kMaxSide / 32;     // a lane's columns lane + 32 u
  constexpr int kAcc = MODE == kSweep ? 5 : 2;
  const int tid = thread_index(), lane = tid & 31, warp = tid >> 5;
  const int K = s.K, W = P.W, fs = s.fs, hp = s.hp;
  for (int m = warp; 2 * m < K; m += kWarps) {
    // neighbours in y order; a lone last star twice, written once
    const int st[2] = {s.ord[2 * m], s.ord[2 * m + 1 < K ? 2 * m + 1 : 2 * m]};
    const int lo = min(s.ylo[st[0]], s.ylo[st[1]]), hi = max(s.yhi[st[0]], s.yhi[st[1]]);
    float acc[2][kCols][kAcc];
#pragma unroll
    for (int n = 0; n < 2 * kCols * kAcc; ++n) (&acc[0][0][0])[n] = 0.f;
#pragma unroll 2
    for (int h = lo; h <= hi; ++h) {  // elsewhere both stars' row profiles are 0
      float f1[kCols];
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int col = lane + 32 * u, pix = h * fs + col;
        float f = 0.f;
        if (col < W) {
          if (MODE == kSweep) {
            f = s.r1[pix];  // phi / lam, which phi_field left in 1/lam's slot
          } else {
            f = s.fld[pix];
            if (MODE == kQ) {
              const float r = s.r1[pix];
              f = f * (r * r);
            }
          }
        }
        f1[u] = f;
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const float2 y = load2(s.gyy + 2 * (st[t] * hp + h));
        const float y2 = MODE == kSweep ? s.gy2g[st[t] * hp + h] : 0.f;
#pragma unroll
        for (int u = 0; u < kCols; ++u) {
          acc[t][u][0] += f1[u] * y.x;
          acc[t][u][1] += f1[u] * y.y;
          if (MODE == kSweep) {
            acc[t][u][2] += f1[u] * y2;
            const float f2 = f1[u] * f1[u];
            acc[t][u][3] += f2 * y.x;
            acc[t][u][4] += f2 * y.y;
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int i = st[t];
      float a1 = 0.f, a2 = 0.f, a3 = 0.f, a4 = 0.f, a5 = 0.f, a6 = 0.f;
      float b1 = 0.f, b4 = 0.f, b6 = 0.f;
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int col = lane + 32 * u;
        if (col < W) {
          const float rg = acc[t][u][0], rg1 = acc[t][u][1];
          const int n = i * fs + col;
          const float gx = s.gxg[n], gx1 = s.gx1g[n];
          a1 += gx1 * rg;
          a4 += gx * rg1;
          a6 += gx * rg;
          if (MODE == kSweep) {
            const float rg2 = acc[t][u][2], rb = acc[t][u][3], rb1 = acc[t][u][4];
            a2 += s.gx2g[n] * rg;
            a3 += gx1 * rg1;
            a5 += gx * rg2;
            b1 += gx1 * rb;
            b4 += gx * rb1;
            b6 += gx * rb;
          }
        }
      }
      a1 = warp_sum(a1); a4 = warp_sum(a4); a6 = warp_sum(a6);
      if (MODE == kSweep) {
        a2 = warp_sum(a2); a3 = warp_sum(a3); a5 = warp_sum(a5);
        b1 = warp_sum(b1); b4 = warp_sum(b4); b6 = warp_sum(b6);
      }
      if (lane == 0 && (t == 0 || st[1] != st[0])) {
        s.dots[i] = a1; s.dots[3 * K + i] = a4; s.dots[5 * K + i] = a6;
        if (MODE == kSweep) {
          s.dots[K + i] = a2; s.dots[2 * K + i] = a3; s.dots[4 * K + i] = a5;
          s.dots[6 * K + i] = b1; s.dots[7 * K + i] = b4; s.dots[8 * K + i] = b6;
        }
      }
    }
  }
  __syncthreads();
}

// The six distinct Hessian profiles hp of a star and the three Jacobian
// profiles of type tb are csrc/fused_rhmc.cu's; type t's own profile is
// hp = hp_of_type(t).
__device__ __forceinline__ int hp_of_type(int t) { return t == 0 ? 0 : (t == 1 ? 3 : 5); }

// unordered pair u of n items, i <= j, without a division
__device__ __forceinline__ void pair_of(int u, int n, int& i, int& j) {
  i = 0;
  while (u >= n - i) { u -= n - i; ++i; }
  j = i + u;
}

// Whether stars i and j share a pixel where both stars' profiles are not 0:
// elsewhere each term of the pair is an exact zero.
__device__ __forceinline__ bool overlap(const Work& s, int i, int j) {
  return max(s.ylo[i], s.ylo[j]) <= min(s.yhi[i], s.yhi[j])
         && max(s.xlo[i], s.xlo[j]) <= min(s.xhi[i], s.xhi[j]);
}

// The lane groups of a pair pass: a group of 1 << lg lanes a star pair (or
// star tile), the power of two at or above the n_chunks 4-column chunks of
// a row (at most 32: W <= 128).
struct PairLanes {
  int lg, g, slot, per_round, n_chunks;
};

__device__ __forceinline__ PairLanes pair_lanes(int fs) {
  PairLanes q;
  const int lane = thread_index() & 31, warp = thread_index() >> 5;
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
// products a pair (csrc/fused_rhmc.cu's pair_contract, by lane groups),
// over the rows where both stars' profiles are non-zero.
// gy'' is read from s.gy2 (shared), the column profiles from their copies
// in the epilogue; the 18 sums of each order are made and reduced in two
// halves of three Hessian profiles.
__device__ void pair_contract(const Params& P, const Work& s) {
  const int K = s.K, fs = s.fs, hp = s.hp, KK = K * K;
  const int n_pairs = K * (K + 1) / 2;
  const PairLanes q = pair_lanes(fs);
  for (int base = 0; base < n_pairs; base += q.per_round) {
    const int u = base + q.slot;
    const bool has = u < n_pairs;
    int i, j;
    pair_of(has ? u : 0, K, i, j);
    // a pair that shares no pixel where both profiles are non-zero has
    // sums of exact zeros: +0
    const bool touch = has && overlap(s, i, j);
    const bool work = touch && q.g < q.n_chunks;
    float t[8][4];
#pragma unroll
    for (int n = 0; n < 32; ++n) (&t[0][0])[n] = 0.f;
    if (work) {
      // offsets into the shared array rather than pointers: fewer registers
      const int g0 = static_cast<int>(s.gyy - b6c_smem), g2 = static_cast<int>(s.gy2 - b6c_smem);
      const int oi = g0 + 2 * i * hp, oj = g0 + 2 * j * hp, oi2 = g2 + i * hp, oj2 = g2 + j * hp;
      const int orc = static_cast<int>(s.r1 - b6c_smem) + 4 * q.g;
      // the rows where both stars' row profiles are non-zero
      const int hi = min(s.yhi[i], s.yhi[j]);
#pragma unroll 2
      for (int h = max(s.ylo[i], s.ylo[j]); h <= hi; ++h) {
        const float2 ya = load2(b6c_smem + oi + 2 * h), yb = load2(b6c_smem + oj + 2 * h);
        const float a0 = ya.x, a1 = ya.y, a2 = b6c_smem[oi2 + h];
        const float b0 = yb.x, b1 = yb.y, b2 = b6c_smem[oj2 + h];
        const float pr[8] = {a0 * b0, a0 * b1, a1 * b0, a1 * b1,
                             a2 * b0, a2 * b1, a0 * b2, a1 * b2};
        const float4 r4 = load4(b6c_smem + orc + h * fs);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float r = comp(r4, k);
#pragma unroll
          for (int m = 0; m < 8; ++m) t[m][k] += pr[m] * r;
        }
      }
    }
    const int ci = i * fs + 4 * q.g, cj = j * fs + 4 * q.g;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float acc[9], acm[9];  // (i, j) and (j, i)
#pragma unroll
      for (int n = 0; n < 9; ++n) acc[n] = acm[n] = 0.f;
      if (work) {
        const float4 xi0 = load4(s.gxg + ci), xi1 = load4(s.gx1g + ci), xi2 = load4(s.gx2g + ci);
        const float4 xj0 = load4(s.gxg + cj), xj1 = load4(s.gx1g + cj), xj2 = load4(s.gx2g + cj);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float xi[3] = {comp(xi0, k), comp(xi1, k), comp(xi2, k)};
          const float xj[3] = {comp(xj0, k), comp(xj1, k), comp(xj2, k)};
          const float T[3][3] = {{t[0][k], t[1][k], t[6][k]},
                                 {t[2][k], t[3][k], t[7][k]},
                                 {t[4][k], t[5][k], 0.f}};
#pragma unroll
          for (int hh = 0; hh < 3; ++hh) {
            const int hq = 3 * half + hh;
            const int yh = hq == 4 ? 2 : ((hq == 2 || hq == 3) ? 1 : 0);
            const int xh = (hq == 0 || hq == 2) ? 1 : (hq == 1 ? 2 : 0);
#pragma unroll
            for (int tb = 0; tb < 3; ++tb) {
              const int yb = tb == 1 ? 1 : 0;
              const int xb = tb == 0 ? 1 : 0;
              acc[hh * 3 + tb] += xi[xh] * xj[xb] * T[yh][yb];
              acm[hh * 3 + tb] += xj[xh] * xi[xb] * T[yb][yh];
            }
          }
        }
      }
      if (__any_sync(kFull, touch)) {
        for (int o = 1; o < (1 << q.lg); o <<= 1) {
#pragma unroll
          for (int n = 0; n < 9; ++n) {
            acc[n] += __shfl_xor_sync(kFull, acc[n], o);
            acm[n] += __shfl_xor_sync(kFull, acm[n], o);
          }
        }
      }
      if (has && q.g == 0) {
#pragma unroll
        for (int n = 0; n < 9; ++n) {
          const int idx = (9 * half + n) * KK;
          s.sraw[idx + i * K + j] = acc[n];
          if (i != j) s.sraw[idx + j * K + i] = acm[n];
        }
      }
    }
  }
  __syncthreads();
}

// The Fisher pairs of a position sweep: the 9 entries F needs per star pair
// (hp = hp_of_type(ta) against tb) from 4 row products, written to (i, j)
// and, mirrored, (j, i).  A lane group takes a 2 x 2 tile of star pairs
// (in y order, stars 2 bi, 2 bi + 1 against 2 bj, 2 bj + 1, bi <= bj): 16
// row products against 1/lam on its 4 columns, over the rows where some
// pair's profiles are both non-zero (elsewhere its terms are exact zeros),
// then each pair's 9 sums in turn.
__device__ void fisher_pairs(const Params& P, const Work& s) {
  const int K = s.K, H = P.H, fs = s.fs, hp = s.hp, KK = K * K;
  const int nb = (K + 1) >> 1;
  const int n_tiles = nb * (nb + 1) / 2;
  const PairLanes q = pair_lanes(fs);
  for (int base = 0; base < n_tiles; base += q.per_round) {
    const int u = base + q.slot;
    const bool has = u < n_tiles;
    int bi, bj;
    pair_of(has ? u : 0, nb, bi, bj);
    // the tile's stars in y order; a star past the last (odd K) is read as
    // the block's first and never written, and on the diagonal the pair
    // (second, first) repeats (first, second)
    const bool odd_i = 2 * bi + 1 >= K, odd_j = 2 * bj + 1 >= K;
    const int li[2] = {s.ord[2 * bi], s.ord[odd_i ? 2 * bi : 2 * bi + 1]};
    const int lj[2] = {s.ord[2 * bj], s.ord[odd_j ? 2 * bj : 2 * bj + 1]};
    const bool live[4] = {true, !odd_j, !odd_i && bi != bj, !odd_i && !odd_j};
    // the pairs that share a pixel where both stars' profiles are non-zero
    // (the others' sums are exact zeros: +0) and the rows where some of
    // them has both row profiles non-zero (elsewhere every row product is
    // exactly zero)
    bool touch[4];
    int lo = H, hi = -1;
#pragma unroll
    for (int pp = 0; pp < 4; ++pp) {
      const int a = li[pp >> 1], b = lj[pp & 1];
      touch[pp] = has && live[pp] && overlap(s, a, b);
      if (touch[pp]) {
        lo = min(lo, max(s.ylo[a], s.ylo[b]));
        hi = max(hi, min(s.yhi[a], s.yhi[b]));
      }
    }
    const bool work = has && q.g < q.n_chunks;
    float t[16][4];  // [(ii 2 + jj) 4 + ya 2 + yb][column]
#pragma unroll
    for (int n = 0; n < 64; ++n) (&t[0][0])[n] = 0.f;
    if (work) {
      // offsets into the shared array rather than pointers: fewer registers
      const int g0 = static_cast<int>(s.gyy - b6c_smem);
      const int oa = g0 + 2 * li[0] * hp, ob = g0 + 2 * li[1] * hp;
      const int oc = g0 + 2 * lj[0] * hp, od = g0 + 2 * lj[1] * hp;
      const int orc = static_cast<int>(s.r1 - b6c_smem) + 4 * q.g;
#pragma unroll 2
      for (int h = lo; h <= hi; ++h) {
        const float2 va = load2(b6c_smem + oa + 2 * h), vb = load2(b6c_smem + ob + 2 * h);
        const float2 vc = load2(b6c_smem + oc + 2 * h), vd = load2(b6c_smem + od + 2 * h);
        const float a[2][2] = {{va.x, va.y}, {vb.x, vb.y}};
        const float b[2][2] = {{vc.x, vc.y}, {vd.x, vd.y}};
        const float4 r4 = load4(b6c_smem + orc + h * fs);
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
            for (int ya = 0; ya < 2; ++ya) {
#pragma unroll
              for (int yb = 0; yb < 2; ++yb) {
                const float pr = a[ii][ya] * b[jj][yb];
                float* tt = t[(ii * 2 + jj) * 4 + ya * 2 + yb];
#pragma unroll
                for (int k = 0; k < 4; ++k) tt[k] += pr * comp(r4, k);
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int pp = 0; pp < 4; ++pp) {
      const int ii = pp >> 1, jj = pp & 1;
      const int i = li[ii], j = lj[jj];
      float acc[9];
#pragma unroll
      for (int n = 0; n < 9; ++n) acc[n] = 0.f;
      if (work && touch[pp]) {
        // the column profiles a column at a time, so that few are live beside t
        const int ci = li[ii] * fs + 4 * q.g, cj = lj[jj] * fs + 4 * q.g;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float xi[2] = {s.gx[ci + k], s.gx1[ci + k]};
          const float xj[2] = {s.gx[cj + k], s.gx1[cj + k]};
#pragma unroll
          for (int ta = 0; ta < 3; ++ta) {
            const int yh = ta == 1 ? 1 : 0, xh = ta == 0 ? 1 : 0;  // hp_of_type(ta)
#pragma unroll
            for (int tb = 0; tb < 3; ++tb) {
              const int yb = tb == 1 ? 1 : 0, xb = tb == 0 ? 1 : 0;
              acc[ta * 3 + tb] += xi[xh] * xj[xb] * t[pp * 4 + yh * 2 + yb][k];
            }
          }
        }
      }
      if (__any_sync(kFull, touch[pp])) {
        for (int o = 1; o < (1 << q.lg); o <<= 1) {
#pragma unroll
          for (int n = 0; n < 9; ++n) acc[n] += __shfl_xor_sync(kFull, acc[n], o);
        }
      }
      if (has && q.g == 0 && live[pp]) {
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
  }
  __syncthreads();
}

// coef_a of J_a for type t of star i: (w cx, w cy, w)
__device__ __forceinline__ float jcoef(const Work& s, int t, int i) {
  return t == 0 ? s.wcx[i] : (t == 1 ? s.wcy[i] : s.w[i]);
}

// The lower triangle of G = beta F + diag(info + (1 - m) + jitter) into
// s.dense, packed by columns with D + 1 rows, from s.sraw (columns over
// warps, rows over lanes), info' into s.infod when `with_infod`, and `rhs`
// (D, or null) into row D, where the factorisation turns it into L^-1 rhs.
// Ends synchronised.
template <typename Off = int>
__device__ void assemble_metric(const Params& P, const Work& s, float beta,
                                bool with_infod, const float* rhs) {
  const int tid = thread_index(), lane = tid & 31, warp = tid >> 5;
  const int K = s.K, D = s.D, n1 = D + 1;
  for (int cb = warp; cb < D; cb += kWarps) {
    const int tb = type_of(cb, K), j = cb - tb * K;
    const float cbj = jcoef(s, tb, j);
    float* col = s.dense + col_off<Off>(cb, n1) - cb;  // col[r] = G(r, cb)
    for (int ra = cb + lane; ra < D; ra += 32) {
      const int ta = type_of(ra, K), i = ra - ta * K;
      const float f = jcoef(s, ta, i) * cbj
                      * s.sraw[plane_off<Off>(hp_of_type(ta) * 3 + tb, K) + i * K + j];
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
      col[ra] = g;
    }
  }
  if (rhs != nullptr)
    for (int c = tid; c < D; c += kThreads) s.dense[col_off<Off>(c, n1) - c + D] = rhs[c];
  __syncthreads();
}

// Cholesky of the first D rows of s.dense (packed by columns, D + 1 rows a
// column) in shared memory; cholesky_panels is the blocked right-looking
// form, in panels of 32 columns, for D >= kPanelMinD, cholesky_columns the
// unblocked one below it.
// A panel lives in registers while it is factored: lane l holds column
// p0 + l, warp w the rows p0 + w + 16 m.  At each of its columns j the
// lanes that hold column j publish it to a shared column buffer (two
// alternate, so one block barrier a column), and every thread forms
// 1 / sqrt(s_jj) and updates its own entries of the later columns,
// A_rc -= (A_rj / L_jj)(A_cj / L_jj).  The panel goes back to shared memory
// and updates the trailing matrix, A_rc -= sum over the panel of L_rk L_ck
// (lanes over columns, each holding its column's panel entries; warps over
// rows, whose panel entries every lane reads at once).  Each entry takes its
// updates in column order, as the dot-product form does.  s.dense then
// holds L below the diagonal, s.ldiag its diagonal and s.dinv
// 1 / sqrt(s_jj).  Rows D .. nrows - 1 (a right-hand side b in row D) are
// reduced alongside, which leaves L^-1 b in row D.  A non-positive pivot
// makes NaN that reaches every later column.  With `logdet`, warp 0 writes
// log det G to s.scal[1], the dead slots' identity rows (diagonal `ldead`
// of L) included.  Every thread calls it; it ends synchronised but for
// s.scal[1].
constexpr int kPanel = 32;                                // columns of a panel: a warp's lanes
constexpr int kPanelRows = (3 * kMaxStars + 1 + kWarps - 1) / kWarps;  // rows a thread holds

__device__ void cholesky_panels(const Work& s, int nrows) {
  const int tid = thread_index(), lane = tid & 31, warp = tid >> 5;
  const int D = s.D, n1 = D + 1;
  float* A = s.dense;
  float* colbuf = s.dense + packed_l(D);  // two column buffers of n1
  float* prow = s.dense + chol_prow(D);   // prow[(r - p0) kPanelLd + k] = L(r, p0 + k)
  for (int p0 = 0; p0 < D; p0 += kPanel) {
    const int p1 = min(p0 + kPanel, D);
    const int c = p0 + lane;  // this lane's column of the panel
    const bool col_ok = c < p1;
    float* ac = A + col_off(col_ok ? c : p0, n1) - (col_ok ? c : p0);  // ac[r] = A(r, c)
    float v[kPanelRows];
#pragma unroll
    for (int m = 0; m < kPanelRows; ++m) {
      const int r = p0 + warp + kWarps * m;
      v[m] = (col_ok && r >= c && r < nrows) ? ac[r] : 0.0f;
    }
    for (int j = p0; j < p1; ++j) {
      float* buf = colbuf + ((j - p0) & 1) * n1;
      if (lane == j - p0) {
#pragma unroll
        for (int m = 0; m < kPanelRows; ++m) {
          const int r = p0 + warp + kWarps * m;
          if (r >= j && r < nrows) buf[r] = v[m];
        }
      }
      __syncthreads();
      const float sjj = buf[j];
      const float dinv = 1.0f / sqrtf(sjj);
      if (tid == 0) {
        s.ldiag[j] = sjj * dinv;
        s.dinv[j] = dinv;
      }
      if (lane == j - p0) {
#pragma unroll
        for (int m = 0; m < kPanelRows; ++m) {
          const int r = p0 + warp + kWarps * m;
          if (r > j) v[m] = v[m] * dinv;
        }
      } else if (col_ok && c > j) {
        const float lc = buf[c] * dinv;
#pragma unroll
        for (int m = 0; m < kPanelRows; ++m) {
          const int r = p0 + warp + kWarps * m;
          if (r >= c && r < nrows) v[m] -= (buf[r] * dinv) * lc;
        }
      }
    }
    // L's panel back into its columns, and by rows for the trailing update
    // (0 on and above the diagonal there, and past the panel's last column)
#pragma unroll
    for (int m = 0; m < kPanelRows; ++m) {
      const int r = p0 + warp + kWarps * m;
      if (r < nrows) {
        if (col_ok && r > c) ac[r] = v[m];
        prow[(r - p0) * kPanelLd + lane] = (col_ok && r > c) ? v[m] : 0.0f;
      }
    }
    __syncthreads();
    if (p1 == D) break;  // nothing trails the last panel
    // the trailing update: A_rc -= sum_k L_rk L_ck over the panel, r >= c;
    // lanes over columns, warps over rows
    for (int c0 = p1; c0 < D; c0 += 32) {
      const int cc = c0 + lane;
      const bool ok = cc < D;
      float lc[kPanel];  // L(cc, p0 + k)
      const float* pc = prow + ((ok ? cc : p1) - p0) * kPanelLd;
#pragma unroll
      for (int k = 0; k < kPanel; ++k) lc[k] = pc[k];
      float* acc_col = A + col_off(ok ? cc : p1, n1) - (ok ? cc : p1);
      for (int r = c0 + warp; r < nrows; r += kWarps) {
        const float* pr = prow + (r - p0) * kPanelLd;
        float a = ok && r >= cc ? acc_col[r] : 0.0f;
#pragma unroll
        for (int k = 0; k < kPanel; k += 4) {
          const float4 l4 = load4(pr + k);
          a -= l4.x * lc[k];
          a -= l4.y * lc[k + 1];
          a -= l4.z * lc[k + 2];
          a -= l4.w * lc[k + 3];
        }
        if (ok && r >= cc) acc_col[r] = a;
      }
    }
    __syncthreads();
  }
}

// The same factorisation unblocked, for small D, where a panel's barriers
// outweigh what its register tiles save: at column j every thread forms
// 1 / sqrt(s_jj), every warp updates its trailing columns (a column a warp,
// rows over lanes), one block barrier a column, and the columns are scaled
// at the end.  The same operations in the same order as cholesky_panels.
__device__ void cholesky_columns(const Work& s, int nrows) {
  const int tid = thread_index(), lane = tid & 31, warp = tid >> 5;
  const int D = s.D, n1 = D + 1;
  float* A = s.dense;
  for (int j = 0; j < D; ++j) {
    const float* cj = A + col_off(j, n1) - j;  // cj[r] = A(r, j)
    const float sjj = cj[j];
    const float dinv = 1.0f / sqrtf(sjj);
    if (tid == 0) {
      s.ldiag[j] = sjj * dinv;
      s.dinv[j] = dinv;
    }
    for (int c = j + 1 + warp; c < D; c += kWarps) {
      float* cc = A + col_off(c, n1) - c;
      const float lc = cj[c] * dinv;
      for (int r = c + lane; r < nrows; r += 32) cc[r] -= (cj[r] * dinv) * lc;
    }
    __syncthreads();
  }
  for (int j = warp; j < D; j += kWarps) {
    float* cj = A + col_off(j, n1) - j;
    const float dinv = s.dinv[j];
    for (int r = j + 1 + lane; r < nrows; r += 32) cj[r] = cj[r] * dinv;
  }
  __syncthreads();
}

// the factorisation's form by D: panels from kPanelMinD parameters up
constexpr int kPanelMinD = 96;

__device__ void cholesky(const Work& s, int nrows, bool logdet, float ldead) {
  const int lane = thread_index() & 31, warp = thread_index() >> 5;
  const int D = s.D;
  if (D >= kPanelMinD) cholesky_panels(s, nrows);
  else cholesky_columns(s, nrows);
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
// cholesky(nrows = D + 1) left L^-1 b in row D: the lanes hold y = L^-1 b
// (rows lane + 32 q); for k = D - 1 .. 0, out_k = y_k / L_kk from its
// owner by a shuffle, then y_r -= L_kr out_k for r < k in every lane.
// Ends synchronised.
__device__ void chol_solve(const Work& s, float* out) {
  const int D = s.D, n1 = D + 1;
  if (thread_index() < 32) {
    const int lane = thread_index();
    float y[kRows];
    int row0[kRows];  // row 0 of the lane's columns r: L(k, r) at row0 + k
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int r = lane + 32 * q;
      row0[q] = r < D ? col_off(r, n1) - r : 0;
      y[q] = r < D ? s.dense[row0[q] + D] : 0.0f;
    }
    for (int k = D - 1; k >= 0; --k) {
      // y's entry k, from its lane's registers by a select chain (an
      // indexed register array would go to local memory)
      const int qk = k >> 5;
      float own = y[0];
#pragma unroll
      for (int q = 1; q < kRows; ++q) own = qk == q ? y[q] : own;
      const float xk = __shfl_sync(kFull, own, k & 31) * s.dinv[k];
      if (lane == (k & 31)) out[k] = xk;
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int r = lane + 32 * q;
        if (r < k) y[q] -= s.dense[row0[q] + k] * xk;
      }
    }
  }
  __syncthreads();
}

// The q field's coefficient table from s.ginv: the star pairs that share a
// pixel where both stars' profiles are non-zero (every other pair's terms
// are exact zeros), in (i, j) order, their number into s.scal[4] (a float
// on the one-tile path, its int's bits on the wide one: q_pairs); for each,
// the nine G^-1 (ta K + i, tb K + j) coef_ta,i coef_tb,j, doubled for i < j,
// then i and j.  Every thread calls it; it ends synchronised.
template <typename Off = int>
__device__ void q_table(const Work& s) {
  const int tid = thread_index(), lane = tid & 31, warp = tid >> 5;
  const int K = s.K, D = s.D;
  for (int i = warp; i < K; i += kWarps) {
    int n = 0;
    for (int j0 = i; j0 < K; j0 += 32) {
      const int j = j0 + lane;
      n += __popc(__ballot_sync(kFull, j < K && overlap(s, i, j)));
    }
    if (lane == 0) s.qrow[i] = n;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int i = 0; i < K; ++i) {
      const int c = s.qrow[i];
      s.qrow[i] = n;
      n += c;
    }
    // at most 2080 pairs on the one-tile path; beyond 2^24 pairs (K > 5792
    // on the wide one) a float no longer holds every count
    s.scal[4] = sizeof(Off) == sizeof(int) ? static_cast<float>(n) : __int_as_float(n);
  }
  __syncthreads();
  for (int i = warp; i < K; i += kWarps) {
    int u = s.qrow[i];
    for (int j0 = i; j0 < K; j0 += 32) {
      const int j = j0 + lane;
      const bool ov = j < K && overlap(s, i, j);
      const unsigned bal = __ballot_sync(kFull, ov);
      const int at = u + __popc(bal & ((1u << lane) - 1u));
      u += __popc(bal);
      if (!ov) continue;
      float* e = s.qcoef + coef_off<Off>(at);
      const float m = i == j ? 1.0f : 2.0f;
      const float ci[3] = {s.wcx[i], s.wcy[i], s.w[i]};
      const float cj[3] = {s.wcx[j], s.wcy[j], s.w[j]};
      // g[ta K D + tb K] = G^-1(ta K + i, tb K + j)
      const float* g = s.ginv + row_off<Off>(i, D) + j;
      const Off KD = row_off<Off>(K, D);
      // T(0,0) = e0 P00, T(0,1) = e1 P01 + e2 P00, T(1,0) = e3 P10 + e4 P00,
      // T(1,1) = e5 P11 + e6 P10 + e7 P01 + e8 P00 (q_operands)
      e[0] = m * g[0] * ci[0] * cj[0];
      e[1] = m * g[K] * ci[0] * cj[1];
      e[2] = m * g[2 * K] * ci[0] * cj[2];
      e[3] = m * g[KD] * ci[1] * cj[0];
      e[4] = m * g[2 * KD] * ci[2] * cj[0];
      e[5] = m * g[KD + K] * ci[1] * cj[1];
      e[6] = m * g[KD + 2 * K] * ci[1] * cj[2];
      e[7] = m * g[2 * KD + K] * ci[2] * cj[1];
      e[8] = m * g[2 * KD + 2 * K] * ci[2] * cj[2];
      e[9] = static_cast<float>(i);
      e[10] = static_cast<float>(j);
      e[11] = 0.0f;
    }
  }
  __syncthreads();
}

// L^-1 packed by columns after L in shared memory, one column per warp at a
// time by forward substitution on L e_c (x_k = r_k / L_kk as r_k / sqrt(s_kk)
// with the factorisation's 1 / sqrt(s_kk)); then G^-1 = L^-T L^-1 into s.ginv
// (its lower half computed, both written) and the q field's coefficient
// table (q_table).  Every thread calls it; it ends synchronised.
__device__ void inverse(const Work& s) {
  const int tid = thread_index(), lane = tid & 31, warp = tid >> 5;
  const int D = s.D, n1 = D + 1;
  const float* A = s.dense;
  float* X = s.dense + packed_l(D);
  for (int c = warp; c < D; c += kWarps) {
    float acc[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) acc[q] = lane + 32 * q == c ? 1.0f : 0.0f;
    float* xc = X + col_off(c, D) - c;  // xc[r] = L^-1(r, c)
    for (int k = c; k < D; ++k) {
      const int qk = k >> 5;  // a select chain, as chol_solve's
      float own = acc[0];
#pragma unroll
      for (int q = 1; q < kRows; ++q) own = qk == q ? acc[q] : own;
      const float xk = __shfl_sync(kFull, own, k & 31) * s.dinv[k];
      if (lane == (k & 31)) xc[k] = xk;
      const float* lk = A + col_off(k, n1) - k;  // column k of L
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int r = lane + 32 * q;
        if (r > k && r < D) acc[q] -= lk[r] * xk;
      }
    }
  }
  __syncthreads();
  for (int a = warp; a < D; a += kWarps) {
    const float* xa = X + col_off(a, D) - a;
    for (int b = lane; b <= a; b += 32) {
      const float* xb = X + col_off(b, D) - b;
      float acc = 0.0f;
      for (int k = a; k < D; ++k) acc += xa[k] * xb[k];
      s.ginv[a * D + b] = acc;
      s.ginv[b * D + a] = acc;
    }
  }
  __syncthreads();
  q_table(s);
}

// out = G^-1 p with the carried s.ginv (D threads; G^-1 is symmetric, so
// thread a runs down column a, and a warp's loads are contiguous).  Ends
// synchronised.
__device__ void ginv_matvec(const Work& s, const float* p, float* out) {
  const int tid = thread_index();
  const int D = s.D;
  if (tid < D) {
    float acc = 0.0f;
    for (int b = 0; b < D; ++b) acc += s.ginv[b * D + tid] * p[b];
    out[tid] = acc;
  }
  __syncthreads();
}

// Chunk n of the q coefficient table (kQPairs pairs) into ring slot `slot`
// by cp.async; the issuing threads wait for it before the next barrier.
template <typename Off = int>
__device__ __forceinline__ void stage_qcoef(const Work& s, int n, int slot) {
  const int tid = thread_index();
  constexpr int kVec = kQPairs * kCoef / 4;
  if (tid < kVec) {
    cp_async16(s.qc + slot * kQPairs * kCoef + 4 * tid,
               s.qcoef + coef_off<Off>(n * kQPairs) + 4 * tid);
    cp_async_commit();
  }
}

// The q field's GEMM operands of chunk n into `buf` from ring slot `slot`:
// T (kQK, Hq), the row terms of each pair's four column-profile
// combinations, and X (kQK, Wq), those combinations of the column profiles;
// zero past the field and past the last pair, and the pairs' row ranges.
// Four groups of 128 threads, rows or columns over a group's threads.
__device__ void q_operands(const Params& P, const Work& s, int n, int slot, float* buf) {
  const int tid = thread_index();
  const int H = P.H, fs = s.fs, hp = s.hp, Hq = s.Hq, Wq = s.Wq;
  const int n_pairs = static_cast<int>(s.scal[4]);  // the q field's pairs (inverse)
  const float* coef = s.qc + slot * kQPairs * kCoef;
  float* T = buf;
  float* X = buf + kQK * Hq;
  if (tid < kQPairs) {
    // the rows where both stars' row profiles are non-zero (none past the
    // last pair); T is exactly zero elsewhere
    int* rng = reinterpret_cast<int*>(X + kQK * Wq);
    int lo = 1, hi = 0;
    if (n * kQPairs + tid < n_pairs) {
      const float* e = coef + tid * kCoef;
      const int i = static_cast<int>(e[9]), j = static_cast<int>(e[10]);
      lo = max(s.ylo[i], s.ylo[j]);
      hi = min(s.yhi[i], s.yhi[j]);
    }
    rng[tid] = lo;
    rng[kQPairs + tid] = hi;
  }
  const int r = tid & 127;
  for (int pl = tid >> 7; pl < kQPairs; pl += kThreads / 128) {
    const float* e = coef + pl * kCoef;
    const bool live = n * kQPairs + pl < n_pairs;
    const int i = live ? static_cast<int>(e[9]) : 0, j = live ? static_cast<int>(e[10]) : 0;
    if (r < Hq) {
      float t0 = 0.f, t1 = 0.f, t2 = 0.f, t3 = 0.f;
      if (live && r < H) {
        const float2 vi = load2(s.gyy + 2 * (i * hp + r)), vj = load2(s.gyy + 2 * (j * hp + r));
        const float yi = vi.x, yi1 = vi.y, yj = vj.x, yj1 = vj.y;
        const float p00 = yi * yj, p01 = yi * yj1, p10 = yi1 * yj, p11 = yi1 * yj1;
        t0 = e[0] * p00;
        t1 = e[1] * p01 + e[2] * p00;
        t2 = e[3] * p10 + e[4] * p00;
        t3 = ((e[5] * p11 + e[6] * p10) + e[7] * p01) + e[8] * p00;
      }
      float* tc = T + 4 * pl * Hq + r;
      tc[0] = t0; tc[Hq] = t1; tc[2 * Hq] = t2; tc[3 * Hq] = t3;
    }
    if (r < Wq) {
      float x0 = 0.f, x1 = 0.f, x2 = 0.f, x3 = 0.f;
      if (live && r < fs) {
        const float gi = s.gx[i * fs + r], gi1 = s.gx1[i * fs + r];
        const float gj = s.gx[j * fs + r], gj1 = s.gx1[j * fs + r];
        x0 = gi1 * gj1; x1 = gi1 * gj; x2 = gi * gj1; x3 = gi * gj;
      }
      float* xc = X + 4 * pl * Wq + r;
      xc[0] = x0; xc[Wq] = x1; xc[2 * Wq] = x2; xc[3 * Wq] = x3;
    }
  }
}

// TR consecutive floats from shared memory (TR = 2 or 4, aligned)
template <int N>
__device__ __forceinline__ void load_n(const float* p, float* v) {
  if (N == 4) {
    const float4 a = load4(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x; v[1] = a.y;
  }
}

// q(p) = sum_ab Ginv_ab J_a(p) J_b(p) into s.fld: the GEMM of the header
// note, a TR x TC pixel tile a thread, chunks of kQPairs pairs through two
// operand stages over s.r1 and the coefficient ring; each pixel sums the
// pairs in order, a warp skipping the pairs whose row profiles vanish on
// all its rows (their terms are exact zeros there).  Ends synchronised.
template <int TR, int TC>
__device__ void q_gemm(const Params& P, const Work& s) {
  const int tid = thread_index();
  const int H = P.H, fs = s.fs, Hq = s.Hq, Wq = s.Wq;
  // the star pairs that share a pixel where both profiles are non-zero
  // (inverse); none: q is 0
  const int n_pairs = static_cast<int>(s.scal[4]);
  const int n_chunks = (n_pairs + kQPairs - 1) / kQPairs;
  const int tiles_c = Wq / TC, n_tiles = (Hq / TR) * tiles_c;
  const bool mine = tid < n_tiles;
  const int tr = mine ? tid / tiles_c : 0;
  // the tile's column groups of 4, 4 tiles_c apart, so that a warp's loads
  // of a group are one contiguous run
  const int r0 = tr * TR, c0 = mine ? 4 * (tid - tr * tiles_c) : 0, cstep = 4 * tiles_c;
  const int stage = q_stage(H, P.W);
  // the rows of the warp's tiles
  const int w0 = tid & ~31;
  const int wlo = (w0 / tiles_c) * TR, whi = ((w0 + 31) / tiles_c) * TR + TR - 1;
  float acc[TR][TC];
#pragma unroll
  for (int n = 0; n < TR * TC; ++n) (&acc[0][0])[n] = 0.f;
  stage_qcoef(s, 0, 0);
  cp_async_wait_all();
  __syncthreads();
  q_operands(P, s, 0, 0, s.qbuf);
  if (n_chunks > 1) stage_qcoef(s, 1, 1);
  cp_async_wait_all();
  __syncthreads();
  for (int n = 0; n < n_chunks; ++n) {
    const float* T = s.qbuf + (n & 1) * stage;
    const float* X = T + kQK * Hq;
    if (n + 1 < n_chunks) q_operands(P, s, n + 1, (n + 1) & 1, s.qbuf + ((n + 1) & 1) * stage);
    if (n + 2 < n_chunks) stage_qcoef(s, n + 2, n & 1);
    if (mine) {
      const int* rng = reinterpret_cast<const int*>(X + kQK * Wq);
      for (int pl = 0; pl < kQPairs; ++pl) {
        // a pair whose row profiles vanish on the warp's rows adds exact zeros
        if (rng[kQPairs + pl] < wlo || rng[pl] > whi) continue;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int k = 4 * pl + kk;
          float tv[TR], xv[TC];
          load_n<TR>(T + k * Hq + r0, tv);
#pragma unroll
          for (int g = 0; g < TC / 4; ++g) load_n<4>(X + k * Wq + c0 + g * cstep, xv + 4 * g);
#pragma unroll
          for (int ri = 0; ri < TR; ++ri) {
#pragma unroll
            for (int ci = 0; ci < TC; ++ci) acc[ri][ci] += tv[ri] * xv[ci];
          }
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }
  if (mine) {
#pragma unroll
    for (int ri = 0; ri < TR; ++ri) {
      if (r0 + ri >= H) break;
#pragma unroll
      for (int g = 0; g < TC / 4; ++g)
        if (c0 + g * cstep < fs)
          store4(s.fld + (r0 + ri) * fs + c0 + g * cstep, acc[ri][4 * g], acc[ri][4 * g + 1],
                 acc[ri][4 * g + 2], acc[ri][4 * g + 3]);
    }
  }
  __syncthreads();
}

// the pixel tile of the q and phi fields: 2 x 4 where that fills the block
// at most, else 4 x 8
__device__ __forceinline__ bool small_tiles(const Work& s) {
  return (s.Hq / 2) * (s.Wq / 4) <= kThreads;
}

__device__ void q_field(const Params& P, const Work& s) {
  if (small_tiles(s)) q_gemm<2, 4>(P, s);
  else q_gemm<4, 8>(P, s);
}

// phi(p) / lam(p), phi = sum_b a_b J_b(p) from the per-star a_b coef_b in
// s.cu, s.cv, s.cs, over 1/lam in s.r1 (which dh_dtheta restores after
// the contraction): a TR x TC pixel tile a thread, the stars in order.
template <int TR, int TC>
__device__ void phi_tiles(const Params& P, const Work& s) {
  const int tid = thread_index();
  const int K = s.K, H = P.H, fs = s.fs, hp = s.hp, Hq = s.Hq, Wq = s.Wq;
  const int tiles_c = Wq / TC, n_tiles = (Hq / TR) * tiles_c;
  if (tid < n_tiles) {
    const int tr = tid / tiles_c;
    // column groups of 4, 4 tiles_c apart, as q_gemm's
    const int r0 = tr * TR, c0 = 4 * (tid - tr * tiles_c), cstep = 4 * tiles_c;
    const int w0 = tid & ~31;  // the rows of the warp's tiles
    const int wlo = (w0 / tiles_c) * TR, whi = ((w0 + 31) / tiles_c) * TR + TR - 1;
    int rows[TR];
#pragma unroll
    for (int ri = 0; ri < TR; ++ri) rows[ri] = r0 + ri < H ? r0 + ri : H - 1;
    float phi[TR][TC];
#pragma unroll
    for (int n = 0; n < TR * TC; ++n) (&phi[0][0])[n] = 0.f;
    for (int i = 0; i < K; ++i) {
      // a star whose row profiles vanish on the warp's rows adds exact zeros
      if (s.yhi[i] < wlo || s.ylo[i] > whi) continue;
      const float cu = s.cu[i], cv = s.cv[i], cs = s.cs[i];
      float gx[TC], gx1[TC];
#pragma unroll
      for (int g = 0; g < TC / 4; ++g) {
        if (c0 + g * cstep < fs) {
          load_n<4>(s.gx + i * fs + c0 + g * cstep, gx + 4 * g);
          load_n<4>(s.gx1 + i * fs + c0 + g * cstep, gx1 + 4 * g);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) gx[4 * g + k] = gx1[4 * g + k] = 0.f;
        }
      }
      float tx[TC], vx[TC];
#pragma unroll
      for (int ci = 0; ci < TC; ++ci) {
        tx[ci] = cu * gx1[ci] + cs * gx[ci];
        vx[ci] = cv * gx[ci];
      }
#pragma unroll
      for (int ri = 0; ri < TR; ++ri) {
        const float2 v = load2(s.gyy + 2 * (i * hp + rows[ri]));
        const float y = v.x, y1 = v.y;
#pragma unroll
        for (int ci = 0; ci < TC; ++ci) {
          phi[ri][ci] = phi[ri][ci] + y * tx[ci];
          phi[ri][ci] = phi[ri][ci] + y1 * vx[ci];
        }
      }
    }
    // phi / lam over 1/lam, pixel by pixel (each thread its own)
#pragma unroll
    for (int ri = 0; ri < TR; ++ri) {
      if (r0 + ri >= H) break;
#pragma unroll
      for (int g = 0; g < TC / 4; ++g) {
        if (c0 + g * cstep < fs) {
          float* r1 = s.r1 + (r0 + ri) * fs + c0 + g * cstep;
          const float4 r = load4(r1);
          store4(r1, phi[ri][4 * g] * r.x, phi[ri][4 * g + 1] * r.y, phi[ri][4 * g + 2] * r.z,
                 phi[ri][4 * g + 3] * r.w);
        }
      }
    }
  }
  __syncthreads();
}

__device__ void phi_field(const Params& P, const Work& s) {
  if (small_tiles(s)) phi_tiles<2, 4>(P, s);
  else phi_tiles<4, 8>(P, s);
}

// Warp 0, after the rho contraction at th_b: the prior's terms, grad U_beta
// into t1 (to which the metric terms are added) and U_beta, from the
// log-likelihood `ll`, into s.scal[0].
__device__ void potential_terms(const Params& P, const Work& s, float beta, double ll) {
  const int lane = thread_index() & 31;
  const int K = s.K;
  double lp = 0.0;
  for (int i = lane; i < K; i += 32) {
    const float u = s.th_b[i], v = s.th_b[K + i], sl = s.th_b[2 * K + i];
    const float m = s.m[i];
    const float lp_pos = -(softplusf(u) + softplusf(-u) + softplusf(v) + softplusf(-v));
    const float zf = (sl - P.logf_mean) / P.logf_sigma;
    const float lp_flux = -0.5f * zf * zf + P.lp_flux_const;
    lp += static_cast<double>((lp_pos + lp_flux) * m);
    // grad U_beta into t1, to which metric_terms adds the metric terms
    s.t1[i] = -(s.wcx[i] * s.dots[i] + (1.0f - 2.0f * s.su[i]) * m);
    s.t1[K + i] = -(s.wcy[i] * s.dots[3 * K + i] + (1.0f - 2.0f * s.sv[i]) * m);
    s.t1[2 * K + i] = -(s.w[i] * s.dots[5 * K + i] + (-zf / P.logf_sigma) * m);
  }
  lp = warp_sum_d(lp);
  if (lane == 0) s.scal[0] = static_cast<float>(-(static_cast<double>(beta) * ll + lp));
}

// After the q contraction:
// t1_c += beta sum_{a in star i} sum_b Ginv_ab S_acb - beta/2 sum_p q J_c R2
//         + 1/2 Ginv_cc info'_c, one warp a parameter c, lanes over stars j,
// with S assembled from Sraw: S[m][tb][i][j] = coef_tb,j sum_terms coefH_i
// Sraw[hp][tb][i][j].  Ends synchronised.
template <typename Off = int>
__device__ void metric_terms(const Params& P, const Work& s, float beta) {
  const int lane = thread_index() & 31, warp = thread_index() >> 5;
  const int K = s.K, D = s.D;
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
      const float* grow = s.ginv + row_off<Off>(ta * K + i, D);
      for (int tb = 0; tb < 3; ++tb) {
        const float* q0 = s.sraw + plane_off<Off>(hp0 * 3 + tb, K) + i * K;
        const float* q1 = hp1 >= 0 ? s.sraw + plane_off<Off>(hp1 * 3 + tb, K) + i * K : nullptr;
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
                + 0.5f * s.ginv[row_off<Off>(c, D) + c] * s.infod[c];
    }
  }
  __syncthreads();
}

// Everything theta-dependent at th_b: profiles, 1/lam, U_beta (scal[0]),
// log det G (scal[1]), the factor L's diagonal (ldiag, dinv), G^-1, info'
// and t1; with `p0`, also p0 = (L xi) m into p_b from the factor, xi in vec.
// Every thread calls it; it ends synchronised, the field phase's arrays in
// place.  Each pass makes its own Work (make_work).
__device__ void build_structs(const Params& P, bool p0) {
  const int tid = thread_index(), warp = tid >> 5;
  const float beta = make_work(P).scal[8];
  double ll;
  { const Work s = make_work(P); profiles(P, s, s.th_b, true); }
  { const Work s = make_work(P); ll = render(P, s, beta, true); }
  {
    // gy'' over the column profiles for the pair contractions, which read
    // the column profiles' copies
    const Work s = make_work(P);
    for (int n = tid; n < s.K * s.hp; n += kThreads) s.gy2[n] = s.gy2g[n];
  }
  __syncthreads();
  { const Work s = make_work(P); pair_contract(P, s); }
  { const Work s = make_work(P); contract<kGrad>(P, s); }
  if (warp == 0) potential_terms(P, make_work(P), beta, ll);
  // the dense phase over the field phase's arrays
  { const Work s = make_work(P); assemble_metric(P, s, beta, true, nullptr); }  // synchronises
  {
    // a dead slot's diagonal of L: its identity row of G plus the jitter,
    // factored as the kernel factors a pivot
    const float gdead = 1.0f + P.jitter;
    const Work s = make_work(P);
    cholesky(s, s.D, true, gdead * (1.0f / sqrtf(gdead)));
  }
  if (p0) {
    // p0 = (L xi) m, L the factor of G(theta0)
    const Work s = make_work(P);
    const int K = s.K, D = s.D, n1 = D + 1;
    if (tid < D) {
      float acc = s.ldiag[tid] * s.vec[tid];
      for (int k = 0; k < tid; ++k) acc += s.dense[col_off(k, n1) - k + tid] * s.vec[k];
      s.p_b[tid] = acc * s.m[tid - type_of(tid, K) * K];
    }
    __syncthreads();
  }
  { const Work s = make_work(P); inverse(s); }
  // the field phase again: profiles and 1/lam around the q field, whose
  // operand stages take 1/lam's place
  { const Work s = make_work(P); profiles(P, s, s.th_b, false); }
  { const Work s = make_work(P); q_field(P, s); }
  { const Work s = make_work(P); render(P, s, beta, false); }
  { const Work s = make_work(P); contract<kQ>(P, s); }
  metric_terms(P, make_work(P), beta);
}

// Parameter c's term of dH/dtheta that depends on a = G^-1 p (in s.a)
// after the phi field's contraction: out[c] = t1 + t2(a).
__device__ __forceinline__ void sweep_term(const Work& s, float beta, float* out, int c) {
  const int K = s.K;
  const int tc = type_of(c, K), i = c - tc * K;
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
  const float ac = s.a[c];
  out[c] = s.t1[c] + (-beta * sv + 0.5f * beta * ct - 0.5f * (ac * ac) * s.infod[c]);
}

// The terms of dH/dtheta that depend on a = G^-1 p: out = t1 + t2(a), a
// thread a parameter.
__device__ void sweep_terms(const Work& s, float beta, float* out) {
  const int tid = thread_index();
  if (tid < s.D) sweep_term(s, beta, out, tid);
  __syncthreads();
}

// dH/dtheta at the structs' theta and the momentum in ph into dh: t1 + t2(a).
__device__ void dh_dtheta(const Params& P) {
  const int tid = thread_index();
  const float beta = make_work(P).scal[8];
  {
    const Work s = make_work(P);
    ginv_matvec(s, s.ph, s.a);
    if (tid < s.K) {
      s.cu[tid] = s.a[tid] * s.wcx[tid];
      s.cv[tid] = s.a[s.K + tid] * s.wcy[tid];
      s.cs[tid] = s.a[2 * s.K + tid] * s.w[tid];
    }
  }
  __syncthreads();
  { const Work s = make_work(P); phi_field(P, s); }
  { const Work s = make_work(P); contract<kSweep>(P, s); }
  { const Work s = make_work(P); render(P, s, beta, false); }  // 1/lam again
  { const Work s = make_work(P); sweep_terms(s, beta, s.dh); }
}

// G(th)^-1 ph into vec by a fresh metric build at th (profiles, 1/lam, F,
// Cholesky with ph as its extra row, back substitution; no S, no q, no t1).
__device__ void fisher_solve(const Params& P) {
  const float beta = make_work(P).scal[8];
  { const Work s = make_work(P); profiles(P, s, s.th, false); }
  { const Work s = make_work(P); render(P, s, beta, false); }
  { const Work s = make_work(P); fisher_pairs(P, s); }
  { const Work s = make_work(P); assemble_metric(P, s, beta, false, s.ph); }
  { const Work s = make_work(P); cholesky(s, s.D + 1, false, 0.0f); }
  { const Work s = make_work(P); chol_solve(s, s.vec); }
}

// Relative sup-norm Picard delta max|x_new - x_old| / (1 + max|x_new|) over
// the D entries, NaN-propagating; returned to every thread.
__device__ float fp_delta(const Work& s, const float* x_new, const float* x_old) {
  const int tid = thread_index(), lane = tid & 31;
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
  const int tid = thread_index(), lane = tid & 31;
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

// One block an SM; each block takes the next chain from the workspace's
// counter until none is left.  Between passes a thread holds no more than
// its loop counters: the chain and its scalars live in shared memory.
__global__ void __launch_bounds__(kThreads, 1) fused_rhmc_crowded_kernel(Params P) {
  __shared__ int live[kMaxStars];     // the chain's live slots, in order
  __shared__ float live_m[kMaxStars];
  const int tid = thread_index();
  if (tid == 0) init_layout(P);

  for (;;) {
    __syncthreads();  // the layout is set; the previous chain's outputs are written
    if (tid == 0) b6c_chain = atomicAdd(reinterpret_cast<int*>(P.work), 1);
    __syncthreads();
    if (b6c_chain >= P.C) break;
    {
      const int c = b6c_chain, Ks = P.K, Ds = 3 * Ks;
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
        b6c_lay[kLyK] = n;
      }
      // every slot as it went in, with momentum 0; the live ones are
      // overwritten at the end
      for (int n = tid; n < Ds; n += kThreads) {
        P.theta_out[c * Ds + n] = P.theta[c * Ds + n];
        P.p_out[c * Ds + n] = 0.0f;
      }
    }
    __syncthreads();
    {
      const Work s = make_work(P);
      const int c = b6c_chain, Ds = 3 * P.K, K = s.K, D = s.D;
      if (tid < K) s.m[tid] = live_m[tid];
      if (tid < D) {  // (K, 3) star-major in memory -> packed a = t K + i over live stars
        const int t = type_of(tid, K), i = tid - t * K, slot = live[i];
        s.th_b[tid] = P.theta[c * Ds + 3 * slot + t];
        s.vec[tid] = P.xi[c * Ds + 3 * slot + t];
      }
      if (tid == 0) {
        s.scal[6] = 0.0f;  // the residual
        s.scal[8] = *P.beta;
        s.scal[9] = P.eps[c];
      }
    }
    __syncthreads();

    // p0 = (L xi) m into p_b, L the factor of G(theta0)
    build_structs(P, true);
    {
      const Work s = make_work(P);
      const float h0 = hamiltonian(s, s.p_b);
      if (tid == 0) s.scal[5] = h0;
    }

    // the loops' counters in shared memory, stepped by thread 0 between
    // barriers, so that no thread holds them in registers across the passes
    if (tid == 0) b6c_iter[0] = 0;
    __syncthreads();
    while (b6c_iter[0] < P.n_steps) {
      // implicit momentum half-step: p_h = p - eps/2 dH/dtheta(theta, p_h)
      {
        const Work s = make_work(P);
        if (tid < s.D) s.ph[tid] = s.p_b[tid];
        if (tid == 0) b6c_iter[1] = 0;
      }
      __syncthreads();
      while (b6c_iter[1] < P.fpi) {
        dh_dtheta(P);
        const Work s = make_work(P);
        const float half_eps = 0.5f * s.scal[9];
        if (tid < s.D) s.dh[tid] = s.p_b[tid] - half_eps * s.dh[tid];
        __syncthreads();
        const float d1 = fp_delta(s, s.dh, s.ph);
        if (tid == 0) s.scal[7] = d1;
        if (tid < s.D) s.ph[tid] = s.dh[tid];
        __syncthreads();
        if (tid == 0) ++b6c_iter[1];
        __syncthreads();
      }
      // implicit position step: theta' = theta + eps/2 [G(theta)^-1 + G(theta')^-1] p_h
      {
        const Work s = make_work(P);
        const float eps = s.scal[9];
        ginv_matvec(s, s.ph, s.vec);
        if (tid < s.D) {
          s.base[tid] = s.th_b[tid] + (0.5f * eps) * s.vec[tid];
          s.th[tid] = s.th_b[tid] + eps * s.vec[tid];
        }
        if (tid == 0) b6c_iter[1] = 0;
      }
      __syncthreads();
      while (b6c_iter[1] < P.fpi) {
        fisher_solve(P);
        const Work s = make_work(P);
        const float half_eps = 0.5f * s.scal[9];
        if (tid < s.D) s.vec[tid] = s.base[tid] + half_eps * s.vec[tid];
        __syncthreads();
        const float d2 = fp_delta(s, s.vec, s.th);
        // the step's residual: the last sweeps' deltas, NaN-propagating
        if (tid == 0 && b6c_iter[1] == P.fpi - 1)
          s.scal[6] = nanmax(s.scal[6], nanmax(s.scal[7], d2));
        if (tid < s.D) s.th[tid] = s.vec[tid];
        __syncthreads();
        if (tid == 0) ++b6c_iter[1];
        __syncthreads();
      }
      // rebuild at theta'; reused by the final half-step, h1 and the next step
      { const Work s = make_work(P); if (tid < s.D) s.th_b[tid] = s.th[tid]; }
      __syncthreads();
      build_structs(P, false);
      dh_dtheta(P);
      {
        const Work s = make_work(P);
        const float half_eps = 0.5f * s.scal[9];
        if (tid < s.D) s.p_b[tid] = s.ph[tid] - half_eps * s.dh[tid];
        if (tid == 0) ++b6c_iter[0];
      }
      __syncthreads();
    }
    const Work s = make_work(P);
    const float h1 = hamiltonian(s, s.p_b);

    const int c = b6c_chain, Ds = 3 * P.K;
    if (tid < s.D) {
      const int K = s.K, t = type_of(tid, K), i = tid - t * K, slot = live[i];
      P.theta_out[c * Ds + 3 * slot + t] = s.th_b[tid];
      P.p_out[c * Ds + 3 * slot + t] = s.p_b[tid];
    }
    if (tid == 0) {
      P.h0_out[c] = s.scal[5];
      P.h1_out[c] = h1;
      P.u1_out[c] = s.scal[0];
      P.resid_out[c] = s.scal[6];
    }
  }
}

// ---------------------------------------------------------------------------
// The wide path: every launch beyond the one-tile domain (H or W > 128, or
// K > 64), on every scene and every K whose slice the card holds.  It replaces no TPU
// kernel: the JAX package runs the full metric there on XLA
// (starcat/api.py:191-205, the smc and trans-d rhmc mutations), since its
// Pallas kernel's gate is H W <= 48^2, K <= 16.  What bounds it is what
// bounds the one-tile path (chip_smoke.rhmc_full_sparse_ops: the star-pair
// terms over their footprints' overlaps and the D^3 dense algebra), but at
// D = 3 K_live in the hundreds and thousands the dense algebra is the
// larger part, and a chain's state (about 3.8 MB at K = 125 on 192 x 192,
// 12.9 MB at K = 254 and 188 MB at K = 1000 on 128 x 128) lives in device
// memory and, over 132 blocks, beyond the 50 MB L2; the wrapper launches
// fewer blocks where a full grid's slices would pass its share of the
// card's free memory (fused_rhmc_crowded.launch_layout).  The passes, their order and their math are the one-tile path's;
// what no longer fits a block's shared memory lives in the block's
// workspace slice, read through L1 and L2, and the passes that held a
// whole field or a whole factor in one block walk them in pieces:
//   * the workspace holds 1/lam and the working field (rho, q, then phi /
//     lam, so no render restores 1/lam after a momentum sweep), the row
//     profiles gy, gy' and gy'', the column profiles gx, gx', gx'' (one copy:
//     the one-tile path's shared set and its copies are the same array here),
//     the 18 K^2 pair sums, G^-1, the q coefficient table, packed L (D + 1
//     rows) and L^-1 (dense, D x D by rows);
//   * shared memory holds the per-star and per-parameter vectors (as the
//     one-tile path; beyond vec_in_smem, K > 615, they live in the slice),
//     the q coefficient ring and one region that is, by phase, the q
//     field's two operand stages over a 128 x 128 pixel tile, the
//     Cholesky's 32-column panel by rows (D + 1 rows) or L^-1's columns
//     under way (a D vector a warp); beyond full_panel (K > 347) the region
//     keeps the stages' size, the panel streams through it in row blocks
//     and L^-1's columns live in the slice;
//   * the chain's live slots and their mask values live in the slice;
//   * the q and phi fields walk the field in 128 x 128 tiles, a 4 x 8 pixel
//     tile a thread, a pair (or star) whose footprint misses the tile
//     skipped; the contractions walk it in 128-column blocks, skipping the
//     blocks where both stars' column profiles are 0, each block's warp sums
//     added to the star's in block order;
//   * the pair passes take a star pair a group of kGroup lanes, each lane 4
//     columns (the rebuild's pair contractions 2) of the pair's footprint
//     overlap at a time (the overlap's width is not bounded by 128), the
//     lanes' sums added across the group in a fixed order;
//   * the Cholesky is right-looking in panels of 32 columns: the panel is
//     read into shared memory, factored there a column at a time (one block
//     barrier a column), written back scaled, and updates the trailing
//     matrix in the workspace, a warp a column and lanes over its rows, each
//     entry taking its updates in column order; beyond full_panel the
//     panel's top 32 rows are factored so, and the rows below stream
//     through a fixed row block, a thread a row (cholesky_streamed); the
//     back substitution runs in one warp by columns of L, L^-1 a column a
//     warp by forward substitution with the column's vector in shared
//     memory (beyond full_panel in the slice), and G^-1 = L^-T L^-1 reads
//     L^-1 by rows, so a warp's loads are contiguous.
// Every sum runs in an order fixed by the scene and the chain's live stars,
// so a chain gives the same bits alone, among others and at any chain count;
// every skipped term is an exact zero.  The bits differ from the one-tile
// path's (other summation orders); both are held against the plain version.
namespace wide {

// the slice's offsets: 64-bit (the index helpers' note)
using WOff = long long;
constexpr int kTile = 128;      // the q and phi fields' pixel tile, the contractions' column block
constexpr int kStage = kQK * 2 * kTile + 2 * kQPairs;  // one q operand stage over a tile
constexpr int kGroup = 8;       // lanes a star pair in the pair passes
constexpr int kPLd = kPanel + 1;  // floats a row of the Cholesky's panel
constexpr int kRowBlock = 448;  // rows of the streamed Cholesky's row block
constexpr int kRing = 2 * kQPairs * kCoef;  // the q coefficient ring
// the dynamic shared memory a block may take: the card's 232448 bytes less
// 1 KB for the static shared memory
constexpr int kSmemFloats = (232448 - 1024) / 4;

__host__ __device__ inline long long round4ll(long long n) { return (n + 3) & ~3LL; }

// column c of a matrix packed by columns of n rows as a pointer whose entry
// r is row r, its offset in 64 bits
template <typename T>
__device__ __forceinline__ T* packed_col(T* A, int c, int n) { return A + col_off<WOff>(c, n) - c; }

// from packed_col(A, c, n) to packed_col(A, c + k, n) in 32 bits (k < 32 in
// the streamed Cholesky: under 32 n)
__device__ __forceinline__ int col_step(int c, int k, int n) {
  return k * (n - c - 1) - k * (k - 1) / 2;
}

// L^-1, dense by rows, after packed L (D + 1 rows) in the slice
__device__ __forceinline__ float* linv(const Work& s) {
  return s.dense + round4ll(packed_l<WOff>(s.D));
}

// the q field's pair count, which q_table<WOff> stores as an int's bits
__device__ __forceinline__ int q_pairs(const Work& s) { return __float_as_int(s.scal[4]); }

// 67 floats a star and 12 of per-chain scalars (place_vectors)
__host__ __device__ inline int vec_floats(int K) { return 67 * K + 12; }

// the region with the Cholesky's whole 32-column panel by rows (D + 1
// rows), or the q field's two operand stages where those are larger
__host__ __device__ inline int panel_region(int K) {
  return round4(imax(2 * kStage, kPLd * (3 * K + 1)));
}

// whether the whole panel, the ring and the vectors fit a block's shared
// memory (K <= 347): the panel is factored in place.  Beyond, the panel
// streams through a region of fixed size (cholesky_streamed)
__host__ __device__ inline bool full_panel(int K) {
  return panel_region(K) + kRing + vec_floats(K) <= kSmemFloats;
}

// the shared region: the whole panel (full_panel), else the q field's two
// operand stages, which hold the streamed panel's top block and a row block
__host__ __device__ inline int region_floats(int K) {
  return full_panel(K) ? panel_region(K)
                       : round4(imax(2 * kStage, kPLd * (kPanel + kRowBlock)));
}

// whether the per-star vectors stay in shared memory beside the region and
// the ring (K <= 615); beyond, they live in the block's workspace slice
__host__ __device__ inline bool vec_in_smem(int K) {
  return region_floats(K) + kRing + vec_floats(K) <= kSmemFloats;
}

// mirrored by wide_smem_bytes() in fused_rhmc_crowded.py: the region, the q
// coefficient ring and, where they fit, 67 floats a star and 12 of
// per-chain scalars
__host__ __device__ inline int smem_floats(int K) {
  return region_floats(K) + kRing + (vec_in_smem(K) ? vec_floats(K) : 0);
}

// mirrored by wide_workspace_floats() in fused_rhmc_crowded.py: the working
// field and 1/lam, gy and gy' interleaved, gx, gx', gx'', gy'', the 18 K^2
// pair sums, G^-1, the q coefficient table, packed L and L^-1 (D x D), the
// chain's live slots and their mask values (2 K); beyond full_panel the
// streamed Cholesky's panel rows (D + 1 rows of kPanel, which L^-1's kWarps
// column vectors share), and beyond vec_in_smem the per-star vectors, each
// a multiple of 4 floats, in 64 bits
__host__ __device__ inline long long work_floats(int K, int H, int W) {
  const long long fs = field_stride(W), hp = prof_ld(H), k = K, D = 3LL * K;
  long long n = 2 * H * fs + round4ll(2 * k * hp) + 3 * k * fs + round4ll(k * hp)
                + round4ll(18 * k * k) + round4ll(D * D) + kCoef * (long long)q_table_pairs(K)
                + round4ll((D + 1) * (D + 2) / 2) + round4ll(D * D) + round4ll(2 * k);
  if (!full_panel(K)) n += kPanel * (D + 1);
  if (!vec_in_smem(K)) n += round4ll(vec_floats(K));
  return n;
}

enum {
  kWFs, kWHp, kWQc, kWSmall, kWSlice, kWR1, kWGyy, kWGx, kWGx1, kWGx2, kWGy2, kWSraw,
  kWGinv, kWQcoef, kWDense, kWLive, kWScratch, kWVec, kWFull, kWK, kWCount
};
// the wide layout: offsets in floats, in 64 bits (kWSlice from the
// workspace's start, the rest from the slice's or from b6c_smem), kWVec
// also 0 where the vectors stay in shared memory, kWFull 1 where the panel
// is factored in place
__shared__ long long lay[kWCount];

// the wide layout into lay (one thread; the chain's K is set per chain)
__device__ void init_layout(const Params& P) {
  long long* ly = lay;
  const int K = P.K, H = P.H, W = P.W;
  const long long fs = field_stride(W), hp = prof_ld(H), k = K, D = 3LL * K;
  ly[kWFs] = fs;
  ly[kWHp] = hp;
  ly[kWQc] = region_floats(K);
  ly[kWSmall] = ly[kWQc] + kRing;
  ly[kWSlice] = kHeader + static_cast<long long>(blockIdx.x) * work_floats(K, H, W);
  ly[kWR1] = H * fs;  // the working field first
  ly[kWGyy] = 2 * H * fs;
  ly[kWGx] = ly[kWGyy] + round4ll(2 * k * hp);
  ly[kWGx1] = ly[kWGx] + k * fs;
  ly[kWGx2] = ly[kWGx1] + k * fs;
  ly[kWGy2] = ly[kWGx2] + k * fs;
  ly[kWSraw] = ly[kWGy2] + round4ll(k * hp);
  ly[kWGinv] = ly[kWSraw] + round4ll(18 * k * k);
  ly[kWQcoef] = ly[kWGinv] + round4ll(D * D);  // 16-byte aligned
  ly[kWDense] = ly[kWQcoef] + kCoef * (long long)q_table_pairs(K);
  ly[kWLive] = ly[kWDense] + round4ll((D + 1) * (D + 2) / 2) + round4ll(D * D);
  ly[kWScratch] = ly[kWLive] + round4ll(2 * k);
  ly[kWFull] = full_panel(K) ? 1 : 0;
  ly[kWVec] = vec_in_smem(K) ? 0 : ly[kWScratch] + (ly[kWFull] ? 0 : kPanel * (D + 1));
  ly[kWK] = K;
}

// kStream: the streamed instantiation, whose per-star vectors lie in shared
// memory or (kWVec) in the workspace; the other's always in shared memory,
// an address the compiler knows as shared
template <bool kStream>
__device__ __forceinline__ Work make_work(const Params& P) {
  const long long* ly = lay;
  Work s;
  s.fs = static_cast<int>(ly[kWFs]);
  s.hp = static_cast<int>(ly[kWHp]);
  s.Hq = kTile;
  s.Wq = kTile;
  float* sm = b6c_smem;
  s.qbuf = sm;
  s.qc = sm + ly[kWQc];
  float* g = P.work + ly[kWSlice];
  place_vectors(s, kStream && ly[kWVec] != 0 ? g + ly[kWVec] : sm + ly[kWSmall], P.K);
  s.fld = g;
  s.r1 = g + ly[kWR1];
  s.gyy = g + ly[kWGyy];
  s.gx = s.gxg = g + ly[kWGx];
  s.gx1 = s.gx1g = g + ly[kWGx1];
  s.gx2g = g + ly[kWGx2];
  s.gy2 = s.gy2g = g + ly[kWGy2];
  s.sraw = g + ly[kWSraw];
  s.ginv = g + ly[kWGinv];
  s.qcoef = g + ly[kWQcoef];
  s.dense = g + ly[kWDense];
  s.scratch = g + ly[kWScratch];
  s.K = static_cast<int>(ly[kWK]);
  s.D = 3 * s.K;
  s.n_dead = P.K - s.K;
  return s;
}

// the chain's live slots and their mask values, in the slice (P.K each)
__device__ __forceinline__ int* live_slots(const Params& P) {
  return reinterpret_cast<int*>(P.work + lay[kWSlice] + lay[kWLive]);
}
__device__ __forceinline__ float* live_masks(const Params& P) {
  return P.work + lay[kWSlice] + lay[kWLive] + P.K;
}

// unordered pair u of n items (i <= j, row by row), from the row offsets
// i n - i (i - 1) / 2 rather than a walk over the rows
__device__ __forceinline__ void pair_of_fast(int u, int n, int& i, int& j) {
  const float b = 2.0f * n + 1.0f;
  int r = static_cast<int>(0.5f * (b - sqrtf(fmaxf(b * b - 8.0f * u, 0.0f))));
  r = max(0, min(r, n - 1));
  while (r > 0 && r * n - r * (r - 1) / 2 > u) --r;
  while (r + 1 < n && (r + 1) * n - (r + 1) * r / 2 <= u) ++r;
  i = r;
  j = r + u - (r * n - r * (r - 1) / 2);
}

// The one-tile contract<MODE> over 128-column blocks: two stars a warp, the
// field (rho, q times 1/lam^2, or phi / lam, all in the working field) read
// once for both down the rows where either star's profiles are non-zero, a
// block's dots reduced by warp shuffles and added to the star's in block
// order, the blocks where both stars' column profiles are 0 skipped.
template <int MODE>
__device__ void contract(const Params& P, const Work& s) {
  constexpr int kCols = kTile / 32;  // a lane's columns cb + lane + 32 u
  constexpr int kAcc = MODE == kSweep ? 5 : 2;
  const int tid = thread_index(), lane = tid & 31, warp = tid >> 5;
  const int K = s.K, W = P.W, fs = s.fs, hp = s.hp;
  for (int m = warp; 2 * m < K; m += kWarps) {
    const int st[2] = {s.ord[2 * m], s.ord[2 * m + 1 < K ? 2 * m + 1 : 2 * m]};
    const int lo = min(s.ylo[st[0]], s.ylo[st[1]]), hi = max(s.yhi[st[0]], s.yhi[st[1]]);
    const int clo = min(s.xlo[st[0]], s.xlo[st[1]]), chi = max(s.xhi[st[0]], s.xhi[st[1]]);
    // the dots n = 0 .. 8 of each star (csrc/fused_rhmc.cu's order) are
    // summed over the blocks in s.dots, by lane 0 (a star is in one pair)
    if (lane == 0) {
#pragma unroll
      for (int n = 0; n < 9; ++n) s.dots[n * K + st[0]] = s.dots[n * K + st[1]] = 0.f;
    }
    for (int cb = clo & ~(kTile - 1); cb <= chi; cb += kTile) {
      float acc[2][kCols][kAcc];
#pragma unroll
      for (int n = 0; n < 2 * kCols * kAcc; ++n) (&acc[0][0][0])[n] = 0.f;
#pragma unroll 2
      for (int h = lo; h <= hi; ++h) {
        float f1[kCols];
#pragma unroll
        for (int u = 0; u < kCols; ++u) {
          const int col = cb + lane + 32 * u, pix = h * fs + col;
          float f = 0.f;
          if (col < W) {
            f = s.fld[pix];
            if (MODE == kQ) {
              const float r = s.r1[pix];
              f = f * (r * r);
            }
          }
          f1[u] = f;
        }
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const float2 y = load2(s.gyy + 2 * (st[t] * hp + h));
          const float y2 = MODE == kSweep ? s.gy2g[st[t] * hp + h] : 0.f;
#pragma unroll
          for (int u = 0; u < kCols; ++u) {
            acc[t][u][0] += f1[u] * y.x;
            acc[t][u][1] += f1[u] * y.y;
            if (MODE == kSweep) {
              acc[t][u][2] += f1[u] * y2;
              const float f2 = f1[u] * f1[u];
              acc[t][u][3] += f2 * y.x;
              acc[t][u][4] += f2 * y.y;
            }
          }
        }
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int i = st[t];
        float a[9];
#pragma unroll
        for (int n = 0; n < 9; ++n) a[n] = 0.f;
#pragma unroll
        for (int u = 0; u < kCols; ++u) {
          const int col = cb + lane + 32 * u;
          if (col < W) {
            const float rg = acc[t][u][0], rg1 = acc[t][u][1];
            const int n = i * fs + col;
            const float gx = s.gxg[n], gx1 = s.gx1g[n];
            a[0] += gx1 * rg;
            a[3] += gx * rg1;
            a[5] += gx * rg;
            if (MODE == kSweep) {
              const float rg2 = acc[t][u][2], rb = acc[t][u][3], rb1 = acc[t][u][4];
              a[1] += s.gx2g[n] * rg;
              a[2] += gx1 * rg1;
              a[4] += gx * rg2;
              a[6] += gx1 * rb;
              a[7] += gx * rb1;
              a[8] += gx * rb;
            }
          }
        }
#pragma unroll
        for (int n = 0; n < 9; ++n) {
          if (MODE == kSweep || n == 0 || n == 3 || n == 5) {
            const float v = warp_sum(a[n]);
            if (lane == 0 && (t == 0 || st[1] != st[0])) s.dots[n * K + i] += v;
          }
        }
      }
    }
  }
  __syncthreads();
}

// The lane group of a pair pass: kGroup lanes a star pair, g the lane's
// place in it, slot the group's place in the block.
struct Group {
  int g, slot;
};

__device__ __forceinline__ Group group_of() {
  const int lane = thread_index() & 31, warp = thread_index() >> 5;
  return Group{lane & (kGroup - 1), warp * (32 / kGroup) + lane / kGroup};
}
constexpr int kPerRound = kWarps * (32 / kGroup);  // star pairs a round

// The rebuild's pair contractions (the one-tile pair_contract's 18 sums of
// both orders a pair, the same 8 row products), a star pair a lane group,
// each lane the 2-column chunks g, g + kGroup, .. of the pair's footprint
// overlap (2 columns rather than the Fisher pairs' 4, so that the row
// products and all 36 sums stay in registers), the sums kept across the
// chunks, then added across the group.
__device__ void pair_contract(const Params& P, const Work& s) {
  const int K = s.K, fs = s.fs, hp = s.hp;
  const int n_pairs = K * (K + 1) / 2;
  const Group q = group_of();
  for (int base = 0; base < n_pairs; base += kPerRound) {
    const int u = base + q.slot;
    const bool has = u < n_pairs;
    int i, j;
    pair_of_fast(has ? u : 0, K, i, j);
    const bool touch = has && overlap(s, i, j);
    float acc[18], acm[18];  // (i, j) and (j, i), index hq 3 + tb
#pragma unroll
    for (int n = 0; n < 18; ++n) acc[n] = acm[n] = 0.f;
    if (touch) {
      const int ylo = max(s.ylo[i], s.ylo[j]), yhi = min(s.yhi[i], s.yhi[j]);
      const int q1 = min(s.xhi[i], s.xhi[j]) >> 1;
      // offsets from the slice's start rather than pointers: fewer registers
      const float* g = s.fld;
      const int oi = static_cast<int>(s.gyy - g) + 2 * i * hp;
      const int oj = static_cast<int>(s.gyy - g) + 2 * j * hp;
      const int oi2 = static_cast<int>(s.gy2 - g) + i * hp;
      const int oj2 = static_cast<int>(s.gy2 - g) + j * hp;
      for (int c2 = (max(s.xlo[i], s.xlo[j]) >> 1) + q.g; c2 <= q1; c2 += kGroup) {
        float t[8][2];
#pragma unroll
        for (int n = 0; n < 16; ++n) (&t[0][0])[n] = 0.f;
        const int orc = static_cast<int>(s.r1 - g) + 2 * c2;
#pragma unroll 2
        for (int h = ylo; h <= yhi; ++h) {
          const float2 ya = load2(g + oi + 2 * h), yb = load2(g + oj + 2 * h);
          const float a0 = ya.x, a1 = ya.y, a2 = g[oi2 + h];
          const float b0 = yb.x, b1 = yb.y, b2 = g[oj2 + h];
          const float pr[8] = {a0 * b0, a0 * b1, a1 * b0, a1 * b1,
                               a2 * b0, a2 * b1, a0 * b2, a1 * b2};
          const float2 r2 = load2(g + orc + h * fs);
#pragma unroll
          for (int m = 0; m < 8; ++m) {
            t[m][0] += pr[m] * r2.x;
            t[m][1] += pr[m] * r2.y;
          }
        }
        // the column profiles a column at a time, so that few are live
        // beside t and the 36 sums, by offsets from the slice's start (gx,
        // gx', gx'' lie K_max fs apart)
        const int kfs = P.K * fs;
        const int ci = static_cast<int>(s.gxg - g) + i * fs + 2 * c2;
        const int cj = static_cast<int>(s.gxg - g) + j * fs + 2 * c2;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float xi[3] = {g[ci + k], g[ci + kfs + k], g[ci + 2 * kfs + k]};
          const float xj[3] = {g[cj + k], g[cj + kfs + k], g[cj + 2 * kfs + k]};
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
    }
    if (__any_sync(kFull, touch)) {
      for (int o = 1; o < kGroup; o <<= 1) {
#pragma unroll
        for (int n = 0; n < 18; ++n) {
          acc[n] += __shfl_xor_sync(kFull, acc[n], o);
          acm[n] += __shfl_xor_sync(kFull, acm[n], o);
        }
      }
    }
    if (has && q.g == 0) {
#pragma unroll
      for (int n = 0; n < 18; ++n) {
        s.sraw[plane_off<WOff>(n, K) + i * K + j] = acc[n];
        if (i != j) s.sraw[plane_off<WOff>(n, K) + j * K + i] = acm[n];
      }
    }
  }
  __syncthreads();
}

// The Fisher pairs of a position sweep (the one-tile fisher_pairs' 9 sums
// a pair, from 4 row products), a star pair a lane group over its
// footprint overlap's 4-column chunks, as pair_contract.
__device__ void fisher_pairs(const Params& P, const Work& s) {
  const int K = s.K, fs = s.fs, hp = s.hp;
  const int n_pairs = K * (K + 1) / 2;
  const Group q = group_of();
  for (int base = 0; base < n_pairs; base += kPerRound) {
    const int u = base + q.slot;
    const bool has = u < n_pairs;
    int i, j;
    pair_of_fast(has ? u : 0, K, i, j);
    const bool touch = has && overlap(s, i, j);
    float acc[9];
#pragma unroll
    for (int n = 0; n < 9; ++n) acc[n] = 0.f;
    if (touch) {
      const int ylo = max(s.ylo[i], s.ylo[j]), yhi = min(s.yhi[i], s.yhi[j]);
      const int q1 = min(s.xhi[i], s.xhi[j]) >> 2;
      const float* g = s.fld;  // offsets from the slice's start, as pair_contract's
      const int oi = static_cast<int>(s.gyy - g) + 2 * i * hp;
      const int oj = static_cast<int>(s.gyy - g) + 2 * j * hp;
      for (int c4 = (max(s.xlo[i], s.xlo[j]) >> 2) + q.g; c4 <= q1; c4 += kGroup) {
        float t[4][4];  // [ya 2 + yb][column]
#pragma unroll
        for (int n = 0; n < 16; ++n) (&t[0][0])[n] = 0.f;
        const int orc = static_cast<int>(s.r1 - g) + 4 * c4;
#pragma unroll 2
        for (int h = ylo; h <= yhi; ++h) {
          const float2 va = load2(g + oi + 2 * h), vb = load2(g + oj + 2 * h);
          const float a[2] = {va.x, va.y}, b[2] = {vb.x, vb.y};
          const float4 r4 = load4(g + orc + h * fs);
#pragma unroll
          for (int ya = 0; ya < 2; ++ya) {
#pragma unroll
            for (int yb = 0; yb < 2; ++yb) {
              const float pr = a[ya] * b[yb];
#pragma unroll
              for (int k = 0; k < 4; ++k) t[ya * 2 + yb][k] += pr * comp(r4, k);
            }
          }
        }
        const int ci = i * fs + 4 * c4, cj = j * fs + 4 * c4;
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
    }
    if (__any_sync(kFull, touch)) {
      for (int o = 1; o < kGroup; o <<= 1) {
#pragma unroll
        for (int n = 0; n < 9; ++n) acc[n] += __shfl_xor_sync(kFull, acc[n], o);
      }
    }
    if (has && q.g == 0) {
#pragma unroll
      for (int ta = 0; ta < 3; ++ta) {
#pragma unroll
        for (int tb = 0; tb < 3; ++tb) {
          const float v = acc[ta * 3 + tb];
          s.sraw[plane_off<WOff>(hp_of_type(ta) * 3 + tb, K) + i * K + j] = v;
          s.sraw[plane_off<WOff>(hp_of_type(tb) * 3 + ta, K) + j * K + i] = v;
        }
      }
    }
  }
  __syncthreads();
}

// The one-tile q_operands over the tile at (tr0, tc0): T (kQK, kTile) of the
// tile's rows, X (kQK, kTile) of its columns, and the pairs' row ranges, a
// pair whose footprint overlap misses the tile empty (its operands there
// are exact zeros).
__device__ void q_operands(const Params& P, const Work& s, int n, int slot, float* buf,
                           int tr0, int tc0) {
  const int tid = thread_index();
  const int H = P.H, fs = s.fs, hp = s.hp;
  const int n_pairs = q_pairs(s);
  const float* coef = s.qc + slot * kQPairs * kCoef;
  float* T = buf;
  float* X = buf + kQK * kTile;
  if (tid < kQPairs) {
    int* rng = reinterpret_cast<int*>(X + kQK * kTile);
    int lo = 1, hi = 0;
    if (n * kQPairs + tid < n_pairs) {
      const float* e = coef + tid * kCoef;
      const int i = static_cast<int>(e[9]), j = static_cast<int>(e[10]);
      const int clo = max(max(s.xlo[i], s.xlo[j]), tc0);
      const int chi = min(min(s.xhi[i], s.xhi[j]), tc0 + kTile - 1);
      if (clo <= chi) {
        lo = max(max(s.ylo[i], s.ylo[j]), tr0);
        hi = min(min(s.yhi[i], s.yhi[j]), tr0 + kTile - 1);
      }
    }
    rng[tid] = lo;
    rng[kQPairs + tid] = hi;
  }
  const int r = tid & (kTile - 1);
  for (int pl = tid / kTile; pl < kQPairs; pl += kThreads / kTile) {
    const float* e = coef + pl * kCoef;
    const bool live = n * kQPairs + pl < n_pairs;
    const int i = live ? static_cast<int>(e[9]) : 0, j = live ? static_cast<int>(e[10]) : 0;
    {
      const int row = tr0 + r;
      float t0 = 0.f, t1 = 0.f, t2 = 0.f, t3 = 0.f;
      if (live && row < H) {
        const float2 vi = load2(s.gyy + 2 * (i * hp + row)), vj = load2(s.gyy + 2 * (j * hp + row));
        const float yi = vi.x, yi1 = vi.y, yj = vj.x, yj1 = vj.y;
        const float p00 = yi * yj, p01 = yi * yj1, p10 = yi1 * yj, p11 = yi1 * yj1;
        t0 = e[0] * p00;
        t1 = e[1] * p01 + e[2] * p00;
        t2 = e[3] * p10 + e[4] * p00;
        t3 = ((e[5] * p11 + e[6] * p10) + e[7] * p01) + e[8] * p00;
      }
      float* tc = T + 4 * pl * kTile + r;
      tc[0] = t0; tc[kTile] = t1; tc[2 * kTile] = t2; tc[3 * kTile] = t3;
    }
    {
      const int col = tc0 + r;
      float x0 = 0.f, x1 = 0.f, x2 = 0.f, x3 = 0.f;
      if (live && col < fs) {
        const float gi = s.gx[i * fs + col], gi1 = s.gx1[i * fs + col];
        const float gj = s.gx[j * fs + col], gj1 = s.gx1[j * fs + col];
        x0 = gi1 * gj1; x1 = gi1 * gj; x2 = gi * gj1; x3 = gi * gj;
      }
      float* xc = X + 4 * pl * kTile + r;
      xc[0] = x0; xc[kTile] = x1; xc[2 * kTile] = x2; xc[3 * kTile] = x3;
    }
  }
}

// q into the working field, tile by tile: the one-tile q_gemm<4, 8> over
// each 128 x 128 tile (a 4 x 8 pixel tile a thread, its column groups of 4
// 64 columns apart), the coefficient ring and the two operand stages
// restarted for each tile.  Ends synchronised.
__device__ void q_field(const Params& P, const Work& s) {
  const int tid = thread_index();
  const int H = P.H, fs = s.fs;
  const int n_pairs = q_pairs(s);
  const int n_chunks = (n_pairs + kQPairs - 1) / kQPairs;
  const int r0 = 4 * (tid >> 4), c0 = 4 * (tid & 15);
  const int wrow = 4 * ((tid & ~31) >> 4);  // the warp's first row in the tile (8 rows)
  for (int tr0 = 0; tr0 < H; tr0 += kTile) {
    for (int tc0 = 0; tc0 < fs; tc0 += kTile) {
      const int wlo = tr0 + wrow, whi = wlo + 7;
      float acc[4][8];
#pragma unroll
      for (int n = 0; n < 32; ++n) (&acc[0][0])[n] = 0.f;
      stage_qcoef<WOff>(s, 0, 0);
      cp_async_wait_all();
      __syncthreads();
      wide::q_operands(P, s, 0, 0, s.qbuf, tr0, tc0);
      if (n_chunks > 1) stage_qcoef<WOff>(s, 1, 1);
      cp_async_wait_all();
      __syncthreads();
      for (int n = 0; n < n_chunks; ++n) {
        const float* T = s.qbuf + (n & 1) * kStage;
        const float* X = T + kQK * kTile;
        if (n + 1 < n_chunks)
          wide::q_operands(P, s, n + 1, (n + 1) & 1, s.qbuf + ((n + 1) & 1) * kStage, tr0, tc0);
        if (n + 2 < n_chunks) stage_qcoef<WOff>(s, n + 2, n & 1);
        const int* rng = reinterpret_cast<const int*>(X + kQK * kTile);
        for (int pl = 0; pl < kQPairs; ++pl) {
          // a pair whose row profiles vanish on the warp's rows, or whose
          // footprint overlap misses the tile, adds exact zeros
          if (rng[kQPairs + pl] < wlo || rng[pl] > whi) continue;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int k = 4 * pl + kk;
            float tv[4], xv[8];
            load_n<4>(T + k * kTile + r0, tv);
            load_n<4>(X + k * kTile + c0, xv);
            load_n<4>(X + k * kTile + c0 + 64, xv + 4);
#pragma unroll
            for (int ri = 0; ri < 4; ++ri) {
#pragma unroll
              for (int ci = 0; ci < 8; ++ci) acc[ri][ci] += tv[ri] * xv[ci];
            }
          }
        }
        cp_async_wait_all();
        __syncthreads();
      }
#pragma unroll
      for (int ri = 0; ri < 4; ++ri) {
        const int row = tr0 + r0 + ri;
        if (row >= H) break;
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const int col = tc0 + c0 + 64 * g;
          if (col < fs)
            store4(s.fld + row * fs + col, acc[ri][4 * g], acc[ri][4 * g + 1],
                   acc[ri][4 * g + 2], acc[ri][4 * g + 3]);
        }
      }
    }
  }
  __syncthreads();
}

// phi / lam into the working field, tile by tile (the one-tile phi_tiles<4,
// 8> over each 128 x 128 tile), 1/lam read from its own array, which stays.
__device__ void phi_field(const Params& P, const Work& s) {
  const int tid = thread_index();
  const int K = s.K, H = P.H, fs = s.fs, hp = s.hp;
  const int r0 = 4 * (tid >> 4), c0 = 4 * (tid & 15);
  const int wrow = 4 * ((tid & ~31) >> 4);
  for (int tr0 = 0; tr0 < H; tr0 += kTile) {
    for (int tc0 = 0; tc0 < fs; tc0 += kTile) {
      const int wlo = tr0 + wrow, whi = wlo + 7;
      int rows[4];
#pragma unroll
      for (int ri = 0; ri < 4; ++ri) rows[ri] = min(tr0 + r0 + ri, H - 1);
      float phi[4][8];
#pragma unroll
      for (int n = 0; n < 32; ++n) (&phi[0][0])[n] = 0.f;
      for (int i = 0; i < K; ++i) {
        // a star whose profiles vanish on the warp's rows or the tile's
        // columns adds exact zeros
        if (s.yhi[i] < wlo || s.ylo[i] > whi || s.xhi[i] < tc0 || s.xlo[i] >= tc0 + kTile)
          continue;
        const float cu = s.cu[i], cv = s.cv[i], cs = s.cs[i];
        float gx[8], gx1[8];
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const int col = tc0 + c0 + 64 * g;
          if (col < fs) {
            load_n<4>(s.gx + i * fs + col, gx + 4 * g);
            load_n<4>(s.gx1 + i * fs + col, gx1 + 4 * g);
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) gx[4 * g + k] = gx1[4 * g + k] = 0.f;
          }
        }
        float tx[8], vx[8];
#pragma unroll
        for (int ci = 0; ci < 8; ++ci) {
          tx[ci] = cu * gx1[ci] + cs * gx[ci];
          vx[ci] = cv * gx[ci];
        }
#pragma unroll
        for (int ri = 0; ri < 4; ++ri) {
          const float2 v = load2(s.gyy + 2 * (i * hp + rows[ri]));
#pragma unroll
          for (int ci = 0; ci < 8; ++ci) {
            phi[ri][ci] = phi[ri][ci] + v.x * tx[ci];
            phi[ri][ci] = phi[ri][ci] + v.y * vx[ci];
          }
        }
      }
#pragma unroll
      for (int ri = 0; ri < 4; ++ri) {
        const int row = tr0 + r0 + ri;
        if (row >= H) break;
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const int col = tc0 + c0 + 64 * g;
          if (col < fs) {
            const float4 r = load4(s.r1 + row * fs + col);
            store4(s.fld + row * fs + col, phi[ri][4 * g] * r.x, phi[ri][4 * g + 1] * r.y,
                   phi[ri][4 * g + 2] * r.z, phi[ri][4 * g + 3] * r.w);
          }
        }
      }
    }
  }
  __syncthreads();
}

// Cholesky of the first D rows of s.dense (packed by columns, D + 1 rows a
// column, in the workspace), rows D .. nrows - 1 reduced alongside (L^-1 b
// in row D), right-looking in panels of kPanel columns through shared
// memory (the header note); s.ldiag, s.dinv and log det G (warp 0, into
// s.scal[1], the dead slots' rows included) as the one-tile cholesky.
// Every thread calls it; it ends synchronised but for s.scal[1].
__device__ void cholesky(const Work& s, int nrows, bool logdet, float ldead) {
  const int tid = thread_index(), lane = tid & 31, warp = tid >> 5;
  const int D = s.D, n1 = D + 1;
  float* A = s.dense;
  float* pr = s.qbuf;  // pr[(r - p0) kPLd + k] = A(r, p0 + k), r >= p0
  for (int p0 = 0; p0 < D; p0 += kPanel) {
    const int p1 = min(p0 + kPanel, D);
    // the panel by rows (0 above the diagonal and past its last column): a
    // warp a column, lanes over its rows
    for (int k = warp; k < kPanel; k += kWarps) {
      const int c = p0 + k;
      const bool ok = c < p1;
      const float* ac = packed_col(A, ok ? c : p0, n1);
      for (int r = p0 + lane; r < nrows; r += 32)
        pr[(r - p0) * kPLd + k] = (ok && r >= c) ? ac[r] : 0.0f;
    }
    __syncthreads();
    // its columns in turn: the pivot, then A_rc -= (A_rj / L_jj)(A_cj / L_jj)
    // for j < c < p1, r >= c (lanes over columns, warps over rows)
    for (int j = p0; j < p1; ++j) {
      const int jj = j - p0;
      const float sjj = pr[jj * kPLd + jj];
      const float dinv = 1.0f / sqrtf(sjj);
      if (tid == 0) {
        s.ldiag[j] = sjj * dinv;
        s.dinv[j] = dinv;
      }
      const int c = j + 1 + lane;
      if (c < p1) {
        const float lc = pr[(c - p0) * kPLd + jj] * dinv;
        for (int r = j + 1 + warp; r < nrows; r += kWarps) {
          if (r < c) continue;
          float* e = pr + (r - p0) * kPLd + (c - p0);
          *e -= (pr[(r - p0) * kPLd + jj] * dinv) * lc;
        }
      }
      __syncthreads();
    }
    // L's panel, scaled: into A below the diagonal and, for the trailing
    // update, in place (0 on and above the diagonal)
    for (int k = warp; k < kPanel; k += kWarps) {
      const int c = p0 + k;
      const bool ok = c < p1;
      const float dv = ok ? s.dinv[c] : 0.0f;
      float* ac = packed_col(A, ok ? c : p0, n1);
      for (int r = p0 + lane; r < nrows; r += 32) {
        float* e = pr + (r - p0) * kPLd + k;
        const bool below = ok && r > c;
        const float l = below ? *e * dv : 0.0f;
        if (below) ac[r] = l;
        *e = l;
      }
    }
    __syncthreads();
    if (p1 == D) break;  // nothing trails the last panel
    // the trailing update A_rc -= sum_k L_rk L_ck over the panel, p1 <= c
    // <= r: a warp a column, lanes over its rows
    for (int c = p1 + warp; c < D; c += kWarps) {
      float lc[kPanel];
#pragma unroll
      for (int k = 0; k < kPanel; ++k) lc[k] = pr[(c - p0) * kPLd + k];
      float* ac = packed_col(A, c, n1);
      for (int r = c + lane; r < nrows; r += 32) {
        const float* lr = pr + (r - p0) * kPLd;
        float a = ac[r];
#pragma unroll
        for (int k = 0; k < kPanel; ++k) a -= lr[k] * lc[k];
        ac[r] = a;
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

// cholesky beyond full_panel, its panel streamed through the fixed region:
// the same factor, entry by entry the same operations in the same order.
// For each 32-column panel, its top block (rows p0 .. p1 - 1) is factored in
// shared memory as cholesky factors the whole panel (one block barrier a
// column) and written back scaled; then the rows below stream through in
// blocks of kRowBlock, a thread a row: the row's panel entries in registers
// take their updates A_rc -= (A_rj / L_jj) L_cj column by column from the
// top block's L, are scaled, written to A and, by rows, to the block's
// shared rows and the workspace's panel rows (s.scratch, kPanel floats a
// row, for the columns of later row blocks), and update the trailing matrix
// on the row block's rows, a warp a column and lanes over its rows, each
// entry taking the panel's 32 updates in column order.  Rows D .. nrows - 1
// are reduced alongside; log det G as cholesky.  Every thread calls it; it
// ends synchronised but for s.scal[1].
__device__ void cholesky_streamed(const Work& s, int nrows, bool logdet, float ldead) {
  const int tid = thread_index(), lane = tid & 31, warp = tid >> 5;
  const int D = s.D, n1 = D + 1;
  float* A = s.dense;
  float* top = s.qbuf;                  // top[(r - p0) kPLd + k] = A(r, p0 + k), r < p1
  float* blk = s.qbuf + kPanel * kPLd;  // blk[(r - r0) kPLd + k] = L(r, p0 + k)
  float* lp = s.scratch;                // lp[(r - p0) kPanel + k] = L(r, p0 + k), r < D
  for (int p0 = 0; p0 < D; p0 += kPanel) {
    const int p1 = min(p0 + kPanel, D);
    for (int k = warp; k < kPanel; k += kWarps) {
      const int c = p0 + k;
      const bool ok = c < p1;
      const float* ac = packed_col(A, ok ? c : p0, n1);
      for (int r = p0 + lane; r < p1; r += 32)
        top[(r - p0) * kPLd + k] = (ok && r >= c) ? ac[r] : 0.0f;
    }
    __syncthreads();
    for (int j = p0; j < p1; ++j) {
      const int jj = j - p0;
      const float sjj = top[jj * kPLd + jj];
      const float dinv = 1.0f / sqrtf(sjj);
      if (tid == 0) {
        s.ldiag[j] = sjj * dinv;
        s.dinv[j] = dinv;
      }
      const int c = j + 1 + lane;
      if (c < p1) {
        const float lc = top[(c - p0) * kPLd + jj] * dinv;
        for (int r = j + 1 + warp; r < p1; r += kWarps) {
          if (r < c) continue;
          float* e = top + (r - p0) * kPLd + (c - p0);
          *e -= (top[(r - p0) * kPLd + jj] * dinv) * lc;
        }
      }
      __syncthreads();
    }
    for (int k = warp; k < kPanel; k += kWarps) {
      const int c = p0 + k;
      const bool ok = c < p1;
      const float dv = ok ? s.dinv[c] : 0.0f;
      float* ac = packed_col(A, ok ? c : p0, n1);
      for (int r = p0 + lane; r < p1; r += 32) {
        float* e = top + (r - p0) * kPLd + k;
        const bool below = ok && r > c;
        const float l = below ? *e * dv : 0.0f;
        if (below) ac[r] = l;
        *e = l;
      }
    }
    __syncthreads();
    float* const ap = packed_col(A, p0, n1);  // the panel's column p0 + k at ap + col_step
    for (int r0 = p1; r0 < nrows; r0 += kRowBlock) {
      const int r1 = min(r0 + kRowBlock, nrows);
      const int r = r0 + tid;
      if (r < r1) {
        float v[kPanel];
#pragma unroll
        for (int k = 0; k < kPanel; ++k)
          v[k] = p0 + k < p1 ? ap[col_step(p0, k, n1) + r] : 0.0f;
#pragma unroll
        for (int jj = 0; jj < kPanel; ++jj) {
          if (p0 + jj < p1) {
            const float lj = v[jj] * s.dinv[p0 + jj];
#pragma unroll
            for (int cc = jj + 1; cc < kPanel; ++cc)
              if (p0 + cc < p1) v[cc] -= lj * top[cc * kPLd + jj];
          }
        }
        float* br = blk + (r - r0) * kPLd;
#pragma unroll
        for (int k = 0; k < kPanel; ++k) {
          const bool ok = p0 + k < p1;
          const float l = ok ? v[k] * s.dinv[p0 + k] : 0.0f;
          if (ok) ap[col_step(p0, k, n1) + r] = l;
          br[k] = l;
          if (r < D) lp[(r - p0) * kPanel + k] = l;
        }
      }
      __syncthreads();
      const int cend = min(r1, D);
      for (int c = p1 + warp; c < cend; c += kWarps) {
        float lc[kPanel];
#pragma unroll
        for (int k = 0; k < kPanel; ++k) lc[k] = lp[(c - p0) * kPanel + k];
        float* ac = packed_col(A, c, n1);
        for (int rr = max(c, r0) + lane; rr < r1; rr += 32) {
          const float* lr = blk + (rr - r0) * kPLd;
          float a = ac[rr];
#pragma unroll
          for (int k = 0; k < kPanel; ++k) a -= lr[k] * lc[k];
          ac[rr] = a;
        }
      }
      __syncthreads();
    }
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

// the Cholesky of the kernel's instantiation: in place where the whole
// panel fits shared memory (kStream false), else streamed
template <bool kStream>
__device__ __forceinline__ void factor(const Work& s, int nrows, bool logdet, float ldead) {
  if constexpr (kStream) cholesky_streamed(s, nrows, logdet, ldead);
  else wide::cholesky(s, nrows, logdet, ldead);
}

// out = G^-1 b by back substitution, L^T out = L^-1 b, after cholesky(nrows
// = D + 1) left L^-1 b in row D: warp 0, out_k = (y_k - L(k+1.., k) .
// out(k+1..)) / L_kk for k = D - 1 .. 0, the dot over column k of L by
// lanes and shuffles, out in shared memory.  Ends synchronised.
__device__ void chol_solve(const Work& s, float* out) {
  const int D = s.D, n1 = D + 1;
  if (thread_index() < 32) {
    const int lane = thread_index();
    for (int k = D - 1; k >= 0; --k) {
      const float* lk = packed_col(s.dense, k, n1);  // lk[r] = L(r, k)
      float acc = 0.0f;
      for (int r = k + 1 + lane; r < D; r += 32) acc += lk[r] * out[r];
      acc = warp_sum(acc);
      if (lane == 0) out[k] = (lk[D] - acc) * s.dinv[k];
      __syncwarp();
    }
  }
  __syncthreads();
}

// L^-1 (dense by rows, X[k D + c] = L^-1(k, c), after packed L) a column a
// warp by forward substitution on L e_c, the column's vector in shared
// memory (beyond full_panel in the workspace's panel rows); then G^-1 = L^-T L^-1 into s.ginv (its lower half computed, both
// written), lanes over columns b reading rows of L^-1; then the q field's
// coefficient table.  Every thread calls it; it ends synchronised.
template <bool kStream>
__device__ void inverse(const Work& s) {
  const int lane = thread_index() & 31, warp = thread_index() >> 5;
  const int D = s.D, n1 = D + 1;
  const float* A = s.dense;
  float* X = linv(s);
  float* v = (kStream ? s.scratch : s.qbuf) + warp * D;
  for (int c = warp; c < D; c += kWarps) {
    for (int r = c + lane; r < D; r += 32) v[r] = r == c ? 1.0f : 0.0f;
    __syncwarp();
    for (int k = c; k < D; ++k) {
      const float xk = v[k] * s.dinv[k];
      if (lane == 0) X[row_off<WOff>(k, D) + c] = xk;
      const float* lk = packed_col(A, k, n1);  // column k of L
      for (int r = k + 1 + lane; r < D; r += 32) v[r] -= lk[r] * xk;
      __syncwarp();
    }
  }
  __syncthreads();
  for (int a = warp; a < D; a += kWarps) {
    const float* const xa = X + row_off<WOff>(a, D) + a;  // L^-1(k, a) at xa + (k - a) D
    float* const ga = s.ginv + row_off<WOff>(a, D);
    for (int b0 = 0; b0 <= a; b0 += 32) {
      const int b = b0 + lane;
      if (b > a) break;
      float acc = 0.0f;
      const float* xk = xa;
      for (int k = a; k < D; ++k, xk += D) acc += xk[0] * xk[b - a];
      ga[b] = acc;
      s.ginv[row_off<WOff>(b, D) + a] = acc;
    }
  }
  __syncthreads();
  q_table<WOff>(s);
}

// out = G^-1 p with the carried s.ginv, a thread a parameter (down column
// a of the symmetric G^-1, so a warp's loads are contiguous).  Ends
// synchronised.
__device__ void ginv_matvec(const Work& s, const float* p, float* out) {
  const int D = s.D;
  for (int a = thread_index(); a < D; a += kThreads) {
    float acc = 0.0f;
    const float* g = s.ginv + a;  // G^-1(b, a) at g + b D
    for (int b = 0; b < D; ++b, g += D) acc += g[0] * p[b];
    out[a] = acc;
  }
  __syncthreads();
}

// H = U + 1/2 log det G + 1/2 p^T G^-1 p at the structs' theta, momentum p.
__device__ float hamiltonian(const Work& s, const float* p) {
  const int tid = thread_index(), lane = tid & 31;
  wide::ginv_matvec(s, p, s.a);
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

// The one-tile build_structs on the wide layout: no copies between the
// shared and the workspace profile sets (they are one), and no rebuild of
// the profiles and 1/lam around the q field (nothing overwrote them).
template <bool kStream>
__device__ void build_structs(const Params& P, bool p0) {
  const int tid = thread_index(), warp = tid >> 5;
  const float beta = wide::make_work<kStream>(P).scal[8];
  double ll;
  { const Work s = wide::make_work<kStream>(P); profiles(P, s, s.th_b, true); }
  { const Work s = wide::make_work<kStream>(P); ll = render(P, s, beta, true); }
  { const Work s = wide::make_work<kStream>(P); wide::pair_contract(P, s); }
  { const Work s = wide::make_work<kStream>(P); wide::contract<kGrad>(P, s); }
  if (warp == 0) potential_terms(P, wide::make_work<kStream>(P), beta, ll);
  {  // synchronises
    const Work s = wide::make_work<kStream>(P);
    assemble_metric<WOff>(P, s, beta, true, nullptr);
  }
  {
    const float gdead = 1.0f + P.jitter;
    const Work s = wide::make_work<kStream>(P);
    wide::factor<kStream>(s, s.D, true, gdead * (1.0f / sqrtf(gdead)));
  }
  if (p0) {
    // p0 = (L xi) m, L the factor of G(theta0)
    const Work s = wide::make_work<kStream>(P);
    const int K = s.K, D = s.D, n1 = D + 1;
    for (int a = tid; a < D; a += kThreads) {
      float acc = s.ldiag[a] * s.vec[a];
      for (int k = 0; k < a; ++k) acc += packed_col(s.dense, k, n1)[a] * s.vec[k];
      s.p_b[a] = acc * s.m[a - type_of(a, K) * K];
    }
    __syncthreads();
  }
  { const Work s = wide::make_work<kStream>(P); wide::inverse<kStream>(s); }
  { const Work s = wide::make_work<kStream>(P); wide::q_field(P, s); }
  { const Work s = wide::make_work<kStream>(P); wide::contract<kQ>(P, s); }
  metric_terms<WOff>(P, wide::make_work<kStream>(P), beta);
}

// dH/dtheta at the structs' theta and the momentum in ph into dh.
template <bool kStream>
__device__ void dh_dtheta(const Params& P) {
  const int tid = thread_index();
  const float beta = wide::make_work<kStream>(P).scal[8];
  {
    const Work s = wide::make_work<kStream>(P);
    wide::ginv_matvec(s, s.ph, s.a);
    for (int i = tid; i < s.K; i += kThreads) {
      s.cu[i] = s.a[i] * s.wcx[i];
      s.cv[i] = s.a[s.K + i] * s.wcy[i];
      s.cs[i] = s.a[2 * s.K + i] * s.w[i];
    }
  }
  __syncthreads();
  { const Work s = wide::make_work<kStream>(P); wide::phi_field(P, s); }
  { const Work s = wide::make_work<kStream>(P); wide::contract<kSweep>(P, s); }
  {
    const Work s = wide::make_work<kStream>(P);
    for (int c = tid; c < s.D; c += kThreads) sweep_term(s, beta, s.dh, c);
  }
  __syncthreads();
}

// G(th)^-1 ph into vec by a fresh metric build at th.
template <bool kStream>
__device__ void fisher_solve(const Params& P) {
  const float beta = wide::make_work<kStream>(P).scal[8];
  { const Work s = wide::make_work<kStream>(P); profiles(P, s, s.th, false); }
  { const Work s = wide::make_work<kStream>(P); render(P, s, beta, false); }
  { const Work s = wide::make_work<kStream>(P); wide::fisher_pairs(P, s); }
  { const Work s = wide::make_work<kStream>(P); assemble_metric<WOff>(P, s, beta, false, s.ph); }
  { const Work s = wide::make_work<kStream>(P); wide::factor<kStream>(s, s.D + 1, false, 0.0f); }
  { const Work s = wide::make_work<kStream>(P); wide::chol_solve(s, s.vec); }
}

// The one-tile kernel's trajectory on the wide layout, the loops over the D
// parameters and the stars strided by the block (either may exceed it);
// kStream (beyond full_panel) streams the Cholesky's panel and keeps L^-1's
// columns in the workspace, so the other instantiation holds none of that
// code.
template <bool kStream>
__global__ void __launch_bounds__(kThreads, 1) fused_rhmc_crowded_wide_kernel(Params P) {
  const int tid = thread_index();
  if (tid == 0) wide::init_layout(P);

  for (;;) {
    __syncthreads();  // the layout is set; the previous chain's outputs are written
    if (tid == 0) b6c_chain = atomicAdd(reinterpret_cast<int*>(P.work), 1);
    __syncthreads();
    if (b6c_chain >= P.C) break;
    {
      const int c = b6c_chain, Ks = P.K, Ds = 3 * Ks;
      if (tid == 0) {
        int* live = wide::live_slots(P);  // the chain's live slots, in order
        float* live_m = wide::live_masks(P);
        const float* mask = P.mask + static_cast<WOff>(c) * P.mask_stride;
        int n = 0;
        for (int i = 0; i < Ks; ++i) {
          const float m = mask[i];
          if (m != 0.0f) {
            live[n] = i;
            live_m[n] = m;
            ++n;
          }
        }
        lay[kWK] = n;
      }
      const WOff co = static_cast<WOff>(c) * Ds;  // the chain's (K, 3) arrays
      for (int n = tid; n < Ds; n += kThreads) {
        P.theta_out[co + n] = P.theta[co + n];
        P.p_out[co + n] = 0.0f;
      }
    }
    __syncthreads();
    {
      const Work s = wide::make_work<kStream>(P);
      const int c = b6c_chain, K = s.K, D = s.D;
      const WOff co = static_cast<WOff>(c) * (3 * P.K);
      const int* live = wide::live_slots(P);
      for (int i = tid; i < K; i += kThreads) s.m[i] = wide::live_masks(P)[i];
      for (int a = tid; a < D; a += kThreads) {
        const int t = type_of(a, K), i = a - t * K, slot = live[i];
        s.th_b[a] = P.theta[co + 3 * slot + t];
        s.vec[a] = P.xi[co + 3 * slot + t];
      }
      if (tid == 0) {
        s.scal[6] = 0.0f;  // the residual
        s.scal[8] = *P.beta;
        s.scal[9] = P.eps[c];
      }
    }
    __syncthreads();

    wide::build_structs<kStream>(P, true);
    {
      const Work s = wide::make_work<kStream>(P);
      const float h0 = wide::hamiltonian(s, s.p_b);
      if (tid == 0) s.scal[5] = h0;
    }

    if (tid == 0) b6c_iter[0] = 0;
    __syncthreads();
    while (b6c_iter[0] < P.n_steps) {
      // implicit momentum half-step: p_h = p - eps/2 dH/dtheta(theta, p_h)
      {
        const Work s = wide::make_work<kStream>(P);
        for (int a = tid; a < s.D; a += kThreads) s.ph[a] = s.p_b[a];
        if (tid == 0) b6c_iter[1] = 0;
      }
      __syncthreads();
      while (b6c_iter[1] < P.fpi) {
        wide::dh_dtheta<kStream>(P);
        const Work s = wide::make_work<kStream>(P);
        const float half_eps = 0.5f * s.scal[9];
        for (int a = tid; a < s.D; a += kThreads) s.dh[a] = s.p_b[a] - half_eps * s.dh[a];
        __syncthreads();
        const float d1 = fp_delta(s, s.dh, s.ph);
        if (tid == 0) s.scal[7] = d1;
        for (int a = tid; a < s.D; a += kThreads) s.ph[a] = s.dh[a];
        __syncthreads();
        if (tid == 0) ++b6c_iter[1];
        __syncthreads();
      }
      // implicit position step: theta' = theta + eps/2 [G(theta)^-1 + G(theta')^-1] p_h
      {
        const Work s = wide::make_work<kStream>(P);
        const float eps = s.scal[9];
        wide::ginv_matvec(s, s.ph, s.vec);
        for (int a = tid; a < s.D; a += kThreads) {
          s.base[a] = s.th_b[a] + (0.5f * eps) * s.vec[a];
          s.th[a] = s.th_b[a] + eps * s.vec[a];
        }
        if (tid == 0) b6c_iter[1] = 0;
      }
      __syncthreads();
      while (b6c_iter[1] < P.fpi) {
        wide::fisher_solve<kStream>(P);
        const Work s = wide::make_work<kStream>(P);
        const float half_eps = 0.5f * s.scal[9];
        for (int a = tid; a < s.D; a += kThreads) s.vec[a] = s.base[a] + half_eps * s.vec[a];
        __syncthreads();
        const float d2 = fp_delta(s, s.vec, s.th);
        if (tid == 0 && b6c_iter[1] == P.fpi - 1)
          s.scal[6] = nanmax(s.scal[6], nanmax(s.scal[7], d2));
        for (int a = tid; a < s.D; a += kThreads) s.th[a] = s.vec[a];
        __syncthreads();
        if (tid == 0) ++b6c_iter[1];
        __syncthreads();
      }
      // rebuild at theta'; reused by the final half-step, h1 and the next step
      {
        const Work s = wide::make_work<kStream>(P);
        for (int a = tid; a < s.D; a += kThreads) s.th_b[a] = s.th[a];
      }
      __syncthreads();
      wide::build_structs<kStream>(P, false);
      wide::dh_dtheta<kStream>(P);
      {
        const Work s = wide::make_work<kStream>(P);
        const float half_eps = 0.5f * s.scal[9];
        for (int a = tid; a < s.D; a += kThreads) s.p_b[a] = s.ph[a] - half_eps * s.dh[a];
        if (tid == 0) ++b6c_iter[0];
      }
      __syncthreads();
    }
    const Work s = wide::make_work<kStream>(P);
    const float h1 = wide::hamiltonian(s, s.p_b);

    const int c = b6c_chain;
    const WOff co = static_cast<WOff>(c) * (3 * P.K);
    const int* live = wide::live_slots(P);
    for (int a = tid; a < s.D; a += kThreads) {
      const int K = s.K, t = type_of(a, K), i = a - t * K, slot = live[i];
      P.theta_out[co + 3 * slot + t] = s.th_b[a];
      P.p_out[co + 3 * slot + t] = s.p_b[a];
    }
    if (tid == 0) {
      P.h0_out[c] = s.scal[5];
      P.h1_out[c] = h1;
      P.u1_out[c] = s.scal[0];
      P.resid_out[c] = s.scal[6];
    }
  }
}

// The fields and profiles (the working field, 1/lam, gy, gy', the three
// column profile sets, gy''), which the passes address in 32 bits from the
// slice's start: whether they end below 2^31 floats (2 H W + 3 K (H + W)
// in all, rounded up: a field of up to about 10^9 pixels).
__host__ __device__ inline bool fields_in_32_bits(int K, int H, int W) {
  const long long fs = field_stride(W), hp = prof_ld(H), k = K;
  return 2 * H * fs + round4ll(2 * k * hp) + 3 * k * fs + round4ll(k * hp) <= 0x7fffffffLL;
}

// The address probe (starcat_fused_rhmc_crowded_addr_probe): one thread
// lays out block 0's slice at P.K with every slot live (init_layout,
// make_work) and, through the index helpers the passes call, writes the
// sentinel -(n + 1) at each corner n and its offset from the workspace's
// start to off[n]: 0, 1 the pair sums' first and plane 17's last; 2, 3 packed
// L's first and last (row D of column D - 1); 4 the last diagonal entry as
// the streamed Cholesky steps to it from its panel's first column
// (col_step); 5, 6 L^-1's first and last; 7, 8 G^-1's; 9, 10 the q
// coefficient table's first and last float.
constexpr int kProbeCorners = 11;
__global__ void addr_probe_kernel(Params P, long long* off) {
  if (threadIdx.x != 0) return;
  wide::init_layout(P);
  const Work s = wide::make_work<true>(P);
  const int K = s.K, D = s.D, n1 = D + 1, p0 = (D - 1) / kPanel * kPanel;
  float* const at[kProbeCorners] = {
      s.sraw + plane_off<WOff>(0, K),
      s.sraw + plane_off<WOff>(17, K) + (K - 1) * K + (K - 1),
      packed_col(s.dense, 0, n1),
      packed_col(s.dense, D - 1, n1) + D,
      packed_col(s.dense, p0, n1) + col_step(p0, D - 1 - p0, n1) + (D - 1),
      linv(s),
      linv(s) + row_off<WOff>(D - 1, D) + (D - 1),
      s.ginv,
      s.ginv + row_off<WOff>(D - 1, D) + (D - 1),
      s.qcoef + coef_off<WOff>(0),
      s.qcoef + coef_off<WOff>(q_table_pairs(K) - 1) + (kCoef - 1)};
  for (int n = 0; n < kProbeCorners; ++n) {
    *at[n] = -static_cast<float>(n + 1);
    off[n] = at[n] - P.work;
  }
}

}  // namespace wide

// The current device's SM count into *sms; returns a CUDA error code.
cudaError_t device_sms(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return e;
}

// The one-tile domain: H, W <= 128 and 1 <= K <= 64.
bool one_tile(int K, int H, int W) {
  return K >= 1 && K <= kMaxStars && H >= 1 && H <= kMaxSide && W >= 1 && W <= kMaxSide;
}

// The kernel's domain (fused_rhmc_crowded.domain_error): every scene and
// K >= 1; where a slice does not fit the card, its allocation fails.
bool in_domain(int K, int H, int W) { return K >= 1 && H >= 1 && W >= 1; }

// Whether a launch's offsets are exact: the one-tile path's always, the
// wide path's where its fields lie within 32 bits (wide::fields_in_32_bits).
bool addressable(int K, int H, int W) {
  return one_tile(K, H, W) || wide::fields_in_32_bits(K, H, W);
}

// The path's shared memory a block, in bytes.
size_t smem_bytes(int K, int H, int W) {
  const int floats = one_tile(K, H, W) ? smem_floats(K, H, W) : wide::smem_floats(K);
  return static_cast<size_t>(floats) * sizeof(float);
}

// The path's kernel with its dynamic shared memory allowed.
cudaError_t prepare(int K, int H, int W, void (**kernel)(Params)) {
  *kernel = one_tile(K, H, W)       ? fused_rhmc_crowded_kernel
            : wide::full_panel(K) ? wide::fused_rhmc_crowded_wide_kernel<false>
                                  : wide::fused_rhmc_crowded_wide_kernel<true>;
  return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes(K, H, W)));
}

}  // namespace

extern "C" {

// Launches `grid` blocks on `stream`, which take the chains from the int
// counter at `work` (zero at launch) and work in their slices of `work`
// after its kHeader floats (kHeader + grid x work_floats(K, H, W) floats,
// allocated by the caller, offsets in 64 bits); returns cudaGetLastError()
// (0 on success).
int starcat_fused_rhmc_crowded(
    const void* theta, const void* xi, const void* eps, const void* mask,
    int mask_stride, const void* beta, const void* image, void* theta_out,
    void* p_out, void* h0_out, void* h1_out, void* u1_out, void* resid_out,
    int C, int K, int H, int W, int n_steps, int fpi, float psf_sigma,
    float psf_norm, float background, float logf_mean, float logf_sigma,
    float lp_flux_const, float jitter, void* work, int grid, void* stream) {
  if (!in_domain(K, H, W) || !addressable(K, H, W) || C < 1 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
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

  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  void (*kernel)(Params) = nullptr;
  cudaError_t e = prepare(K, H, W, &kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, smem_bytes(K, H, W), st>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// The layout a launch of C chains takes: threads per block, the blocks an SM
// holds and the SMs the grid fills (a grid of min(C, SMs x blocks an SM)
// blocks).  Returns a CUDA error code (0 on success).
int starcat_fused_rhmc_crowded_layout(int C, int K, int H, int W, int* threads,
                                      int* blocks_per_sm, int* sms_filled) {
  if (!in_domain(K, H, W)) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  void (*kernel)(Params) = nullptr;
  cudaError_t e = device_sms(&sms);
  if (e == cudaSuccess) e = prepare(K, H, W, &kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads,
                                                      smem_bytes(K, H, W));
  if (e != cudaSuccess) return static_cast<int>(e);
  *threads = kThreads;
  *sms_filled = C < sms ? C : sms;
  return 0;
}

// The source's own sizes for K slots on an H x W scene on the launch's
// path, which the wrapper holds its mirrors to: shared memory a block and
// workspace floats a block (64-bit).
int starcat_fused_rhmc_crowded_sizes(int K, int H, int W, int* smem_out,
                                     long long* work_floats_out) {
  if (!in_domain(K, H, W)) return static_cast<int>(cudaErrorInvalidValue);
  *smem_out = static_cast<int>(smem_bytes(K, H, W));
  *work_floats_out = one_tile(K, H, W) ? work_floats(K, H, W) : wide::work_floats(K, H, W);
  return 0;
}

// The wide path's way at K: bit 0 the Cholesky's whole panel in shared
// memory (else streamed), bit 1 the per-star vectors in shared memory (else
// in the workspace); -1 for K < 1.
int starcat_fused_rhmc_crowded_wide_mode(int K) {
  if (K < 1) return -1;
  return (wide::full_panel(K) ? 1 : 0) | (wide::vec_in_smem(K) ? 2 : 0);
}

// The wide path's address probe at K slots on an H x W scene: one block on
// `stream` writes wide::kProbeCorners sentinels into block 0's slice of
// `work` (kHeader + wide::work_floats(K, H, W) floats at least, allocated
// by the caller) through the passes' index helpers, and their 64-bit
// offsets from `work` to `offsets` (kProbeCorners int64 on the device), for
// the host to hold against exact integers (wide::addr_probe_kernel).
// Returns a CUDA error code; cudaErrorInvalidValue where the launch takes
// the one-tile path or its fields pass 32 bits.
int starcat_fused_rhmc_crowded_addr_probe(int K, int H, int W, void* work, void* offsets,
                                          void* stream) {
  if (!in_domain(K, H, W) || one_tile(K, H, W) || !addressable(K, H, W))
    return static_cast<int>(cudaErrorInvalidValue);
  Params P{};
  P.K = K;
  P.H = H;
  P.W = W;
  P.work = static_cast<float*>(work);
  wide::addr_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      P, static_cast<long long*>(offsets));
  return static_cast<int>(cudaGetLastError());
}

// The probe's corner count (wide::kProbeCorners).
int starcat_fused_rhmc_crowded_probe_corners() { return wide::kProbeCorners; }

// The launch's path: 1 one-tile, 0 wide, -1 outside the domain.
int starcat_fused_rhmc_crowded_one_tile(int K, int H, int W) {
  if (!in_domain(K, H, W)) return -1;
  return one_tile(K, H, W) ? 1 : 0;
}

const char* starcat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
