// Fused leapfrog trajectory for crowded fields on Hopper (sm_90a), one
// thread block per chain.
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
//             gyw[k][h] = gy w_k and gyzw[k][h] = gy z w_k (K (H + W) expf)
//   render    lam = bg + sum_k gyw_k gx_k,  resid = D / lam - 1
//   loglik    sum D log lam - lam (double), on the final evaluation only
//   contract  per star: sum_pix resid gyw gx (flux), resid gyw gx z (x),
//             resid gyzw gx (y); the chain rule and the priors.
//
// What bounds it on this card: operations.  At 128x128 and K = 50 one
// evaluation is 2 K H W FMAs for the render and 2 K H W for the
// contraction, about 3.3 M FMAs, against a state of 3K floats per chain;
// device memory sees theta, p and grad once, and the 64 KB image is read
// from L2 by every block.  The design keeps what one block can hold in
// shared memory (the residual field, gx, gyw and gyzw: 4 (H W + K (W + 2H))
// bytes, 163 KB at 128x128 with K = 64, so one block per SM) and reads the
// image through the read-only path instead of staging it.  512 threads
// keep 16 warps in flight on the SM.  The contraction gives one warp to
// one star; each lane sums four columns down the rows, so the two
// broadcast profile loads of a row serve eight FMAs.
//
// Accuracy: no fast math (expf, logf, IEEE division).  The log-likelihood
// and the prior sum in double, so U carries no float32 summation error over
// the 16384 pixels.  A dead slot (m = 0) has flux 0 by selection, not
// exp(s) * 0, so an extreme theta in a dead slot cannot make NaN; its
// gradient is 0 and, with zero momentum, its theta does not move.
//
// Domain (checked by the wrapper): 1 <= K <= 128 and the block's shared
// memory (smem_floats) within the card's 227 KB.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;  // columns per lane in the contraction

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

struct Smem {
  float *theta, *p, *grad, *invm, *dl;  // 3K each
  float *mask, *x, *y, *wk;             // K each
  float *u;
  double* red;                          // kWarps
  float *res, *gx, *gyw, *gyzw;
};

// mirrored by smem_bytes() in fused_leapfrog_crowded.py
__host__ __device__ inline int smem_floats(int K, int H, int W) {
  return 19 * K + 1 + 1 + 2 * kWarps + H * W + K * (W + 2 * H);
}

__device__ inline Smem carve(float* base, int K, int H, int W) {
  Smem s;
  float* q = base;
  auto take = [&q](int n) { float* r = q; q += n; return r; };
  s.theta = take(3 * K); s.p = take(3 * K); s.grad = take(3 * K);
  s.invm = take(3 * K); s.dl = take(3 * K);
  s.mask = take(K); s.x = take(K); s.y = take(K); s.wk = take(K);
  s.u = take(1);
  // 8-byte alignment for the doubles: skip one float if needed
  if (reinterpret_cast<size_t>(q) & 7) q += 1;
  s.red = reinterpret_cast<double*>(take(2 * kWarps));
  s.res = take(H * W);
  s.gx = take(K * W); s.gyw = take(K * H); s.gyzw = take(K * H);
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

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float softplusf(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// dU/dtheta at s.theta into s.grad and, when with_u, U into s.u[0].
// Every thread of the block must call it (it synchronises).
__device__ void grad_eval(const Params& P, const Smem& s, bool with_u) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = P.K, H = P.H, W = P.W;
  const float sig = P.psf_sigma, inv_sig = 1.0f / sig;

  if (tid < K) {
    const float m = s.mask[tid];
    s.x[tid] = W * sigmoidf(s.theta[3 * tid]);
    s.y[tid] = H * sigmoidf(s.theta[3 * tid + 1]);
    s.wk[tid] = (m != 0.0f) ? expf(s.theta[3 * tid + 2]) * m : 0.0f;
  }
  __syncthreads();

  for (int i = tid; i < K * W; i += kThreads) {
    const int k = i / W, w = i - k * W;
    const float z = ((w + 0.5f) - s.x[k]) / sig;
    s.gx[i] = expf(-0.5f * z * z) * P.psf_norm;
  }
  for (int i = tid; i < K * H; i += kThreads) {
    const int k = i / H, h = i - k * H;
    const float z = ((h + 0.5f) - s.y[k]) / sig;
    const float g = expf(-0.5f * z * z) * P.psf_norm * s.wk[k];
    s.gyw[i] = g;
    s.gyzw[i] = g * z;
  }
  __syncthreads();

  double ll = 0.0;
  for (int pix = tid; pix < H * W; pix += kThreads) {
    const int h = pix / W, w = pix - h * W;
    float lam = P.background;
    for (int k = 0; k < K; ++k) lam = fmaf(s.gyw[k * H + h], s.gx[k * W + w], lam);
    const float d = __ldg(P.image + pix);
    s.res[pix] = d / lam - 1.0f;
    if (with_u) ll += static_cast<double>(d * logf(lam) - lam);
  }
  if (with_u) ll = block_sum_d(ll, s.red);  // synchronises
  else __syncthreads();

  // one warp per star: each lane sums kCols columns down the rows, then
  // the W-length dots with gx by warp shuffles
  for (int k = warp; k < K; k += kWarps) {
    const float* gyw = s.gyw + k * H;
    const float* gyzw = s.gyzw + k * H;
    const float xk = s.x[k];
    float cf = 0.0f, cx = 0.0f, cy = 0.0f;
    for (int c0 = 0; c0 < W; c0 += 32 * kCols) {
      float rg[kCols], rz[kCols];
      int col[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        rg[j] = 0.0f;
        rz[j] = 0.0f;
        col[j] = c0 + lane + 32 * j;
      }
      for (int h = 0; h < H; ++h) {
        const float g = gyw[h], gz = gyzw[h];
        const float* row = s.res + h * W;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const float r = col[j] < W ? row[col[j]] : 0.0f;
          rg[j] = fmaf(r, g, rg[j]);
          rz[j] = fmaf(r, gz, rz[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        if (col[j] < W) {
          const float gxw = s.gx[k * W + col[j]];
          const float zx = ((col[j] + 0.5f) - xk) * inv_sig;
          cf += gxw * rg[j];
          cx += gxw * zx * rg[j];
          cy += gxw * rz[j];
        }
      }
    }
    cf = warp_sum(cf);
    cx = warp_sum(cx);
    cy = warp_sum(cy);
    if (lane == 0) {
      s.dl[3 * k] = cf;
      s.dl[3 * k + 1] = cx * inv_sig;
      s.dl[3 * k + 2] = cy * inv_sig;
    }
  }
  __syncthreads();

  // chain rule to (ux, uy, s) and the priors, one thread per star
  double lp = 0.0;
  if (tid < K) {
    const int k = tid;
    const float ux = s.theta[3 * k], uy = s.theta[3 * k + 1], sl = s.theta[3 * k + 2];
    const float m = s.mask[k];
    const float sx = sigmoidf(ux), sy = sigmoidf(uy);
    const float gl_ux = s.dl[3 * k + 1] * W * sx * (1.0f - sx);
    const float gl_uy = s.dl[3 * k + 2] * H * sy * (1.0f - sy);
    const float gl_s = s.dl[3 * k];
    const float zf = (sl - P.logf_mean) / P.logf_sigma;
    s.grad[3 * k] = -(gl_ux * m + (1.0f - 2.0f * sx) * m);
    s.grad[3 * k + 1] = -(gl_uy * m + (1.0f - 2.0f * sy) * m);
    s.grad[3 * k + 2] = -(gl_s * m + (-zf / P.logf_sigma) * m);
    if (with_u) {
      const float lp_pos = -(softplusf(ux) + softplusf(-ux) + softplusf(uy) + softplusf(-uy));
      const float lp_flux = -0.5f * zf * zf + P.lp_flux_const;
      lp = static_cast<double>((lp_pos + lp_flux) * m);
    }
  }
  if (with_u) {
    lp = block_sum_d(lp, s.red);  // synchronises
    if (tid == 0) s.u[0] = static_cast<float>(-(ll + lp));
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) fused_leapfrog_crowded_kernel(Params P) {
  extern __shared__ float smem[];
  const int c = blockIdx.x, tid = threadIdx.x;
  const int K = P.K, H = P.H, W = P.W, d3 = 3 * K;
  const Smem s = carve(smem, K, H, W);
  const float eps = P.eps[c];
  // a device count cannot be checked on the host; a negative one acts as 0
  const int n = max(*P.n_steps, 0);
  const bool grad_in = P.grad_in != nullptr && n > 0;

  if (tid < d3) {
    s.theta[tid] = P.theta[c * d3 + tid];
    s.p[tid] = P.p[c * d3 + tid];
    s.invm[tid] = P.inv_mass[tid];
    if (grad_in) s.grad[tid] = P.grad_in[c * d3 + tid];
  }
  if (tid < K) s.mask[tid] = P.mask[c * P.mask_stride + tid];
  __syncthreads();

  // n == 0 returns (U, grad U) at theta; otherwise the entry gradient is
  // taken from grad_in or evaluated here, and only the final of the n
  // evaluations computes the log-likelihood for U.
  if (!grad_in) grad_eval(P, s, n == 0);
  for (int step = 0; step < n; ++step) {
    if (tid < d3) {
      const float p_half = s.p[tid] - 0.5f * eps * s.grad[tid];
      s.p[tid] = p_half;
      s.theta[tid] = s.theta[tid] + eps * s.invm[tid] * p_half;
    }
    __syncthreads();
    grad_eval(P, s, step == n - 1);
    if (tid < d3) s.p[tid] = s.p[tid] - 0.5f * eps * s.grad[tid];
  }

  if (tid < d3) {
    P.theta_out[c * d3 + tid] = s.theta[tid];
    P.p_out[c * d3 + tid] = s.p[tid];
    P.grad_out[c * d3 + tid] = s.grad[tid];
  }
  if (tid == 0) P.u_out[c] = s.u[0];
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

  const size_t smem = static_cast<size_t>(smem_floats(K, H, W)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_leapfrog_crowded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fused_leapfrog_crowded_kernel<<<C, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

const char* starcat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
