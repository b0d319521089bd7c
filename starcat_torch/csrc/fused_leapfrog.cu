// Fused leapfrog trajectory on Hopper (sm_90a), one thread block per chain.
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
// (logit x, logit y, log f)):
//   profiles  gx[k][w], gy[k][h], gy*z[k][h]  -- K(W+H) expf, the separable
//             trick: a per-pixel render would need K*H*W
//   render    lam = bg + sum_k (gy_k * f_k m_k) gx_k, resid = d / lam - 1
//   loglik    sum d log lam - lam, on the final evaluation only
//   contract  rgy_k[w] = sum_h resid gy_k, rdgy_k[w] = sum_h resid gy_k z,
//             then W-length dots per star (warp-shuffle reductions)
//   chain rule to the unconstrained coordinates, plus the priors.
//
// What bounds it on this card: work, not bytes.  Per evaluation and chain
// there are about 6*K*H*W FMAs, H*W divisions and 2K(H+W) expf; the state
// (theta, p, grad: 3K floats each) is under 0.5 KB per chain and device
// memory sees it only on entry and exit.  The design keeps everything else
// in shared memory: the image is staged once per block, the residual
// (4 KB at 32x32, 9 KB at 48x48) and the profiles live there for the
// whole L-step loop.
//
// Accuracy: build without --use_fast_math; expf, logf and IEEE division
// keep the gradient within the reference's 0.017 max abs of float64.
//
// Domain (checked by the wrapper): H*W <= 48*48, K <= 16, and the block's
// shared memory (see smem_floats) within the card's 227 KB.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

struct Smem {
  float *theta, *p, *grad, *invm, *dl, *mask, *x, *y, *wk, *red, *u;
  float *img, *res, *gx, *gy, *gyz;
};

// mirrored by smem_bytes() in fused_leapfrog.py, which checks the domain
__host__ __device__ inline int smem_floats(int K, int H, int W) {
  return 19 * K + kWarps + 1 + 2 * H * W + K * (W + 2 * H);
}

__device__ inline Smem carve(float* base, int K, int H, int W) {
  Smem s;
  s.theta = base;          s.p = s.theta + 3 * K;  s.grad = s.p + 3 * K;
  s.invm = s.grad + 3 * K; s.dl = s.invm + 3 * K;  s.mask = s.dl + 3 * K;
  s.x = s.mask + K;        s.y = s.x + K;          s.wk = s.y + K;
  s.red = s.wk + K;        s.u = s.red + kWarps;
  s.img = s.u + 1;         s.res = s.img + H * W;  s.gx = s.res + H * W;
  s.gy = s.gx + K * W;     s.gyz = s.gy + K * H;
  return s;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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
  const float sig = P.psf_sigma;

  if (tid < K) {
    const float m = s.mask[tid];
    s.x[tid] = W * sigmoidf(s.theta[3 * tid]);
    s.y[tid] = H * sigmoidf(s.theta[3 * tid + 1]);
    s.wk[tid] = expf(s.theta[3 * tid + 2]) * m;
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
    const float g = expf(-0.5f * z * z) * P.psf_norm;
    s.gy[i] = g;
    s.gyz[i] = g * z;
  }
  __syncthreads();

  float ll = 0.0f;
  for (int pix = tid; pix < H * W; pix += kThreads) {
    const int h = pix / W, w = pix - h * W;
    float lam = P.background;
    for (int k = 0; k < K; ++k) lam += (s.gy[k * H + h] * s.wk[k]) * s.gx[k * W + w];
    const float d = s.img[pix];
    s.res[pix] = d / lam - 1.0f;
    if (with_u) ll += d * logf(lam) - lam;
  }
  if (with_u) {
    ll = warp_sum(ll);
    if (lane == 0) s.red[warp] = ll;
  }
  __syncthreads();

  // one warp per star: H-first contraction, then the W-length dots
  for (int k = warp; k < K; k += kWarps) {
    const float* gy = s.gy + k * H;
    const float* gyz = s.gyz + k * H;
    const float xk = s.x[k], wk = s.wk[k];
    float cf = 0.0f, cx = 0.0f, cy = 0.0f;
    for (int w = lane; w < W; w += 32) {
      float rgy = 0.0f, rdgy = 0.0f;
      for (int h = 0; h < H; ++h) {
        const float r = s.res[h * W + w];
        rgy += r * gy[h];
        rdgy += r * gyz[h];
      }
      const float gxw = s.gx[k * W + w] * wk;
      const float zx = ((w + 0.5f) - xk) / sig;
      cf += gxw * rgy;
      cx += gxw * zx * rgy;
      cy += gxw * rdgy;
    }
    cf = warp_sum(cf);
    cx = warp_sum(cx);
    cy = warp_sum(cy);
    if (lane == 0) {
      s.dl[3 * k] = cf;
      s.dl[3 * k + 1] = cx / sig;
      s.dl[3 * k + 2] = cy / sig;
    }
  }
  __syncthreads();

  // chain rule to (ux, uy, s) and the priors; K <= 16 stars fit one warp
  if (warp == 0) {
    float lp = 0.0f;
    if (lane < K) {
      const int k = lane;
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
        lp = (lp_pos + lp_flux) * m;
      }
    }
    if (with_u) {
      lp = warp_sum(lp);
      const float llt = warp_sum(lane < kWarps ? s.red[lane] : 0.0f);
      if (lane == 0) s.u[0] = -(llt + lp);
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) fused_leapfrog_kernel(Params P) {
  extern __shared__ float smem[];
  const int c = blockIdx.x, tid = threadIdx.x;
  const int K = P.K, H = P.H, W = P.W, d3 = 3 * K;
  const Smem s = carve(smem, K, H, W);
  const float eps = P.eps[c];
  // a device count cannot be checked on the host; a negative one acts as 0
  const int n = max(*P.n_steps, 0);
  const bool grad_in = P.grad_in != nullptr && n > 0;

  for (int i = tid; i < H * W; i += kThreads) s.img[i] = P.image[i];
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

  const size_t smem = static_cast<size_t>(smem_floats(K, H, W)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_leapfrog_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fused_leapfrog_kernel<<<C, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

const char* starcat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
