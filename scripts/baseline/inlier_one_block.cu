// The coarse-init robust rigid fit on Hopper: all EM iterations of the 2-D
// inlier fit over NN matches in one launch of one block.
//
// Replaces `spateo_tpu/ops/inlier_pallas.py` `_inlier_kernel` (:38), the
// fused form of `math._inlier_from_NN_kernel` (reference methods/utils.py
// :1220). Per iteration, over the N candidate pairs (x_n, y_n) with
// normalised NN distance d_n, valid-row mask m_n and posterior P_n:
//   mu_x = sum P x / Sp, mu_y = sum P y / Sp
//   A = sum_n P (y - mu_y)(x - mu_x)^T   -> closed-form 2-D Procrustes R, t
//   r2 = |y - (R x + t)|^2,  term = exp(-r2 / (2 s2)) w
//   P' = term / (term + max(w) (1 - g) 2 pi s2 / (g a)),  Sp' = sum P'
//   g' = clip(Sp' / n_valid, 0.01, 0.99),  P' = max(P', 1e-6) m
//   s2' = sum r2 P' / (2 Sp')
//   from iteration 21 on: alpha *= decay, w = exp(-d alpha) m / max(...)
// then the final posterior at the fixed (s2, g) = (1e-2, 0.1).
//
// What bounds it on an H100: four or five passes over ~20k rows per
// iteration are tiny; the cost is the three to five synchronised block
// reductions per iteration (latency), not bytes or flops. The design: one
// block of 1024 threads walks the rows with a stride, keeps the per-row
// state (P, w) in global scratch that stays in L1/L2, and reduces with warp
// shuffles plus one shared-memory pass in a fixed order, so the result has
// the same bits on every run. It replaces the ~35 launches per iteration
// of the plain loop (`ops/inlier_cuda.py::inlier_reference`).
//
// f32 throughout, `expf`, IEEE division, no fast-math. Scalars arrive in an
// [8] f32 device array (n_valid, area a, the alpha decay), so the caller
// reads nothing back. Plain C interface, loaded with ctypes; the entry
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 1024;
constexpr int NW = NT / 32;

// Sum (or max) of K values over the block, in a fixed order; every thread
// gets the results. `red` is [K][NW] shared scratch.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float (*red)[NW]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
  }
  __syncthreads();  // red is free
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[k][warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.0f;
    for (int w = 0; w < NW; ++w) s += red[k][w];
    v[k] = s;
  }
}

__device__ __forceinline__ float block_max(float v, float (*red)[NW]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();
  if (lane == 0) red[0][warp] = v;
  __syncthreads();
  float m = red[0][0];
  for (int w = 1; w < NW; ++w) m = fmaxf(m, red[0][w]);
  return m;
}

__global__ void __launch_bounds__(NT) inlier_kernel(
    const float* __restrict__ x,     // [N, 2]
    const float* __restrict__ y,     // [N, 2]
    const float* __restrict__ dist,  // [N] normalised distances
    const float* __restrict__ mask,  // [N]
    const float* __restrict__ scal,  // [8]: n_valid, a, alpha_decay, sigma2_0
    float* __restrict__ P,           // [N] scratch: the posterior
    float* __restrict__ w,           // [N] scratch: the weights
    float* __restrict__ p_out,       // [N] the final posterior
    float* __restrict__ misc,        // [8]: R00 R01 R10 R11 t0 t1 sigma2 gamma
    int N, int max_iter) {
  __shared__ float red[8][NW];
  const float n_valid = scal[0], area = scal[1], decay = scal[2];
  const float two_pi = 6.283185307179586f;

  // weight0 = exp(-d) m (alpha0 = 1); P0 = weight0
  float acc[1] = {0.0f};
  float wmax = -__int_as_float(0x7f800000);
  for (int n = threadIdx.x; n < N; n += NT) {
    const float w0 = expf(-dist[n]) * mask[n];
    w[n] = w0;
    P[n] = w0;
    acc[0] += w0;
    wmax = fmaxf(wmax, w0);
  }
  block_sum<1>(acc, red);
  float Sp = acc[0];
  wmax = block_max(wmax, red);
  float sigma2 = scal[3], gamma = 0.5f, alpha = 1.0f;
  float r00 = 1.0f, r01 = 0.0f, r10 = 0.0f, r11 = 1.0f, t0 = 0.0f, t1 = 0.0f;

  for (int it = 0; it < max_iter; ++it) {
    float m4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int n = threadIdx.x; n < N; n += NT) {
      const float p = P[n];
      m4[0] += x[2 * n] * p;
      m4[1] += x[2 * n + 1] * p;
      m4[2] += y[2 * n] * p;
      m4[3] += y[2 * n + 1] * p;
    }
    block_sum<4>(m4, red);
    const float mx0 = m4[0] / Sp, mx1 = m4[1] / Sp, my0 = m4[2] / Sp, my1 = m4[3] / Sp;
    float a4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int n = threadIdx.x; n < N; n += NT) {
      const float p = P[n];
      const float X0 = (x[2 * n] - mx0) * p, X1 = (x[2 * n + 1] - mx1) * p;
      const float Y0 = y[2 * n] - my0, Y1 = y[2 * n + 1] - my1;
      a4[0] += Y0 * X0;
      a4[1] += Y0 * X1;
      a4[2] += Y1 * X0;
      a4[3] += Y1 * X1;
    }
    block_sum<4>(a4, red);
    const float ca = a4[0] + a4[3], sb = a4[2] - a4[1];
    const float nrm = sqrtf(ca * ca + sb * sb) + 1e-30f;
    const float c = ca / nrm, s = sb / nrm;
    r00 = c; r01 = -s; r10 = s; r11 = c;
    t0 = my0 - (mx0 * r00 + mx1 * r01);
    t1 = my1 - (mx0 * r10 + mx1 * r11);
    const float outlier = wmax * (1.0f - gamma) * (two_pi * sigma2) / (gamma * area);
    float sp2[2] = {0.0f, 0.0f};
    for (int n = threadIdx.x; n < N; n += NT) {
      const float x0 = x[2 * n], x1 = x[2 * n + 1];
      const float e0 = y[2 * n] - (x0 * r00 + x1 * r01 + t0);
      const float e1 = y[2 * n + 1] - (x0 * r10 + x1 * r11 + t1);
      const float r2 = e0 * e0 + e1 * e1;
      const float term = expf(-r2 / (2.0f * sigma2)) * w[n];
      float p = term / (term + outlier);
      sp2[0] += p;
      p = fmaxf(p, 1e-6f) * mask[n];
      P[n] = p;
      sp2[1] += r2 * p;
    }
    block_sum<2>(sp2, red);
    Sp = sp2[0];
    gamma = fminf(fmaxf(Sp / n_valid, 0.01f), 0.99f);
    sigma2 = sp2[1] / (2.0f * Sp);
    if (it > 20) {
      alpha = alpha * decay;
      float mx = -__int_as_float(0x7f800000);
      for (int n = threadIdx.x; n < N; n += NT) {
        const float wn = expf(-dist[n] * alpha) * mask[n];
        w[n] = wn;
        mx = fmaxf(mx, wn);
      }
      mx = block_max(mx, red);
      // the normalised weights and their max, as the next iteration reads it
      float wm = -__int_as_float(0x7f800000);
      for (int n = threadIdx.x; n < N; n += NT) {
        w[n] = w[n] / mx;
        wm = fmaxf(wm, w[n]);
      }
      wmax = block_max(wm, red);
    }
  }

  // the final posterior at the fixed temperature
  const float fs2 = 1e-2f, fg = 0.1f;
  const float outlier = wmax * (1.0f - fg) * (two_pi * fs2) / (fg * area);
  float sp[1] = {0.0f};
  for (int n = threadIdx.x; n < N; n += NT) {
    const float x0 = x[2 * n], x1 = x[2 * n + 1];
    const float e0 = y[2 * n] - (x0 * r00 + x1 * r01 + t0);
    const float e1 = y[2 * n + 1] - (x0 * r10 + x1 * r11 + t1);
    const float term = expf(-(e0 * e0 + e1 * e1) / (2.0f * fs2)) * w[n];
    const float p = term / (term + outlier) * mask[n];
    p_out[n] = p;
    sp[0] += p;
  }
  block_sum<1>(sp, red);
  if (threadIdx.x == 0) {
    misc[0] = r00; misc[1] = r01; misc[2] = r10; misc[3] = r11;
    misc[4] = t0; misc[5] = t1;
    misc[6] = sigma2;
    misc[7] = fminf(fmaxf(sp[0] / n_valid, 0.01f), 0.99f);
  }
}

}  // namespace

extern "C" int inlier_fit(const float* x, const float* y, const float* dist, const float* mask, const float* scal,
                          float* P, float* w, float* p_out, float* misc, int N, int max_iter, void* stream) {
  inlier_kernel<<<1, NT, 0, static_cast<cudaStream_t>(stream)>>>(x, y, dist, mask, scal, P, w, p_out, misc, N,
                                                                  max_iter);
  return static_cast<int>(cudaGetLastError());
}
