// The coarse-init robust rigid fit on Hopper: all EM iterations of the 2-D
// inlier fit over NN matches in one launch of one thread-block cluster.
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
// What bounds it on an H100: the work is ~45 flops a row per iteration,
// so the operations bound (~1.4 us for 20k rows x 100 iterations) stays far
// away; the time is the chain of 3 x max_iter + 2 dependent reductions over
// all rows. The design makes each of them short:
//   * One cluster of C blocks (8, or 16 as a non-portable size) on C SMs;
//     the rows are split contiguously over the ranks, and each thread keeps
//     up to RPT of its rank's rows (x, y, d, m, P, w) in registers for the
//     whole fit: global memory is read once and p_out written once. Rows past
//     C x NT x RPT are walked from global memory each pass (P and w in the
//     caller's scratch), not refused.
//   * Three reductions an iteration: the P-weighted sums; the centred
//     cross-covariance (centred, since uncentred moments of offset
//     coordinates cancel badly); Sp with sum r2 P and, from iteration 21,
//     the max of the new unnormalised weights (alpha does not depend on the
//     data, so the new weights are computed in the same pass). The weights
//     are divided by that max where they are used, and the max of the
//     normalised weights is max / max: the row that holds the max gives
//     exactly that, and rounded division is monotone. So no pass is spent
//     renormalising.
//   * Each reduction: warp butterflies; warp 0 adds the block's warp
//     partials in a fixed order and pushes them with `st.async` into slot
//     `rank` of every block of the cluster (distributed shared memory), each
//     push counting its bytes on the receiving block's mbarrier; each block
//     waits on its own mbarrier only, then every warp adds the C slots in a
//     fixed butterfly. No cluster-wide barrier per reduction: one where every
//     thread arrives with release semantics took 1.1 us a reduction even in
//     a cluster of one block, 2.9 us in one of 16 (PERF.md). Every block
//     computes the same scalars (means, R, t, s2, g, max) with the same
//     bits: nothing is broadcast, and every run gives the same result.
//
// f32 throughout, `expf`, IEEE division, no fast-math. Scalars arrive in an
// [8] f32 device array (n_valid, area a, the alpha decay, sigma2_0), so the
// caller reads nothing back. Plain C interface, loaded with ctypes; the
// entry returns the launch's error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KMAX = 4;   // values one reduction carries
constexpr int CMAX = 16;  // largest cluster

__device__ __forceinline__ float combine(float a, float b, bool is_sum) { return is_sum ? a + b : fmaxf(a, b); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The same shared-memory address in block `rank` of the cluster.
__device__ __forceinline__ uint32_t in_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\tbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Exchange slots of one block: warp partials, one 16-byte slot per sending
// rank and an mbarrier, each twice (by the parity of the reduction).
template <int NT>
struct Exchange {
  float red[2][KMAX][NT / 32];
  __align__(16) float slot[2][CMAX][KMAX];
  __align__(8) uint64_t bar[2];
};

// KS sums then KM maxima of v over the cluster, in a fixed order; every
// thread of every block gets the same bits. Warp butterflies; warp 0 adds
// the block's warp partials and pushes them with st.async into slot `rank`
// of every block, each push counting its 16 bytes on the receiver's
// mbarrier; every block waits on its own mbarrier for the C slots, then
// each warp adds them in a fixed butterfly. A block's slots of parity q are
// written again only after every block has passed the reduction between,
// which needs this block's push of it, made after all its threads read q.
template <int NT, int KS, int KM>
__device__ __forceinline__ void cluster_reduce(float (&v)[KS + KM], Exchange<NT>& ex, int& parity, uint32_t& phases,
                                               int C, int rank) {
  constexpr int NW = NT / 32, K = KS + KM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] = combine(v[k], __shfl_xor_sync(0xffffffffu, v[k], off), k < KS);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) ex.red[parity][k][warp] = v[k];
  }
  __syncthreads();
  const uint32_t bar = smem_u32(&ex.bar[parity]);
  if (warp == 0) {
    float x[KMAX] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < K; ++k) {
      x[k] = ex.red[parity][k][lane % NW];
#pragma unroll
      for (int off = NW / 2; off > 0; off >>= 1) x[k] = combine(x[k], __shfl_xor_sync(0xffffffffu, x[k], off), k < KS);
    }
    if (lane == 0)
      asm volatile("{\n\t.reg .b64 state;\n\tmbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n\t}\n"
                   ::"r"(bar), "r"(C * KMAX * 4) : "memory");
    if (lane < C)
      asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n"
                   ::"r"(in_rank(smem_u32(&ex.slot[parity][rank][0]), lane)), "f"(x[0]), "f"(x[1]), "f"(x[2]),
                   "f"(x[3]), "r"(in_rank(bar, lane)) : "memory");
  }
  const uint32_t phase = (phases >> parity) & 1u;
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n\t.reg .pred p;\n\tmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}\n" : "=r"(done) : "r"(bar), "r"(phase) : "memory");
  phases ^= 1u << parity;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float x = ex.slot[parity][lane % C][k];
    for (int off = C / 2; off > 0; off >>= 1) x = combine(x, __shfl_xor_sync(0xffffffffu, x, off), k < KS);
    v[k] = x;
  }
  parity ^= 1;
}

template <int NT, int RPT>
__global__ void __launch_bounds__(NT, 1) inlier_kernel(
    const float* __restrict__ x,     // [N, 2]
    const float* __restrict__ y,     // [N, 2]
    const float* __restrict__ dist,  // [N] normalised distances
    const float* __restrict__ mask,  // [N]
    const float* __restrict__ scal,  // [8]: n_valid, a, alpha_decay, sigma2_0
    float* __restrict__ P,           // [N] scratch: the posterior of rows past the registers
    float* __restrict__ w,           // [N] scratch: their unnormalised weights
    float* __restrict__ p_out,       // [N] the final posterior
    float* __restrict__ misc,        // [8]: R00 R01 R10 R11 t0 t1 sigma2 gamma
    int N, int per_rank, int max_iter) {
  __shared__ Exchange<NT> ex;
  const int C = gridDim.x, rank = blockIdx.x, tid = threadIdx.x;
  const float n_valid = scal[0], area = scal[1], decay = scal[2];
  const float two_pi = 6.283185307179586f;
  const float ninf = -__int_as_float(0x7f800000);
  const float2* __restrict__ X = reinterpret_cast<const float2*>(x);
  const float2* __restrict__ Y = reinterpret_cast<const float2*>(y);
  int parity = 0;
  uint32_t phases = 0;
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&ex.bar[0])) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&ex.bar[1])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_barrier();  // every block's mbarriers are set up before any block pushes

  // this rank's rows [lo, hi): lo + tid + k NT for k < RPT in registers (the
  // valid ones, k < n_reg; the others hold zeros and add nothing), from g0
  // on walked from global memory
  const int lo = min(N, rank * per_rank), hi = min(N, lo + per_rank);
  const int n_reg = hi - lo > tid ? min(RPT, (hi - lo - tid + NT - 1) / NT) : 0;
  const int g0 = lo + RPT * NT;
  float rx0[RPT], rx1[RPT], ry0[RPT], ry1[RPT], rd[RPT], rm[RPT], rP[RPT], rw[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int n = lo + tid + k * NT;
    const bool ok = k < n_reg;
    const float2 xv = ok ? X[n] : make_float2(0.0f, 0.0f), yv = ok ? Y[n] : make_float2(0.0f, 0.0f);
    rx0[k] = xv.x; rx1[k] = xv.y; ry0[k] = yv.x; ry1[k] = yv.y;
    rd[k] = ok ? dist[n] : 0.0f;
    rm[k] = ok ? mask[n] : 0.0f;
    rP[k] = rw[k] = 0.0f;
  }
  // f(ok, n, x0, x1, y0, y1, d, m, P&, w&) over this thread's rows in a
  // fixed order, the register rows without branches (f adds nothing and
  // changes nothing where !ok); `store` writes the walked rows' P and w back
  auto for_rows = [&](bool store, auto&& f) {
#pragma unroll
    for (int k = 0; k < RPT; ++k)
      f(k < n_reg, lo + tid + k * NT, rx0[k], rx1[k], ry0[k], ry1[k], rd[k], rm[k], rP[k], rw[k]);
    for (int n = g0 + tid; n < hi; n += NT) {
      const float2 xv = X[n], yv = Y[n];
      float pn = P[n], wn = w[n];
      f(true, n, xv.x, xv.y, yv.x, yv.y, dist[n], mask[n], pn, wn);
      if (store) {
        P[n] = pn;
        w[n] = wn;
      }
    }
  };

  // weight0 = exp(-d) m (alpha0 = 1); P0 = weight0
  float v0[2] = {0.0f, ninf};
  for_rows(true, [&](bool ok, int, float, float, float, float, float d, float m, float& p, float& wv) {
    const float w0 = expf(-d) * m;
    wv = p = ok ? w0 : 0.0f;
    v0[0] += ok ? w0 : 0.0f;
    v0[1] = fmaxf(v0[1], ok ? w0 : ninf);
  });
  cluster_reduce<NT, 1, 1>(v0, ex, parity, phases, C, rank);
  float Sp = v0[0], wmax = v0[1], wdiv = 1.0f;  // the weights in use are w / wdiv
  float sigma2 = scal[3], gamma = 0.5f, alpha = 1.0f;
  float r00 = 1.0f, r01 = 0.0f, r10 = 0.0f, r11 = 1.0f, t0 = 0.0f, t1 = 0.0f;

  for (int it = 0; it < max_iter; ++it) {
    // P is 0 on the rows that are not valid
    float m4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for_rows(false, [&](bool, int, float x0, float x1, float y0, float y1, float, float, float& p, float&) {
      m4[0] += x0 * p;
      m4[1] += x1 * p;
      m4[2] += y0 * p;
      m4[3] += y1 * p;
    });
    cluster_reduce<NT, 4, 0>(m4, ex, parity, phases, C, rank);
    const float mx0 = m4[0] / Sp, mx1 = m4[1] / Sp, my0 = m4[2] / Sp, my1 = m4[3] / Sp;
    float a4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for_rows(false, [&](bool ok, int, float x0, float x1, float y0, float y1, float, float, float& p, float&) {
      const float X0 = (x0 - mx0) * p, X1 = (x1 - mx1) * p;
      const float Y0 = y0 - my0, Y1 = y1 - my1;
      a4[0] += ok ? Y0 * X0 : 0.0f;
      a4[1] += ok ? Y0 * X1 : 0.0f;
      a4[2] += ok ? Y1 * X0 : 0.0f;
      a4[3] += ok ? Y1 * X1 : 0.0f;
    });
    cluster_reduce<NT, 4, 0>(a4, ex, parity, phases, C, rank);
    const float ca = a4[0] + a4[3], sb = a4[2] - a4[1];
    const float nrm = sqrtf(ca * ca + sb * sb) + 1e-30f;
    const float c = ca / nrm, s = sb / nrm;
    r00 = c; r01 = -s; r10 = s; r11 = c;
    t0 = my0 - (mx0 * r00 + mx1 * r01);
    t1 = my1 - (mx0 * r10 + mx1 * r11);
    const float outlier = wmax * (1.0f - gamma) * (two_pi * sigma2) / (gamma * area);
    const bool reweight = it > 20;
    if (reweight) alpha = alpha * decay;
    float v3[3] = {0.0f, 0.0f, ninf};
    for_rows(true, [&](bool ok, int, float x0, float x1, float y0, float y1, float d, float m, float& p, float& wv) {
      const float e0 = y0 - (x0 * r00 + x1 * r01 + t0);
      const float e1 = y1 - (x0 * r10 + x1 * r11 + t1);
      const float r2 = e0 * e0 + e1 * e1;
      const float term = expf(-r2 / (2.0f * sigma2)) * (wv / wdiv);
      const float pn = term / (term + outlier);
      const float pc = fmaxf(pn, 1e-6f) * m;
      v3[0] += ok ? pn : 0.0f;
      v3[1] += ok ? r2 * pc : 0.0f;
      p = ok ? pc : 0.0f;
      if (reweight) {
        const float wn = expf(-d * alpha) * m;
        wv = ok ? wn : 0.0f;
        v3[2] = fmaxf(v3[2], ok ? wn : ninf);
      }
    });
    cluster_reduce<NT, 2, 1>(v3, ex, parity, phases, C, rank);
    Sp = v3[0];
    gamma = fminf(fmaxf(Sp / n_valid, 0.01f), 0.99f);
    sigma2 = v3[1] / (2.0f * Sp);
    if (reweight) {
      wdiv = v3[2];
      wmax = wdiv / wdiv;  // the max of the normalised weights
    }
  }

  // the final posterior at the fixed temperature
  const float fs2 = 1e-2f, fg = 0.1f;
  const float outlier = wmax * (1.0f - fg) * (two_pi * fs2) / (fg * area);
  float sp[1] = {0.0f};
  for_rows(false, [&](bool ok, int n, float x0, float x1, float y0, float y1, float, float m, float&, float& wv) {
    const float e0 = y0 - (x0 * r00 + x1 * r01 + t0);
    const float e1 = y1 - (x0 * r10 + x1 * r11 + t1);
    const float term = expf(-(e0 * e0 + e1 * e1) / (2.0f * fs2)) * (wv / wdiv);
    const float p = term / (term + outlier) * m;
    if (ok) p_out[n] = p;
    sp[0] += ok ? p : 0.0f;
  });
  cluster_reduce<NT, 1, 0>(sp, ex, parity, phases, C, rank);
  if (rank == 0 && tid == 0) {
    misc[0] = r00; misc[1] = r01; misc[2] = r10; misc[3] = r11;
    misc[4] = t0; misc[5] = t1;
    misc[6] = sigma2;
    misc[7] = fminf(fmaxf(sp[0] / n_valid, 0.01f), 0.99f);
  }
  cluster_barrier();  // no block leaves while a push to it may be in flight
}

using Kernel = void (*)(const float*, const float*, const float*, const float*, const float*, float*, float*, float*,
                        float*, int, int, int);

template <int NT>
Kernel pick(int rows_per_thread) {
  switch (rows_per_thread) {
    case 1: return inlier_kernel<NT, 1>;
    case 2: return inlier_kernel<NT, 2>;
    case 3: return inlier_kernel<NT, 3>;
    case 4: return inlier_kernel<NT, 4>;
    case 5: return inlier_kernel<NT, 5>;
    case 6: return inlier_kernel<NT, 6>;
    case 7: return inlier_kernel<NT, 7>;
    case 8: return inlier_kernel<NT, 8>;
    default: return nullptr;
  }
}

}  // namespace

// One launch of one cluster of `cluster` blocks (1, 2, 4, 8 or 16) of
// `threads` threads (256 or 512), each thread holding up to
// `rows_per_thread` rows (1 to 8) in registers; the caller's
// `inlier_layout` chooses them. P and w are [N] scratch.
extern "C" int inlier_fit(const float* x, const float* y, const float* dist, const float* mask, const float* scal,
                          float* P, float* w, float* p_out, float* misc, int N, int max_iter, int cluster, int threads,
                          int rows_per_thread, void* stream) {
  Kernel fn = threads == 256 ? pick<256>(rows_per_thread) : threads == 512 ? pick<512>(rows_per_thread) : nullptr;
  if (fn == nullptr || cluster < 1 || cluster > CMAX || (cluster & (cluster - 1)) != 0 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cluster > 8) {
    cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int per_rank = (N + cluster - 1) / cluster;
  cudaError_t err = cudaLaunchKernelEx(&cfg, fn, x, y, dist, mask, scal, P, w, p_out, misc, N, per_rank, max_iter);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
