// The previous design of spateo_tpu_torch/csrc/estep.cu, kept as it was so that
// scripts/kernel_ab_probe.py can time it against the current one on the
// same card. Not built or loaded by the package.
//
// The Morpho flash E-step on Hopper: the two sweeps over [NA, B] probability
// tiles that never leave the SM.
//
// Replaces `spateo_tpu/ops/estep_pallas.py`:
//   * `_colnorm_kernel` (sweep 1, :107) by `estep_colnorm` below: per-column
//     normalisers c1_raw = sum_i pv, c1m = sum_i mm*pv, c2 = sum_i mm*ps,
//     c3 = sum_i mm*full, then K_NB = inlier * c3 / (c3 + eps);
//   * `_rowred_kernel` (sweep 2, :149) by `estep_rowred`: per-row sums of
//     P3, P1, P2, P2*d and P3 @ coordsB (two rows), all before the mm scaling
//     that the wrapper applies.
// with, per (row i of the moving slice, column j of the minibatch),
//   d    = max(|a_i|^2 + |b_j|^2 - 2 a_i.b_j, 0)
//   pv   = exp(-d / (2 s2 / s2v)),  ps = exp(-d / (2 s2))
//   e    = sum_g fat[g, i] fbt[g, j] + bt[j]      (fat's last row is a_rows,
//                                                  fbt's last row is ones)
//   full = ps * exp(-e / (2 p))
//   P1 = pv / (so + c1m_j), P2 = inl_j ps / (c2_j + eps), P3 = inl_j full / (c3_j + eps)
//   inl_j = 1 - so / (so + c1_raw_j).
//
// What bounds it on an H100: at G' = 51 expression features each pair costs
// ~51 f32 FMAs of the expression dot per sweep against 3 exponentials and a
// few multiplies; the inputs are O((NA + B) G') bytes, so it is bound by the
// f32 FMA throughput (and the shared-memory loads feeding it), not by bytes.
// The design: 64 x 64 tiles, 256 threads, each thread a 4 x 4 register
// micro-tile of pairs; the expression dot is a small GEMM over feature
// chunks of 32 staged in shared memory; divisions by the per-call scalars
// and per-column denominators are multiplications by reciprocals computed
// once (IEEE division), `expf` (not `__expf`), no fast-math: f32 throughout,
// as the TPU kernel ran at Precision.HIGHEST. Tensor cores are not used.
//
// Skipping (both sweeps): a tile whose bounding-box gap alone proves
// d > skip_mult * s2 is flagged by the wrapper (`skip`, [n_ta * n_tb] bytes)
// and not touched; otherwise the block computes d, and skips the expression
// dot and the exponentials when no pair of the tile has d < skip_mult * s2
// (`__syncthreads_or`), since every probability there is below e^-40.
//
// Sweep 1 has too few column tiles to fill 132 SMs (B = 2000 gives 32), so
// its rows are split over a second grid dimension into S contiguous ranges;
// each block writes its partial sums, and a second small kernel adds the S
// partials in a fixed order. No float atomics: every run gives the same bits.
//
// The per-call scalars (s2, s2v, spatial outlier so, p, eps) are read from
// an [8] f32 device array, so the EM loop never reads them back to the host.
//
// Plain C interface, loaded with ctypes; every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;   // rows of the moving slice per tile
constexpr int TN = 64;   // minibatch columns per tile
constexpr int TK = 32;   // expression features per staged chunk
constexpr int NT = 256;  // threads: (ty, tx) in 16 x 16; rows ty + 16 r, columns tx + 16 c

struct Scalars {
  float inv_v, inv_s, inv_p, thr, so, eps;
};

__device__ __forceinline__ Scalars read_scalars(const float* __restrict__ scal, float skip_mult) {
  const float s2 = scal[0], s2v = scal[1], p = scal[3];
  Scalars s;
  s.inv_v = 1.0f / (2.0f * s2 / s2v);
  s.inv_s = 1.0f / (2.0f * s2);
  s.inv_p = 1.0f / (2.0f * p);
  s.thr = skip_mult * s2;
  s.so = scal[2];
  s.eps = scal[4];
  return s;
}

// The expression dot of one 64 x 64 tile into e[r][c] (without bt), over
// all G1 features in chunks of TK staged in shared memory.
__device__ __forceinline__ void expression_dot(const float* __restrict__ fat, const float* __restrict__ fbt,
                                               int NA, int B, int G1, int i0, int j0, int tx, int ty,
                                               float (&sa)[TK][TM], float (&sb)[TK][TN], float (&e)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) e[r][c] = 0.0f;
  for (int k0 = 0; k0 < G1; k0 += TK) {
    __syncthreads();  // the previous chunk has been consumed
    for (int q = threadIdx.x; q < TK * TM; q += NT) {
      const int kk = q / TM, ii = q % TM;
      const int g = k0 + kk, i = i0 + ii, j = j0 + ii;
      sa[kk][ii] = (g < G1 && i < NA) ? fat[(size_t)g * NA + i] : 0.0f;
      sb[kk][ii] = (g < G1 && j < B) ? fbt[(size_t)g * B + j] : 0.0f;
    }
    __syncthreads();
    const int kmax = min(TK, G1 - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = sa[kk][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = sb[kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) e[r][c] = fmaf(av[r], bv[c], e[r][c]);
    }
  }
}

// Sweep 1. Grid (n_tb, S): block (jt, s) owns column tile jt and row tiles
// [s * tiles_per_split, (s + 1) * tiles_per_split). Writes partial[s][q][j]
// for q in (c1_raw, c1m, c2, c3).
__global__ void __launch_bounds__(NT) colnorm_kernel(
    const float* __restrict__ xa, const float* __restrict__ cb, const float* __restrict__ fat,
    const float* __restrict__ fbt, const float* __restrict__ bt, const float* __restrict__ mm,
    const float* __restrict__ scal, const uint8_t* __restrict__ skip, float* __restrict__ partial,
    int NA, int B, int G1, int tiles_per_split, float skip_mult) {
  __shared__ float sa[TK][TM];
  __shared__ float sb[TK][TN];
  __shared__ float s_ax[TM], s_ay[TM], s_a2[TM], s_mm[TM];
  __shared__ float red[16][4][TN];

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int jt = blockIdx.x, n_tb = gridDim.x;
  const int j0 = jt * TN;
  const int n_ta = (NA + TM - 1) / TM;
  const int it_begin = blockIdx.y * tiles_per_split;
  const int it_end = min(n_ta, it_begin + tiles_per_split);
  const Scalars s = read_scalars(scal, skip_mult);

  float bx[4], by[4], b2[4], bb[4];
  bool colok[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j = j0 + tx + 16 * c;
    colok[c] = j < B;
    bx[c] = colok[c] ? cb[2 * j] : 0.0f;
    by[c] = colok[c] ? cb[2 * j + 1] : 0.0f;
    b2[c] = bx[c] * bx[c] + by[c] * by[c];
    bb[c] = colok[c] ? bt[j] : 0.0f;
  }
  float acc_v[4] = {0.f, 0.f, 0.f, 0.f}, acc_vm[4] = {0.f, 0.f, 0.f, 0.f};
  float acc_sm[4] = {0.f, 0.f, 0.f, 0.f}, acc_fm[4] = {0.f, 0.f, 0.f, 0.f};

  for (int it = it_begin; it < it_end; ++it) {
    if (skip[(size_t)it * n_tb + jt]) continue;  // uniform over the block
    const int i0 = it * TM;
    __syncthreads();  // shared row data of the previous tile is consumed
    if (threadIdx.x < TM) {
      const int i = i0 + threadIdx.x;
      const bool ok = i < NA;
      const float x = ok ? xa[2 * i] : 0.0f, y = ok ? xa[2 * i + 1] : 0.0f;
      s_ax[threadIdx.x] = x;
      s_ay[threadIdx.x] = y;
      s_a2[threadIdx.x] = x * x + y * y;
      s_mm[threadIdx.x] = ok ? mm[i] : 0.0f;
    }
    __syncthreads();

    float d[4][4];
    float dmin = __int_as_float(0x7f800000);  // +inf
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int il = ty + 16 * r;
      const bool rowok = i0 + il < NA;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float dot = s_ax[il] * bx[c] + s_ay[il] * by[c];
        d[r][c] = fmaxf(s_a2[il] + b2[c] - 2.0f * dot, 0.0f);
        if (rowok && colok[c]) dmin = fminf(dmin, d[r][c]);
      }
    }
    if (!__syncthreads_or(dmin < s.thr)) continue;

    float e[4][4];
    expression_dot(fat, fbt, NA, B, G1, i0, j0, tx, ty, sa, sb, e);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int il = ty + 16 * r;
      if (i0 + il >= NA) continue;
      const float m = s_mm[il];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pv = expf(-d[r][c] * s.inv_v);
        const float ps = expf(-d[r][c] * s.inv_s);
        const float full = ps * expf(-(e[r][c] + bb[c]) * s.inv_p);
        acc_v[c] += pv;
        acc_vm[c] += m * pv;
        acc_sm[c] += m * ps;
        acc_fm[c] += m * full;
      }
    }
  }

  // add the 16 row groups of each column in a fixed order
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int col = tx + 16 * c;
    red[ty][0][col] = acc_v[c];
    red[ty][1][col] = acc_vm[c];
    red[ty][2][col] = acc_sm[c];
    red[ty][3][col] = acc_fm[c];
  }
  __syncthreads();
  const int q = threadIdx.x / TN, col = threadIdx.x % TN;
  float sum = 0.0f;
  for (int t = 0; t < 16; ++t) sum += red[t][q][col];
  const int j = j0 + col;
  if (j < B) partial[((size_t)blockIdx.y * 4 + q) * B + j] = sum;
}

// Sweep 1, second launch: the S partials of each column in order, then K_NB.
// out rows: c1_raw, c1m, c2, c3, K_NB.
__global__ void colnorm_finalize(const float* __restrict__ partial, const float* __restrict__ scal,
                                 float* __restrict__ out, int B, int S) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= B) return;
  float c[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float sum = 0.0f;
    for (int t = 0; t < S; ++t) sum += partial[((size_t)t * 4 + q) * B + j];
    c[q] = sum;
  }
  const float so = scal[2], eps = scal[4];
  const float inl = 1.0f - so / (so + c[0]);
#pragma unroll
  for (int q = 0; q < 4; ++q) out[(size_t)q * B + j] = c[q];
  out[(size_t)4 * B + j] = inl * c[3] / (c[3] + eps);
}

// Sweep 2. Grid (n_ta): block it owns row tile it and walks every column
// tile. out rows: sum P3, sum P1, sum P2, sum P2*d, sum P3*bx, sum P3*by.
__global__ void __launch_bounds__(NT) rowred_kernel(
    const float* __restrict__ xa, const float* __restrict__ cb, const float* __restrict__ fat,
    const float* __restrict__ fbt, const float* __restrict__ bt, const float* __restrict__ colstats,
    const float* __restrict__ scal, const uint8_t* __restrict__ skip, float* __restrict__ out,
    int NA, int B, int G1, float skip_mult) {
  __shared__ float sa[TK][TM];
  __shared__ float sb[TK][TN];
  __shared__ float s_bx[TN], s_by[TN], s_b2[TN], s_bt[TN], s_w1[TN], s_w2[TN], s_w3[TN];

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int it = blockIdx.x, i0 = it * TM;
  const int n_tb = (B + TN - 1) / TN;
  const Scalars s = read_scalars(scal, skip_mult);
  const float* c1r = colstats;
  const float* c1m = colstats + B;
  const float* c2 = colstats + 2 * (size_t)B;
  const float* c3 = colstats + 3 * (size_t)B;

  float ax[4], ay[4], a2[4];
  bool rowok[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    rowok[r] = i < NA;
    ax[r] = rowok[r] ? xa[2 * i] : 0.0f;
    ay[r] = rowok[r] ? xa[2 * i + 1] : 0.0f;
    a2[r] = ax[r] * ax[r] + ay[r] * ay[r];
  }
  float r3[4] = {0.f, 0.f, 0.f, 0.f}, r1[4] = {0.f, 0.f, 0.f, 0.f}, r2[4] = {0.f, 0.f, 0.f, 0.f};
  float sg[4] = {0.f, 0.f, 0.f, 0.f}, px[4] = {0.f, 0.f, 0.f, 0.f}, py[4] = {0.f, 0.f, 0.f, 0.f};

  for (int jt = 0; jt < n_tb; ++jt) {
    if (skip[(size_t)it * n_tb + jt]) continue;  // uniform over the block
    const int j0 = jt * TN;
    __syncthreads();  // shared column data of the previous tile is consumed
    if (threadIdx.x < TN) {
      const int j = j0 + threadIdx.x;
      const bool ok = j < B;
      const float x = ok ? cb[2 * j] : 0.0f, y = ok ? cb[2 * j + 1] : 0.0f;
      s_bx[threadIdx.x] = x;
      s_by[threadIdx.x] = y;
      s_b2[threadIdx.x] = x * x + y * y;
      s_bt[threadIdx.x] = ok ? bt[j] : 0.0f;
      if (ok) {
        const float inl = 1.0f - s.so / (s.so + c1r[j]);
        s_w1[threadIdx.x] = 1.0f / (s.so + c1m[j]);
        s_w2[threadIdx.x] = inl / (c2[j] + s.eps);
        s_w3[threadIdx.x] = inl / (c3[j] + s.eps);
      } else {
        s_w1[threadIdx.x] = s_w2[threadIdx.x] = s_w3[threadIdx.x] = 0.0f;
      }
    }
    __syncthreads();

    float d[4][4];
    float dmin = __int_as_float(0x7f800000);  // +inf
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jl = tx + 16 * c;
        const float dot = ax[r] * s_bx[jl] + ay[r] * s_by[jl];
        d[r][c] = fmaxf(a2[r] + s_b2[jl] - 2.0f * dot, 0.0f);
        if (rowok[r] && j0 + jl < B) dmin = fminf(dmin, d[r][c]);
      }
    }
    if (!__syncthreads_or(dmin < s.thr)) continue;

    float e[4][4];
    expression_dot(fat, fbt, NA, B, G1, i0, j0, tx, ty, sa, sb, e);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int jl = tx + 16 * c;
      if (j0 + jl >= B) continue;
      const float w1 = s_w1[jl], w2 = s_w2[jl], w3 = s_w3[jl], bxj = s_bx[jl], byj = s_by[jl], btj = s_bt[jl];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float pv = expf(-d[r][c] * s.inv_v);
        const float ps = expf(-d[r][c] * s.inv_s);
        const float full = ps * expf(-(e[r][c] + btj) * s.inv_p);
        const float P1 = pv * w1, P2 = ps * w2, P3 = full * w3;
        r3[r] += P3;
        r1[r] += P1;
        r2[r] += P2;
        sg[r] += P2 * d[r][c];
        px[r] += P3 * bxj;
        py[r] += P3 * byj;
      }
    }
  }

  // the 16 column groups of each row sit in one half-warp: a fixed butterfly
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      r3[r] += __shfl_xor_sync(0xffffffffu, r3[r], off);
      r1[r] += __shfl_xor_sync(0xffffffffu, r1[r], off);
      r2[r] += __shfl_xor_sync(0xffffffffu, r2[r], off);
      sg[r] += __shfl_xor_sync(0xffffffffu, sg[r], off);
      px[r] += __shfl_xor_sync(0xffffffffu, px[r], off);
      py[r] += __shfl_xor_sync(0xffffffffu, py[r], off);
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (!rowok[r]) continue;
      const size_t i = (size_t)i0 + ty + 16 * r;
      out[i] = r3[r];
      out[(size_t)NA + i] = r1[r];
      out[2 * (size_t)NA + i] = r2[r];
      out[3 * (size_t)NA + i] = sg[r];
      out[4 * (size_t)NA + i] = px[r];
      out[5 * (size_t)NA + i] = py[r];
    }
  }
}

}  // namespace

extern "C" {

// Sweep 1: colstats [5, B] = (c1_raw, c1m, c2, c3, K_NB); partial is [S, 4, B]
// scratch. Two launches on `stream`.
int estep_colnorm(const float* xa, const float* cb, const float* fat, const float* fbt, const float* bt,
                  const float* mm, const float* scal, const uint8_t* skip, float* partial, float* colstats,
                  int NA, int B, int G1, int S, int tiles_per_split, float skip_mult, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tb = (B + TN - 1) / TN;
  colnorm_kernel<<<dim3(n_tb, S), NT, 0, st>>>(xa, cb, fat, fbt, bt, mm, scal, skip, partial, NA, B, G1,
                                                tiles_per_split, skip_mult);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  colnorm_finalize<<<(B + 255) / 256, 256, 0, st>>>(partial, scal, colstats, B, S);
  return static_cast<int>(cudaGetLastError());
}

// Sweep 2: out [6, NA] = row sums of P3, P1, P2, P2*d, P3*bx, P3*by.
int estep_rowred(const float* xa, const float* cb, const float* fat, const float* fbt, const float* bt,
                 const float* colstats, const float* scal, const uint8_t* skip, float* out, int NA, int B,
                 int G1, float skip_mult, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_ta = (NA + TM - 1) / TM;
  rowred_kernel<<<n_ta, NT, 0, st>>>(xa, cb, fat, fbt, bt, colstats, scal, skip, out, NA, B, G1, skip_mult);
  return static_cast<int>(cudaGetLastError());
}

// The tile sizes the wrapper must cut the skip mask with.
int estep_tile_rows() { return TM; }
int estep_tile_cols() { return TN; }

}  // extern "C"
