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
// ~51 FMAs of the expression dot per sweep against 3 exponentials and a few
// multiplies (about 129 flops for sweep 2, 121 for sweep 1); the inputs are
// O((NA + B) G') bytes, so it is bound by operations, not by bytes.
// Both sweeps share one design over 64 x 64 tiles, 256 threads each owning
// a 4 x 4 register micro-tile of pairs: one side's tile stays resident in
// shared memory, the other side's tiles stream through a cp.async ring
// (`RingLayout`), and 16-byte shared loads feed an f32 FMA dot. Sweep 2
// keeps a row tile and streams column tiles (`rowred_kernel`); sweep 1
// keeps a column tile and streams row tiles (`colnorm_kernel`). Both
// divide by the per-call scalars and per-column
// denominators as multiplications by reciprocals computed once (IEEE
// division), use `expf` (not `__expf`) and no fast-math: f32 accuracy
// throughout, as the TPU kernel ran at Precision.HIGHEST.
//
// Skipping (both sweeps): a tile whose bounding-box gap alone proves
// d > skip_mult * s2 is flagged by the wrapper (`skip`, [n_ta * n_tb] bytes)
// and not touched; otherwise the block computes d, and skips the expression
// dot and the exponentials when no pair of the tile (sweep 2) or of the
// warp's part of it (sweep 1) has d < skip_mult * s2, since every
// probability there is below e^-40.
//
// Sweep 1 has too few column tiles to fill 132 SMs (B = 2000 gives 32), so
// each column tile's live row tiles are dealt over a second grid dimension
// of S blocks; each block writes its partial sums, and a second small
// kernel adds the S partials in a fixed order. No float atomics: every run
// gives the same bits.
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
constexpr int NT = 256;  // threads: 16 x 16, each a 4 x 4 micro-tile of pairs

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

// Sweep 2: the row reductions, redesigned for Hopper.
//
// Grid (n_ta, S): block (it, s) owns row tile it (64 rows) and the column
// tiles [s * tiles_per_split, (s + 1) * tiles_per_split); with S > 1 it
// writes partial[s][6][NA] and `rowred_finalize` adds the S partials of each
// row in order (S is chosen by the wrapper so that 20k rows still spread
// over the card). 256 threads: thread (ty, tx) in 16 x 16 owns the 4 x 4
// pairs of rows 4 ty .. 4 ty + 3 and columns 4 tx .. 4 tx + 3 of each 64 x 64
// tile, so the rows of one half-warp are the same four.
//   * The block's rows stay resident: when G1 <= RK (the benchmark's 51),
//     its 64 rows of fat are loaded once into shared memory and serve every
//     column tile. With more features the fat chunk travels in the ring
//     beside the fbt chunk.
//   * The column tiles stream through a ring of RSTAGES stages filled by
//     cp.async (zero-filled past G1 and B), issued RSTAGES - 1 steps ahead,
//     so the next tiles' loads overlap this tile's exponentials. A step is
//     one chunk of RK features of one column tile; each stage also carries
//     the tile's raw column data (cb, bt, c1_raw, c1m, c2, c3), from which
//     64 threads form the column weights once per tile.
//   * The expression dot is an f32 FMA chain over the features in order,
//     fed by two 16-byte shared loads (4 rows, 4 columns) per 16 FMAs.
//     The dot is not on the tensor cores: on an H100, 3xTF32 (mma.m16n8k8
//     on hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi)) moved the row sums
//     by 1.1e-4 - 2.0e-4 of their scale against the plain version, and even
//     an f64 dot (mma.m8n8k4.f64) by 1.1e-4, above the 1e-4 bar: at
//     p = 0.01, exp(-e / (2 p)) scales any difference in e by 50, and only
//     a dot rounded as the plain version's f32 chain agrees with it closely
//     enough (PERF.md).
//   * The tile skip stays: tiles flagged by the bounding-box mask are never
//     loaded; a tile with no pair at d < skip_mult * s2 skips its dot and
//     its exponentials (`__syncthreads_or`). The 16 column groups of a row
//     are added in a fixed butterfly at the end. No float atomics: the same
//     bits every run.

constexpr int RK = 64;          // features per ring step
constexpr int RLD = TM + 4;     // row stride of the k-major chunks (16-byte aligned)
constexpr int RSTAGES = 3;      // ring depth
constexpr int RCOL = 7 * TN;    // raw column data per stage: cb (2 TN), bt, c1_raw, c1m, c2, c3

constexpr int ROWRED_EXTRA = RCOL + 3 * TN;  // rowred's stage data: raw columns, the weights w1, w2, w3
constexpr int COLNORM_EXTRA = 3 * TM;        // colnorm's stage data: xa (2 TM), mm

// The dynamic shared-memory layout (in floats) of one block of either
// sweep: the resident side's feature tile (when G1 <= RK), RSTAGES ring
// stages, then the block's list of live tiles (ints). A stage holds the
// streamed side's feature chunk [kr][RLD], `extra` floats of that tile's own
// data, and, when the resident side does not fit, its feature chunk too.
struct RingLayout {
  int kr;       // feature rows a step holds: min(RK, G1 rounded up to 4)
  bool res;     // the resident side's whole feature tile is in shared memory
  int stage;    // floats per ring stage
  int ring;     // float offset of stage 0
  int live;     // float offset of the live-tile list (ints)
  __host__ __device__ RingLayout(int G1, int extra) {
    const int g4 = (G1 + 3) / 4 * 4;
    kr = g4 < RK ? g4 : RK;
    res = G1 <= RK;
    stage = kr * RLD + extra + (res ? 0 : kr * RLD);
    ring = res ? kr * RLD : 0;
    live = ring + RSTAGES * stage;
  }
  __host__ __device__ size_t bytes(int n_list) const {
    return sizeof(float) * (size_t(live) + size_t(n_list));
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4-byte async copy global -> shared; zero-fills when !ok.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(RSTAGES - 2) : "memory");
}

__global__ void __launch_bounds__(NT, 2) rowred_kernel(
    const float* __restrict__ xa, const float* __restrict__ cb, const float* __restrict__ fat,
    const float* __restrict__ fbt, const float* __restrict__ bt, const float* __restrict__ colstats,
    const float* __restrict__ scal, const uint8_t* __restrict__ skip, float* __restrict__ out, int NA, int B,
    int G1, int tiles_per_split, float skip_mult) {
  extern __shared__ float4 rowred_smem4[];
  float* sm = reinterpret_cast<float*>(rowred_smem4);
  __shared__ int s_n_live;

  const RingLayout L(G1, ROWRED_EXTRA);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int it = blockIdx.x, i0 = it * TM;
  const int n_tb = (B + TN - 1) / TN;
  const int jt_begin = blockIdx.y * tiles_per_split;
  const int jt_end = min(n_tb, jt_begin + tiles_per_split);
  const int n_kc = (G1 + RK - 1) / RK;
  const Scalars s = read_scalars(scal, skip_mult);
  int* live = reinterpret_cast<int*>(sm + L.live);

  if (tid == 0) {
    int n = 0;
    for (int jt = jt_begin; jt < jt_end; ++jt)
      if (!skip[(size_t)it * n_tb + jt]) live[n++] = jt;
    s_n_live = n;
  }
  if (L.res) {
    for (int e = tid; e < L.kr * TM; e += NT) {
      const int kk = e / TM, ii = e % TM, i = i0 + ii;
      sm[kk * RLD + ii] = (kk < G1 && i < NA) ? fat[(size_t)kk * NA + i] : 0.0f;
    }
  }
  // this thread's four rows
  float ax[4], ay[4], a2[4];
  bool rowok[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * ty + r;
    rowok[r] = i < NA;
    ax[r] = rowok[r] ? xa[2 * i] : 0.0f;
    ay[r] = rowok[r] ? xa[2 * i + 1] : 0.0f;
    a2[r] = ax[r] * ax[r] + ay[r] * ay[r];
  }
  __syncthreads();
  const int n_steps = s_n_live * n_kc;

  // step q: feature chunk q % n_kc of column tile live[q / n_kc], into stage q % RSTAGES
  auto issue = [&](int q) {
    float* st = sm + L.ring + (q % RSTAGES) * L.stage;
    const int j0 = live[q / n_kc] * TN, g0 = (q % n_kc) * RK;
    for (int e = tid; e < L.kr * TN; e += NT) {
      const int kk = e / TN, jj = e % TN, gg = g0 + kk, j = j0 + jj;
      const bool ok = gg < G1 && j < B;
      cp_async4(st + kk * RLD + jj, ok ? fbt + (size_t)gg * B + j : fbt, ok);
    }
    float* col = st + L.kr * RLD;
    for (int e = tid; e < RCOL; e += NT) {
      const int part = e / TN, jj = e % TN;
      if (part < 2) {  // cb, two floats per column
        const int idx = 2 * j0 + e;
        cp_async4(col + e, idx < 2 * B ? cb + idx : cb, idx < 2 * B);
      } else {
        const int j = j0 + jj;
        const float* src = part == 2 ? bt : colstats + (size_t)(part - 3) * B;  // c1_raw, c1m, c2, c3
        cp_async4(col + e, j < B ? src + j : src, j < B);
      }
    }
    if (!L.res) {
      float* sa = col + RCOL + 3 * TN;
      for (int e = tid; e < L.kr * TM; e += NT) {
        const int kk = e / TM, ii = e % TM, gg = g0 + kk, i = i0 + ii;
        const bool ok = gg < G1 && i < NA;
        cp_async4(sa + kk * RLD + ii, ok ? fat + (size_t)gg * NA + i : fat, ok);
      }
    }
  };

#pragma unroll
  for (int q = 0; q < RSTAGES - 1; ++q) {
    if (q < n_steps) issue(q);
    cp_async_commit();
  }

  float e[4][4], d[4][4];
  float r3[4] = {0.f, 0.f, 0.f, 0.f}, r1[4] = {0.f, 0.f, 0.f, 0.f}, r2[4] = {0.f, 0.f, 0.f, 0.f};
  float sg[4] = {0.f, 0.f, 0.f, 0.f}, px[4] = {0.f, 0.f, 0.f, 0.f}, py[4] = {0.f, 0.f, 0.f, 0.f};
  bool tile_live = false;

  for (int q = 0; q < n_steps; ++q) {
    cp_async_wait_ring();
    __syncthreads();  // stage q has landed for every thread; stage q - 1 is consumed
    if (q + RSTAGES - 1 < n_steps) issue(q + RSTAGES - 1);
    cp_async_commit();

    float* st = sm + L.ring + (q % RSTAGES) * L.stage;
    float* col = st + L.kr * RLD;  // cb[2 TN], bt, c1_raw, c1m, c2, c3
    float* wts = col + RCOL;       // w1, w2, w3 [TN] each
    const int kc = q % n_kc, j0 = live[q / n_kc] * TN;

    if (kc == n_kc - 1 && tid < TN) {
      const bool ok = j0 + tid < B;
      const float inl = 1.0f - s.so / (s.so + col[3 * TN + tid]);
      wts[tid] = ok ? 1.0f / (s.so + col[4 * TN + tid]) : 0.0f;
      wts[TN + tid] = ok ? inl / (col[5 * TN + tid] + s.eps) : 0.0f;
      wts[2 * TN + tid] = ok ? inl / (col[6 * TN + tid] + s.eps) : 0.0f;
    }
    if (kc == 0) {
      const float4 b01 = *reinterpret_cast<const float4*>(col + 8 * tx);
      const float4 b23 = *reinterpret_cast<const float4*>(col + 8 * tx + 4);
      const float bx[4] = {b01.x, b01.z, b23.x, b23.z}, by[4] = {b01.y, b01.w, b23.y, b23.w};
      float dmin = __int_as_float(0x7f800000);  // +inf
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float b2 = bx[c] * bx[c] + by[c] * by[c];
        const bool colok = j0 + 4 * tx + c < B;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float dot = ax[r] * bx[c] + ay[r] * by[c];
          d[r][c] = fmaxf(a2[r] + b2 - 2.0f * dot, 0.0f);
          e[r][c] = 0.0f;
          if (rowok[r] && colok) dmin = fminf(dmin, d[r][c]);
        }
      }
      // also publishes the weights when the tile has one chunk
      tile_live = __syncthreads_or(dmin < s.thr);
    } else if (kc == n_kc - 1) {
      __syncthreads();  // the weights
    }
    if (!tile_live) continue;

    // the expression dot of this chunk: one f32 FMA chain per pair, features in order
    const float* sA = L.res ? sm : wts + 3 * TN;
    const int kmax = min(RK, G1 - kc * RK);
#pragma unroll 4
    for (int kk = 0; kk < kmax; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(sA + kk * RLD + 4 * ty);
      const float4 bv = *reinterpret_cast<const float4*>(st + kk * RLD + 4 * tx);
      const float a[4] = {av.x, av.y, av.z, av.w}, b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) e[r][c] = fmaf(a[r], b[c], e[r][c]);
    }
    if (kc != n_kc - 1) continue;

    // epilogue: the tile's pairs into this thread's four rows
    const float4 b01 = *reinterpret_cast<const float4*>(col + 8 * tx);
    const float4 b23 = *reinterpret_cast<const float4*>(col + 8 * tx + 4);
    const float bx[4] = {b01.x, b01.z, b23.x, b23.z}, by[4] = {b01.y, b01.w, b23.y, b23.w};
    const float4 btv = *reinterpret_cast<const float4*>(col + 2 * TN + 4 * tx);
    const float4 w1v = *reinterpret_cast<const float4*>(wts + 4 * tx);
    const float4 w2v = *reinterpret_cast<const float4*>(wts + TN + 4 * tx);
    const float4 w3v = *reinterpret_cast<const float4*>(wts + 2 * TN + 4 * tx);
    const float btc[4] = {btv.x, btv.y, btv.z, btv.w}, w1[4] = {w1v.x, w1v.y, w1v.z, w1v.w};
    const float w2[4] = {w2v.x, w2v.y, w2v.z, w2v.w}, w3[4] = {w3v.x, w3v.y, w3v.z, w3v.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float pv = expf(-d[r][c] * s.inv_v);
        const float ps = expf(-d[r][c] * s.inv_s);
        const float full = ps * expf(-(e[r][c] + btc[c]) * s.inv_p);
        const float P1 = pv * w1[c], P2 = ps * w2[c], P3 = full * w3[c];
        r3[r] += P3;
        r1[r] += P1;
        r2[r] += P2;
        sg[r] += P2 * d[r][c];
        px[r] += P3 * bx[c];
        py[r] += P3 * by[c];
      }
    }
  }
  cp_async_wait_all();

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
    float* o = out + (size_t)blockIdx.y * 6 * NA;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (!rowok[r]) continue;
      const size_t i = (size_t)i0 + 4 * ty + r;
      o[i] = r3[r];
      o[(size_t)NA + i] = r1[r];
      o[2 * (size_t)NA + i] = r2[r];
      o[3 * (size_t)NA + i] = sg[r];
      o[4 * (size_t)NA + i] = px[r];
      o[5 * (size_t)NA + i] = py[r];
    }
  }
}

// Sweep 2, second launch when the columns were split: the S partials of
// each output in order.
__global__ void rowred_finalize(const float* __restrict__ partial, float* __restrict__ out, int n, int S) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float sum = 0.0f;
  for (int t = 0; t < S; ++t) sum += partial[(size_t)t * n + e];
  out[e] = sum;
}


// Sweep 1: the column normalisers, redesigned for Hopper as `rowred_kernel`
// with rows and columns swapped.
//
// Grid (n_tb, S): block (jt, s) owns column tile jt (64 columns). It lists,
// in order, the row tiles the bounding-box mask leaves live for jt, and
// takes the k-th of them when k % S == s, so the S blocks of a column tile
// get the same number of live tiles to within one wherever along the rows
// they lie (Morton-ordered rows put them in a narrow band). The list depends
// only on the mask, so `colnorm_finalize` adds the S partials in one fixed
// order: the same bits every run. 256 threads: thread (cg, rg) = (tid >> 4,
// tid & 15) owns the 4 x 4 pairs of rows 4 rg .. 4 rg + 3 and columns
// 4 cg .. 4 cg + 3 of each 64 x 64 tile, so the 16 row groups of a column
// group sit in one half-warp and its sums end in a fixed butterfly.
//   * The block's columns stay resident: when G1 <= RK its fbt tile is
//     loaded once into shared memory, and each thread keeps cb and bt of its
//     four columns in registers. With more features the fbt chunk travels in
//     the ring beside the fat chunk.
//   * Row tiles stream through the ring of RSTAGES stages filled by cp.async
//     (zero-filled past G1 and NA), issued RSTAGES - 1 steps ahead; a step is
//     one chunk of RK features of one row tile, and each stage also carries
//     the tile's xa and mm.
//   * The dot and the exponentials are rowred's. The tile skip is finer:
//     tiles flagged by the mask are never listed, and each warp skips the
//     dot and exponentials of its own 64 x 8 pairs when none of them has
//     d < skip_mult * s2 (`__any_sync`, no block barrier), which is faster
//     than a block-wide `__syncthreads_or` where most tiles skip (PERF.md).
__global__ void __launch_bounds__(NT, 2) colnorm_kernel(
    const float* __restrict__ xa, const float* __restrict__ cb, const float* __restrict__ fat,
    const float* __restrict__ fbt, const float* __restrict__ bt, const float* __restrict__ mm,
    const float* __restrict__ scal, const uint8_t* __restrict__ skip, float* __restrict__ partial, int NA, int B,
    int G1, float skip_mult) {
  extern __shared__ float4 colnorm_smem4[];
  float* sm = reinterpret_cast<float*>(colnorm_smem4);
  __shared__ int s_warp[NT / 32];

  const RingLayout L(G1, COLNORM_EXTRA);
  const int tid = threadIdx.x, rg = tid & 15, cg = tid >> 4, lane = tid & 31, warp = tid >> 5;
  const int jt = blockIdx.x, n_tb = gridDim.x, j0 = jt * TN;
  const int split = blockIdx.y, S = gridDim.y;
  const int n_ta = (NA + TM - 1) / TM;
  const int n_kc = (G1 + RK - 1) / RK;
  const Scalars s = read_scalars(scal, skip_mult);
  int* list = reinterpret_cast<int*>(sm + L.live);

  if (L.res) {
    for (int e = tid; e < L.kr * TN; e += NT) {
      const int kk = e / TN, jj = e % TN, j = j0 + jj;
      sm[kk * RLD + jj] = (kk < G1 && j < B) ? fbt[(size_t)kk * B + j] : 0.0f;
    }
  }
  // this thread's four columns
  float bx[4], by[4], b2[4], bb[4];
  bool colok[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j = j0 + 4 * cg + c;
    colok[c] = j < B;
    bx[c] = colok[c] ? cb[2 * j] : 0.0f;
    by[c] = colok[c] ? cb[2 * j + 1] : 0.0f;
    b2[c] = bx[c] * bx[c] + by[c] * by[c];
    bb[c] = colok[c] ? bt[j] : 0.0f;
  }
  // the live row tiles of column tile jt in order, NT at a time: the k-th
  // goes to split k % S
  int n_live = 0;
  for (int base = 0; base < n_ta; base += NT) {
    const int it = base + tid;
    const bool lv = it < n_ta && !skip[(size_t)it * n_tb + jt];
    const unsigned bal = __ballot_sync(0xffffffffu, lv);
    if (lane == 0) s_warp[warp] = __popc(bal);
    __syncthreads();
    int k = n_live + __popc(bal & ((1u << lane) - 1u));
    for (int w = 0; w < NT / 32; ++w) {
      if (w < warp) k += s_warp[w];
      n_live += s_warp[w];
    }
    if (lv && k % S == split) list[k / S] = it;
    __syncthreads();  // s_warp is reused; the list and the resident tile are published
  }
  const int n_steps = (n_live > split ? (n_live - split + S - 1) / S : 0) * n_kc;

  // step q: feature chunk q % n_kc of row tile list[q / n_kc], into stage q % RSTAGES
  auto issue = [&](int q) {
    float* st = sm + L.ring + (q % RSTAGES) * L.stage;
    const int i0 = list[q / n_kc] * TM, g0 = (q % n_kc) * RK;
    for (int e = tid; e < L.kr * TM; e += NT) {
      const int kk = e / TM, ii = e % TM, gg = g0 + kk, i = i0 + ii;
      const bool ok = gg < G1 && i < NA;
      cp_async4(st + kk * RLD + ii, ok ? fat + (size_t)gg * NA + i : fat, ok);
    }
    float* row = st + L.kr * RLD;  // xa [2 TM], mm [TM]
    for (int e = tid; e < COLNORM_EXTRA; e += NT) {
      if (e < 2 * TM) {
        const int idx = 2 * i0 + e;
        cp_async4(row + e, idx < 2 * NA ? xa + idx : xa, idx < 2 * NA);
      } else {
        const int i = i0 + e - 2 * TM;
        cp_async4(row + e, i < NA ? mm + i : mm, i < NA);
      }
    }
    if (!L.res) {
      float* sb = row + COLNORM_EXTRA;
      for (int e = tid; e < L.kr * TN; e += NT) {
        const int kk = e / TN, jj = e % TN, gg = g0 + kk, j = j0 + jj;
        const bool ok = gg < G1 && j < B;
        cp_async4(sb + kk * RLD + jj, ok ? fbt + (size_t)gg * B + j : fbt, ok);
      }
    }
  };

#pragma unroll
  for (int q = 0; q < RSTAGES - 1; ++q) {
    if (q < n_steps) issue(q);
    cp_async_commit();
  }

  float e[4][4], d[4][4];
  float acc_v[4] = {0.f, 0.f, 0.f, 0.f}, acc_vm[4] = {0.f, 0.f, 0.f, 0.f};
  float acc_sm[4] = {0.f, 0.f, 0.f, 0.f}, acc_fm[4] = {0.f, 0.f, 0.f, 0.f};
  bool rowok[4] = {false, false, false, false};
  bool tile_live = false;

  for (int q = 0; q < n_steps; ++q) {
    cp_async_wait_ring();
    __syncthreads();  // stage q has landed for every thread; stage q - 1 is consumed
    if (q + RSTAGES - 1 < n_steps) issue(q + RSTAGES - 1);
    cp_async_commit();

    const float* st = sm + L.ring + (q % RSTAGES) * L.stage;
    const float* row = st + L.kr * RLD;
    const int kc = q % n_kc, i0 = list[q / n_kc] * TM;

    if (kc == 0) {
      const float4 a01 = *reinterpret_cast<const float4*>(row + 8 * rg);
      const float4 a23 = *reinterpret_cast<const float4*>(row + 8 * rg + 4);
      const float ax[4] = {a01.x, a01.z, a23.x, a23.z}, ay[4] = {a01.y, a01.w, a23.y, a23.w};
      float dmin = __int_as_float(0x7f800000);  // +inf
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a2 = ax[r] * ax[r] + ay[r] * ay[r];
        rowok[r] = i0 + 4 * rg + r < NA;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float dot = ax[r] * bx[c] + ay[r] * by[c];
          d[r][c] = fmaxf(a2 + b2[c] - 2.0f * dot, 0.0f);
          e[r][c] = 0.0f;
          if (rowok[r] && colok[c]) dmin = fminf(dmin, d[r][c]);
        }
      }
      // a warp whose 64 x 8 pairs are all past the threshold skips them
      tile_live = __any_sync(0xffffffffu, dmin < s.thr);
    }
    if (!tile_live) continue;

    // the expression dot of this chunk: one f32 FMA chain per pair, features in order
    const float* sB = L.res ? sm : row + COLNORM_EXTRA;
    const int kmax = min(RK, G1 - kc * RK);
#pragma unroll 4
    for (int kk = 0; kk < kmax; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(st + kk * RLD + 4 * rg);
      const float4 bv = *reinterpret_cast<const float4*>(sB + kk * RLD + 4 * cg);
      const float a[4] = {av.x, av.y, av.z, av.w}, b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) e[r][c] = fmaf(a[r], b[c], e[r][c]);
    }
    if (kc != n_kc - 1) continue;

    // epilogue: the tile's pairs into this thread's four columns
    const float4 mv = *reinterpret_cast<const float4*>(row + 2 * TM + 4 * rg);
    const float m[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (!rowok[r]) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pv = expf(-d[r][c] * s.inv_v);
        const float ps = expf(-d[r][c] * s.inv_s);
        const float full = ps * expf(-(e[r][c] + bb[c]) * s.inv_p);
        acc_v[c] += pv;
        acc_vm[c] += m[r] * pv;
        acc_sm[c] += m[r] * ps;
        acc_fm[c] += m[r] * full;
      }
    }
  }
  cp_async_wait_all();

  // the 16 row groups of each column sit in one half-warp: a fixed butterfly
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      acc_v[c] += __shfl_xor_sync(0xffffffffu, acc_v[c], off);
      acc_vm[c] += __shfl_xor_sync(0xffffffffu, acc_vm[c], off);
      acc_sm[c] += __shfl_xor_sync(0xffffffffu, acc_sm[c], off);
      acc_fm[c] += __shfl_xor_sync(0xffffffffu, acc_fm[c], off);
    }
  }
  if (rg == 0) {
    float* o = partial + (size_t)split * 4 * B;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (!colok[c]) continue;
      const size_t j = (size_t)j0 + 4 * cg + c;
      o[j] = acc_v[c];
      o[(size_t)B + j] = acc_vm[c];
      o[2 * (size_t)B + j] = acc_sm[c];
      o[3 * (size_t)B + j] = acc_fm[c];
    }
  }
}

}  // namespace

extern "C" {

// Sweep 1: colstats [5, B] = (c1_raw, c1m, c2, c3, K_NB); partial is [S, 4, B]
// scratch, S the blocks dealt each column tile's live row tiles. Two
// launches on `stream`.
int estep_colnorm(const float* xa, const float* cb, const float* fat, const float* fbt, const float* bt,
                  const float* mm, const float* scal, const uint8_t* skip, float* partial, float* colstats,
                  int NA, int B, int G1, int S, float skip_mult, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_ta = (NA + TM - 1) / TM, n_tb = (B + TN - 1) / TN;
  const size_t smem = RingLayout(G1, COLNORM_EXTRA).bytes((n_ta + S - 1) / S);
  cudaError_t err = cudaFuncSetAttribute(colnorm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  colnorm_kernel<<<dim3(n_tb, S), NT, smem, st>>>(xa, cb, fat, fbt, bt, mm, scal, skip, partial, NA, B, G1,
                                                   skip_mult);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  colnorm_finalize<<<(B + 255) / 256, 256, 0, st>>>(partial, scal, colstats, B, S);
  return static_cast<int>(cudaGetLastError());
}

// Sweep 2: out [6, NA] = row sums of P3, P1, P2, P2*d, P3*bx, P3*by. With
// S > 1 column splits, partial is [S, 6, NA] scratch and a second launch
// adds the splits; with S == 1 partial is unused (may be null).
int estep_rowred(const float* xa, const float* cb, const float* fat, const float* fbt, const float* bt,
                 const float* colstats, const float* scal, const uint8_t* skip, float* partial, float* out, int NA,
                 int B, int G1, int S, int tiles_per_split, float skip_mult, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_ta = (NA + TM - 1) / TM;
  const size_t smem = RingLayout(G1, ROWRED_EXTRA).bytes(tiles_per_split);
  cudaError_t err = cudaFuncSetAttribute(rowred_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rowred_kernel<<<dim3(n_ta, S), NT, smem, st>>>(xa, cb, fat, fbt, bt, colstats, scal, skip, S > 1 ? partial : out,
                                                   NA, B, G1, tiles_per_split, skip_mult);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return static_cast<int>(err);
  const int n = 6 * NA;
  rowred_finalize<<<(n + 255) / 256, 256, 0, st>>>(partial, out, n, S);
  return static_cast<int>(cudaGetLastError());
}

// The tile sizes the wrapper must cut the skip mask with.
int estep_tile_rows() { return TM; }
int estep_tile_cols() { return TN; }

}  // extern "C"
