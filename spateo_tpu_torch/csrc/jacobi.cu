// Jacobi sweeps of the Dirichlet heat equation on a raster, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_jacobi_pallas_block` in spateo_tpu/ops/stencil.py
// (run by `_jacobi_kernel(use_pallas=True)` from `jacobi_solve`). One call of
// `jacobi_block_f32` runs n sweeps over an [H, W] f32 field f; in each sweep,
// for every pixel with upd != 0 that is not on the outermost ring,
//   f'[y,x] = 0.25 * (((f[y+1,x] + f[y-1,x]) + f[y,x+1]) + f[y,x-1])
// and every other pixel keeps its value. That is the arithmetic of the JAX
// package's XLA step (stencil.py:97-105: the operands of roll(-1,0),
// roll(1,0), roll(-1,1), roll(1,1), in that order, then a select), and not
// the TPU kernel's blend f + upd*(avg - f), which exists there only because
// comparisons did not lower on that target. Frozen pixels (upd == 0: the
// Dirichlet set) never move.
//
// What bounds it: operations. A sweep is about 5 flops per moving pixel
// (0.077 us per 1024^2 sweep at the f32 peak); the field is 4 MB at 1024^2
// and stays in the 50 MB L2, so device memory is not the limit. A tile in
// shared memory needs 4 loads and a store per pixel, which run the
// shared-memory pipe at a quarter of the FP32 rate; this design keeps the
// tile in registers instead. It issues ~6 instructions a pixel, and its
// pace is set by latency at 12 warps per SM (PERF.md).
//
// Design: temporal blocking with the tile in registers.
//   * A block of NW warps owns an extended tile of EX = 32 * C columns and
//     EY = NW * R rows: lane l of warp w holds the C adjacent columns
//     C*l .. C*l + C-1 of the R rows R*w .. R*w + R-1 in registers. Up and
//     down neighbours inside a strip are registers; left and right
//     neighbours inside a lane too, and across lanes they come by
//     __shfl_up_sync / __shfl_down_sync (two shuffles per row of C pixels).
//   * Only the strips' end rows go through shared memory, once per sweep:
//     warp w writes its top and bottom rows (double-buffered by the sweep's
//     parity) and meets each neighbour warp at a named barrier of two warps
//     (`bar.sync id, 64`), even warps pairing downwards first and odd warps
//     upwards, so all pairs meet in two rounds. No block-wide barrier runs
//     in the sweep loop.
//   * The extended tile's outer T rows and columns are halo: their
//     neighbours outside the tile are stale (lane 0's left and lane 31's
//     right shuffle return the lane's own value, the outer warps reuse their
//     own edge rows), and the error moves inwards one pixel per sweep, so
//     after k <= T sweeps the inner TILE_X x TILE_Y = (EX - 2T) x (EY - 2T)
//     pixels are exact. The block writes those.
//   * Each pixel's moving bit (upd != 0, off the raster's outer ring, inside
//     the raster) is one bit of a 64-bit register; pixels outside the raster
//     load as 0 and are frozen. Any H and W.
//   * `jacobi_block_f32` ping-pongs two device buffers over ceil(n / T)
//     launches, the last running the remaining n - T*(launches-1) sweeps.
//   * Given a weight raster, the last launch also writes each block's sums
//     of (new - f)^2 w and new^2 w over its output pixels in f64 (f being
//     the call's input, never modified), reduced in a fixed order, and
//     `jacobi_err_finalize` adds the blocks' partials in a fixed order and
//     writes err = sqrt(sum d2 / max(sum n2, 1e-30)) as f32 on the device.
//     No atomics: the same bits every run.
//
// Compile-time choice (override with -D): T = JACOBI_T sweeps per launch,
// R = JACOBI_R rows per lane, NW = JACOBI_NW warps per block; C = 4 columns
// per lane. The default, T = 14, R = 10, NW = 12, gives a 100 x 92 output
// tile (a halo recompute of 1.67x), 132 blocks at 1024^2 (one for each SM
// of an H100), 384 threads and 115 registers a thread; it was the fastest
// of the choices tried on the PDE (1024^2) and digitize (2048^2) rasters
// taken together. `scripts/jacobi_tile_probe.py` times other choices.
//
// Numerics: __fadd_rn/__fmul_rn keep nvcc from contracting or reordering,
// and the shuffled and shared operands enter in the XLA step's order, so the
// result is bit-identical to the plain PyTorch version,
// `jacobi_block_reference`. Do not build with -use_fast_math.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#ifndef JACOBI_T
#define JACOBI_T 14
#endif
#ifndef JACOBI_R
#define JACOBI_R 10
#endif
#ifndef JACOBI_NW
#define JACOBI_NW 12
#endif

namespace {

constexpr int T = JACOBI_T;
constexpr int R = JACOBI_R;
constexpr int NW = JACOBI_NW;
constexpr int C = 4;
constexpr int EX = 32 * C;       // extended tile width
constexpr int EY = NW * R;       // extended tile height
constexpr int TILE_X = EX - 2 * T;
constexpr int TILE_Y = EY - 2 * T;
constexpr int NT = 32 * NW;
constexpr size_t SMEM_BYTES = size_t(2) * NW * 2 * EX * sizeof(float);

static_assert(T >= 1 && TILE_X >= 1 && TILE_Y >= 1, "the halo must leave an output tile");
static_assert(R * C <= 64, "a lane's moving bits must fit one 64-bit register");
static_assert(NW >= 1 && NW <= 16, "named barriers 1..NW-1 must exist");
static_assert(SMEM_BYTES <= 48 * 1024, "the edge rows must fit static shared memory");

__device__ __forceinline__ void pair_barrier(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}

__device__ __forceinline__ float jacobi_avg(float down, float up, float right, float left) {
  return __fmul_rn(0.25f, __fadd_rn(__fadd_rn(__fadd_rn(down, up), right), left));
}

// One sweep of a lane's R x C strip, given the rows above (a) and below (b)
// it; a pixel moves where its bit of `bits` is set.
__device__ __forceinline__ void sweep_strip(float (&v)[R][C], uint64_t bits, float4 a, float4 b) {
  float prev[C] = {a.x, a.y, a.z, a.w};
  const float below[C] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float left0 = __shfl_up_sync(0xffffffffu, v[r][C - 1], 1);
    const float rightC = __shfl_down_sync(0xffffffffu, v[r][0], 1);
    float nv[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float down = (r + 1 < R) ? v[r + 1][c] : below[c];
      const float right = (c + 1 < C) ? v[r][c + 1] : rightC;
      const float left = (c > 0) ? v[r][c - 1] : left0;
      const float avg = jacobi_avg(down, prev[c], right, left);
      nv[c] = ((bits >> (r * C + c)) & 1) ? avg : v[r][c];
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      prev[c] = v[r][c];
      v[r][c] = nv[c];
    }
  }
}

__global__ void __launch_bounds__(NT)
    jacobi_kernel(const float* __restrict__ src, const uint8_t* __restrict__ upd, float* __restrict__ dst, int H,
                  int W, int k, const float* __restrict__ orig, const float* __restrict__ weight,
                  double* __restrict__ partial) {
  // edge[parity][warp][0: top row, 1: bottom row][column]
  __shared__ float edge[2][NW][2][EX];
  __shared__ double red[NW][2];
  const int lane = int(threadIdx.x) & 31;
  const int w = int(threadIdx.x) >> 5;
  const int x0 = int(blockIdx.x) * TILE_X - T;  // raster column of extended column 0
  const int y0 = int(blockIdx.y) * TILE_Y - T;  // raster row of extended row 0
  const int cx = C * lane;                      // this lane's first extended column
  const int ry = R * w;                         // this warp's first extended row

  float v[R][C];
  uint64_t bits = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int gy = y0 + ry + r;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int gx = x0 + cx + c;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const size_t p = size_t(gy) * W + gx;
      v[r][c] = in ? src[p] : 0.0f;
      if (in && gy >= 1 && gy < H - 1 && gx >= 1 && gx < W - 1 && upd[p] != 0) bits |= uint64_t(1) << (r * C + c);
    }
  }

  for (int s = 0; s < k; ++s) {
    float(*ed)[2][EX] = edge[s & 1];
    *reinterpret_cast<float4*>(&ed[w][0][cx]) = make_float4(v[0][0], v[0][1], v[0][2], v[0][3]);
    *reinterpret_cast<float4*>(&ed[w][1][cx]) = make_float4(v[R - 1][0], v[R - 1][1], v[R - 1][2], v[R - 1][3]);
    // meet the warp below (barrier w + 1) and the warp above (barrier w)
    if (w & 1) {
      pair_barrier(w);
      if (w + 1 < NW) pair_barrier(w + 1);
    } else {
      if (w + 1 < NW) pair_barrier(w + 1);
      if (w > 0) pair_barrier(w);
    }
    // the row above the strip and the row below it (the outer warps' are
    // halo and take their own edge rows)
    const float4 a = *reinterpret_cast<const float4*>(&ed[w > 0 ? w - 1 : w][w > 0 ? 1 : 0][cx]);
    const float4 b = *reinterpret_cast<const float4*>(&ed[w + 1 < NW ? w + 1 : w][w + 1 < NW ? 0 : 1][cx]);
    sweep_strip(v, bits, a, b);
  }

  double d2 = 0.0, n2 = 0.0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int er = ry + r;
    const int gy = y0 + er;
    if (er < T || er >= T + TILE_Y || gy >= H) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int ec = cx + c;
      const int gx = x0 + ec;
      if (ec < T || ec >= T + TILE_X || gx >= W) continue;
      const size_t p = size_t(gy) * W + gx;
      dst[p] = v[r][c];
      if (partial != nullptr) {
        const double nw = double(v[r][c]), d = nw - double(orig[p]), wt = double(weight[p]);
        d2 += d * d * wt;
        n2 += nw * nw * wt;
      }
    }
  }
  if (partial == nullptr) return;
  // the block's sums in a fixed order: a butterfly in each warp, then the
  // warps in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    d2 += __shfl_xor_sync(0xffffffffu, d2, off);
    n2 += __shfl_xor_sync(0xffffffffu, n2, off);
  }
  if (lane == 0) {
    red[w][0] = d2;
    red[w][1] = n2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double sd = 0.0, sn = 0.0;
    for (int i = 0; i < NW; ++i) {
      sd += red[i][0];
      sn += red[i][1];
    }
    const size_t b = size_t(blockIdx.y) * gridDim.x + blockIdx.x;
    partial[2 * b] = sd;
    partial[2 * b + 1] = sn;
  }
}

constexpr int FIN_NT = 256;

// err = sqrt(sum d2 / max(sum n2, 1e-30)) from `nb` blocks' partials: each
// thread adds a fixed stride of them in order, then a fixed tree.
__global__ void __launch_bounds__(FIN_NT)
    jacobi_err_finalize(const double* __restrict__ partial, int nb, float* __restrict__ err) {
  __shared__ double sd[FIN_NT], sn[FIN_NT];
  double d = 0.0, n = 0.0;
  for (int i = int(threadIdx.x); i < nb; i += FIN_NT) {
    d += partial[2 * i];
    n += partial[2 * i + 1];
  }
  sd[threadIdx.x] = d;
  sn[threadIdx.x] = n;
  __syncthreads();
  for (int h = FIN_NT / 2; h > 0; h >>= 1) {
    if (int(threadIdx.x) < h) {
      sd[threadIdx.x] += sd[threadIdx.x + h];
      sn[threadIdx.x] += sn[threadIdx.x + h];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) err[0] = float(sqrt(sd[0] / fmax(sn[0], 1e-30)));
}

}  // namespace

// The compiled choice: out = (T sweeps per launch, TILE_X, TILE_Y, shared
// bytes per block, R rows per lane, NW warps per block, C columns per lane,
// threads per block).
extern "C" int jacobi_config(int* out) {
  out[0] = T;
  out[1] = TILE_X;
  out[2] = TILE_Y;
  out[3] = int(SMEM_BYTES + sizeof(double) * NW * 2);
  out[4] = R;
  out[5] = NW;
  out[6] = C;
  out[7] = NT;
  return 0;
}

// n sweeps of f (read only) on `stream`: ceil(n / T) launches ping-ponging
// buf0 and buf1 (buf1 is unused, and may be null, when there is one launch).
// The result is in buf0 when the number of launches is odd, in buf1 when it
// is even. With a non-null `weight` ([H, W] f32), the last launch writes
// `partial` ([2 * blocks] f64, blocks = ceil(W / TILE_X) * ceil(H / TILE_Y))
// and one more launch writes the relative change to err[0]. Returns 0 or the
// CUDA error of the first launch that failed.
extern "C" int jacobi_block_f32(const float* f, const uint8_t* upd, float* buf0, float* buf1, const float* weight,
                                double* partial, float* err, int H, int W, int n, cudaStream_t stream) {
  if (n <= 0 || H <= 0 || W <= 0) return 0;
  const dim3 grid((W + TILE_X - 1) / TILE_X, (H + TILE_Y - 1) / TILE_Y);
  const float* src = f;
  float* dst = buf0;
  for (int done = 0; done < n;) {
    const int k = (n - done < T) ? n - done : T;
    const bool last = done + k == n;
    jacobi_kernel<<<grid, NT, 0, stream>>>(src, upd, dst, H, W, k, f, weight,
                                           (last && weight != nullptr) ? partial : nullptr);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return int(e);
    done += k;
    src = dst;
    dst = (dst == buf0) ? buf1 : buf0;
  }
  if (weight == nullptr) return 0;
  jacobi_err_finalize<<<1, FIN_NT, 0, stream>>>(partial, int(grid.x * grid.y), err);
  return int(cudaGetLastError());
}
