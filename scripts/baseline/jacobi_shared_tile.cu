// The previous design of spateo_tpu_torch/csrc/jacobi.cu, kept as it was so that
// scripts/kernel_ab_probe.py can time it against the current one on the
// same card. Not built or loaded by the package.
//
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
// What bounds it: shared-memory traffic. A sweep needs 4 neighbour loads and
// one store per updated pixel and about 5 flops; the field is 4 MB at 1024^2
// and stays in the 50 MB L2, so device memory is not the limit.
//
// Design: temporal blocking. A 32x8-thread block owns a TILE_X x TILE_Y tile
// of the output; it loads the tile plus a halo of T pixels on each side into
// shared memory (twice, as the two buffers of a ping-pong), keeps its pixels'
// upd bits in a register, runs k <= T sweeps there, and writes the tile's
// interior to a second buffer in device memory. After sweep s only the
// pixels at least s from the extended tile's edge are right; after k <= T
// sweeps that still covers the tile. Each thread owns a fixed set of pixels
// (rows 1 + ty + 8i, columns 1 + tx + 32j of the extended tile) and sweeps
// all of them every time, so the halo's stale values are computed and never
// read by a pixel that is kept. `jacobi_block_f32` ping-pongs two device
// buffers and launches ceil(n / T) times, the last launch running the
// remaining n - T*(launches-1) sweeps. Pixels outside the raster (ragged
// edges) load as 0 and are frozen; a pixel the kernel updates is never on the
// raster's outer ring, so it never reads one of them. Any H and W.
//
// Compile-time choice (override with -D): T = 8 sweeps per launch, tiles of
// 64 x 64, so the extended tile is 80 x 80 and the halo recompute costs
// (80/64)^2 = 1.56x; 51,200 bytes of dynamic shared memory per block.
//
// Numerics: __fadd_rn/__fmul_rn keep nvcc from contracting or reordering, so
// the result is bit-identical to the plain PyTorch version,
// `jacobi_block_reference`. Do not build with -use_fast_math.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#ifndef JACOBI_T
#define JACOBI_T 8
#endif
#ifndef JACOBI_TILE_X
#define JACOBI_TILE_X 64
#endif
#ifndef JACOBI_TILE_Y
#define JACOBI_TILE_Y 64
#endif

namespace {

constexpr int T = JACOBI_T;
constexpr int TILE_X = JACOBI_TILE_X;
constexpr int TILE_Y = JACOBI_TILE_Y;
constexpr int BX = 32;
constexpr int BY = 8;
constexpr int EX = TILE_X + 2 * T;  // extended tile width
constexpr int EY = TILE_Y + 2 * T;  // extended tile height
constexpr int NJ = (EX - 2 + BX - 1) / BX;  // columns a thread owns
constexpr int NI = (EY - 2 + BY - 1) / BY;  // rows a thread owns
constexpr size_t SMEM_BYTES = 2 * size_t(EX) * EY * sizeof(float);

static_assert(T >= 1, "T must be at least 1");
static_assert(NI * NJ <= 64, "a thread's upd bits must fit one 64-bit register");
static_assert(SMEM_BYTES <= 227 * 1024, "the two extended tiles must fit in shared memory");

__global__ void __launch_bounds__(BX* BY)
    jacobi_kernel(const float* __restrict__ src, const uint8_t* __restrict__ upd, float* __restrict__ dst, int H,
                  int W, int k) {
  extern __shared__ float smem[];
  float* cur = smem;
  float* nxt = smem + EX * EY;
  const int x0 = int(blockIdx.x) * TILE_X - T;
  const int y0 = int(blockIdx.y) * TILE_Y - T;
  const int tid = int(threadIdx.y) * BX + int(threadIdx.x);

  for (int i = tid; i < EX * EY; i += BX * BY) {
    const int gy = y0 + i / EX;
    const int gx = x0 + i % EX;
    const float v = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? src[size_t(gy) * W + gx] : 0.0f;
    cur[i] = v;
    nxt[i] = v;
  }

  // bit (i * NJ + j): the pixel at row 1 + ty + BY*i, column 1 + tx + BX*j
  // of the extended tile moves
  uint64_t bits = 0;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int r = 1 + int(threadIdx.y) + BY * i;
      const int c = 1 + int(threadIdx.x) + BX * j;
      const int gy = y0 + r;
      const int gx = x0 + c;
      if (r < EY - 1 && c < EX - 1 && gy >= 1 && gy < H - 1 && gx >= 1 && gx < W - 1 &&
          upd[size_t(gy) * W + gx] != 0) {
        bits |= uint64_t(1) << (i * NJ + j);
      }
    }
  }
  __syncthreads();

  for (int s = 0; s < k; ++s) {
#pragma unroll
    for (int i = 0; i < NI; ++i) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if ((bits >> (i * NJ + j)) & 1) {
          const int p = (1 + int(threadIdx.y) + BY * i) * EX + 1 + int(threadIdx.x) + BX * j;
          // frozen pixels hold the same value in both buffers, so only a
          // moving pixel is stored
          nxt[p] = __fmul_rn(0.25f, __fadd_rn(__fadd_rn(__fadd_rn(cur[p + EX], cur[p - EX]), cur[p + 1]), cur[p - 1]));
        }
      }
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  for (int i = tid; i < TILE_X * TILE_Y; i += BX * BY) {
    const int r = i / TILE_X;
    const int c = i % TILE_X;
    const int gy = int(blockIdx.y) * TILE_Y + r;
    const int gx = int(blockIdx.x) * TILE_X + c;
    if (gy < H && gx < W) dst[size_t(gy) * W + gx] = cur[(r + T) * EX + c + T];
  }
}

}  // namespace

// The compiled choice: out[0] = T (sweeps per launch), out[1] = TILE_X,
// out[2] = TILE_Y, out[3] = shared-memory bytes per block.
extern "C" int jacobi_config(int* out) {
  out[0] = T;
  out[1] = TILE_X;
  out[2] = TILE_Y;
  out[3] = int(SMEM_BYTES);
  return 0;
}

// n sweeps of f (read only) on `stream`: ceil(n / T) launches ping-ponging
// buf0 and buf1 (buf1 is unused, and may be null, when there is one launch).
// The result is in buf0 when the number of launches is odd, in buf1 when it
// is even. Returns 0 or the CUDA error of the first launch that failed.
extern "C" int jacobi_block_f32(const float* f, const uint8_t* upd, float* buf0, float* buf1, int H, int W, int n,
                                cudaStream_t stream) {
  if (n <= 0 || H <= 0 || W <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(jacobi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((W + TILE_X - 1) / TILE_X, (H + TILE_Y - 1) / TILE_Y);
  const dim3 block(BX, BY);
  const float* src = f;
  float* dst = buf0;
  for (int done = 0; done < n;) {
    const int k = (n - done < T) ? n - done : T;
    jacobi_kernel<<<grid, block, SMEM_BYTES, stream>>>(src, upd, dst, H, W, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    done += k;
    src = dst;
    dst = (dst == buf0) ? buf1 : buf0;
  }
  return 0;
}
