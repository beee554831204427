// The previous design of spateo_tpu_torch/csrc/bp_step.cu, kept as it was so that
// scripts/kernel_ab_probe.py can time it against the current one on the
// same card. Not built or loaded by the package.
//
// One fused sum-product BP iteration on a binary 4-neighbour grid MRF, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_step_kernel` in spateo_tpu/ops/bp_pallas.py (run
// through `bp_step_pallas`) and computes what it computes. Per pixel s, with
// phi the normalised node potentials and m0[d] the state-0 message delivered
// to s from direction d (state 1 is 1 - m0):
//   prod0 = phi0 * m0[0] m0[1] m0[2] m0[3],  prod1 = phi1 * (1-m0[0]) ... (1-m0[3])
// and for each direction d, with r the reverse direction:
//   e0 = prod0 / max(m0[r], 1e-30),  e1 = prod1 / max(1 - m0[r], 1e-30)
//   o0 = e0 p + e1 q,  o1 = e0 q + e1 p,  o[d] = o0 / max(o0 + o1, 1e-30).
// The outgoing planes are then delivered one pixel along their direction:
//   out[0][y,x] = o[0](y+1,x)   (0.5 where y = H-1)
//   out[1][y,x] = o[1](y-1,x)   (0.5 where y = 0)
//   out[2][y,x] = o[2](y,x+1)   (0.5 where x = W-1)
//   out[3][y,x] = o[3](y,x-1)   (0.5 where x = 0)
// Layout: phi [2, H, W] f32, M and out [4, H, W] in the message type (f32 or
// bf16), all contiguous; arithmetic is f32 throughout.
//
// What bounds it: bytes. Each iteration reads 2 f32 planes of phi and 4
// message planes and writes 4 message planes; at 2048^2 with bf16 messages
// that is about 100 MB, some 30 us at the H100's 3.35 TB/s, against about
// 40 flops per pixel.
//
// Design: one thread per output pixel in 32x8 blocks. A block first stages
// its tile plus a one-pixel halo in shared memory (phi and messages read once
// from device memory, coalesced along x), reduced at once to prod0, prod1 and
// the four m0 values per pixel; each thread then forms its four delivered
// messages from its four neighbours' staged values. Every (pixel, direction)
// message is computed exactly once. Input and output are separate buffers
// (the caller ping-pongs them), so there is no in-place hazard across blocks.
// Any H and W: the ragged edge is masked, nothing is padded.
//
// Numerics: p*e0 + q*e1 is written with __fmul_rn/__fadd_rn so that nvcc does
// not contract it into an FMA, and the file must not be built with
// -use_fast_math (approximate division and flush-to-zero would break the
// max(m, 1e-30) guard); the result then matches the plain PyTorch version,
// `bp_step_reference`, operation for operation. bf16 stores round to nearest
// even (__float2bfloat16_rn), as PyTorch's cast does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;
constexpr int TX = BX + 2;  // tile width with the halo
constexpr int TY = BY + 2;  // tile height with the halo
constexpr float EPS = 1e-30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) { *dst = __float2bfloat16_rn(v); }

struct Tile {
  float prod0[TY][TX];
  float prod1[TY][TX];
  float m0[4][TY][TX];
};

// The state-0 message the staged pixel (ty, tx) sends in the direction whose
// reverse is r, normalised against its state-1 twin.
__device__ __forceinline__ float outgoing(const Tile& t, int ty, int tx, int r, float p, float q) {
  const float mr = t.m0[r][ty][tx];
  const float e0 = t.prod0[ty][tx] / fmaxf(mr, EPS);
  const float e1 = t.prod1[ty][tx] / fmaxf(1.0f - mr, EPS);
  const float o0 = __fadd_rn(__fmul_rn(e0, p), __fmul_rn(e1, q));
  const float o1 = __fadd_rn(__fmul_rn(e0, q), __fmul_rn(e1, p));
  return o0 / fmaxf(o0 + o1, EPS);
}

template <typename T>
__global__ void __launch_bounds__(BX* BY)
    bp_step_kernel(const float* __restrict__ phi, const T* __restrict__ M, T* __restrict__ out, int H, int W,
                   float p, float q) {
  __shared__ Tile tile;
  const size_t plane = static_cast<size_t>(H) * W;
  const int x0 = blockIdx.x * BX;
  const int y0 = blockIdx.y * BY;

  // stage the tile and its halo; pixels outside the image only feed outputs
  // that are overwritten with 0.5 below, so their staged values are unused
  for (int i = threadIdx.y * BX + threadIdx.x; i < TY * TX; i += BX * BY) {
    const int hy = i / TX;
    const int hx = i - hy * TX;
    const int gy = y0 - 1 + hy;
    const int gx = x0 - 1 + hx;
    float m[4] = {0.5f, 0.5f, 0.5f, 0.5f};
    float prod0 = 0.0f, prod1 = 0.0f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const size_t o = static_cast<size_t>(gy) * W + gx;
#pragma unroll
      for (int d = 0; d < 4; ++d) m[d] = to_f32(M[d * plane + o]);
      prod0 = phi[o] * (m[0] * m[1] * m[2] * m[3]);
      prod1 = phi[plane + o] * ((1.0f - m[0]) * (1.0f - m[1]) * (1.0f - m[2]) * (1.0f - m[3]));
    }
    tile.prod0[hy][hx] = prod0;
    tile.prod1[hy][hx] = prod1;
#pragma unroll
    for (int d = 0; d < 4; ++d) tile.m0[d][hy][hx] = m[d];
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const int ty = threadIdx.y + 1;  // this pixel's place in the staged tile
  const int tx = threadIdx.x + 1;
  const size_t o = static_cast<size_t>(y) * W + x;
  // direction d's reverse is r = (1, 0, 3, 2)[d]
  store(out + 0 * plane + o, y == H - 1 ? 0.5f : outgoing(tile, ty + 1, tx, 1, p, q));
  store(out + 1 * plane + o, y == 0 ? 0.5f : outgoing(tile, ty - 1, tx, 0, p, q));
  store(out + 2 * plane + o, x == W - 1 ? 0.5f : outgoing(tile, ty, tx + 1, 3, p, q));
  store(out + 3 * plane + o, x == 0 ? 0.5f : outgoing(tile, ty, tx - 1, 2, p, q));
}

template <typename T>
int launch(const void* phi, const void* M, void* out, int H, int W, float p, float q, void* stream) {
  const dim3 block(BX, BY);
  const dim3 grid((W + BX - 1) / BX, (H + BY - 1) / BY);
  bp_step_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(phi), static_cast<const T*>(M), static_cast<T*>(out), H, W, p, q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Each returns cudaGetLastError() after the
// launch (0 on success); the launch is asynchronous on `stream`.
extern "C" int bp_step_f32(const void* phi, const void* M, void* out, int H, int W, float p, float q,
                           void* stream) {
  return launch<float>(phi, M, out, H, W, p, q, stream);
}

extern "C" int bp_step_bf16(const void* phi, const void* M, void* out, int H, int W, float p, float q,
                            void* stream) {
  return launch<__nv_bfloat16>(phi, M, out, H, W, p, q, stream);
}
