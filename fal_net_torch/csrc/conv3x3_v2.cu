// K-packed 3x3 convolution with a ring of input rows (K4) for Hopper
// (sm_90a), fp32 on the CUDA cores.
//
// Replaces scripts/proto_conv_kernel_v2.py::_kernel.  The same conv as K3
// (conv3x3_packed.cu), from the phase-permuted weights w3 (3, Cout, 9*Cin):
// K row-group slot s (K index s*3*Cin + dx*Cin + ci) holds padded input row
// g with g mod 3 == s, and output row r uses variant p = r mod 3, which maps
// slot s to dy = (s - p) mod 3.  It keeps that kernel's design as the
// Hopper analogue of what it does on the TPU:
//   * a block owns (batch, 128 columns, 64 output channels, a band of 16
//     output rows) and walks down the band; grid
//     (ceil(W/128), ceil(H/16), B * ceil(Cout/64));
//   * three input-row slots in shared memory (all Cin channels over the
//     130 columns of the tile's halo) form a ring, so each output row loads
//     one new input row instead of three;
//   * the next input row is prefetched with cp.async into a fourth buffer
//     while the current row computes (the TPU kernel's 2-slot DMA at
//     proto_conv_kernel_v2.py:46-63); when the row is done that buffer
//     becomes the freed slot and the freed slot the next prefetch target,
//     by swapping pointers, so no row is copied twice;
//   * zero padding is done while staging: halo reads out of range store 0;
//   * the weights of variant p are staged per chunk of 8 input channels,
//     transposed to [(ci, s, dx)][co]; each thread keeps an 8 x 4 register
//     tile of sums, as in K3 (conv3x3_tile.cuh).
// Shared memory: 4 * Cin * 130 + 8 * 9 * 68 floats (153 KB at Cin = 64;
// Cin <= 102 fits in a block's 227 KB, and the C entry refuses more).
// What bounds it on the card: operations, as K3 (1.08 ms for 72.5 GFLOP at
// (8, 64, 192, 640) -> 64 at 67 TFLOP/s fp32, against 0.15 ms for the
// bytes).  The ring saves input reads from L2, not arithmetic.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "conv3x3_tile.cuh"

namespace {

using namespace conv3x3;

constexpr int kCiTile = 8;  // input channels per weight chunk
constexpr int kBand = 16;   // output rows one block walks down
constexpr int kWsFloats = kCiTile * 9 * kWs;
constexpr size_t kMaxSmemBytes = 232448;  // dynamic shared memory one Hopper block may use

// Start copying padded input row g (input row g - 1) of all Cin channels
// over the tile's halo columns into buf, as 4-byte cp.async; out-of-range
// elements are stored as 0 directly.  Completion: __pipeline_wait_prior
// in this thread, then a __syncthreads() for the others.
__device__ __forceinline__ void load_row(float* buf, const float* __restrict__ xb, int g, int x0,
                                         int Cin, int H, int W) {
  const int yy = g - 1;
  const bool row_in = yy >= 0 && yy < H;
  for (int i = threadIdx.x; i < Cin * kHalo; i += kThreads) {
    const int j = i % kHalo, ci = i / kHalo;
    const int xx = x0 - 1 + j;
    if (row_in && xx >= 0 && xx < W)
      __pipeline_memcpy_async(buf + i, xb + ((size_t)ci * H + yy) * W + xx, sizeof(float));
    else
      buf[i] = 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
    conv3x3_v2_kernel(const float* __restrict__ x, const float* __restrict__ w3,
                      float* __restrict__ out, int Cin, int H, int W, int Cout, int co_tiles) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [kCiTile * 9][kWs]
  float* rows = ws + kWsFloats;                 // 4 buffers of [Cin][kHalo]
  const int x0 = blockIdx.x * kXTile;
  const int r0 = blockIdx.y * kBand;
  const int r1 = min(r0 + kBand, H);
  const int b = blockIdx.z / co_tiles;
  const int co0 = (blockIdx.z % co_tiles) * kCoTile;
  const float* xb = x + (size_t)b * Cin * H * W;

  // slot[s] holds padded row g with g % 3 == s; stage receives the next row
  float* slot[3];
  float* stage = rows + 3 * Cin * kHalo;
#pragma unroll
  for (int s = 0; s < 3; ++s) slot[s] = rows + s * Cin * kHalo;
  // output row r0 reads padded rows r0, r0 + 1, r0 + 2
#pragma unroll
  for (int s = 0; s < 3; ++s) load_row(slot[s], xb, r0 + (s - r0 % 3 + 3) % 3, x0, Cin, H, W);
  __pipeline_commit();
  if (r0 + 1 < r1) load_row(stage, xb, r0 + 3, x0, Cin, H, W);
  __pipeline_commit();
  __pipeline_wait_prior(1);  // the three slots, not yet the prefetch
  __syncthreads();

  for (int r = r0; r < r1; ++r) {
    const int p = r % 3;
    const float* wp = w3 + (size_t)p * Cout * 9 * Cin;
    Tile acc;
    zero_tile(acc);
    for (int c0 = 0; c0 < Cin; c0 += kCiTile) {
      // ws[(cl * 9 + s * 3 + dx) * kWs + co] = w3[p, co0 + co, s*3*Cin + dx*Cin + c0 + cl]
      stage_weights<kCiTile>(ws, wp, Cin, Cout, c0, co0);
      __syncthreads();
      const int nc = min(kCiTile, Cin - c0);
#pragma unroll 2
      for (int cl = 0; cl < nc; ++cl)
#pragma unroll
        for (int s = 0; s < 3; ++s) fma_row(acc, slot[s] + (c0 + cl) * kHalo, ws + (cl * 9 + s * 3) * kWs);
      __syncthreads();  // ws is restaged; after the last chunk, slot[p] is free
    }
    store_tile(acc, out, b, co0, r, x0, Cout, H, W);

    if (r + 1 < r1) {
      // padded row r + 3 has landed in stage; it takes slot (r + 3) % 3 == p
      __pipeline_wait_prior(0);
      // unrolled selects keep slot[] in registers (a runtime index would not)
      float* freed = stage;
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        if (s == p) {
          freed = slot[s];
          slot[s] = stage;
        }
      }
      stage = freed;
      __syncthreads();
      // output row r + 2 needs padded row r + 4
      if (r + 2 < r1) load_row(stage, xb, r + 4, x0, Cin, H, W);
      __pipeline_commit();
    }
  }
}

}  // namespace

extern "C" {

// Launch K4 on `stream`: x (B, Cin, H, W), w3 (3, Cout, 9*Cin) and out
// (B, Cout, H, W), fp32 contiguous device buffers.  Returns
// cudaErrorInvalidValue, launching nothing, for sizes the grid or a block's
// shared memory cannot hold (Cin > 102); else cudaGetLastError() after the
// launch (0 on success).
int conv3x3_v2(const float* x, const float* w3, float* out, int B, int Cin, int H, int W, int Cout,
               void* stream) {
  const int bands = (H + kBand - 1) / kBand;
  const size_t smem = (kWsFloats + (size_t)4 * Cin * kHalo) * sizeof(float);
  if (bad_sizes(B, Cin, H, W, Cout, bands) || smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  const int co_tiles = (Cout + kCoTile - 1) / kCoTile;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_v2_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kXTile - 1) / kXTile, bands, B * co_tiles);
  conv3x3_v2_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w3, out, Cin, H, W, Cout, co_tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"

