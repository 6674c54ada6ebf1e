// K-packed 3x3 convolution (K3) for Hopper (sm_90a), fp32 on the CUDA cores.
//
// Replaces scripts/proto_conv_kernel.py::_kernel.  It computes what that
// kernel computes, a 3x3 stride-1 zero-padded conv without bias on NCHW,
//   out[b, co, y, x] = sum_k w2[co, k] * patch[k, x],
//   patch[(dy, dx, ci), x] = in[b, ci, y + dy - 1, x + dx - 1]  (0 outside),
// with w2 (Cout, 9*Cin) in K order (dy, dx, ci).  Not how: the TPU kernel
// keeps the whole w2 and a 16-row x Wp input slab per (batch, 8-row tile)
// in VMEM and runs one (Cout, 9*Cin) x (9*Cin, W) matmul per row.  On
// Hopper w2 alone is 147 KB at 64->64 and three full input rows at 96
// channels x 1282 columns are 1.48 MB, against 227 KB of shared memory a
// block may use.  So:
//   * a block owns (output row y, 128 columns, 64 output channels, batch);
//     grid (ceil(W/128), H, B * ceil(Cout/64));
//   * K is walked in chunks of 16 input channels: per chunk the block
//     stages that chunk's weights, transposed to [(ci, dy, dx)][co], and the
//     three input rows it needs over the 130 columns of the tile's halo, in
//     shared memory (64 KB, above the 48 KB default: opted in);
//   * the zero padding is done in the staging: reads out of range store 0;
//   * each thread keeps an 8 x 4 register tile of sums (conv3x3_tile.cuh).
// What bounds it on the card: operations.  At (8, 64, 192, 640) -> 64 the
// conv is 72.5 GFLOP, 1.08 ms at the 67 TFLOP/s fp32 rate, against 0.15 ms
// for its 503 MB; this simple kernel does 32 FMAs per 6 shared-memory
// loads and makes no use of the tensor cores.

#include <cuda_runtime.h>

#include "conv3x3_tile.cuh"

namespace {

using namespace conv3x3;

constexpr int kCiTile = 16;  // input channels per K chunk
constexpr int kSmemFloats = kCiTile * 9 * kWs + kCiTile * 3 * kHalo;

__global__ void __launch_bounds__(kThreads)
    conv3x3_packed_kernel(const float* __restrict__ x, const float* __restrict__ w2,
                          float* __restrict__ out, int Cin, int H, int W, int Cout, int co_tiles) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [kCiTile * 9][kWs]
  float* xs = ws + kCiTile * 9 * kWs;           // [kCiTile][3][kHalo]
  const int x0 = blockIdx.x * kXTile;
  const int y = blockIdx.y;
  const int b = blockIdx.z / co_tiles;
  const int co0 = (blockIdx.z % co_tiles) * kCoTile;
  const float* xb = x + (size_t)b * Cin * H * W;

  Tile acc;
  zero_tile(acc);
  for (int c0 = 0; c0 < Cin; c0 += kCiTile) {
    stage_weights<kCiTile>(ws, w2, Cin, Cout, c0, co0);
    // input rows y-1, y, y+1 over columns [x0 - 1, x0 + kXTile + 1), zero outside
    for (int i = threadIdx.x; i < kCiTile * 3 * kHalo; i += kThreads) {
      const int j = i % kHalo, dy = (i / kHalo) % 3, cl = i / (3 * kHalo);
      const int ci = c0 + cl, yy = y + dy - 1, xx = x0 - 1 + j;
      xs[i] = (ci < Cin && yy >= 0 && yy < H && xx >= 0 && xx < W)
                  ? __ldg(xb + ((size_t)ci * H + yy) * W + xx)
                  : 0.f;
    }
    __syncthreads();
    const int nc = min(kCiTile, Cin - c0);
#pragma unroll 2
    for (int cl = 0; cl < nc; ++cl)
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) fma_row(acc, xs + (cl * 3 + dy) * kHalo, ws + (cl * 9 + dy * 3) * kWs);
    __syncthreads();
  }
  store_tile(acc, out, b, co0, y, x0, Cout, H, W);
}

}  // namespace

extern "C" {

// Launch K3 on `stream`: x (B, Cin, H, W), w2 (Cout, 9*Cin) and out
// (B, Cout, H, W), fp32 contiguous device buffers.  Returns
// cudaErrorInvalidValue, launching nothing, for sizes the grid cannot
// hold; else cudaGetLastError() after the launch (0 on success).
int conv3x3_packed(const float* x, const float* w2, float* out, int B, int Cin, int H, int W,
                   int Cout, void* stream) {
  if (bad_sizes(B, Cin, H, W, Cout, H)) return (int)cudaErrorInvalidValue;
  const int co_tiles = (Cout + kCoTile - 1) / kCoTile;
  const size_t smem = kSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(conv3x3_packed_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kXTile - 1) / kXTile, H, B * co_tiles);
  conv3x3_packed_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w2, out, Cin, H, W, Cout, co_tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
