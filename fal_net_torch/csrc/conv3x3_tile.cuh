// The block tile that both 3x3 convolution kernels (conv3x3_packed.cu, K3,
// and conv3x3_v2.cu, K4) share, fp32 on the CUDA cores.
//
// A block of 256 threads owns 64 output channels x 128 output columns of
// one output row.  Warp w owns the 8 output channels w*8 .. w*8+7 and a
// lane the 4 columns lane + 32k, an 8 x 4 register tile of sums, so the
// input reads of a warp are consecutive words (no bank conflicts) and its
// weight reads are two broadcast 16-byte loads per tap.  Weights are staged
// per chunk of input channels, transposed to ws[(ci, g, dx)][co] with g the
// row group (dy in K3, the ring slot in K4), rows padded to kWs floats.

#pragma once

namespace conv3x3 {

constexpr int kThreads = 256;
constexpr int kRC = 8;                 // output channels per thread (per warp)
constexpr int kRX = 4;                 // columns per thread: lane + 32 k
constexpr int kCoTile = 8 * kRC;       // 64 output channels per block
constexpr int kXTile = 32 * kRX;       // 128 output columns per block
constexpr int kHalo = kXTile + 2;      // staged input columns
constexpr int kWs = kCoTile + 4;       // weight row stride: 16-byte aligned, fewer store conflicts

using Tile = float[kRC][kRX];

__device__ __forceinline__ void zero_tile(Tile& acc) {
#pragma unroll
  for (int r = 0; r < kRC; ++r)
#pragma unroll
    for (int k = 0; k < kRX; ++k) acc[r][k] = 0.f;
}

// ws[(cl * 9 + t) * kWs + co] = w[co0 + co, t * Cin + c0 + cl] for the
// kCiTile input channels from c0, with w (Cout, 9 * Cin) row-major; 0 past
// Cin or Cout.  cl runs fastest, so the global reads are runs of kCiTile.
template <int kCiTile>
__device__ __forceinline__ void stage_weights(float* ws, const float* __restrict__ w, int Cin,
                                              int Cout, int c0, int co0) {
  const int K = 9 * Cin;
  for (int i = threadIdx.x; i < kCiTile * 9 * kCoTile; i += kThreads) {
    const int cl = i % kCiTile, t = (i / kCiTile) % 9, co = i / (kCiTile * 9);
    const int ci = c0 + cl, cg = co0 + co;
    ws[(cl * 9 + t) * kWs + co] = (ci < Cin && cg < Cout) ? __ldg(w + (size_t)cg * K + t * Cin + ci) : 0.f;
  }
}

// One row group of one input channel: acc[r][k] += sum over dx of
// wg[dx][warp * kRC + r] * xr[32 k + dx], where xr is the staged input row
// (kHalo columns) and wg the three weight rows of (ci, g).
__device__ __forceinline__ void fma_row(Tile& acc, const float* xr, const float* wg) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  xr += lane;
  float v[kRX][3];
#pragma unroll
  for (int k = 0; k < kRX; ++k)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) v[k][dx] = xr[32 * k + dx];
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    const float4* wr = reinterpret_cast<const float4*>(wg + dx * kWs + warp * kRC);
    const float4 a = wr[0], c = wr[1];
    const float wv[kRC] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
#pragma unroll
    for (int r = 0; r < kRC; ++r)
#pragma unroll
      for (int k = 0; k < kRX; ++k) acc[r][k] = fmaf(wv[r], v[k][dx], acc[r][k]);
  }
}

// Write the tile to out[b, co0 + warp * kRC + r, y, x0 + lane + 32 k] of an
// NCHW (B, Cout, H, W) output, inside its bounds.
__device__ __forceinline__ void store_tile(const Tile& acc, float* __restrict__ out, int b, int co0,
                                           int y, int x0, int Cout, int H, int W) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kRC; ++r) {
    const int co = co0 + warp * kRC + r;
    if (co >= Cout) break;
    float* orow = out + (((size_t)b * Cout + co) * H + y) * W;
#pragma unroll
    for (int k = 0; k < kRX; ++k) {
      const int xx = x0 + lane + 32 * k;
      if (xx < W) orow[xx] = acc[r][k];
    }
  }
}

// The sizes both C entries refuse: grid y and z hold at most 65535 blocks,
// and 9 * Cin must fit an int.
inline bool bad_sizes(int B, int Cin, int H, int W, int Cout, int grid_y) {
  const long long co_tiles = (Cout + (long long)kCoTile - 1) / kCoTile;
  return B < 1 || Cin < 1 || H < 1 || W < 1 || Cout < 1 || grid_y > 65535 || B * co_tiles > 65535 ||
         Cin > 0x7fffffff / 9;
}

}  // namespace conv3x3
