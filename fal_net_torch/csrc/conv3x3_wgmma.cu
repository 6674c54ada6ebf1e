// 3x3 convolution on NCHW fp32 through the TF32 tensor cores (wgmma), for
// Hopper (sm_90a).  K3 and K4 both launch it.
//
// Replaces scripts/proto_conv_kernel.py::_kernel (K3) and
// scripts/proto_conv_kernel_v2.py::_kernel (K4), which compute the same
// function: a 3x3, stride-1, zero-padded conv without bias,
//   out[b, co, y, x] = sum_k w2[co, k] * patch[b, k, y, x],
//   patch[b, (dy, dx, ci), y, x] = in[b, ci, y + dy - 1, x + dx - 1]  (0 outside),
// with w2 (Cout, 9*Cin) row-major, K order (dy, dx, ci).  The TPU kernels
// call jnp.dot on fp32 at default precision, one bf16 pass on the TPU; here
// the operands go through the tensor cores as TF32 and the sums stay fp32.
//
// Rounding: the raw fp32 bits of x and w2 are fed to wgmma, which reads the
// top 19 bits of each (sign, exponent, 10 mantissa bits) and ignores the low
// 13: each operand is truncated toward zero to TF32.  ops/conv3x3.py::
// tf32_round emulates that bit for bit.
//
// What bounds it: at (8, 64, 192, 640) -> 64 the conv is 72.5 GFLOP, 0.147
// ms at 495 TFLOP/s TF32, and moves 503 MB, 0.150 ms at 3.35 TB/s: bytes, by
// a hair.  What held the fp32 ports back, and what this design does:
//   * K3 and K4 ran on the CUDA cores (bound 1.08 ms there) with 32 FMAs per
//     6 shared-memory loads.  Here one m64nNk8 wgmma does 64*N*8 MACs.
//   * K3 staged three input rows per output row; K4 pinned 153 KB of shared
//     memory at Cin = 64 (one block an SM, Cin <= 102).  Here a block owns a
//     band of kRows = 3 output rows x 128 columns and stages its kRows + 2
//     input rows once per chunk of 16 input channels, each staged row serving
//     up to three output rows; shared memory does not grow with Cin.
//
// The product, per block tile: M = output pixels (64 consecutive columns of
// one output row per warpgroup and accumulator), N = a tile of output
// channels (Cout cut into tiles of at most 64, rounded up to a multiple of
// 8: 32, 56, 64, 40 for Cout = 32, 49, 64, 70), K = 9*Cin in k8 steps, two
// steps per (tap, chunk of 16 channels).
//   * TF32 wgmma reads a shared-memory operand K-major only (the transpose
//     bits exist for 16-bit types alone), and an NCHW input row is pixel-
//     major.  So A (pixels x K) comes from registers: each thread gathers its
//     m64k8 fragment from the staged NCHW rows with four 32-bit shared loads,
//     the dx shift and the zero halo included.  The other way, staging a
//     transposed input tile, would cost one more shared-memory pass per
//     chunk.  One fragment (input row r, dx) feeds the wgmmas of every output
//     row o with dy = r - o in [0, 3): a warpgroup's three accumulators take
//     27 wgmmas per k8 step from 15 fragments.
//   * B is the weights in shared memory, w2's own K-major layout: per tap an
//     (N, 16) tile, loaded by TMA with the 64-byte swizzle whose rows are
//     exactly those 16 channels (64 bytes), named in the wgmma descriptor;
//     the second k8 step starts 32 bytes into the swizzled rows.  TMA reads
//     w2 in runs of one chunk, so wider chunks mean fewer, longer requests:
//     16 channels ran faster than 8 with the 32-byte swizzle (PERF.md).  A
//     128-byte swizzle would need 32-channel chunks and 161 KB stages, one
//     stage in a block's 227 KB.
//   * The staged input is (16 channels, kRows + 2 rows, 136 columns): one TMA
//     4-D box over (W, H, C, B).  TMA fills out-of-bounds elements with zeros,
//     at the halo's negative start coordinates and past Cin too: that is the
//     conv's padding.  The box starts 4 columns left of the tile, not 1: TMA
//     faults (illegal instruction) on an innermost start coordinate that is
//     not a multiple of 16 bytes, negative or not.  136 columns make a
//     channel 680 floats, 8 banks apart, so the fragment loads are free of
//     bank conflicts.
//   * A ring of kStages = 2 stages of 80 KB with full/empty mbarriers; one
//     producer warp issues the loads while two consumer warpgroups run
//     wgmma.  Blocks are persistent (one per SM, walking the tiles), so the
//     ring runs on from one tile into the next and a tile's epilogue overlaps
//     the next loads.
//   * TMA wants 16-byte-aligned strides: W % 4 == 0 for x and Cin % 4 == 0 for
//     w2's view (Cin, 9, Cout).  Other shapes (W = 37, Cin = 3, ...) take the
//     same kernel with kTma = false: the producer warp fills the same layouts,
//     swizzle included, with zero-filling cp.async (src-size 0 out of range).
//   * Epilogue: each accumulator fragment is stored straight to NCHW; for one
//     register, the 8 lanes of a quad row write 8 consecutive pixels, whole
//     32-byte sectors.  The Cout, H and W tails are masked.

#include "med_stage.cuh"  // mbarrier, TMA and cp.async helpers
#include "wgmma.cuh"      // wgmma, its descriptor, the tensor-map encoder

namespace {

constexpr int kRows = 3;                       // output rows per tile
constexpr int kInRows = kRows + 2;             // staged input rows
constexpr int kCols = 128;                     // output columns per tile: 2 warpgroups x 64
constexpr int kBoxW = 136;                     // staged input columns from x0 - kLead (>= kCols + 5, a multiple of 4)
constexpr int kLead = 4;                       // columns staged left of the tile: 16 bytes, as TMA needs
constexpr int kCi = 16;                        // input channels per chunk: two k8 steps per tap
constexpr int kMaxN = 64;                      // output channels per tile, at most
constexpr int kStages = 2;                     // ring depth
constexpr int kConsumers = 256;                // two warpgroups
constexpr int kThreads = kConsumers + 32;      // and one producer warp
constexpr int kInFloats = kCi * kInRows * kBoxW;
constexpr int kInBytes = kInFloats * 4;        // 43520
constexpr int kAlign = 1024;
constexpr int kMaxDevices = 64;                // the launch settings are kept per device

template <int N> struct Stage {
  static constexpr int kInRegion = round_up(kInBytes, kAlign);
  static constexpr int kWBytes = 9 * N * kCi * 4;          // nine (N, 16) tiles of 64-byte rows
  static constexpr int kTapBytes = round_up(N * kCi * 4, kAlign);  // one tile's stride
  static constexpr int kBytes = kInRegion + 9 * kTapBytes;
  static constexpr int kSmem = kStages * kBytes + 2 * kStages * 8 + kAlign;  // + barriers, alignment slack
};

// Byte offset of element (n, k) of a K-major (N, 16) fp32 tile under the
// 64-byte swizzle: address bits 4-5 (which 16-byte quarter of the row) are
// XORed with bits 7-8 ((n / 2) % 4), as TMA's CU_TENSOR_MAP_SWIZZLE_64B
// writes it.
__device__ __forceinline__ int sw64_offset(int n, int k) {
  return n * 64 + (((k >> 2) ^ ((n >> 1) & 3)) << 4) + (k & 3) * 4;
}

// The tile grid: x tiles fastest, then row bands, batch, output-channel tiles.
struct Tiles {
  int x_tiles, y_tiles, B, n_tiles;
  __device__ __forceinline__ int count() const { return x_tiles * y_tiles * B * n_tiles; }
  __device__ __forceinline__ void at(int t, int& x0, int& y0, int& b, int& co0, int N) const {
    x0 = (t % x_tiles) * kCols;
    t /= x_tiles;
    y0 = (t % y_tiles) * kRows;
    t /= y_tiles;
    b = t % B;
    co0 = (t / B) * N;
  }
};

template <int N, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
                         const float* __restrict__ x, const float* __restrict__ w2, float* __restrict__ out,
                         int Cin, int H, int W, int Cout, Tiles tiles) {
  using S = Stage<N>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAlign - 1) / kAlign * kAlign;
  unsigned char* const gbase = smem_raw + (base - raw);  // generic pointer to `base`
  const uint32_t full = base + kStages * S::kBytes;      // kStages mbarriers, then kStages more
  const uint32_t empty = full + kStages * 8;
  const int chunks = (Cin + kCi - 1) / kCi;
  const int n_tiles = tiles.count();

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, kTma ? 1 : 32);
      mbar_init(empty + 8 * s, kConsumers / 32);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warp: fill the ring, (tile, chunk) after (tile, chunk) ----
    const int lane = threadIdx.x - kConsumers;
    if (kTma && lane != 0) return;
    int it = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      int x0, y0, b, co0;
      tiles.at(t, x0, y0, b, co0, N);
      for (int c = 0; c < chunks; ++c, ++it) {
        const int s = it % kStages;
        mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
        const uint32_t in_s = base + s * S::kBytes, w_s = in_s + S::kInRegion;
        const int c0 = c * kCi;
        if constexpr (kTma) {
          mbar_expect_tx(full + 8 * s, kInBytes + S::kWBytes);
          tma_load_4d(in_s, &x_map, full + 8 * s, x0 - kLead, y0 - 1, c0, b);
          for (int tap = 0; tap < 9; ++tap) tma_load_3d(w_s + tap * S::kTapBytes, &w_map, full + 8 * s, c0, tap, co0);
        } else {
          const float* xb = x + (size_t)b * Cin * H * W;
          for (int i = lane; i < kInFloats; i += 32) {
            const int j = i % kBoxW, r = (i / kBoxW) % kInRows, cl = i / (kBoxW * kInRows);
            const int gx = x0 - kLead + j, gy = y0 - 1 + r, ci = c0 + cl;
            const bool in = gx >= 0 && gx < W && gy >= 0 && gy < H && ci < Cin;
            cp_async_4(in_s + 4 * i, in ? xb + ((size_t)ci * H + gy) * W + gx : x, in);
          }
          for (int i = lane; i < 9 * N * kCi; i += 32) {
            const int k = i % kCi, n = (i / kCi) % N, tap = i / (kCi * N);
            const int ci = c0 + k, co = co0 + n;
            const bool in = ci < Cin && co < Cout;
            cp_async_4(w_s + tap * S::kTapBytes + sw64_offset(n, k),
                       in ? w2 + (size_t)co * 9 * Cin + tap * Cin + ci : w2, in);
          }
          asm volatile("cp.async.wait_all;" ::: "memory");
          // the wgmma reads B through the async proxy
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          mbar_arrive(full + 8 * s);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup g owns columns 64 g .. 64 g + 63 of the tile ----
  const int g = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int m = 16 * warp + gid;  // this thread's first pixel row of the m64 tile; the second is m + 8
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    int x0, y0, b, co0;
    tiles.at(t, x0, y0, b, co0, N);
    float acc[kRows][N / 2];
#pragma unroll
    for (int o = 0; o < kRows; ++o)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[o][i] = 0.f;

    for (int c = 0; c < chunks; ++c, ++it) {
      const int s = it % kStages;
      mbar_wait(full + 8 * s, (it / kStages) & 1);
      const float* xs = reinterpret_cast<const float*>(gbase + s * S::kBytes);
      const uint32_t w_s = base + s * S::kBytes + S::kInRegion;
      // staged input: xs[(ci * kInRows + r) * kBoxW + j] = in[ci, y0 - 1 + r, x0 - kLead + j]; pixel
      // x0 + 64 g + m at tap dx reads column x0 + 64 g + m + dx - 1
      const float* xa = xs + tig * kInRows * kBoxW + 64 * g + m + kLead - 1;
      uint32_t frag[2][3][4];
#pragma unroll
      for (int r = 0; r < kInRows; ++r)
#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {  // channels 8 kb .. 8 kb + 7 of the chunk
        uint32_t(&f)[3][4] = frag[kb];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          // A (64 pixels x 8 channels): a0 (m, tig), a1 (m + 8, tig), a2 (m, tig + 4), a3 (m + 8, tig + 4)
          const float* p = xa + (8 * kb * kInRows + r) * kBoxW + dx;
          f[dx][0] = __float_as_uint(p[0]);
          f[dx][1] = __float_as_uint(p[8]);
          f[dx][2] = __float_as_uint(p[4 * kInRows * kBoxW]);
          f[dx][3] = __float_as_uint(p[4 * kInRows * kBoxW + 8]);
        }
        wgmma_fence();
#pragma unroll
        for (int o = 0; o < kRows; ++o) {
          const int dy = r - o;
          if (dy < 0 || dy > 2) continue;
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            Wgmma<N, Tf32>::run(acc[o], f[dx], desc_sw64(w_s + (dy * 3 + dx) * S::kTapBytes + kb * 32));
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous group is done: its fragments may be overwritten
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    // epilogue: acc[o][i] is (pixel m + 8 ((i >> 1) & 1), channel 8 (i >> 2) + 2 tig + (i & 1))
#pragma unroll
    for (int o = 0; o < kRows; ++o) {
      const int y = y0 + o;
      if (y >= H) break;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const int xx = x0 + 64 * g + m + 8 * ((i >> 1) & 1);
        const int co = co0 + 8 * (i >> 2) + 2 * tig + (i & 1);
        if (xx < W && co < Cout) out[(((size_t)b * Cout + co) * H + y) * W + xx] = acc[o][i];
      }
    }
  }
}

// The shared-memory limit and the SM count are driver calls of microseconds
// each, made while the card waits for the launch: once per device (and, for
// the limit, per instance of the kernel), as med_stage.cuh::launch_rows does.
template <int N, bool kTma>
int launch(const CUtensorMap& xm, const CUtensorMap& wm, const float* x, const float* w2, float* out, int Cin,
           int H, int W, int Cout, Tiles tiles, int sms, int dev, cudaStream_t stream) {
  auto kernel = conv3x3_wgmma_kernel<N, kTma>;
  const int smem = Stage<N>::kSmem;
  static bool set[kMaxDevices];  // per device, for this instance
  if (!set[dev]) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    set[dev] = true;
  }
  const long long count = (long long)tiles.x_tiles * tiles.y_tiles * tiles.B * tiles.n_tiles;
  const int grid = (int)(count < sms ? count : sms);
  kernel<<<grid, kThreads, smem, stream>>>(xm, wm, x, w2, out, Cin, H, W, Cout, tiles);
  return (int)cudaGetLastError();
}

template <bool kTma>
int dispatch(int N, const CUtensorMap& xm, const CUtensorMap& wm, const float* x, const float* w2, float* out,
             int Cin, int H, int W, int Cout, Tiles tiles, int sms, int dev, cudaStream_t st) {
  switch (N) {
    case 8: return launch<8, kTma>(xm, wm, x, w2, out, Cin, H, W, Cout, tiles, sms, dev, st);
    case 16: return launch<16, kTma>(xm, wm, x, w2, out, Cin, H, W, Cout, tiles, sms, dev, st);
    case 24: return launch<24, kTma>(xm, wm, x, w2, out, Cin, H, W, Cout, tiles, sms, dev, st);
    case 32: return launch<32, kTma>(xm, wm, x, w2, out, Cin, H, W, Cout, tiles, sms, dev, st);
    case 40: return launch<40, kTma>(xm, wm, x, w2, out, Cin, H, W, Cout, tiles, sms, dev, st);
    case 48: return launch<48, kTma>(xm, wm, x, w2, out, Cin, H, W, Cout, tiles, sms, dev, st);
    case 56: return launch<56, kTma>(xm, wm, x, w2, out, Cin, H, W, Cout, tiles, sms, dev, st);
    default: return launch<64, kTma>(xm, wm, x, w2, out, Cin, H, W, Cout, tiles, sms, dev, st);
  }
}

}  // namespace

extern "C" {

// Launch the conv on `stream`: x (B, Cin, H, W), w2 (Cout, 9*Cin) and out
// (B, Cout, H, W), fp32 contiguous device buffers.  Returns
// cudaErrorInvalidValue, launching nothing, for sizes it does not take (any
// size below 1, or a tile count or 9 * Cin past an int); else the error of
// encoding the tensor maps or of the launch (0 on success).
int conv3x3_wgmma(const float* x, const float* w2, float* out, int B, int Cin, int H, int W, int Cout,
                  void* stream) {
  if (B < 1 || Cin < 1 || H < 1 || W < 1 || Cout < 1 || Cin > 0x7fffffff / 9) return (int)cudaErrorInvalidValue;
  const int n_tiles = (Cout + kMaxN - 1) / kMaxN;
  const int N = round_up((Cout + n_tiles - 1) / n_tiles, 8);  // equal tiles, each a multiple of 8
  const Tiles tiles{(W + kCols - 1) / kCols, (H + kRows - 1) / kRows, B, n_tiles};
  if ((long long)tiles.x_tiles * tiles.y_tiles * B * n_tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  static int sms_of[kMaxDevices];  // per device: the SM count, read once
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!sms_of[dev]) {
    err = cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int sms = sms_of[dev];

  CUtensorMap xm = {}, wm = {};
  const bool tma = W % 4 == 0 && Cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w2) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!tma) return dispatch<false>(N, xm, wm, x, w2, out, Cin, H, W, Cout, tiles, sms, dev, st);

  EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t xdim[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)Cin, (cuuint64_t)B};
  const cuuint64_t xstride[3] = {(cuuint64_t)W * 4, (cuuint64_t)H * W * 4, (cuuint64_t)Cin * H * W * 4};
  const cuuint32_t xbox[4] = {kBoxW, kInRows, kCi, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  // w2 (Cout, 9*Cin) seen as (Cin, 9, Cout), innermost first
  const cuuint64_t wdim[3] = {(cuuint64_t)Cin, 9, (cuuint64_t)Cout};
  const cuuint64_t wstride[2] = {(cuuint64_t)Cin * 4, (cuuint64_t)Cin * 36};
  const cuuint32_t wbox[3] = {kCi, 1, (cuuint32_t)N};
  if (encode(&xm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(x), xdim, xstride, xbox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&wm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(w2), wdim, wstride, wbox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  return dispatch<true>(N, xm, wm, x, w2, out, Cin, H, W, Cout, tiles, sms, dev, st);
}

}  // extern "C"
