// L1: the composed logits conv of FAL-net's head in bf16, for Hopper
// (sm_90a):
//   out[b, co, y, x] = bias[co] + sum_{ci, dy, dx} k[co, ci, dy, dx] * in[b, ci, y + dy - pad_h, x + dx - 1]
// (0 outside), on bf16 `in` and `k`, every product and sum in fp32, out fp32.
// pad_h is 1, or 0 where the rows already carry their halo (a rank of a
// row-partitioned model); the columns are always padded by 1.
//
// Replaces fal_net_tpu/models/layers.py::_conv_accum as
// fal_net_tpu/models/backbone.py:329 calls it under fuse_logits: iconv1
// (3x3, 96 -> N) and the logits 1x1 (N -> N) composed in fp32 into one 3x3
// kernel, rounded to bf16 once, convolved over the bf16 concat with
// preferred_element_type=float32, plus the 1x1's fp32 bias.  On the TPU it
// is an XLA convolution, not a Pallas kernel; no PyTorch call takes bf16
// operands to an fp32 convolution.
//
// What bounds it: bytes.  At (8, 96, 384, 1280) -> 49 it reads 755 MB of
// bf16 and writes 771 MB of fp32: 0.455 ms at 3.35 TB/s, against 333 GFLOP,
// 0.337 ms at 989 TFLOP/s bf16.  The path it replaces wrote and read an fp32
// copy of the input (1.51 GB) before an fp32 convolution.  The design reads
// the bf16 input through shared memory once per tile (5 staged rows serve 3
// output rows), keeps the sums in registers and writes each fp32 output
// once, with the bias; nothing else touches device memory.
//
// The product, per block tile: M = output pixels (64 consecutive columns of
// one output row per warpgroup and accumulator), N = a tile of output
// channels (Cout cut into tiles of at most 64, rounded up to a multiple of
// 8: 56 for Cout = 49), K = 9*Cin in k16 steps, two steps per (tap, chunk
// of 32 input channels).  It is K3's tiling (conv3x3_wgmma.cu) with bf16
// operands:
//   * A (pixels x K) comes from registers: each thread gathers its m64k16
//     fragment from the staged NCHW rows with eight 16-bit shared loads,
//     two channels of one pixel packed per register, the dx shift and the
//     zero halo included; one fragment (input row r, dx) feeds the wgmmas of
//     every output row o with dy = r - o in [0, 3).  For 16-bit types wgmma
//     could read an M-major (pixel-major) A from shared memory through a
//     descriptor, but a descriptor's start moves in 16-byte steps and the dx
//     taps shift the pixels by one element: each tap would need its own
//     shifted copy, one more shared-memory pass per chunk.
//   * B is the composed kernel in shared memory, K-major: the op hands the
//     kernel k as (Cout, 9, Cin') (Cin' = Cin rounded up to 8, the rest
//     zero), and TMA loads per tap an (N, 32) tile whose 64-byte rows take
//     the 64-byte swizzle, named in the wgmma descriptor (wgmma.cuh); the
//     second k16 step starts 32 bytes into the rows.
//   * The staged input is (32 channels, 5 rows, 152 columns) from 8 columns
//     left of the tile (16 bytes: TMA faults on an innermost start that is
//     not a multiple of 16 bytes): one TMA 4-D box over (W, H, C, B), whose
//     zero fill outside the tensor is the padding, rows and columns, and the
//     channels past Cin.  152 columns make a channel 760 elements, so the
//     four channel pairs one 16-bit load of a warp touches fall in distinct
//     32-byte bank groups: the gather is free of bank conflicts.
//   * A ring of 2 stages (86 KB each) with full/empty mbarriers; one
//     producer warp starts the loads while two consumer warpgroups run
//     wgmma; blocks are persistent (one per SM, walking the tiles).
//   * TMA wants 16-byte row strides, W % 8 == 0 (KITTI's 1242 is not).
//     Where W is even the producer warp's lanes copy each staged row with
//     one 1-D bulk copy from the 16-byte boundary at or before its first
//     column, so the row lands shifted by sh = 0, 2, 4 or 6 columns; the
//     consumers add each (channel, row)'s sh, computed from its address, to
//     their reads (kShifted).  16-byte pieces across the image's edges go as
//     4-byte column pairs with cp.async's zero fill.  (Whole rows by
//     cp.async, in 4- or 16-byte pieces, took longer: one warp keeps too
//     few copies in flight.)  Where W is odd, the lanes copy with plain
//     loads and stores.  The weights come by TMA.
//   * Epilogue: bias plus sum, stored straight to NCHW fp32; for one
//     register, the 8 lanes of a quad row write 8 consecutive pixels.  The
//     Cout, H and W tails are masked.

#include "med_stage.cuh"  // mbarrier, TMA and cp.async helpers
#include "wgmma.cuh"      // wgmma, its descriptor, the tensor-map encoder

namespace {

constexpr int kRows = 3;                       // output rows per tile
constexpr int kInRows = kRows + 2;             // staged input rows
constexpr int kCols = 128;                     // output columns per tile: 2 warpgroups x 64
constexpr int kLead = 8;                       // columns staged left of the tile: 16 bytes, as TMA needs
constexpr int kBoxW = 152;                     // staged columns (>= kCols + kLead + 1, a multiple of 8)
constexpr int kCi = 32;                        // input channels per chunk: two k16 steps per tap
constexpr int kMaxN = 64;                      // output channels per tile, at most
constexpr int kStages = 2;                     // ring depth
constexpr int kConsumers = 256;                // two warpgroups
constexpr int kThreads = kConsumers + 32;      // and one producer warp
constexpr int kChan = kInRows * kBoxW;         // elements of one staged channel: 760
constexpr int kInElems = kCi * kChan;
constexpr int kInBytes = kInElems * 2;         // 48640
constexpr int kAlign = 1024;
constexpr int kMaxDevices = 64;                // the launch settings are kept per device

// How the producer stages the input: TMA, 16-byte cp.async of rows shifted
// to 16-byte boundaries, or plain 16-bit loads and stores.
enum Copy { kTma = 0, kChunks = 1, kSingles = 2 };
constexpr int kPieces = kBoxW / 8;             // 16-byte pieces of a staged row

template <int N> struct Stage {
  static constexpr int kInRegion = round_up(kInBytes, kAlign);
  static constexpr int kWBytes = 9 * N * kCi * 2;          // nine (N, 32) bf16 tiles of 64-byte rows
  static constexpr int kTapBytes = round_up(N * kCi * 2, kAlign);  // one tile's stride
  static constexpr int kBytes = kInRegion + 9 * kTapBytes;
  static constexpr int kSmem = kStages * kBytes + 2 * kStages * 8 + kAlign;  // + barriers, alignment slack
};

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

__device__ __forceinline__ uint32_t pack(unsigned short lo, unsigned short hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// Raise `bar`'s expected transaction bytes without an arrival.
__device__ __forceinline__ void mbar_add_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

// 16-byte cp.async (L2 only) that stores zeros when `in` is false (src-size 0).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(in ? 16 : 0) : "memory");
}

// kShifted (copy == kChunks): staged row (cl, r) starts sh columns early,
// sh = (xoff + element offset of its column x0 - kLead) mod 8, xoff = the
// element offset of x past a 16-byte boundary; the offset mod 8 is
// xoff + ((b Cin + ci) H + gy) (W mod 8), as x0 - kLead is a multiple of 8.
template <int N, bool kShifted>
__global__ void __launch_bounds__(kThreads, 1)
    logits_conv_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
                       const unsigned short* __restrict__ x, const float* __restrict__ bias, float* __restrict__ out,
                       int Cin, int H, int W, int Ho, int Cout, int pad_h, int copy, int xoff, Tiles tiles) {
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
      // lane 0's expect_tx, and without TMA one arrival per producer lane once its copies are in
      mbar_init(full + 8 * s, copy == kTma ? 1 : 33);
      mbar_init(empty + 8 * s, kConsumers / 32);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warp: fill the ring, (tile, chunk) after (tile, chunk) ----
    const int lane = threadIdx.x - kConsumers;
    if (copy == kTma && lane != 0) return;
    int it = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      int x0, y0, b, co0;
      tiles.at(t, x0, y0, b, co0, N);
      for (int c = 0; c < chunks; ++c, ++it) {
        const int s = it % kStages;
        mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
        const uint32_t in_s = base + s * S::kBytes, w_s = in_s + S::kInRegion, bar = full + 8 * s;
        const int c0 = c * kCi;
        if (lane == 0) {
          mbar_expect_tx(bar, S::kWBytes + (copy == kTma ? kInBytes : 0));
          if (copy == kTma) tma_load_4d(in_s, &x_map, bar, x0 - kLead, y0 - pad_h, c0, b);
          for (int tap = 0; tap < 9; ++tap) tma_load_3d(w_s + tap * S::kTapBytes, &w_map, bar, c0, tap, co0);
        }
        if (copy == kTma) continue;
        if (copy == kChunks) {
          // staged row (cl, r), column j = in[b, c0 + cl, y0 - pad_h + r, x0 - kLead + j - sh], 0 outside; a
          // lane a row: the row's 16-byte pieces inside the image in one bulk copy, those across its edges as
          // column pairs (W and sh even: a pair is all in or all out), the rest zeros
          for (int row = lane; row < kCi * kInRows; row += 32) {
            const int gy = y0 - pad_h + row % kInRows, ci = c0 + row / kInRows;
            const uint32_t dst = in_s + row * kBoxW * 2;
            if (gy < 0 || gy >= H || ci >= Cin) {
              for (int q = 0; q < kPieces; ++q) cp_async_16(dst + 16 * q, x, false);
              continue;
            }
            const long long e = (((long long)b * Cin + ci) * H + gy) * W + x0 - kLead;  // column j = 0, unshifted
            const int sh = (int)((xoff + e) & 7), gx0 = x0 - kLead - sh;  // piece q starts at column gx0 + 8 q
            const unsigned short* src = x + (e - sh);                    // 16-byte aligned
            const int q_lo = max(0, (7 - gx0) >> 3), q_hi = min(kPieces - 1, ((W - gx0) >> 3) - 1);
            if (q_lo <= q_hi) {
              const uint32_t bytes = 16 * (q_hi - q_lo + 1);
              mbar_add_tx(bar, bytes);
              bulk_load(dst + 16 * q_lo, src + 8 * q_lo, bytes, bar);
            }
            for (int q = 0; q < kPieces; ++q) {
              if (q >= q_lo && q <= q_hi) continue;
              const int gx = gx0 + 8 * q;
              if (gx + 8 <= 0 || gx >= W) {
                cp_async_16(dst + 16 * q, x, false);
                continue;
              }
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const bool in = gx + 2 * k >= 0 && gx + 2 * k < W;
                cp_async_4(dst + 16 * q + 4 * k, reinterpret_cast<const float*>(in ? src + 8 * q + 2 * k : x), in);
              }
            }
          }
          cp_async_arrive(bar);
        } else {
          // staged row (cl, r), column j = in[b, c0 + cl, y0 - pad_h + r, x0 - kLead + j], 0 outside
          for (int row = 0; row < kCi * kInRows; ++row) {
            const int gy = y0 - pad_h + row % kInRows, ci = c0 + row / kInRows;
            const bool row_in = gy >= 0 && gy < H && ci < Cin;
            const unsigned short* src = x + (((size_t)b * Cin + ci) * H + gy) * W;
            unsigned short* dst = reinterpret_cast<unsigned short*>(gbase + s * S::kBytes) + row * kBoxW;
#pragma unroll
            for (int q = 0; q < (kBoxW + 31) / 32; ++q) {
              const int j = lane + 32 * q, gx = x0 - kLead + j;
              if (j < kBoxW) dst[j] = row_in && gx >= 0 && gx < W ? src[gx] : (unsigned short)0;
            }
          }
          mbar_arrive(bar);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup g owns columns 64 g .. 64 g + 63 of the tile ----
  const int g = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int m = 16 * warp + gid;  // this thread's first pixel row of the m64 tile; the second is m + 8
  const uint32_t wmod = W & 7, hw = (uint32_t)H * wmod;  // kShifted: a channel's step in the offset mod 8
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
      const int s = it % kStages, c0 = c * kCi;
      mbar_wait(full + 8 * s, (it / kStages) & 1);
      const unsigned short* xs = reinterpret_cast<const unsigned short*>(gbase + s * S::kBytes);
      const uint32_t w_s = base + s * S::kBytes + S::kInRegion;
      // staged input: xs[(cl * kInRows + r) * kBoxW + j]; pixel x0 + 64 g + m at tap dx reads column
      // x0 + 64 g + m + dx - 1, staged at j = 64 g + m + dx - 1 + kLead (+ the row's sh if kShifted)
      const unsigned short* xa = xs + 2 * tig * kChan + 64 * g + m + kLead - 1;
      uint32_t frag[2][3][4];
#pragma unroll
      for (int r = 0; r < kInRows; ++r)
#pragma unroll
        for (int kb = 0; kb < 2; ++kb) {  // channels 16 kb .. 16 kb + 15 of the chunk
          uint32_t(&f)[3][4] = frag[kb];
          // the shifts of channels 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9 in this row (0 unless kShifted)
          int s0 = 0, s1 = 0, s2 = 0, s3 = 0;
          if constexpr (kShifted) {
            const uint32_t e = xoff + (((uint32_t)b * Cin + c0 + 16 * kb + 2 * tig) * H + y0 - pad_h + r) * wmod;
            s0 = e & 7, s1 = (e + hw) & 7, s2 = (e + 8 * hw) & 7, s3 = (e + 9 * hw) & 7;
          }
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            // A (64 pixels x 16 channels), channel pairs (2 tig, 2 tig + 1) and (2 tig + 8, 2 tig + 9):
            // a0 (m, low pair), a1 (m + 8, low pair), a2 (m, high pair), a3 (m + 8, high pair)
            const unsigned short* p = xa + (16 * kb * kInRows + r) * kBoxW + dx;
            f[dx][0] = pack(p[s0], p[kChan + s1]);
            f[dx][1] = pack(p[8 + s0], p[kChan + 8 + s1]);
            f[dx][2] = pack(p[8 * kChan + s2], p[9 * kChan + s3]);
            f[dx][3] = pack(p[8 * kChan + 8 + s2], p[9 * kChan + 8 + s3]);
          }
          wgmma_fence();
#pragma unroll
          for (int o = 0; o < kRows; ++o) {
            const int dy = r - o;
            if (dy < 0 || dy > 2) continue;
#pragma unroll
            for (int dx = 0; dx < 3; ++dx)
              Wgmma<N, Bf16>::run(acc[o], f[dx], desc_sw64(w_s + (dy * 3 + dx) * S::kTapBytes + kb * 32));
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
      if (y >= Ho) break;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const int xx = x0 + 64 * g + m + 8 * ((i >> 1) & 1);
        const int co = co0 + 8 * (i >> 2) + 2 * tig + (i & 1);
        if (xx < W && co < Cout) out[(((size_t)b * Cout + co) * Ho + y) * W + xx] = acc[o][i] + bias[co];
      }
    }
  }
}

// The shared-memory limit and the SM count are CUDA calls of microseconds
// each, made while the card waits for the launch: once per device (and, for
// the limit, per instance of the kernel), as conv3x3_wgmma.cu does.
template <int N, bool kShifted>
int launch(const CUtensorMap& xm, const CUtensorMap& wm, const unsigned short* x, const float* bias, float* out,
           int Cin, int H, int W, int Ho, int Cout, int pad_h, int copy, int xoff, Tiles tiles, int sms, int dev,
           cudaStream_t stream) {
  auto kernel = logits_conv_kernel<N, kShifted>;
  const int smem = Stage<N>::kSmem;
  static bool set[kMaxDevices];  // per device, for this instance
  if (!set[dev]) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    set[dev] = true;
  }
  const long long count = (long long)tiles.x_tiles * tiles.y_tiles * tiles.B * tiles.n_tiles;
  const int grid = (int)(count < sms ? count : sms);
  kernel<<<grid, kThreads, smem, stream>>>(xm, wm, x, bias, out, Cin, H, W, Ho, Cout, pad_h, copy, xoff, tiles);
  return (int)cudaGetLastError();
}

template <bool kShifted>
int dispatch(int N, const CUtensorMap& xm, const CUtensorMap& wm, const unsigned short* x, const float* bias,
             float* out, int Cin, int H, int W, int Ho, int Cout, int pad_h, int copy, int xoff, Tiles tiles, int sms,
             int dev, cudaStream_t st) {
#define L1_LAUNCH(n) \
  launch<n, kShifted>(xm, wm, x, bias, out, Cin, H, W, Ho, Cout, pad_h, copy, xoff, tiles, sms, dev, st)
  switch (N) {
    case 8: return L1_LAUNCH(8);
    case 16: return L1_LAUNCH(16);
    case 24: return L1_LAUNCH(24);
    case 32: return L1_LAUNCH(32);
    case 40: return L1_LAUNCH(40);
    case 48: return L1_LAUNCH(48);
    case 56: return L1_LAUNCH(56);
    default: return L1_LAUNCH(64);
  }
#undef L1_LAUNCH
}

}  // namespace

extern "C" {

// Launch L1 on `stream`: x (B, Cin, H, W) bf16, w (Cout, 9, w_cin) bf16
// (k[co, ci, dy, dx] at w[co, 3 dy + dx, ci], zero for ci >= Cin), bias
// (Cout) fp32 and out (B, Cout, H - 2 + 2 pad_h, W) fp32, contiguous
// device buffers.  Returns cudaErrorInvalidValue, launching nothing, for
// what it does not take (a size below 1, pad_h other than 0 or 1, w_cin
// below Cin or not a multiple of 8, w not 16-byte aligned, a tile count or
// a tensor past an int's reach); else the error of encoding the tensor maps
// or of the launch (0 on success).
int logits_conv(const void* x, const void* w, const float* bias, float* out, int B, int Cin, int H, int W,
                int Cout, int pad_h, int w_cin, void* stream) {
  const int Ho = H - 2 + 2 * pad_h;
  if (B < 1 || Cin < 1 || W < 1 || Cout < 1 || (pad_h != 0 && pad_h != 1) || Ho < 1 || w_cin < Cin ||
      w_cin % 8 || reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (Cout + kMaxN - 1) / kMaxN;
  const int N = round_up((Cout + n_tiles - 1) / n_tiles, 8);  // equal tiles, each a multiple of 8
  const Tiles tiles{(W + kCols - 1) / kCols, (Ho + kRows - 1) / kRows, B, n_tiles};
  if ((long long)tiles.x_tiles * tiles.y_tiles * B * n_tiles > 0x7fffffff ||
      (long long)B * Cin * H * W > 0x7fffffffffffll)
    return (int)cudaErrorInvalidValue;
  static int sms_of[kMaxDevices];  // per device: the SM count, read once
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!sms_of[dev]) {
    err = cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;

  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const int copy = W % 8 == 0 && xa % 16 == 0 ? kTma : W % 2 == 0 && xa % 4 == 0 ? kChunks : kSingles;
  const int xoff = (int)(xa / 2 % 8);
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUtensorMap xm = {}, wm = {};
  if (copy == kTma) {
    const cuuint64_t xdim[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)Cin, (cuuint64_t)B};
    const cuuint64_t xstride[3] = {(cuuint64_t)W * 2, (cuuint64_t)H * W * 2, (cuuint64_t)Cin * H * W * 2};
    const cuuint32_t xbox[4] = {kBoxW, kInRows, kCi, 1};
    if (encode(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), xdim, xstride, xbox, ones,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  // w (Cout, 9, w_cin) seen as (w_cin, 9, Cout), innermost first
  const cuuint64_t wdim[3] = {(cuuint64_t)w_cin, 9, (cuuint64_t)Cout};
  const cuuint64_t wstride[2] = {(cuuint64_t)w_cin * 2, (cuuint64_t)w_cin * 18};
  const cuuint32_t wbox[3] = {kCi, 1, (cuuint32_t)N};
  if (encode(&wm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), wdim, wstride, wbox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;

  const unsigned short* xs = static_cast<const unsigned short*>(x);
  const int sms = sms_of[dev];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return copy == kChunks ? dispatch<true>(N, xm, wm, xs, bias, out, Cin, H, W, Ho, Cout, pad_h, copy, xoff, tiles,
                                          sms, dev, st)
                         : dispatch<false>(N, xm, wm, xs, bias, out, Cin, H, W, Ho, Cout, pad_h, copy, xoff, tiles,
                                           sms, dev, st);
}

}  // extern "C"
