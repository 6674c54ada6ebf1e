// L1: the composed logits conv of FAL-net's head in bf16, for Hopper
// (sm_90a):
//   out[b, co, y, x] = bias[co] + sum_{ci, dy, dx} k[co, ci, dy, dx] * in[b, ci, y + dy - pad_h, x + dx - 1]
// (0 outside), on bf16 `in` and `k`, every product and sum in fp32, out fp32
// NCHW.  pad_h is 1, or 0 where the rows already carry their halo (a rank of
// a row-partitioned model); the columns are always padded by 1.  `in` is
// NCHW with rows on a 16-byte pitch: its row, channel and batch strides
// multiples of 8 elements (ops/logits_conv.py::pitched_cat builds the
// concat so).
//
// Replaces fal_net_tpu/models/layers.py::_conv_accum as
// fal_net_tpu/models/backbone.py:329 calls it under fuse_logits: iconv1
// (3x3, 96 -> N) and the logits 1x1 (N -> N) composed in fp32 into one 3x3
// kernel, rounded to bf16 once, convolved over the bf16 concat with
// preferred_element_type=float32, plus the 1x1's fp32 bias.  On the TPU it
// is an XLA convolution, not a Pallas kernel; no PyTorch call takes bf16
// operands to an fp32 convolution.
//
// What bounds it, at (8, 96, 384, 1280) -> 49:
//   * bytes: 755 MB of bf16 read, 771 MB of fp32 written: 0.4555 ms at
//     3.35 TB/s.  The design reads each input byte from device memory once
//     and writes each output once; nothing else;
//   * the tensor cores: with N padded to 56, 388 GFLOP of m64n56k16 wgmma,
//     0.385 ms at 989.4 TFLOP/s bf16.  wgmmas this narrow do not reach that
//     rate: a variant that issues only this kernel's wgmmas, with nothing
//     staged or stored, takes most of the kernel's time (PERF.md);
//   * shared memory, 128 bytes a clock an SM: each wgmma reads its B (N x 32
//     bytes); A's fragments, the staging and the relayout add to it.
// The dx taps shape the design: they move the pixels of an NCHW row by one
// 2-byte element, and a wgmma descriptor, ldmatrix and TMA's innermost
// start all move in 16-byte steps.  A channels-last input would give each
// pixel its own 16 bytes, but PyTorch's channels-last concat costs more
// than the whole kernel saves (PERF.md), so the relayout happens here:
//   * One staging path.  Per chunk of 16 input channels, one TMA box of
//     (kBoxW columns from 8 left of the tile, 5 rows, 16 channels) over the
//     NCHW tensor with its row pitch; coordinates outside the tensor read
//     zeros: the padding, rows and columns, and the channels past Cin.
//     Every W, odd W included, takes it.  A tile is 3 output rows x 128
//     columns, 64 a warpgroup, so the staged box is 1.2x the tile's
//     columns (L2 to shared memory limits the staging: 64-column tiles,
//     1.75x, took longer).
//   * Relayout.  Both warpgroups turn the staged box into [c8][row][col][8
//     channels], 16 bytes a pixel: ldmatrix.trans of an 8-channel x
//     8-column matrix gives each lane two channels of one pixel, which it
//     stores as one word of that pixel's 16 bytes.  Each warp moves fixed
//     column groups of every row, so every address is a per-lane base plus a
//     constant (computing them per matrix cost more issue slots than the
//     wgmmas).  kBoxW = 152 makes a staged channel 1,520 bytes, so the eight
//     channel rows of a matrix fall in distinct banks; a matrix's stores are
//     128 contiguous bytes.  A dx tap is then +16 bytes, a dy tap one relaid
//     row.  Chunk i + 1 is relaid after chunk i's wgmmas are issued, while
//     they run; the relaid buffer is double-buffered, and one block barrier
//     a chunk orders its stores before its loads and frees the stage, which
//     thread 0 then refills (no producer warp: 256 threads leave each
//     thread 255 registers).
//   * A by ldmatrix.  Each m64k16 fragment (64 pixels x 16 channels at one
//     (row, dx)) is one ldmatrix.x4 a warp from the relaid buffer; one
//     fragment feeds the wgmmas of every output row it touches (dy = r - o
//     in [0, 3)): input rows 0-2 in one group of 18 wgmmas, rows 3-4 in one
//     of 9, each group's fragments in their own registers, so a group is
//     loaded while the other runs.  A read by the wgmma itself through a
//     descriptor (the relaid layout is wgmma's K-major core-matrix layout)
//     measured slower at every main-path shape (PERF.md).
//   * Resident weights.  The composed kernel, K-major (N, 32-channel) tiles
//     with the 64-byte swizzle (wgmma.cuh), one per (32 channels, tap), is
//     loaded by TMA once per block: 9 x Cin' x N x 2 bytes, 96.8 KB for
//     FAL_netB (Cin = 96, N = 56).  The rest of the 227 KB holds the ring
//     (3 stages at N = 56) and the relaid buffers.  Blocks are persistent,
//     one per SM.  Past 64 output channels (--no_levels up to K1's 128)
//     the channels split into equal tiles of at most 64, one per blockIdx.y,
//     and a block keeps only its own tile's weights: 110.6 KB at Cin = 96.
//   * Epilogue: the sums start from the bias and go straight to NCHW fp32;
//     for one register, the 8 lanes of a quad row write 8 consecutive
//     pixels (32 bytes).  The Cout, H and W tails are masked.  Both
//     warpgroups store at once, while no wgmma is queued: the kernel's
//     largest serial part (keeping a second set of sums to store them
//     during the next tile spilled registers and measured slower).

#include "med_stage.cuh"  // mbarrier and TMA helpers
#include "wgmma.cuh"      // wgmma, its descriptor, the tensor-map encoder

namespace {

constexpr int kRows = 3;                   // output rows per tile
constexpr int kInRows = kRows + 2;         // staged input rows
constexpr int kCols = 128;                 // output columns per tile: 64 a warpgroup
constexpr int kLead = 8;                   // staged columns left of the tile: TMA starts on 16 bytes
constexpr int kBoxW = 152;                 // staged columns (see the note above)
constexpr int kCi = 16;                    // input channels per chunk: one k16 step per tap
constexpr int kChan = 2 * kInRows * kBoxW;                  // bytes of one staged channel: 1520
constexpr int kStageBytes = kCi * kChan;                    // 24320
constexpr int kPix = kCols + 2;                             // relaid columns: the tile's and one each side
constexpr int kC8Bytes = 16 * kInRows * kPix;               // one relaid group of 8 channels: 10400
constexpr int kRelaidBytes = 2 * kC8Bytes;                  // the chunk's two groups
constexpr int kMaxN = 64;                  // output channels of a block, padded to a multiple of 8, at most
constexpr int kThreads = 256;              // two warpgroups
constexpr int kMaxStages = 4;              // ring depth, at most (3 for FAL_netB, 4 for A and C)
constexpr int kSmemLimit = 232448;         // a block's shared memory on sm_90
constexpr int kAlign = 1024;               // slack to align the dynamic shared memory
constexpr int kBarBytes = 8 * (kMaxStages + 1);
constexpr int kMaxDevices = 64;            // the launch settings are kept per device
static_assert(kChan % 32 == 16, "8 staged channels must start in 8 distinct 16-byte bank groups");
static_assert(kLead + kCols + 1 <= kBoxW && kBoxW % 8 == 0, "the staged box holds the tile's columns");

// The weights' bytes: a (N, 32-channel) tile of 64-byte rows per (32 input
// channels, tap), each a multiple of 512 bytes (N % 8 == 0): the 64-byte
// swizzle's period.
__host__ __device__ constexpr int weight_bytes(int Cin, int N) { return (Cin + 31) / 32 * 9 * N * 64; }

// The output channels split into co_tiles(Cout) equal tiles of tile_n(Cout) channels (a multiple of 8), one a
// blockIdx.y; the last is masked at Cout.
int co_tiles(int Cout) { return (Cout + kMaxN - 1) / kMaxN; }
int tile_n(int Cout) { return round_up((Cout + co_tiles(Cout) - 1) / co_tiles(Cout), 8); }

// Stages that fit beside the weights and the two relaid buffers; below 2 the shape is refused.
int stages_for(int wbytes) {
  int s = kMaxStages;
  while (s > 0 && kAlign + wbytes + s * kStageBytes + 2 * kRelaidBytes + kBarBytes > kSmemLimit) --s;
  return s;
}

// The tile grid: x tiles fastest, then row bands, then the batch.
struct Tiles {
  int x_tiles, y_tiles, B;
  __device__ __forceinline__ int count() const { return x_tiles * y_tiles * B; }
  __device__ __forceinline__ void at(int t, int& x0, int& y0, int& b) const {
    x0 = (t % x_tiles) * kCols;
    t /= x_tiles;
    y0 = (t % y_tiles) * kRows;
    b = t / y_tiles;
  }
};

// 8x8 16-bit matrices, one 16-byte row address per lane (lanes 8 i .. 8 i + 7
// give matrix i's rows).  Register i holds, of matrix i, row lane / 4,
// elements 2 (lane % 4) and 2 (lane % 4) + 1; transposed (_trans), element
// lane / 4 of rows 2 (lane % 4) and 2 (lane % 4) + 1.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ uint32_t ldmatrix_x1_trans(uint32_t addr) {
  uint32_t r;
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.trans.shared.b16 {%0}, [%1];" : "=r"(r) : "r"(addr));
  return r;
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void block_sync() { asm volatile("bar.sync 0;" ::: "memory"); }

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
    logits_conv_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
                       const float* __restrict__ bias, float* __restrict__ out, int Cin, int W, int Ho, int Cout,
                       int pad_h, int stages, Tiles tiles) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t wts = (raw + kAlign - 1) / kAlign * kAlign;  // the weights, the ring, the relaid buffers
  const uint32_t ring = wts + weight_bytes(Cin, N);
  const uint32_t relaid = ring + stages * kStageBytes;
  const uint32_t wbar = relaid + 2 * kRelaidBytes, full = wbar + 8;  // the weights', then stage s's at full + 8 s
  const int chunks = (Cin + kCi - 1) / kCi;
  const int n_tiles = tiles.count();
  const int total = n_tiles > (int)blockIdx.x ? ((n_tiles - 1 - blockIdx.x) / gridDim.x + 1) * chunks : 0;
  const int co0 = blockIdx.y * N;  // this block's output channels: co0 .. co0 + N - 1, below Cout

  // chunk i of this block's walk: tile blockIdx.x + (i / chunks) gridDim.x, channels (i % chunks) kCi ..
  auto load = [&](int i) {
    int x0, y0, b;
    tiles.at(blockIdx.x + i / chunks * gridDim.x, x0, y0, b);
    const int s = i % stages;
    mbar_expect_tx(full + 8 * s, kStageBytes);
    tma_load_4d(ring + s * kStageBytes, &x_map, full + 8 * s, x0 - kLead, y0 - pad_h, i % chunks * kCi, b);
  };
  if (threadIdx.x == 0) {
    mbar_init(wbar, 1);
    for (int s = 0; s < stages; ++s) mbar_init(full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(wbar, weight_bytes(Cin, N));
    for (int c = 0; c < (Cin + 31) / 32; ++c)
      for (int tap = 0; tap < 9; ++tap) tma_load_3d(wts + (c * 9 + tap) * N * 64, &w_map, wbar, 32 * c, tap, co0);
    for (int i = 0; i < stages && i < total; ++i) load(i);
  }
  __syncthreads();

  const int g = threadIdx.x / 128, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  // Relayout, warp w: 8 channels c8 = w / 4, staged column groups 1 + 4 (w % 4) .. 4 + 4 (w % 4) (16 bytes
  // each), every row: one ldmatrix.x4.trans a row.  Register k holds column 8 (1 + 4 (w % 4) + k) + gid of
  // channels 2 tig, 2 tig + 1, which is relaid column 8 (1 + 4 (w % 4) + k) + gid - kLead + 1.  Warps with
  // w % 4 == 0 also move the left edge (staged column kLead - 1, group 0: relaid column 0), those with
  // w % 4 == 3 the right (staged column kLead + kCols, group kGroupR: relaid column kPix - 1).
  constexpr int kGroupR = (kLead + kCols) / 8;
  const int c8 = warp / 4, quarter = warp % 4;
  const uint32_t src = (8 * c8 + lane % 8) * kChan + 16 * (1 + 4 * quarter + lane / 8);
  const uint32_t dst = c8 * kC8Bytes + 16 * (1 + 32 * quarter + gid) + 4 * tig;
  const bool left = quarter == 0, edge = quarter == 0 || quarter == 3;
  const uint32_t esrc = (8 * c8 + lane % 8) * kChan + (lane / 8) * kBoxW * 2 + (left ? 0 : 16 * kGroupR);
  const uint32_t edst = c8 * kC8Bytes + (left ? 0 : 16 * (kPix - 1)) + 4 * tig;
  const bool estore = gid == (left ? kLead - 1 : (kLead + kCols) % 8);
  // This lane's ldmatrix row of an A fragment: matrix q = lane / 8 is (pixels + 8 (q & 1), channels
  // + 8 (q >> 1)) of it.  Relaid (c8, row r, column j) is at c8 * kC8Bytes + (r * kPix + j) * 16; pixel p of
  // warpgroup g at tap dx reads column 64 g + p + dx.
  const uint32_t a_lane = (lane / 16) * kC8Bytes + (64 * g + 16 * (warp % 4) + lane % 8 + 8 * (lane / 8 % 2)) * 16;

  // chunk i from its stage into relaid buffer i % 2
  auto relayout = [&](int i) {
    const uint32_t st = ring + i % stages * kStageBytes, rl = relaid + (i & 1) * kRelaidBytes;
    mbar_wait(full + 8 * (i % stages), (i / stages) & 1);
#pragma unroll
    for (int r = 0; r < kInRows; ++r) {
      uint32_t d[4];
      ldmatrix_x4_trans(d, st + src + r * kBoxW * 2);
#pragma unroll
      for (int k = 0; k < 4; ++k) st_shared(rl + dst + r * kPix * 16 + 128 * k, d[k]);
    }
    if (edge) {
      uint32_t d[4];
      ldmatrix_x4_trans(d, st + esrc);
      const uint32_t d4 = ldmatrix_x1_trans(st + esrc + 4 * kBoxW * 2 * (lane < 8));
      if (estore) {
#pragma unroll
        for (int r = 0; r < 4; ++r) st_shared(rl + edst + r * kPix * 16, d[r]);
        st_shared(rl + edst + 4 * kPix * 16, d4);
      }
    }
  };
  // Chunk i + 1 is relaid once chunk i's wgmmas are issued, while they run; a
  // block barrier then orders the relaid stores before their loads and frees
  // chunk i + 1's stage, which thread 0 refills.
  if (total) relayout(0);
  block_sync();
  if (threadIdx.x == 0 && stages < total) load(stages);
  mbar_wait(wbar, 0);

  for (int i = 0, t = blockIdx.x; i < total; t += gridDim.x) {
    int x0, y0, b;
    tiles.at(t, x0, y0, b);
    float acc[kRows][N / 2];  // (pixel m + 8 ((k >> 1) & 1), channel 8 (k >> 2) + 2 tig + (k & 1)), from the bias
#pragma unroll
    for (int k = 0; k < N / 2; ++k) {
      const int co = co0 + 8 * (k >> 2) + 2 * tig + (k & 1);
      const float b0 = co < Cout ? bias[co] : 0.f;
#pragma unroll
      for (int o = 0; o < kRows; ++o) acc[o][k] = b0;
    }

    for (int c = 0; c < chunks; ++c, ++i) {
      const uint32_t xa = relaid + (i & 1) * kRelaidBytes + a_lane;
      const uint32_t wc = wts + (c / 2) * 9 * N * 64 + (c % 2) * 32;  // this chunk's 16 channels of each tap
      // input rows 0..2 (every wgmma of output row 0, two of row 1's taps, one of row 2's), then rows 3, 4
      uint32_t fa[3][3][4], fb[2][3][4];
      wgmma_wait<1>();  // the last chunk's first group is done: fa is free
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) ldmatrix_x4(fa[r][dx], xa + (r * kPix + dx) * 16);
      wgmma_fence();
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int o = 0; o <= r; ++o)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            Wgmma<N, Bf16>::run(acc[o], fa[r][dx], desc_sw64(wc + ((r - o) * 3 + dx) * N * 64));
      wgmma_commit();
      wgmma_wait<1>();  // the last chunk's second group is done: fb is free
#pragma unroll
      for (int r = 3; r < kInRows; ++r)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) ldmatrix_x4(fb[r - 3][dx], xa + (r * kPix + dx) * 16);
      wgmma_fence();
#pragma unroll
      for (int r = 3; r < kInRows; ++r)
#pragma unroll
        for (int o = r - 2; o < kRows; ++o)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            Wgmma<N, Bf16>::run(acc[o], fb[r - 3][dx], desc_sw64(wc + ((r - o) * 3 + dx) * N * 64));
      wgmma_commit();
      if (i + 1 < total) relayout(i + 1);
      block_sync();
      if (threadIdx.x == 0 && i + 1 + stages < total) load(i + 1 + stages);
    }
    wgmma_wait<0>();

    // epilogue: bias plus sum, in acc
    const int m = 64 * g + 16 * (warp % 4) + gid;
#pragma unroll
    for (int o = 0; o < kRows; ++o) {
      const int y = y0 + o;
      if (y >= Ho) break;
#pragma unroll
      for (int k = 0; k < N / 2; ++k) {
        const int xx = x0 + m + 8 * ((k >> 1) & 1);
        const int co = co0 + 8 * (k >> 2) + 2 * tig + (k & 1);
        if (xx < W && co < Cout) out[(((size_t)b * Cout + co) * Ho + y) * W + xx] = acc[o][k];
      }
    }
  }
}

// The shared-memory limit and the SM count are CUDA calls of microseconds
// each, made while the card waits for the launch: once per device (and, for
// the limit, per instance of the kernel), as conv3x3_wgmma.cu does.
template <int N>
int launch(const CUtensorMap& xm, const CUtensorMap& wm, const float* bias, float* out, int Cin, int W, int Ho,
           int Cout, int pad_h, Tiles tiles, int sms, int dev, cudaStream_t stream) {
  auto kernel = logits_conv_kernel<N>;
  const int wbytes = weight_bytes(Cin, N), stages = stages_for(wbytes);
  const int smem = kAlign + wbytes + stages * kStageBytes + 2 * kRelaidBytes + kBarBytes;
  static bool set[kMaxDevices];  // per device, for this instance: the most any shape asks
  if (!set[dev]) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    set[dev] = true;
  }
  const long long count = (long long)tiles.x_tiles * tiles.y_tiles * tiles.B;
  const int co = co_tiles(Cout), per = sms / co > 1 ? sms / co : 1;  // about one block an SM over all tiles
  const dim3 grid((unsigned)(count < per ? count : per), (unsigned)co);
  kernel<<<grid, kThreads, smem, stream>>>(xm, wm, bias, out, Cin, W, Ho, Cout, pad_h, stages, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Whether L1 takes Cin input and Cout output channels: 0 if so; else 1.
// `bytes` gets the bytes of one block's weights in shared memory (a tile of
// at most kMaxN output channels) and the most that fit.
int logits_conv_fits(int Cin, int Cout, long long* bytes) {
  bytes[0] = Cin < 1 || Cout < 1 ? 0 : weight_bytes(Cin, tile_n(Cout));
  bytes[1] = kSmemLimit - kAlign - kBarBytes - 2 * kStageBytes - 2 * kRelaidBytes;
  return Cin < 1 || Cout < 1 || bytes[0] > bytes[1];
}

// Launch L1 on `stream`: x (B, Cin, H, W) bf16 at the element strides
// (row, channel, batch) = xs, w (Cout, 9, w_cin) bf16 (k[co, ci, dy, dx] at
// w[co, 3 dy + dx, ci], zero for ci >= Cin), bias (Cout) fp32 and out (B,
// Cout, H - 2 + 2 pad_h, W) fp32 contiguous, device buffers.  Returns
// cudaErrorInvalidValue, launching nothing, for what it does not take (a
// size below 1, pad_h other than 0 or 1, a stride of x or w_cin not a
// multiple of 8, x or w not 16-byte aligned, w_cin below Cin, weights that
// do not fit (logits_conv_fits), a tile count past an int's reach); else the
// error of encoding the tensor maps or of the launch (0 on success).
int logits_conv(const void* x, const long long* xs, const void* w, const float* bias, float* out, int B, int Cin,
                int H, int W, int Cout, int pad_h, int w_cin, void* stream) {
  const int Ho = H - 2 + 2 * pad_h;
  long long fit[2];
  if (B < 1 || Cin < 1 || W < 1 || Cout < 1 || (pad_h != 0 && pad_h != 1) || Ho < 1 || w_cin < Cin || w_cin % 8 ||
      xs[0] % 8 || xs[1] % 8 || xs[2] % 8 || xs[0] < 1 || xs[1] < 1 || xs[2] < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16 || logits_conv_fits(Cin, Cout, fit))
    return (int)cudaErrorInvalidValue;
  const Tiles tiles{(W + kCols - 1) / kCols, (Ho + kRows - 1) / kRows, B};
  if ((long long)tiles.x_tiles * tiles.y_tiles * B > 0x7fffffff) return (int)cudaErrorInvalidValue;
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

  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUtensorMap xm = {}, wm = {};
  // x (B, Cin, H, W) at its strides, innermost first; a box is kBoxW columns of kInRows rows of kCi channels
  const cuuint64_t xdim[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)Cin, (cuuint64_t)B};
  const cuuint64_t xstride[3] = {(cuuint64_t)xs[0] * 2, (cuuint64_t)xs[1] * 2, (cuuint64_t)xs[2] * 2};
  const cuuint32_t xbox[4] = {kBoxW, kInRows, kCi, 1};
  if (encode(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), xdim, xstride, xbox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  // w (Cout, 9, w_cin) seen as (w_cin, 9, Cout), innermost first; a box is one tap's (N, 32) tile of one
  // block's output channels, zero past w_cin and Cout
  const int N = tile_n(Cout);
  const cuuint64_t wdim[3] = {(cuuint64_t)w_cin, 9, (cuuint64_t)Cout};
  const cuuint64_t wstride[2] = {(cuuint64_t)w_cin * 2, (cuuint64_t)w_cin * 18};
  const cuuint32_t wbox[3] = {32, 1, (cuuint32_t)N};
  if (encode(&wm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), wdim, wstride, wbox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;

  const int sms = sms_of[dev];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define L1_LAUNCH(n) launch<n>(xm, wm, bias, out, Cin, W, Ho, Cout, pad_h, tiles, sms, dev, st)
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

}  // extern "C"
