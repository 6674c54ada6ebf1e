// Asynchronous copies into shared memory on Hopper (sm_90a), and the
// plane-row staging of the MED kernels.
//
// Part 1, included by every kernel of csrc/ that stages data
// (conv3x3_wgmma.cu, med_fwd.cu, med_bwd.cu): mbarrier helpers whose waits
// trap after 4 s, so that a pipeline fault is a launch error and not a hung
// card; TMA tensor and 1-D bulk copies; the 4-byte zero-filling cp.async.
//
// Part 2, K1 and K2 (med_fwd.cu, med_bwd.cu).  A block owns image rows
// (b, y) in turn: it is persistent, and walks rows blockIdx.x,
// blockIdx.x + gridDim.x, ...  The row's N plane rows logits[b, n, y, :]
// (W floats each) go in stages of G consecutive planes (G <= kGroup = 7;
// N = 49 is 7 stages of 7) through a ring of R slots in shared memory, each
// slot with a full and an empty mbarrier:
//   * the producer, the block's last warp, waits for a slot's empty barrier
//     and fills the slot with a stage.  Where W * 4 bytes and the rows'
//     addresses are multiples of 16, lane 0 issues one 1-D bulk copy per
//     plane row (cp.async.bulk ... complete_tx: no tensor map) and the full
//     barrier (count 1) waits for their bytes.  Otherwise (W = 187, or an
//     unaligned view) its 32 lanes copy 4 bytes each with cp.async, and
//     cp.async.mbarrier.arrive.noinc completes the full barrier (count 32)
//     once every lane's copies have landed.  The consumers read the slot
//     through the generic proxy after the barrier flips, so no proxy fence
//     is needed (the conv needs one: its wgmma reads through the async
//     proxy);
//   * the consumers (all other warps) make sweeps over the stages: for each
//     they wait for its slot, read its planes, shifted reads included, and
//     release it (one arrival per warp), while later stages are in flight.
//     A stage is G planes of independent work that the kernels unroll, for
//     one barrier wait and one release; the rows of a short last stage past
//     its planes are a dummy row of -1e30 logits, which weighs nothing.
// Every staged row keeps zeros in the column before and after it, and reads
// at a column clamped to [-1, W] are the zero-padded gather of the MED
// shifts, without a branch.
// The plan (StagePlan) picks one of two paths per launch:
//   * whole row: R = ceil(N / G) slots hold the row's N plane rows, each
//     loaded once.  The first sweep waits for a stage and the last releases
//     it, so a kernel that needs two passes over the row reads the logits
//     from device memory once, and the next row's first stages are copied
//     while the last sweep works on the later ones;
//   * ring: fewer slots, and every sweep streams the N planes again.
// Columns: thread i of the `consumers` owns columns
// c * cpt * consumers + k * consumers + i (k < cpt) of chunk c; cpt = 2 above
// W = 640, so that W = 640 and W = 1280 fill every thread.  Wider rows take
// several chunks, each a sweep of its own.
// Where neither path fits a whole plane row (wide rows), the plan takes the
// direct path: a slot row holds one chunk's window, the chunk's columns and
// `margin` columns on each side (margin: the largest |floor| of the plane
// shifts plus the lerp's and the masks' neighbours, from the bounds), so
// that shared memory does not grow with W.  Every sweep streams its chunk's
// window through the ring; the sweeps visit the chunks in the order of
// sweep_chunk(), which the producer and the consumers share.  Reads outside
// [0, W) give zero without touching the window (RowCols).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---- Part 1: barriers and copies ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// Wait for the phase of `bar` after `parity`.  A wait of more than 4 s is a
// fault of the pipeline: trap, so that the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t start = 0;
  for (uint32_t i = 1; !mbar_try(bar, parity); ++i) {
    if (i % 1024) continue;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (!start) start = now;
    else if (now - start > 4000000000ull) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory; its bytes count against `bar`'s transactions.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// 4-byte cp.async that stores zero when `in` is false (src-size 0).
__device__ __forceinline__ void cp_async_4(uint32_t dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src), "r"(in ? 4 : 0) : "memory");
}

// One arrival on `bar` once this thread's earlier cp.asyncs have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}

// ---- Part 2: plane-row staging of K1 and K2 ----

constexpr int kMaxPlanes = 128;
constexpr int kMaxChannels = 4;
constexpr int kMaxConsumers = 640;                // 20 warps
constexpr int kStageThreads = kMaxConsumers + 32;  // and the producer warp
constexpr int kGroup = 7;                         // plane rows per stage, at most: N = 49 is 7 stages
constexpr float kNoLogit = -1e30f;                // the dummy row's logits: weight 2^(-1e30 log2 e) = 0
constexpr size_t kMaxSmemBytes = 232448;          // dynamic shared memory of one block
constexpr float kLog2e = 1.4426950408889634f;     // ex2.approx is base 2: e^d = 2^(d log2 e)

struct StagePlan {
  int consumers;  // consumer threads, a multiple of 32
  int cpt;        // columns per thread in a chunk (1 or 2)
  int chunks;     // column chunks of cpt * consumers
  int group;      // G: plane rows per stage (one barrier wait and one release per stage)
  int slots;      // R: stages in the ring
  int whole;      // R = ceil(N / G): each plane row is loaded once per image row
  int sweeps;     // sweeps over the N planes per image row
  int loads;      // stage loads per image row: ceil(N / G) if whole, else sweeps * ceil(N / G)
  int smem;       // dynamic shared memory bytes: [2R mbarriers][R slots of G rows][extra]
  int direct;     // rows too wide: slot rows hold a chunk's window; image and g_pan rows read from device memory
  int margin;     // direct: window columns on each side of a chunk (a multiple of 4); else 0
  int span;       // columns of a slot row: W, or on the direct path cpt * consumers + 2 * margin
  int ahead;      // direct: sweeps of chunk c + 1 made before chunk c's own (0 or 1; see sweep_chunk)
  int own;        // direct: sweeps of chunk c made after them
};

// Row pitch in floats of a staged row: W floats from offset 4 (16 bytes, so
// that bulk copies land aligned), with zeros at offsets 3 and W + 4.  Those
// zero guards stand for every column outside [0, W): a read at column j
// clamped to [-1, W] is the row's value with zero padding.
__host__ __device__ inline int row_pitch(int W) { return (W + 3) / 4 * 4 + 8; }

// The sizes both MED kernels take before their plans: N planes, C image
// channels, a batch and rows that fit an int, the tables' stride.
inline bool med_sizes_ok(int B, int N, int C, int H, int W, int tab_stride) {
  return N >= 2 && N <= kMaxPlanes && C >= 1 && C <= kMaxChannels && B >= 1 && H >= 1 && W >= 1 &&
         (long long)B * H <= 0x7fffffff && (tab_stride == 0 || tab_stride == 5 * N);
}

// Columns to threads: cpt = 2 above 640 columns, at most kMaxConsumers threads.
inline void plan_columns(StagePlan& p, int W) {
  p.direct = p.margin = p.ahead = 0;
  p.own = 1;
  p.span = W;
  p.cpt = W > kMaxConsumers ? 2 : 1;
  const int per = ((W + p.cpt - 1) / p.cpt + 31) / 32 * 32;
  p.consumers = per < kMaxConsumers ? per : kMaxConsumers;
  p.chunks = (W + p.cpt * p.consumers - 1) / (p.cpt * p.consumers);
}

// Stages and ring: the N planes in ceil(N / G) stages of equal size, G the
// largest at most kGroup for which one stage fits beside the dummy row,
// `extra` bytes and `per_row` bytes for each row of a stage; then as many
// stages in the ring as fit, at most a whole row.  Slot rows hold p.span
// columns.  False if not one plane row fits.  plan_columns must have run
// (sweeps depend on chunks).  The direct path never keeps a whole row: each
// sweep reads a window of its own.
inline bool plan_slots(StagePlan& p, int N, int sweeps, size_t extra, size_t per_row = 0) {
  const size_t row = 4 * (size_t)row_pitch(p.span);
  for (int most = kGroup; most >= 1; --most) {
    const int g = (N + (N + most - 1) / most - 1) / ((N + most - 1) / most);
    const int stages = (N + g - 1) / g;
    const size_t fixed = extra + row + per_row * g;  // and the dummy row
    const size_t slot = 16 + row * g;               // two mbarriers and G plane rows
    if (fixed + slot > kMaxSmemBytes) continue;
    size_t r = (kMaxSmemBytes - fixed) / slot;
    if (r > (size_t)stages) r = stages;
    p.group = g;
    p.slots = (int)r;
    p.whole = p.slots == stages && !p.direct;
    p.sweeps = sweeps;
    p.loads = p.whole ? stages : sweeps * stages;
    p.smem = (int)(r * slot + fixed);
    return true;
  }
  return false;
}

// The direct path's settings, once the staged plans are found not to fit:
// chunks' windows of `margin` columns on each side, `ahead` and `own` sweeps
// a chunk (see sweep_chunk).  False where the margin does not fit: it must
// be a multiple of 4 (the windows' copies stay 16-byte aligned) and at most
// a chunk, since the statistics of other columns are kept for the chunks
// before and after the current one only.  Only with cpt = 2 (W > 640).
inline bool plan_direct(StagePlan& p, int margin, int ahead, int own) {
  const int cw = p.cpt * p.consumers;
  if (p.cpt != 2 || margin < 0 || margin % 4 || margin > cw) return false;
  p.direct = 1;
  p.margin = margin;
  p.span = cw + 2 * margin;
  p.ahead = ahead;
  p.own = own;
  return true;
}

// The plan's fields in order, for the C entries that report it.
constexpr int kPlanFields = 11;
inline void plan_fields(const StagePlan& p, int* out) {
  const int v[kPlanFields] = {p.consumers, p.cpt,   p.chunks, p.group,  p.slots, p.whole,
                              p.sweeps,    p.loads, p.smem,   p.direct, p.margin};
  for (int i = 0; i < kPlanFields; ++i) out[i] = v[i];
}

// The chunk whose window sweep s of an image row reads, on the direct path:
// chunk s / own without `ahead`; with it, chunk 0's ahead sweep, then for
// each chunk c the ahead sweep of c + 1 (while there is one) and c's own
// sweeps.  So the statistics a chunk's own sweeps read at other columns
// (within a margin, so in chunks c - 1 .. c + 1) are complete.
__host__ __device__ inline int sweep_chunk(const StagePlan& p, int s) {
  if (!p.ahead) return s / p.own;
  if (s == 0) return 0;
  const int t = s - 1, c = t / (p.own + 1);
  if (c >= p.chunks - 1) return p.chunks - 1;
  return t % (p.own + 1) == 0 ? c + 1 : c;
}

// Column x of chunk c, sub-column k, for consumer thread i (W or more: none).
__device__ __forceinline__ int column(const StagePlan& p, int c, int k, int i) {
  return (c * p.cpt + k) * p.consumers + i;
}

struct Ring {
  uint32_t slot = 0, phase = 0;
  __device__ __forceinline__ void next(uint32_t slots) {
    if (++slot == slots) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// The shared-memory view of the ring.
struct RowStage {
  uint32_t full, empty, slots_u32;  // shared addresses
  const float* slots;
  const float* dummy;  // column 0 of a row of kNoLogit: the rows of a short stage past its last plane
  int P, G, R;         // row pitch (of p.span columns), rows per stage, slots
  // column 0 of the stage's first row; row i starts P floats after row i - 1
  __device__ __forceinline__ const float* rows(uint32_t s) const { return slots + (size_t)s * G * P + 4; }
};

// Lay out the ring and the dummy row at the start of dynamic shared memory,
// zero all of it (the rows' guards stay zero: copies write columns 0 .. W-1
// only), fill the dummy row and initialise the barriers.  All threads call
// this, then sync; `extra` points past the dummy row.
__device__ __forceinline__ RowStage stage_init(unsigned char* smem, const StagePlan& p, bool bulk, float** extra) {
  for (int i = threadIdx.x; i < p.smem / 16; i += blockDim.x) reinterpret_cast<float4*>(smem)[i] = float4{};
  __syncthreads();
  RowStage st;
  st.R = p.slots;
  st.G = p.group;
  st.P = row_pitch(p.span);
  st.full = smem_u32(smem);
  st.empty = st.full + 8 * p.slots;
  st.slots = reinterpret_cast<const float*>(smem + 16 * p.slots);
  st.slots_u32 = st.full + 16 * p.slots;
  float* dummy = reinterpret_cast<float*>(smem + 16 * p.slots + 4 * (size_t)st.P * p.group * p.slots) + 4;
  for (int x = threadIdx.x; x < st.P; x += blockDim.x) dummy[x - 4] = kNoLogit;  // its guards too
  st.dummy = dummy;
  *extra = dummy - 4 + st.P;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.slots; ++s) {
      mbar_init(st.full + 8 * s, bulk ? 1 : 32);
      mbar_init(st.empty + 8 * s, p.consumers / 32);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  return st;
}

// The producer warp: for each of the block's image rows, plan.loads stages
// in the order the consumers read them; stage j holds planes
// (j mod ceil(N/G)) * G onwards, at most G of them: whole plane rows, or on
// the direct path the columns of sweep j / ceil(N/G)'s window that lie in
// [0, W) (the rest of the slot row is never read).
__device__ __forceinline__ void produce_rows(const RowStage& st, const StagePlan& p, const float* __restrict__ logits,
                                             int N, int H, int W, int rows, bool bulk) {
  const int lane = threadIdx.x % 32;
  if (bulk && lane != 0) return;
  const uint32_t pitch = 4 * st.P;
  const size_t plane = (size_t)H * W;
  const int stages = (N + st.G - 1) / st.G, chunk_cols = p.cpt * p.consumers;
  Ring ring;
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const int b = row / H, y = row - b * H;
    const float* src0 = logits + ((size_t)b * N * H + y) * W;
    for (int j = 0, n0 = 0; j < p.loads; ++j) {
      const int g = N - n0 < st.G ? N - n0 : st.G;
      int lo = 0, hi = W, off = 0;  // columns [lo, hi) to slot column off
      if (p.direct) {
        const int ws = sweep_chunk(p, j / stages) * chunk_cols - p.margin;
        lo = max(ws, 0);
        hi = min(ws + p.span, W);
        off = lo - ws;
      }
      const uint32_t bytes = 4 * (hi - lo);
      const uint32_t full = st.full + 8 * ring.slot, dst = st.slots_u32 + ring.slot * st.G * pitch + 16 + 4 * off;
      const float* src = src0 + n0 * plane + lo;
      mbar_wait(st.empty + 8 * ring.slot, ring.phase ^ 1);
      if (bulk) {
        mbar_expect_tx(full, g * bytes);
        for (int i = 0; i < g; ++i) bulk_load(dst + i * pitch, src + i * plane, bytes, full);
      } else {
        for (int i = 0; i < g; ++i)
          for (int x = lane; x < hi - lo; x += 32) cp_async_4(dst + i * pitch + 4 * x, src + i * plane + x, true);
        cp_async_arrive(full);
      }
      ring.next(st.R);
      n0 += st.G;
      if (n0 >= N) n0 = 0;
    }
  }
}

// The consumers' sweeps over one image row: call next(body) once per sweep,
// plan.sweeps times; body(n0, g, rows) runs for the stages in order, with
// planes n0 .. n0 + g - 1 at rows + i * P in shared memory.
struct RowSweeps {
  const RowStage& st;
  const StagePlan& p;
  Ring& ring;  // the consumers' position; advanced past the image row
  int N;
  Ring start;
  int s = 0;
  __device__ __forceinline__ RowSweeps(const RowStage& st_, const StagePlan& p_, Ring& ring_, int N_)
      : st(st_), p(p_), ring(ring_), N(N_), start(ring_) {}

  template <class Body>
  __device__ __forceinline__ void next(Body&& body) {
    // whole row: every sweep reads the same slots, waited for by the first
    // and released by the last; ring: every sweep reads loads of its own
    const bool wait = !p.whole || s == 0, release = !p.whole || s == p.sweeps - 1;
    Ring r = p.whole ? start : ring;
    for (int n0 = 0; n0 < N; n0 += st.G) {
      if (wait) mbar_wait(st.full + 8 * r.slot, r.phase);
      body(n0, N - n0 < st.G ? N - n0 : st.G, st.rows(r.slot));
      if (release) {
        __syncwarp();
        if (threadIdx.x % 32 == 0) mbar_arrive(st.empty + 8 * r.slot);
      }
      r.next(st.R);
    }
    ring = r;
    ++s;
  }
};

// A barrier of the consumer warps alone (the producer runs ahead).
__device__ __forceinline__ void consumers_sync(int consumers) {
  asm volatile("bar.sync 1, %0;" ::"r"(consumers) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// e^d for d = l - m, a logit less a maximum, taken in the logit domain as
// the plain softmax takes it: l <= m makes d, and so the exponent, at most 0
// exactly, and the rounding of d * log2 e is relative to |d|, not to |l|.
__device__ __forceinline__ float exp_diff(float d) { return ex2(d * kLog2e); }

// A softmax's weight of logit l at a column whose statistics are st =
// (maximum m, log2 of the sum of e^(l' - m)): e^(l - m) / sum, at most 1.
__device__ __forceinline__ float softmax_at(float l, float2 st) { return ex2((l - st.x) * kLog2e - st.y); }

// A plane's table entry in shared memory (one 16-byte load): level, forward
// floor and fraction, backward fraction; the backward floor is apart.
// Entries N .. N + kGroup - 2 are zeros: the dummy planes of a short stage.
struct __align__(16) PlaneTab {
  float lev, t;
  int f;
  float tb;
};

inline size_t plane_tab_bytes(int N) { return 16 * (size_t)(N + kGroup - 1); }

// Copy sample tables `tab` ((5, N) fp32 rows: level, fwd floor, fwd frac, bwd
// floor, bwd frac) into s_tab (and the backward floors into s_fb, if given),
// threads `first` onwards in steps of `step`.
__device__ __forceinline__ void load_plane_tabs(PlaneTab* s_tab, int* s_fb, const float* __restrict__ tab, int N,
                                                int first, int step) {
  for (int n = first; n < N + kGroup - 1; n += step) {
    const bool in = n < N;
    PlaneTab e;
    e.lev = in ? __ldg(tab + n) : 0.f;
    e.f = in ? (int)__ldg(tab + N + n) : 0;
    e.t = in ? __ldg(tab + 2 * N + n) : 0.f;
    e.tb = in ? __ldg(tab + 4 * N + n) : 0.f;
    s_tab[n] = e;
    if (s_fb) s_fb[n] = in ? (int)__ldg(tab + 3 * N + n) : 0;
  }
}

// The kGroup rows of a stage: plane n0 + i at lr[i] for i < g, the dummy row
// past it (it weighs nothing in any softmax).
__device__ __forceinline__ void stage_rows(const RowStage& st, const float* rows, int g, const float* (&lr)[kGroup]) {
#pragma unroll
  for (int i = 0; i < kGroup; ++i) lr[i] = i < g ? rows + i * st.P : st.dummy;
}

// v[j] of a row with zero guards (row_pitch): zero outside [0, W).
__device__ __forceinline__ float pad(const float* v, int j, int W) { return v[min(max(j, -1), W)]; }

// The lerp (1-t) a + t b of two logits, rounded as the plain head
// (ops/shift.py) and JAX's kernel round it: 1 - t, each product and the sum
// on their own, so that nvcc contracts nothing into a fused multiply-add.
// t is the tables' fp32 fraction, the plain head's `frac`; at |l| = 1e4 a
// fused form differs by up to 2 ulps of l, 2e-3 in an exponent.
__device__ __forceinline__ float lerp_logit(float a, float b, float t) {
  return __fadd_rn(__fmul_rn(__fsub_rn(1.f, t), a), __fmul_rn(t, b));
}

// The lerp gather (1-t) v[j] + t v[j+1] of a logit row with zero guards.
__device__ __forceinline__ float lerp_at(const float* v, int j, float t, int W) {
  return lerp_logit(pad(v, j, W), pad(v, j + 1, W), t);
}

// Reads of a slot row v at image column j, zero outside [0, W): the whole
// row (kWin false; column 0 at v[0], reads clamped into its zero guards), or
// on the direct path a chunk's window (column ws at v[0]).  The window holds
// every column in [0, W) that a read of its chunk reaches; the index is
// clamped into the window all the same.
template <bool kWin>
struct RowCols {
  int W, ws, span;
  // column j, 0 <= j < W
  __device__ __forceinline__ float in(const float* v, int j) const { return kWin ? v[j - ws] : v[j]; }
  // the lerp gather (1-t) v[j] + t v[j+1] of logits (lerp_logit)
  __device__ __forceinline__ float lerp(const float* v, int j, float t) const {
    return kWin ? lerp_logit(win(v, j), win(v, j + 1), t) : lerp_at(v, j, t, W);
  }

 private:
  __device__ __forceinline__ float win(const float* v, int j) const {
    return (unsigned)j < (unsigned)W ? v[min(max(j - ws, 0), span - 1)] : 0.f;
  }
};

// An image row in shared memory holds one float4 per column (channels 0..3,
// zero past C) from column -1 to W, zero at -1 and W: one 16-byte load reads
// every channel.  Its size in floats:
__host__ __device__ inline int image_floats(int W) { return 4 * (W + 2); }

// The lerp gather of every channel of such a row.
__device__ __forceinline__ float4 lerp4_at(const float4* v, int j, float t, int W) {
  const float4 a = v[min(max(j, -1), W)], b = v[min(max(j + 1, -1), W)];
  return make_float4(fmaf(t, b.x - a.x, a.x), fmaf(t, b.y - a.y, a.y), fmaf(t, b.z - a.z, a.z),
                     fmaf(t, b.w - a.w, a.w));
}

// Column j of a (B, C, H, W) tensor's row in device memory (`src` at its
// channel 0, channels `plane` floats apart) as a float4, zero past C and
// outside [0, W): the unstaged counterpart of a float4 row's v[j].
__device__ __forceinline__ float4 ld_row4(const float* __restrict__ src, int j, int C, int W, size_t plane) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (j < 0 || j >= W) return v;
  v.x = __ldg(src + j);
  if (C > 1) v.y = __ldg(src + plane + j);
  if (C > 2) v.z = __ldg(src + 2 * plane + j);
  if (C > 3) v.w = __ldg(src + 3 * plane + j);
  return v;
}

// The lerp gather of every channel of such a row in device memory.
__device__ __forceinline__ float4 lerp4_ld(const float* __restrict__ src, int j, float t, int C, int W,
                                           size_t plane) {
  const float4 a = ld_row4(src, j, C, W, plane), b = ld_row4(src, j + 1, C, W, plane);
  return make_float4(fmaf(t, b.x - a.x, a.x), fmaf(t, b.y - a.y, a.y), fmaf(t, b.z - a.z, a.z),
                     fmaf(t, b.w - a.w, a.w));
}

// Stage an image row (b, ., y, .) of a (B, C, H, W) tensor: column x of
// channel c to s_img4[x] component c, by `step` threads from `first`.
__device__ __forceinline__ void load_image_row(float4* s_img4, const float* __restrict__ src, int C, int W,
                                               size_t plane, int first, int step) {
  for (int i = first; i < C * W; i += step) {
    const int c = i / W, x = i - c * W;
    reinterpret_cast<float*>(s_img4 + x)[c] = __ldg(src + c * plane + x);
  }
}

// Set the ring's size limit, pick the persistent grid from the occupancy
// and launch `kKernel` over `rows` image rows.  The attribute, SM count and
// occupancy are driver calls of microseconds each, made while the card
// waits for this launch: they are made once per device and block size.
template <auto kKernel, class... Args>
cudaError_t launch_rows(const StagePlan& p, int rows, cudaStream_t stream, Args... args) {
  struct Sizing {
    int smem = -1, threads = -1, sms = 0, per_sm = 0;
  };
  static Sizing sizing[64];  // per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  const int threads = p.consumers + 32;
  Sizing s = sizing[dev];
  if (s.smem != p.smem || s.threads != threads) {
    s = Sizing{p.smem, threads, 0, 0};
    err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&s.per_sm, kKernel, threads, p.smem);
    if (err != cudaSuccess) return err;
    if (s.per_sm < 1) return cudaErrorInvalidConfiguration;
    sizing[dev] = s;
  }
  const long long slots = (long long)s.sms * s.per_sm;
  const int grid = (int)(rows < slots ? rows : slots);
  kKernel<<<grid, threads, p.smem, stream>>>(args..., p);
  return cudaGetLastError();
}

}  // namespace
