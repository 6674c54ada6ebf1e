// MED forward kernel for Hopper (sm_90a).
//
// Replaces fal_net_tpu/ops/med_pallas.py::_fwd_kernel, the Pallas TPU
// kernel of the MED (Mirrored Exponential Disparity) head.  It computes
// what that kernel computes, not how: the TPU version stages an
// (N, 8, W) fp32 volume in VMEM per 8-row tile over a sequential grid;
// here a block stages one image row's plane rows in shared memory, in turn.
//
// For plane n with pixel shift s_n = d_n * (W-1)/W, S_s is the 1-D lerp
// gather along W that reads 0 out of range:
//   S_s(v)[x] = (1-t) v[x+f] + t v[x+f+1],   f = floor(s), t = s - f.
// Outputs per pixel (B, ., H, W), all math fp32:
//   disp   = sum_n d_n softmax_n(l)
//   Dprob  = softmax_n(S_{+s_n}(l_n))             (zero LOGIT padding)
//   pan_c  = sum_n S_{+s_n}(img_c) Dprob_n
//   maskR  = min(1, sum_n S_{+s_n}(softmax(l)_n))  (normalized at the source)
//   maskL  = min(1, sum_n S_{-s_n}(Dprob_n))       (zero PROBABILITY padding)
//
// What bounds it on the card: memory, in principle.  At B=8, N=49,
// 384x1280 the logits volume is 770 MB; read once from device memory that is
// 0.23 ms at 3.35 TB/s, while the arithmetic is ~6 operations per logit in
// disp mode.  The design (staging in med_stage.cuh):
//   * persistent blocks walk the image rows; a producer warp copies the
//     row's plane rows, in stages of up to 7 planes, into a ring of
//     shared-memory slots with 1-D bulk copies (cp.async where W * 4 is not
//     a multiple of 16), so that many plane rows are in flight while the
//     consumer warps work on earlier ones.  A plane row is read from device
//     memory once; the shifted reads l_n[x+f_n], l_n[x+f_n+1] and the image
//     reads are shared-memory loads, clamped into zero guards instead of
//     bounds checks; the image row is one float4 per column, so one load
//     reads every channel;
//   * disp and pan are one sweep over the planes with online softmaxes: one
//     over l_n[x] for disp, one over the shifted logit carrying the C pan
//     accumulators.  Each takes a stage's maximum first and rescales its
//     sums once a stage, not once a plane, with no branch;
//   * every softmax keeps its maximum m of the logits themselves and weighs
//     a logit l by ex2.approx((l - m) log2 e), as the plain softmax and
//     JAX's kernel take exp(l - m): the difference is exact where a weight
//     counts, so the rounding does not grow with |l|, and l <= m keeps every
//     exponent at most 0 at any finite logits.  The shifted logits are
//     lerped with the plain head's rounding (lerp_logit), so that both
//     softmaxes see the same values at |l| = 1e6;
//   * the masks read softmax statistics at OTHER columns, so subocc mode
//     stores per column the maximum and the log2-sum of both softmaxes in
//     shared memory during that sweep (two parts: m + log2 sum in one float
//     would round at |m|), and after a barrier of the consumers sums the
//     shifted probabilities in a second sweep: from the same slots where the
//     row fits in shared memory (whole row), else from a second stream of
//     the planes (ring);
//   * direct path, for rows too wide to stage whole plane rows beside the
//     image row (16 B a column) and the statistics (at N = 49: W > 9,634
//     with pan, > 5,780 with pan and subocc, > 28,908 disp alone): a slot
//     row holds one 1,280-column chunk's window, the chunk and the shift
//     margin on each side, so shared memory does not grow with W; the image
//     row is read from device memory, through the caches, at the shifted
//     columns.  With subocc, the statistics are kept for three chunks (the
//     one before, the current one and the next), and the chunks' sweeps go
//     stats(0), stats(1), masks(0), stats(2), masks(1), ...: the masks of a
//     chunk read statistics within a margin of it.
// On an H100 the pan modes are bound by the consumers' issue rate and
// shared-memory loads, not by device memory (PERF.md).
// Plane tables (level, forward and backward floor/frac; 5*N fp32) are a
// small device buffer with one table per sample, or one for the whole
// batch (stride 0); a block copies its sample's into shared memory, with
// floors as integers (once, or per image row for per-sample tables).

#include "med_stage.cuh"

namespace {

// Floats of the plane tables and backward floors, a multiple of 4.
__host__ __device__ inline int fwd_tab_floats(int N) { return 5 * (N + kGroup - 1) / 4 * 4 + 4; }

template <bool kDisp, bool kPan, bool kSub, int kCpt, bool kDirect>
__global__ void __launch_bounds__(kStageThreads, 1)
med_fwd_kernel(const float* __restrict__ logits,  // (B, N, H, W)
               const float* __restrict__ image,   // (B, C, H, W)
               float* __restrict__ disp,          // (B, 1, H, W)
               float* __restrict__ pan,           // (B, C, H, W)
               float* __restrict__ mask_l,        // (B, 1, H, W)
               float* __restrict__ mask_r,        // (B, 1, H, W)
               const float* __restrict__ tables,  // (B or 1, 5, N)
               int tab_stride, int N, int C, int H, int W, int rows, int bulk, const StagePlan p) {
  constexpr bool kPlain = kDisp || kSub;  // needs softmax(l)
  constexpr bool kShift = kPan || kSub;   // needs softmax(S l)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* extra;
  const RowStage st = stage_init(smem_raw, p, bulk, &extra);
  // extra: [plane tables][backward floors], [image row] for pan (not on
  // the direct path), then for subocc the statistics (maximum, log2-sum) of
  // softmax(l) and of softmax(S l): W columns each, or on the direct path
  // three chunks' columns, column x at x mod their count
  constexpr bool kStageImg = kPan && !kDirect;
  const int chunk_cols = p.cpt * p.consumers, st_cols = kDirect ? 3 * chunk_cols : W;
  PlaneTab* s_tab = reinterpret_cast<PlaneTab*>(extra);
  int* s_fb = reinterpret_cast<int*>(s_tab + N + kGroup - 1);
  float4* s_img4 = reinterpret_cast<float4*>(extra + fwd_tab_floats(N)) + 1;  // column 0
  float2* s_st0 = reinterpret_cast<float2*>(extra + fwd_tab_floats(N) + (kStageImg ? image_floats(W) : 0));
  float2* s_st1 = s_st0 + st_cols;
  auto st_at = [&](int x) { return kDirect ? x % st_cols : x; };  // 0 <= x < W
  if (tab_stride == 0) load_plane_tabs(s_tab, s_fb, tables, N, threadIdx.x, blockDim.x);
  __syncthreads();

  const int tid = threadIdx.x;
  if (tid >= p.consumers) {
    produce_rows(st, p, logits, N, H, W, rows, bulk);
    return;
  }

  const size_t plane = (size_t)H * W;
  Ring ring;
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const int b = row / H, y = row - b * H;
    const size_t pix = ((size_t)b * H + y) * W;       // (b, 0, y, 0) of 1-ch outputs
    const size_t crow = ((size_t)b * C * H + y) * W;  // (b, 0, y, 0) of C-ch tensors
    const float* img_row = image + crow;
    if (kStageImg || kSub || tab_stride) consumers_sync(p.consumers);  // the last row's readers are done
    if (kStageImg) load_image_row(s_img4, img_row, C, W, plane, tid, p.consumers);
    if (tab_stride) load_plane_tabs(s_tab, s_fb, tables + (size_t)b * tab_stride, N, tid, p.consumers);
    if (kStageImg || tab_stride) consumers_sync(p.consumers);
    RowSweeps sweeps(st, p, ring, N);

    // disp, pan and the subocc statistics of chunk ch's columns
    auto first = [&](int ch) {
      const RowCols<kDirect> cols{W, kDirect ? ch * chunk_cols - p.margin : 0, p.span};
      float m0[kCpt], z0[kCpt], acc[kCpt], m1[kCpt], z1[kCpt];
      float4 pc[kCpt];  // pan accumulators, channels 0..3
#pragma unroll
      for (int k = 0; k < kCpt; ++k) {
        m0[k] = m1[k] = -INFINITY;
        z0[k] = acc[k] = z1[k] = 0.f;
        pc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      // One stage: planes n0 .. n0 + g - 1 and dummies up to kGroup.  The
      // online softmaxes take the stage's maximum first, so that each
      // rescales its sums once a stage and the exponentials are independent
      // work.
      sweeps.next([&](int n0, int g, const float* rows) {
        const float* lr[kGroup];
        stage_rows(st, rows, g, lr);
        PlaneTab tb[kGroup];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) tb[i] = s_tab[n0 + i];
#pragma unroll
        for (int k = 0; k < kCpt; ++k) {
          const int x = column(p, ch, k, tid);
          if (x >= W) continue;
          if (kPlain) {
            float a[kGroup], mx = m0[k];
#pragma unroll
            for (int i = 0; i < kGroup; ++i) {
              a[i] = cols.in(lr[i], x);
              mx = fmaxf(mx, a[i]);
            }
            const float r = exp_diff(m0[k] - mx);  // 0 on the first stage
            z0[k] *= r;
            acc[k] *= r;
            m0[k] = mx;
#pragma unroll
            for (int i = 0; i < kGroup; ++i) {
              const float e = exp_diff(a[i] - mx);
              z0[k] += e;
              if (kDisp) acc[k] = fmaf(e, tb[i].lev, acc[k]);
            }
          }
          if (kShift) {
            float a[kGroup], mx = m1[k];
#pragma unroll
            for (int i = 0; i < kGroup; ++i) {
              a[i] = cols.lerp(lr[i], x + tb[i].f, tb[i].t);
              mx = fmaxf(mx, a[i]);
            }
            const float r = exp_diff(m1[k] - mx);
            z1[k] *= r;
            pc[k] = make_float4(pc[k].x * r, pc[k].y * r, pc[k].z * r, pc[k].w * r);
            m1[k] = mx;
#pragma unroll
            for (int i = 0; i < kGroup; ++i) {
              const float e = exp_diff(a[i] - mx);
              z1[k] += e;
              if (kPan) {
                const float4 v = kDirect ? lerp4_ld(img_row, x + tb[i].f, tb[i].t, C, W, plane)
                                         : lerp4_at(s_img4, x + tb[i].f, tb[i].t, W);
                pc[k] = make_float4(fmaf(e, v.x, pc[k].x), fmaf(e, v.y, pc[k].y), fmaf(e, v.z, pc[k].z),
                                    fmaf(e, v.w, pc[k].w));
              }
            }
          }
        }
      });
#pragma unroll
      for (int k = 0; k < kCpt; ++k) {
        const int x = column(p, ch, k, tid);
        if (x >= W) continue;
        if (kDisp) disp[pix + x] = acc[k] / z0[k];
        if (kPan) {
          const float inv = 1.f / z1[k];
          const float v[4] = {pc[k].x, pc[k].y, pc[k].z, pc[k].w};
#pragma unroll
          for (int c = 0; c < kMaxChannels; ++c)
            if (c < C) pan[crow + c * plane + x] = v[c] * inv;
        }
        if (kSub) {
          s_st0[st_at(x)] = make_float2(m0[k], log2f(z0[k]));
          s_st1[st_at(x)] = make_float2(m1[k], log2f(z1[k]));
        }
      }
    };

    // maskL and maskR of chunk ch's columns, from the statistics
    auto masks = [&](int ch) {
      const RowCols<kDirect> cols{W, kDirect ? ch * chunk_cols - p.margin : 0, p.span};
      float mr[kCpt], ml[kCpt];
#pragma unroll
      for (int k = 0; k < kCpt; ++k) mr[k] = ml[k] = 0.f;
      sweeps.next([&](int n0, int g, const float* rows) {
        const float* lr[kGroup];
        stage_rows(st, rows, g, lr);
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          const PlaneTab tb = s_tab[n0 + i];
          const int fb = s_fb[n0 + i];
#pragma unroll
          for (int k = 0; k < kCpt; ++k) {
            const int x = column(p, ch, k, tid);
            if (x >= W) continue;
            // maskR: S_{+s}(softmax(l)_n), the softmax taken at the source column
            const int j = x + tb.f;
            float a = 0.f, c = 0.f;
            if (j >= 0 && j < W) a = softmax_at(cols.in(lr[i], j), s_st0[st_at(j)]);
            if (j + 1 >= 0 && j + 1 < W) c = softmax_at(cols.in(lr[i], j + 1), s_st0[st_at(j + 1)]);
            mr[k] += fmaf(tb.t, c - a, a);
            // maskL: S_{-s}(Dprob_n), Dprob recomputed at the source column
            const int q = x + fb;
            a = c = 0.f;
            if (q >= 0 && q < W) a = softmax_at(cols.lerp(lr[i], q + tb.f, tb.t), s_st1[st_at(q)]);
            if (q + 1 >= 0 && q + 1 < W) c = softmax_at(cols.lerp(lr[i], q + 1 + tb.f, tb.t), s_st1[st_at(q + 1)]);
            ml[k] += fmaf(tb.tb, c - a, a);
          }
        }
      });
#pragma unroll
      for (int k = 0; k < kCpt; ++k) {
        const int x = column(p, ch, k, tid);
        if (x >= W) continue;
        mask_r[pix + x] = fminf(mr[k], 1.f);
        mask_l[pix + x] = fminf(ml[k], 1.f);
      }
    };

    // The sweeps in the order the producer streams them (sweep_chunk on the
    // direct path).  A barrier of the consumers before masks: they read
    // statistics of other columns; on the direct path also before a chunk's
    // statistics, which take the place of those of three chunks back.
    if (!kDirect || !kSub) {
      for (int ch = 0; ch < p.chunks; ++ch) first(ch);
      if (!kSub) continue;
      consumers_sync(p.consumers);
      for (int ch = 0; ch < p.chunks; ++ch) masks(ch);
    } else {
      first(0);
      for (int ch = 0; ch < p.chunks; ++ch) {
        if (ch + 1 < p.chunks) {
          consumers_sync(p.consumers);
          first(ch + 1);
        }
        consumers_sync(p.consumers);
        masks(ch);
      }
    }
  }
}

// Sweeps per image row: one per chunk for disp and pan, and a second one per
// chunk for the masks.  The staged plan first; where it does not fit, the
// direct path (two columns a thread: W > 640) with windows of `margin`.
bool fwd_plan(StagePlan& p, int N, int C, int W, bool pan, bool sub, int margin) {
  plan_columns(p, W);
  const int sweeps = p.chunks * (sub ? 2 : 1);
  const size_t img = pan ? (size_t)image_floats(W) : 0;
  // subocc: the two softmaxes' (maximum, log2-sum) a column
  if (plan_slots(p, N, sweeps, 4 * (fwd_tab_floats(N) + img + (sub ? 4 * (size_t)W : 0)))) return true;
  const int chunk_cols = p.cpt * p.consumers;
  return plan_direct(p, margin, sub, 1) &&
         plan_slots(p, N, sweeps, 4 * (fwd_tab_floats(N) + (sub ? 12 * (size_t)chunk_cols : 0)));
}

template <bool kDisp, bool kPan, bool kSub>
cudaError_t launch(const StagePlan& p, const float* logits, const float* image, float* disp, float* pan,
                   float* mask_l, float* mask_r, const float* tables, int tab_stride, int B, int N, int C, int H,
                   int W, cudaStream_t stream) {
  const int rows = B * H;
  const int bulk = W % 4 == 0 && reinterpret_cast<uintptr_t>(logits) % 16 == 0;
  if (p.direct)  // planned only with 2 columns a thread
    return launch_rows<med_fwd_kernel<kDisp, kPan, kSub, 2, true>>(p, rows, stream, logits, image, disp, pan,
                       mask_l, mask_r, tables, tab_stride, N, C, H, W, rows, bulk);
  if (p.cpt == 1)
    return launch_rows<med_fwd_kernel<kDisp, kPan, kSub, 1, false>>(p, rows, stream, logits, image, disp, pan,
                       mask_l, mask_r, tables, tab_stride, N, C, H, W, rows, bulk);
  return launch_rows<med_fwd_kernel<kDisp, kPan, kSub, 2, false>>(p, rows, stream, logits, image, disp, pan,
                     mask_l, mask_r, tables, tab_stride, N, C, H, W, rows, bulk);
}

}  // namespace

extern "C" {

// Launch the MED forward on `stream`.  `tables` is a device buffer of
// (B, 5, N) fp32 plane tables with `tab_stride` = 5*N, or one (5, N) table
// for every sample with `tab_stride` = 0.  Unrequested outputs may be null.
// `margin` is the direct path's window margin: a multiple of 4 of at least
// 2 more than the largest |floor| in the tables' shift rows (its columns are
// never read on the staged paths).  Returns cudaErrorInvalidValue, launching
// nothing, for sizes it does not take (no ring slot fits beside the
// statistics, a margin past a chunk, N outside 2..128, C outside 1..4, ...);
// else cudaGetLastError() after the launch (0 on success).
int med_fwd(const float* logits, const float* image, float* disp, float* pan, float* mask_l, float* mask_r,
            const float* tables, int tab_stride, int B, int N, int C, int H, int W, int want_disp, int want_pan,
            int want_subocc, int margin, void* stream) {
  StagePlan p;
  if (!med_sizes_ok(B, N, C, H, W, tab_stride) || !fwd_plan(p, N, C, W, want_pan, want_subocc, margin))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mode = (want_disp ? 1 : 0) | (want_pan ? 2 : 0) | (want_subocc ? 4 : 0);
#define MED_CASE(M, D, P, S)                                                                                     \
  case M:                                                                                                        \
    return (int)launch<D, P, S>(p, logits, image, disp, pan, mask_l, mask_r, tables, tab_stride, B, N, C, H, W, \
                                s);
  switch (mode) {
    MED_CASE(1, true, false, false)
    MED_CASE(2, false, true, false)
    MED_CASE(3, true, true, false)
    MED_CASE(4, false, false, true)
    MED_CASE(5, true, false, true)
    MED_CASE(6, false, true, true)
    MED_CASE(7, true, true, true)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MED_CASE
}

// The staging plan med_fwd would launch with, as kPlanFields ints into `out`
// (see med_bwd_plan).  Returns cudaErrorInvalidValue where med_fwd would refuse.
int med_fwd_plan(int N, int C, int W, int want_disp, int want_pan, int want_subocc, int margin, int* out) {
  StagePlan p;
  if (!med_sizes_ok(1, N, C, 1, W, 0) || !(want_disp || want_pan || want_subocc) ||
      !fwd_plan(p, N, C, W, want_pan, want_subocc, margin))
    return (int)cudaErrorInvalidValue;
  plan_fields(p, out);
  return 0;
}

}  // extern "C"
