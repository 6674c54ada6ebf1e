// MED backward kernel for Hopper (sm_90a).
//
// Replaces fal_net_tpu/ops/med_pallas.py::_bwd_kernel, the hand-derived VJP
// of the MED head.  It computes what that kernel computes, not how: the TPU
// version recomputes an (N, 8, W) Dprob volume in VMEM per 8-row tile; here
// a block stages one image row's plane rows in shared memory and keeps
// per-column statistics.
//
// With S_n the lerp gather of plane n (f = floor(s_n), t = s_n - f, zero
// outside [0, W)), sm0 = softmax_n(l), D = softmax_n(S_n l_n) and the masks
// stop-gradient, the cotangents of disp and pan give (fp32 math, but for
// disp's weights, see below):
//   g_l_n(x)   = sm0_n(x) (d_n - disp(x)) g_disp(x)
//              + (1-t) g_shift_n(x-f) + t g_shift_n(x-f-1)        (S^T)
//   g_shift_n  = q_n - D_n sum_m q_m,  q_n = D_n gD_n,
//   gD_n(y)    = sum_c S_n(img_c)(y) g_pan_c(y)
//   g_img_c(x) = sum_n (1-t) (D_n g_pan_c)(x-f) + t (D_n g_pan_c)(x-f-1)
// S^T reads zero outside [0, W).  Its shift is the FORWARD table's (f, t):
// the backward rows of the table serve the forward kernel's maskL only.
//
// What bounds it on the card: memory, in principle.  At B=8, N=49, 192x640
// it must read the logits (193 MB) and write g_logits (193 MB); everything
// else is a few MB, so ~0.12 ms at 3.35 TB/s, against ~62 fp32 operations
// and 5 exponentials per logit.  The design (staging in med_stage.cuh):
//   * S^T reads D_n and sum_m q_m at OTHER columns, so a statistics sweep
//     puts per-column (maximum, log2-sum) and sum_m q_m / sum of the
//     shifted-logit softmax in shared memory, beside the image and g_pan
//     rows (a float4 per column each); the plain softmax's (maximum,
//     log2-sum, disp) stay in the registers of the column's thread;
//   * after a barrier of the consumers, a gradient sweep writes each
//     g_l_n(x) once: per stage, every thread puts g_shift_n(y) =
//     D_n(y) (gD_n(y) - sum_m q_m(y)) of its own columns in shared memory
//     (each value serves two columns of S^T), and after a barrier gathers
//     them at x - f and x - f - 1: no atomics, deterministic;
//   * whole-row path: where the N plane rows fit beside the rest
//     (125,440 + 51,520 B at N = 49, W = 640), the gradient sweep reads the
//     logits from shared memory, so they leave device memory once, and it
//     releases a stage's slot (7 planes at N = 49) as soon as it has written
//     their g_l_n, so that the next row's first stages are copied during the
//     rest of the sweep.  Blocks are persistent over rows;
//   * ring path (W = 1280 at N = 49: a 250,880 B row): the stages stream
//     through fewer slots in both sweeps;
//   * direct path, for rows too wide to stage whole plane rows beside the
//     image and g_pan rows (32 B a column) and the statistics (at N = 49:
//     W > 4,132 with pan cotangents, > 3,856 with g_img, > 28,936 with disp
//     alone): a slot row holds one 1,280-column chunk's window, the chunk
//     and the shift margin on each side, so shared memory does not grow
//     with W; the image and g_pan rows are read from device memory, through
//     the caches, at the shifted columns.  The shifted statistics are kept
//     for three chunks (the one before, the current one and the next); the
//     sweeps go stats(0), then per chunk c stats(c + 1), the plain
//     statistics of c and its gradient, whose S^T reads statistics within a
//     margin of c.  g_shift_n is made per stage for the 1,282 columns the
//     chunk's S^T reads (x - f_n - 1 for x in the chunk, and one more);
//   * the online softmaxes take a stage's maximum first and rescale their
//     sums once a stage, with no branch.  As in K1 (med_fwd.cu), each keeps
//     its maximum m of the logits themselves and weighs a logit l by
//     e^(l - m), the difference taken in the logit domain as the plain
//     softmax takes it (exact where a weight counts; at most 0 at any finite
//     logits), and the shifted logits are lerped with the plain head's
//     rounding (lerp_logit), in the statistics sweep and in the gradient
//     sweep's recompute of D alike;
//   * disp's softmax weights, their sums and disp itself in double, from
//     double exponents: g_l_n is sm0_n (d_n - disp) g_disp, and where d_n is
//     near disp an error in disp stays whole while the term vanishes.  With
//     fp32 weights (ex2.approx, about 2^-22 relative) disp is off by up to
//     ~7e-5 at |disparity| 300, and g_l_n by as much times sm0_n g_disp,
//     past the gradient tests' atol of 1e-5; in double the error left is
//     relative (sm0_n, the fp32 difference), as the tolerance's rtol takes;
//   * columns wider than one chunk (W > 1280) recompute the plain softmax's
//     statistics in a sweep before each chunk's gradient sweep.
// On an H100 it is bound by the consumers' issue rate and shared-memory
// loads, not by device memory (PERF.md).
// Plane tables are K1's device buffer: (B or 1, 5, N) fp32 rows level,
// fwd floor, fwd frac, bwd floor, bwd frac, with a per-sample stride; a
// block copies its sample's into shared memory, floors as integers.

#include "med_stage.cuh"

namespace {

constexpr double kLog2eD = 1.4426950408889634;  // log2 e for disp's weights, in double

// 2^a in double, to 3e-10 relative, for a <= 0: a = n + f with |f| <= 1/2,
// 2^f by its Taylor series in f ln 2 to the 8th power, scaled by 2^n
// through the exponent bits.  Arguments below -1022 (the dummy row's) give
// 2^-1022, a weight of nothing.  Fewer instructions than exp2(double).
__device__ __forceinline__ double exp2_d(double a) {
  a = fmax(a, -1022.0);
  const double n = rint(a);
  const double g = (a - n) * 0.6931471805599453;
  double p = 1.0 / 40320;
  p = fma(p, g, 1.0 / 5040);
  p = fma(p, g, 1.0 / 720);
  p = fma(p, g, 1.0 / 120);
  p = fma(p, g, 1.0 / 24);
  p = fma(p, g, 1.0 / 6);
  p = fma(p, g, 0.5);
  p = fma(p, g, 1.0);
  p = fma(p, g, 1.0);
  return p * __hiloint2double(((int)n + 1023) << 20, 0);
}

// Floats of the plane tables, a multiple of 4.
__host__ __device__ inline int bwd_tab_floats(int N) { return 4 * (N + kGroup - 1); }

// Floats of a g_shift (or D) row of the direct path: the chunk's columns
// and one on each side.
__host__ __device__ inline int gs_pitch(int chunk_cols) { return (chunk_cols + 2 + 3) / 4 * 4; }

template <bool kDisp, bool kPan, bool kImg, int kCpt, bool kDirect>
__global__ void __launch_bounds__(kStageThreads, 1)
med_bwd_kernel(const float* __restrict__ logits,  // (B, N, H, W)
               const float* __restrict__ image,   // (B, C, H, W)
               const float* __restrict__ g_disp,  // (B, 1, H, W)
               const float* __restrict__ g_pan,   // (B, C, H, W)
               float* __restrict__ g_logits,      // (B, N, H, W)
               float* __restrict__ g_image,       // (B, C, H, W)
               const float* __restrict__ tables,  // (B or 1, 5, N)
               int tab_stride, int N, int C, int H, int W, int rows, int bulk, const StagePlan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* extra;
  const RowStage st = stage_init(smem_raw, p, bulk, &extra);
  // extra: [plane tables], then for pan [image row][g_pan row] (not on the
  // direct path) [(maximum, log2-sum) W][sq W, to a multiple of 4][g_shift:
  // G rows of pitch P][D: G rows, for g_img]; the rows as the staged ones,
  // column 0 at offset 4 and zero guards.  On the direct path the
  // statistics are kept for three chunks' columns (column y at y mod their
  // count) and the g_shift and D rows are of gs_pitch, column u standing for
  // x - f_n - 1 + u, x the chunk's first.
  const int chunk_cols = p.cpt * p.consumers, st_cols = kDirect ? 3 * chunk_cols : W;
  const int gsp = kDirect ? gs_pitch(chunk_cols) : st.P;  // g_shift and D row pitch
  PlaneTab* s_tab = reinterpret_cast<PlaneTab*>(extra);
  float4* s_img4 = reinterpret_cast<float4*>(extra + bwd_tab_floats(N)) + 1;  // column 0
  float4* s_gp4 = s_img4 + W + 2;
  float2* s_st = kDirect ? reinterpret_cast<float2*>(extra + bwd_tab_floats(N)) : reinterpret_cast<float2*>(s_gp4 + W + 1);
  float* s_sq = reinterpret_cast<float*>(s_st + st_cols);  // sum_m q_m / sum of the shifted softmax
  float* s_gs = s_sq + (st_cols + 3) / 4 * 4 + 4;
  float* s_d = s_gs + p.group * gsp;
  auto st_at = [&](int y) { return kDirect ? y % st_cols : y; };  // 0 <= y < W
  if (tab_stride == 0) load_plane_tabs(s_tab, nullptr, tables, N, threadIdx.x, blockDim.x);
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
    const size_t row0 = ((size_t)b * N * H + y) * W;  // plane 0 of row y
    const size_t pix = ((size_t)b * H + y) * W;       // (b, 0, y, 0) of 1-ch tensors
    const size_t crow = ((size_t)b * C * H + y) * W;  // (b, 0, y, 0) of C-ch tensors
    // image and g_pan at column j (zero outside [0, W)): staged, or on the
    // direct path from device memory
    auto img_lerp = [&](int j, float t) {
      if (kDirect) {
        const float4 u = ld_row4(image + crow, j, C, W, plane), v = ld_row4(image + crow, j + 1, C, W, plane);
        return make_float4(fmaf(t, v.x - u.x, u.x), fmaf(t, v.y - u.y, u.y), fmaf(t, v.z - u.z, u.z),
                           fmaf(t, v.w - u.w, u.w));
      }
      return lerp4_at(s_img4, j, t, W);
    };
    auto gp_at = [&](int j) { return kDirect ? ld_row4(g_pan + crow, j, C, W, plane) : s_gp4[min(max(j, -1), W)]; };
    auto gp_in = [&](int x) { return kDirect ? ld_row4(g_pan + crow, x, C, W, plane) : s_gp4[x]; };  // 0 <= x < W
    if (kPan || tab_stride) {
      consumers_sync(p.consumers);  // the last row's readers are done
      if (kPan && !kDirect) {
        load_image_row(s_img4, image + crow, C, W, plane, tid, p.consumers);
        load_image_row(s_gp4, g_pan + crow, C, W, plane, tid, p.consumers);
      }
      if (tab_stride) load_plane_tabs(s_tab, nullptr, tables + (size_t)b * tab_stride, N, tid, p.consumers);
      consumers_sync(p.consumers);
    }
    RowSweeps sweeps(st, p, ring, N);
    // the plain softmax of the columns of the current chunk: maximum, log2-sum, disp
    float max0[kCpt];
    double lz0[kCpt], disp[kCpt];

    // Statistics of chunk c: the plain softmax into registers (do_disp), the
    // shifted one into shared memory (do_pan).
    auto stats = [&](int ch, bool do_disp, bool do_pan) {
      const RowCols<kDirect> cols{W, kDirect ? ch * chunk_cols - p.margin : 0, p.span};
      float m0[kCpt], m1[kCpt], z1[kCpt], aq[kCpt];
      double z0[kCpt], a0[kCpt];  // disp's sums, in double (see the header)
      float4 gp[kCpt];  // g_pan at the column, zero past C
#pragma unroll
      for (int k = 0; k < kCpt; ++k) {
        const int x = column(p, ch, k, tid);
        m0[k] = m1[k] = -INFINITY;
        z0[k] = a0[k] = z1[k] = aq[k] = 0.f;
        gp[k] = (kPan && x < W) ? gp_in(x) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      // One stage: planes n0 .. n0 + g - 1 and dummies up to kGroup; each
      // online softmax takes the stage's maximum first and rescales its sums
      // once a stage.
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
          if (kDisp && do_disp) {
            float l[kGroup], mx = m0[k];
#pragma unroll
            for (int i = 0; i < kGroup; ++i) {
              l[i] = cols.in(lr[i], x);
              mx = fmaxf(mx, l[i]);
            }
            const double r = exp2_d(((double)m0[k] - mx) * kLog2eD);  // ~0 on the first stage
            z0[k] *= r;
            a0[k] *= r;
            m0[k] = mx;
#pragma unroll
            for (int i = 0; i < kGroup; ++i) {
              const double e = exp2_d(((double)l[i] - mx) * kLog2eD);
              z0[k] += e;
              a0[k] = fma(e, (double)tb[i].lev, a0[k]);
            }
          }
          if (kPan && do_pan) {
            float a[kGroup], gd[kGroup], mx = m1[k];
#pragma unroll
            for (int i = 0; i < kGroup; ++i) {
              const int j = x + tb[i].f;
              a[i] = cols.lerp(lr[i], j, tb[i].t);
              mx = fmaxf(mx, a[i]);
              const float4 v = img_lerp(j, tb[i].t);
              gd[i] = fmaf(v.x, gp[k].x, fmaf(v.y, gp[k].y, fmaf(v.z, gp[k].z, v.w * gp[k].w)));
            }
            const float r = exp_diff(m1[k] - mx);
            z1[k] *= r;
            aq[k] *= r;
            m1[k] = mx;
#pragma unroll
            for (int i = 0; i < kGroup; ++i) {
              const float e = exp_diff(a[i] - mx);
              z1[k] += e;
              aq[k] = fmaf(e, gd[i], aq[k]);
            }
          }
        }
      });
#pragma unroll
      for (int k = 0; k < kCpt; ++k) {
        const int x = column(p, ch, k, tid);
        if (x >= W) continue;
        if (kDisp && do_disp) {
          max0[k] = m0[k];
          lz0[k] = log2(z0[k]);
          disp[k] = a0[k] / z0[k];
        }
        if (kPan && do_pan) {
          s_st[st_at(x)] = make_float2(m1[k], log2f(z1[k]));
          s_sq[st_at(x)] = aq[k] / z1[k];
        }
      }
    };

    // g_l_n for the columns of chunk c, and their g_img.  S^T reads
    // g_shift_n = D_n (gD_n - sum_m q_m) at other columns, and each of its
    // values serves two: so per stage every thread first puts g_shift_n(y)
    // of its columns of the whole row (and D_n(y) for g_img) in shared
    // memory, and after a barrier gathers them at x - f and x - f - 1.
    auto grad = [&](int ch) {
      const RowCols<kDirect> cols{W, kDirect ? ch * chunk_cols - p.margin : 0, p.span};
      const int c0 = ch * chunk_cols;
      float gd[kCpt];
      float4 gi[kCpt];
#pragma unroll
      for (int k = 0; k < kCpt; ++k) {
        const int x = column(p, ch, k, tid);
        gd[k] = (kDisp && x < W) ? __ldg(g_disp + pix + x) : 0.f;
        gi[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      sweeps.next([&](int n0, int g, const float* rows) {
        const float* lr[kGroup];
        stage_rows(st, rows, g, lr);
        PlaneTab tb[kGroup];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) tb[i] = s_tab[n0 + i];
        if (kPan && kDirect) {
          consumers_sync(p.consumers);  // the last stage's gathers are done
          // g_shift_n(y) and D_n(y) for y = c0 - f_n - 1 + u, u <= chunk_cols:
          // the columns the chunk's S^T reads; zero outside the row
          for (int i = 0; i < kGroup; ++i) {
            if (i >= g) break;
            const int y0 = c0 - tb[i].f - 1;
            for (int u = tid; u < chunk_cols + 2; u += p.consumers) {
              const int y = y0 + u;
              float gs = 0.f, d = 0.f;
              if (y >= 0 && y < W) {
                const float4 gq = gp_in(y);
                const int j = y + tb[i].f;
                d = softmax_at(cols.lerp(lr[i], j, tb[i].t), s_st[st_at(y)]);
                const float4 v = img_lerp(j, tb[i].t);
                gs = d * (fmaf(v.x, gq.x, fmaf(v.y, gq.y, fmaf(v.z, gq.z, v.w * gq.w))) - s_sq[st_at(y)]);
              }
              s_gs[i * gsp + u] = gs;
              if (kImg) s_d[i * gsp + u] = d;
            }
          }
          consumers_sync(p.consumers);
        } else if (kPan) {
          consumers_sync(p.consumers);  // the last stage's gathers are done
          for (int c2 = 0; c2 < p.chunks; ++c2) {
#pragma unroll
            for (int k = 0; k < kCpt; ++k) {
              const int y = column(p, c2, k, tid);
              if (y >= W) continue;
              const float2 sy = s_st[y];  // (maximum, log2-sum) at y
              const float sq = s_sq[y];   // sum_m q_m / sum at y
              const float4 gq = gp_in(y);
#pragma unroll
              for (int i = 0; i < kGroup; ++i) {
                if (i >= g) break;
                const int j = y + tb[i].f;
                const float d = softmax_at(lerp_at(lr[i], j, tb[i].t, W), sy);
                const float4 v = img_lerp(j, tb[i].t);
                const float gdn = fmaf(v.x, gq.x, fmaf(v.y, gq.y, fmaf(v.z, gq.z, v.w * gq.w)));
                s_gs[i * st.P + y] = d * (gdn - sq);
                if (kImg) s_d[i * st.P + y] = d;
              }
            }
          }
          consumers_sync(p.consumers);
        }
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          if (i >= g) break;
          const int n = n0 + i;
          const float t = tb[i].t;
          float* gout = g_logits + row0 + n * plane;
#pragma unroll
          for (int k = 0; k < kCpt; ++k) {
            const int x = column(p, ch, k, tid);
            if (x >= W) continue;
            float gl = 0.f;
            if (kDisp) {
              const float dd = (float)((double)tb[i].lev - disp[k]);  // d_n - disp, rounded once
              gl = ex2((float)(((double)cols.in(lr[i], x) - max0[k]) * kLog2eD - lz0[k])) * dd * gd[k];
            }
            if (kPan) {
              // S^T: y0 = x - f takes weight 1-t, y0 - 1 weight t; zero outside the row
              // (on the direct path, y0 is column u = x - c0 + 1 of the chunk's rows)
              const int y0 = x - tb[i].f, u = x - c0 + 1;
              const float* gsr = s_gs + i * gsp;
              const float* dr = s_d + i * gsp;
              const float a = kDirect ? gsr[u] : pad(gsr, y0, W), c = kDirect ? gsr[u - 1] : pad(gsr, y0 - 1, W);
              gl += fmaf(t, c - a, a);
              if (kImg) {
                const float da = (1.f - t) * (kDirect ? dr[u] : pad(dr, y0, W)),
                            dc = t * (kDirect ? dr[u - 1] : pad(dr, y0 - 1, W));
                const float4 ga = gp_at(y0), gc = gp_at(y0 - 1);
                gi[k] = make_float4(fmaf(da, ga.x, fmaf(dc, gc.x, gi[k].x)), fmaf(da, ga.y, fmaf(dc, gc.y, gi[k].y)),
                                    fmaf(da, ga.z, fmaf(dc, gc.z, gi[k].z)), fmaf(da, ga.w, fmaf(dc, gc.w, gi[k].w)));
              }
            }
            __stcs(gout + x, gl);  // streamed: not read again here
          }
        }
      });
      if (kImg) {
#pragma unroll
        for (int k = 0; k < kCpt; ++k) {
          const int x = column(p, ch, k, tid);
          const float v[4] = {gi[k].x, gi[k].y, gi[k].z, gi[k].w};
#pragma unroll
          for (int c = 0; c < kMaxChannels; ++c)
            if (c < C && x < W) g_image[crow + c * plane + x] = v[c];
        }
      }
    };

    // The sweeps of bwd_sweeps(), in that order (on the direct path, that of
    // sweep_chunk, with a barrier of the consumers before a chunk's shifted
    // statistics, which take the place of those of three chunks back).
    if (kDirect) {
      if (kPan) stats(0, false, true);
      for (int ch = 0; ch < p.chunks; ++ch) {
        if (kPan && ch + 1 < p.chunks) {
          consumers_sync(p.consumers);
          stats(ch + 1, false, true);
        }
        if (kDisp) stats(ch, true, false);
        if (kPan) consumers_sync(p.consumers);
        grad(ch);
      }
    } else if (p.chunks == 1) {
      stats(0, true, true);
      if (kPan) consumers_sync(p.consumers);  // the gradient reads statistics of other columns
      grad(0);
    } else {
      if (kPan) {
        for (int ch = 0; ch < p.chunks; ++ch) stats(ch, false, true);
        consumers_sync(p.consumers);
      }
      for (int ch = 0; ch < p.chunks; ++ch) {
        if (kDisp) stats(ch, true, false);
        grad(ch);
      }
    }
  }
}

// Sweeps per image row, as the kernel makes them: statistics, then gradient;
// with several chunks, the shifted statistics of every chunk first, then per
// chunk the plain statistics (disp) and the gradient.
int bwd_sweeps(int chunks, bool disp, bool pan) {
  if (chunks == 1) return 2;
  return (pan ? chunks : 0) + chunks * (disp ? 2 : 1);
}

bool bwd_plan(StagePlan& p, int N, int C, int W, bool disp, bool pan, bool img, int margin) {
  plan_columns(p, W);
  // pan: image and g_pan rows, (maximum, log2-sum) and sq, and per stage row
  // a g_shift row (and a D row)
  const size_t per_row = pan ? 4 * (size_t)row_pitch(W) * (img ? 2 : 1) : 0;
  const size_t stats = 2 * (size_t)W + (W + 3) / 4 * 4;
  const size_t extra = plane_tab_bytes(N) + (pan ? 4 * (2 * (size_t)image_floats(W) + stats) : 0);
  if (plan_slots(p, N, bwd_sweeps(p.chunks, disp, pan), extra, per_row)) return true;
  // the direct path: per chunk the shifted statistics of the next one
  // (pan), then its plain statistics (disp) and its gradient; the shifted
  // statistics of three chunks, the g_shift and D rows of gs_pitch, their
  // offset of 4
  const int chunk_cols = p.cpt * p.consumers, own = disp ? 2 : 1;
  if (!plan_direct(p, margin, pan, own)) return false;
  const size_t d_per_row = pan ? 4 * (size_t)gs_pitch(chunk_cols) * (img ? 2 : 1) : 0;
  const size_t d_extra = plane_tab_bytes(N) + (pan ? 4 * (9 * (size_t)chunk_cols + 4) : 0);
  return plan_slots(p, N, p.chunks * ((pan ? 1 : 0) + own), d_extra, d_per_row);
}

template <bool kDisp, bool kPan, bool kImg>
cudaError_t launch(const StagePlan& p, const float* logits, const float* image, const float* g_disp,
                   const float* g_pan, float* g_logits, float* g_image, const float* tables, int tab_stride, int B,
                   int N, int C, int H, int W, cudaStream_t stream) {
  const int rows = B * H;
  const int bulk = W % 4 == 0 && reinterpret_cast<uintptr_t>(logits) % 16 == 0;
  if (p.direct)  // planned only with 2 columns a thread
    return launch_rows<med_bwd_kernel<kDisp, kPan, kImg, 2, true>>(p, rows, stream, logits, image, g_disp, g_pan,
                       g_logits, g_image, tables, tab_stride, N, C, H, W, rows, bulk);
  if (p.cpt == 1)
    return launch_rows<med_bwd_kernel<kDisp, kPan, kImg, 1, false>>(p, rows, stream, logits, image, g_disp, g_pan,
                       g_logits, g_image, tables, tab_stride, N, C, H, W, rows, bulk);
  return launch_rows<med_bwd_kernel<kDisp, kPan, kImg, 2, false>>(p, rows, stream, logits, image, g_disp, g_pan,
                     g_logits, g_image, tables, tab_stride, N, C, H, W, rows, bulk);
}

}  // namespace

extern "C" {

// Launch the MED backward on `stream`.  `tables` and `margin` as for med_fwd.  g_disp is
// read only with want_disp, image and g_pan only with want_pan, and g_image
// is written only with want_gimg (which needs want_pan); unused pointers may
// be null.  Every element of g_logits is written.  Returns
// cudaErrorInvalidValue, launching nothing, for sizes it does not take (no
// ring slot fits beside the statistics, N outside 2..128, C outside 1..4,
// ...); else cudaGetLastError() after the launch (0 on success).
int med_bwd(const float* logits, const float* image, const float* g_disp, const float* g_pan, float* g_logits,
            float* g_image, const float* tables, int tab_stride, int B, int N, int C, int H, int W, int want_disp,
            int want_pan, int want_gimg, int margin, void* stream) {
  StagePlan p;
  if (!med_sizes_ok(B, N, C, H, W, tab_stride) || (want_gimg && !want_pan) || !(want_disp || want_pan) ||
      !bwd_plan(p, N, C, W, want_disp, want_pan, want_gimg, margin))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mode = (want_disp ? 1 : 0) | (want_pan ? 2 : 0) | (want_gimg ? 4 : 0);
#define MED_CASE(M, D, P, I)                                                                              \
  case M:                                                                                                 \
    return (int)launch<D, P, I>(p, logits, image, g_disp, g_pan, g_logits, g_image, tables, tab_stride, B, \
                                N, C, H, W, s);
  switch (mode) {
    MED_CASE(1, true, false, false)
    MED_CASE(2, false, true, false)
    MED_CASE(3, true, true, false)
    MED_CASE(6, false, true, true)
    MED_CASE(7, true, true, true)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MED_CASE
}

// The staging plan med_bwd would launch with, as kPlanFields ints into
// `out`: StagePlan's fields in order up to `margin`.  Returns
// cudaErrorInvalidValue where med_bwd would refuse.
int med_bwd_plan(int N, int C, int W, int want_disp, int want_pan, int want_gimg, int margin, int* out) {
  StagePlan p;
  if (!med_sizes_ok(1, N, C, 1, W, 0) || !(want_disp || want_pan) || (want_gimg && !want_pan) ||
      !bwd_plan(p, N, C, W, want_disp, want_pan, want_gimg, margin))
    return (int)cudaErrorInvalidValue;
  plan_fields(p, out);
  return 0;
}

}  // extern "C"
