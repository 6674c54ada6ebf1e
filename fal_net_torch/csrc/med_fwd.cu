// MED forward kernel for Hopper (sm_90a).
//
// Replaces fal_net_tpu/ops/med_pallas.py::_fwd_kernel, the Pallas TPU
// kernel of the MED (Mirrored Exponential Disparity) head.  It computes
// what that kernel computes, not how: the TPU version stages an
// (N, 8, W) fp32 volume in VMEM per 8-row tile over a sequential grid;
// here one block owns one image row and nothing is staged but the image
// row and per-column softmax statistics.
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
// What bounds it on the card: memory.  At B=8, N=49, 384x1280 the logits
// volume is 770 MB; read once from device memory that is 0.23 ms at
// 3.35 TB/s, while the arithmetic is ~15 flops per logit.  The design
// keeps every other read in cache:
//   * grid (H, B), 256 threads striding over the columns of one row; a
//     block walks all N planes for 256 neighbouring columns at a time;
//   * the logits are NOT staged in shared memory (one row at N=49,
//     W=1280 is 245 KB, above the 227 KB a block may use).  The shifted
//     reads l_n[x+f_n] and l_n[x+f_n+1] are the same uniform offset for
//     every thread of a warp, so they are coalesced, and they touch lines
//     that the unshifted read l_n[x] of this block brings in anyway
//     (L1/L2 hits);
//   * the image row (C*W*4 bytes, 15 KB at C=3, W=1280) is in shared
//     memory;
//   * disp and pan are one pass per column with online softmaxes: one
//     over l_n[x] for disp, one over the shifted logit carrying the C pan
//     accumulators, rescaled by exp(m_old - m_new);
//   * the masks read softmax statistics at OTHER columns, so subocc mode
//     first stores per-column (max, 1/sum) of both softmaxes in shared
//     memory (16*W bytes), syncs, then sums the shifted probabilities.
// Plane tables (level, forward and backward floor/frac; 5*N fp32) are a
// small device buffer with one table per sample, or one for the whole
// batch (stride 0).  Each block copies its sample's floors and fractions
// to shared memory; the level is read in place (a warp-uniform load that
// hits L1), which measured faster than a shared-memory level in the
// disp-only loop (0.31 vs 0.70 ms at B=8, N=49, 384x1280 on an H100).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPlanes = 128;
constexpr int kMaxChannels = 4;

// Read v[j] with zero padding outside [0, W).
__device__ __forceinline__ float read_pad(const float* __restrict__ v, int j, int W) {
  return (j >= 0 && j < W) ? __ldg(v + j) : 0.f;
}

__device__ __forceinline__ float shifted_logit(const float* __restrict__ row, int x, int f,
                                               float t, int W) {
  return (1.f - t) * read_pad(row, x + f, W) + t * read_pad(row, x + f + 1, W);
}

template <bool kDisp, bool kPan, bool kSub>
__global__ void __launch_bounds__(kThreads)
med_fwd_kernel(const float* __restrict__ logits,  // (B, N, H, W)
               const float* __restrict__ image,   // (B, C, H, W)
               float* __restrict__ disp,          // (B, 1, H, W)
               float* __restrict__ pan,           // (B, C, H, W)
               float* __restrict__ mask_l,        // (B, 1, H, W)
               float* __restrict__ mask_r,        // (B, 1, H, W)
               const float* __restrict__ tables,  // (B or 1, 5, N)
               int tab_stride, int N, int C, int H, int W) {
  constexpr bool kPlain = kDisp || kSub;   // needs softmax(l)
  constexpr bool kShift = kPan || kSub;    // needs softmax(S l)
  extern __shared__ float smem[];
  // layout: [tfw N][tbw N][ffw N (int)][fbw N (int)]
  //         [img C*W][m0 W][inv_z0 W][m1 W][inv_z1 W]
  float* s_tfw = smem;
  float* s_tbw = s_tfw + N;
  int* s_ffw = reinterpret_cast<int*>(s_tbw + N);
  int* s_fbw = s_ffw + N;
  float* s_img = reinterpret_cast<float*>(s_fbw + N);
  float* s_m0 = s_img + (kPan ? C * W : 0);
  float* s_iz0 = s_m0 + W;
  float* s_m1 = s_iz0 + W;
  float* s_iz1 = s_m1 + W;

  const int y = blockIdx.x;
  const int b = blockIdx.y;
  const size_t plane = (size_t)H * W;
  const float* lrow = logits + ((size_t)b * N * H + y) * W;  // plane 0 of row y
  const size_t pix = ((size_t)b * H + y) * W;                // (b, 0, y, 0) of 1-ch outputs

  // Table rows: level, fwd floor, fwd frac, bwd floor, bwd frac.  The
  // floors are whole numbers stored in fp32 (exact: |floor| <= W+1).
  const float* tab = tables + (size_t)b * tab_stride;
  const float* lev = tab;
  for (int n = threadIdx.x; n < N; n += kThreads) {
    s_ffw[n] = (int)__ldg(tab + N + n);
    s_tfw[n] = __ldg(tab + 2 * N + n);
    s_fbw[n] = (int)__ldg(tab + 3 * N + n);
    s_tbw[n] = __ldg(tab + 4 * N + n);
  }
  if (kPan) {
    const float* irow = image + ((size_t)b * C * H + y) * W;
    for (int i = threadIdx.x; i < C * W; i += kThreads) {
      const int c = i / W, x = i - c * W;
      s_img[i] = __ldg(irow + c * plane + x);
    }
  }
  __syncthreads();

  for (int x = threadIdx.x; x < W; x += kThreads) {
    float m0 = -INFINITY, z0 = 0.f, acc = 0.f;
    float m1 = -INFINITY, z1 = 0.f;
    float p[kMaxChannels] = {0.f, 0.f, 0.f, 0.f};
    for (int n = 0; n < N; ++n) {
      const float* row = lrow + n * plane;
      if (kPlain) {
        const float l = __ldg(row + x);
        if (l > m0) {
          const float r = expf(m0 - l);
          z0 = z0 * r + 1.f;
          acc = acc * r + __ldg(lev + n);
          m0 = l;
        } else {
          const float e = expf(l - m0);
          z0 += e;
          acc += __ldg(lev + n) * e;
        }
      }
      if (kShift) {
        const int f = s_ffw[n];
        const float t = s_tfw[n];
        const float sl = shifted_logit(row, x, f, t, W);
        float r = 1.f, e = 1.f;  // rescale of the old sums, weight of this plane
        if (sl > m1) {
          r = expf(m1 - sl);
          m1 = sl;
        } else {
          e = expf(sl - m1);
        }
        z1 = z1 * r + e;
        if (kPan) {
#pragma unroll
          for (int c = 0; c < kMaxChannels; ++c) {
            if (c < C) {
              const float* ic = s_img + c * W;
              const int j = x + f;
              const float v0 = (j >= 0 && j < W) ? ic[j] : 0.f;
              const float v1 = (j + 1 >= 0 && j + 1 < W) ? ic[j + 1] : 0.f;
              p[c] = p[c] * r + e * ((1.f - t) * v0 + t * v1);
            }
          }
        }
      }
    }
    if (kDisp) disp[pix + x] = acc / z0;
    if (kPan) {
      const float inv = 1.f / z1;
      float* prow = pan + ((size_t)b * C * H + y) * W;
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c)
        if (c < C) prow[c * plane + x] = p[c] * inv;
    }
    if (kSub) {
      s_m0[x] = m0;
      s_iz0[x] = 1.f / z0;
      s_m1[x] = m1;
      s_iz1[x] = 1.f / z1;
    }
  }

  if (!kSub) return;
  __syncthreads();

  for (int x = threadIdx.x; x < W; x += kThreads) {
    float mr = 0.f, ml = 0.f;
    for (int n = 0; n < N; ++n) {
      const float* row = lrow + n * plane;
      const int f = s_ffw[n];
      const float t = s_tfw[n];
      // maskR: S_{+s}(softmax(l)_n), the softmax taken at the source column
      {
        const int j = x + f;
        float a = 0.f, c = 0.f;
        if (j >= 0 && j < W) a = expf(__ldg(row + j) - s_m0[j]) * s_iz0[j];
        if (j + 1 >= 0 && j + 1 < W) c = expf(__ldg(row + j + 1) - s_m0[j + 1]) * s_iz0[j + 1];
        mr += (1.f - t) * a + t * c;
      }
      // maskL: S_{-s}(Dprob_n), Dprob recomputed at the source column
      {
        const int k = x + s_fbw[n];
        const float tb = s_tbw[n];
        float a = 0.f, c = 0.f;
        if (k >= 0 && k < W)
          a = expf(shifted_logit(row, k, f, t, W) - s_m1[k]) * s_iz1[k];
        if (k + 1 >= 0 && k + 1 < W)
          c = expf(shifted_logit(row, k + 1, f, t, W) - s_m1[k + 1]) * s_iz1[k + 1];
        ml += (1.f - tb) * a + tb * c;
      }
    }
    mask_r[pix + x] = fminf(mr, 1.f);
    mask_l[pix + x] = fminf(ml, 1.f);
  }
}

template <bool kDisp, bool kPan, bool kSub>
cudaError_t launch(const float* logits, const float* image, float* disp, float* pan,
                   float* mask_l, float* mask_r, const float* tables, int tab_stride, int B,
                   int N, int C, int H, int W, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (4 * (size_t)N + (kPan ? (size_t)C * W : 0) + (kSub ? 4 * (size_t)W : 0));
  auto kernel = med_fwd_kernel<kDisp, kPan, kSub>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(H, B);
  kernel<<<grid, kThreads, smem, stream>>>(logits, image, disp, pan, mask_l, mask_r, tables,
                                           tab_stride, N, C, H, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the MED forward on `stream`.  `tables` is a device buffer of
// (B, 5, N) fp32 plane tables with `tab_stride` = 5*N, or one (5, N) table
// for every sample with `tab_stride` = 0.  Unrequested outputs may be null.
// Returns cudaGetLastError() after the launch (0 on success).
int med_fwd(const float* logits, const float* image, float* disp, float* pan, float* mask_l,
            float* mask_r, const float* tables, int tab_stride, int B, int N, int C, int H, int W,
            int want_disp, int want_pan, int want_subocc, void* stream) {
  if (N < 2 || N > kMaxPlanes || C < 1 || C > kMaxChannels || B < 1 || H < 1 || W < 1 ||
      (tab_stride != 0 && tab_stride != 5 * N))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mode = (want_disp ? 1 : 0) | (want_pan ? 2 : 0) | (want_subocc ? 4 : 0);
#define MED_CASE(M, D, P, S)                                                             \
  case M:                                                                                \
    return (int)launch<D, P, S>(logits, image, disp, pan, mask_l, mask_r, tables, tab_stride, \
                                B, N, C, H, W, s);
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

}  // extern "C"
