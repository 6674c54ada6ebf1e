// MED backward kernel for Hopper (sm_90a).
//
// Replaces fal_net_tpu/ops/med_pallas.py::_bwd_kernel, the hand-derived VJP
// of the MED head.  It computes what that kernel computes, not how: the TPU
// version recomputes an (N, 8, W) Dprob volume in VMEM per 8-row tile; here
// one block owns one image row and keeps only per-column statistics.
//
// With S_n the lerp gather of plane n (f = floor(s_n), t = s_n - f, zero
// outside [0, W)), sm0 = softmax_n(l), D = softmax_n(S_n l_n) and the masks
// stop-gradient, the cotangents of disp and pan give (all math fp32):
//   g_l_n(x)   = sm0_n(x) (d_n - disp(x)) g_disp(x)
//              + (1-t) g_shift_n(x-f) + t g_shift_n(x-f-1)        (S^T)
//   g_shift_n  = q_n - D_n sum_m q_m,  q_n = D_n gD_n,
//   gD_n(y)    = sum_c S_n(img_c)(y) g_pan_c(y)
//   g_img_c(x) = sum_n (1-t) (D_n g_pan_c)(x-f) + t (D_n g_pan_c)(x-f-1)
// S^T reads zero outside [0, W).  Its shift is the FORWARD table's (f, t):
// the backward rows of the table serve the forward kernel's maskL only.
//
// What bounds it on the card: memory.  At B=8, N=49, 192x640 it must read
// the logits (193 MB) and write g_logits (193 MB); everything else is a few
// MB, so ~0.12 ms at 3.35 TB/s, against ~60 flops per logit.  The design:
//   * grid (H, B), 256 threads striding over the columns of one row;
//   * S^T reads D_n and sum_m q_m at OTHER columns, so pass 1 puts per-column
//     statistics in shared memory: (max, 1/sum) of the shifted-logit
//     softmax, sum_m q_m, and (max, 1/sum, disp) of the plain softmax, with
//     the image row and the g_pan row (6W + 2CW floats, 31 KB at W=640, C=3);
//   * after a __syncthreads(), pass 2 writes each g_l_n(x) once.  The
//     columns it reads are x-f and x-f-1, where the shifted logit and the
//     shifted image read back at x-1, x, x+1: the logits are read again at
//     the block's own columns (L1/L2 hits), and the image values at x-1..x+1
//     sit in registers across the plane loop.  S^T is a gather, so there
//     are no atomics and the result is deterministic.
// Plane tables are K1's device buffer: (B or 1, 5, N) fp32 rows level,
// fwd floor, fwd frac, bwd floor, bwd frac, with a per-sample stride.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPlanes = 128;
constexpr int kMaxChannels = 4;

__device__ __forceinline__ float read_pad(const float* __restrict__ v, int j, int W) {
  return (j >= 0 && j < W) ? __ldg(v + j) : 0.f;
}

__device__ __forceinline__ float shared_pad(const float* v, int j, int W) {
  return (j >= 0 && j < W) ? v[j] : 0.f;
}

template <bool kDisp, bool kPan, bool kImg>
__global__ void __launch_bounds__(kThreads)
med_bwd_kernel(const float* __restrict__ logits,  // (B, N, H, W)
               const float* __restrict__ image,   // (B, C, H, W)
               const float* __restrict__ g_disp,  // (B, 1, H, W)
               const float* __restrict__ g_pan,   // (B, C, H, W)
               float* __restrict__ g_logits,      // (B, N, H, W)
               float* __restrict__ g_image,       // (B, C, H, W)
               const float* __restrict__ tables,  // (B or 1, 5, N)
               int tab_stride, int N, int C, int H, int W) {
  extern __shared__ float smem[];
  // layout: [t N][f N (int)] then, for disp, [m0 W][iz0 W][disp W],
  //         then, for pan, [m1 W][iz1 W][sq W][img C*W][gpan C*W]
  float* s_t = smem;
  int* s_f = reinterpret_cast<int*>(s_t + N);
  float* s_m0 = reinterpret_cast<float*>(s_f + N);
  float* s_iz0 = s_m0 + W;
  float* s_disp = s_iz0 + W;
  float* s_m1 = s_m0 + (kDisp ? 3 * W : 0);
  float* s_iz1 = s_m1 + W;
  float* s_sq = s_iz1 + W;
  float* s_img = s_sq + W;
  float* s_gp = s_img + C * W;

  const int y = blockIdx.x;
  const int b = blockIdx.y;
  const size_t plane = (size_t)H * W;
  const size_t row0 = ((size_t)b * N * H + y) * W;  // plane 0 of row y
  const float* lrow = logits + row0;
  const size_t pix = ((size_t)b * H + y) * W;       // (b, 0, y, 0) of 1-ch tensors
  const size_t crow = ((size_t)b * C * H + y) * W;  // (b, 0, y, 0) of C-ch tensors

  const float* tab = tables + (size_t)b * tab_stride;
  const float* lev = tab;
  for (int n = threadIdx.x; n < N; n += kThreads) {
    s_f[n] = (int)__ldg(tab + N + n);
    s_t[n] = __ldg(tab + 2 * N + n);
  }
  if (kPan) {
    for (int i = threadIdx.x; i < C * W; i += kThreads) {
      const int c = i / W, x = i - c * W;
      s_img[i] = __ldg(image + crow + c * plane + x);
      s_gp[i] = __ldg(g_pan + crow + c * plane + x);
    }
  }
  __syncthreads();

  // Pass 1: per-column statistics.
  for (int x = threadIdx.x; x < W; x += kThreads) {
    float m0 = -INFINITY, z0 = 0.f, acc = 0.f;
    float m1 = -INFINITY, z1 = 0.f, aq = 0.f;
    float gp[kMaxChannels] = {0.f, 0.f, 0.f, 0.f};
    if (kPan) {
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c)
        if (c < C) gp[c] = s_gp[c * W + x];
    }
    for (int n = 0; n < N; ++n) {
      const float* row = lrow + n * plane;
      if (kDisp) {
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
      if (kPan) {
        const int f = s_f[n];
        const float t = s_t[n];
        const int j = x + f;
        const float sl = (1.f - t) * read_pad(row, j, W) + t * read_pad(row, j + 1, W);
        float r = 1.f, e = 1.f;  // rescale of the old sums, weight of this plane
        if (sl > m1) {
          r = expf(m1 - sl);
          m1 = sl;
        } else {
          e = expf(sl - m1);
        }
        float gd = 0.f;
#pragma unroll
        for (int c = 0; c < kMaxChannels; ++c) {
          if (c < C) {
            const float* ic = s_img + c * W;
            gd += ((1.f - t) * shared_pad(ic, j, W) + t * shared_pad(ic, j + 1, W)) * gp[c];
          }
        }
        z1 = z1 * r + e;
        aq = aq * r + e * gd;
      }
    }
    if (kDisp) {
      s_m0[x] = m0;
      s_iz0[x] = 1.f / z0;
      s_disp[x] = acc / z0;
    }
    if (kPan) {
      s_m1[x] = m1;
      s_iz1[x] = 1.f / z1;
      s_sq[x] = aq / z1;
    }
  }
  __syncthreads();

  // Pass 2: g_l_n(x) for every plane, and g_img(x).
  for (int x = threadIdx.x; x < W; x += kThreads) {
    float gd = 0.f, m0 = 0.f, iz0 = 0.f, disp = 0.f;
    if (kDisp) {
      gd = __ldg(g_disp + pix + x);
      m0 = s_m0[x];
      iz0 = s_iz0[x];
      disp = s_disp[x];
    }
    // image at x-1, x, x+1 (zero outside the row), the same for every plane
    float im[kMaxChannels][3] = {};
    float gi[kMaxChannels] = {0.f, 0.f, 0.f, 0.f};
    if (kPan) {
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c) {
        if (c < C) {
          const float* ic = s_img + c * W;
          im[c][0] = shared_pad(ic, x - 1, W);
          im[c][1] = ic[x];
          im[c][2] = shared_pad(ic, x + 1, W);
        }
      }
    }
    for (int n = 0; n < N; ++n) {
      const float* row = lrow + n * plane;
      const float lx = __ldg(row + x);
      float g = 0.f;
      if (kDisp) {
        const float sm = expf(lx - m0) * iz0;
        g = sm * (__ldg(lev + n) - disp) * gd;
      }
      if (kPan) {
        const int f = s_f[n];
        const float t = s_t[n];
        // y0 = x - f takes weight 1-t; its shifted reads land on x and x+1
        const int y0 = x - f;
        if (y0 >= 0 && y0 < W) {
          const float sl = (1.f - t) * lx + t * read_pad(row, x + 1, W);
          const float d = expf(sl - s_m1[y0]) * s_iz1[y0];
          float gdp = 0.f;
#pragma unroll
          for (int c = 0; c < kMaxChannels; ++c) {
            if (c < C) {
              const float gpc = s_gp[c * W + y0];
              gdp += ((1.f - t) * im[c][1] + t * im[c][2]) * gpc;
              if (kImg) gi[c] += (1.f - t) * d * gpc;
            }
          }
          g += (1.f - t) * d * (gdp - s_sq[y0]);
        }
        // y1 = x - f - 1 takes weight t; its shifted reads land on x-1 and x
        const int y1 = y0 - 1;
        if (y1 >= 0 && y1 < W) {
          const float sl = (1.f - t) * read_pad(row, x - 1, W) + t * lx;
          const float d = expf(sl - s_m1[y1]) * s_iz1[y1];
          float gdp = 0.f;
#pragma unroll
          for (int c = 0; c < kMaxChannels; ++c) {
            if (c < C) {
              const float gpc = s_gp[c * W + y1];
              gdp += ((1.f - t) * im[c][0] + t * im[c][1]) * gpc;
              if (kImg) gi[c] += t * d * gpc;
            }
          }
          g += t * d * (gdp - s_sq[y1]);
        }
      }
      g_logits[row0 + n * plane + x] = g;
    }
    if (kImg) {
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c)
        if (c < C) g_image[crow + c * plane + x] = gi[c];
    }
  }
}

template <bool kDisp, bool kPan, bool kImg>
cudaError_t launch(const float* logits, const float* image, const float* g_disp,
                   const float* g_pan, float* g_logits, float* g_image, const float* tables,
                   int tab_stride, int B, int N, int C, int H, int W, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)N + (kDisp ? 3 * (size_t)W : 0) +
                                       (kPan ? (3 + 2 * (size_t)C) * W : 0));
  auto kernel = med_bwd_kernel<kDisp, kPan, kImg>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(H, B);
  kernel<<<grid, kThreads, smem, stream>>>(logits, image, g_disp, g_pan, g_logits, g_image,
                                           tables, tab_stride, N, C, H, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the MED backward on `stream`.  `tables` as for med_fwd.  g_disp is
// read only with want_disp, image and g_pan only with want_pan, and g_image
// is written only with want_gimg (which needs want_pan); unused pointers may
// be null.  Every element of g_logits is written.  Returns
// cudaGetLastError() after the launch (0 on success).
int med_bwd(const float* logits, const float* image, const float* g_disp, const float* g_pan,
            float* g_logits, float* g_image, const float* tables, int tab_stride, int B, int N,
            int C, int H, int W, int want_disp, int want_pan, int want_gimg, void* stream) {
  if (N < 2 || N > kMaxPlanes || C < 1 || C > kMaxChannels || B < 1 || H < 1 || W < 1 ||
      (tab_stride != 0 && tab_stride != 5 * N) || (want_gimg && !want_pan))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mode = (want_disp ? 1 : 0) | (want_pan ? 2 : 0) | (want_gimg ? 4 : 0);
#define MED_CASE(M, D, P, I)                                                                 \
  case M:                                                                                    \
    return (int)launch<D, P, I>(logits, image, g_disp, g_pan, g_logits, g_image, tables,     \
                                tab_stride, B, N, C, H, W, s);
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

}  // extern "C"
