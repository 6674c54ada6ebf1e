// Windowed roll (K5) for Hopper (sm_90a).
//
// Replaces scripts/probe_roll_bug.py::make_fn.<locals>.kernel, the TPU
// probe of a dynamic lane roll (the core of the MED kernels' shift,
// fal_net_tpu/ops/med_pallas.py::_shift_sample).  Each row of x (H, W) is
// placed at columns [left, left + W) of a zero row of wp columns, rolled
// left by f, and the window [left, left + W) is read back:
//   out[h, j] = buf[h, (left + j + f) mod wp].
// f is read from device memory, as the TPU kernel reads it from SMEM, and
// wraps for any value, negative or past the row.
//
// What bounds it on the card: nothing but launch latency at the probe's
// (8, 128) size; the bytes (x in, out back) are 8 KB.  One block per row
// stages the zero-padded row in shared memory (wp floats) and gathers from
// it, so every index is a shared-memory read and no read leaves the row.
// So the launch path is the design: the op fal_net_torch::roll_window
// (torch_ops.cpp) calls this entry from C++, and the entry makes no driver
// call but the launch once a device's shared-memory limit is set.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmemBytes = 232448;  // dynamic shared memory one Hopper block may use
constexpr size_t kDefaultSmemBytes = 48 * 1024;  // what a launch may use without the attribute

__global__ void __launch_bounds__(kThreads)
    roll_window_kernel(const float* __restrict__ x, const int* __restrict__ f,
                       float* __restrict__ out, int W, int wp, int left) {
  extern __shared__ float buf[];
  const float* xr = x + (size_t)blockIdx.x * W;
  for (int i = threadIdx.x; i < wp; i += kThreads) {
    const int j = i - left;
    buf[i] = (j >= 0 && j < W) ? xr[j] : 0.f;
  }
  __syncthreads();
  int shift = f[0] % wp;  // in (-wp, wp)
  if (shift < 0) shift += wp;
  float* orow = out + (size_t)blockIdx.x * W;
  for (int j = threadIdx.x; j < W; j += kThreads) {
    int idx = left + j + shift;  // < 2 wp, since left + W <= wp
    if (idx >= wp) idx -= wp;
    orow[j] = buf[idx];
  }
}

}  // namespace

extern "C" {

// Launch K5 on `stream`: x and out (H, W) fp32, f one int32, all on the
// device.  Returns cudaErrorInvalidValue, launching nothing, unless
// 0 <= left, left + W <= wp and the row of wp floats fits a block's shared
// memory (wp <= 58112); else cudaGetLastError() after the launch (0 on
// success).  The shared-memory limit is a driver call of microseconds: it is
// set once per device, raised to the widest row asked for, and only past the
// 48 KB that every launch may use.
int roll_window(const float* x, const int* f, float* out, int H, int W, int wp, int left,
                void* stream) {
  const size_t smem = (size_t)wp * sizeof(float);
  if (H < 1 || W < 1 || left < 0 || (long long)left + W > wp || smem > kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  static size_t allowed[64];  // per device: the limit set so far
  if (smem > kDefaultSmemBytes) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    if (smem > allowed[dev]) {
      err = cudaFuncSetAttribute(roll_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      allowed[dev] = smem;
    }
  }
  roll_window_kernel<<<H, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(x, f, out, W, wp,
                                                                               left);
  return (int)cudaGetLastError();
}

}  // extern "C"
