// The CUDA impls of the port's PyTorch ops: fal_net_torch::med_fwd (K1),
// med_bwd (K2), conv3x3 (K3 and K4) and roll_window (K5).
//
// fal_net_torch/ops/library.py defines the ops' schemas, their fake (meta)
// impls, their plain CPU kernels and med_fwd's autograd formula; this file
// registers what runs for CUDA tensors.  Each impl checks its inputs, sets
// the device, allocates its outputs, works out the MED kernels' shift margin,
// calls the kernel's C entry (med_fwd.cu, med_bwd.cu, conv3x3_wgmma.cu,
// roll_probe.cu) on PyTorch's current stream, throws on a nonzero return and
// counts the launch.  So a call goes from the dispatcher to the kernel
// launch without Python, and torch.export records the op in its graph.
//
// Host-only C++, compiled by the host compiler against PyTorch's headers and
// linked with the nvcc objects into one library (ops/_build.py).  It includes
// torch/library.h and the ATen/c10 headers it needs, never torch/extension.h,
// whose build takes minutes.
//
// An unrequested output comes back as an empty tensor (a schema cannot
// return None); the Python wrappers map it back to None.  A size the kernel
// refuses raises ValueError in Python (TORCH_CHECK_VALUE), a CUDA error
// RuntimeError.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <algorithm>
#include <atomic>
#include <optional>
#include <tuple>

extern "C" {
int med_fwd(const float* logits, const float* image, float* disp, float* pan, float* mask_l, float* mask_r,
            const float* tables, int tab_stride, int B, int N, int C, int H, int W, int want_disp, int want_pan,
            int want_subocc, int margin, void* stream);
int med_bwd(const float* logits, const float* image, const float* g_disp, const float* g_pan, float* g_logits,
            float* g_image, const float* tables, int tab_stride, int B, int N, int C, int H, int W, int want_disp,
            int want_pan, int want_gimg, int margin, void* stream);
int med_fwd_plan(int N, int C, int W, int want_disp, int want_pan, int want_subocc, int margin, int* out);
int med_bwd_plan(int N, int C, int W, int want_disp, int want_pan, int want_gimg, int margin, int* out);
int conv3x3_wgmma(const float* x, const float* w2, float* out, int B, int Cin, int H, int W, int Cout,
                  void* stream);
int roll_window(const float* x, const int* f, float* out, int H, int W, int wp, int left, void* stream);
}

namespace {

constexpr int kInvalidValue = 1;  // cudaErrorInvalidValue: the C entries' refusal
constexpr int kPlanFields = 11;   // med_stage.cuh
constexpr int kPlanDirect = 9;    // the plan's `direct` field

// Launch counts: K1 by mode (disp | pan << 1 | subocc << 2, minus one), then
// K2, the conv and the roll.  Read by ops/_build.py::launch_counts.
enum { kMedFwd = 0, kMedBwd = 7, kConv = 8, kRoll = 9, kCounters = 10 };
std::atomic<long long> launches[kCounters];

const float* ptr(const at::Tensor& t) { return t.numel() ? t.const_data_ptr<float>() : nullptr; }
float* mut(const at::Tensor& t) { return t.numel() ? t.mutable_data_ptr<float>() : nullptr; }

void check_float(const at::Tensor& t, const char* name, const at::Tensor& like, const char* kernel) {
  TORCH_CHECK_VALUE(t.is_cuda(), "the ", kernel, " kernel needs CUDA tensors; ", name, " is on ", t.device());
  TORCH_CHECK_TYPE(t.scalar_type() == at::kFloat, "the ", kernel, " kernel takes float32; ", name, " is ",
                   t.scalar_type());
  TORCH_CHECK_VALUE(t.is_contiguous(), name, " must be contiguous");
  TORCH_CHECK_VALUE(t.device() == like.device(), name, " is on ", t.device(), " but the input on ", like.device());
}

// The MED kernels' inputs: logits (B, N, H, W), image (B, C, H, W), plane
// tables (S, 5, N) with S = 1 (one table for the batch) or B.  Returns the
// tables' per-sample stride in elements (0 for one table).
int check_med(const at::Tensor& logits, const at::Tensor& image, const at::Tensor& tables) {
  check_float(logits, "logits", logits, "MED");
  check_float(image, "image", logits, "MED");
  check_float(tables, "tables", logits, "MED");
  TORCH_CHECK_VALUE(logits.dim() == 4 && image.dim() == 4, "logits and image must be NCHW, got ", logits.sizes(),
                    " and ", image.sizes());
  const auto b = logits.size(0), n = logits.size(1);
  TORCH_CHECK_VALUE(image.size(0) == b && image.size(2) == logits.size(2) && image.size(3) == logits.size(3),
                    "image ", image.sizes(), " does not match logits ", logits.sizes());
  TORCH_CHECK_VALUE(tables.dim() == 3 && tables.size(1) == 5 && tables.size(2) == n &&
                        (tables.size(0) == 1 || tables.size(0) == b),
                    "tables must be (1 or B, 5, N) for logits ", logits.sizes(), ", got ", tables.sizes());
  return tables.size(0) == 1 ? 0 : (int)(5 * n);
}

// The shift margin to launch with: 0 unless the kernel reads other columns
// than its own (`shifted`) and its staged plans do not fit, so that it takes
// the direct path; there a multiple of 4 at least 2 more than the largest
// |floor| in the tables' shift rows (rows 1 and 3, clamped to W + 1), read
// from the card.  The plan query is host-only.
int shift_margin(bool fwd, int N, int C, int W, int f0, int f1, int f2, bool shifted, const at::Tensor& tables) {
  if (!shifted) return 0;
  int plan[kPlanFields];
  const int ok = fwd ? med_fwd_plan(N, C, W, f0, f1, f2, 0, plan) : med_bwd_plan(N, C, W, f0, f1, f2, 0, plan);
  if (ok != 0 || !plan[kPlanDirect]) return 0;
  const at::Tensor rows = tables.abs().amax(at::IntArrayRef{0, 2}).cpu();
  const float* r = rows.const_data_ptr<float>();
  const int largest = (int)std::max(r[1], r[3]);
  return (largest + 2 + 3) / 4 * 4;
}

// Throw on a C entry's nonzero return; a refusal on the direct path names
// the margin, the only size it can refuse there.
void check_launch(int err, const char* name, int margin) {
  if (err == kInvalidValue) {
    TORCH_CHECK_VALUE(margin == 0, name, ": a shift margin of ", margin,
                      " columns does not fit the direct path's chunk windows (at most 1280 a side): sizes "
                      "beyond the kernel's limits");
    TORCH_CHECK_VALUE(false, name, ": sizes beyond the kernel's limits (cudaErrorInvalidValue)");
  }
  TORCH_CHECK(err == 0, name, " launch failed: CUDA error ", err);
}

at::Tensor output(const at::Tensor& like, int64_t channels, bool want) {
  if (!want) return at::empty({0}, like.options());
  return at::empty({like.size(0), channels, like.size(2), like.size(3)}, like.options());
}

std::tuple<at::Tensor, at::Tensor, at::Tensor, at::Tensor> med_fwd_cuda(const at::Tensor& logits,
                                                                        const at::Tensor& image,
                                                                        const at::Tensor& tables, bool want_disp,
                                                                        bool want_pan, bool want_subocc) {
  const int tab_stride = check_med(logits, image, tables);
  const c10::cuda::CUDAGuard guard(logits.device());
  const int B = logits.size(0), N = logits.size(1), C = image.size(1), H = logits.size(2), W = logits.size(3);
  const int margin = shift_margin(true, N, C, W, want_disp, want_pan, want_subocc, want_pan || want_subocc, tables);
  at::Tensor disp = output(logits, 1, want_disp), pan = output(logits, C, want_pan);
  at::Tensor mask_l = output(logits, 1, want_subocc), mask_r = output(logits, 1, want_subocc);
  check_launch(med_fwd(ptr(logits), ptr(image), mut(disp), mut(pan), mut(mask_l), mut(mask_r), ptr(tables),
                       tab_stride, B, N, C, H, W, want_disp, want_pan, want_subocc, margin,
                       c10::cuda::getCurrentCUDAStream().stream()),
               "med_fwd", margin);
  const int mode = (want_disp ? 1 : 0) | (want_pan ? 2 : 0) | (want_subocc ? 4 : 0);
  ++launches[kMedFwd + mode - 1];
  return {disp, pan, mask_l, mask_r};
}

std::tuple<at::Tensor, at::Tensor> med_bwd_cuda(const at::Tensor& logits, const at::Tensor& image,
                                                const std::optional<at::Tensor>& g_disp,
                                                const std::optional<at::Tensor>& g_pan, const at::Tensor& tables,
                                                bool image_grad) {
  const int tab_stride = check_med(logits, image, tables);
  const c10::cuda::CUDAGuard guard(logits.device());
  const int B = logits.size(0), N = logits.size(1), C = image.size(1), H = logits.size(2), W = logits.size(3);
  const bool want_disp = g_disp.has_value(), want_pan = g_pan.has_value(), want_gimg = image_grad && want_pan;
  for (const auto& [g, name, channels] : {std::tuple{&g_disp, "g_disp", 1}, std::tuple{&g_pan, "g_pan", C}}) {
    if (!g->has_value()) continue;
    check_float(**g, name, logits, "MED");
    TORCH_CHECK_VALUE((*g)->sizes() == at::IntArrayRef({B, channels, H, W}), name, " must be a contiguous (", B,
                      ", ", channels, ", ", H, ", ", W, ") tensor, got ", (*g)->sizes());
  }
  const int margin = shift_margin(false, N, C, W, want_disp, want_pan, want_gimg, want_pan, tables);
  at::Tensor g_logits = at::empty(logits.sizes(), logits.options());
  at::Tensor g_image = want_gimg ? at::empty(image.sizes(), image.options()) : at::empty({0}, image.options());
  check_launch(med_bwd(ptr(logits), ptr(image), want_disp ? ptr(*g_disp) : nullptr, want_pan ? ptr(*g_pan) : nullptr,
                       mut(g_logits), mut(g_image), ptr(tables), tab_stride, B, N, C, H, W, want_disp, want_pan,
                       want_gimg, margin, c10::cuda::getCurrentCUDAStream().stream()),
               "med_bwd", margin);
  ++launches[kMedBwd];
  return {g_logits, g_image};
}

at::Tensor conv3x3_cuda(const at::Tensor& x, const at::Tensor& w2) {
  check_float(x, "x", x, "conv");
  check_float(w2, "w2", x, "conv");
  TORCH_CHECK_VALUE(x.dim() == 4 && w2.dim() == 2, "x must be NCHW and w2 2-D, got ", x.sizes(), " and ",
                    w2.sizes());
  TORCH_CHECK_VALUE(w2.size(1) == 9 * x.size(1), "w2 must be (Cout, 9*Cin) for x ", x.sizes(), ", got ",
                    w2.sizes());
  const c10::cuda::CUDAGuard guard(x.device());
  at::Tensor out = at::empty({x.size(0), w2.size(0), x.size(2), x.size(3)}, x.options());
  check_launch(conv3x3_wgmma(ptr(x), ptr(w2), mut(out), x.size(0), x.size(1), x.size(2), x.size(3), w2.size(0),
                             c10::cuda::getCurrentCUDAStream().stream()),
               "conv3x3_wgmma", 0);
  ++launches[kConv];
  return out;
}

at::Tensor roll_window_cuda(const at::Tensor& x, const at::Tensor& f, int64_t wp, int64_t left) {
  TORCH_CHECK_VALUE(x.is_cuda() && f.device() == x.device(), "the roll kernel needs x and f on one CUDA device; x "
                    "is on ", x.device(), ", f on ", f.device());
  TORCH_CHECK_TYPE(x.scalar_type() == at::kFloat && f.scalar_type() == at::kInt,
                   "the roll kernel takes float32 x and int32 f, got ", x.scalar_type(), " and ", f.scalar_type());
  TORCH_CHECK_VALUE(x.dim() == 2 && x.is_contiguous() && f.dim() == 1 && f.size(0) == 1,
                    "x must be a contiguous (H, W) and f a (1,) tensor, got ", x.sizes(), ", ", f.sizes());
  const c10::cuda::CUDAGuard guard(x.device());
  at::Tensor out = at::empty(x.sizes(), x.options());
  check_launch(roll_window(ptr(x), f.const_data_ptr<int>(), mut(out), x.size(0), x.size(1), wp, left,
                           c10::cuda::getCurrentCUDAStream().stream()),
               "roll_window", 0);
  ++launches[kRoll];
  return out;
}

}  // namespace

TORCH_LIBRARY_IMPL(fal_net_torch, CUDA, m) {
  m.impl("med_fwd", &med_fwd_cuda);
  m.impl("med_bwd", &med_bwd_cuda);
  m.impl("conv3x3", &conv3x3_cuda);
  m.impl("roll_window", &roll_window_cuda);
}

extern "C" {

// The launch count of counter `i` (see the enum above); -1 past the last.
long long fal_net_torch_launches(int i) { return i >= 0 && i < kCounters ? launches[i].load() : -1; }

void fal_net_torch_reset_launches() {
  for (auto& c : launches) c = 0;
}

}  // extern "C"
