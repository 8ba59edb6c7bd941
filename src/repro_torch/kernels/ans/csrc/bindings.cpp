// PyTorch bindings of the six ANS kernels, the posterior bucketize
// (../../bucketize/csrc/bucketize.cu) and the flash-attention forward's two
// routes (../../flash/csrc/flash_fwd_wgmma.cu, bfloat16 on the tensor
// cores; ../../flash/csrc/flash_fwd.cu, float32 on the CUDA cores). Each
// entry point takes typed tensors, checks device, dtype, shape and
// contiguity, allocates its outputs, and launches on PyTorch's current
// stream of the tensors' card (a device guard makes that card current).
// A failed check raises ValueError, a failed launch RuntimeError.
// torch.utils.cpp_extension builds this file together with the .cu sources
// (kernel.py).
#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>
#include <torch/extension.h>

#include <cstdint>
#include <string>
#include <vector>

cudaError_t launch_push(const int64_t* head, const int32_t* starts,
                        const int32_t* freqs, int64_t* out_head,
                        int32_t* chunks, int32_t* need, int steps, int lanes,
                        int precision, cudaStream_t stream);
cudaError_t launch_pop_dyntable(const int64_t* head, const int32_t* tables,
                                const int32_t* feed, int64_t* out_head,
                                int32_t* syms, int32_t* reads, int steps,
                                int lanes, int a1, int precision,
                                cudaStream_t stream);
cudaError_t launch_pop_table(const int64_t* head, const int32_t* table,
                             const int32_t* feed, int64_t* out_head,
                             int32_t* syms, int32_t* reads, int steps,
                             int lanes, int a1, int precision,
                             cudaStream_t stream);
cudaError_t launch_peek(const int64_t* head, int32_t* slots, int lanes,
                        int precision, cudaStream_t stream);
cudaError_t launch_pop_grid(const int64_t* head, const float* mu,
                            const float* sigma, const int32_t* feed,
                            const float* edges, int64_t* out_head,
                            int32_t* idx, int32_t* reads, int steps,
                            int lanes, int kind, int lat_bits,
                            int precision, cudaStream_t stream);
cudaError_t launch_grid_starts(const int32_t* idx, const float* mu,
                               const float* sigma, const float* edges,
                               int32_t* start, int32_t* freq, int n,
                               int kind, int lat_bits, int precision,
                               cudaStream_t stream);
cudaError_t launch_bucketize(const int32_t* slot, const float* mu,
                             const float* sigma, const float* edges,
                             int32_t* idx, int32_t* start, int32_t* freq,
                             int lanes, int lat_bits, int precision,
                             cudaStream_t stream);
cudaError_t launch_flash_fwd_simt(const void* q, const void* k,
                                  const void* v, void* out, int bh,
                                  int group, int sq, int sk, int d,
                                  int head_dim, int causal, int window,
                                  cudaStream_t stream);
cudaError_t launch_flash_fwd_wgmma(const void* q, const void* k,
                                   const void* v, void* out, int bh,
                                   int group, int sq, int sk, int dp,
                                   int head_dim, int causal, int window,
                                   cudaStream_t stream);

namespace {

using torch::Tensor;

// "[a, b, ...]". Messages here format numbers with std::to_string: a
// check whose message streams an integer has been seen to crash the
// process on the card's machine instead of raising.
std::string shape_str(at::IntArrayRef shape) {
  std::string s = "[";
  for (size_t i = 0; i < shape.size(); ++i)
    s += (i ? ", " : "") + std::to_string(shape[i]);
  return s + "]";
}

// `t` lies on `device` as a contiguous `dtype` tensor of `shape`.
void need(const Tensor& t, const char* what, torch::ScalarType dtype,
          at::IntArrayRef shape, const torch::Device& device) {
  TORCH_CHECK_VALUE(t.device() == device, "kernels.ans: ", what,
                    " must be on ", device.str(), ", got ",
                    t.device().str());
  TORCH_CHECK_VALUE(
      t.scalar_type() == dtype && t.sizes() == shape && t.is_contiguous(),
      "kernels.ans: ", what, " must be contiguous ", dtype, shape_str(shape),
      ", got ", t.scalar_type(), shape_str(t.sizes()),
      t.is_contiguous() ? "" : " (not contiguous)");
}

void dims(const Tensor& t, const char* what, int64_t n) {
  TORCH_CHECK_VALUE(t.dim() == n, "kernels.ans: ", what, " must have ",
                    std::to_string(n), " dimensions, got ",
                    shape_str(t.sizes()));
}

void launched(cudaError_t e, const char* name) {
  TORCH_CHECK(e == cudaSuccess, "kernels.ans: ", name,
              " launch failed: ", cudaGetErrorString(e));
}

// The card of `head`, made current for the rest of the scope.
torch::Device card(const Tensor& head) {
  TORCH_CHECK_VALUE(head.is_cuda(), "kernels.ans: the kernels take CUDA "
                    "tensors, got head on ", head.device().str());
  return head.device();
}

}  // namespace

// head int64[L]; starts, freqs int32[S, L] -> (head, chunks, need).
std::vector<Tensor> push_emit(const Tensor& head, const Tensor& starts,
                              const Tensor& freqs, int64_t precision) {
  const torch::Device dev = card(head);
  // The kernel's reciprocal division is exact for freq <= 2^16
  // (push.cu), and the reference allows no other precision
  // (repro/core/ans.py:135).
  TORCH_CHECK_VALUE(precision >= 1 && precision <= 16, "kernels.ans: "
                    "push_emit precision must be in [1, 16], got ",
                    std::to_string(precision));
  dims(starts, "starts", 2);
  const int64_t steps = starts.size(0), lanes = starts.size(1);
  need(head, "head", torch::kInt64, {lanes}, dev);
  need(starts, "starts", torch::kInt32, {steps, lanes}, dev);
  need(freqs, "freqs", torch::kInt32, {steps, lanes}, dev);
  const c10::cuda::CUDAGuard guard(dev);
  Tensor out = torch::empty_like(head);
  Tensor chunks = torch::empty_like(starts);
  Tensor need_ = torch::empty_like(starts);
  launched(launch_push(head.data_ptr<int64_t>(), starts.data_ptr<int32_t>(),
                       freqs.data_ptr<int32_t>(), out.data_ptr<int64_t>(),
                       chunks.data_ptr<int32_t>(), need_.data_ptr<int32_t>(),
                       steps, lanes, precision,
                       at::cuda::getCurrentCUDAStream()),
           "push_emit");
  return {out, chunks, need_};
}

// head int64[L]; tables int32[S, L, A+1]; feed int32[S, L]
// -> (head, syms int32[S, L], reads int32[L]).
std::vector<Tensor> pop_dyntable_emit(const Tensor& head, const Tensor& tables,
                                      const Tensor& feed, int64_t precision) {
  const torch::Device dev = card(head);
  dims(tables, "tables", 3);
  const int64_t steps = tables.size(0), lanes = tables.size(1),
                a1 = tables.size(2);
  need(head, "head", torch::kInt64, {lanes}, dev);
  need(tables, "tables", torch::kInt32, {steps, lanes, a1}, dev);
  need(feed, "feed", torch::kInt32, {steps, lanes}, dev);
  const c10::cuda::CUDAGuard guard(dev);
  Tensor out = torch::empty_like(head);
  Tensor syms = torch::empty_like(feed);
  Tensor reads = torch::zeros({lanes}, feed.options());
  launched(launch_pop_dyntable(
               head.data_ptr<int64_t>(), tables.data_ptr<int32_t>(),
               feed.data_ptr<int32_t>(), out.data_ptr<int64_t>(),
               syms.data_ptr<int32_t>(), reads.data_ptr<int32_t>(), steps,
               lanes, a1, precision, at::cuda::getCurrentCUDAStream()),
           "pop_dyntable_emit");
  return {out, syms, reads};
}

// The widest table row pop_table_emit takes.
constexpr int64_t kPopTableMaxA1 = int64_t{1} << 16;

// head int64[L]; table int32[L, A+1], A+1 <= 2^16; feed int32[S, L];
// precision in [1, 16] -> (head, syms int32[S, L], reads int32[L]).
std::vector<Tensor> pop_table_emit(const Tensor& head, const Tensor& table,
                                   const Tensor& feed, int64_t precision) {
  const torch::Device dev = card(head);
  dims(table, "table", 2);
  dims(feed, "feed", 2);
  const int64_t steps = feed.size(0), lanes = table.size(0),
                a1 = table.size(1);
  // pop_table.cu stages rows up to 4097 entries whole and a sample of
  // wider ones, which fits its shared memory up to 2^16 entries (the most
  // a precision-16 table holds; repro/core/ans.py cdf_to_starts).
  TORCH_CHECK_VALUE(a1 <= kPopTableMaxA1, "kernels.ans: pop_table_emit "
                    "takes tables of at most ", std::to_string(kPopTableMaxA1),
                    " entries a lane, got ", std::to_string(a1));
  TORCH_CHECK_VALUE(precision >= 1 && precision <= 16, "kernels.ans: "
                    "pop_table_emit precision must be in [1, 16], got ",
                    std::to_string(precision));
  need(head, "head", torch::kInt64, {lanes}, dev);
  need(table, "table", torch::kInt32, {lanes, a1}, dev);
  need(feed, "feed", torch::kInt32, {steps, lanes}, dev);
  const c10::cuda::CUDAGuard guard(dev);
  Tensor out = torch::empty_like(head);
  Tensor syms = torch::empty_like(feed);
  Tensor reads = torch::zeros({lanes}, feed.options());
  launched(launch_pop_table(
               head.data_ptr<int64_t>(), table.data_ptr<int32_t>(),
               feed.data_ptr<int32_t>(), out.data_ptr<int64_t>(),
               syms.data_ptr<int32_t>(), reads.data_ptr<int32_t>(), steps,
               lanes, a1, precision, at::cuda::getCurrentCUDAStream()),
           "pop_table_emit");
  return {out, syms, reads};
}

// head int64[L] -> slots int32[L].
Tensor pop_slots(const Tensor& head, int64_t precision) {
  const torch::Device dev = card(head);
  dims(head, "head", 1);
  need(head, "head", torch::kInt64, {head.size(0)}, dev);
  const c10::cuda::CUDAGuard guard(dev);
  Tensor slots = torch::empty({head.size(0)},
                              head.options().dtype(torch::kInt32));
  launched(launch_peek(head.data_ptr<int64_t>(), slots.data_ptr<int32_t>(),
                       head.size(0), precision,
                       at::cuda::getCurrentCUDAStream()),
           "pop_slots");
  return slots;
}

// Grid kinds, as pop_grid.cu and grid_starts.cu number them.
constexpr int kUniform = 0, kGaussian = 1, kLogistic = 2;

static int cdf_kind(const std::string& kind) {
  TORCH_CHECK_VALUE(kind == "gaussian" || kind == "logistic",
                    "kernels.ans: CDF grid kind must be gaussian or "
                    "logistic, got ", kind);
  return kind == "logistic" ? kLogistic : kGaussian;
}

// Shared by every kind of the grid pop; mu, sigma and edges are null for
// the uniform kind.
static std::vector<Tensor> pop_grid(const Tensor& head, const Tensor* mu,
                                    const Tensor* sigma, const Tensor& feed,
                                    const Tensor* edges, int kind,
                                    int64_t lat_bits, int64_t precision) {
  const torch::Device dev = card(head);
  dims(feed, "feed", 2);
  const int64_t steps = feed.size(0), lanes = feed.size(1);
  need(head, "head", torch::kInt64, {lanes}, dev);
  need(feed, "feed", torch::kInt32, {steps, lanes}, dev);
  if (mu != nullptr) {
    need(*mu, "mu", torch::kFloat32, {steps, lanes}, dev);
    need(*sigma, "sigma", torch::kFloat32, {steps, lanes}, dev);
    need(*edges, "edges", torch::kFloat32, {(int64_t{1} << lat_bits) + 1},
         dev);
  }
  const c10::cuda::CUDAGuard guard(dev);
  Tensor out = torch::empty_like(head);
  Tensor idx = torch::empty_like(feed);
  Tensor reads = torch::zeros({lanes}, feed.options());
  const bool cdf = mu != nullptr;
  launched(launch_pop_grid(
               head.data_ptr<int64_t>(),
               cdf ? mu->data_ptr<float>() : nullptr,
               cdf ? sigma->data_ptr<float>() : nullptr,
               feed.data_ptr<int32_t>(),
               cdf ? edges->data_ptr<float>() : nullptr,
               out.data_ptr<int64_t>(), idx.data_ptr<int32_t>(),
               reads.data_ptr<int32_t>(), steps, lanes, kind, lat_bits,
               precision, at::cuda::getCurrentCUDAStream()),
           "pop_grid_emit");
  return {out, idx, reads};
}

// kind "gaussian" or "logistic" (sigma carries the scale); head int64[L];
// mu, sigma float32[S, L]; feed int32[S, L]; edges float32[K+1]
// -> (head, idx int32[S, L], reads int32[L]).
std::vector<Tensor> pop_grid_cdf(const Tensor& head, const Tensor& mu,
                                 const Tensor& sigma, const Tensor& feed,
                                 const Tensor& edges, const std::string& kind,
                                 int64_t lat_bits, int64_t precision) {
  return pop_grid(head, &mu, &sigma, feed, &edges, cdf_kind(kind), lat_bits,
                  precision);
}

// head int64[L]; feed int32[S, L] -> (head, idx int32[S, L], reads).
std::vector<Tensor> pop_grid_uniform(const Tensor& head, const Tensor& feed,
                                     int64_t lat_bits, int64_t precision) {
  return pop_grid(head, nullptr, nullptr, feed, nullptr, kUniform, lat_bits,
                  precision);
}

// idx int32[S, L]; mu, sigma float32[S, L]; edges float32[K+1]; kind
// "gaussian" or "logistic" -> (start int32[S, L], freq int32[S, L]).
std::vector<Tensor> grid_starts(const Tensor& idx, const Tensor& mu,
                                const Tensor& sigma, const Tensor& edges,
                                const std::string& kind, int64_t lat_bits,
                                int64_t precision) {
  const int k = cdf_kind(kind);
  const torch::Device dev = card(idx);
  need(idx, "idx", torch::kInt32, idx.sizes(), dev);
  need(mu, "mu", torch::kFloat32, idx.sizes(), dev);
  need(sigma, "sigma", torch::kFloat32, idx.sizes(), dev);
  need(edges, "edges", torch::kFloat32, {(int64_t{1} << lat_bits) + 1},
       dev);
  const c10::cuda::CUDAGuard guard(dev);
  Tensor start = torch::empty_like(idx);
  Tensor freq = torch::empty_like(idx);
  launched(launch_grid_starts(
               idx.data_ptr<int32_t>(), mu.data_ptr<float>(),
               sigma.data_ptr<float>(), edges.data_ptr<float>(),
               start.data_ptr<int32_t>(), freq.data_ptr<int32_t>(),
               idx.numel(), k, lat_bits, precision,
               at::cuda::getCurrentCUDAStream()),
           "grid_starts");
  return {start, freq};
}

// slot int32[L]; mu, sigma float32[L]; edges float32[K+1]
// -> (idx, start, freq) int32[L].
std::vector<Tensor> posterior_bucketize(const Tensor& slot, const Tensor& mu,
                                        const Tensor& sigma,
                                        const Tensor& edges, int64_t lat_bits,
                                        int64_t precision) {
  const torch::Device dev = card(slot);
  dims(slot, "slot", 1);
  const int64_t lanes = slot.size(0);
  need(slot, "slot", torch::kInt32, {lanes}, dev);
  need(mu, "mu", torch::kFloat32, {lanes}, dev);
  need(sigma, "sigma", torch::kFloat32, {lanes}, dev);
  need(edges, "edges", torch::kFloat32, {(int64_t{1} << lat_bits) + 1},
       dev);
  const c10::cuda::CUDAGuard guard(dev);
  Tensor idx = torch::empty_like(slot);
  Tensor start = torch::empty_like(slot);
  Tensor freq = torch::empty_like(slot);
  launched(launch_bucketize(
               slot.data_ptr<int32_t>(), mu.data_ptr<float>(),
               sigma.data_ptr<float>(), edges.data_ptr<float>(),
               idx.data_ptr<int32_t>(), start.data_ptr<int32_t>(),
               freq.data_ptr<int32_t>(), lanes, lat_bits, precision,
               at::cuda::getCurrentCUDAStream()),
           "bucketize");
  return {idx, start, freq};
}

// Why flash route `route` cannot take q, k, v of head dim d (already
// checked: dtype, shapes, card), or "" when it can. Both routes load
// 16-byte pieces of rows: `wgmma` by TMA, D a multiple of 16, at least one
// key; `simt` by cp.async, D a multiple of 4. The wrapper zero-pads D.
static std::string flash_refusal(const std::string& route, const Tensor& q,
                                 const Tensor& k, const Tensor& v, int64_t d,
                                 int64_t sk, int64_t head_dim) {
  const int64_t multiple = route == "wgmma" ? 16 : 4;
  if (d % multiple != 0)
    return "route " + route + " needs D a multiple of " +
           std::to_string(multiple) + ", got " + std::to_string(d);
  if (head_dim < 1 || head_dim > d)
    return "route " + route + " needs 1 <= head_dim <= D, got " +
           std::to_string(head_dim);
  if (route == "wgmma" && sk < 1) return "route wgmma needs a key";
  for (const Tensor* t : {&q, &k, &v})
    if (reinterpret_cast<uintptr_t>(t->data_ptr()) % 16 != 0)
      return "route " + route + " needs 16-byte aligned tensors";
  return "";
}

// The largest head dim either flash route takes: 160 is the largest that
// a config of the reference registers (stablelm-12b).
constexpr int64_t kFlashMaxD = 192;

// q [BH, Sq, D]; k, v [BH / G, Sk, D]: contiguous, one card -> out
// [BH, Sq, D]. route "wgmma": bfloat16, D a multiple of 16 in [16, 192],
// Sk >= 1; route "simt": float32, D a multiple of 4 in [4, 192]. Both:
// 16-byte aligned, and head_dim <= D the true head dim that sets the
// scale (the wrapper zero-pads D). Raises on inputs the named route does
// not take.
Tensor flash_fwd(const Tensor& q, const Tensor& k, const Tensor& v,
                 bool causal, int64_t window, const std::string& route,
                 int64_t head_dim) {
  const torch::Device dev = card(q);
  dims(q, "q", 3);
  dims(k, "k", 3);
  const int64_t bh = q.size(0), sq = q.size(1), d = q.size(2);
  const int64_t bkv = k.size(0), sk = k.size(1);
  const bool wgmma = route == "wgmma";
  TORCH_CHECK_VALUE(wgmma || route == "simt", "kernels.flash: route must "
                    "be wgmma or simt, got ", route);
  const auto dtype = wgmma ? torch::kBFloat16 : torch::kFloat32;
  TORCH_CHECK_VALUE(q.scalar_type() == dtype, "kernels.flash: route ",
                    route, " takes ", dtype, ", got ", q.scalar_type());
  TORCH_CHECK_VALUE(d >= 1 && d <= kFlashMaxD, "kernels.flash: head dim "
                    "must be in [1, ", std::to_string(kFlashMaxD), "], got ",
                    std::to_string(d));
  TORCH_CHECK_VALUE(bkv >= 1 && bh % bkv == 0, "kernels.flash: ",
                    std::to_string(bh), " query heads do not share ",
                    std::to_string(bkv), " key heads evenly");
  TORCH_CHECK_VALUE(window >= INT32_MIN && window <= INT32_MAX,
                    "kernels.flash: window out of int32 range: ",
                    std::to_string(window));
  need(q, "q", dtype, {bh, sq, d}, dev);
  need(k, "k", dtype, {bkv, sk, d}, dev);
  need(v, "v", dtype, {bkv, sk, d}, dev);
  const std::string refusal = flash_refusal(route, q, k, v, d, sk, head_dim);
  TORCH_CHECK_VALUE(refusal.empty(), "kernels.flash: ", refusal);
  const c10::cuda::CUDAGuard guard(dev);
  Tensor out = torch::empty_like(q);
  const cudaStream_t stream = at::cuda::getCurrentCUDAStream();
  launched(wgmma ? launch_flash_fwd_wgmma(
                       q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), bh, bh / bkv, sq, sk, d, head_dim,
                       causal, (int)window, stream)
                 : launch_flash_fwd_simt(q.data_ptr(), k.data_ptr(),
                                         v.data_ptr(), out.data_ptr(), bh,
                                         bh / bkv, sq, sk, d, head_dim,
                                         causal, (int)window, stream),
           "flash_fwd");
  return out;
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("push_emit", &push_emit);
  m.def("pop_table_emit", &pop_table_emit);
  m.def("pop_slots", &pop_slots);
  m.def("pop_dyntable_emit", &pop_dyntable_emit);
  m.def("pop_grid_cdf", &pop_grid_cdf);
  m.def("pop_grid_uniform", &pop_grid_uniform);
  m.def("grid_starts", &grid_starts);
  m.def("bucketize", &posterior_bucketize);
  m.def("flash_fwd", &flash_fwd);
}
