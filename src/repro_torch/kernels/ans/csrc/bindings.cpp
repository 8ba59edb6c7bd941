// PyTorch bindings of the six ANS kernels and the posterior bucketize
// (../../bucketize/csrc/bucketize.cu). Each entry point takes typed
// tensors, checks device, dtype, shape and contiguity, allocates its
// outputs, and launches on PyTorch's current stream of the tensors' card
// (a device guard makes that card current). A failed check raises
// ValueError, a failed launch RuntimeError. torch.utils.cpp_extension
// builds this file together with the .cu sources (kernel.py).
#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>
#include <torch/extension.h>

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

namespace {

using torch::Tensor;

// `t` lies on `device` as a contiguous `dtype` tensor of `shape`.
void need(const Tensor& t, const char* what, torch::ScalarType dtype,
          at::IntArrayRef shape, const torch::Device& device) {
  TORCH_CHECK_VALUE(t.device() == device, "kernels.ans: ", what,
                    " must be on ", device, ", got ", t.device());
  TORCH_CHECK_VALUE(
      t.scalar_type() == dtype && t.sizes() == shape && t.is_contiguous(),
      "kernels.ans: ", what, " must be contiguous ", dtype, shape, ", got ",
      t.scalar_type(), t.sizes(), " (contiguous=", t.is_contiguous(), ")");
}

void dims(const Tensor& t, const char* what, int64_t n) {
  TORCH_CHECK_VALUE(t.dim() == n, "kernels.ans: ", what, " must have ", n,
                    " dimensions, got ", t.sizes());
}

void launched(cudaError_t e, const char* name) {
  TORCH_CHECK(e == cudaSuccess, "kernels.ans: ", name,
              " launch failed: ", cudaGetErrorString(e));
}

// The card of `head`, made current for the rest of the scope.
torch::Device card(const Tensor& head) {
  TORCH_CHECK_VALUE(head.is_cuda(), "kernels.ans: the kernels take CUDA "
                    "tensors, got head on ", head.device());
  return head.device();
}

}  // namespace

// head int64[L]; starts, freqs int32[S, L] -> (head, chunks, need).
std::vector<Tensor> push_emit(const Tensor& head, const Tensor& starts,
                              const Tensor& freqs, int64_t precision) {
  const torch::Device dev = card(head);
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

// head int64[L]; table int32[L, A+1]; feed int32[S, L]
// -> (head, syms int32[S, L], reads int32[L]).
std::vector<Tensor> pop_table_emit(const Tensor& head, const Tensor& table,
                                   const Tensor& feed, int64_t precision) {
  const torch::Device dev = card(head);
  dims(table, "table", 2);
  dims(feed, "feed", 2);
  const int64_t steps = feed.size(0), lanes = table.size(0),
                a1 = table.size(1);
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

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("push_emit", &push_emit);
  m.def("pop_table_emit", &pop_table_emit);
  m.def("pop_slots", &pop_slots);
  m.def("pop_dyntable_emit", &pop_dyntable_emit);
  m.def("pop_grid_cdf", &pop_grid_cdf);
  m.def("pop_grid_uniform", &pop_grid_uniform);
  m.def("grid_starts", &grid_starts);
  m.def("bucketize", &posterior_bucketize);
}
