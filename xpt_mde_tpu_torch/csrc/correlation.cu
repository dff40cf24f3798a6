// K2, K3 and K4: the PWC-Net correlation cost volume and its two input
// gradients, CUDA C++ for Hopper (sm_90a).
//
// K2 replaces the Pallas TPU kernel xpt_mde_tpu/ops/pallas/correlation.py::
// _corr_kernel (launched by _corr_forward), K3 _corr_grad_cl_kernel (launched
// by _bwd_dcl_spmd) and K4 _corr_grad_cr_kernel (launched by _bwd_dcr_spmd).
// All three work channel-first (NCHW), the layout of the Pallas kernels and of
// the port's convolutions. With offsets o_i = -md + i * stride (i < n,
// n = 2 * md / stride + 1) and displacement k = i * n + j <-> (dy, dx) =
// (o_i, o_j), dy-major:
//
//   K2  out[b,k,y,x]   = (1/C) sum_c cl[b,c,y,x] * cr[b,c,y+dy,x+dx]
//   K3  dcl[b,c,y,x]   = (1/C) sum_k g[b,k,y,x] * cr[b,c,y+dy,x+dx]
//   K4  dcr[b,c,y',x'] = (1/C) sum_k g[b,k,y'-dy,x'-dx] * cl[b,c,y'-dy,x'-dx]
//
// where a term whose shifted position lies outside the frame is zero. They
// compute exactly the plain PyTorch version
// xpt_mde_tpu_torch/ops/correlation.py::correlation_cost_plain and its
// autograd, up to the order of the float32 sums.
//
// What bounds them on this card: memory, at every PWC level. K2 at level 2
// (B=32, C=32, 32x128, n^2=81) must read 33.5 MB and write 42.5 MB, ~23 us at
// 3.35 TB/s, against 2 * C * n^2 flops per pixel, 0.68 GFLOP or ~10 us at
// the 67 TFLOP/s float32 rate; K3 and K4 read g (42.5 MB) and one feature map
// and write the other. These first kernels re-read their inputs: K2 reads
// each cl and cr value up to n^2 times, K3 and K4 read each g value C times.
// Neighbouring threads take neighbouring x, so every read is coalesced and
// the re-reads come from L1/L2 (a whole level's inputs fit the 50 MB L2). The TPU design (whole padded frames resident in VMEM, one dy row
// per grid step with an f32 scratch carried across grid steps, XLA
// pre-slicing the dy windows so Mosaic only takes static lane slices) existed
// for VMEM and the sequential TPU grid; on Hopper each thread owns one output
// element and loops over the reduction itself, so nothing is carried between
// blocks, nothing is padded in memory, and every level takes these kernels.
// K4 is written in gather form (each thread reads the g and cl values that
// land on its own pixel), so there is no scatter and no atomics: the result
// is deterministic.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
corr_fwd_kernel(const float* __restrict__ cl, const float* __restrict__ cr,
                float* __restrict__ out, int channels, int height, int width,
                int md, int stride, int n, long long total) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long hw = static_cast<long long>(height) * width;
  const int x = static_cast<int>(idx % width);
  const int y = static_cast<int>((idx / width) % height);
  const int n2 = n * n;
  const int k = static_cast<int>((idx / hw) % n2);
  const long long b = idx / (hw * n2);
  const int dy = -md + (k / n) * stride;
  const int dx = -md + (k % n) * stride;
  const int ys = y + dy, xs = x + dx;
  float acc = 0.0f;
  if (ys >= 0 && ys < height && xs >= 0 && xs < width) {
    const float* pl = cl + b * channels * hw + static_cast<long long>(y) * width + x;
    const float* pr = cr + b * channels * hw + static_cast<long long>(ys) * width + xs;
    for (int c = 0; c < channels; ++c) {
      acc += __ldg(pl + c * hw) * __ldg(pr + c * hw);
    }
  }
  out[idx] = acc / static_cast<float>(channels);
}

__global__ void __launch_bounds__(kThreads)
corr_bwd_cl_kernel(const float* __restrict__ g, const float* __restrict__ cr,
                   float* __restrict__ dcl, int channels, int height, int width,
                   int md, int stride, int n, long long total) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long hw = static_cast<long long>(height) * width;
  const int x = static_cast<int>(idx % width);
  const int y = static_cast<int>((idx / width) % height);
  const long long bc = idx / hw;  // flattened (batch, channel)
  const long long b = bc / channels;
  const int n2 = n * n;
  const float* pg = g + b * n2 * hw + static_cast<long long>(y) * width + x;
  const float* pr = cr + bc * hw;
  float acc = 0.0f;
  for (int i = 0; i < n; ++i) {
    const int ys = y - md + i * stride;
    if (ys < 0 || ys >= height) continue;
    for (int j = 0; j < n; ++j) {
      const int xs = x - md + j * stride;
      if (xs < 0 || xs >= width) continue;
      acc += __ldg(pg + (i * n + j) * hw)
             * __ldg(pr + static_cast<long long>(ys) * width + xs);
    }
  }
  dcl[idx] = acc / static_cast<float>(channels);
}

__global__ void __launch_bounds__(kThreads)
corr_bwd_cr_kernel(const float* __restrict__ g, const float* __restrict__ cl,
                   float* __restrict__ dcr, int channels, int height, int width,
                   int md, int stride, int n, long long total) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long hw = static_cast<long long>(height) * width;
  const int x = static_cast<int>(idx % width);  // x', y': this thread's cr pixel
  const int y = static_cast<int>((idx / width) % height);
  const long long bc = idx / hw;
  const long long b = bc / channels;
  const int n2 = n * n;
  const float* pg = g + b * n2 * hw;
  const float* pl = cl + bc * hw;
  float acc = 0.0f;
  for (int i = 0; i < n; ++i) {
    const int ys = y + md - i * stride;  // y' - dy_i
    if (ys < 0 || ys >= height) continue;
    for (int j = 0; j < n; ++j) {
      const int xs = x + md - j * stride;  // x' - dx_j
      if (xs < 0 || xs >= width) continue;
      const long long p = static_cast<long long>(ys) * width + xs;
      acc += __ldg(pg + (i * n + j) * hw + p) * __ldg(pl + p);
    }
  }
  dcr[idx] = acc / static_cast<float>(channels);
}

unsigned int grid_size(long long total) {
  return static_cast<unsigned int>((total + kThreads - 1) / kThreads);
}

int displacements(int md, int stride) { return 2 * md / stride + 1; }

}  // namespace

// cl, cr [B,C,H,W]; out [B,n^2,H,W] with n = 2 * md / stride + 1; all float32,
// contiguous, on the current device. Launches K2 on `stream` and returns
// cudaGetLastError().
extern "C" int xpt_corr_fwd(const float* cl, const float* cr, float* out,
                            int batch, int channels, int height, int width,
                            int md, int stride, void* stream) {
  const int n = displacements(md, stride);
  const long long total = static_cast<long long>(batch) * n * n * height * width;
  if (total == 0) return static_cast<int>(cudaSuccess);
  corr_fwd_kernel<<<grid_size(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cl, cr, out, channels, height, width, md, stride, n, total);
  return static_cast<int>(cudaGetLastError());
}

// g [B,n^2,H,W] (the cotangent of K2's output), cr [B,C,H,W]; writes
// dcl [B,C,H,W]. Launches K3 on `stream` and returns cudaGetLastError().
extern "C" int xpt_corr_bwd_cl(const float* g, const float* cr, float* dcl,
                               int batch, int channels, int height, int width,
                               int md, int stride, void* stream) {
  const int n = displacements(md, stride);
  const long long total = static_cast<long long>(batch) * channels * height * width;
  if (total == 0) return static_cast<int>(cudaSuccess);
  corr_bwd_cl_kernel<<<grid_size(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, cr, dcl, channels, height, width, md, stride, n, total);
  return static_cast<int>(cudaGetLastError());
}

// g [B,n^2,H,W], cl [B,C,H,W]; writes dcr [B,C,H,W]. Launches K4 on `stream`
// and returns cudaGetLastError().
extern "C" int xpt_corr_bwd_cr(const float* g, const float* cl, float* dcr,
                               int batch, int channels, int height, int width,
                               int md, int stride, void* stream) {
  const int n = displacements(md, stride);
  const long long total = static_cast<long long>(batch) * channels * height * width;
  if (total == 0) return static_cast<int>(cudaSuccess);
  corr_bwd_cr_kernel<<<grid_size(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, cl, dcr, channels, height, width, md, stride, n, total);
  return static_cast<int>(cudaGetLastError());
}
