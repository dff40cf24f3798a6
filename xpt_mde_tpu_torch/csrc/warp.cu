// K1: const-source bilinear warp, CUDA C++ for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel xpt_mde_tpu/ops/pallas/warp.py::_warp_kernel
// (launched by _warp_kernel_spmd, reached through bilinear_sample_const_src),
// forward only. It computes exactly the function of the plain PyTorch version,
// xpt_mde_tpu_torch/ops/warp.py::bilinear_sample_plain: per (batch, source,
// target pixel) the clipped floor/ceil neighbours of (u, v); the pixel is
// invalid where a clipped ceil != floor + 1 or the shared per-batch mask is 0,
// and invalid pixels are written as 0; valid ones lerp the four neighbours'
// C channels in float32.
//
// What bounds it: memory. Two floating-point lerps per channel against
// 4*C + 2 reads. At the headline scale 0 (B=8, N=4, 128x512, C=3) one launch
// reads ~25 MB of image, ~17 MB of coords and ~2 MB of mask and writes ~25 MB:
// about 70 MB, or ~21 us at the H100's 3.35 TB/s.
//
// Design: one thread per (b, n, target pixel). Neighbouring threads take
// neighbouring pixels, so the u and v rows of coords and the mask are read
// coalesced, and the output (C consecutive floats per thread) is written as
// one contiguous run per warp. The image reads are data-dependent gathers; a
// whole image batch (~25 MB) fits in the 50 MB L2, and reprojected neighbours
// of adjacent targets are mostly adjacent in the source, so those reads are
// served from L2. The TPU design (pure one-hot MXU selections, an int8
// quantised image, 1024-pixel tiles, a width % 128 gate) existed because TPU
// gathers are slow; Hopper gathers natively, so none of it carries over and
// every scale, 16x64 included, takes this kernel.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
warp_const_src_fwd_kernel(const float* __restrict__ image,
                          const float* __restrict__ coords,
                          const float* __restrict__ mask,
                          float* __restrict__ out,
                          int numsrc, int height, int width, int channels,
                          int coord_rows, long long total) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long hw = static_cast<long long>(height) * width;
  const long long bn = idx / hw;   // flattened (batch, source)
  const long long p = idx - bn * hw;

  const float* c = coords + bn * coord_rows * hw;
  const float u = c[p];
  const float v = c[hw + p];

  const float wmax = static_cast<float>(width - 1);
  const float hmax = static_cast<float>(height - 1);
  float uf = floorf(u);
  const float uc = fminf(fmaxf(uf + 1.0f, 0.0f), wmax);
  uf = fminf(fmaxf(uf, 0.0f), wmax);
  float vf = floorf(v);
  const float vc = fminf(fmaxf(vf + 1.0f, 0.0f), hmax);
  vf = fminf(fmaxf(vf, 0.0f), hmax);

  bool valid = (uf + 1.0f == uc) && (vf + 1.0f == vc);
  if (mask != nullptr) valid = valid && (mask[(bn / numsrc) * hw + p] != 0.0f);

  float* o = out + idx * channels;
  if (!valid) {
    for (int ch = 0; ch < channels; ++ch) o[ch] = 0.0f;
    return;
  }

  // same products, in the same order, as the plain version
  const float w_uf = uc - u, w_uc = u - uf;
  const float w_vf = vc - v, w_vc = v - vf;
  const float w_ff = w_uf * w_vf, w_fc = w_uf * w_vc;
  const float w_cf = w_uc * w_vf, w_cc = w_uc * w_vc;

  // valid => uf + 1 and vf + 1 lie inside the frame
  const long long row = static_cast<long long>(width) * channels;
  const float* p_ff = image + bn * hw * channels
                      + (static_cast<long long>(vf) * width + static_cast<long long>(uf)) * channels;
  const float* p_fc = p_ff + row;        // (vf + 1, uf)
  const float* p_cf = p_ff + channels;   // (vf, uf + 1)
  const float* p_cc = p_fc + channels;   // (vf + 1, uf + 1)
  for (int ch = 0; ch < channels; ++ch) {
    o[ch] = __ldg(p_ff + ch) * w_ff + __ldg(p_fc + ch) * w_fc
            + __ldg(p_cf + ch) * w_cf + __ldg(p_cc + ch) * w_cc;
  }
}

}  // namespace

// image [B,N,H,W,C], coords [B,N,coord_rows,H*W] (rows u, v[, 1]),
// mask [B,H,W,1] or null, out [B,N,H,W,C]; all float32, contiguous, on the
// current device. Launches on `stream` and returns cudaGetLastError().
extern "C" int xpt_warp_const_src_fwd(const float* image, const float* coords,
                                      const float* mask, float* out,
                                      int batch, int numsrc, int height,
                                      int width, int channels, int coord_rows,
                                      void* stream) {
  const long long total = static_cast<long long>(batch) * numsrc * height * width;
  if (total == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (total + kThreads - 1) / kThreads;
  warp_const_src_fwd_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      image, coords, mask, out, numsrc, height, width, channels, coord_rows,
      total);
  return static_cast<int>(cudaGetLastError());
}
