// K1 and K1-bwd: the const-source bilinear warp and its coordinate gradient,
// CUDA C++ for Hopper (sm_90a).
//
// K1 replaces the Pallas TPU kernel xpt_mde_tpu/ops/pallas/warp.py::_warp_kernel
// (launched by _warp_kernel_spmd, reached through bilinear_sample_const_src).
// It computes exactly the function of the plain PyTorch version,
// xpt_mde_tpu_torch/ops/warp.py::bilinear_sample_plain: per (batch, source,
// target pixel) the clipped floor/ceil neighbours of (u, v); the pixel is
// invalid where a clipped ceil != floor + 1 or the shared per-batch mask is 0,
// and invalid pixels are written as 0; valid ones lerp the four neighbours'
// C channels in float32.
//
// K1-bwd replaces that kernel's custom VJP: the `with_grads` variant of
// _warp_kernel, which stores J_f, J_c, D_f and D_c (4*C f32 slots per pixel),
// and _warp_const_bwd, which combines them with the output cotangent g:
//   du = valid * sum_c g * (w_v * D_f + (1 - w_v) * D_c)
//   dv = valid * sum_c g * (J_c - J_f)
// It computes exactly xpt_mde_tpu_torch/ops/warp.py::warp_coord_grad_plain.
// The image and mask cotangents are zero by contract, so there is no scatter:
// each thread recomputes its pixel's neighbours from the image and writes only
// its own pixel's (du, dv) -- no atomics, and no residual slots in memory.
//
// What bounds both: memory. K1 does two lerps per channel against 4*C + 2
// reads; at the headline scale 0 (B=8, N=4, 128x512, C=3) one launch reads
// ~25 MB of image, ~17 MB of coords and ~2 MB of mask and writes ~25 MB: about
// 70 MB, or ~21 us at the H100's 3.35 TB/s. K1-bwd also reads g (~25 MB) and
// writes dcoords (~17 MB) instead of the output: about 86 MB, ~26 us. Storing
// the TPU kernel's residual slots instead would write, and read back, ~100 MB
// more at scale 0.
//
// Design: one thread per (b, n, target pixel). Neighbouring threads take
// neighbouring pixels, so the u and v rows of coords, the mask and dcoords are
// coalesced, and the output and g (C consecutive floats per thread) are one
// contiguous run per warp. The image reads are data-dependent gathers; a
// whole image batch (~25 MB) fits in the 50 MB L2, and reprojected neighbours
// of adjacent targets are mostly adjacent in the source, so those reads are
// served from L2. The TPU design (pure one-hot MXU selections, an int8
// quantised image, 1024-pixel tiles, a width % 128 gate) existed because TPU
// gathers are slow; Hopper gathers natively, so none of it carries over and
// every scale, 16x64 included, takes these kernels.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// One target pixel's source neighbours: the clipped floor/ceil of (u, v), and
// whether the pair is valid (both clipped ceils == floor + 1 and mask != 0).
struct Neighbors {
  float uf, uc, vf, vc;
  bool valid;
};

__device__ __forceinline__ Neighbors clipped_neighbors(float u, float v,
                                                       const float* mask,
                                                       long long mask_idx,
                                                       int height, int width) {
  const float wmax = static_cast<float>(width - 1);
  const float hmax = static_cast<float>(height - 1);
  Neighbors nb;
  nb.uf = floorf(u);
  nb.uc = fminf(fmaxf(nb.uf + 1.0f, 0.0f), wmax);
  nb.uf = fminf(fmaxf(nb.uf, 0.0f), wmax);
  nb.vf = floorf(v);
  nb.vc = fminf(fmaxf(nb.vf + 1.0f, 0.0f), hmax);
  nb.vf = fminf(fmaxf(nb.vf, 0.0f), hmax);
  nb.valid = (nb.uf + 1.0f == nb.uc) && (nb.vf + 1.0f == nb.vc);
  if (mask != nullptr) nb.valid = nb.valid && (mask[mask_idx] != 0.0f);
  return nb;
}

// The (vf, uf) neighbour of image plane bn; valid => (vf + 1, uf + 1) lies
// inside the frame too, at +row and +channels.
__device__ __forceinline__ const float* floor_neighbor(const float* image, long long bn,
                                                       long long hw, const Neighbors& nb,
                                                       int width, int channels) {
  return image + bn * hw * channels
         + (static_cast<long long>(nb.vf) * width + static_cast<long long>(nb.uf)) * channels;
}

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
  const Neighbors nb = clipped_neighbors(u, v, mask, (bn / numsrc) * hw + p, height, width);

  float* o = out + idx * channels;
  if (!nb.valid) {
    for (int ch = 0; ch < channels; ++ch) o[ch] = 0.0f;
    return;
  }

  // same products, in the same order, as the plain version
  const float w_uf = nb.uc - u, w_uc = u - nb.uf;
  const float w_vf = nb.vc - v, w_vc = v - nb.vf;
  const float w_ff = w_uf * w_vf, w_fc = w_uf * w_vc;
  const float w_cf = w_uc * w_vf, w_cc = w_uc * w_vc;

  const float* p_ff = floor_neighbor(image, bn, hw, nb, width, channels);
  const float* p_fc = p_ff + static_cast<long long>(width) * channels;  // (vf + 1, uf)
  const float* p_cf = p_ff + channels;                                 // (vf, uf + 1)
  const float* p_cc = p_fc + channels;                                 // (vf + 1, uf + 1)
  for (int ch = 0; ch < channels; ++ch) {
    o[ch] = __ldg(p_ff + ch) * w_ff + __ldg(p_fc + ch) * w_fc
            + __ldg(p_cf + ch) * w_cf + __ldg(p_cc + ch) * w_cc;
  }
}

__global__ void __launch_bounds__(kThreads)
warp_const_src_bwd_kernel(const float* __restrict__ image,
                          const float* __restrict__ coords,
                          const float* __restrict__ mask,
                          const float* __restrict__ grad_out,
                          float* __restrict__ dcoords,
                          int numsrc, int height, int width, int channels,
                          int coord_rows, long long total) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long hw = static_cast<long long>(height) * width;
  const long long bn = idx / hw;
  const long long p = idx - bn * hw;

  const float* c = coords + bn * coord_rows * hw;
  const float u = c[p];
  const float v = c[hw + p];
  const Neighbors nb = clipped_neighbors(u, v, mask, (bn / numsrc) * hw + p, height, width);

  float du = 0.0f, dv = 0.0f;
  if (nb.valid) {
    // same products, in the same order, as warp_coord_grad_plain
    const float w_u = nb.uc - u, w_v = nb.vc - v;
    const float* p_ff = floor_neighbor(image, bn, hw, nb, width, channels);
    const float* p_fc = p_ff + static_cast<long long>(width) * channels;
    const float* p_cf = p_ff + channels;
    const float* p_cc = p_fc + channels;
    const float* g = grad_out + idx * channels;
    for (int ch = 0; ch < channels; ++ch) {
      const float ff = __ldg(p_ff + ch), fc = __ldg(p_fc + ch);
      const float cf = __ldg(p_cf + ch), cc = __ldg(p_cc + ch);
      const float j_f = w_u * ff + (1.0f - w_u) * cf;   // row vf
      const float j_c = w_u * fc + (1.0f - w_u) * cc;   // row vf + 1
      const float d_f = cf - ff, d_c = cc - fc;
      const float gc = __ldg(g + ch);
      du += gc * (w_v * d_f + (1.0f - w_v) * d_c);
      dv += gc * (j_c - j_f);
    }
  }
  float* d = dcoords + bn * coord_rows * hw;
  d[p] = du;
  d[hw + p] = dv;
  if (coord_rows > 2) d[2 * hw + p] = 0.0f;
}

unsigned int grid_size(long long total) {
  return static_cast<unsigned int>((total + kThreads - 1) / kThreads);
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
  warp_const_src_fwd_kernel<<<grid_size(total), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      image, coords, mask, out, numsrc, height, width, channels, coord_rows,
      total);
  return static_cast<int>(cudaGetLastError());
}

// The inputs of xpt_warp_const_src_fwd plus grad_out [B,N,H,W,C] (the
// cotangent of its output); writes dcoords [B,N,coord_rows,H*W] (du, dv[, 0]).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int xpt_warp_const_src_bwd(const float* image, const float* coords,
                                      const float* mask, const float* grad_out,
                                      float* dcoords, int batch, int numsrc,
                                      int height, int width, int channels,
                                      int coord_rows, void* stream) {
  const long long total = static_cast<long long>(batch) * numsrc * height * width;
  if (total == 0) return static_cast<int>(cudaSuccess);
  warp_const_src_bwd_kernel<<<grid_size(total), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      image, coords, mask, grad_out, dcoords, numsrc, height, width, channels,
      coord_rows, total);
  return static_cast<int>(cudaGetLastError());
}
