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
// more at scale 0. The TPU design (pure one-hot MXU selections, an int8
// quantised image, 1024-pixel tiles, a width % 128 gate) existed because TPU
// gathers are slow; Hopper gathers natively, so none of it carries over and
// every scale, 16x64 included, takes these kernels.
//
// K1's design. A first form (one thread per pixel, 64-bit index math) ran at
// half its bound and behind F.grid_sample: each thread paid two emulated
// 64-bit divisions, stored its C floats as C scalar stores, and had one
// pixel's four gathers in flight. Now:
// - a 2-D grid: blockIdx.y is the (batch, source) plane, so the plane, its
//   mask row (one division per block) and all offsets are 32-bit, with no
//   division per pixel;
// - each warp owns 128 consecutive pixels, 4 per lane. Lane l takes pixels
//   l, l + 32, l + 64, l + 96, so each gather instruction of the warp hits
//   the neighbours of 32 adjacent targets (a few 128-byte lines), and a lane
//   keeps 4 pixels' 4 * C gathers in flight;
// - where H*W % 4 == 0 and coords, mask and out are 16-byte aligned, u, v and
//   the mask come in as float4 (lane l: pixels 4l..4l+3) and the output goes
//   out as float4 (128 * C contiguous floats per warp), both through a
//   per-warp shared-memory transpose; otherwise the same kernel loads and
//   stores scalars (a contiguous view with a storage offset, a ragged H*W);
// - invalid pixels gather from the plane's first pixel (offsets 0), so no
//   address leaves the image and no branch splits the gathers;
// - the block size (256, 128 or 64 threads) comes from the plane size, so
//   the 32x128 and 16x64 scales still spread over the 132 SMs.
// K1-bwd keeps its first form: one thread per pixel, at two thirds of its
// bound and ahead of grid_sample's backward.
//
// The target may be a band of `target_rows` rows of the source's width (a
// spatial mesh's band of the target frame): the target's pixels (coords,
// mask, out, grad_out, dcoords) are target_rows * W per plane, the source's
// H * W, and the coordinates are the source's global pixel coordinates,
// clipped to its H and W. target_rows == H is the one-process warp.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBwdThreads = 256;  // K1-bwd: one thread per pixel

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

constexpr int kLanePixels = 4;                     // K1: pixels per lane
constexpr int kWarpPixels = 32 * kLanePixels;      // K1: pixels per warp
constexpr int kFwdMaxThreads = 256;
constexpr int kFwdVecMaxChannels = 8;  // the float4 path's staging fits 48 KB

// K1. `kChannels` > 0 fixes C at compile time (the main path's 3); 0 takes
// `channels`. `kVec`: float4 loads of u, v, mask and float4 stores of the
// output through shared memory (needs H*W % 4 == 0 and 16-byte aligned
// coords, mask and out); else scalar loads and stores.
template <int kChannels, bool kVec>
__global__ void __launch_bounds__(kFwdMaxThreads)
warp_const_src_fwd_kernel(const float* __restrict__ image,
                          const float* __restrict__ coords,
                          const float* __restrict__ mask,
                          float* __restrict__ out,
                          int numsrc, int height, int width, int target_rows,
                          int channels_arg, int coord_rows) {
  const int channels = kChannels > 0 ? kChannels : channels_arg;
  const int hw = target_rows * width;  // the target's pixels per plane
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p0 = (blockIdx.x * (blockDim.x >> 5) + warp) * kWarpPixels;
  if (p0 >= hw) return;  // whole warps only: no block-wide barrier below
  const int count = min(kWarpPixels, hw - p0);
  const int bn = blockIdx.y;  // flattened (batch, source)
  const size_t plane = static_cast<size_t>(bn) * hw;
  const float* img = image + static_cast<size_t>(bn) * height * width * channels;
  const float* cu = coords + plane * coord_rows + p0;
  const float* cv = cu + hw;
  const float* mk = mask == nullptr ? nullptr
                                    : mask + static_cast<size_t>(bn / numsrc) * hw + p0;
  float* o = out + (plane + p0) * channels;

  // per warp: u, v, mask (128 each), then the output (128 * C)
  extern __shared__ float4 stage4[];
  float* s_u = reinterpret_cast<float*>(stage4) + warp * (3 + channels) * kWarpPixels;
  float* s_v = s_u + kWarpPixels;
  float* s_m = s_v + kWarpPixels;
  float* s_out = s_m + kWarpPixels;

  float u[kLanePixels], v[kLanePixels];
  bool keep[kLanePixels];
  if (kVec) {
    if (kLanePixels * lane < count) {  // count % 4 == 0 on this path
      reinterpret_cast<float4*>(s_u)[lane] = __ldg(reinterpret_cast<const float4*>(cu) + lane);
      reinterpret_cast<float4*>(s_v)[lane] = __ldg(reinterpret_cast<const float4*>(cv) + lane);
      if (mk != nullptr) {
        reinterpret_cast<float4*>(s_m)[lane] = __ldg(reinterpret_cast<const float4*>(mk) + lane);
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int k = 0; k < kLanePixels; ++k) {
    const int q = lane + 32 * k;
    const bool in = q < count;
    u[k] = in ? (kVec ? s_u[q] : cu[q]) : 0.0f;
    v[k] = in ? (kVec ? s_v[q] : cv[q]) : 0.0f;
    keep[k] = in && (mk == nullptr || (kVec ? s_m[q] : mk[q]) != 0.0f);
  }

  // neighbours and weights: same products, in the same order, as the plain version
  int base[kLanePixels], rstep[kLanePixels], cstep[kLanePixels];
  bool valid[kLanePixels];
  float w_ff[kLanePixels], w_fc[kLanePixels], w_cf[kLanePixels], w_cc[kLanePixels];
#pragma unroll
  for (int k = 0; k < kLanePixels; ++k) {
    const Neighbors nb = clipped_neighbors(u[k], v[k], nullptr, 0, height, width);
    valid[k] = nb.valid && keep[k];
    // an invalid pixel reads the plane's first pixel: every address in frame
    base[k] = valid[k] ? (static_cast<int>(nb.vf) * width + static_cast<int>(nb.uf)) * channels
                       : 0;
    rstep[k] = valid[k] ? width * channels : 0;  // (vf + 1, uf)
    cstep[k] = valid[k] ? channels : 0;          // (vf, uf + 1)
    const float w_uf = nb.uc - u[k], w_uc = u[k] - nb.uf;
    const float w_vf = nb.vc - v[k], w_vc = v[k] - nb.vf;
    w_ff[k] = w_uf * w_vf;
    w_fc[k] = w_uf * w_vc;
    w_cf[k] = w_uc * w_vf;
    w_cc[k] = w_uc * w_vc;
  }

#pragma unroll
  for (int ch = 0; ch < channels; ++ch) {
#pragma unroll
    for (int k = 0; k < kLanePixels; ++k) {
      const float* p_ff = img + base[k] + ch;
      const float* p_fc = p_ff + rstep[k];
      const float* p_cf = p_ff + cstep[k];
      const float* p_cc = p_fc + cstep[k];
      const float val = __ldg(p_ff) * w_ff[k] + __ldg(p_fc) * w_fc[k]
                        + __ldg(p_cf) * w_cf[k] + __ldg(p_cc) * w_cc[k];
      const int q = lane + 32 * k;
      if (kVec) {
        s_out[q * channels + ch] = valid[k] ? val : 0.0f;
      } else if (q < count) {
        o[q * channels + ch] = valid[k] ? val : 0.0f;
      }
    }
  }

  if (kVec) {  // the warp's count * C floats, a multiple of 4, as float4
    __syncwarp();
    const int n4 = count * channels / 4;
    float4* o4 = reinterpret_cast<float4*>(o);
    const float4* s4 = reinterpret_cast<const float4*>(s_out);
    for (int j = lane; j < n4; j += 32) o4[j] = s4[j];
  }
}

__global__ void __launch_bounds__(kBwdThreads)
warp_const_src_bwd_kernel(const float* __restrict__ image,
                          const float* __restrict__ coords,
                          const float* __restrict__ mask,
                          const float* __restrict__ grad_out,
                          float* __restrict__ dcoords,
                          int numsrc, int height, int width, int target_rows,
                          int channels, int coord_rows, long long total) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long hw = static_cast<long long>(target_rows) * width;  // target pixels
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
    const float* p_ff = floor_neighbor(image, bn, static_cast<long long>(height) * width, nb,
                                       width, channels);
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
  return static_cast<unsigned int>((total + kBwdThreads - 1) / kBwdThreads);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int kChannels>
void launch_fwd(bool vec, dim3 grid, int threads, cudaStream_t stream, const float* image,
                const float* coords, const float* mask, float* out, int numsrc, int height,
                int width, int target_rows, int channels, int coord_rows) {
  if (vec) {
    const size_t smem = (threads / 32) * (3 + channels) * kWarpPixels * sizeof(float);
    warp_const_src_fwd_kernel<kChannels, true><<<grid, threads, smem, stream>>>(
        image, coords, mask, out, numsrc, height, width, target_rows, channels, coord_rows);
  } else {
    warp_const_src_fwd_kernel<kChannels, false><<<grid, threads, 0, stream>>>(
        image, coords, mask, out, numsrc, height, width, target_rows, channels, coord_rows);
  }
}

}  // namespace

// image [B,N,H,W,C], coords [B,N,coord_rows,T*W] (rows u, v[, 1]) for T =
// target_rows target rows, mask [B,T,W,1] or null, out [B,N,T,W,C]; all
// float32, contiguous, on the current device. `threads` per block: 64, 128
// or 256 (the wrapper picks it from the plane size); B*N <= 65535. Launches
// K1 on `stream`, with the float4 path where T*W % 4 == 0, C <= 8 and
// coords, mask and out are 16-byte aligned, and returns cudaGetLastError().
extern "C" int xpt_warp_const_src_fwd(const float* image, const float* coords,
                                      const float* mask, float* out,
                                      int batch, int numsrc, int height,
                                      int width, int target_rows, int channels,
                                      int coord_rows, int threads, void* stream) {
  const int hw = target_rows * width;
  const int planes = batch * numsrc;
  if (hw == 0 || planes == 0 || channels == 0) return static_cast<int>(cudaSuccess);
  if (planes > 65535 || (threads != 64 && threads != 128 && threads != 256)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int block_pixels = threads / 32 * kWarpPixels;
  const dim3 grid((hw + block_pixels - 1) / block_pixels, planes);
  const bool vec = hw % 4 == 0 && channels <= kFwdVecMaxChannels && aligned16(coords)
                   && (mask == nullptr || aligned16(mask)) && aligned16(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (channels == 3) {
    launch_fwd<3>(vec, grid, threads, s, image, coords, mask, out, numsrc, height, width,
                  target_rows, channels, coord_rows);
  } else {
    launch_fwd<0>(vec, grid, threads, s, image, coords, mask, out, numsrc, height, width,
                  target_rows, channels, coord_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

// The inputs of xpt_warp_const_src_fwd plus grad_out [B,N,T,W,C] (the
// cotangent of its output); writes dcoords [B,N,coord_rows,T*W] (du, dv[, 0]).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int xpt_warp_const_src_bwd(const float* image, const float* coords,
                                      const float* mask, const float* grad_out,
                                      float* dcoords, int batch, int numsrc,
                                      int height, int width, int target_rows,
                                      int channels, int coord_rows, void* stream) {
  const long long total = static_cast<long long>(batch) * numsrc * target_rows * width;
  if (total == 0) return static_cast<int>(cudaSuccess);
  warp_const_src_bwd_kernel<<<grid_size(total), kBwdThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      image, coords, mask, grad_out, dcoords, numsrc, height, width, target_rows, channels,
      coord_rows, total);
  return static_cast<int>(cudaGetLastError());
}
