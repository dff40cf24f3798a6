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
// and write the other. The TPU design (whole padded frames resident in VMEM,
// one dy row per grid step with an f32 scratch carried across grid steps, XLA
// pre-slicing the dy windows so Mosaic only takes static lane slices) existed
// for VMEM and the sequential TPU grid; nothing is carried between blocks
// here, nothing is padded in memory, and every level takes these kernels.
//
// K2 and K4 keep their first form: each thread owns one output element and
// loops over its reduction, neighbouring threads on neighbouring x, so every
// read is coalesced; but K2 reads each cl and cr value up to n^2 times and K4
// each g value C times, from L1/L2 (a whole level fits the 50 MB L2). K4 is
// the gather form (each thread reads the g and cl values that land on its
// own pixel): no scatter, no atomics, a deterministic result.
//
// K3's first form had the same shape and ran at 7% of its bound: each g value
// was read C times (once per channel thread), each cr value up to n^2 times,
// about 1.4 GB of L1/L2 traffic at level 2. Its design now:
// - a block owns one image row y, a tile of up to 128 columns and a chunk of
//   channels (all of them where that still gives two blocks per SM), and
//   walks only the displacement rows i whose row y + dy_i is in the frame
//   (at most ceil(H / stride): 4 of 9 at levels 2-5); the others contribute
//   nothing and are neither read nor computed;
// - a stage copies into shared memory, with cp.async, the n g rows of the
//   block's pixels (so each g value leaves device memory once) and, per
//   channel, the cr row y + dy_i with its dx halo. The buffers are zeroed
//   once, and staging writes only in-frame columns and real channels, so the
//   frame's outside reads as 0 and no term is bounds-checked. Where they fit
//   80 KB, all in-frame rows are one stage (levels 4-6); else one row a
//   stage, double-buffered, the next row's copy under this row's FMAs
//   (levels 2-3). Copies are 16 bytes where stride, md and W allow (levels
//   2-3), else 4;
// - a thread owns 4 pixels one stride apart (x, x + s, x + 2s, x + 3s) times
//   8 channels. Pixel p at displacement j reads cr column x + (p + j) * s,
//   so 12 staged values feed 36 FMAs per channel, and each g value held in a
//   register feeds 8 channels: 0.46 shared loads per FMA instead of 2;
// - staged rows carry stride % 32 floats of padding per 32 columns, and the
//   channel blocks a skew, so that the lanes of a warp read distinct banks
//   (at most 2-way conflicts at the PWC levels);
// - the block's results go out through shared memory, so each warp store
//   covers whole runs of x (stores of pixels one stride apart cost as much
//   as the rest of the kernel at level 2);
// - the tile, channel chunk, skew, rows per stage, buffers, threads and
//   shared memory (at most 227 KB) come from ops/kernels/correlation.py::
//   bwd_cl_plan; the entry checks them against this layout and opts in
//   above 48 KB.
// The sum over displacements keeps its order (i, then j) and adds exact
// zeros for out-of-frame columns.

#include <cstdint>

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

// K3's tiles (see the header): a thread owns kPix pixels one stride apart
// times kChan channels, and takes the displacements kDisp at a time.
constexpr int kPix = 4;
constexpr int kChan = 8;
constexpr int kDisp = 9;
constexpr int kBwdClMaxThreads = 256;
constexpr int kSmemLimit = 232448;  // 227 KB, the most a block may take

// Shared-memory index of column l of a staged row: stride % 32 floats of
// padding per 32 columns, so the lanes of a warp, which read columns
// x0 + m * stride for their pixel groups x0, hit distinct banks (for
// strides 1, 2, 4 and 8).
__host__ __device__ inline int padded(int l, int stride) { return l + (l >> 5) * (stride & 31); }

// One cp.async of kUnit floats (4: 16 bytes, both ends 16-byte aligned).
template <int kUnit>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (kUnit == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr), "l"(src));
  }
}

// K3's shared-memory layout. A slot holds one displacement row's staging:
// chans / kChan channel blocks of kChan cr rows (tile_x + (n - 1) * stride
// columns each), the blocks cb_skew floats apart beyond their rows so that
// the lanes of different channel blocks spread over the banks, then n g rows
// of tile_x. A buffer holds rows_per_stage slots; with two buffers the next
// stage's copy runs under this stage's FMAs.
struct BwdClLayout {
  int row_len, cr_pitch, cb_pitch, g_pitch, slot, buffer;
};

__host__ __device__ inline BwdClLayout bwd_cl_layout(int tile_x, int chan_blocks, int n,
                                                     int stride, int cb_skew,
                                                     int rows_per_stage) {
  BwdClLayout lay;
  lay.row_len = tile_x + (n - 1) * stride;
  lay.cr_pitch = padded(lay.row_len - 1, stride) + 1;
  lay.cb_pitch = kChan * lay.cr_pitch + cb_skew;
  lay.g_pitch = padded(tile_x - 1, stride) + 1;
  lay.slot = (chan_blocks * lay.cb_pitch + n * lay.g_pitch + 3) / 4 * 4;  // float4-aligned
  lay.buffer = rows_per_stage * lay.slot;
  return lay;
}

// Copies `rows` rows of `units` runs of kUnit floats with the block's warps:
// source row r at src_row(r), staged at dst_row(r) from staged column
// dst_col0 on. A warp takes 32 / units rows per pass where rows are shorter
// than a warp.
template <int kUnit, typename SrcRow, typename DstRow>
__device__ __forceinline__ void stage_rows(SrcRow src_row, DstRow dst_row, int dst_col0,
                                           int rows, int units, int stride) {
  if (units <= 0) return;
  const int lane = threadIdx.x & 31;
  const int per_pass = units >= 32 ? 1 : 32 / units;
  const int rr = units >= 32 ? 0 : lane / units;
  if (rr >= per_pass) return;
  const int u0 = units >= 32 ? lane : lane - rr * units;
  const int step = units >= 32 ? 32 : units;
  for (int r = (threadIdx.x >> 5) * per_pass + rr; r < rows; r += (blockDim.x >> 5) * per_pass) {
    const float* srow = src_row(r);
    float* drow = dst_row(r);
    for (int u = u0; u < units; u += step) {
      cp_async<kUnit>(drow + padded(dst_col0 + u * kUnit, stride), srow + u * kUnit);
    }
  }
}

// grid (x tiles, H, B * channel chunks); block: chan_blocks * tile_x / kPix
// working threads, and more (up to a multiple of 32) that only stage;
// chan_blocks * kChan channels; rows_per_stage displacement rows per stage,
// in `buffers` (1 or 2) buffers.
// kVec: the rows are staged 16 bytes at a time (stride, md and W multiples
// of 4, g and cr 16-byte aligned); else 4 bytes at a time.
template <bool kVec>
__global__ void __launch_bounds__(kBwdClMaxThreads)
corr_bwd_cl_kernel(const float* __restrict__ g, const float* __restrict__ cr,
                   float* __restrict__ dcl, int channels, int height, int width,
                   int md, int stride, int n, int tile_x, int chan_blocks, int cb_skew,
                   int rows_per_stage, int buffers) {
  constexpr int kUnit = kVec ? 4 : 1;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int s = stride;
  const int chans = chan_blocks * kChan;
  const BwdClLayout lay = bwd_cl_layout(tile_x, chan_blocks, n, s, cb_skew, rows_per_stage);
  const int chunks = (channels + chans - 1) / chans;
  const int b = blockIdx.z / chunks;
  const int c0 = (blockIdx.z - b * chunks) * chans;
  const int y = blockIdx.y;
  const int xt = blockIdx.x * tile_x;
  const int hw = height * width;
  const float* gb = g + static_cast<size_t>(b) * n * n * hw + y * width + xt;
  const float* crb = cr + (static_cast<size_t>(b) * channels + c0) * hw;

  // Zero the buffers once. Staging then writes only in-frame columns and
  // real channels, the same set for every displacement row, so the frame's
  // outside and the channels past C read as 0 and no term is bounds-checked.
  for (int e = threadIdx.x; e < buffers * lay.buffer / 4; e += blockDim.x) {
    smem4[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();

  // the displacement rows i whose row y - md + i * s lies in the frame
  const int i_lo = md > y ? (md - y + s - 1) / s : 0;
  const int i_hi = min(n - 1, (height - 1 - y + md) / s);
  // staged row column l is frame column xt - md + l; on the kVec path
  // l_lo, l_hi and x_hi are multiples of 4
  const int l_lo = max(0, md - xt);
  const int l_hi = min(lay.row_len, width - xt + md);
  const int x_hi = min(tile_x, width - xt);
  const int c_hi = min(chans, channels - c0);
  const int cr_pitch = lay.cr_pitch, cb_pitch = lay.cb_pitch, g_pitch = lay.g_pitch;
  const int slot = lay.slot;

  // stage displacement rows i0 .. i0 + count - 1 into `buffer`, one slot each
  auto stage = [&](int i0, int count, float* buffer) {
    for (int k = 0; k < count; ++k) {
      // channel c0's row y + dy, from staged column l_lo on
      const float* cr_k = crb + ((y + (i0 + k) * s - md) * width + xt - md + l_lo);
      const float* g_k = gb + static_cast<size_t>(i0 + k) * n * hw;
      float* slot_k = buffer + k * slot;
      stage_rows<kUnit>(
          [=](int r) { return cr_k + static_cast<size_t>(r) * hw; },
          [=](int r) { return slot_k + (r / kChan) * cb_pitch + (r % kChan) * cr_pitch; },
          l_lo, c_hi, (l_hi - l_lo) / kUnit, s);
      stage_rows<kUnit>(
          [=](int r) { return g_k + static_cast<size_t>(r) * hw; },
          [=](int r) { return slot_k + chan_blocks * cb_pitch + r * g_pitch; },
          0, n, x_hi / kUnit, s);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // this thread: pixel group gi (pixels x0 + p * s) and channel block cb
  const int groups = tile_x / kPix;
  const bool active = static_cast<int>(threadIdx.x) < groups * chan_blocks;
  const int gi = threadIdx.x % groups;
  const int cb = threadIdx.x / groups;
  const int x0 = (gi / s) * (kPix * s) + gi % s;
  int g_addr[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) g_addr[p] = padded(x0 + p * s, s);

  float acc[kChan][kPix];
#pragma unroll
  for (int q = 0; q < kChan; ++q) {
#pragma unroll
    for (int p = 0; p < kPix; ++p) acc[q][p] = 0.0f;
  }

  const int per_stage = rows_per_stage;
  const int stages = i_lo <= i_hi ? (i_hi - i_lo + per_stage) / per_stage : 0;
  if (stages > 0) stage(i_lo, min(per_stage, i_hi - i_lo + 1), smem);
  for (int k = 0; k < stages; ++k) {
    const int i0 = i_lo + k * per_stage;
    const int count = min(per_stage, i_hi - i0 + 1);
    const int i1 = i0 + per_stage;
    const float* cur = smem + (buffers == 2 ? (k & 1) * lay.buffer : 0);
    if (buffers == 2 && k + 1 < stages) {  // the next copy runs under these FMAs
      stage(i1, min(per_stage, i_hi - i1 + 1), smem + ((k + 1) & 1) * lay.buffer);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    for (int row = 0; active && row < count; ++row) {
      const float* s_cr = cur + row * slot + cb * cb_pitch;
      const float* s_g = cur + row * slot + chan_blocks * cb_pitch;
      for (int j0 = 0; j0 < n; j0 += kDisp) {
        // g of this thread's pixels for displacements j0 .. j0 + kDisp - 1
        float gv[kDisp][kPix];
#pragma unroll
        for (int j = 0; j < kDisp; ++j) {
          const bool on = j0 + j < n;
          const int jj = on ? j0 + j : n - 1;
#pragma unroll
          for (int p = 0; p < kPix; ++p) gv[j][p] = on ? s_g[jj * g_pitch + g_addr[p]] : 0.0f;
        }
        // the window of columns x0 + (j0 + m) * s feeds pixel p at
        // displacement j = m - p: kDisp + kPix - 1 loads for kDisp * kPix FMAs
        int w_addr[kDisp + kPix - 1];
#pragma unroll
        for (int m = 0; m < kDisp + kPix - 1; ++m) {
          w_addr[m] = padded(x0 + min(j0 + m, n + kPix - 2) * s, s);
        }
#pragma unroll
        for (int q = 0; q < kChan; ++q) {
          const float* row_q = s_cr + q * cr_pitch;
          float w[kDisp + kPix - 1];
#pragma unroll
          for (int m = 0; m < kDisp + kPix - 1; ++m) w[m] = row_q[w_addr[m]];
#pragma unroll
          for (int j = 0; j < kDisp; ++j) {
#pragma unroll
            for (int p = 0; p < kPix; ++p) acc[q][p] = fmaf(gv[j][p], w[p + j], acc[q][p]);
          }
        }
      }
    }
    __syncthreads();  // the buffer is restaged from here on
    if (buffers == 1 && k + 1 < stages) stage(i1, min(per_stage, i_hi - i1 + 1), smem);
  }

  // The block's outputs go out through shared memory (the first buffer,
  // c_hi rows of g_pitch floats), so each warp store covers whole runs of x
  // rather than pixels one stride apart.
  if (stages == 0) __syncthreads();  // else the stage loop ended on a barrier
  if (active) {
#pragma unroll
    for (int q = 0; q < kChan; ++q) {
#pragma unroll
      for (int p = 0; p < kPix; ++p) smem[(cb * kChan + q) * g_pitch + g_addr[p]] = acc[q][p];
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int per_pass = x_hi >= 32 ? 1 : 32 / x_hi;
  const int rr = x_hi >= 32 ? 0 : lane / x_hi;
  if (rr >= per_pass) return;
  const int u0 = x_hi >= 32 ? lane : lane - rr * x_hi;
  const int step = x_hi >= 32 ? 32 : x_hi;
  float* out = dcl + (static_cast<size_t>(b) * channels + c0) * hw + y * width + xt;
  for (int r = (threadIdx.x >> 5) * per_pass + rr; r < c_hi; r += (blockDim.x >> 5) * per_pass) {
    for (int x = u0; x < x_hi; x += step) {
      out[static_cast<size_t>(r) * hw + x] = smem[r * g_pitch + padded(x, s)]
                                            / static_cast<float>(channels);
    }
  }
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
// dcl [B,C,H,W]. The tiling comes from the wrapper's plan
// (ops/kernels/correlation.py::bwd_cl_plan): tile_x (a multiple of
// 4 * stride), chan_blocks (blocks of 8 channels per CUDA block), cb_skew
// (0-31; a multiple of 4 where stride is), rows_per_stage (1..n), buffers
// (1 or 2), threads
// (a multiple of 32, at least chan_blocks * tile_x / 4, at most 256) and
// smem_bytes, which must equal this layout's buffers and fit 227 KB. Stages
// 16 bytes at a time where stride, md and W are multiples of 4 and g and cr
// are 16-byte aligned.
// Launches K3 on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan that does not match.
extern "C" int xpt_corr_bwd_cl(const float* g, const float* cr, float* dcl,
                               int batch, int channels, int height, int width,
                               int md, int stride, int tile_x, int chan_blocks,
                               int cb_skew, int rows_per_stage, int buffers, int threads,
                               int smem_bytes, void* stream) {
  const int n = displacements(md, stride);
  if (static_cast<long long>(batch) * channels * height * width == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const int chans = chan_blocks * kChan;
  const int chunks = (channels + chans - 1) / chans;
  const bool vec = stride % 4 == 0 && md % 4 == 0 && width % 4 == 0
                   && reinterpret_cast<uintptr_t>(g) % 16 == 0
                   && reinterpret_cast<uintptr_t>(cr) % 16 == 0;
  if (tile_x <= 0 || stride <= 0 || rows_per_stage < 1 || rows_per_stage > n
      || (buffers != 1 && buffers != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BwdClLayout lay = bwd_cl_layout(tile_x, chan_blocks, n, stride, cb_skew,
                                        rows_per_stage);
  const long long want = static_cast<long long>(buffers) * lay.buffer * sizeof(float);
  if (tile_x % (kPix * stride) != 0 || chan_blocks <= 0
      || cb_skew < 0 || cb_skew >= 32 || (stride % 4 == 0 && cb_skew % 4 != 0)
      || threads % 32 != 0 || threads > kBwdClMaxThreads
      || threads < chan_blocks * (tile_x / kPix) || smem_bytes != want
      || smem_bytes > kSmemLimit || height > 65535
      || static_cast<long long>(batch) * chunks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = vec ? corr_bwd_cl_kernel<true> : corr_bwd_cl_kernel<false>;
  if (smem_bytes > 48 * 1024) {  // above the default, a launch must opt in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((width + tile_x - 1) / tile_x, height, batch * chunks);
  kernel<<<grid, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      g, cr, dcl, channels, height, width, md, stride, n, tile_x, chan_blocks, cb_skew,
      rows_per_stage, buffers);
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
