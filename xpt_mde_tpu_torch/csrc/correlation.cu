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
// where a term whose shifted position lies outside the frame is zero. On a
// spatial mesh's band cl and g hold h rows and cr its own H_r rows (the rows
// the band reads), row_offset = cl's first global row minus cr's: cl's row y
// meets cr's row y + row_offset + dy, and the frame is cr's [0, H_r); K4 then
// writes dcr over cr's H_r rows. row_offset 0 with h = H_r is the whole frame.
// They compute exactly the plain PyTorch version
// xpt_mde_tpu_torch/ops/correlation.py::correlation_cost_plain and its
// autograd, up to the order of the float32 sums; every sum has a fixed order
// and nothing is added atomically, so a result is the same bits every run.
//
// What bounds them on this card: memory, at every PWC level. K2 at level 2
// (B=32, C=32, 32x128, n^2=81) must read 33.5 MB and write 42.5 MB, ~23 us at
// 3.35 TB/s, against 2 * C * n^2 flops per pixel, 0.68 GFLOP or ~10 us at
// the 67 TFLOP/s float32 rate; K3 and K4 read g (42.5 MB) and one feature map
// and write the other. No tensor cores for float32 operands: wgmma takes no
// float32, and TF32 would break the 1e-5 tolerance; the work is FFMA fed
// from shared memory. (bfloat16 operands are another matter: their products
// are exact in float32, and the bfloat16 K2, K3 and K4 in
// correlation_bf16.cu take them on the tensor cores.)
// The TPU design (whole padded frames resident in VMEM, one dy row per grid
// step with an f32 scratch carried across grid steps, XLA pre-slicing the dy
// windows so Mosaic only takes static lane slices) existed for VMEM and the
// sequential TPU grid; nothing is carried between blocks here, nothing is
// padded in memory, and every level takes these kernels.
//
// The first forms (one thread per output element) re-read their inputs
// from L1/L2: K2 each cl and cr value up to n^2 times, K3 and K4 each g value
// C times, ~1 GB of loads at level 2. The three now share one pattern:
// - a block owns one image row, a tile of up to 128 columns (and, for K3 and
//   K4, a chunk of channels), and walks only the displacement rows i whose
//   shifted row is in the frame (at most ceil(H / stride): 4 of 9 at levels
//   2-5); the others contribute nothing and are neither read nor computed;
// - a stage copies rows into shared memory with cp.async, 16 bytes at a time
//   where stride, md and W allow (levels 2-3), else 4. The buffers are zeroed
//   once, and staging writes only in-frame columns and real channels, the
//   same set for every displacement row, so the frame's outside reads as 0
//   and no term is bounds-checked. Where everything fits, all in-frame rows
//   are one stage; else one row a stage (K3, K4: double-buffered, the next
//   row's copy under this row's FMAs; K2: one buffer, see below);
// - a thread owns 4 pixels one stride apart (x, x + s, x + 2s, x + 3s).
//   Pixels one stride apart share n - 1 of their n shifted columns, so for
//   one channel and 9 displacements a window of 12 staged values feeds 36
//   FMAs;
// - staged rows carry stride % 32 floats of padding per 32 columns, and the
//   channel rows or blocks a skew, so that the lanes of a warp read distinct
//   banks (at most 2-way conflicts at the PWC levels);
// - results go out through shared memory, so each warp store covers runs of
//   x (stores of pixels one stride apart cost as much as the rest of K3 did
//   at level 2);
// - the launch plans are Python (ops/kernels/correlation.py::fwd_plan and
//   bwd_plan), so CPU tests check them; each entry recomputes the layout,
//   refuses a plan that does not match, and opts in above 48 KB of shared
//   memory (at most 227 KB).
//
// K2: the block stages its cl tile [C x tile] once and, per stage, the cr
// rows y + dy_i with their dx halo [C x (tile + (n - 1) * stride)]. A thread
// owns its 4 pixels times the 9 displacements j of one row i (n > 9 takes
// them 9 at a time) and walks a group of channels: 4 cl and 12 cr loads per
// 36 FMAs (0.44 shared loads per FMA, against 2 loads per FMA from L1/L2 in
// the first form). A block has only tile / 4 pixel groups per displacement
// row, so the channel sum is split over channel groups of threads (49
// groups of 4 channels at level 6, where the grid has 64 blocks); their
// partial sums meet in shared memory and are added in group order. Where
// all in-frame rows fit one stage with two blocks an SM (levels 4-6), they
// are one stage and the groups fill 256 threads; else (levels 2-3) one row
// is a stage in one buffer, the block stays within a quarter of the SM's
// shared memory and 128 threads, and the four blocks that share an SM hide
// each other's copies: at levels 2-3 this beat double-buffering, which
// fits only two or three blocks an SM. Displacement rows whose row
// y + dy_i lies outside the frame are written as zero planes without
// compute. Outputs go out as whole rows of one plane, float4 where
// W % 4 == 0 and the output is 16-byte aligned, else one float a lane.
//
// K3 and K4 are one kernel, corr_bwd_kernel<kVec, kDcr>. A thread owns its 4
// pixels times 8 channels of the block's chunk, and each g value held in a
// register feeds 8 channels: 0.46 shared loads per FMA. A stage holds, per
// displacement row i, the chunk's feature rows (K3: cr at y + dy_i; K4: cl
// at y' - dy_i) with their halo, and the n g rows of the row. K3's pixel x
// reads column x + dx_j of cr and g at its own column. K4's pixel x' reads
// column x' - dx_j of cl and of g row (i, j); so K4 stages each g row from
// its own column window x' - dx_j, at slot position n - 1 - j, and its cl
// rows from column x' - dx_{n-1}: pixel x' at slot position m then reads
// window column x' + m * stride, as K3's does, and both share one inner loop.
// The offsets need not be symmetric (stride 3 with md 4: -4, -1, 2), so
// each kernel places its window from its own first offset. The sum over
// displacements keeps a fixed order and adds exact zeros for out-of-frame
// columns.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// a thread owns kPix pixels one stride apart and takes the displacements
// kDisp at a time; K3 and K4 give it kChan channels
constexpr int kPix = 4;
constexpr int kChan = 8;
constexpr int kDisp = 9;
constexpr int kMaxThreads = 256;
constexpr int kSmemLimit = 232448;  // 227 KB, the most a block may take

// Shared-memory index of column l of a staged row: stride % 32 floats of
// padding per 32 columns, so the lanes of a warp, which read columns
// x0 + m * stride for their pixel groups x0, hit distinct banks (for
// strides 1, 2, 4 and 8).
__host__ __device__ inline int padded(int l, int stride) { return l + (l >> 5) * (stride & 31); }

// floats of one staged row of `cols` columns, padding included
__host__ __device__ inline int row_pitch(int cols, int stride) {
  return padded(cols - 1, stride) + 1;
}

__host__ __device__ inline int round4(int floats) { return (floats + 3) / 4 * 4; }

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

// How the block's warps walk rows of up to `units` units: each warp takes
// 32 / units rows per pass where rows are shorter than a warp. One division
// per thread, none in the loops.
struct RowLanes {
  bool on;
  int first, next, u0, step;
};

__device__ __forceinline__ RowLanes row_lanes(int units) {
  const int lane = threadIdx.x & 31;
  const int per_pass = units >= 32 ? 1 : 32 / max(units, 1);
  const int rr = units >= 32 ? 0 : lane / max(units, 1);
  RowLanes rl;
  rl.on = units > 0 && rr < per_pass;
  rl.first = (threadIdx.x >> 5) * per_pass + rr;
  rl.next = (blockDim.x >> 5) * per_pass;
  rl.u0 = units >= 32 ? lane : lane - rr * units;
  rl.step = units >= 32 ? 32 : units;
  return rl;
}

// Copies `rows` rows of runs of kUnit values with the block's warps: row r
// stages cols(r).y units from src_row(r) at dst_row(r), from staged column
// cols(r).x on; `max_units` bounds cols(r).y.
template <int kUnit, typename SrcRow, typename DstRow, typename Cols>
__device__ __forceinline__ void stage_rows(SrcRow src_row, DstRow dst_row, Cols cols, int rows,
                                           int max_units, int stride) {
  const RowLanes rl = row_lanes(max_units);
  if (!rl.on) return;
  for (int r = rl.first; r < rows; r += rl.next) {
    const int2 c = cols(r);
    const auto* srow = src_row(r);
    float* drow = dst_row(r);
    for (int u = rl.u0; u < c.y; u += rl.step) {
      cp_async<kUnit>(drow + padded(c.x + u * kUnit, stride), srow + u * kUnit);
    }
  }
}

// The displacement rows i whose shifted row r0 + i * stride (r0 = the block's
// row minus md, in the rows read) lies in [0, rows): lo .. hi (hi < lo: none).
__device__ __forceinline__ int2 rows_in_frame(int r0, int rows, int stride, int n) {
  const int lo = r0 < 0 ? (-r0 + stride - 1) / stride : 0;
  const int last = rows - 1 - r0;  // the largest i * stride in the frame
  return make_int2(lo, last < 0 ? -1 : min(n - 1, last / stride));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// ---------------------------------------------------------------- K2

// K2's shared memory, in floats: the cl tile (chan_groups * per_group rows
// of cl_pitch), the stage slots (one per displacement row, each as many cr
// rows of cr_pitch), and from `part` on the channel groups' partial sums,
// chan_groups * rows_per_stage * n rows of part_pitch. The skews pad the
// channel rows and the slots against bank conflicts.
struct FwdLayout {
  int row_len, cl_pitch, cr_pitch, cl_area, slot, part, part_pitch, total;
};

__host__ __device__ inline FwdLayout fwd_layout(int tile_x, int n, int stride, int chan_groups,
                                                int per_group, int rows_per_stage, int skew,
                                                int slot_skew) {
  FwdLayout lay;
  const int chans = chan_groups * per_group;
  lay.row_len = tile_x + (n - 1) * stride;
  lay.cl_pitch = row_pitch(tile_x, stride) + skew;
  lay.cr_pitch = row_pitch(lay.row_len, stride) + skew;
  lay.cl_area = round4(chans * lay.cl_pitch);
  lay.slot = round4(chans * lay.cr_pitch) + slot_skew;
  lay.part = round4(lay.cl_area + rows_per_stage * lay.slot);
  lay.part_pitch = row_pitch(tile_x, stride);
  lay.total = lay.part + chan_groups * rows_per_stage * n * lay.part_pitch;
  return lay;
}

// grid (x tiles, H, B); block: tile_x / kPix pixel groups x rows_per_stage
// displacement rows x chan_groups channel groups of working threads, and
// more (up to a multiple of 32, at least 128) that stage and store;
// rows_per_stage displacement rows per stage, in one buffer.
// kVec: rows are staged 4 values at a time (stride, md and W multiples of
// 4, cl and cr aligned to 4 values). kVecOut: outputs go out 4 at a time (W
// a multiple of 4, out aligned to 4 values).
// At most 128 registers (two blocks of 256 threads, or four of 128, an SM):
// uncapped, K2 took 158-160 and levels 2-3 lost their fourth block an SM.
template <bool kVec, bool kVecOut>
__global__ void __launch_bounds__(kMaxThreads, 2)
corr_fwd_kernel(const float* __restrict__ cl, const float* __restrict__ cr,
                float* __restrict__ out, int channels, int height, int width, int cr_height,
                int row_offset, int md, int stride, int n, int tile_x, int rows_per_stage,
                int chan_groups, int skew, int slot_skew) {
  constexpr int kUnit = kVec ? 4 : 1;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int s = stride;
  const int per_group = (channels + chan_groups - 1) / chan_groups;
  const FwdLayout lay = fwd_layout(tile_x, n, s, chan_groups, per_group, rows_per_stage, skew,
                                   slot_skew);
  const int b = blockIdx.z;
  const int y = blockIdx.y;
  const int xt = blockIdx.x * tile_x;
  const int hw = height * width, hw_r = cr_height * width;
  const float* clb = cl + static_cast<size_t>(b) * channels * hw + y * width + xt;
  const float* crb = cr + static_cast<size_t>(b) * channels * hw_r;
  const int y0 = y + row_offset - md;  // cr's row of displacement row 0
  float* outb = out + static_cast<size_t>(b) * n * n * hw + y * width + xt;
  float* s_cl = smem;
  float* s_buf = smem + lay.cl_area;
  float* s_part = smem + lay.part;
  const int cl_pitch = lay.cl_pitch, cr_pitch = lay.cr_pitch, slot = lay.slot;
  const int part_pitch = lay.part_pitch;

  // the displacement rows i whose cr row y0 + i * s lies in cr's frame
  const int2 in_rows = rows_in_frame(y0, cr_height, s, n);
  const int i_lo = in_rows.x, i_hi = in_rows.y;
  const int in_frame = max(0, i_hi - i_lo + 1);
  // staged cr column l is frame column xt - md + l; on the kVec path l_lo,
  // l_hi and x_hi are multiples of 4
  const int l_lo = max(0, md - xt);
  const int l_hi = min(lay.row_len, width - xt + md);
  const int x_hi = min(tile_x, width - xt);

  // Zero the cl tile and the slots once, with float4 stores (faster than
  // zeroing only what staging never writes, one short row a warp); staging
  // then writes only in-frame columns and real channels, the same columns
  // of the same channels in every stage, so the frame's outside and the
  // channels past C read as 0 and no term is bounds-checked.
  for (int e = threadIdx.x; e < lay.part / 4; e += blockDim.x) {
    smem4[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();

  // the cl tile, in the first stage's copy group
  stage_rows<kUnit>([=](int r) { return clb + static_cast<size_t>(r) * hw; },
                    [=](int r) { return s_cl + r * cl_pitch; },
                    [=](int) { return make_int2(0, x_hi / kUnit); }, channels, x_hi / kUnit, s);

  // stage displacement rows i0 .. i0 + count - 1, one slot each
  auto stage = [&](int i0, int count) {
    for (int k = 0; k < count; ++k) {
      const float* cr_k = crb + ((y0 + (i0 + k) * s) * width + xt - md + l_lo);
      float* slot_k = s_buf + k * slot;
      stage_rows<kUnit>([=](int r) { return cr_k + static_cast<size_t>(r) * hw_r; },
                        [=](int r) { return slot_k + r * cr_pitch; },
                        [=](int) { return make_int2(l_lo, (l_hi - l_lo) / kUnit); }, channels,
                        (l_hi - l_lo) / kUnit, s);
    }
    cp_async_commit();
  };

  // Writes `rows` output rows of x_hi columns: row e is plane plane(e) of
  // this image row, and holds the sum of the chan_groups partial rows
  // part(e), part(e) + group_stride, ... in that order, over C (zeros where
  // part(e) is null).
  // With stride a multiple of 4, four columns 4u .. 4u + 3 of a padded row
  // are one aligned float4, and 8 lanes read 128 contiguous bytes: the
  // partial sums are read as float4.
  const int group_stride = rows_per_stage * n * lay.part_pitch;
  const float inv_c = 1.0f / static_cast<float>(channels);
  const bool part4 = (s & 3) == 0;
  auto scale = [&](float v) { return v * inv_c; };  // from a channel sum
  auto store = [&](int rows, auto plane, auto part) {
    const RowLanes rl = row_lanes(kVecOut ? x_hi / 4 : x_hi);
    if (!rl.on) return;
    for (int e = rl.first; e < rows; e += rl.next) {
      float* dst = outb + static_cast<size_t>(plane(e)) * hw;
      const float* src = part(e);
      auto value = [&](int x) {
        if (src == nullptr) return 0.0f;
        const float* col = src + padded(x, s);
        float v = col[0];
        for (int grp = 1; grp < chan_groups; ++grp) v += col[grp * group_stride];
        return scale(v);
      };
      if (kVecOut) {
        for (int u = rl.u0; u < x_hi / 4; u += rl.step) {
          const int x = 4 * u;
          float4 v4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (src != nullptr && part4) {
            const float4* col = reinterpret_cast<const float4*>(src + padded(x, s));
            v4 = col[0];
            for (int grp = 1; grp < chan_groups; ++grp) {
              const float4 p4 = col[grp * group_stride / 4];
              v4.x += p4.x;
              v4.y += p4.y;
              v4.z += p4.z;
              v4.w += p4.w;
            }
            v4 = make_float4(scale(v4.x), scale(v4.y), scale(v4.z), scale(v4.w));
          } else if (src != nullptr) {
            v4 = make_float4(value(x), value(x + 1), value(x + 2), value(x + 3));
          }
          *reinterpret_cast<float4*>(dst + x) = v4;
        }
      } else {
        for (int x = rl.u0; x < x_hi; x += rl.step) dst[x] = value(x);
      }
    }
  };

  // the displacement rows outside the frame: zero planes
  store((n - in_frame) * n,
        [=](int e) {
          const int zi = e / n;
          return (zi < i_lo ? zi : zi + in_frame) * n + (e - zi * n);
        },
        [](int) -> const float* { return nullptr; });

  // this thread: pixel group gi (pixels x0 + p * s), stage row r, channel
  // group cg (channels cg * per_group ..)
  const int groups = tile_x / kPix;
  const int t = threadIdx.x;
  const bool active = t < groups * rows_per_stage * chan_groups;
  const int gi = t % groups;
  const int r = (t / groups) % rows_per_stage;
  const int cg = t / (groups * rows_per_stage);
  const int x0 = (gi / s) * (kPix * s) + gi % s;
  int x_addr[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) x_addr[p] = padded(x0 + p * s, s);
  const float* s_l = s_cl + cg * per_group * cl_pitch;
  float* s_p = s_part + (cg * rows_per_stage + r) * n * part_pitch;

  // One buffer: the blocks that share the SM (four at levels 2 and 3)
  // compute while a block waits for its copies; at levels 2-3 this beat
  // double-buffering with fewer blocks per SM.
  const int per_stage = rows_per_stage;
  const int stages = (in_frame + per_stage - 1) / per_stage;
  if (stages > 0) {
    stage(i_lo, min(per_stage, in_frame));
  } else {
    cp_async_commit();
  }
  for (int k = 0; k < stages; ++k) {
    const int i0 = i_lo + k * per_stage;
    const int count = min(per_stage, i_hi - i0 + 1);
    cp_async_wait<0>();
    __syncthreads();
    if (active && r < count) {
      const float* s_cr = s_buf + r * slot + cg * per_group * cr_pitch;
      for (int j0 = 0; j0 < n; j0 += kDisp) {
        // the window of columns x0 + (j0 + m) * s feeds pixel p at
        // displacement j = m - p: kDisp + kPix - 1 loads for kDisp * kPix FMAs
        int w_addr[kDisp + kPix - 1];
#pragma unroll
        for (int m = 0; m < kDisp + kPix - 1; ++m) {
          w_addr[m] = padded(x0 + min(j0 + m, n + kPix - 2) * s, s);
        }
        float acc[kDisp][kPix];
#pragma unroll
        for (int j = 0; j < kDisp; ++j) {
#pragma unroll
          for (int p = 0; p < kPix; ++p) acc[j][p] = 0.0f;
        }
#pragma unroll 2
        for (int q = 0; q < per_group; ++q) {
          const float* row_l = s_l + q * cl_pitch;
          const float* row_r = s_cr + q * cr_pitch;
          float a[kPix], w[kDisp + kPix - 1];
#pragma unroll
          for (int p = 0; p < kPix; ++p) a[p] = row_l[x_addr[p]];
#pragma unroll
          for (int m = 0; m < kDisp + kPix - 1; ++m) w[m] = row_r[w_addr[m]];
#pragma unroll
          for (int j = 0; j < kDisp; ++j) {
#pragma unroll
            for (int p = 0; p < kPix; ++p) acc[j][p] = fmaf(a[p], w[p + j], acc[j][p]);
          }
        }
#pragma unroll
        for (int j = 0; j < kDisp; ++j) {
          if (j0 + j < n) {
#pragma unroll
            for (int p = 0; p < kPix; ++p) s_p[(j0 + j) * part_pitch + x_addr[p]] = acc[j][p];
          }
        }
      }
    }
    __syncthreads();
    // the channel groups' partial sums, added in group order, out as rows
    // (partial row e of group 0 is stage row e / n, displacement e % n)
    store(count * n, [=](int e) { return i0 * n + e; },
          [=](int e) -> const float* { return s_part + e * part_pitch; });
    // every warp read the slots before the barrier above: restage them
    if (k + 1 < stages) stage(i0 + per_stage, min(per_stage, i_hi - i0 - per_stage + 1));
  }
  cp_async_wait<0>();
}

// ------------------------------------------------------------ K3 and K4

// K3's and K4's shared-memory layout. A slot holds one displacement row's
// staging: chans / kChan channel blocks of kChan feature rows (tile_x +
// (n - 1) * stride columns each), the blocks cb_skew floats apart beyond
// their rows so that the lanes of different channel blocks spread over the
// banks, then n g rows of tile_x. A buffer holds rows_per_stage slots; with
// two buffers the next stage's copy runs under this stage's FMAs.
struct BwdLayout {
  int row_len, feat_pitch, cb_pitch, g_pitch, slot, buffer;
};

__host__ __device__ inline BwdLayout bwd_layout(int tile_x, int chan_blocks, int n, int stride,
                                                int cb_skew, int rows_per_stage) {
  BwdLayout lay;
  lay.row_len = tile_x + (n - 1) * stride;
  lay.feat_pitch = row_pitch(lay.row_len, stride);
  lay.cb_pitch = kChan * lay.feat_pitch + cb_skew;
  lay.g_pitch = row_pitch(tile_x, stride);
  lay.slot = round4(chan_blocks * lay.cb_pitch + n * lay.g_pitch);  // float4-aligned
  lay.buffer = rows_per_stage * lay.slot;
  return lay;
}

// grid (x tiles, H, B * channel chunks); block: chan_blocks * tile_x / kPix
// working threads, and more (up to a multiple of 32) that only stage;
// chan_blocks * kChan channels; rows_per_stage displacement rows per stage,
// in `buffers` (1 or 2) buffers. kDcr: K4 (feat = cl, out = dcr), else K3
// (feat = cr, out = dcl). kVec: the rows are staged 4 values at a time
// (stride, md and W multiples of 4, g and feat aligned to 4 values).
template <bool kVec, bool kDcr>
__global__ void __launch_bounds__(kMaxThreads, 2)
corr_bwd_kernel(const float* __restrict__ g, const float* __restrict__ feat,
                float* __restrict__ dfeat, int channels, int height, int width,
                int cr_height, int row_offset, int md, int stride, int n, int tile_x,
                int chan_blocks, int cb_skew, int rows_per_stage, int buffers) {
  constexpr int kUnit = kVec ? 4 : 1;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int s = stride;
  const int chans = chan_blocks * kChan;
  const BwdLayout lay = bwd_layout(tile_x, chan_blocks, n, s, cb_skew, rows_per_stage);
  const int chunks = (channels + chans - 1) / chans;
  const int b = blockIdx.z / chunks;
  const int c0 = (blockIdx.z - b * chunks) * chans;
  const int y = blockIdx.y;  // K3: a row of cl and g; K4: a row of cr
  const int xt = blockIdx.x * tile_x;
  const int hw = height * width, hw_r = cr_height * width;
  // the feature rows (K3: cr's, K4: cl's) and the output rows (K3: dcl's, K4: dcr's)
  const int hw_f = kDcr ? hw : hw_r, hw_o = kDcr ? hw_r : hw;
  const float* gb = g + static_cast<size_t>(b) * n * n * hw + xt;
  const float* fb = feat + (static_cast<size_t>(b) * channels + c0) * hw_f;

  // Zero the buffers once. Staging then writes only in-frame columns and
  // real channels, the same set for every displacement row, so the frame's
  // outside and the channels past C read as 0 and no term is bounds-checked.
  for (int e = threadIdx.x; e < buffers * lay.buffer / 4; e += blockDim.x) {
    smem4[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();

  // the displacement rows i whose feature row lies in its frame: K3's cr row
  // y + row_offset - md + i * s in [0, cr_height); K4's cl row
  // y - row_offset + md - i * s in [0, height), i.e. the row
  // (height - 1) - that, y1 + i * s with y1 as below, in [0, height)
  const int y1 = kDcr ? height - 1 - (y - row_offset + md) : y + row_offset - md;
  const int2 in_rows = rows_in_frame(y1, kDcr ? height : cr_height, s, n);
  const int i_lo = in_rows.x, i_hi = in_rows.y;
  // staged feature column l is frame column xt - lead + l: K3's pixel x
  // reads x + o_j from x + o_0 on (lead md), K4's pixel x' reads x' - o_j
  // from x' - o_{n-1} on (lead o_{n-1}); on the kVec path lead, l_lo, l_hi
  // and x_hi are multiples of 4
  const int lead = kDcr ? (n - 1) * s - md : md;
  const int l_lo = max(0, lead - xt);
  const int l_hi = min(lay.row_len, width - xt + lead);
  const int x_hi = min(tile_x, width - xt);
  const int c_hi = min(chans, channels - c0);
  const int feat_pitch = lay.feat_pitch, cb_pitch = lay.cb_pitch, g_pitch = lay.g_pitch;
  const int slot = lay.slot;

  // stage displacement rows i0 .. i0 + count - 1 into `buffer`, one slot each
  auto stage = [&](int i0, int count, float* buffer) {
    for (int k = 0; k < count; ++k) {
      const int i = i0 + k;
      const int row = kDcr ? y - row_offset + md - i * s : y1 + i * s;
      const float* f_k = fb + (row * width + xt - lead + l_lo);
      float* slot_k = buffer + k * slot;
      float* g_slot = slot_k + chan_blocks * cb_pitch;
      stage_rows<kUnit>(
          [=](int r) { return f_k + static_cast<size_t>(r) * hw_f; },
          [=](int r) { return slot_k + (r / kChan) * cb_pitch + (r % kChan) * feat_pitch; },
          [=](int) { return make_int2(l_lo, (l_hi - l_lo) / kUnit); }, c_hi,
          (l_hi - l_lo) / kUnit, s);
      if (kDcr) {
        // g row (i, j) at the cl row, in slot position m = n - 1 - j, from
        // frame column x' - o_j: staged column x holds column xt + x - o_j
        const float* g_k = gb + static_cast<size_t>(i) * n * hw + row * width;
        stage_rows<kUnit>(
            [=](int m) {
              const int j = n - 1 - m, o = j * s - md;
              return g_k + static_cast<size_t>(j) * hw - o + max(0, o - xt);
            },
            [=](int m) { return g_slot + m * g_pitch; },
            [=](int m) {
              const int o = (n - 1 - m) * s - md;
              const int lo = max(0, o - xt), hi = min(x_hi, width - xt + o);
              return make_int2(lo, max(0, hi - lo) / kUnit);
            },
            n, x_hi / kUnit, s);
      } else {
        // g rows (i, j) of the block's own row, in slot position j
        const float* g_k = gb + static_cast<size_t>(i) * n * hw + y * width;
        stage_rows<kUnit>([=](int m) { return g_k + static_cast<size_t>(m) * hw; },
                          [=](int m) { return g_slot + m * g_pitch; },
                          [=](int) { return make_int2(0, x_hi / kUnit); }, n, x_hi / kUnit, s);
      }
    }
    cp_async_commit();
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
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int row = 0; active && row < count; ++row) {
      const float* s_f = cur + row * slot + cb * cb_pitch;
      const float* s_g = cur + row * slot + chan_blocks * cb_pitch;
      for (int j0 = 0; j0 < n; j0 += kDisp) {
        // g of this thread's pixels for slot positions j0 .. j0 + kDisp - 1
        float gv[kDisp][kPix];
#pragma unroll
        for (int j = 0; j < kDisp; ++j) {
          const bool on = j0 + j < n;
          const int jj = on ? j0 + j : n - 1;
#pragma unroll
          for (int p = 0; p < kPix; ++p) gv[j][p] = on ? s_g[jj * g_pitch + g_addr[p]] : 0.0f;
        }
        // the window of columns x0 + (j0 + m) * s feeds pixel p at slot
        // position j = m - p: kDisp + kPix - 1 loads for kDisp * kPix FMAs
        int w_addr[kDisp + kPix - 1];
#pragma unroll
        for (int m = 0; m < kDisp + kPix - 1; ++m) {
          w_addr[m] = padded(x0 + min(j0 + m, n + kPix - 2) * s, s);
        }
#pragma unroll
        for (int q = 0; q < kChan; ++q) {
          const float* row_q = s_f + q * feat_pitch;
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
  const RowLanes rl = row_lanes(x_hi);
  if (!rl.on) return;
  float* out = dfeat + (static_cast<size_t>(b) * channels + c0) * hw_o + y * width + xt;
  for (int r = rl.first; r < c_hi; r += rl.next) {
    for (int x = rl.u0; x < x_hi; x += rl.step) {
      out[static_cast<size_t>(r) * hw_o + x] =
          smem[r * g_pitch + padded(x, s)] / static_cast<float>(channels);
    }
  }
}

int displacements(int md, int stride) { return 2 * md / stride + 1; }

// the 4-value vector paths need 16-byte alignment
bool aligned4(const float* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Opts in above the default 48 KB of dynamic shared memory, then launches.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int threads, int smem_bytes, void* stream, Args... args) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// K3 (kDcr false) or K4 (true): checks the plan, picks the staging width and
// launches.
template <bool kDcr>
int corr_bwd(const float* g, const float* feat, float* dfeat, int batch, int channels,
             int height, int width, int cr_height, int row_offset, int md, int stride,
             int tile_x, int chan_blocks, int cb_skew, int rows_per_stage, int buffers,
             int threads, int smem_bytes, void* stream) {
  // the output's rows: K3 dcl's (height), K4 dcr's (cr_height)
  const int out_rows = kDcr ? cr_height : height;
  if (static_cast<long long>(batch) * channels * out_rows * width == 0) {
    return static_cast<int>(cudaSuccess);
  }
  if (tile_x <= 0 || stride <= 0 || md < 0 || chan_blocks <= 0 || height < 0
      || cr_height < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n = displacements(md, stride);
  const int chans = chan_blocks * kChan;
  const int chunks = (channels + chans - 1) / chans;
  if (rows_per_stage < 1 || rows_per_stage > n || (buffers != 1 && buffers != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BwdLayout lay = bwd_layout(tile_x, chan_blocks, n, stride, cb_skew, rows_per_stage);
  const long long want = static_cast<long long>(buffers) * lay.buffer * sizeof(float);
  if (tile_x % (kPix * stride) != 0 || cb_skew < 0 || cb_skew >= 32
      || (stride % 4 == 0 && cb_skew % 4 != 0) || threads % 32 != 0 || threads > kMaxThreads
      || threads < chan_blocks * (tile_x / kPix) || smem_bytes != want
      || smem_bytes > kSmemLimit || out_rows > 65535
      || static_cast<long long>(batch) * chunks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = stride % 4 == 0 && md % 4 == 0 && width % 4 == 0 && aligned4(g)
                   && aligned4(feat);
  const auto kernel = vec ? corr_bwd_kernel<true, kDcr> : corr_bwd_kernel<false, kDcr>;
  const dim3 grid((width + tile_x - 1) / tile_x, out_rows, batch * chunks);
  return launch(kernel, grid, threads, smem_bytes, stream, g, feat, dfeat, channels, height,
                width, cr_height, row_offset, md, stride, n, tile_x, chan_blocks, cb_skew,
                rows_per_stage, buffers);
}

// K2: checks the plan, picks the staging and store widths and launches.
int corr_fwd(const float* cl, const float* cr, float* out, int batch, int channels, int height,
             int width, int cr_height, int row_offset, int md, int stride, int tile_x,
             int rows_per_stage, int chan_groups, int skew, int slot_skew, int threads,
             int smem_bytes, void* stream) {
  if (static_cast<long long>(batch) * height * width == 0) return static_cast<int>(cudaSuccess);
  if (tile_x <= 0 || stride <= 0 || md < 0 || channels <= 0 || chan_groups <= 0
      || chan_groups > channels || cr_height < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n = displacements(md, stride);
  const int per_group = (channels + chan_groups - 1) / chan_groups;
  if (rows_per_stage < 1 || rows_per_stage > n || (chan_groups - 1) * per_group >= channels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FwdLayout lay = fwd_layout(tile_x, n, stride, chan_groups, per_group, rows_per_stage,
                                   skew, slot_skew);
  const long long want = static_cast<long long>(lay.total) * sizeof(float);
  const long long working = static_cast<long long>(tile_x / kPix) * rows_per_stage * chan_groups;
  const int skew_step = stride % 4 == 0 ? 4 : 1;
  if (tile_x % (kPix * stride) != 0 || skew < 0 || skew >= 32 || skew % skew_step != 0
      || slot_skew < 0 || slot_skew >= 32 || slot_skew % skew_step != 0 || threads % 32 != 0
      || threads > kMaxThreads || threads < working || smem_bytes != want
      || smem_bytes > kSmemLimit || height > 65535 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = stride % 4 == 0 && md % 4 == 0 && width % 4 == 0 && aligned4(cl)
                   && aligned4(cr);
  const bool vec_out = width % 4 == 0 && aligned4(out);
  const auto kernel = vec ? (vec_out ? corr_fwd_kernel<true, true> : corr_fwd_kernel<true, false>)
                          : (vec_out ? corr_fwd_kernel<false, true>
                                     : corr_fwd_kernel<false, false>);
  const dim3 grid((width + tile_x - 1) / tile_x, height, batch);
  return launch(kernel, grid, threads, smem_bytes, stream, cl, cr, out, channels, height, width,
                cr_height, row_offset, md, stride, n, tile_x, rows_per_stage, chan_groups, skew,
                slot_skew);
}

}  // namespace

// cl [B,C,H,W], cr [B,C,H_r,W] (H_r = cr_height; row_offset: cl's first
// global row minus cr's, 0 with H_r = H for the whole frame); writes out
// [B,n^2,H,W] with n = 2 * md / stride + 1; all float32, contiguous, on the
// current device. The tiling comes from the
// wrapper's plan (ops/kernels/correlation.py::fwd_plan): tile_x (a multiple
// of 4 * stride), rows_per_stage (1..n), chan_groups (1..C, none empty),
// skew and slot_skew (0-31; multiples of 4 where stride is), threads (a
// multiple of 32, at least the working threads, at most 256) and
// smem_bytes, which must equal this layout and fit 227 KB. Stages 16 bytes
// at a time where stride, md and W are multiples of 4 and cl and cr are
// 16-byte aligned; stores float4 where W is a multiple of 4 and out is
// 16-byte aligned. Launches K2 on `stream` and returns cudaGetLastError(),
// or cudaErrorInvalidValue for a plan that does not match.
extern "C" int xpt_corr_fwd(const float* cl, const float* cr, float* out,
                            int batch, int channels, int height, int width, int cr_height,
                            int row_offset, int md, int stride, int tile_x, int rows_per_stage,
                            int chan_groups, int skew, int slot_skew, int threads,
                            int smem_bytes, void* stream) {
  return corr_fwd(cl, cr, out, batch, channels, height, width, cr_height, row_offset, md, stride,
                  tile_x, rows_per_stage, chan_groups, skew, slot_skew, threads, smem_bytes,
                  stream);
}

// g [B,n^2,H,W] (the cotangent of K2's output), cr [B,C,H_r,W] (cr_height
// and row_offset as for xpt_corr_fwd); writes dcl [B,C,H,W]. The tiling comes from the wrapper's plan
// (ops/kernels/correlation.py::bwd_plan): tile_x (a multiple of
// 4 * stride), chan_blocks (blocks of 8 channels per CUDA block), cb_skew
// (0-31; a multiple of 4 where stride is), rows_per_stage (1..n), buffers
// (1 or 2), threads (a multiple of 32, at least chan_blocks * tile_x / 4, at
// most 256) and smem_bytes, which must equal this layout's buffers and fit
// 227 KB. Stages 16 bytes at a time where stride, md and W are multiples of
// 4 and g and cr are 16-byte aligned. Launches K3 on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a plan that does not
// match.
extern "C" int xpt_corr_bwd_cl(const float* g, const float* cr, float* dcl,
                               int batch, int channels, int height, int width, int cr_height,
                               int row_offset, int md, int stride, int tile_x, int chan_blocks,
                               int cb_skew, int rows_per_stage, int buffers, int threads,
                               int smem_bytes, void* stream) {
  return corr_bwd<false>(g, cr, dcl, batch, channels, height, width, cr_height, row_offset, md,
                         stride, tile_x, chan_blocks, cb_skew, rows_per_stage, buffers, threads,
                         smem_bytes, stream);
}

// g [B,n^2,H,W], cl [B,C,H,W]; writes dcr [B,C,H_r,W] (cr_height and
// row_offset as for xpt_corr_fwd: on a band, this band's share of the
// gradient of cr's H_r rows). The same plan and checks as xpt_corr_bwd_cl
// (one plan serves both). Launches K4 on `stream`.
extern "C" int xpt_corr_bwd_cr(const float* g, const float* cl, float* dcr,
                               int batch, int channels, int height, int width, int cr_height,
                               int row_offset, int md, int stride, int tile_x, int chan_blocks,
                               int cb_skew, int rows_per_stage, int buffers, int threads,
                               int smem_bytes, void* stream) {
  return corr_bwd<true>(g, cl, dcr, batch, channels, height, width, cr_height, row_offset, md,
                        stride, tile_x, chan_blocks, cb_skew, rows_per_stage, buffers, threads,
                        smem_bytes, stream);
}
