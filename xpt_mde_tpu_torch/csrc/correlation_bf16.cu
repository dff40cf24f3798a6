// K2-bf16, K3-bf16 and K4-bf16: the PWC-Net cost volume and the gradients
// of its left and right features on bfloat16 operands, CUDA C++ for Hopper
// (sm_90a).
//
// K2-bf16 replaces the Pallas TPU kernel xpt_mde_tpu/ops/pallas/
// correlation.py::_corr_kernel (:68, launched by _corr_forward), K3-bf16
// _corr_grad_cl_kernel (:88, launched by _bwd_dcl_spmd) and K4-bf16
// _corr_grad_cr_kernel (:119, launched by _bwd_dcr_spmd), all as the JAX
// package runs them at its default compute dtype: bfloat16 operands, each
// read as float32, products summed in float32, the sum divided by C and
// rounded once to bfloat16 (round to nearest even). With offsets
// o_i = -md + i * stride (i < n, n = 2 * md / stride + 1), NCHW:
//
//   K2  out[b,i*n+j,y,x]  = bf16((sum_c cl[b,c,y,x] * cr[b,c,y+o_i,x+o_j]) / C)
//   K3  dcl[b,c,y,x]      = bf16((sum_{i,j} g[b,i*n+j,y,x] * cr[b,c,y+o_i,x+o_j]) / C)
//   K4  dcr[b,c,y',x']    = bf16((sum_{i,j} g[b,i*n+j,y'-o_i,x'-o_j]
//                                           * cl[b,c,y'-o_i,x'-o_j]) / C)
//
// where a term whose shifted position lies outside the frame is zero. On a
// spatial mesh's band cl and g hold h rows and cr its own H_r rows,
// row_offset = cl's first global row minus cr's: cl's row y meets cr's row
// y + row_offset + o_i, the frame is cr's [0, H_r) (cr's tensor map has H_r
// rows, so TMA's zero fill is that frame's outside, above it too), and K4
// writes dcr over cr's H_r rows. row_offset 0 with H_r = h is the whole
// frame. The plain versions xpt_mde_tpu_torch/ops/correlation.py::correlation_cost_plain,
// correlation_grad_cl_plain and correlation_grad_cr_plain, up to the order
// of the float32 sums. Every sum has a fixed order and nothing is added
// atomically: the same inputs give the same bits on every run and on every
// staging path.
//
// What bounds them on this card. Bytes at levels 2-3 (level 2, 32 pairs:
// K2 38 MB of bfloat16 in and out, 11.3 us at 3.35 TB/s; K3 and K4 25 MB,
// 7.4 us, as they need g only at the in-frame terms, as chip_smoke.py's
// bound counts them); at levels 4-6 latency and the size of the grid (64
// to 256 image rows of work, a copy round trip and a few barriers each).
// The arithmetic is not the bound: products of two bfloat16 values are
// exact in float32, so the tensor cores take it (mma.sync m16n8k16,
// bfloat16 in, float32 accumulators), and the cost left is feeding them
// from shared memory.
//
// The design, for the three kernels:
// - a block owns one image row and a tile of columns (K2: and a group of
//   displacement rows; K3 and K4: and a chunk of channels), and stages the
//   rows it needs as raw bfloat16 in shared memory: one TMA box ([W, H, C,
//   B] tensor maps from cuTensorMapEncodeTiled, looked up in libcuda.so.1
//   at run time, so the library links no -lcuda) per staged row, completing
//   on an mbarrier.
//   A box starts at a multiple of 8 columns (16 bytes; a box starting
//   elsewhere in its row faults), so a window is staged from the multiple
//   of 8 at or left of its first column and read 0-7 columns on. A box
//   may start left of the frame or run past it, and past the last
//   channel: the hardware writes zeros there, which is the frame's outside,
//   so no term is bounds-checked and there is no zeroing pass. Rows are
//   staged with an odd number of 16-byte units of pitch, which spreads the
//   lanes' gathers over the banks. Shapes TMA cannot take (W % 8 != 0, an
//   operand not 16-byte aligned, a box over 256 columns) are staged by the
//   block's threads into the same layout, zeros included, and run the same
//   compute in the same order: their results are the same bits;
// - the work is cut by residue class of x mod stride: pixels x = cls +
//   stride * p of one class see window columns cls + stride * q, so a class
//   turns into a stride-1 problem over p and q. 16 pixels of a class and 9
//   displacements (n > 9: 9 at a time) make one band product:
//   K2: D[p, q] = sum_c cl[c, p] * cr_i[c, q], a 16 x 24 product of which the
//     9 diagonals q - p = j are the outputs: per 16 channels one A fragment
//     and three n8 tiles;
//   K3: D[c, p] = sum_q cr_i[c, q] * G[q, p] with G[q, p] = g[(i, m)] at
//     the pixel's own column p where m = q - p lies in the band, else 0;
//   K4: D[c, p] = sum_q cl_r[c, q] * G[q, p] with G[q, p] = g[(i, n-1-m)]
//     at window column q where m = q - p lies in the band, else 0;
//   K3 and K4: per 16 channels and 8 pixels one m16n8k16 over 16 window
//     columns, the B fragment built by each thread from the staged g;
//   a warp owns one such tile (its fragments gathered from the staged rows
//   as pairs of bfloat16), and the float32 accumulators go out through
//   shared memory as whole rows, 16 bytes a lane where W % 8 == 0;
// - K2 holds a group of at most kFwdRows in-frame displacement rows at once
//   and takes the channels outermost, so one A fragment feeds every row of
//   the group; K3 and K4 accumulate all in-frame rows in registers and
//   stage them kRowsPerStage at a time, each row on its own mbarrier so
//   that the first rows' MMAs start while the last ones are still in
//   flight. K4 stages the n g rows of each displacement row with its cl
//   row, over the window; K3 reads g only at its own image row and stages
//   the g rows of its in-frame displacement rows once, over the tile, on a
//   barrier of their own (g of an out-of-frame row is never read);
// - the grid has at least two blocks an SM at every PWC level: K2 splits
//   the displacement rows into groups (a group with no in-frame row writes
//   zero planes), K3 and K4 the channels into chunks;
// - the launch plans are Python (ops/kernels/correlation.py::fwd_plan_bf16,
//   bwd_cl_plan_bf16 and bwd_cr_plan_bf16), so CPU tests check them and an
//   emulation of the band products; each entry recomputes the layout and
//   refuses a plan that does not match.
//
// The last step keeps the JAX kernel's: the float32 sum divided by C,
// rounded to nearest (div_rn gives the division's bits without its slow
// path), then __float2bfloat16_rn.

#include <cstdint>

#include <dlfcn.h>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using u16 = unsigned short;

constexpr int kTileP = 16;        // pixels of one residue class in a tile
constexpr int kJ = 9;             // displacements one band product takes
constexpr int kFwdRows = 4;       // K2: in-frame displacement rows a block holds
constexpr int kGroupBlocks = 4;   // K3, K4: 16-channel blocks one warp accumulates
constexpr int kRowsPerStage = 4;  // K3, K4: rows one stage holds at most
constexpr int kMaxWarps = 8;      // one tile a warp; at most 80 registers a thread, so
                                  // three blocks of 8 warps fit an SM
constexpr int kSmemLimit = 232448;
constexpr int kBoxMax = 256;      // a TMA box is at most 256 elements a dimension

// Elements of one staged row of `cols` columns: whole 16-byte units (TMA
// writes boxes densely, 16-byte rows), an odd count of them.
__host__ __device__ inline int stage_pitch(int cols) {
  const int units = (cols + 7) / 8;
  return (units | 1) * 8;
}

__host__ __device__ inline int align128(int bytes) { return (bytes + 127) / 128 * 128; }

// band products over the displacements, kJ at a time
__host__ __device__ inline int disp_chunks(int n) { return (n + kJ - 1) / kJ; }

// staged columns of a row: the tile and the window the last chunk reads,
// and up to 7 more on the left, as a row's box starts at a multiple of 8
// columns (a TMA box must start 16-byte aligned in its row)
__host__ __device__ inline int window_cols(int tile_x, int stride, int n) {
  return tile_x + stride * (kJ * disp_chunks(n) - 1) + 7;
}

// how far frame column `col` lies right of the multiple of 8 at or left of it
__host__ __device__ inline int lead8(int col) { return ((col % 8) + 8) % 8; }

__host__ __device__ inline int rows_max(int n, int stride, int height) {
  const int h = (height + stride - 1) / stride;
  return n < h ? n : h;
}

// The displacement rows i whose shifted row r0 + i * stride (r0 = the
// block's row minus md, in the rows read) lies in [0, rows): lo .. hi (hi <
// lo: none). At most rows_max(n, stride, rows) of them.
__device__ __forceinline__ int2 rows_in_frame(int r0, int rows, int stride, int n) {
  const int lo = r0 < 0 ? (-r0 + stride - 1) / stride : 0;
  const int last = rows - 1 - r0;  // the largest i * stride in the frame
  return make_int2(lo, last < 0 ? -1 : min(n - 1, last / stride));
}

// K2 stages all channels of a row, rounded up to 16, as `count` boxes of
// `box` channels (each at most 256, a multiple of 8).
struct ChanBoxes {
  int box, count;
};

__host__ __device__ inline ChanBoxes chan_boxes(int channels) {
  const int padded = (channels + 15) / 16 * 16;
  const int count = (padded + kBoxMax - 1) / kBoxMax;
  return {((padded + count - 1) / count + 7) / 8 * 8, count};
}

// K3 stages the planes of its g tile as `count` boxes of `box` planes (each
// at most 256, a multiple of 8: each box starts 128-byte aligned).
__host__ __device__ inline ChanBoxes plane_boxes(int planes) {
  const int count = (planes + kBoxMax - 1) / kBoxMax;
  return {((planes + count - 1) / count + 7) / 8 * 8, count};
}

// K2's shared memory: the cl tile [chans][cl_pitch], then `rows` cr rows
// [chans][row_pitch]; after the MMAs the rows' region holds the float32
// sums [rows * n][part_pitch]. `total` includes 128 bytes to align the base.
struct FwdLayout {
  int chans, cl_pitch, row_pitch, part_pitch, rows, cl_bytes, row_bytes, total;
};

__host__ __device__ inline FwdLayout fwd_layout(int channels, int height, int stride, int n,
                                                int tile_x, int groups) {
  FwdLayout lay;
  const ChanBoxes cb = chan_boxes(channels);
  lay.chans = cb.box * cb.count;
  lay.cl_pitch = stage_pitch(tile_x);
  lay.row_pitch = stage_pitch(window_cols(tile_x, stride, n));
  lay.part_pitch = tile_x + 4;
  lay.rows = (rows_max(n, stride, height) + groups - 1) / groups;
  lay.cl_bytes = lay.chans * lay.cl_pitch * 2;
  lay.row_bytes = lay.chans * lay.row_pitch * 2;
  const int rows_bytes = lay.rows * lay.row_bytes;
  const int part_bytes = align128(lay.rows * n * lay.part_pitch * 4);
  lay.total = 128 + lay.cl_bytes + (rows_bytes > part_bytes ? rows_bytes : part_bytes);
  return lay;
}

// K4's shared memory: `rows` slots, each the chunk's cl row [chans][pitch]
// and the n g rows (i, 0..n-1) [n][pitch] of one displacement row; after
// the MMAs the float32 sums [chans][part_pitch].
struct BwdLayout {
  int chans, pitch, part_pitch, cl_bytes, g_bytes, slot, total;
};

__host__ __device__ inline BwdLayout bwd_layout(int stride, int n, int tile_x, int chan_blocks,
                                                int rows) {
  BwdLayout lay;
  lay.chans = chan_blocks * 16;
  lay.pitch = stage_pitch(window_cols(tile_x, stride, n));
  lay.part_pitch = tile_x + 4;
  lay.cl_bytes = lay.chans * lay.pitch * 2;
  lay.g_bytes = align128(n * lay.pitch * 2);
  lay.slot = lay.cl_bytes + lay.g_bytes;
  const int part_bytes = align128(lay.chans * lay.part_pitch * 4);
  lay.total = 128 + (rows * lay.slot > part_bytes ? rows * lay.slot : part_bytes);
  return lay;
}

// K3's shared memory: the g tile [g_planes][g_pitch] (the n g rows of each
// displacement row that can lie in the frame, rows_max of them, from the
// block's first in-frame row on: as plane_boxes stages them, over the
// tile's columns), then `rows` slots of the chunk's cr row [chans][pitch];
// after the MMAs the float32 sums [chans][part_pitch].
struct BwdClLayout {
  int chans, pitch, g_pitch, g_planes, g_bytes, row_bytes, part_pitch, total;
};

__host__ __device__ inline BwdClLayout bwd_cl_layout(int stride, int n, int tile_x,
                                                     int chan_blocks, int rows, int height) {
  BwdClLayout lay;
  const ChanBoxes planes = plane_boxes(rows_max(n, stride, height) * n);
  lay.chans = chan_blocks * 16;
  lay.pitch = stage_pitch(window_cols(tile_x, stride, n));
  lay.g_pitch = stage_pitch(tile_x);
  lay.g_planes = planes.box * planes.count;
  lay.g_bytes = align128(lay.g_planes * lay.g_pitch * 2);
  lay.row_bytes = lay.chans * lay.pitch * 2;
  lay.part_pitch = tile_x + 4;
  const int staged = lay.g_bytes + rows * lay.row_bytes;
  const int part_bytes = align128(lay.chans * lay.part_pitch * 4);
  lay.total = 128 + (staged > part_bytes ? staged : part_bytes);
  return lay;
}

// ------------------------------------------------------------ device helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the one arrival of the phase, and the bytes its copies will bring
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// generic-proxy accesses before, TMA writes after
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One TMA box of a [W, H, planes, B] map to shared memory, from element
// (x, y, plane, b); completes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y, int plane,
                                         int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(plane), "r"(b),
      "r"(smem_addr(bar))
      : "memory");
}

// Stages `rows` rows of `pitch` columns, from frame column col0 of the
// rows src, src + plane, ... into dst (row pitch `pitch`), with zeros
// outside [0, width) and from row `valid` on: what a TMA box writes.
__device__ void stage_plain(u16* dst, const u16* src, size_t plane, int rows, int valid,
                            int pitch, int col0, int width) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < rows; r += warps) {
    const u16* s = src + static_cast<size_t>(r) * plane;
    u16* d = dst + r * pitch;
    for (int w = lane; w < pitch; w += 32) {
      const int col = col0 + w;
      d[w] = (r < valid && col >= 0 && col < width) ? s[col] : u16(0);
    }
  }
}

// two bfloat16 (their bits), the first in the low half: one fragment register
__device__ __forceinline__ uint32_t pack(u16 lo, u16 hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// d += a * b over one m16n8k16 tile, bfloat16 in, float32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ u16 to_bf16(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// v / c rounded to nearest, as the division rounds it, from rc = 1 / c
// rounded to nearest: q = v * rc, then one FMA correction with the exact
// remainder v - q * c (Markstein's theorem). The division itself takes its
// slow path for the many exact zeros (sums over the frame's outside), which
// cost a third of K2's time at level 2. v is never -0 (the sums start at
// +0), where this gives +0.
__device__ __forceinline__ float div_rn(float v, float c, float rc) {
  const float q = __fmul_rn(v, rc);
  return __fmaf_rn(__fmaf_rn(-q, c, v), rc, q);
}

// How the block's warps walk rows of up to `units` units: each warp takes
// 32 / units rows per pass where rows are shorter than a warp.
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

// Writes `rows` output rows of x_hi values, row e at dst + e * plane: the
// float32 sums src + e * pitch divided by C (div_rn) and rounded once to
// bfloat16, or zeros where src is null. 8 values (16 bytes) a lane where
// `vec`.
__device__ void store_rows(u16* dst, size_t plane, int rows, const float* src, int pitch,
                           int x_hi, bool vec, float c) {
  const float rc = __frcp_rn(c);
  const int units = vec ? x_hi / 8 : x_hi;
  const RowLanes rl = row_lanes(units);
  if (!rl.on) return;
  for (int e = rl.first; e < rows; e += rl.next) {
    u16* d = dst + static_cast<size_t>(e) * plane;
    const float* s = src == nullptr ? nullptr : src + e * pitch;
    for (int u = rl.u0; u < units; u += rl.step) {
      if (vec) {
        uint4 v = make_uint4(0, 0, 0, 0);
        if (s != nullptr) {
          const float4 lo = *reinterpret_cast<const float4*>(s + 8 * u);
          const float4 hi = *reinterpret_cast<const float4*>(s + 8 * u + 4);
          v.x = pack(to_bf16(div_rn(lo.x, c, rc)), to_bf16(div_rn(lo.y, c, rc)));
          v.y = pack(to_bf16(div_rn(lo.z, c, rc)), to_bf16(div_rn(lo.w, c, rc)));
          v.z = pack(to_bf16(div_rn(hi.x, c, rc)), to_bf16(div_rn(hi.y, c, rc)));
          v.w = pack(to_bf16(div_rn(hi.z, c, rc)), to_bf16(div_rn(hi.w, c, rc)));
        }
        *reinterpret_cast<uint4*>(d + 8 * u) = v;
      } else {
        d[u] = s == nullptr ? u16(0) : to_bf16(div_rn(s[u], c, rc));
      }
    }
  }
}

// A K3 or K4 warp's float32 accumulators: kGroupBlocks 16-channel blocks x
// two n8 pixel tiles, one m16n8 fragment each.
using BwdAcc = float[kGroupBlocks][2][4];

// One 16-column step of a K3 or K4 warp's band products: A is the staged
// feature row s_f (row pitch `pitch`), channel rows gq and gq + 8 of each
// of the warp's `blocks` 16-channel blocks (16 (kGroupBlocks grp + q) on);
// pixel tile 0 takes window columns wa + s kk for kk = 0, 1, 8, 9 (wa: the
// lane's kk = 2 tig), tile 1 slides 8 columns on; B is the lane's bf.
__device__ __forceinline__ void band_mma(BwdAcc& acc, const u16* s_f, int pitch, int wa, int s,
                                         int grp, int blocks, int gq,
                                         const uint32_t (&bf)[2][2]) {
#pragma unroll
  for (int q = 0; q < kGroupBlocks; ++q) {
    if (q < blocks) {
      const u16* pa = s_f + (16 * (kGroupBlocks * grp + q) + gq) * pitch + wa;
      const u16* pc = pa + 8 * pitch;
      const uint32_t a0 = pack(pa[0], pa[s]);
      const uint32_t a1 = pack(pc[0], pc[s]);
      const uint32_t a2 = pack(pa[8 * s], pa[9 * s]);
      const uint32_t a3 = pack(pc[8 * s], pc[9 * s]);
      mma(acc[q][0], a0, a1, a2, a3, bf[0][0], bf[0][1]);
      mma(acc[q][1], a2, a3, pack(pa[16 * s], pa[17 * s]), pack(pc[16 * s], pc[17 * s]),
          bf[1][0], bf[1][1]);
    }
  }
}

// The last step of a K3 or K4 block, reached by all its threads: once every
// warp has read the staged rows, the working warps put their sums D[c][p]
// into s_part [chans][part_pitch] (the lane holds channel rows gq + 8h and
// pixels 2 tig + e of each tile of class cls, class tile ct), and the
// block writes the chunk's `rows` output rows from `out` (plane pitch hw),
// x_hi columns each, as store_rows does over `channels`.
__device__ __forceinline__ void store_sums(const BwdAcc& acc, bool working, int grp, int blocks,
                                           int cls, int ct, int s, float* s_part,
                                           int part_pitch, u16* out, size_t hw, int rows,
                                           int x_hi, bool vec_out, int channels) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tig = lane & 3;
  __syncthreads();  // every warp has read the staged rows: their region takes the sums
  if (working) {
#pragma unroll
    for (int q = 0; q < kGroupBlocks; ++q) {
      if (q < blocks) {
#pragma unroll
        for (int pt = 0; pt < 2; ++pt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int ch = 16 * (kGroupBlocks * grp + q) + gq + 8 * h;
              const int x = cls + s * (kTileP * ct + 8 * pt + 2 * tig + e);
              s_part[ch * part_pitch + x] = acc[q][pt][2 * h + e];
            }
          }
        }
      }
    }
  }
  __syncthreads();
  store_rows(out, hw, rows, s_part, part_pitch, x_hi, vec_out, static_cast<float>(channels));
}

// ---------------------------------------------------------------- K2-bf16

// grid (x tiles, H, B * groups); block: one warp per (class tile, chunk of
// kJ displacements), tile_x / 16 class tiles; the layout's rows from cr's
// height. Group grp computes the
// in-frame displacement rows lo + grp * rows .. (rows = the layout's) and
// writes the zero planes of the out-of-frame rows i with i % groups == grp.
// `tma`: cl and cr staged by TMA boxes (map_cl, map_cr), else by the
// threads. `vec_out`: outputs 16 bytes a lane.
__global__ void __launch_bounds__(kMaxWarps * 32, 3)
corr_fwd_bf16_kernel(const __grid_constant__ CUtensorMap map_cl,
                     const __grid_constant__ CUtensorMap map_cr, const u16* __restrict__ cl,
                     const u16* __restrict__ cr, u16* __restrict__ out, int channels, int height,
                     int width, int cr_height, int row_offset, int md, int s, int n, int tile_x,
                     int groups, int tma, int vec_out) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  uint8_t* smem = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  const FwdLayout lay = fwd_layout(channels, cr_height, s, n, tile_x, groups);
  const ChanBoxes boxes = chan_boxes(channels);
  const int cl_pitch = lay.cl_pitch, row_pitch = lay.row_pitch, row_elems = lay.row_bytes / 2;
  u16* s_cl = reinterpret_cast<u16*>(smem);
  u16* s_rows = reinterpret_cast<u16*>(smem + lay.cl_bytes);
  float* s_part = reinterpret_cast<float*>(smem + lay.cl_bytes);

  const int b = blockIdx.z / groups, grp = blockIdx.z - b * groups;
  const int y = blockIdx.y, xt = blockIdx.x * tile_x;
  const size_t hw = static_cast<size_t>(height) * width;
  const size_t hw_r = static_cast<size_t>(cr_height) * width;
  // the displacement rows i whose cr row y0 + i * s lies in cr's frame, and
  // this group's share of them
  const int y0 = y + row_offset - md;
  const int2 in_rows = rows_in_frame(y0, cr_height, s, n);
  const int lo_y = in_rows.x, hi_y = in_rows.y;
  const int c_lo = lo_y + grp * lay.rows;
  const int rows = max(0, min(hi_y, c_lo + lay.rows - 1) - c_lo + 1);
  // the cr rows' window starts at frame column xt - md, staged column sh
  const int sh = lead8(xt - md);

  if (rows > 0) {
    if (tma) {
      if (threadIdx.x == 0) {
        mbar_init(&bar);
        mbar_fence_init();
        mbar_expect(&bar, lay.cl_bytes + rows * lay.row_bytes);
        for (int q = 0; q < boxes.count; ++q) {
          tma_load(s_cl + q * boxes.box * cl_pitch, &map_cl, xt, y, q * boxes.box, b, &bar);
        }
        for (int k = 0; k < rows; ++k) {
          for (int q = 0; q < boxes.count; ++q) {
            tma_load(s_rows + k * row_elems + q * boxes.box * row_pitch, &map_cr, xt - md - sh,
                     y0 + (c_lo + k) * s, q * boxes.box, b, &bar);
          }
        }
      }
      __syncthreads();  // the barrier is initialised before anyone waits on it
    } else {
      const u16* clb = cl + static_cast<size_t>(b) * channels * hw + static_cast<size_t>(y) * width;
      stage_plain(s_cl, clb, hw, lay.chans, channels, cl_pitch, xt, width);
      for (int k = 0; k < rows; ++k) {
        const u16* crb = cr + static_cast<size_t>(b) * channels * hw_r
                         + static_cast<size_t>(y0 + (c_lo + k) * s) * width;
        stage_plain(s_rows + k * row_elems, crb, hw_r, lay.chans, channels, row_pitch,
                    xt - md - sh, width);
      }
      __syncthreads();
    }
  }

  // the zero planes of the out-of-frame rows i with i % groups == grp, while
  // the copies are in flight
  const int x_hi = min(tile_x, width - xt);
  const float c_f = static_cast<float>(channels);
  u16* outb = out + static_cast<size_t>(b) * n * n * hw + static_cast<size_t>(y) * width + xt;
  for (int i = grp; i < n; i += groups) {
    if (i < lo_y || i > hi_y) {
      store_rows(outb + static_cast<size_t>(i) * n * hw, hw, n, nullptr, 0, x_hi, vec_out, c_f);
    }
  }

  // this warp's tile: class cls, class tile ct (pixels x = cls + s * (16 ct
  // + p), p < 16), displacements j0 .. j0 + kJ - 1; lane (gq, tig) holds
  // pixel rows gq and gq + 8 (columns xa, xb of the tile) of the fragments
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tig = lane & 3;
  const int chunks = disp_chunks(n);
  const bool working = rows > 0 && warp < (tile_x / kTileP) * chunks;
  const int j0 = (warp % chunks) * kJ;
  const int cls = (warp / chunks) % s, ct = (warp / chunks) / s;
  const int xa = cls + s * (kTileP * ct + gq), xb = xa + 8 * s;
  float acc[kFwdRows][3][4];
#pragma unroll
  for (int r = 0; r < kFwdRows; ++r) {
#pragma unroll
    for (int nt = 0; nt < 3; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][nt][e] = 0.0f;
    }
  }
  if (working) {
    if (tma) mbar_wait(&bar, 0);
    // window column q = j0 + 8 nt + gq of the band (B's column gq of n8
    // tile nt) is staged cr column sh + cls + s * (16 ct + q); channels
    // c0 + 0/1 and c0 + 8/9 of the k16 step
    const int w0 = sh + cls + s * (kTileP * ct + j0 + gq);
    const int ksteps = (channels + 15) / 16;
    for (int k16 = 0; k16 < ksteps; ++k16) {
      const int c0 = 16 * k16 + 2 * tig;
      const u16* pa = s_cl + c0 * cl_pitch;
      const uint32_t a0 = pack(pa[xa], pa[cl_pitch + xa]);
      const uint32_t a1 = pack(pa[xb], pa[cl_pitch + xb]);
      const uint32_t a2 = pack(pa[8 * cl_pitch + xa], pa[9 * cl_pitch + xa]);
      const uint32_t a3 = pack(pa[8 * cl_pitch + xb], pa[9 * cl_pitch + xb]);
#pragma unroll
      for (int r = 0; r < kFwdRows; ++r) {
        if (r < rows) {
          const u16* pb = s_rows + r * row_elems + c0 * row_pitch + w0;
#pragma unroll
          for (int nt = 0; nt < 3; ++nt) {
            const int w = nt * 8 * s;
            mma(acc[r][nt], a0, a1, a2, a3, pack(pb[w], pb[row_pitch + w]),
                pack(pb[8 * row_pitch + w], pb[9 * row_pitch + w]));
          }
        }
      }
    }
  }
  __syncthreads();  // every warp has read the rows: their region takes the sums
  if (working) {
    // D[p][q]: the lane holds p = gq + 8h, q = 8 nt + 2 tig + e; its
    // displacement is j = j0 + q - p
#pragma unroll
    for (int r = 0; r < kFwdRows; ++r) {
      if (r < rows) {
        float* pr = s_part + r * n * lay.part_pitch;
#pragma unroll
        for (int nt = 0; nt < 3; ++nt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int jl = 8 * nt + 2 * tig + e - gq - 8 * h;
              if (jl >= 0 && jl < kJ && j0 + jl < n) {
                pr[(j0 + jl) * lay.part_pitch + (h ? xb : xa)] = acc[r][nt][2 * h + e];
              }
            }
          }
        }
      }
    }
  }
  __syncthreads();

  store_rows(outb + static_cast<size_t>(c_lo) * n * hw, hw, rows * n, s_part, lay.part_pitch,
             x_hi, vec_out, c_f);
}

// ---------------------------------------------------------------- K3-bf16

// grid (x tiles, H, B * channel chunks); block: one warp per (class tile,
// group of up to kGroupBlocks 16-channel blocks), as K4-bf16. The block
// stages its g tile once, on a barrier of its own: the g rows (i, j) of
// image row y from its first in-frame displacement row i_lo on, frame
// columns xt .. (g of an out-of-frame row is never read; the tile holds
// rows_max of cr's height). Its in-frame rows' cr rows
// y + row_offset - md + i * s go through `rows_per_stage` slots, one
// mbarrier each, from frame column xt - md on: pixel x = xt + X of term j
// reads window column X + s * j of the cr row and column X of g row (i, j).
__global__ void __launch_bounds__(kMaxWarps * 32, 3)
corr_bwd_cl_bf16_kernel(const __grid_constant__ CUtensorMap map_g,
                        const __grid_constant__ CUtensorMap map_cr, const u16* __restrict__ g,
                        const u16* __restrict__ cr, u16* __restrict__ dcl, int channels,
                        int height, int width, int cr_height, int row_offset, int md, int s,
                        int n, int tile_x, int chan_blocks, int rows_per_stage, int tma,
                        int vec_out) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kRowsPerStage + 1];  // the slots', then the g tile's
  uint8_t* smem = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  const BwdClLayout lay = bwd_cl_layout(s, n, tile_x, chan_blocks, rows_per_stage, cr_height);
  const ChanBoxes planes = plane_boxes(rows_max(n, s, cr_height) * n);
  const int pitch = lay.pitch, g_pitch = lay.g_pitch, row_elems = lay.row_bytes / 2;
  u16* s_g = reinterpret_cast<u16*>(smem);
  u16* s_rows = reinterpret_cast<u16*>(smem + lay.g_bytes);
  float* s_part = reinterpret_cast<float*>(smem);
  uint64_t* g_bar = &bars[kRowsPerStage];

  const int chunks_c = ((channels + 15) / 16 + chan_blocks - 1) / chan_blocks;
  const int b = blockIdx.z / chunks_c, c0 = (blockIdx.z - b * chunks_c) * lay.chans;
  const int y = blockIdx.y, xt = blockIdx.x * tile_x;
  const size_t hw = static_cast<size_t>(height) * width;
  const size_t hw_r = static_cast<size_t>(cr_height) * width;
  // the displacement rows i whose cr row y0 + i * s lies in cr's frame
  const int y0 = y + row_offset - md;
  const int2 in_rows = rows_in_frame(y0, cr_height, s, n);
  const int i_lo = in_rows.x, i_hi = in_rows.y;
  const int in_frame = max(0, i_hi - i_lo + 1);
  const int stages = (in_frame + rows_per_stage - 1) / rows_per_stage;
  // the cr window starts at frame column col0, staged column sh
  const int col0 = xt - md;
  const int sh = lead8(col0);

  // this warp's tile: class cls, class tile ct, channel blocks 4 grp ..
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tig = lane & 3;
  const int wgroups = (chan_blocks + kGroupBlocks - 1) / kGroupBlocks;
  const bool working = warp < (tile_x / kTileP) * wgroups;
  const int grp = warp % wgroups;
  const int cls = (warp / wgroups) % s, ct = (warp / wgroups) / s;
  const int blocks = min(kGroupBlocks, chan_blocks - kGroupBlocks * grp);
  // the lane's pixel (B's column gq) of n8 tile 0, a tile column; tile 1's
  // is 8 * s on
  const int xg = cls + s * (kTileP * ct + gq);
  BwdAcc acc = {};

  // the g tile, once; a block with no in-frame row stages nothing and
  // writes zeros
  if (stages > 0) {
    if (tma) {
      if (threadIdx.x == 0) {
        for (int k = 0; k <= kRowsPerStage; ++k) mbar_init(&bars[k]);
        mbar_fence_init();
        mbar_expect(g_bar, lay.g_planes * g_pitch * 2);
        for (int q = 0; q < planes.count; ++q) {
          tma_load(s_g + q * planes.box * g_pitch, &map_g, xt, y, i_lo * n + q * planes.box, b,
                   g_bar);
        }
      }
    } else {
      stage_plain(s_g, g + (static_cast<size_t>(b) * n * n + i_lo * n) * hw
                           + static_cast<size_t>(y) * width,
                  hw, lay.g_planes, (n - i_lo) * n, g_pitch, xt, width);
    }
  }
  for (int st = 0; st < stages; ++st) {
    const int i0 = i_lo + st * rows_per_stage;
    const int count = min(rows_per_stage, i_hi - i0 + 1);
    __syncthreads();  // the barriers are set up; the last stage's rows are read
    if (tma) {
      if (threadIdx.x == 0) {
        fence_proxy_async();
        for (int k = 0; k < count; ++k) {
          mbar_expect(&bars[k], lay.row_bytes);
          tma_load(s_rows + k * row_elems, &map_cr, col0 - sh, y0 + (i0 + k) * s, c0, b,
                   &bars[k]);
        }
      }
    } else {
      for (int k = 0; k < count; ++k) {
        stage_plain(s_rows + k * row_elems,
                    cr + (static_cast<size_t>(b) * channels + c0) * hw_r
                        + static_cast<size_t>(y0 + (i0 + k) * s) * width,
                    hw_r, lay.chans, channels - c0, pitch, col0 - sh, width);
      }
      __syncthreads();
    }
    if (tma && working && st == 0) mbar_wait(g_bar, 0);
    for (int k = 0; working && k < count; ++k) {
      if (tma) mbar_wait(&bars[k], st & 1);
      const u16* s_cr = s_rows + k * row_elems;
      const u16* s_gi = s_g + (i0 + k - i_lo) * n * g_pitch;  // g row (i, 0)
      for (int m0 = 0; m0 < n; m0 += kJ) {
        // B of n8 tile pt: (q = 8 pt + m0 + kk, p = 8 pt + gq) for the lane's
        // kk = 2 tig + e + 8 h; j = q - p = m0 + kk - gq in the band: g row
        // (i, j) at the pixel's column, the same j for both tiles
        uint32_t bf[2][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          u16 v[2][2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = m0 + 2 * tig + e + 8 * h - gq;
            const bool on = j >= m0 && j < m0 + kJ && j < n;
            // off the band the loads read g row (i, 0), in range, and are dropped
            const u16* pg = s_gi + (on ? j : 0) * g_pitch + xg;
            v[0][e] = on ? pg[0] : u16(0);
            v[1][e] = on ? pg[8 * s] : u16(0);
          }
          bf[0][h] = pack(v[0][0], v[0][1]);
          bf[1][h] = pack(v[1][0], v[1][1]);
        }
        band_mma(acc, s_cr, pitch, sh + cls + s * (kTileP * ct + m0 + 2 * tig), s, grp,
                 blocks, gq, bf);
      }
    }
  }
  store_sums(acc, working, grp, blocks, cls, ct, s, s_part, lay.part_pitch,
             dcl + (static_cast<size_t>(b) * channels + c0) * hw + static_cast<size_t>(y) * width
                 + xt,
             hw, min(lay.chans, channels - c0), min(tile_x, width - xt), vec_out, channels);
}

// ---------------------------------------------------------------- K4-bf16

// grid (x tiles, H, B * channel chunks); block: one warp per (class tile,
// group of up to kGroupBlocks 16-channel blocks), tile_x / 16 class tiles,
// chan_blocks blocks of 16 channels a chunk; y' a row of cr (grid rows
// H_r), cl and g of h rows. The in-frame displacement rows i (cl row
// y' - row_offset + md - i * s) go through `rows_per_stage` slots, one
// mbarrier each. A row's cl and g are staged from frame column
// xt - ((n - 1) * s - md) on: pixel x' = xt + X of term j reads window
// column X + s * (n - 1 - j).
__global__ void __launch_bounds__(kMaxWarps * 32, 3)
corr_bwd_cr_bf16_kernel(const __grid_constant__ CUtensorMap map_g,
                        const __grid_constant__ CUtensorMap map_cl, const u16* __restrict__ g,
                        const u16* __restrict__ cl, u16* __restrict__ dcr, int channels,
                        int height, int width, int cr_height, int row_offset, int md, int s,
                        int n, int tile_x, int chan_blocks, int rows_per_stage, int tma,
                        int vec_out) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kRowsPerStage];
  uint8_t* smem = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  const BwdLayout lay = bwd_layout(s, n, tile_x, chan_blocks, rows_per_stage);
  const int pitch = lay.pitch, cl_elems = lay.cl_bytes / 2, slot_elems = lay.slot / 2;
  u16* s_slots = reinterpret_cast<u16*>(smem);
  float* s_part = reinterpret_cast<float*>(smem);

  const int chunks_c = ((channels + 15) / 16 + chan_blocks - 1) / chan_blocks;
  const int b = blockIdx.z / chunks_c, c0 = (blockIdx.z - b * chunks_c) * lay.chans;
  const int y = blockIdx.y, xt = blockIdx.x * tile_x;
  const size_t hw = static_cast<size_t>(height) * width;
  const size_t hw_r = static_cast<size_t>(cr_height) * width;
  // the displacement rows i whose cl row yc - i * s lies in [0, height): the
  // row height - 1 - (yc - i * s) = y1 + i * s in it
  const int yc = y - row_offset + md, y1 = height - 1 - yc;
  const int2 in_rows = rows_in_frame(y1, height, s, n);
  const int i_lo = in_rows.x, i_hi = in_rows.y;
  const int in_frame = max(0, i_hi - i_lo + 1);
  const int stages = (in_frame + rows_per_stage - 1) / rows_per_stage;
  // the window starts at frame column col0, staged column sh
  const int col0 = xt - ((n - 1) * s - md);
  const int sh = lead8(col0);

  // this warp's tile: class cls, class tile ct, channel blocks 4 grp ..
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tig = lane & 3;
  const int wgroups = (chan_blocks + kGroupBlocks - 1) / kGroupBlocks;
  const bool working = warp < (tile_x / kTileP) * wgroups;
  const int grp = warp % wgroups;
  const int cls = (warp / wgroups) % s, ct = (warp / wgroups) / s;
  const int blocks = min(kGroupBlocks, chan_blocks - kGroupBlocks * grp);
  BwdAcc acc = {};

  if (tma && stages > 0 && threadIdx.x == 0) {
    for (int k = 0; k < rows_per_stage; ++k) mbar_init(&bars[k]);
    mbar_fence_init();
  }
  for (int st = 0; st < stages; ++st) {
    const int i0 = i_lo + st * rows_per_stage;
    const int count = min(rows_per_stage, i_hi - i0 + 1);
    __syncthreads();  // the barriers are set up; the last stage's rows are read
    if (tma) {
      if (threadIdx.x == 0) {
        fence_proxy_async();
        for (int k = 0; k < count; ++k) {
          const int row = yc - (i0 + k) * s;
          u16* slot = s_slots + k * slot_elems;
          mbar_expect(&bars[k], (lay.chans + n) * pitch * 2);
          tma_load(slot, &map_cl, col0 - sh, row, c0, b, &bars[k]);
          tma_load(slot + cl_elems, &map_g, col0 - sh, row, (i0 + k) * n, b, &bars[k]);
        }
      }
    } else {
      for (int k = 0; k < count; ++k) {
        const int row = yc - (i0 + k) * s;
        u16* slot = s_slots + k * slot_elems;
        stage_plain(slot, cl + (static_cast<size_t>(b) * channels + c0) * hw
                              + static_cast<size_t>(row) * width,
                    hw, lay.chans, channels - c0, pitch, col0 - sh, width);
        stage_plain(slot + cl_elems, g + (static_cast<size_t>(b) * n * n + (i0 + k) * n) * hw
                                         + static_cast<size_t>(row) * width,
                    hw, n, n, pitch, col0 - sh, width);
      }
      __syncthreads();
    }
    for (int k = 0; working && k < count; ++k) {
      if (tma) mbar_wait(&bars[k], st & 1);
      const u16* s_f = s_slots + k * slot_elems;
      const u16* s_g = s_f + cl_elems;
      for (int m0 = 0; m0 < n; m0 += kJ) {
        // B of n8 tile pt: (q = 8 pt + m0 + kk, p = 8 pt + gq) for the lane's
        // kk = 2 tig + e + 8 h; m = m0 + kk - gq in the band, j = n - 1 - m
        uint32_t bf[2][2];
#pragma unroll
        for (int pt = 0; pt < 2; ++pt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            u16 v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kk = 2 * tig + e + 8 * h, m = m0 + kk - gq;
              const bool on = m >= m0 && m < m0 + kJ && m < n;
              // off the band the load reads row 0, in range, and is dropped
              const u16 raw = s_g[(on ? n - 1 - m : 0) * pitch + sh + cls
                                  + s * (kTileP * ct + 8 * pt + m0 + kk)];
              v[e] = on ? raw : u16(0);
            }
            bf[pt][h] = pack(v[0], v[1]);
          }
        }
        band_mma(acc, s_f, pitch, sh + cls + s * (kTileP * ct + m0 + 2 * tig), s, grp,
                 blocks, gq, bf);
      }
    }
  }
  store_sums(acc, working, grp, blocks, cls, ct, s, s_part, lay.part_pitch,
             dcr + (static_cast<size_t>(b) * channels + c0) * hw_r
                 + static_cast<size_t>(y) * width + xt,
             hw_r, min(lay.chans, channels - c0), min(tile_x, width - xt), vec_out, channels);
}

// ------------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda.so.1, which the CUDA runtime has
// loaded already (the library links no -lcuda)
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A map over bfloat16 [batch, planes, height, width] with boxes of `cols`
// columns of one row of `rows` planes; zeros outside the tensor.
bool encode_map(CUtensorMap* map, const void* base, int batch, int planes, int height, int width,
                int cols, int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(height),
                              static_cast<cuuint64_t>(planes), static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(width) * 2;
  const cuuint64_t strides[3] = {row, row * height, row * height * planes};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
         == CUDA_SUCCESS;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int displacements(int md, int stride) { return 2 * md / stride + 1; }

// Whether a K3 or K4 plan holds: tile_x a multiple of 16 * stride, at most
// 16 channel blocks and 8 warps (one per class tile and group of 4 blocks),
// 1..4 rows a stage, `threads` the warps', `smem_bytes` the layout's
// `total` within 227 KB, a grid of at most 65535 rows and images x chunks.
bool bwd_plan_holds(int batch, int channels, int height, int stride, int tile_x,
                    int chan_blocks, int rows_per_stage, int threads, int smem_bytes,
                    int total) {
  const int chunks = ((channels + 15) / 16 + chan_blocks - 1) / chan_blocks;
  const int warps = tile_x / kTileP * ((chan_blocks + kGroupBlocks - 1) / kGroupBlocks);
  return tile_x % (kTileP * stride) == 0 && chan_blocks <= kBoxMax / 16 && rows_per_stage >= 1
         && rows_per_stage <= kRowsPerStage && warps <= kMaxWarps && threads == 32 * warps
         && smem_bytes == total && smem_bytes <= kSmemLimit && height <= 65535
         && static_cast<long long>(batch) * chunks <= 65535;
}

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

}  // namespace

// cl [B,C,H,W], cr [B,C,H_r,W] bfloat16 (H_r = cr_height; row_offset: cl's
// first global row minus cr's, 0 with H_r = H for the whole frame); writes
// out [B,n^2,H,W] bfloat16, n = 2 * md / stride + 1; contiguous, on the
// current device. The plan comes from
// ops/kernels/correlation.py::fwd_plan_bf16: tile_x (a multiple of 16 *
// stride, at most kMaxWarps / ceil(n / 9) class tiles), groups (1..n, at
// most kFwdRows in-frame rows each), threads (32 a class tile and chunk)
// and smem_bytes, which must equal this layout and fit 227 KB. Stages by
// TMA where W % 8 == 0, cl and cr are 16-byte aligned and the rows fit one
// box; writes 16 bytes a lane where W % 8 == 0 and out is 16-byte aligned.
// Launches K2-bf16 on `stream` and returns cudaGetLastError(),
// cudaErrorInvalidValue for a plan that does not match, or
// cudaErrorNotSupported where no tensor map can be made.
extern "C" int xpt_corr_fwd_bf16(const void* cl, const void* cr, void* out, int batch,
                                 int channels, int height, int width, int cr_height,
                                 int row_offset, int md, int stride, int tile_x, int groups,
                                 int threads, int smem_bytes, void* stream) {
  if (static_cast<long long>(batch) * height * width == 0) return static_cast<int>(cudaSuccess);
  if (channels <= 0 || stride <= 0 || md < 0 || tile_x <= 0 || groups <= 0 || cr_height <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n = displacements(md, stride);
  const FwdLayout lay = fwd_layout(channels, cr_height, stride, n, tile_x, groups);
  const int warps = tile_x / kTileP * disp_chunks(n);
  if (tile_x % (kTileP * stride) != 0 || groups > n || lay.rows > kFwdRows || warps > kMaxWarps
      || threads != 32 * warps || smem_bytes != lay.total || smem_bytes > kSmemLimit
      || height > 65535 || static_cast<long long>(batch) * groups > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap map_cl{}, map_cr{};
  const bool tma = width % 8 == 0 && aligned16(cl) && aligned16(cr) && lay.cl_pitch <= kBoxMax
                   && lay.row_pitch <= kBoxMax;
  const int box = chan_boxes(channels).box;
  if (tma && !(encode_map(&map_cl, cl, batch, channels, height, width, lay.cl_pitch, box)
               && encode_map(&map_cr, cr, batch, channels, cr_height, width, lay.row_pitch,
                             box))) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  const bool vec_out = width % 8 == 0 && aligned16(out);
  const dim3 grid((width + tile_x - 1) / tile_x, height, batch * groups);
  return launch(corr_fwd_bf16_kernel, grid, threads, smem_bytes, stream, map_cl, map_cr,
                static_cast<const u16*>(cl), static_cast<const u16*>(cr), static_cast<u16*>(out),
                channels, height, width, cr_height, row_offset, md, stride, n, tile_x, groups,
                tma ? 1 : 0, vec_out ? 1 : 0);
}

// g [B,n^2,H,W] (the cotangent of K2's output), cr [B,C,H_r,W], bfloat16
// (cr_height and row_offset as for xpt_corr_fwd_bf16); writes dcl [B,C,H,W]
// bfloat16. The plan comes from ops/kernels/
// correlation.py::bwd_cl_plan_bf16: tile_x (a multiple of 16 * stride),
// chan_blocks (16-channel blocks a CUDA block, at most 16, one warp per
// class tile and group of 4), rows_per_stage (1..4), threads and
// smem_bytes, which must equal this layout and fit 227 KB. Stages by TMA
// where W % 8 == 0, g and cr are 16-byte aligned and a cr row fits one
// box. Launches K3-bf16 on `stream`; returns as xpt_corr_fwd_bf16.
extern "C" int xpt_corr_bwd_cl_bf16(const void* g, const void* cr, void* dcl, int batch,
                                    int channels, int height, int width, int cr_height,
                                    int row_offset, int md, int stride, int tile_x,
                                    int chan_blocks, int rows_per_stage, int threads,
                                    int smem_bytes, void* stream) {
  if (static_cast<long long>(batch) * channels * height * width == 0) {
    return static_cast<int>(cudaSuccess);
  }
  if (stride <= 0 || md < 0 || tile_x <= 0 || chan_blocks <= 0 || cr_height <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n = displacements(md, stride);
  const BwdClLayout lay = bwd_cl_layout(stride, n, tile_x, chan_blocks, rows_per_stage,
                                        cr_height);
  if (!bwd_plan_holds(batch, channels, height, stride, tile_x, chan_blocks, rows_per_stage,
                      threads, smem_bytes, lay.total)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap map_g{}, map_cr{};
  const bool tma = width % 8 == 0 && aligned16(g) && aligned16(cr) && lay.pitch <= kBoxMax;
  if (tma && !(encode_map(&map_g, g, batch, n * n, height, width, lay.g_pitch,
                          plane_boxes(rows_max(n, stride, cr_height) * n).box)
               && encode_map(&map_cr, cr, batch, channels, cr_height, width, lay.pitch,
                             lay.chans))) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  const bool vec_out = width % 8 == 0 && aligned16(dcl);
  const int chunks = ((channels + 15) / 16 + chan_blocks - 1) / chan_blocks;
  const dim3 grid((width + tile_x - 1) / tile_x, height, batch * chunks);
  return launch(corr_bwd_cl_bf16_kernel, grid, threads, smem_bytes, stream, map_g, map_cr,
                static_cast<const u16*>(g), static_cast<const u16*>(cr), static_cast<u16*>(dcl),
                channels, height, width, cr_height, row_offset, md, stride, n, tile_x,
                chan_blocks, rows_per_stage, tma ? 1 : 0, vec_out ? 1 : 0);
}

// g [B,n^2,H,W], cl [B,C,H,W], bfloat16; writes dcr [B,C,H_r,W] bfloat16
// (cr_height and row_offset as for xpt_corr_fwd_bf16; the grid's rows are
// cr's).
// The plan comes from ops/kernels/correlation.py::bwd_cr_plan_bf16, with
// the keys and limits of xpt_corr_bwd_cl_bf16's, for this layout. Stages by
// TMA where W % 8 == 0, g and cl are 16-byte aligned and a row fits one
// box. Launches K4-bf16 on `stream`; returns as xpt_corr_fwd_bf16.
extern "C" int xpt_corr_bwd_cr_bf16(const void* g, const void* cl, void* dcr, int batch,
                                    int channels, int height, int width, int cr_height,
                                    int row_offset, int md, int stride, int tile_x,
                                    int chan_blocks, int rows_per_stage, int threads,
                                    int smem_bytes, void* stream) {
  if (static_cast<long long>(batch) * channels * cr_height * width == 0) {
    return static_cast<int>(cudaSuccess);
  }
  if (stride <= 0 || md < 0 || tile_x <= 0 || chan_blocks <= 0 || height <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n = displacements(md, stride);
  const BwdLayout lay = bwd_layout(stride, n, tile_x, chan_blocks, rows_per_stage);
  if (!bwd_plan_holds(batch, channels, cr_height, stride, tile_x, chan_blocks, rows_per_stage,
                      threads, smem_bytes, lay.total)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap map_g{}, map_cl{};
  const bool tma = width % 8 == 0 && aligned16(g) && aligned16(cl) && lay.pitch <= kBoxMax
                   && n <= kBoxMax;
  if (tma && !(encode_map(&map_g, g, batch, n * n, height, width, lay.pitch, n)
               && encode_map(&map_cl, cl, batch, channels, height, width, lay.pitch, lay.chans))) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  const bool vec_out = width % 8 == 0 && aligned16(dcr);
  const int chunks = ((channels + 15) / 16 + chan_blocks - 1) / chan_blocks;
  const dim3 grid((width + tile_x - 1) / tile_x, cr_height, batch * chunks);
  return launch(corr_bwd_cr_bf16_kernel, grid, threads, smem_bytes, stream, map_g, map_cl,
                static_cast<const u16*>(g), static_cast<const u16*>(cl), static_cast<u16*>(dcr),
                channels, height, width, cr_height, row_offset, md, stride, n, tile_x,
                chan_blocks, rows_per_stage, tma ? 1 : 0, vec_out ? 1 : 0);
}
