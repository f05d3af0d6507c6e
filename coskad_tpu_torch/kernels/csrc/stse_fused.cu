// Eval-mode STSE encoder, fused: pose windows -> hidden state in one kernel.
//
// Replaces the Pallas kernel coskad_tpu/kernels/stse_fused.py::_kernel
// (driven by fused_stse_forward). Every layer of the STS-GCN stack computes
//
//     y = PReLU( (M^T x) W + x W_res + (b + b_res) )
//
// with BatchNorm already folded into W / W_res / b (fold_stse_params) and the
// two separable graph contractions merged into one [N, N] matrix M
// (combined_graph_matrix), N = T*V nodes. The projector matmul stays outside.
//
// What bounds it on an H100: at the flagship width (N = 216, channels
// 2->32->16->32->64) a window needs ~8.9 MFLOP (graph contractions on
// min(C_in, C_out) channels, see below) against 3.5 KB read and 55 KB
// written, ~150 FLOP per byte of device memory: operations, as fp32 FMAs
// (the ridge is ~20 FLOP/byte: 67 TFLOP/s over 3.35 TB/s, the H100 SXM data
// sheet's peaks at 700 W) and as 3xTF32 on the tensor cores alike (three
// TF32 products for each fp32 one, ~fp32 accuracy; ~50 FLOP/byte at 495
// TFLOP/s). Feeding those operations is the other limit: M (200 KB a layer,
// padded) is the operand every window shares, read from L2 by every block.
//
// Design:
//   * a block takes WB windows (2 at the flagship) side by side as the
//     columns of one product G = M^T X, so one pass over M feeds them all;
//   * each of 16 warps owns a 16-node tile of the output (kPair tiles a
//     warp, a constant: k1_variants.py times two tiles at 8 warps) and
//     stages the k-slices of the columns of M its tile needs in a ring of
//     its own in shared memory (16-byte cp.async, kStages = 2 slices; a
//     row stride of 8 mod 32 words puts an A fragment's 32 lanes on 32
//     banks). A block so reads each layer's M from L2 once, not once per
//     window, and no block-wide barrier paces the ring;
//   * G = M^T X and the channel mixes G W + X W_res run as 3xTF32 m16n8k8
//     mma.sync (mma_3xtf32, tf32_mma.cuh), with the bias and PReLU in the
//     epilogue. The loops around the mma's have compile-time bounds and no
//     branch (a warp short of a tile computes a copy and drops it), and
//     operands are split into TF32 pairs by truncation (split_trunc). The
//     mixes read G, X and W^T in a k order permuted to the accumulator
//     layout (channel 2t at k = t, 2t + 1 at k = t + 4, for lane t % 4), as
//     8-byte loads;
//   * the activations stay in shared memory from layer to layer, node-major
//     [rows][ldx] with window w's channels at columns [w c8, (w + 1) c8),
//     c8 the channels rounded up to 8; each warp writes only its own rows
//     (G too: into the other buffer, mixed from there in place), so a layer
//     needs one barrier before it and one for its W^T (two more where it
//     narrows), and only the last layer's valid outputs go to device
//     memory, node-major [B, N, C_out], the layout the projector reads;
//   * where a layer narrows (C_out < C_in) it computes U = X W into the
//     other buffer and R = X W_res in place of X, then M^T U + R, so the
//     graph contraction, the bulk of the FLOPs, runs on the smaller channel
//     count;
//   * an identity residual adds x; padded nodes and channels carry zeros (M,
//     W, W_res and b are zero-padded, and rows past N are written as 0), so
//     they never reach a valid output; a ragged last block computes on zero
//     windows and writes only its real ones;
//   * no atomics: every sum is taken in a fixed order, so two launches give
//     the same bits.
// Each code path runs a few times a block, so the code is kept small: the
// walk over M is the one hot loop, and the layer's passes are instantiated
// per tile count (graph_layer, mix_layer, narrow_pre) rather than unrolled
// over runtime bounds.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"  // mma_3xtf32, cp_async16, cp_async4, round8

namespace {

constexpr int kMaxLayers = 8;
constexpr int kThreads = 512;        // 16 warps: more to hide latency than 8 of two tiles
constexpr int kWarps = kThreads / 32;
constexpr int kPair = 1;              // 16-node tiles a warp takes at once
constexpr int kStages = 2;            // slices of M a warp has staged or in flight
constexpr int kSliceK = 16;           // rows (k) of M a slice
constexpr int kLdm = 16 * kPair + 8;  // a slice's row stride: 8 mod 32 words
constexpr int kSlice = kSliceK * kLdm;
constexpr int kOutTiles = 8;          // output channels a mix takes at once: 8 x 8
constexpr int kMaxSmem = 232448;      // bytes a block may opt into on an H100

// 3xTF32's split of v into big + small, each a TF32 value, by truncation:
// big is v with its 13 low mantissa bits cleared, small the rest, likewise
// (an mma reads only a TF32 operand's top 19 bits). Two logic ops and a
// subtraction, fewer instructions than split_tf32's two cvt.rna.tf32; the
// pair still holds v to ~2^-20, and the dropped small x small product is
// as small.
__device__ __forceinline__ void split_trunc(float v, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(v) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big)) & 0xffffe000u;
}

struct LayerDesc {
  int ci, co, identity;
  long long off_m, off_w, off_wr, off_b, off_alpha;  // float offsets
};

struct Params {
  LayerDesc layers[kMaxLayers];
  int n_layers;
  int n_nodes;  // N = T*V
  int rows;     // N rounded up to 16; M is [rows][rows]
  int ldx;      // activation row stride
  int ldwt;     // W^T and W_res^T row stride
  int co8_max;  // rows of W^T
};

// The least stride >= v that is 8 (mod 16) words: the rows t = 0..3 of a
// fragment start 8 banks apart, so its 32 lanes (or a half-warp's 16 8-byte
// loads) hit 32 banks.
__host__ __device__ inline int pad_stride(int v) { return (v + 7) / 16 * 16 + 8; }

// Shared memory, float offsets: the two activation buffers [rows][ldx], W^T
// and W_res^T [co8_max][ldwt], the bias [co8_max], then each warp's ring of
// kStages slices [kSliceK][kLdm]. Every offset is a multiple of 8 floats.
struct Smem {
  int act, wt, bias, ring, total;
};
__host__ __device__ inline Smem smem_layout(const Params& p) {
  Smem s;
  s.act = p.rows * p.ldx;
  s.wt = 2 * s.act;
  s.bias = s.wt + 2 * p.co8_max * p.ldwt;
  s.ring = s.bias + p.co8_max;
  s.total = s.ring + kWarps * kStages * kSlice;
  return s;
}

// o[tl][ot] += A[tl] . W^T[oc + 8 ot + o][k] over one k-step, for ot < NT,
// where the lane holds each node tile's A fragment (ab, as) in the permuted
// k order (channel 2t at k = t, 2t + 1 at k = t + 4) and wts points at
// W^T[oc + g][k0 + 2t].
template <int NT>
__device__ __forceinline__ void mix_step(float (&o)[kPair][NT][4], const uint32_t (&ab)[kPair][4],
                                         const uint32_t (&as)[kPair][4], const float* wts,
                                         int ldwt) {
#pragma unroll
  for (int ot = 0; ot < NT; ++ot) {
    const float2 w = *reinterpret_cast<const float2*>(wts + 8 * ot * ldwt);
    uint32_t bb[2], bs[2];
    split_trunc(w.x, bb[0], bs[0]);
    split_trunc(w.y, bb[1], bs[1]);
#pragma unroll
    for (int tl = 0; tl < kPair; ++tl) mma_3xtf32(o[tl][ot], ab[tl], as[tl], bb, bs);
  }
}

// The A fragment of rows [r0, r0 + 16) x channels [k0, k0 + 8) of a
// node-major buffer a (row stride lda), split, in the permuted k order: two
// 8-byte loads.
__device__ __forceinline__ void frag_rows(const float* a, int lda, uint32_t (&ab)[4],
                                          uint32_t (&as)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float2 lo = *reinterpret_cast<const float2*>(a + g * lda + 2 * t);
  const float2 hi = *reinterpret_cast<const float2*>(a + (g + 8) * lda + 2 * t);
  split_trunc(lo.x, ab[0], as[0]);  // a[g][2t]         -> A[g][t]
  split_trunc(hi.x, ab[1], as[1]);  // a[g + 8][2t]     -> A[g + 8][t]
  split_trunc(lo.y, ab[2], as[2]);  // a[g][2t + 1]     -> A[g][t + 4]
  split_trunc(hi.y, ab[3], as[3]);  // a[g + 8][2t + 1] -> A[g + 8][t + 4]
}

// o[tl][ot] += a[tl][16 rows][c] . W^T[oc + 8 ot ..][c] over c < k8, for
// the pair of node tiles a[tl] in shared memory (at its first row and
// channel; row stride lda). An output tile past the layer's channels reads
// rows of W^T that hold no weight; its output is dropped.
template <int NT>
__device__ __forceinline__ void mix_rows(float (&o)[kPair][NT][4], const float* const (&a)[kPair],
                                         int lda, int k8, const float* wts, int ldwt, int oc) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* wa = wts + (oc + g) * ldwt + 2 * t;
  for (int k0 = 0; k0 < k8; k0 += 8) {
    uint32_t ab[kPair][4], as[kPair][4];
#pragma unroll
    for (int tl = 0; tl < kPair; ++tl) frag_rows(a[tl] + k0, lda, ab[tl], as[tl]);
    mix_step(o, ab, as, wa + k0, ldwt);
  }
}

// PReLU(v + b) (act), or v as it is; rows past n are 0 where act.
__device__ __forceinline__ float2 activate(float v0, float v1, bool act, const float* b,
                                           float alpha, bool pad_row) {
  if (!act) return make_float2(v0, v1);
  v0 += b[0];
  v1 += b[1];
  v0 = pad_row ? 0.0f : (v0 >= 0.0f ? v0 : alpha * v0);
  v1 = pad_row ? 0.0f : (v1 >= 0.0f ? v1 : alpha * v1);
  return make_float2(v0, v1);
}

// A lane's two values at row r, channels c, c + 1: to dst (shared, row
// stride ldx, channel c at column col0 + c) or, where dst is null and r < n,
// to out_w [n][co] in device memory (the channels past co dropped).
__device__ __forceinline__ void put2(float2 v, int r, int c, int n, float* dst, int ldx,
                                     int col0, float* __restrict__ out_w, int co) {
  if (dst != nullptr) {
    *reinterpret_cast<float2*>(dst + r * ldx + col0 + c) = v;
  } else if (r < n) {
    float* row = out_w + (long long)r * co;
    if ((co & 1) == 0 && c < co) {
      *reinterpret_cast<float2*>(row + c) = v;
    } else {
      if (c < co) row[c] = v.x;
      if (c + 1 < co) row[c + 1] = v.y;
    }
  }
}

// The tile's rows [r0, r0 + 16) x channels [oc, oc + 8 nt) of o, activated
// or not, to dst at column col0 + channel, or to out_w.
template <int NT>
__device__ __forceinline__ void finish(const float (&o)[NT][4], bool act, const float* bs,
                                       float alpha, int r0, int oc, int nt, int n, float* dst,
                                       int ldx, int col0, float* __restrict__ out_w, int co) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int ot = 0; ot < NT; ++ot) {
    if (ot >= nt) break;
    const int c = oc + 8 * ot + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      const float2 v = activate(o[ot][2 * h], o[ot][2 * h + 1], act, bs + c, alpha, r >= n);
      put2(v, r, c, n, dst, ldx, col0, out_w, co);
    }
  }
}

// The warp's group of kPair node tiles from rt0: rt0, rt0 + kWarps, ...; a
// tile past the last repeats rt0 (walked and mixed with the others, its
// results dropped: no branch between the mma's).
struct TileGroup {
  int rt[kPair];
  int real;  // the tiles that exist
};
__device__ __forceinline__ TileGroup tile_group(int rt0, int tiles) {
  TileGroup tg;
  tg.real = 0;
#pragma unroll
  for (int tl = 0; tl < kPair; ++tl) {
    const int r = rt0 + tl * kWarps;
    tg.rt[tl] = r < tiles ? r : rt0;
    tg.real += r < tiles ? 1 : 0;
  }
  return tg;
}

// acc[tl][w][jj] += the 16 x 8 tile of G = M^T S at the warp's node tile
// tg.rt[tl] and window w's channels [8 jj, 8 jj + 8), over all rows k; S in
// shared memory (row stride ldx, window w's channels at
// columns [w c8, w c8 + c8)), c8 >= 8 NJ > c8 - 8 (a tile past c8 repeats
// the last one and is not used). The warp stages M[k0 .. k0 + kSliceK)[its
// tiles' 16 columns each] into its ring, kStages - 1 slices ahead of the one
// it multiplies; A[r][k] = M[k][r] is read from there, B from S. The loops
// are unrolled with compile-time bounds (NJ): this walk is the kernel's one
// hot loop.
template <int WB, int NJ>
__device__ __forceinline__ void graph_walk(float (&acc)[kPair][WB][NJ][4], const TileGroup& tg,
                                           const float* __restrict__ M, int rows,
                                           const float* s, int ldx, int c8, float* ring) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // A slice row is 4 16-byte copies a tile that exists (a repeated tile
  // reads its slot of the ring unstaged; its results are dropped): lane
  // copies chunk q of row r0 + pass * rpass; the addresses are set once.
  const int steps = rows / kSliceK, per_row = 4 * tg.real, rpass = 32 / per_row;
  const int r0 = lane / per_row, q = lane - r0 * per_row;
  float* dst0 = ring + r0 * kLdm + 4 * q;  // tile q / 4 at columns [16 (q / 4), + 16)
  const float* src0 = M + (long long)r0 * rows + 16 * tg.rt[q >> 2] + 4 * (q & 3);
  auto stage = [&](int step) {
    if (step < steps) {
      float* dst = dst0 + (step % kStages) * kSlice;
      const float* src = src0 + (long long)step * kSliceK * rows;
      for (int pass = 0; pass < kSliceK / rpass; ++pass)
        cp_async16(dst + pass * rpass * kLdm, src + (long long)pass * rpass * rows);
    }
    cp_async_commit();
  };
  int cols[WB][NJ];  // S's column of each B tile
#pragma unroll
  for (int w = 0; w < WB; ++w)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) cols[w][jj] = w * c8 + (8 * jj < c8 ? 8 * jj : c8 - 8) + g;
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) stage(j);
  for (int step = 0; step < steps; ++step) {
    stage(step + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const float* ms = ring + (step % kStages) * kSlice + t * kLdm + g;
    const float* xk = s + (step * kSliceK + t) * ldx;
#pragma unroll
    for (int kk = 0; kk < kSliceK; kk += 8) {
      uint32_t ab[kPair][4], as[kPair][4];
#pragma unroll
      for (int tl = 0; tl < kPair; ++tl) {
        const float* f = ms + kk * kLdm + 16 * tl;
        split_trunc(f[0], ab[tl][0], as[tl][0]);
        split_trunc(f[8], ab[tl][1], as[tl][1]);
        split_trunc(f[4 * kLdm], ab[tl][2], as[tl][2]);
        split_trunc(f[4 * kLdm + 8], ab[tl][3], as[tl][3]);
      }
#pragma unroll
      for (int w = 0; w < WB; ++w)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const float* f = xk + kk * ldx + cols[w][jj];
          uint32_t bb[2], bs[2];
          split_trunc(f[0], bb[0], bs[0]);
          split_trunc(f[4 * ldx], bb[1], bs[1]);
#pragma unroll
          for (int tl = 0; tl < kPair; ++tl) mma_3xtf32(acc[tl][w][jj], ab[tl], as[tl], bb, bs);
        }
    }
    __syncwarp();  // the slice is read before the ring's next copy overwrites it
  }
}

// What a layer's passes work on.
struct LayerPass {
  const float* M;  // [rows][rows]
  float* x;        // the layer's input buffer
  float* xalt;     // the other buffer
  const float* wt;
  const float* wrt;
  const float* bs;
  float* out_w0;   // the block's first window in device memory
  float alpha;
  int ci8, co8, co, n, rows, ldx, ldwt, nwin;
  bool narrow, last, identity;
};

// Where a layer narrows: U = X W into xalt and R = X W_res into x at the
// warp's own rows (after its last read of them), both at the output's
// columns ([w co8, w co8 + co8) for window w), NT >= co8 / 8 tiles.
template <int WB, int NT>
__device__ void narrow_pre(const LayerPass& lp) {
  const int warp = threadIdx.x >> 5, tiles = lp.rows / 16;
  for (int rt0 = warp; rt0 < tiles; rt0 += kPair * kWarps) {
    const TileGroup tg = tile_group(rt0, tiles);
    for (int w = 0; w < WB; ++w) {
      float u[kPair][NT][4] = {}, r[kPair][NT][4] = {};
      const float* xa[kPair];
#pragma unroll
      for (int tl = 0; tl < kPair; ++tl) xa[tl] = lp.x + 16 * tg.rt[tl] * lp.ldx + w * lp.ci8;
      mix_rows(u, xa, lp.ldx, lp.ci8, lp.wt, lp.ldwt, 0);
      mix_rows(r, xa, lp.ldx, lp.ci8, lp.wrt, lp.ldwt, 0);
      __syncwarp();  // every lane's reads of the window's x rows are done
#pragma unroll
      for (int tl = 0; tl < kPair; ++tl) {
        if (tl >= tg.real) break;
        finish(u[tl], false, lp.bs, lp.alpha, 16 * tg.rt[tl], 0, lp.co8 / 8, lp.n, lp.xalt,
               lp.ldx, w * lp.co8, nullptr, 0);
        finish(r[tl], false, lp.bs, lp.alpha, 16 * tg.rt[tl], 0, lp.co8 / 8, lp.n, lp.x,
               lp.ldx, w * lp.co8, nullptr, 0);
      }
    }
  }
}

// The layer's graph contraction, a pair of node tiles a turn (a warp with
// one tile left walks it twice and drops the copy: the loop has no branch
// between its mma's). Every warp passes the first turn, walking M where it
// has tiles, and meets the barrier there: W^T, W_res^T and b are then
// complete. Then, where the layer does not narrow, G goes to xalt at the
// warp's own rows (window w's channels at columns [w ci8, w ci8 + ci8)), for
// the mix; where it narrows, G = M^T U is the output: + R (left in x by
// narrow_pre) + b, PReLU, to x in place or, in the last layer, to device
// memory.
template <int WB, int NJ>
__device__ void graph_layer(const LayerPass& lp, float* ring) {
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int tiles = lp.rows / 16, c8 = lp.narrow ? lp.co8 : lp.ci8;
  const float* s = lp.narrow ? lp.xalt : lp.x;
  for (int rt0 = warp;; rt0 += kPair * kWarps) {
    const bool first = rt0 == warp;
    if (!first && rt0 >= tiles) break;
    const TileGroup tg = tile_group(rt0, tiles);
    float acc[kPair][WB][NJ][4] = {};
    if (rt0 < tiles) graph_walk<WB, NJ>(acc, tg, lp.M, lp.rows, s, lp.ldx, c8, ring);
    if (first) {
      cp_async_wait<0>();
      __syncthreads();
    }
    if (rt0 >= tiles) break;
#pragma unroll
    for (int tl = 0; tl < kPair; ++tl) {
      if (tl >= tg.real) break;
#pragma unroll
      for (int w = 0; w < WB; ++w) {
        if (lp.last && w >= lp.nwin) break;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const int c = 8 * jj + 2 * t;
          if (c >= c8) break;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * tg.rt[tl] + g + 8 * h;
            const float v0 = acc[tl][w][jj][2 * h], v1 = acc[tl][w][jj][2 * h + 1];
            if (!lp.narrow) {
              *reinterpret_cast<float2*>(lp.xalt + r * lp.ldx + w * c8 + c) =
                  make_float2(v0, v1);
              continue;
            }
            const float2 res =
                *reinterpret_cast<const float2*>(lp.x + r * lp.ldx + w * lp.co8 + c);
            const float2 v = activate(v0 + res.x, v1 + res.y, true, lp.bs + c, lp.alpha,
                                      r >= lp.n);
            put2(v, r, c, lp.n, lp.last ? nullptr : lp.x, lp.ldx, w * lp.co8,
                 lp.out_w0 + (long long)w * lp.n * lp.co, lp.co);
          }
        }
      }
    }
  }
}

// Where a layer does not narrow: y = G W + X W_res + b (an identity residual
// adds x), G from xalt at the warp's own rows, into xalt or, in the last
// layer, to device memory; NT tiles of output channels a pass. A window at
// a time, the last first, so that window w's output (columns [w co8, w co8
// + co8), co8 >= ci8) never covers the G of a window still to mix; each
// window's G is read before its output is written.
template <int WB, int NT>
__device__ void mix_layer(const LayerPass& lp) {
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int tiles = lp.rows / 16;
  __syncwarp();  // the warp's G is complete
  for (int rt0 = warp; rt0 < tiles; rt0 += kPair * kWarps) {
    const TileGroup tg = tile_group(rt0, tiles);
    for (int w = WB - 1; w >= 0; --w) {
      if (lp.last && w >= lp.nwin) continue;
      for (int oc = 0; oc < lp.co8; oc += 8 * NT) {
        const int nt = lp.co8 - oc < 8 * NT ? (lp.co8 - oc) / 8 : NT;
        float o[kPair][NT][4] = {};
        const float* ga[kPair];
        const float* xa[kPair];
#pragma unroll
        for (int tl = 0; tl < kPair; ++tl) {
          ga[tl] = lp.xalt + 16 * tg.rt[tl] * lp.ldx + w * lp.ci8;
          xa[tl] = lp.x + 16 * tg.rt[tl] * lp.ldx + w * lp.ci8;
        }
        mix_rows(o, ga, lp.ldx, lp.ci8, lp.wt, lp.ldwt, oc);
        if (lp.identity) {  // C_in == C_out: add x itself
#pragma unroll
          for (int tl = 0; tl < kPair; ++tl)
#pragma unroll
            for (int ot = 0; ot < NT; ++ot) {
              if (ot >= nt) break;
              const float* xe = xa[tl] + g * lp.ldx + oc + 8 * ot + 2 * t;
              const float2 lo = *reinterpret_cast<const float2*>(xe);
              const float2 hi = *reinterpret_cast<const float2*>(xe + 8 * lp.ldx);
              o[tl][ot][0] += lo.x;
              o[tl][ot][1] += lo.y;
              o[tl][ot][2] += hi.x;
              o[tl][ot][3] += hi.y;
            }
        } else {
          mix_rows(o, xa, lp.ldx, lp.ci8, lp.wrt, lp.ldwt, oc);
        }
        __syncwarp();  // every lane's reads of the window's G are done
#pragma unroll
        for (int tl = 0; tl < kPair; ++tl) {
          if (tl >= tg.real) break;
          finish(o[tl], true, lp.bs, lp.alpha, 16 * tg.rt[tl], oc, nt, lp.n,
                 lp.last ? nullptr : lp.xalt, lp.ldx, w * lp.co8,
                 lp.out_w0 + (long long)w * lp.n * lp.co, lp.co);
        }
      }
    }
  }
}

// The least of 1, 2, 4, 8 that is >= v (8 past it).
__device__ __forceinline__ int pow2_tiles(int v) { return v <= 1 ? 1 : v <= 2 ? 2 : v <= 4 ? 4 : 8; }

// One block per WB windows (the last block may hold fewer).
template <int WB>
__global__ void __launch_bounds__(kThreads, 1)
stse_fused_kernel(const float* __restrict__ x,        // [B, C_in0, N]
                  const float* __restrict__ weights,  // packed, see stse_fused.py
                  float* __restrict__ out,            // [B, N, C_out_last]
                  Params p, int batch) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int n = p.n_nodes, rows = p.rows, ldx = p.ldx, ldwt = p.ldwt;
  const Smem sm = smem_layout(p);
  float* xin = smem;            // the layer's input
  float* xalt = smem + sm.act;  // the other buffer
  float* wt = smem + sm.wt;     // W^T [co8][ldwt]
  float* wrt = wt + p.co8_max * ldwt;
  float* bs = smem + sm.bias;
  float* ring = smem + sm.ring + warp * kStages * kSlice;
  const int win0 = blockIdx.x * WB;
  const int nwin = batch - win0 < WB ? batch - win0 : WB;

  {  // the block's windows node-major, 0 past the nodes, channels and windows
    const int ci = p.layers[0].ci, c8 = round8(ci);
    for (int i = 4 * tid; i < rows * ldx; i += 4 * kThreads)
      *reinterpret_cast<float4*>(xin + i) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncthreads();
    const float* xb = x + (long long)win0 * ci * n;  // nwin windows, contiguous
    for (int i = tid; i < nwin * ci * n; i += kThreads) {
      const int wc = i / n, k = i - wc * n, w = wc / ci, c = wc - w * ci;
      cp_async4(xin + k * ldx + w * c8 + c, xb + i);
    }
    cp_async_commit();
  }

  for (int l = 0; l < p.n_layers; ++l) {
    const LayerDesc L = p.layers[l];
    LayerPass lp;
    lp.ci8 = round8(L.ci);
    lp.co8 = round8(L.co);
    cp_async_wait<0>();  // this thread's copies of the input (layer 0)
    __syncthreads();     // xin complete; the last layer's reads of W^T, b and xalt done
    // This layer's W^T, W_res^T and b by 4-byte cp.async, complete at the
    // barrier in graph_layer: they land while the warps walk M (a narrowing
    // layer waits for them now).
    for (int i = tid; i < lp.ci8 * lp.co8; i += kThreads) {
      const int c = i / lp.co8, o = i - c * lp.co8;
      cp_async4(wt + o * ldwt + c, weights + L.off_w + i);
      if (!L.identity) cp_async4(wrt + o * ldwt + c, weights + L.off_wr + i);
    }
    for (int i = tid; i < lp.co8; i += kThreads) cp_async4(bs + i, weights + L.off_b + i);
    cp_async_commit();
    lp.M = weights + L.off_m;
    lp.x = xin;
    lp.xalt = xalt;
    lp.wt = wt;
    lp.wrt = wrt;
    lp.bs = bs;
    lp.out_w0 = out + (long long)win0 * n * L.co;
    lp.alpha = __ldg(weights + L.off_alpha);
    lp.co = L.co;
    lp.n = n;
    lp.rows = rows;
    lp.ldx = ldx;
    lp.ldwt = ldwt;
    lp.nwin = nwin;
    lp.narrow = L.co < L.ci;
    lp.last = l == p.n_layers - 1;
    lp.identity = L.identity;
    const int nt = pow2_tiles(lp.co8 / 8);

    if (lp.narrow) {
      cp_async_wait<0>();
      __syncthreads();  // W^T complete
      switch (nt) {
        case 1: narrow_pre<WB, 1>(lp); break;
        case 2: narrow_pre<WB, 2>(lp); break;
        case 4: narrow_pre<WB, 4>(lp); break;
        default: narrow_pre<WB, 8>(lp);
      }
      __syncthreads();  // U complete
    }
    switch (pow2_tiles((lp.narrow ? lp.co8 : lp.ci8) / 8)) {
      case 1: graph_layer<WB, 1>(lp, ring); break;
      case 2: graph_layer<WB, 2>(lp, ring); break;
      case 4: graph_layer<WB, 4>(lp, ring); break;
      default: graph_layer<WB, (WB == 1 ? 8 : 4)>(lp, ring);  // WB 1 only: 5-8 tiles
    }
    if (lp.narrow) continue;  // the output is in xin
    switch (nt) {
      case 1: mix_layer<WB, 1>(lp); break;
      case 2: mix_layer<WB, 2>(lp); break;
      case 4: mix_layer<WB, 4>(lp); break;
      default: mix_layer<WB, 8>(lp);
    }
    float* tmp = xin;
    xin = xalt;
    xalt = tmp;
  }
}

typedef void (*Kernel)(const float*, const float*, float*, Params, int);

// The launch's parameters, windows a block and shared bytes for this layout;
// cudaErrorInvalidValue for a layout the kernel does not take (more than
// kMaxLayers layers, a graph contraction wider than 64 channels or an inner
// layer putting out more, activations past kMaxSmem). Touches no device:
// the eval forward asks it which route to take (stse_fused_plan).
int plan_layout(const long long* layout, int n_layers, int n_nodes, int n_pad, Params& p,
                int& wb, long long& smem) {
  if (n_layers < 1 || n_layers > kMaxLayers || n_nodes < 1 || n_pad % 16 != 0 ||
      n_pad < n_nodes)
    return (int)cudaErrorInvalidValue;
  p.n_layers = n_layers;
  p.n_nodes = n_nodes;
  p.rows = n_pad;
  int act8 = 0, ci8_max = 0, g8_max = 0;
  p.co8_max = 0;
  for (int l = 0; l < n_layers; ++l) {
    const long long* r = layout + 8 * l;
    LayerDesc& d = p.layers[l];
    d.ci = (int)r[0];
    d.co = (int)r[1];
    d.identity = (int)r[2];
    d.off_m = r[3];
    d.off_w = r[4];
    d.off_wr = r[5];
    d.off_b = r[6];
    d.off_alpha = r[7];
    if (d.ci < 1 || d.co < 1 || (d.identity && d.ci != d.co) || d.off_m % 4 != 0)
      return (int)cudaErrorInvalidValue;
    if (l > 0 && d.ci != p.layers[l - 1].co) return (int)cudaErrorInvalidValue;
    const int ci8 = round8(d.ci), co8 = round8(d.co), g8 = ci8 < co8 ? ci8 : co8;
    // an inner layer's output is mixed in one pass of kOutTiles tiles, in place
    if (l < n_layers - 1 && co8 > 8 * kOutTiles) return (int)cudaErrorInvalidValue;
    act8 = ci8 > act8 ? ci8 : act8;
    if (l < n_layers - 1) act8 = co8 > act8 ? co8 : act8;
    ci8_max = ci8 > ci8_max ? ci8 : ci8_max;
    g8_max = g8 > g8_max ? g8 : g8_max;
    p.co8_max = co8 > p.co8_max ? co8 : p.co8_max;
  }
  if (g8_max > 64) return (int)cudaErrorInvalidValue;  // G holds at most 8 tiles a window
  p.ldwt = pad_stride(ci8_max);
  for (wb = 2; wb >= 1; --wb) {  // the most windows a block that fit
    if (wb == 2 && g8_max > 32) continue;  // two windows' G: at most 4 tiles each
    p.ldx = pad_stride(wb * act8);
    smem = (long long)sizeof(float) * smem_layout(p).total;
    if (smem <= kMaxSmem) break;
  }
  return wb < 1 ? (int)cudaErrorInvalidValue : (int)cudaSuccess;
}

// plan_layout, then the kernel for its windows a block, opted into its
// shared bytes; a cudaError_t.
int plan(const long long* layout, int n_layers, int n_nodes, int n_pad, Params& p, int& wb,
         Kernel& kernel, long long& smem) {
  const int err = plan_layout(layout, n_layers, n_nodes, n_pad, p, wb, smem);
  if (err != 0) return err;
  kernel = wb == 2 ? stse_fused_kernel<2> : stse_fused_kernel<1>;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

}  // namespace

// ---------------------------------------------------------------------------
// The bf16 form, stse_fused_bf16_kernel: the eval encoder of a model whose
// compute dtype is bf16 (every shipped config), at the module path's own
// rounding points (models/stsgcn.py: STSGCNLayer.forward, dense_bn,
// SpaceTimeGraphConv). Each layer computes
//
//     x_r = bf16(x)                          x the layer's input
//     G   = bf16(M_r^T x_r)                  M_r = bf16(M), rounded at fold time
//     h   = bf16(bf16(G W) + b)              W, b: BatchNorm folded as dense_bn
//     res = x_r, or bf16(bf16(x_r W_res) + b_res)
//     y   = PReLU(bf16(h + res))             float32, the slope float32
//
// with b and b_res kept apart. Every product multiplies bf16 values exactly
// and sums them in float32: one bf16 mma.sync a product (m16n8k16, m16n8k8
// where a depth leaves 8), where the float32 form takes three (3xTF32). A
// narrowing layer is not reassociated: M_r^T contracts the C_in channels of
// x_r, as the modules and JAX do (M^T (x W) would move the rounding points).
//
// What bounds it on an H100: at the HR-STC widths (204 nodes, channels
// 2->32->16->32->64) a window needs ~9.4 MFLOP against 1.6 KB read and 52 KB
// written (the float32 hidden state the projector reads): bytes, ~180 FLOP
// per byte under the bf16 ridge of ~295 (989 TFLOP/s over 3.35 TB/s). Short
// of that, feeding mma.sync from shared memory limits it: the kernel reads
// two 32-bit B registers for every graph product.
//
// Design, beside the float32 form's:
//   * the activations stay in shared memory as bf16 bits, channel-major
//     [wb * cs][ldn] (a row is window w's channel c, a column a node; ldn =
//     rows + 8, 4 mod 8 words), so the graph product's B fragment, a pair
//     along the node axis, is one 32-bit load on 32 banks. Every value kept
//     between layers is exactly a bf16 value, as each layer rounds its input;
//   * M_r^T is packed bf16 [rows][rows]; a warp owns a 16-node output tile
//     and stages its rows of M_r^T, 16 x 16 a slice, in a ring of its own
//     (kBfStages slices, one 16-byte cp.async a lane), as the float32 form
//     stages M; one block walks each layer's M_r^T once for its windows;
//   * the warp holds G for each of the block's windows in registers. The
//     m16n8 accumulator's layout is m16n8k16's A fragment (tiles 2j and 2j +
//     1 give a chunk's four registers), so G rounded by cvt.rn.bf16x2 is the
//     mix's operand and never goes to shared memory, and the layer needs no
//     barrier between its product and its mix;
//   * the mixes read W^T and W_res^T (bf16 [co8][ci16]) and b, b_res from
//     device memory through the read-only cache; x_r's residual fragment
//     pairs two channel rows (two 16-bit loads);
//   * a warp writes only its own nodes of the next layer's input, so a layer
//     needs one barrier, before it; the last layer writes float32 [B, N,
//     C_out] for the projector. Padded nodes are written 0, padded channels
//     come out 0 (zero-padded weights and biases), and a ragged last block
//     computes on zero windows and writes only its real ones;
//   * windows a block (4, 2 or 1, bf16_plan_layout): the most that keep a
//     warp's G within kBfMaxTiles accumulator tiles and the activations and
//     rings within a block's shared memory;
//   * no atomics: every sum is taken in a fixed order, so two launches give
//     the same bits.
// wgmma is not used: its 64-row tiles would cover four of these 16-node
// tiles with one warpgroup, leaving the block 13 tiles at 204 nodes as 4
// warpgroup tiles and its B operand (2-64 channels a window) far below the
// widths where the asynchronous product pays; mma.sync keeps a warp a tile.

namespace {

constexpr int kBfMaxWarps = 16;
constexpr int kBfThreads = 32 * kBfMaxWarps;
constexpr int kBfStages = 4;           // slices of M_r^T a warp has staged or in flight
constexpr int kBfLds = 24;             // a slice's row stride in bf16: 12 words, 4 mod 8
constexpr int kBfSlice = 16 * kBfLds;  // bf16 elements a slice: 16 rows x 16 k
constexpr int kBfMaxTiles = 16;        // windows x channel tiles of a warp's G

typedef unsigned short bf16_raw;  // the bits of a bf16 value

struct BfLayer {
  int ci, co, identity;
  long long off_mt, off_wt, off_wrt, off_b, off_alpha;  // float offsets
};

struct BfParams {
  BfLayer layers[kMaxLayers];
  int n_layers;
  int n_nodes;  // N = T*V
  int rows;     // N rounded up to 16: M_r^T is [rows][rows]
  int warps;    // rows / 16 node tiles, at most kBfMaxWarps warps
  int cs;       // activation rows a window: the widest layer input, rounded up to 8
  int ldn;      // activation row stride in bf16: rows + 8
};

// Shared bytes: two activation buffers [wb * cs][ldn], then each warp's ring.
__host__ __device__ inline long long bf_smem_bytes(const BfParams& p, int wb) {
  return 2LL * 2 * wb * p.cs * p.ldn + 2LL * p.warps * kBfStages * kBfSlice;
}

// The least of 1, 2, 4, 8 that is >= v (8 past it).
__host__ __device__ inline int bf_pow2(int v) { return v <= 1 ? 1 : v <= 2 ? 2 : v <= 4 ? 4 : 8; }

// v rounded to bf16 (to nearest even), as a float, and as its bits; a bf16
// value from its bits; the pair p[0], p[1] as one fragment register.
__device__ __forceinline__ float bf16_round(float v) { return __uint_as_float(bf16_bits(v)); }
__device__ __forceinline__ bf16_raw bf16_of(float v) { return (bf16_raw)(bf16_bits(v) >> 16); }
__device__ __forceinline__ float bf16_value(bf16_raw h) {
  return __uint_as_float((uint32_t)h << 16);
}
__device__ __forceinline__ uint32_t pair32(const bf16_raw* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc[w][j] += the 16 x 8 tile of G = M_r^T X at nodes [m0, m0 + 16) and
// window w's channels [8 j, 8 j + 8), for j < tiles <= NJ, over every node k
// < rows: A = M_r^T's rows from the warp's ring, B = X from xs (channel-major,
// row stride ldn, window w's channel c at row w cs + c). The warp stages
// M_r^T[m0 .. m0 + 16)[16 s .. 16 s + 16) kBfStages - 1 slices ahead of the
// one it multiplies.
template <int WB, int NJ>
__device__ __forceinline__ void bf_graph_walk(float (&acc)[WB][NJ][4], int m0, int tiles,
                                              const bf16_raw* __restrict__ mt, int rows,
                                              const bf16_raw* xs, int ldn, int cs, bf16_raw* ring) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
  const int steps = rows / 16;
  // lane copies 16 bytes: slice row lane / 2, columns [8 (lane % 2), + 8)
  bf16_raw* dst0 = ring + (lane >> 1) * kBfLds + 8 * (lane & 1);
  const bf16_raw* src0 = mt + (long long)(m0 + (lane >> 1)) * rows + 8 * (lane & 1);
  auto stage = [&](int step) {
    if (step < steps) cp_async16(dst0 + (step % kBfStages) * kBfSlice, src0 + 16 * step);
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kBfStages - 1; ++s) stage(s);
  for (int step = 0; step < steps; ++step) {
    stage(step + kBfStages - 1);
    cp_async_wait<kBfStages - 1>();
    __syncwarp();
    const bf16_raw* a = ring + (step % kBfStages) * kBfSlice + g * kBfLds + t2;
    const uint32_t af[4] = {pair32(a), pair32(a + 8 * kBfLds), pair32(a + 8),
                            pair32(a + 8 * kBfLds + 8)};
    const bf16_raw* xk = xs + g * ldn + 16 * step + t2;
#pragma unroll
    for (int w = 0; w < WB; ++w)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j >= tiles) break;
        const bf16_raw* b = xk + (w * cs + 8 * j) * ldn;
        const uint32_t bf[2] = {pair32(b), pair32(b + 8)};
        mma_bf16_k16(acc[w][j], af, bf);
      }
    __syncwarp();  // the slice is read before the ring's next copy overwrites it
  }
}

// What a layer's mix works on.
struct BfPass {
  const bf16_raw* x;    // the layer's input, x_r [wb * cs][ldn] in shared memory
  bf16_raw* y;          // the next layer's input, or null in the last layer
  const bf16_raw* wt;   // W^T [co8][ci16] in device memory
  const bf16_raw* wrt;  // W_res^T, likewise (not read where identity)
  const float* b;       // b [co8], then b_res [co8]
  float* out_w0;        // the last layer's output for the block's first window
  float alpha;
  int ci8, ci16, co, co8, n, ldn, cs, nwin;
  bool identity;
};

// The layer's output at the warp's nodes [m0, m0 + 16) from G (acc, in
// float32): h = bf16(bf16(G W) + b), res, y = PReLU(bf16(h + res)), to the
// next layer's input as bf16 (0 at padded nodes) or, in the last layer, to
// device memory as float32, an 8-channel output tile a turn.
template <int WB, int NJ>
__device__ __forceinline__ void bf_mix(const float (&acc)[WB][NJ][4], int m0, const BfPass& lp) {
  constexpr int KC = (NJ + 1) / 2;  // chunks of 16 channels (one of 8 where NJ is 1)
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
  uint32_t gf[WB][KC][4];  // G rounded to bf16: the accumulators as A fragments
#pragma unroll
  for (int w = 0; w < WB; ++w)
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      gf[w][kc][0] = pack_bf16x2(acc[w][2 * kc][0], acc[w][2 * kc][1]);
      gf[w][kc][1] = pack_bf16x2(acc[w][2 * kc][2], acc[w][2 * kc][3]);
      if (2 * kc + 1 < NJ) {
        gf[w][kc][2] = pack_bf16x2(acc[w][2 * kc + 1][0], acc[w][2 * kc + 1][1]);
        gf[w][kc][3] = pack_bf16x2(acc[w][2 * kc + 1][2], acc[w][2 * kc + 1][3]);
      }
    }
  // x_r's pair at channels c, c + 1 of node m (two rows), 0 past C_in's tiles
  auto xpair = [&](int w, int c, int m) -> uint32_t {
    if (c >= lp.ci8) return 0u;
    const bf16_raw* p = lp.x + (w * lp.cs + c) * lp.ldn + m;
    return (uint32_t)p[0] | (uint32_t)p[lp.ldn] << 16;
  };
  for (int oc = 0; oc < lp.co8; oc += 8) {
    // W^T's and W_res^T's B fragments at output channels [oc, oc + 8)
    uint32_t wf[KC][2], wrf[KC][2];
    const bf16_raw* wrow = lp.wt + (oc + g) * lp.ci16 + t2;
    const bf16_raw* wrrow = lp.wrt + (oc + g) * lp.ci16 + t2;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      if (16 * kc >= lp.ci8) break;
      wf[kc][0] = __ldg(reinterpret_cast<const unsigned int*>(wrow + 16 * kc));
      wf[kc][1] = NJ > 1 ? __ldg(reinterpret_cast<const unsigned int*>(wrow + 16 * kc + 8)) : 0u;
      if (!lp.identity) {
        wrf[kc][0] = __ldg(reinterpret_cast<const unsigned int*>(wrrow + 16 * kc));
        wrf[kc][1] =
            NJ > 1 ? __ldg(reinterpret_cast<const unsigned int*>(wrrow + 16 * kc + 8)) : 0u;
      }
    }
    const int c0 = oc + t2;
    const float bh[2] = {__ldg(lp.b + c0), __ldg(lp.b + c0 + 1)};
    const float br[2] = {__ldg(lp.b + lp.co8 + c0), __ldg(lp.b + lp.co8 + c0 + 1)};
#pragma unroll
    for (int w = 0; w < WB; ++w) {
      float o[4] = {0.0f, 0.0f, 0.0f, 0.0f}, r[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        if (16 * kc >= lp.ci8) break;
        if constexpr (NJ == 1) {
          const uint32_t a[2] = {gf[w][0][0], gf[w][0][1]};
          mma_bf16_k8(o, a, wf[0][0]);
        } else {
          mma_bf16_k16(o, gf[w][kc], wf[kc]);
        }
        if (lp.identity) continue;
        const int k = 16 * kc + t2;
        if constexpr (NJ == 1) {
          const uint32_t a[2] = {xpair(w, k, m0 + g), xpair(w, k, m0 + g + 8)};
          mma_bf16_k8(r, a, wrf[0][0]);
        } else {
          const uint32_t a[4] = {xpair(w, k, m0 + g), xpair(w, k, m0 + g + 8),
                                 xpair(w, k + 8, m0 + g), xpair(w, k + 8, m0 + g + 8)};
          mma_bf16_k16(r, a, wrf[kc]);
        }
      }
      float y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + g + (i >= 2 ? 8 : 0), c = c0 + (i & 1);
        const float h = bf16_round(bf16_round(o[i]) + bh[i & 1]);
        const float res = lp.identity ? bf16_value(lp.x[(w * lp.cs + c) * lp.ldn + m])
                                      : bf16_round(bf16_round(r[i]) + br[i & 1]);
        const float s = bf16_round(h + res);
        y[i] = s >= 0.0f ? s : lp.alpha * s;
        if (lp.y != nullptr)
          lp.y[(w * lp.cs + c) * lp.ldn + m] = m < lp.n ? bf16_of(y[i]) : (bf16_raw)0;
      }
      if (lp.y != nullptr || w >= lp.nwin) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {  // rows g and g + 8: channels c0, c0 + 1
        const int m = m0 + g + 8 * hh;
        if (m >= lp.n) continue;
        float* row = lp.out_w0 + ((long long)w * lp.n + m) * lp.co;
        if ((lp.co & 1) == 0 && c0 < lp.co) {
          *reinterpret_cast<float2*>(row + c0) = make_float2(y[2 * hh], y[2 * hh + 1]);
        } else {
          if (c0 < lp.co) row[c0] = y[2 * hh];
          if (c0 + 1 < lp.co) row[c0 + 1] = y[2 * hh + 1];
        }
      }
    }
  }
}

// One layer: each of the warp's node tiles walked (G for every window),
// then mixed and written.
template <int WB, int NJ>
__device__ void bf_layer(const BfPass& lp, const bf16_raw* __restrict__ mt, int rows, int warps,
                         bf16_raw* ring) {
  const int warp = threadIdx.x >> 5;
  for (int tile = warp; tile < rows / 16; tile += warps) {
    float acc[WB][NJ][4] = {};
    bf_graph_walk<WB, NJ>(acc, 16 * tile, lp.ci8 / 8, mt, rows, lp.x, lp.ldn, lp.cs, ring);
    bf_mix<WB, NJ>(acc, 16 * tile, lp);
  }
}

// NJ as instantiated for WB windows: the planner keeps WB * NJ <= kBfMaxTiles.
__host__ __device__ constexpr int bf_nj(int wb, int nj) {
  return wb * nj <= kBfMaxTiles ? nj : kBfMaxTiles / wb;
}

// One block per WB windows (the last block may hold fewer), 32 p.warps threads.
template <int WB>
__global__ void __launch_bounds__(kBfThreads, 1)
stse_fused_bf16_kernel(const float* __restrict__ x,        // [B, C_in0, N] float32
                       const float* __restrict__ weights,  // packed, see stse_fused.py
                       float* __restrict__ out,            // [B, N, C_out_last] float32
                       BfParams p, int batch) {
  extern __shared__ __align__(16) float smem_bf16[];
  const int tid = threadIdx.x, warp = tid >> 5, threads = 32 * p.warps;
  const long long act = (long long)WB * p.cs * p.ldn;
  bf16_raw* xin = reinterpret_cast<bf16_raw*>(smem_bf16);
  bf16_raw* xalt = xin + act;
  bf16_raw* ring = xin + 2 * act + warp * kBfStages * kBfSlice;
  const int win0 = blockIdx.x * WB;
  const int nwin = batch - win0 < WB ? batch - win0 : WB;
  const int n = p.n_nodes;

  {  // x_r: the block's windows rounded to bf16, channel-major; 0 past the
     // nodes, channels and windows
    const int ci = p.layers[0].ci;
    const float* xb = x + (long long)win0 * ci * n;  // nwin windows, contiguous
    for (int i = tid; i < act; i += threads) {
      const int row = i / p.ldn, k = i - row * p.ldn, w = row / p.cs, c = row - w * p.cs;
      xin[i] = w < nwin && c < ci && k < n ? bf16_of(xb[((long long)w * ci + c) * n + k])
                                            : (bf16_raw)0;
    }
  }

  for (int l = 0; l < p.n_layers; ++l) {
    __syncthreads();  // the layer's input complete; the last layer's reads of xalt done
    const BfLayer L = p.layers[l];
    BfPass lp;
    lp.x = xin;
    lp.y = l == p.n_layers - 1 ? nullptr : xalt;
    lp.wt = reinterpret_cast<const bf16_raw*>(weights + L.off_wt);
    lp.wrt = reinterpret_cast<const bf16_raw*>(weights + L.off_wrt);
    lp.b = weights + L.off_b;
    lp.out_w0 = out + (long long)win0 * n * L.co;
    lp.alpha = __ldg(weights + L.off_alpha);
    lp.ci8 = round8(L.ci);
    lp.ci16 = (L.ci + 15) & ~15;
    lp.co = L.co;
    lp.co8 = round8(L.co);
    lp.n = n;
    lp.ldn = p.ldn;
    lp.cs = p.cs;
    lp.nwin = nwin;
    lp.identity = L.identity != 0;
    const bf16_raw* mt = reinterpret_cast<const bf16_raw*>(weights + L.off_mt);
    switch (bf_pow2(lp.ci8 / 8)) {
      case 1: bf_layer<WB, 1>(lp, mt, p.rows, p.warps, ring); break;
      case 2: bf_layer<WB, 2>(lp, mt, p.rows, p.warps, ring); break;
      case 4: bf_layer<WB, bf_nj(WB, 4)>(lp, mt, p.rows, p.warps, ring); break;
      default: bf_layer<WB, bf_nj(WB, 8)>(lp, mt, p.rows, p.warps, ring);
    }
    bf16_raw* tmp = xin;
    xin = xalt;
    xalt = tmp;
  }
}

typedef void (*BfKernel)(const float*, const float*, float*, BfParams, int);

// The bf16 form's launch parameters, windows a block and shared bytes for
// this layout; cudaErrorInvalidValue for a layout it does not take (more
// than kMaxLayers layers, a layer contracting more than 64 channels, or
// activations and rings past kMaxSmem at one window a block). Touches no
// device (stse_fused_bf16_plan).
int bf16_plan_layout(const long long* layout, int n_layers, int n_nodes, int n_pad,
                     BfParams& p, int& wb, long long& smem) {
  if (n_layers < 1 || n_layers > kMaxLayers || n_nodes < 1 || n_pad % 16 != 0 ||
      n_pad < n_nodes)
    return (int)cudaErrorInvalidValue;
  p.n_layers = n_layers;
  p.n_nodes = n_nodes;
  p.rows = n_pad;
  p.warps = n_pad / 16 < kBfMaxWarps ? n_pad / 16 : kBfMaxWarps;
  p.ldn = n_pad + 8;
  p.cs = 0;
  int nj_max = 1;
  for (int l = 0; l < n_layers; ++l) {
    const long long* r = layout + 8 * l;
    BfLayer& d = p.layers[l];
    d.ci = (int)r[0];
    d.co = (int)r[1];
    d.identity = (int)r[2];
    d.off_mt = r[3];
    d.off_wt = r[4];
    d.off_wrt = r[5];
    d.off_b = r[6];
    d.off_alpha = r[7];
    if (d.ci < 1 || d.co < 1 || (d.identity && d.ci != d.co) || d.off_mt % 4 != 0)
      return (int)cudaErrorInvalidValue;
    if (l > 0 && d.ci != p.layers[l - 1].co) return (int)cudaErrorInvalidValue;
    const int ci8 = round8(d.ci);
    if (ci8 > 64) return (int)cudaErrorInvalidValue;  // G holds at most 8 tiles a window
    nj_max = bf_pow2(ci8 / 8) > nj_max ? bf_pow2(ci8 / 8) : nj_max;
    p.cs = ci8 > p.cs ? ci8 : p.cs;
  }
  for (wb = 4; wb >= 1; wb /= 2) {  // the most windows a block that fit
    if (wb * nj_max > kBfMaxTiles) continue;
    smem = bf_smem_bytes(p, wb);
    if (smem <= kMaxSmem) break;
  }
  return wb < 1 ? (int)cudaErrorInvalidValue : (int)cudaSuccess;
}

// bf16_plan_layout, then the kernel for its windows a block, opted into its
// shared bytes; a cudaError_t.
int bf16_plan(const long long* layout, int n_layers, int n_nodes, int n_pad, BfParams& p,
              int& wb, BfKernel& kernel, long long& smem) {
  const int err = bf16_plan_layout(layout, n_layers, n_nodes, n_pad, p, wb, smem);
  if (err != 0) return err;
  kernel = wb == 4 ? stse_fused_bf16_kernel<4>
                   : wb == 2 ? stse_fused_bf16_kernel<2> : stse_fused_bf16_kernel<1>;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

}  // namespace

extern "C" {

const char* stse_fused_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// layout: host array of n_layers rows of 8 int64:
//   ci, co, identity, off_m, off_w, off_wr, off_b, off_alpha
// (M [n_pad][n_pad], W and W_res [ci8][co8], b [co8], zero-padded; n_pad a
// multiple of 16). Returns a cudaError_t (0 on success). The launch is
// asynchronous on `stream`; the return value reports refused launches, not
// faults while the kernel runs.
int stse_fused_forward(const float* x, const float* weights, const long long* layout,
                       int n_layers, int batch, int n_nodes, int n_pad, float* out,
                       void* stream) {
  if (batch < 1) return (int)cudaErrorInvalidValue;
  Params p;
  int wb;
  Kernel kernel;
  long long smem;
  const int err = plan(layout, n_layers, n_nodes, n_pad, p, wb, kernel, smem);
  if (err != 0) return err;
  const dim3 grid((batch + wb - 1) / wb);
  kernel<<<grid, kThreads, (size_t)smem, (cudaStream_t)stream>>>(x, weights, out, p, batch);
  return (int)cudaGetLastError();
}

// Whether the kernel takes this layout (0) or not (cudaErrorInvalidValue),
// from the planner a launch runs, with no device touched; where it does,
// out[0] windows a block and out[1] shared bytes a block.
int stse_fused_plan(const long long* layout, int n_layers, int n_nodes, int n_pad, int* out) {
  Params p;
  int wb;
  long long smem;
  const int err = plan_layout(layout, n_layers, n_nodes, n_pad, p, wb, smem);
  if (err == 0) {
    out[0] = wb;
    out[1] = (int)smem;
  }
  return err;
}

// What a launch on this layout would use: out[0] windows a block, out[1]
// shared bytes a block, out[2] blocks an SM on the current device.
int stse_fused_occupancy(const long long* layout, int n_layers, int n_nodes, int n_pad,
                         int* out) {
  Params p;
  int wb;
  Kernel kernel;
  long long smem;
  int err = plan(layout, n_layers, n_nodes, n_pad, p, wb, kernel, smem);
  if (err != 0) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads,
                                                           (size_t)smem);
  out[0] = wb;
  out[1] = (int)smem;
  out[2] = blocks;
  return err;
}

// The bf16 form (stse_fused_bf16_kernel) on the same arguments: x float32
// [B, C_in, N]; layout rows ci, co, identity, off_mt, off_wt, off_wrt,
// off_b, off_alpha (M_r^T bf16 [n_pad][n_pad], W^T and W_res^T bf16
// [co8][ci16], b then b_res float32 [co8] each, the slope float32; the bf16
// segments held in the float32 buffer, two values a float); out float32
// [B, N, C_out]. Returns a cudaError_t, as stse_fused_forward.
int stse_fused_bf16_forward(const float* x, const float* weights, const long long* layout,
                            int n_layers, int batch, int n_nodes, int n_pad, float* out,
                            void* stream) {
  if (batch < 1) return (int)cudaErrorInvalidValue;
  BfParams p;
  int wb;
  BfKernel kernel;
  long long smem;
  const int err = bf16_plan(layout, n_layers, n_nodes, n_pad, p, wb, kernel, smem);
  if (err != 0) return err;
  const dim3 grid((batch + wb - 1) / wb);
  kernel<<<grid, 32 * p.warps, (size_t)smem, (cudaStream_t)stream>>>(x, weights, out, p, batch);
  return (int)cudaGetLastError();
}

// Whether the bf16 form takes this layout (0) or not, from its planner, with
// no device touched; where it does, out[0] windows a block and out[1] shared
// bytes a block.
int stse_fused_bf16_plan(const long long* layout, int n_layers, int n_nodes, int n_pad,
                         int* out) {
  BfParams p;
  int wb;
  long long smem;
  const int err = bf16_plan_layout(layout, n_layers, n_nodes, n_pad, p, wb, smem);
  if (err == 0) {
    out[0] = wb;
    out[1] = (int)smem;
  }
  return err;
}

// What a bf16 launch on this layout would use: out[0] windows a block,
// out[1] shared bytes a block, out[2] blocks an SM on the current device,
// out[3] threads a block.
int stse_fused_bf16_occupancy(const long long* layout, int n_layers, int n_nodes, int n_pad,
                              int* out) {
  BfParams p;
  int wb;
  BfKernel kernel;
  long long smem;
  int err = bf16_plan(layout, n_layers, n_nodes, n_pad, p, wb, kernel, smem);
  if (err != 0) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, 32 * p.warps,
                                                           (size_t)smem);
  out[0] = wb;
  out[1] = (int)smem;
  out[2] = blocks;
  out[3] = 32 * p.warps;
  return err;
}

}  // extern "C"
