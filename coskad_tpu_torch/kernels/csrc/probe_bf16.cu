// bf16 operand probes: one small kernel per job of scripts/probe_mosaic.py.
//
// Replaces the Pallas kernel P of scripts/probe_mosaic.py: `run` (:27,
// pallas_call :32) with the job bodies of `main` (:56-97) and `extra_jobs`
// (:107-138). On the TPU each job compiled one Mosaic op class (lhsT dots,
// mixed-dtype selects, bf16 min, transposes, 2D x 3D dots) to find what the
// remote compiler rejected in bf16 backward payloads. Here each job is the
// same function as a CUDA kernel on bf16 operands with f32 accumulation:
// the operand forms the bf16 compute_dtype of K2-K5 needs on Hopper (a load
// rounded to bf16, bf16 compares, selects, products and min, bf16
// transposes through shared memory, bf16 dots summed in f32 on the tensor
// cores).
//
// Every job takes the probe's inputs, a and b [C, BB, N] = [32, 64, 256]
// f32, rounds them to bf16 (round to nearest even, as `.astype(bf16)`) and
// writes [32, 64, 256] f32 ([32, 256, 64] for transpose_pure). What bounds
// them on an H100: bytes (at most 4 MB in and 2 MB out, a few MFLOP), and
// at this size the ramp of a launch. The design, for 132 SMs:
//   - dot0 (the lhsT dot) reads A = a as [2048, 256] once, row by row, 64
//     columns of it in 16-byte loads, rounds each value to bf16 once into
//     shared memory as k-pairs, and runs the [32 x 2048] x [2048 x 64]
//     product on the bf16 mma.sync, split over 128 blocks of 16 rows; a
//     second kernel sums the 128 partials in a fixed order and writes the
//     broadcast on all SMs in 16-byte stores;
//   - min_bf16 splits each channel over 8 blocks (256 in all), 16-byte
//     loads, then the same second kernel sums the 8 partials in order and
//     writes the broadcast. Both sums are the same bits from run to run;
//   - the selects and transpose_merge: 512 blocks, 16-byte loads and
//     stores, bf16x2 products and compares; the transposes (a 32 x 32 bf16
//     tile a block) and dotg (a thread a (q, n) column) as first written:
//     within 2x of their bound and faster than one PyTorch call.
// PERF.md (PR 17) has each job's time beside its bound and the variants'.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kC = 32, kBB = 64, kN = 256;
constexpr int kCount = kC * kBB * kN;
constexpr int kThreads = 256;

// dot0: the contraction's 2048 rows of A in blocks of 16 (one m16n8k16
// step), 4 warps a block, warp w the 16 x 32 tile at c0 = 16 (w & 1), q0 =
// 32 (w >> 1) of the [32, 64] result; the sums kDotSumRows rows of the
// result a block (256 blocks). The other splits probe_variants.py tries
// (8 or 32 rows a partial, 16 or 32 rows a sum block) ran no faster.
constexpr int kDotRows = 16;
constexpr int kDotBlocks = kC * kBB / kDotRows;  // 128 partial products
constexpr int kDotThreads = 128;
constexpr int kDotSumRows = 8;
constexpr int kPairLd = kBB + 8;  // words a row of k-pairs: 72 = 8 mod 32, no bank conflict
// min_bf16: a channel's 16,384 products over 8 blocks of 2,048 (4 or 16
// blocks ran no faster).
constexpr int kMinSplits = 8;
constexpr int kMinSpan = kBB * kN / kMinSplits;
static_assert(kMinSpan % (4 * kThreads) == 0, "whole float4s a thread");
// The selects: a thread a float4 of each input, 512 blocks (2 float4s a
// thread on 256 blocks ran 1.2x slower; probe_variants.py).
constexpr int kElemThreads = 256, kElemBlocks = 512;
constexpr int kElemVec = kCount / 4 / (kElemBlocks * kElemThreads);
static_assert(kElemVec * 4 * kElemBlocks * kElemThreads == kCount, "whole float4s a thread");
// transpose_merge: kMergeRows output rows (i, q) a block.
constexpr int kMergeBlocks = 512;
constexpr int kMergeRows = kC * kBB / kMergeBlocks;
// The partials' workspace, in floats: dot0's [128][32][64], min's [8][32].
constexpr int kWorkspace = kDotBlocks * kC * kBB;
static_assert(kMinSplits * kC <= kWorkspace, "min's partials fit the workspace");

// In the order of JOBS in probe.py.
enum Job {
  DOT0_BF16, DOT0_SMALL_BF16, WHERE_MIXED, MIN_BF16, TRANSPOSE_BF16, DOTG_BF16, WHERE_CLEAN,
  WHERE_F32PRED, WHERE_CONST_SCALAR, TRANSPOSE_PURE, TRANSPOSE_MERGE, JOB_COUNT
};

__device__ __forceinline__ __nv_bfloat16 bf(float v) { return __float2bfloat16(v); }
__device__ __forceinline__ float f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Tree sum of red[0 .. kThreads) into red[0]; the caller has synchronised.
__device__ void block_sum(float* red) {
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
}

// dot0, stage 1: A = a as [C*BB, N] in bf16; block p writes part[p][c][q]
// = sum over its 16 rows k of A[k][c] A[k][q] for c < C, q < BB (only
// r[:C, :BB] of r = A^T A reaches the output). Thread j loads rows 2j' and
// 2j' + 1 at 4 columns (16-byte loads, a row's 64 columns by 16 threads) and
// stores them as 4 k-pairs, pairs[j'][col] = (A[2j'][col], A[2j'+1][col])
// in bf16x2, so an mma fragment register of either operand is one word:
// the A operand is A^T (A^T[c][k] = A[k][c], its pair (k, k+1) is
// pairs[k/2][c]) and the B operand A itself (pairs[k/2][q]).
__global__ void __launch_bounds__(kDotThreads)
dot0_partial_kernel(const float* __restrict__ a, float* __restrict__ part) {
  __shared__ __align__(16) uint32_t pairs[kDotRows / 2][kPairLd];
  const int k0 = blockIdx.x * kDotRows;
  for (int e = threadIdx.x; e < kDotRows / 2 * (kBB / 4); e += kDotThreads) {
    const int j = e / (kBB / 4), col = e % (kBB / 4) * 4;
    const float4 lo = *reinterpret_cast<const float4*>(a + (k0 + 2 * j) * kN + col);
    const float4 hi = *reinterpret_cast<const float4*>(a + (k0 + 2 * j + 1) * kN + col);
    *reinterpret_cast<uint4*>(&pairs[j][col]) =
        make_uint4(pack_bf16x2(lo.x, hi.x), pack_bf16x2(lo.y, hi.y), pack_bf16x2(lo.z, hi.z),
                   pack_bf16x2(lo.w, hi.w));
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, c0 = 16 * (warp & 1), q0 = 32 * (warp >> 1);
  float acc[4][4] = {};
  const auto pa = [&](int c, int k) { return pairs[k >> 1][c]; };
  const auto pb = [&](int k, int q) { return pairs[k >> 1][q]; };
  warp_tile_bf16<4>(acc, c0, kDotRows, q0, 4, pa, pb);
  float* dst = part + blockIdx.x * kC * kBB;
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int i = 0; i < 4; i += 2)
      *reinterpret_cast<float2*>(dst + (c0 + frag_row(i)) * kBB + q0 + 8 * t + frag_col(i)) =
          make_float2(acc[t][i], acc[t][i + 1]);
}

// min_bf16, stage 1: block (c, s) writes part[s][c], the sum of f32(bf(b))
// * f32(min(bf(a), 0)) over elements [s, s + 1) * kMinSpan of channel c:
// 16-byte loads, bf16x2 conversions and min, exact products summed in f32
// in a fixed order (a thread's in turn, then a tree).
__global__ void __launch_bounds__(kThreads)
min_partial_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ part) {
  __shared__ float red[kThreads];
  const int c = blockIdx.x / kMinSplits, s = blockIdx.x % kMinSplits;
  const int base = (c * kBB * kN + s * kMinSpan) / 4;
  const float4* a4 = reinterpret_cast<const float4*>(a) + base;
  const float4* b4 = reinterpret_cast<const float4*>(b) + base;
  const __nv_bfloat162 zero = __floats2bfloat162_rn(0.0f, 0.0f);
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < kMinSpan / 4 / kThreads; ++i) {
    const float4 av = a4[threadIdx.x + i * kThreads], bv = b4[threadIdx.x + i * kThreads];
    const __nv_bfloat162 m01 = __hmin2(__floats2bfloat162_rn(av.x, av.y), zero);
    const __nv_bfloat162 m23 = __hmin2(__floats2bfloat162_rn(av.z, av.w), zero);
    const __nv_bfloat162 b01 = __floats2bfloat162_rn(bv.x, bv.y);
    const __nv_bfloat162 b23 = __floats2bfloat162_rn(bv.z, bv.w);
    sum = fmaf(__low2float(b01), __low2float(m01), sum);
    sum = fmaf(__high2float(b01), __high2float(m01), sum);
    sum = fmaf(__low2float(b23), __low2float(m23), sum);
    sum = fmaf(__high2float(b23), __high2float(m23), sum);
  }
  red[threadIdx.x] = sum;
  __syncthreads();
  block_sum(red);
  if (threadIdx.x == 0) part[s * kC + c] = red[0];
}

// Stage 2 of dot0 and min_bf16: out[r][l] = sum over p < P of part[p][r]
// (part [P][R]), in order of p, for l < L. A block the rows [r0, r0 + RB)
// and columns [l0, l0 + LB): its threads first sum each row's partials (G
// groups of threads take p = s, s + G, ...; a row's G sums then in order
// of s), then write the block's RB x LB values in 16-byte stores.
template <int P, int R, int L, int RB, int LB>
__global__ void __launch_bounds__(kThreads)
broadcast_sums_kernel(const float* __restrict__ part, float* __restrict__ out) {
  constexpr int G = P < kThreads / RB ? P : kThreads / RB;
  __shared__ float red[G * RB];
  __shared__ float row_sum[RB];
  const int r0 = blockIdx.x / (L / LB) * RB, l0 = blockIdx.x % (L / LB) * LB;
  const int i = threadIdx.x % RB, s = threadIdx.x / RB;
  if (s < G) {
    float v = 0.0f;
    for (int p = s; p < P; p += G) v += part[p * R + r0 + i];
    red[s * RB + i] = v;
  }
  __syncthreads();
  if ((int)threadIdx.x < RB) {
    float v = 0.0f;
    for (int g = 0; g < G; ++g) v += red[g * RB + threadIdx.x];
    row_sum[threadIdx.x] = v;
  }
  __syncthreads();
  for (int f = threadIdx.x; f < RB * LB / 4; f += kThreads) {
    const int row = f / (LB / 4);
    const float v = row_sum[row];
    reinterpret_cast<float4*>(out + (r0 + row) * L + l0)[f % (LB / 4)] = make_float4(v, v, v, v);
  }
}

// The selects: out = pred < 0 ? alpha * b : b in bf16, then f32. pred is
// bf16(a) or a itself (f32_pred); alpha is bf16(0.25) or bf16(a[0, 0, 0]).
// A thread kElemVec float4s of a and b (all loads first), bf16x2
// conversions, products and compares, a float4 store each.
__global__ void __launch_bounds__(kElemThreads)
select_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out,
              bool f32_pred, bool alpha_from_a) {
  const __nv_bfloat162 alpha = __bfloat162bfloat162(bf(alpha_from_a ? a[0] : 0.25f));
  const __nv_bfloat162 zero = __floats2bfloat162_rn(0.0f, 0.0f);
  float4 av[kElemVec], bv[kElemVec];
#pragma unroll
  for (int j = 0; j < kElemVec; ++j) {
    const int v = (blockIdx.x + j * kElemBlocks) * kElemThreads + threadIdx.x;
    av[j] = reinterpret_cast<const float4*>(a)[v];
    bv[j] = reinterpret_cast<const float4*>(b)[v];
  }
#pragma unroll
  for (int j = 0; j < kElemVec; ++j) {
    const __nv_bfloat162 b01 = __floats2bfloat162_rn(bv[j].x, bv[j].y);
    const __nv_bfloat162 b23 = __floats2bfloat162_rn(bv[j].z, bv[j].w);
    const __nv_bfloat162 p01 = __hmul2(alpha, b01), p23 = __hmul2(alpha, b23);
    bool n0 = av[j].x < 0.0f, n1 = av[j].y < 0.0f, n2 = av[j].z < 0.0f, n3 = av[j].w < 0.0f;
    if (!f32_pred) {
      const __nv_bfloat162 l01 = __hlt2(__floats2bfloat162_rn(av[j].x, av[j].y), zero);
      const __nv_bfloat162 l23 = __hlt2(__floats2bfloat162_rn(av[j].z, av[j].w), zero);
      n0 = __low2float(l01) != 0.0f, n1 = __high2float(l01) != 0.0f;
      n2 = __low2float(l23) != 0.0f, n3 = __high2float(l23) != 0.0f;
    }
    reinterpret_cast<float4*>(out)[(blockIdx.x + j * kElemBlocks) * kElemThreads + threadIdx.x] =
        make_float4(n0 ? __low2float(p01) : __low2float(b01),
                    n1 ? __high2float(p01) : __high2float(b01),
                    n2 ? __low2float(p23) : __low2float(b23),
                    n3 ? __high2float(p23) : __high2float(b23));
  }
}

// out[c][n][q] = bf(a[c][q][n]) (transpose_bf16 reads the same words as
// [C, BB, N]). A 32 x 32 bf16 tile through shared memory a block, padded
// against bank conflicts; 256 threads, 4 rows each.
__global__ void __launch_bounds__(kThreads) transpose_kernel(const float* a, float* out) {
  __shared__ __nv_bfloat16 tile[32][34];
  const int tiles_n = kN / 32, tiles_q = kBB / 32;
  const int c = blockIdx.x / (tiles_n * tiles_q);
  const int n0 = (blockIdx.x / tiles_q % tiles_n) * 32, q0 = blockIdx.x % tiles_q * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const float* src = a + (long long)c * kBB * kN;
  for (int r = ty; r < 32; r += kThreads / 32) tile[r][tx] = bf(src[(q0 + r) * kN + n0 + tx]);
  __syncthreads();
  float* dst = out + (long long)c * kN * kBB;
  for (int r = ty; r < 32; r += kThreads / 32) dst[(n0 + r) * kBB + q0 + tx] = f32(tile[tx][r]);
}

// dotg: out[i][q][n] = sum_c w[i][c] bf(a[c][q][n]) with w = ones [C, C]
// in bf16, summed in f32 in order of c. A thread a (q, n), all C rows of it.
__global__ void __launch_bounds__(kThreads) dotg_kernel(const float* a, float* out) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= kBB * kN) return;
  const __nv_bfloat16 w = bf(1.0f);
  float s = 0.0f;
  for (int c = 0; c < kC; ++c) s = fmaf(f32(w), f32(bf(a[c * kBB * kN + j])), s);
  for (int i = 0; i < kC; ++i) out[i * kBB * kN + j] = s;
}

// transpose_merge: h = transpose(bf(a), (0, 2, 1)) as [C*N, BB];
// out[i][q][n] = h[i][q] = bf(a[0][q][i]) for i < C: 2,048 rows (i, q) of
// N equal values, kMergeRows rows a block, in float4 stores.
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ a, float* __restrict__ out) {
  for (int f = threadIdx.x; f < kMergeRows * kN / 4; f += kThreads) {
    const int row = blockIdx.x * kMergeRows + f / (kN / 4), i = row / kBB, q = row % kBB;
    const float v = f32(bf(a[q * kN + i]));
    reinterpret_cast<float4*>(out)[blockIdx.x * kMergeRows * kN / 4 + f] = make_float4(v, v, v, v);
  }
}

}  // namespace

extern "C" {

const char* probe_bf16_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Floats of workspace job `job` needs (0: none).
int probe_bf16_workspace(int job) {
  return job == DOT0_BF16 || job == DOT0_SMALL_BF16 ? kWorkspace
         : job == MIN_BF16                          ? kMinSplits * kC
                                                    : 0;
}

// Run job `job` (enum Job) on a, b [32, 64, 256] f32 into out (kCount
// floats) on `stream`, with `work` the job's workspace
// (probe_bf16_workspace floats, from the caller's allocator); returns
// cudaGetLastError().
int probe_bf16_run(int job, const float* a, const float* b, float* out, float* work,
                   void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  switch (job) {
    case DOT0_BF16:
    case DOT0_SMALL_BF16: {
      dot0_partial_kernel<<<kDotBlocks, kDotThreads, 0, stream>>>(a, work);
      auto sums = broadcast_sums_kernel<kDotBlocks, kC * kBB, kN, kDotSumRows, kN>;
      sums<<<kC * kBB / kDotSumRows, kThreads, 0, stream>>>(work, out);
      break;
    }
    case WHERE_MIXED:
    case WHERE_CONST_SCALAR:
      select_kernel<<<kElemBlocks, kElemThreads, 0, stream>>>(a, b, out, false, false);
      break;
    case WHERE_CLEAN:
      select_kernel<<<kElemBlocks, kElemThreads, 0, stream>>>(a, b, out, false, true);
      break;
    case WHERE_F32PRED:
      select_kernel<<<kElemBlocks, kElemThreads, 0, stream>>>(a, b, out, true, true);
      break;
    case MIN_BF16: {
      min_partial_kernel<<<kC * kMinSplits, kThreads, 0, stream>>>(a, b, work);
      auto sums = broadcast_sums_kernel<kMinSplits, kC, kBB * kN, 1, kMinSpan>;
      sums<<<kC * kMinSplits, kThreads, 0, stream>>>(work, out);
      break;
    }
    case TRANSPOSE_BF16:
    case TRANSPOSE_PURE:
      transpose_kernel<<<kC * (kN / 32) * (kBB / 32), kThreads, 0, stream>>>(a, out);
      break;
    case DOTG_BF16:
      dotg_kernel<<<(kBB * kN + kThreads - 1) / kThreads, kThreads, 0, stream>>>(a, out);
      break;
    case TRANSPOSE_MERGE:
      merge_kernel<<<kMergeBlocks, kThreads, 0, stream>>>(a, out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
