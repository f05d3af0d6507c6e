// bf16 operand probes: one small kernel per job of scripts/probe_mosaic.py.
//
// Replaces the Pallas kernel P of scripts/probe_mosaic.py: `run` (:27,
// pallas_call :32) with the job bodies of `main` (:56-97) and `extra_jobs`
// (:107-138). On the TPU each job compiled one Mosaic op class (lhsT dots,
// mixed-dtype selects, bf16 min, transposes, 2D x 3D dots) to find what the
// remote compiler rejected in bf16 backward payloads. Here each job is the
// same function as a CUDA kernel on __nv_bfloat16 operands with f32
// accumulation: the operand forms the bf16 compute_dtype of K2-K5 will need
// on Hopper (a load rounded to bf16, bf16 compares, selects, products and
// min, bf16 transposes through shared memory, bf16 dots summed in f32).
//
// Every job takes the probe's inputs, a and b [C, BB, N] = [32, 64, 256]
// f32, rounds them to bf16 (round to nearest even, as `.astype(bf16)`) and
// writes [32, 64, 256] f32 ([32, 256, 64] for transpose_pure). What bounds
// them on an H100: bytes (4 MB in and out at most, a few MFLOP); at this
// size, launch latency. The design is the plain one: a thread per output
// element, or a block per output sum with a fixed-order tree reduction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kC = 32, kBB = 64, kN = 256;
constexpr int kCount = kC * kBB * kN;
constexpr int kThreads = 256;

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

// dot0: A = a as [C*BB, N] in bf16, r = A^T A [N, N] (the lhsT dot,
// contracting dim 0), out[c][q][n] = r[c][q]. Only r[:C, :BB] reaches the
// output. One block an output (c, q): thread k sums rows k, k + 256, ...
__global__ void __launch_bounds__(kThreads) dot0_kernel(const float* a, float* out) {
  __shared__ float red[kThreads];
  const int c = blockIdx.x / kBB, q = blockIdx.x % kBB;
  float s = 0.0f;
  for (int k = threadIdx.x; k < kC * kBB; k += kThreads)
    s = fmaf(f32(bf(a[k * kN + c])), f32(bf(a[k * kN + q])), s);
  red[threadIdx.x] = s;
  __syncthreads();
  block_sum(red);
  out[(long long)blockIdx.x * kN + threadIdx.x] = red[0];
}

// The selects: out = pred < 0 ? alpha * b : b in bf16, then f32. pred is
// bf16(a) or a itself (f32_pred); alpha is bf16(0.25) or bf16(a[0, 0, 0]).
__global__ void __launch_bounds__(kThreads)
select_kernel(const float* a, const float* b, float* out, bool f32_pred, bool alpha_from_a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= kCount) return;
  const __nv_bfloat16 alpha = bf(alpha_from_a ? a[0] : 0.25f);
  const __nv_bfloat16 bv = bf(b[i]);
  const bool neg = f32_pred ? a[i] < 0.0f : __hlt(bf(a[i]), bf(0.0f));
  out[i] = f32(neg ? __hmul(alpha, bv) : bv);
}

// min_bf16: r[c] = sum over (q, n) of f32(bf(b)) * f32(min(bf(a), 0)),
// broadcast over [BB, N]. One block a channel.
__global__ void __launch_bounds__(kThreads) min_kernel(const float* a, const float* b, float* out) {
  __shared__ float red[kThreads];
  const long long base = (long long)blockIdx.x * kBB * kN;
  float s = 0.0f;
  for (int j = threadIdx.x; j < kBB * kN; j += kThreads)
    s = fmaf(f32(bf(b[base + j])), f32(__hmin(bf(a[base + j]), bf(0.0f))), s);
  red[threadIdx.x] = s;
  __syncthreads();
  block_sum(red);
  for (int j = threadIdx.x; j < kBB * kN; j += kThreads) out[base + j] = red[0];
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
// out[i][q][n] = h[i][q] = bf(a[0][q][i]) for i < C.
__global__ void __launch_bounds__(kThreads) merge_kernel(const float* a, float* out) {
  const int o = blockIdx.x * kThreads + threadIdx.x;
  if (o >= kCount) return;
  const int i = o / (kBB * kN), q = o / kN % kBB;
  out[o] = f32(bf(a[q * kN + i]));
}

}  // namespace

extern "C" {

const char* probe_bf16_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Run job `job` (enum Job) on a, b [32, 64, 256] f32 into out (kCount
// floats) on `stream`; returns cudaGetLastError().
int probe_bf16_run(int job, const float* a, const float* b, float* out, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int elems = (kCount + kThreads - 1) / kThreads;
  switch (job) {
    case DOT0_BF16:
    case DOT0_SMALL_BF16:
      dot0_kernel<<<kC * kBB, kThreads, 0, stream>>>(a, out);
      break;
    case WHERE_MIXED:
    case WHERE_CONST_SCALAR:
      select_kernel<<<elems, kThreads, 0, stream>>>(a, b, out, false, false);
      break;
    case WHERE_CLEAN:
      select_kernel<<<elems, kThreads, 0, stream>>>(a, b, out, false, true);
      break;
    case WHERE_F32PRED:
      select_kernel<<<elems, kThreads, 0, stream>>>(a, b, out, true, true);
      break;
    case MIN_BF16:
      min_kernel<<<kC, kThreads, 0, stream>>>(a, b, out);
      break;
    case TRANSPOSE_BF16:
    case TRANSPOSE_PURE:
      transpose_kernel<<<kC * (kN / 32) * (kBB / 32), kThreads, 0, stream>>>(a, out);
      break;
    case DOTG_BF16:
      dotg_kernel<<<(kBB * kN + kThreads - 1) / kThreads, kThreads, 0, stream>>>(a, out);
      break;
    case TRANSPOSE_MERGE:
      merge_kernel<<<elems, kThreads, 0, stream>>>(a, out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
