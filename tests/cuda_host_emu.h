// Runs a CUDA kernel source on the host, for tests on machines without a GPU.
//
// Covers the subset the port's kernels use: float2, float4, uint2, uint4, __ldg, rsqrtf,
// threadIdx (x) and blockIdx (x, y) with a dim3 grid, dynamic shared memory and
// __syncthreads, __nv_bfloat16 and __nv_bfloat162 with the conversions,
// compares, products and min the probes use, and the warp-level pieces of the batch-reduction
// products: __syncwarp, cvt.rna.tf32.f32 (tf32_of), cvt.rn.bf16.f32
// (bf16_bits), cvt.rn.bf16x2.f32 (pack_bf16x2), the m16n8k8 TF32 mma
// (mma_tf32), the m16n8k16 and m16n8k8 bf16 mma (mma_bf16_k16, mma_bf16_k8)
// and cp.async of fp32 or bf16 bytes (cp_async16 / cp_async4 as plain
// copies, cp_async_commit / cp_async_wait as no-ops). It defines CUDA_HOST_EMU, under
// which a kernel source leaves out its inline-PTX versions of those helpers.
// Each CUDA thread of a block is a std::thread (one set a launch, which
// runs the blocks one after another), __syncthreads is a std::barrier and
// each warp has a barrier of its own. Shared memory starts as NaN (0x7FC07FC0, a NaN as a float and as
// each of its bf16 halves), so a read of a value no thread wrote shows up in
// the output. The test rewrites each kernel's `extern __shared__`
// declaration to read g_smem and each <<<...>>> launch to call emu_launch
// (and drops probe_bf16.cu's cuda_bf16.h include; tf32_mma.cuh includes it
// only outside the emulation); a static `__shared__` array becomes a function-local
// static, one for all threads, which holds because blocks run in turn.
#pragma once
#define CUDA_HOST_EMU 1
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <limits>
#include <memory>
#include <thread>
#include <vector>

struct float2 {
  float x, y;
};
inline float2 make_float2(float a, float b) { return {a, b}; }
struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct uint2 {
  uint32_t x, y;
};
inline uint2 make_uint2(uint32_t a, uint32_t b) { return {a, b}; }
struct uint4 {
  uint32_t x, y, z, w;
};
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }

struct dim3 {
  int x, y, z;
  dim3(int x_ = 1, int y_ = 1, int z_ = 1) : x(x_), y(y_), z(z_) {}
};

struct EmuIndex {
  int x, y;
};
inline thread_local EmuIndex threadIdx, blockIdx;
inline std::barrier<>* g_barrier;
inline float* g_smem;

inline void __syncthreads() { g_barrier->arrive_and_wait(); }

// One warp's barrier and the exchange area of its collective operations.
struct EmuWarp {
  explicit EmuWarp(int lanes) : barrier(lanes) {}
  std::barrier<> barrier;
  float a[32][4], b[32][2];
  uint32_t pa[32][4], pb[32][2];  // bf16 fragments: two values a register
};
inline std::vector<std::unique_ptr<EmuWarp>>* g_warps;
inline EmuWarp& emu_warp() { return *(*g_warps)[threadIdx.x / 32]; }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp().barrier.arrive_and_wait(); }

inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}

// cvt.rna.tf32.f32: keep the top 19 bits, rounded to nearest with ties away
// from zero on the 13 dropped ones (a magnitude carry in sign-magnitude
// form; subnormals round the same way); NaN stays NaN, infinity infinity.
inline uint32_t tf32_of(float v) {
  uint32_t u = __float_as_uint(v);
  if ((u & 0x7F800000u) == 0x7F800000u) return (u & 0x7FFFFFu) ? 0x7FFFFFFFu : u;
  return (u + 0x1000u) & 0xFFFFE000u;
}

// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, d += a b, with the
// PTX fragment layout (g = lane / 4, t = lane % 4): a0..a3 hold A[g][t],
// A[g+8][t], A[g][t+4], A[g+8][t+4]; b0, b1 hold B[t][g], B[t+4][g]; d0..d3
// hold D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]. Each lane posts its
// fragments, meets the warp's barrier, sums the eight exact products of each
// element it owns in k order in double and rounds once, and meets the
// barrier again before any lane may post the next fragments.
// Warp-level mma.sync calls by kind (0 TF32, 1 bf16), counted by lane 0: a
// test reads and clears them through emu_mma_count to see which tensor-core
// route a kernel took.
inline std::atomic<long long> g_emu_mma[2];
extern "C" long long emu_mma_count(int kind) { return g_emu_mma[kind].exchange(0); }

inline void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  EmuWarp& w = emu_warp();
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  if (lane == 0) g_emu_mma[0].fetch_add(1, std::memory_order_relaxed);
  for (int i = 0; i < 4; ++i) w.a[lane][i] = __uint_as_float(a[i]);
  for (int i = 0; i < 2; ++i) w.b[lane][i] = __uint_as_float(b[i]);
  w.barrier.arrive_and_wait();
  for (int i = 0; i < 4; ++i) {
    const int row = g + (i >= 2 ? 8 : 0), col = 2 * t + (i & 1);
    double acc = d[i];
    for (int k = 0; k < 8; ++k) {
      const float av = w.a[(row % 8) * 4 + k % 4][(row >= 8 ? 1 : 0) + (k >= 4 ? 2 : 0)];
      const float bv = w.b[col * 4 + k % 4][k >= 4 ? 1 : 0];
      acc += (double)av * (double)bv;
    }
    d[i] = (float)acc;
  }
  w.barrier.arrive_and_wait();
}

// The value of half h (0 low, 1 high) of a bf16x2 register.
inline double emu_bf16_half(uint32_t r, int h) {
  return (double)__uint_as_float(h ? (r & 0xFFFF0000u) : (r << 16));
}

// mma.sync.aligned.m16n8k{16,8}.row.col.f32.bf16.bf16.f32, d += a b, K 16 or
// 8 (a holds K / 4 registers, b K / 8), each register a pair of bf16 values
// along k, the lower k in the low half: with g = lane / 4, t = lane % 4, a
// holds A[g][2t, 2t+1], A[g+8][2t, 2t+1] (and for K 16 A[g][2t+8, 2t+9],
// A[g+8][2t+8, 2t+9]); b holds B[2t, 2t+1][g] (and B[2t+8, 2t+9][g]); d as
// mma_tf32's. Like mma_tf32: the exact products of each element summed in k
// order in double, one rounding.
template <int K>
inline void emu_mma_bf16(float (&d)[4], const uint32_t* a, const uint32_t* b) {
  EmuWarp& w = emu_warp();
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  if (lane == 0) g_emu_mma[1].fetch_add(1, std::memory_order_relaxed);
  for (int i = 0; i < K / 4; ++i) w.pa[lane][i] = a[i];
  for (int i = 0; i < K / 8; ++i) w.pb[lane][i] = b[i];
  w.barrier.arrive_and_wait();
  for (int i = 0; i < 4; ++i) {
    const int row = g + (i >= 2 ? 8 : 0), col = 2 * t + (i & 1);
    double acc = d[i];
    for (int k = 0; k < K; ++k) {
      const int kt = (k % 8) / 2, half = k % 2, hi = k >= 8 ? 1 : 0;
      const double av =
          emu_bf16_half(w.pa[(row % 8) * 4 + kt][(row >= 8 ? 1 : 0) + 2 * hi], half);
      const double bv = emu_bf16_half(w.pb[col * 4 + kt][hi], half);
      acc += av * bv;
    }
    d[i] = (float)acc;
  }
  w.barrier.arrive_and_wait();
}
inline void mma_bf16_k16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  emu_mma_bf16<16>(d, a, b);
}
inline void mma_bf16_k8(float (&d)[4], const uint32_t (&a)[2], uint32_t b) {
  emu_mma_bf16<8>(d, a, &b);
}

// cp.async: the copy happens at once, so a commit or a wait has nothing to do.
inline void cp_async16(void* dst, const void* src) { std::memcpy(dst, src, 16); }
inline void cp_async4(void* dst, const void* src) { std::memcpy(dst, src, 4); }
inline void cp_async_commit() {}
template <int N>
void cp_async_wait() {}
template <class T>
T __ldg(const T* p) {
  return *p;
}
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n)
#define __shared__ static

// bf16: the top 16 bits of a float, rounded to nearest even on the 16
// dropped ones (a carry past the largest finite value gives infinity); NaN
// to the canonical 0x7FFF, as cvt.rn.bf16.f32 gives it.
struct __nv_bfloat16 {
  uint16_t x;
};
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7F800000u) == 0x7F800000u && (u & 0x7FFFFFu)) return {(uint16_t)0x7FFFu};
  u += 0x7FFF + ((u >> 16) & 1);
  return {(uint16_t)(u >> 16)};
}
// cvt.rn.bf16.f32 as the bits of a float (the low 16 bits zero): the
// operand rounding of tf32_mma.cuh's bf16 products.
inline uint32_t bf16_bits(float v) { return (uint32_t)__float2bfloat16(v).x << 16; }
// cvt.rn.bf16x2.f32: lo and hi rounded as bf16_bits, lo in the low half.
inline uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__float2bfloat16(lo).x | (uint32_t)__float2bfloat16(hi).x << 16;
}
inline float __bfloat162float(__nv_bfloat16 b) {
  const uint32_t u = (uint32_t)b.x << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline bool __hlt(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __bfloat162float(a) < __bfloat162float(b);
}
inline __nv_bfloat16 __hmul(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16(__bfloat162float(a) * __bfloat162float(b));
}
inline __nv_bfloat16 __hmin(__nv_bfloat16 a, __nv_bfloat16 b) { return __hlt(b, a) ? b : a; }

// bf16x2: two bf16 values, x the low half; each operation is the scalar one
// on each half (a compare gives 1.0 or 0.0).
struct __nv_bfloat162 {
  __nv_bfloat16 x, y;
};
inline __nv_bfloat162 __floats2bfloat162_rn(float lo, float hi) {
  return {__float2bfloat16(lo), __float2bfloat16(hi)};
}
inline __nv_bfloat162 __bfloat162bfloat162(__nv_bfloat16 v) { return {v, v}; }
inline float __low2float(__nv_bfloat162 v) { return __bfloat162float(v.x); }
inline float __high2float(__nv_bfloat162 v) { return __bfloat162float(v.y); }
inline __nv_bfloat162 __hmul2(__nv_bfloat162 a, __nv_bfloat162 b) {
  return {__hmul(a.x, b.x), __hmul(a.y, b.y)};
}
inline __nv_bfloat162 __hmin2(__nv_bfloat162 a, __nv_bfloat162 b) {
  return {__hmin(a.x, b.x), __hmin(a.y, b.y)};
}
inline __nv_bfloat162 __hlt2(__nv_bfloat162 a, __nv_bfloat162 b) {
  return {__float2bfloat16(__hlt(a.x, b.x) ? 1.0f : 0.0f),
          __float2bfloat16(__hlt(a.y, b.y) ? 1.0f : 0.0f)};
}

typedef int cudaError_t;
typedef void* cudaStream_t;
typedef void* cudaEvent_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaErrorInvalidDevice = 101,
  cudaStreamNonBlocking = 1,
  cudaEventDisableTiming = 2,
};
// Streams and events: launches run at once, in the order the host makes
// them, so every stream is the same serial one and an event orders nothing
// that is not ordered already. A created stream or event is a non-null
// handle, as the caller may test it.
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaStreamCreateWithFlags(cudaStream_t* s, unsigned) {
  static char stream;
  *s = &stream;
  return cudaSuccess;
}
inline cudaError_t cudaEventCreateWithFlags(cudaEvent_t* e, unsigned) {
  static char event;
  *e = &event;
  return cudaSuccess;
}
inline cudaError_t cudaEventRecord(cudaEvent_t, cudaStream_t) { return cudaSuccess; }
inline cudaError_t cudaStreamWaitEvent(cudaStream_t, cudaEvent_t, unsigned) {
  return cudaSuccess;
}
inline cudaError_t cudaEventDestroy(cudaEvent_t) { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "error in host emulation"; }
template <class K>
cudaError_t cudaFuncSetAttribute(K, int, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
// Blocks run one at a time here.
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, K, int, size_t) {
  *blocks = 1;
  return cudaSuccess;
}

// A launch: `threads` host threads, made once, run the grid's blocks one
// after another; between two blocks every thread waits, and thread 0 fills
// shared memory with NaN again.
template <class K, class... A>
void emu_launch(K kernel, dim3 grid, int threads, size_t smem_bytes, A... args) {
  std::vector<float> smem(smem_bytes / sizeof(float) + 4);
  g_smem = smem.data();
  std::barrier<> barrier(threads), between(threads);
  g_barrier = &barrier;
  std::vector<std::unique_ptr<EmuWarp>> warps;
  for (int w = 0; w * 32 < threads; ++w)
    warps.push_back(std::make_unique<EmuWarp>(threads - w * 32 < 32 ? threads - w * 32 : 32));
  g_warps = &warps;
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t)
    pool.emplace_back([&, t] {
      threadIdx.x = t;
      threadIdx.y = 0;
      for (int by = 0; by < grid.y; ++by)
        for (int bx = 0; bx < grid.x; ++bx) {
          if (t == 0) std::fill(smem.begin(), smem.end(), __uint_as_float(0x7FC07FC0u));
          between.arrive_and_wait();
          blockIdx.x = bx;
          blockIdx.y = by;
          kernel(args...);
          between.arrive_and_wait();
        }
    });
  for (auto& th : pool) th.join();
}
