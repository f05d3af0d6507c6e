// Runs a CUDA kernel source on the host, for tests on machines without a GPU.
//
// Covers the subset the port's kernels use: float4, __ldg, rsqrtf, threadIdx
// (x) and blockIdx (x, y) with a dim3 grid, dynamic shared memory and
// __syncthreads, and __nv_bfloat16 with the conversions, compares, products
// and min the probes use. Each CUDA thread of a block is a std::thread and
// __syncthreads is a std::barrier; blocks run one after another. Shared
// memory starts as NaN, so a read of a value no thread wrote shows up in the
// output. The test rewrites each kernel's `extern __shared__` declaration to
// read g_smem and each <<<...>>> launch to call emu_launch (and drops the
// cuda_bf16.h include); a static `__shared__` array becomes a function-local
// static, one for all threads, which holds because blocks run in turn.
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }

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

// bf16: the top 16 bits of a float, rounded to nearest even (no NaNs here).
struct __nv_bfloat16 {
  uint16_t x;
};
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  u += 0x7FFF + ((u >> 16) & 1);
  return {(uint16_t)(u >> 16)};
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

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
};
inline const char* cudaGetErrorString(cudaError_t) { return "error in host emulation"; }
template <class K>
cudaError_t cudaFuncSetAttribute(K, int, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

template <class K, class... A>
void emu_launch(K kernel, dim3 grid, int threads, size_t smem_bytes, A... args) {
  std::vector<float> smem(smem_bytes / sizeof(float) + 4);
  for (int by = 0; by < grid.y; ++by)
    for (int bx = 0; bx < grid.x; ++bx) {
      std::fill(smem.begin(), smem.end(), std::numeric_limits<float>::quiet_NaN());
      g_smem = smem.data();
      std::barrier<> barrier(threads);
      g_barrier = &barrier;
      std::vector<std::thread> pool;
      for (int t = 0; t < threads; ++t)
        pool.emplace_back([&, t] {
          threadIdx.x = t;
          threadIdx.y = 0;
          blockIdx.x = bx;
          blockIdx.y = by;
          kernel(args...);
        });
      for (auto& th : pool) th.join();
    }
}
