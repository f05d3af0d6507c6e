// Runs a CUDA kernel source on the host, for tests on machines without a GPU.
//
// Covers the subset the port's kernels use: float4, __ldg, rsqrtf, threadIdx
// (x) and blockIdx (x, y) with a dim3 grid, dynamic shared memory and
// __syncthreads. Each CUDA thread of a block is a std::thread and
// __syncthreads is a std::barrier; blocks run one after another. Shared
// memory starts as NaN, so a read of a value no thread wrote shows up in the
// output. The test rewrites each kernel's `extern __shared__` declaration to
// read g_smem and each <<<...>>> launch to call emu_launch.
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
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
