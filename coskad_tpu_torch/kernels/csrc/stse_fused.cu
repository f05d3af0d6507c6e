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
// written, i.e. ~150 FLOP per byte of device memory, above the fp32 ridge
// of ~20 FLOP/byte (67 TFLOP/s over 3.35 TB/s, the H100 SXM data sheet's
// peaks at its 700 W limit). So the kernel is bound by fp32 operations, and
// by how often the SMs re-read M through L1 and L2.
//
// Design (simple first):
//   * one thread block per window; the window's activations never leave
//     shared memory between layers (channel-major [C][NP], NP = N rounded up
//     to a multiple of 4, so every row is 16-byte aligned for float4 loads);
//   * M (one [NP, NP] matrix per layer, 186 KB at N = 216) is read straight
//     from global memory: all blocks read the same M, so it stays in L2, and
//     the warps of a block that read the same M row hit in L1;
//   * W / W_res / bias of the current layer are staged in shared memory;
//   * where a layer narrows (C_out < C_in) it computes M^T (x W) rather than
//     (M^T x) W, so the graph contraction, the bulk of the FLOPs, runs on the
//     smaller channel count;
//   * every thread owns a register tile of 1, 4 or 8 channels x 4 nodes: the
//     widest tile that still keeps 3/4 of the block's threads busy (wide
//     tiles feed more FMAs per float4 load; the 4-wide tile is load-bound,
//     and a layer with 4 padded input channels gives 4-wide tiles to only 54
//     of 256 threads);
//   * padded nodes (n >= N) and padded channels carry zeros through M and W,
//     so they never reach a valid output; only valid outputs are written,
//     node-major [B, N, C_out], the layout the projector reads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kThreads = 256;

struct LayerDesc {
  int ci, co;      // true channel counts
  int cip, cop;    // padded to a multiple of 4
  long long off_m, off_w, off_wr, off_b, off_alpha;  // float offsets
};

struct Params {
  LayerDesc layers[kMaxLayers];
  int n_layers;
  int n_nodes;   // N = T*V
  int n_pad;     // NP, multiple of 4
  int c_act;     // rows of each activation buffer (max padded channels)
  int cip_max, cop_max;
};

__device__ __forceinline__ void fma4(float (&acc)[4], float a, const float4& b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// A register tile is TW channels x 4 nodes: the widest of 8 and 4 that
// leaves at least 3/4 of the block's threads a tile, else 1.
__device__ __forceinline__ int tile_width(int channels, int n_pad) {
  const int busy = kThreads * 3 / 4;
  if (channels % 8 == 0 && (channels / 8) * (n_pad / 4) >= busy) return 8;
  if ((channels / 4) * (n_pad / 4) >= busy) return 4;
  return 1;
}

// Graph contraction: gt[c][m] = sum_k xt[c][k] * M[k][m].
template <int TC>
__device__ __forceinline__ void graph_tiles(const float* xt, const float* __restrict__ M,
                                            float* gt, int cip, int np) {
  const int tiles_m = np / 4;
  const int tiles = (cip / TC) * tiles_m;
  for (int t = threadIdx.x; t < tiles; t += kThreads) {
    const int c0 = (t / tiles_m) * TC;
    const int m0 = (t % tiles_m) * 4;
    const float* mcol = M + m0;
    float acc[TC][4] = {};
    float4 mb[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) mb[j] = __ldg(reinterpret_cast<const float4*>(mcol + j * np));
    for (int k = 0; k < np; k += 4) {
      // M comes from L2: issue the next 4 rows' loads before this step's
      // FMAs (the last step reloads its own rows instead of running past M).
      const int kn = k + 4 < np ? k + 4 : k;
      float4 mn[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mn[j] = __ldg(reinterpret_cast<const float4*>(mcol + (long long)(kn + j) * np));
#pragma unroll
      for (int i = 0; i < TC; ++i) {
        const float4 xa = *reinterpret_cast<const float4*>(xt + (c0 + i) * np + k);
#pragma unroll
        for (int j = 0; j < 4; ++j) fma4(acc[i], comp(xa, j), mb[j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) mb[j] = mn[j];
    }
#pragma unroll
    for (int i = 0; i < TC; ++i)
      *reinterpret_cast<float4*>(gt + (c0 + i) * np + m0) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

__device__ __forceinline__ void graph_phase(const float* xt, const float* __restrict__ M,
                                            float* gt, int channels, int np) {
  switch (tile_width(channels, np)) {
    case 8: graph_tiles<8>(xt, M, gt, channels, np); break;
    case 4: graph_tiles<4>(xt, M, gt, channels, np); break;
    default: graph_tiles<1>(xt, M, gt, channels, np);
  }
}

// The 1x1 channel mixes of a layer, for o < cop and every node m:
//   kFull:     y[o][m] = PReLU(sum_c W[c][o] gt[c][m] + sum_c Wr[c][o] xt[c][m] + b[o])
//   kProject:  dst[o][m] = sum_c W[c][o] xt[c][m]                     (no bias, no PReLU)
//   kResidual: y[o][m] = PReLU(dst[o][m] + sum_c Wr[c][o] xt[c][m] + b[o])
// y goes to dst[o][m] (the next layer's input), or for the last layer the
// valid outputs go node-major to out_b[m][o]. A thread reads and writes only
// its own tile of dst, so kResidual may update dst in place.
enum Mix { kFull, kProject, kResidual };

template <int TO, Mix MODE>
__device__ __forceinline__ void mix_tiles(const float* ws, const float* wrs, const float* bs,
                                          const float* gt, const float* xt, float* dst,
                                          float* __restrict__ out_b, float alpha, int cip,
                                          int cop, int co, int np, int n, bool last) {
  const int tiles_m = np / 4;
  const int tiles = (cop / TO) * tiles_m;
  for (int t = threadIdx.x; t < tiles; t += kThreads) {
    const int o0 = (t / tiles_m) * TO;
    const int m0 = (t % tiles_m) * 4;
    float acc[TO][4];
#pragma unroll
    for (int i = 0; i < TO; ++i) {
      const float4 a = MODE == kResidual
                           ? *reinterpret_cast<const float4*>(dst + (o0 + i) * np + m0)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      acc[i][0] = a.x;
      acc[i][1] = a.y;
      acc[i][2] = a.z;
      acc[i][3] = a.w;
    }
    for (int c = 0; c < cip; ++c) {
      const float4 x4 = *reinterpret_cast<const float4*>(xt + c * np + m0);
      const float4 g4 =
          MODE == kFull ? *reinterpret_cast<const float4*>(gt + c * np + m0) : x4;
#pragma unroll
      for (int q = 0; q < TO / 4; ++q) {
        if (MODE != kResidual) {
          const float4 w4 = *reinterpret_cast<const float4*>(ws + c * cop + o0 + 4 * q);
#pragma unroll
          for (int i = 0; i < 4; ++i) fma4(acc[4 * q + i], comp(w4, i), g4);
        }
        if (MODE != kProject) {
          const float4 wr4 = *reinterpret_cast<const float4*>(wrs + c * cop + o0 + 4 * q);
#pragma unroll
          for (int i = 0; i < 4; ++i) fma4(acc[4 * q + i], comp(wr4, i), x4);
        }
      }
    }
    if (MODE != kProject) {
#pragma unroll
      for (int i = 0; i < TO; ++i) {
        const float bias = bs[o0 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float h = acc[i][j] + bias;
          acc[i][j] = h >= 0.0f ? h : alpha * h;
        }
      }
    }
    if (MODE == kProject || !last) {
#pragma unroll
      for (int i = 0; i < TO; ++i)
        *reinterpret_cast<float4*>(dst + (o0 + i) * np + m0) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      continue;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + j;
      if (m >= n) continue;
      float* row = out_b + (long long)m * co;
      if ((co & 3) == 0) {
#pragma unroll
        for (int q = 0; q < TO / 4; ++q)
          *reinterpret_cast<float4*>(row + o0 + 4 * q) =
              make_float4(acc[4 * q][j], acc[4 * q + 1][j], acc[4 * q + 2][j],
                          acc[4 * q + 3][j]);
      } else {
#pragma unroll
        for (int i = 0; i < TO; ++i)
          if (o0 + i < co) row[o0 + i] = acc[i][j];
      }
    }
  }
}

template <Mix MODE>
__device__ __forceinline__ void mix_phase(const float* ws, const float* wrs, const float* bs,
                                          const float* gt, const float* xt, float* dst,
                                          float* __restrict__ out_b, float alpha,
                                          const LayerDesc& L, int np, int n, bool last) {
  if (tile_width(L.cop, np) == 8)
    mix_tiles<8, MODE>(ws, wrs, bs, gt, xt, dst, out_b, alpha, L.cip, L.cop, L.co, np, n, last);
  else
    mix_tiles<4, MODE>(ws, wrs, bs, gt, xt, dst, out_b, alpha, L.cip, L.cop, L.co, np, n, last);
}

__global__ void __launch_bounds__(kThreads, 2)
stse_fused_kernel(const float* __restrict__ x,        // [B, C_in0, N]
                  const float* __restrict__ weights,  // packed, see stse_fused.py
                  float* __restrict__ out,            // [B, N, C_out_last]
                  Params p) {
  extern __shared__ __align__(16) float smem[];
  const int np = p.n_pad;
  const int n = p.n_nodes;
  const int act = p.c_act * np;
  float* xt = smem;                 // current input  [c][np]
  float* xt_next = smem + act;      // next input     [c][np]
  float* gt = smem + 2 * act;       // graph output   [c][np]
  float* ws = smem + 3 * act;       // W      [cip][cop]
  float* wrs = ws + p.cip_max * p.cop_max;   // W_res [cip][cop]
  float* bs = wrs + p.cip_max * p.cop_max;   // b + b_res [cop]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;

  // Load the window channel-major; zero the padded rows and columns.
  {
    const LayerDesc& l0 = p.layers[0];
    const float* xb = x + (long long)b * l0.ci * n;
    for (int i = tid; i < l0.cip * np; i += kThreads) {
      const int c = i / np, m = i - c * np;
      xt[i] = (c < l0.ci && m < n) ? xb[c * n + m] : 0.0f;
    }
  }

  for (int layer = 0; layer < p.n_layers; ++layer) {
    const LayerDesc L = p.layers[layer];
    const bool last = layer == p.n_layers - 1;
    __syncthreads();  // xt complete; the previous layer's reads of ws done

    // Stage this layer's dense weights.
    for (int i = tid; i < L.cip * L.cop; i += kThreads) {
      ws[i] = weights[L.off_w + i];
      wrs[i] = weights[L.off_wr + i];
    }
    for (int i = tid; i < L.cop; i += kThreads) bs[i] = weights[L.off_b + i];

    const float* M = weights + L.off_m;
    const float alpha = weights[L.off_alpha];
    float* out_b = out + (long long)b * n * L.co;
    if (L.cop < L.cip) {
      // Narrowing layer: u = x W into gt, g = M^T u into xt_next, then
      // xt_next = PReLU(g + x W_res + b) in place.
      __syncthreads();  // the staged weights are complete
      mix_phase<kProject>(ws, wrs, bs, nullptr, xt, gt, out_b, alpha, L, np, n, last);
      __syncthreads();
      graph_phase(gt, M, xt_next, L.cop, np);
      __syncthreads();
      mix_phase<kResidual>(ws, wrs, bs, nullptr, xt, xt_next, out_b, alpha, L, np, n, last);
    } else {
      graph_phase(xt, M, gt, L.cip, np);
      __syncthreads();  // gt and the staged weights are complete
      mix_phase<kFull>(ws, wrs, bs, gt, xt, xt_next, out_b, alpha, L, np, n, last);
    }
    float* tmp = xt;
    xt = xt_next;
    xt_next = tmp;
  }
}

}  // namespace

extern "C" {

const char* stse_fused_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shared memory one block needs for this layout, in bytes.
long long stse_fused_smem_bytes(int n_pad, int c_act, int cip_max, int cop_max) {
  return (long long)sizeof(float) *
         (3LL * c_act * n_pad + 2LL * cip_max * cop_max + cop_max);
}

// layout: host array of n_layers rows of 9 int64:
//   ci, co, cip, cop, off_m, off_w, off_wr, off_b, off_alpha.
// Returns a cudaError_t (0 on success). The launch is asynchronous on
// `stream`; the return value reports refused launches, not faults while
// the kernel runs.
int stse_fused_forward(const float* x, const float* weights, const long long* layout,
                       int n_layers, int batch, int n_nodes, int n_pad, float* out,
                       void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || batch < 1 || n_pad % 4 != 0 ||
      n_pad < n_nodes)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.n_layers = n_layers;
  p.n_nodes = n_nodes;
  p.n_pad = n_pad;
  p.c_act = 0;
  p.cip_max = 0;
  p.cop_max = 0;
  for (int l = 0; l < n_layers; ++l) {
    const long long* r = layout + 9 * l;
    LayerDesc& d = p.layers[l];
    d.ci = (int)r[0];
    d.co = (int)r[1];
    d.cip = (int)r[2];
    d.cop = (int)r[3];
    d.off_m = r[4];
    d.off_w = r[5];
    d.off_wr = r[6];
    d.off_b = r[7];
    d.off_alpha = r[8];
    if (d.cip % 4 != 0 || d.cop % 4 != 0) return (int)cudaErrorInvalidValue;
    if (l > 0 && d.cip != p.layers[l - 1].cop) return (int)cudaErrorInvalidValue;
    p.c_act = d.cip > p.c_act ? d.cip : p.c_act;
    if (l < n_layers - 1) p.c_act = d.cop > p.c_act ? d.cop : p.c_act;
    p.cip_max = d.cip > p.cip_max ? d.cip : p.cip_max;
    p.cop_max = d.cop > p.cop_max ? d.cop : p.cop_max;
  }
  const long long smem = stse_fused_smem_bytes(n_pad, p.c_act, p.cip_max, p.cop_max);
  cudaError_t err = cudaFuncSetAttribute(
      stse_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  stse_fused_kernel<<<batch, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      x, weights, out, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
