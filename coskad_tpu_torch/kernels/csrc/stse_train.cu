// Train-mode STSE encoder with ghost BatchNorm: forward (K2), the split
// backward (K3 for a lower layer, K4 for the top layer with the projector)
// and the mono backward (K5, from x and dz alone).
//
// Replaces the Pallas kernels of coskad_tpu/kernels/stse_train.py:
//   K2  stse_train_forward        <- _fwd_kernel (:432), via _fwd_pallas (:843)
//   K3  stse_train_layer_backward <- _layer_bwd_kernel (:790) / _layer_bwd_body (:566)
//   K4  stse_train_top_backward   <- _top_layer_bwd_kernel (:738)
//   K5  stse_train_mono_backward  <- _bwd_kernel (:498), via _bwd_pallas (:1008)
// Each C entry point launches several __global__ functions in order on the
// caller's stream (K5 some on a second stream, joined back before it
// returns) and returns cudaGetLastError().
//
// Per layer, with x [B, N, C_in] node-major (N = T*V), M [N, N], W and W_res
// [C_in, C_out] in flax orientation:
//   g = M^T x,  t = g W + b,  r = x W_res + b_res  (r = x for an identity residual)
//   pre = BN_ghost(t; gamma, beta) + BN_ghost(r; gamma_res, beta_res)   (identity: + x)
//   y = PReLU(pre)
// where BN_ghost takes the biased statistics of each block of `ghost`
// consecutive windows over all their N nodes. The top layer feeds the
// projector z = y_flat wp + bp, y flattened node-major (the flax kernel's
// (t, v, c) row order).
//
// What bounds it on an H100: at the flagship width a window needs ~10.8
// MFLOP forward (the graph contraction 2 N^2 C_in is 70% of it) and ~2-3x
// that backward, against ~0.5 MB of activations in and out per window,
// ~40-60 FLOP/byte: above the fp32 ridge (~20 FLOP/byte at 67 TFLOP/s over
// 3.35 TB/s), so every product runs as 3xTF32 on the tensor cores (three
// TF32 products for each fp32 one, ~fp32 accuracy), where the FLOPs take
// less time than the bytes. The design is the simple one, right first:
//   * A ghost block (64 windows x 216 nodes x 64 channels, 3.5 MB) does not
//     fit in an SM's 227 KB, so ghost statistics cross thread blocks, and
//     Hopper's blocks run in no order (the TPU accumulated across its
//     sequential grid). Each layer therefore runs as passes: a block of one
//     to four windows computes g, t, r and per-window channel moments; one
//     block per ghost block turns them into (mean, inv_std); an elementwise
//     pass normalizes; on the top layer a product kernel projects. No float
//     atomics: every sum is taken in a fixed order, so the results repeat
//     bit for bit from run to run.
//   * The backward follows the same shape: per window the PReLU backward
//     and the sums s1 = sum dpre, s2 = sum dpre t (and dpre r); per ghost
//     block the affine constants of d_raw = a dpre + b raw + c (the TPU
//     kernel's bn_consts); per window dt, dr, dg = dt W^T and dx = M dg +
//     dr W_res^T.
//   * dW, dW_res, dM and dwp are reductions over the whole batch: 22 GFLOP
//     over 1.2 GB of operands a flagship step (B = 2048). In fp32 outside
//     the tensor cores the FLOPs alone take as long as the bytes (0.33 vs
//     0.36 ms), so no SIMT kernel reaches the memory bound; as 3xTF32 on
//     the tensor cores (three TF32 products for each fp32 one, ~fp32
//     accuracy) they take 0.13 ms, and the bytes bound them. They run as
//     3xTF32 mma.sync, each warp staging its share of the reduction with
//     16-byte cp.async several steps ahead, in output tiles fitted to each
//     product's shape (see the product kernels), split over blocks along
//     the batch, then a pass that sums the splits.
//   * Intermediates (t, r, dpre, g, dg) go through device memory. That
//     costs bytes, not operations, which is the right trade for a first
//     version; keeping them on chip is later work. Under "bfloat16" they are
//     bf16, half the bytes (see the forms below).
//   * The per-window passes (K2's fwd_pre and projector_z, the backward's
//     bwd_pre, projector_dy and bwd_dx) run their products as 3xTF32
//     mma.sync too, which leaves them bound by their scratch traffic (~1.4-
//     1.6 GB a pass a flagship step); see "the per-window passes" below. No
//     TMA or wgmma: those come with the PRs that make them fast.
//
// K5, the mono backward, keeps nothing from the forward: it reads x, dz and
// the operands and writes every gradient. Its function needs the fp32 work
// of K4 + K3, which already hold g, t and r once; the kernel does more, K2's
// passes and then K4's and K3's, which compute g, t and r again. Its
// reason to exist is memory: split keeps x and every layer's
// activations alive from forward to backward (442,368 rows x 146 channels,
// 258 MB at the flagship width and B = 2048) and its backward scratch
// (t, r, dpre, g, dg over the batch) adds ~450 MB. Ghost statistics never
// cross a ghost block, so K5 walks the batch in chunks of whole ghost
// blocks (the last one may be ragged), and for each chunk:
//   * re-runs K2's passes on the chunk's windows (pointer offsets; the
//     running-statistic sums were taken in the forward and are skipped),
//     keeping each layer's output and block statistics in a chunk
//     workspace;
//   * runs K4's and K3's passes over that workspace, top layer down, with
//     no dx on layer 0 (the TPU body computes it and throws it away);
//   * writes its share of dW, dW_res, dM and dwp to a [n_chunks, ...]
//     buffer, and its per-window / per-ghost-block shares of dgamma, dbeta,
//     db, dalpha to whole-batch buffers.
// One last pass sums them in chunk (and block) order: no float atomics, so
// runs repeat bit for bit. That is the simple design: the same passes as
// K2-K4, reused, not a fused remat kernel. The TPU walked one ghost block a
// grid step with its whole live set in VMEM; a ghost block's live set (~3.5
// MB at f32) is far past an SM's 227 KB, so here a chunk's lives in a
// workspace in device memory and L2, and what is left to design is the
// schedule: how large a chunk is and how many run at once.
//   * The chunk comes from a byte budget (stse_train.py's mono_chunk): the
//     largest whole number of ghost blocks whose footprint (the chunk
//     workspaces in flight and the whole-batch buffers) stays at or under
//     what K2's forward allocates at the same batch and form. A mono step's
//     peak memory is that forward, so K5 adds none to it, and each pass gets
//     as many blocks as that memory allows (128 windows fed bwd_dx 128
//     blocks on 132 SMs).
//   * Up to two chunks run at once, each in its own workspace slot (one
//     buffer, the descriptor's MH_SLOT_BYTES apart): chunk c in slot c % 2,
//     slot 0 on the caller's stream and slot 1 on a second stream, forked
//     from and joined back to the caller's with events (run_mono). One
//     chunk's small passes (statistics, constants, split sums) then overlap
//     the other's large ones. No chunk writes what another reads or writes,
//     so the result is the bits of one stream.

// The compute_dtype forms (each kernel and host function below that runs a
// product or stores a value is a template on one, ComputeDtype; the entry
// points read it from the descriptor):
//   float32            every product 3xTF32 (~fp32), everything stored fp32;
//   bfloat16           every product's operands rounded to bf16 (exact
//                      products, fp32 sums), and the values JAX stores at bf16
//                      rounded where they are stored (`stored`): the layer
//                      input x as read, g, t and r, the output y, the
//                      projector's dy, dy as read, dpre, dg and dx. The
//                      interface (x, y, dy, dx) is bf16 (`act_t`), as the
//                      JAX kernel stores these values in its dtype
//                      (coskad_tpu/kernels/stse_train.py:420-422, 450); K2's
//                      t and r scratch and K3's, K4's and K5's per-window
//                      backward scratch (g, t, r, dpre, dg and M's operand)
//                      are bf16 (`scratch_t`), as it stores g3, t3, r3 and
//                      pre3; statistics, sums, z and weight gradients are
//                      fp32;
//   bfloat16_f32store  bf16 operands, every value stored fp32.
// Under both bf16 forms every per-window pass (fwd_pre, projector_z,
// bwd_pre, projector_dy, bwd_dx) and the batch-reduction products run on
// the bf16 mma (m16n8k16; m16n8k8 where a depth leaves 8), their fragments
// loaded as bf16 pairs: straight from bf16 memory (M^T's graph operand,
// scratch, activations, shared memory), or packed by cvt.rn.bf16x2.f32 from
// an fp32 source (the weights, dz, M, and x, y, dy under
// "bfloat16_f32store"), the bits the rounding of the TF32 path gave. fwd_pre
// and bwd_pre compute g, t and r in one routine from the same operands, so
// the backward's recompute is the forward's arithmetic, bit for bit.
// The wrapper rounds the input windows to bf16 for both bf16 forms (JAX casts
// x_t to the operand dtype). The JAX kernel's own store points
// (coskad_tpu/kernels/stse_train.py:342-372, 450, 814-821) are those of its
// algorithm; these are the same rule, a value rounded where it is stored at
// the store dtype, applied to this one's.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

#include "tf32_mma.cuh"  // tf32_of, bf16_bits, split_tf32, mma_3xtf32, cp_async16, warp_tile, ...

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-5f;

// compute_dtype forms, in the order of stse_train.py's COMPUTE_DTYPES.
enum ComputeDtype { kFloat32 = 0, kBfloat16 = 1, kBfloat16F32Store = 2 };
// A form's operand precision (tf32_mma.cuh).
template <int D>
constexpr int op_of = D == kFloat32 ? kOpF32 : kOpBF16;
// v as the form stores it: rounded to bf16 under "bfloat16", else as it is.
template <int D>
__device__ __forceinline__ float stored(float v) {
  if constexpr (D == kBfloat16)
    return __uint_as_float(bf16_bits(v));
  else
    return v;
}

// The type of the per-window scratch (K2's t and r; the backward's g, t, r,
// dpre, dg and graph operand) in form D: bf16 under "bfloat16", where each of
// these values is a bf16 value already (`stored`) or is rounded to one by
// the product that reads it, as the JAX kernel stores g3, t3, r3 and pre3
// in its dtype (coskad_tpu/kernels/stse_train.py:342-345); else fp32.
template <int D>
using scratch_t = typename std::conditional<D == kBfloat16, __nv_bfloat16, float>::type;
// The type of the values K2-K5 hand each other (x, y, dy, dx) in form D:
// bf16 under "bfloat16", where each is a bf16 value (`stored`), else fp32.
template <int D>
using act_t = scratch_t<D>;
// Whether bwd_pre keeps t and r themselves in scratch (bf16 values under
// "bfloat16"; bwd_dx centres them again, the same fp32 subtraction of the
// same values) or, in the fp32-scratch forms, the centred tc and rc.
template <int D>
constexpr bool raw_scratch = D == kBfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
// v written to scratch: rounded to bf16 (to nearest even) in a bf16 buffer.
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
// Four consecutive values as one load or store (16 bytes of fp32, 8 of
// bf16; p aligned to that).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xFFFF0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xFFFF0000u));
}
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
}

// The bits of a bf16 value, and two of them as one fragment register.
__device__ __forceinline__ uint32_t bits_of(__nv_bfloat16 v) {
  return *reinterpret_cast<const unsigned short*>(&v);
}
__device__ __forceinline__ uint32_t bf16_pair(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return bits_of(lo) | bits_of(hi) << 16;
}

// ---- descriptor layouts (int64 arrays built by stse_train.py) ----
enum FwdHeader {
  FH_N_LAYERS, FH_BATCH, FH_N_NODES, FH_GHOST, FH_LATENT, FH_X, FH_WP, FH_BP, FH_Z,
  FH_T_BUF, FH_R_BUF, FH_PART, FH_BLOCK_SUMS, FH_Z_SPLITS, FH_Z_PART, FH_GRAPH, FH_DTYPE,
  FH_COUNT
};
enum FwdLayerField {
  FL_CI, FL_CO, FL_IDENTITY, FL_M, FL_W, FL_B, FL_GAMMA, FL_BETA, FL_W_RES, FL_B_RES,
  FL_GAMMA_RES, FL_BETA_RES, FL_ALPHA, FL_ACT, FL_STATS, FL_SUMS, FL_COUNT
};
// One product alone (stse_train_product); forms in the order of
// stse_train.py's PRODUCT_FORMS.
enum ProductForm { PF_ROWS, PF_WINDOWS };
enum ProductField {
  PD_FORM, PD_P, PD_Q, PD_N, PD_K, PD_A, PD_B, PD_SPLITS, PD_PART, PD_OUT, PD_DTYPE, PD_A_BF16,
  PD_B_BF16, PD_COUNT
};
enum BwdField {
  BD_BATCH, BD_N_NODES, BD_GHOST, BD_CI, BD_CO, BD_IDENTITY, BD_LATENT, BD_X, BD_DY, BD_DZ,
  BD_WP, BD_Y, BD_M, BD_W, BD_B, BD_GAMMA, BD_BETA, BD_W_RES, BD_B_RES, BD_GAMMA_RES,
  BD_BETA_RES, BD_ALPHA, BD_STATS, BD_DM, BD_DW, BD_DB, BD_DGAMMA, BD_DBETA, BD_DW_RES,
  BD_DB_RES, BD_DGAMMA_RES, BD_DBETA_RES, BD_DALPHA, BD_DX, BD_DWP, BD_DBP, BD_MT, BD_G_BUF,
  BD_T_BUF, BD_R_BUF, BD_DPRE_BUF, BD_DG_BUF, BD_PART, BD_DALPHA_PART, BD_CONSTS, BD_GPART,
  BD_PROD_BUF, BD_SPLITS_W, BD_SPLITS_W_RES, BD_SPLITS_M, BD_SPLITS_WP, BD_DTYPE, BD_COUNT
};
// K5: a header, then one row per layer. The gradients (ML_DM ... ML_DALPHA)
// follow the operands (ML_M ... ML_ALPHA) in the same order.
enum MonoHeader {
  MH_N_LAYERS, MH_BATCH, MH_N_NODES, MH_GHOST, MH_LATENT, MH_CHUNK, MH_IN_FLIGHT, MH_SLOT_BYTES,
  MH_X, MH_DZ, MH_WP, MH_DWP, MH_DBP, MH_SPLITS_WP, MH_CHUNK_DWP, MH_T_BUF, MH_R_BUF,
  MH_DPRE_BUF, MH_G_BUF, MH_DG_BUF, MH_DY_BUF, MH_PART, MH_BLOCK_SUMS, MH_CONSTS, MH_PROD_BUF,
  MH_DTYPE, MH_COUNT
};
enum MonoLayerField {
  ML_CI, ML_CO, ML_IDENTITY, ML_M, ML_W, ML_B, ML_GAMMA, ML_BETA, ML_W_RES, ML_B_RES,
  ML_GAMMA_RES, ML_BETA_RES, ML_ALPHA, ML_DM, ML_DW, ML_DB, ML_DGAMMA, ML_DBETA, ML_DW_RES,
  ML_DB_RES, ML_DGAMMA_RES, ML_DBETA_RES, ML_DALPHA, ML_ACT, ML_STATS, ML_MT, ML_GPART,
  ML_DALPHA_PART, ML_CHUNK_DM, ML_CHUNK_DW, ML_CHUNK_DW_RES, ML_SPLITS_W, ML_SPLITS_M, ML_COUNT
};
static_assert((int)FL_ALPHA == (int)ML_ALPHA, "forward and mono rows share their operands");

struct Layer {
  int ci, co, identity;
  const float *m, *w, *b, *gamma, *beta, *wr, *br, *gamma_r, *beta_r, *alpha, *stats;
};

template <class T>
T* ptr(const long long* d, int i) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(d[i]));
}

// K5's chunk-workspace buffer d[i] in the slot `offset` bytes past slot 0
// (null stays null).
template <class T>
T* in_slot(const long long* d, int i, long long offset) {
  return d[i] == 0 ? nullptr : reinterpret_cast<T*>(static_cast<uintptr_t>(d[i] + offset));
}

// In-place tree sum of red[q * kThreads + tid] over tid for q < rows; the
// caller has synchronised. Leaves the sums in red[q * kThreads].
__device__ void block_reduce(float* red, int rows) {
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s)
      for (int q = 0; q < rows; ++q) red[q * kThreads + threadIdx.x] += red[q * kThreads + threadIdx.x + s];
    __syncthreads();
  }
}

// ================= shared by K3 and K4 =================

// The graph operands of the per-window passes in form D's scratch. Under
// "bfloat16": M and M^T rounded to bf16, each in rows of graph_ld(n) = n
// rounded up to 8 (zero past n), one after the other: the A operands of
// bwd_dx's dx = M dg, A(r, k) = M[r][k], and of fwd_pre's and bwd_pre's g =
// M^T x, A(r, k) = M[k][r], so the pair A(r, k), A(r, k + 1) of a bf16
// fragment is one aligned 32-bit load, at half M's bytes (K2 reads only
// M^T). Else M^T alone (fp32), for bwd_dx, so lanes on
// consecutive rows read consecutive addresses (fwd_pre and bwd_pre read M
// itself).
template <int D>
__host__ __device__ inline int graph_ld(int n) {
  return D == kBfloat16 ? round8(n) : n;
}
// The bf16 M^T half of form D's graph operand, which fwd_pre and bwd_pre
// read under "bfloat16" (null in the other forms: they read M itself).
template <int D>
__device__ __forceinline__ const __nv_bfloat16* graph_mt(const scratch_t<D>* graph, int n) {
  if constexpr (D == kBfloat16)
    return graph + (long long)n * graph_ld<D>(n);
  else
    return nullptr;
}
template <int D>
__global__ void __launch_bounds__(kThreads)
graph_operand_kernel(const float* __restrict__ src, scratch_t<D>* dst, int n) {
  const int ld = graph_ld<D>(n);
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)n * ld) return;
  const int r = (int)(i / ld), c = (int)(i % ld);
  if constexpr (D == kBfloat16) {
    put(dst + i, c < n ? src[(long long)r * n + c] : 0.0f);
    put(dst + (long long)n * ld + i, c < n ? src[(long long)c * n + r] : 0.0f);
  } else {
    dst[(long long)c * n + r] = src[i];
  }
}

// Backward pass 1 (bwd_pre_kernel) runs on the tensor cores: see below.

// Backward pass 2, one block per ghost block: the ghost-BN backward's
// per-channel constants d_raw = a dpre + b (raw - mean) + c for t (and r),
// consts [k][6][co], and this block's dgamma, dbeta, dbias, gpart [k][6][co].
// With x_hat = (raw - mean) inv: dgamma = sum dpre x_hat, a = gamma inv,
// b = -a inv dgamma / cnt, c = -a sum(dpre) / cnt. dbias = sum d_raw =
// b sum(raw - mean) is exactly zero (BatchNorm removes any shift of its
// input), so it is written as 0; the TPU kernel's a s1 + b cnt mean + c cnt
// is that zero plus rounding, which a channel with a large mean against its
// spread magnifies.
__global__ void __launch_bounds__(kThreads)
bwd_consts_kernel(const float* __restrict__ part, Layer L, int ghost, int n, float* consts,
                  float* gpart) {
  const int co = L.co, k = blockIdx.x;
  const float cnt = (float)ghost * (float)n;
  const float* st = L.stats + (long long)k * 4 * co;
  float* cs = consts + (long long)k * 6 * co;
  float* gp = gpart + (long long)k * 6 * co;
  for (int o = threadIdx.x; o < co; o += kThreads) {
    float s[3] = {0.0f, 0.0f, 0.0f};  // s1, s2t, s2r
    for (int w = 0; w < ghost; ++w) {
      const float* row = part + ((long long)k * ghost + w) * 3 * co;
#pragma unroll
      for (int q = 0; q < 3; ++q) s[q] += row[q * co + o];
    }
    const float s1 = s[0];
    for (int br = 0; br < 2; ++br) {
      if (br == 1 && L.identity) {
        for (int q = 3; q < 6; ++q) cs[q * co + o] = gp[q * co + o] = 0.0f;
        break;
      }
      const float inv = st[(2 * br + 1) * co + o];
      const float gam = br ? L.gamma_r[o] : L.gamma[o];
      const float dgam = inv * s[1 + br];
      const float a = gam * inv;
      const float b = -a * inv * (dgam / cnt);
      cs[(3 * br) * co + o] = a;
      cs[(3 * br + 1) * co + o] = b;
      cs[(3 * br + 2) * co + o] = -a * (s1 / cnt);
      gp[(3 * br) * co + o] = dgam;
      gp[(3 * br + 1) * co + o] = s1;
      gp[(3 * br + 2) * co + o] = 0.0f;
    }
  }
}

// Backward pass 3, one block: sum the ghost blocks' shares into dgamma,
// dbeta, db (and the residual's), dalpha over the windows, and dbp = sum dz.
__global__ void __launch_bounds__(kThreads)
bwd_reduce_kernel(const float* __restrict__ gpart, int n_blocks,
                  const float* __restrict__ dalpha_part, int batch, Layer L, float* dgamma,
                  float* dbeta, float* db, float* dgamma_r, float* dbeta_r, float* dbr,
                  float* dalpha, const float* __restrict__ dz, int latent, float* dbp) {
  extern __shared__ __align__(16) float red[];  // [kThreads]
  const int co = L.co, tid = threadIdx.x;
  float* outs[6] = {dgamma, dbeta, db, dgamma_r, dbeta_r, dbr};
  for (int j = tid; j < 6 * co; j += kThreads) {
    const int q = j / co, o = j - q * co;
    if (q >= 3 && L.identity) continue;
    float s = 0.0f;
    for (int k = 0; k < n_blocks; ++k) s += gpart[(long long)k * 6 * co + j];
    outs[q][o] = s;
  }
  float s = 0.0f;
  for (int w = tid; w < batch; w += kThreads) s += dalpha_part[w];
  red[tid] = s;
  __syncthreads();
  block_reduce(red, 1);
  if (tid == 0) *dalpha = red[0];
  if (dz == nullptr) return;  // uniform over the block
  // dbp: thread j sums windows j / latent, + lanes, ... of column j % latent
  // (all threads busy for latent <= kThreads), then one thread a column
  // adds the lanes' sums.
  const int lanes = latent <= kThreads ? kThreads / latent : 1;
  for (int l0 = 0; l0 < latent; l0 += kThreads) {
    __syncthreads();
    const int l = l0 + tid % latent, lane = tid / latent;
    float acc = 0.0f;
    if (lane < lanes && l < latent)
      for (int w = lane; w < batch; w += lanes) acc += dz[(long long)w * latent + l];
    red[tid] = acc;
    __syncthreads();
    if (tid < latent - l0 && tid < kThreads) {
      float total = 0.0f;
      for (int k = 0; k < lanes; ++k) total += red[k * latent + tid];
      dbp[l0 + tid] = total;
    }
  }
}

// Backward pass 4 (bwd_dx_kernel) runs on the tensor cores: see below.

// ================= the batch-reduction products (K3, K4, K5) =================
//
// dW = g^T dt and dW_res = x^T dr (rows form: A [R, P], B [R, Q], the sum over
// R = B * N rows), dwp = y_flat^T dz (rows form, R = B windows) and dM = sum
// over windows of x_w dg_w^T (windows form: A [W, P, K], B [W, Q, K], the sum
// over windows and channels): the dots the TPU body folds (p_t = dpre g3^T
// in _layer_bwd_body, coskad_tpu/kernels/stse_train.py:656; dwp at :768).
// A block owns one tile of the output; its eight warps each take every
// eighth step of the block's share of the reduction (a step is kRowsStep
// rows, or kChanStep channels of one window), stage it into kStages slabs
// of their own with cp.async (two steps in flight while the third is
// multiplied) and multiply it on the tensor cores as mma.sync in the form's
// operand precision OP: 3xTF32 (m16n8k8), or bf16 (m16n8k16, m16n8k8 for a
// window's last 8 channels or fewer). An operand is staged as it is stored,
// fp32 or bf16 (TA, TB): under "bfloat16" every operand but dz (g, dt, dr,
// dg, x, y) is bf16 and stages at half the bytes; an fp32 operand of a bf16
// product is packed to bf16 pairs as its fragments are loaded
// (pack_bf16x2, cvt.rn.bf16x2.f32).
// The warps' sums are added in warp order, and the blocks that split the
// reduction write [splits, P, Q] partials that sum_splits_kernel adds in
// split order: no float atomics, the same bits on every run.

constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;     // steps a warp has staged or in flight
constexpr int kRowsStep = 16;  // rows form: reduction rows a step
constexpr int kChanStep = 16;  // windows form: channels of one window a step
constexpr int kWinMT = 2, kWinNT = 7;  // windows tile 32 x 56: 216 nodes in 7 x 4 tiles

// Slab row strides, in elements, chosen so that the 32 lanes of a fragment
// load hit 32 banks (g = lane / 4 runs along a row, t = lane % 4 across rows
// or along k):
//   rows form, a row of `width` (the tile's 16 MT or 8 NT) values of one
//   reduction row: 3xTF32 reads rows k0 + t, width + 8 floats (t apart by 8
//   mod 32 words); bf16 reads the pair of rows k0 + 2t, + 1 as two 16-bit
//   loads, width + 8 bf16 (t apart by 8 mod 32 words); fp32 packed to bf16
//   reads the same rows, width + 4 floats (2t rows: 8t mod 32 words);
//   windows form, a row of kChanStep channels of one node: 3xTF32 20 floats
//   (4 mod 8 words: g apart), bf16 24 (12 words: a pair one 32-bit load),
//   fp32 packed 24 floats (a pair one 8-byte load; each half-warp's 8-byte
//   loads on 32 banks).
template <int OP, class T>
__host__ __device__ constexpr int rows_ld(int width) {
  return OP == kOpBF16 && sizeof(T) == 4 ? width + 4 : width + 8;
}
template <int OP>
__host__ __device__ constexpr int windows_ld() {
  return OP == kOpF32 ? kChanStep + 4 : kChanStep + 8;
}

template <class T>
__device__ __forceinline__ void set_zero(T* p, int i) {
  if constexpr (sizeof(T) == 2)
    reinterpret_cast<unsigned short*>(p)[i] = 0;
  else
    p[i] = 0.0f;
}

// Stage rows x width elements (row i at src + i * ld) into a warp's slab
// (row stride lds), `ce` elements a copy: cp.async of 16 bytes or 4 (the
// rows, the stride and src in whole copies), or, for bf16 rows of odd width
// or stride, a plain copy of each element. The lanes walk (row, column) by
// counters.
template <class T>
__device__ __forceinline__ void stage_block(T* dst, int lds, const T* __restrict__ src,
                                            long long ld, int rows, int width, int ce) {
  const int cols = width / ce;  // copies a row
  if (cols <= 0) return;
  const int lane = threadIdx.x & 31;
  int r = lane / cols, c = lane - r * cols;
  const int dr = 32 / cols, dc = 32 - dr * cols;
  auto walk = [&](auto copy) {
    while (r < rows) {
      copy(r, c);
      r += dr;
      c += dc;
      if (c >= cols) {
        c -= cols;
        ++r;
      }
    }
  };
  const int bytes = ce * (int)sizeof(T);
  if (bytes == 16)
    walk([&](int i, int j) { cp_async16(dst + i * lds + ce * j, src + i * ld + ce * j); });
  else if (bytes == 4)
    walk([&](int i, int j) { cp_async4(dst + i * lds + ce * j, src + i * ld + ce * j); });
  else
    walk([&](int i, int j) { dst[i * lds + j] = src[i * ld + j]; });
}

// A bf16 fragment register from a staged operand: the pair v[0], v[step]
// (two 16-bit loads of bf16, or two fp32 values packed), and the pair v[0],
// v[1] of consecutive elements (one 32-bit load of bf16, one 8-byte load of
// fp32 then packed; v 4- or 8-byte aligned).
__device__ __forceinline__ uint32_t pair_strided(const __nv_bfloat16* v, int step) {
  return bf16_pair(v[0], v[step]);
}
__device__ __forceinline__ uint32_t pair_strided(const float* v, int step) {
  return pack_bf16x2(v[0], v[step]);
}
__device__ __forceinline__ uint32_t pair_next(const __nv_bfloat16* v) {
  return *reinterpret_cast<const uint32_t*>(v);
}
__device__ __forceinline__ uint32_t pair_next(const float* v) {
  const float2 f = *reinterpret_cast<const float2*>(v);
  return pack_bf16x2(f.x, f.y);
}

// The warps' sums (acc of each lane) added in warp order; the tile's
// outputs inside P x Q written to out [P][Q]. smem is free on entry.
template <int MT, int NT>
__device__ __forceinline__ void write_tile(const float (&acc)[MT][NT][4], float* smem, int p0,
                                           int q0, int P, int Q, float* out) {
  constexpr int E = MT * NT * 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        smem[(warp * E + (mt * NT + nt) * 4 + i) * 32 + lane] = acc[mt][nt][i];
  __syncthreads();
  for (int e = threadIdx.x; e < E * 32; e += kThreads) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += smem[w * E * 32 + e];
    const int l = e & 31, i = (e >> 5) & 3, tile = e >> 7;
    const int p = p0 + (tile / NT) * 16 + (l >> 2) + (i >= 2 ? 8 : 0);
    const int q = q0 + (tile % NT) * 8 + 2 * (l & 3) + (i & 1);
    if (p < P && q < Q) out[(long long)p * Q + q] = s;
  }
}

// Rows form. Block (tile, split) owns outputs [p0, p0 + 16 MT) x [q0, q0 +
// 8 NT) and rows [r0, r0 + r_split). A warp's slab holds a step as A rows
// [kRowsStep][LDA] and B rows [kRowsStep][LDB] (rows_ld). The mma's k is the
// reduction row: a bf16 fragment register pairs two rows of one column.
template <int OP, class TA, class TB, int MT, int NT>
__global__ void __launch_bounds__(kThreads)
product_rows_kernel(const TA* __restrict__ a, const TB* __restrict__ b, int P, int Q,
                    long long R, long long r_split, float* out, int ce_a, int ce_b) {
  constexpr int PT = 16 * MT, QT = 8 * NT;
  constexpr int LDA = rows_ld<OP, TA>(PT), LDB = rows_ld<OP, TB>(QT);
  constexpr int SA = kRowsStep * LDA, SB = kRowsStep * LDB;  // elements
  constexpr int SLAB = SA * (int)sizeof(TA) + SB * (int)sizeof(TB);  // bytes
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  char* slabs = reinterpret_cast<char*>(smem) + warp * kStages * SLAB;
  auto slab_a = [&](int j) { return reinterpret_cast<TA*>(slabs + (j % kStages) * SLAB); };
  auto slab_b = [&](int j) {
    return reinterpret_cast<TB*>(slabs + (j % kStages) * SLAB + SA * (int)sizeof(TA));
  };
  const int tiles_q = (Q + QT - 1) / QT;
  const int p0 = (blockIdx.x / tiles_q) * PT, q0 = (blockIdx.x % tiles_q) * QT;
  const int pw = P - p0 < PT ? P - p0 : PT, qw = Q - q0 < QT ? Q - q0 : QT;
  const long long r0 = blockIdx.y * r_split;
  const long long r1 = r0 + r_split < R ? r0 + r_split : R;
  const long long steps = r1 > r0 ? (r1 - r0 + kRowsStep - 1) / kRowsStep : 0;
  const int mine = steps > warp ? (int)((steps - warp + kWarps - 1) / kWarps) : 0;
  for (int i = lane; i < kStages * SLAB / 4; i += 32)  // the pads stay 0
    reinterpret_cast<float*>(slabs)[i] = 0.0f;
  __syncwarp();
  // The warp's j-th step (rows r0 + (warp + j kWarps) kRowsStep on) into slab j % kStages.
  auto stage_step = [&](int j) {
    if (j < mine) {
      const long long rs = r0 + (long long)(warp + j * kWarps) * kRowsStep;
      const int rows = r1 - rs < kRowsStep ? (int)(r1 - rs) : kRowsStep;
      TA* as = slab_a(j);
      TB* bs = slab_b(j);
      stage_block(as, LDA, a + rs * P + p0, P, rows, pw, ce_a);
      stage_block(bs, LDB, b + rs * Q + q0, Q, rows, qw, ce_b);
      for (int i = rows * LDA + lane; i < SA; i += 32) set_zero(as, i);  // last step
      for (int i = rows * LDB + lane; i < SB; i += 32) set_zero(bs, i);
    }
    cp_async_commit();
  };
  float acc[MT][NT][4] = {};
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) stage_step(j);
  for (int j = 0; j < mine; ++j) {
    stage_step(j + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const TA* as = slab_a(j);
    const TB* bs = slab_b(j);
    if constexpr (OP == kOpF32) {
#pragma unroll
      for (int kk = 0; kk < kRowsStep; kk += 8) {
        uint32_t ab[MT][4], asm_[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float* f = as + (kk + t) * LDA + mt * 16 + g;  // A[p][k] = slab[k][p]
          split_tf32(f[0], ab[mt][0], asm_[mt][0]);
          split_tf32(f[8], ab[mt][1], asm_[mt][1]);
          split_tf32(f[4 * LDA], ab[mt][2], asm_[mt][2]);
          split_tf32(f[4 * LDA + 8], ab[mt][3], asm_[mt][3]);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float* f = bs + (kk + t) * LDB + nt * 8 + g;  // B[k][q] = slab[k][q]
          uint32_t bb[2], bsm[2];
          split_tf32(f[0], bb[0], bsm[0]);
          split_tf32(f[4 * LDB], bb[1], bsm[1]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_3xtf32(acc[mt][nt], ab[mt], asm_[mt], bb, bsm);
        }
      }
    } else {  // one m16n8k16 a tile per step: k is the step's 16 rows, paired 2t, 2t + 1
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const TA* f = as + 2 * t * LDA + mt * 16 + g;
        af[mt][0] = pair_strided(f, LDA);
        af[mt][1] = pair_strided(f + 8, LDA);
        af[mt][2] = pair_strided(f + 8 * LDA, LDA);
        af[mt][3] = pair_strided(f + 8 * LDA + 8, LDA);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const TB* f = bs + 2 * t * LDB + nt * 8 + g;
        const uint32_t bf[2] = {pair_strided(f, LDB), pair_strided(f + 8 * LDB, LDB)};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16_k16(acc[mt][nt], af[mt], bf);
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();
  __syncthreads();
  write_tile<MT, NT>(acc, smem, p0, q0, P, Q, out + (long long)blockIdx.y * P * Q);
}

// Windows form. Block (tile, split) owns outputs [p0, p0 + 32) x [q0, q0 +
// 56) and windows [w0, w0 + w_split); a step is kChanStep channels of one
// window: A rows [32][LDK] and B rows [56][LDK] (windows_ld), each row a
// node's channels (contiguous in memory): the mma's k is the channel, so a
// bf16 fragment register is two neighbouring channels. Channels past K
// (layer 0 has 2) stay 0 up to the mma's k (8 for a step of 8 channels or
// fewer, else 16).
template <int OP, class TA, class TB>
__global__ void __launch_bounds__(kThreads)
product_windows_kernel(const TA* __restrict__ a, const TB* __restrict__ b, int P, int Q, int W,
                       int K, int w_split, float* out, int ce_a, int ce_b) {
  constexpr int MT = kWinMT, NT = kWinNT, PT = 16 * MT, QT = 8 * NT, LDK = windows_ld<OP>();
  constexpr int SA = PT * LDK, SB = QT * LDK;  // elements
  constexpr int SLAB = SA * (int)sizeof(TA) + SB * (int)sizeof(TB);  // bytes
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  char* slabs = reinterpret_cast<char*>(smem) + warp * kStages * SLAB;
  auto slab_a = [&](int j) { return reinterpret_cast<TA*>(slabs + (j % kStages) * SLAB); };
  auto slab_b = [&](int j) {
    return reinterpret_cast<TB*>(slabs + (j % kStages) * SLAB + SA * (int)sizeof(TA));
  };
  const int tiles_q = (Q + QT - 1) / QT;
  const int p0 = (blockIdx.x / tiles_q) * PT, q0 = (blockIdx.x % tiles_q) * QT;
  const int pw = P - p0 < PT ? P - p0 : PT, qw = Q - q0 < QT ? Q - q0 : QT;
  const int w0 = blockIdx.y * w_split;
  const int w1 = w0 + w_split < W ? w0 + w_split : W;
  const int chunks = (K + kChanStep - 1) / kChanStep;
  const long long steps = w1 > w0 ? (long long)(w1 - w0) * chunks : 0;
  const int mine = steps > warp ? (int)((steps - warp + kWarps - 1) / kWarps) : 0;
  for (int i = lane; i < kStages * SLAB / 4; i += 32) reinterpret_cast<float*>(slabs)[i] = 0.0f;
  __syncwarp();
  auto stage_step = [&](int j) {
    if (j < mine) {
      const int s = warp + j * kWarps, win = w0 + s / chunks, c0 = (s % chunks) * kChanStep;
      const int kc = K - c0 < kChanStep ? K - c0 : kChanStep;
      TA* as = slab_a(j);
      TB* bs = slab_b(j);
      if (kc < kChanStep && chunks > 1) {  // a short last chunk after full ones: clear the rest
        for (int r = lane; r < PT; r += 32)
          for (int c = kc; c < kChanStep; ++c) set_zero(as, r * LDK + c);
        for (int r = lane; r < QT; r += 32)
          for (int c = kc; c < kChanStep; ++c) set_zero(bs, r * LDK + c);
      }
      stage_block(as, LDK, a + ((long long)win * P + p0) * K + c0, K, pw, kc, ce_a);
      stage_block(bs, LDK, b + ((long long)win * Q + q0) * K + c0, K, qw, kc, ce_b);
    }
    cp_async_commit();
  };
  float acc[MT][NT][4] = {};
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) stage_step(j);
  for (int j = 0; j < mine; ++j) {
    stage_step(j + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const TA* as = slab_a(j);
    const TB* bs = slab_b(j);
    const int s = warp + j * kWarps, c0 = (s % chunks) * kChanStep;
    const int kc = K - c0 < kChanStep ? K - c0 : kChanStep;
    if constexpr (OP == kOpF32) {
      for (int kk = 0; kk < kc; kk += 8) {
        uint32_t ab[MT][4], asm_[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float* f = as + (mt * 16 + g) * LDK + kk + t;  // A[p][k] = slab[p][k]
          split_tf32(f[0], ab[mt][0], asm_[mt][0]);
          split_tf32(f[8 * LDK], ab[mt][1], asm_[mt][1]);
          split_tf32(f[4], ab[mt][2], asm_[mt][2]);
          split_tf32(f[8 * LDK + 4], ab[mt][3], asm_[mt][3]);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float* f = bs + (nt * 8 + g) * LDK + kk + t;  // B[k][q] = slab[q][k]
          uint32_t bb[2], bsm[2];
          split_tf32(f[0], bb[0], bsm[0]);
          split_tf32(f[4], bb[1], bsm[1]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_3xtf32(acc[mt][nt], ab[mt], asm_[mt], bb, bsm);
        }
      }
    } else {  // channels 2t, 2t + 1 (and + 8) of a node: one m16n8k16, or m16n8k8 for kc <= 8
      const bool k16 = kc > 8;
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const TA* f = as + (mt * 16 + g) * LDK + 2 * t;
        af[mt][0] = pair_next(f);
        af[mt][1] = pair_next(f + 8 * LDK);
        if (k16) {
          af[mt][2] = pair_next(f + 8);
          af[mt][3] = pair_next(f + 8 * LDK + 8);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const TB* f = bs + (nt * 8 + g) * LDK + 2 * t;
        const uint32_t b0 = pair_next(f);
        if (k16) {
          const uint32_t bf[2] = {b0, pair_next(f + 8)};
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_bf16_k16(acc[mt][nt], af[mt], bf);
        } else {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const uint32_t a8[2] = {af[mt][0], af[mt][1]};
            mma_bf16_k8(acc[mt][nt], a8, b0);
          }
        }
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();
  __syncthreads();
  write_tile<MT, NT>(acc, smem, p0, q0, P, Q, out + (long long)blockIdx.y * P * Q);
}

__global__ void __launch_bounds__(kThreads)
sum_splits_kernel(const float* __restrict__ part, long long count, int splits, float* out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= count) return;
  float s = 0.0f;
#pragma unroll 8
  for (int k = 0; k < splits; ++k) s += part[(long long)k * count + i];
  out[i] = s;
}

// ================= the per-window passes of K2-K5 on the tensor cores =================
//
// fwd_pre and bwd_pre (g = M^T x, t = g W + b, r = x W_res + b_res, in one
// routine both call), K2's z = y_flat wp, K4's dy = dz wp^T and bwd_dx
// (dg = dt W^T, dx = M dg + dr W_res^T) run every product on the tensor
// cores, like the batch-reduction products: as 3xTF32 m16n8k8 mma.sync
// under float32 (warp_tile, tf32_mma.cuh), on the bf16 mma under the bf16
// forms (warp_tile_bf16, fragments as bf16 pairs). Fragments come from
// loaders, small functions (row, k) -> value (or pair): of shared memory;
// of M (or M^T), read through L1/L2 as every
// block reads the same M; or, for dt and dr, computed from device memory
// in the loader and written back there, so those operands need no shared
// buffer. A warp owns whole 16-row tiles
// of the output and loads each A fragment once for all its column tiles,
// so each element of an A operand is loaded by one lane once per 32 output
// columns. No float atomics: a column sum (or moment) is taken lane by
// lane, then warp by warp, in a fixed order.

// Windows a fwd_pre or bwd_pre block takes side by side, so that the graph
// contraction's wb * ci columns reach 32 where they can: one pass over M
// then feeds them all (C_in 2: 4 windows; 16: 2; 32: 1).
__host__ __device__ inline int pre_windows(int ci) {
  const int w = 32 / ci;
  return w >= 4 ? 4 : (w >= 2 ? 2 : 1);
}

// Blocks an SM bwd_pre, bwd_dx and fwd_pre are compiled for, in every form
// (their registers bounded to fit them): at the flagship layers shared
// memory bounds bwd_pre to 2, and bwd_dx's 3xTF32 form fits 4; fwd_pre's
// shared memory fits 4 at layer 0 (C_in 2), where its bf16 form, unbounded,
// took the registers of 2.
constexpr int kPreBlocks = 2, kDxBlocks = 4, kFwdPreBlocks = 4;

// What a column of fwd_pre's and bwd_pre's tiles carries from lane to warp
// to window: fwd_pre its moments (count, mean t, M2 t, mean r, M2 r),
// bwd_pre its sums (sum dpre, sum dpre tc, sum dpre rc).
constexpr int kFwdMoments = 5, kBwdSums = 3;

// fwd_pre's and bwd_pre's shared memory, in floats: x and g [rows][ldx]
// (the nodes rounded up to whole 16-row tiles; the wb * ci columns rounded
// up to 8, + 4, so an A fragment's 32 lanes hit 32 banks), W and W_res
// [ci][ldw] (C_out rounded up to 8, + 8, for the B fragments), then, at the
// offsets csum, wred and red, the column partials [groups][q][C_out rounded
// up to 8], each warp's lane partials [kWarps][32][2 q] and bwd_pre's
// dalpha reduction [kThreads]; q is kFwdMoments or kBwdSums.
struct PreSmem {
  int rows, ldx, ldw, csum, wred, red, total;
};
__host__ __device__ inline PreSmem pre_smem(int n, int ci, int co, int wb, int q) {
  PreSmem s;
  s.rows = (n + 15) / 16 * 16;
  s.ldx = round8(wb * ci) + 4;
  s.ldw = round8(co) + 8;
  s.csum = 2 * s.rows * s.ldx + 2 * ci * s.ldw;
  s.wred = s.csum + q * (round8(co) > 64 ? round8(co) : 64);
  s.red = s.wred + kWarps * 32 * 2 * q;
  s.total = s.red + kThreads;
  return s;
}

// The rows of node tiles that share a channel tile in fwd_pre and bwd_pre:
// with fewer channel tiles than warps, warp w takes channel tile w % tiles
// and every groups-th node tile from w / tiles; else one group.
__host__ __device__ inline int pre_groups(int co) {
  const int otiles = round8(co) / 8;
  return otiles >= kWarps ? 1 : kWarps / otiles;
}

// The block's windows [win0, win0 + nwin) in shared memory: x and g = M^T x
// side by side, W and W_res (0 for an identity residual).
struct PreBlock {
  const float *xs, *gs, *ws, *wrs;
  int rows, ldx, ldw, win0, nwin;
};

// The first half of the g / t / r work fwd_pre and bwd_pre share (so the
// backward's recompute of t and r is the forward's arithmetic, bit for
// bit): stage the block's wb windows of x (as stored: rounded under bf16) and
// the layer's W and W_res in shared memory, then g = M^T x on the windows side
// by side as the columns of one product, M read from L2 as A fragments; g
// (stored) also to g_buf unless it is null. Ends synchronised. NATIVE runs
// the products on the bf16 mma (both passes under a bf16 form), M^T's pairs
// one 32-bit load of mtb (graph_operand_kernel's bf16 M^T) where it is
// given, else packed from M's fp32 values, as the other operands; else
// warp_tile's 3xTF32 (float32).
template <int D, bool NATIVE, class X, class G>
__device__ __forceinline__ PreBlock pre_graph(const X* __restrict__ x, const Layer& L, int n,
                                              int batch, int wb, const PreSmem& sm, float* smem,
                                              G* g_buf,
                                              const __nv_bfloat16* __restrict__ mtb = nullptr) {
  const int ci = L.ci, co = L.co, tid = threadIdx.x, warp = tid >> 5;
  const int rows = sm.rows, ldx = sm.ldx, ldw = sm.ldw, cols = wb * ci;
  float* xs = smem;
  float* gs = xs + rows * ldx;
  float* ws = gs + rows * ldx;
  float* wrs = ws + ci * ldw;
  const int win0 = blockIdx.x * wb;
  const int nwin = batch - win0 < wb ? batch - win0 : wb;
  for (int i = tid; i < rows * ldx; i += kThreads) {
    const int k = i / ldx, j = i - k * ldx, w = j / ci;
    xs[i] = k < n && j < cols && w < nwin
                ? stored<D>(to_f(x[((long long)(win0 + w) * n + k) * ci + j - w * ci]))
                : 0.0f;
  }
  for (int i = tid; i < ci * ldw; i += kThreads) {
    const int c = i / ldw, o = i - c * ldw;
    ws[i] = o < co ? L.w[c * co + o] : 0.0f;
    wrs[i] = o < co && !L.identity ? L.wr[c * co + o] : 0.0f;
  }
  __syncthreads();
  const float* __restrict__ M = L.m;
  auto mt_of = [&](int r, int k) { return r < n && k < n ? __ldg(M + (long long)k * n + r) : 0.0f; };
  auto xs_of = [&](int k, int j) { return xs[k * ldx + j]; };
  const int ctiles = round8(cols) / 8;
  for (int r0 = warp * 16; r0 < rows; r0 += kWarps * 16)
    for (int c0 = 0; c0 < ctiles; c0 += 4) {
      float acc[4][4] = {};
      const int tiles = ctiles - c0 < 4 ? ctiles - c0 : 4;
      if constexpr (NATIVE) {
        if (mtb != nullptr) {  // uniform over the block
          auto mt_pair = [&](int r, int k) -> uint32_t {
            return r < n ? *reinterpret_cast<const uint32_t*>(mtb + (long long)r * round8(n) + k)
                         : 0u;
          };
          warp_tile_bf16<4>(acc, r0, round8(n), 8 * c0, tiles, mt_pair, pairs_b(xs_of));
        } else {
          warp_tile_bf16<4>(acc, r0, round8(n), 8 * c0, tiles, pairs_a(mt_of), pairs_b(xs_of));
        }
      } else
        warp_tile<4>(acc, r0, round8(n), 8 * c0, tiles, mt_of, xs_of);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c0 + j >= ctiles) break;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + frag_row(i), c = 8 * (c0 + j) + frag_col(i), w = c / ci;
          const float g = stored<D>(acc[j][i]);
          gs[r * ldx + c] = g;
          if (g_buf != nullptr && r < n && c < cols && w < nwin)
            put(g_buf + ((long long)(win0 + w) * n + r) * ci + c - w * ci, g);
        }
      }
    }
  __syncthreads();
  return PreBlock{xs, gs, ws, wrs, rows, ldx, ldw, win0, nwin};
}

// The second half: t and r of the block's window w, a warp on one 8-channel
// tile of C_out and every groups-th 16-node tile (pre_groups), each tile's
// t = g W + b and r = x W_res + b_res (r = x for an identity residual) as
// warp_tile<1> products. For each tile fetch(r0, ot) runs before the
// products (loads whose latency they hide), take(r0, ot, t, r) after, with
// t and r in the accumulator layout (frag_row, frag_col; 0 past the nodes
// and channels; stored); flush(ot, grp) after a channel tile's last node tile.
// NATIVE as pre_graph's.
template <int D, bool NATIVE, class Fetch, class Take, class Flush>
__device__ __forceinline__ void pre_window(const PreBlock& pb, const Layer& L, int n, int w,
                                           const Fetch& fetch, const Take& take,
                                           const Flush& flush) {
  const int ci = L.ci, co = L.co, warp = threadIdx.x >> 5, ldx = pb.ldx, ldw = pb.ldw;
  const int otiles = round8(co) / 8, groups = pre_groups(co);
  const int grp = otiles >= kWarps ? 0 : warp / otiles;
  if (grp >= groups) return;
  const float* xs = pb.xs + w * ci;
  const float* gs = pb.gs + w * ci;
  auto g_of = [&](int r, int k) { return k < ci ? gs[r * ldx + k] : 0.0f; };
  auto x_of = [&](int r, int k) { return k < ci ? xs[r * ldx + k] : 0.0f; };
  auto w_of = [&](int k, int o) { return k < ci ? pb.ws[k * ldw + o] : 0.0f; };
  auto wr_of = [&](int k, int o) { return k < ci ? pb.wrs[k * ldw + o] : 0.0f; };
  for (int ot = warp % otiles; ot < otiles; ot += otiles >= kWarps ? kWarps : otiles) {
    for (int r0 = 16 * grp; r0 < pb.rows; r0 += 16 * groups) {
      fetch(r0, ot);
      float at[1][4] = {}, ar[1][4] = {};
      if constexpr (NATIVE) {
        warp_tile_bf16<1>(at, r0, round8(ci), 8 * ot, 1, pairs_a(g_of), pairs_b(w_of));
        if (!L.identity)
          warp_tile_bf16<1>(ar, r0, round8(ci), 8 * ot, 1, pairs_a(x_of), pairs_b(wr_of));
      } else {
        warp_tile<1>(at, r0, round8(ci), 8 * ot, 1, g_of, w_of);
        if (!L.identity) warp_tile<1>(ar, r0, round8(ci), 8 * ot, 1, x_of, wr_of);
      }
      float t[4], r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = r0 + frag_row(i), o = 8 * ot + frag_col(i);
        const bool in = rr < n && o < co;
        t[i] = in ? stored<D>(at[0][i] + L.b[o]) : 0.0f;
        r[i] = !in ? 0.0f : (L.identity ? xs[rr * ldx + o] : stored<D>(ar[0][i] + L.br[o]));
      }
      take(r0, ot, t, r);
    }
    flush(ot, grp);
  }
}

// bwd_dx's shared memory. Under float32 (3xTF32 fragments of fp32 values):
// dg [rows][lddg] (C_in rounded up to 8, + 4) and W^T and W_res^T [co][ldwt]
// (C_in rounded up to 8, + 8) in fp32. Under the bf16 forms (bf16 mma
// fragments, a register a pair along k): dg^T [C_in rounded up to 8][ldg]
// (the node tiles' rows + 8) and W and W_res [C_in rounded up to 8][ldw]
// (C_out rounded up to 16, + 8) in bf16, zero past C_in and C_out, so the
// pair dg[k][c], dg[k + 1][c] (and W[c][o], W[c][o + 1]) is one 32-bit load
// and, a row being 4 mod 8 words, a fragment load's 32 lanes hit 32 banks.
// Then, at byte offset `consts`, the window's BN-backward constants [6][co]
// (fp32: a, b, c of t and of r), and under "bfloat16" (raw_scratch) the
// block's t_mean and r_mean after them. `total` is in bytes.
struct DxSmem {
  int rows, lddg, ldwt, ldg, ldw, consts, total;
};
template <int D>
__host__ __device__ inline DxSmem dx_smem(int n, int ci, int co) {
  DxSmem s;
  s.rows = (n + 15) / 16 * 16;
  s.lddg = round8(ci) + 4;
  s.ldwt = round8(ci) + 8;
  s.ldg = s.rows + 8;
  s.ldw = (co + 15) / 16 * 16 + 8;
  s.consts = D == kFloat32 ? 4 * (s.rows * s.lddg + 2 * co * s.ldwt)
                           : 2 * round8(ci) * (s.ldg + 2 * s.ldw);
  s.total = s.consts + 4 * (raw_scratch<D> ? 8 : 6) * co;
  return s;
}

// ================= K2: forward =================

// Moments a = (count, mean t, M2 t, mean r, M2 r) <- with b's values added
// (b's entries `stride` floats apart), by Chan's formula: M2 = M2a + M2b +
// d^2 na nb / (na + nb), d the difference of the means. A count of 0 is
// an empty set.
__device__ __forceinline__ void merge_moments(float (&a)[kFwdMoments], const float* b,
                                              int stride) {
  const float na = a[0], nb = b[0];
  if (nb == 0.0f) return;
  const float f = nb / (na + nb);
#pragma unroll
  for (int q = 1; q < kFwdMoments; q += 2) {
    const float d = b[q * stride] - a[q];
    a[q] = fmaf(d, f, a[q]);
    a[q + 1] += b[(q + 1) * stride] + d * d * na * f;
  }
  a[0] = na + nb;
}

// Pass (a), one block per wb windows (pre_windows): g, t, r on the tensor
// cores (pre_graph, pre_window), t and r to scratch, and per-window channel
// moments part [B][4][co] = (sum t, M2 t, sum r, M2 r), M2 the sum of
// squared deviations from the window's own mean. The moments come from the
// accumulators, t and r never read back: each lane folds its values into
// (count, mean, M2) one at a time, then the 8 lanes of a column are merged
// in lane order and the node-tile groups in group order (merge_moments), so
// a channel whose spread is small against its mean keeps its digits and
// two launches give the same bits. Under a bf16 form on the bf16 mma, as
// bwd_pre (under "bfloat16" from graph's bf16 M^T, else M packed), t and r
// to scratch in form D's type.
template <int D>
__global__ void __launch_bounds__(kThreads, kFwdPreBlocks)
fwd_pre_kernel(const act_t<D>* __restrict__ x, Layer L, int n, int batch, int wb,
               scratch_t<D>* t_buf, scratch_t<D>* r_buf, float* part,
               const scratch_t<D>* __restrict__ graph) {
  constexpr bool kNative = D != kFloat32;
  extern __shared__ __align__(16) float smem[];
  const int co = L.co, tid = threadIdx.x, lane = tid & 31;
  const PreSmem sm = pre_smem(n, L.ci, co, wb, kFwdMoments);
  const PreBlock pb =
      pre_graph<D, kNative>(x, L, n, batch, wb, sm, smem, (float*)nullptr, graph_mt<D>(graph, n));
  const int cop = round8(co), groups = pre_groups(co);
  float* csum = smem + sm.csum;  // [groups][kFwdMoments][cop]
  float* wred = smem + sm.wred + (tid >> 5) * 32 * 2 * kFwdMoments;
  for (int w = 0; w < pb.nwin; ++w) {
    const int win = pb.win0 + w;
    const long long base = (long long)win * n * co;
    float m[2][kFwdMoments] = {};  // columns 2 (lane % 4) and + 1
    auto take = [&](int r0, int ot, const float (&t)[4], const float (&r)[4]) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = r0 + frag_row(i), o = 8 * ot + frag_col(i);
        if (rr >= n || o >= co) continue;
        const long long e = base + (long long)rr * co + o;
        put(t_buf + e, t[i]);
        put(r_buf + e, r[i]);
        const float one[kFwdMoments] = {1.0f, t[i], 0.0f, r[i], 0.0f};
        merge_moments(m[i & 1], one, 1);
      }
    };
    // The warp's moments of its 8 columns: one lane a column merges the 8
    // lanes that hold it (lanes 4 g + column / 2) in lane order.
    auto flush = [&](int ot, int grp) {
#pragma unroll
      for (int q = 0; q < 2 * kFwdMoments; ++q) wred[lane * 2 * kFwdMoments + q] = m[q / kFwdMoments][q % kFwdMoments];
      __syncwarp();
      if (lane < 8) {
        float c[kFwdMoments] = {};
        for (int g8 = 0; g8 < 8; ++g8)
          merge_moments(c, wred + ((g8 * 4 + lane / 2) * 2 + lane % 2) * kFwdMoments, 1);
#pragma unroll
        for (int q = 0; q < kFwdMoments; ++q) csum[(grp * kFwdMoments + q) * cop + 8 * ot + lane] = c[q];
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 2 * kFwdMoments; ++q) m[q / kFwdMoments][q % kFwdMoments] = 0.0f;
    };
    pre_window<D, kNative>(pb, L, n, w, [](int, int) {}, take, flush);
    __syncthreads();
    float* pw = part + (long long)win * 4 * co;
    for (int o = tid; o < co; o += kThreads) {
      float c[kFwdMoments] = {};
      for (int k = 0; k < groups; ++k) merge_moments(c, csum + k * kFwdMoments * cop + o, cop);
      pw[o] = c[1] * c[0];
      pw[co + o] = c[2];
      pw[2 * co + o] = c[3] * c[0];
      pw[3 * co + o] = c[4];
    }
    __syncthreads();  // csum serves the next window
  }
}

// Chan's combination of per-window moments over windows [w0, w0 + count):
// the block's mean and M2 of one channel (q = 0 for t, 2 for r).
__device__ void combine_moments(const float* __restrict__ part, long long w0, int count, int n,
                                int co, int q, int o, float* mean, float* m2) {
  float s = 0.0f;
  for (int w = 0; w < count; ++w) s += part[(w0 + w) * 4 * co + q * co + o];
  const float mu = s / ((float)count * (float)n);
  float acc = 0.0f;
  for (int w = 0; w < count; ++w) {
    const float* row = part + (w0 + w) * 4 * co;
    const float d = row[q * co + o] / (float)n - mu;
    acc += row[(q + 1) * co + o] + (float)n * d * d;
  }
  *mean = mu;
  *m2 = acc;
}

// Pass (b), one block per ghost block: stats[k][4][co] = (t_mean, t_inv_std,
// r_mean, r_inv_std), the biased variance M2 / cnt; an identity residual
// has (0, 1). Also the block's (sum, sum of squares) of t and r,
// block_sums[k][4][co], for the full-batch sums.
__global__ void __launch_bounds__(kThreads)
fwd_stats_kernel(const float* __restrict__ part, Layer L, int ghost, int n, float* stats,
                 float* block_sums) {
  const int co = L.co, k = blockIdx.x;
  const float cnt = (float)ghost * (float)n;
  float* st = stats + (long long)k * 4 * co;
  float* bs = block_sums + (long long)k * 4 * co;
  for (int j = threadIdx.x; j < 2 * co; j += kThreads) {
    const int q = j < co ? 0 : 2, o = j % co;
    float mean, m2;
    combine_moments(part, (long long)k * ghost, ghost, n, co, q, o, &mean, &m2);
    bs[q * co + o] = mean * cnt;
    bs[(q + 1) * co + o] = m2 + cnt * mean * mean;
    const bool fixed = q == 2 && L.identity;  // no BN on an identity residual
    st[q * co + o] = fixed ? 0.0f : mean;
    st[(q + 1) * co + o] = fixed ? 1.0f : rsqrtf(m2 / cnt + kEps);
  }
}

// Full-batch pre-BN sums [4][co] = (sum t, sum t^2, sum r, sum r^2), the
// ghost blocks' sums added up.
__global__ void __launch_bounds__(kThreads)
fwd_sums_kernel(const float* __restrict__ block_sums, int co, int n_blocks, float* sums) {
  for (int j = threadIdx.x; j < 4 * co; j += kThreads) {
    float total = 0.0f;
    for (int k = 0; k < n_blocks; ++k) total += block_sums[(long long)k * 4 * co + j];
    sums[j] = total;
  }
}

// BatchNorm of one value: the arithmetic fwd_apply and bwd_pre share.
__device__ __forceinline__ float bn(float v, float mean, float inv, float gamma, float beta) {
  return (v - mean) * inv * gamma + beta;
}

__device__ __forceinline__ float ghost_pre(const Layer& L, const float* st, int o, float t,
                                           float r) {
  const int co = L.co;
  return bn(t, st[o], st[co + o], L.gamma[o], L.beta[o]) +
         (L.identity ? r : bn(r, st[2 * co + o], st[3 * co + o], L.gamma_r[o], L.beta_r[o]));
}

// Pass (c), elementwise: y = PReLU(BN(t) + BN(r)) to the saved activation.
// A block takes kApplyElems consecutive elements of one ghost block's
// [ghost * N, C_out], four a load where vec (C_out a multiple of 4, the
// buffers aligned to four elements: 16 bytes of fp32, 8 of bf16), with the
// block's BN constants in shared memory, c [8][co] = (t_mean, t_inv_std,
// gamma, beta, r_mean, r_inv_std, gamma_res, beta_res). t, r and y are
// form D's (bf16 under "bfloat16").
constexpr int kApplyElems = 4 * 4 * kThreads;
template <int D>
__global__ void __launch_bounds__(kThreads)
fwd_apply_kernel(Layer L, int n, int ghost, int chunks, const scratch_t<D>* __restrict__ t_buf,
                 const scratch_t<D>* __restrict__ r_buf, act_t<D>* act, int vec) {
  extern __shared__ __align__(16) float cs[];
  const int co = L.co, k = blockIdx.x / chunks;
  const float* st = L.stats + (long long)k * 4 * co;
  for (int o = threadIdx.x; o < co; o += kThreads) {
    cs[o] = st[o];
    cs[co + o] = st[co + o];
    cs[2 * co + o] = L.gamma[o];
    cs[3 * co + o] = L.beta[o];
    cs[4 * co + o] = L.identity ? 0.0f : st[2 * co + o];
    cs[5 * co + o] = L.identity ? 1.0f : st[3 * co + o];
    cs[6 * co + o] = L.identity ? 1.0f : L.gamma_r[o];
    cs[7 * co + o] = L.identity ? 0.0f : L.beta_r[o];
  }
  __syncthreads();
  const float alpha = *L.alpha;
  const bool identity = L.identity;
  auto y_of = [&](int o, float t, float r) {
    const float pre = bn(t, cs[o], cs[co + o], cs[2 * co + o], cs[3 * co + o]) +
                      (identity ? r : bn(r, cs[4 * co + o], cs[5 * co + o], cs[6 * co + o],
                                         cs[7 * co + o]));
    return stored<D>(pre >= 0.0f ? pre : alpha * pre);
  };
  const long long per = (long long)ghost * n * co;
  const long long e0 = (long long)(blockIdx.x - k * chunks) * kApplyElems;
  const int end = per - e0 < kApplyElems ? (int)(per - e0) : kApplyElems;
  const scratch_t<D>* tb = t_buf + k * per + e0;
  const scratch_t<D>* rb = r_buf + k * per + e0;
  act_t<D>* yb = act + k * per + e0;
  // A thread's first element, its channel, and the channel step between its elements.
  const int first = vec ? 4 * threadIdx.x : threadIdx.x, stride = vec ? 4 * kThreads : kThreads;
  const int step = stride % co;
  int o = (int)((e0 + first) % co);
  for (int e = first; e < end; e += stride) {
    if (vec) {
      const float4 t = load4(tb + e), r = load4(rb + e);
      store4(yb + e, make_float4(y_of(o, t.x, r.x), y_of(o + 1, t.y, r.y),
                                 y_of(o + 2, t.z, r.z), y_of(o + 3, t.w, r.w)));
    } else {
      put(yb + e, y_of(o, to_f(tb[e]), to_f(rb[e])));
    }
    o += step;
    if (o >= co) o -= co;
  }
}

// The projector, z = y_flat wp + bp, as a product (the mirror of
// projector_dy_kernel below): block (split s, latent tile lt; window tile
// wt) owns z's windows [128 wt, 128 wt + 128) x latent columns [16 lt, 16 lt
// + 16) over the rows [s r_split, (s + 1) r_split) of wp, a warp 16 of the
// windows. y is the A operand, so warp_tile loads it (from device memory)
// a k-step ahead; wp, the B operand, is read by the block's 8 warps through
// L1, so from L2 once per 128 windows. Each split writes its partial sums
// to part [splits][batch][latent]; projector_sum_kernel adds them in split
// order, then bp. 3xTF32 under float32; under the bf16 forms the bf16 mma,
// wp's pairs packed (as projector_dy_kernel's) and y's, under "bfloat16"
// with rows even, one 32-bit load of the bf16 activation (r_split is a
// multiple of 8, so a pair never straddles a split or the row's end).
// Built for kZBlocks blocks an SM in every form, as many as the float32
// form's registers fit (it holds no shared memory).
constexpr int kZWindows = 16 * kWarps, kZBlocks = 5;
template <int D>
__global__ void __launch_bounds__(kThreads, kZBlocks)
projector_z_kernel(const act_t<D>* __restrict__ y, const float* __restrict__ wp, int batch,
                   int rows, int latent, int r_split, int splits, float* part) {
  const int s = blockIdx.x % splits, l0 = (blockIdx.x / splits) * 16;
  const int w0 = blockIdx.y * kZWindows + (threadIdx.x >> 5) * 16;
  const int k0 = s * r_split, k1 = rows - k0 < r_split ? rows : k0 + r_split;
  if (w0 >= batch) return;  // uniform over the warp; no block barrier follows
  auto y_of = [&](int w, int k) {
    return w < batch && k0 + k < k1 ? to_f(__ldg(y + (long long)w * rows + k0 + k)) : 0.0f;
  };
  auto wp_of = [&](int k, int l) {
    return l < latent && k0 + k < k1 ? __ldg(wp + (long long)(k0 + k) * latent + l) : 0.0f;
  };
  float acc[2][4] = {};
  const int K = k1 > k0 ? round8(k1 - k0) : 0, tiles = latent - l0 > 8 ? 2 : 1;
  if constexpr (D == kFloat32) {
    warp_tile<2>(acc, w0, K, l0, tiles, y_of, wp_of);
  } else if constexpr (D == kBfloat16) {
    if (rows % 2 == 0) {  // uniform over the grid
      auto y_pair = [&](int w, int k) -> uint32_t {
        return w < batch && k0 + k < k1
                   ? __ldg(reinterpret_cast<const unsigned int*>(y + (long long)w * rows + k0 + k))
                   : 0u;
      };
      warp_tile_bf16<2>(acc, w0, K, l0, tiles, y_pair, pairs_b(wp_of));
    } else {
      warp_tile_bf16<2>(acc, w0, K, l0, tiles, pairs_a(y_of), pairs_b(wp_of));
    }
  } else {
    warp_tile_bf16<2>(acc, w0, K, l0, tiles, pairs_a(y_of), pairs_b(wp_of));
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int w = w0 + frag_row(i), l = l0 + 8 * j + frag_col(i);
      if (w < batch && l < latent) part[((long long)s * batch + w) * latent + l] = acc[j][i];
    }
}

// z[w][l] = (sum over splits in split order of part[s][w][l]) + bp[l].
__global__ void __launch_bounds__(kThreads)
projector_sum_kernel(const float* __restrict__ part, int batch, int latent, int splits,
                     const float* __restrict__ bp, float* z) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long count = (long long)batch * latent;
  if (i >= count) return;
  float s = 0.0f;
  for (int k = 0; k < splits; ++k) s += part[k * count + i];
  z[i] = s + bp[i % latent];
}

// K4's projector backward, dy[w][i] = sum_l dz[w][l] wp[i][l] for the
// rows i < n * C_out of wp, into dy [batch][rows] (bwd_pre's dpre buffer,
// which bwd_pre reads it from and writes dpre over). A block owns 128 rows
// of wp (16 a warp) and 64 windows (8 column tiles), so wp is read once per
// 64 windows, not once per window. 3xTF32 under float32; under the bf16
// forms one m16n8k16 a 16-deep step (latent 16: one), its pairs packed from
// wp's and dz's fp32 values.
constexpr int kDyRows = 16 * kWarps, kDyWindows = 64;
template <int D>
__global__ void __launch_bounds__(kThreads)
projector_dy_kernel(const float* __restrict__ dz, const float* __restrict__ wp, int batch,
                    int rows, int latent, scratch_t<D>* dy) {
  const int warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * kDyRows + warp * 16, w0 = blockIdx.y * kDyWindows;
  const int wn = batch - w0 < kDyWindows ? batch - w0 : kDyWindows;
  auto wp_of = [&](int i, int l) {
    return i < rows && l < latent ? __ldg(wp + (long long)i * latent + l) : 0.0f;
  };
  auto dz_of = [&](int l, int w) {
    return l < latent && w < batch ? __ldg(dz + (long long)w * latent + l) : 0.0f;
  };
  float acc[kDyWindows / 8][4] = {};
  if constexpr (D == kFloat32)
    warp_tile<kDyWindows / 8>(acc, r0, round8(latent), w0, (wn + 7) / 8, wp_of, dz_of);
  else
    warp_tile_bf16<kDyWindows / 8>(acc, r0, round8(latent), w0, (wn + 7) / 8, pairs_a(wp_of),
                                   pairs_b(dz_of));
#pragma unroll
  for (int j = 0; j < kDyWindows / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + frag_row(i), w = w0 + 8 * j + frag_col(i);
      if (r < rows && w < batch) put(dy + (long long)w * rows + r, stored<D>(acc[j][i]));
    }
}

// Backward pass 1, one block per wb windows (pre_windows): recompute g, t, r
// and pre from the saved input and block statistics; dpre = PReLU'(pre) dy,
// with dy from the layer above (K3) or projector_dy_kernel (K4) in dpre_buf
// (under "bfloat16", where that buffer is bf16, dy is null for K4). Writes g, the centred tc = t - t_mean and rc = r -
// r_mean (under "bfloat16" t and r themselves, bf16 values: raw_scratch) and
// dpre to scratch (form D's), per-window sums [3][co] = (sum dpre, sum dpre
// tc, sum dpre rc) and the window's share of dalpha = sum over PReLU's
// negative branch of dy pre. Working from centred values keeps the digits
// of a channel whose spread is small against its mean (the TPU kernel's s2
// - mean s1 loses them).
// PReLU's branch is the forward's, read from the sign of its output y (for
// alpha >= 0; a negative slope gives both branches one sign, and then the
// branch is taken from the recomputed pre): a pre-activation within
// rounding of 0 could otherwise land on the other side in this rounding of
// the recomputation, and one such element moves dW and dM by more than the
// gradients' tolerance.
// g, t and r are fwd_pre's routine (pre_graph, pre_window, from the same
// operands: the forward's values, bit for bit), the PReLU backward and the
// column sums taken from the accumulators. x, y and dy are form D's
// activations (act_t); dy is read, and dpre written, as stored (under bf16,
// dpre = bf16(alpha dy) on the negative branch, alpha as it is).
template <int D>
__global__ void __launch_bounds__(kThreads, kPreBlocks)
bwd_pre_kernel(const act_t<D>* __restrict__ x, Layer L, int n, int ghost, int batch, int wb,
               const act_t<D>* __restrict__ y, const act_t<D>* dy, scratch_t<D>* g_buf,
               scratch_t<D>* t_buf, scratch_t<D>* r_buf, scratch_t<D>* dpre_buf, float* part,
               float* dalpha_part, const scratch_t<D>* __restrict__ graph) {
  constexpr bool kNative = D != kFloat32;
  extern __shared__ __align__(16) float smem[];
  const int co = L.co, tid = threadIdx.x, lane = tid & 31;
  const PreSmem sm = pre_smem(n, L.ci, co, wb, kBwdSums);
  const PreBlock pb =
      pre_graph<D, kNative>(x, L, n, batch, wb, sm, smem, g_buf, graph_mt<D>(graph, n));
  const int cop = round8(co), groups = pre_groups(co);
  float* csum = smem + sm.csum;  // [groups][kBwdSums][cop]
  float* wred = smem + sm.wred + (tid >> 5) * 32 * 2 * kBwdSums;
  float* red = smem + sm.red;
  const float alpha = *L.alpha;
  for (int w = 0; w < pb.nwin; ++w) {
    const int win = pb.win0 + w;
    const float* st = L.stats + (long long)(win / ghost) * 4 * co;
    const long long base = (long long)win * n * co;
    float dal = 0.0f, yv[4], dyv[4];
    float s[2 * kBwdSums] = {};  // (sum dpre, dpre tc, dpre rc) of columns 2 (lane % 4) and + 1
    auto fetch = [&](int r0, int ot) {  // issued first: their latency runs under the products
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + frag_row(i), o = 8 * ot + frag_col(i);
        const long long e = base + (long long)r * co + o;
        const bool in = r < n && o < co;
        yv[i] = in ? to_f(y[e]) : 0.0f;
        if constexpr (raw_scratch<D>)
          dyv[i] = !in ? 0.0f : to_f(dy != nullptr ? dy[e] : dpre_buf[e]);
        else
          dyv[i] = in ? stored<D>(dy[e]) : 0.0f;
      }
    };
    auto take = [&](int r0, int ot, const float (&t)[4], const float (&rv)[4]) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + frag_row(i), o = 8 * ot + frag_col(i);
        if (r >= n || o >= co) continue;
        const float tc = t[i] - st[o];
        const float rc = rv[i] - st[2 * co + o];  // an identity residual has mean 0: rc = x
        const float pre = ghost_pre(L, st, o, t[i], rv[i]);
        const long long e = base + (long long)r * co + o;
        const bool neg = alpha >= 0.0f ? (__float_as_uint(yv[i]) >> 31) != 0 : pre < 0.0f;
        const float g_out = dyv[i];
        if (neg) dal = fmaf(g_out, pre, dal);
        const float dp = stored<D>(neg ? alpha * g_out : g_out);
        put(t_buf + e, raw_scratch<D> ? t[i] : tc);
        put(r_buf + e, raw_scratch<D> ? rv[i] : rc);
        put(dpre_buf + e, dp);
        float* sc = s + kBwdSums * (i & 1);
        sc[0] += dp;
        sc[1] = fmaf(dp, tc, sc[1]);
        sc[2] = fmaf(dp, rc, sc[2]);
      }
    };
    // The warp's share of its 8 columns: the 8 lanes of a column in lane order.
    auto flush = [&](int ot, int grp) {
#pragma unroll
      for (int q = 0; q < 2 * kBwdSums; ++q) wred[lane * 2 * kBwdSums + q] = s[q];
      __syncwarp();
      if (lane < 4)
        for (int q = 0; q < 2 * kBwdSums; ++q) {
          float v = 0.0f;
          for (int g8 = 0; g8 < 8; ++g8) v += wred[(g8 * 4 + lane) * 2 * kBwdSums + q];
          csum[(grp * kBwdSums + q % kBwdSums) * cop + 8 * ot + 2 * lane + q / kBwdSums] = v;
        }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 2 * kBwdSums; ++q) s[q] = 0.0f;
    };
    pre_window<D, kNative>(pb, L, n, w, fetch, take, flush);
    red[tid] = dal;
    __syncthreads();
    block_reduce(red, 1);
    if (tid == 0) dalpha_part[win] = red[0];
    float* pw = part + (long long)win * kBwdSums * co;
    for (int j = tid; j < kBwdSums * co; j += kThreads) {
      const int q = j / co, o = j - q * co;
      float v = 0.0f;
      for (int k = 0; k < groups; ++k) v += csum[(k * kBwdSums + q) * cop + o];
      pw[j] = v;
    }
    __syncthreads();  // csum and red serve the next window
  }
}

// Backward pass 4, one block per window: dt = a dpre + b tc + c (written over
// tc; under "bfloat16" over t, tc = t - t_mean), as the A operand of dg = dt
// W^T (to scratch, for dM, and to shared memory), then, unless dx is null,
// dr likewise (over rc or r; an
// identity residual has dr = dpre) as the A operand of dr W_res^T, which
// adds to dx = M dg. Without dx (layer 0) dr is written by a plain loop. dt
// and dr never sit in shared memory: a loader computes each element from
// dpre and t (r) once and writes it back, and later column chunks (C_in >
// 32) read it again. dg and dx are stored (dx in form D's activation type,
// act_t). Under float32 the products are
// 3xTF32 from fp32 shared memory and M^T; under the bf16 forms they run on
// the bf16 mma: dt and dr computed a pair at a time (one 32-bit load of t,
// r and dpre each and one store back where the scratch is bf16), W, W_res
// and dg^T as bf16 pairs in shared memory, M's pairs one 32-bit load of the
// bf16 graph operand (graph_operand_kernel; packed from M^T under
// "bfloat16_f32store").
template <int D>
__global__ void __launch_bounds__(kThreads, kDxBlocks)
bwd_dx_kernel(Layer L, int n, int ghost, const float* __restrict__ consts,
              scratch_t<D>* t_buf, scratch_t<D>* r_buf,
              const scratch_t<D>* __restrict__ dpre_buf, scratch_t<D>* dg_buf,
              const scratch_t<D>* __restrict__ mt, act_t<D>* dx) {
  using S = scratch_t<D>;
  extern __shared__ __align__(16) float smem[];
  const int ci = L.ci, co = L.co, tid = threadIdx.x, warp = tid >> 5, win = blockIdx.x;
  const DxSmem sm = dx_smem<D>(n, ci, co);
  const int rows = sm.rows, ci8 = round8(ci);
  float* cs = reinterpret_cast<float*>(reinterpret_cast<char*>(smem) + sm.consts);
  const float* csg = consts + (long long)(win / ghost) * 6 * co;
  for (int i = tid; i < 6 * co; i += kThreads) cs[i] = csg[i];
  if constexpr (raw_scratch<D>) {
    const float* st = L.stats + (long long)(win / ghost) * 4 * co;  // the block's means
    for (int o = tid; o < co; o += kThreads) {
      cs[6 * co + o] = st[o];
      cs[7 * co + o] = st[2 * co + o];  // 0 for an identity residual
    }
  }
  // fp32 (float32): W^T, W_res^T [co][ldwt] after dg [rows][lddg]
  float* dgs = smem;
  float* wts = dgs + rows * sm.lddg;
  float* wrts = wts + co * sm.ldwt;
  // bf16 pairs (bf16 forms): dg^T [ci8][ldg], W, W_res [ci8][ldw]
  __nv_bfloat16* dgt = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wb = dgt + ci8 * sm.ldg;
  __nv_bfloat16* wrb = wb + ci8 * sm.ldw;
  if constexpr (D == kFloat32) {
    for (int i = tid; i < co * sm.ldwt; i += kThreads) {
      const int o = i / sm.ldwt, c = i - o * sm.ldwt;
      wts[i] = c < ci ? L.w[c * co + o] : 0.0f;
      wrts[i] = c < ci && !L.identity ? L.wr[c * co + o] : 0.0f;
    }
  } else {
    for (int i = tid; i < ci8 * sm.ldw; i += kThreads) {
      const int c = i / sm.ldw, o = i - c * sm.ldw;
      const bool in = c < ci && o < co;
      put(wb + i, in ? L.w[c * co + o] : 0.0f);
      put(wrb + i, in && !L.identity ? L.wr[c * co + o] : 0.0f);
    }
  }
  __syncthreads();
  const long long base = (long long)win * n * co;
  const int ctiles = ci8 / 8;
  // d_raw = a dpre + b (raw - mean) + c of t (q = 0) or r (q = 1) at element e,
  // channel o; the scratch holds raw - mean unless raw_scratch
  auto d_of = [&](int q, long long e, int o, const S* raw) {
    float centred = to_f(raw[e]);
    if constexpr (raw_scratch<D>) centred -= cs[(6 + q) * co + o];
    return fmaf(cs[3 * q * co + o], to_f(dpre_buf[e]),
                fmaf(cs[(3 * q + 1) * co + o], centred, cs[(3 * q + 2) * co + o]));
  };
  // The bf16 pair (d_raw at channels o, o + 1 of node r) of t (q = 0) or r:
  // computed and written over raw in the first column chunk, read back after.
  auto d_pair = [&](int q, S* raw, int r, int o, bool first) -> uint32_t {
    if (r >= n || o >= co) return 0u;
    const long long e = base + (long long)r * co + o;
    const bool two = o + 1 < co;
    if constexpr (D == kBfloat16) {
      const bool word = two && (e & 1) == 0;  // both in one aligned 32-bit word
      if (!first)
        return word ? *reinterpret_cast<const uint32_t*>(raw + e)
                    : bf16_pair(raw[e], two ? raw[e + 1] : __float2bfloat16(0.0f));
      const uint32_t pr = pack_bf16x2(d_of(q, e, o, raw), two ? d_of(q, e + 1, o + 1, raw) : 0.0f);
      if (word) {
        *reinterpret_cast<uint32_t*>(raw + e) = pr;
      } else {
        *reinterpret_cast<unsigned short*>(raw + e) = (unsigned short)(pr & 0xFFFFu);
        if (two) *reinterpret_cast<unsigned short*>(raw + e + 1) = (unsigned short)(pr >> 16);
      }
      return pr;
    } else {
      if (!first) return pack_bf16x2(to_f(raw[e]), two ? to_f(raw[e + 1]) : 0.0f);
      const float v0 = d_of(q, e, o, raw), v1 = two ? d_of(q, e + 1, o + 1, raw) : 0.0f;
      raw[e] = v0;
      if (two) raw[e + 1] = v1;
      return pack_bf16x2(v0, v1);
    }
  };
  auto word_at = [](const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); };
  for (int r0 = warp * 16; r0 < rows; r0 += kWarps * 16)
    for (int c0 = 0; c0 < ctiles; c0 += 4) {
      const int tiles = ctiles - c0 < 4 ? ctiles - c0 : 4;
      float acc[4][4] = {};
      if constexpr (D == kFloat32) {
        auto dt_of = [&](int r, int o) {
          if (r >= n || o >= co) return 0.0f;
          const long long e = base + (long long)r * co + o;
          if (c0 > 0) return t_buf[e];  // this lane wrote dt there in the first chunk
          const float v = d_of(0, e, o, t_buf);
          t_buf[e] = v;
          return v;
        };
        auto wt_of = [&](int o, int c) { return o < co ? wts[o * sm.ldwt + c] : 0.0f; };
        warp_tile<4>(acc, r0, round8(co), 8 * c0, tiles, dt_of, wt_of);
      } else {
        auto dt_pair = [&](int r, int o) { return d_pair(0, t_buf, r, o, c0 == 0); };
        auto w_pair = [&](int o, int c) { return word_at(wb + c * sm.ldw + o); };
        warp_tile_bf16<4>(acc, r0, round8(co), 8 * c0, tiles, dt_pair, w_pair);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c0 + j >= ctiles) break;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + frag_row(i), c = 8 * (c0 + j) + frag_col(i);
          const float dg = stored<D>(acc[j][i]);
          if constexpr (D == kFloat32)
            dgs[r * sm.lddg + c] = dg;
          else
            put(dgt + c * sm.ldg + r, dg);
          if (r < n && c < ci) put(dg_buf + ((long long)win * n + r) * ci + c, dg);
        }
      }
    }
  if (dx == nullptr) {  // uniform over the block
    if (!L.identity)
      for (int i = tid; i < n * co; i += kThreads) {
        const long long e = base + i;
        put(r_buf + e, d_of(1, e, i % co, r_buf));
      }
    return;
  }
  __syncthreads();
  for (int r0 = warp * 16; r0 < rows; r0 += kWarps * 16)
    for (int c0 = 0; c0 < ctiles; c0 += 4) {
      const int tiles = ctiles - c0 < 4 ? ctiles - c0 : 4;
      float acc[4][4] = {};
      if constexpr (D == kFloat32) {
        auto m_of = [&](int r, int k) {
          return r < n && k < n ? __ldg(mt + (long long)k * n + r) : 0.0f;
        };
        auto dg_of = [&](int k, int c) { return dgs[k * sm.lddg + c]; };
        auto wrt_of = [&](int o, int c) { return o < co ? wrts[o * sm.ldwt + c] : 0.0f; };
        auto dr_of = [&](int r, int o) {
          if (r >= n || o >= co) return 0.0f;
          const long long e = base + (long long)r * co + o;
          if (c0 > 0) return r_buf[e];
          const float v = d_of(1, e, o, r_buf);
          r_buf[e] = v;
          return v;
        };
        warp_tile<4>(acc, r0, round8(n), 8 * c0, tiles, m_of, dg_of);  // M dg
        if (!L.identity) warp_tile<4>(acc, r0, round8(co), 8 * c0, tiles, dr_of, wrt_of);
      } else {
        auto m_pair = [&](int r, int k) -> uint32_t {
          if (r >= n) return 0u;
          if constexpr (D == kBfloat16) {
            return word_at(mt + (long long)r * graph_ld<D>(n) + k);
          } else {
            const float lo = k < n ? __ldg(mt + (long long)k * n + r) : 0.0f;
            const float hi = k + 1 < n ? __ldg(mt + (long long)(k + 1) * n + r) : 0.0f;
            return pack_bf16x2(lo, hi);
          }
        };
        auto dg_pair = [&](int k, int c) { return word_at(dgt + c * sm.ldg + k); };
        auto dr_pair = [&](int r, int o) { return d_pair(1, r_buf, r, o, c0 == 0); };
        auto wr_pair = [&](int o, int c) { return word_at(wrb + c * sm.ldw + o); };
        warp_tile_bf16<4>(acc, r0, round8(n), 8 * c0, tiles, m_pair, dg_pair);  // M dg
        if (!L.identity) warp_tile_bf16<4>(acc, r0, round8(co), 8 * c0, tiles, dr_pair, wr_pair);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c0 + j >= ctiles) break;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + frag_row(i), c = 8 * (c0 + j) + frag_col(i);
          if (r >= n || c >= ci) continue;
          float v = acc[j][i];
          if (L.identity) v += to_f(dpre_buf[base + (long long)r * co + c]);
          put(dx + ((long long)win * n + r) * ci + c, stored<D>(v));
        }
      }
    }
}

int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

cudaError_t allow_smem(const void* kernel, long long bytes) {
  if (bytes > 232448) return cudaErrorInvalidValue;  // 227 KB, the most a block may use
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// One product: A and B, the output's P x Q, the reduction's n (rows, or
// windows of k channels). See the product kernels above.
struct Product {
  int form;  // ProductForm
  const void* a;
  const void* b;
  int p, q;
  long long n;
  int k;
  int a_bf16, b_bf16;  // whether A, B hold bf16 (else fp32) values
};

bool aligned(const void* p, int bytes) { return (reinterpret_cast<uintptr_t>(p) % bytes) == 0; }

// Elements of T a staging copy moves for rows of stride ld (elements) from
// base: 16 bytes where the stride and base allow it, else 4, else one bf16
// element (a plain copy).
template <class T>
int copy_elems(const void* base, long long ld) {
  constexpr int e16 = 16 / (int)sizeof(T), e4 = 4 / (int)sizeof(T);
  if (ld % e16 == 0 && aligned(base, 16)) return e16;
  if (ld % e4 == 0 && aligned(base, 4)) return e4;
  return 1;
}

template <int OP, class TA, class TB, int MT, int NT>
cudaError_t launch_rows(const Product& pr, int splits, float* dst, cudaStream_t stream) {
  constexpr int PT = 16 * MT, QT = 8 * NT;
  const long long slabs = (long long)kWarps * kStages * kRowsStep *
                          (rows_ld<OP, TA>(PT) * (long long)sizeof(TA) +
                           rows_ld<OP, TB>(QT) * (long long)sizeof(TB));
  const long long red = (long long)sizeof(float) * kWarps * MT * NT * 4 * 32;
  const long long smem = slabs > red ? slabs : red;
  long long r_split = (pr.n + splits - 1) / splits;
  r_split = (r_split + kRowsStep - 1) / kRowsStep * kRowsStep;
  auto kern = product_rows_kernel<OP, TA, TB, MT, NT>;
  cudaError_t err = allow_smem((const void*)kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((pr.p + PT - 1) / PT) * ((pr.q + QT - 1) / QT), splits);
  kern<<<grid, kThreads, (size_t)smem, stream>>>(
      static_cast<const TA*>(pr.a), static_cast<const TB*>(pr.b), pr.p, pr.q, pr.n, r_split, dst,
      copy_elems<TA>(pr.a, pr.p), copy_elems<TB>(pr.b, pr.q));
  return cudaGetLastError();
}

template <int OP, class TA, class TB>
cudaError_t launch_windows(const Product& pr, int splits, float* dst, cudaStream_t stream) {
  constexpr int PT = 16 * kWinMT, QT = 8 * kWinNT;
  const long long slabs = (long long)kWarps * kStages * windows_ld<OP>() *
                          (PT * (long long)sizeof(TA) + QT * (long long)sizeof(TB));
  const long long red = (long long)sizeof(float) * kWarps * kWinMT * kWinNT * 4 * 32;
  const long long smem = slabs > red ? slabs : red;
  const int w_split = (int)((pr.n + splits - 1) / splits);
  auto kern = product_windows_kernel<OP, TA, TB>;
  cudaError_t err = allow_smem((const void*)kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((pr.p + PT - 1) / PT) * ((pr.q + QT - 1) / QT), splits);
  kern<<<grid, kThreads, (size_t)smem, stream>>>(
      static_cast<const TA*>(pr.a), static_cast<const TB*>(pr.b), pr.p, pr.q, (int)pr.n, pr.k,
      w_split, dst, copy_elems<TA>(pr.a, pr.k), copy_elems<TB>(pr.b, pr.k));
  return cudaGetLastError();
}

// The rows form's tile: 16, 32 or 64 of P by 16, 32 or 64 of Q, the least
// that holds the output (dW, dW_res: one tile), else 64 (dwp: 216 tiles of
// 64 x 16). stse_train.py's product_splits mirrors this choice.
template <int OP, class TA, class TB>
cudaError_t launch_typed(const Product& pr, int splits, float* dst, cudaStream_t stream) {
  if (pr.form == PF_WINDOWS) return launch_windows<OP, TA, TB>(pr, splits, dst, stream);
  const int mt = pr.p <= 16 ? 1 : (pr.p <= 32 ? 2 : 4);
  const int nt = pr.q <= 16 ? 2 : (pr.q <= 32 ? 4 : 8);
  switch (mt * 10 + nt) {
    case 12: return launch_rows<OP, TA, TB, 1, 2>(pr, splits, dst, stream);
    case 14: return launch_rows<OP, TA, TB, 1, 4>(pr, splits, dst, stream);
    case 18: return launch_rows<OP, TA, TB, 1, 8>(pr, splits, dst, stream);
    case 22: return launch_rows<OP, TA, TB, 2, 2>(pr, splits, dst, stream);
    case 24: return launch_rows<OP, TA, TB, 2, 4>(pr, splits, dst, stream);
    case 28: return launch_rows<OP, TA, TB, 2, 8>(pr, splits, dst, stream);
    case 42: return launch_rows<OP, TA, TB, 4, 2>(pr, splits, dst, stream);
    case 44: return launch_rows<OP, TA, TB, 4, 4>(pr, splits, dst, stream);
    default: return launch_rows<OP, TA, TB, 4, 8>(pr, splits, dst, stream);
  }
}

// By the operands' types: fp32 and fp32 for 3xTF32; any of fp32 and bf16
// for the bf16 mma.
template <int OP>
cudaError_t launch_product(const Product& pr, int splits, float* dst, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  if constexpr (OP == kOpF32) {
    if (pr.a_bf16 || pr.b_bf16) return cudaErrorInvalidValue;
    return launch_typed<OP, float, float>(pr, splits, dst, stream);
  } else {
    switch (2 * (pr.a_bf16 != 0) + (pr.b_bf16 != 0)) {
      case 0: return launch_typed<OP, float, float>(pr, splits, dst, stream);
      case 1: return launch_typed<OP, float, bf16>(pr, splits, dst, stream);
      case 2: return launch_typed<OP, bf16, float>(pr, splits, dst, stream);
      default: return launch_typed<OP, bf16, bf16>(pr, splits, dst, stream);
    }
  }
}

// The product into out [P][Q]: straight there for one split, else through
// [splits][P][Q] partials in part, summed in split order.
template <int D>
cudaError_t run_product(const Product& pr, int splits, float* part, float* out,
                        cudaStream_t stream) {
  if (splits < 1 || splits > 65535 || pr.n < 1 || pr.k < 1 || (splits > 1 && part == nullptr) ||
      (pr.form == PF_WINDOWS && pr.n >= (1LL << 31)))
    return cudaErrorInvalidValue;
  cudaError_t err = launch_product<op_of<D>>(pr, splits, splits > 1 ? part : out, stream);
  if (err != cudaSuccess || splits == 1) return err;
  const long long count = (long long)pr.p * pr.q;
  sum_splits_kernel<<<blocks_for(count), kThreads, 0, stream>>>(part, count, splits, out);
  return cudaGetLastError();
}

// The operands of a forward (or mono) layer row; the caller sets stats.
Layer row_layer(const long long* r) {
  Layer L;
  L.ci = (int)r[FL_CI];
  L.co = (int)r[FL_CO];
  L.identity = (int)r[FL_IDENTITY];
  L.m = ptr<const float>(r, FL_M);
  L.w = ptr<const float>(r, FL_W);
  L.b = ptr<const float>(r, FL_B);
  L.gamma = ptr<const float>(r, FL_GAMMA);
  L.beta = ptr<const float>(r, FL_BETA);
  L.wr = ptr<const float>(r, FL_W_RES);
  L.br = ptr<const float>(r, FL_B_RES);
  L.gamma_r = ptr<const float>(r, FL_GAMMA_RES);
  L.beta_r = ptr<const float>(r, FL_BETA_RES);
  L.alpha = ptr<const float>(r, FL_ALPHA);
  L.stats = nullptr;
  return L;
}

// Dynamic shared memory of a layer's fwd_pre, fwd_apply, bwd_pre and
// bwd_dx blocks, in bytes.
struct LayerSmem {
  long long fwd, apply, pre, dx;
};
template <int D>
LayerSmem layer_smem(const Layer& L, int n) {
  const int wb = pre_windows(L.ci);
  return {(long long)sizeof(float) * pre_smem(n, L.ci, L.co, wb, kFwdMoments).total,
          (long long)sizeof(float) * 8 * L.co,
          (long long)sizeof(float) * pre_smem(n, L.ci, L.co, wb, kBwdSums).total,
          (long long)dx_smem<D>(n, L.ci, L.co).total};
}

// Checks n_layers descriptor rows (`stride` fields apart; the forward's
// and K5's rows start alike) and returns, in most, each pass's largest
// shared memory over them in form D.
template <int D>
cudaError_t check_layers(const long long* rows, int stride, int n_layers, int n,
                         LayerSmem* most) {
  *most = {0, 0, 0, 0};
  for (int l = 0; l < n_layers; ++l) {
    const Layer L = row_layer(rows + (long long)l * stride);
    if (L.ci < 1 || L.co < 1 || (L.identity && L.ci != L.co) ||
        (l > 0 && L.ci != rows[(long long)(l - 1) * stride + FL_CO]))
      return cudaErrorInvalidValue;
    const LayerSmem s = layer_smem<D>(L, n);
    most->fwd = s.fwd > most->fwd ? s.fwd : most->fwd;
    most->apply = s.apply > most->apply ? s.apply : most->apply;
    most->pre = s.pre > most->pre ? s.pre : most->pre;
    most->dx = s.dx > most->dx ? s.dx : most->dx;
  }
  return cudaSuccess;
}

// Opt form D's per-window passes into the shared memory `most` gives them (a
// pass given 0 is left as it is: the launch at hand does not run it).
template <int D>
cudaError_t allow_passes(const LayerSmem& most) {
  const void* kernels[4] = {(const void*)fwd_pre_kernel<D>, (const void*)fwd_apply_kernel<D>,
                            (const void*)bwd_pre_kernel<D>, (const void*)bwd_dx_kernel<D>};
  const long long bytes[4] = {most.fwd, most.apply, most.pre, most.dx};
  cudaError_t err = cudaSuccess;
  for (int k = 0; k < 4 && err == cudaSuccess; ++k)
    if (bytes[k] > 0) err = allow_smem(kernels[k], bytes[k]);
  return err;
}

// fn(std::integral_constant<int, D>) for the compute dtype `dtype` names
// (ComputeDtype), or cudaErrorInvalidValue.
template <class Fn>
int with_dtype(long long dtype, const Fn& fn) {
  switch (dtype) {
    case kFloat32: return fn(std::integral_constant<int, kFloat32>{});
    case kBfloat16: return fn(std::integral_constant<int, kBfloat16>{});
    case kBfloat16F32Store: return fn(std::integral_constant<int, kBfloat16F32Store>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// One layer of K2's forward on windows [0, batch) of the buffers (a
// chunk's, for K5): fwd_pre, fwd_stats into stats and block_sums, the
// full-batch sums unless sums is null, then fwd_apply into act. graph is
// the layer's graph operand (graph_operand_kernel; read under "bfloat16").
template <int D>
cudaError_t run_forward_layer(const act_t<D>* x, const Layer& L, int n, int ghost, int batch,
                              scratch_t<D>* t_buf, scratch_t<D>* r_buf, float* part,
                              float* stats, float* block_sums, float* sums, act_t<D>* act,
                              const scratch_t<D>* graph, cudaStream_t stream) {
  const LayerSmem smem = layer_smem<D>(L, n);
  const int wb = pre_windows(L.ci), n_blocks = batch / ghost;
  auto pre = fwd_pre_kernel<D>;
  pre<<<(batch + wb - 1) / wb, kThreads, (size_t)smem.fwd, stream>>>(x, L, n, batch, wb, t_buf,
                                                                     r_buf, part, graph);
  fwd_stats_kernel<<<n_blocks, kThreads, 0, stream>>>(part, L, ghost, n, stats, block_sums);
  if (sums != nullptr)
    fwd_sums_kernel<<<1, kThreads, 0, stream>>>(block_sums, L.co, n_blocks, sums);
  const long long per = (long long)ghost * n * L.co;
  const int chunks = (int)((per + kApplyElems - 1) / kApplyElems);
  constexpr int four = 4 * (int)sizeof(scratch_t<D>);  // bytes of four elements
  const int vec =
      L.co % 4 == 0 && aligned(t_buf, four) && aligned(r_buf, four) && aligned(act, four);
  auto apply = fwd_apply_kernel<D>;
  apply<<<n_blocks * chunks, kThreads, (size_t)smem.apply, stream>>>(L, n, ghost, chunks, t_buf,
                                                                     r_buf, act, vec);
  return cudaGetLastError();
}

// K2's projector on the top layer's output y [batch][rows]: projector_z
// into part ([splits][batch][latent] floats), then projector_sum into z.
template <int D>
cudaError_t run_projector(const act_t<D>* y, const float* wp, const float* bp, int batch, int rows,
                          int latent, int splits, float* part, float* z, cudaStream_t stream) {
  const int r_split = round8((rows + splits - 1) / splits);
  const dim3 grid_z(splits * ((latent + 15) / 16), (batch + kZWindows - 1) / kZWindows);
  auto proj = projector_z_kernel<D>;
  proj<<<grid_z, kThreads, 0, stream>>>(y, wp, batch, rows, latent, r_split, splits, part);
  projector_sum_kernel<<<blocks_for((long long)batch * latent), kThreads, 0, stream>>>(
      part, batch, latent, splits, bp, z);
  return cudaGetLastError();
}

// The per-window passes of one layer's backward on windows [0, batch) of
// the buffers (a chunk's, for K5): bwd_pre (after K4's projector_dy_kernel,
// whose dy it reads from dpre_buf), bwd_consts, then bwd_dx. `y` is the
// layer's output; dy, for K3, the layer above's dx; dz and wp, for K4. The
// activations (x, y, dy, dx) are form D's act_t, the per-window scratch its
// scratch_t.
template <int D>
struct PassArgs {
  using S = scratch_t<D>;
  using A = act_t<D>;
  const A *x, *y, *dy;
  const float *dz, *wp;
  const S* mt;
  int batch, n, ghost, latent;
  S *g_buf, *t_buf, *r_buf, *dpre_buf, *dg_buf;
  float *part, *dalpha_part, *consts, *gpart;
  A* dx;
};
template <int D>
cudaError_t run_passes(const Layer& L, const PassArgs<D>& a, const LayerSmem& smem,
                       cudaStream_t stream) {
  const act_t<D>* dy = a.dy;
  if (a.dz != nullptr) {
    const int rows = a.n * L.co;
    const dim3 grid_dy((rows + kDyRows - 1) / kDyRows, (a.batch + kDyWindows - 1) / kDyWindows);
    auto proj_dy = projector_dy_kernel<D>;
    proj_dy<<<grid_dy, kThreads, 0, stream>>>(a.dz, a.wp, a.batch, rows, a.latent, a.dpre_buf);
    if constexpr (raw_scratch<D>)
      dy = nullptr;  // bf16 in dpre_buf: bwd_pre reads it there
    else
      dy = a.dpre_buf;
  }
  const int wb = pre_windows(L.ci);
  auto pre = bwd_pre_kernel<D>;
  pre<<<(a.batch + wb - 1) / wb, kThreads, (size_t)smem.pre, stream>>>(
      a.x, L, a.n, a.ghost, a.batch, wb, a.y, dy, a.g_buf, a.t_buf, a.r_buf, a.dpre_buf, a.part,
      a.dalpha_part, a.mt);
  bwd_consts_kernel<<<a.batch / a.ghost, kThreads, 0, stream>>>(a.part, L, a.ghost, a.n, a.consts,
                                                                a.gpart);
  auto dx = bwd_dx_kernel<D>;
  dx<<<a.batch, kThreads, (size_t)smem.dx, stream>>>(L, a.n, a.ghost, a.consts, a.t_buf, a.r_buf,
                                                     a.dpre_buf, a.dg_buf, a.mt, a.dx);
  return cudaGetLastError();
}

// K5, one chunk of windows [w0, w0 + wc) on `stream`: the forward again
// into its workspace slot (`slot` bytes past slot 0: each layer's output and
// block statistics), then the backward sweep, top layer down, leaving the
// chunk's share of every batch reduction in the [n_chunks, ...] buffers
// (index c) and the per-window / per-block buffers (offset by w0). It
// writes nothing another chunk writes or reads.
template <int D>
cudaError_t mono_chunk(const long long* d, int c, int w0, int wc, long long slot,
                       cudaStream_t stream) {
  using S = scratch_t<D>;
  using A = act_t<D>;
  constexpr int sb = D == kBfloat16;  // the products' scratch and activation operands: bf16
  const int n_layers = (int)d[MH_N_LAYERS], n = (int)d[MH_N_NODES], ghost = (int)d[MH_GHOST];
  const int latent = (int)d[MH_LATENT];
  S* t_buf = in_slot<S>(d, MH_T_BUF, slot);  // K2's passes, then the backward's
  S* r_buf = in_slot<S>(d, MH_R_BUF, slot);
  S* dpre_buf = in_slot<S>(d, MH_DPRE_BUF, slot);
  S* g_buf = in_slot<S>(d, MH_G_BUF, slot);
  S* dg_buf = in_slot<S>(d, MH_DG_BUF, slot);
  A* dy_buf = in_slot<A>(d, MH_DY_BUF, slot);
  float* part = in_slot<float>(d, MH_PART, slot);
  float* consts = in_slot<float>(d, MH_CONSTS, slot);
  float* prod_buf = in_slot<float>(d, MH_PROD_BUF, slot);
  const long long* rows = d + MH_COUNT;
  const A* x_c = ptr<const A>(d, MH_X) + (long long)w0 * n * rows[ML_CI];
  const float* dz_c = ptr<const float>(d, MH_DZ) + (long long)w0 * latent;

  const A* h = x_c;
  cudaError_t err = cudaSuccess;
  for (int l = 0; l < n_layers && err == cudaSuccess; ++l) {
    const long long* row = rows + (long long)l * ML_COUNT;
    Layer L = row_layer(row);
    float* stats = in_slot<float>(row, ML_STATS, slot);
    L.stats = stats;
    A* act = in_slot<A>(row, ML_ACT, slot);
    err = run_forward_layer<D>(h, L, n, ghost, wc, t_buf, r_buf, part, stats,
                               in_slot<float>(d, MH_BLOCK_SUMS, slot), nullptr, act,
                               ptr<const S>(row, ML_MT), stream);
    h = act;
  }
  for (int l = n_layers - 1; l >= 0 && err == cudaSuccess; --l) {
    const long long* row = rows + (long long)l * ML_COUNT;
    Layer L = row_layer(row);
    L.stats = in_slot<const float>(row, ML_STATS, slot);
    const int ci = L.ci, co = L.co;
    const bool top = l == n_layers - 1;
    const A* x_l = l == 0 ? x_c : in_slot<const A>(row - ML_COUNT, ML_ACT, slot);
    PassArgs<D> pa;
    pa.x = x_l;
    pa.y = in_slot<const A>(row, ML_ACT, slot);
    pa.dy = top ? nullptr : dy_buf;
    pa.dz = top ? dz_c : nullptr;
    pa.wp = ptr<const float>(d, MH_WP);
    pa.mt = ptr<const S>(row, ML_MT);
    pa.batch = wc;
    pa.n = n;
    pa.ghost = ghost;
    pa.latent = latent;
    pa.g_buf = g_buf;
    pa.t_buf = t_buf;
    pa.r_buf = r_buf;
    pa.dpre_buf = dpre_buf;
    pa.dg_buf = dg_buf;
    pa.part = part;
    pa.dalpha_part = ptr<float>(row, ML_DALPHA_PART) + w0;
    pa.consts = consts;
    pa.gpart = ptr<float>(row, ML_GPART) + (long long)(w0 / ghost) * 6 * co;
    pa.dx = l > 0 ? dy_buf : nullptr;
    err = run_passes<D>(L, pa, layer_smem<D>(L, n), stream);
    // dW = sum g^T dt, dW_res = sum x^T dr, dM = sum x^T dg over the chunk.
    const long long wsz = (long long)ci * co;
    const long long n_rows = (long long)wc * n;
    Product pw{PF_ROWS, g_buf, pa.t_buf, ci, co, n_rows, 1, sb, sb};
    if (err == cudaSuccess)
      err = run_product<D>(pw, (int)row[ML_SPLITS_W], prod_buf,
                           ptr<float>(row, ML_CHUNK_DW) + c * wsz, stream);
    if (err == cudaSuccess && !L.identity) {
      Product pr{PF_ROWS, x_l, pa.r_buf, ci, co, n_rows, 1, sb, sb};
      err = run_product<D>(pr, (int)row[ML_SPLITS_W], prod_buf,
                           ptr<float>(row, ML_CHUNK_DW_RES) + c * wsz, stream);
    }
    if (err == cudaSuccess) {
      Product pm{PF_WINDOWS, x_l, dg_buf, n, n, wc, ci, sb, sb};
      err = run_product<D>(pm, (int)row[ML_SPLITS_M], prod_buf,
                           ptr<float>(row, ML_CHUNK_DM) + (long long)c * n * n, stream);
    }
    // dwp = sum over the chunk's windows of y_flat^T dz.
    if (err == cudaSuccess && top) {
      Product pp{PF_ROWS, pa.y, dz_c, n * co, latent, wc, 1, sb, 0};
      err = run_product<D>(pp, (int)d[MH_SPLITS_WP], prod_buf,
                           ptr<float>(d, MH_CHUNK_DWP) + (long long)c * n * co * latent, stream);
    }
  }
  return err;
}

// The second stream K5 runs chunks on, one for each device, created at its
// first use and kept for the life of the process. Non-blocking: PyTorch's
// default stream is the legacy null stream, with which a blocking stream
// would synchronise, running the two chunks one after the other again; the
// fork and join events order it against the caller's stream instead.
cudaError_t side_stream(cudaStream_t* out) {
  constexpr int kMaxDevices = 64;
  static std::mutex lock;
  static cudaStream_t streams[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(lock);
  if (streams[dev] == nullptr)
    err = cudaStreamCreateWithFlags(&streams[dev], cudaStreamNonBlocking);
  *out = streams[dev];
  return err;
}

template <int D>
int run_mono(const long long* d, cudaStream_t stream) {
  const int n_layers = (int)d[MH_N_LAYERS], batch = (int)d[MH_BATCH], n = (int)d[MH_N_NODES];
  const int ghost = (int)d[MH_GHOST], latent = (int)d[MH_LATENT], chunk = (int)d[MH_CHUNK];
  const int in_flight = (int)d[MH_IN_FLIGHT];
  const long long slot_bytes = d[MH_SLOT_BYTES];
  if (n_layers < 1 || batch < 1 || ghost < 1 || batch % ghost != 0 || n < 1 || latent < 1 ||
      chunk < ghost || chunk % ghost != 0 || in_flight < 1 || in_flight > 2 || slot_bytes < 0)
    return (int)cudaErrorInvalidValue;
  const long long* rows = d + MH_COUNT;
  LayerSmem most;
  cudaError_t err = check_layers<D>(rows, ML_COUNT, n_layers, n, &most);
  if (err == cudaSuccess) err = allow_passes<D>(most);
  if (err != cudaSuccess) return (int)err;
  auto graph = graph_operand_kernel<D>;
  // the graph operands: every layer that passes dx down, and under "bfloat16"
  // every layer (fwd_pre and bwd_pre read M^T's bf16 copy)
  for (int l = D == kBfloat16 ? 0 : 1; l < n_layers; ++l) {
    const long long* row = rows + (long long)l * ML_COUNT;
    graph<<<blocks_for((long long)n * graph_ld<D>(n)), kThreads, 0, stream>>>(
        ptr<const float>(row, ML_M), ptr<scratch_t<D>>(row, ML_MT), n);
  }
  // Chunk c runs in slot c % in_flight: slot 0 on the caller's stream, slot
  // 1 on the side stream, which first waits for everything before it on the
  // caller's (the inputs, the graph operands, the workspace's last use).
  // Each stream takes its slot's chunks in order, so a slot is reused only
  // after its last chunk is done; and as no two chunks write one buffer, the
  // result is the same bits as one stream's.
  const int n_chunks = (batch + chunk - 1) / chunk;
  cudaStream_t streams[2] = {stream, stream};
  cudaEvent_t fork = nullptr, join = nullptr;
  bool forked = false;
  if (in_flight > 1 && n_chunks > 1) {
    err = side_stream(&streams[1]);
    if (err == cudaSuccess) err = cudaEventCreateWithFlags(&fork, cudaEventDisableTiming);
    if (err == cudaSuccess) err = cudaEventCreateWithFlags(&join, cudaEventDisableTiming);
    if (err == cudaSuccess) err = cudaEventRecord(fork, stream);
    if (err == cudaSuccess) err = cudaStreamWaitEvent(streams[1], fork, 0);
    forked = err == cudaSuccess;
  }
  for (int c = 0; c < n_chunks && err == cudaSuccess; ++c) {
    const int w0 = c * chunk;
    const int wc = batch - w0 < chunk ? batch - w0 : chunk;
    const int s = c % in_flight;
    err = mono_chunk<D>(d, c, w0, wc, s * slot_bytes, streams[s]);
  }
  if (forked) {
    // Join before returning, whatever happened above. The wrapper's
    // workspaces are torch.empty tensors allocated on the caller's stream;
    // when Python drops them the caching allocator hands their memory to the
    // next allocation on that stream at once, without waiting for the
    // device. Only this wait keeps the kernels still queued on the side
    // stream ordered before any such reuse (and before the sums below).
    cudaError_t j = cudaEventRecord(join, streams[1]);
    if (j == cudaSuccess) j = cudaStreamWaitEvent(stream, join, 0);
    if (err == cudaSuccess) err = j;
  }
  if (fork != nullptr) cudaEventDestroy(fork);  // released once their work completes
  if (join != nullptr) cudaEventDestroy(join);
  if (err != cudaSuccess) return (int)err;
  // The whole-batch sums, in chunk (block, window) order.
  for (int l = 0; l < n_layers; ++l) {
    const long long* row = rows + (long long)l * ML_COUNT;
    const Layer L = row_layer(row);
    const bool top = l == n_layers - 1;
    const long long wsz = (long long)L.ci * L.co;
    sum_splits_kernel<<<blocks_for(wsz), kThreads, 0, stream>>>(
        ptr<const float>(row, ML_CHUNK_DW), wsz, n_chunks, ptr<float>(row, ML_DW));
    if (!L.identity)
      sum_splits_kernel<<<blocks_for(wsz), kThreads, 0, stream>>>(
          ptr<const float>(row, ML_CHUNK_DW_RES), wsz, n_chunks, ptr<float>(row, ML_DW_RES));
    sum_splits_kernel<<<blocks_for((long long)n * n), kThreads, 0, stream>>>(
        ptr<const float>(row, ML_CHUNK_DM), (long long)n * n, n_chunks, ptr<float>(row, ML_DM));
    bwd_reduce_kernel<<<1, kThreads, sizeof(float) * kThreads, stream>>>(
        ptr<const float>(row, ML_GPART), batch / ghost, ptr<const float>(row, ML_DALPHA_PART),
        batch, L, ptr<float>(row, ML_DGAMMA), ptr<float>(row, ML_DBETA), ptr<float>(row, ML_DB),
        ptr<float>(row, ML_DGAMMA_RES), ptr<float>(row, ML_DBETA_RES), ptr<float>(row, ML_DB_RES),
        ptr<float>(row, ML_DALPHA), top ? ptr<const float>(d, MH_DZ) : nullptr, latent,
        ptr<float>(d, MH_DBP));
    if (top) {
      const long long psz = (long long)n * L.co * latent;
      sum_splits_kernel<<<blocks_for(psz), kThreads, 0, stream>>>(
          ptr<const float>(d, MH_CHUNK_DWP), psz, n_chunks, ptr<float>(d, MH_DWP));
    }
  }
  return (int)cudaGetLastError();
}

template <int D>
int run_backward(const long long* d, bool top, cudaStream_t stream) {
  using S = scratch_t<D>;
  using A = act_t<D>;
  constexpr int sb = D == kBfloat16;  // the products' scratch and activation operands: bf16
  const int batch = (int)d[BD_BATCH], n = (int)d[BD_N_NODES], ghost = (int)d[BD_GHOST];
  const int latent = (int)d[BD_LATENT];
  Layer L;
  L.ci = (int)d[BD_CI];
  L.co = (int)d[BD_CO];
  L.identity = (int)d[BD_IDENTITY];
  L.m = ptr<const float>(d, BD_M);
  L.w = ptr<const float>(d, BD_W);
  L.b = ptr<const float>(d, BD_B);
  L.gamma = ptr<const float>(d, BD_GAMMA);
  L.beta = ptr<const float>(d, BD_BETA);
  L.wr = ptr<const float>(d, BD_W_RES);
  L.br = ptr<const float>(d, BD_B_RES);
  L.gamma_r = ptr<const float>(d, BD_GAMMA_RES);
  L.beta_r = ptr<const float>(d, BD_BETA_RES);
  L.alpha = ptr<const float>(d, BD_ALPHA);
  L.stats = ptr<const float>(d, BD_STATS);
  const int ci = L.ci, co = L.co;
  if (batch < 1 || ghost < 1 || batch % ghost != 0 || n < 1 || ci < 1 || co < 1 ||
      (L.identity && ci != co) || (top && (latent < 1 || d[BD_DZ] == 0 || d[BD_WP] == 0)) ||
      (!top && d[BD_DY] == 0) || d[BD_Y] == 0)
    return (int)cudaErrorInvalidValue;
  const int n_blocks = batch / ghost;
  const A* x = ptr<const A>(d, BD_X);
  const float* dz = top ? ptr<const float>(d, BD_DZ) : nullptr;
  S* g_buf = ptr<S>(d, BD_G_BUF);
  S* t_buf = ptr<S>(d, BD_T_BUF);
  S* r_buf = ptr<S>(d, BD_R_BUF);
  S* dg_buf = ptr<S>(d, BD_DG_BUF);
  float* prod_buf = ptr<float>(d, BD_PROD_BUF);
  S* mt = ptr<S>(d, BD_MT);

  const LayerSmem smem = layer_smem<D>(L, n);
  cudaError_t err = allow_passes<D>(LayerSmem{0, 0, smem.pre, smem.dx});
  if (err != cudaSuccess) return (int)err;

  PassArgs<D> pa;
  pa.x = x;
  pa.y = ptr<const A>(d, BD_Y);
  pa.dy = top ? nullptr : ptr<const A>(d, BD_DY);
  pa.dz = dz;
  pa.wp = ptr<const float>(d, BD_WP);
  pa.mt = mt;
  pa.batch = batch;
  pa.n = n;
  pa.ghost = ghost;
  pa.latent = latent;
  pa.g_buf = g_buf;
  pa.t_buf = t_buf;
  pa.r_buf = r_buf;
  pa.dpre_buf = ptr<S>(d, BD_DPRE_BUF);
  pa.dg_buf = dg_buf;
  pa.part = ptr<float>(d, BD_PART);
  pa.dalpha_part = ptr<float>(d, BD_DALPHA_PART);
  pa.consts = ptr<float>(d, BD_CONSTS);
  pa.gpart = ptr<float>(d, BD_GPART);
  pa.dx = ptr<A>(d, BD_DX);
  if (pa.dx != nullptr || D == kBfloat16) {  // bf16: bwd_pre reads M^T's bf16 copy
    auto graph = graph_operand_kernel<D>;
    graph<<<blocks_for((long long)n * graph_ld<D>(n)), kThreads, 0, stream>>>(L.m, mt, n);
  }
  err = run_passes<D>(L, pa, smem, stream);
  if (err != cudaSuccess) return (int)err;
  bwd_reduce_kernel<<<1, kThreads, sizeof(float) * kThreads, stream>>>(
      pa.gpart, n_blocks, pa.dalpha_part, batch, L, ptr<float>(d, BD_DGAMMA),
      ptr<float>(d, BD_DBETA), ptr<float>(d, BD_DB), ptr<float>(d, BD_DGAMMA_RES),
      ptr<float>(d, BD_DBETA_RES), ptr<float>(d, BD_DB_RES), ptr<float>(d, BD_DALPHA), dz, latent,
      ptr<float>(d, BD_DBP));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // dW = sum g^T dt and dW_res = sum x^T dr over all B*N rows.
  const long long n_rows = (long long)batch * n;
  Product pw{PF_ROWS, g_buf, t_buf, ci, co, n_rows, 1, sb, sb};
  err = run_product<D>(pw, (int)d[BD_SPLITS_W], prod_buf, ptr<float>(d, BD_DW), stream);
  if (err == cudaSuccess && !L.identity) {
    Product pr{PF_ROWS, x, r_buf, ci, co, n_rows, 1, sb, sb};
    err = run_product<D>(pr, (int)d[BD_SPLITS_W_RES], prod_buf, ptr<float>(d, BD_DW_RES),
                         stream);
  }
  // dM[k][m] = sum over windows and channels of x[k][c] dg[m][c].
  if (err == cudaSuccess) {
    Product pm{PF_WINDOWS, x, dg_buf, n, n, batch, ci, sb, sb};
    err = run_product<D>(pm, (int)d[BD_SPLITS_M], prod_buf, ptr<float>(d, BD_DM), stream);
  }
  // K4: dwp = sum over windows of y_flat^T dz.
  if (err == cudaSuccess && top) {
    Product pp{PF_ROWS, ptr<const A>(d, BD_Y), dz, n * co, latent, batch, 1, sb, 0};
    err = run_product<D>(pp, (int)d[BD_SPLITS_WP], prod_buf, ptr<float>(d, BD_DWP), stream);
  }
  return (int)err;
}

// K2 in form D (see stse_train_forward).
template <int D>
int run_forward(const long long* desc, cudaStream_t stream) {
  const int n_layers = (int)desc[FH_N_LAYERS], batch = (int)desc[FH_BATCH];
  const int n = (int)desc[FH_N_NODES], ghost = (int)desc[FH_GHOST];
  const int latent = (int)desc[FH_LATENT], z_splits = (int)desc[FH_Z_SPLITS];
  if (n_layers < 1 || batch < 1 || ghost < 1 || batch % ghost != 0 || n < 1 || latent < 1 ||
      z_splits < 1)
    return (int)cudaErrorInvalidValue;
  const long long* rows = desc + FH_COUNT;
  LayerSmem most;
  cudaError_t err = check_layers<D>(rows, FL_COUNT, n_layers, n, &most);
  if (err == cudaSuccess) err = allow_passes<D>(LayerSmem{most.fwd, most.apply, 0, 0});
  if (err != cudaSuccess) return (int)err;
  using S = scratch_t<D>;
  using A = act_t<D>;
  S* graph = ptr<S>(desc, FH_GRAPH);  // under "bfloat16": each layer's M^T in turn
  if (D == kBfloat16 && graph == nullptr) return (int)cudaErrorInvalidValue;
  const A* x = ptr<const A>(desc, FH_X);
  for (int l = 0; l < n_layers && err == cudaSuccess; ++l) {
    const long long* row = rows + (long long)l * FL_COUNT;
    Layer L = row_layer(row);
    float* stats = ptr<float>(row, FL_STATS);
    L.stats = stats;
    A* act = ptr<A>(row, FL_ACT);
    if constexpr (D == kBfloat16) {
      auto op = graph_operand_kernel<D>;
      op<<<blocks_for((long long)n * graph_ld<D>(n)), kThreads, 0, stream>>>(L.m, graph, n);
    }
    err = run_forward_layer<D>(x, L, n, ghost, batch, ptr<S>(desc, FH_T_BUF),
                               ptr<S>(desc, FH_R_BUF), ptr<float>(desc, FH_PART), stats,
                               ptr<float>(desc, FH_BLOCK_SUMS), ptr<float>(row, FL_SUMS), act,
                               graph, stream);
    x = act;
  }
  if (err != cudaSuccess) return (int)err;
  const int c_top = (int)rows[(long long)(n_layers - 1) * FL_COUNT + FL_CO];
  return (int)run_projector<D>(x, ptr<const float>(desc, FH_WP), ptr<const float>(desc, FH_BP),
                               batch, n * c_top, latent, z_splits, ptr<float>(desc, FH_Z_PART),
                               ptr<float>(desc, FH_Z), stream);
}

// The per-window passes of a layer of C_in ci, C_out co on n nodes in the
// compute dtype `dtype` (ComputeDtype), for checks and reports: out =
// (bwd_pre's windows a block, its shared bytes a block, its blocks an SM;
// bwd_dx's shared bytes, blocks an SM; fwd_pre's windows a block, shared
// bytes, blocks an SM; fwd_apply's shared bytes, blocks an SM;
// projector_z's blocks an SM), the blocks an SM as
// cudaOccupancyMaxActiveBlocksPerMultiprocessor gives them on the current
// device for that form's kernels.
template <int D>
int pass_occupancy(int n, int ci, int co, int* out) {
  Layer L;
  L.ci = ci;
  L.co = co;
  const LayerSmem smem = layer_smem<D>(L, n);
  const void* kernels[5] = {(const void*)bwd_pre_kernel<D>, (const void*)bwd_dx_kernel<D>,
                            (const void*)fwd_pre_kernel<D>, (const void*)fwd_apply_kernel<D>,
                            (const void*)projector_z_kernel<D>};
  const long long bytes[5] = {smem.pre, smem.dx, smem.fwd, smem.apply, 0};
  int blocks[5] = {0, 0, 0, 0, 0};
  cudaError_t err = cudaSuccess;
  for (int k = 0; k < 5 && err == cudaSuccess; ++k) {
    err = allow_smem(kernels[k], bytes[k]);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks[k], kernels[k], kThreads,
                                                          (size_t)bytes[k]);
  }
  const int fields[11] = {pre_windows(ci), (int)smem.pre, blocks[0], (int)smem.dx, blocks[1],
                          pre_windows(ci), (int)smem.fwd, blocks[2], (int)smem.apply, blocks[3],
                          blocks[4]};
  for (int k = 0; k < 11; ++k) out[k] = fields[k];
  return (int)err;
}

}  // namespace

extern "C" {

const char* stse_train_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// K2. desc: FH_COUNT header fields, then n_layers rows of FL_COUNT fields
// (see FwdHeader / FwdLayerField; built by stse_train.py). x and each
// layer's act in form D's activation type; scratch t_buf and r_buf [B, N,
// max C_out] in its scratch type, fp32 part [B, 4, max C_out], block_sums
// [B / ghost, 4, max C_out] and z_part [z_splits, B, latent] (the
// projector's partials); under "bfloat16" graph, the bf16 graph operand
// [2 N round8(N)] (else null).
int stse_train_forward(const long long* desc, void* stream) {
  return with_dtype(desc[FH_DTYPE], [&](auto d) {
    return run_forward<decltype(d)::value>(desc, (cudaStream_t)stream);
  });
}

// K5. desc: MH_COUNT header fields, then n_layers rows of ML_COUNT fields
// (see MonoHeader / MonoLayerField; built by stse_train.py). x and dz
// [B, ...]. MH_IN_FLIGHT (1 or 2) chunk workspaces, each MH_SLOT_BYTES
// past the one before; the descriptor holds the first's pointers. One, for
// C = MH_CHUNK windows, in form D's scratch type: t_buf, r_buf, dpre_buf
// [C, N, max C_out]; g_buf, dg_buf [C, N, max C_in]; in its activation
// type: dy_buf [C, N, max C_in of the layers above 0], per layer act [C, N,
// C_out]; fp32: part [C, 4, max C_out]; block_sums and consts [C / ghost, 4
// and 6, max C_out]; per layer stats [C / ghost, 4, C_out]; prod_buf as
// K3/K4's for one chunk. Whole batch, per layer: mt, the graph operand (not
// layer 0 outside "bfloat16"), gpart [B / ghost, 6, C_out], dalpha_part
// [B], chunk_dm / chunk_dw / chunk_dw_res [n_chunks, ...]; chunk_dwp
// [n_chunks, N * C_out, latent]. Returns with every launch queued after
// the caller's stream's earlier work and before its later work.
int stse_train_mono_backward(const long long* desc, void* stream) {
  return with_dtype(desc[MH_DTYPE], [&](auto d) {
    return run_mono<decltype(d)::value>(desc, (cudaStream_t)stream);
  });
}

// One batch-reduction product alone. desc: PD_COUNT fields (see
// ProductField): rows form C = A^T B, A [n, p], B [n, q]; windows form
// C = sum over n windows of A_w B_w^T, A [n, p, k], B [n, q, k]; A and B
// fp32, or bf16 (PD_A_BF16, PD_B_BF16; a bf16 form only), as K3-K5 hand
// their scratch operands over. part holds splits * p * q floats (unused for
// one split).
int stse_train_product(const long long* d, void* stream) {
  const int form = (int)d[PD_FORM], p = (int)d[PD_P], q = (int)d[PD_Q], k = (int)d[PD_K];
  const long long n = d[PD_N];
  if ((form != PF_ROWS && form != PF_WINDOWS) || p < 1 || q < 1 || n < 1 || k < 1)
    return (int)cudaErrorInvalidValue;
  const Product pr{form, ptr<const void>(d, PD_A), ptr<const void>(d, PD_B), p, q, n, k,
                   (int)d[PD_A_BF16], (int)d[PD_B_BF16]};
  return with_dtype(d[PD_DTYPE], [&](auto dt) {
    return (int)run_product<decltype(dt)::value>(pr, (int)d[PD_SPLITS], ptr<float>(d, PD_PART),
                                                 ptr<float>(d, PD_OUT), (cudaStream_t)stream);
  });
}

// K3: one lower layer's backward (desc: BD_COUNT fields, BD_Y and BD_DY set, BD_DZ 0).
int stse_train_layer_backward(const long long* desc, void* stream) {
  return with_dtype(desc[BD_DTYPE], [&](auto d) {
    return run_backward<decltype(d)::value>(desc, false, (cudaStream_t)stream);
  });
}

// K4: the top layer's backward with the projector's (BD_DZ, BD_WP, BD_Y set).
int stse_train_top_backward(const long long* desc, void* stream) {
  return with_dtype(desc[BD_DTYPE], [&](auto d) {
    return run_backward<decltype(d)::value>(desc, true, (cudaStream_t)stream);
  });
}

// The per-window passes' occupancy (pass_occupancy above) in the form `dtype` names.
int stse_train_pass_occupancy(int n, int ci, int co, int dtype, int* out) {
  if (n < 1 || ci < 1 || co < 1) return (int)cudaErrorInvalidValue;
  return with_dtype(dtype,
                    [&](auto d) { return pass_occupancy<decltype(d)::value>(n, ci, co, out); });
}

}  // extern "C"
