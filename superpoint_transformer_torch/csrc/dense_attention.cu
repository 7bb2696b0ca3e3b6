// Dense-neighbor masked softmax attention, for Hopper (sm_90a).
//
// Replaces the TPU kernel `dense_attention_pallas`
// (superpoint_transformer_tpu/ops/pallas_attention.py, body `_kernel`),
// which runs every attention block of the flagship model in training,
// where the k/q/v relative position encodings are added to the gathered
// rows outside the kernel. For every node n and head h, over the K
// neighbor slots:
//
//   qs[k,h,:]  = round_T(q[n,(k),h,:] * scale[n])   (q per node or per edge)
//   logit[k,h] = sum_d qs[k,h,d] * k[n,k,h,d]
//   out[n,h,:] = softmax_k(masked logit) . v[n,k,h,:]
//
// q*scale is rounded to the input type T before the dot product, as the
// TPU kernel does. Masked slots get the logit -1e30 and weight 0; a fully
// masked row gives out = 0. Inputs are f32 or bf16; all math is f32.
//
// What bounds it on an H100: every input value is read once and only
// [N, H, C/H] f32 is written, (2*H*D + C) values per slot (384 bytes in
// bf16 at the flagship H=16, D=4, C=64 with per-edge q), about 2 FLOP per
// byte: device-memory bandwidth. The design keeps loads coalesced (lanes
// over the contiguous channel axis of the natural [N, K, H, D] layout,
// not Mosaic's [H*D, K, N]) and issues the loads of SLOTS slots before
// any arithmetic on them, so several rows are in flight per warp.
//
// Layout: one warp per node, WARPS_PER_BLOCK nodes per block, grid-stride
// over nodes. Lane l owns the q/k channels j = l + 32*i and the value
// channels c = l + 32*i (i < NJ). A head's logit is summed over its D
// consecutive lanes with warp shuffles (D a power of two, at most 32) and
// passed to the lanes holding that head's value channels through shared
// memory. The online softmax state (running max, denominator,
// accumulator) lives in registers, one copy per value channel.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int WARP = 32;
constexpr int WARPS_PER_BLOCK = 8;
constexpr int SLOTS = 4;
constexpr int MAX_H = 128;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// an f32 value rounded to T and back
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T, int NJ>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * WARP)
dense_attention_kernel(
    const T* __restrict__ q,         // [N, H*D] or [N, K, H*D]
    const T* __restrict__ k,         // [N, K, H*D]
    const T* __restrict__ v,         // [N, K, C]
    const bool* __restrict__ mask,   // [N, K]
    const float* __restrict__ scale, // [N]
    float* __restrict__ out,         // [N, C]
    int N, int K, int H, int D, int C, int q_per_edge) {
  __shared__ float s_logit_all[WARPS_PER_BLOCK][SLOTS * MAX_H];
  const int DH = H * D;
  const int CH = C / H;
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  float* s_logit = s_logit_all[warp];   // [SLOTS, H]
  const long long q_node = q_per_edge ? (long long)K * DH : DH;
  const long long q_slot = q_per_edge ? DH : 0;

  for (int n = blockIdx.x * WARPS_PER_BLOCK + warp; n < N;
       n += gridDim.x * WARPS_PER_BLOCK) {
    const float sc = scale[n];
    float m[NJ], s[NJ], acc[NJ];
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      m[i] = -1e30f;
      s[i] = 0.f;
      acc[i] = 0.f;
    }

    for (int k0 = 0; k0 < K; k0 += SLOTS) {
      // issue the loads of SLOTS slots first (zeros past K)
      float qv[SLOTS][NJ], kv[SLOTS][NJ], vv[SLOTS][NJ], mk[SLOTS];
#pragma unroll
      for (int u = 0; u < SLOTS; ++u) {
        const int kk = k0 + u;
        const long long row = (long long)n * K + kk;
        mk[u] = kk < K && mask[row] ? 1.f : 0.f;
#pragma unroll
        for (int i = 0; i < NJ; ++i) {
          const int j = lane + WARP * i;
          const bool qk_ok = kk < K && j < DH;
          qv[u][i] = qk_ok ? to_f32(q[n * q_node + kk * q_slot + j]) : 0.f;
          kv[u][i] = qk_ok ? to_f32(k[row * DH + j]) : 0.f;
          vv[u][i] = kk < K && j < C ? to_f32(v[row * C + j]) : 0.f;
        }
      }
      // per-head logits: partial products summed over D lanes
#pragma unroll
      for (int u = 0; u < SLOTS; ++u) {
#pragma unroll
        for (int i = 0; i < NJ; ++i) {
          const int j = lane + WARP * i;
          float prod = round_to(qv[u][i] * sc, q) * kv[u][i];
          for (int off = D / 2; off > 0; off >>= 1)
            prod += __shfl_xor_sync(FULL, prod, off);
          if (j < DH && j % D == 0) s_logit[u * H + j / D] = prod;
        }
      }
      __syncwarp();
      // online softmax update of every value channel
#pragma unroll
      for (int u = 0; u < SLOTS; ++u) {
        if (k0 + u < K) {  // warp-uniform
#pragma unroll
          for (int i = 0; i < NJ; ++i) {
            const int c = lane + WARP * i;
            if (c < C) {
              const float logit =
                  mk[u] > 0.f ? s_logit[u * H + c / CH] : -1e30f;
              const float m_new = fmaxf(m[i], logit);
              const float alpha = expf(m[i] - m_new);
              const float p = expf(logit - m_new) * mk[u];
              s[i] = s[i] * alpha + p;
              acc[i] = acc[i] * alpha + p * vv[u][i];
              m[i] = m_new;
            }
          }
        }
      }
      __syncwarp();
    }

#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      const int c = lane + WARP * i;
      if (c < C) out[(long long)n * C + c] = acc[i] / fmaxf(s[i], 1e-30f);
    }
  }
}

template <typename T, int NJ>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, const void* scale, void* out, int N,
                   int K, int H, int D, int C, int q_per_edge,
                   cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  long long blocks = (N + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  const long long max_blocks = (long long)(sms > 0 ? sms : 132) * 8;
  if (blocks > max_blocks) blocks = max_blocks;
  dense_attention_kernel<T, NJ><<<(int)blocks, WARPS_PER_BLOCK * WARP, 0,
                                  stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const bool*)mask,
      (const float*)scale, (float*)out, N, K, H, D, C, q_per_edge);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int nj, const void* q, const void* k, const void* v,
                     const void* mask, const void* scale, void* out, int N,
                     int K, int H, int D, int C, int q_per_edge,
                     cudaStream_t stream) {
  if (nj <= 1)
    return launch<T, 1>(q, k, v, mask, scale, out, N, K, H, D, C,
                        q_per_edge, stream);
  if (nj <= 2)
    return launch<T, 2>(q, k, v, mask, scale, out, N, K, H, D, C,
                        q_per_edge, stream);
  return launch<T, 4>(q, k, v, mask, scale, out, N, K, H, D, C, q_per_edge,
                      stream);
}

}  // namespace

// Plain C entry point for ctypes. `is_bf16` selects the input type
// (0: float32, 1: bfloat16); q, k and v share it. The caller guarantees
// H*D <= 128, C <= 128, D a power of two <= 32, C % H == 0 and contiguous
// q ([N, H*D], or [N, K, H*D] when `q_per_edge`), k [N, K, H*D],
// v [N, K, C], mask [N, K] and scale [N]. Returns the CUDA error of the
// launch (0 on success); the launch does not synchronize.
extern "C" int dense_attention_launch(int is_bf16, const void* q,
                                      const void* k, const void* v,
                                      const void* mask, const void* scale,
                                      void* out, int N, int K, int H, int D,
                                      int C, int q_per_edge, void* stream) {
  if (N == 0) return 0;
  const int DH = H * D;
  const int nj = ((DH > C ? DH : C) + WARP - 1) / WARP;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = is_bf16
      ? dispatch<__nv_bfloat16>(nj, q, k, v, mask, scale, out, N, K, H, D, C,
                                q_per_edge, st)
      : dispatch<float>(nj, q, k, v, mask, scale, out, N, K, H, D, C,
                        q_per_edge, st);
  return (int)err;
}
