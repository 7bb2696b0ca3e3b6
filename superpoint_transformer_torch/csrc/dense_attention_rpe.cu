// Streaming dense-neighbor attention with in-kernel relative position
// encodings (RPE), for Hopper (sm_90a).
//
// Replaces the TPU kernel `dense_attention_rpe_pallas`
// (superpoint_transformer_tpu/ops/pallas_attention.py, body `_rpe_kernel`).
// For every node n and head h, over the K neighbor slots:
//
//   k_rpe = ef[n,k] . wk + bk     q_rpe = ef[n,k] . wq + bq
//   v_rpe = ef[n,k] . wv + bv
//   logit[k,h] = scale[n] * sum_d (q[n,h,d] + q_rpe[h,d]) (kg[n,k,h,d] + k_rpe[h,d])
//   out[n,h,:] = softmax_k(masked logit) . (vg[n,k,h,:] + v_rpe[h,:])
//   lse[h,n]   = log-sum-exp of the masked logits (optional)
//
// Masked slots get the logit -1e30 and weight 0; a fully masked row gives
// out = 0. Inputs are f32 or bf16; all math is f32.
//
// What bounds it on an H100: the gathered keys, values and edge features
// are read once ((H*D + C + De) values per slot, 320 bytes in bf16 at the
// flagship H=16, D=4, C=64, De=32), and the [N, K, H*D] RPE tensors are
// never written. The RPE projections are De*(2*H*D + C) multiply-adds per
// slot on the CUDA cores with the weights read from shared memory, so the
// kernel is bound by shared-memory loads before device memory. The design
// answers that by computing the projections of SLOTS slots per pass over
// the weights (each weight load feeds SLOTS FMAs) and by staging the
// weights once per block, which then walks many nodes (grid-stride).
//
// Layout: one warp per node, WARPS_PER_BLOCK nodes per block. Lane l owns
// the q/k channels j = l + 32*i and the v channels c = l + 32*i
// (i < NJ). A head's logit is summed over its D consecutive lanes with
// warp shuffles (D a power of two, at most 32) and passed to the lanes
// holding that head's value channels through shared memory. The online
// softmax state (running max, denominator, accumulator) lives in
// registers, one copy per value channel.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int WARP = 32;
constexpr int WARPS_PER_BLOCK = 8;
constexpr int SLOTS = 4;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int NJ>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * WARP)
dense_attention_rpe_kernel(
    const T* __restrict__ q,         // [N, H*D]
    const T* __restrict__ kg,        // [N, K, >=H*D], slot stride ldk
    const T* __restrict__ vg,        // [N, K, >=C],   slot stride ldv
    const T* __restrict__ ef,        // [N, K, De]
    const T* __restrict__ wk, const T* __restrict__ bk,  // [De, H*D], [H*D]
    const T* __restrict__ wq, const T* __restrict__ bq,  // [De, H*D], [H*D]
    const T* __restrict__ wv, const T* __restrict__ bv,  // [De, C],   [C]
    const bool* __restrict__ mask,   // [N, K]
    const float* __restrict__ scale, // [N]
    float* __restrict__ out,         // [N, C]
    float* __restrict__ lse,         // [H, N] or nullptr
    int N, int K, int H, int D, int C, int De, long long ldk,
    long long ldv) {
  extern __shared__ float smem[];
  const int DH = H * D;
  const int CH = C / H;
  float* s_wk = smem;
  float* s_wq = s_wk + De * DH;
  float* s_wv = s_wq + De * DH;
  float* s_bk = s_wv + De * C;
  float* s_bq = s_bk + DH;
  float* s_bv = s_bq + DH;
  float* s_warps = s_bv + C;

  for (int i = threadIdx.x; i < De * DH; i += blockDim.x) {
    s_wk[i] = to_f32(wk[i]);
    s_wq[i] = to_f32(wq[i]);
  }
  for (int i = threadIdx.x; i < De * C; i += blockDim.x)
    s_wv[i] = to_f32(wv[i]);
  for (int i = threadIdx.x; i < DH; i += blockDim.x) {
    s_bk[i] = to_f32(bk[i]);
    s_bq[i] = to_f32(bq[i]);
  }
  for (int i = threadIdx.x; i < C; i += blockDim.x) s_bv[i] = to_f32(bv[i]);
  __syncthreads();

  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  float* s_ef = s_warps + warp * SLOTS * (De + H);  // [SLOTS, De]
  float* s_logit = s_ef + SLOTS * De;               // [SLOTS, H]

  for (int n = blockIdx.x * WARPS_PER_BLOCK + warp; n < N;
       n += gridDim.x * WARPS_PER_BLOCK) {
    const float sc = scale[n];
    // node query with the q bias folded in
    float qn[NJ];
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      const int j = lane + WARP * i;
      qn[i] = j < DH ? to_f32(q[(long long)n * DH + j]) + s_bq[j] : 0.f;
    }
    float m[NJ], s[NJ], acc[NJ];
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      m[i] = -1e30f;
      s[i] = 0.f;
      acc[i] = 0.f;
    }

    for (int k0 = 0; k0 < K; k0 += SLOTS) {
      // stage the edge features of SLOTS slots (zeros past K)
      __syncwarp();
      for (int t = lane; t < SLOTS * De; t += WARP) {
        const int k = k0 + t / De;
        s_ef[t] = k < K
            ? to_f32(ef[((long long)n * K + k) * De + t % De]) : 0.f;
      }
      __syncwarp();

      // RPE projections of the SLOTS slots: one pass over the weights
      float kr[SLOTS][NJ], qr[SLOTS][NJ], vr[SLOTS][NJ];
#pragma unroll
      for (int i = 0; i < NJ; ++i) {
        const int j = lane + WARP * i;
        const float b_k = j < DH ? s_bk[j] : 0.f;
        const float b_v = j < C ? s_bv[j] : 0.f;
#pragma unroll
        for (int u = 0; u < SLOTS; ++u) {
          kr[u][i] = b_k;
          qr[u][i] = 0.f;
          vr[u][i] = b_v;
        }
      }
      for (int e = 0; e < De; ++e) {
        float efu[SLOTS];
#pragma unroll
        for (int u = 0; u < SLOTS; ++u) efu[u] = s_ef[u * De + e];
#pragma unroll
        for (int i = 0; i < NJ; ++i) {
          const int j = lane + WARP * i;
          if (j < DH) {
            const float a = s_wk[e * DH + j];
            const float b = s_wq[e * DH + j];
#pragma unroll
            for (int u = 0; u < SLOTS; ++u) {
              kr[u][i] = fmaf(efu[u], a, kr[u][i]);
              qr[u][i] = fmaf(efu[u], b, qr[u][i]);
            }
          }
          if (j < C) {
            const float w = s_wv[e * C + j];
#pragma unroll
            for (int u = 0; u < SLOTS; ++u)
              vr[u][i] = fmaf(efu[u], w, vr[u][i]);
          }
        }
      }

#pragma unroll
      for (int u = 0; u < SLOTS; ++u) {
        const int k = k0 + u;
        if (k < K) {  // warp-uniform
          const long long row = (long long)n * K + k;
          const float maskk = mask[row] ? 1.f : 0.f;
          // per-head logits: partial products summed over D lanes
#pragma unroll
          for (int i = 0; i < NJ; ++i) {
            const int j = lane + WARP * i;
            float prod = 0.f;
            if (j < DH)
              prod = (qn[i] + qr[u][i])
                  * (to_f32(kg[row * ldk + j]) + kr[u][i]);
            for (int off = D / 2; off > 0; off >>= 1)
              prod += __shfl_xor_sync(FULL, prod, off);
            if (j < DH && j % D == 0) s_logit[u * H + j / D] = prod;
          }
          __syncwarp();
          // online softmax update of every value channel
#pragma unroll
          for (int i = 0; i < NJ; ++i) {
            const int c = lane + WARP * i;
            if (c < C) {
              float logit = s_logit[u * H + c / CH] * sc;
              logit = logit * maskk + (maskk - 1.f) * 1e30f;
              const float m_new = fmaxf(m[i], logit);
              const float alpha = expf(m[i] - m_new);
              const float p = expf(logit - m_new) * maskk;
              s[i] = s[i] * alpha + p;
              acc[i] = acc[i] * alpha
                  + p * (to_f32(vg[row * ldv + c]) + vr[u][i]);
              m[i] = m_new;
            }
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      const int c = lane + WARP * i;
      if (c < C) {
        const float denom = fmaxf(s[i], 1e-30f);
        out[(long long)n * C + c] = acc[i] / denom;
        if (lse != nullptr && c % CH == 0)
          lse[(long long)(c / CH) * N + n] = m[i] + logf(denom);
      }
    }
  }
}

template <typename T, int NJ>
cudaError_t launch(const void* q, const void* kg, long long ldk,
                   const void* vg, long long ldv, const void* ef,
                   const void* wk, const void* bk, const void* wq,
                   const void* bq, const void* wv, const void* bv,
                   const void* mask, const void* scale, void* out,
                   void* lse, int N, int K, int H, int D, int C, int De,
                   cudaStream_t stream) {
  const int DH = H * D;
  const size_t smem = sizeof(float)
      * ((size_t)De * (2 * DH + C) + 2 * DH + C
         + (size_t)WARPS_PER_BLOCK * SLOTS * (De + H));
  auto kernel = dense_attention_rpe_kernel<T, NJ>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  long long blocks = (N + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  const long long max_blocks = (long long)(sms > 0 ? sms : 132) * 8;
  if (blocks > max_blocks) blocks = max_blocks;
  kernel<<<(int)blocks, WARPS_PER_BLOCK * WARP, smem, stream>>>(
      (const T*)q, (const T*)kg, (const T*)vg, (const T*)ef,
      (const T*)wk, (const T*)bk, (const T*)wq, (const T*)bq,
      (const T*)wv, (const T*)bv, (const bool*)mask, (const float*)scale,
      (float*)out, (float*)lse, N, K, H, D, C, De, ldk, ldv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int nj, const void* q, const void* kg, long long ldk,
                     const void* vg, long long ldv, const void* ef,
                     const void* wk, const void* bk, const void* wq,
                     const void* bq, const void* wv, const void* bv,
                     const void* mask, const void* scale, void* out,
                     void* lse, int N, int K, int H, int D, int C, int De,
                     cudaStream_t stream) {
  if (nj <= 1)
    return launch<T, 1>(q, kg, ldk, vg, ldv, ef, wk, bk, wq, bq, wv, bv,
                        mask, scale, out, lse, N, K, H, D, C, De, stream);
  if (nj <= 2)
    return launch<T, 2>(q, kg, ldk, vg, ldv, ef, wk, bk, wq, bq, wv, bv,
                        mask, scale, out, lse, N, K, H, D, C, De, stream);
  return launch<T, 4>(q, kg, ldk, vg, ldv, ef, wk, bk, wq, bq, wv, bv,
                      mask, scale, out, lse, N, K, H, D, C, De, stream);
}

}  // namespace

// Plain C entry point for ctypes. `is_bf16` selects the input type
// (0: float32, 1: bfloat16). The caller guarantees H*D <= 128,
// C <= 128, D a power of two <= 32, C % H == 0, contiguous [N, H*D] q,
// [N, K, De] ef, [N, K] mask, [N] scale and weights, and kg / vg whose
// last axis is contiguous with slot stride ldk / ldv. Returns the CUDA
// error of the launch (0 on success); the launch does not synchronize.
extern "C" int dense_attention_rpe_launch(
    int is_bf16, const void* q, const void* kg, long long ldk,
    const void* vg, long long ldv, const void* ef, const void* wk,
    const void* bk, const void* wq, const void* bq, const void* wv,
    const void* bv, const void* mask, const void* scale, void* out,
    void* lse, int N, int K, int H, int D, int C, int De, void* stream) {
  if (N == 0) return 0;
  const int DH = H * D;
  const int nj = ((DH > C ? DH : C) + WARP - 1) / WARP;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = is_bf16
      ? dispatch<__nv_bfloat16>(nj, q, kg, ldk, vg, ldv, ef, wk, bk, wq,
                                bq, wv, bv, mask, scale, out, lse, N, K,
                                H, D, C, De, st)
      : dispatch<float>(nj, q, kg, ldk, vg, ldv, ef, wk, bk, wq, bq, wv,
                        bv, mask, scale, out, lse, N, K, H, D, C, De, st);
  return (int)err;
}
