// Backward of the streaming dense-neighbor attention with in-kernel
// relative position encodings (RPE), for Hopper (sm_90a).
//
// Replaces the TPU kernel `dense_attention_rpe_bwd_pallas`
// (superpoint_transformer_tpu/ops/pallas_attention.py, body
// `_rpe_bwd_kernel`). From the forward's log-sum-exp and the row
// correction delta[h,n] = sum_c g[n,h,c] * out[n,h,c] (computed by the
// caller), for every node n and neighbor slot k it recomputes
//
//   k_full = kg + ef . wk + bk    q_full = q + ef . wq + bq
//   v_full = vg + ef . wv + bv
//   p[k,h] = exp(scale * <q_full, k_full>_h - lse[h,n])   (0 if masked)
//
// and emits the ten input gradients:
//
//   dvg = dv_full = p g                   e = p (g . v_full - delta) scale
//   dkg = dk_full = e q_full              dq = sum_k e k_full
//   d_ef = dk_full wk^T + dq_full wq^T + dv_full wv^T   (dq_full = e k_full)
//   dwk = sum_{n,k} ef^T dk_full, dbk = sum_{n,k} dk_full, and likewise
//   dwq, dbq (from dq_full) and dwv, dbv (from dv_full).
//
// Per-edge gradients are written in the input type T; weight and bias
// gradients are f32. In the bf16 variant all math is f32. The f32
// variant, which the tests and the f32 model check hold to autograd in
// f64, runs its whole per-slot chain in f64 (the projections, the logit,
// p, e and every product that feeds a gradient, and the weight-gradient
// sums) and rebuilds lse and delta in f64 from a first pass over the
// node's slots; each output is rounded to f32 once (see below).
//
// What bounds it on an H100: per slot it reads the gathered k/v rows and
// the edge features once and writes their gradients once (about 640
// bytes in bf16 at the flagship H=16, D=4, C=64, De=32), and does
// De*(2*H*D + C) = 6,144 multiply-adds three times: the recomputed RPE
// projections, the edge-feature gradient and the weight gradients. That
// is ~30 FLOP per byte; the bound from bytes is ~0.05 ms at N=5120,
// K=48, the kernel takes ~1.06 ms. What sets its pace is instruction
// latency on the CUDA cores: each warp's per-slot chain of shared loads,
// FMAs and shuffles, then the block's weight-gradient FMAs between two
// barriers a round. The design:
//
// - one warp per node for the per-slot work, as in the forward kernel:
//   lanes over the q/k and value channels, per-head sums by shuffles
//   (D and C/H powers of two at most 32), heads passed between the q/k
//   lanes and the value lanes through shared memory; the RPE projections
//   of SLOTS slots share each weight load;
// - the weights live once per block in shared memory, [De, W+1] with
//   W = 2*H*D + C columns [wk | wq | wv]: the odd row stride keeps the
//   projection (lanes over columns) and the f32 edge-feature gradient
//   (lanes over edge-feature rows) free of bank conflicts;
// - a round stages ROWS = 16 slots of the block, one m16n8k16 A tile:
//   every warp stages each slot's edge features (plus a constant 1, whose
//   row gives the bias gradients) and its [dk | dq | dv] gradient row G;
// - the edge-feature gradient d_ef = G [wk | wq | wv]^T is, in bf16, one
//   block-level product a round on the tensor cores (edge_grad_mma): the
//   bf16 weights are exact operands, staged once per block in B-fragment
//   order. G is f32, and one bf16 rounding (2^-9 relative) breaks K3's
//   tolerance by far (tests/test_torch_k3_precision.py), so G is staged
//   as two bf16 parts, hi = bf16(G) and lo = bf16(G - hi), about 2^-17
//   relative together, and each tile takes two mma. The f32 variant,
//   which only the tests and the f32 model check use, keeps its FMAs;
// - the weight gradients reduce over every node, which the TPU did on
//   its sequential grid. A CUDA grid has no order and f32 atomics would
//   make the result vary from run to run, so the whole block adds the
//   staged rows into a [De+1, W] accumulator of which each thread owns
//   tiles of EPT x 1 in registers; each block writes its partial sums,
//   and a second kernel adds the partials in block order. The result is
//   the same in every run on a given card. These stay on FMAs: on the
//   tensor cores (the same split of G) they drifted from an f64 reference
//   by up to 2.3x K3's tolerance at N=5120, where the FMAs stay within
//   0.34x, and took longer (PERF.md, Findings). The f32 variant sums
//   them in f64 (the accumulators, the block partials and their sum; the
//   f32 products are exact in f64) and rounds to f32 once, at the end:
//   with f32 sums over N*K = 245,760 slots its worst weight gradient
//   reached 1.54x the tolerance from f64 autograd over 20 seeds. f64
//   sums alone left one seed at 1.26x: each of the N*K terms carried
//   its own f32 roundings (the projections, exp, g . v - delta, and the
//   f32 lse and delta that the forward and the caller rounded). So the
//   f32 variant takes lse and delta from its own first pass (the row
//   max, the sum of exponentials and delta = sum_k p_k (g . v_full_k),
//   which is sum_c g * out) and carries every per-slot value in f64.
#include <type_traits>

#include "node_tiles.cuh"

namespace {

using node_tiles::FULL;
using node_tiles::mma_bf16;
using node_tiles::to_f32;
using node_tiles::WARP;

constexpr int WARPS_PER_BLOCK = 8;
constexpr int THREADS = WARPS_PER_BLOCK * WARP;
constexpr int SLOTS = 2;                          // slots per warp per round
constexpr int ROWS = WARPS_PER_BLOCK * SLOTS;     // slots staged per round
constexpr int EPT = 8;     // edge-feature rows per accumulator item
constexpr int MAX_ITEMS = 4;  // accumulator items per thread
static_assert(ROWS == 16, "a round is one 16-row m16n8k16 tile");

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
// acc + a * b in the accumulator's type (the f32 product is exact in f64)
__device__ __forceinline__ float fma_acc(float a, float b, float acc) {
  return fmaf(a, b, acc);
}
__device__ __forceinline__ double fma_acc(float a, float b, double acc) {
  return fma((double)a, (double)b, acc);
}
__device__ __forceinline__ double fma_acc(float a, double b, double acc) {
  return fma((double)a, b, acc);
}
__device__ __forceinline__ void store(float* p, double v) { *p = (float)v; }
__device__ __forceinline__ float exp_c(float x) { return expf(x); }
__device__ __forceinline__ double exp_c(double x) { return exp(x); }

// four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__host__ __device__ inline int padded_de1(int De) {
  return (De + 1 + EPT - 1) / EPT * EPT;
}

__host__ __device__ inline size_t up16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

// Shared-memory layout in bytes, the same on host and device; every
// region starts on 16 bytes. Both variants: the weights [De, W+1] and
// biases [W] in f32, the staged edge features [ROWS, DE1P] in f32, the
// gradient rows [ROWS, W] and the per-warp head scratch in the chain's
// type (f32 in bf16, f64 in f32). The bf16 variant
// adds the weights as the B fragments of the edge-feature gradient (NTA
// tiles of 8 edge features, KSA k-steps of 16 gradient columns) and the
// gradient rows split into bf16 hi and lo parts, [ROWS, LDG] each, zero
// past column W.
struct Layout {
  int W, WP, DE1P, NTA, KSA, LDG;
  size_t w, b, ef, grad, head, frag, ghi, glo, total;
  __host__ __device__ Layout(int H, int D, int C, int De, bool bf16) {
    W = 2 * H * D + C;
    WP = W + 1;
    DE1P = padded_de1(De);
    NTA = (De + 7) / 8;
    KSA = (W + 15) / 16;
    LDG = KSA * 16 + 8;  // 16 * odd bytes: ldmatrix rows on distinct banks
    const size_t chain = bf16 ? sizeof(float) : sizeof(double);
    size_t o = 0;
    w = o;    o += up16(sizeof(float) * De * WP);
    b = o;    o += up16(sizeof(float) * W);
    ef = o;   o += up16(sizeof(float) * ROWS * DE1P);
    grad = o; o += up16(chain * ROWS * W);
    head = o; o += up16(chain * WARPS_PER_BLOCK * 2 * H);
    frag = ghi = glo = o;
    if (bf16) {
      frag = o; o += sizeof(uint2) * NTA * KSA * WARP;
      ghi = o;  o += up16(sizeof(__nv_bfloat16) * ROWS * LDG);
      glo = o;  o += up16(sizeof(__nv_bfloat16) * ROWS * LDG);
    }
    total = o;
  }
};

// The edge-feature gradient of a round's ROWS staged slots on the tensor
// cores: d_ef[ROWS, De] = G[ROWS, W] . [wk | wq | wv]^T, with G = hi + lo
// (two bf16 parts, two products) and the bf16 weights exact. Warp w takes
// the tiles of 8 edge features w, w + 8, ...; staged row r is slot
// k0 + r % SLOTS of node base + r / SLOTS.
template <typename T>
__device__ __forceinline__ void edge_grad_mma(
    const Layout& L, const unsigned char* smem, long long base, int k0,
    int N, int K, int De, T* __restrict__ d_ef, int warp, int lane) {
  const uint2* frag = reinterpret_cast<const uint2*>(smem + L.frag);
  const __nv_bfloat16* ghi =
      reinterpret_cast<const __nv_bfloat16*>(smem + L.ghi);
  const __nv_bfloat16* glo =
      reinterpret_cast<const __nv_bfloat16*>(smem + L.glo);
  const int g = lane >> 2, tq = lane & 3;
  // A fragments: matrix l / 8 holds rows 8 * (l / 8 % 2) .. + 8 and
  // columns 8 * (l / 16) .. + 8 of the k-step
  const int a_off = (lane & 15) * L.LDG + 8 * (lane >> 4);
  for (int nt = warp; nt < L.NTA; nt += WARPS_PER_BLOCK) {
    float dh[4] = {0.f, 0.f, 0.f, 0.f}, dl[4] = {0.f, 0.f, 0.f, 0.f};
    for (int ks = 0; ks < L.KSA; ++ks) {
      unsigned ah[4], al[4];
      ldmatrix_x4(ah, ghi + a_off + ks * 16);
      ldmatrix_x4(al, glo + a_off + ks * 16);
      const uint2 bw = frag[(nt * L.KSA + ks) * WARP + lane];
      mma_bf16(dh, ah, bw);
      mma_bf16(dl, al, bw);
    }
    const int e = 8 * nt + 2 * tq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = g + 8 * half;
      const long long n = base + r / SLOTS;
      const int kk = k0 + r % SLOTS;
      if (n < N && kk < K) {
        T* dst = d_ef + (n * K + kk) * De;
        if (e < De) store(dst + e, dh[2 * half] + dl[2 * half]);
        if (e + 1 < De)
          store(dst + e + 1, dh[2 * half + 1] + dl[2 * half + 1]);
      }
    }
  }
}

// the type of the per-slot chain and of the weight-gradient sums: f32 in
// the bf16 variant, f64 in the f32 variant
template <typename T>
using Acc = typename std::conditional<
    std::is_same<T, __nv_bfloat16>::value, float, double>::type;

template <typename T, int NJ, int ITEMS>
__global__ void __launch_bounds__(THREADS)
dense_attention_rpe_bwd_kernel(
    const T* __restrict__ q,         // [N, H*D]
    const T* __restrict__ kg,        // [N, K, >=H*D], slot stride ldk
    const T* __restrict__ vg,        // [N, K, >=C],   slot stride ldv
    const T* __restrict__ ef,        // [N, K, De]
    const T* __restrict__ wk, const T* __restrict__ bk,  // [De, H*D], [H*D]
    const T* __restrict__ wq, const T* __restrict__ bq,  // [De, H*D], [H*D]
    const T* __restrict__ wv, const T* __restrict__ bv,  // [De, C],   [C]
    const bool* __restrict__ mask,    // [N, K]
    const float* __restrict__ scale,  // [N]
    const float* __restrict__ g,      // [N, C]
    const float* __restrict__ lse,    // [H, N]
    const float* __restrict__ delta,  // [H, N]
    T* __restrict__ dq,               // [N, H*D]
    T* __restrict__ dkg,              // [N, K, H*D]
    T* __restrict__ dvg,              // [N, K, C]
    T* __restrict__ d_ef,             // [N, K, De]
    Acc<T>* __restrict__ partial,     // [gridDim.x, De+1, W]
    int N, int K, int H, int D, int C, int De, long long ldk,
    long long ldv) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  using Ch = Acc<T>;  // the per-slot chain's type
  const Layout L(H, D, C, De, BF16);
  const int DH = H * D;
  const int CH = C / H;
  const int W = L.W;             // gradient columns [dk | dq | dv]
  const int WP = L.WP;           // odd row stride of the weights
  const int DE1 = De + 1;        // edge features and the constant 1
  const int DE1P = L.DE1P;
  float* s_w = reinterpret_cast<float*>(smem + L.w);   // [De, WP]
  float* s_b = reinterpret_cast<float*>(smem + L.b);   // [W]
  float* s_ef = reinterpret_cast<float*>(smem + L.ef);      // [ROWS, DE1P]
  Ch* s_grad = reinterpret_cast<Ch*>(smem + L.grad);  // [ROWS, W]
  Ch* s_head = reinterpret_cast<Ch*>(smem + L.head);
  __nv_bfloat16* s_ghi = reinterpret_cast<__nv_bfloat16*>(smem + L.ghi);
  __nv_bfloat16* s_glo = reinterpret_cast<__nv_bfloat16*>(smem + L.glo);

  for (int i = threadIdx.x; i < De * W; i += THREADS) {
    const int e = i / W, j = i % W;
    const float w = j < DH ? to_f32(wk[e * DH + j])
        : j < 2 * DH       ? to_f32(wq[e * DH + j - DH])
                           : to_f32(wv[e * C + j - 2 * DH]);
    s_w[e * WP + j] = w;
  }
  for (int j = threadIdx.x; j < W; j += THREADS)
    s_b[j] = j < DH ? to_f32(bk[j])
        : j < 2 * DH ? to_f32(bq[j - DH]) : to_f32(bv[j - 2 * DH]);
  if constexpr (BF16) {
    // the B fragments of [wk | wq | wv]^T: k = gradient column, n = edge
    // feature, zero past W and De (bf16 weights: exact)
    auto weight = [&](int e, int j) -> float {
      if (e >= De || j >= W) return 0.f;
      return j < DH ? to_f32(wk[e * DH + j])
          : j < 2 * DH ? to_f32(wq[e * DH + j - DH])
                       : to_f32(wv[e * C + j - 2 * DH]);
    };
    uint2* frag = reinterpret_cast<uint2*>(smem + L.frag);
    for (int i = threadIdx.x; i < L.NTA * L.KSA * WARP; i += THREADS) {
      const int l = i % WARP, ks = (i / WARP) % L.KSA;
      const int e = 8 * (i / (WARP * L.KSA)) + (l >> 2);
      const int j = ks * 16 + 2 * (l & 3);
      const __nv_bfloat162 lo =
          __floats2bfloat162_rn(weight(e, j), weight(e, j + 1));
      const __nv_bfloat162 hi =
          __floats2bfloat162_rn(weight(e, j + 8), weight(e, j + 9));
      frag[i] = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                           *reinterpret_cast<const unsigned*>(&hi));
    }
    // the gradient rows' columns past W stay zero
    for (int i = threadIdx.x; i < ROWS * L.LDG; i += THREADS) {
      s_ghi[i] = __float2bfloat16(0.f);
      s_glo[i] = __float2bfloat16(0.f);
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  Ch* s_logit = s_head + warp * 2 * H;  // [H]
  Ch* s_e = s_logit + H;                // [H]

  // accumulator item t: edge-feature rows (t / W) * EPT .. + EPT, column
  // t % W
  const int n_items = DE1P / EPT * W;
  Acc<T> acc[ITEMS][EPT];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it)
#pragma unroll
    for (int ee = 0; ee < EPT; ++ee) acc[it][ee] = 0;

  // every warp of a block runs the same number of rounds (the loop bounds
  // are block-uniform), so the __syncthreads below are reached by all
  for (long long base = (long long)blockIdx.x * WARPS_PER_BLOCK; base < N;
       base += (long long)gridDim.x * WARPS_PER_BLOCK) {
    const long long n = base + warp;
    const bool node_ok = n < N;
    const float sc = node_ok ? scale[n] : 0.f;
    // node query with the q bias folded in; cotangent, lse and delta of
    // the head of each value channel
    Ch qn[NJ], gq[NJ], lse_c[NJ], delta_c[NJ], dq_acc[NJ];
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      const int j = lane + WARP * i;
      qn[i] = node_ok && j < DH ? (Ch)to_f32(q[n * DH + j]) + s_b[DH + j]
                                : 0.f;
      const bool c_ok = node_ok && j < C;
      const long long hn = (long long)(j / CH) * N + n;
      gq[i] = c_ok ? g[n * C + j] : 0.f;
      lse_c[i] = c_ok ? lse[hn] : 0.f;
      delta_c[i] = c_ok ? delta[hn] : 0.f;
      dq_acc[i] = 0.f;
    }

    // stage the edge features of SLOTS slots from k0 (zeros past K or N),
    // with the constant 1 at index De
    auto stage = [&](int k0) {
      for (int t = lane; t < SLOTS * DE1P; t += WARP) {
        const int u = t / DE1P, e = t % DE1P, kk = k0 + u;
        float val = 0.f;
        if (e < De) {
          if (node_ok && kk < K) val = to_f32(ef[(n * K + kk) * De + e]);
        } else if (e == De) {
          val = 1.f;
        }
        s_ef[(warp * SLOTS + u) * DE1P + e] = val;
      }
      __syncwarp();
    };
    // recomputed RPE projections of the staged slots: one pass over the
    // weights (q's bias is folded into qn)
    auto project = [&](Ch (&kr)[SLOTS][NJ], Ch (&qr)[SLOTS][NJ],
                       Ch (&vr)[SLOTS][NJ]) {
#pragma unroll
      for (int i = 0; i < NJ; ++i) {
        const int j = lane + WARP * i;
        const Ch b_k = j < DH ? s_b[j] : 0.f;
        const Ch b_v = j < C ? s_b[2 * DH + j] : 0.f;
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
        for (int u = 0; u < SLOTS; ++u)
          efu[u] = s_ef[(warp * SLOTS + u) * DE1P + e];
        const float* wrow = s_w + e * WP;
#pragma unroll
        for (int i = 0; i < NJ; ++i) {
          const int j = lane + WARP * i;
          if (j < DH) {
            const float a = wrow[j], b = wrow[DH + j];
#pragma unroll
            for (int u = 0; u < SLOTS; ++u) {
              kr[u][i] = fma_acc(efu[u], a, kr[u][i]);
              qr[u][i] = fma_acc(efu[u], b, qr[u][i]);
            }
          }
          if (j < C) {
            const float w = wrow[2 * DH + j];
#pragma unroll
            for (int u = 0; u < SLOTS; ++u)
              vr[u][i] = fma_acc(efu[u], w, vr[u][i]);
          }
        }
      }
    };
    // q/k lanes: the head logits of slot u into s_logit, partial products
    // summed over D lanes; k_full and q_full stay in kf and qf
    auto logits = [&](int u, bool slot_ok, long long row,
                      const Ch (&kr)[SLOTS][NJ], const Ch (&qr)[SLOTS][NJ],
                      Ch (&kf)[NJ], Ch (&qf)[NJ]) {
#pragma unroll
      for (int i = 0; i < NJ; ++i) {
        const int j = lane + WARP * i;
        kf[i] = 0.f;
        qf[i] = 0.f;
        if (slot_ok && j < DH) {
          kf[i] = to_f32(kg[row * ldk + j]) + kr[u][i];
          qf[i] = qn[i] + qr[u][i];
        }
        Ch prod = qf[i] * kf[i];
        for (int off = D / 2; off > 0; off >>= 1)
          prod += __shfl_xor_sync(FULL, prod, off);
        if (j < DH && j % D == 0) s_logit[j / D] = prod;
      }
      __syncwarp();
    };

    if constexpr (!BF16) {
      // f32: lse and delta of each head in f64, from a first pass over the
      // node's slots: the running max, the sum of exponentials and the
      // sum of exponentials times g . v_full (an online softmax)
      Ch mx[NJ], se[NJ], te[NJ];
#pragma unroll
      for (int i = 0; i < NJ; ++i) {
        mx[i] = -1e300;
        se[i] = 0.f;
        te[i] = 0.f;
      }
      for (int k0 = 0; k0 < K; k0 += SLOTS) {
        stage(k0);
        Ch kr[SLOTS][NJ], qr[SLOTS][NJ], vr[SLOTS][NJ];
        project(kr, qr, vr);
#pragma unroll
        for (int u = 0; u < SLOTS; ++u) {
          const int kk = k0 + u;
          const bool slot_ok = node_ok && kk < K;  // warp-uniform
          const long long row = n * K + kk;
          const bool live = slot_ok && mask[row];
          Ch kf[NJ], qf[NJ];
          logits(u, slot_ok, row, kr, qr, kf, qf);
#pragma unroll
          for (int i = 0; i < NJ; ++i) {
            const int c = lane + WARP * i;
            Ch logit = 0.f, gv = 0.f;
            if (slot_ok && c < C) {
              logit = s_logit[c / CH] * sc;
              gv = gq[i] * ((Ch)to_f32(vg[row * ldv + c]) + vr[u][i]);
            }
            for (int off = CH / 2; off > 0; off >>= 1)
              gv += __shfl_xor_sync(FULL, gv, off);
            if (live && c < C) {
              if (logit > mx[i]) {
                const Ch r = exp_c(mx[i] - logit);
                se[i] = se[i] * r + 1.0;
                te[i] = te[i] * r + gv;
                mx[i] = logit;
              } else {
                const Ch w = exp_c(logit - mx[i]);
                se[i] += w;
                te[i] += w * gv;
              }
            }
          }
          __syncwarp();
        }
      }
#pragma unroll
      for (int i = 0; i < NJ; ++i) {
        lse_c[i] = se[i] > 0.0 ? mx[i] + log(se[i]) : 0.0;
        delta_c[i] = se[i] > 0.0 ? te[i] / se[i] : 0.0;
      }
    }

    for (int k0 = 0; k0 < K; k0 += SLOTS) {
      stage(k0);
      Ch kr[SLOTS][NJ], qr[SLOTS][NJ], vr[SLOTS][NJ];
      project(kr, qr, vr);

#pragma unroll
      for (int u = 0; u < SLOTS; ++u) {
        const int kk = k0 + u;
        const bool slot_ok = node_ok && kk < K;  // warp-uniform
        const long long row = n * K + kk;
        const float maskk = slot_ok && mask[row] ? 1.f : 0.f;
        Ch* grad = s_grad + (warp * SLOTS + u) * W;
        __nv_bfloat16* ghi = s_ghi + (warp * SLOTS + u) * L.LDG;
        __nv_bfloat16* glo = s_glo + (warp * SLOTS + u) * L.LDG;
        // column j of the slot's gradient row: f32, and in bf16 also split
        // into hi + lo for the tensor cores
        auto put = [&](int j, Ch v) {
          grad[j] = v;
          if constexpr (BF16) {
            const __nv_bfloat16 hi = __float2bfloat16(v);
            ghi[j] = hi;
            glo[j] = __float2bfloat16(v - __bfloat162float(hi));
          }
        };

        Ch kf[NJ], qf[NJ];
        logits(u, slot_ok, row, kr, qr, kf, qf);

        // value lanes: attention weight, value gradient, and the logit
        // gradient e of each head (g . v_full summed over C/H lanes)
        Ch dv[NJ];
#pragma unroll
        for (int i = 0; i < NJ; ++i) {
          const int c = lane + WARP * i;
          Ch p = 0.f, gv = 0.f;
          dv[i] = 0.f;
          if (slot_ok && c < C) {
            const Ch logit =
                maskk > 0.f ? s_logit[c / CH] * sc : -1e30f;
            p = exp_c(logit - lse_c[i]) * maskk;
            const Ch vf = to_f32(vg[row * ldv + c]) + vr[u][i];
            dv[i] = p * gq[i];
            gv = gq[i] * vf;
          }
          for (int off = CH / 2; off > 0; off >>= 1)
            gv += __shfl_xor_sync(FULL, gv, off);
          if (c < C && c % CH == 0)
            s_e[c / CH] = p * (gv - delta_c[i]) * sc;
        }
        __syncwarp();

        // q/k lanes: dq_full = e k_full, dk_full = e q_full
#pragma unroll
        for (int i = 0; i < NJ; ++i) {
          const int j = lane + WARP * i;
          if (j < DH) {
            const Ch e = s_e[j / D];
            const Ch dqf = e * kf[i], dkf = e * qf[i];
            dq_acc[i] += dqf;
            put(j, dkf);
            put(DH + j, dqf);
            if (slot_ok) store(&dkg[row * DH + j], dkf);
          }
          if (j < C) {
            put(2 * DH + j, dv[i]);
            if (slot_ok) store(&dvg[row * C + j], dv[i]);
          }
        }
        __syncwarp();

        // f32: lanes over edge-feature rows, back through the three
        // projections (bf16: edge_grad_mma below, for the whole block)
        if constexpr (!BF16) {
          for (int e = lane; e < De; e += WARP) {
            const float* wrow = s_w + e * WP;
            Ch sum = 0.f;
            for (int jj = 0; jj < W; ++jj)
              sum = fma_acc(wrow[jj], grad[jj], sum);
            if (slot_ok) store(&d_ef[row * De + e], sum);
          }
        }
        __syncwarp();
      }

      // the block's staged rows into the edge-feature gradient (bf16) and
      // the weight and bias gradients
      __syncthreads();
      if constexpr (BF16)
        edge_grad_mma(L, smem, base, k0, N, K, De, d_ef, warp, lane);
#pragma unroll
      for (int it = 0; it < ITEMS; ++it) {
        const int t = threadIdx.x + THREADS * it;
        if (t < n_items) {
          const int j = t % W, e0 = t / W * EPT;
          for (int r = 0; r < ROWS; ++r) {
            const Ch gr = s_grad[r * W + j];
            const float* er = s_ef + r * DE1P + e0;
#pragma unroll
            for (int ee = 0; ee < EPT; ++ee)
              acc[it][ee] = fma_acc(er[ee], gr, acc[it][ee]);
          }
        }
      }
      __syncthreads();
    }

    if (node_ok) {
#pragma unroll
      for (int i = 0; i < NJ; ++i) {
        const int j = lane + WARP * i;
        if (j < DH) store(&dq[n * DH + j], dq_acc[i]);
      }
    }
  }

#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int t = threadIdx.x + THREADS * it;
    if (t < n_items) {
      const int j = t % W, e0 = t / W * EPT;
#pragma unroll
      for (int ee = 0; ee < EPT; ++ee)
        if (e0 + ee < DE1)
          partial[((long long)blockIdx.x * DE1 + e0 + ee) * W + j] =
              acc[it][ee];
    }
  }
}

// out[i] = sum over blocks of partial[b, i], in block order, in the
// partials' type; rounded to f32 once
template <typename A>
__global__ void reduce_partials(const A* __restrict__ partial, int blocks,
                                int size, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  A s = 0;
  for (int b = 0; b < blocks; ++b) s += partial[(long long)b * size + i];
  out[i] = (float)s;
}

int grid_blocks(int N) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  long long blocks = ((long long)N + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  const long long max_blocks = (long long)(sms > 0 ? sms : 132) * 2;
  return (int)(blocks < max_blocks ? blocks : max_blocks);
}

template <typename T, int NJ, int ITEMS>
cudaError_t launch(int blocks, const void* q, const void* kg, long long ldk,
                   const void* vg, long long ldv, const void* ef,
                   const void* wk, const void* bk, const void* wq,
                   const void* bq, const void* wv, const void* bv,
                   const void* mask, const void* scale, const void* g,
                   const void* lse, const void* delta, void* dq, void* dkg,
                   void* dvg, void* d_ef, void* partial, void* dw, int N,
                   int K, int H, int D, int C, int De, cudaStream_t stream) {
  const int W = 2 * H * D + C;
  const size_t smem =
      Layout(H, D, C, De, std::is_same<T, __nv_bfloat16>::value).total;
  auto kernel = dense_attention_rpe_bwd_kernel<T, NJ, ITEMS>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, THREADS, smem, stream>>>(
      (const T*)q, (const T*)kg, (const T*)vg, (const T*)ef, (const T*)wk,
      (const T*)bk, (const T*)wq, (const T*)bq, (const T*)wv, (const T*)bv,
      (const bool*)mask, (const float*)scale, (const float*)g,
      (const float*)lse, (const float*)delta, (T*)dq, (T*)dkg, (T*)dvg,
      (T*)d_ef, (Acc<T>*)partial, N, K, H, D, C, De, ldk, ldv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int size = (De + 1) * W;
  reduce_partials<Acc<T> ><<<(size + 255) / 256, 256, 0, stream>>>(
      (const Acc<T>*)partial, blocks, size, (float*)dw);
  return cudaGetLastError();
}

template <typename T, int NJ>
cudaError_t dispatch_items(int items, int blocks, const void* q,
                           const void* kg, long long ldk, const void* vg,
                           long long ldv, const void* ef, const void* wk,
                           const void* bk, const void* wq, const void* bq,
                           const void* wv, const void* bv, const void* mask,
                           const void* scale, const void* g, const void* lse,
                           const void* delta, void* dq, void* dkg, void* dvg,
                           void* d_ef, void* partial, void* dw, int N, int K,
                           int H, int D, int C, int De, cudaStream_t st) {
  if (items <= 1)
    return launch<T, NJ, 1>(blocks, q, kg, ldk, vg, ldv, ef, wk, bk, wq, bq,
                            wv, bv, mask, scale, g, lse, delta, dq, dkg, dvg,
                            d_ef, partial, dw, N, K, H, D, C, De, st);
  if (items <= 2)
    return launch<T, NJ, 2>(blocks, q, kg, ldk, vg, ldv, ef, wk, bk, wq, bq,
                            wv, bv, mask, scale, g, lse, delta, dq, dkg, dvg,
                            d_ef, partial, dw, N, K, H, D, C, De, st);
  return launch<T, NJ, MAX_ITEMS>(blocks, q, kg, ldk, vg, ldv, ef, wk, bk, wq,
                                  bq, wv, bv, mask, scale, g, lse, delta, dq,
                                  dkg, dvg, d_ef, partial, dw, N, K, H, D, C,
                                  De, st);
}

template <typename T>
cudaError_t dispatch(int nj, int items, int blocks, const void* q,
                     const void* kg, long long ldk, const void* vg,
                     long long ldv, const void* ef, const void* wk,
                     const void* bk, const void* wq, const void* bq,
                     const void* wv, const void* bv, const void* mask,
                     const void* scale, const void* g, const void* lse,
                     const void* delta, void* dq, void* dkg, void* dvg,
                     void* d_ef, void* partial, void* dw, int N, int K, int H,
                     int D, int C, int De, cudaStream_t st) {
  if (nj <= 1)
    return dispatch_items<T, 1>(items, blocks, q, kg, ldk, vg, ldv, ef, wk,
                                bk, wq, bq, wv, bv, mask, scale, g, lse,
                                delta, dq, dkg, dvg, d_ef, partial, dw, N, K,
                                H, D, C, De, st);
  if (nj <= 2)
    return dispatch_items<T, 2>(items, blocks, q, kg, ldk, vg, ldv, ef, wk,
                                bk, wq, bq, wv, bv, mask, scale, g, lse,
                                delta, dq, dkg, dvg, d_ef, partial, dw, N, K,
                                H, D, C, De, st);
  return dispatch_items<T, 4>(items, blocks, q, kg, ldk, vg, ldv, ef, wk, bk,
                              wq, bq, wv, bv, mask, scale, g, lse, delta, dq,
                              dkg, dvg, d_ef, partial, dw, N, K, H, D, C, De,
                              st);
}

}  // namespace

// Number of blocks the backward launches for N nodes on the current
// device: the first axis of the scratch `partial` [blocks, De+1, W] that
// the caller allocates (W = 2*H*D + C): f32 for bf16 inputs, f64 for
// float32 inputs.
extern "C" int dense_attention_rpe_bwd_blocks(int N) {
  return N > 0 ? grid_blocks(N) : 0;
}

// Plain C entry point for ctypes. `is_bf16` selects the input type
// (0: float32, 1: bfloat16). The caller guarantees H*D <= 128, C <= 128,
// D and C/H powers of two <= 32, (De+1 rounded up to 8) * (2*H*D + C)
// <= 1024 * 8, contiguous q [N, H*D], ef [N, K, De], mask [N, K], scale,
// weights, g [N, C] f32, lse and delta [H, N] f32, kg / vg whose last
// axis is contiguous with slot stride ldk / ldv, contiguous outputs
// dq [N, H*D], dkg [N, K, H*D], dvg [N, K, C], d_ef [N, K, De] of the
// input type, `partial` as `dense_attention_rpe_bwd_blocks(N)` sizes it
// (f64 for float32 inputs),
// and dw [De+1, 2*H*D + C] f32 (rows: edge features, then biases;
// columns: [k | q | v]). Returns the CUDA error of the launches (0 on
// success); they do not synchronize.
extern "C" int dense_attention_rpe_bwd_launch(
    int is_bf16, const void* q, const void* kg, long long ldk,
    const void* vg, long long ldv, const void* ef, const void* wk,
    const void* bk, const void* wq, const void* bq, const void* wv,
    const void* bv, const void* mask, const void* scale, const void* g,
    const void* lse, const void* delta, void* dq, void* dkg, void* dvg,
    void* d_ef, void* partial, void* dw, int N, int K, int H, int D, int C,
    int De, void* stream) {
  if (N == 0) return 0;
  const int DH = H * D, W = 2 * DH + C;
  const int nj = ((DH > C ? DH : C) + WARP - 1) / WARP;
  const int items = (padded_de1(De) / EPT * W + THREADS - 1) / THREADS;
  if (items > MAX_ITEMS) return (int)cudaErrorInvalidValue;
  const int blocks = grid_blocks(N);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = is_bf16
      ? dispatch<__nv_bfloat16>(nj, items, blocks, q, kg, ldk, vg, ldv, ef,
                                wk, bk, wq, bq, wv, bv, mask, scale, g, lse,
                                delta, dq, dkg, dvg, d_ef, partial, dw, N, K,
                                H, D, C, De, st)
      : dispatch<float>(nj, items, blocks, q, kg, ldk, vg, ldv, ef, wk, bk,
                        wq, bq, wv, bv, mask, scale, g, lse, delta, dq, dkg,
                        dvg, d_ef, partial, dw, N, K, H, D, C, De, st);
  return (int)err;
}
