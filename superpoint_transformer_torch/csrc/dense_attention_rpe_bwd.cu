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
// Per-edge gradients are written in the input type; weight and bias
// gradients are f32. The weight gradients reduce over every node, which
// the TPU did on its sequential grid. A CUDA grid has no order and f32
// atomics would make the result vary from run to run, so each block sums
// its slots in a fixed order into partial sums of its own, and a second
// kernel adds the partials in block order: the result is the same in
// every run on a given card.
//
// What bounds it on an H100: per slot it reads the gathered k/v rows and
// the edge features once and writes their gradients once (about 640
// bytes in bf16 at the flagship H=16, D=4, C=64, De=32), and does
// De*(2*H*D + C) = 6,144 multiply-adds three times: the recomputed RPE
// projections, the edge-feature gradient and the weight gradients. The
// bound from bytes is ~0.05 ms at N=5120, K=48; the bf16 kernel takes
// ~0.42 ms there (PERF.md), set by the latency of the per-slot chain
// (~0.33 ms: one block of 8 warps an SM, 255 registers a thread) and the
// weight-gradient FMAs (~0.09 ms).
//
// The bf16 variant (namespace `tiles`) is built on the forward kernel's
// skeleton (dense_attention_rpe.cu, node_tiles.cuh):
//
// - persistent grid, 8 warps a block and one block an SM (~27 KB of
//   shared memory a warp at the flagship widths; 4 warps measured ~2x
//   slower); each warp walks its nodes in tiles of 16 slots. A tile's
//   gathered k/v rows, edge features, the node's query and its cotangent
//   g go into a ring of 2 shared-memory stages with 16-byte cp.async,
//   zero-filled past the last slot, one tile ahead of the compute; the
//   tile's mask bits and the node's scale, lse and delta are loaded into
//   registers one tile ahead too. Rows are padded to an odd number of
//   16-byte chunks so that the fragment loads hit distinct banks. Shapes
//   whose rows are not whole 16-byte chunks are staged by plain loads
//   instead (same layout);
// - the RPE projections of a tile, [16, De] x [De, W] with W the column
//   tiles [k | q | v], run on the tensor cores: mma.sync m16n8k16, bf16
//   operands (exact products), f32 sums started from the biases. The
//   weights live once per block in shared memory as [De, W] bf16; the
//   projection reads its B fragments with ldmatrix.trans and the
//   edge-feature gradient with ldmatrix, so one copy serves both;
// - the per-slot chain stays in the accumulator layout: a lane holds
//   slots g and g+8 (g = lane/4) and the column pair 2*(lane%4) of every
//   8-column tile. Head sums over D (or C/H) columns take at most two
//   shuffles; the per-(slot, head) logits, p, g . v_full and e pass
//   through a small per-warp scratch. The k/q projections are computed
//   again for dk = e q_full and dq = e k_full instead of being held in
//   registers (the tensor cores make that cheaper than the registers);
//   dq sums in registers over the node's tiles and over the 8 slot
//   groups once per node. dk and dv overwrite the tile's own k and v
//   columns in the stage (each lane its own), and the warp stores the
//   tile's dkg and dvg rows from there in 16-byte chunks (paired 4-byte
//   stores from the accumulator layout took ~5% longer);
// - the gradient rows G = [dk_full | dq_full | dv] of a tile go into the
//   warp's own [16, W] tile in f32 (the bytes a bf16 hi + lo pair would
//   take), and the warp takes d_ef = G W^T alone on the tensor cores:
//   each A fragment is split once into hi = bf16(G) and lo = bf16(G - hi)
//   (one bf16 rounding of G breaks K3's tolerance by far:
//   tests/test_torch_k3_precision.py), two mma a k-step;
// - the weight and bias gradients stay on f32 FMAs (on the tensor cores
//   they drifted from an f64 reference by up to 2.35x K3's tolerance and
//   took longer: PERF.md), and read the f32 G: read as hi + lo, the
//   2^-18 relative error of every term put them beyond K3's tolerance.
//   All warps of a block run the same number of tiles (a round each);
//   after each round the block adds the staged [ef | 1]^T G rows of all
//   its warps into register sums (8 edge features x 4 columns a thread):
//   two barriers a round of (warps x 16) slots. Each thread then adds its
//   round sums to its entries of the block's partial sums in device
//   memory, so that no f32 register sum runs over more than one round.
//
// The f32 variant, which the tests and the f32 model check hold to
// autograd in f64, keeps the first design: one warp a node, 2 slots a
// step, the projections and d_ef as FMAs from shared memory, and its
// whole per-slot chain in f64 (the projections, the logit, p, e, every
// product that feeds a gradient and the weight-gradient sums), with lse
// and delta rebuilt in f64 from a first pass over the node's slots; each
// output is rounded to f32 once. With f32 sums over N*K = 245,760 slots
// its worst weight gradient reached 1.54x the tolerance from f64
// autograd over 20 seeds; f64 sums alone left one seed at 1.26x.
#include <cstdint>

#include "node_tiles.cuh"

namespace {

using node_tiles::FULL;
using node_tiles::to_f32;
using node_tiles::WARP;

constexpr int WARPS_PER_BLOCK = 8;
constexpr int THREADS = WARPS_PER_BLOCK * WARP;
constexpr int SLOTS = 2;                          // slots per warp per round
constexpr int ROWS = WARPS_PER_BLOCK * SLOTS;     // slots staged per round
constexpr int EPT = 8;     // edge-feature rows per accumulator item
constexpr int MAX_ITEMS = 4;  // accumulator items per thread

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
// acc + a * b in f64 (the f32 product is exact in f64)
__device__ __forceinline__ double fma_acc(float a, float b, double acc) {
  return fma((double)a, (double)b, acc);
}
__device__ __forceinline__ double fma_acc(float a, double b, double acc) {
  return fma((double)a, b, acc);
}
__device__ __forceinline__ void store(float* p, double v) { *p = (float)v; }

__host__ __device__ inline int padded_de1(int De) {
  return (De + 1 + EPT - 1) / EPT * EPT;
}

__host__ __device__ inline size_t up16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

// Shared-memory layout of the f32 kernel in bytes, the same on host and
// device; every region starts on 16 bytes: the weights [De, W+1] and
// biases [W] in f32, the staged edge features [ROWS, DE1P] in f32, the
// gradient rows [ROWS, W] and the per-warp head scratch in f64.
struct Layout {
  int W, WP, DE1P;
  size_t w, b, ef, grad, head, total;
  __host__ __device__ Layout(int H, int D, int C, int De) {
    W = 2 * H * D + C;
    WP = W + 1;
    DE1P = padded_de1(De);
    size_t o = 0;
    w = o;    o += up16(sizeof(float) * De * WP);
    b = o;    o += up16(sizeof(float) * W);
    ef = o;   o += up16(sizeof(float) * ROWS * DE1P);
    grad = o; o += up16(sizeof(double) * ROWS * W);
    head = o; o += up16(sizeof(double) * WARPS_PER_BLOCK * 2 * H);
    total = o;
  }
};

// The f32 kernel: one warp per node, lanes over the q/k and value
// channels, per-head sums by shuffles (D and C/H powers of two at most
// 32), heads passed between the q/k lanes and the value lanes through
// shared memory; the RPE projections of SLOTS slots share each weight
// load. The weights live once per block in shared memory, [De, W+1]
// (the odd row stride keeps the projection and the edge-feature
// gradient free of bank conflicts). A round stages ROWS = 16 slots of
// the block: each slot's edge features (plus a constant 1, whose row
// gives the bias gradients) and its gradient row G; the whole block adds
// them into a [De+1, W] accumulator of which each thread owns tiles of
// EPT x 1 in registers.
template <int NJ, int ITEMS>
__global__ void __launch_bounds__(THREADS)
dense_attention_rpe_bwd_kernel(
    const float* __restrict__ q,     // [N, H*D]
    const float* __restrict__ kg,    // [N, K, >=H*D], slot stride ldk
    const float* __restrict__ vg,    // [N, K, >=C],   slot stride ldv
    const float* __restrict__ ef,    // [N, K, De]
    const float* __restrict__ wk, const float* __restrict__ bk,
    const float* __restrict__ wq, const float* __restrict__ bq,
    const float* __restrict__ wv, const float* __restrict__ bv,
    const bool* __restrict__ mask,    // [N, K]
    const float* __restrict__ scale,  // [N]
    const float* __restrict__ g,      // [N, C]
    float* __restrict__ dq,           // [N, H*D]
    float* __restrict__ dkg,          // [N, K, H*D]
    float* __restrict__ dvg,          // [N, K, C]
    float* __restrict__ d_ef,         // [N, K, De]
    double* __restrict__ partial,     // [gridDim.x, De+1, W]
    int N, int K, int H, int D, int C, int De, long long ldk,
    long long ldv) {
  extern __shared__ __align__(16) unsigned char smem[];
  using Ch = double;  // the per-slot chain's type
  const Layout L(H, D, C, De);
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
  __syncthreads();

  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  Ch* s_logit = s_head + warp * 2 * H;  // [H]
  Ch* s_e = s_logit + H;                // [H]

  // accumulator item t: edge-feature rows (t / W) * EPT .. + EPT, column
  // t % W
  const int n_items = DE1P / EPT * W;
  Ch acc[ITEMS][EPT];
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
      gq[i] = node_ok && j < C ? g[n * C + j] : 0.f;
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

    // lse and delta of each head in f64, from a first pass over the
    // node's slots: the running max, the sum of exponentials and the sum
    // of exponentials times g . v_full (an online softmax)
    {
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
                const Ch r = exp(mx[i] - logit);
                se[i] = se[i] * r + 1.0;
                te[i] = te[i] * r + gv;
                mx[i] = logit;
              } else {
                const Ch w = exp(logit - mx[i]);
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
            p = exp(logit - lse_c[i]) * maskk;
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
            grad[j] = dkf;
            grad[DH + j] = dqf;
            if (slot_ok) store(&dkg[row * DH + j], dkf);
          }
          if (j < C) {
            grad[2 * DH + j] = dv[i];
            if (slot_ok) store(&dvg[row * C + j], dv[i]);
          }
        }
        __syncwarp();

        // lanes over edge-feature rows, back through the three projections
        for (int e = lane; e < De; e += WARP) {
          const float* wrow = s_w + e * WP;
          Ch sum = 0.f;
          for (int jj = 0; jj < W; ++jj)
            sum = fma_acc(wrow[jj], grad[jj], sum);
          if (slot_ok) store(&d_ef[row * De + e], sum);
        }
        __syncwarp();
      }

      // the block's staged rows into the weight and bias gradients
      __syncthreads();
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

cudaError_t reduce(const void* partial, bool f64, int blocks, int size,
                   void* dw, cudaStream_t stream) {
  if (f64)
    reduce_partials<double><<<(size + 255) / 256, 256, 0, stream>>>(
        (const double*)partial, blocks, size, (float*)dw);
  else
    reduce_partials<float><<<(size + 255) / 256, 256, 0, stream>>>(
        (const float*)partial, blocks, size, (float*)dw);
  return cudaGetLastError();
}

template <int NJ, int ITEMS>
cudaError_t launch_f32(const void* q, const void* kg, long long ldk,
                       const void* vg, long long ldv, const void* ef,
                       const void* wk, const void* bk, const void* wq,
                       const void* bq, const void* wv, const void* bv,
                       const void* mask, const void* scale, const void* g,
                       void* dq, void* dkg, void* dvg, void* d_ef,
                       void* partial, void* dw, int N, int K, int H, int D,
                       int C, int De, cudaStream_t stream) {
  const int blocks = grid_blocks(N);
  const size_t smem = Layout(H, D, C, De).total;
  auto kernel = dense_attention_rpe_bwd_kernel<NJ, ITEMS>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, THREADS, smem, stream>>>(
      (const float*)q, (const float*)kg, (const float*)vg,
      (const float*)ef, (const float*)wk, (const float*)bk,
      (const float*)wq, (const float*)bq, (const float*)wv,
      (const float*)bv, (const bool*)mask, (const float*)scale,
      (const float*)g, (float*)dq, (float*)dkg, (float*)dvg, (float*)d_ef,
      (double*)partial, N, K, H, D, C, De, ldk, ldv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce(partial, true, blocks, (De + 1) * (2 * H * D + C), dw,
                stream);
}

template <int NJ>
cudaError_t dispatch_f32_items(int items, const void* q, const void* kg,
                               long long ldk, const void* vg, long long ldv,
                               const void* ef, const void* wk, const void* bk,
                               const void* wq, const void* bq, const void* wv,
                               const void* bv, const void* mask,
                               const void* scale, const void* g, void* dq,
                               void* dkg, void* dvg, void* d_ef,
                               void* partial, void* dw, int N, int K, int H,
                               int D, int C, int De, cudaStream_t st) {
  if (items <= 1)
    return launch_f32<NJ, 1>(q, kg, ldk, vg, ldv, ef, wk, bk, wq, bq, wv, bv,
                             mask, scale, g, dq, dkg, dvg, d_ef, partial, dw,
                             N, K, H, D, C, De, st);
  if (items <= 2)
    return launch_f32<NJ, 2>(q, kg, ldk, vg, ldv, ef, wk, bk, wq, bq, wv, bv,
                             mask, scale, g, dq, dkg, dvg, d_ef, partial, dw,
                             N, K, H, D, C, De, st);
  return launch_f32<NJ, MAX_ITEMS>(q, kg, ldk, vg, ldv, ef, wk, bk, wq, bq,
                                   wv, bv, mask, scale, g, dq, dkg, dvg,
                                   d_ef, partial, dw, N, K, H, D, C, De, st);
}

cudaError_t dispatch_f32(const void* q, const void* kg, long long ldk,
                         const void* vg, long long ldv, const void* ef,
                         const void* wk, const void* bk, const void* wq,
                         const void* bq, const void* wv, const void* bv,
                         const void* mask, const void* scale, const void* g,
                         void* dq, void* dkg, void* dvg, void* d_ef,
                         void* partial, void* dw, int N, int K, int H, int D,
                         int C, int De, cudaStream_t st) {
  const int DH = H * D, W = 2 * DH + C;
  const int nj = ((DH > C ? DH : C) + WARP - 1) / WARP;
  const int items = (padded_de1(De) / EPT * W + THREADS - 1) / THREADS;
  if (items > MAX_ITEMS) return cudaErrorInvalidValue;
  if (nj <= 1)
    return dispatch_f32_items<1>(items, q, kg, ldk, vg, ldv, ef, wk, bk, wq,
                                 bq, wv, bv, mask, scale, g, dq, dkg, dvg,
                                 d_ef, partial, dw, N, K, H, D, C, De, st);
  if (nj <= 2)
    return dispatch_f32_items<2>(items, q, kg, ldk, vg, ldv, ef, wk, bk, wq,
                                 bq, wv, bv, mask, scale, g, dq, dkg, dvg,
                                 d_ef, partial, dw, N, K, H, D, C, De, st);
  return dispatch_f32_items<4>(items, q, kg, ldk, vg, ldv, ef, wk, bk, wq, bq,
                               wv, bv, mask, scale, g, dq, dkg, dvg, d_ef,
                               partial, dw, N, K, H, D, C, De, st);
}

// ---------------------------------------------------------------------
// The bf16 kernel
// ---------------------------------------------------------------------
namespace tiles {

using namespace node_tiles;
typedef __nv_bfloat16 bf16;

constexpr int MAX_BLOCK_WARPS = 8;  // warps a block at most
constexpr int W_EPT = 8;       // edge features per weight-gradient item
constexpr int W_CPT = 4;       // gradient columns per weight-gradient item
constexpr int MAX_W_ITEMS = 4;  // weight-gradient items per thread
constexpr int MAX_HR = 4;      // heads per lane (H <= 128)

// four (x4) or two (x2) 8x8 b16 matrices from shared memory; lane l gives
// the address of row l % 8 of matrix l / 8; `trans` transposes each
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ uint2 ldmatrix_x2(const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  uint2 r;
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r.x), "=r"(r.y) : "r"(s));
  return r;
}

// the two bf16 of a 32-bit word as f32: element 0 (low half), element 1
__device__ __forceinline__ float bf_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// columns c, c+1 of a row of `width` values, rounded to bf16: one 4-byte
// store when both exist and the pair is aligned (even width, even c)
__device__ __forceinline__ void store_pair(bf16* row, int c, int width,
                                           float a, float b) {
  if (c + 1 < width && (width & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(a, b);
  } else if (c < width) {
    row[c] = __float2bfloat16(a);
    if (c + 1 < width) row[c + 1] = __float2bfloat16(b);
  }
}

// gradient columns c, c+1 into a row of the warp's f32 G tile
__device__ __forceinline__ void put_g(float* row_c, float a, float b) {
  *reinterpret_cast<float2*>(row_c) = make_float2(a, b);
}

// two f32 values as the bf16 pairs hi = bf16(x) and lo = bf16(x - hi),
// packed for an mma operand register each
__device__ __forceinline__ void split2(float2 x, unsigned& hi,
                                       unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x.x, x.y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x.x - hf.x, x.y - hf.y);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// The warp stages `rows` rows of `width` values (row stride dst_ld) from
// src (row stride src_ld) by plain loads, zeros from rows_valid and from
// width_valid on: the path for rows that are not whole 16-byte chunks.
template <typename T>
__device__ __forceinline__ void copy_elems(T* dst, int dst_ld, const T* src,
                                           long long src_ld, int rows_valid,
                                           int rows, int width_valid,
                                           int width, int lane) {
  for (int idx = lane; idx < rows * width; idx += WARP) {
    const int r = idx / width, c = idx - r * width;
    dst[r * dst_ld + c] = r < rows_valid && c < width_valid
        ? src[r * src_ld + c] : T(0.f);
  }
}

// The warp stores `rows` rows of `width` values from shared memory (row
// stride src_ld) to dst (row stride = width): 16 bytes a lane and
// instruction when `vec` (widths and dst in 16-byte chunks), else one
// value.
__device__ __forceinline__ void store_rows(bf16* dst, const bf16* src,
                                           int src_ld, int rows, int width,
                                           bool vec, int lane) {
  if (vec) {
    const int cw = width / 8;
    for (int idx = lane; idx < rows * cw; idx += WARP) {
      const int r = idx / cw, c = (idx - r * cw) * 8;
      *reinterpret_cast<uint4*>(dst + (long long)r * width + c) =
          *reinterpret_cast<const uint4*>(src + r * src_ld + c);
    }
    return;
  }
  for (int idx = lane; idx < rows * width; idx += WARP) {
    const int r = idx / width, c = idx - r * width;
    dst[(long long)r * width + c] = src[r * src_ld + c];
  }
}

// Shared-memory layout in bytes, the same on host and device. Once per
// block: the weights [KS*16, LDW] bf16 (rows: edge features, columns: the
// NT column tiles [k (NK) | q (NK) | v (NV)] of 8, zero past De and past
// each block's width) and their bias [NT*8] f32. Per warp: STAGES stages
// of {k/v tile [TILE, KVS] (k at column 0, v at NK*8), edge tile
// [TILE, EFS], query row [QS] in bf16; the node's cotangent g [NV*8] in
// f32}, the G tile [TILE, LDG] in f32 (the bytes of a bf16 hi and lo
// pair), and the f32 scratch: the tile's logits then p [TILE, H+1], its
// g . v_full then e [TILE, H+1], and the node's lse (log2 units) and
// delta [H] each.
struct Layout {
  int NK, NV, NT, WP, KS, KSA, NTA, KVS, EFS, QS, LDG, ldp;
  size_t bias_off, w_bytes, gst_off, stage_bytes, g_off, s_off, warp_bytes;
  __host__ __device__ Layout(int H, int D, int C, int De, int ks) {
    NK = (H * D + 7) / 8;
    NV = (C + 7) / 8;
    NT = 2 * NK + NV;
    WP = NT * 8;
    KS = ks;                 // k-steps of 16 edge features, KS * 16 >= De
    KSA = (WP + 15) / 16;    // k-steps of 16 gradient columns
    NTA = (De + 7) / 8;      // tiles of 8 edge features
    // rows of an odd number of 16-byte chunks: ldmatrix and the fragment
    // loads of 8 rows hit distinct banks
    KVS = (NK + NV) * 8 + ((NK + NV) % 2 == 0 ? 8 : 16);
    EFS = KS * 16 + 8;
    QS = NK * 8;
    LDG = KSA * 16 + 8;
    ldp = H + 1;
    bias_off = up16(sizeof(bf16) * KS * 16 * LDG);
    w_bytes = bias_off + up16(sizeof(float) * WP);
    gst_off = up16(sizeof(bf16) * (TILE * KVS + TILE * EFS + QS));
    stage_bytes = gst_off + up16(sizeof(float) * NV * 8);
    g_off = STAGES * stage_bytes;
    // LDG * 4 bytes = 8 (mod 32) words: the float2 fragment loads of 4
    // rows (half a warp) hit distinct banks
    s_off = g_off + sizeof(float) * TILE * LDG;
    warp_bytes = s_off + up16(sizeof(float) * (2 * TILE * ldp + 2 * H));
  }
  // weight-gradient items: NTA blocks of 8 edge features x WP / 4 column
  // groups, then WP / 4 bias groups
  __host__ __device__ int items() const { return (NTA + 1) * (WP / W_CPT); }
};

// The accumulator fragment of output column tile jn (bias included):
// slots g, g+8 and columns c, c+1 of the tile (c = 2*(lane%4)), from the
// A fragments `a` of the tile's edge features and the weights' B
// fragments (ldmatrix.trans of rows e, columns 8*jn..+8).
template <int KS>
__device__ __forceinline__ void project(const bf16* w, const float* bias,
                                        int LDW, int jn,
                                        const unsigned (&a)[KS][4], int lane,
                                        float (&d)[4]) {
  const float2 b = *reinterpret_cast<const float2*>(
      bias + 8 * jn + 2 * (lane & 3));
  d[0] = b.x; d[1] = b.y; d[2] = b.x; d[3] = b.y;
#pragma unroll
  for (int ks = 0; ks < KS; ks += 2) {
    unsigned r[4];
    ldmatrix_x4_trans(r, w + (16 * ks + lane) * LDW + 8 * jn);
    mma_bf16(d, a[ks], make_uint2(r[0], r[1]));
    mma_bf16(d, a[ks + 1], make_uint2(r[2], r[3]));
  }
}

// NJ: column tiles per lane for the keys and for the values (H*D <= 8*NJ
// and C <= 8*NJ); KS: k-steps of 16 edge features; ITEMS: weight-gradient
// items per thread
template <int NJ, int KS, int ITEMS>
__global__ void __launch_bounds__(MAX_BLOCK_WARPS * WARP)
rpe_bwd_tiles_kernel(
    const bf16* __restrict__ q,      // [N, H*D]
    const bf16* __restrict__ kg,     // [N, K, >=H*D], slot stride ldk
    const bf16* __restrict__ vg,     // [N, K, >=C],   slot stride ldv
    const bf16* __restrict__ ef,     // [N, K, De]
    const bf16* __restrict__ wk, const bf16* __restrict__ bk,
    const bf16* __restrict__ wq, const bf16* __restrict__ bq,
    const bf16* __restrict__ wv, const bf16* __restrict__ bv,
    const bool* __restrict__ mask,    // [N, K]
    const float* __restrict__ scale,  // [N]
    const float* __restrict__ g,      // [N, C]
    const float* __restrict__ lse,    // [H, N]
    const float* __restrict__ delta,  // [H, N]
    bf16* __restrict__ dq,            // [N, H*D]
    bf16* __restrict__ dkg,           // [N, K, H*D]
    bf16* __restrict__ dvg,           // [N, K, C]
    bf16* __restrict__ d_ef,          // [N, K, De]
    float* __restrict__ partial,      // [gridDim.x, De+1, 2*H*D + C]
    int N, int K, int H, int D, int C, int De, long long ldk, long long ldv,
    bool aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(H, D, C, De, KS);
  const int DH = H * D;
  const int CH = C / H;
  const int nwarps = blockDim.x / WARP;
  const int nthreads = blockDim.x;
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  const int gr = lane >> 2, tq = lane & 3;
  const int LDW = L.LDG;
  // whole 16-byte chunks for the dkg / dvg rows (outputs are allocated
  // aligned)
  const bool vec_out = DH % 8 == 0 && C % 8 == 0;

  // the weights and biases, once per block
  bf16* w_sm = reinterpret_cast<bf16*>(smem);
  float* bias = reinterpret_cast<float*>(smem + L.bias_off);
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < KS * 16 * LDW; i += nthreads) {
    const int e = i / LDW;
    int col = i - e * LDW;
    bf16 w = zero;
    if (e < De && col < L.WP) {
      if (col < 8 * L.NK) {
        if (col < DH) w = wk[e * DH + col];
      } else if ((col -= 8 * L.NK) < 8 * L.NK) {
        if (col < DH) w = wq[e * DH + col];
      } else if ((col -= 8 * L.NK) < C) {
        w = wv[e * C + col];
      }
    }
    w_sm[i] = w;
  }
  for (int i = threadIdx.x; i < L.WP; i += nthreads) {
    int col = i;
    float b = 0.f;
    if (col < 8 * L.NK) {
      b = col < DH ? to_f32(bk[col]) : 0.f;
    } else if ((col -= 8 * L.NK) < 8 * L.NK) {
      b = col < DH ? to_f32(bq[col]) : 0.f;
    } else {
      col -= 8 * L.NK;
      b = col < C ? to_f32(bv[col]) : 0.f;
    }
    bias[i] = b;
  }

  unsigned char* wbase = smem + L.w_bytes + warp * L.warp_bytes;
  auto stage = [&](int slot) {
    return reinterpret_cast<bf16*>(wbase + slot * L.stage_bytes);
  };
  float* gf = reinterpret_cast<float*>(wbase + L.g_off);  // [TILE, LDG]
  float* s_lp = reinterpret_cast<float*>(wbase + L.s_off);
  float* s_e = s_lp + TILE * L.ldp;
  float* s_nd = s_e + TILE * L.ldp;  // lse (log2 units) [H], delta [H]
  const int ldp = L.ldp;
  // the G tile's columns past WP are read by the last k-step: zeros
  for (int i = lane; i < TILE * (L.LDG - L.WP); i += WARP) {
    const int r = i / (L.LDG - L.WP), c = L.WP + i % (L.LDG - L.WP);
    gf[r * L.LDG + c] = 0.f;
  }
  __syncthreads();

  const int tiles = K > TILE ? (K + TILE - 1) / TILE : 1;
  const long long gw0 = (long long)blockIdx.x * nwarps;
  const long long gw = gw0 + warp;
  const long long TW = (long long)gridDim.x * nwarps;
  const int nodes = gw < N ? (int)((N - 1 - gw) / TW) + 1 : 0;
  const int mine = nodes * tiles;
  // every warp of the block runs warp 0's rounds, so that the barriers
  // below are reached by all
  const int rounds = (gw0 < N ? (int)((N - 1 - gw0) / TW) + 1 : 0) * tiles;

  // the copies of round rr's tile into stage rr % STAGES; one commit
  // group a round, empty past the warp's last tile
  auto issue = [&](int rr) {
    if (rr < mine) {
      const int node = rr / tiles, t = rr - node * tiles;
      const long long n = gw + node * TW;
      const int k0 = t * TILE;
      const int rows = K - k0 < TILE ? K - k0 : TILE;
      const long long row0 = n * K + k0;
      bf16* st = stage(rr % STAGES);
      bf16* st_ef = st + TILE * L.KVS;
      bf16* st_q = st_ef + TILE * L.EFS;
      float* st_g = reinterpret_cast<float*>(
          reinterpret_cast<unsigned char*>(st) + L.gst_off);
      if (aligned) {
        copy_rows(st, L.KVS, kg + row0 * ldk, ldk, rows, TILE, DH, 8 * L.NK,
                  lane);
        copy_rows(st + 8 * L.NK, L.KVS, vg + row0 * ldv, ldv, rows, TILE, C,
                  8 * L.NV, lane);
        copy_rows(st_ef, L.EFS, ef + row0 * De, De, rows, TILE, De, KS * 16,
                  lane);
        copy_rows(st_q, L.QS, q + n * DH, 0, 1, 1, DH, L.QS, lane);
        copy_rows(st_g, 8 * L.NV, g + n * C, 0, 1, 1, C, 8 * L.NV, lane);
      } else {
        copy_elems(st, L.KVS, kg + row0 * ldk, ldk, rows, TILE, DH, 8 * L.NK,
                   lane);
        copy_elems(st + 8 * L.NK, L.KVS, vg + row0 * ldv, ldv, rows, TILE, C,
                   8 * L.NV, lane);
        copy_elems(st_ef, L.EFS, ef + row0 * De, De, rows, TILE, De, KS * 16,
                   lane);
        copy_elems(st_q, L.QS, q + n * DH, 0, 1, 1, DH, L.QS, lane);
        copy_elems(st_g, 8 * L.NV, g + n * C, 0, 1, 1, C, 8 * L.NV, lane);
      }
    }
    cp_async_commit();
  };
  // round rr's mask bit (lanes < TILE) and, at a node's first tile, its
  // scale, lse and delta: loaded a round ahead (g comes with the tile)
  bool nx_ok = false;
  float nx_scale = 0.f, nx_lse[MAX_HR], nx_delta[MAX_HR];
  auto meta = [&](int rr) {
    if (rr < mine) {
      const int node = rr / tiles, t = rr - node * tiles;
      const long long n = gw + node * TW;
      const int k = t * TILE + lane;
      nx_ok = lane < TILE && k < K && mask[n * K + k];
      if (t == 0) {
        nx_scale = scale[n];
#pragma unroll
        for (int i = 0; i < MAX_HR; ++i) {
          const int h = lane + WARP * i;
          nx_lse[i] = h < H ? lse[(long long)h * N + n] : 0.f;
          nx_delta[i] = h < H ? delta[(long long)h * N + n] : 0.f;
        }
      }
    }
  };

  const int dshift = __ffs(D) - 1;     // D = 1 << dshift
  const int dg = D < 8 ? D : 8;        // a head's columns within one tile
  const int cshift = __ffs(CH) - 1;    // C/H = 1 << cshift
  const int cg = CH < 8 ? CH : 8;
  auto clamp_h = [&](int h) { return h < H ? h : H - 1; };

  float sc = 0.f, dq_acc[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j) dq_acc[j][0] = dq_acc[j][1] = 0.f;
  float acc[ITEMS][W_EPT][W_CPT];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it)
#pragma unroll
    for (int ee = 0; ee < W_EPT; ++ee)
#pragma unroll
      for (int cc = 0; cc < W_CPT; ++cc) acc[it][ee][cc] = 0.f;
  const int n_w = L.NTA * (L.WP / W_CPT);   // weight items; then biases

  // The block's partial sums [De+1, 2*H*D + C] live in device memory: after
  // each round a thread adds the round's register sums (warps x 16 rows)
  // into its own entries there and restarts them from zero. Summing all
  // of the block's slots in registers (~1,900 rows a sum at N=5120) put
  // the weight gradients up to 0.94x K3's tolerance from f64 (0.77x so).
  const int W = 2 * DH + C;
  auto column = [&](int col) {  // padded column -> output column, or -1
    if (col < 8 * L.NK) return col < DH ? col : -1;
    col -= 8 * L.NK;
    if (col < 8 * L.NK) return col < DH ? DH + col : -1;
    col -= 8 * L.NK;
    return col < C ? 2 * DH + col : -1;
  };
  float* out = partial + (long long)blockIdx.x * (De + 1) * W;
  // after each round, add the register sums to this thread's entries of
  // the partial sums (all loads first: one memory latency) and restart
  // them from zero
  auto flush = [&](bool first) {
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int item = threadIdx.x + nthreads * it;
      if (item < n_w + L.WP / W_CPT) {
        const bool w_item = item < n_w;
        const int eb = w_item ? item / (L.WP / W_CPT) : 0;
        const int c0 = W_CPT * (w_item ? item - eb * (L.WP / W_CPT)
                                       : item - n_w);
        const int e0 = w_item ? W_EPT * eb : De;
        const int rows = w_item ? min(W_EPT, De - e0) : 1;
        int col[W_CPT];
        float prev[W_EPT][W_CPT];
#pragma unroll
        for (int cc = 0; cc < W_CPT; ++cc) {
          col[cc] = column(c0 + cc);
#pragma unroll
          for (int ee = 0; ee < W_EPT; ++ee)
            prev[ee][cc] = !first && col[cc] >= 0 && ee < rows
                ? out[(long long)(e0 + ee) * W + col[cc]] : 0.f;
        }
#pragma unroll
        for (int cc = 0; cc < W_CPT; ++cc)
#pragma unroll
          for (int ee = 0; ee < W_EPT; ++ee)
            if (col[cc] >= 0 && ee < rows)
              out[(long long)(e0 + ee) * W + col[cc]] =
                  prev[ee][cc] + acc[it][ee][cc];
      }
#pragma unroll
      for (int ee = 0; ee < W_EPT; ++ee)
#pragma unroll
        for (int cc = 0; cc < W_CPT; ++cc) acc[it][ee][cc] = 0.f;
    }
  };

  meta(0);
  issue(0);
  for (int rr = 0; rr < rounds; ++rr) {
    issue(rr + 1);
    if (rr < mine) {  // warp-uniform
      const int node = rr / tiles, t = rr - node * tiles;
      const long long n = gw + node * TW;
      const int k0 = t * TILE;
      const unsigned valid = __ballot_sync(FULL, nx_ok);
      if (t == 0) {
        sc = nx_scale;
#pragma unroll
        for (int i = 0; i < MAX_HR; ++i) {
          const int h = lane + WARP * i;
          if (h < H) {
            s_nd[h] = nx_lse[i] * LOG2E;
            s_nd[H + h] = nx_delta[i];
          }
        }
      }
      meta(rr + 1);
      cp_async_wait<STAGES - 1>();
      __syncwarp();
      bf16* st_kv = stage(rr % STAGES);
      const bf16* st_ef = st_kv + TILE * L.KVS;
      const bf16* st_q = st_ef + TILE * L.EFS;
      const float* st_g = reinterpret_cast<const float*>(
          reinterpret_cast<const unsigned char*>(st_kv) + L.gst_off);
      const bool ok0 = k0 + gr < K, ok8 = k0 + gr + 8 < K;
      const long long row0 = n * K + k0 + gr, row8 = row0 + 8;

      // A fragments of the tile's edge features
      unsigned a[KS][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldmatrix_x4(a[ks], st_ef + (lane & 15) * L.EFS + 8 * (lane >> 4)
                               + 16 * ks);

      // logits of slots g, g+8 in log2 units (k and q column tiles, head
      // sums over D columns)
      const float sc2 = sc * LOG2E;
      float part0 = 0.f, part1 = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j < L.NK) {
          float rk[4], rq[4];
          project<KS>(w_sm, bias, LDW, j, a, lane, rk);
          project<KS>(w_sm, bias, LDW, L.NK + j, a, lane, rq);
          const int c = 8 * j + 2 * tq;
          const float2 k0v = load2(st_kv + gr * L.KVS + c);
          const float2 k8v = load2(st_kv + (gr + 8) * L.KVS + c);
          const float2 qv = load2(st_q + c);
          const float p00 = (qv.x + rq[0]) * (k0v.x + rk[0]);
          const float p01 = (qv.y + rq[1]) * (k0v.y + rk[1]);
          const float p10 = (qv.x + rq[2]) * (k8v.x + rk[2]);
          const float p11 = (qv.y + rq[3]) * (k8v.y + rk[3]);
          if (D == 1) {
            if (c < DH) {
              s_lp[gr * ldp + c] = p00 * sc2;
              s_lp[(gr + 8) * ldp + c] = p10 * sc2;
            }
            if (c + 1 < DH) {
              s_lp[gr * ldp + c + 1] = p01 * sc2;
              s_lp[(gr + 8) * ldp + c + 1] = p11 * sc2;
            }
          } else {
            part0 += p00 + p01;
            part1 += p10 + p11;
            if ((((j + 1) * 8) & (D - 1)) == 0) {  // this tile ends a head
              for (int off = 1; off < dg / 2; off <<= 1) {
                part0 += __shfl_xor_sync(FULL, part0, off);
                part1 += __shfl_xor_sync(FULL, part1, off);
              }
              const int h = c >> dshift;
              if (((2 * tq) & (dg - 1)) == 0 && h < H) {
                s_lp[gr * ldp + h] = part0 * sc2;
                s_lp[(gr + 8) * ldp + h] = part1 * sc2;
              }
              part0 = part1 = 0.f;
            }
          }
        }
      }
      __syncwarp();

      // p = exp(scale * logit - lse), 0 where the slot is masked
      for (int idx = lane; idx < TILE * H; idx += WARP) {
        const int r = idx / H, h = idx - r * H;
        float* x = s_lp + r * ldp + h;
        *x = (valid >> r & 1u) ? fast_exp2(*x - s_nd[h]) : 0.f;
      }
      __syncwarp();

      // value column tiles: dv = p g (stored, and into G), and
      // g . v_full summed over each head's C/H columns
      float gp0 = 0.f, gp1 = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j < L.NV) {
          float rv[4];
          project<KS>(w_sm, bias, LDW, 2 * L.NK + j, a, lane, rv);
          const int c = 8 * j + 2 * tq;
          const float2 v0 = load2(st_kv + gr * L.KVS + 8 * L.NK + c);
          const float2 v8 = load2(st_kv + (gr + 8) * L.KVS + 8 * L.NK + c);
          const float2 gg = load2(st_g + c);
          const float ga = gg.x, gb = gg.y;
          const int h0 = clamp_h(c >> cshift), h1 = clamp_h((c + 1) >> cshift);
          const float d00 = s_lp[gr * ldp + h0] * ga;
          const float d01 = s_lp[gr * ldp + h1] * gb;
          const float d10 = s_lp[(gr + 8) * ldp + h0] * ga;
          const float d11 = s_lp[(gr + 8) * ldp + h1] * gb;
          // dv in place of the slot's v columns (this lane's own)
          *reinterpret_cast<__nv_bfloat162*>(
              st_kv + gr * L.KVS + 8 * L.NK + c) =
              __floats2bfloat162_rn(d00, d01);
          *reinterpret_cast<__nv_bfloat162*>(
              st_kv + (gr + 8) * L.KVS + 8 * L.NK + c) =
              __floats2bfloat162_rn(d10, d11);
          const int gc = 8 * (2 * L.NK + j) + 2 * tq;
          put_g(gf + gr * L.LDG + gc, d00, d01);
          put_g(gf + (gr + 8) * L.LDG + gc, d10, d11);
          const float t00 = ga * (v0.x + rv[0]), t01 = gb * (v0.y + rv[1]);
          const float t10 = ga * (v8.x + rv[2]), t11 = gb * (v8.y + rv[3]);
          if (CH == 1) {
            if (c < C) {
              s_e[gr * ldp + c] = t00;
              s_e[(gr + 8) * ldp + c] = t10;
            }
            if (c + 1 < C) {
              s_e[gr * ldp + c + 1] = t01;
              s_e[(gr + 8) * ldp + c + 1] = t11;
            }
          } else {
            gp0 += t00 + t01;
            gp1 += t10 + t11;
            if ((((j + 1) * 8) & (CH - 1)) == 0) {  // this tile ends a head
              for (int off = 1; off < cg / 2; off <<= 1) {
                gp0 += __shfl_xor_sync(FULL, gp0, off);
                gp1 += __shfl_xor_sync(FULL, gp1, off);
              }
              const int h = c >> cshift;
              if (((2 * tq) & (cg - 1)) == 0 && h < H) {
                s_e[gr * ldp + h] = gp0;
                s_e[(gr + 8) * ldp + h] = gp1;
              }
              gp0 = gp1 = 0.f;
            }
          }
        }
      }
      __syncwarp();

      // e = p (g . v_full - delta) scale
      for (int idx = lane; idx < TILE * H; idx += WARP) {
        const int r = idx / H, h = idx - r * H;
        const int o = r * ldp + h;
        s_e[o] = s_lp[o] * (s_e[o] - s_nd[H + h]) * sc;
      }
      __syncwarp();

      // k and q column tiles again: dk = e q_full (stored, and into G),
      // dq_full = e k_full (into G, and summed into dq)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j < L.NK) {
          float rk[4], rq[4];
          project<KS>(w_sm, bias, LDW, j, a, lane, rk);
          project<KS>(w_sm, bias, LDW, L.NK + j, a, lane, rq);
          const int c = 8 * j + 2 * tq;
          const float2 k0v = load2(st_kv + gr * L.KVS + c);
          const float2 k8v = load2(st_kv + (gr + 8) * L.KVS + c);
          const float2 qv = load2(st_q + c);
          const int h0 = clamp_h(c >> dshift), h1 = clamp_h((c + 1) >> dshift);
          const float e00 = s_e[gr * ldp + h0], e01 = s_e[gr * ldp + h1];
          const float e10 = s_e[(gr + 8) * ldp + h0];
          const float e11 = s_e[(gr + 8) * ldp + h1];
          const float dk00 = e00 * (qv.x + rq[0]), dk01 = e01 * (qv.y + rq[1]);
          const float dk10 = e10 * (qv.x + rq[2]), dk11 = e11 * (qv.y + rq[3]);
          const float dq00 = e00 * (k0v.x + rk[0]);
          const float dq01 = e01 * (k0v.y + rk[1]);
          const float dq10 = e10 * (k8v.x + rk[2]);
          const float dq11 = e11 * (k8v.y + rk[3]);
          dq_acc[j][0] += dq00 + dq10;
          dq_acc[j][1] += dq01 + dq11;
          // dk in place of the slot's k columns (this lane's own)
          *reinterpret_cast<__nv_bfloat162*>(st_kv + gr * L.KVS + c) =
              __floats2bfloat162_rn(dk00, dk01);
          *reinterpret_cast<__nv_bfloat162*>(st_kv + (gr + 8) * L.KVS + c) =
              __floats2bfloat162_rn(dk10, dk11);
          put_g(gf + gr * L.LDG + c, dk00, dk01);
          put_g(gf + (gr + 8) * L.LDG + c, dk10, dk11);
          const int qc = 8 * (L.NK + j) + 2 * tq;
          put_g(gf + gr * L.LDG + qc, dq00, dq01);
          put_g(gf + (gr + 8) * L.LDG + qc, dq10, dq11);
        }
      }
      __syncwarp();

      // the tile's dkg and dvg rows, staged in the k/v tile, in whole rows
      {
        const int rows = K - k0 < TILE ? K - k0 : TILE;
        store_rows(dkg + (n * K + k0) * DH, st_kv, L.KVS, rows, DH, vec_out,
                   lane);
        store_rows(dvg + (n * K + k0) * C, st_kv + 8 * L.NK, L.KVS, rows, C,
                   vec_out, lane);
      }

      // d_ef = G W^T for the tile: k-steps of 16 gradient columns, each
      // A fragment split into bf16 hi + lo once for every tile of 8 edge
      // features (two mma a k-step and tile)
      {
        float dh[2 * KS][4], dl[2 * KS][4];
#pragma unroll
        for (int nt = 0; nt < 2 * KS; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) dh[nt][i] = dl[nt][i] = 0.f;
        const float* g0 = gf + gr * L.LDG + 2 * tq;
        const float* g8 = g0 + 8 * L.LDG;
        const bf16* wb = w_sm + (lane & 7) * LDW + 8 * ((lane >> 3) & 1);
        for (int ks = 0; ks < L.KSA; ++ks) {
          unsigned ah[4], al[4];
          split2(load2(g0 + 16 * ks), ah[0], al[0]);
          split2(load2(g8 + 16 * ks), ah[1], al[1]);
          split2(load2(g0 + 16 * ks + 8), ah[2], al[2]);
          split2(load2(g8 + 16 * ks + 8), ah[3], al[3]);
#pragma unroll
          for (int nt = 0; nt < 2 * KS; ++nt) {
            if (nt < L.NTA) {
              const uint2 b = ldmatrix_x2(wb + 8 * nt * LDW + 16 * ks);
              mma_bf16(dh[nt], ah, b);
              mma_bf16(dl[nt], al, b);
            }
          }
        }
#pragma unroll
        for (int nt = 0; nt < 2 * KS; ++nt) {
          const int e = 8 * nt + 2 * tq;
          if (nt < L.NTA && ok0)
            store_pair(d_ef + row0 * De, e, De, dh[nt][0] + dl[nt][0],
                       dh[nt][1] + dl[nt][1]);
          if (nt < L.NTA && ok8)
            store_pair(d_ef + row8 * De, e, De, dh[nt][2] + dl[nt][2],
                       dh[nt][3] + dl[nt][3]);
        }
      }

      // end of the node: dq summed over the 8 slot groups; the lanes of
      // slot group g write the column tiles j = g (mod 8)
      if (t == tiles - 1) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
#pragma unroll
          for (int off = 4; off < WARP; off <<= 1) {
            dq_acc[j][0] += __shfl_xor_sync(FULL, dq_acc[j][0], off);
            dq_acc[j][1] += __shfl_xor_sync(FULL, dq_acc[j][1], off);
          }
          if (j < L.NK && (j & 7) == gr)
            store_pair(dq + n * DH, 8 * j + 2 * tq, DH, dq_acc[j][0],
                       dq_acc[j][1]);
          dq_acc[j][0] = dq_acc[j][1] = 0.f;
        }
      }
    }

    // the round's staged rows of every live warp into the weight and
    // bias gradients: acc[e][c] += ef[r][e] * G[r][c] over the rows, in
    // a fixed order
    __syncthreads();
    {
      const long long left = N - gw0 - (long long)(rr / tiles) * TW;
      const int live = left < nwarps ? (int)left : nwarps;
      const int slot = rr % STAGES;
#pragma unroll
      for (int it = 0; it < ITEMS; ++it) {
        const int item = threadIdx.x + nthreads * it;
        const bool w_item = item < n_w;
        if (item < n_w + L.WP / W_CPT) {
          const int eb = w_item ? item / (L.WP / W_CPT) : 0;
          const int c0 = W_CPT * (w_item ? item - eb * (L.WP / W_CPT)
                                         : item - n_w);
          for (int w = 0; w < live; ++w) {
            const unsigned char* wb = smem + L.w_bytes + w * L.warp_bytes;
            const bf16* er = reinterpret_cast<const bf16*>(
                wb + slot * L.stage_bytes) + TILE * L.KVS + W_EPT * eb;
            const float* gw_ = reinterpret_cast<const float*>(wb + L.g_off)
                + c0;
            if (w_item) {
#pragma unroll
              for (int r = 0; r < TILE; ++r) {
                const float4 gv4 = *reinterpret_cast<const float4*>(
                    gw_ + r * L.LDG);
                const float gcol[W_CPT] = {gv4.x, gv4.y, gv4.z, gv4.w};
                const uint4 ev = *reinterpret_cast<const uint4*>(
                    er + r * L.EFS);
                const float efv[W_EPT] = {
                    bf_lo(ev.x), bf_hi(ev.x), bf_lo(ev.y), bf_hi(ev.y),
                    bf_lo(ev.z), bf_hi(ev.z), bf_lo(ev.w), bf_hi(ev.w)};
#pragma unroll
                for (int ee = 0; ee < W_EPT; ++ee)
#pragma unroll
                  for (int cc = 0; cc < W_CPT; ++cc)
                    acc[it][ee][cc] = fmaf(efv[ee], gcol[cc],
                                           acc[it][ee][cc]);
              }
            } else {
#pragma unroll
              for (int r = 0; r < TILE; ++r) {
                const float4 gv4 = *reinterpret_cast<const float4*>(
                    gw_ + r * L.LDG);
                acc[it][0][0] += gv4.x;
                acc[it][0][1] += gv4.y;
                acc[it][0][2] += gv4.z;
                acc[it][0][3] += gv4.w;
              }
            }
          }
        }
      }
    }
    flush(rr == 0);
    __syncthreads();
  }
  cp_async_wait<0>();
}

// Weight-gradient items a thread for the widest shapes of (NJ, KS):
// (2*KS + 1) * 6*NJ items over the block's threads (at most 4 warps fit
// at 16 column tiles), rounded up to 1, 2 or 4
constexpr int w_items(int NJ, int KS) {
  const int warps = NJ == 16 && MAX_BLOCK_WARPS > 4 ? 4 : MAX_BLOCK_WARPS;
  const int n = ((2 * KS + 1) * 6 * NJ + WARP * warps - 1) / (WARP * warps);
  return n <= 1 ? 1 : n <= 2 ? 2 : MAX_W_ITEMS;
}

// The launch of one instantiation: warps a block (as many as fit in
// shared memory, at most MAX_BLOCK_WARPS), weight-gradient items a
// thread, and a persistent grid. `blocks` alone is set when `launch` is
// false.
template <int NJ, int KS, int ITEMS>
cudaError_t run(bool launch, int* blocks, const void* q,
                const void* kg, long long ldk, const void* vg, long long ldv,
                const void* ef, const void* wk, const void* bk,
                const void* wq, const void* bq, const void* wv,
                const void* bv, const void* mask, const void* scale,
                const void* g, const void* lse, const void* delta, void* dq,
                void* dkg, void* dvg, void* d_ef, void* partial, void* dw,
                int N, int K, int H, int D, int C, int De,
                cudaStream_t stream) {
  const Layout L(H, D, C, De, KS);
  int warps = warps_that_fit(L.w_bytes, L.warp_bytes);
  if (warps > MAX_BLOCK_WARPS) warps = MAX_BLOCK_WARPS;
  if (warps < 1) return cudaErrorInvalidValue;
  const int items = (L.items() + warps * WARP - 1) / (warps * WARP);
  if (items > ITEMS) return cudaErrorInvalidValue;
  const size_t smem = L.w_bytes + warps * L.warp_bytes;
  auto kernel = rpe_bwd_tiles_kernel<NJ, KS, ITEMS>;
  cudaError_t err =
      persistent_grid(kernel, warps * WARP, smem, N, warps, blocks);
  if (err != cudaSuccess || !launch) return err;
  const bool aligned = H * D % 8 == 0 && C % 8 == 0 && De % 8 == 0
      && ldk % 8 == 0 && ldv % 8 == 0
      && ((uintptr_t)q | (uintptr_t)kg | (uintptr_t)vg | (uintptr_t)ef
          | (uintptr_t)g) % 16 == 0;
  kernel<<<*blocks, warps * WARP, smem, stream>>>(
      (const bf16*)q, (const bf16*)kg, (const bf16*)vg, (const bf16*)ef,
      (const bf16*)wk, (const bf16*)bk, (const bf16*)wq, (const bf16*)bq,
      (const bf16*)wv, (const bf16*)bv, (const bool*)mask,
      (const float*)scale, (const float*)g, (const float*)lse,
      (const float*)delta, (bf16*)dq, (bf16*)dkg, (bf16*)dvg, (bf16*)d_ef,
      (float*)partial, N, K, H, D, C, De, ldk, ldv, aligned);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce(partial, false, *blocks, (De + 1) * (2 * H * D + C), dw,
                stream);
}

// the instantiation for a shape: NJ column tiles a lane from the wider of
// H*D and C, KS k-steps from De (at most 64)
cudaError_t dispatch(bool launch, int* blocks, const void* q, const void* kg,
                     long long ldk, const void* vg, long long ldv,
                     const void* ef, const void* wk, const void* bk,
                     const void* wq, const void* bq, const void* wv,
                     const void* bv, const void* mask, const void* scale,
                     const void* g, const void* lse, const void* delta,
                     void* dq, void* dkg, void* dvg, void* d_ef,
                     void* partial, void* dw, int N, int K, int H, int D,
                     int C, int De, cudaStream_t st) {
  if (De > 64 || H > MAX_HR * WARP) return cudaErrorInvalidValue;
  const int width = H * D > C ? H * D : C;
#define RPE_BWD_RUN(NJ, KS)                                                  \
  return run<NJ, KS, w_items(NJ, KS)>(                                       \
      launch, blocks, q, kg, ldk, vg, ldv, ef, wk, bk, wq, bq, wv, bv, mask, \
      scale, g, lse, delta, dq, dkg, dvg, d_ef, partial, dw, N, K, H, D, C,  \
      De, st)
  if (De <= 32) {
    if (width <= 32) RPE_BWD_RUN(4, 2);
    if (width <= 64) RPE_BWD_RUN(8, 2);
    RPE_BWD_RUN(16, 2);
  }
  if (width <= 32) RPE_BWD_RUN(4, 4);
  if (width <= 64) RPE_BWD_RUN(8, 4);
  RPE_BWD_RUN(16, 4);
#undef RPE_BWD_RUN
}

}  // namespace tiles

}  // namespace

// Number of blocks the backward launches for these sizes on the current
// device: the first axis of the scratch `partial` [blocks, De+1, W] that
// the caller allocates (W = 2*H*D + C; f32 for bf16 inputs, f64 for
// float32 inputs). 0 for N = 0; -1 when the bf16 kernel cannot take the
// shape (De > 64, or its tiles do not fit in shared memory).
extern "C" int dense_attention_rpe_bwd_blocks(int is_bf16, int N, int K,
                                              int H, int D, int C, int De) {
  if (N <= 0) return 0;
  if (!is_bf16) return grid_blocks(N);
  int blocks = 0;
  const cudaError_t err = tiles::dispatch(
      false, &blocks, nullptr, nullptr, 0, nullptr, 0, nullptr, nullptr,
      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
      N, K, H, D, C, De, nullptr);
  return err == cudaSuccess ? blocks : -1;
}

// Plain C entry point for ctypes. `is_bf16` selects the input type
// (0: float32, 1: bfloat16). The caller guarantees H*D <= 128, C <= 128,
// D and C/H powers of two <= 32, contiguous q [N, H*D], ef [N, K, De],
// mask [N, K], scale, weights, g [N, C] f32, lse and delta [H, N] f32,
// kg / vg whose last axis is contiguous with slot stride ldk / ldv,
// contiguous outputs dq [N, H*D], dkg [N, K, H*D], dvg [N, K, C],
// d_ef [N, K, De] of the input type, `partial` as
// `dense_attention_rpe_bwd_blocks` sizes it, and dw [De+1, 2*H*D + C]
// f32 (rows: edge features, then biases; columns: [k | q | v]). float32
// also needs (De+1 rounded up to 8) * (2*H*D + C) <= 1024 * 8; bfloat16
// needs a positive block count from `dense_attention_rpe_bwd_blocks`.
// Returns the CUDA error of the launches (0 on success); they do not
// synchronize.
extern "C" int dense_attention_rpe_bwd_launch(
    int is_bf16, const void* q, const void* kg, long long ldk,
    const void* vg, long long ldv, const void* ef, const void* wk,
    const void* bk, const void* wq, const void* bq, const void* wv,
    const void* bv, const void* mask, const void* scale, const void* g,
    const void* lse, const void* delta, void* dq, void* dkg, void* dvg,
    void* d_ef, void* partial, void* dw, int N, int K, int H, int D, int C,
    int De, void* stream) {
  if (N == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (!is_bf16)
    return (int)dispatch_f32(q, kg, ldk, vg, ldv, ef, wk, bk, wq, bq, wv, bv,
                             mask, scale, g, dq, dkg, dvg, d_ef, partial, dw,
                             N, K, H, D, C, De, st);
  int blocks = 0;
  return (int)tiles::dispatch(true, &blocks, q, kg, ldk, vg, ldv, ef, wk, bk,
                              wq, bq, wv, bv, mask, scale, g, lse, delta, dq,
                              dkg, dvg, d_ef, partial, dw, N, K, H, D, C, De,
                              st);
}
