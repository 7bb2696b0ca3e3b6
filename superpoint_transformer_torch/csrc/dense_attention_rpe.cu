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
// out = 0. Inputs are f32 or bf16; all sums are f32.
//
// What bounds it on an H100: the gathered keys, values and edge features
// are read once ((H*D + C + De) values per slot, 320 bytes in bf16 at the
// flagship H=16, D=4, C=64, De=32), and the [N, K, H*D] RPE tensors are
// never written: device-memory bytes, about 48 us for N=10240, K=48. The
// RPE projections are De*(2*H*D + C) multiply-adds per slot, 6 GFLOP at
// that shape: on the CUDA cores (this kernel's first design) their
// instructions bound the kernel before memory does.
//
// Design (node_tiles.cuh has the shared pieces):
// - 16 warps a block and one block an SM (128 registers a thread, ~217 KB
//   of shared memory at the flagship shape): more warps hide the latency
//   of a tile's dependent chain better than more work per warp (two
//   16-slot blocks a stage with 8 warps measured slower).
// - Persistent grid, one pipeline per warp: the warp walks its nodes in
//   tiles of 16 slots; each tile's gathered k/v rows, edge features and
//   the node's query are copied into a ring of 2 shared-memory stages with
//   16-byte cp.async, one tile ahead of the compute; the tile's mask and
//   the node's scale are loaded a tile ahead too. The k/v and edge rows
//   are padded by 16 bytes so that the fragment loads below are free of
//   bank conflicts.
// - The RPE projections of a tile, [16, De] x [De, 2*H*D + C], run on the
//   tensor cores in the bf16 variant: mma.sync m16n8k16 with f32
//   accumulation (bf16 x bf16 products are exact in f32, so this is the
//   plain version's math up to the order of the sums). The weights are
//   staged once per block in the order of the B fragments (one 8-byte
//   load per mma) and the biases start the accumulators. The f32 variant,
//   which only the tests and the f32 model check use, computes the same
//   fragments with FMAs on the CUDA cores: TF32 products would break the
//   kernel's tolerance.
// - In the accumulator layout a lane holds slots g and g+8 (g = lane/4)
//   and the column pair 2*(lane%4) of every 8-column tile. The lane adds
//   the gathered keys and the node query to its key and query columns,
//   multiplies them, and sums each head's D columns with at most two
//   shuffles; the per-(slot, head) logits go to shared memory. The lanes
//   of each head then take the tile's exact softmax and merge it with the
//   node's earlier tiles. The value columns come out of the same
//   accumulator layout: each lane adds its slots' weighted values to
//   running sums, which are reduced over the 8 slot groups once per node.
#include <type_traits>

#include "node_tiles.cuh"

namespace {

using namespace node_tiles;

// Shared-memory layout, the same on host and device. The weights region
// (once per block) holds the concatenated projection [De, NT*8] for the
// column tiles [k (NK) | q (NK) | v (NV)], as B fragments in bf16 (KS
// k-steps, the edge features zero-padded to KS * 16) or row major in
// f32, and its bias in f32. Each warp then has STAGES stages of
// {kv tile [TILE, KVS], edge tile [TILE, EFS], query row [QS]} in the
// input type, and its softmax scratch.
struct Layout {
  int NK, NV, NT, KS, KVS, EFS, QS;
  size_t frag_bytes, w_bytes, stage_bytes, warp_bytes;
  __host__ __device__ Layout(int H, int D, int C, int De, int elem,
                             int ks) {
    const int DH = H * D;
    NK = (DH + 7) / 8;
    NV = (C + 7) / 8;
    NT = 2 * NK + NV;
    KS = ks;  // k-steps of 16 edge features (bf16), KS * 16 >= De
    const bool bf16 = elem == 2;
    const int de_pad = bf16 ? KS * 16 : (De + 3) / 4 * 4;
    KVS = DH + C + 8;
    EFS = de_pad + 8;
    QS = NK * 8;
    frag_bytes = bf16 ? (size_t)NT * KS * WARP * 8
                      : (size_t)De * NT * 8 * sizeof(float);
    w_bytes = frag_bytes + (size_t)NT * 8 * sizeof(float);
    stage_bytes = ((size_t)(TILE * KVS + TILE * EFS + QS) * elem + 15)
        / 16 * 16;
    warp_bytes = STAGES * stage_bytes
        + ((size_t)(TILE * (H + 1) + 2 * H) * sizeof(float) + 15) / 16
        * 16;
  }
};

// The accumulator fragment of output column tile jn (bias included) for
// slots g, g+8 and columns c, c+1 of the tile (c = 2*(lane%4)): on the
// tensor cores from the A fragments `a` in bf16, with FMAs from the edge
// tile in f32.
template <typename T, int KS>
__device__ __forceinline__ void project(const unsigned char* w,
                                        const float* bias, int NT, int De,
                                        int EFS, int jn,
                                        const unsigned (&a)[KS][4],
                                        const T* st_ef, int lane,
                                        float (&d)[4]) {
  const int c = 8 * jn + 2 * (lane & 3);
  const float2 b = *reinterpret_cast<const float2*>(bias + c);
  d[0] = b.x; d[1] = b.y; d[2] = b.x; d[3] = b.y;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const uint2* frag = reinterpret_cast<const uint2*>(w)
        + jn * KS * WARP + lane;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) mma_bf16(d, a[ks], frag[ks * WARP]);
  } else {
    const float* wf = reinterpret_cast<const float*>(w) + c;
    const int ldw = NT * 8;
    const float* e0 = st_ef + (lane >> 2) * EFS;
    const float* e1 = e0 + 8 * EFS;
    for (int e = 0; e < De; ++e) {
      const float2 we = *reinterpret_cast<const float2*>(wf + e * ldw);
      d[0] = fmaf(e0[e], we.x, d[0]);
      d[1] = fmaf(e0[e], we.y, d[1]);
      d[2] = fmaf(e1[e], we.x, d[2]);
      d[3] = fmaf(e1[e], we.y, d[3]);
    }
  }
}

// NJ: column tiles per lane for the keys and for the values,
// H*D <= 8 * NJ and C <= 8 * NJ; KS: k-steps of 16 edge features (bf16)
template <typename T, int NJ, int KS>
__global__ void __launch_bounds__(MAX_WARPS * WARP)
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
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  const Layout L(H, D, C, De, sizeof(T), KS);
  const int DH = H * D;
  const int CH = C / H;
  const int nwarps = blockDim.x / WARP;
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  const int g = lane >> 2, tq = lane & 3;

  // the projection weights and biases, once per block
  auto weight = [&](int e, int col) -> float {
    if (e >= De) return 0.f;
    if (col < 8 * L.NK)
      return col < DH ? to_f32(wk[e * DH + col]) : 0.f;
    col -= 8 * L.NK;
    if (col < 8 * L.NK)
      return col < DH ? to_f32(wq[e * DH + col]) : 0.f;
    col -= 8 * L.NK;
    return col < C ? to_f32(wv[e * C + col]) : 0.f;
  };
  if constexpr (BF16) {
    uint2* frag = reinterpret_cast<uint2*>(smem);
    for (int i = threadIdx.x; i < L.NT * L.KS * WARP; i += blockDim.x) {
      const int l = i % WARP, ks = (i / WARP) % L.KS;
      const int jn = i / (WARP * L.KS);
      const int col = 8 * jn + (l >> 2), e = ks * 16 + 2 * (l & 3);
      const __nv_bfloat162 lo =
          __floats2bfloat162_rn(weight(e, col), weight(e + 1, col));
      const __nv_bfloat162 hi =
          __floats2bfloat162_rn(weight(e + 8, col), weight(e + 9, col));
      frag[i] = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                           *reinterpret_cast<const unsigned*>(&hi));
    }
  } else {
    float* w = reinterpret_cast<float*>(smem);
    for (int i = threadIdx.x; i < De * L.NT * 8; i += blockDim.x)
      w[i] = weight(i / (L.NT * 8), i % (L.NT * 8));
  }
  float* bias = reinterpret_cast<float*>(smem + L.frag_bytes);
  for (int col = threadIdx.x; col < L.NT * 8; col += blockDim.x) {
    int c = col;
    float b = 0.f;
    if (c < 8 * L.NK) {
      b = c < DH ? to_f32(bk[c]) : 0.f;
    } else if ((c -= 8 * L.NK) < 8 * L.NK) {
      b = c < DH ? to_f32(bq[c]) : 0.f;
    } else {
      c -= 8 * L.NK;
      b = c < C ? to_f32(bv[c]) : 0.f;
    }
    bias[col] = b;
  }
  __syncthreads();

  unsigned char* wbase = smem + L.w_bytes + warp * L.warp_bytes;
  auto stage = [&](int slot) {
    return reinterpret_cast<T*>(wbase + slot * L.stage_bytes);
  };
  const int ldp = H + 1;
  float* s_lp = reinterpret_cast<float*>(wbase + STAGES * L.stage_bytes);
  float* s_alpha = s_lp + TILE * ldp;
  float* s_den = s_alpha + H;

  const int tiles = (K + TILE - 1) / TILE;
  const long long gw = (long long)blockIdx.x * nwarps + warp;
  const long long TW = (long long)gridDim.x * nwarps;
  const int nodes = gw < N ? (int)((N - 1 - gw) / TW) + 1 : 0;

  // the copy cursor: the next (node, tile) to copy, into stage `slot`;
  // one commit group per tile, empty past the warp's last node
  int c_node = 0, c_tile = 0;
  auto issue = [&](int slot) {
    if (c_node < nodes) {
      const long long n = gw + c_node * TW;
      const int k0 = c_tile * TILE;
      const int rows = K - k0 < TILE ? K - k0 : TILE;
      const long long row0 = n * K + k0;
      T* st = stage(slot);
      copy_rows(st, L.KVS, kg + row0 * ldk, ldk, rows, TILE, DH, DH, lane);
      copy_rows(st + DH, L.KVS, vg + row0 * ldv, ldv, rows, TILE, C, C,
                lane);
      copy_rows(st + TILE * L.KVS, L.EFS, ef + row0 * De, De, rows, TILE,
                De, L.EFS - 8, lane);
      copy_rows(st + TILE * (L.KVS + L.EFS), L.QS, q + n * DH, 0, 1, 1, DH,
                L.QS, lane);
      if (++c_tile == tiles) {
        c_tile = 0;
        ++c_node;
      }
    }
    cp_async_commit();
  };
  // the mask and scale cursor, a tile ahead of the compute
  int m_node = 0, m_tile = 0;
  TileMeta next;
  next.ok = false;
  next.scale = 0.f;
  auto meta = [&]() {
    if (m_node < nodes) {
      next.load(mask, scale, gw + m_node * TW, K, m_tile * TILE, lane);
      if (++m_tile == tiles) {
        m_tile = 0;
        ++m_node;
      }
    }
  };

  // the head of value column c (c < 8 * NV), by a shift when C/H is a
  // power of two
  const int ch_shift = (CH & (CH - 1)) == 0 ? __ffs(CH) - 1 : -1;
  auto head_of = [&](int c) {
    const int h = ch_shift >= 0 ? c >> ch_shift : c / CH;
    return h < H ? h : H - 1;
  };
  const bool pair_heads = CH % 2 == 0;  // columns c, c+1 share a head
  const int dshift = __ffs(D) - 1;     // D = 1 << dshift
  const int dg = D < 8 ? D : 8;     // a head's columns within one tile

  Heads heads(H);
  float acc[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = 0.f;

  meta();
  for (int i = 0; i < STAGES - 1; ++i) issue(i);
  int slot = 0;
  for (int node = 0; node < nodes; ++node) {
    const long long n = gw + node * TW;
    for (int t = 0; t < tiles; ++t) {
      issue((slot + STAGES - 1) % STAGES);
      const unsigned valid = next.bits();
      const float sc = next.scale * LOG2E;
      meta();
      cp_async_wait<STAGES - 1>();
      __syncwarp();
      const T* st_kv = stage(slot);
      const T* st_ef = st_kv + TILE * L.KVS;
      const T* st_q = st_ef + TILE * L.EFS;
      slot = (slot + 1) % STAGES;

      // A fragments of the tile's edge features (bf16 only)
      unsigned a[KS][4];
      if constexpr (BF16) {
        const T* e0 = st_ef + g * L.EFS + 2 * tq;
        const T* e1 = e0 + 8 * L.EFS;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          a[ks][0] = *reinterpret_cast<const unsigned*>(e0 + ks * 16);
          a[ks][1] = *reinterpret_cast<const unsigned*>(e1 + ks * 16);
          a[ks][2] = *reinterpret_cast<const unsigned*>(e0 + ks * 16 + 8);
          a[ks][3] = *reinterpret_cast<const unsigned*>(e1 + ks * 16 + 8);
        }
      }

      // logits of slots g, g+8 (log2 units): key and query column tiles,
      // head sums
      float part0 = 0.f, part1 = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j < L.NK) {
          float rk[4], rq[4];
          project<T, KS>(smem, bias, L.NT, De, L.EFS, j, a, st_ef, lane,
                         rk);
          project<T, KS>(smem, bias, L.NT, De, L.EFS, L.NK + j, a, st_ef,
                         lane, rq);
          const int c = 8 * j + 2 * tq;
          const float2 k0 = load2(st_kv + g * L.KVS + c);
          const float2 k1 = load2(st_kv + (g + 8) * L.KVS + c);
          const float2 qv = load2(st_q + c);
          const float p00 = (qv.x + rq[0]) * (k0.x + rk[0]);
          const float p01 = (qv.y + rq[1]) * (k0.y + rk[1]);
          const float p10 = (qv.x + rq[2]) * (k1.x + rk[2]);
          const float p11 = (qv.y + rq[3]) * (k1.y + rk[3]);
          if (D == 1) {
            if (c < DH) {
              s_lp[g * ldp + c] = p00 * sc;
              s_lp[(g + 8) * ldp + c] = p10 * sc;
            }
            if (c + 1 < DH) {
              s_lp[g * ldp + c + 1] = p01 * sc;
              s_lp[(g + 8) * ldp + c + 1] = p11 * sc;
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
                s_lp[g * ldp + h] = part0 * sc;
                s_lp[(g + 8) * ldp + h] = part1 * sc;
              }
              part0 = part1 = 0.f;
            }
          }
        }
      }
      __syncwarp();
      tile_softmax(heads, s_lp, s_alpha, valid, ldp, lane);
      __syncwarp();

      // weighted values of slots g, g+8 into the running sums
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j < L.NV) {
          float rv[4];
          project<T, KS>(smem, bias, L.NT, De, L.EFS, 2 * L.NK + j, a,
                         st_ef, lane, rv);
          const int c = 8 * j + 2 * tq;
          const int h0 = head_of(c);
          const float2 v0 = load2(st_kv + g * L.KVS + DH + c);
          const float2 v1 = load2(st_kv + (g + 8) * L.KVS + DH + c);
          const float p0 = s_lp[g * ldp + h0], p8 = s_lp[(g + 8) * ldp + h0];
          const float a0 = s_alpha[h0];
          float q0 = p0, q8 = p8, a1 = a0;
          if (!pair_heads) {  // column c + 1 may start another head
            const int h1 = head_of(c + 1);
            q0 = s_lp[g * ldp + h1];
            q8 = s_lp[(g + 8) * ldp + h1];
            a1 = s_alpha[h1];
          }
          acc[j][0] = acc[j][0] * a0 + p0 * (v0.x + rv[0])
              + p8 * (v1.x + rv[2]);
          acc[j][1] = acc[j][1] * a1 + q0 * (v0.y + rv[1])
              + q8 * (v1.y + rv[3]);
        }
      }
      __syncwarp();  // the stage and the scratch are free again
    }

    // the node's sums over the 8 slot groups, and its output
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int off = 4; off < WARP; off <<= 1) {
        acc[j][0] += __shfl_xor_sync(FULL, acc[j][0], off);
        acc[j][1] += __shfl_xor_sync(FULL, acc[j][1], off);
      }
    }
    finish_heads(heads, s_den, lse, N, n, lane);
    __syncwarp();
    // the lanes of slot group g write the column tiles j = g (mod 8)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = 8 * j + 2 * tq;
      if (j < L.NV && (j & 7) == g && c < C) {
        float2 o;
        o.x = acc[j][0] / s_den[head_of(c)];
        o.y = acc[j][1] / s_den[head_of(c + 1)];
        *reinterpret_cast<float2*>(out + n * C + c) = o;
      }
      acc[j][0] = acc[j][1] = 0.f;
    }
  }
  cp_async_wait<0>();
}

template <typename T, int NJ, int KS>
cudaError_t launch(const void* q, const void* kg, long long ldk,
                   const void* vg, long long ldv, const void* ef,
                   const void* wk, const void* bk, const void* wq,
                   const void* bq, const void* wv, const void* bv,
                   const void* mask, const void* scale, void* out,
                   void* lse, int N, int K, int H, int D, int C, int De,
                   cudaStream_t stream) {
  const Layout L(H, D, C, De, sizeof(T), KS);
  const int warps = warps_that_fit(L.w_bytes, L.warp_bytes);
  if (warps < 1) return cudaErrorInvalidValue;
  const size_t smem = L.w_bytes + warps * L.warp_bytes;
  auto kernel = dense_attention_rpe_kernel<T, NJ, KS>;
  int blocks = 0;
  cudaError_t err =
      persistent_grid(kernel, warps * WARP, smem, N, warps, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, warps * WARP, smem, stream>>>(
      (const T*)q, (const T*)kg, (const T*)vg, (const T*)ef,
      (const T*)wk, (const T*)bk, (const T*)wq, (const T*)bq,
      (const T*)wv, (const T*)bv, (const bool*)mask, (const float*)scale,
      (float*)out, (float*)lse, N, K, H, D, C, De, ldk, ldv);
  return cudaGetLastError();
}

// the column tiles a lane needs (NJ) and, in bf16, the k-steps of the
// projections (KS; f32 computes them without fragments)
template <typename T, int KS>
cudaError_t dispatch_width(const void* q, const void* kg, long long ldk,
                           const void* vg, long long ldv, const void* ef,
                           const void* wk, const void* bk, const void* wq,
                           const void* bq, const void* wv, const void* bv,
                           const void* mask, const void* scale, void* out,
                           void* lse, int N, int K, int H, int D, int C,
                           int De, cudaStream_t stream) {
  const int width = H * D > C ? H * D : C;
  if (width <= 32)
    return launch<T, 4, KS>(q, kg, ldk, vg, ldv, ef, wk, bk, wq, bq, wv, bv,
                            mask, scale, out, lse, N, K, H, D, C, De,
                            stream);
  if (width <= 64)
    return launch<T, 8, KS>(q, kg, ldk, vg, ldv, ef, wk, bk, wq, bq, wv, bv,
                            mask, scale, out, lse, N, K, H, D, C, De,
                            stream);
  return launch<T, 16, KS>(q, kg, ldk, vg, ldv, ef, wk, bk, wq, bq, wv, bv,
                           mask, scale, out, lse, N, K, H, D, C, De, stream);
}

}  // namespace

// Plain C entry point for ctypes. `is_bf16` selects the input type
// (0: float32, 1: bfloat16). The caller guarantees H <= 32, H*D <= 128,
// C <= 128, D a power of two <= 32, C % H == 0, De <= 64, contiguous
// [N, H*D] q, [N, K, De] ef, [N, K] mask, [N] scale and weights, kg / vg
// whose last axis is contiguous with slot stride ldk / ldv, and 16-byte
// alignment of q, kg, vg, ef and of the rows of each (H*D, C, De, ldk and
// ldv in bytes). Returns the CUDA error of the launch (0 on success); the
// launch does not synchronize.
extern "C" int dense_attention_rpe_launch(
    int is_bf16, const void* q, const void* kg, long long ldk,
    const void* vg, long long ldv, const void* ef, const void* wk,
    const void* bk, const void* wq, const void* bq, const void* wv,
    const void* bv, const void* mask, const void* scale, void* out,
    void* lse, int N, int K, int H, int D, int C, int De, void* stream) {
  if (N == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (!is_bf16)
    err = dispatch_width<float, 1>(q, kg, ldk, vg, ldv, ef, wk, bk, wq, bq,
                                   wv, bv, mask, scale, out, lse, N, K, H,
                                   D, C, De, st);
  else if (De <= 32)
    err = dispatch_width<__nv_bfloat16, 2>(q, kg, ldk, vg, ldv, ef, wk, bk,
                                           wq, bq, wv, bv, mask, scale, out,
                                           lse, N, K, H, D, C, De, st);
  else
    err = dispatch_width<__nv_bfloat16, 4>(q, kg, ldk, vg, ldv, ef, wk, bk,
                                           wq, bq, wv, bv, mask, scale, out,
                                           lse, N, K, H, D, C, De, st);
  return (int)err;
}
