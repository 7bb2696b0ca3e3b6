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
// masked row gives out = 0. Inputs are f32 or bf16; all sums are f32.
//
// What bounds it on an H100: every input value is read once and only
// [N, H, C/H] f32 is written, (2*H*D + C) values per slot (384 bytes in
// bf16 at the flagship H=16, D=4, C=64 with per-edge q), about 2 FLOP per
// byte: device-memory bandwidth, about 29 us for N=5120, K=48. So the
// design is about bytes in flight and 16-byte accesses.
//
// Design (node_tiles.cuh has the shared pieces): a persistent grid, one
// pipeline per warp. The warp walks its nodes in tiles of 16 slots; a
// tile's q (16 rows per edge, or the node's row), k and v are contiguous
// blocks of the natural [N, K, *] layout and are copied into a ring of 2
// shared-memory stages with 16-byte cp.async, one tile ahead of the
// compute (at the flagship shape 6 KB in flight per warp, 96 KB per SM
// with 16 warps). On a tile the lanes go over its (slot, head) pairs for
// the logits, the lanes of each head take the tile's exact softmax and
// merge it with the node's earlier tiles, and the lanes go over channel
// pairs for the weighted sum of the values, which stays in registers
// until the node's last tile.
#include "node_tiles.cuh"

namespace {

using namespace node_tiles;

// an f32 value rounded to T and back
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// sum_d round_T(q[d] * sc) * k[d] over the D values of one head, from
// shared memory; D is a power of two
template <typename T>
__device__ __forceinline__ float head_logit(const T* q, const T* k, int D,
                                            float sc) {
  if (D == 1) return round_to(to_f32(q[0]) * sc, q) * to_f32(k[0]);
  float l = 0.f;
  for (int d = 0; d < D; d += 2) {
    const float2 a = load2(q + d), b = load2(k + d);
    l += round_to(a.x * sc, q) * b.x + round_to(a.y * sc, q) * b.y;
  }
  return l;
}

// Shared memory per warp: STAGES stages of {q [QR, DH], k [TILE, DH],
// v [TILE, C]} in the input type (QR = TILE per edge, 1 per node), then
// the softmax scratch.
struct Layout {
  int QR;
  size_t stage_bytes, warp_bytes;
  __host__ __device__ Layout(int H, int D, int C, int q_per_edge,
                             int elem) {
    const int DH = H * D;
    QR = q_per_edge ? TILE : 1;
    stage_bytes = (size_t)(QR * DH + TILE * DH + TILE * C) * elem;
    warp_bytes = STAGES * stage_bytes
        + ((size_t)(TILE * (H + 1) + 2 * H) * sizeof(float) + 15) / 16
        * 16;
  }
};

// NC: value channel pairs per lane, C <= 64 * NC
template <typename T, int NC>
__global__ void __launch_bounds__(MAX_WARPS * WARP)
dense_attention_kernel(
    const T* __restrict__ q,         // [N, H*D] or [N, K, H*D]
    const T* __restrict__ k,         // [N, K, H*D]
    const T* __restrict__ v,         // [N, K, C]
    const bool* __restrict__ mask,   // [N, K]
    const float* __restrict__ scale, // [N]
    float* __restrict__ out,         // [N, C]
    int N, int K, int H, int D, int C, int q_per_edge) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(H, D, C, q_per_edge, sizeof(T));
  const int DH = H * D;
  const int CH = C / H;
  const int nwarps = blockDim.x / WARP;
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;

  unsigned char* wbase = smem + warp * L.warp_bytes;
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
      if (q_per_edge)
        copy_rows(st, DH, q + row0 * DH, DH, rows, TILE, DH, DH, lane);
      else
        copy_rows(st, DH, q + n * DH, 0, 1, 1, DH, DH, lane);
      st += L.QR * DH;
      copy_rows(st, DH, k + row0 * DH, DH, rows, TILE, DH, DH, lane);
      copy_rows(st + TILE * DH, C, v + row0 * C, C, rows, TILE, C, C, lane);
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

  // the heads of the lane's value channels c = 2 lane + 64 i and c + 1
  int h0[NC], h1[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = 2 * lane + 64 * i;
    h0[i] = min(c / CH, H - 1);
    h1[i] = min((c + 1) / CH, H - 1);
  }
  // the (slot, head) pairs of the logits: with H a power of two up to 32,
  // lane l takes head l % H and the slots l / H + (32 / H) i
  const bool pow2_heads = H <= WARP && (H & (H - 1)) == 0;
  const int hshift = __ffs(H) - 1;

  Heads heads(H);
  float acc[NC][2];
#pragma unroll
  for (int i = 0; i < NC; ++i) acc[i][0] = acc[i][1] = 0.f;

  meta();
  for (int i = 0; i < STAGES - 1; ++i) issue(i);
  int slot = 0;
  for (int node = 0; node < nodes; ++node) {
    const long long n = gw + node * TW;
    for (int t = 0; t < tiles; ++t) {
      issue((slot + STAGES - 1) % STAGES);
      const unsigned valid = next.bits();
      const float sc = next.scale;
      meta();
      cp_async_wait<STAGES - 1>();
      __syncwarp();
      const T* st_q = stage(slot);
      const T* st_k = st_q + L.QR * DH;
      const T* st_v = st_k + TILE * DH;
      slot = (slot + 1) % STAGES;

      // the logits of the tile's (slot, head) pairs, in log2 units
      if (pow2_heads) {
        const int h = lane & (H - 1);
        const T* qh = st_q + h * D;
        const T* kh = st_k + h * D;
#pragma unroll 4
        for (int r = lane >> hshift; r < TILE; r += WARP >> hshift)
          s_lp[r * ldp + h] = head_logit(qh + (q_per_edge ? r * DH : 0),
                                         kh + r * DH, D, sc) * LOG2E;
      } else {
        for (int idx = lane; idx < TILE * H; idx += WARP) {
          const int r = idx / H, h = idx - r * H;
          const T* qp = st_q + (q_per_edge ? r * DH : 0) + h * D;
          s_lp[r * ldp + h] =
              head_logit(qp, st_k + r * DH + h * D, D, sc) * LOG2E;
        }
      }
      __syncwarp();
      tile_softmax(heads, s_lp, s_alpha, valid, ldp, lane);
      __syncwarp();

      // weighted values: lane l owns the channel pairs 2l + 64 i
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = 2 * lane + 64 * i;
        if (c < C) {
          float a0 = acc[i][0] * s_alpha[h0[i]];
          float a1 = acc[i][1] * s_alpha[h1[i]];
#pragma unroll
          for (int r = 0; r < TILE; ++r) {
            const float2 vv = load2(st_v + r * C + c);
            a0 = fmaf(s_lp[r * ldp + h0[i]], vv.x, a0);
            a1 = fmaf(s_lp[r * ldp + h1[i]], vv.y, a1);
          }
          acc[i][0] = a0;
          acc[i][1] = a1;
        }
      }
      __syncwarp();  // the stage and the scratch are free again
    }

    // the node's output
    finish_heads(heads, s_den, nullptr, N, n, lane);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = 2 * lane + 64 * i;
      if (c < C) {
        float2 o;
        o.x = acc[i][0] / s_den[h0[i]];
        o.y = acc[i][1] / s_den[h1[i]];
        *reinterpret_cast<float2*>(out + n * C + c) = o;
      }
      acc[i][0] = acc[i][1] = 0.f;
    }
  }
  cp_async_wait<0>();
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, const void* scale, void* out, int N,
                   int K, int H, int D, int C, int q_per_edge,
                   cudaStream_t stream) {
  const Layout L(H, D, C, q_per_edge, sizeof(T));
  const int warps = warps_that_fit(0, L.warp_bytes);
  if (warps < 1) return cudaErrorInvalidValue;
  const size_t smem = warps * L.warp_bytes;
  auto kernel = dense_attention_kernel<T, NC>;
  int blocks = 0;
  cudaError_t err =
      persistent_grid(kernel, warps * WARP, smem, N, warps, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, warps * WARP, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const bool*)mask,
      (const float*)scale, (float*)out, N, K, H, D, C, q_per_edge);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* mask, const void* scale, void* out, int N,
                     int K, int H, int D, int C, int q_per_edge,
                     cudaStream_t stream) {
  if (C <= 64)
    return launch<T, 1>(q, k, v, mask, scale, out, N, K, H, D, C,
                        q_per_edge, stream);
  return launch<T, 2>(q, k, v, mask, scale, out, N, K, H, D, C, q_per_edge,
                      stream);
}

}  // namespace

// Plain C entry point for ctypes. `is_bf16` selects the input type
// (0: float32, 1: bfloat16); q, k and v share it. The caller guarantees
// H <= 32, H*D <= 128, C <= 128, D a power of two <= 32, C % H == 0,
// contiguous
// q ([N, H*D], or [N, K, H*D] when `q_per_edge`), k [N, K, H*D],
// v [N, K, C], mask [N, K] and scale [N], and 16-byte alignment of q, k,
// v and of their rows (H*D and C in bytes). Returns the CUDA error of the
// launch (0 on success); the launch does not synchronize.
extern "C" int dense_attention_launch(int is_bf16, const void* q,
                                      const void* k, const void* v,
                                      const void* mask, const void* scale,
                                      void* out, int N, int K, int H, int D,
                                      int C, int q_per_edge, void* stream) {
  if (N == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = is_bf16
      ? dispatch<__nv_bfloat16>(q, k, v, mask, scale, out, N, K, H, D, C,
                                q_per_edge, st)
      : dispatch<float>(q, k, v, mask, scale, out, N, K, H, D, C,
                        q_per_edge, st);
  return (int)err;
}
