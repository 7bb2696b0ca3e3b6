// Pieces shared by the dense-neighbor attention kernels K1
// (dense_attention.cu) and K2 (dense_attention_rpe.cu), for Hopper
// (sm_90a); K2's backward K3 (dense_attention_rpe_bwd.cu) takes its
// tensor-core product `mma_bf16` from here too.
//
// Both kernels walk a node's K neighbor slots in tiles of TILE slots.
// Every warp runs its own pipeline: a ring of tiles in shared memory,
// filled with 16-byte asynchronous copies (cp.async, zero-filled past the
// last slot), so that the next tile's bytes are in flight while the warp
// computes on this one; the slot mask and the node's scale for the next
// tile are loaded into registers one tile ahead too. A tile's softmax is
// exact per head; the running max, denominator and weighted sum merge it
// with the node's earlier tiles (online softmax), so any K works. Logits
// are kept in log2 units (scaled by log2(e)) so that every exponential is
// one exp2.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace node_tiles {

constexpr int WARP = 32;
constexpr int TILE = 16;       // neighbor slots per tile
constexpr int STAGES = 2;      // tiles per warp ring: one in flight
// warps per block, at 128 registers a thread: the per-tile work is a
// chain of dependent shared loads, arithmetic and shuffles, and the most
// warps an SM can hold hide its latency best
constexpr int MAX_WARPS = 16;
constexpr int MAX_H = 32;      // heads: one per lane at most
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// two consecutive values, the first at an even element offset
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// 2^x in one instruction (relative error below 2^-22); 0 for x -> -inf
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// one m16n8k16 bf16 product added to the f32 accumulator d (A row major
// in the four registers of the m16n8k16 A fragment, B column major in
// two)
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const unsigned (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// 16 bytes from global to shared memory: `bytes` is 16 to copy or 0 to
// write zeros (then `gmem` is not read, but must be a valid address)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The warp copies `rows` rows of `width` elements into dst (row stride
// dst_ld) from src (row stride src_ld), 16 bytes a lane and instruction.
// Rows from `rows_valid` on and columns from `width_valid` on are written
// as zeros. Widths, strides and addresses are multiples of 16 bytes, and
// a row is at most 32 chunks.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int dst_ld, const T* src,
                                          long long src_ld, int rows_valid,
                                          int rows, int width_valid,
                                          int width, int lane) {
  constexpr int CPC = 16 / sizeof(T);  // elements per 16-byte chunk
  const int cw = width / CPC;
  if ((cw & (cw - 1)) == 0) {  // whole rows per pass: no division
    const int shift = __ffs(cw) - 1;
    const int c = (lane & (cw - 1)) * CPC;
    for (int r = lane >> shift; r < rows; r += WARP >> shift) {
      const bool ok = r < rows_valid && c < width_valid;
      cp_async16(dst + r * dst_ld + c, ok ? src + r * src_ld + c : src,
                 ok ? 16 : 0);
    }
    return;
  }
  for (int idx = lane; idx < rows * cw; idx += WARP) {
    const int r = idx / cw, c = (idx - r * cw) * CPC;
    const bool ok = r < rows_valid && c < width_valid;
    cp_async16(dst + r * dst_ld + c, ok ? src + r * src_ld + c : src,
               ok ? 16 : 0);
  }
}

// The running softmax state of a warp's current node (H <= MAX_H). With
// H a power of two up to 16, the G = 32 / H lanes l = h (mod H) share
// head h, each over the slots l / H + G i of a tile, and all hold its
// state; otherwise (G = 1) lane h < H owns head h.
struct Heads {
  int H, G;
  float m, s;  // running max (log2 units), denominator
  __device__ explicit Heads(int H_) : H(H_), m(-1e30f), s(0.f) {
    G = (H <= 16 && (H & (H - 1)) == 0) ? WARP / H : 1;
  }
};

// The per-head softmax of one tile and its merge into the running state.
// On entry s_lp[r * ldp + h] holds the logit of slot r and head h in log2
// units (ldp = H + 1, an odd stride for H even: readers that go over slots
// hit distinct banks); on exit the slot's weight exp2(logit - m_new) (0
// where the slot is masked: bit r of `valid` is 0), and s_alpha[h] the
// factor that rescales the node's earlier tiles. A masked slot counts as
// the logit -1e30, as in the plain version, so a fully masked row keeps
// m = -1e30, s = 0.
// fmax / sum of the first n values of x (n a power of two), as a tree
template <int n>
__device__ __forceinline__ float tree_max(const float* x) {
  if constexpr (n == 1) {
    return x[0];
  } else {
    return fmaxf(tree_max<n / 2>(x), tree_max<n / 2>(x + n / 2));
  }
}
template <int n>
__device__ __forceinline__ float tree_sum(const float* x) {
  if constexpr (n == 1) {
    return x[0];
  } else {
    return tree_sum<n / 2>(x) + tree_sum<n / 2>(x + n / 2);
  }
}

__device__ __forceinline__ void tile_softmax(Heads& st, float* s_lp,
                                             float* s_alpha, unsigned valid,
                                             int ldp, int lane) {
  // one head per lane group: every slot's logit loaded first, then the
  // max and the sum as trees, so that the loads and exponentials of a
  // tile are independent of each other
  const int h = lane & (st.G > 1 ? st.H - 1 : WARP - 1);
  const int r0 = st.G > 1 ? lane / st.H : 0;
  if (h >= st.H) return;
  float x[TILE];
  bool ok[TILE];
#pragma unroll
  for (int u = 0; u < TILE; ++u) {
    const int r = r0 + st.G * u;
    ok[u] = r < TILE && (valid >> r & 1u);
    x[u] = ok[u] ? s_lp[r * ldp + h] : -1e30f;
  }
  float mx = fmaxf(st.m, tree_max<TILE>(x));
  for (int off = st.H; st.G > 1 && off < WARP; off <<= 1)
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
#pragma unroll
  for (int u = 0; u < TILE; ++u) {
    const int r = r0 + st.G * u;
    x[u] = ok[u] ? fast_exp2(x[u] - mx) : 0.f;
    if (r < TILE) s_lp[r * ldp + h] = x[u];
  }
  float sum = tree_sum<TILE>(x);
  for (int off = st.H; st.G > 1 && off < WARP; off <<= 1)
    sum += __shfl_xor_sync(FULL, sum, off);
  const float alpha = fast_exp2(st.m - mx);
  st.s = st.s * alpha + sum;
  st.m = mx;
  if (r0 == 0) s_alpha[h] = alpha;
}

// End of a node: s_den[h] = the clamped denominator (read by the lanes
// that hold the node's weighted sums), lse[h * N + n] = the natural
// log-sum-exp when lse is set (-1e30 + log(1e-30) for a fully masked row,
// as in the plain version); the state is reset for the next node.
__device__ __forceinline__ void finish_heads(Heads& st, float* s_den,
                                             float* lse, long long N,
                                             long long n, int lane) {
  if (lane < st.H) {  // lane h holds head h in both layouts
    const float den = fmaxf(st.s, 1e-30f);
    s_den[lane] = den;
    if (lse != nullptr)
      lse[lane * N + n] = (st.m == -1e30f ? -1e30f : st.m * LN2)
          + logf(den);
  }
  st.m = -1e30f;
  st.s = 0.f;
}

// The slot mask byte and the node scale that a lane needs for the tile
// at slots k0 .. k0 + TILE - 1 of node n: loaded a tile ahead, turned
// into the tile's validity bits (0 past K) when the tile comes up.
struct TileMeta {
  bool ok;
  float scale;
  __device__ void load(const bool* mask, const float* scale_, long long n,
                       int K, int k0, int lane) {
    ok = lane < TILE && k0 + lane < K && mask[n * K + k0 + lane];
    scale = scale_[n];
  }
  __device__ unsigned bits() const { return __ballot_sync(FULL, ok); }
};

// Blocks for a persistent grid: as many as fit on the card at once, no
// more than the nodes need. A kernel's shared-memory limit is one value
// per kernel and device: it is raised to the largest size launched so
// far, never lowered. The occupancy is asked once per kernel, device,
// block size and shared-memory size, so that a launch costs the host no
// more API calls.
template <typename Kernel>
__host__ inline cudaError_t persistent_grid(Kernel kernel, int threads,
                                            size_t smem, long long nodes,
                                            int warps, int* blocks) {
  struct Limit {
    const void* fn;
    int device;
    size_t smem;
  };
  struct Entry {
    const void* fn;
    int device, threads, cap;
    size_t smem;
  };
  static Limit limits[16];
  static Entry cache[64];
  static int n_limits = 0, used = 0;
  const void* fn = (const void*)kernel;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  Limit* limit = nullptr;
  for (int i = 0; i < n_limits && limit == nullptr; ++i)
    if (limits[i].fn == fn && limits[i].device == device) limit = &limits[i];
  if (limit == nullptr || limit->smem < smem) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    if (limit != nullptr)
      limit->smem = smem;
    else if (n_limits < 16)
      limits[n_limits++] = Limit{fn, device, smem};
  }
  int cap = 0;
  for (int i = 0; i < used && cap == 0; ++i)
    if (cache[i].fn == fn && cache[i].device == device
        && cache[i].threads == threads && cache[i].smem == smem)
      cap = cache[i].cap;
  if (cap == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cap = sms * per_sm;
    if (used < 64) cache[used++] = Entry{fn, device, threads, cap, smem};
  }
  const long long b = (nodes + warps - 1) / warps;
  *blocks = (int)(b < cap ? b : cap);
  return cudaSuccess;
}

// Warps per block that fit `warp_bytes` each beside `shared_bytes` in the
// block's shared memory (at most MAX_WARPS; 0 if none fits).
__host__ inline int warps_that_fit(size_t shared_bytes, size_t warp_bytes) {
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  if ((size_t)optin <= shared_bytes) return 0;
  const size_t w = ((size_t)optin - shared_bytes) / warp_bytes;
  return (int)(w < (size_t)MAX_WARPS ? w : MAX_WARPS);
}

}  // namespace node_tiles
