// GraphNorm's forward without gradients, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's GraphNorm
// (superpoint_transformer_tpu/nn/norm.py) is XLA ops, one-hot
// contractions for the per-graph sums and for the broadcast back. The
// port ran the same function as about 50 PyTorch ops a call (casts, a
// cat, two one-hot contractions, two gathers, the affine on [N, C]), and a
// serving forward calls it 20-30 times. Here it is three launches:
//
//   stats:    for every row range and graph, sum x and x^2 over the rows
//             in range and masked in, and count them (all in f32);
//   finalize: per graph and channel, add the ranges' sums in a fixed
//             order and turn them into a scale and a shift:
//               n = max(count, 1), mean = s1 / n, ex2 = s2 / n,
//               am = mean_scale * mean,
//               var = max(ex2 - 2 * am * mean + am * am, 0),
//               inv = 1 / sqrt(var + eps),
//               sc = inv * weight, sh = bias - am * inv * weight
//             (the order of nn/norm.py's operations, each rounded as
//             there: the _rn intrinsics keep nvcc from contracting them);
//   apply:    y = x * sc[graph] + sh[graph] in f32, LeakyReLU (slope
//             0.01) when asked, rounded once to x's type; every row whose
//             graph id is in range, masked in or not; 0 for the others.
//
// What bounds it on an H100: device-memory bandwidth. The two passes read
// x twice and write y once (plus 8 bytes of graph id a row each pass);
// the arithmetic is a few FLOPs a byte. So the design is about 16-byte
// accesses and bytes in flight:
//
// - A block's threads split as (row lane, channel vector): each thread
//   owns 16 bytes of a row's channels and walks rows a tile at a time,
//   kUnroll rows a tile, all its loads of a tile issued together. The
//   stats pass checks the graph ids of kSpan tiles at once, so a span of
//   one graph streams through with no barrier between its tiles; the
//   grids are one wave of resident blocks.
// - No float atomics, so the result is the same bits run after run. In
//   the stats pass a tile whose rows share one graph id (the common case:
//   levels and edge rows come sorted by graph) adds into per-thread
//   registers; when the tile's graph differs from the last one, the
//   registers are summed over the row lanes in lane order into the
//   block's [g][2][Cb] shared-memory accumulators, where each column has
//   one owner thread. A tile of several ids (a graph boundary, unsorted
//   ids) is staged in shared memory and each owner thread adds its
//   column row by row. A span or tile of rows out of range is skipped
//   unread. Each block writes its whole partial [g][2C + 1] (sums, then
//   the count as an int's bits), so no buffer is cleared first; the
//   finalize adds the partials in a fixed order (each of 32 threads every
//   32nd block, then the 32 sums in turn).
// - Channels are cut into chunks (grid y) whose accumulators fit
//   kAccBytes: g <= 128 graphs at C = 128 take one chunk.
// - The apply pass keeps the scale and shift of the last graph it met in
//   registers and reloads them (from L2) only when the graph changes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                // rows a thread loads a tile
constexpr int kSpan = 8;                  // tiles a graph-id check covers
constexpr int kAccBytes = 128 * 1024;     // a chunk's accumulators
constexpr int kFinalizeSlices = 32;       // threads summing a column
constexpr float kSlope = 0.01f;           // ops/graph_norm.py:LEAKY_SLOPE

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load(const T* p) {
  return *reinterpret_cast<const Vec<T, V>*>(p);
}

// the shape of a launch, the same for the three kernels
struct Plan {
  int Cb;      // channels of a chunk (a multiple of V)
  int lanes;   // channel vectors of a chunk: threads along a row
  int RL;      // row lanes
  int TR;      // rows of a tile, RL * kUnroll
};

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <int V>
Plan make_plan(int C, int g) {
  int cap = kAccBytes / (8 * g) / V * V;
  if (cap > kThreads * V) cap = kThreads * V;
  if (cap < V) cap = V;
  Plan p;
  p.Cb = C < cap ? C : cap;
  p.lanes = p.Cb / V;
  p.RL = kThreads / p.lanes;
  p.TR = p.RL * kUnroll;
  return p;
}

// accumulators [g][2][Cb], counts [g], the tile stage [TR][Cb] and the
// tile's graph ids [TR]
size_t stats_smem(const Plan& p, int g) {
  return sizeof(float) * ((size_t)2 * g * p.Cb + g + (size_t)p.TR * p.Cb +
                          p.TR);
}

// the graph of row r, or -1 out of [0, g); no `batch` means graph 0
__device__ __forceinline__ int graph_of(const int64_t* batch, int r,
                                        int g) {
  if (batch == nullptr) return 0;
  const int64_t b = batch[r];
  return b >= 0 && b < g ? (int)b : -1;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    graph_norm_stats(const T* __restrict__ x,
                     const int64_t* __restrict__ batch,
                     const uint8_t* __restrict__ mask, int N, int C, int g,
                     Plan p, int rows_per_block, float* __restrict__ part) {
  extern __shared__ float smem[];
  const int Cb = p.Cb;
  float* acc = smem;                                // [g][2][Cb]
  int* cnt = reinterpret_cast<int*>(acc + 2 * g * Cb);
  float* stage = reinterpret_cast<float*>(cnt + g);  // [TR][Cb]
  int* tile_graph = reinterpret_cast<int*>(stage + p.TR * Cb);

  const int tid = threadIdx.x;
  const int c0 = blockIdx.y * Cb;
  const int cw = min(Cb, C - c0);
  const int rl = tid / p.lanes, col = (tid % p.lanes) * V;
  const bool active = rl < p.RL && col < cw;
  const bool counter = active && col == 0;
  for (int i = tid; i < 2 * g * Cb; i += kThreads) acc[i] = 0.f;
  for (int i = tid; i < g; i += kThreads) cnt[i] = 0;

  float s1[V], s2[V];
  int n = 0;
#pragma unroll
  for (int k = 0; k < V; ++k) s1[k] = s2[k] = 0.f;
  int cur = -1;   // the graph the registers hold sums of (block-uniform)

  // the registers' sums into the accumulators of graph `cur`, in row
  // lane order, one owner thread a column
  auto flush = [&]() {
    if (cur < 0) return;
    if (active) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        stage[(2 * rl) * Cb + col + k] = s1[k];
        stage[(2 * rl + 1) * Cb + col + k] = s2[k];
        s1[k] = s2[k] = 0.f;
      }
    }
    if (counter) tile_graph[rl] = n;
    n = 0;
    __syncthreads();
    for (int i = tid; i < 2 * Cb; i += kThreads) {
      const int half = i / Cb, c = i % Cb;
      if (c >= cw) continue;
      float s = 0.f;
      for (int q = 0; q < p.RL; ++q) s += stage[(2 * q + half) * Cb + c];
      acc[(2 * cur + half) * Cb + c] += s;
    }
    if (tid == 0) {
      int s = 0;
      for (int q = 0; q < p.RL; ++q) s += tile_graph[q];
      cnt[cur] += s;
    }
    __syncthreads();
  };

  // the kind of `rows` rows from t0: their one graph id, -1 (none in
  // range) or -2 (several ids); block-uniform, after a barrier
  auto kind = [&](int t0, int rows) {
    const int f = graph_of(batch, t0, g);
    bool same = true;
    for (int i = tid; i < rows; i += kThreads)
      same &= graph_of(batch, t0 + i, g) == f;
    return __syncthreads_and(same) ? f : -2;
  };
  // the rows of a tile of one graph into the registers
  auto add_tile = [&](int t0, int rows) {
    Vec<T, V> a[kUnroll];
    bool in[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int r = t0 + rl + j * p.RL;
      in[j] = r < t0 + rows;
      if (in[j]) {
        a[j] = load<T, V>(x + (size_t)r * C + c0 + col);
        in[j] = mask == nullptr || mask[r];
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (!in[j]) continue;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float f = to_f32(a[j].v[k]);
        s1[k] += f;
        s2[k] += f * f;
      }
      n += counter;
    }
  };

  const int r_begin = blockIdx.x * rows_per_block;
  const int r_end = min(N, r_begin + rows_per_block);
  __syncthreads();
  // spans of kSpan tiles: one barrier for a span of one graph, whose
  // tiles then stream through the registers with no barrier between them
  for (int s0 = r_begin; s0 < r_end; s0 += kSpan * p.TR) {
    const int span_end = min(r_end, s0 + kSpan * p.TR);
    const int u = kind(s0, span_end - s0);
    if (u == -1) continue;
    if (u >= 0) {
      if (u != cur) {
        flush();
        cur = u;
      }
      if (active)
        for (int t0 = s0; t0 < span_end; t0 += p.TR)
          add_tile(t0, min(p.TR, span_end - t0));
      continue;
    }
    // several graphs in the span: tile by tile
    for (int t0 = s0; t0 < span_end; t0 += p.TR) {
      const int rows = min(p.TR, span_end - t0);
      const int v = kind(t0, rows);
      if (v == -1) continue;
      if (v != cur) {
        flush();
        cur = v;
      }
      if (v >= 0) {
        if (active) add_tile(t0, rows);
        continue;
      }
      // several graphs in the tile: stage it, then each owner thread
      // adds its column row by row
      for (int i = tid; i < rows; i += kThreads) {
        const int r = t0 + i;
        const bool m = mask == nullptr || mask[r];
        tile_graph[i] = m ? graph_of(batch, r, g) : -1;
      }
      if (active) {
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
          const int i = rl + j * p.RL;
          if (i >= rows) continue;
          const Vec<T, V> a =
              load<T, V>(x + (size_t)(t0 + i) * C + c0 + col);
#pragma unroll
          for (int k = 0; k < V; ++k)
            stage[i * Cb + col + k] = to_f32(a.v[k]);
        }
      }
      __syncthreads();
      for (int c = tid; c < cw; c += kThreads) {
        for (int i = 0; i < rows; ++i) {
          const int e = tile_graph[i];
          if (e < 0) continue;
          const float f = stage[i * Cb + c];
          acc[(2 * e) * Cb + c] += f;
          acc[(2 * e + 1) * Cb + c] += f * f;
        }
      }
      if (tid == kThreads - 1) {
        for (int i = 0; i < rows; ++i)
          if (tile_graph[i] >= 0) ++cnt[tile_graph[i]];
      }
      __syncthreads();
    }
  }
  flush();
  __syncthreads();

  // the block's partial sums, whole: [g][2C + 1] (this chunk's columns)
  float* out = part + (size_t)blockIdx.x * g * (2 * C + 1);
  for (int i = tid; i < g * 2 * cw; i += kThreads) {
    const int e = i / (2 * cw), half = (i / cw) % 2, c = i % cw;
    out[(size_t)e * (2 * C + 1) + half * C + c0 + c] =
        acc[(2 * e + half) * Cb + c];
  }
  if (blockIdx.y == 0)
    for (int e = tid; e < g; e += kThreads)
      out[(size_t)e * (2 * C + 1) + 2 * C] = __int_as_float(cnt[e]);
}

// block (graph, 32 channels); its 32 warps sum every 32nd partial, then
// warp 0 adds the 32 in order and writes sc [g][C] and sh [g][C]
__global__ void __launch_bounds__(32 * kFinalizeSlices)
    graph_norm_finalize(const float* __restrict__ part, int blocks, int C,
                        int g, const float* __restrict__ weight,
                        const float* __restrict__ bias,
                        const float* __restrict__ mean_scale, float eps,
                        float* __restrict__ ss) {
  __shared__ float red[kFinalizeSlices][2][32];
  __shared__ int red_n[kFinalizeSlices][32];
  const int e = blockIdx.x, lane = threadIdx.x % 32,
            j = threadIdx.x / 32;
  const int c = blockIdx.y * 32 + lane;
  const size_t P = 2 * (size_t)C + 1;
  float a = 0.f, b = 0.f;
  int n = 0;
  if (c < C) {
#pragma unroll 4
    for (int q = j; q < blocks; q += kFinalizeSlices) {
      const float* row = part + ((size_t)q * g + e) * P;
      a += row[c];
      b += row[C + c];
      n += __float_as_int(row[2 * C]);
    }
  }
  red[j][0][lane] = a;
  red[j][1][lane] = b;
  red_n[j][lane] = n;
  __syncthreads();
  if (j != 0 || c >= C) return;
  float s1 = 0.f, s2 = 0.f;
  n = 0;
  for (int q = 0; q < kFinalizeSlices; ++q) {
    s1 += red[q][0][lane];
    s2 += red[q][1][lane];
    n += red_n[q][lane];
  }
  const float nf = (float)(n < 1 ? 1 : n);
  const float mean = __fdiv_rn(s1, nf);
  const float ex2 = __fdiv_rn(s2, nf);
  const float am = __fmul_rn(mean_scale[c], mean);
  float var = __fadd_rn(__fsub_rn(ex2, __fmul_rn(__fmul_rn(2.f, am), mean)),
                        __fmul_rn(am, am));
  var = var < 0.f ? 0.f : var;
  const float inv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  ss[(size_t)e * 2 * C + c] = __fmul_rn(inv, weight[c]);
  ss[(size_t)e * 2 * C + C + c] =
      __fsub_rn(bias[c], __fmul_rn(__fmul_rn(am, inv), weight[c]));
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    graph_norm_apply(const T* __restrict__ x,
                     const int64_t* __restrict__ batch, int N, int C, int g,
                     Plan p, const float* __restrict__ ss, int leaky,
                     T* __restrict__ y) {
  const int rl = threadIdx.x / p.lanes;
  const int col = blockIdx.y * p.Cb + (threadIdx.x % p.lanes) * V;
  if (rl >= p.RL || col >= min(C, (int)(blockIdx.y + 1) * p.Cb)) return;
  int held = -1;   // the graph whose scale and shift the registers hold
  float sc[V], sh[V];
  for (int t0 = blockIdx.x * p.TR; t0 < N; t0 += gridDim.x * p.TR) {
    Vec<T, V> a[kUnroll];
    int e[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int r = t0 + rl + j * p.RL;
      e[j] = r < N ? graph_of(batch, r, g) : -1;
      if (r < N) a[j] = load<T, V>(x + (size_t)r * C + col);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int r = t0 + rl + j * p.RL;
      if (r >= N) continue;
      Vec<T, V> o;
      if (e[j] < 0) {
#pragma unroll
        for (int k = 0; k < V; ++k) from_f32(0.f, &o.v[k]);
      } else {
        if (e[j] != held) {
          held = e[j];
          const float* row = ss + (size_t)held * 2 * C + col;
#pragma unroll
          for (int k = 0; k < V; ++k) {
            sc[k] = row[k];
            sh[k] = row[C + k];
          }
        }
#pragma unroll
        for (int k = 0; k < V; ++k) {
          float f = __fadd_rn(__fmul_rn(to_f32(a[j].v[k]), sc[k]), sh[k]);
          if (leaky && !(f > 0.f)) f = __fmul_rn(f, kSlope);
          from_f32(f, &o.v[k]);
        }
      }
      *reinterpret_cast<Vec<T, V>*>(y + (size_t)r * C + col) = o;
    }
  }
}

constexpr int kDevices = 16;

// per device and kernel pair: the dynamic shared memory granted to the
// statistics kernel, and the blocks a multiprocessor holds of each
// kernel at `occ_smem` bytes
struct DeviceCache {
  size_t granted = 48 * 1024;
  size_t occ_smem = 0;
  int occ_stats = 0, occ_apply = 0;
};

template <typename T, int V>
cudaError_t run(const void* xv, const int64_t* batch, const uint8_t* mask,
                const float* weight, const float* bias,
                const float* mean_scale, float eps, int leaky, int N, int C,
                int g, int blocks, int sms, float* work, void* yv,
                cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  const Plan p = make_plan<V>(C, g);
  const int chunks = ceil_div(C, p.Cb);
  const size_t smem = stats_smem(p, g);
  // the shared-memory opt-in above 48 KB (raised only when a launch
  // needs more) and the occupancies are settings of a device: kept for
  // each of the first kDevices, asked at every call past them
  static DeviceCache cache[kDevices];
  DeviceCache spare;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  DeviceCache& c = dev < kDevices ? cache[dev] : spare;
  if (smem > c.granted) {
    err = cudaFuncSetAttribute(graph_norm_stats<T, V>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    c.granted = smem;
  }
  // one wave of resident blocks (at most `blocks`, the partials' room),
  // so that no multiprocessor idles through a last partial wave
  if (c.occ_smem != smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &c.occ_stats, graph_norm_stats<T, V>, kThreads, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &c.occ_apply, graph_norm_apply<T, V>, kThreads, 0);
    if (err != cudaSuccess) return err;
    c.occ_smem = smem;
  }
  const int occ_stats = c.occ_stats, occ_apply = c.occ_apply;
  if (blocks > occ_stats * sms) blocks = occ_stats * sms;
  if (blocks < 1) blocks = 1;
  const int rows_per_block = ceil_div(ceil_div(N, blocks), p.TR) * p.TR;
  float* part = work;
  float* ss = work + (size_t)blocks * g * (2 * C + 1);
  graph_norm_stats<T, V><<<dim3(blocks, chunks), kThreads, smem, st>>>(
      x, batch, mask, N, C, g, p, rows_per_block, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  graph_norm_finalize<<<dim3(g, ceil_div(C, 32)), 32 * kFinalizeSlices, 0,
                        st>>>(part, blocks, C, g, weight, bias, mean_scale,
                              eps, ss);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int apply_blocks = ceil_div(N, p.TR);
  if (apply_blocks > occ_apply * sms) apply_blocks = occ_apply * sms;
  graph_norm_apply<T, V><<<dim3(apply_blocks, chunks), kThreads, 0, st>>>(
      x, batch, N, C, g, p, ss, leaky, y);
  return cudaGetLastError();
}

}  // namespace

// x, y: [N, C] f32 or bf16 (is_bf16); batch: [N] int64 or null (graph 0);
// mask: [N] bool or null; weight, bias, mean_scale: [C] f32; work: f32
// scratch of blocks * g * (2C + 1) + g * 2C values. Rows of 16-byte
// multiples at 16-byte aligned x and y take 16-byte accesses, others one
// element a thread. Returns the CUDA error of a launch, 0 on success.
extern "C" int graph_norm_launch(int is_bf16, const void* x,
                                 const void* batch, const void* mask,
                                 const void* weight, const void* bias,
                                 const void* mean_scale, float eps,
                                 int leaky, int N, int C, int g, int blocks,
                                 int sms, void* work, void* y,
                                 void* stream) {
  if (N == 0) return 0;
  const size_t esz = is_bf16 ? 2 : 4;
  const bool vec = (C * esz) % 16 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)y % 16 == 0;
  const int64_t* b = static_cast<const int64_t*>(batch);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* w = static_cast<const float*>(weight);
  const float* bi = static_cast<const float*>(bias);
  const float* ms = static_cast<const float*>(mean_scale);
  float* wk = static_cast<float*>(work);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (is_bf16)
    err = vec ? run<__nv_bfloat16, 8>(x, b, m, w, bi, ms, eps, leaky, N, C,
                                      g, blocks, sms, wk, y, st)
              : run<__nv_bfloat16, 1>(x, b, m, w, bi, ms, eps, leaky, N, C,
                                      g, blocks, sms, wk, y, st);
  else
    err = vec ? run<float, 4>(x, b, m, w, bi, ms, eps, leaky, N, C, g,
                              blocks, sms, wk, y, st)
              : run<float, 1>(x, b, m, w, bi, ms, eps, leaky, N, C, g,
                              blocks, sms, wk, y, st);
  return (int)err;
}
