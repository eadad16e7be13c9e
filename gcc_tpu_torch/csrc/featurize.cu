// Fused featurize builder: adjacency counts, in-degrees and the shifted
// normalized operator m_shift, from compact wire edges, in one pass.
//
// Replaces the TPU kernel gcc_tpu/ops/featurize_pallas.py
// fused_adjacency_featurize (_fused_kernel), and computes what the default
// XLA chain computes (ops/aggregate.py build_dense_adjacency_compact ->
// features/positional.py normalized_adjacency -> the +I shift of
// _subspace_topk):
//
//   adj[g, d, s]  = number of edges s -> d of graph g (stored)
//   deg[g, v]     = sum_s adj[g, v, s]               (in-degree)
//   m_shift[g]    = D^-1/2 A D^-1/2 (deg clipped at 1)
//                   + I on real rows, 0 on the padding diagonal
//
// Bound on Hopper: bytes. The outputs are 2 * N^2 values per graph (0.54
// GB in f32, 0.27 GB in bf16, for 4096 graphs at N = 128) against a few
// hundred edges read; the arithmetic is a handful of operations per
// output value. So the design keeps everything but the two output
// streams off the memory bus and cheap in issue slots:
//
// * Each edge is read and counted once per graph. The band path (N <=
//   256 and e_tot < 65536): a thread block cluster of C = ceil(N / 128)
//   blocks per graph (one block up to N = 128, two up to 256), block b
//   owning a band of R = ceil(N / C) rows as 16-bit counts, two to a
//   32-bit word, in shared memory (32 KB at N = 128, 64 KB at N = 256:
//   three or more blocks an SM, so one graph's counting overlaps
//   another's stores). Block b walks 1/C of the graph's edge run and adds
//   each edge into its owner's band, through distributed shared memory
//   when the owner is the other block. 16-bit counts are exact because no
//   graph holds more edges than the wire's e_tot. A cluster rather than
//   one block a graph at N = 256: the counts would take 128 KB, one block
//   an SM, and every graph's zeroing and counting would stall the SM's
//   stores.
// * Degrees come from the stored entries: the owner adds 1 to deg[dst]
//   where atomicAdd's old count shows the stored entry moved (always in
//   f32; in bf16 while the count is below 256, where bf16 +1 increments
//   stop). Each owner takes rsqrt once per node of its band and writes it
//   into every block's inv[] (one rsqrt per node, not per entry), then a
//   cluster barrier.
// * Threads map to (column group, row) in two dimensions: no runtime
//   division per entry. A thread takes 8 columns of a row at a time, as
//   8 / W groups of W adjacent columns, W values a store: 16 bytes (4 f32
//   or 8 bf16 values) where every row starts 16-byte aligned (N a
//   multiple of 4 in f32, of 8 in bf16: 128, 240 and 256 are), else 8, 4
//   or 2 bytes as the rows allow. A warp's groups lie side by side, so
//   each store instruction writes adjacent addresses; the counts come in
//   with one shared load a group. A row's last group, where N is no
//   multiple of W, is stored a value at a time.
// * The tile path (256 < N <= 2048, or e_tot >= 65536): blocks of R =
//   8192 / N' rows (N' = N rounded up to 8) with 32-bit counts, two
//   launches. The first counts each tile's rows, writes deg and inv[] of
//   those rows to a device scratch; the second counts the tile again and
//   writes it with the same store loop. Each edge is read once per tile
//   in each launch there.
//
// Slots past a graph's count are never read: the run [cumsum - count,
// cumsum) of its wire segment is masked by meta[:, 1, :], not by a
// sentinel id, so id 255 is a real node in the 256 bucket. Padding rows
// and columns stay exact zeros, the padding diagonal of m_shift is 0.
//
// Storage dtype T (the reference's GCC_TPU_ADJ_DTYPE=bf16,
// gcc_tpu/ops/aggregate.py:30-45, as EncoderConfig.adj_dtype): float, or
// __nv_bfloat16 for adj and m_shift. The bf16 variant rounds where the
// reference's default chain rounds (ops/aggregate.py in the port states
// each): adj = min(count, 256), what bf16 +1 increments leave; the degrees
// that normalize are the f32 row sums of those stored entries (gcc_tpu/
// features/positional.py:64-71); M = D^-1/2 A D^-1/2 in f32 from them,
// rounded once; m_shift's real diagonal rounded again after the +1, so
// bf16(bf16(a_vv s_v^2) + 1); deg, f32, the row sum rounded to bf16 (the
// train route's adj.sum(axis=2) in the adjacency dtype). Rounding is
// __float2bfloat16_rn, to nearest even, as XLA's convert and torch's
// .to(torch.bfloat16). Products are separately rounded, in the chain's
// order (adj * inv_row) * inv_col, with no contraction into an FMA.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// ---- the launch plan (ops/aggregate.py featurize_launch_plan mirrors it)
constexpr int kMaxN = 2048;            // the widest bucket the wrapper takes
constexpr int kBandMaxN = 256;         // the widest N of the band path
constexpr int kBandRows = 128;         // rows a band block owns at most
constexpr int kCount16Limit = 65536;   // e_tot below it: 16-bit counts exact
constexpr int kTileEntries = 8192;     // counts a tile block holds
constexpr int kThreads = 256;          // threads a block, at most
constexpr int kVec = 8;                // values a thread stores at once
constexpr int kMaxCluster = 8;         // the portable cluster size
constexpr int kBf16CountLimit = 256;   // a bf16 count stops here
constexpr int kPlainSmem = 48 * 1024;  // above: opt in to dynamic smem
constexpr int kMaxSmem = 232448;       // the most a Hopper block may use

enum Path { kBandPath = 0, kTilePath = 1 };

struct Plan {
  int path, cluster, rows, count_bits, gx, gy, blocks_per_graph, launches,
      smem, store_bytes;
};

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Shared memory of a block holding `rows` rows of counts of `bytes` bytes
// each, their degree sums (int) and inv[] of every column (float).
constexpr int block_smem(int n, int rows, int bytes) {
  return rows * round_up(n, kVec) * bytes + 4 * round_up(rows, 4)
         + 4 * round_up(n, kVec);
}

// Bytes a store instruction writes: 16 where every row of T values starts
// 16-byte aligned (4 f32 or 8 bf16 values), else the most of 8, 4 and 2
// bytes to which every row is aligned, else one value.
constexpr int store_bytes(int n, int value_bytes) {
  return n * value_bytes % 16 == 0 ? 16
         : n * value_bytes % 8 == 0 ? 8
         : n * value_bytes % 4 == 0 ? 4 : value_bytes;
}

// cluster: 0 for the plan's own choice, or a band cluster to check.
// Returns a CUDA error code (cudaErrorInvalidValue on what no path takes).
int make_plan(int n, int e_tot, int lo, int cluster, Plan* p) {
  if (n <= 0 || n > kMaxN || e_tot < 0) return (int)cudaErrorInvalidValue;
  const int np = round_up(n, kVec);
  p->gx = np / kVec;
  p->gy = kThreads / p->gx > 1 ? kThreads / p->gx : 1;
  p->store_bytes = store_bytes(n, lo ? 2 : 4);
  if (n <= kBandMaxN && e_tot < kCount16Limit) {
    const int c = cluster != 0 ? cluster : (n + kBandRows - 1) / kBandRows;
    if (c < 1 || c > kMaxCluster || c > n) return (int)cudaErrorInvalidValue;
    p->path = kBandPath;
    p->cluster = c;
    p->rows = (n + c - 1) / c;
    p->count_bits = 16;
    p->blocks_per_graph = c;
    p->launches = 1;
    p->smem = block_smem(n, p->rows, 2);
    if (p->smem > kMaxSmem) return (int)cudaErrorInvalidValue;
    return 0;
  }
  if (cluster != 0) return (int)cudaErrorInvalidValue;
  p->path = kTilePath;
  p->cluster = 1;
  p->rows = kTileEntries / np > 1 ? kTileEntries / np : 1;
  p->count_bits = 32;
  p->blocks_per_graph = (n + p->rows - 1) / p->rows;
  p->launches = 2;
  p->smem = block_smem(n, p->rows, 4);
  return 0;
}

// ---- device helpers -----------------------------------------------------

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a in the low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

// W values v[0..W) at p, in one store of W * sizeof(T) bytes (p aligned to
// it): W = 4, 2 or 1 f32 values, 8, 4, 2 or 1 bf16 values.
template <int W>
__device__ __forceinline__ void store_w(float* p, const float* v) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (W == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    *p = v[0];
}

template <int W>
__device__ __forceinline__ void store_w(__nv_bfloat16* p, const float* v) {
  if constexpr (W == 8)
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                   pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  else if constexpr (W == 4)
    *reinterpret_cast<uint2*>(p) =
        make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  else if constexpr (W == 2)
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(v[0], v[1]);
  else
    put(p, v[0]);
}

// W counts from shared memory, 16-bit or 32-bit, in one load where W * the
// count's bytes is at most 16 (two for 8 32-bit counts).
template <int W>
__device__ __forceinline__ void load_w(const uint16_t* c, float* out) {
  if constexpr (W == 8) {
    const uint4 w = *reinterpret_cast<const uint4*>(c);
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = (float)(u[i] & 0xFFFFu);
      out[2 * i + 1] = (float)(u[i] >> 16);
    }
  } else if constexpr (W == 4) {
    const uint2 w = *reinterpret_cast<const uint2*>(c);
    out[0] = (float)(w.x & 0xFFFFu); out[1] = (float)(w.x >> 16);
    out[2] = (float)(w.y & 0xFFFFu); out[3] = (float)(w.y >> 16);
  } else if constexpr (W == 2) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(c);
    out[0] = (float)(w & 0xFFFFu); out[1] = (float)(w >> 16);
  } else {
    out[0] = (float)*c;
  }
}

template <int W>
__device__ __forceinline__ void load_w(const uint32_t* c, float* out) {
  if constexpr (W >= 4) {
#pragma unroll
    for (int h = 0; h < W / 4; ++h) {
      const uint4 w = reinterpret_cast<const uint4*>(c)[h];
      out[4 * h] = (float)w.x; out[4 * h + 1] = (float)w.y;
      out[4 * h + 2] = (float)w.z; out[4 * h + 3] = (float)w.w;
    }
  } else if constexpr (W == 2) {
    const uint2 w = *reinterpret_cast<const uint2*>(c);
    out[0] = (float)w.x; out[1] = (float)w.y;
  } else {
    out[0] = (float)*c;
  }
}

// W floats of inv[] from shared memory.
template <int W>
__device__ __forceinline__ void load_inv(const float* p, float* out) {
#pragma unroll
  for (int h = 0; h < (W + 3) / 4; ++h) {
    if constexpr (W >= 4) {
      const float4 u = reinterpret_cast<const float4*>(p)[h];
      out[4 * h] = u.x; out[4 * h + 1] = u.y;
      out[4 * h + 2] = u.z; out[4 * h + 3] = u.w;
    } else if constexpr (W == 2) {
      const float2 u = *reinterpret_cast<const float2*>(p);
      out[0] = u.x; out[1] = u.y;
    } else {
      out[0] = *p;
    }
  }
}

// Graph g's run in its segment: s_run = {start, count, n_nodes}. Warp 0
// (threads tid < 32 of the block's linear order; a block has at least 32).
__device__ __forceinline__ void graph_run(const int32_t* meta, int g, int b,
                                          int tid, int* s_run) {
  if (tid >= 32) return;
  const int s = g / b, j = g - s * b;
  const int32_t* seg_meta = meta + (size_t)s * 3 * b;
  int acc = 0;
  for (int t = tid; t < j; t += 32) acc += seg_meta[b + t];
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (tid == 0) {
    s_run[0] = acc;
    s_run[1] = seg_meta[b + j];
    s_run[2] = seg_meta[j];
  }
}

// One barrier of the whole cluster (C > 1: release / acquire, so the
// shared memory writes of every block before it are seen after it), or of
// the block (C = 1).
__device__ __forceinline__ void band_barrier(int csize) {
  if (csize > 1)
    asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
                 "barrier.cluster.wait.acquire.aligned;" ::: "memory");
  else
    __syncthreads();
}

// Writes rows [0, rows) of the counts (row r is graph row r0 + r, its
// counts at cnt + r * N') as adj and m_shift. A thread takes 8 columns of
// each of rows y, y + gy, ...: kVec / W groups of W adjacent columns, group
// k at W x + k N' / (kVec / W), so that each of a warp's stores writes
// adjacent addresses. inv[] holds N' floats, 0 past N.
template <int W, class T, class Cnt>
__device__ __forceinline__ void write_rows(const Cnt* cnt, const float* inv,
                                           int rows, int r0, int n,
                                           int n_nodes, T* adj_g, T* ms_g) {
  constexpr bool kLo = sizeof(T) == 2;
  constexpr int kGroups = kVec / W;
  const int np = blockDim.x * kVec;
  const int span = np / kGroups;  // a multiple of W, as N' is of 8
  int col[kGroups];
  float ic[kVec];
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    col[k] = W * threadIdx.x + k * span;
    load_inv<W>(inv + col[k], ic + k * W);
  }
  for (int r = threadIdx.y; r < rows; r += blockDim.y) {
    const int row = r0 + r;
    float a[kVec], m[kVec];
#pragma unroll
    for (int k = 0; k < kGroups; ++k)
      load_w<W>(cnt + (size_t)r * np + col[k], a + k * W);
    const float ir = inv[row];
    const int diag = row < n_nodes ? row : -1;  // real rows only
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const int i = k * W + w;
        // The stored count: in bf16, +1 increments stop at 256.
        const float x = kLo ? fminf(a[i], (float)kBf16CountLimit) : a[i];
        float y = __fmul_rn(__fmul_rn(x, ir), ic[i]);
        // bf16: M is stored rounded, the shift adds to the stored value.
        if (kLo) y = bf16_round(y);
        if (col[k] + w == diag) y = __fadd_rn(y, 1.f);
        a[i] = x;
        m[i] = y;
      }
    }
    T* pa = adj_g + (size_t)row * n;
    T* pm = ms_g + (size_t)row * n;
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const int c = col[k];
      if (c + W <= n) {
        store_w<W>(pa + c, a + k * W);
        store_w<W>(pm + c, m + k * W);
      } else {
        // A row's last group, N no multiple of W (unrolled, so a[] and m[]
        // stay in registers).
#pragma unroll
        for (int i = 0; i < W; ++i) {
          if (c + i < n) {
            put(pa + c + i, a[k * W + i]);
            put(pm + c + i, m[k * W + i]);
          }
        }
      }
    }
  }
}

// ---- the band path: a cluster of C blocks per graph ---------------------

template <class T, int W>
__global__ void __launch_bounds__(kThreads)
featurize_band_kernel(const int32_t* __restrict__ edges,  // (S, E_tot) packed
                      const int32_t* __restrict__ meta,   // (S, 3, B)
                      T* __restrict__ adj,                // (S*B, N, N)
                      T* __restrict__ m_shift,            // (S*B, N, N)
                      float* __restrict__ deg,            // (S*B, N)
                      int e_tot, int b, int n, int rows, int csize,
                      int id_bits) {
  constexpr bool kLo = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int np = blockDim.x * kVec;
  const int words = np / 2;                  // two 16-bit counts a word
  uint32_t* cnt = reinterpret_cast<uint32_t*>(smem);
  int* dsum = reinterpret_cast<int*>(smem + (size_t)rows * np * 2);
  float* inv = reinterpret_cast<float*>(smem + (size_t)rows * np * 2
                                        + 4 * round_up(rows, 4));
  __shared__ int s_run[3];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = csize > 1 ? (int)cluster.block_rank() : 0;
  const int g = blockIdx.x / csize;
  const int s = g / b;
  const int r0 = rank * rows;
  const int here = max(0, min(rows, n - r0));
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;

  graph_run(meta, g, b, tid, s_run);
  uint4* c4 = reinterpret_cast<uint4*>(cnt);
  for (int i = tid; i < rows * np / 8; i += nthr)
    c4[i] = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < rows; i += nthr) dsum[i] = 0;
  // Every block's band is zero (and every block has started) before any
  // block adds into it.
  band_barrier(csize);

  const int start = max(s_run[0], 0);
  const int end = min(start + max(s_run[1], 0), e_tot);
  const int mask = (1 << id_bits) - 1;
  const int32_t* seg = edges + (size_t)s * e_tot;
  for (int e = start + rank * nthr + tid; e < end; e += csize * nthr) {
    const int packed = seg[e];
    const int src = packed & mask;
    const int dst = (packed >> id_bits) & mask;
    if (src >= n || dst >= n) continue;  // outside the bucket: no slot
    const int owner = dst / rows;
    const int lr = dst - owner * rows;
    uint32_t* cw = cnt + lr * words + (src >> 1);
    int* dw = dsum + lr;
    if (owner != rank) {
      cw = cluster.map_shared_rank(cw, owner);
      dw = cluster.map_shared_rank(dw, owner);
    }
    const int sh = (src & 1) * 16;
    const uint32_t old = (atomicAdd(cw, 1u << sh) >> sh) & 0xFFFFu;
    // The degree is the sum of the stored entries.
    if (!kLo || old < (uint32_t)kBf16CountLimit) atomicAdd(dw, 1);
  }
  band_barrier(csize);

  // One rsqrt per node: each owner its band's, into every block's inv[].
  for (int r = tid; r < here; r += nthr) {
    const float d = (float)dsum[r];
    const int v = r0 + r;
    deg[(size_t)g * n + v] = kLo ? bf16_round(d) : d;
    const float iv = rsqrtf(fmaxf(d, 1.f));
    if (csize == 1) {
      inv[v] = iv;
    } else {
      for (int q = 0; q < csize; ++q)
        *cluster.map_shared_rank(inv + v, q) = iv;
    }
  }
  for (int v = n + tid; v < np; v += nthr) inv[v] = 0.f;
  // inv[] is whole in every block, and no block reads another's shared
  // memory after this barrier.
  band_barrier(csize);

  write_rows<W>(reinterpret_cast<const uint16_t*>(cnt), inv, here, r0, n,
                s_run[2], adj + (size_t)g * n * n,
                m_shift + (size_t)g * n * n);
}

// ---- the tile path: blocks of R rows, two launches -----------------------

// kWrite false: count the tile's rows, write their deg and inv (scratch).
// kWrite true: count them again and write adj and m_shift.
template <class T, int W, bool kWrite>
__global__ void __launch_bounds__(kThreads)
featurize_tile_kernel(const int32_t* __restrict__ edges,
                      const int32_t* __restrict__ meta,
                      T* __restrict__ adj, T* __restrict__ m_shift,
                      float* __restrict__ deg,
                      float* __restrict__ inv_g,          // (S*B, N) scratch
                      int e_tot, int b, int n, int rows, int id_bits) {
  constexpr bool kLo = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int np = blockDim.x * kVec;
  uint32_t* cnt = reinterpret_cast<uint32_t*>(smem);
  int* dsum = reinterpret_cast<int*>(smem + (size_t)rows * np * 4);
  float* inv = reinterpret_cast<float*>(smem + (size_t)rows * np * 4
                                        + 4 * round_up(rows, 4));
  __shared__ int s_run[3];

  const int g = blockIdx.x;
  const int s = g / b;
  const int r0 = blockIdx.y * rows;
  const int here = min(rows, n - r0);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;

  graph_run(meta, g, b, tid, s_run);
  uint4* c4 = reinterpret_cast<uint4*>(cnt);
  for (int i = tid; i < rows * np / 4; i += nthr)
    c4[i] = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < rows; i += nthr) dsum[i] = 0;
  if (kWrite)
    for (int v = tid; v < np; v += nthr)
      inv[v] = v < n ? inv_g[(size_t)g * n + v] : 0.f;
  __syncthreads();

  const int start = max(s_run[0], 0);
  const int end = min(start + max(s_run[1], 0), e_tot);
  const int mask = (1 << id_bits) - 1;
  const int32_t* seg = edges + (size_t)s * e_tot;
  for (int e = start + tid; e < end; e += nthr) {
    const int packed = seg[e];
    const int src = packed & mask;
    const int dst = (packed >> id_bits) & mask;
    const int lr = dst - r0;
    if (src >= n || dst >= n || lr < 0 || lr >= here) continue;
    const uint32_t old = atomicAdd(&cnt[lr * np + src], 1u);
    if (!kWrite && (!kLo || old < (uint32_t)kBf16CountLimit))
      atomicAdd(&dsum[lr], 1);
  }
  __syncthreads();

  if (!kWrite) {
    for (int r = tid; r < here; r += nthr) {
      const float d = (float)dsum[r];
      deg[(size_t)g * n + r0 + r] = kLo ? bf16_round(d) : d;
      inv_g[(size_t)g * n + r0 + r] = rsqrtf(fmaxf(d, 1.f));
    }
    return;
  }
  write_rows<W>(cnt, inv, here, r0, n, s_run[2], adj + (size_t)g * n * n,
                m_shift + (size_t)g * n * n);
}

template <class K>
int allow_smem(K kern, int smem) {
  if (smem <= kPlainSmem) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <class T, int W>
int launch_w(const Plan& p, const void* edges, const void* meta, void* adj,
             void* m_shift, void* deg, void* scratch, int graphs, int e_tot,
             int b, int n, int id_bits, cudaStream_t stream) {
  const dim3 block(p.gx, p.gy, 1);
  if (p.path == kBandPath) {
    const auto kern = featurize_band_kernel<T, W>;
    int err = allow_smem(kern, p.smem);
    if (err != 0) return err;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(graphs * p.cluster, 1, 1);
    cfg.blockDim = block;
    cfg.dynamicSmemBytes = p.smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = p.cluster > 1 ? 1 : 0;
    err = (int)cudaLaunchKernelEx(
        &cfg, kern, (const int32_t*)edges, (const int32_t*)meta, (T*)adj,
        (T*)m_shift, (float*)deg, e_tot, b, n, p.rows, p.cluster, id_bits);
    if (err != 0) return err;
    return (int)cudaGetLastError();
  }
  const dim3 grid(graphs, p.blocks_per_graph, 1);
  const auto count = featurize_tile_kernel<T, W, false>;
  const auto write = featurize_tile_kernel<T, W, true>;
  int err = allow_smem(count, p.smem);
  if (err == 0) err = allow_smem(write, p.smem);
  if (err != 0) return err;
  count<<<grid, block, p.smem, stream>>>(
      (const int32_t*)edges, (const int32_t*)meta, (T*)adj, (T*)m_shift,
      (float*)deg, (float*)scratch, e_tot, b, n, p.rows, id_bits);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  write<<<grid, block, p.smem, stream>>>(
      (const int32_t*)edges, (const int32_t*)meta, (T*)adj, (T*)m_shift,
      (float*)deg, (float*)scratch, e_tot, b, n, p.rows, id_bits);
  return (int)cudaGetLastError();
}

// The instance whose stores write p.store_bytes: W = 4, 2, 1 f32 values or
// 8, 4, 2, 1 bf16 values.
template <class T>
int launch(const Plan& p, const void* edges, const void* meta, void* adj,
           void* m_shift, void* deg, void* scratch, int graphs, int e_tot,
           int b, int n, int id_bits, cudaStream_t stream) {
  switch (p.store_bytes / (int)sizeof(T)) {
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch_w<T, 8>(p, edges, meta, adj, m_shift, deg, scratch,
                              graphs, e_tot, b, n, id_bits, stream);
      break;
    case 4:
      return launch_w<T, 4>(p, edges, meta, adj, m_shift, deg, scratch,
                            graphs, e_tot, b, n, id_bits, stream);
    case 2:
      return launch_w<T, 2>(p, edges, meta, adj, m_shift, deg, scratch,
                            graphs, e_tot, b, n, id_bits, stream);
    case 1:
      return launch_w<T, 1>(p, edges, meta, adj, m_shift, deg, scratch,
                            graphs, e_tot, b, n, id_bits, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The launch plan for N = n, a wire of e_tot slots a segment, bf16 (lo) or
// f32 storage and a forced band cluster (0: the plan's):
// out = {path (0 band, 1 tile), cluster, rows a block, count bits,
// threads, shared bytes, blocks a graph, launches, store bytes, scratch
// bytes a graph}. Returns a CUDA error code.
extern "C" int gcc_featurize_plan(int n, int e_tot, int lo, int cluster,
                                  int* out) {
  Plan p;
  const int err = make_plan(n, e_tot, lo, cluster, &p);
  if (err != 0) return err;
  const int vals[10] = {p.path, p.cluster, p.rows, p.count_bits,
                        p.gx * p.gy, p.smem, p.blocks_per_graph, p.launches,
                        p.store_bytes, p.path == kTilePath ? 4 * n : 0};
  for (int i = 0; i < 10; ++i) out[i] = vals[i];
  return 0;
}

// lo: adj and m_shift are bf16 (else f32); deg is f32 either way. scratch:
// (S*B, N) floats on the tile path (unused on the band path). cluster: 0
// for the plan's own choice.
extern "C" int gcc_featurize_launch(const void* edges, const void* meta,
                                    void* adj, void* m_shift, void* deg,
                                    void* scratch, int s, int e_tot, int b,
                                    int n, int id_bits, int lo, int cluster,
                                    void* stream) {
  Plan p;
  const int err = make_plan(n, e_tot, lo, cluster, &p);
  if (err != 0) return err;
  if (s <= 0 || b <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  return lo ? launch<__nv_bfloat16>(p, edges, meta, adj, m_shift, deg,
                                    scratch, s * b, e_tot, b, n, id_bits, st)
            : launch<float>(p, edges, meta, adj, m_shift, deg, scratch,
                            s * b, e_tot, b, n, id_bits, st);
}
