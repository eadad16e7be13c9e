// Fused featurize builder: adjacency counts, in-degrees and the shifted
// normalized operator m_shift, from compact wire edges, in one pass.
//
// Replaces the TPU kernel gcc_tpu/ops/featurize_pallas.py
// fused_adjacency_featurize (_fused_kernel), and computes what the default
// XLA chain computes (ops/aggregate.py build_dense_adjacency_compact ->
// features/positional.py normalized_adjacency -> the +I shift of
// _subspace_topk):
//
//   adj[g, d, s]  = number of edges s -> d of graph g
//   deg[g, v]     = sum_s adj[g, v, s]               (in-degree)
//   m_shift[g]    = D^-1/2 A D^-1/2 (deg clipped at 1)
//                   + I on real rows, 0 on the padding diagonal
//
// Bound on Hopper: bytes. The outputs are 2 * N^2 floats per graph
// (0.54 GB for 4096 graphs at N = 128) against a few hundred edges read;
// the arithmetic is a handful of operations per output element.
// Design: one block per (graph, tile of rows). The block zeroes a tile of
// adjacency rows and a full in-degree histogram in shared memory, walks
// the graph's edge run [cumsum - count, cumsum) of its wire segment, and
// counts with shared-memory atomics (counts held in f32 are exact
// whatever the atomic order). Slots past a graph's count are never read:
// the run is masked by meta[:, 1, :], not by a sentinel id, so id 255 is a
// real node in the 256 bucket. The tile is then written once as adj and
// once as m_shift, row-contiguous, so both output streams are coalesced.
// Every tile block recounts the whole histogram from the same edges —
// cheaper than a second launch — and the first tile writes deg.
//
// Storage dtype T (the reference's GCC_TPU_ADJ_DTYPE=bf16,
// gcc_tpu/ops/aggregate.py:30-45, as EncoderConfig.adj_dtype): float, or
// __nv_bfloat16 for adj and m_shift, which halves the bytes written. The
// bf16 variant rounds where the reference's default chain rounds
// (ops/aggregate.py in the port states each): adj = min(count, 256), what
// bf16 +1 increments leave; M = D^-1/2 A D^-1/2 in f32 from that adj,
// rounded once; m_shift's real diagonal rounded again after the +1, so
// bf16(bf16(a_vv s_v^2) + 1); deg, f32, the f32 row sum rounded to bf16
// (the train route's adj.sum(axis=2) in the adjacency dtype). Rounding is
// __float2bfloat16_rn, to nearest even, as XLA's convert and torch's
// .to(torch.bfloat16). The in-degrees the normalization uses are counted
// from the edges, so they equal the sums of the stored entries where no
// (dst, src) pair repeats more than 256 times in a graph (an RWR
// subgraph of the wire repeats none); past that the bf16 adj saturates
// and the degrees still count every edge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
featurize_kernel(const int32_t* __restrict__ edges,  // (S, E_tot) packed
                 const int32_t* __restrict__ meta,   // (S, 3, B)
                 T* __restrict__ adj,                // (S*B, N, N)
                 T* __restrict__ m_shift,            // (S*B, N, N)
                 float* __restrict__ deg,            // (S*B, N)
                 int e_tot, int b, int n, int rows_per_tile, int id_bits) {
  constexpr bool kLo = sizeof(T) == 2;
  extern __shared__ float smem[];
  float* tile = smem;                       // rows_per_tile * n
  float* hist = smem + rows_per_tile * n;   // n
  __shared__ int s_start, s_count, s_nodes;

  const int g = blockIdx.x;
  const int s = g / b;
  const int j = g - s * b;
  const int r0 = blockIdx.y * rows_per_tile;
  const int rows = min(rows_per_tile, n - r0);
  const int32_t* seg_meta = meta + (size_t)s * 3 * b;

  // Start of graph j's run = sum of the edge counts before it.
  if (threadIdx.x < 32) {
    int acc = 0;
    for (int t = threadIdx.x; t < j; t += 32) acc += seg_meta[b + t];
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (threadIdx.x == 0) {
      s_start = acc;
      s_count = seg_meta[b + j];
      s_nodes = seg_meta[j];
    }
  }
  for (int i = threadIdx.x; i < rows * n; i += blockDim.x) tile[i] = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) hist[i] = 0.f;
  __syncthreads();

  const int start = max(s_start, 0);
  const int end = min(start + max(s_count, 0), e_tot);
  const int mask = (1 << id_bits) - 1;
  const int32_t* seg = edges + (size_t)s * e_tot;
  for (int e = start + (int)threadIdx.x; e < end; e += blockDim.x) {
    const int packed = seg[e];
    const int src = packed & mask;
    const int dst = (packed >> id_bits) & mask;
    if (src >= n || dst >= n) continue;  // outside the bucket: no slot
    atomicAdd(&hist[dst], 1.f);
    const int r = dst - r0;
    if (r >= 0 && r < rows) atomicAdd(&tile[r * n + src], 1.f);
  }
  __syncthreads();

  const int n_nodes = s_nodes;
  const size_t base = (size_t)g * n * n + (size_t)r0 * n;
  for (int i = threadIdx.x; i < rows * n; i += blockDim.x) {
    const int r = i / n;
    const int c = i - r * n;
    const int row = r0 + r;
    // The stored count: in bf16, +1 increments stop at 256.
    const float a = kLo ? fminf(tile[i], 256.f) : tile[i];
    // Separately rounded products, in the chain's order (adj * inv_row)
    // * inv_col: no contraction into an FMA.
    const float inv_r = rsqrtf(fmaxf(hist[row], 1.f));
    const float inv_c = rsqrtf(fmaxf(hist[c], 1.f));
    float m = __fmul_rn(__fmul_rn(a, inv_r), inv_c);
    // bf16: M is stored rounded, and the shift adds to the stored value.
    if (kLo) m = bf16_round(m);
    if (row == c && row < n_nodes) m = __fadd_rn(m, 1.f);
    put(adj + base + i, a);
    put(m_shift + base + i, m);
  }
  if (blockIdx.y == 0)
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      deg[(size_t)g * n + i] = kLo ? bf16_round(hist[i]) : hist[i];
}

template <class T>
int launch(const void* edges, const void* meta, void* adj, void* m_shift,
           void* deg, int s, int e_tot, int b, int n, int id_bits,
           cudaStream_t stream) {
  const int rows_per_tile = n >= 8192 ? 1 : 8192 / n;
  const size_t smem = (size_t)(rows_per_tile * n + n) * sizeof(float);
  dim3 grid(s * b, (n + rows_per_tile - 1) / rows_per_tile);
  featurize_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const int32_t*)edges, (const int32_t*)meta, (T*)adj, (T*)m_shift,
      (float*)deg, e_tot, b, n, rows_per_tile, id_bits);
  return (int)cudaGetLastError();
}

}  // namespace

// lo: adj and m_shift are bf16 (else f32); deg is f32 either way.
extern "C" int gcc_featurize_launch(const void* edges, const void* meta,
                                    void* adj, void* m_shift, void* deg,
                                    int s, int e_tot, int b, int n,
                                    int id_bits, int lo, void* stream) {
  if (s <= 0 || b <= 0 || n <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  return lo ? launch<__nv_bfloat16>(edges, meta, adj, m_shift, deg, s, e_tot,
                                    b, n, id_bits, st)
            : launch<float>(edges, meta, adj, m_shift, deg, s, e_tot, b, n,
                            id_bits, st);
}
