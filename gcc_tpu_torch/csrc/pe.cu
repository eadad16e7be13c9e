// Block subspace iteration for the Laplacian positional embedding: the
// leading-k invariant subspace of each graph's shifted operator m_shift.
//
// Replaces the TPU kernel gcc_tpu/ops/pe_pallas.py pe_subspace_iterate
// (_pe_kernel) and computes what it computes, on the basis stored
// transposed as Q^T (k, N):
//   * iters / orth_every rounds, each of orth_every power steps
//     Q^T <- lo(Q^T) lo(M) and one Newton-Schulz orthonormalization of
//     ns_steps steps (column-unit rows, Gershgorin scale
//     1/sqrt(max_a sum_b |G_ab|), then Q^T <- 1.5 Q^T - 0.5 lo(G) lo(Q^T)
//     with G = lo(Q^T) lo(Q^T)^T), where lo() rounds to bf16 and every
//     sum is kept in f32 (pe_pallas.py:58-65, 71-76, 98);
//   * polish f32 power steps, each followed by column-unit rows;
//   * a final_ns-step Newton-Schulz finish in f32;
//   * the 1e-20 floors of colunit and of the Gershgorin scale.
//
// Bound on Hopper: operations — about 31.5 MFLOP per graph at N = 128,
// k = 32 (6 M of them f32) against 64 KB of M read once. This first
// kernel runs every product on the CUDA cores in f32 (a product of two
// bf16 values is exact in f32, so the bf16 rounding points are kept
// exactly; only the order of the f32 sums differs); tensor-core MMA is
// later work.
// Design: one block per graph. M's bf16 copy (N^2 * 2 bytes: 128 KB at
// N = 256) and Q^T live in shared memory for the whole iteration, so M is
// read from device memory once for the rounds; the two f32 polish steps
// read the f32 M from device memory (L2) again. Thread (column c, row
// group) owns 16 rows of column c of Q^T: a power step streams M's row j
// (coalesced over c) against broadcast float4 reads of its Q^T rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;  // rows of Q^T per thread

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct Ctx {
  int n, kp;                  // nodes, block width padded to 16
  float* qt;                  // shared (kp, n)
  float* gram;                // shared (kp, kp)
  float* red;                 // shared (kp)
  float* scal;                // shared (1)
  const __nv_bfloat16* mlo;   // shared (n, n)
  const float* mg;            // device memory (n, n), f32
  int col, r0, warp, lane, nwarps;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Q^T <- lo(Q^T) @ M: LO reads bf16-rounded Q^T and the bf16 copy of M;
// otherwise full f32 Q^T and the f32 M from device memory.
template <bool LO>
__device__ void power_step(Ctx& x) {
  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
  const int n = x.n, c = x.col;
  for (int j = 0; j < n; j += 4) {
    float m[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      m[u] = LO ? __bfloat162float(x.mlo[(j + u) * n + c])
                : x.mg[(size_t)(j + u) * n + c];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float4 q = *reinterpret_cast<const float4*>(&x.qt[(x.r0 + i) * n + j]);
      if (LO) {
        q.x = bf16r(q.x); q.y = bf16r(q.y); q.z = bf16r(q.z); q.w = bf16r(q.w);
      }
      acc[i] = fmaf(q.x, m[0], acc[i]);
      acc[i] = fmaf(q.y, m[1], acc[i]);
      acc[i] = fmaf(q.z, m[2], acc[i]);
      acc[i] = fmaf(q.w, m[3], acc[i]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRows; ++i) x.qt[(x.r0 + i) * n + c] = acc[i];
  __syncthreads();
}

// Rows of Q^T (= columns of Q) scaled to unit norm, floor 1e-20.
__device__ void colunit(Ctx& x) {
  const int n = x.n;
  for (int r = x.warp; r < x.kp; r += x.nwarps) {
    float s = 0.f;
    for (int c = x.lane; c < n; c += 32) {
      const float v = x.qt[r * n + c];
      s = fmaf(v, v, s);
    }
    s = warp_sum(s);
    if (x.lane == 0) x.red[r] = fmaxf(__fsqrt_rn(s), 1e-20f);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float* p = &x.qt[(x.r0 + i) * n + x.col];
    *p = __fdiv_rn(*p, x.red[x.r0 + i]);
  }
  __syncthreads();
}

// G = lo(Q^T) lo(Q^T)^T, one warp per (a <= b) entry.
template <bool LO>
__device__ void gram(Ctx& x) {
  const int n = x.n, kp = x.kp;
  for (int idx = x.warp; idx < kp * kp; idx += x.nwarps) {
    const int a = idx / kp, b = idx - (idx / kp) * kp;
    if (b < a) continue;
    float s = 0.f;
    for (int c = x.lane; c < n; c += 32) {
      float u = x.qt[a * n + c], v = x.qt[b * n + c];
      if (LO) { u = bf16r(u); v = bf16r(v); }
      s = fmaf(u, v, s);
    }
    s = warp_sum(s);
    if (x.lane == 0) {
      x.gram[a * kp + b] = s;
      x.gram[b * kp + a] = s;
    }
  }
  __syncthreads();
}

template <bool LO>
__device__ void ns_orth(Ctx& x, int steps) {
  const int n = x.n, kp = x.kp;
  colunit(x);
  gram<LO>(x);
  if (x.warp == 0) {
    float best = 0.f;
    for (int a = x.lane; a < kp; a += 32) {
      float s = 0.f;
      for (int b = 0; b < kp; ++b) s = __fadd_rn(s, fabsf(x.gram[a * kp + b]));
      best = fmaxf(best, s);
    }
    for (int off = 16; off > 0; off >>= 1)
      best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, off));
    if (x.lane == 0) x.scal[0] = rsqrtf(fmaxf(best, 1e-20f));
  }
  __syncthreads();
  const float sc = x.scal[0];
  const float sc2 = __fmul_rn(sc, sc);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float* p = &x.qt[(x.r0 + i) * n + x.col];
    *p = __fmul_rn(*p, sc);
  }
  for (int idx = threadIdx.x; idx < kp * kp; idx += blockDim.x)
    x.gram[idx] = __fmul_rn(x.gram[idx], sc2);
  __syncthreads();
  for (int it = 0; it < steps; ++it) {
    if (it) gram<LO>(x);
    float acc[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
    for (int b = 0; b < kp; ++b) {
      float qv = x.qt[b * n + x.col];
      if (LO) qv = bf16r(qv);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float gv = x.gram[(x.r0 + i) * kp + b];
        if (LO) gv = bf16r(gv);
        acc[i] = fmaf(gv, qv, acc[i]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float* p = &x.qt[(x.r0 + i) * n + x.col];
      *p = __fsub_rn(__fmul_rn(1.5f, *p), __fmul_rn(0.5f, acc[i]));
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(1024)
pe_kernel(const float* __restrict__ m,    // (B, n, n)
                          const float* __restrict__ q0,   // (B, n, k)
                          float* __restrict__ out,        // (B, n, k)
                          int n, int k, int kp, int rounds, int orth_every,
                          int ns_steps, int polish, int final_ns, int lo) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* mlo = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* qt = reinterpret_cast<float*>(smem_raw + (size_t)n * n * 2);
  float* gm = qt + kp * n;
  float* red = gm + kp * kp;
  float* scal = red + kp;

  const float* mg = m + (size_t)blockIdx.x * n * n;
  const float* qb = q0 + (size_t)blockIdx.x * n * k;
  if (lo)
    for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x)
      mlo[idx] = __float2bfloat16_rn(mg[idx]);
  for (int idx = threadIdx.x; idx < kp * n; idx += blockDim.x) {
    const int r = idx / n, c = idx - (idx / n) * n;
    qt[idx] = (r < k) ? qb[c * k + r] : 0.f;  // padded rows stay zero
  }
  __syncthreads();

  Ctx x;
  x.n = n; x.kp = kp; x.qt = qt; x.gram = gm; x.red = red; x.scal = scal;
  x.mlo = mlo; x.mg = mg;
  x.col = threadIdx.x % n;
  x.r0 = (threadIdx.x / n) * kRows;
  x.warp = threadIdx.x / 32; x.lane = threadIdx.x % 32;
  x.nwarps = blockDim.x / 32;

  for (int r = 0; r < rounds; ++r) {
    if (lo) {
      for (int s = 0; s < orth_every; ++s) power_step<true>(x);
      ns_orth<true>(x, ns_steps);
    } else {
      for (int s = 0; s < orth_every; ++s) power_step<false>(x);
      ns_orth<false>(x, ns_steps);
    }
  }
  for (int p = 0; p < polish; ++p) {
    power_step<false>(x);
    colunit(x);
  }
  if (final_ns) ns_orth<false>(x, final_ns);

  float* ob = out + (size_t)blockIdx.x * n * k;
  for (int idx = threadIdx.x; idx < n * k; idx += blockDim.x) {
    const int c = idx / k, r = idx - (idx / k) * k;
    ob[idx] = qt[r * n + c];
  }
}

}  // namespace

extern "C" int gcc_pe_smem_bytes(int n, int k) {
  const int kp = (k + 15) / 16 * 16;
  return n * n * 2 + (kp * n + kp * kp + kp + 4) * 4;
}

extern "C" int gcc_pe_launch(const void* m, const void* q0, void* out,
                             int batch, int n, int k, int iters,
                             int orth_every, int ns_steps, int polish,
                             int final_ns, int lo, void* stream) {
  if (batch <= 0) return 0;
  if (n % 32 != 0 || k <= 0 || orth_every <= 0)
    return (int)cudaErrorInvalidValue;
  const int kp = (k + 15) / 16 * 16;
  const int threads = kp / kRows * n;
  if (threads > 1024) return (int)cudaErrorInvalidConfiguration;
  const int smem = gcc_pe_smem_bytes(n, k);
  cudaError_t err = cudaFuncSetAttribute(
      pe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int rounds = max(1, iters / orth_every);
  pe_kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(
      (const float*)m, (const float*)q0, (float*)out, n, k, kp, rounds,
      orth_every, ns_steps, polish, final_ns, lo);
  return (int)cudaGetLastError();
}
