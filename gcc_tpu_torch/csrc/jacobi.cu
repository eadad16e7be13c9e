// Batched symmetric eigendecomposition of small matrices by parallel-order
// cyclic Jacobi (the Rayleigh-Ritz finish of the positional embedding).
//
// Replaces the TPU kernel gcc_tpu/ops/jacobi_pallas.py jacobi_eigh_tpu
// (_jacobi_kernel), and computes what the production XLA formulation
// gcc_tpu/ops/jacobi.py jacobi_eigh computes, round for round: the
// UNSORTED circle tournament in the half-split layout (pivot pair j sits
// at positions (j, j + n/2)), _rotation_cs with its eps / small-apq rule
// and tau == 0 -> t = 1, the row mix, the column mix, the constant
// re-pair permutation, V^T tracking, sweeps * (n - 1) rounds, the layout
// undone and the comparison-rank sort (_sort_eig, ties broken by index).
//
// Bound on Hopper: operations (f32, outside the tensor cores). One matrix
// is 4 KB at n = 32 and the round chain is serial, so the work per matrix
// is latency-bound; the batch (4096 matrices) supplies the parallelism.
// Design: one block per matrix, A and V^T double-buffered in shared memory
// (16 n^2 bytes: 16 KB at n = 32, 36 KB at n = 48). A round is two
// barriers: the n/2 pivot rotations, then one pass in which each thread
// takes 2x2 blocks of A (rows of pair a x columns of pair b), applies the
// row mix and then the column mix to them — the same two roundings as the
// XLA formulation — and writes them straight to their re-paired positions
// in the other buffer, V^T rows likewise. Products and sums are explicitly
// rounded (__fmul_rn / __fadd_rn), so no FMA contraction changes them.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ void rotation_cs(float app, float aqq, float apq,
                                            float eps, float* c, float* s) {
  const bool small =
      fabsf(apq) <= mul(eps, __fsqrt_rn(add(fabsf(mul(app, aqq)), eps)));
  const float safe_apq = small ? 1.f : apq;
  const float tau = __fdiv_rn(sub(aqq, app), mul(2.f, safe_apq));
  const float sgn = (tau > 0.f) ? 1.f : ((tau < 0.f) ? -1.f : 0.f);
  float t = __fdiv_rn(sgn, add(fabsf(tau), __fsqrt_rn(add(1.f, mul(tau, tau)))));
  if (tau == 0.f) t = 1.f;
  float cc = __fdiv_rn(1.f, __fsqrt_rn(add(1.f, mul(t, t))));
  float ss = mul(t, cc);
  *c = small ? 1.f : cc;
  *s = small ? 0.f : ss;
}

__global__ void __launch_bounds__(kThreads)
jacobi_kernel(const float* __restrict__ t,      // (B, n, n) symmetric
              const int* __restrict__ tables,   // layout0[n] | repair_dst[n]
              float* __restrict__ w_out,        // (B, n)
              float* __restrict__ v_out,        // (B, n, n), vectors in columns
              int n, int rounds, int descending, float eps) {
  extern __shared__ float sm[];
  const int h = n / 2;
  const int nn = n * n;
  float* a_cur = sm;
  float* a_nxt = a_cur + nn;
  float* v_cur = a_nxt + nn;
  float* v_nxt = v_cur + nn;
  float* cs_c = v_nxt + nn;       // h
  float* cs_s = cs_c + h;         // h
  float* w_nat = cs_s + h;        // n, natural order
  int* lay = (int*)(w_nat + n);   // n: round-0 position -> node index
  int* dst = lay + n;             // n: position -> position after re-pair
  int* pos_of = dst + n;          // n: node index -> round-0 position
  int* rank = pos_of + n;         // n

  const int tid = threadIdx.x;
  const float* tb = t + (size_t)blockIdx.x * nn;
  for (int i = tid; i < n; i += blockDim.x) {
    lay[i] = tables[i];
    dst[i] = tables[n + i];
    pos_of[tables[i]] = i;
  }
  __syncthreads();
  // Natural order -> round-0 layout: A = T[lay][:, lay], V^T = I[lay].
  for (int idx = tid; idx < nn; idx += blockDim.x) {
    const int i = idx / n, k = idx - (idx / n) * n;
    a_cur[idx] = tb[lay[i] * n + lay[k]];
    v_cur[idx] = (lay[i] == k) ? 1.f : 0.f;
  }
  __syncthreads();

  for (int r = 0; r < rounds; ++r) {
    for (int j = tid; j < h; j += blockDim.x)
      rotation_cs(a_cur[j * n + j], a_cur[(j + h) * n + j + h],
                  a_cur[j * n + j + h], eps, &cs_c[j], &cs_s[j]);
    __syncthreads();
    // A <- R A R^T on the 2x2 block (pair pa rows, pair pb columns):
    // row mix first, then column mix, then scatter to re-paired slots.
    for (int idx = tid; idx < h * h; idx += blockDim.x) {
      const int pa = idx / h, pb = idx - (idx / h) * h;
      const float ca = cs_c[pa], sa = cs_s[pa];
      const float cb = cs_c[pb], sb = cs_s[pb];
      const float a00 = a_cur[pa * n + pb], a01 = a_cur[pa * n + pb + h];
      const float a10 = a_cur[(pa + h) * n + pb];
      const float a11 = a_cur[(pa + h) * n + pb + h];
      const float r00 = sub(mul(ca, a00), mul(sa, a10));
      const float r01 = sub(mul(ca, a01), mul(sa, a11));
      const float r10 = add(mul(sa, a00), mul(ca, a10));
      const float r11 = add(mul(sa, a01), mul(ca, a11));
      const int i0 = dst[pa], i1 = dst[pa + h];
      const int k0 = dst[pb], k1 = dst[pb + h];
      a_nxt[i0 * n + k0] = sub(mul(cb, r00), mul(sb, r01));
      a_nxt[i0 * n + k1] = add(mul(sb, r00), mul(cb, r01));
      a_nxt[i1 * n + k0] = sub(mul(cb, r10), mul(sb, r11));
      a_nxt[i1 * n + k1] = add(mul(sb, r10), mul(cb, r11));
    }
    // V^T <- R V^T, rows re-paired.
    for (int idx = tid; idx < h * n; idx += blockDim.x) {
      const int pa = idx / n, col = idx - (idx / n) * n;
      const float ca = cs_c[pa], sa = cs_s[pa];
      const float v0 = v_cur[pa * n + col], v1 = v_cur[(pa + h) * n + col];
      v_nxt[dst[pa] * n + col] = sub(mul(ca, v0), mul(sa, v1));
      v_nxt[dst[pa + h] * n + col] = add(mul(sa, v0), mul(ca, v1));
    }
    __syncthreads();
    float* tmp = a_cur; a_cur = a_nxt; a_nxt = tmp;
    tmp = v_cur; v_cur = v_nxt; v_nxt = tmp;
  }

  // sweeps * (n - 1) re-pairs return the layout to round-0 form:
  // eigenpair at position j belongs to node index lay[j].
  for (int j = tid; j < n; j += blockDim.x) w_nat[lay[j]] = a_cur[j * n + j];
  __syncthreads();
  for (int j = tid; j < n; j += blockDim.x) {
    const float wj = w_nat[j];
    int cnt = 0;
    for (int k = 0; k < n; ++k) {
      const float wk = w_nat[k];
      const bool before = descending ? (wk > wj) : (wk < wj);
      cnt += (before || (wk == wj && k < j)) ? 1 : 0;
    }
    rank[j] = cnt;
    w_out[(size_t)blockIdx.x * n + cnt] = wj;
  }
  __syncthreads();
  // v[:, rank[j]] = natural eigenvector j = row pos_of[j] of V^T.
  float* vb = v_out + (size_t)blockIdx.x * nn;
  for (int idx = tid; idx < nn; idx += blockDim.x) {
    const int row = idx / n, j = idx - (idx / n) * n;
    vb[row * n + rank[j]] = v_cur[pos_of[j] * n + row];
  }
}

}  // namespace

extern "C" int gcc_jacobi_launch(const void* t, const void* tables, void* w,
                                 void* v, int batch, int n, int sweeps,
                                 int descending, float eps, void* stream) {
  if (batch <= 0) return 0;
  const size_t smem =
      (size_t)(4 * n * n + 2 * n) * sizeof(float) + (size_t)4 * n * sizeof(int);
  jacobi_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)t, (const int*)tables, (float*)w, (float*)v, n,
      sweeps * (n - 1), descending, eps);
  return (int)cudaGetLastError();
}
