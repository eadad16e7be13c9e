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
// is 4 KB at n = 32 and its round chain is serial, so a matrix is bound by
// latency and the batch (4096 matrices) supplies the parallelism.
//
// Three hand-written kernels, chosen by shape (jacobi_launch_plan in
// ops/jacobi.py mirrors the choice):
//   * n == 32 (the train path): jacobi_warp_kernel, one WARP per matrix
//     and no block-wide barrier in the round loop. Lane c holds column c
//     of A and column c of V^T in registers (32 + 32). The row mix of pair
//     (j, j + 16) is arithmetic inside the lane; the column mix takes lane
//     c ^ 16's value by one shuffle; the re-pair permutation is a static
//     register renaming for rows and one shuffle with a per-lane constant
//     source for columns. The pivots are picked out of the registers by a
//     chain of selects (no dynamic register index, so no local memory),
//     every lane computes the rotation of pair (lane % 16), and the 16
//     (c, s) pairs are broadcast by shuffle. The rank sort and the
//     coalesced write-out go through a warp-private slab of shared memory
//     with __syncwarp(). Four warps share a block only to fill the SM.
//   * n == 48 (the serve path: the eval profile's guarded finish, batches
//     of 64 or 128 matrices, so the card is mostly empty and the time is
//     one matrix's serial chain of sweeps * 47 rounds): jacobi_pair_kernel,
//     specialised at compile time. One block of 576 threads per matrix,
//     ONE thread per 2x2 block (pair pa rows, pair pb columns) of A, and
//     ONE barrier a round. A warp owns a 4 x 8 patch of blocks, so it
//     needs 12 rotations: its lanes read the pivots straight from the
//     current buffer, compute them (redundant arithmetic in place of a
//     24-thread phase and its barrier), and hand them round by shuffle.
//     Each thread then mixes its block (rows, then columns) and two entry
//     pairs of V^T and writes them to their re-paired slots of the other
//     buffer; its slots are constants of the thread. Rows are padded to
//     56 floats, which keeps a patch's loads and stores off each other's
//     banks. What is left of a round is the rotation's chain of dependent
//     square roots and divisions.
//   * any other even n from 4 to 118: jacobi_block_kernel, one block per
//     matrix, A and V^T double-buffered in shared memory (16 n^2 bytes),
//     two barriers a round: the n/2 rotations, then one pass in which each
//     thread takes 2x2 blocks of A, applies the row mix and then the
//     column mix, and writes them to their re-paired positions. Its
//     shared memory, 4 (4 n^2 + 2 n) + 16 n bytes, passes the 48 KB of a
//     plain launch above n = 52 (67,072 B at n = 64, 104,320 B at n = 80,
//     the widths of PE 64 on the train and eval profiles); the launch
//     then opts in to dynamic shared memory up to the 232,448 B a Hopper
//     block may hold, which n = 118 fits and n = 120 does not.
// In all, products and sums are explicitly rounded (__fmul_rn /
// __fadd_rn / ...) in the plain version's order per element (row mix,
// then column mix), so no FMA contraction changes them: Jacobi has no
// reduction, and all three kernels are bit-identical to the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kPlainSmem = 48 * 1024;  // a launch without the opt-in
constexpr size_t kMaxSmem = 232448;       // a Hopper block's most

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
jacobi_block_kernel(const float* __restrict__ t,      // (B, n, n) symmetric
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


// ---- n == 32: one warp per matrix ------------------------------------

constexpr int kN = 32, kH = 16;
constexpr int kWarps = 4;                 // matrices per block
constexpr int kSlab = kN * (kN + 1);      // floats of a warp's slab

// Re-pair permutation of the unsorted circle tournament in the
// half-split layout: new[i] = old[kPi(i)].
__host__ __device__ constexpr int kPi(int i) {
  return i == 0 ? 0
       : i == 1 ? kH
       : i < kH ? i - 1
       : i < kN - 1 ? i + 1
       : kH - 1;
}

__global__ void __launch_bounds__(kWarps * 32, 4)
jacobi_warp_kernel(const float* __restrict__ t,      // (B, 32, 32) symmetric
                   const int* __restrict__ tables,   // layout0[32] | unused
                   float* __restrict__ w_out,        // (B, 32)
                   float* __restrict__ v_out,        // (B, 32, 32)
                   int batch, int rounds, int descending, float eps) {
  __shared__ int lay[kN];                 // round-0 position -> node index
  __shared__ float slab_all[kWarps * kSlab];
  __shared__ float w_all[kWarps * kN];
  __shared__ int rp_all[kWarps * kN];
  if (threadIdx.x < kN) lay[threadIdx.x] = tables[threadIdx.x];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mat = blockIdx.x * kWarps + warp;
  if (mat >= batch) return;
  constexpr unsigned kFull = 0xffffffffu;
  float* slab = slab_all + warp * kSlab;
  float* w_nat = w_all + warp * kN;
  int* rp = rp_all + warp * kN;

  // Natural order -> round-0 layout. a[i] = A[i][lane] = T[lay i][lay lane],
  // v[i] = V^T[i][lane] = (lay i == lane).
  const float* tb = t + (size_t)mat * kN * kN;
  const int my_lay = lay[lane];
  float a[kN], v[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int li = lay[i];
    a[i] = tb[li * kN + my_lay];
    v[i] = (li == lane) ? 1.f : 0.f;
  }
  const bool upper = lane >= kH;
  const int pi_lane = (lane == 0) ? 0
                    : (lane == 1) ? kH
                    : (lane < kH) ? lane - 1
                    : (lane < kN - 1) ? lane + 1 : kH - 1;

  for (int r = 0; r < rounds; ++r) {
    // Pivot entries of pair j = lane % 16: app = A[j][j] (lane j, a[j]),
    // aqq = A[j+16][j+16] (lane j+16, a[j+16]), apq = A[j][j+16]
    // (lane j+16, a[j]).
    float diag = a[0], sup = a[0];
#pragma unroll
    for (int i = 1; i < kN; ++i) diag = (lane == i) ? a[i] : diag;
#pragma unroll
    for (int i = 1; i < kH; ++i) sup = (lane == i + kH) ? a[i] : sup;
    const float diag_o = __shfl_xor_sync(kFull, diag, kH);
    const float sup_o = __shfl_xor_sync(kFull, sup, kH);
    float c, s;
    rotation_cs(upper ? diag_o : diag, upper ? diag : diag_o,
                upper ? sup : sup_o, eps, &c, &s);
    // Row mix of A and of V^T, pair by pair, inside the lane.
#pragma unroll
    for (int j = 0; j < kH; ++j) {
      const float cj = __shfl_sync(kFull, c, j);
      const float sj = __shfl_sync(kFull, s, j);
      const float a0 = a[j], a1 = a[j + kH];
      a[j] = sub(mul(cj, a0), mul(sj, a1));
      a[j + kH] = add(mul(sj, a0), mul(cj, a1));
      const float v0 = v[j], v1 = v[j + kH];
      v[j] = sub(mul(cj, v0), mul(sj, v1));
      v[j + kH] = add(mul(sj, v0), mul(cj, v1));
    }
    // Column mix of A: columns (lane % 16, lane % 16 + 16) with this
    // lane's own (c, s): left <- c*left - s*right, right <- s*left +
    // c*right. (x - y is x + (-y) bit for bit, and the sum commutes.)
    const float s_o = upper ? s : -s;
    float m[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const float o = __shfl_xor_sync(kFull, a[i], kH);
      m[i] = add(mul(c, a[i]), mul(s_o, o));
    }
    // Re-pair: rows by renaming, columns by one shuffle.
    float nv[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      a[i] = __shfl_sync(kFull, m[kPi(i)], pi_lane);
      nv[i] = v[kPi(i)];
    }
#pragma unroll
    for (int i = 0; i < kN; ++i) v[i] = nv[i];
  }

  // sweeps * 31 re-pairs return the layout to round-0 form: the
  // eigenpair at position j belongs to node index lay[j].
  float diag = a[0];
#pragma unroll
  for (int i = 1; i < kN; ++i) diag = (lane == i) ? a[i] : diag;
  w_nat[my_lay] = diag;
  __syncwarp();
  const float wj = w_nat[lane];
  int cnt = 0;
  for (int k = 0; k < kN; ++k) {
    const float wk = w_nat[k];
    const bool before = descending ? (wk > wj) : (wk < wj);
    cnt += (before || (wk == wj && k < lane)) ? 1 : 0;
  }
  w_out[(size_t)mat * kN + cnt] = wj;
  slab[lane] = __int_as_float(cnt);       // rank of natural index `lane`
  __syncwarp();
  rp[lane] = __float_as_int(slab[my_lay]);  // rank of the pair at position
  __syncwarp();
  // v[:, rank] = eigenvector of that pair = row `position` of V^T; this
  // lane holds V^T[:, lane], i.e. row `lane` of the output.
#pragma unroll
  for (int p = 0; p < kN; ++p) slab[lane * (kN + 1) + rp[p]] = v[p];
  __syncwarp();
  float* vb = v_out + (size_t)mat * kN * kN;
#pragma unroll 4
  for (int row = 0; row < kN; ++row)
    vb[row * kN + lane] = slab[row * (kN + 1) + lane];
}

// ---- n == 48: one thread per 2x2 block, one barrier a round -----------

constexpr int kPairN = 48;

template <int N>
__global__ void __launch_bounds__((N / 2) * (N / 2))
jacobi_pair_kernel(const float* __restrict__ t,      // (B, N, N) symmetric
                   const int* __restrict__ tables,   // layout0[N] | repair_dst[N]
                   float* __restrict__ w_out,        // (B, N)
                   float* __restrict__ v_out,        // (B, N, N)
                   int rounds, int descending, float eps) {
  constexpr int H = N / 2, LD = N + 8, T = H * H;
  constexpr int kRows = 4;                // a warp's patch: 4 x 8 pairs
  constexpr int kPatchCols = H / 8;
  static_assert(H % 8 == 0 && H % kRows == 0,
                "patches of 4 x 8 pairs, a rotation a lane");
  __shared__ float a_buf[2][N * LD];
  __shared__ float v_buf[2][N * LD];
  __shared__ float w_nat[N];              // natural order
  __shared__ int lay[N];                  // round-0 position -> node index
  __shared__ int pos_of[N];               // node index -> round-0 position
  __shared__ int rank[N];
  constexpr unsigned kFull = 0xffffffffu;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* tb = t + (size_t)blockIdx.x * N * N;
  if (tid < N) {
    lay[tid] = tables[tid];
    pos_of[tables[tid]] = tid;
  }
  __syncthreads();
  // Natural order -> round-0 layout: A = T[lay][:, lay], V^T = I[lay].
  for (int idx = tid; idx < N * N; idx += T) {
    const int i = idx / N, k = idx - i * N;
    a_buf[0][i * LD + k] = tb[lay[i] * N + lay[k]];
    v_buf[0][i * LD + k] = (lay[i] == k) ? 1.f : 0.f;
  }
  // This thread's block (pair pa rows, pair pb columns) and where the
  // re-pair sends its rows and columns.
  const int pa0 = (warp / kPatchCols) * kRows, pb0 = (warp % kPatchCols) * 8;
  const int pa = pa0 + (lane >> 3), pb = pb0 + (lane & 7);
  const int i0 = tables[N + pa], i1 = tables[N + pa + H];
  const int k0 = tables[N + pb], k1 = tables[N + pb + H];
  // The rotation this lane computes: lanes 0-7 the patch's column pairs,
  // lanes 8 to 11 its row pairs (the rest repeat those).
  const int j = lane < 8 ? pb0 + lane : pa0 + (lane - 8) % kRows;
  __syncthreads();

  int cur = 0;
  for (int r = 0; r < rounds; ++r) {
    const float* a = a_buf[cur];
    const float* v = v_buf[cur];
    float* an = a_buf[cur ^ 1];
    float* vn = v_buf[cur ^ 1];
    float c, s;
    rotation_cs(a[j * LD + j], a[(j + H) * LD + j + H], a[j * LD + j + H],
                eps, &c, &s);
    const float cb = __shfl_sync(kFull, c, lane & 7);
    const float sb = __shfl_sync(kFull, s, lane & 7);
    const float a00 = a[pa * LD + pb], a01 = a[pa * LD + pb + H];
    const float a10 = a[(pa + H) * LD + pb];
    const float a11 = a[(pa + H) * LD + pb + H];
    const float v00 = v[pa * LD + pb], v01 = v[pa * LD + pb + H];
    const float v10 = v[(pa + H) * LD + pb];
    const float v11 = v[(pa + H) * LD + pb + H];
    const float ca = __shfl_sync(kFull, c, 8 + (lane >> 3));
    const float sa = __shfl_sync(kFull, s, 8 + (lane >> 3));
    // A <- R A R^T on the block: row mix, then column mix, then the
    // re-paired slots.
    const float r00 = sub(mul(ca, a00), mul(sa, a10));
    const float r01 = sub(mul(ca, a01), mul(sa, a11));
    const float r10 = add(mul(sa, a00), mul(ca, a10));
    const float r11 = add(mul(sa, a01), mul(ca, a11));
    an[i0 * LD + k0] = sub(mul(cb, r00), mul(sb, r01));
    an[i0 * LD + k1] = add(mul(sb, r00), mul(cb, r01));
    an[i1 * LD + k0] = sub(mul(cb, r10), mul(sb, r11));
    an[i1 * LD + k1] = add(mul(sb, r10), mul(cb, r11));
    // V^T <- R V^T on columns pb and pb + H, rows re-paired.
    vn[i0 * LD + pb] = sub(mul(ca, v00), mul(sa, v10));
    vn[i1 * LD + pb] = add(mul(sa, v00), mul(ca, v10));
    vn[i0 * LD + pb + H] = sub(mul(ca, v01), mul(sa, v11));
    vn[i1 * LD + pb + H] = add(mul(sa, v01), mul(ca, v11));
    __syncthreads();
    cur ^= 1;
  }

  // sweeps * (N - 1) re-pairs return the layout to round-0 form:
  // eigenpair at position j belongs to node index lay[j].
  const float* a = a_buf[cur];
  const float* v = v_buf[cur];
  if (tid < N) w_nat[lay[tid]] = a[tid * LD + tid];
  __syncthreads();
  if (tid < N) {
    const float wj = w_nat[tid];
    int cnt = 0;
    for (int k = 0; k < N; ++k) {
      const float wk = w_nat[k];
      const bool before = descending ? (wk > wj) : (wk < wj);
      cnt += (before || (wk == wj && k < tid)) ? 1 : 0;
    }
    rank[tid] = cnt;
    w_out[(size_t)blockIdx.x * N + cnt] = wj;
  }
  __syncthreads();
  // v[:, rank[j]] = natural eigenvector j = row pos_of[j] of V^T.
  float* vb = v_out + (size_t)blockIdx.x * N * N;
  for (int idx = tid; idx < N * N; idx += T) {
    const int row = idx / N, jj = idx - row * N;
    vb[row * N + rank[jj]] = v[pos_of[jj] * LD + row];
  }
}

}  // namespace

extern "C" int gcc_jacobi_launch(const void* t, const void* tables, void* w,
                                 void* v, int batch, int n, int sweeps,
                                 int descending, float eps, void* stream) {
  if (batch <= 0) return 0;
  const size_t smem =
      (size_t)(4 * n * n + 2 * n) * sizeof(float) + (size_t)4 * n * sizeof(int);
  if (n % 2 != 0 || n < 4 || smem > kMaxSmem || sweeps < 0)
    return (int)cudaErrorInvalidValue;
  if (n == kN) {
    jacobi_warp_kernel<<<(batch + kWarps - 1) / kWarps, kWarps * 32, 0,
                         (cudaStream_t)stream>>>(
        (const float*)t, (const int*)tables, (float*)w, (float*)v, batch,
        sweeps * (n - 1), descending, eps);
    return (int)cudaGetLastError();
  }
  if (n == kPairN) {
    jacobi_pair_kernel<kPairN><<<batch, (kPairN / 2) * (kPairN / 2), 0,
                                 (cudaStream_t)stream>>>(
        (const float*)t, (const int*)tables, (float*)w, (float*)v,
        sweeps * (n - 1), descending, eps);
    return (int)cudaGetLastError();
  }
  if (smem > kPlainSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        jacobi_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  jacobi_block_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)t, (const int*)tables, (float*)w, (float*)v, n,
      sweeps * (n - 1), descending, eps);
  return (int)cudaGetLastError();
}
