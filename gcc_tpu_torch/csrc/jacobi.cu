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
// latency and the batch (4096 matrices) supplies the parallelism. Every
// product and sum is rounded on its own (no FMA), so half the card's
// counted f32 rate is the ceiling, and a round moves about 4 n^2 words of
// shared memory (A and V^T read once and written once) beside them.
//
// Three hand-written kernels, chosen by shape (jacobi_launch_plan in
// ops/jacobi.py mirrors the choice, gcc_jacobi_plan below reports it):
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
//   * n == 48, 64, 80 (the eval profile's guarded finish at PE 32; PE 64's
//     finish on the train profile, n = 64 on 4096 matrices, and on the
//     eval profile and the giant path, n = 80 on 64 matrices or one):
//     jacobi_pair_kernel<N, ITEMS, MIN_BLOCKS>, one block per matrix, one
//     thread per ITEMS 2x2 blocks (pair pa rows, pair pb columns) of A and
//     ONE barrier a round. A warp owns a (4 ITEMS) x 8 patch of blocks, so
//     it needs 8 + 4 ITEMS rotations: its lanes read the pivots straight
//     from the current buffer, compute them (redundant arithmetic in place
//     of a phase of n/2 threads and its barrier), and hand them round by
//     shuffle. Each thread then mixes its blocks (rows, then columns) and
//     two entry pairs of V^T per block and writes them to their re-paired
//     slots of the other buffer; its slots are constants of the thread.
//     Rows are padded to N + 8 floats, which keeps a patch's loads off
//     each other's banks (and most of the re-pair's stores). The round
//     loop runs two rounds a pass, so both buffers' addresses are
//     constants. A matrix at n = 48 fills a block alone (a batch of 64 is
//     bound by one matrix's chain of rounds); at n = 64 and 4096 matrices
//     the card is full and a round is bound by the SM's issue slots and
//     shared-memory traffic (about 4 n^2 words a round), so fewer warps of
//     more items spend less on the redundant rotations. Shared memory
//     (4 (4 N (N + 8) + N) + 12 N bytes) passes a plain launch's 48 KB at
//     n = 64 (74,752 B) and 80 (113,920 B): the launch then opts in to
//     dynamic shared memory.
//   * any other even n from 4 to 118 (no configuration the repository
//     ships): jacobi_block_kernel, one block per matrix, A and V^T
//     double-buffered in shared memory (16 n^2 bytes), two barriers a
//     round: the n/2 rotations, then one pass in which each thread takes
//     2x2 blocks of A, applies the row mix and then the column mix, and
//     writes them to their re-paired positions. Its shared memory,
//     4 (4 n^2 + 2 n) + 16 n bytes, passes the 48 KB of a plain launch
//     above n = 52; the launch then opts in to dynamic shared memory up to
//     the 232,448 B a Hopper block may hold, which n = 118 fits and
//     n = 120 does not.
//   * every even n from 120 to 832 (PE 104 and more on the eval profile,
//     PE 120 and more on the train profile; no configuration the
//     repository ships): the same block kernel with A and V^T, still
//     double-buffered, in a per-matrix device scratch of 16 n^2 bytes that
//     the wrapper allocates (the L1 and L2 caches serve it); c/s, the
//     eigenvalues and the index tables stay in shared memory (24 n bytes),
//     and a block has 1024 threads, so more loads are in flight. The same
//     rounds in the same order: bit for bit its plain version. Slow by
//     design: a round's every entry goes through device memory twice.
// In all, products and sums are explicitly rounded (__fmul_rn /
// __fadd_rn / ...) in the plain version's order per element (row mix,
// then column mix), so no FMA contraction changes them: Jacobi has no
// reduction, and all three kernels are bit-identical to the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDeviceThreads = 1024;      // the device-memory variant
constexpr size_t kPlainSmem = 48 * 1024;  // a launch without the opt-in
constexpr size_t kMaxSmem = 232448;       // a Hopper block's most
constexpr int kMaxN = 832;                // the widest n the kernels take

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

// DEVICE: A and V^T in `scratch` (B, 4, n, n) instead of shared memory.
template <bool DEVICE>
__global__ void __launch_bounds__(DEVICE ? kDeviceThreads : kThreads)
jacobi_block_kernel(const float* __restrict__ t,      // (B, n, n) symmetric
              const int* __restrict__ tables,   // layout0[n] | repair_dst[n]
              float* __restrict__ w_out,        // (B, n)
              float* __restrict__ v_out,        // (B, n, n), vectors in columns
              float* scratch,                   // DEVICE: (B, 4, n, n)
              int n, int rounds, int descending, float eps) {
  extern __shared__ float sm[];
  const int h = n / 2;
  const int nn = n * n;
  float* a_cur = DEVICE ? scratch + (size_t)blockIdx.x * 4 * nn : sm;
  float* a_nxt = a_cur + nn;
  float* v_cur = a_nxt + nn;
  float* v_nxt = v_cur + nn;
  float* cs_c = DEVICE ? sm : v_nxt + nn;   // h
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

// ---- n == 48, 64, 80: a thread per 2x2 blocks, one barrier a round -----

// Shared memory of the pair kernel: A and V^T double-buffered with rows
// padded to N + 8 floats, the eigenvalues and three index tables.
__host__ __device__ constexpr size_t pair_smem(int n) {
  return (size_t)(4 * n * (n + 8) + n) * sizeof(float)
       + (size_t)3 * n * sizeof(int);
}

// ITEMS: 2x2 blocks a thread mixes, one above the other 4 pair rows apart,
// so a warp owns a (4 ITEMS) x 8 patch of blocks and needs 8 + 4 ITEMS
// rotations. MIN_BLOCKS: blocks an SM is to hold (caps the registers).
template <int N, int ITEMS, int MIN_BLOCKS>
__global__ void __launch_bounds__((N / 2) * (N / 2) / ITEMS, MIN_BLOCKS)
jacobi_pair_kernel(const float* __restrict__ t,      // (B, N, N) symmetric
                   const int* __restrict__ tables,   // layout0[N] | repair_dst[N]
                   float* __restrict__ w_out,        // (B, N)
                   float* __restrict__ v_out,        // (B, N, N)
                   int rounds, int descending, float eps) {
  constexpr int H = N / 2, LD = N + 8, T = H * H / ITEMS;
  constexpr int kRows = 4 * ITEMS;        // a warp's patch: kRows x 8 pairs
  constexpr int kPatchCols = H / 8;
  static_assert(H % 8 == 0 && H % kRows == 0 && 8 + kRows <= 32,
                "patches of 4 ITEMS x 8 pairs, a rotation a lane");
  extern __shared__ float sm[];           // A, A', V^T, V^T' (N x LD each)
  float* w_nat = sm + 4 * N * LD;         // natural order
  int* lay = (int*)(w_nat + N);           // round-0 position -> node index
  int* pos_of = lay + N;                  // node index -> round-0 position
  int* rank = pos_of + N;
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
    sm[i * LD + k] = tb[lay[i] * N + lay[k]];
    sm[2 * N * LD + i * LD + k] = (lay[i] == k) ? 1.f : 0.f;
  }
  // This thread's blocks (pair pa[it] rows, pair pb columns) and where
  // the re-pair sends their rows and columns.
  const int pa0 = (warp / kPatchCols) * kRows, pb0 = (warp % kPatchCols) * 8;
  const int pb = pb0 + (lane & 7);
  const int k0 = tables[N + pb], k1 = tables[N + pb + H];
  int pa[ITEMS], i0[ITEMS], i1[ITEMS];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    pa[it] = pa0 + 4 * it + (lane >> 3);
    i0[it] = tables[N + pa[it]];
    i1[it] = tables[N + pa[it] + H];
  }
  // The rotation this lane computes: lanes 0-7 the patch's column pairs,
  // lanes 8 to 7 + kRows its row pairs (the rest repeat those).
  const int j = lane < 8 ? pb0 + lane : pa0 + (lane - 8) % kRows;
  __syncthreads();

  // One round from (a, v) into (an, v'). The loop below runs two a pass,
  // so that each buffer's address is a constant of the code.
  auto round = [&](const float* a, const float* v, float* an, float* vn) {
    float c, s;
    rotation_cs(a[j * LD + j], a[(j + H) * LD + j + H], a[j * LD + j + H],
                eps, &c, &s);
    const float cb = __shfl_sync(kFull, c, lane & 7);
    const float sb = __shfl_sync(kFull, s, lane & 7);
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int p = pa[it];
      const float a00 = a[p * LD + pb], a01 = a[p * LD + pb + H];
      const float a10 = a[(p + H) * LD + pb];
      const float a11 = a[(p + H) * LD + pb + H];
      const float v00 = v[p * LD + pb], v01 = v[p * LD + pb + H];
      const float v10 = v[(p + H) * LD + pb];
      const float v11 = v[(p + H) * LD + pb + H];
      const float ca = __shfl_sync(kFull, c, 8 + 4 * it + (lane >> 3));
      const float sa = __shfl_sync(kFull, s, 8 + 4 * it + (lane >> 3));
      // A <- R A R^T on the block: row mix, then column mix, then the
      // re-paired slots.
      const float r00 = sub(mul(ca, a00), mul(sa, a10));
      const float r01 = sub(mul(ca, a01), mul(sa, a11));
      const float r10 = add(mul(sa, a00), mul(ca, a10));
      const float r11 = add(mul(sa, a01), mul(ca, a11));
      an[i0[it] * LD + k0] = sub(mul(cb, r00), mul(sb, r01));
      an[i0[it] * LD + k1] = add(mul(sb, r00), mul(cb, r01));
      an[i1[it] * LD + k0] = sub(mul(cb, r10), mul(sb, r11));
      an[i1[it] * LD + k1] = add(mul(sb, r10), mul(cb, r11));
      // V^T <- R V^T on columns pb and pb + H, rows re-paired.
      vn[i0[it] * LD + pb] = sub(mul(ca, v00), mul(sa, v10));
      vn[i1[it] * LD + pb] = add(mul(sa, v00), mul(ca, v10));
      vn[i0[it] * LD + pb + H] = sub(mul(ca, v01), mul(sa, v11));
      vn[i1[it] * LD + pb + H] = add(mul(sa, v01), mul(ca, v11));
    }
    __syncthreads();
  };
  float* const a0 = sm;
  float* const a1 = sm + N * LD;
  float* const v0 = sm + 2 * N * LD;
  float* const v1 = sm + 3 * N * LD;
  for (int r = 0; r < rounds; r += 2) {
    round(a0, v0, a1, v1);
    if (r + 1 < rounds) round(a1, v1, a0, v0);
  }

  // sweeps * (N - 1) re-pairs return the layout to round-0 form:
  // eigenpair at position j belongs to node index lay[j].
  const float* a = (rounds & 1) ? a1 : a0;
  const float* v = (rounds & 1) ? v1 : v0;
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

// The pair kernel's instances: items per thread and blocks per SM, chosen
// by timing each width's main-path batch (gcc_tpu_torch/ops/
// jacobi_instances.py). n = 48 (the eval profile's finish, 64 or 128
// matrices): 576 threads, 32 registers, so that 3 blocks fit an SM at any
// batch. n = 64 (PE 64's train profile, 4096 matrices): 256 threads of 4
// items, 3 blocks an SM (shared memory allows no more); fewer warps spend
// fewer issue slots on the redundant rotations. n = 80 (PE 64's eval
// profile and giant finish, 64 matrices or one: one block an SM): 320
// threads of 5 items.
constexpr int kPair48Items = 1, kPair48Blocks = 3;
constexpr int kPair64Items = 4, kPair64Blocks = 3;
constexpr int kPair80Items = 5, kPair80Blocks = 1;

template <int N, int ITEMS, int MIN_BLOCKS>
int launch_pair(const void* t, const void* tables, void* w, void* v,
                int batch, int sweeps, int descending, float eps,
                void* stream) {
  constexpr size_t smem = pair_smem(N);
  const auto kernel = jacobi_pair_kernel<N, ITEMS, MIN_BLOCKS>;
  if (smem > kPlainSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<batch, (N / 2) * (N / 2) / ITEMS, smem, (cudaStream_t)stream>>>(
      (const float*)t, (const int*)tables, (float*)w, (float*)v,
      sweeps * (N - 1), descending, eps);
  return (int)cudaGetLastError();
}

// Shared memory of the block kernel: A and V^T double-buffered, c/s and
// the eigenvalues (2 n floats), four index tables.
size_t block_smem(int n) {
  return (size_t)(4 * n * n + 2 * n) * sizeof(float)
       + (size_t)4 * n * sizeof(int);
}

}  // namespace

// Kernels by plan: out[0] of gcc_jacobi_plan.
enum Kernel { kWarpKernel = 0, kPairKernel, kBlockKernel, kDeviceKernel };

// The launch plan of width n, as gcc_jacobi_launch launches it: out =
// {kernel (Kernel), threads per block, bytes of shared memory per block,
// bytes of device scratch per matrix}. ops/jacobi.py jacobi_launch_plan
// mirrors it.
extern "C" int gcc_jacobi_plan(int n, int* out) {
  if (n % 2 != 0 || n < 4 || n > kMaxN) return (int)cudaErrorInvalidValue;
  const int pair_items = n == 48 ? kPair48Items
                       : n == 64 ? kPair64Items
                       : n == 80 ? kPair80Items : 0;
  out[3] = 0;
  if (n == kN) {
    out[0] = kWarpKernel;
    out[1] = kWarps * 32;
    out[2] = (int)(sizeof(int) * kN + sizeof(float) * kWarps * (kSlab + kN)
                   + sizeof(int) * kWarps * kN);
  } else if (pair_items) {
    out[0] = kPairKernel;
    out[1] = (n / 2) * (n / 2) / pair_items;
    out[2] = (int)pair_smem(n);
  } else if (block_smem(n) > kMaxSmem) {
    // c/s and the eigenvalues (2 n floats), four index tables; A and V^T,
    // double-buffered, in the scratch.
    out[0] = kDeviceKernel;
    out[1] = kDeviceThreads;
    out[2] = (int)((size_t)2 * n * sizeof(float) + (size_t)4 * n * sizeof(int));
    out[3] = (int)((size_t)4 * n * n * sizeof(float));
  } else {
    out[0] = kBlockKernel;
    out[1] = kThreads;
    out[2] = (int)block_smem(n);
  }
  return 0;
}

// scratch: (batch, 4, n, n) f32 for n > 118 (A and V^T of the device-
// memory variant), unused and may be null else.
extern "C" int gcc_jacobi_launch(const void* t, const void* tables, void* w,
                                 void* v, void* scratch, int batch, int n,
                                 int sweeps, int descending, float eps,
                                 void* stream) {
  if (batch <= 0) return 0;
  int plan[4];
  if (sweeps < 0 || gcc_jacobi_plan(n, plan) != 0)
    return (int)cudaErrorInvalidValue;
  const int threads = plan[1];
  const size_t smem = (size_t)plan[2];
  const int rounds = sweeps * (n - 1);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (plan[0]) {
    case kWarpKernel:
      jacobi_warp_kernel<<<(batch + kWarps - 1) / kWarps, threads, 0, st>>>(
          (const float*)t, (const int*)tables, (float*)w, (float*)v, batch,
          rounds, descending, eps);
      return (int)cudaGetLastError();
    case kPairKernel:
      if (n == 48)
        return launch_pair<48, kPair48Items, kPair48Blocks>(
            t, tables, w, v, batch, sweeps, descending, eps, stream);
      if (n == 64)
        return launch_pair<64, kPair64Items, kPair64Blocks>(
            t, tables, w, v, batch, sweeps, descending, eps, stream);
      return launch_pair<80, kPair80Items, kPair80Blocks>(
          t, tables, w, v, batch, sweeps, descending, eps, stream);
    case kDeviceKernel:
      if (scratch == nullptr) return (int)cudaErrorInvalidValue;
      jacobi_block_kernel<true><<<batch, threads, smem, st>>>(
          (const float*)t, (const int*)tables, (float*)w, (float*)v,
          (float*)scratch, n, rounds, descending, eps);
      return (int)cudaGetLastError();
    default:
      if (smem > kPlainSmem) {
        const cudaError_t err = cudaFuncSetAttribute(
            jacobi_block_kernel<false>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
      }
      jacobi_block_kernel<false><<<batch, threads, smem, st>>>(
          (const float*)t, (const int*)tables, (float*)w, (float*)v, nullptr,
          n, rounds, descending, eps);
      return (int)cudaGetLastError();
  }
}
