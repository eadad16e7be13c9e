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
//   * every other even n from 4 to 832 (PE 80 and PE 104 to 816 on the
//     eval profile, no configuration the repository ships):
//     jacobi_cluster_kernel<ITEMS, DEVICE>, the pair kernel's design
//     spread over a thread block cluster of C blocks per matrix (C = 1
//     up to n = 118), each holding a contiguous range of pairs, ONE
//     cluster barrier a round, the rows that cross a range's ends written
//     into the neighbours' shared memory and each pair's pivots read from
//     the block holding it (the section below). The card holds a batch's
//     clusters in one wave where it can: at (16, 256, 256) 16 clusters of
//     6 blocks, at (64, 128, 128) 64 of 2, at (128, 96, 96) 128 blocks of
//     one. Above n = 328 no cluster of 8 holds A and V^T in shared
//     memory, and they live in a per-matrix device scratch instead, read
//     and written by C SMs in rows of 128 bytes.
// In all, products and sums are explicitly rounded (__fmul_rn /
// __fadd_rn / ...) in the plain version's order per element (row mix,
// then column mix), so no FMA contraction changes them: Jacobi has no
// reduction, and all three kernels are bit-identical to the plain version.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr size_t kPlainSmem = 48 * 1024;  // a launch without the opt-in
constexpr size_t kMaxSmem = 232448;       // a Hopper block's most
constexpr int kMaxN = 832;                // the widest n the kernels take

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// V^T's storage (the reference's GCC_TPU_JACOBI_V_DTYPE=bf16,
// gcc_tpu/ops/jacobi.py:151-168): each round rotates V^T in f32 and, with
// RV, rounds the result to bf16 (to nearest even) before it is stored; A
// and the eigenvalues never read V^T and stay as in f32.
template <bool RV>
__device__ __forceinline__ float vround(float x) {
  if constexpr (RV) return __bfloat162float(__float2bfloat16_rn(x));
  else return x;
}

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

// ---- every other even n: the cluster pair kernel ----------------------
//
// Every even n from 4 to 832 other than 32, 48, 64 and 80. A thread block
// cluster of C blocks per matrix; block b holds the contiguous pairs
// [pstart[b], pstart[b + 1]) and both full rows of each (top row j, bottom
// row j + h), in A, A', V^T and V^T'. A warp mixes a (4 ITEMS) x 8 patch of
// 2x2 blocks (its block's pairs x every column pair), as the pair kernel
// does, computing the patch's 8 + 4 ITEMS rotations in its lanes and
// handing them round by shuffle; the patch's slots and tables are
// constants of the warp, and it issues all its loads before it mixes.
// The re-pair moves the top row of pair j to pair j + 1 and the bottom row
// to pair j - 1 (unsorted_tournament in ops/jacobi.py), so only the rows
// at the ends of a block's range cross to a neighbour, through
// distributed shared memory (st.shared::cluster); the column mix and the
// column re-pair act inside a row. Every block needs all h rotations:
// each lane reads its pair's pivots (A[j][j], A[j+h][j+h], A[j][j+h]) from
// the block holding the pair (pushing each pivot from its writer into
// every block measured 3x slower: the warps that write pivots lag the
// rest, PERF.md). One cluster barrier a round (release / acquire; a block
// barrier at C = 1), and double buffering makes it enough. Rows are padded
// to LD floats, the least >= n that is 8 mod 16, so a warp's 4 rows x 8
// columns of loads fall on distinct banks. Placement: in the blocks'
// shared memory wherever some C <= 8 (the portable cluster size) makes a
// block's share fit, that is every even n <= 328 (C = 1 up to n = 118);
// above that, the same kernel and schedule with A and V^T in a per-matrix
// device scratch (read through L2, ld.global.cg), spread over C SMs. There
// HBM's rate sets the pace once the batch's scratch outgrows L2, so a
// warp's patch is ITEMS x 32 pairs (each load and store 32 consecutive
// floats of a row, rows padded to 128 bytes) and each round's rotations
// are computed once a block into shared memory before the mix (one block
// barrier more a round). What bounds the shared placement (PERF.md):
// issue slots; a round's redundant rotations and addressing cost about
// as much as its arithmetic, and a cluster barrier with its remote pivot
// loads about 1 us a round.

constexpr int kMaxCluster = 8;            // the portable cluster size
constexpr int kPairRangeInts = 16;        // pstart: C + 1 of them used
constexpr int kSMs = 132;                 // one wave of an H100's SMs
// Items a thread in the device scratch, where a warp walks several patches
// a round (the scratch's traffic, not the items, sets the pace).
constexpr int kDeviceItems = 2;

// Warps a block of the ITEMS instance may have: the registers of more
// items a thread allow fewer.
__host__ __device__ constexpr int cluster_max_warps(int items) {
  return items <= 3 ? 32 : 16;
}

// Row stride of the buffers: in shared memory the least >= n that is 8
// mod 16 floats; in the device scratch n rounded up to 128 bytes.
__host__ __device__ constexpr int cluster_ld(int n, bool device) {
  return device ? (n + 31) / 32 * 32 : n + (24 - n % 16) % 16;
}

// A warp's patch of 2x2 blocks: rows of the block's pairs x columns (pairs
// pb): 4 ITEMS x 8 in shared memory, ITEMS x 32 in the device scratch.
__host__ __device__ constexpr int patch_cols(bool device) {
  return device ? 32 : 8;
}
__host__ __device__ constexpr int patch_rows(int items, bool device) {
  return 32 / patch_cols(device) * items;
}

// Pairs the largest block of a cluster of c holds: ceil(h / c).
__host__ __device__ constexpr int cluster_pairs(int n, int c) {
  return (n / 2 + c - 1) / c;
}

// Shared memory of the cluster pair kernel: A, A', V^T and V^T' (2 M rows
// of LD floats each; in the device scratch instead when `device`, with a
// round's rotations, n floats), the eigenvalues (n), four n-int tables,
// the pair ranges and the ranks (n ints).
__host__ __device__ constexpr size_t cluster_smem(int n, int c, bool device) {
  return (device ? (size_t)4 * n
                 : (size_t)32 * cluster_pairs(n, c) * cluster_ld(n, false))
       + (size_t)24 * n + sizeof(int) * kPairRangeInts;
}

template <bool DEVICE>
__device__ __forceinline__ float ld_buf(const float* p) {
  if constexpr (DEVICE) return __ldcg(p);   // rows other SMs wrote: from L2
  else return *p;
}

// The shared::cluster address of shared address `addr` in block `rank`.
__device__ __forceinline__ unsigned mapa_u32(unsigned addr, unsigned rank) {
  unsigned out;
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// A store to a shared::cluster address (this block's or another's).
__device__ __forceinline__ void st_cluster(unsigned addr, float val) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" :: "r"(addr), "f"(val));
}

// A load from a shared::cluster address.
__device__ __forceinline__ float ld_cluster(unsigned addr) {
  float val;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(val) : "r"(addr));
  return val;
}

// One barrier of the whole cluster (C > 1: barrier.cluster.arrive, with
// release semantics, and wait, with acquire) or of the block (C = 1).
__device__ __forceinline__ void round_barrier(int csize) {
  if (csize > 1)
    asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
                 "barrier.cluster.wait.acquire.aligned;" ::: "memory");
  else
    __syncthreads();
}

template <int ITEMS, bool DEVICE, bool RV>
__global__ void __launch_bounds__(32 * cluster_max_warps(ITEMS))
jacobi_cluster_kernel(const float* __restrict__ t,     // (B, n, n) symmetric
                      const int* __restrict__ tables,  // cluster_tables
                      float* __restrict__ w_out,       // (B, n)
                      float* __restrict__ v_out,       // (B, n, n)
                      float* scratch,                  // DEVICE: (B, 4, n, LD)
                      int n, int csize, int rounds, int descending,
                      float eps) {
  // A warp's patch: kRows x kCols pairs, lane = quad * kCols + col, items
  // kQuads rows apart.
  constexpr int kCols = patch_cols(DEVICE), kRows = patch_rows(ITEMS, DEVICE);
  constexpr int kQuads = 32 / kCols;
  constexpr unsigned kFull = 0xffffffffu;
  extern __shared__ float sm[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int h = n / 2, ld = cluster_ld(n, DEVICE);
  const int pairs = cluster_pairs(n, csize);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, warps = nthreads >> 5;
  const int rank = csize > 1 ? (int)cluster.block_rank() : 0;
  const int mat = blockIdx.x / csize;
  const size_t buf = DEVICE ? (size_t)n * ld : (size_t)2 * pairs * ld;
  float* const a0 = DEVICE ? scratch + (size_t)mat * 4 * buf : sm;
  float* const a1 = a0 + buf;
  float* const v0 = a1 + buf;
  float* const v1 = v0 + buf;
  float* const w_nat = DEVICE ? sm : sm + 4 * buf;  // natural order
  int* const lay = (int*)(w_nat + n);   // round-0 position -> node index
  int* const cdst = lay + n;            // position -> position after re-pair
  int* const rdst = cdst + n;           // position -> rank << 16 | buffer row
                                        //   of its position after re-pair
  int* const home = rdst + n;           // position -> rank << 16 | buffer row
  int* const pstart = home + n;         // block b: pairs [pstart[b], [b + 1])
  int* const rk = pstart + kPairRangeInts;  // rank of each row's eigenpair
  float* const rot = (float*)(rk + n);  // DEVICE: the round's c[h] | s[h]

  for (int i = tid; i < 4 * n + kPairRangeInts; i += nthreads)
    lay[i] = tables[i];
  __syncthreads();
  const int p0 = pstart[rank], m = pstart[rank + 1] - p0;
  // Buffer rows of local pair 0's top and bottom rows.
  const int top0 = DEVICE ? p0 : 0, bot0 = DEVICE ? p0 + h : pairs;
  const float* tb = t + (size_t)mat * n * n;
  // This block's rows in the round-0 layout: A = T[lay][:, lay], V^T = I[lay].
  for (int idx = tid; idx < 2 * m * n; idx += nthreads) {
    const int r = idx / n, k = idx - r * n;
    const bool top = r < m;
    const int l = top ? r : r - m;
    const int x = top ? p0 + l : p0 + l + h;
    const int row = (top ? top0 : bot0) + l;
    a0[row * ld + k] = tb[lay[x] * n + lay[k]];
    v0[row * ld + k] = lay[x] == k ? 1.f : 0.f;
  }
  round_barrier(csize);

  // The buffers by element offset from a0: a1 = a0 + buf, v0 = a0 + 2 buf,
  // v1 = a0 + 3 buf. Even rounds read A and V^T at offset 0 and write at
  // buf; odd rounds the other way. In shared memory a0 is sm, indexed
  // as such (so the warp-uniform offsets fold into the LDS / STS); rows
  // of another block go through shared::cluster addresses.
  const int vofs = 2 * (int)buf, odelta = (int)buf;
  unsigned sbase = 0;
  if constexpr (!DEVICE) sbase = (unsigned)__cvta_generic_to_shared(sm);
  auto load = [&](int off) -> float {
    if constexpr (DEVICE) return __ldcg(a0 + off);   // rows other SMs wrote
    else return sm[off];
  };
  auto load_from = [&](int q, int off) -> float {   // from block q's buffer
    return q == rank ? sm[off] : ld_cluster(mapa_u32(sbase + 4u * off, q));
  };
  auto store = [&](int off, float val) {
    if constexpr (DEVICE) a0[off] = val;
    else sm[off] = val;
  };

  // A warp's patch: kRows of the block's pairs x kCols column pairs (in
  // shared memory 4 ITEMS x 8: the rotations handed round by shuffle, a
  // warp's loads on distinct banks; in the device scratch ITEMS x 32: the
  // rotations from shared memory, each load and store 32 consecutive
  // floats of a row), and everything about it that does not change from
  // round to round.
  struct Patch {
    int pb, k0, k1, j, lbase;
    int src[ITEMS];          // top row of pair lbase + kQuads it, column pb
    int d0[ITEMS], d1[ITEMS];  // its rows' destination rows, from a1
    unsigned ok, far;        // bit it: a real 2x2 block; a row leaves
    int piv_top, piv_bot;    // pivots of pair j: block << 16 | row
  };
  const int col_patches = (h + kCols - 1) / kCols;
  const int patches = (pairs + kRows - 1) / kRows * col_patches;
  const int quad = lane / kCols, col = lane % kCols;
  const int bot = (bot0 - top0) * ld;     // bottom row from its top row
  auto setup = [&](int patch) {
    Patch P;
    const int prow = patch / col_patches;
    const int pa0 = prow * kRows, pb0 = (patch - prow * col_patches) * kCols;
    const bool col_ok = pb0 + col < h;
    P.pb = col_ok ? pb0 + col : h - 1;
    P.k0 = cdst[P.pb];
    P.k1 = cdst[P.pb + h];
    P.lbase = pa0 + quad;
    P.ok = 0;
    P.far = 0;
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int l = P.lbase + kQuads * it;
      const int lc = l < m ? l : 0;
      if (col_ok && l < m) P.ok |= 1u << it;
      P.src[it] = (top0 + lc) * ld + P.pb;
      const int e0 = rdst[p0 + lc], e1 = rdst[p0 + lc + h];
      P.d0[it] = (e0 & 0xffff) * ld + odelta;
      P.d1[it] = (e1 & 0xffff) * ld + odelta;
      if (!DEVICE && ((e0 >> 16) != rank || (e1 >> 16) != rank))
        P.far |= 1u << it;
    }
    // The rotation this lane computes: lanes 0-7 the patch's column
    // pairs, lanes 8 to 7 + kRows its row pairs (the rest repeat those).
    P.j = min(lane < 8 ? pb0 + lane : p0 + pa0 + (lane - 8) % kRows, h - 1);
    P.piv_top = home[P.j];
    P.piv_bot = home[P.j + h];
    return P;
  };

  // One round of one patch: every load of its 2x2 blocks, its rotations,
  // then the mix and the stores to the re-paired slots.
  auto mix = [&](const Patch& P, int r) {
    const bool odd = r & 1;
    const int po = odd ? odelta : 0;
    float x[ITEMS][8];
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int o = P.src[it] + po;
      x[it][0] = load(o);
      x[it][1] = load(o + h);
      x[it][2] = load(o + bot);
      x[it][3] = load(o + bot + h);
      x[it][4] = load(o + vofs);
      x[it][5] = load(o + vofs + h);
      x[it][6] = load(o + vofs + bot);
      x[it][7] = load(o + vofs + bot + h);
    }
    float cb, sb, cr[ITEMS], sr[ITEMS];
    if constexpr (DEVICE) {
      // The round's rotations, from shared memory (rotations() below).
      cb = rot[P.pb];
      sb = rot[h + P.pb];
#pragma unroll
      for (int it = 0; it < ITEMS; ++it) {
        const int j = min(p0 + P.lbase + kQuads * it, h - 1);
        cr[it] = rot[j];
        sr[it] = rot[h + j];
      }
    } else {
      // Pair j's pivots, from the blocks holding its top and bottom rows.
      float c, s;
      const int ot = (P.piv_top & 0xffff) * ld + P.j + po;
      const int ob = (P.piv_bot & 0xffff) * ld + P.j + h + po;
      rotation_cs(load_from(P.piv_top >> 16, ot),
                  load_from(P.piv_bot >> 16, ob),
                  load_from(P.piv_top >> 16, ot + h), eps, &c, &s);
      // Every shuffle before the first branch: the warp is converged.
      cb = __shfl_sync(kFull, c, col);
      sb = __shfl_sync(kFull, s, col);
#pragma unroll
      for (int it = 0; it < ITEMS; ++it) {
        cr[it] = __shfl_sync(kFull, c, 8 + 4 * it + quad);
        sr[it] = __shfl_sync(kFull, s, 8 + 4 * it + quad);
      }
    }
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const float cp = cr[it], sp = sr[it];
      // A <- R A R^T on the block: row mix, then column mix.
      const float r00 = sub(mul(cp, x[it][0]), mul(sp, x[it][2]));
      const float r01 = sub(mul(cp, x[it][1]), mul(sp, x[it][3]));
      const float r10 = add(mul(sp, x[it][0]), mul(cp, x[it][2]));
      const float r11 = add(mul(sp, x[it][1]), mul(cp, x[it][3]));
      const float o00 = sub(mul(cb, r00), mul(sb, r01));
      const float o01 = add(mul(sb, r00), mul(cb, r01));
      const float o10 = sub(mul(cb, r10), mul(sb, r11));
      const float o11 = add(mul(sb, r10), mul(cb, r11));
      // V^T <- R V^T on columns pb and pb + h.
      const float w00 = vround<RV>(sub(mul(cp, x[it][4]), mul(sp, x[it][6])));
      const float w10 = vround<RV>(add(mul(sp, x[it][4]), mul(cp, x[it][6])));
      const float w01 = vround<RV>(sub(mul(cp, x[it][5]), mul(sp, x[it][7])));
      const float w11 = vround<RV>(add(mul(sp, x[it][5]), mul(cp, x[it][7])));
      if (!(P.ok >> it & 1u)) continue;
      // The re-paired slots: rows to their blocks, columns in the row.
      const int e0 = P.d0[it] - po, e1 = P.d1[it] - po;
      const int pb = P.pb;
      if (!(P.far >> it & 1u)) {
        store(e0 + P.k0, o00);
        store(e0 + P.k1, o01);
        store(e1 + P.k0, o10);
        store(e1 + P.k1, o11);
        store(e0 + vofs + pb, w00);
        store(e1 + vofs + pb, w10);
        store(e0 + vofs + pb + h, w01);
        store(e1 + vofs + pb + h, w11);
      } else if constexpr (!DEVICE) {
        const int l = P.lbase + kQuads * it;
        const unsigned q0 = (unsigned)(rdst[p0 + l] >> 16);
        const unsigned q1 = (unsigned)(rdst[p0 + l + h] >> 16);
        const unsigned a0s = mapa_u32(sbase + 4u * e0, q0);
        const unsigned a1s = mapa_u32(sbase + 4u * e1, q1);
        st_cluster(a0s + 4u * P.k0, o00);
        st_cluster(a0s + 4u * P.k1, o01);
        st_cluster(a1s + 4u * P.k0, o10);
        st_cluster(a1s + 4u * P.k1, o11);
        st_cluster(a0s + 4u * (vofs + pb), w00);
        st_cluster(a1s + 4u * (vofs + pb), w10);
        st_cluster(a0s + 4u * (vofs + pb + h), w01);
        st_cluster(a1s + 4u * (vofs + pb + h), w11);
      }
    }
  };

  // In the device scratch a pivot read is an L2 round trip: the block
  // computes the round's h rotations once into shared memory, from the
  // pivots in the scratch, and then mixes (a block barrier between).
  auto rotations = [&](int r) {
    if constexpr (DEVICE) {
      const int po = (r & 1) ? odelta : 0;
      for (int j = tid; j < h; j += nthreads) {
        const int ot = (home[j] & 0xffff) * ld + j + po;
        const int ob = (home[j + h] & 0xffff) * ld + j + h + po;
        rotation_cs(__ldcg(a0 + ot), __ldcg(a0 + ob), __ldcg(a0 + ot + h),
                    eps, &rot[j], &rot[h + j]);
      }
      __syncthreads();
    }
  };

  if (patches == warps) {
    // A patch a warp (the plan's rule wherever the warps allow it).
    const Patch P = setup(warp);
    for (int r = 0; r < rounds; ++r) {
      rotations(r);
      mix(P, r);
      round_barrier(csize);
    }
  } else {
    for (int r = 0; r < rounds; ++r) {
      rotations(r);
      for (int patch = warp; patch < patches; patch += warps)
        mix(setup(patch), r);
      round_barrier(csize);
    }
  }

  // sweeps * (n - 1) re-pairs return the layout to round-0 form: the
  // eigenpair at position x belongs to node index lay[x]. Every
  // eigenvalue, from the block holding it.
  const float* af = (rounds & 1) ? a1 : a0;
  const float* vf = (rounds & 1) ? v1 : v0;
  for (int x = tid; x < n; x += nthreads) {
    const int hm = home[x];
    const float* src = af;
    if constexpr (!DEVICE)
      if (hm >> 16 != rank)
        src = cluster.map_shared_rank(const_cast<float*>(af), hm >> 16);
    w_nat[lay[x]] = ld_buf<DEVICE>(src + (hm & 0xffff) * ld + x);
  }
  round_barrier(csize);   // no block exits while another reads it
  // The ranks of this block's eigenpairs (ties broken by index).
  for (int r = tid; r < 2 * m; r += nthreads) {
    const int jn = lay[r < m ? p0 + r : p0 + r - m + h];
    const float wj = w_nat[jn];
    int cnt = 0;
    for (int k = 0; k < n; ++k) {
      const float wk = w_nat[k];
      const bool before = descending ? (wk > wj) : (wk < wj);
      cnt += (before || (wk == wj && k < jn)) ? 1 : 0;
    }
    rk[r] = cnt;
    w_out[(size_t)mat * n + cnt] = wj;
  }
  __syncthreads();
  // v[:, rank] = the eigenvector of the pair at position x = row x of V^T,
  // a warp's stores along one row of v.
  float* vb = v_out + (size_t)mat * n * n;
  for (int idx = tid; idx < 2 * m * n; idx += nthreads) {
    const int row = idx / (2 * m), r = idx - row * (2 * m);
    const int br = r < m ? top0 + r : bot0 + r - m;
    vb[(size_t)row * n + rk[r]] = ld_buf<DEVICE>(vf + br * ld + row);
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

template <bool RV>
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
      v[j] = vround<RV>(sub(mul(cj, v0), mul(sj, v1)));
      v[j + kH] = vround<RV>(add(mul(sj, v0), mul(cj, v1)));
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
template <int N, int ITEMS, int MIN_BLOCKS, bool RV>
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
      vn[i0[it] * LD + pb] = vround<RV>(sub(mul(ca, v00), mul(sa, v10)));
      vn[i1[it] * LD + pb] = vround<RV>(add(mul(sa, v00), mul(ca, v10)));
      vn[i0[it] * LD + pb + H] =
          vround<RV>(sub(mul(ca, v01), mul(sa, v11)));
      vn[i1[it] * LD + pb + H] =
          vround<RV>(add(mul(sa, v01), mul(ca, v11)));
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

template <int N, int ITEMS, int MIN_BLOCKS, bool RV>
int launch_pair(const void* t, const void* tables, void* w, void* v,
                int batch, int sweeps, int descending, float eps,
                void* stream) {
  constexpr size_t smem = pair_smem(N);
  const auto kernel = jacobi_pair_kernel<N, ITEMS, MIN_BLOCKS, RV>;
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

// The cluster pair kernel's launch plan (ops/jacobi.py jacobi_launch_plan
// mirrors it): the cluster size, the 2x2 blocks a thread mixes, the
// threads, the placement of A and V^T and the bytes they take.
struct ClusterPlan {
  int cluster, items, threads, device;
  size_t smem, scratch;
};

// The least C <= 8 whose share of A and V^T fits a block; 0 if none.
int least_cluster(int n) {
  for (int c = 1; c <= kMaxCluster; ++c)
    if (cluster_smem(n, c, false) <= kMaxSmem) return c;
  return 0;
}

// Patches of a block holding `pairs` pairs.
int cluster_patches(int n, int pairs, int items, bool device) {
  const int rows = patch_rows(items, device), cols = patch_cols(device);
  return (pairs + rows - 1) / rows * ((n / 2 + cols - 1) / cols);
}

// Items a thread (6, 4, 3 or 2), by a rule fitted to the timings of
// ops/jacobi_instances.py: first a patch a warp and at least 16 warps,
// then the fewest patch rows past the block's pairs, then the most items;
// failing that, a patch a warp and the most warps; failing that, the
// fewest 2x2 blocks a thread mixes in a round.
int cluster_items(int n, int pairs) {
  int best = 0;
  long long key_best = 1LL << 62;
  for (const int items : {6, 4, 3, 2}) {
    const int warps = cluster_max_warps(items);
    const int patches = cluster_patches(n, pairs, items, false);
    const int rows = (pairs + 4 * items - 1) / (4 * items) * 4 * items;
    long long key;
    if (patches <= warps && patches >= 16)
      key = (long long)rows * 8 + (8 - items);
    else if (patches <= warps)
      key = (1LL << 40) + (long long)(32 - patches) * 8 + (8 - items);
    else
      key = (2LL << 40) + (long long)(patches + warps - 1) / warps * items * 8
            + (8 - items);
    if (key < key_best) {
      best = items;
      key_best = key;
    }
  }
  return best;
}

// held[c - 1]: clusters of c blocks the card holds at once. cluster and
// items: 0 for the plan's own choice, or a choice to check. Returns a CUDA
// error code (cudaErrorInvalidValue on a choice the kernel does not take).
int cluster_plan(int n, int batch, const int* held, int cluster, int items,
                 ClusterPlan* p) {
  const int least = least_cluster(n);
  p->device = least == 0;
  const int lo = p->device ? 1 : least, hi = n / 2 < kMaxCluster ? n / 2
                                                                  : kMaxCluster;
  if (cluster != 0) {
    if (cluster < lo || cluster > hi) return (int)cudaErrorInvalidValue;
    p->cluster = cluster;
  } else if (least == 1) {
    p->cluster = 1;          // a block holds the whole matrix
  } else {
    // Raised while the batch's clusters fill at most one wave of the SMs
    // and the card holds them all at once.
    int c = lo;
    while (c < hi && batch * (c + 1) <= kSMs && batch <= held[c]) ++c;
    p->cluster = c;
  }
  const int pairs = cluster_pairs(n, p->cluster);
  if (p->device) {
    if (items != 0 && items != kDeviceItems) return (int)cudaErrorInvalidValue;
    items = kDeviceItems;
  } else if (items == 0) {
    items = cluster_items(n, pairs);
  } else if (items != 2 && items != 3 && items != 4 && items != 6) {
    return (int)cudaErrorInvalidValue;
  }
  p->items = items;
  const int patches = cluster_patches(n, pairs, items, p->device);
  const int warps = patches < cluster_max_warps(items)
                        ? patches : cluster_max_warps(items);
  p->threads = 32 * warps;
  p->smem = cluster_smem(n, p->cluster, p->device);
  p->scratch = p->device ? (size_t)16 * n * cluster_ld(n, true) : 0;
  return 0;
}

// held[c - 1] = how many clusters of c blocks of the cluster pair kernel
// the current device holds at once, c = 1 .. 8, at one block an SM (the
// most shared memory a block may hold; cudaOccupancyMaxActiveClusters).
// Asked once per device. Returns a CUDA error code.
constexpr int kHeldDevices = 16;
std::atomic<int> g_held[kHeldDevices][kMaxCluster];

int cluster_held(int* held) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const auto kern = jacobi_cluster_kernel<6, false, false>;
  for (int c = 1; c <= kMaxCluster; ++c) {
    int v = dev < kHeldDevices
                ? g_held[dev][c - 1].load(std::memory_order_relaxed) : 0;
    if (v == 0) {
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
      if (err != cudaSuccess) return (int)err;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = c;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(c, 1, 1);
      cfg.blockDim = dim3(32 * cluster_max_warps(6), 1, 1);
      cfg.dynamicSmemBytes = kMaxSmem;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      err = cudaOccupancyMaxActiveClusters(&v, kern, &cfg);
      if (err != cudaSuccess) return (int)err;
      if (dev < kHeldDevices)
        g_held[dev][c - 1].store(v, std::memory_order_relaxed);
    }
    held[c - 1] = v;
  }
  return 0;
}

template <int ITEMS, bool DEVICE, bool RV>
int launch_cluster(const ClusterPlan& p, const void* t, const void* tables,
                   void* w, void* v, void* scratch, int batch, int n,
                   int rounds, int descending, float eps,
                   cudaStream_t stream) {
  const auto kern = jacobi_cluster_kernel<ITEMS, DEVICE, RV>;
  if (p.smem > kPlainSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * p.cluster, 1, 1);
  cfg.blockDim = dim3(p.threads, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = p.cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, (const float*)t, (const int*)tables, (float*)w, (float*)v,
      (float*)scratch, n, p.cluster, rounds, descending, eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool RV>
int launch_cluster_shared(const ClusterPlan& p, const void* t,
                          const void* tables, void* w, void* v, int batch,
                          int n, int rounds, int descending, float eps,
                          cudaStream_t stream) {
  switch (p.items) {
    case 2:
      return launch_cluster<2, false, RV>(p, t, tables, w, v, nullptr, batch, n,
                                      rounds, descending, eps, stream);
    case 3:
      return launch_cluster<3, false, RV>(p, t, tables, w, v, nullptr, batch, n,
                                      rounds, descending, eps, stream);
    case 4:
      return launch_cluster<4, false, RV>(p, t, tables, w, v, nullptr, batch, n,
                                      rounds, descending, eps, stream);
    default:
      return launch_cluster<6, false, RV>(p, t, tables, w, v, nullptr, batch, n,
                                      rounds, descending, eps, stream);
  }
}

}  // namespace

// Kernels by plan: out[0] of gcc_jacobi_plan.
enum Kernel { kWarpKernel = 0, kPairKernel, kClusterKernel };

// held[c - 1], c = 1 .. 8: clusters of c blocks of the cluster pair kernel
// the current device holds at once (the plan's input).
extern "C" int gcc_jacobi_held(int* held) { return cluster_held(held); }

// The launch plan of (batch, n, n) on the current device, as
// gcc_jacobi_launch launches it: out = {kernel (Kernel), threads per block,
// bytes of shared memory per block, bytes of device scratch per matrix,
// blocks per matrix (the cluster), 2x2 blocks a thread, placement of A and
// V^T (0 registers or shared memory, 1 the device scratch)}. ops/jacobi.py
// jacobi_launch_plan mirrors it.
extern "C" int gcc_jacobi_plan(int n, int batch, int* out) {
  if (n % 2 != 0 || n < 4 || n > kMaxN || batch < 1)
    return (int)cudaErrorInvalidValue;
  const int pair_items = n == 48 ? kPair48Items
                       : n == 64 ? kPair64Items
                       : n == 80 ? kPair80Items : 0;
  out[3] = 0;
  out[4] = 1;
  out[6] = 0;
  if (n == kN) {
    out[0] = kWarpKernel;
    out[1] = kWarps * 32;
    out[2] = (int)(sizeof(int) * kN + sizeof(float) * kWarps * (kSlab + kN)
                   + sizeof(int) * kWarps * kN);
    out[5] = 0;
    return 0;
  }
  if (pair_items) {
    out[0] = kPairKernel;
    out[1] = (n / 2) * (n / 2) / pair_items;
    out[2] = (int)pair_smem(n);
    out[5] = pair_items;
    return 0;
  }
  int held[kMaxCluster];
  int err = cluster_held(held);
  if (err != 0) return err;
  ClusterPlan p;
  err = cluster_plan(n, batch, held, 0, 0, &p);
  if (err != 0) return err;
  out[0] = kClusterKernel;
  out[1] = p.threads;
  out[2] = (int)p.smem;
  out[3] = (int)p.scratch;
  out[4] = p.cluster;
  out[5] = p.items;
  out[6] = p.device;
  return 0;
}

namespace {

// gcc_jacobi_launch's body for one storage of V^T (RV: bf16-rounded).
template <bool RV>
int launch_jacobi(const void* t, const void* tables, void* w, void* v,
                  void* scratch, int batch, int n, int sweeps, int descending,
                  float eps, int cluster, int items, void* stream) {
  if (batch <= 0) return 0;
  if (sweeps < 0 || n % 2 != 0 || n < 4 || n > kMaxN)
    return (int)cudaErrorInvalidValue;
  const int rounds = sweeps * (n - 1);
  const cudaStream_t st = (cudaStream_t)stream;
  const bool fixed = n == kN || n == 48 || n == 64 || n == 80;
  if (fixed && (cluster != 0 || items != 0)) return (int)cudaErrorInvalidValue;
  if (n == kN) {
    jacobi_warp_kernel<RV>
        <<<(batch + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(
        (const float*)t, (const int*)tables, (float*)w, (float*)v, batch,
        rounds, descending, eps);
    return (int)cudaGetLastError();
  }
  if (n == 48)
    return launch_pair<48, kPair48Items, kPair48Blocks, RV>(
        t, tables, w, v, batch, sweeps, descending, eps, stream);
  if (n == 64)
    return launch_pair<64, kPair64Items, kPair64Blocks, RV>(
        t, tables, w, v, batch, sweeps, descending, eps, stream);
  if (n == 80)
    return launch_pair<80, kPair80Items, kPair80Blocks, RV>(
        t, tables, w, v, batch, sweeps, descending, eps, stream);
  int held[kMaxCluster];
  int err = cluster_held(held);
  if (err != 0) return err;
  ClusterPlan p;
  err = cluster_plan(n, batch, held, cluster, items, &p);
  if (err != 0) return err;
  if (p.device && scratch == nullptr) return (int)cudaErrorInvalidValue;
  // A cluster the card cannot place is refused here, not left to hang
  // (held counts clusters at a block's most shared memory and threads).
  if (held[p.cluster - 1] == 0) return (int)cudaErrorLaunchOutOfResources;
  return p.device
             ? launch_cluster<kDeviceItems, true, RV>(
                   p, t, tables, w, v, scratch, batch, n, rounds, descending,
                   eps, st)
             : launch_cluster_shared<RV>(p, t, tables, w, v, batch, n, rounds,
                                         descending, eps, st);
}

}  // namespace

// tables: layout0[n] | repair destination[n] (the warp and pair kernels
// read these), then for the cluster pair kernel the destination's and the
// position's block and buffer row[n each] and the pair ranges[16]
// (ops/jacobi.py cluster_tables, built for `cluster` blocks a matrix).
// scratch: (batch, 4, n, LD) f32 where A and V^T are placed in the device
// scratch, unused and may be null else. cluster, items: the cluster pair
// kernel's blocks per matrix and 2x2 blocks per thread, 0 for the plan's.
// v_bf16: round V^T to bf16 after each round's rotation (else f32).
extern "C" int gcc_jacobi_launch(const void* t, const void* tables, void* w,
                                 void* v, void* scratch, int batch, int n,
                                 int sweeps, int descending, float eps,
                                 int cluster, int items, int v_bf16,
                                 void* stream) {
  return v_bf16 ? launch_jacobi<true>(t, tables, w, v, scratch, batch, n,
                                      sweeps, descending, eps, cluster, items,
                                      stream)
                : launch_jacobi<false>(t, tables, w, v, scratch, batch, n,
                                       sweeps, descending, eps, cluster,
                                       items, stream);
}
