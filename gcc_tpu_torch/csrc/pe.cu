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
// M comes in f32 or in bf16 (the reference's GCC_TPU_ADJ_DTYPE=bf16
// operator, pe_pallas.py:49): a bf16 M is its own lo(M), and the f32 steps
// widen it as they read it (m_at, ld_m4, stage_m4 below). The choice is a
// flag the launch passes, read at M's loads only.
//
// Bound on Hopper: operations — about 28.4 MFLOP per graph at N = 128,
// k = 32, 23.1 M of them bf16-input products and 5.3 M f32, against 64 KB
// of M read once. The f32 part is three quarters of the bound: the f32
// rate outside the tensor cores is a fifteenth of the bf16 rate.
//
// Design: one block of 2N threads (N/16 warps) per graph.
//   * bf16 rounds, on the tensor cores (mma.sync.aligned.m16n8k16, bf16
//     inputs, f32 accumulators, operands by ldmatrix). Warp w owns the 16
//     columns [16w, 16w + 16) of Q^T for the whole round: its f32 values
//     live in the accumulator registers (kp/16 row tiles x 2 column tiles
//     x 4), and Q^T is rounded to bf16 ONCE, where it is written: each
//     step's epilogue stores the bf16 copy that the next product reads
//     (two buffers, so a step costs one barrier). The power step is
//     A = lo(Q^T) (row-major, k along j), B = lo(M); the NS update is
//     A = lo(G), B = lo(Q^T); the Gram is A = lo(Q^T), B = lo(Q^T)^T in
//     16x8 tiles, one per warp where there are warps enough (else its
//     depth is split and the parts are summed in a fixed order).
//     colunit's sums of squares come from the accumulators (quad shuffle,
//     then one partial per warp).
//   * M is read as the reference reads it. m_shift is symmetric as a
//     matrix but not bit for bit, so the product needs B[j][c] = M[j][c]:
//     the bf16 copy is staged AS STORED (row j, column c contiguous) and
//     the B fragments are loaded with ldmatrix.trans — no transposed copy
//     is made, and M[c][j] is never read in its place.
//   * Rows of the bf16 tiles are padded by 8 values (16 bytes), which
//     spreads the 8 rows of an ldmatrix phase and the epilogue's bf16x2
//     stores over all 32 banks.
//   * f32 work (polish power steps, the NS finish, and every round when
//     lo = 0, a mode only the checks use) stays in full f32 on the CUDA
//     cores, register-tiled from shared memory: a thread owns 4 columns x
//     kp/8 rows of Q^T (64 to 96 FMAs per 8 vector loads); the f32 Gram is
//     4x4 tiles of the upper triangle, mirrored, up to four lanes to a
//     tile, their parts summed by shuffle in a fixed order; the NS update
//     writes a second buffer, so a step is two barriers. The f32 power
//     steps stage the f32 M through shared memory in panels of 16 rows
//     with cp.async (three buffers, two copies in flight), so the copy of
//     panel p + 1 overlaps the FMAs on panel p. The two f32 Q^T buffers
//     reuse the bytes of M's bf16 copy, and the panels those of the bf16
//     tiles, which the rounds are done with by then.
//   * Work follows the data. A graph of the batch has fewer nodes than
//     the bucket's N (a mean of 56 in the 128 bucket), and the padding
//     rows and columns of M and Q^T are zero and stay zero. The block
//     finds the extent of the non-zeros while it converts M, rounds it up
//     to 16, and runs every product over the live rows and columns only
//     (skipped terms are exact zeros, so the sums do not change). With
//     f32 rounds (lo = 0) it takes all N.
//   * Gershgorin: thread a sums |G[b][a]| over b in order with __fadd_rn.
//     It reads COLUMN a (no bank conflict); G is symmetric bit for bit
//     (entry (a, b) and (b, a) are the same products in the same order),
//     so this is row a's sum.
// The launch plan (threads, shared-memory bytes, splits) is computed by
// pe_plan below and mirrored by pe_launch_plan in ops/pe.py.
//
// Above N = 256 the bf16 copy of M no longer fits a block's shared memory
// (532 KB at N = 512). Those shapes, 256 < N <= 832, take the STREAMED
// plan below (pe_cluster_kernel): the same steps in the
// same order on a cluster of 2 or 4 blocks per graph, the rounds on the
// tensor cores against a bf16 copy of M that the kernel makes once in a
// device scratch and streams for every power step, Q^T in registers and
// in a bf16 copy in every block's shared memory.
//
// Widths 48 < k <= 80 (PE 64: k = 64 on the train profile, 80 with the
// eval profile's 16 guards) take the WIDE plan, which is these two kernels
// at five row tiles (KT = 4, 5), chosen by bytes:
//   * pe_kernel where its shared memory fits a block (N <= 224 at kp = 64,
//     N <= 160 at kp = 80: 130 KB at (128, 64), 171 KB at (128, 80)), one
//     block an SM. The rounds run on the tensor cores against M's bf16
//     copy in shared memory, made once; the f32 Gram is split over depth
//     (`chunks`) and the f32 update and power steps are register-tiled,
//     so every thread is busy in the polish and the finish.
//   * pe_cluster_kernel above (the N = 256 training bucket at k = 64, the
//     eval shapes at k = 80), one block per graph up to N = 256 (a batch
//     of 4096 graphs then takes one SM a graph, not two): the bf16 copy of
//     M made once in the device scratch and streamed by cp.async, the
//     NS update a row tile at a time (a whole panel of accumulators beside
//     Q^T's would spill). Where two bf16 copies of Q^T do not
//     fit beside the rest (kp = 80 above N = 384, kp = 64 above N = 512)
//     a block keeps ONE, and every store to it waits at a barrier until
//     its readers are done; the f32 Q^T of the polish and the finish then
//     lives in the scratch (one copy for the cluster, read through L1/L2)
//     in place of every block's shared memory. The partial Grams (2 kp^2
//     f32, 50 KB at kp = 80) outgrow the warps' rings; their region grows.
//   * Both at five row tiles split every bf16 A operand into a high and a
//     low part for the tensor core (mma_step): its sums are cut, not
//     rounded to nearest, and at these widths that bias alone carried the
//     mean difference from the plain version over its limit. They, and
//     the general plan, also take colunit's and the Gershgorin bound's
//     sums in f64 (SqSum, gershgorin<true>): a reduction in another
//     order than the library's did the same on most graph sets.
// What bounds the wide plan: at (4096, 128, 128), k = 64, the bound's own
// count is 241 GFLOP of bf16 rounds and 69 GFLOP of f32 polish and finish
// (0.24 and 1.03 ms at peak): the f32 work on the CUDA cores.
//
// Widths 80 < k <= 832 take the GENERAL plan (pe_general_kernel, at the
// end): a cluster of blocks per graph sized by the batch, every step a
// GEMM of 128 x 64 tiles over operands in a device scratch (bf16 copies of
// M and Q for the rounds, on the tensor cores with the A operand split;
// f32 copies for the polish and finish, on the CUDA cores).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

struct Plan {
  int n, k, kp, kt;        // nodes, width, width padded to 16, kp / 16
  int threads, warps;      // 2n, n / 16
  int ldm, ldq, ldg, ldt;  // row strides: bf16 M, bf16 Q^T, bf16 G, f32 Q^T
  int ks;                  // depth split of the tensor-core Gram
  int chunks;              // lanes (1, 2 or 4) that share an f32 Gram tile
  int off_gram, off_redw, off_red;    // bytes: f32 G, partial sums
  int off_qlo, off_glo, off_gpart;    // bytes: the tensor-core rounds' tiles
  int off_stage;                      // bytes: panels of f32 M (same bytes)
  int smem;                // bytes in all
};

constexpr int kMaxWarps = 16;   // n <= 256, 16 columns a warp
constexpr int kMaxSplit = 8;    // most parts a Gram is summed from
constexpr int kPanel = 16;      // rows of f32 M per staged panel
constexpr int kStages = 3;      // panel buffers: two copies in flight
constexpr int kMaxSmem = 232448;   // shared memory a Hopper block may use
constexpr int kMaxKt = 5;       // row tiles of the tensor-core plans: k <= 80

inline int align16(int x) { return (x + 15) / 16 * 16; }

// Shapes: n a multiple of 32 up to 256, 1 <= k <= 80, and the bytes within
// a block's shared memory (every n at k <= 48; n <= 224 at kp = 64, n <=
// 160 at kp = 80, where the wide plan runs this kernel).
inline bool pe_plan(int n, int k, Plan* p) {
  if (n < 32 || n > 256 || n % 32 != 0 || k < 1 || k > 16 * kMaxKt)
    return false;
  p->n = n; p->k = k;
  p->kp = (k + 15) / 16 * 16;
  p->kt = p->kp / 16;
  p->threads = 2 * n;
  p->warps = n / 16;
  p->ldm = n + 8; p->ldq = n + 8; p->ldg = p->kp + 8; p->ldt = n + 4;
  const int tiles = 2 * p->kt * p->kt;   // 16x8 tiles of G
  p->ks = 1;
  for (int d = 1; d <= kMaxSplit; ++d)
    if (p->warps % d == 0 && tiles * d <= p->warps) p->ks = d;
  const int kq = p->kp / 4;
  const int tiles4 = kq * (kq + 1) / 2;
  p->chunks = 1;
  for (int d = 2; d <= 4; d *= 2)
    if (tiles4 * d <= p->threads) p->chunks = d;
  const int kk = p->kp * p->kp;
  const int lo_bytes = n * p->ldm * 2;
  const int f32_bytes = 2 * p->kp * p->ldt * 4;
  int off = align16(lo_bytes > f32_bytes ? lo_bytes : f32_bytes);
  p->off_gram = off;  off += kk * 4;
  p->off_redw = off;  off += p->warps * p->kp * 4;
  p->off_red = off;   off += p->kp * 4 + 16;
  // The rounds' bf16 tiles and the f32 steps' panels of M are never live
  // together: one region, the larger of the two.
  p->off_stage = off;
  p->off_qlo = off;   off += align16(2 * p->kp * p->ldq * 2);
  p->off_glo = off;   off += align16(p->kp * p->ldg * 2);
  p->off_gpart = off; off += p->ks > 1 ? p->ks * kk * 4 : 0;
  const int stage_end = p->off_stage + kStages * kPanel * n * 4;
  p->smem = off > stage_end ? off : stage_end;
  return p->smem <= kMaxSmem;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a = hi + lo per bf16 value, both exact in bf16: hi keeps the sign, the
// exponent and the top 3 bits of the significand, lo the other 4.
__device__ __forceinline__ void split_bf16(const uint32_t (&a)[4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = a[i] & 0xFFF0FFF0u;
    uint32_t x = a[i], h = hi[i];
    const __nv_bfloat162 d = __hsub2(
        *reinterpret_cast<const __nv_bfloat162*>(&x),
        *reinterpret_cast<const __nv_bfloat162*>(&h));
    lo[i] = *reinterpret_cast<const uint32_t*>(&d);
  }
}

// c += a * b over one 16-deep k-step. The tensor core does not round its
// sums to nearest: it aligns the products (and c) to the largest and cuts
// the bits below, a bias toward zero that the k-steps carry on. At the
// five-tile widths (SPLIT: KT >= 4), whose guard columns pass a bf16
// rounding difference on to the result the most, that bias put the mean
// difference from the plain version over its limit. There a's high and
// low parts (split_bf16) go through the tensor core apart, so every
// product has 12 significant bits and is not cut unless the products'
// exponents lie far apart; each part is summed in a zeroed fragment, and
// the parts and c are added with IEEE f32 adds. Twice the tensor-core work.
template <bool SPLIT>
__device__ __forceinline__ void mma_step(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (SPLIT) {
    uint32_t hi[4], lo[4];
    split_bf16(a, hi, lo);
    float d[4] = {0.f, 0.f, 0.f, 0.f}, e[4] = {0.f, 0.f, 0.f, 0.f};
    mma_bf16(d, hi, b0, b1);
    mma_bf16(e, lo, b0, b1);
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = __fadd_rn(c[i], __fadd_rn(d[i], e[i]));
  } else {
    mma_bf16(c, a, b0, b1);
  }
}

template <int KT>
struct Ctx {
  static constexpr int kp = 16 * KT;   // width padded to 16
  static constexpr int ldg = kp + 8;   // row stride of the bf16 G
  int n, ldm, ldq, ldt, ks, chunks;
  int ne;           // live nodes: rows/columns >= ne of M and Q^T are zero
  bf16* mlo;        // (n, ldm) bf16 copy of M, as stored
  float* qt;        // (kp, ldt) f32 Q^T; shares mlo's bytes
  float* qt2;       // the NS update's other buffer; after qt
  bf16* qlo0;       // two (kp, ldq) bf16 copies of Q^T, back to back
  float* gram;      // (kp, kp)
  bf16* glo;        // (kp, ldg) bf16 copy of G
  float* gpart;     // (ks, kp, kp) parts of the tensor-core Gram, if ks > 1
  float* redw;      // (warps, kp)
  float* red;       // (kp)
  float* scal;      // (1)
  float* stage;     // (kStages, kPanel, n) panels of f32 M; shares qlo0's bytes
  const float* mg;  // device memory (n, n): f32, or bf16 where mbf
  bool mbf;         // M is stored in bf16 (read through ld_m4 / stage_m4)
  int tid, nthreads, warp, lane, nwarps;
  int cur;          // which bf16 copy holds lo(Q^T)
  __device__ __forceinline__ bf16* qlo(int which) const {
    return qlo0 + which * kp * ldq;
  }
};

// ---- tensor-core side: Q^T lives in registers, warp owns 16 columns ----
//
// Fragment of the accumulator tile (mt, nt): row mt*16 + lane/4 (+8 for
// elements 2, 3), columns c0 + nt*8 + (lane%4)*2 (+1 for elements 1, 3).

// acc = A (rows (mt0 + mt)*16 for mt < RT, 16*ksteps deep, row-major bf16,
// lda) * B (16*ksteps x ., row-major bf16, ldb)[:, c0 : c0 + 16]. RT is KT
// (the whole panel) but for the five-tile widths' Newton-Schulz update,
// which takes one row tile at a time: a whole panel of accumulators beside
// Q^T's would spill.
template <int KT, int RT>
__device__ __forceinline__ void mma_panel(float (&acc)[RT][2][4],
                                          const bf16* a_s, int lda,
                                          const bf16* b_s, int ldb,
                                          int ksteps, int c0, int lane,
                                          int mt0 = 0) {
#pragma unroll
  for (int mt = 0; mt < RT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  const int lr = lane & 15, lc = (lane >> 4) * 8;
#pragma unroll (RT > 1 ? 2 : 1)
  for (int s = 0; s < ksteps; ++s) {
    uint32_t b[4];
    ldsm_x4_trans(b, b_s + (s * 16 + lr) * ldb + c0 + lc);
#pragma unroll
    for (int mt = 0; mt < RT; ++mt) {
      uint32_t a[4];
      ldsm_x4(a, a_s + ((mt0 + mt) * 16 + lr) * lda + s * 16 + lc);
      mma_step<(KT >= 4)>(acc[mt][0], a, b[0], b[1]);
      mma_step<(KT >= 4)>(acc[mt][1], a, b[2], b[3]);
    }
  }
}

// The one place Q^T is rounded to bf16: registers -> the other buffer.
// Ends with a barrier; x.cur then names the buffer just written.
template <int KT>
__device__ __forceinline__ void store_lo(Ctx<KT>& x,
                                         const float (&q)[KT][2][4]) {
  bf16* dst = x.qlo(x.cur ^ 1);
  const int g = x.lane >> 2, t = x.lane & 3, c0 = x.warp * 16;
  if (c0 < x.ne) {
#pragma unroll
    for (int mt = 0; mt < KT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = c0 + nt * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(
            &dst[(mt * 16 + g) * x.ldq + col]) =
            __floats2bfloat162_rn(q[mt][nt][0], q[mt][nt][1]);
        *reinterpret_cast<__nv_bfloat162*>(
            &dst[(mt * 16 + g + 8) * x.ldq + col]) =
            __floats2bfloat162_rn(q[mt][nt][2], q[mt][nt][3]);
      }
  }
  __syncthreads();
  x.cur ^= 1;
}

// Sums of squares of the bf16 rounds' colunit. The plain version rounds
// each square to f32 and sums them with the library's reduction, close to
// the correctly rounded sum; a chain of f32 adds in another order is a
// few units in the last place away, and every bf16 rounding of Q^T after
// it carries the difference on. At the five-tile widths (KT >= 4) and in
// the general plan that put the mean difference from the plain version
// over its limit on most graph sets, so there the squares (and the
// Gershgorin sums) are summed in f64 and rounded to f32 once. Below, the
// plans keep their f32 sums: every path that holds their output against
// the CPU's was measured with them.
template <int KT>
using SqSum = std::conditional_t<(KT >= 4), double, float>;

__device__ __forceinline__ float sq_add(float s, float v) {
  return fmaf(v, v, s);
}

__device__ __forceinline__ double sq_add(double s, float v) {
  return s + (double)__fmul_rn(v, v);
}

// Rows of Q^T scaled to unit norm (floor 1e-20), from the registers.
template <int KT>
__device__ __forceinline__ void colunit_regs(Ctx<KT>& x,
                                             float (&q)[KT][2][4]) {
  const int g = x.lane >> 2, t = x.lane & 3;
  const bool live = x.warp * 16 < x.ne;
#pragma unroll
  for (int mt = 0; mt < KT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!live) break;
      SqSum<KT> s = 0;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        s = sq_add(s, q[mt][nt][2 * h]);
        s = sq_add(s, q[mt][nt][2 * h + 1]);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (t == 0) x.redw[x.warp * x.kp + mt * 16 + h * 8 + g] = (float)s;
    }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < KT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!live) break;
      const int row = mt * 16 + h * 8 + g;
      SqSum<KT> s = 0;
#pragma unroll
      for (int w = 0; w < kMaxWarps; ++w)   // unrolled: the loads overlap
        if (w < x.ne / 16) s += x.redw[w * x.kp + row];
      const float d = fmaxf(__fsqrt_rn((float)s), 1e-20f);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        q[mt][nt][2 * h] = __fdiv_rn(q[mt][nt][2 * h], d);
        q[mt][nt][2 * h + 1] = __fdiv_rn(q[mt][nt][2 * h + 1], d);
      }
    }
  // redw is next written after the barriers of store_lo and the Gram.
}

// G = sum of `parts` parts in order. TO_LO: also the bf16 copy.
template <bool TO_LO, int KT>
__device__ __forceinline__ void gram_sum(Ctx<KT>& x, const float* part,
                                         int parts) {
  const int kk = x.kp * x.kp;
#pragma unroll 2
  for (int idx = x.tid; idx < kk; idx += x.nthreads) {
    float s = part[idx];
#pragma unroll
    for (int p = 1; p < kMaxSplit; ++p)     // unrolled: the loads overlap
      if (p < parts) s += part[p * kk + idx];
    x.gram[idx] = s;
    if (TO_LO) {
      const int a = idx / x.kp, b = idx - a * x.kp;
      x.glo[a * x.ldg + b] = __float2bfloat16_rn(s);
    }
  }
  __syncthreads();
}

// G = lo(Q^T) lo(Q^T)^T from the current bf16 copy: 16x8 tiles, one
// (tile, chunk) item per warp turn, the live depth split into ks chunks.
// With one chunk (the main path's N = 128, k = 32: eight tiles, eight
// warps) a tile goes straight from the accumulators to G and its bf16
// copy; else the parts are summed in order by gram_sum.
template <bool TO_LO, int KT>
__device__ __forceinline__ void gram_lo(Ctx<KT>& x) {
  constexpr int kTiles = 2 * KT * KT;
  const bf16* q = x.qlo(x.cur);
  const int all = x.ne / 16;               // k-steps of 16 live columns
  const int steps = (all + x.ks - 1) / x.ks;   // per chunk
  const int lane = x.lane, g = lane >> 2, t = lane & 3;
  const int lr = lane & 15, lc = (lane >> 4) * 8;
  const int br = lane & 7, bc = 8 * ((lane >> 3) & 1);
  const bool direct = x.ks == 1;
  for (int item = x.warp; item < kTiles * x.ks; item += x.nwarps) {
    const int tile = item % kTiles, chunk = item / kTiles;
    const int mt = tile / (2 * KT), nt = tile % (2 * KT);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s = chunk * steps; s < min(all, (chunk + 1) * steps); ++s) {
      uint32_t a[4], b[2];
      ldsm_x4(a, q + (mt * 16 + lr) * x.ldq + s * 16 + lc);
      ldsm_x2(b, q + (nt * 8 + br) * x.ldq + s * 16 + bc);
      mma_step<(KT >= 4)>(acc, a, b[0], b[1]);
    }
    float* dst = direct ? x.gram : x.gpart + chunk * x.kp * x.kp;
    const int row = mt * 16 + g, col = nt * 8 + 2 * t;
    *reinterpret_cast<float2*>(&dst[row * x.kp + col]) =
        make_float2(acc[0], acc[1]);
    *reinterpret_cast<float2*>(&dst[(row + 8) * x.kp + col]) =
        make_float2(acc[2], acc[3]);
    if (TO_LO && direct) {
      *reinterpret_cast<__nv_bfloat162*>(&x.glo[row * x.ldg + col]) =
          __floats2bfloat162_rn(acc[0], acc[1]);
      *reinterpret_cast<__nv_bfloat162*>(&x.glo[(row + 8) * x.ldg + col]) =
          __floats2bfloat162_rn(acc[2], acc[3]);
    }
  }
  __syncthreads();
  if (!direct) gram_sum<TO_LO>(x, x.gpart, x.ks);
}

// scal[0] = 1 / sqrt(max_a sum_b |G_ab|), floor 1e-20. F64: each sum is
// taken in f64 and rounded to f32 once, as close to the library's
// reduction in the plain version as a fixed order gets (see SqSum).
template <bool F64, class X>
__device__ __forceinline__ void gershgorin(X& x) {
  using Sum = std::conditional_t<F64, double, float>;
  if (x.warp == 0) {
    Sum best = 0;
    for (int a = x.lane; a < x.kp; a += 32) {
      Sum s = 0;
#pragma unroll 16
      for (int b = 0; b < x.kp; ++b) s += fabs((Sum)x.gram[b * x.kp + a]);
      best = fmax(best, s);
    }
    for (int off = 16; off > 0; off >>= 1)
      best = fmax(best, __shfl_xor_sync(0xffffffffu, best, off));
    if (x.lane == 0) x.scal[0] = rsqrtf(fmaxf((float)best, 1e-20f));
  }
  __syncthreads();
}

// Newton-Schulz with bf16-input products; Q^T in registers. On return
// qlo[cur] holds lo(Q^T).
template <int KT>
__device__ void ns_orth_lo(Ctx<KT>& x, float (&q)[KT][2][4], int steps) {
  colunit_regs(x, q);
  store_lo(x, q);
  gram_lo<false>(x);
  gershgorin<(KT >= 4)>(x);
  const float sc = x.scal[0];
  const float sc2 = __fmul_rn(sc, sc);
#pragma unroll
  for (int mt = 0; mt < KT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) q[mt][nt][e] = __fmul_rn(q[mt][nt][e], sc);
  for (int idx = x.tid; idx < x.kp * x.kp; idx += x.nthreads) {
    const int a = idx / x.kp, b = idx - a * x.kp;
    x.glo[a * x.ldg + b] = __float2bfloat16_rn(__fmul_rn(x.gram[idx], sc2));
  }
  store_lo(x, q);
  for (int it = 0; it < steps; ++it) {
    if (it) gram_lo<true>(x);
    if (x.warp * 16 < x.ne) {
      float acc[KT][2][4];
      mma_panel<KT>(acc, x.glo, x.ldg, x.qlo(x.cur), x.ldq, KT, x.warp * 16,
                    x.lane);
#pragma unroll
      for (int mt = 0; mt < KT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            q[mt][nt][e] = __fsub_rn(__fmul_rn(1.5f, q[mt][nt][e]),
                                     __fmul_rn(0.5f, acc[mt][nt][e]));
    }
    store_lo(x, q);
  }
}

// ---- f32 side: Q^T in shared memory, thread owns 4 columns x 2KT rows --

// acc[u] += sum over v of a[v] * b[v][u]: one row of an output tile, four
// steps of depth, in depth order.
__device__ __forceinline__ void fma_1x4x4(float (&acc)[4], const float4& a,
                                          const float4 (&b)[4]) {
  acc[0] = fmaf(a.x, b[0].x, acc[0]);
  acc[1] = fmaf(a.x, b[0].y, acc[1]);
  acc[2] = fmaf(a.x, b[0].z, acc[2]);
  acc[3] = fmaf(a.x, b[0].w, acc[3]);
  acc[0] = fmaf(a.y, b[1].x, acc[0]);
  acc[1] = fmaf(a.y, b[1].y, acc[1]);
  acc[2] = fmaf(a.y, b[1].z, acc[2]);
  acc[3] = fmaf(a.y, b[1].w, acc[3]);
  acc[0] = fmaf(a.z, b[2].x, acc[0]);
  acc[1] = fmaf(a.z, b[2].y, acc[1]);
  acc[2] = fmaf(a.z, b[2].z, acc[2]);
  acc[3] = fmaf(a.z, b[2].w, acc[3]);
  acc[0] = fmaf(a.w, b[3].x, acc[0]);
  acc[1] = fmaf(a.w, b[3].y, acc[1]);
  acc[2] = fmaf(a.w, b[3].z, acc[2]);
  acc[3] = fmaf(a.w, b[3].w, acc[3]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(d), "l"(src) : "memory");
}

// M's storage. The kernels take M in f32 or in bf16 (the reference's
// GCC_TPU_ADJ_DTYPE=bf16 operator): `m` points at a graph's first element
// either way, and `bf` says which. A bf16 M is its own bf16 copy (its
// values convert to bf16 unchanged), and the f32 steps widen it as they
// read it, so a bf16 M gives the result of the f32 M that holds the same
// values, at half the bytes read.
__device__ __forceinline__ const float* m_at(const float* m, bool bf,
                                             size_t i) {
  return bf ? reinterpret_cast<const float*>(
                  reinterpret_cast<const bf16*>(m) + i)
            : m + i;
}

// Four consecutive values of M from element i, as f32.
__device__ __forceinline__ float4 ld_m4(const float* m, bool bf, size_t i) {
  if (bf) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(
        reinterpret_cast<const bf16*>(m) + i));
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  return __ldg(reinterpret_cast<const float4*>(m + i));
}

// Four values of M from element i into shared memory at dst, as f32: an
// f32 M by a 16-byte cp.async (the caller commits the group); a bf16 M by
// a load widened as it lands and a plain store, done before the caller's
// next barrier, as the cp.async it stands for is.
__device__ __forceinline__ void stage_m4(float* dst, const float* m, bool bf,
                                         size_t i) {
  if (bf) *reinterpret_cast<float4*>(dst) = ld_m4(m, true, i);
  else cp_async16(dst, m + i);
}

// Q^T <- Q^T M in f32. M streams from device memory through shared memory
// in panels of kPanel rows (cp.async): the copy of panel p + 1 runs under
// the FMAs on panel p, and no register waits on device memory.
template <int KT>
__device__ void power_f32(Ctx<KT>& x) {
  constexpr int R = 2 * KT;
  const int n = x.n, nq = n / 4;
  const int tc = x.tid % nq, tr = x.tid / nq;
  float acc[R][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[i][u] = 0.f;
  // Live rows and columns only: the panels end at row ne, and a thread
  // whose four columns are dead copies and computes nothing.
  const int panels = x.ne / kPanel;
  const bool live = 4 * tc < x.ne;
  auto copy_panel = [&](int p) {   // rows tr and tr + 8 of panel p
    if (live && p < panels) {
      float* dst = x.stage + (p % kStages) * kPanel * n + 4 * tc;
      const size_t src = (size_t)p * kPanel * n + 4 * tc;
      stage_m4(dst + tr * n, x.mg, x.mbf, src + tr * n);
      stage_m4(dst + (tr + 8) * n, x.mg, x.mbf, src + (tr + 8) * n);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  copy_panel(0);
  copy_panel(1);
  for (int p = 0; p < panels; ++p) {
    // All but the newest copy are done: panel p has landed for every
    // thread, and every thread is done with panel p - 1, whose buffer the
    // next copy (panel p + 2, or an empty group) refills.
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncthreads();
    copy_panel(p + 2);
    if (!live) continue;
    const float* mp = x.stage + (p % kStages) * kPanel * n + 4 * tc;
    const float* qp = x.qt + tr * x.ldt + p * kPanel;
#pragma unroll
    for (int j = 0; j < kPanel; j += 4) {
      float4 m[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        m[u] = *reinterpret_cast<const float4*>(mp + (j + u) * n);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float4 q =
            *reinterpret_cast<const float4*>(qp + 8 * i * x.ldt + j);
        fma_1x4x4(acc[i], q, m);
      }
    }
  }
  __syncthreads();
  if (live) {
#pragma unroll
    for (int i = 0; i < R; ++i)
      *reinterpret_cast<float4*>(&x.qt[(tr + 8 * i) * x.ldt + 4 * tc]) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  __syncthreads();
}

// Rows of Q^T scaled to unit norm (floor 1e-20), in shared memory.
template <int KT>
__device__ void colunit_f32(Ctx<KT>& x) {
  constexpr int kp = 16 * KT, R = 2 * KT;
  const int nq = x.n / 4;
  for (int r = x.warp; r < kp; r += x.nwarps) {
    float s = 0.f;
    for (int c = x.lane; c < x.ne / 4; c += 32) {
      const float4 v =
          *reinterpret_cast<const float4*>(&x.qt[r * x.ldt + 4 * c]);
      s = fmaf(v.x, v.x, s);
      s = fmaf(v.y, v.y, s);
      s = fmaf(v.z, v.z, s);
      s = fmaf(v.w, v.w, s);
    }
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (x.lane == 0) x.red[r] = fmaxf(__fsqrt_rn(s), 1e-20f);
  }
  __syncthreads();
  const int tc = x.tid % nq, tr = x.tid / nq;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (4 * tc >= x.ne) break;
    float4* p =
        reinterpret_cast<float4*>(&x.qt[(tr + 8 * i) * x.ldt + 4 * tc]);
    const float d = x.red[tr + 8 * i];
    float4 q = *p;
    q.x = __fdiv_rn(q.x, d);
    q.y = __fdiv_rn(q.y, d);
    q.z = __fdiv_rn(q.z, d);
    q.w = __fdiv_rn(q.w, d);
    *p = q;
  }
  __syncthreads();
}

// G = Q^T Q in f32: 4x4 tiles (rows ta + kq*i, tb + kq*j) of the upper
// triangle ta <= tb, mirrored into the lower. `chunks` (1, 2 or 4) lanes
// share a tile, each taking a slice of the live depth, and sum their
// parts by shuffle (pairwise, a fixed order). The lanes of a tile sit
// 32 / chunks apart, so the 8 lanes of a 128-bit load phase read the same
// slice of 8 different tiles: row strides of 4 banks, no conflict.
template <int KT>
__device__ void gram_f32(Ctx<KT>& x) {
  constexpr int kp = 16 * KT, kq = kp / 4, tiles = kq * (kq + 1) / 2;
  const int c = x.chunks, per = 32 / c;                  // tiles a warp turn
  const int sub = x.lane / per;                          // this lane's slice
  const int depth = (x.ne / 4 + c - 1) / c * 4;          // of one lane
  for (int t0 = x.warp * per; t0 < tiles; t0 += x.nwarps * per) {
    const int tile = t0 + x.lane % per;
    const bool valid = tile < tiles;   // the others only join the shuffles
    int ta = 0, tb = valid ? tile : 0;
    while (tb >= kq - ta) { tb -= kq - ta; ++ta; }
    tb += ta;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
    for (int d = sub * depth; d < min(x.ne, (sub + 1) * depth); d += 4) {
      float4 av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = *reinterpret_cast<const float4*>(
            &x.qt[(ta + kq * i) * x.ldt + d]);
        bv[i] = *reinterpret_cast<const float4*>(
            &x.qt[(tb + kq * i) * x.ldt + d]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
          acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
          acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
          acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = acc[i][j];
        if (c > 1) v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (c > 2) v += __shfl_xor_sync(0xffffffffu, v, 8);
        // Every lane of the tile holds the sum; lane `sub` writes the
        // rows i = sub (mod c).
        if (valid && (i & (c - 1)) == sub) {
          const int a = ta + kq * i, b = tb + kq * j;
          x.gram[a * kp + b] = v;
          if (ta != tb) x.gram[b * kp + a] = v;
        }
      }
  }
  __syncthreads();
}

// Newton-Schulz in f32 on Q^T in shared memory.
template <int KT>
__device__ void ns_orth_f32(Ctx<KT>& x, int steps) {
  constexpr int R = 2 * KT;
  const int nq = x.n / 4;
  const int tc = x.tid % nq, tr = x.tid / nq;
  colunit_f32(x);
  gram_f32(x);
  gershgorin<(KT >= 4)>(x);
  const bool live = 4 * tc < x.ne;
  const float sc = x.scal[0];
  const float sc2 = __fmul_rn(sc, sc);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (!live) break;
    float4* p =
        reinterpret_cast<float4*>(&x.qt[(tr + 8 * i) * x.ldt + 4 * tc]);
    float4 q = *p;
    q.x = __fmul_rn(q.x, sc);
    q.y = __fmul_rn(q.y, sc);
    q.z = __fmul_rn(q.z, sc);
    q.w = __fmul_rn(q.w, sc);
    *p = q;
  }
  for (int idx = x.tid; idx < x.kp * x.kp; idx += x.nthreads)
    x.gram[idx] = __fmul_rn(x.gram[idx], sc2);
  __syncthreads();
  for (int it = 0; it < steps; ++it) {
    if (it) gram_f32(x);
    float acc[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][u] = 0.f;
    for (int b = 0; b < (live ? x.kp : 0); b += 4) {
      float4 qv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        qv[u] = *reinterpret_cast<const float4*>(
            &x.qt[(b + u) * x.ldt + 4 * tc]);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float4 g = *reinterpret_cast<const float4*>(
            &x.gram[(tr + 8 * i) * x.kp + b]);
        fma_1x4x4(acc[i], g, qv);
      }
    }
    // The update goes to the other buffer (dead columns as zeros), so
    // the step needs no barrier between its reads and its writes.
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int at = (tr + 8 * i) * x.ldt + 4 * tc;
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live) {
        q = *reinterpret_cast<const float4*>(&x.qt[at]);
        q.x = __fsub_rn(__fmul_rn(1.5f, q.x), __fmul_rn(0.5f, acc[i][0]));
        q.y = __fsub_rn(__fmul_rn(1.5f, q.y), __fmul_rn(0.5f, acc[i][1]));
        q.z = __fsub_rn(__fmul_rn(1.5f, q.z), __fmul_rn(0.5f, acc[i][2]));
        q.w = __fsub_rn(__fmul_rn(1.5f, q.w), __fmul_rn(0.5f, acc[i][3]));
      }
      *reinterpret_cast<float4*>(&x.qt2[at]) = q;
    }
    __syncthreads();
    float* other = x.qt; x.qt = x.qt2; x.qt2 = other;
  }
}

// MAXT / MINB: the block is at most MAXT threads and MINB blocks should
// fit an SM (the compiler caps the registers at 65536 / (MAXT * MINB)).
template <int KT, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB)
pe_kernel(const float* __restrict__ m,    // (B, n, n)
          const float* __restrict__ q0,   // (B, n, k)
          float* __restrict__ out,        // (B, n, k)
          Plan p, int rounds, int orth_every, int ns_steps, int polish,
          int final_ns, int lo) {
  // lo: bit 0 the rounds in bf16, bit 1 M stored in bf16.
  const bool mbf = lo & 2;
  lo &= 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = p.n, k = p.k;
  constexpr int kp = 16 * KT;
  Ctx<KT> x;
  x.n = n; x.ldm = p.ldm; x.ldq = p.ldq; x.ldt = p.ldt;
  x.ks = p.ks; x.chunks = p.chunks;
  x.mlo = reinterpret_cast<bf16*>(smem_raw);
  x.qt = reinterpret_cast<float*>(smem_raw);
  x.qt2 = x.qt + kp * p.ldt;
  x.qlo0 = reinterpret_cast<bf16*>(smem_raw + p.off_qlo);
  x.gram = reinterpret_cast<float*>(smem_raw + p.off_gram);
  x.glo = reinterpret_cast<bf16*>(smem_raw + p.off_glo);
  x.gpart = reinterpret_cast<float*>(smem_raw + p.off_gpart);
  x.redw = reinterpret_cast<float*>(smem_raw + p.off_redw);
  x.red = reinterpret_cast<float*>(smem_raw + p.off_red);
  x.scal = x.red + kp;
  x.stage = reinterpret_cast<float*>(smem_raw + p.off_stage);
  x.tid = threadIdx.x; x.nthreads = blockDim.x;
  x.warp = threadIdx.x >> 5; x.lane = threadIdx.x & 31;
  x.nwarps = blockDim.x >> 5;
  x.cur = 0;
  x.ne = n;
  x.mbf = mbf;
  x.mg = m_at(m, mbf, (size_t)blockIdx.x * n * n);
  const float* qb = q0 + (size_t)blockIdx.x * n * k;

  if (lo) {
    // extent: 1 + the last row or column of M or Q^T with a non-zero.
    int* extent = reinterpret_cast<int*>(x.scal + 1);
    if (x.tid == 0) *extent = 0;
    __syncthreads();
    int ext = 0;
    // M's bf16 copy, as stored: float4 in, four bf16 out.
    const int nq = n / 4;
#pragma unroll 4
    for (int idx = x.tid; idx < n * nq; idx += x.nthreads) {
      const int j = idx / nq, c4 = idx - j * nq;
      const float4 v = ld_m4(x.mg, mbf, (size_t)4 * idx);
      if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)
        ext = max(ext, max(j + 1, 4 * c4 + 4));
      __nv_bfloat162* d =
          reinterpret_cast<__nv_bfloat162*>(&x.mlo[j * p.ldm + 4 * c4]);
      d[0] = __floats2bfloat162_rn(v.x, v.y);
      d[1] = __floats2bfloat162_rn(v.z, v.w);
    }
    // Q^T into this warp's fragments; padded rows (>= k) stay zero.
    float q[KT][2][4];
    const int g = x.lane >> 2, t = x.lane & 3, c0 = x.warp * 16;
#pragma unroll
    for (int mt = 0; mt < KT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = mt * 16 + g + 8 * (e >> 1);
          const int col = c0 + nt * 8 + 2 * t + (e & 1);
          q[mt][nt][e] = (row < k) ? qb[col * k + row] : 0.f;
          if (q[mt][nt][e] != 0.f) ext = max(ext, col + 1);
        }
    ext = __reduce_max_sync(0xffffffffu, ext);
    if (x.lane == 0) atomicMax(extent, ext);
    // The rows' 8 padding values are never read: ldmatrix stays inside
    // columns [0, n). The barrier of store_lo also covers the copy of M
    // and the extent.
    store_lo(x, q);
    // Padding of the node axis is zero in M and in Q^T and stays zero
    // through every step (a product with it adds exact zeros), so the
    // steps run on the live rows and columns only, in tiles of 16: a warp
    // whose 16 columns are dead only keeps the barriers.
    x.ne = min(n, max(16, (*extent + 15) / 16 * 16));
    for (int r = 0; r < rounds; ++r) {
      for (int s = 0; s < orth_every; ++s) {
        if (c0 < x.ne)
          mma_panel<KT>(q, x.qlo(x.cur), x.ldq, x.mlo, x.ldm, x.ne / 16, c0,
                        x.lane);
        if (s + 1 < orth_every) store_lo(x, q);
      }
      ns_orth_lo(x, q, ns_steps);
    }
    // The rounds are done with M's bf16 copy (the last reads of it are
    // behind the barriers of ns_orth_lo): f32 Q^T takes its place.
#pragma unroll
    for (int mt = 0; mt < KT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = c0 + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(&x.qt[(mt * 16 + g) * p.ldt + col]) =
            make_float2(q[mt][nt][0], q[mt][nt][1]);
        *reinterpret_cast<float2*>(&x.qt[(mt * 16 + g + 8) * p.ldt + col]) =
            make_float2(q[mt][nt][2], q[mt][nt][3]);
      }
    __syncthreads();
  } else {
    for (int idx = x.tid; idx < kp * n; idx += x.nthreads) {
      const int r = idx / n, c = idx - r * n;
      x.qt[r * p.ldt + c] = (r < k) ? qb[c * k + r] : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < rounds; ++r) {
      for (int s = 0; s < orth_every; ++s) power_f32(x);
      ns_orth_f32(x, ns_steps);
    }
  }
  for (int s = 0; s < polish; ++s) {
    power_f32(x);
    colunit_f32(x);
  }
  if (final_ns) ns_orth_f32(x, final_ns);

  float* ob = out + (size_t)blockIdx.x * n * k;
  for (int idx = x.tid; idx < n * k; idx += x.nthreads) {
    const int c = idx / k, r = idx - c * k;
    ob[idx] = x.qt[r * p.ldt + c];
  }
}

template <int KT, int MAXT, int MINB>
int launch_as(const Plan& p, const void* m, const void* q0, void* out,
              int batch, int rounds, int orth_every, int ns_steps, int polish,
              int final_ns, int lo, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      pe_kernel<KT, MAXT, MINB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      p.smem);
  if (err != cudaSuccess) return (int)err;
  pe_kernel<KT, MAXT, MINB><<<batch, p.threads, p.smem, stream>>>(
      (const float*)m, (const float*)q0, (float*)out, p, rounds, orth_every,
      ns_steps, polish, final_ns, lo);
  return (int)cudaGetLastError();
}

// N <= 128 (at most 256 threads, under 90 KB of shared memory): three
// blocks an SM, so one graph's barriers and loads hide behind the others'.
// N > 128, or the wide plan's 64 and 80 columns (over 128 KB of shared
// memory at N = 128): one block an SM, registers are free.
template <int KT>
int launch(const Plan& p, const void* m, const void* q0, void* out, int batch,
           int rounds, int orth_every, int ns_steps, int polish, int final_ns,
           int lo, cudaStream_t stream) {
  if constexpr (KT < 4) {
    if (p.threads <= 256)
      return launch_as<KT, 256, 3>(p, m, q0, out, batch, rounds, orth_every,
                                   ns_steps, polish, final_ns, lo, stream);
  } else {
    if (p.threads <= 256)
      return launch_as<KT, 256, 1>(p, m, q0, out, batch, rounds, orth_every,
                                   ns_steps, polish, final_ns, lo, stream);
  }
  return launch_as<KT, 512, 1>(p, m, q0, out, batch, rounds, orth_every,
                               ns_steps, polish, final_ns, lo, stream);
}

// ---- the streamed plan: 256 < N <= 832 ---------------------------------
//
// Above N = 256 neither M's bf16 copy nor a graph's whole chain fits one
// block well: the bytes are too many for shared memory and one SM is too
// slow for a batch of 64 graphs on 132 SMs. What bounds this plan on the
// card is one graph's serial chain of steps (about 100 barrier-separated
// phases) and, at N = 832, the 16 passes over a bf16 M that no longer fits
// the L2 cache. The design:
//   * A thread block CLUSTER per graph (2 blocks up to N = 512, 4 above),
//     512 threads a block. The blocks split the live columns of Q^T in
//     slabs of 16: block r takes slabs [r * spb, (r + 1) * spb) of the
//     live ones, spb = ceil(live slabs / blocks) <= 16, one warp a slab.
//     A block (or a warp) with nothing live computes nothing but arrives
//     at every barrier.
//   * A bf16 copy of M, made ONCE. The prologue reads all of M anyway to
//     find the live extent; the same pass (its rows split over the
//     cluster) writes lo(M) into a device scratch, as 16 x 16 tiles of
//     512 bytes, tile (j / 16, c / 16) holding M[j][c] AS STORED (never
//     M[c][j]), its two 16-byte halves of a row swapped on rows 4-7 and
//     12-15 so that ldmatrix reads it without a bank conflict. The rounds
//     read half the bytes and round nothing.
//   * The rounds' products on the tensor cores (mma.sync m16n8k16, as in
//     the shared plan). A warp keeps its 16 columns of Q^T in f32 in its
//     accumulator registers for the whole round. Q^T is rounded to bf16
//     once, where it is written, into a (kp, N) copy in shared memory (two
//     buffers) that is the A operand of the next power step; a power
//     step's epilogue writes the warp's columns into the copy of EVERY
//     block of the cluster through distributed shared memory, and one
//     cluster barrier closes the step. B = lo(M) needs only the warp's own
//     16 columns: every warp streams its own tiles through a private ring
//     of four 512-byte stages with cp.async (three copies in flight) and
//     reads them with ldmatrix.trans, so a power step has no block-wide
//     barrier and no byte of M is read twice across the cluster.
//   * Newton-Schulz: the Gram is summed per block over its own columns
//     (16 x 8 tensor-core tiles from the shared copy), the partial G's
//     are read from every block's shared memory and added in block order,
//     so G does not depend on timing and is symmetric bit for bit; the
//     G Q^T update needs only the warp's own columns. colunit's sums of
//     squares travel the same way. Inside an orthonormalization only the
//     last store of lo(Q^T) goes to the other blocks.
//   * The f32 work (polish, the NS finish, every round when lo = 0) stays
//     in full f32 on the CUDA cores, register-tiled (a thread owns 4
//     columns x kp/8 rows), split over the cluster by the same columns.
//     Every block keeps a full f32 copy of Q^T in shared memory (the bytes
//     of the bf16 copies). A power step reads all of it as A and streams
//     f32 M at the block's columns in panels of 16 rows with cp.async
//     (three buffers); its result stays in registers until every block is
//     done reading, then goes to every block's copy through distributed
//     shared memory. The f32 Newton-Schulz runs in place on the block's
//     own columns; only sums of squares and partial Grams cross the
//     cluster. Q^T never goes to device memory.
//   * Work follows the data: every loop runs over the live extent only
//     (rounded up to 32), found by the prologue.
// Barriers between blocks are cluster barriers (release/acquire), which
// also order the bf16 copy of M in device memory.

namespace cg = cooperative_groups;

constexpr int kBigThreads = 512;
constexpr int kBigWarps = kBigThreads / 32;
constexpr int kRing = 4;                  // stages of a warp's ring of tiles
constexpr int kTile = 512;                // bytes of a 16 x 16 bf16 tile
constexpr int kMaxCluster = 4;

struct BigPlan {
  int n, k, kp, kt;
  int cluster;       // blocks per graph
  int slabs;         // n / 16
  int spb;           // most slabs a block takes: ceil(slabs / cluster)
  int ldq;           // row stride of the bf16 Q^T
  int ldf;           // row stride of the f32 Q^T
  int ldp;           // row stride of a staged panel of f32 M: 16 spb
  int nbuf;          // bf16 copies of Q^T a block keeps: 2, or 1
  int off_ring, off_gram, off_glo, off_redw, off_redc, off_red;   // bytes
  int smem;
  int scratch;       // bytes of device scratch per graph
};

inline int big_smem(BigPlan* p) {
  const int kk = p->kp * p->kp;
  // The bf16 copies of Q^T; with two, the f32 steps keep one f32 copy of
  // Q^T (kp, ldf) in the same bytes (never more: 4 (n + 4) <= 4 (n + 8)),
  // with one it lives in the device scratch.
  int off = align16(p->nbuf * p->kp * p->ldq * 2);
  // The warps' rings of bf16 tiles; the f32 power steps' three panels of
  // f32 M take the same bytes, and between power steps the two partial
  // Gram matrices (2 kk f32: 18 KB at kp = 48, 50 KB at kp = 80).
  int region = kBigWarps * kRing * kTile;
  if (region < kStages * kPanel * p->ldp * 4)
    region = kStages * kPanel * p->ldp * 4;
  if (region < 2 * kk * 4) region = 2 * kk * 4;
  p->off_ring = off; off += region;
  p->off_gram = off; off += kk * 4;
  p->off_glo = off;  off += align16(p->kp * (p->kp + 8) * 2);
  p->off_redw = off; off += kBigWarps * p->kp * 4;
  p->off_redc = off; off += kMaxCluster * p->kp * 4;
  p->off_red = off;  off += p->kp * 4 + 16 + kMaxCluster * 4;
  return off;
}

// Shapes: n a multiple of 32 in (256, 832] at 1 <= k <= 48 (the streamed
// plan), and 48 < k <= 80 at every n up to 832 that the shared plan does
// not take (the wide plan's cluster layout).
inline bool pe_big_plan(int n, int k, BigPlan* p) {
  if (n < 32 || n > 832 || n % 32 != 0 || k < 1 || k > 16 * kMaxKt)
    return false;
  Plan shared;
  if (pe_plan(n, k, &shared)) return false;
  p->n = n; p->k = k;
  p->kp = (k + 15) / 16 * 16;
  p->kt = p->kp / 16;
  // One block per graph up to N = 256 (the wide plan's: 16 slabs, one a
  // warp), 2 up to N = 512 (64 graphs are 128 blocks on 132 SMs), 4 above.
  p->cluster = n <= 256 ? 1 : n <= 512 ? 2 : kMaxCluster;
  p->slabs = n / 16;
  p->spb = (p->slabs + p->cluster - 1) / p->cluster;
  p->ldq = n + 8;
  p->ldf = n + 4;
  p->ldp = 16 * p->spb;
  // Two bf16 copies of Q^T where they fit (every shape at k <= 48), else
  // one, and the f32 Q^T in the device scratch (k = 80 above N = 384, k
  // = 64 above N = 512).
  p->nbuf = 2;
  p->smem = big_smem(p);
  if (p->smem > kMaxSmem) {
    p->nbuf = 1;
    p->smem = big_smem(p);
  }
  p->scratch = n * n * 2 + (p->nbuf == 1 ? p->kp * p->ldf * 4 : 0);
  return p->smem <= kMaxSmem;
}

template <int KT>
struct Big {
  static constexpr int kp = 16 * KT;
  static constexpr int ldg = kp + 8;
  int n;            // padded nodes
  int ne;           // live nodes, a multiple of 32
  int ldq, ldf, ldp, slabs;
  int rank, nblk;   // this block in its cluster; blocks in the cluster
  int s0, s1;       // the live slabs [s0, s1) of 16 columns of this block
  bool one_buf;     // KT >= 4: one bf16 copy of Q^T (written behind a
                    // barrier) and the f32 Q^T in device memory, one copy
                    // for the cluster
  const float* mg;  // device memory (n, n): f32, or bf16 where mbf
  bool mbf;         // M is stored in bf16 (read through ld_m4 / stage_m4)
  const unsigned char* mlo;   // device scratch: lo(M) in 512-byte tiles
  bf16* qlo0;       // two (kp, ldq) bf16 copies of Q^T, back to back, or one
  float* qf;        // (kp, ldf) f32 copy of Q^T; qlo0's bytes, or the scratch
  unsigned char* ring;        // (warps, kRing, kTile), or
                              // (kStages, kPanel, ldp) panels of f32 M
  float* gpart0;    // two (kp, kp) partial Grams; the ring's bytes
  float* gram;      // (kp, kp)
  bf16* glo;        // (kp, ldg) bf16 copy of G
  float* redw;      // (warps, kp)
  float* redc;      // (kMaxCluster, kp): every block's sums of squares
  float* red;       // (kp)
  float* scal;      // (1)
  int tid, warp, lane;
  int cur;          // which bf16 copy holds lo(Q^T)
  int par;          // which partial Gram the next Gram writes
  // False at compile time below five row tiles (the streamed plan), whose
  // code then keeps pointers the compiler knows are to shared memory.
  __device__ __forceinline__ bool single() const {
    return KT >= 4 && one_buf;
  }
  __device__ __forceinline__ bf16* qlo(int which) const {
    return qlo0 + (single() ? 0 : which) * kp * ldq;
  }
  __device__ __forceinline__ bool warp_live() const { return s0 + warp < s1; }
};

// red[row] = max(sqrt(sum of squares of row), 1e-20) over the cluster.
// `mine` is this block's sum for row tid (threads tid < kp); it is handed
// to every block and the blocks' sums are added in block order. One
// cluster barrier.
template <int KT>
__device__ __forceinline__ void big_norms(Big<KT>& x, float mine) {
  cg::cluster_group cl = cg::this_cluster();
  if (x.tid < x.kp) {
    for (int r = 0; r < x.nblk; ++r)
      cl.map_shared_rank(x.redc, r)[x.rank * x.kp + x.tid] = mine;
  }
  cl.sync();
  if (x.tid < x.kp) {
    float s = 0.f;
    for (int r = 0; r < x.nblk; ++r) s += x.redc[r * x.kp + x.tid];
    x.red[x.tid] = fmaxf(__fsqrt_rn(s), 1e-20f);
  }
  __syncthreads();
}

// G = the blocks' partial Grams added in block order. TO_LO: also the
// bf16 copy. One cluster barrier; the next Gram writes the other partial.
template <bool TO_LO, int KT>
__device__ __forceinline__ void big_gram_reduce(Big<KT>& x) {
  cg::cluster_group cl = cg::this_cluster();
  constexpr int kk = Big<KT>::kp * Big<KT>::kp;
  float* part = x.gpart0 + x.par * kk;
  cl.sync();
  const float* parts[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    parts[r] = cl.map_shared_rank(part, r < x.nblk ? r : 0);
  for (int idx = x.tid; idx < kk; idx += kBigThreads) {
    float s = parts[0][idx];
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r)   // unrolled: the loads overlap
      if (r < x.nblk) s += parts[r][idx];
    x.gram[idx] = s;
    if (TO_LO) {
      const int a = idx / x.kp, b = idx - a * x.kp;
      x.glo[a * x.ldg + b] = __float2bfloat16_rn(s);
    }
  }
  __syncthreads();
  x.par ^= 1;
}

// ---- tensor-core side of the streamed plan ------------------------------

// The one place Q^T is rounded to bf16: registers -> the other buffer, of
// this block only or (all) of every block of the cluster. Ends with a
// block or a cluster barrier; x.cur then names the buffer just written.
// With one buffer, a barrier first: every reader of it is done.
template <int KT>
__device__ __forceinline__ void big_store_lo(Big<KT>& x,
                                             const float (&q)[KT][2][4],
                                             bool all) {
  cg::cluster_group cl = cg::this_cluster();
  if (x.single()) {
    if (all) cl.sync(); else __syncthreads();
  }
  bf16* mine = x.qlo(x.cur ^ 1);
  if (x.warp_live()) {
    const int g = x.lane >> 2, t = x.lane & 3;
    const int c0 = (x.s0 + x.warp) * 16;
    __nv_bfloat162 v[KT][2][2];
#pragma unroll
    for (int mt = 0; mt < KT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        v[mt][nt][0] = __floats2bfloat162_rn(q[mt][nt][0], q[mt][nt][1]);
        v[mt][nt][1] = __floats2bfloat162_rn(q[mt][nt][2], q[mt][nt][3]);
      }
    for (int r = 0; r < (all ? x.nblk : 1); ++r) {
      bf16* dst = all ? cl.map_shared_rank(mine, r) : mine;
#pragma unroll
      for (int mt = 0; mt < KT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = c0 + nt * 8 + 2 * t;
          *reinterpret_cast<__nv_bfloat162*>(
              &dst[(mt * 16 + g) * x.ldq + col]) = v[mt][nt][0];
          *reinterpret_cast<__nv_bfloat162*>(
              &dst[(mt * 16 + g + 8) * x.ldq + col]) = v[mt][nt][1];
        }
    }
  }
  if (all) cl.sync(); else __syncthreads();
  x.cur ^= 1;
}

// Q^T <- lo(Q^T) lo(M) for this warp's 16 columns: A is the whole live
// depth of the shared bf16 copy, B the warp's own tiles of lo(M), streamed
// through its ring. No block-wide barrier.
template <int KT>
__device__ __forceinline__ void big_power_lo(Big<KT>& x,
                                             float (&q)[KT][2][4]) {
  if (!x.warp_live()) return;
  const int lane = x.lane, ksteps = x.ne / 16;
  unsigned char* ring = x.ring + x.warp * kRing * kTile;
  const unsigned char* src =
      x.mlo + (size_t)(x.s0 + x.warp) * kTile + lane * 16;
  const size_t down = (size_t)x.slabs * kTile;   // one tile row further
  auto fetch = [&](int s) {
    if (s < ksteps)
      cp_async16(ring + (s % kRing) * kTile + lane * 16, src + s * down);
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
#pragma unroll
  for (int mt = 0; mt < KT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) q[mt][nt][e] = 0.f;
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) fetch(s);
  const bf16* a_s = x.qlo(x.cur);
  const int lr = lane & 15, lc = (lane >> 4) * 8;
  // Row lr of a tile, its 16-byte half (lane / 16) swapped on rows 4-7
  // and 12-15, as the prologue stored it.
  const int boff = lr * 32 + (((lane >> 4) ^ ((lr >> 2) & 1)) * 16);
  for (int s = 0; s < ksteps; ++s) {
    // All but the two newest copies are done: tile s has landed; after
    // the warp barrier every lane is done with tile s - 1, whose stage
    // the next copy refills.
    asm volatile("cp.async.wait_group 2;" ::: "memory");
    __syncwarp();
    fetch(s + kRing - 1);
    uint32_t b[4];
    ldsm_x4_trans(b, ring + (s % kRing) * kTile + boff);
#pragma unroll
    for (int mt = 0; mt < KT; ++mt) {
      uint32_t a[4];
      ldsm_x4(a, a_s + (mt * 16 + lr) * x.ldq + s * 16 + lc);
      mma_step<(KT >= 4)>(q[mt][0], a, b[0], b[1]);
      mma_step<(KT >= 4)>(q[mt][1], a, b[2], b[3]);
    }
  }
}

// Rows of Q^T scaled to unit norm (floor 1e-20), from the registers.
template <int KT>
__device__ __forceinline__ void big_colunit_regs(Big<KT>& x,
                                                 float (&q)[KT][2][4]) {
  const int g = x.lane >> 2, t = x.lane & 3;
  const bool live = x.warp_live();
#pragma unroll
  for (int mt = 0; mt < KT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!live) break;
      SqSum<KT> s = 0;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        s = sq_add(s, q[mt][nt][2 * h]);
        s = sq_add(s, q[mt][nt][2 * h + 1]);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (t == 0) x.redw[x.warp * x.kp + mt * 16 + h * 8 + g] = (float)s;
    }
  __syncthreads();
  SqSum<KT> mine = 0;
  if (x.tid < x.kp)
    for (int w = 0; w < x.s1 - x.s0; ++w) mine += x.redw[w * x.kp + x.tid];
  big_norms(x, (float)mine);
#pragma unroll
  for (int mt = 0; mt < KT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!live) break;
      const float d = x.red[mt * 16 + h * 8 + g];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        q[mt][nt][2 * h] = __fdiv_rn(q[mt][nt][2 * h], d);
        q[mt][nt][2 * h + 1] = __fdiv_rn(q[mt][nt][2 * h + 1], d);
      }
    }
  // redw and red are next written behind the barriers of the store and
  // of the Gram.
}

// This block's part of G = lo(Q^T) lo(Q^T)^T: the sum over its own live
// columns, 16 x 8 tiles from the current bf16 copy, one tile per warp
// turn, straight from the accumulators into the partial Gram.
template <int KT>
__device__ __forceinline__ void big_gram_lo(Big<KT>& x) {
  constexpr int kTiles = 2 * KT * KT;
  const bf16* q = x.qlo(x.cur);
  float* part = x.gpart0 + x.par * x.kp * x.kp;
  const int lane = x.lane, g = lane >> 2, t = lane & 3;
  const int lr = lane & 15, lc = (lane >> 4) * 8;
  const int br = lane & 7, bc = 8 * ((lane >> 3) & 1);
  for (int tile = x.warp; tile < kTiles; tile += kBigWarps) {
    const int mt = tile / (2 * KT), nt = tile % (2 * KT);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s = x.s0; s < x.s1; ++s) {
      uint32_t a[4], b[2];
      ldsm_x4(a, q + (mt * 16 + lr) * x.ldq + s * 16 + lc);
      ldsm_x2(b, q + (nt * 8 + br) * x.ldq + s * 16 + bc);
      mma_step<(KT >= 4)>(acc, a, b[0], b[1]);
    }
    const int row = mt * 16 + g, col = nt * 8 + 2 * t;
    *reinterpret_cast<float2*>(&part[row * x.kp + col]) =
        make_float2(acc[0], acc[1]);
    *reinterpret_cast<float2*>(&part[(row + 8) * x.kp + col]) =
        make_float2(acc[2], acc[3]);
  }
}

// Newton-Schulz with bf16-input products; Q^T in registers. On return
// qlo[cur] of every block holds lo(Q^T), all live columns.
template <int KT>
__device__ void big_ns_lo(Big<KT>& x, float (&q)[KT][2][4], int steps) {
  big_colunit_regs(x, q);
  big_store_lo(x, q, false);
  big_gram_lo(x);
  big_gram_reduce<false>(x);
  gershgorin<(KT >= 4)>(x);
  const float sc = x.scal[0];
  const float sc2 = __fmul_rn(sc, sc);
#pragma unroll
  for (int mt = 0; mt < KT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) q[mt][nt][e] = __fmul_rn(q[mt][nt][e], sc);
  for (int idx = x.tid; idx < x.kp * x.kp; idx += kBigThreads) {
    const int a = idx / x.kp, b = idx - a * x.kp;
    x.glo[a * x.ldg + b] = __float2bfloat16_rn(__fmul_rn(x.gram[idx], sc2));
  }
  big_store_lo(x, q, steps == 0);
  for (int it = 0; it < steps; ++it) {
    if (it) {
      big_gram_lo(x);
      big_gram_reduce<true>(x);
    }
    if (x.warp_live()) {
      if constexpr (KT >= 4) {
        // Row tile by row tile: B is lo(Q^T) in shared memory, not q.
#pragma unroll
        for (int mt = 0; mt < KT; ++mt) {
          float acc[1][2][4];
          mma_panel<KT>(acc, x.glo, x.ldg, x.qlo(x.cur), x.ldq, KT,
                        (x.s0 + x.warp) * 16, x.lane, mt);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              q[mt][nt][e] = __fsub_rn(__fmul_rn(1.5f, q[mt][nt][e]),
                                       __fmul_rn(0.5f, acc[0][nt][e]));
        }
      } else {
        float acc[KT][2][4];
        mma_panel<KT>(acc, x.glo, x.ldg, x.qlo(x.cur), x.ldq, KT,
                      (x.s0 + x.warp) * 16, x.lane);
#pragma unroll
        for (int mt = 0; mt < KT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              q[mt][nt][e] = __fsub_rn(__fmul_rn(1.5f, q[mt][nt][e]),
                                       __fmul_rn(0.5f, acc[mt][nt][e]));
      }
    }
    big_store_lo(x, q, it == steps - 1);
  }
}

// ---- f32 side of the streamed plan --------------------------------------
//
// Every block keeps a full f32 copy of Q^T (kp, ldf) in shared memory (the
// bytes of the two bf16 copies, which the f32 steps no longer need). A
// thread owns 4 columns x kp/8 rows (rows tr + 8 i) of the block's columns.

// acc <- (Q^T M)[rows, the thread's columns] in f32. A is the block's full
// copy of Q^T; M's rows stream at the block's columns through shared
// memory in panels of kPanel rows (cp.async, three buffers, two copies in
// flight: the copy of panel p + 1 runs under the FMAs on panel p). The
// copy of Q^T is only read: the caller writes the new columns after a
// cluster barrier.
template <int KT>
__device__ void big_power_f32(Big<KT>& x, float (&acc)[2 * KT][4]) {
  constexpr int R = 2 * KT;
  const int n = x.n, ldp = x.ldp;
  const int tc = x.tid & 63, tr = x.tid >> 6;
  const int c0 = 16 * x.s0, own = 16 * (x.s1 - x.s0);
  const bool live = 4 * tc < own;
  const int panels = own ? x.ne / kPanel : 0;    // the same for the block
  float* stage = reinterpret_cast<float*>(x.ring);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[i][u] = 0.f;
  auto copy_panel = [&](int p) {   // rows tr and tr + 8 of panel p
    if (live && p < panels) {
      float* dst = stage + (p % kStages) * kPanel * ldp + 4 * tc;
      const size_t src = (size_t)p * kPanel * n + c0 + 4 * tc;
      stage_m4(dst + tr * ldp, x.mg, x.mbf, src + tr * n);
      stage_m4(dst + (tr + 8) * ldp, x.mg, x.mbf, src + (tr + 8) * n);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  copy_panel(0);
  copy_panel(1);
  for (int p = 0; p < panels; ++p) {
    // All but the newest copy are done: panel p has landed for every
    // thread, and every thread is done with panel p - 1, whose buffer the
    // next copy (panel p + 2, or an empty group) refills.
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncthreads();
    copy_panel(p + 2);
    if (!live) continue;
    const float* mp = stage + (p % kStages) * kPanel * ldp + 4 * tc;
    const float* qp = x.qf + tr * x.ldf + p * kPanel;
#pragma unroll
    for (int j = 0; j < kPanel; j += 4) {
      float4 m[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        m[u] = *reinterpret_cast<const float4*>(mp + (j + u) * ldp);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float4 q =
            *reinterpret_cast<const float4*>(qp + 8 * i * x.ldf + j);
        fma_1x4x4(acc[i], q, m);
      }
    }
  }
}

// The thread's tile into the copy of Q^T of every block of the cluster
// (or, others_only, of every other block: the block's own copy already
// holds it); with the copy in device memory, into that one copy (others
// only: nothing). Ends with a cluster barrier. Every block must be done
// reading the columns that are overwritten: a cluster barrier comes first.
template <int KT>
__device__ __forceinline__ void big_put_f32(Big<KT>& x,
                                            const float (&acc)[2 * KT][4],
                                            bool others_only) {
  cg::cluster_group cl = cg::this_cluster();
  constexpr int R = 2 * KT;
  const int tc = x.tid & 63, tr = x.tid >> 6;
  const int col = 16 * x.s0 + 4 * tc;
  if (col < 16 * x.s1 && !(x.single() && others_only)) {
    for (int r = 0; r < (x.single() ? 1 : x.nblk); ++r) {
      if (others_only && r == x.rank) continue;
      float* dst = x.single() ? x.qf : cl.map_shared_rank(x.qf, r);
#pragma unroll
      for (int i = 0; i < R; ++i)
        *reinterpret_cast<float4*>(&dst[(tr + 8 * i) * x.ldf + col]) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
  cl.sync();
}

// One polish step: Q^T <- colunit(Q^T M), two cluster barriers. The sums
// of squares come from the tiles (the 32 lanes of a warp hold 128 columns
// of a row, two warps a row), so the barrier inside big_norms also says
// that every block is done reading the old Q^T.
template <int KT>
__device__ void big_polish_f32(Big<KT>& x) {
  constexpr int R = 2 * KT;
  const int tr = x.tid >> 6;
  float acc[R][4];
  big_power_f32(x, acc);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) s = fmaf(acc[i][u], acc[i][u], s);
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (x.lane == 0) x.redw[2 * (tr + 8 * i) + (x.warp & 1)] = s;
  }
  __syncthreads();
  big_norms(x, x.tid < x.kp ? x.redw[2 * x.tid] + x.redw[2 * x.tid + 1] : 0.f);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float d = x.red[tr + 8 * i];
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[i][u] = __fdiv_rn(acc[i][u], d);
  }
  big_put_f32(x, acc, false);
}

// One f32 power step of a round (lo = 0): Q^T <- Q^T M.
template <int KT>
__device__ void big_step_f32(Big<KT>& x) {
  float acc[2 * KT][4];
  big_power_f32(x, acc);
  cg::this_cluster().sync();   // every block is done reading the old Q^T
  big_put_f32(x, acc, false);
}

// This block's part of G = Q^T Q in f32, from its own columns of the copy
// in shared memory: 4x4 tiles (rows ta + kq*i, tb + kq*j) of the upper
// triangle, mirrored (so G is symmetric bit for bit). Four lanes share a
// tile, each taking a slice of the block's columns, and sum their parts by
// shuffle (pairwise, a fixed order). The lanes of a tile sit 8 apart, so
// the 8 lanes of a 128-bit load phase read the same slice of 8 different
// tiles.
template <int KT>
__device__ void big_gram_f32(Big<KT>& x) {
  constexpr int kp = 16 * KT, kq = kp / 4, tiles = kq * (kq + 1) / 2;
  constexpr int c = 4, per = 32 / c;                   // tiles a warp turn
  const int own = 16 * (x.s1 - x.s0);
  const float* qt = x.qf + 16 * x.s0;
  const int sub = x.lane / per;                        // this lane's slice
  const int depth = (own / 4 + c - 1) / c * 4;         // of one lane
  float* part = x.gpart0 + x.par * kp * kp;
  for (int t0 = x.warp * per; t0 < tiles; t0 += kBigWarps * per) {
    const int tile = t0 + x.lane % per;
    const bool valid = tile < tiles;   // the others only join the shuffles
    int ta = 0, tb = valid ? tile : 0;
    while (tb >= kq - ta) { tb -= kq - ta; ++ta; }
    tb += ta;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
    for (int d = sub * depth; d < min(own, (sub + 1) * depth); d += 4) {
      float4 av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = *reinterpret_cast<const float4*>(
            &qt[(ta + kq * i) * x.ldf + d]);
        bv[i] = *reinterpret_cast<const float4*>(
            &qt[(tb + kq * i) * x.ldf + d]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
          acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
          acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
          acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = acc[i][j];
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        // Every lane of the tile holds the sum; lane `sub` writes row i.
        if (valid && i == sub) {
          const int a = ta + kq * i, b = tb + kq * j;
          part[a * kp + b] = v;
          if (ta != tb) part[b * kp + a] = v;
        }
      }
  }
}

// Newton-Schulz in f32, in place on the block's own columns of its copy
// of Q^T; only the sums of squares and the partial Grams cross the
// cluster. At the end the block's columns go to the other blocks' copies;
// ends with a cluster barrier.
template <int KT>
__device__ void big_ns_f32(Big<KT>& x, int steps) {
  constexpr int R = 2 * KT, kp = 16 * KT;
  const int own4 = 4 * (x.s1 - x.s0);
  const int tc = x.tid & 63, tr = x.tid >> 6;
  const bool live = tc < own4;
  float* qt = x.qf + 16 * x.s0 + 4 * tc;     // the thread's columns, row 0
  // Rows to unit norm over the cluster.
  for (int r = x.warp; r < kp; r += kBigWarps) {
    float s = 0.f;
    for (int c = x.lane; c < own4; c += 32) {
      const float4 v = *reinterpret_cast<const float4*>(
          &x.qf[r * x.ldf + 16 * x.s0 + 4 * c]);
      s = fmaf(v.x, v.x, s);
      s = fmaf(v.y, v.y, s);
      s = fmaf(v.z, v.z, s);
      s = fmaf(v.w, v.w, s);
    }
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (x.lane == 0) x.redw[r] = s;
  }
  __syncthreads();
  big_norms(x, x.tid < kp ? x.redw[x.tid] : 0.f);
  float q[R][4];   // the thread's tile, kept in registers between steps
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) v = *reinterpret_cast<const float4*>(&qt[(tr + 8 * i) * x.ldf]);
    const float d = x.red[tr + 8 * i];
    q[i][0] = __fdiv_rn(v.x, d);
    q[i][1] = __fdiv_rn(v.y, d);
    q[i][2] = __fdiv_rn(v.z, d);
    q[i][3] = __fdiv_rn(v.w, d);
    if (live)
      *reinterpret_cast<float4*>(&qt[(tr + 8 * i) * x.ldf]) =
          make_float4(q[i][0], q[i][1], q[i][2], q[i][3]);
  }
  __syncthreads();
  big_gram_f32(x);
  big_gram_reduce<false>(x);
  gershgorin<(KT >= 4)>(x);
  const float sc = x.scal[0];
  const float sc2 = __fmul_rn(sc, sc);
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int u = 0; u < 4; ++u) q[i][u] = __fmul_rn(q[i][u], sc);
    if (live)
      *reinterpret_cast<float4*>(&qt[(tr + 8 * i) * x.ldf]) =
          make_float4(q[i][0], q[i][1], q[i][2], q[i][3]);
  }
  for (int idx = x.tid; idx < kp * kp; idx += kBigThreads)
    x.gram[idx] = __fmul_rn(x.gram[idx], sc2);
  __syncthreads();
  for (int it = 0; it < steps; ++it) {
    if (it) {
      big_gram_f32(x);
      big_gram_reduce<false>(x);
    }
    float acc[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][u] = 0.f;
    if (live) {
#pragma unroll 2
      for (int b = 0; b < kp; b += 4) {
        float4 qv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          qv[u] = *reinterpret_cast<const float4*>(&qt[(b + u) * x.ldf]);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float4 g = *reinterpret_cast<const float4*>(
              x.gram + (tr + 8 * i) * kp + b);
          fma_1x4x4(acc[i], g, qv);
        }
      }
    }
    // In place: every thread is done reading these columns first.
    __syncthreads();
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        q[i][u] = __fsub_rn(__fmul_rn(1.5f, q[i][u]),
                            __fmul_rn(0.5f, acc[i][u]));
      if (live)
        *reinterpret_cast<float4*>(&qt[(tr + 8 * i) * x.ldf]) =
            make_float4(q[i][0], q[i][1], q[i][2], q[i][3]);
    }
    __syncthreads();
  }
  // No block reads another's columns inside an orthonormalization, and
  // every block passed a cluster barrier after its last read of them.
  big_put_f32(x, q, true);
}

template <int KT>
__global__ void __launch_bounds__(kBigThreads, 1)
pe_cluster_kernel(const float* __restrict__ m,    // (B, n, n)
                  const float* __restrict__ q0,   // (B, n, k)
                  float* __restrict__ out,        // (B, n, k)
                  unsigned char* scratch,         // (B, p.scratch)
                  BigPlan p, int rounds, int orth_every, int ns_steps,
                  int polish, int final_ns, int lo) {
  // lo: bit 0 the rounds in bf16, bit 1 M stored in bf16.
  const bool mbf = lo & 2;
  lo &= 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  constexpr int kp = 16 * KT;
  const int n = p.n, k = p.k;
  const int graph = blockIdx.x / p.cluster;
  Big<KT> x;
  x.n = n; x.ne = n; x.ldq = p.ldq; x.ldf = p.ldf; x.ldp = p.ldp;
  x.slabs = p.slabs;
  x.rank = (int)cl.block_rank(); x.nblk = p.cluster;
  x.one_buf = p.nbuf == 1;
  unsigned char* mlo = scratch + (size_t)graph * p.scratch;
  x.mlo = mlo;
  x.mbf = mbf;
  x.mg = m_at(m, mbf, (size_t)graph * n * n);
  x.qlo0 = reinterpret_cast<bf16*>(smem_raw);
  x.qf = x.single() ? reinterpret_cast<float*>(mlo + (size_t)n * n * 2)
                     : reinterpret_cast<float*>(smem_raw);
  x.ring = smem_raw + p.off_ring;
  x.gpart0 = reinterpret_cast<float*>(smem_raw + p.off_ring);
  x.gram = reinterpret_cast<float*>(smem_raw + p.off_gram);
  x.glo = reinterpret_cast<bf16*>(smem_raw + p.off_glo);
  x.redw = reinterpret_cast<float*>(smem_raw + p.off_redw);
  x.redc = reinterpret_cast<float*>(smem_raw + p.off_redc);
  x.red = reinterpret_cast<float*>(smem_raw + p.off_red);
  x.scal = x.red + kp;
  x.tid = threadIdx.x; x.warp = threadIdx.x >> 5; x.lane = threadIdx.x & 31;
  x.cur = 0; x.par = 0;
  const float* qg = q0 + (size_t)graph * n * k;

  // extent: 1 + the last row or column of M or Q^T with a non-zero. The
  // blocks split the rows of M; the same pass writes lo(M) in tiles.
  int* extent = reinterpret_cast<int*>(x.scal + 1);
  int* extc = extent + 1;                 // (kMaxCluster) every block's
  if (x.tid == 0) *extent = 0;
  // Also: every block of the cluster runs before any writes to another.
  cl.sync();
  int ext = 0;
  const int nq = n / 4, share = n * nq / x.nblk;
#pragma unroll 4
  for (int idx = x.rank * share + x.tid; idx < (x.rank + 1) * share;
       idx += kBigThreads) {
    const int j = idx / nq, c = 4 * (idx - j * nq);
    const float4 v = ld_m4(x.mg, mbf, (size_t)4 * idx);
    if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)
      ext = max(ext, max(j + 1, c + 4));
    if (lo) {
      const int jr = j & 15;
      unsigned char* d = mlo + ((size_t)(j >> 4) * p.slabs + (c >> 4)) * kTile
          + jr * 32 + ((((c >> 3) & 1) ^ ((jr >> 2) & 1)) * 16) + (c & 7) * 2;
      __nv_bfloat162 lo01 = __floats2bfloat162_rn(v.x, v.y);
      __nv_bfloat162 lo23 = __floats2bfloat162_rn(v.z, v.w);
      uint2 w;
      w.x = *reinterpret_cast<uint32_t*>(&lo01);
      w.y = *reinterpret_cast<uint32_t*>(&lo23);
      *reinterpret_cast<uint2*>(d) = w;
    }
  }
  for (int idx = x.rank * kBigThreads + x.tid; idx < n * k;
       idx += kBigThreads * x.nblk)
    if (qg[idx] != 0.f) ext = max(ext, idx / k + 1);
  ext = __reduce_max_sync(0xffffffffu, ext);
  if (x.lane == 0) atomicMax(extent, ext);
  __syncthreads();
  if (x.tid < x.nblk) cl.map_shared_rank(extc, x.tid)[x.rank] = *extent;
  cl.sync();   // also: lo(M) in device memory is visible to the cluster
  ext = 0;
  for (int r = 0; r < x.nblk; ++r) ext = max(ext, extc[r]);
  x.ne = min(n, max(32, (ext + 31) / 32 * 32));
  // The live slabs, dealt out in runs: the last blocks may get fewer, or
  // none.
  const int slabs_live = x.ne / 16;
  const int spb = (slabs_live + x.nblk - 1) / x.nblk;
  x.s0 = min(x.rank * spb, slabs_live);
  x.s1 = min(x.s0 + spb, slabs_live);

  if (lo) {
    // Q^T into this warp's fragments; padded rows (>= k) stay zero.
    float q[KT][2][4];
    const int g = x.lane >> 2, t = x.lane & 3, c0 = (x.s0 + x.warp) * 16;
#pragma unroll
    for (int mt = 0; mt < KT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = mt * 16 + g + 8 * (e >> 1);
          const int col = c0 + nt * 8 + 2 * t + (e & 1);
          q[mt][nt][e] = (x.warp_live() && row < k) ? qg[col * k + row] : 0.f;
        }
    big_store_lo(x, q, true);
    for (int r = 0; r < rounds; ++r) {
      for (int s = 0; s < orth_every; ++s) {
        big_power_lo(x, q);
        if (s + 1 < orth_every) big_store_lo(x, q, true);
      }
      big_ns_lo(x, q, ns_steps);
    }
    // The rounds are done with the bf16 copies (every block passed the
    // barrier of the last store): the f32 Q^T takes their place, each
    // warp's columns in every block's copy (or in the one copy in device
    // memory).
    if (x.warp_live()) {
      for (int r = 0; r < (x.single() ? 1 : x.nblk); ++r) {
        float* dst = x.single() ? x.qf : cl.map_shared_rank(x.qf, r);
#pragma unroll
        for (int mt = 0; mt < KT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int col = c0 + nt * 8 + 2 * t;
            *reinterpret_cast<float2*>(&dst[(mt * 16 + g) * x.ldf + col]) =
                make_float2(q[mt][nt][0], q[mt][nt][1]);
            *reinterpret_cast<float2*>(
                &dst[(mt * 16 + g + 8) * x.ldf + col]) =
                make_float2(q[mt][nt][2], q[mt][nt][3]);
          }
      }
    }
    cl.sync();
  } else {
    // Every block fills its own copy with all live columns (the blocks
    // split the one copy in device memory).
    const int first = x.single() ? x.rank * kBigThreads + x.tid : x.tid;
    const int step = x.single() ? x.nblk * kBigThreads : kBigThreads;
    for (int idx = first; idx < kp * x.ne; idx += step) {
      const int r = idx / x.ne, c = idx - r * x.ne;
      x.qf[r * x.ldf + c] = (r < k) ? qg[c * k + r] : 0.f;
    }
    if (x.single()) cl.sync(); else __syncthreads();
    for (int r = 0; r < rounds; ++r) {
      for (int s = 0; s < orth_every; ++s) big_step_f32(x);
      big_ns_f32(x, ns_steps);
    }
  }
  for (int s = 0; s < polish; ++s) big_polish_f32(x);
  if (final_ns) big_ns_f32(x, final_ns);

  // Every path above ends with a cluster barrier: the block's copy holds
  // all live columns, and no block touches another's shared memory any
  // more.
  float* ob = out + (size_t)graph * n * k;
  for (int idx = x.rank * kBigThreads + x.tid; idx < n * k;
       idx += kBigThreads * x.nblk) {
    const int c = idx / k, r = idx - c * k;
    ob[idx] = c < x.ne ? x.qf[r * x.ldf + c] : 0.f;
  }
}

// 0 unknown, 1 the card places the cluster, -1 it does not; by device,
// n / 32, kt. A device beyond the table is asked at every launch. Threads
// that race here ask the same question and store the same answer.
constexpr int kFitsDevices = 16;
std::atomic<int> g_cluster_fits[kFitsDevices][832 / 32 + 1][kMaxKt + 1];

template <int KT>
int launch_big(const BigPlan& p, const void* m, const void* q0, void* out,
               void* scratch, int batch, int rounds, int orth_every,
               int ns_steps, int polish, int final_ns, int lo,
               cudaStream_t stream) {
  auto kern = pe_cluster_kernel<KT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * p.cluster, 1, 1);
  cfg.blockDim = dim3(kBigThreads, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::atomic<int>* cached =
      dev < kFitsDevices ? &g_cluster_fits[dev][p.n / 32][KT] : nullptr;
  int fits = cached ? cached->load(std::memory_order_relaxed) : 0;
  if (fits == 0) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (err != cudaSuccess) return (int)err;
    fits = clusters > 0 ? 1 : -1;
    if (cached) cached->store(fits, std::memory_order_relaxed);
  }
  if (fits < 0) return (int)cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, kern, (const float*)m, (const float*)q0,
                           (float*)out, (unsigned char*)scratch, p, rounds,
                           orth_every, ns_steps, polish, final_ns, lo);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---- the general plan: 80 < k <= 832, every N <= 832 -------------------
//
// Widths above 80 (PE 66 and more with the eval profile's 16 guards, PE 81
// and more on the train profile) are reached by no configuration the
// repository ships, but the reference computes them: it sends every bucket
// with N*N*6 <= 4 MiB to its kernel whatever k. No fixed tile of Q^T fits
// a warp's registers at these widths (k = 832 would take 416 accumulators
// a lane), so this plan is a chain of small batched GEMMs, every operand
// in a device scratch that stays in L2, tiles streamed through shared
// memory. What bounds it on the card: operations — at (16, 832, 832), k =
// 256, the bf16 rounds are four fifths of the operations, and the f32
// polish and finish (a fifteenth of the bf16 rate) four fifths of the
// bound. What holds this design back (PERF.md): the issue slots of the
// tensor-core loop (the split A operand costs four IEEE adds per mma) and
// the f32 tiles at about half the FMA rate; the rounds take over half the
// time.
//   * A thread block CLUSTER per graph: the most blocks (at most 8, the
//     portable size) whose batch x cluster fits one wave of the card's 132
//     SMs and whose clusters the card holds at once (it is asked: a GPC
//     holds whole clusters, and an H100 80GB HBM3 holds 15 of 8 blocks,
//     17 of 6): 6 at a batch of 16, 2 at 64, 1 from 67 up. 512 threads a
//     block. Every step is one GEMM whose 128 x 64 output tiles
//     are dealt to the cluster's blocks round robin; a cluster barrier
//     (release/acquire, which also orders the scratch in device memory)
//     closes the step. A tile's result does not depend on which block
//     computes it, so the output does not depend on the batch.
//   * Q is stored as (N, kp), row c holding column c of Q^T: an f32 copy
//     and a bf16 copy, each double-buffered; M's bf16 copy (N, N) is made
//     once, by the prologue that also finds the live extent. G (kp, kp) in
//     f32 (two buffers) and bf16. Every step reads its operands at the live
//     extent only: at (16, 832, 832), k = 256 a power step touches 27 MB
//     (lo(M) and the two copies of lo(Q)), well inside the 50 MB L2.
//   * The bf16 rounds on the tensor cores: mma.sync m16n8k16, bf16 inputs,
//     f32 accumulators, operands by ldmatrix from a four-stage cp.async
//     ring of 64-deep slices (one barrier a slice; a block's tiles run as
//     one stream of slices, so the next tile's loads overlap this one's
//     last slices). 16 warps as 4 x 4, 32 x 16 outputs a warp. The A
//     operand is split in two (mma_step<true>, as the wide plan's
//     five-tile widths): the tensor core cuts its sums.
//     Power step Q <- lo(M)^T lo(Q) (A = lo(M) as stored, M[j][c], read
//     with ldmatrix.trans: M[c][j] never stands in for it), Gram lo(Q)^T
//     lo(Q), update Q <- 1.5 Q - 0.5 lo(Q) lo(G).
//   * The f32 steps (polish, finish, and every round when lo = 0) on the
//     CUDA cores: the same tiles from the ring in 32-deep f32 slices, a
//     thread owns a 4 x 4 register tile (16 FMAs per two 128-bit loads:
//     the shared memory's 128 B a clock, not the FMAs, bounds them). No
//     TF32.
//   * The Gram's tiles cover its upper triangle only and each is written
//     twice, at (a, b) and (b, a), so G is symmetric bit for bit: the
//     update reads row b of G as column b, and the Gershgorin sums read a
//     column as the row.
//   * colunit's sums of squares and the Gershgorin sums in f64, rounded to
//     f32 once (see SqSum): the sums of squares in fixed chunks of 128
//     rows, added in chunk order. The 1e-20 floors. bf16 rounding exactly
//     where the plain version rounds.
//   * Work follows the data: every GEMM runs over the live rows and columns
//     only (the extent rounded up to 32; skipped terms are exact zeros),
//     tiles beyond it are zero-filled by cp.async, and zeros come out
//     beyond it.

constexpr int kGenMaxN = 832;
constexpr int kGenMaxK = 832;
constexpr int kGenThreads = 512;
constexpr int kGenMaxCluster = 8;   // the portable cluster size
constexpr int kGenSms = 132;        // an H100's SMs: batch x cluster fills them
constexpr int kGenBm = 128, kGenBn = 64;   // output tile
constexpr int kGenBkLo = 64, kGenBkF = 32;   // depth of a bf16 / f32 slice
constexpr int kGenStages = 4;       // slices in the ring, 3 copies in flight
constexpr int kGenChunk = 128;      // rows of a partial sum of squares
// Row strides (elements) of the staged slices, padded so that ldmatrix's
// eight rows and the f32 steps' 128-bit loads fall on distinct banks.
constexpr int kLdAk = kGenBm + 8;     // bf16 A, depth-major [k][m]
constexpr int kLdAm = kGenBkLo + 8;   // bf16 A, row-major [m][k]
constexpr int kLdB = kGenBn + 8;      // bf16 B [k][n]
constexpr int kLdFk = kGenBm + 4;     // f32 A, depth-major
constexpr int kLdFm = kGenBkF + 4;    // f32 A, row-major
constexpr int kLdFb = kGenBn + 4;     // f32 B
constexpr int kOffBLo =               // bytes: a bf16 slice's B after its A
    2 * (kGenBm * kLdAm > kGenBkLo * kLdAk ? kGenBm * kLdAm
                                           : kGenBkLo * kLdAk);
constexpr int kOffBF =                // bytes: an f32 slice's B after its A
    4 * (kGenBm * kLdFm > kGenBkF * kLdFk ? kGenBm * kLdFm : kGenBkF * kLdFk);
constexpr int kStageLo = kOffBLo + 2 * kGenBkLo * kLdB;
constexpr int kStageF = kOffBF + 4 * kGenBkF * kLdFb;
constexpr int kGenStage = kStageLo > kStageF ? kStageLo : kStageF;
constexpr int kGenMisc = 256;       // per-warp partials, the scale, the extent

struct GenPlan {
  int n, k, kp;
  int cluster;         // blocks per graph
  int tiles;           // most tiles of a power step a block takes, all N live
  int smem;            // bytes of dynamic shared memory
  long long scratch;   // bytes of device scratch per graph
};

// Shapes: n a multiple of 32 up to 832, 80 < k <= 832, any batch.
// held[c]: how many clusters of c blocks the card holds at once (c = 1 ..
// 8), or null to ask only whether the shape is the plan's. The cluster is
// the largest c whose batch x c blocks fit one wave of the SMs and whose
// batch of clusters the card holds at once: a GPC holds whole clusters
// only, and an H100 80GB HBM3 holds 15 clusters of 8 blocks, not 16.
inline bool pe_general_plan(int n, int k, int batch, const int* held,
                            GenPlan* p) {
  if (n < 32 || n > kGenMaxN || n % 32 != 0 || k <= 16 * kMaxKt ||
      k > kGenMaxK)
    return false;
  p->n = n; p->k = k;
  p->kp = align16(k);
  p->cluster = 1;
  for (int c = 2; held && c <= kGenMaxCluster; ++c)
    if ((long long)batch * c <= kGenSms && batch <= held[c]) p->cluster = c;
  const int tiles =
      ((n + kGenBm - 1) / kGenBm) * ((p->kp + kGenBn - 1) / kGenBn);
  p->tiles = (tiles + p->cluster - 1) / p->cluster;
  p->smem = kGenStages * kGenStage + p->kp * 4 + kGenMisc;
  // lo(M) | f32 Q x 2 | bf16 Q x 2 | f32 G x 2 | bf16 G | partial sums of
  // squares | the blocks' extents. Every part a multiple of 256 bytes.
  const long long nn = n, kp = p->kp;
  const long long part = ((n + kGenChunk - 1) / kGenChunk) * kp * 8;
  p->scratch = 2 * nn * nn + 12 * nn * kp + 10 * kp * kp +
               (part + 255) / 256 * 256 + 256;
  return true;
}

struct Gx {
  int n, kp, ne;         // ne: live nodes, a multiple of 32
  int tid, rank, csize;  // this thread, this block in its cluster, blocks
  const float* m;        // this graph's M (n, n) as stored: f32, or bf16
  bool mbf;              //   where mbf (read through ld_m4 / stage_m4)
  bf16* mlo;             // (n, n) bf16 copy of M
  float* qf[2];          // (n, kp) f32 Q, double-buffered
  bf16* ql[2];           // (n, kp) bf16 Q, double-buffered
  float* ga;             // (kp, kp) f32 G
  float* gb;             // (kp, kp) f32 G scaled (the f32 finish's first step)
  bf16* glo;             // (kp, kp) bf16 G
  double* part;          // (ceil(n / 128), kp) partial sums of squares
  float* red;            // shared: (kp) row norms
  double* wred;          // shared: (16) per-warp maxima
  float* scal;           // shared: the Gershgorin scale
  int f, cur;            // which f32 copy and which bf16 copy hold Q
};

// Every step ends here: a block barrier, or a cluster barrier whose
// release/acquire also orders the device-memory writes between blocks.
__device__ __forceinline__ void gsync(const Gx& x) {
  if (x.csize > 1) cg::this_cluster().sync();
  else __syncthreads();
}

// A 16-byte copy to shared memory, zeros where !ok (nothing is read).
__device__ __forceinline__ void cp_async16z(void* dst, const void* src,
                                            bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

// The output tiles of a step: tm x tn tiles of 128 x 64, or (upper) those
// of a kp x kp Gram that hold an entry (a, b) with a <= b: J >= 2 I.
struct Tiles {
  int tm, tn;
  bool upper;
  __device__ int count() const {
    if (!upper) return tm * tn;
    int s = 0;
    for (int i = 0; i < tm; ++i) s += max(0, tn - 2 * i);
    return s;
  }
  __device__ void at(int t, int& i, int& j) const {
    if (!upper) { i = t / tn; j = t - i * tn; return; }
    i = 0;
    while (t >= tn - 2 * i) { t -= tn - 2 * i; ++i; }
    j = 2 * i + t;
  }
};

// The general plan's dynamic shared memory: the ring of slices, then the
// row norms and the reductions' scratch. Named at file scope so that every
// access compiles to a shared-memory instruction.
extern __shared__ __align__(16) unsigned char gen_smem[];

// The next slice of a block's stream of tiles: its tile's origin, its
// depth offset and its stage of the ring. Advanced without a division.
struct Cursor {
  int tile, k0, m0, n0, stage;
  __device__ void start(const Gx& x, const Tiles& tl, int mine) {
    tile = 0; k0 = 0; stage = 0;
    if (mine) origin(x, tl);
  }
  __device__ void origin(const Gx& x, const Tiles& tl) {
    int ti, tj;
    tl.at(x.rank + tile * x.csize, ti, tj);
    m0 = ti * kGenBm; n0 = tj * kGenBn;
  }
  // Returns true where this slice ended its tile.
  __device__ bool next(const Gx& x, const Tiles& tl, int mine, int K,
                       int bk) {
    stage = stage + 1 == kGenStages ? 0 : stage + 1;
    k0 += bk;
    if (k0 < K) return false;
    k0 = 0;
    if (++tile < mine) origin(x, tl);
    return true;
  }
};

// out[m][n] = sum over k < K of A(m, k) B(k, n) for m < M, n < N, on the
// tensor cores; epi(m, n, v0, v1) takes outputs (m, n) and (m, n + 1). A is
// bf16 in device memory, depth-major (AK: A(m, k) = A[k * lda + m]) or
// row-major (A[m * lda + k]); B is bf16, B(k, n) = B[k * ldb + n]. Each
// output's sum runs over k in order, one 16-deep step at a time. The
// block's tiles run as one stream of 64-deep slices through the ring, so
// the next tile's first slices are in flight during this tile's last ones
// and its epilogue.
template <bool AK, class Epi>
__device__ void gemm_lo(const Gx& x, const bf16* A, int lda, const bf16* B,
                        int ldb, int M, int N, int K, bool upper, Epi epi) {
  constexpr int bk = kGenBkLo;
  const Tiles tl{(M + kGenBm - 1) / kGenBm, (N + kGenBn - 1) / kGenBn, upper};
  const int ntiles = tl.count();
  const int mine = ntiles > x.rank ? (ntiles - x.rank - 1) / x.csize + 1 : 0;
  const int tid = x.tid, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 16;
  const int slices = mine * ((K + bk - 1) / bk);
  const int lr = lane & 15, lc = (lane >> 4) * 8;
  // ldmatrix.trans of a depth-major A: this lane's row of matrix lane / 8.
  const int ak = (lane & 7) + 8 * (lane >> 4), am = 8 * ((lane >> 3) & 1);
  const int g = lane >> 2, t4 = lane & 3;
  Cursor ld, cp;
  ld.start(x, tl, mine);
  cp.start(x, tl, mine);
  int loaded = 0;
  auto load = [&]() {
    if (loaded < slices) {
      unsigned char* st = gen_smem + ld.stage * kGenStage;
      bf16* as = reinterpret_cast<bf16*>(st);
      bf16* bs = reinterpret_cast<bf16*>(st + kOffBLo);
      const int k0 = ld.k0, m0 = ld.m0, n0 = ld.n0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int idx = tid + h * kGenThreads;
        if (AK) {
          const int kk = idx >> 4, mm = (idx & 15) * 8;
          const bool ok = k0 + kk < K && m0 + mm < M;
          cp_async16z(as + kk * kLdAk + mm,
                      ok ? A + (size_t)(k0 + kk) * lda + m0 + mm : A, ok);
        } else {
          const int mm = idx >> 3, kk = (idx & 7) * 8;
          const bool ok = m0 + mm < M && k0 + kk < K;
          cp_async16z(as + mm * kLdAm + kk,
                      ok ? A + (size_t)(m0 + mm) * lda + k0 + kk : A, ok);
        }
      }
      const int kk = tid >> 3, nn = (tid & 7) * 8;
      const bool ok = k0 + kk < K && n0 + nn < N;
      cp_async16z(bs + kk * kLdB + nn,
                  ok ? B + (size_t)(k0 + kk) * ldb + n0 + nn : B, ok);
      ld.next(x, tl, mine, K, bk);
      ++loaded;
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  float acc[2][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll
  for (int s = 0; s < kGenStages - 1; ++s) load();
  for (int s = 0; s < slices; ++s) {
    // Slice s has landed for every thread, and every warp is done with
    // slice s - 1, whose stage the next copy refills.
    asm volatile("cp.async.wait_group %0;" :: "n"(kGenStages - 2) : "memory");
    __syncthreads();
    load();
    const unsigned char* st = gen_smem + cp.stage * kGenStage;
    const bf16* as = reinterpret_cast<const bf16*>(st);
    const bf16* bs = reinterpret_cast<const bf16*>(st + kOffBLo);
#pragma unroll
    for (int ks = 0; ks < bk / 16; ++ks) {
      uint32_t b[4];
      ldsm_x4_trans(b, bs + (ks * 16 + lr) * kLdB + wn + lc);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        uint32_t a[4];
        if (AK)
          ldsm_x4_trans(a, as + (ks * 16 + ak) * kLdAk + wm + mt * 16 + am);
        else
          ldsm_x4(a, as + (wm + mt * 16 + lr) * kLdAm + ks * 16 + lc);
        mma_step<true>(acc[mt][0], a, b[0], b[1]);
        mma_step<true>(acc[mt][1], a, b[2], b[3]);
      }
    }
    const int m0 = cp.m0, n0 = cp.n0;
    if (!cp.next(x, tl, mine, K, bk)) continue;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int m = m0 + wm + mt * 16 + g, n = n0 + wn + nt * 8 + 2 * t4;
        if (n < N) {
          if (m < M) epi(m, n, acc[mt][nt][0], acc[mt][nt][1]);
          if (m + 8 < M) epi(m + 8, n, acc[mt][nt][2], acc[mt][nt][3]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
      }
  }
}

// The same product in f32 on the CUDA cores (32-deep slices): A and B
// f32, a thread owns rows 4 ty .. 4 ty + 3 by columns 4 tx .. 4 tx + 3 of
// the tile; a warp's lanes take 4 rows of threads by 8 columns. a_bf: A is
// stored in bf16 (a bf16 M), widened as its slices land.
template <bool AK, class Epi>
__device__ void gemm_f32(const Gx& x, const float* A, int lda, const float* B,
                         int ldb, int M, int N, int K, bool upper, Epi epi,
                         bool a_bf = false) {
  constexpr int bk = kGenBkF;
  const Tiles tl{(M + kGenBm - 1) / kGenBm, (N + kGenBn - 1) / kGenBn, upper};
  const int ntiles = tl.count();
  const int mine = ntiles > x.rank ? (ntiles - x.rank - 1) / x.csize + 1 : 0;
  const int tid = x.tid, warp = tid >> 5, lane = tid & 31;
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  const int tx = (warp & 1) * 8 + (lane & 7);
  const int slices = mine * ((K + bk - 1) / bk);
  Cursor ld, cp;
  ld.start(x, tl, mine);
  cp.start(x, tl, mine);
  int loaded = 0;
  auto load = [&]() {
    if (loaded < slices) {
      unsigned char* st = gen_smem + ld.stage * kGenStage;
      float* as = reinterpret_cast<float*>(st);
      float* bs = reinterpret_cast<float*>(st + kOffBF);
      const int k0 = ld.k0, m0 = ld.m0, n0 = ld.n0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int idx = tid + h * kGenThreads;
        // The slice's offset in A and in the stage, zeros where !ok.
        const int kk = AK ? idx >> 5 : (idx & 7) * 4;
        const int mm = AK ? (idx & 31) * 4 : idx >> 3;
        const bool ok = k0 + kk < K && m0 + mm < M;
        const size_t at = AK ? (size_t)(k0 + kk) * lda + m0 + mm
                             : (size_t)(m0 + mm) * lda + k0 + kk;
        float* dst = as + (AK ? kk * kLdFk + mm : mm * kLdFm + kk);
        if (a_bf)
          *reinterpret_cast<float4*>(dst) =
              ok ? ld_m4(A, true, at) : make_float4(0.f, 0.f, 0.f, 0.f);
        else
          cp_async16z(dst, ok ? A + at : A, ok);
      }
      const int kk = tid >> 4, nn = (tid & 15) * 4;
      const bool ok = k0 + kk < K && n0 + nn < N;
      cp_async16z(bs + kk * kLdFb + nn,
                  ok ? B + (size_t)(k0 + kk) * ldb + n0 + nn : B, ok);
      ld.next(x, tl, mine, K, bk);
      ++loaded;
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[i][u] = 0.f;
#pragma unroll
  for (int s = 0; s < kGenStages - 1; ++s) load();
  for (int s = 0; s < slices; ++s) {
    asm volatile("cp.async.wait_group %0;" :: "n"(kGenStages - 2) : "memory");
    __syncthreads();
    load();
    const unsigned char* st = gen_smem + cp.stage * kGenStage;
    const float* as = reinterpret_cast<const float*>(st);
    const float* bs = reinterpret_cast<const float*>(st + kOffBF) + 4 * tx;
    if (AK) {
      as += 4 * ty;
#pragma unroll 8
      for (int kk = 0; kk < bk; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(as + kk * kLdFk);
        const float4 b = *reinterpret_cast<const float4*>(bs + kk * kLdFb);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(av[i], b.x, acc[i][0]);
          acc[i][1] = fmaf(av[i], b.y, acc[i][1]);
          acc[i][2] = fmaf(av[i], b.z, acc[i][2]);
          acc[i][3] = fmaf(av[i], b.w, acc[i][3]);
        }
      }
    } else {
      as += 4 * ty * kLdFm;
#pragma unroll 2
      for (int kk = 0; kk < bk; kk += 4) {
        float4 b[4];
#pragma unroll
        for (int v = 0; v < 4; ++v)
          b[v] = *reinterpret_cast<const float4*>(bs + (kk + v) * kLdFb);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          fma_1x4x4(acc[i],
                    *reinterpret_cast<const float4*>(as + i * kLdFm + kk), b);
      }
    }
    const int m0 = cp.m0, n = cp.n0 + 4 * tx;
    if (!cp.next(x, tl, mine, K, bk)) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + 4 * ty + i;
      if (n < N && m < M) {
        epi(m, n, acc[i][0], acc[i][1]);
        epi(m, n + 2, acc[i][2], acc[i][3]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][u] = 0.f;
    }
  }
}

// Gram entries (a, b) and (a, b + 1) of a tile, written where a <= b and
// mirrored: G is symmetric bit for bit.
template <class T>
__device__ __forceinline__ void gram_put(T* g, int kp, int a, int b, T v0,
                                         T v1) {
  if (a <= b) { g[a * kp + b] = v0; g[b * kp + a] = v0; }
  if (a <= b + 1) { g[a * kp + b + 1] = v1; g[(b + 1) * kp + a] = v1; }
}

// Columns of Q (rows of Q^T) to unit norm, floor 1e-20, in place on the
// current f32 copy; LO: also its bf16 copy into ql[cur]. The sums of
// squares in f64 over chunks of 128 rows (one per thread of the cluster),
// then the chunks in order by every block; each block scales its share.
template <bool LO>
__device__ void gen_colunit(Gx& x) {
  float* q = x.qf[x.f];
  const int kp = x.kp, all = x.csize * kGenThreads;
  const int nct = (x.ne + kGenChunk - 1) / kGenChunk;
  for (int it = x.rank * kGenThreads + x.tid; it < nct * kp; it += all) {
    const int ct = it / kp, r = it - ct * kp;
    const int c1 = min(x.ne, (ct + 1) * kGenChunk);
    double s = 0.0;
    for (int c = ct * kGenChunk; c < c1; ++c) s = sq_add(s, q[c * kp + r]);
    x.part[it] = s;
  }
  gsync(x);
  for (int r = x.tid; r < kp; r += kGenThreads) {
    double s = 0.0;
    for (int ct = 0; ct < nct; ++ct) s += x.part[ct * kp + r];
    x.red[r] = fmaxf(__fsqrt_rn((float)s), 1e-20f);
  }
  __syncthreads();
  for (int i = 4 * (x.rank * kGenThreads + x.tid); i < x.ne * kp;
       i += 4 * all) {
    float4 v = *reinterpret_cast<float4*>(q + i);
    const float* d = x.red + i % kp;
    v.x = __fdiv_rn(v.x, d[0]);
    v.y = __fdiv_rn(v.y, d[1]);
    v.z = __fdiv_rn(v.z, d[2]);
    v.w = __fdiv_rn(v.w, d[3]);
    *reinterpret_cast<float4*>(q + i) = v;
    if (LO) {
      __nv_bfloat162* l = reinterpret_cast<__nv_bfloat162*>(x.ql[x.cur] + i);
      l[0] = __floats2bfloat162_rn(v.x, v.y);
      l[1] = __floats2bfloat162_rn(v.z, v.w);
    }
  }
  gsync(x);
}

// The Gershgorin scale sc = 1 / sqrt(max_a sum_b |G_ab|), floor 1e-20, from
// the f32 G in x.ga (every block, each sum in f64 over a column, which is
// the row), then Q *= sc in place (LO: and its bf16 copy) and G's scaled
// copy: lo(sc^2 G) into glo (LO) or sc^2 G into gb, each block its share.
template <bool LO>
__device__ void gen_scale(Gx& x) {
  const int kp = x.kp, all = x.csize * kGenThreads;
  const int warp = x.tid >> 5, lane = x.tid & 31;
  double best = 0.0;
  for (int a = x.tid; a < kp; a += kGenThreads) {
    double s = 0.0;
#pragma unroll 8
    for (int b = 0; b < kp; ++b) s += fabs((double)x.ga[b * kp + a]);
    best = fmax(best, s);
  }
  for (int off = 16; off > 0; off >>= 1)
    best = fmax(best, __shfl_xor_sync(0xffffffffu, best, off));
  if (lane == 0) x.wred[warp] = best;
  __syncthreads();
  if (x.tid == 0) {
    double b = 0.0;
    for (int w = 0; w < kGenThreads / 32; ++w) b = fmax(b, x.wred[w]);
    x.scal[0] = rsqrtf(fmaxf((float)b, 1e-20f));
  }
  __syncthreads();
  const float sc = x.scal[0];
  const float sc2 = __fmul_rn(sc, sc);
  float* q = x.qf[x.f];
  for (int i = 4 * (x.rank * kGenThreads + x.tid); i < x.ne * kp;
       i += 4 * all) {
    float4 v = *reinterpret_cast<float4*>(q + i);
    v.x = __fmul_rn(v.x, sc);
    v.y = __fmul_rn(v.y, sc);
    v.z = __fmul_rn(v.z, sc);
    v.w = __fmul_rn(v.w, sc);
    *reinterpret_cast<float4*>(q + i) = v;
    if (LO) {
      __nv_bfloat162* l = reinterpret_cast<__nv_bfloat162*>(x.ql[x.cur] + i);
      l[0] = __floats2bfloat162_rn(v.x, v.y);
      l[1] = __floats2bfloat162_rn(v.z, v.w);
    }
  }
  for (int i = 4 * (x.rank * kGenThreads + x.tid); i < kp * kp;
       i += 4 * all) {
    float4 v = *reinterpret_cast<const float4*>(x.ga + i);
    v.x = __fmul_rn(v.x, sc2);
    v.y = __fmul_rn(v.y, sc2);
    v.z = __fmul_rn(v.z, sc2);
    v.w = __fmul_rn(v.w, sc2);
    if (LO) {
      __nv_bfloat162* l = reinterpret_cast<__nv_bfloat162*>(x.glo + i);
      l[0] = __floats2bfloat162_rn(v.x, v.y);
      l[1] = __floats2bfloat162_rn(v.z, v.w);
    } else {
      *reinterpret_cast<float4*>(x.gb + i) = v;
    }
  }
  gsync(x);
}

// One bf16 power step, Q <- lo(M)^T lo(Q): the next bf16 copy, or (last of
// the round, which colunit reads next) the f32 copy.
__device__ void gen_power_lo(Gx& x, bool last) {
  const int kp = x.kp;
  bf16* nxt = x.ql[x.cur ^ 1];
  float* qf = x.qf[x.f];
  gemm_lo<true>(x, x.mlo, x.n, x.ql[x.cur], kp, x.ne, kp, x.ne, false,
                [&](int c, int r, float v0, float v1) {
                  if (last)
                    *reinterpret_cast<float2*>(qf + c * kp + r) =
                        make_float2(v0, v1);
                  else
                    *reinterpret_cast<__nv_bfloat162*>(nxt + c * kp + r) =
                        __floats2bfloat162_rn(v0, v1);
                });
  gsync(x);
  if (!last) x.cur ^= 1;
}

// G = lo(Q)^T lo(Q) from ql[cur]: into the f32 G (the round's first Gram,
// which the scale reads) or straight into lo(G).
__device__ void gen_gram_lo(Gx& x, bool to_f32) {
  const int kp = x.kp;
  const bf16* q = x.ql[x.cur];
  float* ga = x.ga;
  bf16* glo = x.glo;
  gemm_lo<true>(x, q, kp, q, kp, kp, kp, x.ne, true,
                [&](int a, int b, float v0, float v1) {
                  if (to_f32)
                    gram_put(ga, kp, a, b, v0, v1);
                  else
                    gram_put(glo, kp, a, b, __float2bfloat16_rn(v0),
                             __float2bfloat16_rn(v1));
                });
  gsync(x);
}

// Newton-Schulz with bf16-input products, on the f32 copy and ql[cur]:
// colunit, the Gram, the Gershgorin scale, then `steps` updates
// Q <- 1.5 Q - 0.5 lo(Q) lo(G), each after a new Gram but the first.
__device__ void gen_ns_lo(Gx& x, int steps) {
  const int kp = x.kp;
  gen_colunit<true>(x);
  gen_gram_lo(x, true);
  gen_scale<true>(x);
  for (int it = 0; it < steps; ++it) {
    if (it) gen_gram_lo(x, false);
    float* qf = x.qf[x.f];
    bf16* nxt = x.ql[x.cur ^ 1];
    gemm_lo<false>(x, x.ql[x.cur], kp, x.glo, kp, x.ne, kp, kp, false,
                   [&](int c, int a, float v0, float v1) {
                     float2* p = reinterpret_cast<float2*>(qf + c * kp + a);
                     const float2 q = *p;
                     const float u0 = __fsub_rn(__fmul_rn(1.5f, q.x),
                                                __fmul_rn(0.5f, v0));
                     const float u1 = __fsub_rn(__fmul_rn(1.5f, q.y),
                                                __fmul_rn(0.5f, v1));
                     *p = make_float2(u0, u1);
                     *reinterpret_cast<__nv_bfloat162*>(nxt + c * kp + a) =
                         __floats2bfloat162_rn(u0, u1);
                   });
    gsync(x);
    x.cur ^= 1;
  }
}

// One f32 power step, Q <- M^T Q into the other f32 copy.
__device__ void gen_power_f32(Gx& x) {
  const int kp = x.kp;
  float* nxt = x.qf[x.f ^ 1];
  gemm_f32<true>(x, x.m, x.n, x.qf[x.f], kp, x.ne, kp, x.ne, false,
                 [&](int c, int r, float v0, float v1) {
                   *reinterpret_cast<float2*>(nxt + c * kp + r) =
                       make_float2(v0, v1);
                 }, x.mbf);
  gsync(x);
  x.f ^= 1;
}

// G = Q^T Q in f32 from the current f32 copy, into x.ga.
__device__ void gen_gram_f32(Gx& x) {
  const int kp = x.kp;
  const float* q = x.qf[x.f];
  float* ga = x.ga;
  gemm_f32<true>(x, q, kp, q, kp, kp, kp, x.ne, true,
                 [&](int a, int b, float v0, float v1) {
                   gram_put(ga, kp, a, b, v0, v1);
                 });
  gsync(x);
}

// Newton-Schulz in f32 on the f32 copy; the first update reads the scaled
// Gram (x.gb), the others a new one.
__device__ void gen_ns_f32(Gx& x, int steps) {
  const int kp = x.kp;
  gen_colunit<false>(x);
  gen_gram_f32(x);
  gen_scale<false>(x);
  for (int it = 0; it < steps; ++it) {
    if (it) gen_gram_f32(x);
    const float* cur = x.qf[x.f];
    float* nxt = x.qf[x.f ^ 1];
    gemm_f32<false>(x, cur, kp, it ? x.ga : x.gb, kp, x.ne, kp, kp, false,
                    [&](int c, int a, float v0, float v1) {
                      const float2 q =
                          *reinterpret_cast<const float2*>(cur + c * kp + a);
                      *reinterpret_cast<float2*>(nxt + c * kp + a) =
                          make_float2(__fsub_rn(__fmul_rn(1.5f, q.x),
                                                __fmul_rn(0.5f, v0)),
                                      __fsub_rn(__fmul_rn(1.5f, q.y),
                                                __fmul_rn(0.5f, v1)));
                    });
    gsync(x);
    x.f ^= 1;
  }
}

__global__ void __launch_bounds__(kGenThreads, 1)
pe_general_kernel(const float* __restrict__ m,    // (B, n, n)
                  const float* __restrict__ q0,   // (B, n, k)
                  float* __restrict__ out,        // (B, n, k)
                  unsigned char* scratch,         // (B, p.scratch)
                  GenPlan p, int rounds, int orth_every, int ns_steps,
                  int polish, int final_ns, int lo) {
  // lo: bit 0 the rounds in bf16, bit 1 M stored in bf16.
  const bool mbf = lo & 2;
  lo &= 1;
  const int n = p.n, k = p.k, kp = p.kp, csize = p.cluster;
  const int graph = blockIdx.x / csize;
  Gx x;
  x.n = n; x.kp = kp;
  x.tid = threadIdx.x; x.rank = blockIdx.x - graph * csize; x.csize = csize;
  x.mbf = mbf;
  x.m = m_at(m, mbf, (size_t)graph * n * n);
  unsigned char* sb = scratch + (size_t)graph * p.scratch;
  const size_t nn = (size_t)n * n, nkp = (size_t)n * kp, kk = (size_t)kp * kp;
  x.mlo = reinterpret_cast<bf16*>(sb);
  x.qf[0] = reinterpret_cast<float*>(sb + 2 * nn);
  x.qf[1] = x.qf[0] + nkp;
  x.ql[0] = reinterpret_cast<bf16*>(x.qf[1] + nkp);
  x.ql[1] = x.ql[0] + nkp;
  x.ga = reinterpret_cast<float*>(x.ql[1] + nkp);
  x.gb = x.ga + kk;
  x.glo = reinterpret_cast<bf16*>(x.gb + kk);
  x.part = reinterpret_cast<double*>(x.glo + kk);
  int* ext_g = reinterpret_cast<int*>(
      sb + p.scratch - 256);   // (cluster) every block's extent
  x.red = reinterpret_cast<float*>(gen_smem + kGenStages * kGenStage);
  x.wred = reinterpret_cast<double*>(x.red + kp);
  x.scal = reinterpret_cast<float*>(x.wred + kGenThreads / 32);
  int* ext_s = reinterpret_cast<int*>(x.scal + 1);
  x.f = 0; x.cur = 0;
  const int all = csize * kGenThreads, first = x.rank * kGenThreads + x.tid;

  // Prologue: the extent (1 + the last row or column of M or q0 with a
  // non-zero) and lo(M), the blocks splitting M's rows; q0 into both copies
  // of Q (padding columns >= k zero), the blocks splitting its entries.
  if (x.tid == 0) *ext_s = 0;
  __syncthreads();
  int ext = 0;
  const int nq = n / 4;
  const int j0 = x.rank * n / csize, j1 = (x.rank + 1) * n / csize;
  for (int idx = j0 * nq + x.tid; idx < j1 * nq; idx += kGenThreads) {
    const int j = idx / nq, c = 4 * (idx - j * nq);
    const float4 v = ld_m4(x.m, mbf, (size_t)4 * idx);
    if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)
      ext = max(ext, max(j + 1, c + 4));
    if (lo) {
      __nv_bfloat162* d =
          reinterpret_cast<__nv_bfloat162*>(x.mlo + (size_t)j * n + c);
      d[0] = __floats2bfloat162_rn(v.x, v.y);
      d[1] = __floats2bfloat162_rn(v.z, v.w);
    }
  }
  const float* qg = q0 + (size_t)graph * n * k;
  for (int idx = first; idx < n * kp; idx += all) {
    const int c = idx / kp, r = idx - c * kp;
    const float v = r < k ? qg[(size_t)c * k + r] : 0.f;
    if (v != 0.f) ext = max(ext, c + 1);
    x.qf[0][idx] = v;
    x.ql[0][idx] = __float2bfloat16_rn(v);
  }
  ext = __reduce_max_sync(0xffffffffu, ext);
  if ((x.tid & 31) == 0) atomicMax(ext_s, ext);
  __syncthreads();
  if (x.tid == 0) ext_g[x.rank] = *ext_s;
  gsync(x);
  ext = 0;
  for (int r = 0; r < csize; ++r) ext = max(ext, ext_g[r]);
  x.ne = min(n, max(32, (ext + 31) / 32 * 32));

  if (lo) {
    for (int r = 0; r < rounds; ++r) {
      for (int s = 0; s < orth_every; ++s)
        gen_power_lo(x, s + 1 == orth_every);
      gen_ns_lo(x, ns_steps);
    }
  } else {
    for (int r = 0; r < rounds; ++r) {
      for (int s = 0; s < orth_every; ++s) gen_power_f32(x);
      gen_ns_f32(x, ns_steps);
    }
  }
  for (int s = 0; s < polish; ++s) {
    gen_power_f32(x);
    gen_colunit<false>(x);
  }
  if (final_ns) gen_ns_f32(x, final_ns);

  // Every step ended with a barrier of the whole cluster.
  const float* q = x.qf[x.f];
  float* ob = out + (size_t)graph * n * k;
  for (int idx = first; idx < n * k; idx += all) {
    const int c = idx / k, r = idx - c * k;
    ob[idx] = c < x.ne ? q[(size_t)c * kp + r] : 0.f;
  }
}

// held[c] = how many clusters of c blocks of pe_general_kernel the current
// device holds at once, c = 1 .. 8 (cudaOccupancyMaxActiveClusters; one
// block an SM whatever the shape: the registers of 512 threads fill it).
// Asked once per device. Returns a CUDA error code.
std::atomic<int> g_general_held[kFitsDevices][kGenMaxCluster + 1];

int general_held(int* held) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const int smem = kGenStages * kGenStage + kGenMaxK * 4 + kGenMisc;
  for (int c = 1; c <= kGenMaxCluster; ++c) {
    int v = dev < kFitsDevices
                ? g_general_held[dev][c].load(std::memory_order_relaxed)
                : 0;
    if (v == 0) {
      err = cudaFuncSetAttribute(pe_general_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return (int)err;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = c;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(c, 1, 1);
      cfg.blockDim = dim3(kGenThreads, 1, 1);
      cfg.dynamicSmemBytes = smem;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      err = cudaOccupancyMaxActiveClusters(&v, pe_general_kernel, &cfg);
      if (err != cudaSuccess) return (int)err;
      if (dev < kFitsDevices)
        g_general_held[dev][c].store(v, std::memory_order_relaxed);
    }
    held[c] = v;
  }
  return 0;
}

// The plan on this device: general_held, then pe_general_plan. Raises
// (cudaErrorLaunchOutOfResources) where the card cannot place the cluster.
int general_plan_here(int n, int k, int batch, GenPlan* p) {
  int held[kGenMaxCluster + 1];
  const int err = general_held(held);
  if (err != 0) return err;
  pe_general_plan(n, k, batch, held, p);
  return held[p->cluster] > 0 ? 0 : (int)cudaErrorLaunchOutOfResources;
}

int launch_general(const GenPlan& p, const void* m, const void* q0, void* out,
                   void* scratch, int batch, int rounds, int orth_every,
                   int ns_steps, int polish, int final_ns, int lo,
                   cudaStream_t stream) {
  auto kern = pe_general_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * p.cluster, 1, 1);
  cfg.blockDim = dim3(kGenThreads, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = p.cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kern, (const float*)m, (const float*)q0,
                           (float*)out, (unsigned char*)scratch, p, rounds,
                           orth_every, ns_steps, polish, final_ns, lo);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// plan[0..8] = threads, shared-memory bytes, kp, warps, depth split of the
// tensor-core Gram, depth split of the f32 Gram (1 and 1 under the cluster
// layout and the general plan, which split neither), blocks per graph (the
// cluster), most slabs of 16 columns a block takes (the general plan: most
// 128 x 64 tiles of a power step a block takes), bytes of device scratch
// per graph. `batch` sizes the general plan's cluster only. Returns 0, or
// non-zero for a shape the kernel does not take. The plans by width: k <=
// 48 "shared" (N <= 256) and "streamed" (the cluster layout above); 48 < k
// <= 80 "wide", the same two layouts (the shared one where it fits a
// block); 80 < k <= 832 "general".
extern "C" int gcc_pe_plan(int n, int k, int batch, int* plan) {
  Plan p;
  BigPlan g;
  GenPlan w;
  if (pe_plan(n, k, &p)) {
    plan[0] = p.threads; plan[1] = p.smem; plan[2] = p.kp; plan[3] = p.warps;
    plan[4] = p.ks; plan[5] = p.chunks;
    plan[6] = 1; plan[7] = p.warps; plan[8] = 0;
    return 0;
  }
  if (pe_big_plan(n, k, &g)) {
    plan[0] = kBigThreads; plan[1] = g.smem; plan[2] = g.kp;
    plan[3] = kBigWarps; plan[4] = 1; plan[5] = 1;
    plan[6] = g.cluster; plan[7] = g.spb; plan[8] = g.scratch;
    return 0;
  }
  if (pe_general_plan(n, k, batch, nullptr, &w)) {
    const int err = general_plan_here(n, k, batch, &w);
    if (err != 0) return err;
    plan[0] = kGenThreads; plan[1] = w.smem; plan[2] = w.kp;
    plan[3] = kGenThreads / 32; plan[4] = 1; plan[5] = 1;
    plan[6] = w.cluster; plan[7] = w.tiles; plan[8] = (int)w.scratch;
    return 0;
  }
  return 1;
}

// How many clusters of `cluster` blocks of the general plan's kernel the
// card holds at once, into *count. Returns a CUDA error code.
extern "C" int gcc_pe_general_clusters(int cluster, int* count) {
  if (cluster < 1 || cluster > kGenMaxCluster)
    return (int)cudaErrorInvalidValue;
  int held[kGenMaxCluster + 1];
  const int err = general_held(held);
  if (err == 0) *count = held[cluster];
  return err;
}

// scratch: (batch, plan[8]) bytes for the cluster layout (the bf16 copy of
// M per graph, and with one bf16 copy of Q^T a block the f32 Q^T) and for
// the general plan (bf16 M, f32 and bf16 Q and G); unused and may be null
// else. m_bf16: M is stored in bf16 (else f32); see m_at.
extern "C" int gcc_pe_launch(const void* m, const void* q0, void* out,
                             void* scratch, int batch, int n, int k,
                             int iters, int orth_every, int ns_steps,
                             int polish, int final_ns, int lo, int m_bf16,
                             void* stream) {
  if (batch <= 0) return 0;
  if (orth_every <= 0 || ns_steps < 0 || polish < 0 || final_ns < 0)
    return (int)cudaErrorInvalidValue;
  const int rounds = max(1, iters / orth_every);
  cudaStream_t s = (cudaStream_t)stream;
  // The kernels' flags word: bit 0 the rounds in bf16, bit 1 M in bf16.
  lo = (lo ? 1 : 0) | (m_bf16 ? 2 : 0);
  Plan p;
  BigPlan g;
  GenPlan w;
  if (pe_plan(n, k, &p)) {
    switch (p.kt) {
      case 1:
        return launch<1>(p, m, q0, out, batch, rounds, orth_every, ns_steps,
                         polish, final_ns, lo, s);
      case 2:
        return launch<2>(p, m, q0, out, batch, rounds, orth_every, ns_steps,
                         polish, final_ns, lo, s);
      case 3:
        return launch<3>(p, m, q0, out, batch, rounds, orth_every, ns_steps,
                         polish, final_ns, lo, s);
      case 4:
        return launch<4>(p, m, q0, out, batch, rounds, orth_every, ns_steps,
                         polish, final_ns, lo, s);
      default:
        return launch<5>(p, m, q0, out, batch, rounds, orth_every, ns_steps,
                         polish, final_ns, lo, s);
    }
  }
  if (pe_general_plan(n, k, batch, nullptr, &w)) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    const int err = general_plan_here(n, k, batch, &w);
    if (err != 0) return err;
    return launch_general(w, m, q0, out, scratch, batch, rounds, orth_every,
                          ns_steps, polish, final_ns, lo, s);
  }
  if (!pe_big_plan(n, k, &g) || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  switch (g.kt) {
    case 1:
      return launch_big<1>(g, m, q0, out, scratch, batch, rounds, orth_every,
                           ns_steps, polish, final_ns, lo, s);
    case 2:
      return launch_big<2>(g, m, q0, out, scratch, batch, rounds, orth_every,
                           ns_steps, polish, final_ns, lo, s);
    case 3:
      return launch_big<3>(g, m, q0, out, scratch, batch, rounds, orth_every,
                           ns_steps, polish, final_ns, lo, s);
    case 4:
      return launch_big<4>(g, m, q0, out, scratch, batch, rounds, orth_every,
                           ns_steps, polish, final_ns, lo, s);
    default:
      return launch_big<5>(g, m, q0, out, scratch, batch, rounds, orth_every,
                           ns_steps, polish, final_ns, lo, s);
  }
}
