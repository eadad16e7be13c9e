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
// plan at the end of this file (pe_cluster_kernel): the same steps in the
// same order on a cluster of 2 or 4 blocks per graph, the rounds on the
// tensor cores against a bf16 copy of M that the kernel makes once in a
// device scratch and streams for every power step, Q^T in registers and
// in a bf16 copy in every block's shared memory.
//
// Widths 48 < k <= 80 (PE 64, with and without the eval profile's 16
// guards) take the WIDE plan (pe_wide_kernel, after the streamed plan) at
// every N <= 832: one block per graph, Q in a device scratch, every
// product an f32 FMA on operands rounded to bf16 where the reference
// rounds them.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

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

inline int align16(int x) { return (x + 15) / 16 * 16; }

// Shapes: n a multiple of 32 up to 256, 1 <= k <= 48.
inline bool pe_plan(int n, int k, Plan* p) {
  if (n < 32 || n > 256 || n % 32 != 0 || k < 1 || k > 48) return false;
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
  return true;
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
  const float* mg;  // device memory (n, n), f32
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

// acc = A (KT*16 x 16*ksteps, row-major bf16, lda) * B (16*ksteps x .,
// row-major bf16, ldb)[:, c0 : c0 + 16].
template <int KT>
__device__ __forceinline__ void mma_panel(float (&acc)[KT][2][4],
                                          const bf16* a_s, int lda,
                                          const bf16* b_s, int ldb,
                                          int ksteps, int c0, int lane) {
#pragma unroll
  for (int mt = 0; mt < KT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  const int lr = lane & 15, lc = (lane >> 4) * 8;
#pragma unroll 2
  for (int s = 0; s < ksteps; ++s) {
    uint32_t b[4];
    ldsm_x4_trans(b, b_s + (s * 16 + lr) * ldb + c0 + lc);
#pragma unroll
    for (int mt = 0; mt < KT; ++mt) {
      uint32_t a[4];
      ldsm_x4(a, a_s + (mt * 16 + lr) * lda + s * 16 + lc);
      mma_bf16(acc[mt][0], a, b[0], b[1]);
      mma_bf16(acc[mt][1], a, b[2], b[3]);
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
      float s = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        s = fmaf(q[mt][nt][2 * h], q[mt][nt][2 * h], s);
        s = fmaf(q[mt][nt][2 * h + 1], q[mt][nt][2 * h + 1], s);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (t == 0) x.redw[x.warp * x.kp + mt * 16 + h * 8 + g] = s;
    }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < KT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!live) break;
      const int row = mt * 16 + h * 8 + g;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kMaxWarps; ++w)   // unrolled: the loads overlap
        if (w < x.ne / 16) s += x.redw[w * x.kp + row];
      const float d = fmaxf(__fsqrt_rn(s), 1e-20f);
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
      mma_bf16(acc, a, b[0], b[1]);
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

// scal[0] = 1 / sqrt(max_a sum_b |G_ab|), floor 1e-20.
template <class X>
__device__ __forceinline__ void gershgorin(X& x) {
  if (x.warp == 0) {
    float best = 0.f;
    for (int a = x.lane; a < x.kp; a += 32) {
      float s = 0.f;
#pragma unroll 16
      for (int b = 0; b < x.kp; ++b)
        s = __fadd_rn(s, fabsf(x.gram[b * x.kp + a]));
      best = fmaxf(best, s);
    }
    for (int off = 16; off > 0; off >>= 1)
      best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, off));
    if (x.lane == 0) x.scal[0] = rsqrtf(fmaxf(best, 1e-20f));
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
  gershgorin(x);
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
      const float* src = x.mg + (size_t)p * kPanel * n + 4 * tc;
      cp_async16(dst + tr * n, src + tr * n);
      cp_async16(dst + (tr + 8) * n, src + (tr + 8) * n);
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
  gershgorin(x);
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
  x.mg = m + (size_t)blockIdx.x * n * n;
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
      const float4 v = __ldg(reinterpret_cast<const float4*>(x.mg) + idx);
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
// N > 128: shared memory allows one or two blocks, registers are free.
template <int KT>
int launch(const Plan& p, const void* m, const void* q0, void* out, int batch,
           int rounds, int orth_every, int ns_steps, int polish, int final_ns,
           int lo, cudaStream_t stream) {
  if (p.threads <= 256)
    return launch_as<KT, 256, 3>(p, m, q0, out, batch, rounds, orth_every,
                                 ns_steps, polish, final_ns, lo, stream);
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
  int off_ring, off_gram, off_glo, off_redw, off_redc, off_red;   // bytes
  int smem;
  int scratch;       // bytes of device scratch per graph
};

// Shapes: n a multiple of 32 in (256, 832], 1 <= k <= 48.
inline bool pe_big_plan(int n, int k, BigPlan* p) {
  if (n <= 256 || n > 832 || n % 32 != 0 || k < 1 || k > 48) return false;
  p->n = n; p->k = k;
  p->kp = (k + 15) / 16 * 16;
  p->kt = p->kp / 16;
  p->cluster = n <= 512 ? 2 : kMaxCluster;
  p->slabs = n / 16;
  p->spb = (p->slabs + p->cluster - 1) / p->cluster;
  p->ldq = n + 8;
  p->ldf = n + 4;
  p->ldp = 16 * p->spb;
  const int kk = p->kp * p->kp;
  // The two bf16 copies of Q^T; the f32 steps keep one f32 copy of Q^T
  // (kp, ldf) in the same bytes (never more: 4 (n + 4) <= 4 (n + 8)).
  int off = align16(2 * p->kp * p->ldq * 2);
  // The warps' rings of bf16 tiles; the f32 power steps' three panels of
  // f32 M take the same bytes, and between power steps the two partial
  // Gram matrices (2 kk f32 <= 18 KB).
  const int ring_bytes = kBigWarps * kRing * kTile;
  const int panel_bytes = kStages * kPanel * p->ldp * 4;
  p->off_ring = off;
  off += ring_bytes > panel_bytes ? ring_bytes : panel_bytes;
  p->off_gram = off; off += kk * 4;
  p->off_glo = off;  off += align16(p->kp * (p->kp + 8) * 2);
  p->off_redw = off; off += kBigWarps * p->kp * 4;
  p->off_redc = off; off += kMaxCluster * p->kp * 4;
  p->off_red = off;  off += p->kp * 4 + 16 + kMaxCluster * 4;
  p->smem = off;
  p->scratch = n * n * 2;
  return true;
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
  const float* mg;  // device memory (n, n), f32
  const unsigned char* mlo;   // device scratch: lo(M) in 512-byte tiles
  bf16* qlo0;       // two (kp, ldq) bf16 copies of Q^T, back to back
  float* qf;        // (kp, ldf) f32 copy of Q^T; qlo0's bytes
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
  __device__ __forceinline__ bf16* qlo(int which) const {
    return qlo0 + which * kp * ldq;
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
template <int KT>
__device__ __forceinline__ void big_store_lo(Big<KT>& x,
                                             const float (&q)[KT][2][4],
                                             bool all) {
  cg::cluster_group cl = cg::this_cluster();
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
      mma_bf16(q[mt][0], a, b[0], b[1]);
      mma_bf16(q[mt][1], a, b[2], b[3]);
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
      float s = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        s = fmaf(q[mt][nt][2 * h], q[mt][nt][2 * h], s);
        s = fmaf(q[mt][nt][2 * h + 1], q[mt][nt][2 * h + 1], s);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (t == 0) x.redw[x.warp * x.kp + mt * 16 + h * 8 + g] = s;
    }
  __syncthreads();
  float mine = 0.f;
  if (x.tid < x.kp)
    for (int w = 0; w < x.s1 - x.s0; ++w) mine += x.redw[w * x.kp + x.tid];
  big_norms(x, mine);
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
      mma_bf16(acc, a, b[0], b[1]);
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
  gershgorin(x);
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
      const float* src = x.mg + (size_t)p * kPanel * n + c0 + 4 * tc;
      cp_async16(dst + tr * ldp, src + tr * n);
      cp_async16(dst + (tr + 8) * ldp, src + (tr + 8) * n);
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
// holds it); ends with a cluster barrier. Every block must be done reading
// the columns that are overwritten: a cluster barrier comes first.
template <int KT>
__device__ __forceinline__ void big_put_f32(Big<KT>& x,
                                            const float (&acc)[2 * KT][4],
                                            bool others_only) {
  cg::cluster_group cl = cg::this_cluster();
  constexpr int R = 2 * KT;
  const int tc = x.tid & 63, tr = x.tid >> 6;
  const int col = 16 * x.s0 + 4 * tc;
  if (col < 16 * x.s1) {
    for (int r = 0; r < x.nblk; ++r) {
      if (others_only && r == x.rank) continue;
      float* dst = cl.map_shared_rank(x.qf, r);
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
  gershgorin(x);
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
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  constexpr int kp = 16 * KT;
  const int n = p.n, k = p.k;
  const int graph = blockIdx.x / p.cluster;
  Big<KT> x;
  x.n = n; x.ne = n; x.ldq = p.ldq; x.ldf = p.ldf; x.ldp = p.ldp;
  x.slabs = p.slabs;
  x.rank = (int)cl.block_rank(); x.nblk = p.cluster;
  unsigned char* mlo = scratch + (size_t)graph * p.scratch;
  x.mlo = mlo;
  x.mg = m + (size_t)graph * n * n;
  x.qlo0 = reinterpret_cast<bf16*>(smem_raw);
  x.qf = reinterpret_cast<float*>(smem_raw);
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
    const float4 v = __ldg(reinterpret_cast<const float4*>(x.mg) + idx);
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
    // warp's columns in every block's copy.
    if (x.warp_live()) {
      for (int r = 0; r < x.nblk; ++r) {
        float* dst = cl.map_shared_rank(x.qf, r);
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
    // Every block fills its own copy with all live columns.
    for (int idx = x.tid; idx < kp * x.ne; idx += kBigThreads) {
      const int r = idx / x.ne, c = idx - r * x.ne;
      x.qf[r * x.ldf + c] = (r < k) ? qg[c * k + r] : 0.f;
    }
    __syncthreads();
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
std::atomic<int> g_cluster_fits[kFitsDevices][832 / 32 + 1][4];

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

// ---- the wide plan: 48 < k <= 80, every N <= 832 -----------------------
//
// PE 64 iterates k = 64 columns on the train profile and 80 (64 + 16
// guards) on the eval profile and the giant finish. At those widths the
// two plans above do not fit: the shared plan's copies of Q^T pass a
// block's 227 KB above N = 160 at kp = 80 (and by 272 B at N = 256, kp =
// 64), and the streamed plan's two bf16 copies of Q^T alone take 268,800
// B at N = 832. The wide plan keeps Q^T in device memory instead, where
// the L1 and L2 caches serve it, and does every product on the CUDA cores
// as f32 FMAs on operands rounded to bf16 where the reference rounds them
// (a product of two bf16 values is exact in f32, so each sum is the plain
// version's arithmetic in another order). It is the simple kernel, right
// first; its time is in PERF.md.
//   * One block per graph up to N = 256 (256 threads); above, a cluster
//     of two blocks of 512 threads (a batch of 64 graphs then fills the
//     card's 132 SMs): the blocks split every product's items and every
//     write of Q, each keeps its own copy of G, and a cluster barrier
//     follows every write. Q is stored as (N, kp), row c holding column c
//     of Q^T, four copies in a device scratch: f32 and its bf16 rounding
//     (kept as f32), each double-buffered, so no step reads what it
//     writes.
//   * A thread computes one (CW columns, 16-row tile) item of a product at
//     a time: 16·CW accumulators, the tile's 16 values of one operand read
//     as four float4 (the same address across most of a warp: a
//     broadcast) for every CW values of the other. CW = 4 where the live
//     extent leaves every other thread an item, else 1 (small graphs need
//     the items more than the reuse). The power step streams M[j][c0..]
//     (coalesced over the column groups) and rounds it to bf16 where the
//     round does; the Newton-Schulz update reads lo(G) from shared memory
//     and rows c0.. of lo(Q) from the scratch. Each output's sum runs over
//     its depth in order, whatever CW.
//   * The Gram is 4 x 4 tiles of its upper triangle (136 at kp = 64, 210
//     at kp = 80), one a thread, mirrored, so G is symmetric bit for bit
//     and lo(G) is formed in place.
//   * Work follows the data: the live extent of M and q0 is found first,
//     and every loop runs over it only (skipped terms are exact zeros).

constexpr int kWideMaxN = 832;

struct WidePlan {
  int n, k, kp, kt, threads, smem;
  int cluster;         // blocks per graph
  int cw;              // columns an item (1 or 4)
  long long scratch;   // bytes per graph: 4 (N, kp) f32 copies of Q
};

// Shapes: n a multiple of 32 up to 832, 48 < k <= 80.
inline bool pe_wide_plan(int n, int k, WidePlan* p) {
  if (n < 32 || n > kWideMaxN || n % 32 != 0 || k <= 48 || k > 80)
    return false;
  p->n = n; p->k = k;
  p->kp = (k + 15) / 16 * 16;
  p->kt = p->kp / 16;
  p->threads = n <= 256 ? 256 : 512;
  p->cluster = n <= 256 ? 1 : 2;
  p->cw = n <= 128 ? 1 : 4;
  // G (kp x kp f32), the row norms, the Gershgorin scale and the extent.
  p->smem = p->kp * p->kp * 4 + p->kp * 4 + 16;
  p->scratch = 4LL * n * p->kp * 4;
  return true;
}

__device__ __forceinline__ float bf_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int KT>
struct Wide {
  static constexpr int kp = 16 * KT;
  int n, ne, tid, nthreads, warp, lane, nwarps;
  int rank, csize;                // this block's place in the graph's cluster
  const float* m;                 // this graph's M (n, n)
  float* qf[2];                   // f32 Q (n, kp), double-buffered
  float* ql[2];                   // lo(Q), the same
  int cur;
  float* gram;                    // (kp, kp)
  float* red;                     // kp
  float* scal;
  // This thread's first index and stride over work split by the cluster.
  __device__ int first() const { return rank * nthreads + tid; }
  __device__ int stride() const { return csize * nthreads; }
};

// Every write to the graph's Q (in device memory) is followed by this:
// a block barrier, or with a cluster of blocks a cluster barrier, whose
// release/acquire also orders the device-memory writes between blocks.
template <int KT>
__device__ __forceinline__ void wide_sync(const Wide<KT>& x) {
  if (x.csize > 1) cooperative_groups::this_cluster().sync();
  else __syncthreads();
}

// Writes item (columns c0..c0+CW-1, tile mt) of the next buffers.
template <int CW, int KT>
__device__ __forceinline__ void wide_store(Wide<KT>& x, int c0, int mt,
                                           const float (&acc)[CW][16]) {
#pragma unroll
  for (int u = 0; u < CW; ++u) {
    const int at = (c0 + u) * x.kp + mt * 16;
    float4* f = reinterpret_cast<float4*>(x.qf[x.cur ^ 1] + at);
    float4* l = reinterpret_cast<float4*>(x.ql[x.cur ^ 1] + at);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float* a = &acc[u][4 * v];
      f[v] = make_float4(a[0], a[1], a[2], a[3]);
      l[v] = make_float4(bf_round(a[0]), bf_round(a[1]), bf_round(a[2]),
                         bf_round(a[3]));
    }
  }
}

// acc[u][i] += a[i] * b[u]: 16 values of one operand (four float4, a
// broadcast across the warp) against CW of the other.
template <int CW>
__device__ __forceinline__ void fma_tile(float (&acc)[CW][16],
                                         const float* a, const float* b) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const float4 q = a4[v];
#pragma unroll
    for (int u = 0; u < CW; ++u) {
      acc[u][4 * v] = fmaf(q.x, b[u], acc[u][4 * v]);
      acc[u][4 * v + 1] = fmaf(q.y, b[u], acc[u][4 * v + 1]);
      acc[u][4 * v + 2] = fmaf(q.z, b[u], acc[u][4 * v + 2]);
      acc[u][4 * v + 3] = fmaf(q.w, b[u], acc[u][4 * v + 3]);
    }
  }
}

// Columns c0..c0+CW-1 of row j of M, rounded to bf16 when lo.
template <int CW>
__device__ __forceinline__ void load_m(const float* row, bool lo,
                                       float (&mv)[CW]) {
  if constexpr (CW == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row));
    mv[0] = v.x; mv[1] = v.y; mv[2] = v.z; mv[3] = v.w;
  } else {
    mv[0] = __ldg(row);
  }
  if (lo) {
#pragma unroll
    for (int u = 0; u < CW; ++u) mv[u] = bf_round(mv[u]);
  }
}

// Q^T <- A(Q^T) M, A = lo or f32, M rounded to bf16 when lo. An item is
// CW columns c0.. (CW = 4: one float4 of a row of M) by one 16-row tile.
template <int CW, int KT>
__device__ void wide_power(Wide<KT>& x, bool lo) {
  const float* a = lo ? x.ql[x.cur] : x.qf[x.cur];
  const int groups = x.ne / CW, items = groups * KT;
  for (int it = x.first(); it < items; it += x.stride()) {
    const int mt = it / groups, c0 = CW * (it - mt * groups);
    float acc[CW][16] = {};
    for (int j = 0; j < x.ne; ++j) {
      float mv[CW];
      load_m<CW>(x.m + (size_t)j * x.n + c0, lo, mv);
      fma_tile<CW>(acc, a + j * x.kp + mt * 16, mv);
    }
    wide_store<CW>(x, c0, mt, acc);
  }
  wide_sync(x);
  x.cur ^= 1;
}

// Rows of Q^T scaled to unit norm (floor 1e-20), in place. Every block
// of the cluster sums all of them; each scales its share.
template <int KT>
__device__ void wide_colunit(Wide<KT>& x) {
  float* q = x.qf[x.cur];
  float* l = x.ql[x.cur];
  for (int r = x.warp; r < x.kp; r += x.nwarps) {
    float s = 0.f;
    for (int c = x.lane; c < x.ne; c += 32)
      s = fmaf(q[c * x.kp + r], q[c * x.kp + r], s);
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (x.lane == 0) x.red[r] = fmaxf(__fsqrt_rn(s), 1e-20f);
  }
  wide_sync(x);   // every block has read Q before any block rewrites it
  for (int idx = x.first(); idx < x.ne * x.kp; idx += x.stride()) {
    const float v = __fdiv_rn(q[idx], x.red[idx % x.kp]);
    q[idx] = v;
    l[idx] = bf_round(v);
  }
  wide_sync(x);
}

// G = A(Q^T) A(Q^T)^T into shared memory (every block of the cluster),
// 4 x 4 tiles of the upper triangle mirrored into the lower.
template <int KT>
__device__ void wide_gram(Wide<KT>& x, bool lo) {
  constexpr int kq = 4 * KT, tiles = kq * (kq + 1) / 2;
  const float* q = lo ? x.ql[x.cur] : x.qf[x.cur];
  for (int tile = x.tid; tile < tiles; tile += x.nthreads) {
    int ta = 0, tb = tile;
    while (tb >= kq - ta) { tb -= kq - ta; ++ta; }
    tb += ta;
    float acc[4][4] = {};
    for (int c = 0; c < x.ne; ++c) {
      const float4 av =
          *reinterpret_cast<const float4*>(q + c * x.kp + 4 * ta);
      const float4 bv =
          *reinterpret_cast<const float4*>(q + c * x.kp + 4 * tb);
      const float a4[4] = {av.x, av.y, av.z, av.w};
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a4[i], b4[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int a = 4 * ta + i, b = 4 * tb + j;
        x.gram[a * x.kp + b] = acc[i][j];
        x.gram[b * x.kp + a] = acc[i][j];
      }
  }
  wide_sync(x);   // and every block has read Q before it is rewritten
}

// Newton-Schulz update Q^T <- 1.5 Q^T - 0.5 G A(Q^T) (G in shared memory,
// already A-rounded), the power step's items.
template <int CW, int KT>
__device__ void wide_update(Wide<KT>& x, bool lo) {
  const float* a = lo ? x.ql[x.cur] : x.qf[x.cur];
  const float* f = x.qf[x.cur];
  const int groups = x.ne / CW, items = groups * KT;
  for (int it = x.first(); it < items; it += x.stride()) {
    const int mt = it / groups, c0 = CW * (it - mt * groups);
    float acc[CW][16] = {};
    // G is symmetric bit for bit: row b of G is column b.
    for (int b = 0; b < x.kp; b += 4) {
      float4 qv[CW];
#pragma unroll
      for (int u = 0; u < CW; ++u)
        qv[u] = *reinterpret_cast<const float4*>(a + (c0 + u) * x.kp + b);
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        float col[CW];
#pragma unroll
        for (int u = 0; u < CW; ++u)
          col[u] = bb == 0 ? qv[u].x : bb == 1 ? qv[u].y
                 : bb == 2 ? qv[u].z : qv[u].w;
        fma_tile<CW>(acc, x.gram + (b + bb) * x.kp + mt * 16, col);
      }
    }
#pragma unroll
    for (int u = 0; u < CW; ++u) {
      const float* q = f + (c0 + u) * x.kp + mt * 16;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        acc[u][i] = __fsub_rn(__fmul_rn(1.5f, q[i]),
                              __fmul_rn(0.5f, acc[u][i]));
    }
    wide_store<CW>(x, c0, mt, acc);
  }
  wide_sync(x);
  x.cur ^= 1;
}

// Newton-Schulz: colunit, Gershgorin scale, `steps` updates
// Q^T <- 1.5 Q^T - 0.5 A(G) A(Q^T), A = lo or f32.
template <int CW, int KT>
__device__ void wide_ns(Wide<KT>& x, int steps, bool lo) {
  wide_colunit(x);
  wide_gram(x, lo);
  gershgorin(x);
  const float sc = x.scal[0];
  const float sc2 = __fmul_rn(sc, sc);
  float* q = x.qf[x.cur];
  float* l = x.ql[x.cur];
  for (int idx = x.first(); idx < x.ne * x.kp; idx += x.stride()) {
    const float v = __fmul_rn(q[idx], sc);
    q[idx] = v;
    l[idx] = bf_round(v);
  }
  for (int idx = x.tid; idx < x.kp * x.kp; idx += x.nthreads) {
    const float g = __fmul_rn(x.gram[idx], sc2);
    x.gram[idx] = lo ? bf_round(g) : g;
  }
  wide_sync(x);
  for (int s = 0; s < steps; ++s) {
    if (s) {
      wide_gram(x, lo);
      if (lo) {
        for (int idx = x.tid; idx < x.kp * x.kp; idx += x.nthreads)
          x.gram[idx] = bf_round(x.gram[idx]);
        __syncthreads();
      }
    }
    wide_update<CW>(x, lo);
  }
}

template <int KT, int MAXT, int CW>
__global__ void __launch_bounds__(MAXT)
pe_wide_kernel(const float* __restrict__ m,    // (B, n, n)
               const float* __restrict__ q0,   // (B, n, k)
               float* __restrict__ out,        // (B, n, k)
               float* __restrict__ scratch,    // (B, 4, n, kp)
               int n, int k, int csize, int rounds, int orth_every,
               int ns_steps, int polish, int final_ns, int lo) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Wide<KT> x;
  constexpr int kp = 16 * KT;
  const int graph = blockIdx.x / csize;
  x.n = n;
  x.tid = threadIdx.x; x.nthreads = blockDim.x;
  x.warp = threadIdx.x >> 5; x.lane = threadIdx.x & 31;
  x.nwarps = blockDim.x >> 5;
  x.rank = blockIdx.x - graph * csize; x.csize = csize;
  x.m = m + (size_t)graph * n * n;
  float* sb = scratch + (size_t)graph * 4 * n * kp;
  x.qf[0] = sb; x.qf[1] = sb + n * kp;
  x.ql[0] = sb + 2 * n * kp; x.ql[1] = sb + 3 * n * kp;
  x.cur = 0;
  x.gram = reinterpret_cast<float*>(smem_raw);
  x.red = x.gram + kp * kp;
  x.scal = x.red + kp;
  int* extent = reinterpret_cast<int*>(x.scal + 1);
  const float* qb = q0 + (size_t)graph * n * k;

  // extent: 1 + the last row or column of M or q0 with a non-zero (every
  // block of the cluster finds it).
  if (x.tid == 0) *extent = 0;
  __syncthreads();
  int ext = 0;
  const int nq = n / 4;
  for (int idx = x.tid; idx < n * nq; idx += x.nthreads) {
    const int j = idx / nq, c4 = idx - j * nq;
    const float4 v = __ldg(reinterpret_cast<const float4*>(x.m) + idx);
    if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)
      ext = max(ext, max(j + 1, 4 * c4 + 4));
  }
  for (int idx = x.tid; idx < n * k; idx += x.nthreads)
    if (qb[idx] != 0.f) ext = max(ext, idx / k + 1);
  ext = __reduce_max_sync(0xffffffffu, ext);
  if (x.lane == 0) atomicMax(extent, ext);
  __syncthreads();
  x.ne = min(n, (*extent + 3) / 4 * 4);   // whole float4 column groups
  // q0 into both copies of the current buffer; rows >= k are zero.
  for (int idx = x.first(); idx < x.ne * kp; idx += x.stride()) {
    const int c = idx / kp, r = idx - c * kp;
    const float v = r < k ? qb[c * k + r] : 0.f;
    x.qf[0][idx] = v;
    x.ql[0][idx] = bf_round(v);
  }
  wide_sync(x);

  for (int r = 0; r < rounds; ++r) {
    for (int s = 0; s < orth_every; ++s) wide_power<CW>(x, lo != 0);
    wide_ns<CW>(x, ns_steps, lo != 0);
  }
  for (int s = 0; s < polish; ++s) {
    wide_power<CW>(x, false);
    wide_colunit(x);
  }
  if (final_ns) wide_ns<CW>(x, final_ns, false);

  const float* q = x.qf[x.cur];
  float* ob = out + (size_t)graph * n * k;
  for (int idx = x.first(); idx < n * k; idx += x.stride()) {
    const int c = idx / k, r = idx - c * k;
    ob[idx] = c < x.ne ? q[c * kp + r] : 0.f;
  }
}

template <int KT, int MAXT, int CW>
int launch_wide_as(const WidePlan& p, const void* m, const void* q0,
                   void* out, void* scratch, int batch, int rounds,
                   int orth_every, int ns_steps, int polish, int final_ns,
                   int lo, cudaStream_t stream) {
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
      &cfg, pe_wide_kernel<KT, MAXT, CW>, (const float*)m, (const float*)q0,
      (float*)out, (float*)scratch, p.n, p.k, p.cluster, rounds, orth_every,
      ns_steps, polish, final_ns, lo);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// N <= 128: one column an item (small graphs need the items, and the
// registers stay low enough for three blocks an SM); above, four columns
// an item (each value of M and of the tile read once for four).
template <int KT>
int launch_wide(const WidePlan& p, const void* m, const void* q0, void* out,
                void* scratch, int batch, int rounds, int orth_every,
                int ns_steps, int polish, int final_ns, int lo,
                cudaStream_t stream) {
  if (p.cw == 1)
    return launch_wide_as<KT, 256, 1>(p, m, q0, out, scratch, batch, rounds,
                                      orth_every, ns_steps, polish, final_ns,
                                      lo, stream);
  if (p.threads <= 256)
    return launch_wide_as<KT, 256, 4>(p, m, q0, out, scratch, batch, rounds,
                                      orth_every, ns_steps, polish, final_ns,
                                      lo, stream);
  return launch_wide_as<KT, 512, 4>(p, m, q0, out, scratch, batch, rounds,
                                    orth_every, ns_steps, polish, final_ns,
                                    lo, stream);
}

}  // namespace

// plan[0..8] = threads, shared-memory bytes, kp, warps, depth split of the
// tensor-core Gram, depth split of the f32 Gram (1 and 1 under the streamed
// plan, which splits neither), blocks per graph (the cluster), most slabs
// of 16 columns a block takes, bytes of device scratch per graph. Returns
// 0, or non-zero for a shape the kernel does not take.
extern "C" int gcc_pe_plan(int n, int k, int* plan) {
  Plan p;
  BigPlan g;
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
  WidePlan w;
  if (pe_wide_plan(n, k, &w)) {
    plan[0] = w.threads; plan[1] = w.smem; plan[2] = w.kp;
    plan[3] = w.threads / 32; plan[4] = 1; plan[5] = 1;
    plan[6] = w.cluster; plan[7] = n / 16; plan[8] = (int)w.scratch;
    return 0;
  }
  return 1;
}

// scratch: (batch, plan[8]) bytes for n > 256 (the streamed plan: the
// bf16 copy of M per graph) and for k > 48 (the wide plan: four f32
// copies of Q), unused and may be null else.
extern "C" int gcc_pe_launch(const void* m, const void* q0, void* out,
                             void* scratch, int batch, int n, int k,
                             int iters, int orth_every, int ns_steps,
                             int polish, int final_ns, int lo, void* stream) {
  if (batch <= 0) return 0;
  if (orth_every <= 0 || ns_steps < 0 || polish < 0 || final_ns < 0)
    return (int)cudaErrorInvalidValue;
  const int rounds = max(1, iters / orth_every);
  cudaStream_t s = (cudaStream_t)stream;
  Plan p;
  BigPlan g;
  if (pe_plan(n, k, &p)) {
    switch (p.kt) {
      case 1:
        return launch<1>(p, m, q0, out, batch, rounds, orth_every, ns_steps,
                         polish, final_ns, lo, s);
      case 2:
        return launch<2>(p, m, q0, out, batch, rounds, orth_every, ns_steps,
                         polish, final_ns, lo, s);
      default:
        return launch<3>(p, m, q0, out, batch, rounds, orth_every, ns_steps,
                         polish, final_ns, lo, s);
    }
  }
  WidePlan w;
  if (pe_wide_plan(n, k, &w)) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    if (w.kt == 4)
      return launch_wide<4>(w, m, q0, out, scratch, batch, rounds,
                            orth_every, ns_steps, polish, final_ns, lo, s);
    return launch_wide<5>(w, m, q0, out, scratch, batch, rounds, orth_every,
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
    default:
      return launch_big<3>(g, m, q0, out, scratch, batch, rounds, orth_every,
                           ns_steps, polish, final_ns, lo, s);
  }
}
