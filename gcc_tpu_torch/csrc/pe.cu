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
// plan at the end of this file (pe_big_kernel): the same steps in the same
// order, M streamed from device memory for every power step and Q^T kept
// in a device scratch that stays in the L2 cache.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// One block of 512 threads per graph. Nothing of size N^2 or k*N lives in
// shared memory:
//   * Q^T (kp, N) f32 lives in a device scratch, two buffers per graph
//     (every step reads one and writes the other; 160 KB each at k = 48,
//     N = 832, so a batch of 64 stays in the L2 cache). Threads of the
//     block see each other's writes to it after __syncthreads().
//   * M streams from device memory once per power step, in chunks of 32
//     rows x 256 columns that are staged through shared memory beside the
//     matching 32 columns of Q^T; the next chunk's loads are in flight in
//     registers while the block multiplies the current one.
//   * Every product runs on the CUDA cores in f32. For the rounds both
//     operands are rounded to bf16 where they are staged or loaded; a
//     product of two bf16 values is exact in f32, so the f32 FMAs give the
//     bf16-input, f32-sum product of the plain version. M is read as
//     M[j][c], as above.
//   * A thread owns 4 columns x kp/8 rows of the output (rows tr + 8i), a
//     pass covers 256 columns, and the Gram is 4x4 tiles of the upper
//     triangle, one warp a tile with the lanes along the depth, summed by
//     shuffle and mirrored (so G is symmetric bit for bit).
//   * Work follows the data here too: the block finds the extent of the
//     non-zeros of M and Q^T, rounds it up to 32, and runs every loop over
//     the live rows and columns only.
// This plan is bound by the CUDA cores' f32 rate and by one block per
// graph (a batch of 64 fills half the card); it is the simple version.

constexpr int kBigThreads = 512;
constexpr int kBigWarps = kBigThreads / 32;
constexpr int kBigCols = 256;             // columns a pass covers: 64 x 4
constexpr int kBigDepth = 32;             // rows of M in a staged chunk
constexpr int kBigLda = kBigDepth + 4;    // row stride of the staged Q^T

struct BigPlan {
  int n, k, kp, kt;
  int off_a, off_b, off_gram, off_red;   // bytes
  int smem;
};

// Shapes: n a multiple of 32 in (256, 832], 1 <= k <= 48.
inline bool pe_big_plan(int n, int k, BigPlan* p) {
  if (n <= 256 || n > 832 || n % 32 != 0 || k < 1 || k > 48) return false;
  p->n = n; p->k = k;
  p->kp = (k + 15) / 16 * 16;
  p->kt = p->kp / 16;
  int off = 0;
  p->off_a = off;    off += p->kp * kBigLda * 4;
  p->off_b = off;    off += kBigDepth * kBigCols * 4;
  p->off_gram = off; off += p->kp * p->kp * 4;
  p->off_red = off;  off += p->kp * 4 + 16;
  p->smem = off;
  return true;
}

template <bool LO>
__device__ __forceinline__ float rnd(float v) {
  return LO ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <bool LO>
__device__ __forceinline__ float4 rnd4(float4 v) {
  return make_float4(rnd<LO>(v.x), rnd<LO>(v.y), rnd<LO>(v.z), rnd<LO>(v.w));
}

template <int KT>
struct Big {
  static constexpr int kp = 16 * KT;
  int n;            // padded nodes
  int ne;           // live nodes, a multiple of 32
  float* qa;        // device scratch (kp, n): the current Q^T
  float* qb;        // the buffer the next step writes
  const float* mg;  // device memory (n, n), f32
  float* as;        // (kp, kBigLda) staged columns of Q^T
  float* bs;        // (kBigDepth, kBigCols) staged rows of M
  float* gram;      // (kp, kp)
  float* red;       // (kp)
  float* scal;      // (1)
  int tid, warp, lane;
};

// Q^T <- lo(Q^T) lo(M), or the f32 product when LO is false.
template <int KT, bool LO>
__device__ void big_power(Big<KT>& x) {
  constexpr int R = 2 * KT;
  const int n = x.n, ne = x.ne;
  const int tc = x.tid & 63, tr = x.tid >> 6;
  const int chunks = ne / kBigDepth;
  for (int c0 = 0; c0 < ne; c0 += kBigCols) {
    const int col = c0 + 4 * tc;
    const bool live = col < ne;
    float acc[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][u] = 0.f;
    float a_reg[KT];
    float4 b_reg[4];
    // Chunk ch into registers: 32 columns of Q^T (kp x 32 values, KT a
    // thread) and 32 rows x 256 columns of M (four float4 a thread).
    auto fetch = [&](int ch) {
      const int j0 = ch * kBigDepth;
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        const int idx = x.tid + t * kBigThreads;
        a_reg[t] = x.qa[(idx >> 5) * n + j0 + (idx & 31)];
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int idx = x.tid + t * kBigThreads;
        const int row = idx >> 6, cc = c0 + 4 * (idx & 63);
        b_reg[t] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (cc < ne)
          b_reg[t] = *reinterpret_cast<const float4*>(
              x.mg + (size_t)(j0 + row) * n + cc);
      }
    };
    fetch(0);
    for (int ch = 0; ch < chunks; ++ch) {
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        const int idx = x.tid + t * kBigThreads;
        x.as[(idx >> 5) * kBigLda + (idx & 31)] = rnd<LO>(a_reg[t]);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int idx = x.tid + t * kBigThreads;
        *reinterpret_cast<float4*>(
            x.bs + (idx >> 6) * kBigCols + 4 * (idx & 63)) =
            rnd4<LO>(b_reg[t]);
      }
      __syncthreads();
      if (ch + 1 < chunks) fetch(ch + 1);
      if (live) {
#pragma unroll 2
        for (int j = 0; j < kBigDepth; j += 4) {
          float4 mv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            mv[u] = *reinterpret_cast<const float4*>(
                x.bs + (j + u) * kBigCols + 4 * tc);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const float4 q = *reinterpret_cast<const float4*>(
                x.as + (tr + 8 * i) * kBigLda + j);
            fma_1x4x4(acc[i], q, mv);
          }
        }
      }
      __syncthreads();
    }
    if (live) {
#pragma unroll
      for (int i = 0; i < R; ++i)
        *reinterpret_cast<float4*>(x.qb + (tr + 8 * i) * n + col) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
  __syncthreads();
  float* other = x.qa; x.qa = x.qb; x.qb = other;
}

// Rows of Q^T scaled to unit norm (floor 1e-20), in place.
template <int KT>
__device__ void big_colunit(Big<KT>& x) {
  constexpr int kp = 16 * KT;
  const int n = x.n, ne4 = x.ne / 4;
  for (int r = x.warp; r < kp; r += kBigWarps) {
    float s = 0.f;
    for (int c = x.lane; c < ne4; c += 32) {
      const float4 v = *reinterpret_cast<const float4*>(x.qa + r * n + 4 * c);
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
  for (int idx = x.tid; idx < kp * ne4; idx += kBigThreads) {
    const int r = idx / ne4, c = idx - r * ne4;
    float4* p = reinterpret_cast<float4*>(x.qa + r * n + 4 * c);
    const float d = x.red[r];
    float4 q = *p;
    q.x = __fdiv_rn(q.x, d);
    q.y = __fdiv_rn(q.y, d);
    q.z = __fdiv_rn(q.z, d);
    q.w = __fdiv_rn(q.w, d);
    *p = q;
  }
  __syncthreads();
}

// G = lo(Q^T) lo(Q^T)^T (f32 when LO is false) into x.gram; with
// `rounded` the stored values are lo(G), which is all the NS update reads.
template <int KT, bool LO>
__device__ void big_gram(Big<KT>& x, bool rounded) {
  constexpr int kp = 16 * KT, kq = kp / 4, tiles = kq * (kq + 1) / 2;
  const int n = x.n, ne4 = x.ne / 4;
  for (int tile = x.warp; tile < tiles; tile += kBigWarps) {
    int ta = 0, tb = tile;
    while (tb >= kq - ta) { tb -= kq - ta; ++ta; }
    tb += ta;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int d = x.lane; d < ne4; d += 32) {
      float4 av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = rnd4<LO>(*reinterpret_cast<const float4*>(
            x.qa + (ta + kq * i) * n + 4 * d));
        bv[i] = rnd4<LO>(*reinterpret_cast<const float4*>(
            x.qa + (tb + kq * i) * n + 4 * d));
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
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (x.lane == 4 * i + j) {   // every lane holds the sum
          if (rounded) v = rnd<LO>(v);
          const int a = ta + kq * i, b = tb + kq * j;
          x.gram[a * kp + b] = v;
          if (ta != tb) x.gram[b * kp + a] = v;
        }
      }
  }
  __syncthreads();
}

// Newton-Schulz on Q^T in the scratch: bf16-input products when LO.
template <int KT, bool LO>
__device__ void big_ns(Big<KT>& x, int steps) {
  constexpr int R = 2 * KT, kp = 16 * KT;
  const int n = x.n, ne = x.ne, ne4 = ne / 4;
  const int tc = x.tid & 63, tr = x.tid >> 6;
  big_colunit(x);
  big_gram<KT, LO>(x, false);
  gershgorin(x);
  const float sc = x.scal[0];
  const float sc2 = __fmul_rn(sc, sc);
  for (int idx = x.tid; idx < kp * ne4; idx += kBigThreads) {
    const int r = idx / ne4, c = idx - r * ne4;
    float4* p = reinterpret_cast<float4*>(x.qa + r * n + 4 * c);
    float4 q = *p;
    q.x = __fmul_rn(q.x, sc);
    q.y = __fmul_rn(q.y, sc);
    q.z = __fmul_rn(q.z, sc);
    q.w = __fmul_rn(q.w, sc);
    *p = q;
  }
  for (int idx = x.tid; idx < kp * kp; idx += kBigThreads)
    x.gram[idx] = rnd<LO>(__fmul_rn(x.gram[idx], sc2));
  __syncthreads();
  for (int it = 0; it < steps; ++it) {
    if (it) big_gram<KT, LO>(x, true);
    for (int c0 = 0; c0 < ne; c0 += kBigCols) {
      const int col = c0 + 4 * tc;
      if (col >= ne) continue;
      float acc[R][4];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[i][u] = 0.f;
#pragma unroll 2
      for (int b = 0; b < kp; b += 4) {
        float4 qv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          qv[u] = rnd4<LO>(*reinterpret_cast<const float4*>(
              x.qa + (b + u) * n + col));
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float4 g = *reinterpret_cast<const float4*>(
              x.gram + (tr + 8 * i) * kp + b);
          fma_1x4x4(acc[i], g, qv);
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int at = (tr + 8 * i) * n + col;
        float4 q = *reinterpret_cast<const float4*>(x.qa + at);
        q.x = __fsub_rn(__fmul_rn(1.5f, q.x), __fmul_rn(0.5f, acc[i][0]));
        q.y = __fsub_rn(__fmul_rn(1.5f, q.y), __fmul_rn(0.5f, acc[i][1]));
        q.z = __fsub_rn(__fmul_rn(1.5f, q.z), __fmul_rn(0.5f, acc[i][2]));
        q.w = __fsub_rn(__fmul_rn(1.5f, q.w), __fmul_rn(0.5f, acc[i][3]));
        *reinterpret_cast<float4*>(x.qb + at) = q;
      }
    }
    __syncthreads();
    float* other = x.qa; x.qa = x.qb; x.qb = other;
  }
}

template <int KT>
__global__ void __launch_bounds__(kBigThreads, 1)
pe_big_kernel(const float* __restrict__ m,    // (B, n, n)
              const float* __restrict__ q0,   // (B, n, k)
              float* __restrict__ out,        // (B, n, k)
              float* scratch,                 // (B, 2, kp, n)
              BigPlan p, int rounds, int orth_every, int ns_steps, int polish,
              int final_ns, int lo) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kp = 16 * KT;
  const int n = p.n, k = p.k;
  Big<KT> x;
  x.n = n; x.ne = n;
  x.qa = scratch + (size_t)blockIdx.x * 2 * kp * n;
  x.qb = x.qa + kp * n;
  x.mg = m + (size_t)blockIdx.x * n * n;
  x.as = reinterpret_cast<float*>(smem_raw + p.off_a);
  x.bs = reinterpret_cast<float*>(smem_raw + p.off_b);
  x.gram = reinterpret_cast<float*>(smem_raw + p.off_gram);
  x.red = reinterpret_cast<float*>(smem_raw + p.off_red);
  x.scal = x.red + kp;
  x.tid = threadIdx.x; x.warp = threadIdx.x >> 5; x.lane = threadIdx.x & 31;
  const float* qg = q0 + (size_t)blockIdx.x * n * k;

  // extent: 1 + the last row or column of M or Q^T with a non-zero.
  int* extent = reinterpret_cast<int*>(x.scal + 1);
  if (x.tid == 0) *extent = 0;
  __syncthreads();
  int ext = 0;
  const int nq = n / 4;
  for (int idx = x.tid; idx < n * nq; idx += kBigThreads) {
    const int j = idx / nq, c4 = idx - j * nq;
    const float4 v = __ldg(reinterpret_cast<const float4*>(x.mg) + idx);
    if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)
      ext = max(ext, max(j + 1, 4 * c4 + 4));
  }
  // Q^T from q0 (rows >= k stay zero); the other buffer starts as zeros,
  // so the columns past the extent, which no step writes, read as zero
  // from whichever buffer holds the result.
  for (int idx = x.tid; idx < kp * n; idx += kBigThreads) {
    const int r = idx / n, c = idx - r * n;
    const float v = (r < k) ? qg[c * k + r] : 0.f;
    if (v != 0.f) ext = max(ext, c + 1);
    x.qa[idx] = v;
    x.qb[idx] = 0.f;
  }
  ext = __reduce_max_sync(0xffffffffu, ext);
  if (x.lane == 0) atomicMax(extent, ext);
  __syncthreads();
  x.ne = min(n, max(32, (*extent + 31) / 32 * 32));

  for (int r = 0; r < rounds; ++r) {
    for (int s = 0; s < orth_every; ++s) {
      if (lo) big_power<KT, true>(x);
      else big_power<KT, false>(x);
    }
    if (lo) big_ns<KT, true>(x, ns_steps);
    else big_ns<KT, false>(x, ns_steps);
  }
  for (int s = 0; s < polish; ++s) {
    big_power<KT, false>(x);
    big_colunit(x);
  }
  if (final_ns) big_ns<KT, false>(x, final_ns);

  float* ob = out + (size_t)blockIdx.x * n * k;
  for (int idx = x.tid; idx < n * k; idx += kBigThreads) {
    const int c = idx / k, r = idx - c * k;
    ob[idx] = x.qa[r * n + c];
  }
}

template <int KT>
int launch_big(const BigPlan& p, const void* m, const void* q0, void* out,
               void* scratch, int batch, int rounds, int orth_every,
               int ns_steps, int polish, int final_ns, int lo,
               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      pe_big_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  pe_big_kernel<KT><<<batch, kBigThreads, p.smem, stream>>>(
      (const float*)m, (const float*)q0, (float*)out, (float*)scratch, p,
      rounds, orth_every, ns_steps, polish, final_ns, lo);
  return (int)cudaGetLastError();
}

}  // namespace

// plan[0..5] = threads, shared-memory bytes, kp, warps, depth split of the
// tensor-core Gram, depth split of the f32 Gram (1 and 1 under the streamed
// plan, which has neither). Returns 0, or non-zero for a shape the kernel
// does not take.
extern "C" int gcc_pe_plan(int n, int k, int* plan) {
  Plan p;
  BigPlan g;
  if (pe_plan(n, k, &p)) {
    plan[0] = p.threads; plan[1] = p.smem; plan[2] = p.kp; plan[3] = p.warps;
    plan[4] = p.ks; plan[5] = p.chunks;
    return 0;
  }
  if (pe_big_plan(n, k, &g)) {
    plan[0] = kBigThreads; plan[1] = g.smem; plan[2] = g.kp;
    plan[3] = kBigWarps; plan[4] = 1; plan[5] = 1;
    return 0;
  }
  return 1;
}

// scratch: (batch, 2, kp, n) f32 for n > 256 (the streamed plan), unused
// and may be null else.
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
