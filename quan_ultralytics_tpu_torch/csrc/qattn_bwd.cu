// Per-component attention, backward: dQ, dK, dV of O = softmax(scale * Q K^T) V for each
// group g, given dO. The softmax is recomputed; no N x N residual is stored.
//
// Replaces the TPU kernel quan_ultralytics_tpu/ops/pallas/qattn.py:_attn_bwd_kernel
// (the custom VJP _attn_bwd of _attn).
//
// It computes what the TPU kernel computes, at the same rounding points (T is the input
// dtype; "round_T" rounds an f32 value to T):
//   q2 = round_T(q * round_T(scale log2e)),  ks = round_T(k * round_T(scale))
//   E  = exp2(q2 k^T - m)  (f32),            m = rowmax, r = 1 / rowsum(E)
//   dor = round_T(dO * r),                   dV = round_T(E_b^T dor), E_b = round_T(E)
//   dP = dO V^T (f32),  rse = rowsum(dP o E),  U = round_T(E o (dP - r rse))
//   dQ = round_T(r o (U ks)),                dK = round_T(U^T round_T(q2 o (r ln2)))
// m and r come from the forward (csrc/qattn_fwd.cu writes them when a backward will
// follow): the same dot in the same order, so the values the TPU kernel's VJP recomputes.
//
// What bounds it on an H100: at the main path's shapes (N = 1024, dk = 2, dv = 4, G = 32
// groups per image) a group moves N (3 dk + 3 dv) elements, but each of the N^2 scores
// needs exp2 and a few dozen multiply-adds: it is bound by the special-function units
// (one exp2 a score and a pass, 16 lanes an SM) and by the issue of the per-score f32
// work, not by memory.
//
// bf16 (tensor cores, two exp2 a score):
//  (a) qattn_bwd_rse: a pre-pass over the keys (staged 1024 at a time at the main
//      path's widths) per block of 128 query rows, 16 rows a warp. S = q2 k^T and
//      dP = dO V^T run as mma.m16n8k8 (dk and dv zero-padded to 8); each thread sums
//      dP o exp2(S - m) in f32 for its two rows, then the quad reduces.
//      It writes c = r rse to a [G, N] f32 buffer. rse is the exact f32 row sum: taking it
//      from the rounded output O instead would move U and miss the tolerance.
//  (b) qattn_bwd_keys: one block per (group, 128 keys), 16 keys a warp, over all query
//      rows in tiles of up to 128 (1024 / dk) staged in shared memory. Per 16 x 16 block of
//      scores it computes S^T = k q2^T and dP^T = v dO^T (m16n8k8), E and U in registers,
//      and turns the f32 accumulators into the bf16 A fragments of the next products
//      without shared memory (as FlashAttention-2 does): dV += E_b^T dor and dK += U^T qr
//      (m16n8k16, kept in registers for the block's life), and dQ = U ks, whose A fragment
//      is U^T's transposed by movmatrix. dQ is summed over the block's eight warps in
//      shared memory in a fixed order and written as one f32 partial per (key block,
//      row): no atomics, so repeated runs give the same dQ.
//  (c) qattn_bwd_dq: dQ = round_T(r o sum of the partials), in key-block order.
//  Every operand is already bf16 at the TPU kernel's rounding points and bf16 products
//  are exact in f32, so only the order of the f32 sums changes. A score's products may
//  be summed in another order on the tensor cores than in the forward, which moves
//  S - m by a few f32 ulps (E may slightly exceed 1); qattn.BWD_TOL covers that.
//  exp2 is ex2.approx.ftz; values below 2^-126 flush to zero.
//
// f32 (CUDA cores; TF32 products would miss the f32 tolerance), three exp2 a score:
//  (a) qattn_bwd_rows: one thread per query row, keys and values staged through shared
//      memory as broadcasts. Pass 1 sums dP o E for rse; pass 2 recomputes E, forms U
//      and accumulates U ks for dQ. It writes rse to a [G, N] f32 buffer.
//  (b) qattn_bwd_cols: one thread per key row, query rows (q2, round_T(q2 r ln2), dO,
//      dor and the row's m, r, rse) staged through shared memory. It recomputes E and U
//      for its column and accumulates dK and dV.
//  Both compute a score, E and dP with the same device functions in the same order, so
//  they see bitwise the same E and U.
// Keys and query rows >= N are outside the loop bounds or masked, so any N works
// without padding.
#include <math_constants.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr float kLn2 = 0.693147180559945309f;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------- bf16, tensor cores

constexpr int kWarps = 8;                  // warps per block of (a) and (b)
constexpr int kRows = 16 * kWarps;         // query rows per block of (a), keys per block of (b)
constexpr int kKeyBytes = 12288;           // bytes of keys and values per staged tile of (a)
constexpr int kQueryTile = 128;            // query rows per staged tile of (b), at most
constexpr int kUnroll = 4;                 // 16-row query blocks of (b) unrolled
constexpr int kRseUnroll = 1;              // 8-key steps of (a) unrolled (2: slower)

// element (row, d) of an [n, D] bf16 matrix in device memory as f32; zero outside it
__device__ __forceinline__ float elem(const bf16* base, int row, int d, int D, int n) {
  return (row < n && d < D) ? __bfloat162float(base[static_cast<size_t>(row) * D + d]) : 0.f;
}

// rows [0, rows) of an [.., D] bf16 matrix into shared memory rows of width DS (D
// rounded up to even) for `tile` rows; the rest of the tile, and column D if D is odd,
// zero. Even D: the rows are one contiguous run of 32-bit words.
template <int D, int DS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int rows, int tile) {
  if (D == DS) {
    uint32_t* d32 = reinterpret_cast<uint32_t*>(dst);
    const uint32_t* s32 = reinterpret_cast<const uint32_t*>(src);
    for (int i = threadIdx.x; i < tile * D / 2; i += blockDim.x) d32[i] = i < rows * D / 2 ? s32[i] : 0u;
  } else {
    for (int i = threadIdx.x; i < tile * DS; i += blockDim.x) {
      const int j = i / DS, d = i % DS;
      dst[i] = j < rows && d < D ? src[j * D + d] : __float2bfloat16_rn(0.f);
    }
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(32 * kWarps)
qattn_bwd_rse(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const bf16* __restrict__ dout, const float* __restrict__ stats,
              float* __restrict__ cbuf, int n, int g_total, int tiles, float scale_log2e) {
  constexpr int NKC = (DK + 7) / 8, NVC = (DV + 7) / 8;
  constexpr int DKS = (DK + 1) & ~1, DVS = (DV + 1) & ~1;  // staged row widths (even)
  // keys a staged tile: about kKeyBytes, a multiple of 128, at least 128
  constexpr int kFit = kKeyBytes / (2 * (DKS + DVS)) / 128 * 128;
  constexpr int kKeyTile = kFit > 128 ? kFit : 128;
  __shared__ __align__(16) bf16 ks[kKeyTile][DKS];
  __shared__ __align__(16) bf16 vs[kKeyTile][DVS];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int grp = blockIdx.x / tiles;
  const int r0 = (blockIdx.x % tiles) * kRows + 16 * warp;  // this warp's first row
  const bf16* qg = q + static_cast<size_t>(grp) * n * DK;
  const bf16* kg = k + static_cast<size_t>(grp) * n * DK;
  const bf16* vg = v + static_cast<size_t>(grp) * n * DV;
  const bf16* dog = dout + static_cast<size_t>(grp) * n * DV;
  const float c2 = quan::round_to<bf16>(scale_log2e);

  // A fragments of q2 and dO for rows r0 + g, r0 + g + 8
  uint32_t qa[NKC][2], da[NVC][2];
#pragma unroll
  for (int c = 0; c < NKC; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + g + 8 * h, d = 8 * c + 2 * t;
      qa[c][h] = quan::pack_bf16(quan::round_to<bf16>(elem(qg, row, d, DK, n) * c2),
                                 quan::round_to<bf16>(elem(qg, row, d + 1, DK, n) * c2));
    }
#pragma unroll
  for (int c = 0; c < NVC; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + g + 8 * h, d = 8 * c + 2 * t;
      da[c][h] = quan::pack_bf16(elem(dog, row, d, DV, n), elem(dog, row, d + 1, DV, n));
    }
  const size_t srow = static_cast<size_t>(grp) * n;
  const size_t plane = static_cast<size_t>(g_total) * n;
  float mrow[2], rse[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    mrow[h] = row < n ? stats[srow + row] : 0.f;
  }

  for (int t0 = 0; t0 < n; t0 += kKeyTile) {
    const int nt_end = min(kKeyTile, n - t0);
    __syncthreads();
    stage_rows<DK, DKS>(&ks[0][0], kg + static_cast<size_t>(t0) * DK, nt_end, kKeyTile);
    stage_rows<DV, DVS>(&vs[0][0], vg + static_cast<size_t>(t0) * DV, nt_end, kKeyTile);
    __syncthreads();
    const bool ragged = nt_end < kKeyTile;
#pragma unroll kRseUnroll
    for (int j0 = 0; j0 < nt_end; j0 += 8) {
      float s[4] = {0.f, 0.f, 0.f, 0.f}, p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < NKC; ++c) {
        const int d = 8 * c + 2 * t;
        const uint32_t b = d < DK ? quan::lds32(&ks[j0 + g][d]) : 0u;
        quan::mma_1688(s, qa[c][0], qa[c][1], b);
      }
#pragma unroll
      for (int c = 0; c < NVC; ++c) {
        const int d = 8 * c + 2 * t;
        const uint32_t b = d < DV ? quan::lds32(&vs[j0 + g][d]) : 0u;
        quan::mma_1688(p, da[c][0], da[c][1], b);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float x = s[e] - mrow[h];
        if (ragged && j0 + 2 * t + (e & 1) >= nt_end) x = -CUDART_INF_F;
        rse[h] = fmaf(p[e], quan::exp2_approx(x), rse[h]);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rse[h] += __shfl_xor_sync(0xffffffffu, rse[h], 1);
    rse[h] += __shfl_xor_sync(0xffffffffu, rse[h], 2);
    const int row = r0 + g + 8 * h;
    if (t == 0 && row < n) cbuf[srow + row] = stats[plane + srow + row] * rse[h];
  }
}

template <int DK, int DV>
struct KeysTile {
  static constexpr int BQ = kQueryTile < 1024 / DK ? kQueryTile : 1024 / DK;  // query rows a tile
  static constexpr int NDK = (DK + 7) / 8, NDV = (DV + 7) / 8;
  static constexpr int DKS = (DK + 1) & ~1, DVS = (DV + 1) & ~1;
  static constexpr int TP = BQ + 8;                     // pitch of the transposed tiles
};

template <int DK, int DV>
__global__ void __launch_bounds__(32 * kWarps)
qattn_bwd_keys(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               const bf16* __restrict__ dout, const float* __restrict__ stats,
               const float* __restrict__ cbuf, float* __restrict__ dq_part, bf16* __restrict__ dk,
               bf16* __restrict__ dv, int n, int g_total, int kblocks, float scale,
               float scale_log2e) {
  using L = KeysTile<DK, DV>;
  constexpr int BQ = L::BQ, NDK = L::NDK, NDV = L::NDV, DKS = L::DKS, DVS = L::DVS, TP = L::TP;
  __shared__ __align__(16) bf16 q2s[BQ][DKS];        // q2, B operand of S^T = k q2^T
  __shared__ __align__(16) bf16 dos[BQ][DVS];        // dO, B operand of dP^T = v dO^T
  __shared__ __align__(16) bf16 dorT[8 * NDV][TP];   // dor^T, B operand of dV += E_b^T dor
  __shared__ __align__(16) bf16 qrT[8 * NDK][TP];    // qr^T, B operand of dK += U^T qr
  __shared__ __align__(16) float ms[BQ], cs[BQ];     // m and c = r rse per row
  __shared__ float dqp[kWarps][BQ][DK];               // each warp's dQ of the tile

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int grp = blockIdx.x / kblocks, kb = blockIdx.x % kblocks;
  const int j0 = kb * kRows + 16 * warp;  // this warp's first key
  const size_t kbase = static_cast<size_t>(grp) * n * DK;
  const size_t vbase = static_cast<size_t>(grp) * n * DV;
  const bf16* kg = k + kbase;
  const bf16* vg = v + vbase;
  const size_t srow = static_cast<size_t>(grp) * n;
  const size_t plane = static_cast<size_t>(g_total) * n;
  const float c2 = quan::round_to<bf16>(scale_log2e);
  const float csc = quan::round_to<bf16>(scale);

  // the rows d >= dk, dv of the transposed tiles are never staged: zero
  for (int i = threadIdx.x; i < (8 * NDV - DV) * TP; i += blockDim.x)
    (&dorT[DV][0])[i] = __float2bfloat16_rn(0.f);
  for (int i = threadIdx.x; i < (8 * NDK - DK) * TP; i += blockDim.x)
    (&qrT[DK][0])[i] = __float2bfloat16_rn(0.f);

  // warp-constant fragments: k and v as A (rows = keys), ks as B of dQ = U ks
  uint32_t ka[NDK][2], va[NDV][2], kb0[NDK], kb1[NDK];
#pragma unroll
  for (int c = 0; c < NDK; ++c) {
    const int d = 8 * c + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = j0 + g + 8 * h;
      ka[c][h] = quan::pack_bf16(elem(kg, row, d, DK, n), elem(kg, row, d + 1, DK, n));
    }
    const int dd = 8 * c + g;  // column of ks this lane holds
    auto ksv = [&](int row) { return quan::round_to<bf16>(elem(kg, row, dd, DK, n) * csc); };
    kb0[c] = quan::pack_bf16(ksv(j0 + 2 * t), ksv(j0 + 2 * t + 1));
    kb1[c] = quan::pack_bf16(ksv(j0 + 2 * t + 8), ksv(j0 + 2 * t + 9));
  }
#pragma unroll
  for (int c = 0; c < NDV; ++c) {
    const int d = 8 * c + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = j0 + g + 8 * h;
      va[c][h] = quan::pack_bf16(elem(vg, row, d, DV, n), elem(vg, row, d + 1, DV, n));
    }
  }
  float acc_k[NDK][4], acc_v[NDV][4];
#pragma unroll
  for (int c = 0; c < NDK; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[c][e] = 0.f;
#pragma unroll
  for (int c = 0; c < NDV; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_v[c][e] = 0.f;

  const bool key_ragged = j0 + 16 > n;
  float* part = dq_part + (static_cast<size_t>(kb) * g_total + grp) * n * DK;

  // the previous tile's dQ, summed over the warps in a fixed order
  auto reduce = [&](int i0) {
    for (int i = threadIdx.x; i < BQ * DK; i += blockDim.x) {
      const int row = i / DK, d = i % DK;
      if (i0 + row >= n) continue;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += dqp[w][row][d];
      part[static_cast<size_t>(i0 + row) * DK + d] = s;
    }
  };

  for (int i0 = 0; i0 < n; i0 += BQ) {
    // stage the query rows of this tile (rows >= n: zeros), then finish the previous tile
    for (int row = threadIdx.x; row < BQ; row += blockDim.x) {
      const int gi = i0 + row;
      const bool ok = gi < n;
      const float m = ok ? stats[srow + gi] : 0.f;
      const float r = ok ? stats[plane + srow + gi] : 0.f;
      ms[row] = m;
      cs[row] = ok ? cbuf[srow + gi] : 0.f;
      const float rl = r * kLn2;
#pragma unroll
      for (int d = 0; d < DKS; ++d) {
        const float x = quan::round_to<bf16>(elem(q + kbase, gi, d, DK, n) * c2);
        q2s[row][d] = __float2bfloat16_rn(x);
        if (d < DK) qrT[d][row] = __float2bfloat16_rn(x * rl);
      }
#pragma unroll
      for (int d = 0; d < DVS; ++d) {
        const float x = elem(dout + vbase, gi, d, DV, n);
        dos[row][d] = __float2bfloat16_rn(x);
        if (d < DV) dorT[d][row] = __float2bfloat16_rn(x * r);
      }
    }
    if (i0 > 0) reduce(i0 - BQ);
    __syncthreads();

    const bool ragged = key_ragged || i0 + BQ > n;
#pragma unroll kUnroll
    for (int b = 0; b < BQ; b += 16) {
      float s[2][4], p[2][4];
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        const int col = b + 8 * nn + g;  // query row this lane reads for the B fragments
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nn][e] = p[nn][e] = 0.f;
#pragma unroll
        for (int c = 0; c < NDK; ++c) {
          const int d = 8 * c + 2 * t;
          quan::mma_1688(s[nn], ka[c][0], ka[c][1], d < DK ? quan::lds32(&q2s[col][d]) : 0u);
        }
#pragma unroll
        for (int c = 0; c < NDV; ++c) {
          const int d = 8 * c + 2 * t;
          quan::mma_1688(p[nn], va[c][0], va[c][1], d < DV ? quan::lds32(&dos[col][d]) : 0u);
        }
      }
      // E and U: element e of n-tile nn is (key j0 + g + 8 (e / 2), query b + 8 nn + 2 t + e % 2)
      uint32_t ea[4], ua[4];
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        const int qi = b + 8 * nn + 2 * t;
        const float2 m2 = *reinterpret_cast<const float2*>(&ms[qi]);
        const float2 c2v = *reinterpret_cast<const float2*>(&cs[qi]);
        float ev[4], uv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nn][e] - ((e & 1) ? m2.y : m2.x);
          if (ragged && (j0 + g + 8 * (e >> 1) >= n || i0 + qi + (e & 1) >= n)) x = -CUDART_INF_F;
          const float ex = quan::exp2_approx(x);
          ev[e] = ex;
          uv[e] = ex * (p[nn][e] - ((e & 1) ? c2v.y : c2v.x));
        }
        // A fragment (rows = keys, k = the 16 queries): a0 rows g, a1 rows g + 8,
        // a2 / a3 the same rows for queries 8..15
        ea[2 * nn] = quan::pack_bf16(ev[0], ev[1]);
        ea[2 * nn + 1] = quan::pack_bf16(ev[2], ev[3]);
        ua[2 * nn] = quan::pack_bf16(uv[0], uv[1]);
        ua[2 * nn + 1] = quan::pack_bf16(uv[2], uv[3]);
      }
#pragma unroll
      for (int c = 0; c < NDV; ++c)
        quan::mma_16816(acc_v[c], ea[0], ea[1], ea[2], ea[3],
                        quan::lds32(&dorT[8 * c + g][b + 2 * t]),
                        quan::lds32(&dorT[8 * c + g][b + 2 * t + 8]));
#pragma unroll
      for (int c = 0; c < NDK; ++c)
        quan::mma_16816(acc_k[c], ua[0], ua[1], ua[2], ua[3],
                        quan::lds32(&qrT[8 * c + g][b + 2 * t]),
                        quan::lds32(&qrT[8 * c + g][b + 2 * t + 8]));
      // dQ = U ks over this warp's 16 keys: U's A fragment (rows = queries) is U^T's,
      // each 8 x 8 piece transposed: (q0, k0) = T(ua0), (q8, k0) = T(ua2),
      // (q0, k8) = T(ua1), (q8, k8) = T(ua3)
      const uint32_t u0 = quan::transpose8x8(ua[0]), u1 = quan::transpose8x8(ua[2]);
      const uint32_t u2 = quan::transpose8x8(ua[1]), u3 = quan::transpose8x8(ua[3]);
#pragma unroll
      for (int c = 0; c < NDK; ++c) {
        float dq4[4] = {0.f, 0.f, 0.f, 0.f};
        quan::mma_16816(dq4, u0, u1, u2, u3, kb0[c], kb1[c]);
        const int d = 8 * c + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (d + (e & 1) < DK) dqp[warp][b + g + 8 * (e >> 1)][d + (e & 1)] = dq4[e];
      }
    }
    __syncthreads();
  }
  if (n > 0) reduce((n - 1) / BQ * BQ);

  // dK, dV of this warp's keys: element e of n-tile c is (key j0 + g + 8 (e / 2), d = 8 c + 2 t + e % 2)
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = j0 + g + 8 * (e >> 1);
    if (j >= n) continue;
#pragma unroll
    for (int c = 0; c < NDK; ++c) {
      const int d = 8 * c + 2 * t + (e & 1);
      if (d < DK) dk[kbase + static_cast<size_t>(j) * DK + d] = __float2bfloat16_rn(acc_k[c][e]);
    }
#pragma unroll
    for (int c = 0; c < NDV; ++c) {
      const int d = 8 * c + 2 * t + (e & 1);
      if (d < DV) dv[vbase + static_cast<size_t>(j) * DV + d] = __float2bfloat16_rn(acc_v[c][e]);
    }
  }
}

// dq[g, i, d] = round_T(r[g, i] * sum over key blocks of dq_part[kb, g, i, d])
__global__ void qattn_bwd_dq(const float* __restrict__ dq_part, const float* __restrict__ stats,
                             bf16* __restrict__ dq, long long rows, int dk, int kblocks) {
  const long long total = rows * dk;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int kb = 0; kb < kblocks; ++kb) s += dq_part[kb * total + i];
    dq[i] = __float2bfloat16_rn(s * stats[rows + i / dk]);
  }
}

template <int DK, int DV>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                        const float* stats, float* cbuf, float* dq_part, void* dq, void* dk,
                        void* dv, int g, int n, float scale, float scale_log2e,
                        cudaStream_t stream) {
  const int tiles = (n + kRows - 1) / kRows;  // query blocks of (a) = key blocks of (b)
  const long long blocks = static_cast<long long>(g) * tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k);
  const bf16 *vb = static_cast<const bf16*>(v), *db = static_cast<const bf16*>(dout);
  qattn_bwd_rse<DK, DV><<<static_cast<unsigned>(blocks), 32 * kWarps, 0, stream>>>(
      qb, kb, vb, db, stats, cbuf, n, g, tiles, scale_log2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  qattn_bwd_keys<DK, DV><<<static_cast<unsigned>(blocks), 32 * kWarps, 0, stream>>>(
      qb, kb, vb, db, stats, cbuf, dq_part, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n,
      g, tiles, scale, scale_log2e);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long rows = static_cast<long long>(g) * n;
  const long long dq_blocks = std::min((rows * DK + 255) / 256, 65536LL);
  qattn_bwd_dq<<<static_cast<unsigned>(dq_blocks), 256, 0, stream>>>(
      dq_part, stats, static_cast<bf16*>(dq), rows, DK, tiles);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- f32, CUDA cores

constexpr int kBlock = 128;  // threads per block

// rows staged per shared-memory tile: 128, or 64 where 128 rows of `FloatsPerRow`
// floats would pass 40 KB (the static shared-memory limit is 48 KB)
template <int FloatsPerRow>
struct TileRows {
  static constexpr int value = FloatsPerRow * kBlock * 4 <= 40960 ? kBlock : kBlock / 2;
};

// a . b over D elements in f32: one product, then fused multiply-adds in index order
template <int D>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = a[0] * b[0];
#pragma unroll
  for (int d = 1; d < D; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

template <int DK, int DV>
__global__ void __launch_bounds__(kBlock)
qattn_bwd_rows(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ stats, float* __restrict__ dq,
               float* __restrict__ rse_buf, int n, int g_total, int tiles, float scale,
               float scale_log2e) {
  constexpr int kTile = TileRows<2 * DK + DV>::value;
  __shared__ __align__(16) float ks[kTile][DK];   // k
  __shared__ __align__(16) float kss[kTile][DK];  // k * scale
  __shared__ __align__(16) float vs[kTile][DV];

  const int g = blockIdx.x / tiles;
  const int row = (blockIdx.x % tiles) * kBlock + threadIdx.x;
  const bool active = row < n;
  const size_t kbase = static_cast<size_t>(g) * n * DK;
  const size_t vbase = static_cast<size_t>(g) * n * DV;
  const size_t srow = static_cast<size_t>(g) * n + (active ? row : 0);
  const size_t plane = static_cast<size_t>(g_total) * n;

  float q2[DK], dov[DV];  // q2 and dO of this row
#pragma unroll
  for (int d = 0; d < DK; ++d)
    q2[d] = active ? q[kbase + static_cast<size_t>(row) * DK + d] * scale_log2e : 0.f;
#pragma unroll
  for (int d = 0; d < DV; ++d) dov[d] = active ? dout[vbase + static_cast<size_t>(row) * DV + d] : 0.f;
  const float m = active ? stats[srow] : 0.f;
  const float r = active ? stats[plane + srow] : 0.f;

  auto stage = [&](int t0, int nt, bool with_ks) {
    __syncthreads();
    for (int j = threadIdx.x; j < nt; j += kBlock) {
      const size_t key = static_cast<size_t>(t0 + j);
#pragma unroll
      for (int d = 0; d < DK; ++d) {
        const float kv = k[kbase + key * DK + d];
        ks[j][d] = kv;
        if (with_ks) kss[j][d] = kv * scale;
      }
#pragma unroll
      for (int d = 0; d < DV; ++d) vs[j][d] = v[vbase + key * DV + d];
    }
    __syncthreads();
  };

  // pass 1: rse = rowsum(dP o E)
  float rse = 0.f;
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int nt = min(kTile, n - t0);
    stage(t0, nt, false);
#pragma unroll 4
    for (int j = 0; j < nt; ++j)
      rse = fmaf(dot<DV>(dov, vs[j]), exp2f(dot<DK>(q2, ks[j]) - m), rse);
  }

  // pass 2: dQ = r o (U ks)
  float acc[DK];
#pragma unroll
  for (int d = 0; d < DK; ++d) acc[d] = 0.f;
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int nt = min(kTile, n - t0);
    stage(t0, nt, true);
#pragma unroll 4
    for (int j = 0; j < nt; ++j) {
      const float e = exp2f(dot<DK>(q2, ks[j]) - m);
      const float u = e * (dot<DV>(dov, vs[j]) - r * rse);
#pragma unroll
      for (int d = 0; d < DK; ++d) acc[d] = fmaf(u, kss[j][d], acc[d]);
    }
  }

  if (active) {
    float* dqrow = dq + kbase + static_cast<size_t>(row) * DK;
#pragma unroll
    for (int d = 0; d < DK; ++d) dqrow[d] = acc[d] * r;
    rse_buf[srow] = rse;
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(kBlock)
qattn_bwd_cols(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ stats, const float* __restrict__ rse_buf,
               float* __restrict__ dk, float* __restrict__ dv, int n, int g_total, int tiles,
               float scale_log2e) {
  constexpr int kTile = TileRows<2 * DK + 2 * DV + 3>::value;
  __shared__ __align__(16) float q2s[kTile][DK];   // q2 = q * scale log2e
  __shared__ __align__(16) float qrs[kTile][DK];   // q2 * (r ln2)
  __shared__ __align__(16) float dos[kTile][DV];   // dO
  __shared__ __align__(16) float dors[kTile][DV];  // dO * r
  __shared__ float ms[kTile], rs[kTile], rses[kTile];

  const int g = blockIdx.x / tiles;
  const int col = (blockIdx.x % tiles) * kBlock + threadIdx.x;
  const bool active = col < n;
  const size_t kbase = static_cast<size_t>(g) * n * DK;
  const size_t vbase = static_cast<size_t>(g) * n * DV;
  const size_t sbase = static_cast<size_t>(g) * n;
  const size_t plane = static_cast<size_t>(g_total) * n;

  float kc[DK], vc[DV];
#pragma unroll
  for (int d = 0; d < DK; ++d) kc[d] = active ? k[kbase + static_cast<size_t>(col) * DK + d] : 0.f;
#pragma unroll
  for (int d = 0; d < DV; ++d) vc[d] = active ? v[vbase + static_cast<size_t>(col) * DV + d] : 0.f;

  float acck[DK], accv[DV];
#pragma unroll
  for (int d = 0; d < DK; ++d) acck[d] = 0.f;
#pragma unroll
  for (int d = 0; d < DV; ++d) accv[d] = 0.f;

  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int nt = min(kTile, n - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < nt; i += kBlock) {
      const size_t qr = static_cast<size_t>(t0 + i);
      const float m = stats[sbase + qr], r = stats[plane + sbase + qr];
      ms[i] = m;
      rs[i] = r;
      rses[i] = rse_buf[sbase + qr];
      const float rl = r * kLn2;
#pragma unroll
      for (int d = 0; d < DK; ++d) {
        const float x = q[kbase + qr * DK + d] * scale_log2e;
        q2s[i][d] = x;
        qrs[i][d] = x * rl;
      }
#pragma unroll
      for (int d = 0; d < DV; ++d) {
        const float x = dout[vbase + qr * DV + d];
        dos[i][d] = x;
        dors[i][d] = x * r;
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < nt; ++i) {
      const float e = exp2f(dot<DK>(q2s[i], kc) - ms[i]);
#pragma unroll
      for (int d = 0; d < DV; ++d) accv[d] = fmaf(e, dors[i][d], accv[d]);
      const float u = e * (dot<DV>(dos[i], vc) - rs[i] * rses[i]);
#pragma unroll
      for (int d = 0; d < DK; ++d) acck[d] = fmaf(u, qrs[i][d], acck[d]);
    }
  }

  if (active) {
#pragma unroll
    for (int d = 0; d < DK; ++d) dk[kbase + static_cast<size_t>(col) * DK + d] = acck[d];
#pragma unroll
    for (int d = 0; d < DV; ++d) dv[vbase + static_cast<size_t>(col) * DV + d] = accv[d];
  }
}

template <int DK, int DV>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* dout,
                       const float* stats, float* rse, void* dq, void* dk, void* dv, int g,
                       int n, float scale, float scale_log2e, cudaStream_t stream) {
  const int tiles = (n + kBlock - 1) / kBlock;
  const long long blocks = static_cast<long long>(g) * tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k);
  const float *vf = static_cast<const float*>(v), *df = static_cast<const float*>(dout);
  qattn_bwd_rows<DK, DV><<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(
      qf, kf, vf, df, stats, static_cast<float*>(dq), rse, n, g, tiles, scale, scale_log2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  qattn_bwd_cols<DK, DV><<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(
      qf, kf, vf, df, stats, rse, static_cast<float*>(dk), static_cast<float*>(dv), n, g, tiles,
      scale_log2e);
  return cudaGetLastError();
}

// The forward's head widths (csrc/qattn_fwd.cu:dispatch, ops/kernels/qattn.py:SUPPORTED).
#define QUAN_QATTN_PAIRS(X)                                                                \
  X(1, 1) X(1, 2) X(2, 2) X(2, 4) X(4, 4) X(4, 8) X(8, 8) X(8, 16) X(16, 16) X(16, 32)    \
  X(32, 32)

}  // namespace

// Both entry points: q, k, dq, dk: [G, N, dk]; v, dout, dv: [G, N, dv]; stats: [2, G, N]
// f32, the row max m and reciprocal sum r that the forward wrote; all contiguous, the
// tensors of the entry point's dtype, on CUDA device `device`. scale is the softmax scale
// and scale_log2e the scale times log2(e), both computed by the caller in double. Each
// launches its kernels on `stream` and returns the first nonzero cudaGetLastError().

// bf16 on the tensor cores. cbuf: [G, N] f32 scratch; dq_part: [ceil(N / 128), G, N, dk]
// f32 scratch.
extern "C" int qattn_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                              const void* stats, void* cbuf, void* dq_part, void* dq, void* dk,
                              void* dv, int g, int n, int d_k, int d_v, float scale,
                              float scale_log2e, int device, void* stream) {
  if (g <= 0 || n <= 0) return cudaSuccess;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(stats);
  float* cb = static_cast<float*>(cbuf);
  float* part = static_cast<float*>(dq_part);
#define QUAN_QATTN_CASE(A, B)                                                              \
  if (d_k == A && d_v == B)                                                                \
    return launch_bf16<A, B>(q, k, v, dout, sp, cb, part, dq, dk, dv, g, n, scale,        \
                             scale_log2e, st);
  QUAN_QATTN_PAIRS(QUAN_QATTN_CASE)
#undef QUAN_QATTN_CASE
  return cudaErrorInvalidValue;
}

// f32 on the CUDA cores. rse: [G, N] f32 scratch.
extern "C" int qattn_bwd_f32(const void* q, const void* k, const void* v, const void* dout,
                             const void* stats, void* rse, void* dq, void* dk, void* dv, int g,
                             int n, int d_k, int d_v, float scale, float scale_log2e,
                             int device, void* stream) {
  if (g <= 0 || n <= 0) return cudaSuccess;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(stats);
  float* rb = static_cast<float*>(rse);
#define QUAN_QATTN_CASE(A, B)                                                              \
  if (d_k == A && d_v == B)                                                                \
    return launch_f32<A, B>(q, k, v, dout, sp, rb, dq, dk, dv, g, n, scale, scale_log2e, st);
  QUAN_QATTN_PAIRS(QUAN_QATTN_CASE)
#undef QUAN_QATTN_CASE
  return cudaErrorInvalidValue;
}
