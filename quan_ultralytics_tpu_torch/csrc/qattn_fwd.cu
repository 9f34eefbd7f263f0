// Per-component attention, forward: O = softmax(scale * Q K^T) V for each group g.
//
// Replaces the TPU kernel quan_ultralytics_tpu/ops/pallas/qattn.py:_attn_kernel
// (called through _fwd_call -> _attn -> qattention_fused).
//
// It computes what the TPU kernel computes, at the same rounding points (T is the input
// dtype; "round_T" rounds an f32 value to T):
//   q2 = round_T(q * round_T(scale log2e)),  s = q2 k^T (f32, the exp2 domain)
//   m = rowmax(s),  E = exp2(s - m),  r = 1 / rowsum(E)   (f32)
//   O = round_T((round_T(E) V in f32) * r)                 (normalized on [N, dv])
// An online softmax would round E against a running max and rescale afterwards: another
// result. So both kernels take two passes over the keys, the first for the exact row
// max. Keys >= N are masked by N itself (no padding), so any N works. The N x N block
// never reaches device memory.
//
// What bounds it on an H100: at the main path's shapes (N = 1024 tokens, dk = 2, dv = 4,
// G = 32 groups per image) a group moves N (2 dk + 2 dv) elements in and out, about
// 0.8 MB per image, but has N^2 scores, each with one exp2 on the special-function units
// (16 lanes an SM): 33.6 M exp2 per image. It is bound by the SFUs and by the issue of
// the per-score work, not by memory.
//
// bf16 (qattn_fwd_mma, tensor cores): one block per (group, 128 query rows), 16 rows a
// warp (the m of mma.sync). The group's K and V are staged once into shared memory with
// cp.async (all N keys where they fit 48 KB, else in tiles, once per pass), rows
// zero-padded to 8 columns: dk to the m16n8k8 depth, dv to n8. q2 stays in registers.
//   pass 1: S = q2 K^T by mma.m16n8k8 (f32 sums), 32 keys a step; the running row max in
//           registers, then over the quad of lanes that share a row.
//   pass 2: S - m by the same mma with -m as its accumulator input; E = exp2 on the SFU
//           (ex2.approx.ftz); l += E in f32; E packed to bf16 pairs, so the f32
//           accumulator fragment of S is the bf16 A fragment of E V (as FlashAttention-2
//           and csrc/qattn_bwd.cu do); O += E V by mma.m16n8k16, V's B fragments by
//           ldmatrix.trans. At the end l over the quad and round_T(O r).
// A step is one block of code (the pass and the ragged last step are compile-time), so
// that the compiler schedules its mma, exp2 and sums together. Many short blocks beat
// fewer long ones here (more rows a warp, a grid of one wave, or a pipeline that runs one
// row tile's pass 1 beside another's pass 2 were all slower on the H100: PERF.md).
// Pass 2 runs at about the pace of its one exp2 a score on the SFUs; pass 1, which has
// none, and the blocks' start add the rest (0.66 of the exp2 floor at the main shape on
// an H100: PERF.md). bf16 products are exact in f32, so only the order of f32 sums
// differs from the TPU kernel; qattn.FWD_TOL covers that. No atomics: repeated runs give
// the same bits.
//
// f32 (qattn_fwd_simt, CUDA cores; TF32 products would miss the f32 tolerance): one thread
// per query row; keys and values staged through shared memory 128 at a time, every thread
// reading the same staged key (a broadcast). Pass 1 finds the row max m; pass 2 recomputes
// the score, sums exp2f(s - m) and accumulates e v in f32; the output is multiplied by r.
//
// Row statistics for the backward: when the caller passes a `stats` buffer ([2, G, N] f32;
// only when a backward will follow), both kernels write each row's m and r there. The
// backward (csrc/qattn_bwd.cu) then needs no pass for either: the TPU kernel's VJP
// recomputes exactly these values from q and k. Without a buffer (a predict forward)
// nothing is written.
#include <math_constants.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------- bf16, tensor cores

constexpr int kWarps = 8;                  // warps per block, 16 query rows each
constexpr int kRows = 16 * kWarps;         // query rows per block
constexpr int kStep = 32;                  // keys per step of a warp: four n8 tiles
constexpr int kStageBytes = 48 * 1024;     // shared memory for staged keys and values, at most

// Row pitch (elements) of a staged [keys, D] operand: one 16-byte ldmatrix row for D <= 8,
// else D + 8, so that the 8 rows an ldmatrix phase reads fall in distinct banks.
template <int D>
struct Pitch {
  static constexpr int value = D <= 8 ? 8 : D + 8;
};

// keys a staged tile holds at most: a multiple of kStep
template <int DK, int DV>
constexpr int max_keys() {
  return kStageBytes / (2 * (Pitch<DK>::value + Pitch<DV>::value)) / kStep * kStep;
}

// element (row, d) of an [n, D] bf16 matrix in device memory as f32; zero outside it
template <int D>
__device__ __forceinline__ float elem(const bf16* base, int row, int d, int n) {
  return (row < n && d < D) ? __bfloat162float(base[static_cast<size_t>(row) * D + d]) : 0.f;
}

// rows [0, rows) of a [.., D] bf16 matrix in device memory into shared rows of pitch P,
// columns [0, D) only, asynchronously in the largest piece that divides a row (16, 8 or 4
// bytes; D = 1 element by element). The source is 16-byte aligned at row 0.
template <int D, int P>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int rows) {
  constexpr int kBytes = 2 * D;
  constexpr int kPiece = kBytes % 16 == 0 ? 16 : kBytes % 8 == 0 ? 8 : kBytes % 4 == 0 ? 4 : 2;
  constexpr int kPer = kBytes / kPiece;  // pieces a row
  for (int i = threadIdx.x; i < rows * kPer; i += blockDim.x) {
    const int j = i / kPer, p = i % kPer;
    char* d = reinterpret_cast<char*>(dst + j * P) + p * kPiece;
    const char* s = reinterpret_cast<const char*>(src + static_cast<size_t>(j) * D) + p * kPiece;
    if constexpr (kPiece == 16) {
      quan::cp_async16(d, s);
    } else if constexpr (kPiece == 8) {
      quan::cp_async8(d, s);
    } else if constexpr (kPiece == 4) {
      quan::cp_async4(d, s);
    } else {
      *reinterpret_cast<bf16*>(d) = *reinterpret_cast<const bf16*>(s);
    }
  }
}

// zero `bytes` (a multiple of 16) of shared memory at `p` (16-byte aligned)
__device__ __forceinline__ void zero_shared(void* p, int bytes) {
  uint4* p16 = static_cast<uint4*>(p);
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x) p16[i] = make_uint4(0u, 0u, 0u, 0u);
}

template <int DK, int DV>
__global__ void __launch_bounds__(32 * kWarps)
qattn_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              bf16* __restrict__ o, float* __restrict__ stats, int n, int g_total, int tiles,
              int kt, float scale_log2e) {
  constexpr int NKC = (DK + 7) / 8, NVC = (DV + 7) / 8;  // 8-wide column chunks of q2 / k, of v
  constexpr int PK = Pitch<DK>::value, PV = Pitch<DV>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [kt][PK]
  bf16* vs = ks + kt * PK;                   // [kt][PV]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int grp = blockIdx.x / tiles;
  const int r0 = (blockIdx.x % tiles) * kRows + 16 * warp;  // this warp's first row
  const bool active = r0 < n;
  const bf16* qg = q + static_cast<size_t>(grp) * n * DK;
  const bf16* kg = k + static_cast<size_t>(grp) * n * DK;
  const bf16* vg = v + static_cast<size_t>(grp) * n * DV;

  // pad columns and rows past N stay zero: staging writes columns [0, D) of valid rows
  zero_shared(smem, kt * (PK + PV) * 2);

  // A fragments of q2 for rows r0 + g (a0) and r0 + g + 8 (a1), columns 8c + 2t, 8c + 2t + 1
  const float c2 = quan::round_to<bf16>(scale_log2e);
  uint32_t qa[NKC][2];
#pragma unroll
  for (int c = 0; c < NKC; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + g + 8 * h, d = 8 * c + 2 * t;
      qa[c][h] = quan::pack_bf16(quan::round_to<bf16>(elem<DK>(qg, row, d, n) * c2),
                                 quan::round_to<bf16>(elem<DK>(qg, row, d + 1, n) * c2));
    }

  // S of 32 keys (B fragments kb), the accumulators started at c: element e of n-tile i is
  // (row r0 + g + 8 (e / 2), key j0 + 8 i + 2 t + e % 2)
  auto scores = [&](float (&s)[4][4], const uint32_t (&kb)[NKC][4], const float (&c)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      quan::mma_1688(s[i], qa[0][0], qa[0][1], kb[0][i], c);
#pragma unroll
      for (int cc = 1; cc < NKC; ++cc) quan::mma_1688(s[i], qa[cc][0], qa[cc][1], kb[cc][i]);
    }
  };
  // keys >= nt of the step from key j0 to -inf
  auto mask = [&](float (&s)[4][4], int j0, int nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j0 + 8 * i + 2 * t + (e & 1) >= nt) s[i][e] = -CUDART_INF_F;
  };

  const float zero4[4] = {0.f, 0.f, 0.f, 0.f};
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};  // pass 1: row max of rows r0 + g, r0 + g + 8
  float nm[4];  // pass 2: -m as the accumulators' input, so the mma gives S - m
  float l[2] = {0.f, 0.f};  // pass 2: row sums of E
  float acc[NVC][4];        // pass 2: E V
#pragma unroll
  for (int c = 0; c < NVC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  // one step of 32 keys from key j0 of the staged tile of nt keys: pass 1, or pass 2 (P2),
  // keys past nt masked (R); compile-time flags, so that a step is one block of code that
  // the compiler can schedule as a whole
  auto step = [&](int j0, int nt, auto p2, auto r) {
    constexpr bool P2 = decltype(p2)::value, R = decltype(r)::value;
    uint32_t kb[NKC][4];  // B fragments: lanes 8i..8i+7 address keys j0 + 8i .. j0 + 8i + 7
#pragma unroll
    for (int cc = 0; cc < NKC; ++cc) quan::ldmatrix_x4(kb[cc], ks + (j0 + lane) * PK + 8 * cc);
    float s[4][4];
    if constexpr (!P2) {
      scores(s, kb, zero4);
      if constexpr (R) mask(s, j0, nt);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[i][e]);
    } else {
      scores(s, kb, nm);
      if constexpr (R) mask(s, j0, nt);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[i][e] = quan::exp2_approx(s[i][e]);
          l[e >> 1] += s[i][e];
        }
      // A fragments of E over keys j0 + 16 hh .. + 15: a0 (row g, keys 2t, 2t+1 of n-tile
      // 2 hh), a1 (row g + 8, same keys), a2 / a3 the same rows in n-tile 2 hh + 1
      uint32_t ea[2][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          ea[hh][2 * p] = quan::pack_bf16(s[2 * hh + p][0], s[2 * hh + p][1]);
          ea[hh][2 * p + 1] = quan::pack_bf16(s[2 * hh + p][2], s[2 * hh + p][3]);
        }
#pragma unroll
      for (int c = 0; c < NVC; ++c) {
        uint32_t vb[4];  // B fragments of V (k = keys, n = columns 8c..8c+7), two per 16 keys
        quan::ldmatrix_x4_trans(vb, vs + (j0 + lane) * PV + 8 * c);
        quan::mma_16816(acc[c], ea[0][0], ea[0][1], ea[0][2], ea[0][3], vb[0], vb[1]);
        quan::mma_16816(acc[c], ea[1][0], ea[1][1], ea[1][2], ea[1][3], vb[2], vb[3]);
      }
    }
  };
  // the steps over the nt keys of a staged tile, the last one masked if nt is ragged
  auto keys = [&](int nt, auto p2) {
    const int full = nt / kStep * kStep;
    for (int j0 = 0; j0 < full; j0 += kStep) step(j0, nt, p2, std::false_type{});
    if (full < nt) step(full, nt, p2, std::true_type{});
  };
  const bool whole = n <= kt;  // the group's keys fit one staged tile: staged once
  // one pass over all keys; where they do not fit, tiles of kt keys are staged for it (the
  // last tile's rows past its keys were written by an earlier tile, so they are zeroed
  // again, up to the next step). Every warp takes part in the staging.
  auto sweep = [&](auto p2) {
    if (whole) {
      if (active) keys(n, p2);
      return;
    }
    for (int t0 = 0; t0 < n; t0 += kt) {
      const int nt = min(kt, n - t0);
      __syncthreads();
      const int end = min(kt, (nt + kStep - 1) / kStep * kStep);
      zero_shared(ks + nt * PK, (end - nt) * PK * 2);
      stage_rows<DK, PK>(ks, kg + static_cast<size_t>(t0) * DK, nt);
      if constexpr (decltype(p2)::value) {
        zero_shared(vs + nt * PV, (end - nt) * PV * 2);
        stage_rows<DV, PV>(vs, vg + static_cast<size_t>(t0) * DV, nt);
      }
      quan::cp_async_commit();
      quan::cp_async_wait<0>();
      __syncthreads();
      if (active) keys(nt, p2);
    }
  };

  __syncthreads();
  if (whole) {
    // K first, so that pass 1 overlaps the copy of V
    stage_rows<DK, PK>(ks, kg, n);
    quan::cp_async_commit();
    stage_rows<DV, PV>(vs, vg, n);
    quan::cp_async_commit();
    quan::cp_async_wait<1>();
    __syncthreads();
  }
  sweep(std::false_type{});
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
  nm[0] = nm[1] = -mx[0];
  nm[2] = nm[3] = -mx[1];
  if (whole) {
    quan::cp_async_wait<0>();
    __syncthreads();
  }
  sweep(std::true_type{});
  if (!active) return;

  // epilogue: l over the quad, r = 1 / l, round_T(O r) and the statistics; element e of
  // n-tile c is (row r0 + g + 8 (e / 2), column 8c + 2t + e % 2)
  bf16* og = o + static_cast<size_t>(grp) * n * DV;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float r = 1.f / l[h];
    const int row = r0 + g + 8 * h;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < NVC; ++c) {
      const int d = 8 * c + 2 * t;
      bf16* out = og + static_cast<size_t>(row) * DV + d;
      if (d + 1 < DV) {
        *reinterpret_cast<__nv_bfloat162*>(out) =
            __floats2bfloat162_rn(acc[c][2 * h] * r, acc[c][2 * h + 1] * r);
      } else if (d < DV) {
        *out = __float2bfloat16_rn(acc[c][2 * h] * r);
      }
    }
    if (stats != nullptr && t == 0) {
      const size_t srow = static_cast<size_t>(grp) * n + row;
      stats[srow] = mx[h];
      stats[static_cast<size_t>(g_total) * n + srow] = r;
    }
  }
}

template <int DK, int DV>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, float* stats, int g,
                       int n, float scale_log2e, cudaStream_t stream) {
  const int tiles = (n + kRows - 1) / kRows;
  const long long blocks = static_cast<long long>(g) * tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int kt = std::min((n + kStep - 1) / kStep * kStep, max_keys<DK, DV>());
  const size_t smem = static_cast<size_t>(kt) * (Pitch<DK>::value + Pitch<DV>::value) * 2;
  qattn_fwd_mma<DK, DV><<<static_cast<unsigned>(blocks), 32 * kWarps, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), stats, n, g, tiles, kt, scale_log2e);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- f32, CUDA cores

constexpr int kBlock = 128;  // threads per block = query rows per block = keys per tile

template <int DK, int DV>
__global__ void __launch_bounds__(kBlock)
qattn_fwd_simt(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, float* __restrict__ stats,
               int n, int g_total, int tiles, float scale_log2e) {
  __shared__ __align__(16) float ks[kBlock][DK];
  __shared__ __align__(16) float vs[kBlock][DV];

  const int g = blockIdx.x / tiles;
  const int row = (blockIdx.x % tiles) * kBlock + threadIdx.x;
  const bool active = row < n;
  const size_t kbase = static_cast<size_t>(g) * n * DK;
  const size_t vbase = static_cast<size_t>(g) * n * DV;

  float qr[DK];  // q * (scale * log2e)
#pragma unroll
  for (int d = 0; d < DK; ++d)
    qr[d] = active ? q[kbase + static_cast<size_t>(row) * DK + d] * scale_log2e : 0.f;

  // pass 1: the row max of the scores
  float m = -CUDART_INF_F;
  for (int t0 = 0; t0 < n; t0 += kBlock) {
    const int nt = min(kBlock, n - t0);
    __syncthreads();
    if (threadIdx.x < nt) {
#pragma unroll
      for (int d = 0; d < DK; ++d)
        ks[threadIdx.x][d] = k[kbase + static_cast<size_t>(t0 + threadIdx.x) * DK + d];
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < nt; ++j) {
      float s = qr[0] * ks[j][0];
#pragma unroll
      for (int d = 1; d < DK; ++d) s = fmaf(qr[d], ks[j][d], s);
      m = fmaxf(m, s);
    }
  }

  // pass 2: e = exp2(s - m), its row sum, and sum of e * v
  float l = 0.f;
  float acc[DV];
#pragma unroll
  for (int d = 0; d < DV; ++d) acc[d] = 0.f;
  for (int t0 = 0; t0 < n; t0 += kBlock) {
    const int nt = min(kBlock, n - t0);
    __syncthreads();
    if (threadIdx.x < nt) {
      const size_t key = static_cast<size_t>(t0 + threadIdx.x);
#pragma unroll
      for (int d = 0; d < DK; ++d) ks[threadIdx.x][d] = k[kbase + key * DK + d];
#pragma unroll
      for (int d = 0; d < DV; ++d) vs[threadIdx.x][d] = v[vbase + key * DV + d];
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < nt; ++j) {
      float s = qr[0] * ks[j][0];
#pragma unroll
      for (int d = 1; d < DK; ++d) s = fmaf(qr[d], ks[j][d], s);
      const float e = exp2f(s - m);
      l += e;
#pragma unroll
      for (int d = 0; d < DV; ++d) acc[d] = fmaf(e, vs[j][d], acc[d]);
    }
  }

  if (active) {
    const float r = 1.f / l;
    float* orow = o + vbase + static_cast<size_t>(row) * DV;
#pragma unroll
    for (int d = 0; d < DV; ++d) orow[d] = acc[d] * r;
    if (stats != nullptr) {
      const size_t srow = static_cast<size_t>(g) * n + row;
      stats[srow] = m;
      stats[static_cast<size_t>(g_total) * n + srow] = r;
    }
  }
}

template <int DK, int DV>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* o, float* stats, int g,
                        int n, float scale_log2e, cudaStream_t stream) {
  const int tiles = (n + kBlock - 1) / kBlock;
  const long long blocks = static_cast<long long>(g) * tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  qattn_fwd_simt<DK, DV><<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), stats, n, g, tiles, scale_log2e);
  return cudaGetLastError();
}

// Head widths the model family uses: dv = dk (attn_ratio 1) or dv = 2 dk (attn_ratio 0.5),
// up to 32. The Python wrapper lists the same pairs (ops/kernels/qattn.py:SUPPORTED).
#define QUAN_QATTN_PAIRS(X)                                                                \
  X(1, 1) X(1, 2) X(2, 2) X(2, 4) X(4, 4) X(4, 8) X(8, 8) X(8, 16) X(16, 16) X(16, 32)    \
  X(32, 32)

}  // namespace

// Both entry points: q, k: [G, N, dk]; v, o: [G, N, dv]; all contiguous, of the entry
// point's dtype, on CUDA device `device`. stats: null, or [2, G, N] f32 that receives each
// row's max m and reciprocal sum r. scale_log2e is the softmax scale times log2(e),
// computed by the caller in double. Returns cudaGetLastError() after the launch (0 on
// success).

// bf16 on the tensor cores; k and v 16-byte aligned.
extern "C" int qattn_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* stats,
                              int g, int n, int dk, int dv, float scale_log2e, int device,
                              void* stream) {
  if (g <= 0 || n <= 0) return cudaSuccess;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  float* sp = static_cast<float*>(stats);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define QUAN_QATTN_CASE(A, B) \
  if (dk == A && dv == B) return launch_mma<A, B>(q, k, v, o, sp, g, n, scale_log2e, st);
  QUAN_QATTN_PAIRS(QUAN_QATTN_CASE)
#undef QUAN_QATTN_CASE
  return cudaErrorInvalidValue;
}

// f32 on the CUDA cores.
extern "C" int qattn_fwd_f32(const void* q, const void* k, const void* v, void* o, void* stats,
                             int g, int n, int dk, int dv, float scale_log2e, int device,
                             void* stream) {
  if (g <= 0 || n <= 0) return cudaSuccess;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  float* sp = static_cast<float*>(stats);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define QUAN_QATTN_CASE(A, B) \
  if (dk == A && dv == B) return launch_simt<A, B>(q, k, v, o, sp, g, n, scale_log2e, st);
  QUAN_QATTN_PAIRS(QUAN_QATTN_CASE)
#undef QUAN_QATTN_CASE
  return cudaErrorInvalidValue;
}
