// Per-component attention, forward: O = softmax(scale * Q K^T) V for each group g.
//
// Replaces the TPU kernel quan_ultralytics_tpu/ops/pallas/qattn.py:_attn_kernel
// (called through _fwd_call -> _attn -> qattention_fused).
//
// What bounds it on an H100: at the main path's shapes (N = 1024 tokens,
// dk = 2, dv = 4, G = 32 groups per image) a group moves only N * (2dk + 2dv)
// elements in and out, about 0.8 MB per image, but does N^2 exp2 and about
// N^2 * (2dk + 2dv + 3) f32 operations: 33.6 M exp2 and ~0.5 G flops per
// image. It is bound by the special-function and FMA units, not by memory.
// This kernel runs its dk- and dv-long dots on the CUDA cores.
//
// Design: one block per (group, tile of 128 query rows), one thread per query
// row. Keys and values are staged through shared memory 128 at a time; every
// thread reads the same staged key (a broadcast, no bank conflicts). Two
// passes over the keys: pass 1 finds the row max m; pass 2 recomputes the
// score s, takes e = exp2(s - m), sums e in f32, rounds e to V's dtype and
// accumulates e * v in f32; the output is multiplied by r = 1 / sum at the end.
// This keeps the TPU kernel's rounding points exactly (scores in f32 in the
// exp2 domain with scale * log2(e) folded into Q and rounded to Q's dtype,
// e unnormalized and cast to V's dtype before e V, the reciprocal applied on
// [N, dv]); an online softmax would not. The second pass costs one extra
// dk-long dot per score and no extra exp2. Keys >= N are outside the loop
// bounds, so any N works without padding. The N x N block never reaches
// device memory.
//
// Row statistics for the backward: when the caller passes a `stats` buffer
// ([2, G, N] f32; only when a backward will follow), the kernel writes each
// row's m and r there. The backward (csrc/qattn_bwd.cu) then needs no pass for
// either: the TPU kernel's VJP recomputes exactly these values from q and k.
// Without a buffer (a predict forward) nothing is written.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kBlock = 128;  // threads per block = query rows per block = keys per tile

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kBlock)
qattn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ stats, int n, int g_total, int tiles,
                 float scale_log2e) {
  __shared__ __align__(16) float ks[kBlock][DK];
  __shared__ __align__(16) float vs[kBlock][DV];

  const int g = blockIdx.x / tiles;
  const int row = (blockIdx.x % tiles) * kBlock + threadIdx.x;
  const bool active = row < n;
  const size_t kbase = static_cast<size_t>(g) * n * DK;
  const size_t vbase = static_cast<size_t>(g) * n * DV;

  // q * (scale * log2e), both rounded to T as the TPU kernel's T-typed product is
  const float c = quan::round_to<T>(scale_log2e);
  float qr[DK];
#pragma unroll
  for (int d = 0; d < DK; ++d)
    qr[d] = active ? quan::round_to<T>(quan::to_f32(q[kbase + static_cast<size_t>(row) * DK + d]) * c)
                   : 0.f;

  // pass 1: the row max of the scores
  float m = -CUDART_INF_F;
  for (int t0 = 0; t0 < n; t0 += kBlock) {
    const int nt = min(kBlock, n - t0);
    __syncthreads();
    if (threadIdx.x < nt) {
#pragma unroll
      for (int d = 0; d < DK; ++d)
        ks[threadIdx.x][d] = quan::to_f32(k[kbase + static_cast<size_t>(t0 + threadIdx.x) * DK + d]);
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

  // pass 2: e = exp2(s - m), its f32 row sum, and sum of T(e) * v in f32
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
      for (int d = 0; d < DK; ++d) ks[threadIdx.x][d] = quan::to_f32(k[kbase + key * DK + d]);
#pragma unroll
      for (int d = 0; d < DV; ++d) vs[threadIdx.x][d] = quan::to_f32(v[vbase + key * DV + d]);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < nt; ++j) {
      float s = qr[0] * ks[j][0];
#pragma unroll
      for (int d = 1; d < DK; ++d) s = fmaf(qr[d], ks[j][d], s);
      const float e = exp2f(s - m);
      l += e;
      const float eb = quan::round_to<T>(e);
#pragma unroll
      for (int d = 0; d < DV; ++d) acc[d] = fmaf(eb, vs[j][d], acc[d]);
    }
  }

  if (active) {
    const float r = 1.f / l;
    T* orow = o + vbase + static_cast<size_t>(row) * DV;
#pragma unroll
    for (int d = 0; d < DV; ++d) orow[d] = quan::from_f32<T>(acc[d] * r);
    if (stats != nullptr) {
      const size_t srow = static_cast<size_t>(g) * n + row;
      stats[srow] = m;
      stats[static_cast<size_t>(g_total) * n + srow] = r;
    }
  }
}

template <typename T, int DK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* stats, int g,
                   int n, float scale_log2e, cudaStream_t stream) {
  const int tiles = (n + kBlock - 1) / kBlock;
  const long long blocks = static_cast<long long>(g) * tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  qattn_fwd_kernel<T, DK, DV><<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), stats, n, g, tiles, scale_log2e);
  return cudaGetLastError();
}

// Head widths the model family uses: dv = dk (attn_ratio 1) or dv = 2 dk (attn_ratio 0.5),
// up to 32. The Python wrapper lists the same pairs (ops/kernels/qattn.py:SUPPORTED).
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, float* stats, int g,
                     int n, int dk, int dv, float scale_log2e, cudaStream_t stream) {
#define QUAN_QATTN_CASE(A, B) \
  if (dk == A && dv == B) return launch<T, A, B>(q, k, v, o, stats, g, n, scale_log2e, stream);
  QUAN_QATTN_CASE(1, 1) QUAN_QATTN_CASE(1, 2) QUAN_QATTN_CASE(2, 2) QUAN_QATTN_CASE(2, 4)
  QUAN_QATTN_CASE(4, 4) QUAN_QATTN_CASE(4, 8) QUAN_QATTN_CASE(8, 8) QUAN_QATTN_CASE(8, 16)
  QUAN_QATTN_CASE(16, 16) QUAN_QATTN_CASE(16, 32) QUAN_QATTN_CASE(32, 32)
#undef QUAN_QATTN_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k: [G, N, dk]; v, o: [G, N, dv]; all contiguous, of one dtype, on CUDA device `device`.
// stats: null, or [2, G, N] f32 that receives each row's max m and reciprocal sum r.
// scale_log2e is the softmax scale times log2(e), computed by the caller in double.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int qattn_fwd(const void* q, const void* k, const void* v, void* o, void* stats,
                         int g, int n, int dk, int dv, float scale_log2e, int dtype, int device,
                         void* stream) {
  if (g <= 0 || n <= 0) return cudaSuccess;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sp = static_cast<float*>(stats);
  if (dtype == quan::kF32) return dispatch<float>(q, k, v, o, sp, g, n, dk, dv, scale_log2e, st);
  if (dtype == quan::kBF16)
    return dispatch<__nv_bfloat16>(q, k, v, o, sp, g, n, dk, dv, scale_log2e, st);
  return cudaErrorInvalidValue;
}
