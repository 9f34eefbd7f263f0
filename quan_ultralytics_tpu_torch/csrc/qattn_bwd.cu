// Per-component attention, backward: dQ, dK, dV of O = softmax(scale * Q K^T) V for each
// group g, given dO. The softmax is recomputed; no N x N residual is stored.
//
// Replaces the TPU kernel quan_ultralytics_tpu/ops/pallas/qattn.py:_attn_bwd_kernel
// (the custom VJP _attn_bwd of _attn).
//
// It computes what the TPU kernel computes, at the same rounding points (T is the input
// dtype; "round_T" rounds an f32 value to T):
//   q2 = round_T(q * round_T(scale log2e)),  ks = round_T(k * round_T(scale))
//   E  = exp2(q2 k^T - rowmax)  (f32),       r = 1 / rowsum(E)
//   dor = round_T(dO * r),                   dV = round_T(E_b^T dor), E_b = round_T(E)
//   dP = dO V^T (f32),  rse = rowsum(dP o E),  U = round_T(E o (dP - r rse))
//   dQ = round_T(r o (U ks)),                dK = round_T(U^T round_T(q2 o (r ln2)))
//
// What bounds it on an H100: at the main path's shapes (N = 1024, dk = 2, dv = 4, G = 32
// groups per image) a group moves N (3 dk + 3 dv) elements, but each of the N^2 scores
// needs an exp2 and about (6 dk + 4 dv) multiply-adds: it is bound by the special-function
// and FMA units, not by memory. dk and dv are far below a tensor-core tile, so the CUDA
// cores do the work.
//
// Design: dQ is a sum over keys, dK and dV are sums over query rows, so one thread per
// row cannot produce all three without atomics. Two kernels run one after the other:
//  (a) qattn_bwd_rows: one thread per query row, keys and values staged through shared
//      memory as broadcasts (like the forward). Pass 1 finds the row max m; pass 2 sums
//      E for r and dP o E for rse; pass 3 recomputes E, forms U and accumulates U ks for
//      dQ. It writes m, r and rse to an [3, G, N] f32 scratch: O(N), not N^2.
//  (b) qattn_bwd_cols: one thread per key row, query rows (q2, round_T(q2 r ln2), dO,
//      dor and the row's m, r, rse) staged through shared memory. It recomputes E and U
//      for its column and accumulates dK and dV.
// U needs rse, a sum over the whole row, and is rounded to T before it multiplies ks, so
// dQ takes a pass of its own: three exp2 a score in all (two in (a), one in (b)). Both
// kernels compute a score, E and dP with the same device functions in the same order,
// so they see bitwise the same E and U. Keys and query rows >= N are outside the loop
// bounds, so any N works without padding.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kBlock = 128;  // threads per block
constexpr float kLn2 = 0.693147180559945309f;

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

// U = round_T(E o (dP - r rse)), as the TPU kernel forms it
template <typename T>
__device__ __forceinline__ float u_of(float e, float dp, float r, float rse) {
  return quan::round_to<T>(e * (dp - r * rse));
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kBlock)
qattn_bwd_rows(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ stats,
               int n, int g_total, int tiles, float scale, float scale_log2e) {
  constexpr int kTile = TileRows<2 * DK + DV>::value;
  __shared__ __align__(16) float ks[kTile][DK];   // k as f32
  __shared__ __align__(16) float kss[kTile][DK];  // round_T(k * scale)
  __shared__ __align__(16) float vs[kTile][DV];

  const int g = blockIdx.x / tiles;
  const int row = (blockIdx.x % tiles) * kBlock + threadIdx.x;
  const bool active = row < n;
  const size_t kbase = static_cast<size_t>(g) * n * DK;
  const size_t vbase = static_cast<size_t>(g) * n * DV;
  const float c2 = quan::round_to<T>(scale_log2e);
  const float cs = quan::round_to<T>(scale);

  float q2[DK], dov[DV];  // q2 and dO of this row, as f32
#pragma unroll
  for (int d = 0; d < DK; ++d)
    q2[d] = active ? quan::round_to<T>(quan::to_f32(q[kbase + static_cast<size_t>(row) * DK + d]) * c2)
                   : 0.f;
#pragma unroll
  for (int d = 0; d < DV; ++d)
    dov[d] = active ? quan::to_f32(dout[vbase + static_cast<size_t>(row) * DV + d]) : 0.f;

  auto stage = [&](int t0, int nt, bool with_v, bool with_ks) {
    __syncthreads();
    for (int j = threadIdx.x; j < nt; j += kBlock) {
      const size_t key = static_cast<size_t>(t0 + j);
#pragma unroll
      for (int d = 0; d < DK; ++d) {
        const float kv = quan::to_f32(k[kbase + key * DK + d]);
        ks[j][d] = kv;
        if (with_ks) kss[j][d] = quan::round_to<T>(kv * cs);
      }
      if (with_v) {
#pragma unroll
        for (int d = 0; d < DV; ++d) vs[j][d] = quan::to_f32(v[vbase + key * DV + d]);
      }
    }
    __syncthreads();
  };

  // pass 1: the row max of the scores
  float m = -CUDART_INF_F;
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int nt = min(kTile, n - t0);
    stage(t0, nt, false, false);
#pragma unroll 4
    for (int j = 0; j < nt; ++j) m = fmaxf(m, dot<DK>(q2, ks[j]));
  }

  // pass 2: l = rowsum(E), rse = rowsum(dP o E)
  float l = 0.f, rse = 0.f;
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int nt = min(kTile, n - t0);
    stage(t0, nt, true, false);
#pragma unroll 4
    for (int j = 0; j < nt; ++j) {
      const float e = exp2f(dot<DK>(q2, ks[j]) - m);
      l += e;
      rse = fmaf(dot<DV>(dov, vs[j]), e, rse);
    }
  }
  const float r = 1.f / l;

  // pass 3: dQ = r o (U ks)
  float acc[DK];
#pragma unroll
  for (int d = 0; d < DK; ++d) acc[d] = 0.f;
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int nt = min(kTile, n - t0);
    stage(t0, nt, true, true);
#pragma unroll 4
    for (int j = 0; j < nt; ++j) {
      const float e = exp2f(dot<DK>(q2, ks[j]) - m);
      const float u = u_of<T>(e, dot<DV>(dov, vs[j]), r, rse);
#pragma unroll
      for (int d = 0; d < DK; ++d) acc[d] = fmaf(u, kss[j][d], acc[d]);
    }
  }

  if (active) {
    T* dqrow = dq + kbase + static_cast<size_t>(row) * DK;
#pragma unroll
    for (int d = 0; d < DK; ++d) dqrow[d] = quan::from_f32<T>(acc[d] * r);
    const size_t srow = static_cast<size_t>(g) * n + row;
    const size_t plane = static_cast<size_t>(g_total) * n;
    stats[srow] = m;
    stats[plane + srow] = r;
    stats[2 * plane + srow] = rse;
  }
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kBlock)
qattn_bwd_cols(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ stats,
               T* __restrict__ dk, T* __restrict__ dv, int n, int g_total, int tiles,
               float scale_log2e) {
  constexpr int kTile = TileRows<2 * DK + 2 * DV + 3>::value;
  __shared__ __align__(16) float q2s[kTile][DK];   // q2 = round_T(q * scale log2e)
  __shared__ __align__(16) float qrs[kTile][DK];   // round_T(q2 * (r ln2))
  __shared__ __align__(16) float dos[kTile][DV];   // dO as f32
  __shared__ __align__(16) float dors[kTile][DV];  // round_T(dO * r)
  __shared__ float ms[kTile], rs[kTile], rses[kTile];

  const int g = blockIdx.x / tiles;
  const int col = (blockIdx.x % tiles) * kBlock + threadIdx.x;
  const bool active = col < n;
  const size_t kbase = static_cast<size_t>(g) * n * DK;
  const size_t vbase = static_cast<size_t>(g) * n * DV;
  const size_t sbase = static_cast<size_t>(g) * n;
  const size_t plane = static_cast<size_t>(g_total) * n;
  const float c2 = quan::round_to<T>(scale_log2e);

  float kc[DK], vc[DV];
#pragma unroll
  for (int d = 0; d < DK; ++d)
    kc[d] = active ? quan::to_f32(k[kbase + static_cast<size_t>(col) * DK + d]) : 0.f;
#pragma unroll
  for (int d = 0; d < DV; ++d)
    vc[d] = active ? quan::to_f32(v[vbase + static_cast<size_t>(col) * DV + d]) : 0.f;

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
      rses[i] = stats[2 * plane + sbase + qr];
      const float rl = r * kLn2;
#pragma unroll
      for (int d = 0; d < DK; ++d) {
        const float x = quan::round_to<T>(quan::to_f32(q[kbase + qr * DK + d]) * c2);
        q2s[i][d] = x;
        qrs[i][d] = quan::round_to<T>(x * rl);
      }
#pragma unroll
      for (int d = 0; d < DV; ++d) {
        const float x = quan::to_f32(dout[vbase + qr * DV + d]);
        dos[i][d] = x;
        dors[i][d] = quan::round_to<T>(x * r);
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < nt; ++i) {
      const float e = exp2f(dot<DK>(q2s[i], kc) - ms[i]);
      const float eb = quan::round_to<T>(e);
#pragma unroll
      for (int d = 0; d < DV; ++d) accv[d] = fmaf(eb, dors[i][d], accv[d]);
      const float u = u_of<T>(e, dot<DV>(dos[i], vc), rs[i], rses[i]);
#pragma unroll
      for (int d = 0; d < DK; ++d) acck[d] = fmaf(u, qrs[i][d], acck[d]);
    }
  }

  if (active) {
    T* dkrow = dk + kbase + static_cast<size_t>(col) * DK;
    T* dvrow = dv + vbase + static_cast<size_t>(col) * DV;
#pragma unroll
    for (int d = 0; d < DK; ++d) dkrow[d] = quan::from_f32<T>(acck[d]);
#pragma unroll
    for (int d = 0; d < DV; ++d) dvrow[d] = quan::from_f32<T>(accv[d]);
  }
}

template <typename T, int DK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, void* dq,
                   void* dk, void* dv, void* stats, int g, int n, float scale,
                   float scale_log2e, cudaStream_t stream) {
  const int tiles = (n + kBlock - 1) / kBlock;
  const long long blocks = static_cast<long long>(g) * tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  qattn_bwd_rows<T, DK, DV><<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<float*>(stats), n, g,
      tiles, scale, scale_log2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  qattn_bwd_cols<T, DK, DV><<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(stats), static_cast<T*>(dk),
      static_cast<T*>(dv), n, g, tiles, scale_log2e);
  return cudaGetLastError();
}

// The forward's head widths (csrc/qattn_fwd.cu:dispatch, ops/kernels/qattn.py:SUPPORTED).
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* dout, void* dq,
                     void* dk, void* dv, void* stats, int g, int n, int d_k, int d_v,
                     float scale, float scale_log2e, cudaStream_t stream) {
#define QUAN_QATTN_CASE(A, B)                                                             \
  if (d_k == A && d_v == B)                                                               \
    return launch<T, A, B>(q, k, v, dout, dq, dk, dv, stats, g, n, scale, scale_log2e,    \
                           stream);
  QUAN_QATTN_CASE(1, 1) QUAN_QATTN_CASE(1, 2) QUAN_QATTN_CASE(2, 2) QUAN_QATTN_CASE(2, 4)
  QUAN_QATTN_CASE(4, 4) QUAN_QATTN_CASE(4, 8) QUAN_QATTN_CASE(8, 8) QUAN_QATTN_CASE(8, 16)
  QUAN_QATTN_CASE(16, 16) QUAN_QATTN_CASE(16, 32) QUAN_QATTN_CASE(32, 32)
#undef QUAN_QATTN_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, dq, dk: [G, N, dk]; v, dout, dv: [G, N, dv]; stats: [3, G, N] f32 scratch; all
// contiguous, q/k/v/dout/dq/dk/dv of one dtype, on CUDA device `device`. scale is the
// softmax scale and scale_log2e the scale times log2(e), both computed by the caller in
// double. Launches two kernels on `stream`; returns the first nonzero cudaGetLastError().
extern "C" int qattn_bwd(const void* q, const void* k, const void* v, const void* dout,
                         void* dq, void* dk, void* dv, void* stats, int g, int n, int d_k,
                         int d_v, float scale, float scale_log2e, int dtype, int device,
                         void* stream) {
  if (g <= 0 || n <= 0) return cudaSuccess;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == quan::kF32)
    return dispatch<float>(q, k, v, dout, dq, dk, dv, stats, g, n, d_k, d_v, scale,
                           scale_log2e, st);
  if (dtype == quan::kBF16)
    return dispatch<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, stats, g, n, d_k, d_v, scale,
                                   scale_log2e, st);
  return cudaErrorInvalidValue;
}
