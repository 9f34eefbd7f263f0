// Fused 1x1 quaternion conv + folded IQBN affine + optional SiLU (inference).
//
// Replaces the TPU kernel quan_ultralytics_tpu/ops/pallas/qconv_fused.py:_kernel
// (called in qconv1x1_fused, dispatched from models/conv.py Conv under
// QUAN_FUSED_1X1=1).
//
// For each pixel p and output channel co, with x q-major [P, 4 Ci]:
//   s_d = sum_ci x[p, d Ci + ci] * w[d, co, ci]      (f32 accumulation, d = r, i, j, k)
//   y   = M s                                       (Zhou mixing)
//   out[p, q Co + co] = silu(y_q * scale[q, co] + shift[q, co])   in x's dtype
//
// What bounds it on an H100: with Ci, Co <= 128 a pixel does 4 Ci Co FMAs
// for 4 (Ci + Co) elements moved, a few FLOPs per byte, far below the card's
// balance point, so device memory bounds it:
// (P 4 Ci + P 4 Co) * itemsize / 3.35 TB/s per site.
//
// Design: the weights of a tile of output channels stay in shared memory (as
// f32, transposed to [4][Ci][co_tile] so that neighbouring threads read
// neighbouring channels) for the life of the block; each block walks over
// pixel tiles (a grid-stride loop sized to the card's resident blocks), so the
// weights are read once per block, not once per pixel tile. Each pixel tile
// [tp, 4 Ci] is read from device memory once, coalesced, into shared memory
// with a row pitch of 4 Ci + 1 floats (no bank conflicts between pixels).
// Each thread computes CT neighbouring output channels of one pixel for all
// four components (4 CT accumulators), then the mixing, the affine and the
// SiLU in registers, and writes CT channels per component at once. The
// intermediates s and y never reach device memory: one read of x and one write
// of the output, against the four passes of the unfused conv, mixing, IQBN
// and SiLU.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;                 // upper bound of threads per block
constexpr int kWeightBudget = 96 * 1024;      // bytes of shared memory for the weight tile
constexpr int kPixelBudget = 64 * 1024;       // bytes of shared memory for the pixel tile

// CT consecutive elements moved as one aligned vector access.
template <typename T, int CT>
struct alignas(sizeof(T) * CT) Pack {
  T el[CT];
};

template <typename T, int CT>
__device__ __forceinline__ void store(T* dst, const float (&v)[CT]) {
  Pack<T, CT> p;
#pragma unroll
  for (int t = 0; t < CT; ++t) p.el[t] = quan::from_f32<T>(v[t]);
  *reinterpret_cast<Pack<T, CT>*>(dst) = p;
}

template <int CT>
__device__ __forceinline__ void load(const float* src, float (&v)[CT]) {
  const Pack<float, CT> p = *reinterpret_cast<const Pack<float, CT>*>(src);
#pragma unroll
  for (int t = 0; t < CT; ++t) v[t] = p.el[t];
}

template <typename T, int CT>
__global__ void __launch_bounds__(kThreads)
qconv1x1_fused_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const float* __restrict__ scale, const float* __restrict__ shift,
                      T* __restrict__ out, long long p_total, int ci_n, int co_n, int co_tile,
                      int tp, int silu) {
  extern __shared__ __align__(16) float smem[];
  const int k4 = 4 * ci_n;
  const int ldx = k4 + 1;
  float* ws = smem;                     // [4][ci_n][co_tile]
  float* xs = smem + k4 * co_tile;      // [tp][ldx]
  const int co_base = blockIdx.y * co_tile;

  // weights: read w[d, co_base + col, ci] (contiguous in ci), store transposed
  for (int i = threadIdx.x; i < k4 * co_tile; i += blockDim.x) {
    const int ci = i % ci_n;
    const int rest = i / ci_n;
    const int col = rest % co_tile;
    const int d = rest / co_tile;
    ws[(d * ci_n + ci) * co_tile + col] =
        quan::to_f32(w[(static_cast<size_t>(d) * co_n + co_base + col) * ci_n + ci]);
  }

  const int ncc = co_tile / CT;
  const int pl = threadIdx.x / ncc;     // pixel within the tile
  const int co0 = (threadIdx.x % ncc) * CT;
  const long long tiles = (p_total + tp - 1) / tp;

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long p0 = tile * tp;
    const int np = static_cast<int>(min(static_cast<long long>(tp), p_total - p0));
    __syncthreads();  // the previous tile is consumed (and, first time, the weights are in)
    const T* xt = x + p0 * k4;
    for (int i = threadIdx.x; i < np * k4; i += blockDim.x) {
      const int r = i / k4;
      xs[r * ldx + (i - r * k4)] = quan::to_f32(xt[i]);
    }
    __syncthreads();
    if (pl >= np) continue;

    float acc[4][CT];
#pragma unroll
    for (int d = 0; d < 4; ++d)
#pragma unroll
      for (int t = 0; t < CT; ++t) acc[d][t] = 0.f;
    const float* xr = xs + pl * ldx;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const float* xd = xr + d * ci_n;
      const float* wd = ws + d * ci_n * co_tile + co0;
#pragma unroll 4
      for (int ci = 0; ci < ci_n; ++ci) {
        const float xv = xd[ci];
        float wv[CT];
        load<CT>(wd + ci * co_tile, wv);
#pragma unroll
        for (int t = 0; t < CT; ++t) acc[d][t] = fmaf(xv, wv[t], acc[d][t]);
      }
    }

    T* orow = out + (p0 + pl) * 4 * co_n + co_base + co0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v[CT];
#pragma unroll
      for (int t = 0; t < CT; ++t) {
        const float sr = acc[0][t], si = acc[1][t], sj = acc[2][t], sk = acc[3][t];
        float y;
        if (q == 0) y = sr + si + sj + sk;
        else if (q == 1) y = sr - si - sj + sk;
        else if (q == 2) y = sr + si - sj - sk;
        else y = sr - si + sj - sk;
        const int co = co_base + co0 + t;
        y = y * scale[q * co_n + co] + shift[q * co_n + co];
        if (silu) y = y / (1.f + expf(-y));
        v[t] = y;
      }
      store<T, CT>(orow + q * co_n, v);
    }
  }
}

template <typename T, int CT>
cudaError_t launch(const void* x, const void* w, const float* scale, const float* shift,
                   void* out, long long p_total, int ci_n, int co_n, int silu, int dev,
                   cudaStream_t stream) {
  // output-channel tile: the largest divisor of Co (a multiple of CT, at most
  // kThreads * CT wide) whose f32 weights fit the weight budget
  int co_tile = 0;
  for (int c = std::min(co_n, kThreads * CT); c >= CT; c -= CT) {
    if (co_n % c == 0 && 4LL * ci_n * c * 4 <= kWeightBudget) {
      co_tile = c;
      break;
    }
  }
  if (co_tile == 0) return cudaErrorInvalidValue;
  const int ncc = co_tile / CT;
  const int pitch_bytes = (4 * ci_n + 1) * 4;
  const int tp = std::max(1, std::min(kThreads / ncc, kPixelBudget / pitch_bytes));
  const int threads = tp * ncc;
  const size_t smem = (static_cast<size_t>(4) * ci_n * co_tile + static_cast<size_t>(tp) *
                       (4 * ci_n + 1)) * sizeof(float);

  auto kernel = qconv1x1_fused_kernel<T, CT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int sms = 0, resident = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, threads, smem)) !=
      cudaSuccess)
    return err;
  const int co_tiles = co_n / co_tile;
  const long long p_tiles = (p_total + tp - 1) / tp;
  const long long fill = std::max(1LL, static_cast<long long>(sms) * std::max(resident, 1) / co_tiles);
  dim3 grid(static_cast<unsigned>(std::min(p_tiles, fill)), static_cast<unsigned>(co_tiles));
  kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                          scale, shift, static_cast<T*>(out), p_total, ci_n,
                                          co_n, co_tile, tp, silu);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, const float* scale, const float* shift,
                     void* out, long long p_total, int ci_n, int co_n, int silu, int dev,
                     cudaStream_t stream) {
  if (co_n % 4 == 0)
    return launch<T, 4>(x, w, scale, shift, out, p_total, ci_n, co_n, silu, dev, stream);
  if (co_n % 2 == 0)
    return launch<T, 2>(x, w, scale, shift, out, p_total, ci_n, co_n, silu, dev, stream);
  return launch<T, 1>(x, w, scale, shift, out, p_total, ci_n, co_n, silu, dev, stream);
}

}  // namespace

// x: [P, 4 Ci] q-major; w: [4, Co, Ci]; scale, shift: [4, Co] f32; out: [P, 4 Co] q-major.
// x, w and out share one dtype; everything is contiguous and on CUDA device `device`.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int qconv1x1_fused(const void* x, const void* w, const void* scale, const void* shift,
                              void* out, long long p_total, int ci_n, int co_n, int silu,
                              int dtype, int device, void* stream) {
  if (p_total <= 0) return cudaSuccess;
  if (ci_n <= 0 || co_n <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  if (dtype == quan::kF32)
    return dispatch<float>(x, w, sc, sh, out, p_total, ci_n, co_n, silu, device, st);
  if (dtype == quan::kBF16)
    return dispatch<__nv_bfloat16>(x, w, sc, sh, out, p_total, ci_n, co_n, silu, device, st);
  return cudaErrorInvalidValue;
}
