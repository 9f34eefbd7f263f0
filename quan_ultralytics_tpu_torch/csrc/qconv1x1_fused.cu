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
// What bounds it on an H100: with Ci, Co <= 128 a pixel does 4 Ci Co FMAs for
// 4 (Ci + Co) elements moved, about 13 flops a byte at Ci = 64, Co = 16, far below
// the card's ~295, so device memory bounds it: (P 4 Ci + P 4 Co) * itemsize / 3.35 TB/s
// per site. The design has to keep device memory busy: bytes in flight at all times,
// every byte read or written once, in wide coalesced pieces. At the small sites (P =
// 8,192 pixels, up to 64 KB of weights) latency bounds it instead: the weights' load,
// and few tiles a block, so enough warps must share each tile's work.
//
// Two kernels, chosen by dtype (the Python wrapper calls one entry point or the other):
//
// bf16, qconv1x1_mma_kernel (tensor cores, asynchronous copies):
//  - The weights stay in shared memory as bf16 for the block's life, as the four [Co, Ci]
//    component blocks (w's own layout, which is the column-major B operand of
//    mma.m16n8k16.row.col, loaded with ldmatrix), Ci zero-padded as x's staged rows are
//    (below) and Co to a multiple of 8. The per-component form keeps Ci = 128, Co = 64 at
//    68 KB; the folded [4 Ci, 4 Co] weight would be four times that. Where the weights of
//    all of Co pass 72 KB (the wider layers of the s to x models, such as Ci = 256, Co =
//    128), a second grid dimension splits Co into tiles of a multiple of 8 channels, each
//    block holding one tile's weights and reading x once for it; every n-model site keeps
//    all of Co in one block.
//  - Persistent blocks of eight warps walk over tiles of bm pixels (about 16 KB of x, 16 to
//    128 rows) and stream them with cp.async (16-byte pieces; 8 or 4 bytes where Ci is not
//    a multiple of 8) into a ring of two stages in shared memory: the next tile is in flight
//    while the block computes on this one. (A third stage costs more than it gives: it
//    leaves fewer blocks on an SM, and their tiles in flight were worth more, measured on
//    the card at the 21 site shapes.) A staged row keeps each component's Ci elements
//    where Ci is a multiple of 8 (an odd multiple of 8 ends in one m16n8k8 step) and pads
//    them with zeros to a multiple of 16 otherwise (Ci = 12); each row is 16 bytes longer
//    than its data, so the eight 16-byte rows of an ldmatrix hit 32 different banks. An odd
//    Ci (no model has one) is copied an element at a time with plain loads and stores.
//  - A tile's work is split into items of (16 pixels, 8 or 16 output channels) shared
//    round robin by the warps, so a 16-pixel tile of a 64-channel site keeps all eight
//    warps busy. Four mma accumulators per fragment (s_r, s_i, s_j, s_k) share one layout,
//    so each thread holds all four components of the same (pixel, co): the mixing, the
//    affine and the SiLU run in registers in the TPU kernel's order, then one cast to bf16.
//  - The bf16 output tile is staged in shared memory and written to device memory in
//    16-byte coalesced pieces (a tile's rows are contiguous there); with channel tiles, or
//    Co not a multiple of 8, in pieces of 8, 4, 2 or 1 elements, whichever Co and the tile
//    allow.
// bf16 products are exact in f32; only the order of the f32 sums differs from the plain
// version (chunks of 16 along Ci, the last one 8 where Ci is an odd multiple of 8).
//
// f32, qconv1x1_fused_kernel (CUDA cores): TF32 products would miss the f32 tolerance.
// The weights of a tile of output channels stay in shared memory (f32, transposed to
// [4][Ci][co_tile]) for the block's life; each block walks over pixel tiles, read once
// into shared memory with a row pitch of 4 Ci + 1 floats; each thread computes CT
// neighbouring output channels of one pixel for all four components, then the mixing,
// the affine and the SiLU in registers. A block loads, then computes: no copy overlaps
// the math.
//
// Both kernels read x once and write the output once, against the four passes of the
// unfused conv, mixing, IQBN and SiLU.
#include <algorithm>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------- bf16, tensor cores

constexpr int kMmaWarps = 8;            // warps per block
constexpr int kStages = 2;              // x tiles per block in shared memory
constexpr int kTileBytes = 16384;       // target bytes of x per tile
constexpr int kMmaWeightBudget = 72 * 1024;  // bytes of bf16 weights a block, at most
constexpr int kMaxSmem = 227 * 1024;

using bf16 = __nv_bfloat16;

// Elements of a component in a staged row: Ci where it is a multiple of 8 (16-byte pieces,
// ldmatrix rows aligned; an odd multiple ends in one m16n8k8 step), else Ci zero-padded to a
// multiple of 16.
__host__ __device__ int staged_width(int ci_n) { return ci_n % 8 == 0 ? ci_n : (ci_n + 15) & ~15; }

// j / d for j < 4 d without a division: (j ceil(2^32 / d)) >> 32, exact while d < 32768
struct Quarter {
  unsigned long long mul;
  __host__ __device__ explicit Quarter(unsigned d) : mul(((1ull << 32) + d - 1) / d) {}
  __device__ unsigned operator()(unsigned j) const { return static_cast<unsigned>((j * mul) >> 32); }
};

// NT: n-tiles of 8 output channels per work item (1 or 2). Block (bx, by) computes output
// channels [by ct, by ct + cw) of every component, cw = min(ct, Co - by ct), for the pixel
// tiles bx, bx + gridDim.x, ...; ct is Co, or a multiple of 8 where the weights of all of Co
// would not fit the block's shared memory.
template <int NT>
__global__ void __launch_bounds__(32 * kMmaWarps)
qconv1x1_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const float* __restrict__ scale, const float* __restrict__ shift,
                    bf16* __restrict__ out, long long p_total, int ci_n, int co_n, int ct,
                    int bm, int silu) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int co_base = blockIdx.y * ct, cw = min(ct, co_n - co_base);
  const int ck = staged_width(ci_n), cop = (ct + 7) & ~7;
  const int xpitch = 8 * ck + 16;   // bytes per pixel row of an x stage: 4 components of ck
  const int opitch = 8 * cop + 16;  // bytes per pixel row of the output stage: 4 of cop
  const int wpitch = 2 * ck + 16;   // bytes per output channel of a weight block

  unsigned char* ws = smem;  // [4][cop][wpitch]
  float* sc = reinterpret_cast<float*>(smem + 4 * cop * wpitch);  // [4][cop]
  float* sh = sc + 4 * cop;
  unsigned char* xs = smem + 4 * cop * wpitch + 32 * cop;  // [kStages][bm][xpitch]
  unsigned char* os = xs + kStages * bm * xpitch;          // [bm][opitch]

  const long long tiles = (p_total + bm - 1) / bm;
  // x is copied in pieces of `pb` bytes, each inside one component of a row (2: odd Ci,
  // plain loads and stores, since cp.async moves 4 bytes at least)
  const int pb = ci_n % 8 == 0 ? 16 : ci_n % 4 == 0 ? 8 : ci_n % 2 == 0 ? 4 : 2;
  const unsigned ppc = 2 * ci_n / pb, ppr = 4 * ppc;  // pieces a component, a row
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);
  unsigned char* ob = reinterpret_cast<unsigned char*>(out);

  auto rows_of = [&](long long tile) {
    return static_cast<int>(min(static_cast<long long>(bm), p_total - tile * bm));
  };

  // the weights of this block's channels first, in their own copy group
  const int wide = ci_n % 8 == 0 ? 8 : ci_n % 2 == 0 ? 2 : 1;  // elements a copy
  const int per_row = ci_n / wide;
  for (int i = tid; i < 4 * cw * per_row; i += blockDim.x) {
    const int row = i / per_row, c = i - row * per_row;  // row = d * cw + channel
    const int d = row / cw, co = row - d * cw;
    unsigned char* dst = ws + (d * cop + co) * wpitch + c * 2 * wide;
    const bf16* src = w + (static_cast<size_t>(d) * co_n + co_base + co) * ci_n + c * wide;
    if (wide == 8) quan::cp_async16(dst, src);
    else if (wide == 2) quan::cp_async4(dst, src);
    else *reinterpret_cast<bf16*>(dst) = *src;
  }
  quan::cp_async_commit();

  // this thread's pieces of a tile, found without a division each: the first (row,
  // piece of the row), and the step to the next; c = row * ppr + piece
  const unsigned r_first = tid / ppr, j_first = tid % ppr;
  const unsigned r_step = blockDim.x / ppr, j_step = blockDim.x % ppr;
  const unsigned gap = 2 * (ck - ci_n);  // padding bytes after each component of a row
  const Quarter comp_of(ppc);            // piece of a row -> its component
  auto issue = [&](long long tile, int stage) {
    if (tile < tiles) {
      const unsigned np = static_cast<unsigned>(rows_of(tile));
      const unsigned char* src = xb + tile * bm * 8 * ci_n;
      unsigned char* dst = xs + stage * bm * xpitch;
      unsigned r = r_first, j = j_first;
      for (unsigned c = tid; r < np; c += blockDim.x) {
        unsigned char* to = dst + r * xpitch + j * pb + comp_of(j) * gap;
        if (pb == 16) quan::cp_async16(to, src + static_cast<size_t>(c) * 16);
        else if (pb == 8) quan::cp_async8(to, src + static_cast<size_t>(c) * 8);
        else if (pb == 4) quan::cp_async4(to, src + static_cast<size_t>(c) * 4);
        else *reinterpret_cast<bf16*>(to) = *reinterpret_cast<const bf16*>(src + static_cast<size_t>(c) * 2);
        r += r_step;
        j += j_step;
        if (j >= ppr) {
          j -= ppr;
          ++r;
        }
      }
    }
    quan::cp_async_commit();  // an empty group past the end keeps the count uniform
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(blockIdx.x + static_cast<long long>(s) * gridDim.x, s);

  // zeros where no copy writes: weights k >= Ci and channels >= cw, x columns Ci..ck of
  // every component in every stage; then the affine (zero past cw)
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int row = warp; row < 4 * cop; row += kMmaWarps) {
    const int from = row % cop < cw ? ci_n : 0;
    for (int kk = from + lane; kk < ck; kk += 32)
      reinterpret_cast<bf16*>(ws + row * wpitch)[kk] = zero;
  }
  const int pad = ck - ci_n;  // elements of padding a component
  for (int i = tid; i < kStages * bm * 4 * pad; i += blockDim.x) {
    const int rd = i / pad;  // (stage, row) * 4 + d
    reinterpret_cast<bf16*>(xs + (rd >> 2) * xpitch)[(rd & 3) * ck + ci_n + i - rd * pad] = zero;
  }
  for (int i = tid; i < 4 * cop; i += blockDim.x) {
    const int q = i / cop, c = i - q * cop;
    sc[i] = c < cw ? scale[q * co_n + co_base + c] : 0.f;
    sh[i] = c < cw ? shift[q * co_n + co_base + c] : 0.f;
  }

  // work items of a tile: (16-pixel m-tile, group of NT n-tiles), round robin over warps
  // (with NT = 2 the last group may hold one n-tile past cop: its channels are not stored)
  const int mtiles = bm / 16, items = mtiles * ((cop + 8 * NT - 1) / (8 * NT));
  // ldmatrix lane addresses: A rows (lane % 16), k half (lane / 16); B rows (lane % 8),
  // k half ((lane / 8) % 2), n-tile (lane / 16) for NT = 2; for a k8 step, B n-tile
  // ((lane / 8) % 2)
  const int a_off = (lane & 15) * xpitch + (lane >> 4) * 16;
  const int b_off = ((lane & 7) + (NT == 2 ? (lane >> 4) * 8 : 0)) * wpitch + ((lane >> 3) & 1) * 16;
  const int b8_off = ((lane & 7) + (NT == 2 ? ((lane >> 3) & 1) * 8 : 0)) * wpitch;

  // The output stage's rows go out in pieces of pe elements, pieces of a tile walked as x's
  // are. One channel tile of Co a multiple of 8: a tile's rows are contiguous in device
  // memory and in the stage, so 16-byte pieces run along the whole tile. Otherwise each row
  // holds four runs of cw channels, Co apart in device memory.
  const bool whole = cw == co_n && co_n % 8 == 0;
  const int pe = whole ? 8 : co_n % 8 == 0 && cw % 8 == 0 ? 8 : co_n % 4 == 0 && cw % 4 == 0 ? 4
                 : co_n % 2 == 0 && cw % 2 == 0 ? 2 : 1;
  const unsigned opc = cw / pe, opr = 4 * opc;  // pieces a component, a row
  const unsigned o_r0 = tid / opr, o_j0 = tid % opr;
  const unsigned o_rstep = blockDim.x / opr, o_jstep = blockDim.x % opr;
  const Quarter ocomp_of(opc);

  int stage = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    issue(tile + static_cast<long long>(kStages - 1) * gridDim.x, (stage + kStages - 1) % kStages);
    quan::cp_async_wait<kStages - 1>();  // this tile's group (and the weights) have landed
    __syncthreads();
    const int np = rows_of(tile);
    const unsigned char* xt = xs + stage * bm * xpitch;

    for (int it = warp; it < items; it += kMmaWarps) {
      const int m0 = 16 * (it % mtiles), n0 = 8 * NT * (it / mtiles);
      if (m0 >= np) continue;
      float acc[4][NT][4];
#pragma unroll
      for (int d = 0; d < 4; ++d)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[d][nt][e] = 0.f;
      const unsigned char* xa = xt + m0 * xpitch + a_off;
      const unsigned char* wb = ws + n0 * wpitch;
      for (int kc = 0; kc < ck; kc += 16) {
        if (ck - kc >= 16) {
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            uint32_t a[4];
            quan::ldmatrix_x4(a, xa + (d * ck + kc) * 2);
            const unsigned char* wd = wb + b_off + d * cop * wpitch + kc * 2;
            if (NT == 2) {
              uint32_t b[4];
              quan::ldmatrix_x4(b, wd);
              quan::mma_16816(acc[d][0], a[0], a[1], a[2], a[3], b[0], b[1]);
              quan::mma_16816(acc[d][NT - 1], a[0], a[1], a[2], a[3], b[2], b[3]);
            } else {
              uint32_t b[2];
              quan::ldmatrix_x2(b, wd);
              quan::mma_16816(acc[d][0], a[0], a[1], a[2], a[3], b[0], b[1]);
            }
          }
        } else {  // the last 8 of a component: m16n8k8
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            uint32_t a[2];
            quan::ldmatrix_x2(a, xa + (d * ck + kc) * 2);
            const unsigned char* wd = wb + b8_off + d * cop * wpitch + kc * 2;
            if (NT == 2) {
              uint32_t b[2];
              quan::ldmatrix_x2(b, wd);
              quan::mma_1688(acc[d][0], a[0], a[1], b[0]);
              quan::mma_1688(acc[d][NT - 1], a[0], a[1], b[1]);
            } else {
              uint32_t b[1];
              quan::ldmatrix_x1(b, wd);
              quan::mma_1688(acc[d][0], a[0], a[1], b[0]);
            }
          }
        }
      }

      // mixing, affine, SiLU, one cast; into the output stage (a channel cw, where cw is
      // odd, lands in the stage's padding and is not stored)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = n0 + 8 * nt + 2 * t;
        if (col >= cw) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float y[4][2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float sr = acc[0][nt][2 * h + e], si = acc[1][nt][2 * h + e];
            const float sj = acc[2][nt][2 * h + e], sk = acc[3][nt][2 * h + e];
            y[0][e] = sr + si + sj + sk;
            y[1][e] = sr - si - sj + sk;
            y[2][e] = sr + si - sj - sk;
            y[3][e] = sr - si + sj - sk;
          }
          unsigned char* orow = os + (m0 + g + 8 * h) * opitch;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 a = *reinterpret_cast<const float2*>(sc + q * cop + col);
            const float2 b = *reinterpret_cast<const float2*>(sh + q * cop + col);
            float v[2] = {y[q][0] * a.x + b.x, y[q][1] * a.y + b.y};
            if (silu) {
#pragma unroll
              for (int e = 0; e < 2; ++e) v[e] = __fdividef(v[e], 1.f + __expf(-v[e]));
            }
            *reinterpret_cast<uint32_t*>(orow + (q * cop + col) * 2) = quan::pack_bf16(v[0], v[1]);
          }
        }
      }
    }
    __syncthreads();  // the output tile is complete (and this x stage consumed)

    unsigned r = o_r0, j = o_j0;
    if (whole) {  // 16-byte coalesced stores along the tile
      unsigned char* dst = ob + tile * bm * 8 * co_n;
      for (unsigned c = tid; r < static_cast<unsigned>(np); c += blockDim.x) {
        *reinterpret_cast<uint4*>(dst + static_cast<size_t>(c) * 16) =
            *reinterpret_cast<const uint4*>(os + r * opitch + j * 16);
        r += o_rstep;
        j += o_jstep;
        if (j >= opr) {
          j -= opr;
          ++r;
        }
      }
    } else {  // piece j of row r: component q, channels co_base + (j - q opc) pe ...
      bf16* dst = out + tile * bm * 4 * co_n + co_base;
      while (r < static_cast<unsigned>(np)) {
        const unsigned q = ocomp_of(j), e = (j - q * opc) * pe;
        const unsigned char* from = os + r * opitch + (q * cop + e) * 2;
        bf16* to = dst + (static_cast<size_t>(r) * 4 + q) * co_n + e;
        if (pe == 8) *reinterpret_cast<uint4*>(to) = *reinterpret_cast<const uint4*>(from);
        else if (pe == 4) *reinterpret_cast<uint2*>(to) = *reinterpret_cast<const uint2*>(from);
        else if (pe == 2) *reinterpret_cast<uint32_t*>(to) = *reinterpret_cast<const uint32_t*>(from);
        else *to = *reinterpret_cast<const bf16*>(from);
        r += o_rstep;
        j += o_jstep;
        if (j >= opr) {
          j -= opr;
          ++r;
        }
      }
    }
    stage = (stage + 1) % kStages;
  }
  quan::cp_async_wait<0>();
}

// Pixel rows of a tile: about kTileBytes of x, and at least enough 16-row m-tiles that
// every warp has an n-tile of work; 16 to 128.
int mma_rows(int ci_n, int ct) {
  const int ntiles = (ct + 7) / 8;
  const int by_bytes = kTileBytes / (16 * 8 * ci_n);
  const int by_warps = (kMmaWarps + ntiles - 1) / ntiles;
  return 16 * std::max(1, std::min(8, std::max(by_bytes, by_warps)));
}

// Shared memory of a launch: weights, affine, kStages x tiles of bm rows, the output stage.
size_t mma_smem(int ci_n, int ct, int bm) {
  const size_t ck = staged_width(ci_n), cop = (ct + 7) / 8 * 8;
  return 4 * cop * (2 * ck + 16) + 32 * cop + kStages * bm * (8 * ck + 16) +
         static_cast<size_t>(bm) * (8 * cop + 16);
}

// The channel tile ct and the tile's pixel rows bm: all of Co where its weights fit
// kMmaWeightBudget (every site of the n model), else the widest multiple of 8 that does,
// evened out over the tiles; both then narrowed until the block fits the shared memory.
// Returns false where even 8 channels and 16 rows do not fit (Ci beyond about 700).
bool mma_tiles(int ci_n, int co_n, int* ct, int* bm) {
  const int wbytes = 4 * (2 * staged_width(ci_n) + 16);  // weight bytes a channel
  int c = co_n;
  if (static_cast<long long>((co_n + 7) / 8 * 8) * wbytes > kMmaWeightBudget) {
    const int widest = std::max(8, kMmaWeightBudget / wbytes / 8 * 8);
    const int n = (co_n + widest - 1) / widest;
    c = ((co_n + n - 1) / n + 7) / 8 * 8;
  }
  for (; c > 0; c = c > 8 ? (c - 1) / 8 * 8 : 0) {
    for (int rows = mma_rows(ci_n, c); rows >= 16; rows -= 16) {
      if (mma_smem(ci_n, c, rows) <= static_cast<size_t>(kMaxSmem)) {
        *ct = c;
        *bm = rows;
        return true;
      }
    }
  }
  return false;
}

template <int NT>
cudaError_t launch_mma(const void* x, const void* w, const float* scale, const float* shift,
                       void* out, long long p_total, int ci_n, int co_n, int ct, int bm,
                       int silu, int dev, cudaStream_t stream) {
  auto kernel = qconv1x1_mma_kernel<NT>;
  const size_t smem = mma_smem(ci_n, ct, bm);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int sms = 0, resident = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, 32 * kMmaWarps,
                                                           smem)) != cudaSuccess)
    return err;
  const int co_tiles = (co_n + ct - 1) / ct;
  const long long tiles = (p_total + bm - 1) / bm;
  const long long fill = std::max(1LL, static_cast<long long>(sms) * std::max(resident, 1) / co_tiles);
  dim3 grid(static_cast<unsigned>(std::min(tiles, fill)), static_cast<unsigned>(co_tiles));
  kernel<<<grid, 32 * kMmaWarps, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), scale, shift,
      static_cast<bf16*>(out), p_total, ci_n, co_n, ct, bm, silu);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- f32, CUDA cores

constexpr int kThreads = 256;                 // upper bound of threads per block
constexpr int kWeightBudget = 96 * 1024;      // bytes of shared memory for the weight tile
constexpr int kPixelBudget = 64 * 1024;       // bytes of shared memory for the pixel tile

// CT consecutive floats moved as one aligned vector access.
template <int CT>
struct alignas(sizeof(float) * CT) Pack {
  float el[CT];
};

template <int CT>
__global__ void __launch_bounds__(kThreads)
qconv1x1_fused_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ scale, const float* __restrict__ shift,
                      float* __restrict__ out, long long p_total, int ci_n, int co_n, int co_tile,
                      int tp, int silu) {
  extern __shared__ __align__(16) float smem_f[];
  const int k4 = 4 * ci_n;
  const int ldx = k4 + 1;
  float* ws = smem_f;                   // [4][ci_n][co_tile]
  float* xs = smem_f + k4 * co_tile;    // [tp][ldx]
  const int co_base = blockIdx.y * co_tile;

  // weights: read w[d, co_base + col, ci] (contiguous in ci), store transposed
  for (int i = threadIdx.x; i < k4 * co_tile; i += blockDim.x) {
    const int ci = i % ci_n;
    const int rest = i / ci_n;
    const int col = rest % co_tile;
    const int d = rest / co_tile;
    ws[(d * ci_n + ci) * co_tile + col] = w[(static_cast<size_t>(d) * co_n + co_base + col) * ci_n + ci];
  }

  const int ncc = co_tile / CT;
  const int pl = threadIdx.x / ncc;     // pixel within the tile
  const int co0 = (threadIdx.x % ncc) * CT;
  const long long tiles = (p_total + tp - 1) / tp;

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long p0 = tile * tp;
    const int np = static_cast<int>(min(static_cast<long long>(tp), p_total - p0));
    __syncthreads();  // the previous tile is consumed (and, first time, the weights are in)
    const float* xt = x + p0 * k4;
    for (int i = threadIdx.x; i < np * k4; i += blockDim.x) {
      const int r = i / k4;
      xs[r * ldx + (i - r * k4)] = xt[i];
    }
    __syncthreads();
    if (pl >= np) continue;

    float acc[4][CT];
#pragma unroll
    for (int d = 0; d < 4; ++d)
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[d][c] = 0.f;
    const float* xr = xs + pl * ldx;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const float* xd = xr + d * ci_n;
      const float* wd = ws + d * ci_n * co_tile + co0;
#pragma unroll 4
      for (int ci = 0; ci < ci_n; ++ci) {
        const float xv = xd[ci];
        const Pack<CT> wv = *reinterpret_cast<const Pack<CT>*>(wd + ci * co_tile);
#pragma unroll
        for (int c = 0; c < CT; ++c) acc[d][c] = fmaf(xv, wv.el[c], acc[d][c]);
      }
    }

    float* orow = out + (p0 + pl) * 4 * co_n + co_base + co0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      Pack<CT> v;
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const float sr = acc[0][c], si = acc[1][c], sj = acc[2][c], sk = acc[3][c];
        float y;
        if (q == 0) y = sr + si + sj + sk;
        else if (q == 1) y = sr - si - sj + sk;
        else if (q == 2) y = sr + si - sj - sk;
        else y = sr - si + sj - sk;
        const int co = co_base + co0 + c;
        y = y * scale[q * co_n + co] + shift[q * co_n + co];
        if (silu) y = y / (1.f + expf(-y));
        v.el[c] = y;
      }
      *reinterpret_cast<Pack<CT>*>(orow + q * co_n) = v;
    }
  }
}

template <int CT>
cudaError_t launch_f32(const float* x, const float* w, const float* scale, const float* shift,
                       float* out, long long p_total, int ci_n, int co_n, int silu, int dev,
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

  auto kernel = qconv1x1_fused_kernel<CT>;
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
  kernel<<<grid, threads, smem, stream>>>(x, w, scale, shift, out, p_total, ci_n, co_n, co_tile,
                                          tp, silu);
  return cudaGetLastError();
}

}  // namespace

// Both entry points: x: [P, 4 Ci] q-major; w: [4, Co, Ci]; scale, shift: [4, Co] f32; out:
// [P, 4 Co] q-major. x, w and out share the entry point's dtype; everything is contiguous
// and on CUDA device `device`. Return cudaGetLastError() after the launch (0 on success).

// bf16 on the tensor cores, at any Ci up to about 700 and any Co (channel tiles where the
// weights of all of Co do not fit one block: mma_tiles). x and w aligned to 16 bytes where
// Ci is a multiple of 8, else to 8, 4 or 2 as Ci is a multiple of 4, 2 or odd; out to 16.
extern "C" int qconv1x1_mma_bf16(const void* x, const void* w, const void* scale,
                                 const void* shift, void* out, long long p_total, int ci_n,
                                 int co_n, int silu, int device, void* stream) {
  if (p_total <= 0) return cudaSuccess;
  if (ci_n <= 0 || co_n <= 0) return cudaErrorInvalidValue;
  const uintptr_t in_align = ci_n % 8 == 0 ? 16 : ci_n % 4 == 0 ? 8 : ci_n % 2 == 0 ? 4 : 2;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % in_align ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorMisalignedAddress;
  int ct = 0, bm = 0;
  if (!mma_tiles(ci_n, co_n, &ct, &bm)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  // two n-tiles an item where that still gives every warp an item of a tile
  const int cop = (ct + 7) / 8 * 8;
  if (bm / 16 * (cop / 16) >= kMmaWarps)
    return launch_mma<2>(x, w, sc, sh, out, p_total, ci_n, co_n, ct, bm, silu, device, st);
  return launch_mma<1>(x, w, sc, sh, out, p_total, ci_n, co_n, ct, bm, silu, device, st);
}

// f32 on the CUDA cores.
extern "C" int qconv1x1_simt_f32(const void* x, const void* w, const void* scale,
                                 const void* shift, void* out, long long p_total, int ci_n,
                                 int co_n, int silu, int device, void* stream) {
  if (p_total <= 0) return cudaSuccess;
  if (ci_n <= 0 || co_n <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  float* of = static_cast<float*>(out);
  if (co_n % 4 == 0) return launch_f32<4>(xf, wf, sc, sh, of, p_total, ci_n, co_n, silu, device, st);
  if (co_n % 2 == 0) return launch_f32<2>(xf, wf, sc, sh, of, p_total, ci_n, co_n, silu, device, st);
  return launch_f32<1>(xf, wf, sc, sh, of, p_total, ci_n, co_n, silu, device, st);
}
