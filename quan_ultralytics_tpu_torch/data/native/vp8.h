// VP8 (RFC 6386) decoding, shared by the WebP reader (webp.cpp: one key
// frame) and the video reader (video.cpp: a stream of key and inter frames).
//
// The reconstruction is normative, so libwebp, FFmpeg's vp8.c and libvpx give
// the same planes; where the three differ outside the normative part, the
// decoder follows libwebp for a WebP image (Decoder::libwebp) and FFmpeg's
// vp8.c for a video stream, as OpenCV 5.0 decodes each:
//   * the boolean decoder, frame header, segments, loop-filter deltas, 1/2/4/8
//     token partitions and coefficient probability updates;
//   * key frames: intra 16x16, B_PRED 4x4 and chroma prediction with the
//     borders of RFC 6386 (127 above, 129 left, the above-right pixels of the
//     last column repeated from the macroblock above), from the unfiltered
//     reconstruction;
//   * inter frames (RFC 6386 9.7-9.11, 16-18; vp8.c): the reference updates
//     (refresh_golden/alternate_frame, copy_buffer_to_golden/alternate,
//     sign_bias, refresh_last), refresh_entropy_probs = 0 (the probabilities
//     saved and restored after the frame), prob_intra/last/gf, the y/uv mode
//     probability and MV probability updates, intra macroblocks with the fixed
//     inter-frame probabilities, find_near_mvs (nearest, near and best with
//     sign-bias inversion and the mode contexts; near, nearest and best
//     clamped, NEWMV not), MV reading (short tree, long form, the bit above
//     15), SPLITMV (16x8, 8x16, 8x8, 4x4) with the left and above sub-MV
//     contexts, the six-tap filter (profile 0) or the bilinear one (profiles
//     1-3; full-pixel chroma in profile 3), chroma MVs averaged over the four
//     luma sub-MVs with FFmpeg's rounding, prediction beyond the frame edge
//     from repeated border pixels of the macroblock-aligned reference, and the
//     persistence of probabilities, segment map, segment and loop-filter
//     parameters across frames;
//   * the inverse WHT and DCT, libwebp's dequantisation clamps (equal to
//     FFmpeg's), the simple and normal loop filters with per-reference and
//     per-mode deltas and the key/inter frame high-edge-variance thresholds.
// Where the decoders differ: a macroblock's inner edges are filtered when it
// has coefficient tokens (FFmpeg, libvpx) or non-zero coefficients after the
// WHT (libwebp); a key frame's segment header without data is absolute
// (libwebp) or relative (FFmpeg).
//
// The key-frame tables are webp_tables.h's (read from libwebp); the inter-frame
// tables below were held against the bytes of the libavcodec that OpenCV's
// wheel bundles (vp8data.h: the mode contexts, MV default and update
// probabilities, sub-MV probabilities, B_PRED inter probabilities, partition
// maps, six-tap filters and the high-edge-variance table).

#pragma once

#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <cstdlib>
#include <memory>
#include <vector>

#include "webp_tables.h"

namespace vp8 {

// the statuses webp.cpp shares (kOk, kEndOfData, kNotKeyFrame, kBadFrameHeader,
// kBadPartitions, kBadSize), and one of a stream's
enum Status {
  kOk = 0,
  kEndOfData = 1,
  kNotKeyFrame = 5,
  kBadFrameHeader = 6,
  kBadPartitions = 8,
  kBadSize = 10,
  kNoReference = 11,
};

struct BoolDecoder {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 254;  // range - 1
  bool eof = false;

  void init(const uint8_t* start, size_t size) {
    buf = start;
    end = start + size;
    value = 0;
    bits = -8;
    range = 254;
    eof = false;
    load();
  }
  void load() {
    if (buf < end) {
      bits += 8;
      value = (uint64_t)(*buf++) | (value << 8);
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * (uint32_t)prob) >> 8;
    const uint32_t v = (uint32_t)(value >> pos);
    const int b = v > split;
    if (b) {
      r -= split;
      value -= (uint64_t)(split + 1) << pos;
    } else {
      r = split + 1;
    }
    const int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return b;
  }
  int value_bits(int n) {
    int v = 0;
    while (n-- > 0) v |= bit(0x80) << n;
    return v;
  }
  int signed_value(int n) {
    const int v = value_bits(n);
    return bit(0x80) ? -v : v;
  }
};

enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED };
enum { DC_PRED = B_DC_PRED, TM_PRED = B_TM_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED };
enum { DC_NOTOP = 10, DC_NOLEFT, DC_NOTOPLEFT };
// a macroblock's mode: the intra 16x16 modes above, then these
enum { MODE_B_PRED = 4, MODE_ZERO = 5, MODE_MV = 6, MODE_SPLIT = 7 };
enum { SPLIT_16x8 = 0, SPLIT_8x16, SPLIT_8x8, SPLIT_4x4, SPLIT_NONE };

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// inter frames (vp8data.h)
const uint8_t kModeContexts[6][4] = {{7, 1, 1, 143},     {14, 18, 14, 107}, {135, 64, 57, 68},
                                     {60, 56, 128, 65},  {159, 134, 128, 34}, {234, 188, 128, 28}};
const uint8_t kMvUpdateProba[2][19] = {
    {237, 246, 253, 253, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 250, 250, 252, 254, 254},
    {231, 243, 245, 253, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 251, 251, 254, 254, 254}};
const uint8_t kMvDefaultProba[2][19] = {
    {162, 128, 225, 146, 172, 147, 214, 39, 156, 128, 129, 132, 75, 145, 178, 206, 239, 254, 254},
    {164, 128, 204, 170, 119, 235, 140, 230, 228, 128, 130, 130, 74, 148, 180, 203, 236, 254, 254}};
const uint8_t kSubMvProba[5][3] = {{147, 136, 18}, {106, 145, 1}, {179, 121, 1}, {223, 1, 34}, {208, 1, 1}};
const uint8_t kSplitProba[3] = {110, 111, 150};
const uint8_t kBModesProbaInter[9] = {120, 90, 79, 133, 87, 85, 80, 111, 151};
const uint8_t kYModesProbaInter[4] = {112, 86, 140, 37};
const uint8_t kUVModesProbaInter[3] = {162, 101, 204};
const uint8_t kSplits[5][16] = {{0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1},
                                {0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1},
                                {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3},
                                {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
                                {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}};
const uint8_t kSplitCount[4] = {2, 2, 4, 16};
const uint8_t kSplitFirst[4][16] = {
    {0, 8}, {0, 2}, {0, 2, 8, 10}, {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15}};
// taps 0, 2, 3 and 5 add, 1 and 4 subtract (the odd positions are 4-tap)
const uint8_t kSixTap[7][6] = {{0, 6, 123, 12, 1, 0},  {2, 11, 108, 36, 8, 1}, {0, 9, 93, 50, 6, 0},
                               {3, 16, 77, 77, 16, 3}, {0, 6, 50, 93, 9, 0},   {1, 8, 36, 108, 11, 2},
                               {0, 1, 12, 123, 6, 0}};

const int BPS = 32;
const int Y_OFF = BPS * 1 + 8;
const int U_OFF = Y_OFF + BPS * 16 + BPS;
const int V_OFF = U_OFF + 16;

struct MBData {
  int16_t coeffs[384];
  uint8_t is_i4x4, imodes[16], uvmode, segment, skip;
  uint32_t non_zero_y, non_zero_uv;
};

struct FInfo {
  int limit, ilevel, inner, hev_thresh;
};

static inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : (uint8_t)v; }
#define VP8_AVG3(a, b, c) ((uint8_t)(((a) + 2 * (b) + (c) + 2) >> 2))
#define VP8_AVG2(a, b) (((a) + (b) + 1) >> 1)
#define VP8_DST(x, y) dst[(x) + (y) * BPS]

static void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y, dst += BPS)
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + dst[-1] - tl);
}

static void fill(uint8_t* dst, int size, int v) {
  for (int y = 0; y < size; ++y) memset(dst + y * BPS, v, size);
}

static void pred_block(uint8_t* dst, int size, int mode) {  // 16x16 luma or 8x8 chroma
  const int shift = size == 16 ? 4 : 3;
  int dc = 0;
  switch (mode) {
    case DC_PRED:
      for (int i = 0; i < size; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, size, (dc + size) >> (shift + 1));
      break;
    case DC_NOTOP:
      for (int i = 0; i < size; ++i) dc += dst[-1 + i * BPS];
      fill(dst, size, (dc + size / 2) >> shift);
      break;
    case DC_NOLEFT:
      for (int i = 0; i < size; ++i) dc += dst[i - BPS];
      fill(dst, size, (dc + size / 2) >> shift);
      break;
    case DC_NOTOPLEFT:
      fill(dst, size, 0x80);
      break;
    case TM_PRED:
      true_motion(dst, size);
      break;
    case V_PRED:
      for (int y = 0; y < size; ++y) memcpy(dst + y * BPS, dst - BPS, size);
      break;
    case H_PRED:
      for (int y = 0; y < size; ++y) memset(dst + y * BPS, dst[y * BPS - 1], size);
      break;
  }
}

static void pred4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  switch (mode) {
    case B_DC_PRED: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
      fill(dst, 4, dc >> 3);
      break;
    }
    case B_TM_PRED:
      true_motion(dst, 4);
      break;
    case B_VE_PRED: {
      const uint8_t v[4] = {VP8_AVG3(X, A, B), VP8_AVG3(A, B, C), VP8_AVG3(B, C, D), VP8_AVG3(C, D, E)};
      for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, v, 4);
      break;
    }
    case B_HE_PRED:
      memset(dst, VP8_AVG3(X, I, J), 4);
      memset(dst + BPS, VP8_AVG3(I, J, K), 4);
      memset(dst + 2 * BPS, VP8_AVG3(J, K, L), 4);
      memset(dst + 3 * BPS, VP8_AVG3(K, L, L), 4);
      break;
    case B_RD_PRED:
      VP8_DST(0, 3) = VP8_AVG3(J, K, L);
      VP8_DST(1, 3) = VP8_DST(0, 2) = VP8_AVG3(I, J, K);
      VP8_DST(2, 3) = VP8_DST(1, 2) = VP8_DST(0, 1) = VP8_AVG3(X, I, J);
      VP8_DST(3, 3) = VP8_DST(2, 2) = VP8_DST(1, 1) = VP8_DST(0, 0) = VP8_AVG3(A, X, I);
      VP8_DST(3, 2) = VP8_DST(2, 1) = VP8_DST(1, 0) = VP8_AVG3(B, A, X);
      VP8_DST(3, 1) = VP8_DST(2, 0) = VP8_AVG3(C, B, A);
      VP8_DST(3, 0) = VP8_AVG3(D, C, B);
      break;
    case B_LD_PRED:
      VP8_DST(0, 0) = VP8_AVG3(A, B, C);
      VP8_DST(1, 0) = VP8_DST(0, 1) = VP8_AVG3(B, C, D);
      VP8_DST(2, 0) = VP8_DST(1, 1) = VP8_DST(0, 2) = VP8_AVG3(C, D, E);
      VP8_DST(3, 0) = VP8_DST(2, 1) = VP8_DST(1, 2) = VP8_DST(0, 3) = VP8_AVG3(D, E, F);
      VP8_DST(3, 1) = VP8_DST(2, 2) = VP8_DST(1, 3) = VP8_AVG3(E, F, G);
      VP8_DST(3, 2) = VP8_DST(2, 3) = VP8_AVG3(F, G, H);
      VP8_DST(3, 3) = VP8_AVG3(G, H, H);
      break;
    case B_VR_PRED:
      VP8_DST(0, 0) = VP8_DST(1, 2) = VP8_AVG2(X, A);
      VP8_DST(1, 0) = VP8_DST(2, 2) = VP8_AVG2(A, B);
      VP8_DST(2, 0) = VP8_DST(3, 2) = VP8_AVG2(B, C);
      VP8_DST(3, 0) = VP8_AVG2(C, D);
      VP8_DST(0, 3) = VP8_AVG3(K, J, I);
      VP8_DST(0, 2) = VP8_AVG3(J, I, X);
      VP8_DST(0, 1) = VP8_DST(1, 3) = VP8_AVG3(I, X, A);
      VP8_DST(1, 1) = VP8_DST(2, 3) = VP8_AVG3(X, A, B);
      VP8_DST(2, 1) = VP8_DST(3, 3) = VP8_AVG3(A, B, C);
      VP8_DST(3, 1) = VP8_AVG3(B, C, D);
      break;
    case B_VL_PRED:
      VP8_DST(0, 0) = VP8_AVG2(A, B);
      VP8_DST(1, 0) = VP8_DST(0, 2) = VP8_AVG2(B, C);
      VP8_DST(2, 0) = VP8_DST(1, 2) = VP8_AVG2(C, D);
      VP8_DST(3, 0) = VP8_DST(2, 2) = VP8_AVG2(D, E);
      VP8_DST(0, 1) = VP8_AVG3(A, B, C);
      VP8_DST(1, 1) = VP8_DST(0, 3) = VP8_AVG3(B, C, D);
      VP8_DST(2, 1) = VP8_DST(1, 3) = VP8_AVG3(C, D, E);
      VP8_DST(3, 1) = VP8_DST(2, 3) = VP8_AVG3(D, E, F);
      VP8_DST(3, 2) = VP8_AVG3(E, F, G);
      VP8_DST(3, 3) = VP8_AVG3(F, G, H);
      break;
    case B_HD_PRED:
      VP8_DST(0, 0) = VP8_DST(2, 1) = VP8_AVG2(I, X);
      VP8_DST(0, 1) = VP8_DST(2, 2) = VP8_AVG2(J, I);
      VP8_DST(0, 2) = VP8_DST(2, 3) = VP8_AVG2(K, J);
      VP8_DST(0, 3) = VP8_AVG2(L, K);
      VP8_DST(3, 0) = VP8_AVG3(A, B, C);
      VP8_DST(2, 0) = VP8_AVG3(X, A, B);
      VP8_DST(1, 0) = VP8_DST(3, 1) = VP8_AVG3(I, X, A);
      VP8_DST(1, 1) = VP8_DST(3, 2) = VP8_AVG3(J, I, X);
      VP8_DST(1, 2) = VP8_DST(3, 3) = VP8_AVG3(K, J, I);
      VP8_DST(1, 3) = VP8_AVG3(L, K, J);
      break;
    case B_HU_PRED:
      VP8_DST(0, 0) = VP8_AVG2(I, J);
      VP8_DST(2, 0) = VP8_DST(0, 1) = VP8_AVG2(J, K);
      VP8_DST(2, 1) = VP8_DST(0, 2) = VP8_AVG2(K, L);
      VP8_DST(1, 0) = VP8_AVG3(I, J, K);
      VP8_DST(3, 0) = VP8_DST(1, 1) = VP8_AVG3(J, K, L);
      VP8_DST(3, 1) = VP8_DST(1, 2) = VP8_AVG3(K, L, L);
      VP8_DST(3, 2) = VP8_DST(2, 2) = VP8_DST(0, 3) = VP8_DST(1, 3) = VP8_DST(2, 3) = VP8_DST(3, 3) = L;
      break;
  }
}

static inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
static inline int mul2(int a) { return (a * 35468) >> 16; }

static void inverse_dct_add(const int16_t* in, uint8_t* dst) {
  int C[16], *tmp = C;
  for (int i = 0; i < 4; ++i, ++in, tmp += 4) {
    const int a = in[0] + in[8], b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]), d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i, ++tmp, dst += BPS) {
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8], b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]), d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
  }
}

static void inverse_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i, out += 64) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
  }
}

static inline bool block_nonzero(const int16_t* c) {
  for (int i = 0; i < 16; ++i)
    if (c[i]) return true;
  return false;
}

// ---------------------------------------------------------------- loop filter

static inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
static inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

static inline void filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}
static inline void filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}
static inline void filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}
static inline bool hev(const uint8_t* p, int step, int thresh) {
  return std::abs(p[-2 * step] - p[-step]) > thresh || std::abs(p[step] - p[0]) > thresh;
}
static inline bool needs_filter(const uint8_t* p, int step, int t) {
  return 4 * std::abs(p[-step] - p[0]) + std::abs(p[-2 * step] - p[step]) <= t;
}
static inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// ``size`` positions along an edge: hstride crosses it, vstride runs along it
static void simple_edge(uint8_t* p, int hstride, int vstride, int size, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride)
    if (needs_filter(p, hstride, t2)) filter2(p, hstride);
}
static void normal_edge(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh, int hev_t,
                        bool mb_edge) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!needs_filter2(p, hstride, t2, ithresh)) continue;
    if (hev(p, hstride, hev_t)) filter2(p, hstride);
    else if (mb_edge) filter6(p, hstride);
    else filter4(p, hstride);
  }
}

// ---------------------------------------------------------------- tokens

static int get_large_value(BoolDecoder& br, const uint8_t* p) {
  int v;
  if (!br.bit(p[3])) {
    v = !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
  } else if (!br.bit(p[6])) {
    if (!br.bit(p[7])) {
      v = 5 + br.bit(159);
    } else {
      v = 7 + 2 * br.bit(165);
      v += br.bit(145);
    }
  } else {
    const int bit1 = br.bit(p[8]);
    const int bit0 = br.bit(p[9 + bit1]);
    const int cat = 2 * bit1 + bit0;
    v = 0;
    for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
    v += 3 + (8 << cat);
  }
  return v;
}

// libwebp's GetCoeffs: the tokens of one block from position n; returns the
// position after the last token (n itself for an immediate end of block).
static int get_coeffs(BoolDecoder& br, const uint8_t (*type_proba)[3][11], int ctx, const int* dq, int n,
                      int16_t* out) {
  const uint8_t* p = type_proba[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.bit(p[0])) return n;
    while (!br.bit(p[1])) {
      p = type_proba[kBands[++n]][0];
      if (n == 16) return 16;
    }
    int v;
    const uint8_t(*next)[11] = type_proba[kBands[n + 1]];
    if (!br.bit(p[2])) {
      v = 1;
      p = next[1];
    } else {
      v = get_large_value(br, p);
      p = next[2];
    }
    const int s = br.bit(0x80) ? -v : v;
    out[kZigzag[n]] = (int16_t)(s * dq[n > 0]);
  }
  return 16;
}

static inline uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
  return nz_coeffs;
}

struct NZ {
  uint32_t nz = 0, nz_dc = 0;
};

static const int kScan[16] = {0 + 0 * BPS,  4 + 0 * BPS,  8 + 0 * BPS,  12 + 0 * BPS, 0 + 4 * BPS,  4 + 4 * BPS,
                              8 + 4 * BPS,  12 + 4 * BPS, 0 + 8 * BPS,  4 + 8 * BPS,  8 + 8 * BPS,  12 + 8 * BPS,
                              0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};

static inline int check_mode(int mb_x, int mb_y, int mode) {
  if (mode == DC_PRED) {
    if (mb_x == 0) return mb_y == 0 ? (int)DC_NOTOPLEFT : (int)DC_NOLEFT;
    return mb_y == 0 ? (int)DC_NOTOP : (int)DC_PRED;
  }
  return mode;
}

// ---------------------------------------------------------------- motion compensation

// One block of bw x bh predicted from ``src`` (a plane of pw x ph, the
// macroblock-aligned area, its border pixels repeated beyond it) at the
// full-pixel position (x, y) plus (fx, fy) eighths: FFmpeg's put_vp8_epel
// (six-tap, horizontal pass first, each pass rounded and clipped) or
// put_vp8_bilinear; a zero fraction is the identity, as its copy paths are.
static void predict_block(const uint8_t* src, int stride, int pw, int ph, int x, int y, int fx, int fy, int bw,
                          int bh, bool bilinear, uint8_t* dst, int dstride) {
  uint8_t win[21 * 21], pass[21 * 16];
  const int W = bw + 5, H = bh + 5;  // columns x-2 .. x+bw+2, rows y-2 .. y+bh+2
  for (int r = 0; r < H; ++r) {
    int yy = y - 2 + r;
    yy = yy < 0 ? 0 : yy >= ph ? ph - 1 : yy;
    const uint8_t* row = src + (size_t)yy * stride;
    for (int c = 0; c < W; ++c) {
      int xx = x - 2 + c;
      xx = xx < 0 ? 0 : xx >= pw ? pw - 1 : xx;
      win[r * W + c] = row[xx];
    }
  }
  if (bilinear) {
    const int a = 8 - fx, b = fx, c = 8 - fy, d = fy;
    for (int r = 0; r < bh + 1; ++r)
      for (int k = 0; k < bw; ++k) {
        const uint8_t* s = win + (r + 2) * W + k + 2;
        pass[r * bw + k] = (uint8_t)((a * s[0] + b * s[1] + 4) >> 3);
      }
    for (int r = 0; r < bh; ++r)
      for (int k = 0; k < bw; ++k)
        dst[r * dstride + k] = (uint8_t)((c * pass[r * bw + k] + d * pass[(r + 1) * bw + k] + 4) >> 3);
    return;
  }
  for (int r = 0; r < H; ++r)
    for (int k = 0; k < bw; ++k) {
      const uint8_t* s = win + r * W + k + 2;
      if (!fx) {
        pass[r * bw + k] = s[0];
      } else {
        const uint8_t* F = kSixTap[fx - 1];
        pass[r * bw + k] =
            clip8((F[2] * s[0] - F[1] * s[-1] + F[0] * s[-2] + F[3] * s[1] - F[4] * s[2] + F[5] * s[3] + 64) >> 7);
      }
    }
  for (int r = 0; r < bh; ++r)
    for (int k = 0; k < bw; ++k) {
      const uint8_t* s = pass + (r + 2) * bw + k;
      int v;
      if (!fy) {
        v = s[0];
      } else {
        const uint8_t* F = kSixTap[fy - 1];
        v = clip8((F[2] * s[0] - F[1] * s[-bw] + F[0] * s[-2 * bw] + F[3] * s[bw] - F[4] * s[2 * bw] +
                   F[5] * s[3 * bw] + 64) >> 7);
      }
      dst[r * dstride + k] = (uint8_t)v;
    }
}

// ---------------------------------------------------------------- frames

struct Picture {  // macroblock-aligned planes
  int width = 0, height = 0, mb_w = 0, mb_h = 0, ys = 0, uvs = 0;
  std::vector<uint8_t> Y, U, V;
};

struct Probas {
  uint8_t token[4][8][3][11];
  uint8_t ymode[4], uvmode[3];
  uint8_t mvc[2][19];
};

struct MBInfo {  // what neighbouring macroblocks read of one another
  uint8_t ref = 0;  // 0 intra, 1 last, 2 golden, 3 altref
  uint8_t mode = 0;  // DC/TM/V/H_PRED, MODE_B_PRED, MODE_ZERO, MODE_MV, MODE_SPLIT
  uint8_t partitioning = SPLIT_NONE;
  int16_t mv[2] = {0, 0};  // x, y in quarter pixels
  int16_t bmv[16][2] = {};  // by partition
};

static inline uint32_t pack(const int16_t* mv) { return (uint16_t)mv[0] | ((uint32_t)(uint16_t)mv[1] << 16); }

struct Decoder {
  bool libwebp = false;  // libwebp's choices for a WebP image (see the top of this file)
  // what lasts from one frame to the next
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  Probas prob, saved;
  bool seg_enabled = false, seg_update_map = false, seg_absolute = false;
  int seg_quant[4] = {0, 0, 0, 0}, seg_filter[4] = {0, 0, 0, 0};
  uint8_t seg_probs[3] = {255, 255, 255};
  bool lf_delta = false;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  std::shared_ptr<Picture> refs[4];  // [1] last, [2] golden, [3] altref
  std::vector<uint8_t> seg_map;
  // the frame being decoded
  bool key_frame = true, show = true;
  int profile = 0, filter_simple = 0, filter_level = 0, sharpness = 0, filter_type = 0;
  int num_parts = 1;
  BoolDecoder br, parts[8];
  int y1_mat[4][2], y2_mat[4][2], uv_mat[4][2];
  bool skip_enabled = false;
  int skip_p = 0, prob_intra = 0, prob_last = 0, prob_gf = 0;
  int sign_bias[4] = {0, 0, 0, 0};
  int update_golden = 0, update_altref = 0;  // -1 none, 0 current, else the reference copied
  bool update_last = true, update_probas = true;
  std::vector<MBInfo> info;  // (mb_w + 1) x (mb_h + 1), a zero row above and column left
  std::shared_ptr<Picture> cur;

  MBInfo& mbi(int x, int y) { return info[(size_t)(y + 1) * (mb_w + 1) + x + 1]; }

  void reset_probas() {
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p) prob.token[t][b][c][p] = kCoeffsProba0[((t * 8 + b) * 3 + c) * 11 + p];
    memcpy(prob.ymode, kYModesProbaInter, 4);
    memcpy(prob.uvmode, kUVModesProbaInter, 3);
    memcpy(prob.mvc, kMvDefaultProba, sizeof(prob.mvc));
  }

  int ref_to_update(int update, int which) {  // vp8.c ref_to_update: -1 none, 0 current
    if (update) return 0;
    switch (br.value_bits(2)) {
      case 1: return 1;
      case 2: return which == 2 ? 3 : 2;
    }
    return -1;
  }

  int parse_header(const uint8_t* data, size_t n) {
    if (n < 3) return kEndOfData;
    const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
    key_frame = !(bits & 1);
    profile = (bits >> 1) & 7;
    show = (bits >> 4) & 1;
    const uint32_t part0 = bits >> 5;
    if (libwebp) {
      if (!key_frame) return kNotKeyFrame;
      if (profile > 3 || !show) return kBadFrameHeader;
    }
    const uint8_t* buf = data + 3;
    size_t size = n - 3;
    if (key_frame) {
      if (size < 7) return kEndOfData;
      if (buf[0] != 0x9d || buf[1] != 0x01 || buf[2] != 0x2a) return kBadFrameHeader;
      const int w = ((buf[4] << 8) | buf[3]) & 0x3fff, h = ((buf[6] << 8) | buf[5]) & 0x3fff;
      if (w == 0 || h == 0 || (!libwebp && (w > 8192 || h > 8192))) return kBadSize;
      buf += 7;
      size -= 7;
      if (w != width || h != height || info.empty()) {
        width = w;
        height = h;
        mb_w = (w + 15) >> 4;
        mb_h = (h + 15) >> 4;
        seg_map.assign((size_t)mb_w * mb_h, 0);
        for (auto& r : refs) r.reset();
      }
      reset_probas();
      seg_enabled = seg_update_map = false;
      seg_absolute = libwebp;
      memset(seg_quant, 0, sizeof(seg_quant));
      memset(seg_filter, 0, sizeof(seg_filter));
      lf_delta = false;
      memset(ref_lf_delta, 0, sizeof(ref_lf_delta));
      memset(mode_lf_delta, 0, sizeof(mode_lf_delta));
    } else if (!refs[1]) {
      return kNoReference;
    }
    if (part0 > size) return kEndOfData;
    br.init(buf, part0);
    buf += part0;
    size -= part0;
    if (key_frame) {
      br.value_bits(1);  // colour space
      br.value_bits(1);  // clamping type
    }
    // segment header
    seg_enabled = br.bit(0x80);
    seg_update_map = false;
    if (seg_enabled) {
      seg_update_map = br.bit(0x80);
      if (br.bit(0x80)) {
        seg_absolute = br.bit(0x80);
        for (int s = 0; s < 4; ++s) seg_quant[s] = br.bit(0x80) ? br.signed_value(7) : 0;
        for (int s = 0; s < 4; ++s) seg_filter[s] = br.bit(0x80) ? br.signed_value(6) : 0;
      }
      if (seg_update_map)
        for (int s = 0; s < 3; ++s) seg_probs[s] = br.bit(0x80) ? br.value_bits(8) : 255;
    }
    if (br.eof) return kBadFrameHeader;
    // filter header
    filter_simple = br.bit(0x80);
    filter_level = br.value_bits(6);
    sharpness = br.value_bits(3);
    lf_delta = br.bit(0x80);
    if (lf_delta && br.bit(0x80)) {
      for (int i = 0; i < 4; ++i)
        if (br.bit(0x80)) ref_lf_delta[i] = br.signed_value(6);
      for (int i = 0; i < 4; ++i)
        if (br.bit(0x80)) mode_lf_delta[i] = br.signed_value(6);
    }
    filter_type = filter_level == 0 ? 0 : filter_simple ? 1 : 2;
    if (br.eof) return kBadFrameHeader;
    // partitions
    num_parts = 1 << br.value_bits(2);
    const size_t last = num_parts - 1;
    if (size < 3 * last) return kBadPartitions;
    const uint8_t* sz = buf;
    const uint8_t* part_start = buf + last * 3;
    size_t left = size - last * 3;
    for (size_t p = 0; p < last; ++p, sz += 3) {
      size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
      if (psize > left) {
        if (!libwebp) return kBadPartitions;
        psize = left;
      }
      parts[p].init(part_start, psize);
      part_start += psize;
      left -= psize;
    }
    parts[last].init(part_start, left);
    if (part_start >= buf + size) return kBadPartitions;
    // quantisers
    const int base_q0 = br.value_bits(7);
    const int dqy1_dc = br.bit(0x80) ? br.signed_value(4) : 0;
    const int dqy2_dc = br.bit(0x80) ? br.signed_value(4) : 0;
    const int dqy2_ac = br.bit(0x80) ? br.signed_value(4) : 0;
    const int dquv_dc = br.bit(0x80) ? br.signed_value(4) : 0;
    const int dquv_ac = br.bit(0x80) ? br.signed_value(4) : 0;
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int i = 0; i < 4; ++i) {
      int q;
      if (seg_enabled) {
        q = seg_quant[i];
        if (!seg_absolute) q += base_q0;
      } else {
        q = base_q0;
      }
      y1_mat[i][0] = kDcTable[clip(q + dqy1_dc, 127)];
      y1_mat[i][1] = kAcTable[clip(q, 127)];
      y2_mat[i][0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      y2_mat[i][1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
      if (y2_mat[i][1] < 8) y2_mat[i][1] = 8;
      uv_mat[i][0] = kDcTable[clip(q + dquv_dc, 117)];  // FFmpeg: at most 132, kDcTable[117]
      uv_mat[i][1] = kAcTable[clip(q + dquv_ac, 127)];
    }
    if (key_frame) {
      update_golden = update_altref = 0;
    } else {
      const int ug = br.bit(0x80), ua = br.bit(0x80);  // refresh_golden_frame, refresh_alternate_frame
      update_golden = ref_to_update(ug, 2);  // copy_buffer_to_golden
      update_altref = ref_to_update(ua, 3);  // copy_buffer_to_alternate
      sign_bias[2] = br.bit(0x80);
      sign_bias[3] = br.bit(0x80);
    }
    update_probas = br.bit(0x80);  // refresh_entropy_probs
    if (!update_probas) saved = prob;
    update_last = key_frame || br.bit(0x80);
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p)
            if (br.bit(kCoeffsUpdateProba[((t * 8 + b) * 3 + c) * 11 + p])) prob.token[t][b][c][p] = br.value_bits(8);
    skip_enabled = br.bit(0x80);
    skip_p = skip_enabled ? br.value_bits(8) : 0;
    if (!key_frame) {
      prob_intra = br.value_bits(8);
      prob_last = br.value_bits(8);
      prob_gf = br.value_bits(8);
      if (br.bit(0x80))
        for (int i = 0; i < 4; ++i) prob.ymode[i] = br.value_bits(8);
      if (br.bit(0x80))
        for (int i = 0; i < 3; ++i) prob.uvmode[i] = br.value_bits(8);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 19; ++j)
          if (br.bit(kMvUpdateProba[i][j])) {
            const int v = br.value_bits(7) << 1;
            prob.mvc[i][j] = v ? v : 1;
          }
    }
    return br.eof ? kBadFrameHeader : kOk;
  }

  // ---- modes

  int read_mv_component(const uint8_t* p) {  // vp8.c read_mv_component
    int x = 0;
    if (br.bit(p[0])) {
      for (int i = 0; i < 3; ++i) x += br.bit(p[9 + i]) << i;
      for (int i = 9; i > 3; --i) x += br.bit(p[9 + i]) << i;
      if (!(x & 0xFFF0) || br.bit(p[12])) x += 8;
    } else {
      const uint8_t* ps = p + 2;
      int bit = br.bit(*ps);
      ps += 1 + 3 * bit;
      x += 4 * bit;
      bit = br.bit(*ps);
      ps += 1 + bit;
      x += 2 * bit;
      x += br.bit(*ps);
    }
    return (x && br.bit(p[1])) ? -x : x;
  }

  static void clamp_mv(int16_t* dst, const int16_t* src, const int* lo, const int* hi) {
    for (int i = 0; i < 2; ++i) dst[i] = (int16_t)std::max(lo[i], std::min((int)src[i], hi[i]));
  }

  int decode_splitmvs(MBInfo& mb, int mb_x, int mb_y) {  // vp8.c decode_splitmvs; returns the count
    const MBInfo& left_mb = mbi(mb_x - 1, mb_y);
    const MBInfo& top_mb = mbi(mb_x, mb_y - 1);
    const uint8_t* splits_left = kSplits[left_mb.partitioning];
    const uint8_t* splits_top = kSplits[top_mb.partitioning];
    int part;
    if (br.bit(kSplitProba[0]))
      part = br.bit(kSplitProba[1]) ? SPLIT_16x8 + br.bit(kSplitProba[2]) : SPLIT_8x8;
    else
      part = SPLIT_4x4;
    const int num = kSplitCount[part];
    const uint8_t* splits_cur = kSplits[part];
    mb.partitioning = (uint8_t)part;
    for (int n = 0; n < num; ++n) {
      const int k = kSplitFirst[part][n];
      const int16_t* l = !(k & 3) ? left_mb.bmv[splits_left[k + 3]] : mb.bmv[splits_cur[k - 1]];
      const int16_t* a = k <= 3 ? top_mb.bmv[splits_top[k + 12]] : mb.bmv[splits_cur[k - 4]];
      const uint32_t left = pack(l), above = pack(a);
      const uint8_t* p = left == above ? kSubMvProba[4 - !!left] : !above ? kSubMvProba[2] : kSubMvProba[1 - !!left];
      int16_t v[2];
      if (br.bit(p[0])) {
        if (br.bit(p[1])) {
          if (br.bit(p[2])) {
            v[1] = (int16_t)(mb.mv[1] + read_mv_component(prob.mvc[0]));
            v[0] = (int16_t)(mb.mv[0] + read_mv_component(prob.mvc[1]));
          } else {
            v[0] = v[1] = 0;
          }
        } else {
          v[0] = a[0];
          v[1] = a[1];
        }
      } else {
        v[0] = l[0];
        v[1] = l[1];
      }
      mb.bmv[n][0] = v[0];
      mb.bmv[n][1] = v[1];
    }
    return num;
  }

  void decode_mvs(MBInfo& mb, int mb_x, int mb_y) {  // vp8.c vp8_decode_mvs
    const MBInfo* edge[3] = {&mbi(mb_x, mb_y - 1), &mbi(mb_x - 1, mb_y), &mbi(mb_x - 1, mb_y - 1)};
    enum { CNT_ZERO, CNT_NEAREST, CNT_NEAR, CNT_SPLITMV };
    int16_t near_mv[4][2] = {{0, 0}, {0, 0}, {0, 0}, {0, 0}};
    uint8_t cnt[4] = {0, 0, 0, 0};
    int idx = CNT_ZERO;
    const int cur_bias = sign_bias[mb.ref];
    for (int n = 0; n < 3; ++n) {
      const MBInfo& e = *edge[n];
      if (e.ref == 0) continue;
      int16_t mv[2] = {e.mv[0], e.mv[1]};
      if (mv[0] || mv[1]) {
        if (cur_bias != sign_bias[e.ref]) {
          mv[0] = (int16_t)-mv[0];
          mv[1] = (int16_t)-mv[1];
        }
        if (!n || pack(mv) != pack(near_mv[idx])) {
          ++idx;
          near_mv[idx][0] = mv[0];
          near_mv[idx][1] = mv[1];
        }
        cnt[idx] += 1 + (n != 2);
      } else {
        cnt[CNT_ZERO] += 1 + (n != 2);
      }
    }
    const int lo[2] = {-64 - 64 * mb_x, -64 - 64 * mb_y};
    const int hi[2] = {((mb_w - 1) << 6) + 64 - 64 * mb_x, ((mb_h - 1) << 6) + 64 - 64 * mb_y};
    mb.partitioning = SPLIT_NONE;
    if (br.bit(kModeContexts[cnt[CNT_ZERO]][0])) {
      mb.mode = MODE_MV;
      if (cnt[CNT_SPLITMV] && pack(near_mv[1]) == pack(near_mv[3])) cnt[CNT_NEAREST] += 1;
      if (cnt[CNT_NEAR] > cnt[CNT_NEAREST]) {
        std::swap(cnt[CNT_NEAREST], cnt[CNT_NEAR]);
        std::swap(near_mv[CNT_NEAREST][0], near_mv[CNT_NEAR][0]);
        std::swap(near_mv[CNT_NEAREST][1], near_mv[CNT_NEAR][1]);
      }
      if (br.bit(kModeContexts[cnt[CNT_NEAREST]][1])) {
        if (br.bit(kModeContexts[cnt[CNT_NEAR]][2])) {
          clamp_mv(mb.mv, near_mv[CNT_ZERO + (cnt[CNT_NEAREST] >= cnt[CNT_ZERO])], lo, hi);  // best
          cnt[CNT_SPLITMV] = ((edge[1]->mode == MODE_SPLIT) + (edge[0]->mode == MODE_SPLIT)) * 2 +
                             (edge[2]->mode == MODE_SPLIT);
          if (br.bit(kModeContexts[cnt[CNT_SPLITMV]][3])) {
            mb.mode = MODE_SPLIT;
            const int num = decode_splitmvs(mb, mb_x, mb_y);
            mb.mv[0] = mb.bmv[num - 1][0];
            mb.mv[1] = mb.bmv[num - 1][1];
          } else {  // NEWMV: best plus the vector read, not clamped
            mb.mv[1] = (int16_t)(mb.mv[1] + read_mv_component(prob.mvc[0]));
            mb.mv[0] = (int16_t)(mb.mv[0] + read_mv_component(prob.mvc[1]));
            mb.bmv[0][0] = mb.mv[0];
            mb.bmv[0][1] = mb.mv[1];
          }
        } else {
          clamp_mv(mb.mv, near_mv[CNT_NEAR], lo, hi);
          mb.bmv[0][0] = mb.mv[0];
          mb.bmv[0][1] = mb.mv[1];
        }
      } else {
        clamp_mv(mb.mv, near_mv[CNT_NEAREST], lo, hi);
        mb.bmv[0][0] = mb.mv[0];
        mb.bmv[0][1] = mb.mv[1];
      }
    } else {
      mb.mode = MODE_ZERO;
      mb.mv[0] = mb.mv[1] = 0;
      mb.bmv[0][0] = mb.bmv[0][1] = 0;
    }
  }

  int read_bmode(const uint8_t* prob4) {
    const uint8_t* prob = prob4;
    if (!br.bit(prob[0])) return B_DC_PRED;
    if (!br.bit(prob[1])) return B_TM_PRED;
    if (!br.bit(prob[2])) return B_VE_PRED;
    if (!br.bit(prob[3])) return !br.bit(prob[4]) ? B_HE_PRED : (!br.bit(prob[5]) ? B_RD_PRED : B_VR_PRED);
    if (!br.bit(prob[6])) return B_LD_PRED;
    if (!br.bit(prob[7])) return B_VL_PRED;
    return !br.bit(prob[8]) ? B_HD_PRED : B_HU_PRED;
  }

  // the modes of one macroblock from the first partition
  void parse_mode(MBData& mb, MBInfo& m, int mb_x, int mb_y, uint8_t* top, uint8_t* left) {
    uint8_t& seg = seg_map[(size_t)mb_y * mb_w + mb_x];
    if (seg_update_map) {
      seg = !br.bit(seg_probs[0]) ? br.bit(seg_probs[1]) : br.bit(seg_probs[2]) + 2;
    } else if (libwebp) {
      seg = 0;
    }
    mb.segment = seg_enabled ? seg : 0;
    mb.skip = skip_enabled ? br.bit(skip_p) : 0;
    m.partitioning = SPLIT_NONE;
    if (key_frame) {
      m.ref = 0;
      mb.is_i4x4 = !br.bit(145);
      if (!mb.is_i4x4) {
        const int ymode = br.bit(156) ? (br.bit(128) ? TM_PRED : H_PRED) : (br.bit(163) ? V_PRED : DC_PRED);
        mb.imodes[0] = ymode;
        memset(top, ymode, 4);
        memset(left, ymode, 4);
        m.mode = ymode;
      } else {
        uint8_t* modes = mb.imodes;
        for (int y = 0; y < 4; ++y) {
          int ymode = left[y];
          for (int x = 0; x < 4; ++x) {
            ymode = read_bmode(kBModesProba + (top[x] * 10 + ymode) * 9);
            top[x] = ymode;
          }
          memcpy(modes, top, 4);
          modes += 4;
          left[y] = ymode;
        }
        m.mode = MODE_B_PRED;
      }
      mb.uvmode = !br.bit(142) ? DC_PRED : !br.bit(114) ? V_PRED : br.bit(183) ? TM_PRED : H_PRED;
    } else if (br.bit(prob_intra)) {
      m.ref = br.bit(prob_last) ? (br.bit(prob_gf) ? 3 : 2) : 1;
      decode_mvs(m, mb_x, mb_y);
      mb.is_i4x4 = 0;
    } else {
      m.ref = 0;
      const uint8_t* p = prob.ymode;
      int ymode;
      if (!br.bit(p[0])) ymode = DC_PRED;
      else if (!br.bit(p[1])) ymode = br.bit(p[2]) ? H_PRED : V_PRED;
      else ymode = br.bit(p[3]) ? (int)MODE_B_PRED : (int)TM_PRED;
      m.mode = (uint8_t)ymode;
      mb.is_i4x4 = ymode == MODE_B_PRED;
      if (mb.is_i4x4) {
        for (int k = 0; k < 16; ++k) mb.imodes[k] = (uint8_t)read_bmode(kBModesProbaInter);
      } else {
        mb.imodes[0] = (uint8_t)ymode;
      }
      const uint8_t* q = prob.uvmode;
      mb.uvmode = !br.bit(q[0]) ? DC_PRED : !br.bit(q[1]) ? V_PRED : br.bit(q[2]) ? TM_PRED : H_PRED;
      m.mv[0] = m.mv[1] = 0;
      m.bmv[0][0] = m.bmv[0][1] = 0;
    }
  }

  // libwebp's ParseResiduals; *tokens is whether any block had a token;
  // returns whether no coefficient is non-zero (after the WHT)
  int parse_residuals(BoolDecoder& tbr, MBData& mb, bool has_y2, NZ& top, NZ& left, bool* tokens) {
    const int seg = mb.segment;
    int16_t* dst = mb.coeffs;
    memset(dst, 0, sizeof(mb.coeffs));
    int first;
    const uint8_t(*ac_proba)[3][11];
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    bool any = false;
    if (has_y2) {
      int16_t dc[16] = {0};
      const int ctx = top.nz_dc + left.nz_dc;
      const int nz = get_coeffs(tbr, prob.token[1], ctx, y2_mat[seg], 0, dc);
      top.nz_dc = left.nz_dc = nz > 0;
      any |= nz > 0;
      inverse_wht(dc, dst);
      first = 1;
      ac_proba = prob.token[0];
    } else {
      first = 0;
      ac_proba = prob.token[3];
    }
    uint32_t tnz = top.nz & 0x0f, lnz = left.nz & 0x0f;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      uint32_t nz_coeffs = 0;
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(tbr, ac_proba, ctx, y1_mat[seg], first, dst);
        l = nz > first;
        any |= l;
        tnz = (tnz >> 1) | (l << 7);
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 4;
      lnz = (lnz >> 1) | (l << 7);
      non_zero_y = (non_zero_y << 8) | nz_coeffs;
    }
    uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t nz_coeffs = 0;
      tnz = top.nz >> (4 + ch);
      lnz = left.nz >> (4 + ch);
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + (tnz & 1);
          const int nz = get_coeffs(tbr, prob.token[2], ctx, uv_mat[seg], 0, dst);
          l = nz > 0;
          any |= l;
          tnz = (tnz >> 1) | (l << 3);
          nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
          dst += 16;
        }
        tnz >>= 2;
        lnz = (lnz >> 1) | (l << 5);
      }
      non_zero_uv |= nz_coeffs << (4 * ch);
      out_t_nz |= (tnz << 4) << ch;
      out_l_nz |= (lnz & 0xf0) << ch;
    }
    top.nz = out_t_nz;
    left.nz = out_l_nz;
    mb.non_zero_y = non_zero_y;
    mb.non_zero_uv = non_zero_uv;
    *tokens = any;
    return !(non_zero_y | non_zero_uv);
  }

  FInfo filter_info(const MBData& mb, const MBInfo& m, bool coded) const {  // vp8.c filter_level_for_mb
    int level = filter_level;
    if (seg_enabled) {
      level = seg_filter[mb.segment];
      if (!seg_absolute) level += filter_level;
    }
    if (lf_delta) {
      level += ref_lf_delta[m.ref];
      if (m.mode >= MODE_B_PRED) level += mode_lf_delta[m.mode - MODE_B_PRED];
    }
    level = level < 0 ? 0 : level > 63 ? 63 : level;
    FInfo fi = {0, 0, 0, 0};
    if (level > 0) {
      int ilevel = level;
      if (sharpness > 0) {
        ilevel >>= sharpness > 4 ? 2 : 1;
        if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
      }
      if (ilevel < 1) ilevel = 1;
      fi.ilevel = ilevel;
      fi.limit = 2 * level + ilevel;
      fi.hev_thresh = key_frame ? (level >= 40 ? 2 : level >= 15 ? 1 : 0)
                                : (level >= 40 ? 3 : level >= 20 ? 2 : level >= 15 ? 1 : 0);
    }
    fi.inner = coded || m.mode == MODE_B_PRED || m.mode == MODE_SPLIT;
    return fi;
  }

  // vp8.c inter_predict, into the work buffer
  void inter_predict(const MBInfo& m, int mb_x, int mb_y, uint8_t* y_dst, uint8_t* u_dst, uint8_t* v_dst) {
    const Picture& r = *refs[m.ref];
    const bool bil = profile != 0;
    const int pw = 16 * mb_w, ph = 16 * mb_h;
    auto luma = [&](const int16_t* mv, int bx, int by, int bw, int bh) {
      predict_block(r.Y.data(), r.ys, pw, ph, mb_x * 16 + bx + (mv[0] >> 2), mb_y * 16 + by + (mv[1] >> 2),
                    (mv[0] * 2) & 7, (mv[1] * 2) & 7, bw, bh, bil, y_dst + by * BPS + bx, BPS);
    };
    auto chroma = [&](int mvx, int mvy, int bx, int by, int bw, int bh) {
      if (profile == 3) {
        mvx &= ~7;
        mvy &= ~7;
      }
      const int x = mb_x * 8 + bx + (mvx >> 3), y = mb_y * 8 + by + (mvy >> 3);
      predict_block(r.U.data(), r.uvs, pw >> 1, ph >> 1, x, y, mvx & 7, mvy & 7, bw, bh, bil, u_dst + by * BPS + bx,
                    BPS);
      predict_block(r.V.data(), r.uvs, pw >> 1, ph >> 1, x, y, mvx & 7, mvy & 7, bw, bh, bil, v_dst + by * BPS + bx,
                    BPS);
    };
    auto part = [&](const int16_t* mv, int bx, int by, int bw, int bh) {  // vp8_mc_part
      luma(mv, bx, by, bw, bh);
      chroma(mv[0], mv[1], bx >> 1, by >> 1, bw >> 1, bh >> 1);
    };
    switch (m.partitioning) {
      case SPLIT_NONE:
        part(m.mv, 0, 0, 16, 16);
        break;
      case SPLIT_16x8:
        part(m.bmv[0], 0, 0, 16, 8);
        part(m.bmv[1], 0, 8, 16, 8);
        break;
      case SPLIT_8x16:
        part(m.bmv[0], 0, 0, 8, 16);
        part(m.bmv[1], 8, 0, 8, 16);
        break;
      case SPLIT_8x8:
        part(m.bmv[0], 0, 0, 8, 8);
        part(m.bmv[1], 8, 0, 8, 8);
        part(m.bmv[2], 0, 8, 8, 8);
        part(m.bmv[3], 8, 8, 8, 8);
        break;
      default:  // 4x4: chroma from the average of each 2x2 group, rounded away from zero
        for (int y = 0; y < 4; ++y)
          for (int x = 0; x < 4; ++x) luma(m.bmv[4 * y + x], 4 * x, 4 * y, 4, 4);
        for (int y = 0; y < 2; ++y)
          for (int x = 0; x < 2; ++x) {
            int s[2];
            for (int c = 0; c < 2; ++c) {
              s[c] = m.bmv[2 * y * 4 + 2 * x][c] + m.bmv[2 * y * 4 + 2 * x + 1][c] +
                     m.bmv[(2 * y + 1) * 4 + 2 * x][c] + m.bmv[(2 * y + 1) * 4 + 2 * x + 1][c];
              s[c] = (s[c] + 2 + (s[c] >> 31)) >> 2;
            }
            chroma((int16_t)s[0], (int16_t)s[1], 4 * x, 4 * y, 4, 4);
          }
    }
  }

  void loop_filter(Picture& p, const std::vector<FInfo>& finfo) {
    const int ys = p.ys, uvs = p.uvs;
    for (int mb_y = 0; mb_y < mb_h; ++mb_y)
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        const FInfo& fi = finfo[(size_t)mb_y * mb_w + mb_x];
        const int limit = fi.limit;
        if (limit == 0) continue;
        uint8_t* yp = &p.Y[(size_t)mb_y * 16 * ys + mb_x * 16];
        if (filter_type == 1) {
          if (mb_x > 0) simple_edge(yp, 1, ys, 16, limit + 4);
          if (fi.inner)
            for (int k = 1; k <= 3; ++k) simple_edge(yp + 4 * k, 1, ys, 16, limit);
          if (mb_y > 0) simple_edge(yp, ys, 1, 16, limit + 4);
          if (fi.inner)
            for (int k = 1; k <= 3; ++k) simple_edge(yp + 4 * k * ys, ys, 1, 16, limit);
        } else {
          uint8_t* up = &p.U[(size_t)mb_y * 8 * uvs + mb_x * 8];
          uint8_t* vp = &p.V[(size_t)mb_y * 8 * uvs + mb_x * 8];
          const int il = fi.ilevel, ht = fi.hev_thresh;
          if (mb_x > 0) {
            normal_edge(yp, 1, ys, 16, limit + 4, il, ht, true);
            normal_edge(up, 1, uvs, 8, limit + 4, il, ht, true);
            normal_edge(vp, 1, uvs, 8, limit + 4, il, ht, true);
          }
          if (fi.inner) {
            for (int k = 1; k <= 3; ++k) normal_edge(yp + 4 * k, 1, ys, 16, limit, il, ht, false);
            normal_edge(up + 4, 1, uvs, 8, limit, il, ht, false);
            normal_edge(vp + 4, 1, uvs, 8, limit, il, ht, false);
          }
          if (mb_y > 0) {
            normal_edge(yp, ys, 1, 16, limit + 4, il, ht, true);
            normal_edge(up, uvs, 1, 8, limit + 4, il, ht, true);
            normal_edge(vp, uvs, 1, 8, limit + 4, il, ht, true);
          }
          if (fi.inner) {
            for (int k = 1; k <= 3; ++k) normal_edge(yp + 4 * k * ys, ys, 1, 16, limit, il, ht, false);
            normal_edge(up + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
            normal_edge(vp + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
          }
        }
      }
  }

  // Decode one frame into ``cur`` and update the references; ``show`` tells
  // whether it is displayed.
  int decode(const uint8_t* data, size_t n) {
    int st = parse_header(data, n);
    if (st) return st;
    auto pic = std::make_shared<Picture>();
    Picture& out = *pic;
    const int ys = mb_w * 16, uvs = mb_w * 8;
    out.width = width;
    out.height = height;
    out.mb_w = mb_w;
    out.mb_h = mb_h;
    out.ys = ys;
    out.uvs = uvs;
    std::vector<uint8_t>& Y = out.Y;
    std::vector<uint8_t>& U = out.U;
    std::vector<uint8_t>& V = out.V;
    Y.assign((size_t)ys * mb_h * 16, 0);
    U.assign((size_t)uvs * mb_h * 8, 0);
    V.assign((size_t)uvs * mb_h * 8, 0);
    info.assign((size_t)(mb_w + 1) * (mb_h + 1), MBInfo());
    for (auto& m : info) m.partitioning = SPLIT_16x8;  // FFmpeg's zeroed border macroblocks
    std::vector<FInfo> finfo((size_t)mb_w * mb_h);
    std::vector<uint8_t> intra_t(4 * mb_w, B_DC_PRED);
    std::vector<NZ> nz_top(mb_w);
    std::vector<uint8_t> top_y(16 * mb_w), top_u(8 * mb_w), top_v(8 * mb_w);
    std::vector<MBData> row(mb_w);
    uint8_t yuv_b[BPS * 17 + BPS * 9];
    memset(yuv_b, 0, sizeof(yuv_b));
    uint8_t* const y_dst = yuv_b + Y_OFF;
    uint8_t* const u_dst = yuv_b + U_OFF;
    uint8_t* const v_dst = yuv_b + V_OFF;
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
      uint8_t intra_l[4] = {B_DC_PRED, B_DC_PRED, B_DC_PRED, B_DC_PRED};
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) parse_mode(row[mb_x], mbi(mb_x, mb_y), mb_x, mb_y, &intra_t[4 * mb_x], intra_l);
      if (br.eof) return kEndOfData;
      BoolDecoder& tbr = parts[mb_y & (num_parts - 1)];
      NZ nz_left;
      // reconstruct the row (libwebp's ReconstructRow)
      for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
      for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
      if (mb_y > 0) {
        y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
      } else {
        memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
        memset(u_dst - BPS - 1, 127, 8 + 1);
        memset(v_dst - BPS - 1, 127, 8 + 1);
      }
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        MBData& mb = row[mb_x];
        const MBInfo& m = mbi(mb_x, mb_y);
        const bool has_y2 = m.mode != MODE_B_PRED && m.mode != MODE_SPLIT;
        int skip = mb.skip;
        bool tokens = false;
        if (!skip) {
          skip = parse_residuals(tbr, mb, has_y2, nz_top[mb_x], nz_left, &tokens);
        } else {
          nz_left.nz = nz_top[mb_x].nz = 0;
          if (has_y2) nz_left.nz_dc = nz_top[mb_x].nz_dc = 0;
          mb.non_zero_y = mb.non_zero_uv = 0;
          memset(mb.coeffs, 0, sizeof(mb.coeffs));
        }
        if (filter_type > 0) finfo[(size_t)mb_y * mb_w + mb_x] = filter_info(mb, m, libwebp ? !skip : tokens);
        if (tbr.eof) return kEndOfData;
        if (mb_x > 0) {
          for (int j = -1; j < 16; ++j) memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
          for (int j = -1; j < 8; ++j) {
            memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
            memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
          }
        }
        if (mb_y > 0) {
          memcpy(y_dst - BPS, &top_y[16 * mb_x], 16);
          memcpy(u_dst - BPS, &top_u[8 * mb_x], 8);
          memcpy(v_dst - BPS, &top_v[8 * mb_x], 8);
        }
        const int16_t* coeffs = mb.coeffs;
        if (m.ref) {
          inter_predict(m, mb_x, mb_y, y_dst, u_dst, v_dst);
          for (int k = 0; k < 16; ++k)
            if (block_nonzero(coeffs + k * 16)) inverse_dct_add(coeffs + k * 16, y_dst + kScan[k]);
        } else if (mb.is_i4x4) {
          uint8_t* top_right = y_dst - BPS + 16;
          if (mb_y > 0) {
            if (mb_x >= mb_w - 1) memset(top_right, top_y[16 * mb_x + 15], 4);
            else memcpy(top_right, &top_y[16 * (mb_x + 1)], 4);
          }
          for (int k = 1; k <= 3; ++k) memcpy(top_right + k * 4 * BPS, top_right, 4);
          for (int k = 0; k < 16; ++k) {
            uint8_t* dst = y_dst + kScan[k];
            pred4(dst, mb.imodes[k]);
            if (block_nonzero(coeffs + k * 16)) inverse_dct_add(coeffs + k * 16, dst);
          }
        } else {
          pred_block(y_dst, 16, check_mode(mb_x, mb_y, mb.imodes[0]));
          for (int k = 0; k < 16; ++k)
            if (block_nonzero(coeffs + k * 16)) inverse_dct_add(coeffs + k * 16, y_dst + kScan[k]);
        }
        if (!m.ref) {
          const int uv_mode = check_mode(mb_x, mb_y, mb.uvmode);
          pred_block(u_dst, 8, uv_mode);
          pred_block(v_dst, 8, uv_mode);
        }
        for (int k = 0; k < 4; ++k) {
          const int off = (k & 1) * 4 + (k >> 1) * 4 * BPS;
          if (block_nonzero(coeffs + (16 + k) * 16)) inverse_dct_add(coeffs + (16 + k) * 16, u_dst + off);
          if (block_nonzero(coeffs + (20 + k) * 16)) inverse_dct_add(coeffs + (20 + k) * 16, v_dst + off);
        }
        if (mb_y < mb_h - 1) {
          memcpy(&top_y[16 * mb_x], y_dst + 15 * BPS, 16);
          memcpy(&top_u[8 * mb_x], u_dst + 7 * BPS, 8);
          memcpy(&top_v[8 * mb_x], v_dst + 7 * BPS, 8);
        }
        for (int j = 0; j < 16; ++j) memcpy(&Y[(size_t)(mb_y * 16 + j) * ys + mb_x * 16], y_dst + j * BPS, 16);
        for (int j = 0; j < 8; ++j) {
          memcpy(&U[(size_t)(mb_y * 8 + j) * uvs + mb_x * 8], u_dst + j * BPS, 8);
          memcpy(&V[(size_t)(mb_y * 8 + j) * uvs + mb_x * 8], v_dst + j * BPS, 8);
        }
      }
    }
    // loop filter, macroblocks in raster order (libwebp's DoFilter, vp8.c filter_mb)
    if (filter_type > 0) loop_filter(out, finfo);
    // the references (vp8.c: from the references before this frame)
    std::shared_ptr<Picture> old[4] = {pic, refs[1], refs[2], refs[3]};
    if (update_altref >= 0) refs[3] = old[update_altref];
    if (update_golden >= 0) refs[2] = old[update_golden];
    if (update_last) refs[1] = pic;
    if (!update_probas) prob = saved;
    cur = pic;
    return kOk;
  }
};

}  // namespace vp8
