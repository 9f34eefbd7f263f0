// VP9 profile 0 decoding (8-bit 4:2:0) for the video reader (video.cpp), as
// FFmpeg's native vp9 decoder (libavcodec/vp9*.c) decodes a stream, which is
// what OpenCV 5.0's FFmpeg capture runs. VP9's reconstruction is normative,
// so the planes equal libvpx's and the VP9 Bitstream Specification's too;
// where FFmpeg's bookkeeping differs from the specification's outside the
// normative part, FFmpeg's is followed (sign biases read as 0 in
// error-resilient frames, the frame context an intra-only frame loads, which
// segmentation map and which frame's motion vectors the next frame predicts
// from, the previous frame's visibility after show_existing_frame).
//
//   * superframes split at their index (vp9_superframe_split_bsf.c), each
//     frame decoded in turn; show_existing_frame gives the frame in that
//     slot again and decodes nothing; hidden frames give no frame;
//   * the uncompressed header (vp9.c decode_frame_header) and the
//     compressed one: tx_mode, coefficient, skip, inter-mode, filter,
//     is-inter, reference, y-mode, partition and MV probability updates;
//     four saved frame contexts reset by key, intra-only and error-resilient
//     frames as reset_frame_context says;
//   * the boolean decoder of libavcodec's vpx_rac.h: VP8's arithmetic, but
//     not vp8.h's reader, which is libwebp's and stops shifting in data at
//     its end, where FFmpeg's 16-bit refill reads on into the next tile's
//     bytes and then zeros;
//   * tiles (columns and rows, each with its own decoder), the partition
//     tree down to 4x4 with its contexts, segment ids (explicit, predicted,
//     the map kept across frames), skip, tx_size, is-inter, the intra modes
//     with the key-frame probabilities of their neighbours, references
//     (single and compound), find_ref_mvs with FFmpeg's sub-8x8 rules,
//     NEAREST/NEAR/ZERO/NEWMV and the MV joint, class and bit trees;
//   * tokens with their band and neighbour contexts at 4x4 to 32x32, the
//     default, column and row scans, dequantisation (32x32 halved), the
//     inverse DCT/ADST 4-32 and WHT with the reference arithmetic and 16-bit
//     storage between the passes, as FFmpeg's C version;
//   * intra prediction of the ten modes at every size with VP9's edges (127
//     above and 129 left outside the picture, pixels beyond the 8-aligned
//     edge repeated, the above-right of 4x4 blocks only inside their block);
//   * inter prediction with the regular, smooth and sharp 8-tap filters and
//     bilinear, 1/8-pel luma and 1/16-pel chroma, compound averaging,
//     sub-8x8 chroma MVs averaged, references read with their edges
//     repeated (FFmpeg's emulated_edge_mc);
//   * the loop filter of libvpx's masks (vp9_loopfilter.c, which FFmpeg's
//     vp9lpf reproduces): levels from segment, reference and mode deltas,
//     the 4-, 8- and 16-wide filters on block and transform edges, columns
//     then rows in each 64x64 superblock in raster order;
//   * backward adaptation of the coefficient, mode and MV probabilities
//     (vp9prob.c).
// Profiles 1-3, and references of another size than the frame (scaled
// motion compensation), are refused with a message that names them.
//
// The constant tables are vp9_tables.h's (the bytes of the libavcodec that
// OpenCV's wheel bundles).

#pragma once

#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <cstdlib>
#include <memory>
#include <string>
#include <vector>

#include "vp9_tables.h"

namespace vp9 {

enum Status { kOk = 0, kUnsupported = 2, kDamaged = 3 };

// intra modes in FFmpeg's order, then the inter modes
enum { VERT = 0, HOR, DC, D45, D135, D117, D153, D63, D207, TM, NEARESTMV, NEARMV, ZEROMV, NEWMV };
// DC variants that the edge rules substitute
enum { LEFT_DC = 14, TOP_DC, DC_128 };
// FFmpeg's transform types: DCT_ADST is an ADST on the first (horizontal) pass
enum { DCT_DCT = 0, DCT_ADST, ADST_DCT, ADST_ADST };
enum { TX_4X4 = 0, TX_8X8, TX_16X16, TX_32X32, TX_SWITCHABLE };
// FFmpeg's block sizes: bs = level * 3 + partition for NONE, H and V
enum { BS_64x64 = 0, BS_64x32, BS_32x64, BS_32x32, BS_32x16, BS_16x32, BS_16x16, BS_16x8, BS_8x16, BS_8x8,
       BS_8x4, BS_4x8, BS_4x4 };
enum { PARTITION_NONE = 0, PARTITION_H, PARTITION_V, PARTITION_SPLIT };
// libvpx's filter numbering (the switchable tree's symbols); the frame-level literal maps onto it
enum { FILTER_REGULAR = 0, FILTER_SMOOTH, FILTER_SHARP, FILTER_BILINEAR, FILTER_SWITCHABLE };
// libvpx's reference numbering
enum { NONE_FRAME = -1, INTRA_FRAME = 0, LAST_FRAME, GOLDEN_FRAME, ALTREF_FRAME };
enum { PRED_SINGLE = 0, PRED_COMPOUND, PRED_SWITCHABLE };

// the tools a stream used (Decoder::stats), read by tests to tell which a stream reaches
enum Stat {
  ST_KEY_FRAMES, ST_INTER_FRAMES, ST_INTRA_ONLY_FRAMES, ST_HIDDEN_FRAMES, ST_SHOW_EXISTING, ST_SUPERFRAMES,
  ST_TX4, ST_TX8, ST_TX16, ST_TX32, ST_DCT_DCT, ST_DCT_ADST, ST_ADST_DCT, ST_ADST_ADST, ST_WHT,
  ST_MODE_V, ST_MODE_H, ST_MODE_DC, ST_MODE_D45, ST_MODE_D135, ST_MODE_D117, ST_MODE_D153, ST_MODE_D63,
  ST_MODE_D207, ST_MODE_TM, ST_FILTER_REGULAR, ST_FILTER_SMOOTH, ST_FILTER_SHARP, ST_FILTER_BILINEAR,
  ST_COMPOUND, ST_SUB8X8, ST_NEWMV, ST_MULTI_TILE_FRAMES, ST_SEGMENTED_FRAMES, ST_LOSSLESS_FRAMES,
  ST_ADAPTED_FRAMES, ST_LOOP_FILTERED_FRAMES, ST_PREV_FRAME_MVS, ST_ERROR_RESILIENT_FRAMES, ST_FULL_RANGE_FRAMES,
  ST_COUNT
};

struct Mv {
  int16_t x = 0, y = 0;
};
inline bool operator==(Mv a, Mv b) { return a.x == b.x && a.y == b.y; }
inline bool operator!=(Mv a, Mv b) { return !(a == b); }

// FFmpeg's ProbContext, byte for byte (kDefaultProbs)
struct Probs {
  uint8_t y_mode[4][9];
  uint8_t uv_mode[10][9];
  uint8_t filter[4][2];
  uint8_t mv_mode[7][3];
  uint8_t intra[4];
  uint8_t comp[5];
  uint8_t single_ref[5][2];
  uint8_t comp_ref[5];
  uint8_t tx32p[2][3];
  uint8_t tx16p[2][2];
  uint8_t tx8p[2];
  uint8_t skip[3];
  uint8_t mv_joint[3];
  struct {
    uint8_t sign, classes[10], class0, bits[10], class0_fp[2][3], fp[3], class0_hp, hp;
  } mv_comp[2];
  uint8_t partition[4][4][3];
};
static_assert(sizeof(Probs) == sizeof(kDefaultProbs), "Probs is FFmpeg's ProbContext");

struct FrameContext {
  Probs p;
  uint8_t coef[4][2][2][6][6][3];
};

struct Counts {
  unsigned y_mode[4][10], uv_mode[10][10], filter[4][3], mv_mode[7][4], intra[4][2], comp[5][2],
      single_ref[5][2][2], comp_ref[5][2], tx32p[2][4], tx16p[2][3], tx8p[2][2], skip[3][2], mv_joint[4];
  struct {
    unsigned sign[2], classes[11], class0[2], bits[10][2], class0_fp[2][4], fp[4], class0_hp[2], hp[2];
  } mv_comp[2];
  unsigned partition[4][4][4];
  unsigned coef[4][2][2][6][6][3];
  unsigned eob[4][2][2][6][6][2];
};

// ---- trees (FFmpeg's [node][branch] form; a value <= 0 is a leaf) -------------

const int8_t kIntraModeTree[9][2] = {{-DC, 1}, {-TM, 2}, {-VERT, 3}, {4, 6}, {-HOR, 5},
                                     {-D135, -D117}, {-D45, 7}, {-D63, 8}, {-D153, -D207}};
const int8_t kInterModeTree[3][2] = {{-(ZEROMV - NEARESTMV), 1}, {0, 2}, {-(NEARMV - NEARESTMV), -(NEWMV - NEARESTMV)}};
const int8_t kPartitionTree[3][2] = {{-PARTITION_NONE, 1}, {-PARTITION_H, 2}, {-PARTITION_V, -PARTITION_SPLIT}};
const int8_t kSegmentTree[7][2] = {{1, 2}, {3, 4}, {5, 6}, {0, -1}, {-2, -3}, {-4, -5}, {-6, -7}};
const int8_t kMvJointTree[3][2] = {{0, 1}, {-1, 2}, {-2, -3}};
const int8_t kMvClassTree[10][2] = {{0, 1}, {-1, 2}, {3, 4}, {-2, -3}, {5, 6}, {-4, -5}, {-6, 7}, {8, 9}, {-7, -8}, {-9, -10}};
const int8_t kMvFpTree[3][2] = {{0, 1}, {-1, 2}, {-2, -3}};
const int8_t kFilterTree[2][2] = {{-FILTER_REGULAR, 1}, {-FILTER_SMOOTH, -FILTER_SHARP}};

// ---- block geometry (FFmpeg's ff_vp9_bwh_tab) --------------------------------

const uint8_t kBw4[13] = {16, 16, 8, 8, 8, 4, 4, 4, 2, 2, 2, 1, 1};  // width in 4-pixel units
const uint8_t kBh4[13] = {16, 8, 16, 8, 4, 8, 4, 2, 4, 2, 1, 2, 1};
const uint8_t kBw8[13] = {8, 8, 4, 4, 4, 2, 2, 2, 1, 1, 1, 1, 1};  // in 8-pixel (mode info) units
const uint8_t kBh8[13] = {8, 4, 8, 4, 2, 4, 2, 1, 2, 1, 1, 1, 1};
const uint8_t kMaxTx[13] = {3, 3, 3, 3, 2, 2, 2, 1, 1, 1, 0, 0, 0};
const uint8_t kAbovePartitionCtx[13] = {0x0, 0x0, 0x8, 0x8, 0x8, 0xc, 0xc, 0xc, 0xe, 0xe, 0xe, 0xf, 0xf};
const uint8_t kLeftPartitionCtx[13] = {0x0, 0x8, 0x0, 0x8, 0xc, 0x8, 0xc, 0xe, 0xc, 0xe, 0xf, 0xe, 0xf};
// the candidate positions of find_ref_mvs, {column, row} offsets (vp9mvs.c mv_ref_blk_off)
const int8_t kMvRefOffsets[13][8][2] = {
    {{3, -1}, {-1, 3}, {4, -1}, {-1, 4}, {-1, -1}, {0, -1}, {-1, 0}, {6, -1}},
    {{0, -1}, {-1, 0}, {4, -1}, {-1, 2}, {-1, -1}, {0, -3}, {-3, 0}, {2, -1}},
    {{-1, 0}, {0, -1}, {-1, 4}, {2, -1}, {-1, -1}, {-3, 0}, {0, -3}, {-1, 2}},
    {{1, -1}, {-1, 1}, {2, -1}, {-1, 2}, {-1, -1}, {0, -3}, {-3, 0}, {-3, -3}},
    {{0, -1}, {-1, 0}, {2, -1}, {-1, -1}, {-1, 1}, {0, -3}, {-3, 0}, {-3, -3}},
    {{-1, 0}, {0, -1}, {-1, 2}, {-1, -1}, {1, -1}, {-3, 0}, {0, -3}, {-3, -3}},
    {{0, -1}, {-1, 0}, {1, -1}, {-1, 1}, {-1, -1}, {0, -3}, {-3, 0}, {-3, -3}},
    {{0, -1}, {-1, 0}, {1, -1}, {-1, -1}, {0, -2}, {-2, 0}, {-2, -1}, {-1, -2}},
    {{-1, 0}, {0, -1}, {-1, 1}, {-1, -1}, {-2, 0}, {0, -2}, {-1, -2}, {-2, -1}},
    {{0, -1}, {-1, 0}, {-1, -1}, {0, -2}, {-2, 0}, {-1, -2}, {-2, -1}, {-2, -2}},
    {{0, -1}, {-1, 0}, {-1, -1}, {0, -2}, {-2, 0}, {-1, -2}, {-2, -1}, {-2, -2}},
    {{0, -1}, {-1, 0}, {-1, -1}, {0, -2}, {-2, 0}, {-1, -2}, {-2, -1}, {-2, -2}},
    {{0, -1}, {-1, 0}, {-1, -1}, {0, -2}, {-2, 0}, {-1, -2}, {-2, -1}, {-2, -2}},
};
// the transform type each intra mode gives a luma block (ff_vp9_intra_txfm_type)
const uint8_t kIntraTxType[10] = {ADST_DCT, DCT_ADST, DCT_DCT, DCT_DCT, ADST_ADST,
                                  ADST_DCT, DCT_ADST, ADST_DCT, DCT_ADST, ADST_ADST};

inline int clip(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }
inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// ---- the uncompressed header's bit reader ---------------------------------------

struct BitReader {
  const uint8_t* p = nullptr;
  size_t size = 0, pos = 0;  // in bits
  bool overrun = false;
  void init(const uint8_t* d, size_t n) {
    p = d;
    size = n * 8;
    pos = 0;
    overrun = false;
  }
  int bit() {
    if (pos >= size) {
      overrun = true;
      return 0;
    }
    int b = (p[pos >> 3] >> (7 - (pos & 7))) & 1;
    ++pos;
    return b;
  }
  int bits(int n) {
    int v = 0;
    while (n-- > 0) v = (v << 1) | bit();
    return v;
  }
  int sbits_inv(int n) {  // magnitude then sign (FFmpeg's get_sbits_inv)
    int v = bits(n);
    return bit() ? -v : v;
  }
};

// ---- libavcodec's VPX range coder (vpx_rac.h) --------------------------------------

struct Rac {
  int high = 255, bits = -16, end_reached = 0;
  const uint8_t *buf = nullptr, *end = nullptr, *mem_end = nullptr;
  unsigned code_word = 0;
  // bytes past ``end`` up to ``mem_end`` are the packet's (as FFmpeg's 16-bit
  // refill reads them), past ``mem_end`` FFmpeg's zero padding
  uint8_t at(const uint8_t* q) const { return q < mem_end ? *q : 0; }
  void init(const uint8_t* b, size_t size, const uint8_t* mem) {
    end = b + size;
    mem_end = mem;
    end_reached = 0;
    high = 255;
    bits = -16;
    buf = b;
    code_word = (unsigned)at(b) << 16 | (unsigned)at(b + 1) << 8 | at(b + 2);
    buf += 3;
  }
  inline unsigned renorm() {
    int shift = __builtin_clz((unsigned)high) - 24;  // ff_vpx_norm_shift
    high <<= shift;
    unsigned cw = code_word << shift;
    bits += shift;
    if (bits >= 0 && buf < end) {
      cw |= ((unsigned)at(buf) << 8 | at(buf + 1)) << bits;
      buf += 2;
      bits -= 16;
    }
    return cw;
  }
  inline int get(int prob) {
    unsigned cw = renorm();
    unsigned low = 1 + (((high - 1) * prob) >> 8);
    unsigned low_shift = low << 16;
    int bit = cw >= low_shift;
    high = bit ? high - (int)low : (int)low;
    code_word = bit ? cw - low_shift : cw;
    return bit;
  }
  int bit() { return get(128); }
  int uint(int n) {
    int v = 0;
    while (n-- > 0) v = (v << 1) | bit();
    return v;
  }
  template <int N>
  int tree(const int8_t (&t)[N][2], const uint8_t* probs) {
    int i = 0;
    do {
      i = t[i][get(probs[i])];
    } while (i > 0);
    return -i;
  }
  bool is_end() {
    if (end <= buf && bits >= 0) end_reached++;
    return end_reached > 10;
  }
};

// ---- inverse transforms (vp9dsp_template.c's C version) ------------------------------

// The first pass reads in[i * stride] for i < n (a row of the specification's
// layout), the second a column of the first pass's 16-bit output.
#define IN(x) ((int)in[(x) * stride])
static inline int rnd14(int64_t v) { return (int)((v + (1 << 13)) >> 14); }

static void idct4(const int16_t* in, int stride, int16_t* out) {
  int t0 = rnd14((int64_t)(IN(0) + IN(2)) * 11585), t1 = rnd14((int64_t)(IN(0) - IN(2)) * 11585);
  int t2 = rnd14((int64_t)IN(1) * 6270 - (int64_t)IN(3) * 15137), t3 = rnd14((int64_t)IN(1) * 15137 + (int64_t)IN(3) * 6270);
  out[0] = (int16_t)(t0 + t3);
  out[1] = (int16_t)(t1 + t2);
  out[2] = (int16_t)(t1 - t2);
  out[3] = (int16_t)(t0 - t3);
}

static void iadst4(const int16_t* in, int stride, int16_t* out) {
  int64_t t0 = 5283LL * IN(0) + 15212LL * IN(2) + 9929LL * IN(3);
  int64_t t1 = 9929LL * IN(0) - 5283LL * IN(2) - 15212LL * IN(3);
  int64_t t2 = 13377LL * (IN(0) - IN(2) + IN(3));
  int64_t t3 = 13377LL * IN(1);
  out[0] = (int16_t)rnd14(t0 + t3);
  out[1] = (int16_t)rnd14(t1 + t3);
  out[2] = (int16_t)rnd14(t2);
  out[3] = (int16_t)rnd14(t0 + t1 - t3);
}

static void idct8(const int16_t* in, int stride, int16_t* out) {
  int t0a = rnd14((int64_t)(IN(0) + IN(4)) * 11585), t1a = rnd14((int64_t)(IN(0) - IN(4)) * 11585);
  int t2a = rnd14((int64_t)IN(2) * 6270 - (int64_t)IN(6) * 15137), t3a = rnd14((int64_t)IN(2) * 15137 + (int64_t)IN(6) * 6270);
  int t4a = rnd14((int64_t)IN(1) * 3196 - (int64_t)IN(7) * 16069), t5a = rnd14((int64_t)IN(5) * 13623 - (int64_t)IN(3) * 9102);
  int t6a = rnd14((int64_t)IN(5) * 9102 + (int64_t)IN(3) * 13623), t7a = rnd14((int64_t)IN(1) * 16069 + (int64_t)IN(7) * 3196);
  int t0 = t0a + t3a, t1 = t1a + t2a, t2 = t1a - t2a, t3 = t0a - t3a;
  int t4 = t4a + t5a;
  t5a = t4a - t5a;
  int t7 = t7a + t6a;
  t6a = t7a - t6a;
  int t5 = rnd14((int64_t)(t6a - t5a) * 11585), t6 = rnd14((int64_t)(t6a + t5a) * 11585);
  out[0] = (int16_t)(t0 + t7);
  out[1] = (int16_t)(t1 + t6);
  out[2] = (int16_t)(t2 + t5);
  out[3] = (int16_t)(t3 + t4);
  out[4] = (int16_t)(t3 - t4);
  out[5] = (int16_t)(t2 - t5);
  out[6] = (int16_t)(t1 - t6);
  out[7] = (int16_t)(t0 - t7);
}

static void iadst8(const int16_t* in, int stride, int16_t* out) {
  int64_t t0a = 16305LL * IN(7) + 1606LL * IN(0), t1a = 1606LL * IN(7) - 16305LL * IN(0);
  int64_t t2a = 14449LL * IN(5) + 7723LL * IN(2), t3a = 7723LL * IN(5) - 14449LL * IN(2);
  int64_t t4a = 10394LL * IN(3) + 12665LL * IN(4), t5a = 12665LL * IN(3) - 10394LL * IN(4);
  int64_t t6a = 4756LL * IN(1) + 15679LL * IN(6), t7a = 15679LL * IN(1) - 4756LL * IN(6);
  int t0 = rnd14(t0a + t4a), t1 = rnd14(t1a + t5a), t2 = rnd14(t2a + t6a), t3 = rnd14(t3a + t7a);
  int t4 = rnd14(t0a - t4a), t5 = rnd14(t1a - t5a), t6 = rnd14(t2a - t6a), t7 = rnd14(t3a - t7a);
  int64_t u4 = 15137LL * t4 + 6270LL * t5, u5 = 6270LL * t4 - 15137LL * t5;
  int64_t u6 = 15137LL * t7 - 6270LL * t6, u7 = 6270LL * t7 + 15137LL * t6;
  out[0] = (int16_t)(t0 + t2);
  out[7] = (int16_t)(-(t1 + t3));
  int s2 = t0 - t2, s3 = t1 - t3;
  out[1] = (int16_t)(-rnd14(u4 + u6));
  out[6] = (int16_t)rnd14(u5 + u7);
  int s6 = rnd14(u4 - u6), s7 = rnd14(u5 - u7);
  out[3] = (int16_t)(-rnd14((int64_t)(s2 + s3) * 11585));
  out[4] = (int16_t)rnd14((int64_t)(s2 - s3) * 11585);
  out[2] = (int16_t)rnd14((int64_t)(s6 + s7) * 11585);
  out[5] = (int16_t)(-rnd14((int64_t)(s6 - s7) * 11585));
}

static void idct16(const int16_t* in, int stride, int16_t* out) {
  // libvpx idct16_c's stages
  int s1[16], s2[16];
  int64_t a, b;
  s1[0] = IN(0); s1[1] = IN(8); s1[2] = IN(4); s1[3] = IN(12);
  s1[4] = IN(2); s1[5] = IN(10); s1[6] = IN(6); s1[7] = IN(14);
  s1[8] = IN(1); s1[9] = IN(9); s1[10] = IN(5); s1[11] = IN(13);
  s1[12] = IN(3); s1[13] = IN(11); s1[14] = IN(7); s1[15] = IN(15);
  // stage 2
  s2[0] = s1[0]; s2[1] = s1[1]; s2[2] = s1[2]; s2[3] = s1[3];
  s2[4] = s1[4]; s2[5] = s1[5]; s2[6] = s1[6]; s2[7] = s1[7];
  a = (int64_t)s1[8] * 1606 - (int64_t)s1[15] * 16305; b = (int64_t)s1[8] * 16305 + (int64_t)s1[15] * 1606;
  s2[8] = rnd14(a); s2[15] = rnd14(b);
  a = (int64_t)s1[9] * 12665 - (int64_t)s1[14] * 10394; b = (int64_t)s1[9] * 10394 + (int64_t)s1[14] * 12665;
  s2[9] = rnd14(a); s2[14] = rnd14(b);
  a = (int64_t)s1[10] * 7723 - (int64_t)s1[13] * 14449; b = (int64_t)s1[10] * 14449 + (int64_t)s1[13] * 7723;
  s2[10] = rnd14(a); s2[13] = rnd14(b);
  a = (int64_t)s1[11] * 15679 - (int64_t)s1[12] * 4756; b = (int64_t)s1[11] * 4756 + (int64_t)s1[12] * 15679;
  s2[11] = rnd14(a); s2[12] = rnd14(b);
  // stage 3
  s1[0] = s2[0]; s1[1] = s2[1]; s1[2] = s2[2]; s1[3] = s2[3];
  a = (int64_t)s2[4] * 3196 - (int64_t)s2[7] * 16069; b = (int64_t)s2[4] * 16069 + (int64_t)s2[7] * 3196;
  s1[4] = rnd14(a); s1[7] = rnd14(b);
  a = (int64_t)s2[5] * 13623 - (int64_t)s2[6] * 9102; b = (int64_t)s2[5] * 9102 + (int64_t)s2[6] * 13623;
  s1[5] = rnd14(a); s1[6] = rnd14(b);
  s1[8] = s2[8] + s2[9]; s1[9] = s2[8] - s2[9];
  s1[10] = -s2[10] + s2[11]; s1[11] = s2[10] + s2[11];
  s1[12] = s2[12] + s2[13]; s1[13] = s2[12] - s2[13];
  s1[14] = -s2[14] + s2[15]; s1[15] = s2[14] + s2[15];
  // stage 4
  a = (int64_t)(s1[0] + s1[1]) * 11585; b = (int64_t)(s1[0] - s1[1]) * 11585;
  s2[0] = rnd14(a); s2[1] = rnd14(b);
  a = (int64_t)s1[2] * 6270 - (int64_t)s1[3] * 15137; b = (int64_t)s1[2] * 15137 + (int64_t)s1[3] * 6270;
  s2[2] = rnd14(a); s2[3] = rnd14(b);
  s2[4] = s1[4] + s1[5]; s2[5] = s1[4] - s1[5];
  s2[6] = -s1[6] + s1[7]; s2[7] = s1[6] + s1[7];
  s2[8] = s1[8]; s2[15] = s1[15];
  a = -(int64_t)s1[9] * 15137 + (int64_t)s1[14] * 6270; b = (int64_t)s1[9] * 6270 + (int64_t)s1[14] * 15137;
  s2[9] = rnd14(a); s2[14] = rnd14(b);
  a = -(int64_t)s1[10] * 6270 - (int64_t)s1[13] * 15137; b = -(int64_t)s1[10] * 15137 + (int64_t)s1[13] * 6270;
  s2[10] = rnd14(a); s2[13] = rnd14(b);
  s2[11] = s1[11]; s2[12] = s1[12];
  // stage 5
  s1[0] = s2[0] + s2[3]; s1[1] = s2[1] + s2[2]; s1[2] = s2[1] - s2[2]; s1[3] = s2[0] - s2[3];
  s1[4] = s2[4];
  a = (int64_t)(s2[6] - s2[5]) * 11585; b = (int64_t)(s2[5] + s2[6]) * 11585;
  s1[5] = rnd14(a); s1[6] = rnd14(b);
  s1[7] = s2[7];
  s1[8] = s2[8] + s2[11]; s1[9] = s2[9] + s2[10]; s1[10] = s2[9] - s2[10]; s1[11] = s2[8] - s2[11];
  s1[12] = -s2[12] + s2[15]; s1[13] = -s2[13] + s2[14]; s1[14] = s2[13] + s2[14]; s1[15] = s2[12] + s2[15];
  // stage 6
  s2[0] = s1[0] + s1[7]; s2[1] = s1[1] + s1[6]; s2[2] = s1[2] + s1[5]; s2[3] = s1[3] + s1[4];
  s2[4] = s1[3] - s1[4]; s2[5] = s1[2] - s1[5]; s2[6] = s1[1] - s1[6]; s2[7] = s1[0] - s1[7];
  s2[8] = s1[8]; s2[9] = s1[9];
  a = (int64_t)(-s1[10] + s1[13]) * 11585; b = (int64_t)(s1[10] + s1[13]) * 11585;
  s2[10] = rnd14(a); s2[13] = rnd14(b);
  a = (int64_t)(-s1[11] + s1[12]) * 11585; b = (int64_t)(s1[11] + s1[12]) * 11585;
  s2[11] = rnd14(a); s2[12] = rnd14(b);
  s2[14] = s1[14]; s2[15] = s1[15];
  // stage 7
  for (int i = 0; i < 8; ++i) {
    out[i] = (int16_t)(s2[i] + s2[15 - i]);
    out[15 - i] = (int16_t)(s2[i] - s2[15 - i]);
  }
}

static void iadst16(const int16_t* in, int stride, int16_t* out) {
  // libvpx iadst16_c
  int64_t s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, s14, s15;
  int64_t x0 = IN(15), x1 = IN(0), x2 = IN(13), x3 = IN(2), x4 = IN(11), x5 = IN(4), x6 = IN(9), x7 = IN(6);
  int64_t x8 = IN(7), x9 = IN(8), x10 = IN(5), x11 = IN(10), x12 = IN(3), x13 = IN(12), x14 = IN(1), x15 = IN(14);
  // stage 1
  s0 = x0 * 16364 + x1 * 804;
  s1 = x0 * 804 - x1 * 16364;
  s2 = x2 * 15893 + x3 * 3981;
  s3 = x2 * 3981 - x3 * 15893;
  s4 = x4 * 14811 + x5 * 7005;
  s5 = x4 * 7005 - x5 * 14811;
  s6 = x6 * 13160 + x7 * 9760;
  s7 = x6 * 9760 - x7 * 13160;
  s8 = x8 * 11003 + x9 * 12140;
  s9 = x8 * 12140 - x9 * 11003;
  s10 = x10 * 8423 + x11 * 14053;
  s11 = x10 * 14053 - x11 * 8423;
  s12 = x12 * 5520 + x13 * 15426;
  s13 = x12 * 15426 - x13 * 5520;
  s14 = x14 * 2404 + x15 * 16207;
  s15 = x14 * 16207 - x15 * 2404;
  x0 = rnd14(s0 + s8); x1 = rnd14(s1 + s9); x2 = rnd14(s2 + s10); x3 = rnd14(s3 + s11);
  x4 = rnd14(s4 + s12); x5 = rnd14(s5 + s13); x6 = rnd14(s6 + s14); x7 = rnd14(s7 + s15);
  x8 = rnd14(s0 - s8); x9 = rnd14(s1 - s9); x10 = rnd14(s2 - s10); x11 = rnd14(s3 - s11);
  x12 = rnd14(s4 - s12); x13 = rnd14(s5 - s13); x14 = rnd14(s6 - s14); x15 = rnd14(s7 - s15);
  // stage 2
  s0 = x0; s1 = x1; s2 = x2; s3 = x3; s4 = x4; s5 = x5; s6 = x6; s7 = x7;
  s8 = x8 * 16069 + x9 * 3196;
  s9 = x8 * 3196 - x9 * 16069;
  s10 = x10 * 9102 + x11 * 13623;
  s11 = x10 * 13623 - x11 * 9102;
  s12 = -x12 * 3196 + x13 * 16069;
  s13 = x12 * 16069 + x13 * 3196;
  s14 = -x14 * 13623 + x15 * 9102;
  s15 = x14 * 9102 + x15 * 13623;
  x0 = s0 + s4; x1 = s1 + s5; x2 = s2 + s6; x3 = s3 + s7;
  x4 = s0 - s4; x5 = s1 - s5; x6 = s2 - s6; x7 = s3 - s7;
  x8 = rnd14(s8 + s12); x9 = rnd14(s9 + s13); x10 = rnd14(s10 + s14); x11 = rnd14(s11 + s15);
  x12 = rnd14(s8 - s12); x13 = rnd14(s9 - s13); x14 = rnd14(s10 - s14); x15 = rnd14(s11 - s15);
  // stage 3
  s0 = x0; s1 = x1; s2 = x2; s3 = x3;
  s4 = x4 * 15137 + x5 * 6270;
  s5 = x4 * 6270 - x5 * 15137;
  s6 = -x6 * 6270 + x7 * 15137;
  s7 = x6 * 15137 + x7 * 6270;
  s8 = x8; s9 = x9; s10 = x10; s11 = x11;
  s12 = x12 * 15137 + x13 * 6270;
  s13 = x12 * 6270 - x13 * 15137;
  s14 = -x14 * 6270 + x15 * 15137;
  s15 = x14 * 15137 + x15 * 6270;
  x0 = s0 + s2; x1 = s1 + s3; x2 = s0 - s2; x3 = s1 - s3;
  x4 = rnd14(s4 + s6); x5 = rnd14(s5 + s7); x6 = rnd14(s4 - s6); x7 = rnd14(s5 - s7);
  x8 = s8 + s10; x9 = s9 + s11; x10 = s8 - s10; x11 = s9 - s11;
  x12 = rnd14(s12 + s14); x13 = rnd14(s13 + s15); x14 = rnd14(s12 - s14); x15 = rnd14(s13 - s15);
  // stage 4
  s2 = -11585 * (x2 + x3);
  s3 = 11585 * (x2 - x3);
  s6 = 11585 * (x6 + x7);
  s7 = 11585 * (-x6 + x7);
  s10 = 11585 * (x10 + x11);
  s11 = 11585 * (-x10 + x11);
  s14 = -11585 * (x14 + x15);
  s15 = 11585 * (x14 - x15);
  x2 = rnd14(s2); x3 = rnd14(s3); x6 = rnd14(s6); x7 = rnd14(s7);
  x10 = rnd14(s10); x11 = rnd14(s11); x14 = rnd14(s14); x15 = rnd14(s15);
  out[0] = (int16_t)x0;
  out[1] = (int16_t)(-x8);
  out[2] = (int16_t)x12;
  out[3] = (int16_t)(-x4);
  out[4] = (int16_t)x6;
  out[5] = (int16_t)x14;
  out[6] = (int16_t)x10;
  out[7] = (int16_t)x2;
  out[8] = (int16_t)x3;
  out[9] = (int16_t)x11;
  out[10] = (int16_t)x15;
  out[11] = (int16_t)x7;
  out[12] = (int16_t)x5;
  out[13] = (int16_t)(-x13);
  out[14] = (int16_t)x9;
  out[15] = (int16_t)(-x1);
}

static void idct32(const int16_t* in, int stride, int16_t* out) {
  // libvpx idct32_c
  int s1[32], s2[32];
  int64_t a, b;
  // stage 1
  s1[0] = IN(0); s1[1] = IN(16); s1[2] = IN(8); s1[3] = IN(24);
  s1[4] = IN(4); s1[5] = IN(20); s1[6] = IN(12); s1[7] = IN(28);
  s1[8] = IN(2); s1[9] = IN(18); s1[10] = IN(10); s1[11] = IN(26);
  s1[12] = IN(6); s1[13] = IN(22); s1[14] = IN(14); s1[15] = IN(30);
  a = (int64_t)IN(1) * 804 - (int64_t)IN(31) * 16364; b = (int64_t)IN(1) * 16364 + (int64_t)IN(31) * 804;
  s1[16] = rnd14(a); s1[31] = rnd14(b);
  a = (int64_t)IN(17) * 12140 - (int64_t)IN(15) * 11003; b = (int64_t)IN(17) * 11003 + (int64_t)IN(15) * 12140;
  s1[17] = rnd14(a); s1[30] = rnd14(b);
  a = (int64_t)IN(9) * 7005 - (int64_t)IN(23) * 14811; b = (int64_t)IN(9) * 14811 + (int64_t)IN(23) * 7005;
  s1[18] = rnd14(a); s1[29] = rnd14(b);
  a = (int64_t)IN(25) * 15426 - (int64_t)IN(7) * 5520; b = (int64_t)IN(25) * 5520 + (int64_t)IN(7) * 15426;
  s1[19] = rnd14(a); s1[28] = rnd14(b);
  a = (int64_t)IN(5) * 3981 - (int64_t)IN(27) * 15893; b = (int64_t)IN(5) * 15893 + (int64_t)IN(27) * 3981;
  s1[20] = rnd14(a); s1[27] = rnd14(b);
  a = (int64_t)IN(21) * 14053 - (int64_t)IN(11) * 8423; b = (int64_t)IN(21) * 8423 + (int64_t)IN(11) * 14053;
  s1[21] = rnd14(a); s1[26] = rnd14(b);
  a = (int64_t)IN(13) * 9760 - (int64_t)IN(19) * 13160; b = (int64_t)IN(13) * 13160 + (int64_t)IN(19) * 9760;
  s1[22] = rnd14(a); s1[25] = rnd14(b);
  a = (int64_t)IN(29) * 16207 - (int64_t)IN(3) * 2404; b = (int64_t)IN(29) * 2404 + (int64_t)IN(3) * 16207;
  s1[23] = rnd14(a); s1[24] = rnd14(b);
  // stage 2
  for (int i = 0; i < 8; ++i) s2[i] = s1[i];
  a = (int64_t)s1[8] * 1606 - (int64_t)s1[15] * 16305; b = (int64_t)s1[8] * 16305 + (int64_t)s1[15] * 1606;
  s2[8] = rnd14(a); s2[15] = rnd14(b);
  a = (int64_t)s1[9] * 12665 - (int64_t)s1[14] * 10394; b = (int64_t)s1[9] * 10394 + (int64_t)s1[14] * 12665;
  s2[9] = rnd14(a); s2[14] = rnd14(b);
  a = (int64_t)s1[10] * 7723 - (int64_t)s1[13] * 14449; b = (int64_t)s1[10] * 14449 + (int64_t)s1[13] * 7723;
  s2[10] = rnd14(a); s2[13] = rnd14(b);
  a = (int64_t)s1[11] * 15679 - (int64_t)s1[12] * 4756; b = (int64_t)s1[11] * 4756 + (int64_t)s1[12] * 15679;
  s2[11] = rnd14(a); s2[12] = rnd14(b);
  s2[16] = s1[16] + s1[17]; s2[17] = s1[16] - s1[17];
  s2[18] = -s1[18] + s1[19]; s2[19] = s1[18] + s1[19];
  s2[20] = s1[20] + s1[21]; s2[21] = s1[20] - s1[21];
  s2[22] = -s1[22] + s1[23]; s2[23] = s1[22] + s1[23];
  s2[24] = s1[24] + s1[25]; s2[25] = s1[24] - s1[25];
  s2[26] = -s1[26] + s1[27]; s2[27] = s1[26] + s1[27];
  s2[28] = s1[28] + s1[29]; s2[29] = s1[28] - s1[29];
  s2[30] = -s1[30] + s1[31]; s2[31] = s1[30] + s1[31];
  // stage 3
  for (int i = 0; i < 4; ++i) s1[i] = s2[i];
  a = (int64_t)s2[4] * 3196 - (int64_t)s2[7] * 16069; b = (int64_t)s2[4] * 16069 + (int64_t)s2[7] * 3196;
  s1[4] = rnd14(a); s1[7] = rnd14(b);
  a = (int64_t)s2[5] * 13623 - (int64_t)s2[6] * 9102; b = (int64_t)s2[5] * 9102 + (int64_t)s2[6] * 13623;
  s1[5] = rnd14(a); s1[6] = rnd14(b);
  s1[8] = s2[8] + s2[9]; s1[9] = s2[8] - s2[9];
  s1[10] = -s2[10] + s2[11]; s1[11] = s2[10] + s2[11];
  s1[12] = s2[12] + s2[13]; s1[13] = s2[12] - s2[13];
  s1[14] = -s2[14] + s2[15]; s1[15] = s2[14] + s2[15];
  s1[16] = s2[16]; s1[31] = s2[31];
  a = -(int64_t)s2[17] * 16069 + (int64_t)s2[30] * 3196; b = (int64_t)s2[17] * 3196 + (int64_t)s2[30] * 16069;
  s1[17] = rnd14(a); s1[30] = rnd14(b);
  a = -(int64_t)s2[18] * 3196 - (int64_t)s2[29] * 16069; b = -(int64_t)s2[18] * 16069 + (int64_t)s2[29] * 3196;
  s1[18] = rnd14(a); s1[29] = rnd14(b);
  s1[19] = s2[19]; s1[20] = s2[20];
  a = -(int64_t)s2[21] * 9102 + (int64_t)s2[26] * 13623; b = (int64_t)s2[21] * 13623 + (int64_t)s2[26] * 9102;
  s1[21] = rnd14(a); s1[26] = rnd14(b);
  a = -(int64_t)s2[22] * 13623 - (int64_t)s2[25] * 9102; b = -(int64_t)s2[22] * 9102 + (int64_t)s2[25] * 13623;
  s1[22] = rnd14(a); s1[25] = rnd14(b);
  s1[23] = s2[23]; s1[24] = s2[24]; s1[27] = s2[27]; s1[28] = s2[28];
  // stage 4
  a = (int64_t)(s1[0] + s1[1]) * 11585; b = (int64_t)(s1[0] - s1[1]) * 11585;
  s2[0] = rnd14(a); s2[1] = rnd14(b);
  a = (int64_t)s1[2] * 6270 - (int64_t)s1[3] * 15137; b = (int64_t)s1[2] * 15137 + (int64_t)s1[3] * 6270;
  s2[2] = rnd14(a); s2[3] = rnd14(b);
  s2[4] = s1[4] + s1[5]; s2[5] = s1[4] - s1[5];
  s2[6] = -s1[6] + s1[7]; s2[7] = s1[6] + s1[7];
  s2[8] = s1[8]; s2[15] = s1[15];
  a = -(int64_t)s1[9] * 15137 + (int64_t)s1[14] * 6270; b = (int64_t)s1[9] * 6270 + (int64_t)s1[14] * 15137;
  s2[9] = rnd14(a); s2[14] = rnd14(b);
  a = -(int64_t)s1[10] * 6270 - (int64_t)s1[13] * 15137; b = -(int64_t)s1[10] * 15137 + (int64_t)s1[13] * 6270;
  s2[10] = rnd14(a); s2[13] = rnd14(b);
  s2[11] = s1[11]; s2[12] = s1[12];
  s2[16] = s1[16] + s1[19]; s2[17] = s1[17] + s1[18]; s2[18] = s1[17] - s1[18]; s2[19] = s1[16] - s1[19];
  s2[20] = -s1[20] + s1[23]; s2[21] = -s1[21] + s1[22]; s2[22] = s1[21] + s1[22]; s2[23] = s1[20] + s1[23];
  s2[24] = s1[24] + s1[27]; s2[25] = s1[25] + s1[26]; s2[26] = s1[25] - s1[26]; s2[27] = s1[24] - s1[27];
  s2[28] = -s1[28] + s1[31]; s2[29] = -s1[29] + s1[30]; s2[30] = s1[29] + s1[30]; s2[31] = s1[28] + s1[31];
  // stage 5
  s1[0] = s2[0] + s2[3]; s1[1] = s2[1] + s2[2]; s1[2] = s2[1] - s2[2]; s1[3] = s2[0] - s2[3];
  s1[4] = s2[4];
  a = (int64_t)(s2[6] - s2[5]) * 11585; b = (int64_t)(s2[5] + s2[6]) * 11585;
  s1[5] = rnd14(a); s1[6] = rnd14(b);
  s1[7] = s2[7];
  s1[8] = s2[8] + s2[11]; s1[9] = s2[9] + s2[10]; s1[10] = s2[9] - s2[10]; s1[11] = s2[8] - s2[11];
  s1[12] = -s2[12] + s2[15]; s1[13] = -s2[13] + s2[14]; s1[14] = s2[13] + s2[14]; s1[15] = s2[12] + s2[15];
  s1[16] = s2[16]; s1[17] = s2[17];
  a = -(int64_t)s2[18] * 15137 + (int64_t)s2[29] * 6270; b = (int64_t)s2[18] * 6270 + (int64_t)s2[29] * 15137;
  s1[18] = rnd14(a); s1[29] = rnd14(b);
  a = -(int64_t)s2[19] * 15137 + (int64_t)s2[28] * 6270; b = (int64_t)s2[19] * 6270 + (int64_t)s2[28] * 15137;
  s1[19] = rnd14(a); s1[28] = rnd14(b);
  a = -(int64_t)s2[20] * 6270 - (int64_t)s2[27] * 15137; b = -(int64_t)s2[20] * 15137 + (int64_t)s2[27] * 6270;
  s1[20] = rnd14(a); s1[27] = rnd14(b);
  a = -(int64_t)s2[21] * 6270 - (int64_t)s2[26] * 15137; b = -(int64_t)s2[21] * 15137 + (int64_t)s2[26] * 6270;
  s1[21] = rnd14(a); s1[26] = rnd14(b);
  s1[22] = s2[22]; s1[23] = s2[23]; s1[24] = s2[24]; s1[25] = s2[25]; s1[30] = s2[30]; s1[31] = s2[31];
  // stage 6
  s2[0] = s1[0] + s1[7]; s2[1] = s1[1] + s1[6]; s2[2] = s1[2] + s1[5]; s2[3] = s1[3] + s1[4];
  s2[4] = s1[3] - s1[4]; s2[5] = s1[2] - s1[5]; s2[6] = s1[1] - s1[6]; s2[7] = s1[0] - s1[7];
  s2[8] = s1[8]; s2[9] = s1[9];
  a = (int64_t)(-s1[10] + s1[13]) * 11585; b = (int64_t)(s1[10] + s1[13]) * 11585;
  s2[10] = rnd14(a); s2[13] = rnd14(b);
  a = (int64_t)(-s1[11] + s1[12]) * 11585; b = (int64_t)(s1[11] + s1[12]) * 11585;
  s2[11] = rnd14(a); s2[12] = rnd14(b);
  s2[14] = s1[14]; s2[15] = s1[15];
  s2[16] = s1[16] + s1[23]; s2[17] = s1[17] + s1[22]; s2[18] = s1[18] + s1[21]; s2[19] = s1[19] + s1[20];
  s2[20] = s1[19] - s1[20]; s2[21] = s1[18] - s1[21]; s2[22] = s1[17] - s1[22]; s2[23] = s1[16] - s1[23];
  s2[24] = -s1[24] + s1[31]; s2[25] = -s1[25] + s1[30]; s2[26] = -s1[26] + s1[29]; s2[27] = -s1[27] + s1[28];
  s2[28] = s1[27] + s1[28]; s2[29] = s1[26] + s1[29]; s2[30] = s1[25] + s1[30]; s2[31] = s1[24] + s1[31];
  // stage 7
  for (int i = 0; i < 8; ++i) {
    s1[i] = s2[i] + s2[15 - i];
    s1[15 - i] = s2[i] - s2[15 - i];
  }
  s1[16] = s2[16]; s1[17] = s2[17]; s1[18] = s2[18]; s1[19] = s2[19];
  a = (int64_t)(-s2[20] + s2[27]) * 11585; b = (int64_t)(s2[20] + s2[27]) * 11585;
  s1[20] = rnd14(a); s1[27] = rnd14(b);
  a = (int64_t)(-s2[21] + s2[26]) * 11585; b = (int64_t)(s2[21] + s2[26]) * 11585;
  s1[21] = rnd14(a); s1[26] = rnd14(b);
  a = (int64_t)(-s2[22] + s2[25]) * 11585; b = (int64_t)(s2[22] + s2[25]) * 11585;
  s1[22] = rnd14(a); s1[25] = rnd14(b);
  a = (int64_t)(-s2[23] + s2[24]) * 11585; b = (int64_t)(s2[23] + s2[24]) * 11585;
  s1[23] = rnd14(a); s1[24] = rnd14(b);
  s1[28] = s2[28]; s1[29] = s2[29]; s1[30] = s2[30]; s1[31] = s2[31];
  // final stage
  for (int i = 0; i < 16; ++i) {
    out[i] = (int16_t)(s1[i] + s1[31 - i]);
    out[31 - i] = (int16_t)(s1[i] - s1[31 - i]);
  }
}

static void iwht4(const int16_t* in, int stride, int16_t* out, int pass) {
  int t0, t1, t2, t3;
  if (pass == 0) {
    t0 = IN(0) >> 2; t1 = IN(3) >> 2; t2 = IN(1) >> 2; t3 = IN(2) >> 2;
  } else {
    t0 = IN(0); t1 = IN(3); t2 = IN(1); t3 = IN(2);
  }
  t0 += t2;
  t3 -= t1;
  int t4 = (t0 - t3) >> 1;
  t1 = t4 - t1;
  t2 = t4 - t2;
  t0 -= t1;
  t3 += t2;
  out[0] = (int16_t)t0;
  out[1] = (int16_t)t1;
  out[2] = (int16_t)t2;
  out[3] = (int16_t)t3;
}
#undef IN

typedef void (*Tx1d)(const int16_t*, int, int16_t*);

// Add the inverse transform of ``block`` (FFmpeg's layout, sz x sz) to ``dst``
// and clear the block. tx: 0-3 (4x4-32x32), 4 the lossless WHT.
static void itxfm_add(uint8_t* dst, int stride, int16_t* block, int tx, int txtp, int eob) {
  if (tx == 4) {
    int16_t tmp[16], out[4];
    for (int i = 0; i < 4; ++i) iwht4(block + i, 4, tmp + i * 4, 0);
    memset(block, 0, 16 * sizeof(int16_t));
    for (int i = 0; i < 4; ++i) {
      iwht4(tmp + i, 4, out, 1);
      for (int j = 0; j < 4; ++j) dst[j * stride + i] = clip8(dst[j * stride + i] + out[j]);
    }
    return;
  }
  const int sz = 4 << tx, bits = tx == 0 ? 4 : tx == 1 ? 5 : 6;
  if (txtp == DCT_DCT && eob == 1) {  // FFmpeg's DC-only shortcut, equal to the full transform
    int t = rnd14((int64_t)rnd14((int64_t)block[0] * 11585) * 11585);
    block[0] = 0;
    int v = (t + (1 << (bits - 1))) >> bits;
    for (int j = 0; j < sz; ++j)
      for (int i = 0; i < sz; ++i) dst[j * stride + i] = clip8(dst[j * stride + i] + v);
    return;
  }
  static const Tx1d dct[4] = {idct4, idct8, idct16, idct32};
  static const Tx1d adst[4] = {iadst4, iadst8, iadst16, idct32};
  Tx1d first = (txtp == DCT_ADST || txtp == ADST_ADST) ? adst[tx] : dct[tx];
  Tx1d second = (txtp == ADST_DCT || txtp == ADST_ADST) ? adst[tx] : dct[tx];
  int16_t tmp[32 * 32], out[32];
  for (int i = 0; i < sz; ++i) first(block + i, sz, tmp + i * sz);
  memset(block, 0, sz * sz * sizeof(int16_t));
  for (int i = 0; i < sz; ++i) {
    second(tmp + i, sz, out);
    for (int j = 0; j < sz; ++j) dst[j * stride + i] = clip8(dst[j * stride + i] + ((out[j] + (1 << (bits - 1))) >> bits));
  }
}

// ---- intra prediction (vpx_dsp/intrapred.c) ---------------------------------------

#define AVG2(a, b) (((a) + (b) + 1) >> 1)
#define AVG3(a, b, c) (((a) + 2 * (b) + (c) + 2) >> 2)

// above[-1..2*bs-1] and left[0..bs-1] prepared by the caller
static void intra_pred(uint8_t* dst, int stride, int mode, int bs, const uint8_t* above, const uint8_t* left) {
  int r, c;
  switch (mode) {
    case VERT:
      for (r = 0; r < bs; ++r) memcpy(dst + r * stride, above, bs);
      break;
    case HOR:
      for (r = 0; r < bs; ++r) memset(dst + r * stride, left[r], bs);
      break;
    case DC: case LEFT_DC: case TOP_DC: case DC_128: {
      int sum = 0, v;
      if (mode == DC) {
        for (int i = 0; i < bs; ++i) sum += above[i] + left[i];
        v = (sum + bs) / (2 * bs);
      } else if (mode == LEFT_DC) {
        for (int i = 0; i < bs; ++i) sum += left[i];
        v = (sum + bs / 2) / bs;
      } else if (mode == TOP_DC) {
        for (int i = 0; i < bs; ++i) sum += above[i];
        v = (sum + bs / 2) / bs;
      } else {
        v = 128;
      }
      for (r = 0; r < bs; ++r) memset(dst + r * stride, v, bs);
      break;
    }
    case TM:
      for (r = 0; r < bs; ++r)
        for (c = 0; c < bs; ++c) dst[r * stride + c] = clip8(left[r] + above[c] - above[-1]);
      break;
    case D45:
      for (r = 0; r < bs; ++r)
        for (c = 0; c < bs; ++c)
          dst[r * stride + c] = r + c + 2 < 2 * bs ? AVG3(above[r + c], above[r + c + 1], above[r + c + 2]) : above[2 * bs - 1];
      break;
    case D63:
      for (r = 0; r < bs; ++r)
        for (c = 0; c < bs; ++c) {
          int i = (r >> 1) + c;
          dst[r * stride + c] = r & 1 ? AVG3(above[i], above[i + 1], above[i + 2]) : AVG2(above[i], above[i + 1]);
        }
      break;
    case D135: {
      // edge[k] for k = c - r in [-(bs-1), bs-1]; left[-1] is the top-left pixel
      uint8_t e[64];
      uint8_t* edge = e + 32;
      edge[0] = AVG3(left[0], above[-1], above[0]);
      for (int k = 1; k < bs; ++k) edge[k] = AVG3(above[k - 2], above[k - 1], above[k]);
      edge[-1] = AVG3(above[-1], left[0], left[1]);
      for (int k = 2; k < bs; ++k) edge[-k] = AVG3(left[k - 2], left[k - 1], left[k]);
      for (r = 0; r < bs; ++r)
        for (c = 0; c < bs; ++c) dst[r * stride + c] = edge[c - r];
      break;
    }
    case D117:
      for (c = 0; c < bs; ++c) dst[c] = AVG2(above[c - 1], above[c]);
      dst[stride] = AVG3(left[0], above[-1], above[0]);
      for (c = 1; c < bs; ++c) dst[stride + c] = AVG3(above[c - 2], above[c - 1], above[c]);
      dst[2 * stride] = AVG3(above[-1], left[0], left[1]);
      for (r = 3; r < bs; ++r) dst[r * stride] = AVG3(left[r - 3], left[r - 2], left[r - 1]);
      for (r = 2; r < bs; ++r)
        for (c = 1; c < bs; ++c) dst[r * stride + c] = dst[(r - 2) * stride + c - 1];
      break;
    case D153:
      dst[0] = AVG2(above[-1], left[0]);
      for (r = 1; r < bs; r++) dst[r * stride] = AVG2(left[r - 1], left[r]);
      dst[1] = AVG3(left[0], above[-1], above[0]);
      dst[stride + 1] = AVG3(above[-1], left[0], left[1]);
      for (r = 2; r < bs; r++) dst[r * stride + 1] = AVG3(left[r - 2], left[r - 1], left[r]);
      for (c = 0; c < bs - 2; c++) dst[2 + c] = AVG3(above[c - 1], above[c], above[c + 1]);
      for (r = 1; r < bs; ++r)
        for (c = 0; c < bs - 2; c++) dst[r * stride + 2 + c] = dst[(r - 1) * stride + c];
      break;
    case D207:
      for (r = 0; r < bs - 1; ++r) dst[r * stride] = AVG2(left[r], left[r + 1]);
      dst[(bs - 1) * stride] = left[bs - 1];
      for (r = 0; r < bs - 2; ++r) dst[r * stride + 1] = AVG3(left[r], left[r + 1], left[r + 2]);
      dst[(bs - 2) * stride + 1] = AVG3(left[bs - 2], left[bs - 1], left[bs - 1]);
      dst[(bs - 1) * stride + 1] = left[bs - 1];
      for (c = 0; c < bs - 2; ++c) dst[(bs - 1) * stride + 2 + c] = left[bs - 1];
      for (r = bs - 2; r >= 0; --r)
        for (c = 0; c < bs - 2; ++c) dst[r * stride + 2 + c] = dst[(r + 1) * stride + c];
      break;
  }
}
#undef AVG2
#undef AVG3

// ---- the loop filter (vpx_dsp/loopfilter.c) -------------------------------------

static inline int8_t sclamp(int t) { return (int8_t)clip(t, -128, 127); }

static inline void filter4(int mask, int hev, uint8_t* op1, uint8_t* op0, uint8_t* oq0, uint8_t* oq1) {
  const int8_t ps1 = (int8_t)(*op1 ^ 0x80), ps0 = (int8_t)(*op0 ^ 0x80);
  const int8_t qs0 = (int8_t)(*oq0 ^ 0x80), qs1 = (int8_t)(*oq1 ^ 0x80);
  int8_t filter = hev ? sclamp(ps1 - qs1) : 0;
  filter = mask ? sclamp(filter + 3 * (qs0 - ps0)) : 0;
  const int8_t filter1 = sclamp(filter + 4) >> 3, filter2 = sclamp(filter + 3) >> 3;
  *oq0 = (uint8_t)(sclamp(qs0 - filter1) ^ 0x80);
  *op0 = (uint8_t)(sclamp(ps0 + filter2) ^ 0x80);
  filter = hev ? 0 : (int8_t)((filter1 + 1) >> 1);
  *oq1 = (uint8_t)(sclamp(qs1 - filter) ^ 0x80);
  *op1 = (uint8_t)(sclamp(ps1 + filter) ^ 0x80);
}

// one edge of 8 pixels: s points at q0 of the first, ``step`` crosses the
// edge, ``along`` moves along it; size 4, 8 or 16
static void lpf_edge(uint8_t* s, int step, int along, int size, int lim, int mblim, int hev_thr) {
  for (int i = 0; i < 8; ++i, s += along) {
    int v[16];  // p7..p0 at 0..7, q0..q7 at 8..15
    const int reach = size == 16 ? 8 : 4;
    for (int k = -reach; k < reach; ++k) v[8 + k] = s[k * step];
    const int p3 = v[4], p2 = v[5], p1 = v[6], p0 = v[7], q0 = v[8], q1 = v[9], q2 = v[10], q3 = v[11];
    const bool mask = !(std::abs(p3 - p2) > lim || std::abs(p2 - p1) > lim || std::abs(p1 - p0) > lim ||
                        std::abs(q1 - q0) > lim || std::abs(q2 - q1) > lim || std::abs(q3 - q2) > lim ||
                        std::abs(p0 - q0) * 2 + std::abs(p1 - q1) / 2 > mblim);
    if (!mask) continue;
    const bool hev = std::abs(p1 - p0) > hev_thr || std::abs(q1 - q0) > hev_thr;
    bool flat = false, flat2 = false;
    if (size >= 8)
      flat = !(std::abs(p1 - p0) > 1 || std::abs(q1 - q0) > 1 || std::abs(p2 - p0) > 1 || std::abs(q2 - q0) > 1 ||
               std::abs(p3 - p0) > 1 || std::abs(q3 - q0) > 1);
    if (size == 16 && flat)
      flat2 = !(std::abs(v[0] - p0) > 1 || std::abs(v[15] - q0) > 1 || std::abs(v[1] - p0) > 1 ||
                std::abs(v[14] - q0) > 1 || std::abs(v[2] - p0) > 1 || std::abs(v[13] - q0) > 1 ||
                std::abs(v[3] - p0) > 1 || std::abs(v[12] - q0) > 1);
    if (flat2) {  // 15 taps
      for (int k = -7; k < 7; ++k) {
        int sum = v[8 + k];
        for (int j = k - 7; j <= k + 7; ++j) sum += v[8 + clip(j, -8, 7)];
        s[k * step] = (uint8_t)((sum + 8) >> 4);
      }
    } else if (flat) {  // 7 taps
      for (int k = -3; k < 3; ++k) {
        int sum = v[8 + k];
        for (int j = k - 3; j <= k + 3; ++j) sum += v[8 + clip(j, -4, 3)];
        s[k * step] = (uint8_t)((sum + 4) >> 3);
      }
    } else {
      filter4(1, hev, s - 2 * step, s - step, s, s + step);
    }
  }
}

// ---- frames ----------------------------------------------------------------------

struct MvRef {
  int8_t ref[2];  // 0 last, 1 golden, 2 altref, -1 none (FFmpeg's VP9mvrefPair)
  Mv mv[2];
};

struct Picture {
  int width = 0, height = 0, cols = 0, rows = 0;
  bool full_range = false;
  int stride[3] = {0, 0, 0};
  std::vector<uint8_t> plane[3];
  std::vector<MvRef> mv;           // per mode-info unit (8x8)
  std::vector<uint8_t> segmap;     // per mode-info unit
  void alloc(int w, int h) {
    width = w;
    height = h;
    cols = (w + 7) >> 3;
    rows = (h + 7) >> 3;
    const int aw = ((cols + 7) >> 3) * 64, ah = ((rows + 7) >> 3) * 64;
    for (int p = 0; p < 3; ++p) {
      stride[p] = p ? aw >> 1 : aw;
      plane[p].assign((size_t)stride[p] * (p ? ah >> 1 : ah), 0);
    }
    mv.assign((size_t)cols * rows, MvRef{{-1, -1}, {Mv(), Mv()}});
    segmap.assign((size_t)cols * rows, 0);
  }
};
typedef std::shared_ptr<Picture> PicPtr;

struct Block {
  uint8_t bs, tx, uvtx, skip, intra, comp, filter, seg_id, uvmode, lf_level;
  int8_t rf[2];  // libvpx numbering: 0 intra, 1 last, 2 golden, 3 altref; -1 none
  uint8_t mode[4];
  Mv mv[4][2];
  int row, col;
};

struct Segmentation {
  bool enabled = false, update_map = false, temporal = false, absolute = false;
  uint8_t prob[7] = {255, 255, 255, 255, 255, 255, 255}, pred_prob[3] = {255, 255, 255};
  struct Feature {
    bool q_enabled = false, lf_enabled = false, ref_enabled = false, skip_enabled = false;
    int q_val = 0, lf_val = 0, ref_val = 0;
  } feat[8];
};

struct Decoder {
  // persistent state
  FrameContext ctx[4];
  PicPtr refs[8];
  PicPtr last;        // the previous decoded frame (FFmpeg's CUR_FRAME before the next)
  PicPtr segmap_ref;  // FFmpeg's REF_FRAME_SEGMAP
  PicPtr mvpair_ref;  // FFmpeg's REF_FRAME_MVPAIR
  Segmentation seg;
  int lf_ref_delta[4] = {1, 0, -1, -1}, lf_mode_delta[2] = {0, 0};
  bool keyframe = false, last_keyframe = false, invisible = false, intraonly = false, errorres = false;
  int64_t stats[ST_COUNT] = {0};
  std::string msg;

  // the frame's header
  int profile = 0, w = 0, h = 0, refidx[3] = {0, 0, 0}, resetctx = 0, refreshmask = 0, filtermode = 0;
  int signbias[4] = {0, 0, 0, 0};  // by libvpx reference number
  bool hp = false, refreshctx = false, parallel = false, use_last_mvs = false, lossless = false, full_range = false;
  int framectxid = 0, load_ctx = 0, txfmmode = 0, comppred = 0, fixcompref = 0, varcompref[2] = {0, 0};
  bool allow_comp = false;
  int compressed_size = 0;
  int filter_level = 0, sharpness = 0, yac_qi = 0, ydc_q = 0, uvdc_q = 0, uvac_q = 0;
  bool lf_delta_enabled = false;
  int log2_tile_cols = 0, log2_tile_rows = 0;
  int16_t qmul[8][2][2];
  uint8_t lflvl[8][4][2];

  // the frame being decoded
  PicPtr cur;
  int cols = 0, rows = 0, sb_cols = 0, sb_rows = 0;
  Probs prob;
  uint8_t coef[4][2][2][6][6][11];
  Counts counts;
  Rac rac;  // the compressed header's, then each tile's
  std::vector<Block> blocks;
  std::vector<int32_t> grid;  // index of the block covering each mode-info unit
  std::vector<uint8_t> above_partition, above_segpred, above_nnz[3];
  uint8_t left_partition[8], left_segpred[8], left_nnz[3][16];
  int tile_col_start = 0;
  int16_t yblock[64 * 64], uvblock[2][32 * 32];
  uint16_t yeob[256], uveob[2][64];

  Decoder() {
    for (auto& c : ctx) {
      memcpy(&c.p, kDefaultProbs, sizeof(Probs));
      memcpy(c.coef, kDefaultCoefProbs, sizeof(c.coef));
    }
    memset(yblock, 0, sizeof(yblock));
    memset(uvblock, 0, sizeof(uvblock));
  }

  int fail(int st, const std::string& m) {
    msg = "VP9: " + m;
    return st;
  }

  // ---------------------------------------------------------------- headers

  int read_uncompressed(const uint8_t* data, size_t size, int& existing, size_t& header_bytes) {
    BitReader gb;
    gb.init(data, size);
    existing = -1;
    if (gb.bits(2) != 2) return fail(kDamaged, "a frame marker other than 2");
    profile = gb.bit();
    profile |= gb.bit() << 1;
    if (profile == 3) profile += gb.bit();
    if (profile > 3) return fail(kDamaged, "a reserved profile bit set");
    if (profile > 0) {
      static const char* what[] = {"", "1 (4:2:2, 4:4:0 and 4:4:4 at 8 bits)", "2 (4:2:0 at 10 and 12 bits)",
                                   "3 (4:2:2, 4:4:0 and 4:4:4 at 10 and 12 bits)"};
      return fail(kUnsupported, std::string("profile ") + what[profile] + " is not decoded (profile 0 is)");
    }
    if (gb.bit()) {  // show_existing_frame
      existing = gb.bits(3);
      if (gb.overrun) return fail(kDamaged, "a show_existing_frame header cut short");
      return kOk;
    }
    last_keyframe = keyframe;
    keyframe = !gb.bit();
    const bool last_invisible = invisible;
    invisible = !gb.bit();
    errorres = gb.bit();
    use_last_mvs = !errorres && !last_invisible;
    int fw = 0, fh = 0;
    if (keyframe) {
      if (gb.bits(24) != 0x498342) return fail(kDamaged, "a key frame without the sync code");
      if (gb.bits(3) == 7) return fail(kDamaged, "RGB in profile 0");
      full_range = gb.bit();
      refreshmask = 0xff;
      fw = gb.bits(16) + 1;
      fh = gb.bits(16) + 1;
      if (gb.bit()) gb.bits(32);  // render size
      intraonly = false;
    } else {
      intraonly = invisible ? gb.bit() : 0;
      resetctx = errorres ? 0 : gb.bits(2);
      if (intraonly) {
        if (gb.bits(24) != 0x498342) return fail(kDamaged, "an intra-only frame without the sync code");
        full_range = false;  // profile 0 carries no colour config here: FFmpeg sets limited range
        refreshmask = gb.bits(8);
        fw = gb.bits(16) + 1;
        fh = gb.bits(16) + 1;
        if (gb.bit()) gb.bits(32);
      } else {
        refreshmask = gb.bits(8);
        for (int i = 0; i < 3; ++i) {
          refidx[i] = gb.bits(3);
          signbias[LAST_FRAME + i] = gb.bit() && !errorres;
        }
        for (int i = 0; i < 3; ++i)
          if (!refs[refidx[i]]) return fail(kDamaged, "an inter frame whose references are not all decoded");
        if (gb.bit()) {
          fw = refs[refidx[0]]->width;
          fh = refs[refidx[0]]->height;
        } else if (gb.bit()) {
          fw = refs[refidx[1]]->width;
          fh = refs[refidx[1]]->height;
        } else if (gb.bit()) {
          fw = refs[refidx[2]]->width;
          fh = refs[refidx[2]]->height;
        } else {
          fw = gb.bits(16) + 1;
          fh = gb.bits(16) + 1;
        }
        use_last_mvs = use_last_mvs && last && last->width == fw && last->height == fh;
        if (gb.bit()) gb.bits(32);
        hp = gb.bit();
        static const int lut[4] = {FILTER_SMOOTH, FILTER_REGULAR, FILTER_SHARP, FILTER_BILINEAR};
        filtermode = gb.bit() ? FILTER_SWITCHABLE : lut[gb.bits(2)];
        const bool allowcomp = signbias[LAST_FRAME] != signbias[GOLDEN_FRAME] ||
                               signbias[LAST_FRAME] != signbias[ALTREF_FRAME];
        comppred = PRED_SINGLE;
        if (allowcomp) {
          if (signbias[LAST_FRAME] == signbias[GOLDEN_FRAME]) {
            fixcompref = ALTREF_FRAME;
            varcompref[0] = LAST_FRAME;
            varcompref[1] = GOLDEN_FRAME;
          } else if (signbias[LAST_FRAME] == signbias[ALTREF_FRAME]) {
            fixcompref = GOLDEN_FRAME;
            varcompref[0] = LAST_FRAME;
            varcompref[1] = ALTREF_FRAME;
          } else {
            fixcompref = LAST_FRAME;
            varcompref[0] = GOLDEN_FRAME;
            varcompref[1] = ALTREF_FRAME;
          }
        }
        allow_comp = allowcomp;
      }
    }
    refreshctx = errorres ? false : gb.bit();
    parallel = errorres ? true : gb.bit();
    load_ctx = gb.bits(2);
    framectxid = (keyframe || intraonly) ? 0 : load_ctx;

    if (keyframe || errorres || intraonly) {
      lf_ref_delta[0] = 1;
      lf_ref_delta[1] = 0;
      lf_ref_delta[2] = -1;
      lf_ref_delta[3] = -1;
      lf_mode_delta[0] = lf_mode_delta[1] = 0;
      for (auto& f : seg.feat) f = Segmentation::Feature();
    }
    filter_level = gb.bits(6);
    sharpness = gb.bits(3);
    if ((lf_delta_enabled = gb.bit())) {
      if (gb.bit()) {
        for (int i = 0; i < 4; ++i)
          if (gb.bit()) lf_ref_delta[i] = gb.sbits_inv(6);
        for (int i = 0; i < 2; ++i)
          if (gb.bit()) lf_mode_delta[i] = gb.sbits_inv(6);
      }
    }
    yac_qi = gb.bits(8);
    ydc_q = gb.bit() ? gb.sbits_inv(4) : 0;
    uvdc_q = gb.bit() ? gb.sbits_inv(4) : 0;
    uvac_q = gb.bit() ? gb.sbits_inv(4) : 0;
    lossless = yac_qi == 0 && ydc_q == 0 && uvdc_q == 0 && uvac_q == 0;
    if ((seg.enabled = gb.bit())) {
      if ((seg.update_map = gb.bit())) {
        for (int i = 0; i < 7; ++i) seg.prob[i] = gb.bit() ? gb.bits(8) : 255;
        if ((seg.temporal = gb.bit()))
          for (int i = 0; i < 3; ++i) seg.pred_prob[i] = gb.bit() ? gb.bits(8) : 255;
      }
      if (gb.bit()) {
        seg.absolute = gb.bit();
        for (int i = 0; i < 8; ++i) {
          auto& f = seg.feat[i];
          if ((f.q_enabled = gb.bit())) f.q_val = gb.sbits_inv(8);
          if ((f.lf_enabled = gb.bit())) f.lf_val = gb.sbits_inv(6);
          if ((f.ref_enabled = gb.bit())) f.ref_val = gb.bits(2);
          f.skip_enabled = gb.bit();
        }
      }
    } else {
      seg.update_map = seg.temporal = seg.absolute = false;
    }
    for (int i = 0; i < (seg.enabled ? 8 : 1); ++i) {
      const auto& f = seg.feat[i];
      int qyac = yac_qi;
      if (seg.enabled && f.q_enabled) qyac = seg.absolute ? clip(f.q_val, 0, 255) : clip(yac_qi + f.q_val, 0, 255);
      const int qydc = clip(qyac + ydc_q, 0, 255), quvdc = clip(qyac + uvdc_q, 0, 255);
      const int quvac = clip(qyac + uvac_q, 0, 255);
      qyac = clip(qyac, 0, 255);
      qmul[i][0][0] = kDcQLookup[qydc];
      qmul[i][0][1] = kAcQLookup[qyac];
      qmul[i][1][0] = kDcQLookup[quvdc];
      qmul[i][1][1] = kAcQLookup[quvac];
      const int sh = filter_level >= 32;
      int lvl = filter_level;
      if (seg.enabled && f.lf_enabled) lvl = seg.absolute ? clip(f.lf_val, 0, 63) : clip(filter_level + f.lf_val, 0, 63);
      if (lf_delta_enabled) {
        lflvl[i][0][0] = lflvl[i][0][1] = (uint8_t)clip(lvl + lf_ref_delta[0] * (1 << sh), 0, 63);
        for (int j = 1; j < 4; ++j) {
          lflvl[i][j][0] = (uint8_t)clip(lvl + (lf_ref_delta[j] + lf_mode_delta[0]) * (1 << sh), 0, 63);
          lflvl[i][j][1] = (uint8_t)clip(lvl + (lf_ref_delta[j] + lf_mode_delta[1]) * (1 << sh), 0, 63);
        }
      } else {
        memset(lflvl[i], lvl, sizeof(lflvl[i]));
      }
    }
    if (fw > 8192 || fh > 8192) return fail(kUnsupported, "a frame size above 8192 x 8192");
    w = fw;
    h = fh;
    const int sbc = (((w + 7) >> 3) + 7) >> 3;
    log2_tile_cols = 0;
    while (sbc > (64 << log2_tile_cols)) log2_tile_cols++;
    int max = 0;
    while ((sbc >> max) >= 4) max++;
    max = std::max(0, max - 1);
    while (max > log2_tile_cols) {
      if (gb.bit())
        log2_tile_cols++;
      else
        break;
    }
    log2_tile_rows = gb.bit();
    if (log2_tile_rows) log2_tile_rows += gb.bit();
    const int compressed = gb.bits(16);
    if (gb.overrun) return fail(kDamaged, "a frame header cut short");
    header_bytes = (gb.pos + 7) >> 3;
    if (compressed == 0 || (size_t)compressed > size - header_bytes)
      return fail(kDamaged, "a compressed header size past the frame");
    compressed_size = compressed;
    return kOk;
  }

  static int inv_recenter_nonneg(int v, int m) {
    if (v > 2 * m) return v;
    if (v & 1) return m - ((v + 1) >> 1);
    return m + (v >> 1);
  }

  int update_prob(int p) {
    static uint8_t inv_map[255];
    static bool init = false;
    if (!init) {
      int n = 0;
      for (int i = 0; i < 20; ++i) inv_map[n++] = (uint8_t)(7 + 13 * i);
      for (int v = 1; v < 254; ++v)
        if ((v - 7) % 13 != 0 || v < 7) inv_map[n++] = (uint8_t)v;
      inv_map[n++] = 253;
      init = true;
    }
    int d;
    if (!rac.bit()) {
      d = rac.uint(4);
    } else if (!rac.bit()) {
      d = rac.uint(4) + 16;
    } else if (!rac.bit()) {
      d = rac.uint(5) + 32;
    } else {
      d = rac.uint(7);
      if (d >= 65) d = (d << 1) - 65 + rac.bit();
      d += 64;
    }
    return p <= 128 ? 1 + inv_recenter_nonneg(inv_map[d], p - 1) : 255 - inv_recenter_nonneg(inv_map[d], 255 - p);
  }

  void diff_update(uint8_t& p) {
    if (rac.get(252)) p = (uint8_t)update_prob(p);
  }
  void mv_update(uint8_t& p) {
    if (rac.get(252)) p = (uint8_t)((rac.uint(7) << 1) | 1);
  }

  int read_compressed(const uint8_t* data, const uint8_t* mem_end) {
    if (keyframe || errorres || (intraonly && resetctx == 3)) {
      for (auto& c : ctx) {
        memcpy(&c.p, kDefaultProbs, sizeof(Probs));
        memcpy(c.coef, kDefaultCoefProbs, sizeof(c.coef));
      }
    } else if (intraonly && resetctx == 2) {
      memcpy(&ctx[load_ctx].p, kDefaultProbs, sizeof(Probs));
      memcpy(ctx[load_ctx].coef, kDefaultCoefProbs, sizeof(ctx[load_ctx].coef));
    }
    rac.init(data, compressed_size, mem_end);
    if (rac.get(128)) return fail(kDamaged, "the compressed header's marker bit set");
    if (keyframe || intraonly) {
      memset(counts.coef, 0, sizeof(counts.coef));
      memset(counts.eob, 0, sizeof(counts.eob));
    } else {
      memset(&counts, 0, sizeof(counts));
    }
    prob = ctx[load_ctx].p;
    if (lossless) {
      txfmmode = TX_4X4;
    } else {
      txfmmode = rac.uint(2);
      if (txfmmode == 3) txfmmode += rac.bit();
      if (txfmmode == TX_SWITCHABLE) {
        for (int i = 0; i < 2; ++i) diff_update(prob.tx8p[i]);
        for (int i = 0; i < 2; ++i)
          for (int j = 0; j < 2; ++j) diff_update(prob.tx16p[i][j]);
        for (int i = 0; i < 2; ++i)
          for (int j = 0; j < 3; ++j) diff_update(prob.tx32p[i][j]);
      }
    }
    for (int i = 0; i < 4; ++i) {
      const uint8_t(*ref)[2][6][6][3] = ctx[load_ctx].coef[i];
      const bool update = rac.bit();
      for (int j = 0; j < 2; ++j)
        for (int k = 0; k < 2; ++k)
          for (int l = 0; l < 6; ++l)
            for (int m = 0; m < 6; ++m) {
              uint8_t* p = coef[i][j][k][l][m];
              const uint8_t* r = ref[j][k][l][m];
              if (m >= 3 && l == 0) break;  // band 0 has 3 contexts
              for (int n = 0; n < 3; ++n) {
                p[n] = r[n];
                if (update) diff_update(p[n]);
              }
              memcpy(&p[3], kParetoModel[p[2]], 8);
            }
      if (txfmmode == i) break;
    }
    for (int i = 0; i < 3; ++i) diff_update(prob.skip[i]);
    if (!keyframe && !intraonly) {
      for (int i = 0; i < 7; ++i)
        for (int j = 0; j < 3; ++j) diff_update(prob.mv_mode[i][j]);
      if (filtermode == FILTER_SWITCHABLE)
        for (int i = 0; i < 4; ++i)
          for (int j = 0; j < 2; ++j) diff_update(prob.filter[i][j]);
      for (int i = 0; i < 4; ++i) diff_update(prob.intra[i]);
      if (allow_comp) {
        comppred = rac.bit();
        if (comppred) comppred += rac.bit();
        if (comppred == PRED_SWITCHABLE)
          for (int i = 0; i < 5; ++i) diff_update(prob.comp[i]);
      } else {
        comppred = PRED_SINGLE;
      }
      if (comppred != PRED_COMPOUND)
        for (int i = 0; i < 5; ++i) {
          diff_update(prob.single_ref[i][0]);
          diff_update(prob.single_ref[i][1]);
        }
      if (comppred != PRED_SINGLE)
        for (int i = 0; i < 5; ++i) diff_update(prob.comp_ref[i]);
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 9; ++j) diff_update(prob.y_mode[i][j]);
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j)
          for (int k = 0; k < 3; ++k) diff_update(prob.partition[3 - i][j][k]);
      for (int i = 0; i < 3; ++i) mv_update(prob.mv_joint[i]);
      for (int i = 0; i < 2; ++i) {
        mv_update(prob.mv_comp[i].sign);
        for (int j = 0; j < 10; ++j) mv_update(prob.mv_comp[i].classes[j]);
        mv_update(prob.mv_comp[i].class0);
        for (int j = 0; j < 10; ++j) mv_update(prob.mv_comp[i].bits[j]);
      }
      for (int i = 0; i < 2; ++i) {
        for (int j = 0; j < 2; ++j)
          for (int k = 0; k < 3; ++k) mv_update(prob.mv_comp[i].class0_fp[j][k]);
        for (int j = 0; j < 3; ++j) mv_update(prob.mv_comp[i].fp[j]);
      }
      if (hp)
        for (int i = 0; i < 2; ++i) {
          mv_update(prob.mv_comp[i].class0_hp);
          mv_update(prob.mv_comp[i].hp);
        }
    }
    return kOk;
  }

  // ---------------------------------------------------------------- contexts

  const Block* at(int r, int c) const { return &blocks[grid[(size_t)r * cols + c]]; }
  static bool is_inter(const Block* b) { return b->rf[0] > INTRA_FRAME; }
  static bool has_second(const Block* b) { return b->rf[1] > INTRA_FRAME; }

  int comp_ctx(const Block* A, const Block* L) const {  // vp9_get_reference_mode_context
    if (A && L) {
      if (!has_second(A) && !has_second(L)) return (A->rf[0] == fixcompref) ^ (L->rf[0] == fixcompref);
      if (!has_second(A)) return 2 + (A->rf[0] == fixcompref || !is_inter(A));
      if (!has_second(L)) return 2 + (L->rf[0] == fixcompref || !is_inter(L));
      return 4;
    }
    if (A || L) {
      const Block* e = A ? A : L;
      return has_second(e) ? 3 : e->rf[0] == fixcompref;
    }
    return 1;
  }

  int comp_ref_ctx(const Block* A, const Block* L) const {  // vp9_get_pred_context_comp_ref_p
    const int fix_ref_idx = signbias[fixcompref], var_ref_idx = !fix_ref_idx;
    if (A && L) {
      const bool ai = !is_inter(A), li = !is_inter(L);
      if (ai && li) return 2;
      if (ai || li) {
        const Block* e = ai ? L : A;
        if (!has_second(e)) return 1 + 2 * (e->rf[0] != varcompref[1]);
        return 1 + 2 * (e->rf[var_ref_idx] != varcompref[1]);
      }
      const bool l_sg = !has_second(L), a_sg = !has_second(A);
      const int vrfa = a_sg ? A->rf[0] : A->rf[var_ref_idx];
      const int vrfl = l_sg ? L->rf[0] : L->rf[var_ref_idx];
      if (vrfa == vrfl && varcompref[1] == vrfa) return 0;
      if (l_sg && a_sg) {
        if ((vrfa == fixcompref && vrfl == varcompref[0]) || (vrfl == fixcompref && vrfa == varcompref[0])) return 4;
        if (vrfa == vrfl) return 3;
        return 1;
      }
      if (l_sg || a_sg) {
        const int vrfc = l_sg ? vrfa : vrfl, rfs = a_sg ? vrfa : vrfl;
        if (vrfc == varcompref[1] && rfs != varcompref[1]) return 1;
        if (rfs == varcompref[1] && vrfc != varcompref[1]) return 2;
        return 4;
      }
      return vrfa == vrfl ? 4 : 2;
    }
    if (A || L) {
      const Block* e = A ? A : L;
      if (!is_inter(e)) return 2;
      if (has_second(e)) return 4 * (e->rf[var_ref_idx] != varcompref[1]);
      return 3 * (e->rf[0] != varcompref[1]);
    }
    return 2;
  }

  static int single_ref_p1(const Block* A, const Block* L) {
    if (A && L) {
      const bool ai = !is_inter(A), li = !is_inter(L);
      if (ai && li) return 2;
      if (ai || li) {
        const Block* e = ai ? L : A;
        if (!has_second(e)) return 4 * (e->rf[0] == LAST_FRAME);
        return 1 + (e->rf[0] == LAST_FRAME || e->rf[1] == LAST_FRAME);
      }
      const bool a2 = has_second(A), l2 = has_second(L);
      const int a0 = A->rf[0], a1 = A->rf[1], l0 = L->rf[0], l1 = L->rf[1];
      if (a2 && l2) return 1 + (a0 == LAST_FRAME || a1 == LAST_FRAME || l0 == LAST_FRAME || l1 == LAST_FRAME);
      if (a2 || l2) {
        const int rfs = !a2 ? a0 : l0, crf1 = a2 ? a0 : l0, crf2 = a2 ? a1 : l1;
        if (rfs == LAST_FRAME) return 3 + (crf1 == LAST_FRAME || crf2 == LAST_FRAME);
        return crf1 == LAST_FRAME || crf2 == LAST_FRAME;
      }
      return 2 * (a0 == LAST_FRAME) + 2 * (l0 == LAST_FRAME);
    }
    if (A || L) {
      const Block* e = A ? A : L;
      if (!is_inter(e)) return 2;
      if (!has_second(e)) return 4 * (e->rf[0] == LAST_FRAME);
      return 1 + (e->rf[0] == LAST_FRAME || e->rf[1] == LAST_FRAME);
    }
    return 2;
  }

  static int single_ref_p2(const Block* A, const Block* L) {
    if (A && L) {
      const bool ai = !is_inter(A), li = !is_inter(L);
      if (ai && li) return 2;
      if (ai || li) {
        const Block* e = ai ? L : A;
        if (!has_second(e)) {
          if (e->rf[0] == LAST_FRAME) return 3;
          return 4 * (e->rf[0] == GOLDEN_FRAME);
        }
        return 1 + 2 * (e->rf[0] == GOLDEN_FRAME || e->rf[1] == GOLDEN_FRAME);
      }
      const bool a2 = has_second(A), l2 = has_second(L);
      const int a0 = A->rf[0], a1 = A->rf[1], l0 = L->rf[0], l1 = L->rf[1];
      if (a2 && l2) {
        if (a0 == l0 && a1 == l1)
          return 3 * (a0 == GOLDEN_FRAME || a1 == GOLDEN_FRAME || l0 == GOLDEN_FRAME || l1 == GOLDEN_FRAME);
        return 2;
      }
      if (a2 || l2) {
        const int rfs = !a2 ? a0 : l0, crf1 = a2 ? a0 : l0, crf2 = a2 ? a1 : l1;
        if (rfs == GOLDEN_FRAME) return 3 + (crf1 == GOLDEN_FRAME || crf2 == GOLDEN_FRAME);
        if (rfs == ALTREF_FRAME) return crf1 == GOLDEN_FRAME || crf2 == GOLDEN_FRAME;
        return 1 + 2 * (crf1 == GOLDEN_FRAME || crf2 == GOLDEN_FRAME);
      }
      if (a0 == LAST_FRAME && l0 == LAST_FRAME) return 3;
      if (a0 == LAST_FRAME || l0 == LAST_FRAME) {
        const int edge0 = (a0 == LAST_FRAME) ? l0 : a0;
        return 4 * (edge0 == GOLDEN_FRAME);
      }
      return 2 * (a0 == GOLDEN_FRAME) + 2 * (l0 == GOLDEN_FRAME);
    }
    if (A || L) {
      const Block* e = A ? A : L;
      if (!is_inter(e) || (e->rf[0] == LAST_FRAME && !has_second(e))) return 2;
      if (!has_second(e)) return 4 * (e->rf[0] == GOLDEN_FRAME);
      return 3 * (e->rf[0] == GOLDEN_FRAME || e->rf[1] == GOLDEN_FRAME);
    }
    return 2;
  }

  // ---------------------------------------------------------------- motion vectors

  int min_mv_x = 0, min_mv_y = 0, max_mv_x = 0, max_mv_y = 0;

  Mv clamp_mv(Mv m) const {
    Mv r;
    r.x = (int16_t)clip(m.x, min_mv_x, max_mv_x);
    r.y = (int16_t)clip(m.y, min_mv_y, max_mv_y);
    return r;
  }

  // vp9mvs.c find_ref_mvs: ``ref`` 0-2, ``z`` which of the block's MVs, ``idx``
  // 0 nearest 1 near, ``sb`` the sub-8x8 block or -1
  Mv find_ref_mvs(const Block& b, int row, int col, int ref, int z, int idx, int sb) {
    const int8_t(*p)[2] = kMvRefOffsets[b.bs];
    const uint32_t INVALID = 0x80008000u;
    uint32_t mem = INVALID, mem_sub8x8 = INVALID;
    auto pack = [](Mv m) { return (uint32_t)(uint16_t)m.x | ((uint32_t)(uint16_t)m.y << 16); };
    Mv out;
    // returns true when ``out`` is final
    auto direct = [&](Mv m) -> bool {
      uint32_t v = pack(m);
      if (!idx) {
        out = m;
        return true;
      } else if (mem == INVALID) {
        mem = v;
      } else if (v != mem) {
        out = m;
        return true;
      }
      return false;
    };
    auto ret = [&](Mv m) -> bool {
      if (sb > 0) {
        if (mem_sub8x8 == INVALID) {
          Mv t = clamp_mv(m);
          if (pack(t) != mem) {
            out = t;
            return true;
          }
          mem_sub8x8 = pack(m);
        } else if (mem_sub8x8 != pack(m)) {
          Mv t = clamp_mv(m);
          out = pack(t) != mem ? t : Mv();
          return true;
        }
        return false;
      }
      uint32_t v = pack(m);
      if (!idx) {
        out = clamp_mv(m);
        return true;
      } else if (mem == INVALID) {
        mem = v;
      } else if (v != mem) {
        out = clamp_mv(m);
        return true;
      }
      return false;
    };
    int i;
    if (sb >= 0) {
      if (sb == 2 || sb == 1) {
        if (direct(b.mv[0][z])) return out;
      } else if (sb == 3) {
        if (direct(b.mv[2][z]) || direct(b.mv[1][z]) || direct(b.mv[0][z])) return out;
      }
      if (row > 0) {
        const Block* a = at(row - 1, col);
        const int8_t r0 = a->rf[0] - 1, r1 = a->rf[1] > 0 ? a->rf[1] - 1 : -1;
        if (r0 == ref) {
          if (ret(a->mv[2 + (sb & 1)][0])) return out;
        } else if (r1 == ref) {
          if (ret(a->mv[2 + (sb & 1)][1])) return out;
        }
      }
      if (col > tile_col_start) {
        const Block* l = at(row, col - 1);
        const int8_t r0 = l->rf[0] - 1, r1 = l->rf[1] > 0 ? l->rf[1] - 1 : -1;
        if (r0 == ref) {
          if (ret(l->mv[1 + 2 * (sb >> 1)][0])) return out;
        } else if (r1 == ref) {
          if (ret(l->mv[1 + 2 * (sb >> 1)][1])) return out;
        }
      }
      i = 2;
    } else {
      i = 0;
    }
    for (; i < 8; i++) {
      const int c = p[i][0] + col, r = p[i][1] + row;
      if (c >= tile_col_start && c < cols && r >= 0 && r < rows) {
        const Block* m = at(r, c);
        const int8_t r0 = m->rf[0] - 1, r1 = m->rf[1] > 0 ? m->rf[1] - 1 : -1;
        if (r0 == ref) {
          if (ret(m->mv[3][0])) return out;
        } else if (r1 == ref) {
          if (ret(m->mv[3][1])) return out;
        }
      }
    }
    const MvRef* prev = use_last_mvs ? &mvpair_ref->mv[(size_t)row * cols + col] : nullptr;
    if (prev) {
      if (prev->ref[0] == ref) {
        if (ret(prev->mv[0])) return out;
      } else if (prev->ref[1] == ref) {
        if (ret(prev->mv[1])) return out;
      }
    }
    auto scaled = [&](Mv m, int from) -> Mv {
      if (signbias[from + 1] != signbias[ref + 1]) {
        m.x = (int16_t)-m.x;
        m.y = (int16_t)-m.y;
      }
      return m;
    };
    for (i = 0; i < 8; i++) {
      const int c = p[i][0] + col, r = p[i][1] + row;
      if (c >= tile_col_start && c < cols && r >= 0 && r < rows) {
        const Block* m = at(r, c);
        const int8_t r0 = m->rf[0] - 1, r1 = m->rf[1] > 0 ? m->rf[1] - 1 : -1;
        if (r0 != ref && r0 >= 0)
          if (ret(scaled(m->mv[3][0], r0))) return out;
        if (r1 != ref && r1 >= 0 && m->mv[3][0] != m->mv[3][1])
          if (ret(scaled(m->mv[3][1], r1))) return out;
      }
    }
    if (prev) {
      if (prev->ref[0] != ref && prev->ref[0] >= 0)
        if (ret(scaled(prev->mv[0], prev->ref[0]))) return out;
      if (prev->ref[1] != ref && prev->ref[1] >= 0 && prev->mv[0] != prev->mv[1])
        if (ret(scaled(prev->mv[1], prev->ref[1]))) return out;
    }
    return clamp_mv(Mv());
  }

  int read_mv_component(int idx, bool usehp) {
    auto& pc = prob.mv_comp[idx];
    auto& cc = counts.mv_comp[idx];
    const int sign = rac.get(pc.sign);
    const int c = rac.tree(kMvClassTree, pc.classes);
    cc.sign[sign]++;
    cc.classes[c]++;
    int n;
    if (c) {
      n = 0;
      for (int m = 0; m < c; m++) {
        const int bit = rac.get(pc.bits[m]);
        n |= bit << m;
        cc.bits[m][bit]++;
      }
      n <<= 3;
      const int fp = rac.tree(kMvFpTree, pc.fp);
      n |= fp << 1;
      cc.fp[fp]++;
      if (usehp) {
        const int bit = rac.get(pc.hp);
        cc.hp[bit]++;
        n |= bit;
      } else {
        n |= 1;
        cc.hp[1]++;
      }
      n += 2 << (c + 2);
    } else {
      n = rac.get(pc.class0);
      cc.class0[n]++;
      const int fp = rac.tree(kMvFpTree, pc.class0_fp[n]);
      cc.class0_fp[n][fp]++;
      n = (n << 3) | (fp << 1);
      if (usehp) {
        const int bit = rac.get(pc.class0_hp);
        cc.class0_hp[bit]++;
        n |= bit;
      } else {
        n |= 1;
        cc.class0_hp[1]++;
      }
    }
    return sign ? -(n + 1) : (n + 1);
  }

  // vp9block.c fill_mv: the block's MVs for ``mode``, sub-8x8 block ``sb`` or -1
  void fill_mv(Block& b, Mv* mv, int mode, int sb, int row, int col) {
    if (mode == ZEROMV) {
      mv[0] = mv[1] = Mv();
      return;
    }
    for (int z = 0; z < 1 + b.comp; ++z) {
      mv[z] = find_ref_mvs(b, row, col, b.rf[z] - 1, z, mode == NEARMV, mode == NEWMV ? -1 : sb);
      bool usehp = false;
      if (mode == NEWMV || sb == -1) {
        usehp = hp && std::abs(mv[z].x) < 64 && std::abs(mv[z].y) < 64;
        if (!usehp) {
          if (mv[z].y & 1) mv[z].y = (int16_t)(mv[z].y + (mv[z].y < 0 ? 1 : -1));
          if (mv[z].x & 1) mv[z].x = (int16_t)(mv[z].x + (mv[z].x < 0 ? 1 : -1));
        }
      }
      if (mode == NEWMV) {
        const int j = rac.tree(kMvJointTree, prob.mv_joint);
        counts.mv_joint[j]++;
        if (j >= 2) mv[z].y = (int16_t)(mv[z].y + read_mv_component(0, usehp));
        if (j & 1) mv[z].x = (int16_t)(mv[z].x + read_mv_component(1, usehp));
      }
    }
  }

  // ---------------------------------------------------------------- modes

  void decode_mode(Block& b, int row, int col) {
    const int bs = b.bs;
    const int max_tx = kMaxTx[bs];
    const int bw8 = kBw8[bs], bh8 = kBh8[bs];
    const int w8 = std::min(cols - col, bw8), h8 = std::min(rows - row, bh8);
    const int row7 = row & 7;
    const Block* A = row > 0 ? at(row - 1, col) : nullptr;
    const Block* L = col > tile_col_start ? at(row, col - 1) : nullptr;
    const bool intra_frame = keyframe || intraonly;

    if (!seg.enabled) {
      b.seg_id = 0;
    } else if (intra_frame) {
      b.seg_id = !seg.update_map ? 0 : (uint8_t)rac.tree(kSegmentTree, seg.prob);
    } else if (!seg.update_map ||
               (seg.temporal && rac.get(seg.pred_prob[above_segpred[col] + left_segpred[row7]]))) {
      if (!errorres && segmap_ref) {
        int pred = 8;
        for (int y = 0; y < h8; y++)
          for (int x = 0; x < w8; x++) pred = std::min<int>(pred, segmap_ref->segmap[(size_t)(row + y) * cols + col + x]);
        b.seg_id = (uint8_t)pred;
      } else {
        b.seg_id = 0;
      }
      memset(&above_segpred[col], 1, w8);
      memset(&left_segpred[row7], 1, h8);
    } else {
      b.seg_id = (uint8_t)rac.tree(kSegmentTree, seg.prob);
      memset(&above_segpred[col], 0, w8);
      memset(&left_segpred[row7], 0, h8);
    }
    if (seg.enabled && (seg.update_map || intra_frame))
      for (int y = 0; y < h8; y++) memset(&cur->segmap[(size_t)(row + y) * cols + col], b.seg_id, w8);

    b.skip = seg.enabled && seg.feat[b.seg_id].skip_enabled;
    if (!b.skip) {
      const int c = (A ? A->skip : 0) + (L ? L->skip : 0);
      b.skip = (uint8_t)rac.get(prob.skip[c]);
      counts.skip[c][b.skip]++;
    }

    if (intra_frame) {
      b.intra = 1;
    } else if (seg.enabled && seg.feat[b.seg_id].ref_enabled) {
      b.intra = !seg.feat[b.seg_id].ref_val;
    } else {
      int c;
      if (A && L) {
        const bool ai = !is_inter(A), li = !is_inter(L);
        c = ai && li ? 3 : ai || li;
      } else if (A || L) {
        c = 2 * !is_inter(A ? A : L);
      } else {
        c = 0;
      }
      const int bit = rac.get(prob.intra[c]);
      counts.intra[c][bit]++;
      b.intra = !bit;
    }

    if ((b.intra || !b.skip) && txfmmode == TX_SWITCHABLE) {
      int a = A && !A->skip ? A->tx : max_tx, l = L && !L->skip ? L->tx : max_tx;
      if (!L) l = a;
      if (!A) a = l;
      const int c = a + l > max_tx;
      if (max_tx == TX_32X32) {
        b.tx = (uint8_t)rac.get(prob.tx32p[c][0]);
        if (b.tx) {
          b.tx += rac.get(prob.tx32p[c][1]);
          if (b.tx == 2) b.tx += rac.get(prob.tx32p[c][2]);
        }
        counts.tx32p[c][b.tx]++;
      } else if (max_tx == TX_16X16) {
        b.tx = (uint8_t)rac.get(prob.tx16p[c][0]);
        if (b.tx) b.tx += rac.get(prob.tx16p[c][1]);
        counts.tx16p[c][b.tx]++;
      } else if (max_tx == TX_8X8) {
        b.tx = (uint8_t)rac.get(prob.tx8p[c]);
        counts.tx8p[c][b.tx]++;
      } else {
        b.tx = TX_4X4;
      }
    } else {
      b.tx = (uint8_t)std::min(max_tx, txfmmode);
    }

    b.comp = 0;
    b.rf[0] = INTRA_FRAME;
    b.rf[1] = NONE_FRAME;
    b.filter = 0;
    if (intra_frame) {
      // the neighbours' sub-block modes (DC outside the picture or tile)
      auto above_mode = [&](int k) { return A ? A->mode[2 + k] : (int)DC; };
      auto left_mode = [&](int k) { return L ? L->mode[1 + 2 * k] : (int)DC; };
      if (bs > BS_8x8) {
        b.mode[0] = (uint8_t)rac.tree(kIntraModeTree, kKfYModeProbs[above_mode(0)][left_mode(0)]);
        if (bs != BS_8x4)
          b.mode[1] = (uint8_t)rac.tree(kIntraModeTree, kKfYModeProbs[above_mode(1)][b.mode[0]]);
        else
          b.mode[1] = b.mode[0];
        if (bs != BS_4x8) {
          b.mode[2] = (uint8_t)rac.tree(kIntraModeTree, kKfYModeProbs[b.mode[0]][left_mode(1)]);
          if (bs != BS_8x4)
            b.mode[3] = (uint8_t)rac.tree(kIntraModeTree, kKfYModeProbs[b.mode[1]][b.mode[2]]);
          else
            b.mode[3] = b.mode[2];
        } else {
          b.mode[2] = b.mode[0];
          b.mode[3] = b.mode[1];
        }
      } else {
        b.mode[0] = (uint8_t)rac.tree(kIntraModeTree, kKfYModeProbs[above_mode(0)][left_mode(0)]);
        b.mode[1] = b.mode[2] = b.mode[3] = b.mode[0];
      }
      b.uvmode = (uint8_t)rac.tree(kIntraModeTree, kKfUvModeProbs[b.mode[3]]);
    } else if (b.intra) {
      if (bs > BS_8x8) {
        b.mode[0] = (uint8_t)rac.tree(kIntraModeTree, prob.y_mode[0]);
        counts.y_mode[0][b.mode[0]]++;
        if (bs != BS_8x4) {
          b.mode[1] = (uint8_t)rac.tree(kIntraModeTree, prob.y_mode[0]);
          counts.y_mode[0][b.mode[1]]++;
        } else {
          b.mode[1] = b.mode[0];
        }
        if (bs != BS_4x8) {
          b.mode[2] = (uint8_t)rac.tree(kIntraModeTree, prob.y_mode[0]);
          counts.y_mode[0][b.mode[2]]++;
          if (bs != BS_8x4) {
            b.mode[3] = (uint8_t)rac.tree(kIntraModeTree, prob.y_mode[0]);
            counts.y_mode[0][b.mode[3]]++;
          } else {
            b.mode[3] = b.mode[2];
          }
        } else {
          b.mode[2] = b.mode[0];
          b.mode[3] = b.mode[1];
        }
      } else {
        static const uint8_t size_group[10] = {3, 3, 3, 3, 2, 2, 2, 1, 1, 1};
        const int sz = size_group[bs];
        b.mode[0] = (uint8_t)rac.tree(kIntraModeTree, prob.y_mode[sz]);
        b.mode[1] = b.mode[2] = b.mode[3] = b.mode[0];
        counts.y_mode[sz][b.mode[3]]++;
      }
      b.uvmode = (uint8_t)rac.tree(kIntraModeTree, prob.uv_mode[b.mode[3]]);
      counts.uv_mode[b.mode[3]][b.uvmode]++;
    } else {
      // the mode context: the first two candidates (vp9_mvref_common.h counter_to_context)
      static const uint8_t counter_to_context[19] = {2, 3, 4, 1, 3, 9, 0, 9, 9, 5, 5, 9, 5, 9, 9, 9, 9, 9, 6};
      int counter = 0;
      for (int i = 0; i < 2; ++i) {
        const int c = kMvRefOffsets[bs][i][0] + col, r = kMvRefOffsets[bs][i][1] + row;
        if (c >= tile_col_start && c < cols && r >= 0 && r < rows) {
          const Block* m = at(r, c);
          if (!is_inter(m)) counter += 9;
          else if (m->mode[3] == ZEROMV) counter += 3;
          else if (m->mode[3] == NEWMV) counter += 1;
        }
      }
      const int mctx = counter_to_context[counter];
      if (seg.enabled && seg.feat[b.seg_id].ref_enabled) {
        b.comp = 0;
        b.rf[0] = (int8_t)seg.feat[b.seg_id].ref_val;
      } else {
        if (comppred != PRED_SWITCHABLE) {
          b.comp = comppred == PRED_COMPOUND;
        } else {
          const int c = comp_ctx(A, L);
          b.comp = (uint8_t)rac.get(prob.comp[c]);
          counts.comp[c][b.comp]++;
        }
        if (b.comp) {
          const int fix_idx = signbias[fixcompref], c = comp_ref_ctx(A, L);
          const int bit = rac.get(prob.comp_ref[c]);
          counts.comp_ref[c][bit]++;
          b.rf[fix_idx] = (int8_t)fixcompref;
          b.rf[!fix_idx] = (int8_t)varcompref[bit];
        } else {
          const int c0 = single_ref_p1(A, L);
          const int bit0 = rac.get(prob.single_ref[c0][0]);
          counts.single_ref[c0][0][bit0]++;
          if (bit0) {
            const int c1 = single_ref_p2(A, L);
            const int bit1 = rac.get(prob.single_ref[c1][1]);
            counts.single_ref[c1][1][bit1]++;
            b.rf[0] = bit1 ? ALTREF_FRAME : GOLDEN_FRAME;
          } else {
            b.rf[0] = LAST_FRAME;
          }
        }
      }
      if (bs <= BS_8x8) {
        if (seg.enabled && seg.feat[b.seg_id].skip_enabled) {
          b.mode[0] = ZEROMV;
        } else {
          b.mode[0] = (uint8_t)(rac.tree(kInterModeTree, prob.mv_mode[mctx]) + NEARESTMV);
          counts.mv_mode[mctx][b.mode[0] - NEARESTMV]++;
        }
      }
      if (filtermode == FILTER_SWITCHABLE) {
        int a = A && is_inter(A) ? A->filter : 3, l = L && is_inter(L) ? L->filter : 3;
        const int c = a == l ? l : a == 3 ? l : l == 3 ? a : 3;
        b.filter = (uint8_t)rac.tree(kFilterTree, prob.filter[c]);
        counts.filter[c][b.filter]++;
      } else {
        b.filter = (uint8_t)filtermode;
      }
      if (bs > BS_8x8) {
        auto sub = [&](int k) {
          b.mode[k] = (uint8_t)(rac.tree(kInterModeTree, prob.mv_mode[mctx]) + NEARESTMV);
          counts.mv_mode[mctx][b.mode[k] - NEARESTMV]++;
          fill_mv(b, b.mv[k], b.mode[k], k, row, col);
        };
        sub(0);
        if (bs != BS_8x4) {
          sub(1);
        } else {
          b.mode[1] = b.mode[0];
          b.mv[1][0] = b.mv[0][0];
          b.mv[1][1] = b.mv[0][1];
        }
        if (bs != BS_4x8) {
          sub(2);
          if (bs != BS_8x4) {
            sub(3);
          } else {
            b.mode[3] = b.mode[2];
            b.mv[3][0] = b.mv[2][0];
            b.mv[3][1] = b.mv[2][1];
          }
        } else {
          b.mode[2] = b.mode[0];
          b.mv[2][0] = b.mv[0][0];
          b.mv[2][1] = b.mv[0][1];
          b.mode[3] = b.mode[1];
          b.mv[3][0] = b.mv[1][0];
          b.mv[3][1] = b.mv[1][1];
        }
      } else {
        fill_mv(b, b.mv[0], b.mode[0], -1, row, col);
        for (int k = 1; k < 4; ++k) {
          b.mv[k][0] = b.mv[0][0];
          b.mv[k][1] = b.mv[0][1];
        }
        b.mode[1] = b.mode[2] = b.mode[3] = b.mode[0];
      }
    }
    // the MVs the next frame may predict from
    for (int y = 0; y < h8; y++) {
      MvRef* m = &cur->mv[(size_t)(row + y) * cols + col];
      for (int x = 0; x < w8; x++) {
        if (b.intra) {
          m[x].ref[0] = m[x].ref[1] = -1;
        } else {
          m[x].ref[0] = (int8_t)(b.rf[0] - 1);
          m[x].ref[1] = (int8_t)(b.comp ? b.rf[1] - 1 : -1);
          m[x].mv[0] = b.mv[3][0];
          if (b.comp) m[x].mv[1] = b.mv[3][1];
        }
      }
    }
  }

  // ---------------------------------------------------------------- coefficients

  // one transform block's tokens (decode_coeffs_b_generic); returns its eob
  int decode_coeffs_b(int16_t* out, int n_coeffs, bool tx32, unsigned (*cnt)[6][3], unsigned (*eob)[6][2],
                      uint8_t (*p)[6][11], int nnz, const int16_t* scan, const int16_t (*nb)[2],
                      const int16_t* band_counts, const int16_t* qmul) {
    int i = 0, band = 0, band_left = band_counts[band];
    const uint8_t* tp = p[0][nnz];
    uint8_t cache[1024];
    do {
      int val = rac.get(tp[0]);
      eob[band][nnz][val]++;
      if (!val) break;
      for (;;) {  // skip_eob
        if (rac.get(tp[1])) break;
        cnt[band][nnz][0]++;
        if (!--band_left) band_left = band_counts[++band];
        cache[scan[i]] = 0;
        nnz = (1 + cache[nb[i][0]] + cache[nb[i][1]]) >> 1;
        tp = p[band][nnz];
        if (++i == n_coeffs) return i;
      }
      const int rc = scan[i];
      if (!rac.get(tp[2])) {
        cnt[band][nnz][1]++;
        val = 1;
        cache[rc] = 1;
      } else {
        cnt[band][nnz][2]++;
        if (!rac.get(tp[3])) {
          if (!rac.get(tp[4])) {
            cache[rc] = val = 2;
          } else {
            val = 3 + rac.get(tp[5]);
            cache[rc] = 3;
          }
        } else if (!rac.get(tp[6])) {
          cache[rc] = 4;
          if (!rac.get(tp[7])) {
            val = rac.get(159) + 5;
          } else {
            val = (rac.get(165) << 1) + 7;
            val += rac.get(145);
          }
        } else {
          cache[rc] = 5;
          if (!rac.get(tp[8])) {
            if (!rac.get(tp[9])) {
              val = 11 + (rac.get(173) << 2);
              val += rac.get(148) << 1;
              val += rac.get(140);
            } else {
              val = 19 + (rac.get(176) << 3);
              val += rac.get(155) << 2;
              val += rac.get(140) << 1;
              val += rac.get(135);
            }
          } else if (!rac.get(tp[10])) {
            val = (rac.get(180) << 4) + 35;
            val += rac.get(157) << 3;
            val += rac.get(141) << 2;
            val += rac.get(134) << 1;
            val += rac.get(130);
          } else {
            static const uint8_t cat6[14] = {254, 254, 254, 252, 249, 243, 230, 196, 177, 153, 140, 133, 130, 129};
            val = 67;
            for (int k = 0; k < 14; ++k) val += rac.get(cat6[k]) << (13 - k);
          }
        }
      }
      if (!--band_left) band_left = band_counts[++band];
      const int v = rac.bit() ? -val : val;
      if (tx32)
        out[rc] = (int16_t)((int32_t)((uint32_t)v * (uint32_t)qmul[!!i]) / 2);
      else
        out[rc] = (int16_t)((uint32_t)v * (uint32_t)qmul[!!i]);
      nnz = (1 + cache[nb[i][0]] + cache[nb[i][1]]) >> 1;
      tp = p[band][nnz];
    } while (++i < n_coeffs);
    return i;
  }

  static void scan_of(int tx, int txtp, const int16_t*& scan, const int16_t (*&nb)[2]) {
    switch (tx) {
      case 0:
        if (txtp == DCT_ADST) { scan = kScan4x4Col; nb = kScan4x4ColNb; }
        else if (txtp == ADST_DCT) { scan = kScan4x4Row; nb = kScan4x4RowNb; }
        else { scan = kScan4x4Default; nb = kScan4x4DefaultNb; }
        break;
      case 1:
        if (txtp == DCT_ADST) { scan = kScan8x8Col; nb = kScan8x8ColNb; }
        else if (txtp == ADST_DCT) { scan = kScan8x8Row; nb = kScan8x8RowNb; }
        else { scan = kScan8x8Default; nb = kScan8x8DefaultNb; }
        break;
      case 2:
        if (txtp == DCT_ADST) { scan = kScan16x16Col; nb = kScan16x16ColNb; }
        else if (txtp == ADST_DCT) { scan = kScan16x16Row; nb = kScan16x16RowNb; }
        else { scan = kScan16x16Default; nb = kScan16x16DefaultNb; }
        break;
      default:
        scan = kScan32x32Default;
        nb = kScan32x32DefaultNb;
    }
  }

  // a transform type and its scan: intra luma takes its mode's, the rest DCT_DCT
  int luma_txtp(const Block& b, int n) const {
    if (lossless || !b.intra || b.tx == TX_32X32) return DCT_DCT;
    return kIntraTxType[b.mode[b.bs > BS_8x8 && b.tx == TX_4X4 ? n : 0]];
  }

  bool decode_coeffs(const Block& b, int row, int col) {
    static const int16_t band_counts[4][8] = {{1, 2, 3, 4, 3, 16 - 13}, {1, 2, 3, 4, 11, 64 - 21},
                                              {1, 2, 3, 4, 11, 256 - 21}, {1, 2, 3, 4, 11, 1024 - 21}};
    const int tx = b.tx;
    int w4 = kBw8[b.bs] * 2, h4 = kBh8[b.bs] * 2;
    int end_x = std::min(2 * (cols - col), w4), end_y = std::min(2 * (rows - row), h4);
    const int16_t* qm = qmul[b.seg_id][0];
    bool total = false;
    auto merge = [](uint8_t* la, int end, int step) {
      for (int n = 0; n < end; n += step) {
        int any = 0;
        for (int k = 0; k < step; ++k) any |= la[n + k];
        la[n] = !!any;
      }
    };
    auto splat = [](uint8_t* la, int end, int step, bool whole) {
      for (int n = 0; n < end; n += step) {
        const int k = whole ? step - 1 : std::min(end - n - 1, step - 1);
        memset(&la[n + 1], la[n], k);
      }
    };
    const int step1d = 1 << tx;
    {
      uint8_t* a = &above_nnz[0][col * 2];
      uint8_t* l = &left_nnz[0][(row & 7) * 2];
      uint8_t(*p)[6][11] = coef[tx][0][!b.intra];
      unsigned(*c)[6][3] = counts.coef[tx][0][!b.intra];
      unsigned(*e)[6][2] = counts.eob[tx][0][!b.intra];
      if (step1d > 1) {
        merge(l, end_y, step1d);
        merge(a, end_x, step1d);
      }
      int n = 0;
      for (int y = 0; y < end_y; y += step1d)
        for (int x = 0; x < end_x; x += step1d, n += step1d * step1d) {
          const int txtp = luma_txtp(b, n);
          const int16_t* scan;
          const int16_t(*nb)[2];
          scan_of(lossless ? 0 : tx, lossless ? DCT_DCT : txtp, scan, nb);
          const int ret = decode_coeffs_b(yblock + 16 * n, 16 * step1d * step1d, tx == TX_32X32, c, e, p,
                                          a[x] + l[y], scan, nb, band_counts[tx], qm);
          a[x] = l[y] = !!ret;
          total |= !!ret;
          yeob[n] = (uint16_t)ret;
        }
      if (step1d > 1) {
        splat(a, end_x, step1d, end_x == w4);
        splat(l, end_y, step1d, end_y == h4);
      }
    }
    const int uvtx = b.uvtx, uvstep = 1 << uvtx;
    uint8_t(*p)[6][11] = coef[uvtx][1][!b.intra];
    unsigned(*c)[6][3] = counts.coef[uvtx][1][!b.intra];
    unsigned(*e)[6][2] = counts.eob[uvtx][1][!b.intra];
    w4 >>= 1;
    h4 >>= 1;
    end_x >>= 1;
    end_y >>= 1;
    const int16_t* scan;
    const int16_t(*nb)[2];
    scan_of(uvtx, DCT_DCT, scan, nb);
    for (int pl = 0; pl < 2; ++pl) {
      uint8_t* a = &above_nnz[1 + pl][col];
      uint8_t* l = &left_nnz[1 + pl][row & 7];
      if (uvstep > 1) {
        merge(l, end_y, uvstep);
        merge(a, end_x, uvstep);
      }
      int n = 0;
      for (int y = 0; y < end_y; y += uvstep)
        for (int x = 0; x < end_x; x += uvstep, n += uvstep * uvstep) {
          const int ret = decode_coeffs_b(uvblock[pl] + 16 * n, 16 * uvstep * uvstep, uvtx == TX_32X32, c, e, p,
                                          a[x] + l[y], scan, nb, band_counts[uvtx], qmul[b.seg_id][1]);
          a[x] = l[y] = !!ret;
          total |= !!ret;
          uveob[pl][n] = (uint16_t)ret;
        }
      if (uvstep > 1) {
        splat(a, end_x, uvstep, end_x == w4);
        splat(l, end_y, uvstep, end_y == h4);
      }
    }
    return total;
  }

  // ---------------------------------------------------------------- reconstruction

  // check_intra_mode: the edges of a transform block at 4-pixel (x, y) of a
  // block at mode-info (row, col) in plane p, and the mode to run
  int prepare_edges(int mode, uint8_t* above, uint8_t* left, const uint8_t* dst, int stride, int row, int col, int x,
                    int y, int w4, int tx, int p) {
    const int ss = p ? 1 : 0;
    const bool have_top = row > 0 || y > 0, have_left = col > tile_col_start || x > 0, have_right = x < w4 - 1;
    const int bs = 4 << tx;
    if (mode == DC) mode = have_left ? (have_top ? (int)DC : (int)LEFT_DC) : (have_top ? (int)TOP_DC : (int)DC_128);
    if (have_top) {
      const int n_have = (((cols - col) << !ss) - x) * 4;
      const uint8_t* top = dst - stride;
      for (int i = 0; i < bs; ++i) above[i] = top[std::min(i, n_have - 1)];
      if (tx == TX_4X4 && have_right && bs + 4 <= n_have)
        for (int i = 4; i < 8; ++i) above[i] = top[i];
      else
        memset(above + bs, above[bs - 1], bs);
      above[-1] = have_left ? top[-1] : 129;
    } else {
      memset(above, 127, 2 * bs);
      above[-1] = 127;
    }
    if (have_left) {
      const int n_have = (((rows - row) << !ss) - y) * 4;
      for (int i = 0; i < bs; ++i) left[i] = dst[std::min(i, n_have - 1) * stride - 1];
    } else {
      memset(left, 129, bs);
    }
    return mode;
  }

  void intra_recon(const Block& b, int row, int col) {
    const int w4 = kBw8[b.bs] * 2, h4 = kBh8[b.bs] * 2;
    int end_x = std::min(2 * (cols - col), w4), end_y = std::min(2 * (rows - row), h4);
    const int tx = b.tx, step1d = 1 << tx;
    uint8_t abuf[96], lbuf[64];
    uint8_t* above = abuf + 32;
    const int ys = cur->stride[0];
    uint8_t* base = cur->plane[0].data() + (size_t)row * 8 * ys + col * 8;
    int n = 0;
    for (int y = 0; y < end_y; y += step1d)
      for (int x = 0; x < end_x; x += step1d, n += step1d * step1d) {
        uint8_t* ptr = base + (size_t)y * 4 * ys + x * 4;
        int mode = b.mode[b.bs > BS_8x8 && tx == TX_4X4 ? n : 0];
        const int txtp = luma_txtp(b, n);
        stats[ST_MODE_V + mode]++;
        mode = prepare_edges(mode, above, lbuf, ptr, ys, row, col, x, y, w4, tx, 0);
        intra_pred(ptr, ys, mode, 4 << tx, above, lbuf);
        const int eob = b.skip ? 0 : yeob[n];
        if (eob) {
          itxfm_add(ptr, ys, yblock + 16 * n, lossless ? 4 : tx, txtp, eob);
          stats[lossless ? ST_WHT : ST_DCT_DCT + txtp]++;
        }
      }
    const int uvtx = b.uvtx, uvstep = 1 << uvtx;
    const int uw4 = w4 >> 1;
    end_x >>= 1;
    end_y >>= 1;
    for (int pl = 0; pl < 2; ++pl) {
      const int us = cur->stride[1 + pl];
      uint8_t* ubase = cur->plane[1 + pl].data() + (size_t)row * 4 * us + col * 4;
      int m = 0;
      for (int y = 0; y < end_y; y += uvstep)
        for (int x = 0; x < end_x; x += uvstep, m += uvstep * uvstep) {
          uint8_t* ptr = ubase + (size_t)y * 4 * us + x * 4;
          int mode = prepare_edges(b.uvmode, above, lbuf, ptr, us, row, col, x, y, uw4, uvtx, 1);
          intra_pred(ptr, us, mode, 4 << uvtx, above, lbuf);
          const int eob = b.skip ? 0 : uveob[pl][m];
          if (eob) itxfm_add(ptr, us, uvblock[pl] + 16 * m, lossless ? 4 : uvtx, DCT_DCT, eob);
        }
    }
  }

  // one block of motion-compensated prediction: ``ref`` plane p read from
  // integer position (px, py) with 1/16 fractions (fx, fy), its edges repeated
  static void mc(uint8_t* dst, int ds, const Picture& ref, int p, int px, int py, int fx, int fy, int bw, int bh,
                 int filter, bool avg) {
    const int pw = p ? (ref.width + 1) >> 1 : ref.width, ph = p ? (ref.height + 1) >> 1 : ref.height;
    const uint8_t* src = ref.plane[p].data();
    const int ss = ref.stride[p];
    uint8_t buf[(64 + 7) * (64 + 7)];
    const int bstride = 64 + 7;
    const uint8_t* s0;
    int sstride;
    if (px - 3 >= 0 && py - 3 >= 0 && px + bw + 4 <= pw && py + bh + 4 <= ph) {
      s0 = src + (size_t)(py - 3) * ss + (px - 3);
      sstride = ss;
    } else {
      for (int r = 0; r < bh + 7; ++r) {
        const uint8_t* row = src + (size_t)clip(py - 3 + r, 0, ph - 1) * ss;
        for (int c = 0; c < bw + 7; ++c) buf[r * bstride + c] = row[clip(px - 3 + c, 0, pw - 1)];
      }
      s0 = buf;
      sstride = bstride;
    }
    int16_t kx[8], ky[8];
    auto kernel = [&](int f, int16_t* k) {
      if (filter == FILTER_BILINEAR) {
        memset(k, 0, 8 * sizeof(int16_t));
        k[3] = (int16_t)(128 - 8 * f);
        k[4] = (int16_t)(8 * f);
      } else {
        static const int bank[3] = {1, 0, 2};  // regular, smooth, sharp in kSubpelFilters' order
        memcpy(k, kSubpelFilters[bank[filter]][f], 8 * sizeof(int16_t));
      }
    };
    kernel(fx, kx);
    kernel(fy, ky);
    uint8_t tmp[(64 + 7) * 64];
    // horizontal pass over bh + 7 rows into tmp (clipped to 8 bits, as libvpx and FFmpeg)
    for (int r = 0; r < bh + 7; ++r) {
      const uint8_t* s = s0 + (size_t)r * sstride + 3;
      uint8_t* t = tmp + r * 64;
      if (fx == 0) {
        memcpy(t, s, bw);
      } else {
        for (int c = 0; c < bw; ++c) {
          int sum = 64;
          for (int k = 0; k < 8; ++k) sum += kx[k] * s[c + k - 3];
          t[c] = clip8(sum >> 7);
        }
      }
    }
    for (int r = 0; r < bh; ++r) {
      uint8_t* d = dst + (size_t)r * ds;
      const uint8_t* t = tmp + (r + 3) * 64;
      for (int c = 0; c < bw; ++c) {
        int v;
        if (fy == 0) {
          v = t[c];
        } else {
          int sum = 64;
          for (int k = 0; k < 8; ++k) sum += ky[k] * t[c + (k - 3) * 64];
          v = clip8(sum >> 7);
        }
        d[c] = avg ? (uint8_t)((d[c] + v + 1) >> 1) : (uint8_t)v;
      }
    }
  }

  int inter_recon(const Block& b, int row, int col) {
    for (int z = 0; z < 1 + b.comp; ++z) {
      const Picture& ref = *refs[refidx[b.rf[z] - 1]];
      if (ref.width != w || ref.height != h) {
        char buf[200];
        snprintf(buf, sizeof(buf),
                 "a %dx%d reference of a %dx%d frame: scaled motion compensation (reference scaling) is not decoded",
                 ref.width, ref.height, w, h);
        return fail(kUnsupported, buf);
      }
    }
    stats[ST_FILTER_REGULAR + b.filter]++;
    if (b.comp) stats[ST_COMPOUND]++;
    const int ys = cur->stride[0], us = cur->stride[1];
    uint8_t* dy = cur->plane[0].data() + (size_t)row * 8 * ys + col * 8;
    uint8_t* du = cur->plane[1].data() + (size_t)row * 4 * us + col * 4;
    uint8_t* dv = cur->plane[2].data() + (size_t)row * 4 * us + col * 4;
    auto luma = [&](const Picture& ref, uint8_t* d, int x, int y, Mv mv, int bw, int bh, bool avg) {
      mc(d, ys, ref, 0, x + (mv.x >> 3), y + (mv.y >> 3), (mv.x & 7) << 1, (mv.y & 7) << 1, bw, bh, b.filter, avg);
    };
    auto chroma = [&](const Picture& ref, int x, int y, Mv mv, int bw, int bh, bool avg) {
      for (int pl = 1; pl <= 2; ++pl)
        mc(pl == 1 ? du : dv, us, ref, pl, x + (mv.x >> 4), y + (mv.y >> 4), mv.x & 15, mv.y & 15, bw, bh, b.filter,
           avg);
    };
    auto rdiv = [](int a, int d) { return (a >= 0 ? a + (d >> 1) : a - (d >> 1)) / d; };
    for (int z = 0; z < 1 + b.comp; ++z) {
      const Picture& ref = *refs[refidx[b.rf[z] - 1]];
      const bool avg = z == 1;
      const int x = col * 8, y = row * 8;
      if (b.bs > BS_8x8) {
        stats[ST_SUB8X8]++;
        Mv uvmv;
        if (b.bs == BS_8x4) {
          luma(ref, dy, x, y, b.mv[0][z], 8, 4, avg);
          luma(ref, dy + 4 * ys, x, y + 4, b.mv[2][z], 8, 4, avg);
          uvmv.x = (int16_t)rdiv(b.mv[0][z].x + b.mv[2][z].x, 2);
          uvmv.y = (int16_t)rdiv(b.mv[0][z].y + b.mv[2][z].y, 2);
        } else if (b.bs == BS_4x8) {
          luma(ref, dy, x, y, b.mv[0][z], 4, 8, avg);
          luma(ref, dy + 4, x + 4, y, b.mv[1][z], 4, 8, avg);
          uvmv.x = (int16_t)rdiv(b.mv[0][z].x + b.mv[1][z].x, 2);
          uvmv.y = (int16_t)rdiv(b.mv[0][z].y + b.mv[1][z].y, 2);
        } else {
          luma(ref, dy, x, y, b.mv[0][z], 4, 4, avg);
          luma(ref, dy + 4, x + 4, y, b.mv[1][z], 4, 4, avg);
          luma(ref, dy + 4 * ys, x, y + 4, b.mv[2][z], 4, 4, avg);
          luma(ref, dy + 4 * ys + 4, x + 4, y + 4, b.mv[3][z], 4, 4, avg);
          uvmv.x = (int16_t)rdiv(b.mv[0][z].x + b.mv[1][z].x + b.mv[2][z].x + b.mv[3][z].x, 4);
          uvmv.y = (int16_t)rdiv(b.mv[0][z].y + b.mv[1][z].y + b.mv[2][z].y + b.mv[3][z].y, 4);
        }
        chroma(ref, col * 4, row * 4, uvmv, 4, 4, avg);
      } else {
        const int bw = kBw4[b.bs] * 4, bh = kBh4[b.bs] * 4;
        luma(ref, dy, x, y, b.mv[0][z], bw, bh, avg);
        chroma(ref, col * 4, row * 4, b.mv[0][z], bw >> 1, bh >> 1, avg);
      }
    }
    if (!b.skip) {
      const int w4 = kBw8[b.bs] * 2, h4 = kBh8[b.bs] * 2;
      int end_x = std::min(2 * (cols - col), w4), end_y = std::min(2 * (rows - row), h4);
      const int tx = lossless ? 4 : b.tx, step1d = 1 << b.tx;
      int n = 0;
      for (int y = 0; y < end_y; y += step1d)
        for (int x = 0; x < end_x; x += step1d, n += step1d * step1d)
          if (yeob[n]) {
            itxfm_add(dy + (size_t)y * 4 * ys + x * 4, ys, yblock + 16 * n, tx, DCT_DCT, yeob[n]);
            stats[lossless ? ST_WHT : ST_DCT_DCT]++;
          }
      end_x >>= 1;
      end_y >>= 1;
      const int uvtx = lossless ? 4 : b.uvtx, uvstep = 1 << b.uvtx;
      for (int pl = 0; pl < 2; ++pl) {
        uint8_t* d = pl ? dv : du;
        int m = 0;
        for (int y = 0; y < end_y; y += uvstep)
          for (int x = 0; x < end_x; x += uvstep, m += uvstep * uvstep)
            if (uveob[pl][m]) itxfm_add(d + (size_t)y * 4 * us + x * 4, us, uvblock[pl] + 16 * m, uvtx, DCT_DCT, uveob[pl][m]);
      }
    }
    return kOk;
  }

  int decode_block(int row, int col, int bl, int bp) {
    const int bs = bl * 3 + bp;
    blocks.emplace_back();
    const int32_t bi = (int32_t)blocks.size() - 1;
    Block& b = blocks.back();
    b = Block{};
    b.bs = (uint8_t)bs;
    b.row = row;
    b.col = col;
    const int bw8 = kBw8[bs], bh8 = kBh8[bs];
    const int w8 = std::min(cols - col, bw8), h8 = std::min(rows - row, bh8);
    for (int y = 0; y < h8; ++y)
      for (int x = 0; x < w8; ++x) grid[(size_t)(row + y) * cols + col + x] = bi;
    min_mv_x = -(128 + col * 64);
    min_mv_y = -(128 + row * 64);
    max_mv_x = 128 + (cols - col - bw8) * 64;
    max_mv_y = 128 + (rows - row - bh8) * 64;
    decode_mode(b, row, col);
    b.uvtx = (uint8_t)(b.tx - ((bw8 * 2 == (1 << b.tx)) || (bh8 * 2 == (1 << b.tx))));
    stats[ST_TX4 + b.tx]++;
    if (b.mode[0] == NEWMV || b.mode[3] == NEWMV) stats[ST_NEWMV]++;
    const int row7 = row & 7;
    if (!b.skip) {
      const bool has = decode_coeffs(b, row, col);
      if (!has && b.bs <= BS_8x8 && !b.intra) b.skip = 1;
    } else {
      memset(&above_nnz[0][col * 2], 0, bw8 * 2);
      memset(&left_nnz[0][row7 * 2], 0, bh8 * 2);
      for (int pl = 1; pl < 3; ++pl) {
        memset(&above_nnz[pl][col], 0, bw8);
        memset(&left_nnz[pl][row7], 0, bh8);
      }
    }
    memset(&above_partition[col], kAbovePartitionCtx[bs], bw8);
    memset(&left_partition[row7], kLeftPartitionCtx[bs], bh8);
    if (b.intra) {
      intra_recon(b, row, col);
    } else if (int st = inter_recon(b, row, col)) {
      return st;
    }
    b.lf_level = filter_level ? lflvl[b.seg_id][b.intra ? 0 : b.rf[0]][b.mode[3] != ZEROMV] : 0;
    return kOk;
  }

  int decode_sb(int row, int col, int bl) {
    const int c = ((above_partition[col] >> (3 - bl)) & 1) | (((left_partition[row & 7] >> (3 - bl)) & 1) << 1);
    const uint8_t* p = (keyframe || intraonly) ? kKfPartitionProbs[bl][c] : prob.partition[bl][c];
    const int hbs = 4 >> bl;
    int bp, st;
    if (bl == 3) {
      bp = rac.tree(kPartitionTree, p);
      st = decode_block(row, col, bl, bp);
    } else if (col + hbs < cols) {
      if (row + hbs < rows) {
        bp = rac.tree(kPartitionTree, p);
        switch (bp) {
          case PARTITION_NONE:
            st = decode_block(row, col, bl, bp);
            break;
          case PARTITION_H:
            if (!(st = decode_block(row, col, bl, bp))) st = decode_block(row + hbs, col, bl, bp);
            break;
          case PARTITION_V:
            if (!(st = decode_block(row, col, bl, bp))) st = decode_block(row, col + hbs, bl, bp);
            break;
          default:
            if (!(st = decode_sb(row, col, bl + 1)) && !(st = decode_sb(row, col + hbs, bl + 1)) &&
                !(st = decode_sb(row + hbs, col, bl + 1)))
              st = decode_sb(row + hbs, col + hbs, bl + 1);
        }
      } else if (rac.get(p[1])) {
        bp = PARTITION_SPLIT;
        if (!(st = decode_sb(row, col, bl + 1))) st = decode_sb(row, col + hbs, bl + 1);
      } else {
        bp = PARTITION_H;
        st = decode_block(row, col, bl, bp);
      }
    } else if (row + hbs < rows) {
      if (rac.get(p[2])) {
        bp = PARTITION_SPLIT;
        if (!(st = decode_sb(row, col, bl + 1))) st = decode_sb(row + hbs, col, bl + 1);
      } else {
        bp = PARTITION_V;
        st = decode_block(row, col, bl, bp);
      }
    } else {
      bp = PARTITION_SPLIT;
      st = decode_sb(row, col, bl + 1);
    }
    counts.partition[bl][c][bp]++;
    return st;
  }

  // ---------------------------------------------------------------- the loop filter

  struct Mask {
    uint64_t left_y[4], above_y[4], int_4x4_y;
    uint16_t left_uv[4], above_uv[4], int_4x4_uv;
    uint8_t lfl_y[64];
  };

  void build_mask(Mask& m, const Block& b) {
    const int lvl = b.lf_level;
    if (!lvl) return;
    const int bw8 = kBw8[b.bs], bh8 = kBh8[b.bs];
    const int shift_y = (b.row & 7) * 8 + (b.col & 7);
    for (int i = 0; i < bh8; ++i) memset(&m.lfl_y[shift_y + i * 8], lvl, bw8);
    uint64_t above = (1ULL << bw8) - 1, left = 0, size = 0;
    for (int i = 0; i < bh8; ++i) {
      left |= 1ULL << (8 * i);
      size |= above << (8 * i);
    }
    static const uint64_t left_tx[4] = {~0ULL, ~0ULL, 0x5555555555555555ULL, 0x1111111111111111ULL};
    static const uint64_t above_tx[4] = {~0ULL, ~0ULL, 0x00ff00ff00ff00ffULL, 0x000000ff000000ffULL};
    static const uint16_t left_tx_uv[4] = {0xffff, 0xffff, 0x5555, 0x1111};
    static const uint16_t above_tx_uv[4] = {0xffff, 0xffff, 0x0f0f, 0x000f};
    const bool uv = !(b.row & 1) && !(b.col & 1);
    const int uw = (bw8 + 1) >> 1, uh = (bh8 + 1) >> 1;
    const int shift_uv = ((b.row & 7) >> 1) * 4 + ((b.col & 7) >> 1);
    uint16_t above_uv = (uint16_t)((1 << uw) - 1), left_uv = 0, size_uv = 0;
    for (int i = 0; i < uh; ++i) {
      left_uv |= (uint16_t)(1 << (4 * i));
      size_uv |= (uint16_t)(above_uv << (4 * i));
    }
    m.above_y[b.tx] |= above << shift_y;
    m.left_y[b.tx] |= left << shift_y;
    if (uv) {
      m.above_uv[b.uvtx] |= (uint16_t)(above_uv << shift_uv);
      m.left_uv[b.uvtx] |= (uint16_t)(left_uv << shift_uv);
    }
    if (b.skip && !b.intra) return;
    m.above_y[b.tx] |= (size & above_tx[b.tx]) << shift_y;
    m.left_y[b.tx] |= (size & left_tx[b.tx]) << shift_y;
    if (uv) {
      m.above_uv[b.uvtx] |= (uint16_t)((size_uv & above_tx_uv[b.uvtx]) << shift_uv);
      m.left_uv[b.uvtx] |= (uint16_t)((size_uv & left_tx_uv[b.uvtx]) << shift_uv);
    }
    if (b.tx == TX_4X4) m.int_4x4_y |= size << shift_y;
    if (uv && b.uvtx == TX_4X4) m.int_4x4_uv |= (uint16_t)(size_uv << shift_uv);
  }

  void loop_filter() {
    int lim[64], mblim[64];
    for (int lvl = 0; lvl < 64; ++lvl) {
      int limit = lvl >> ((sharpness > 0) + (sharpness > 4));
      if (sharpness > 0) limit = std::min(limit, 9 - sharpness);
      limit = std::max(limit, 1);
      lim[lvl] = limit;
      mblim[lvl] = 2 * (lvl + 2) + limit;
    }
    auto edge = [&](uint8_t* s, int step, int along, int size, int lvl) {
      lpf_edge(s, step, along, size, lim[lvl], mblim[lvl], lvl >> 4);
    };
    for (int sbr = 0; sbr < sb_rows; ++sbr)
      for (int sbc = 0; sbc < sb_cols; ++sbc) {
        const int mi_row = sbr * 8, mi_col = sbc * 8;
        Mask m;
        memset(&m, 0, sizeof(m));
        for (int r = mi_row; r < std::min(rows, mi_row + 8); ++r)
          for (int c = mi_col; c < std::min(cols, mi_col + 8); ++c) {
            const Block& b = blocks[grid[(size_t)r * cols + c]];
            if (b.row == r && b.col == c) build_mask(m, b);
          }
        m.left_y[TX_16X16] |= m.left_y[TX_32X32];
        m.above_y[TX_16X16] |= m.above_y[TX_32X32];
        m.left_uv[TX_16X16] |= m.left_uv[TX_32X32];
        m.above_uv[TX_16X16] |= m.above_uv[TX_32X32];
        const uint64_t left_border = 0x1111111111111111ULL, above_border = 0x000000ff000000ffULL;
        const uint16_t left_border_uv = 0x1111, above_border_uv = 0x000f;
        m.left_y[TX_8X8] |= m.left_y[TX_4X4] & left_border;
        m.left_y[TX_4X4] &= ~left_border;
        m.above_y[TX_8X8] |= m.above_y[TX_4X4] & above_border;
        m.above_y[TX_4X4] &= ~above_border;
        m.left_uv[TX_8X8] |= m.left_uv[TX_4X4] & left_border_uv;
        m.left_uv[TX_4X4] &= (uint16_t)~left_border_uv;
        m.above_uv[TX_8X8] |= m.above_uv[TX_4X4] & above_border_uv;
        m.above_uv[TX_4X4] &= (uint16_t)~above_border_uv;
        if (mi_row + 8 > rows) {
          const uint64_t nr = rows - mi_row;
          const uint64_t mask_y = (1ULL << (nr << 3)) - 1;
          const uint16_t mask_uv = (uint16_t)((1 << (((nr + 1) >> 1) << 2)) - 1);
          for (int i = 0; i < TX_32X32; i++) {
            m.left_y[i] &= mask_y;
            m.above_y[i] &= mask_y;
            m.left_uv[i] &= mask_uv;
            m.above_uv[i] &= mask_uv;
          }
          m.int_4x4_y &= mask_y;
          m.int_4x4_uv &= mask_uv;
          if (nr == 1) {
            m.above_uv[TX_8X8] |= m.above_uv[TX_16X16];
            m.above_uv[TX_16X16] = 0;
          }
          if (nr == 5) {
            m.above_uv[TX_8X8] |= m.above_uv[TX_16X16] & 0xff00;
            m.above_uv[TX_16X16] &= (uint16_t)~(m.above_uv[TX_16X16] & 0xff00);
          }
        }
        if (mi_col + 8 > cols) {
          const uint64_t nc = cols - mi_col;
          const uint64_t mask_y = ((1ULL << nc) - 1) * 0x0101010101010101ULL;
          const uint16_t mask_uv = (uint16_t)(((1 << ((nc + 1) >> 1)) - 1) * 0x1111);
          const uint16_t mask_uv_int = (uint16_t)(((1 << (nc >> 1)) - 1) * 0x1111);
          for (int i = 0; i < TX_32X32; i++) {
            m.left_y[i] &= mask_y;
            m.above_y[i] &= mask_y;
            m.left_uv[i] &= mask_uv;
            m.above_uv[i] &= mask_uv;
          }
          m.int_4x4_y &= mask_y;
          m.int_4x4_uv &= mask_uv_int;
          if (nc == 1) {
            m.left_uv[TX_8X8] |= m.left_uv[TX_16X16];
            m.left_uv[TX_16X16] = 0;
          }
          if (nc == 5) {
            m.left_uv[TX_8X8] |= (m.left_uv[TX_16X16] & 0xcccc);
            m.left_uv[TX_16X16] &= (uint16_t)~(m.left_uv[TX_16X16] & 0xcccc);
          }
        }
        if (mi_col == 0) {
          for (int i = 0; i < TX_32X32; i++) {
            m.left_y[i] &= 0xfefefefefefefefeULL;
            m.left_uv[i] &= 0xeeee;
          }
        }
        // luma: vertical edges, then horizontal
        const int ys = cur->stride[0];
        uint8_t* y0 = cur->plane[0].data() + (size_t)mi_row * 8 * ys + mi_col * 8;
        for (int r = 0; r < 8 && mi_row + r < rows; ++r)
          for (int c = 0; c < 8; ++c) {
            const int bit = r * 8 + c;
            uint8_t* s = y0 + (size_t)r * 8 * ys + c * 8;
            const int lvl = m.lfl_y[bit];
            if ((m.left_y[TX_16X16] >> bit) & 1) edge(s, 1, ys, 16, lvl);
            else if ((m.left_y[TX_8X8] >> bit) & 1) edge(s, 1, ys, 8, lvl);
            else if ((m.left_y[TX_4X4] >> bit) & 1) edge(s, 1, ys, 4, lvl);
            if ((m.int_4x4_y >> bit) & 1) edge(s + 4, 1, ys, 4, lvl);
          }
        for (int r = 0; r < 8 && mi_row + r < rows; ++r)
          for (int c = 0; c < 8; ++c) {
            const int bit = r * 8 + c;
            uint8_t* s = y0 + (size_t)r * 8 * ys + c * 8;
            const int lvl = m.lfl_y[bit];
            if (mi_row + r > 0) {
              if ((m.above_y[TX_16X16] >> bit) & 1) edge(s, ys, 1, 16, lvl);
              else if ((m.above_y[TX_8X8] >> bit) & 1) edge(s, ys, 1, 8, lvl);
              else if ((m.above_y[TX_4X4] >> bit) & 1) edge(s, ys, 1, 4, lvl);
            }
            if ((m.int_4x4_y >> bit) & 1) edge(s + 4 * ys, ys, 1, 4, lvl);
          }
        // chroma (4:2:0): each bit an 8x8 block, its level the top-left luma unit's
        for (int pl = 1; pl < 3; ++pl) {
          const int us = cur->stride[pl];
          uint8_t* u0 = cur->plane[pl].data() + (size_t)mi_row * 4 * us + mi_col * 4;
          for (int r = 0; r < 4 && mi_row + 2 * r < rows; ++r)
            for (int c = 0; c < 4; ++c) {
              const int bit = r * 4 + c;
              uint8_t* s = u0 + (size_t)r * 8 * us + c * 8;
              const int lvl = m.lfl_y[(r * 2) * 8 + c * 2];
              if ((m.left_uv[TX_16X16] >> bit) & 1) edge(s, 1, us, 16, lvl);
              else if ((m.left_uv[TX_8X8] >> bit) & 1) edge(s, 1, us, 8, lvl);
              else if ((m.left_uv[TX_4X4] >> bit) & 1) edge(s, 1, us, 4, lvl);
              if ((m.int_4x4_uv >> bit) & 1) edge(s + 4, 1, us, 4, lvl);
            }
          for (int r = 0; r < 4 && mi_row + 2 * r < rows; ++r) {
            const bool skip_border_4x4 = mi_row + 2 * r == rows - 1;
            for (int c = 0; c < 4; ++c) {
              const int bit = r * 4 + c;
              uint8_t* s = u0 + (size_t)r * 8 * us + c * 8;
              const int lvl = m.lfl_y[(r * 2) * 8 + c * 2];
              if (mi_row + 2 * r > 0) {
                if ((m.above_uv[TX_16X16] >> bit) & 1) edge(s, us, 1, 16, lvl);
                else if ((m.above_uv[TX_8X8] >> bit) & 1) edge(s, us, 1, 8, lvl);
                else if ((m.above_uv[TX_4X4] >> bit) & 1) edge(s, us, 1, 4, lvl);
              }
              if (!skip_border_4x4 && ((m.int_4x4_uv >> bit) & 1)) edge(s + 4 * us, us, 1, 4, lvl);
            }
          }
        }
      }
  }

  // ---------------------------------------------------------------- adaptation (vp9prob.c)

  static void adapt_prob(uint8_t* p, unsigned ct0, unsigned ct1, int max_count, int update_factor) {
    const unsigned ct = ct0 + ct1;
    if (!ct) return;
    update_factor = update_factor * (int)std::min(ct, (unsigned)max_count) / max_count;
    const int p1 = *p;
    int p2 = (int)((((int64_t)ct0 << 8) + (ct >> 1)) / ct);
    p2 = clip(p2, 1, 255);
    *p = (uint8_t)(p1 + (((p2 - p1) * update_factor + 128) >> 8));
  }

  void adapt_probs() {
    Probs* p = &ctx[framectxid].p;
    const int uf = (keyframe || intraonly || !last_keyframe) ? 112 : 128;
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 2; j++)
        for (int k = 0; k < 2; k++)
          for (int l = 0; l < 6; l++)
            for (int m = 0; m < 6; m++) {
              uint8_t* pp = ctx[framectxid].coef[i][j][k][l][m];
              unsigned* e = counts.eob[i][j][k][l][m];
              unsigned* c = counts.coef[i][j][k][l][m];
              if (l == 0 && m >= 3) break;
              adapt_prob(&pp[0], e[0], e[1], 24, uf);
              adapt_prob(&pp[1], c[0], c[1] + c[2], 24, uf);
              adapt_prob(&pp[2], c[1], c[2], 24, uf);
            }
    if (keyframe || intraonly) {
      memcpy(p->skip, prob.skip, sizeof(p->skip));
      memcpy(p->tx32p, prob.tx32p, sizeof(p->tx32p));
      memcpy(p->tx16p, prob.tx16p, sizeof(p->tx16p));
      memcpy(p->tx8p, prob.tx8p, sizeof(p->tx8p));
      return;
    }
    for (int i = 0; i < 3; i++) adapt_prob(&p->skip[i], counts.skip[i][0], counts.skip[i][1], 20, 128);
    for (int i = 0; i < 4; i++) adapt_prob(&p->intra[i], counts.intra[i][0], counts.intra[i][1], 20, 128);
    if (comppred == PRED_SWITCHABLE)
      for (int i = 0; i < 5; i++) adapt_prob(&p->comp[i], counts.comp[i][0], counts.comp[i][1], 20, 128);
    if (comppred != PRED_SINGLE)
      for (int i = 0; i < 5; i++) adapt_prob(&p->comp_ref[i], counts.comp_ref[i][0], counts.comp_ref[i][1], 20, 128);
    if (comppred != PRED_COMPOUND)
      for (int i = 0; i < 5; i++) {
        adapt_prob(&p->single_ref[i][0], counts.single_ref[i][0][0], counts.single_ref[i][0][1], 20, 128);
        adapt_prob(&p->single_ref[i][1], counts.single_ref[i][1][0], counts.single_ref[i][1][1], 20, 128);
      }
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 4; j++) {
        uint8_t* pp = p->partition[i][j];
        unsigned* c = counts.partition[i][j];
        adapt_prob(&pp[0], c[0], c[1] + c[2] + c[3], 20, 128);
        adapt_prob(&pp[1], c[1], c[2] + c[3], 20, 128);
        adapt_prob(&pp[2], c[2], c[3], 20, 128);
      }
    if (txfmmode == TX_SWITCHABLE)
      for (int i = 0; i < 2; i++) {
        unsigned *c16 = counts.tx16p[i], *c32 = counts.tx32p[i];
        adapt_prob(&p->tx8p[i], counts.tx8p[i][0], counts.tx8p[i][1], 20, 128);
        adapt_prob(&p->tx16p[i][0], c16[0], c16[1] + c16[2], 20, 128);
        adapt_prob(&p->tx16p[i][1], c16[1], c16[2], 20, 128);
        adapt_prob(&p->tx32p[i][0], c32[0], c32[1] + c32[2] + c32[3], 20, 128);
        adapt_prob(&p->tx32p[i][1], c32[1], c32[2] + c32[3], 20, 128);
        adapt_prob(&p->tx32p[i][2], c32[2], c32[3], 20, 128);
      }
    if (filtermode == FILTER_SWITCHABLE)
      for (int i = 0; i < 4; i++) {
        uint8_t* pp = p->filter[i];
        unsigned* c = counts.filter[i];
        adapt_prob(&pp[0], c[0], c[1] + c[2], 20, 128);
        adapt_prob(&pp[1], c[1], c[2], 20, 128);
      }
    for (int i = 0; i < 7; i++) {
      uint8_t* pp = p->mv_mode[i];
      unsigned* c = counts.mv_mode[i];
      adapt_prob(&pp[0], c[2], c[1] + c[0] + c[3], 20, 128);
      adapt_prob(&pp[1], c[0], c[1] + c[3], 20, 128);
      adapt_prob(&pp[2], c[1], c[3], 20, 128);
    }
    {
      uint8_t* pp = p->mv_joint;
      unsigned* c = counts.mv_joint;
      adapt_prob(&pp[0], c[0], c[1] + c[2] + c[3], 20, 128);
      adapt_prob(&pp[1], c[1], c[2] + c[3], 20, 128);
      adapt_prob(&pp[2], c[2], c[3], 20, 128);
    }
    for (int i = 0; i < 2; i++) {
      auto& pc = p->mv_comp[i];
      auto& cc = counts.mv_comp[i];
      adapt_prob(&pc.sign, cc.sign[0], cc.sign[1], 20, 128);
      uint8_t* pp = pc.classes;
      unsigned* c = cc.classes;
      unsigned sum = c[1] + c[2] + c[3] + c[4] + c[5] + c[6] + c[7] + c[8] + c[9] + c[10];
      adapt_prob(&pp[0], c[0], sum, 20, 128);
      sum -= c[1];
      adapt_prob(&pp[1], c[1], sum, 20, 128);
      sum -= c[2] + c[3];
      adapt_prob(&pp[2], c[2] + c[3], sum, 20, 128);
      adapt_prob(&pp[3], c[2], c[3], 20, 128);
      sum -= c[4] + c[5];
      adapt_prob(&pp[4], c[4] + c[5], sum, 20, 128);
      adapt_prob(&pp[5], c[4], c[5], 20, 128);
      sum -= c[6];
      adapt_prob(&pp[6], c[6], sum, 20, 128);
      adapt_prob(&pp[7], c[7] + c[8], c[9] + c[10], 20, 128);
      adapt_prob(&pp[8], c[7], c[8], 20, 128);
      adapt_prob(&pp[9], c[9], c[10], 20, 128);
      adapt_prob(&pc.class0, cc.class0[0], cc.class0[1], 20, 128);
      for (int j = 0; j < 10; j++) adapt_prob(&pc.bits[j], cc.bits[j][0], cc.bits[j][1], 20, 128);
      for (int j = 0; j < 2; j++) {
        uint8_t* q = pc.class0_fp[j];
        unsigned* d = cc.class0_fp[j];
        adapt_prob(&q[0], d[0], d[1] + d[2] + d[3], 20, 128);
        adapt_prob(&q[1], d[1], d[2] + d[3], 20, 128);
        adapt_prob(&q[2], d[2], d[3], 20, 128);
      }
      adapt_prob(&pc.fp[0], cc.fp[0], cc.fp[1] + cc.fp[2] + cc.fp[3], 20, 128);
      adapt_prob(&pc.fp[1], cc.fp[1], cc.fp[2] + cc.fp[3], 20, 128);
      adapt_prob(&pc.fp[2], cc.fp[2], cc.fp[3], 20, 128);
      if (hp) {
        adapt_prob(&pc.class0_hp, cc.class0_hp[0], cc.class0_hp[1], 20, 128);
        adapt_prob(&pc.hp, cc.hp[0], cc.hp[1], 20, 128);
      }
    }
    auto modes = [](uint8_t* pp, const unsigned* c) {
      unsigned sum = c[0] + c[1] + c[3] + c[4] + c[5] + c[6] + c[7] + c[8] + c[9], s2;
      adapt_prob(&pp[0], c[DC], sum, 20, 128);
      sum -= c[TM];
      adapt_prob(&pp[1], c[TM], sum, 20, 128);
      sum -= c[VERT];
      adapt_prob(&pp[2], c[VERT], sum, 20, 128);
      s2 = c[HOR] + c[D135] + c[D117];
      sum -= s2;
      adapt_prob(&pp[3], s2, sum, 20, 128);
      s2 -= c[HOR];
      adapt_prob(&pp[4], c[HOR], s2, 20, 128);
      adapt_prob(&pp[5], c[D135], c[D117], 20, 128);
      sum -= c[D45];
      adapt_prob(&pp[6], c[D45], sum, 20, 128);
      sum -= c[D63];
      adapt_prob(&pp[7], c[D63], sum, 20, 128);
      adapt_prob(&pp[8], c[D153], c[D207], 20, 128);
    };
    for (int i = 0; i < 4; i++) modes(p->y_mode[i], counts.y_mode[i]);
    for (int i = 0; i < 10; i++) modes(p->uv_mode[i], counts.uv_mode[i]);
  }

  // ---------------------------------------------------------------- frames

  static void set_tile_offset(int& start, int& end, int idx, int log2_n, int n) {
    const int sb_start = (idx * n) >> log2_n, sb_end = ((idx + 1) * n) >> log2_n;
    start = std::min(sb_start, n) << 3;
    end = std::min(sb_end, n) << 3;
  }

  // Decode one frame (not a superframe). ``shown`` is set to the frame to
  // output, or null for a hidden frame.
  int decode_frame(const uint8_t* data, size_t size, const uint8_t* mem_end, PicPtr& shown) {
    shown.reset();
    if (size < 1) return fail(kDamaged, "an empty frame");
    const bool retain_segmap = segmap_ref && (!seg.enabled || !seg.update_map);
    int existing;
    size_t header_bytes;
    if (int st = read_uncompressed(data, size, existing, header_bytes)) return st;
    if (existing >= 0) {
      if (!refs[existing]) return fail(kDamaged, "show_existing_frame of an empty slot");
      stats[ST_SHOW_EXISTING]++;
      shown = refs[existing];
      return kOk;
    }
    if (int st = read_compressed(data + header_bytes, mem_end)) return st;
    stats[keyframe ? ST_KEY_FRAMES : ST_INTER_FRAMES]++;
    if (intraonly) stats[ST_INTRA_ONLY_FRAMES]++;
    if (invisible) stats[ST_HIDDEN_FRAMES]++;
    if (lossless) stats[ST_LOSSLESS_FRAMES]++;
    if (seg.enabled) stats[ST_SEGMENTED_FRAMES]++;
    if (errorres) stats[ST_ERROR_RESILIENT_FRAMES]++;
    if (use_last_mvs && !keyframe && !intraonly) stats[ST_PREV_FRAME_MVS]++;
    if (log2_tile_cols || log2_tile_rows) stats[ST_MULTI_TILE_FRAMES]++;

    const bool intra_frame = keyframe || intraonly;
    PicPtr src = (!intra_frame && !errorres) ? last : PicPtr();
    if (!retain_segmap || intra_frame) segmap_ref = src;
    mvpair_ref = src;
    cur = std::make_shared<Picture>();
    cur->alloc(w, h);
    cur->full_range = full_range;
    if (full_range) stats[ST_FULL_RANGE_FRAMES]++;
    if (seg.enabled && !seg.update_map && !intra_frame && !errorres && segmap_ref) cur->segmap = segmap_ref->segmap;
    if (!mvpair_ref || mvpair_ref->width != w || mvpair_ref->height != h) segmap_ref.reset();
    if (use_last_mvs && (!mvpair_ref || mvpair_ref->width != w || mvpair_ref->height != h)) use_last_mvs = false;

    cols = cur->cols;
    rows = cur->rows;
    sb_cols = (cols + 7) >> 3;
    sb_rows = (rows + 7) >> 3;
    blocks.clear();
    blocks.reserve(std::min<size_t>((size_t)cols * rows, 1 << 16));
    grid.assign((size_t)cols * rows, 0);
    above_partition.assign(sb_cols * 8, 0);
    above_segpred.assign(sb_cols * 8, 0);
    above_nnz[0].assign(sb_cols * 16, 0);
    above_nnz[1].assign(sb_cols * 8, 0);
    above_nnz[2].assign(sb_cols * 8, 0);

    if (refreshctx && parallel) {
      for (int i = 0; i < 4; i++) {
        for (int j = 0; j < 2; j++)
          for (int k = 0; k < 2; k++)
            for (int l = 0; l < 6; l++)
              for (int m = 0; m < 6; m++) memcpy(ctx[framectxid].coef[i][j][k][l][m], coef[i][j][k][l][m], 3);
        if (txfmmode == i) break;
      }
      ctx[framectxid].p = prob;
    }

    const uint8_t* tiles = data + header_bytes + compressed_size;
    size_t left = size - header_bytes - compressed_size;
    const int tile_cols = 1 << log2_tile_cols, tile_rows = 1 << log2_tile_rows;
    std::vector<Rac> racs(tile_cols);
    for (int tile_row = 0; tile_row < tile_rows; tile_row++) {
      int row_start, row_end;
      set_tile_offset(row_start, row_end, tile_row, log2_tile_rows, sb_rows);
      for (int tile_col = 0; tile_col < tile_cols; tile_col++) {
        size_t tile_size;
        if (tile_col == tile_cols - 1 && tile_row == tile_rows - 1) {
          tile_size = left;
        } else {
          if (left < 4) return fail(kDamaged, "a tile size past the frame");
          tile_size = (size_t)tiles[0] << 24 | (size_t)tiles[1] << 16 | (size_t)tiles[2] << 8 | tiles[3];
          tiles += 4;
          left -= 4;
        }
        if (tile_size > left || tile_size < 1) return fail(kDamaged, "a tile size past the frame");
        racs[tile_col].init(tiles, tile_size, mem_end);
        if (racs[tile_col].get(128)) return fail(kDamaged, "a tile's marker bit set");
        tiles += tile_size;
        left -= tile_size;
      }
      for (int row = row_start; row < row_end; row += 8) {
        for (int tile_col = 0; tile_col < tile_cols; tile_col++) {
          int col_start, col_end;
          set_tile_offset(col_start, col_end, tile_col, log2_tile_cols, sb_cols);
          tile_col_start = col_start;
          memset(left_partition, 0, sizeof(left_partition));
          memset(left_segpred, 0, sizeof(left_segpred));
          memset(left_nnz, 0, sizeof(left_nnz));
          rac = racs[tile_col];
          for (int col = col_start; col < col_end; col += 8) {
            if (rac.is_end()) return fail(kDamaged, "tile data that ends early");
            if (int st = decode_sb(row, col, 0)) return st;
          }
          racs[tile_col] = rac;
        }
      }
    }
    if (filter_level) {
      loop_filter();
      stats[ST_LOOP_FILTERED_FRAMES]++;
    }
    if (refreshctx && !parallel) {
      adapt_probs();
      stats[ST_ADAPTED_FRAMES]++;
    }
    for (int i = 0; i < 8; i++)
      if (refreshmask & (1 << i)) refs[i] = cur;
    last = cur;
    if (!invisible) shown = cur;
    return kOk;
  }
};

// Split a packet into its frames at the superframe index, as FFmpeg's
// vp9_superframe_split bitstream filter does; a packet without a valid index
// is one frame. Returns false for an index whose sizes overrun the packet.
inline bool split_superframe(const uint8_t* data, size_t size, std::vector<std::pair<size_t, size_t>>& frames) {
  frames.clear();
  if (size == 0) return false;
  const int marker = data[size - 1];
  if ((marker & 0xe0) == 0xc0) {
    const int length_size = 1 + ((marker >> 3) & 0x3), nb_frames = 1 + (marker & 0x7);
    const size_t idx_size = 2 + (size_t)nb_frames * length_size;
    if (size >= idx_size && data[size - idx_size] == marker) {
      const uint8_t* p = data + size + 1 - idx_size;
      size_t offset = 0;
      int64_t total = 0;
      for (int i = 0; i < nb_frames; i++) {
        size_t fs = 0;
        for (int j = 0; j < length_size; j++) fs |= (size_t)(*p++) << (j * 8);
        total += fs;
        if (total > (int64_t)(size - idx_size)) return false;
        frames.emplace_back(offset, fs);
        offset += fs;
      }
      return true;
    }
  }
  frames.emplace_back(0, size);
  return true;
}

}  // namespace vp9
