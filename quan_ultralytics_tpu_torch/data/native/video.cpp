// Video decoding on the host: Motion-JPEG, MPEG-4 Part 2 (Simple and Advanced
// Simple Profile), the H.263 family (H.263, Sorenson H.263, MS-MPEG4 v2 and
// v3, WMV1, WMV2), VP8 and VP9 packets into planar YUV, and YUV into RGB as
// OpenCV's FFmpeg capture converts it. Called through ctypes from video.py,
// which demuxes the file.
//
// OpenCV 5.0 decodes with FFmpeg's libavcodec and converts each frame to
// BGR24 with libswscale (sws_scale at the same size, SWS_BICUBIC). This file
// follows FFmpeg's arithmetic, so the pixels equal OpenCV's:
//   * FFmpeg's 8-bit simple IDCT (libavcodec/simple_idct_template.c:
//     idctRowCondDC with its DC-only shortcut, idctSparseColPut/Add; W1..W7,
//     ROW_SHIFT 11, COL_SHIFT 20). FFmpeg's x86 build selects
//     ff_simple_idct8_sse2 instead; on the fixtures its output equals the C
//     version's, so the C version is the one written here. Streams of the
//     Xvid encoder take the Xvid IDCT (xvididct.c's C version; the x86
//     build's SSE2 one equals it on every stream tried).
//   * Motion-JPEG (mjpegdec.c): the entropy decoding is the JPEG reader's
//     (imread.cpp, included below); each block is then dequantised as FFmpeg
//     does (DC predicted in the dequantised domain from 1024, clipped to int16)
//     and put through the simple IDCT into planes at their own subsampling,
//     with no upsampling (FFmpeg's yuvj420p/yuvj422p). A frame without DHT
//     segments takes Annex K's tables (init_default_huffman_tables).
//   * MPEG-4 Part 2 (ISO/IEC 14496-2; mpeg4videodec.c, h263dec.c,
//     mpegvideo_motion.c, qpeldsp.c): VOS/VO/VOL headers from the decoder
//     configuration or in band, GOV and user data headers, I-, P- and B-VOPs,
//     not coded VOPs (no frame, as FFmpeg outputs none; the last frame again
//     when one ends the stream), MCBPC/CBPY/MVD/TCOEF VLCs with the three
//     escape modes, intra DC VLC below intra_dc_vlc_thr, DC and AC prediction
//     with AC rescaling across quantisers, H.263 or MPEG inverse quantisation
//     (default matrices or those carried in the VOL, mismatch control),
//     DQUANT, not coded macroblocks, 1 and 4 motion vectors with median
//     prediction, half-pel motion compensation with vop_rounding_type and
//     quarter-pel with its mirrored 8-tap filters, unrestricted vectors
//     (edge samples repeated), resync markers (video packets); B-VOPs with
//     MODB, MB_TYPE and DBQUANT, direct mode (the co-located vectors scaled
//     by TRB/TRD from modulo_time_base and vop_time_increment), forward,
//     backward and interpolated prediction, macroblocks skipped with their
//     co-located one, and the display order of h263dec.c (a reference held
//     back until the next one, vdec_flush at the end). The encoder named by
//     the user data or fourcc selects ff_mpeg4_workaround_bugs's behaviour:
//     the Xvid IDCT, the old qpel filters, the quarter-pel chroma rounding of
//     old Xvid and DivX builds, edges at the picture size, unclipped DC,
//     low_delay detection, and DivX 5's packed B-VOPs; data partitioning
//     (the first two partitions of each video packet, then its textures).
//     An H.263 picture (short_video_header) is damaged data, as FFmpeg's
//     MPEG-4 decoder finds no VOP in it (the H.263 decoder below reads it).
//     RVLC, interlace, GMC/sprites, non-8-bit video,
//     shapes other than rectangular, newpred, reduced-resolution VOPs,
//     scalability and complexity estimation are refused with a message that
//     names them.
//   * The H.263 family (struct H263 below, over Mpeg4's macroblock state):
//     H.263 and H.263+ (ituh263dec.c), Sorenson H.263 (flvdec.c), MS-MPEG4
//     v2 and v3 (msmpeg4dec.c, tables in msmpeg4_tables.h), WMV1
//     (msmpeg4dec.c) and WMV2 (wmv2dec.c, wmv2dsp.c; tables in
//     wmv_tables.h), the deblocking filter of WMV2 and H.263+ Annex J
//     (h263.c, h263dsp.c), low delay.
//   * VP8 (vp8.h, as vp8.c decodes a stream): key and inter frames, the
//     golden and altref references, invisible frames (no output).
//   * VP9 profile 0 (vp9.h, as FFmpeg's vp9 decoder decodes a stream): a
//     packet is split at its superframe index and may give more than one
//     frame (vdec_next hands out the others), hidden frames none.
//   * YUV -> BGR24 (libswscale's unscaled yuv2rgb path for 4:2:0 and 4:2:2
//     frames of even width and height; other frames, and a frame whose size
//     changed mid-stream, which OpenCV scales, are refused):
//     one chroma sample for each 2x2 (4:2:0) or 2x1 (4:2:2) block of luma;
//     BT.601 coefficients, limited range for MPEG-4's and VP8's yuv420p and
//     full range for Motion-JPEG's yuvj formats; the arithmetic is the x86
//     kernels' 16-bit fixed point (samples << 3, pmulhw by coefficients
//     scaled by 2^13, no rounding), which the C path of the same libswscale
//     also gives on every (Y, U, V): held against it exhaustively.

#include "imread.cpp"
#include "jpeg_tables.h"
#include "msmpeg4_tables.h"
#include "wmv_tables.h"
#include "vp8.h"
#include "vp9.h"

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <string>

namespace vid {

enum Status { FRAME = 0, NO_FRAME = 1, NOT_IMPLEMENTED = 2, DAMAGED = 3 };

inline uint8_t clip_u8(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// ---- FFmpeg's simple IDCT, 8-bit (simple_idct_template.c) ------------------

constexpr int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867, W7 = 4520;
constexpr int ROW_SHIFT = 11, COL_SHIFT = 20, DC_SHIFT = 3;

// int32 arithmetic that wraps, as FFmpeg's SUINT does
inline uint32_t mul(int w, int x) { return (uint32_t)w * (uint32_t)x; }

void idct_row(int16_t* row) {
  if (!(row[1] | row[2] | row[3] | row[4] | row[5] | row[6] | row[7])) {
    int16_t t = (int16_t)(uint16_t)((uint32_t)row[0] << DC_SHIFT);
    for (int i = 0; i < 8; ++i) row[i] = t;
    return;
  }
  uint32_t a0 = mul(W4, row[0]) + (1u << (ROW_SHIFT - 1));
  uint32_t a1 = a0, a2 = a0, a3 = a0;
  a0 += mul(W2, row[2]);
  a1 += mul(W6, row[2]);
  a2 -= mul(W6, row[2]);
  a3 -= mul(W2, row[2]);
  uint32_t b0 = mul(W1, row[1]) + mul(W3, row[3]);
  uint32_t b1 = mul(W3, row[1]) + mul(-W7, row[3]);
  uint32_t b2 = mul(W5, row[1]) + mul(-W1, row[3]);
  uint32_t b3 = mul(W7, row[1]) + mul(-W5, row[3]);
  if (row[4] | row[5] | row[6] | row[7]) {
    a0 += mul(W4, row[4]) + mul(W6, row[6]);
    a1 += mul(-W4, row[4]) - mul(W2, row[6]);
    a2 += mul(-W4, row[4]) + mul(W2, row[6]);
    a3 += mul(W4, row[4]) - mul(W6, row[6]);
    b0 += mul(W5, row[5]) + mul(W7, row[7]);
    b1 += mul(-W1, row[5]) + mul(-W5, row[7]);
    b2 += mul(W7, row[5]) + mul(W3, row[7]);
    b3 += mul(W3, row[5]) + mul(-W1, row[7]);
  }
  row[0] = (int16_t)((int32_t)(a0 + b0) >> ROW_SHIFT);
  row[7] = (int16_t)((int32_t)(a0 - b0) >> ROW_SHIFT);
  row[1] = (int16_t)((int32_t)(a1 + b1) >> ROW_SHIFT);
  row[6] = (int16_t)((int32_t)(a1 - b1) >> ROW_SHIFT);
  row[2] = (int16_t)((int32_t)(a2 + b2) >> ROW_SHIFT);
  row[5] = (int16_t)((int32_t)(a2 - b2) >> ROW_SHIFT);
  row[3] = (int16_t)((int32_t)(a3 + b3) >> ROW_SHIFT);
  row[4] = (int16_t)((int32_t)(a3 - b3) >> ROW_SHIFT);
}

// one column's eight outputs, before the clip: out[k] for rows 0..7
void idct_col(const int16_t* col, int* out) {
  uint32_t a0 = mul(W4, col[0] + ((1 << (COL_SHIFT - 1)) / W4));
  uint32_t a1 = a0, a2 = a0, a3 = a0;
  a0 += mul(W2, col[16]);
  a1 += mul(W6, col[16]);
  a2 += mul(-W6, col[16]);
  a3 += mul(-W2, col[16]);
  uint32_t b0 = mul(W1, col[8]) + mul(W3, col[24]);
  uint32_t b1 = mul(W3, col[8]) + mul(-W7, col[24]);
  uint32_t b2 = mul(W5, col[8]) + mul(-W1, col[24]);
  uint32_t b3 = mul(W7, col[8]) + mul(-W5, col[24]);
  if (col[32]) {
    a0 += mul(W4, col[32]);
    a1 += mul(-W4, col[32]);
    a2 += mul(-W4, col[32]);
    a3 += mul(W4, col[32]);
  }
  if (col[40]) {
    b0 += mul(W5, col[40]);
    b1 += mul(-W1, col[40]);
    b2 += mul(W7, col[40]);
    b3 += mul(W3, col[40]);
  }
  if (col[48]) {
    a0 += mul(W6, col[48]);
    a1 += mul(-W2, col[48]);
    a2 += mul(W2, col[48]);
    a3 += mul(-W6, col[48]);
  }
  if (col[56]) {
    b0 += mul(W7, col[56]);
    b1 += mul(-W5, col[56]);
    b2 += mul(W3, col[56]);
    b3 += mul(-W1, col[56]);
  }
  out[0] = (int32_t)(a0 + b0) >> COL_SHIFT;
  out[1] = (int32_t)(a1 + b1) >> COL_SHIFT;
  out[2] = (int32_t)(a2 + b2) >> COL_SHIFT;
  out[3] = (int32_t)(a3 + b3) >> COL_SHIFT;
  out[4] = (int32_t)(a3 - b3) >> COL_SHIFT;
  out[5] = (int32_t)(a2 - b2) >> COL_SHIFT;
  out[6] = (int32_t)(a1 - b1) >> COL_SHIFT;
  out[7] = (int32_t)(a0 - b0) >> COL_SHIFT;
}

// ff_simple_idct_put_int16_8bit / _add_: the block (natural order) is consumed
void idct_put(uint8_t* dst, int stride, int16_t* blk) {
  for (int r = 0; r < 8; ++r) idct_row(blk + 8 * r);
  int out[8];
  for (int c = 0; c < 8; ++c) {
    idct_col(blk + c, out);
    for (int r = 0; r < 8; ++r) dst[r * stride + c] = clip_u8(out[r]);
  }
}

void idct_add(uint8_t* dst, int stride, int16_t* blk) {
  for (int r = 0; r < 8; ++r) idct_row(blk + 8 * r);
  int out[8];
  for (int c = 0; c < 8; ++c) {
    idct_col(blk + c, out);
    for (int r = 0; r < 8; ++r) dst[r * stride + c] = clip_u8(dst[r * stride + c] + out[r]);
  }
}

// ff_simple_idct84_add / ff_simple_idct48_add (simple_idct.c): WMV2's ABT
// sub-blocks, the 8-point row or column above and a 4-point one across it
constexpr double SQRT2 = 1.41421356237309504880;  // M_SQRT2
constexpr int C_SHIFT4 = 4 + 1 + 12, R_SHIFT4 = 11;
constexpr int C1_4 = (int)(0.6532814824 * SQRT2 * (1 << 12) + 0.5), C2_4 = (int)(0.2705980501 * SQRT2 * (1 << 12) + 0.5),
              C3_4 = (int)(0.5 * SQRT2 * (1 << 12) + 0.5);
constexpr int R1_4 = (int)(0.6532814824 * SQRT2 * (1 << 15) + 0.5), R2_4 = (int)(0.2705980501 * SQRT2 * (1 << 15) + 0.5),
              R3_4 = (int)(0.5 * SQRT2 * (1 << 15) + 0.5);

void idct84_add(uint8_t* dst, int stride, int16_t* blk) {  // an 8 x 4 block: rows 0..3
  for (int r = 0; r < 4; ++r) idct_row(blk + 8 * r);
  for (int c = 0; c < 8; ++c) {  // idct4col_add
    const int a0 = blk[c], a1 = blk[8 + c], a2 = blk[16 + c], a3 = blk[24 + c];
    const int c0 = (a0 + a2) * C3_4 + (1 << (C_SHIFT4 - 1)), c2 = (a0 - a2) * C3_4 + (1 << (C_SHIFT4 - 1));
    const int c1 = a1 * C1_4 + a3 * C2_4, c3 = a1 * C2_4 - a3 * C1_4;
    const int out[4] = {c0 + c1, c2 + c3, c2 - c3, c0 - c1};
    for (int r = 0; r < 4; ++r) dst[r * stride + c] = clip_u8(dst[r * stride + c] + (out[r] >> C_SHIFT4));
  }
}

void idct48_add(uint8_t* dst, int stride, int16_t* blk) {  // a 4 x 8 block: columns 0..3
  for (int r = 0; r < 8; ++r) {  // idct4row
    int16_t* row = blk + 8 * r;
    const int a0 = row[0], a1 = row[1], a2 = row[2], a3 = row[3];
    const int c0 = (a0 + a2) * R3_4 + (1 << (R_SHIFT4 - 1)), c2 = (a0 - a2) * R3_4 + (1 << (R_SHIFT4 - 1));
    const int c1 = a1 * R1_4 + a3 * R2_4, c3 = a1 * R2_4 - a3 * R1_4;
    row[0] = (int16_t)((c0 + c1) >> R_SHIFT4);
    row[1] = (int16_t)((c2 + c3) >> R_SHIFT4);
    row[2] = (int16_t)((c2 - c3) >> R_SHIFT4);
    row[3] = (int16_t)((c0 - c1) >> R_SHIFT4);
  }
  int out[8];
  for (int c = 0; c < 4; ++c) {
    idct_col(blk + c, out);
    for (int r = 0; r < 8; ++r) dst[r * stride + c] = clip_u8(dst[r * stride + c] + out[r]);
  }
}

// ---- Xvid's IDCT (libavcodec/xvididct.c), for streams from the Xvid encoder --

namespace xvid {

const int kTab04[7] = {22725, 21407, 19266, 16384, 12873, 8867, 4520};
const int kTab17[7] = {31521, 29692, 26722, 22725, 17855, 12299, 6270};
const int kTab26[7] = {29692, 27969, 25172, 21407, 16819, 11585, 5906};
const int kTab35[7] = {26722, 25172, 22654, 19266, 15137, 10426, 5315};
constexpr int ROW_SHIFT = 11, COL_SHIFT = 6;
constexpr uint32_t TAN1 = 0x32EC, TAN2 = 0x6A0A, TAN3 = 0xAB0E, SQRT2 = 0x5A82;

// (int)(c * (unsigned)x) >> n, as xvididct.c's MULT
inline int mult(uint32_t c, int x, int n) { return (int)(c * (uint32_t)x) >> n; }

// idct_row: 0 if the row is all zero (and left so)
int idct_row(int16_t* in, const int* tab, int rnd) {
  const uint32_t c1 = tab[0], c2 = tab[1], c3 = tab[2], c4 = tab[3], c5 = tab[4], c6 = tab[5], c7 = tab[6];
  const int right = in[5] | in[6] | in[7], left = in[1] | in[2] | in[3];
  auto put = [&](uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint32_t b0, uint32_t b1, uint32_t b2,
                 uint32_t b3) {
    in[0] = (int16_t)((int)(a0 + b0) >> ROW_SHIFT);
    in[7] = (int16_t)((int)(a0 - b0) >> ROW_SHIFT);
    in[1] = (int16_t)((int)(a1 + b1) >> ROW_SHIFT);
    in[6] = (int16_t)((int)(a1 - b1) >> ROW_SHIFT);
    in[2] = (int16_t)((int)(a2 + b2) >> ROW_SHIFT);
    in[5] = (int16_t)((int)(a2 - b2) >> ROW_SHIFT);
    in[3] = (int16_t)((int)(a3 + b3) >> ROW_SHIFT);
    in[4] = (int16_t)((int)(a3 - b3) >> ROW_SHIFT);
  };
  const uint32_t i0 = (uint32_t)in[0], i1 = (uint32_t)in[1], i2 = (uint32_t)in[2], i3 = (uint32_t)in[3];
  const uint32_t i4 = (uint32_t)in[4], i5 = (uint32_t)in[5], i6 = (uint32_t)in[6], i7 = (uint32_t)in[7];
  const uint32_t k = c4 * i0 + (uint32_t)rnd;
  if (!(right | in[4])) {
    if (left) {
      put(k + c2 * i2, k + c6 * i2, k - c6 * i2, k - c2 * i2, c1 * i1 + c3 * i3, c3 * i1 - c7 * i3,
          c5 * i1 - c1 * i3, c7 * i1 - c5 * i3);
    } else {
      const int a0 = (int)k >> ROW_SHIFT;
      if (!a0) return 0;
      for (int i = 0; i < 8; ++i) in[i] = (int16_t)a0;
    }
  } else {
    put(k + c2 * i2 + c4 * i4 + c6 * i6, k + c6 * i2 - c4 * i4 - c2 * i6, k - c6 * i2 - c4 * i4 + c2 * i6,
        k - c2 * i2 + c4 * i4 - c6 * i6, c1 * i1 + c3 * i3 + c5 * i5 + c7 * i7, c3 * i1 - c7 * i3 - c1 * i5 - c5 * i7,
        c5 * i1 - c1 * i3 + c7 * i5 + c3 * i7, c7 * i1 - c5 * i3 + c3 * i5 - c1 * i7);
  }
  return 1;
}

// idct_col_8, _4 and _3 are one butterfly with in[5 * 8], in[7 * 8] (and in[3 * 8],
// in[4 * 8], in[6 * 8]) zero; the general form gives the same values
void idct_col(int16_t* in) {
  int mm0, mm1, mm2, mm3, mm4, mm5, mm6, mm7, spill;
  mm4 = in[7 * 8];
  mm5 = in[5 * 8];
  mm6 = in[3 * 8];
  mm7 = in[1 * 8];
  mm0 = mult(TAN1, mm4, 16) + mm7;
  mm1 = mult(TAN1, mm7, 16) - mm4;
  mm2 = mult(TAN3, mm5, 16) + mm6;
  mm3 = mult(TAN3, mm6, 16) - mm5;
  mm7 = mm0 + mm2;
  mm4 = mm1 - mm3;
  mm0 = mm0 - mm2;
  mm1 = mm1 + mm3;
  mm6 = mm0 + mm1;
  mm5 = mm0 - mm1;
  mm5 = 2 * mult(SQRT2, mm5, 16);
  mm6 = 2 * mult(SQRT2, mm6, 16);
  mm1 = in[2 * 8];
  mm2 = in[6 * 8];
  mm3 = mult(TAN2, mm2, 16) + mm1;
  mm2 = mult(TAN2, mm1, 16) - mm2;
  mm0 = in[0] + in[4 * 8];
  mm1 = in[0] - in[4 * 8];
  spill = mm0 + mm3; mm3 = mm0 - mm3; mm0 = spill;
  spill = mm0 + mm7; mm7 = mm0 - mm7; mm0 = spill;
  in[8 * 0] = (int16_t)(mm0 >> COL_SHIFT);
  in[8 * 7] = (int16_t)(mm7 >> COL_SHIFT);
  mm0 = mm3 + mm4; mm4 = mm3 - mm4; mm3 = mm0;
  in[8 * 3] = (int16_t)(mm3 >> COL_SHIFT);
  in[8 * 4] = (int16_t)(mm4 >> COL_SHIFT);
  mm0 = mm1 + mm2; mm2 = mm1 - mm2; mm1 = mm0;
  mm0 = mm1 + mm6; mm6 = mm1 - mm6; mm1 = mm0;
  in[8 * 1] = (int16_t)(mm1 >> COL_SHIFT);
  in[8 * 6] = (int16_t)(mm6 >> COL_SHIFT);
  mm0 = mm2 + mm5; mm5 = mm2 - mm5; mm2 = mm0;
  in[8 * 2] = (int16_t)(mm2 >> COL_SHIFT);
  in[8 * 5] = (int16_t)(mm5 >> COL_SHIFT);
}

void idct(int16_t* in) {  // ff_xvid_idct
  static const int* const tabs[8] = {kTab04, kTab17, kTab26, kTab35, kTab04, kTab35, kTab26, kTab17};
  static const int rnd[8] = {65536, 3597, 2260, 1203, 0, 120, 512, 512};
  for (int r = 0; r < 8; ++r) idct_row(in + 8 * r, tabs[r], rnd[r]);
  for (int c = 0; c < 8; ++c) idct_col(in + c);
}

}  // namespace xvid

void xvid_idct_put(uint8_t* dst, int stride, int16_t* blk) {
  xvid::idct(blk);
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c) dst[r * stride + c] = clip_u8(blk[8 * r + c]);
}

void xvid_idct_add(uint8_t* dst, int stride, int16_t* blk) {
  xvid::idct(blk);
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c) dst[r * stride + c] = clip_u8(dst[r * stride + c] + blk[8 * r + c]);
}

// ---- WMV2's IDCT and quarter-sample filters (libavcodec/wmv2dsp.c) ---------

constexpr int WW0 = 2048, WW1 = 2841, WW2 = 2676, WW3 = 2408, WW5 = 1609, WW6 = 1108, WW7 = 565;

// wmv2_idct_row / wmv2_idct_col; ``s`` is 1 along a row, 8 down a column
void wmv2_idct_1d(int16_t* b, int s, bool col) {
  const int r = col ? 4 : 0, sh = col ? 3 : 0;
  const int a1 = (WW1 * b[1 * s] + WW7 * b[7 * s] + r) >> sh, a7 = (WW7 * b[1 * s] - WW1 * b[7 * s] + r) >> sh;
  const int a5 = (WW5 * b[5 * s] + WW3 * b[3 * s] + r) >> sh, a3 = (WW3 * b[5 * s] - WW5 * b[3 * s] + r) >> sh;
  const int a2 = (WW2 * b[2 * s] + WW6 * b[6 * s] + r) >> sh, a6 = (WW6 * b[2 * s] - WW2 * b[6 * s] + r) >> sh;
  const int a0 = (WW0 * b[0] + WW0 * b[4 * s]) >> sh, a4 = (WW0 * b[0] - WW0 * b[4 * s]) >> sh;
  const int s1 = (int)(181u * (uint32_t)(a1 - a5 + a7 - a3) + 128) >> 8;
  const int s2 = (int)(181u * (uint32_t)(a1 - a5 - a7 + a3) + 128) >> 8;
  const int rnd = col ? 1 << 13 : 1 << 7, out = col ? 14 : 8;
  b[0] = (int16_t)((a0 + a2 + a1 + a5 + rnd) >> out);
  b[1 * s] = (int16_t)((a4 + a6 + s1 + rnd) >> out);
  b[2 * s] = (int16_t)((a4 - a6 + s2 + rnd) >> out);
  b[3 * s] = (int16_t)((a0 - a2 + a7 + a3 + rnd) >> out);
  b[4 * s] = (int16_t)((a0 - a2 - a7 - a3 + rnd) >> out);
  b[5 * s] = (int16_t)((a4 - a6 - s2 + rnd) >> out);
  b[6 * s] = (int16_t)((a4 + a6 - s1 + rnd) >> out);
  b[7 * s] = (int16_t)((a0 + a2 - a1 - a5 + rnd) >> out);
}

// wmv2_idct_put_c / wmv2_idct_add_c (the x86 build has no other)
void wmv2_idct(uint8_t* dst, int stride, int16_t* blk, bool add) {
  for (int i = 0; i < 64; i += 8) wmv2_idct_1d(blk + i, 1, false);
  for (int i = 0; i < 8; ++i) wmv2_idct_1d(blk + i, 8, true);
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c) {
      uint8_t& d = dst[(size_t)r * stride + c];
      d = clip_u8((add ? d : 0) + blk[r * 8 + c]);
    }
}

// put_mspel8_mcXY_c: an 8 x 8 block from ``src`` (stride 11, its sample (0, 0)
// at src[12], one sample of context before and two after on each axis) at
// mspel position ``dxy`` (0 the samples, 1 mc10, 2 mc20, 3 mc30, 4 mc02,
// 5 mc12, 6 mc22, 7 mc32): wmv2_mspel8_{h,v}_lowpass's taps (-1, 9, 9, -1) / 16
// and put_pixels8_l2's rounded average
void mspel8(uint8_t* dst, int dstride, const uint8_t* src, int dxy) {
  constexpr int S = 11;
  auto low = [](int a, int b, int c, int d) { return clip_u8((9 * (b + c) - (a + d) + 8) >> 4); };
  uint8_t half_h[11 * 8], a[64], b[64];  // half_h: rows -1..9 filtered along each row
  for (int r = -1; r < 10; ++r)
    for (int c = 0; c < 8; ++c) {
      const uint8_t* p = src + 12 + r * S + c;
      half_h[(r + 1) * 8 + c] = low(p[-1], p[0], p[1], p[2]);
    }
  auto vlow = [&](uint8_t* out, int x0) {  // along columns of src from column x0
    for (int r = 0; r < 8; ++r)
      for (int c = 0; c < 8; ++c) {
        const uint8_t* p = src + 12 + r * S + c + x0;
        out[r * 8 + c] = low(p[-S], p[0], p[S], p[2 * S]);
      }
  };
  auto vlow_h = [&](uint8_t* out) {  // along columns of half_h
    for (int r = 0; r < 8; ++r)
      for (int c = 0; c < 8; ++c) {
        const uint8_t* p = half_h + (r + 1) * 8 + c;
        out[r * 8 + c] = low(p[-8], p[0], p[8], p[16]);
      }
  };
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c) a[r * 8 + c] = src[12 + r * S + c];
  switch (dxy) {
    case 0: break;
    case 1: case 3:  // the samples (mc10) or those one to the right (mc30) averaged with the row filter
      for (int r = 0; r < 8; ++r)
        for (int c = 0; c < 8; ++c)
          a[r * 8 + c] = (uint8_t)((src[12 + r * S + c + (dxy == 3)] + half_h[(r + 1) * 8 + c] + 1) >> 1);
      break;
    case 2: memcpy(a, half_h + 8, 64); break;
    case 4: vlow(a, 0); break;
    case 6: vlow_h(a); break;
    default:  // mc12 / mc32: the column filter at x (or x + 1) averaged with both filters
      vlow(a, dxy == 7);
      vlow_h(b);
      for (int i = 0; i < 64; ++i) a[i] = (uint8_t)((a[i] + b[i] + 1) >> 1);
  }
  for (int r = 0; r < 8; ++r) memcpy(dst + (size_t)r * dstride, a + r * 8, 8);
}

// ---- MPEG-4 quarter-pel (libavcodec/qpeldsp.c) ------------------------------

// mpeg4_qpel{8,16}_{h,v}_lowpass over ``n`` lines: the taps (-1, 3, -6, 20, 20,
// -6, 3, -1) / 32 over the s + 1 samples of a line, those past either end of it
// mirrored back into it, rounded (+16) or not (+15), clipped
void qpel_lowpass(uint8_t* dst, int dstep, int dline, const uint8_t* src, int sstep, int sline, int s, int n,
                  int rnd) {
  static const int taps[8] = {-1, 3, -6, 20, 20, -6, 3, -1};
  for (int l = 0; l < n; ++l)
    for (int k = 0; k < s; ++k) {
      int sum = 0;
      for (int t = 0; t < 8; ++t) {
        int i = k - 3 + t;
        i = i < 0 ? -1 - i : (i > s ? 2 * s + 1 - i : i);
        sum += taps[t] * src[l * sline + i * sstep];
      }
      dst[l * dline + k * dstep] = clip_u8((sum + rnd) >> 5);
    }
}

// put_{,no_rnd_}qpel{8,16}_mcXY_c: an s x s block (s = 8 or 16) at quarter-pel
// position dxy = (y << 2) | x from ``full``, the (s + 1) x (s + 1) samples from
// the block's integer position (stride s + 1); the intermediate planes are
// rounded as the result is (put: (a + b + 1) >> 1 and +16; no_rnd: (a + b) >> 1 and +15).
// ``old``: the mc11/31/12/32/13/33 of libavcodec before build 4653
// (qpel{8,16}_mcXY_old_c, FF_BUG_STD_QPEL), which average four planes
void qpel_mc(uint8_t* out, const uint8_t* full, int s, int dxy, bool no_rnd, bool old) {
  const int fs = s + 1, rnd = no_rnd ? 15 : 16, r2 = no_rnd ? 0 : 1;
  const int X = dxy & 3, Y = dxy >> 2;
  uint8_t half[17 * 16], hv[16 * 16];
  auto l2 = [&](uint8_t* d, int ds, const uint8_t* a, int as, const uint8_t* b, int bs, int rows) {
    for (int r = 0; r < rows; ++r)
      for (int k = 0; k < s; ++k) d[r * ds + k] = (uint8_t)((a[r * as + k] + b[r * bs + k] + r2) >> 1);
  };
  auto h = [&](uint8_t* d, const uint8_t* src, int rows) { qpel_lowpass(d, 1, s, src, 1, fs, s, rows, rnd); };
  auto v = [&](uint8_t* d, const uint8_t* src, int sstride) { qpel_lowpass(d, s, 1, src, sstride, 1, s, s, rnd); };
  if (Y == 0) {
    if (X == 0) {
      for (int r = 0; r < s; ++r) memcpy(out + r * s, full + r * fs, s);
    } else if (X == 2) {
      h(out, full, s);
    } else {  // mc10, mc30
      h(half, full, s);
      l2(out, s, full + (X == 3), fs, half, s, s);
    }
    return;
  }
  if (X == 0) {
    if (Y == 2) {
      v(out, full, fs);
    } else {  // mc01, mc03
      v(half, full, fs);
      l2(out, s, full + (Y == 3) * fs, fs, half, s, s);
    }
    return;
  }
  // the others filter s + 1 rows horizontally, then vertically
  h(half, full, s + 1);
  if (old && X != 2) {
    uint8_t hvv[16 * 16];
    v(hv, full + (X == 3), fs);  // halfV
    v(hvv, half, s);  // halfHV
    if (Y == 2) {
      l2(out, s, hv, s, hvv, s, s);
      return;
    }
    const uint8_t* a = full + (X == 3) + (Y == 3) * fs;
    const uint8_t* b = half + (Y == 3) * s;
    for (int r = 0; r < s; ++r)
      for (int k = 0; k < s; ++k)
        out[r * s + k] = (uint8_t)((a[r * fs + k] + b[r * s + k] + hv[r * s + k] + hvv[r * s + k] + 1 + r2) >> 2);
    return;
  }
  if (X != 2) l2(half, s, half, s, full + (X == 3), fs, s + 1);  // mc11, 31, 13, 33, 12, 32
  if (Y == 2) {
    v(out, half, s);
    return;
  }
  v(hv, half, s);
  l2(out, s, half + (Y == 3) * s, s, hv, s, s);
}

// ff_mpeg4_default_intra_matrix, ff_mpeg4_default_non_intra_matrix (natural order)
const uint8_t kDefaultIntraMatrix[64] = {
    8,  17, 18, 19, 21, 23, 25, 27, 17, 18, 19, 21, 23, 25, 27, 28, 20, 21, 22, 23, 24, 26,
    28, 30, 21, 22, 23, 24, 26, 28, 30, 32, 22, 23, 24, 26, 28, 30, 32, 35, 23, 24, 26, 28,
    30, 32, 35, 38, 25, 26, 28, 30, 32, 35, 38, 41, 27, 28, 30, 32, 35, 38, 41, 45};
const uint8_t kDefaultInterMatrix[64] = {
    16, 17, 18, 19, 20, 21, 22, 23, 17, 18, 19, 20, 21, 22, 23, 24, 18, 19, 20, 21, 22, 23,
    24, 25, 19, 20, 21, 22, 23, 24, 26, 27, 20, 21, 22, 23, 25, 26, 27, 28, 21, 22, 23, 24,
    26, 27, 28, 30, 22, 23, 24, 26, 27, 28, 30, 31, 23, 24, 25, 27, 28, 30, 31, 33};

// ---- planar frames and YUV -> RGB ------------------------------------------

struct Frame {
  int width = 0, height = 0;  // visible size
  int ystride = 0, cstride = 0;
  int cshift_y = 1;  // 1: 4:2:0, 0: 4:2:2
  bool full_range = false;
  std::vector<uint8_t> y, u, v;
  void alloc(int w, int h, int yw, int yh, int cw, int ch, int vshift) {
    width = w;
    height = h;
    ystride = yw;
    cstride = cw;
    cshift_y = vshift;
    y.assign((size_t)yw * yh, 0);
    u.assign((size_t)cw * ch, 0);
    v.assign((size_t)cw * ch, 0);
  }
};

// libswscale's yuv2rgb coefficients (ff_yuv2rgb_c_init_tables, the 16-bit
// fields its SIMD kernels read) for BT.601 at the default brightness,
// contrast and saturation
struct RgbCoeffs {
  int y, yoff, vr, ub, ug, vg;
};

RgbCoeffs rgb_coeffs(bool full) {
  int64_t crv = 104597, cbu = 132201, cgu = -25675, cgv = -53279;  // ff_yuv2rgb_coeffs[SWS_CS_DEFAULT]
  int64_t cy = 1 << 16, oy = 0;
  if (!full) {
    cy = (cy * 255) / 219;
    oy = 16 << 16;
  } else {
    crv = (crv * 224) / 255;
    cbu = (cbu * 224) / 255;
    cgu = (cgu * 224) / 255;
    cgv = (cgv * 224) / 255;
  }
  auto r16 = [](int64_t x) { return (int)((x + (1 << 15)) >> 16); };  // roundToInt16
  return {r16(cy * (1 << 13)), r16(oy * (1 << 3)), r16(crv * (1 << 13)),
          r16(cbu * (1 << 13)), r16(cgu * (1 << 13)), r16(cgv * (1 << 13))};
}

inline int mulhw(int a, int b) { return (a * b) >> 16; }

void to_rgb(const Frame& f, uint8_t* out) {
  RgbCoeffs k = rgb_coeffs(f.full_range);
  for (int r = 0; r < f.height; ++r) {
    const uint8_t* py = f.y.data() + (size_t)r * f.ystride;
    const uint8_t* pu = f.u.data() + (size_t)(r >> f.cshift_y) * f.cstride;
    const uint8_t* pv = f.v.data() + (size_t)(r >> f.cshift_y) * f.cstride;
    uint8_t* o = out + (size_t)r * f.width * 3;
    for (int x = 0; x < f.width; ++x) {
      int u = (pu[x >> 1] << 3) - 1024, v = (pv[x >> 1] << 3) - 1024;
      int yy = mulhw((py[x] << 3) - k.yoff, k.y);
      o[3 * x] = clip_u8(yy + mulhw(v, k.vr));
      o[3 * x + 1] = clip_u8(yy + mulhw(u, k.ug) + mulhw(v, k.vg));
      o[3 * x + 2] = clip_u8(yy + mulhw(u, k.ub));
    }
  }
}

// ---- Motion-JPEG ---------------------------------------------------------

// FFmpeg's reconstruction of a baseline block: dequantise (the DC from
// FFmpeg's predictor origin 1024, clipped to int16) and the simple IDCT
void mjpeg_recon(const int32_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int16_t blk[64];
  int dc = coef[0] * q[0] + 1024;
  blk[0] = (int16_t)(dc < -32768 ? -32768 : (dc > 32767 ? 32767 : dc));
  for (int k = 1; k < 64; ++k) blk[k] = (int16_t)(coef[k] * q[k]);
  idct_put(out, stride, blk);
}

struct Mjpeg {
  Huffman dc[4], ac[4];  // FFmpeg keeps the tables from one frame to the next
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Mjpeg() {
    build_huffman(dc[0], kDcLumaBits, kDcLumaVals, 12);
    build_huffman(dc[1], kDcChromaBits, kDcChromaVals, 12);
    build_huffman(ac[0], kAcLumaBits, kAcLumaVals, 162);
    build_huffman(ac[1], kAcChromaBits, kAcChromaVals, 162);
  }

  int decode(const uint8_t* data, long n, Frame& f, std::string& msg) {
    Decoder d;
    d.data = data;
    d.n = (size_t)n;
    d.recon = mjpeg_recon;
    for (int i = 0; i < 4; ++i) {
      d.dc[i] = dc[i];
      d.ac[i] = ac[i];
      memcpy(d.qt[i], qt[i], sizeof(qt[i]));
      d.qt_defined[i] = qt_defined[i];
    }
    int st = d.parse();
    for (int i = 0; i < 4; ++i) {
      dc[i] = d.dc[i];
      ac[i] = d.ac[i];
      memcpy(qt[i], d.qt[i], sizeof(qt[i]));
      qt_defined[i] = d.qt_defined[i];
    }
    if (st == OK && !d.frame) st = E_NO_FRAME;
    if (st != OK) {
      msg = std::string("Motion-JPEG: ") + kMessages[st];
      bool refused = st == E_HIERARCHICAL || st == E_ARITHMETIC || st == E_LOSSLESS || st == E_PRECISION ||
                     st == E_SAMPLING || st == E_COMPONENTS || st == E_DNL;
      return refused ? NOT_IMPLEMENTED : DAMAGED;
    }
    if (d.progressive) d.idct_planes();
    const Component* c = d.comp;
    int vshift = -1;
    if (d.ncomp == 3 && c[1].h == 1 && c[1].v == 1 && c[2].h == 1 && c[2].v == 1 && c[0].h == 2)
      vshift = c[0].v == 2 ? 1 : (c[0].v == 1 ? 0 : -1);
    if (vshift < 0 || d.is_rgb()) {
      char buf[160];
      snprintf(buf, sizeof(buf),
               "Motion-JPEG with %d components sampled %dx%d,%dx%d,%dx%d%s (only 4:2:0 and 4:2:2 YCbCr "
               "take libswscale's unscaled path)",
               d.ncomp, c[0].h, c[0].v, d.ncomp > 1 ? c[1].h : 0, d.ncomp > 1 ? c[1].v : 0,
               d.ncomp > 2 ? c[2].h : 0, d.ncomp > 2 ? c[2].v : 0, d.is_rgb() ? " as RGB" : "");
      msg = buf;
      return NOT_IMPLEMENTED;
    }
    f.width = d.width;
    f.height = d.height;
    f.ystride = c[0].plane_w;
    f.cstride = c[1].plane_w;
    f.cshift_y = vshift;
    f.full_range = true;
    f.y = c[0].plane;
    f.u = c[1].plane;
    f.v = c[2].plane;
    return FRAME;
  }
};

// ---- MPEG-4 Part 2: bits and VLCs ------------------------------------------

struct Bits {
  const uint8_t* d = nullptr;
  int64_t nbits = 0, pos = 0;
  void init(const uint8_t* data, long n) {
    d = data;
    nbits = (int64_t)n * 8;
    pos = 0;
  }
  uint32_t show(int n) const {  // n in 1..32; bits past the end read as 0
    if (n == 0) return 0;
    int64_t byte = pos >> 3;
    uint64_t v = 0;
    for (int i = 0; i < 5; ++i) {
      int64_t b = byte + i;
      v = (v << 8) | (b >= 0 && b * 8 < nbits ? d[b] : 0);
    }
    v <<= 24 + (pos & 7);
    return (uint32_t)(v >> (64 - n));
  }
  uint32_t get(int n) {
    uint32_t v = show(n);
    pos += n;
    return v;
  }
  int get1() { return (int)get(1); }
  int sget(int n) {  // two's complement, n bits
    uint32_t v = get(n);
    return (int)(v << (32 - n)) >> (32 - n);
  }
  int xbits(int n) {  // get_xbits: sign by the leading bit, as JPEG extends
    uint32_t v = get(n);
    return (v >> (n - 1)) ? (int)v : (int)v - (1 << n) + 1;
  }
  void skip(int n) { pos += n; }
  void align() { pos = (pos + 7) & ~(int64_t)7; }
  int64_t left() const { return nbits - pos; }
};

struct Vlc {
  int bits = 0;
  std::vector<int16_t> sym;
  std::vector<uint8_t> len;
  void build(int maxlen, const uint16_t* codes, const uint8_t* lens, int n) {
    bits = maxlen;
    sym.assign((size_t)1 << maxlen, -1);
    len.assign((size_t)1 << maxlen, 0);
    for (int i = 0; i < n; ++i) {
      if (!lens[i]) continue;
      int shift = maxlen - lens[i];
      uint32_t base = (uint32_t)codes[i] << shift;
      for (uint32_t j = 0; j < (1u << shift); ++j) {
        sym[base | j] = (int16_t)i;
        len[base | j] = lens[i];
      }
    }
  }
  int read(Bits& b) const {  // the symbol, or -1 for no code
    uint32_t idx = b.show(bits);
    if (!len[idx]) return -1;
    b.skip(len[idx]);
    return sym[idx];
  }
};

// H.263 Table 7 and 8 (MCBPC for I and P pictures) in FFmpeg's symbol order:
// bit 2 of the symbol marks intra, bit 3 DQUANT, bit 4 four vectors, 8 and 20 stuffing
const uint16_t kIntraMcbpcCode[9] = {1, 1, 2, 3, 1, 1, 2, 3, 1};
const uint8_t kIntraMcbpcLen[9] = {1, 3, 3, 3, 4, 6, 6, 6, 9};
const uint16_t kInterMcbpcCode[28] = {1, 3, 2, 5, 3, 4, 3, 3, 3, 7, 6, 5, 4, 4, 3, 2,
                                      2, 5, 4, 5, 1, 0, 0, 0, 2, 12, 14, 15};
const uint8_t kInterMcbpcLen[28] = {1, 4, 4, 6, 5, 8, 8, 7, 3, 7, 7, 9, 6, 9, 9, 9,
                                    3, 7, 7, 8, 9, 0, 0, 0, 11, 13, 13, 13};
// H.263 Table 13: CBPY for intra macroblocks (inter ones take it xor 15)
const uint16_t kCbpyCode[16] = {3, 5, 4, 9, 3, 7, 2, 11, 2, 3, 5, 10, 4, 8, 6, 3};
const uint8_t kCbpyLen[16] = {4, 5, 5, 4, 5, 4, 6, 4, 5, 6, 4, 4, 4, 4, 4, 2};
// H.263 Table 14: motion vector magnitudes 0..32, the sign bit follows
const uint16_t kMvCode[33] = {1, 1, 1, 1, 3, 5, 4, 3, 11, 10, 9, 17, 16, 15, 14, 13, 12,
                              11, 10, 9, 8, 7, 6, 5, 4, 7, 6, 5, 4, 3, 2, 3, 2};
const uint8_t kMvLen[33] = {1, 2, 3, 4, 6, 7, 7, 7, 9, 9, 9, 10, 10, 10, 10, 10, 10,
                            10, 10, 10, 10, 10, 10, 10, 10, 11, 11, 11, 11, 11, 11, 12, 12};
// ISO/IEC 14496-2 Tables B-13 and B-14: dct_dc_size for luminance and chrominance
const uint16_t kDcLumCode[13] = {3, 3, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1};
const uint8_t kDcLumLen[13] = {3, 2, 2, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint16_t kDcChromCode[13] = {3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
const uint8_t kDcChromLen[13] = {2, 2, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12};

// Tables B-16 (intra) and B-17 (inter) TCOEF: codes without the sign bit, the
// last = 0 entries then the last = 1 entries (each run in order, levels
// ascending), then ESCAPE
const uint16_t kIntraTcoef[103][2] = {
    {2, 2}, {6, 3}, {15, 4}, {13, 5}, {12, 5}, {21, 6}, {19, 6}, {18, 6}, {23, 7}, {31, 8}, {30, 8},
    {29, 8}, {37, 9}, {36, 9}, {35, 9}, {33, 9}, {33, 10}, {32, 10}, {15, 10}, {14, 10}, {7, 11},
    {6, 11}, {32, 11}, {33, 11}, {80, 12}, {81, 12}, {82, 12}, {14, 4}, {20, 6}, {22, 7}, {28, 8},
    {32, 9}, {31, 9}, {13, 10}, {34, 11}, {83, 12}, {85, 12}, {11, 5}, {21, 7}, {30, 9}, {12, 10},
    {86, 12}, {17, 6}, {27, 8}, {29, 9}, {11, 10}, {16, 6}, {34, 9}, {10, 10}, {13, 6}, {28, 9},
    {8, 10}, {18, 7}, {27, 9}, {84, 12}, {20, 7}, {26, 9}, {87, 12}, {25, 8}, {9, 10}, {24, 8},
    {35, 11}, {23, 8}, {25, 9}, {24, 9}, {7, 10}, {88, 12}, {7, 4}, {12, 6}, {22, 8}, {23, 9},
    {6, 10}, {5, 11}, {4, 11}, {89, 12}, {15, 6}, {22, 9}, {5, 10}, {14, 6}, {4, 10}, {17, 7},
    {36, 11}, {16, 7}, {37, 11}, {19, 7}, {90, 12}, {21, 8}, {91, 12}, {20, 8}, {19, 8}, {26, 8},
    {21, 9}, {20, 9}, {19, 9}, {18, 9}, {17, 9}, {38, 11}, {39, 11}, {92, 12}, {93, 12}, {94, 12},
    {95, 12}, {3, 7}};
const uint16_t kInterTcoef[103][2] = {
    {2, 2}, {15, 4}, {21, 6}, {23, 7}, {31, 8}, {37, 9}, {36, 9}, {33, 10}, {32, 10}, {7, 11},
    {6, 11}, {32, 11}, {6, 3}, {20, 6}, {30, 8}, {15, 10}, {33, 11}, {80, 12}, {14, 4}, {29, 8},
    {14, 10}, {81, 12}, {13, 5}, {35, 9}, {13, 10}, {12, 5}, {34, 9}, {82, 12}, {11, 5}, {12, 10},
    {83, 12}, {19, 6}, {11, 10}, {84, 12}, {18, 6}, {10, 10}, {17, 6}, {9, 10}, {16, 6}, {8, 10},
    {22, 7}, {85, 12}, {21, 7}, {20, 7}, {28, 8}, {27, 8}, {33, 9}, {32, 9}, {31, 9}, {30, 9},
    {29, 9}, {28, 9}, {27, 9}, {26, 9}, {34, 11}, {35, 11}, {86, 12}, {87, 12}, {7, 4}, {25, 9},
    {5, 11}, {15, 6}, {4, 11}, {14, 6}, {13, 6}, {12, 6}, {19, 7}, {18, 7}, {17, 7}, {16, 7},
    {26, 8}, {25, 8}, {24, 8}, {23, 8}, {22, 8}, {21, 8}, {20, 8}, {19, 8}, {24, 9}, {23, 9},
    {22, 9}, {21, 9}, {20, 9}, {19, 9}, {18, 9}, {17, 9}, {7, 10}, {6, 10}, {5, 10}, {4, 10},
    {36, 11}, {37, 11}, {38, 11}, {39, 11}, {88, 12}, {89, 12}, {90, 12}, {91, 12}, {92, 12},
    {93, 12}, {94, 12}, {95, 12}, {3, 7}};
// the largest level of each run (last = 0, then last = 1), which also fixes
// the order of the entries above
const int kIntraMaxLevel0[] = {27, 10, 5, 4, 3, 3, 3, 3, 2, 2, 1, 1, 1, 1, 1};
const int kIntraMaxLevel1[] = {8, 3, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
const int kInterMaxLevel0[] = {12, 6, 4, 3, 3, 3, 3, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
const int kInterMaxLevel1[] = {3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                               1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
constexpr int kEscape = 102;

struct RunLevel {
  Vlc vlc;
  int run[102], level[102], last[102];
  int max_level[2][64], max_run[2][64];  // ff_rl_init
  void build(const uint16_t (*tab)[2], const int* ml0, int n0, const int* ml1, int n1) {
    uint16_t codes[103];
    uint8_t lens[103];
    for (int i = 0; i < 103; ++i) {
      codes[i] = tab[i][0];
      lens[i] = (uint8_t)tab[i][1];
    }
    vlc.build(12, codes, lens, 103);
    memset(max_level, 0, sizeof(max_level));
    memset(max_run, 0, sizeof(max_run));
    int k = 0;
    for (int l = 0; l < 2; ++l) {
      const int* ml = l ? ml1 : ml0;
      int nr = l ? n1 : n0;
      for (int r = 0; r < nr; ++r)
        for (int lv = 1; lv <= ml[r]; ++lv, ++k) {
          run[k] = r;
          level[k] = lv;
          last[k] = l;
          max_level[l][r] = std::max(max_level[l][r], lv);
          max_run[l][lv] = std::max(max_run[l][lv], r);
        }
    }
  }
};

struct Tables {
  Vlc intra_mcbpc, inter_mcbpc, cbpy, mv, dc_lum, dc_chrom;
  RunLevel intra, inter;
  Tables() {
    intra_mcbpc.build(9, kIntraMcbpcCode, kIntraMcbpcLen, 9);
    inter_mcbpc.build(13, kInterMcbpcCode, kInterMcbpcLen, 28);
    cbpy.build(6, kCbpyCode, kCbpyLen, 16);
    mv.build(12, kMvCode, kMvLen, 33);
    dc_lum.build(11, kDcLumCode, kDcLumLen, 13);
    dc_chrom.build(12, kDcChromCode, kDcChromLen, 13);
    intra.build(kIntraTcoef, kIntraMaxLevel0, 15, kIntraMaxLevel1, 21);
    inter.build(kInterTcoef, kInterMaxLevel0, 27, kInterMaxLevel1, 41);
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

const uint8_t kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                             12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                             35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                             58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
const uint8_t kAltHorizontal[64] = {0,  1,  2,  3,  8,  9,  16, 17, 10, 11, 4,  5,  6,  7,  15, 14,
                                    13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
                                    30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
                                    46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};
const uint8_t kAltVertical[64] = {0,  8,  16, 24, 1,  9,  2,  10, 17, 25, 32, 40, 48, 56, 57, 49,
                                  41, 33, 26, 18, 3,  11, 4,  12, 19, 27, 34, 42, 50, 58, 35, 43,
                                  51, 59, 20, 28, 5,  13, 6,  14, 21, 29, 36, 44, 52, 60, 37, 45,
                                  53, 61, 22, 30, 7,  15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};
// ff_mpeg4_y_dc_scale_table / ff_mpeg4_c_dc_scale_table, by quantiser
const uint8_t kYDcScale[32] = {0,  8,  8,  8,  8,  10, 12, 14, 16, 17, 18, 19, 20, 21, 22, 23,
                               24, 25, 26, 27, 28, 29, 30, 31, 32, 34, 36, 38, 40, 42, 44, 46};
const uint8_t kCDcScale[32] = {0,  8,  8,  8,  8,  9,  9,  10, 10, 11, 11, 12, 12, 13, 13, 14,
                               14, 15, 15, 16, 16, 17, 17, 18, 18, 19, 20, 21, 22, 23, 24, 25};
const int kDcThreshold[8] = {99, 13, 15, 17, 19, 21, 23, 0};
const int kDquant[4] = {-1, -2, 1, 2};

inline int mid_pred(int a, int b, int c) { return std::max(std::min(a, b), std::min(std::max(a, b), c)); }

inline int rounded_div(int a, int b) { return (a >= 0 ? a + (b >> 1) : a - (b >> 1)) / b; }

// ---- MPEG-4 Part 2: the decoder ----------------------------------------------

enum { I_VOP = 0, P_VOP = 1, B_VOP = 2, S_VOP = 3 };
// what a stream used, counted as it is decoded (vdec_stats), so that tests can
// tell which coding tools their fixtures exercise
enum Stat {
  ST_I_VOP, ST_P_VOP, ST_NOT_CODED_VOP, ST_SKIPPED_MB, ST_INTRA_MB_IN_P, ST_FOUR_MV_MB, ST_DQUANT,
  ST_PACKETS, ST_ESCAPE1, ST_ESCAPE2, ST_ESCAPE3, ST_AC_PRED_MB, ST_DC_AS_AC, ST_NO_ROUNDING_MB,
  ST_AC_RESCALED, ST_B_VOP, ST_B_DIRECT, ST_B_FORWARD, ST_B_BACKWARD, ST_B_INTERPOLATED, ST_B_COLOCATED_SKIP,
  ST_DBQUANT, ST_QPEL_MB, ST_MPEG_QUANT_BLOCK, ST_XVID_IDCT_BLOCK, ST_PACKED_B, ST_SKIPPED_B,
  ST_PARTITIONED_PACKETS, ST_GOB_HEADERS, ST_FLV_ESCAPE, ST_MV_ESCAPE, ST_DROPPABLE, ST_INTER_INTRA_PICTURES,
  ST_INTER_INTRA_MB, ST_PER_MB_RL_PICTURES, ST_SKIP_MAPS, ST_MSPEL_PICTURES, ST_HSHIFT_MB, ST_LOOP_FILTERED_MB,
  ST_WMV_ESCAPE3_LENGTHS, ST_SKIPPED_PICTURES, ST_ABT_BLOCK, ST_TOP_LEFT_MV, ST_COUNT
};
constexpr int SLICE_END = 1;  // decode_slice: a video packet ends before the VOP does
constexpr int FRAME_SKIPPED = 4;  // decode_vop_header: a VOP FFmpeg decodes to no frame
constexpr int PARTITIONS_END = 5;  // decode_partitioned_mb: the video packet's last macroblock
constexpr int MAX_NVOP_SIZE = 19;  // h263dec.c: a packet this small after a packed one is its placeholder

// FFmpeg's workaround_bugs flags that change what a progressive stream decodes to
enum Bug {
  BUG_UMP4 = 1 << 0, BUG_QPEL_CHROMA = 1 << 1, BUG_QPEL_CHROMA2 = 1 << 2, BUG_EDGE = 1 << 3, BUG_DC_CLIP = 1 << 4,
  BUG_STD_QPEL = 1 << 5
};

struct Mpeg4 {
  uint32_t tag = 0;  // the container's fourcc, upper case
  std::string msg;
  int64_t stats[ST_COUNT] = {};
  // video object layer
  bool have_vol = false;
  int vo_type = 0, vol_control = 0, width = 0, height = 0, mb_w = 0, mb_h = 0, mb_num = 0;
  int time_increment_bits = 0, time_resolution = 1, quant_precision = 5;
  bool resync_marker = false, low_delay = false, quarter_sample = false, mpeg_quant = false;
  bool data_partitioning = false, partitioned = false;  // the VOL's flag; the VOP being decoded uses it
  // the macroblocks of a data-partitioned video packet, from its first two
  // partitions (FFmpeg's mb_type, cbp_table, qscale_table, pred_dir_table)
  enum { DP_INTER = 0, DP_INTER4V = 1, DP_INTRA = 2, DP_SKIP = 3 };
  std::vector<uint8_t> dp_type, dp_cbp, dp_ac_pred, dp_q, dp_dir;
  int mb_num_left = 0;
  uint8_t intra_matrix[64], inter_matrix[64];  // natural order
  // the encoder, from the user data and the fourcc (ff_mpeg4_workaround_bugs)
  int lavc_build = -1, xvid_build = -1, divx_version = -1, divx_build = -1;
  bool divx_packed = false, xvid_idct = false;
  // WMV2 (the H263 decoder below): its own IDCT, and its quarter-sample luma
  // prediction (ff_mspel_motion) with the picture's mspel flag and the macroblock's hshift;
  // each inter block's ABT type (0 8x8, 1 two 8x4, 2 two 4x8) and second sub-block
  bool wmv2_idct = false, mspel = false;
  int hshift = 0;
  int abt_type_table[6] = {};
  int16_t abt_block2[6][64] = {};
  int bugs = 0;
  int picture_number = 0;
  // time stamps (decode_vop_header), in ticks of 1 / time_resolution
  int64_t time_base = 0, last_time_base = 0, time = 0, last_non_b_time = 0;
  uint16_t pp_time = 0, pb_time = 0;
  // the VOP being decoded
  int pict_type = I_VOP, qscale = 1, f_code = 1, b_code = 1, no_rounding = 0, intra_dc_threshold = 99;
  int y_dc_scale = 8, c_dc_scale = 8;
  int mb_x = 0, mb_y = 0, resync_mb_x = 0, resync_mb_y = 0;
  bool first_slice_line = true, ac_pred = false;
  // pictures: the one decoded, the older and the newer reference (FFmpeg's
  // cur_pic, last_pic and next_pic)
  Frame cur, past, future;
  bool have_past = false, have_future = false, skipped_last_frame = false, last_decoded_b = false;
  std::vector<uint8_t> stash;  // the B-VOP after a packed P-VOP (divx_packed)
  // prediction state, with a border of one block (or macroblock) on each side
  int bw = 0, cw = 0;  // widths of the luma-block and chroma (macroblock) grids, borders included
  std::vector<int16_t> dc_y, dc_u, dc_v, ac_y, ac_u, ac_v, mv;
  std::vector<int8_t> qs;  // quantiser of each macroblock
  // the newer reference's macroblocks, for B-VOPs: not coded, four vectors
  std::vector<uint8_t> ref_skipped, ref_four_mv;
  int16_t block[6][64];
  int last_index[6];
  int mv_type = 0;  // 0: one vector, 1: four
  int mv_dir = 1;  // 1 forward, 2 backward, 3 both
  int mvs[2][4][2];  // [direction][block][x, y]
  int last_mv[2][2];  // B-VOPs: the vector predictors of each direction
  bool mb_intra = false;

  Mpeg4() {
    memcpy(intra_matrix, kDefaultIntraMatrix, 64);
    memcpy(inter_matrix, kDefaultInterMatrix, 64);
  }

  int refuse(const char* what) {
    msg = std::string("MPEG-4 Part 2: ") + what + " is not supported";
    return NOT_IMPLEMENTED;
  }
  int damaged(const char* what) {
    char buf[200];
    snprintf(buf, sizeof(buf), "MPEG-4 Part 2: %s (macroblock %d, %d)", what, mb_x, mb_y);
    msg = buf;
    return DAMAGED;
  }

  // the DC scales by quantiser: MPEG-4's, or those of the H.263 family
  const uint8_t* y_dc_table = kYDcScale;
  const uint8_t* c_dc_table = kCDcScale;

  void set_qscale(int q) {
    qscale = q < 1 ? 1 : (q > 31 ? 31 : q);
    y_dc_scale = y_dc_table[qscale];
    c_dc_scale = c_dc_table[qscale];
  }

  // ---- headers

  // load_*_quant_mat: up to 64 values in zigzag order, the last repeated after a 0
  int load_matrix(Bits& b, uint8_t* m) {
    int last = 0, i = 0;
    for (; i < 64; ++i) {
      if (b.left() < 8) return damaged("a truncated quantisation matrix");
      int v = (int)b.get(8);
      if (v == 0) break;
      last = v;
      m[kZigzag[i]] = (uint8_t)v;
    }
    for (; i < 64; ++i) m[kZigzag[i]] = (uint8_t)last;
    return OK;
  }

  int decode_vol(Bits& b) {
    b.skip(1);  // random_accessible_vol
    vo_type = (int)b.get(8);
    if (vo_type == 14 || vo_type == 15) return refuse("the Studio profile");
    int ver_id = 1;
    if (b.get1()) {
      ver_id = (int)b.get(4);
      b.skip(3);
    }
    if (b.get(4) == 15) b.skip(16);  // aspect_ratio_info: extended PAR
    vol_control = b.get1();
    if (vol_control) {
      if (b.get(2) != 1) return refuse("a chroma format other than 4:2:0");
      low_delay = b.get1();
      if (b.get1()) b.skip(15 + 1 + 15 + 1 + 15 + 1 + 3 + 11 + 1 + 15 + 1);  // vbv parameters
    } else if (picture_number == 0) {  // SIMPLE_VO_TYPE and ADV_SIMPLE_VO_TYPE are low delay
      low_delay = vo_type == 1 || vo_type == 17;
    }
    int shape = (int)b.get(2);
    if (shape != 0) return refuse("a video object layer shape other than rectangular");
    b.skip(1);
    int resolution = (int)b.get(16);
    if (!resolution) return damaged("vop_time_increment_resolution 0");
    time_resolution = resolution;
    time_increment_bits = 1;
    while ((1 << time_increment_bits) < resolution) ++time_increment_bits;  // av_log2(res - 1) + 1
    if (resolution == 1) time_increment_bits = 1;
    b.skip(1);
    if (b.get1()) b.skip(time_increment_bits);  // fixed_vop_rate
    b.skip(1);
    int w = (int)b.get(13);
    b.skip(1);
    int h = (int)b.get(13);
    b.skip(1);
    if (b.get1()) return refuse("interlaced video");
    b.skip(1);  // obmc_disable: FFmpeg decodes without OBMC either way
    if (b.get(ver_id == 1 ? 1 : 2)) return refuse("sprites and global motion compensation");
    if (b.get1()) return refuse("video other than 8-bit");
    mpeg_quant = b.get1();  // quant_type 1: MPEG quantisation
    if (mpeg_quant) {
      memcpy(intra_matrix, kDefaultIntraMatrix, 64);
      memcpy(inter_matrix, kDefaultInterMatrix, 64);
      if (b.get1()) {
        int st = load_matrix(b, intra_matrix);
        if (st) return st;
      }
      if (b.get1()) {
        int st = load_matrix(b, inter_matrix);
        if (st) return st;
      }
    }
    quarter_sample = ver_id != 1 && b.get1();
    if (!b.get1()) return refuse("complexity estimation");
    resync_marker = !b.get1();
    data_partitioning = b.get1();
    if (data_partitioning && b.get1()) return refuse("data partitioning with RVLC (reversible VLCs)");
    if (ver_id != 1) {
      if (b.get1()) return refuse("newpred");
      if (b.get1()) return refuse("reduced-resolution VOPs");
    }
    if (b.get1()) return refuse("scalability");
    if (w <= 0 || h <= 0 || w > 8192 || h > 8192) return damaged("bad frame size");
    if (!have_vol || w != width || h != height) set_size(w, h);
    have_vol = true;
    return OK;
  }

  // the picture size, and the prediction state for it (the references dropped)
  void set_size(int w, int h) {
    width = w;
    height = h;
    mb_w = (w + 15) / 16;
    mb_h = (h + 15) / 16;
    mb_num = mb_w * mb_h;
    bw = 2 * mb_w + 2;
    cw = mb_w + 2;
    size_t nb = (size_t)bw * (2 * mb_h + 2), nc = (size_t)cw * (mb_h + 2);
    dc_y.assign(nb, 1024);
    dc_u.assign(nc, 1024);
    dc_v.assign(nc, 1024);
    ac_y.assign(nb * 16, 0);
    ac_u.assign(nc * 16, 0);
    ac_v.assign(nc * 16, 0);
    mv.assign(nb * 2, 0);
    qs.assign(nc, 0);
    ref_skipped.assign(mb_num, 0);
    ref_four_mv.assign(mb_num, 0);
    have_past = have_future = false;
  }

  void decode_user_data(Bits& b) {
    char buf[256];
    int i = 0;
    for (; i < 255 && b.left() > 0; ++i) {
      if (b.show(23) == 0) break;
      buf[i] = (char)b.get(8);
    }
    buf[i] = 0;
    int ver = 0, ver2 = 0, ver3 = 0, build = 0;
    char last;
    int e = sscanf(buf, "DivX%dBuild%d%c", &ver, &build, &last);
    if (e < 2) e = sscanf(buf, "DivX%db%d%c", &ver, &build, &last);
    if (e >= 2) {
      divx_version = ver;
      divx_build = build;
      divx_packed = e == 3 && last == 'p';
    }
    e = sscanf(buf, "FFmpe%*[^b]b%d", &build) + 3;
    if (e != 4) e = sscanf(buf, "FFmpeg v%d.%d.%d / libavcodec build: %d", &ver, &ver2, &ver3, &build);
    if (e != 4) {
      e = sscanf(buf, "Lavc%d.%d.%d", &ver, &ver2, &ver3) + 1;
      if (e > 1) build = ((ver & 0xFF) << 16) + ((ver2 & 0xFF) << 8) + (ver3 & 0xFF);
    }
    if (e != 4 && strcmp(buf, "ffmpeg") == 0) lavc_build = 4600;
    if (e == 4) lavc_build = build;
    if (sscanf(buf, "XviD%d", &build) == 1) xvid_build = build;
  }

  // the headers before a VOP; returns OK at a VOP start code (b past it),
  // NO_FRAME at the end of the data
  int decode_headers(Bits& b) {
    b.align();
    uint32_t startcode = 0xff;
    bool vol = false;
    while (true) {
      if (b.left() <= 0) return NO_FRAME;
      startcode = (startcode << 8) | b.get(8);
      if ((startcode & 0xFFFFFF00) != 0x100) continue;
      if (startcode >= 0x120 && startcode <= 0x12F) {
        if (!vol) {  // FFmpeg ignores a second VOL header in one packet
          vol = true;
          int st = decode_vol(b);
          if (st) return st;
        }
      } else if (startcode == 0x1B2) {
        decode_user_data(b);
      } else if (startcode == 0x1B6) {
        return OK;
      }
      b.align();
      startcode = 0xff;
    }
  }

  // ff_mpeg4_workaround_bugs: the encoder told by the user data or fourcc, and
  // what FFmpeg decodes differently for it (the Xvid IDCT; the bugs of old
  // Xvid, DivX and libavcodec builds)
  int check_encoder() {
    auto rl32 = [](const char* s) {  // AV_RL32
      return (uint32_t)s[0] | (uint32_t)s[1] << 8 | (uint32_t)s[2] << 16 | (uint32_t)s[3] << 24;
    };
    if (xvid_build == -1 && divx_version == -1 && lavc_build == -1) {
      if (tag == rl32("XVID") || tag == rl32("XVIX") || tag == rl32("RMP4") || tag == rl32("ZMP4") ||
          tag == rl32("SIPP"))
        xvid_build = 0;
    }
    if (xvid_build == -1 && divx_version == -1 && lavc_build == -1 && tag == rl32("DIVX") && vo_type == 0 &&
        vol_control == 0)
      divx_version = 400;
    if (xvid_build >= 0 && divx_version >= 0) divx_version = divx_build = -1;
    // FF_BUG_XVID_ILACE (XVIX) and FF_BUG_HPEL_CHROMA (DivX) act on interlaced video only
    if (tag == rl32("UMP4")) bugs |= BUG_UMP4;
    if (divx_version >= 500 && divx_build < 1814) bugs |= BUG_QPEL_CHROMA;
    if (divx_version > 502 && divx_build < 1814) bugs |= BUG_QPEL_CHROMA2;
    if ((unsigned)xvid_build <= 1u) bugs |= BUG_QPEL_CHROMA;
    if ((unsigned)xvid_build <= 12u) bugs |= BUG_EDGE;
    if ((unsigned)xvid_build <= 32u) bugs |= BUG_DC_CLIP;
    if ((unsigned)lavc_build < 4653u) bugs |= BUG_STD_QPEL;
    if ((unsigned)lavc_build < 4670u) bugs |= BUG_EDGE;
    if ((unsigned)lavc_build <= 4712u) bugs |= BUG_DC_CLIP;
    if ((unsigned)divx_version < 500u) bugs |= BUG_EDGE;
    // padding_bug_score (old Xvid, DivX 5.01 of 2002-04-16) acts on streams
    // without resync markers whose end is padded wrongly; FF_BUG_IEDGE moves
    // an edge buffer in a way no progressive picture shows
    if (xvid_build >= 0) xvid_idct = true;
    return OK;
  }

  int h_edge() const { return (bugs & BUG_EDGE) ? width : mb_w * 16; }
  int v_edge() const { return (bugs & BUG_EDGE) ? height : mb_h * 16; }

  // decode_vop_header up to the quantiser; FRAME_SKIPPED for a VOP FFmpeg
  // decodes to no frame
  int decode_vop_header(Bits& b) {
    pict_type = (int)b.get(2);
    if (pict_type == B_VOP && low_delay && vol_control == 0) low_delay = false;  // "set incorrectly"
    int time_incr = 0;
    while (b.get1()) {
      ++time_incr;
      if (b.left() <= 0) return damaged("truncated VOP header");
    }
    b.skip(1);  // marker
    const int time_increment = (int)b.get(time_increment_bits);
    if (pict_type != B_VOP) {
      last_time_base = time_base;
      time_base += time_incr;
      time = time_base * time_resolution + time_increment;
      if ((bugs & BUG_UMP4) && time < last_non_b_time) {
        ++time_base;
        time += time_resolution;
      }
      pp_time = (uint16_t)(time - last_non_b_time);
      last_non_b_time = time;
    } else {
      time = (last_time_base + time_incr) * time_resolution + time_increment;
      pb_time = (uint16_t)(pp_time - (last_non_b_time - time));
      if (pp_time <= pb_time || pp_time <= pp_time - pb_time || pp_time <= 0) {
        ++stats[ST_SKIPPED_B];  // "messed up order": FFmpeg skips the B-VOP
        return FRAME_SKIPPED;
      }
    }
    b.skip(1);  // marker
    if (!b.get1()) {  // vop_coded = 0: FFmpeg outputs no frame
      ++stats[ST_NOT_CODED_VOP];
      skipped_last_frame = true;
      return FRAME_SKIPPED;
    }
    if (pict_type == S_VOP) return refuse("S-VOPs (sprites and global motion compensation)");
    no_rounding = pict_type == P_VOP ? b.get1() : 0;
    intra_dc_threshold = kDcThreshold[b.get(3)];
    int q = (int)b.get(quant_precision);
    if (q == 0) return damaged("quantiser 0");
    set_qscale(q);
    f_code = b_code = 1;
    if (pict_type != I_VOP) {
      f_code = (int)b.get(3);
      if (f_code == 0) return damaged("f_code 0");
    }
    if (pict_type == B_VOP) {
      b_code = (int)b.get(3);
      if (b_code == 0) return damaged("b_code 0");
    }
    if (b.left() < 0) return damaged("truncated VOP header");
    // divx4, old Xvid and OpenDivX streams that do not set low_delay
    if (vo_type == 0 && vol_control == 0 && divx_version == -1 && picture_number == 0) low_delay = true;
    ++picture_number;
    return OK;
  }

  // ---- prediction state

  int16_t* dc_at(int n) {  // the DC store of block n of the current macroblock
    if (n < 4) return &dc_y[(size_t)(2 * mb_y + (n >> 1) + 1) * bw + 2 * mb_x + (n & 1) + 1];
    return &(n == 4 ? dc_u : dc_v)[(size_t)(mb_y + 1) * cw + mb_x + 1];
  }
  int16_t* ac_at(int n) {
    if (n < 4) return &ac_y[((size_t)(2 * mb_y + (n >> 1) + 1) * bw + 2 * mb_x + (n & 1) + 1) * 16];
    return &(n == 4 ? ac_u : ac_v)[((size_t)(mb_y + 1) * cw + mb_x + 1) * 16];
  }
  int wrap(int n) const { return n < 4 ? bw : cw; }
  int16_t* mv_at(int n) {  // motion vector of luma block n of the current macroblock
    return &mv[((size_t)(2 * mb_y + (n >> 1) + 1) * bw + 2 * mb_x + (n & 1) + 1) * 2];
  }
  int8_t& qs_at(int x, int y) { return qs[(size_t)(y + 1) * cw + x + 1]; }

  // ff_mpeg4_pred_dc's prediction: the predictor, and the direction (0 left, 1 top)
  int pred_dc(int n, int* dir) {
    int16_t* dc = dc_at(n);
    int wr = wrap(n);
    int a = dc[-1], bb = dc[-1 - wr], c = dc[-wr];
    if (first_slice_line && n != 3) {
      if (n != 2) bb = c = 1024;
      if (n != 1 && mb_x == resync_mb_x) bb = a = 1024;
    }
    if (mb_x == resync_mb_x && mb_y == resync_mb_y + 1) {
      if (n == 0 || n == 4 || n == 5) bb = 1024;
    }
    if (std::abs(a - bb) < std::abs(bb - c)) {
      *dir = 1;
      return c;
    }
    *dir = 0;
    return a;
  }

  // mpeg4_get_level_dc: the DC level with its prediction, stored scaled
  // (not clipped at 2047 under FF_BUG_DC_CLIP)
  int level_dc(int n, int pred, int level) {
    int scale = n < 4 ? y_dc_scale : c_dc_scale;
    pred = (pred + (scale >> 1)) / scale;
    level += pred;
    int ret = level;
    level *= scale;
    if (level & ~2047) {
      if (level < 0) level = 0;
      else if (!(bugs & BUG_DC_CLIP)) level = 2047;
    }
    *dc_at(n) = (int16_t)level;
    return ret;
  }

  void pred_ac(int16_t* blk, int n, int dir) {
    int16_t* ac = ac_at(n);
    if (ac_pred) {
      if (dir == 0) {
        const int16_t* left = ac - 16;
        int q = mb_x > 0 ? qs_at(mb_x - 1, mb_y) : qscale;
        if (mb_x == 0 || qscale == q || n == 1 || n == 3) {
          for (int i = 1; i < 8; ++i) blk[i << 3] += left[i];
        } else {
          ++stats[ST_AC_RESCALED];
          for (int i = 1; i < 8; ++i) blk[i << 3] += rounded_div(left[i] * q, qscale);
        }
      } else {
        const int16_t* top = ac - 16 * wrap(n);
        int q = mb_y > 0 ? qs_at(mb_x, mb_y - 1) : qscale;
        if (mb_y == 0 || qscale == q || n == 2 || n == 3) {
          for (int i = 1; i < 8; ++i) blk[i] += top[i + 8];
        } else {
          ++stats[ST_AC_RESCALED];
          for (int i = 1; i < 8; ++i) blk[i] += rounded_div(top[i + 8] * q, qscale);
        }
      }
    }
    for (int i = 1; i < 8; ++i) ac[i] = blk[i << 3];
    for (int i = 1; i < 8; ++i) ac[8 + i] = blk[i];
  }

  void clean_intra_entries() {  // ff_clean_intra_table_entries
    for (int n = 0; n < 6; ++n) {
      *dc_at(n) = 1024;
      memset(ac_at(n), 0, 16 * sizeof(int16_t));
    }
  }

  // ---- blocks

  int decode_dc(Bits& b, int n, int* dir) {  // mpeg4_decode_dc
    const Tables& t = tables();
    int code = (n < 4 ? t.dc_lum : t.dc_chrom).read(b);
    if (code < 0) return INT32_MIN;
    int level = 0;
    if (code) {
      level = b.xbits(code);
      if (code > 8) b.skip(1);  // marker
    }
    int pred = pred_dc(n, dir);
    return level_dc(n, pred, level);
  }

  // mpeg4_decode_block; the inter levels of MPEG quantisation are left for
  // dequant_mpeg_inter, as FFmpeg's tables for quantiser 0 leave them
  int decode_block(Bits& b, int16_t* blk, int n, bool coded, bool intra) {
    const Tables& t = tables();
    int i, qmul, qadd, dir = 0, pred = 0;
    const RunLevel* rl;
    const uint8_t* scan = kZigzag;
    bool use_dc_vlc = qscale_at_mb_start < intra_dc_threshold;
    if (intra) {
      if (use_dc_vlc && partitioned) {  // decoded with the partitions: recovered from its store
        const int scale = n < 4 ? y_dc_scale : c_dc_scale;
        blk[0] = (int16_t)((*dc_at(n) + (scale >> 1)) / scale);
        dir = (dp_dir[mb_y * mb_w + mb_x] << n) & 32 ? 1 : 0;
        i = 0;
      } else if (use_dc_vlc) {
        int level = decode_dc(b, n, &dir);
        if (level == INT32_MIN) return damaged("bad DC size code");
        blk[0] = (int16_t)level;
        i = 0;
      } else {
        ++stats[ST_DC_AS_AC];
        i = -1;
        pred = pred_dc(n, &dir);
      }
      rl = &t.intra;
      if (ac_pred) scan = dir == 0 ? kAltVertical : kAltHorizontal;
      qmul = 1;
      qadd = 0;
    } else {
      i = -1;
      if (!coded) {
        last_index[n] = -1;
        return OK;
      }
      rl = &t.inter;
      qmul = mpeg_quant ? 1 : qscale << 1;
      qadd = mpeg_quant ? 0 : (qscale - 1) | 1;
    }
    if (coded) {
      while (true) {
        int sym = rl->vlc.read(b);
        if (sym < 0) return damaged("bad TCOEF code");
        int run, level, last;
        if (sym != kEscape) {
          run = rl->run[sym];
          last = rl->last[sym];
          level = rl->level[sym] * qmul + qadd;
          if (b.get1()) level = -level;
          i += run + 1;
        } else {
          int mode = (int)b.show(2);
          if (mode < 2) {  // first escape: the level is offset by the run's largest
            ++stats[ST_ESCAPE1];
            b.skip(1);
            sym = rl->vlc.read(b);
            if (sym < 0 || sym == kEscape) return damaged("bad TCOEF code after escape");
            run = rl->run[sym];
            last = rl->last[sym];
            level = rl->level[sym] * qmul + qadd + rl->max_level[last][run] * qmul;
            if (b.get1()) level = -level;
            i += run + 1;
          } else if (mode == 2) {  // second escape: the run is offset by the level's largest
            ++stats[ST_ESCAPE2];
            b.skip(2);
            sym = rl->vlc.read(b);
            if (sym < 0 || sym == kEscape) return damaged("bad TCOEF code after escape");
            run = rl->run[sym];
            last = rl->last[sym];
            int lv = rl->level[sym];
            level = lv * qmul + qadd;
            run += rl->max_run[last][lv] + 1;
            if (b.get1()) level = -level;
            i += run + 1;
          } else {  // third escape: last, run and level given outright
            ++stats[ST_ESCAPE3];
            b.skip(2);
            last = b.get1();
            run = (int)b.get(6);
            if (!b.get1()) return damaged("missing marker in a third escape");
            level = b.sget(12);
            if (!b.get1()) return damaged("missing marker in a third escape");
            level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
            if ((unsigned)(level + 2048) > 4095) level = level < 0 ? -2048 : 2047;
            i += run + 1;
          }
        }
        if (b.left() < 0) return damaged("truncated block");
        if (last) {
          if (i > 63) return damaged("coefficients past the block");
          blk[scan[i]] = (int16_t)level;
          break;
        }
        if (i > 62) return damaged("coefficients past the block");
        blk[scan[i]] = (int16_t)level;
      }
    }
    if (intra) {
      if (!use_dc_vlc) {
        blk[0] = (int16_t)level_dc(n, pred, blk[0]);
        if (i < 0) i = 0;
      }
      pred_ac(blk, n, dir);
      if (ac_pred) i = 63;
    }
    last_index[n] = i;
    return OK;
  }

  // dct_unquantize_mpeg2_intra_c (FFmpeg's, not the bit-exact one): the DC
  // by its scale, the others level * 2 qscale * matrix >> 4
  void dequant_mpeg_intra(int16_t* blk, int n) {
    blk[0] = (int16_t)(blk[0] * (n < 4 ? y_dc_scale : c_dc_scale));
    const int q = qscale << 1;
    for (int i = 1; i <= last_index[n]; ++i) {
      const int j = kZigzag[i];
      int level = blk[j];
      if (!level) continue;
      level = level < 0 ? -((int)(-level * q * intra_matrix[j]) >> 4) : (int)(level * q * intra_matrix[j]) >> 4;
      blk[j] = (int16_t)level;
    }
  }

  // dct_unquantize_mpeg2_inter_c: (2 level + 1) * 2 qscale * matrix >> 5, then
  // mismatch control on the last coefficient
  void dequant_mpeg_inter(int16_t* blk, int n) {
    const int q = qscale << 1;
    int sum = -1;
    for (int i = 0; i <= last_index[n]; ++i) {
      const int j = kZigzag[i];
      int level = blk[j];
      if (!level) continue;
      level = level < 0 ? -((((-level << 1) + 1) * q * inter_matrix[j]) >> 5)
                        : (((level << 1) + 1) * q * inter_matrix[j]) >> 5;
      blk[j] = (int16_t)level;
      sum += level;
    }
    blk[63] ^= sum & 1;
  }

  // ---- motion vectors

  // ff_h263_pred_motion
  int16_t* pred_motion(int n, int* px, int* py) {
    static const int off[4] = {2, 1, 1, -1};
    int16_t* mvp = mv_at(n);
    int wr = bw * 2;  // in int16 units: one row of vectors
    int16_t* A = mvp - 2;
    if (first_slice_line && n < 3) {
      if (n == 0) {
        if (mb_x == resync_mb_x) {
          *px = *py = 0;
        } else if (mb_x + 1 == resync_mb_x) {
          int16_t* C = mvp + 2 * off[n] - wr;
          if (mb_x == 0) {
            *px = C[0];
            *py = C[1];
          } else {
            *px = mid_pred(A[0], 0, C[0]);
            *py = mid_pred(A[1], 0, C[1]);
          }
        } else {
          *px = A[0];
          *py = A[1];
        }
      } else if (n == 1) {
        if (mb_x + 1 == resync_mb_x) {
          int16_t* C = mvp + 2 * off[n] - wr;
          *px = mid_pred(A[0], 0, C[0]);
          *py = mid_pred(A[1], 0, C[1]);
        } else {
          *px = A[0];
          *py = A[1];
        }
      } else {
        int16_t* B = mvp - wr;
        int16_t* C = mvp + 2 * off[n] - wr;
        if (mb_x == resync_mb_x) A[0] = A[1] = 0;
        *px = mid_pred(A[0], B[0], C[0]);
        *py = mid_pred(A[1], B[1], C[1]);
      }
    } else {
      int16_t* B = mvp - wr;
      int16_t* C = mvp + 2 * off[n] - wr;
      *px = mid_pred(A[0], B[0], C[0]);
      *py = mid_pred(A[1], B[1], C[1]);
    }
    return mvp;
  }

  // ff_h263_decode_motion; INT32_MIN for a bad code
  int decode_motion(Bits& b, int pred, int fcode) {
    int code = tables().mv.read(b);
    if (code == 0) return pred;
    if (code < 0) return INT32_MIN;
    int sign = b.get1(), shift = fcode - 1, val = code;
    if (shift) {
      val = (val - 1) << shift;
      val |= (int)b.get(shift);
      val++;
    }
    if (sign) val = -val;
    val += pred;
    int bits = 5 + fcode;  // sign_extend(val, 5 + f_code)
    return (int)((uint32_t)val << (32 - bits)) >> (32 - bits);
  }

  // ---- motion compensation (mpegvideo_motion.c), edges repeated as
  // emulated_edge_mc repeats them

  static void hpel(const uint8_t* plane, int stride, int edge_w, int edge_h, int x, int y, int dxy,
                   int bsize, bool no_rnd, uint8_t* dst, int dstride) {
    auto px = [&](int xx, int yy) {
      xx = xx < 0 ? 0 : (xx >= edge_w ? edge_w - 1 : xx);
      yy = yy < 0 ? 0 : (yy >= edge_h ? edge_h - 1 : yy);
      return (int)plane[(size_t)yy * stride + xx];
    };
    // FFmpeg's x86 build averages 8-wide blocks without rounding by
    // put_no_rnd_pixels8_{x2,y2}_mmxext unless asked to be bit-exact:
    // pavgb(max(p - 1, 0), q), exact but where p is 0; p is the left sample
    // (x2) or that of the pair's odd source row counted from the block's
    // first (y2). 16-wide blocks take the exact C versions.
    auto avg_no_rnd = [bsize](int p, int q) {
      return bsize == 16 ? (p + q) >> 1 : ((p > 0 ? p - 1 : 0) + q + 1) >> 1;
    };
    for (int r = 0; r < bsize; ++r)
      for (int c = 0; c < bsize; ++c) {
        int a = px(x + c, y + r), v;
        switch (dxy) {
          case 0: v = a; break;
          case 1: {
            int b = px(x + c + 1, y + r);
            v = no_rnd ? avg_no_rnd(a, b) : (a + b + 1) >> 1;
            break;
          }
          case 2: {
            int b = px(x + c, y + r + 1);
            v = !no_rnd ? (a + b + 1) >> 1 : (r & 1) ? avg_no_rnd(a, b) : avg_no_rnd(b, a);
            break;
          }
          default:
            v = (a + px(x + c + 1, y + r) + px(x + c, y + r + 1) + px(x + c + 1, y + r + 1) + (no_rnd ? 1 : 2)) >> 2;
        }
        dst[(size_t)r * dstride + c] = (uint8_t)v;
      }
  }

  // qpel_mc of the (s + 1) x (s + 1) samples at (x, y), edges repeated
  static void qpel(const uint8_t* plane, int stride, int edge_w, int edge_h, int x, int y, int dxy, int s,
                   bool no_rnd, bool old, uint8_t* dst, int dstride) {
    uint8_t full[17 * 17], out[16 * 16];
    for (int r = 0; r <= s; ++r) {
      int yy = y + r;
      yy = yy < 0 ? 0 : (yy >= edge_h ? edge_h - 1 : yy);
      for (int c = 0; c <= s; ++c) {
        int xx = x + c;
        xx = xx < 0 ? 0 : (xx >= edge_w ? edge_w - 1 : xx);
        full[r * (s + 1) + c] = plane[(size_t)yy * stride + xx];
      }
    }
    qpel_mc(out, full, s, dxy, no_rnd, old);
    for (int r = 0; r < s; ++r) memcpy(dst + (size_t)r * dstride, out + r * s, s);
  }

  // the macroblock's prediction from one reference (ff_mpv_motion for
  // MV_TYPE_16X16 and MV_TYPE_8X8: mpeg_motion, qpel_motion, hpel_motion and
  // chroma_4mv_motion) into y (16 x 16), u and v (8 x 8 each)
  void predict(const Frame& f, const int (*mvv)[2], bool nr, uint8_t* y, uint8_t* u, uint8_t* v) {
    const int he = h_edge(), ve = v_edge();
    if (mv_type == 0 && mspel) {
      mspel_predict(f, mvv[0][0], mvv[0][1], nr, y, u, v);
      return;
    }
    if (mv_type == 0) {
      const int mx = mvv[0][0], my = mvv[0][1];
      if (quarter_sample) {  // qpel_motion
        const int dxy = ((my & 3) << 2) | (mx & 3);
        const int sx = mb_x * 16 + (mx >> 2), sy = mb_y * 16 + (my >> 2);
        qpel(f.y.data(), f.ystride, he, ve, sx, sy, dxy, 16, nr, bugs & BUG_STD_QPEL, y, 16);
        int cx, cy;
        if (bugs & BUG_QPEL_CHROMA2) {
          static const int rtab[8] = {0, 0, 1, 1, 0, 0, 0, 1};
          cx = (mx >> 1) + rtab[mx & 7];
          cy = (my >> 1) + rtab[my & 7];
        } else if (bugs & BUG_QPEL_CHROMA) {
          cx = (mx >> 1) | (mx & 1);
          cy = (my >> 1) | (my & 1);
        } else {
          cx = mx / 2;
          cy = my / 2;
        }
        cx = (cx >> 1) | (cx & 1);
        cy = (cy >> 1) | (cy & 1);
        const int uvdxy = (cx & 1) | ((cy & 1) << 1);
        const int ux = mb_x * 8 + (cx >> 1), uy = mb_y * 8 + (cy >> 1);
        hpel(f.u.data(), f.cstride, he >> 1, ve >> 1, ux, uy, uvdxy, 8, nr, u, 8);
        hpel(f.v.data(), f.cstride, he >> 1, ve >> 1, ux, uy, uvdxy, 8, nr, v, 8);
        return;
      }
      // mpeg_motion_internal, 16x16
      const int dxy = ((my & 1) << 1) | (mx & 1);
      const int sx = mb_x * 16 + (mx >> 1), sy = mb_y * 16 + (my >> 1);
      hpel(f.y.data(), f.ystride, he, ve, sx, sy, dxy, 16, nr, y, 16);
      const int uvdxy = dxy | (my & 2) | ((mx & 2) >> 1);
      const int ux = sx >> 1, uy = sy >> 1;
      hpel(f.u.data(), f.cstride, he >> 1, ve >> 1, ux, uy, uvdxy, 8, nr, u, 8);
      hpel(f.v.data(), f.cstride, he >> 1, ve >> 1, ux, uy, uvdxy, 8, nr, v, 8);
      return;
    }
    int sumx = 0, sumy = 0;
    for (int i = 0; i < 4; ++i) {
      const int mx = mvv[i][0], my = mvv[i][1];
      uint8_t* d = y + (i & 1) * 8 + (i >> 1) * 8 * 16;
      if (quarter_sample) {
        int dxy = ((my & 3) << 2) | (mx & 3);
        int sx = mb_x * 16 + (mx >> 2) + (i & 1) * 8, sy = mb_y * 16 + (my >> 2) + (i >> 1) * 8;
        sx = std::max(-16, std::min(sx, width));
        if (sx == width) dxy &= ~3;
        sy = std::max(-16, std::min(sy, height));
        if (sy == height) dxy &= ~12;
        qpel(f.y.data(), f.ystride, he, ve, sx, sy, dxy, 8, nr, bugs & BUG_STD_QPEL, d, 16);
        sumx += mx / 2;
        sumy += my / 2;
      } else {  // hpel_motion
        int sx = mb_x * 16 + (i & 1) * 8 + (mx >> 1), sy = mb_y * 16 + (i >> 1) * 8 + (my >> 1);
        int dxy = 0;
        sx = std::max(-16, std::min(sx, width));
        if (sx != width) dxy |= mx & 1;
        sy = std::max(-16, std::min(sy, height));
        if (sy != height) dxy |= (my & 1) << 1;
        hpel(f.y.data(), f.ystride, he, ve, sx, sy, dxy, 8, nr, d, 16);
        sumx += mx;
        sumy += my;
      }
    }
    // chroma_4mv_motion, with ff_h263_round_chroma
    static const uint8_t roundtab[16] = {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2};
    int mx = roundtab[sumx & 15] + ((sumx >> 3) & ~1), my = roundtab[sumy & 15] + ((sumy >> 3) & ~1);
    int dxy = ((my & 1) << 1) | (mx & 1);
    mx >>= 1;
    my >>= 1;
    int sx = mb_x * 8 + mx, sy = mb_y * 8 + my;
    sx = std::max(-8, std::min(sx, width >> 1));
    if (sx == (width >> 1)) dxy &= ~1;
    sy = std::max(-8, std::min(sy, height >> 1));
    if (sy == (height >> 1)) dxy &= ~2;
    hpel(f.u.data(), f.cstride, he >> 1, ve >> 1, sx, sy, dxy, 8, nr, u, 8);
    hpel(f.v.data(), f.cstride, he >> 1, ve >> 1, sx, sy, dxy, 8, nr, v, 8);
  }

  // ff_mspel_motion (wmv2.c): the luma's four 8 x 8 blocks through the mspel
  // filters at dxy = 2 * (half-sample position) + hshift, the chroma at half
  // samples rounded from the quarter positions; edges repeated
  void mspel_predict(const Frame& f, int mx, int my, bool nr, uint8_t* y, uint8_t* u, uint8_t* v) {
    const int he = h_edge(), ve = v_edge();
    int dxy = 2 * (((my & 1) << 1) | (mx & 1)) + hshift;
    int sx = std::max(-16, std::min(mb_x * 16 + (mx >> 1), width));
    int sy = std::max(-16, std::min(mb_y * 16 + (my >> 1), height));
    if (sx <= -16 || sx >= width) dxy &= ~3;
    if (sy <= -16 || sy >= height) dxy &= ~4;
    uint8_t src[11 * 11];
    for (int blk = 0; blk < 4; ++blk) {
      const int bx = sx + (blk & 1) * 8, by = sy + (blk >> 1) * 8;
      for (int r = 0; r < 11; ++r) {
        const int yy = std::max(0, std::min(by + r - 1, ve - 1));
        for (int c = 0; c < 11; ++c)
          src[r * 11 + c] = f.y[(size_t)yy * f.ystride + std::max(0, std::min(bx + c - 1, he - 1))];
      }
      mspel8(y + (blk & 1) * 8 + (blk >> 1) * 8 * 16, 16, src, dxy);
    }
    int cdxy = ((mx & 3) != 0) | (((my & 3) != 0) << 1);
    int cx = std::max(-8, std::min(mb_x * 8 + (mx >> 2), width >> 1));
    if (cx == (width >> 1)) cdxy &= ~1;
    int cy = std::max(-8, std::min(mb_y * 8 + (my >> 2), height >> 1));
    if (cy == (height >> 1)) cdxy &= ~2;
    hpel(f.u.data(), f.cstride, he >> 1, ve >> 1, cx, cy, cdxy, 8, nr, u, 8);
    hpel(f.v.data(), f.cstride, he >> 1, ve >> 1, cx, cy, cdxy, 8, nr, v, 8);
  }

  // the forward prediction put, the backward one put or averaged over it
  // (avg_pixels and avg_qpel: (dst + pred + 1) >> 1)
  void motion(uint8_t* dy, uint8_t* du, uint8_t* dv) {
    uint8_t py[256], pu[64], pv[64];
    bool have = false;
    for (int dir = 0; dir < 2; ++dir) {
      if (!(mv_dir & (1 << dir))) continue;
      const Frame& f = pict_type == B_VOP ? (dir ? future : past) : future;
      predict(f, mvs[dir], pict_type != B_VOP && no_rounding, py, pu, pv);
      for (int r = 0; r < 16; ++r)
        for (int c = 0; c < 16; ++c) {
          uint8_t& d = dy[(size_t)r * cur.ystride + c];
          d = have ? (uint8_t)((d + py[r * 16 + c] + 1) >> 1) : py[r * 16 + c];
        }
      for (int r = 0; r < 8; ++r)
        for (int c = 0; c < 8; ++c) {
          uint8_t& a = du[(size_t)r * cur.cstride + c];
          uint8_t& b = dv[(size_t)r * cur.cstride + c];
          a = have ? (uint8_t)((a + pu[r * 8 + c] + 1) >> 1) : pu[r * 8 + c];
          b = have ? (uint8_t)((b + pv[r * 8 + c] + 1) >> 1) : pv[r * 8 + c];
        }
      have = true;
    }
  }

  // ---- macroblocks

  int qscale_at_mb_start = 1;

  // ff_mpeg4_set_direct_mv: the co-located vectors of the newer reference
  // scaled by TRB / TRD, plus the delta
  void set_direct_mv(int mx, int my) {
    const int mb = mb_y * mb_w + mb_x;
    const int tpp = pp_time, tpb = pb_time;
    auto one = [&](int i) {
      const int16_t* p = mv_at(i);
      for (int c = 0; c < 2; ++c) {
        const int d = c ? my : mx, pm = p[c];
        mvs[0][i][c] = pm * tpb / tpp + d;
        mvs[1][i][c] = d ? mvs[0][i][c] - pm : pm * (tpb - tpp) / tpp;
      }
    };
    if (ref_four_mv[mb]) {
      mv_type = 1;
      for (int i = 0; i < 4; ++i) one(i);
      return;
    }
    one(0);
    for (int i = 1; i < 4; ++i)
      for (int c = 0; c < 2; ++c) {
        mvs[0][i][c] = mvs[0][0][c];
        mvs[1][i][c] = mvs[1][0][c];
      }
    // FFmpeg tests FF_BUG_DIRECT_BLOCKSIZE in avctx->workaround_bugs, where
    // ff_mpeg4_workaround_bugs does not set it: an autodetected one has no effect
    mv_type = quarter_sample ? 1 : 0;
  }

  // mpeg4_decode_mb for B-VOPs
  int decode_b_mb(Bits& b) {
    mb_intra = false;
    mv_type = 0;
    if (mb_x == 0) memset(last_mv, 0, sizeof(last_mv));
    for (int i = 0; i < 6; ++i) memset(block[i], 0, sizeof(block[i]));
    if (ref_skipped[mb_y * mb_w + mb_x]) {  // not coded in the newer reference: the older one's macroblock
      ++stats[ST_B_COLOCATED_SKIP];
      for (int i = 0; i < 6; ++i) last_index[i] = -1;
      mv_dir = 1;
      memset(mvs, 0, sizeof(mvs));
      return OK;
    }
    int cbp = 0;
    bool direct;
    if (b.get1()) {  // modb '1': direct, no vectors, no coefficients
      direct = true;
      ++stats[ST_B_DIRECT];
      set_direct_mv(0, 0);
      mv_dir = 3;
    } else {
      const int modb2 = b.get1();
      int type = 0;  // mb_type: '1' direct, '01' interpolated, '001' backward, '0001' forward
      while (type < 4 && !b.get1()) ++type;
      if (type == 4) return damaged("bad B macroblock type");
      if (!modb2) cbp = (int)b.get(6);
      direct = type == 0;
      if (!direct && cbp && b.get1()) {
        ++stats[ST_DBQUANT];
        set_qscale(qscale + b.get1() * 4 - 2);
      }
      if (!direct) {
        mv_dir = type == 1 ? 3 : type == 2 ? 2 : 1;
        ++stats[type == 1 ? ST_B_INTERPOLATED : type == 2 ? ST_B_BACKWARD : ST_B_FORWARD];
        for (int dir = 0; dir < 2; ++dir) {
          if (!(mv_dir & (1 << dir))) continue;
          const int fc = dir ? b_code : f_code;
          int mx = decode_motion(b, last_mv[dir][0], fc);
          if (mx == INT32_MIN) return damaged("bad motion vector code");
          int my = decode_motion(b, last_mv[dir][1], fc);
          if (my == INT32_MIN) return damaged("bad motion vector code");
          last_mv[dir][0] = mvs[dir][0][0] = mx;
          last_mv[dir][1] = mvs[dir][0][1] = my;
        }
      } else {
        ++stats[ST_B_DIRECT];
        int mx = decode_motion(b, 0, 1);
        if (mx == INT32_MIN) return damaged("bad motion vector code");
        int my = decode_motion(b, 0, 1);
        if (my == INT32_MIN) return damaged("bad motion vector code");
        set_direct_mv(mx, my);
        mv_dir = 3;
      }
    }
    if (quarter_sample) ++stats[ST_QPEL_MB];
    for (int i = 0; i < 6; ++i) {
      int st = decode_block(b, block[i], i, (cbp & 32) != 0, false);
      if (st) return st;
      cbp += cbp;
    }
    return OK;
  }

  // ---- data partitioning (mpeg4_decode_partitions)

  static constexpr uint32_t DC_MARKER = 0x6B001, MOTION_MARKER = 0x1F001;

  // the intra DCs of a macroblock in a partition, and their directions (dp_dir)
  int partition_dcs(Bits& b, int mb) {
    int dir = 0;
    for (int i = 0; i < 6; ++i) {
      int d = 0;
      const int level = decode_dc(b, i, &d);
      if (level == INT32_MIN || level < 0) return damaged("a bad DC in a partition");
      dir = (dir << 1) | d;
    }
    dp_dir[mb] = (uint8_t)dir;
    return OK;
  }

  // mpeg4_decode_partition_a: the macroblocks up to the DC or motion marker;
  // returns their number, or -1 (msg set)
  int partition_a(Bits& b) {
    const Tables& t = tables();
    int count = 0;
    first_slice_line = true;
    for (; mb_y < mb_h; ++mb_y) {
      for (; mb_x < mb_w; ++mb_x) {
        const int mb = mb_y * mb_w + mb_x;
        ++count;
        if (mb_x == resync_mb_x && mb_y == resync_mb_y + 1) first_slice_line = false;
        if (pict_type == I_VOP) {
          int cbpc;
          do {
            if (b.show(19) == DC_MARKER) return count - 1;
            cbpc = t.intra_mcbpc.read(b);
            if (cbpc < 0) return damaged("bad MCBPC code in the first partition"), -1;
          } while (cbpc == 8);
          dp_cbp[mb] = (uint8_t)(cbpc & 3);
          dp_type[mb] = DP_INTRA;
          mb_intra = true;
          if (cbpc & 4) {
            ++stats[ST_DQUANT];
            set_qscale(qscale + kDquant[b.get(2)]);
          }
          dp_q[mb] = (uint8_t)qscale;
          qs_at(mb_x, mb_y) = (int8_t)qscale;
          if (partition_dcs(b, mb)) return -1;
          continue;
        }
        int cbpc;
        while (true) {
          const uint32_t bits = b.show(17);
          if (bits == MOTION_MARKER) return count - 1;
          b.skip(1);
          if (bits & 0x10000) {
            cbpc = -1;  // not coded
            break;
          }
          cbpc = t.inter_mcbpc.read(b);
          if (cbpc < 0) return damaged("bad MCBPC code in the first partition"), -1;
          if (cbpc != 20) break;
        }
        int16_t* mvp = mv_at(0);
        const int wr = bw * 2;
        auto set_all = [&](int mx, int my) {
          mvp[0] = mvp[2] = mvp[wr] = mvp[wr + 2] = (int16_t)mx;
          mvp[1] = mvp[3] = mvp[wr + 1] = mvp[wr + 3] = (int16_t)my;
        };
        if (cbpc < 0) {
          ++stats[ST_SKIPPED_MB];
          dp_type[mb] = DP_SKIP;
          set_all(0, 0);
          clean_intra_entries();
          continue;
        }
        dp_cbp[mb] = (uint8_t)(cbpc & (8 + 3));
        if (cbpc & 4) {
          dp_type[mb] = DP_INTRA;
          set_all(0, 0);
          continue;
        }
        clean_intra_entries();
        if (no_rounding) ++stats[ST_NO_ROUNDING_MB];
        if (quarter_sample) ++stats[ST_QPEL_MB];
        int px, py;
        if (!(cbpc & 16)) {
          dp_type[mb] = DP_INTER;
          pred_motion(0, &px, &py);
          const int mx = decode_motion(b, px, f_code);
          if (mx == INT32_MIN) return damaged("bad motion vector code"), -1;
          const int my = decode_motion(b, py, f_code);
          if (my == INT32_MIN) return damaged("bad motion vector code"), -1;
          set_all(mx, my);
        } else {
          ++stats[ST_FOUR_MV_MB];
          dp_type[mb] = DP_INTER4V;
          for (int i = 0; i < 4; ++i) {
            int16_t* p = pred_motion(i, &px, &py);
            const int mx = decode_motion(b, px, f_code);
            if (mx == INT32_MIN) return damaged("bad motion vector code"), -1;
            const int my = decode_motion(b, py, f_code);
            if (my == INT32_MIN) return damaged("bad motion vector code"), -1;
            p[0] = (int16_t)mx;
            p[1] = (int16_t)my;
          }
        }
      }
      mb_x = 0;
    }
    return count;
  }

  // mpeg4_decode_partition_b: ac_pred, CBPY, DQUANT and the DCs of P-VOPs' intra macroblocks
  int partition_b(Bits& b, int count) {
    const Tables& t = tables();
    int n = 0;
    mb_x = resync_mb_x;
    first_slice_line = true;
    for (mb_y = resync_mb_y; n < count; ++mb_y) {
      for (; n < count && mb_x < mb_w; ++mb_x) {
        const int mb = mb_y * mb_w + mb_x;
        ++n;
        if (mb_x == resync_mb_x && mb_y == resync_mb_y + 1) first_slice_line = false;
        if (pict_type == I_VOP || dp_type[mb] == DP_INTRA) {
          dp_ac_pred[mb] = (uint8_t)b.get1();
          const int cbpy = t.cbpy.read(b);
          if (cbpy < 0) return damaged("bad CBPY code in the second partition");
          if (pict_type == P_VOP) {
            ++stats[ST_INTRA_MB_IN_P];
            if (dp_cbp[mb] & 8) {
              ++stats[ST_DQUANT];
              set_qscale(qscale + kDquant[b.get(2)]);
            }
            dp_q[mb] = (uint8_t)qscale;
            qs_at(mb_x, mb_y) = (int8_t)qscale;
            if (partition_dcs(b, mb)) return DAMAGED;
          }
          dp_cbp[mb] = (uint8_t)((dp_cbp[mb] & 3) | (cbpy << 2));
        } else if (dp_type[mb] == DP_SKIP) {
          dp_q[mb] = (uint8_t)qscale;
          dp_cbp[mb] = 0;
        } else {
          const int cbpy = t.cbpy.read(b);
          if (cbpy < 0) return damaged("bad CBPY code in the second partition");
          if (dp_cbp[mb] & 8) {
            ++stats[ST_DQUANT];
            set_qscale(qscale + kDquant[b.get(2)]);
          }
          dp_q[mb] = (uint8_t)qscale;
          dp_cbp[mb] = (uint8_t)((dp_cbp[mb] & 3) | ((cbpy ^ 0xF) << 2));
        }
      }
      if (n >= count) return OK;
      mb_x = 0;
    }
    return OK;
  }

  // ff_mpeg4_decode_partitions, then back to the packet's first macroblock
  int decode_partitions(Bits& b) {
    const int q = qscale;
    const int count = partition_a(b);
    if (count < 0) return DAMAGED;
    if (count == 0) return damaged("an empty first partition");
    if (resync_mb_x + resync_mb_y * mb_w + count > mb_num) return damaged("a partition past the picture");
    mb_num_left = count;
    if (pict_type == I_VOP) {
      while (b.show(9) == 1) b.skip(9);
      if (b.get(19) != DC_MARKER) return damaged("no DC marker after the first partition");
    } else {
      while (b.show(10) == 1) b.skip(10);
      if (b.get(17) != MOTION_MARKER) return damaged("no motion marker after the first partition");
    }
    int st = partition_b(b, count);
    if (st) return st;
    ++stats[ST_PARTITIONED_PACKETS];
    first_slice_line = true;
    mb_x = resync_mb_x;
    mb_y = resync_mb_y;
    set_qscale(q);
    return OK;
  }

  // mpeg4_decode_partitioned_mb: the texture of one macroblock; SLICE_END at
  // the packet's last one
  int decode_partitioned_mb(Bits& b) {
    const int mb = mb_y * mb_w + mb_x;
    const int type = dp_type[mb];
    int cbp = dp_cbp[mb];
    qscale_at_mb_start = qscale;  // FFmpeg tests the intra DC threshold before taking the macroblock's quantiser
    if (dp_q[mb] != qscale) set_qscale(dp_q[mb]);
    for (int i = 0; i < 6; ++i) memset(block[i], 0, sizeof(block[i]));
    mv_dir = 1;
    mv_type = type == DP_INTER4V ? 1 : 0;
    mb_intra = type == DP_INTRA;
    ac_pred = mb_intra && dp_ac_pred[mb];
    if (ac_pred) ++stats[ST_AC_PRED_MB];
    const int mb_index = mb_y * mb_w + mb_x;
    ref_skipped[mb_index] = type == DP_SKIP;
    ref_four_mv[mb_index] = type == DP_INTER4V;
    for (int i = 0; i < 4; ++i) {
      const int16_t* p = mv_at(i);
      mvs[0][i][0] = p[0];
      mvs[0][i][1] = p[1];
    }
    if (type == DP_SKIP) {
      for (int i = 0; i < 6; ++i) last_index[i] = -1;
    } else {
      for (int i = 0; i < 6; ++i) {
        int st = decode_block(b, block[i], i, (cbp & 32) != 0, mb_intra);
        if (st) return st;
        cbp += cbp;
      }
    }
    if (--mb_num_left <= 0) {
      if (is_resync(b)) return PARTITIONS_END;
      return damaged("a video packet whose partitions do not end together");
    }
    return OK;
  }

  // mpeg4_decode_mb, for I- and P-VOPs without data partitioning
  int decode_mb(Bits& b) {
    if (partitioned) return decode_partitioned_mb(b);
    if (pict_type == B_VOP) return decode_b_mb(b);
    const Tables& t = tables();
    int cbpc, cbp, dquant;
    for (int i = 0; i < 6; ++i) memset(block[i], 0, sizeof(block[i]));
    mv_type = 0;
    mv_dir = 1;
    const int mb = mb_y * mb_w + mb_x;
    ref_skipped[mb] = ref_four_mv[mb] = 0;
    if (pict_type == P_VOP) {
      do {
        if (b.get1()) {  // not coded: the reference's macroblock, vector 0
          ++stats[ST_SKIPPED_MB];
          ref_skipped[mb] = 1;
          mb_intra = false;
          for (int i = 0; i < 6; ++i) last_index[i] = -1;
          mvs[0][0][0] = mvs[0][0][1] = 0;
          return OK;
        }
        cbpc = t.inter_mcbpc.read(b);
        if (cbpc < 0) return damaged("bad MCBPC code");
      } while (cbpc == 20);
      dquant = cbpc & 8;
      mb_intra = (cbpc & 4) != 0;
      if (!mb_intra) {
        int cbpy = t.cbpy.read(b);
        if (cbpy < 0) return damaged("bad CBPY code");
        cbpy ^= 0xF;
        cbp = (cbpc & 3) | (cbpy << 2);
        if (dquant) {
          ++stats[ST_DQUANT];
          set_qscale(qscale + kDquant[b.get(2)]);
        }
        if (no_rounding) ++stats[ST_NO_ROUNDING_MB];
        if (quarter_sample) ++stats[ST_QPEL_MB];
        int px, py;
        if ((cbpc & 16) == 0) {
          pred_motion(0, &px, &py);
          int mx = decode_motion(b, px, f_code);
          if (mx == INT32_MIN) return damaged("bad motion vector code");
          int my = decode_motion(b, py, f_code);
          if (my == INT32_MIN) return damaged("bad motion vector code");
          mvs[0][0][0] = mx;
          mvs[0][0][1] = my;
        } else {
          ++stats[ST_FOUR_MV_MB];
          mv_type = 1;
          ref_four_mv[mb] = 1;
          for (int i = 0; i < 4; ++i) {
            int16_t* mvp = pred_motion(i, &px, &py);
            int mx = decode_motion(b, px, f_code);
            if (mx == INT32_MIN) return damaged("bad motion vector code");
            int my = decode_motion(b, py, f_code);
            if (my == INT32_MIN) return damaged("bad motion vector code");
            mvs[0][i][0] = mvp[0] = (int16_t)mx;
            mvs[0][i][1] = mvp[1] = (int16_t)my;
          }
        }
        for (int i = 0; i < 6; ++i) {
          int st = decode_block(b, block[i], i, (cbp & 32) != 0, false);
          if (st) return st;
          cbp += cbp;
        }
        return OK;
      }
    } else {
      do {
        cbpc = t.intra_mcbpc.read(b);
        if (cbpc < 0) return damaged("bad MCBPC code");
      } while (cbpc == 8);
      dquant = cbpc & 4;
      mb_intra = true;
    }
    if (pict_type == P_VOP) ++stats[ST_INTRA_MB_IN_P];
    ac_pred = b.get1();
    if (ac_pred) ++stats[ST_AC_PRED_MB];
    int cbpy = t.cbpy.read(b);
    if (cbpy < 0) return damaged("bad CBPY code");
    cbp = (cbpc & 3) | (cbpy << 2);
    qscale_at_mb_start = qscale;
    if (dquant) {
      ++stats[ST_DQUANT];
      set_qscale(qscale + kDquant[b.get(2)]);
    }
    for (int i = 0; i < 6; ++i) {
      int st = decode_block(b, block[i], i, (cbp & 32) != 0, true);
      if (st) return st;
      cbp += cbp;
    }
    return OK;
  }

  void update_motion_val() {  // ff_h263_update_motion_val (not for B-VOPs)
    if (pict_type == B_VOP) return;
    if (mv_type == 1 && !mb_intra) return;  // stored while parsing
    int mx = mb_intra ? 0 : mvs[0][0][0], my = mb_intra ? 0 : mvs[0][0][1];
    for (int n = 0; n < 4; ++n) {
      int16_t* p = mv_at(n);
      p[0] = (int16_t)mx;
      p[1] = (int16_t)my;
    }
  }

  void idct_put(uint8_t* dst, int stride, int16_t* blk) {
    if (wmv2_idct) {
      vid::wmv2_idct(dst, stride, blk, false);
    } else if (xvid_idct) {
      ++stats[ST_XVID_IDCT_BLOCK];
      xvid_idct_put(dst, stride, blk);
    } else {
      vid::idct_put(dst, stride, blk);
    }
  }
  void idct_add(uint8_t* dst, int stride, int16_t* blk) {
    if (wmv2_idct) {
      vid::wmv2_idct(dst, stride, blk, true);
    } else if (xvid_idct) {
      ++stats[ST_XVID_IDCT_BLOCK];
      xvid_idct_add(dst, stride, blk);
    } else {
      vid::idct_add(dst, stride, blk);
    }
  }

  void reconstruct() {  // ff_mpv_reconstruct_mb
    if (pict_type != B_VOP) qs_at(mb_x, mb_y) = (int8_t)qscale;
    uint8_t* dy = cur.y.data() + (size_t)mb_y * 16 * cur.ystride + mb_x * 16;
    uint8_t* du = cur.u.data() + (size_t)mb_y * 8 * cur.cstride + mb_x * 8;
    uint8_t* dv = cur.v.data() + (size_t)mb_y * 8 * cur.cstride + mb_x * 8;
    uint8_t* dst[6] = {dy, dy + 8, dy + 8 * (size_t)cur.ystride, dy + 8 * (size_t)cur.ystride + 8, du, dv};
    if (!mb_intra) {
      if (pict_type != B_VOP) clean_intra_entries();
      motion(dy, du, dv);
      for (int n = 0; n < 6; ++n)
        if (last_index[n] >= 0) {
          if (mpeg_quant) {
            ++stats[ST_MPEG_QUANT_BLOCK];
            dequant_mpeg_inter(block[n], n);
          }
          const int stride = n < 4 ? cur.ystride : cur.cstride;
          if (wmv2_idct && abt_type_table[n]) {  // wmv2_add_block: the two sub-blocks
            const bool rows = abt_type_table[n] == 1;
            (rows ? idct84_add : idct48_add)(dst[n], stride, block[n]);
            (rows ? idct84_add : idct48_add)(dst[n] + (rows ? 4 * (size_t)stride : 4), stride, abt_block2[n]);
            memset(abt_block2[n], 0, sizeof(abt_block2[n]));
          } else {
            idct_add(dst[n], stride, block[n]);
          }
        }
      return;
    }
    int qmul = qscale << 1, qadd = (qscale - 1) | 1;  // dct_unquantize_h263_intra
    for (int n = 0; n < 6; ++n) {
      int16_t* blk = block[n];
      if (mpeg_quant) {
        ++stats[ST_MPEG_QUANT_BLOCK];
        dequant_mpeg_intra(blk, n);
      } else {
        blk[0] = (int16_t)(blk[0] * (n < 4 ? y_dc_scale : c_dc_scale));
        for (int k = 1; k < 64; ++k) {
          int level = blk[k];
          if (level) blk[k] = (int16_t)(level < 0 ? level * qmul - qadd : level * qmul + qadd);
        }
      }
      idct_put(dst[n], n < 4 ? cur.ystride : cur.cstride, blk);
    }
  }

  int prefix_length() const {  // ff_mpeg4_get_video_packet_prefix_length
    if (pict_type == I_VOP) return 16;
    if (pict_type == B_VOP) return std::max(std::max(f_code, b_code), 2) + 15;
    return f_code + 15;
  }

  // mpeg4_is_resync: the macroblock number of the video packet that starts
  // here, mb_num at the end of the data, 0 if none
  int is_resync(Bits& b) {
    int64_t bits_count = b.pos;
    int v = (int)b.show(16);
    int type = pict_type + 1;  // FFmpeg's AV_PICTURE_TYPE_I is 1, _P 2
    while (v <= 0xFF) {  // macroblock stuffing: 9 bits in an I-VOP, 10 in a P-VOP
      if (pict_type == B_VOP || (v >> (8 - type)) != 1) break;
      b.skip(8 + type);
      bits_count += 8 + type;
      v = (int)b.show(16);
    }
    if (bits_count + 8 >= b.nbits) {
      v >>= 8;
      v |= 0x7F >> (7 - (bits_count & 7));
      if (v == 0x7F) return mb_num;
    } else {
      static const uint16_t prefix[8] = {0x7F00, 0x7E00, 0x7C00, 0x7800, 0x7000, 0x6000, 0x4000, 0x0000};
      if (v == prefix[bits_count & 7]) {
        Bits g = b;
        g.skip(1);
        g.align();
        int len = 0;
        for (; len < 32; ++len)
          if (g.get1()) break;
        int mb_num_bits = 1;
        while ((1 << mb_num_bits) < mb_num) ++mb_num_bits;
        int num = (int)g.get(mb_num_bits);
        if (!num || num > mb_num || g.pos + 6 > g.nbits) num = -1;
        if (len >= prefix_length()) return num;
      }
    }
    return 0;
  }

  // decode_video_packet_header, after ff_h263_resync found the marker
  int decode_packet_header(Bits& b) {
    if (b.left() < 20) return damaged("truncated video packet header");
    int len = 0;
    for (; len < 32; ++len)
      if (b.get1()) break;
    if (len != prefix_length()) return damaged("a resync marker that does not match f_code");
    int mb_num_bits = 1;
    while ((1 << mb_num_bits) < mb_num) ++mb_num_bits;
    int num = (int)b.get(mb_num_bits);
    if (num >= mb_num || num <= 0) return damaged("bad macroblock number in a video packet header");
    mb_x = num % mb_w;
    mb_y = num / mb_w;
    int q = (int)b.get(quant_precision);
    if (q) set_qscale(q);
    if (b.get1()) {  // header_extension_code
      while (b.get1()) {
        if (b.left() <= 0) return damaged("truncated video packet header");
      }
      b.skip(1);
      b.skip(time_increment_bits);
      b.skip(1);
      b.skip(2 + 3);  // vop_coding_type, intra_dc_vlc_thr (FFmpeg ignores both here)
      if (pict_type != I_VOP) b.skip(3);  // f_code
      if (pict_type == B_VOP) b.skip(3);  // b_code
    }
    return OK;
  }

  // ff_h263_resync: the video packet header after the stuffing, else the
  // next one at a byte boundary from the start of this packet
  int resync(Bits& b, const Bits& packet_start) {
    b.skip(1);
    b.align();
    if (b.show(16) == 0) {
      Bits g = b;
      if (decode_packet_header(g) == OK) {
        b = g;
        return OK;
      }
    }
    b = packet_start;
    b.align();
    for (int64_t left = b.left(); left > 16 + 1 + 5 + 5; left -= 8) {
      if (b.show(16) == 0) {
        Bits g = b;
        if (decode_packet_header(g) == OK) {
          b = g;
          return OK;
        }
      }
      b.skip(8);
    }
    return damaged("the data ends before the VOP does");
  }

  void clean_buffers() {  // ff_mpeg4_clean_buffers: no AC or vector prediction across packets
    auto clear = [](std::vector<int16_t>& ac, size_t from, size_t count, size_t total) {
      from = std::min(from, total);
      count = std::min(count, total - from);
      std::fill(ac.begin() + from * 16, ac.begin() + (from + count) * 16, 0);
    };
    size_t l = (size_t)(2 * mb_y) * bw + 2 * mb_x;  // row 2 mb_y - 1, column 2 mb_x - 1, with the border
    clear(ac_y, l, 2 * bw + 1, ac_y.size() / 16);
    size_t c = (size_t)mb_y * cw + mb_x;
    clear(ac_u, c, cw + 1, ac_u.size() / 16);
    clear(ac_v, c, cw + 1, ac_v.size() / 16);
    memset(last_mv, 0, sizeof(last_mv));
  }

  int decode_slice(Bits& b) {
    first_slice_line = true;
    resync_mb_x = mb_x;
    resync_mb_y = mb_y;
    set_qscale(qscale);
    if (partitioned) {
      int st = decode_partitions(b);
      if (st) return st;
    }
    for (; mb_y < mb_h; ++mb_y) {
      for (; mb_x < mb_w; ++mb_x) {
        if (resync_mb_x == mb_x && resync_mb_y + 1 == mb_y) first_slice_line = false;
        if (!partitioned) qscale_at_mb_start = qscale;
        int st = decode_mb(b);
        update_motion_val();
        if (st && st != PARTITIONS_END) return st;
        reconstruct();
        if (st == PARTITIONS_END) {
          if (++mb_x >= mb_w) {
            mb_x = 0;
            ++mb_y;
          }
          return SLICE_END;
        }
        if (partitioned) continue;
        int next = is_resync(b);
        if (next) {
          if (next < 0 || mb_x + mb_y * mb_w + 1 >= next) {
            if (++mb_x >= mb_w) {
              mb_x = 0;
              ++mb_y;
            }
            return SLICE_END;
          }
        }
      }
      mb_x = 0;
    }
    return OK;
  }

  // ff_mpeg4_frame_end for divx_packed: the rest of a packet whose next VOP
  // is an I- or B-VOP is kept for the next packet
  void keep_packed(const uint8_t* data, long n, int64_t consumed_bits) {
    const long at = (long)(consumed_bits >> 3);
    if (n - at <= 7) return;
    for (long i = at; i < n - 4; ++i)
      if (data[i] == 0 && data[i + 1] == 0 && data[i + 2] == 1 && data[i + 3] == 0xB6) {
        if (!(data[i + 4] & 0x40)) {
          stash.assign(data + at, data + n);
          ++stats[ST_PACKED_B];
        }
        return;
      }
  }

  // one packet; FRAME with ``out`` the frame to show (in display order: with
  // B-VOPs a reference waits for the next one, and `flush` gives the last)
  int decode(const uint8_t* packet, long packet_n, Frame& out) {
    if (divx_packed && !stash.empty()) {  // "Discarding excessive bitstream in packed xvid"
      for (long i = 0; i + 3 < packet_n; ++i)
        if (packet[i] == 0 && packet[i + 1] == 0 && packet[i + 2] == 1) {
          if (packet[i + 3] == 0xB0) stash.clear();
          break;
        }
    }
    std::vector<uint8_t> held;
    const uint8_t* data = packet;
    long n = packet_n;
    if (!stash.empty() && (divx_packed || packet_n <= MAX_NVOP_SIZE)) {
      held.swap(stash);
      data = held.data();
      n = (long)held.size();
    }
    stash.clear();
    if (n >= 3 && data[0] == 0 && data[1] == 0 && (data[2] & 0xFC) == 0x80)
      return damaged("an H.263 picture (short_video_header), which FFmpeg's MPEG-4 decoder decodes to nothing");
    Bits b;
    b.init(data, n);
    int st = decode_headers(b);
    if (st == NO_FRAME) return NO_FRAME;  // headers only
    if (st) return st;
    if (!have_vol) return damaged("a VOP before any video object layer header");
    st = check_encoder();
    if (st) return st;
    st = decode_vop_header(b);
    if (st == FRAME_SKIPPED) return NO_FRAME;
    if (st) return st;
    skipped_last_frame = false;
    if (pict_type == P_VOP && !have_future) return damaged("a P-VOP without a reference frame");
    if (pict_type == B_VOP && !have_past) {  // FFmpeg skips B-VOPs without both references
      ++stats[ST_SKIPPED_B];
      return NO_FRAME;
    }
    ++stats[pict_type == I_VOP ? ST_I_VOP : pict_type == P_VOP ? ST_P_VOP : ST_B_VOP];
    cur.alloc(width, height, mb_w * 16, mb_h * 16, mb_w * 8, mb_h * 8, 1);
    mb_x = mb_y = 0;
    memset(last_mv, 0, sizeof(last_mv));
    partitioned = data_partitioning && pict_type != B_VOP;
    if (partitioned) {
      for (auto* v : {&dp_type, &dp_cbp, &dp_ac_pred, &dp_q, &dp_dir}) v->assign(mb_num, 0);
    }
    while (true) {
      Bits packet_start = b;
      st = decode_slice(b);
      if (st != SLICE_END) break;
      if (mb_y >= mb_h) break;
      st = resync(b, packet_start);
      if (st) return st;
      ++stats[ST_PACKETS];
      clean_buffers();
    }
    if (st != OK && st != SLICE_END) return st;
    if (divx_packed) keep_packed(packet, packet_n, data == packet ? b.pos : 0);
    cur.full_range = false;
    last_decoded_b = pict_type == B_VOP;
    if (pict_type == B_VOP) {
      out = cur;
      return FRAME;
    }
    const bool had_future = have_future;
    if (had_future) std::swap(past, future);
    std::swap(future, cur);
    have_past = had_future;
    have_future = true;
    if (low_delay) {
      out = future;
      return FRAME;
    }
    if (!had_future) return NO_FRAME;
    out = past;
    return FRAME;
  }

  // the end of the stream: the reference still held back (h263dec.c), or the
  // last picture again when the stream ended with a VOP that is not coded
  int flush(Frame& out) {
    if (!low_delay && have_future) {
      have_future = have_past = false;
      out = future;
      return FRAME;
    }
    if (low_delay && skipped_last_frame && have_future) {
      skipped_last_frame = false;
      out = last_decoded_b ? cur : future;
      return FRAME;
    }
    return NO_FRAME;
  }
};

// ---- The H.263 family (h263dec.c, ituh263dec.c, flvdec.c, msmpeg4dec.c) -------
//
// One decoder over Mpeg4's macroblock state, motion compensation and IDCT,
// with the picture layers of H.263 (baseline, and PLUSPTYPE's custom picture
// format with the deblocking filter of Annex J and no other optional annex),
// Sorenson H.263 (FLV1), Microsoft's MPEG-4 v2 (MP42) and v3 (DIV3), and
// Windows Media Video 7 (WMV1) and 8 (WMV2): low delay, one frame out for
// each picture (none for a WMV2 picture whose every macroblock is skipped).

// A VLC whose codes may be longer than its table: the codes of up to ``bits``
// bits looked up at once, the longer ones compared one by one
struct LongVlc {
  int bits = 0;
  std::vector<int32_t> sym;
  std::vector<uint8_t> len;
  std::vector<uint32_t> long_code;
  std::vector<uint8_t> long_len;
  std::vector<int32_t> long_sym;
  void init(int b) {
    bits = b;
    sym.assign((size_t)1 << b, -1);
    len.assign((size_t)1 << b, 0);
  }
  void add(uint32_t code, int n, int symbol) {
    if (n <= bits) {
      const int shift = bits - n;
      const uint32_t base = code << shift;
      for (uint32_t j = 0; j < (1u << shift); ++j) {
        sym[base | j] = symbol;
        len[base | j] = (uint8_t)n;
      }
      return;
    }
    size_t at = 0;  // kept sorted by length
    while (at < long_len.size() && long_len[at] <= n) ++at;
    long_code.insert(long_code.begin() + at, code);
    long_len.insert(long_len.begin() + at, (uint8_t)n);
    long_sym.insert(long_sym.begin() + at, symbol);
  }
  int read(Bits& b) const {  // the symbol, or -1 for no code
    const uint32_t idx = b.show(bits);
    if (len[idx]) {
      b.skip(len[idx]);
      return sym[idx];
    }
    for (size_t i = 0; i < long_len.size(); ++i)
      if (b.show(long_len[i]) == long_code[i]) {
        b.skip(long_len[i]);
        return long_sym[i];
      }
    return -1;
  }
};

// An RLTable: a VLC over n codes and the escape (symbol n), each code's run,
// level and last flag, and ff_rl_init's largest level of each run and largest
// run of each level
struct RlTab {
  LongVlc vlc;
  int n = 0;
  std::vector<int> run, level, last;
  int max_level[2][65] = {}, max_run[2][65] = {};
  void init(int count, int last_start, const int* runs, const int* levels) {
    n = count;
    run.assign(runs, runs + n);
    level.assign(levels, levels + n);
    last.resize(n);
    for (int i = 0; i < n; ++i) {
      last[i] = i >= last_start;
      const int l = last[i];
      max_level[l][run[i] & 63] = std::max(max_level[l][run[i] & 63], level[i]);
      if (level[i] <= 64) max_run[l][level[i]] = std::max(max_run[l][level[i]], run[i]);
    }
  }
};

struct H263Tables {
  RlTab rl[6];  // ff_rl_table's order: 0, 1 and MPEG-4's intra table; 2, 3 and H.263's inter table
  LongVlc mb_i, mb_non_intra, dc[2][2], mv[2], v2_dc[2], v2_mb_type, v2_intra_cbpc;
  LongVlc wmv2_inter[3], inter_intra;  // WMV2's macroblock VLCs by CBP table index (the fourth is mb_non_intra)
  H263Tables() {
    const int8_t* runs[4] = {msmp4::kRl0Run, msmp4::kRl1Run, msmp4::kRl2Run, msmp4::kRl3Run};
    const int8_t* levels[4] = {msmp4::kRl0Level, msmp4::kRl1Level, msmp4::kRl2Level, msmp4::kRl3Level};
    const uint16_t (*vlcs[4])[2] = {msmp4::kRl0Vlc, msmp4::kRl1Vlc, msmp4::kRl2Vlc, msmp4::kRl3Vlc};
    const int sizes[4] = {msmp4::kRl0Size, msmp4::kRl1Size, msmp4::kRl2Size, msmp4::kRl3Size};
    const int lasts[4] = {msmp4::kRl0Last, msmp4::kRl1Last, msmp4::kRl2Last, msmp4::kRl3Last};
    const int slot[4] = {0, 1, 3, 4};
    for (int t = 0; t < 4; ++t) {
      RlTab& r = rl[slot[t]];
      std::vector<int> ru(runs[t], runs[t] + sizes[t]), le(levels[t], levels[t] + sizes[t]);
      r.init(sizes[t], lasts[t], ru.data(), le.data());
      r.vlc.init(9);
      for (int i = 0; i <= sizes[t]; ++i) r.vlc.add(vlcs[t][i][0], vlcs[t][i][1], i);
    }
    const RunLevel* mpeg4[2] = {&tables().intra, &tables().inter};
    const uint16_t (*tcoef[2])[2] = {kIntraTcoef, kInterTcoef};
    for (int t = 0; t < 2; ++t) {
      RlTab& r = rl[t ? 5 : 2];
      const RunLevel& src = *mpeg4[t];
      int last_start = 0;
      while (last_start < kEscape && !src.last[last_start]) ++last_start;
      r.init(kEscape, last_start, src.run, src.level);
      r.vlc.init(9);
      for (int i = 0; i <= kEscape; ++i) r.vlc.add(tcoef[t][i][0], tcoef[t][i][1], i);
    }
    mb_i.init(9);
    for (int i = 0; i < 64; ++i) mb_i.add(msmp4::kMbITable[i][0], msmp4::kMbITable[i][1], i);
    mb_non_intra.init(9);
    for (int i = 0; i < 128; ++i) mb_non_intra.add(msmp4::kMbNonIntraTable[i][0], msmp4::kMbNonIntraTable[i][1], i);
    for (int t = 0; t < 3; ++t) {
      wmv2_inter[t].init(9);
      for (int i = 0; i < 128; ++i) wmv2_inter[t].add(wmv::kWmv2InterTable[t][i][0], wmv::kWmv2InterTable[t][i][1], i);
    }
    inter_intra.init(3);
    for (int i = 0; i < 4; ++i) inter_intra.add(wmv::kTableInterIntra[i][0], wmv::kTableInterIntra[i][1], i);
    for (int t = 0; t < 2; ++t)
      for (int c = 0; c < 2; ++c) {
        dc[t][c].init(9);
        for (int i = 0; i < 120; ++i) dc[t][c].add(msmp4::kDcTables[t][c][i][0], msmp4::kDcTables[t][c][i][1], i);
      }
    const uint8_t* lens[2] = {msmp4::kMvLens0, msmp4::kMvLens1};
    const uint16_t* syms[2] = {msmp4::kMvSyms0, msmp4::kMvSyms1};
    for (int t = 0; t < 2; ++t) {  // ff_vlc_init_from_lengths: codes in order, each after the last
      mv[t].init(9);
      uint64_t acc = 0;
      for (int i = 0; i < 1100; ++i) {
        mv[t].add((uint32_t)(acc >> (32 - lens[t][i])), lens[t][i], syms[t][i]);
        acc += (uint64_t)1 << (32 - lens[t][i]);
      }
    }
    // init_h263_dc_for_msmpeg4: MPEG-4's DC size codes inverted, the value's
    // bits after them and a marker past 8 bits; symbol level + 256
    for (int c = 0; c < 2; ++c) {
      v2_dc[c].init(9);
      for (int level = -256; level < 256; ++level) {
        int size = 0;
        for (int v = std::abs(level); v; v >>= 1) ++size;
        const int l = level < 0 ? (-level) ^ ((1 << size) - 1) : level;
        uint32_t code = c ? kDcChromCode[size] : kDcLumCode[size];
        int n = c ? kDcChromLen[size] : kDcLumLen[size];
        code ^= (1u << n) - 1;
        if (size > 0) {
          code = (code << size) | l;
          n += size;
          if (size > 8) {
            code = (code << 1) | 1;
            ++n;
          }
        }
        v2_dc[c].add(code, n, level + 256);
      }
    }
    v2_mb_type.init(7);
    for (int i = 0; i < 8; ++i) v2_mb_type.add(msmp4::kV2MbType[i][0], msmp4::kV2MbType[i][1], i);
    v2_intra_cbpc.init(3);
    for (int i = 0; i < 4; ++i) v2_intra_cbpc.add(msmp4::kV2IntraCbpc[i][0], msmp4::kV2IntraCbpc[i][1], i);
  }
};

const H263Tables& h263_tables() {
  static const H263Tables t;
  return t;
}

// ff_mpeg1_dc_scale_table (8 at every quantiser): H.263's, FLV's and MS-MPEG4 v2's DC scale
const uint8_t kDcScale8[32] = {8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8,
                               8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8};
// ff_h263_format: the source formats of PTYPE, width and height
const int kH263Format[8][2] = {{0, 0}, {128, 96}, {176, 144}, {352, 288}, {704, 576}, {1408, 1152}, {0, 0}, {0, 0}};

enum H263Kind { K_H263 = 0, K_FLV = 1, K_MSMP4V2 = 2, K_MSMP4V3 = 3, K_WMV1 = 4, K_WMV2 = 5 };
constexpr int SLICE_ERROR = -1;
constexpr int MBAC_BITRATE = 50 * 1024, II_BITRATE = 128 * 1024;  // msmpeg4.h: WMV1's tools by bit rate
enum { SKIP_TYPE_NONE = 0, SKIP_TYPE_MPEG = 1, SKIP_TYPE_ROW = 2, SKIP_TYPE_COL = 3 };  // WMV2's skip maps

struct H263 : Mpeg4 {
  int kind = K_H263;
  int flv = 0;  // FFmpeg's h263_flv: 1 or 2 (the 11-bit escapes of format 1)
  int gob_height = 1;
  // H.263+: the OPPTYPE fields carried over to pictures whose UFEP is 0
  bool have_opptype = false, custom_pcf = false;
  int plus_format = 0;
  // MS-MPEG4
  int slice_height = 0, rl_table_index = 2, rl_chroma_table_index = 2, dc_table_index = 0, mv_table_index = 0;
  bool use_skip_mb_code = false, flipflop_rounding = false, droppable = false;
  int pred_dir = 0;  // msmpeg4_pred_dc's direction for the block being decoded
  std::vector<uint8_t> coded_block;  // MS-MPEG4 v3: each luma block's coded flag, with a border
  // WMV1 and WMV2: the bit rate of the ext header, which picks WMV1's tools;
  // run-level tables chosen per macroblock; the inter-intra DC predictor and
  // its direction; escape 3's lengths, fixed at its first use in a picture
  int bit_rate = 0, aic_dir = 0, esc3_level_length = 0, esc3_run_length = 0;
  bool per_mb_rl_table = false, inter_intra_pred = false;
  // WMV2 (wmv2dec.c): the ext header (the container's 4 bytes of extradata)
  std::vector<uint8_t> extradata;
  bool have_ext = false;
  int mspel_bit = 0, abt_flag = 0, j_type_bit = 0, top_left_mv_flag = 0, per_mb_rl_bit = 0, cbp_table_index = 0;
  // ABT: the type a picture, a macroblock or each block picks (abt_type_table holds each block's)
  int abt_type = 0;
  bool per_mb_abt = false, per_block_abt = false;
  // the H.263 deblocking filter (Annex J; WMV2's loop_filter) and the
  // picture's skipped macroblocks, which it leaves alone (IS_SKIP)
  bool loop_filter = false;
  std::vector<uint8_t> mb_skip;
  // MS-MPEG4 and WMV, for tests only (vdec_trace): where each picture and
  // macroblock lies in its packet, so that a test can rewrite a stream into
  // one that uses a tool no encoder at hand writes. A picture: -1, the
  // picture's count, its type, the bit after its quantiser, then zeros; a
  // macroblock: its index, intra, skipped, cbp, its type code, the bits at its
  // start, after its type code, where a per-macroblock run-level table is read
  // and after its vector, the vector; then (WMV2) the bits at the start and
  // end of each block and the block in which escape 3's lengths were read
  // (-1: none)
  bool tracing = false;
  std::vector<int64_t> trace;
  int64_t tr_header = 0, tr_code = 0, tr_rl = 0, tr_mv = 0, tr_blocks[6][2] = {};
  int tr_sym = 0, tr_cbp = 0, tr_esc3_block = -1, pictures = 0;
  static constexpr int TRACE_WIDTH = 24;

  const char* name() const {
    static const char* names[] = {"H.263", "Sorenson H.263", "MS-MPEG4 v2", "MS-MPEG4 v3", "WMV1", "WMV2"};
    return names[kind];
  }
  int refuse(const char* what) {
    msg = std::string(name()) + ": " + what + " is not supported";
    return NOT_IMPLEMENTED;
  }
  int damaged(const char* what) {
    char buf[200];
    snprintf(buf, sizeof(buf), "%s: %s (macroblock %d, %d)", name(), what, mb_x, mb_y);
    msg = buf;
    return DAMAGED;
  }

  void open(int k) {
    kind = k;
    y_dc_table = kind == K_MSMP4V3 ? msmp4::kV3YDcScale : kind >= K_WMV1 ? wmv::kWmv1YDcScale : kDcScale8;
    c_dc_table = kind >= K_MSMP4V3 ? msmp4::kV3CDcScale : kDcScale8;
    wmv2_idct = kind == K_WMV2;
    low_delay = true;
  }
  void resize(int w, int h) {
    set_size(w, h);
    coded_block.assign((size_t)bw * (2 * mb_h + 2), 0);
    mb_skip.assign(mb_num, 0);
    gob_height = height <= 400 ? 1 : height <= 800 ? 2 : 4;  // ff_h263_get_gob_height
    have_vol = true;
  }

  // ---- picture headers

  // ff_h263_decode_picture_header, without the annexes FFmpeg's encoders leave off
  int h263_picture_header(Bits& b) {
    b.align();
    uint32_t startcode = b.get(22 - 8);
    for (int64_t i = b.left(); i > 24; i -= 8) {
      startcode = ((startcode << 8) | b.get(8)) & 0x003FFFFF;
      if (startcode == 0x20) break;
    }
    if (startcode != 0x20) return damaged("no picture start code");
    b.skip(8);  // temporal reference
    if (!b.get1()) return damaged("a PTYPE without its marker");
    if (b.get1()) return damaged("a PTYPE that is not H.263's");
    b.skip(3);  // split screen, document camera, freeze picture release
    int format = (int)b.get(3);
    int w = 0, h = 0;
    if (format != 7 && format != 6) {
      w = kH263Format[format][0];
      h = kH263Format[format][1];
      if (!w) return damaged("a forbidden source format");
      pict_type = b.get1() ? P_VOP : I_VOP;
      if (b.get1()) return refuse("the unrestricted motion vector mode (H.263 Annex D)");
      if (b.get1()) return refuse("syntax-based arithmetic coding (H.263 Annex E)");
      if (b.get1()) return refuse("the advanced prediction mode (H.263 Annex F)");
      if (b.get1()) return refuse("PB-frames (H.263 Annex G)");
      set_qscale((int)b.get(5));
      b.skip(1);  // continuous presence multipoint
    } else {
      const int ufep = (int)b.get(3);
      if (ufep == 1) {  // OPPTYPE
        plus_format = (int)b.get(3);
        custom_pcf = b.get1();
        if (b.get1()) return refuse("the unlimited unrestricted motion vector mode (H.263 Annex D)");
        if (b.get1()) return refuse("syntax-based arithmetic coding (H.263 Annex E)");
        if (b.get1()) return refuse("the advanced prediction mode (H.263 Annex F)");
        if (b.get1()) return refuse("advanced intra coding (H.263 Annex I)");
        loop_filter = b.get1();
        if (b.get1()) return refuse("the slice structured mode (H.263 Annex K)");
        if (b.get1()) return refuse("reference picture selection (H.263 Annex N)");
        if (b.get1()) return refuse("independent segment decoding (H.263 Annex R)");
        if (b.get1()) return refuse("the alternative inter VLC (H.263 Annex S)");
        if (b.get1()) return refuse("the modified quantisation (H.263 Annex T)");
        b.skip(1 + 3);
        have_opptype = true;
      } else if (ufep != 0) {
        return damaged("a bad UFEP");
      }
      if (!have_opptype) return damaged("an H.263+ picture before any OPPTYPE");
      switch ((int)b.get(3)) {  // MPPTYPE
        case 0: case 7: pict_type = I_VOP; break;
        case 1: pict_type = P_VOP; break;
        case 2: return refuse("improved PB-frames (H.263 Annex M)");
        case 3: return refuse("B-pictures (H.263 Annex O)");
        default: return damaged("a bad picture coding type");
      }
      b.skip(2);
      no_rounding = b.get1();
      b.skip(4);
      if (ufep) {
        if (plus_format == 6) {  // custom picture format
          const int aspect = (int)b.get(4);
          w = ((int)b.get(9) + 1) * 4;
          if (!b.get1()) return damaged("a custom picture format without its marker");
          h = (int)b.get(9) * 4;
          if (aspect == 15) b.skip(16);  // extended pixel aspect ratio
        } else {
          w = kH263Format[plus_format & 7][0];
          h = kH263Format[plus_format & 7][1];
        }
        if (!w || !h) return damaged("a zero picture size");
        if (custom_pcf) b.skip(1 + 7);  // custom picture clock frequency
      } else {
        w = width;
        h = height;
      }
      if (custom_pcf) b.skip(2);  // extended temporal reference
      set_qscale((int)b.get(5));
    }
    if (qscale == 0) return damaged("quantiser 0");
    while (b.get1()) b.skip(8);  // PEI and PSUPP
    if (b.left() < 0) return damaged("a truncated picture header");
    if (w != width || h != height || !have_vol) resize(w, h);
    f_code = 1;
    return OK;
  }

  // ff_flv_decode_picture_header
  int flv_picture_header(Bits& b) {
    if (b.get(17) != 1) return damaged("no picture start code");
    const int format = (int)b.get(5);
    if (format != 0 && format != 1) return damaged("a bad picture format");
    flv = format + 1;
    b.skip(8);  // temporal reference
    int w, h;
    switch ((int)b.get(3)) {
      case 0: w = (int)b.get(8); h = (int)b.get(8); break;
      case 1: w = (int)b.get(16); h = (int)b.get(16); break;
      case 2: w = 352; h = 288; break;
      case 3: w = 176; h = 144; break;
      case 4: w = 128; h = 96; break;
      case 5: w = 320; h = 240; break;
      case 6: w = 160; h = 120; break;
      default: w = h = 0;
    }
    if (w <= 0 || h <= 0 || w > 8192 || h > 8192) return damaged("a bad picture size");
    const int type = (int)b.get(2);
    if (type > 2) return damaged("a bad picture type");
    pict_type = type ? P_VOP : I_VOP;
    droppable = type == 2;  // a disposable P-frame: no reference for the next
    if (droppable) ++stats[ST_DROPPABLE];
    b.skip(1);  // deblocking flag
    set_qscale((int)b.get(5));
    if (qscale == 0) return damaged("quantiser 0");
    while (b.get1()) b.skip(8);  // PEI
    if (b.left() < 0) return damaged("a truncated picture header");
    if (w != width || h != height || !have_vol) resize(w, h);
    f_code = 1;
    return OK;
  }

  int decode012(Bits& b) { return b.get1() ? 1 + b.get1() : 0; }

  // ff_msmpeg4_decode_picture_header (v2, v3, WMV1)
  int msmpeg4_picture_header(Bits& b) {
    if (b.left() * 8 < (int64_t)mb_num) return damaged("a picture smaller than an eighth of a bit a macroblock");
    const int type = (int)b.get(2) + 1;
    if (type != 1 && type != 2) return damaged("a bad picture type");
    pict_type = type == 1 ? I_VOP : P_VOP;
    const int q = (int)b.get(5);
    if (q == 0) return damaged("quantiser 0");
    set_qscale(q);
    tr_header = b.pos;
    if (pict_type == I_VOP) {
      const int code = (int)b.get(5);
      if (code < 0x17) return damaged("a bad slice code");
      slice_height = mb_h / (code - 0x16);
      if (kind == K_WMV1) {
        // ff_msmpeg4_decode_ext_header(s, (2 + 5 + 5 + 17 + 7) / 8): its 17 bits here
        b.skip(5);  // frame rate
        bit_rate = (int)b.get(11) * 1024;
        flipflop_rounding = b.get1();
        per_mb_rl_table = bit_rate > MBAC_BITRATE && b.get1();
        if (!per_mb_rl_table) {
          rl_chroma_table_index = decode012(b);
          rl_table_index = decode012(b);
        }
        dc_table_index = b.get1();
        inter_intra_pred = false;
      } else if (kind == K_MSMP4V3) {
        rl_chroma_table_index = decode012(b);
        rl_table_index = decode012(b);
        dc_table_index = b.get1();
      } else {
        rl_table_index = rl_chroma_table_index = 2;
      }
      no_rounding = 1;
    } else {
      use_skip_mb_code = b.get1();
      per_mb_rl_table = kind == K_WMV1 && bit_rate > MBAC_BITRATE && b.get1();
      if (kind >= K_MSMP4V3) {
        if (!per_mb_rl_table) rl_table_index = rl_chroma_table_index = decode012(b);
        dc_table_index = b.get1();
        mv_table_index = b.get1();
      } else {
        rl_table_index = rl_chroma_table_index = 2;
      }
      inter_intra_pred = kind == K_WMV1 && width * height < 320 * 240 && bit_rate <= II_BITRATE;
      if (inter_intra_pred) ++stats[ST_INTER_INTRA_PICTURES];
      no_rounding = flipflop_rounding ? no_rounding ^ 1 : 0;
    }
    if (per_mb_rl_table) ++stats[ST_PER_MB_RL_PICTURES];
    esc3_level_length = esc3_run_length = 0;
    return OK;
  }

  // wmv2dec.c decode_ext_header: the container's 4 bytes, read before the first picture
  int wmv2_ext_header() {
    if (extradata.size() < 4)
      return refuse("a stream without the 4 bytes of extradata that hold its ext header (FFmpeg conceals such "
                    "pictures)");
    Bits g;
    g.init(extradata.data(), 4);
    g.skip(5);  // frame rate
    bit_rate = (int)g.get(11) * 1024;
    mspel_bit = g.get1();
    loop_filter = g.get1();
    abt_flag = g.get1();
    j_type_bit = g.get1();
    top_left_mv_flag = g.get1();
    per_mb_rl_bit = g.get1();
    const int code = (int)g.get(3);
    if (code == 0) return damaged("an ext header with no slices");
    slice_height = mb_h / code;
    have_ext = true;
    return OK;
  }

  // ff_wmv2_decode_picture_header; FRAME_SKIPPED for a P-frame whose every
  // macroblock is skipped, which FFmpeg decodes to no frame
  int wmv2_picture_header(Bits& b) {
    if (!have_ext) {
      const int st = wmv2_ext_header();
      if (st) return st;
    }
    pict_type = b.get1() ? P_VOP : I_VOP;
    if (pict_type == I_VOP) b.skip(7);
    const int q = (int)b.get(5);
    if (q == 0) return damaged("quantiser 0");
    set_qscale(q);
    tr_header = b.pos;
    if (pict_type == P_VOP && b.show(1)) {
      Bits g = b;
      const int skip_type = (int)g.get(2);
      int run = skip_type == SKIP_TYPE_COL ? mb_w : mb_h;
      while (run > 0) {
        const int n = std::min(run, 25);
        if (g.get(n) + 1 != (1u << n)) break;
        run -= n;
      }
      if (!run) return FRAME_SKIPPED;
    }
    return OK;
  }

  // parse_mb_skip: the P-frame's map of skipped macroblocks
  int wmv2_parse_mb_skip(Bits& b) {
    const int skip_type = (int)b.get(2);
    std::fill(mb_skip.begin(), mb_skip.end(), 0);
    if (skip_type != SKIP_TYPE_NONE) ++stats[ST_SKIP_MAPS];
    auto line = [&](int start, int step, int n) -> bool {  // one row or column: all skipped, or a bit each
      if (skip_type == SKIP_TYPE_MPEG || !b.get1()) {
        if (b.left() < n) return false;
        for (int i = 0; i < n; ++i) mb_skip[start + i * step] = (uint8_t)b.get1();
      } else {
        for (int i = 0; i < n; ++i) mb_skip[start + i * step] = 1;
      }
      return true;
    };
    if (skip_type == SKIP_TYPE_MPEG) {
      if (b.left() < mb_num) return damaged("a truncated skip map");
      line(0, 1, mb_num);
    } else if (skip_type == SKIP_TYPE_ROW) {
      for (int y = 0; y < mb_h; ++y)
        if (b.left() < 1 || !line(y * mb_w, 1, mb_w)) return damaged("a truncated skip map");
    } else if (skip_type == SKIP_TYPE_COL) {
      for (int x = 0; x < mb_w; ++x)
        if (b.left() < 1 || !line(x, mb_w, mb_h)) return damaged("a truncated skip map");
    }
    int coded = 0;
    for (int i = 0; i < mb_num; ++i) coded += !mb_skip[i];
    if (coded > b.left()) return damaged("fewer bits than coded macroblocks");
    return OK;
  }

  // ff_wmv2_decode_secondary_picture_header, once the picture's buffers exist
  int wmv2_secondary_header(Bits& b) {
    if (pict_type == I_VOP) {
      std::fill(mb_skip.begin(), mb_skip.end(), 0);
      if (j_type_bit && b.get1()) return refuse("IntraX8 J-frames (the alternative intra coding of intrax8.c)");
      per_mb_rl_table = per_mb_rl_bit && b.get1();
      if (!per_mb_rl_table) {
        rl_chroma_table_index = decode012(b);
        rl_table_index = decode012(b);
      }
      dc_table_index = b.get1();
      if (b.left() * 8 < (int64_t)mb_num) return damaged("a picture smaller than an eighth of a bit a macroblock");
      no_rounding = 1;
    } else {
      int st = wmv2_parse_mb_skip(b);
      if (st) return st;
      static const uint8_t map[3][3] = {{0, 2, 1}, {1, 0, 2}, {2, 1, 0}};  // wmv2_get_cbp_table_index
      cbp_table_index = map[(qscale > 10) + (qscale > 20)][decode012(b)];
      mspel = mspel_bit && b.get1();
      if (mspel) ++stats[ST_MSPEL_PICTURES];
      if (abt_flag) {
        per_mb_abt = !b.get1();
        if (!per_mb_abt) abt_type = decode012(b);
      }
      per_mb_rl_table = per_mb_rl_bit && b.get1();
      if (!per_mb_rl_table) rl_table_index = rl_chroma_table_index = decode012(b);
      if (b.left() < 2) return damaged("a truncated picture header");
      dc_table_index = b.get1();
      mv_table_index = b.get1();
      no_rounding ^= 1;
    }
    if (per_mb_rl_table) ++stats[ST_PER_MB_RL_PICTURES];
    inter_intra_pred = false;
    esc3_level_length = esc3_run_length = 0;
    return OK;
  }

  // ff_msmpeg4_decode_ext_header, after an I-frame's macroblocks (v2, v3)
  void msmpeg4_ext_header(Bits& b) {
    const int64_t left = b.left();
    const int length = kind == K_MSMP4V3 ? 17 : 16;
    if (left >= length && left < length + 8) {
      b.skip(5 + 11);  // frame rate, bit rate
      flipflop_rounding = kind == K_MSMP4V3 && b.get1();
    } else if (left < length + 8) {
      flipflop_rounding = false;
    }
  }

  // ---- blocks

  // get_dc: the mean of an 8 x 8 block of the picture being decoded, by ``scale``
  static int block_dc(const uint8_t* src, int stride, int scale) {
    int sum = 0;
    for (int y = 0; y < 8; ++y)
      for (int x = 0; x < 8; ++x) sum += src[(size_t)y * stride + x];
    return (sum + (scale >> 1)) / scale;
  }

  // ff_msmpeg4_pred_dc (v2, v3, WMV1, WMV2): the predictor from the scaled DCs
  // around, by the test MS-MPEG4 takes (the top one on a tie, where MPEG-4 and
  // WMV take the left); WMV1's inter-intra prediction takes the left or top
  // block's mean pixel for luma block 0 and chroma, in the coded direction
  int msmpeg4_pred_dc(int n) {
    const int scale = n < 4 ? y_dc_scale : c_dc_scale;
    int16_t* dc = dc_at(n);
    const int wr = wrap(n);
    int a = dc[-1], bb = dc[-1 - wr], c = dc[-wr];
    if (first_slice_line && !(n & 2) && kind < K_WMV1) bb = c = 1024;
    // FFmpeg's x86 build divides with imull by ff_inverse[scale] (2^32 / scale
    // rounded up) and keeps the high half: floor division, one less for a
    // negative multiple of a scale that is not a power of two
    const int32_t inv = (int32_t)(scale == 1 ? 4294967295u : (uint32_t)((((uint64_t)1 << 32) + scale - 1) / scale));
    auto div = [&](int x) { return (int)(((int64_t)(x + (scale >> 1)) * inv) >> 32); };
    a = div(a);
    bb = div(bb);
    c = div(c);
    if (kind >= K_WMV1) {
      if (inter_intra_pred && n != 3) {
        if (n == 1 || n == 2) {
          pred_dir = n == 2;
          return n == 2 ? c : a;
        }
        const int stride = n < 4 ? cur.ystride : cur.cstride;
        const uint8_t* dest = n < 4 ? cur.y.data() + (size_t)mb_y * 16 * stride + mb_x * 16
                                    : (n == 4 ? cur.u : cur.v).data() + (size_t)mb_y * 8 * stride + mb_x * 8;
        a = mb_x == 0 ? (1024 + (scale >> 1)) / scale : block_dc(dest - 8, stride, scale * 8);
        c = mb_y == 0 ? (1024 + (scale >> 1)) / scale : block_dc(dest - 8 * (size_t)stride, stride, scale * 8);
        // aic_dir 0: both left; 1: luma top, chroma left; 2: luma left, chroma top; 3: both top
        pred_dir = aic_dir == 3 || (aic_dir == 1 && n == 0) || (aic_dir == 2 && n != 0);
        return pred_dir ? c : a;
      }
      pred_dir = std::abs(a - bb) < std::abs(bb - c);
      return pred_dir ? c : a;
    }
    if (std::abs(a - bb) <= std::abs(bb - c)) {  // MPEG-4 takes the left one on a tie
      pred_dir = 1;
      return c;
    }
    pred_dir = 0;
    return a;
  }

  // msmpeg4_decode_dc; INT32_MIN for a bad code
  int msmpeg4_decode_dc(Bits& b, int n) {
    const H263Tables& t = h263_tables();
    int level;
    if (kind == K_MSMP4V2) {
      level = t.v2_dc[n >= 4].read(b);
      if (level < 0) return INT32_MIN;
      level -= 256;
    } else {
      level = t.dc[dc_table_index][n >= 4].read(b);
      if (level < 0) return INT32_MIN;
      if (level == 119) {  // DC_MAX: the magnitude in 8 bits
        level = (int)b.get(8);
        if (b.get1()) level = -level;
      } else if (level != 0 && b.get1()) {
        level = -level;
      }
    }
    level += msmpeg4_pred_dc(n);
    *dc_at(n) = (int16_t)(level * (n < 4 ? y_dc_scale : c_dc_scale));
    return level;
  }

  // ff_msmpeg4_decode_block (v2, v3, WMV1, WMV2): inter levels dequantised
  // here, intra ones in reconstruct; WMV's scans and escape 3; ``inter_scan``
  // replaces an inter block's (WMV2's ABT sub-blocks)
  int msmpeg4_decode_block(Bits& b, int16_t* blk, int n, bool coded, const uint8_t* inter_scan = nullptr) {
    const H263Tables& t = h263_tables();
    const bool wmv = kind >= K_WMV1;
    int i, qmul, qadd, run_diff;
    const RlTab* rl;
    const uint8_t* scan = inter_scan ? inter_scan : wmv ? wmv::kWmv1Scantable[0] : kZigzag;
    if (mb_intra) {
      qmul = 1;
      qadd = 0;
      int level = msmpeg4_decode_dc(b, n);
      if (level == INT32_MIN) return damaged("bad DC code");
      if (level < 0 && inter_intra_pred) level = 0;
      if (level > 256 * (n < 4 ? y_dc_scale : c_dc_scale) && !inter_intra_pred) return damaged("a DC out of range");
      blk[0] = (int16_t)level;
      rl = &t.rl[n < 4 ? rl_table_index : 3 + rl_chroma_table_index];
      run_diff = wmv;
      i = 0;
      if (wmv) scan = wmv::kWmv1Scantable[ac_pred ? (pred_dir == 0 ? 3 : 2) : 1];
      else if (ac_pred) scan = pred_dir == 0 ? kAltVertical : kAltHorizontal;
      if (!coded) {
        pred_ac(blk, n, pred_dir);
        last_index[n] = ac_pred ? 63 : 0;
        return OK;
      }
    } else {
      qmul = qscale << 1;
      qadd = (qscale - 1) | 1;
      i = -1;
      rl = &t.rl[3 + rl_table_index];
      run_diff = kind == K_MSMP4V2 ? 0 : 1;
      if (!coded) {
        last_index[n] = -1;
        return OK;
      }
    }
    while (true) {
      int sym = rl->vlc.read(b);
      if (sym < 0) return damaged("bad TCOEF code");
      int level, run, last;
      if (sym != rl->n) {
        last = rl->last[sym];
        level = rl->level[sym] * qmul + qadd;
        if (b.get1()) level = -level;
        i += rl->run[sym] + 1 + (last ? 192 : 0);
      } else {
        const int mode = (int)b.show(2);
        if (mode < 2) {  // '0': third escape
          if (!(mode & 1)) {
            ++stats[ST_ESCAPE3];
            b.skip(2);
            last = b.get1();
            if (!wmv) {
              run = (int)b.get(6);
              level = b.sget(8);
            } else {  // the level's and the run's lengths, read at the picture's first escape 3
              if (!esc3_level_length) {
                ++stats[ST_WMV_ESCAPE3_LENGTHS];
                int ll;
                if (qscale < 8) {
                  ll = (int)b.get(3);
                  if (ll == 0) ll = 8 + b.get1();
                } else {
                  ll = 2;
                  while (ll < 8 && b.show(1) == 0) {
                    ++ll;
                    b.skip(1);
                  }
                  if (ll < 8) b.skip(1);
                }
                esc3_level_length = ll;
                esc3_run_length = (int)b.get(2) + 3;
              }
              run = (int)b.get(esc3_run_length);
              const int sign = b.get1();
              level = (int)b.get(esc3_level_length);
              if (sign) level = -level;
            }
            level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
            i += run + 1 + (last ? 192 : 0);
          } else {  // '01': second escape, the run offset by the level's largest
            ++stats[ST_ESCAPE2];
            b.skip(2);
            sym = rl->vlc.read(b);
            if (sym < 0 || sym == rl->n) return damaged("bad TCOEF code after escape");
            last = rl->last[sym];
            const int lv = rl->level[sym];
            level = lv * qmul + qadd;
            i += rl->run[sym] + 1 + (last ? 192 : 0) + rl->max_run[last][lv] + run_diff;
            if (b.get1()) level = -level;
          }
        } else {  // '1': first escape, the level offset by the run's largest
          ++stats[ST_ESCAPE1];
          b.skip(1);
          sym = rl->vlc.read(b);
          if (sym < 0 || sym == rl->n) return damaged("bad TCOEF code after escape");
          last = rl->last[sym];
          level = rl->level[sym] * qmul + qadd + rl->max_level[last][rl->run[sym] & 63] * qmul;
          i += rl->run[sym] + 1 + (last ? 192 : 0);
          if (b.get1()) level = -level;
        }
      }
      if (i > 62) {
        i -= 192;
        if (i & ~63) {  // FFmpeg ignores the overflow and ends the block
          i = 63;
          break;
        }
        blk[scan[i]] = (int16_t)level;
        break;
      }
      blk[scan[i]] = (int16_t)level;
    }
    if (b.left() < 0) return damaged("truncated block");
    if (mb_intra) {
      pred_ac(blk, n, pred_dir);
      if (ac_pred) i = 63;
    }
    if (wmv && i > 0) i = 63;
    last_index[n] = i;
    return OK;
  }

  // h263_decode_block (no advanced intra coding): levels as coded, the
  // inter ones dequantised here (dct_unquantize_h263_inter), the intra ones
  // in reconstruct
  int h263_decode_block(Bits& b, int16_t* blk, int n, bool coded) {
    const RlTab& rl = h263_tables().rl[5];
    int i;
    if (mb_intra) {
      int level = (int)b.get(8);
      if ((level & 0x7F) == 0) return damaged("an illegal intra DC");
      if (level == 255) level = 128;
      blk[0] = (int16_t)level;
      i = 1;
    } else {
      i = 0;
    }
    if (!coded) {
      last_index[n] = i - 1;
      return OK;
    }
    const int qmul = qscale << 1, qadd = (qscale - 1) | 1;
    --i;
    while (true) {
      int sym = rl.vlc.read(b);
      if (sym < 0) return damaged("bad TCOEF code");
      int run, level;
      if (sym == rl.n) {  // escape
        if (flv > 1) {
          ++stats[ST_FLV_ESCAPE];
          const int is11 = b.get1();
          run = (int)b.get(7) + 1;
          level = b.sget(is11 ? 11 : 7);
        } else {
          ++stats[ST_ESCAPE3];
          run = (int)b.get(7) + 1;
          level = (int8_t)b.get(8);
          if (level == -128) {
            level = (int)b.get(5);
            level |= b.sget(6) * 32;
          }
        }
      } else {
        run = rl.run[sym] + 1 + (rl.last[sym] ? 192 : 0);
        level = rl.level[sym];
        if (b.get1()) level = -level;
      }
      i += run;
      bool last = false;
      if (i >= 64) {
        i = i - run + ((run - 1) & 63) + 1;
        if (i >= 64) return damaged("coefficients past the block");
        last = true;
      }
      if (!mb_intra && level) level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
      blk[kZigzag[i]] = (int16_t)level;
      if (last) break;
    }
    if (b.left() < 0) return damaged("truncated block");
    last_index[n] = i;
    return OK;
  }

  // ---- macroblocks

  void skip_mb() {
    ++stats[ST_SKIPPED_MB];
    mb_intra = false;
    for (int i = 0; i < 6; ++i) last_index[i] = -1;
    mvs[0][0][0] = mvs[0][0][1] = 0;
    mv_type = 0;
  }

  // ff_h263_decode_mb for I- and P-pictures without the optional annexes;
  // SLICE_END where the next 16 bits are zero (a GOB or picture start code)
  int h263_decode_mb(Bits& b) {
    const Tables& t = tables();
    int cbpc, cbp;
    for (int i = 0; i < 6; ++i) memset(block[i], 0, sizeof(block[i]));
    mv_type = 0;
    mv_dir = 1;
    ac_pred = false;
    bool skipped = false;
    mb_skip[mb_y * mb_w + mb_x] = 0;
    if (pict_type == P_VOP) {
      do {
        if (b.get1()) {
          skip_mb();
          skipped = true;
          mb_skip[mb_y * mb_w + mb_x] = 1;
          break;
        }
        cbpc = t.inter_mcbpc.read(b);
        if (cbpc < 0) return damaged("bad MCBPC code");
      } while (cbpc == 20);
      if (!skipped) {
        mb_intra = (cbpc & 4) != 0;
        if (!mb_intra) {
          int cbpy = t.cbpy.read(b);
          if (cbpy < 0) return damaged("bad CBPY code");
          cbp = (cbpc & 3) | ((cbpy ^ 0xF) << 2);
          if (cbpc & 8) {
            ++stats[ST_DQUANT];
            set_qscale(qscale + kDquant[b.get(2)]);
          }
          // four vectors, which FFmpeg's encoders write with +mv4 and no OBMC
          const int nmv = cbpc & 16 ? 4 : 1;
          if (nmv == 4) {
            ++stats[ST_FOUR_MV_MB];
            mv_type = 1;
          }
          for (int i = 0; i < nmv; ++i) {
            int px, py;
            int16_t* mvp = pred_motion(i, &px, &py);
            int mx = decode_motion(b, px, 1);
            if (mx == INT32_MIN) return damaged("bad motion vector code");
            int my = decode_motion(b, py, 1);
            if (my == INT32_MIN) return damaged("bad motion vector code");
            mvs[0][i][0] = mx;
            mvs[0][i][1] = my;
            if (nmv == 4) {
              mvp[0] = (int16_t)mx;
              mvp[1] = (int16_t)my;
            }
          }
          for (int i = 0; i < 6; ++i) {
            int st = h263_decode_block(b, block[i], i, (cbp & 32) != 0);
            if (st) return st;
            cbp += cbp;
          }
        } else {
          ++stats[ST_INTRA_MB_IN_P];
        }
      }
    } else {
      do {
        cbpc = t.intra_mcbpc.read(b);
        if (cbpc < 0) return damaged("bad MCBPC code");
      } while (cbpc == 8);
      mb_intra = true;
    }
    if (!skipped && mb_intra) {
      int cbpy = t.cbpy.read(b);
      if (cbpy < 0) return damaged("bad CBPY code");
      cbp = (cbpc & 3) | (cbpy << 2);
      if (pict_type == P_VOP ? (cbpc & 8) : (cbpc & 4)) {
        ++stats[ST_DQUANT];
        set_qscale(qscale + kDquant[b.get(2)]);
      }
      for (int i = 0; i < 6; ++i) {
        int st = h263_decode_block(b, block[i], i, (cbp & 32) != 0);
        if (st) return st;
        cbp += cbp;
      }
    }
    if (b.left() < 0) return damaged("the data ends inside a macroblock");
    int64_t left = b.left();
    uint32_t v = b.show(16);
    if (left < 16) v >>= 16 - left;
    return v == 0 ? SLICE_END : OK;
  }

  // msmpeg4v2_decode_motion: H.263's vector code, wrapped into -63..63
  int v2_decode_motion(Bits& b, int pred) {
    int code = tables().mv.read(b);
    if (code < 0) return INT32_MIN;
    if (code == 0) return pred;
    int val = b.get1() ? -code : code;
    val += pred;
    if (val <= -64) val += 64;
    else if (val >= 64) val -= 64;
    return val;
  }

  // ff_msmpeg4_decode_motion (v3)
  int v3_decode_motion(Bits& b, int* mx, int* my) {
    const int sym = h263_tables().mv[mv_table_index].read(b);
    if (sym < 0) return damaged("bad motion vector code");
    int x, y;
    if (sym) {
      x = sym >> 8;
      y = sym & 0xFF;
    } else {
      ++stats[ST_MV_ESCAPE];
      x = (int)b.get(6);
      y = (int)b.get(6);
    }
    x += *mx - 32;
    y += *my - 32;
    if (x <= -64) x += 64;
    else if (x >= 64) x -= 64;
    if (y <= -64) y += 64;
    else if (y >= 64) y -= 64;
    *mx = x;
    *my = y;
    return OK;
  }

  uint8_t* coded_at(int n) { return &coded_block[(size_t)(2 * mb_y + (n >> 1) + 1) * bw + 2 * mb_x + (n & 1) + 1]; }

  // an I-frame macroblock's cbp from its code, the luma bits predicted from
  // the coded flags around (ff_msmpeg4_coded_block_pred)
  int intra_cbp(int code) {
    int cbp = 0;
    for (int i = 0; i < 6; ++i) {
      int val = (code >> (5 - i)) & 1;
      if (i < 4) {
        uint8_t* cb = coded_at(i);
        const int a = cb[-1], bb = cb[-1 - bw], c = cb[-bw];
        val ^= bb == c ? a : c;
        *cb = (uint8_t)val;
      }
      cbp |= val << (5 - i);
    }
    return cbp;
  }

  // decode012 of a macroblock's own run-level table (per_mb_rl_table)
  void mb_rl_table(Bits& b, int cbp) {
    tr_rl = b.pos;
    if (per_mb_rl_table && cbp) rl_table_index = rl_chroma_table_index = decode012(b);
  }

  // msmpeg4v12_decode_mb (v2) and msmpeg4v34_decode_mb (v3, WMV1)
  int msmpeg4_decode_mb(Bits& b) {
    const Tables& t = tables();
    const H263Tables& ht = h263_tables();
    for (int i = 0; i < 6; ++i) memset(block[i], 0, sizeof(block[i]));
    mv_type = 0;
    mv_dir = 1;
    ac_pred = false;
    if (b.left() <= 0) return damaged("the data ends before the picture does");
    int cbp = 0;
    if (pict_type == P_VOP) {
      if (use_skip_mb_code && b.get1()) {
        skip_mb();
        return OK;
      }
      int code;
      if (kind == K_MSMP4V2) {
        code = ht.v2_mb_type.read(b);
        if (code < 0 || code > 7) return damaged("bad macroblock type code");
        mb_intra = code >> 2;
        cbp = code & 3;
      } else {
        code = ht.mb_non_intra.read(b);
        if (code < 0) return damaged("bad macroblock type code");
        mb_intra = !(code & 0x40);
        cbp = code & 0x3F;
      }
      tr_sym = code;
    } else {
      mb_intra = true;
      if (kind == K_MSMP4V2) {
        cbp = ht.v2_intra_cbpc.read(b);
        if (cbp < 0) return damaged("bad intra CBPC code");
      } else {
        const int code = ht.mb_i.read(b);
        if (code < 0) return damaged("bad intra macroblock code");
        tr_sym = code;
        cbp = intra_cbp(code);
      }
    }
    if (!mb_intra) {
      if (kind == K_MSMP4V2) {
        int cbpy = t.cbpy.read(b);
        if (cbpy < 0) return damaged("bad CBPY code");
        cbp |= cbpy << 2;
        if ((cbp & 3) != 3) cbp ^= 0x3C;
      }
      int px, py;
      pred_motion(0, &px, &py);
      if (kind == K_MSMP4V2) {
        px = v2_decode_motion(b, px);
        if (px == INT32_MIN) return damaged("bad motion vector code");
        py = v2_decode_motion(b, py);
        if (py == INT32_MIN) return damaged("bad motion vector code");
      } else {
        tr_code = b.pos;
        mb_rl_table(b, cbp);
        int st = v3_decode_motion(b, &px, &py);
        if (st) return st;
        tr_mv = b.pos;
      }
      mvs[0][0][0] = px;
      mvs[0][0][1] = py;
    } else {
      if (pict_type == P_VOP) ++stats[ST_INTRA_MB_IN_P];
      if (kind == K_MSMP4V2) {
        ac_pred = b.get1();
        const int cbpy = t.cbpy.read(b);
        if (cbpy < 0) return damaged("bad CBPY code");
        cbp |= cbpy << 2;
      } else {
        tr_code = b.pos;
        ac_pred = b.get1();
        if (inter_intra_pred) {
          ++stats[ST_INTER_INTRA_MB];
          aic_dir = ht.inter_intra.read(b);
        }
        mb_rl_table(b, cbp);
      }
      if (ac_pred) ++stats[ST_AC_PRED_MB];
    }
    tr_cbp = cbp;
    for (int i = 0; i < 6; ++i) {
      int st = msmpeg4_decode_block(b, block[i], i, (cbp >> (5 - i)) & 1);
      if (st) return st;
    }
    return OK;
  }

  // wmv2_decode_mb: MS-MPEG4's intra coding; a P-frame's macroblocks skipped
  // by the picture's skip map, their VLC picked by the CBP table index, the
  // vector predicted as wmv2_pred_motion predicts it (the median, the left
  // vector on a slice's first row, or under top_left_mv_flag the left or top
  // one as a bit says where they differ by 8 or more) and hshift after an odd
  // vector of an mspel picture
  int wmv2_decode_mb(Bits& b) {
    const H263Tables& ht = h263_tables();
    for (int i = 0; i < 6; ++i) memset(block[i], 0, sizeof(block[i]));
    mv_type = 0;
    mv_dir = 1;
    ac_pred = false;
    int cbp = 0;
    if (pict_type == P_VOP) {
      if (mb_skip[mb_y * mb_w + mb_x]) {
        skip_mb();
        hshift = 0;
        return OK;
      }
      if (b.left() <= 0) return damaged("the data ends before the picture does");
      const int code = (cbp_table_index == 3 ? ht.mb_non_intra : ht.wmv2_inter[cbp_table_index]).read(b);
      if (code < 0) return damaged("bad macroblock type code");
      tr_sym = code;
      mb_intra = !(code & 0x40);
      cbp = code & 0x3F;
    } else {
      mb_intra = true;
      if (b.left() <= 0) return damaged("the data ends before the picture does");
      const int code = ht.mb_i.read(b);
      if (code < 0) return damaged("bad intra macroblock code");
      tr_sym = code;
      cbp = intra_cbp(code);
    }
    if (!mb_intra) {
      const int16_t* mvp = mv_at(0);
      const int16_t *A = mvp - 2, *B = mvp - 2 * bw, *C = mvp + 4 - 2 * bw;
      tr_code = b.pos;
      const int diff = mb_x && !first_slice_line && !mspel && top_left_mv_flag
                           ? std::max(std::abs(A[0] - B[0]), std::abs(A[1] - B[1])) : 0;
      const int type = diff >= 8 ? b.get1() : 2;
      if (type < 2) ++stats[ST_TOP_LEFT_MV];
      int px = type == 1 ? B[0] : A[0], py = type == 1 ? B[1] : A[1];
      if (type == 2 && !first_slice_line) {
        px = mid_pred(A[0], B[0], C[0]);
        py = mid_pred(A[1], B[1], C[1]);
      }
      mb_rl_table(b, cbp);
      if (cbp) {
        per_block_abt = abt_flag && per_mb_abt && b.get1();
        if (abt_flag && per_mb_abt && !per_block_abt) abt_type = decode012(b);
      }
      int st = v3_decode_motion(b, &px, &py);
      if (st) return st;
      tr_mv = b.pos;
      hshift = ((px | py) & 1) && mspel ? b.get1() : 0;
      if (hshift) ++stats[ST_HSHIFT_MB];
      mvs[0][0][0] = px;
      mvs[0][0][1] = py;
    } else {
      if (pict_type == P_VOP) ++stats[ST_INTRA_MB_IN_P];
      tr_code = b.pos;
      ac_pred = b.get1();
      if (ac_pred) ++stats[ST_AC_PRED_MB];
      mb_rl_table(b, cbp);
    }
    tr_cbp = cbp;
    for (int i = 0; i < 6; ++i) {
      tr_blocks[i][0] = b.pos;
      const bool esc3_unset = !esc3_level_length;
      int st = mb_intra ? msmpeg4_decode_block(b, block[i], i, (cbp >> (5 - i)) & 1)
                        : wmv2_inter_block(b, i, (cbp >> (5 - i)) & 1);
      if (st) return st;
      tr_blocks[i][1] = b.pos;
      if (esc3_unset && esc3_level_length) tr_esc3_block = i;
    }
    return OK;
  }

  // wmv2_decode_inter_block: an 8x8 block, or under ABT two 8x4 or 4x8
  // sub-blocks (ff_wmv2_scantableA/B), either or both coded
  int wmv2_inter_block(Bits& b, int n, bool coded) {
    if (!coded) {
      last_index[n] = -1;
      return OK;
    }
    if (per_block_abt) abt_type = decode012(b);
    abt_type_table[n] = abt_type;
    if (!abt_type) return msmpeg4_decode_block(b, block[n], n, true);
    ++stats[ST_ABT_BLOCK];
    static const int sub_cbp_table[3] = {2, 3, 1};
    const int sub_cbp = sub_cbp_table[decode012(b)];
    const uint8_t* scan = abt_type == 1 ? wmv::kWmv2ScantableA : wmv::kWmv2ScantableB;
    if (sub_cbp & 1) {
      const int st = msmpeg4_decode_block(b, block[n], n, true, scan);
      if (st) return st;
    }
    if (sub_cbp & 2) {
      const int st = msmpeg4_decode_block(b, abt_block2[n], n, true, scan);
      if (st) return st;
    }
    last_index[n] = 63;
    return OK;
  }

  // ---- the deblocking filter (h263dsp.c, h263.c ff_h263_loop_filter)

  // h263_{v,h}_loop_filter_c: 8 samples along an edge, ``across`` the step
  // over it and ``along`` the step beside it (the x86 build's MMX versions
  // give the same samples)
  static void filter_edge(uint8_t* src, int across, int along, int qscale) {
    const int strength = wmv::kLoopFilterStrength[qscale];
    for (int k = 0; k < 8; ++k) {
      uint8_t* q = src + k * along;
      const int p0 = q[-2 * across], p3 = q[across];
      int p1 = q[-across], p2 = q[0];
      const int d = (p0 - p3 + 4 * (p2 - p1)) / 8;
      int d1;
      if (d < -2 * strength) d1 = 0;
      else if (d < -strength) d1 = -2 * strength - d;
      else if (d < strength) d1 = d;
      else if (d < 2 * strength) d1 = 2 * strength - d;
      else d1 = 0;
      p1 += d1;
      p2 -= d1;
      if (p1 & 256) p1 = ~(p1 >> 31);
      if (p2 & 256) p2 = ~(p2 >> 31);
      q[-across] = (uint8_t)p1;
      q[0] = (uint8_t)p2;
      const int ad1 = std::abs(d1) >> 1;
      const int d2 = std::max(-ad1, std::min((p0 - p3) / 4, ad1));
      q[-2 * across] = (uint8_t)(p0 - d2);
      q[across] = (uint8_t)(p3 + d2);
    }
  }
  void v_filter(uint8_t* src, int stride, int q) { filter_edge(src, stride, 1, q); }  // the edge above src
  void h_filter(uint8_t* src, int stride, int q) { filter_edge(src, 1, stride, q); }  // the edge left of src

  // ff_h263_loop_filter after each macroblock: its inner edges and those it
  // shares with the macroblocks above, above-left and left, at the quantiser
  // of the one that is coded (not skipped); the chroma quantiser is the luma's
  void loop_filter_mb() {
    ++stats[ST_LOOP_FILTERED_MB];
    const int ls = cur.ystride, cs = cur.cstride, xy = mb_y * mb_w + mb_x;
    uint8_t* dy = cur.y.data() + (size_t)mb_y * 16 * ls + mb_x * 16;
    uint8_t* du = cur.u.data() + (size_t)mb_y * 8 * cs + mb_x * 8;
    uint8_t* dv = cur.v.data() + (size_t)mb_y * 8 * cs + mb_x * 8;
    int qp_c = 0;
    if (!mb_skip[xy]) {
      qp_c = qscale;
      v_filter(dy + 8 * ls, ls, qp_c);
      v_filter(dy + 8 * ls + 8, ls, qp_c);
    }
    if (mb_y) {
      const int qp_tt = mb_skip[xy - mb_w] ? 0 : qs_at(mb_x, mb_y - 1);
      const int qp_tc = qp_c ? qp_c : qp_tt;
      if (qp_tc) {
        v_filter(dy, ls, qp_tc);
        v_filter(dy + 8, ls, qp_tc);
        v_filter(du, cs, qp_tc);
        v_filter(dv, cs, qp_tc);
      }
      if (qp_tt) h_filter(dy - 8 * ls + 8, ls, qp_tt);
      if (mb_x) {
        const int qp_dt = qp_tt || mb_skip[xy - 1 - mb_w] ? qp_tt : qs_at(mb_x - 1, mb_y - 1);
        if (qp_dt) {
          h_filter(dy - 8 * ls, ls, qp_dt);
          h_filter(du - 8 * cs, cs, qp_dt);
          h_filter(dv - 8 * cs, cs, qp_dt);
        }
      }
    }
    if (qp_c) {
      h_filter(dy + 8, ls, qp_c);
      if (mb_y + 1 == mb_h) h_filter(dy + 8 * ls + 8, ls, qp_c);
    }
    if (mb_x) {
      const int qp_lc = qp_c || mb_skip[xy - 1] ? qp_c : qs_at(mb_x - 1, mb_y);
      if (qp_lc) {
        h_filter(dy, ls, qp_lc);
        if (mb_y + 1 == mb_h) {
          h_filter(dy + 8 * ls, ls, qp_lc);
          h_filter(du, cs, qp_lc);
          h_filter(dv, cs, qp_lc);
        }
      }
    }
  }

  // ---- slices and pictures

  // h263_decode_gob_header, after a SLICE_END; false where none follows
  bool gob_header(Bits& b) {
    if (b.show(16)) return false;
    b.skip(16);
    int64_t left = std::min<int64_t>(b.left(), 32);
    for (; left > 13; --left)
      if (b.get1()) break;
    if (left <= 13) return false;
    const int gob = (int)b.get(5);
    mb_x = 0;
    mb_y = gob_height * gob;
    b.skip(2);  // GFID
    const int q = (int)b.get(5);
    if (mb_y >= mb_h || q == 0) return false;
    set_qscale(q);
    ++stats[ST_GOB_HEADERS];
    return true;
  }

  // ff_h263_resync for H.263: the GOB header here, else the next one at a
  // byte boundary after the slice's start
  int h263_resync(Bits& b, const Bits& slice_start) {
    if (b.show(16) == 0) {
      Bits g = b;
      if (gob_header(g)) {
        b = g;
        return OK;
      }
    }
    b = slice_start;
    b.align();
    for (int64_t left = b.left(); left > 16 + 1 + 5 + 5; left -= 8) {
      if (b.show(16) == 0) {
        Bits g = b;
        if (gob_header(g)) {
          b = g;
          return OK;
        }
      }
      b.skip(8);
    }
    return damaged("the data ends before the picture does");
  }

  Bits slice_start;  // FFmpeg's last_resync_gb

  // decode_slice: from (mb_x, mb_y) to a SLICE_END (H.263 and FLV), the end
  // of an MS-MPEG4 slice (slice_height rows) or of the picture
  int decode_slice(Bits& b) {
    slice_start = b;
    first_slice_line = true;
    resync_mb_x = mb_x;
    resync_mb_y = mb_y;
    set_qscale(qscale);
    for (; mb_y < mb_h; ++mb_y) {
      if (kind >= K_MSMP4V2 && resync_mb_y + slice_height == mb_y) return OK;
      for (; mb_x < mb_w; ++mb_x) {
        if (resync_mb_x == mb_x && resync_mb_y + 1 == mb_y) first_slice_line = false;
        qscale_at_mb_start = qscale;
        const int64_t tr_start = b.pos;
        tr_code = tr_rl = tr_mv = -1;
        tr_cbp = tr_sym = 0;
        tr_esc3_block = -1;
        for (auto& blk : tr_blocks) blk[0] = blk[1] = -1;
        int st = kind == K_WMV2 ? wmv2_decode_mb(b) : kind >= K_MSMP4V2 ? msmpeg4_decode_mb(b) : h263_decode_mb(b);
        if (tracing && st == OK) {
          const int64_t row[TRACE_WIDTH] = {mb_y * mb_w + mb_x, mb_intra, tr_code < 0, tr_cbp, tr_sym, tr_start,
                                            tr_code, tr_rl, tr_mv, mvs[0][0][0], mvs[0][0][1],
                                            tr_blocks[0][0], tr_blocks[0][1], tr_blocks[1][0], tr_blocks[1][1],
                                            tr_blocks[2][0], tr_blocks[2][1], tr_blocks[3][0], tr_blocks[3][1],
                                            tr_blocks[4][0], tr_blocks[4][1], tr_blocks[5][0], tr_blocks[5][1],
                                            tr_esc3_block};
          trace.insert(trace.end(), row, row + TRACE_WIDTH);
        }
        update_motion_val();
        if (st != OK && st != SLICE_END) return st;
        reconstruct();
        if (loop_filter) loop_filter_mb();
        if (st == SLICE_END) {
          if (++mb_x >= mb_w) {
            mb_x = 0;
            ++mb_y;
          }
          return SLICE_END;
        }
      }
      mb_x = 0;
    }
    return OK;
  }

  int decode(const uint8_t* data, long n, Frame& out) {
    Bits b;
    b.init(data, n);
    int st;
    droppable = false;
    if (kind == K_FLV) {
      st = flv_picture_header(b);
    } else if (kind == K_H263) {
      st = h263_picture_header(b);
    } else {
      if (!have_vol) return damaged("no frame size from the container");
      st = kind == K_WMV2 ? wmv2_picture_header(b) : msmpeg4_picture_header(b);
    }
    if (st == FRAME_SKIPPED) {  // WMV2: every macroblock skipped, no frame
      ++stats[ST_SKIPPED_PICTURES];
      return NO_FRAME;
    }
    if (st) return st;
    if (pict_type == P_VOP && !have_future) return damaged("a P-frame without a reference frame");
    ++stats[pict_type == I_VOP ? ST_I_VOP : ST_P_VOP];
    if (tracing) {
      const int64_t row[TRACE_WIDTH] = {-1, pictures, pict_type, tr_header};
      trace.insert(trace.end(), row, row + TRACE_WIDTH);
    }
    ++pictures;
    cur.alloc(width, height, mb_w * 16, mb_h * 16, mb_w * 8, mb_h * 8, 1);
    if (kind == K_WMV2) {
      st = wmv2_secondary_header(b);
      if (st) return st;
    }
    mb_x = mb_y = 0;
    memset(last_mv, 0, sizeof(last_mv));
    st = decode_slice(b);
    while (mb_y < mb_h) {
      if (st != OK && st != SLICE_END) return st;
      if (kind >= K_MSMP4V2) {
        if (slice_height <= 0 || mb_x != 0 || mb_y % slice_height != 0 || b.left() < 0) break;
        ++stats[ST_PACKETS];
        if (kind < K_WMV1) clean_buffers();  // h263dec.c: ff_mpeg4_clean_buffers below WMV1 only
      } else {
        st = h263_resync(b, slice_start);
        if (st) return st;
      }
      st = decode_slice(b);
    }
    if (st != OK && st != SLICE_END) return st;
    if (mb_y < mb_h) return damaged("the data ends before the picture does");
    if ((kind == K_MSMP4V2 || kind == K_MSMP4V3) && pict_type == I_VOP) msmpeg4_ext_header(b);
    cur.full_range = false;
    out = cur;
    if (!droppable) {
      std::swap(future, cur);
      have_future = true;
    }
    return FRAME;
  }
};

// ---- VP8 (vp8.h, as FFmpeg's vp8.c decodes a stream) ------------------------

struct Vp8 {
  vp8::Decoder dec;
  int decode(const uint8_t* data, long n, Frame& out, std::string& msg) {
    int st = dec.decode(data, (size_t)n);
    if (st) {
      static const char* what[] = {"", "the frame ends early", "", "", "", "", "a bad frame header", "",
                                   "bad token partitions", "", "a frame size of 0 or above 8192",
                                   "an inter frame before any key frame"};
      msg = std::string("VP8: ") + (st > 0 && st < 12 ? what[st] : "damaged data");
      return DAMAGED;
    }
    if (!dec.show) return NO_FRAME;  // invisible frames update the references only, as in FFmpeg
    const vp8::Picture& p = *dec.cur;
    out.width = p.width;
    out.height = p.height;
    out.ystride = p.ys;
    out.cstride = p.uvs;
    out.cshift_y = 1;
    out.full_range = false;
    out.y = p.Y;
    out.u = p.U;
    out.v = p.V;
    return FRAME;
  }
};

// ---- VP9 (vp9.h, as FFmpeg's vp9 decoder decodes a stream) ------------------

struct Vp9 {
  vp9::Decoder dec;
  std::vector<vp9::PicPtr> queue;  // the frames a packet shows, in order
  size_t next = 0;
  int pending = 0;  // an error met after a frame of the same packet was shown
  std::string pending_msg;

  static void put(const vp9::Picture& p, Frame& out) {
    out.width = p.width;
    out.height = p.height;
    out.ystride = p.stride[0];
    out.cstride = p.stride[1];
    out.cshift_y = 1;
    out.full_range = p.full_range;
    out.y = p.plane[0];
    out.u = p.plane[1];
    out.v = p.plane[2];
  }

  // Decode every frame of a packet; FRAME if it shows one (the first is put
  // in ``out``, the others wait for `take`), NO_FRAME if none. An error after
  // a shown frame is held back until the next packet, as FFmpeg's capture
  // returns the frames decoded before it.
  int decode(const uint8_t* data, long n, Frame& out, std::string& msg) {
    queue.clear();
    next = 0;
    if (pending) {
      int st = pending;
      pending = 0;
      msg = pending_msg;
      return st;
    }
    std::vector<std::pair<size_t, size_t>> frames;
    if (!vp9::split_superframe(data, (size_t)n, frames)) {
      msg = "VP9: a superframe index whose sizes overrun the packet";
      return DAMAGED;
    }
    if (frames.size() > 1) dec.stats[vp9::ST_SUPERFRAMES]++;
    const uint8_t* mem_end = data + n;
    for (auto& f : frames) {
      vp9::PicPtr shown;
      int st = dec.decode_frame(data + f.first, f.second, mem_end, shown);
      if (st) {
        int code = st == vp9::kUnsupported ? NOT_IMPLEMENTED : DAMAGED;
        if (queue.empty()) {
          msg = dec.msg;
          return code;
        }
        pending = code;
        pending_msg = dec.msg;
        break;
      }
      if (shown) queue.push_back(shown);
    }
    return take(out);
  }

  int take(Frame& out) {
    if (next >= queue.size()) return NO_FRAME;
    put(*queue[next++], out);
    return FRAME;
  }
};

struct Handle {
  int codec;
  int open_status = 0;
  Mjpeg mjpeg;
  Mpeg4 mpeg4;
  H263 h263;
  Vp8 vp8;
  Vp9 vp9;
  Frame frame;
  bool have_frame = false;
  int first_w = 0, first_h = 0;  // the size of the first frame converted
  std::string msg;
};

}  // namespace vid

extern "C" {

// codec: 1 Motion-JPEG, 2 MPEG-4 Part 2, 3 VP8, 4 VP9, 5 H.263 (and H.263+), 6 Sorenson
// H.263, 7 MS-MPEG4 v2, 8 MS-MPEG4 v3, 9 WMV1, 10 WMV2; ``priv``: the decoder
// configuration (MPEG-4's VOS/VOL headers, WMV2's ext header) or empty;
// ``tag``: the container's fourcc
void* vdec_open(int codec, const uint8_t* priv, long n, uint32_t tag) {
  vid::Handle* h = new vid::Handle();
  h->codec = codec;
  h->mpeg4.tag = tag;
  if (codec >= 5) h->h263.open(codec - 5);
  if (codec == 10) h->h263.extradata.assign(priv, priv + n);  // WMV2's ext header
  if (codec == 2 && n > 0) {
    vid::Bits b;
    b.init(priv, n);
    int st = h->mpeg4.decode_headers(b);
    if (st != vid::NO_FRAME && st != OK) {
      h->open_status = st;
      h->msg = h->mpeg4.msg;
    }
  }
  return h;
}

// Decode one packet: 0 a frame is ready (vdec_size, vdec_rgb), 1 no frame
// (headers only, a VOP that is not coded, an invisible VP8 or VP9 frame, or a
// reference held back until the next one for display order), 2 a tool or
// format refused, 3 damaged data; vdec_error gives the message of 2 and 3.
// A VP9 packet may show more than one frame: vdec_next gives the others.
int vdec_send(void* hp, const uint8_t* data, long n) {
  vid::Handle* h = (vid::Handle*)hp;
  if (h->open_status) return h->open_status;
  int st;
  if (h->codec == 1) {
    st = h->mjpeg.decode(data, n, h->frame, h->msg);
  } else if (h->codec == 3) {
    st = h->vp8.decode(data, n, h->frame, h->msg);
  } else if (h->codec == 4) {
    st = h->vp9.decode(data, n, h->frame, h->msg);
  } else if (h->codec >= 5) {
    st = h->h263.decode(data, n, h->frame);
    if (st >= vid::NOT_IMPLEMENTED) h->msg = h->h263.msg;
  } else {
    st = h->mpeg4.decode(data, n, h->frame);
    if (st >= vid::NOT_IMPLEMENTED) h->msg = h->mpeg4.msg;
  }
  if (st == vid::FRAME) h->have_frame = true;
  return st;
}

int vdec_size(void* hp, int* height, int* width) {
  vid::Handle* h = (vid::Handle*)hp;
  *height = h->have_frame ? h->frame.height : 0;
  *width = h->have_frame ? h->frame.width : 0;
  return 0;
}

// the last frame as RGB, height * width * 3 bytes
int vdec_rgb(void* hp, uint8_t* out) {
  vid::Handle* h = (vid::Handle*)hp;
  if (!h->have_frame) return vid::DAMAGED;
  if (!h->first_w) {
    h->first_w = h->frame.width;
    h->first_h = h->frame.height;
  }
  if (h->frame.width != h->first_w || h->frame.height != h->first_h) {  // OpenCV scales it to the first size
    char buf[200];
    snprintf(buf, sizeof(buf),
             "a %dx%d frame after %dx%d ones: OpenCV scales a frame whose size changed with libswscale's scaled "
             "path",
             h->frame.width, h->frame.height, h->first_w, h->first_h);
    h->msg = buf;
    return vid::NOT_IMPLEMENTED;
  }
  if ((h->frame.width | h->frame.height) & 1) {  // libswscale takes its scaled path for these
    char buf[160];
    snprintf(buf, sizeof(buf), "a %dx%d frame: odd frame sizes leave libswscale's unscaled YUV->RGB path",
             h->frame.width, h->frame.height);
    h->msg = buf;
    return vid::NOT_IMPLEMENTED;
  }
  vid::to_rgb(h->frame, out);
  return 0;
}

// The next frame the last packet shows (a VP9 superframe or a frame followed
// by show_existing_frame): 0 it is ready, 1 there is none.
int vdec_next(void* hp) {
  vid::Handle* h = (vid::Handle*)hp;
  if (h->codec != 4 || h->open_status) return vid::NO_FRAME;
  return h->vp9.take(h->frame);
}

// The end of the stream: 0 a frame held back for display order is ready, 1 none.
int vdec_flush(void* hp) {
  vid::Handle* h = (vid::Handle*)hp;
  if (h->codec != 2 || h->open_status) return vid::NO_FRAME;
  int st = h->mpeg4.flush(h->frame);
  if (st == vid::FRAME) h->have_frame = true;
  return st;
}

const char* vdec_error(void* hp, int) { return ((vid::Handle*)hp)->msg.c_str(); }

// the decoder's counts of coding tools met so far (MPEG-4: vid::Stat order,
// VP9: vp9::Stat order), for tests
int vdec_stats(void* hp, int64_t* out) {
  vid::Handle* h = (vid::Handle*)hp;
  if (h->codec == 4) {
    for (int i = 0; i < vp9::ST_COUNT; ++i) out[i] = h->vp9.dec.stats[i];
    return vp9::ST_COUNT;
  }
  const int64_t* stats = h->codec >= 5 ? h->h263.stats : h->mpeg4.stats;
  for (int i = 0; i < vid::ST_COUNT; ++i) out[i] = stats[i];
  return vid::ST_COUNT;
}

// MS-MPEG4 and WMV, for tests: with ``out`` null, start recording where each
// picture and macroblock lies (H263::trace); else copy up to ``cap`` values of
// the record and return its length.
long vdec_trace(void* hp, int64_t* out, long cap) {
  vid::H263& d = ((vid::Handle*)hp)->h263;
  if (!out) {
    d.tracing = true;
    return 0;
  }
  const long n = (long)d.trace.size();
  std::copy(d.trace.begin(), d.trace.begin() + std::min(n, cap), out);
  return n;
}

// The picture size a container gives (MS-MPEG4 carries none in its bitstream).
void vdec_set_size(void* hp, int width, int height) {
  vid::Handle* h = (vid::Handle*)hp;
  if (h->codec >= 7 && width > 0 && height > 0 && width <= 8192 && height <= 8192) h->h263.resize(width, height);
}

void vdec_close(void* hp) { delete (vid::Handle*)hp; }

}  // extern "C"
