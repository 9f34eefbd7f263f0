// Video decoding on the host: Motion-JPEG and MPEG-4 Part 2 Simple Profile
// packets into planar YUV, and YUV into RGB as OpenCV's FFmpeg capture
// converts it. Called through ctypes from video.py, which demuxes the file.
//
// OpenCV 5.0 decodes with FFmpeg's libavcodec and converts each frame to
// BGR24 with libswscale (sws_scale at the same size, SWS_BICUBIC). This file
// follows FFmpeg's arithmetic, so the pixels equal OpenCV's:
//   * FFmpeg's 8-bit simple IDCT (libavcodec/simple_idct_template.c:
//     idctRowCondDC with its DC-only shortcut, idctSparseColPut/Add; W1..W7,
//     ROW_SHIFT 11, COL_SHIFT 20). FFmpeg's x86 build selects
//     ff_simple_idct8_sse2 instead; on the fixtures its output equals the C
//     version's, so the C version is the one written here.
//   * Motion-JPEG (mjpegdec.c): the entropy decoding is the JPEG reader's
//     (imread.cpp, included below); each block is then dequantised as FFmpeg
//     does (DC predicted in the dequantised domain from 1024, clipped to int16)
//     and put through the simple IDCT into planes at their own subsampling,
//     with no upsampling (FFmpeg's yuvj420p/yuvj422p). A frame without DHT
//     segments takes Annex K's tables (init_default_huffman_tables).
//   * MPEG-4 Part 2 Simple Profile (ISO/IEC 14496-2; mpeg4videodec.c,
//     h263dec.c, mpegvideo_motion.c): VOS/VO/VOL headers from the decoder
//     configuration or in band, GOV and user data headers, I- and P-VOPs,
//     not coded VOPs (no frame, as FFmpeg outputs none), MCBPC/CBPY/MVD/TCOEF
//     VLCs with the three escape modes, intra DC VLC below intra_dc_vlc_thr,
//     DC and AC prediction with AC rescaling across quantisers, H.263 inverse
//     quantisation, DQUANT, not coded macroblocks, 1 and 4 motion vectors
//     with median prediction, half-pel motion compensation with
//     vop_rounding_type, unrestricted vectors (edge samples repeated), and
//     resync markers (video packets). Data partitioning, RVLC, interlace,
//     quarter-pel, GMC/sprites, B-VOPs, MPEG quantisation matrices,
//     short_video_header, non-8-bit video, shapes other than rectangular,
//     newpred, reduced-resolution VOPs, scalability and complexity estimation
//     are refused with a message that names them, as are streams from the
//     Xvid and DivX encoders, which FFmpeg decodes with their own IDCT and
//     bug workarounds.
//   * YUV -> BGR24 (libswscale's unscaled yuv2rgb path for 4:2:0 and 4:2:2
//     frames of even width and height; other frames are refused):
//     one chroma sample for each 2x2 (4:2:0) or 2x1 (4:2:2) block of luma;
//     BT.601 coefficients, limited range for MPEG-4's yuv420p and full range
//     for Motion-JPEG's yuvj formats; the arithmetic is the x86 kernels'
//     16-bit fixed point (samples << 3, pmulhw by coefficients scaled by
//     2^13, no rounding), which the C path of the same libswscale also gives
//     on every (Y, U, V): held against it exhaustively.

#include "imread.cpp"
#include "jpeg_tables.h"

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
  ST_AC_RESCALED, ST_COUNT
};
constexpr int SLICE_END = 1;  // decode_slice: a video packet ends before the VOP does

struct Mpeg4 {
  uint32_t tag = 0;  // the container's fourcc, upper case
  std::string msg;
  int64_t stats[ST_COUNT] = {};
  // video object layer
  bool have_vol = false;
  int vo_type = 0, vol_control = 0, width = 0, height = 0, mb_w = 0, mb_h = 0, mb_num = 0;
  int time_increment_bits = 0, quant_precision = 5;
  bool resync_marker = false;
  int lavc_build = -1, xvid_build = -1, divx_version = -1;
  // the VOP being decoded
  int pict_type = I_VOP, qscale = 1, f_code = 1, no_rounding = 0, intra_dc_threshold = 99;
  int y_dc_scale = 8, c_dc_scale = 8;
  int mb_x = 0, mb_y = 0, resync_mb_x = 0, resync_mb_y = 0;
  bool first_slice_line = true, ac_pred = false;
  Frame cur, ref;
  bool have_ref = false;
  // prediction state, with a border of one block (or macroblock) on each side
  int bw = 0, cw = 0;  // widths of the luma-block and chroma (macroblock) grids, borders included
  std::vector<int16_t> dc_y, dc_u, dc_v, ac_y, ac_u, ac_v, mv;
  std::vector<int8_t> qs;  // quantiser of each macroblock
  int16_t block[6][64];
  int last_index[6];
  int mv_type = 0;  // 0: one vector, 1: four
  int mvs[4][2];
  bool mb_intra = false;

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

  void set_qscale(int q) {
    qscale = q < 1 ? 1 : (q > 31 ? 31 : q);
    y_dc_scale = kYDcScale[qscale];
    c_dc_scale = kCDcScale[qscale];
  }

  // ---- headers

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
      b.skip(1);  // low_delay
      if (b.get1()) b.skip(15 + 1 + 15 + 1 + 15 + 1 + 3 + 11 + 1 + 15 + 1);  // vbv parameters
    }
    int shape = (int)b.get(2);
    if (shape != 0) return refuse("a video object layer shape other than rectangular");
    b.skip(1);
    int resolution = (int)b.get(16);
    if (!resolution) return damaged("vop_time_increment_resolution 0");
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
    if (b.get1()) return refuse("MPEG quantisation matrices (quant_type 1)");
    if (ver_id != 1 && b.get1()) return refuse("quarter-pel motion compensation");
    if (!b.get1()) return refuse("complexity estimation");
    resync_marker = !b.get1();
    if (b.get1()) return refuse(b.get1() ? "data partitioning with RVLC" : "data partitioning");
    if (ver_id != 1) {
      if (b.get1()) return refuse("newpred");
      if (b.get1()) return refuse("reduced-resolution VOPs");
    }
    if (b.get1()) return refuse("scalability");
    if (w <= 0 || h <= 0 || w > 8192 || h > 8192) return damaged("bad frame size");
    if (!have_vol || w != width || h != height) {
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
      have_ref = false;
    }
    have_vol = true;
    return OK;
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
    if (e >= 2) divx_version = ver;
    e = sscanf(buf, "FFmpe%*[^b]b%d", &build) + 3;
    if (e != 4) e = sscanf(buf, "FFmpeg v%d.%d.%d / libavcodec build: %d", &ver, &ver2, &ver3, &build);
    if (e != 4) {
      e = sscanf(buf, "Lavc%d.%d.%d", &ver, &ver2, &ver3) + 1;
      if (e > 1) {
        if (ver > 0xFF || ver2 > 0xFF || ver3 > 0xFF)
          e = 0;
        else
          build = (ver << 16) + (ver2 << 8) + ver3;
      }
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
    while (true) {
      if (b.left() <= 0) return NO_FRAME;
      startcode = (startcode << 8) | b.get(8);
      if ((startcode & 0xFFFFFF00) != 0x100) continue;
      if (startcode >= 0x120 && startcode <= 0x12F) {
        int st = decode_vol(b);
        if (st) return st;
      } else if (startcode == 0x1B2) {
        decode_user_data(b);
      } else if (startcode == 0x1B6) {
        return OK;
      }
      b.align();
      startcode = 0xff;
    }
  }

  // ff_mpeg4_workaround_bugs: the encoders whose streams FFmpeg decodes with
  // the Xvid IDCT or with bug workarounds
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
    if (xvid_build >= 0) return refuse("a stream from the Xvid encoder (decoded with the Xvid IDCT)");
    if (divx_version >= 0) return refuse("a stream from the DivX encoder (decoded with its bug workarounds)");
    if (tag == rl32("XVIX") || tag == rl32("UMP4")) return refuse("a stream whose fourcc asks for bug workarounds");
    bool iedge = (lavc_build & 0xFF) >= 100 && lavc_build > 3621476 && lavc_build < 3752552 &&
                 (lavc_build < 3752037 || lavc_build > 3752191);  // FF_BUG_IEDGE's builds
    if (lavc_build >= 0 && (lavc_build <= 4712 || iedge))
      return refuse("a stream from an old libavcodec (decoded with bug workarounds)");
    return OK;
  }

  int decode_vop_header(Bits& b) {
    pict_type = (int)b.get(2);
    while (b.get1()) {
      if (b.left() <= 0) return damaged("truncated VOP header");
    }
    b.skip(1);  // marker
    b.skip(time_increment_bits);
    b.skip(1);  // marker
    if (!b.get1()) {  // vop_coded = 0: FFmpeg outputs no frame
      ++stats[ST_NOT_CODED_VOP];
      return NO_FRAME;
    }
    if (pict_type == B_VOP) return refuse("B-VOPs (Advanced Simple Profile)");
    if (pict_type == S_VOP) return refuse("S-VOPs (sprites and global motion compensation)");
    no_rounding = pict_type == P_VOP ? b.get1() : 0;
    intra_dc_threshold = kDcThreshold[b.get(3)];
    int q = (int)b.get(quant_precision);
    if (q == 0) return damaged("quantiser 0");
    set_qscale(q);
    f_code = 1;
    if (pict_type != I_VOP) {
      f_code = (int)b.get(3);
      if (f_code == 0) return damaged("f_code 0");
    }
    if (b.left() < 0) return damaged("truncated VOP header");
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
  int level_dc(int n, int pred, int level) {
    int scale = n < 4 ? y_dc_scale : c_dc_scale;
    pred = (pred + (scale >> 1)) / scale;
    level += pred;
    int ret = level;
    level *= scale;
    if (level & ~2047) level = level < 0 ? 0 : 2047;
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

  int decode_block(Bits& b, int16_t* blk, int n, bool coded, bool intra) {  // mpeg4_decode_block
    const Tables& t = tables();
    int i, qmul, qadd, dir = 0, pred = 0;
    const RunLevel* rl;
    const uint8_t* scan = kZigzag;
    bool use_dc_vlc = qscale_at_mb_start < intra_dc_threshold;
    if (intra) {
      if (use_dc_vlc) {
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
      qmul = qscale << 1;
      qadd = (qscale - 1) | 1;
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
  int decode_motion(Bits& b, int pred) {
    int code = tables().mv.read(b);
    if (code == 0) return pred;
    if (code < 0) return INT32_MIN;
    int sign = b.get1(), shift = f_code - 1, val = code;
    if (shift) {
      val = (val - 1) << shift;
      val |= (int)b.get(shift);
      val++;
    }
    if (sign) val = -val;
    val += pred;
    int bits = 5 + f_code;  // sign_extend(val, 5 + f_code)
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
    // put_no_rnd_pixels{8,16}_{x2,y2}_mmxext, which FFmpeg's x86 build takes
    // unless asked to be bit-exact: pavgb(max(p - 1, 0), q), exact but where
    // p is 0; p is the left sample (x2) or that of the pair's odd source row
    // counted from the block's first (y2)
    auto avg_no_rnd = [](int p, int q) { return ((p > 0 ? p - 1 : 0) + q + 1) >> 1; };
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

  int h_edge() const { return mb_w * 16; }
  int v_edge() const { return mb_h * 16; }

  void motion(uint8_t* dy, uint8_t* du, uint8_t* dv) {
    const Frame& f = ref;
    bool nr = no_rounding != 0;
    int he = h_edge(), ve = v_edge();
    if (mv_type == 0) {  // mpeg_motion_internal, 16x16
      int mx = mvs[0][0], my = mvs[0][1];
      int dxy = ((my & 1) << 1) | (mx & 1);
      int sx = mb_x * 16 + (mx >> 1), sy = mb_y * 16 + (my >> 1);
      hpel(f.y.data(), f.ystride, he, ve, sx, sy, dxy, 16, nr, dy, cur.ystride);
      int uvdxy = dxy | (my & 2) | ((mx & 2) >> 1);
      int ux = sx >> 1, uy = sy >> 1;
      hpel(f.u.data(), f.cstride, he >> 1, ve >> 1, ux, uy, uvdxy, 8, nr, du, cur.cstride);
      hpel(f.v.data(), f.cstride, he >> 1, ve >> 1, ux, uy, uvdxy, 8, nr, dv, cur.cstride);
      return;
    }
    int sumx = 0, sumy = 0;
    for (int i = 0; i < 4; ++i) {  // hpel_motion
      int mx = mvs[i][0], my = mvs[i][1];
      int sx = mb_x * 16 + (i & 1) * 8 + (mx >> 1), sy = mb_y * 16 + (i >> 1) * 8 + (my >> 1);
      int dxy = 0;
      sx = std::max(-16, std::min(sx, width));
      if (sx != width) dxy |= mx & 1;
      sy = std::max(-16, std::min(sy, height));
      if (sy != height) dxy |= (my & 1) << 1;
      hpel(f.y.data(), f.ystride, he, ve, sx, sy, dxy, 8, nr,
           dy + (i & 1) * 8 + (size_t)(i >> 1) * 8 * cur.ystride, cur.ystride);
      sumx += mx;
      sumy += my;
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
    hpel(f.u.data(), f.cstride, he >> 1, ve >> 1, sx, sy, dxy, 8, nr, du, cur.cstride);
    hpel(f.v.data(), f.cstride, he >> 1, ve >> 1, sx, sy, dxy, 8, nr, dv, cur.cstride);
  }

  // ---- macroblocks

  int qscale_at_mb_start = 1;

  // mpeg4_decode_mb, for I- and P-VOPs without data partitioning
  int decode_mb(Bits& b) {
    const Tables& t = tables();
    int cbpc, cbp, dquant;
    for (int i = 0; i < 6; ++i) memset(block[i], 0, sizeof(block[i]));
    mv_type = 0;
    if (pict_type == P_VOP) {
      do {
        if (b.get1()) {  // not coded: the reference's macroblock, vector 0
          ++stats[ST_SKIPPED_MB];
          mb_intra = false;
          for (int i = 0; i < 6; ++i) last_index[i] = -1;
          mvs[0][0] = mvs[0][1] = 0;
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
        int px, py;
        if ((cbpc & 16) == 0) {
          pred_motion(0, &px, &py);
          int mx = decode_motion(b, px);
          if (mx == INT32_MIN) return damaged("bad motion vector code");
          int my = decode_motion(b, py);
          if (my == INT32_MIN) return damaged("bad motion vector code");
          mvs[0][0] = mx;
          mvs[0][1] = my;
        } else {
          ++stats[ST_FOUR_MV_MB];
          mv_type = 1;
          for (int i = 0; i < 4; ++i) {
            int16_t* mvp = pred_motion(i, &px, &py);
            int mx = decode_motion(b, px);
            if (mx == INT32_MIN) return damaged("bad motion vector code");
            int my = decode_motion(b, py);
            if (my == INT32_MIN) return damaged("bad motion vector code");
            mvs[i][0] = mvp[0] = (int16_t)mx;
            mvs[i][1] = mvp[1] = (int16_t)my;
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

  void update_motion_val() {  // ff_h263_update_motion_val
    if (mv_type == 1 && !mb_intra) return;  // stored while parsing
    int mx = mb_intra ? 0 : mvs[0][0], my = mb_intra ? 0 : mvs[0][1];
    for (int n = 0; n < 4; ++n) {
      int16_t* p = mv_at(n);
      p[0] = (int16_t)mx;
      p[1] = (int16_t)my;
    }
  }

  void reconstruct() {  // ff_mpv_reconstruct_mb
    qs_at(mb_x, mb_y) = (int8_t)qscale;
    uint8_t* dy = cur.y.data() + (size_t)mb_y * 16 * cur.ystride + mb_x * 16;
    uint8_t* du = cur.u.data() + (size_t)mb_y * 8 * cur.cstride + mb_x * 8;
    uint8_t* dv = cur.v.data() + (size_t)mb_y * 8 * cur.cstride + mb_x * 8;
    uint8_t* dst[6] = {dy, dy + 8, dy + 8 * (size_t)cur.ystride, dy + 8 * (size_t)cur.ystride + 8, du, dv};
    if (!mb_intra) {
      clean_intra_entries();
      motion(dy, du, dv);
      for (int n = 0; n < 6; ++n)
        if (last_index[n] >= 0) idct_add(dst[n], n < 4 ? cur.ystride : cur.cstride, block[n]);
      return;
    }
    int qmul = qscale << 1, qadd = (qscale - 1) | 1;  // dct_unquantize_h263_intra
    for (int n = 0; n < 6; ++n) {
      int16_t* blk = block[n];
      blk[0] = (int16_t)(blk[0] * (n < 4 ? y_dc_scale : c_dc_scale));
      for (int k = 1; k < 64; ++k) {
        int level = blk[k];
        if (level) blk[k] = (int16_t)(level < 0 ? level * qmul - qadd : level * qmul + qadd);
      }
      idct_put(dst[n], n < 4 ? cur.ystride : cur.cstride, blk);
    }
  }

  int prefix_length() const { return pict_type == I_VOP ? 16 : f_code + 15; }

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

  void clean_buffers() {  // ff_mpeg4_clean_buffers: no AC prediction across packets
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
  }

  int decode_slice(Bits& b) {
    first_slice_line = true;
    resync_mb_x = mb_x;
    resync_mb_y = mb_y;
    set_qscale(qscale);
    for (; mb_y < mb_h; ++mb_y) {
      for (; mb_x < mb_w; ++mb_x) {
        if (resync_mb_x == mb_x && resync_mb_y + 1 == mb_y) first_slice_line = false;
        qscale_at_mb_start = qscale;
        int st = decode_mb(b);
        update_motion_val();
        if (st) return st;
        reconstruct();
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

  int decode(const uint8_t* data, long n, Frame& out) {
    if (n >= 3 && data[0] == 0 && data[1] == 0 && (data[2] & 0xFC) == 0x80)
      return refuse("short_video_header (an H.263 picture)");
    Bits b;
    b.init(data, n);
    int st = decode_headers(b);
    if (st == NO_FRAME) return NO_FRAME;  // headers only
    if (st) return st;
    if (!have_vol) return damaged("a VOP before any video object layer header");
    st = check_encoder();
    if (st) return st;
    st = decode_vop_header(b);
    if (st) return st;
    if (pict_type == P_VOP && !have_ref) return damaged("a P-VOP without a reference frame");
    ++stats[pict_type == I_VOP ? ST_I_VOP : ST_P_VOP];
    cur.alloc(width, height, mb_w * 16, mb_h * 16, mb_w * 8, mb_h * 8, 1);
    mb_x = mb_y = 0;
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
    std::swap(ref, cur);
    have_ref = true;
    out = ref;
    out.full_range = false;
    return FRAME;
  }
};

struct Handle {
  int codec;
  int open_status = 0;
  Mjpeg mjpeg;
  Mpeg4 mpeg4;
  Frame frame;
  bool have_frame = false;
  std::string msg;
};

}  // namespace vid

extern "C" {

// codec: 1 Motion-JPEG, 2 MPEG-4 Part 2; ``priv``: the decoder configuration
// (MPEG-4's VOS/VOL headers) or empty; ``tag``: the container's fourcc
void* vdec_open(int codec, const uint8_t* priv, long n, uint32_t tag) {
  vid::Handle* h = new vid::Handle();
  h->codec = codec;
  h->mpeg4.tag = tag;
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
// (headers only, or a VOP that is not coded), 2 a tool or format refused,
// 3 damaged data; vdec_error gives the message of 2 and 3.
int vdec_send(void* hp, const uint8_t* data, long n) {
  vid::Handle* h = (vid::Handle*)hp;
  if (h->open_status) return h->open_status;
  int st;
  if (h->codec == 1) {
    st = h->mjpeg.decode(data, n, h->frame, h->msg);
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

const char* vdec_error(void* hp, int) { return ((vid::Handle*)hp)->msg.c_str(); }

// the MPEG-4 decoder's counts of coding tools met so far (vid::Stat order), for tests
int vdec_stats(void* hp, int64_t* out) {
  vid::Handle* h = (vid::Handle*)hp;
  for (int i = 0; i < vid::ST_COUNT; ++i) out[i] = h->mpeg4.stats[i];
  return vid::ST_COUNT;
}

void vdec_close(void* hp) { delete (vid::Handle*)hp; }

}  // extern "C"
