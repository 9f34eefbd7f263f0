// Image decoding on the host: PNG row unfiltering and a baseline JPEG decoder.
//
// The port's counterpart of cv2.imread(IMREAD_COLOR) + cvtColor(BGR2RGB),
// called through ctypes from native.py, which parses PNG chunks and inflates
// their data with Python's zlib.
//
// JPEG: baseline, extended sequential and progressive Huffman files, 8-bit
// samples, interleaved or not, restart intervals, any integer chroma
// subsampling. A progressive file's scans (spectral selection and successive
// approximation: DC first and refinement, AC first and refinement with EOB
// runs, jdphuff.c) fill a coefficient buffer, which the same IDCT and
// upsampling then turn into pixels once its last scan is read, as libjpeg
// does without buffered-image mode (a complete file's coefficients take no
// block smoothing). The arithmetic is libjpeg-turbo's, so the pixels equal
// what OpenCV (built with libjpeg-turbo) gives:
//   * the accurate integer IDCT (jidctint.c, jpeg_idct_islow) and its range
//     limit table (jdmaster.c, prepare_range_limit_table);
//   * "fancy" triangle upsampling of 2x1, 2x2 and 1x2 subsampled chroma
//     (jdsample.c, h2v1/h2v2/h1v2_fancy_upsample), edge rows and columns
//     replicated as the main controller's context rows are (jdmainct.c), and
//     replication for the other ratios (int_upsample);
//   * the fixed-point YCbCr->RGB tables (jdcolor.c, build_ycc_rgb_table).
// Four-component (CMYK) files, Adobe transform 0 or no Adobe marker, come
// out of libjpeg as CMYK and through OpenCV's CMYK->BGR
// (imgcodecs/src/utils.cpp, icvCvt_CMYK2BGR_8u_C4C3R). The same decoder reads
// the strips and tiles of JPEG-in-TIFF (jpeg_decode_tiff): an abbreviated
// tables-only stream (the JPEGTables tag) read first, then the segment's own
// stream, its colour converted only where libtiff asks libjpeg for RGB.
// Arithmetic-coded, lossless, hierarchical, 12-bit and YCCK (Adobe
// transform 2) files are refused with an error code that native.py raises
// as NotImplementedError.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Status {
  OK = 0,
  E_TRUNCATED = 1,
  E_NOT_JPEG = 2,
  E_HIERARCHICAL = 3,
  E_ARITHMETIC = 4,
  E_LOSSLESS = 5,
  E_PRECISION = 6,
  E_SAMPLING = 7,
  E_COMPONENTS = 8,
  E_HUFFMAN = 9,
  E_BAD_DATA = 10,
  E_PNG_FILTER = 11,
  E_SIZE = 12,
  E_NO_FRAME = 13,
  E_DNL = 14,
  E_YCCK = 15,
  E_TIFF_LAYOUT = 16,
};

const char* const kMessages[] = {
    "ok",
    "the data ends before the image does",
    "not a JPEG file",
    "hierarchical progressive JPEG is not supported",
    "arithmetic-coded JPEG is not supported",
    "lossless or hierarchical JPEG is not supported",
    "only 8-bit JPEG samples are supported",
    "this chroma subsampling is not supported",
    "only 1-, 3- and 4-component (CMYK) JPEG files are supported",
    "bad Huffman code or table",
    "corrupt JPEG data",
    "unknown PNG filter type",
    "the image size does not match the header",
    "no frame header before the scan",
    "height given by a DNL marker is not supported",
    "YCCK JPEG (Adobe transform 2) is not supported",
    "the JPEG's components or sampling factors are not those the TIFF's tags give",
};

// zigzag index -> natural (row-major) index, with the 16 extra entries
// libjpeg keeps so that a corrupt run length cannot write past the block
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool defined = false;
  uint8_t look_len[512];  // code length of the 9-bit prefix, 0 if longer
  uint8_t look_val[512];
  int32_t maxcode[18];
  int32_t valoffset[17];
  uint8_t vals[256];
};

bool build_huffman(Huffman& h, const uint8_t* bits, const uint8_t* vals, int nvals) {
  memset(h.look_len, 0, sizeof(h.look_len));
  memcpy(h.vals, vals, nvals);
  int code = 0, p = 0;
  for (int l = 1; l <= 16; ++l) {
    int n = bits[l - 1];
    h.valoffset[l] = p - code;
    if (n) {
      for (int i = 0; i < n; ++i, ++p, ++code) {
        if (l <= 9) {
          int shift = 9 - l;
          for (int j = 0; j < (1 << shift); ++j) {
            h.look_len[(code << shift) | j] = (uint8_t)l;
            h.look_val[(code << shift) | j] = vals[p];
          }
        }
      }
      h.maxcode[l] = code - 1;
    } else {
      h.maxcode[l] = -1;
    }
    if (code > (1 << l)) return false;  // more codes than the length allows
    code <<= 1;
  }
  h.maxcode[17] = 0x7FFFFFFF;
  h.defined = true;
  return true;
}

// Entropy-coded data reader: bits MSB first, byte stuffing removed, zeros fed
// past a marker (counted, so that reading into them is an error).
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int cnt = 0;
  int fake = 0;  // zero bytes fed past a marker or the end, still in buf
  bool at_marker = false;

  void fill() {
    while (cnt <= 56) {
      uint32_t b = 0;
      if (at_marker || p >= end) {
        at_marker = true;
        ++fake;
      } else {
        b = *p;
        if (b == 0xFF) {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) ++q;  // fill bytes
          if (q < end && *q == 0x00) {
            p = q + 1;
          } else {  // a marker: stop before it
            p = q - 1;
            at_marker = true;
            ++fake;
            b = 0;
          }
        } else {
          ++p;
        }
      }
      buf |= (uint64_t)b << (56 - cnt);
      cnt += 8;
    }
  }
  bool overrun() const { return cnt < fake * 8; }
  uint32_t get(int n) {  // n in 1..16, cnt >= n
    uint32_t v = (uint32_t)(buf >> (64 - n));
    buf <<= n;
    cnt -= n;
    return v;
  }
  void reset() { buf = 0; cnt = 0; fake = 0; at_marker = false; }
};

inline int decode(BitReader& br, const Huffman& h) {
  if (br.cnt < 16) br.fill();
  uint32_t look = (uint32_t)(br.buf >> 55);
  int len = h.look_len[look];
  if (len) {
    br.buf <<= len;
    br.cnt -= len;
    return h.look_val[look];
  }
  for (int l = 10; l <= 16; ++l) {
    int32_t code = (int32_t)(br.buf >> (64 - l));
    if (code <= h.maxcode[l]) {
      br.buf <<= l;
      br.cnt -= l;
      int idx = h.valoffset[l] + code;
      return (idx >= 0 && idx < 256) ? h.vals[idx] : -1;
    }
  }
  return -1;
}

inline int extend(uint32_t v, int s) {
  return (v < (1u << (s - 1))) ? (int)v - (1 << s) + 1 : (int)v;
}

inline uint32_t bits(BitReader& br, int n) {  // n in 0..16
  if (n == 0) return 0;
  if (br.cnt < n) br.fill();
  return br.get(n);
}

// ---- the accurate integer IDCT, jidctint.c jpeg_idct_islow -----------------

constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

// post-IDCT range limit: the value, centred on 0, masked to 10 bits as libjpeg does
inline uint8_t idct_limit(int64_t x) {
  int v = (int)(x & 1023);
  if (v < 128) return (uint8_t)(v + 128);
  if (v < 512) return 255;
  if (v < 896) return 0;
  return (uint8_t)(v - 896);
}

void idct_islow(const int32_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int32_t* in = coef + c;
    const uint16_t* qt = q + c;
    int32_t* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 && in[48] == 0 &&
        in[56] == 0) {
      int32_t dc = (int32_t)((int64_t)in[0] * qt[0] * (1 << PASS1_BITS));
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = (int64_t)in[16] * qt[16], z3 = (int64_t)in[48] * qt[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)in[0] * qt[0];
    z3 = (int64_t)in[32] * qt[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)in[56] * qt[56];
    tmp1 = (int64_t)in[40] * qt[40];
    tmp2 = (int64_t)in[24] * qt[24];
    tmp3 = (int64_t)in[8] * qt[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int S = CONST_BITS - PASS1_BITS;
    w[0] = (int32_t)descale(tmp10 + tmp3, S);
    w[56] = (int32_t)descale(tmp10 - tmp3, S);
    w[8] = (int32_t)descale(tmp11 + tmp2, S);
    w[48] = (int32_t)descale(tmp11 - tmp2, S);
    w[16] = (int32_t)descale(tmp12 + tmp1, S);
    w[40] = (int32_t)descale(tmp12 - tmp1, S);
    w[24] = (int32_t)descale(tmp13 + tmp0, S);
    w[32] = (int32_t)descale(tmp13 - tmp0, S);
  }
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + 8 * r;
    uint8_t* o = out + (size_t)r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 && w[7] == 0) {
      uint8_t dc = idct_limit(descale(w[0], PASS1_BITS + 3));
      for (int c = 0; c < 8; ++c) o[c] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << CONST_BITS);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int S = CONST_BITS + PASS1_BITS + 3;
    o[0] = idct_limit(descale(tmp10 + tmp3, S));
    o[7] = idct_limit(descale(tmp10 - tmp3, S));
    o[1] = idct_limit(descale(tmp11 + tmp2, S));
    o[6] = idct_limit(descale(tmp11 - tmp2, S));
    o[2] = idct_limit(descale(tmp12 + tmp1, S));
    o[5] = idct_limit(descale(tmp12 - tmp1, S));
    o[3] = idct_limit(descale(tmp13 + tmp0, S));
    o[4] = idct_limit(descale(tmp13 - tmp0, S));
  }
}

// ---- frame, scans and output -------------------------------------------------

struct Component {
  int id, h, v, tq;
  int dc_tbl = 0, ac_tbl = 0;
  int pred = 0;
  int plane_w = 0, plane_h = 0;  // samples, whole MCUs
  int comp_w = 0, comp_h = 0;    // libjpeg's downsampled_width / _height
  std::vector<uint8_t> plane;
  std::vector<int16_t> coef;     // progressive: 64 a block, plane_w / 8 blocks a row
  uint16_t qt_latched[64];       // progressive: the table at the component's first scan
  bool latched = false;
};

struct Decoder {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool frame = false, jfif = false, adobe = false;
  bool four_components = false;  // take CMYK / YCCK frames (a JPEG file's reader)
  bool tables_only = false;      // an abbreviated stream of tables alone is complete
  int adobe_transform = -1;
  int restart_interval = 0;
  bool progressive = false;
  int eobrun = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  Component comp[4];
  // dequantises and inverse-transforms a block of quantised coefficients
  // (natural order) into 8x8 samples; the Motion-JPEG decoder puts FFmpeg's here
  void (*recon)(const int32_t* coef, const uint16_t* q, uint8_t* out, int stride) = idct_islow;

  int u16(size_t at) const { return (data[at] << 8) | data[at + 1]; }

  int read_segment(size_t* seg, int* len) {
    if (pos + 2 > n) return E_TRUNCATED;
    *len = u16(pos);
    if (*len < 2 || pos + *len > n) return E_TRUNCATED;
    *seg = pos + 2;
    pos += *len;
    return OK;
  }

  int parse_sof(int marker) {
    size_t s;
    int len, st = read_segment(&s, &len);
    if (st) return st;
    if (marker == 0xC6) return E_HIERARCHICAL;
    if (marker >= 0xC9) return E_ARITHMETIC;
    if (marker != 0xC0 && marker != 0xC1 && marker != 0xC2) return E_LOSSLESS;
    progressive = marker == 0xC2;
    if (len < 8) return E_BAD_DATA;
    if (data[s] != 8) return E_PRECISION;
    height = u16(s + 1);
    width = u16(s + 3);
    ncomp = data[s + 5];
    if (height == 0) return E_DNL;
    if (width == 0) return E_BAD_DATA;
    if (ncomp != 1 && ncomp != 3 && !(ncomp == 4 && four_components)) return E_COMPONENTS;
    if (len < 8 + 3 * ncomp) return E_BAD_DATA;
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = data[s + 6 + 3 * i];
      c.h = data[s + 7 + 3 * i] >> 4;
      c.v = data[s + 7 + 3 * i] & 15;
      c.tq = data[s + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) return E_BAD_DATA;
      hmax = c.h > hmax ? c.h : hmax;
      vmax = c.v > vmax ? c.v : vmax;
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (hmax % c.h || vmax % c.v) return E_SAMPLING;
      c.plane_w = mcux * c.h * 8;
      c.plane_h = mcuy * c.v * 8;
      c.comp_w = (int)(((long)width * c.h + hmax - 1) / hmax);
      c.comp_h = (int)(((long)height * c.v + vmax - 1) / vmax);
      c.plane.assign((size_t)c.plane_w * c.plane_h, 0);
      if (progressive) c.coef.assign((size_t)c.plane_w * c.plane_h, 0);
    }
    frame = true;
    return OK;
  }

  int parse_dht() {
    size_t s;
    int len, st = read_segment(&s, &len);
    if (st) return st;
    size_t e = s + len - 2;
    while (s < e) {
      if (s + 17 > e) return E_BAD_DATA;
      int tc = data[s] >> 4, th = data[s] & 15;
      if (tc > 1 || th > 3) return E_HUFFMAN;
      const uint8_t* bits = data + s + 1;
      int total = 0;
      for (int i = 0; i < 16; ++i) total += bits[i];
      if (total > 256 || s + 17 + total > e) return E_HUFFMAN;
      if (!build_huffman(tc ? ac[th] : dc[th], bits, data + s + 17, total)) return E_HUFFMAN;
      s += 17 + total;
    }
    return OK;
  }

  int parse_dqt() {
    size_t s;
    int len, st = read_segment(&s, &len);
    if (st) return st;
    size_t e = s + len - 2;
    while (s < e) {
      int pq = data[s] >> 4, tq = data[s] & 15;
      if (tq > 3 || pq > 1) return E_BAD_DATA;
      size_t need = 1 + 64 * (pq + 1);
      if (s + need > e) return E_BAD_DATA;
      for (int k = 0; k < 64; ++k)
        qt[tq][kNatural[k]] = pq ? (uint16_t)u16(s + 1 + 2 * k) : data[s + 1 + k];
      qt_defined[tq] = true;
      s += need;
    }
    return OK;
  }

  int decode_block(BitReader& br, Component& c, uint8_t* out, int stride) {
    int32_t coef[64];
    memset(coef, 0, sizeof(coef));
    const Huffman& hd = dc[c.dc_tbl];
    const Huffman& ha = ac[c.ac_tbl];
    if (br.cnt < 32) br.fill();
    int s = decode(br, hd);
    if (s < 0 || s > 15) return E_HUFFMAN;
    if (s) {
      if (br.cnt < 16) br.fill();
      c.pred += extend(br.get(s), s);
    }
    coef[0] = c.pred;
    for (int k = 1; k < 64; ++k) {
      if (br.cnt < 32) br.fill();
      int rs = decode(br, ha);
      if (rs < 0) return E_HUFFMAN;
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (br.cnt < 16) br.fill();
        coef[kNatural[k]] = extend(br.get(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    if (br.overrun()) return E_TRUNCATED;
    recon(coef, qt[c.tq], out, stride);
    return OK;
  }

  // ---- progressive scans (jdphuff.c decode_mcu_DC_first, _DC_refine, _AC_first, _AC_refine)

  int16_t* block_at(Component& c, long by, long bx) {
    return c.coef.data() + ((size_t)by * (c.plane_w / 8) + bx) * 64;
  }

  int dc_first(BitReader& br, Component& c, int16_t* blk, int al) {
    int s = decode(br, dc[c.dc_tbl]);
    if (s < 0 || s > 15) return E_HUFFMAN;
    if (s) c.pred += extend(bits(br, s), s);
    blk[0] = (int16_t)(c.pred * (1 << al));
    return OK;
  }

  void dc_refine(BitReader& br, int16_t* blk, int al) {
    if (bits(br, 1)) blk[0] = (int16_t)(blk[0] | (1 << al));
  }

  int ac_first(BitReader& br, const Huffman& h, int16_t* blk, int ss, int se, int al) {
    if (eobrun > 0) {
      --eobrun;
      return OK;
    }
    for (int k = ss; k <= se; ++k) {
      int rs = decode(br, h);
      if (rs < 0) return E_HUFFMAN;
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) return E_BAD_DATA;
        blk[kNatural[k]] = (int16_t)(extend(bits(br, s), s) * (1 << al));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += bits(br, r);
        --eobrun;
        break;
      }
    }
    return OK;
  }

  int ac_refine(BitReader& br, const Huffman& h, int16_t* blk, int ss, int se, int al) {
    const int p1 = 1 << al, m1 = -p1;
    auto correct = [&](int16_t* coef) {  // a refinement bit of a nonzero coefficient
      if (bits(br, 1) && (*coef & p1) == 0) *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
    };
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = decode(br, h);
        if (rs < 0) return E_HUFFMAN;
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = bits(br, 1) ? p1 : m1;  // a newly nonzero coefficient (s == 1 in a valid file)
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += bits(br, r);
          break;
        }
        // skip r zero coefficients, refining the nonzero ones met on the way
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            correct(coef);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) {
          if (k > 63) return E_BAD_DATA;
          blk[kNatural[k]] = (int16_t)s;
        }
      }
    }
    if (eobrun > 0) {  // the band's rest is in an EOB run: refine its nonzero coefficients
      for (; k <= se; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) correct(coef);
      }
      --eobrun;
    }
    return OK;
  }

  // the coefficient buffers through the IDCT into the planes, after the last scan
  void idct_planes() {
    int32_t blk[64];
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      const uint16_t* q = c.latched ? c.qt_latched : qt[c.tq];
      for (int by = 0; by < c.plane_h / 8; ++by)
        for (int bx = 0; bx < c.plane_w / 8; ++bx) {
          const int16_t* src = block_at(c, by, bx);
          for (int k = 0; k < 64; ++k) blk[k] = src[k];
          recon(blk, q, c.plane.data() + (size_t)by * 8 * c.plane_w + bx * 8, c.plane_w);
        }
    }
  }

  // finds the RSTn marker that ends a restart interval and moves past it
  int next_restart(BitReader& br) {
    const uint8_t* p = br.p;
    while (p + 1 < br.end) {
      if (p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7) {
        br.p = p + 2;
        br.reset();
        return OK;
      }
      if (p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF) return E_BAD_DATA;
      ++p;
    }
    return E_TRUNCATED;
  }

  int parse_sos() {
    if (!frame) return E_NO_FRAME;
    size_t s;
    int len, st = read_segment(&s, &len);
    if (st) return st;
    int ns = data[s];
    if (ns < 1 || ns > 4 || len < 6 + 2 * ns) return E_BAD_DATA;
    Component* sc[4];
    for (int i = 0; i < ns; ++i) {
      int id = data[s + 1 + 2 * i];
      sc[i] = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == id) sc[i] = &comp[j];
      if (!sc[i]) return E_BAD_DATA;
      sc[i]->dc_tbl = data[s + 2 + 2 * i] >> 4;
      sc[i]->ac_tbl = data[s + 2 + 2 * i] & 15;
      if (sc[i]->dc_tbl > 3 || sc[i]->ac_tbl > 3 || !qt_defined[sc[i]->tq]) return E_HUFFMAN;
      sc[i]->pred = 0;
    }
    int ss = data[s + 1 + 2 * ns], se = data[s + 2 + 2 * ns], ahal = data[s + 3 + 2 * ns];
    int ah = ahal >> 4, al = ahal & 15;
    if (progressive) {
      // a DC scan (Ss = 0) takes Se = 0, an AC scan one component (jdinput.c / jdphuff.c start_pass)
      if ((ss == 0 && se != 0) || (ss > 0 && (se < ss || se > 63 || ns != 1)) || ah > 13 || al > 13)
        return E_BAD_DATA;
      for (int i = 0; i < ns; ++i) {
        Component& c = *sc[i];
        bool need_dc = ss == 0 && ah == 0, need_ac = ss > 0;
        if ((need_dc && !dc[c.dc_tbl].defined) || (need_ac && !ac[c.ac_tbl].defined)) return E_HUFFMAN;
        if (!c.latched) {  // jdinput.c latch_quant_tables
          memcpy(c.qt_latched, qt[c.tq], sizeof(c.qt_latched));
          c.latched = true;
        }
      }
      return progressive_scan(sc, ns, ss, se, ah, al);
    }
    for (int i = 0; i < ns; ++i)
      if (!dc[sc[i]->dc_tbl].defined || !ac[sc[i]->ac_tbl].defined) return E_HUFFMAN;
    if (ss != 0 || se != 63 || ahal != 0) return E_BAD_DATA;

    BitReader br;
    br.p = data + pos;
    br.end = data + n;
    int blocks_per_mcu = 0;
    long mcus_x, mcus_y;
    if (ns == 1) {  // non-interleaved: one block an MCU over the component's own extent
      mcus_x = (sc[0]->comp_w + 7) / 8;
      mcus_y = (sc[0]->comp_h + 7) / 8;
      blocks_per_mcu = 1;
    } else {
      mcus_x = mcux;
      mcus_y = mcuy;
      for (int i = 0; i < ns; ++i) blocks_per_mcu += sc[i]->h * sc[i]->v;
      if (blocks_per_mcu > 10) return E_BAD_DATA;
    }
    long total = mcus_x * mcus_y, done = 0;
    for (long my = 0; my < mcus_y; ++my) {
      for (long mx = 0; mx < mcus_x; ++mx) {
        if (restart_interval && done && done % restart_interval == 0) {
          st = next_restart(br);
          if (st) return st;
          for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
        }
        if (ns == 1) {
          Component& c = *sc[0];
          st = decode_block(br, c, c.plane.data() + (size_t)my * 8 * c.plane_w + mx * 8, c.plane_w);
          if (st) return st;
        } else {
          for (int i = 0; i < ns; ++i) {
            Component& c = *sc[i];
            for (int by = 0; by < c.v; ++by)
              for (int bx = 0; bx < c.h; ++bx) {
                size_t y = (size_t)(my * c.v + by) * 8, x = (size_t)(mx * c.h + bx) * 8;
                st = decode_block(br, c, c.plane.data() + y * c.plane_w + x, c.plane_w);
                if (st) return st;
              }
          }
        }
        ++done;
      }
    }
    (void)total;
    end_scan(br);
    return OK;
  }

  // continue the marker loop at the marker that ends the scan
  void end_scan(const BitReader& br) {
    const uint8_t* p = br.p;
    while (p + 1 < br.end && !(p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF &&
                               !(p[1] >= 0xD0 && p[1] <= 0xD7)))
      ++p;
    pos = (size_t)(p - data);
  }

  int progressive_scan(Component** sc, int ns, int ss, int se, int ah, int al) {
    BitReader br;
    br.p = data + pos;
    br.end = data + n;
    eobrun = 0;
    long mcus_x = mcux, mcus_y = mcuy;
    if (ns == 1) {  // non-interleaved: the component's own blocks
      mcus_x = (sc[0]->comp_w + 7) / 8;
      mcus_y = (sc[0]->comp_h + 7) / 8;
    }
    long done = 0;
    for (long my = 0; my < mcus_y; ++my) {
      for (long mx = 0; mx < mcus_x; ++mx) {
        if (restart_interval && done && done % restart_interval == 0) {
          int st = next_restart(br);
          if (st) return st;
          for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
          eobrun = 0;
        }
        for (int i = 0; i < ns; ++i) {
          Component& c = *sc[i];
          int nv = ns == 1 ? 1 : c.v, nh = ns == 1 ? 1 : c.h;
          for (int by = 0; by < nv; ++by)
            for (int bx = 0; bx < nh; ++bx) {
              int16_t* blk = block_at(c, my * nv + by, mx * nh + bx);
              int st = OK;
              if (ss == 0) {
                if (ah == 0) st = dc_first(br, c, blk, al);
                else dc_refine(br, blk, al);
              } else {
                st = ah == 0 ? ac_first(br, ac[c.ac_tbl], blk, ss, se, al)
                             : ac_refine(br, ac[c.ac_tbl], blk, ss, se, al);
              }
              if (st) return st;
            }
        }
        if (br.overrun()) return E_TRUNCATED;
        ++done;
      }
    }
    end_scan(br);
    return OK;
  }

  int parse() {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) return E_NOT_JPEG;
    pos = 2;
    bool scanned = false;
    while (true) {
      while (pos < n && data[pos] != 0xFF) ++pos;  // garbage between segments
      while (pos < n && data[pos] == 0xFF) ++pos;
      if (pos >= n) return scanned || (tables_only && !frame) ? OK : E_TRUNCATED;
      int marker = data[pos++];
      int st = OK;
      if (marker == 0xD9) return scanned || (tables_only && !frame) ? OK : E_TRUNCATED;
      if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 && marker != 0xC8 && marker != 0xCC) {
        if (frame) return E_BAD_DATA;
        st = parse_sof(marker);
      } else if (marker == 0xCC) {
        return E_ARITHMETIC;
      } else if (marker == 0xC4) {
        st = parse_dht();
      } else if (marker == 0xDB) {
        st = parse_dqt();
      } else if (marker == 0xDD) {
        size_t s;
        int len;
        st = read_segment(&s, &len);
        if (!st) restart_interval = u16(s);
      } else if (marker == 0xDA) {
        st = parse_sos();
        scanned = true;
      } else if (marker == 0xDC) {
        return E_DNL;
      } else if (marker == 0xE0 || marker == 0xEE) {
        size_t s;
        int len;
        st = read_segment(&s, &len);
        if (!st && marker == 0xE0 && len >= 7 && memcmp(data + s, "JFIF\0", 5) == 0) jfif = true;
        if (!st && marker == 0xEE && len >= 14 && memcmp(data + s, "Adobe", 5) == 0) {
          adobe = true;
          adobe_transform = data[s + 11];
        }
      } else if (marker >= 0xD0 && marker <= 0xD7) {
        continue;  // stray restart marker
      } else {
        size_t s;
        int len;
        st = read_segment(&s, &len);
      }
      if (st) return st;
    }
  }

  // libjpeg's default colour space of a 3-component file (jdapimin.c default_decompress_parms)
  bool is_rgb() const {
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    if (comp[0].id == 1 && comp[1].id == 2 && comp[2].id == 3) return false;
    if (comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66) return true;
    return false;
  }
};

// One component's samples at full resolution, rows [0, height), cols [0, width).
void upsample(const Component& c, int hmax, int vmax, int width, int height, uint8_t* out) {
  int rx = hmax / c.h, ry = vmax / c.v;
  const uint8_t* pl = c.plane.data();
  int W = c.plane_w, cw = c.comp_w, ch = c.comp_h;
  auto at = [&](int y, int x) -> int { return pl[(size_t)y * W + x]; };
  auto clampy = [&](int y) { return y < 0 ? 0 : (y >= ch ? ch - 1 : y); };
  auto clampx = [&](int x) { return x < 0 ? 0 : (x >= cw ? cw - 1 : x); };
  if (rx == 1 && ry == 1) {
    for (int y = 0; y < height; ++y) memcpy(out + (size_t)y * width, pl + (size_t)y * W, width);
    return;
  }
  if (rx == 2 && ry == 1 && cw > 2) {  // h2v1_fancy_upsample
    for (int y = 0; y < height; ++y) {
      uint8_t* o = out + (size_t)y * width;
      for (int x = 0; x < width; ++x) {
        int i = x >> 1, v3 = 3 * at(y, i);
        o[x] = (x & 1) ? (uint8_t)((v3 + at(y, clampx(i + 1)) + 2) >> 2)
                       : (uint8_t)((v3 + at(y, clampx(i - 1)) + 1) >> 2);
      }
    }
    return;
  }
  if (rx == 1 && ry == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < height; ++y) {
      int i = y >> 1, nb = (y & 1) ? clampy(i + 1) : clampy(i - 1), bias = (y & 1) ? 2 : 1;
      uint8_t* o = out + (size_t)y * width;
      for (int x = 0; x < width; ++x) o[x] = (uint8_t)((3 * at(i, x) + at(nb, x) + bias) >> 2);
    }
    return;
  }
  if (rx == 2 && ry == 2 && cw > 2) {  // h2v2_fancy_upsample
    std::vector<int> colsum(cw);
    for (int y = 0; y < height; ++y) {
      int i = y >> 1, nb = (y & 1) ? clampy(i + 1) : clampy(i - 1);
      for (int x = 0; x < cw; ++x) colsum[x] = 3 * at(i, x) + at(nb, x);
      uint8_t* o = out + (size_t)y * width;
      for (int x = 0; x < width; ++x) {
        int j = x >> 1, t3 = 3 * colsum[j];
        o[x] = (x & 1) ? (uint8_t)((t3 + colsum[clampx(j + 1)] + 7) >> 4)
                       : (uint8_t)((t3 + colsum[clampx(j - 1)] + 8) >> 4);
      }
    }
    return;
  }
  for (int y = 0; y < height; ++y) {  // int_upsample: replication
    uint8_t* o = out + (size_t)y * width;
    for (int x = 0; x < width; ++x) o[x] = (uint8_t)at(y / ry, x / rx);
  }
}

// jdcolor.c build_ycc_rgb_table and ycc_rgb_convert: planes Y, Cb, Cr -> interleaved RGB
void ycc_to_rgb(const uint8_t* p0, const uint8_t* p1, const uint8_t* p2, size_t npix, uint8_t* out) {
  constexpr int SCALEBITS = 16;
  constexpr int64_t ONE_HALF = (int64_t)1 << (SCALEBITS - 1);
  auto fix = [](double x) { return (int64_t)(x * (1L << SCALEBITS) + 0.5); };
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  for (int i = 0, x = -128; i < 256; ++i, ++x) {
    cr_r[i] = (int)((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
    cb_b[i] = (int)((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
    cr_g[i] = -fix(0.71414) * x;
    cb_g[i] = -fix(0.34414) * x + ONE_HALF;
  }
  auto limit = [](int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); };
  for (size_t i = 0; i < npix; ++i) {
    int y = p0[i], cb = p1[i], cr = p2[i];
    out[3 * i] = limit(y + cr_r[cr]);
    out[3 * i + 1] = limit(y + (int)((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
    out[3 * i + 2] = limit(y + cb_b[cb]);
  }
}

}  // namespace

extern "C" {

const char* imread_error(int status) {
  int n = (int)(sizeof(kMessages) / sizeof(kMessages[0]));
  return (status >= 0 && status < n) ? kMessages[status] : "unknown error";
}

// Undo PNG's per-row filters. ``in``: h rows of 1 filter byte + rowbytes
// bytes; ``bpp``: bytes a complete pixel (at least 1); ``out``: h * rowbytes.
int png_unfilter(const uint8_t* in, int h, long rowbytes, int bpp, uint8_t* out) {
  const uint8_t* prev = nullptr;
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = in + (size_t)y * (rowbytes + 1);
    int ft = *src++;
    uint8_t* dst = out + (size_t)y * rowbytes;
    switch (ft) {
      case 0:
        memcpy(dst, src, rowbytes);
        break;
      case 1:
        for (long i = 0; i < rowbytes; ++i) dst[i] = (uint8_t)(src[i] + (i >= bpp ? dst[i - bpp] : 0));
        break;
      case 2:
        for (long i = 0; i < rowbytes; ++i) dst[i] = (uint8_t)(src[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (long i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? dst[i - bpp] : 0, b = prev ? prev[i] : 0;
          dst[i] = (uint8_t)(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (long i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? dst[i - bpp] : 0, b = prev ? prev[i] : 0;
          int c = (i >= bpp && prev) ? prev[i - bpp] : 0;
          int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          dst[i] = (uint8_t)(src[i] + pred);
        }
        break;
      default:
        return E_PNG_FILTER;
    }
    prev = dst;
  }
  return OK;
}

// Decode a JPEG held in memory into ``out``, ``height * width * 3`` RGB bytes;
// ``height`` and ``width`` must be the frame's (see jpeg_shape in native.py).
int jpeg_decode(const uint8_t* data, long n, uint8_t* out, int height, int width) {
  Decoder d;
  d.data = data;
  d.n = (size_t)n;
  d.four_components = true;
  int st = d.parse();
  if (st) return st;
  if (!d.frame) return E_NO_FRAME;
  // libjpeg's colour space of a 4-component file: CMYK without an Adobe marker or with
  // transform 0, YCCK with any other transform (jdapimin.c default_decompress_parms)
  if (d.ncomp == 4 && d.adobe && d.adobe_transform != 0) return E_YCCK;
  if (d.height != height || d.width != width) return E_SIZE;
  if (d.progressive) d.idct_planes();
  size_t npix = (size_t)width * height;
  if (d.ncomp == 1) {
    std::vector<uint8_t> y(npix);
    upsample(d.comp[0], d.hmax, d.vmax, width, height, y.data());
    for (size_t i = 0; i < npix; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
    return OK;
  }
  std::vector<uint8_t> p0(npix), p1(npix), p2(npix);
  upsample(d.comp[0], d.hmax, d.vmax, width, height, p0.data());
  upsample(d.comp[1], d.hmax, d.vmax, width, height, p1.data());
  upsample(d.comp[2], d.hmax, d.vmax, width, height, p2.data());
  if (d.ncomp == 4) {
    std::vector<uint8_t> p3(npix);
    upsample(d.comp[3], d.hmax, d.vmax, width, height, p3.data());
    for (size_t i = 0; i < npix; ++i) {  // icvCvt_CMYK2BGR_8u_C4C3R
      int k = p3[i];
      out[3 * i] = (uint8_t)(k - ((255 - p0[i]) * k >> 8));
      out[3 * i + 1] = (uint8_t)(k - ((255 - p1[i]) * k >> 8));
      out[3 * i + 2] = (uint8_t)(k - ((255 - p2[i]) * k >> 8));
    }
    return OK;
  }
  if (d.is_rgb()) {
    for (size_t i = 0; i < npix; ++i) {
      out[3 * i] = p0[i];
      out[3 * i + 1] = p1[i];
      out[3 * i + 2] = p2[i];
    }
    return OK;
  }
  ycc_to_rgb(p0.data(), p1.data(), p2.data(), npix, out);
  return OK;
}

// Decode one strip or tile of a JPEG-in-TIFF file (compression 7), as libtiff
// 4.7 drives libjpeg (tif_jpeg.c): ``tables`` (``ntables`` bytes, 0 for none)
// is the JPEGTables tag's abbreviated stream, read for its tables before the
// segment's stream ``data``. The frame must hold ``ncomp`` components, the
// first sampled ``hs`` x ``vs`` and the others 1 x 1. ``out`` takes
// ``height * width * ncomp`` interleaved samples (the frame's size): with
// ``ycc`` (photometric YCbCr, JPEGCOLORMODE_RGB) the components are upsampled
// and converted to RGB by libjpeg's tables, otherwise they come out as stored.
int jpeg_decode_tiff(const uint8_t* tables, long ntables, const uint8_t* data, long n, uint8_t* out, int height,
                     int width, int ncomp, int hs, int vs, int ycc) {
  Decoder d;
  d.four_components = true;
  int st;
  if (ntables > 0) {
    d.data = tables;
    d.n = (size_t)ntables;
    d.tables_only = true;
    st = d.parse();
    if (st) return st;
    if (d.frame) return E_BAD_DATA;
    d.tables_only = false;
  }
  d.data = data;
  d.n = (size_t)n;
  d.pos = 0;
  st = d.parse();
  if (st) return st;
  if (!d.frame) return E_NO_FRAME;
  if (d.height != height || d.width != width) return E_SIZE;
  if (d.ncomp != ncomp || d.comp[0].h != hs || d.comp[0].v != vs) return E_TIFF_LAYOUT;
  for (int i = 1; i < d.ncomp; ++i)
    if (d.comp[i].h != 1 || d.comp[i].v != 1) return E_TIFF_LAYOUT;
  if (d.progressive) d.idct_planes();
  size_t npix = (size_t)width * height;
  std::vector<uint8_t> planes((size_t)ncomp * npix);
  for (int i = 0; i < ncomp; ++i) upsample(d.comp[i], d.hmax, d.vmax, width, height, planes.data() + i * npix);
  if (ycc && ncomp == 3) {
    ycc_to_rgb(planes.data(), planes.data() + npix, planes.data() + 2 * npix, npix, out);
    return OK;
  }
  for (size_t i = 0; i < npix; ++i)
    for (int c = 0; c < ncomp; ++c) out[i * ncomp + c] = planes[c * npix + i];
  return OK;
}

}  // extern "C"
