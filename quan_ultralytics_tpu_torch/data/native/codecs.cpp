// The loops of the BMP and TIFF readers and writers that numpy cannot
// vectorise: BMP's RLE8 and RLE4 as OpenCV 5.0's decoder runs them
// (grfmt_bmp.cpp), and TIFF's LZW (as libtiff decodes and encodes it),
// PackBits, horizontal differencing and CCITT RLE, Group 3 (1-D and 2-D) and
// Group 4 (ITU-T T.4 and T.6) as libtiff 4.7's tif_fax3.c decodes them;
// and those of the stills OpenCV reads outside the dataset formats: the
// numbers of ASCII PxM files (grfmt_pxm.cpp's ReadNumber), Radiance's RGBE scanlines (rgbe.cpp's
// RGBE_ReadPixels_RLE) and GIF's LZW.

#include <stdint.h>
#include <string.h>

#include <vector>

namespace {

enum { kOk = 0, kBad = 1, kEnded = 2, kCorrupt = 3, kOldLzw = 4 };

// OpenCV's FillUniColor on palette indices: ``count`` pixels of ``idx`` from
// ``data``, moving to the next row at a row's end.
struct RleState {
  uint8_t* out;
  long data, line_end;
  int width, height, y;
  void fill(long count, uint8_t idx) {
    do {
      long end = data + count;
      if (end > line_end) end = line_end;
      count -= end - data;
      for (; data < end; ++data) out[data] = idx;
      if (data >= line_end) {
        line_end += width;
        data = line_end - width;
        if (++y >= height) break;
      }
    } while (count > 0);
  }
};

// ---- CCITT RLE, Group 3 and Group 4 ------------------------------------------
//
// The decoder keeps libtiff's bit accumulator (least significant bit first,
// zeros padded past the end of the data, which may also pad a byte-aligned
// RLE row by a bit), its run arrays (white and black runs alternating, the
// previous row's runs as the 2-D reference) and its handling of damaged rows:
// a row whose runs do not add up to the width is cut or padded (tif_fax3.c
// CLEANUP_RUNS), a bad code word ends the row, and data that ends before the
// last row ends the strip there. The code tables are built from T.4's code
// words as mkg3states.c builds tif_fax3sm.c.

enum FaxState : uint8_t { S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB, S_MakeUpW,
                          S_MakeUpB, S_MakeUp, S_EOL };

struct FaxEnt {
  uint8_t state = S_Null, width = 0;
  uint16_t param = 0;
};

const char* const kWhiteTerm[64] = {
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111", "10011", "10100", "00111", "01000",
    "001000", "000011", "110100", "110101", "101010", "101011", "0100111", "0001100", "0001000", "0010111",
    "0000011", "0000100", "0101000", "0101011", "0010011", "0100100", "0011000", "00000010", "00000011",
    "00011010", "00011011", "00010010", "00010011", "00010100", "00010101", "00010110", "00010111", "00101000",
    "00101001", "00101010", "00101011", "00101100", "00101101", "00000100", "00000101", "00001010", "00001011",
    "01010010", "01010011", "01010100", "01010101", "00100100", "00100101", "01011000", "01011001", "01011010",
    "01011011", "01001010", "01001011", "00110010", "00110011", "00110100"};
const char* const kWhiteMakeUp[27] = {  // 64, 128, ..., 1728
    "11011", "10010", "010111", "0110111", "00110110", "00110111", "01100100", "01100101", "01101000",
    "01100111", "011001100", "011001101", "011010010", "011010011", "011010100", "011010101", "011010110",
    "011010111", "011011000", "011011001", "011011010", "011011011", "010011000", "010011001", "010011010",
    "011000", "010011011"};
const char* const kBlackTerm[64] = {
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011", "000101", "000100", "0000100", "0000101",
    "0000111", "00000100", "00000111", "000011000", "0000010111", "0000011000", "0000001000", "00001100111",
    "00001101000", "00001101100", "00000110111", "00000101000", "00000010111", "00000011000", "000011001010",
    "000011001011", "000011001100", "000011001101", "000001101000", "000001101001", "000001101010",
    "000001101011", "000011010010", "000011010011", "000011010100", "000011010101", "000011010110",
    "000011010111", "000001101100", "000001101101", "000011011010", "000011011011", "000001010100",
    "000001010101", "000001010110", "000001010111", "000001100100", "000001100101", "000001010010",
    "000001010011", "000000100100", "000000110111", "000000111000", "000000100111", "000000101000",
    "000001011000", "000001011001", "000000101011", "000000101100", "000001011010", "000001100110",
    "000001100111"};
const char* const kBlackMakeUp[27] = {
    "0000001111", "000011001000", "000011001001", "000001011011", "000000110011", "000000110100",
    "000000110101", "0000001101100", "0000001101101", "0000001001010", "0000001001011", "0000001001100",
    "0000001001101", "0000001110010", "0000001110011", "0000001110100", "0000001110101", "0000001110110",
    "0000001110111", "0000001010010", "0000001010011", "0000001010100", "0000001010101", "0000001011010",
    "0000001011011", "0000001100100", "0000001100101"};
const char* const kMakeUp[13] = {  // 1792, 1856, ..., 2560: both colours
    "00000001000", "00000001100", "00000001101", "000000010010", "000000010011", "000000010100",
    "000000010101", "000000010110", "000000010111", "000000011100", "000000011101", "000000011110",
    "000000011111"};

// mkg3states.c FillTable: every ``size``-bit index whose first bits (least
// significant first) are the code word
void fax_fill(FaxEnt* t, int size, const char* bits, FaxState state, int param) {
  int width = (int)strlen(bits), code = 0;
  for (int i = 0; i < width; ++i)
    if (bits[i] == '1') code |= 1 << i;
  for (int c = code; c < (1 << size); c += 1 << width) t[c] = FaxEnt{(uint8_t)state, (uint8_t)width, (uint16_t)param};
}

struct FaxTables {
  FaxEnt mode[128], white[4096], black[8192];
  FaxTables() {
    fax_fill(mode, 7, "0001", S_Pass, 0);
    fax_fill(mode, 7, "001", S_Horiz, 0);
    fax_fill(mode, 7, "1", S_V0, 0);
    fax_fill(mode, 7, "011", S_VR, 1);
    fax_fill(mode, 7, "000011", S_VR, 2);
    fax_fill(mode, 7, "0000011", S_VR, 3);
    fax_fill(mode, 7, "010", S_VL, 1);
    fax_fill(mode, 7, "000010", S_VL, 2);
    fax_fill(mode, 7, "0000010", S_VL, 3);
    fax_fill(mode, 7, "0000001", S_Ext, 0);
    fax_fill(mode, 7, "0000000", S_EOL, 0);
    for (int i = 0; i < 27; ++i) fax_fill(white, 12, kWhiteMakeUp[i], S_MakeUpW, 64 * (i + 1));
    for (int i = 0; i < 13; ++i) fax_fill(white, 12, kMakeUp[i], S_MakeUp, 1792 + 64 * i);
    for (int i = 0; i < 64; ++i) fax_fill(white, 12, kWhiteTerm[i], S_TermW, i);
    fax_fill(white, 12, "00000000000", S_EOL, 0);
    for (int i = 0; i < 27; ++i) fax_fill(black, 13, kBlackMakeUp[i], S_MakeUpB, 64 * (i + 1));
    for (int i = 0; i < 13; ++i) fax_fill(black, 13, kMakeUp[i], S_MakeUp, 1792 + 64 * i);
    for (int i = 0; i < 64; ++i) fax_fill(black, 13, kBlackTerm[i], S_TermB, i);
    fax_fill(black, 13, "00000000000", S_EOL, 0);
  }
};

struct FaxDecoder {
  const uint8_t* cp;
  const uint8_t* ep;
  bool reverse;  // FillOrder 1: the first bit of the data is each byte's high bit
  uint32_t acc = 0;
  int avail = 0, eolcnt = 0;
  int lastx;
  long nruns;
  std::vector<uint32_t> runs;
  uint32_t* cur;
  uint32_t* ref;
  const FaxTables& tab;

  FaxDecoder(const uint8_t* in, long n, bool lsb_first, int width, bool two_d, const FaxTables& t)
      : cp(in), ep(in + n), reverse(!lsb_first), lastx(width), tab(t) {
    nruns = ((long)width + 1 + 31) / 32 * 32 * (two_d ? 2 : 1);
    runs.assign(2 * nruns + 2, 0);
    cur = runs.data();
    ref = two_d ? runs.data() + nruns : nullptr;
    if (ref) {
      ref[0] = (uint32_t)width;
      ref[1] = 0;
    }
  }
  static uint8_t rev(uint8_t b) {
    b = (uint8_t)((b & 0xF0) >> 4 | (b & 0x0F) << 4);
    b = (uint8_t)((b & 0xCC) >> 2 | (b & 0x33) << 2);
    return (uint8_t)((b & 0xAA) >> 1 | (b & 0x55) << 1);
  }
  uint32_t next() { return reverse ? rev(*cp++) : *cp++; }
  // NeedBits8 / NeedBits16: false where the data has ended with no bit left
  bool need8(int n) {
    if (avail < n) {
      if (cp >= ep) {
        if (avail == 0) return false;
        avail = n;
      } else {
        acc |= next() << avail;
        avail += 8;
      }
    }
    return true;
  }
  bool need16(int n) {
    if (avail < n) {
      if (cp >= ep) {
        if (avail == 0) return false;
        avail = n;
      } else {
        acc |= next() << avail;
        if ((avail += 8) < n) {
          if (cp >= ep) {
            avail = n;
          } else {
            acc |= next() << avail;
            avail += 8;
          }
        }
      }
    }
    return true;
  }
  uint32_t get(int n) const { return acc & ((1u << n) - 1); }
  void clr(int n) {
    avail -= n;
    acc >>= n;
  }
  // the bits to the next byte boundary of the data (RLE rows are byte-aligned)
  void align() { clr(avail & 7); }

  // _TIFFFax3fillruns: white and black runs from x = 0 into a row of bits (black = 1), clipped at lastx
  void fill(uint8_t* row, uint32_t* r, uint32_t* erun) {
    if ((erun - r) & 1) *erun++ = 0;
    long x = 0;
    for (; r < erun; r += 2) {
      for (int k = 0; k < 2; ++k) {
        long run = r[k];
        if (x + run > lastx || run > lastx) run = r[k] = (uint32_t)(lastx - x);
        if (k == 1)
          for (long i = x; i < x + run; ++i) row[i >> 3] |= (uint8_t)(0x80 >> (i & 7));
        x += run;
      }
    }
  }
};

// One row's runs into ``pa``; the outcome: 0 the row ended (maybe cut or padded),
// 1 the data ended (premature EOF), -1 the strip fails (run buffer overflow).
struct FaxRow {
  FaxDecoder& d;
  uint32_t* thisrun;
  uint32_t* pa;
  uint32_t* pb = nullptr;
  long a0 = 0, run_length = 0, b1 = 0;

  bool setvalue(long x) {  // SETVALUE
    if (pa >= thisrun + d.nruns) return false;
    *pa++ = (uint32_t)(run_length + x);
    a0 += x;
    run_length = 0;
    return true;
  }
  bool cleanup() {  // CLEANUP_RUNS
    if (run_length && !setvalue(0)) return false;
    if (a0 != d.lastx) {
      while (a0 > d.lastx && pa > thisrun) a0 -= *--pa;
      if (a0 < d.lastx) {
        if (a0 < 0) a0 = 0;
        if (((pa - thisrun) & 1) && !setvalue(0)) return false;
        if (!setvalue(d.lastx - a0)) return false;
      } else if (a0 > d.lastx) {
        if (!setvalue(d.lastx) || !setvalue(0)) return false;
      }
    }
    return true;
  }
  // one run of ``colour`` (makeup codes, then a terminating code): 0 done, 1 EOL,
  // 2 a bad code word, 3 the data ended, -1 overflow
  int run(bool black) {
    for (;;) {
      int wid = black ? 13 : 12;
      if (!d.need16(wid)) return 3;
      const FaxEnt& e = (black ? d.tab.black : d.tab.white)[d.get(wid)];
      d.clr(e.width);
      switch (e.state) {
        case S_EOL:
          return 1;
        case S_TermW:
        case S_TermB:
          return setvalue(e.param) ? 0 : -1;
        case S_MakeUpW:
        case S_MakeUpB:
        case S_MakeUp:
          a0 += e.param;
          run_length += e.param;
          break;
        default:
          return 2;
      }
    }
  }
  // EXPAND1D: 0 row done, 1 the data ended, -1 fail
  int expand1d() {
    for (;;) {
      int st = run(false);
      if (st == 1) d.eolcnt = 1;
      if (st == 1 || st == 2) return cleanup() ? 0 : -1;
      if (st == 3) return cleanup() ? 1 : -1;
      if (st < 0) return -1;
      if (a0 >= d.lastx) return cleanup() ? 0 : -1;
      st = run(true);
      if (st == 1) d.eolcnt = 1;
      if (st == 1 || st == 2) return cleanup() ? 0 : -1;
      if (st == 3) return cleanup() ? 1 : -1;
      if (st < 0) return -1;
      if (a0 >= d.lastx) return cleanup() ? 0 : -1;
      if (*(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;
    }
  }
  bool check_b1() {  // CHECK_b1
    if (pa != thisrun)
      while (b1 <= a0 && b1 < d.lastx) {
        if (pb + 1 >= d.ref + d.nruns) return false;
        b1 += pb[0] + pb[1];
        pb += 2;
      }
    return true;
  }
  bool step_b1() {
    if (pb >= d.ref + d.nruns) return false;
    b1 += *pb++;
    return true;
  }
  // EXPAND2D against the reference runs ``d.ref``: 0 row done, 1 the data ended, -1 fail
  int expand2d() {
    pb = d.ref;
    b1 = *pb++;
    while (a0 < d.lastx) {
      if (pa >= thisrun + d.nruns) return -1;
      if (!d.need8(7)) return cleanup() ? 1 : -1;
      const FaxEnt& e = d.tab.mode[d.get(7)];
      d.clr(e.width);
      int st;
      switch (e.state) {
        case S_Pass:
          if (!check_b1() || !step_b1()) return -1;
          run_length += b1 - a0;
          a0 = b1;
          if (!step_b1()) return -1;
          break;
        case S_Horiz: {
          bool black_first = (pa - thisrun) & 1;
          st = run(black_first);
          if (st == 0) st = run(!black_first);
          if (st == 1 || st == 2) return cleanup() ? 0 : -1;  // a bad code (an EOL is one here)
          if (st == 3) return cleanup() ? 1 : -1;
          if (st < 0) return -1;
          if (!check_b1()) return -1;
          break;
        }
        case S_V0:
          if (!check_b1() || !setvalue(b1 - a0) || !step_b1()) return -1;
          break;
        case S_VR:
          if (!check_b1() || !setvalue(b1 - a0 + e.param) || !step_b1()) return -1;
          break;
        case S_VL:
          if (!check_b1()) return -1;
          if (b1 < a0 + e.param) return cleanup() ? 0 : -1;
          if (!setvalue(b1 - a0 - e.param)) return -1;
          b1 -= *--pb;
          break;
        case S_Ext:
          *pa++ = (uint32_t)(d.lastx - a0);
          return cleanup() ? 0 : -1;
        case S_EOL:
          *pa++ = (uint32_t)(d.lastx - a0);
          if (!d.need8(4)) return cleanup() ? 1 : -1;
          d.clr(4);
          d.eolcnt = 1;
          return cleanup() ? 0 : -1;
        default:
          return cleanup() ? 0 : -1;
      }
    }
    if (run_length) {
      if (run_length + a0 < d.lastx) {  // expect a final V0
        if (!d.need8(1)) return cleanup() ? 1 : -1;
        if (!d.get(1)) return cleanup() ? 0 : -1;
        d.clr(1);
      }
      if (!setvalue(0)) return -1;
    }
    return cleanup() ? 0 : -1;
  }
};

// SYNC_EOL: past the next EOL (an EOL already met needs only its final 1 bit);
// false where the data ends first
bool fax_sync_eol(FaxDecoder& d) {
  if (d.eolcnt == 0) {
    for (;;) {
      if (!d.need16(11)) return false;
      if (d.get(11) == 0) break;
      d.clr(1);
    }
  }
  for (;;) {
    if (!d.need8(8)) return false;
    if (d.get(8)) break;
    d.clr(8);
  }
  while (d.get(1) == 0) d.clr(1);
  d.clr(1);
  d.eolcnt = 0;
  return true;
}

}  // namespace

extern "C" {

// CCITT-coded strip or tile -> ``rows`` rows of ``width`` bits (black = 1,
// rows of (width + 7) / 8 bytes, ``out`` zeroed by the caller). ``mode``: 2
// RLE (Modified Huffman, byte-aligned rows), 3 Group 3 (``two_d``: T4Options
// bit 0), 4 Group 4; ``lsb_first``: FillOrder 2. Returns 0, or -1 where
// libtiff fails the strip: ``out`` then holds the rows decoded before the
// fault (and the faulty one as libtiff fills it), which is what OpenCV shows,
// as its RGBA reads do not stop on an error.
int tiff_fax_decode(const uint8_t* in, long n, int mode, int two_d, int lsb_first, int width, int rows,
                    uint8_t* out) {
  static const FaxTables tables;
  const bool ref_line = mode == 4 || (mode == 3 && two_d);
  FaxDecoder d(in, n, lsb_first != 0, width, ref_line, tables);
  const long rowbytes = (width + 7) / 8;
  for (int line = 0; line < rows; ++line) {
    uint8_t* row = out + line * rowbytes;
    FaxRow r{d, d.cur, d.cur};
    int st;
    if (mode == 3) {
      if (!fax_sync_eol(d)) return -1;  // the row stays white
      bool one_d = true;
      if (two_d) {
        if (!d.need8(1)) return -1;
        one_d = d.get(1);
        d.clr(1);
      }
      st = one_d ? r.expand1d() : r.expand2d();
    } else {
      st = mode == 2 ? r.expand1d() : r.expand2d();
    }
    if (st < 0) return -1;  // a run buffer overflow: the row is not filled
    d.fill(row, r.thisrun, r.pa);
    if (mode == 2) {
      if (st) return -1;
      d.align();
    } else if (mode == 3) {
      if (st) return -1;
      if (two_d) {
        if (r.pa < r.thisrun + d.nruns) r.setvalue(0);  // imaginary change for reference
        std::swap(d.cur, d.ref);
      }
    } else {
      if (st || d.eolcnt) return line ? 0 : -1;  // EOFB, or the data ended: this row, then no more
      if (!r.setvalue(0)) return -1;
      std::swap(d.cur, d.ref);
    }
  }
  return 0;
}

// BMP RLE8 (rle4 = 0) or RLE4 (rle4 = 1) pixel data -> palette indices
// [height, width] in the order the rows are stored (bottom-up files are
// flipped by the caller). Pixels the stream skips (EOL, EOB, delta) take
// index 0, as OpenCV fills them with the first palette entry. Returns 0, or
// 1 where OpenCV gives up on the data and 2 where the data ends first.
int bmp_rle_decode(const uint8_t* src, long n, int rle4, int width, int height, uint8_t* out) {
  RleState s{out, 0, width, width, height, 0};
  long pos = 0;
  uint8_t buf[256];
  auto get_byte = [&](int& v) {
    if (pos >= n) return false;
    v = src[pos++];
    return true;
  };
  auto get_bytes = [&](uint8_t* dst, int count) {
    if (pos + count > n) return false;
    memcpy(dst, src + pos, count);
    pos += count;
    return true;
  };
  int line_end_flag = 0;
  for (;;) {
    int len, code;
    if (!get_byte(len) || !get_byte(code)) return kEnded;
    if (len != 0) {  // encoded mode
      if (s.data + len > s.line_end) return kBad;
      if (rle4) {
        const uint8_t clr[2] = {(uint8_t)(code >> 4), (uint8_t)(code & 15)};
        const long end = s.data + len;
        int t = 0;
        do {
          out[s.data] = clr[t];
          t ^= 1;
        } while (++s.data < end);
      } else {
        const int prev_y = s.y;
        s.fill(len, (uint8_t)code);
        line_end_flag = s.y - prev_y;
        if (s.y >= height) break;
      }
    } else if (code > 2) {  // absolute mode
      if (s.data + code > s.line_end) return kBad;
      const int sz = rle4 ? (((code + 1) >> 1) + 1) & ~1 : (code + 1) & ~1;
      if (!get_bytes(buf, sz)) return kEnded;
      for (int i = 0; i < code; ++i) out[s.data++] = rle4 ? (i & 1 ? buf[i >> 1] & 15 : buf[i >> 1] >> 4) : buf[i];
      line_end_flag = 0;
    } else if (rle4) {  // end of line, end of bitmap (read on, as OpenCV does) or delta
      long shift = s.line_end - s.data;
      if (code == 2) {
        int dx, dy;
        if (!get_byte(dx) || !get_byte(dy)) return kEnded;
        shift = dx;  // OpenCV's RLE4 ignores the delta's rows
      }
      s.fill(shift, 0);
      if (s.y >= height) break;
    } else {
      long x_shift = s.line_end - s.data;
      long y_shift = height - s.y;
      if (code || !line_end_flag || x_shift < width) {
        if (code == 2) {
          int dx, dy;
          if (!get_byte(dx) || !get_byte(dy)) return kEnded;
          x_shift = dx;
          y_shift = dy;
        }
        if (code) x_shift += y_shift * width;
        if (s.y >= height) break;
        s.fill(x_shift, 0);
        if (s.y >= height) break;
      }
      line_end_flag = 0;
      if (s.y >= height) break;
    }
  }
  return kOk;
}

// TIFF LZW (most significant bit first, the code width growing one code
// early, as libtiff's LZWDecode): the first ``cap`` bytes of the data.
// Returns the number of bytes written, or -kCorrupt / -kOldLzw.
long tiff_lzw_decode(const uint8_t* in, long n, uint8_t* out, long cap) {
  if (n >= 2 && in[0] == 0 && (in[1] & 1)) return -kOldLzw;
  static thread_local std::vector<uint16_t> prefix(4096), length(4096);
  static thread_local std::vector<uint8_t> suffix(4096), first(4096);
  for (int i = 0; i < 256; ++i) suffix[i] = first[i] = (uint8_t)i, length[i] = 1, prefix[i] = 0;
  long pos = 0, written = 0;
  uint64_t bitbuf = 0;
  int bitcnt = 0, nbits = 9, free_ent = 258, old = -1;
  auto read_code = [&](int& code) {
    while (bitcnt < nbits) {
      if (pos >= n) return false;
      bitbuf = (bitbuf << 8) | in[pos++];
      bitcnt += 8;
    }
    bitcnt -= nbits;
    code = (int)((bitbuf >> bitcnt) & ((1u << nbits) - 1));
    return true;
  };
  auto emit = [&](int code) {
    const int len = length[code];
    long at = written + len - 1;
    for (int c = code; c >= 0;) {
      if (at < cap) out[at] = suffix[c];
      --at;
      if (length[c] == 1) break;
      c = prefix[c];
    }
    written += len;
  };
  int code;
  while (written < cap && read_code(code)) {
    if (code == 257) break;
    if (code == 256) {
      free_ent = 258;
      nbits = 9;
      if (!read_code(code) || code == 257) break;
      if (code > 255) return -kCorrupt;
      emit(code);
      old = code;
      continue;
    }
    if (old < 0) {  // no clear code first
      if (code > 255) return -kCorrupt;
      emit(code);
      old = code;
      continue;
    }
    if (code > free_ent || free_ent >= 4096) return -kCorrupt;
    const uint8_t k = code < free_ent ? first[code] : first[old];
    prefix[free_ent] = (uint16_t)old;
    suffix[free_ent] = k;
    first[free_ent] = first[old];
    length[free_ent] = (uint16_t)(length[old] + 1);
    ++free_ent;
    emit(code);
    old = code;
    nbits = free_ent >= 2047 ? 12 : free_ent >= 1023 ? 11 : free_ent >= 511 ? 10 : 9;
  }
  return written < cap ? written : cap;
}

// TIFF LZW encoding of ``n`` bytes into ``out``: the compressed length, or -1
// if ``cap`` is too small.
long tiff_lzw_encode(const uint8_t* in, long n, uint8_t* out, long cap) {
  static thread_local std::vector<int16_t> table(4096 * 256, -1);
  std::vector<int> added;
  long nout = 0;
  uint32_t acc = 0;
  int nacc = 0;
  bool overflow = false;
  auto put = [&](int code, int width) {
    acc = (acc << width) | (uint32_t)code;
    nacc += width;
    while (nacc >= 8) {
      if (nout < cap) out[nout] = (uint8_t)(acc >> (nacc - 8));
      else overflow = true;
      ++nout;
      nacc -= 8;
    }
  };
  auto width_for = [](int next) { return next >= 2048 ? 12 : next >= 1024 ? 11 : next >= 512 ? 10 : 9; };
  auto reset = [&]() {
    for (int k : added) table[k] = -1;
    added.clear();
  };
  int next = 258;
  put(256, 9);
  if (n > 0) {
    int omega = in[0];
    for (long i = 1; i < n; ++i) {
      const int key = (omega << 8) | in[i];
      if (table[key] >= 0) {
        omega = table[key];
        continue;
      }
      put(omega, width_for(next));
      table[key] = (int16_t)next++;
      added.push_back(key);
      omega = in[i];
      if (next >= 4093) {
        put(256, width_for(next));
        reset();
        next = 258;
      }
    }
    put(omega, width_for(next));
    put(257, width_for(next + 1));
  } else {
    put(257, 9);
  }
  reset();
  if (nacc > 0) put(0, 8 - nacc);
  return overflow ? -1 : nout;
}

// Horizontal differencing (predictor 2) undone in place: ``rows`` rows of
// ``width`` pixels of ``spp`` samples, 8-bit (``bits`` 8) or native 16-bit.
void tiff_undo_predictor(void* data, long rows, long width, int spp, int bits) {
  const long row_samples = width * spp;
  for (long r = 0; r < rows; ++r) {
    if (bits == 16) {
      uint16_t* p = static_cast<uint16_t*>(data) + r * row_samples;
      for (long i = spp; i < row_samples; ++i) p[i] = (uint16_t)(p[i] + p[i - spp]);
    } else {
      uint8_t* p = static_cast<uint8_t*>(data) + r * row_samples;
      for (long i = spp; i < row_samples; ++i) p[i] = (uint8_t)(p[i] + p[i - spp]);
    }
  }
}

// PackBits: the first ``cap`` bytes. Returns the number written.
long tiff_packbits_decode(const uint8_t* in, long n, uint8_t* out, long cap) {
  long i = 0, o = 0;
  while (i < n && o < cap) {
    const int b = (int8_t)in[i++];
    if (b >= 0) {
      long count = b + 1;
      if (i + count > n) count = n - i;
      if (o + count > cap) count = cap - o;
      memcpy(out + o, in + i, count);
      i += b + 1;
      o += count;
    } else if (b != -128) {
      if (i >= n) break;
      long count = 1 - b;
      if (o + count > cap) count = cap - o;
      memset(out + o, in[i++], count);
      o += count;
    }
  }
  return o;
}

// ASCII PxM samples as OpenCV's ReadNumber reads them, from ``*pos``: white
// space and ``#`` comments (to the end of the line) skipped before each
// number; with ``single_digit`` (P1) one digit a sample. ``count`` samples
// into ``out``; ``*pos`` is left after the character that ended the last.
// Returns 0, 1 for a character that is no digit, space or comment, 2 where
// the data ends first, 3 for a number above INT_MAX.
int pnm_ascii(const uint8_t* src, long n, long* pos, long count, int single_digit, int32_t* out) {
  long p = *pos;
  auto space = [](int c) { return c == ' ' || (c >= 9 && c <= 13); };
  for (long k = 0; k < count; ++k) {
    if (p >= n) return 2;
    int code = src[p++];
    while (code < '0' || code > '9') {
      if (code == '#') {
        do {
          if (p >= n) return 2;
          code = src[p++];
        } while (code != '\n' && code != '\r');
        if (p >= n) return 2;
        code = src[p++];
      } else if (space(code)) {
        while (space(code)) {
          if (p >= n) return 2;
          code = src[p++];
        }
      } else {
        return 1;
      }
    }
    int64_t val = 0;
    int digits = 0;
    do {
      val = val * 10 + (code - '0');
      if (val > 2147483647) return 3;
      ++digits;
      if (single_digit) break;
      if (p >= n) return 2;  // the stream's getByte throws past the end
      code = src[p++];
    } while (code >= '0' && code <= '9');
    out[k] = (int32_t)val;
  }
  *pos = p;
  return 0;
}

// Radiance RGBE pixels (RGBE_ReadPixels_RLE) -> ``width * height`` RGBE
// quadruples: new-style scanlines (2, 2, width) with each channel run-length
// coded, else flat pixels from the first one that does not start so, as
// rgbe.cpp reads them (old-style run pixels are taken as pixels). Returns 0,
// 1 for bad scanline data or a wrong width, 2 where the data ends first.
int hdr_read_pixels(const uint8_t* src, long n, int width, int height, uint8_t* out) {
  long pos = 0;
  const long total = (long)width * height;
  auto flat = [&](long from) {
    long need = (total - from) * 4;
    if (pos + need > n) return 2;
    memcpy(out + from * 4, src + pos, need);
    return 0;
  };
  if (width < 8 || width > 0x7fff) return flat(0);
  std::vector<uint8_t> line((size_t)width * 4);
  for (int y = 0; y < height; ++y) {
    if (pos + 4 > n) return 2;
    const uint8_t* q = src + pos;
    pos += 4;
    if (q[0] != 2 || q[1] != 2 || (q[2] & 0x80)) {
      memcpy(out + (long)y * width * 4, q, 4);
      return flat((long)y * width + 1);
    }
    if (((q[2] << 8) | q[3]) != width) return 1;
    long at = 0;
    for (int c = 0; c < 4; ++c) {
      const long end = (long)(c + 1) * width;
      while (at < end) {
        if (pos + 2 > n) return 2;
        int count = src[pos], value = src[pos + 1];
        pos += 2;
        if (count > 128) {
          count -= 128;
          if (count > end - at) return 1;
          memset(&line[at], value, count);
          at += count;
        } else {
          if (count == 0 || count > end - at) return 1;
          line[at++] = (uint8_t)value;
          if (--count > 0) {
            if (pos + count > n) return 2;
            memcpy(&line[at], src + pos, count);
            pos += count;
            at += count;
          }
        }
      }
    }
    uint8_t* o = out + (long)y * width * 4;
    for (int x = 0; x < width; ++x)
      for (int c = 0; c < 4; ++c) o[x * 4 + c] = line[(size_t)c * width + x];
  }
  return 0;
}

// GIF LZW (least significant bit first, code sizes from min_size + 1 up to
// 12, a clear and an end code, a full 4,096-entry table kept until the next
// clear) -> up to ``cap`` indices. Returns the number written, or -1 for a
// code that is not yet in the table.
long gif_lzw_decode(const uint8_t* in, long n, int min_size, uint8_t* out, long cap) {
  const int clear = 1 << min_size, end = clear + 1;
  std::vector<uint16_t> prefix(4096);
  std::vector<uint8_t> suffix(4096), stack(4097);
  int size = min_size + 1, next = clear + 2, prev = -1;
  uint8_t first = 0;
  uint32_t acc = 0;
  int nbits = 0;
  long pos = 0, o = 0;
  while (o < cap) {
    while (nbits < size && pos < n) {
      acc |= (uint32_t)in[pos++] << nbits;
      nbits += 8;
    }
    if (nbits < size) break;
    int code = acc & ((1u << size) - 1);
    acc >>= size;
    nbits -= size;
    if (code == clear) {
      size = min_size + 1;
      next = clear + 2;
      prev = -1;
      continue;
    }
    if (code == end) break;
    if (prev < 0) {
      if (code >= clear) return -1;
      out[o++] = first = (uint8_t)code;
      prev = code;
      continue;
    }
    int cur = code, sp = 0;
    if (code >= next) {
      if (code > next) return -1;
      stack[sp++] = first;
      cur = prev;
    }
    while (cur >= clear) {
      stack[sp++] = suffix[cur];
      cur = prefix[cur];
    }
    stack[sp++] = (uint8_t)cur;
    first = (uint8_t)cur;
    while (sp > 0 && o < cap) out[o++] = stack[--sp];
    if (next < 4096) {
      prefix[next] = (uint16_t)prev;
      suffix[next] = first;
      ++next;
      if (next == (1 << size) && size < 12) ++size;
    }
    prev = code;
  }
  return o;
}

}  // extern "C"
