// The loops of the BMP and TIFF readers and writers that numpy cannot
// vectorise: BMP's RLE8 and RLE4 as OpenCV 5.0's decoder runs them
// (grfmt_bmp.cpp), and TIFF's LZW (as libtiff decodes and encodes it),
// PackBits and horizontal differencing.

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

}  // namespace

extern "C" {

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

}  // extern "C"
