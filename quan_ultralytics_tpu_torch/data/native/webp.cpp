// WebP bitstreams without libwebp: the lossless VP8L decoder and encoder and
// the lossy VP8 key-frame decoder, with libwebp's arithmetic so that the
// pixels equal those OpenCV 5.0 reads through libwebp (WebPDecodeBGRInto).
//
// * VP8L (RFC 9649): simple and normal prefix codes, meta prefix codes (the
//   entropy image), LZ77 with the 120-entry distance map, the colour cache,
//   and the predictor (14 modes), cross-colour, subtract-green and
//   colour-indexing (with pixel bundling) transforms. Output ARGB.
// * VP8 (RFC 6386), key frames: the boolean decoder and frame header,
//   segments, 1/2/4/8 token partitions, coefficient probability updates,
//   intra 16x16, B_PRED 4x4 and chroma prediction with libwebp's borders
//   (127 above, 129 left, the top-right pixels replicated down the last
//   column), libwebp's dequantisation clamps, inverse WHT and DCT, the simple
//   and normal loop filters, then libwebp's "fancy" 4:2:0 upsampler and its
//   14-bit YUV->RGB conversion. Output RGB, cropped to the picture.
// * The encoder writes VP8L: a predictor transform (one mode for the whole
//   image), subtract-green, prefix codes built from the histograms and
//   limited to 15 bits, and runs of equal pixels as distance-1 copies.
//
// The constant tables are in webp_tables.h.

#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <vector>

#include "webp_tables.h"

namespace {

enum Status {
  kOk = 0,
  kEndOfData = 1,
  kBadCode = 2,
  kBadCopy = 3,
  kBadTransform = 4,
  kNotKeyFrame = 5,
  kBadFrameHeader = 6,
  kBadLosslessHeader = 7,
  kBadPartitions = 8,
  kBadCacheBits = 9,
  kBadSize = 10,
};

// ================================================================ VP8L

struct LBits {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;        // next byte to load
  uint64_t val = 0;      // unread bits, least significant first
  int nbits = 0;
  uint64_t consumed = 0; // bits consumed in all
  LBits(const uint8_t* d, size_t n) : data(d), size(n) {}
  void fill() {
    while (nbits <= 56) {
      const uint64_t b = pos < size ? data[pos] : 0;
      ++pos;
      val |= b << nbits;
      nbits += 8;
    }
  }
  uint32_t peek(int n) {
    if (nbits < n) fill();
    return (uint32_t)(val & ((1ull << n) - 1));
  }
  void skip(int n) {
    val >>= n;
    nbits -= n;
    consumed += n;
  }
  uint32_t read(int n) {
    if (n == 0) return 0;
    const uint32_t v = peek(n);
    skip(n);
    return v;
  }
  bool eos() const { return consumed > 8ull * size; }
};

const int kMaxLen = 15;
const int kTableBits = 10;

static uint32_t reverse_bits(uint32_t code, int len) {
  uint32_t r = 0;
  for (int i = 0; i < len; ++i) r |= ((code >> i) & 1u) << (len - 1 - i);
  return r;
}

// A canonical prefix code: a table of the first kTableBits bits read, and a
// canonical walk for the longer codes.
struct PrefixCode {
  int single = -1;                // the one symbol of a zero-bit code
  std::vector<int32_t> table;     // (symbol << 4) | length, or -1 for longer codes
  int count[kMaxLen + 1] = {0};
  std::vector<int> sorted;        // symbols by (length, value)

  // libwebp's VP8LBuildHuffmanTable: false unless the lengths make a complete
  // code, or exactly one symbol has a length.
  bool build(const int* lengths, int n) {
    sorted.clear();
    for (int l = 0; l <= kMaxLen; ++l) count[l] = 0;
    for (int s = 0; s < n; ++s) {
      if (lengths[s] > kMaxLen || lengths[s] < 0) return false;
      ++count[lengths[s]];
    }
    count[0] = 0;
    for (int l = 1; l <= kMaxLen; ++l)
      for (int s = 0; s < n; ++s)
        if (lengths[s] == l) sorted.push_back(s);
    if (sorted.empty()) return false;
    if (sorted.size() == 1) {
      single = sorted[0];
      return true;
    }
    int left = 1;
    for (int l = 1; l <= kMaxLen; ++l) {
      left <<= 1;
      left -= count[l];
      if (left < 0) return false;
    }
    if (left != 0) return false;
    table.assign(1 << kTableBits, -1);
    uint32_t code = 0;
    size_t k = 0;
    for (int l = 1; l <= kMaxLen; ++l) {
      for (int i = 0; i < count[l]; ++i, ++k, ++code) {
        if (l > kTableBits) continue;
        const uint32_t r = reverse_bits(code, l);
        for (uint32_t j = r; j < (1u << kTableBits); j += 1u << l)
          table[j] = (sorted[k] << 4) | l;
      }
      code <<= 1;
    }
    return true;
  }

  int decode(LBits& br) const {
    if (single >= 0) return single;
    const uint32_t bits = br.peek(kMaxLen);
    const int32_t e = table[bits & ((1u << kTableBits) - 1)];
    if (e >= 0) {
      br.skip(e & 15);
      return e >> 4;
    }
    int code = 0, first = 0, index = 0;
    for (int l = 1; l <= kMaxLen; ++l) {
      code |= (bits >> (l - 1)) & 1;
      const int c = count[l];
      if (code - c < first) {
        br.skip(l);
        return sorted[index + (code - first)];
      }
      index += c;
      first += c;
      first <<= 1;
      code <<= 1;
    }
    br.skip(kMaxLen);
    return 0;
  }
};

const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

static int read_code_lengths(LBits& br, const int* cl_lengths, int num_symbols, int* lengths) {
  PrefixCode cl;
  if (!cl.build(cl_lengths, 19)) return kBadCode;
  int max_symbol = num_symbols;
  if (br.read(1)) {
    const int length_nbits = 2 + 2 * br.read(3);
    max_symbol = 2 + br.read(length_nbits);
    if (max_symbol > num_symbols) return kBadCode;
  }
  int symbol = 0, prev = 8;
  while (symbol < num_symbols) {
    if (max_symbol-- == 0) break;
    const int len = cl.decode(br);
    if (len < 16) {
      lengths[symbol++] = len;
      if (len) prev = len;
    } else {
      const int slot = len - 16;
      static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
      const int repeat = br.read(extra[slot]) + offset[slot];
      if (symbol + repeat > num_symbols) return kBadCode;
      const int v = slot == 0 ? prev : 0;
      for (int i = 0; i < repeat; ++i) lengths[symbol++] = v;
    }
  }
  return br.eos() ? kEndOfData : kOk;
}

static int read_prefix_code(LBits& br, int alphabet, PrefixCode& out) {
  std::vector<int> lengths(std::max(alphabet, 256), 0);
  if (br.read(1)) {  // simple code
    const int num = br.read(1) + 1;
    const int first_bits = br.read(1) ? 8 : 1;
    lengths[br.read(first_bits)] = 1;
    if (num == 2) lengths[br.read(8)] = 1;
  } else {
    int cl_lengths[19] = {0};
    const int num_codes = br.read(4) + 4;
    for (int i = 0; i < num_codes; ++i) cl_lengths[kCodeLengthOrder[i]] = br.read(3);
    const int st = read_code_lengths(br, cl_lengths, alphabet, lengths.data());
    if (st) return st;
  }
  if (br.eos()) return kEndOfData;
  return out.build(lengths.data(), alphabet) ? kOk : kBadCode;
}

struct Group {
  PrefixCode code[5];  // green+lengths+cache, red, blue, alpha, distance
};

static int read_group(LBits& br, int cache_size, Group& g) {
  const int sizes[5] = {256 + 24 + cache_size, 256, 256, 256, 40};
  for (int i = 0; i < 5; ++i) {
    const int st = read_prefix_code(br, sizes[i], g.code[i]);
    if (st) return st;
  }
  return kOk;
}

static int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

static int prefix_value(int symbol, LBits& br) {
  if (symbol < 4) return symbol + 1;
  const int extra = (symbol - 2) >> 1;
  const int offset = (2 + (symbol & 1)) << extra;
  return offset + (int)br.read(extra) + 1;
}

static int plane_to_distance(int xsize, int code) {
  if (code > 120) return code - 120;
  const int d = kCodeToPlane[code - 1];
  const int dist = (d >> 4) * xsize + (8 - (d & 15));
  return dist >= 1 ? dist : 1;
}

static int decode_image(LBits& br, int xsize, int ysize, bool level0, std::vector<uint32_t>& out);

// The entropy-coded pixels of an xsize x ysize image.
static int decode_pixels(LBits& br, int xsize, int ysize, int cache_bits, const std::vector<Group>& groups,
                         const std::vector<uint32_t>& meta, int meta_bits, std::vector<uint32_t>& out) {
  const size_t total = (size_t)xsize * ysize;
  out.assign(total, 0);
  const int cache_size = cache_bits ? 1 << cache_bits : 0;
  std::vector<uint32_t> cache(cache_size ? cache_size : 1, 0);
  const int meta_xsize = meta_bits ? subsample(xsize, meta_bits) : 0;
  size_t pos = 0, cached = 0;
  int x = 0, y = 0;
  while (pos < total) {
    const Group& g = meta_bits ? groups[(meta[(size_t)meta_xsize * (y >> meta_bits) + (x >> meta_bits)] >> 8) & 0xffff]
                               : groups[0];
    const int code = g.code[0].decode(br);
    if (code < 256) {
      const uint32_t r = g.code[1].decode(br);
      const uint32_t b = g.code[2].decode(br);
      const uint32_t a = g.code[3].decode(br);
      out[pos++] = (a << 24) | (r << 16) | ((uint32_t)code << 8) | b;
      if (++x >= xsize) x = 0, ++y;
    } else if (code < 256 + 24) {
      const int length = prefix_value(code - 256, br);
      const int dist = plane_to_distance(xsize, prefix_value(g.code[4].decode(br), br));
      if (br.eos()) return kEndOfData;
      if ((size_t)dist > pos || total - pos < (size_t)length) return kBadCopy;
      for (int i = 0; i < length; ++i, ++pos) out[pos] = out[pos - dist];
      x += length;
      while (x >= xsize) x -= xsize, ++y;
    } else if (code < 256 + 24 + cache_size) {
      for (; cached < pos; ++cached) cache[(0x1e35a7bdu * out[cached]) >> (32 - cache_bits)] = out[cached];
      out[pos++] = cache[code - 256 - 24];
      if (++x >= xsize) x = 0, ++y;
    } else {
      return kBadCode;
    }
    if (br.eos()) return kEndOfData;
    if (cache_size)
      for (; cached < pos; ++cached) cache[(0x1e35a7bdu * out[cached]) >> (32 - cache_bits)] = out[cached];
  }
  return kOk;
}

// An entropy-coded image without transforms: a sub-image (level0 false) or
// the main image's data once its transforms have been read.
static int decode_image(LBits& br, int xsize, int ysize, bool level0, std::vector<uint32_t>& out) {
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = br.read(4);
    if (cache_bits < 1 || cache_bits > 11) return kBadCacheBits;
  }
  std::vector<uint32_t> meta;
  int meta_bits = 0, num_groups = 1;
  if (level0 && br.read(1)) {
    meta_bits = br.read(3) + 2;
    const int st = decode_image(br, subsample(xsize, meta_bits), subsample(ysize, meta_bits), false, meta);
    if (st) return st;
    for (uint32_t m : meta) num_groups = std::max(num_groups, (int)((m >> 8) & 0xffff) + 1);
  }
  if (br.eos()) return kEndOfData;
  std::vector<Group> groups(num_groups);
  for (auto& g : groups) {
    const int st = read_group(br, cache_bits ? 1 << cache_bits : 0, g);
    if (st) return st;
  }
  return decode_pixels(br, xsize, ysize, cache_bits, groups, meta, meta_bits, out);
}

static inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
static inline uint32_t sub_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = 0x00ff00ffu + (a & 0xff00ff00u) - (b & 0xff00ff00u);
  const uint32_t rb = 0xff00ff00u + (a & 0x00ff00ffu) - (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
static inline uint32_t average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }
static inline int clip255(int a) { return a < 0 ? 0 : a > 255 ? 255 : a; }
static inline int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }
static inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {  // a = T, b = L, c = TL
  const int d = sub3(a >> 24, b >> 24, c >> 24) + sub3((a >> 16) & 255, (b >> 16) & 255, (c >> 16) & 255) +
                sub3((a >> 8) & 255, (b >> 8) & 255, (c >> 8) & 255) + sub3(a & 255, b & 255, c & 255);
  return d <= 0 ? a : b;
}
static inline uint32_t clamp_add_sub_full(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= (uint32_t)clip255((int)((a >> s) & 255) + (int)((b >> s) & 255) - (int)((c >> s) & 255)) << s;
  return out;
}
static inline uint32_t clamp_add_sub_half(uint32_t a, uint32_t b) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int x = (a >> s) & 255, y = (b >> s) & 255;
    out |= (uint32_t)clip255(x + (x - y) / 2) << s;
  }
  return out;
}

// The prediction of mode ``mode`` from the left, top, top-left and
// top-right pixels.
static inline uint32_t predict(int mode, uint32_t L, uint32_t T, uint32_t TL, uint32_t TR) {
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: return select_pred(T, L, TL);
    case 12: return clamp_add_sub_full(L, T, TL);
    case 13: return clamp_add_sub_half(average2(L, T), TL);
    default: return 0xff000000u;  // 0, and 14 and 15 as libwebp takes them
  }
}

struct Transform {
  int type, bits, xsize, ysize;
  std::vector<uint32_t> data;
};

static void inverse_transform(const Transform& t, const std::vector<uint32_t>& in, std::vector<uint32_t>& out) {
  const int w = t.xsize, h = t.ysize;
  if (t.type == 0) {  // predictor, in place in raster order
    out = in;
    const int tiles = subsample(w, t.bits);
    for (int y = 0; y < h; ++y) {
      uint32_t* row = out.data() + (size_t)y * w;
      const uint32_t* up = row - w;
      for (int x = 0; x < w; ++x) {
        int mode;
        if (y == 0) mode = x == 0 ? 0 : 1;
        else if (x == 0) mode = 2;
        else mode = (t.data[(size_t)(y >> t.bits) * tiles + (x >> t.bits)] >> 8) & 15;
        const uint32_t L = x ? row[x - 1] : 0, T = y ? up[x] : 0;
        const uint32_t TL = (x && y) ? up[x - 1] : 0, TR = y ? up[x + 1] : 0;  // up[w] is this row's first pixel
        row[x] = add_pixels(row[x], predict(mode, L, T, TL, TR));
      }
    }
  } else if (t.type == 1) {  // cross-colour
    out = in;
    const int tiles = subsample(w, t.bits);
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const uint32_t m = t.data[(size_t)(y >> t.bits) * tiles + (x >> t.bits)];
        const int8_t g2r = (int8_t)(m & 255), g2b = (int8_t)((m >> 8) & 255), r2b = (int8_t)((m >> 16) & 255);
        uint32_t& p = out[(size_t)y * w + x];
        const int8_t green = (int8_t)(p >> 8);
        int red = (p >> 16) & 255, blue = p & 255;
        red = (red + (((int)g2r * green) >> 5)) & 255;
        blue += ((int)g2b * green) >> 5;
        blue += ((int)r2b * (int8_t)red) >> 5;
        p = (p & 0xff00ff00u) | ((uint32_t)red << 16) | (uint32_t)(blue & 255);
      }
  } else if (t.type == 2) {  // subtract green
    out = in;
    for (uint32_t& p : out) {
      const uint32_t g = (p >> 8) & 255;
      p = (p & 0xff00ff00u) | ((((p >> 16) + g) & 255) << 16) | (((p & 255) + g) & 255);
    }
  } else {  // colour indexing
    out.assign((size_t)w * h, 0);
    const int bits_per_pixel = 8 >> t.bits, per_byte = 1 << t.bits;
    const int in_w = subsample(w, t.bits);
    const uint32_t mask = (1u << bits_per_pixel) - 1;
    for (int y = 0; y < h; ++y) {
      uint32_t packed = 0;
      const uint32_t* src = in.data() + (size_t)y * in_w;
      for (int x = 0; x < w; ++x) {
        if ((x & (per_byte - 1)) == 0) packed = (*src++ >> 8) & 255;
        out[(size_t)y * w + x] = t.data[packed & mask];
        packed >>= bits_per_pixel;
      }
    }
  }
}

static int vp8l_decode_argb(const uint8_t* data, size_t n, int want_w, int want_h, std::vector<uint32_t>& argb) {
  if (n < 5 || data[0] != 0x2f) return kBadLosslessHeader;
  LBits br(data + 1, n - 1);
  const int w = br.read(14) + 1, h = br.read(14) + 1;
  br.read(1);  // alpha_is_used: a hint only
  if (br.read(3) != 0) return kBadLosslessHeader;
  if (w != want_w || h != want_h) return kBadSize;
  std::vector<Transform> transforms;
  int xsize = w;
  unsigned seen = 0;
  while (br.read(1)) {
    Transform t;
    t.type = br.read(2);
    if (seen & (1u << t.type)) return kBadTransform;
    seen |= 1u << t.type;
    t.xsize = xsize;
    t.ysize = h;
    t.bits = 0;
    if (t.type == 0 || t.type == 1) {
      t.bits = br.read(3) + 2;
      const int st = decode_image(br, subsample(xsize, t.bits), subsample(h, t.bits), false, t.data);
      if (st) return st;
    } else if (t.type == 3) {
      const int num_colors = br.read(8) + 1;
      t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
      xsize = subsample(xsize, t.bits);
      std::vector<uint32_t> pal;
      const int st = decode_image(br, num_colors, 1, false, pal);
      if (st) return st;
      t.data.assign((size_t)1 << (8 >> t.bits), 0);
      t.data[0] = pal[0];
      for (int i = 1; i < num_colors; ++i) t.data[i] = add_pixels(pal[i], t.data[i - 1]);
    }
    transforms.push_back(std::move(t));
  }
  std::vector<uint32_t> img;
  const int st = decode_image(br, xsize, h, true, img);
  if (st) return st;
  for (int i = (int)transforms.size() - 1; i >= 0; --i) {
    std::vector<uint32_t> next;
    inverse_transform(transforms[i], img, next);
    img.swap(next);
  }
  argb.swap(img);
  return kOk;
}

// ---------------------------------------------------------------- VP8L encoder

struct BitWriter {
  std::vector<uint8_t> out;
  uint64_t acc = 0;
  int n = 0;
  void put(uint32_t v, int bits) {
    if (bits == 0) return;
    acc |= (uint64_t)v << n;
    n += bits;
    while (n >= 8) {
      out.push_back((uint8_t)acc);
      acc >>= 8;
      n -= 8;
    }
  }
  void flush() {
    if (n) out.push_back((uint8_t)acc);
    acc = 0;
    n = 0;
  }
};

// Code lengths of a Huffman code for ``counts`` limited to ``limit`` bits:
// small counts are raised until the tree is shallow enough.
static std::vector<int> code_lengths(const std::vector<uint32_t>& counts, int limit) {
  const int n = (int)counts.size();
  std::vector<int> lengths(n, 0);
  std::vector<int> used;
  for (int i = 0; i < n; ++i)
    if (counts[i]) used.push_back(i);
  if (used.size() <= 1) {
    for (int i : used) lengths[i] = 1;
    return lengths;
  }
  for (uint32_t floor_count = 1;; floor_count *= 2) {
    // nodes: (weight, index); leaves first, then internal nodes
    std::vector<uint64_t> weight;
    std::vector<int> parent;
    for (int i : used) weight.push_back(std::max<uint64_t>(counts[i], floor_count)), parent.push_back(-1);
    std::vector<int> order(used.size());
    for (size_t i = 0; i < order.size(); ++i) order[i] = (int)i;
    std::sort(order.begin(), order.end(), [&](int a, int b) { return weight[a] < weight[b] || (weight[a] == weight[b] && a < b); });
    // two-queue Huffman construction
    std::vector<int> internal;
    size_t li = 0, ii = 0;
    auto pop = [&]() {
      if (li < order.size() && (ii >= internal.size() || weight[order[li]] <= weight[internal[ii]])) return order[li++];
      return internal[ii++];
    };
    for (size_t k = 0; k + 1 < used.size(); ++k) {
      const int a = pop(), b = pop();
      weight.push_back(weight[a] + weight[b]);
      parent.push_back(-1);
      parent[a] = parent[b] = (int)weight.size() - 1;
      internal.push_back((int)weight.size() - 1);
    }
    int deepest = 0;
    std::vector<int> depth(weight.size(), 0);
    for (int i = (int)weight.size() - 2; i >= 0; --i) {
      depth[i] = depth[parent[i]] + 1;
      if (i < (int)used.size()) deepest = std::max(deepest, depth[i]);
    }
    if (deepest <= limit) {
      for (size_t k = 0; k < used.size(); ++k) lengths[used[k]] = depth[k];
      return lengths;
    }
  }
}

// Canonical codes (bit-reversed, to be written least significant bit first).
static std::vector<uint32_t> canonical_codes(const std::vector<int>& lengths) {
  std::vector<uint32_t> codes(lengths.size(), 0);
  int count[kMaxLen + 2] = {0};
  for (int l : lengths) ++count[l];
  count[0] = 0;
  uint32_t next[kMaxLen + 2] = {0}, code = 0;
  for (int l = 1; l <= kMaxLen; ++l) {
    code = (code + count[l - 1]) << 1;
    next[l] = code;
  }
  for (size_t s = 0; s < lengths.size(); ++s)
    if (lengths[s]) codes[s] = reverse_bits(next[lengths[s]]++, lengths[s]);
  return codes;
}

struct EncCode {
  std::vector<int> lengths;
  std::vector<uint32_t> codes;
  bool zero_bits = false;  // one symbol: written with no bits
  void put(BitWriter& bw, int s) const {
    if (!zero_bits) bw.put(codes[s], lengths[s]);
  }
};

// Write a prefix code for ``counts`` and return it for the symbols.
static EncCode write_code(BitWriter& bw, const std::vector<uint32_t>& counts) {
  EncCode c;
  c.lengths = code_lengths(counts, kMaxLen);
  int used = 0, last = 0;
  for (size_t i = 0; i < counts.size(); ++i)
    if (c.lengths[i]) ++used, last = (int)i;
  if (used <= 1 && last < 256) {  // simple code, one symbol of 1 or 8 bits, read with no bits
    bw.put(1, 1);
    bw.put(0, 1);
    if (last < 2) {
      bw.put(0, 1);
      bw.put(last, 1);
    } else {
      bw.put(1, 1);
      bw.put(last, 8);
    }
    c.zero_bits = true;
    return c;
  }
  c.codes = canonical_codes(c.lengths);
  // the lengths as code-length symbols: 0..15, 17 (3-10 zeros), 18 (11-138 zeros)
  std::vector<int> syms, extra;
  const int n = (int)counts.size();
  for (int i = 0; i < n;) {
    if (c.lengths[i] == 0) {
      int run = 0;
      while (i + run < n && c.lengths[i + run] == 0 && run < 138) ++run;
      if (run >= 11) {
        syms.push_back(18), extra.push_back(run - 11);
        i += run;
        continue;
      }
      if (run >= 3) {
        syms.push_back(17), extra.push_back(run - 3);
        i += run;
        continue;
      }
    }
    syms.push_back(c.lengths[i++]), extra.push_back(0);
  }
  std::vector<uint32_t> cl_counts(19, 0);
  for (int s : syms) ++cl_counts[s];
  std::vector<int> cl_lengths = code_lengths(cl_counts, 7);
  int cl_used = 0;
  for (int l : cl_lengths) cl_used += l > 0;
  std::vector<uint32_t> cl_codes = canonical_codes(cl_lengths);
  int num_codes = 4;
  for (int i = 0; i < 19; ++i)
    if (cl_lengths[kCodeLengthOrder[i]]) num_codes = std::max(num_codes, i + 1);
  bw.put(0, 1);
  bw.put(num_codes - 4, 4);
  for (int i = 0; i < num_codes; ++i) bw.put(cl_lengths[kCodeLengthOrder[i]], 3);
  bw.put(0, 1);  // every symbol's length follows
  for (size_t k = 0; k < syms.size(); ++k) {
    if (cl_used > 1) bw.put(cl_codes[syms[k]], cl_lengths[syms[k]]);
    if (syms[k] == 17) bw.put(extra[k], 3);
    if (syms[k] == 18) bw.put(extra[k], 7);
  }
  if (used == 1) c.zero_bits = true;
  return c;
}

static void prefix_encode(int value, int* symbol, int* nextra, int* extra) {
  const int d = value - 1;
  if (d < 4) {
    *symbol = d, *nextra = 0, *extra = 0;
    return;
  }
  int hb = 31 - __builtin_clz((unsigned)d);
  const int second = (d >> (hb - 1)) & 1;
  *nextra = hb - 1;
  *extra = d & ((1 << *nextra) - 1);
  *symbol = 2 * hb + second;
}

// The entropy-coded data of ``px`` (no colour cache, one group): literals,
// and runs of a repeated pixel as copies at distance 1 (plane code 2).
static void write_pixels(BitWriter& bw, const std::vector<uint32_t>& px, bool level0) {
  struct Token { uint32_t value; int length; };
  std::vector<Token> tokens;
  for (size_t i = 0; i < px.size();) {
    size_t run = 0;
    if (i > 0)
      while (i + run < px.size() && px[i + run] == px[i - 1] && run < 4096) ++run;
    if (run >= 3) {
      tokens.push_back({0, (int)run});
      i += run;
    } else {
      tokens.push_back({px[i], 0});
      ++i;
    }
  }
  std::vector<uint32_t> counts[5] = {std::vector<uint32_t>(280, 0), std::vector<uint32_t>(256, 0),
                                     std::vector<uint32_t>(256, 0), std::vector<uint32_t>(256, 0),
                                     std::vector<uint32_t>(40, 0)};
  int sym, nextra, extra;
  for (const Token& t : tokens) {
    if (t.length) {
      prefix_encode(t.length, &sym, &nextra, &extra);
      ++counts[0][256 + sym];
      ++counts[4][1];  // plane code 2: the pixel to the left
    } else {
      ++counts[0][(t.value >> 8) & 255];
      ++counts[1][(t.value >> 16) & 255];
      ++counts[2][t.value & 255];
      ++counts[3][t.value >> 24];
    }
  }
  bw.put(0, 1);               // no colour cache
  if (level0) bw.put(0, 1);   // no meta prefix codes
  EncCode codes[5];
  for (int i = 0; i < 5; ++i) codes[i] = write_code(bw, counts[i]);
  for (const Token& t : tokens) {
    if (t.length) {
      prefix_encode(t.length, &sym, &nextra, &extra);
      codes[0].put(bw, 256 + sym);
      bw.put(extra, nextra);
      codes[4].put(bw, 1);
    } else {
      codes[0].put(bw, (t.value >> 8) & 255);
      codes[1].put(bw, (t.value >> 16) & 255);
      codes[2].put(bw, t.value & 255);
      codes[3].put(bw, t.value >> 24);
    }
  }
}

// ================================================================ VP8

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

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

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
#define AVG3(a, b, c) ((uint8_t)(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) (((a) + (b) + 1) >> 1)
#define DST(x, y) dst[(x) + (y) * BPS]

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
      const uint8_t v[4] = {AVG3(X, A, B), AVG3(A, B, C), AVG3(B, C, D), AVG3(C, D, E)};
      for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, v, 4);
      break;
    }
    case B_HE_PRED:
      memset(dst, AVG3(X, I, J), 4);
      memset(dst + BPS, AVG3(I, J, K), 4);
      memset(dst + 2 * BPS, AVG3(J, K, L), 4);
      memset(dst + 3 * BPS, AVG3(K, L, L), 4);
      break;
    case B_RD_PRED:
      DST(0, 3) = AVG3(J, K, L);
      DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
      DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
      DST(3, 0) = AVG3(D, C, B);
      break;
    case B_LD_PRED:
      DST(0, 0) = AVG3(A, B, C);
      DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
      DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
      DST(3, 3) = AVG3(G, H, H);
      break;
    case B_VR_PRED:
      DST(0, 0) = DST(1, 2) = AVG2(X, A);
      DST(1, 0) = DST(2, 2) = AVG2(A, B);
      DST(2, 0) = DST(3, 2) = AVG2(B, C);
      DST(3, 0) = AVG2(C, D);
      DST(0, 3) = AVG3(K, J, I);
      DST(0, 2) = AVG3(J, I, X);
      DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
      DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
      DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
      DST(3, 1) = AVG3(B, C, D);
      break;
    case B_VL_PRED:
      DST(0, 0) = AVG2(A, B);
      DST(1, 0) = DST(0, 2) = AVG2(B, C);
      DST(2, 0) = DST(1, 2) = AVG2(C, D);
      DST(3, 0) = DST(2, 2) = AVG2(D, E);
      DST(0, 1) = AVG3(A, B, C);
      DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
      DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
      DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
      DST(3, 2) = AVG3(E, F, G);
      DST(3, 3) = AVG3(F, G, H);
      break;
    case B_HD_PRED:
      DST(0, 0) = DST(2, 1) = AVG2(I, X);
      DST(0, 1) = DST(2, 2) = AVG2(J, I);
      DST(0, 2) = DST(2, 3) = AVG2(K, J);
      DST(0, 3) = AVG2(L, K);
      DST(3, 0) = AVG3(A, B, C);
      DST(2, 0) = AVG3(X, A, B);
      DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
      DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
      DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
      DST(1, 3) = AVG3(L, K, J);
      break;
    case B_HU_PRED:
      DST(0, 0) = AVG2(I, J);
      DST(2, 0) = DST(0, 1) = AVG2(J, K);
      DST(2, 1) = DST(0, 2) = AVG2(K, L);
      DST(1, 0) = AVG3(I, J, K);
      DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
      DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
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

// ---------------------------------------------------------------- frame

struct VP8Frame {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  // headers
  int use_segment = 0, update_map = 0, absolute_delta = 1;
  int quantizer[4] = {0}, filter_strength[4] = {0};
  uint8_t segment_probs[3] = {255, 255, 255};
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
  int filter_type = 0;
  int num_parts = 1;
  BoolDecoder br, parts[8];
  int y1_mat[4][2], y2_mat[4][2], uv_mat[4][2];
  uint8_t proba[4][8][3][11];
  int use_skip_proba = 0, skip_p = 0;
  FInfo fstrengths[4][2];
};

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
// position after the last non-zero coefficient (16 if the block is full).
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

// libwebp's ParseResiduals; returns whether the macroblock has no non-zero
// coefficient (after the WHT).
static int parse_residuals(VP8Frame& f, BoolDecoder& br, MBData& mb, NZ& top, NZ& left) {
  const int seg = mb.segment;
  int16_t* dst = mb.coeffs;
  memset(dst, 0, sizeof(mb.coeffs));
  int first;
  const uint8_t(*ac_proba)[3][11];
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  if (!mb.is_i4x4) {
    int16_t dc[16] = {0};
    const int ctx = top.nz_dc + left.nz_dc;
    const int nz = get_coeffs(br, f.proba[1], ctx, f.y2_mat[seg], 0, dc);
    top.nz_dc = left.nz_dc = nz > 0;
    inverse_wht(dc, dst);
    first = 1;
    ac_proba = f.proba[0];
  } else {
    first = 0;
    ac_proba = f.proba[3];
  }
  uint32_t tnz = top.nz & 0x0f, lnz = left.nz & 0x0f;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    uint32_t nz_coeffs = 0;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + (tnz & 1);
      const int nz = get_coeffs(br, ac_proba, ctx, f.y1_mat[seg], first, dst);
      l = nz > first;
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
        const int nz = get_coeffs(br, f.proba[2], ctx, f.uv_mat[seg], 0, dst);
        l = nz > 0;
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
  return !(non_zero_y | non_zero_uv);
}

static void parse_intra_mode(VP8Frame& f, MBData& mb, uint8_t* top, uint8_t* left) {
  BoolDecoder& br = f.br;
  if (f.update_map)
    mb.segment = !br.bit(f.segment_probs[0]) ? br.bit(f.segment_probs[1]) : br.bit(f.segment_probs[2]) + 2;
  else
    mb.segment = 0;
  mb.skip = f.use_skip_proba ? br.bit(f.skip_p) : 0;
  mb.is_i4x4 = !br.bit(145);
  if (!mb.is_i4x4) {
    const int ymode = br.bit(156) ? (br.bit(128) ? TM_PRED : H_PRED) : (br.bit(163) ? V_PRED : DC_PRED);
    mb.imodes[0] = ymode;
    memset(top, ymode, 4);
    memset(left, ymode, 4);
  } else {
    uint8_t* modes = mb.imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* prob = kBModesProba + (top[x] * 10 + ymode) * 9;
        if (!br.bit(prob[0])) ymode = B_DC_PRED;
        else if (!br.bit(prob[1])) ymode = B_TM_PRED;
        else if (!br.bit(prob[2])) ymode = B_VE_PRED;
        else if (!br.bit(prob[3])) ymode = !br.bit(prob[4]) ? B_HE_PRED : (!br.bit(prob[5]) ? B_RD_PRED : B_VR_PRED);
        else if (!br.bit(prob[6])) ymode = B_LD_PRED;
        else if (!br.bit(prob[7])) ymode = B_VL_PRED;
        else ymode = !br.bit(prob[8]) ? B_HD_PRED : B_HU_PRED;
        top[x] = ymode;
      }
      memcpy(modes, top, 4);
      modes += 4;
      left[y] = ymode;
    }
  }
  mb.uvmode = !br.bit(142) ? DC_PRED : !br.bit(114) ? V_PRED : br.bit(183) ? TM_PRED : H_PRED;
}

static int parse_headers(VP8Frame& f, const uint8_t* data, size_t n) {
  if (n < 10) return kEndOfData;
  const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
  const int key_frame = !(bits & 1), profile = (bits >> 1) & 7, show = (bits >> 4) & 1;
  const uint32_t part0 = bits >> 5;
  if (!key_frame) return kNotKeyFrame;
  if (profile > 3 || !show) return kBadFrameHeader;
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return kBadFrameHeader;
  f.width = ((data[7] << 8) | data[6]) & 0x3fff;
  f.height = ((data[9] << 8) | data[8]) & 0x3fff;
  const uint8_t* buf = data + 10;
  size_t size = n - 10;
  if (part0 > size) return kEndOfData;
  f.br.init(buf, part0);
  buf += part0;
  size -= part0;
  BoolDecoder& br = f.br;
  br.value_bits(1);  // colour space
  br.value_bits(1);  // clamping type
  // segment header
  f.use_segment = br.bit(0x80);
  if (f.use_segment) {
    f.update_map = br.bit(0x80);
    if (br.bit(0x80)) {
      f.absolute_delta = br.bit(0x80);
      for (int s = 0; s < 4; ++s) f.quantizer[s] = br.bit(0x80) ? br.signed_value(7) : 0;
      for (int s = 0; s < 4; ++s) f.filter_strength[s] = br.bit(0x80) ? br.signed_value(6) : 0;
    }
    if (f.update_map)
      for (int s = 0; s < 3; ++s) f.segment_probs[s] = br.bit(0x80) ? br.value_bits(8) : 255;
  }
  if (br.eof) return kBadFrameHeader;
  // filter header
  f.simple = br.bit(0x80);
  f.level = br.value_bits(6);
  f.sharpness = br.value_bits(3);
  f.use_lf_delta = br.bit(0x80);
  if (f.use_lf_delta && br.bit(0x80)) {
    for (int i = 0; i < 4; ++i)
      if (br.bit(0x80)) f.ref_lf_delta[i] = br.signed_value(6);
    for (int i = 0; i < 4; ++i)
      if (br.bit(0x80)) f.mode_lf_delta[i] = br.signed_value(6);
  }
  f.filter_type = f.level == 0 ? 0 : f.simple ? 1 : 2;
  if (br.eof) return kBadFrameHeader;
  // partitions
  f.num_parts = 1 << br.value_bits(2);
  const size_t last = f.num_parts - 1;
  if (size < 3 * last) return kBadPartitions;
  const uint8_t* sz = buf;
  const uint8_t* part_start = buf + last * 3;
  size_t left = size - last * 3;
  for (size_t p = 0; p < last; ++p, sz += 3) {
    size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
    if (psize > left) psize = left;
    f.parts[p].init(part_start, psize);
    part_start += psize;
    left -= psize;
  }
  f.parts[last].init(part_start, left);
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
    if (f.use_segment) {
      q = f.quantizer[i];
      if (!f.absolute_delta) q += base_q0;
    } else {
      q = base_q0;
    }
    f.y1_mat[i][0] = kDcTable[clip(q + dqy1_dc, 127)];
    f.y1_mat[i][1] = kAcTable[clip(q, 127)];
    f.y2_mat[i][0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
    f.y2_mat[i][1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
    if (f.y2_mat[i][1] < 8) f.y2_mat[i][1] = 8;
    f.uv_mat[i][0] = kDcTable[clip(q + dquv_dc, 117)];
    f.uv_mat[i][1] = kAcTable[clip(q + dquv_ac, 127)];
  }
  br.bit(0x80);  // refresh entropy probabilities: a single key frame ignores it
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p) {
          const int k = ((t * 8 + b) * 3 + c) * 11 + p;
          f.proba[t][b][c][p] = br.bit(kCoeffsUpdateProba[k]) ? br.value_bits(8) : kCoeffsProba0[k];
        }
  f.use_skip_proba = br.bit(0x80);
  if (f.use_skip_proba) f.skip_p = br.value_bits(8);
  // filter strengths
  for (int s = 0; s < 4; ++s) {
    int base = f.level;
    if (f.use_segment) {
      base = f.filter_strength[s];
      if (!f.absolute_delta) base += f.level;
    }
    for (int i4 = 0; i4 <= 1; ++i4) {
      FInfo& info = f.fstrengths[s][i4];
      int level = base;
      if (f.use_lf_delta) {
        level += f.ref_lf_delta[0];
        if (i4) level += f.mode_lf_delta[0];
      }
      level = level < 0 ? 0 : level > 63 ? 63 : level;
      info.limit = 0;
      info.ilevel = 0;
      info.hev_thresh = 0;
      if (level > 0) {
        int ilevel = level;
        if (f.sharpness > 0) {
          ilevel >>= f.sharpness > 4 ? 2 : 1;
          if (ilevel > 9 - f.sharpness) ilevel = 9 - f.sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        info.ilevel = ilevel;
        info.limit = 2 * level + ilevel;
        info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
      }
      info.inner = i4;
    }
  }
  return br.eof ? kBadFrameHeader : kOk;
}

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

// libwebp's 14-bit YUV -> RGB
static inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
static inline int yuv_clip8(int v) { return (v & ~16383) == 0 ? (v >> 6) : (v < 0) ? 0 : 255; }
static inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = (uint8_t)yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = (uint8_t)yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = (uint8_t)yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// libwebp's UpsampleRgbLinePair: two output rows from two luma rows and the
// chroma rows above (top_u/v) and below (cur_u/v) them.
static void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u, const uint8_t* top_v,
                          const uint8_t* cur_u, const uint8_t* cur_v, uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  const int last_pair = (len - 1) >> 1;
  int tl_u = top_u[0], tl_v = top_v[0], l_u = cur_u[0], l_v = cur_v[0];
  yuv_to_rgb(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst);
  if (bottom_y) yuv_to_rgb(bottom_y[0], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2, bottom_dst);
  for (int x = 1; x <= last_pair; ++x) {
    const int t_u = top_u[x], t_v = top_v[x], c_u = cur_u[x], c_v = cur_v[x];
    const int avg_u = tl_u + t_u + l_u + c_u + 8, avg_v = tl_v + t_v + l_v + c_v + 8;
    const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int d03_u = (avg_u + 2 * (tl_u + c_u)) >> 3, d03_v = (avg_v + 2 * (tl_v + c_v)) >> 3;
    yuv_to_rgb(top_y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1, top_dst + (2 * x - 1) * 3);
    yuv_to_rgb(top_y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, top_dst + 2 * x * 3);
    if (bottom_y) {
      yuv_to_rgb(bottom_y[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1, bottom_dst + (2 * x - 1) * 3);
      yuv_to_rgb(bottom_y[2 * x], (d12_u + c_u) >> 1, (d12_v + c_v) >> 1, bottom_dst + 2 * x * 3);
    }
    tl_u = t_u, tl_v = t_v, l_u = c_u, l_v = c_v;
  }
  if (!(len & 1)) {
    yuv_to_rgb(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst + (len - 1) * 3);
    if (bottom_y)
      yuv_to_rgb(bottom_y[len - 1], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2, bottom_dst + (len - 1) * 3);
  }
}

struct Planes {
  int width = 0, height = 0, ys = 0, uvs = 0;
  std::vector<uint8_t> Y, U, V;  // macroblock-aligned, loop-filtered
};

static int vp8_decode_planes(const uint8_t* data, size_t n, Planes& out) {
  VP8Frame f;
  int st = parse_headers(f, data, n);
  if (st) return st;
  if (f.width == 0 || f.height == 0) return kBadSize;
  const int mb_w = (f.width + 15) >> 4, mb_h = (f.height + 15) >> 4;
  const int ys = mb_w * 16, uvs = mb_w * 8;
  out.width = f.width;
  out.height = f.height;
  out.ys = ys;
  out.uvs = uvs;
  std::vector<uint8_t>& Y = out.Y;
  std::vector<uint8_t>& U = out.U;
  std::vector<uint8_t>& V = out.V;
  Y.assign((size_t)ys * mb_h * 16, 0);
  U.assign((size_t)uvs * mb_h * 8, 0);
  V.assign((size_t)uvs * mb_h * 8, 0);
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
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) parse_intra_mode(f, row[mb_x], &intra_t[4 * mb_x], intra_l);
    if (f.br.eof) return kEndOfData;
    BoolDecoder& tbr = f.parts[mb_y & (f.num_parts - 1)];
    NZ nz_left;
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      MBData& mb = row[mb_x];
      int skip = mb.skip;
      if (!skip) {
        skip = parse_residuals(f, tbr, mb, nz_top[mb_x], nz_left);
      } else {
        nz_left.nz = nz_top[mb_x].nz = 0;
        if (!mb.is_i4x4) nz_left.nz_dc = nz_top[mb_x].nz_dc = 0;
        mb.non_zero_y = mb.non_zero_uv = 0;
        memset(mb.coeffs, 0, sizeof(mb.coeffs));
      }
      if (f.filter_type > 0) {
        FInfo fi = f.fstrengths[mb.segment][mb.is_i4x4];
        fi.inner |= !skip;
        finfo[(size_t)mb_y * mb_w + mb_x] = fi;
      }
      if (tbr.eof) return kEndOfData;
    }
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
      const MBData& mb = row[mb_x];
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
      if (mb.is_i4x4) {
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
      const int uv_mode = check_mode(mb_x, mb_y, mb.uvmode);
      pred_block(u_dst, 8, uv_mode);
      pred_block(v_dst, 8, uv_mode);
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
  // loop filter, macroblocks in raster order (libwebp's DoFilter)
  if (f.filter_type > 0) {
    for (int mb_y = 0; mb_y < mb_h; ++mb_y)
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        const FInfo& fi = finfo[(size_t)mb_y * mb_w + mb_x];
        const int limit = fi.limit;
        if (limit == 0) continue;
        uint8_t* yp = &Y[(size_t)mb_y * 16 * ys + mb_x * 16];
        if (f.filter_type == 1) {
          if (mb_x > 0) simple_edge(yp, 1, ys, 16, limit + 4);
          if (fi.inner)
            for (int k = 1; k <= 3; ++k) simple_edge(yp + 4 * k, 1, ys, 16, limit);
          if (mb_y > 0) simple_edge(yp, ys, 1, 16, limit + 4);
          if (fi.inner)
            for (int k = 1; k <= 3; ++k) simple_edge(yp + 4 * k * ys, ys, 1, 16, limit);
        } else {
          uint8_t* up = &U[(size_t)mb_y * 8 * uvs + mb_x * 8];
          uint8_t* vp = &V[(size_t)mb_y * 8 * uvs + mb_x * 8];
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
  return kOk;
}

static int vp8_decode_rgb(const uint8_t* data, size_t n, int want_w, int want_h, uint8_t* rgb) {
  Planes p;
  const int st = vp8_decode_planes(data, n, p);
  if (st) return st;
  if (p.width != want_w || p.height != want_h) return kBadSize;
  const std::vector<uint8_t>&Y = p.Y, &U = p.U, &V = p.V;
  const int ys = p.ys, uvs = p.uvs;
  // fancy upsampling to RGB (libwebp's EmitFancyRGB over the whole picture)
  const int w = p.width, h = p.height;
  const size_t stride = (size_t)w * 3;
  upsample_pair(&Y[0], nullptr, &U[0], &V[0], &U[0], &V[0], rgb, nullptr, w);
  int y = 0;
  for (; y + 2 < h; y += 2) {
    const size_t k = (size_t)y / 2;
    upsample_pair(&Y[(size_t)(y + 1) * ys], &Y[(size_t)(y + 2) * ys], &U[k * uvs], &V[k * uvs], &U[(k + 1) * uvs],
                  &V[(k + 1) * uvs], rgb + (y + 1) * stride, rgb + (y + 2) * stride, w);
  }
  if (!(h & 1)) {
    const size_t k = (size_t)y / 2;
    upsample_pair(&Y[(size_t)(y + 1) * ys], nullptr, &U[k * uvs], &V[k * uvs], &U[k * uvs], &V[k * uvs],
                  rgb + (y + 1) * stride, nullptr, w);
  }
  return kOk;
}

}  // namespace

extern "C" {

const char* webp_error(int status) {
  switch (status) {
    case kEndOfData: return "the bitstream ends early";
    case kBadCode: return "an invalid prefix code";
    case kBadCopy: return "a backward reference out of the image";
    case kBadTransform: return "a repeated VP8L transform";
    case kNotKeyFrame: return "not a VP8 key frame";
    case kBadFrameHeader: return "a bad VP8 frame header";
    case kBadLosslessHeader: return "a bad VP8L header";
    case kBadPartitions: return "bad VP8 token partitions";
    case kBadCacheBits: return "bad VP8L colour cache bits";
    case kBadSize: return "the frame size differs from the container's";
    default: return "unknown error";
  }
}

// VP8L chunk payload -> RGB uint8 [h, w, 3] (alpha dropped)
int vp8l_decode(const uint8_t* data, long n, uint8_t* rgb, int width, int height) {
  std::vector<uint32_t> argb;
  const int st = vp8l_decode_argb(data, (size_t)n, width, height, argb);
  if (st) return st;
  for (size_t i = 0; i < argb.size(); ++i) {
    rgb[3 * i] = (uint8_t)(argb[i] >> 16);
    rgb[3 * i + 1] = (uint8_t)(argb[i] >> 8);
    rgb[3 * i + 2] = (uint8_t)argb[i];
  }
  return kOk;
}

// VP8 key-frame chunk payload -> RGB uint8 [h, w, 3]
int vp8_decode(const uint8_t* data, long n, uint8_t* rgb, int width, int height) {
  return vp8_decode_rgb(data, (size_t)n, width, height, rgb);
}

// RGB uint8 [h, w, 3] -> a VP8L chunk payload in ``out`` (capacity ``cap``):
// its length, or -1 if ``cap`` is too small. ``mode`` is the predictor mode
// (0-13) of the whole image.
long vp8l_encode(const uint8_t* rgb, int width, int height, int mode, uint8_t* out, long cap) {
  const size_t n = (size_t)width * height;
  std::vector<uint32_t> argb(n), res(n);
  for (size_t i = 0; i < n; ++i)
    argb[i] = 0xff000000u | ((uint32_t)rgb[3 * i] << 16) | ((uint32_t)rgb[3 * i + 1] << 8) | rgb[3 * i + 2];
  const int bits = 9;  // one predictor block of 512 x 512
  for (int y = 0; y < height; ++y)
    for (int x = 0; x < width; ++x) {
      const uint32_t* row = argb.data() + (size_t)y * width;
      const uint32_t* up = row - width;
      const int m = y == 0 ? (x == 0 ? 0 : 1) : (x == 0 ? 2 : mode);
      const uint32_t L = x ? row[x - 1] : 0, T = y ? up[x] : 0;
      const uint32_t TL = (x && y) ? up[x - 1] : 0, TR = y ? up[x + 1] : 0;
      const uint32_t r = sub_pixels(row[x], predict(m, L, T, TL, TR));
      const uint32_t g = (r >> 8) & 255;  // subtract green
      res[(size_t)y * width + x] =
          (r & 0xff00ff00u) | ((((r >> 16) - g) & 255) << 16) | (((r & 255) - g) & 255);
    }
  BitWriter bw;
  bw.put(0x2f, 8);
  bw.put(width - 1, 14);
  bw.put(height - 1, 14);
  bw.put(0, 1);  // no alpha
  bw.put(0, 3);  // version
  bw.put(1, 1);  // transform: predictor
  bw.put(0, 2);
  bw.put(bits - 2, 3);
  std::vector<uint32_t> modes((size_t)subsample(width, bits) * subsample(height, bits), 0xff000000u | (mode << 8));
  write_pixels(bw, modes, false);
  bw.put(1, 1);  // transform: subtract green
  bw.put(2, 2);
  bw.put(0, 1);  // no more transforms
  write_pixels(bw, res, true);
  bw.flush();
  if ((long)bw.out.size() > cap) return -1;
  memcpy(out, bw.out.data(), bw.out.size());
  return (long)bw.out.size();
}

}  // extern "C"
