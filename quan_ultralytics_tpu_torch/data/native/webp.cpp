// WebP bitstreams without libwebp: the lossless VP8L decoder and encoder and
// the lossy VP8 key-frame decoder, with libwebp's arithmetic so that the
// pixels equal those OpenCV 5.0 reads through libwebp (WebPDecodeBGRInto).
//
// * VP8L (RFC 9649): simple and normal prefix codes, meta prefix codes (the
//   entropy image), LZ77 with the 120-entry distance map, the colour cache,
//   and the predictor (14 modes), cross-colour, subtract-green and
//   colour-indexing (with pixel bundling) transforms. Output ARGB.
// * VP8 (RFC 6386), key frames: decoded into planes by vp8.h (the VP8 core
//   the video reader shares, with libwebp's choices where decoders differ),
//   then libwebp's "fancy" 4:2:0 upsampler and its 14-bit YUV->RGB
//   conversion. Output RGB, cropped to the picture.
// * The encoder writes VP8L: a predictor transform (one mode for the whole
//   image), subtract-green, prefix codes built from the histograms and
//   limited to 15 bits, and runs of equal pixels as distance-1 copies.
//
// The constant tables are in webp_tables.h (through vp8.h).

#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <vector>

#include "vp8.h"

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

// the key-frame decoder is vp8.h's (vp8::Decoder with libwebp's choices)

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

static int vp8_decode_rgb(const uint8_t* data, size_t n, int want_w, int want_h, uint8_t* rgb) {
  vp8::Decoder dec;
  dec.libwebp = true;
  const int st = dec.decode(data, n);
  if (st) return st;
  const vp8::Picture& p = *dec.cur;
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
