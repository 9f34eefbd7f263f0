// Baseline JPEG encoding on the host: the port's counterpart of cv2.imwrite
// of a ".jpg" with OpenCV's defaults, called through ctypes from native.py.
//
// OpenCV writes with libjpeg-turbo: quality 95, 4:2:0 chroma (one component
// for a gray image), the standard Huffman tables of JPEG Annex K (no
// optimisation), sequential and not progressive, no restart markers, a JFIF
// 1.01 APP0 segment. This encoder follows libjpeg-turbo's arithmetic, so the
// files it writes equal OpenCV's byte for byte:
//   * the fixed-point RGB->YCbCr tables (jccolor.c, rgb_ycc_start);
//   * edge replication to whole blocks and MCU rows (jcprepct.c,
//     expand_right_edge / expand_bottom_edge), and h2v2 chroma downsampling
//     with its alternating 1, 2 rounding bias (jcsample.c);
//   * the accurate integer forward DCT (jfdctint.c, jpeg_fdct_islow) and
//     rounded division by 8 x the quantiser (jcdctmgr.c);
//   * the quality-scaled Annex K quantisers, capped at 255 (jcparam.c);
//   * dummy blocks past the image's right and bottom edges that repeat the
//     DC of the block before them (jccoefct.c), and jchuff.c's entropy
//     coding, 0xFF byte stuffing and 1-bit padding.
// Markers are written in libjpeg's order: SOI, APP0, DQT per table, SOF0,
// DHT per table, SOS, the scan, EOI.

#include <cstdint>
#include <cstring>
#include <vector>

#include "jpeg_tables.h"

namespace {

// zigzag index -> natural (row-major) index
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct HuffEnc {
    uint32_t code[256];
    int size[256];
    void build(const uint8_t* bits, const uint8_t* vals) {
        std::memset(size, 0, sizeof(size));
        uint32_t c = 0;
        int k = 0;
        for (int len = 1; len <= 16; ++len) {
            for (int i = 0; i < bits[len - 1]; ++i, ++k) {
                code[vals[k]] = c++;
                size[vals[k]] = len;
            }
            c <<= 1;
        }
    }
};

struct Writer {
    std::vector<uint8_t> out;
    uint64_t acc = 0;
    int nbits = 0;
    void byte(int b) { out.push_back((uint8_t)b); }
    void word(int w) { byte(w >> 8); byte(w & 0xFF); }
    void marker(int m) { byte(0xFF); byte(m); }
    void bits(uint32_t v, int n) {  // the low n bits of v, most significant first
        if (n == 0) return;
        acc = (acc << n) | (v & ((1u << n) - 1));
        nbits += n;
        while (nbits >= 8) {
            uint8_t c = (uint8_t)(acc >> (nbits - 8));
            out.push_back(c);
            if (c == 0xFF) out.push_back(0);
            nbits -= 8;
        }
    }
    void flush() {  // jchuff.c flush_bits: pad with one-bits to a byte
        bits(0x7F, 7);
        acc = 0;
        nbits = 0;
    }
};

struct Component {
    int id, h, v, tq;  // component id, sampling factors, quantiser table
    int width_blocks, height_blocks;
    std::vector<uint8_t> plane;  // width_blocks * 8 wide, padded to whole MCU rows
    int stride, rows;
    int last_dc = 0;
};

inline int descale(int64_t x, int n) { return (int)((x + ((int64_t)1 << (n - 1))) >> n); }

void fdct_islow(int* data) {
    const int CONST_BITS = 13, PASS1_BITS = 2;
    const int64_t F_0_298 = 2446, F_0_390 = 3196, F_0_541 = 4433, F_0_765 = 6270, F_0_899 = 7373,
                  F_1_175 = 9633, F_1_501 = 12299, F_1_847 = 15137, F_1_961 = 16069, F_2_053 = 16819,
                  F_2_562 = 20995, F_3_072 = 25172;
    for (int pass = 0; pass < 2; ++pass) {
        for (int ctr = 0; ctr < 8; ++ctr) {
            int* d = pass == 0 ? data + ctr * 8 : data + ctr;
            const int s = pass == 0 ? 1 : 8;
            int64_t tmp0 = d[0] + d[7 * s], tmp7 = d[0] - d[7 * s];
            int64_t tmp1 = d[1 * s] + d[6 * s], tmp6 = d[1 * s] - d[6 * s];
            int64_t tmp2 = d[2 * s] + d[5 * s], tmp5 = d[2 * s] - d[5 * s];
            int64_t tmp3 = d[3 * s] + d[4 * s], tmp4 = d[3 * s] - d[4 * s];
            int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
            int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
            const int n = pass == 0 ? CONST_BITS - PASS1_BITS : CONST_BITS + PASS1_BITS;
            if (pass == 0) {
                d[0] = (int)((tmp10 + tmp11) * (1 << PASS1_BITS));
                d[4 * s] = (int)((tmp10 - tmp11) * (1 << PASS1_BITS));
            } else {
                d[0] = descale(tmp10 + tmp11, PASS1_BITS);
                d[4 * s] = descale(tmp10 - tmp11, PASS1_BITS);
            }
            int64_t z1 = (tmp12 + tmp13) * F_0_541;
            d[2 * s] = descale(z1 + tmp13 * F_0_765, n);
            d[6 * s] = descale(z1 + tmp12 * -F_1_847, n);
            z1 = tmp4 + tmp7;
            int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
            int64_t z5 = (z3 + z4) * F_1_175;
            tmp4 *= F_0_298;
            tmp5 *= F_2_053;
            tmp6 *= F_3_072;
            tmp7 *= F_1_501;
            z1 *= -F_0_899;
            z2 *= -F_2_562;
            z3 *= -F_1_961;
            z4 *= -F_0_390;
            z3 += z5;
            z4 += z5;
            d[7 * s] = descale(tmp4 + z1 + z3, n);
            d[5 * s] = descale(tmp5 + z2 + z4, n);
            d[3 * s] = descale(tmp6 + z2 + z3, n);
            d[1 * s] = descale(tmp7 + z1 + z4, n);
        }
    }
}

// quantised coefficients (natural order) of the 8x8 block at (bx, by) of a plane
void encode_block_coefs(const Component& c, int bx, int by, const int* divisors, int* coef) {
    int ws[64];
    for (int y = 0; y < 8; ++y) {
        const uint8_t* row = c.plane.data() + (size_t)(by * 8 + y) * c.stride + bx * 8;
        for (int x = 0; x < 8; ++x) ws[y * 8 + x] = (int)row[x] - 128;
    }
    fdct_islow(ws);
    for (int i = 0; i < 64; ++i) {
        int q = divisors[i], t = ws[i];
        coef[i] = t < 0 ? -((-t + (q >> 1)) / q) : (t + (q >> 1)) / q;
    }
}

int nbits_of(int v) {
    int n = 0;
    while (v) {
        ++n;
        v >>= 1;
    }
    return n;
}

void huff_block(Writer& w, const int* coef, int& last_dc, const HuffEnc& dc, const HuffEnc& ac) {
    int t = coef[0] - last_dc, t2 = t;
    last_dc = coef[0];
    if (t < 0) {
        t = -t;
        t2--;
    }
    int nb = nbits_of(t);
    w.bits(dc.code[nb], dc.size[nb]);
    w.bits((uint32_t)t2, nb);
    int r = 0;
    for (int k = 1; k < 64; ++k) {
        t = coef[kNatural[k]];
        if (t == 0) {
            r++;
            continue;
        }
        while (r > 15) {
            w.bits(ac.code[0xF0], ac.size[0xF0]);
            r -= 16;
        }
        t2 = t;
        if (t < 0) {
            t = -t;
            t2--;
        }
        nb = nbits_of(t);
        int sym = (r << 4) + nb;
        w.bits(ac.code[sym], ac.size[sym]);
        w.bits((uint32_t)t2, nb);
        r = 0;
    }
    if (r > 0) w.bits(ac.code[0], ac.size[0]);
}

// rows x cols plane from `src` (width w, height h, given stride), the right
// edge repeated to `cols` and the last row to `rows`
std::vector<uint8_t> padded(const std::vector<uint8_t>& src, int w, int h, int cols, int rows) {
    std::vector<uint8_t> out((size_t)cols * rows);
    for (int y = 0; y < rows; ++y) {
        const uint8_t* s = src.data() + (size_t)std::min(y, h - 1) * w;
        uint8_t* d = out.data() + (size_t)y * cols;
        std::memcpy(d, s, w);
        std::memset(d + w, s[w - 1], cols - w);
    }
    return out;
}

void write_dqt(Writer& w, int index, const int* q_natural) {
    w.marker(0xDB);
    w.word(64 + 1 + 2);
    w.byte(index);
    for (int i = 0; i < 64; ++i) w.byte(q_natural[kNatural[i]]);
}

void write_dht(Writer& w, int index, const uint8_t* bits, const uint8_t* vals) {
    int total = 0;
    for (int i = 0; i < 16; ++i) total += bits[i];
    w.marker(0xC4);
    w.word(2 + 1 + 16 + total);
    w.byte(index);
    for (int i = 0; i < 16; ++i) w.byte(bits[i]);
    for (int i = 0; i < total; ++i) w.byte(vals[i]);
}

inline int imin(int a, int b) { return a < b ? a : b; }

}  // namespace

extern "C" {

// Encode uint8 pixels [h, w, nch] (nch 3: RGB; nch 1: gray) at `quality`
// (1..100) into `out` (capacity `cap` bytes). Returns the file's length, or
// -1 when it does not fit (call again with more room), -2 for bad arguments.
long jpeg_encode(const uint8_t* px, int h, int w, int nch, int quality, uint8_t* out, long cap) {
    if (h <= 0 || w <= 0 || h > 65535 || w > 65535 || (nch != 1 && nch != 3) || quality < 1 || quality > 100)
        return -2;
    // jcparam.c: jpeg_quality_scaling, jpeg_add_quant_table (force_baseline)
    int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
    int quant[2][64];
    for (int t = 0; t < 2; ++t) {
        const uint8_t* base = t == 0 ? kLumaQuantZigzag : kChromaQuantZigzag;
        for (int i = 0; i < 64; ++i) {
            long v = ((long)base[i] * scale + 50) / 100;
            if (v <= 0) v = 1;
            if (v > 255) v = 255;
            quant[t][kNatural[i]] = (int)v;
        }
    }
    int divisors[2][64];
    for (int t = 0; t < 2; ++t)
        for (int i = 0; i < 64; ++i) divisors[t][i] = quant[t][i] << 3;

    const bool color = nch == 3;
    const int ncomp = color ? 3 : 1;
    const int hmax = color ? 2 : 1, vmax = color ? 2 : 1;
    const int mcu_cols = (w + 8 * hmax - 1) / (8 * hmax), mcu_rows = (h + 8 * vmax - 1) / (8 * vmax);

    // colour conversion (jccolor.c, fixed point, SCALEBITS 16)
    std::vector<uint8_t> planes[3];
    for (int c = 0; c < ncomp; ++c) planes[c].resize((size_t)w * h);
    if (color) {
        const int64_t ONE_HALF = 1 << 15, CBCR_OFFSET = (int64_t)128 << 16;
        const int64_t FR_Y = 19595, FG_Y = 38470, FB_Y = 7471, FR_CB = 11059, FG_CB = 21709, FB_CB = 32768,
                      FG_CR = 27439, FB_CR = 5329;
        for (long i = 0; i < (long)w * h; ++i) {
            int64_t r = px[3 * i], g = px[3 * i + 1], b = px[3 * i + 2];
            planes[0][i] = (uint8_t)((FR_Y * r + FG_Y * g + FB_Y * b + ONE_HALF) >> 16);
            planes[1][i] = (uint8_t)((-FR_CB * r - FG_CB * g + FB_CB * b + CBCR_OFFSET + ONE_HALF - 1) >> 16);
            planes[2][i] = (uint8_t)((FB_CB * r - FG_CR * g - FB_CR * b + CBCR_OFFSET + ONE_HALF - 1) >> 16);
        }
    } else {
        std::memcpy(planes[0].data(), px, (size_t)w * h);
    }

    Component comps[3];
    for (int c = 0; c < ncomp; ++c) {
        Component& k = comps[c];
        k.id = c + 1;
        k.h = c == 0 ? hmax : 1;
        k.v = c == 0 ? vmax : 1;
        k.tq = c == 0 ? 0 : 1;
        k.width_blocks = (w * k.h + 8 * hmax - 1) / (8 * hmax);
        k.height_blocks = (h * k.v + 8 * vmax - 1) / (8 * vmax);
        k.stride = mcu_cols * k.h * 8;
        k.rows = mcu_rows * k.v * 8;
        if (k.h == hmax) {  // full size: replicate to whole blocks and iMCU rows
            k.plane = padded(planes[c], w, h, k.stride, k.rows);
        } else {  // h2v2: replicate to twice the block width, then average 2x2 with bias 1, 2, 1, ...
            int in_cols = k.width_blocks * 16, in_rows = ((h + 1) / 2) * 2;
            std::vector<uint8_t> full = padded(planes[c], w, h, in_cols, in_rows);
            int out_cols = k.width_blocks * 8, out_rows = in_rows / 2;
            std::vector<uint8_t> small((size_t)out_cols * out_rows);
            for (int y = 0; y < out_rows; ++y) {
                const uint8_t* r0 = full.data() + (size_t)(2 * y) * in_cols;
                const uint8_t* r1 = r0 + in_cols;
                int bias = 1;
                for (int x = 0; x < out_cols; ++x) {
                    small[(size_t)y * out_cols + x] =
                        (uint8_t)((r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >> 2);
                    bias ^= 3;
                }
            }
            k.plane = padded(small, out_cols, out_rows, k.stride, k.rows);
        }
    }

    HuffEnc dc[2], ac[2];
    dc[0].build(kDcLumaBits, kDcLumaVals);
    ac[0].build(kAcLumaBits, kAcLumaVals);
    dc[1].build(kDcChromaBits, kDcChromaVals);
    ac[1].build(kAcChromaBits, kAcChromaVals);

    Writer wr;
    wr.out.reserve((size_t)w * h / 2 + 1024);
    wr.marker(0xD8);
    wr.marker(0xE0);  // JFIF 1.01, no density unit, 1:1, no thumbnail
    wr.word(16);
    for (char ch : {'J', 'F', 'I', 'F', '\0'}) wr.byte(ch);
    wr.byte(1); wr.byte(1); wr.byte(0); wr.word(1); wr.word(1); wr.byte(0); wr.byte(0);
    for (int t = 0; t < (color ? 2 : 1); ++t) write_dqt(wr, t, quant[t]);
    wr.marker(0xC0);
    wr.word(8 + 3 * ncomp);
    wr.byte(8);
    wr.word(h);
    wr.word(w);
    wr.byte(ncomp);
    for (int c = 0; c < ncomp; ++c) {
        wr.byte(comps[c].id);
        wr.byte((comps[c].h << 4) | comps[c].v);
        wr.byte(comps[c].tq);
    }
    write_dht(wr, 0x00, kDcLumaBits, kDcLumaVals);
    write_dht(wr, 0x10, kAcLumaBits, kAcLumaVals);
    if (color) {
        write_dht(wr, 0x01, kDcChromaBits, kDcChromaVals);
        write_dht(wr, 0x11, kAcChromaBits, kAcChromaVals);
    }
    wr.marker(0xDA);
    wr.word(6 + 2 * ncomp);
    wr.byte(ncomp);
    for (int c = 0; c < ncomp; ++c) {
        wr.byte(comps[c].id);
        wr.byte(c == 0 ? 0x00 : 0x11);
    }
    wr.byte(0); wr.byte(63); wr.byte(0);

    int coef[64];
    for (int my = 0; my < mcu_rows; ++my) {
        for (int mx = 0; mx < mcu_cols; ++mx) {
            for (int c = 0; c < ncomp; ++c) {
                Component& k = comps[c];
                const HuffEnc& d = dc[c == 0 ? 0 : 1];
                const HuffEnc& a = ac[c == 0 ? 0 : 1];
                for (int yi = 0; yi < k.v; ++yi) {
                    for (int xi = 0; xi < k.h; ++xi) {
                        int bx = mx * k.h + xi, by = my * k.v + yi;
                        if (bx < k.width_blocks && by < k.height_blocks) {
                            encode_block_coefs(k, bx, by, divisors[k.tq], coef);
                        } else {  // a dummy block: the DC of the block before it, no AC
                            std::memset(coef, 0, sizeof(coef));
                            coef[0] = k.last_dc;
                        }
                        huff_block(wr, coef, k.last_dc, d, a);
                    }
                }
            }
        }
    }
    wr.flush();
    wr.marker(0xD9);
    if ((long)wr.out.size() > cap) return -1;
    std::memcpy(out, wr.out.data(), wr.out.size());
    return (long)wr.out.size();
}

}  // extern "C"
