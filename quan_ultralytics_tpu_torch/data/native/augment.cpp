// Pixel work of the train augmentations, on the host, without OpenCV.
//
// Each function gives the pixels that OpenCV 5.0 gives for the call named
// beside it, on uint8 RGB images [h, w, 3] (or one channel where stated):
//
//   aug_warp_affine       cv2.warpAffine(INTER_LINEAR, BORDER_CONSTANT)
//   aug_warp_perspective  cv2.warpPerspective(INTER_LINEAR, BORDER_CONSTANT)
//   aug_rgb_to_hsv        cv2.cvtColor(COLOR_RGB2HSV)     (hue range 180)
//   aug_hsv_to_rgb        cv2.cvtColor(COLOR_HSV2RGB)
//   aug_rgb_to_gray       cv2.cvtColor(COLOR_RGB2GRAY)    (one channel out)
//   aug_rgb_to_lab        cv2.cvtColor(COLOR_RGB2LAB)
//   aug_lab_to_rgb        cv2.cvtColor(COLOR_LAB2RGB)
//   aug_blur              cv2.blur((k, k)), BORDER_REFLECT_101
//   aug_median_blur       cv2.medianBlur(k), BORDER_REPLICATE
//   aug_clahe             cv2.createCLAHE(clip, (tx, ty)).apply (one channel)
//   aug_fill_polygons     cv2.drawContours(mask, contours, -1, 1, FILLED)
//   aug_optical_flow_lk   cv2.calcOpticalFlowPyrLK (one channel, BoT-SORT's GMC)
//
// The arithmetic follows OpenCV's own: the integer tables of its 8-bit colour
// conversions, the float32 steps of its vectorised warp (a fused multiply-add
// where it uses one, written out with std::fma), its fixed-point polygon
// edges. Build with -ffp-contract=off and without -ffast-math, so that the
// compiler adds no fused multiply-add of its own and every machine rounds the
// same way. The functions keep no state between calls: loader threads call
// them at once, each on its own arrays.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <utility>
#include <vector>

namespace {

inline uint8_t sat_u8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }
inline uint8_t round_u8(float v) {
    long r = std::lrint(v);  // round half to even, as cvRound
    return (uint8_t)(r < 0 ? 0 : r > 255 ? 255 : r);
}
inline int descale(int x, int n) { return (x + (1 << (n - 1))) >> n; }

inline int reflect101(int p, int n) {
    if (n == 1) return 0;
    while (p < 0 || p >= n) p = p < 0 ? -p : 2 * n - 2 - p;
    return p;
}

// ------------------------------------------------------------------ warps

// Bilinear sample at source (sx, sy), taps outside the image take `border`:
// floor, float32 fractions, a lerp along x then along y, each lerp a fused
// multiply-add, rounded half to even.
inline void bilinear(const uint8_t* src, int sh, int sw, float sx, float sy, uint8_t border,
                     uint8_t* out) {
    if (!(sx > -1.f && sx < (float)sw && sy > -1.f && sy < (float)sh)) {  // every tap outside, or NaN
        out[0] = out[1] = out[2] = border;
        return;
    }
    float fx = std::floor(sx), fy = std::floor(sy);
    int ix = (int)fx, iy = (int)fy;
    float a = sx - fx, b = sy - fy;
    const uint8_t* taps[4];
    for (int k = 0; k < 4; ++k) {
        int xx = ix + (k & 1), yy = iy + (k >> 1);
        taps[k] = (xx >= 0 && xx < sw && yy >= 0 && yy < sh) ? src + ((long)yy * sw + xx) * 3 : nullptr;
    }
    for (int c = 0; c < 3; ++c) {
        float p[4];
        for (int k = 0; k < 4; ++k) p[k] = taps[k] ? (float)taps[k][c] : (float)border;
        float top = std::fma(a, p[1] - p[0], p[0]);
        float bot = std::fma(a, p[3] - p[2], p[2]);
        out[c] = round_u8(std::fma(b, bot - top, top));
    }
}

}  // namespace

extern "C" {

// dst [dh, dw, 3] = src [sh, sw, 3] warped by the forward 2x3 matrix m (double,
// row-major). The matrix is inverted in double (cv2.invertAffineTransform) and
// rounded to float32; a source coordinate is fma(m0, x, m1 * y + m2).
void aug_warp_affine(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh, int dw, const double* m,
                     int border) {
    double d = m[0] * m[4] - m[1] * m[3];
    d = d != 0 ? 1.0 / d : 0.0;
    double a11 = m[4] * d, a22 = m[0] * d, a12 = -m[1] * d, a21 = -m[3] * d;
    double b1 = -a11 * m[2] - a12 * m[5], b2 = -a21 * m[2] - a22 * m[5];
    const float M[6] = {(float)a11, (float)a12, (float)b1, (float)a21, (float)a22, (float)b2};
    for (int y = 0; y < dh; ++y) {
        float fy = (float)y;
        float rx = M[1] * fy + M[2], ry = M[4] * fy + M[5];
        uint8_t* row = dst + (long)y * dw * 3;
        for (int x = 0; x < dw; ++x) {
            float fx = (float)x;
            bilinear(src, sh, sw, std::fma(M[0], fx, rx), std::fma(M[3], fx, ry), (uint8_t)border, row + 3 * x);
        }
    }
}

// The same with the forward 3x3 matrix m: inverted in double, rounded to
// float32, each homogeneous coordinate fma(m0, x, m1 * y + m2), then X / W.
void aug_warp_perspective(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh, int dw, const double* m,
                          int border) {
    double c[9] = {m[4] * m[8] - m[5] * m[7], m[2] * m[7] - m[1] * m[8], m[1] * m[5] - m[2] * m[4],
                   m[5] * m[6] - m[3] * m[8], m[0] * m[8] - m[2] * m[6], m[2] * m[3] - m[0] * m[5],
                   m[3] * m[7] - m[4] * m[6], m[1] * m[6] - m[0] * m[7], m[0] * m[4] - m[1] * m[3]};
    double det = m[0] * c[0] + m[1] * c[3] + m[2] * c[6];
    det = det != 0 ? 1.0 / det : 0.0;
    float M[9];
    for (int i = 0; i < 9; ++i) M[i] = (float)(c[i] * det);
    for (int y = 0; y < dh; ++y) {
        float fy = (float)y;
        float rx = M[1] * fy + M[2], ry = M[4] * fy + M[5], rw = M[7] * fy + M[8];
        uint8_t* row = dst + (long)y * dw * 3;
        for (int x = 0; x < dw; ++x) {
            float fx = (float)x;
            float X = std::fma(M[0], fx, rx), Y = std::fma(M[3], fx, ry), W = std::fma(M[6], fx, rw);
            bilinear(src, sh, sw, X / W, Y / W, (uint8_t)border, row + 3 * x);
        }
    }
}

// ------------------------------------------------------------------ colour

// OpenCV's 8-bit RGB2HSV: integer, division tables with 12 fraction bits.
void aug_rgb_to_hsv(const uint8_t* src, uint8_t* dst, long n) {
    const int shift = 12;
    struct Tables {
        int sdiv[256], hdiv[256];
        Tables() {
            sdiv[0] = hdiv[0] = 0;
            for (int i = 1; i < 256; ++i) {
                sdiv[i] = (int)std::lrint((255 << shift) / (1. * i));
                hdiv[i] = (int)std::lrint((180 << shift) / (6. * i));
            }
        }
    };
    static const Tables t;
    for (long i = 0; i < n; ++i, src += 3, dst += 3) {
        int r = src[0], g = src[1], b = src[2];
        int v = std::max(r, std::max(g, b)), vmin = std::min(r, std::min(g, b));
        int diff = v - vmin;
        int vr = v == r ? -1 : 0, vg = v == g ? -1 : 0;
        int s = (diff * t.sdiv[v] + (1 << (shift - 1))) >> shift;
        int h = (vr & (g - b)) + (~vr & ((vg & (b - r + 2 * diff)) + (~vg & (r - g + 4 * diff))));
        h = (h * t.hdiv[diff] + (1 << (shift - 1))) >> shift;
        h += h < 0 ? 180 : 0;
        dst[0] = sat_u8(h);
        dst[1] = (uint8_t)s;
        dst[2] = (uint8_t)v;
    }
}

// OpenCV's 8-bit HSV2RGB: float32 with its fused multiply-adds. Its
// vectorised loop (32 pixels a step) truncates the result; the pixels after
// the last full step of a row round it. n pixels, rows of w.
void aug_hsv_to_rgb(const uint8_t* src, uint8_t* dst, long n, int w) {
    static const int sector_data[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1}, {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};
    const float hscale = 6.f / 180.f;
    const int vectorised = w / 32 * 32;
    for (long i = 0; i < n; ++i, src += 3, dst += 3) {
        float h = (float)src[0] * hscale, s = src[1] * (1.f / 255.f), v = src[2] * (1.f / 255.f);
        float pre = std::floor(h);
        h -= pre;
        int sector = (int)pre % 6;
        float tab[4] = {v, v * (1.f - s), v * std::fma(-s, h, 1.f), v * std::fma(-s, 1.f - h, 1.f)};
        float rgb[3] = {tab[sector_data[sector][2]] * 255.f, tab[sector_data[sector][1]] * 255.f,
                        tab[sector_data[sector][0]] * 255.f};
        const bool truncate = i % w < vectorised;
        for (int c = 0; c < 3; ++c) dst[c] = truncate ? sat_u8((int)rgb[c]) : round_u8(rgb[c]);
    }
}

// OpenCV 5's 8-bit RGB2GRAY: 15-bit coefficients. dst has one channel.
void aug_rgb_to_gray(const uint8_t* src, uint8_t* dst, long n) {
    for (long i = 0; i < n; ++i, src += 3)
        dst[i] = (uint8_t)((9798 * src[0] + 19235 * src[1] + 3735 * src[2] + (1 << 14)) >> 15);
}

namespace {

// The tables of OpenCV's bit-exact 8-bit Lab conversions (color_lab.cpp),
// sRGB with the D65 white point.
struct LabTables {
    static const int lab_shift = 12, gamma_shift = 3, lab_shift2 = lab_shift + gamma_shift;
    static const int cbrt_size = 256 * 3 / 2 * (1 << gamma_shift);
    static const int base = 1 << 14, inv_gamma_size = 1 << 12;
    uint16_t gamma[256], cbrt[cbrt_size], inv_gamma[inv_gamma_size];
    int to_xyz[9], to_rgb[9], l_to_y[256], l_to_ify[256];

    LabTables() {
        const double g_thresh = 809.0 / 20000.0, g_inv_thresh = 7827.0 / 2500000.0;
        const double g_low = 323.0 / 25.0, g_power = 12.0 / 5.0, g_shift = 11.0 / 200.0;
        for (int i = 0; i < 256; ++i) {
            double x = (double)((float)i / 255.f);
            double g = x <= g_thresh ? x / g_low : std::pow((x + g_shift) / (1.0 + g_shift), g_power);
            gamma[i] = (uint16_t)std::lrint(255.0 * (1 << gamma_shift) * g);
        }
        const float lthresh = 216.f / 24389.f;
        const double lscale = 841.0 / 108.0;
        for (int i = 0; i < cbrt_size; ++i) {
            float x = (float)i * (1.f / (255.f * (1 << gamma_shift)));
            double f = x < lthresh ? (double)x * lscale + 16.0 / 116.0 : std::cbrt((double)x);
            cbrt[i] = (uint16_t)std::lrint((1 << lab_shift2) * f);
        }
        // where OpenCV's single-precision cube root rounds the other way
        cbrt[49] = 9454;
        cbrt[2079] = 32976;
        cbrt[2958] = 37088;
        cbrt[2995] = 37242;
        for (int i = 0; i < inv_gamma_size; ++i) {
            double x = (double)((float)i / (float)inv_gamma_size);
            double g = x <= g_inv_thresh ? x * g_low : std::pow(x, 1.0 / g_power) * (1.0 + g_shift) - g_shift;
            inv_gamma[i] = (uint16_t)std::lrint(255.f * (float)g);
        }
        for (int i = 0; i < 256; ++i) {
            if (i <= 20) {
                l_to_y[i] = (int)std::lrint((float)(i * base * 20 * 9) / (float)(17 * 29 * 29 * 29));
                l_to_ify[i] = (int)std::lrint((float)base * ((float)16 / (float)116 + (float)(i * 5) / (float)(3 * 17 * 29)));
            } else {
                float fy = (float)(i * 100 * base) / (float)(255 * 116) + (float)(16 * base) / (float)116;
                l_to_ify[i] = (int)std::lrint(fy);
                l_to_y[i] = (int)std::lrint(fy * fy * fy / (float)(base * base));
            }
        }
        static const double rgb2xyz[9] = {0.412453, 0.357580, 0.180423, 0.212671, 0.715160,
                                          0.072169, 0.019334, 0.119193, 0.950227};
        static const double xyz2rgb[9] = {3.240479, -1.53715, -0.498535, -0.969256, 1.875991,
                                          0.041556, 0.055648, -0.204043, 1.057311};
        static const double white[3] = {0.950456, 1., 1.088754};
        for (int r = 0; r < 3; ++r)
            for (int c = 0; c < 3; ++c) {
                to_xyz[r * 3 + c] = (int)std::lrint((1 << lab_shift) * rgb2xyz[r * 3 + c] / white[r]);
                to_rgb[r * 3 + c] = (int)std::lrint((1 << lab_shift) * xyz2rgb[r * 3 + c] * white[c]);
            }
    }
};

const LabTables& lab_tables() {
    static const LabTables t;
    return t;
}

inline int ab_to_xz(int v) {
    const int base = LabTables::base;
    return v <= 3390 ? v * 108 / 841 - base * 16 / 116 * 108 / 841 : v * v / base * v / base;
}

}  // namespace

void aug_rgb_to_lab(const uint8_t* src, uint8_t* dst, long n) {
    const LabTables& t = lab_tables();
    const int s2 = LabTables::lab_shift2, s = LabTables::lab_shift;
    const int Lscale = (116 * 255 + 50) / 100, Lshift = -((16 * 255 * (1 << s2) + 50) / 100);
    const int* C = t.to_xyz;
    for (long i = 0; i < n; ++i, src += 3, dst += 3) {
        int R = t.gamma[src[0]], G = t.gamma[src[1]], B = t.gamma[src[2]];
        int fX = t.cbrt[descale(R * C[0] + G * C[1] + B * C[2], s)];
        int fY = t.cbrt[descale(R * C[3] + G * C[4] + B * C[5], s)];
        int fZ = t.cbrt[descale(R * C[6] + G * C[7] + B * C[8], s)];
        dst[0] = sat_u8(descale(Lscale * fY + Lshift, s2));
        dst[1] = sat_u8(descale(500 * (fX - fY) + 128 * (1 << s2), s2));
        dst[2] = sat_u8(descale(200 * (fY - fZ) + 128 * (1 << s2), s2));
    }
}

void aug_lab_to_rgb(const uint8_t* src, uint8_t* dst, long n) {
    const LabTables& t = lab_tables();
    const int base = LabTables::base, top = LabTables::inv_gamma_size - 1;
    for (long i = 0; i < n; ++i, src += 3, dst += 3) {
        int L = src[0], a = src[1], b = src[2];
        int y = t.l_to_y[L], ify = t.l_to_ify[L];
        int adiv = ((5 * a * 53687 + (1 << 7)) >> 13) - 128 * base / 500;
        int bdiv = ((b * 41943 + (1 << 4)) >> 9) - 128 * base / 200 + 1;
        int x = ab_to_xz(ify + adiv), z = ab_to_xz(ify - bdiv);
        for (int c = 0; c < 3; ++c) {
            int v = descale(t.to_rgb[c * 3] * x + t.to_rgb[c * 3 + 1] * y + t.to_rgb[c * 3 + 2] * z, 14);
            dst[c] = sat_u8(t.inv_gamma[std::max(0, std::min(top, v))]);
        }
    }
}

// ------------------------------------------------------------------ filters

// Normalised k x k box filter of a [h, w, cn] image, BORDER_REFLECT_101:
// the integer window sum over k * k, rounded (k * k is odd: no ties).
void aug_blur(const uint8_t* src, int h, int w, int cn, uint8_t* dst, int k) {
    const int r = k / 2, area = k * k;
    std::vector<int> cols((long)w * cn);
    std::vector<int> xs(w + 2 * r);
    for (int x = -r; x < w + r; ++x) xs[x + r] = reflect101(x, w);
    for (int y = 0; y < h; ++y) {
        std::fill(cols.begin(), cols.end(), 0);
        for (int dy = -r; dy <= r; ++dy) {
            const uint8_t* row = src + (long)reflect101(y + dy, h) * w * cn;
            for (long j = 0; j < (long)w * cn; ++j) cols[j] += row[j];
        }
        uint8_t* out = dst + (long)y * w * cn;
        for (int x = 0; x < w; ++x)
            for (int c = 0; c < cn; ++c) {
                int s = 0;
                for (int dx = 0; dx < k; ++dx) s += cols[(long)xs[x + dx] * cn + c];
                out[x * cn + c] = (uint8_t)((s + (area - 1) / 2) / area);
            }
    }
}

// Median of each k x k window of a [h, w, cn] image, BORDER_REPLICATE, by a
// running histogram along each row.
void aug_median_blur(const uint8_t* src, int h, int w, int cn, uint8_t* dst, int k) {
    const int r = k / 2, half = k * k / 2;
    auto at = [&](int y, int x, int c) {
        y = std::min(std::max(y, 0), h - 1);
        x = std::min(std::max(x, 0), w - 1);
        return src[((long)y * w + x) * cn + c];
    };
    for (int c = 0; c < cn; ++c)
        for (int y = 0; y < h; ++y) {
            int hist[256] = {0};
            for (int dy = -r; dy <= r; ++dy)
                for (int dx = -r; dx <= r; ++dx) hist[at(y + dy, dx, c)]++;
            for (int x = 0; x < w; ++x) {
                if (x > 0)
                    for (int dy = -r; dy <= r; ++dy) {
                        hist[at(y + dy, x - 1 - r, c)]--;
                        hist[at(y + dy, x + r, c)]++;
                    }
                int v = 0, seen = hist[0];
                while (seen <= half) seen += hist[++v];
                dst[((long)y * w + x) * cn + c] = (uint8_t)v;
            }
        }
}

// CLAHE of a one-channel [h, w] image on a tiles_x x tiles_y grid (clahe.cpp):
// a side that does not divide by its tile count pads both sides by
// BORDER_REFLECT_101 for the histograms; each tile's histogram is clipped at
// clip * tile area / 256, the excess spread evenly and its residual in steps;
// the tiles' LUTs are blended bilinearly in float32.
void aug_clahe(const uint8_t* src, int h, int w, uint8_t* dst, double clip_limit, int tiles_x, int tiles_y) {
    const int hist_size = 256;
    int eh = h, ew = w;
    if (w % tiles_x != 0 || h % tiles_y != 0) {
        eh = h + tiles_y - h % tiles_y;
        ew = w + tiles_x - w % tiles_x;
    }
    const int tw = ew / tiles_x, th = eh / tiles_y, area = tw * th;
    const float lut_scale = (float)(hist_size - 1) / area;
    int clip = 0;
    if (clip_limit > 0.0) clip = std::max((int)(clip_limit * area / hist_size), 1);
    std::vector<uint8_t> lut((long)tiles_x * tiles_y * hist_size);
    for (int t = 0; t < tiles_x * tiles_y; ++t) {
        const int ty = t / tiles_x, tx = t % tiles_x;
        int hist[hist_size] = {0};
        for (int y = ty * th; y < (ty + 1) * th; ++y) {
            const uint8_t* row = src + (long)reflect101(y, h) * w;
            for (int x = tx * tw; x < (tx + 1) * tw; ++x) hist[row[reflect101(x, w)]]++;
        }
        if (clip > 0) {
            int clipped = 0;
            for (int i = 0; i < hist_size; ++i)
                if (hist[i] > clip) {
                    clipped += hist[i] - clip;
                    hist[i] = clip;
                }
            const int batch = clipped / hist_size;
            int residual = clipped - batch * hist_size;
            for (int i = 0; i < hist_size; ++i) hist[i] += batch;
            if (residual != 0) {
                const int step = std::max(hist_size / residual, 1);
                for (int i = 0; i < hist_size && residual > 0; i += step, residual--) hist[i]++;
            }
        }
        uint8_t* L = &lut[(long)t * hist_size];
        int sum = 0;
        for (int i = 0; i < hist_size; ++i) {
            sum += hist[i];
            L[i] = round_u8(sum * lut_scale);
        }
    }
    const float inv_tw = 1.0f / tw, inv_th = 1.0f / th;
    std::vector<int> ind1(w), ind2(w);
    std::vector<float> xa(w), xa1(w);
    for (int x = 0; x < w; ++x) {
        float txf = x * inv_tw - 0.5f;
        int tx1 = (int)std::floor(txf), tx2 = tx1 + 1;
        xa[x] = txf - tx1;
        xa1[x] = 1.0f - xa[x];
        ind1[x] = std::max(tx1, 0) * hist_size;
        ind2[x] = std::min(tx2, tiles_x - 1) * hist_size;
    }
    for (int y = 0; y < h; ++y) {
        float tyf = y * inv_th - 0.5f;
        int ty1 = (int)std::floor(tyf), ty2 = ty1 + 1;
        float ya = tyf - ty1, ya1 = 1.0f - ya;
        const uint8_t* p1 = &lut[(long)std::max(ty1, 0) * tiles_x * hist_size];
        const uint8_t* p2 = &lut[(long)std::min(ty2, tiles_y - 1) * tiles_x * hist_size];
        const uint8_t* in = src + (long)y * w;
        uint8_t* out = dst + (long)y * w;
        for (int x = 0; x < w; ++x) {
            const int v = in[x];
            float res = (p1[ind1[x] + v] * xa1[x] + p1[ind2[x] + v] * xa[x]) * ya1 +
                        (p2[ind1[x] + v] * xa1[x] + p2[ind2[x] + v] * xa[x]) * ya;
            out[x] = round_u8(res);
        }
    }
}

}  // extern "C"

// ------------------------------------------------------------------ polygons
//
// OpenCV's fillPoly (drawing.cpp: CollectPolyEdges, FillEdgeCollection) with
// 8-connected edges and no sub-pixel bits: every contour's outline is drawn
// with a Bresenham line, the edges of all contours are collected together, and
// each scan line is filled between pairs of crossings, so overlapping contours
// fill under the even-odd rule. A crossing is x in 16.16 fixed point stepped
// by the edge's truncated slope; a span runs from the ceiling of its left
// crossing to the floor of its right one. An edge that leaves the image takes
// its x from its clipped end points (and its y too unless they fall on one
// row), extrapolated over its whole rows. Points must lie within +-2^20.

namespace {

const int XY_SHIFT = 16;
const int64_t XY_ONE = (int64_t)1 << XY_SHIFT;

struct PolyEdge {
    int y0 = 0, y1 = 0;
    int64_t x = 0, dx = 0;
    PolyEdge* next = nullptr;
};

struct Mask {
    uint8_t* data;
    int h, w;
    uint8_t value;
};

// cv::clipLine on a w x h image, 64-bit points; false if the line misses it.
bool clip_line(int64_t w, int64_t h, int64_t& x1, int64_t& y1, int64_t& x2, int64_t& y2) {
    const int64_t right = w - 1, bottom = h - 1;
    if (w <= 0 || h <= 0) return false;
    int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
    int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
        int64_t a;
        if (c1 & 12) {
            a = c1 < 8 ? 0 : bottom;
            x1 += (int64_t)((double)(a - y1) * (x2 - x1) / (y2 - y1));
            y1 = a;
            c1 = (x1 < 0) + (x1 > right) * 2;
        }
        if (c2 & 12) {
            a = c2 < 8 ? 0 : bottom;
            x2 += (int64_t)((double)(a - y2) * (x2 - x1) / (y2 - y1));
            y2 = a;
            c2 = (x2 < 0) + (x2 > right) * 2;
        }
        if ((c1 & c2) == 0 && (c1 | c2) != 0) {
            if (c1) {
                a = c1 == 1 ? 0 : right;
                y1 += (int64_t)((double)(a - x1) * (y2 - y1) / (x2 - x1));
                x1 = a;
                c1 = 0;
            }
            if (c2) {
                a = c2 == 1 ? 0 : right;
                y2 += (int64_t)((double)(a - x2) * (y2 - y1) / (x2 - x1));
                x2 = a;
                c2 = 0;
            }
        }
    }
    return (c1 | c2) == 0;
}

// cv::Line with an 8-connected LineIterator, drawn left to right.
void draw_line(Mask& m, int64_t x1, int64_t y1, int64_t x2, int64_t y2) {
    if ((uint64_t)x1 >= (uint64_t)m.w || (uint64_t)x2 >= (uint64_t)m.w || (uint64_t)y1 >= (uint64_t)m.h ||
        (uint64_t)y2 >= (uint64_t)m.h) {
        // the iterator clips int points
        x1 = (int)x1; y1 = (int)y1; x2 = (int)x2; y2 = (int)y2;
        if (!clip_line(m.w, m.h, x1, y1, x2, y2)) return;
    }
    int px1 = (int)x1, py1 = (int)y1, px2 = (int)x2, py2 = (int)y2;
    int dx = px2 - px1, dy = py2 - py1;
    if (dx < 0) {
        dx = -dx;
        dy = -dy;
        std::swap(px1, px2);
        std::swap(py1, py2);
    }
    int step_y = 1;
    if (dy < 0) {
        dy = -dy;
        step_y = -1;
    }
    const bool vert = dy > dx;
    if (vert) std::swap(dx, dy);
    int err = dx - (dy + dy);
    const int plus = dx + dx, minus = -(dy + dy);
    int x = px1, y = py1;
    for (int i = 0; i <= dx; ++i) {
        m.data[(long)y * m.w + x] = m.value;
        const bool side = err < 0;
        err += minus + (side ? plus : 0);
        if (vert) {
            y += step_y;
            if (side) x += 1;
        } else {
            x += 1;
            if (side) y += step_y;
        }
    }
}

void collect_edges(Mask& m, const int32_t* pts, int count, std::vector<PolyEdge>& edges) {
    int64_t p0x = (int64_t)pts[2 * (count - 1)] << XY_SHIFT, p0y = pts[2 * (count - 1) + 1];
    for (int i = 0; i < count; ++i) {
        const int64_t p1x = (int64_t)pts[2 * i] << XY_SHIFT, p1y = pts[2 * i + 1];
        int64_t c0x = p0x, c0y = p0y, c1x = p1x, c1y = p1y;
        int64_t t0x = (p0x + (XY_ONE >> 1)) >> XY_SHIFT, t0y = p0y;
        int64_t t1x = (p1x + (XY_ONE >> 1)) >> XY_SHIFT, t1y = p1y;
        draw_line(m, t0x, t0y, t1x, t1y);
        if ((uint64_t)t0x >= (uint64_t)m.w || (uint64_t)t1x >= (uint64_t)m.w || (uint64_t)t0y >= (uint64_t)m.h ||
            (uint64_t)t1y >= (uint64_t)m.h) {
            // an edge that leaves the image takes its x from its clipped end points
            if (clip_line(m.w, m.h, t0x, t0y, t1x, t1y)) {
                if (t0y != t1y) {
                    c0y = t0y;
                    c1y = t1y;
                }
                c0x = t0x << XY_SHIFT;
                c1x = t1x << XY_SHIFT;
            }
        }
        if (p0y != p1y) {
            PolyEdge e;
            e.dx = (c1x - c0x) / (c1y - c0y);
            if (p0y < p1y) {
                e.y0 = (int)p0y;
                e.y1 = (int)p1y;
                e.x = c0x + (p0y - c0y) * e.dx;
            } else {
                e.y0 = (int)p1y;
                e.y1 = (int)p0y;
                e.x = c1x + (p1y - c1y) * e.dx;
            }
            edges.push_back(e);
        }
        p0x = p1x;
        p0y = p1y;
    }
}

void fill_edges(Mask& m, std::vector<PolyEdge>& edges) {
    const int total = (int)edges.size();
    if (total < 2) return;
    int y_max = INT32_MIN, y_min = INT32_MAX;
    int64_t x_max = INT64_MIN, x_min = INT64_MAX;
    for (const PolyEdge& e : edges) {
        const int64_t x1 = e.x + (e.y1 - e.y0) * e.dx;
        y_min = std::min(y_min, e.y0);
        y_max = std::max(y_max, e.y1);
        x_min = std::min(x_min, std::min(e.x, x1));
        x_max = std::max(x_max, std::max(e.x, x1));
    }
    if (y_max < 0 || y_min >= m.h || x_max < 0 || x_min >= ((int64_t)m.w << XY_SHIFT)) return;
    std::sort(edges.begin(), edges.end(), [](const PolyEdge& a, const PolyEdge& b) {
        return a.y0 != b.y0 ? a.y0 < b.y0 : a.x != b.x ? a.x < b.x : a.dx < b.dx;
    });
    PolyEdge tmp;
    tmp.y0 = INT32_MAX;
    edges.push_back(tmp);  // no edge is added after this: pointers into edges stay valid
    int i = 0;
    tmp.next = nullptr;
    PolyEdge* e = &edges[i];
    y_max = std::min(y_max, m.h);
    for (int y = e->y0; y < y_max; ++y) {
        PolyEdge *last, *prelast, *keep_prelast;
        bool draw = false;
        const bool clipline = y < 0;
        prelast = &tmp;
        last = tmp.next;
        while (last || e->y0 == y) {
            if (last && last->y1 == y) {  // the edge ends on this line
                prelast->next = last->next;
                last = last->next;
                continue;
            }
            keep_prelast = prelast;
            if (last && (e->y0 > y || last->x < e->x)) {
                prelast = last;
                last = last->next;
            } else if (i < total) {  // the edge starts on this line
                prelast->next = e;
                e->next = last;
                prelast = e;
                e = &edges[++i];
            } else {
                break;
            }
            if (draw) {
                if (!clipline) {
                    int x1, x2;
                    if (keep_prelast->x > prelast->x) {
                        x1 = (int)((prelast->x + XY_ONE - 1) >> XY_SHIFT);
                        x2 = (int)(keep_prelast->x >> XY_SHIFT);
                    } else {
                        x1 = (int)((keep_prelast->x + XY_ONE - 1) >> XY_SHIFT);
                        x2 = (int)(prelast->x >> XY_SHIFT);
                    }
                    if (x1 < m.w && x2 >= 0) {
                        x1 = std::max(x1, 0);
                        x2 = std::min(x2, m.w - 1);
                        std::memset(m.data + (long)y * m.w + x1, m.value, x2 - x1 + 1);
                    }
                }
                keep_prelast->x += keep_prelast->dx;
                prelast->x += prelast->dx;
            }
            draw = !draw;
        }
        // keep the active list sorted by x (bubble sort)
        keep_prelast = nullptr;
        do {
            prelast = &tmp;
            last = tmp.next;
            PolyEdge* last_exchange = nullptr;
            while (last != keep_prelast && last->next != nullptr) {
                PolyEdge* te = last->next;
                if (last->x > te->x) {
                    prelast->next = te;
                    last->next = te->next;
                    te->next = last;
                    prelast = te;
                    last_exchange = prelast;
                } else {
                    prelast = last;
                    last = te;
                }
            }
            if (last_exchange == nullptr) break;
            keep_prelast = last_exchange;
        } while (keep_prelast != tmp.next && keep_prelast != &tmp);
    }
}

}  // namespace

extern "C" {

// Fill n contours into the one-channel mask [h, w] with 1: contour j has
// counts[j] points, (x, y) int32 pairs, laid end to end in pts.
void aug_fill_polygons(uint8_t* mask, int h, int w, const int32_t* pts, const int32_t* counts, int n) {
    Mask m{mask, h, w, 1};
    std::vector<PolyEdge> edges;
    long at = 0;
    for (int j = 0; j < n; ++j) {
        if (counts[j] > 0) collect_edges(m, pts + 2 * at, counts[j], edges);
        at += counts[j];
    }
    fill_edges(m, edges);
}

}  // extern "C"

// ------------------------------------------------------------------ pyramidal Lucas-Kanade
//
// OpenCV 5.0's calcOpticalFlowPyrLK (lkpyramid.cpp, the scalar path) on one
// channel: pyrDown levels while a level stays larger than the window, Scharr
// derivatives (3, 10, 3) of the previous image, windows sampled bilinearly
// with 14-bit weights (the image scaled by 32, the derivatives as they are),
// the 2 x 2 gradient matrix and its minimum eigenvalue, then Newton steps
// until a step is below eps or two steps cancel. Images are padded by
// win + 1 (BORDER_REFLECT_101; the derivatives by zeros), so every tap of a
// window whose corner passes the bounds check lies inside the padding.

namespace {

constexpr int kWBits = 14;
constexpr double kFltScale = 1.0 / (1 << 20);

std::vector<uint8_t> pyr_down(const std::vector<uint8_t>& src, int h, int w, int oh, int ow) {
    static const int k[5] = {1, 4, 6, 4, 1};
    std::vector<int32_t> rows((size_t)oh * w);
    for (int y = 0; y < oh; ++y)
        for (int x = 0; x < w; ++x) {
            int s = 0;
            for (int i = 0; i < 5; ++i) s += k[i] * src[(size_t)reflect101(2 * y + i - 2, h) * w + x];
            rows[(size_t)y * w + x] = s;
        }
    std::vector<uint8_t> out((size_t)oh * ow);
    for (int y = 0; y < oh; ++y)
        for (int x = 0; x < ow; ++x) {
            int s = 0;
            for (int j = 0; j < 5; ++j) s += k[j] * rows[(size_t)y * w + reflect101(2 * x + j - 2, w)];
            out[(size_t)y * ow + x] = (uint8_t)((s + 128) >> 8);
        }
    return out;
}

struct Padded {  // an image padded by `pad` on every side, int32, rows of `width`
    int width = 0, pad = 0;
    std::vector<int32_t> px;
    int32_t at(int y, int x) const { return px[(size_t)(y + pad) * width + (x + pad)]; }
};

Padded pad_reflect(const std::vector<uint8_t>& im, int h, int w, int pad) {
    Padded p;
    p.width = w + 2 * pad;
    p.pad = pad;
    p.px.resize((size_t)(h + 2 * pad) * p.width);
    std::vector<int> cols(p.width);
    for (int x = -pad; x < w + pad; ++x) cols[x + pad] = reflect101(x, w);
    for (int y = -pad; y < h + pad; ++y) {
        const uint8_t* row = &im[(size_t)reflect101(y, h) * w];
        int32_t* dst = &p.px[(size_t)(y + pad) * p.width];
        for (int x = 0; x < p.width; ++x) dst[x] = row[cols[x]];
    }
    return p;
}

// Scharr derivatives (OpenCV's calcSharrDeriv) of the image that I pads by
// BORDER_REFLECT_101, zero-padded like I.
void scharr(const Padded& I, int h, int w, Padded& dx, Padded& dy) {
    for (Padded* d : {&dx, &dy}) {
        d->width = I.width;
        d->pad = I.pad;
        d->px.assign(I.px.size(), 0);
    }
    std::vector<int32_t> t0(w + 2), t1(w + 2);  // columns -1 .. w
    for (int y = 0; y < h; ++y) {
        for (int x = -1; x <= w; ++x) {
            const int32_t up = I.at(y - 1, x), mid = I.at(y, x), dn = I.at(y + 1, x);
            t0[x + 1] = (up + dn) * 3 + mid * 10;
            t1[x + 1] = dn - up;
        }
        const size_t o = (size_t)(y + I.pad) * I.width + I.pad;
        for (int x = 0; x < w; ++x) {
            dx.px[o + x] = t0[x + 2] - t0[x];
            dy.px[o + x] = (t1[x] + t1[x + 2]) * 3 + t1[x + 1] * 10;
        }
    }
}

struct Corner {  // integer corner and 14-bit bilinear weights of a float32 point
    int x, y;
    int32_t w00, w01, w10, w11;
};

Corner corner(float px, float py) {
    Corner c;
    float fx = std::floor(px), fy = std::floor(py);
    c.x = (int)fx;
    c.y = (int)fy;
    float a = px - fx, b = py - fy, s = (float)(1 << kWBits);
    c.w00 = (int32_t)std::lrint((1.f - a) * (1.f - b) * s);
    c.w01 = (int32_t)std::lrint(a * (1.f - b) * s);
    c.w10 = (int32_t)std::lrint((1.f - a) * b * s);
    c.w11 = (1 << kWBits) - c.w00 - c.w01 - c.w10;
    return c;
}

// the window of `img` at corner c, win x win, descaled by `shift` bits
void sample(const Padded& img, const Corner& c, int win, int shift, int32_t* out) {
    for (int r = 0; r < win; ++r) {
        const int32_t* p0 = &img.px[(size_t)(c.y + r + img.pad) * img.width + (c.x + img.pad)];
        const int32_t* p1 = p0 + img.width;
        for (int q = 0; q < win; ++q)
            out[r * win + q] = descale(p0[q] * c.w00 + p0[q + 1] * c.w01 + p1[q] * c.w10 + p1[q + 1] * c.w11, shift);
    }
}

}  // namespace

extern "C" {

// Track n points (x, y float32 pairs in pts) from prev to next (uint8 [h, w]):
// the tracked points into out (n x 2 float32) and 1 or 0 into status (uint8).
void aug_optical_flow_lk(const uint8_t* prev, const uint8_t* next, int h, int w, const float* pts, int n,
                         float* out, uint8_t* status, int win, int max_level, int max_iter, double eps,
                         double min_eig) {
    std::vector<std::vector<uint8_t>> P{std::vector<uint8_t>(prev, prev + (size_t)h * w)};
    std::vector<std::vector<uint8_t>> Q{std::vector<uint8_t>(next, next + (size_t)h * w)};
    std::vector<std::pair<int, int>> size{{h, w}};
    for (int l = 0; l < max_level; ++l) {
        int lh = size.back().first, lw = size.back().second, oh = (lh + 1) / 2, ow = (lw + 1) / 2;
        if (ow <= win || oh <= win) break;
        P.push_back(pyr_down(P.back(), lh, lw, oh, ow));
        Q.push_back(pyr_down(Q.back(), lh, lw, oh, ow));
        size.push_back({oh, ow});
    }
    const int top = (int)P.size() - 1, pad = win + 1, area = win * win;
    const float half = (float)((win - 1) * 0.5);
    const double eps2 = eps * eps;
    std::fill(status, status + n, (uint8_t)1);
    std::vector<int32_t> Iv(area), Ix(area), Iy(area), Jv(area);
    for (int level = top; level >= 0; --level) {
        const int lh = size[level].first, lw = size[level].second;
        Padded I = pad_reflect(P[level], lh, lw, pad), J = pad_reflect(Q[level], lh, lw, pad), dx, dy;
        scharr(I, lh, lw, dx, dy);
        const float inv = 1.f / (float)(1 << level);
        for (int k = 0; k < n; ++k) {
            float* o = out + 2 * k;
            const float px = pts[2 * k] * inv, py = pts[2 * k + 1] * inv;
            if (level == top) {
                o[0] = px;
                o[1] = py;
            } else {
                o[0] *= 2.f;
                o[1] *= 2.f;
            }
            Corner c = corner(px - half, py - half);
            if (c.x < -win || c.x >= lw || c.y < -win || c.y >= lh) {
                if (level == 0) status[k] = 0;
                continue;
            }
            sample(I, c, win, kWBits - 5, Iv.data());
            sample(dx, c, win, kWBits, Ix.data());
            sample(dy, c, win, kWBits, Iy.data());
            int64_t s11 = 0, s12 = 0, s22 = 0;
            for (int i = 0; i < area; ++i) {
                s11 += (int64_t)Ix[i] * Ix[i];
                s12 += (int64_t)Ix[i] * Iy[i];
                s22 += (int64_t)Iy[i] * Iy[i];
            }
            const float A11 = (float)(s11 * kFltScale), A12 = (float)(s12 * kFltScale),
                        A22 = (float)(s22 * kFltScale);
            const float D = A11 * A22 - A12 * A12;
            const float eig = (A22 + A11 - std::sqrt((A11 - A22) * (A11 - A22) + 4.f * A12 * A12)) / (float)(2 * area);
            if (eig < (float)min_eig || D < std::numeric_limits<float>::epsilon()) {
                if (level == 0) status[k] = 0;
                continue;
            }
            const float Dinv = 1.f / D;
            float ptx = o[0] - half, pty = o[1] - half, prevx = 0.f, prevy = 0.f;
            for (int j = 0; j < max_iter; ++j) {
                Corner cn = corner(ptx, pty);
                if (cn.x < -win || cn.x >= lw || cn.y < -win || cn.y >= lh) {
                    if (level == 0) status[k] = 0;
                    break;
                }
                sample(J, cn, win, kWBits - 5, Jv.data());
                int64_t s1 = 0, s2 = 0;
                for (int i = 0; i < area; ++i) {
                    const int64_t diff = Jv[i] - Iv[i];
                    s1 += diff * Ix[i];
                    s2 += diff * Iy[i];
                }
                const float b1 = (float)(s1 * kFltScale), b2 = (float)(s2 * kFltScale);
                const float ddx = (A12 * b2 - A22 * b1) * Dinv, ddy = (A12 * b1 - A11 * b2) * Dinv;
                ptx += ddx;
                pty += ddy;
                o[0] = ptx + half;
                o[1] = pty + half;
                if ((double)ddx * ddx + (double)ddy * ddy <= eps2) break;
                if (j > 0 && std::fabs(ddx + prevx) < 0.01f && std::fabs(ddy + prevy) < 0.01f) {
                    o[0] -= ddx * 0.5f;
                    o[1] -= ddy * 0.5f;
                    break;
                }
                prevx = ddx;
                prevy = ddy;
            }
        }
    }
}

}  // extern "C"
