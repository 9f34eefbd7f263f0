// Drawing on uint8 images on the host, without OpenCV: the raster of the
// port's plots (utils/plotting.py).
//
// Each function gives the pixels of the OpenCV 5.0 call named beside it, on
// images [h, w, nch] with nch 1 or 3 (the colour is applied channel for
// channel, so RGB images take RGB colours):
//
//   draw_polyline      cv2.polylines / cv2.line / cv2.rectangle (outlined),
//                      thickness >= 1, LINE_8 or LINE_AA
//   draw_fill_convex   cv2.fillConvexPoly / cv2.rectangle (thickness -1)
//   draw_circle        cv2.circle, filled or outlined, LINE_8 or LINE_AA
//
// The algorithms are drawing.cpp's: points in 16.16 fixed point (XY_SHIFT),
// Bresenham lines for LINE_8, the Gaussian-filtered Wu-style LineAA with its
// end-point correction tables, a thick line as a filled convex quadrilateral
// with round caps (a polygon of the circle, ellipse2Poly's table of sines),
// the convex fill with its fixed-point edge steps, and the midpoint circle.
// No floating-point step is fused: build with -ffp-contract=off. No state
// is kept between calls.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int XY_SHIFT = 16;
constexpr int64_t XY_ONE = int64_t(1) << XY_SHIFT;
constexpr int LINE_AA = 16;

struct Pt {
    int64_t x, y;
    bool operator!=(const Pt& o) const { return x != o.x || y != o.y; }
};

struct Image {
    uint8_t* data;
    int h, w, nch;
    uint8_t color[4];
    uint8_t* px(int x, int y) const { return data + ((long)y * w + x) * nch; }
    void put(int x, int y) const { std::memcpy(px(x, y), color, nch); }
    void hline(int y, int x1, int x2) const {  // inclusive, already clipped
        for (int x = x1; x <= x2; ++x) put(x, y);
    }
};

inline int cv_round(double v) { return (int)std::lrint(v); }  // half to even, as cvRound

// ------------------------------------------------------------------ clipping

bool clip_line(int64_t width, int64_t height, Pt& pt1, Pt& pt2) {
    if (width <= 0 || height <= 0) return false;
    int64_t right = width - 1, bottom = height - 1;
    int64_t &x1 = pt1.x, &y1 = pt1.y, &x2 = pt2.x, &y2 = pt2.y;
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

// ------------------------------------------------------------------ LINE_8

// Bresenham through LineIterator (8-connected, left to right), clipped first.
void line8(const Image& img, Pt p1, Pt p2) {
    if ((uint64_t)p1.x >= (uint64_t)img.w || (uint64_t)p2.x >= (uint64_t)img.w ||
        (uint64_t)p1.y >= (uint64_t)img.h || (uint64_t)p2.y >= (uint64_t)img.h) {
        if (!clip_line(img.w, img.h, p1, p2)) return;
    }
    int x1 = (int)p1.x, y1 = (int)p1.y, x2 = (int)p2.x, y2 = (int)p2.y;
    int delta_x = 1, delta_y = 1;
    int dx = x2 - x1, dy = y2 - y1;
    if (dx < 0) {  // left to right
        dx = -dx;
        dy = -dy;
        std::swap(x1, x2);
        std::swap(y1, y2);
    }
    if (dy < 0) {
        dy = -dy;
        delta_y = -1;
    }
    bool vert = dy > dx;
    if (vert) {
        std::swap(dx, dy);
        std::swap(delta_x, delta_y);
    }
    int err = dx - (dy + dy), plus_delta = dx + dx, minus_delta = -(dy + dy);
    int minus_shift = delta_x, plus_shift = 0, minus_step = 0, plus_step = delta_y;
    int count = dx + 1;
    if (vert) {
        std::swap(plus_step, plus_shift);
        std::swap(minus_step, minus_shift);
    }
    int x = x1, y = y1;
    for (int i = 0; i < count; ++i) {
        img.put(x, y);
        int mask = err < 0 ? -1 : 0;
        err += minus_delta + (plus_delta & mask);
        x += minus_shift + (plus_shift & mask);
        y += minus_step + (plus_step & mask);
    }
}

// Line2: the Bresenham of fixed-point end points (LINE_8 edges of a thick
// line or of a polygon given with fractional bits), both ends drawn.
void line2(const Image& img, Pt pt1, Pt pt2) {
    int64_t width = (int64_t)img.w << XY_SHIFT, height = (int64_t)img.h << XY_SHIFT;
    if (!clip_line(width, height, pt1, pt2)) return;
    int64_t dx = pt2.x - pt1.x, dy = pt2.y - pt1.y;
    int64_t j = dx < 0 ? -1 : 0;
    int64_t ax = (dx ^ j) - j;
    int64_t i = dy < 0 ? -1 : 0;
    int64_t ay = (dy ^ i) - i;
    int64_t x_step, y_step;
    int ecount;
    if (ax > ay) {
        dy = (dy ^ j) - j;
        pt1.x ^= pt2.x & j; pt2.x ^= pt1.x & j; pt1.x ^= pt2.x & j;
        pt1.y ^= pt2.y & j; pt2.y ^= pt1.y & j; pt1.y ^= pt2.y & j;
        x_step = XY_ONE;
        y_step = (dy << XY_SHIFT) / (ax | 1);
        ecount = (int)((pt2.x - pt1.x) >> XY_SHIFT);
    } else {
        dx = (dx ^ i) - i;
        pt1.x ^= pt2.x & i; pt2.x ^= pt1.x & i; pt1.x ^= pt2.x & i;
        pt1.y ^= pt2.y & i; pt2.y ^= pt1.y & i; pt1.y ^= pt2.y & i;
        x_step = (dx << XY_SHIFT) / (ay | 1);
        y_step = XY_ONE;
        ecount = (int)((pt2.y - pt1.y) >> XY_SHIFT);
    }
    pt1.x += XY_ONE >> 1;
    pt1.y += XY_ONE >> 1;
    auto put = [&](int64_t x, int64_t y) {
        if (0 <= x && x < img.w && 0 <= y && y < img.h) img.put((int)x, (int)y);
    };
    put((pt2.x + (XY_ONE >> 1)) >> XY_SHIFT, (pt2.y + (XY_ONE >> 1)) >> XY_SHIFT);
    if (ax > ay) {
        pt1.x >>= XY_SHIFT;
        for (; ecount >= 0; ecount--, pt1.x++, pt1.y += y_step) put(pt1.x, pt1.y >> XY_SHIFT);
    } else {
        pt1.y >>= XY_SHIFT;
        for (; ecount >= 0; ecount--, pt1.x += x_step, pt1.y++) put(pt1.x >> XY_SHIFT, pt1.y);
    }
}

// ------------------------------------------------------------------ LINE_AA

const int kSlopeCorr[] = {181, 181, 181, 182, 182, 183, 184, 185, 187, 188, 190, 192, 194, 196, 198, 201,
                          203, 206, 209, 211, 214, 218, 221, 224, 227, 231, 235, 238, 242, 246, 250, 254};

// OpenCV 5.0's Gaussian weights: [dist] for the pixel on the line, [dist + 32]
// and [63 - dist] for its two neighbours (symmetric about 15.5)
const int kFilter[] = {168, 177, 185, 194, 202, 210, 218, 224, 231, 236, 241, 246, 249, 252, 254, 254,
                       254, 254, 252, 249, 246, 241, 236, 231, 224, 218, 210, 202, 194, 185, 177, 168,
                       158, 149, 140, 131, 122, 114, 105, 97,  89,  82,  75,  68,  62,  56,  50,  45,
                       40,  36,  32,  28,  25,  22,  19,  16,  14,  12,  11,  9,   8,   7,   5,   5};

inline void put_aa(const Image& img, int x, int y, int a) {
    uint8_t* t = img.px(x, y);
    for (int c = 0; c < img.nch; ++c) {
        int v = t[c], col = img.color[c];
        v += ((col - v) * a + 127) >> 8;
        v += ((col - v) * a + 127) >> 8;
        t[c] = (uint8_t)v;
    }
}

void line_aa(const Image& img, Pt pt1, Pt pt2) {
    int64_t width = (int64_t)img.w << XY_SHIFT, height = (int64_t)img.h << XY_SHIFT;
    if (!clip_line(width, height, pt1, pt2)) return;
    int64_t dx = pt2.x - pt1.x, dy = pt2.y - pt1.y;
    int64_t j = dx < 0 ? -1 : 0;
    int64_t ax = (dx ^ j) - j;
    int64_t i = dy < 0 ? -1 : 0;
    int64_t ay = (dy ^ i) - i;
    int64_t x_step, y_step;
    int ecount, scount = 0, slope;
    if (ax > ay) {
        dy = (dy ^ j) - j;
        pt1.x ^= pt2.x & j; pt2.x ^= pt1.x & j; pt1.x ^= pt2.x & j;
        pt1.y ^= pt2.y & j; pt2.y ^= pt1.y & j; pt1.y ^= pt2.y & j;
        x_step = XY_ONE;
        y_step = (dy << XY_SHIFT) / (ax | 1);
        pt2.x += XY_ONE;
        ecount = (int)((pt2.x >> XY_SHIFT) - (pt1.x >> XY_SHIFT));
        j = -(pt1.x & (XY_ONE - 1));
        pt1.y += ((y_step * j) >> XY_SHIFT) + (XY_ONE >> 1);
        slope = (int)((y_step >> (XY_SHIFT - 5)) & 0x3f);
        slope ^= (y_step < 0 ? 0x3f : 0);
        i = (pt1.x >> (XY_SHIFT - 7)) & 0x78;
        j = (pt2.x >> (XY_SHIFT - 7)) & 0x78;
    } else {
        dx = (dx ^ i) - i;
        pt1.x ^= pt2.x & i; pt2.x ^= pt1.x & i; pt1.x ^= pt2.x & i;
        pt1.y ^= pt2.y & i; pt2.y ^= pt1.y & i; pt1.y ^= pt2.y & i;
        x_step = (dx << XY_SHIFT) / (ay | 1);
        y_step = XY_ONE;
        pt2.y += XY_ONE;
        ecount = (int)((pt2.y >> XY_SHIFT) - (pt1.y >> XY_SHIFT));
        j = -(pt1.y & (XY_ONE - 1));
        pt1.x += ((x_step * j) >> XY_SHIFT) + (XY_ONE >> 1);
        slope = (int)((x_step >> (XY_SHIFT - 5)) & 0x3f);
        slope ^= (x_step < 0 ? 0x3f : 0);
        i = (pt1.y >> (XY_SHIFT - 7)) & 0x78;
        j = (pt2.y >> (XY_SHIFT - 7)) & 0x78;
    }
    slope = (slope & 0x20) ? 0x100 : kSlopeCorr[slope];
    int ep_table[9];
    {
        int t0 = slope << 7;
        int t1 = ((0x78 - (int)i) | 4) * slope;
        int t2 = ((int)j | 4) * slope;
        ep_table[0] = 0;
        ep_table[8] = slope;
        ep_table[1] = ep_table[3] = ((((j - i) & 0x78) | 4) * slope >> 8) & 0x1ff;
        ep_table[2] = (t1 >> 8) & 0x1ff;
        ep_table[4] = ((((j - i) + 0x80) | 4) * slope >> 8) & 0x1ff;
        ep_table[5] = ((t1 + t0) >> 8) & 0x1ff;
        ep_table[6] = (t2 >> 8) & 0x1ff;
        ep_table[7] = ((t2 + t0) >> 8) & 0x1ff;
    }
    if (ax > ay) {
        int x = (int)(pt1.x >> XY_SHIFT);
        for (; ecount >= 0; x++, pt1.y += y_step, scount++, ecount--) {
            if ((unsigned)x >= (unsigned)img.w) continue;
            int y = (int)((pt1.y >> XY_SHIFT) - 1);
            int ep_corr = ep_table[(((scount >= 2) + 1) & (scount | 2)) * 3 + (((ecount >= 2) + 1) & (ecount | 2))];
            int dist = (int)((pt1.y >> (XY_SHIFT - 5)) & 31);
            int a = (ep_corr * kFilter[dist + 32] >> 8) & 0xff;
            if ((unsigned)y < (unsigned)img.h) put_aa(img, x, y, a);
            a = (ep_corr * kFilter[dist] >> 8) & 0xff;
            if ((unsigned)(y + 1) < (unsigned)img.h) put_aa(img, x, y + 1, a);
            a = (ep_corr * kFilter[63 - dist] >> 8) & 0xff;
            if ((unsigned)(y + 2) < (unsigned)img.h) put_aa(img, x, y + 2, a);
        }
    } else {
        int y = (int)(pt1.y >> XY_SHIFT);
        for (; ecount >= 0; y++, pt1.x += x_step, scount++, ecount--) {
            if ((unsigned)y >= (unsigned)img.h) continue;
            int x = (int)((pt1.x >> XY_SHIFT) - 1);
            int ep_corr = ep_table[(((scount >= 2) + 1) & (scount | 2)) * 3 + (((ecount >= 2) + 1) & (ecount | 2))];
            int dist = (int)((pt1.x >> (XY_SHIFT - 5)) & 31);
            int a = (ep_corr * kFilter[dist + 32] >> 8) & 0xff;
            if ((unsigned)x < (unsigned)img.w) put_aa(img, x, y, a);
            a = (ep_corr * kFilter[dist] >> 8) & 0xff;
            if ((unsigned)(x + 1) < (unsigned)img.w) put_aa(img, x + 1, y, a);
            a = (ep_corr * kFilter[63 - dist] >> 8) & 0xff;
            if ((unsigned)(x + 2) < (unsigned)img.w) put_aa(img, x + 2, y, a);
        }
    }
}

// ------------------------------------------------------------------ convex fill

void fill_convex(const Image& img, const Pt* v, int npts, int line_type, int shift) {
    struct {
        int idx, di;
        int64_t x, dx;
        int ye;
    } edge[2];
    int delta = 1 << shift >> 1;
    int imin = 0, edges = npts;
    int delta1, delta2;
    if (line_type < LINE_AA)
        delta1 = delta2 = XY_ONE >> 1;
    else
        delta1 = XY_ONE - 1, delta2 = 0;
    Pt p0 = v[npts - 1];
    p0.x <<= XY_SHIFT - shift;
    p0.y <<= XY_SHIFT - shift;
    int64_t xmin = v[0].x, xmax = v[0].x, ymin = v[0].y, ymax = v[0].y;
    for (int i = 0; i < npts; i++) {
        Pt p = v[i];
        if (p.y < ymin) {
            ymin = p.y;
            imin = i;
        }
        ymax = std::max(ymax, p.y);
        xmax = std::max(xmax, p.x);
        xmin = std::min(xmin, p.x);
        p.x <<= XY_SHIFT - shift;
        p.y <<= XY_SHIFT - shift;
        if (line_type <= 8) {
            if (shift == 0) {
                line8(img, Pt{p0.x >> XY_SHIFT, p0.y >> XY_SHIFT}, Pt{p.x >> XY_SHIFT, p.y >> XY_SHIFT});
            } else {
                line2(img, p0, p);
            }
        } else {
            line_aa(img, p0, p);
        }
        p0 = p;
    }
    xmin = (xmin + delta) >> shift;
    xmax = (xmax + delta) >> shift;
    ymin = (ymin + delta) >> shift;
    ymax = (ymax + delta) >> shift;
    if (npts < 3 || (int)xmax < 0 || (int)ymax < 0 || (int)xmin >= img.w || (int)ymin >= img.h) return;
    ymax = std::min<int64_t>(ymax, img.h - 1);
    edge[0].idx = edge[1].idx = imin;
    int y = (int)ymin;
    edge[0].ye = edge[1].ye = y;
    edge[0].di = 1;
    edge[1].di = npts - 1;
    edge[0].x = edge[1].x = -XY_ONE;
    edge[0].dx = edge[1].dx = 0;
    do {
        if (line_type < LINE_AA || y < (int)ymax || y == (int)ymin) {
            for (int i = 0; i < 2; i++) {
                if (y >= edge[i].ye) {
                    int idx0 = edge[i].idx, di = edge[i].di;
                    int idx = idx0 + di;
                    if (idx >= npts) idx -= npts;
                    int ty = 0;
                    for (; edges-- > 0;) {
                        ty = (int)((v[idx].y + delta) >> shift);
                        if (ty > y) {
                            int64_t xs = v[idx0].x, xe = v[idx].x;
                            if (shift != XY_SHIFT) {
                                xs <<= XY_SHIFT - shift;
                                xe <<= XY_SHIFT - shift;
                            }
                            edge[i].ye = ty;
                            edge[i].dx = ((xe - xs) * 2 + ((int64_t)ty - y)) / (2 * ((int64_t)ty - y));
                            edge[i].x = xs;
                            edge[i].idx = idx;
                            break;
                        }
                        idx0 = idx;
                        idx += di;
                        if (idx >= npts) idx -= npts;
                    }
                }
            }
        }
        if (edges < 0) break;
        if (y >= 0) {
            int left = 0, right = 1;
            if (edge[0].x > edge[1].x) left = 1, right = 0;
            int xx1 = (int)((edge[left].x + delta1) >> XY_SHIFT);
            int xx2 = (int)((edge[right].x + delta2) >> XY_SHIFT);
            if (xx2 >= 0 && xx1 < img.w) {
                if (xx1 < 0) xx1 = 0;
                if (xx2 >= img.w) xx2 = img.w - 1;
                img.hline(y, xx1, xx2);
            }
        }
        edge[0].x += edge[0].dx;
        edge[1].x += edge[1].dx;
    } while (++y <= (int)ymax);
}

// ------------------------------------------------------------------ circles

// sin of 0..450 degrees, as drawing.cpp's SinTable holds them: 7 decimals, float
float sin_table(int deg) {
    double v = std::sin(deg * 3.14159265358979323846 / 180.0);
    return (float)(std::nearbyint(v * 1e7) / 1e7);
}

void ellipse2poly(double cx, double cy, double aw, double ah, int angle, int arc_start, int arc_end, int delta,
                  std::vector<std::pair<double, double>>& pts) {
    while (angle < 0) angle += 360;
    while (angle > 360) angle -= 360;
    if (arc_start > arc_end) std::swap(arc_start, arc_end);
    while (arc_start < 0) {
        arc_start += 360;
        arc_end += 360;
    }
    while (arc_end > 360) {
        arc_end -= 360;
        arc_start -= 360;
    }
    if (arc_end - arc_start > 360) {
        arc_start = 0;
        arc_end = 360;
    }
    float alpha = sin_table(450 - angle), beta = sin_table(angle);
    pts.clear();
    for (int i = arc_start; i < arc_end + delta; i += delta) {
        int a = i;
        if (a > arc_end) a = arc_end;
        if (a < 0) a += 360;
        double x = aw * sin_table(450 - a);
        double y = ah * sin_table(a);
        pts.push_back({cx + x * alpha - y * beta, cy + x * beta + y * alpha});
    }
    if (pts.size() == 1) pts.assign(2, {cx, cy});
}

void thick_line(const Image& img, Pt p0, Pt p1, int thickness, int line_type, int flags, int shift);

void poly_line(const Image& img, const Pt* v, int count, bool closed, int thickness, int line_type, int shift) {
    if (count <= 0) return;
    int i = closed ? count - 1 : 0;
    int flags = 2 + !closed;
    Pt p0 = v[i];
    for (i = !closed; i < count; i++) {
        thick_line(img, p0, v[i], thickness, line_type, flags, shift);
        p0 = v[i];
        flags = 2;
    }
}

// EllipseEx for a full circle of fixed-point radius r about fixed-point c
void ellipse_ex(const Image& img, Pt c, int64_t r, int thickness, int line_type) {
    int delta = (int)((r + (XY_ONE >> 1)) >> XY_SHIFT);
    delta = delta < 3 ? 90 : delta < 10 ? 30 : delta < 15 ? 18 : 5;
    std::vector<std::pair<double, double>> dv;
    ellipse2poly((double)c.x, (double)c.y, (double)r, (double)r, 0, 0, 360, delta, dv);
    std::vector<Pt> v;
    Pt prev{(int64_t)0xFFFFFFFFFFFFFFFFull, (int64_t)0xFFFFFFFFFFFFFFFFull};
    for (const auto& q : dv) {
        Pt p;
        p.x = (int64_t)cv_round(q.first / XY_ONE) << XY_SHIFT;
        p.y = (int64_t)cv_round(q.second / XY_ONE) << XY_SHIFT;
        p.x += cv_round(q.first - p.x);
        p.y += cv_round(q.second - p.y);
        if (p != prev) {
            v.push_back(p);
            prev = p;
        }
    }
    if (v.size() == 1) v.assign(2, c);
    if (thickness >= 0)
        poly_line(img, v.data(), (int)v.size(), false, thickness, line_type, XY_SHIFT);
    else
        fill_convex(img, v.data(), (int)v.size(), line_type, XY_SHIFT);
}

// the midpoint circle of LINE_8 at thickness 1 or filled
void circle8(const Image& img, int cxi, int cyi, int radius, bool fill) {
    int err = 0, dx = radius, dy = 0, plus = 1, minus = (radius << 1) - 1;
    auto put = [&](int x, int y) {
        if ((unsigned)x < (unsigned)img.w && (unsigned)y < (unsigned)img.h) img.put(x, y);
    };
    auto hline = [&](int y, int x1, int x2) {
        if ((unsigned)y >= (unsigned)img.h) return;
        x1 = std::max(x1, 0);
        x2 = std::min(x2, img.w - 1);
        if (x1 <= x2) img.hline(y, x1, x2);
    };
    while (dx >= dy) {
        int y11 = cyi - dy, y12 = cyi + dy, y21 = cyi - dx, y22 = cyi + dx;
        int x11 = cxi - dx, x12 = cxi + dx, x21 = cxi - dy, x22 = cxi + dy;
        if (x11 < img.w && x12 >= 0 && y21 < img.h && y22 >= 0) {
            if (fill) {
                hline(y11, x11, x12);
                hline(y12, x11, x12);
                if (x21 < img.w && x22 >= 0) {
                    hline(y21, x21, x22);
                    hline(y22, x21, x22);
                }
            } else {
                put(x11, y11); put(x12, y11); put(x11, y12); put(x12, y12);
                put(x21, y21); put(x22, y21); put(x21, y22); put(x22, y22);
            }
        }
        dy++;
        err += plus;
        plus += 2;
        int mask = (err <= 0) - 1;
        err -= minus & mask;
        dx += mask;
        minus -= mask & 2;
    }
}

void thick_line(const Image& img, Pt p0, Pt p1, int thickness, int line_type, int flags, int shift) {
    const double INV_XY_ONE = 1. / XY_ONE;
    if (thickness > 1) {  // OpenCV 5.0 first clips a thick line to the image grown by the thickness
        int64_t pad = (int64_t)thickness << shift;
        Pt q0{p0.x + pad, p0.y + pad}, q1{p1.x + pad, p1.y + pad};
        if (!clip_line(((int64_t)img.w << shift) + 2 * pad, ((int64_t)img.h << shift) + 2 * pad, q0, q1)) return;
        p0 = {q0.x - pad, q0.y - pad};
        p1 = {q1.x - pad, q1.y - pad};
    }
    p0.x <<= XY_SHIFT - shift;
    p0.y <<= XY_SHIFT - shift;
    p1.x <<= XY_SHIFT - shift;
    p1.y <<= XY_SHIFT - shift;
    if (thickness <= 1) {
        if (line_type < LINE_AA && shift == 0) {
            p0.x = (p0.x + (XY_ONE >> 1)) >> XY_SHIFT;
            p0.y = (p0.y + (XY_ONE >> 1)) >> XY_SHIFT;
            p1.x = (p1.x + (XY_ONE >> 1)) >> XY_SHIFT;
            p1.y = (p1.y + (XY_ONE >> 1)) >> XY_SHIFT;
            line8(img, p0, p1);
        } else if (line_type < LINE_AA) {
            line2(img, p0, p1);
        } else {
            line_aa(img, p0, p1);
        }
        return;
    }
    Pt pt[4];
    double dx = (p0.x - p1.x) * INV_XY_ONE, dy = (p1.y - p0.y) * INV_XY_ONE;
    double r = dx * dx + dy * dy;
    int odd = thickness & 1;
    int64_t th = (int64_t)thickness << (XY_SHIFT - 1);
    if (std::fabs(r) > 2.220446049250313e-16) {
        r = (th + odd * XY_ONE * 0.5) / std::sqrt(r);
        int64_t dpx = cv_round(dy * r), dpy = cv_round(dx * r);
        pt[0] = {p0.x + dpx, p0.y + dpy};
        pt[1] = {p0.x - dpx, p0.y - dpy};
        pt[2] = {p1.x - dpx, p1.y - dpy};
        pt[3] = {p1.x + dpx, p1.y + dpy};
        fill_convex(img, pt, 4, line_type, XY_SHIFT);
    }
    for (int i = 0; i < 2; i++) {
        if (flags & (i + 1)) {
            if (line_type < LINE_AA) {
                int cx = (int)((p0.x + (XY_ONE >> 1)) >> XY_SHIFT);
                int cy = (int)((p0.y + (XY_ONE >> 1)) >> XY_SHIFT);
                circle8(img, cx, cy, (int)((th + (XY_ONE >> 1)) >> XY_SHIFT), true);
            } else {
                ellipse_ex(img, p0, th, -1, line_type);
            }
        }
        p0 = p1;
    }
}

Image make_image(uint8_t* data, int h, int w, int nch, const uint8_t* color) {
    Image img{data, h, w, nch, {0, 0, 0, 0}};
    std::memcpy(img.color, color, nch);
    return img;
}

std::vector<Pt> points(const int64_t* xy, int n) {
    std::vector<Pt> v(n);
    for (int i = 0; i < n; ++i) v[i] = {xy[2 * i], xy[2 * i + 1]};
    return v;
}

}  // namespace

extern "C" {

// cv2.polylines(img, [pts], closed, color, thickness, line_type, shift): n
// points (x, y) int64 pairs with `shift` fractional bits; a two-point open
// polyline is cv2.line.
void draw_polyline(uint8_t* data, int h, int w, int nch, const int64_t* xy, int n, int closed,
                   const uint8_t* color, int thickness, int line_type, int shift) {
    Image img = make_image(data, h, w, nch, color);
    std::vector<Pt> v = points(xy, n);
    poly_line(img, v.data(), n, closed != 0, thickness, line_type, shift);
}

// cv2.fillConvexPoly(img, pts, color, line_type, shift)
void draw_fill_convex(uint8_t* data, int h, int w, int nch, const int64_t* xy, int n, const uint8_t* color,
                      int line_type, int shift) {
    Image img = make_image(data, h, w, nch, color);
    std::vector<Pt> v = points(xy, n);
    if (n > 0) fill_convex(img, v.data(), n, line_type, shift);
}

// cv2.circle(img, (cx, cy), radius, color, thickness, line_type): thickness < 0 fills
void draw_circle(uint8_t* data, int h, int w, int nch, int cx, int cy, int radius, const uint8_t* color,
                 int thickness, int line_type) {
    Image img = make_image(data, h, w, nch, color);
    if (thickness > 1 || line_type != 8) {
        ellipse_ex(img, Pt{(int64_t)cx << XY_SHIFT, (int64_t)cy << XY_SHIFT}, (int64_t)radius << XY_SHIFT,
                   thickness, line_type);
    } else {
        circle8(img, cx, cy, radius, thickness < 0);
    }
}

}  // extern "C"
