// Native image preparation and PNG row unfiltering for the latent
// precompute.
//
// A copy of the JAX package's ``native/image_ops.cpp`` (``prepare_image``,
// ``prepare_image_batch``: the same arithmetic, so both packages prepare an
// image to the same bits), plus ``png_unfilter``, which undoes the five PNG
// row filters for ``png.py``'s reader.
//
// prepare_image fuses the whole pixel path -- Lanczos3 resample -> crop ->
// optional horizontal flip -> [-1,1] float32 CHW -- into one
// OpenMP-parallel pass over planes.  Resampling semantics match PIL's
// LANCZOS: support a=3 scaled by the downscale factor, border-clamped taps,
// per-pixel weight normalization.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC image_ops.cpp
//        (native/__init__.py builds it at first use and binds it with
//        ctypes)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr double kA = 3.0;  // Lanczos3
constexpr double kPi = 3.14159265358979323846;

double lanczos(double x) {
    if (x == 0.0) return 1.0;
    if (x <= -kA || x >= kA) return 0.0;
    double px = kPi * x;
    return kA * std::sin(px) * std::sin(px / kA) / (px * px);
}

// Precomputed taps for one output coordinate axis.
struct Taps {
    std::vector<int> start;      // first source index per output index
    std::vector<int> count;      // tap count per output index
    std::vector<float> weights;  // flattened [out][count]
    int max_count = 0;
};

Taps build_taps(int src_n, int dst_n) {
    Taps t;
    double scale = static_cast<double>(src_n) / dst_n;
    double filt = std::max(scale, 1.0);  // widen support when downscaling
    double support = kA * filt;
    t.max_count = static_cast<int>(std::ceil(2.0 * support)) + 2;
    t.start.resize(dst_n);
    t.count.resize(dst_n);
    t.weights.assign(static_cast<size_t>(dst_n) * t.max_count, 0.0f);
    for (int i = 0; i < dst_n; ++i) {
        double center = (i + 0.5) * scale - 0.5;
        int lo = static_cast<int>(std::floor(center - support));
        int hi = static_cast<int>(std::ceil(center + support));
        lo = std::max(lo, 0);
        hi = std::min(hi, src_n - 1);
        double sum = 0.0;
        int n = 0;
        for (int s = lo; s <= hi && n < t.max_count; ++s, ++n) {
            double w = lanczos((s - center) / filt);
            t.weights[static_cast<size_t>(i) * t.max_count + n] =
                static_cast<float>(w);
            sum += w;
        }
        if (sum != 0.0) {
            for (int k = 0; k < n; ++k)
                t.weights[static_cast<size_t>(i) * t.max_count + k] /=
                    static_cast<float>(sum);
        }
        t.start[i] = lo;
        t.count[i] = n;
    }
    return t;
}

}  // namespace

extern "C" {

// src: uint8 HWC RGB [sh, sw, 3]
// dst: float32 CHW [3, th, tw], (x/127.5 - 1)
// The image is first Lanczos-resized to (rh, rw), then the (th, tw) window
// at (crop_top, crop_left) is taken; flip mirrors horizontally.
// Returns 0 on success.
int prepare_image(const uint8_t* src, int sh, int sw,
                  float* dst, int th, int tw,
                  int crop_top, int crop_left, int rh, int rw, int flip) {
    if (sh <= 0 || sw <= 0 || th <= 0 || tw <= 0 || rh <= 0 || rw <= 0)
        return 1;
    if (crop_top < 0 || crop_left < 0 || crop_top + th > rh ||
        crop_left + tw > rw)
        return 2;

    Taps hx = build_taps(sw, rw);
    Taps vy = build_taps(sh, rh);

    // horizontal pass: [sh, rw, 3] floats, only columns we will need
    std::vector<float> mid(static_cast<size_t>(sh) * tw * 3);
#pragma omp parallel for schedule(static)
    for (int y = 0; y < sh; ++y) {
        const uint8_t* row = src + static_cast<size_t>(y) * sw * 3;
        float* orow = mid.data() + static_cast<size_t>(y) * tw * 3;
        for (int xo = 0; xo < tw; ++xo) {
            int xr = crop_left + xo;  // column in the resized plane
            const float* w = hx.weights.data() +
                static_cast<size_t>(xr) * hx.max_count;
            int s0 = hx.start[xr], n = hx.count[xr];
            float acc0 = 0, acc1 = 0, acc2 = 0;
            for (int k = 0; k < n; ++k) {
                const uint8_t* px = row + static_cast<size_t>(s0 + k) * 3;
                float wk = w[k];
                acc0 += wk * px[0];
                acc1 += wk * px[1];
                acc2 += wk * px[2];
            }
            orow[xo * 3 + 0] = acc0;
            orow[xo * 3 + 1] = acc1;
            orow[xo * 3 + 2] = acc2;
        }
    }

    // vertical pass + crop + flip + normalize into CHW
    const size_t plane = static_cast<size_t>(th) * tw;
#pragma omp parallel for schedule(static)
    for (int yo = 0; yo < th; ++yo) {
        int yr = crop_top + yo;  // row in the resized plane
        const float* w = vy.weights.data() +
            static_cast<size_t>(yr) * vy.max_count;
        int s0 = vy.start[yr], n = vy.count[yr];
        for (int xo = 0; xo < tw; ++xo) {
            float acc0 = 0, acc1 = 0, acc2 = 0;
            for (int k = 0; k < n; ++k) {
                const float* px = mid.data() +
                    (static_cast<size_t>(s0 + k) * tw + xo) * 3;
                float wk = w[k];
                acc0 += wk * px[0];
                acc1 += wk * px[1];
                acc2 += wk * px[2];
            }
            int xd = flip ? (tw - 1 - xo) : xo;
            size_t o = static_cast<size_t>(yo) * tw + xd;
            auto clamp01 = [](float v) {
                return std::min(255.0f, std::max(0.0f, v));
            };
            dst[0 * plane + o] = clamp01(acc0) / 127.5f - 1.0f;
            dst[1 * plane + o] = clamp01(acc1) / 127.5f - 1.0f;
            dst[2 * plane + o] = clamp01(acc2) / 127.5f - 1.0f;
        }
    }
    return 0;
}

// Batch variant: amortizes the taps computation across images of one bucket.
int prepare_image_batch(const uint8_t** srcs, const int* shs, const int* sws,
                        float* dst, int batch, int th, int tw,
                        const int* crop_tops, const int* crop_lefts,
                        const int* rhs, const int* rws, const int* flips) {
    int rc = 0;
    for (int b = 0; b < batch; ++b) {
        int r = prepare_image(srcs[b], shs[b], sws[b],
                              dst + static_cast<size_t>(b) * 3 * th * tw,
                              th, tw, crop_tops[b], crop_lefts[b],
                              rhs[b], rws[b], flips[b]);
        if (r != 0) rc = r;
    }
    return rc;
}

// PNG rows: data holds h rows of 1 + stride bytes (the filter type, then
// the filtered bytes); out receives h * stride unfiltered bytes.  bpp is
// the bytes per pixel (the left neighbour's distance).  The filters are
// None, Sub, Up, Average and Paeth (PNG spec, section 9).  Returns 0, or
// 3 with *bad_row set when a row's filter type is unknown.
int png_unfilter(const uint8_t* data, int h, int stride, int bpp,
                 uint8_t* out, int* bad_row) {
    // the row above the first is all zeros
    std::vector<uint8_t> zeros(static_cast<size_t>(stride), 0);
    for (int y = 0; y < h; ++y) {
        const uint8_t* line = data + static_cast<size_t>(y) * (stride + 1);
        const uint8_t* raw = line + 1;
        uint8_t* cur = out + static_cast<size_t>(y) * stride;
        const uint8_t* up = y > 0 ? cur - stride : zeros.data();
        const int n = std::min(bpp, stride);
        switch (line[0]) {
            case 0:  // None
                std::memcpy(cur, raw, static_cast<size_t>(stride));
                break;
            case 1:  // Sub
                std::memcpy(cur, raw, static_cast<size_t>(n));
                for (int i = bpp; i < stride; ++i)
                    cur[i] = static_cast<uint8_t>(raw[i] + cur[i - bpp]);
                break;
            case 2:  // Up
                for (int i = 0; i < stride; ++i)
                    cur[i] = static_cast<uint8_t>(raw[i] + up[i]);
                break;
            case 3:  // Average
                for (int i = 0; i < n; ++i)
                    cur[i] = static_cast<uint8_t>(raw[i] + (up[i] >> 1));
                for (int i = bpp; i < stride; ++i)
                    cur[i] = static_cast<uint8_t>(
                        raw[i] + ((cur[i - bpp] + up[i]) >> 1));
                break;
            case 4:  // Paeth: with a = c = 0 the predictor is b
                for (int i = 0; i < n; ++i)
                    cur[i] = static_cast<uint8_t>(raw[i] + up[i]);
                for (int i = bpp; i < stride; ++i) {
                    const int a = cur[i - bpp], b = up[i], c = up[i - bpp];
                    const int pa = std::abs(b - c), pb = std::abs(a - c),
                              pc = std::abs(a + b - 2 * c);
                    const int pred = (pa <= pb && pa <= pc) ? a
                                     : (pb <= pc ? b : c);
                    cur[i] = static_cast<uint8_t>(raw[i] + pred);
                }
                break;
            default:
                *bad_row = y;
                return 3;
        }
    }
    return 0;
}

}  // extern "C"
