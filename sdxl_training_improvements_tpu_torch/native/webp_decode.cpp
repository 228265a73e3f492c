// A WebP decoder for the image reader (``images.py``): what Pillow's
// ``Image.open(p).convert("RGB")`` gives, bit for bit, with the settings
// Pillow runs libwebp at (``WebPAnimDecoder``: non-premultiplied RGBA,
// fancy upsampling, no dithering, the loop filter on).  ``images.py``
// parses the RIFF container and hands over one frame: the payload of its
// ``VP8 `` or ``VP8L`` chunk and, for a lossy frame, of its ``ALPH`` chunk.
//
// * VP8L (lossless; the WebP lossless bitstream specification): canonical
//   prefix codes (simple codes of 1-2 symbols, a code of one symbol read
//   in 0 bits), the meta prefix codes of an entropy image, LZ77 with the
//   120-entry distance map, the color cache, and the predictor (modes
//   0-13; 14 and 15 read as 0), cross-color, subtract-green and
//   color-indexing transforms (pixels bundled at 2, 4 and 16 colors; an
//   index past the palette reads 0).  Codes libwebp refuses (no symbol,
//   an incomplete or over-subscribed tree, a code-length run past the
//   alphabet) are refused, as are back references before the first
//   pixel or past the last, a repeated transform, and data that ends
//   before the image: libwebp's reader pads a stream shorter than 8 bytes
//   with zeros to 8, and so does this one.
// * VP8 (RFC 6386, key frames): the boolean decoder (libwebp's, to its
//   arithmetic; a partition that reads past its end fails the frame),
//   segments, the token partitions
//   (macroblock row y reads partition y % n), the coefficient tokens with
//   their contexts, dequantization as ``VP8ParseQuant`` clamps it, the
//   WHT and the 4x4 inverse DCT as libwebp picks it for a block (DC-only,
//   AC3 or full; on valid data the three agree, and the full one is its
//   SSE2 version, whose 16-bit lanes wrap where a corrupt stream
//   overflows them), intra
//   prediction from unfiltered neighbours (127 above the frame, 129 left
//   of it, the macroblock's top-right four pixels reused below its first
//   sub-block row), and then the loop filter over the whole frame in
//   macroblock raster order (simple or normal, the per-segment and B_PRED
//   deltas, sharpness, hev thresholds; inner edges skipped for a
//   macroblock with no coefficients that is not B_PRED).
// * RGB: libwebp's fancy upsampler (``UpsampleRgbaLinePair``: 9-3-3-1
//   in two rounded steps, edge rows and columns replicated) and its
//   14-bit ``VP8YUVToR/G/B`` (src/dsp/yuv.h).
// * ALPH: raw or VP8L-compressed without a header (green = alpha), its
//   horizontal, vertical and gradient filters undone.  ``convert`` drops
//   alpha; it is decoded so that a frame whose alpha libwebp refuses is
//   refused, and handed back when asked for.
//
// No OpenMP: the precompute decodes one image a thread.
//
// Build: g++ -O3 -march=native -shared -fPIC webp_decode.cpp
//        (native/__init__.py builds it at first use and binds it with
//        ctypes)

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
    using std::runtime_error::runtime_error;
};

// ================================================================ VP8L

// The bits of a VP8L stream, least significant first.  Past the end it
// reads zeros and counts them: libwebp fails a stream that reads past
// max(size, 8) bytes.
class LBits {
public:
    LBits(const uint8_t* d, size_t n) : d_(d), n_(n),
        limit_(8 * static_cast<uint64_t>(std::max<size_t>(n, 8))) {}

    uint32_t peek(int nbits) const {
        const size_t i = static_cast<size_t>(pos_ >> 3);
        uint64_t v = 0;
        if (i + 8 <= n_) {
            for (int k = 7; k >= 0; --k) v = (v << 8) | d_[i + k];
        } else {
            for (int k = 7; k >= 0; --k)
                v = (v << 8) | (i + k < n_ ? d_[i + k] : 0);
        }
        return static_cast<uint32_t>(v >> (pos_ & 7)) &
               ((1u << nbits) - 1);
    }
    void skip(int nbits) { pos_ += nbits; }
    uint32_t read(int nbits) {
        const uint32_t v = nbits ? peek(nbits) : 0;
        pos_ += nbits;
        return v;
    }
    bool overrun() const { return pos_ > limit_; }

private:
    const uint8_t* d_;
    size_t n_;
    uint64_t pos_ = 0, limit_;
};

// A canonical prefix code: symbols of codes up to 8 bits from a lookup
// of the next 8 bits; longer codes bit by bit.  A code of one symbol
// reads in 0 bits.
class PrefixCode {
public:
    // From the code lengths of an alphabet; false where libwebp's
    // ``BuildHuffmanTable`` fails (no symbol, or a code that is not
    // complete).
    bool build(const int* lengths, int n) {
        int count[16] = {0};
        for (int s = 0; s < n; ++s) ++count[lengths[s]];
        if (count[0] == n) return false;
        single_ = -1;
        if (n - count[0] == 1) {
            for (int s = 0; s < n; ++s)
                if (lengths[s]) single_ = s;
            return true;
        }
        int open = 1;
        for (int l = 1; l <= 15; ++l) {
            open = 2 * open - count[l];
            if (open < 0) return false;
        }
        if (open != 0) return false;
        // canonical codes in (length, symbol) order
        int code = 0;
        sorted_.clear();
        for (int l = 1; l <= 15; ++l) {
            first_code_[l] = code;
            first_index_[l] = static_cast<int>(sorted_.size());
            count_[l] = count[l];
            for (int s = 0; s < n; ++s)
                if (lengths[s] == l)
                    sorted_.push_back(static_cast<uint16_t>(s));
            code = (code + count[l]) << 1;
        }
        std::fill(root_, root_ + 256, 0);
        for (int l = 1; l <= 8; ++l) {
            for (int i = 0; i < count[l]; ++i) {
                const int c = first_code_[l] + i;
                int r = 0;  // the code as the reader meets it: reversed
                for (int b = 0; b < l; ++b) r |= ((c >> (l - 1 - b)) & 1) << b;
                const uint16_t e = static_cast<uint16_t>(
                    (l << 12) | sorted_[first_index_[l] + i]);
                for (int k = r; k < 256; k += 1 << l) root_[k] = e;
            }
        }
        return true;
    }

    int single() const { return single_; }

    int decode(LBits& br) const {
        if (single_ >= 0) return single_;
        const uint32_t v = br.peek(15);
        const uint16_t e = root_[v & 0xff];
        if (e) {
            br.skip(e >> 12);
            return e & 0xfff;
        }
        int code = 0;
        for (int l = 1; l <= 15; ++l) {
            code = (code << 1) | ((v >> (l - 1)) & 1);
            const int k = code - first_code_[l];
            if (k >= 0 && k < count_[l]) {
                br.skip(l);
                return sorted_[first_index_[l] + k];
            }
        }
        throw Error("corrupt data (bad prefix code)");  // not reached
    }

private:
    int single_ = -1;
    uint16_t root_[256];
    int first_code_[16] = {0}, first_index_[16] = {0}, count_[16] = {0};
    std::vector<uint16_t> sorted_;
};

const int kAlphabetSize[5] = {256 + 24, 256, 256, 256, 40};
const int kCodeLengthOrder[19] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                  7,  8,  9, 10, 11, 12, 13, 14, 15};
const int kCacheMaxBits = 11;

// The distance map: (dx, dy) of the first 120 distance codes
const int8_t kDistanceMap[120][2] = {
    {0, 1},  {1, 0},  {1, 1},  {-1, 1}, {0, 2},  {2, 0},  {1, 2},  {-1, 2},
    {2, 1},  {-2, 1}, {2, 2},  {-2, 2}, {0, 3},  {3, 0},  {1, 3},  {-1, 3},
    {3, 1},  {-3, 1}, {2, 3},  {-2, 3}, {3, 2},  {-3, 2}, {0, 4},  {4, 0},
    {1, 4},  {-1, 4}, {4, 1},  {-4, 1}, {3, 3},  {-3, 3}, {2, 4},  {-2, 4},
    {4, 2},  {-4, 2}, {0, 5},  {3, 4},  {-3, 4}, {4, 3},  {-4, 3}, {5, 0},
    {1, 5},  {-1, 5}, {5, 1},  {-5, 1}, {2, 5},  {-2, 5}, {5, 2},  {-5, 2},
    {4, 4},  {-4, 4}, {3, 5},  {-3, 5}, {5, 3},  {-5, 3}, {0, 6},  {6, 0},
    {1, 6},  {-1, 6}, {6, 1},  {-6, 1}, {2, 6},  {-2, 6}, {6, 2},  {-6, 2},
    {4, 5},  {-4, 5}, {5, 4},  {-5, 4}, {3, 6},  {-3, 6}, {6, 3},  {-6, 3},
    {0, 7},  {7, 0},  {1, 7},  {-1, 7}, {5, 5},  {-5, 5}, {7, 1},  {-7, 1},
    {4, 6},  {-4, 6}, {6, 4},  {-6, 4}, {2, 7},  {-2, 7}, {7, 2},  {-7, 2},
    {3, 7},  {-3, 7}, {7, 3},  {-7, 3}, {5, 6},  {-5, 6}, {6, 5},  {-6, 5},
    {8, 0},  {4, 7},  {-4, 7}, {7, 4},  {-7, 4}, {8, 1},  {8, 2},  {6, 6},
    {-6, 6}, {8, 3},  {5, 7},  {-5, 7}, {7, 5},  {-7, 5}, {8, 4},  {6, 7},
    {-6, 7}, {7, 6},  {-7, 6}, {8, 5},  {7, 7},  {-7, 7}, {8, 6},  {8, 7}};

inline int subsample(int size, int bits) {
    return (size + (1 << bits) - 1) >> bits;
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
    const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
    const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
    return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline uint32_t average2(uint32_t a, uint32_t b) {
    return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline uint32_t clip255(int v) {
    return v < 0 ? 0 : v > 255 ? 255 : static_cast<uint32_t>(v);
}

inline uint32_t add_subtract_full(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
        const int v = static_cast<int>((a >> s) & 0xff) +
                      static_cast<int>((b >> s) & 0xff) -
                      static_cast<int>((c >> s) & 0xff);
        out |= clip255(v) << s;
    }
    return out;
}

inline uint32_t add_subtract_half(uint32_t a, uint32_t b) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
        const int x = static_cast<int>((a >> s) & 0xff);
        const int y = static_cast<int>((b >> s) & 0xff);
        out |= clip255(x + (x - y) / 2) << s;
    }
    return out;
}

inline uint32_t select_pred(uint32_t t, uint32_t l, uint32_t tl) {
    int pa_minus_pb = 0;  // sum |L - TL| - |T - TL|
    for (int s = 0; s < 32; s += 8) {
        const int a = (t >> s) & 0xff, b = (l >> s) & 0xff,
                  c = (tl >> s) & 0xff;
        pa_minus_pb += std::abs(b - c) - std::abs(a - c);
    }
    return pa_minus_pb <= 0 ? t : l;
}

// libwebp's VP8LPredictors[mode](left, top row at x)
inline uint32_t predict(int mode, uint32_t L, const uint32_t* top) {
    switch (mode) {
    case 1: return L;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(L, top[1]), top[0]);
    case 6: return average2(L, top[-1]);
    case 7: return average2(L, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10:
        return average2(average2(L, top[-1]), average2(top[0], top[1]));
    case 11: return select_pred(top[0], L, top[-1]);
    case 12: return add_subtract_full(L, top[0], top[-1]);
    case 13: return add_subtract_half(average2(L, top[0]), top[-1]);
    default: return 0xff000000u;  // 0, and 14-15 as libwebp pads them
    }
}

inline int color_delta(int8_t pred, int8_t color) {
    return (static_cast<int>(pred) * color) >> 5;
}

struct Transform {
    int type = 0, bits = 0, xsize = 0;
    std::vector<uint32_t> data;
};

// The prefix codes of one image: one group (green, red, blue, alpha,
// distance) or the groups of an entropy image.
struct Codes {
    int bits = 0, xsize = 0;  // entropy image tile bits and width
    std::vector<uint32_t> image;  // group index of each tile
    std::vector<PrefixCode> groups;  // 5 a group
    int cache_bits = 0;
    // every group libwebp keeps has single-symbol red, blue and alpha
    // codes: its 8-bit alpha path may apply
    bool rba_trivial = true;
};

class Lossless {
public:
    Lossless(const uint8_t* d, size_t n) : br_(d, n) {}

    // The VP8L frame: the header, then the image.  ARGB out.
    std::vector<uint32_t> decode_frame(int* w, int* h) {
        if (br_.read(8) != 0x2f) throw Error("not a VP8L stream");
        *w = static_cast<int>(br_.read(14)) + 1;
        *h = static_cast<int>(br_.read(14)) + 1;
        br_.read(1);  // alpha hint
        if (br_.read(3) != 0) throw Error("unknown VP8L version");
        return decode_stream(*w, *h, true, false);
    }

    // The image of an ALPH chunk (no header): its green channel is alpha.
    std::vector<uint32_t> decode_alpha(int w, int h) {
        return decode_stream(w, h, true, true);
    }

    // what the image used: its transforms (a bit a type), color cache
    // bits, entropy image (0/1) and palette size
    int transform_mask() const {
        int m = 0;
        for (const Transform& t : transforms_) m |= 1 << t.type;
        return m;
    }
    int cache_bits = 0, meta = 0, palette = 0;

private:
    LBits br_;
    std::vector<Transform> transforms_;
    unsigned seen_ = 0;

    void check() const {
        if (br_.overrun()) throw Error("truncated data (VP8L)");
    }

    void read_code(int alphabet, PrefixCode& out) {
        std::vector<int> lengths(alphabet, 0);
        if (br_.read(1)) {  // simple code: 1 or 2 symbols
            const int nsym = static_cast<int>(br_.read(1)) + 1;
            const int first8 = static_cast<int>(br_.read(1));
            int s = static_cast<int>(br_.read(first8 ? 8 : 1));
            if (s < alphabet) lengths[s] = 1;
            if (nsym == 2) {
                s = static_cast<int>(br_.read(8));
                if (s < alphabet) lengths[s] = 1;
            }
        } else {
            int clen[19] = {0};
            const int num = static_cast<int>(br_.read(4)) + 4;
            for (int i = 0; i < num; ++i)
                clen[kCodeLengthOrder[i]] = static_cast<int>(br_.read(3));
            read_code_lengths(clen, alphabet, lengths.data());
        }
        check();
        if (!out.build(lengths.data(), alphabet))
            throw Error("corrupt data (invalid prefix code)");
    }

    void read_code_lengths(const int* clen, int n, int* lengths) {
        PrefixCode lc;
        if (!lc.build(clen, 19))
            throw Error("corrupt data (invalid code-length code)");
        int max_symbol = n;
        if (br_.read(1)) {
            const int nbits = 2 + 2 * static_cast<int>(br_.read(3));
            max_symbol = 2 + static_cast<int>(br_.read(nbits));
            if (max_symbol > n)
                throw Error("corrupt data (code lengths past the alphabet)");
        }
        int sym = 0, prev = 8;
        while (sym < n) {
            if (max_symbol-- == 0) break;
            const int c = lc.decode(br_);
            if (c < 16) {
                lengths[sym++] = c;
                if (c) prev = c;
            } else {
                static const int kExtra[3] = {2, 3, 7};
                static const int kOffset[3] = {3, 3, 11};
                int rep = static_cast<int>(br_.read(kExtra[c - 16])) +
                          kOffset[c - 16];
                if (sym + rep > n)
                    throw Error("corrupt data (code-length run past the "
                                "alphabet)");
                const int v = c == 16 ? prev : 0;
                while (rep-- > 0) lengths[sym++] = v;
            }
        }
    }

    void read_codes(int xsize, int ysize, bool allow_meta, Codes& c) {
        int ngroups = 1;
        if (allow_meta && br_.read(1)) {
            c.bits = static_cast<int>(br_.read(3)) + 2;
            c.xsize = subsample(xsize, c.bits);
            c.image = decode_stream(c.xsize, subsample(ysize, c.bits),
                                    false, false);
            for (uint32_t& p : c.image) {
                p = (p >> 8) & 0xffff;
                ngroups = std::max(ngroups, static_cast<int>(p) + 1);
            }
        }
        check();
        // libwebp keeps only the groups the entropy image uses when there
        // are more than 1000 or more than pixels; every group is read and
        // checked either way
        const bool remap = ngroups > 1000 ||
            static_cast<int64_t>(ngroups) > static_cast<int64_t>(xsize) * ysize;
        std::vector<int> map(ngroups, remap ? -1 : 0);
        int kept = ngroups;
        if (remap) {
            kept = 0;
            for (uint32_t& p : c.image) {
                if (map[p] < 0) map[p] = kept++;
                p = static_cast<uint32_t>(map[p]);
            }
        }
        c.groups.assign(static_cast<size_t>(kept) * 5, PrefixCode());
        PrefixCode scratch;
        for (int g = 0; g < ngroups; ++g) {
            const int slot = remap ? map[g] : g;
            for (int j = 0; j < 5; ++j) {
                int alphabet = kAlphabetSize[j];
                if (j == 0 && c.cache_bits) alphabet += 1 << c.cache_bits;
                PrefixCode& dst = slot >= 0 ?
                    c.groups[static_cast<size_t>(slot) * 5 + j] : scratch;
                read_code(alphabet, dst);
                if (slot >= 0 && j >= 1 && j <= 3 && dst.single() < 0)
                    c.rba_trivial = false;
            }
        }
    }

    static int copy_value(int sym, LBits& br) {
        if (sym < 4) return sym + 1;
        const int extra = (sym - 2) >> 1;
        const int offset = (2 + (sym & 1)) << extra;
        return offset + static_cast<int>(br.read(extra)) + 1;
    }

    // The entropy-coded pixels of an xsize x ysize image.  ``lenient``:
    // libwebp's 8-bit alpha path, which tolerates a read past the end
    // while it decodes the last pixel.
    std::vector<uint32_t> decode_pixels(int xsize, int ysize,
                                        const Codes& c, bool lenient) {
        const size_t total = static_cast<size_t>(xsize) * ysize;
        std::vector<uint32_t> out(total);
        const int cache_size = c.cache_bits ? 1 << c.cache_bits : 0;
        std::vector<uint32_t> cache(cache_size, 0);
        const int cache_shift = 32 - c.cache_bits;
        size_t pos = 0, cached = 0;
        int x = 0, y = 0;
        while (pos < total) {
            if (lenient && br_.overrun()) break;
            const PrefixCode* g = c.groups.data();
            if (c.bits) {
                const uint32_t t = c.image[static_cast<size_t>(y >> c.bits) *
                                           c.xsize + (x >> c.bits)];
                g += static_cast<size_t>(t) * 5;
            }
            const int code = g[0].decode(br_);
            if (code < 256) {
                const uint32_t r = g[1].decode(br_);
                const uint32_t b = g[2].decode(br_);
                const uint32_t a = g[3].decode(br_);
                out[pos++] = (a << 24) | (r << 16) |
                             (static_cast<uint32_t>(code) << 8) | b;
                if (++x == xsize) { x = 0; ++y; }
            } else if (code < 256 + 24) {
                const int length = copy_value(code - 256, br_);
                const int dsym = g[4].decode(br_);
                const int dcode = copy_value(dsym, br_);
                int dist;
                if (dcode > 120) {
                    dist = dcode - 120;
                } else {
                    dist = kDistanceMap[dcode - 1][0] +
                           kDistanceMap[dcode - 1][1] * xsize;
                    if (dist < 1) dist = 1;
                }
                if (!lenient) check();
                if (pos < static_cast<size_t>(dist) ||
                    total - pos < static_cast<size_t>(length))
                    throw Error("corrupt data (bad back reference)");
                for (int k = 0; k < length; ++k, ++pos)
                    out[pos] = out[pos - dist];
                x += length;
                while (x >= xsize) { x -= xsize; ++y; }
            } else if (code < 256 + 24 + cache_size) {
                while (cached < pos) {
                    const uint32_t p = out[cached++];
                    cache[(0x1e35a7bdu * p) >> cache_shift] = p;
                }
                out[pos++] = cache[code - 256 - 24];
                if (++x == xsize) { x = 0; ++y; }
            } else {
                throw Error("corrupt data (bad symbol)");
            }
            if (!lenient) check();
        }
        if (pos < total) throw Error("truncated data (VP8L)");
        return out;
    }

    void read_transform(int* xsize, int ysize) {
        const int type = static_cast<int>(br_.read(2));
        if (seen_ & (1u << type)) throw Error("corrupt data (a transform "
                                              "repeats)");
        seen_ |= 1u << type;
        Transform t;
        t.type = type;
        t.xsize = *xsize;
        if (type == 0 || type == 1) {  // predictor, cross-color
            t.bits = static_cast<int>(br_.read(3)) + 2;
            t.data = decode_stream(subsample(t.xsize, t.bits),
                                   subsample(ysize, t.bits), false, false);
        } else if (type == 3) {  // color indexing
            const int n = static_cast<int>(br_.read(8)) + 1;
            t.bits = n > 16 ? 0 : n > 4 ? 1 : n > 2 ? 2 : 3;
            *xsize = subsample(t.xsize, t.bits);
            palette = n;
            std::vector<uint32_t> pal = decode_stream(n, 1, false, false);
            t.data.assign(static_cast<size_t>(1) << (8 >> t.bits), 0);
            t.data[0] = pal[0];
            for (int i = 1; i < n; ++i)
                t.data[i] = add_pixels(pal[i], t.data[i - 1]);
        }
        transforms_.push_back(std::move(t));
    }

    std::vector<uint32_t> decode_stream(int xsize, int ysize, bool level0,
                                        bool alpha) {
        int tx = xsize;
        if (level0) {
            while (br_.read(1)) {
                read_transform(&tx, ysize);
                check();
            }
        }
        Codes c;
        if (br_.read(1)) {
            c.cache_bits = static_cast<int>(br_.read(4));
            if (c.cache_bits < 1 || c.cache_bits > kCacheMaxBits)
                throw Error("corrupt data (bad color cache size)");
        }
        read_codes(tx, ysize, level0, c);
        if (level0) {
            cache_bits = c.cache_bits;
            meta = c.bits != 0;
        }
        // libwebp decodes alpha one byte a pixel when it is a palette
        // image without a color cache
        const bool lenient = alpha && transforms_.size() == 1 &&
                             transforms_[0].type == 3 && !c.cache_bits &&
                             c.rba_trivial;
        std::vector<uint32_t> px = decode_pixels(tx, ysize, c, lenient);
        if (!level0) return px;
        for (size_t i = transforms_.size(); i-- > 0;)
            px = inverse(transforms_[i], px, ysize);
        return px;
    }

    static std::vector<uint32_t> inverse(const Transform& t,
                                         std::vector<uint32_t>& px,
                                         int ysize) {
        const int w = t.xsize;
        switch (t.type) {
        case 0: {  // predictor
            const int tiles = subsample(w, t.bits);
            for (int y = 0; y < ysize; ++y) {
                uint32_t* row = px.data() + static_cast<size_t>(y) * w;
                if (y == 0) {
                    row[0] = add_pixels(row[0], 0xff000000u);
                    for (int x = 1; x < w; ++x)
                        row[x] = add_pixels(row[x], row[x - 1]);
                    continue;
                }
                const uint32_t* top = row - w;
                const uint32_t* modes =
                    t.data.data() + static_cast<size_t>(y >> t.bits) * tiles;
                row[0] = add_pixels(row[0], top[0]);
                for (int x = 1; x < w; ++x) {
                    const int mode = (modes[x >> t.bits] >> 8) & 0xf;
                    row[x] = add_pixels(row[x],
                                        predict(mode, row[x - 1], top + x));
                }
            }
            return std::move(px);
        }
        case 1: {  // cross-color
            const int tiles = subsample(w, t.bits);
            for (int y = 0; y < ysize; ++y) {
                uint32_t* row = px.data() + static_cast<size_t>(y) * w;
                const uint32_t* m =
                    t.data.data() + static_cast<size_t>(y >> t.bits) * tiles;
                for (int x = 0; x < w; ++x) {
                    const uint32_t code = m[x >> t.bits];
                    const int8_t g2r = static_cast<int8_t>(code & 0xff);
                    const int8_t g2b = static_cast<int8_t>((code >> 8) & 0xff);
                    const int8_t r2b = static_cast<int8_t>((code >> 16) & 0xff);
                    const uint32_t argb = row[x];
                    const int8_t green = static_cast<int8_t>(argb >> 8);
                    int r = (argb >> 16) & 0xff, b = argb & 0xff;
                    r = (r + color_delta(g2r, green)) & 0xff;
                    b += color_delta(g2b, green);
                    b += color_delta(r2b, static_cast<int8_t>(r));
                    b &= 0xff;
                    row[x] = (argb & 0xff00ff00u) |
                             (static_cast<uint32_t>(r) << 16) |
                             static_cast<uint32_t>(b);
                }
            }
            return std::move(px);
        }
        case 2:  // subtract green
            for (uint32_t& p : px) {
                const uint32_t g = (p >> 8) & 0xff;
                const uint32_t rb = ((p & 0x00ff00ffu) + ((g << 16) | g)) &
                                    0x00ff00ffu;
                p = (p & 0xff00ff00u) | rb;
            }
            return std::move(px);
        default: {  // color indexing
            const int pw = subsample(w, t.bits);
            std::vector<uint32_t> out(static_cast<size_t>(w) * ysize);
            const int bpp = 8 >> t.bits;
            const uint32_t mask = (1u << bpp) - 1;
            const int per = 1 << t.bits;
            for (int y = 0; y < ysize; ++y) {
                const uint32_t* src = px.data() + static_cast<size_t>(y) * pw;
                uint32_t* dst = out.data() + static_cast<size_t>(y) * w;
                uint32_t packed = 0;
                for (int x = 0; x < w; ++x) {
                    if ((x & (per - 1)) == 0) packed = (*src++ >> 8) & 0xff;
                    dst[x] = t.data[packed & mask];
                    packed >>= bpp;
                }
            }
            return out;
        }
        }
    }
};

// ================================================================= VP8

// The boolean decoder as libwebp's runs it on a 64-bit x86 or ARM host
// (bit_reader_utils.h, BITS = 56: 7 bytes a load while 8 remain, then one
// at a time; the end-of-data flag set where VP8LoadFinalBytes sets it).
// A stream whose first byte is 0xff leaves the decoder's value above its
// range, and from there on the bits depend on this arithmetic: 64-bit
// value, 32-bit window, VP8GetSigned's sign-mask form.
class BoolDecoder {
public:
    void init(const uint8_t* p, size_t n) {
        buf_ = p;
        end_ = p + n;
        max_ = n >= 8 ? p + n - 8 + 1 : p;
        value_ = 0;
        bits_ = -8;
        range_ = 255 - 1;
        eof_ = false;
        load();
    }
    bool eof() const { return eof_; }

    int get(int prob) {
        uint32_t range = range_;
        if (bits_ < 0) load();
        const int pos = bits_;
        const uint32_t split = (range * static_cast<uint32_t>(prob)) >> 8;
        const uint32_t value = static_cast<uint32_t>(value_ >> pos);
        const int bit = value > split;
        if (bit) {
            range -= split;
            value_ -= static_cast<uint64_t>(split + 1) << pos;
        } else {
            range = split + 1;
        }
        const int shift = 7 ^ (31 - __builtin_clz(range));
        range <<= shift;
        bits_ -= shift;
        range_ = range - 1;
        return bit;
    }
    // VP8GetSigned: v with the sign read at probability 1/2
    int get_signed(int v) {
        if (bits_ < 0) load();
        const int pos = bits_;
        const uint32_t split = range_ >> 1;
        const uint32_t value = static_cast<uint32_t>(value_ >> pos);
        const int32_t mask = static_cast<int32_t>(split - value) >> 31;
        bits_ -= 1;
        range_ += static_cast<uint32_t>(mask);
        range_ |= 1;
        value_ -= static_cast<uint64_t>((split + 1) &
                                        static_cast<uint32_t>(mask)) << pos;
        return (v ^ mask) - mask;
    }
    int value(int nbits) {
        int v = 0;
        while (nbits-- > 0) v |= get(0x80) << nbits;
        return v;
    }
    int signed_value(int nbits) {
        const int v = value(nbits);
        return get(0x80) ? -v : v;
    }

private:
    void load() {
        if (buf_ < max_) {
            uint64_t in = 0;
            for (int k = 0; k < 8; ++k) in = (in << 8) | buf_[k];
            buf_ += 7;
            value_ = (in >> 8) | (value_ << 56);
            bits_ += 56;
        } else if (buf_ < end_) {
            bits_ += 8;
            value_ = *buf_++ | (value_ << 8);
        } else if (!eof_) {
            value_ <<= 8;
            bits_ += 8;
            eof_ = true;
        } else {
            bits_ = 0;
        }
    }
    const uint8_t* buf_ = nullptr;
    const uint8_t* end_ = nullptr;
    const uint8_t* max_ = nullptr;
    uint64_t value_ = 0;
    uint32_t range_ = 254;
    int bits_ = -8;
    bool eof_ = false;
};

const uint8_t kDcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  10,  11,  12,  13,  14,  15,  16,  17,
    17,  18,  19,  20,  20,  21,  21,  22,  22,  23,  23,  24,  25,  25,  26,
    27,  28,  29,  30,  31,  32,  33,  34,  35,  36,  37,  37,  38,  39,  40,
    41,  42,  43,  44,  45,  46,  46,  47,  48,  49,  50,  51,  52,  53,  54,
    55,  56,  57,  58,  59,  60,  61,  62,  63,  64,  65,  66,  67,  68,  69,
    70,  71,  72,  73,  74,  75,  76,  76,  77,  78,  79,  80,  81,  82,  83,
    84,  85,  86,  87,  88,  89,  91,  93,  95,  96,  98,  100, 101, 102, 104,
    106, 108, 110, 112, 114, 116, 118, 122, 124, 126, 128, 130, 132, 134, 136,
    138, 140, 143, 145, 148, 151, 154, 157};

const uint16_t kAcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  11,  12,  13,  14,  15,  16,  17,  18,
    19,  20,  21,  22,  23,  24,  25,  26,  27,  28,  29,  30,  31,  32,  33,
    34,  35,  36,  37,  38,  39,  40,  41,  42,  43,  44,  45,  46,  47,  48,
    49,  50,  51,  52,  53,  54,  55,  56,  57,  58,  60,  62,  64,  66,  68,
    70,  72,  74,  76,  78,  80,  82,  84,  86,  88,  90,  92,  94,  96,  98,
    100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128, 131, 134,
    137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177, 181,
    185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245,
    249, 254, 259, 264, 269, 274, 279, 284};

// RFC 6386 13.5, default_coeff_probs [type][band][context][node]
const uint8_t kCoeffsProba0[4][8][3][11] = {
    {{{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
     {{253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128},
      {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128},
      {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
     {{1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128},
      {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128},
      {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
     {{1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128},
      {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128},
      {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
     {{1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128},
      {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128},
      {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
     {{1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128},
      {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128},
      {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
     {{1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128},
      {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128},
      {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
     {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}},
    {{{198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62},
      {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1},
      {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
     {{1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128},
      {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128},
      {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
     {{1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128},
      {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128},
      {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
     {{1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128},
      {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128},
      {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
     {{1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128},
      {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128},
      {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
     {{1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128},
      {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128},
      {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
     {{1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128},
      {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128},
      {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
     {{1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128},
      {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128},
      {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}}},
    {{{253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128},
      {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128},
      {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
     {{1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128},
      {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128},
      {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
     {{1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128},
      {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128},
      {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
     {{1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128},
      {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
      {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
     {{1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128},
      {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128},
      {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
     {{1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
     {{1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128},
      {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128},
      {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
     {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}},
    {{{202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255},
      {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128},
      {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
     {{1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128},
      {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128},
      {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
     {{1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128},
      {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128},
      {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
     {{1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128},
      {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128},
      {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
     {{1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128},
      {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128},
      {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
     {{1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128},
      {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128},
      {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
     {{1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128},
      {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128},
      {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
     {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}}}};

// RFC 6386 13.4, coeff_update_probs
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    {{{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255},
      {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255},
      {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255},
      {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
    {{{217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255},
      {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
     {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
    {{{186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255},
      {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255},
      {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
     {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
    {{{248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
      {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255},
      {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}}};

// 4x4 intra modes in RFC 6386's order
enum { B_DC, B_TM, B_VE, B_HE, B_LD, B_RD, B_VR, B_VL, B_HD, B_HU };
// 16x16 and chroma modes, named by the 4x4 mode their contexts take
enum { DC_PRED = B_DC, TM_PRED = B_TM, V_PRED = B_VE, H_PRED = B_HE };

// RFC 6386 11.5, kf_bmode_probs [above][left]
const uint8_t kBModesProba[10][10][9] = {
    {{231, 120, 48, 89, 115, 113, 120, 152, 112},
     {152, 179, 64, 126, 170, 118, 46, 70, 95},
     {175, 69, 143, 80, 85, 82, 72, 155, 103},
     {56, 58, 10, 171, 218, 189, 17, 13, 152},
     {144, 71, 10, 38, 171, 213, 144, 34, 26},
     {114, 26, 17, 163, 44, 195, 21, 10, 173},
     {121, 24, 80, 195, 26, 62, 44, 64, 85},
     {170, 46, 55, 19, 136, 160, 33, 206, 71},
     {63, 20, 8, 114, 114, 208, 12, 9, 226},
     {81, 40, 11, 96, 182, 84, 29, 16, 36}},
    {{134, 183, 89, 137, 98, 101, 106, 165, 148},
     {72, 187, 100, 130, 157, 111, 32, 75, 80},
     {66, 102, 167, 99, 74, 62, 40, 234, 128},
     {41, 53, 9, 178, 241, 141, 26, 8, 107},
     {104, 79, 12, 27, 217, 255, 87, 17, 7},
     {74, 43, 26, 146, 73, 166, 49, 23, 157},
     {65, 38, 105, 160, 51, 52, 31, 115, 128},
     {87, 68, 71, 44, 114, 51, 15, 186, 23},
     {47, 41, 14, 110, 182, 183, 21, 17, 194},
     {66, 45, 25, 102, 197, 189, 23, 18, 22}},
    {{88, 88, 147, 150, 42, 46, 45, 196, 205},
     {43, 97, 183, 117, 85, 38, 35, 179, 61},
     {39, 53, 200, 87, 26, 21, 43, 232, 171},
     {56, 34, 51, 104, 114, 102, 29, 93, 77},
     {107, 54, 32, 26, 51, 1, 81, 43, 31},
     {39, 28, 85, 171, 58, 165, 90, 98, 64},
     {34, 22, 116, 206, 23, 34, 43, 166, 73},
     {68, 25, 106, 22, 64, 171, 36, 225, 114},
     {34, 19, 21, 102, 132, 188, 16, 76, 124},
     {62, 18, 78, 95, 85, 57, 50, 48, 51}},
    {{193, 101, 35, 159, 215, 111, 89, 46, 111},
     {60, 148, 31, 172, 219, 228, 21, 18, 111},
     {112, 113, 77, 85, 179, 255, 38, 120, 114},
     {40, 42, 1, 196, 245, 209, 10, 25, 109},
     {100, 80, 8, 43, 154, 1, 51, 26, 71},
     {88, 43, 29, 140, 166, 213, 37, 43, 154},
     {61, 63, 30, 155, 67, 45, 68, 1, 209},
     {142, 78, 78, 16, 255, 128, 34, 197, 171},
     {41, 40, 5, 102, 211, 183, 4, 1, 221},
     {51, 50, 17, 168, 209, 192, 23, 25, 82}},
    {{125, 98, 42, 88, 104, 85, 117, 175, 82},
     {95, 84, 53, 89, 128, 100, 113, 101, 45},
     {75, 79, 123, 47, 51, 128, 81, 171, 1},
     {57, 17, 5, 71, 102, 57, 53, 41, 49},
     {115, 21, 2, 10, 102, 255, 166, 23, 6},
     {38, 33, 13, 121, 57, 73, 26, 1, 85},
     {41, 10, 67, 138, 77, 110, 90, 47, 114},
     {101, 29, 16, 10, 85, 128, 101, 196, 26},
     {57, 18, 10, 102, 102, 213, 34, 20, 43},
     {117, 20, 15, 36, 163, 128, 68, 1, 26}},
    {{138, 31, 36, 171, 27, 166, 38, 44, 229},
     {67, 87, 58, 169, 82, 115, 26, 59, 179},
     {63, 59, 90, 180, 59, 166, 93, 73, 154},
     {40, 40, 21, 116, 143, 209, 34, 39, 175},
     {57, 46, 22, 24, 128, 1, 54, 17, 37},
     {47, 15, 16, 183, 34, 223, 49, 45, 183},
     {46, 17, 33, 183, 6, 98, 15, 32, 183},
     {65, 32, 73, 115, 28, 128, 23, 128, 205},
     {40, 3, 9, 115, 51, 192, 18, 6, 223},
     {87, 37, 9, 115, 59, 77, 64, 21, 47}},
    {{104, 55, 44, 218, 9, 54, 53, 130, 226},
     {64, 90, 70, 205, 40, 41, 23, 26, 57},
     {54, 57, 112, 184, 5, 41, 38, 166, 213},
     {30, 34, 26, 133, 152, 116, 10, 32, 134},
     {75, 32, 12, 51, 192, 255, 160, 43, 51},
     {39, 19, 53, 221, 26, 114, 32, 73, 255},
     {31, 9, 65, 234, 2, 15, 1, 118, 73},
     {88, 31, 35, 67, 102, 85, 55, 186, 85},
     {56, 21, 23, 111, 59, 205, 45, 37, 192},
     {55, 38, 70, 124, 73, 102, 1, 34, 98}},
    {{102, 61, 71, 37, 34, 53, 31, 243, 192},
     {69, 60, 71, 38, 73, 119, 28, 222, 37},
     {68, 45, 128, 34, 1, 47, 11, 245, 171},
     {62, 17, 19, 70, 146, 85, 55, 62, 70},
     {75, 15, 9, 9, 64, 255, 184, 119, 16},
     {37, 43, 37, 154, 100, 163, 85, 160, 1},
     {63, 9, 92, 136, 28, 64, 32, 201, 85},
     {86, 6, 28, 5, 64, 255, 25, 248, 1},
     {56, 8, 17, 132, 137, 255, 55, 116, 128},
     {58, 15, 20, 82, 135, 57, 26, 121, 40}},
    {{164, 50, 31, 137, 154, 133, 25, 35, 218},
     {51, 103, 44, 131, 131, 123, 31, 6, 158},
     {86, 40, 64, 135, 148, 224, 45, 183, 128},
     {22, 26, 17, 131, 240, 154, 14, 1, 209},
     {83, 12, 13, 54, 192, 255, 68, 47, 28},
     {45, 16, 21, 91, 64, 222, 7, 1, 197},
     {56, 21, 39, 155, 60, 138, 23, 102, 213},
     {85, 26, 85, 85, 128, 128, 32, 146, 171},
     {18, 11, 7, 63, 144, 171, 4, 4, 246},
     {35, 27, 10, 146, 174, 171, 12, 26, 128}},
    {{190, 80, 35, 99, 180, 80, 126, 54, 45},
     {85, 126, 47, 87, 176, 51, 41, 20, 32},
     {101, 75, 128, 139, 118, 146, 116, 128, 85},
     {56, 41, 15, 176, 236, 85, 37, 9, 62},
     {146, 36, 19, 30, 171, 255, 97, 27, 20},
     {71, 30, 17, 119, 118, 255, 17, 18, 138},
     {101, 38, 60, 138, 55, 70, 43, 26, 142},
     {138, 45, 61, 62, 219, 1, 81, 188, 64},
     {32, 41, 20, 117, 151, 142, 20, 21, 163},
     {112, 19, 12, 61, 195, 128, 48, 4, 24}}};

const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6,
                            6, 6, 6, 6, 6, 7, 0};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6,
                             9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177,
                         153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

constexpr int BPS = 32;  // the stride of a macroblock's work area

inline uint8_t clip8(int v) {
    return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
}
inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }
inline int16_t w16(int v) { return static_cast<int16_t>(v); }
inline int16_t mulhi16(int16_t a, int k) {
    return static_cast<int16_t>((a * k) >> 16);
}

// The inverse DCT of in, added to dst, as libwebp's Transform_SSE2 (the
// one an x86 host runs) computes it: 16-bit lanes that wrap, the
// constants 85627 and 35468 as 20091 and -30068 plus the input.  It
// equals TransformOne_C wherever nothing overflows 16 bits, which a
// corrupt stream can make happen.
void idct_add(const int16_t* in, uint8_t* dst) {
    int16_t m[4][4];
    for (int c = 0; c < 4; ++c) {  // vertical pass
        const int16_t i0 = in[c], i1 = in[4 + c], i2 = in[8 + c],
                      i3 = in[12 + c];
        const int16_t a = w16(i0 + i2), b = w16(i0 - i2);
        const int16_t cc = w16(w16(i1 - i3) +
                               w16(mulhi16(i1, -30068) - mulhi16(i3, 20091)));
        const int16_t d = w16(w16(i1 + i3) +
                              w16(mulhi16(i1, 20091) + mulhi16(i3, -30068)));
        m[0][c] = w16(a + d);
        m[1][c] = w16(b + cc);
        m[2][c] = w16(b - cc);
        m[3][c] = w16(a - d);
    }
    for (int r = 0; r < 4; ++r) {  // horizontal pass
        const int16_t t0 = m[r][0], t1 = m[r][1], t2 = m[r][2], t3 = m[r][3];
        const int16_t dc = w16(t0 + 4);
        const int16_t a = w16(dc + t2), b = w16(dc - t2);
        const int16_t cc = w16(w16(t1 - t3) +
                               w16(mulhi16(t1, -30068) - mulhi16(t3, 20091)));
        const int16_t d = w16(w16(t1 + t3) +
                              w16(mulhi16(t1, 20091) + mulhi16(t3, -30068)));
        uint8_t* row = dst + r * BPS;
        row[0] = clip8(row[0] + (w16(a + d) >> 3));
        row[1] = clip8(row[1] + (w16(b + cc) >> 3));
        row[2] = clip8(row[2] + (w16(b - cc) >> 3));
        row[3] = clip8(row[3] + (w16(a - d) >> 3));
    }
}

// TransformDC_C: a block whose only coefficient is its DC
void idct_dc_add(const int16_t* in, uint8_t* dst) {
    const int dc = in[0] + 4;
    for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c)
            dst[r * BPS + c] = clip8(dst[r * BPS + c] + (dc >> 3));
}

// TransformAC3_C: coefficients 0, 1 and 4 only
void idct_ac3_add(const int16_t* in, uint8_t* dst) {
    const int a = in[0] + 4;
    const int c4 = mul2(in[4]), d4 = mul1(in[4]);
    const int c1 = mul2(in[1]), d1 = mul1(in[1]);
    const int dcs[4] = {a + d4, a + c4, a - c4, a - d4};
    for (int r = 0; r < 4; ++r) {
        uint8_t* row = dst + r * BPS;
        row[0] = clip8(row[0] + ((dcs[r] + d1) >> 3));
        row[1] = clip8(row[1] + ((dcs[r] + c1) >> 3));
        row[2] = clip8(row[2] + ((dcs[r] - c1) >> 3));
        row[3] = clip8(row[3] + ((dcs[r] - d1) >> 3));
    }
}

// libwebp's DoTransform: the transform NzCodeBits picked
void transform(int code, const int16_t* in, uint8_t* dst) {
    if (code == 3) idct_add(in, dst);
    else if (code == 2) idct_ac3_add(in, dst);
    else if (code == 1) idct_dc_add(in, dst);
}

// libwebp's TransformWHT: the Y2 block's inverse WHT into the DC of the
// 16 luma blocks
void inverse_wht(const int16_t* in, int16_t* out) {
    int tmp[16];
    for (int i = 0; i < 4; ++i) {
        const int a0 = in[0 + i] + in[12 + i];
        const int a1 = in[4 + i] + in[8 + i];
        const int a2 = in[4 + i] - in[8 + i];
        const int a3 = in[0 + i] - in[12 + i];
        tmp[0 + i] = a0 + a1;
        tmp[8 + i] = a0 - a1;
        tmp[4 + i] = a3 + a2;
        tmp[12 + i] = a3 - a2;
    }
    for (int i = 0; i < 4; ++i) {
        const int dc = tmp[0 + i * 4] + 3;
        const int a0 = dc + tmp[3 + i * 4];
        const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
        const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
        const int a3 = dc - tmp[3 + i * 4];
        out[0] = static_cast<int16_t>((a0 + a1) >> 3);
        out[16] = static_cast<int16_t>((a3 + a2) >> 3);
        out[32] = static_cast<int16_t>((a0 - a1) >> 3);
        out[48] = static_cast<int16_t>((a3 - a2) >> 3);
        out += 64;
    }
}

inline uint8_t avg3(int a, int b, int c) {
    return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2);
}
inline uint8_t avg2(int a, int b) {
    return static_cast<uint8_t>((a + b + 1) >> 1);
}

void true_motion(uint8_t* dst, int size) {
    const uint8_t* top = dst - BPS;
    for (int y = 0; y < size; ++y) {
        const int left = dst[y * BPS - 1];
        for (int x = 0; x < size; ++x)
            dst[y * BPS + x] = clip8(top[x] + left - top[-1]);
    }
}

void fill(uint8_t* dst, int size, int v) {
    for (int y = 0; y < size; ++y)
        std::memset(dst + y * BPS, v, static_cast<size_t>(size));
}

// 16x16 (size 16) and chroma (size 8) prediction; DC by what the frame
// edges leave (libwebp's CheckMode)
void predict_block(uint8_t* dst, int size, int mode, bool has_top,
                   bool has_left) {
    const int shift = size == 16 ? 4 : 3;
    switch (mode) {
    case DC_PRED: {
        int dc = 0;
        if (has_top && has_left) {
            for (int j = 0; j < size; ++j)
                dc += dst[j * BPS - 1] + dst[j - BPS];
            fill(dst, size, (dc + size) >> (shift + 1));
        } else if (has_left) {
            for (int j = 0; j < size; ++j) dc += dst[j * BPS - 1];
            fill(dst, size, (dc + size / 2) >> shift);
        } else if (has_top) {
            for (int j = 0; j < size; ++j) dc += dst[j - BPS];
            fill(dst, size, (dc + size / 2) >> shift);
        } else {
            fill(dst, size, 0x80);
        }
        break;
    }
    case TM_PRED: true_motion(dst, size); break;
    case V_PRED:
        for (int y = 0; y < size; ++y)
            std::memcpy(dst + y * BPS, dst - BPS, static_cast<size_t>(size));
        break;
    default:  // H_PRED
        for (int y = 0; y < size; ++y)
            std::memset(dst + y * BPS, dst[y * BPS - 1],
                        static_cast<size_t>(size));
        break;
    }
}

#define DST(x, y) dst[(x) + (y) * BPS]

void predict4(uint8_t* dst, int mode) {
    const uint8_t* top = dst - BPS;
    const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
    const int E = top[4], F = top[5], G = top[6], H = top[7];
    const int I = dst[-1], J = dst[BPS - 1], K = dst[2 * BPS - 1],
              L = dst[3 * BPS - 1];
    switch (mode) {
    case B_DC: {
        int dc = 4;
        for (int i = 0; i < 4; ++i) dc += top[i] + dst[i * BPS - 1];
        fill(dst, 4, dc >> 3);
        break;
    }
    case B_TM: true_motion(dst, 4); break;
    case B_VE: {
        const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D),
                              avg3(C, D, E)};
        for (int y = 0; y < 4; ++y) std::memcpy(dst + y * BPS, v, 4);
        break;
    }
    case B_HE:
        std::memset(dst, avg3(X, I, J), 4);
        std::memset(dst + BPS, avg3(I, J, K), 4);
        std::memset(dst + 2 * BPS, avg3(J, K, L), 4);
        std::memset(dst + 3 * BPS, avg3(K, L, L), 4);
        break;
    case B_RD:
        DST(0, 3) = avg3(J, K, L);
        DST(1, 3) = DST(0, 2) = avg3(I, J, K);
        DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
        DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
        DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
        DST(3, 1) = DST(2, 0) = avg3(C, B, A);
        DST(3, 0) = avg3(D, C, B);
        break;
    case B_LD:
        DST(0, 0) = avg3(A, B, C);
        DST(1, 0) = DST(0, 1) = avg3(B, C, D);
        DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
        DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
        DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
        DST(3, 2) = DST(2, 3) = avg3(F, G, H);
        DST(3, 3) = avg3(G, H, H);
        break;
    case B_VR:
        DST(0, 0) = DST(1, 2) = avg2(X, A);
        DST(1, 0) = DST(2, 2) = avg2(A, B);
        DST(2, 0) = DST(3, 2) = avg2(B, C);
        DST(3, 0) = avg2(C, D);
        DST(0, 3) = avg3(K, J, I);
        DST(0, 2) = avg3(J, I, X);
        DST(0, 1) = DST(1, 3) = avg3(I, X, A);
        DST(1, 1) = DST(2, 3) = avg3(X, A, B);
        DST(2, 1) = DST(3, 3) = avg3(A, B, C);
        DST(3, 1) = avg3(B, C, D);
        break;
    case B_VL:
        DST(0, 0) = avg2(A, B);
        DST(1, 0) = DST(0, 2) = avg2(B, C);
        DST(2, 0) = DST(1, 2) = avg2(C, D);
        DST(3, 0) = DST(2, 2) = avg2(D, E);
        DST(0, 1) = avg3(A, B, C);
        DST(1, 1) = DST(0, 3) = avg3(B, C, D);
        DST(2, 1) = DST(1, 3) = avg3(C, D, E);
        DST(3, 1) = DST(2, 3) = avg3(D, E, F);
        DST(3, 2) = avg3(E, F, G);
        DST(3, 3) = avg3(F, G, H);
        break;
    case B_HD:
        DST(0, 0) = DST(2, 1) = avg2(I, X);
        DST(0, 1) = DST(2, 2) = avg2(J, I);
        DST(0, 2) = DST(2, 3) = avg2(K, J);
        DST(0, 3) = avg2(L, K);
        DST(3, 0) = avg3(A, B, C);
        DST(2, 0) = avg3(X, A, B);
        DST(1, 0) = DST(3, 1) = avg3(I, X, A);
        DST(1, 1) = DST(3, 2) = avg3(J, I, X);
        DST(1, 2) = DST(3, 3) = avg3(K, J, I);
        DST(1, 3) = avg3(L, K, J);
        break;
    default:  // B_HU
        DST(0, 0) = avg2(I, J);
        DST(2, 0) = DST(0, 1) = avg2(J, K);
        DST(2, 1) = DST(0, 2) = avg2(K, L);
        DST(1, 0) = avg3(I, J, K);
        DST(3, 0) = DST(1, 1) = avg3(J, K, L);
        DST(3, 1) = DST(1, 2) = avg3(K, L, L);
        DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) =
            DST(3, 3) = static_cast<uint8_t>(L);
        break;
    }
}

#undef DST

// ------------------------------------------------------ the loop filter

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    const int a1 = sclip2((a + 4) >> 3);
    const int a2 = sclip2((a + 3) >> 3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0);
    const int a1 = sclip2((a + 4) >> 3);
    const int a2 = sclip2((a + 3) >> 3);
    const int a3 = (a1 + 1) >> 1;
    p[-2 * step] = clip8(p1 + a3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
    const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
    const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    const int a1 = (27 * a + 63) >> 7;
    const int a2 = (18 * a + 63) >> 7;
    const int a3 = (9 * a + 63) >> 7;
    p[-3 * step] = clip8(p2 + a3);
    p[-2 * step] = clip8(p1 + a2);
    p[-step] = clip8(p0 + a1);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a2);
    p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
    const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
    const int p0 = p[-step], q0 = p[0];
    const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
    if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
    return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
           std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
           std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// one edge of ``size`` pixels: hstride across it, vstride along it
void simple_edge(uint8_t* p, int hstride, int vstride, int size,
                 int thresh) {
    const int t2 = 2 * thresh + 1;
    for (int i = 0; i < size; ++i, p += vstride)
        if (needs_filter(p, hstride, t2)) do_filter2(p, hstride);
}

void normal_edge(uint8_t* p, int hstride, int vstride, int size, int thresh,
                 int ithresh, int hev_t, bool mb_edge) {
    const int t2 = 2 * thresh + 1;
    for (int i = 0; i < size; ++i, p += vstride) {
        if (!needs_filter2(p, hstride, t2, ithresh)) continue;
        if (hev(p, hstride, hev_t)) do_filter2(p, hstride);
        else if (mb_edge) do_filter6(p, hstride);
        else do_filter4(p, hstride);
    }
}

struct FilterInfo {
    int limit = 0, ilevel = 0, hev = 0;
    bool inner = false;
};

struct MBInfo {
    bool i4x4 = false;
    int segment = 0;
    bool skip = false;
    uint8_t modes[16];  // 4x4 modes, or the 16x16 mode in [0]
    int uvmode = 0;
};

class Lossy {
public:
    Lossy(const uint8_t* d, size_t n) : d_(d), n_(n) {}

    void decode();
    int width() const { return width_; }
    int height() const { return height_; }
    // what the frame used: filter type, level, sharpness, token
    // partitions, segments, segment map, B_PRED macroblocks, skip flags
    void describe(int* info) const {
        info[5] = filter_type_;
        info[6] = level_;
        info[7] = sharpness_;
        info[8] = num_parts_;
        info[9] = use_segment_;
        info[10] = update_map_;
        info[14] = i4x4_count_;
        info[15] = use_skip_;
    }
    // HxWx3 RGB through the fancy upsampler
    void rgb(uint8_t* out) const;

private:
    const uint8_t* d_;
    size_t n_;
    int width_ = 0, height_ = 0, mb_w_ = 0, mb_h_ = 0;
    BoolDecoder br_;
    BoolDecoder parts_[8];
    int num_parts_ = 1;
    // segments
    bool use_segment_ = false, update_map_ = false, absolute_delta_ = true;
    int quantizer_[4] = {0, 0, 0, 0}, filter_strength_[4] = {0, 0, 0, 0};
    int seg_proba_[3] = {255, 255, 255};
    // filter header
    bool simple_ = false;
    int level_ = 0, sharpness_ = 0;
    bool use_lf_delta_ = false;
    int ref_lf_delta_[4] = {0, 0, 0, 0}, mode_lf_delta_[4] = {0, 0, 0, 0};
    int filter_type_ = 0;  // 0 off, 1 simple, 2 normal
    FilterInfo fstrengths_[4][2];
    // quantizers: y1, y2, uv (dc, ac) of each segment
    int dq_[4][3][2];
    uint8_t proba_[4][8][3][11];
    bool use_skip_ = false;
    int skip_p_ = 0;
    // the frame, unfiltered until the end
    std::vector<uint8_t> y_, u_, v_;
    int ystride_ = 0, uvstride_ = 0;
    std::vector<FilterInfo> finfo_;
    int i4x4_count_ = 0;

    void parse_header();
    void parse_intra_row(std::vector<MBInfo>& row, std::vector<uint8_t>& top);
    int get_coeffs(BoolDecoder& br, int type, int ctx, const int* dq,
                   int n, int16_t* out);
    void decode_mb(BoolDecoder& br, MBInfo& mb, int mb_x, int mb_y,
                   uint8_t* top_nz, uint8_t* top_nz_dc, uint8_t& left_nz,
                   uint8_t& left_nz_dc);
    void filter();
};

void Lossy::parse_header() {
    if (n_ < 10) throw Error("truncated data (VP8 frame header)");
    const uint32_t bits = d_[0] | (d_[1] << 8) | (d_[2] << 16);
    if (bits & 1) throw Error("not a key frame (VP8)");
    if (((bits >> 1) & 7) > 3) throw Error("corrupt data (VP8 profile)");
    if (!((bits >> 4) & 1)) throw Error("corrupt data (VP8 frame not "
                                        "shown)");
    const uint32_t part0 = bits >> 5;
    if (d_[3] != 0x9d || d_[4] != 0x01 || d_[5] != 0x2a)
        throw Error("corrupt data (VP8 start code)");
    width_ = ((d_[7] << 8) | d_[6]) & 0x3fff;
    height_ = ((d_[9] << 8) | d_[8]) & 0x3fff;
    if (!width_ || !height_) throw Error("corrupt data (VP8 size 0)");
    mb_w_ = (width_ + 15) >> 4;
    mb_h_ = (height_ + 15) >> 4;
    const uint8_t* buf = d_ + 10;
    size_t size = n_ - 10;
    if (part0 > size) throw Error("truncated data (VP8 partition 0)");
    br_.init(buf, part0);
    buf += part0;
    size -= part0;

    br_.value(1);  // color space
    br_.value(1);  // clamping type
    // segment header
    use_segment_ = br_.value(1);
    if (use_segment_) {
        update_map_ = br_.value(1);
        if (br_.value(1)) {  // update data
            absolute_delta_ = br_.value(1);
            for (int& q : quantizer_)
                q = br_.value(1) ? br_.signed_value(7) : 0;
            for (int& f : filter_strength_)
                f = br_.value(1) ? br_.signed_value(6) : 0;
        }
        if (update_map_)
            for (int& p : seg_proba_) p = br_.value(1) ? br_.value(8) : 255;
    }
    if (br_.eof()) throw Error("truncated data (VP8 segment header)");
    // filter header
    simple_ = br_.value(1);
    level_ = br_.value(6);
    sharpness_ = br_.value(3);
    use_lf_delta_ = br_.value(1);
    if (use_lf_delta_ && br_.value(1)) {
        for (int& r : ref_lf_delta_)
            if (br_.value(1)) r = br_.signed_value(6);
        for (int& m : mode_lf_delta_)
            if (br_.value(1)) m = br_.signed_value(6);
    }
    filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
    if (br_.eof()) throw Error("truncated data (VP8 filter header)");
    // token partitions
    num_parts_ = 1 << br_.value(2);
    const size_t last = static_cast<size_t>(num_parts_ - 1);
    if (size < 3 * last) throw Error("truncated data (VP8 partitions)");
    const uint8_t* sz = buf;
    const uint8_t* start = buf + 3 * last;
    size_t left = size - 3 * last;
    for (size_t p = 0; p < last; ++p, sz += 3) {
        size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
        if (psize > left) psize = left;
        parts_[p].init(start, psize);
        start += psize;
        left -= psize;
    }
    parts_[last].init(start, left);
    if (left == 0) throw Error("truncated data (VP8 partitions)");
    // quantizers
    const int base_q0 = br_.value(7);
    int dq[5];
    for (int& v : dq) v = br_.value(1) ? br_.signed_value(4) : 0;
    const int dqy1_dc = dq[0], dqy2_dc = dq[1], dqy2_ac = dq[2],
              dquv_dc = dq[3], dquv_ac = dq[4];
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int s = 0; s < 4; ++s) {
        int q;
        if (use_segment_) {
            q = quantizer_[s];
            if (!absolute_delta_) q += base_q0;
        } else {
            if (s > 0) {
                std::memcpy(dq_[s], dq_[0], sizeof(dq_[0]));
                continue;
            }
            q = base_q0;
        }
        dq_[s][0][0] = kDcTable[clip(q + dqy1_dc, 127)];
        dq_[s][0][1] = kAcTable[clip(q, 127)];
        dq_[s][1][0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
        dq_[s][1][1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
        if (dq_[s][1][1] < 8) dq_[s][1][1] = 8;
        dq_[s][2][0] = kDcTable[clip(q + dquv_dc, 117)];
        dq_[s][2][1] = kAcTable[clip(q + dquv_ac, 127)];
    }
    br_.value(1);  // refresh entropy probs: ignored
    for (int t = 0; t < 4; ++t)
        for (int b = 0; b < 8; ++b)
            for (int c = 0; c < 3; ++c)
                for (int p = 0; p < 11; ++p)
                    proba_[t][b][c][p] = static_cast<uint8_t>(
                        br_.get(kCoeffsUpdateProba[t][b][c][p]) ?
                        br_.value(8) : kCoeffsProba0[t][b][c][p]);
    use_skip_ = br_.value(1);
    if (use_skip_) skip_p_ = br_.value(8);

    // libwebp's PrecomputeFilterStrengths
    if (filter_type_ > 0) {
        for (int s = 0; s < 4; ++s) {
            int base = level_;
            if (use_segment_) {
                base = filter_strength_[s];
                if (!absolute_delta_) base += level_;
            }
            for (int i4 = 0; i4 <= 1; ++i4) {
                FilterInfo& f = fstrengths_[s][i4];
                int level = base;
                if (use_lf_delta_) {
                    level += ref_lf_delta_[0];
                    if (i4) level += mode_lf_delta_[0];
                }
                level = level < 0 ? 0 : level > 63 ? 63 : level;
                if (level > 0) {
                    int ilevel = level;
                    if (sharpness_ > 0) {
                        ilevel >>= sharpness_ > 4 ? 2 : 1;
                        if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
                    }
                    if (ilevel < 1) ilevel = 1;
                    f.ilevel = ilevel;
                    f.limit = 2 * level + ilevel;
                    f.hev = level >= 40 ? 2 : level >= 15 ? 1 : 0;
                } else {
                    f.limit = 0;
                }
                f.inner = i4 != 0;
            }
        }
    }
}

void Lossy::parse_intra_row(std::vector<MBInfo>& row,
                            std::vector<uint8_t>& top) {
    uint8_t left[4] = {B_DC, B_DC, B_DC, B_DC};
    for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        MBInfo& mb = row[mb_x];
        uint8_t* t = top.data() + 4 * mb_x;
        if (update_map_) {
            mb.segment = !br_.get(seg_proba_[0]) ? br_.get(seg_proba_[1])
                                                 : br_.get(seg_proba_[2]) + 2;
        } else {
            mb.segment = 0;
        }
        mb.skip = use_skip_ ? br_.get(skip_p_) : false;
        mb.i4x4 = !br_.get(145);
        i4x4_count_ += mb.i4x4;
        if (!mb.i4x4) {
            const int ymode = br_.get(156) ? (br_.get(128) ? TM_PRED : H_PRED)
                                           : (br_.get(163) ? V_PRED : DC_PRED);
            mb.modes[0] = static_cast<uint8_t>(ymode);
            std::memset(t, ymode, 4);
            std::memset(left, ymode, 4);
        } else {
            for (int y = 0; y < 4; ++y) {
                int ymode = left[y];
                for (int x = 0; x < 4; ++x) {
                    const uint8_t* p = kBModesProba[t[x]][ymode];
                    ymode = !br_.get(p[0]) ? B_DC :
                            !br_.get(p[1]) ? B_TM :
                            !br_.get(p[2]) ? B_VE :
                            !br_.get(p[3]) ?
                                (!br_.get(p[4]) ? B_HE :
                                 !br_.get(p[5]) ? B_RD : B_VR) :
                                (!br_.get(p[6]) ? B_LD :
                                 !br_.get(p[7]) ? B_VL :
                                 !br_.get(p[8]) ? B_HD : B_HU);
                    t[x] = static_cast<uint8_t>(ymode);
                    mb.modes[4 * y + x] = static_cast<uint8_t>(ymode);
                }
                left[y] = static_cast<uint8_t>(ymode);
            }
        }
        mb.uvmode = !br_.get(142) ? DC_PRED : !br_.get(114) ? V_PRED
                    : br_.get(183) ? TM_PRED : H_PRED;
    }
    if (br_.eof()) throw Error("truncated data (VP8 partition 0)");
}

// libwebp's GetCoeffs: the tokens of one block from position n; returns
// the position after the last token read (16 when the block is full)
int Lossy::get_coeffs(BoolDecoder& br, int type, int ctx, const int* dq,
                      int n, int16_t* out) {
    const uint8_t* p = proba_[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
        if (!br.get(p[0])) return n;  // end of block
        while (!br.get(p[1])) {  // zeros
            p = proba_[type][kBands[++n]][0];
            if (n == 16) return 16;
        }
        int v;
        int next_ctx;
        if (!br.get(p[2])) {
            v = 1;
            next_ctx = 1;
        } else {
            if (!br.get(p[3])) {
                v = !br.get(p[4]) ? 2 : 3 + br.get(p[5]);
            } else if (!br.get(p[6])) {
                if (!br.get(p[7])) {
                    v = 5 + br.get(159);
                } else {
                    v = 7 + 2 * br.get(165);
                    v += br.get(145);
                }
            } else {
                const int bit1 = br.get(p[8]);
                const int bit0 = br.get(p[9 + bit1]);
                const int cat = 2 * bit1 + bit0;
                v = 0;
                for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab)
                    v += v + br.get(*tab);
                v += 3 + (8 << cat);
            }
            next_ctx = 2;
        }
        p = proba_[type][kBands[n + 1]][next_ctx];
        out[kZigzag[n]] = static_cast<int16_t>(br.get_signed(v) * dq[n > 0]);
    }
    return 16;
}

// which transform libwebp's NzCodeBits picks: 0 none, else a transform
inline int nz_code(int nz, bool dc_nz) {
    return nz > 3 ? 3 : nz > 1 ? 2 : dc_nz ? 1 : 0;
}

void Lossy::decode_mb(BoolDecoder& br, MBInfo& mb, int mb_x, int mb_y,
                      uint8_t* top_nz, uint8_t* top_nz_dc,
                      uint8_t& left_nz, uint8_t& left_nz_dc) {
    int16_t coeffs[384];
    uint8_t codes[24];  // each block's transform code
    bool skip = use_skip_ ? mb.skip : false;
    if (!skip) {
        std::memset(coeffs, 0, sizeof(coeffs));
        const int* q = &dq_[mb.segment][0][0];
        int first, ac_type;
        if (!mb.i4x4) {
            int16_t dc[16] = {0};
            const int ctx = *top_nz_dc + left_nz_dc;
            const int nz = get_coeffs(br, 1, ctx, q + 2, 0, dc);
            *top_nz_dc = left_nz_dc = nz > 0;
            if (nz > 1) {
                inverse_wht(dc, coeffs);
            } else {
                const int16_t dc0 = static_cast<int16_t>((dc[0] + 3) >> 3);
                for (int i = 0; i < 256; i += 16) coeffs[i] = dc0;
            }
            first = 1;
            ac_type = 0;
        } else {
            first = 0;
            ac_type = 3;
        }
        uint8_t tnz = *top_nz & 0x0f, lnz = left_nz & 0x0f;
        bool any = false;
        for (int y = 0; y < 4; ++y) {
            int l = lnz & 1;
            for (int x = 0; x < 4; ++x) {
                const int ctx = l + (tnz & 1);
                int16_t* blk = coeffs + 16 * (4 * y + x);
                const int nz = get_coeffs(br, ac_type, ctx, q, first, blk);
                l = nz > first;
                tnz = static_cast<uint8_t>((tnz >> 1) | (l << 7));
                codes[4 * y + x] =
                    static_cast<uint8_t>(nz_code(nz, blk[0] != 0));
                any |= codes[4 * y + x] != 0;
            }
            tnz >>= 4;
            lnz = static_cast<uint8_t>((lnz >> 1) | (l << 7));
        }
        uint32_t out_t = tnz, out_l = lnz >> 4;
        for (int ch = 0; ch < 4; ch += 2) {
            uint32_t t = *top_nz >> (4 + ch), lf = left_nz >> (4 + ch);
            for (int y = 0; y < 2; ++y) {
                int l = lf & 1;
                for (int x = 0; x < 2; ++x) {
                    const int ctx = l + (t & 1);
                    const int b = 16 + 2 * ch + 2 * y + x;
                    int16_t* blk = coeffs + 16 * b;
                    const int nz = get_coeffs(br, 2, ctx, q + 4, 0, blk);
                    l = nz > 0;
                    t = (t >> 1) | (l << 3);
                    codes[b] = static_cast<uint8_t>(nz_code(nz, blk[0] != 0));
                    any |= codes[b] != 0;
                }
                t >>= 2;
                lf = (lf >> 1) | (l << 5);
            }
            out_t |= (t << 4) << ch;
            out_l |= (lf & 0xf0) << ch;
        }
        *top_nz = static_cast<uint8_t>(out_t);
        left_nz = static_cast<uint8_t>(out_l);
        skip = !any;
    } else {
        *top_nz = left_nz = 0;
        if (!mb.i4x4) *top_nz_dc = left_nz_dc = 0;
        std::memset(codes, 0, sizeof(codes));
    }
    if (filter_type_ > 0) {
        FilterInfo f = fstrengths_[mb.segment][mb.i4x4];
        f.inner = f.inner || !skip;
        finfo_[static_cast<size_t>(mb_y) * mb_w_ + mb_x] = f;
    }

    // reconstruct in a work area whose row -1 and column -1 hold the
    // unfiltered neighbours
    uint8_t ybuf[17 * BPS], ubuf[9 * BPS], vbuf[9 * BPS];
    uint8_t* yd = ybuf + BPS + 8;
    uint8_t* ud = ubuf + BPS + 8;
    uint8_t* vd = vbuf + BPS + 8;
    const int x0 = 16 * mb_x, y0 = 16 * mb_y;
    const int cx0 = 8 * mb_x, cy0 = 8 * mb_y;
    if (mb_y == 0) {
        std::memset(yd - BPS - 1, 127, 16 + 4 + 1);
        std::memset(ud - BPS - 1, 127, 8 + 1);
        std::memset(vd - BPS - 1, 127, 8 + 1);
    } else {
        const uint8_t* yt = y_.data() + static_cast<size_t>(y0 - 1) * ystride_;
        const size_t crow = static_cast<size_t>(cy0 - 1) * uvstride_;
        const uint8_t* ut = u_.data() + crow;
        const uint8_t* vt = v_.data() + crow;
        std::memcpy(yd - BPS, yt + x0, 16);
        std::memcpy(ud - BPS, ut + cx0, 8);
        std::memcpy(vd - BPS, vt + cx0, 8);
        yd[-BPS - 1] = mb_x ? yt[x0 - 1] : 129;
        ud[-BPS - 1] = mb_x ? ut[cx0 - 1] : 129;
        vd[-BPS - 1] = mb_x ? vt[cx0 - 1] : 129;
        if (mb_x == mb_w_ - 1) std::memset(yd - BPS + 16, yt[x0 + 15], 4);
        else std::memcpy(yd - BPS + 16, yt + x0 + 16, 4);
    }
    for (int j = 0; j < 16; ++j)
        yd[j * BPS - 1] = mb_x ? y_[static_cast<size_t>(y0 + j) * ystride_ +
                                    x0 - 1] : 129;
    for (int j = 0; j < 8; ++j) {
        ud[j * BPS - 1] = mb_x ? u_[static_cast<size_t>(cy0 + j) * uvstride_ +
                                    cx0 - 1] : 129;
        vd[j * BPS - 1] = mb_x ? v_[static_cast<size_t>(cy0 + j) * uvstride_ +
                                    cx0 - 1] : 129;
    }
    if (mb.i4x4) {
        // the top-right pixels stand for the sub-blocks below them too
        for (int r = 3; r < 16; r += 4)
            std::memcpy(yd + r * BPS + 16, yd - BPS + 16, 4);
        for (int n = 0; n < 16; ++n) {
            uint8_t* dst = yd + (n >> 2) * 4 * BPS + (n & 3) * 4;
            predict4(dst, mb.modes[n]);
            transform(codes[n], coeffs + 16 * n, dst);
        }
    } else {
        predict_block(yd, 16, mb.modes[0], mb_y > 0, mb_x > 0);
        for (int n = 0; n < 16; ++n)
            transform(codes[n], coeffs + 16 * n,
                      yd + (n >> 2) * 4 * BPS + (n & 3) * 4);
    }
    predict_block(ud, 8, mb.uvmode, mb_y > 0, mb_x > 0);
    predict_block(vd, 8, mb.uvmode, mb_y > 0, mb_x > 0);
    // DoUVTransform: the full transform on all four blocks if one has
    // more than its DC, else the DC-only one
    for (int ch = 0; ch < 2; ++ch) {
        const uint8_t* c = codes + 16 + 4 * ch;
        uint8_t* base = ch ? vd : ud;
        const bool any = c[0] | c[1] | c[2] | c[3];
        const bool ac = c[0] >= 2 || c[1] >= 2 || c[2] >= 2 || c[3] >= 2;
        for (int n = 0; n < 4 && any; ++n)
            transform(ac ? 3 : 1, coeffs + 16 * (16 + 4 * ch + n),
                      base + (n >> 1) * 4 * BPS + (n & 1) * 4);
    }
    for (int j = 0; j < 16; ++j)
        std::memcpy(y_.data() + static_cast<size_t>(y0 + j) * ystride_ + x0,
                    yd + j * BPS, 16);
    for (int j = 0; j < 8; ++j) {
        std::memcpy(u_.data() + static_cast<size_t>(cy0 + j) * uvstride_ + cx0,
                    ud + j * BPS, 8);
        std::memcpy(v_.data() + static_cast<size_t>(cy0 + j) * uvstride_ + cx0,
                    vd + j * BPS, 8);
    }
}

void Lossy::decode() {
    parse_header();
    ystride_ = 16 * mb_w_;
    uvstride_ = 8 * mb_w_;
    y_.assign(static_cast<size_t>(ystride_) * 16 * mb_h_, 0);
    u_.assign(static_cast<size_t>(uvstride_) * 8 * mb_h_, 0);
    v_.assign(static_cast<size_t>(uvstride_) * 8 * mb_h_, 0);
    finfo_.assign(static_cast<size_t>(mb_w_) * mb_h_, FilterInfo());
    std::vector<MBInfo> row(mb_w_);
    std::vector<uint8_t> intra_top(4 * static_cast<size_t>(mb_w_), B_DC);
    std::vector<uint8_t> top_nz(mb_w_, 0), top_nz_dc(mb_w_, 0);
    for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
        parse_intra_row(row, intra_top);
        BoolDecoder& tb = parts_[mb_y & (num_parts_ - 1)];
        uint8_t left_nz = 0, left_nz_dc = 0;
        for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
            decode_mb(tb, row[mb_x], mb_x, mb_y, &top_nz[mb_x],
                      &top_nz_dc[mb_x], left_nz, left_nz_dc);
            if (tb.eof()) throw Error("truncated data (VP8 token "
                                      "partition)");
        }
    }
    if (filter_type_ > 0) filter();
}

void Lossy::filter() {
    for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
        for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
            const FilterInfo& f = finfo_[static_cast<size_t>(mb_y) * mb_w_ +
                                         mb_x];
            if (f.limit == 0) continue;
            uint8_t* yp = y_.data() + static_cast<size_t>(16 * mb_y) *
                          ystride_ + 16 * mb_x;
            const int ys = ystride_;
            if (filter_type_ == 1) {
                if (mb_x > 0) simple_edge(yp, 1, ys, 16, f.limit + 4);
                if (f.inner)
                    for (int k = 4; k < 16; k += 4)
                        simple_edge(yp + k, 1, ys, 16, f.limit);
                if (mb_y > 0) simple_edge(yp, ys, 1, 16, f.limit + 4);
                if (f.inner)
                    for (int k = 4; k < 16; k += 4)
                        simple_edge(yp + k * ys, ys, 1, 16, f.limit);
                continue;
            }
            const int cs = uvstride_;
            uint8_t* up = u_.data() + static_cast<size_t>(8 * mb_y) * cs +
                          8 * mb_x;
            uint8_t* vp = v_.data() + static_cast<size_t>(8 * mb_y) * cs +
                          8 * mb_x;
            const int il = f.ilevel, hv = f.hev;
            if (mb_x > 0) {
                normal_edge(yp, 1, ys, 16, f.limit + 4, il, hv, true);
                normal_edge(up, 1, cs, 8, f.limit + 4, il, hv, true);
                normal_edge(vp, 1, cs, 8, f.limit + 4, il, hv, true);
            }
            if (f.inner) {
                for (int k = 4; k < 16; k += 4)
                    normal_edge(yp + k, 1, ys, 16, f.limit, il, hv, false);
                normal_edge(up + 4, 1, cs, 8, f.limit, il, hv, false);
                normal_edge(vp + 4, 1, cs, 8, f.limit, il, hv, false);
            }
            if (mb_y > 0) {
                normal_edge(yp, ys, 1, 16, f.limit + 4, il, hv, true);
                normal_edge(up, cs, 1, 8, f.limit + 4, il, hv, true);
                normal_edge(vp, cs, 1, 8, f.limit + 4, il, hv, true);
            }
            if (f.inner) {
                for (int k = 4; k < 16; k += 4)
                    normal_edge(yp + k * ys, ys, 1, 16, f.limit, il, hv,
                                false);
                normal_edge(up + 4 * cs, cs, 1, 8, f.limit, il, hv, false);
                normal_edge(vp + 4 * cs, cs, 1, 8, f.limit, il, hv, false);
            }
        }
    }
}

// src/dsp/yuv.h: 14-bit fixed point
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) {
    return static_cast<uint8_t>((v & ~16383) == 0 ? (v >> 6)
                                : v < 0 ? 0 : 255);
}
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
    const int yy = mult_hi(y, 19077);
    rgb[0] = yuv_clip8(yy + mult_hi(v, 26149) - 14234);
    rgb[1] = yuv_clip8(yy - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
    rgb[2] = yuv_clip8(yy + mult_hi(u, 33050) - 17685);
}

// One output row of UpsampleRgbaLinePair: ``near`` the chroma row next to
// it, ``far`` the other one of the pair
void upsample_row(const uint8_t* y, const uint8_t* nu, const uint8_t* nv,
                  const uint8_t* fu, const uint8_t* fv, int len,
                  uint8_t* out) {
    auto chroma = [](const uint8_t* n, const uint8_t* f, int x, int* c0,
                     int* c1) {
        const int tl = n[x - 1], t = n[x], l = f[x - 1], c = f[x];
        const int avg = tl + t + l + c + 8;
        const int d12 = (avg + 2 * (t + l)) >> 3;
        const int d03 = (avg + 2 * (tl + c)) >> 3;
        *c0 = (d12 + tl) >> 1;
        *c1 = (d03 + t) >> 1;
    };
    yuv_to_rgb(y[0], (3 * nu[0] + fu[0] + 2) >> 2, (3 * nv[0] + fv[0] + 2) >> 2,
               out);
    const int pairs = (len - 1) >> 1;
    for (int x = 1; x <= pairs; ++x) {
        int u0, u1, v0, v1;
        chroma(nu, fu, x, &u0, &u1);
        chroma(nv, fv, x, &v0, &v1);
        yuv_to_rgb(y[2 * x - 1], u0, v0, out + 3 * (2 * x - 1));
        yuv_to_rgb(y[2 * x], u1, v1, out + 3 * (2 * x));
    }
    if (!(len & 1)) {
        const int k = pairs;
        yuv_to_rgb(y[len - 1], (3 * nu[k] + fu[k] + 2) >> 2,
                   (3 * nv[k] + fv[k] + 2) >> 2, out + 3 * (len - 1));
    }
}

void Lossy::rgb(uint8_t* out) const {
    const int uvh = (height_ + 1) >> 1;
    for (int r = 0; r < height_; ++r) {
        const int near = r >> 1;
        int far;
        if (r & 1) far = std::min((r + 1) >> 1, uvh - 1);
        else far = std::max((r >> 1) - 1, 0);
        upsample_row(y_.data() + static_cast<size_t>(r) * ystride_,
                     u_.data() + static_cast<size_t>(near) * uvstride_,
                     v_.data() + static_cast<size_t>(near) * uvstride_,
                     u_.data() + static_cast<size_t>(far) * uvstride_,
                     v_.data() + static_cast<size_t>(far) * uvstride_,
                     width_, out + static_cast<size_t>(r) * width_ * 3);
    }
}

// ================================================================ ALPH

inline uint8_t gradient(int a, int b, int c) {
    const int g = a + b - c;
    return static_cast<uint8_t>((g & ~0xff) == 0 ? g : g < 0 ? 0 : 255);
}

// The alpha plane of an ALPH chunk (its payload) for a w x h frame;
// info[11..13]: its method + 1, filter and VP8L transforms
std::vector<uint8_t> decode_alph(const uint8_t* d, size_t n, int w, int h,
                                 int* info) {
    if (n <= 1) throw Error("corrupt alpha data (ALPH chunk too short)");
    const int method = d[0] & 3, filt = (d[0] >> 2) & 3,
              pre = (d[0] >> 4) & 3, rsrv = (d[0] >> 6) & 3;
    if (method > 1 || pre > 1 || rsrv != 0)
        throw Error("corrupt alpha data (ALPH header)");
    info[11] = method + 1;
    info[12] = filt;
    const size_t total = static_cast<size_t>(w) * h;
    std::vector<uint8_t> a(total);
    if (method == 0) {
        if (n - 1 < total) throw Error("truncated alpha data");
        std::memcpy(a.data(), d + 1, total);
    } else {
        Lossless dec(d + 1, n - 1);
        const std::vector<uint32_t> px = dec.decode_alpha(w, h);
        info[13] = dec.transform_mask();
        for (size_t i = 0; i < total; ++i)
            a[i] = static_cast<uint8_t>((px[i] >> 8) & 0xff);
    }
    // undo the filter (libwebp's WebPUnfilters), row by row
    for (int y = 0; y < h && filt; ++y) {
        uint8_t* row = a.data() + static_cast<size_t>(y) * w;
        const uint8_t* prev = y ? row - w : nullptr;
        if (!prev || filt == 1) {
            uint8_t pred = prev ? prev[0] : 0;
            for (int x = 0; x < w; ++x) {
                row[x] = static_cast<uint8_t>(pred + row[x]);
                pred = row[x];
            }
        } else if (filt == 2) {
            for (int x = 0; x < w; ++x)
                row[x] = static_cast<uint8_t>(prev[x] + row[x]);
        } else {
            uint8_t top = prev[0], top_left = top, left = top;
            for (int x = 0; x < w; ++x) {
                top = prev[x];
                left = static_cast<uint8_t>(row[x] + gradient(left, top,
                                                              top_left));
                top_left = top;
                row[x] = left;
            }
        }
    }
    return a;
}

}  // namespace

extern "C" {

// The frame in data[0:n] (a VP8L payload when lossless, else VP8, with the
// ALPH payload alpha[0:alpha_n] when alpha is not null) decoded into out
// (HxWx3 RGB, as Pillow's convert("RGB") gives it; out holds cap bytes)
// and, when alpha_out is not null, its alpha (HxW; 255 for a lossy frame
// without ALPH).  *w and *h receive the size, info[0:16] (when not null)
// what the frame used: [0] lossless; VP8L [1] transforms (a bit a type),
// [2] color cache bits, [3] entropy image, [4] palette size; VP8 [5]
// filter type, [6] level, [7] sharpness, [8] token partitions, [9]
// segments, [10] segment map, [14] B_PRED macroblocks, [15] skip flags;
// ALPH [11] method + 1, [12] filter, [13] VP8L transforms.  Returns 0, 1
// with a message in err (at most errlen bytes) when the frame is
// refused, or 2 when cap is too small for the frame.
int webp_decode(const uint8_t* data, size_t n, int lossless,
                const uint8_t* alpha, size_t alpha_n, uint8_t* out,
                size_t cap, uint8_t* alpha_out, int* w, int* h, int* info,
                char* err, int errlen) {
    int scratch[16] = {0};
    if (!info) info = scratch;
    std::memset(info, 0, sizeof(scratch));
    try {
        if (lossless) {
            Lossless dec(data, n);
            const std::vector<uint32_t> px = dec.decode_frame(w, h);
            info[0] = 1;
            info[1] = dec.transform_mask();
            info[2] = dec.cache_bits;
            info[3] = dec.meta;
            info[4] = dec.palette;
            const size_t total = static_cast<size_t>(*w) * *h;
            if (3 * total > cap) return 2;
            for (size_t i = 0; i < total; ++i) {
                out[3 * i] = static_cast<uint8_t>(px[i] >> 16);
                out[3 * i + 1] = static_cast<uint8_t>(px[i] >> 8);
                out[3 * i + 2] = static_cast<uint8_t>(px[i]);
                if (alpha_out) alpha_out[i] = static_cast<uint8_t>(px[i] >> 24);
            }
            return 0;
        }
        Lossy dec(data, n);
        dec.decode();
        dec.describe(info);
        *w = dec.width();
        *h = dec.height();
        const size_t total = static_cast<size_t>(*w) * *h;
        if (3 * total > cap) return 2;
        std::vector<uint8_t> a;
        if (alpha) a = decode_alph(alpha, alpha_n, *w, *h, info);
        dec.rgb(out);
        if (alpha_out) {
            if (alpha) std::memcpy(alpha_out, a.data(), total);
            else std::memset(alpha_out, 255, total);
        }
        return 0;
    } catch (const std::exception& e) {
        std::snprintf(err, static_cast<size_t>(errlen), "%s", e.what());
        return 1;
    }
}

}  // extern "C"
