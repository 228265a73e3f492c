// A JPEG decoder for the image reader (``images.py``): what Pillow's
// ``Image.open(p).convert("RGB")`` and ``.convert("L")`` give, bit for
// bit, with the settings Pillow runs libjpeg-turbo at.
//
// * Frames: SOF0, SOF1 (Huffman, 8-bit) and SOF2 (progressive: DC first
//   and refinement, AC first and refinement with EOB runs); 1, 3 or 4
//   components with sampling factors 1-4 whose ratios are integral;
//   interleaved and non-interleaved scans, DRI/RSTn restart intervals,
//   DQT and DHT anywhere before the scan that uses them (a sequential
//   scan falls back to the standard tables 0 and 1, as libjpeg-turbo's
//   does; a progressive one refuses a missing table).  Every scan is
//   decoded into whole-image coefficient arrays, then the image is made
//   from them, as libjpeg does for a file of several scans.
// * Pixels: ``jpeg_idct_islow`` (jidctint.c: 13-bit constants, 2 bits of
//   pass-1 scaling, the post-IDCT range-limit table with its 1023 mask);
//   upsampling as jdsample.c picks it: fancy h2v1 and h2v2 (triangle
//   filters, for components wider than 2 samples), fancy h1v2, box
//   replication for other integral ratios; edge rows and columns
//   replicated at the component's real size (jdmainct.c's context rows);
//   YCbCr -> RGB with jdcolor.c's 16-bit fixed-point tables; YCCK ->
//   CMYK; the color space from the JFIF and Adobe markers, else the
//   component ids, as ``default_decompress_parms`` chooses it.
// * Pillow's side: a 4-component image is read as inverted CMYK
//   (``CMYK;I``) and converted by ``cmyk2rgb``; "L" from color is
//   (R*19595 + G*38470 + B*7471 + 0x8000) >> 16.
// * Refused, with a message: arithmetic coding, 12-bit, lossless and
//   hierarchical frames, DNL heights, a progressive file whose scans
//   leave coefficients 1-9 unrefined (libjpeg would smooth its blocks),
//   and any stream that is truncated or does not decode: a bad Huffman
//   code, a segment that ends before its blocks, a wrong restart marker.
//   (libjpeg decodes some such streams with a warning; the port does
//   not.)
//
// No OpenMP: the precompute decodes one image a thread.
//
// Build: g++ -O3 -march=native -shared -fPIC jpeg_decode.cpp
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

// zigzag -> natural order, with 16 spare entries for a corrupt run that
// steps past 63 (jutils.c's jpeg_natural_order)
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huffman {
    bool defined = false;
    int maxcode[18];    // the largest code of each length, -1 if none
    int valoffset[18];  // symbol index = valoffset[l] + code
    uint8_t vals[256];
    int nvals = 0;
    // (length << 8) | symbol for every code of up to kLookBits bits
    uint16_t lookup[1 << kLookBits];
};

// jpeg_make_d_derived_tbl: canonical codes from the counts of each
// length; a table whose codes overflow their length is refused
void build_huffman(Huffman& h, const uint8_t* counts, const uint8_t* vals,
                   int nvals) {
    int size[257], code[256];
    int p = 0;
    for (int l = 1; l <= 16; ++l)
        for (int i = 0; i < counts[l - 1]; ++i) size[p++] = l;
    size[p] = 0;
    int c = 0, si = size[0];
    p = 0;
    while (size[p]) {
        while (size[p] == si) code[p++] = c++;
        if (c >= (1 << si)) throw Error("corrupt data: bad Huffman table");
        c <<= 1;
        ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
        if (counts[l - 1]) {
            h.valoffset[l] = p - code[p];
            p += counts[l - 1];
            h.maxcode[l] = code[p - 1];
        } else {
            h.maxcode[l] = -1;
            h.valoffset[l] = 0;
        }
    }
    h.maxcode[17] = 0x7FFFFFFF;
    std::memcpy(h.vals, vals, nvals);
    h.nvals = nvals;
    std::memset(h.lookup, 0, sizeof(h.lookup));
    p = 0;
    for (int l = 1; l <= kLookBits; ++l) {
        for (int i = 0; i < counts[l - 1]; ++i, ++p) {
            int first = code[p] << (kLookBits - l);
            for (int k = 0; k < (1 << (kLookBits - l)); ++k)
                h.lookup[first + k] = static_cast<uint16_t>((l << 8) | vals[p]);
        }
    }
    h.defined = true;
}

// The standard tables (ITU T.81 Annex K.3), which libjpeg-turbo's
// sequential decoder takes for tables 0 (luminance) and 1 (chrominance)
// when a scan names one that no DHT defined (jstdhuff.c: Motion-JPEG
// frames omit them)
const uint8_t kStdDcCounts[2][16] = {
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
const uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcCounts[2][16] = {
    {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125},
    {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119}};
const uint8_t kStdAcVals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
     0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
     0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
     0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
     0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
     0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
     0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
     0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
     0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
     0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
     0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
     0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
     0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
     0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
     0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
     0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
     0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
     0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
     0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
     0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
     0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
     0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
     0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
     0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
     0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int bw = 0, bh = 0;    // blocks that hold the component's samples
    int bwp = 0, bhp = 0;  // blocks of the coefficient array (MCU-padded)
    int dw = 0, dh = 0;    // the component's real size in samples
    int dc_tbl = 0, ac_tbl = 0;
    bool latched = false;  // its quantization table, at its first scan
    uint16_t q[64];        // natural order
    int last_dc = 0;
    int coef_bits[64];     // progressive: the last Al of each coefficient
    std::vector<int16_t> coef;
};

int extend(int v, int s) {  // HUFF_EXTEND
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

class Decoder {
public:
    Decoder(const uint8_t* data, size_t n) : p_(data), n_(n) {}

    void decode();
    int width() const { return width_; }
    int height() const { return height_; }
    // HxWx3 RGB or HxW gray into out, as Pillow's convert gives them
    void output(uint8_t* out, bool gray);

private:
    const uint8_t* p_;
    size_t n_, pos_ = 0;
    uint16_t qt_[4][64];
    bool qdef_[4] = {false, false, false, false};
    Huffman dc_[4], ac_[4];
    int restart_interval_ = 0;
    bool jfif_ = false, adobe_ = false;
    int adobe_transform_ = 0;
    bool frame_ = false, progressive_ = false;
    int width_ = 0, height_ = 0, ncomp_ = 0, hmax_ = 1, vmax_ = 1;
    int mcux_ = 0, mcuy_ = 0;
    Component comp_[4];
    int scans_ = 0;
    // the bit reader: the next bits MSB first; zeros stand in for the
    // bytes past a marker or the end, and ``padded_`` counts them
    uint64_t buf_ = 0;
    int nbits_ = 0, padded_ = 0;
    bool stopped_ = false;
    int eobrun_ = 0;

    uint8_t byte() {
        if (pos_ >= n_) throw Error("truncated file");
        return p_[pos_++];
    }
    int u16() {
        int hi = byte();
        return (hi << 8) | byte();
    }
    int next_marker();
    void read_dqt();
    void read_dht();
    void read_sof(int marker);
    void read_app(int marker, size_t len);
    void read_sos();
    void skip_segment() {
        int len = u16();
        if (len < 2 || pos_ + len - 2 > n_) throw Error("truncated file");
        pos_ += len - 2;
    }

    void reset_bits() {
        buf_ = 0;
        nbits_ = padded_ = 0;
        stopped_ = false;
    }
    void fill() {
        while (nbits_ <= 56) {
            unsigned c = 0;
            if (!stopped_) {
                if (pos_ >= n_) {
                    stopped_ = true;
                } else if (p_[pos_] != 0xFF) {
                    c = p_[pos_++];
                } else {
                    // FF 00 is an FF data byte (any FFs before the 00
                    // too, as libjpeg reads them); FF then anything
                    // else is a marker, where the data stops
                    size_t q = pos_ + 1;
                    while (q < n_ && p_[q] == 0xFF) ++q;
                    if (q < n_ && p_[q] == 0) {
                        c = 0xFF;
                        pos_ = q + 1;
                    } else {
                        stopped_ = true;
                    }
                }
            }
            if (stopped_) padded_ += 8;
            buf_ |= static_cast<uint64_t>(c) << (56 - nbits_);
            nbits_ += 8;
        }
    }
    int bits(int k) {
        if (k == 0) return 0;
        if (nbits_ < k) fill();
        int v = static_cast<int>(buf_ >> (64 - k));
        buf_ <<= k;
        nbits_ -= k;
        return v;
    }
    int decode(const Huffman& h) {
        if (nbits_ < 16) fill();
        int e = h.lookup[buf_ >> (64 - kLookBits)];
        if (e) {
            int l = e >> 8;
            buf_ <<= l;
            nbits_ -= l;
            return e & 0xFF;
        }
        int code = static_cast<int>(buf_ >> (64 - kLookBits));
        for (int l = kLookBits + 1; l <= 16; ++l) {
            code = (code << 1) | static_cast<int>((buf_ >> (64 - l)) & 1);
            if (code <= h.maxcode[l]) {
                buf_ <<= l;
                nbits_ -= l;
                int i = h.valoffset[l] + code;
                if (i < 0 || i >= h.nvals)
                    throw Error("corrupt data: bad Huffman code");
                return h.vals[i];
            }
        }
        throw Error("corrupt data: bad Huffman code");
    }
    // the segment's blocks must not have read past its end
    void check_overrun() {
        if (padded_ > nbits_)
            throw Error(pos_ >= n_ ? "truncated file"
                                   : "corrupt data: an entropy-coded "
                                     "segment ends before its blocks");
    }
    void finish_segment() {  // drop the rest of the byte, find the marker
        check_overrun();
        reset_bits();
        while (pos_ + 1 < n_ && !(p_[pos_] == 0xFF && p_[pos_ + 1] != 0 &&
                                  p_[pos_ + 1] != 0xFF))
            ++pos_;
        if (pos_ + 1 >= n_) throw Error("truncated file");
    }

    void decode_scan(Component** sc, int ns, int ss, int se, int ah, int al);
    void block_sequential(Component& c, int16_t* b);
    void block_dc_first(Component& c, int16_t* b, int al);
    void block_ac_first(Component& c, int16_t* b, int ss, int se, int al);
    void block_ac_refine(Component& c, int16_t* b, int ss, int se,
                         int al);
    void check_smoothing() const;
    void component_plane(Component& c, std::vector<uint8_t>& out) const;
    void upsample(const Component& c, const std::vector<uint8_t>& plane,
                  std::vector<uint8_t>& out) const;
};

int Decoder::next_marker() {
    // libjpeg skips bytes that are not a marker (a warning) and any FF
    // fill bytes before one
    for (;;) {
        uint8_t c = byte();
        if (c != 0xFF) continue;
        do {
            c = byte();
        } while (c == 0xFF);
        if (c != 0) return c;
    }
}

void Decoder::read_dqt() {
    int len = u16() - 2;
    size_t end = pos_ + len;
    if (len < 0 || end > n_) throw Error("truncated file");
    while (pos_ < end) {
        int pq = byte();
        int t = pq & 15, prec = pq >> 4;
        if (t > 3) throw Error("corrupt data: quantization table id > 3");
        for (int i = 0; i < 64; ++i) {
            int v = prec ? u16() : byte();
            qt_[t][kNatural[i]] = static_cast<uint16_t>(v);
        }
        qdef_[t] = true;
    }
    if (pos_ != end) throw Error("corrupt data: bad DQT length");
}

void Decoder::read_dht() {
    int len = u16() - 2;
    size_t end = pos_ + len;
    if (len < 0 || end > n_) throw Error("truncated file");
    while (pos_ + 17 <= end) {
        int tc = byte();
        uint8_t counts[16];
        int total = 0;
        for (int i = 0; i < 16; ++i) total += counts[i] = byte();
        if (total > 256 || pos_ + total > end)
            throw Error("corrupt data: bad Huffman table");
        uint8_t vals[256];
        for (int i = 0; i < total; ++i) vals[i] = byte();
        int t = tc & 15;
        if (t > 3 || (tc >> 4) > 1)
            throw Error("corrupt data: bad Huffman table id");
        build_huffman((tc >> 4) ? ac_[t] : dc_[t], counts, vals, total);
    }
    if (pos_ != end) throw Error("corrupt data: bad DHT length");
}

void Decoder::read_app(int marker, size_t len) {
    const uint8_t* d = p_ + pos_;
    if (marker == 0xE0 && len >= 14 && std::memcmp(d, "JFIF\0", 5) == 0)
        jfif_ = true;
    if (marker == 0xEE && len >= 12 && std::memcmp(d, "Adobe", 5) == 0) {
        adobe_ = true;
        adobe_transform_ = d[11];
    }
}

void Decoder::read_sof(int marker) {
    if (frame_) throw Error("corrupt data: a second frame header");
    int len = u16();
    int precision = byte();
    height_ = u16();
    width_ = u16();
    ncomp_ = byte();
    if (precision != 8)
        throw Error(std::to_string(precision) +
                    "-bit samples (only 8-bit JPEGs are read)");
    if (height_ == 0)
        throw Error("the height is set by a DNL marker (not supported)");
    if (width_ == 0) throw Error("corrupt data: width 0");
    if (ncomp_ != 1 && ncomp_ != 3 && ncomp_ != 4)
        throw Error("cannot handle " + std::to_string(ncomp_) +
                    "-component images");
    if (len != 8 + 3 * ncomp_) throw Error("corrupt data: bad SOF length");
    for (int i = 0; i < ncomp_; ++i) {
        Component& c = comp_[i];
        c.id = byte();
        int hv = byte();
        c.h = hv >> 4;
        c.v = hv & 15;
        c.tq = byte();
        if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
            throw Error("corrupt data: bad sampling factors");
        if (c.tq > 3) throw Error("corrupt data: quantization table id > 3");
        hmax_ = std::max(hmax_, c.h);
        vmax_ = std::max(vmax_, c.v);
    }
    mcux_ = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
    for (int i = 0; i < ncomp_; ++i) {
        Component& c = comp_[i];
        if (hmax_ % c.h || vmax_ % c.v)
            throw Error("sampling factors whose ratios are not integral "
                        "(not supported by libjpeg)");
        c.dw = static_cast<int>(
            (static_cast<int64_t>(width_) * c.h + hmax_ - 1) / hmax_);
        c.dh = static_cast<int>(
            (static_cast<int64_t>(height_) * c.v + vmax_ - 1) / vmax_);
        c.bw = (c.dw + 7) / 8;
        c.bh = (c.dh + 7) / 8;
        c.bwp = mcux_ * c.h;
        c.bhp = mcuy_ * c.v;
        c.coef.assign(static_cast<size_t>(c.bwp) * c.bhp * 64, 0);
        for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
    }
    frame_ = true;
    progressive_ = marker == 0xC2;
}

void Decoder::read_sos() {
    if (!frame_) throw Error("corrupt data: a scan before the frame header");
    int len = u16();
    int ns = byte();
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns)
        throw Error("corrupt data: bad SOS");
    Component* sc[4];
    for (int i = 0; i < ns; ++i) {
        int id = byte(), t = byte();
        Component* c = nullptr;
        for (int k = 0; k < ncomp_; ++k)
            if (comp_[k].id == id) c = &comp_[k];
        if (!c) throw Error("corrupt data: a scan names no component");
        for (int k = 0; k < i; ++k)
            if (sc[k] == c) throw Error("corrupt data: a component twice");
        c->dc_tbl = t >> 4;
        c->ac_tbl = t & 15;
        if (c->dc_tbl > 3 || c->ac_tbl > 3)
            throw Error("corrupt data: bad Huffman table id");
        sc[i] = c;
    }
    int ss = byte(), se = byte(), a = byte();
    int ah = a >> 4, al = a & 15;
    if (ns > 1) {
        int blocks = 0;
        for (int i = 0; i < ns; ++i) blocks += sc[i]->h * sc[i]->v;
        if (blocks > 10) throw Error("corrupt data: more than 10 blocks "
                                     "in an MCU");
    }
    for (int i = 0; i < ns; ++i) {  // latch_quant_tables
        Component& c = *sc[i];
        if (c.latched) continue;
        if (!qdef_[c.tq]) throw Error("corrupt data: no quantization table");
        std::memcpy(c.q, qt_[c.tq], sizeof(c.q));
        c.latched = true;
    }
    decode_scan(sc, ns, ss, se, ah, al);
    ++scans_;
}

void Decoder::decode() {
    if (n_ < 2 || p_[0] != 0xFF || p_[1] != 0xD8)
        throw Error("not a JPEG file");
    pos_ = 2;
    for (;;) {
        int m = next_marker();
        if (m == 0xD9) break;  // EOI
        switch (m) {
            case 0xC0: case 0xC1: case 0xC2:
                read_sof(m);
                break;
            case 0xC3:
                throw Error("lossless JPEG (not supported)");
            case 0xC5: case 0xC6: case 0xC7: case 0xDE: case 0xDF:
                throw Error("hierarchical JPEG (not supported)");
            case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE:
            case 0xCF:
                throw Error("arithmetic-coded JPEG (not supported)");
            case 0xC4: read_dht(); break;
            case 0xDB: read_dqt(); break;
            case 0xDD:
                if (u16() != 4) throw Error("corrupt data: bad DRI length");
                restart_interval_ = u16();
                break;
            case 0xDC:
                throw Error("the height is set by a DNL marker (not "
                            "supported)");
            case 0xDA:
                read_sos();
                break;
            case 0xCC:  // DAC: arithmetic conditioning, unused here
                skip_segment();
                break;
            case 0xD8:
                throw Error("corrupt data: a second SOI marker");
            case 0x01: case 0xD0: case 0xD1: case 0xD2: case 0xD3:
            case 0xD4: case 0xD5: case 0xD6: case 0xD7:
                break;  // parameterless (libjpeg ignores them here)
            default:
                if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE) {
                    int len = u16();
                    if (len < 2 || pos_ + len - 2 > n_)
                        throw Error("truncated file");
                    read_app(m, static_cast<size_t>(len - 2));
                    pos_ += len - 2;
                } else {
                    char buf[64];
                    std::snprintf(buf, sizeof(buf),
                                  "corrupt data: unknown marker 0x%02X", m);
                    throw Error(buf);
                }
        }
    }
    if (!frame_ || scans_ == 0) throw Error("corrupt data: no image");
    if (progressive_) check_smoothing();
}

void Decoder::decode_scan(Component** sc, int ns, int ss, int se, int ah,
                          int al) {
    enum Kind { kSeq, kDcFirst, kDcRefine, kAcFirst, kAcRefine } kind;
    if (!progressive_) {
        kind = kSeq;  // Ss, Se, Ah, Al are not checked (a libjpeg warning)
    } else {
        bool dc = ss == 0;
        bool bad = dc ? se != 0 : (ss > se || se > 63 || ns != 1);
        if (ah != 0 && al != ah - 1) bad = true;
        if (al > 13) bad = true;
        if (bad) throw Error("corrupt data: bad progressive scan "
                             "parameters");
        kind = dc ? (ah ? kDcRefine : kDcFirst) : (ah ? kAcRefine : kAcFirst);
        for (int i = 0; i < ns; ++i)
            for (int k = ss; k <= se; ++k) sc[i]->coef_bits[k] = al;
    }
    for (int i = 0; i < ns; ++i) {
        const Component& c = *sc[i];
        bool need_dc = kind == kSeq || kind == kDcFirst;
        bool need_ac = kind == kSeq || kind == kAcFirst || kind == kAcRefine;
        if (kind == kSeq) {  // the standard tables where none was defined
            if (c.dc_tbl < 2 && !dc_[c.dc_tbl].defined)
                build_huffman(dc_[c.dc_tbl], kStdDcCounts[c.dc_tbl],
                              kStdDcVals, 12);
            if (c.ac_tbl < 2 && !ac_[c.ac_tbl].defined)
                build_huffman(ac_[c.ac_tbl], kStdAcCounts[c.ac_tbl],
                              kStdAcVals[c.ac_tbl], 162);
        }
        if (need_dc) {
            const Huffman& h = dc_[c.dc_tbl];
            if (!h.defined) throw Error("corrupt data: no Huffman table");
            for (int k = 0; k < h.nvals; ++k)
                if (h.vals[k] > 15)
                    throw Error("corrupt data: bad Huffman table");
        }
        if (need_ac && !ac_[c.ac_tbl].defined)
            throw Error("corrupt data: no Huffman table");
    }
    for (int i = 0; i < ns; ++i) sc[i]->last_dc = 0;
    reset_bits();
    eobrun_ = 0;

    // MCU geometry: one block a unit for a one-component scan, else the
    // frame's MCUs of h x v blocks of each component
    const bool single = ns == 1;
    const int units_x = single ? sc[0]->bw : mcux_;
    const int units_y = single ? sc[0]->bh : mcuy_;
    const int64_t total = static_cast<int64_t>(units_x) * units_y;
    int next_rst = 0;
    for (int64_t u = 0; u < total; ++u) {
        if (restart_interval_ && u > 0 && u % restart_interval_ == 0) {
            finish_segment();
            if (p_[pos_ + 1] != 0xD0 + next_rst)
                throw Error("corrupt data: a missing or wrong restart "
                            "marker");
            pos_ += 2;
            next_rst = (next_rst + 1) & 7;
            for (int i = 0; i < ns; ++i) sc[i]->last_dc = 0;
            eobrun_ = 0;
        }
        const int ux = static_cast<int>(u % units_x);
        const int uy = static_cast<int>(u / units_x);
        for (int i = 0; i < ns; ++i) {
            Component& c = *sc[i];
            const int bh = single ? 1 : c.v, bwn = single ? 1 : c.h;
            for (int by = 0; by < bh; ++by) {
                for (int bx = 0; bx < bwn; ++bx) {
                    const int col = single ? ux : ux * c.h + bx;
                    const int row = single ? uy : uy * c.v + by;
                    int16_t* b = c.coef.data() +
                        (static_cast<size_t>(row) * c.bwp + col) * 64;
                    switch (kind) {
                        case kSeq: block_sequential(c, b); break;
                        case kDcFirst: block_dc_first(c, b, al); break;
                        case kDcRefine:
                            if (bits(1)) b[0] |= static_cast<int16_t>(1 << al);
                            break;
                        case kAcFirst: block_ac_first(c, b, ss, se, al); break;
                        case kAcRefine: block_ac_refine(c, b, ss, se, al); break;
                    }
                }
            }
        }
        check_overrun();
    }
    finish_segment();
}

void Decoder::block_sequential(Component& c, int16_t* b) {
    int s = decode(dc_[c.dc_tbl]);
    int diff = s ? extend(bits(s), s) : 0;
    c.last_dc = static_cast<int>(static_cast<unsigned>(c.last_dc) +
                                 static_cast<unsigned>(diff));
    b[0] = static_cast<int16_t>(c.last_dc);
    const Huffman& act = ac_[c.ac_tbl];
    for (int k = 1; k < 64; ++k) {
        int rs = decode(act);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
            k += r;
            b[kNatural[k]] = static_cast<int16_t>(extend(bits(s), s));
        } else {
            if (r != 15) break;
            k += 15;
        }
    }
}

void Decoder::block_dc_first(Component& c, int16_t* b, int al) {
    int s = decode(dc_[c.dc_tbl]);
    int diff = s ? extend(bits(s), s) : 0;
    c.last_dc = static_cast<int>(static_cast<unsigned>(c.last_dc) +
                                 static_cast<unsigned>(diff));
    b[0] = static_cast<int16_t>(static_cast<unsigned>(c.last_dc) << al);
}

void Decoder::block_ac_first(Component& c, int16_t* b, int ss, int se,
                             int al) {
    if (eobrun_ > 0) {
        --eobrun_;
        return;
    }
    const Huffman& act = ac_[c.ac_tbl];
    for (int k = ss; k <= se; ++k) {
        int rs = decode(act);
        int r = rs >> 4, s = rs & 15;
        if (s) {
            k += r;
            int v = extend(bits(s), s);
            b[kNatural[k]] =
                static_cast<int16_t>(static_cast<unsigned>(v) << al);
        } else if (r == 15) {
            k += 15;
        } else {
            eobrun_ = 1 << r;
            if (r) eobrun_ += bits(r);
            --eobrun_;
            break;
        }
    }
}

void Decoder::block_ac_refine(Component& c, int16_t* b, int ss, int se,
                              int al) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    const Huffman& act = ac_[c.ac_tbl];
    int k = ss;
    if (eobrun_ == 0) {
        for (; k <= se; ++k) {
            int rs = decode(act);
            int r = rs >> 4, s = rs & 15;
            if (s) {
                // a newly nonzero coefficient has size 1 (libjpeg warns
                // on others and reads one sign bit all the same)
                s = bits(1) ? p1 : m1;
            } else if (r != 15) {
                eobrun_ = 1 << r;
                if (r) eobrun_ += bits(r);
                break;
            }
            do {
                int16_t* t = b + kNatural[k];
                if (*t != 0) {
                    if (bits(1) && (*t & p1) == 0)
                        *t = static_cast<int16_t>(*t + (*t >= 0 ? p1 : m1));
                } else if (--r < 0) {
                    break;
                }
                ++k;
            } while (k <= se);
            if (s) b[kNatural[k]] = static_cast<int16_t>(s);
        }
    }
    if (eobrun_ > 0) {
        for (; k <= se; ++k) {
            int16_t* t = b + kNatural[k];
            if (*t != 0 && bits(1) && (*t & p1) == 0)
                *t = static_cast<int16_t>(*t + (*t >= 0 ? p1 : m1));
        }
        --eobrun_;
    }
}

void Decoder::check_smoothing() const {
    // jdcoefct.c's smoothing_ok at the output pass: libjpeg smooths the
    // blocks (decompress_smooth_data) when every component has its
    // quantization table latched with nonzero DC and low AC entries and
    // a DC scan, and some component's zigzag coefficients 1-9 are not
    // fully refined
    static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int i = 0; i < ncomp_; ++i) {
        const Component& c = comp_[i];
        if (!c.latched) return;
        for (int k = 0; k < 10; ++k)
            if (c.q[kPos[k]] == 0) return;
        if (c.coef_bits[0] < 0) return;
        for (int k = 1; k < 10; ++k)
            if (c.coef_bits[k] != 0) useful = true;
    }
    if (useful)
        throw Error("a progressive file whose scans leave coefficients 1-9 "
                    "unrefined (libjpeg's block smoothing is not "
                    "supported)");
}

// jidctint.c's jpeg_idct_islow
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t kFix0298631336 = 2446, kFix0390180644 = 3196,
                  kFix0541196100 = 4433, kFix0765366865 = 6270,
                  kFix0899976223 = 7373, kFix1175875602 = 9633,
                  kFix1501321110 = 12299, kFix1847759065 = 15137,
                  kFix1961570560 = 16069, kFix2053119869 = 16819,
                  kFix2562915447 = 20995, kFix3072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
    return (x + (int64_t(1) << (n - 1))) >> n;
}

// the post-IDCT range limit: a sample of x (centered on 0) is
// table[x & 1023]: x + 128 for -128 <= x < 128, then 255 up to 511 and
// 0 from -512, wrapping beyond (jdmaster.c's prepare_range_limit_table)
struct RangeLimit {
    uint8_t t[1024];
    RangeLimit() {
        for (int i = 0; i < 1024; ++i) {
            if (i < 128) t[i] = static_cast<uint8_t>(i + 128);
            else if (i < 512) t[i] = 255;
            else if (i < 896) t[i] = 0;
            else t[i] = static_cast<uint8_t>(i - 896);
        }
    }
};
const RangeLimit kRange;

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
    int ws[64];
    for (int col = 0; col < 8; ++col) {
        const int16_t* c = in + col;
        const uint16_t* qq = q + col;
        int* w = ws + col;
        if (c[8] == 0 && c[16] == 0 && c[24] == 0 && c[32] == 0 &&
            c[40] == 0 && c[48] == 0 && c[56] == 0) {
            int dc = static_cast<int>(static_cast<unsigned>(c[0] * qq[0])
                                      << kPass1Bits);
            for (int r = 0; r < 8; ++r) w[8 * r] = dc;
            continue;
        }
        int64_t z2 = c[16] * qq[16], z3 = c[48] * qq[48];
        int64_t z1 = (z2 + z3) * kFix0541196100;
        int64_t tmp2 = z1 + z3 * -kFix1847759065;
        int64_t tmp3 = z1 + z2 * kFix0765366865;
        z2 = c[0] * qq[0];
        z3 = c[32] * qq[32];
        int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
        int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = c[56] * qq[56];
        tmp1 = c[40] * qq[40];
        tmp2 = c[24] * qq[24];
        tmp3 = c[8] * qq[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * kFix1175875602;
        tmp0 *= kFix0298631336;
        tmp1 *= kFix2053119869;
        tmp2 *= kFix3072711026;
        tmp3 *= kFix1501321110;
        z1 *= -kFix0899976223;
        z2 *= -kFix2562915447;
        z3 *= -kFix1961570560;
        z4 *= -kFix0390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int n = kConstBits - kPass1Bits;
        w[0] = static_cast<int>(descale(tmp10 + tmp3, n));
        w[56] = static_cast<int>(descale(tmp10 - tmp3, n));
        w[8] = static_cast<int>(descale(tmp11 + tmp2, n));
        w[48] = static_cast<int>(descale(tmp11 - tmp2, n));
        w[16] = static_cast<int>(descale(tmp12 + tmp1, n));
        w[40] = static_cast<int>(descale(tmp12 - tmp1, n));
        w[24] = static_cast<int>(descale(tmp13 + tmp0, n));
        w[32] = static_cast<int>(descale(tmp13 - tmp0, n));
    }
    const int n = kConstBits + kPass1Bits + 3;
    for (int row = 0; row < 8; ++row) {
        const int* w = ws + 8 * row;
        uint8_t* o = out + static_cast<size_t>(row) * stride;
        if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
            w[6] == 0 && w[7] == 0) {
            uint8_t v = kRange.t[descale(w[0], kPass1Bits + 3) & 1023];
            for (int i = 0; i < 8; ++i) o[i] = v;
            continue;
        }
        int64_t z2 = w[2], z3 = w[6];
        int64_t z1 = (z2 + z3) * kFix0541196100;
        int64_t tmp2 = z1 + z3 * -kFix1847759065;
        int64_t tmp3 = z1 + z2 * kFix0765366865;
        int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << kConstBits);
        int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << kConstBits);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = w[7];
        tmp1 = w[5];
        tmp2 = w[3];
        tmp3 = w[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * kFix1175875602;
        tmp0 *= kFix0298631336;
        tmp1 *= kFix2053119869;
        tmp2 *= kFix3072711026;
        tmp3 *= kFix1501321110;
        z1 *= -kFix0899976223;
        z2 *= -kFix2562915447;
        z3 *= -kFix1961570560;
        z4 *= -kFix0390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        o[0] = kRange.t[descale(tmp10 + tmp3, n) & 1023];
        o[7] = kRange.t[descale(tmp10 - tmp3, n) & 1023];
        o[1] = kRange.t[descale(tmp11 + tmp2, n) & 1023];
        o[6] = kRange.t[descale(tmp11 - tmp2, n) & 1023];
        o[2] = kRange.t[descale(tmp12 + tmp1, n) & 1023];
        o[5] = kRange.t[descale(tmp12 - tmp1, n) & 1023];
        o[3] = kRange.t[descale(tmp13 + tmp0, n) & 1023];
        o[4] = kRange.t[descale(tmp13 - tmp0, n) & 1023];
    }
}

// the component's samples, bw*8 wide and bh*8 high
void Decoder::component_plane(Component& c, std::vector<uint8_t>& out) const {
    const int stride = c.bw * 8;
    out.assign(static_cast<size_t>(stride) * c.bh * 8, 0);
    for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
            idct_islow(c.coef.data() +
                           (static_cast<size_t>(by) * c.bwp + bx) * 64,
                       c.q, out.data() + static_cast<size_t>(by) * 8 * stride
                           + bx * 8, stride);
}

// the component at full size (width_ x height_), as jdsample.c upsamples
// it; rows above the first and below the last real one repeat them
void Decoder::upsample(const Component& c, const std::vector<uint8_t>& in,
                       std::vector<uint8_t>& out) const {
    const int W = width_, H = height_, stride = c.bw * 8;
    const int hf = hmax_ / c.h, vf = vmax_ / c.v, dw = c.dw, dh = c.dh;
    out.resize(static_cast<size_t>(W) * H);
    auto row = [&](int y) {
        y = std::min(std::max(y, 0), dh - 1);
        return in.data() + static_cast<size_t>(y) * stride;
    };
    if (hf == 1 && vf == 1) {
        for (int y = 0; y < H; ++y)
            std::memcpy(out.data() + static_cast<size_t>(y) * W, row(y), W);
    } else if (hf == 2 && vf == 1 && dw > 2) {  // h2v1_fancy_upsample
        for (int y = 0; y < H; ++y) {
            const uint8_t* s = row(y);
            uint8_t* o = out.data() + static_cast<size_t>(y) * W;
            for (int j = 0; j < dw; ++j) {
                int a = j == 0 ? s[0] : (s[j] * 3 + s[j - 1] + 1) >> 2;
                int b = j == dw - 1 ? s[j] : (s[j] * 3 + s[j + 1] + 2) >> 2;
                if (2 * j < W) o[2 * j] = static_cast<uint8_t>(a);
                if (2 * j + 1 < W) o[2 * j + 1] = static_cast<uint8_t>(b);
            }
        }
    } else if (hf == 1 && vf == 2) {  // h1v2_fancy_upsample
        for (int y = 0; y < H; ++y) {
            const int i = y / 2, near = y % 2 ? i + 1 : i - 1;
            const int bias = y % 2 ? 2 : 1;
            const uint8_t* s0 = row(i);
            const uint8_t* s1 = row(near);
            uint8_t* o = out.data() + static_cast<size_t>(y) * W;
            for (int x = 0; x < W; ++x)
                o[x] = static_cast<uint8_t>((s0[x] * 3 + s1[x] + bias) >> 2);
        }
    } else if (hf == 2 && vf == 2 && dw > 2) {  // h2v2_fancy_upsample
        std::vector<int> sum(dw);
        for (int y = 0; y < H; ++y) {
            const int i = y / 2, near = y % 2 ? i + 1 : i - 1;
            const uint8_t* s0 = row(i);
            const uint8_t* s1 = row(near);
            for (int j = 0; j < dw; ++j) sum[j] = s0[j] * 3 + s1[j];
            uint8_t* o = out.data() + static_cast<size_t>(y) * W;
            for (int j = 0; j < dw; ++j) {
                int a = j == 0 ? (sum[0] * 4 + 8) >> 4
                               : (sum[j] * 3 + sum[j - 1] + 8) >> 4;
                int b = j == dw - 1 ? (sum[j] * 4 + 7) >> 4
                                    : (sum[j] * 3 + sum[j + 1] + 7) >> 4;
                if (2 * j < W) o[2 * j] = static_cast<uint8_t>(a);
                if (2 * j + 1 < W) o[2 * j + 1] = static_cast<uint8_t>(b);
            }
        }
    } else {  // int_upsample, h2v1_upsample, h2v2_upsample: replication
        for (int y = 0; y < H; ++y) {
            const uint8_t* s = row(y / vf);
            uint8_t* o = out.data() + static_cast<size_t>(y) * W;
            for (int x = 0; x < W; ++x) o[x] = s[x / hf];
        }
    }
}

// jdcolor.c's build_ycc_rgb_table (SCALEBITS 16)
struct YccTables {
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    YccTables() {
        const int64_t half = int64_t(1) << 15;
        auto fix = [](double x) {
            return static_cast<int64_t>(x * 65536.0 + 0.5);
        };
        for (int i = 0; i < 256; ++i) {
            const int64_t x = i - 128;
            cr_r[i] = static_cast<int>((fix(1.40200) * x + half) >> 16);
            cb_b[i] = static_cast<int>((fix(1.77200) * x + half) >> 16);
            cr_g[i] = -fix(0.71414) * x;
            cb_g[i] = -fix(0.34414) * x + half;
        }
    }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) {
    return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

inline uint8_t luma(int r, int g, int b) {  // Pillow's rgb2l
    return static_cast<uint8_t>((r * 19595 + g * 38470 + b * 7471 + 0x8000)
                                >> 16);
}

void Decoder::output(uint8_t* out, bool gray) {
    const size_t npix = static_cast<size_t>(width_) * height_;
    std::vector<uint8_t> plane, full[4];
    for (int i = 0; i < ncomp_; ++i) {
        component_plane(comp_[i], plane);
        upsample(comp_[i], plane, full[i]);
    }
    if (ncomp_ == 1) {
        const uint8_t* y = full[0].data();
        if (gray) {
            std::memcpy(out, y, npix);
        } else {
            for (size_t k = 0; k < npix; ++k)
                out[3 * k] = out[3 * k + 1] = out[3 * k + 2] = y[k];
        }
        return;
    }
    // default_decompress_parms: the JFIF marker, else the Adobe marker's
    // transform, else the component ids decide the color space
    bool ycc;
    if (ncomp_ == 3) {
        if (jfif_) ycc = true;
        else if (adobe_) ycc = adobe_transform_ != 0;
        else ycc = !(comp_[0].id == 82 && comp_[1].id == 71 &&
                     comp_[2].id == 66);
    } else {
        ycc = adobe_ && adobe_transform_ != 0;  // YCCK, else CMYK
    }
    const uint8_t *c0 = full[0].data(), *c1 = full[1].data(),
                  *c2 = full[2].data();
    for (size_t k = 0; k < npix; ++k) {
        int r, g, b;
        if (ycc) {
            const int y = c0[k], cb = c1[k], cr = c2[k];
            r = clamp255(y + kYcc.cr_r[cr]);
            g = clamp255(y + static_cast<int>(
                                 (kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
            b = clamp255(y + kYcc.cb_b[cb]);
        } else {
            r = c0[k];
            g = c1[k];
            b = c2[k];
        }
        if (ncomp_ == 4) {
            // YCCK -> CMYK inverts the color channels; Pillow then reads
            // CMYK inverted ("CMYK;I") and cmyk2rgb makes
            // nk - nk * C / 255 of each with nk = 255 - K
            int cc, mm, yy;
            if (ycc) {
                cc = r;  // 255 - (255 - r): the two inversions cancel
                mm = g;
                yy = b;
            } else {
                cc = 255 - r;
                mm = 255 - g;
                yy = 255 - b;
            }
            const int nk = full[3][k];  // 255 - (255 - K)
            auto muldiv = [](int a, int bb) {
                int t = a * bb + 128;
                return ((t >> 8) + t) >> 8;
            };
            r = clamp255(nk - muldiv(cc, nk));
            g = clamp255(nk - muldiv(mm, nk));
            b = clamp255(nk - muldiv(yy, nk));
        }
        if (gray) {
            out[k] = luma(r, g, b);
        } else {
            out[3 * k] = static_cast<uint8_t>(r);
            out[3 * k + 1] = static_cast<uint8_t>(g);
            out[3 * k + 2] = static_cast<uint8_t>(b);
        }
    }
}

}  // namespace

extern "C" {

// The JPEG in data[0:n] decoded into out (HxWx3 RGB, or HxW when gray),
// as Pillow's convert("RGB") / convert("L") give it; out holds cap
// bytes.  *w and *h receive the size.  Returns 0, 1 with a message in
// err (at most errlen bytes) when the file is refused, or 2 when cap is
// too small for the image.
int jpeg_decode(const uint8_t* data, size_t n, int gray, uint8_t* out,
                size_t cap, int* w, int* h, char* err, int errlen) {
    try {
        Decoder d(data, n);
        d.decode();
        *w = d.width();
        *h = d.height();
        const size_t need = static_cast<size_t>(d.width()) * d.height() *
                            (gray ? 1 : 3);
        if (need > cap) return 2;
        d.output(out, gray != 0);
        return 0;
    } catch (const std::exception& e) {
        std::snprintf(err, static_cast<size_t>(errlen), "%s", e.what());
        return 1;
    }
}

}  // extern "C"
