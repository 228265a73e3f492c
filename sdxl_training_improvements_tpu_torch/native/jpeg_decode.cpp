// A JPEG decoder for the image reader (``images.py``): what Pillow's
// ``Image.open(p).convert("RGB")`` and ``.convert("L")`` give, bit for
// bit, with the settings Pillow runs libjpeg-turbo 3 at, and refusing
// what Pillow refuses.  The decoder follows libjpeg-turbo's control flow
// (jdmarker.c, jdinput.c, jdcoefct.c, jdhuff.c, jdphuff.c, jdarith.c,
// jddiffct.c, jdlossls.c, jdlhuff.c) wherever that flow decides pixels
// or a refusal.
//
// * Frames: SOF0, SOF1 (Huffman, 8-bit), SOF2 (progressive Huffman),
//   SOF9 (sequential arithmetic), SOF10 (progressive arithmetic) and
//   SOF3 (lossless Huffman, predictors 1-7, point transform); 1, 3 or 4
//   components with sampling factors 1-4 whose ratios are integral;
//   interleaved and non-interleaved scans, DRI/RSTn restart intervals,
//   DQT, DHT and DAC anywhere before the scan that uses them (a
//   sequential Huffman scan falls back to the standard tables 0 and 1,
//   as libjpeg-turbo's does; DAC's defaults are L 0, U 1, K 5).  Every
//   scan is decoded into whole-image coefficient (or sample) arrays, then
//   the image is made from them.
// * Damaged streams, as libjpeg-turbo recovers from them (each a warning
//   there, none a refusal): a bad Huffman code is read as symbol 0; a
//   segment whose data runs into a marker reads zero bits to the end of
//   that MCU, then leaves the segment's later MCUs empty (zero, or as
//   earlier scans left them); bytes before a marker are skipped; a
//   missing or wrong RSTn is resolved by ``jpeg_resync_to_restart``'s
//   rule; the arithmetic decoder reads zeros past a marker and stops a
//   scan whose code overflows.
// * Pillow's side of the stream: Pillow hands libjpeg the file in reads
//   of 64 KiB and stops at the first read that returns nothing, so a
//   stream that ends before libjpeg is done is "truncated" -- except
//   after the last row of a single-scan file, where Pillow stops
//   without reading further (what follows the scan then is not read).
//   The arithmetic decoder cannot wait for a read: a scan whose data
//   runs past what Pillow had read when it began is refused, as Pillow
//   refuses it.  libjpeg-turbo's fast Huffman path (taken with 512 bytes
//   a block left in the read) fills its bit buffer otherwise than the
//   slow one, which decides where a stream cut short fails; both are
//   followed.
// * Pixels: ``jpeg_idct_islow`` (jidctint.c: 13-bit constants, 2 bits of
//   pass-1 scaling, the post-IDCT range-limit table with its 1023 mask);
//   progressive block smoothing (jdcoefct.c's ``decompress_smooth_data``:
//   coefficients 1-9 estimated from a 5x5 neighbourhood of DC values,
//   and the DC itself when no AC is known) where the scans leave any of
//   them unrefined; upsampling as jdsample.c picks it: fancy h2v1 and
//   h2v2 (triangle filters, for components wider than 2 samples), fancy
//   h1v2, box replication for other integral ratios and for lossless
//   frames; edge rows and columns replicated at the component's real
//   size (jdmainct.c's context rows); YCbCr -> RGB with jdcolor.c's
//   16-bit fixed-point tables; YCCK -> CMYK; the color space from the
//   JFIF and Adobe markers, else the component ids, as
//   ``default_decompress_parms`` chooses it (RGB for a lossless frame).
// * Pillow's side of the pixels: a 4-component image is read as inverted
//   CMYK (``CMYK;I``) and converted by ``cmyk2rgb``; "L" from color is
//   (R*19595 + G*38470 + B*7471 + 0x8000) >> 16.
// * Refused, with a message, as Pillow refuses them: samples other than
//   8 bits, hierarchical frames (SOF5-7, 13-15), arithmetic lossless
//   (SOF11, which libjpeg-turbo does not read), a height of 0 (set by a
//   DNL marker), fractional sampling ratios, truncated streams and what
//   libjpeg treats as fatal (bad tables, scan headers and markers).
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
struct Done {};     // Pillow stops reading after a single-scan file's rows
struct Suspend {};  // a Huffman decoder needs bytes past Pillow's read

// Pillow's ``ImageFile.MAXBLOCK``: the file reaches libjpeg in reads of
// this many bytes
constexpr size_t kPillowRead = 65536;

// zigzag -> natural order, with 16 spare entries for a corrupt run that
// steps past 63 (jutils.c's jpeg_natural_order)
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------- Huffman

// a table as DHT gives it (bits[1..16], the symbols zero-filled to 256)
struct HuffSpec {
    bool defined = false;
    uint8_t bits[17];
    uint8_t vals[256];
};

constexpr int kLook = 8;  // HUFF_LOOKAHEAD

// jpeg_make_d_derived_tbl's tables
struct Derived {
    int64_t maxcode[18];
    int64_t valoffset[18];
    uint16_t lookup[1 << kLook];  // (length << 8) | symbol, or 9 << 8
    uint8_t vals[256];
};

void make_derived(Derived& d, const HuffSpec* specs, int t, bool dc,
                  int dc_max) {
    if (t >= 4 || !specs[t].defined)
        throw Error("corrupt data: a scan names a Huffman table no DHT "
                    "defined");
    const HuffSpec& h = specs[t];
    char size[257];
    unsigned code[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
        int i = h.bits[l];
        if (p + i > 256) throw Error("corrupt data: bad Huffman table");
        while (i--) size[p++] = static_cast<char>(l);
    }
    size[p] = 0;
    const int nsym = p;
    unsigned c = 0;
    int si = size[0];
    p = 0;
    while (size[p]) {
        while (size[p] == si) code[p++] = c++;
        if (static_cast<int64_t>(c) >= (int64_t(1) << si))
            throw Error("corrupt data: bad Huffman table");
        c <<= 1;
        ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
        if (h.bits[l]) {
            d.valoffset[l] = int64_t(p) - int64_t(code[p]);
            p += h.bits[l];
            d.maxcode[l] = code[p - 1];
        } else {
            d.maxcode[l] = -1;
        }
    }
    d.valoffset[17] = 0;
    d.maxcode[17] = 0xFFFFF;
    for (int i = 0; i < (1 << kLook); ++i)
        d.lookup[i] = static_cast<uint16_t>((kLook + 1) << kLook);
    p = 0;
    for (int l = 1; l <= kLook; ++l) {
        for (int i = 1; i <= h.bits[l]; ++i, ++p) {
            int look = static_cast<int>(code[p] << (kLook - l));
            for (int k = 1 << (kLook - l); k > 0; --k)
                d.lookup[look++] = static_cast<uint16_t>((l << kLook) |
                                                         h.vals[p]);
        }
    }
    if (dc)
        for (int i = 0; i < nsym; ++i)
            if (h.vals[i] > dc_max)
                throw Error("corrupt data: bad Huffman table");
    std::memcpy(d.vals, h.vals, 256);
}

// The standard tables (ITU T.81 Annex K.3), which libjpeg-turbo's
// sequential decoder takes for tables 0 (luminance) and 1 (chrominance)
// when no DHT defined them (jstdhuff.c: Motion-JPEG frames omit them)
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

void std_table(HuffSpec& h, const uint8_t* counts, const uint8_t* vals,
               int n) {
    h.bits[0] = 0;
    std::memcpy(h.bits + 1, counts, 16);
    std::memset(h.vals, 0, 256);
    std::memcpy(h.vals, vals, n);
    h.defined = true;
}

// ------------------------------------------------------------ arithmetic

// jaricom.c's jpeg_aritab: (Qe << 16) | (Next_Index_MPS << 8) |
// (Switch_MPS << 7) | Next_Index_LPS; the last entry is the fixed 0.5
// estimate of T.851
const int64_t kAriTab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171};

constexpr int kDcStatBins = 64, kAcStatBins = 256;

// ------------------------------------------------------------- the frame

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int bw = 0, bh = 0;    // width_in_blocks, height_in_blocks (blocks,
                           // or samples in a lossless frame)
    int bwp = 0, bhp = 0;  // the arrays' size: whole iMCUs
    int dw = 0, dh = 0;    // the component's real size in samples
    int dc_tbl = 0, ac_tbl = 0;
    bool latched = false;  // its quantization table, at its first scan
    uint16_t q[64] = {};   // natural order
    int coef_bits[64];     // progressive: the last Al of each coefficient
    int prev_bits[64];     // ... before the scan that last set it
    std::vector<int16_t> coef;     // DCT frames: bwp x bhp blocks
    std::vector<uint16_t> sample;  // lossless frames: bwp x bhp samples
    std::vector<uint8_t> plane;    // ... and as JSAMPLEs, Pt applied
    int16_t* block(int row, int col) {
        return coef.data() + (static_cast<size_t>(row) * bwp + col) * 64;
    }
};

int huff_extend(int x, int s) {  // HUFF_EXTEND
    return x < (1 << (s - 1)) ? x + static_cast<int>(
        static_cast<unsigned>(-1) << s) + 1 : x;
}

// the bit reader of jdhuff.c: ``buf``'s low ``left`` bits are next
struct Bits {
    uint64_t buf = 0;
    int left = 0;
    size_t pos = 0;
};

constexpr int kMinGetBits = 57;  // MIN_GET_BITS on a 64-bit build

enum ReadResult { kReachedSOS, kReachedEOI };

class Decoder {
public:
    Decoder(const uint8_t* data, size_t n)
        : p_(data), n_(n), end_(std::min(n, kPillowRead)) {}

    void decode();
    int width() const { return width_; }
    int height() const { return height_; }
    // HxWx3 RGB or HxW gray into out, as Pillow's convert gives them
    void output(uint8_t* out, bool gray);

private:
    // the stream, and how much of it Pillow has handed libjpeg
    const uint8_t* p_;
    size_t n_, pos_ = 0, end_;
    bool finishing_ = false;  // past a single-scan file's last row
    bool no_suspend_ = false;  // in an arithmetic scan
    int unread_ = 0;           // cinfo->unread_marker

    // the marker reader's state
    bool saw_soi_ = false, saw_sof_ = false;
    int next_restart_ = 0;
    uint16_t qt_[4][64];
    bool qdef_[4] = {false, false, false, false};
    HuffSpec dc_spec_[4], ac_spec_[4];
    uint8_t arith_l_[16], arith_u_[16], arith_k_[16];
    int restart_interval_ = 0;
    bool jfif_ = false, adobe_ = false;
    int adobe_transform_ = 0;

    // the frame
    bool progressive_ = false, lossless_ = false, arith_ = false;
    int precision_ = 0, width_ = 0, height_ = 0, ncomp_ = 0;
    int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0, imcu_rows_ = 0;
    Component comp_[4];
    bool multiple_scans_ = false;
    int input_scan_ = 0;
    int last_good_row_ = 0;  // last_good_iMCU_row

    // the scan
    int ns_ = 0, ss_ = 0, se_ = 0, ah_ = 0, al_ = 0;
    Component* sc_[4];
    int blocks_in_mcu_ = 0;

    // the entropy decoders' state
    Bits bits_;
    bool insufficient_ = false;
    int last_dc_[4] = {0, 0, 0, 0};
    unsigned eobrun_ = 0;
    int restarts_to_go_ = 0;
    Derived dc_tbl_[4], ac_tbl_[4];
    int64_t ac_c_ = 0, ac_a_ = 0;
    int ac_ct_ = 0;
    int dc_context_[4] = {0, 0, 0, 0};
    uint8_t dc_stats_[16][kDcStatBins], ac_stats_[16][kAcStatBins];
    uint8_t fixed_bin_[4] = {113, 0, 0, 0};

    // lossless: the undifferencer's state of each component
    bool first_row_[4] = {true, true, true, true};
    int restart_rows_to_go_ = 0;

    // block smoothing's latched coefficient bits (jdcoefct.c)
    int latch_[4][10], prev_latch_[4][10];

    // ---- reading
    void need_more() {
        if (finishing_) throw Done();
        if (no_suspend_)
            throw Error("the arithmetic-coded data runs past what Pillow "
                        "had read (libjpeg cannot suspend its arithmetic "
                        "decoder: Pillow refuses the file)");
        if (end_ >= n_) throw Error("truncated file");
        end_ = std::min(end_ + kPillowRead, n_);
    }
    int mbyte() {  // a byte of the marker layer (INPUT_BYTE)
        while (pos_ >= end_) need_more();
        return p_[pos_++];
    }
    int m16() {
        int hi = mbyte();
        return (hi << 8) | mbyte();
    }
    void skip(int64_t len) {  // skip_input_data
        if (len > 0) pos_ += static_cast<size_t>(len);
    }

    // ---- markers (jdmarker.c)
    void first_marker();
    void next_marker();
    int read_markers();
    void get_soi();
    void get_sof(bool prog, bool lossless, bool arith);
    void get_sos();
    void get_dac();
    void get_dht();
    void get_dqt();
    void get_dri();
    void get_app(int marker);
    void skip_variable() { skip(static_cast<int64_t>(m16()) - 2); }
    void read_restart_marker();
    void resync_to_restart(int desired);

    // ---- set-up (jdinput.c, jdmaster.c)
    void initial_setup();
    void master_selection();
    void start_scan();

    // ---- entropy decoding
    void decode_scan();
    void decode_mcu(int16_t** blocks);
    void process_restart_huff();
    void fill(Bits& b, int nbits);
    int peek(Bits& b, int n) {
        return static_cast<int>(b.buf >> (b.left - n)) & ((1 << n) - 1);
    }
    int get(Bits& b, int n) {
        b.left -= n;
        return static_cast<int>(b.buf >> b.left) & ((1 << n) - 1);
    }
    int check_get(Bits& b, int n) {  // CHECK_BIT_BUFFER then GET_BITS
        if (b.left < n) fill(b, n);
        return get(b, n);
    }
    int huff_decode(Bits& b, const Derived& t);
    int huff_decode_slow(Bits& b, const Derived& t, int l);
    bool mcu_seq_fast(int16_t** blocks);
    void mcu_seq_slow(int16_t** blocks);
    void mcu_dc_first(int16_t** blocks);
    void mcu_dc_refine(int16_t** blocks);
    void mcu_ac_first(int16_t** blocks);
    void mcu_ac_refine(int16_t** blocks);

    int abyte() {
        if (pos_ >= end_) need_more();
        return p_[pos_++];
    }
    int arith_decode(uint8_t* st);
    void arith_process_restart();
    void arith_mcu(int16_t** blocks);
    int arith_dc_diff(int ci, int tbl, bool& overflow);
    void arith_ac_value(int tbl, int k, uint8_t* st, int& v, bool& overflow);

    void decode_lossless_scan();
    void undifference(Component& c, int row, int prev_row, int ci);

    // ---- pixels
    bool smoothing_ok();
    // default_decompress_parms: the JFIF marker, else the Adobe marker's
    // transform, else the component ids decide whether a 3-component
    // frame is YCbCr (a lossless frame is taken for RGB where a lossy one
    // is YCbCr), and a 4-component one YCCK
    bool ycc_() const {
        if (ncomp_ == 3) {
            if (jfif_) return true;
            if (adobe_) return adobe_transform_ != 0;
            if (comp_[0].id == 82 && comp_[1].id == 71 && comp_[2].id == 66)
                return false;
            return !lossless_;
        }
        return ncomp_ == 4 && adobe_ && adobe_transform_ != 0;
    }
    void component_plane(int ci, bool smooth, std::vector<uint8_t>& out);
    void smooth_plane(int ci, std::vector<uint8_t>& out);
    void upsample(const Component& c, const std::vector<uint8_t>& plane,
                  int stride, bool fancy, std::vector<uint8_t>& out) const;
};

// ------------------------------------------------------------- markers

void Decoder::first_marker() {
    int c = mbyte(), c2 = mbyte();
    if (c != 0xFF || c2 != 0xD8) throw Error("not a JPEG file");
    unread_ = c2;
}

void Decoder::next_marker() {
    // bytes that are not a marker are skipped (a libjpeg warning), FF 00
    // pairs included, and any FF fill bytes before one
    int c;
    for (;;) {
        c = mbyte();
        while (c != 0xFF) c = mbyte();
        do {
            c = mbyte();
        } while (c == 0xFF);
        if (c != 0) break;
    }
    unread_ = c;
}

int Decoder::read_markers() {
    for (;;) {
        if (unread_ == 0) {
            if (!saw_soi_) first_marker();
            else next_marker();
        }
        const int m = unread_;
        switch (m) {
            case 0xD8: get_soi(); break;
            case 0xC0: case 0xC1: get_sof(false, false, false); break;
            case 0xC2: get_sof(true, false, false); break;
            case 0xC3: get_sof(false, true, false); break;
            case 0xC9: get_sof(false, false, true); break;
            case 0xCA: get_sof(true, false, true); break;
            case 0xCB: get_sof(false, true, true); break;
            case 0xC5: case 0xC6: case 0xC7: case 0xC8: case 0xCD:
            case 0xCE: case 0xCF: {
                char buf[96];
                std::snprintf(buf, sizeof(buf),
                              "hierarchical JPEG (frame marker 0x%02X: "
                              "libjpeg does not read it)", m);
                throw Error(buf);
            }
            case 0xDA:
                get_sos();
                unread_ = 0;
                return kReachedSOS;
            case 0xD9:
                unread_ = 0;
                return kReachedEOI;
            case 0xCC: get_dac(); break;
            case 0xC4: get_dht(); break;
            case 0xDB: get_dqt(); break;
            case 0xDD: get_dri(); break;
            case 0xFE: skip_variable(); break;
            case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4:
            case 0xD5: case 0xD6: case 0xD7: case 0x01:
                break;  // parameterless
            case 0xDC: skip_variable(); break;  // DNL: ignored
            default:
                if (m >= 0xE0 && m <= 0xEF) {
                    get_app(m);
                } else {
                    char buf[64];
                    std::snprintf(buf, sizeof(buf),
                                  "corrupt data: unknown marker 0x%02X", m);
                    throw Error(buf);
                }
        }
        unread_ = 0;
    }
}

void Decoder::get_soi() {
    if (saw_soi_) throw Error("corrupt data: a second SOI marker");
    for (int i = 0; i < 16; ++i) {
        arith_l_[i] = 0;
        arith_u_[i] = 1;
        arith_k_[i] = 5;
    }
    restart_interval_ = 0;
    jfif_ = adobe_ = false;
    adobe_transform_ = 0;
    saw_soi_ = true;
}

void Decoder::get_sof(bool prog, bool lossless, bool arith) {
    if (saw_sof_) throw Error("corrupt data: a second frame header");
    progressive_ = prog;
    lossless_ = lossless;
    arith_ = arith;
    int len = m16();
    precision_ = mbyte();
    height_ = m16();
    width_ = m16();
    ncomp_ = mbyte();
    len -= 8;
    if (height_ == 0 || width_ == 0 || ncomp_ == 0)
        throw Error("empty image: the height is set by a DNL marker (not "
                    "supported by libjpeg)");
    if (len != 3 * ncomp_) throw Error("corrupt data: bad SOF length");
    if (ncomp_ != 1 && ncomp_ != 3 && ncomp_ != 4)
        throw Error("cannot handle " + std::to_string(ncomp_) +
                    "-component images");
    for (int i = 0; i < ncomp_; ++i) {
        Component& c = comp_[i];
        c.id = mbyte();
        int hv = mbyte();
        c.h = (hv >> 4) & 15;
        c.v = hv & 15;
        c.tq = mbyte();
    }
    saw_sof_ = true;
}

void Decoder::get_sos() {
    if (!saw_sof_) throw Error("corrupt data: a scan before the frame "
                               "header");
    int len = m16();
    int n = mbyte();
    if (len != 2 * n + 6 || n < 1 || n > 4)
        throw Error("corrupt data: bad SOS length");
    ns_ = n;
    for (int i = 0; i < 4; ++i) sc_[i] = nullptr;
    // jdmarker.c's lookup: the first component with the id whose
    // component index is not yet a filled scan slot
    Component* cur[4] = {nullptr, nullptr, nullptr, nullptr};
    for (int i = 0; i < n; ++i) {
        int cc = mbyte(), t = mbyte();
        Component* c = nullptr;
        for (int ci = 0; ci < ncomp_ && ci < 4; ++ci)
            if (cc == comp_[ci].id && !cur[ci]) {
                c = &comp_[ci];
                break;
            }
        if (!c) throw Error("corrupt data: a scan names no component of "
                            "the frame");
        cur[i] = c;
        for (int k = 0; k < i; ++k)
            if (cur[k] == c) throw Error("corrupt data: a component twice "
                                         "in a scan");
        c->dc_tbl = (t >> 4) & 15;
        c->ac_tbl = t & 15;
    }
    for (int i = 0; i < n; ++i) sc_[i] = cur[i];
    ss_ = mbyte();
    se_ = mbyte();
    int a = mbyte();
    ah_ = (a >> 4) & 15;
    al_ = a & 15;
    next_restart_ = 0;
    ++input_scan_;
}

void Decoder::get_dac() {
    int len = m16() - 2;
    while (len > 0) {
        int index = mbyte(), val = mbyte();
        len -= 2;
        if (index >= 32) throw Error("corrupt data: bad DAC index");
        if (index >= 16) {
            arith_k_[index - 16] = static_cast<uint8_t>(val);
        } else {
            arith_l_[index] = static_cast<uint8_t>(val & 15);
            arith_u_[index] = static_cast<uint8_t>(val >> 4);
            if (arith_l_[index] > arith_u_[index])
                throw Error("corrupt data: bad DAC value");
        }
    }
    if (len != 0) throw Error("corrupt data: bad DAC length");
}

void Decoder::get_dht() {
    int len = m16() - 2;
    while (len > 16) {
        int index = mbyte();
        uint8_t bits[17];
        bits[0] = 0;
        int count = 0;
        for (int i = 1; i <= 16; ++i) count += bits[i] =
            static_cast<uint8_t>(mbyte());
        len -= 17;
        if (count > 256 || count > len)
            throw Error("corrupt data: bad Huffman table");
        uint8_t vals[256];
        for (int i = 0; i < count; ++i) vals[i] = static_cast<uint8_t>(
            mbyte());
        std::memset(vals + count, 0, 256 - count);
        len -= count;
        HuffSpec* h;
        if (index & 0x10) {
            index -= 0x10;
            if (index >= 4) throw Error("corrupt data: bad Huffman table id");
            h = &ac_spec_[index];
        } else {
            if (index >= 4) throw Error("corrupt data: bad Huffman table id");
            h = &dc_spec_[index];
        }
        std::memcpy(h->bits, bits, 17);
        std::memcpy(h->vals, vals, 256);
        h->defined = true;
    }
    if (len != 0) throw Error("corrupt data: bad DHT length");
}

void Decoder::get_dqt() {
    int len = m16() - 2;
    while (len > 0) {
        --len;
        int n = mbyte();
        int prec = n >> 4;
        n &= 15;
        if (n >= 4) throw Error("corrupt data: quantization table id > 3");
        for (int i = 0; i < 64; ++i)
            qt_[n][kNatural[i]] = static_cast<uint16_t>(prec ? m16()
                                                              : mbyte());
        len -= 64;
        if (prec) len -= 64;
        qdef_[n] = true;
    }
    if (len != 0) throw Error("corrupt data: bad DQT length");
}

void Decoder::get_dri() {
    if (m16() != 4) throw Error("corrupt data: bad DRI length");
    restart_interval_ = m16();
}

void Decoder::get_app(int marker) {
    // APP0 and APP14 are read for the JFIF and Adobe markers (their first
    // 14 bytes, get_interesting_appn); the rest is skipped
    int64_t len = static_cast<int64_t>(m16()) - 2;
    if (marker != 0xE0 && marker != 0xEE) {
        skip(len);
        return;
    }
    uint8_t b[14];
    int nread = len >= 14 ? 14 : (len > 0 ? static_cast<int>(len) : 0);
    for (int i = 0; i < nread; ++i) b[i] = static_cast<uint8_t>(mbyte());
    len -= nread;
    if (marker == 0xE0 && nread >= 14 && std::memcmp(b, "JFIF\0", 5) == 0)
        jfif_ = true;
    if (marker == 0xEE && nread >= 12 && std::memcmp(b, "Adobe", 5) == 0) {
        adobe_ = true;
        adobe_transform_ = b[11];
    }
    skip(len);
}

void Decoder::read_restart_marker() {
    if (unread_ == 0) next_marker();
    if (unread_ == 0xD0 + next_restart_) unread_ = 0;
    else resync_to_restart(next_restart_);
    next_restart_ = (next_restart_ + 1) & 7;
}

void Decoder::resync_to_restart(int desired) {
    // jpeg_resync_to_restart: discard a marker near the expected one,
    // skip forward past an earlier one, else leave the marker unread (the
    // segment reads as empty)
    for (;;) {
        const int m = unread_;
        int action;
        if (m < 0xC0) {
            action = 2;
        } else if (m < 0xD0 || m > 0xD7) {
            action = 3;
        } else if (m == 0xD0 + ((desired + 1) & 7) ||
                   m == 0xD0 + ((desired + 2) & 7)) {
            action = 3;
        } else if (m == 0xD0 + ((desired - 1) & 7) ||
                   m == 0xD0 + ((desired - 2) & 7)) {
            action = 2;
        } else {
            action = 1;
        }
        if (action == 1) {
            unread_ = 0;
            return;
        }
        if (action == 3) return;
        next_marker();
    }
}

// -------------------------------------------------------------- set-up

void Decoder::initial_setup() {
    if (height_ > 65500 || width_ > 65500)
        throw Error("image too big (libjpeg's limit is 65500 pixels)");
    if (precision_ != 8)
        throw Error(std::to_string(precision_) + "-bit samples (Pillow "
                    "reads 8-bit JPEGs only)");
    hmax_ = vmax_ = 1;
    for (int i = 0; i < ncomp_; ++i) {
        Component& c = comp_[i];
        if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
            throw Error("corrupt data: bad sampling factors");
        hmax_ = std::max(hmax_, c.h);
        vmax_ = std::max(vmax_, c.v);
    }
    const int unit = lossless_ ? 1 : 8;
    mcux_ = (width_ + unit * hmax_ - 1) / (unit * hmax_);
    mcuy_ = (height_ + unit * vmax_ - 1) / (unit * vmax_);
    imcu_rows_ = mcuy_;
    for (int i = 0; i < ncomp_; ++i) {
        Component& c = comp_[i];
        c.dw = static_cast<int>(
            (static_cast<int64_t>(width_) * c.h + hmax_ - 1) / hmax_);
        c.dh = static_cast<int>(
            (static_cast<int64_t>(height_) * c.v + vmax_ - 1) / vmax_);
        c.bw = (c.dw + unit - 1) / unit;
        c.bh = (c.dh + unit - 1) / unit;
        c.bwp = mcux_ * c.h;
        c.bhp = mcuy_ * c.v;
        if (lossless_) {
            c.sample.assign(static_cast<size_t>(c.bwp) * c.bhp, 0);
            c.plane.assign(static_cast<size_t>(c.bwp) * c.bhp, 0);
        } else {
            c.coef.assign(static_cast<size_t>(c.bwp) * c.bhp * 64, 0);
        }
        for (int k = 0; k < 64; ++k) c.coef_bits[k] = c.prev_bits[k] = -1;
    }
    multiple_scans_ = ns_ < ncomp_ || progressive_;
}

void Decoder::master_selection() {
    if (lossless_ && arith_)
        throw Error("arithmetic-coded lossless JPEG (SOF11: libjpeg-turbo "
                    "does not read it)");
    if (lossless_ && ycc_())  // jdcolor.c converts no lossless colors
        throw Error("a lossless JPEG in YCbCr or YCCK (libjpeg-turbo does "
                    "not convert a lossless frame's colors)");
    for (int i = 0; i < ncomp_; ++i)
        if (hmax_ % comp_[i].h || vmax_ % comp_[i].v)
            throw Error("sampling factors whose ratios are not integral "
                        "(not supported by libjpeg)");
    if (!progressive_ && !arith_ && !lossless_) {  // std_huff_tables
        for (int t = 0; t < 2; ++t) {
            if (!dc_spec_[t].defined)
                std_table(dc_spec_[t], kStdDcCounts[t], kStdDcVals, 12);
            if (!ac_spec_[t].defined)
                std_table(ac_spec_[t], kStdAcCounts[t], kStdAcVals[t], 162);
        }
    }
}

void Decoder::start_scan() {
    // per_scan_setup
    if (ns_ > 1) {
        blocks_in_mcu_ = 0;
        for (int i = 0; i < ns_; ++i) {
            blocks_in_mcu_ += sc_[i]->h * sc_[i]->v;
            if (blocks_in_mcu_ > 10)
                throw Error("corrupt data: more than 10 blocks in an MCU");
        }
    } else {
        blocks_in_mcu_ = 1;
    }
    if (!lossless_) {  // latch_quant_tables
        for (int i = 0; i < ns_; ++i) {
            Component& c = *sc_[i];
            if (c.latched) continue;
            if (c.tq >= 4 || !qdef_[c.tq])
                throw Error("corrupt data: quantization table " +
                            std::to_string(c.tq) + " was not defined");
            std::memcpy(c.q, qt_[c.tq], sizeof(c.q));
            c.latched = true;
        }
    }
    if (progressive_) {
        // jdphuff.c / jdarith.c: the scan's parameters, then the
        // progression status (inconsistencies are warnings)
        bool bad = false;
        if (ss_ == 0) {
            if (se_ != 0) bad = true;
        } else {
            if (ss_ > se_ || se_ > 63 || ns_ != 1) bad = true;
        }
        if (ah_ != 0 && al_ != ah_ - 1) bad = true;
        if (al_ > 13) bad = true;
        if (bad) throw Error("corrupt data: bad progressive scan "
                             "parameters");
        for (int i = 0; i < ns_; ++i) {
            Component& c = *sc_[i];
            for (int k = std::min(ss_, 1); k <= std::max(se_, 9); ++k)
                c.prev_bits[k] = input_scan_ > 1 ? c.coef_bits[k] : 0;
            for (int k = ss_; k <= se_; ++k) c.coef_bits[k] = al_;
        }
    }
    if (lossless_) {
        if (ss_ < 1 || ss_ > 7 || se_ != 0 || ah_ != 0 || al_ >= precision_)
            throw Error("corrupt data: bad lossless scan parameters");
        const int mcus_per_row = ns_ == 1 ? sc_[0]->bw : mcux_;
        if (restart_interval_ % mcus_per_row)
            throw Error("corrupt data: a restart interval that is not a "
                        "whole number of MCU rows (lossless)");
        restart_rows_to_go_ = restart_interval_ / mcus_per_row;
        for (int i = 0; i < 4; ++i) first_row_[i] = true;
    }
    if (arith_) {
        for (int i = 0; i < ns_; ++i) {
            Component& c = *sc_[i];
            if (!progressive_ || (ss_ == 0 && ah_ == 0)) {
                std::memset(dc_stats_[c.dc_tbl], 0, kDcStatBins);
                last_dc_[i] = 0;
                dc_context_[i] = 0;
            }
            if (!progressive_ || ss_)
                std::memset(ac_stats_[c.ac_tbl], 0, kAcStatBins);
        }
        ac_c_ = 0;
        ac_a_ = 0;
        ac_ct_ = -16;
    } else {
        for (int i = 0; i < ns_; ++i) {
            Component& c = *sc_[i];
            Derived& dct = dc_tbl_[c.dc_tbl & 3];
            Derived& act = ac_tbl_[c.ac_tbl & 3];
            if (lossless_) {
                make_derived(dct, dc_spec_, c.dc_tbl, true, 16);
            } else if (!progressive_) {
                make_derived(dct, dc_spec_, c.dc_tbl, true, 15);
                make_derived(act, ac_spec_, c.ac_tbl, false, 0);
            } else if (ss_ == 0) {
                if (ah_ == 0)  // DC refinement needs no table
                    make_derived(dct, dc_spec_, c.dc_tbl, true, 15);
            } else {
                make_derived(act, ac_spec_, c.ac_tbl, false, 0);
            }
            last_dc_[i] = 0;
        }
        bits_.buf = 0;
        bits_.left = 0;
        eobrun_ = 0;
    }
    insufficient_ = false;
    restarts_to_go_ = restart_interval_;
}

void Decoder::decode() {
    // jpeg_read_header: the markers up to the first scan (Pillow reads
    // the header again after a tables-only stream)
    for (;;) {
        if (read_markers() == kReachedSOS) break;
        if (saw_sof_) throw Error("corrupt data: a frame without a scan");
        saw_soi_ = false;
    }
    initial_setup();
    master_selection();
    start_scan();
    if (multiple_scans_) {
        // jpeg_start_decompress reads the whole file first
        for (;;) {
            decode_scan();
            if (read_markers() == kReachedEOI) break;
            start_scan();
        }
        return;
    }
    decode_scan();
    // jpeg_finish_decompress: markers up to EOI; Pillow stops where
    // libjpeg waits for more data, the rows being complete
    finishing_ = true;
    try {
        if (read_markers() == kReachedSOS)
            throw Error("corrupt data: a second scan in a single-scan file");
    } catch (const Done&) {
    }
}

// ------------------------------------------------------ entropy decoding

void Decoder::decode_scan() {
    if (lossless_) {
        decode_lossless_scan();
        return;
    }
    no_suspend_ = arith_;
    const bool single = ns_ == 1;
    const int per_row = single ? sc_[0]->bw : mcux_;
    int16_t* blocks[10];
    for (int r = 0; r < imcu_rows_; ++r) {
        int mcu_rows = 1;
        if (single) {
            Component& c = *sc_[0];
            int rem = c.bh % c.v;
            mcu_rows = r < imcu_rows_ - 1 ? c.v : (rem ? rem : c.v);
        }
        for (int y = 0; y < mcu_rows; ++y) {
            for (int col = 0; col < per_row; ++col) {
                int n = 0;
                if (single) {
                    blocks[n++] = sc_[0]->block(r * sc_[0]->v + y, col);
                } else {
                    for (int i = 0; i < ns_; ++i) {
                        Component& c = *sc_[i];
                        for (int by = 0; by < c.v; ++by)
                            for (int bx = 0; bx < c.h; ++bx)
                                blocks[n++] = c.block(r * c.v + by,
                                                      col * c.h + bx);
                    }
                }
                if (!insufficient_) last_good_row_ = r;
                for (;;) {
                    if (!multiple_scans_)  // decompress_onepass zeroes them
                        for (int k = 0; k < n; ++k)
                            std::memset(blocks[k], 0, 64 * sizeof(int16_t));
                    try {
                        if (arith_) arith_mcu(blocks);
                        else decode_mcu(blocks);
                        break;
                    } catch (const Suspend&) {
                        need_more();
                    }
                }
            }
        }
    }
    no_suspend_ = false;
}

void Decoder::process_restart_huff() {
    bits_.left = 0;
    read_restart_marker();
    for (int i = 0; i < ns_; ++i) last_dc_[i] = 0;
    eobrun_ = 0;
    restarts_to_go_ = restart_interval_;
    if (unread_ == 0) insufficient_ = false;
}

void Decoder::decode_mcu(int16_t** blocks) {
    bool usefast = !progressive_;
    if (restart_interval_) {
        if (restarts_to_go_ == 0) process_restart_huff();
        usefast = false;
    }
    if (end_ < pos_ + 512 * static_cast<size_t>(blocks_in_mcu_) || unread_)
        usefast = false;
    if (!progressive_) {
        if (!insufficient_ && !(usefast && mcu_seq_fast(blocks)))
            mcu_seq_slow(blocks);
    } else if (ss_ == 0) {
        if (ah_ == 0) mcu_dc_first(blocks);
        else mcu_dc_refine(blocks);
    } else {
        if (ah_ == 0) mcu_ac_first(blocks);
        else mcu_ac_refine(blocks);
    }
    if (restart_interval_) --restarts_to_go_;
}

// jpeg_fill_bit_buffer: load to MIN_GET_BITS bits, stopping at a marker;
// past one, zero bits stand in for what a decode needs (the segment is
// then out of data)
void Decoder::fill(Bits& b, int nbits) {
    if (unread_ == 0) {
        while (b.left < kMinGetBits) {
            if (b.pos >= end_) throw Suspend();
            int c = p_[b.pos++];
            if (c == 0xFF) {
                do {
                    if (b.pos >= end_) throw Suspend();
                    c = p_[b.pos++];
                } while (c == 0xFF);
                if (c == 0) {
                    c = 0xFF;
                } else {
                    unread_ = c;
                    goto no_more;
                }
            }
            b.buf = (b.buf << 8) | static_cast<unsigned>(c);
            b.left += 8;
        }
        return;
    }
no_more:
    if (nbits > b.left) {
        insufficient_ = true;
        b.buf <<= kMinGetBits - b.left;
        b.left = kMinGetBits;
    }
}

int Decoder::huff_decode_slow(Bits& b, const Derived& t, int l) {
    // jpeg_huff_decode: a code longer than 16 bits is read as symbol 0
    int64_t code = check_get(b, l);
    while (code > t.maxcode[l]) {
        code = (code << 1) | check_get(b, 1);
        ++l;
    }
    if (l > 16) return 0;
    return t.vals[(code + t.valoffset[l]) & 0xFF];
}

int Decoder::huff_decode(Bits& b, const Derived& t) {  // HUFF_DECODE
    if (b.left < kLook) {
        fill(b, 0);
        if (b.left < kLook) return huff_decode_slow(b, t, 1);
    }
    int e = t.lookup[peek(b, kLook)];
    int nb = e >> kLook;
    if (nb <= kLook) {
        b.left -= nb;
        return e & 0xFF;
    }
    return huff_decode_slow(b, t, nb);
}

// decode_mcu_fast: a bit buffer refilled six bytes at a time, with a
// marker read as zero bytes; an MCU that met a marker is decoded again
// by the slow path
bool Decoder::mcu_seq_fast(int16_t** blocks) {
    uint64_t buf = bits_.buf;
    int left = bits_.left;
    size_t q = pos_;
    int dc[4];
    std::memcpy(dc, last_dc_, sizeof(dc));
    auto fill_fast = [&]() {
        if (left <= 16) {
            for (int i = 0; i < 6; ++i) {
                int c0 = p_[q++], c1 = p_[q];
                buf = (buf << 8) | static_cast<unsigned>(c0);
                left += 8;
                if (c0 == 0xFF) {
                    ++q;
                    if (c1 != 0) {
                        unread_ = c1;
                        q -= 2;
                        buf &= ~uint64_t(0xFF);
                    }
                }
            }
        }
    };
    auto getb = [&](int n) {
        left -= n;
        return static_cast<int>(buf >> left) & ((1 << n) - 1);
    };
    auto decode_fast = [&](const Derived& t) {
        fill_fast();
        int s = t.lookup[static_cast<int>(buf >> (left - kLook)) & 0xFF];
        int nb = s >> kLook;
        left -= nb;
        s &= 0xFF;
        if (nb > kLook) {
            int64_t code = static_cast<int64_t>(buf >> left) &
                           ((int64_t(1) << nb) - 1);
            while (code > t.maxcode[nb]) {
                code = (code << 1) | getb(1);
                ++nb;
            }
            s = nb > 16 ? 0 : t.vals[(code + t.valoffset[nb]) & 0xFF];
        }
        return s;
    };
    int blkn = 0;
    for (int i = 0; i < ns_; ++i) {
        Component& c = *sc_[i];
        const int nblk = ns_ == 1 ? 1 : c.h * c.v;
        const Derived& dct = dc_tbl_[c.dc_tbl];
        const Derived& act = ac_tbl_[c.ac_tbl];
        for (int k0 = 0; k0 < nblk; ++k0, ++blkn) {
            int16_t* b = blocks[blkn];
            int s = decode_fast(dct);
            if (s) {
                fill_fast();
                s = huff_extend(getb(s), s);
            }
            dc[i] = static_cast<int>(static_cast<unsigned>(dc[i]) +
                                     static_cast<unsigned>(s));
            b[0] = static_cast<int16_t>(dc[i]);
            for (int k = 1; k < 64; ++k) {
                s = decode_fast(act);
                int r = s >> 4;
                s &= 15;
                if (s) {
                    k += r;
                    fill_fast();
                    b[kNatural[k]] = static_cast<int16_t>(
                        huff_extend(getb(s), s));
                } else {
                    if (r != 15) break;
                    k += 15;
                }
            }
        }
    }
    if (unread_ != 0) {
        unread_ = 0;
        return false;
    }
    bits_.buf = buf;
    bits_.left = left;
    pos_ = q;
    std::memcpy(last_dc_, dc, sizeof(dc));
    return true;
}

void Decoder::mcu_seq_slow(int16_t** blocks) {
    Bits b = bits_;
    b.pos = pos_;
    int dc[4];
    std::memcpy(dc, last_dc_, sizeof(dc));
    int blkn = 0;
    for (int i = 0; i < ns_; ++i) {
        Component& c = *sc_[i];
        const int nblk = ns_ == 1 ? 1 : c.h * c.v;
        const Derived& dct = dc_tbl_[c.dc_tbl];
        const Derived& act = ac_tbl_[c.ac_tbl];
        for (int k0 = 0; k0 < nblk; ++k0, ++blkn) {
            int16_t* blk = blocks[blkn];
            int s = huff_decode(b, dct);
            if (s) s = huff_extend(check_get(b, s), s);
            dc[i] = static_cast<int>(static_cast<unsigned>(dc[i]) +
                                     static_cast<unsigned>(s));
            blk[0] = static_cast<int16_t>(dc[i]);
            for (int k = 1; k < 64; ++k) {
                s = huff_decode(b, act);
                int r = s >> 4;
                s &= 15;
                if (s) {
                    k += r;
                    blk[kNatural[k]] = static_cast<int16_t>(
                        huff_extend(check_get(b, s), s));
                } else {
                    if (r != 15) break;
                    k += 15;
                }
            }
        }
    }
    bits_ = b;
    pos_ = b.pos;
    std::memcpy(last_dc_, dc, sizeof(dc));
}

void Decoder::mcu_dc_first(int16_t** blocks) {
    if (insufficient_) return;
    Bits b = bits_;
    b.pos = pos_;
    int dc[4];
    std::memcpy(dc, last_dc_, sizeof(dc));
    int blkn = 0;
    for (int i = 0; i < ns_; ++i) {
        Component& c = *sc_[i];
        const int nblk = ns_ == 1 ? 1 : c.h * c.v;
        for (int k0 = 0; k0 < nblk; ++k0, ++blkn) {
            int s = huff_decode(b, dc_tbl_[c.dc_tbl]);
            if (s) s = huff_extend(check_get(b, s), s);
            dc[i] = static_cast<int>(static_cast<unsigned>(dc[i]) +
                                     static_cast<unsigned>(s));
            blocks[blkn][0] = static_cast<int16_t>(
                static_cast<unsigned>(dc[i]) << al_);
        }
    }
    bits_ = b;
    pos_ = b.pos;
    std::memcpy(last_dc_, dc, sizeof(dc));
}

void Decoder::mcu_dc_refine(int16_t** blocks) {
    // no check of the out-of-data flag: zero bits change nothing
    Bits b = bits_;
    b.pos = pos_;
    const int p1 = 1 << al_;
    for (int k = 0; k < blocks_in_mcu_; ++k)
        if (check_get(b, 1)) blocks[k][0] = static_cast<int16_t>(
            blocks[k][0] | p1);
    bits_ = b;
    pos_ = b.pos;
}

void Decoder::mcu_ac_first(int16_t** blocks) {
    if (insufficient_) return;
    unsigned eob = eobrun_;
    if (eob > 0) {
        eobrun_ = eob - 1;
        return;
    }
    Bits b = bits_;
    b.pos = pos_;
    int16_t* blk = blocks[0];
    const Derived& t = ac_tbl_[sc_[0]->ac_tbl];
    for (int k = ss_; k <= se_; ++k) {
        int s = huff_decode(b, t);
        int r = s >> 4;
        s &= 15;
        if (s) {
            k += r;
            int v = huff_extend(check_get(b, s), s);
            blk[kNatural[k]] = static_cast<int16_t>(
                static_cast<unsigned>(v) << al_);
        } else if (r == 15) {
            k += 15;
        } else {
            eob = 1u << r;
            if (r) eob += static_cast<unsigned>(check_get(b, r));
            --eob;
            break;
        }
    }
    bits_ = b;
    pos_ = b.pos;
    eobrun_ = eob;
}

void Decoder::mcu_ac_refine(int16_t** blocks) {
    if (insufficient_) return;
    Bits b = bits_;
    b.pos = pos_;
    unsigned eob = eobrun_;
    int16_t* blk = blocks[0];
    const Derived& t = ac_tbl_[sc_[0]->ac_tbl];
    const int p1 = 1 << al_;
    const int m1 = -1 * (1 << al_);
    int newnz[64], nnew = 0;
    int k = ss_;
    try {
        if (eob == 0) {
            for (; k <= se_; ++k) {
                int s = huff_decode(b, t);
                int r = s >> 4;
                s &= 15;
                if (s) {
                    // a newly nonzero coefficient has size 1 (libjpeg
                    // warns on others and reads one sign bit all the same)
                    s = check_get(b, 1) ? p1 : m1;
                } else if (r != 15) {
                    eob = 1u << r;
                    if (r) eob += static_cast<unsigned>(check_get(b, r));
                    break;
                }
                do {
                    int16_t* c = blk + kNatural[k];
                    if (*c != 0) {
                        if (check_get(b, 1) && (*c & p1) == 0)
                            *c = static_cast<int16_t>(*c + (*c >= 0 ? p1
                                                                    : m1));
                    } else if (--r < 0) {
                        break;
                    }
                    ++k;
                } while (k <= se_);
                if (s) {
                    int pos = kNatural[k];
                    blk[pos] = static_cast<int16_t>(s);
                    newnz[nnew++] = pos;
                }
            }
        }
        if (eob > 0) {
            for (; k <= se_; ++k) {
                int16_t* c = blk + kNatural[k];
                if (*c != 0 && check_get(b, 1) && (*c & p1) == 0)
                    *c = static_cast<int16_t>(*c + (*c >= 0 ? p1 : m1));
            }
            --eob;
        }
    } catch (const Suspend&) {
        while (nnew > 0) blk[newnz[--nnew]] = 0;  // undo the new ones
        throw;
    }
    bits_ = b;
    pos_ = b.pos;
    eobrun_ = eob;
}

// ---- arithmetic (jdarith.c)

int Decoder::arith_decode(uint8_t* st) {
    while (ac_a_ < 0x8000) {
        if (--ac_ct_ < 0) {
            int data;
            if (unread_) {
                data = 0;  // past a marker the data is zeros
            } else {
                data = abyte();
                if (data == 0xFF) {
                    do {
                        data = abyte();
                    } while (data == 0xFF);
                    if (data == 0) {
                        data = 0xFF;
                    } else {
                        unread_ = data;
                        data = 0;
                    }
                }
            }
            ac_c_ = (ac_c_ << 8) | data;
            if ((ac_ct_ += 8) < 0)
                if (++ac_ct_ == 0) ac_a_ = 0x8000;
        }
        ac_a_ <<= 1;
    }
    int sv = *st;
    int64_t qe = kAriTab[sv & 0x7F];
    const uint8_t nl = static_cast<uint8_t>(qe & 0xFF);
    qe >>= 8;
    const uint8_t nm = static_cast<uint8_t>(qe & 0xFF);
    qe >>= 8;
    int64_t temp = ac_a_ - qe;
    ac_a_ = temp;
    temp <<= ac_ct_;
    if (ac_c_ >= temp) {
        ac_c_ -= temp;
        if (ac_a_ < qe) {
            ac_a_ = qe;
            *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
        } else {
            ac_a_ = qe;
            *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
            sv ^= 0x80;
        }
    } else if (ac_a_ < 0x8000) {
        if (ac_a_ < qe) {
            *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
            sv ^= 0x80;
        } else {
            *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
        }
    }
    return sv >> 7;
}

void Decoder::arith_process_restart() {
    read_restart_marker();
    for (int i = 0; i < ns_; ++i) {
        Component& c = *sc_[i];
        if (!progressive_ || (ss_ == 0 && ah_ == 0)) {
            std::memset(dc_stats_[c.dc_tbl], 0, kDcStatBins);
            last_dc_[i] = 0;
            dc_context_[i] = 0;
        }
        if (!progressive_ || ss_)
            std::memset(ac_stats_[c.ac_tbl], 0, kAcStatBins);
    }
    ac_c_ = 0;
    ac_a_ = 0;
    ac_ct_ = -16;
    restarts_to_go_ = restart_interval_;
}

// Figures F.19-F.24 for a DC difference: its value (0 for none);
// ``overflow`` when the magnitude category overflows
int Decoder::arith_dc_diff(int ci, int tbl, bool& overflow) {
    uint8_t* st = dc_stats_[tbl] + dc_context_[ci];
    if (arith_decode(st) == 0) {
        dc_context_[ci] = 0;
        return 0;
    }
    int sign = arith_decode(st + 1);
    st += 2 + sign;
    int m = arith_decode(st);
    if (m != 0) {
        st = dc_stats_[tbl] + 20;
        while (arith_decode(st)) {
            if ((m <<= 1) == 0x8000) {
                overflow = true;
                return 0;
            }
            st += 1;
        }
    }
    if (m < static_cast<int>((1L << arith_l_[tbl]) >> 1))
        dc_context_[ci] = 0;
    else if (m > static_cast<int>((1L << arith_u_[tbl]) >> 1))
        dc_context_[ci] = 12 + sign * 4;
    else
        dc_context_[ci] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
        if (arith_decode(st)) v |= m;
    v += 1;
    return sign ? -v : v;
}

// an AC value once its nonzero flag is read (``st`` at that bin)
void Decoder::arith_ac_value(int tbl, int k, uint8_t* st, int& v,
                             bool& overflow) {
    int sign = arith_decode(fixed_bin_);
    st += 2;
    int m = arith_decode(st);
    if (m != 0) {
        if (arith_decode(st)) {
            m <<= 1;
            st = ac_stats_[tbl] + (k <= arith_k_[tbl] ? 189 : 217);
            while (arith_decode(st)) {
                if ((m <<= 1) == 0x8000) {
                    overflow = true;
                    return;
                }
                st += 1;
            }
        }
    }
    v = m;
    st += 14;
    while (m >>= 1)
        if (arith_decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
}

void Decoder::arith_mcu(int16_t** blocks) {
    if (restart_interval_) {
        if (restarts_to_go_ == 0) arith_process_restart();
        --restarts_to_go_;
    }
    const bool dc_refine = progressive_ && ss_ == 0 && ah_ != 0;
    if (ac_ct_ == -1 && !dc_refine) return;  // stopped by an overflow
    bool overflow = false;
    if (dc_refine) {
        const int p1 = 1 << al_;
        for (int k = 0; k < blocks_in_mcu_; ++k)
            if (arith_decode(fixed_bin_)) blocks[k][0] = static_cast<int16_t>(
                blocks[k][0] | p1);
        return;
    }
    if (!progressive_ || ss_ == 0) {  // sequential, or DC first
        int blkn = 0;
        for (int i = 0; i < ns_; ++i) {
            Component& c = *sc_[i];
            const int nblk = ns_ == 1 ? 1 : c.h * c.v;
            for (int k0 = 0; k0 < nblk; ++k0, ++blkn) {
                int16_t* b = blocks[blkn];
                int v = arith_dc_diff(i, c.dc_tbl, overflow);
                if (overflow) {
                    ac_ct_ = -1;
                    return;
                }
                if (progressive_) {
                    last_dc_[i] += v;
                    b[0] = static_cast<int16_t>(
                        static_cast<unsigned>(last_dc_[i]) << al_);
                    continue;
                }
                if (v) last_dc_[i] = (last_dc_[i] + v) & 0xFFFF;
                b[0] = static_cast<int16_t>(last_dc_[i]);
                const int tbl = c.ac_tbl;
                for (int k = 1; k <= 63; ++k) {
                    uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
                    if (arith_decode(st)) break;  // EOB
                    while (arith_decode(st + 1) == 0) {
                        st += 3;
                        ++k;
                        if (k > 63) {
                            ac_ct_ = -1;  // spectral overflow
                            return;
                        }
                    }
                    int val = 0;
                    arith_ac_value(tbl, k, st, val, overflow);
                    if (overflow) {
                        ac_ct_ = -1;
                        return;
                    }
                    b[kNatural[k]] = static_cast<int16_t>(val);
                }
            }
        }
        return;
    }
    int16_t* b = blocks[0];
    const int tbl = sc_[0]->ac_tbl;
    if (ah_ == 0) {  // AC first
        for (int k = ss_; k <= se_; ++k) {
            uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
            if (arith_decode(st)) break;
            while (arith_decode(st + 1) == 0) {
                st += 3;
                ++k;
                if (k > se_) {
                    ac_ct_ = -1;
                    return;
                }
            }
            int val = 0;
            arith_ac_value(tbl, k, st, val, overflow);
            if (overflow) {
                ac_ct_ = -1;
                return;
            }
            b[kNatural[k]] = static_cast<int16_t>(
                static_cast<unsigned>(val) << al_);
        }
        return;
    }
    // AC refinement
    const int p1 = 1 << al_;
    const int m1 = static_cast<int>(static_cast<unsigned>(-1) << al_);
    int kex = se_;
    for (; kex > 0; --kex)
        if (b[kNatural[kex]]) break;
    for (int k = ss_; k <= se_; ++k) {
        uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
        if (k > kex)
            if (arith_decode(st)) break;
        for (;;) {
            int16_t* c = b + kNatural[k];
            if (*c) {
                if (arith_decode(st + 2))
                    *c = static_cast<int16_t>(*c + (*c < 0 ? m1 : p1));
                break;
            }
            if (arith_decode(st + 1)) {
                *c = static_cast<int16_t>(arith_decode(fixed_bin_) ? m1 : p1);
                break;
            }
            st += 3;
            ++k;
            if (k > se_) {
                ac_ct_ = -1;
                return;
            }
        }
    }
}

// ---- lossless (jddiffct.c, jdlhuff.c, jdlossls.c)

void Decoder::undifference(Component& c, int row, int prev_row, int ci) {
    // jdlossls.c: the first row of a scan or restart interval predicts
    // from the row's left neighbour (its first sample from 1 << (P-Pt-1)),
    // later rows from the selected predictor (their first sample from
    // the one above); samples are kept mod 2^16, then shifted by Pt
    uint16_t* cur = c.sample.data() + static_cast<size_t>(row) * c.bwp;
    const uint16_t* up = c.sample.data() + static_cast<size_t>(prev_row) *
                         c.bwp;
    const int w = c.bw;
    // the differences were stored in cur; up holds undifferenced values
    // (the samples before the point transform's shift)
    if (first_row_[ci]) {
        int ra = (static_cast<int16_t>(cur[0]) + (1 << (precision_ - al_ - 1)))
                 & 0xFFFF;
        cur[0] = static_cast<uint16_t>(ra);
        for (int x = 1; x < w; ++x) {
            ra = (static_cast<int16_t>(cur[x]) + ra) & 0xFFFF;
            cur[x] = static_cast<uint16_t>(ra);
        }
        first_row_[ci] = false;
    } else {
        int rb = up[0];
        int ra = (static_cast<int16_t>(cur[0]) + rb) & 0xFFFF;
        cur[0] = static_cast<uint16_t>(ra);
        for (int x = 1; x < w; ++x) {
            int rc = rb;
            rb = up[x];
            int pred;
            switch (ss_) {
                case 1: pred = ra; break;
                case 2: pred = rb; break;
                case 3: pred = rc; break;
                case 4: pred = ra + rb - rc; break;
                case 5: pred = ra + ((rb - rc) >> 1); break;
                case 6: pred = rb + ((ra - rc) >> 1); break;
                default: pred = (ra + rb) >> 1; break;
            }
            ra = (static_cast<int16_t>(cur[x]) + pred) & 0xFFFF;
            cur[x] = static_cast<uint16_t>(ra);
        }
    }
    uint8_t* o = c.plane.data() + static_cast<size_t>(row) * c.bwp;
    for (int x = 0; x < w; ++x)
        o[x] = static_cast<uint8_t>(cur[x] << al_);
}

void Decoder::decode_lossless_scan() {
    // differences are stored (as int16 bit patterns) in the sample
    // arrays, then undifferenced in place one iMCU row at a time
    const bool single = ns_ == 1;
    const int per_row = single ? sc_[0]->bw : mcux_;
    for (int r = 0; r < imcu_rows_; ++r) {
        int mcu_rows = 1;
        if (single) {
            Component& c = *sc_[0];
            int rem = c.bh % c.v;
            mcu_rows = r < imcu_rows_ - 1 ? c.v : (rem ? rem : c.v);
        }
        for (int y = 0; y < mcu_rows; ++y) {
            if (restart_interval_) {
                if (restart_rows_to_go_ == 0) {
                    bits_.left = 0;
                    read_restart_marker();
                    if (unread_ == 0) insufficient_ = false;
                    for (int i = 0; i < 4; ++i) first_row_[i] = true;
                    restart_rows_to_go_ = restart_interval_ / per_row;
                }
            }
            if (insufficient_) {
                // out of data: zero differences, the predictors reset
                for (int col = 0; col < per_row; ++col)
                    for (int i = 0; i < ns_; ++i) {
                        Component& c = *sc_[i];
                        const int hh = single ? 1 : c.h, vv = single ? 1 : c.v;
                        for (int by = 0; by < vv; ++by)
                            for (int bx = 0; bx < hh; ++bx) {
                                int row = single ? r * c.v + y : r * c.v + by;
                                int cx = single ? col : col * c.h + bx;
                                c.sample[static_cast<size_t>(row) * c.bwp +
                                         cx] = 0;
                            }
                    }
                for (int i = 0; i < 4; ++i) first_row_[i] = true;
            } else {
                for (int col = 0; col < per_row; ++col) {
                    for (;;) {
                        Bits b = bits_;
                        b.pos = pos_;
                        try {
                            for (int i = 0; i < ns_; ++i) {
                                Component& c = *sc_[i];
                                const Derived& t = dc_tbl_[c.dc_tbl];
                                const int hh = single ? 1 : c.h;
                                const int vv = single ? 1 : c.v;
                                for (int by = 0; by < vv; ++by)
                                    for (int bx = 0; bx < hh; ++bx) {
                                        int s = huff_decode(b, t);
                                        if (s == 16) s = 32768;
                                        else if (s)
                                            s = huff_extend(check_get(b, s),
                                                            s);
                                        int row = single ? r * c.v + y
                                                         : r * c.v + by;
                                        int cx = single ? col
                                                        : col * c.h + bx;
                                        c.sample[static_cast<size_t>(row) *
                                                     c.bwp + cx] =
                                            static_cast<uint16_t>(s);
                                    }
                            }
                            bits_ = b;
                            pos_ = b.pos;
                            break;
                        } catch (const Suspend&) {
                            need_more();
                        }
                    }
                }
            }
            if (restart_interval_) --restart_rows_to_go_;
        }
        // undifference the iMCU row's real rows of each component
        for (int i = 0; i < ns_; ++i) {
            Component& c = *sc_[i];
            int rem = c.bh - r * c.v;
            int nrows = std::min(c.v, rem);
            for (int row = 0; row < nrows; ++row) {
                int abs_row = r * c.v + row;
                undifference(c, abs_row, abs_row > 0 ? abs_row - 1 : 0,
                             static_cast<int>(&c - comp_));
            }
        }
    }
}

// ------------------------------------------------------------- pixels

// jpeg_idct_islow as libjpeg-turbo's x86 SIMD code computes it
// (jidctint-sse2.asm and -avx2.asm, which Pillow's x86-64 builds run):
// jidctint.c's 13-bit constants and 2 bits of pass-1 scaling, with the
// coefficients dequantized in 16 bits (pmullw), the sums in0 +- in4,
// in3 + in7 and in1 + in5 taken in 16 bits, each pass's outputs packed
// to 16 bits with saturation, and the samples saturated to 8 bits
// (packsswb) before the +128; a block whose rows 1-7 are all zero skips
// the column pass as (dc * q) << 2 in 16 bits.  For coefficients a
// valid stream gives, this is the C code's result exactly; a damaged one
// gives others.
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t kF0298 = 2446, kF0390 = 3196, kF0541 = 4433,
                  kF0765 = 6270, kF0899 = 7373, kF1175 = 9633,
                  kF1501 = 12299, kF1847 = 15137, kF1961 = 16069,
                  kF2053 = 16819, kF2562 = 20995, kF3072 = 25172;

inline int32_t w16(int32_t x) {  // a 16-bit lane's wrap
    return static_cast<int16_t>(static_cast<uint16_t>(x));
}
inline int32_t sat16(int32_t x) {
    return x < -32768 ? -32768 : (x > 32767 ? 32767 : x);
}

// one 1-D pass over in[0..7] (16-bit lanes) into 32-bit out[0..7],
// before the descale
inline void idct_1d(const int32_t* in, int32_t* out) {
    const int32_t z2 = in[2], z3 = in[6];
    const int32_t tmp3 = z2 * (kF0541 + kF0765) + z3 * kF0541;
    const int32_t tmp2 = z2 * kF0541 + z3 * (kF0541 - kF1847);
    const int32_t tmp0 = w16(in[0] + in[4]) * (1 << kConstBits);
    const int32_t tmp1 = w16(in[0] - in[4]) * (1 << kConstBits);
    const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    const int32_t i1 = in[1], i3 = in[3], i5 = in[5], i7 = in[7];
    const int32_t oz3 = w16(i7 + i3), oz4 = w16(i5 + i1);
    const int32_t z3p = oz3 * (kF1175 - kF1961) + oz4 * kF1175;
    const int32_t z4p = oz3 * kF1175 + oz4 * (kF1175 - kF0390);
    const int32_t t0 = i7 * (kF0298 - kF0899) + i1 * -kF0899 + z3p;
    const int32_t t3 = i7 * -kF0899 + i1 * (kF1501 - kF0899) + z4p;
    const int32_t t1 = i5 * (kF2053 - kF2562) + i3 * -kF2562 + z4p;
    const int32_t t2 = i5 * -kF2562 + i3 * (kF3072 - kF2562) + z3p;
    out[0] = tmp10 + t3;
    out[7] = tmp10 - t3;
    out[1] = tmp11 + t2;
    out[6] = tmp11 - t2;
    out[2] = tmp12 + t1;
    out[5] = tmp12 - t1;
    out[3] = tmp13 + t0;
    out[4] = tmp13 - t0;
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
    int32_t ws[64];  // the 16-bit workspace, column-major per row
    bool ac_zero = true;
    for (int k = 8; k < 64; ++k)
        if (in[k]) {
            ac_zero = false;
            break;
        }
    int32_t col[8], res[8];
    if (ac_zero) {
        for (int c = 0; c < 8; ++c) {
            const int32_t v = w16(w16(in[c] * q[c]) * (1 << kPass1Bits));
            for (int r = 0; r < 8; ++r) ws[8 * r + c] = v;
        }
    } else {
        for (int c = 0; c < 8; ++c) {
            for (int r = 0; r < 8; ++r)
                col[r] = w16(in[8 * r + c] * q[8 * r + c]);
            idct_1d(col, res);
            for (int r = 0; r < 8; ++r)
                ws[8 * r + c] = sat16((res[r] + (1 << (kConstBits -
                    kPass1Bits - 1))) >> (kConstBits - kPass1Bits));
        }
    }
    constexpr int kP2 = kConstBits + kPass1Bits + 3;
    for (int r = 0; r < 8; ++r) {
        idct_1d(ws + 8 * r, res);
        uint8_t* o = out + static_cast<size_t>(r) * stride;
        for (int c = 0; c < 8; ++c) {
            int32_t v = sat16((res[c] + (1 << (kP2 - 1))) >> kP2);
            v = v < -128 ? -128 : (v > 127 ? 127 : v);
            o[c] = static_cast<uint8_t>(v + 128);
        }
    }
}

bool Decoder::smoothing_ok() {
    // jdcoefct.c's smoothing_ok at the output pass: every component has
    // its quantization table latched with nonzero DC and low AC entries
    // and a DC scan; smoothing is useful when some component's zigzag
    // coefficients 1-9 are not fully refined.  The bits are latched here
    // (and those before each coefficient's last scan, for the rows past
    // the last that had data)
    if (!progressive_) return false;
    static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int i = 0; i < ncomp_; ++i) {
        Component& c = comp_[i];
        if (!c.latched) return false;
        for (int k = 0; k < 10; ++k)
            if (c.q[kPos[k]] == 0) return false;
        if (c.coef_bits[0] < 0) return false;
        latch_[i][0] = c.coef_bits[0];
        for (int k = 1; k < 10; ++k) {
            prev_latch_[i][k] = input_scan_ > 1 ? c.prev_bits[k] : -1;
            latch_[i][k] = c.coef_bits[k];
            if (c.coef_bits[k] != 0) useful = true;
        }
    }
    return useful;
}

// the component's samples, bw*8 wide and bh*8 high
void Decoder::component_plane(int ci, bool smooth,
                              std::vector<uint8_t>& out) {
    Component& c = comp_[ci];
    if (smooth) {
        smooth_plane(ci, out);
        return;
    }
    const int stride = c.bw * 8;
    out.assign(static_cast<size_t>(stride) * c.bh * 8, 0);
    for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
            idct_islow(c.block(by, bx), c.q,
                       out.data() + static_cast<size_t>(by) * 8 * stride +
                           bx * 8,
                       stride);
}

// decompress_smooth_data: each block's unknown coefficients 1-9 (and
// with no AC known, its DC) estimated from the DC values of the 5x5
// blocks around it; its sliding registers and row choices are libjpeg's,
// edge cases included
void Decoder::smooth_plane(int ci, std::vector<uint8_t>& out) {
    Component& c = comp_[ci];
    const int stride = c.bw * 8;
    out.assign(static_cast<size_t>(stride) * c.bh * 8, 0);
    const int last_row = imcu_rows_ - 1;
    const int64_t Q00 = c.q[0], Q01 = c.q[1], Q10 = c.q[8], Q20 = c.q[16],
                  Q11 = c.q[9], Q02 = c.q[2];
    int16_t ws[64];
    for (int r = 0; r < imcu_rows_; ++r) {
        int block_rows;
        if (r < last_row) {
            block_rows = c.v;
        } else {
            block_rows = c.bh % c.v;
            if (block_rows == 0) block_rows = c.v;
        }
        const int* bits = r > last_good_row_ ? prev_latch_[ci] : latch_[ci];
        const bool change_dc =
            bits[1] == -1 && bits[2] == -1 && bits[3] == -1 &&
            bits[4] == -1 && bits[5] == -1 && bits[6] == -1 &&
            bits[7] == -1 && bits[8] == -1 && bits[9] == -1;
        int64_t Q03 = 0, Q12 = 0, Q21 = 0, Q30 = 0;
        if (change_dc) {
            Q03 = c.q[3];
            Q12 = c.q[10];
            Q21 = c.q[17];
            Q30 = c.q[24];
        }
        const int image_block_rows = block_rows * imcu_rows_;
        for (int br = 0; br < block_rows; ++br) {
            const int ibr = r * block_rows + br;
            const int row = r * c.v + br;
            const int prev = ibr > 0 ? row - 1 : row;
            const int pprev = ibr > 1 ? row - 2 : prev;
            const int next = ibr < image_block_rows - 1 ? row + 1 : row;
            const int nnext = ibr < image_block_rows - 2 ? row + 2 : next;
            auto dc = [&](int rr, int col) {
                return static_cast<int>(c.block(rr, col)[0]);
            };
            int DC01, DC02, DC03, DC04, DC05, DC06, DC07, DC08, DC09, DC10,
                DC11, DC12, DC13, DC14, DC15, DC16, DC17, DC18, DC19, DC20,
                DC21, DC22, DC23, DC24, DC25;
            DC01 = DC02 = DC03 = DC04 = DC05 = dc(pprev, 0);
            DC06 = DC07 = DC08 = DC09 = DC10 = dc(prev, 0);
            DC11 = DC12 = DC13 = DC14 = DC15 = dc(row, 0);
            DC16 = DC17 = DC18 = DC19 = DC20 = dc(next, 0);
            DC21 = DC22 = DC23 = DC24 = DC25 = dc(nnext, 0);
            const int last_col = c.bw - 1;
            for (int b = 0; b <= last_col; ++b) {
                std::memcpy(ws, c.block(row, b), sizeof(ws));
                if (b == 0 && b < last_col) {
                    DC04 = DC05 = dc(pprev, b + 1);
                    DC09 = DC10 = dc(prev, b + 1);
                    DC14 = DC15 = dc(row, b + 1);
                    DC19 = DC20 = dc(next, b + 1);
                    DC24 = DC25 = dc(nnext, b + 1);
                }
                if (b + 1 < last_col) {
                    DC05 = dc(pprev, b + 2);
                    DC10 = dc(prev, b + 2);
                    DC15 = dc(row, b + 2);
                    DC20 = dc(next, b + 2);
                    DC25 = dc(nnext, b + 2);
                }
                auto predict = [&](int al, int64_t qk, int64_t num) {
                    int pred;
                    if (num >= 0) {
                        pred = static_cast<int>(((qk << 7) + num) /
                                                (qk << 8));
                        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
                    } else {
                        pred = static_cast<int>(((qk << 7) - num) /
                                                (qk << 8));
                        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
                        pred = -pred;
                    }
                    return static_cast<int16_t>(pred);
                };
                int al;
                if ((al = bits[1]) != 0 && ws[1] == 0) {  // AC01
                    int64_t num = Q00 * (change_dc ?
                        (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 -
                         13 * DC09 + 3 * DC10 - 3 * DC11 + 38 * DC12 -
                         38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 -
                         13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25) :
                        (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
                    ws[1] = predict(al, Q01, num);
                }
                if ((al = bits[2]) != 0 && ws[8] == 0) {  // AC10
                    int64_t num = Q00 * (change_dc ?
                        (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 -
                         DC06 + 13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 +
                         DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 +
                         DC21 + 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25) :
                        (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
                    ws[8] = predict(al, Q10, num);
                }
                if ((al = bits[3]) != 0 && ws[16] == 0) {  // AC20
                    int64_t num = Q00 * (change_dc ?
                        (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 -
                         14 * DC13 - 5 * DC14 + 2 * DC17 + 7 * DC18 +
                         2 * DC19 + DC23) :
                        (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
                    ws[16] = predict(al, Q20, num);
                }
                if ((al = bits[4]) != 0 && ws[9] == 0) {  // AC11
                    int64_t num = Q00 * (change_dc ?
                        (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 +
                         9 * DC19 + DC21 - DC25) :
                        (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 +
                         DC22 - DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09));
                    ws[9] = predict(al, Q11, num);
                }
                if ((al = bits[5]) != 0 && ws[2] == 0) {  // AC02
                    int64_t num = Q00 * (change_dc ?
                        (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 -
                         14 * DC13 + 7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 +
                         2 * DC19) :
                        (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
                    ws[2] = predict(al, Q02, num);
                }
                if (change_dc) {
                    if ((al = bits[6]) != 0 && ws[3] == 0) {  // AC03
                        int64_t num = Q00 * (DC07 - DC09 + 2 * DC12 -
                                             2 * DC14 + DC17 - DC19);
                        ws[3] = predict(al, Q03, num);
                    }
                    if ((al = bits[7]) != 0 && ws[10] == 0) {  // AC12
                        int64_t num = Q00 * (DC07 - 3 * DC08 + DC09 - DC17 +
                                             3 * DC18 - DC19);
                        ws[10] = predict(al, Q12, num);
                    }
                    if ((al = bits[8]) != 0 && ws[17] == 0) {  // AC21
                        int64_t num = Q00 * (DC07 - DC09 - 3 * DC12 +
                                             3 * DC14 + DC17 - DC19);
                        ws[17] = predict(al, Q21, num);
                    }
                    if ((al = bits[9]) != 0 && ws[24] == 0) {  // AC30
                        int64_t num = Q00 * (DC07 + 2 * DC08 + DC09 - DC17 -
                                             2 * DC18 - DC19);
                        ws[24] = predict(al, Q30, num);
                    }
                    int64_t num = Q00 *
                        (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 -
                         2 * DC05 - 6 * DC06 + 6 * DC07 + 42 * DC08 +
                         6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 +
                         152 * DC13 + 42 * DC14 - 8 * DC15 - 6 * DC16 +
                         6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 -
                         2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 -
                         2 * DC25);
                    int pred;
                    if (num >= 0) {
                        pred = static_cast<int>(((Q00 << 7) + num) /
                                                (Q00 << 8));
                    } else {
                        pred = -static_cast<int>(((Q00 << 7) - num) /
                                                 (Q00 << 8));
                    }
                    ws[0] = static_cast<int16_t>(pred);
                }
                idct_islow(ws, c.q,
                           out.data() + static_cast<size_t>(row) * 8 * stride
                               + b * 8,
                           stride);
                DC01 = DC02; DC02 = DC03; DC03 = DC04; DC04 = DC05;
                DC06 = DC07; DC07 = DC08; DC08 = DC09; DC09 = DC10;
                DC11 = DC12; DC12 = DC13; DC13 = DC14; DC14 = DC15;
                DC16 = DC17; DC17 = DC18; DC18 = DC19; DC19 = DC20;
                DC21 = DC22; DC22 = DC23; DC23 = DC24; DC24 = DC25;
            }
        }
    }
}

// the component at full size (width_ x height_), as jdsample.c upsamples
// it; rows above the first and below the last real one repeat them
void Decoder::upsample(const Component& c, const std::vector<uint8_t>& in,
                       int stride, bool fancy,
                       std::vector<uint8_t>& out) const {
    const int W = width_, H = height_;
    const int hf = hmax_ / c.h, vf = vmax_ / c.v, dw = c.dw, dh = c.dh;
    out.resize(static_cast<size_t>(W) * H);
    auto row = [&](int y) {
        y = std::min(std::max(y, 0), dh - 1);
        return in.data() + static_cast<size_t>(y) * stride;
    };
    if (hf == 1 && vf == 1) {
        for (int y = 0; y < H; ++y)
            std::memcpy(out.data() + static_cast<size_t>(y) * W, row(y), W);
    } else if (fancy && hf == 2 && vf == 1 && dw > 2) {  // h2v1_fancy
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
    } else if (fancy && hf == 1 && vf == 2) {  // h1v2_fancy_upsample
        for (int y = 0; y < H; ++y) {
            const int i = y / 2, near = y % 2 ? i + 1 : i - 1;
            const int bias = y % 2 ? 2 : 1;
            const uint8_t* s0 = row(i);
            const uint8_t* s1 = row(near);
            uint8_t* o = out.data() + static_cast<size_t>(y) * W;
            for (int x = 0; x < W; ++x)
                o[x] = static_cast<uint8_t>((s0[x] * 3 + s1[x] + bias) >> 2);
        }
    } else if (fancy && hf == 2 && vf == 2 && dw > 2) {  // h2v2_fancy
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
    const bool smooth = !lossless_ && smoothing_ok();
    for (int i = 0; i < ncomp_; ++i) {
        Component& c = comp_[i];
        if (lossless_) {
            upsample(c, c.plane, c.bwp, false, full[i]);
        } else {
            component_plane(i, smooth, plane);
            upsample(c, plane, c.bw * 8, true, full[i]);
        }
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
    const bool ycc = ycc_();
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
    } catch (...) {  // Done and Suspend are caught inside; never here
        std::snprintf(err, static_cast<size_t>(errlen), "internal error");
        return 1;
    }
}

}  // extern "C"
