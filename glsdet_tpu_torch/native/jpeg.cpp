// JPEG decoding and baseline encoding for data/image_io.py, equal to what
// cv2.imread / cv2.imdecode (IMREAD_COLOR) and cv2.imencode(".jpg") give
// with OpenCV's bundled libjpeg-turbo at its defaults.
//
// Decoding repeats libjpeg-turbo's default decompression step by step:
//   - Huffman sequential scans (SOF0/SOF1, 8-bit samples, 1, 3 or 4
//     components, interleaved or not, restart intervals, the standard
//     tables where a DHT is missing, as jdhuff.c supplies them);
//   - Huffman progressive scans (SOF2) into a coefficient buffer of the
//     whole image, as jdphuff.c decodes them: DC first and refinement
//     scans (interleaved or not), AC first scans with EOB runs and AC
//     refinement scans (one component each), spectral selection,
//     successive approximation and restart intervals; the scans' order
//     checked as jdphuff.c checks it (coef_bits);
//   - jpeg_idct_islow (jidctint.c: CONST_BITS 13, PASS1_BITS 2), the
//     results clamped to [0, 255] as the SIMD IDCTs that OpenCV runs
//     clamp them (the C range-limit table agrees wherever an output lies
//     within 384 codes of the sample range, which every encoder's output
//     does);
//   - the "fancy" triangular upsamplers of jdsample.c (h2v1, h2v2 and
//     h1v2, with their rounding biases; h2v1 and h2v2 only where the
//     component is more than two samples wide, else replication), the
//     edge rows replicated as jdmainct.c's context rows replicate them,
//     and int_upsample's replication for other integral factors (4:1:1);
//   - the fixed-point YCbCr -> RGB tables of jdcolor.c, and the colour
//     space chosen as jdapimin.c: default_decompress_parms chooses it;
//     four components are CMYK (no Adobe marker, or Adobe transform 0),
//     which OpenCV converts as icvCvt_CMYK2BGR_8u_C4C3R does: each of
//     C, M, Y to k - ((255 - x) * k >> 8), as R, G, B.
// Where a scan's data ends early (at a marker, or at the end of the
// bytes), libjpeg decodes the block that ran out with zero bits and
// leaves every later block of the scan at zero (mid grey); so does this
// decoder.  At the end of the bytes the two OpenCV readers differ, and
// `file_mode` picks one: cv2.imread's file source inserts a fake EOI
// there (the image decodes, grey where data is missing), cv2.imdecode's
// memory source suspends and imdecode returns nothing (refused here).
// A marker segment cut short is refused by both.  Entropy data that
// libjpeg would decode only with warnings and substitutes (a bad Huffman
// code, a coefficient past the block, a restart marker out of sequence,
// a progression out of order) is refused.
//
// A progressive image whose scans stop before every low coefficient is
// exact (a file cut short, or closed with EOI early) is block-smoothed
// as libjpeg-turbo 2.1+ smooths it (jdcoefct.c: smoothing_ok and
// decompress_smooth_data); a complete file never is.
// YCCK (Adobe transform 2), arithmetic coding, lossless, hierarchical
// and 12-bit files are refused as unsupported forms.
//
// Encoding repeats libjpeg-turbo's compression at jpeg_set_defaults +
// jpeg_set_quality(q, TRUE): jccolor.c's RGB -> YCbCr tables, 4:2:0 with
// h2v2_downsample's 1,2,1,2 bias and the edge replication of jcprepct.c
// and jcsample.c, jpeg_fdct_islow, the reciprocal quantiser of
// jcdctmgr.c (16-bit, as in the SIMD builds), dummy blocks as jccoefct.c
// makes them, and the standard Huffman tables (no optimisation).
//
// Everything is integer arithmetic, so the result does not depend on the
// compiler, and no state is shared between calls.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

#include "simple_idct.h"

namespace {

enum Status { kOk = 0, kCorrupt = 1, kUnsupported = 2 };

struct JpegError : std::exception {
  int code;
  std::string msg;
  JpegError(int c, std::string m) : code(c), msg(std::move(m)) {}
};

[[noreturn]] void corrupt(const std::string& m) { throw JpegError(kCorrupt, m); }
[[noreturn]] void unsupported(const std::string& m) {
  throw JpegError(kUnsupported, m);
}

// jpeg_natural_order: zigzag index -> natural (row-major) index
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// The standard Huffman tables of Annex K.3 (jstdhuff.c): bits[1..16], vals
const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcLumVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kDcChrBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcChrVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
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
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChrBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChrVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
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
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// Annex K.1 quantisation tables, natural order (jcparam.c)
const int kStdLumQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kStdChrQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// jidctint.c / jfdctint.c constants (CONST_BITS = 13)
constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr int32_t FIX_0_298631336 = 2446;
constexpr int32_t FIX_0_390180644 = 3196;
constexpr int32_t FIX_0_541196100 = 4433;
constexpr int32_t FIX_0_765366865 = 6270;
constexpr int32_t FIX_0_899976223 = 7373;
constexpr int32_t FIX_1_175875602 = 9633;
constexpr int32_t FIX_1_501321110 = 12299;
constexpr int32_t FIX_1_847759065 = 15137;
constexpr int32_t FIX_1_961570560 = 16069;
constexpr int32_t FIX_2_053119869 = 16819;
constexpr int32_t FIX_2_562915447 = 20995;
constexpr int32_t FIX_3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }
inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// ---------------------------------------------------------------- decode

struct Huff {
  bool defined = false;
  uint16_t fast[512];   // 9-bit lookahead: (length << 8) | symbol, 0 = slow
  int32_t maxcode[18];  // largest code of each length, -1 where none
  int32_t valoff[17];   // index into vals of a length's first code, less it
  uint8_t bits[17];
  uint8_t vals[256];
  int nvals = 0;

  void set(const uint8_t* b, const uint8_t* v) {
    int n = 0;
    bits[0] = 0;
    for (int l = 1; l <= 16; ++l) {
      bits[l] = b[l];
      n += b[l];
    }
    if (n > 256) corrupt("bad Huffman table");
    memcpy(vals, v, n);
    nvals = n;
    defined = true;
  }

  // jpeg_make_d_derived_tbl
  void derive(bool dc) {
    int code = 0, k = 0;
    uint16_t codes[256];
    uint8_t sizes[256];
    for (int l = 1; l <= 16; ++l) {
      valoff[l] = k - code;
      for (int i = 0; i < bits[l]; ++i) {
        codes[k] = (uint16_t)code;
        sizes[k] = (uint8_t)l;
        ++code;
        ++k;
      }
      if (code > (1 << l)) corrupt("bad Huffman table");
      maxcode[l] = bits[l] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    memset(fast, 0, sizeof(fast));
    for (int i = 0; i < k; ++i) {
      if (sizes[i] > 9) continue;
      const int shift = 9 - sizes[i];
      const int base = codes[i] << shift;
      for (int j = 0; j < (1 << shift); ++j)
        fast[base | j] = (uint16_t)((sizes[i] << 8) | vals[i]);
    }
    if (dc)
      for (int i = 0; i < nvals; ++i)
        if (vals[i] > 15) corrupt("bad Huffman table");
  }
};

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;       // downsampled_width/height
  int stride = 0, rows = 0; // plane size, a whole number of MCUs
  int dc = 0, ac = 0;       // Huffman table slots of the current scan
  int pred = 0;
  bool scanned = false;
  uint16_t q[64];           // latched at the first scan, natural order
  std::vector<uint8_t> plane;
  // progressive: every block's coefficients (stride / 8 blocks a row,
  // natural order), and the successive-approximation bit each
  // coefficient has reached (jdphuff.c's coef_bits, -1 before any scan)
  std::vector<int16_t> coef;
  int coef_bits[64];
  int prev_bits[64];        // coef_bits before the component's last scan
};

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;  // left-aligned
  int cnt = 0;       // valid bits in buf
  int pad = 0;       // zero bits appended after a marker
  int marker = 0;    // the marker that ended the entropy data, 0 if none
  bool eof_eoi = false;  // the end of the bytes reads as EOI (file mode)

  int eof() {
    if (!eof_eoi) corrupt("JPEG data ends inside a scan");
    p = end;
    return 0xD9;
  }

  void fill() {
    while (cnt <= 56) {
      int byte = 0;
      if (marker) {
        pad += 8;
      } else if (p >= end) {
        marker = eof();
        pad += 8;
      } else {
        byte = *p++;
        if (byte == 0xFF) {
          int next;
          do {
            next = p < end ? *p++ : eof();
          } while (next == 0xFF);
          if (next != 0) {
            marker = next;
            byte = 0;
            pad += 8;
          }
        }
      }
      buf |= (uint64_t)byte << (56 - cnt);
      cnt += 8;
    }
  }
  inline int peek(int n) const { return (int)(buf >> (64 - n)); }
  inline void skip(int n) {
    buf <<= n;
    cnt -= n;
  }
  inline int get(int n) {
    if (cnt < n) fill();
    const int v = peek(n);
    skip(n);
    return v;
  }
  inline int decode(const Huff& h) {
    if (cnt < 16) fill();
    const int e = h.fast[peek(9)];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    for (int l = 10; l <= 16; ++l) {
      const int code = peek(l);
      if (code <= h.maxcode[l]) {
        skip(l);
        return h.vals[h.valoff[l] + code];
      }
    }
    corrupt("corrupt JPEG data: bad Huffman code");
  }
  inline int receive_extend(int s) {
    if (s == 0) return 0;
    const int v = get(s);
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }
  void drop_bits() {
    buf = 0;
    cnt = 0;
    pad = 0;
  }
  // bits consumed past a marker: the entropy data was cut short
  bool overran() const { return cnt < pad; }
  // the natural index of zigzag position k; past the block, libjpeg's
  // jpeg_natural_order[] extra entries land on 63, which the zero bits
  // after the data ran out may reach (in real data it is refused)
  int natural(int k) const {
    if (k <= 63) return kNatural[k];
    if (!overran()) corrupt("corrupt JPEG data: coefficient past the block");
    return 63;
  }
};

// jpeg_idct_islow, outputs clamped (see the file comment)
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
        ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      const int dc = (ip[0] * qp[0]) * (1 << PASS1_BITS);
      for (int i = 0; i < 8; ++i) wp[8 * i] = dc;
      continue;
    }
    int32_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int32_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int32_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    const int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = CONST_BITS - PASS1_BITS;
    wp[0] = descale(tmp10 + tmp3, n);
    wp[56] = descale(tmp10 - tmp3, n);
    wp[8] = descale(tmp11 + tmp2, n);
    wp[48] = descale(tmp11 - tmp2, n);
    wp[16] = descale(tmp12 + tmp1, n);
    wp[40] = descale(tmp12 - tmp1, n);
    wp[24] = descale(tmp13 + tmp0, n);
    wp[32] = descale(tmp13 - tmp0, n);
  }
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + (size_t)r * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 &&
        wp[6] == 0 && wp[7] == 0) {
      const uint8_t dc = clamp255(descale(wp[0], PASS1_BITS + 3) + 128);
      memset(op, dc, 8);
      continue;
    }
    int32_t z2 = wp[2], z3 = wp[6];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    int32_t tmp0 = (wp[0] + wp[4]) * (1 << CONST_BITS);
    int32_t tmp1 = (wp[0] - wp[4]) * (1 << CONST_BITS);
    const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    const int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = CONST_BITS + PASS1_BITS + 3;
    op[0] = clamp255(descale(tmp10 + tmp3, n) + 128);
    op[7] = clamp255(descale(tmp10 - tmp3, n) + 128);
    op[1] = clamp255(descale(tmp11 + tmp2, n) + 128);
    op[6] = clamp255(descale(tmp11 - tmp2, n) + 128);
    op[2] = clamp255(descale(tmp12 + tmp1, n) + 128);
    op[5] = clamp255(descale(tmp12 - tmp1, n) + 128);
    op[3] = clamp255(descale(tmp13 + tmp0, n) + 128);
    op[4] = clamp255(descale(tmp13 - tmp0, n) + 128);
  }
}

struct Decoder {
  const uint8_t* data;
  const uint8_t* end;
  const uint8_t* p;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart = 0;
  bool have_sof = false, jfif = false, adobe = false, progressive = false;
  int adobe_transform = -1;
  int orientation = 1;
  bool seen_app1 = false;
  Comp comp[4];
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huff dc_tbl[4], ac_tbl[4];

  bool eof_eoi;  // file mode: the end of the bytes reads as EOI
  // FFmpeg's mjpeg route (jpeg_decode_yuv420): dequantise and run its
  // simple IDCT instead of jpeg_idct_islow
  bool ffmpeg_idct = false;
  int scans = 0;       // SOS markers read (input_scan_number)
  // jdcoefct.c's last_good_iMCU_row: the iMCU row where a scan's data
  // ran out; block smoothing takes the bits before the last scan past it
  int last_good = 1 << 30;

  Decoder(const uint8_t* d, size_t n, bool file_mode)
      : data(d), end(d + n), p(d), eof_eoi(file_mode) {}

  int byte() {
    if (p >= end) corrupt("JPEG data ends inside a marker segment");
    return *p++;
  }
  int u16() {
    const int hi = byte();
    return (hi << 8) | byte();
  }

  // next_marker: skip any bytes that are not a marker, as libjpeg does
  int next_marker() {
    for (;;) {
      if (p >= end) return eof_marker();
      if (*p++ != 0xFF) continue;
      int m;
      do {
        if (p >= end) return eof_marker();
        m = *p++;
      } while (m == 0xFF);
      if (m != 0) return m;
    }
  }
  int eof_marker() {
    if (!eof_eoi) corrupt("JPEG data ends before EOI");
    return 0xD9;
  }

  static uint16_t be16(const uint8_t* b, bool le) {
    return le ? (uint16_t)(b[0] | (b[1] << 8)) : (uint16_t)((b[0] << 8) | b[1]);
  }
  static uint32_t be32(const uint8_t* b, bool le) {
    return le ? (uint32_t)b[0] | ((uint32_t)b[1] << 8) | ((uint32_t)b[2] << 16) |
                    ((uint32_t)b[3] << 24)
              : ((uint32_t)b[0] << 24) | ((uint32_t)b[1] << 16) |
                    ((uint32_t)b[2] << 8) | (uint32_t)b[3];
  }

  // OpenCV reads the orientation from the first APP1 segment, past its
  // six-byte identifier, from IFD0 of the TIFF structure there
  void parse_exif(const uint8_t* b, int n) {
    if (n <= 6) return;
    b += 6;
    n -= 6;
    if (n < 8) return;
    bool le;
    if (b[0] == 'I' && b[1] == 'I') le = true;
    else if (b[0] == 'M' && b[1] == 'M') le = false;
    else return;
    if (be16(b + 2, le) != 0x2A) return;
    const uint32_t ifd = be32(b + 4, le);
    if ((uint64_t)ifd + 2 > (uint64_t)n) return;
    const int count = be16(b + ifd, le);
    for (int i = 0; i < count; ++i) {
      const uint64_t e = (uint64_t)ifd + 2 + 12 * (uint64_t)i;
      if (e + 12 > (uint64_t)n) return;
      if (be16(b + e, le) == 0x0112) {
        const int v = be16(b + e + 8, le);
        orientation = (v >= 1 && v <= 8) ? v : 1;
        return;
      }
    }
  }

  void read_sof(int m, int len) {
    if (have_sof) corrupt("JPEG with two SOF markers");
    const int prec = byte();
    height = u16();
    width = u16();
    ncomp = byte();
    if (len != 8 + 3 * ncomp) corrupt("bad SOF length");
    if (m != 0xC0 && m != 0xC1 && m != 0xC2) {
      const bool arith = m >= 0xC9;
      const char* what = m == 0xC9 ? "sequential" :
                         m == 0xCA ? "progressive" :
                         m == 0xC3 || m == 0xCB ? "lossless" : "hierarchical";
      unsupported(std::string(arith ? "arithmetic-coded " : "") + what +
                  " JPEG");
    }
    progressive = m == 0xC2;
    if (prec != 8)
      unsupported(std::to_string(prec) + "-bit JPEG samples");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      unsupported(std::to_string(ncomp) + "-component JPEG");
    if (width <= 0 || height <= 0) corrupt("JPEG with an empty image (DNL)");
    for (int i = 0; i < ncomp; ++i) {
      Comp& c = comp[i];
      c.id = byte();
      const int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        corrupt("bad JPEG sampling factors");
      hmax = c.h > hmax ? c.h : hmax;
      vmax = c.v > vmax ? c.v : vmax;
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Comp& c = comp[i];
      c.dw = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
      c.stride = mcux * c.h * 8;
      c.rows = mcuy * c.v * 8;
    }
    have_sof = true;
  }

  // Parse marker segments up to the first SOS (or to the end of the
  // headers when only the size is wanted).  Returns the marker that
  // stopped it.
  int read_markers(bool stop_at_sof, int first = 0) {
    for (;;) {
      const int m = first ? first : next_marker();
      first = 0;
      if (m == 0xD8) continue;            // SOI
      if (m == 0xD9 || m == 0xDA) return m;
      if (m >= 0xD0 && m <= 0xD7) continue;  // stray RSTn, ignored
      if (m == 0x01) continue;               // TEM
      const int len = u16();
      if (len < 2) corrupt("bad marker length");
      const uint8_t* seg = p;
      if (end - p < len - 2) corrupt("JPEG data ends inside a marker segment");
      p += len - 2;
      const uint8_t* q = seg;
      const uint8_t* qend = seg + (len - 2);
      if ((m >= 0xC0 && m <= 0xCF) && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        p = seg;
        read_sof(m, len);
        p = qend;
        if (stop_at_sof) return m;
      } else if (m == 0xC4) {  // DHT
        while (q < qend) {
          const int tc = *q >> 4, th = *q & 15;
          ++q;
          if (tc > 1 || th > 3 || qend - q < 16) corrupt("bad DHT");
          uint8_t bits[17];
          bits[0] = 0;
          int n = 0;
          for (int l = 1; l <= 16; ++l) n += bits[l] = *q++;
          if (n > 256 || qend - q < n) corrupt("bad DHT");
          (tc ? ac_tbl : dc_tbl)[th].set(bits, q);
          q += n;
        }
      } else if (m == 0xDB) {  // DQT
        while (q < qend) {
          const int pq = *q >> 4, tq = *q & 15;
          ++q;
          if (tq > 3 || pq > 1 || qend - q < (pq ? 128 : 64)) corrupt("bad DQT");
          for (int i = 0; i < 64; ++i) {
            const int v = pq ? (q[0] << 8) | q[1] : q[0];
            q += pq ? 2 : 1;
            qt[tq][kNatural[i]] = (uint16_t)v;
          }
          qt_defined[tq] = true;
        }
      } else if (m == 0xDD) {  // DRI
        if (len != 4) corrupt("bad DRI");
        restart = (seg[0] << 8) | seg[1];
      } else if (m == 0xE0) {  // APP0
        if (len - 2 >= 14 && memcmp(seg, "JFIF\0", 5) == 0) jfif = true;
      } else if (m == 0xE1) {  // APP1
        if (!seen_app1) {
          seen_app1 = true;
          parse_exif(seg, len - 2);
        }
      } else if (m == 0xEE) {  // APP14
        if (len - 2 >= 12 && memcmp(seg, "Adobe", 5) == 0) {
          adobe = true;
          adobe_transform = seg[11];
        }
      } else if (m == 0xCC) {
        unsupported("arithmetic-coded JPEG");
      }
      // other APPn, COM, DNL, ...: skipped
    }
  }

  void decode_block(BitReader& br, Comp& c, const Huff& dc, const Huff& ac,
                    uint8_t* out) {
    int16_t blk[64];
    memset(blk, 0, sizeof(blk));
    const int s = br.decode(dc);
    c.pred += br.receive_extend(s);
    blk[0] = (int16_t)c.pred;
    for (int k = 1; k < 64; ++k) {
      const int rs = br.decode(ac);
      const int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        const int pos = br.natural(k);
        blk[pos] = (int16_t)br.receive_extend(sz);
      } else if (r == 15) {
        k += 15;
      } else {
        break;
      }
    }
    if (ffmpeg_idct) {
      // mjpegdec.c: the DC predicted from 4 << 8 (the level shift) in
      // dequantised units and clipped to int16, each AC level times its
      // step
      int dc = blk[0] * c.q[0] + 1024;
      blk[0] = (int16_t)(dc < -32768 ? -32768 : dc > 32767 ? 32767 : dc);
      for (int k = 1; k < 64; ++k) blk[k] = (int16_t)(blk[k] * c.q[k]);
      simple_idct::put(blk, out, c.stride, false);
      return;
    }
    idct_islow(blk, c.q, out, c.stride);
  }

  // jdphuff.c: decode_mcu_DC_first / _DC_refine, one block
  void dc_first(BitReader& br, Comp& c, int16_t* blk, int al) {
    const int s = br.decode(dc_tbl[c.dc]);
    c.pred += br.receive_extend(s);
    blk[0] = (int16_t)(c.pred * (1 << al));
  }
  static void dc_refine(BitReader& br, int16_t* blk, int al) {
    if (br.get(1)) blk[0] = (int16_t)(blk[0] | (1 << al));
  }

  // jdphuff.c: decode_mcu_AC_first, one block
  void ac_first(BitReader& br, const Huff& ac, int16_t* blk, int ss, int se,
                int al, int& eobrun) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      const int rs = br.decode(ac);
      const int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        const int pos = br.natural(k);
        blk[pos] = (int16_t)(br.receive_extend(sz) * (1 << al));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.get(r);
        --eobrun;
        break;
      }
    }
  }

  // jdphuff.c: decode_mcu_AC_refine, one block
  static void correct(BitReader& br, int16_t& coef, int p1) {
    if (br.get(1) && (coef & p1) == 0)
      coef = (int16_t)(coef + (coef >= 0 ? p1 : -p1));
  }
  void ac_refine(BitReader& br, const Huff& ac, int16_t* blk, int ss, int se,
                 int al, int& eobrun) {
    const int p1 = 1 << al;
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        const int rs = br.decode(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1 && !br.overran())
            corrupt("corrupt JPEG data: bad refinement code");
          s = br.get(1) ? p1 : -p1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        // past the nonzero coefficients (each with its correction bit)
        // and r zero ones, to the new coefficient's position
        do {
          int16_t& coef = blk[kNatural[k]];
          if (coef != 0) {
            correct(br, coef, p1);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[br.natural(k)] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t& coef = blk[kNatural[k]];
        if (coef != 0) correct(br, coef, p1);
      }
      --eobrun;
    }
  }

  // jdphuff.c: start_pass_phuff_decoder's checks of a scan's parameters
  // and of the order of the scans
  void check_progression(Comp** sc, int ns, int ss, int se, int ah, int al) {
    bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1);
    if (ah != 0 && al != ah - 1) bad = true;
    if (al > 13 || bad) corrupt("bad progressive scan parameters");
    for (int i = 0; i < ns; ++i) {
      int* bits = sc[i]->coef_bits;
      for (int k = ss < 1 ? ss : 1; k <= (se > 9 ? se : 9); ++k)
        sc[i]->prev_bits[k] = scans > 1 ? bits[k] : 0;
      if (ss != 0 && bits[0] < 0)
        corrupt("corrupt JPEG data: AC scan before the DC scan");
      for (int k = ss; k <= se; ++k) {
        if (ah != (bits[k] < 0 ? 0 : bits[k]))
          corrupt("corrupt JPEG data: progressive scans out of order");
        bits[k] = al;
      }
    }
  }

  void read_scan() {
    const int len = u16();
    const int ns = byte();
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns) corrupt("bad SOS");
    if (!have_sof) corrupt("SOS before SOF");
    Comp* sc[4];
    for (int i = 0; i < ns; ++i) {
      const int id = byte(), t = byte();
      int k = 0;
      while (k < ncomp && comp[k].id != id) ++k;
      if (k == ncomp) corrupt("SOS names an unknown component");
      sc[i] = &comp[k];
      sc[i]->dc = t >> 4;
      sc[i]->ac = t & 15;
      if (sc[i]->dc > 3 || sc[i]->ac > 3) corrupt("bad SOS table slot");
    }
    const int ss = byte(), se = byte(), a = byte();
    const int ah = a >> 4, al = a & 15;
    ++scans;
    if (!progressive && (ss != 0 || se != 63 || a != 0))
      corrupt("bad sequential scan parameters");
    if (progressive) check_progression(sc, ns, ss, se, ah, al);
    // the tables the scan reads: a progressive DC refinement reads none,
    // a DC scan no AC table, an AC scan no DC table
    const bool need_dc = !progressive || (ss == 0 && ah == 0);
    const bool need_ac = !progressive || ss != 0;
    for (int i = 0; i < ns; ++i) {
      Comp& c = *sc[i];
      if (!c.scanned) {
        if (!qt_defined[c.tq]) corrupt("JPEG component without a DQT");
        memcpy(c.q, qt[c.tq], sizeof(c.q));
        if (progressive) {
          c.coef.assign((size_t)c.stride * c.rows, 0);  // 64 per 8x8 block
        } else {
          // blocks a short scan leaves out stay at zero: mid grey
          c.plane.assign((size_t)c.stride * c.rows, 128);
        }
        c.scanned = true;
      }
      c.pred = 0;
      // jdhuff.c: a missing table of slot 0 or 1 is the standard one
      for (int dc = 1; dc >= 0; --dc) {
        if (!(dc ? need_dc : need_ac)) continue;
        Huff& h = dc ? dc_tbl[c.dc] : ac_tbl[c.ac];
        const int slot = dc ? c.dc : c.ac;
        if (!h.defined) {
          if (slot > 1) corrupt("JPEG scan without its Huffman table");
          if (dc) h.set(slot ? kDcChrBits : kDcLumBits, slot ? kDcChrVals : kDcLumVals);
          else h.set(slot ? kAcChrBits : kAcLumBits, slot ? kAcChrVals : kAcLumVals);
        }
        h.derive(dc);
      }
    }
    int nx, ny;
    if (ns == 1) {
      nx = (sc[0]->dw + 7) / 8;
      ny = (sc[0]->dh + 7) / 8;
    } else {
      nx = mcux;
      ny = mcuy;
    }
    int eobrun = 0;
    // one block of a scan: decoded into its plane (sequential) or into
    // the coefficient buffer (progressive)
    auto block = [&](BitReader& br, Comp& c, int by, int bx) {
      if (!progressive) {
        decode_block(br, c, dc_tbl[c.dc], ac_tbl[c.ac],
                     c.plane.data() + (size_t)by * 8 * c.stride + bx * 8);
        return;
      }
      int16_t* blk = c.coef.data() + ((size_t)by * (c.stride / 8) + bx) * 64;
      if (ss == 0) {
        if (ah == 0) dc_first(br, c, blk, al);
        else dc_refine(br, blk, al);
      } else if (ah == 0) {
        ac_first(br, ac_tbl[c.ac], blk, ss, se, al, eobrun);
      } else {
        ac_refine(br, ac_tbl[c.ac], blk, ss, se, al, eobrun);
      }
    };
    BitReader br;
    br.p = p;
    br.end = end;
    br.eof_eoi = eof_eoi;
    int todo = restart, next_rst = 0;
    bool insufficient = false;  // jdhuff.c: the data ran out
    for (int my = 0; my < ny; ++my) {
      for (int mx = 0; mx < nx; ++mx) {
        if (restart && todo == 0) {
          // process_restart: drop the buffered bits, read RSTn
          if (!br.marker) {
            p = br.p;
            br.marker = next_marker();
            br.p = p;
          }
          br.drop_bits();
          if (br.marker == 0xD0 + next_rst) {
            br.marker = 0;
            insufficient = false;
          } else if (br.marker < 0xC0 || (br.marker >= 0xD0 && br.marker <= 0xD7)) {
            corrupt("corrupt JPEG data: restart marker out of sequence");
          }  // else jpeg_resync_to_restart leaves the marker: the data ran out
          next_rst = (next_rst + 1) & 7;
          todo = restart;
          for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
          eobrun = 0;
        }
        if (insufficient) {
          if (restart) --todo;
          continue;
        }
        if (ns == 1) {
          block(br, *sc[0], my, mx);
        } else {
          for (int i = 0; i < ns; ++i) {
            Comp& c = *sc[i];
            for (int by = 0; by < c.v; ++by)
              for (int bx = 0; bx < c.h; ++bx)
                block(br, c, my * c.v + by, mx * c.h + bx);
          }
        }
        if (!insufficient && br.overran()) {  // decoded with zero bits
          insufficient = true;
          // the iMCU row where the data ran out: an MCU row of an
          // interleaved scan, v block rows of a component's own
          last_good = ns == 1 ? my / sc[0]->v : my;
        }
        if (restart) --todo;
      }
    }
    // the rest of the entropy data, if any, is skipped up to the next marker
    p = br.p;
    pending_marker = br.marker;
  }
  int pending_marker = 0;

  // jdcoefct.c: smoothing_ok, whether libjpeg smooths the blocks of a
  // progressive image (some of its low coefficients not yet exact)
  bool smoothing_ok() const {
    static const int kLow[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int i = 0; i < ncomp; ++i) {
      const Comp& c = comp[i];
      if (!c.scanned) return false;  // a quantisation table not latched
      for (int k : kLow)
        if (c.q[k] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  // jdcoefct.c: decompress_smooth_data (libjpeg-turbo 2.1 and later):
  // each block's DC and those of the 5x5 blocks around it estimate the
  // low AC coefficients that are still zero and not known to be exact
  // (and, while no AC coefficient has arrived, the DC itself); iMCU rows
  // past the one where the data ran out take the bits before the last
  // scan.  The block rows of the last iMCU row count as in
  // jdcoefct.c (block_rows * total_iMCU_rows), which reaches the
  // padding row below the image for some heights.
  void smooth_plane(Comp& c) {
    const int bw = c.stride / 8;
    const int wib = (c.dw + 7) / 8, hib = (c.dh + 7) / 8;
    const int64_t Q00 = c.q[0], Q01 = c.q[1], Q10 = c.q[8], Q20 = c.q[16],
                  Q11 = c.q[9], Q02 = c.q[2], Q03 = c.q[3], Q12 = c.q[10],
                  Q21 = c.q[17], Q30 = c.q[24];
    int prev[10];
    for (int k = 1; k < 10; ++k) prev[k] = scans > 1 ? c.prev_bits[k] : -1;
    auto dc_at = [&](int row, int col) {
      return (int)c.coef[((size_t)row * bw + col) * 64];
    };
    auto est = [](int64_t q, int64_t num, int al) {
      int pred = (int)(((q << 7) + (num >= 0 ? num : -num)) / (q << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      return num >= 0 ? pred : -pred;
    };
    for (int r = 0; r < mcuy; ++r) {
      int block_rows = c.v;
      if (r == mcuy - 1) {
        block_rows = hib % c.v;
        if (block_rows == 0) block_rows = c.v;
      }
      const int image_block_rows = block_rows * mcuy;
      const int* bits = r > last_good ? prev : c.coef_bits;
      bool change_dc = true;
      for (int k = 1; k < 10; ++k) change_dc = change_dc && bits[k] == -1;
      for (int b = 0; b < block_rows; ++b) {
        const int ib = r * block_rows + b, cur = r * c.v + b;
        const int prv = ib > 0 ? cur - 1 : cur;
        const int nxt = ib < image_block_rows - 1 ? cur + 1 : cur;
        const int rows[5] = {ib > 1 ? cur - 2 : prv, prv, cur, nxt,
                             ib < image_block_rows - 2 ? cur + 2 : nxt};
        int D[5][5];  // DC01..DC25 of jdcoefct.c, row by row
        for (int i = 0; i < 5; ++i)
          for (int j = 0; j < 5; ++j) D[i][j] = dc_at(rows[i], 0);
        const int last_col = wib - 1;
        for (int bn = 0; bn <= last_col; ++bn) {
          if (bn == 0 && bn < last_col)
            for (int i = 0; i < 5; ++i) D[i][3] = D[i][4] = dc_at(rows[i], 1);
          if (bn + 1 < last_col)
            for (int i = 0; i < 5; ++i) D[i][4] = dc_at(rows[i], bn + 2);
          const int DC01 = D[0][0], DC02 = D[0][1], DC03 = D[0][2],
                    DC04 = D[0][3], DC05 = D[0][4], DC06 = D[1][0],
                    DC07 = D[1][1], DC08 = D[1][2], DC09 = D[1][3],
                    DC10 = D[1][4], DC11 = D[2][0], DC12 = D[2][1],
                    DC13 = D[2][2], DC14 = D[2][3], DC15 = D[2][4],
                    DC16 = D[3][0], DC17 = D[3][1], DC18 = D[3][2],
                    DC19 = D[3][3], DC20 = D[3][4], DC21 = D[4][0],
                    DC22 = D[4][1], DC23 = D[4][2], DC24 = D[4][3],
                    DC25 = D[4][4];
          int16_t ws[64];
          memcpy(ws, c.coef.data() + ((size_t)cur * bw + bn) * 64, sizeof(ws));
          int al;
          if ((al = bits[1]) != 0 && ws[1] == 0)  // AC01
            ws[1] = (int16_t)est(Q01, Q00 * (change_dc ?
                (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 -
                 13 * DC09 + 3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 +
                 3 * DC15 - 3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 -
                 DC21 - DC22 + DC24 + DC25) :
                (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15)), al);
          if ((al = bits[2]) != 0 && ws[8] == 0)  // AC10
            ws[8] = (int16_t)est(Q10, Q00 * (change_dc ?
                (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
                 13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 -
                 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
                 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25) :
                (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23)), al);
          if ((al = bits[3]) != 0 && ws[16] == 0)  // AC20
            ws[16] = (int16_t)est(Q20, Q00 * (change_dc ?
                (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 -
                 14 * DC13 - 5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 +
                 DC23) :
                (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23)), al);
          if ((al = bits[4]) != 0 && ws[9] == 0)  // AC11
            ws[9] = (int16_t)est(Q11, Q00 * (change_dc ?
                (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 +
                 9 * DC19 + DC21 - DC25) :
                (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 +
                 DC22 - DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09)), al);
          if ((al = bits[5]) != 0 && ws[2] == 0)  // AC02
            ws[2] = (int16_t)est(Q02, Q00 * (change_dc ?
                (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 -
                 14 * DC13 + 7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 +
                 2 * DC19) :
                (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15)), al);
          if (change_dc) {
            if ((al = bits[6]) != 0 && ws[3] == 0)  // AC03
              ws[3] = (int16_t)est(Q03, Q00 * (DC07 - DC09 + 2 * DC12 -
                                               2 * DC14 + DC17 - DC19), al);
            if ((al = bits[7]) != 0 && ws[10] == 0)  // AC12
              ws[10] = (int16_t)est(Q12, Q00 * (DC07 - 3 * DC08 + DC09 -
                                                DC17 + 3 * DC18 - DC19), al);
            if ((al = bits[8]) != 0 && ws[17] == 0)  // AC21
              ws[17] = (int16_t)est(Q21, Q00 * (DC07 - DC09 - 3 * DC12 +
                                                3 * DC14 + DC17 - DC19), al);
            if ((al = bits[9]) != 0 && ws[24] == 0)  // AC30
              ws[24] = (int16_t)est(Q30, Q00 * (DC07 + 2 * DC08 + DC09 -
                                                DC17 - 2 * DC18 - DC19), al);
            ws[0] = (int16_t)est(Q00, Q00 *
                (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 -
                 6 * DC06 + 6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 -
                 8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 -
                 8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 -
                 6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 -
                 2 * DC25), 0);
          }
          idct_islow(ws, c.q, c.plane.data() + (size_t)cur * 8 * c.stride + bn * 8,
                     c.stride);
          for (int i = 0; i < 5; ++i) {
            D[i][0] = D[i][1];
            D[i][1] = D[i][2];
            D[i][2] = D[i][3];
            D[i][3] = D[i][4];
          }
        }
      }
    }
  }

  // the progressive coefficient buffer through the IDCT into the planes
  // (smoothed where libjpeg smooths); a component that no scan reached
  // is mid grey (jddctmgr.c's zero multipliers)
  void idct_planes() {
    const bool smooth = smoothing_ok();
    for (int i = 0; i < ncomp; ++i) {
      Comp& c = comp[i];
      c.plane.assign((size_t)c.stride * c.rows, 128);
      if (!c.scanned) continue;
      if (smooth) {
        smooth_plane(c);
        continue;
      }
      const int bw = c.stride / 8, bh = c.rows / 8;
      for (int by = 0; by < bh; ++by)
        for (int bx = 0; bx < bw; ++bx)
          idct_islow(c.coef.data() + ((size_t)by * bw + bx) * 64, c.q,
                     c.plane.data() + (size_t)by * 8 * c.stride + bx * 8,
                     c.stride);
    }
  }

  void decode_all() {
    int m = read_markers(false);
    if (ncomp == 4 && adobe && adobe_transform != 0)
      unsupported("YCCK JPEG (Adobe transform " +
                  std::to_string(adobe_transform) + ")");
    for (int i = 0; i < ncomp; ++i)
      for (int k = 0; k < 64; ++k) comp[i].coef_bits[k] = -1;
    while (m != 0xD9) {  // m is SOS
      read_scan();
      m = read_markers(false, pending_marker);
      pending_marker = 0;
    }
    if (!have_sof) corrupt("JPEG without SOF");
    if (progressive) {
      // jdinput.c: EOI before the first SOS is JERR_SOF_NO_SOS
      bool any = false;
      for (int i = 0; i < ncomp; ++i) any = any || comp[i].scanned;
      if (!any) corrupt("JPEG without a scan");
      idct_planes();
      return;
    }
    for (int i = 0; i < ncomp; ++i)
      if (!comp[i].scanned) corrupt("JPEG component without a scan");
  }

  // jdsample.c, one output row of component c at full size
  void upsample_row(const Comp& c, int y, uint8_t* out) const {
    const int he = hmax / c.h, ve = vmax / c.v;
    const uint8_t* pl = c.plane.data();
    const int dw = c.dw, dh = c.dh;
    auto row = [&](int r) {
      r = r < 0 ? 0 : (r >= dh ? dh - 1 : r);
      return pl + (size_t)r * c.stride;
    };
    if (he == 1 && ve == 1) {
      memcpy(out, row(y), width);
    } else if (he == 2 && ve == 1) {
      const uint8_t* in = row(y);
      if (dw > 2) {
        for (int x = 0; x < dw; ++x) {
          const int v3 = in[x] * 3;
          const int o = 2 * x;
          if (o < width)
            out[o] = (uint8_t)(x == 0 ? in[0] : (v3 + in[x - 1] + 1) >> 2);
          if (o + 1 < width)
            out[o + 1] = (uint8_t)(x == dw - 1 ? in[x] : (v3 + in[x + 1] + 2) >> 2);
        }
      } else {
        for (int x = 0; x < width; ++x) out[x] = in[x >> 1];
      }
    } else if (he == 1 && ve == 2) {
      const int iy = y >> 1;
      const uint8_t* in0 = row(iy);
      const uint8_t* in1 = row((y & 1) ? iy + 1 : iy - 1);
      const int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < width; ++x)
        out[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
    } else if (he == 2 && ve == 2 && dw > 2) {
      const int iy = y >> 1;
      const uint8_t* in0 = row(iy);
      const uint8_t* in1 = row((y & 1) ? iy + 1 : iy - 1);
      int last = 0, cur = in0[0] * 3 + in1[0];
      for (int x = 0; x < dw; ++x) {
        const int nxt = x + 1 < dw ? in0[x + 1] * 3 + in1[x + 1] : 0;
        const int o = 2 * x;
        if (o < width)
          out[o] = (uint8_t)(x == 0 ? (cur * 4 + 8) >> 4 : (cur * 3 + last + 8) >> 4);
        if (o + 1 < width)
          out[o + 1] = (uint8_t)(x == dw - 1 ? (cur * 4 + 7) >> 4 : (cur * 3 + nxt + 7) >> 4);
        last = cur;
        cur = nxt;
      }
    } else {  // h2v2 at two samples or less, and int_upsample
      const uint8_t* in = pl + (size_t)(y / ve) * c.stride;
      for (int x = 0; x < width; ++x) out[x] = in[x / he];
    }
  }

  void to_rgb(uint8_t* out) const {
    for (int i = 0; i < ncomp; ++i)
      if (hmax % comp[i].h || vmax % comp[i].v)
        unsupported("JPEG with non-integral sampling ratios");
    // jdcolor.c: build_ycc_rgb_table
    int cr_r[256], cb_b[256];
    int32_t cr_g[256], cb_g[256];
    const int32_t one_half = 1 << 15;
    for (int i = 0; i < 256; ++i) {
      const int x = i - 128;
      cr_r[i] = (int)((91881 * x + one_half) >> 16);   // FIX(1.40200)
      cb_b[i] = (int)((116130 * x + one_half) >> 16);  // FIX(1.77200)
      cr_g[i] = -46802 * x;                            // FIX(0.71414)
      cb_g[i] = -22554 * x + one_half;                 // FIX(0.34414)
    }
    bool rgb = false;
    if (ncomp == 3) {
      if (jfif) rgb = false;
      else if (adobe) rgb = adobe_transform == 0;
      else rgb = comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;
    }
    std::vector<uint8_t> rows((size_t)4 * width);
    uint8_t* r0 = rows.data();
    uint8_t* r1 = r0 + width;
    uint8_t* r2 = r1 + width;
    uint8_t* r3 = r2 + width;
    for (int y = 0; y < height; ++y) {
      uint8_t* o = out + (size_t)y * width * 3;
      upsample_row(comp[0], y, r0);
      if (ncomp == 1) {
        for (int x = 0; x < width; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = r0[x];
        continue;
      }
      upsample_row(comp[1], y, r1);
      upsample_row(comp[2], y, r2);
      if (ncomp == 4) {  // CMYK as stored; OpenCV's CMYK -> BGR, as RGB
        upsample_row(comp[3], y, r3);
        for (int x = 0; x < width; ++x) {
          const int k = r3[x];
          o[3 * x] = (uint8_t)(k - (((255 - r0[x]) * k) >> 8));
          o[3 * x + 1] = (uint8_t)(k - (((255 - r1[x]) * k) >> 8));
          o[3 * x + 2] = (uint8_t)(k - (((255 - r2[x]) * k) >> 8));
        }
        continue;
      }
      if (rgb) {
        for (int x = 0; x < width; ++x) {
          o[3 * x] = r0[x];
          o[3 * x + 1] = r1[x];
          o[3 * x + 2] = r2[x];
        }
        continue;
      }
      for (int x = 0; x < width; ++x) {
        const int yy = r0[x], cb = r1[x], cr = r2[x];
        o[3 * x] = clamp255(yy + cr_r[cr]);
        o[3 * x + 1] = clamp255(yy + (int)((cb_g[cb] + cr_g[cr]) >> 16));
        o[3 * x + 2] = clamp255(yy + cb_b[cb]);
      }
    }
  }
};

int fail(const JpegError& e, char* msg, int msglen) {
  if (msg && msglen > 0) {
    strncpy(msg, e.msg.c_str(), msglen - 1);
    msg[msglen - 1] = 0;
  }
  return e.code;
}

// ---------------------------------------------------------------- encode

struct Writer {
  std::vector<uint8_t> out;
  uint64_t acc = 0;  // pending bits, right-aligned
  int nacc = 0;

  void u8(int b) { out.push_back((uint8_t)b); }
  void u16(int v) {
    u8(v >> 8);
    u8(v & 0xFF);
  }
  void bits(uint32_t code, int n) {
    acc = (acc << n) | (code & ((1u << n) - 1));
    nacc += n;
    while (nacc >= 8) {
      const int b = (int)(acc >> (nacc - 8)) & 0xFF;
      out.push_back((uint8_t)b);
      if (b == 0xFF) out.push_back(0);
      nacc -= 8;
    }
  }
  void flush() {  // pad the last byte with 1-bits
    if (nacc > 0) bits(0x7F, 8 - nacc);
    acc = 0;
    nacc = 0;
  }
};

struct EncHuff {
  uint16_t code[256];
  uint8_t size[256];
  // jpeg_make_c_derived_tbl
  void build(const uint8_t* bits, const uint8_t* vals) {
    memset(size, 0, sizeof(size));
    int c = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l]; ++i) {
        code[vals[k]] = (uint16_t)c++;
        size[vals[k]] = (uint8_t)l;
        ++k;
      }
      c <<= 1;
    }
  }
};

inline int nbits(int v) {
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

// jpeg_fdct_islow, in place on samples less 128
void fdct_islow(int32_t* d) {
  for (int r = 0; r < 8; ++r) {
    int32_t* p = d + 8 * r;
    int32_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int32_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int32_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int32_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (tmp10 + tmp11) * (1 << PASS1_BITS);
    p[4] = (tmp10 - tmp11) * (1 << PASS1_BITS);
    int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[2] = descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS - PASS1_BITS);
    p[6] = descale(z1 + tmp12 * (-FIX_1_847759065), CONST_BITS - PASS1_BITS);
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    const int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = descale(tmp4 + z1 + z3, CONST_BITS - PASS1_BITS);
    p[5] = descale(tmp5 + z2 + z4, CONST_BITS - PASS1_BITS);
    p[3] = descale(tmp6 + z2 + z3, CONST_BITS - PASS1_BITS);
    p[1] = descale(tmp7 + z1 + z4, CONST_BITS - PASS1_BITS);
  }
  for (int c = 0; c < 8; ++c) {
    int32_t* p = d + c;
    int32_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int32_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int32_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int32_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = descale(tmp10 + tmp11, PASS1_BITS);
    p[32] = descale(tmp10 - tmp11, PASS1_BITS);
    int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[16] = descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS + PASS1_BITS);
    p[48] = descale(z1 + tmp12 * (-FIX_1_847759065), CONST_BITS + PASS1_BITS);
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    const int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = descale(tmp4 + z1 + z3, CONST_BITS + PASS1_BITS);
    p[40] = descale(tmp5 + z2 + z4, CONST_BITS + PASS1_BITS);
    p[24] = descale(tmp6 + z2 + z3, CONST_BITS + PASS1_BITS);
    p[8] = descale(tmp7 + z1 + z4, CONST_BITS + PASS1_BITS);
  }
}

// jcdctmgr.c: compute_reciprocal with 16-bit DCTELEMs (the SIMD builds)
struct Divisor {
  uint32_t recip, corr;
  int shift;  // total right shift of the product
};

Divisor reciprocal(uint32_t divisor) {
  if (divisor == 1) return {1, 0, 0};
  int b = 0;
  while ((1u << (b + 1)) <= divisor) ++b;  // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (uint32_t)((1ull << r) / divisor);
  const uint32_t fr = (uint32_t)((1ull << r) % divisor);
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2u) {
    ++c;
  } else {
    ++fq;
  }
  return {fq & 0xFFFF, c & 0xFFFF, r};
}

inline int quantize(int32_t v, const Divisor& d) {
  const bool neg = v < 0;
  const uint32_t t = (uint32_t)((neg ? -v : v) + (int32_t)d.corr) & 0xFFFF;
  const int q = (int)(((uint64_t)t * d.recip) >> d.shift);
  return neg ? -q : q;
}

struct EncComp {
  int h, v, wb, hb;  // sampling factors, width/height in blocks
  int stride, rows;  // padded plane
  std::vector<uint8_t> plane;
  const Divisor* div;
  const EncHuff* dc;
  const EncHuff* ac;
  int pred = 0;
};

void encode_block(Writer& w, const int16_t* zz, EncComp& c) {
  // jchuff.c: encode_one_block
  int diff = zz[0] - c.pred;
  c.pred = zz[0];
  int t = diff < 0 ? -diff : diff;
  int t2 = diff < 0 ? diff - 1 : diff;
  int n = nbits(t);
  w.bits(c.dc->code[n], c.dc->size[n]);
  if (n) w.bits((uint32_t)t2, n);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    const int v = zz[k];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      w.bits(c.ac->code[0xF0], c.ac->size[0xF0]);
      run -= 16;
    }
    t = v < 0 ? -v : v;
    t2 = v < 0 ? v - 1 : v;
    n = nbits(t);
    const int sym = (run << 4) + n;
    w.bits(c.ac->code[sym], c.ac->size[sym]);
    w.bits((uint32_t)t2, n);
    run = 0;
  }
  if (run > 0) w.bits(c.ac->code[0], c.ac->size[0]);
}

void block_coefs(const EncComp& c, int bx, int by, int16_t* zz) {
  int32_t d[64];
  const uint8_t* src = c.plane.data() + (size_t)by * 8 * c.stride + bx * 8;
  for (int r = 0; r < 8; ++r)
    for (int x = 0; x < 8; ++x) d[8 * r + x] = (int32_t)src[(size_t)r * c.stride + x] - 128;
  fdct_islow(d);
  for (int k = 0; k < 64; ++k) zz[k] = (int16_t)quantize(d[kNatural[k]], c.div[kNatural[k]]);
}

std::vector<uint8_t> encode(const uint8_t* img, int w, int h, int ch, int quality) {
  // jcparam.c: jpeg_quality_scaling + jpeg_set_linear_quality(force_baseline)
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  int qtab[2][64];
  Divisor div[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) {
      long v = ((long)(t ? kStdChrQuant[i] : kStdLumQuant[i]) * scale + 50) / 100;
      v = v <= 0 ? 1 : (v > 255 ? 255 : v);
      qtab[t][i] = (int)v;
      div[t][i] = reciprocal((uint32_t)v << 3);
    }
  EncHuff hdc[2], hac[2];
  hdc[0].build(kDcLumBits, kDcLumVals);
  hac[0].build(kAcLumBits, kAcLumVals);
  hdc[1].build(kDcChrBits, kDcChrVals);
  hac[1].build(kAcChrBits, kAcChrVals);

  const int ncomp = ch == 1 ? 1 : 3;
  const int hmax = ncomp == 1 ? 1 : 2, vmax = hmax;
  const int mcux = (w + 8 * hmax - 1) / (8 * hmax);
  const int mcuy = (h + 8 * vmax - 1) / (8 * vmax);
  EncComp comp[3];
  for (int i = 0; i < ncomp; ++i) {
    EncComp& c = comp[i];
    c.h = c.v = (i == 0 && ncomp == 3) ? 2 : 1;
    const int dw = (w * c.h + hmax - 1) / hmax, dh = (h * c.v + vmax - 1) / vmax;
    c.wb = (dw + 7) / 8;
    c.hb = (dh + 7) / 8;
    c.stride = mcux * c.h * 8;
    c.rows = mcuy * c.v * 8;
    c.plane.assign((size_t)c.stride * c.rows, 0);
    c.div = div[i ? 1 : 0];
    c.dc = &hdc[i ? 1 : 0];
    c.ac = &hac[i ? 1 : 0];
  }
  if (ncomp == 1) {
    EncComp& c = comp[0];
    for (int y = 0; y < c.rows; ++y) {
      const uint8_t* s = img + (size_t)(y < h ? y : h - 1) * w;
      uint8_t* o = c.plane.data() + (size_t)y * c.stride;
      memcpy(o, s, w);
      memset(o + w, s[w - 1], c.stride - w);
    }
  } else {
    // jccolor.c: rgb_ycc_convert, then jcprepct.c's edge replication
    int32_t tab[8 * 256];
    const int32_t one_half = 1 << 15, cbcr_off = 128 << 16;
    for (int i = 0; i < 256; ++i) {
      tab[i] = 19595 * i;                                    // FIX(0.29900)
      tab[256 + i] = 38470 * i;                              // FIX(0.58700)
      tab[512 + i] = 7471 * i + one_half;                    // FIX(0.11400)
      tab[768 + i] = -11059 * i;                             // FIX(0.16874)
      tab[1024 + i] = -21709 * i;                            // FIX(0.33126)
      tab[1280 + i] = 32768 * i + cbcr_off + one_half - 1;   // FIX(0.5)
      tab[1536 + i] = -27439 * i;                            // FIX(0.41869)
      tab[1792 + i] = -5329 * i;                             // FIX(0.08131)
    }
    // full-size Y, Cb, Cr rows padded to an even height, each row
    // padded on the right to the chroma's expanded width
    const int h2 = h + (h & 1);
    const int fw = comp[1].stride * 2 > comp[0].stride ? comp[1].stride * 2 : comp[0].stride;
    std::vector<uint8_t> full((size_t)3 * fw * h2);
    for (int y = 0; y < h2; ++y) {
      const uint8_t* s = img + (size_t)(y < h ? y : h - 1) * w * 3;
      uint8_t* oy = full.data() + (size_t)y * fw;
      uint8_t* ob = oy + (size_t)fw * h2;
      uint8_t* orr = ob + (size_t)fw * h2;
      for (int x = 0; x < w; ++x) {
        const int r = s[3 * x], g = s[3 * x + 1], b = s[3 * x + 2];
        oy[x] = (uint8_t)((tab[r] + tab[256 + g] + tab[512 + b]) >> 16);
        ob[x] = (uint8_t)((tab[768 + r] + tab[1024 + g] + tab[1280 + b]) >> 16);
        orr[x] = (uint8_t)((tab[1280 + r] + tab[1536 + g] + tab[1792 + b]) >> 16);
      }
      memset(oy + w, oy[w - 1], fw - w);
      memset(ob + w, ob[w - 1], fw - w);
      memset(orr + w, orr[w - 1], fw - w);
    }
    EncComp& Y = comp[0];
    for (int y = 0; y < Y.rows; ++y)
      memcpy(Y.plane.data() + (size_t)y * Y.stride,
             full.data() + (size_t)(y < h2 ? y : h2 - 1) * fw, Y.stride);
    // jcsample.c: h2v2_downsample, bias 1, 2, 1, 2, ... along each row
    for (int ci = 1; ci < 3; ++ci) {
      EncComp& c = comp[ci];
      const uint8_t* src = full.data() + (size_t)ci * fw * h2;
      const int dh = h2 / 2;
      for (int y = 0; y < c.rows; ++y) {
        uint8_t* o = c.plane.data() + (size_t)y * c.stride;
        if (y >= dh) {
          memcpy(o, c.plane.data() + (size_t)(dh - 1) * c.stride, c.stride);
          continue;
        }
        const uint8_t* i0 = src + (size_t)(2 * y) * fw;
        const uint8_t* i1 = i0 + fw;
        int bias = 1;
        for (int x = 0; x < c.stride; ++x) {
          o[x] = (uint8_t)((i0[2 * x] + i0[2 * x + 1] + i1[2 * x] + i1[2 * x + 1] + bias) >> 2);
          bias ^= 3;
        }
      }
    }
  }

  Writer wr;
  wr.out.reserve((size_t)w * h * ch / 4 + 1024);
  wr.u16(0xFFD8);
  // JFIF APP0: version 1.01, no units, 1:1 density, no thumbnail
  wr.u16(0xFFE0);
  wr.u16(16);
  for (char ch8 : std::string("JFIF", 5)) wr.u8(ch8);
  wr.u8(1);
  wr.u8(1);
  wr.u8(0);
  wr.u16(1);
  wr.u16(1);
  wr.u8(0);
  wr.u8(0);
  for (int t = 0; t < (ncomp == 1 ? 1 : 2); ++t) {
    wr.u16(0xFFDB);
    wr.u16(67);
    wr.u8(t);
    for (int k = 0; k < 64; ++k) wr.u8(qtab[t][kNatural[k]]);
  }
  wr.u16(0xFFC0);
  wr.u16(8 + 3 * ncomp);
  wr.u8(8);
  wr.u16(h);
  wr.u16(w);
  wr.u8(ncomp);
  for (int i = 0; i < ncomp; ++i) {
    wr.u8(i + 1);
    wr.u8((comp[i].h << 4) | comp[i].v);
    wr.u8(i ? 1 : 0);
  }
  for (int t = 0; t < (ncomp == 1 ? 1 : 2); ++t)
    for (int ac = 0; ac < 2; ++ac) {
      const uint8_t* bits = ac ? (t ? kAcChrBits : kAcLumBits) : (t ? kDcChrBits : kDcLumBits);
      const uint8_t* vals = ac ? (t ? kAcChrVals : kAcLumVals) : (t ? kDcChrVals : kDcLumVals);
      int n = 0;
      for (int l = 1; l <= 16; ++l) n += bits[l];
      wr.u16(0xFFC4);
      wr.u16(2 + 1 + 16 + n);
      wr.u8((ac << 4) | t);
      for (int l = 1; l <= 16; ++l) wr.u8(bits[l]);
      for (int i = 0; i < n; ++i) wr.u8(vals[i]);
    }
  wr.u16(0xFFDA);
  wr.u16(6 + 2 * ncomp);
  wr.u8(ncomp);
  for (int i = 0; i < ncomp; ++i) {
    wr.u8(i + 1);
    wr.u8(i ? 0x11 : 0x00);
  }
  wr.u8(0);
  wr.u8(63);
  wr.u8(0);

  int16_t zz[64];
  if (ncomp == 1) {
    EncComp& c = comp[0];
    for (int by = 0; by < c.hb; ++by)
      for (int bx = 0; bx < c.wb; ++bx) {
        block_coefs(c, bx, by, zz);
        encode_block(wr, zz, c);
      }
  } else {
    for (int my = 0; my < mcuy; ++my)
      for (int mx = 0; mx < mcux; ++mx)
        for (int ci = 0; ci < 3; ++ci) {
          EncComp& c = comp[ci];
          int last_dc = 0;
          for (int y = 0; y < c.v; ++y)
            for (int x = 0; x < c.h; ++x) {
              const int bx = mx * c.h + x, by = my * c.v + y;
              if (bx < c.wb && by < c.hb) {
                block_coefs(c, bx, by, zz);
              } else {
                // jccoefct.c: a dummy block repeats the DC before it
                memset(zz, 0, sizeof(zz));
                zz[0] = (int16_t)last_dc;
              }
              last_dc = zz[0];
              encode_block(wr, zz, c);
            }
        }
  }
  wr.flush();
  wr.u16(0xFFD9);
  return std::move(wr.out);
}

}  // namespace

// Header of a JPEG: dims = {width, height, components, EXIF orientation}
// (`file_mode` as for jpeg_decode).
// Returns 0, 1 (corrupt, msg says why) or 2 (unsupported form).
extern "C" int jpeg_header(const uint8_t* data, size_t n, int file_mode,
                           int* dims, char* msg, int msglen) {
  try {
    Decoder d(data, n, file_mode != 0);
    if (n < 2 || data[0] != 0xFF || data[1] != 0xD8) corrupt("not a JPEG file");
    d.read_markers(true);
    if (!d.have_sof) corrupt("JPEG without SOF");
    // the orientation may follow the SOF: read on up to the first scan
    d.read_markers(false);
    dims[0] = d.width;
    dims[1] = d.height;
    dims[2] = d.ncomp;
    dims[3] = d.orientation;
    return kOk;
  } catch (const JpegError& e) {
    return fail(e, msg, msglen);
  }
}

// Decode to (height, width, 3) RGB in `out` (as stored, before the EXIF
// orientation, which the caller applies).  `file_mode`: the end of the
// bytes reads as EOI, as cv2.imread's file source has it (else it is
// refused, as cv2.imdecode refuses it).  Same returns as jpeg_header.
extern "C" int jpeg_decode(const uint8_t* data, size_t n, int file_mode,
                           uint8_t* out, size_t cap, char* msg, int msglen) {
  try {
    Decoder d(data, n, file_mode != 0);
    if (n < 2 || data[0] != 0xFF || data[1] != 0xD8) corrupt("not a JPEG file");
    d.decode_all();
    if ((size_t)d.width * d.height * 3 > cap) corrupt("output buffer too small");
    d.to_rgb(out);
    return kOk;
  } catch (const JpegError& e) {
    return fail(e, msg, msglen);
  }
}

// Decode a baseline 4:2:0 YCbCr JPEG as FFmpeg's mjpeg decoder does for a
// video frame (yuvj420p): the levels dequantised and put through FFmpeg's
// simple IDCT, no upsampling or colour conversion.  `out` receives Y
// (width x height), then Cb and Cr ((width + 1) / 2 x (height + 1) / 2);
// dims = {width, height}.  Other JPEG forms return 2 (unsupported).
extern "C" int jpeg_decode_yuv420(const uint8_t* data, size_t n, uint8_t* out,
                                  size_t cap, int* dims, char* msg,
                                  int msglen) {
  try {
    Decoder d(data, n, false);
    d.ffmpeg_idct = true;
    if (n < 2 || data[0] != 0xFF || data[1] != 0xD8) corrupt("not a JPEG file");
    d.read_markers(true);
    if (!d.have_sof) corrupt("JPEG without SOF");
    if (d.progressive) unsupported("a progressive MJPEG frame");
    if (d.ncomp != 3 || d.comp[0].h != 2 || d.comp[0].v != 2 ||
        d.comp[1].h != 1 || d.comp[1].v != 1 || d.comp[2].h != 1 ||
        d.comp[2].v != 1)
      unsupported("an MJPEG frame that is not 4:2:0 YCbCr");
    const int w = d.width, h = d.height, cw = (w + 1) / 2, ch = (h + 1) / 2;
    dims[0] = w;
    dims[1] = h;
    if ((size_t)w * h + 2 * (size_t)cw * ch > cap) return kOk;
    Decoder full(data, n, false);
    full.ffmpeg_idct = true;
    full.decode_all();
    for (int i = 0; i < 3; ++i) {
      const Comp& c = full.comp[i];
      const int pw = i ? cw : w, ph = i ? ch : h;
      if (c.plane.empty()) corrupt("MJPEG frame without a scan of every component");
      for (int y = 0; y < ph; ++y)
        memcpy(out + (size_t)y * pw, c.plane.data() + (size_t)y * c.stride, pw);
      out += (size_t)pw * ph;
    }
    return kOk;
  } catch (const JpegError& e) {
    return fail(e, msg, msglen);
  }
}

// Encode (h, w, ch) uint8, ch 1 (grey) or 3 (RGB), at `quality`.  Returns a
// malloc'd buffer (free it with jpeg_free) and its length in *len.
extern "C" uint8_t* jpeg_encode(const uint8_t* img, int w, int h, int ch,
                                int quality, size_t* len) {
  std::vector<uint8_t> v = encode(img, w, h, ch, quality);
  uint8_t* out = (uint8_t*)malloc(v.size());
  if (!out) return nullptr;
  memcpy(out, v.data(), v.size());
  *len = v.size();
  return out;
}

extern "C" void jpeg_free(uint8_t* p) { free(p); }
