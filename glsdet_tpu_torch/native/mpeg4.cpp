// MPEG-4 Part 2 (ISO/IEC 14496-2, "mp4v") decoding and encoding for
// data/video.py, equal to what cv2.VideoCapture (OpenCV's FFmpeg backend)
// decodes and readable by it.
//
// Decoding covers the Simple-profile tools FFmpeg's mpeg4 encoder (which
// cv2.VideoWriter runs for "mp4v", "XVID" and "DIVX") writes, and the port's
// own encoder below:
//   - VOS / VO / VOL / GOV / VOP headers, rectangular, progressive, 8-bit,
//     H.263 quantisation, half-pel motion;
//   - I- and P-VOP macroblocks: MCBPC, CBPY, DQUANT and not_coded, intra DC
//     with the DC scaler and its prediction, AC prediction with the
//     rescaling FFmpeg applies where the neighbour's quantiser differs, the
//     three escape modes of the AC VLC, H.263 dequantisation;
//   - 1MV motion with median prediction, f_code ranges, half-pel bilinear
//     compensation with vop_rounding_type, unrestricted vectors over
//     edge-extended references (the edge at the macroblock-aligned size,
//     where FFmpeg's decoder puts it);
//   - FFmpeg's simple IDCT (simple_idct_template.c at 8 bits), which its
//     decoder picks for streams tagged "Lavc" or untagged.
// Anything else (B- and S-VOPs, quarter-pel, interlace, data partitioning,
// resync markers, 4MV, MPEG quantisation, not_8_bit, non-rectangular
// shapes, short-video-header streams, complexity estimation, OBMC, newpred,
// scalability, not-coded VOPs, intra DC coded with the AC VLC
// (intra_dc_vlc_thr other than 0), streams tagged by XviD or DivX whose
// decoding FFmpeg changes) is refused with status 2 and yields no frame.
//
// The YUV 4:2:0 -> RGB step repeats swscale's yuv2rgb as cv2.VideoCapture
// runs it (to BGR24 with SWS_BICUBIC; see yuv420_to_rgb).
//
// Encoding writes I- and P-VOPs (a GOP of 12, as cv2.VideoWriter's) at a
// fixed quantiser, one finer (DQUANT) in flat macroblocks; AC prediction
// where it takes fewer bits; 1MV with a full-pel diamond search and a
// half-pel refinement, intra MBs where they cost less, not_coded MBs;
// integer DCT only, so equal frames give equal bytes on every machine.
// Each VOP written is decoded by the decoder above, which gives the next
// VOP's reference exactly.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <algorithm>

#include "simple_idct.h"

namespace {

using simple_idct::clip_pixel;

struct M4vError {
  int code;  // 1: corrupt stream, 2: unsupported feature
  std::string msg;
};

[[noreturn]] void corrupt(const std::string& m) { throw M4vError{1, m}; }
[[noreturn]] void unsupported(const std::string& m) { throw M4vError{2, m}; }

// ------------------------------------------------------------------ tables

struct Code { uint16_t code; uint8_t len; };

const Code kIntraMcbpc[9] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}, {1, 4},
                             {1, 6}, {2, 6}, {3, 6}, {1, 9}};
// FFmpeg's numbering: cbpc | 4 intra | 8 dquant | 16 four MVs; 20 stuffing
const Code kInterMcbpc[21] = {
    {1, 1}, {3, 4}, {2, 4}, {5, 6}, {3, 5}, {4, 8}, {3, 8}, {3, 7},
    {3, 3}, {7, 7}, {6, 7}, {5, 9}, {4, 6}, {4, 9}, {3, 9}, {2, 9},
    {2, 3}, {5, 7}, {4, 7}, {5, 8}, {1, 9}};
const Code kCbpy[16] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4},
                        {2, 6}, {11, 4}, {2, 5}, {3, 6}, {5, 4}, {10, 4},
                        {4, 4}, {8, 4}, {6, 4}, {3, 2}};
const Code kMv[33] = {
    {1, 1}, {1, 2}, {1, 3}, {1, 4}, {3, 6}, {5, 7}, {4, 7}, {3, 7},
    {11, 9}, {10, 9}, {9, 9}, {17, 10}, {16, 10}, {15, 10}, {14, 10},
    {13, 10}, {12, 10}, {11, 10}, {10, 10}, {9, 10}, {8, 10}, {7, 10},
    {6, 10}, {5, 10}, {4, 10}, {7, 11}, {6, 11}, {5, 11}, {4, 11},
    {3, 11}, {2, 11}, {3, 12}, {2, 12}};
const Code kDcLum[13] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3},
                         {1, 4}, {1, 5}, {1, 6}, {1, 7}, {1, 8},
                         {1, 9}, {1, 10}, {1, 11}};
const Code kDcChrom[13] = {{3, 2}, {2, 2}, {1, 2}, {1, 3}, {1, 4},
                           {1, 5}, {1, 6}, {1, 7}, {1, 8}, {1, 9},
                           {1, 10}, {1, 11}, {1, 12}};

// The AC VLCs: 102 (last, run, level) codes and the escape (index 102),
// sign bit after each.  Inter is H.263's TCOEF table; intra (MPEG-4 table
// B-16) uses the same codewords for other triples.
const Code kInterVlc[103] = {
    {0x2, 2}, {0xf, 4}, {0x15, 6}, {0x17, 7}, {0x1f, 8}, {0x25, 9},
    {0x24, 9}, {0x21, 10}, {0x20, 10}, {0x7, 11}, {0x6, 11}, {0x20, 11},
    {0x6, 3}, {0x14, 6}, {0x1e, 8}, {0xf, 10}, {0x21, 11}, {0x50, 12},
    {0xe, 4}, {0x1d, 8}, {0xe, 10}, {0x51, 12}, {0xd, 5}, {0x23, 9},
    {0xd, 10}, {0xc, 5}, {0x22, 9}, {0x52, 12}, {0xb, 5}, {0xc, 10},
    {0x53, 12}, {0x13, 6}, {0xb, 10}, {0x54, 12}, {0x12, 6}, {0xa, 10},
    {0x11, 6}, {0x9, 10}, {0x10, 6}, {0x8, 10}, {0x16, 7}, {0x55, 12},
    {0x15, 7}, {0x14, 7}, {0x1c, 8}, {0x1b, 8}, {0x21, 9}, {0x20, 9},
    {0x1f, 9}, {0x1e, 9}, {0x1d, 9}, {0x1c, 9}, {0x1b, 9}, {0x1a, 9},
    {0x22, 11}, {0x23, 11}, {0x56, 12}, {0x57, 12}, {0x7, 4}, {0x19, 9},
    {0x5, 11}, {0xf, 6}, {0x4, 11}, {0xe, 6}, {0xd, 6}, {0xc, 6},
    {0x13, 7}, {0x12, 7}, {0x11, 7}, {0x10, 7}, {0x1a, 8}, {0x19, 8},
    {0x18, 8}, {0x17, 8}, {0x16, 8}, {0x15, 8}, {0x14, 8}, {0x13, 8},
    {0x18, 9}, {0x17, 9}, {0x16, 9}, {0x15, 9}, {0x14, 9}, {0x13, 9},
    {0x12, 9}, {0x11, 9}, {0x7, 10}, {0x6, 10}, {0x5, 10}, {0x4, 10},
    {0x24, 11}, {0x25, 11}, {0x26, 11}, {0x27, 11}, {0x58, 12},
    {0x59, 12}, {0x5a, 12}, {0x5b, 12}, {0x5c, 12}, {0x5d, 12},
    {0x5e, 12}, {0x5f, 12}, {0x3, 7}};
const int8_t kInterRun[102] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 2, 2,
    2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 5, 6, 6, 6, 7, 7, 8, 8, 9, 9,
    10, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24,
    25, 26, 0, 0, 0, 1, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13,
    14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
    30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40};
const int8_t kInterLevel[102] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 1, 2, 3, 4, 5, 6, 1, 2,
    3, 4, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 2,
    1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2,
    3, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1};
const int kInterLast = 58;  // codes from here on end the block

const Code kIntraVlc[103] = {
    {0x2, 2}, {0x6, 3}, {0xf, 4}, {0xd, 5}, {0xc, 5}, {0x15, 6},
    {0x13, 6}, {0x12, 6}, {0x17, 7}, {0x1f, 8}, {0x1e, 8}, {0x1d, 8},
    {0x25, 9}, {0x24, 9}, {0x23, 9}, {0x21, 9}, {0x21, 10}, {0x20, 10},
    {0xf, 10}, {0xe, 10}, {0x7, 11}, {0x6, 11}, {0x20, 11}, {0x21, 11},
    {0x50, 12}, {0x51, 12}, {0x52, 12}, {0xe, 4}, {0x14, 6}, {0x16, 7},
    {0x1c, 8}, {0x20, 9}, {0x1f, 9}, {0xd, 10}, {0x22, 11}, {0x53, 12},
    {0x55, 12}, {0xb, 5}, {0x15, 7}, {0x1e, 9}, {0xc, 10}, {0x56, 12},
    {0x11, 6}, {0x1b, 8}, {0x1d, 9}, {0xb, 10}, {0x10, 6}, {0x22, 9},
    {0xa, 10}, {0xd, 6}, {0x1c, 9}, {0x8, 10}, {0x12, 7}, {0x1b, 9},
    {0x54, 12}, {0x14, 7}, {0x1a, 9}, {0x57, 12}, {0x19, 8}, {0x9, 10},
    {0x18, 8}, {0x23, 11}, {0x17, 8}, {0x19, 9}, {0x18, 9}, {0x7, 10},
    {0x58, 12}, {0x7, 4}, {0xc, 6}, {0x16, 8}, {0x17, 9}, {0x6, 10},
    {0x5, 11}, {0x4, 11}, {0x59, 12}, {0xf, 6}, {0x16, 9}, {0x5, 10},
    {0xe, 6}, {0x4, 10}, {0x11, 7}, {0x24, 11}, {0x10, 7}, {0x25, 11},
    {0x13, 7}, {0x5a, 12}, {0x15, 8}, {0x5b, 12}, {0x14, 8}, {0x13, 8},
    {0x1a, 8}, {0x15, 9}, {0x14, 9}, {0x13, 9}, {0x12, 9}, {0x11, 9},
    {0x26, 11}, {0x27, 11}, {0x5c, 12}, {0x5d, 12}, {0x5e, 12},
    {0x5f, 12}, {0x3, 7}};
const int8_t kIntraRun[102] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2,
    2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 5, 6, 6, 6, 7, 7, 7, 8, 8,
    9, 9, 10, 11, 12, 13, 14, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1,
    2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 12, 13, 14,
    15, 16, 17, 18, 19, 20};
const int8_t kIntraLevel[102] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18,
    19, 20, 21, 22, 23, 24, 25, 26, 27, 1, 2, 3, 4, 5, 6, 7, 8, 9,
    10, 1, 2, 3, 4, 5, 1, 2, 3, 4, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1,
    2, 3, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 2, 3, 4, 5, 6, 7, 8, 1,
    2, 3, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1};
const int kIntraLast = 67;

const uint8_t kZigzag[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
const uint8_t kAltHoriz[64] = {
    0, 1, 2, 3, 8, 9, 16, 17, 10, 11, 4, 5, 6, 7, 15, 14,
    13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
    30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
    46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};
const uint8_t kAltVert[64] = {
    0, 8, 16, 24, 1, 9, 2, 10, 17, 25, 32, 40, 48, 56, 57, 49,
    41, 33, 26, 18, 3, 11, 4, 12, 19, 27, 34, 42, 50, 58, 35, 43,
    51, 59, 20, 28, 5, 13, 6, 14, 21, 29, 36, 44, 52, 60, 37, 45,
    53, 61, 22, 30, 7, 15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};

// direct lookup of a prefix code: entry = symbol << 8 | length, -1 invalid
struct Vlc {
  int bits;
  std::vector<int32_t> tab;
  Vlc(const Code* c, int n, int bits_) : bits(bits_), tab(1u << bits_, -1) {
    for (int s = 0; s < n; s++) {
      int len = c[s].len, shift = bits - len;
      uint32_t first = (uint32_t)c[s].code << shift;
      for (uint32_t k = 0; k < (1u << shift); k++)
        tab[first + k] = (s << 8) | len;
    }
  }
};

struct RlTable {
  const Code* vlc;
  const int8_t* run;
  const int8_t* level;
  int last_from;
  int max_level[2][64];
  int max_run[2][64];
  Vlc lookup;
  RlTable(const Code* v, const int8_t* r, const int8_t* l, int lf)
      : vlc(v), run(r), level(l), last_from(lf), lookup(v, 103, 12) {
    memset(max_level, 0, sizeof max_level);
    memset(max_run, 0, sizeof max_run);
    for (int i = 0; i < 102; i++) {
      int last = i >= lf;
      max_level[last][r[i]] = std::max(max_level[last][r[i]], (int)l[i]);
      max_run[last][l[i]] = std::max(max_run[last][l[i]], (int)r[i]);
    }
  }
};

const Vlc& intra_mcbpc_vlc() { static Vlc v(kIntraMcbpc, 9, 9); return v; }
const Vlc& inter_mcbpc_vlc() { static Vlc v(kInterMcbpc, 21, 9); return v; }
const Vlc& cbpy_vlc() { static Vlc v(kCbpy, 16, 6); return v; }
const Vlc& mv_vlc() { static Vlc v(kMv, 33, 12); return v; }
const Vlc& dc_lum_vlc() { static Vlc v(kDcLum, 13, 11); return v; }
const Vlc& dc_chrom_vlc() { static Vlc v(kDcChrom, 13, 12); return v; }
const RlTable& intra_rl() {
  static RlTable t(kIntraVlc, kIntraRun, kIntraLevel, kIntraLast);
  return t;
}
const RlTable& inter_rl() {
  static RlTable t(kInterVlc, kInterRun, kInterLevel, kInterLast);
  return t;
}

inline int dc_scale(int q, bool luma) {
  if (luma) return q < 5 ? 8 : q < 9 ? 2 * q : q < 25 ? q + 8 : 2 * q - 16;
  return q < 5 ? 8 : q < 25 ? (q + 13) / 2 : q - 6;
}

inline int mid_pred(int a, int b, int c) {
  return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

// ------------------------------------------------------------- bit reader

struct Bits {
  std::vector<uint8_t> buf;  // the data and 8 zero bytes
  size_t nbits = 0, pos = 0;
  Bits(const uint8_t* d, size_t n) : buf(n + 8, 0), nbits(n * 8) {
    memcpy(buf.data(), d, n);
  }
  inline uint32_t peek() const {
    const uint8_t* p = buf.data() + (pos >> 3);
    uint64_t v = ((uint64_t)p[0] << 56) | ((uint64_t)p[1] << 48) |
                 ((uint64_t)p[2] << 40) | ((uint64_t)p[3] << 32) |
                 ((uint64_t)p[4] << 24);
    return (uint32_t)((v << (pos & 7)) >> 32);
  }
  inline uint32_t get(int k) {
    if (!k) return 0;
    uint32_t v = peek() >> (32 - k);
    pos += k;
    if (pos > nbits) corrupt("VOP data ends early");
    return v;
  }
  inline int get1() { return (int)get(1); }
  inline int sget(int k) {  // two's complement field
    int v = (int)get(k);
    return v >= (1 << (k - 1)) ? v - (1 << k) : v;
  }
  inline int vlc(const Vlc& t) {
    int e = t.tab[peek() >> (32 - t.bits)];
    if (e < 0) corrupt("invalid VLC code");
    pos += e & 255;
    if (pos > nbits) corrupt("VOP data ends early");
    return e >> 8;
  }
  void marker(const char* what) {
    if (!get1()) corrupt(std::string("marker bit missing in ") + what);
  }
  void align_next() { pos = (pos + 7) & ~(size_t)7; }
};

// ---------------------------------------------------- motion compensation

// size x size block at (x, y) of `ref` displaced by (mx, my) half-pels;
// samples outside [0, ew) x [0, eh) repeat the nearest edge sample
void mc(const uint8_t* ref, int stride, int ew, int eh, uint8_t* dst,
        int dstride, int x, int y, int size, int mx, int my, int rnd) {
  int ix = x + (mx >> 1), iy = y + (my >> 1), fx = mx & 1, fy = my & 1;
  uint8_t tmp[17 * 17];
  const uint8_t* src;
  int sstride;
  if (ix >= 0 && iy >= 0 && ix + size + fx <= ew && iy + size + fy <= eh) {
    src = ref + iy * stride + ix;
    sstride = stride;
  } else {
    for (int j = 0; j <= size; j++) {
      int yy = std::min(std::max(iy + j, 0), eh - 1);
      for (int i = 0; i <= size; i++) {
        int xx = std::min(std::max(ix + i, 0), ew - 1);
        tmp[j * 17 + i] = ref[yy * stride + xx];
      }
    }
    src = tmp;
    sstride = 17;
  }
  for (int j = 0; j < size; j++) {
    const uint8_t* a = src + j * sstride;
    const uint8_t* b = a + sstride;
    uint8_t* d = dst + j * dstride;
    if (!fx && !fy) {
      memcpy(d, a, size);
    } else if (fx && !fy) {
      for (int i = 0; i < size; i++) d[i] = (a[i] + a[i + 1] + 1 - rnd) >> 1;
    } else if (!fx && fy) {
      for (int i = 0; i < size; i++) d[i] = (a[i] + b[i] + 1 - rnd) >> 1;
    } else {
      for (int i = 0; i < size; i++)
        d[i] = (a[i] + a[i + 1] + b[i] + b[i + 1] + 2 - rnd) >> 2;
    }
  }
}

// The median MV predictor of a macroblock from its left, upper and
// upper-right neighbours (zero outside the VOP; the first row takes the
// left one alone).  mvs holds (x, y) half-pels of each MB, mbw a row.
void pred_motion(const int16_t* mvs, int mbw, int mbx, int mby, int* px,
                 int* py) {
  auto mv = [&](int x, int y, int k) {
    if (x < 0 || x >= mbw || y < 0) return 0;
    return (int)mvs[2 * (y * mbw + x) + k];
  };
  for (int k = 0; k < 2; k++)
    (k ? *py : *px) = mby == 0 ? mv(mbx - 1, 0, k)
                               : mid_pred(mv(mbx - 1, mby, k),
                                          mv(mbx, mby - 1, k),
                                          mv(mbx + 1, mby - 1, k));
}

// The DC predictor of the block at (x, y) of a grid of gw (stored,
// dequantised DCs; 1024 outside the VOP and for non-intra blocks): the
// left or the upper neighbour's, whichever the gradients choose, divided
// by the block's DC scaler.  *dir: 0 from the left, 1 from above.
int dc_predictor(const int16_t* D, int gw, int x, int y, int scale,
                 int* dir) {
  int A = x > 0 ? D[y * gw + x - 1] : 1024;
  int B = x > 0 && y > 0 ? D[(y - 1) * gw + x - 1] : 1024;
  int C = y > 0 ? D[(y - 1) * gw + x] : 1024;
  *dir = std::abs(A - B) < std::abs(B - C);
  return ((*dir ? C : A) + (scale >> 1)) / scale;
}

// The AC predictor of block n (FFmpeg's ff_mpeg4_pred_ac): the first
// column (dir 0, from the block on the left) or row (dir 1, from the block
// above) of the neighbour's levels, rescaled to quantiser q where the
// neighbour lies in a macroblock quantised otherwise (ROUNDED_DIV).  `own`
// is the block's 16 stored levels (first column, then first row) in a grid
// of width gw; outside the VOP the levels are zero.  Returns whether it
// rescaled.
bool ac_predictor(const int16_t* own, int gw, int x, int y, int n, int mbx,
                  int mby, int mbw, const int8_t* mbq, int q, int dir,
                  int pred[8]) {
  const int16_t* nb = nullptr;
  int nq = q;
  if (dir == 0) {
    if (x > 0) nb = own - 16;
    if (!(n == 1 || n == 3 || mbx == 0)) nq = mbq[mby * mbw + mbx - 1];
  } else {
    if (y > 0) nb = own - (size_t)gw * 16;
    if (!(n == 2 || n == 3 || mby == 0)) nq = mbq[(mby - 1) * mbw + mbx];
  }
  for (int k = 1; k < 8; k++) {
    int v = nb ? nb[dir == 0 ? k : 8 + k] : 0;
    if (nq != q) {
      int p = v * nq;
      v = (p > 0 ? p + (q >> 1) : p - (q >> 1)) / q;
    }
    pred[k] = v;
  }
  return nb && nq != q;
}

// what the decoder has met, for the tests: the tools each fixture covers
enum Tool { kToolIVop, kToolPVop, kToolIntraInP, kToolNotCoded,
            kToolDquant, kToolAcPred, kToolAcRescaled, kToolEsc1, kToolEsc2,
            kToolEsc3, kTools };

// ----------------------------------------------------------------- decoder

struct Vol {
  int width = 0, height = 0;
  int time_res = 0, time_bits = 1;
};

struct Picture {
  int w = 0, h = 0;  // macroblock-aligned luma size
  std::vector<uint8_t> p[3];
  void alloc(int w_, int h_) {
    w = w_;
    h = h_;
    p[0].assign((size_t)w * h, 0);
    p[1].assign((size_t)w * h / 4, 128);
    p[2].assign((size_t)w * h / 4, 128);
  }
  int stride(int c) const { return c ? w / 2 : w; }
};

struct Decoder {
  Vol vol;
  bool have_vol = false;
  int mbw = 0, mbh = 0;
  Picture cur, ref;
  bool have_ref = false;
  // per VOP
  int qscale = 0, rounding = 0, fcode = 1, dc_thr = 0;
  // per block: DC (dequantised) and the 7 + 7 AC levels of its first
  // column and row; luma grid 2 mbw x 2 mbh, chroma mbw x mbh
  std::vector<int16_t> dc[3], ac[3];
  std::vector<int8_t> mbq;     // quantiser of each MB
  std::vector<int16_t> mvs;    // (x, y) of each MB, half-pels
  int64_t tools[kTools] = {};

  void parse_vol(Bits& b);
  void parse_user_data(const uint8_t* d, size_t n);
  int decode(const uint8_t* data, size_t n);
  void decode_vop(Bits& b);
  void decode_mb(Bits& b, int mbx, int mby, bool pvop);
  void intra_block(Bits& b, int n, int mbx, int mby, bool coded, bool acpred,
                   int16_t* blk);
  int inter_block(Bits& b, bool coded, int16_t* blk);
  int decode_motion(Bits& b, int pred) const;
};

void Decoder::parse_user_data(const uint8_t* d, size_t n) {
  std::string s((const char*)d, std::min<size_t>(n, 64));
  if (s.compare(0, 4, "XviD") == 0 || s.compare(0, 4, "DivX") == 0)
    unsupported("a stream tagged '" + s.substr(0, 12) +
                "' (FFmpeg decodes it with its XviD IDCT or DivX workarounds)");
}

void Decoder::parse_vol(Bits& b) {
  b.get1();  // random_accessible_vol
  int type = b.get(8);
  if (type == 0x12) unsupported("a fine-granularity-scalable VOL");
  int verid = 1;
  if (b.get1()) {
    verid = b.get(4);
    b.get(3);
  }
  if (b.get(4) == 15) b.get(16);  // extended pixel aspect ratio
  if (b.get1()) {                 // vol_control_parameters
    if (b.get(2) != 1) unsupported("a chroma format other than 4:2:0");
    b.get1();  // low_delay
    if (b.get1()) {
      b.get(15); b.marker("VOL"); b.get(15); b.marker("VOL");
      b.get(15); b.marker("VOL"); b.get(3); b.get(11); b.marker("VOL");
      b.get(15); b.marker("VOL");
    }
  }
  if (b.get(2) != 0) unsupported("a non-rectangular VOL shape");
  b.marker("VOL");
  vol.time_res = b.get(16);
  if (!vol.time_res) corrupt("vop_time_increment_resolution 0");
  vol.time_bits = 1;
  while ((1 << vol.time_bits) < vol.time_res) vol.time_bits++;
  b.marker("VOL");
  if (b.get1()) b.get(vol.time_bits);  // fixed_vop_rate
  b.marker("VOL");
  int w = b.get(13);
  b.marker("VOL");
  int h = b.get(13);
  b.marker("VOL");
  if (b.get1()) unsupported("interlaced video");
  if (!b.get1()) unsupported("overlapped block motion compensation");
  if (b.get(verid == 1 ? 1 : 2)) unsupported("sprites (S-VOPs, GMC)");
  if (b.get1()) unsupported("not_8_bit video");
  if (b.get1()) unsupported("MPEG quantisation (quant_type 1)");
  if (verid != 1 && b.get1()) unsupported("quarter-pel motion");
  if (!b.get1()) unsupported("complexity estimation headers");
  if (!b.get1()) unsupported("resync markers");
  if (b.get1()) unsupported("data partitioning");
  if (verid != 1) {
    if (b.get1()) unsupported("newpred");
    if (b.get1()) unsupported("reduced-resolution VOPs");
  }
  if (b.get1()) unsupported("scalability");
  if (w <= 0 || h <= 0) corrupt("VOL size 0");
  if (have_vol && (w != vol.width || h != vol.height))
    unsupported("a VOL that changes the frame size");
  vol.width = w;
  vol.height = h;
  if (!have_vol) {
    mbw = (w + 15) / 16;
    mbh = (h + 15) / 16;
    cur.alloc(mbw * 16, mbh * 16);
    ref.alloc(mbw * 16, mbh * 16);
    dc[0].assign(4 * mbw * mbh, 1024);
    dc[1].assign(mbw * mbh, 1024);
    dc[2].assign(mbw * mbh, 1024);
    for (int c = 0; c < 3; c++) ac[c].assign(dc[c].size() * 16, 0);
    mbq.assign(mbw * mbh, 0);
    mvs.assign(2 * mbw * mbh, 0);
  }
  have_vol = true;
}

// Walks the start codes of one sample; returns 1 when a VOP was decoded
// into `cur`, 0 when the sample holds headers only.
int Decoder::decode(const uint8_t* data, size_t n) {
  auto next_code = [&](size_t from) {
    for (size_t k = from; k + 3 < n; k++)
      if (data[k] == 0 && data[k + 1] == 0 && data[k + 2] == 1) return k;
    return n;
  };
  size_t i = next_code(0);
  int got = 0;
  while (i < n) {
    if (i + 3 >= n) break;
    uint8_t code = data[i + 3];
    size_t body = i + 4, end = next_code(body);
    if (code <= 0x1F || code == 0xB0 || code == 0xB1 || code == 0xB3 ||
        code == 0xB5) {
      // VO, VOS start / end, GOV, visual object: nothing the decoding needs
      if (code == 0xB5 && body < n) {
        Bits b(data + body, end - body);
        int verid_flag = b.get1();
        if (verid_flag) b.get(7);
        int type = b.get(4);
        if (type != 1) unsupported("a visual object that is not video");
      }
    } else if (code >= 0x20 && code <= 0x2F) {
      Bits b(data + body, end - body);
      parse_vol(b);
    } else if (code == 0xB2) {
      parse_user_data(data + body, end - body);
    } else if (code == 0xB6) {
      if (!have_vol) corrupt("a VOP before any VOL");
      if (got) unsupported("two VOPs in one sample (packed B-frames)");
      Bits b(data + body, end - body);
      decode_vop(b);
      got = 1;
    } else {
      unsupported("start code 0x" + std::to_string(code));
    }
    i = end;
  }
  return got;
}

void Decoder::decode_vop(Bits& b) {
  int type = b.get(2);
  if (type == 2) unsupported("B-VOPs");
  if (type == 3) unsupported("S-VOPs (sprites, GMC)");
  if (type == 1 && !have_ref) corrupt("a P-VOP without a reference");
  while (b.get1()) {}  // modulo_time_base
  b.marker("VOP");
  b.get(vol.time_bits);
  b.marker("VOP");
  if (!b.get1()) unsupported("a not-coded VOP");
  rounding = type == 1 ? b.get1() : 0;
  dc_thr = b.get(3);
  if (dc_thr != 0)
    unsupported("intra_dc_vlc_thr " + std::to_string(dc_thr) +
                " (intra DC coded with the AC VLC)");
  qscale = b.get(5);
  if (!qscale) corrupt("vop_quant 0");
  fcode = 1;
  if (type == 1) {
    fcode = b.get(3);
    if (!fcode) corrupt("vop_fcode_forward 0");
  }
  for (int c = 0; c < 3; c++) {
    std::fill(dc[c].begin(), dc[c].end(), 1024);
    std::fill(ac[c].begin(), ac[c].end(), 0);
  }
  std::fill(mvs.begin(), mvs.end(), 0);
  tools[type == 1 ? kToolPVop : kToolIVop]++;
  for (int mby = 0; mby < mbh; mby++)
    for (int mbx = 0; mbx < mbw; mbx++) decode_mb(b, mbx, mby, type == 1);
  std::swap(cur, ref);  // the decoded VOP is the next reference
  have_ref = true;
}

int Decoder::decode_motion(Bits& b, int pred) const {
  int code = b.vlc(mv_vlc());
  if (code == 0) return pred;
  int sign = b.get1(), shift = fcode - 1, val = code;
  if (shift) {
    val = (val - 1) << shift;
    val |= b.get(shift);
    val++;
  }
  if (sign) val = -val;
  val += pred;
  int bits = 5 + fcode;  // wrap into [-2^(bits-1), 2^(bits-1))
  val = (int)((unsigned)val << (32 - bits)) >> (32 - bits);
  return val;
}

// Block geometry: grid plane, x, y, grid width
inline void block_pos(int n, int mbx, int mby, int mbw, int* c, int* x,
                      int* y, int* gw) {
  if (n < 4) {
    *c = 0;
    *x = 2 * mbx + (n & 1);
    *y = 2 * mby + (n >> 1);
    *gw = 2 * mbw;
  } else {
    *c = n - 3;
    *x = mbx;
    *y = mby;
    *gw = mbw;
  }
}

void Decoder::intra_block(Bits& b, int n, int mbx, int mby, bool coded,
                          bool acpred, int16_t* blk) {
  memset(blk, 0, 64 * sizeof(int16_t));
  bool luma = n < 4;
  int scale = dc_scale(qscale, luma);
  // DC: size, then the differential
  int size = b.vlc(luma ? dc_lum_vlc() : dc_chrom_vlc());
  int diff = 0;
  if (size) {
    int v = b.get(size);
    diff = (v >> (size - 1)) ? v : v - (1 << size) + 1;
    if (size > 8) b.marker("DC");
  }
  int c, x, y, gw;
  block_pos(n, mbx, mby, mbw, &c, &x, &y, &gw);
  std::vector<int16_t>& D = dc[c];
  int dir;
  int level = diff + dc_predictor(D.data(), gw, x, y, scale, &dir);
  int stored = level * scale;
  if (stored & ~2047) stored = stored < 0 ? 0 : 2047;
  D[y * gw + x] = (int16_t)stored;
  blk[0] = (int16_t)level;
  // AC levels
  if (coded) {
    const uint8_t* scan =
        !acpred ? kZigzag : dir == 0 ? kAltVert : kAltHoriz;
    const RlTable& rl = intra_rl();
    int i = 1;
    for (;;) {
      int sym = b.vlc(rl.lookup), last, run, lev;
      if (sym < 102) {
        last = sym >= rl.last_from;
        run = rl.run[sym];
        lev = rl.level[sym];
        if (b.get1()) lev = -lev;
      } else if (!b.get1()) {  // escape 1: level offset
        tools[kToolEsc1]++;
        sym = b.vlc(rl.lookup);
        if (sym >= 102) corrupt("escape after escape");
        last = sym >= rl.last_from;
        run = rl.run[sym];
        lev = rl.level[sym] + rl.max_level[last][run];
        if (b.get1()) lev = -lev;
      } else if (!b.get1()) {  // escape 2: run offset
        tools[kToolEsc2]++;
        sym = b.vlc(rl.lookup);
        if (sym >= 102) corrupt("escape after escape");
        last = sym >= rl.last_from;
        lev = rl.level[sym];
        run = rl.run[sym] + rl.max_run[last][lev] + 1;
        if (b.get1()) lev = -lev;
      } else {  // escape 3: fixed length
        tools[kToolEsc3]++;
        last = b.get1();
        run = b.get(6);
        b.marker("escape 3");
        lev = b.sget(12);
        b.marker("escape 3");
        if (!lev) corrupt("escape 3 level 0");
      }
      i += run;
      if (i > 63) corrupt("AC coefficient past the block");
      blk[scan[i]] = (int16_t)lev;
      i++;
      if (last) break;
    }
  }
  // AC prediction and the stored first column / row
  int16_t* own = &ac[c][(size_t)(y * gw + x) * 16];
  if (acpred) {
    int pred[8];
    tools[kToolAcRescaled] += ac_predictor(own, gw, x, y, n, mbx, mby, mbw,
                                       mbq.data(), qscale, dir, pred);
    for (int k = 1; k < 8; k++) {
      int16_t& v = dir == 0 ? blk[k * 8] : blk[k];
      v = (int16_t)(v + pred[k]);
    }
  }
  for (int k = 1; k < 8; k++) {
    own[k] = blk[k * 8];
    own[8 + k] = blk[k];
  }
  // H.263 dequantisation
  int qmul = 2 * qscale, qadd = (qscale - 1) | 1;
  blk[0] = (int16_t)(blk[0] * scale);
  for (int k = 1; k < 64; k++) {
    int v = blk[k];
    if (v) blk[k] = (int16_t)(v < 0 ? v * qmul - qadd : v * qmul + qadd);
  }
}

// returns whether the block has coefficients
int Decoder::inter_block(Bits& b, bool coded, int16_t* blk) {
  if (!coded) return 0;
  memset(blk, 0, 64 * sizeof(int16_t));
  const RlTable& rl = inter_rl();
  int qmul = 2 * qscale, qadd = (qscale - 1) | 1;
  int i = 0;
  for (;;) {
    int sym = b.vlc(rl.lookup), last, run, lev;
    bool esc3 = false;
    if (sym < 102) {
      last = sym >= rl.last_from;
      run = rl.run[sym];
      lev = rl.level[sym];
    } else if (!b.get1()) {
      tools[kToolEsc1]++;
      sym = b.vlc(rl.lookup);
      if (sym >= 102) corrupt("escape after escape");
      last = sym >= rl.last_from;
      run = rl.run[sym];
      lev = rl.level[sym] + rl.max_level[last][run];
    } else if (!b.get1()) {
      tools[kToolEsc2]++;
      sym = b.vlc(rl.lookup);
      if (sym >= 102) corrupt("escape after escape");
      last = sym >= rl.last_from;
      lev = rl.level[sym];
      run = rl.run[sym] + rl.max_run[last][lev] + 1;
    } else {
      tools[kToolEsc3]++;
      last = b.get1();
      run = b.get(6);
      b.marker("escape 3");
      lev = b.sget(12);
      b.marker("escape 3");
      if (!lev) corrupt("escape 3 level 0");
      esc3 = true;
    }
    int v;
    if (esc3) {
      v = lev > 0 ? lev * qmul + qadd : lev * qmul - qadd;
      if ((unsigned)(v + 2048) > 4095) v = v < 0 ? -2048 : 2047;
    } else {
      v = lev * qmul + qadd;
      if (b.get1()) v = -v;
    }
    i += run;
    if (i > 63) corrupt("AC coefficient past the block");
    blk[kZigzag[i]] = (int16_t)v;
    i++;
    if (last) break;
  }
  return 1;
}

const int kDquant[4] = {-1, -2, 1, 2};

void Decoder::decode_mb(Bits& b, int mbx, int mby, bool pvop) {
  int16_t blk[6][64];
  int mbi = mby * mbw + mbx;
  bool intra, dquant;
  int cbpc, cbp;
  bool acpred = false;
  int mx = 0, my = 0;
  Picture& P = cur;
  if (pvop) {
    int code;
    for (;;) {
      if (b.get1()) {  // not coded: the reference, unmoved
        tools[kToolNotCoded]++;
        for (int c = 0; c < 3; c++) {
          int s = c ? 8 : 16, st = P.stride(c);
          for (int j = 0; j < s; j++)
            memcpy(&P.p[c][(size_t)(mby * s + j) * st + mbx * s],
                   &ref.p[c][(size_t)(mby * s + j) * st + mbx * s], s);
        }
        mbq[mbi] = (int8_t)qscale;
        return;
      }
      code = b.vlc(inter_mcbpc_vlc());
      if (code != 20) break;
    }
    if (code & 16) unsupported("four motion vectors a macroblock (4MV)");
    intra = code & 4;
    dquant = code & 8;
    cbpc = code & 3;
  } else {
    int code;
    do code = b.vlc(intra_mcbpc_vlc());
    while (code == 8);
    intra = true;
    dquant = code & 4;
    cbpc = code & 3;
  }
  if (intra) acpred = b.get1();
  tools[kToolIntraInP] += pvop && intra;
  tools[kToolAcPred] += acpred;
  int cbpy = b.vlc(cbpy_vlc());
  if (!intra) cbpy ^= 15;
  cbp = cbpc | (cbpy << 2);
  if (dquant) {
    qscale = std::min(31, std::max(1, qscale + kDquant[b.get(2)]));
    tools[kToolDquant]++;
  }
  mbq[mbi] = (int8_t)qscale;
  if (intra) {
    for (int n = 0; n < 6; n++) {
      intra_block(b, n, mbx, mby, (cbp >> (5 - n)) & 1, acpred, blk[n]);
    }
    for (int n = 0; n < 6; n++) {
      int c = n < 4 ? 0 : n - 3, st = P.stride(c);
      int x = n < 4 ? mbx * 16 + (n & 1) * 8 : mbx * 8;
      int y = n < 4 ? mby * 16 + (n >> 1) * 8 : mby * 8;
      simple_idct::put(blk[n], &P.p[c][(size_t)y * st + x], st, false);
    }
    return;
  }
  int px, py;
  pred_motion(mvs.data(), mbw, mbx, mby, &px, &py);
  mx = decode_motion(b, px);
  my = decode_motion(b, py);
  mvs[2 * mbi] = (int16_t)mx;
  mvs[2 * mbi + 1] = (int16_t)my;
  // this MB is not intra: its neighbours predict no DC or AC from it
  for (int n = 0; n < 6; n++) {
    int c, x, y, gw;
    block_pos(n, mbx, mby, mbw, &c, &x, &y, &gw);
    dc[c][y * gw + x] = 1024;
    memset(&ac[c][(size_t)(y * gw + x) * 16], 0, 16 * sizeof(int16_t));
  }
  int coded[6];
  for (int n = 0; n < 6; n++)
    coded[n] = inter_block(b, (cbp >> (5 - n)) & 1, blk[n]);
  // prediction, then the residual
  int ew = mbw * 16, eh = mbh * 16;
  mc(ref.p[0].data(), P.w, ew, eh, &P.p[0][(size_t)mby * 16 * P.w + mbx * 16],
     P.w, mbx * 16, mby * 16, 16, mx, my, rounding);
  int cmx = (mx >> 1) | (mx & 1), cmy = (my >> 1) | (my & 1);
  for (int c = 1; c < 3; c++)
    mc(ref.p[c].data(), P.w / 2, ew >> 1, eh >> 1,
       &P.p[c][(size_t)mby * 8 * (P.w / 2) + mbx * 8], P.w / 2, mbx * 8,
       mby * 8, 8, cmx, cmy, rounding);
  for (int n = 0; n < 6; n++) {
    if (!coded[n]) continue;
    int c = n < 4 ? 0 : n - 3, st = P.stride(c);
    int x = n < 4 ? mbx * 16 + (n & 1) * 8 : mbx * 8;
    int y = n < 4 ? mby * 16 + (n >> 1) * 8 : mby * 8;
    simple_idct::put(blk[n], &P.p[c][(size_t)y * st + x], st, true);
  }
}

// ------------------------------------------------------------ YUV -> RGB

// swscale's conversion of yuv420p (or, full range, yuvj420p) to BGR24 as
// cv2.VideoCapture asks for it (sws_getCachedContext, SWS_BICUBIC, equal
// sizes): the unscaled yuv2rgb path, whose x86 SIMD (yuv_2_rgb.asm)
// works on samples shifted left by 3 with pmulhw (a product's high 16
// bits) by the coefficients yuv2rgb.c: ff_yuv2rgb_c_init_tables derives
// from ITU-R BT.601 (ff_yuv2rgb_coeffs[SWS_CS_DEFAULT]) at swscale's
// default contrast, saturation and brightness, or from the matrix an
// H.264 stream's VUI names (its matrix_coefficients, which OpenCV hands to
// swscale: 1 BT.709, 4 FCC, 7 SMPTE 240M, 9 BT.2020; every other value
// converts as BT.601).  Chroma is not interpolated: each 2x2 block of luma
// shares its chroma sample.
struct YuvCoeffs {
  int y, yoff, vr, ub, ug, vg;
};

inline int round_int16(int64_t f) {
  int64_t r = (f + (1 << 15)) >> 16;
  return (int)(r < -0x8000 ? -0x8000 : r > 0x7FFF ? 0x7FFF : r);
}

YuvCoeffs yuv_coeffs(bool full_range, int matrix) {
  int64_t crv = 104597, cbu = 132201, cgu = -25675, cgv = -53279;
  if (matrix == 1) crv = 117489, cbu = 138438, cgu = -13975, cgv = -34925;
  if (matrix == 4) crv = 104448, cbu = 132798, cgu = -24759, cgv = -53109;
  if (matrix == 7) crv = 117579, cbu = 136230, cgu = -16907, cgv = -35559;
  if (matrix == 9) crv = 110013, cbu = 140363, cgu = -12277, cgv = -42626;
  int64_t cy = 1 << 16, oy = 0;
  if (!full_range) {
    cy = (cy * 255) / 219;
    oy = 16 << 16;
  } else {
    crv = (crv * 224) / 255;
    cbu = (cbu * 224) / 255;
    cgu = (cgu * 224) / 255;
    cgv = (cgv * 224) / 255;
  }
  return {round_int16(cy * (1 << 13)), round_int16(oy * (1 << 3)),
          round_int16(crv * (1 << 13)), round_int16(cbu * (1 << 13)),
          round_int16(cgu * (1 << 13)), round_int16(cgv * (1 << 13))};
}

inline int mulhi(int a, int b) { return (a * b) >> 16; }


// ----------------------------------------------------------------- encoder

struct BitWriter {
  std::vector<uint8_t> out;
  uint64_t acc = 0;
  int n = 0;
  void put(uint32_t v, int k) {
    if (!k) return;
    acc = (acc << k) | (v & ((1ull << k) - 1));
    n += k;
    while (n >= 8) {
      n -= 8;
      out.push_back((uint8_t)(acc >> n));
    }
  }
  void code(const Code& c) { put(c.code, c.len); }
  // next_start_code(): a zero bit, then ones up to the byte boundary
  void stuffing() {
    put(0, 1);
    while (n) put(1, 1);
  }
  void start(uint8_t code) {
    put(0, 16);
    put(1, 8);
    put(code, 8);
  }
};

// BitWriter's interface, counting the bits only
struct BitCounter {
  int64_t bits = 0;
  void put(uint32_t, int k) { bits += k; }
  void code(const Code& c) { bits += c.len; }
};

// the forward DCT in integers: F = T X T^T with T the orthonormal DCT-II
// basis (MPEG-4's normalisation, DC = 8 x mean) scaled by 2^13 per pass
int dct_basis(int u, int x) {
  static const int base[9] = {4096, 4017, 3784, 3406, 2896, 2276, 1567, 799, 0};
  if (u == 0) return 2896;
  int k = ((2 * x + 1) * u) % 32;
  if (k > 16) k = 32 - k;
  return k > 8 ? -base[16 - k] : base[k];
}

void fdct(const int* in, int* out) {  // in, out: 8 x 8, row major
  static int T[8][8];
  static bool init = false;
  if (!init) {
    for (int u = 0; u < 8; u++)
      for (int x = 0; x < 8; x++) T[u][x] = dct_basis(u, x);
    init = true;
  }
  // |in| <= 255: the row sums stay below 2^24, the column sums below 2^28
  int tmp[8][8];  // tmp[y][u], scale 2^2
  for (int y = 0; y < 8; y++)
    for (int u = 0; u < 8; u++) {
      int a = 0;
      for (int x = 0; x < 8; x++) a += T[u][x] * in[y * 8 + x];
      tmp[y][u] = (a + (1 << 10)) >> 11;
    }
  for (int v = 0; v < 8; v++)
    for (int u = 0; u < 8; u++) {
      int a = 0;
      for (int y = 0; y < 8; y++) a += T[v][y] * tmp[y][u];
      out[v * 8 + u] = (a + (1 << 14)) >> 15;
    }
}

struct RlCodes {  // (last, run, level) -> VLC index, -1 where none
  int16_t idx[2][64][64];
  explicit RlCodes(const RlTable& t) {
    memset(idx, -1, sizeof idx);
    for (int i = 0; i < 102; i++)
      idx[i >= t.last_from][t.run[i]][t.level[i]] = (int16_t)i;
  }
  int find(int last, int run, int level) const {
    return run < 64 && level < 64 ? idx[last][run][level] : -1;
  }
};

const RlCodes& intra_codes() { static RlCodes c(intra_rl()); return c; }
const RlCodes& inter_codes() { static RlCodes c(inter_rl()); return c; }

template <class Sink>
void put_event(Sink& w, const RlTable& rl, const RlCodes& rc, int last,
               int run, int level) {
  int a = std::abs(level), sign = level < 0;
  int i = rc.find(last, run, a);
  if (i >= 0) {
    w.code(rl.vlc[i]);
    w.put(sign, 1);
    return;
  }
  const Code& esc = rl.vlc[102];
  int ml = rl.max_level[last][run];
  if (ml && a > ml && (i = rc.find(last, run, a - ml)) >= 0) {
    w.code(esc);
    w.put(0, 1);
    w.code(rl.vlc[i]);
    w.put(sign, 1);
    return;
  }
  if (a < 64) {
    int mr = rl.max_run[last][a];
    if (rl.max_level[last][0] >= a && run > mr &&
        (i = rc.find(last, run - mr - 1, a)) >= 0) {
      w.code(esc);
      w.put(2, 2);
      w.code(rl.vlc[i]);
      w.put(sign, 1);
      return;
    }
  }
  w.code(esc);
  w.put(3, 2);
  w.put(last, 1);
  w.put(run, 6);
  w.put(1, 1);
  w.put((uint32_t)level & 0xFFF, 12);
  w.put(1, 1);
}

// the levels of blk (natural order), in `scan` order from `first`, as
// (last, run, level) events
template <class Sink>
void put_block(Sink& w, const int16_t* lev, int first, bool intra,
               const uint8_t* scan = kZigzag) {
  const RlTable& rl = intra ? intra_rl() : inter_rl();
  const RlCodes& rc = intra ? intra_codes() : inter_codes();
  int lastpos = -1;
  for (int i = first; i < 64; i++)
    if (lev[scan[i]]) lastpos = i;
  int run = 0;
  for (int i = first; i <= lastpos; i++) {
    int v = lev[scan[i]];
    if (!v) {
      run++;
      continue;
    }
    put_event(w, rl, rc, i == lastpos, run, v);
    run = 0;
  }
}

struct Encoder {
  int w, h, mbw, mbh, q, gop, res, tinc;
  Decoder dec;  // decodes each VOP written: the references, exactly
  int frame = 0, rounding = 0;
  static const int kFcode = 2;
  std::vector<uint8_t> src[3];  // macroblock-aligned, edges repeated
  std::vector<int16_t> dcs[3];  // the decoder's DC predictors
  std::vector<int16_t> acs[3];  // and AC predictors (16 levels a block)
  std::vector<int8_t> mbq;      // each MB's quantiser
  std::vector<int16_t> mvs;
  int qrun = 0;                 // the running quantiser of the VOP

  // one intra MB as written: levels (natural order; AC-predicted ones
  // minus their predictor), DC differentials, scans, cbp, ac_pred_flag
  struct IntraMB {
    int16_t lev[6][64];
    int dcdiff[6];
    const uint8_t* scan[6];
    int cbp;
    bool acpred;
  };

  Encoder(int w_, int h_, int q_, int gop_, int res_, int tinc_)
      : w(w_), h(h_), q(q_), gop(gop_), res(res_), tinc(tinc_) {
    mbw = (w + 15) / 16;
    mbh = (h + 15) / 16;
    src[0].assign((size_t)mbw * 16 * mbh * 16, 0);
    src[1].assign((size_t)mbw * 8 * mbh * 8, 0);
    src[2].assign((size_t)mbw * 8 * mbh * 8, 0);
    dcs[0].assign(4 * mbw * mbh, 1024);
    dcs[1].assign(mbw * mbh, 1024);
    dcs[2].assign(mbw * mbh, 1024);
    for (int c = 0; c < 3; c++) acs[c].assign(dcs[c].size() * 16, 0);
    mbq.assign(mbw * mbh, 0);
    mvs.assign(2 * mbw * mbh, 0);
    std::vector<uint8_t> hdr = header();
    dec.decode(hdr.data(), hdr.size());
  }

  int time_bits() const {
    int b = 1;
    while ((1 << b) < res) b++;
    return b;
  }

  std::vector<uint8_t> header() const {
    BitWriter b;
    b.start(0xB0);
    b.put(1, 8);  // profile_and_level_indication: simple profile
    b.start(0xB5);
    b.put(0, 1);  // is_visual_object_identifier
    b.put(1, 4);  // video
    b.put(0, 1);  // video_signal_type
    b.stuffing();
    b.start(0x00);  // video object 0
    b.start(0x20);  // video object layer 0
    b.put(0, 1);
    b.put(1, 8);  // simple object type
    b.put(0, 1);  // is_object_layer_identifier
    b.put(1, 4);  // square pixels
    b.put(1, 1);  // vol_control_parameters
    b.put(1, 2);  // 4:2:0
    b.put(1, 1);  // low_delay
    b.put(0, 1);  // vbv_parameters
    b.put(0, 2);  // rectangular
    b.put(1, 1);
    b.put(res, 16);
    b.put(1, 1);
    b.put(0, 1);  // fixed_vop_rate
    b.put(1, 1);
    b.put(w, 13);
    b.put(1, 1);
    b.put(h, 13);
    b.put(1, 1);
    b.put(0, 1);  // interlaced
    b.put(1, 1);  // obmc_disable
    b.put(0, 1);  // sprite_enable
    b.put(0, 1);  // not_8_bit
    b.put(0, 1);  // quant_type: H.263
    b.put(1, 1);  // complexity_estimation_disable
    b.put(1, 1);  // resync_marker_disable
    b.put(0, 1);  // data_partitioned
    b.put(0, 1);  // scalability
    b.stuffing();
    return b.out;
  }

  void load(const uint8_t* y, const uint8_t* u, const uint8_t* v) {
    const uint8_t* in[3] = {y, u, v};
    for (int c = 0; c < 3; c++) {
      int pw = c ? w / 2 : w, ph = c ? h / 2 : h, sw = c ? mbw * 8 : mbw * 16,
          sh = c ? mbh * 8 : mbh * 16;
      for (int j = 0; j < sh; j++) {
        const uint8_t* row = in[c] + (size_t)std::min(j, ph - 1) * pw;
        uint8_t* o = &src[c][(size_t)j * sw];
        memcpy(o, row, pw);
        memset(o + pw, row[pw - 1], sw - pw);
      }
    }
  }

  // sum of absolute differences of the 16 x 16 luma at (x, y) against the
  // reference displaced by (mx, my) half-pels
  int sad(int x, int y, int mx, int my, int limit) const {
    const Picture& r = dec.ref;
    const int sw = mbw * 16;
    int ix = x + (mx >> 1), iy = y + (my >> 1);
    const uint8_t* ref;
    int rs;
    uint8_t pred[256];
    if (!(mx & 1) && !(my & 1) && ix >= 0 && iy >= 0 && ix + 16 <= r.w &&
        iy + 16 <= r.h) {
      ref = &r.p[0][(size_t)iy * r.w + ix];  // full pel, inside: no copy
      rs = r.w;
    } else {
      mc(r.p[0].data(), r.w, r.w, r.h, pred, 16, x, y, 16, mx, my, rounding);
      ref = pred;
      rs = 16;
    }
    int s = 0;
    for (int j = 0; j < 16 && s < limit; j++) {
      const uint8_t* a = &src[0][(size_t)(y + j) * sw + x];
      const uint8_t* b = ref + (size_t)j * rs;
      for (int i = 0; i < 16; i++) s += std::abs(a[i] - b[i]);
    }
    return s;
  }

  void block_pixels(int c, int x, int y, int* out) const {
    const int sw = c ? mbw * 8 : mbw * 16;
    for (int j = 0; j < 8; j++)
      for (int i = 0; i < 8; i++)
        out[j * 8 + i] = src[c][(size_t)(y + j) * sw + x + i];
  }

  static void block_origin(int n, int mbx, int mby, int* c, int* x, int* y) {
    *c = n < 4 ? 0 : n - 3;
    *x = n < 4 ? mbx * 16 + (n & 1) * 8 : mbx * 8;
    *y = n < 4 ? mby * 16 + (n >> 1) * 8 : mby * 8;
  }

  // an intra MB at quantiser qm: the DC and AC predictors exactly as the
  // decoder forms them, and AC prediction where it takes fewer bits
  void intra_mb(int mbx, int mby, int qm, IntraMB& m) {
    int16_t act[6][64], res[6][64];
    int dir[6];
    bool fits = true;
    mbq[mby * mbw + mbx] = (int8_t)qm;
    for (int n = 0; n < 6; n++) {
      int c, x, y, px[64], F[64];
      block_origin(n, mbx, mby, &c, &x, &y);
      block_pixels(c, x, y, px);
      fdct(px, F);
      int scale = dc_scale(qm, n < 4);
      int qdc = std::max(1, std::min(254, (F[0] + (scale >> 1)) / scale));
      int gc, gx, gy, gw;
      block_pos(n, mbx, mby, mbw, &gc, &gx, &gy, &gw);
      std::vector<int16_t>& D = dcs[gc];
      m.dcdiff[n] = qdc - dc_predictor(D.data(), gw, gx, gy, scale, &dir[n]);
      int stored = qdc * scale;
      if (stored & ~2047) stored = stored < 0 ? 0 : 2047;
      D[gy * gw + gx] = (int16_t)stored;
      act[n][0] = 0;
      for (int k = 1; k < 64; k++) {
        int a = std::min((std::abs(F[k]) * 8 + 6 * qm) / (16 * qm), 2047);
        act[n][k] = (int16_t)(F[k] < 0 ? -a : a);  // rounding + 3/8
      }
      int16_t* own = &acs[gc][(size_t)(gy * gw + gx) * 16];
      int ap[8];
      ac_predictor(own, gw, gx, gy, n, mbx, mby, mbw, mbq.data(), qm,
                   dir[n], ap);
      memcpy(res[n], act[n], sizeof act[n]);
      for (int k = 1; k < 8; k++) {
        int16_t& r = dir[n] ? res[n][k] : res[n][k * 8];
        int v = r - ap[k];
        fits &= v >= -2047 && v <= 2047;
        r = (int16_t)v;
        own[k] = act[n][k * 8];
        own[8 + k] = act[n][k];
      }
    }
    BitCounter plain, predicted;
    for (int n = 0; n < 6; n++) {
      put_block(plain, act[n], 1, true);
      put_block(predicted, res[n], 1, true, dir[n] ? kAltHoriz : kAltVert);
    }
    m.acpred = fits && predicted.bits < plain.bits;
    m.cbp = 0;
    for (int n = 0; n < 6; n++) {
      memcpy(m.lev[n], m.acpred ? res[n] : act[n], sizeof act[n]);
      m.scan[n] = !m.acpred ? kZigzag : dir[n] ? kAltHoriz : kAltVert;
      for (int k = 1; k < 64; k++)
        if (m.lev[n][k]) {
          m.cbp |= 32 >> n;
          break;
        }
    }
  }

  void put_intra(BitWriter& b, const IntraMB& m) {
    for (int n = 0; n < 6; n++) {
      int d = m.dcdiff[n], a = std::abs(d), size = 0;
      while (a >> size) size++;
      b.code(n < 4 ? kDcLum[size] : kDcChrom[size]);
      if (size) {
        b.put(d > 0 ? d : d + (1 << size) - 1, size);
        if (size > 8) b.put(1, 1);
      }
      if (m.cbp & (32 >> n)) put_block(b, m.lev[n], 1, true, m.scan[n]);
    }
  }

  // the MB's quantiser: one finer where the luma is flat (banding shows
  // there first), reached by DQUANT steps of at most 2 from the running
  // one
  int mb_quant(int mbx, int mby) const {
    int target = intra_cost(mbx, mby) < 3 * 256 ? std::max(1, q - 1) : q;
    return qrun + std::max(-2, std::min(2, target - qrun));
  }

  static void put_dquant(BitWriter& b, int dq) {
    b.put(dq == -1 ? 0 : dq == -2 ? 1 : dq == 1 ? 2 : 3, 2);
  }

  void forget_intra(int mbx, int mby) {
    for (int n = 0; n < 6; n++) {
      int c, x, y, gw;
      block_pos(n, mbx, mby, mbw, &c, &x, &y, &gw);
      dcs[c][y * gw + x] = 1024;
      memset(&acs[c][(size_t)(y * gw + x) * 16], 0, 16 * sizeof(int16_t));
    }
  }

  void put_mv(BitWriter& b, int v) {
    const int shift = kFcode - 1, range = 1 << (4 + kFcode);
    if (v < -range) v += 2 * range;
    if (v >= range) v -= 2 * range;
    if (!v) {
      b.code(kMv[0]);
      return;
    }
    int a = std::abs(v) - 1;
    b.code(kMv[(a >> shift) + 1]);
    b.put(v < 0, 1);
    b.put(a & ((1 << shift) - 1), shift);
  }

  // motion search: a small diamond at full pel from the best of a few
  // candidates, then the eight half-pel neighbours
  void search(int mbx, int mby, int* bx, int* by, int* best) {
    const int x = mbx * 16, y = mby * 16, lim = 2 * 24;
    int px, py;
    pred_motion(mvs.data(), mbw, mbx, mby, &px, &py);
    int cand[4][2] = {{0, 0}, {px & ~1, py & ~1}, {0, 0}, {0, 0}};
    int nc = 2;
    if (mbx > 0) {
      cand[nc][0] = mvs[2 * (mby * mbw + mbx - 1)] & ~1;
      cand[nc++][1] = mvs[2 * (mby * mbw + mbx - 1) + 1] & ~1;
    }
    if (mby > 0) {
      cand[nc][0] = mvs[2 * ((mby - 1) * mbw + mbx)] & ~1;
      cand[nc++][1] = mvs[2 * ((mby - 1) * mbw + mbx) + 1] & ~1;
    }
    *best = 1 << 30;
    for (int i = 0; i < nc; i++) {
      int s = sad(x, y, cand[i][0], cand[i][1], *best);
      if (s < *best) {
        *best = s;
        *bx = cand[i][0];
        *by = cand[i][1];
      }
    }
    static const int dia[4][2] = {{-2, 0}, {2, 0}, {0, -2}, {0, 2}};
    for (int it = 0; it < 32; it++) {
      int cx = *bx, cy = *by;
      for (auto& d : dia) {
        int mx = cx + d[0], my = cy + d[1];
        if (std::abs(mx) > lim || std::abs(my) > lim) continue;
        int s = sad(x, y, mx, my, *best);
        if (s < *best) {
          *best = s;
          *bx = mx;
          *by = my;
        }
      }
      if (*bx == cx && *by == cy) break;
    }
    int cx = *bx, cy = *by;
    for (int dy = -1; dy <= 1; dy++)
      for (int dx = -1; dx <= 1; dx++) {
        if (!dx && !dy) continue;
        int s = sad(x, y, cx + dx, cy + dy, *best);
        if (s < *best) {
          *best = s;
          *bx = cx + dx;
          *by = cy + dy;
        }
      }
  }

  // levels of the residual of an inter MB; returns cbp
  int inter_levels(int mbx, int mby, int mx, int my, int qm,
                   int16_t lev[6][64]) {
    const Picture& r = dec.ref;
    uint8_t pl[256], pc[2][64];
    mc(r.p[0].data(), r.w, r.w, r.h, pl, 16, mbx * 16, mby * 16, 16, mx, my,
       rounding);
    int cmx = (mx >> 1) | (mx & 1), cmy = (my >> 1) | (my & 1);
    for (int c = 1; c < 3; c++)
      mc(r.p[c].data(), r.w / 2, r.w / 2, r.h / 2, pc[c - 1], 8, mbx * 8,
         mby * 8, 8, cmx, cmy, rounding);
    int cbp = 0;
    for (int n = 0; n < 6; n++) {
      int c, x, y, px[64], F[64];
      block_origin(n, mbx, mby, &c, &x, &y);
      block_pixels(c, x, y, px);
      for (int k = 0; k < 64; k++) {
        int j = k >> 3, i = k & 7;
        px[k] -= n < 4 ? pl[((n >> 1) * 8 + j) * 16 + (n & 1) * 8 + i]
                       : pc[n - 4][j * 8 + i];
      }
      fdct(px, F);
      bool any = false;
      for (int k = 0; k < 64; k++) {
        int a = (std::abs(F[k]) * 4 - qm * 2) / (8 * qm);  // - 1/4
        a = std::max(0, std::min(a, 2047));
        lev[n][k] = (int16_t)(F[k] < 0 ? -a : a);
        any |= a != 0;
      }
      if (any) cbp |= 32 >> n;
    }
    return cbp;
  }

  int intra_cost(int mbx, int mby) const {
    const int sw = mbw * 16;
    int sum = 0;
    for (int j = 0; j < 16; j++)
      for (int i = 0; i < 16; i++)
        sum += src[0][(size_t)(mby * 16 + j) * sw + mbx * 16 + i];
    int mean = (sum + 128) >> 8, dev = 0;
    for (int j = 0; j < 16; j++)
      for (int i = 0; i < 16; i++)
        dev += std::abs(src[0][(size_t)(mby * 16 + j) * sw + mbx * 16 + i] -
                        mean);
    return dev;
  }

  std::vector<uint8_t> encode(const uint8_t* y, const uint8_t* u,
                              const uint8_t* v, int* key) {
    load(y, u, v);
    bool intra_vop = frame % gop == 0;
    *key = intra_vop;
    BitWriter b;
    int64_t t = (int64_t)frame * tinc;
    int secs = (int)(t / res);
    if (intra_vop) {
      b.start(0xB3);
      b.put(secs / 3600 % 24, 5);
      b.put(secs / 60 % 60, 6);
      b.put(1, 1);
      b.put(secs % 60, 6);
      b.put(1, 1);  // closed_gov
      b.put(0, 1);  // broken_link
      b.stuffing();
    }
    if (!intra_vop) rounding ^= 1;
    b.start(0xB6);
    b.put(intra_vop ? 0 : 1, 2);
    // modulo_time_base: the seconds since the GOV's time code or the
    // VOP before
    int base = intra_vop ? secs : (int)((int64_t)(frame - 1) * tinc / res);
    for (int s = base; s < secs; s++) b.put(1, 1);
    b.put(0, 1);
    b.put(1, 1);
    b.put((uint32_t)(t % res), time_bits());
    b.put(1, 1);
    b.put(1, 1);  // vop_coded
    if (!intra_vop) b.put(rounding, 1);
    b.put(0, 3);  // intra_dc_vlc_thr: the DC VLC throughout
    b.put(q, 5);
    if (!intra_vop) b.put(kFcode, 3);
    for (int c = 0; c < 3; c++) {
      std::fill(dcs[c].begin(), dcs[c].end(), 1024);
      std::fill(acs[c].begin(), acs[c].end(), 0);
    }
    std::fill(mvs.begin(), mvs.end(), 0);
    qrun = q;
    IntraMB m;
    int16_t lev[6][64];
    for (int mby = 0; mby < mbh; mby++)
      for (int mbx = 0; mbx < mbw; mbx++) {
        const int qm = mb_quant(mbx, mby), dq = qm - qrun;
        int mx = 0, my = 0, best = 0;
        if (!intra_vop) search(mbx, mby, &mx, &my, &best);
        if (intra_vop || intra_cost(mbx, mby) + 500 < best) {
          intra_mb(mbx, mby, qm, m);
          if (intra_vop) {
            b.code(kIntraMcbpc[(dq ? 4 : 0) | (m.cbp & 3)]);
          } else {
            b.put(0, 1);  // coded
            b.code(kInterMcbpc[(dq ? 12 : 4) | (m.cbp & 3)]);
          }
          b.put(m.acpred, 1);
          b.code(kCbpy[m.cbp >> 2]);
          if (dq) put_dquant(b, dq);
          qrun = qm;
          put_intra(b, m);
          continue;
        }
        forget_intra(mbx, mby);
        int cbp = inter_levels(mbx, mby, mx, my, qm, lev);
        if (!cbp && !mx && !my) {
          b.put(1, 1);  // not coded
          mbq[mby * mbw + mbx] = (int8_t)qrun;
          continue;
        }
        mbq[mby * mbw + mbx] = (int8_t)qm;
        int px, py;
        pred_motion(mvs.data(), mbw, mbx, mby, &px, &py);
        mvs[2 * (mby * mbw + mbx)] = (int16_t)mx;
        mvs[2 * (mby * mbw + mbx) + 1] = (int16_t)my;
        b.put(0, 1);
        b.code(kInterMcbpc[(dq ? 8 : 0) | (cbp & 3)]);
        b.code(kCbpy[(cbp >> 2) ^ 15]);
        if (dq) put_dquant(b, dq);
        qrun = qm;
        put_mv(b, mx - px);
        put_mv(b, my - py);
        for (int n = 0; n < 6; n++)
          if (cbp & (32 >> n)) put_block(b, lev[n], 0, false);
      }
    b.stuffing();
    frame++;
    int got = dec.decode(b.out.data(), b.out.size());
    if (!got) corrupt("the encoder wrote a VOP its decoder does not read");
    return b.out;
  }
};

int fail(const M4vError& e, char* msg, int msglen) {
  if (msg && msglen > 0) {
    strncpy(msg, e.msg.c_str(), msglen - 1);
    msg[msglen - 1] = 0;
  }
  return e.code;
}

}  // namespace

extern "C" {

void* m4v_open() { return new Decoder(); }

void m4v_close(void* h) { delete (Decoder*)h; }

// Feeds one sample (or a VOL configuration).  Returns 0 with got = 1 when a
// frame was decoded, 0 with got = 0 for headers only, 1 for a corrupt
// stream, 2 for an unsupported one (msg says what).
int m4v_decode(void* h, const uint8_t* data, size_t n, int* got, char* msg,
               int msglen) {
  Decoder* d = (Decoder*)h;
  try {
    *got = d->decode(data, n);
    return 0;
  } catch (const M4vError& e) {
    return fail(e, msg, msglen);
  }
}

// counts of the tools decoded so far (enum Tool's order, n of them)
void m4v_tools(void* h, int64_t* out, int n) {
  Decoder* d = (Decoder*)h;
  for (int i = 0; i < n && i < kTools; i++) out[i] = d->tools[i];
}

// width, height of the VOL (0, 0 before one)
void m4v_size(void* h, int* wh) {
  Decoder* d = (Decoder*)h;
  wh[0] = d->have_vol ? d->vol.width : 0;
  wh[1] = d->have_vol ? d->vol.height : 0;
}

// the last decoded frame's planes: Y (w x h), then U and V ((w+1)/2 x
// (h+1)/2)
void m4v_planes(void* h, uint8_t* out) {
  Decoder* d = (Decoder*)h;
  const Picture& P = d->ref;
  int w = d->vol.width, hh = d->vol.height, cw = (w + 1) / 2, ch = (hh + 1) / 2;
  for (int y = 0; y < hh; y++)
    memcpy(out + (size_t)y * w, &P.p[0][(size_t)y * P.w], w);
  out += (size_t)w * hh;
  for (int c = 1; c < 3; c++) {
    for (int y = 0; y < ch; y++)
      memcpy(out + (size_t)y * cw, &P.p[c][(size_t)y * (P.w / 2)], cw);
    out += (size_t)cw * ch;
  }
}

// Y (w x h), U, V ((w + 1) / 2 x (h + 1) / 2) -> (h, w, 3) RGB, as
// cv2.VideoCapture's BGR frame reversed
void yuv420_to_rgb(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                   int w, int h, int full_range, int matrix, uint8_t* rgb) {
  const YuvCoeffs k = yuv_coeffs(full_range != 0, matrix);
  const int cw = (w + 1) / 2;
  for (int j = 0; j < h; j++) {
    const uint8_t* yr = y + (size_t)j * w;
    const uint8_t* ur = u + (size_t)(j / 2) * cw;
    const uint8_t* vr = v + (size_t)(j / 2) * cw;
    uint8_t* o = rgb + (size_t)j * w * 3;
    for (int i = 0; i < w; i++) {
      int uu = ur[i / 2] * 8 - 1024, vv = vr[i / 2] * 8 - 1024;
      int yy = mulhi(yr[i] * 8 - k.yoff, k.y);
      o[3 * i] = clip_pixel(yy + mulhi(vv, k.vr));
      o[3 * i + 1] = clip_pixel(yy + mulhi(uu, k.ug) + mulhi(vv, k.vg));
      o[3 * i + 2] = clip_pixel(yy + mulhi(uu, k.ub));
    }
  }
}

// An encoder of (w, h) frames (both even) at quantiser q, an I-VOP every
// `gop` frames, vop_time_increment_resolution `res` and `tinc` of it a
// frame.  Returns nullptr with msg set on bad arguments.
void* m4v_enc_open(int w, int h, int q, int gop, int res, int tinc, char* msg,
                   int msglen) {
  try {
    if (w < 2 || h < 2 || (w & 1) || (h & 1) || w > 8190 || h > 8190)
      corrupt("frame size must be even, 2 to 8190");
    if (q < 1 || q > 31 || gop < 1 || res < 1 || res > 65535 || tinc < 1 ||
        tinc >= res * 64)
      corrupt("bad quantiser, GOP or time base");
    return new Encoder(w, h, q, gop, res, tinc);
  } catch (const M4vError& e) {
    fail(e, msg, msglen);
    return nullptr;
  }
}

void m4v_enc_close(void* h) { delete (Encoder*)h; }

// the VOS / VO / VOL header (the .mp4 esds configuration; an .avi carries
// it before the first VOP): written to out (cap bytes), its length returned
size_t m4v_enc_header(void* h, uint8_t* out, size_t cap) {
  std::vector<uint8_t> v = ((Encoder*)h)->header();
  if (v.size() <= cap) memcpy(out, v.data(), v.size());
  return v.size();
}

// Encodes planes Y (w x h), U, V (w/2 x h/2) as the next VOP.  Returns its
// length (written to out only if it fits cap), *key = 1 for an I-VOP; 0 on
// failure (msg says why).
size_t m4v_enc_frame(void* h, const uint8_t* y, const uint8_t* u,
                     const uint8_t* v, uint8_t* out, size_t cap, int* key,
                     char* msg, int msglen) {
  Encoder* e = (Encoder*)h;
  try {
    std::vector<uint8_t> bytes = e->encode(y, u, v, key);
    if (bytes.size() <= cap) memcpy(out, bytes.data(), bytes.size());
    return bytes.size();
  } catch (const M4vError& err) {
    fail(err, msg, msglen);
    return 0;
  }
}

// (h, w, 3) RGB -> BT.601 limited-range Y (w x h), U, V (w/2 x h/2, the
// mean of each 2 x 2), w and h even: what the decoder's yuv420_to_rgb
// inverts
void rgb_to_yuv420(const uint8_t* rgb, int w, int h, uint8_t* y, uint8_t* u,
                   uint8_t* v) {
  for (int j = 0; j < h; j++)
    for (int i = 0; i < w; i++) {
      const uint8_t* p = rgb + ((size_t)j * w + i) * 3;
      y[(size_t)j * w + i] =
          (uint8_t)(((66 * p[0] + 129 * p[1] + 25 * p[2] + 128) >> 8) + 16);
    }
  const int cw = w / 2;
  for (int j = 0; j < h / 2; j++)
    for (int i = 0; i < cw; i++) {
      int su = 0, sv = 0;
      for (int k = 0; k < 4; k++) {
        const uint8_t* p =
            rgb + ((size_t)(2 * j + (k >> 1)) * w + 2 * i + (k & 1)) * 3;
        su += -38 * p[0] - 74 * p[1] + 112 * p[2];
        sv += 112 * p[0] - 94 * p[1] - 18 * p[2];
      }
      u[(size_t)j * cw + i] = clip_pixel(((su + 512) >> 10) + 128);
      v[(size_t)j * cw + i] = clip_pixel(((sv + 512) >> 10) + 128);
    }
}

}  // extern "C"
