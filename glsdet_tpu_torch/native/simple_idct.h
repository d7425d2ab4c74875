// FFmpeg's simple IDCT at 8 bits (libavcodec/simple_idct_template.c:
// idctRowCondDC, then idctSparseColPut / idctSparseColAdd), the IDCT its
// MPEG-4 Part 2 and MJPEG decoders run for the streams the port reads.
// Integer arithmetic only, rows first, so the result is the same
// everywhere.  Shared by mpeg4.cpp and jpeg.cpp.

#pragma once

#include <cstdint>

namespace simple_idct {

inline uint8_t clip_pixel(int v) {
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

constexpr int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873,
          W6 = 8867, W7 = 4520;
constexpr int ROW_SHIFT = 11, COL_SHIFT = 20, DC_SHIFT = 3;

inline void idct_row(int16_t* row) {
  bool rest = false;
  for (int i = 1; i < 8; i++) rest |= row[i] != 0;
  if (!rest) {
    int16_t t = (int16_t)(uint16_t)((unsigned)row[0] << DC_SHIFT);
    for (int i = 0; i < 8; i++) row[i] = t;
    return;
  }
  uint32_t a0 = (uint32_t)(W4 * row[0]) + (1u << (ROW_SHIFT - 1));
  uint32_t a1 = a0, a2 = a0, a3 = a0;
  a0 += (uint32_t)(W2 * row[2]);
  a1 += (uint32_t)(W6 * row[2]);
  a2 -= (uint32_t)(W6 * row[2]);
  a3 -= (uint32_t)(W2 * row[2]);
  uint32_t b0 = (uint32_t)(W1 * row[1]) + (uint32_t)(W3 * row[3]);
  uint32_t b1 = (uint32_t)(W3 * row[1]) + (uint32_t)(-W7 * row[3]);
  uint32_t b2 = (uint32_t)(W5 * row[1]) + (uint32_t)(-W1 * row[3]);
  uint32_t b3 = (uint32_t)(W7 * row[1]) + (uint32_t)(-W5 * row[3]);
  if (row[4] | row[5] | row[6] | row[7]) {
    a0 += (uint32_t)(W4 * row[4] + W6 * row[6]);
    a1 += (uint32_t)(-W4 * row[4] - W2 * row[6]);
    a2 += (uint32_t)(-W4 * row[4] + W2 * row[6]);
    a3 += (uint32_t)(W4 * row[4] - W6 * row[6]);
    b0 += (uint32_t)(W5 * row[5]) + (uint32_t)(W7 * row[7]);
    b1 += (uint32_t)(-W1 * row[5]) + (uint32_t)(-W5 * row[7]);
    b2 += (uint32_t)(W7 * row[5]) + (uint32_t)(W3 * row[7]);
    b3 += (uint32_t)(W3 * row[5]) + (uint32_t)(-W1 * row[7]);
  }
  row[0] = (int16_t)((int)(a0 + b0) >> ROW_SHIFT);
  row[7] = (int16_t)((int)(a0 - b0) >> ROW_SHIFT);
  row[1] = (int16_t)((int)(a1 + b1) >> ROW_SHIFT);
  row[6] = (int16_t)((int)(a1 - b1) >> ROW_SHIFT);
  row[2] = (int16_t)((int)(a2 + b2) >> ROW_SHIFT);
  row[5] = (int16_t)((int)(a2 - b2) >> ROW_SHIFT);
  row[3] = (int16_t)((int)(a3 + b3) >> ROW_SHIFT);
  row[4] = (int16_t)((int)(a3 - b3) >> ROW_SHIFT);
}

// one column: out[k] (k = 0..7) before the final shift's clamp
inline void idct_col(const int16_t* col, int out[8]) {
  uint32_t a0 = (uint32_t)(W4 * (col[0] + ((1 << (COL_SHIFT - 1)) / W4)));
  uint32_t a1 = a0, a2 = a0, a3 = a0;
  a0 += (uint32_t)(W2 * col[16]);
  a1 += (uint32_t)(W6 * col[16]);
  a2 += (uint32_t)(-W6 * col[16]);
  a3 += (uint32_t)(-W2 * col[16]);
  uint32_t b0 = (uint32_t)(W1 * col[8]) + (uint32_t)(W3 * col[24]);
  uint32_t b1 = (uint32_t)(W3 * col[8]) + (uint32_t)(-W7 * col[24]);
  uint32_t b2 = (uint32_t)(W5 * col[8]) + (uint32_t)(-W1 * col[24]);
  uint32_t b3 = (uint32_t)(W7 * col[8]) + (uint32_t)(-W5 * col[24]);
  a0 += (uint32_t)(W4 * col[32]);
  a1 += (uint32_t)(-W4 * col[32]);
  a2 += (uint32_t)(-W4 * col[32]);
  a3 += (uint32_t)(W4 * col[32]);
  b0 += (uint32_t)(W5 * col[40]);
  b1 += (uint32_t)(-W1 * col[40]);
  b2 += (uint32_t)(W7 * col[40]);
  b3 += (uint32_t)(W3 * col[40]);
  a0 += (uint32_t)(W6 * col[48]);
  a1 += (uint32_t)(-W2 * col[48]);
  a2 += (uint32_t)(W2 * col[48]);
  a3 += (uint32_t)(-W6 * col[48]);
  b0 += (uint32_t)(W7 * col[56]);
  b1 += (uint32_t)(-W5 * col[56]);
  b2 += (uint32_t)(W3 * col[56]);
  b3 += (uint32_t)(-W1 * col[56]);
  out[0] = (int)(a0 + b0) >> COL_SHIFT;
  out[1] = (int)(a1 + b1) >> COL_SHIFT;
  out[2] = (int)(a2 + b2) >> COL_SHIFT;
  out[3] = (int)(a3 + b3) >> COL_SHIFT;
  out[4] = (int)(a3 - b3) >> COL_SHIFT;
  out[5] = (int)(a2 - b2) >> COL_SHIFT;
  out[6] = (int)(a1 - b1) >> COL_SHIFT;
  out[7] = (int)(a0 - b0) >> COL_SHIFT;
}

// add == false: dst = clamp(idct); add == true: dst = clamp(dst + idct)
inline void put(int16_t* blk, uint8_t* dst, int stride, bool add) {
  for (int i = 0; i < 8; i++) idct_row(blk + 8 * i);
  for (int x = 0; x < 8; x++) {
    int o[8];
    idct_col(blk + x, o);
    for (int y = 0; y < 8; y++) {
      uint8_t& p = dst[y * stride + x];
      p = clip_pixel(add ? p + o[y] : o[y]);
    }
  }
}

}  // namespace simple_idct
