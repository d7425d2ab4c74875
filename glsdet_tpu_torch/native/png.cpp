// PNG row unfiltering (the five adaptive filters of the PNG standard,
// section 9) for data/image_io.py: the host side of reading training
// frames without OpenCV.  Sub and Up would vectorise in numpy, but
// Average and Paeth depend on the pixel to the left, so the rows are
// undone here, one pass over the decompressed stream.
//
// in:  height rows of (1 + stride) bytes, each a filter-type byte then the
//      filtered row, as zlib inflates them from the IDAT chunks;
// out: height * stride bytes, the reconstructed rows;
// bpp: bytes per complete pixel, at least 1 (the filter unit of section
//      9.2: 1 for bit depths below 8, 2 per sample at depth 16).
// Returns 0, or -(row + 1) of the first row with an unknown filter type.

#include <cstdint>
#include <cstdlib>

extern "C" int png_unfilter(const uint8_t* in, int height, int stride,
                            int bpp, uint8_t* out) {
  for (int y = 0; y < height; ++y) {
    const uint8_t* src = in + (size_t)y * (stride + 1);
    const int type = src[0];
    ++src;
    uint8_t* row = out + (size_t)y * stride;
    const uint8_t* up = y > 0 ? row - stride : nullptr;
    switch (type) {
      case 0:
        for (int i = 0; i < stride; ++i) row[i] = src[i];
        break;
      case 1:  // Sub
        for (int i = 0; i < stride; ++i)
          row[i] = (uint8_t)(src[i] + (i >= bpp ? row[i - bpp] : 0));
        break;
      case 2:  // Up
        for (int i = 0; i < stride; ++i)
          row[i] = (uint8_t)(src[i] + (up ? up[i] : 0));
        break;
      case 3:  // Average
        for (int i = 0; i < stride; ++i) {
          const int a = i >= bpp ? row[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          row[i] = (uint8_t)(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int i = 0; i < stride; ++i) {
          const int a = i >= bpp ? row[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          row[i] = (uint8_t)(src[i] + pred);
        }
        break;
      default:
        return -(y + 1);
    }
  }
  return 0;
}
