// UFP mosaic painter for Hopper (sm_90a).
//
// Replaces: glsdet_tpu/ufp/pallas_paint.py: _paint_kernel /
// assemble_mosaic_pallas_batch (per (image, 256^2 canvas tile): DMA each
// region's source crop into VMEM, upscale x{1,2,4} with cv2 INTER_LINEAR
// taps, masked-blend into the tile, write the tile once).
//
// What it computes, per canvas pixel (X, Y) of image slot s: the last
// region row [x1, y1, w, h, nx, ny, f] (f > 0) whose canvas rectangle
// [nx, nx + w*f) x [ny, ny + h*f) holds the pixel paints it; uncovered
// pixels are 0.  Along each axis, with d = Y - ny, q = d / f, p = d % f,
// the cv2 source coordinate is y1 + q + frac, frac = (p + 0.5)/f - 0.5,
// sampled from the two neighbouring source rows.  Taps read the real
// neighbouring pixels of the source frame (the 1-px halo of the Pallas
// kernel) and 0 beyond the frame border (the Pallas kernel's zero pad).
// For f in {1, 2, 4} (what the packer emits) every tap weight is k/8, so
// the f32 value is exact in any order of its products and sums and
// equals the plain version bit for bit.
//
// One kernel body, three epilogues:
//   - the canvas entry (the Pallas kernel's own function): the f32 value,
//     or its round-to-nearest-even bf16 cast, 0 where nothing paints;
//   - the path entry: MP-Det's normalized bf16 input in one pass,
//     c = bf16(v), d = bf16(c - mean), out = bf16(d * inv_std), each step
//     rounded once as PyTorch's two bf16 ops round it (both are exact in
//     f32 before their rounding, so sub.rn/mul.rn.bf16 give the same
//     bits); uncovered pixels hold the normalized 0.
//
// What bounds it on the H100: bytes, the canvas written once (6 bytes a
// pixel in bf16).  The chips cover a small share of the canvas (12% of
// the path's 1280^2 canvases), and most of the canvas is the value of 0.
// The design keeps the store stream dense and spends lanes only where a
// chip paints:
//   - a block covers a band of kWarps canvas rows of one slot, one warp a
//     row; all its threads load the slot's region rows at once
//     (coalesced) and keep those that meet the band in shared memory, in
//     row order;
//   - each warp paints its row's owner map in shared memory (every row
//     that covers the canvas row writes its index over its x range, in
//     row order: the last one wins);
//   - the warp then walks the row in segments of 256 pixels: a segment
//     that no chip touches is stored straight from registers as the
//     repeating pattern of 0's value (16-byte stores, contiguous across
//     the warp); otherwise the segment is staged in shared memory, 32
//     consecutive pixels at a time go to the 32 lanes (so that the lanes
//     of one chip run the same code), skipping groups of 32 that no chip
//     covers, and the warp stores the segment contiguously;
//   - source bytes come as aligned 32-bit words, funnel-shifted into
//     place and turned into floats by a byte permute into 2^23 + b (no
//     conversion-unit instructions); power-of-two factors take shifts,
//     not divisions.
// A word load reads up to 3 bytes beside the pixels it needs; they lie in
// the same aligned word as a byte of the frame, so never on another page.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;            // canvas rows a block, a warp each
constexpr int kThreads = 32 * kWarps;
// 4 blocks an SM (64 registers a thread): a chip's pixels wait on their
// source loads, and more resident warps hide that (at 2 or 3 blocks the
// path's call is 35% or 10% slower; at 5 or more the registers spill)
constexpr int kMinBlocks = 4;
constexpr int kSeg = 256;            // pixels a warp stores at a time
constexpr int kMaxRows = 1024;       // region rows per slot
constexpr int kMaxWidth = 8192;      // canvas width (the owner maps)
constexpr int kMaxDevices = 64;
constexpr int kNone = 0xffff;        // no owner

enum Epilogue { kF32 = 0, kBF16 = 1, kNorm = 2 };

// dynamic shared memory of a launch (paint_kernel's layout)
inline size_t smem_bytes(int n_rows, int out_w, int out_bytes) {
  const size_t map_w = (size_t)(out_w + kSeg - 1) / kSeg * kSeg;
  return (size_t)n_rows * sizeof(int4) * 2 +
         (size_t)kWarps * kSeg * 3 * out_bytes + (size_t)kWarps * map_w * 2;
}

// A region row that meets the band, in canvas coordinates.
struct Hit {
  int nx, xend, ny, yend, x1, y1, f, shift;  // shift = log2 f, or -1
};

// Taps along one axis: source offset t0 (t0 + 1 is the other) from the
// crop origin, and their weights.
__device__ __forceinline__ void axis_taps(int d, int f, int shift, int* t0,
                                          float* w0, float* w1) {
  int q, p;
  float frac;
  if (shift >= 0) {
    q = d >> shift;
    p = d & ((1 << shift) - 1);
    // (p + 0.5) / f: the product by 2^-shift is exact
    frac = (float(p) + 0.5f) * __int_as_float((127 - shift) << 23) - 0.5f;
  } else {
    q = d / f;
    p = d - q * f;
    frac = __fdiv_rn(float(p) + 0.5f, float(f)) - 0.5f;
  }
  if (frac < 0.0f) {
    *t0 = q - 1;
    *w0 = -frac;
    *w1 = 1.0f + frac;
  } else {
    *t0 = q;
    *w0 = 1.0f - frac;
    *w1 = frac;
  }
}

// byte i of w as a float: the bits 2^23 + b, minus 2^23 (exact)
__device__ __forceinline__ float byte_f(uint32_t w, int i) {
  return __int_as_float(__byte_perm(w, 0x4B000000u, 0x7440u | i)) -
         8388608.0f;
}

// Source pixels sx and sx + 1 of one source row (3 channels each) as
// floats, 0 where a column lies outside the frame.  two == false: only sx
// is needed (its neighbour's weight is 0; v[3..5] are then any finite
// values).
__device__ __forceinline__ void load_pair(const uint8_t* row, int src_w,
                                          int sx, bool two, float v[6]) {
  const bool in0 = sx >= 0 && sx < src_w;
  const bool in1 = sx + 1 >= 0 && sx + 1 < src_w;
  if (in0 && (in1 || !two)) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(row + 3 * sx);
    const uint32_t* wp =
        reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
    const int o = int(a & 3);
    const int end = o + (two ? 6 : 3);
    const uint32_t w0 = __ldg(wp);
    const uint32_t w1 = end > 4 ? __ldg(wp + 1) : 0u;
    const uint32_t w2 = end > 8 ? __ldg(wp + 2) : 0u;
    const uint32_t lo = __funnelshift_r(w0, w1, 8 * o);
    const uint32_t hi = __funnelshift_r(w1, w2, 8 * o);
    v[0] = byte_f(lo, 0);
    v[1] = byte_f(lo, 1);
    v[2] = byte_f(lo, 2);
    v[3] = byte_f(lo, 3);
    v[4] = byte_f(hi, 0);
    v[5] = byte_f(hi, 1);
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      v[c] = in0 ? float(row[3 * sx + c]) : 0.0f;
      v[3 + c] = (two && in1) ? float(row[3 * (sx + 1) + c]) : 0.0f;
    }
  }
}

// Pixel (x, y)'s 3 channels from hit j, which covers it.
__device__ __forceinline__ void paint_pixel(const int4* __restrict__ hits,
                                            int j, int x, int y,
                                            const uint8_t* frame, int src_h,
                                            int src_w, float v[3]) {
  const int4 h0 = hits[2 * j], h1 = hits[2 * j + 1];
  const int f = h1.z, shift = h1.w;
  int ty, tx;
  float wy0, wy1, wx0, wx1;
  axis_taps(y - h0.z, f, shift, &ty, &wy0, &wy1);
  axis_taps(x - h0.x, f, shift, &tx, &wx0, &wx1);
  const int sy = h1.y + ty, sx = h1.x + tx;
  const bool two = wx1 != 0.0f;
  float a[6], b[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) a[c] = b[c] = 0.0f;
  if (sy >= 0 && sy < src_h)
    load_pair(frame + (size_t)sy * src_w * 3, src_w, sx, two, a);
  if (wy1 != 0.0f && sy + 1 >= 0 && sy + 1 < src_h)
    load_pair(frame + (size_t)(sy + 1) * src_w * 3, src_w, sx, two, b);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    v[c] = wy0 * (wx0 * a[c] + wx1 * a[3 + c]) +
           wy1 * (wx0 * b[c] + wx1 * b[3 + c]);
}

__device__ __forceinline__ uint16_t cvt_bf16(float x) {
  uint16_t r;
  asm("cvt.rn.bf16.f32 %0, %1;\n" : "=h"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ uint16_t sub_bf16(uint16_t a, uint16_t b) {
  uint16_t r;
  asm("sub.rn.bf16 %0, %1, %2;\n" : "=h"(r) : "h"(a), "h"(b));
  return r;
}

__device__ __forceinline__ uint16_t mul_bf16(uint16_t a, uint16_t b) {
  uint16_t r;
  asm("mul.rn.bf16 %0, %1, %2;\n" : "=h"(r) : "h"(a), "h"(b));
  return r;
}

// p[r] for r in {0, 1, 2}, by selects (no indexed copy in local memory)
template <typename T>
__device__ __forceinline__ T pick3(const T p[3], int r) {
  return r == 0 ? p[0] : (r == 1 ? p[1] : p[2]);
}

template <int E>
using OutT = typename std::conditional<E == kF32, float, uint16_t>::type;

// The stored value of f32 v: v, bf16(v), or bf16(bf16(bf16(v) - m) * i).
template <int E>
__device__ __forceinline__ OutT<E> epilogue(float v, uint16_t m,
                                            uint16_t i) {
  if constexpr (E == kF32) {
    return v;
  } else if constexpr (E == kBF16) {
    return cvt_bf16(v);
  } else {
    return mul_bf16(sub_bf16(cvt_bf16(v), m), i);
  }
}

template <int E>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    paint_kernel(const uint8_t* __restrict__ src, int n_src, int src_h,
                 int src_w, const int64_t* __restrict__ idx,
                 const float* __restrict__ rows, int n_rows,
                 void* __restrict__ out, int out_h, int out_w,
                 const uint16_t* __restrict__ mean,
                 const uint16_t* __restrict__ inv_std) {
  using Out = OutT<E>;
  constexpr int kVals = 16 / sizeof(Out);      // values in 16 bytes
  constexpr int kChunks = 3 * kSeg / kVals;    // 16-byte words a segment
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int map_w = (out_w + kSeg - 1) / kSeg * kSeg;
  // shared memory: [n_rows] hits (2 int4 each); per warp a staging buffer
  // of one segment and the owner map of its canvas row
  extern __shared__ int4 smem[];
  int4* hits = smem;
  uint4* stage =
      reinterpret_cast<uint4*>(hits + 2 * n_rows) + warp * kChunks;
  Out* stage_v = reinterpret_cast<Out*>(stage);
  uint16_t* omap = reinterpret_cast<uint16_t*>(
                       reinterpret_cast<uint4*>(hits + 2 * n_rows) +
                       kWarps * kChunks) +
                   warp * map_w;
  __shared__ int chunk_count[kMaxRows / 32];

  const int s = blockIdx.y;
  const int y0 = blockIdx.x * kWarps;
  const unsigned lt = (1u << lane) - 1u;
  const int64_t img = idx[s];
  const bool has_img = img >= 0 && img < n_src;

  // 1. the rows that meet the band, in row order: rows [32c, 32c + 32)
  //    are chunk c, read by warp c % kWarps
  constexpr int kRowChunks = kMaxRows / 32 / kWarps;
  Hit mine[kRowChunks];
  unsigned ballot[kRowChunks];
#pragma unroll
  for (int k = 0; k < kRowChunks; ++k) {
    const int c = k * kWarps + warp;
    const int r = c * 32 + lane;
    bool hit = false;
    if (has_img && r < n_rows) {
      const float* p = rows + ((size_t)s * n_rows + r) * 7;
      const int x1 = (int)p[0], y1 = (int)p[1], w = (int)p[2],
                h = (int)p[3], nx = (int)p[4], ny = (int)p[5],
                f = (int)p[6];
      mine[k] = {nx, nx + w * f, ny, ny + h * f, x1, y1, f,
                 (f & (f - 1)) == 0 ? __ffs(f) - 1 : -1};
      hit = f > 0 && w > 0 && h > 0 && ny < y0 + kWarps &&
            mine[k].yend > y0 && nx < out_w && mine[k].xend > 0;
    }
    ballot[k] = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) chunk_count[c] = __popc(ballot[k]);
  }
  __syncthreads();
  const int count = chunk_count[lane];
  int incl = count;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  const int n_band = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
  for (int k = 0; k < kRowChunks; ++k) {
    const int c = k * kWarps + warp;
    const int base = __shfl_sync(0xffffffffu, incl - count, c);
    if (ballot[k] >> lane & 1)
      reinterpret_cast<Hit*>(hits)[base + __popc(ballot[k] & lt)] = mine[k];
  }
  __syncthreads();

  const int y = y0 + warp;
  if (y >= out_h) return;

  // the stored value of 0 per channel, and as the 16-byte words of a
  // segment, whose pattern repeats every 3 words (a segment starts at a
  // pixel, and 3 words hold a whole number of pixels)
  uint16_t m[3] = {0, 0, 0}, is[3] = {0, 0, 0};
  if constexpr (E == kNorm) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      m[c] = mean[c];
      is[c] = inv_std[c];
    }
  }
  Out zero[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) zero[c] = epilogue<E>(0.0f, m[c], is[c]);
  uint4 zpat[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    union {
      Out v[kVals];
      uint4 u;
    } w;
#pragma unroll
    for (int e = 0; e < kVals; ++e) w.v[e] = zero[(q * kVals + e) % 3];
    zpat[q] = w.u;
  }

  // 2. the owner map of canvas row y: the band's rows that cover it, in
  //    row order, each over its x range (the last one wins)
  for (int q = lane; q < map_w / 8; q += 32)
    reinterpret_cast<uint4*>(omap)[q] =
        make_uint4(0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu);
  __syncwarp();
  for (int j = 0; j < n_band; ++j) {
    const int4 h0 = hits[2 * j];
    if (h0.z <= y && y < h0.w) {
      for (int x = max(h0.x, 0) + lane; x < min(h0.y, out_w); x += 32)
        omap[x] = (uint16_t)j;
      __syncwarp();
    }
  }
  __syncwarp();
  const uint8_t* frame =
      src + (has_img ? (size_t)img * src_h * src_w * 3 : 0);
  Out* row_out =
      static_cast<Out*>(out) + ((size_t)s * out_h + y) * out_w * 3;

  // 3. the row in segments of kSeg pixels
  for (int x0 = 0; x0 < out_w; x0 += kSeg) {
    const int n_vals = 3 * min(kSeg, out_w - x0);
    Out* o = row_out + (size_t)x0 * 3;
    const bool aligned = (reinterpret_cast<uintptr_t>(o) & 15) == 0 &&
                         n_vals % kVals == 0;
    // does a chip touch the segment?  (8 owners a lane)
    const uint4 ow = reinterpret_cast<const uint4*>(omap + x0)[lane];
    const bool touched = (ow.x & ow.y & ow.z & ow.w) != 0xffffffffu;
    if (!__any_sync(0xffffffffu, touched)) {
      if (aligned) {
        for (int q = lane; q < n_vals / kVals; q += 32)
          reinterpret_cast<uint4*>(o)[q] = pick3(zpat, q % 3);
      } else {
        for (int e = lane; e < n_vals; e += 32) o[e] = pick3(zero, e % 3);
      }
      continue;
    }
    for (int q = lane; q < kChunks; q += 32) stage[q] = pick3(zpat, q % 3);
    __syncwarp();
    // 32 consecutive pixels a step, one a lane; steps that no chip
    // covers are skipped
    for (int k = 0; k < kSeg; k += 32) {
      const int x = x0 + k + lane;
      const int j = omap[x];
      if (!__any_sync(0xffffffffu, j != kNone)) continue;
      if (j != kNone) {
        float v[3];
        paint_pixel(hits, j, x, y, frame, src_h, src_w, v);
#pragma unroll
        for (int c = 0; c < 3; ++c)
          stage_v[3 * (k + lane) + c] = epilogue<E>(v[c], m[c], is[c]);
      }
    }
    __syncwarp();
    if (aligned) {
      for (int q = lane; q < n_vals / kVals; q += 32)
        reinterpret_cast<uint4*>(o)[q] = stage[q];
    } else {
      for (int e = lane; e < n_vals; e += 32) o[e] = stage_v[e];
    }
    __syncwarp();
  }
}

template <int E>
int launch(const uint8_t* src, int n_src, int src_h, int src_w,
           const int64_t* idx, const float* rows, int batch, int n_rows,
           void* out, int out_h, int out_w, const void* mean,
           const void* inv_std, cudaStream_t stream) {
  if (n_rows < 0 || n_rows > kMaxRows || out_w > kMaxWidth)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n_rows, out_w, E == kF32 ? 4 : 2);
  // above 48 KB less the static part, a kernel must be granted more, on
  // each device it runs on
  static size_t granted[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > 47 * 1024 && smem > granted[dev]) {
    err = cudaFuncSetAttribute(paint_kernel<E>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    granted[dev] = smem;
  }
  const dim3 grid((out_h + kWarps - 1) / kWarps, batch);
  paint_kernel<E><<<grid, kThreads, smem, stream>>>(
      src, n_src, src_h, src_w, idx, rows, n_rows, out, out_h, out_w,
      static_cast<const uint16_t*>(mean),
      static_cast<const uint16_t*>(inv_std));
  return (int)cudaGetLastError();
}

}  // namespace

// src (N, H, W, 3) u8; idx (b,) i64 slots -> frames; rows (b, R, 7) f32
// integer-valued [x1, y1, w, h, nx, ny, f]; out (b, out_h, out_w, 3) f32
// (out_bf16 == 0) or bf16: the canvas.  R <= 1024, out_w <= 8192.
extern "C" int glsdet_paint_mosaic(const uint8_t* src, int n_src, int src_h,
                                   int src_w, const int64_t* idx,
                                   const float* rows, int batch, int n_rows,
                                   void* out, int out_h, int out_w,
                                   int out_bf16, cudaStream_t stream) {
  return out_bf16
             ? launch<kBF16>(src, n_src, src_h, src_w, idx, rows, batch,
                             n_rows, out, out_h, out_w, nullptr, nullptr,
                             stream)
             : launch<kF32>(src, n_src, src_h, src_w, idx, rows, batch,
                            n_rows, out, out_h, out_w, nullptr, nullptr,
                            stream);
}

// As glsdet_paint_mosaic, painted at hw x hw and normalized per channel
// with the bf16 mean (3,) and inv_std (3,): out (b, hw, hw, 3) bf16, the
// model input.
extern "C" int glsdet_paint_mosaic_inputs(const uint8_t* src, int n_src,
                                          int src_h, int src_w,
                                          const int64_t* idx,
                                          const float* rows, int batch,
                                          int n_rows, const void* mean,
                                          const void* inv_std, void* out,
                                          int hw, cudaStream_t stream) {
  return launch<kNorm>(src, n_src, src_h, src_w, idx, rows, batch, n_rows,
                       out, hw, hw, mean, inv_std, stream);
}
