// Fused identity ResNet bottleneck, for Hopper (sm_90a), on bf16 tensor
// cores through nvcuda::wmma (m16n16k16, f32 accumulators).
//
// Replaces: glsdet_tpu/ops/pallas_bottleneck.py: _kernel / fused_bottleneck
// (row bands of one image with a one-row halo, DMA'd by hand into two VMEM
// slots; conv1 on the halo'd band, the 3x3 as one im2col matmul, conv3 with
// the residual), which glsdet_tpu/ops/fused_infer.py runs for every
// identity Bottleneck (stride 1, in == 4C) of MP-Det's ResNet.
//
// Semantics, per output pixel, with BN folded into (w, b) and x rounded to
// bf16 (the wrapper's job):
//   y1 = bf16(relu(x @ w1 + b1))                 (4C -> C), f32 sums
//   y1 = 0 outside the image                     (the 3x3's zero padding)
//   y2 = bf16(relu(conv3x3(y1, w2) + b2))        (C -> C, SAME), f32 sums
//   y  = bf16(relu((y2 @ w3 + b3) + x))          (C -> 4C)
// w2 is (9C, C) in the JAX package's tap order: row (dh * 3 + dw) * C + ci.
// The plain version (glsdet_tpu_torch/ops/bottleneck_kernel.py:
// fused_bottleneck_plain) does the same operations; the two differ only in
// the order of the f32 sums, so an intermediate can round to the other
// neighbouring bf16 value.
//
// What bounds it on the H100 (from the SXM part's published peaks, 3.35
// TB/s and 989 dense bf16 TFLOP/s): at the path's shapes (1152 bucket,
// batch 16) the block moves x in and y out, 4 bytes per element of x, and
// does 34 C^2 FLOP per pixel; 0.41 ms of bytes against 0.19 ms of FLOPs at
// layer1 (C = 64), both about 0.19 ms at layer3 and layer4.  So the
// intermediates must stay on the chip, as on the TPU.  This first design
// keeps them in shared memory and is simple rather than fast:
//   - one block of 8 warps per (image, TH x 16 output tile); the conv1
//     result of the halo'd (TH + 2) x 18 tile is kept in shared memory (y1),
//     so x is read once plus a halo, and y1, y2 never reach device memory;
//   - conv1 streams the halo'd x tile and w1 through shared memory in
//     K-chunks of 64 (in column passes that fit 8 accumulators a warp);
//     out-of-image halo pixels are written to y1 as zeros;
//   - the 3x3 is a K = 9C product whose A operand is read straight out of
//     y1: with a tile 16 pixels wide, one WMMA row tile is one tile row, and
//     the 16 inputs of tap (dh, dw) are 16 consecutive y1 rows.  w2 streams
//     in K-chunks.  y2 then overwrites y1 (same buffer);
//   - conv3 runs in column passes of 4C with w3 in K-chunks; the epilogue
//     adds b3 and the residual (read from x in device memory), applies the
//     ReLU and stores 16 bytes a lane;
//   - every K loop is double-buffered: cp.async copies the next chunk into
//     the other of two staging slots while the warps multiply this one.
// Each warp holds a block of up to 8 accumulator fragments (WarpTile) and
// loads each A and B fragment once per K step for a row or column of them.
// Every epilogue goes through a per-warp 16 x 16 f32 scratch, so each lane
// knows the pixel and channels it writes.  No atomics: the result does not
// depend on block scheduling.  Every block re-reads the weights from L2
// (0.14 MB at C = 64, 8.4 MB at C = 512), the products are WMMA
// (mma.sync) from shared memory, and the tile is small where C is large:
// the speed is later work (TMA, wgmma, weights shared across a cluster).
//
// Shapes taken: C in {16, 32, 64, 128, 256, 512} (4C = 64 ... 2048), any
// B, H, W >= 1; x, out contiguous NHWC, all pointers 16-byte aligned.  The
// output tile is TH x 16 with TH = 8 for C <= 128, 4 for C = 256 and 2 for
// C = 512, so that shared memory (y1, two staging slots and the scratch:
// 80 KB at C = 16 to 223 KB at C = 512) fits the SM's 227 KB and the 3x3's
// accumulators fit 8 fragments a warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTW = 16;        // output tile width: one WMMA row tile
constexpr int kHW = kTW + 2;   // halo'd tile width
constexpr int kKC = 64;        // K rows staged per chunk
constexpr int kMaxFrags = 8;   // accumulator fragments per warp
constexpr int kPad = 8;        // bf16 row padding of the staging buffers

constexpr int pow2_floor(int v) {
  int p = 1;
  while (2 * p <= v) p *= 2;
  return p;
}
constexpr int cmin(int a, int b) { return a < b ? a : b; }
constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

// How 8 warps share an MT x NT grid of 16 x 16 output fragments: WM x WN
// warps, each holding FM x FN accumulators (m-tiles wm + i * WM, n-tiles
// wn + j * WN).  WN is chosen for the fewest fragment loads from shared
// memory per 16-deep K step: MT * WN A loads and 8 * FN B loads.
template <int MT_, int NT_>
struct WarpTile {
  static constexpr int MT = MT_, NT = NT_;
  static constexpr int pick() {
    int best = 0, best_loads = 1 << 30;
    for (int wn = 1; wn <= kWarps; wn *= 2) {
      const int fm = (MT + kWarps / wn - 1) / (kWarps / wn);
      if (NT % wn || fm * (NT / wn) > kMaxFrags) continue;
      const int loads = MT * wn + kWarps * (NT / wn);
      if (loads < best_loads) best = wn, best_loads = loads;
    }
    return best;
  }
  static constexpr int WN = pick();
  static_assert(WN > 0, "accumulators do not fit");
  static constexpr int WM = kWarps / WN;
  static constexpr int FM = (MT + WM - 1) / WM, FN = NT / WN;
};

template <int C>
struct Cfg {
  static constexpr int CIN = 4 * C;
  static constexpr int TH = C >= 512 ? 2 : (C >= 256 ? 4 : 8);
  static constexpr int P1 = (TH + 2) * kHW;     // halo'd tile pixels
  static constexpr int M1 = (P1 + 15) / 16 * 16;
  static constexpr int MT1 = M1 / 16;
  static constexpr int MT2 = TH;                // output row tiles
  static constexpr int CT = C / 16;
  // y1 / y2 rows: a multiple of 16 bf16 (32 bytes), since the 3x3 reads
  // fragments that start at any row
  static constexpr int LDC = C + 16;
  static constexpr int LDX = kKC + kPad;
  // column tiles per pass, so that a pass holds <= 8 fragments a warp
  static constexpr int NT1 = cmin(CT, pow2_floor(kWarps * kMaxFrags / MT1));
  static constexpr int NT3 = cmin(4 * CT, pow2_floor(kWarps * kMaxFrags / MT2));
  static constexpr int LDW1 = NT1 * 16 + kPad;
  static constexpr int LDW3 = NT3 * 16 + kPad;
  static constexpr int KC2 = cmin(C, kKC);      // divides 9C
  static constexpr int KC3 = cmin(C, kKC);
  using T1 = WarpTile<MT1, NT1>;
  using T2 = WarpTile<MT2, CT>;
  using T3 = WarpTile<MT2, NT3>;
  static constexpr int Y_BYTES = align128(M1 * LDC * 2);
  static constexpr int XS_BYTES = align128(M1 * LDX * 2);
  static constexpr int STAGE_BYTES = align128(cmax(
      XS_BYTES + kKC * LDW1 * 2, cmax(KC2 * LDC * 2, KC3 * LDW3 * 2)));
  static constexpr int SCRATCH_BYTES = kWarps * 256 * 4;
  static constexpr int SMEM = Y_BYTES + 2 * STAGE_BYTES + SCRATCH_BYTES;
  static_assert(SMEM <= 232448, "shared memory does not fit");
  static_assert(CIN % kKC == 0 && (9 * C) % KC2 == 0 && C % KC3 == 0,
                "K chunks");
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// 16-byte asynchronous copy global -> shared; src_bytes = 0 writes zeros
// and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// rows x cols bf16 block, global row stride gld -> shared row stride sld;
// cols a multiple of 8 (16-byte vectors)
__device__ __forceinline__ void stage(bf16* dst, int sld,
                                      const bf16* __restrict__ src,
                                      size_t gld, int rows, int cols) {
  const int vpr = cols / 8;
  for (int v = threadIdx.x; v < rows * vpr; v += kThreads) {
    const int r = v / vpr, c = (v % vpr) * 8;
    cp_async16(dst + r * sld + c, src + (size_t)r * gld + c, 16);
  }
}

// A K loop over n chunks, double-buffered: issue(k, slot) starts the copies
// of chunk k into one of two staging slots, compute(k, slot) multiplies it.
// Chunk k + 1 is in flight while chunk k is multiplied; the barriers make a
// chunk visible to every warp before its products and free its slot after.
template <typename Issue, typename Compute>
__device__ __forceinline__ void pipelined(int n, Issue&& issue,
                                          Compute&& compute) {
  issue(0, 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int k = 0; k < n; ++k) {
    if (k + 1 < n) issue(k + 1, (k + 1) & 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // chunk k is in
    __syncthreads();
    compute(k, k & 1);
    __syncthreads();
  }
}

template <class T>
using Acc = FragC[T::FM][T::FN];

template <class T>
__device__ __forceinline__ void zero(Acc<T>& acc) {
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
}

// One 16-deep K step of a warp's tile: acc[i][j] += A(mt) B(nt), where
// a(mt) and b(nt) point at the fragments in shared memory.  Each A and B
// fragment is loaded once and used FN and FM times.
template <class T, class PtrA, class PtrB>
__device__ __forceinline__ void warp_mma(Acc<T>& acc, int wm, int wn,
                                         PtrA&& a, int lda, PtrB&& b,
                                         int ldb) {
  FragB fb[T::FN];
#pragma unroll
  for (int j = 0; j < T::FN; ++j)
    wmma::load_matrix_sync(fb[j], b(wn + j * T::WN), ldb);
#pragma unroll
  for (int i = 0; i < T::FM; ++i) {
    const int mt = wm + i * T::WM;
    if (mt < T::MT) {
      FragA fa;
      wmma::load_matrix_sync(fa, a(mt), lda);
#pragma unroll
      for (int j = 0; j < T::FN; ++j)
        wmma::mma_sync(acc[i][j], fa, fb[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  uint4 out;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    h[j] = __halves2bfloat162(__float2bfloat16_rn(v[2 * j]),
                              __float2bfloat16_rn(v[2 * j + 1]));
  return out;
}

template <int C>
__global__ void __launch_bounds__(kThreads)
    bottleneck_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                      const float* __restrict__ b1,
                      const bf16* __restrict__ w2,
                      const float* __restrict__ b2,
                      const bf16* __restrict__ w3,
                      const float* __restrict__ b3, bf16* __restrict__ out,
                      int H, int W, int tiles_h, int tiles_w) {
  using K = Cfg<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ys = reinterpret_cast<bf16*>(smem);                    // y1, then y2
  unsigned char* slots = smem + K::Y_BYTES;   // two staging slots
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* scratch = reinterpret_cast<float*>(smem + K::Y_BYTES +
                                            2 * K::STAGE_BYTES) + warp * 256;
  // each lane of an epilogue owns row r, channels [c8, c8 + 8) of a tile
  const int r = lane >> 1, c8 = (lane & 1) * 8;

  int t = blockIdx.x;
  const int tw = t % tiles_w;
  t /= tiles_w;
  const int th = t % tiles_h;
  const int b = t / tiles_h;
  const int h0 = th * K::TH, w0 = tw * kTW;

  // ---- conv1 over the halo'd tile -> y1 (bf16, zero outside the image) --
  // chunk ck: column pass ck / KCH1, K rows [(ck % KCH1) * kKC, + kKC)
  constexpr int KCH1 = K::CIN / kKC;
  using T1 = typename K::T1;
  const int wm1 = warp / T1::WN, wn1 = warp % T1::WN;
  Acc<T1> acc1;
  pipelined(
      (C / (K::NT1 * 16)) * KCH1,
      [&](int ck, int s) {
        const int n0 = ck / KCH1 * K::NT1 * 16, k0 = ck % KCH1 * kKC;
        bf16* xs = reinterpret_cast<bf16*>(slots + s * K::STAGE_BYTES);
        for (int v = threadIdx.x; v < K::M1 * (kKC / 8); v += kThreads) {
          const int p = v / (kKC / 8), c = (v % (kKC / 8)) * 8;
          const bf16* src = x;  // read nothing: the row is zero-filled
          int bytes = 0;
          if (p < K::P1) {
            const int h = h0 - 1 + p / kHW, w = w0 - 1 + p % kHW;
            if (h >= 0 && h < H && w >= 0 && w < W) {
              src = x + (((size_t)b * H + h) * W + w) * K::CIN + k0 + c;
              bytes = 16;
            }
          }
          cp_async16(xs + p * K::LDX + c, src, bytes);
        }
        stage(reinterpret_cast<bf16*>(slots + s * K::STAGE_BYTES +
                                      K::XS_BYTES),
              K::LDW1, w1 + (size_t)k0 * C + n0, C, kKC, K::NT1 * 16);
      },
      [&](int ck, int s) {
        const bf16* xs = reinterpret_cast<bf16*>(slots + s * K::STAGE_BYTES);
        const bf16* w1s = reinterpret_cast<bf16*>(slots + s * K::STAGE_BYTES +
                                                  K::XS_BYTES);
        if (ck % KCH1 == 0) zero<T1>(acc1);
#pragma unroll
        for (int kk = 0; kk < kKC; kk += 16)
          warp_mma<T1>(
              acc1, wm1, wn1,
              [&](int mt) { return xs + mt * 16 * K::LDX + kk; }, K::LDX,
              [&](int nt) { return w1s + kk * K::LDW1 + nt * 16; }, K::LDW1);
        if (ck % KCH1 != KCH1 - 1) return;
        const int n0 = ck / KCH1 * K::NT1 * 16;
#pragma unroll
        for (int ij = 0; ij < T1::FM * T1::FN; ++ij) {
          const int i = ij / T1::FN, j = ij % T1::FN;
          const int mt = wm1 + i * T1::WM, nt = wn1 + j * T1::WN;
          if (mt < T1::MT) {
            wmma::store_matrix_sync(scratch, acc1[i][j], 16,
                                    wmma::mem_row_major);
            __syncwarp();
            const int p = mt * 16 + r, n = n0 + nt * 16 + c8;
            bool inside = false;
            if (p < K::P1) {
              const int h = h0 - 1 + p / kHW, w = w0 - 1 + p % kHW;
              inside = h >= 0 && h < H && w >= 0 && w < W;
            }
            float v[8];
#pragma unroll
            for (int e = 0; e < 8; ++e)
              v[e] = inside
                         ? fmaxf(scratch[r * 16 + c8 + e] + b1[n + e], 0.0f)
                         : 0.0f;
            *reinterpret_cast<uint4*>(ys + p * K::LDC + n) = pack8(v);
            __syncwarp();
          }
        }
      });

  // ---- conv2: 3x3 as K = 9C, A read straight out of y1 -------------------
  using T2 = typename K::T2;
  const int wm2 = warp / T2::WN, wn2 = warp % T2::WN;
  Acc<T2> acc2;
  zero<T2>(acc2);
  pipelined(
      9 * C / K::KC2,
      [&](int ck, int s) {
        stage(reinterpret_cast<bf16*>(slots + s * K::STAGE_BYTES), K::LDC,
              w2 + (size_t)ck * K::KC2 * C, C, K::KC2, C);
      },
      [&](int ck, int s) {
        const bf16* ws = reinterpret_cast<bf16*>(slots + s * K::STAGE_BYTES);
#pragma unroll
        for (int kk = 0; kk < K::KC2; kk += 16) {
          const int k = ck * K::KC2 + kk, tap = k / C, ci = k % C;
          const int dh = tap / 3, dw = tap % 3;
          warp_mma<T2>(
              acc2, wm2, wn2,
              [&](int mt) {
                return ys + ((mt + dh) * kHW + dw) * K::LDC + ci;
              },
              K::LDC, [&](int nt) { return ws + kk * K::LDC + nt * 16; },
              K::LDC);
        }
      });
  // every warp is done reading y1 (the loop's last barrier): y2 replaces it
#pragma unroll
  for (int ij = 0; ij < T2::FM * T2::FN; ++ij) {
    const int i = ij / T2::FN, j = ij % T2::FN;
    const int mt = wm2 + i * T2::WM, nt = wn2 + j * T2::WN;
    if (mt < T2::MT) {
      wmma::store_matrix_sync(scratch, acc2[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int n = nt * 16 + c8;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = fmaxf(scratch[r * 16 + c8 + e] + b2[n + e], 0.0f);
      *reinterpret_cast<uint4*>(ys + (mt * 16 + r) * K::LDC + n) = pack8(v);
      __syncwarp();
    }
  }

  // ---- conv3 + b3 + residual + relu -> out -------------------------------
  // chunk ck: column pass ck / KCH3, K rows [(ck % KCH3) * KC3, + KC3)
  constexpr int KCH3 = C / K::KC3;
  using T3 = typename K::T3;
  const int wm3 = warp / T3::WN, wn3 = warp % T3::WN;
  Acc<T3> acc3;
  pipelined(
      (K::CIN / (K::NT3 * 16)) * KCH3,
      [&](int ck, int s) {
        const int n0 = ck / KCH3 * K::NT3 * 16, k0 = ck % KCH3 * K::KC3;
        stage(reinterpret_cast<bf16*>(slots + s * K::STAGE_BYTES), K::LDW3,
              w3 + (size_t)k0 * K::CIN + n0, K::CIN, K::KC3, K::NT3 * 16);
      },
      [&](int ck, int s) {
        const bf16* ws = reinterpret_cast<bf16*>(slots + s * K::STAGE_BYTES);
        const int k0 = ck % KCH3 * K::KC3;
        if (ck % KCH3 == 0) zero<T3>(acc3);
#pragma unroll
        for (int kk = 0; kk < K::KC3; kk += 16)
          warp_mma<T3>(
              acc3, wm3, wn3,
              [&](int mt) { return ys + mt * 16 * K::LDC + k0 + kk; }, K::LDC,
              [&](int nt) { return ws + kk * K::LDW3 + nt * 16; }, K::LDW3);
        if (ck % KCH3 != KCH3 - 1) return;
        const int n0 = ck / KCH3 * K::NT3 * 16;
#pragma unroll
        for (int ij = 0; ij < T3::FM * T3::FN; ++ij) {
          const int i = ij / T3::FN, j = ij % T3::FN;
          const int mt = wm3 + i * T3::WM, nt = wn3 + j * T3::WN;
          if (mt < T3::MT) {
            wmma::store_matrix_sync(scratch, acc3[i][j], 16,
                                    wmma::mem_row_major);
            __syncwarp();
            const int h = h0 + mt, w = w0 + r, n = n0 + nt * 16 + c8;
            if (h < H && w < W) {
              const size_t off = (((size_t)b * H + h) * W + w) * K::CIN + n;
              const uint4 raw =
                  __ldg(reinterpret_cast<const uint4*>(x + off));
              const __nv_bfloat162* xr =
                  reinterpret_cast<const __nv_bfloat162*>(&raw);
              float v[8];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float2 xf = __bfloat1622float2(xr[e]);
                v[2 * e] = fmaxf((scratch[r * 16 + c8 + 2 * e] +
                                  b3[n + 2 * e]) + xf.x, 0.0f);
                v[2 * e + 1] = fmaxf((scratch[r * 16 + c8 + 2 * e + 1] +
                                      b3[n + 2 * e + 1]) + xf.y, 0.0f);
              }
              *reinterpret_cast<uint4*>(out + off) = pack8(v);
            }
            __syncwarp();
          }
        }
      });
}

template <int C>
int launch(const void* x, const void* w1, const float* b1, const void* w2,
           const float* b2, const void* w3, const float* b3, void* out,
           int batch, int h, int w, cudaStream_t stream) {
  using K = Cfg<C>;
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      K::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int tiles_h = (h + K::TH - 1) / K::TH, tiles_w = (w + kTW - 1) / kTW;
  const long long blocks = (long long)batch * tiles_h * tiles_w;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  bottleneck_kernel<C><<<(unsigned)blocks, kThreads, K::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), b1,
      static_cast<const bf16*>(w2), b2, static_cast<const bf16*>(w3), b3,
      static_cast<bf16*>(out), h, w, tiles_h, tiles_w);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out (B, H, W, 4C) bf16 NHWC; w1 (4C, C), w2 (9C, C), w3 (C, 4C) bf16
// row-major; b1, b2 (C,), b3 (4C,) f32.  Returns cudaErrorInvalidValue for
// a C the kernel does not take.
extern "C" int glsdet_fused_bottleneck(const void* x, const void* w1,
                                       const float* b1, const void* w2,
                                       const float* b2, const void* w3,
                                       const float* b3, void* out, int batch,
                                       int h, int w, int c,
                                       cudaStream_t stream) {
  switch (c) {
    case 16:
      return launch<16>(x, w1, b1, w2, b2, w3, b3, out, batch, h, w, stream);
    case 32:
      return launch<32>(x, w1, b1, w2, b2, w3, b3, out, batch, h, w, stream);
    case 64:
      return launch<64>(x, w1, b1, w2, b2, w3, b3, out, batch, h, w, stream);
    case 128:
      return launch<128>(x, w1, b1, w2, b2, w3, b3, out, batch, h, w, stream);
    case 256:
      return launch<256>(x, w1, b1, w2, b2, w3, b3, out, batch, h, w, stream);
    case 512:
      return launch<512>(x, w1, b1, w2, b2, w3, b3, out, batch, h, w, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
