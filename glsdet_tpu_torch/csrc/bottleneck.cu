// Fused identity ResNet bottleneck for Hopper (sm_90a): wgmma products,
// weight chunks multicast across a thread-block cluster by bulk copies
// under mbarriers, fed by a producer warp.
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
// neighbouring bf16 value.  No atomics: the result does not depend on
// block scheduling.
//
// What bounds it on the H100 (SXM part's published peaks, 3.35 TB/s and 989
// dense bf16 TFLOP/s): at the path's shapes (1152 bucket, batch 16) the
// launch must move x in and y out (4 bytes per element of x) and do 34 C^2
// FLOP per pixel: 0.41 ms of bytes at layer1 (C = 64), 0.20 at layer2,
// 0.19 ms of FLOPs at layer3 and layer4.  The intermediates therefore stay
// on the chip.  What the design does:
//   - one block per (TH x 16) output tile: two consumer warpgroups and a
//     producer warpgroup.  conv1 runs on the (TH + 2) x 18 halo'd tile and
//     its result y1 stays in shared memory (zero outside the image); the 3x3
//     reads y1 in place; y2 overwrites y1; conv3 adds b3 and the residual
//     and stores straight from the accumulators;
//   - products are wgmma.mma_async (m64nNk16, f32 accumulators in
//     registers).  A comes from registers, loaded by ldmatrix with one row
//     address per lane, so the 3x3's tap-shifted rows of y1 start at any
//     pixel and need no im2col buffer; y1 rows are padded by 16 bytes, so
//     the 8 rows of an ldmatrix hit 8 different bank groups;
//   - B (the weights) comes from a ring of shared-memory slots through
//     wgmma descriptors.  The weights are prepacked on the host
//     (ops/bottleneck_kernel.py: pack_weights) into K-chunks in the
//     no-swizzle core-matrix layout ([n / 8][k / 8][8 n][8 k] bf16, LBO 128
//     bytes, SBO 16 KC bytes), in the order the kernel reads them, so each
//     chunk is one contiguous cp.async.bulk copy and needs no tensor map;
//   - a cluster of CL blocks on consecutive tiles shares every weight
//     chunk: the cluster's first block multicasts it into all CL rings
//     (.multicast::cluster), so the weights leave L2 once per CL tiles.
//     Every consumer warp of the cluster releases a slot on every block's
//     "empty" barrier; each block's producer sets its own "full" barrier's
//     expected bytes.  A cluster may span two images (the weights are the
//     same), so only the last cluster tile has spare blocks: they join
//     every barrier and receive every multicast but load and store nothing;
//   - during conv1 each slot also holds its chunk's x (KC channels of the
//     halo'd tile, rows padded by 16 bytes), which the producer's other
//     three warps copy by 16-byte cp.async, zero-filled outside the image;
//     the slot's "full" barrier waits for those copies too
//     (cp.async.mbarrier.arrive), so x streams as deep as the weights;
//   - consumers wait on mbarriers, never on __syncthreads(); the two
//     warpgroups meet at a named barrier only between the three products
//     (y1 complete; y1 free for y2; y2 complete; y2 read);
//   - clusters are persistent: the launch starts as many as are resident
//     at once (cudaOccupancyMaxActiveClusters) and each walks the tiles
//     cid, cid + n, ...; the rings run on across tiles, so the producer
//     loads the next tile's x and weights while the consumers finish
//     this one's epilogues, and no cluster waits for four SMs of a GPC to
//     come free at once;
//   - the conv3 epilogue issues the residual loads of a column block
//     before its stores (a load may not pass a store to memory that could
//     alias it), so their latencies overlap;
//   - the producer's warpgroup (thread 0 issues the weight copies, three
//     warps the x copies) gives its registers to the consumers by
//     setmaxnreg: 232 a consumer thread at one block
//     per SM (at most 128 accumulator floats a thread by the plan below),
//     where ptxas alone would give every thread of a wgmma kernel of 384
//     threads 168 and spill.
//
// The tile plan, Cfg<C> (TH x 16 output pixels per block, CL blocks per
// cluster; per product the K rows per chunk KC, the columns per pass NCH
// and whether the two warpgroups split N or the 64-row M tiles; weight
// bytes leaving L2 per output pixel = 34 C^2 / (16 TH CL); halo factor
// (TH + 2) 18 / (16 TH) of conv1's rows; shared memory per block):
//
//   C    TH  CL  conv1 KC/NCH  conv2 KC/NCH  conv3 KC/NCH  L2 B/px  halo  slots    smem    blocks/SM
//   16    8   1  32/16  M      16/16  M      16/64   M         68   1.41  4 x 15K   69 KB  2
//   32    8   1  32/32  N      32/32  M      32/128  M        272   1.41  4 x 16K   79 KB  2
//   64    8   1  32/64  N      64/64  M      32/128  M       1088   1.41  4 x 18K   98 KB  2
//  128    8   2  64/128 N      64/128 M      64/256  M       2176   1.41  4 x 41K  213 KB  1
//  256    8   4  32/128 N      64/256 M      64/256  M       4352   1.41  4 x 32K  221 KB  1
//  512    4   4  32/256 M      32/512 N      32/512  N      34816   1.69  3 x 32K  206 KB  1
//
// (M / N: the two warpgroups split the 64-row M tiles or the columns.)
// Against the first design of this kernel (every block read all 17 C^2
// weights for its own TH x 16 tile, 34.8 KB per pixel at C = 256 (TH = 4),
// 278 KB at C = 512 (TH = 2)) that is 8.0x fewer weight bytes from L2 per pixel at
// both C = 256 and C = 512, and conv1's halo recompute falls from 1.69 to
// 1.41 at C = 256 and from 2.25 to 1.69 at C = 512.  Widths: a 16-wide tile
// pads W = 36 to 48 (1.33) and W = 72 to 80 (1.11), as before.  y2
// overwrites y1 once the 3x3's K loop is done, so conv2 runs in one pass.
//
// Shapes taken: C in {16, 32, 64, 128, 256, 512} (4C = 64 ... 2048), any
// B, H, W >= 1; x, out contiguous NHWC, all pointers 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer's warpgroup
constexpr int kTW = 16;                  // output tile width
constexpr int kHW = kTW + 2;             // halo'd tile width

constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }
constexpr int cmin(int a, int b) { return a < b ? a : b; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

// One product's plan: K rows per chunk, columns per pass, and whether the
// two warpgroups split the columns (each takes NCH / 2 of every M tile) or
// the M tiles (warpgroup g takes tiles g, g + 2, ...; all NCH columns).
template <int K_, int N_, int MT_, int KC_, int NCH_, bool SPLIT_N_>
struct Gemm {
  static constexpr int K = K_, N = N_, MT = MT_, KC = KC_, NCH = NCH_;
  static constexpr bool SPLIT_N = SPLIT_N_;
  static constexpr int PASSES = N / NCH, KCH = K / KC;
  static constexpr int CHUNKS = PASSES * KCH;
  static constexpr int CHUNK_BYTES = KC * NCH * 2;
  static constexpr int MTW = SPLIT_N ? MT : (MT + 1) / 2;  // M tiles a WG
  static constexpr int COLS = SPLIT_N ? NCH / 2 : NCH;     // columns a WG
  static constexpr int NW = cmin(64, COLS);                // wgmma width
  static constexpr int NI = COLS / NW;                     // wgmmas a row
  static_assert(K % KC == 0 && N % NCH == 0 && KC % 16 == 0, "chunks");
  static_assert(COLS % NW == 0 && (NW == 16 || NW == 32 || NW == 64),
                "wgmma width");
  static_assert(MTW * COLS <= 256, "accumulators: at most 128 a thread");
};

template <int C> struct Plan;
//                        TH CL  KC1 NCH1 N1?    KC2 NCH2 N2?    KC3 NCH3 N3?
template <> struct Plan<16>  { static constexpr int v[] = {8, 1, 32, 16, 0, 16, 16, 0, 16, 64, 0}; };
template <> struct Plan<32>  { static constexpr int v[] = {8, 1, 32, 32, 1, 32, 32, 0, 32, 128, 0}; };
template <> struct Plan<64>  { static constexpr int v[] = {8, 1, 32, 64, 1, 64, 64, 0, 32, 128, 0}; };
template <> struct Plan<128> { static constexpr int v[] = {8, 2, 64, 128, 1, 64, 128, 0, 64, 256, 0}; };
template <> struct Plan<256> { static constexpr int v[] = {8, 4, 32, 128, 1, 64, 256, 0, 64, 256, 0}; };
template <> struct Plan<512> { static constexpr int v[] = {4, 4, 32, 256, 0, 32, 512, 1, 32, 512, 1}; };

template <int C>
struct Cfg {
  using P = Plan<C>;
  static constexpr int CIN = 4 * C;
  static constexpr int TH = P::v[0], CL = P::v[1];
  static constexpr int P1 = (TH + 2) * kHW;      // halo'd tile pixels
  static constexpr int MT1 = (P1 + 63) / 64;     // conv1 M tiles
  static constexpr int MT2 = TH * kTW / 64;      // output M tiles
  static_assert(TH * kTW % 64 == 0, "output tile");
  using G1 = Gemm<CIN, C, MT1, P::v[2], P::v[3], P::v[4] != 0>;
  using G2 = Gemm<9 * C, C, MT2, P::v[5], P::v[6], P::v[7] != 0>;
  using G3 = Gemm<C, CIN, MT2, P::v[8], P::v[9], P::v[10] != 0>;
  static_assert(C % G2::KC == 0, "a conv2 chunk stays in one tap");
  static constexpr int LDC = C + 8;               // y1 / y2 row, bf16
  static constexpr int XLD = G1::KC + 8;          // x chunk row, bf16
  static constexpr int Y_BYTES = align128(P1 * LDC * 2);
  static constexpr int XS_BYTES = align128(P1 * XLD * 2);
  // a slot holds a weight chunk; during conv1 also the chunk's x, after it
  static constexpr int X_OFF = align128(G1::CHUNK_BYTES);
  static constexpr int SLOT = align128(cmax(
      X_OFF + XS_BYTES, cmax(G2::CHUNK_BYTES, G3::CHUNK_BYTES)));
  // accumulator floats a consumer thread holds, at most
  static constexpr int ACC = cmax(G1::MTW * G1::COLS,
                                  cmax(G2::MTW * G2::COLS,
                                       G3::MTW * G3::COLS)) / 2;
  // up to 4 slots; two blocks an SM where each fits 2 or more slots in
  // 113 KB and its accumulators the 104 registers a consumer thread then
  // gets (as many slots as keep them fitting)
  static constexpr int FIXED = Y_BYTES + 64;
  static constexpr int NSLOT_TWO =
      ACC <= 64 ? (113 * 1024 - FIXED) / SLOT : 0;
  static constexpr int NSLOT =
      NSLOT_TWO >= 2 ? cmin(4, NSLOT_TWO)
                     : cmin(4, (232448 - 1024 - FIXED) / SLOT);
  static_assert(NSLOT >= 2, "shared memory does not fit two slots");
  static constexpr int BAR_OFF = Y_BYTES + NSLOT * SLOT;
  static constexpr int SMEM = BAR_OFF + 8 * 2 * NSLOT;
  static constexpr int BLOCKS_PER_SM = NSLOT_TWO >= 2 ? 2 : 1;
};

// ---- PTX wrappers -------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// arrive on the barrier at the same offset in block `rank` of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}

// bytes from global memory into this block's shared memory, counted on
// `bar` of this block
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the same, into the same offset of every block in `mask`, each counted on
// its own `bar`
__device__ __forceinline__ void bulk_copy_multicast(uint32_t dst,
                                                    const void* src,
                                                    uint32_t bytes,
                                                    uint32_t bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

// named barrier of the two consumer warpgroups (id 1; 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* a, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// wgmma descriptor of a no-swizzle, K-major B tile: core matrices of 8
// rows (n) x 16 bytes (8 k), LBO between neighbours along K, SBO between
// neighbours along N
__device__ __forceinline__ uint64_t desc_b(uint32_t addr, uint32_t lbo,
                                           uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x N f32, N / 2 a thread) += a (64 x 16 bf16, 4 registers a
// thread, the mma.sync A fragment of each warp's 16 rows) * B (descriptor)
template <int N>
__device__ __forceinline__ void wgmma(float* d, const uint32_t* a,
                                      uint64_t b);

#define D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])

template <>
__device__ __forceinline__ void wgmma<16>(float* d, const uint32_t* a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, "
      "p, 1, 1, 0;\n}\n"
      : D4(0), D4(4)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<32>(float* d, const uint32_t* a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : D4(0), D4(4), D4(8), D4(12)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<64>(float* d, const uint32_t* a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : D4(0), D4(4), D4(8), D4(12), D4(16), D4(20), D4(24), D4(28)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef D4

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h =
      __halves2bfloat162(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Where the kernel is in the ring: chunk g of the launch (all products in
// order) sits in slot g % NSLOT, and its barriers are in phase g / NSLOT.
struct Ring {
  uint32_t full, empty;  // shared addresses of the barrier arrays
  __device__ __forceinline__ uint32_t full_bar(int s) const {
    return full + 8 * s;
  }
  __device__ __forceinline__ uint32_t empty_bar(int s) const {
    return empty + 8 * s;
  }
};

// Pin registers at this point of the program: wgmma reads its A fragments
// and writes its accumulators asynchronously, so the compiler must neither
// reuse nor move them between a wgmma's issue and its wait.
template <int A, int B, int E>
__device__ __forceinline__ void fence_regs(float (&v)[A][B][E]) {
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j)
#pragma unroll
      for (int e = 0; e < E; ++e) asm volatile("" : "+f"(v[i][j][e])::"memory");
}
template <int A, int B, int E>
__device__ __forceinline__ void fence_regs(uint32_t (&v)[A][B][E]) {
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j)
#pragma unroll
      for (int e = 0; e < E; ++e) asm volatile("" : "+r"(v[i][j][e])::"memory");
}

// Release chunk g's slot on every block of the cluster (one arrival per
// consumer warp and block).
template <int NSLOT, int CL>
__device__ __forceinline__ void release(const Ring& ring, int g) {
  const uint32_t bar = ring.empty_bar(g % NSLOT);
  if constexpr (CL == 1) {
    mbar_arrive(bar);
  } else {
#pragma unroll
    for (int r = 0; r < CL; ++r) mbar_arrive_cluster(bar, r);
  }
}

// The consumer side of one product: for each pass, zero the accumulators,
// run its K chunks (acc += A * B(chunk)), then epi(pass, col0, acc).
// a_addr(m, kc, st, slot) is the shared address of this lane's ldmatrix
// row for M tile m (this warp's 16 of its rows) at 16-deep K step st of K
// chunk kc, whose slot starts at `slot` (conv1's x is in it).
// With PIPE, a chunk's products run while the next chunk's A fragments
// load into the other of two register sets: it is released once they are
// done (wgmma.wait_group 1); else each chunk is released after its own
// (two blocks an SM then overlap each other's waits).
template <class G, int NSLOT, int SLOT, int CL, bool PIPE, class AAddr,
          class Epi>
__device__ __forceinline__ void consume(int& g, const Ring& ring,
                                        uint32_t slots, int wg, int lane,
                                        AAddr&& a_addr, Epi&& epi) {
  using Frags = uint32_t[G::KC / 16][G::MTW][4];
  float acc[G::MTW][G::NI][G::NW / 2];
  Frags a0, a1;
  const int col0 = G::SPLIT_N ? wg * G::COLS : 0;
  // chunk kc of this pass: wait for it, load A into `a`, issue its
  // products, and release the chunk before (PIPE) or this one
  auto step = [&](int pass, int kc, Frags& a, Frags& a_prev) {
    const int gc = g + kc, s = gc % NSLOT;
    mbar_wait(ring.full_bar(s), (gc / NSLOT) & 1);
    const uint32_t chunk = slots + s * SLOT;
#pragma unroll
    for (int st = 0; st < G::KC / 16; ++st)
#pragma unroll
      for (int i = 0; i < G::MTW; ++i) {
        const int m = G::SPLIT_N ? i : wg + 2 * i;
        if (G::SPLIT_N || G::MT % 2 == 0 || m < G::MT)
          ldmatrix_x4(a[st][i], a_addr(m, kc, st, chunk));
      }
    fence_regs(a);
    wgmma_fence();  // A and the accumulators written: visible to wgmma
#pragma unroll
    for (int st = 0; st < G::KC / 16; ++st)
#pragma unroll
      for (int i = 0; i < G::MTW; ++i) {
        const int m = G::SPLIT_N ? i : wg + 2 * i;
        if (G::SPLIT_N || G::MT % 2 == 0 || m < G::MT) {
#pragma unroll
          for (int n = 0; n < G::NI; ++n)
            wgmma<G::NW>(
                acc[i][n], a[st][i],
                desc_b(chunk + (col0 + n * G::NW) / 8 * (G::KC * 16) +
                           st * 256,
                       128, G::KC * 16));
        }
      }
    wgmma_commit();
    fence_regs(acc);
    if constexpr (PIPE) {
      if (kc > 0) {
        wgmma_wait<1>();
        fence_regs(acc);
        fence_regs(a_prev);
        if (lane == 0) release<NSLOT, CL>(ring, gc - 1);
      }
    } else {
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(a);
      if (lane == 0) release<NSLOT, CL>(ring, gc);
    }
  };
  for (int pass = 0; pass < G::PASSES; ++pass) {
#pragma unroll
    for (int i = 0; i < G::MTW; ++i)
#pragma unroll
      for (int n = 0; n < G::NI; ++n)
#pragma unroll
        for (int e = 0; e < G::NW / 2; ++e) acc[i][n][e] = 0.0f;
    fence_regs(acc);
    for (int kc = 0; kc < G::KCH; kc += 2) {
      step(pass, kc, a0, a1);
      if (kc + 1 < G::KCH) step(pass, kc + 1, a1, a0);
    }
    g += G::KCH;
    if constexpr (PIPE) {
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(a0);
      fence_regs(a1);
      if (lane == 0) release<NSLOT, CL>(ring, g - 1);
    }
    epi(pass, col0, acc);
  }
}

// The producer warpgroup walks every chunk of the launch in the
// consumers' order, all of its threads waiting until the chunk's slot is
// free on every block of the cluster.  For a conv1 chunk its last three
// warps first copy the chunk's x (KC channels of every pixel of the
// halo'd tile, zeros outside the image) into the slot by 16-byte
// cp.async, each thread making the slot's "full" barrier wait for its
// copies (cp.async.mbarrier.arrive); then thread 0 sets the weight bytes
// the barrier expects, and the cluster's first block multicasts the weight
// chunk.  (One bulk copy per pixel would cost the copy engine more than
// the bytes: 108-180 small requests a chunk.)
constexpr int kXLoaders = 96;

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

template <int C, class TileOf>
__device__ __forceinline__ void produce(
    const Ring& ring, uint32_t slots, const bf16* __restrict__ x,
    const bf16* __restrict__ w1p, const bf16* __restrict__ w2p,
    const bf16* __restrict__ w3p, int H, int W, int rounds,
    TileOf&& tile_of, bool leader, int t) {
  using K = Cfg<C>;
  constexpr int VPP = K::G1::KC / 8;   // 16-byte x vectors a pixel
  int g = 0;
  for (int it = 0; it < rounds; ++it) {
    int b, h0, w0;
    const bool valid = tile_of(it, b, h0, w0);
    auto run = [&](auto gemm, const bf16* __restrict__ wp, auto is_conv1) {
      using G = decltype(gemm);
      for (int j = 0; j < G::CHUNKS; ++j, ++g) {
        const int s = g % K::NSLOT;
        const uint32_t slot = slots + s * K::SLOT;
        mbar_wait(ring.empty_bar(s), ((g / K::NSLOT) & 1) ^ 1);
        if constexpr (decltype(is_conv1)::value) {
          if (t >= 32) {
            const int k0 = (j % G::KCH) * G::KC;
            for (int v = t - 32; valid && v < K::P1 * VPP; v += kXLoaders) {
              const int p = v / VPP, c = v % VPP * 8;
              const int h = h0 - 1 + p / kHW, w = w0 - 1 + p % kHW;
              const bool inside = h >= 0 && h < H && w >= 0 && w < W;
              cp_async16(slot + K::X_OFF + (p * K::XLD + c) * 2,
                         inside ? x + (((size_t)b * H + h) * W + w) * K::CIN +
                                      k0 + c
                                : x,
                         inside ? 16 : 0);
            }
            // one more pending arrival on "full", made when the copies land
            asm volatile(
                "cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(
                    ring.full_bar(s))
                : "memory");
          }
          // every x thread's arrival is pending before thread 0 arrives
          asm volatile("bar.sync 2, %0;\n" ::"n"(32 + kXLoaders) : "memory");
        }
        if (t == 0) {
          mbar_expect_tx(ring.full_bar(s), G::CHUNK_BYTES);
          if (leader) {
            const bf16* src = wp + (size_t)j * (G::CHUNK_BYTES / 2);
            if constexpr (K::CL == 1)
              bulk_copy(slot, src, G::CHUNK_BYTES, ring.full_bar(s));
            else
              bulk_copy_multicast(slot, src, G::CHUNK_BYTES,
                                  ring.full_bar(s), (1u << K::CL) - 1);
          }
        }
      }
    };
    run(typename K::G1{}, w1p, std::true_type{});
    run(typename K::G2{}, w2p, std::false_type{});
    run(typename K::G3{}, w3p, std::false_type{});
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, Cfg<C>::BLOCKS_PER_SM)
    bottleneck_kernel(const bf16* __restrict__ x,
                      const bf16* __restrict__ w1p,
                      const float* __restrict__ b1,
                      const bf16* __restrict__ w2p,
                      const float* __restrict__ b2,
                      const bf16* __restrict__ w3p,
                      const float* __restrict__ b3, bf16* __restrict__ out,
                      int H, int W, int tiles_h, int tiles_w, int n_tiles) {
  using K = Cfg<C>;
  using G1 = typename K::G1;
  using G2 = typename K::G2;
  using G3 = typename K::G3;
  static_assert(G2::PASSES == 1, "y2 overwrites y1 after the whole 3x3");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ys = reinterpret_cast<bf16*>(smem);     // y1, then y2
  const uint32_t ys_u = smem_u32(smem);
  const uint32_t slots = ys_u + K::Y_BYTES;     // the ring
  Ring ring;
  ring.full = ys_u + K::BAR_OFF;
  ring.empty = ring.full + 8 * K::NSLOT;
  if (threadIdx.x == 0) {
    for (int s = 0; s < K::NSLOT; ++s) {
      mbar_init(ring.full_bar(s), 1);
      mbar_init(ring.empty_bar(s), 8 * K::CL);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (K::CL > 1)
    cluster_sync();
  else
    __syncthreads();

  // persistent clusters: cluster cid takes cluster tiles cid, cid + ncl,
  // ...; block `rank` of it takes tile rank of each (spare past n_tiles)
  const int rank = blockIdx.x % K::CL, cid = blockIdx.x / K::CL;
  const int ncl = gridDim.x / K::CL;
  const int rounds = ((n_tiles + K::CL - 1) / K::CL - 1 - cid) / ncl + 1;
  auto tile_of = [&](int it, int& b, int& h0, int& w0) {
    const int t = (cid + it * ncl) * K::CL + rank;
    const int tt = t < n_tiles ? t : 0;
    w0 = tt % tiles_w * kTW;
    h0 = tt / tiles_w % tiles_h * K::TH;
    b = tt / tiles_w / tiles_h;
    return t < n_tiles;
  };

  // registers: the producer's warpgroup gives up its share to the
  // consumers' accumulators (ptxas sizes a wgmma kernel per warpgroup:
  // 168 a thread at one block per SM, 80 at two; 2 x (256 x 104 + 128 x
  // 32) registers fit an SM)
  constexpr int kRegsProducer = K::BLOCKS_PER_SM == 1 ? 40 : 32;
  constexpr int kRegsConsumer = K::BLOCKS_PER_SM == 1 ? 232 : 104;
  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegsProducer));
    produce<C>(ring, slots, x, w1p, w2p, w3p, H, W, rounds, tile_of,
               K::CL == 1 || cluster_rank() == 0, threadIdx.x - kConsumers);
    // no block leaves while a peer may still arrive on its barriers
    if constexpr (K::CL > 1) cluster_sync();
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegsConsumer));
    const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4;
    const int lane = threadIdx.x % 32;
    // this lane's ldmatrix row and column in a warp's 16 x 16 A fragment,
    // and its accumulator rows (r, r + 8) and column pair (2 q)
    const int lrow = lane % 16, lcol = lane / 16 * 8;
    const int r = lane / 4, q2 = lane % 4 * 2;
    int g = 0;
    for (int it = 0; it < rounds; ++it) {
    int b, h0, w0;
    const bool valid = tile_of(it, b, h0, w0);

    // ---- conv1 over the halo'd tile -> y1 (bf16, zero outside) ----------
    consume<G1, K::NSLOT, K::SLOT, K::CL, K::BLOCKS_PER_SM == 1>(
        g, ring, slots, wg, lane,
        [&](int m, int, int st, uint32_t slot) {
          int p = m * 64 + warp * 16 + lrow;
          if (p >= K::P1) p = 0;          // a padding row: result unused
          return slot + K::X_OFF +
                 (p * K::XLD + st * 16 + lcol) * 2;
        },
        [&](int pass, int col0, auto& acc) {
#pragma unroll
          for (int i = 0; i < G1::MTW; ++i) {
            const int m = G1::SPLIT_N ? i : wg + 2 * i;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int p = m * 64 + warp * 16 + r + 8 * hf;
              if (m >= G1::MT || p >= K::P1) continue;
              const int h = h0 - 1 + p / kHW, w = w0 - 1 + p % kHW;
              const bool inside = h >= 0 && h < H && w >= 0 && w < W;
#pragma unroll
              for (int n = 0; n < G1::NI; ++n)
#pragma unroll
                for (int e = 0; e < G1::NW / 8; ++e) {
                  const int col = pass * G1::NCH + col0 + n * G1::NW +
                                  e * 8 + q2;
                  const float2 bb =
                      __ldg(reinterpret_cast<const float2*>(b1 + col));
                  const float* v = &acc[i][n][4 * e + 2 * hf];
                  *reinterpret_cast<uint32_t*>(ys + p * K::LDC + col) =
                      inside ? pack_bf16x2(fmaxf(v[0] + bb.x, 0.0f),
                                           fmaxf(v[1] + bb.y, 0.0f))
                             : 0u;
                }
            }
          }
        });
    consumers_sync();  // y1 complete

    // ---- conv2: 3x3 as K = 9C, A rows straight out of y1 ----------------
    consume<G2, K::NSLOT, K::SLOT, K::CL, K::BLOCKS_PER_SM == 1>(
        g, ring, slots, wg, lane,
        [&](int m, int kc, int st, uint32_t) {
          const int k = kc * G2::KC + st * 16, tap = k / C, ci = k % C;
          const int o = m * 64 + warp * 16 + lrow;   // output pixel
          const int p = (o / kTW + tap / 3) * kHW + o % kTW + tap % 3;
          return ys_u + (p * K::LDC + ci + lcol) * 2;
        },
        [&](int, int col0, auto& acc) {
          consumers_sync();  // every warp is done reading y1
#pragma unroll
          for (int i = 0; i < G2::MTW; ++i) {
            const int m = G2::SPLIT_N ? i : wg + 2 * i;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int o = m * 64 + warp * 16 + r + 8 * hf;
              if (m >= G2::MT) continue;
#pragma unroll
              for (int n = 0; n < G2::NI; ++n)
#pragma unroll
                for (int e = 0; e < G2::NW / 8; ++e) {
                  const int col = col0 + n * G2::NW + e * 8 + q2;
                  const float2 bb =
                      __ldg(reinterpret_cast<const float2*>(b2 + col));
                  const float* v = &acc[i][n][4 * e + 2 * hf];
                  *reinterpret_cast<uint32_t*>(ys + o * K::LDC + col) =
                      pack_bf16x2(fmaxf(v[0] + bb.x, 0.0f),
                                  fmaxf(v[1] + bb.y, 0.0f));
                }
            }
          }
        });
    consumers_sync();  // y2 complete

    // ---- conv3 + b3 + residual + relu -> out ----------------------------
    consume<G3, K::NSLOT, K::SLOT, K::CL, K::BLOCKS_PER_SM == 1>(
        g, ring, slots, wg, lane,
        [&](int m, int kc, int st, uint32_t) {
          const int o = m * 64 + warp * 16 + lrow;
          return ys_u + (o * K::LDC + kc * G3::KC + st * 16 + lcol) * 2;
        },
        [&](int pass, int col0, auto& acc) {
          if (!valid) return;
          size_t base[G3::MTW][2];
#pragma unroll
          for (int i = 0; i < G3::MTW; ++i)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int m = G3::SPLIT_N ? i : wg + 2 * i;
              const int o = m * 64 + warp * 16 + r + 8 * hf;
              const int h = h0 + o / kTW, w = w0 + o % kTW;
              base[i][hf] = m < G3::MT && h < H && w < W
                                ? (((size_t)b * H + h) * W + w) * K::CIN
                                : ~(size_t)0;
            }
          // per wgmma column block: the residual loads first, all in
          // flight at once (a load may not pass a store to memory that
          // could alias it), then bias, add, ReLU and the stores
#pragma unroll
          for (int n = 0; n < G3::NI; ++n) {
            const int col_n = pass * G3::NCH + col0 + n * G3::NW + q2;
            uint32_t xr[G3::MTW][2][G3::NW / 8];
#pragma unroll
            for (int i = 0; i < G3::MTW; ++i)
#pragma unroll
              for (int hf = 0; hf < 2; ++hf)
#pragma unroll
                for (int e = 0; e < G3::NW / 8; ++e)
                  xr[i][hf][e] =
                      base[i][hf] != ~(size_t)0
                          ? __ldg(reinterpret_cast<const unsigned int*>(
                                x + base[i][hf] + col_n + e * 8))
                          : 0u;
#pragma unroll
            for (int e = 0; e < G3::NW / 8; ++e) {
              const int col = col_n + e * 8;
              const float2 bb =
                  __ldg(reinterpret_cast<const float2*>(b3 + col));
#pragma unroll
              for (int i = 0; i < G3::MTW; ++i)
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                  if (base[i][hf] == ~(size_t)0) continue;
                  const float2 xf = __bfloat1622float2(
                      *reinterpret_cast<const __nv_bfloat162*>(&xr[i][hf][e]));
                  const float* v = &acc[i][n][4 * e + 2 * hf];
                  *reinterpret_cast<uint32_t*>(out + base[i][hf] + col) =
                      pack_bf16x2(fmaxf((v[0] + bb.x) + xf.x, 0.0f),
                                  fmaxf((v[1] + bb.y) + xf.y, 0.0f));
                }
            }
          }
        });
    consumers_sync();  // y2 read: the next tile may write y1
    }
    if constexpr (K::CL > 1) cluster_sync();
  }
}

template <int C>
int launch(const void* x, const void* w1p, const float* b1, const void* w2p,
           const float* b2, const void* w3p, const float* b3, void* out,
           int batch, int h, int w, cudaStream_t stream) {
  using K = Cfg<C>;
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      K::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int tiles_h = (h + K::TH - 1) / K::TH, tiles_w = (w + kTW - 1) / kTW;
  const long long n_tiles = (long long)batch * tiles_h * tiles_w;
  if (n_tiles * K::CL > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = K::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K::CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // as many clusters as are resident at once, each looping over tiles
  const long long clusters = (n_tiles + K::CL - 1) / K::CL;
  cfg.gridDim = dim3((unsigned)(clusters * K::CL));
  static int resident_on[64] = {};   // per device, found at first launch
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int& resident = resident_on[dev & 63];
  if (resident == 0) {
    err = cudaOccupancyMaxActiveClusters(&resident, bottleneck_kernel<C>,
                                         &cfg);
    if (err != cudaSuccess) return (int)err;
    if (resident < 1) return (int)cudaErrorInvalidConfiguration;
  }
  cfg.gridDim = dim3((unsigned)(
      (clusters < resident ? clusters : (long long)resident) * K::CL));
  err = cudaLaunchKernelEx(
      &cfg, bottleneck_kernel<C>, static_cast<const bf16*>(x),
      static_cast<const bf16*>(w1p), b1, static_cast<const bf16*>(w2p), b2,
      static_cast<const bf16*>(w3p), b3, static_cast<bf16*>(out), h, w,
      tiles_h, tiles_w, (int)n_tiles);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// x, out (B, H, W, 4C) bf16 NHWC; w1p, w2p, w3p the folded weights packed
// by ops/bottleneck_kernel.py: pack_weights for this C (bf16, 17 C^2 in
// all); b1, b2 (C,), b3 (4C,) f32.  Returns cudaErrorInvalidValue for a C
// the kernel does not take.
extern "C" int glsdet_fused_bottleneck(const void* x, const void* w1p,
                                       const float* b1, const void* w2p,
                                       const float* b2, const void* w3p,
                                       const float* b3, void* out, int batch,
                                       int h, int w, int c,
                                       cudaStream_t stream) {
  switch (c) {
#define CASE(N)                                                           \
  case N:                                                                 \
    return launch<N>(x, w1p, b1, w2p, b2, w3p, b3, out, batch, h, w, stream);
    CASE(16) CASE(32) CASE(64) CASE(128) CASE(256) CASE(512)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
