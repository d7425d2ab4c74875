// Exact greedy NMS over score-sorted boxes, for Hopper (sm_90a).
//
// Replaces: glsdet_tpu/ops/pallas_nms.py: _nms_kernel / nms_pallas_sorted
// (one VMEM-resident program walking the K sorted boxes, recomputing each
// IoU row on the VPU), and the XLA fixpoint it twins
// (glsdet_tpu/ops/nms.py: nms).
//
// What bounds it on the H100: not bytes and not FLOPs.  The serving path
// runs K <= 2048 boxes per image and a TTA union up to 4096 (K*K/2 IoUs, a
// few MFLOP), so the first pass is short; the second is a chain of K
// dependent decisions per image, i.e. latency.  The design keeps every
// link of that chain on chip:
//   pass 1 (nms_mask_kernel): grid (K/64 column tiles, K/64 row tiles, B),
//     64 threads.  A block stages one 64-box column tile in shared memory;
//     each thread writes one 64-bit word: the bits j > i of the tile whose
//     IoU(i, j) > thr.  Tiles left of the diagonal are never read and are
//     skipped.  Rows are `stride` words apart, stride = ceil(K/64) rounded
//     up to even, so each 64-row chunk starts 16-byte aligned.
//   pass 2 (nms_reduce_kernel): one block of 8 warps per image.  Thread 0
//     streams chunk c's 64 mask rows (mask[base:base+64, :], contiguous)
//     into a shared-memory ring of up to 8 stages (as many 64 x stride
//     word slots as fit in kRingBytes: 8 up to K = 3456, 6 at K = 4096) by
//     cp.async.bulk on mbarriers, so the next chunks load while chunk c is
//     decided.  Warp 0 decides the chunk from shared memory alone: its
//     lanes mark the candidates whose diagonal word meets another
//     candidate, and lane 0 walks only those, in order, by find-first-set,
//     each one still a candidate clearing its diagonal word's bits (a chunk
//     of disjoint boxes takes no step).  Then the 8 warps OR the kept rows'
//     later words into the removed mask (lane w takes words c+1+w and
//     c+33+w, warp r the rows r, r+8, ...), with shared atomics: OR is
//     order-free, so the result does not depend on timing.  No global load
//     stays on the dependent chain.
// Pass 1 stays a separate launch: folded into pass 2's one block per
// image it would put the K*K/2 IoUs on one SM each.
//
// The IoU is the same float expression as glsdet_tpu_torch/ops/boxes.py
// and glsdet_tpu/ops/boxes.py (clamp then multiply, union = a1 + a2 -
// inter, inter / max(union, 1e-7)), written with the _rn intrinsics so
// that no multiply-add is contracted: with the class shift (+label*8192)
// coordinates reach ~8e4, where one f32 ulp is ~0.008, and a contracted
// IoU flips keep decisions at the threshold.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kMaxWords = 64;        // K <= 4096
constexpr int kReduceThreads = 256;  // 8 warps
constexpr int kStages = 8;           // at most; fewer when slots are large
constexpr int kRingBytes = 220 * 1024;  // the ring's dynamic shared memory

// ring slots of 64 * stride words that fit in kRingBytes, at most kStages
int ring_stages(int stride) {
  const int slot = kTile * stride * 8;
  const int n = kRingBytes / slot;
  return n < kStages ? n : kStages;
}

__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2, float off) {
  const float w = fmaxf(__fadd_rn(__fsub_rn(x2, x1), off), 0.0f);
  const float h = fmaxf(__fadd_rn(__fsub_rn(y2, y1), off), 0.0f);
  return __fmul_rn(w, h);
}

__global__ void nms_mask_kernel(const float* __restrict__ boxes, int k,
                                int stride, float thr, float off,
                                unsigned long long* __restrict__ mask) {
  const int cb = blockIdx.x, rb = blockIdx.y, b = blockIdx.z;
  if (cb < rb) return;  // left of the diagonal: never read by pass 2
  __shared__ float col[kTile][5];
  const float* bx = boxes + (size_t)b * k * 4;
  const int t = threadIdx.x;
  const int j0 = cb * kTile;
  const int ncols = min(kTile, k - j0);
  if (t < ncols) {
    const float* p = bx + (size_t)(j0 + t) * 4;
    col[t][0] = p[0];
    col[t][1] = p[1];
    col[t][2] = p[2];
    col[t][3] = p[3];
    col[t][4] = box_area(p[0], p[1], p[2], p[3], off);
  }
  __syncthreads();
  const int i = rb * kTile + t;
  if (i >= k) return;
  const float* p = bx + (size_t)i * 4;
  const float x1 = p[0], y1 = p[1], x2 = p[2], y2 = p[3];
  const float area_i = box_area(x1, y1, x2, y2, off);
  unsigned long long bits = 0ull;
  for (int jj = (cb == rb) ? t + 1 : 0; jj < ncols; ++jj) {
    const float iw = fmaxf(
        __fadd_rn(__fsub_rn(fminf(x2, col[jj][2]), fmaxf(x1, col[jj][0])),
                  off), 0.0f);
    const float ih = fmaxf(
        __fadd_rn(__fsub_rn(fminf(y2, col[jj][3]), fmaxf(y1, col[jj][1])),
                  off), 0.0f);
    const float inter = __fmul_rn(iw, ih);
    const float uni = fmaxf(
        __fsub_rn(__fadd_rn(area_i, col[jj][4]), inter), 1e-7f);
    // inter / uni as div.rn rounds it, without its operand check: most
    // pairs do not overlap, and a zero dividend sends div.rn to its slow
    // path; uni >= 1e-7 and 0 <= inter <= uni keep the sequence exact
    if (ptx::div_rn(inter, uni, ptx::rcp_refined(uni)) > thr)
      bits |= 1ull << jj;
  }
  mask[((size_t)b * k + i) * stride + cb] = bits;
}

// dynamic shared memory: `stages` slots of 64 * stride words
__global__ void __launch_bounds__(kReduceThreads, 1)
    nms_reduce_kernel(const unsigned long long* __restrict__ mask,
                      const uint8_t* __restrict__ valid, int k, int stride,
                      int stages, uint8_t* __restrict__ keep) {
  extern __shared__ __align__(128) unsigned long long ring[];
  __shared__ unsigned long long removed[kMaxWords], kept_w[kMaxWords],
      vbits[kMaxWords];
  __shared__ __align__(8) unsigned long long bars[kStages];
  const int b = blockIdx.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int nwords = (k + kTile - 1) / kTile;
  const unsigned long long* m = mask + (size_t)b * k * stride;
  const uint8_t* v = valid + (size_t)b * k;
  const uint32_t ring_u = ptx::smem_u32(ring), bar_u = ptx::smem_u32(bars);
  const int slot_words = kTile * stride;

  if (t == 0) {
    for (int s = 0; s < stages; ++s) ptx::mbar_init(bar_u + 8 * s, 1);
    ptx::fence_mbar_init();
  }
  if (t < kMaxWords) removed[t] = 0ull;
  for (int c = warp; c < nwords; c += kReduceThreads / 32) {
    const int base = c * kTile, n = min(kTile, k - base);
    const unsigned lo = __ballot_sync(0xffffffffu, lane < n && v[base + lane]);
    const unsigned hi =
        __ballot_sync(0xffffffffu, lane + 32 < n && v[base + lane + 32]);
    if (lane == 0)
      vbits[c] = (unsigned long long)lo | ((unsigned long long)hi << 32);
  }
  __syncthreads();
  auto issue = [&](int c) {
    const int s = c % stages;
    const int n = min(kTile, k - c * kTile);
    const uint32_t bytes = (uint32_t)(n * stride * 8);
    ptx::mbar_expect_tx(bar_u + 8 * s, bytes);
    ptx::bulk_copy(ring_u + s * slot_words * 8, m + (size_t)c * kTile * stride,
                   bytes, bar_u + 8 * s);
  };
  if (t == 0) {
    for (int c = 0; c < min(stages, nwords); ++c) issue(c);
  }
  for (int c = 0; c < nwords; ++c) {
    const int s = c % stages;
    ptx::mbar_wait(bar_u + 8 * s, (uint32_t)((c / stages) & 1));
    const unsigned long long* rows = ring + (size_t)s * slot_words;
    if (warp == 0) {
      // greedy over the chunk.  Only a candidate whose diagonal word (bits
      // > r only) meets another candidate can change the outcome: warp 0
      // finds those rows in parallel, and lane 0 walks just them in order,
      // each one still a candidate clearing the rows it overlaps.  The
      // candidates left at the end are the kept rows.
      const unsigned long long cand0 = vbits[c] & ~removed[c];
      const unsigned long long d_lo = rows[(size_t)lane * stride + c];
      const unsigned long long d_hi = rows[(size_t)(lane + 32) * stride + c];
      const unsigned s_lo = __ballot_sync(
          0xffffffffu, ((cand0 >> lane) & 1ull) && (d_lo & cand0));
      const unsigned s_hi = __ballot_sync(
          0xffffffffu, ((cand0 >> (lane + 32)) & 1ull) && (d_hi & cand0));
      if (lane == 0) {
        unsigned long long cand = cand0;
        unsigned long long todo =
            (unsigned long long)s_lo | ((unsigned long long)s_hi << 32);
        while (todo) {
          const int r = __ffsll((long long)todo) - 1;
          cand &= ~rows[(size_t)r * stride + c];
          todo &= (todo - 1) & cand;
        }
        kept_w[c] = cand;
      }
    }
    __syncthreads();
    const unsigned long long kept = kept_w[c];
    for (int w = c + 1 + lane; kept && w < nwords; w += 32) {
      unsigned long long mine = kept & (0x0101010101010101ull << warp);
      unsigned long long acc = 0ull;
      while (mine) {
        const int r = __ffsll((long long)mine) - 1;
        mine &= mine - 1;
        acc |= rows[(size_t)r * stride + w];
      }
      if (acc) atomicOr(&removed[w], acc);
    }
    __syncthreads();  // removed is current and the slot is read
    if (t == 0 && c + stages < nwords) issue(c + stages);
  }
  uint8_t* out = keep + (size_t)b * k;
  for (int i = t; i < k; i += kReduceThreads)
    out[i] = (uint8_t)((kept_w[i / kTile] >> (i % kTile)) & 1ull);
}

int check_args(int k, int stride) {
  const int nwords = (k + kTile - 1) / kTile;
  if (k < 1 || nwords > kMaxWords || stride < nwords || stride % 2)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// boxes (B, K, 4) f32 sorted by descending score -> mask (B, K, stride)
// u64, stride even and >= ceil(K/64).  K <= 4096.
extern "C" int glsdet_nms_mask(const float* boxes, unsigned long long* mask,
                               int batch, int k, int stride, float iou_thr,
                               float offset, cudaStream_t stream) {
  if (int rc = check_args(k, stride)) return rc;
  const int nwords = (k + kTile - 1) / kTile;
  nms_mask_kernel<<<dim3(nwords, nwords, batch), kTile, 0, stream>>>(
      boxes, k, stride, iou_thr, offset, mask);
  return (int)cudaGetLastError();
}

// mask as above, valid (B, K) u8 -> keep (B, K) u8.
extern "C" int glsdet_nms_reduce(const unsigned long long* mask,
                                 const uint8_t* valid, uint8_t* keep,
                                 int batch, int k, int stride,
                                 cudaStream_t stream) {
  if (int rc = check_args(k, stride)) return rc;
  static bool attr_set[64] = {};  // per device: the largest ring
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (!attr_set[dev % 64]) {
    err = cudaFuncSetAttribute(nms_reduce_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kRingBytes);
    if (err != cudaSuccess) return (int)err;
    attr_set[dev % 64] = true;
  }
  const int stages = ring_stages(stride);
  const int smem = stages * kTile * stride * 8;
  nms_reduce_kernel<<<batch, kReduceThreads, smem, stream>>>(
      mask, valid, k, stride, stages, keep);
  return (int)cudaGetLastError();
}

// both passes; mask is the (B, K, stride) u64 scratch.
extern "C" int glsdet_nms_sorted(const float* boxes, const uint8_t* valid,
                                 uint8_t* keep, unsigned long long* mask,
                                 int batch, int k, int stride, float iou_thr,
                                 float offset, cudaStream_t stream) {
  if (int rc = glsdet_nms_mask(boxes, mask, batch, k, stride, iou_thr,
                               offset, stream))
    return rc;
  return glsdet_nms_reduce(mask, valid, keep, batch, k, stride, stream);
}
