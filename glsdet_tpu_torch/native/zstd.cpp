// A Zstandard frame decoder written from RFC 8878, and CRC-32C, for
// utils/orbax_read.py: the host side of reading the JAX package's orbax
// checkpoints (OCDBT nodes and zarr chunks are zstd frames, OCDBT nodes and
// manifests end in a CRC-32C) on a machine without zstd, tensorstore or JAX.
//
// What it decodes: raw, RLE and compressed blocks; raw, RLE, Huffman (1 or 4
// streams) and treeless literals; sequences with predefined, RLE, FSE and
// repeat tables and the three repeat offsets; the single-segment flag and
// the frame content size; frames back to back and skippable frames; the
// XXH64 content checksum, verified when the frame has one.  A frame that
// names a dictionary is refused.  The whole output is held in the caller's
// buffer, so a match may reach back to the start of its frame; windows up
// to 2^31 bytes are accepted.
//
// Every read is bounded by its section and every write by the output
// buffer: damaged input returns an error with the byte offset of the part
// that was being read, never reads or writes out of bounds.
//
// zstd_decompress returns 0 (out_len = bytes written), 1 (corrupt or
// unsupported input, message in msg) or 2 (the output needs more than cap
// bytes).  zstd_content_size returns the sum of the frames' content sizes,
// -1 where a frame does not state one, or -2 for input that is not zstd.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr size_t kBlockMax = 128 * 1024;
constexpr uint32_t kMagic = 0xFD2FB528u;
constexpr uint32_t kSkipMagic = 0x184D2A50u;

struct Error {
  size_t offset;
  const char* what;
  int code;  // 1 corrupt, 2 output too small
};

[[noreturn]] void fail(size_t offset, const char* what) {
  throw Error{offset, what, 1};
}

inline int highbit(uint32_t v) {  // index of the highest set bit, -1 for 0
  return v ? 31 - __builtin_clz(v) : -1;
}

inline uint32_t rd16(const uint8_t* p) { return p[0] | (uint32_t)p[1] << 8; }
inline uint32_t rd24(const uint8_t* p) {
  return rd16(p) | (uint32_t)p[2] << 16;
}
inline uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

// ── XXH64 ───────────────────────────────────────────────────────────────
constexpr uint64_t P1 = 0x9E3779B185EBCA87ull, P2 = 0xC2B2AE3D27D4EB4Full,
                   P3 = 0x165667B19E3779F9ull, P4 = 0x85EBCA77C2B2AE63ull,
                   P5 = 0x27D4EB2F165667C5ull;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t xmerge(uint64_t acc, uint64_t v) {
  return (acc ^ xround(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += n;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t)rd32(p) * P1, 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ *p * P5, 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  return h ^ (h >> 32);
}

// ── bit streams ─────────────────────────────────────────────────────────
// Forward (FSE table descriptions): bits taken from the lowest of each
// byte, bytes in order.
struct FwdBits {
  const uint8_t* p;
  size_t n, base;  // base: offset of p in the whole input, for messages
  size_t pos = 0;  // bits consumed
  uint32_t read(int k) {
    uint32_t v = 0;
    for (int i = 0; i < k; ++i, ++pos) {
      if ((pos >> 3) >= n)
        fail(base + n, "table description runs past its section");
      v |= (uint32_t)((p[pos >> 3] >> (pos & 7)) & 1) << i;
    }
    return v;
  }
  size_t bytes() const { return (pos + 7) >> 3; }
};

// Backward (Huffman and FSE streams): read from the end towards the start,
// after the highest set bit of the last byte.  Bits before the start read
// as 0 (the streams' own rule); pos < 0 then records the overrun.
struct BackBits {
  const uint8_t* p;
  size_t n;
  int64_t pos;
  BackBits(const uint8_t* src, size_t len, size_t base) : p(src), n(len) {
    if (len == 0) fail(base, "empty bit stream");
    const int hb = highbit(src[len - 1]);
    if (hb < 0) fail(base + len - 1, "bit stream ends in a zero byte");
    pos = (int64_t)len * 8 - (8 - hb);
  }
  uint64_t window(int64_t bit, int k) const {  // k <= 56 bits at bit >= 0
    const size_t byte = (size_t)(bit >> 3);
    uint64_t v;
    if (byte + 8 <= n) {
      v = rd64(p + byte);
    } else {
      v = 0;
      for (size_t i = byte; i < n; ++i) v |= (uint64_t)p[i] << (8 * (i - byte));
    }
    return (v >> (bit & 7)) & ((1ull << k) - 1);
  }
  uint32_t read(int k) {
    if (k == 0) return 0;
    pos -= k;
    if (pos >= 0) return (uint32_t)window(pos, k);
    const int64_t have = k + pos;
    if (have <= 0) return 0;
    return (uint32_t)(window(0, (int)have) << (-pos));
  }
};

// ── FSE ─────────────────────────────────────────────────────────────────
struct Fse {
  int log = -1;  // accuracy log; -1: no table yet
  uint8_t sym[512];
  uint8_t bits[512];
  uint16_t base[512];
};

void fse_build(Fse& t, const int16_t* norm, int nsym, int log, size_t at) {
  const int size = 1 << log;
  uint16_t next[256];
  int high = size;
  for (int s = 0; s < nsym; ++s)
    if (norm[s] == -1) {
      t.sym[--high] = (uint8_t)s;
      next[s] = 1;
    }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] <= 0) continue;
    next[s] = (uint16_t)norm[s];
    for (int i = 0; i < norm[s]; ++i) {
      t.sym[pos] = (uint8_t)s;
      do pos = (pos + step) & mask;
      while (pos >= high);
    }
  }
  if (pos != 0) fail(at, "FSE table does not fill its states");
  for (int i = 0; i < size; ++i) {
    const uint16_t d = next[t.sym[i]]++;
    t.bits[i] = (uint8_t)(log - highbit(d));
    t.base[i] = (uint16_t)(((uint32_t)d << t.bits[i]) - size);
  }
  t.log = log;
}

void fse_rle(Fse& t, uint8_t s) {
  t.sym[0] = s;
  t.bits[0] = 0;
  t.base[0] = 0;
  t.log = 0;
}

// Reads a table description at p[0..n); returns the bytes it took.
size_t fse_read(Fse& t, const uint8_t* p, size_t n, size_t base, int max_log,
                int max_sym) {
  FwdBits in{p, n, base};
  const int log = 5 + (int)in.read(4);
  if (log > max_log) fail(base, "FSE accuracy log too large");
  int16_t norm[256];
  int remaining = 1 << log, sym = 0;
  while (remaining > 0) {
    if (sym > max_sym) fail(base, "FSE table has too many symbols");
    const int nb = highbit((uint32_t)remaining + 1) + 1;
    uint32_t v = in.read(nb);
    const uint32_t lower = (1u << (nb - 1)) - 1;
    const uint32_t thr = (1u << nb) - 1 - (uint32_t)(remaining + 1);
    if ((v & lower) < thr) {
      --in.pos;
      v &= lower;
    } else if (v > lower) {
      v -= thr;
    }
    const int prob = (int)v - 1;
    remaining -= prob < 0 ? -prob : prob;
    norm[sym++] = (int16_t)prob;
    if (prob == 0) {
      for (;;) {
        const uint32_t rep = in.read(2);
        for (uint32_t i = 0; i < rep; ++i) {
          if (sym > max_sym) fail(base, "FSE table has too many symbols");
          norm[sym++] = 0;
        }
        if (rep != 3) break;
      }
    }
  }
  if (remaining != 0) fail(base, "FSE probabilities overrun the table");
  fse_build(t, norm, sym, log, base);
  return in.bytes();
}

struct FseState {
  const Fse* t;
  uint32_t s;
  void init(const Fse& table, BackBits& in) {
    t = &table;
    s = in.read(table.log);
  }
  uint8_t peek() const { return t->sym[s]; }
  void update(BackBits& in) { s = t->base[s] + in.read(t->bits[s]); }
};

// ── Huffman ─────────────────────────────────────────────────────────────
struct Huf {
  int max_bits = 0;  // 0: no table yet
  uint8_t sym[1 << 11];
  uint8_t bits[1 << 11];
};

// Reads a tree description at p[0..n); returns the bytes it took.
size_t huf_read(Huf& h, const uint8_t* p, size_t n, size_t base) {
  if (n < 1) fail(base, "literals section ends before its Huffman tree");
  uint8_t w[256];
  int nw;
  size_t used;
  const int head = p[0];
  if (head >= 128) {
    nw = head - 127;
    used = 1 + (size_t)(nw + 1) / 2;
    if (used > n) fail(base, "Huffman weights run past their section");
    for (int i = 0; i < nw; ++i)
      w[i] = (uint8_t)((p[1 + i / 2] >> (i % 2 ? 0 : 4)) & 15);
  } else {
    used = 1 + (size_t)head;
    if (used > n || head == 0)
      fail(base, "Huffman weights run past their section");
    Fse t;
    const size_t hdr = fse_read(t, p + 1, head, base + 1, 6, 255);
    if (hdr >= (size_t)head) fail(base + 1, "Huffman weight stream is empty");
    BackBits in(p + 1 + hdr, head - hdr, base + 1 + hdr);
    FseState s1, s2;
    s1.init(t, in);
    s2.init(t, in);
    nw = 0;
    auto push = [&](uint8_t v) {
      if (nw >= 255) fail(base, "too many Huffman weights");
      w[nw++] = v;
    };
    for (;;) {
      push(s1.peek());
      s1.update(in);
      if (in.pos < 0) {
        push(s2.peek());
        break;
      }
      push(s2.peek());
      s2.update(in);
      if (in.pos < 0) {
        push(s1.peek());
        break;
      }
    }
  }
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    if (w[i] > 11) fail(base, "Huffman weight above 11");
    if (w[i]) total += 1u << (w[i] - 1);
  }
  if (total == 0) fail(base, "Huffman weights are all zero");
  const int max_bits = highbit(total) + 1;
  if (max_bits > 11) fail(base, "Huffman code longer than 11 bits");
  const uint32_t left = (1u << max_bits) - total;
  if (left & (left - 1)) fail(base, "Huffman weights do not complete a tree");
  w[nw++] = (uint8_t)(highbit(left) + 1);
  int count[12] = {0};
  uint8_t nbits[256];
  for (int i = 0; i < nw; ++i) {
    nbits[i] = w[i] ? (uint8_t)(max_bits + 1 - w[i]) : 0;
    count[nbits[i]]++;
  }
  uint32_t start[13];
  start[max_bits] = 0;
  for (int b = max_bits; b >= 1; --b) {
    start[b - 1] = start[b] + count[b] * (1u << (max_bits - b));
    std::memset(h.bits + start[b], b, start[b - 1] - start[b]);
  }
  if (start[0] != (1u << max_bits)) fail(base, "Huffman table is not full");
  for (int i = 0; i < nw; ++i) {
    if (!nbits[i]) continue;
    const uint32_t len = 1u << (max_bits - nbits[i]);
    std::memset(h.sym + start[nbits[i]], i, len);
    start[nbits[i]] += len;
  }
  h.max_bits = max_bits;
  return used;
}

// Bits [top - k, top) of a backward stream, bit top - 1 the highest; bits
// before the start read as 0.  The fast form needs top >= 56: it loads the
// 8 bytes that end at the byte holding bit top - 1.
inline uint32_t peek_fast(const uint8_t* p, int64_t top, int k) {
  const uint64_t v = rd64(p + (top >> 3) - 7);
  return (uint32_t)(v >> ((top & 7) + 56 - k)) & ((1u << k) - 1);
}

uint32_t peek_slow(const uint8_t* p, int64_t top, int k) {
  uint32_t v = 0;
  for (int i = 1; i <= k; ++i) {
    const int64_t b = top - i;
    v = (v << 1) | (b >= 0 ? (p[b >> 3] >> (b & 7)) & 1u : 0u);
  }
  return v;
}

// A Huffman stream being decoded: each symbol is the table entry at the
// next max_bits bits, which then gives up the symbol's own length (the
// state form of RFC 8878 section 4.2.2, read as a sliding window).
struct HufCursor {
  const uint8_t* p;
  size_t base;
  int64_t top;  // bits not yet consumed
  uint8_t* out;
  size_t i, count;
};

HufCursor huf_open(const uint8_t* p, size_t n, size_t base, uint8_t* out,
                   size_t count) {
  if (n == 0) fail(base, "empty bit stream");
  const int hb = highbit(p[n - 1]);
  if (hb < 0) fail(base + n - 1, "bit stream ends in a zero byte");
  return HufCursor{p, base, (int64_t)n * 8 - (8 - hb), out, 0, count};
}

inline void huf_step(const Huf& h, HufCursor& c, bool fast) {
  const uint32_t idx = fast ? peek_fast(c.p, c.top, h.max_bits)
                            : peek_slow(c.p, c.top, h.max_bits);
  c.out[c.i++] = h.sym[idx];
  c.top -= h.bits[idx];
}

// Decodes the rest of a stream, which must end exactly at its first bit.
void huf_finish(const Huf& h, HufCursor& c) {
  while (c.i < c.count && c.top >= 56) huf_step(h, c, true);
  while (c.i < c.count) huf_step(h, c, false);
  if (c.top != 0) fail(c.base, "Huffman stream not consumed exactly");
}

// ── sequences ───────────────────────────────────────────────────────────
const int16_t kLLNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1,
                             2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1,
                             -1, -1, -1, -1};
const int16_t kMLNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
                             -1, -1, -1, -1, -1};
const int16_t kOFNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {
    0,   1,   2,    3,    4,    5,    6,    7,    8,     9,     10,    11,
    12,  13,  14,   15,   16,   18,   20,   22,   24,    28,    32,    40,
    48,  64,  128,  256,  512,  1024, 2048, 4096, 8192,  16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,  14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24, 25,  26,  27,  28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41, 43,  47,  51,  59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct Frame {
  Huf huf;
  Fse ll, of, ml;
  uint32_t rep[3] = {1, 4, 8};
};

// Reads one symbol table of mode `mode` at p[0..n); returns bytes taken.
size_t seq_table(Fse& t, int mode, const uint8_t* p, size_t n, size_t base,
                 const int16_t* norm, int nsym, int dlog, int max_log,
                 int max_sym) {
  switch (mode) {
    case 0:
      fse_build(t, norm, nsym, dlog, base);
      return 0;
    case 1:
      if (n < 1) fail(base, "sequences section ends before an RLE symbol");
      if (p[0] > max_sym) fail(base, "RLE symbol out of range");
      fse_rle(t, p[0]);
      return 1;
    case 2:
      return fse_read(t, p, n, base, max_log, max_sym);
    default:
      if (t.log < 0) fail(base, "repeat mode without an earlier table");
      return 0;
  }
}

struct Out {
  uint8_t* dst;
  size_t cap, len;
  void need(size_t k) {
    if (k > cap - len) throw Error{0, "output buffer too small", 2};
  }
};

void compressed_block(Frame& f, const uint8_t* p, size_t n, size_t base,
                      Out& out, size_t frame_start, size_t block_max,
                      std::vector<uint8_t>& lit_buf) {
  if (n < 1) fail(base, "empty compressed block");
  // literals section
  const int ltype = p[0] & 3, sf = (p[0] >> 2) & 3;
  size_t hsize, regen, csize = 0;
  if (ltype < 2) {
    if (sf == 0 || sf == 2) {
      hsize = 1;
      regen = p[0] >> 3;
    } else if (sf == 1) {
      hsize = 2;
      if (n < 2) fail(base, "literals header truncated");
      regen = (p[0] >> 4) + ((size_t)p[1] << 4);
    } else {
      hsize = 3;
      if (n < 3) fail(base, "literals header truncated");
      regen = (p[0] >> 4) + ((size_t)p[1] << 4) + ((size_t)p[2] << 12);
    }
  } else {
    hsize = sf < 2 ? 3 : sf == 2 ? 4 : 5;
    if (n < hsize) fail(base, "literals header truncated");
    const int b = sf < 2 ? 10 : sf == 2 ? 14 : 18;
    uint64_t h = 0;
    for (size_t i = 0; i < hsize; ++i) h |= (uint64_t)p[i] << (8 * i);
    regen = (h >> 4) & ((1u << b) - 1);
    csize = (h >> (4 + b)) & ((1u << b) - 1);
  }
  if (regen > block_max) fail(base, "literals larger than a block");
  const uint8_t* lit;
  size_t lsec;
  if (ltype == 0) {
    lsec = hsize + regen;
    if (lsec > n) fail(base, "raw literals run past the block");
    lit = p + hsize;
  } else if (ltype == 1) {
    lsec = hsize + 1;
    if (lsec > n) fail(base, "RLE literals run past the block");
    std::memset(lit_buf.data(), p[hsize], regen);
    lit = lit_buf.data();
  } else {
    lsec = hsize + csize;
    if (lsec > n) fail(base, "compressed literals run past the block");
    const uint8_t* q = p + hsize;
    size_t qn = csize, qb = base + hsize;
    if (ltype == 2) {
      const size_t t = huf_read(f.huf, q, qn, qb);
      q += t;
      qn -= t;
      qb += t;
    } else if (f.huf.max_bits == 0) {
      fail(base, "treeless literals without an earlier Huffman table");
    }
    if (sf == 0) {
      HufCursor c = huf_open(q, qn, qb, lit_buf.data(), regen);
      huf_finish(f.huf, c);
    } else {
      if (qn < 6) fail(qb, "Huffman jump table truncated");
      const size_t s1 = rd16(q), s2 = rd16(q + 2), s3 = rd16(q + 4);
      if (6 + s1 + s2 + s3 > qn)
        fail(qb, "Huffman streams run past their section");
      const size_t s4 = qn - 6 - s1 - s2 - s3;
      const size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) fail(qb, "too few literals for four streams");
      const size_t sizes[4] = {s1, s2, s3, s4};
      HufCursor c[4];
      size_t at = 6;
      for (int i = 0; i < 4; ++i) {
        c[i] = huf_open(q + at, sizes[i], qb + at, lit_buf.data() + i * seg,
                        i < 3 ? seg : regen - 3 * seg);
        at += sizes[i];
      }
      // the four streams in step, for the independent loads; a symbol
      // takes at most max_bits, so `run` steps keep every top >= 56
      for (;;) {
        int64_t run = INT64_MAX;
        for (const HufCursor& k : c) {
          if (k.top < 56 || k.i >= k.count) run = 0;
          else run = std::min({run, (k.top - 56) / f.huf.max_bits + 1,
                               (int64_t)(k.count - k.i)});
        }
        if (run == 0) break;
        for (int64_t r = 0; r < run; ++r) {
          huf_step(f.huf, c[0], true);
          huf_step(f.huf, c[1], true);
          huf_step(f.huf, c[2], true);
          huf_step(f.huf, c[3], true);
        }
      }
      for (int i = 0; i < 4; ++i) huf_finish(f.huf, c[i]);
    }
    lit = lit_buf.data();
  }
  // sequences section
  p += lsec;
  n -= lsec;
  base += lsec;
  if (n < 1) fail(base, "sequences section missing");
  size_t nseq, at;
  if (p[0] < 128) {
    nseq = p[0];
    at = 1;
  } else if (p[0] < 255) {
    if (n < 2) fail(base, "sequence count truncated");
    nseq = ((size_t)(p[0] - 128) << 8) + p[1];
    at = 2;
  } else {
    if (n < 3) fail(base, "sequence count truncated");
    nseq = p[1] + ((size_t)p[2] << 8) + 0x7F00;
    at = 3;
  }
  const size_t block_start = out.len;
  if (nseq == 0) {
    if (at != n) fail(base, "bytes after an empty sequences section");
    out.need(regen);
    std::memcpy(out.dst + out.len, lit, regen);
    out.len += regen;
    if (out.len - block_start > block_max)
      fail(base, "block larger than allowed");
    return;
  }
  if (at >= n) fail(base, "sequence modes missing");
  const int modes = p[at];
  if (modes & 3) fail(base + at, "reserved bits set in sequence modes");
  ++at;
  at += seq_table(f.ll, modes >> 6, p + at, n - at, base + at, kLLNorm, 36,
                  6, 9, 35);
  at += seq_table(f.of, (modes >> 4) & 3, p + at, n - at, base + at, kOFNorm,
                  29, 5, 8, 31);
  at += seq_table(f.ml, (modes >> 2) & 3, p + at, n - at, base + at, kMLNorm,
                  53, 6, 9, 52);
  if (at >= n) fail(base, "sequence bit stream missing");
  BackBits in(p + at, n - at, base + at);
  FseState sll, sof, sml;
  sll.init(f.ll, in);
  sof.init(f.of, in);
  sml.init(f.ml, in);
  size_t lpos = 0;
  uint32_t* rep = f.rep;
  for (size_t i = 0; i < nseq; ++i) {
    const int ofc = sof.peek(), mlc = sml.peek(), llc = sll.peek();
    if (ofc > 31) fail(base + at, "offset code out of range");
    const uint32_t ofv = (1u << ofc) + in.read(ofc);
    const size_t ml = kMLBase[mlc] + in.read(kMLBits[mlc]);
    const size_t ll = kLLBase[llc] + in.read(kLLBits[llc]);
    uint32_t offset;
    if (ofv > 3) {
      offset = ofv - 3;
      rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = offset;
    } else {
      const int idx = (int)ofv - 1 + (ll == 0);
      if (idx == 0) {
        offset = rep[0];
      } else {
        offset = idx < 3 ? rep[idx] : rep[0] - 1;
        if (idx > 1) rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      }
    }
    if (i + 1 < nseq) {
      sll.update(in);
      sml.update(in);
      sof.update(in);
    }
    if (in.pos < 0) fail(base + at, "sequence bit stream overrun");
    if (ll > regen - lpos)
      fail(base + at, "sequence takes more literals than the block has");
    out.need(ll + ml);
    std::memcpy(out.dst + out.len, lit + lpos, ll);
    out.len += ll;
    lpos += ll;
    if (offset == 0 || offset > out.len - frame_start)
      fail(base + at, "match offset before the start of the frame");
    uint8_t* d = out.dst + out.len;
    const uint8_t* s = d - offset;
    if (offset >= ml) {
      std::memcpy(d, s, ml);
    } else {
      for (size_t k = 0; k < ml; ++k) d[k] = s[k];
    }
    out.len += ml;
    if (out.len - block_start > block_max)
      fail(base, "block larger than allowed");
  }
  if (in.pos != 0) fail(base + at, "sequence bit stream not consumed exactly");
  const size_t rest = regen - lpos;
  out.need(rest);
  std::memcpy(out.dst + out.len, lit + lpos, rest);
  out.len += rest;
  if (out.len - block_start > block_max)
    fail(base, "block larger than allowed");
}

struct Header {
  size_t size;           // header bytes after the magic
  uint64_t window;
  int64_t content_size;  // -1: not stated
  bool checksum;
};

Header frame_header(const uint8_t* p, size_t n, size_t base) {
  if (n < 1) fail(base, "frame header truncated");
  const int d = p[0];
  const int fcs_flag = d >> 6, single = (d >> 5) & 1, did_flag = d & 3;
  if (d & 8) fail(base, "reserved bit set in the frame header");
  Header h{1, 0, -1, (d & 4) != 0};
  if (!single) {
    if (n < 2) fail(base, "frame header truncated");
    const int e = p[1] >> 3, m = p[1] & 7;
    const int wlog = 10 + e;
    if (wlog > 31) fail(base + 1, "window larger than 2^31");
    const uint64_t wbase = 1ull << wlog;
    h.window = wbase + (wbase / 8) * m;
    h.size = 2;
  }
  const int did_bytes = did_flag == 3 ? 4 : did_flag;
  if (n < h.size + did_bytes) fail(base, "frame header truncated");
  uint32_t did = 0;
  for (int i = 0; i < did_bytes; ++i) did |= (uint32_t)p[h.size + i] << (8 * i);
  if (did)
    fail(base + h.size, "frame needs a dictionary, which is not supported");
  h.size += did_bytes;
  const int fcs_bytes = fcs_flag == 0 ? single : 1 << fcs_flag;
  if (n < h.size + fcs_bytes) fail(base, "frame header truncated");
  if (fcs_bytes) {
    uint64_t v = 0;
    for (int i = 0; i < fcs_bytes; ++i) v |= (uint64_t)p[h.size + i] << (8 * i);
    if (fcs_bytes == 2) v += 256;
    if (v > (uint64_t)INT64_MAX) fail(base, "frame content size too large");
    h.content_size = (int64_t)v;
    h.size += fcs_bytes;
  }
  if (single) h.window = (uint64_t)h.content_size;
  return h;
}

void decode_all(const uint8_t* src, size_t n, Out& out) {
  size_t pos = 0;
  std::vector<uint8_t> lit_buf(kBlockMax);
  Frame* f = new Frame;
  struct Del {
    Frame* f;
    ~Del() { delete f; }
  } del{f};
  if (n == 0) fail(0, "no zstd frame");
  while (pos < n) {
    if (n - pos < 4) fail(pos, "frame magic truncated");
    const uint32_t magic = rd32(src + pos);
    if ((magic & 0xFFFFFFF0u) == kSkipMagic) {
      if (n - pos < 8) fail(pos, "skippable frame truncated");
      const uint64_t size = rd32(src + pos + 4);
      if (size > n - pos - 8) fail(pos, "skippable frame truncated");
      pos += 8 + size;
      continue;
    }
    if (magic != kMagic) fail(pos, "not a zstd frame (bad magic)");
    pos += 4;
    const Header h = frame_header(src + pos, n - pos, pos);
    pos += h.size;
    *f = Frame();
    const size_t start = out.len;
    const size_t block_max =
        h.window < kBlockMax ? (size_t)h.window : kBlockMax;
    for (;;) {
      if (n - pos < 3) fail(pos, "block header truncated");
      const uint32_t bh = rd24(src + pos);
      const bool last = bh & 1;
      const int type = (bh >> 1) & 3;
      const size_t size = bh >> 3;
      const size_t at = pos;
      pos += 3;
      if (type == 3) fail(at, "reserved block type");
      if (type == 1) {
        if (size > block_max) fail(at, "block larger than allowed");
        if (n - pos < 1) fail(at, "RLE block truncated");
        out.need(size);
        std::memset(out.dst + out.len, src[pos], size);
        out.len += size;
        pos += 1;
      } else {
        if (size > n - pos) fail(at, "block runs past the input");
        if (type == 0) {
          if (size > block_max) fail(at, "block larger than allowed");
          out.need(size);
          std::memcpy(out.dst + out.len, src + pos, size);
          out.len += size;
        } else {
          if (size > kBlockMax) fail(at, "block larger than allowed");
          compressed_block(*f, src + pos, size, pos, out, start, block_max,
                           lit_buf);
        }
        pos += size;
      }
      if (last) break;
    }
    if (h.content_size >= 0 &&
        (uint64_t)(out.len - start) != (uint64_t)h.content_size)
      fail(pos, "frame content size does not match the decoded size");
    if (h.checksum) {
      if (n - pos < 4) fail(pos, "content checksum truncated");
      const uint32_t want = rd32(src + pos);
      if ((uint32_t)xxh64(out.dst + start, out.len - start) != want)
        fail(pos, "content checksum mismatch");
      pos += 4;
    }
  }
}

// CRC-32C (Castagnoli, reflected 0x82F63B78), slicing by 8.
uint32_t crc_table[8][256];
bool crc_init() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = c & 1 ? (c >> 1) ^ 0x82F63B78u : c >> 1;
    crc_table[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; ++i)
    for (int t = 1; t < 8; ++t)
      crc_table[t][i] = (crc_table[t - 1][i] >> 8) ^
                        crc_table[0][crc_table[t - 1][i] & 255];
  return true;
}
const bool crc_ready = crc_init();

}  // namespace

extern "C" int zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst,
                               size_t cap, size_t* out_len, char* msg,
                               int msglen) {
  Out out{dst, cap, 0};
  try {
    decode_all(src, n, out);
  } catch (const Error& e) {
    if (e.code == 1 && msg && msglen > 0)
      std::snprintf(msg, msglen, "%s at byte %zu", e.what, e.offset);
    return e.code;
  } catch (const std::bad_alloc&) {
    if (msg && msglen > 0) std::snprintf(msg, msglen, "out of memory");
    return 1;
  }
  *out_len = out.len;
  return 0;
}

extern "C" int64_t zstd_content_size(const uint8_t* src, size_t n) {
  size_t pos = 0;
  int64_t total = 0;
  try {
    while (pos < n) {
      if (n - pos < 4) return -2;
      const uint32_t magic = rd32(src + pos);
      if ((magic & 0xFFFFFFF0u) == kSkipMagic) {
        if (n - pos < 8) return -2;
        const uint64_t size = rd32(src + pos + 4);
        if (size > n - pos - 8) return -2;
        pos += 8 + size;
        continue;
      }
      if (magic != kMagic) return -2;
      pos += 4;
      const Header h = frame_header(src + pos, n - pos, pos);
      if (h.content_size < 0) return -1;
      total += h.content_size;
      pos += h.size;
      for (;;) {
        if (n - pos < 3) return -2;
        const uint32_t bh = rd24(src + pos);
        pos += 3 + (((bh >> 1) & 3) == 1 ? 1 : (bh >> 3));
        if (pos > n) return -2;
        if (bh & 1) break;
      }
      if (h.checksum) pos += 4;
    }
  } catch (const Error&) {
    return -2;
  }
  return n == 0 ? -2 : total;
}

extern "C" uint32_t crc32c(const uint8_t* p, size_t n, uint32_t crc) {
  crc = ~crc;
  while (n >= 8) {
    const uint64_t v = rd64(p) ^ crc;
    crc = crc_table[7][v & 255] ^ crc_table[6][(v >> 8) & 255] ^
          crc_table[5][(v >> 16) & 255] ^ crc_table[4][(v >> 24) & 255] ^
          crc_table[3][(v >> 32) & 255] ^ crc_table[2][(v >> 40) & 255] ^
          crc_table[1][(v >> 48) & 255] ^ crc_table[0][v >> 56];
    p += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ crc_table[0][(crc ^ *p++) & 255];
  return ~crc;
}
