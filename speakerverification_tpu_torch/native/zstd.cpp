// A Zstandard decoder (RFC 8878) for the orbax reader
// (training/orbax_read.py): the JAX package's OCDBT stores compress their
// manifests, b-tree nodes and zarr chunks with zstd, and the machines that
// serve the port have no zstd module.
//
// Covered: frames with or without a content size (any frame header
// layout), skippable frames, concatenated frames; raw, RLE and compressed
// blocks; raw, RLE, compressed and treeless literals with 1 or 4 Huffman
// streams (weights direct or FSE-compressed); sequences with predefined,
// RLE, FSE-compressed and repeat tables, and the repeat offsets. A frame's
// XXH64 content checksum is checked when `verify` is set (the caller
// always sets it). Dictionaries are refused by name: a frame that names
// one fails with "zstd: dictionaries are not supported".
//
// Built at first use by ops/_build.py (g++ -O3 -std=c++17 -fPIC -shared)
// into the package's _build/ directory, and loaded by
// training/orbax_read.py. The C ABI:
//   svz_content_size(src, n)            -> first frame's content size, -1
//                                          when the header has none, -2 on
//                                          a malformed header
//   svz_decompress(src, n, dst, cap, verify, err, errcap)
//                                       -> bytes written into dst, or -1
//                                          with a message in err
//   svz_decompress_alloc(src, n, &out, verify, err, errcap)
//                                       -> the same into a buffer it
//                                          allocates (free with svz_free)
//   svz_crc32c(src, n)                  -> CRC-32C (OCDBT's file checksum)
//   svz_coverage(out, n), svz_coverage_reset()
//                                       -> counts of the modes met (enum Cov)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  explicit Error(const std::string& m) : std::runtime_error("zstd: " + m) {}
};

inline uint32_t rd16(const uint8_t* p) { return p[0] | (uint32_t(p[1]) << 8); }
inline uint32_t rd24(const uint8_t* p) {
  return p[0] | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16);
}
inline uint32_t rd32(const uint8_t* p) {
  return rd24(p) | (uint32_t(p[3]) << 24);
}
inline uint64_t rd64(const uint8_t* p) {
  return rd32(p) | (uint64_t(rd32(p + 4)) << 32);
}

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// What the decoder met since the last svz_coverage_reset (per thread): the
// tests use it to show which block, literal and sequence modes their frames
// reach.
enum Cov {
  kBlockRaw, kBlockRle, kBlockCompressed,
  kLitRaw, kLitRle, kLitCompressed, kLitTreeless,
  kLit1Stream, kLit4Streams, kHufDirect, kHufFse,
  kSeqNone, kSeqPredefined, kSeqRle, kSeqFse, kSeqRepeat,
  kRep0, kRep1, kRep2, kRep3,
  kFrameSized, kFrameUnsized, kChecksum, kSkippable,
  kCovCount
};
thread_local long long g_cov[kCovCount];

// ---------------------------------------------------------------------------
// output
// ---------------------------------------------------------------------------
struct Out {
  uint8_t* fixed = nullptr;    // caller's buffer, or
  size_t cap = 0;
  std::vector<uint8_t> grow;   // a growing one
  size_t n = 0;

  uint8_t* data() { return fixed ? fixed : grow.data(); }
  void reserve(size_t extra) {
    if (fixed) {
      if (n + extra > cap)
        throw Error("decompressed data exceed the " + std::to_string(cap) +
                    "-byte buffer");
    } else if (n + extra > grow.size()) {
      size_t want = grow.size() * 2;
      if (want < n + extra) want = n + extra;
      if (want < 4096) want = 4096;
      grow.resize(want);
    }
  }
  void put(const uint8_t* p, size_t k) {
    reserve(k);
    memcpy(data() + n, p, k);
    n += k;
  }
  void fill(uint8_t b, size_t k) {
    reserve(k);
    memset(data() + n, b, k);
    n += k;
  }
};

// ---------------------------------------------------------------------------
// bitstreams
// ---------------------------------------------------------------------------
// Forward, little-endian (the FSE table descriptions).
struct FwdBits {
  const uint8_t* p;
  size_t size;
  size_t pos = 0;   // bits consumed
  FwdBits(const uint8_t* p_, size_t n) : p(p_), size(n) {}
  uint32_t peek(int nb) const {
    uint64_t v = 0;
    size_t byte = pos >> 3;
    for (int i = 0; i < 8 && byte + i < size; ++i)
      v |= uint64_t(p[byte + i]) << (8 * i);
    return uint32_t((v >> (pos & 7)) & ((uint64_t(1) << nb) - 1));
  }
  void skip(int nb) { pos += nb; }
  uint32_t read(int nb) { uint32_t v = peek(nb); skip(nb); return v; }
  size_t bytes() const { return (pos + 7) >> 3; }
};

// Backward (Huffman streams, FSE-coded sequences and weights): the stream
// starts at its last byte, whose highest set bit marks the end of padding.
struct BackBits {
  const uint8_t* p;
  size_t size;
  int64_t bits;     // bits not yet read; may go negative (reads zeros)
  BackBits(const uint8_t* p_, size_t n) : p(p_), size(n) {
    if (n == 0) throw Error("empty bitstream");
    uint8_t last = p[n - 1];
    if (last == 0) throw Error("bitstream lacks its end marker");
    bits = int64_t(n - 1) * 8 + highbit(last);
  }
  inline uint32_t peek(int nb) const {
    if (nb == 0) return 0;
    int64_t start = bits - nb;
    uint64_t mask = (uint64_t(1) << nb) - 1;
    if (start >= 0) {
      size_t byte = size_t(start >> 3);
      uint64_t v = 0;
      if (byte + 8 <= size) {
        memcpy(&v, p + byte, 8);
      } else {
        for (size_t i = byte, s = 0; i < size; ++i, s += 8)
          v |= uint64_t(p[i]) << s;
      }
      return uint32_t((v >> (start & 7)) & mask);
    }
    if (bits <= 0) return 0;
    // fewer bits left than asked: the missing low bits read as zeros
    uint64_t v = 0;
    size_t end = size_t((bits + 7) >> 3);
    for (size_t i = 0; i < end; ++i) v |= uint64_t(p[i]) << (8 * i);
    v &= (uint64_t(1) << bits) - 1;
    return uint32_t((v << (-start)) & mask);
  }
  inline uint32_t read(int nb) {
    uint32_t v = peek(nb);
    bits -= nb;
    return v;
  }
  bool overflowed() const { return bits < 0; }
};

// ---------------------------------------------------------------------------
// FSE
// ---------------------------------------------------------------------------
struct FseEntry {
  uint16_t symbol;
  uint8_t nb_bits;
  uint16_t base;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> t;
};

// Read a normalized distribution (RFC 8878 4.1.1); returns bytes used.
size_t read_ncount(const uint8_t* src, size_t n, int max_log, int max_sym,
                   std::vector<int16_t>& norm, int* log_out) {
  if (n == 0) throw Error("empty FSE table description");
  FwdBits b(src, n);
  int log = int(b.read(4)) + 5;
  if (log > max_log)
    throw Error("FSE accuracy log " + std::to_string(log) + " above " +
                std::to_string(max_log));
  norm.assign(max_sym + 1, 0);
  int remaining = (1 << log) + 1;
  int threshold = 1 << log;
  int nb = log + 1;
  int sym = 0;
  bool prev0 = false;
  while (remaining > 1 && sym <= max_sym) {
    if (prev0) {
      for (;;) {
        uint32_t r = b.read(2);
        sym += int(r);
        if (r != 3) break;
      }
      if (sym > max_sym) throw Error("FSE zero run past the last symbol");
    }
    int max = (2 * threshold - 1) - remaining;
    int count;
    uint32_t low = b.peek(nb - 1);
    if (int(low) < max) {
      count = int(low);
      b.skip(nb - 1);
    } else {
      count = int(b.peek(nb));
      if (count >= threshold) count -= max;
      b.skip(nb);
    }
    count -= 1;
    remaining -= count < 0 ? -count : count;
    norm[sym++] = int16_t(count);
    prev0 = count == 0;
    while (remaining < threshold) {
      nb -= 1;
      threshold >>= 1;
    }
  }
  if (remaining != 1) throw Error("FSE distribution does not sum to 1");
  if (b.bytes() > n) throw Error("FSE table description overruns");
  *log_out = log;
  return b.bytes();
}

void build_fse(const std::vector<int16_t>& norm, int log, FseTable& out) {
  int size = 1 << log;
  out.log = log;
  out.t.assign(size, FseEntry{0, 0, 0});
  std::vector<uint32_t> next(norm.size());
  int high = size - 1;
  for (size_t s = 0; s < norm.size(); ++s) {
    if (norm[s] == -1) {
      out.t[high--].symbol = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint32_t(norm[s] < 0 ? 0 : norm[s]);
    }
  }
  int pos = 0, step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  for (size_t s = 0; s < norm.size(); ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      out.t[pos].symbol = uint16_t(s);
      do {
        pos = (pos + step) & mask;
      } while (pos > high);
    }
  }
  if (pos != 0) throw Error("FSE table spread did not close");
  for (int u = 0; u < size; ++u) {
    uint32_t s = out.t[u].symbol;
    uint32_t state = next[s]++;
    int nb = log - highbit(state);
    out.t[u].nb_bits = uint8_t(nb);
    out.t[u].base = uint16_t((state << nb) - size);
  }
}

void rle_fse(int symbol, FseTable& out) {
  out.log = 0;
  out.t.assign(1, FseEntry{uint16_t(symbol), 0, 0});
}

struct FseState {
  const FseTable* tab;
  uint32_t state;
  void init(BackBits& b, const FseTable& t) {
    tab = &t;
    state = b.read(t.log);
  }
  uint16_t symbol() const { return tab->t[state].symbol; }
  void update(BackBits& b) {
    const FseEntry& e = tab->t[state];
    state = e.base + b.read(e.nb_bits);
  }
};

// ---------------------------------------------------------------------------
// Huffman
// ---------------------------------------------------------------------------
struct HufTable {
  int max_bits = 0;
  std::vector<uint16_t> t;     // 1 << max_bits entries: symbol | bits << 8
  bool present = false;
};

// The tree description (RFC 8878 4.2.1); returns bytes used.
size_t read_huffman(const uint8_t* src, size_t n, HufTable& h) {
  if (n == 0) throw Error("empty Huffman tree description");
  uint8_t header = src[0];
  std::vector<uint8_t> w;
  size_t used;
  if (header >= 128) {
    g_cov[kHufDirect]++;
    size_t count = header - 127;
    used = 1 + (count + 1) / 2;
    if (used > n) throw Error("Huffman weights overrun");
    w.resize(count);
    for (size_t i = 0; i < count; ++i) {
      uint8_t byte = src[1 + i / 2];
      w[i] = (i % 2 == 0) ? (byte >> 4) : (byte & 15);
    }
  } else {
    g_cov[kHufFse]++;
    used = 1 + header;
    if (used > n) throw Error("Huffman weights overrun");
    std::vector<int16_t> norm;
    int log;
    size_t d = read_ncount(src + 1, header, 6, 255, norm, &log);
    FseTable t;
    build_fse(norm, log, t);
    BackBits b(src + 1 + d, header - d);
    FseState s1, s2;
    s1.init(b, t);
    s2.init(b, t);
    for (;;) {
      if (w.size() >= 255) throw Error("too many Huffman weights");
      w.push_back(uint8_t(s1.symbol()));
      s1.update(b);
      if (b.overflowed()) {
        w.push_back(uint8_t(s2.symbol()));
        break;
      }
      if (w.size() >= 255) throw Error("too many Huffman weights");
      w.push_back(uint8_t(s2.symbol()));
      s2.update(b);
      if (b.overflowed()) {
        w.push_back(uint8_t(s1.symbol()));
        break;
      }
    }
  }
  // the last symbol's weight completes the sum to a power of two
  uint32_t total = 0;
  for (uint8_t x : w) {
    if (x > 11) throw Error("Huffman weight above 11");
    if (x) total += 1u << (x - 1);
  }
  if (total == 0) throw Error("Huffman weights are all zero");
  int max_bits = highbit(total) + 1;
  uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) throw Error("Huffman weights do not close");
  w.push_back(uint8_t(highbit(rest) + 1));
  if (max_bits > 11) throw Error("Huffman code longer than 11 bits");
  if (w.size() > 256) throw Error("too many Huffman symbols");

  h.max_bits = max_bits;
  h.t.assign(size_t(1) << max_bits, 0);
  std::vector<uint32_t> count(max_bits + 2, 0), start(max_bits + 2, 0);
  for (uint8_t x : w) count[x]++;
  uint32_t at = 0;
  for (int x = 1; x <= max_bits; ++x) {
    start[x] = at;
    at += count[x] << (x - 1);
  }
  for (size_t s = 0; s < w.size(); ++s) {
    uint8_t x = w[s];
    if (!x) continue;
    uint32_t len = (1u << x) >> 1;
    for (uint32_t i = 0; i < len; ++i) {
      h.t[start[x] + i] = uint16_t(s | (max_bits + 1 - x) << 8);
    }
    start[x] += len;
  }
  h.present = true;
  return used;
}

// One Huffman stream being decoded: its bits (BackBits) and its output.
struct HufCursor {
  BackBits b;
  uint8_t* dst;
  size_t left;
};

// Decode `k` streams in turns, five codes from each per 8-byte load (a
// code has at most 11 bits, and one load gives 56), while every stream
// has five codes left and eight bytes below its read position; the
// streams' independent chains overlap in the core. Returns with each
// stream's rest for huf_finish.
void huf_fast(const HufTable& h, HufCursor* c, int k) {
  const int mb = h.max_bits;
  const uint16_t* tab = h.t.data();
  const uint64_t mask = (uint64_t(1) << mb) - 1;
  for (;;) {
    uint64_t w[4];
    int avail[4];
    int64_t lo[4];
    for (int j = 0; j < k; ++j) {
      lo[j] = c[j].b.bits - 56;
      if (c[j].left < 5 || lo[j] < 0 || size_t(lo[j] >> 3) + 8 > c[j].b.size)
        return;
    }
    for (int j = 0; j < k; ++j) {
      memcpy(&w[j], c[j].b.p + (lo[j] >> 3), 8);
      w[j] >>= (lo[j] & 7);
      avail[j] = 56;
    }
    for (int r = 0; r < 5; ++r) {
      for (int j = 0; j < k; ++j) {
        uint16_t e = tab[(w[j] >> (avail[j] - mb)) & mask];
        *c[j].dst++ = uint8_t(e);
        avail[j] -= e >> 8;
      }
    }
    for (int j = 0; j < k; ++j) {
      c[j].b.bits = lo[j] + avail[j];
      c[j].left -= 5;
    }
  }
}

void huf_finish(const HufTable& h, HufCursor& c) {
  const int mb = h.max_bits;
  for (; c.left; --c.left) {
    uint16_t e = h.t[c.b.peek(mb)];
    *c.dst++ = uint8_t(e);
    c.b.bits -= e >> 8;
  }
  if (c.b.bits != 0) throw Error("Huffman stream not consumed exactly");
}

// ---------------------------------------------------------------------------
// frames
// ---------------------------------------------------------------------------
const int16_t kLLNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                             2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                             2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,    5,    6,    7,    8,
                              9,  10, 11,  12,  13,   14,   15,   16,   18,
                              20, 22, 24,  28,  32,   40,   48,   64,   128,
                              256, 512, 1024, 2048, 4096, 8192, 16384, 32768,
                              65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13,  14,  15,  16,   17,   18,
    19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,  30,  31,  32,   33,   34,
    35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051,
    4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct FrameState {
  HufTable huf;
  FseTable ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint32_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> lit;
};

// One table of the sequences section; returns bytes used.
size_t seq_table(int mode, const uint8_t* p, size_t n, const int16_t* pre,
                 int pre_n, int pre_log, int max_log, int max_sym,
                 FseTable& t, bool& have, const char* what) {
  g_cov[kSeqPredefined + mode]++;
  if (mode == 0) {
    std::vector<int16_t> norm(pre, pre + pre_n);
    build_fse(norm, pre_log, t);
    have = true;
    return 0;
  }
  if (mode == 1) {
    if (n < 1) throw Error(std::string(what) + " RLE symbol missing");
    if (p[0] > max_sym) throw Error(std::string(what) + " symbol too large");
    rle_fse(p[0], t);
    have = true;
    return 1;
  }
  if (mode == 2) {
    std::vector<int16_t> norm;
    int log;
    size_t used = read_ncount(p, n, max_log, max_sym, norm, &log);
    build_fse(norm, log, t);
    have = true;
    return used;
  }
  if (!have) throw Error(std::string(what) + " repeat mode with no table");
  return 0;
}

void compressed_block(const uint8_t* p, size_t n, FrameState& fs, Out& out,
                      size_t frame_start) {
  if (n < 1) throw Error("empty compressed block");
  // --- literals
  uint8_t b0 = p[0];
  int ltype = b0 & 3, sf = (b0 >> 2) & 3;
  size_t regen = 0, comp = 0, hsize = 0;
  int streams = 1;
  if (ltype < 2) {
    if (sf == 0 || sf == 2) {
      regen = b0 >> 3;
      hsize = 1;
    } else if (sf == 1) {
      if (n < 2) throw Error("literals header truncated");
      regen = (b0 >> 4) + (uint32_t(p[1]) << 4);
      hsize = 2;
    } else {
      if (n < 3) throw Error("literals header truncated");
      regen = (b0 >> 4) + (uint32_t(p[1]) << 4) + (uint32_t(p[2]) << 12);
      hsize = 3;
    }
  } else {
    if (sf <= 1) {
      if (n < 3) throw Error("literals header truncated");
      uint32_t v = rd24(p);
      regen = (v >> 4) & 0x3FF;
      comp = (v >> 14) & 0x3FF;
      hsize = 3;
      streams = sf == 0 ? 1 : 4;
    } else if (sf == 2) {
      if (n < 4) throw Error("literals header truncated");
      uint32_t v = rd32(p);
      regen = (v >> 4) & 0x3FFF;
      comp = v >> 18;
      hsize = 4;
      streams = 4;
    } else {
      if (n < 5) throw Error("literals header truncated");
      uint64_t v = rd32(p) | (uint64_t(p[4]) << 32);
      regen = (v >> 4) & 0x3FFFF;
      comp = (v >> 22) & 0x3FFFF;
      hsize = 5;
      streams = 4;
    }
  }
  fs.lit.resize(regen);
  g_cov[kLitRaw + ltype]++;
  if (ltype >= 2) g_cov[streams == 1 ? kLit1Stream : kLit4Streams]++;
  size_t at = hsize;
  if (ltype == 0) {
    if (at + regen > n) throw Error("raw literals overrun the block");
    memcpy(fs.lit.data(), p + at, regen);
    at += regen;
  } else if (ltype == 1) {
    if (at + 1 > n) throw Error("RLE literal missing");
    memset(fs.lit.data(), p[at], regen);
    at += 1;
  } else {
    if (at + comp > n) throw Error("compressed literals overrun the block");
    const uint8_t* q = p + at;
    size_t qn = comp;
    if (ltype == 2) {
      size_t used = read_huffman(q, qn, fs.huf);
      q += used;
      qn -= used;
    } else if (!fs.huf.present) {
      throw Error("treeless literals with no previous Huffman table");
    }
    if (streams == 1) {
      HufCursor c{BackBits(q, qn), fs.lit.data(), regen};
      huf_fast(fs.huf, &c, 1);
      huf_finish(fs.huf, c);
    } else {
      if (qn < 6) throw Error("jump table truncated");
      size_t s1 = rd16(q), s2 = rd16(q + 2), s3 = rd16(q + 4);
      if (6 + s1 + s2 + s3 > qn) throw Error("jump table overruns");
      size_t s4 = qn - 6 - s1 - s2 - s3;
      size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) throw Error("too few literals for 4 streams");
      const uint8_t* d = q + 6;
      uint8_t* o = fs.lit.data();
      HufCursor c[4] = {{BackBits(d, s1), o, seg},
                        {BackBits(d + s1, s2), o + seg, seg},
                        {BackBits(d + s1 + s2, s3), o + 2 * seg, seg},
                        {BackBits(d + s1 + s2 + s3, s4), o + 3 * seg,
                         regen - 3 * seg}};
      huf_fast(fs.huf, c, 4);
      for (HufCursor& one : c) huf_finish(fs.huf, one);
    }
    at += comp;
  }

  // --- sequences
  if (at >= n) throw Error("sequences section missing");
  const uint8_t* s = p + at;
  size_t sn = n - at;
  size_t nseq;
  size_t sat;
  if (s[0] < 128) {
    nseq = s[0];
    sat = 1;
  } else if (s[0] < 255) {
    if (sn < 2) throw Error("sequence count truncated");
    nseq = (size_t(s[0] - 128) << 8) + s[1];
    sat = 2;
  } else {
    if (sn < 3) throw Error("sequence count truncated");
    nseq = s[1] + (size_t(s[2]) << 8) + 0x7F00;
    sat = 3;
  }
  if (nseq == 0) {
    g_cov[kSeqNone]++;
    out.put(fs.lit.data(), regen);
    return;
  }
  if (sat >= sn) throw Error("compression modes missing");
  uint8_t modes = s[sat++];
  if (modes & 3) throw Error("reserved bits of the compression modes set");
  sat += seq_table(modes >> 6, s + sat, sn - sat, kLLNorm, 36, 6, 9, 35,
                   fs.ll, fs.have_ll, "literals-length");
  sat += seq_table((modes >> 4) & 3, s + sat, sn - sat, kOFNorm, 29, 5, 8,
                   31, fs.of, fs.have_of, "offset");
  sat += seq_table((modes >> 2) & 3, s + sat, sn - sat, kMLNorm, 53, 6, 9,
                   52, fs.ml, fs.have_ml, "match-length");
  if (sat > sn) throw Error("sequence tables overrun the block");

  BackBits b(s + sat, sn - sat);
  FseState ll, of, ml;
  ll.init(b, fs.ll);
  of.init(b, fs.of);
  ml.init(b, fs.ml);
  const uint8_t* lit = fs.lit.data();
  size_t lit_left = regen;
  for (size_t i = 0; i < nseq; ++i) {
    uint32_t ofc = of.symbol(), mlc = ml.symbol(), llc = ll.symbol();
    if (ofc > 31 || mlc > 52 || llc > 35)
      throw Error("sequence code out of range");
    uint32_t ofv = (1u << ofc) + b.read(int(ofc));
    uint32_t mlen = kMLBase[mlc] + b.read(kMLBits[mlc]);
    uint32_t llen = kLLBase[llc] + b.read(kLLBits[llc]);
    uint32_t off;
    if (ofv > 3) {
      off = ofv - 3;
      fs.rep[2] = fs.rep[1];
      fs.rep[1] = fs.rep[0];
      fs.rep[0] = off;
    } else {
      uint32_t idx = ofv - 1 + (llen == 0 ? 1 : 0);
      g_cov[kRep0 + idx]++;
      if (idx == 0) {
        off = fs.rep[0];
      } else {
        off = idx == 3 ? fs.rep[0] - 1 : fs.rep[idx];
        if (idx >= 2) fs.rep[2] = fs.rep[1];
        fs.rep[1] = fs.rep[0];
        fs.rep[0] = off;
      }
    }
    if (i + 1 < nseq) {
      ll.update(b);
      ml.update(b);
      of.update(b);
    }
    if (llen > lit_left) throw Error("sequence takes more literals than left");
    out.put(lit, llen);
    lit += llen;
    lit_left -= llen;
    if (off == 0 || off > out.n - frame_start)
      throw Error("match offset reaches before the frame");
    out.reserve(mlen);
    uint8_t* d = out.data() + out.n;
    const uint8_t* src = d - off;
    if (off >= mlen) {
      memcpy(d, src, mlen);
    } else {
      for (uint32_t k = 0; k < mlen; ++k) d[k] = src[k];
    }
    out.n += mlen;
  }
  if (b.bits != 0) throw Error("sequence bitstream not consumed exactly");
  out.put(lit, lit_left);
}

// XXH64 of the frame's content (its low 32 bits are the checksum).
uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
const uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
               P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
               P5 = 2870177450012600261ULL;
uint64_t round64(uint64_t acc, uint64_t in) {
  acc += in * P2;
  return rotl(acc, 31) * P1;
}
uint64_t merge64(uint64_t acc, uint64_t v) {
  acc ^= round64(0, v);
  return acc * P1 + P4;
}
uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t* lim = end - 32;
    do {
      v1 = round64(v1, rd64(p));
      v2 = round64(v2, rd64(p + 8));
      v3 = round64(v3, rd64(p + 16));
      v4 = round64(v4, rd64(p + 24));
      p += 32;
    } while (p <= lim);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge64(h, v1);
    h = merge64(h, v2);
    h = merge64(h, v3);
    h = merge64(h, v4);
  } else {
    h = P5;
  }
  h += uint64_t(n);
  while (p + 8 <= end) {
    h ^= round64(0, rd64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= uint64_t(rd32(p)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p) * P5;
    h = rotl(h, 11) * P1;
    ++p;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

struct Header {
  size_t size;            // header bytes after the magic
  int64_t content = -1;   // -1: not stated
  bool checksum = false;
};

Header frame_header(const uint8_t* p, size_t n) {
  if (n < 1) throw Error("frame header truncated");
  uint8_t fhd = p[0];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, dict_flag = fhd & 3;
  if (fhd & 8) throw Error("reserved bit of the frame header set");
  Header h;
  h.checksum = (fhd >> 2) & 1;
  size_t at = 1;
  if (!single) at += 1;   // window descriptor
  static const int dict_sizes[4] = {0, 1, 2, 4};
  size_t dsz = dict_sizes[dict_flag];
  if (at + dsz > n) throw Error("frame header truncated");
  uint32_t dict = 0;
  for (size_t i = 0; i < dsz; ++i) dict |= uint32_t(p[at + i]) << (8 * i);
  if (dict != 0)
    throw Error("dictionaries are not supported (the frame names dictionary " +
                std::to_string(dict) + ")");
  at += dsz;
  static const int fcs_sizes[4] = {0, 2, 4, 8};
  size_t fsz = fcs_sizes[fcs_flag];
  if (fcs_flag == 0 && single) fsz = 1;
  if (at + fsz > n) throw Error("frame header truncated");
  if (fsz) {
    uint64_t v = 0;
    for (size_t i = 0; i < fsz; ++i) v |= uint64_t(p[at + i]) << (8 * i);
    if (fsz == 2) v += 256;
    h.content = int64_t(v);
  }
  h.size = at + fsz;
  return h;
}

void decompress(const uint8_t* src, size_t n, Out& out, bool verify) {
  size_t at = 0;
  if (n == 0) throw Error("no data");
  while (at < n) {
    if (n - at < 4) throw Error("trailing bytes after the last frame");
    uint32_t magic = rd32(src + at);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {   // skippable frame
      if (n - at < 8) throw Error("skippable frame truncated");
      size_t len = rd32(src + at + 4);
      if (len > n - at - 8) throw Error("skippable frame truncated");
      at += 8 + len;
      g_cov[kSkippable]++;
      continue;
    }
    if (magic != 0xFD2FB528u) throw Error("not a zstd frame (bad magic)");
    at += 4;
    Header h = frame_header(src + at, n - at);
    at += h.size;
    size_t frame_start = out.n;
    g_cov[h.content >= 0 ? kFrameSized : kFrameUnsized]++;
    if (h.content >= 0) out.reserve(size_t(h.content));
    FrameState fs;
    for (;;) {
      if (n - at < 3) throw Error("block header truncated");
      uint32_t bh = rd24(src + at);
      at += 3;
      bool last = bh & 1;
      int type = (bh >> 1) & 3;
      size_t size = bh >> 3;
      if (type < 3) g_cov[kBlockRaw + type]++;
      if (type == 0) {
        if (size > n - at) throw Error("raw block overruns the input");
        out.put(src + at, size);
        at += size;
      } else if (type == 1) {
        if (n - at < 1) throw Error("RLE block truncated");
        out.fill(src[at], size);
        at += 1;
      } else if (type == 2) {
        if (size > n - at) throw Error("compressed block overruns the input");
        compressed_block(src + at, size, fs, out, frame_start);
        at += size;
      } else {
        throw Error("reserved block type");
      }
      if (last) break;
    }
    size_t produced = out.n - frame_start;
    if (h.content >= 0 && produced != size_t(h.content))
      throw Error("frame content size " + std::to_string(h.content) +
                  " but " + std::to_string(produced) + " bytes decoded");
    if (h.checksum) {
      g_cov[kChecksum]++;
      if (n - at < 4) throw Error("content checksum truncated");
      if (verify) {
        uint32_t want = rd32(src + at);
        uint32_t got =
            uint32_t(xxh64(out.data() + frame_start, produced) & 0xFFFFFFFFu);
        if (want != got) throw Error("content checksum mismatch");
      }
      at += 4;
    }
  }
}

// CRC-32C (Castagnoli, reflected), which guards OCDBT's manifests and nodes.
struct CrcTable {
  uint32_t t[256];
  CrcTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[i] = c;
    }
  }
};

uint32_t crc32c(const uint8_t* p, size_t n) {
  static const CrcTable table;   // initialized once, thread-safely
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) c = table.t[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

void set_err(char* err, size_t cap, const char* msg) {
  if (err && cap) {
    snprintf(err, cap, "%s", msg);
  }
}

}  // namespace

extern "C" {

long long svz_content_size(const uint8_t* src, size_t n) {
  try {
    if (n < 4 || rd32(src) != 0xFD2FB528u) return -2;
    return frame_header(src + 4, n - 4).content;
  } catch (const std::exception&) {
    return -2;
  }
}

long long svz_decompress(const uint8_t* src, size_t n, uint8_t* dst,
                         size_t cap, int verify, char* err, size_t errcap) {
  try {
    Out out;
    out.fixed = dst;
    out.cap = cap;
    decompress(src, n, out, verify != 0);
    return (long long)out.n;
  } catch (const std::exception& e) {
    set_err(err, errcap, e.what());
    return -1;
  }
}

long long svz_decompress_alloc(const uint8_t* src, size_t n, uint8_t** dst,
                               int verify, char* err, size_t errcap) {
  *dst = nullptr;
  try {
    Out out;
    decompress(src, n, out, verify != 0);
    uint8_t* buf = static_cast<uint8_t*>(malloc(out.n ? out.n : 1));
    if (!buf) throw Error("out of memory");
    memcpy(buf, out.data(), out.n);
    *dst = buf;
    return (long long)out.n;
  } catch (const std::exception& e) {
    set_err(err, errcap, e.what());
    return -1;
  }
}

void svz_free(uint8_t* p) { free(p); }

int svz_coverage(long long* out, int n) {
  int k = n < kCovCount ? n : kCovCount;
  for (int i = 0; i < k; ++i) out[i] = g_cov[i];
  return kCovCount;
}

void svz_coverage_reset() { memset(g_cov, 0, sizeof(g_cov)); }

unsigned svz_crc32c(const uint8_t* p, size_t n) { return crc32c(p, n); }

}  // extern "C"
