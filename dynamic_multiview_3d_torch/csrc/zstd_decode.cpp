// A Zstandard decoder (RFC 8878) for the Orbax checkpoint reader: zarr
// chunks and OCDBT nodes are zstd frames, and the machine with the GPU has
// no zstd module. Host code, built with g++ and bound with ctypes
// (utils/zstd.py).
//
// It decodes every frame the format allows except those that name a
// dictionary: raw, RLE and compressed blocks; raw, RLE, compressed and
// treeless literals in 1 or 4 streams; Huffman weights FSE-coded or given
// directly; sequences in predefined, RLE, FSE and repeat modes; repeat
// offsets; the XXH64 content checksum (verified); skippable and
// concatenated frames. Every read and write is bounds-checked: a truncated
// or corrupt input, or an output larger than the caller's capacity, is an
// error with a message, never an access out of range.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const char* what) { throw Error(what); }

inline void check(bool ok, const char* what) {
  if (!ok) fail(what);
}

inline uint32_t load_le32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
         uint32_t(p[3]) << 24;
}

inline uint64_t load_le64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);  // x86 and aarch64 hosts are little-endian
  return v;
}

inline int highbit32(uint32_t v) { return 31 - __builtin_clz(v); }

// How often each path of the format was taken, for the tests to show that
// their frames reach every one (dmv3d_zstd_path_counts); counted per frame,
// block or section, never per symbol.
enum Path {
  FRAME_SINGLE_SEGMENT, FRAME_WINDOWED, FRAME_NO_CONTENT_SIZE,
  FRAME_CHECKSUM, FRAME_SKIPPABLE, BLOCK_RAW, BLOCK_RLE, BLOCK_COMPRESSED,
  LIT_RAW, LIT_RLE, LIT_COMPRESSED, LIT_TREELESS, LIT_1_STREAM,
  LIT_4_STREAMS, WEIGHTS_FSE, WEIGHTS_DIRECT, SEQ_NONE, SEQ_PREDEFINED,
  SEQ_RLE, SEQ_FSE, SEQ_REPEAT, OFFSET_REPEAT, OFFSET_REPEAT_LL0, N_PATHS
};
std::atomic<uint64_t> path_count[N_PATHS];
inline void took(Path p) {
  path_count[p].fetch_add(1, std::memory_order_relaxed);
}

// ---------------------------------------------------------------- XXH64
constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xxh_round(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t xxh_merge(uint64_t acc, uint64_t v) {
  return (acc ^ xxh_round(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; end - p >= 32; p += 32) {
      v1 = xxh_round(v1, load_le64(p));
      v2 = xxh_round(v2, load_le64(p + 8));
      v3 = xxh_round(v3, load_le64(p + 16));
      v4 = xxh_round(v4, load_le64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxh_merge(xxh_merge(xxh_merge(xxh_merge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += n;
  for (; end - p >= 8; p += 8)
    h = rotl(h ^ xxh_round(0, load_le64(p)), 27) * P1 + P4;
  if (end - p >= 4) {
    h = rotl(h ^ (uint64_t(load_le32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ------------------------------------------------------------ bit readers
// Forward reader (FSE table descriptions): bits from the lowest of each
// byte up. Reading past the end is an error.
struct ForwardBits {
  const uint8_t* p;
  size_t n_bytes;
  size_t pos = 0;  // bits consumed
  ForwardBits(const uint8_t* p_, size_t n) : p(p_), n_bytes(n) {}
  uint32_t peek(int nb) const {  // nb <= 25; zero past the end
    uint32_t v = 0;
    for (int i = 0; i < nb; ++i) {
      size_t b = pos + i;
      if ((b >> 3) < n_bytes) v |= uint32_t((p[b >> 3] >> (b & 7)) & 1) << i;
    }
    return v;
  }
  void skip(int nb) {
    pos += nb;
    check((pos + 7) / 8 <= n_bytes, "corrupt frame: FSE table description "
                                    "runs past its section");
  }
  uint32_t read(int nb) {
    uint32_t v = peek(nb);
    skip(nb);
    return v;
  }
  size_t bytes_used() const { return (pos + 7) / 8; }
};

// Backward reader (Huffman streams, FSE bitstreams): the stream is one
// little-endian number read from its highest bit down, after the padding
// marker (the highest set bit of the last byte). Reading below bit 0 gives
// zeros and drives `pos` negative, which the callers detect.
struct BackwardBits {
  const uint8_t* p;
  size_t n_bytes;
  int64_t pos;  // bits left
  BackwardBits(const uint8_t* p_, size_t n) : p(p_), n_bytes(n) {
    check(n > 0, "corrupt frame: empty bitstream");
    uint8_t last = p[n - 1];
    check(last != 0, "corrupt frame: bitstream without its end marker");
    pos = int64_t(n - 1) * 8 + highbit32(last);
  }
  // the nb (<= 56) bits below pos, as a number; zeros below bit 0
  inline uint64_t peek(int nb) const {
    if (nb == 0) return 0;
    int64_t lo = pos - nb;
    if (lo >= 0 && size_t(lo >> 3) + 8 <= n_bytes)
      return (load_le64(p + (lo >> 3)) >> (lo & 7)) & ((1ULL << nb) - 1);
    uint64_t v = 0;
    for (int i = nb - 1; i >= 0; --i) {
      int64_t b = lo + i;
      v <<= 1;
      if (b >= 0) v |= (p[b >> 3] >> (b & 7)) & 1;
    }
    return v;
  }
  inline void skip(int nb) { pos -= nb; }
  inline uint64_t read(int nb) {
    uint64_t v = peek(nb);
    pos -= nb;
    return v;
  }
  bool overflowed() const { return pos < 0; }
};

// -------------------------------------------------------------------- FSE
struct FseEntry {
  uint16_t symbol;
  uint8_t nb_bits;
  uint16_t baseline;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> cells;
};

// Reads a table description (RFC 8878 4.1.1) -> normalized counts.
// Returns the bytes it used.
size_t read_fse_counts(const uint8_t* p, size_t n, int max_log, int max_symbol,
                       std::vector<int16_t>& counts, int& log) {
  ForwardBits bits(p, n);
  check(n > 0, "corrupt frame: missing FSE table description");
  log = int(bits.read(4)) + 5;
  check(log <= max_log, "corrupt frame: FSE accuracy log too large");
  counts.assign(max_symbol + 1, 0);
  int remaining = (1 << log) + 1;
  int threshold = 1 << log;
  int nb = log + 1;
  int sym = 0;
  bool previous0 = false;
  while (remaining > 1) {
    check(sym <= max_symbol, "corrupt frame: FSE table has too many symbols");
    if (previous0) {
      int n0 = sym;
      for (;;) {
        uint32_t r = bits.read(2);
        n0 += int(r);
        check(n0 <= max_symbol + 1, "corrupt frame: FSE zero run too long");
        if (r != 3) break;
      }
      sym = n0;  // counts[...] already 0
      check(sym <= max_symbol, "corrupt frame: FSE table has too many "
                               "symbols");
    }
    int max = (2 * threshold - 1) - remaining;
    int value;
    uint32_t low = bits.peek(nb - 1);
    if (int(low) < max) {
      value = int(low);
      bits.skip(nb - 1);
    } else {
      value = int(bits.peek(nb));
      if (value >= threshold) value -= max;
      bits.skip(nb);
    }
    int count = value - 1;
    remaining -= count < 0 ? -count : count;
    counts[sym++] = int16_t(count);
    previous0 = count == 0;
    check(remaining >= 1, "corrupt frame: FSE probabilities overflow");
    while (remaining < threshold) {
      --nb;
      threshold >>= 1;
    }
  }
  check(remaining == 1, "corrupt frame: FSE probabilities do not sum");
  counts.resize(sym);
  return bits.bytes_used();
}

void build_fse(const std::vector<int16_t>& counts, int log, FseTable& t) {
  int size = 1 << log;
  t.log = log;
  t.cells.assign(size, FseEntry{0, 0, 0});
  std::vector<uint16_t> next(counts.size());
  int high = size - 1;
  for (size_t s = 0; s < counts.size(); ++s) {
    if (counts[s] == -1) {
      check(high >= 0, "corrupt frame: FSE table overfull");
      t.cells[high--].symbol = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint16_t(counts[s]);
    }
  }
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (size_t s = 0; s < counts.size(); ++s) {
    for (int i = 0; i < counts[s]; ++i) {
      t.cells[pos].symbol = uint16_t(s);
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  }
  check(pos == 0, "corrupt frame: FSE counts do not fill the table");
  for (int u = 0; u < size; ++u) {
    uint16_t s = t.cells[u].symbol;
    uint32_t state = next[s]++;
    check(state > 0, "corrupt frame: FSE state");
    int nb = log - highbit32(state);
    t.cells[u].nb_bits = uint8_t(nb);
    t.cells[u].baseline = uint16_t((state << nb) - size);
  }
}

void build_rle(uint8_t symbol, FseTable& t) {
  t.log = 0;
  t.cells.assign(1, FseEntry{symbol, 0, 0});
}

// ---------------------------------------------------------------- Huffman
struct Huffman {
  int max_bits = 0;
  std::vector<uint16_t> cell;  // by the next max_bits bits: symbol << 8 | bits
};

// Reads a Huffman tree description (RFC 8878 4.2.1). Returns bytes used.
size_t read_huffman(const uint8_t* p, size_t n, Huffman& h) {
  check(n >= 1, "corrupt frame: missing Huffman tree description");
  uint8_t weights[256];
  int n_weights;
  size_t used;
  uint8_t header = p[0];
  if (header >= 128) {  // 4-bit weights, given directly
    took(WEIGHTS_DIRECT);
    n_weights = header - 127;
    used = 1 + (n_weights + 1) / 2;
    check(used <= n, "corrupt frame: Huffman weights truncated");
    for (int i = 0; i < n_weights; ++i) {
      uint8_t b = p[1 + i / 2];
      weights[i] = (i % 2 == 0) ? b >> 4 : b & 15;
    }
  } else {  // FSE-coded weights, two interleaved states
    took(WEIGHTS_FSE);
    used = 1 + size_t(header);
    check(used <= n, "corrupt frame: Huffman weights truncated");
    std::vector<int16_t> counts;
    int log;
    size_t desc = read_fse_counts(p + 1, header, 6, 255, counts, log);
    check(desc < header, "corrupt frame: Huffman weights have no bitstream");
    FseTable t;
    build_fse(counts, log, t);
    BackwardBits bits(p + 1 + desc, header - desc);
    uint32_t s1 = uint32_t(bits.read(log)), s2 = uint32_t(bits.read(log));
    n_weights = 0;
    for (;;) {
      check(n_weights < 255, "corrupt frame: too many Huffman weights");
      const FseEntry& e1 = t.cells[s1];
      weights[n_weights++] = uint8_t(e1.symbol);
      s1 = e1.baseline + uint32_t(bits.read(e1.nb_bits));
      if (bits.overflowed()) {
        check(n_weights < 255, "corrupt frame: too many Huffman weights");
        weights[n_weights++] = uint8_t(t.cells[s2].symbol);
        break;
      }
      check(n_weights < 255, "corrupt frame: too many Huffman weights");
      const FseEntry& e2 = t.cells[s2];
      weights[n_weights++] = uint8_t(e2.symbol);
      s2 = e2.baseline + uint32_t(bits.read(e2.nb_bits));
      if (bits.overflowed()) {
        check(n_weights < 255, "corrupt frame: too many Huffman weights");
        weights[n_weights++] = uint8_t(t.cells[s1].symbol);
        break;
      }
    }
  }
  // the last weight is implied: the total must reach a power of 2
  uint32_t total = 0;
  for (int i = 0; i < n_weights; ++i) {
    check(weights[i] <= 11, "corrupt frame: Huffman weight too large");
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  check(total > 0, "corrupt frame: Huffman weights all zero");
  int max_bits = highbit32(total) + 1;
  check(max_bits <= 11, "corrupt frame: Huffman code too long");
  uint32_t left = (1u << max_bits) - total;
  check(left > 0 && (left & (left - 1)) == 0,
        "corrupt frame: Huffman weights do not complete a tree");
  check(n_weights < 256, "corrupt frame: too many Huffman symbols");
  weights[n_weights++] = uint8_t(highbit32(left) + 1);

  h.max_bits = max_bits;
  int size = 1 << max_bits;
  h.cell.assign(size, 0);
  int rank_count[13] = {0};
  uint8_t bits_of[256];
  for (int i = 0; i < n_weights; ++i) {
    bits_of[i] = weights[i] ? uint8_t(max_bits + 1 - weights[i]) : 0;
    rank_count[bits_of[i]]++;
  }
  int rank_idx[13] = {0};
  for (int b = max_bits; b >= 1; --b)
    rank_idx[b - 1] = rank_idx[b] + rank_count[b] * (1 << (max_bits - b));
  check(rank_idx[0] == size, "corrupt frame: Huffman table");
  for (int i = 0; i < n_weights; ++i) {
    if (!bits_of[i]) continue;
    int code = rank_idx[bits_of[i]];
    int len = 1 << (max_bits - bits_of[i]);
    for (int j = code; j < code + len; ++j)
      h.cell[j] = uint16_t(i << 8 | bits_of[i]);
    rank_idx[bits_of[i]] += len;
  }
  return used;
}

// One Huffman stream being decoded: its bits and the output still to fill.
struct HufStream {
  BackwardBits bits;
  uint8_t* out;
  size_t left;
  // the fast path's one unaligned 8-byte load at pos - max_bits is in range
  bool fast(int mb) const {
    return bits.pos >= mb && size_t((bits.pos - mb) >> 3) + 8 <= bits.n_bytes;
  }
};

inline void huf_step_checked(const Huffman& h, HufStream& s) {
  uint16_t c = h.cell[s.bits.peek(h.max_bits)];
  *s.out++ = uint8_t(c >> 8);
  --s.left;
  s.bits.skip(c & 0xFF);
}

inline void huf_step_fast(const uint16_t* cell, int mb, uint64_t mask,
                          HufStream& s) {
  int64_t lo = s.bits.pos - mb;
  uint16_t c = cell[(load_le64(s.bits.p + (lo >> 3)) >> (lo & 7)) & mask];
  *s.out++ = uint8_t(c >> 8);
  --s.left;
  s.bits.pos -= c & 0xFF;
}

// Decodes what is left of a stream: the checked reader within 8 bytes of
// the stream's end and below bit max_bits, the fast path between.
void huf_finish(const Huffman& h, HufStream& s) {
  const int mb = h.max_bits;
  const uint64_t mask = (1ULL << mb) - 1;
  while (s.left && !s.fast(mb)) {
    if (s.bits.pos < mb) break;
    huf_step_checked(h, s);
  }
  while (s.left && s.bits.pos >= mb) huf_step_fast(h.cell.data(), mb, mask, s);
  while (s.left) huf_step_checked(h, s);
  check(s.bits.pos == 0, "corrupt frame: Huffman stream not consumed exactly");
}

// Four streams decode interleaved: their dependency chains (load, table,
// shift) overlap, which a single stream's cannot.
void decode_huffman(const Huffman& h, const uint8_t* const* p,
                    const size_t* n, uint8_t* const* out,
                    const size_t* n_out, int n_streams) {
  HufStream s[4] = {
      {BackwardBits(p[0], n[0]), out[0], n_out[0]},
      n_streams == 4 ? HufStream{BackwardBits(p[1], n[1]), out[1], n_out[1]}
                     : HufStream{BackwardBits(p[0], n[0]), out[0], 0},
      n_streams == 4 ? HufStream{BackwardBits(p[2], n[2]), out[2], n_out[2]}
                     : HufStream{BackwardBits(p[0], n[0]), out[0], 0},
      n_streams == 4 ? HufStream{BackwardBits(p[3], n[3]), out[3], n_out[3]}
                     : HufStream{BackwardBits(p[0], n[0]), out[0], 0}};
  if (n_streams == 4) {
    const int mb = h.max_bits;
    const uint64_t mask = (1ULL << mb) - 1;
    for (auto& st : s)
      while (st.left && !st.fast(mb) && st.bits.pos >= mb)
        huf_step_checked(h, st);
    const uint16_t* cell = h.cell.data();
    while (s[0].left && s[1].left && s[2].left && s[3].left &&
           s[0].bits.pos >= mb && s[1].bits.pos >= mb &&
           s[2].bits.pos >= mb && s[3].bits.pos >= mb) {
      huf_step_fast(cell, mb, mask, s[0]);
      huf_step_fast(cell, mb, mask, s[1]);
      huf_step_fast(cell, mb, mask, s[2]);
      huf_step_fast(cell, mb, mask, s[3]);
    }
  }
  for (int k = 0; k < n_streams; ++k) huf_finish(h, s[k]);
}

// -------------------------------------------------------------- sequences
const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1,  1,  1,  1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t LL_BASE[36] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,   9,   10,  11,   12,   13,
    14, 15, 16, 18, 20, 22, 24, 28, 32,  40,  48,  64,   128,  256,
    512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,  14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24, 25,  26,  27,  28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41, 43,  47,  51,  59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

constexpr size_t MAX_BLOCK = 128 * 1024;

struct FrameState {
  Huffman huffman;
  bool have_huffman = false;
  FseTable ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint64_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> literals;
};

struct Output {
  uint8_t* buf;
  size_t cap;
  size_t size = 0;
  size_t frame_start = 0;
  void need(size_t n) const {
    check(n <= cap - size, "output larger than the given capacity");
  }
};

// one of the three symbol tables of a sequences section; returns bytes used
size_t read_seq_table(int mode, const uint8_t* p, size_t n,
                      const int16_t* dflt, int dflt_n, int dflt_log,
                      int max_log, int max_symbol, FseTable& t, bool& have) {
  took(Path(SEQ_PREDEFINED + mode));
  if (mode == 0) {
    std::vector<int16_t> counts(dflt, dflt + dflt_n);
    build_fse(counts, dflt_log, t);
    have = true;
    return 0;
  }
  if (mode == 1) {
    check(n >= 1, "corrupt frame: RLE symbol missing");
    check(p[0] <= max_symbol, "corrupt frame: RLE symbol out of range");
    build_rle(p[0], t);
    have = true;
    return 1;
  }
  if (mode == 2) {
    std::vector<int16_t> counts;
    int log;
    size_t used = read_fse_counts(p, n, max_log, max_symbol, counts, log);
    build_fse(counts, log, t);
    have = true;
    return used;
  }
  check(have, "corrupt frame: repeat mode with no previous table");
  return 0;
}

void copy_match(Output& out, uint64_t offset, uint32_t length) {
  check(offset > 0 && offset <= out.size - out.frame_start,
        "corrupt frame: match offset beyond the decoded data");
  out.need(length);
  uint8_t* d = out.buf + out.size;
  const uint8_t* s = d - offset;
  if (offset >= length) {
    std::memcpy(d, s, length);
  } else if (offset >= 8) {
    for (uint32_t i = 0; i < length; i += 8)
      std::memcpy(d + i, s + i, length - i < 8 ? length - i : 8);
  } else {
    for (uint32_t i = 0; i < length; ++i) d[i] = s[i];
  }
  out.size += length;
}

void decode_compressed_block(const uint8_t* p, size_t n, FrameState& st,
                             Output& out) {
  const uint8_t* end = p + n;
  // -- literals section
  check(n >= 1, "corrupt frame: empty compressed block");
  int lit_type = p[0] & 3, size_format = (p[0] >> 2) & 3;
  size_t regen, comp = 0, header;
  int n_streams = 1;
  if (lit_type <= 1) {  // raw, RLE
    if (size_format == 0 || size_format == 2) {
      header = 1;
      regen = p[0] >> 3;
    } else if (size_format == 1) {
      check(n >= 2, "corrupt frame: literals header truncated");
      header = 2;
      regen = (p[0] >> 4) + (size_t(p[1]) << 4);
    } else {
      check(n >= 3, "corrupt frame: literals header truncated");
      header = 3;
      regen = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
    }
  } else {  // compressed, treeless
    if (size_format <= 1) {
      check(n >= 3, "corrupt frame: literals header truncated");
      header = 3;
      uint32_t h = p[0] | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16;
      regen = (h >> 4) & 0x3FF;
      comp = (h >> 14) & 0x3FF;
      n_streams = size_format == 0 ? 1 : 4;
    } else if (size_format == 2) {
      check(n >= 4, "corrupt frame: literals header truncated");
      header = 4;
      uint32_t h = load_le32(p);
      regen = (h >> 4) & 0x3FFF;
      comp = h >> 18;
      n_streams = 4;
    } else {
      check(n >= 5, "corrupt frame: literals header truncated");
      header = 5;
      uint64_t h = load_le32(p) | uint64_t(p[4]) << 32;
      regen = (h >> 4) & 0x3FFFF;
      comp = (h >> 22) & 0x3FFFF;
      n_streams = 4;
    }
  }
  check(regen <= MAX_BLOCK, "corrupt frame: literals larger than a block");
  p += header;
  took(Path(LIT_RAW + lit_type));
  if (lit_type >= 2) took(n_streams == 1 ? LIT_1_STREAM : LIT_4_STREAMS);
  std::vector<uint8_t>& lit = st.literals;
  lit.resize(regen);
  if (lit_type == 0) {
    check(size_t(end - p) >= regen, "corrupt frame: raw literals truncated");
    if (regen) std::memcpy(lit.data(), p, regen);
    p += regen;
  } else if (lit_type == 1) {
    check(end - p >= 1, "corrupt frame: RLE literal missing");
    if (regen) std::memset(lit.data(), p[0], regen);
    p += 1;
  } else {
    check(size_t(end - p) >= comp, "corrupt frame: literals truncated");
    const uint8_t* lp = p;
    size_t ln = comp;
    if (lit_type == 2) {
      size_t used = read_huffman(lp, ln, st.huffman);
      st.have_huffman = true;
      lp += used;
      ln -= used;
    } else {
      check(st.have_huffman, "corrupt frame: treeless literals with no "
                             "previous Huffman table");
    }
    if (n_streams == 1) {
      uint8_t* o = lit.data();
      decode_huffman(st.huffman, &lp, &ln, &o, &regen, 1);
    } else {
      check(ln >= 6, "corrupt frame: jump table truncated");
      size_t sz[4] = {lp[0] | size_t(lp[1]) << 8, lp[2] | size_t(lp[3]) << 8,
                      lp[4] | size_t(lp[5]) << 8, 0};
      check(sz[0] + sz[1] + sz[2] <= ln - 6, "corrupt frame: jump table");
      sz[3] = ln - 6 - sz[0] - sz[1] - sz[2];
      size_t seg = (regen + 3) / 4;
      check(3 * seg <= regen, "corrupt frame: too few literals for 4 "
                              "streams");
      const uint8_t* q[4] = {lp + 6, lp + 6 + sz[0], lp + 6 + sz[0] + sz[1],
                             lp + 6 + sz[0] + sz[1] + sz[2]};
      uint8_t* o[4] = {lit.data(), lit.data() + seg, lit.data() + 2 * seg,
                       lit.data() + 3 * seg};
      size_t n_out[4] = {seg, seg, seg, regen - 3 * seg};
      decode_huffman(st.huffman, q, sz, o, n_out, 4);
    }
    p += comp;
  }
  // -- sequences section
  check(end - p >= 1, "corrupt frame: sequences section missing");
  size_t n_seq = p[0];
  if (n_seq < 128) {
    p += 1;
  } else if (n_seq < 255) {
    check(end - p >= 2, "corrupt frame: sequence count truncated");
    n_seq = ((n_seq - 128) << 8) + p[1];
    p += 2;
  } else {
    check(end - p >= 3, "corrupt frame: sequence count truncated");
    n_seq = p[1] + (size_t(p[2]) << 8) + 0x7F00;
    p += 3;
  }
  size_t block_start = out.size;
  if (n_seq == 0) {
    took(SEQ_NONE);
    check(p == end, "corrupt frame: bytes after a block's literals");
    out.need(regen);
    if (regen) std::memcpy(out.buf + out.size, lit.data(), regen);
    out.size += regen;
    return;
  }
  check(end - p >= 1, "corrupt frame: compression modes missing");
  uint8_t modes = *p++;
  check((modes & 3) == 0, "corrupt frame: reserved bits set");
  p += read_seq_table(modes >> 6, p, end - p, LL_DEFAULT, 36, 6, 9, 35, st.ll,
                      st.have_ll);
  p += read_seq_table((modes >> 4) & 3, p, end - p, OF_DEFAULT, 29, 5, 8, 31,
                      st.of, st.have_of);
  p += read_seq_table((modes >> 2) & 3, p, end - p, ML_DEFAULT, 53, 6, 9, 52,
                      st.ml, st.have_ml);
  check(p < end, "corrupt frame: sequence bitstream missing");
  BackwardBits bits(p, end - p);
  uint32_t sll = uint32_t(bits.read(st.ll.log));
  uint32_t sof = uint32_t(bits.read(st.of.log));
  uint32_t sml = uint32_t(bits.read(st.ml.log));
  size_t lit_pos = 0;
  uint64_t* rep = st.rep;
  for (size_t i = 0; i < n_seq; ++i) {
    const FseEntry& ell = st.ll.cells[sll];
    const FseEntry& eof = st.of.cells[sof];
    const FseEntry& eml = st.ml.cells[sml];
    uint32_t of_code = eof.symbol, ll_code = ell.symbol, ml_code = eml.symbol;
    check(of_code <= 31, "corrupt frame: offset code too large");
    uint64_t ofv = (1ULL << of_code) + bits.read(int(of_code));
    uint32_t ml = ML_BASE[ml_code] + uint32_t(bits.read(ML_BITS[ml_code]));
    uint32_t ll = LL_BASE[ll_code] + uint32_t(bits.read(LL_BITS[ll_code]));
    uint64_t offset;
    if (ofv > 3) {
      offset = ofv - 3;
      rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = offset;
    } else {
      took(ll == 0 ? OFFSET_REPEAT_LL0 : OFFSET_REPEAT);
      int idx = int(ofv) - 1 + (ll == 0 ? 1 : 0);
      if (idx == 0) {
        offset = rep[0];
      } else {
        offset = idx == 3 ? rep[0] - 1 : rep[idx];
        if (idx > 1) rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      }
    }
    if (i + 1 < n_seq) {
      sll = ell.baseline + uint32_t(bits.read(ell.nb_bits));
      sml = eml.baseline + uint32_t(bits.read(eml.nb_bits));
      sof = eof.baseline + uint32_t(bits.read(eof.nb_bits));
    }
    check(!bits.overflowed(), "corrupt frame: sequence bitstream overrun");
    check(ll <= regen - lit_pos, "corrupt frame: literals overrun");
    out.need(ll);
    if (ll) std::memcpy(out.buf + out.size, lit.data() + lit_pos, ll);
    out.size += ll;
    lit_pos += ll;
    copy_match(out, offset, ml);
    check(out.size - block_start <= MAX_BLOCK,
          "corrupt frame: block larger than 128 KiB");
  }
  check(bits.pos == 0, "corrupt frame: sequence bitstream not consumed "
                       "exactly");
  size_t rest = regen - lit_pos;
  out.need(rest);
  if (rest) std::memcpy(out.buf + out.size, lit.data() + lit_pos, rest);
  out.size += rest;
  check(out.size - block_start <= MAX_BLOCK,
        "corrupt frame: block larger than 128 KiB");
}

// Decodes the frame at src; returns the bytes of src it took.
size_t decode_frame(const uint8_t* src, size_t n, Output& out) {
  check(n >= 4, "truncated frame: no magic number");
  uint32_t magic = load_le32(src);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable frame
    check(n >= 8, "truncated skippable frame");
    uint64_t len = load_le32(src + 4);
    check(len <= n - 8, "truncated skippable frame");
    took(FRAME_SKIPPABLE);
    return 8 + size_t(len);
  }
  check(magic == 0xFD2FB528u, "not a zstd frame: bad magic number");
  size_t pos = 4;
  check(n > pos, "truncated frame header");
  uint8_t fhd = src[pos++];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, has_checksum = (fhd >> 2) & 1,
      dict_flag = fhd & 3;
  check(((fhd >> 3) & 1) == 0, "corrupt frame: reserved header bit set");
  took(single ? FRAME_SINGLE_SEGMENT : FRAME_WINDOWED);
  if (!single) {
    check(n > pos, "truncated frame header");
    uint8_t wd = src[pos++];
    check((wd >> 3) + 10 <= 41, "corrupt frame: window too large");
  }
  static const int DICT_BYTES[4] = {0, 1, 2, 4};
  int db = DICT_BYTES[dict_flag];
  check(n - pos >= size_t(db), "truncated frame header");
  uint32_t dict_id = 0;
  for (int i = 0; i < db; ++i) dict_id |= uint32_t(src[pos + i]) << (8 * i);
  pos += db;
  if (dict_id != 0) fail("frame needs a dictionary, which is not supported");
  static const int FCS_BYTES[4] = {0, 2, 4, 8};
  int fb = fcs_flag == 0 ? (single ? 1 : 0) : FCS_BYTES[fcs_flag];
  check(n - pos >= size_t(fb), "truncated frame header");
  bool has_fcs = fb > 0;
  uint64_t fcs = 0;
  for (int i = 0; i < fb; ++i) fcs |= uint64_t(src[pos + i]) << (8 * i);
  if (fb == 2) fcs += 256;
  pos += fb;
  if (!has_fcs) took(FRAME_NO_CONTENT_SIZE);
  if (has_fcs) check(fcs <= out.cap - out.size,
                     "output larger than the given capacity");

  FrameState st;
  out.frame_start = out.size;
  for (;;) {
    check(n - pos >= 3, "truncated frame: block header");
    uint32_t bh = src[pos] | uint32_t(src[pos + 1]) << 8 |
                  uint32_t(src[pos + 2]) << 16;
    pos += 3;
    int last = bh & 1, type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    check(type != 3, "corrupt frame: reserved block type");
    check(size <= MAX_BLOCK, "corrupt frame: block larger than 128 KiB");
    took(Path(BLOCK_RAW + type));
    if (type == 1) {  // RLE
      check(n - pos >= 1, "truncated frame: RLE block");
      out.need(size);
      std::memset(out.buf + out.size, src[pos], size);
      out.size += size;
      pos += 1;
    } else {
      check(n - pos >= size, "truncated frame: block");
      if (type == 0) {
        out.need(size);
        if (size) std::memcpy(out.buf + out.size, src + pos, size);
        out.size += size;
      } else {
        decode_compressed_block(src + pos, size, st, out);
      }
      pos += size;
    }
    if (last) break;
  }
  size_t produced = out.size - out.frame_start;
  if (has_fcs) check(produced == fcs, "corrupt frame: content size differs "
                                      "from the header's");
  if (has_checksum) {
    check(n - pos >= 4, "truncated frame: checksum");
    uint32_t want = load_le32(src + pos);
    uint32_t got = uint32_t(xxh64(out.buf + out.frame_start, produced));
    check(want == got, "corrupt frame: content checksum mismatch");
    took(FRAME_CHECKSUM);
    pos += 4;
  }
  return pos;
}

void copy_error(const char* what, char* err, uint64_t err_cap) {
  if (err && err_cap) std::snprintf(err, err_cap, "%s", what);
}

}  // namespace

extern "C" {

// Decodes every frame of src[0:n] (concatenated frames, skippable ones
// skipped) into dst[0:cap]. Returns the bytes written, or -1 with a message
// in err (truncated or corrupt input, a dictionary, or an output larger
// than cap).
int64_t dmv3d_zstd_decompress(const uint8_t* src, uint64_t n, uint8_t* dst,
                              uint64_t cap, char* err, uint64_t err_cap) {
  try {
    check(n > 0, "truncated frame: empty input");
    Output out{dst, size_t(cap)};
    size_t pos = 0;
    while (pos < n) pos += decode_frame(src + pos, size_t(n - pos), out);
    return int64_t(out.size);
  } catch (const std::exception& e) {
    copy_error(e.what(), err, err_cap);
  } catch (...) {
    copy_error("zstd decoder failed", err, err_cap);
  }
  return -1;
}

uint64_t dmv3d_xxh64(const uint8_t* p, uint64_t n) { return xxh64(p, n); }

// Copies the path counters (enum Path order) into out[0:n] and returns how
// many there are; reset != 0 zeroes them afterwards.
int dmv3d_zstd_path_counts(uint64_t* out, int n, int reset) {
  for (int i = 0; i < N_PATHS; ++i) {
    uint64_t v = reset ? path_count[i].exchange(0) : path_count[i].load();
    if (i < n) out[i] = v;
  }
  return N_PATHS;
}

}  // extern "C"
