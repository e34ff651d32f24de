// Self-contained PNG decoder for the port's native data path
// (csrc/vsr_dataio.cc). It takes the place of libpng there and needs only
// the C++ standard library: no png.h, no zlib.h.
//
// decode_rgb8 gives the bytes that the JAX package's libpng reader
// (native/vsr_dataio.cc:decode_png_rgb) gives, which asks libpng for
//   png_set_strip_16, png_set_palette_to_rgb, png_set_expand_gray_1_2_4_to_8,
//   png_set_tRNS_to_alpha, png_set_gray_to_rgb and png_set_strip_alpha,
// and no gamma. So: 16-bit samples keep their high byte; a palette index
// becomes its PLTE colour (indices past the palette give black, as libpng's
// zero-filled 256-entry palette does); gray at 1, 2 or 4 bits is scaled to
// 8 bits (x255, x85, x17) and repeated into R, G and B; alpha is dropped.
// tRNS would become alpha, which is dropped, so it never reaches the RGB
// bytes and is skipped like every other ancillary chunk. (The JAX reader
// strips alpha only from colour types that carry it, so for a gray, RGB or
// palette image with tRNS libpng hands it RGBA rows, which it reads as RGB;
// here the alpha is dropped, as PIL drops it.)
//
// What it checks, as libpng does by default on that path: the signature;
// IHDR first, with a legal depth and colour type; the CRC of IHDR, PLTE
// and every IDAT (ancillary chunks are skipped unchecked, as libpng only
// warns on theirs); no unknown critical chunk; PLTE before the IDATs of a
// palette image; the zlib stream of the IDAT run (RFC 1950: header,
// stored, fixed and dynamic Huffman blocks of RFC 1951, Adler-32) holding
// at least the image's bytes; filter types 0-4. Reading stops at the first
// chunk after the IDAT run, or at the file's end there (libpng's row reader
// never reads past it, so IEND is not needed and not checked). Adam7-interlaced images are refused: the JAX reader
// does not turn on libpng's interlace handling, so it has no defined
// result to match. Every refusal returns false.
//
// Inflate is table-driven: a 10-bit first-level lookup resolves every
// code of up to 10 bits in one step; longer codes (11-15 bits) take a
// canonical search over the lengths above 10.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__
#error "Inflater::refill loads the input as little-endian words"
#endif

namespace vsr_png {

// ------------------------------------------------------------- checksums

// CRC-32 (ISO 3309, the PNG chunk CRC), slicing by 8.
inline const uint32_t (*crc_tables())[256] {
  static const struct Tables {
    uint32_t t[8][256];
    Tables() {
      for (uint32_t n = 0; n < 256; ++n) {
        uint32_t c = n;
        for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        t[0][n] = c;
      }
      for (int s = 1; s < 8; ++s)
        for (int n = 0; n < 256; ++n)
          t[s][n] = (t[s - 1][n] >> 8) ^ t[0][t[s - 1][n] & 0xFF];
    }
  } tables;
  return tables.t;
}

inline uint32_t crc32(const uint8_t* p, size_t n) {
  const uint32_t(*t)[256] = crc_tables();
  uint32_t c = 0xFFFFFFFFu;
  for (; n >= 8; n -= 8, p += 8) {
    const uint32_t lo = c ^ (uint32_t(p[0]) | uint32_t(p[1]) << 8 |
                             uint32_t(p[2]) << 16 | uint32_t(p[3]) << 24);
    c = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF] ^
        t[4][lo >> 24] ^ t[3][p[4]] ^ t[2][p[5]] ^ t[1][p[6]] ^ t[0][p[7]];
  }
  for (; n; --n) c = t[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

inline uint32_t adler32(const uint8_t* p, size_t n) {
  uint32_t a = 1, b = 0;
  while (n) {
    size_t k = n < 5552 ? n : 5552;  // the most sums before b can overflow
    n -= k;
    for (; k; --k) {
      a += *p++;
      b += a;
    }
    a %= 65521u;
    b %= 65521u;
  }
  return (b << 16) | a;
}

inline uint32_t be32(const uint8_t* p) {
  return uint32_t(p[0]) << 24 | uint32_t(p[1]) << 16 | uint32_t(p[2]) << 8 |
         uint32_t(p[3]);
}

// ------------------------------------------------------------------ inflate

constexpr int kFastBits = 10;

// Canonical Huffman code over up to 288 symbols. fast[] maps the next
// kFastBits input bits (LSB first) to (length << 9 | symbol) for every code
// of at most kFastBits bits, 0 where the code is longer or absent.
struct Huffman {
  uint16_t fast[1 << kFastBits];
  uint32_t max_code[17];     // one past the last code of each length, << (16 - len)
  uint16_t first_code[16];
  uint16_t first_slot[16];
  uint16_t symbol[288];      // by slot: canonical order
  bool complete;             // every code of up to 15 bits is assigned

  // zlib's rules: an over-subscribed set is refused; an incomplete set only
  // where its longest code is 1 bit (one code), or where it is empty and
  // `allow_empty` (a distance code of a block of literals only).
  bool build(const uint8_t* lens, int n, bool allow_empty) {
    int count[16] = {0};
    for (int i = 0; i < n; ++i) ++count[lens[i]];
    count[0] = 0;
    int left = 1, longest = 0;
    for (int len = 1; len < 16; ++len) {
      left = (left << 1) - count[len];
      if (left < 0) return false;
      if (count[len]) longest = len;
    }
    complete = left == 0;
    if (longest == 0) {
      if (!allow_empty) return false;
    } else if (!complete && longest != 1) {
      return false;
    }
    std::memset(fast, 0, sizeof fast);
    int code = 0, slot = 0;
    uint16_t next[16];
    for (int len = 1; len < 16; ++len) {
      first_code[len] = uint16_t(code);
      first_slot[len] = uint16_t(slot);
      next[len] = uint16_t(code);
      code += count[len];
      slot += count[len];
      max_code[len] = uint32_t(code) << (16 - len);
      code <<= 1;
    }
    max_code[16] = 0x10000;
    for (int i = 0; i < n; ++i) {
      const int len = lens[i];
      if (!len) continue;
      const int c = next[len]++;
      symbol[first_slot[len] + c - first_code[len]] = uint16_t(i);
      if (len <= kFastBits) {
        int r = 0;  // the code reversed: the stream sends codes MSB first
        for (int b = 0; b < len; ++b) r |= ((c >> b) & 1) << (len - 1 - b);
        for (; r < (1 << kFastBits); r += 1 << len)
          fast[r] = uint16_t(len << 9 | i);
      }
    }
    return true;
  }
};

class Inflater {
  // Output bytes kept free past the end: a whole match (258 bytes) and the
  // overshoot of its 8-byte copies, so a symbol needs no bounds check.
  static constexpr size_t kSlack = 258 + 8;

 public:
  Inflater(const uint8_t* in, size_t n) : start_(in), p_(in), end_(in + n) {}

  // The zlib stream into out (sized to `expect` first, grown if the
  // stream holds more). False on a stream that ends short of `expect`
  // bytes, on input that runs out, and on a fault met before the stream
  // has given `expect` bytes and moved on to the next. libpng inflates one
  // row a call; after the last row it inflates the rest of the stream only
  // to check it, and a fault found there is a warning (png_read_IDAT_data
  // with no output buffer), so it is forgiven here too.
  bool zlib(std::vector<uint8_t>* out, size_t expect) {
    if (end_ - p_ < 2) return false;
    const uint8_t cmf = p_[0], flg = p_[1];
    if ((cmf & 15) != 8 || (cmf >> 4) > 7 || (cmf * 256u + flg) % 31 != 0 ||
        (flg & 0x20))  // deflate, window <= 32K, header check, no dictionary
      return false;
    p_ += 2;
    out_ = out;
    out_->resize(expect + kSlack);
    pos_ = 0;
    expect_ = expect;
    bool last = false;
    while (!last) {
      refill();
      last = bits(1);
      const uint32_t type = bits(2);
      bool ok;
      if (type == 0) {
        ok = stored();
      } else if (type == 1) {
        ok = codes(fixed_lit(), fixed_dist());
      } else if (type == 2) {
        ok = dynamic();
      } else {
        ok = fault();
      }
      if (!ok && !forgiven_) return false;
      if (past_end()) return false;
      if (forgiven_) break;
    }
    if (pos_ < expect) return false;
    if (!forgiven_) {  // Adler-32 of the output, big-endian, byte-aligned
      const size_t at = byte_pos();
      if (at + 4 > size_t(end_ - start_)) return false;
      if (be32(start_ + at) != adler32(out_->data(), pos_) && !soft_) return false;
    }
    out_->resize(pos_);
    return true;
  }

 private:
  const uint8_t* start_;
  const uint8_t* p_;
  const uint8_t* end_;
  uint64_t buf_ = 0;
  int cnt_ = 0;        // bits in buf_
  size_t pad_ = 0;     // zero bytes fed past the end of the input
  std::vector<uint8_t>* out_ = nullptr;
  size_t pos_ = 0;
  size_t expect_ = 0;
  bool soft_ = false;      // where libpng would have stopped: faults forgiven
  bool forgiven_ = false;  // a fault was met and forgiven

  // A fault in the stream's data: forgiven after the image's bytes, as long
  // as the input has not run out (libpng's "Not enough image data").
  bool fault() {
    forgiven_ = soft_ && !past_end();
    return false;
  }

  // At least 56 bits in buf_ (zeros past the end, counted in pad_).
  void refill() {
    if (end_ - p_ >= 8) {
      uint64_t w;
      std::memcpy(&w, p_, 8);  // little-endian host
      buf_ |= w << cnt_;
      p_ += (63 - cnt_) >> 3;
      cnt_ |= 56;
      return;
    }
    while (cnt_ <= 56) {
      if (p_ < end_) {
        buf_ |= uint64_t(*p_++) << cnt_;
      } else {
        ++pad_;
      }
      cnt_ += 8;
    }
  }
  // Whether a bit past the end of the input has been consumed.
  bool past_end() const { return pad_ * 8 > size_t(cnt_); }
  uint32_t bits(int n) {
    const uint32_t v = uint32_t(buf_ & ((uint64_t(1) << n) - 1));
    buf_ >>= n;
    cnt_ -= n;
    return v;
  }
  // The input byte after the last consumed bit, rounded up; empties buf_.
  size_t byte_pos() {
    const size_t fed = size_t(p_ - start_) + pad_;
    const size_t at = fed - size_t(cnt_ / 8);
    buf_ = 0;
    cnt_ = 0;
    pad_ = 0;
    p_ = start_ + (at < size_t(end_ - start_) ? at : size_t(end_ - start_));
    return at;
  }
  int decode(const Huffman& h) {
    const uint32_t e = h.fast[buf_ & ((1u << kFastBits) - 1)];
    if (e) {
      const int len = int(e >> 9);
      buf_ >>= len;
      cnt_ -= len;
      return int(e & 511);
    }
    uint32_t k = uint32_t(buf_ & 0xFFFF), r = 0;  // 16 bits, MSB first
    for (int b = 0; b < 16; ++b) r |= ((k >> b) & 1) << (15 - b);
    int len = kFastBits + 1;
    while (len < 16 && r >= h.max_code[len]) ++len;
    if (len == 16) return -1;  // no such code (an incomplete set)
    buf_ >>= len;
    cnt_ -= len;
    return h.symbol[h.first_slot[len] + (r >> (16 - len)) - h.first_code[len]];
  }
  // Room for n more bytes and the slack after them.
  void reserve(size_t n) {
    if (out_->size() - pos_ < n + kSlack)
      out_->resize(pos_ + n + kSlack > 2 * out_->size() ? pos_ + n + kSlack
                                                        : 2 * out_->size());
  }

  bool stored() {
    size_t at = byte_pos();
    const size_t n = size_t(end_ - start_);
    if (at + 4 > n) return false;
    const uint32_t len = uint32_t(start_[at]) | uint32_t(start_[at + 1]) << 8;
    const uint32_t nlen = uint32_t(start_[at + 2]) | uint32_t(start_[at + 3]) << 8;
    if ((len ^ 0xFFFF) != nlen) return fault();
    if (len && pos_ >= expect_) soft_ = true;  // libpng's last row stops here
    if (at + 4 + len > n) return false;
    reserve(len);
    std::memcpy(out_->data() + pos_, start_ + at + 4, len);
    pos_ += len;
    p_ = start_ + at + 4 + len;
    return true;
  }

  static const Huffman& fixed_lit() {
    static const struct Fixed : Huffman {
      Fixed() {
        uint8_t lens[288];
        for (int i = 0; i < 288; ++i)
          lens[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
        build(lens, 288, false);
      }
    } h;
    return h;
  }
  static const Huffman& fixed_dist() {
    static const struct Fixed : Huffman {
      Fixed() {
        uint8_t lens[32];
        std::memset(lens, 5, sizeof lens);
        build(lens, 32, false);
      }
    } h;
    return h;
  }

  bool dynamic() {
    static const uint8_t order[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                      11, 4,  12, 3, 13, 2, 14, 1, 15};
    refill();
    const int nlen = int(bits(5)) + 257, ndist = int(bits(5)) + 1,
              ncode = int(bits(4)) + 4;
    if (nlen > 286 || ndist > 30) return fault();
    uint8_t cl[19] = {0};
    for (int i = 0; i < ncode; ++i) {
      refill();
      cl[order[i]] = uint8_t(bits(3));
    }
    Huffman clh;  // zlib takes no incomplete code-length code
    if (!clh.build(cl, 19, false) || !clh.complete) return fault();
    uint8_t lens[286 + 30] = {0};
    for (int i = 0; i < nlen + ndist;) {
      refill();
      if (past_end()) return false;
      const int sym = decode(clh);
      if (sym < 0) return fault();
      if (sym < 16) {
        lens[i++] = uint8_t(sym);
        continue;
      }
      int rep;
      uint8_t v = 0;
      if (sym == 16) {
        if (i == 0) return fault();
        v = lens[i - 1];
        rep = 3 + int(bits(2));
      } else if (sym == 17) {
        rep = 3 + int(bits(3));
      } else {
        rep = 11 + int(bits(7));
      }
      if (i + rep > nlen + ndist) return fault();
      while (rep--) lens[i++] = v;
    }
    if (lens[256] == 0) return fault();  // no end-of-block code
    Huffman lit, dist;
    if (!lit.build(lens, nlen, false) || !dist.build(lens + nlen, ndist, true))
      return fault();
    return codes(lit, dist);
  }

  bool codes(const Huffman& lit, const Huffman& dist) {
    static const uint16_t len_base[29] = {
        3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
        31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
    static const uint8_t len_extra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                                          1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                                          4, 4, 4, 4, 5, 5, 5, 5, 0};
    static const uint16_t dist_base[30] = {
        1,    2,    3,    4,    5,    7,     9,     13,    17,  25,
        33,   49,   65,   97,   129,  193,   257,   385,   513, 769,
        1025, 1537, 2049, 3073, 4097, 6145,  8193,  12289, 16385, 24577};
    static const uint8_t dist_extra[30] = {0, 0, 0, 0, 1, 1, 2,  2,  3,  3,
                                           4, 4, 5, 5, 6, 6, 7,  7,  8,  8,
                                           9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
    uint8_t* out = out_->data();
    size_t pos = pos_;
    const size_t expect = expect_;
    auto bad = [&] {
      pos_ = pos;
      return fault();
    };
    for (;;) {
      if (out_->size() - pos < kSlack) {
        pos_ = pos;
        reserve(0);
        out = out_->data();
      }
      refill();  // >= 56 bits: a length and a distance take at most 48
      if (pad_ >= 8) return false;  // every buffered bit lies past the end
      const int sym = decode(lit);
      if (sym < 256) {
        if (sym < 0) return bad();
        if (pos >= expect) soft_ = true;  // libpng's last row stops here
        out[pos++] = uint8_t(sym);
        continue;
      }
      if (sym == 256) {
        pos_ = pos;
        return true;
      }
      const int li = sym - 257;
      if (li >= 29) return bad();
      const size_t len = len_base[li] + bits(len_extra[li]);
      const int di = decode(dist);
      if (di < 0 || di >= 30) return bad();
      const size_t d = dist_base[di] + bits(dist_extra[di]);
      if (pos >= expect) soft_ = true;  // ... or here, before the distance check
      if (d > pos) return bad();  // before the start of the output
      uint8_t* o = out + pos;
      const uint8_t* src = o - d;
      pos += len;
      if (pos > expect) soft_ = true;  // ... or inside this match
      if (d >= 8) {  // 8-byte words, each read before it is overwritten
        for (uint8_t* end = o + len; o < end; o += 8, src += 8) std::memcpy(o, src, 8);
      } else if (d == 1) {
        std::memset(o, *src, len);
      } else {
        for (size_t i = 0; i < len; ++i) o[i] = src[i];
      }
    }
  }
};

// -------------------------------------------------------------------- PNG

inline bool read_file(const char* path, std::vector<uint8_t>* bytes) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  bytes->clear();
  uint8_t chunk[1 << 16];
  size_t got;
  while ((got = std::fread(chunk, 1, sizeof chunk, fp)) > 0)
    bytes->insert(bytes->end(), chunk, chunk + got);
  const bool ok = !std::ferror(fp);
  std::fclose(fp);
  return ok;
}

// The Paeth predictor without branches: the three pixels' independent
// bytes then run side by side.
inline int paeth(int a, int b, int c) {
  const int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
  const int ab = pa <= pb ? a : b;
  return (pa <= pb ? pa : pb) <= pc ? ab : c;
}

// One row's Average and Paeth filters reversed, BPP bytes a pixel.
template <int BPP>
void unfilter_row(int type, uint8_t* cur, const uint8_t* prev, size_t n) {
  if (type == 3) {
    for (size_t i = 0; i < BPP; ++i) cur[i] += prev[i] >> 1;
    for (size_t i = BPP; i < n; i += BPP)
      for (int k = 0; k < BPP; ++k)
        cur[i + k] += uint8_t((cur[i + k - BPP] + prev[i + k]) >> 1);
  } else {
    for (size_t i = 0; i < BPP; ++i) cur[i] += prev[i];
    for (size_t i = BPP; i < n; i += BPP)
      for (int k = 0; k < BPP; ++k)
        cur[i + k] += uint8_t(paeth(cur[i + k - BPP], prev[i + k], prev[i + k - BPP]));
  }
}

// Reverses the scanline filters in place: `rows` rows of 1 filter byte and
// `rowbytes` bytes (a multiple of bpp); bpp is the bytes a whole pixel
// takes, at least 1: 1, 2, 3, 4, 6 or 8.
inline bool unfilter(uint8_t* data, size_t rows, size_t rowbytes, size_t bpp) {
  const std::vector<uint8_t> zeros(rowbytes, 0);
  const uint8_t* prev = zeros.data();
  for (size_t y = 0; y < rows; ++y) {
    uint8_t* f = data + y * (rowbytes + 1);
    uint8_t* cur = f + 1;
    const int type = *f;
    if (type == 1) {
      for (size_t i = bpp; i < rowbytes; ++i) cur[i] += cur[i - bpp];
    } else if (type == 2) {
      for (size_t i = 0; i < rowbytes; ++i) cur[i] += prev[i];
    } else if (type == 3 || type == 4) {
      switch (bpp) {
        case 1: unfilter_row<1>(type, cur, prev, rowbytes); break;
        case 2: unfilter_row<2>(type, cur, prev, rowbytes); break;
        case 3: unfilter_row<3>(type, cur, prev, rowbytes); break;
        case 4: unfilter_row<4>(type, cur, prev, rowbytes); break;
        case 6: unfilter_row<6>(type, cur, prev, rowbytes); break;
        default: unfilter_row<8>(type, cur, prev, rowbytes); break;
      }
    } else if (type != 0) {
      return false;
    }
    prev = cur;
  }
  return true;
}

// The PNG in data[0, n) as 8-bit RGB, (h, w, 3) row-major in *rgb; false
// on any refusal listed at the top of this file.
inline bool decode_rgb8(const uint8_t* data, size_t n, std::vector<uint8_t>* rgb,
                        int* h, int* w) {
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (n < 8 || std::memcmp(data, sig, 8) != 0) return false;
  uint32_t width = 0, height = 0;
  int depth = 0, color = -1;
  bool have_plte = false, have_idat = false;
  uint8_t pal[256][3] = {};
  std::vector<uint8_t> z;
  for (size_t at = 8;;) {
    if (have_idat && (n - at < 8 || std::memcmp(data + at + 4, "IDAT", 4) != 0))
      break;  // past the IDAT run: libpng's row reader reads no further
    if (n - at < 12) return false;
    const uint32_t len = be32(data + at);
    const uint8_t* type = data + at + 4;
    if (len > 0x7FFFFFFFu || n - at - 12 < len) return false;
    for (int i = 0; i < 4; ++i) {
      const uint8_t c = uint8_t(type[i] | 0x20);
      if (c < 'a' || c > 'z') return false;
    }
    const uint8_t* body = type + 4;
    const bool critical = !(type[0] & 0x20);
    const bool idat = std::memcmp(type, "IDAT", 4) == 0;
    if (critical && std::memcmp(type, "IEND", 4) != 0 &&
        crc32(type, len + 4) != be32(body + len))
      return false;
    if (color < 0 && std::memcmp(type, "IHDR", 4) != 0) return false;
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (color >= 0 || len != 13) return false;
      width = be32(body);
      height = be32(body + 4);
      depth = body[8];
      color = body[9];
      const bool depth_ok =
          (color == 0 && (depth == 1 || depth == 2 || depth == 4 ||
                          depth == 8 || depth == 16)) ||
          (color == 3 && (depth == 1 || depth == 2 || depth == 4 || depth == 8)) ||
          ((color == 2 || color == 4 || color == 6) && (depth == 8 || depth == 16));
      // libpng's default user limits: 1e6 pixels a side
      if (!depth_ok || width == 0 || height == 0 || width > 1000000u ||
          height > 1000000u || body[10] != 0 || body[11] != 0 || body[12] != 0)
        return false;  // body[12] == 1 is Adam7: refused, see the top
    } else if (std::memcmp(type, "PLTE", 4) == 0) {
      if (have_plte) return false;
      have_plte = true;
      if (color == 3) {
        if (len % 3 != 0 || len > 768) return false;
        for (uint32_t i = 0; i < len / 3; ++i)
          std::memcpy(pal[i], body + 3 * i, 3);
      }
    } else if (idat) {
      if (color == 3 && !have_plte) return false;
      z.insert(z.end(), body, body + len);
      have_idat = true;
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      return false;  // before any IDAT
    } else if (critical) {
      return false;  // an unknown critical chunk
    }
    at += 12 + size_t(len);
  }

  const int channels = color == 2 ? 3 : color == 4 ? 2 : color == 6 ? 4 : 1;
  const size_t rowbytes = (size_t(width) * channels * depth + 7) / 8;
  const size_t bpp = size_t(channels) * depth >= 8 ? size_t(channels) * depth / 8 : 1;
  const size_t expect = size_t(height) * (rowbytes + 1);
  // deflate gives at most 1032 bytes a byte (a 258-byte match in 2 bits):
  // a shorter stream cannot hold the image, and is refused before any
  // allocation of the image's size
  if (expect / 1032 > z.size() + 2) return false;
  std::vector<uint8_t> raw;
  Inflater inf(z.data(), z.size());
  if (!inf.zlib(&raw, expect) ||
      !unfilter(raw.data(), height, rowbytes, bpp))
    return false;

  rgb->resize(size_t(height) * width * 3);
  const int mask = (1 << (depth < 8 ? depth : 8)) - 1;
  const int scale = depth < 8 ? 255 / mask : 1;
  for (size_t y = 0; y < height; ++y) {
    const uint8_t* s = raw.data() + y * (rowbytes + 1) + 1;
    uint8_t* d = rgb->data() + y * width * 3;
    if (color == 2 && depth == 8) {
      std::memcpy(d, s, size_t(width) * 3);
      continue;
    }
    for (size_t x = 0; x < width; ++x, d += 3) {
      if (color == 2 || color == 6) {  // RGB(A): the high byte of each
        const size_t step = size_t(channels) * (depth / 8);
        const size_t b = depth / 8;
        d[0] = s[x * step];
        d[1] = s[x * step + b];
        d[2] = s[x * step + 2 * b];
        continue;
      }
      int v;  // gray or palette index
      if (depth >= 8) {
        v = s[x * size_t(channels) * (depth / 8)];
      } else {
        const size_t bit = x * depth;
        v = (s[bit >> 3] >> (8 - depth - (bit & 7))) & mask;
      }
      if (color == 3) {
        std::memcpy(d, pal[v], 3);
      } else {
        d[0] = d[1] = d[2] = uint8_t(depth < 8 ? v * scale : v);
      }
    }
  }
  *h = int(height);
  *w = int(width);
  return true;
}

}  // namespace vsr_png
