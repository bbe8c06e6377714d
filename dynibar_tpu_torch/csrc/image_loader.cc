// Host image decoder of the PyTorch/CUDA port: PNG and JPEG with no
// third-party library, and a thread pool that decodes batches of files
// into float32 NHWC.
//
// The machine with the card has no image library (no libpng, libjpeg or
// zlib headers are assumed), so this file carries its own decoders, a C++
// rendering of data/png.py and data/jpeg.py that returns the same bytes:
//   * PNG: non-interlaced 8-bit gray, gray+alpha, RGB and RGBA, the five
//     row filters, CRC-checked chunks, and the inflate (RFC 1951) of the
//     zlib stream (RFC 1950, Adler-32 checked);
//   * JPEG: baseline and extended-Huffman sequential (SOF0, SOF1) and
//     progressive (SOF2) files with 8-bit samples, grayscale, YCbCr or
//     RGB-coded, 4:4:4, 4:2:2 or 4:2:0, restart markers; libjpeg's islow
//     inverse DCT, fancy upsampling and fixed-point YCbCr tables.
// Both refuse what the numpy decoders refuse, with their messages.
//
// The batch entry is the counterpart of runtime/image_loader.cc's
// dyn_loader_decode_batch: a persistent pool decodes each file, broadcasts
// gray, drops alpha, and writes v * (1/255) as float32 into the caller's
// [N, out_h, out_w, 3] buffer, resized with the same bilinear arithmetic
// (half-pixel centres, clamped corners).  Built with -ffp-contract=off so
// that the resize rounds as that library does on every host.
//
// C API (ctypes; the GIL is released for every call):
//   int   dyn_decode_file(const char* path, unsigned char** data,
//                         int* shape, char* err, int err_len);
//         -> malloc'd uint8 HWC (free with dyn_free), shape = {h, w, c}
//   int   dyn_read_shape(const char* path, int* shape, char* err,
//                        int err_len);   -> {h, w, c} from the header
//   void  dyn_free(void* p);
//   void* dyn_loader_create(int num_threads);
//   void  dyn_loader_destroy(void* h);
//   int   dyn_loader_decode_batch(void* h, const char** paths, int n,
//                                 float* out, int out_h, int out_w,
//                                 char* err, int err_len);
//         -> 0, or the 1-based index of the first file that failed.
// The single-file entries return 0, 1 with a message for a file they
// refuse, 2 for a zlib stream they cannot inflate (Python's zlib.error),
// or -errno when the file cannot be read.

#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

namespace {

using Bytes = std::vector<uint8_t>;

struct Image {
  int h = 0, w = 0, c = 0;
  Bytes data;  // HWC, 8-bit
};

// A file the decoder refuses (the numpy decoders' ValueError).
struct DecodeError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// A file that cannot be read (the numpy decoders' OSError from open()).
struct FileError : std::runtime_error {
  explicit FileError(int e) : std::runtime_error(strerror(e)), err(e) {}
  int err;
};

Bytes ReadFile(const char* path, long limit = -1) {
  FILE* fp = fopen(path, "rb");
  if (!fp) throw FileError(errno);
  Bytes out;
  uint8_t buf[1 << 16];
  for (;;) {
    size_t want = sizeof(buf);
    if (limit >= 0) {
      long left = limit - static_cast<long>(out.size());
      if (left <= 0) break;
      if (static_cast<size_t>(left) < want) want = static_cast<size_t>(left);
    }
    size_t got = fread(buf, 1, want, fp);
    out.insert(out.end(), buf, buf + got);
    if (got < want) {
      int e = ferror(fp) ? errno : 0;
      fclose(fp);
      if (e) throw FileError(e);
      return out;
    }
  }
  fclose(fp);
  return out;
}

std::string IntList(const std::vector<int>& v) {  // Python's list repr
  std::string s = "[";
  for (size_t i = 0; i < v.size(); ++i) {
    if (i) s += ", ";
    s += std::to_string(v[i]);
  }
  return s + "]";
}

std::string BytesRepr(const uint8_t* p, size_t n) {  // Python's bytes repr
  bool squote = false, dquote = false;
  for (size_t i = 0; i < n; ++i) {
    squote |= p[i] == '\'';
    dquote |= p[i] == '"';
  }
  char quote = squote && !dquote ? '"' : '\'';
  std::string s = "b";
  s += quote;
  for (size_t i = 0; i < n; ++i) {
    uint8_t ch = p[i];
    char tmp[8];
    if (ch == quote || ch == '\\') {
      s += '\\';
      s += static_cast<char>(ch);
    } else if (ch == '\t') {
      s += "\\t";
    } else if (ch == '\n') {
      s += "\\n";
    } else if (ch == '\r') {
      s += "\\r";
    } else if (ch < 32 || ch >= 127) {
      snprintf(tmp, sizeof(tmp), "\\x%02x", ch);
      s += tmp;
    } else {
      s += static_cast<char>(ch);
    }
  }
  return s + quote;
}

// ------------------------------------------------------------------ inflate

struct ZError : DecodeError {
  ZError(int code, const char* what)
      : DecodeError("Error " + std::to_string(code) +
                    " while decompressing data: " + what) {}
};

constexpr int kFastBits = 10;

struct Huffman {
  uint16_t count[16] = {0};    // codes per length
  uint16_t symbol[320] = {0};  // symbols in canonical order
  uint16_t fast[1 << kFastBits] = {0};  // (symbol << 4) | length, 0: slow

  // Lengths of n symbols; throws on an over-subscribed set.
  void Build(const uint8_t* lengths, int n) {
    memset(count, 0, sizeof(count));
    for (int s = 0; s < n; ++s) count[lengths[s]]++;
    count[0] = 0;
    int left = 1;
    for (int len = 1; len < 16; ++len) {
      left = (left << 1) - count[len];
      if (left < 0) throw ZError(-3, "invalid code lengths set");
    }
    uint16_t offs[16] = {0};
    for (int len = 1; len < 15; ++len) offs[len + 1] = offs[len] + count[len];
    uint16_t next[16];
    memcpy(next, offs, sizeof(next));
    for (int s = 0; s < n; ++s)
      if (lengths[s]) symbol[next[lengths[s]]++] = static_cast<uint16_t>(s);
    memset(fast, 0, sizeof(fast));
    int code = 0, k = 0;
    for (int len = 1; len <= kFastBits; ++len) {
      for (int i = 0; i < count[len]; ++i, ++code, ++k) {
        int rev = 0;  // codes are sent from their most significant bit
        for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
        for (int j = rev; j < (1 << kFastBits); j += 1 << len)
          fast[j] = static_cast<uint16_t>((symbol[k] << 4) | len);
      }
      code <<= 1;
    }
  }
};

class Inflater {
 public:
  Inflater(const uint8_t* p, size_t n) : p_(p), n_(n) {}

  // The zlib stream's data; `expect` bytes are allotted ahead.
  Bytes Run(size_t expect) {
    out_.resize(expect + 258);
    if (n_ < 2) throw ZError(-5, "incomplete or truncated stream");
    int cmf = p_[0], flg = p_[1];
    if ((cmf * 256 + flg) % 31 != 0)
      throw ZError(-3, "incorrect header check");
    if ((cmf & 15) != 8) throw ZError(-3, "unknown compression method");
    if ((cmf >> 4) > 7) throw ZError(-3, "invalid window size");
    if (flg & 32) throw ZError(2, "need dictionary");
    pos_ = 2;
    int last;
    do {
      last = Bits(1);
      int type = Bits(2);
      if (type == 0) {
        Stored();
      } else if (type == 1) {
        Fixed();
      } else if (type == 2) {
        Dynamic();
      } else {
        throw ZError(-3, "invalid block type");
      }
    } while (!last);
    // the Adler-32 of the data, from the next byte boundary
    Drop(cnt_ & 7);
    uint32_t want = 0;
    for (int i = 0; i < 4; ++i)
      want = (want << 8) | static_cast<uint32_t>(Bits(8));
    Overrun();
    out_.resize(o_);
    uint32_t a = 1, b = 0;
    size_t i = 0;
    while (i < o_) {
      size_t stop = i + 5552 < o_ ? i + 5552 : o_;
      for (; i < stop; ++i) {
        a += out_[i];
        b += a;
      }
      a %= 65521;
      b %= 65521;
    }
    if (((b << 16) | a) != want) throw ZError(-3, "incorrect data check");
    return std::move(out_);
  }

 private:
  // At least k (<= 56) bits in the buffer.  Past the end of the data it
  // shifts in zero bytes, counted, which Overrun() turns into an error
  // once they are consumed.  The bits above cnt_ may hold the bytes from
  // pos_ on (a whole word is loaded at once), never anything else.
  void Need(int k) {
    if (cnt_ >= k) return;
#if __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
    if (pos_ + 8 <= n_) {
      uint64_t v;
      memcpy(&v, p_ + pos_, 8);
      bitbuf_ |= v << cnt_;
      int take = (63 - cnt_) >> 3;
      pos_ += take;
      cnt_ += take * 8;
      return;
    }
#endif
    while (cnt_ < k) {
      uint64_t byte = 0;
      if (pos_ < n_) {
        byte = p_[pos_];
      } else if (++phantom_ > 8) {
        throw ZError(-5, "incomplete or truncated stream");
      }
      ++pos_;
      bitbuf_ |= byte << cnt_;
      cnt_ += 8;
    }
  }
  void Drop(int k) {
    bitbuf_ >>= k;
    cnt_ -= k;
  }
  int Bits(int k) {
    if (k == 0) return 0;
    Need(k);
    int v = static_cast<int>(bitbuf_ & ((uint64_t(1) << k) - 1));
    Drop(k);
    return v;
  }
  // throws if the bits consumed run past the end of the data
  void Overrun() const {
    if (phantom_ * 8 > cnt_) throw ZError(-5, "incomplete or truncated stream");
  }
  // room for k more output bytes
  uint8_t* Room(size_t k) {
    if (o_ + k > out_.size()) out_.resize(2 * (o_ + k));
    return out_.data() + o_;
  }
  int Decode(const Huffman& h) {
    Need(16);
    int e = h.fast[bitbuf_ & ((1 << kFastBits) - 1)];
    if (e) {
      Drop(e & 15);
      return e >> 4;
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len < 16; ++len) {
      code |= static_cast<int>((bitbuf_ >> (len - 1)) & 1);
      int count = h.count[len];
      if (code - count < first) {
        Drop(len);
        return h.symbol[index + (code - first)];
      }
      index += count;
      first += count;
      first <<= 1;
      code <<= 1;
    }
    throw ZError(-3, "invalid code");
  }
  void Stored() {
    Drop(cnt_ & 7);
    int len = Bits(16);
    int nlen = Bits(16);
    if (len != (~nlen & 0xFFFF))
      throw ZError(-3, "invalid stored block lengths");
    Overrun();
    // give back the whole bytes still in the buffer
    size_t back = static_cast<size_t>(cnt_ >> 3);
    pos_ -= back;
    bitbuf_ = 0;
    cnt_ = 0;
    if (pos_ > n_ || n_ - pos_ < static_cast<size_t>(len))
      throw ZError(-5, "incomplete or truncated stream");
    memcpy(Room(len), p_ + pos_, len);
    o_ += len;
    pos_ += len;
  }
  void Codes(const Huffman& lit, const Huffman& dist) {
    static const uint16_t kLenBase[29] = {
        3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31,
        35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
    static const uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                                          1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                                          4, 4, 4, 4, 5, 5, 5, 5, 0};
    static const uint16_t kDistBase[30] = {
        1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129,
        193, 257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097,
        6145, 8193, 12289, 16385, 24577};
    static const uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2, 3, 3,
                                           4, 4, 5, 5, 6, 6, 7, 7, 8, 8,
                                           9, 9, 10, 10, 11, 11, 12, 12,
                                           13, 13};
    for (;;) {
      int sym = Decode(lit);
      if (sym < 256) {
        *Room(1) = static_cast<uint8_t>(sym);
        ++o_;
        continue;
      }
      if (sym == 256) break;
      sym -= 257;
      if (sym >= 29) throw ZError(-3, "invalid literal/length code");
      size_t len = kLenBase[sym] + Bits(kLenExtra[sym]);
      int ds = Decode(dist);
      if (ds >= 30) throw ZError(-3, "invalid distance code");
      size_t d = kDistBase[ds] + Bits(kDistExtra[ds]);
      if (d > o_) throw ZError(-3, "invalid distance too far back");
      uint8_t* o = Room(len);  // the copy may overlap its source
      for (size_t i = 0; i < len; ++i) o[i] = o[i - d];
      o_ += len;
      if (phantom_ > 4) Overrun();
    }
    Overrun();
  }
  void Fixed() {
    static Huffman lit, dist;
    static std::once_flag once;
    std::call_once(once, [] {
      uint8_t l[288];
      for (int i = 0; i < 144; ++i) l[i] = 8;
      for (int i = 144; i < 256; ++i) l[i] = 9;
      for (int i = 256; i < 280; ++i) l[i] = 7;
      for (int i = 280; i < 288; ++i) l[i] = 8;
      lit.Build(l, 288);
      uint8_t d[30];
      for (int i = 0; i < 30; ++i) d[i] = 5;
      dist.Build(d, 30);
    });
    Codes(lit, dist);
  }
  void Dynamic() {
    static const uint8_t kOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                       11, 4, 12, 3, 13, 2, 14, 1, 15};
    int nlen = Bits(5) + 257, ndist = Bits(5) + 1, ncode = Bits(4) + 4;
    if (nlen > 286 || ndist > 30)
      throw ZError(-3, "too many length or distance symbols");
    uint8_t lengths[320] = {0};
    for (int i = 0; i < ncode; ++i)
      lengths[kOrder[i]] = static_cast<uint8_t>(Bits(3));
    Huffman lencode;
    lencode.Build(lengths, 19);
    memset(lengths, 0, sizeof(lengths));
    int index = 0;
    while (index < nlen + ndist) {
      int sym = Decode(lencode);
      if (sym < 16) {
        lengths[index++] = static_cast<uint8_t>(sym);
        continue;
      }
      int len = 0, rep;
      if (sym == 16) {
        if (index == 0) throw ZError(-3, "invalid bit length repeat");
        len = lengths[index - 1];
        rep = 3 + Bits(2);
      } else if (sym == 17) {
        rep = 3 + Bits(3);
      } else {
        rep = 11 + Bits(7);
      }
      if (index + rep > nlen + ndist)
        throw ZError(-3, "invalid bit length repeat");
      while (rep--) lengths[index++] = static_cast<uint8_t>(len);
    }
    if (lengths[256] == 0)
      throw ZError(-3, "invalid code -- missing end-of-block");
    Huffman lit, dist;
    lit.Build(lengths, nlen);
    dist.Build(lengths + nlen, ndist);
    Codes(lit, dist);
    Overrun();
  }

  const uint8_t* p_;
  size_t n_;
  size_t pos_ = 0;
  int phantom_ = 0;
  uint64_t bitbuf_ = 0;
  int cnt_ = 0;
  Bytes out_;
  size_t o_ = 0;
};

// ---------------------------------------------------------------------- PNG

const uint8_t kPngSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

// zlib's CRC-32, eight bytes a step (slicing by 8)
uint32_t Crc32(const uint8_t* p, size_t n) {
  static uint32_t table[8][256];
  static std::once_flag once;
  std::call_once(once, [] {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = c & 1 ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int t = 1; t < 8; ++t)
        table[t][i] = (table[t - 1][i] >> 8) ^ table[0][table[t - 1][i] & 0xFF];
  });
  uint32_t c = 0xFFFFFFFFu;
  for (; n >= 8; n -= 8, p += 8) {
    uint32_t lo = c ^ (uint32_t(p[0]) | uint32_t(p[1]) << 8 |
                       uint32_t(p[2]) << 16 | uint32_t(p[3]) << 24);
    c = table[7][lo & 0xFF] ^ table[6][(lo >> 8) & 0xFF] ^
        table[5][(lo >> 16) & 0xFF] ^ table[4][lo >> 24] ^ table[3][p[4]] ^
        table[2][p[5]] ^ table[1][p[6]] ^ table[0][p[7]];
  }
  for (; n; --n, ++p) c = table[0][(c ^ *p) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

uint32_t Be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int PngChannels(int color) {  // gray, RGB, gray+alpha, RGBA; else 0
  switch (color) {
    case 0: return 1;
    case 2: return 3;
    case 4: return 2;
    case 6: return 4;
    default: return 0;
  }
}

// data/png.py's decode
Image DecodePng(const Bytes& data) {
  if (data.size() < 8 || memcmp(data.data(), kPngSig, 8) != 0)
    throw DecodeError("not a PNG file");
  const uint8_t* hdr = nullptr;
  Bytes idat;
  size_t pos = 8, n = data.size();
  while (pos + 8 <= n) {
    uint32_t length = Be32(&data[pos]);
    const uint8_t* kind = &data[pos + 4];
    if (pos + 12 + static_cast<size_t>(length) > n)
      throw DecodeError("PNG chunk " + BytesRepr(kind, 4) + ": truncated");
    if (Crc32(kind, 4 + static_cast<size_t>(length)) != Be32(&data[pos + 8 + length]))
      throw DecodeError("PNG chunk " + BytesRepr(kind, 4) + ": bad CRC");
    const uint8_t* body = kind + 4;
    if (!memcmp(kind, "IHDR", 4)) {
      if (length != 13) throw DecodeError("PNG IHDR of the wrong size");
      hdr = body;
    } else if (!memcmp(kind, "IDAT", 4)) {
      idat.insert(idat.end(), body, body + length);
    } else if (!memcmp(kind, "IEND", 4)) {
      break;
    }
    pos += 12 + static_cast<size_t>(length);
  }
  if (!hdr) throw DecodeError("PNG without IHDR");
  uint32_t w = Be32(hdr), h = Be32(hdr + 4);
  int depth = hdr[8], color = hdr[9], interlace = hdr[12];
  int bpp = PngChannels(color);
  if (depth != 8 || !bpp || interlace != 0)
    throw DecodeError("unsupported PNG: bit depth " + std::to_string(depth) +
                      ", color type " + std::to_string(color) +
                      ", interlace " + std::to_string(interlace) +
                      " (8-bit gray, gray+alpha, RGB or RGBA, not "
                      "interlaced)");
  size_t stride = static_cast<size_t>(w) * bpp;
  Bytes raw = Inflater(idat.data(), idat.size()).Run(h * (stride + 1));
  if (raw.size() != h * (stride + 1))
    throw DecodeError("PNG image data has the wrong size");
  Image img;
  img.h = static_cast<int>(h);
  img.w = static_cast<int>(w);
  img.c = bpp;
  img.data.resize(h * stride);
  Bytes zero(stride, 0);
  const uint8_t* prior = zero.data();
  for (uint32_t y = 0; y < h; ++y) {
    const uint8_t* row = &raw[y * (stride + 1)];
    int kind = row[0];
    ++row;
    uint8_t* out = &img.data[y * stride];
    switch (kind) {
      case 0:
        memcpy(out, row, stride);
        break;
      case 1:  // Sub
        memcpy(out, row, bpp);
        for (size_t i = bpp; i < stride; ++i)
          out[i] = static_cast<uint8_t>(row[i] + out[i - bpp]);
        break;
      case 2:  // Up
        for (size_t i = 0; i < stride; ++i)
          out[i] = static_cast<uint8_t>(row[i] + prior[i]);
        break;
      case 3:  // Average
        for (size_t i = 0; i < size_t(bpp); ++i)
          out[i] = static_cast<uint8_t>(row[i] + (prior[i] >> 1));
        for (size_t i = bpp; i < stride; ++i)
          out[i] = static_cast<uint8_t>(row[i] + ((out[i - bpp] + prior[i]) >> 1));
        break;
      case 4:  // Paeth; a = 0 and c = 0 on the first pixel leave b
        for (size_t i = 0; i < size_t(bpp); ++i)
          out[i] = static_cast<uint8_t>(row[i] + prior[i]);
        for (size_t i = bpp; i < stride; ++i) {
          int a = out[i - bpp], b = prior[i], c = prior[i - bpp];
          int pa = abs(b - c), pb = abs(a - c), pc = abs(a + b - 2 * c);
          int pred = pa <= pb && pa <= pc ? a : (pb <= pc ? b : c);
          out[i] = static_cast<uint8_t>(row[i] + pred);
        }
        break;
      default:
        throw DecodeError("PNG row filter " + std::to_string(kind));
    }
    prior = out;
  }
  return img;
}

// data/png.py's read_shape
void PngShape(const char* path, int* shape) {
  Bytes head = ReadFile(path, 33);
  if (head.size() < 16 || memcmp(head.data(), kPngSig, 8) != 0 ||
      memcmp(&head[12], "IHDR", 4) != 0)
    throw DecodeError(std::string(path) + ": not a PNG file");
  if (head.size() < 26)
    throw DecodeError(std::string(path) + ": PNG header is truncated");
  int c = PngChannels(head[25]);
  shape[0] = static_cast<int>(Be32(&head[20]));
  shape[1] = static_cast<int>(Be32(&head[16]));
  shape[2] = c ? c : 1;
}

// --------------------------------------------------------------------- JPEG

const int kZigzag[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

const char* SofName(int marker) {  // what the decoder refuses, by SOF
  switch (marker) {
    case 0xC3: return "lossless";
    case 0xC5: case 0xC6: case 0xC7: return "hierarchical";
    case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
      return "arithmetic-coded";
    default: return nullptr;
  }
}

// Canonical codes -> (code length, symbol) lookups on a 16-bit window.
struct JpegTable {
  std::vector<uint8_t> len, sym;
  void Build(const uint8_t* counts, const uint8_t* symbols, size_t nsym) {
    len.assign(65536, 0);
    sym.assign(65536, 0);
    uint32_t code = 0;
    size_t k = 0;
    for (int length = 1; length <= 16; ++length) {
      for (int i = 0; i < counts[length - 1]; ++i) {
        uint32_t lo = code << (16 - length), hi = (code + 1) << (16 - length);
        if (hi > 65536 || k >= nsym) throw DecodeError("bad Huffman table");
        memset(&len[lo], length, hi - lo);
        memset(&sym[lo], symbols[k], hi - lo);
        ++code;
        ++k;
      }
      code <<= 1;
    }
  }
};

// The bits of one entropy-coded segment (byte stuffing removed), read as
// 16-bit windows from any bit position, padded with ones as a decoder
// reading past the end sees them.
class Bits {
 public:
  Bits(const Bytes& seg, const std::string& name)
      : data_(seg), limit_(8 * seg.size() + 16), name_(name) {
    data_.insert(data_.end(), 4, 0xFF);
  }
  uint32_t Win(size_t pos) const {
    if (pos >= limit_) throw DecodeError(name_ + ": JPEG scan data ends early");
    size_t b = pos >> 3;
    uint32_t v = (uint32_t(data_[b]) << 16) | (uint32_t(data_[b + 1]) << 8) |
                 data_[b + 2];
    return (v >> (8 - (pos & 7))) & 0xFFFF;
  }
  int Receive(size_t pos, int n) const {  // n (<= 16) raw bits
    return n ? static_cast<int>(Win(pos) >> (16 - n)) : 0;
  }
  int Bit(size_t pos) const { return static_cast<int>(Win(pos) >> 15); }

 private:
  Bytes data_;
  size_t limit_;
  const std::string& name_;
};

inline int Extend(int v, int t) {
  return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v;
}

struct Frame {
  int h = 0, w = 0;
  bool progressive = false;
  std::vector<int> ids, hs, vs, tq;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  // each component's coefficient blocks over the whole MCU grid, [by][bx][64]
  std::vector<std::vector<int32_t>> coef;
  std::vector<int> nby, nbx;

  int CompH(int i) const { return (h * vs[i] + vmax - 1) / vmax; }
  int CompW(int i) const { return (w * hs[i] + hmax - 1) / hmax; }
  int32_t* Block(int ci, int by, int bx) {
    return &coef[ci][(static_cast<size_t>(by) * nbx[ci] + bx) * 64];
  }
};

struct Unit {
  int ci, by, bx;
};

// A scan's blocks in order, and where each MCU starts in that list: the
// component's own block grid when it is scanned alone.
void ScanUnits(const Frame& f, const std::vector<int>& comps,
               std::vector<Unit>* units, std::vector<size_t>* mcu_start) {
  units->clear();
  mcu_start->clear();
  if (comps.size() == 1) {
    int ci = comps[0];
    int nby = (f.CompH(ci) + 7) / 8, nbx = (f.CompW(ci) + 7) / 8;
    for (int by = 0; by < nby; ++by)
      for (int bx = 0; bx < nbx; ++bx) {
        mcu_start->push_back(units->size());
        units->push_back({ci, by, bx});
      }
  } else {
    for (int my = 0; my < f.mcuy; ++my)
      for (int mx = 0; mx < f.mcux; ++mx) {
        mcu_start->push_back(units->size());
        for (int ci : comps)
          for (int y = 0; y < f.vs[ci]; ++y)
            for (int x = 0; x < f.hs[ci]; ++x)
              units->push_back({ci, my * f.vs[ci] + y, mx * f.hs[ci] + x});
      }
  }
  mcu_start->push_back(units->size());
}

// The entropy-coded data of a scan from `start`, split at restart markers,
// byte stuffing removed; returns the offset of the marker that ends it.
size_t Segments(const Bytes& data, size_t start, std::vector<Bytes>* parts) {
  size_t n = data.size(), end = start;
  for (;;) {
    const void* hit = end < n ? memchr(&data[end], 0xFF, n - end) : nullptr;
    if (!hit) {
      end = n;
      break;
    }
    end = static_cast<const uint8_t*>(hit) - data.data();
    if (end + 1 >= n) {
      end = n;
      break;
    }
    uint8_t nxt = data[end + 1];
    if (nxt == 0 || (nxt >= 0xD0 && nxt <= 0xD7) || nxt == 0xFF) {
      end += nxt == 0xFF ? 1 : 2;
      continue;
    }
    break;
  }
  parts->clear();
  parts->emplace_back();
  for (size_t i = start; i < end; ++i) {
    uint8_t b = data[i];
    if (b == 0xFF && i + 1 < end && data[i + 1] >= 0xD0 && data[i + 1] <= 0xD7) {
      parts->emplace_back();
      ++i;
      continue;
    }
    parts->back().push_back(b);
  }
  for (Bytes& p : *parts) {  // FF 00 -> FF, left to right
    size_t o = 0;
    for (size_t i = 0; i < p.size(); ++i) {
      p[o++] = p[i];
      if (p[i] == 0xFF && i + 1 < p.size() && p[i + 1] == 0) ++i;
    }
    p.resize(o);
  }
  return end;
}

struct JpegState {
  std::string name;
  Frame frame;
  bool have_frame = false;
  int64_t qt[16][64];
  bool have_qt[16] = {false};
  JpegTable dc[16], ac[16];
  bool have_dc[16] = {false}, have_ac[16] = {false};
  int restart = 0;
  int adobe = -1;

  DecodeError Error(const std::string& what) const {
    return DecodeError(name + ": " + what);
  }
  const JpegTable& Dc(int t) const {
    if (!have_dc[t]) throw Error("missing DC Huffman table");
    return dc[t];
  }
  const JpegTable& Ac(int t) const {
    if (!have_ac[t]) throw Error("missing AC Huffman table");
    return ac[t];
  }
};

// One restart interval of a sequential scan (jdhuff.c decode_mcu).
void DecodeSegment(const Bits& bits, const Unit* u, const Unit* end,
                   const JpegTable* const* dct, const JpegTable* const* act,
                   int* pred, Frame* f, const JpegState& st) {
  size_t pos = 0;
  for (; u != end; ++u) {
    const JpegTable& d = *dct[u->ci];
    const JpegTable& a = *act[u->ci];
    int32_t* blk = f->Block(u->ci, u->by, u->bx);
    uint32_t w = bits.Win(pos);
    int t = d.sym[w];
    pos += d.len[w];
    int diff = 0;
    if (t) {
      if (t > 16) throw st.Error("bad DC difference");
      diff = Extend(bits.Receive(pos, t), t);
      pos += t;
    }
    pred[u->ci] += diff;
    blk[0] = pred[u->ci];
    int k = 1;
    while (k < 64) {
      w = bits.Win(pos);
      int rs = a.sym[w];
      pos += a.len[w];
      int r = rs >> 4, s = rs & 15;
      if (s == 0) {
        if (r != 15) break;  // end of block
        k += 16;
        continue;
      }
      k += r;
      if (k > 63) throw st.Error("bad AC coefficient index");
      blk[kZigzag[k]] = Extend(bits.Receive(pos, s), s);
      pos += s;
      ++k;
    }
  }
}

using Blocks = std::vector<std::pair<int, int32_t*>>;

void DcFirst(const Bits& bits, const Blocks& blocks,
             const JpegTable* const* tabs, int al, int* pred,
             const JpegState& st) {
  size_t pos = 0;
  for (const auto& cb : blocks) {
    const JpegTable& tab = *tabs[cb.first];
    uint32_t w = bits.Win(pos);
    int t = tab.sym[w];
    pos += tab.len[w];
    if (t) {
      if (t > 16) throw st.Error("bad DC difference");
      pred[cb.first] += Extend(bits.Receive(pos, t), t);
      pos += t;
    }
    cb.second[0] = static_cast<int32_t>(static_cast<int64_t>(pred[cb.first]) *
                                        (int64_t(1) << al));
  }
}

void DcRefine(const Bits& bits, const Blocks& blocks, int al) {
  size_t pos = 0;
  for (const auto& cb : blocks) {
    if (bits.Bit(pos)) cb.second[0] |= 1 << al;
    ++pos;
  }
}

void AcFirst(const Bits& bits, const Blocks& blocks, const JpegTable& tab,
             int ss, int se, int al, const JpegState& st) {
  size_t pos = 0;
  int64_t eobrun = 0;
  for (const auto& cb : blocks) {
    int32_t* blk = cb.second;
    if (eobrun) {
      --eobrun;
      continue;
    }
    int k = ss;
    while (k <= se) {
      uint32_t w = bits.Win(pos);
      int rs = tab.sym[w];
      pos += tab.len[w];
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) throw st.Error("bad AC coefficient index");
        blk[kZigzag[k]] = static_cast<int32_t>(
            static_cast<int64_t>(Extend(bits.Receive(pos, s), s)) *
            (int64_t(1) << al));
        pos += s;
        ++k;
      } else if (r == 15) {
        k += 16;
      } else {
        eobrun = (int64_t(1) << r) - 1 + bits.Receive(pos, r);
        pos += r;
        break;
      }
    }
  }
}

void AcRefine(const Bits& bits, const Blocks& blocks, const JpegTable& tab,
              int ss, int se, int al, const JpegState& st) {
  const int32_t p1 = int32_t(1) << al, m1 = -p1;
  size_t pos = 0;
  int64_t eobrun = 0;
  for (const auto& cb : blocks) {
    int32_t* blk = cb.second;
    int k = ss;
    if (!eobrun) {
      while (k <= se) {
        uint32_t w = bits.Win(pos);
        int rs = tab.sym[w];
        pos += tab.len[w];
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = bits.Bit(pos) ? p1 : m1;
          ++pos;
        } else if (r != 15) {
          eobrun = (int64_t(1) << r) + bits.Receive(pos, r);
          pos += r;
          break;
        }
        while (k <= se) {
          if (k > 63) throw st.Error("bad AC coefficient index");
          int z = kZigzag[k];
          int32_t c = blk[z];
          if (c) {
            if (bits.Bit(pos) && !(c & p1)) blk[z] = c + (c >= 0 ? p1 : m1);
            ++pos;
          } else {
            if (--r < 0) break;
          }
          ++k;
        }
        if (s) {
          if (k > 63) throw st.Error("bad AC coefficient index");
          blk[kZigzag[k]] = s;
        }
        ++k;
      }
    }
    if (eobrun) {
      for (; k <= se; ++k) {
        if (k > 63) throw st.Error("bad AC coefficient index");
        int z = kZigzag[k];
        int32_t c = blk[z];
        if (c) {
          if (bits.Bit(pos) && !(c & p1)) blk[z] = c + (c >= 0 ? p1 : m1);
          ++pos;
        }
      }
      --eobrun;
    }
  }
}

void DecodeScan(JpegState* st, const std::vector<int>& comps,
                const std::vector<int>& td, const std::vector<int>& ta,
                const std::vector<Bytes>& parts, const int* band) {
  Frame& f = st->frame;
  std::vector<Unit> units;
  std::vector<size_t> mcu_start;
  ScanUnits(f, comps, &units, &mcu_start);
  size_t nmcu = mcu_start.size() - 1;
  size_t per = st->restart ? static_cast<size_t>(st->restart) : nmcu;
  const size_t nc = f.ids.size();
  std::vector<const JpegTable*> dct(nc, nullptr), act(nc, nullptr);
  int ss = band[0], se = band[1], ah = band[2], al = band[3];
  bool dc_first = f.progressive && ss == 0 && ah == 0;
  for (size_t i = 0; i < comps.size(); ++i) {
    if (!f.progressive || dc_first) dct[comps[i]] = &st->Dc(td[i]);
    if (!f.progressive) act[comps[i]] = &st->Ac(ta[i]);
  }
  const JpegTable* ac_tab =
      f.progressive && ss ? &st->Ac(ta[0]) : nullptr;
  for (size_t k = 0; k < parts.size(); ++k) {
    size_t a = k * per;
    if (a >= nmcu) break;
    size_t b = a + per < nmcu ? a + per : nmcu;
    Bits bits(parts[k], st->name);
    std::vector<int> pred(nc, 0);
    const Unit* u0 = units.data() + mcu_start[a];
    const Unit* u1 = units.data() + mcu_start[b];
    if (!f.progressive) {
      DecodeSegment(bits, u0, u1, dct.data(), act.data(), pred.data(), &f,
                    *st);
      continue;
    }
    Blocks blocks;
    blocks.reserve(u1 - u0);
    for (const Unit* u = u0; u != u1; ++u)
      blocks.emplace_back(u->ci, f.Block(u->ci, u->by, u->bx));
    if (ss == 0 && ah == 0) {
      DcFirst(bits, blocks, dct.data(), al, pred.data(), *st);
    } else if (ss == 0) {
      DcRefine(bits, blocks, al);
    } else if (ah == 0) {
      AcFirst(bits, blocks, *ac_tab, ss, se, al, *st);
    } else {
      AcRefine(bits, blocks, *ac_tab, ss, se, al, *st);
    }
  }
}

// One pass of libjpeg's islow IDCT (jidctint.c, CONST_BITS 13) over
// in[0], in[step], ..., in[7 step], descaled by `shift` with rounding.
inline void Idct1d(const int64_t* in, int step, int shift, int64_t* out,
                   int ostep) {
  const int64_t c0 = in[0], c1 = in[step], c2 = in[2 * step],
                c3 = in[3 * step], c4 = in[4 * step], c5 = in[5 * step],
                c6 = in[6 * step], c7 = in[7 * step];
  int64_t z1 = (c2 + c6) * 4433;
  int64_t tmp2 = z1 + c6 * -15137;
  int64_t tmp3 = z1 + c2 * 6270;
  int64_t tmp0 = (c0 + c4) * 8192;
  int64_t tmp1 = (c0 - c4) * 8192;
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  int64_t t0 = c7, t1 = c5, t2 = c3, t3 = c1;
  z1 = t0 + t3;
  int64_t z2 = t1 + t2, z3 = t0 + t2, z4 = t1 + t3;
  int64_t z5 = (z3 + z4) * 9633;
  t0 *= 2446;
  t1 *= 16819;
  t2 *= 25172;
  t3 *= 12299;
  z1 *= -7373;
  z2 *= -20995;
  z3 = z3 * -16069 + z5;
  z4 = z4 * -3196 + z5;
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;
  const int64_t half = int64_t(1) << (shift - 1);
  out[0 * ostep] = (tmp10 + t3 + half) >> shift;
  out[1 * ostep] = (tmp11 + t2 + half) >> shift;
  out[2 * ostep] = (tmp12 + t1 + half) >> shift;
  out[3 * ostep] = (tmp13 + t0 + half) >> shift;
  out[4 * ostep] = (tmp13 - t0 + half) >> shift;
  out[5 * ostep] = (tmp12 - t1 + half) >> shift;
  out[6 * ostep] = (tmp11 - t2 + half) >> shift;
  out[7 * ostep] = (tmp10 - t3 + half) >> shift;
}

// Dequantize and invert one block of row-major coefficients into 8 rows
// of `stride` samples.
void Idct(const int32_t* coef, const int64_t* q, uint8_t* out,
          size_t stride) {
  int64_t x[64], ws[64], row[8];
  for (int i = 0; i < 64; ++i) x[i] = static_cast<int64_t>(coef[i]) * q[i];
  // pass 1 over the columns: ws[y][v]
  for (int v = 0; v < 8; ++v) Idct1d(x + v, 8, 13 - 2, ws + v, 8);
  // pass 2 over the rows
  for (int y = 0; y < 8; ++y) {
    Idct1d(ws + 8 * y, 1, 13 + 2 + 3, row, 1);
    for (int xx = 0; xx < 8; ++xx) {
      int64_t v = row[xx] + 128;
      out[y * stride + xx] =
          static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

// libjpeg's fancy upsampling (jdsample.c) of a [h, w] plane: h2v1 (4:2:2)
// into [h, 2w], or h2v2 (4:2:0) into [2h, 2w].
Bytes Fancy(const Bytes& x, int h, int w, bool v2) {
  Bytes out(static_cast<size_t>(h) * (v2 ? 2 : 1) * 2 * w);
  if (!v2) {
    for (int y = 0; y < h; ++y) {
      const uint8_t* r = &x[static_cast<size_t>(y) * w];
      uint8_t* o = &out[static_cast<size_t>(y) * 2 * w];
      for (int j = 0; j < w; ++j) {
        int c = r[j];
        int left = r[j > 0 ? j - 1 : 0], right = r[j + 1 < w ? j + 1 : w - 1];
        o[2 * j] = static_cast<uint8_t>(j == 0 ? c : (3 * c + left + 1) >> 2);
        o[2 * j + 1] =
            static_cast<uint8_t>(j == w - 1 ? c : (3 * c + right + 2) >> 2);
      }
    }
    return out;
  }
  std::vector<int> cs(w);
  for (int y = 0; y < h; ++y) {
    const uint8_t* r = &x[static_cast<size_t>(y) * w];
    for (int half = 0; half < 2; ++half) {
      int ny = half == 0 ? (y > 0 ? y - 1 : 0) : (y + 1 < h ? y + 1 : h - 1);
      const uint8_t* near = &x[static_cast<size_t>(ny) * w];
      for (int j = 0; j < w; ++j) cs[j] = 3 * r[j] + near[j];
      uint8_t* o = &out[(2 * static_cast<size_t>(y) + half) * 2 * w];
      for (int j = 0; j < w; ++j) {
        int c = cs[j];
        int left = cs[j > 0 ? j - 1 : 0], right = cs[j + 1 < w ? j + 1 : w - 1];
        o[2 * j] = static_cast<uint8_t>(j == 0 ? (4 * c + 8) >> 4
                                               : (3 * c + left + 8) >> 4);
        o[2 * j + 1] = static_cast<uint8_t>(
            j == w - 1 ? (4 * c + 7) >> 4 : (3 * c + right + 7) >> 4);
      }
    }
  }
  return out;
}

inline uint8_t Clamp255(int64_t v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

Image Assemble(JpegState* st) {
  Frame& f = st->frame;
  const int nc = static_cast<int>(f.ids.size());
  std::vector<Bytes> planes(nc);
  for (int ci = 0; ci < nc; ++ci) {
    int tq = f.tq[ci];
    if (tq > 15 || !st->have_qt[tq]) throw st->Error("missing quantization table");
    int nby = f.nby[ci], nbx = f.nbx[ci];
    size_t pw = static_cast<size_t>(nbx) * 8;
    Bytes full(static_cast<size_t>(nby) * 8 * pw);
    for (int by = 0; by < nby; ++by)
      for (int bx = 0; bx < nbx; ++bx)
        Idct(f.Block(ci, by, bx), st->qt[tq],
             &full[static_cast<size_t>(by) * 8 * pw + static_cast<size_t>(bx) * 8],
             pw);
    int ch = f.CompH(ci), cw = f.CompW(ci);
    Bytes plane(static_cast<size_t>(ch) * cw);
    for (int y = 0; y < ch; ++y)
      memcpy(&plane[static_cast<size_t>(y) * cw], &full[y * pw], cw);
    int h2 = f.hmax / f.hs[ci], v2 = f.vmax / f.vs[ci];
    int ph = ch, pwid = cw;
    if (h2 == 2 && (v2 == 2 || v2 == 1)) {
      plane = Fancy(plane, ch, cw, v2 == 2);
      ph = ch * v2;
      pwid = 2 * cw;
    } else if (!(h2 == 1 && v2 == 1)) {
      throw st->Error("JPEG chroma sampling " + IntList(f.hs) + "x" +
                      IntList(f.vs) +
                      " is not supported (4:4:4, 4:2:2, 4:2:0 only)");
    }
    if (ph < f.h || pwid < f.w) throw st->Error("component smaller than the frame");
    Bytes crop(static_cast<size_t>(f.h) * f.w);
    for (int y = 0; y < f.h; ++y)
      memcpy(&crop[static_cast<size_t>(y) * f.w],
             &plane[static_cast<size_t>(y) * pwid], f.w);
    planes[ci] = std::move(crop);
  }
  Image img;
  img.h = f.h;
  img.w = f.w;
  if (nc == 1) {
    img.c = 1;
    img.data = std::move(planes[0]);
    return img;
  }
  if (nc != 3)
    throw st->Error(std::to_string(nc) +
                    "-component JPEG (CMYK) is not supported");
  img.c = 3;
  size_t n = static_cast<size_t>(f.h) * f.w;
  img.data.resize(n * 3);
  bool rgb_coded = st->adobe == 0 ||
                   (f.ids[0] == 82 && f.ids[1] == 71 && f.ids[2] == 66);
  if (rgb_coded) {
    for (size_t i = 0; i < n; ++i)
      for (int k = 0; k < 3; ++k) img.data[i * 3 + k] = planes[k][i];
    return img;
  }
  // jdcolor.c ycc_rgb_convert with its fixed-point tables (SCALEBITS 16):
  // int(v * 65536 + 0.5) of 1.40200, 1.77200, 0.34414 and 0.71414
  const int64_t kCr = 91881, kCb = 116130, kGb = 22554, kGr = 46802;
  const int64_t one_half = int64_t(1) << 15;
  for (size_t i = 0; i < n; ++i) {
    int64_t y = planes[0][i], xb = int64_t(planes[1][i]) - 128,
            xr = int64_t(planes[2][i]) - 128;
    img.data[i * 3 + 0] = Clamp255(y + ((kCr * xr + one_half) >> 16));
    img.data[i * 3 + 1] =
        Clamp255(y + ((-kGb * xb + one_half + -kGr * xr) >> 16));
    img.data[i * 3 + 2] = Clamp255(y + ((kCb * xb + one_half) >> 16));
  }
  return img;
}

// data/jpeg.py's decode
Image DecodeJpeg(const Bytes& data, const std::string& name) {
  JpegState st;
  st.name = name;
  const size_t n = data.size();
  if (n < 2 || data[0] != 0xFF || data[1] != 0xD8)
    throw st.Error("not a JPEG file");
  auto at = [&](const uint8_t* body, size_t len, size_t i) -> int {
    if (i >= len) throw st.Error("truncated JPEG segment");
    return body[i];
  };
  size_t pos = 2;
  while (pos < n) {
    if (data[pos] != 0xFF)
      throw st.Error("bad JPEG marker at byte " + std::to_string(pos));
    if (pos + 1 >= n) throw st.Error("truncated JPEG marker");
    int marker = data[pos + 1];
    pos += 2;
    if (marker == 0xFF) {  // fill byte
      pos -= 1;
      continue;
    }
    if (marker == 0xD9) break;  // EOI
    if ((marker >= 0xD0 && marker <= 0xD7) || marker == 0x01) continue;
    size_t length = 0;
    if (pos < n) length = data[pos];
    if (pos + 1 < n) length = (length << 8) | data[pos + 1];
    const uint8_t* body = pos + 2 <= n ? &data[0] + pos + 2 : &data[0] + n;
    size_t blen = pos + length > pos + 2 && pos + 2 < n
                      ? (pos + length < n ? pos + length : n) - (pos + 2)
                      : 0;
    pos += length;
    if (marker == 0xC0 || marker == 0xC1 || marker == 0xC2) {
      int bits = at(body, blen, 0);
      if (bits != 8)
        throw st.Error(std::to_string(bits) + "-bit JPEG samples (8 only)");
      Frame f;
      f.h = (at(body, blen, 1) << 8) | at(body, blen, 2);
      f.w = (at(body, blen, 3) << 8) | at(body, blen, 4);
      int nc = at(body, blen, 5);
      if (nc == 0) throw st.Error("frame header with no component");
      for (int i = 0; i < nc; ++i) {
        f.ids.push_back(at(body, blen, 6 + 3 * i));
        int hv = at(body, blen, 7 + 3 * i);
        f.hs.push_back(hv >> 4);
        f.vs.push_back(hv & 15);
        f.tq.push_back(at(body, blen, 8 + 3 * i));
      }
      f.progressive = marker == 0xC2;
      for (int i = 0; i < nc; ++i) {
        if (!f.hs[i] || !f.vs[i]) throw st.Error("zero sampling factor");
        f.hmax = std::max(f.hmax, f.hs[i]);
        f.vmax = std::max(f.vmax, f.vs[i]);
      }
      f.mcux = (f.w + 8 * f.hmax - 1) / (8 * f.hmax);
      f.mcuy = (f.h + 8 * f.vmax - 1) / (8 * f.vmax);
      f.coef.resize(nc);
      for (int i = 0; i < nc; ++i) {
        f.nby.push_back(f.mcuy * f.vs[i]);
        f.nbx.push_back(f.mcux * f.hs[i]);
        f.coef[i].assign(static_cast<size_t>(f.nby[i]) * f.nbx[i] * 64, 0);
      }
      st.frame = std::move(f);
      st.have_frame = true;
    } else if (const char* kind = SofName(marker)) {
      throw st.Error(std::string(kind) +
                     " JPEG is not supported (Huffman sequential or "
                     "progressive only)");
    } else if (marker == 0xC4) {  // DHT
      size_t i = 0;
      while (i < blen) {
        int cls = body[i] >> 4, tid = body[i] & 15;
        if (i + 17 > blen) throw st.Error("truncated Huffman table");
        const uint8_t* counts = body + i + 1;
        size_t nsym = 0;
        for (int k = 0; k < 16; ++k) nsym += counts[k];
        size_t avail = i + 17 <= blen ? blen - (i + 17) : 0;
        JpegTable& tab = cls ? st.ac[tid] : st.dc[tid];
        tab.Build(counts, body + i + 17, nsym < avail ? nsym : avail);
        (cls ? st.have_ac : st.have_dc)[tid] = true;
        i += 17 + nsym;
      }
    } else if (marker == 0xDB) {  // DQT
      size_t i = 0;
      while (i < blen) {
        int prec = body[i] >> 4, tid = body[i] & 15;
        int64_t vals[64];
        if (prec) {
          for (int k = 0; k < 64; ++k)
            vals[k] = (at(body, blen, i + 1 + 2 * k) << 8) |
                      at(body, blen, i + 2 + 2 * k);
          i += 129;
        } else {
          for (int k = 0; k < 64; ++k) vals[k] = at(body, blen, i + 1 + k);
          i += 65;
        }
        for (int k = 0; k < 64; ++k) st.qt[tid][kZigzag[k]] = vals[k];
        st.have_qt[tid] = true;
      }
    } else if (marker == 0xDD) {  // DRI
      st.restart = (at(body, blen, 0) << 8) | at(body, blen, 1);
    } else if (marker == 0xEE && blen >= 12 && !memcmp(body, "Adobe", 5)) {
      st.adobe = body[11];
    } else if (marker == 0xDA) {  // SOS
      if (!st.have_frame) throw st.Error("scan before the frame header");
      int ns = at(body, blen, 0);
      std::vector<int> comps, td, ta;
      for (int i = 0; i < ns; ++i) {
        int id = at(body, blen, 1 + 2 * i);
        int ci = -1;
        for (size_t c = 0; c < st.frame.ids.size(); ++c)
          if (st.frame.ids[c] == id) {
            ci = static_cast<int>(c);
            break;
          }
        if (ci < 0) throw st.Error("scan of an unknown component");
        comps.push_back(ci);
        int t = at(body, blen, 2 + 2 * i);
        td.push_back(t >> 4);
        ta.push_back(t & 15);
      }
      std::vector<Bytes> parts;
      pos = Segments(data, pos, &parts);
      int band[4] = {0, 63, 0, 0};
      if (st.frame.progressive) {
        band[0] = at(body, blen, 1 + 2 * ns);
        band[1] = at(body, blen, 2 + 2 * ns);
        band[2] = at(body, blen, 3 + 2 * ns) >> 4;
        band[3] = at(body, blen, 3 + 2 * ns) & 15;
        if (band[0] && ns != 1)
          throw st.Error("a progressive AC scan of " + std::to_string(ns) +
                         " components");
      }
      DecodeScan(&st, comps, td, ta, parts, band);
    }
  }
  if (!st.have_frame) throw st.Error("no frame header");
  return Assemble(&st);
}

// data/jpeg.py's read_shape
void JpegShape(const char* path, int* shape) {
  Bytes data = ReadFile(path);
  std::string name(path);
  if (data.size() < 2 || data[0] != 0xFF || data[1] != 0xD8)
    throw DecodeError(name + ": not a JPEG file");
  size_t pos = 2, n = data.size();
  while (pos + 4 <= n) {
    int marker = data[pos + 1];
    if (data[pos] != 0xFF || marker == 0xFF) {
      ++pos;
      continue;
    }
    size_t length = (size_t(data[pos + 2]) << 8) | data[pos + 3];
    if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 &&
        marker != 0xC8 && marker != 0xCC) {
      if (pos + 10 > n) throw DecodeError(name + ": truncated frame header");
      const uint8_t* body = &data[pos + 4];
      shape[0] = (body[1] << 8) | body[2];
      shape[1] = (body[3] << 8) | body[4];
      shape[2] = body[5] == 1 ? 1 : 3;
      return;
    }
    pos += 2 + length;
  }
  throw DecodeError(name + ": no JPEG frame header");
}

bool IsJpeg(const char* path) {  // data/llff.py's dispatch: magic bytes
  Bytes head = ReadFile(path, 2);
  return head.size() == 2 && head[0] == 0xFF && head[1] == 0xD8;
}

Image DecodeAny(const char* path) {
  Bytes data = ReadFile(path);
  if (data.size() >= 2 && data[0] == 0xFF && data[1] == 0xD8)
    return DecodeJpeg(data, path);
  return DecodePng(data);
}

// runtime/image_loader.cc's ResizeToFloat, operation for operation: gray
// broadcast, alpha dropped, bilinear with half-pixel centres and clamped
// corners when the size changes, then v * (1/255).  Gray+alpha gives its
// gray three times (that library's channel clamp gives gray, alpha, alpha).
void ResizeToFloat(const Image& src, float* out, int oh, int ow) {
  const float inv255 = 1.0f / 255.0f;
  const int c = src.c;
  if (oh == src.h && ow == src.w) {
    const size_t n = static_cast<size_t>(oh) * ow;
    for (size_t i = 0; i < n; ++i) {
      for (int k = 0; k < 3; ++k) {
        int kk = c < 3 ? 0 : k;
        out[i * 3 + k] = src.data[i * c + kk] * inv255;
      }
    }
    return;
  }
  const float sy = static_cast<float>(src.h) / oh;
  const float sx = static_cast<float>(src.w) / ow;
  for (int y = 0; y < oh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = fy < 0 ? 0 : static_cast<int>(fy);
    int y1 = y0 + 1 < src.h ? y0 + 1 : src.h - 1;
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    for (int x = 0; x < ow; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = fx < 0 ? 0 : static_cast<int>(fx);
      int x1 = x0 + 1 < src.w ? x0 + 1 : src.w - 1;
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      for (int k = 0; k < 3; ++k) {
        int kk = c < 3 ? 0 : k;
        float v00 = src.data[(static_cast<size_t>(y0) * src.w + x0) * c + kk];
        float v01 = src.data[(static_cast<size_t>(y0) * src.w + x1) * c + kk];
        float v10 = src.data[(static_cast<size_t>(y1) * src.w + x0) * c + kk];
        float v11 = src.data[(static_cast<size_t>(y1) * src.w + x1) * c + kk];
        float v = (1 - wy) * ((1 - wx) * v00 + wx * v01) +
                  wy * ((1 - wx) * v10 + wx * v11);
        out[(static_cast<size_t>(y) * ow + x) * 3 + k] = v * inv255;
      }
    }
  }
}

// ---------------------------------------------------------------- the pool

class ThreadPool {
 public:
  explicit ThreadPool(int n) {
    for (int i = 0; i < n; ++i) workers_.emplace_back([this] { Loop(); });
  }
  ~ThreadPool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }
  void Submit(std::function<void()> fn) {
    {
      std::unique_lock<std::mutex> lk(mu_);
      tasks_.push(std::move(fn));
    }
    cv_.notify_one();
  }

 private:
  void Loop() {
    for (;;) {
      std::function<void()> task;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !tasks_.empty(); });
        if (stop_ && tasks_.empty()) return;
        task = std::move(tasks_.front());
        tasks_.pop();
      }
      task();
    }
  }
  std::mutex mu_;
  std::condition_variable cv_;
  std::queue<std::function<void()>> tasks_;
  std::vector<std::thread> workers_;
  bool stop_ = false;
};

void SetError(char* err, int err_len, const std::string& msg) {
  if (err && err_len > 0) {
    strncpy(err, msg.c_str(), static_cast<size_t>(err_len) - 1);
    err[err_len - 1] = '\0';
  }
}

// Runs fn; maps what it throws to the C API's return codes.
template <typename Fn>
int Guard(char* err, int err_len, Fn fn) {
  try {
    fn();
    return 0;
  } catch (const FileError& e) {
    SetError(err, err_len, e.what());
    return -e.err;
  } catch (const ZError& e) {
    SetError(err, err_len, e.what());
    return 2;
  } catch (const std::bad_alloc&) {
    SetError(err, err_len, "out of memory");
    return -ENOMEM;
  } catch (const std::exception& e) {
    SetError(err, err_len, e.what());
    return 1;
  }
}

}  // namespace

extern "C" {

int dyn_decode_file(const char* path, unsigned char** data, int* shape,
                    char* err, int err_len) {
  *data = nullptr;
  return Guard(err, err_len, [&] {
    Image img = DecodeAny(path);
    unsigned char* buf = static_cast<unsigned char*>(
        malloc(img.data.size() ? img.data.size() : 1));
    if (!buf) throw std::bad_alloc();
    memcpy(buf, img.data.data(), img.data.size());
    *data = buf;
    shape[0] = img.h;
    shape[1] = img.w;
    shape[2] = img.c;
  });
}

int dyn_read_shape(const char* path, int* shape, char* err, int err_len) {
  return Guard(err, err_len, [&] {
    if (IsJpeg(path)) {
      JpegShape(path, shape);
    } else {
      PngShape(path, shape);
    }
  });
}

void dyn_free(void* p) { free(p); }

void* dyn_loader_create(int num_threads) {
  return new ThreadPool(num_threads > 0 ? num_threads : 1);
}

void dyn_loader_destroy(void* h) { delete static_cast<ThreadPool*>(h); }

int dyn_loader_decode_batch(void* handle, const char** paths, int n,
                            float* out, int out_h, int out_w, char* err,
                            int err_len) {
  auto* pool = static_cast<ThreadPool*>(handle);
  std::vector<std::string> errors(n);
  std::vector<char> failed(n, 0);
  int done = 0;
  std::mutex mu;
  std::condition_variable cv;
  for (int i = 0; i < n; ++i) {
    pool->Submit([&, i] {
      char msg[512] = {0};
      int rc = Guard(msg, sizeof(msg), [&] {
        Image img = DecodeAny(paths[i]);
        ResizeToFloat(img, out + static_cast<size_t>(i) * out_h * out_w * 3,
                      out_h, out_w);
      });
      std::unique_lock<std::mutex> lk(mu);
      if (rc) {
        failed[i] = 1;
        errors[i] = msg;
      }
      if (++done == n) cv.notify_all();
    });
  }
  std::unique_lock<std::mutex> lk(mu);
  cv.wait(lk, [&] { return done == n; });
  for (int i = 0; i < n; ++i)
    if (failed[i]) {
      SetError(err, err_len, errors[i]);
      return i + 1;
    }
  return 0;
}

}  // extern "C"
