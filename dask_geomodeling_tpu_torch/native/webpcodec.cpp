// The port's lossless WebP (VP8L) codec: a decoder that follows the WebP
// lossless bitstream (RFC 9649) and libwebp 1.6.0's checks as Pillow drives
// it (its WebPAnimDecoder over WebPDemux, RGBA output, the alpha flag of
// the container deciding RGB or RGBA), and an encoder of its own.  Each
// step names the libwebp routine it follows.
//
// Built with g++ -O3 -shared -fPIC -std=c++17 at first use
// (ops/_build.py) and called through ctypes, which releases the GIL: the
// chunks of one image decode on the codec's thread pool.  No state is kept
// between calls.
//
// Decoding:
//   webp_decode(src, n, out, capacity, info, message, message_size)
//   info[0..2] = width, height, channels of the image (3: RGB, 4: RGBA);
//   info[3], when 1 to 3 on entry, writes only that many leading channels
//   (a one-sample GeoTIFF keeps band 0), else every channel.  With ``out``
//   NULL, or ``capacity`` below width * height * the channels written,
//   only the container and the VP8L header are read and WEBP_NEED_SPACE is
//   returned with ``info`` filled in.  Returns 0, or WEBP_CORRUPT (where
//   libwebp's demuxer or decoder fails, so Pillow raises OSError),
//   WEBP_UNSUPPORTED (a lossy "VP8 " image, an "ALPH" chunk, an animation),
//   with a message.
//
// Encoding:
//   webp_encode(pixels, width, height, channels, out, capacity)
//   channels 1 (gray, written as ARGB with R = G = B as libwebp imports an
//   L image Pillow converted to RGB), 3 (RGB) or 4 (RGBA); the alpha hint
//   is set only where some alpha is not 255.  The stream: subtract-green,
//   a predictor transform whose mode is chosen per 16 x 16 block by the
//   entropy of its residuals, LZ77 over a hash chain, one prefix-code group
//   of canonical codes limited to 15 bits, written with the 16/17/18 run
//   codes.  Lossless, but not libwebp's bytes (its cost model and
//   histogram clustering are not copied).  Returns the bytes written, -1
//   when ``capacity`` is too small, -2 for a shape it cannot write.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <queue>
#include <string>
#include <vector>

namespace {

enum { WEBP_OK = 0, WEBP_CORRUPT = -1, WEBP_UNSUPPORTED = -2, WEBP_NEED_SPACE = -3 };

struct WebpError {
  int code;
  std::string message;
};

[[noreturn]] void corrupt(const std::string &message) { throw WebpError{WEBP_CORRUPT, message}; }
[[noreturn]] void unsupported(const std::string &message) {
  throw WebpError{WEBP_UNSUPPORTED, message};
}

inline uint32_t le32(const uint8_t *p) {
  return (uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 | (uint32_t)p[3] << 24;
}
inline uint32_t le24(const uint8_t *p) {
  return (uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16;
}
inline bool tag_is(const uint8_t *p, const char *tag) { return std::memcmp(p, tag, 4) == 0; }

// --- the container: demux.c (ReadHeader, ParseVP8X, ParseVP8XChunks,
// ParseSingleImage, StoreFrame, IsValidSimpleFormat/IsValidExtendedFormat)
// and webp_dec.c (ParseVP8Header, VP8GetInfo, VP8LGetInfo) ---

const uint32_t kMaxChunkPayload = ~0u - 8 - 1;  // MAX_CHUNK_PAYLOAD
const int kAlphaFlag = 0x10, kAnimationFlag = 0x02, kAllValidFlags = 0x3e;

struct Frame {
  const uint8_t *payload = nullptr;  // the VP8L bitstream, its padding included
  size_t payload_size = 0;
  int width = 0, height = 0;
  bool has_alpha = false;  // Pillow's RGBA
};

// vp8_dec.c: VP8GetInfo, the checks a lossy frame header passes before the
// demuxer accepts it
bool vp8_header_ok(const uint8_t *data, size_t size, size_t chunk_size) {
  if (size < 10) return false;
  if (!(data[3] == 0x9d && data[4] == 0x01 && data[5] == 0x2a)) return false;
  const uint32_t bits = data[0] | data[1] << 8 | data[2] << 16;
  const int w = ((data[7] << 8) | data[6]) & 0x3fff;
  const int h = ((data[9] << 8) | data[8]) & 0x3fff;
  if (bits & 1) return false;  // not a key frame
  if (((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) || (bits >> 5) >= chunk_size) return false;
  return w != 0 && h != 0;
}

struct Container {
  const uint8_t *buf;
  size_t end;        // the bytes readable: the buffer, cut at the RIFF's end
  size_t riff_end;
  size_t start = 12;
  bool is_ext = false;
  int flags = 0;
  int canvas_w = 0, canvas_h = 0;
  bool have_frame = false;
  bool frame_complete = false;
  bool lossy = false;
  bool alph = false;
  size_t image_offset = 0, image_size = 0, alpha_offset = 0, alpha_size = 0;
  Frame frame;

  size_t available() const { return end - start; }
  bool size_invalid(size_t size) const { return size > riff_end - start; }

  // StoreFrame: the image chunk (and an ALPH chunk before it) of one frame;
  // returns false where libwebp returns PARSE_ERROR or PARSE_NEED_MORE_DATA
  // (the same failure for a whole file)
  bool store_frame() {
    int alpha_chunks = 0, image_chunks = 0;
    if (available() < 8) return false;
    bool done = false;
    do {
      const size_t chunk_start = start;
      const uint8_t *head = buf + start;
      const uint32_t payload_size = le32(head + 4);
      start += 8;
      if (payload_size > kMaxChunkPayload) return false;
      const size_t padded = (size_t)payload_size + (payload_size & 1);
      if (size_invalid(padded)) return false;
      if (padded > available()) return false;  // PARSE_NEED_MORE_DATA
      const size_t chunk_size = 8 + padded;
      if (tag_is(head, "ALPH") && alpha_chunks == 0) {
        ++alpha_chunks;
        alpha_offset = chunk_start;
        alpha_size = chunk_size;
        alph = true;
        start += padded;
      } else if ((tag_is(head, "VP8L") || tag_is(head, "VP8 ")) && image_chunks == 0) {
        const bool is_vp8l = tag_is(head, "VP8L");
        if (is_vp8l && alpha_chunks > 0) return false;  // VP8L has its own alpha
        // WebPGetFeatures over the chunk: ParseVP8Header, then VP8LGetInfo
        // or VP8GetInfo
        const uint8_t *data = head + 8;
        const size_t data_size = padded;
        if (is_vp8l) {
          if (data_size < 5) return false;
          if (!(data[0] == 0x2f && (data[4] >> 5) == 0)) return false;
          const uint32_t bits = le32(data + 1);
          frame.width = (int)(bits & 0x3fff) + 1;
          frame.height = (int)((bits >> 14) & 0x3fff) + 1;
          frame.has_alpha = (bits >> 28) & 1;
        } else {
          if (data_size < 10 || !vp8_header_ok(data, data_size, payload_size)) return false;
          frame.width = ((data[7] << 8) | data[6]) & 0x3fff;
          frame.height = ((data[9] << 8) | data[8]) & 0x3fff;
          frame.has_alpha = false;
          lossy = true;
        }
        if (alpha_chunks > 0) frame.has_alpha = true;
        ++image_chunks;
        image_offset = chunk_start;
        image_size = chunk_size;
        frame.payload = data;
        frame.payload_size = data_size;
        frame_complete = true;
        start += padded;
      } else {
        start -= 8;  // another chunk: the frame ends before it
        done = true;
      }
      if (start == riff_end) {
        done = true;
      } else if (available() < 8) {
        return false;
      }
    } while (!done);
    return true;
  }

  // ParseSingleImage
  bool single_image() {
    if (have_frame) return false;
    if (size_invalid(8) || available() < 8) return false;
    if (!store_frame()) return false;
    if (!(flags & kAlphaFlag) && alpha_size > 0) {  // alpha dropped without the flag
      alpha_size = 0;
      alpha_offset = 0;
      frame.has_alpha = false;
    }
    if (!is_ext && frame.width > 0 && frame.height > 0) {
      canvas_w = frame.width;
      canvas_h = frame.height;
      if (frame.has_alpha) flags |= kAlphaFlag;
    }
    have_frame = true;
    return true;
  }

  // ParseVP8X and ParseVP8XChunks
  bool extended() {
    if (available() < 8) return false;
    is_ext = true;
    start += 4;
    uint32_t vp8x_size = le32(buf + start);
    start += 4;
    if (vp8x_size > kMaxChunkPayload || vp8x_size < 10) return false;
    vp8x_size += vp8x_size & 1;
    if (size_invalid(vp8x_size) || available() < vp8x_size) return false;
    flags = buf[start];
    canvas_w = 1 + (int)le24(buf + start + 4);
    canvas_h = 1 + (int)le24(buf + start + 7);
    if ((uint64_t)canvas_w * (uint64_t)canvas_h >= (1ull << 32)) return false;
    start += vp8x_size;
    if (size_invalid(8) || available() < 8) return false;
    if (flags & kAnimationFlag) {
      unsupported("an animated WebP (VP8X animation flag) is not ported");
    }
    do {
      const uint8_t *head = buf + start;
      const uint32_t chunk_size = le32(head + 4);
      start += 8;
      if (chunk_size > kMaxChunkPayload) return false;
      const size_t padded = (size_t)chunk_size + (chunk_size & 1);
      if (size_invalid(padded)) return false;
      if (tag_is(head, "VP8X")) return false;
      if (tag_is(head, "ALPH") || tag_is(head, "VP8 ") || tag_is(head, "VP8L")) {
        start -= 8;
        if (!single_image()) return false;
      } else if (tag_is(head, "ANIM") || tag_is(head, "ANMF")) {
        unsupported("an animated WebP (ANIM/ANMF chunks) is not ported");
      } else {
        // ICCP, EXIF, XMP and unknown chunks are skipped
        if (padded > available()) return false;
        start += padded;
      }
      if (start == riff_end) break;
      if (available() < 8) return false;
    } while (true);
    return true;
  }

  // IsValidSimpleFormat / IsValidExtendedFormat with CheckFrameBounds
  bool valid() const {
    if (canvas_w <= 0 || canvas_h <= 0 || !have_frame) return false;
    if (is_ext && (flags & ~kAllValidFlags)) return false;
    if (!frame_complete) return false;
    if (frame.width <= 0 || frame.height <= 0) return false;
    if (alpha_size > 0 && alpha_offset > image_offset) return false;
    if (is_ext && (frame.width != canvas_w || frame.height != canvas_h)) return false;
    return true;
  }
};

// The frame of a RIFF/WEBP file as WebPDemux gives it to the decoder, or
// an exception: WEBP_CORRUPT where WebPDemux returns NULL (Pillow: "could
// not create decoder object"; or, without the signature, Pillow cannot
// identify the file), WEBP_UNSUPPORTED for what the port does not decode.
Frame parse_container(const uint8_t *data, size_t size) {
  // WebPImagePlugin._accept: RIFF, WEBP and a known first chunk
  if (size < 16 || !tag_is(data, "RIFF") || !tag_is(data + 8, "WEBP") ||
      !(tag_is(data + 12, "VP8 ") || tag_is(data + 12, "VP8L") || tag_is(data + 12, "VP8X"))) {
    corrupt("cannot identify image file");
  }
  if (size < 20) corrupt("could not create decoder object (truncated header)");
  const uint32_t riff_size = le32(data + 4);
  if (riff_size < 8 || riff_size > kMaxChunkPayload) corrupt("could not create decoder object");
  Container c{data, size, (size_t)riff_size + 8};
  if (c.end > c.riff_end) c.end = c.riff_end;
  if (size < c.riff_end) corrupt("could not create decoder object (the file is truncated)");
  bool ok;
  if (tag_is(data + 12, "VP8X")) {
    ok = c.extended();
  } else {
    ok = c.single_image();
  }
  if (!ok || !c.valid()) corrupt("could not create decoder object");
  if (c.lossy) {
    unsupported(c.alph ? "a lossy WebP with an ALPH chunk (VP8 + ALPH) is not ported"
                       : "a lossy WebP (VP8) is not ported");
  }
  if (c.alph) unsupported("a WebP with an ALPH chunk is not ported");
  Frame frame = c.frame;
  frame.has_alpha = (c.flags & kAlphaFlag) != 0;
  return frame;
}

// --- the bit reader: bit_reader_utils.c (VP8LBitReader).  libwebp's end of
// stream: more bits consumed than the stream holds, or than the 64 of its
// first window for a stream under 8 bytes; past the end the bits read as
// zeros, and every decode that reaches it fails ---

struct BitReader {
  const uint8_t *data;
  size_t size;
  uint64_t pos = 0;
  uint64_t limit;
  bool eos = false;

  BitReader(const uint8_t *d, size_t n) : data(d), size(n) {
    limit = std::max<uint64_t>(8 * (uint64_t)n, 64);
  }
  // at least 57 bits from the current position
  inline uint64_t window() const {
    const size_t byte = (size_t)(pos >> 3);
    uint64_t v = 0;
    if (byte + 8 <= size) {
      std::memcpy(&v, data + byte, 8);
    } else {
      for (size_t i = byte; i < size && i < byte + 8; ++i) v |= (uint64_t)data[i] << (8 * (i - byte));
    }
    return v >> (pos & 7);
  }
  inline void skip(int n) {
    pos += (uint64_t)n;
    if (pos > limit) eos = true;
  }
  inline uint32_t read(int n) {
    if (n == 0) return 0;
    const uint32_t v = (uint32_t)(window() & ((1ull << n) - 1));
    skip(n);
    return v;
  }
};

// --- prefix codes: huffman_utils.c (BuildHuffmanTable) ---

struct HCode {
  uint8_t bits;
  uint16_t value;
};

const int kRootBits = 8;  // HUFFMAN_TABLE_BITS
const int kMaxCodeLength = 15;

inline uint32_t next_key(uint32_t key, int len) {
  uint32_t step = 1u << (len - 1);
  while (key & step) step >>= 1;
  return step ? (key & (step - 1)) + step : key;
}

inline void replicate(HCode *table, int step, int end, HCode code) {
  do {
    end -= step;
    table[end] = code;
  } while (end > 0);
}

inline int next_table_bits(const int *count, int len, int root_bits) {
  int left = 1 << (len - root_bits);
  while (len < kMaxCodeLength) {
    left -= count[len];
    if (left <= 0) break;
    ++len;
    left <<= 1;
  }
  return len - root_bits;
}

// Builds the two-level lookup table of the code with ``lengths`` into
// ``out`` (appended); returns its size, 0 when the lengths are no valid code
// (all zero, over-subscribed, or not complete unless one symbol is coded).
int build_table(std::vector<HCode> &out, int root_bits, const int *lengths, int n) {
  int count[kMaxCodeLength + 1] = {0};
  int offset[kMaxCodeLength + 1];
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > kMaxCodeLength) return 0;
    ++count[lengths[s]];
  }
  if (count[0] == n) return 0;
  offset[1] = 0;
  for (int len = 1; len < kMaxCodeLength; ++len) {
    if (count[len] > (1 << len)) return 0;
    offset[len + 1] = offset[len] + count[len];
  }
  thread_local std::vector<uint16_t> sorted;
  sorted.resize(n);
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > 0) sorted[offset[lengths[s]]++] = (uint16_t)s;
  }
  const size_t base = out.size();
  int total_size = 1 << root_bits;
  if (offset[kMaxCodeLength] == 1) {  // one symbol: it reads no bits
    out.resize(base + total_size, HCode{0, sorted[0]});
    return total_size;
  }
  // room for the largest table: the root and a second-level table for
  // every root entry; a complete code writes every entry it uses, so the
  // room is never cleared
  thread_local std::vector<HCode> scratch;
  const size_t room = (size_t)total_size + ((size_t)1 << root_bits) * (1 << (kMaxCodeLength - root_bits));
  if (scratch.size() < room) scratch.resize(room);
  HCode *root = scratch.data();
  HCode *table = root;
  uint32_t key = 0;
  int num_nodes = 1, num_open = 1;
  int table_bits = root_bits, table_size = 1 << table_bits;
  int symbol = 0;
  int len, step;
  for (len = 1, step = 2; len <= root_bits; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return 0;
    for (; count[len] > 0; --count[len]) {
      replicate(&table[key], step, table_size, HCode{(uint8_t)len, sorted[symbol++]});
      key = next_key(key, len);
    }
  }
  const uint32_t mask = total_size - 1;
  uint32_t low = 0xffffffffu;
  for (len = root_bits + 1, step = 2; len <= kMaxCodeLength; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return 0;
    for (; count[len] > 0; --count[len]) {
      if ((key & mask) != low) {
        table += table_size;
        table_bits = next_table_bits(count, len, root_bits);
        table_size = 1 << table_bits;
        total_size += table_size;
        low = key & mask;
        root[low].bits = (uint8_t)(table_bits + root_bits);
        root[low].value = (uint16_t)((table - root) - low);
      }
      replicate(&table[key >> root_bits], step, table_size,
                HCode{(uint8_t)(len - root_bits), sorted[symbol++]});
      key = next_key(key, len);
    }
  }
  if (num_nodes != 2 * offset[kMaxCodeLength] - 1) return 0;  // the tree is not full
  out.insert(out.end(), scratch.begin(), scratch.begin() + total_size);
  return total_size;
}

// vp8l_dec.c: ReadSymbol
inline int read_symbol(const HCode *table, BitReader &br) {
  uint64_t val = br.window();
  table += val & ((1u << kRootBits) - 1);
  const int nbits = table->bits - kRootBits;
  if (nbits > 0) {
    br.skip(kRootBits);
    val >>= kRootBits;
    table += table->value;
    table += val & ((1u << nbits) - 1);
  }
  br.skip(table->bits);
  return table->value;
}

// --- the lossless decoder: vp8l_dec.c ---

const int kCodeLengthCodes = 19;
const uint8_t kCodeLengthCodeOrder[kCodeLengthCodes] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                                        7,  8,  9, 10, 11, 12, 13, 14, 15};
const int kAlphabetSize[5] = {256 + 24, 256, 256, 256, 40};
const int kLengthsTableBits = 7;
const int kMaxCacheBits = 11;

// RFC 9649's distance map: the (dx, dy) neighbour of each plane code
// below 121, at distance dx + dy * xsize (libwebp's kCodeToPlane)
const int8_t kPlaneOffsets[120][2] = {
    {0, 1}, {1, 0}, {1, 1}, {-1, 1}, {0, 2}, {2, 0}, {1, 2}, {-1, 2},
    {2, 1}, {-2, 1}, {2, 2}, {-2, 2}, {0, 3}, {3, 0}, {1, 3}, {-1, 3},
    {3, 1}, {-3, 1}, {2, 3}, {-2, 3}, {3, 2}, {-3, 2}, {0, 4}, {4, 0},
    {1, 4}, {-1, 4}, {4, 1}, {-4, 1}, {3, 3}, {-3, 3}, {2, 4}, {-2, 4},
    {4, 2}, {-4, 2}, {0, 5}, {3, 4}, {-3, 4}, {4, 3}, {-4, 3}, {5, 0},
    {1, 5}, {-1, 5}, {5, 1}, {-5, 1}, {2, 5}, {-2, 5}, {5, 2}, {-5, 2},
    {4, 4}, {-4, 4}, {3, 5}, {-3, 5}, {5, 3}, {-5, 3}, {0, 6}, {6, 0},
    {1, 6}, {-1, 6}, {6, 1}, {-6, 1}, {2, 6}, {-2, 6}, {6, 2}, {-6, 2},
    {4, 5}, {-4, 5}, {5, 4}, {-5, 4}, {3, 6}, {-3, 6}, {6, 3}, {-6, 3},
    {0, 7}, {7, 0}, {1, 7}, {-1, 7}, {5, 5}, {-5, 5}, {7, 1}, {-7, 1},
    {4, 6}, {-4, 6}, {6, 4}, {-6, 4}, {2, 7}, {-2, 7}, {7, 2}, {-7, 2},
    {3, 7}, {-3, 7}, {7, 3}, {-7, 3}, {5, 6}, {-5, 6}, {6, 5}, {-6, 5},
    {8, 0}, {4, 7}, {-4, 7}, {7, 4}, {-7, 4}, {8, 1}, {8, 2}, {6, 6},
    {-6, 6}, {8, 3}, {5, 7}, {-5, 7}, {7, 5}, {-7, 5}, {8, 4}, {6, 7},
    {-6, 7}, {7, 6}, {-7, 6}, {8, 5}, {7, 7}, {-7, 7}, {8, 6}, {8, 7},
};

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

inline int plane_code_to_distance(int xsize, int plane_code) {
  if (plane_code > 120) return plane_code - 120;
  const int dist = kPlaneOffsets[plane_code - 1][1] * xsize + kPlaneOffsets[plane_code - 1][0];
  return dist >= 1 ? dist : 1;
}

// GetCopyDistance and GetCopyLength
inline int copy_value(int symbol, BitReader &br) {
  if (symbol < 4) return symbol + 1;
  const int extra_bits = (symbol - 2) >> 1;
  const int offset = (2 + (symbol & 1)) << extra_bits;
  return offset + (int)br.read(extra_bits) + 1;
}

struct Group {
  const HCode *codes[5];
  // red, blue and alpha codes of one symbol each (they read no bits): a
  // literal is its green symbol over these (libwebp's is_trivial_literal)
  bool trivial = false;
  uint32_t literal_arb = 0;
};

enum { PREDICTOR = 0, CROSS_COLOR = 1, SUBTRACT_GREEN = 2, COLOR_INDEXING = 3 };

struct Transform {
  int type = 0;
  int bits = 0;
  int xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

struct Decoder {
  BitReader br;
  std::vector<Transform> transforms;
  unsigned seen = 0;

  explicit Decoder(const uint8_t *data, size_t size) : br(data, size) {}

  // ReadHuffmanCodeLengths
  void read_code_lengths(const int *cl_lengths, int num_symbols, int *lengths) {
    std::vector<HCode> table;
    if (!build_table(table, kLengthsTableBits, cl_lengths, kCodeLengthCodes)) {
      corrupt("a code-length code is no prefix code");
    }
    int max_symbol;
    if (br.read(1)) {
      const int length_nbits = 2 + 2 * (int)br.read(3);
      max_symbol = 2 + (int)br.read(length_nbits);
      if (max_symbol > num_symbols) corrupt("max_symbol past the alphabet");
    } else {
      max_symbol = num_symbols;
    }
    int prev = 8;
    int symbol = 0;
    while (symbol < num_symbols) {
      if (max_symbol-- == 0) break;
      const uint64_t val = br.window();
      const HCode &p = table[val & ((1u << kLengthsTableBits) - 1)];
      br.skip(p.bits);
      const int code_len = p.value;
      if (code_len < 16) {
        lengths[symbol++] = code_len;
        if (code_len != 0) prev = code_len;
      } else {
        static const int kExtraBits[3] = {2, 3, 7};
        static const int kOffsets[3] = {3, 3, 11};
        const int slot = code_len - 16;
        int repeat = (int)br.read(kExtraBits[slot]) + kOffsets[slot];
        if (symbol + repeat > num_symbols) corrupt("a run of code lengths past the alphabet");
        const int length = code_len == 16 ? prev : 0;
        while (repeat-- > 0) lengths[symbol++] = length;
      }
    }
  }

  // ReadHuffmanCode; the code's table is appended to ``tables`` (an unused
  // group's is built and dropped); returns its start
  size_t read_code(int alphabet_size, std::vector<HCode> &tables, std::vector<int> &lengths) {
    lengths.assign(std::max(alphabet_size, 256), 0);
    if (br.read(1)) {  // simple code: one or two symbols
      const int num_symbols = (int)br.read(1) + 1;
      const int first_bits = br.read(1) == 0 ? 1 : 8;
      lengths[br.read(first_bits)] = 1;
      if (num_symbols == 2) lengths[br.read(8)] = 1;
    } else {
      int cl_lengths[kCodeLengthCodes] = {0};
      const int num_codes = (int)br.read(4) + 4;
      for (int i = 0; i < num_codes; ++i) cl_lengths[kCodeLengthCodeOrder[i]] = (int)br.read(3);
      read_code_lengths(cl_lengths, alphabet_size, lengths.data());
    }
    if (br.eos) corrupt("the stream ends in a prefix code");
    const size_t start = tables.size();
    if (!build_table(tables, kRootBits, lengths.data(), alphabet_size)) {
      corrupt("code lengths that are no prefix code");
    }
    return start;
  }

  // DecodeImageStream: the (xsize, ysize) image of a level (the main image
  // with its transforms, or a sub-image), its pixels entropy-decoded; for
  // the main image ``xsize`` comes back as the width after its transforms
  std::unique_ptr<uint32_t[]> image_stream(int &xsize, int ysize, bool level0) {
    if (level0) {
      while (br.read(1)) read_transform(xsize, ysize);
    }
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = (int)br.read(4);
      if (cache_bits < 1 || cache_bits > kMaxCacheBits) corrupt("a colour cache size out of range");
    }
    // ReadHuffmanCodes
    int huffman_bits = 0, huffman_xsize = 0;
    std::unique_ptr<uint32_t[]> huffman_image;
    int num_groups = 1;
    if (level0 && br.read(1)) {
      huffman_bits = 2 + (int)br.read(3);
      huffman_xsize = subsample(xsize, huffman_bits);
      int huffman_ysize = subsample(ysize, huffman_bits);
      int sub_xsize = huffman_xsize;
      huffman_image = image_stream(sub_xsize, huffman_ysize, false);
      const size_t n = (size_t)huffman_xsize * huffman_ysize;
      for (size_t i = 0; i < n; ++i) {
        const uint32_t group = (huffman_image[i] >> 8) & 0xffff;
        huffman_image[i] = group;
        if ((int)group >= num_groups) num_groups = (int)group + 1;
      }
    }
    if (br.eos) corrupt("the stream ends before its prefix codes");
    std::vector<char> used(num_groups, huffman_image ? 0 : 1);
    if (huffman_image) {
      const size_t n = (size_t)huffman_xsize * subsample(ysize, huffman_bits);
      for (size_t i = 0; i < n; ++i) used[huffman_image[i]] = 1;
    }
    std::vector<HCode> tables;
    std::vector<int> lengths;
    std::vector<size_t> starts((size_t)num_groups * 5, 0);
    std::vector<HCode> dropped;
    for (int g = 0; g < num_groups; ++g) {
      for (int j = 0; j < 5; ++j) {
        int alphabet = kAlphabetSize[j];
        if (j == 0 && cache_bits > 0) alphabet += 1 << cache_bits;
        if (used[g]) {
          starts[(size_t)g * 5 + j] = read_code(alphabet, tables, lengths);
        } else {
          dropped.clear();
          read_code(alphabet, dropped, lengths);
        }
      }
    }
    std::vector<Group> groups(num_groups);
    for (int g = 0; g < num_groups; ++g) {
      for (int j = 0; j < 5; ++j) groups[g].codes[j] = tables.data() + starts[(size_t)g * 5 + j];
      const HCode *const *c = groups[g].codes;
      groups[g].trivial = c[1][0].bits == 0 && c[2][0].bits == 0 && c[3][0].bits == 0;
      groups[g].literal_arb = (uint32_t)c[3][0].value << 24 | (uint32_t)c[1][0].value << 16 |
                              (uint32_t)c[2][0].value;
    }
    const size_t total = (size_t)xsize * ysize;
    std::unique_ptr<uint32_t[]> pixels(new uint32_t[total]);
    decode_pixels(pixels.get(), xsize, ysize, groups, huffman_image.get(), huffman_bits,
                  huffman_xsize, cache_bits);
    return pixels;
  }

  // ReadTransform
  void read_transform(int &xsize, int ysize) {
    const int type = (int)br.read(2);
    if (seen & (1u << type)) corrupt("a transform appears twice");
    seen |= 1u << type;
    Transform t;
    t.type = type;
    t.xsize = xsize;
    t.ysize = ysize;
    if (type == PREDICTOR || type == CROSS_COLOR) {
      t.bits = 2 + (int)br.read(3);
      int sub_x = subsample(t.xsize, t.bits);
      const int sub_y = subsample(t.ysize, t.bits);
      auto data = image_stream(sub_x, sub_y, false);
      t.data.assign(data.get(), data.get() + (size_t)sub_x * sub_y);
    } else if (type == COLOR_INDEXING) {
      const int num_colors = (int)br.read(8) + 1;
      const int bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
      xsize = subsample(t.xsize, bits);
      t.bits = bits;
      int palette_x = num_colors;
      auto data = image_stream(palette_x, 1, false);
      // ExpandColorMap: the entries are delta-coded; an index past them
      // reads as 0x00000000
      const int final_colors = 1 << (8 >> bits);
      t.data.assign(final_colors, 0);
      uint8_t *out = reinterpret_cast<uint8_t *>(t.data.data());
      const uint8_t *in = reinterpret_cast<const uint8_t *>(data.get());
      t.data[0] = data[0];
      for (int i = 4; i < 4 * num_colors; ++i) out[i] = (uint8_t)((in[i] + out[i - 4]) & 0xff);
    }
    transforms.push_back(std::move(t));
  }

  // DecodeImageData
  void decode_pixels(uint32_t *data, int width, int height, const std::vector<Group> &groups,
                     const uint32_t *huffman_image, int huffman_bits, int huffman_xsize,
                     int cache_bits) {
    const size_t total = (size_t)width * height;
    const int mask = huffman_bits == 0 ? ~0 : (1 << huffman_bits) - 1;
    std::vector<uint32_t> cache(cache_bits > 0 ? (size_t)1 << cache_bits : 0, 0);
    const int cache_shift = 32 - cache_bits;
    const int cache_limit = 280 + (cache_bits > 0 ? 1 << cache_bits : 0);
    size_t pos = 0, last_cached = 0;
    int col = 0, row = 0;
    auto group_at = [&](int x, int y) -> const Group * {
      if (!huffman_image) return &groups[0];
      return &groups[huffman_image[(size_t)huffman_xsize * (y >> huffman_bits) + (x >> huffman_bits)]];
    };
    auto flush_cache = [&]() {
      if (cache_bits > 0) {
        while (last_cached < pos) {
          const uint32_t argb = data[last_cached++];
          cache[(0x1e35a7bdu * argb) >> cache_shift] = argb;
        }
      }
    };
    const Group *g = total ? group_at(0, 0) : nullptr;
    while (pos < total) {
      if ((col & mask) == 0) g = group_at(col, row);
      const int code = read_symbol(g->codes[0], br);
      if (br.eos) break;
      if (code < 256 && g->trivial) {
        data[pos] = g->literal_arb | (uint32_t)code << 8;
      } else if (code < 256) {
        const int red = read_symbol(g->codes[1], br);
        const int blue = read_symbol(g->codes[2], br);
        const int alpha = read_symbol(g->codes[3], br);
        if (br.eos) break;
        data[pos] = (uint32_t)alpha << 24 | (uint32_t)red << 16 | (uint32_t)code << 8 | (uint32_t)blue;
      } else if (code < 280) {
        const int length = copy_value(code - 256, br);
        const int dist_symbol = read_symbol(g->codes[4], br);
        const int dist_code = copy_value(dist_symbol, br);
        const size_t dist = (size_t)plane_code_to_distance(width, dist_code);
        if (br.eos) break;
        if (pos < dist || total - pos < (size_t)length) corrupt("a copy reaches outside the image");
        uint32_t *dst = data + pos;
        const uint32_t *src = dst - dist;
        for (int k = 0; k < length; ++k) dst[k] = src[k];
        pos += length;
        col += length;
        while (col >= width) {
          col -= width;
          ++row;
        }
        if (col & mask) g = group_at(col, row);
        flush_cache();
        continue;
      } else if (code < cache_limit) {
        flush_cache();
        data[pos] = cache[code - 280];
      } else {
        corrupt("a symbol past the alphabet");
      }
      ++pos;
      if (++col >= width) {
        col = 0;
        ++row;
        flush_cache();
      }
    }
    if (br.eos) corrupt("the image data is truncated");
  }
};

// --- the inverse transforms: lossless.c ---

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t sub_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = 0x00ff00ffu + (a & 0xff00ff00u) - (b & 0xff00ff00u);
  const uint32_t rb = 0xff00ff00u + (a & 0x00ff00ffu) - (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }
inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }
inline int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }
inline uint32_t select(uint32_t a, uint32_t b, uint32_t c) {
  const int d = sub3(a >> 24, b >> 24, c >> 24) + sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) + sub3(a & 0xff, b & 0xff, c & 0xff);
  return d <= 0 ? a : b;
}
inline uint32_t clamped_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t a = clip255((uint32_t)((int)(c0 >> 24) + (int)(c1 >> 24) - (int)(c2 >> 24)));
  const uint32_t r = clip255((uint32_t)((int)((c0 >> 16) & 0xff) + (int)((c1 >> 16) & 0xff) - (int)((c2 >> 16) & 0xff)));
  const uint32_t g = clip255((uint32_t)((int)((c0 >> 8) & 0xff) + (int)((c1 >> 8) & 0xff) - (int)((c2 >> 8) & 0xff)));
  const uint32_t b = clip255((uint32_t)((int)(c0 & 0xff) + (int)(c1 & 0xff) - (int)(c2 & 0xff)));
  return a << 24 | r << 16 | g << 8 | b;
}
inline int half_component(int a, int b) { return (int)clip255((uint32_t)(a + (a - b) / 2)); }
inline uint32_t clamped_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  const int a = half_component(ave >> 24, c2 >> 24);
  const int r = half_component((ave >> 16) & 0xff, (c2 >> 16) & 0xff);
  const int g = half_component((ave >> 8) & 0xff, (c2 >> 8) & 0xff);
  const int b = half_component(ave & 0xff, c2 & 0xff);
  return (uint32_t)a << 24 | (uint32_t)r << 16 | (uint32_t)g << 8 | (uint32_t)b;
}

// VP8LPredictors[mode](left, upper + x): upper[0] is T, upper[-1] TL,
// upper[1] TR; modes 14 and 15 predict black, as libwebp's table does
inline uint32_t predict(int mode, uint32_t left, const uint32_t *top) {
  switch (mode) {
    case 1: return left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(left, top[1]), top[0]);
    case 6: return average2(left, top[-1]);
    case 7: return average2(left, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(left, top[-1]), average2(top[0], top[1]));
    case 11: return select(top[0], left, top[-1]);
    case 12: return clamped_full(left, top[0], top[-1]);
    case 13: return clamped_half(left, top[0], top[-1]);
    default: return 0xff000000u;
  }
}

// VP8LPredictorsAdd[mode] over out[x0, x1) of a row whose upper row is
// ``upper``
template <int MODE>
void add_predicted(uint32_t *out, const uint32_t *upper, int x0, int x1) {
  for (int x = x0; x < x1; ++x) out[x] = add_pixels(out[x], predict(MODE, out[x - 1], upper + x));
}

typedef void (*AddRun)(uint32_t *, const uint32_t *, int, int);
const AddRun kAddRuns[16] = {
    add_predicted<0>,  add_predicted<1>,  add_predicted<2>,  add_predicted<3>,
    add_predicted<4>,  add_predicted<5>,  add_predicted<6>,  add_predicted<7>,
    add_predicted<8>,  add_predicted<9>,  add_predicted<10>, add_predicted<11>,
    add_predicted<12>, add_predicted<13>, add_predicted<0>,  add_predicted<0>};

// PredictorInverseTransform_C, in place over the whole image
void inverse_predictor(const Transform &t, uint32_t *px) {
  const int width = t.xsize;
  if (t.ysize == 0 || width == 0) return;
  px[0] = add_pixels(px[0], 0xff000000u);
  for (int x = 1; x < width; ++x) px[x] = add_pixels(px[x], px[x - 1]);
  const int tiles_per_row = subsample(width, t.bits);
  const int tile = 1 << t.bits;
  for (int y = 1; y < t.ysize; ++y) {
    uint32_t *out = px + (size_t)y * width;
    const uint32_t *upper = out - width;
    const uint32_t *modes = t.data.data() + (size_t)(y >> t.bits) * tiles_per_row;
    out[0] = add_pixels(out[0], upper[0]);
    for (int x = 1; x < width;) {
      const int x_end = std::min(width, (x & ~(tile - 1)) + tile);
      kAddRuns[(modes[x >> t.bits] >> 8) & 0xf](out, upper, x, x_end);
      x = x_end;
    }
  }
}

inline int color_delta(int8_t pred, int8_t color) { return ((int)pred * color) >> 5; }

// ColorSpaceInverseTransform_C
void inverse_cross_color(const Transform &t, uint32_t *px) {
  const int width = t.xsize;
  const int tiles_per_row = subsample(width, t.bits);
  for (int y = 0; y < t.ysize; ++y) {
    uint32_t *row = px + (size_t)y * width;
    const uint32_t *codes = t.data.data() + (size_t)(y >> t.bits) * tiles_per_row;
    for (int x = 0; x < width; ++x) {
      const uint32_t code = codes[x >> t.bits];
      const int8_t green_to_red = (int8_t)(code & 0xff);
      const int8_t green_to_blue = (int8_t)((code >> 8) & 0xff);
      const int8_t red_to_blue = (int8_t)((code >> 16) & 0xff);
      const uint32_t argb = row[x];
      const int8_t green = (int8_t)(argb >> 8);
      int new_red = (argb >> 16) & 0xff;
      int new_blue = argb & 0xff;
      new_red += color_delta(green_to_red, green);
      new_red &= 0xff;
      new_blue += color_delta(green_to_blue, green);
      new_blue += color_delta(red_to_blue, (int8_t)new_red);
      new_blue &= 0xff;
      row[x] = (argb & 0xff00ff00u) | (uint32_t)new_red << 16 | (uint32_t)new_blue;
    }
  }
}

// VP8LAddGreenToBlueAndRed_C
void inverse_subtract_green(size_t n, uint32_t *px) {
  for (size_t i = 0; i < n; ++i) {
    const uint32_t argb = px[i];
    const uint32_t green = (argb >> 8) & 0xff;
    uint32_t red_blue = argb & 0x00ff00ffu;
    red_blue += (green << 16) | green;
    px[i] = (argb & 0xff00ff00u) | (red_blue & 0x00ff00ffu);
  }
}

// ColorIndexInverseTransform_C: (packed width x ysize) indices in green to
// (xsize x ysize) colours
std::unique_ptr<uint32_t[]> inverse_color_indexing(const Transform &t, const uint32_t *src) {
  const int width = t.xsize;
  std::unique_ptr<uint32_t[]> out(new uint32_t[(size_t)width * t.ysize]);
  uint32_t *dst = out.get();
  const uint32_t *map = t.data.data();
  if (t.bits == 0) {
    const size_t n = (size_t)width * t.ysize;
    for (size_t i = 0; i < n; ++i) dst[i] = map[(src[i] >> 8) & 0xff];
    return out;
  }
  const int bits_per_pixel = 8 >> t.bits;
  const int count_mask = (1 << t.bits) - 1;
  const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
  for (int y = 0; y < t.ysize; ++y) {
    uint32_t packed = 0;
    for (int x = 0; x < width; ++x) {
      if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
      *dst++ = map[packed & bit_mask];
      packed >>= bits_per_pixel;
    }
  }
  return out;
}

// The whole decode: ARGB pixels of the frame's (width x height)
std::unique_ptr<uint32_t[]> decode_vp8l(const Frame &frame) {
  Decoder dec(frame.payload, frame.payload_size);
  // ReadImageInfo
  if (dec.br.read(8) != 0x2f) corrupt("not a VP8L stream");
  const int width = (int)dec.br.read(14) + 1;
  const int height = (int)dec.br.read(14) + 1;
  dec.br.read(1);
  if (dec.br.read(3) != 0) corrupt("an unknown VP8L version");
  if (dec.br.eos) corrupt("the VP8L header is truncated");
  int xsize = width;
  std::unique_ptr<uint32_t[]> px = dec.image_stream(xsize, height, true);
  for (size_t k = dec.transforms.size(); k-- > 0;) {
    const Transform &t = dec.transforms[k];
    switch (t.type) {
      case PREDICTOR: inverse_predictor(t, px.get()); break;
      case CROSS_COLOR: inverse_cross_color(t, px.get()); break;
      case SUBTRACT_GREEN: inverse_subtract_green((size_t)t.xsize * t.ysize, px.get()); break;
      case COLOR_INDEXING: px = inverse_color_indexing(t, px.get()); break;
    }
  }
  return px;
}

// --- the encoder ---

struct BitWriter {
  std::vector<uint8_t> bytes;
  BitWriter() { bytes.reserve(1 << 16); }
  uint64_t acc = 0;
  int nbits = 0;
  inline void put(uint32_t value, int n) {
    acc |= (uint64_t)value << nbits;
    nbits += n;
    while (nbits >= 8) {
      bytes.push_back((uint8_t)acc);
      acc >>= 8;
      nbits -= 8;
    }
  }
  void flush() {
    if (nbits > 0) bytes.push_back((uint8_t)acc);
    acc = 0;
    nbits = 0;
  }
};

// Code lengths of a Huffman code over ``freq`` limited to ``limit`` bits:
// the least frequencies raised to a doubling floor until the tree fits
// (huffman_encode_utils.c: GenerateOptimalTree's approach)
std::vector<uint8_t> huffman_lengths(const std::vector<uint32_t> &freq, int limit) {
  const int n = (int)freq.size();
  std::vector<uint8_t> lengths(n, 0);
  std::vector<int> symbols;
  for (int s = 0; s < n; ++s)
    if (freq[s]) symbols.push_back(s);
  if (symbols.empty()) return lengths;
  if (symbols.size() == 1) {
    lengths[symbols[0]] = 1;
    return lengths;
  }
  for (uint64_t floor = 1;; floor *= 2) {
    const int m = (int)symbols.size();
    std::vector<int> parent(2 * m, -1);
    typedef std::pair<uint64_t, int> Node;  // (weight, id): ties by id
    std::priority_queue<Node, std::vector<Node>, std::greater<Node>> heap;
    for (int i = 0; i < m; ++i) heap.push(Node(std::max<uint64_t>(freq[symbols[i]], floor), i));
    int next = m;
    while (heap.size() > 1) {
      const Node a = heap.top();
      heap.pop();
      const Node b = heap.top();
      heap.pop();
      parent[a.second] = next;
      parent[b.second] = next;
      heap.push(Node(a.first + b.first, next++));
    }
    int deepest = 0;
    std::vector<int> depth(next, 0);
    for (int i = next - 2; i >= 0; --i) depth[i] = depth[parent[i]] + 1;
    for (int i = 0; i < m; ++i) deepest = std::max(deepest, depth[i]);
    if (deepest <= limit) {
      for (int i = 0; i < m; ++i) lengths[symbols[i]] = (uint8_t)depth[i];
      return lengths;
    }
  }
}

struct Code {
  std::vector<uint8_t> lengths;
  std::vector<uint16_t> codes;  // bit-reversed canonical codes
  bool silent = false;          // one symbol: it reads no bits
  inline void write(BitWriter &bw, int symbol) const {
    if (!silent) bw.put(codes[symbol], lengths[symbol]);
  }
};

// canonical codes (the order of build_table's keys), reversed for the
// LSB-first writer
void assign_codes(Code &code) {
  const int n = (int)code.lengths.size();
  code.codes.assign(n, 0);
  int count[kMaxCodeLength + 1] = {0};
  int coded = 0;
  for (int s = 0; s < n; ++s) {
    if (code.lengths[s]) {
      ++count[code.lengths[s]];
      ++coded;
    }
  }
  code.silent = coded <= 1;
  uint32_t next[kMaxCodeLength + 2] = {0};
  uint32_t value = 0;
  for (int len = 1; len <= kMaxCodeLength; ++len) {
    value = (value + count[len - 1]) << 1;
    next[len] = value;
  }
  for (int s = 0; s < n; ++s) {
    const int len = code.lengths[s];
    if (!len) continue;
    uint32_t c = next[len]++;
    uint32_t reversed = 0;
    for (int i = 0; i < len; ++i) {
      reversed = (reversed << 1) | (c & 1);
      c >>= 1;
    }
    code.codes[s] = (uint16_t)reversed;
  }
}

// Writes the code of the frequencies ``freq`` (a simple code for up to two
// symbols below 256, else code lengths run-length coded with 16/17/18) and
// returns it
Code write_code(BitWriter &bw, const std::vector<uint32_t> &freq) {
  Code code;
  code.lengths = huffman_lengths(freq, kMaxCodeLength);
  std::vector<int> coded;
  for (int s = 0; s < (int)freq.size(); ++s)
    if (code.lengths[s]) coded.push_back(s);
  if (coded.empty()) {  // nothing coded: a simple code of symbol 0
    bw.put(1, 1);
    bw.put(0, 1);
    bw.put(0, 1);
    bw.put(0, 1);
    code.lengths[0] = 1;
    assign_codes(code);
    return code;
  }
  if (coded.size() <= 2 && coded.back() < 256) {
    bw.put(1, 1);
    bw.put((uint32_t)coded.size() - 1, 1);
    if (coded[0] < 2) {
      bw.put(0, 1);
      bw.put(coded[0], 1);
    } else {
      bw.put(1, 1);
      bw.put(coded[0], 8);
    }
    if (coded.size() == 2) bw.put(coded[1], 8);
    for (int s : coded) code.lengths[s] = 1;
    assign_codes(code);
    return code;
  }
  assign_codes(code);
  // the run-length tokens: (symbol, extra bits value)
  std::vector<std::pair<int, int>> tokens;
  const int n = (int)code.lengths.size();
  int prev = 8;
  for (int i = 0; i < n;) {
    const int v = code.lengths[i];
    int run = 1;
    while (i + run < n && code.lengths[i + run] == v) ++run;
    i += run;
    if (v == 0) {
      while (run >= 11) {
        const int r = std::min(run, 138);
        tokens.push_back({18, r - 11});
        run -= r;
      }
      if (run >= 3) {
        tokens.push_back({17, run - 3});
        run = 0;
      }
      while (run-- > 0) tokens.push_back({0, 0});
    } else {
      if (v != prev) {
        tokens.push_back({v, 0});
        prev = v;
        --run;
      }
      while (run >= 3) {
        const int r = std::min(run, 6);
        tokens.push_back({16, r - 3});
        run -= r;
      }
      while (run-- > 0) tokens.push_back({v, 0});
    }
  }
  std::vector<uint32_t> token_freq(kCodeLengthCodes, 0);
  for (auto &t : tokens) ++token_freq[t.first];
  Code cl;
  cl.lengths = huffman_lengths(token_freq, 7);
  assign_codes(cl);
  int num_codes = kCodeLengthCodes;
  while (num_codes > 4 && cl.lengths[kCodeLengthCodeOrder[num_codes - 1]] == 0) --num_codes;
  bw.put(0, 1);
  bw.put((uint32_t)num_codes - 4, 4);
  for (int i = 0; i < num_codes; ++i) bw.put(cl.lengths[kCodeLengthCodeOrder[i]], 3);
  bw.put(0, 1);  // no max_symbol: every length is written
  static const int kExtraBits[3] = {2, 3, 7};
  for (auto &t : tokens) {
    cl.write(bw, t.first);
    if (t.first >= 16) bw.put((uint32_t)t.second, kExtraBits[t.first - 16]);
  }
  return code;
}

// VP8LPrefixEncode: the prefix symbol of a length or plane code, its extra
// bits and their value
inline void prefix_encode(int value, int &symbol, int &extra_bits, int &extra_value) {
  --value;
  if (value < 4) {
    symbol = value;
    extra_bits = 0;
    extra_value = 0;
    return;
  }
  int highest = 31 - __builtin_clz((unsigned)value);
  const int second = (value >> (highest - 1)) & 1;
  extra_bits = highest - 1;
  extra_value = value & ((1 << extra_bits) - 1);
  symbol = 2 * highest + second;
}

struct Token {
  uint32_t argb = 0;    // a literal
  int length = 0;       // 0: a literal, else a copy of ``length`` pixels
  int plane_code = 0;   // the copy's distance as a plane code
  uint32_t pos = 0;     // the pixel the token starts at
};

// LZ77 over a hash chain of three pixels: at each pixel the longest match
// at distance 1 (a run), one row up, or among the last kMaxChain positions
// of the same hash; a copy of 4 or more pixels (3 at a plane code of the
// 120 neighbours) is taken, else a literal
std::vector<Token> lz77_tokens(const uint32_t *px, int width, int height) {
  const size_t n = (size_t)width * height;
  std::vector<Token> tokens;
  tokens.reserve(n);
  const size_t near_limit = (size_t)8 * width + 8;
  std::vector<int> near_code(near_limit + 1, 0);
  for (int code = 120; code >= 1; --code) {
    const size_t d = (size_t)plane_code_to_distance(width, code);
    if (d <= near_limit) near_code[d] = code;
  }
  const int kHashBits = 16;
  const int kMaxChain = 4;
  const size_t kMaxLength = 4096;
  const size_t kMaxDistance = (1u << 20) - 120;
  std::vector<int32_t> head((size_t)1 << kHashBits, -1);
  std::vector<int32_t> chain(n, -1);
  auto hash = [&](size_t i) -> uint32_t {
    return (px[i] * 0x1e35a7bdu + px[i + 1] * 0x9e3779b1u + px[i + 2] * 0x85ebca6bu) >>
           (32 - kHashBits);
  };
  auto insert = [&](size_t i) {
    if (i + 2 < n) {
      const uint32_t h = hash(i);
      chain[i] = head[h];
      head[h] = (int32_t)i;
    }
  };
  auto match = [&](size_t i, size_t j, size_t limit) -> size_t {
    size_t len = 0;
    while (len < limit && px[i + len] == px[j + len]) ++len;
    return len;
  };
  for (size_t i = 0; i < n;) {
    const size_t limit = std::min(kMaxLength, n - i);
    size_t best_len = 0, best_dist = 0;
    for (size_t d : {(size_t)1, (size_t)width}) {
      if (d <= i) {
        const size_t len = match(i, i - d, limit);
        if (len > best_len) {
          best_len = len;
          best_dist = d;
        }
      }
    }
    if (i + 2 < n && best_len < 16) {
      int32_t j = head[hash(i)];
      for (int steps = 0; j >= 0 && steps < kMaxChain; ++steps, j = chain[j]) {
        const size_t d = i - (size_t)j;
        if (d > kMaxDistance) break;
        if (px[j + best_len] != px[i + best_len]) continue;
        const size_t len = match(i, (size_t)j, limit);
        if (len > best_len) {
          best_len = len;
          best_dist = d;
          if (len == limit) break;
        }
      }
    }
    const bool near = best_dist > 0 && best_dist <= near_limit && near_code[best_dist] > 0;
    Token t;
    t.pos = (uint32_t)i;
    if (best_len >= 4 || (best_len >= 3 && near)) {
      t.length = (int)best_len;
      t.plane_code = near ? near_code[best_dist] : (int)best_dist + 120;
      for (size_t k = 0; k < best_len; ++k) insert(i + k);
      i += best_len;
    } else {
      t.argb = px[i];
      insert(i);
      ++i;
    }
    tokens.push_back(t);
  }
  return tokens;
}

const int kAlphabetTotal = 280 + 256 + 256 + 256 + 40;
const int kAlphabetBase[5] = {0, 280, 536, 792, 1048};

// the symbols of a token, as (alphabet, symbol) pairs into a histogram of
// kAlphabetTotal bins
template <class F>
inline void token_symbols(const Token &t, F &&f) {
  if (t.length == 0) {
    f(0, (t.argb >> 8) & 0xff);
    f(1, (t.argb >> 16) & 0xff);
    f(2, t.argb & 0xff);
    f(3, t.argb >> 24);
  } else {
    int symbol, bits, value;
    prefix_encode(t.length, symbol, bits, value);
    f(0, 256 + symbol);
    prefix_encode(t.plane_code, symbol, bits, value);
    f(4, symbol);
  }
}

// the bits of a histogram's data under its own code, estimated as its
// entropy, plus about 4 bits of header a coded symbol
double histogram_bits(const uint32_t *h) {
  double bits = 0.0;
  for (int a = 0; a < 5; ++a) {
    const uint32_t *bins = h + kAlphabetBase[a];
    const int size = kAlphabetSize[a];
    uint64_t total = 0;
    int coded = 0;
    for (int s = 0; s < size; ++s) {
      total += bins[s];
      coded += bins[s] > 0;
    }
    if (coded > 1) {
      for (int s = 0; s < size; ++s)
        if (bins[s]) bits += bins[s] * std::log2((double)total / bins[s]);
    }
    bits += coded > 2 ? 4.0 * coded + 40.0 : 12.0;
  }
  return bits;
}

const int kMetaBits = 5;      // 32 x 32 blocks share a prefix-code group
const int kMaxGroups = 32;

// The prefix-code group of each block of the main image: k-means over the
// blocks' histograms (a block goes to the group whose code costs its
// symbols least; the groups start as quantiles of the blocks' commonest
// green symbol); empty where one group costs less
std::vector<uint32_t> cluster_blocks(const std::vector<Token> &tokens, int width, int height,
                                     int &num_groups) {
  const int bx = subsample(width, kMetaBits), by = subsample(height, kMetaBits);
  const int nb = bx * by;
  num_groups = 1;
  if (nb < 2) return {};
  std::vector<uint32_t> hist((size_t)nb * kAlphabetTotal, 0);
  for (const Token &t : tokens) {
    const int x = (int)(t.pos % (uint32_t)width), y = (int)(t.pos / (uint32_t)width);
    uint32_t *h = hist.data() + (size_t)((y >> kMetaBits) * bx + (x >> kMetaBits)) * kAlphabetTotal;
    token_symbols(t, [&](int a, int s) { ++h[kAlphabetBase[a] + s]; });
  }
  // each block's nonzero bins
  std::vector<std::vector<std::pair<int, uint32_t>>> sparse(nb);
  std::vector<std::pair<int, int>> order(nb);
  for (int b = 0; b < nb; ++b) {
    const uint32_t *h = hist.data() + (size_t)b * kAlphabetTotal;
    int common = 0;
    for (int s = 0; s < kAlphabetTotal; ++s) {
      if (h[s]) sparse[b].push_back({s, h[s]});
      if (s < 256 && h[s] > h[common]) common = s;
    }
    order[b] = {common, b};
  }
  std::sort(order.begin(), order.end());
  int k = std::min(nb, kMaxGroups);
  std::vector<int> group(nb);
  for (int i = 0; i < nb; ++i) group[order[i].second] = (int)((int64_t)i * k / nb);
  std::vector<uint32_t> sums;
  std::vector<float> cost;
  for (int round = 0; round < 6; ++round) {
    sums.assign((size_t)k * kAlphabetTotal, 0);
    for (int b = 0; b < nb; ++b)
      for (auto &e : sparse[b]) sums[(size_t)group[b] * kAlphabetTotal + e.first] += e.second;
    cost.assign((size_t)k * kAlphabetTotal, 0.0f);
    for (int g = 0; g < k; ++g) {
      for (int a = 0; a < 5; ++a) {
        const uint32_t *bins = sums.data() + (size_t)g * kAlphabetTotal + kAlphabetBase[a];
        float *c = cost.data() + (size_t)g * kAlphabetTotal + kAlphabetBase[a];
        uint64_t total = 0;
        for (int s = 0; s < kAlphabetSize[a]; ++s) total += bins[s];
        const double lt = std::log2((double)total + 1.0);
        for (int s = 0; s < kAlphabetSize[a]; ++s)
          c[s] = bins[s] ? (float)(lt - std::log2((double)bins[s])) : (float)(lt + 10.0);
      }
    }
    bool moved = false;
    for (int b = 0; b < nb; ++b) {
      int best = group[b];
      float best_cost = 0.0f;
      for (int g = 0; g < k; ++g) {
        const float *c = cost.data() + (size_t)g * kAlphabetTotal;
        float sum = 0.0f;
        for (auto &e : sparse[b]) sum += e.second * c[e.first];
        if (g == 0 || sum < best_cost) {
          best_cost = sum;
          best = g;
        }
      }
      moved |= best != group[b];
      group[b] = best;
    }
    if (!moved) break;
  }
  // renumber the groups in use, and weigh them against one group
  std::vector<int> index(k, -1);
  int used = 0;
  for (int b = 0; b < nb; ++b)
    if (index[group[b]] < 0) index[group[b]] = used++;
  sums.assign((size_t)used * kAlphabetTotal, 0);
  std::vector<uint32_t> one(kAlphabetTotal, 0);
  for (int b = 0; b < nb; ++b) {
    group[b] = index[group[b]];
    for (auto &e : sparse[b]) {
      sums[(size_t)group[b] * kAlphabetTotal + e.first] += e.second;
      one[e.first] += e.second;
    }
  }
  double grouped = 2.0 * nb;  // the entropy image, about 2 bits a block
  for (int g = 0; g < used; ++g) grouped += histogram_bits(sums.data() + (size_t)g * kAlphabetTotal);
  if (used < 2 || grouped >= histogram_bits(one.data())) return {};
  num_groups = used;
  std::vector<uint32_t> image(nb);
  for (int b = 0; b < nb; ++b) image[b] = 0xff000000u | (uint32_t)group[b] << 8;
  return image;
}

// The entropy-coded image of ``px``: the colour-cache bit (no cache), the
// meta-code bit where ``level0`` (with an entropy image of prefix-code
// groups where cluster_blocks finds one worth its cost), the five codes of
// each group, and the pixels as lz77_tokens
void write_image_data(BitWriter &bw, const uint32_t *px, int width, int height, bool level0) {
  const std::vector<Token> tokens = lz77_tokens(px, width, height);
  int num_groups = 1;
  std::vector<uint32_t> groups_image;
  if (level0) groups_image = cluster_blocks(tokens, width, height, num_groups);
  const int bx = subsample(width, kMetaBits);
  std::vector<std::vector<uint32_t>> freq((size_t)num_groups * 5);
  for (int g = 0; g < num_groups; ++g)
    for (int a = 0; a < 5; ++a) freq[(size_t)g * 5 + a].assign(kAlphabetSize[a], 0);
  // the group of each token: that of the block of its first pixel
  std::vector<uint8_t> token_group(tokens.size(), 0);
  if (num_groups > 1) {
    int x = 0, y = 0;
    for (size_t k = 0; k < tokens.size(); ++k) {
      token_group[k] = (uint8_t)((groups_image[(size_t)(y >> kMetaBits) * bx + (x >> kMetaBits)] >> 8) & 0xff);
      x += tokens[k].length ? tokens[k].length : 1;
      while (x >= width) {
        x -= width;
        ++y;
      }
    }
  }
  for (size_t k = 0; k < tokens.size(); ++k) {
    const int g = token_group[k];
    token_symbols(tokens[k], [&](int a, int s) { ++freq[(size_t)g * 5 + a][s]; });
  }
  bw.put(0, 1);  // no colour cache
  if (level0) {
    if (num_groups > 1) {
      bw.put(1, 1);
      bw.put(kMetaBits - 2, 3);
      write_image_data(bw, groups_image.data(), bx, subsample(height, kMetaBits), false);
    } else {
      bw.put(0, 1);
    }
  }
  std::vector<Code> codes((size_t)num_groups * 5);
  for (size_t c = 0; c < codes.size(); ++c) codes[c] = write_code(bw, freq[c]);
  for (size_t k = 0; k < tokens.size(); ++k) {
    const Token &t = tokens[k];
    const Code *code = codes.data() + (size_t)token_group[k] * 5;
    if (t.length == 0) {
      code[0].write(bw, (t.argb >> 8) & 0xff);
      code[1].write(bw, (t.argb >> 16) & 0xff);
      code[2].write(bw, t.argb & 0xff);
      code[3].write(bw, t.argb >> 24);
    } else {
      int symbol, bits, value;
      prefix_encode(t.length, symbol, bits, value);
      code[0].write(bw, 256 + symbol);
      bw.put((uint32_t)value, bits);
      prefix_encode(t.plane_code, symbol, bits, value);
      code[4].write(bw, symbol);
      bw.put((uint32_t)value, bits);
    }
  }
}

const int kPredictorBits = 4;  // 16 x 16 blocks

// n log2 n for the block histograms' entropy
struct NLogN {
  float table[(1 << (2 * kPredictorBits)) + 1];
  NLogN() {
    table[0] = 0.0f;
    for (int k = 1; k <= (1 << (2 * kPredictorBits)); ++k) table[k] = (float)(k * std::log2((double)k));
  }
};

// The entropy of one block's residuals under predictor MODE: the sum over
// the varying channels (bit shifts in ``shifts``) of N log2 N - sum n log2 n
template <int MODE>
float block_entropy(const uint32_t *px, int width, int x0, int x1, int y0, int y1,
                    const int *shifts, int nch, uint16_t *hist, uint32_t *residuals,
                    const float *nlogn) {
  int count = 0;
  for (int y = y0; y < y1; ++y) {
    const uint32_t *row = px + (size_t)y * width;
    const uint32_t *upper = row - width;
    for (int x = x0; x < x1; ++x) residuals[count++] = sub_pixels(row[x], predict(MODE, row[x - 1], upper + x));
  }
  float sum = 0.0f;
  for (int c = 0; c < nch; ++c) {
    uint16_t *h = hist + c * 256;
    const int shift = shifts[c];
    for (int i = 0; i < count; ++i) ++h[(residuals[i] >> shift) & 0xff];
    for (int i = 0; i < count; ++i) {
      uint16_t &n = h[(residuals[i] >> shift) & 0xff];
      sum += nlogn[n];
      n = 0;
    }
  }
  return nch * nlogn[count] - sum;
}

// the residuals of row[x0, x1) under predictor MODE
template <int MODE>
void sub_predicted(const uint32_t *row, const uint32_t *upper, uint32_t *out, int x0, int x1) {
  for (int x = x0; x < x1; ++x) out[x] = sub_pixels(row[x], predict(MODE, row[x - 1], upper + x));
}

typedef void (*SubRun)(const uint32_t *, const uint32_t *, uint32_t *, int, int);
const SubRun kSubRuns[16] = {
    sub_predicted<0>,  sub_predicted<1>,  sub_predicted<2>,  sub_predicted<3>,
    sub_predicted<4>,  sub_predicted<5>,  sub_predicted<6>,  sub_predicted<7>,
    sub_predicted<8>,  sub_predicted<9>,  sub_predicted<10>, sub_predicted<11>,
    sub_predicted<12>, sub_predicted<13>, sub_predicted<0>,  sub_predicted<0>};

typedef float (*BlockEntropy)(const uint32_t *, int, int, int, int, int, const int *, int,
                              uint16_t *, uint32_t *, const float *);
const BlockEntropy kBlockEntropy[14] = {
    block_entropy<0>, block_entropy<1>, block_entropy<2>,  block_entropy<3>,  block_entropy<4>,
    block_entropy<5>, block_entropy<6>, block_entropy<7>,  block_entropy<8>,  block_entropy<9>,
    block_entropy<10>, block_entropy<11>, block_entropy<12>, block_entropy<13>};

// The predictor's mode of each block: the one of 0..13 whose residuals'
// histograms (one per channel that varies) have the least entropy; the
// first row and column of the image, whose prediction is fixed, do not
// count
std::vector<uint32_t> choose_modes(const uint32_t *px, int width, int height, bool alpha, bool color) {
  static const NLogN nlogn;
  const int tiles_x = subsample(width, kPredictorBits);
  const int tiles_y = subsample(height, kPredictorBits);
  std::vector<uint32_t> modes((size_t)tiles_x * tiles_y, 0xff000000u | (11u << 8));
  int shifts[4];
  int nch = 0;
  shifts[nch++] = 8;
  if (color) {
    shifts[nch++] = 16;
    shifts[nch++] = 0;
  }
  if (alpha) shifts[nch++] = 24;
  std::vector<uint16_t> hist(4 * 256, 0);
  std::vector<uint32_t> residuals((size_t)1 << (2 * kPredictorBits));
  for (int ty = 0; ty < tiles_y; ++ty) {
    for (int tx = 0; tx < tiles_x; ++tx) {
      const int y0 = std::max(1, ty << kPredictorBits);
      const int y1 = std::min(height, (ty + 1) << kPredictorBits);
      const int x0 = std::max(1, tx << kPredictorBits);
      const int x1 = std::min(width, (tx + 1) << kPredictorBits);
      if (y0 >= y1 || x0 >= x1) continue;
      float best = 0.0f;
      int best_mode = 0;
      for (int mode = 0; mode < 14; ++mode) {
        const float cost = kBlockEntropy[mode](px, width, x0, x1, y0, y1, shifts, nch, hist.data(),
                                               residuals.data(), nlogn.table);
        if (mode == 0 || cost < best) {
          best = cost;
          best_mode = mode;
        }
      }
      modes[(size_t)ty * tiles_x + tx] = 0xff000000u | (uint32_t)best_mode << 8;
    }
  }
  return modes;
}

std::vector<uint8_t> encode_vp8l(const uint8_t *pixels, int width, int height, int channels) {
  const size_t n = (size_t)width * height;
  std::vector<uint32_t> argb(n);
  bool alpha = false, color = false;
  for (size_t i = 0; i < n; ++i) {
    uint32_t r, g, b, a = 255;
    if (channels == 1) {
      r = g = b = pixels[i];
    } else {
      const uint8_t *p = pixels + i * channels;
      r = p[0];
      g = p[1];
      b = p[2];
      if (channels == 4) a = p[3];
    }
    alpha |= a != 255;
    color |= r != g || b != g;
    argb[i] = a << 24 | r << 16 | g << 8 | b;
  }
  // subtract-green (VP8LSubtractGreenFromBlueAndRed)
  for (size_t i = 0; i < n; ++i) {
    const uint32_t v = argb[i];
    const uint32_t green = (v >> 8) & 0xff;
    const uint32_t red_blue = (v & 0x00ff00ffu) + 0x01000100u - ((green << 16) | green);
    argb[i] = (v & 0xff00ff00u) | (red_blue & 0x00ff00ffu);
  }
  const std::vector<uint32_t> modes = choose_modes(argb.data(), width, height, alpha, color);
  // the residuals of every pixel against the original neighbours
  const int tiles_x = subsample(width, kPredictorBits);
  std::vector<uint32_t> residual(n);
  residual[0] = sub_pixels(argb[0], 0xff000000u);
  for (int x = 1; x < width; ++x) residual[x] = sub_pixels(argb[x], argb[x - 1]);
  const int tile = 1 << kPredictorBits;
  for (int y = 1; y < height; ++y) {
    const uint32_t *row = argb.data() + (size_t)y * width;
    uint32_t *out = residual.data() + (size_t)y * width;
    const uint32_t *row_modes = modes.data() + (size_t)(y >> kPredictorBits) * tiles_x;
    out[0] = sub_pixels(row[0], row[-width]);
    for (int x = 1; x < width;) {
      const int x_end = std::min(width, (x & ~(tile - 1)) + tile);
      kSubRuns[(row_modes[x >> kPredictorBits] >> 8) & 0xf](row, row - width, out, x, x_end);
      x = x_end;
    }
  }
  BitWriter bw;
  bw.put(0x2f, 8);
  bw.put((uint32_t)width - 1, 14);
  bw.put((uint32_t)height - 1, 14);
  bw.put(alpha ? 1 : 0, 1);
  bw.put(0, 3);
  bw.put(1, 1);
  bw.put(SUBTRACT_GREEN, 2);
  bw.put(1, 1);
  bw.put(PREDICTOR, 2);
  bw.put(kPredictorBits - 2, 3);
  write_image_data(bw, modes.data(), tiles_x, subsample(height, kPredictorBits), false);
  bw.put(0, 1);  // no more transforms
  write_image_data(bw, residual.data(), width, height, true);
  bw.flush();
  return bw.bytes;
}

}  // namespace

extern "C" {

int webp_decode(const uint8_t *src, int64_t n, uint8_t *out, int64_t capacity, int32_t *info,
                char *message, int64_t message_size) {
  try {
    const Frame frame = parse_container(src, (size_t)n);
    const int channels = frame.has_alpha ? 4 : 3;
    const int written = info[3] >= 1 && info[3] < channels ? info[3] : channels;
    info[0] = frame.width;
    info[1] = frame.height;
    info[2] = channels;
    const int64_t need = (int64_t)frame.width * frame.height * written;
    if (out == nullptr || capacity < need) {
      if (message_size > 0) message[0] = 0;
      return WEBP_NEED_SPACE;
    }
    std::unique_ptr<uint32_t[]> px = decode_vp8l(frame);
    const size_t count = (size_t)frame.width * frame.height;
    // VP8LConvertBGRAToRGBA_C, the alpha byte dropped for Pillow's "RGBX"
    if (written == 1) {
      for (size_t i = 0; i < count; ++i) out[i] = (uint8_t)(px[i] >> 16);
    } else {
      for (size_t i = 0; i < count; ++i) {
        const uint32_t v = px[i];
        uint8_t *o = out + i * written;
        o[0] = (uint8_t)(v >> 16);
        o[1] = (uint8_t)(v >> 8);
        if (written > 2) o[2] = (uint8_t)v;
        if (written > 3) o[3] = (uint8_t)(v >> 24);
      }
    }
    if (message_size > 0) message[0] = 0;
    return WEBP_OK;
  } catch (const WebpError &e) {
    if (message_size > 0) {
      std::strncpy(message, e.message.c_str(), (size_t)message_size - 1);
      message[message_size - 1] = 0;
    }
    return e.code;
  } catch (const std::bad_alloc &) {
    if (message_size > 0) {
      std::strncpy(message, "out of memory", (size_t)message_size - 1);
      message[message_size - 1] = 0;
    }
    return WEBP_CORRUPT;
  }
}

int64_t webp_encode(const uint8_t *pixels, int32_t width, int32_t height, int32_t channels,
                    uint8_t *out, int64_t capacity) {
  if (width < 1 || height < 1 || width > 16384 || height > 16384 ||
      !(channels == 1 || channels == 3 || channels == 4)) {
    return -2;
  }
  try {
    const std::vector<uint8_t> stream = encode_vp8l(pixels, width, height, channels);
    const size_t padded = stream.size() + (stream.size() & 1);
    const size_t total = 20 + padded;
    if ((int64_t)total > capacity) return -1;
    std::memcpy(out, "RIFF", 4);
    const uint32_t riff_size = (uint32_t)(total - 8);
    const uint32_t chunk_size = (uint32_t)stream.size();
    for (int k = 0; k < 4; ++k) out[4 + k] = (uint8_t)(riff_size >> (8 * k));
    std::memcpy(out + 8, "WEBPVP8L", 8);
    for (int k = 0; k < 4; ++k) out[16 + k] = (uint8_t)(chunk_size >> (8 * k));
    std::memcpy(out + 20, stream.data(), stream.size());
    if (stream.size() & 1) out[20 + stream.size()] = 0;
    return (int64_t)total;
  } catch (const std::bad_alloc &) {
    return -2;
  }
}

}  // extern "C"
