// The port's WebP codec: a decoder of still WebP images that follows the
// lossless bitstream (VP8L, RFC 9649), the lossy one (VP8 key frames, RFC
// 6386) with its ALPH chunk, and libwebp 1.6.0's checks and output as
// Pillow drives it (its WebPAnimDecoder over WebPDemux, RGBA output, the
// alpha flag of the container deciding RGB or RGBA; for a lossy frame the
// loop filter, fancy upsampling and 14-bit YUV to RGB, bitwise), and a
// lossless encoder of its own.  Each step names the libwebp routine it
// follows.
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
//   only the container (and the frame header it checks) is read and WEBP_NEED_SPACE is
//   returned with ``info`` filled in.  Returns 0, or WEBP_CORRUPT (where
//   libwebp's demuxer or decoder fails, so Pillow raises OSError),
//   WEBP_UNSUPPORTED (an animation), with a message.
//
//   webp_decode_planes(src, n, y, u, v, info, message, message_size)
//   a lossy frame's Y (width x height), U and V ((width + 1) / 2 x
//   (height + 1) / 2) planes before the upsampling, as libwebp's
//   WebPDecodeYUV gives them; with ``y`` NULL only info[0..1] = width,
//   height and WEBP_NEED_SPACE.
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
  const uint8_t *payload = nullptr;  // the VP8L or VP8 bitstream, its padding included
  size_t payload_size = 0;
  int width = 0, height = 0;
  bool has_alpha = false;  // Pillow's RGBA
  bool lossy = false;      // a "VP8 " frame
  const uint8_t *alpha = nullptr;  // its ALPH chunk's payload, kept under the alpha flag
  size_t alpha_size = 0;
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
    const bool is_animation = (flags & kAnimationFlag) != 0;
    do {
      const uint8_t *head = buf + start;
      const uint32_t chunk_size = le32(head + 4);
      start += 8;
      if (chunk_size > kMaxChunkPayload) return false;
      const size_t padded = (size_t)chunk_size + (chunk_size & 1);
      if (size_invalid(padded)) return false;
      if (tag_is(head, "VP8X")) return false;
      if (tag_is(head, "ALPH") || tag_is(head, "VP8 ") || tag_is(head, "VP8L")) {
        if (is_animation) return false;  // a still image's chunks under the animation flag
        start -= 8;
        if (!single_image()) return false;
      } else if (tag_is(head, "ANIM")) {
        unsupported("an animated WebP (ANIM/ANMF chunks) is not ported");
      } else if (tag_is(head, "ANMF")) {
        return false;  // no ANIM before the frames
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
  Frame frame = c.frame;
  frame.has_alpha = (c.flags & kAlphaFlag) != 0;
  frame.lossy = c.lossy;
  if (c.alpha_size > 0) {  // GetFramePayload: the ALPH chunk before the image
    frame.alpha = data + c.alpha_offset + 8;
    frame.alpha_size = le32(data + c.alpha_offset + 4);
  }
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

// VP8LBitReader itself, for DecodeAlphaData, where what a read past the end
// gives is kept: the window is the last 8 bytes loaded, shifted by the bit
// position modulo 64 (so a read at exactly 64 bits wraps onto them), and
// once the end is seen the position restarts at 0
struct LiteralBitReader {
  const uint8_t *buf;
  size_t len, loaded;
  uint64_t val = 0;
  int bit_pos;
  bool eos = false;

  // the state VP8LInitBitReader and ShiftBytes leave at ``bits`` read
  LiteralBitReader(const uint8_t *data, size_t size, uint64_t bits) : buf(data), len(size) {
    const size_t skip = size <= 8 ? 0 : std::min<size_t>((size_t)(bits >> 3), size - 8);
    loaded = std::min<size_t>(size, skip + 8);
    for (size_t i = skip; i < loaded; ++i) val |= (uint64_t)buf[i] << (8 * (i - skip));
    bit_pos = (int)(bits - 8 * skip);
  }
  uint32_t prefetch() const { return (uint32_t)(val >> (bit_pos & 63)); }  // VP8LPrefetchBits
  bool at_end() const { return eos || (loaded == len && bit_pos > 64); }  // VP8LIsEndOfStream
  void set_end() {  // VP8LSetEndOfStream
    eos = true;
    bit_pos = 0;
  }
  void shift_bytes() {  // ShiftBytes
    while (bit_pos >= 8 && loaded < len) {
      val = (val >> 8) | (uint64_t)buf[loaded++] << 56;
      bit_pos -= 8;
    }
    if (at_end()) set_end();
  }
  void fill() {  // VP8LFillBitWindow
    if (bit_pos >= 32) shift_bytes();
  }
  uint32_t read(int n) {  // VP8LReadBits
    if (!eos && n <= 24) {
      const uint32_t v = prefetch() & ((1u << n) - 1);
      bit_pos += n;
      shift_bytes();
      return v;
    }
    set_end();
    return 0;
  }
  // ReadSymbol
  int symbol(const HCode *table) {
    uint32_t v = prefetch();
    table += v & ((1u << kRootBits) - 1);
    const int nbits = table->bits - kRootBits;
    if (nbits > 0) {
      bit_pos += kRootBits;
      v = prefetch();
      table += table->value;
      table += v & ((1u << nbits) - 1);
    }
    bit_pos += table->bits;
    return table->value;
  }
  // GetCopyDistance and GetCopyLength
  int copy_value(int symbol) {
    if (symbol < 4) return symbol + 1;
    const int extra_bits = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra_bits;
    return offset + (int)read(extra_bits) + 1;
  }
};

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
  // an ALPH chunk's stream: decoded to bytes (DecodeAlphaData) where it is
  // colour-indexed alone with no colour cache and no red, blue or alpha
  // bits (VP8LDecodeAlphaHeader's Is8bOptimizable)
  bool alpha_stream = false;

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
    bool bytes = alpha_stream && level0 && cache_bits == 0 && transforms.size() == 1 &&
                 transforms[0].type == COLOR_INDEXING;
    for (const Group &g : groups) bytes = bytes && g.trivial;
    const size_t total = (size_t)xsize * ysize;
    std::unique_ptr<uint32_t[]> pixels(new uint32_t[total]);
    if (bytes) {
      decode_alpha_bytes(pixels.get(), xsize, ysize, groups, huffman_image.get(), huffman_bits,
                         huffman_xsize);
    } else {
      decode_pixels(pixels.get(), xsize, ysize, groups, huffman_image.get(), huffman_bits,
                    huffman_xsize, cache_bits);
    }
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

  // DecodeAlphaData: the colour indices of an ALPH stream, over libwebp's
  // own bit reader from where the prefix codes end.  A pixel read past
  // the end is kept, and the stream fails only where the image is not
  // complete
  void decode_alpha_bytes(uint32_t *data, int width, int height, const std::vector<Group> &groups,
                          const uint32_t *huffman_image, int huffman_bits, int huffman_xsize) {
    LiteralBitReader lr(br.data, br.size, br.pos);
    const size_t end = (size_t)width * height;
    const int mask = huffman_bits == 0 ? ~0 : (1 << huffman_bits) - 1;
    auto group_at = [&](int x, int y) -> const Group * {
      if (!huffman_image) return &groups[0];
      return &groups[huffman_image[(size_t)huffman_xsize * (y >> huffman_bits) + (x >> huffman_bits)]];
    };
    size_t pos = 0;
    int col = 0, row = 0;
    bool ok = true;
    const Group *g = end ? group_at(0, 0) : nullptr;
    while (!lr.eos && pos < end) {
      if ((col & mask) == 0) g = group_at(col, row);
      lr.fill();
      const int code = lr.symbol(g->codes[0]);
      if (code < 256) {
        data[pos++] = (uint32_t)code << 8;
        if (++col >= width) {
          col = 0;
          ++row;
        }
      } else if (code < 280) {
        const int length = lr.copy_value(code - 256);
        const int dist_symbol = lr.symbol(g->codes[4]);
        lr.fill();
        const size_t dist = (size_t)plane_code_to_distance(width, lr.copy_value(dist_symbol));
        if (!(pos >= dist && end - pos >= (size_t)length)) {
          ok = false;
          break;
        }
        for (int k = 0; k < length; ++k) data[pos + k] = data[pos + k - dist];
        pos += length;
        col += length;
        while (col >= width) {
          col -= width;
          ++row;
        }
        if (pos < end && (col & mask)) g = group_at(col, row);
      } else {
        ok = false;
        break;
      }
      lr.eos = lr.at_end();
    }
    if (!ok || (lr.at_end() && pos < end)) corrupt("the alpha data is truncated or broken");
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

// ApplyInverseTransforms: one transform undone over the whole image
void apply_inverse(const Transform &t, std::unique_ptr<uint32_t[]> &px) {
  switch (t.type) {
    case PREDICTOR: inverse_predictor(t, px.get()); break;
    case CROSS_COLOR: inverse_cross_color(t, px.get()); break;
    case SUBTRACT_GREEN: inverse_subtract_green((size_t)t.xsize * t.ysize, px.get()); break;
    case COLOR_INDEXING: px = inverse_color_indexing(t, px.get()); break;
  }
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
  for (size_t k = dec.transforms.size(); k-- > 0;) apply_inverse(dec.transforms[k], px);
  return px;
}

// --- the lossy decoder: RFC 6386 key frames as libwebp 1.6.0 decodes them
// (vp8_dec.c, tree_dec.c, quant_dec.c, frame_dec.c, dsp/dec.c), their
// output (io_dec.c: EmitFancyRGB; dsp/upsampling.c; dsp/yuv.h) and the ALPH
// chunk (alpha_dec.c, dsp/filters.c).  The tables are RFC 6386's ---

// tree_dec.c: kBModesProba[top][left], the 4x4 mode tree's probabilities
const uint8_t kBModesProba[10][10][9] = {
    {{231, 120, 48, 89, 115, 113, 120, 152, 112},
     {152, 179, 64, 126, 170, 118, 46, 70, 95},
     {175, 69, 143, 80, 85, 82, 72, 155, 103},
     {56, 58, 10, 171, 218, 189, 17, 13, 152},
     {114, 26, 17, 163, 44, 195, 21, 10, 173},
     {121, 24, 80, 195, 26, 62, 44, 64, 85},
     {144, 71, 10, 38, 171, 213, 144, 34, 26},
     {170, 46, 55, 19, 136, 160, 33, 206, 71},
     {63, 20, 8, 114, 114, 208, 12, 9, 226},
     {81, 40, 11, 96, 182, 84, 29, 16, 36}},
    {{134, 183, 89, 137, 98, 101, 106, 165, 148},
     {72, 187, 100, 130, 157, 111, 32, 75, 80},
     {66, 102, 167, 99, 74, 62, 40, 234, 128},
     {41, 53, 9, 178, 241, 141, 26, 8, 107},
     {74, 43, 26, 146, 73, 166, 49, 23, 157},
     {65, 38, 105, 160, 51, 52, 31, 115, 128},
     {104, 79, 12, 27, 217, 255, 87, 17, 7},
     {87, 68, 71, 44, 114, 51, 15, 186, 23},
     {47, 41, 14, 110, 182, 183, 21, 17, 194},
     {66, 45, 25, 102, 197, 189, 23, 18, 22}},
    {{88, 88, 147, 150, 42, 46, 45, 196, 205},
     {43, 97, 183, 117, 85, 38, 35, 179, 61},
     {39, 53, 200, 87, 26, 21, 43, 232, 171},
     {56, 34, 51, 104, 114, 102, 29, 93, 77},
     {39, 28, 85, 171, 58, 165, 90, 98, 64},
     {34, 22, 116, 206, 23, 34, 43, 166, 73},
     {107, 54, 32, 26, 51, 1, 81, 43, 31},
     {68, 25, 106, 22, 64, 171, 36, 225, 114},
     {34, 19, 21, 102, 132, 188, 16, 76, 124},
     {62, 18, 78, 95, 85, 57, 50, 48, 51}},
    {{193, 101, 35, 159, 215, 111, 89, 46, 111},
     {60, 148, 31, 172, 219, 228, 21, 18, 111},
     {112, 113, 77, 85, 179, 255, 38, 120, 114},
     {40, 42, 1, 196, 245, 209, 10, 25, 109},
     {88, 43, 29, 140, 166, 213, 37, 43, 154},
     {61, 63, 30, 155, 67, 45, 68, 1, 209},
     {100, 80, 8, 43, 154, 1, 51, 26, 71},
     {142, 78, 78, 16, 255, 128, 34, 197, 171},
     {41, 40, 5, 102, 211, 183, 4, 1, 221},
     {51, 50, 17, 168, 209, 192, 23, 25, 82}},
    {{138, 31, 36, 171, 27, 166, 38, 44, 229},
     {67, 87, 58, 169, 82, 115, 26, 59, 179},
     {63, 59, 90, 180, 59, 166, 93, 73, 154},
     {40, 40, 21, 116, 143, 209, 34, 39, 175},
     {47, 15, 16, 183, 34, 223, 49, 45, 183},
     {46, 17, 33, 183, 6, 98, 15, 32, 183},
     {57, 46, 22, 24, 128, 1, 54, 17, 37},
     {65, 32, 73, 115, 28, 128, 23, 128, 205},
     {40, 3, 9, 115, 51, 192, 18, 6, 223},
     {87, 37, 9, 115, 59, 77, 64, 21, 47}},
    {{104, 55, 44, 218, 9, 54, 53, 130, 226},
     {64, 90, 70, 205, 40, 41, 23, 26, 57},
     {54, 57, 112, 184, 5, 41, 38, 166, 213},
     {30, 34, 26, 133, 152, 116, 10, 32, 134},
     {39, 19, 53, 221, 26, 114, 32, 73, 255},
     {31, 9, 65, 234, 2, 15, 1, 118, 73},
     {75, 32, 12, 51, 192, 255, 160, 43, 51},
     {88, 31, 35, 67, 102, 85, 55, 186, 85},
     {56, 21, 23, 111, 59, 205, 45, 37, 192},
     {55, 38, 70, 124, 73, 102, 1, 34, 98}},
    {{125, 98, 42, 88, 104, 85, 117, 175, 82},
     {95, 84, 53, 89, 128, 100, 113, 101, 45},
     {75, 79, 123, 47, 51, 128, 81, 171, 1},
     {57, 17, 5, 71, 102, 57, 53, 41, 49},
     {38, 33, 13, 121, 57, 73, 26, 1, 85},
     {41, 10, 67, 138, 77, 110, 90, 47, 114},
     {115, 21, 2, 10, 102, 255, 166, 23, 6},
     {101, 29, 16, 10, 85, 128, 101, 196, 26},
     {57, 18, 10, 102, 102, 213, 34, 20, 43},
     {117, 20, 15, 36, 163, 128, 68, 1, 26}},
    {{102, 61, 71, 37, 34, 53, 31, 243, 192},
     {69, 60, 71, 38, 73, 119, 28, 222, 37},
     {68, 45, 128, 34, 1, 47, 11, 245, 171},
     {62, 17, 19, 70, 146, 85, 55, 62, 70},
     {37, 43, 37, 154, 100, 163, 85, 160, 1},
     {63, 9, 92, 136, 28, 64, 32, 201, 85},
     {75, 15, 9, 9, 64, 255, 184, 119, 16},
     {86, 6, 28, 5, 64, 255, 25, 248, 1},
     {56, 8, 17, 132, 137, 255, 55, 116, 128},
     {58, 15, 20, 82, 135, 57, 26, 121, 40}},
    {{164, 50, 31, 137, 154, 133, 25, 35, 218},
     {51, 103, 44, 131, 131, 123, 31, 6, 158},
     {86, 40, 64, 135, 148, 224, 45, 183, 128},
     {22, 26, 17, 131, 240, 154, 14, 1, 209},
     {45, 16, 21, 91, 64, 222, 7, 1, 197},
     {56, 21, 39, 155, 60, 138, 23, 102, 213},
     {83, 12, 13, 54, 192, 255, 68, 47, 28},
     {85, 26, 85, 85, 128, 128, 32, 146, 171},
     {18, 11, 7, 63, 144, 171, 4, 4, 246},
     {35, 27, 10, 146, 174, 171, 12, 26, 128}},
    {{190, 80, 35, 99, 180, 80, 126, 54, 45},
     {85, 126, 47, 87, 176, 51, 41, 20, 32},
     {101, 75, 128, 139, 118, 146, 116, 128, 85},
     {56, 41, 15, 176, 236, 85, 37, 9, 62},
     {71, 30, 17, 119, 118, 255, 17, 18, 138},
     {101, 38, 60, 138, 55, 70, 43, 26, 142},
     {146, 36, 19, 30, 171, 255, 97, 27, 20},
     {138, 45, 61, 62, 219, 1, 81, 188, 64},
     {32, 41, 20, 117, 151, 142, 20, 21, 163},
     {112, 19, 12, 61, 195, 128, 48, 4, 24}},
};
// tree_dec.c: CoeffsProba0, the default coefficient probabilities
const uint8_t kCoeffsProba0[4][8][3][11] = {
    {
        {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}, {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}, {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128}, {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128}, {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
        {{1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128}, {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128}, {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
        {{1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128}, {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128}, {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
        {{1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128}, {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128}, {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
        {{1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128}, {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128}, {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
        {{1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128}, {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128}, {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
        {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
    },
    {
        {{198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62}, {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1}, {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
        {{1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128}, {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128}, {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
        {{1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128}, {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128}, {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
        {{1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128}, {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128}, {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
        {{1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128}, {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128}, {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
        {{1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128}, {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128}, {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
        {{1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128}, {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128}, {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
        {{1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128}, {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128}, {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}},
    },
    {
        {{253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128}, {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128}, {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
        {{1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128}, {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128}, {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
        {{1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128}, {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128}, {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
        {{1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128}, {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128}, {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
        {{1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128}, {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128}, {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128}, {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128}, {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}, {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}, {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
    },
    {
        {{202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255}, {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128}, {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
        {{1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128}, {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128}, {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
        {{1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128}, {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128}, {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
        {{1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128}, {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128}, {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
        {{1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128}, {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128}, {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
        {{1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128}, {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128}, {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
        {{1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128}, {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128}, {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
        {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    },
};
// tree_dec.c: CoeffsUpdateProba, the probabilities of their updates
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    {
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255}, {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255}, {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255}, {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
    {
        {{217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255}, {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
        {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
    {
        {{186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255}, {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255}, {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
        {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
    {
        {{248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255}, {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255}, {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
};
// quant_dec.c: kDcTable and kAcTable
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
// the band of each coefficient position; the 17th is the sentinel past the end
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t *const kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};

// bit_reader_utils.c and bit_reader_inl_utils.h: VP8BitReader, its range
// kept minus one, 56 bits loaded at a time.  Past the end one zero byte is
// read and eof set; libwebp checks eof after each row of modes and each
// macroblock's residuals, so every read that reaches it fails the frame
struct BoolDecoder {
  const uint8_t *buf = nullptr, *buf_end = nullptr, *buf_max = nullptr;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 255 - 1;
  bool eof = false;

  // VP8InitBitReader: the first bytes are loaded at once, so an empty
  // partition is at its end before any read
  void init(const uint8_t *start, size_t size) {
    buf = start;
    buf_end = start + size;
    buf_max = size >= 8 ? start + size - 8 + 1 : start;
    value = 0;
    bits = -8;
    range = 255 - 1;
    eof = false;
    load();
  }
  // VP8LoadNewBytes and VP8LoadFinalBytes
  void load() {
    if (buf < buf_max) {
      uint64_t in;
      std::memcpy(&in, buf, 8);
      buf += 7;
      value = (__builtin_bswap64(in) >> 8) | (value << 56);
      bits += 56;
    } else if (buf < buf_end) {
      bits += 8;
      value = (uint64_t)(*buf++) | (value << 8);
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  // VP8GetBit
  inline int bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * (uint32_t)prob) >> 8;
    const uint32_t v = (uint32_t)(value >> pos);
    const int b = v > split;
    if (b) {
      r -= split;
      value -= (uint64_t)(split + 1) << pos;
    } else {
      r = split + 1;
    }
    const int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return b;
  }
  // VP8GetValue: ``n`` bits, the most significant first
  inline int value_bits(int n) {
    int v = 0;
    while (n-- > 0) v |= bit(0x80) << n;
    return v;
  }
  // VP8GetSignedValue
  inline int signed_value(int n) {
    const int v = value_bits(n);
    return value_bits(1) ? -v : v;
  }
  // VP8GetSigned: ``v`` with a sign read at probability 1/2
  inline int sign(int v) {
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t val = (uint32_t)(value >> pos);
    const int32_t mask = (int32_t)(split - val) >> 31;  // -1 or 0
    bits -= 1;
    range += (uint32_t)mask;
    range |= 1;
    value -= (uint64_t)((split + 1) & (uint32_t)mask) << pos;
    return (v ^ mask) - mask;
  }
};

// the intra modes: the ten 4 x 4 ones, and the 16 x 16 and chroma ones at
// the same numbers with the three DC variants of the frame's edges
enum {
  B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED, B_VL_PRED,
  B_HD_PRED, B_HU_PRED,
  DC_PRED = B_DC_PRED, TM_PRED = B_TM_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED,
  DC_PRED_NOTOP = 4, DC_PRED_NOLEFT = 5, DC_PRED_NOTOPLEFT = 6
};

// the work area of frame_dec.c: one macroblock's Y, U and V at a stride of
// BPS, with the row above and the column to its left
const int BPS = 32;
const int kYuvSize = BPS * 17 + BPS * 9;
const int kYOff = BPS * 1 + 8;
const int kUOff = kYOff + BPS * 16 + BPS;
const int kVOff = kUOff + 16;
const int kScan[16] = {0 + 0 * BPS,  4 + 0 * BPS,  8 + 0 * BPS,  12 + 0 * BPS,
                       0 + 4 * BPS,  4 + 4 * BPS,  8 + 4 * BPS,  12 + 4 * BPS,
                       0 + 8 * BPS,  4 + 8 * BPS,  8 + 8 * BPS,  12 + 8 * BPS,
                       0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};

inline uint8_t clip8b(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// --- dsp/dec.c: the inverse transforms ---

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }  // WEBP_TRANSFORM_AC3_MUL1
inline int mul2(int a) { return (a * 35468) >> 16; }        // WEBP_TRANSFORM_AC3_MUL2
inline void store(uint8_t *dst, int x, int y, int v) {
  dst[x + y * BPS] = clip8b(dst[x + y * BPS] + (v >> 3));
}

// Transform_SSE2, the TransformOne that libwebp runs on x86-64: its 16-bit
// lanes wrap, and its products are _mm_mulhi_epi16 against 20091 and
// -30068 (MUL1 and MUL2 less the input).  Within the coefficients' normal
// range it equals TransformOne_C; a corrupt stream's larger coefficients
// wrap as libwebp's do
inline int16_t w16(int v) { return (int16_t)v; }
inline int16_t mulhi(int16_t a, int k) { return (int16_t)((a * k) >> 16); }
inline void idct_pass(int16_t i0, int16_t i1, int16_t i2, int16_t i3, int16_t dc_bias,
                      int16_t *out) {
  const int16_t dc = w16(i0 + dc_bias);
  const int16_t a = w16(dc + i2);
  const int16_t b = w16(dc - i2);
  const int16_t c = w16(w16(i1 - i3) + w16(mulhi(i1, -30068) - mulhi(i3, 20091)));
  const int16_t d = w16(w16(i1 + i3) + w16(mulhi(i1, 20091) + mulhi(i3, -30068)));
  out[0] = w16(a + d);
  out[1] = w16(b + c);
  out[2] = w16(b - c);
  out[3] = w16(a - d);
}

void transform_one(const int16_t *in, uint8_t *dst) {
  int16_t tmp[16], row[4];
  for (int i = 0; i < 4; ++i) idct_pass(in[i], in[4 + i], in[8 + i], in[12 + i], 0, tmp + 4 * i);
  for (int i = 0; i < 4; ++i) {  // row i from each column's i-th output
    idct_pass(tmp[i], tmp[4 + i], tmp[8 + i], tmp[12 + i], 4, row);
    for (int x = 0; x < 4; ++x) dst[x] = clip8b(dst[x] + (row[x] >> 3));
    dst += BPS;
  }
}

// TransformAC3_C: only in[0], in[1] and in[4] set
void transform_ac3(const int16_t *in, uint8_t *dst) {
  const int a = in[0] + 4;
  const int c4 = mul2(in[4]), d4 = mul1(in[4]);
  const int c1 = mul2(in[1]), d1 = mul1(in[1]);
  const int rows[4] = {a + d4, a + c4, a - c4, a - d4};
  for (int y = 0; y < 4; ++y) {
    store(dst, 0, y, rows[y] + d1);
    store(dst, 1, y, rows[y] + c1);
    store(dst, 2, y, rows[y] - c1);
    store(dst, 3, y, rows[y] - d1);
  }
}

// TransformDC_C: only in[0] set
void transform_dc(const int16_t *in, uint8_t *dst) {
  const int dc = in[0] + 4;
  for (int j = 0; j < 4; ++j)
    for (int i = 0; i < 4; ++i) store(dst, i, j, dc);
}

// frame_dec.c: DoTransform, by the block's two bits of non_zero_y
inline void do_transform(uint32_t bits, const int16_t *src, uint8_t *dst) {
  switch (bits >> 30) {
    case 3: transform_one(src, dst); break;
    case 2: transform_ac3(src, dst); break;
    case 1: transform_dc(src, dst); break;
    default: break;
  }
}

// DoUVTransform: the four blocks of a chroma plane
inline void do_uv_transform(uint32_t bits, const int16_t *src, uint8_t *dst) {
  if (bits & 0xff) {
    if (bits & 0xaa) {  // an AC coefficient: TransformUV, the full transform
      transform_one(src, dst);
      transform_one(src + 16, dst + 4);
      transform_one(src + 32, dst + 4 * BPS);
      transform_one(src + 48, dst + 4 * BPS + 4);
    } else {  // TransformDCUV
      transform_dc(src, dst);
      transform_dc(src + 16, dst + 4);
      transform_dc(src + 32, dst + 4 * BPS);
      transform_dc(src + 48, dst + 4 * BPS + 4);
    }
  }
}

// TransformWHT_C: the Y2 block's inverse Walsh-Hadamard transform into the
// DC of the sixteen luma blocks
void transform_wht(const int16_t *in, int16_t *out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

// --- dsp/dec.c: the intra predictors, over the work area ---

#define DST(x, y) dst[(x) + (y) * BPS]
inline uint8_t avg3(int a, int b, int c) { return (uint8_t)((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return (uint8_t)((a + b + 1) >> 1); }

// TrueMotion: clip(top + left - top_left)
inline void true_motion(uint8_t *dst, int size) {
  const uint8_t *top = dst - BPS;
  const int top_left = top[-1];
  for (int y = 0; y < size; ++y) {
    const int left = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip8b(top[x] + left - top_left);
    dst += BPS;
  }
}

void ve4(uint8_t *dst) {
  const uint8_t *top = dst - BPS;
  const uint8_t vals[4] = {avg3(top[-1], top[0], top[1]), avg3(top[0], top[1], top[2]),
                           avg3(top[1], top[2], top[3]), avg3(top[2], top[3], top[4])};
  for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, vals, 4);
}

void he4(uint8_t *dst) {
  const int A = dst[-1 - BPS], B = dst[-1], C = dst[-1 + BPS];
  const int D = dst[-1 + 2 * BPS], E = dst[-1 + 3 * BPS];
  std::memset(dst + 0 * BPS, avg3(A, B, C), 4);
  std::memset(dst + 1 * BPS, avg3(B, C, D), 4);
  std::memset(dst + 2 * BPS, avg3(C, D, E), 4);
  std::memset(dst + 3 * BPS, avg3(D, E, E), 4);
}

void dc4(uint8_t *dst) {
  uint32_t dc = 4;
  for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
  dc >>= 3;
  for (int i = 0; i < 4; ++i) std::memset(dst + i * BPS, (int)dc, 4);
}

void rd4(uint8_t *dst) {
  const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS];
  const int L = dst[-1 + 3 * BPS], X = dst[-1 - BPS];
  const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS];
  DST(0, 3) = avg3(J, K, L);
  DST(1, 3) = DST(0, 2) = avg3(I, J, K);
  DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
  DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
  DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
  DST(3, 1) = DST(2, 0) = avg3(C, B, A);
  DST(3, 0) = avg3(D, C, B);
}

void ld4(uint8_t *dst) {
  const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS];
  const int E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
  DST(0, 0) = avg3(A, B, C);
  DST(1, 0) = DST(0, 1) = avg3(B, C, D);
  DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
  DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
  DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
  DST(3, 2) = DST(2, 3) = avg3(F, G, H);
  DST(3, 3) = avg3(G, H, H);
}

void vr4(uint8_t *dst) {
  const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS];
  const int X = dst[-1 - BPS];
  const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS];
  DST(0, 0) = DST(1, 2) = avg2(X, A);
  DST(1, 0) = DST(2, 2) = avg2(A, B);
  DST(2, 0) = DST(3, 2) = avg2(B, C);
  DST(3, 0) = avg2(C, D);
  DST(0, 3) = avg3(K, J, I);
  DST(0, 2) = avg3(J, I, X);
  DST(0, 1) = DST(1, 3) = avg3(I, X, A);
  DST(1, 1) = DST(2, 3) = avg3(X, A, B);
  DST(2, 1) = DST(3, 3) = avg3(A, B, C);
  DST(3, 1) = avg3(B, C, D);
}

void vl4(uint8_t *dst) {
  const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS];
  const int E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
  DST(0, 0) = avg2(A, B);
  DST(1, 0) = DST(0, 2) = avg2(B, C);
  DST(2, 0) = DST(1, 2) = avg2(C, D);
  DST(3, 0) = DST(2, 2) = avg2(D, E);
  DST(0, 1) = avg3(A, B, C);
  DST(1, 1) = DST(0, 3) = avg3(B, C, D);
  DST(2, 1) = DST(1, 3) = avg3(C, D, E);
  DST(3, 1) = DST(2, 3) = avg3(D, E, F);
  DST(3, 2) = avg3(E, F, G);
  DST(3, 3) = avg3(F, G, H);
}

void hu4(uint8_t *dst) {
  const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS];
  const int L = dst[-1 + 3 * BPS];
  DST(0, 0) = avg2(I, J);
  DST(2, 0) = DST(0, 1) = avg2(J, K);
  DST(2, 1) = DST(0, 2) = avg2(K, L);
  DST(1, 0) = avg3(I, J, K);
  DST(3, 0) = DST(1, 1) = avg3(J, K, L);
  DST(3, 1) = DST(1, 2) = avg3(K, L, L);
  DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = (uint8_t)L;
}

void hd4(uint8_t *dst) {
  const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS];
  const int L = dst[-1 + 3 * BPS], X = dst[-1 - BPS];
  const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS];
  DST(0, 0) = DST(2, 1) = avg2(I, X);
  DST(0, 1) = DST(2, 2) = avg2(J, I);
  DST(0, 2) = DST(2, 3) = avg2(K, J);
  DST(0, 3) = avg2(L, K);
  DST(3, 0) = avg3(A, B, C);
  DST(2, 0) = avg3(X, A, B);
  DST(1, 0) = DST(3, 1) = avg3(I, X, A);
  DST(1, 1) = DST(3, 2) = avg3(J, I, X);
  DST(1, 2) = DST(3, 3) = avg3(K, J, I);
  DST(1, 3) = avg3(L, K, J);
}
#undef DST

void tm4(uint8_t *dst) { true_motion(dst, 4); }

typedef void (*PredFunc)(uint8_t *);
// VP8PredLuma4, in the order of the modes
const PredFunc kPredLuma4[10] = {dc4, tm4, ve4, he4, rd4, vr4, ld4, vl4, hd4, hu4};

inline void fill(uint8_t *dst, int v, int size) {
  for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, v, size);
}

// VP8PredLuma16 (size 16) and VP8PredChroma8 (size 8): DC, TM, VE, HE and
// DC without the top, the left or both
template <int SIZE>
void predict_block(int mode, uint8_t *dst) {
  const int shift = SIZE == 16 ? 4 : 3;
  switch (mode) {
    case DC_PRED: {
      int dc = SIZE;
      for (int j = 0; j < SIZE; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      fill(dst, dc >> (shift + 1), SIZE);
      break;
    }
    case TM_PRED: true_motion(dst, SIZE); break;
    case V_PRED:
      for (int j = 0; j < SIZE; ++j) std::memcpy(dst + j * BPS, dst - BPS, SIZE);
      break;
    case H_PRED:
      for (int j = 0; j < SIZE; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], SIZE);
      break;
    case DC_PRED_NOTOP: {
      int dc = SIZE / 2;
      for (int j = 0; j < SIZE; ++j) dc += dst[-1 + j * BPS];
      fill(dst, dc >> shift, SIZE);
      break;
    }
    case DC_PRED_NOLEFT: {
      int dc = SIZE / 2;
      for (int i = 0; i < SIZE; ++i) dc += dst[i - BPS];
      fill(dst, dc >> shift, SIZE);
      break;
    }
    default: fill(dst, 0x80, SIZE); break;
  }
}

// frame_dec.c: CheckMode, the DC variant at the frame's top and left edges
inline int check_mode(int mb_x, int mb_y, int mode) {
  if (mode == B_DC_PRED) {
    if (mb_x == 0) return mb_y == 0 ? DC_PRED_NOTOPLEFT : DC_PRED_NOLEFT;
    return mb_y == 0 ? DC_PRED_NOTOP : DC_PRED;
  }
  return mode;
}

// --- dsp/dec.c: the loop filters ---

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // VP8ksclip1
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // VP8ksclip2

// DoFilter2_C: 4 pixels in, 2 out
inline void do_filter2(uint8_t *p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8b(p0 + a2);
  p[0] = clip8b(q0 - a1);
}

// DoFilter4_C: 4 pixels in, 4 out
inline void do_filter4(uint8_t *p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8b(p1 + a3);
  p[-step] = clip8b(p0 + a2);
  p[0] = clip8b(q0 - a1);
  p[step] = clip8b(q1 - a3);
}

// DoFilter6_C: 6 pixels in, 6 out
inline void do_filter6(uint8_t *p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8b(p2 + a3);
  p[-2 * step] = clip8b(p1 + a2);
  p[-step] = clip8b(p0 + a1);
  p[0] = clip8b(q0 - a1);
  p[step] = clip8b(q1 - a2);
  p[2 * step] = clip8b(q2 - a3);
}

inline bool hev(const uint8_t *p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

// NeedsFilter_C
inline bool needs_filter(const uint8_t *p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

// NeedsFilter2_C
inline bool needs_filter2(const uint8_t *p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// SimpleVFilter16_C (step ``stride``, along a row) and SimpleHFilter16_C
// (step 1, down a column)
inline void simple_filter16(uint8_t *p, int step, int along, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i) {
    if (needs_filter(p + i * along, step, thresh2)) do_filter2(p + i * along, step);
  }
}

// FilterLoop26_C (macroblock edges) and FilterLoop24_C (inner edges)
template <bool EDGE>
inline void filter_loop(uint8_t *p, int hstride, int vstride, int size, int thresh, int ithresh,
                        int hev_thresh) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) {
        do_filter2(p, hstride);
      } else if (EDGE) {
        do_filter6(p, hstride);
      } else {
        do_filter4(p, hstride);
      }
    }
    p += vstride;
  }
}

// --- the frame: vp8_dec.c, tree_dec.c, quant_dec.c, frame_dec.c ---

struct QuantMatrix {
  int y1[2], y2[2], uv[2];  // DC, AC
};

struct FilterInfo {  // VP8FInfo
  uint8_t limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};

struct MBData {  // VP8MBData
  int16_t coeffs[384];
  uint8_t is_i4x4 = 0, imodes[16] = {0}, uvmode = 0, segment = 0, skip = 0;
  uint32_t non_zero_y = 0, non_zero_uv = 0;
};

struct TopSamples {  // VP8TopSamples: the unfiltered last row of the macroblock above
  uint8_t y[16], u[8], v[8];
};

struct Planes {
  int width = 0, height = 0, y_stride = 0, uv_stride = 0;
  std::vector<uint8_t> y, u, v;  // whole macroblocks
};

class Vp8Decoder {
 public:
  // VP8GetHeaders and VP8Decode over a "VP8 " chunk's payload (its pad
  // byte included, as libwebp is given it); the planes reconstructed and
  // loop-filtered
  Planes decode(const uint8_t *data, size_t size) {
    headers(data, size);
    Planes out;
    out.width = width_;
    out.height = height_;
    out.y_stride = mb_w_ * 16;
    out.uv_stride = mb_w_ * 8;
    out.y.assign((size_t)out.y_stride * mb_h_ * 16, 0);
    out.u.assign((size_t)out.uv_stride * mb_h_ * 8, 0);
    out.v.assign((size_t)out.uv_stride * mb_h_ * 8, 0);
    frame(out);
    if (filter_type_ > 0) {
      for (int mb_y = 0; mb_y < mb_h_; ++mb_y)
        for (int mb_x = 0; mb_x < mb_w_; ++mb_x) filter_mb(out, mb_x, mb_y);
    }
    return out;
  }

 private:
  int width_ = 0, height_ = 0, mb_w_ = 0, mb_h_ = 0;
  BoolDecoder br_;
  BoolDecoder parts_[8];
  int num_parts_ = 1;
  // the segment header (ResetSegmentHeader's defaults)
  bool use_segment_ = false, update_map_ = false, absolute_delta_ = true;
  int quantizer_[4] = {0}, filter_strength_[4] = {0};
  uint8_t segment_proba_[3] = {255, 255, 255};
  // the filter header
  bool simple_ = false, use_lf_delta_ = false;
  int level_ = 0, sharpness_ = 0, ref_lf_delta_[4] = {0}, mode_lf_delta_[4] = {0};
  int filter_type_ = 0;  // 0 none, 1 simple, 2 normal
  QuantMatrix dqm_[4];
  uint8_t proba_[4][8][3][11];
  bool use_skip_proba_ = false;
  int skip_p_ = 0;
  FilterInfo fstrengths_[4][2];
  // per column: the contexts of the row above; [0] is the left's
  std::vector<uint8_t> intra_t_;
  uint8_t intra_l_[4];
  std::vector<uint8_t> nz_, nz_dc_;  // mb_w + 1, [0] the left
  std::vector<MBData> mb_data_;      // the row being decoded
  std::vector<FilterInfo> f_info_;   // every macroblock
  std::vector<TopSamples> yuv_t_;
  uint8_t yuv_b_[kYuvSize];

  void headers(const uint8_t *buf, size_t buf_size) {
    if (buf_size < 4) corrupt("Truncated header.");
    const uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
    const bool key_frame = !(bits & 1);
    const int profile = (bits >> 1) & 7;
    const bool show = (bits >> 4) & 1;
    const uint32_t partition_length = bits >> 5;
    if (profile > 3) corrupt("Incorrect keyframe parameters.");
    if (!show) corrupt("Frame not displayable.");
    buf += 3;
    buf_size -= 3;
    if (key_frame) {
      if (buf_size < 7) corrupt("cannot parse picture header");
      if (!(buf[0] == 0x9d && buf[1] == 0x01 && buf[2] == 0x2a)) corrupt("Bad code word");
      width_ = ((buf[4] << 8) | buf[3]) & 0x3fff;
      height_ = ((buf[6] << 8) | buf[5]) & 0x3fff;
      buf += 7;
      buf_size -= 7;
      mb_w_ = (width_ + 15) >> 4;
      mb_h_ = (height_ + 15) >> 4;
    }
    if (partition_length > buf_size) corrupt("bad partition length");
    br_.init(buf, partition_length);
    buf += partition_length;
    buf_size -= partition_length;
    if (key_frame) {
      br_.value_bits(1);  // colour space
      br_.value_bits(1);  // clamping type
    }
    // ParseSegmentHeader
    use_segment_ = br_.value_bits(1);
    if (use_segment_) {
      update_map_ = br_.value_bits(1);
      if (br_.value_bits(1)) {  // update data
        absolute_delta_ = br_.value_bits(1);
        for (int s = 0; s < 4; ++s) quantizer_[s] = br_.value_bits(1) ? br_.signed_value(7) : 0;
        for (int s = 0; s < 4; ++s)
          filter_strength_[s] = br_.value_bits(1) ? br_.signed_value(6) : 0;
      }
      if (update_map_) {
        for (int s = 0; s < 3; ++s)
          segment_proba_[s] = (uint8_t)(br_.value_bits(1) ? br_.value_bits(8) : 255);
      }
    } else {
      update_map_ = false;
    }
    if (br_.eof) corrupt("cannot parse segment header");
    // ParseFilterHeader
    simple_ = br_.value_bits(1);
    level_ = br_.value_bits(6);
    sharpness_ = br_.value_bits(3);
    use_lf_delta_ = br_.value_bits(1);
    if (use_lf_delta_) {
      if (br_.value_bits(1)) {  // update lf-delta?
        for (int i = 0; i < 4; ++i)
          if (br_.value_bits(1)) ref_lf_delta_[i] = br_.signed_value(6);
        for (int i = 0; i < 4; ++i)
          if (br_.value_bits(1)) mode_lf_delta_[i] = br_.signed_value(6);
      }
    }
    filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
    if (br_.eof) corrupt("cannot parse filter header");
    // ParsePartitions: 1, 2, 4 or 8, the sizes of all but the last in 3
    // bytes each; a size past the data is cut to it, and the last must not
    // be empty
    {
      const uint8_t *sz = buf;
      const uint8_t *buf_end = buf + buf_size;
      num_parts_ = 1 << br_.value_bits(2);
      const size_t last_part = (size_t)num_parts_ - 1;
      if (buf_size < 3 * last_part) corrupt("cannot parse partitions");
      const uint8_t *part_start = buf + last_part * 3;
      size_t size_left = buf_size - last_part * 3;
      for (size_t p = 0; p < last_part; ++p) {
        size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
        if (psize > size_left) psize = size_left;
        parts_[p].init(part_start, psize);
        part_start += psize;
        size_left -= psize;
        sz += 3;
      }
      parts_[last_part].init(part_start, size_left);
      if (!(part_start < buf_end)) corrupt("cannot parse partitions");
    }
    parse_quant();
    if (!key_frame) corrupt("Not a key frame.");
    br_.value_bits(1);  // update_proba, ignored
    parse_proba();
  }

  // VP8ParseQuant
  void parse_quant() {
    const int base_q0 = br_.value_bits(7);
    const int dqy1_dc = br_.value_bits(1) ? br_.signed_value(4) : 0;
    const int dqy2_dc = br_.value_bits(1) ? br_.signed_value(4) : 0;
    const int dqy2_ac = br_.value_bits(1) ? br_.signed_value(4) : 0;
    const int dquv_dc = br_.value_bits(1) ? br_.signed_value(4) : 0;
    const int dquv_ac = br_.value_bits(1) ? br_.signed_value(4) : 0;
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int i = 0; i < 4; ++i) {
      int q;
      if (use_segment_) {
        q = quantizer_[i];
        if (!absolute_delta_) q += base_q0;
      } else if (i > 0) {
        dqm_[i] = dqm_[0];
        continue;
      } else {
        q = base_q0;
      }
      QuantMatrix &m = dqm_[i];
      m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
      m.y1[1] = kAcTable[clip(q + 0, 127)];
      m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      // x * 155 / 100 as (x * 101581) >> 16, at least 8
      m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
      m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
    }
  }

  // VP8ParseProba
  void parse_proba() {
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p)
            proba_[t][b][c][p] = (uint8_t)(br_.bit(kCoeffsUpdateProba[t][b][c][p])
                                               ? br_.value_bits(8)
                                               : kCoeffsProba0[t][b][c][p]);
    use_skip_proba_ = br_.value_bits(1);
    if (use_skip_proba_) skip_p_ = br_.value_bits(8);
  }

  // PrecomputeFilterStrengths
  void filter_strengths() {
    if (filter_type_ == 0) return;
    for (int s = 0; s < 4; ++s) {
      int base_level;
      if (use_segment_) {
        base_level = filter_strength_[s];
        if (!absolute_delta_) base_level += level_;
      } else {
        base_level = level_;
      }
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FilterInfo &info = fstrengths_[s][i4x4];
        int level = base_level;
        if (use_lf_delta_) {
          level += ref_lf_delta_[0];
          if (i4x4) level += mode_lf_delta_[0];
        }
        level = level < 0 ? 0 : level > 63 ? 63 : level;
        if (level > 0) {
          int ilevel = level;
          if (sharpness_ > 0) {
            ilevel >>= sharpness_ > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = (uint8_t)ilevel;
          info.limit = (uint8_t)(2 * level + ilevel);
          info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
        } else {
          info.limit = 0;  // no filtering
        }
        info.inner = (uint8_t)i4x4;
      }
    }
  }

  // ParseIntraMode
  void parse_intra_mode(int mb_x) {
    BoolDecoder &br = br_;
    uint8_t *const top = intra_t_.data() + 4 * mb_x;
    uint8_t *const left = intra_l_;
    MBData &block = mb_data_[mb_x];
    if (update_map_) {
      block.segment = !br.bit(segment_proba_[0]) ? (uint8_t)br.bit(segment_proba_[1])
                                                 : (uint8_t)(br.bit(segment_proba_[2]) + 2);
    } else {
      block.segment = 0;
    }
    if (use_skip_proba_) block.skip = (uint8_t)br.bit(skip_p_);
    block.is_i4x4 = !br.bit(145);
    if (!block.is_i4x4) {
      const int ymode = br.bit(156) ? (br.bit(128) ? TM_PRED : H_PRED)
                                    : (br.bit(163) ? V_PRED : DC_PRED);
      block.imodes[0] = (uint8_t)ymode;
      std::memset(top, ymode, 4);
      std::memset(left, ymode, 4);
    } else {
      uint8_t *modes = block.imodes;
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t *const prob = kBModesProba[top[x]][ymode];
          ymode = !br.bit(prob[0])   ? B_DC_PRED
                  : !br.bit(prob[1]) ? B_TM_PRED
                  : !br.bit(prob[2]) ? B_VE_PRED
                  : !br.bit(prob[3])
                      ? (!br.bit(prob[4]) ? B_HE_PRED : (!br.bit(prob[5]) ? B_RD_PRED : B_VR_PRED))
                      : (!br.bit(prob[6])   ? B_LD_PRED
                         : !br.bit(prob[7]) ? B_VL_PRED
                         : !br.bit(prob[8]) ? B_HD_PRED
                                            : B_HU_PRED);
          top[x] = (uint8_t)ymode;
        }
        std::memcpy(modes, top, 4);
        modes += 4;
        left[y] = (uint8_t)ymode;
      }
    }
    block.uvmode = !br.bit(142)   ? DC_PRED
                   : !br.bit(114) ? V_PRED
                   : br.bit(183)  ? TM_PRED
                                  : H_PRED;
  }

  // GetLargeValue: a coefficient of 2 or more (RFC 6386 13.2)
  static int large_value(BoolDecoder &br, const uint8_t *p) {
    int v;
    if (!br.bit(p[3])) {
      if (!br.bit(p[4])) {
        v = 2;
      } else {
        v = 3 + br.bit(p[5]);
      }
    } else {
      if (!br.bit(p[6])) {
        if (!br.bit(p[7])) {
          v = 5 + br.bit(159);
        } else {
          v = 7 + 2 * br.bit(165);
          v += br.bit(145);
        }
      } else {
        const int bit1 = br.bit(p[8]);
        const int bit0 = br.bit(p[9 + bit1]);
        const int cat = 2 * bit1 + bit0;
        v = 0;
        for (const uint8_t *tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
        v += 3 + (8 << cat);
      }
    }
    return v;
  }

  // GetCoeffs: the tokens of one block of type ``t`` from position ``n``
  // into ``out`` (zigzag, dequantized, stored as int16_t as libwebp does);
  // returns the position past the last coefficient read
  int coeffs(BoolDecoder &br, int t, int ctx, const int *dq, int n, int16_t *out) {
    const uint8_t *p = proba_[t][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!br.bit(p[0])) return n;  // the end of the block
      while (!br.bit(p[1])) {       // a run of zeros
        p = proba_[t][kBands[++n]][0];
        if (n == 16) return 16;
      }
      int v;
      const int next_band = kBands[n + 1];
      if (!br.bit(p[2])) {
        v = 1;
        p = proba_[t][next_band][1];
      } else {
        v = large_value(br, p);
        p = proba_[t][next_band][2];
      }
      out[kZigzag[n]] = (int16_t)(br.sign(v) * dq[n > 0]);
    }
    return 16;
  }

  static inline uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
    nz_coeffs <<= 2;
    nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
    return nz_coeffs;
  }

  // ParseResiduals; returns whether the macroblock has no coefficient
  bool residuals(int mb_x, BoolDecoder &br) {
    MBData &block = mb_data_[mb_x];
    const QuantMatrix &q = dqm_[block.segment];
    int16_t *dst = block.coeffs;
    uint8_t &mb_nz = nz_[mb_x + 1], &left_nz = nz_[0];
    uint8_t &mb_nz_dc = nz_dc_[mb_x + 1], &left_nz_dc = nz_dc_[0];
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    int first, ac_type;
    std::memset(dst, 0, 384 * sizeof(*dst));
    if (!block.is_i4x4) {  // the Y2 block of the DCs
      int16_t dc[16] = {0};
      const int ctx = mb_nz_dc + left_nz_dc;
      const int nz = coeffs(br, 1, ctx, q.y2, 0, dc);
      mb_nz_dc = left_nz_dc = (uint8_t)(nz > 0);
      if (nz > 1) {
        transform_wht(dc, dst);
      } else {  // only the DC: the transform inlined
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 16 * 16; i += 16) dst[i] = (int16_t)dc0;
      }
      first = 1;
      ac_type = 0;
    } else {
      first = 0;
      ac_type = 3;
    }
    uint8_t tnz = mb_nz & 0x0f;
    uint8_t lnz = left_nz & 0x0f;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      uint32_t nz_coeffs = 0;
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = coeffs(br, ac_type, ctx, q.y1, first, dst);
        l = nz > first;
        tnz = (uint8_t)((tnz >> 1) | (l << 7));
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 4;
      lnz = (uint8_t)((lnz >> 1) | (l << 7));
      non_zero_y = (non_zero_y << 8) | nz_coeffs;
    }
    uint32_t out_t_nz = tnz;
    uint32_t out_l_nz = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t nz_coeffs = 0;
      tnz = (uint8_t)(mb_nz >> (4 + ch));
      lnz = (uint8_t)(left_nz >> (4 + ch));
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + (tnz & 1);
          const int nz = coeffs(br, 2, ctx, q.uv, 0, dst);
          l = nz > 0;
          tnz = (uint8_t)((tnz >> 1) | (l << 3));
          nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
          dst += 16;
        }
        tnz >>= 2;
        lnz = (uint8_t)((lnz >> 1) | (l << 5));
      }
      non_zero_uv |= nz_coeffs << (4 * ch);
      out_t_nz |= (uint32_t)(tnz << 4) << ch;
      out_l_nz |= (uint32_t)(lnz & 0xf0) << ch;
    }
    mb_nz = (uint8_t)out_t_nz;
    left_nz = (uint8_t)out_l_nz;
    block.non_zero_y = non_zero_y;
    block.non_zero_uv = non_zero_uv;
    return !(non_zero_y | non_zero_uv);
  }

  // VP8DecodeMB
  void decode_mb(int mb_x, int mb_y, BoolDecoder &token_br) {
    MBData &block = mb_data_[mb_x];
    bool skip = use_skip_proba_ ? block.skip : false;
    if (!skip) {
      skip = residuals(mb_x, token_br);
    } else {
      nz_[0] = nz_[mb_x + 1] = 0;
      if (!block.is_i4x4) nz_dc_[0] = nz_dc_[mb_x + 1] = 0;
      block.non_zero_y = 0;
      block.non_zero_uv = 0;
    }
    if (filter_type_ > 0) {
      FilterInfo &finfo = f_info_[(size_t)mb_y * mb_w_ + mb_x];
      finfo = fstrengths_[block.segment][block.is_i4x4];
      finfo.inner |= (uint8_t)!skip;
    }
  }

  // ParseFrame: each row's modes from partition 0, then each macroblock's
  // residuals from the row's token partition, reconstructed in turn
  void frame(Planes &out) {
    filter_strengths();
    intra_t_.assign(4 * (size_t)mb_w_, B_DC_PRED);
    nz_.assign(mb_w_ + 1, 0);
    nz_dc_.assign(mb_w_ + 1, 0);
    mb_data_.assign(mb_w_, MBData());
    f_info_.assign((size_t)mb_w_ * mb_h_, FilterInfo());
    yuv_t_.assign(mb_w_, TopSamples());
    std::memset(yuv_b_, 0, sizeof(yuv_b_));
    for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
      BoolDecoder &token_br = parts_[mb_y & (num_parts_ - 1)];
      std::memset(intra_l_, B_DC_PRED, sizeof(intra_l_));
      nz_[0] = 0;
      nz_dc_[0] = 0;
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) parse_intra_mode(mb_x);
      if (br_.eof) corrupt("Premature end-of-partition0 encountered.");
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        decode_mb(mb_x, mb_y, token_br);
        if (token_br.eof) corrupt("Premature end-of-file encountered.");
      }
      reconstruct_row(out, mb_y);
    }
  }

  // ReconstructRow: prediction and residuals in the work area, with 127
  // above the frame, 129 left of it, the top-right samples of the row above
  // reused down the macroblock's right column of 4 x 4 blocks
  void reconstruct_row(Planes &out, int mb_y) {
    uint8_t *const y_dst = yuv_b_ + kYOff;
    uint8_t *const u_dst = yuv_b_ + kUOff;
    uint8_t *const v_dst = yuv_b_ + kVOff;
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) {
      u_dst[j * BPS - 1] = 129;
      v_dst[j * BPS - 1] = 129;
    }
    if (mb_y > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
      std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      std::memset(u_dst - BPS - 1, 127, 8 + 1);
      std::memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
      const MBData &block = mb_data_[mb_x];
      if (mb_x > 0) {  // the left samples from the macroblock before
        for (int j = -1; j < 16; ++j) std::memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
        for (int j = -1; j < 8; ++j) {
          std::memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
          std::memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
        }
      }
      TopSamples *const top_yuv = yuv_t_.data() + mb_x;
      const int16_t *const coeffs = block.coeffs;
      uint32_t bits = block.non_zero_y;
      if (mb_y > 0) {
        std::memcpy(y_dst - BPS, top_yuv[0].y, 16);
        std::memcpy(u_dst - BPS, top_yuv[0].u, 8);
        std::memcpy(v_dst - BPS, top_yuv[0].v, 8);
      }
      if (block.is_i4x4) {
        uint8_t *const top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w_ - 1) {  // the rightmost macroblock
            std::memset(top_right, top_yuv[0].y[15], 4);
          } else {
            std::memcpy(top_right, top_yuv[1].y, 4);
          }
        }
        // the top-right samples replicated below, for the right column
        for (int k = 1; k <= 3; ++k) std::memcpy(top_right + 4 * k * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n, bits <<= 2) {
          uint8_t *const dst = y_dst + kScan[n];
          kPredLuma4[block.imodes[n]](dst);
          do_transform(bits, coeffs + n * 16, dst);
        }
      } else {
        predict_block<16>(check_mode(mb_x, mb_y, block.imodes[0]), y_dst);
        if (bits != 0) {
          for (int n = 0; n < 16; ++n, bits <<= 2) do_transform(bits, coeffs + n * 16, y_dst + kScan[n]);
        }
      }
      const uint32_t bits_uv = block.non_zero_uv;
      const int uv_mode = check_mode(mb_x, mb_y, block.uvmode);
      predict_block<8>(uv_mode, u_dst);
      predict_block<8>(uv_mode, v_dst);
      do_uv_transform(bits_uv >> 0, coeffs + 16 * 16, u_dst);
      do_uv_transform(bits_uv >> 8, coeffs + 20 * 16, v_dst);
      if (mb_y < mb_h_ - 1) {  // the unfiltered samples for the row below
        std::memcpy(top_yuv[0].y, y_dst + 15 * BPS, 16);
        std::memcpy(top_yuv[0].u, u_dst + 7 * BPS, 8);
        std::memcpy(top_yuv[0].v, v_dst + 7 * BPS, 8);
      }
      uint8_t *const y_out = out.y.data() + (size_t)mb_y * 16 * out.y_stride + mb_x * 16;
      uint8_t *const u_out = out.u.data() + (size_t)mb_y * 8 * out.uv_stride + mb_x * 8;
      uint8_t *const v_out = out.v.data() + (size_t)mb_y * 8 * out.uv_stride + mb_x * 8;
      for (int j = 0; j < 16; ++j) std::memcpy(y_out + (size_t)j * out.y_stride, y_dst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(u_out + (size_t)j * out.uv_stride, u_dst + j * BPS, 8);
        std::memcpy(v_out + (size_t)j * out.uv_stride, v_dst + j * BPS, 8);
      }
    }
  }

  // DoFilter: the macroblock's left edge, its inner vertical edges, its top
  // edge and its inner horizontal edges, in that order
  void filter_mb(Planes &out, int mb_x, int mb_y) {
    const FilterInfo &f = f_info_[(size_t)mb_y * mb_w_ + mb_x];
    const int limit = f.limit;
    if (limit == 0) return;
    const int ys = out.y_stride;
    uint8_t *const y_dst = out.y.data() + (size_t)mb_y * 16 * ys + mb_x * 16;
    if (filter_type_ == 1) {  // simple
      if (mb_x > 0) simple_filter16(y_dst, 1, ys, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simple_filter16(y_dst + 4 * k, 1, ys, limit);
      if (mb_y > 0) simple_filter16(y_dst, ys, 1, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simple_filter16(y_dst + 4 * k * ys, ys, 1, limit);
      return;
    }
    const int uvs = out.uv_stride;
    uint8_t *const u_dst = out.u.data() + (size_t)mb_y * 8 * uvs + mb_x * 8;
    uint8_t *const v_dst = out.v.data() + (size_t)mb_y * 8 * uvs + mb_x * 8;
    const int ilevel = f.ilevel, hev_t = f.hev_thresh;
    if (mb_x > 0) {  // HFilter16, HFilter8
      filter_loop<true>(y_dst, 1, ys, 16, limit + 4, ilevel, hev_t);
      filter_loop<true>(u_dst, 1, uvs, 8, limit + 4, ilevel, hev_t);
      filter_loop<true>(v_dst, 1, uvs, 8, limit + 4, ilevel, hev_t);
    }
    if (f.inner) {  // HFilter16i, HFilter8i
      for (int k = 1; k <= 3; ++k) filter_loop<false>(y_dst + 4 * k, 1, ys, 16, limit, ilevel, hev_t);
      filter_loop<false>(u_dst + 4, 1, uvs, 8, limit, ilevel, hev_t);
      filter_loop<false>(v_dst + 4, 1, uvs, 8, limit, ilevel, hev_t);
    }
    if (mb_y > 0) {  // VFilter16, VFilter8
      filter_loop<true>(y_dst, ys, 1, 16, limit + 4, ilevel, hev_t);
      filter_loop<true>(u_dst, uvs, 1, 8, limit + 4, ilevel, hev_t);
      filter_loop<true>(v_dst, uvs, 1, 8, limit + 4, ilevel, hev_t);
    }
    if (f.inner) {  // VFilter16i, VFilter8i
      for (int k = 1; k <= 3; ++k)
        filter_loop<false>(y_dst + 4 * k * ys, ys, 1, 16, limit, ilevel, hev_t);
      filter_loop<false>(u_dst + 4 * uvs, uvs, 1, 8, limit, ilevel, hev_t);
      filter_loop<false>(v_dst + 4 * uvs, uvs, 1, 8, limit, ilevel, hev_t);
    }
  }
};

// --- the output: dsp/yuv.h (VP8YuvToRgb, 14-bit fixed point) and
// dsp/upsampling.c (UpsampleRgbaLinePair, the "fancy" upsampler) ---

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) {  // VP8Clip8
  const int kMask = (256 << 6) - 1;
  return (uint8_t)(((v & ~kMask) == 0) ? (v >> 6) : (v < 0) ? 0 : 255);
}
inline void yuv_to_rgb(int y, int u, int v, uint8_t *rgb) {
  rgb[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// UPSAMPLE_FUNC: two output rows from a luma row pair and the chroma rows
// above and below them, u and v packed in one word as libwebp does;
// ``bottom_y`` NULL for a single row.  Writes RGB triplets
void upsample_pair(const uint8_t *top_y, const uint8_t *bottom_y, const uint8_t *top_u,
                   const uint8_t *top_v, const uint8_t *cur_u, const uint8_t *cur_v,
                   uint8_t *top_dst, uint8_t *bottom_dst, int len) {
  auto load_uv = [](int u, int v) { return (uint32_t)u | ((uint32_t)v << 16); };
  const int last_pixel_pair = (len - 1) >> 1;
  uint32_t tl_uv = load_uv(top_u[0], top_v[0]);
  uint32_t l_uv = load_uv(cur_u[0], cur_v[0]);
  {
    const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
    yuv_to_rgb(top_y[0], uv0 & 0xff, (uv0 >> 16), top_dst);
  }
  if (bottom_y != nullptr) {
    const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
    yuv_to_rgb(bottom_y[0], uv0 & 0xff, (uv0 >> 16), bottom_dst);
  }
  for (int x = 1; x <= last_pixel_pair; ++x) {
    const uint32_t t_uv = load_uv(top_u[x], top_v[x]);
    const uint32_t uv = load_uv(cur_u[x], cur_v[x]);
    const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
    {
      const uint32_t uv0 = (diag_12 + tl_uv) >> 1;
      const uint32_t uv1 = (diag_03 + t_uv) >> 1;
      yuv_to_rgb(top_y[2 * x - 1], uv0 & 0xff, (uv0 >> 16), top_dst + (2 * x - 1) * 3);
      yuv_to_rgb(top_y[2 * x - 0], uv1 & 0xff, (uv1 >> 16), top_dst + (2 * x - 0) * 3);
    }
    if (bottom_y != nullptr) {
      const uint32_t uv0 = (diag_03 + l_uv) >> 1;
      const uint32_t uv1 = (diag_12 + uv) >> 1;
      yuv_to_rgb(bottom_y[2 * x - 1], uv0 & 0xff, (uv0 >> 16), bottom_dst + (2 * x - 1) * 3);
      yuv_to_rgb(bottom_y[2 * x + 0], uv1 & 0xff, (uv1 >> 16), bottom_dst + (2 * x + 0) * 3);
    }
    tl_uv = t_uv;
    l_uv = uv;
  }
  if (!(len & 1)) {
    {
      const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
      yuv_to_rgb(top_y[len - 1], uv0 & 0xff, (uv0 >> 16), top_dst + (len - 1) * 3);
    }
    if (bottom_y != nullptr) {
      const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
      yuv_to_rgb(bottom_y[len - 1], uv0 & 0xff, (uv0 >> 16), bottom_dst + (len - 1) * 3);
    }
  }
}

// EmitFancyRGB over the whole frame: row 0 alone on chroma row 0, then the
// pairs (2k - 1, 2k) between chroma rows k - 1 and k, and for an even
// height the last row alone on the last chroma row.  ``out`` gets the
// first ``written`` of R, G, B and (where ``alpha`` is given) A
void emit_rgb(const Planes &p, const uint8_t *alpha, uint8_t *out, int written) {
  const int w = p.width, h = p.height;
  std::vector<uint8_t> rows(2 * (size_t)w * 3);
  uint8_t *const top_rgb = rows.data();
  uint8_t *const bottom_rgb = rows.data() + (size_t)w * 3;
  auto put = [&](int y, const uint8_t *rgb) {
    uint8_t *o = out + (size_t)y * w * written;
    const int colour = written < 3 ? written : 3;
    if (colour == 3 && written == 3) {
      std::memcpy(o, rgb, (size_t)w * 3);
      return;
    }
    for (int x = 0; x < w; ++x) {
      for (int c = 0; c < colour; ++c) o[x * written + c] = rgb[x * 3 + c];
      if (written == 4) o[x * 4 + 3] = alpha ? alpha[(size_t)y * w + x] : 255;
    }
  };
  const uint8_t *Y = p.y.data(), *U = p.u.data(), *V = p.v.data();
  const size_t ys = p.y_stride, uvs = p.uv_stride;
  upsample_pair(Y, nullptr, U, V, U, V, top_rgb, nullptr, w);
  put(0, top_rgb);
  for (int k = 1; 2 * k - 1 < h; ++k) {
    const int y0 = 2 * k - 1, y1 = 2 * k;
    if (y1 < h) {
      upsample_pair(Y + y0 * ys, Y + y1 * ys, U + (k - 1) * uvs, V + (k - 1) * uvs, U + k * uvs,
                    V + k * uvs, top_rgb, bottom_rgb, w);
      put(y0, top_rgb);
      put(y1, bottom_rgb);
    } else {  // the last row of an even height
      upsample_pair(Y + y0 * ys, nullptr, U + (k - 1) * uvs, V + (k - 1) * uvs, U + (k - 1) * uvs,
                    V + (k - 1) * uvs, top_rgb, nullptr, w);
      put(y0, top_rgb);
    }
  }
}

// --- the ALPH chunk: alpha_dec.c (ALPHInit, ALPHDecode), vp8l_dec.c
// (VP8LDecodeAlphaHeader, DecodeAlphaData, ExtractAlphaRows) and
// dsp/filters.c (the unfilters) ---

// HorizontalUnfilter_C, VerticalUnfilter_C and GradientUnfilter_C over a
// row, ``prev`` NULL for the first
void unfilter_row(int filter, const uint8_t *prev, const uint8_t *in, uint8_t *out, int width) {
  if (filter == 0) {
    if (in != out) std::memcpy(out, in, (size_t)width);
    return;
  }
  if (filter == 1 || prev == nullptr) {
    uint8_t pred = prev == nullptr ? 0 : prev[0];
    for (int i = 0; i < width; ++i) {
      out[i] = (uint8_t)(pred + in[i]);
      pred = out[i];
    }
  } else if (filter == 2) {
    for (int i = 0; i < width; ++i) out[i] = (uint8_t)(prev[i] + in[i]);
  } else {
    uint8_t top = prev[0], top_left = top, left = top;
    for (int i = 0; i < width; ++i) {
      top = prev[i];
      const int g = left + top - top_left;
      left = (uint8_t)(in[i] + ((g & ~0xff) == 0 ? g : g < 0 ? 0 : 255));
      top_left = top;
      out[i] = left;
    }
  }
}

// The alpha plane (width x height) of an ALPH chunk's payload; throws
// where libwebp fails the frame ("Alpha decoder initialization failed.",
// "Could not decode alpha data.")
std::vector<uint8_t> decode_alpha(const uint8_t *data, size_t size, int width, int height) {
  if (size <= 1) corrupt("Alpha decoder initialization failed.");
  const int method = data[0] & 0x03;
  const int filter = (data[0] >> 2) & 0x03;
  const int pre_processing = (data[0] >> 4) & 0x03;
  const int reserved = (data[0] >> 6) & 0x03;
  if (method > 1 || pre_processing > 1 || reserved != 0) {
    corrupt("Alpha decoder initialization failed.");
  }
  const size_t n = (size_t)width * height;
  std::vector<uint8_t> plane(n);
  if (method == 0) {  // raw
    if (size - 1 < n) corrupt("Alpha decoder initialization failed.");
    std::memcpy(plane.data(), data + 1, n);
  } else {  // a VP8L image stream without its header, alpha in green
    Decoder dec(data + 1, size - 1);
    int xsize = width;
    // Is8bOptimizable: a colour-indexed stream without colour cache whose
    // red, blue and alpha codes read no bits decodes to bytes, where the
    // stream may end inside the last pixel
    dec.alpha_stream = true;
    std::unique_ptr<uint32_t[]> px = dec.image_stream(xsize, height, true);
    for (size_t k = dec.transforms.size(); k-- > 0;) apply_inverse(dec.transforms[k], px);
    for (size_t i = 0; i < n; ++i) plane[i] = (uint8_t)(px[i] >> 8);
  }
  // the unfilters, row by row over the rows before
  for (int y = 0; y < height; ++y) {
    uint8_t *row = plane.data() + (size_t)y * width;
    unfilter_row(filter, y == 0 ? nullptr : row - width, row, row, width);
  }
  return plane;
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

// Runs a decode: its return code, or that of the WebpError or failed
// allocation it throws, with the message (empty on success)
template <typename Body>
int guarded(char *message, int64_t message_size, Body body) {
  auto say = [&](const char *text) {
    if (message_size > 0) {
      std::strncpy(message, text, (size_t)message_size - 1);
      message[message_size - 1] = 0;
    }
  };
  try {
    say("");
    return body();
  } catch (const WebpError &e) {
    say(e.message.c_str());
    return e.code;
  } catch (const std::bad_alloc &) {
    say("out of memory");
    return (int)WEBP_CORRUPT;
  }
}

}  // namespace

extern "C" {

int webp_decode(const uint8_t *src, int64_t n, uint8_t *out, int64_t capacity, int32_t *info,
                char *message, int64_t message_size) {
  return guarded(message, message_size, [&]() {
    const Frame frame = parse_container(src, (size_t)n);
    const int channels = frame.has_alpha ? 4 : 3;
    const int written = info[3] >= 1 && info[3] < channels ? info[3] : channels;
    info[0] = frame.width;
    info[1] = frame.height;
    info[2] = channels;
    const int64_t need = (int64_t)frame.width * frame.height * written;
    if (out == nullptr || capacity < need) return (int)WEBP_NEED_SPACE;
    if (frame.lossy) {
      // DecodeInto: the frame, then its alpha (a failure of either fails
      // the frame), emitted as RGB(A)
      Vp8Decoder dec;
      const Planes planes = dec.decode(frame.payload, frame.payload_size);
      std::vector<uint8_t> alpha;
      if (frame.alpha) alpha = decode_alpha(frame.alpha, frame.alpha_size, frame.width, frame.height);
      emit_rgb(planes, alpha.empty() ? nullptr : alpha.data(), out, written);
      return (int)WEBP_OK;
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
    return (int)WEBP_OK;
  });
}

int webp_decode_planes(const uint8_t *src, int64_t n, uint8_t *y, uint8_t *u, uint8_t *v,
                       int32_t *info, char *message, int64_t message_size) {
  return guarded(message, message_size, [&]() {
    const Frame frame = parse_container(src, (size_t)n);
    info[0] = frame.width;
    info[1] = frame.height;
    if (!frame.lossy) unsupported("a lossless WebP (VP8L) has no YUV planes");
    if (y == nullptr) return (int)WEBP_NEED_SPACE;
    Vp8Decoder dec;
    const Planes p = dec.decode(frame.payload, frame.payload_size);
    const int uv_w = (p.width + 1) / 2, uv_h = (p.height + 1) / 2;
    for (int j = 0; j < p.height; ++j)
      std::memcpy(y + (size_t)j * p.width, p.y.data() + (size_t)j * p.y_stride, (size_t)p.width);
    for (int j = 0; j < uv_h; ++j) {
      std::memcpy(u + (size_t)j * uv_w, p.u.data() + (size_t)j * p.uv_stride, (size_t)uv_w);
      std::memcpy(v + (size_t)j * uv_w, p.v.data() + (size_t)j * p.uv_stride, (size_t)uv_w);
    }
    return (int)WEBP_OK;
  });
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
