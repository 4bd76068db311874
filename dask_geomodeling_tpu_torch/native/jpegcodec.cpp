// The port's JPEG codec: a baseline, extended-sequential and progressive
// Huffman decoder and a baseline encoder, both bitwise to libjpeg-turbo as
// Pillow drives it (its default decode: the ISLOW IDCT, fancy upsampling,
// fixed-point colour tables; its default encode: the ISLOW forward DCT,
// quality 75, 4:2:0, the standard Huffman tables).  Each step names the
// libjpeg-turbo routine it follows.
//
// Built with g++ -O3 -shared -fPIC -std=c++17 at first use
// (ops/_build.py) and called through ctypes, which releases the GIL: the
// chunks of one image decode on the codec's thread pool.  No state is kept
// between calls.
//
// Decoding:
//   jpeg_decode(src, n, out, capacity, info, message, message_size)
//   info[0..2] = width, height, channels of the output (1: L, 3: RGB,
//   4: CMYK inverted as Pillow's "CMYK;I" raw mode gives it).  Returns 0,
//   or JPEG_CORRUPT (the stream is broken where libjpeg or Pillow raise),
//   JPEG_UNSUPPORTED (arithmetic coding, lossless, 12-bit samples, block
//   smoothing), JPEG_NEED_SPACE (``capacity`` is below width * height *
//   channels; ``info`` is filled in), with a message.
//
//   Where libjpeg only warns and goes on (an entropy segment cut short by
//   a marker: zero bits, then the scan's remaining MCUs skipped; a code
//   longer than 16 bits: symbol 0) this decoder does the same; a stream
//   that ends before its image is complete raises, as Pillow's suspending
//   source does; a restart marker out of sequence raises (libjpeg
//   resynchronises).
//
//   Block smoothing (jdcoefct.c: smoothing_ok) acts only on a progressive
//   stream whose scans leave one of the first nine AC coefficients
//   unrefined; such a stream is refused (JPEG_UNSUPPORTED), never decoded
//   otherwise than libjpeg would.
//
// Encoding:
//   jpeg_encode(pixels, width, height, channels, quality, h_samp, v_samp,
//               out, capacity)
//   channels 1 (grayscale) or 3 (RGB, stored as YCbCr with component ids
//   1, 2, 3, the luma sampled h_samp x v_samp, the chroma 1 x 1), an APP0
//   JFIF 1.01 marker after SOI.  Returns the bytes written, or -1 when
//   ``capacity`` is too small.
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum { JPEG_OK = 0, JPEG_CORRUPT = -1, JPEG_UNSUPPORTED = -2, JPEG_NEED_SPACE = -3 };

struct JpegError {
  int code;
  std::string message;
};

[[noreturn]] void fail(int code, const std::string &message) { throw JpegError{code, message}; }

// jutils.c: jpeg_natural_order, with 16 extra entries so that a corrupt
// run length cannot index past the block
const int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------- tables

// jdhuff.c: jpeg_make_d_derived_tbl, with a 9-bit lookahead
struct HuffDecode {
  bool defined = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t lookup[1 << 9];  // (length << 8) | symbol, 0 when longer than 9 bits
};

const int kLookahead = 9;

void build_decode_table(HuffDecode &t, bool is_dc) {
  int huffsize[257];
  unsigned int huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; l++) {
    int i = t.bits[l];
    if (p + i > 256) fail(JPEG_CORRUPT, "Bogus Huffman table definition");
    while (i--) huffsize[p++] = l;
  }
  huffsize[p] = 0;
  int numsymbols = p;
  unsigned int code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) {
      huffcode[p++] = code;
      code++;
    }
    if ((int64_t)code >= ((int64_t)1 << si)) fail(JPEG_CORRUPT, "Bogus Huffman table definition");
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (t.bits[l]) {
      t.valoffset[l] = p - (int32_t)huffcode[p];
      p += t.bits[l];
      t.maxcode[l] = (int32_t)huffcode[p - 1];
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.valoffset[17] = 0;
  t.maxcode[17] = 0xFFFFF;
  std::memset(t.lookup, 0, sizeof(t.lookup));
  p = 0;
  for (int l = 1; l <= kLookahead; l++) {
    for (int i = 1; i <= t.bits[l]; i++, p++) {
      int lookbits = (int)(huffcode[p] << (kLookahead - l));
      for (int ctr = 1 << (kLookahead - l); ctr > 0; ctr--) {
        t.lookup[lookbits++] = (uint16_t)((l << 8) | t.vals[p]);
      }
    }
  }
  if (is_dc) {
    for (int i = 0; i < numsymbols; i++) {
      if (t.vals[i] > 15) fail(JPEG_CORRUPT, "Bogus Huffman table definition");
    }
  }
}

// ------------------------------------------------------------ bit reader

// jdhuff.c: jpeg_fill_bit_buffer.  Stuffed zero bytes are dropped; a run
// of 0xFF fill bytes is one; at a marker the reader stops and hands out
// zero bits, and at the end of the data too.  ``real`` counts the buffered
// bits that came from the data: once a read uses a zero bit beyond them,
// a marker means libjpeg's "insufficient data" (a warning) and the end of
// the data a truncated stream (Pillow raises).  A lookahead past them
// (the Huffman decoder's peek) is no read.
struct BitReader {
  const uint8_t *p;
  const uint8_t *end;
  uint64_t buffer = 0;
  int bits = 0;
  int real = 0;
  bool hit_marker = false;
  bool hit_end = false;
  bool insufficient = false;  // zero bits were read at a marker
  bool overrun = false;       // zero bits were read past the end of data

  void fill() {
    while (bits <= 56) {
      if (hit_marker || hit_end) return;
      if (p >= end) {
        hit_end = true;
        return;
      }
      unsigned c = *p;
      if (c == 0xFF) {
        const uint8_t *q = p + 1;
        while (q < end && *q == 0xFF) q++;
        if (q >= end) {
          hit_end = true;
          return;
        }
        if (*q == 0) {
          p = q + 1;
        } else {
          p = q - 1;  // at the 0xFF that starts the marker
          hit_marker = true;
          return;
        }
      } else {
        p++;
      }
      buffer |= (uint64_t)c << (56 - bits);
      bits += 8;
      real += 8;
    }
  }

  inline void ensure(int n) {
    if (bits < n) {
      fill();
      if (bits < n) bits = 64;  // zeros
    }
  }

  inline unsigned peek(int n) { return (unsigned)(buffer >> (64 - n)); }

  inline void skip(int n) {
    buffer <<= n;
    bits -= n;
    real -= n;
    if (real < 0) {
      if (hit_marker) insufficient = true;
      else overrun = true;
    }
  }

  inline unsigned get(int n) {
    if (n == 0) return 0;
    ensure(n);
    unsigned v = peek(n);
    skip(n);
    return v;
  }

  // jdhuff.c: process_restart's bit-buffer reset
  void reset() {
    buffer = 0;
    bits = 0;
    real = 0;
  }
};

inline int extend(int x, int s) { return x < (1 << (s - 1)) ? x + (int)(-1u << s) + 1 : x; }

// jdhuff.c: HUFF_DECODE and jpeg_huff_decode
inline int huff_decode(BitReader &br, const HuffDecode &t) {
  br.ensure(16);
  unsigned look = t.lookup[br.peek(kLookahead)];
  if (look) {
    br.skip(look >> 8);
    return look & 0xFF;
  }
  int l = kLookahead + 1;
  int32_t code = (int32_t)br.peek(l);
  while (l <= 16 && code > t.maxcode[l]) {
    l++;
    code = (int32_t)br.peek(l);
  }
  if (l > 16) {
    // libjpeg: a code of 17 bits or more is a warning; it takes 17 bits
    // and returns symbol 0
    br.skip(16);
    br.get(1);
    return 0;
  }
  br.skip(l);
  return t.vals[(code + t.valoffset[l]) & 0xFF];
}

// ------------------------------------------------------------- decoding

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;        // downsampled width and height (jdinput.c)
  int bw = 0, bh = 0;        // blocks stored: whole MCUs
  int wib = 0, hib = 0;      // width_in_blocks, height_in_blocks
  std::vector<int16_t> coef;  // bw * bh blocks of 64, natural order
  uint16_t qt[64];
  bool qt_latched = false;
  int coef_bits[64];          // jdphuff.c: -1 until a scan covers the coefficient
  int dc_tbl = 0, ac_tbl = 0;
  int last_dc = 0;
};

struct Decoder {
  const uint8_t *data;
  size_t size;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0;
  int precision = 8;
  bool progressive = false, frame_seen = false;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Component comp[4];
  uint16_t qtables[4][64];
  bool qdefined[4] = {false, false, false, false};
  HuffDecode dc_tables[4], ac_tables[4];
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = 0;
  bool eoi = false;
  int scans = 0;

  unsigned u8() {
    if (pos >= size) fail(JPEG_CORRUPT, "image file is truncated");
    return data[pos++];
  }
  unsigned u16() {
    unsigned hi = u8();
    return (hi << 8) | u8();
  }

  // jdmarker.c: next_marker, skipping garbage before a marker
  int next_marker() {
    for (;;) {
      unsigned c = u8();
      while (c != 0xFF) c = u8();
      do {
        c = u8();
      } while (c == 0xFF);
      if (c != 0) return (int)c;
    }
  }

  void read_dqt(size_t end) {
    while (pos < end) {
      unsigned pq = u8();
      unsigned n = pq & 15, prec = pq >> 4;
      if (n > 3) fail(JPEG_CORRUPT, "Bogus DQT index");
      for (int i = 0; i < 64; i++) {
        unsigned value = prec ? u16() : u8();
        qtables[n][kNaturalOrder[i]] = (uint16_t)value;
      }
      qdefined[n] = true;
    }
  }

  void read_dht(size_t end) {
    while (pos + 17 <= end) {
      unsigned index = u8();
      uint8_t bits[17];
      bits[0] = 0;
      int count = 0;
      for (int i = 1; i <= 16; i++) {
        bits[i] = (uint8_t)u8();
        count += bits[i];
      }
      if (count > 256 || pos + count > end) fail(JPEG_CORRUPT, "Bogus Huffman table definition");
      // jdmarker.c: get_dht
      bool is_ac = (index & 0x10) != 0;
      if (is_ac) index -= 0x10;
      if (index > 3) fail(JPEG_CORRUPT, "Bogus DHT index");
      HuffDecode &t = is_ac ? ac_tables[index] : dc_tables[index];
      std::memcpy(t.bits, bits, 17);
      std::memset(t.vals, 0, sizeof(t.vals));
      for (int i = 0; i < count; i++) t.vals[i] = (uint8_t)u8();
      build_decode_table(t, !is_ac);
      t.defined = true;
    }
    if (pos != end) fail(JPEG_CORRUPT, "Bogus marker length");
  }

  void read_sof(int marker, size_t end) {
    if (frame_seen) fail(JPEG_CORRUPT, "Invalid JPEG file structure: two SOF markers");
    precision = (int)u8();
    height = (int)u16();
    width = (int)u16();
    ncomp = (int)u8();
    if (precision != 8) {
      fail(JPEG_UNSUPPORTED, "JPEG with " + std::to_string(precision) +
                                 "-bit samples is not ported (dask_geomodeling_tpu/io/jpeg.py "
                                 "reads it with Pillow)");
    }
    if (ncomp != 1 && ncomp != 3 && ncomp != 4) {
      fail(JPEG_CORRUPT, "cannot handle " + std::to_string(ncomp) + "-layer images");
    }
    if (width <= 0 || height <= 0) fail(JPEG_CORRUPT, "Empty JPEG image (DNL not supported)");
    if (pos + 3 * (size_t)ncomp != end) fail(JPEG_CORRUPT, "Bogus marker length");
    for (int c = 0; c < ncomp; c++) {
      comp[c].id = (int)u8();
      unsigned hv = u8();
      comp[c].h = (int)(hv >> 4);
      comp[c].v = (int)(hv & 15);
      comp[c].tq = (int)u8();
      if (comp[c].h < 1 || comp[c].h > 4 || comp[c].v < 1 || comp[c].v > 4) {
        fail(JPEG_CORRUPT, "Bogus sampling factors");
      }
      if (comp[c].tq > 3) fail(JPEG_CORRUPT, "Bogus quantization table number");
      hmax = std::max(hmax, comp[c].h);
      vmax = std::max(vmax, comp[c].v);
    }
    progressive = marker == 0xC2;
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int c = 0; c < ncomp; c++) {
      Component &k = comp[c];
      // jdinput.c: initial_setup
      k.dw = (int)(((int64_t)width * k.h + hmax - 1) / hmax);
      k.dh = (int)(((int64_t)height * k.v + vmax - 1) / vmax);
      k.wib = (int)(((int64_t)width * k.h + 8 * hmax - 1) / (8 * hmax));
      k.hib = (int)(((int64_t)height * k.v + 8 * vmax - 1) / (8 * vmax));
      k.bw = mcux * k.h;
      k.bh = mcuy * k.v;
      for (int i = 0; i < 64; i++) k.coef_bits[i] = -1;
    }
    frame_seen = true;
  }

  void allocate() {
    for (int c = 0; c < ncomp; c++) {
      Component &k = comp[c];
      if (k.coef.empty()) k.coef.assign((size_t)k.bw * k.bh * 64, 0);
    }
  }

  void read_app(int marker, size_t end) {
    size_t len = end - pos;
    // jdmarker.c: examine_app0 and examine_app14
    if (marker == 0xE0 && len >= 14 && std::memcmp(data + pos, "JFIF\0", 5) == 0) jfif = true;
    if (marker == 0xEE && len >= 12 && std::memcmp(data + pos, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = data[pos + 11];
    }
    pos = end;
  }

  // one scan: SOS header then its entropy-coded data
  void read_scan(size_t end) {
    if (!frame_seen) fail(JPEG_CORRUPT, "Invalid JPEG file structure: SOS before SOF");
    int ns = (int)u8();
    if (ns < 1 || ns > 4 || pos + 2 * (size_t)ns + 3 != end) fail(JPEG_CORRUPT, "Bogus marker length");
    int members[4];
    for (int i = 0; i < ns; i++) {
      int id = (int)u8();
      unsigned tables = u8();
      int c = 0;
      while (c < ncomp && comp[c].id != id) c++;
      if (c == ncomp) fail(JPEG_CORRUPT, "Invalid component ID in SOS");
      for (int j = 0; j < i; j++) {
        if (members[j] == c) fail(JPEG_CORRUPT, "Invalid component ID in SOS");
      }
      members[i] = c;
      comp[c].dc_tbl = (int)(tables >> 4);
      comp[c].ac_tbl = (int)(tables & 15);
      if (comp[c].dc_tbl > 3 || comp[c].ac_tbl > 3) fail(JPEG_CORRUPT, "Bogus Huffman table index");
    }
    int ss = (int)u8(), se = (int)u8();
    unsigned a = u8();
    int ah = (int)(a >> 4), al = (int)(a & 15);
    // jdinput.c: latch_quant_tables, at a component's first scan
    for (int i = 0; i < ns; i++) {
      Component &k = comp[members[i]];
      if (!k.qt_latched) {
        if (!qdefined[k.tq]) fail(JPEG_CORRUPT, "Quantization table not defined");
        std::memcpy(k.qt, qtables[k.tq], sizeof(k.qt));
        k.qt_latched = true;
      }
    }
    // jdinput.c: per_scan_setup's MCU limit
    int blocks = 0;
    for (int i = 0; i < ns; i++) blocks += ns == 1 ? 1 : comp[members[i]].h * comp[members[i]].v;
    if (blocks > 10) fail(JPEG_CORRUPT, "Sampling factors too large for interleaved scan");
    allocate();
    scans++;

    enum { SEQ, DC_FIRST, DC_REFINE, AC_FIRST, AC_REFINE } kind = SEQ;
    if (progressive) {
      // jdphuff.c: start_pass_phuff_decoder's checks
      bool bad = false;
      if (ss == 0) {
        if (se != 0) bad = true;
      } else {
        if (se < ss || se > 63 || ns != 1) bad = true;
      }
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) fail(JPEG_CORRUPT, "Invalid progressive parameters");
      for (int i = 0; i < ns; i++) {
        int *cb = comp[members[i]].coef_bits;
        if (ss != 0 && cb[0] < 0) { /* libjpeg warns: AC before DC */ }
        for (int k = ss; k <= se; k++) cb[k] = al;
      }
      kind = ss == 0 ? (ah == 0 ? DC_FIRST : DC_REFINE) : (ah == 0 ? AC_FIRST : AC_REFINE);
    }
    for (int i = 0; i < ns; i++) {
      Component &k = comp[members[i]];
      bool need_dc = kind == SEQ || kind == DC_FIRST;
      bool need_ac = kind == SEQ || kind == AC_FIRST || kind == AC_REFINE;
      if (need_dc && !dc_tables[k.dc_tbl].defined) fail(JPEG_CORRUPT, "Huffman table 0x" + std::to_string(k.dc_tbl) + " was not defined");
      if (need_ac && !ac_tables[k.ac_tbl].defined) fail(JPEG_CORRUPT, "Huffman table 0x" + std::to_string(k.ac_tbl) + " was not defined");
      k.last_dc = 0;
    }

    BitReader br;
    br.p = data + pos;
    br.end = data + size;
    int eobrun = 0;
    int64_t mcus;
    int cols;
    if (ns == 1) {
      cols = comp[members[0]].wib;
      mcus = (int64_t)cols * comp[members[0]].hib;
    } else {
      cols = mcux;
      mcus = (int64_t)mcux * mcuy;
    }
    int next_restart = 0;
    int64_t todo = restart_interval;
    bool skipping = false;  // libjpeg's insufficient_data: MCUs skipped
    for (int64_t m = 0; m < mcus; m++) {
      if (restart_interval && todo == 0) {
        // jdhuff.c: process_restart
        br.reset();
        pos = (size_t)(br.p - data);
        int marker = next_marker();
        if (marker != 0xD0 + next_restart) fail(JPEG_CORRUPT, "Corrupt JPEG data: bad restart marker");
        next_restart = (next_restart + 1) & 7;
        todo = restart_interval;
        for (int i = 0; i < ns; i++) comp[members[i]].last_dc = 0;
        eobrun = 0;
        br.p = data + pos;
        br.hit_marker = false;
        br.hit_end = false;
        skipping = false;
        br.insufficient = false;
      }
      if (restart_interval) todo--;
      if (skipping) continue;
      int mrow = (int)(m / cols), mcol = (int)(m % cols);
      for (int i = 0; i < ns; i++) {
        Component &k = comp[members[i]];
        int nh = ns == 1 ? 1 : k.h, nv = ns == 1 ? 1 : k.v;
        for (int y = 0; y < nv; y++) {
          for (int x = 0; x < nh; x++) {
            int brow = mrow * nv + y, bcol = mcol * nh + x;
            int16_t *block = &k.coef[((size_t)brow * k.bw + bcol) * 64];
            switch (kind) {
              case SEQ: decode_sequential(br, k, block); break;
              case DC_FIRST: {
                int s = huff_decode(br, dc_tables[k.dc_tbl]);
                if (s) s = extend((int)br.get(s), s);
                k.last_dc += s;
                block[0] = (int16_t)(k.last_dc * (1 << al));
                break;
              }
              case DC_REFINE:
                if (br.get(1)) block[0] = (int16_t)(block[0] | (1 << al));
                break;
              case AC_FIRST: decode_ac_first(br, k, block, ss, se, al, eobrun); break;
              case AC_REFINE: decode_ac_refine(br, k, block, ss, se, al, eobrun); break;
            }
          }
        }
      }
      if (br.overrun) fail(JPEG_CORRUPT, "image file is truncated");
      if (br.insufficient) skipping = true;
    }
    // after the scan: the reader stopped at (or before) the next marker
    pos = (size_t)(br.p - data);
  }

  void decode_sequential(BitReader &br, Component &k, int16_t *block) {
    const HuffDecode &dc = dc_tables[k.dc_tbl];
    const HuffDecode &ac = ac_tables[k.ac_tbl];
    int s = huff_decode(br, dc);
    if (s) s = extend((int)br.get(s), s);
    k.last_dc += s;
    block[0] = (int16_t)k.last_dc;
    for (int n = 1; n < 64; n++) {
      int rs = huff_decode(br, ac);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        n += r;
        s = extend((int)br.get(s), s);
        block[kNaturalOrder[n]] = (int16_t)s;
      } else {
        if (r != 15) break;
        n += 15;
      }
    }
  }

  // jdphuff.c: decode_mcu_AC_first
  void decode_ac_first(BitReader &br, Component &k, int16_t *block, int ss, int se, int al,
                       int &eobrun) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    const HuffDecode &ac = ac_tables[k.ac_tbl];
    for (int n = ss; n <= se; n++) {
      int rs = huff_decode(br, ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        n += r;
        s = extend((int)br.get(s), s);
        block[kNaturalOrder[n]] = (int16_t)(s * (1 << al));
      } else if (r == 15) {
        n += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += (int)br.get(r);
        eobrun--;
        break;
      }
    }
  }

  // jdphuff.c: decode_mcu_AC_refine
  void decode_ac_refine(BitReader &br, Component &k, int16_t *block, int ss, int se, int al,
                        int &eobrun) {
    int p1 = 1 << al;
    int m1 = (int)(-1u << al);
    int n = ss;
    const HuffDecode &ac = ac_tables[k.ac_tbl];
    if (eobrun == 0) {
      for (; n <= se; n++) {
        int rs = huff_decode(br, ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += (int)br.get(r);
          break;
        }
        do {
          int16_t *coef = block + kNaturalOrder[n];
          if (*coef != 0) {
            if (br.get(1)) {
              if ((*coef & p1) == 0) *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
            }
          } else {
            if (--r < 0) break;
          }
          n++;
        } while (n <= se);
        if (s) block[kNaturalOrder[n]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; n <= se; n++) {
        int16_t *coef = block + kNaturalOrder[n];
        if (*coef != 0) {
          if (br.get(1)) {
            if ((*coef & p1) == 0) *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
          }
        }
      }
      eobrun--;
    }
  }

  // the markers up to the first SOS (header) or to EOI (whole).  A
  // sequential image is whole once every component has had its scan;
  // the markers after it are read as libjpeg's jpeg_finish_decompress
  // reads them (tables and comments taken, another scan or an unknown
  // marker an error), but their end, with or without EOI, is no error:
  // Pillow has its rows by then.
  void parse(bool whole) {
    // JpegImagePlugin.py: _accept, the first three bytes
    if (size < 3 || data[0] != 0xFF || data[1] != 0xD8 || data[2] != 0xFF) {
      fail(JPEG_CORRUPT, "not a JPEG file");
    }
    pos = 2;
    bool complete = false;
    for (;;) {
      if (complete && pos >= size) return;
      int marker;
      try {
        marker = next_marker();
      } catch (const JpegError &) {
        if (complete) return;
        throw;
      }
      if (marker == 0xD9) {
        if (!frame_seen || scans == 0) fail(JPEG_CORRUPT, "Invalid JPEG file structure: missing SOS marker");
        eoi = true;
        return;
      }
      if (marker == 0xD8) fail(JPEG_CORRUPT, "Invalid JPEG file structure: two SOI markers");
      if (marker >= 0xD0 && marker <= 0xD7) continue;  // jdmarker.c: a stray RSTn
      if (marker == 0x01) continue;                     // TEM
      bool known = (marker >= 0xC0 && marker <= 0xCF && marker != 0xC8) ||
                   (marker >= 0xDA && marker <= 0xDD) || (marker >= 0xE0 && marker <= 0xEF) ||
                   marker == 0xFE;
      if (!known) fail(JPEG_CORRUPT, "Unsupported marker type 0x" + std::to_string(marker));
      size_t at = pos;
      if (complete && at + 2 > size) return;
      size_t len = u16();
      if (len < 2 || at + len > size) {
        if (complete) return;
        fail(JPEG_CORRUPT, "image file is truncated");
      }
      size_t end = at + len;
      switch (marker) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
          read_sof(marker, end);
          break;
        case 0xC3:
        case 0xC5:
        case 0xC6:
        case 0xC7:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          fail(JPEG_UNSUPPORTED, "lossless and hierarchical JPEG are not ported "
                                 "(dask_geomodeling_tpu/io/jpeg.py reads them with Pillow)");
        case 0xC9:
        case 0xCA:
        case 0xCC:
          fail(JPEG_UNSUPPORTED, "arithmetic-coded JPEG is not ported "
                                 "(dask_geomodeling_tpu/io/jpeg.py reads it with Pillow)");
        case 0xC4:
          read_dht(end);
          break;
        case 0xDB:
          read_dqt(end);
          if (pos != end) fail(JPEG_CORRUPT, "Bogus marker length");
          break;
        case 0xDD:
          if (len != 4) fail(JPEG_CORRUPT, "Bogus marker length");
          restart_interval = (int)u16();
          break;
        case 0xDA:
          if (complete) fail(JPEG_CORRUPT, "Didn't expect more than one scan");
          if (!whole) {
            if (!frame_seen) fail(JPEG_CORRUPT, "Invalid JPEG file structure: SOS before SOF");
            return;
          }
          read_scan(end);
          if (!progressive && ncomp_done()) {
            complete = true;
            eoi = true;
          }
          break;
        case 0xDC:  // DNL
        case 0xFE:  // COM
          pos = end;
          break;
        default:
          if (marker >= 0xE0 && marker <= 0xEF) {
            read_app(marker, end);
          } else {
            fail(JPEG_CORRUPT, "Unsupported marker type 0x" + std::to_string(marker));
          }
      }
    }
  }

  bool ncomp_done() {
    for (int c = 0; c < ncomp; c++) {
      if (!comp[c].qt_latched) return false;
    }
    return true;
  }

  // jdcoefct.c: smoothing_ok (SAVED_COEFS = 10, Q01..Q30 in zigzag order)
  bool smoothing_wanted() {
    if (!progressive) return false;
    bool useful = false;
    for (int c = 0; c < ncomp; c++) {
      const Component &k = comp[c];
      if (!k.qt_latched) return false;
      static const int positions[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
      for (int i = 0; i < 10; i++) {
        if (k.qt[positions[i]] == 0) return false;
      }
      if (k.coef_bits[0] < 0) return false;
      for (int i = 1; i < 10; i++) {
        if (k.coef_bits[i] != 0) useful = true;
      }
    }
    return useful;
  }
};

// ---------------------------------------------------------- ISLOW IDCT

const int CONST_BITS = 13;
const int PASS1_BITS = 2;
const int32_t FIX_0_298631336 = 2446;
const int32_t FIX_0_390180644 = 3196;
const int32_t FIX_0_541196100 = 4433;
const int32_t FIX_0_765366865 = 6270;
const int32_t FIX_0_899976223 = 7373;
const int32_t FIX_1_175875602 = 9633;
const int32_t FIX_1_501321110 = 12299;
const int32_t FIX_1_847759065 = 15137;
const int32_t FIX_1_961570560 = 16069;
const int32_t FIX_2_053119869 = 16819;
const int32_t FIX_2_562915447 = 20995;
const int32_t FIX_3_072711026 = 25172;

inline int32_t descale(int64_t x, int n) { return (int32_t)((x + ((int64_t)1 << (n - 1))) >> n); }

// jdmaster.c: prepare_range_limit_table, the post-IDCT part: a sample is
// range_limit[x & 1023] with range_limit = sample_range_limit + 128
struct RangeLimit {
  uint8_t idct[1024];
  RangeLimit() {
    for (int w = 0; w < 1024; w++) {
      int v;
      if (w < 128) v = w + 128;
      else if (w < 512) v = 255;
      else if (w < 896) v = 0;
      else v = w - 896;
      idct[w] = (uint8_t)v;
    }
  }
};
const RangeLimit kRange;

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// jidctint.c: jpeg_idct_islow
void idct_islow(const int16_t *coef, const uint16_t *quant, uint8_t *out, int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t *in = coef + c;
    const uint16_t *q = quant + c;
    int32_t *w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 && in[48] == 0 &&
        in[56] == 0) {
      int32_t dcval = (int32_t)in[0] * (int32_t)q[0] * (1 << PASS1_BITS);
      for (int r = 0; r < 8; r++) w[8 * r] = dcval;
      continue;
    }
    int64_t z2 = (int32_t)in[16] * (int32_t)q[16];
    int64_t z3 = (int32_t)in[48] * (int32_t)q[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int32_t)in[0] * (int32_t)q[0];
    z3 = (int32_t)in[32] * (int32_t)q[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int32_t)in[56] * (int32_t)q[56];
    tmp1 = (int32_t)in[40] * (int32_t)q[40];
    tmp2 = (int32_t)in[24] * (int32_t)q[24];
    tmp3 = (int32_t)in[8] * (int32_t)q[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = CONST_BITS - PASS1_BITS;
    w[0] = descale(tmp10 + tmp3, n);
    w[56] = descale(tmp10 - tmp3, n);
    w[8] = descale(tmp11 + tmp2, n);
    w[48] = descale(tmp11 - tmp2, n);
    w[16] = descale(tmp12 + tmp1, n);
    w[40] = descale(tmp12 - tmp1, n);
    w[24] = descale(tmp13 + tmp0, n);
    w[32] = descale(tmp13 - tmp0, n);
  }
  const int n = CONST_BITS + PASS1_BITS + 3;
  for (int r = 0; r < 8; r++) {
    const int32_t *w = ws + 8 * r;
    uint8_t *o = out + (size_t)r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 && w[7] == 0) {
      uint8_t dc = kRange.idct[descale(w[0], PASS1_BITS + 3) & 1023];
      for (int i = 0; i < 8; i++) o[i] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << CONST_BITS);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = kRange.idct[descale(tmp10 + tmp3, n) & 1023];
    o[7] = kRange.idct[descale(tmp10 - tmp3, n) & 1023];
    o[1] = kRange.idct[descale(tmp11 + tmp2, n) & 1023];
    o[6] = kRange.idct[descale(tmp11 - tmp2, n) & 1023];
    o[2] = kRange.idct[descale(tmp12 + tmp1, n) & 1023];
    o[5] = kRange.idct[descale(tmp12 - tmp1, n) & 1023];
    o[3] = kRange.idct[descale(tmp13 + tmp0, n) & 1023];
    o[4] = kRange.idct[descale(tmp13 - tmp0, n) & 1023];
  }
}

// ----------------------------------------------------------- upsampling

// The component's samples (dw x dh, edges repeated: jdmainct.c's context
// pointers and jdsample.c's edge columns) brought to width x height by
// jdsample.c's method for its ratio.
void upsample(const Component &k, const uint8_t *plane, int stride, int hmax, int vmax, int width,
              int height, uint8_t *out) {
  const int dw = k.dw, dh = k.dh;
  auto at = [&](int r, int c) -> int {
    r = r < 0 ? 0 : (r >= dh ? dh - 1 : r);
    c = c < 0 ? 0 : (c >= dw ? dw - 1 : c);
    return plane[(size_t)r * stride + c];
  };
  if (k.h == hmax && k.v == vmax) {
    for (int y = 0; y < height; y++) std::memcpy(out + (size_t)y * width, plane + (size_t)y * stride, width);
    return;
  }
  bool h2 = k.h * 2 == hmax, v2 = k.v * 2 == vmax;
  bool h1 = k.h == hmax, v1 = k.v == vmax;
  if (h2 && v1 && dw > 2) {
    // h2v1_fancy_upsample
    for (int y = 0; y < height; y++) {
      const uint8_t *in = plane + (size_t)y * stride;
      uint8_t *o = out + (size_t)y * width;
      for (int x = 0; x < width; x++) {
        int j = x >> 1;
        int near = 3 * in[j];
        o[x] = (x & 1) ? (uint8_t)((near + in[j + 1 < dw ? j + 1 : dw - 1] + 2) >> 2)
                       : (uint8_t)((near + in[j > 0 ? j - 1 : 0] + 1) >> 2);
      }
    }
    return;
  }
  if (h1 && v2) {
    // h1v2_fancy_upsample
    for (int y = 0; y < height; y++) {
      int i = y >> 1;
      int far = (y & 1) ? i + 1 : i - 1;
      int bias = (y & 1) ? 2 : 1;
      uint8_t *o = out + (size_t)y * width;
      for (int x = 0; x < width; x++) o[x] = (uint8_t)((3 * at(i, x) + at(far, x) + bias) >> 2);
    }
    return;
  }
  if (h2 && v2 && dw > 2) {
    // h2v2_fancy_upsample
    std::vector<int> colsum(dw);
    for (int y = 0; y < height; y++) {
      int i = y >> 1;
      int far = (y & 1) ? i + 1 : i - 1;
      far = far < 0 ? 0 : (far >= dh ? dh - 1 : far);
      int ii = i >= dh ? dh - 1 : i;
      const uint8_t *n0 = plane + (size_t)ii * stride;
      const uint8_t *n1 = plane + (size_t)far * stride;
      for (int j = 0; j < dw; j++) colsum[j] = 3 * n0[j] + n1[j];
      uint8_t *o = out + (size_t)y * width;
      for (int x = 0; x < width; x++) {
        int j = x >> 1;
        int thiscol = colsum[j];
        if (x & 1) {
          int next = colsum[j + 1 < dw ? j + 1 : dw - 1];
          o[x] = (uint8_t)((thiscol * 3 + next + 7) >> 4);
        } else {
          int last = colsum[j > 0 ? j - 1 : 0];
          o[x] = (uint8_t)((thiscol * 3 + last + 8) >> 4);
        }
      }
    }
    return;
  }
  if (hmax % k.h == 0 && vmax % k.v == 0) {
    // int_upsample (and h2v1_upsample / h2v2_upsample): replication
    int he = hmax / k.h, ve = vmax / k.v;
    for (int y = 0; y < height; y++) {
      const uint8_t *in = plane + (size_t)(y / ve) * stride;
      uint8_t *o = out + (size_t)y * width;
      for (int x = 0; x < width; x++) o[x] = in[x / he];
    }
    return;
  }
  fail(JPEG_CORRUPT, "Fractional sampling not implemented yet");
}

// jdcolor.c: build_ycc_rgb_table (SCALEBITS 16)
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    const int32_t one_half = 1 << 15;
    auto fix = [](double x) { return (int32_t)(x * 65536.0 + 0.5); };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = (int)((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = (int)((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
  }
};
const YccTables kYcc;

void decode_image(Decoder &d, uint8_t *out) {
  if (d.smoothing_wanted()) {
    fail(JPEG_UNSUPPORTED, "a progressive JPEG whose scans leave low AC coefficients unrefined "
                           "needs libjpeg's block smoothing, which is not ported "
                           "(dask_geomodeling_tpu/io/jpeg.py reads it with Pillow)");
  }
  const int W = d.width, H = d.height, nc = d.ncomp;
  std::vector<std::vector<uint8_t>> full(nc);
  for (int c = 0; c < nc; c++) {
    Component &k = d.comp[c];
    if (!k.qt_latched) {
      // a component no scan covered: libjpeg's coefficients stay zero
      std::memcpy(k.qt, d.qtables[k.tq], sizeof(k.qt));
      if (k.coef.empty()) k.coef.assign((size_t)k.bw * k.bh * 64, 0);
    }
    int stride = k.bw * 8;
    std::vector<uint8_t> plane((size_t)stride * k.bh * 8);
    // jdcoefct.c: only the blocks inside width_in_blocks x height_in_blocks
    for (int by = 0; by < k.hib; by++) {
      for (int bx = 0; bx < k.wib; bx++) {
        idct_islow(&k.coef[((size_t)by * k.bw + bx) * 64], k.qt,
                   &plane[(size_t)by * 8 * stride + bx * 8], stride);
      }
    }
    std::vector<int16_t>().swap(k.coef);
    full[c].resize((size_t)W * H);
    upsample(k, plane.data(), stride, d.hmax, d.vmax, W, H, full[c].data());
  }
  const size_t n = (size_t)W * H;
  if (nc == 1) {
    std::memcpy(out, full[0].data(), n);
    return;
  }
  // jdapimin.c: default_decompress_parms' colour space
  bool ycc;
  if (nc == 3) {
    int id0 = d.comp[0].id, id1 = d.comp[1].id, id2 = d.comp[2].id;
    if (d.jfif) ycc = true;
    else if (d.adobe) ycc = d.adobe_transform != 0;
    else if (id0 == 1 && id1 == 2 && id2 == 3) ycc = true;
    else if (id0 == 82 && id1 == 71 && id2 == 66) ycc = false;
    else ycc = true;
  } else {
    ycc = d.adobe && d.adobe_transform != 0;  // YCCK, else CMYK
  }
  const uint8_t *p0 = full[0].data(), *p1 = full[1].data(), *p2 = full[2].data();
  if (nc == 3) {
    for (size_t i = 0; i < n; i++) {
      if (ycc) {
        // jdcolor.c: ycc_rgb_convert
        int y = p0[i], cb = p1[i], cr = p2[i];
        out[3 * i] = clamp255(y + kYcc.cr_r[cr]);
        out[3 * i + 1] = clamp255(y + (int)((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
        out[3 * i + 2] = clamp255(y + kYcc.cb_b[cb]);
      } else {
        out[3 * i] = p0[i];
        out[3 * i + 1] = p1[i];
        out[3 * i + 2] = p2[i];
      }
    }
    return;
  }
  const uint8_t *p3 = full[3].data();
  for (size_t i = 0; i < n; i++) {
    uint8_t c0, c1, c2;
    if (ycc) {
      // jdcolor.c: ycck_cmyk_convert
      int y = p0[i], cb = p1[i], cr = p2[i];
      c0 = clamp255(255 - (y + kYcc.cr_r[cr]));
      c1 = clamp255(255 - (y + (int)((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16)));
      c2 = clamp255(255 - (y + kYcc.cb_b[cb]));
    } else {
      c0 = p0[i];
      c1 = p1[i];
      c2 = p2[i];
    }
    // Pillow's "CMYK;I" raw mode: every byte inverted
    out[4 * i] = (uint8_t)(255 - c0);
    out[4 * i + 1] = (uint8_t)(255 - c1);
    out[4 * i + 2] = (uint8_t)(255 - c2);
    out[4 * i + 3] = (uint8_t)(255 - p3[i]);
  }
}

// ------------------------------------------------------------- encoding

// jcparam.c's standard quantisation tables (natural order)
const int kStdLuminance[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kStdChrominance[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99, 99,
    99, 99, 47, 66, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// jstdhuff.c: the standard Huffman tables
const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcLumVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kDcChromBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcChromVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// jchuff.c: jpeg_make_c_derived_tbl
struct HuffEncode {
  unsigned code[256];
  int size[256];
  void build(const uint8_t *bits, const uint8_t *vals) {
    std::memset(size, 0, sizeof(size));
    std::memset(code, 0, sizeof(code));
    unsigned c = 0;
    int p = 0;
    for (int l = 1; l <= 16; l++) {
      for (int i = 0; i < bits[l]; i++, p++) {
        code[vals[p]] = c++;
        size[vals[p]] = l;
      }
      c <<= 1;
    }
  }
};

struct ByteWriter {
  uint8_t *out;
  int64_t capacity;
  int64_t n = 0;
  bool overflow = false;
  uint64_t acc = 0;  // jchuff.c's put_buffer
  int acc_bits = 0;
  inline void byte(unsigned b) {
    if (n < capacity) out[n] = (uint8_t)b;
    else overflow = true;
    n++;
  }
  void u16(unsigned v) {
    byte(v >> 8);
    byte(v & 0xFF);
  }
  void marker(unsigned m) {
    byte(0xFF);
    byte(m);
  }
  inline void bits(unsigned value, int size) {
    if (size == 0) return;
    acc = (acc << size) | (value & ((1u << size) - 1));
    acc_bits += size;
    while (acc_bits >= 8) {
      unsigned b = (unsigned)(acc >> (acc_bits - 8)) & 0xFF;
      byte(b);
      if (b == 0xFF) byte(0);
      acc_bits -= 8;
    }
  }
  // jchuff.c: flush_bits pads with one bits
  void flush() {
    if (acc_bits) bits(0x7F, 8 - acc_bits);
    acc = 0;
    acc_bits = 0;
  }
};

// jfdctint.c: jpeg_fdct_islow (results scaled up by 8)
void fdct_islow(int32_t *data) {
  int32_t *d = data;
  for (int r = 0; r < 8; r++, d += 8) {
    int64_t tmp0 = d[0] + d[7], tmp7 = d[0] - d[7];
    int64_t tmp1 = d[1] + d[6], tmp6 = d[1] - d[6];
    int64_t tmp2 = d[2] + d[5], tmp5 = d[2] - d[5];
    int64_t tmp3 = d[3] + d[4], tmp4 = d[3] - d[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    d[0] = (int32_t)((tmp10 + tmp11) * (1 << PASS1_BITS));
    d[4] = (int32_t)((tmp10 - tmp11) * (1 << PASS1_BITS));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    d[2] = descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS - PASS1_BITS);
    d[6] = descale(z1 + tmp12 * (-FIX_1_847759065), CONST_BITS - PASS1_BITS);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    d[7] = descale(tmp4 + z1 + z3, CONST_BITS - PASS1_BITS);
    d[5] = descale(tmp5 + z2 + z4, CONST_BITS - PASS1_BITS);
    d[3] = descale(tmp6 + z2 + z3, CONST_BITS - PASS1_BITS);
    d[1] = descale(tmp7 + z1 + z4, CONST_BITS - PASS1_BITS);
  }
  d = data;
  for (int c = 0; c < 8; c++, d++) {
    int64_t tmp0 = d[0] + d[56], tmp7 = d[0] - d[56];
    int64_t tmp1 = d[8] + d[48], tmp6 = d[8] - d[48];
    int64_t tmp2 = d[16] + d[40], tmp5 = d[16] - d[40];
    int64_t tmp3 = d[24] + d[32], tmp4 = d[24] - d[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    d[0] = descale(tmp10 + tmp11, PASS1_BITS);
    d[32] = descale(tmp10 - tmp11, PASS1_BITS);
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    d[16] = descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS + PASS1_BITS);
    d[48] = descale(z1 + tmp12 * (-FIX_1_847759065), CONST_BITS + PASS1_BITS);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    d[56] = descale(tmp4 + z1 + z3, CONST_BITS + PASS1_BITS);
    d[40] = descale(tmp5 + z2 + z4, CONST_BITS + PASS1_BITS);
    d[24] = descale(tmp6 + z2 + z3, CONST_BITS + PASS1_BITS);
    d[8] = descale(tmp7 + z1 + z4, CONST_BITS + PASS1_BITS);
  }
}

// jcdctmgr.c: compute_reciprocal for a divisor of quantval << 3
struct Divisor {
  uint32_t recip, corr;
  int shift;  // r: the product is shifted right by r
};

Divisor compute_reciprocal(uint32_t divisor) {
  Divisor out;
  if (divisor == 1) {
    out.recip = 1;
    out.corr = 0;
    out.shift = 0;
    return out;
  }
  int b = 31 - __builtin_clz(divisor);
  int r = 16 + b;
  uint32_t fq = (uint32_t)(((uint64_t)1 << r) / divisor);
  uint32_t fr = (uint32_t)(((uint64_t)1 << r) % divisor);
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2u) {
    c++;
  } else {
    fq++;
  }
  out.recip = fq & 0xFFFF;
  out.corr = c & 0xFFFF;
  out.shift = r;
  return out;
}

// jcdctmgr.c: quantize (16-bit DCTELEM, as libjpeg-turbo builds it with
// its SIMD extensions)
inline int16_t quantize(int32_t value, const Divisor &d) {
  int16_t temp = (int16_t)value;
  bool negative = temp < 0;
  if (negative) temp = (int16_t)-temp;
  uint32_t product = (uint32_t)((uint16_t)temp + d.corr) * d.recip;
  product >>= d.shift;
  int16_t q = (int16_t)product;
  return negative ? (int16_t)-q : q;
}

struct EncComponent {
  int id, h, v, tq, td, ta;
  int wib, hib;               // width_in_blocks, height_in_blocks
  int pw, ph;                 // the padded plane
  std::vector<uint8_t> plane;
  Divisor div[64];
  int last_dc = 0;
};

int encode(const uint8_t *pixels, int width, int height, int channels, int quality, int hs, int vs,
           ByteWriter &w) {
  // jcparam.c: jpeg_quality_scaling and jpeg_add_quant_table (baseline)
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  uint16_t qt[2][64];
  for (int i = 0; i < 64; i++) {
    for (int t = 0; t < 2; t++) {
      long temp = ((long)(t ? kStdChrominance[i] : kStdLuminance[i]) * scale + 50L) / 100L;
      if (temp <= 0L) temp = 1L;
      if (temp > 32767L) temp = 32767L;
      if (temp > 255L) temp = 255L;
      qt[t][i] = (uint16_t)temp;
    }
  }
  const int nc = channels;
  EncComponent comps[3];
  // a grayscale image writes its sampling factors in SOF, as Pillow's
  // subsampling option sets them, and codes one block at a time
  int hmax = hs, vmax = vs;
  for (int c = 0; c < nc; c++) {
    EncComponent &k = comps[c];
    k.id = c + 1;
    k.h = c == 0 ? hs : 1;
    k.v = c == 0 ? vs : 1;
    k.tq = c == 0 ? 0 : 1;
    k.td = k.ta = c == 0 ? 0 : 1;
    // jcmaster.c: initial_setup
    k.wib = (int)(((int64_t)width * k.h + 8 * hmax - 1) / (8 * hmax));
    k.hib = (int)(((int64_t)height * k.v + 8 * vmax - 1) / (8 * vmax));
    for (int i = 0; i < 64; i++) k.div[i] = compute_reciprocal((uint32_t)qt[k.tq][i] << 3);
  }
  const int mcux = (width + 8 * hmax - 1) / (8 * hmax);
  const int mcuy = (height + 8 * vmax - 1) / (8 * vmax);

  // jccolor.c: rgb_ycc_convert, then jcprepct.c's bottom padding to
  // max_v_samp_factor rows and jcsample.c's right padding and
  // downsampling, then the bottom padding to whole iMCU rows
  const int rows = ((height + vmax - 1) / vmax) * vmax;
  std::vector<uint8_t> full[3];
  for (int c = 0; c < nc; c++) full[c].resize((size_t)width * rows);
  if (nc == 1) {
    for (int y = 0; y < height; y++) std::memcpy(&full[0][(size_t)y * width], pixels + (size_t)y * width, width);
  } else {
    const int32_t one_half = 1 << 15, cbcr_offset = 128 << 16;
    auto fix = [](double x) { return (int32_t)(x * 65536.0 + 0.5); };
    int32_t ry[256], gy[256], by[256], rcb[256], gcb[256], bcb[256], gcr[256], bcr[256];
    for (int i = 0; i < 256; i++) {
      ry[i] = fix(0.29900) * i;
      gy[i] = fix(0.58700) * i;
      by[i] = fix(0.11400) * i + one_half;
      rcb[i] = (-fix(0.16874)) * i;
      gcb[i] = (-fix(0.33126)) * i;
      bcb[i] = fix(0.50000) * i + cbcr_offset + one_half - 1;
      gcr[i] = (-fix(0.41869)) * i;
      bcr[i] = (-fix(0.08131)) * i;
    }
    for (int y = 0; y < height; y++) {
      const uint8_t *src = pixels + (size_t)y * width * 3;
      uint8_t *o0 = &full[0][(size_t)y * width], *o1 = &full[1][(size_t)y * width],
              *o2 = &full[2][(size_t)y * width];
      for (int x = 0; x < width; x++) {
        int r = src[3 * x], g = src[3 * x + 1], b = src[3 * x + 2];
        o0[x] = (uint8_t)((ry[r] + gy[g] + by[b]) >> 16);
        o1[x] = (uint8_t)((rcb[r] + gcb[g] + bcb[b]) >> 16);
        o2[x] = (uint8_t)((bcb[r] + gcr[g] + bcr[b]) >> 16);
      }
    }
  }
  for (int c = 0; c < nc; c++) {
    for (int y = height; y < rows; y++) {
      std::memcpy(&full[c][(size_t)y * width], &full[c][(size_t)(height - 1) * width], width);
    }
  }
  for (int c = 0; c < nc; c++) {
    EncComponent &k = comps[c];
    int hf = hmax / k.h, vf = vmax / k.v;
    k.pw = k.wib * 8;
    int produced = rows / vf;           // downsampled rows
    k.ph = mcuy * k.v * 8;              // whole iMCU rows
    k.plane.assign((size_t)k.pw * k.ph, 0);
    int in_cols = k.pw * hf;
    std::vector<uint8_t> r0(in_cols), r1(in_cols);
    for (int y = 0; y < produced; y++) {
      uint8_t *o = &k.plane[(size_t)y * k.pw];
      auto expand = [&](int src_row, std::vector<uint8_t> &row) {
        const uint8_t *s = &full[c][(size_t)src_row * width];
        int n = std::min(width, in_cols);
        std::memcpy(row.data(), s, n);
        for (int x = n; x < in_cols; x++) row[x] = s[width - 1];
      };
      if (hf == 1 && vf == 1) {
        expand(y, r0);
        std::memcpy(o, r0.data(), k.pw);
      } else if (hf == 2 && vf == 1) {
        // jcsample.c: h2v1_downsample, bias 0, 1, 0, 1, ...
        expand(y, r0);
        int bias = 0;
        for (int x = 0; x < k.pw; x++) {
          o[x] = (uint8_t)((r0[2 * x] + r0[2 * x + 1] + bias) >> 1);
          bias ^= 1;
        }
      } else if (hf == 2 && vf == 2) {
        // jcsample.c: h2v2_downsample, bias 1, 2, 1, 2, ...
        expand(2 * y, r0);
        expand(2 * y + 1, r1);
        int bias = 1;
        for (int x = 0; x < k.pw; x++) {
          o[x] = (uint8_t)((r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >> 2);
          bias ^= 3;
        }
      } else {
        return -2;
      }
    }
    for (int y = produced; y < k.ph; y++) {
      std::memcpy(&k.plane[(size_t)y * k.pw], &k.plane[(size_t)(produced - 1) * k.pw], k.pw);
    }
  }

  HuffEncode dc[2], ac[2];
  dc[0].build(kDcLumBits, kDcLumVals);
  ac[0].build(kAcLumBits, kAcLumVals);
  dc[1].build(kDcChromBits, kDcChromVals);
  ac[1].build(kAcChromBits, kAcChromVals);

  // the markers (jcmarker.c): SOI, JFIF, DQT per table, SOF0, DHT per
  // table as the scan header first uses it, SOS
  w.marker(0xD8);
  w.marker(0xE0);
  w.u16(16);
  const uint8_t app0[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  for (uint8_t b : app0) w.byte(b);
  int ntables = nc == 1 ? 1 : 2;
  for (int t = 0; t < ntables; t++) {
    w.marker(0xDB);
    w.u16(67);
    w.byte(t);
    for (int i = 0; i < 64; i++) w.byte(qt[t][kNaturalOrder[i]]);
  }
  w.marker(0xC0);
  w.u16(8 + 3 * nc);
  w.byte(8);
  w.u16(height);
  w.u16(width);
  w.byte(nc);
  for (int c = 0; c < nc; c++) {
    w.byte(comps[c].id);
    w.byte((comps[c].h << 4) | comps[c].v);
    w.byte(comps[c].tq);
  }
  for (int t = 0; t < ntables; t++) {
    const uint8_t *bits[2] = {t ? kDcChromBits : kDcLumBits, t ? kAcChromBits : kAcLumBits};
    const uint8_t *vals[2] = {t ? kDcChromVals : kDcLumVals, t ? kAcChromVals : kAcLumVals};
    for (int cls = 0; cls < 2; cls++) {
      int count = 0;
      for (int i = 1; i <= 16; i++) count += bits[cls][i];
      w.marker(0xC4);
      w.u16(2 + 1 + 16 + count);
      w.byte((cls << 4) | t);
      for (int i = 1; i <= 16; i++) w.byte(bits[cls][i]);
      for (int i = 0; i < count; i++) w.byte(vals[cls][i]);
    }
  }
  w.marker(0xDA);
  w.u16(6 + 2 * nc);
  w.byte(nc);
  for (int c = 0; c < nc; c++) {
    w.byte(comps[c].id);
    w.byte((comps[c].td << 4) | comps[c].ta);
  }
  w.byte(0);
  w.byte(63);
  w.byte(0);

  // jccoefct.c: compress_data, MCU by MCU; jchuff.c: encode_one_block
  int32_t work[64];
  int16_t block[64];
  int16_t prev_dc = 0;
  auto encode_block = [&](EncComponent &k, const int16_t *b) {
    int temp = b[0] - k.last_dc;
    k.last_dc = b[0];
    int temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    int nbits = temp ? 32 - __builtin_clz((unsigned)temp) : 0;
    const HuffEncode &d = dc[k.td];
    w.bits(d.code[nbits], d.size[nbits]);
    w.bits((unsigned)temp2, nbits);
    const HuffEncode &a = ac[k.ta];
    int r = 0;
    for (int n = 1; n < 64; n++) {
      temp = b[kNaturalOrder[n]];
      if (temp == 0) {
        r++;
        continue;
      }
      while (r > 15) {
        w.bits(a.code[0xF0], a.size[0xF0]);
        r -= 16;
      }
      temp2 = temp;
      if (temp < 0) {
        temp = -temp;
        temp2--;
      }
      nbits = 32 - __builtin_clz((unsigned)temp);
      int sym = (r << 4) + nbits;
      w.bits(a.code[sym], a.size[sym]);
      w.bits((unsigned)temp2, nbits);
      r = 0;
    }
    if (r > 0) w.bits(a.code[0], a.size[0]);
  };
  auto forward = [&](EncComponent &k, int brow, int bcol, int16_t *out) {
    for (int y = 0; y < 8; y++) {
      const uint8_t *s = &k.plane[(size_t)(brow * 8 + y) * k.pw + bcol * 8];
      for (int x = 0; x < 8; x++) work[8 * y + x] = (int32_t)s[x] - 128;
    }
    fdct_islow(work);
    for (int i = 0; i < 64; i++) out[i] = quantize(work[i], k.div[i]);
  };
  if (nc == 1) {
    EncComponent &k = comps[0];
    for (int by = 0; by < k.hib; by++) {
      for (int bx = 0; bx < k.wib; bx++) {
        forward(k, by, bx, block);
        encode_block(k, block);
      }
    }
  } else {
    std::vector<int16_t> mcu(64 * 10);
    for (int my = 0; my < mcuy; my++) {
      for (int mx = 0; mx < mcux; mx++) {
        for (int c = 0; c < nc; c++) {
          EncComponent &k = comps[c];
          int last_col_width = k.wib % k.h ? k.wib % k.h : k.h;
          int last_row_height = k.hib % k.v ? k.hib % k.v : k.v;
          int blockcnt = mx < mcux - 1 ? k.h : last_col_width;
          int blkn = 0;
          for (int yi = 0; yi < k.v; yi++) {
            int16_t *row = &mcu[(size_t)blkn * 64];
            if (my < mcuy - 1 || yi < last_row_height) {
              for (int bi = 0; bi < blockcnt; bi++) forward(k, my * k.v + yi, mx * k.h + bi, row + bi * 64);
              for (int bi = blockcnt; bi < k.h; bi++) {
                std::memset(row + bi * 64, 0, 64 * sizeof(int16_t));
                row[bi * 64] = row[(bi - 1) * 64];
              }
            } else {
              for (int bi = 0; bi < k.h; bi++) {
                std::memset(row + bi * 64, 0, 64 * sizeof(int16_t));
                row[bi * 64] = prev_dc;
              }
            }
            blkn += k.h;
            prev_dc = mcu[(size_t)(blkn - 1) * 64];
          }
          for (int b = 0; b < blkn; b++) encode_block(k, &mcu[(size_t)b * 64]);
        }
      }
    }
  }
  w.flush();
  w.marker(0xD9);
  return 0;
}

}  // namespace

extern "C" {

int jpeg_decode(const uint8_t *src, int64_t n, uint8_t *out, int64_t capacity, int32_t *info,
                char *message, int64_t message_size) {
  try {
    Decoder header;
    header.data = src;
    header.size = (size_t)n;
    header.parse(false);
    info[0] = header.width;
    info[1] = header.height;
    info[2] = header.ncomp;
    int64_t need = (int64_t)header.width * header.height * header.ncomp;
    if (out == nullptr || capacity < need) return JPEG_NEED_SPACE;
    Decoder d;
    d.data = src;
    d.size = (size_t)n;
    d.parse(true);
    if (!d.eoi) fail(JPEG_CORRUPT, "image file is truncated");
    decode_image(d, out);
    return JPEG_OK;
  } catch (const JpegError &e) {
    if (message && message_size > 0) std::snprintf(message, (size_t)message_size, "%s", e.message.c_str());
    return e.code;
  } catch (const std::bad_alloc &) {
    if (message && message_size > 0) std::snprintf(message, (size_t)message_size, "out of memory");
    return JPEG_CORRUPT;
  }
}

int64_t jpeg_encode(const uint8_t *pixels, int32_t width, int32_t height, int32_t channels,
                    int32_t quality, int32_t h_samp, int32_t v_samp, uint8_t *out,
                    int64_t capacity) {
  if (width < 1 || height < 1 || width > 65535 || height > 65535) return -2;
  if (channels != 1 && channels != 3) return -2;
  if (h_samp < 1 || h_samp > 2 || v_samp < 1 || v_samp > h_samp) return -2;
  ByteWriter w;
  w.out = out;
  w.capacity = capacity;
  int rc;
  try {
    rc = encode(pixels, width, height, channels, quality, h_samp, v_samp, w);
  } catch (const std::bad_alloc &) {
    return -2;
  }
  if (rc) return rc;
  if (w.overflow) return -1;
  return w.n;
}

}  // extern "C"
