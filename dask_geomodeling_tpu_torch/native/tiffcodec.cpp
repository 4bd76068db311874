// Native TIFF chunk decoders: LZW (early-change) and PackBits.
//
// The port's copy of dask_geomodeling_tpu/native/tiffcodec.cpp.  The
// GeoTIFF read path (io/geotiff.py:_decode) calls these through ctypes
// (native/__init__.py) for every LZW or PackBits chunk; its pure-Python
// decoders stay as the plain versions these are held to byte for byte
// (tests/test_torch_native.py).  Semantics match TIFF6 + libtiff.
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Decode a TIFF LZW stream.  Returns the number of bytes written to
// `out` (<= out_capacity), or -1 on corrupt input, or -2 if out_capacity
// is too small.  Decoding stops once out_capacity bytes are produced.
int64_t lzw_decode(const uint8_t* in, int64_t in_size, uint8_t* out,
                   int64_t out_capacity) {
    // string table: (previous code, first byte, length, last byte)
    struct Entry {
        int32_t prev;
        uint8_t first;
        uint8_t last;
        int32_t length;
    };
    std::vector<Entry> table(4096);
    auto reset = [&table]() {
        for (int i = 0; i < 256; ++i) {
            table[i] = {-1, (uint8_t)i, (uint8_t)i, 1};
        }
    };
    reset();

    int width = 9;
    int next_code = 258;
    uint64_t acc = 0;
    int nbits = 0;
    int64_t pos = 0;
    int64_t written = 0;
    int32_t prev = -1;

    // emit the string for `code` at out+written (backwards fill)
    auto emit = [&](int32_t code) -> int64_t {
        int32_t length = table[code].length;
        if (written + length > out_capacity) return -2;
        int64_t end = written + length;
        int32_t c = code;
        for (int64_t i = end - 1; i >= written; --i) {
            out[i] = table[c].last;
            c = table[c].prev;
        }
        written = end;
        return length;
    };

    while (true) {
        while (nbits < width) {
            if (pos >= in_size) return written;
            acc = (acc << 8) | in[pos++];
            nbits += 8;
        }
        nbits -= width;
        int32_t code = (int32_t)((acc >> nbits) & ((1u << width) - 1));
        if (code == 256) {  // ClearCode
            reset();
            width = 9;
            next_code = 258;
            prev = -1;
            continue;
        }
        if (code == 257) return written;  // EndOfInformation
        if (prev < 0) {
            if (code >= 256) return -1;
            if (emit(code) < 0) return -2;
        } else {
            if (code > next_code || next_code >= 4096) return -1;
            if (code == next_code) {
                // KwKwK: entry = prev + first(prev)
                table[next_code] = {prev, table[prev].first, table[prev].first,
                                    table[prev].length + 1};
                if (emit(next_code) < 0) return -2;
            } else {
                table[next_code] = {prev, table[prev].first, table[code].first,
                                    table[prev].length + 1};
                if (emit(code) < 0) return -2;
            }
            ++next_code;
            // TIFF early change (matches libtiff)
            if (next_code == (1 << width) - 1 && width < 12) ++width;
        }
        prev = code;
    }
}

// Decode PackBits.  Returns bytes written, or -2 if out_capacity is too
// small.
int64_t packbits_decode(const uint8_t* in, int64_t in_size, uint8_t* out,
                        int64_t out_capacity) {
    int64_t pos = 0;
    int64_t written = 0;
    while (pos < in_size) {
        uint8_t header = in[pos++];
        if (header < 128) {
            int64_t n = (int64_t)header + 1;
            if (pos + n > in_size) n = in_size - pos;
            if (written + n > out_capacity) return -2;
            std::memcpy(out + written, in + pos, (size_t)n);
            pos += n;
            written += n;
        } else if (header > 128) {
            int64_t n = 257 - (int64_t)header;
            if (pos >= in_size) break;
            if (written + n > out_capacity) return -2;
            std::memset(out + written, in[pos++], (size_t)n);
            written += n;
        }
        // header == 128: no-op
    }
    return written;
}

}  // extern "C"
