// Fixture encoders of chip_smoke.py's lzw-sheet phase: TIFF LZW and
// PackBits, as libtiff writes them (tif_lzw.c, tif_packbits.c).
//
// The port only reads these compressions (io/geotiff.py); its writer, like
// the JAX package's, writes none of them.  So the phase's files are encoded
// here: a sheet of 500 MB is hours of work for an encoder in Python.
// Built with g++ at first use by the port's ops/_build.py, loaded with
// ctypes (plain C interface).
//
// LZW: a ClearCode first; real dictionary codes, 9 to 12 bits, MSB first;
// the code width grows when the next free entry passes the width's largest
// code, which with the decoder's one-entry lag is TIFF's early change; a
// ClearCode when the table reaches 4094 entries; the EndOfInformation code
// at the width the decoder reaches after the last code.
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kClear = 256;
constexpr int kEnd = 257;
constexpr int kFirst = 258;
constexpr int kMaxCode = 4095;

struct BitWriter {
    uint8_t* out;
    int64_t capacity;
    int64_t written = 0;
    uint64_t acc = 0;
    int nbits = 0;
    bool full = false;

    void put(int code, int width) {
        acc = (acc << width) | (uint64_t)code;
        nbits += width;
        while (nbits >= 8) {
            nbits -= 8;
            if (written >= capacity) {
                full = true;
                return;
            }
            out[written++] = (uint8_t)(acc >> nbits);
        }
    }

    void flush() {
        if (nbits > 0) {
            if (written >= capacity) {
                full = true;
                return;
            }
            out[written++] = (uint8_t)(acc << (8 - nbits));
            nbits = 0;
        }
    }
};

}  // namespace

extern "C" {

// Encode `in` as one TIFF LZW chunk.  Returns the bytes written, or -2
// when `out_capacity` is too small.
int64_t lzw_encode(const uint8_t* in, int64_t in_size, uint8_t* out,
                   int64_t out_capacity) {
    // child[code * 256 + byte]: the entry extending `code` by `byte`, 0
    // for none; the entries added since the last clear are reset one by one
    std::vector<uint16_t> child((size_t)4096 * 256, 0);
    std::vector<int32_t> added;
    added.reserve(4096);
    BitWriter bits{out, out_capacity};
    int width = 9;
    int free_ent = kFirst;
    bits.put(kClear, width);
    if (in_size == 0) {
        bits.put(kEnd, width);
        bits.flush();
        return bits.full ? -2 : bits.written;
    }
    int ent = in[0];
    for (int64_t i = 1; i < in_size; ++i) {
        int c = in[i];
        int32_t slot = ent * 256 + c;
        if (child[slot] != 0) {
            ent = child[slot];
            continue;
        }
        bits.put(ent, width);
        child[slot] = (uint16_t)free_ent;
        added.push_back(slot);
        ent = c;
        ++free_ent;
        if (free_ent == kMaxCode - 1) {
            // table full: clear and start again at 9 bits
            bits.put(kClear, width);
            for (int32_t s : added) child[s] = 0;
            added.clear();
            free_ent = kFirst;
            width = 9;
        } else if (free_ent > (1 << width) - 1) {
            ++width;
        }
        if (bits.full) return -2;
    }
    bits.put(ent, width);
    // the decoder adds one more entry on reading that code
    ++free_ent;
    if (free_ent == kMaxCode - 1) {
        bits.put(kClear, width);
        width = 9;
    } else if (free_ent > (1 << width) - 1) {
        ++width;
    }
    bits.put(kEnd, width);
    bits.flush();
    return bits.full ? -2 : bits.written;
}

// Encode `rows` rows of `row_bytes` bytes each as PackBits, each row on
// its own (TIFF 6: runs never cross a row): a repeat run for two or more
// equal bytes, literal runs up to 128 bytes otherwise.  Returns the bytes
// written, or -2 when `out_capacity` is too small.
int64_t packbits_encode_rows(const uint8_t* in, int64_t rows, int64_t row_bytes,
                             uint8_t* out, int64_t out_capacity) {
    int64_t written = 0;
    for (int64_t r = 0; r < rows; ++r) {
        const uint8_t* row = in + r * row_bytes;
        int64_t i = 0;
        while (i < row_bytes) {
            int64_t run = 1;
            while (i + run < row_bytes && run < 128 && row[i + run] == row[i]) ++run;
            if (run >= 2) {
                if (written + 2 > out_capacity) return -2;
                out[written++] = (uint8_t)(257 - run);
                out[written++] = row[i];
                i += run;
                continue;
            }
            // a literal run up to the next pair of equal bytes
            int64_t j = i + 1;
            while (j < row_bytes && j - i < 128 &&
                   !(j + 1 < row_bytes && row[j] == row[j + 1])) {
                ++j;
            }
            int64_t n = j - i;
            if (written + 1 + n > out_capacity) return -2;
            out[written++] = (uint8_t)(n - 1);
            std::memcpy(out + written, row + i, (size_t)n);
            written += n;
            i = j;
        }
    }
    return written;
}

}  // extern "C"
