// Snappy block-format codec + CRC32C, from scratch (C ABI for ctypes).
//
// Role: the reference's client edge compresses gate<->client streams
// with snappy (ClientProxy.go:38-53 via netconnutil); this provides a
// wire-compatible codec without any third-party library. The BLOCK
// format implemented here is the public one from google/snappy's
// format_description.txt:
//   preamble: uncompressed length, varint32
//   elements: tag byte, low 2 bits = type
//     00 literal  (len-1 in tag>>2; 60..63 mean 1..4 extra LE len bytes)
//     01 copy     (len = ((tag>>2)&7)+4, offset = ((tag>>5)<<8)|byte)
//     10 copy     (len = (tag>>2)+1, 2-byte LE offset)
//     11 copy     (len = (tag>>2)+1, 4-byte LE offset)
// Any format-compliant element stream is valid snappy, so the encoder
// here (greedy hash-table matcher, the standard approach) need not be
// byte-identical to Google's — every spec-conforming decoder reads it,
// and this decoder reads Google-encoded blocks.
//
// CRC32C (Castagnoli, polynomial 0x82f63b78, reflected) is what the
// snappy FRAMING format checksums with; the Python side applies the
// framing-format mask ((crc>>15 | crc<<17) + 0xa282ead8).

#include <cstdint>
#include <cstring>
#include <cstddef>

extern "C" {

// ---------------------------------------------------------------- crc32c --
static uint32_t crc_table[8][256];
static bool crc_init_done = false;

static void crc_init() {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? (0x82f63b78u ^ (c >> 1)) : (c >> 1);
        crc_table[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = crc_table[0][i];
        for (int t = 1; t < 8; t++) {
            c = crc_table[0][c & 0xff] ^ (c >> 8);
            crc_table[t][i] = c;
        }
    }
    crc_init_done = true;
}

uint32_t gw_crc32c(const uint8_t* p, int64_t n) {
    if (!crc_init_done) crc_init();
    uint32_t crc = 0xffffffffu;
    // slice-by-8
    while (n >= 8) {
        uint32_t lo;
        uint32_t hi;
        memcpy(&lo, p, 4);
        memcpy(&hi, p + 4, 4);
        lo ^= crc;
        crc = crc_table[0][(hi >> 24) & 0xff] ^
              crc_table[1][(hi >> 16) & 0xff] ^
              crc_table[2][(hi >> 8) & 0xff] ^
              crc_table[3][hi & 0xff] ^
              crc_table[4][(lo >> 24) & 0xff] ^
              crc_table[5][(lo >> 16) & 0xff] ^
              crc_table[6][(lo >> 8) & 0xff] ^
              crc_table[7][lo & 0xff];
        p += 8;
        n -= 8;
    }
    while (n-- > 0)
        crc = crc_table[0][(crc ^ *p++) & 0xff] ^ (crc >> 8);
    return crc ^ 0xffffffffu;
}

// ------------------------------------------------------------- compress --
// worst case: the spec's MaxCompressedLength formula
int64_t gw_snappy_max_compressed_length(int64_t n) {
    return 32 + n + n / 6;
}

static inline uint8_t* emit_varint(uint8_t* dst, uint64_t v) {
    while (v >= 0x80) {
        *dst++ = (uint8_t)(v | 0x80);
        v >>= 7;
    }
    *dst++ = (uint8_t)v;
    return dst;
}

static inline uint8_t* emit_literal(uint8_t* dst, const uint8_t* src,
                                    int64_t len) {
    int64_t n = len - 1;
    if (n < 60) {
        *dst++ = (uint8_t)(n << 2);
    } else if (n < (1 << 8)) {
        *dst++ = 60 << 2;
        *dst++ = (uint8_t)n;
    } else if (n < (1 << 16)) {
        *dst++ = 61 << 2;
        *dst++ = (uint8_t)n;
        *dst++ = (uint8_t)(n >> 8);
    } else if (n < (1 << 24)) {
        *dst++ = 62 << 2;
        *dst++ = (uint8_t)n;
        *dst++ = (uint8_t)(n >> 8);
        *dst++ = (uint8_t)(n >> 16);
    } else {
        *dst++ = 63 << 2;
        *dst++ = (uint8_t)n;
        *dst++ = (uint8_t)(n >> 8);
        *dst++ = (uint8_t)(n >> 16);
        *dst++ = (uint8_t)(n >> 24);
    }
    memcpy(dst, src, (size_t)len);
    return dst + len;
}

// emit one copy element for len in [4..64], offset < 2^16 always here
// (the matcher never reaches 4-byte offsets: window = this block)
static inline uint8_t* emit_copy_le64(uint8_t* dst, int64_t offset,
                                      int64_t len) {
    if (len < 12 && offset < 2048) {
        *dst++ = (uint8_t)(1 | ((len - 4) << 2) | ((offset >> 8) << 5));
        *dst++ = (uint8_t)offset;
    } else {
        *dst++ = (uint8_t)(2 | ((len - 1) << 2));
        *dst++ = (uint8_t)offset;
        *dst++ = (uint8_t)(offset >> 8);
    }
    return dst;
}

static inline uint8_t* emit_copy(uint8_t* dst, int64_t offset,
                                 int64_t len) {
    while (len >= 68) {
        dst = emit_copy_le64(dst, offset, 64);
        len -= 64;
    }
    if (len > 64) {
        dst = emit_copy_le64(dst, offset, 60);
        len -= 60;
    }
    return emit_copy_le64(dst, offset, len);
}

static inline uint32_t load32(const uint8_t* p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return v;
}

// returns compressed size
int64_t gw_snappy_compress(const uint8_t* src, int64_t n, uint8_t* dst) {
    uint8_t* d = emit_varint(dst, (uint64_t)n);
    if (n == 0) return d - dst;
    if (n < 16) {  // too short to match
        d = emit_literal(d, src, n);
        return d - dst;
    }
    // hash table of positions, 14-bit
    const int HASH_BITS = 14;
    int32_t table[1 << HASH_BITS];
    memset(table, -1, sizeof(table));
    const uint32_t HASH_MUL = 0x1e35a7bd;
    int64_t ip = 0;        // next byte to examine
    int64_t lit_start = 0; // start of pending literal run
    const int64_t limit = n - 4;  // last position a 4-byte load is safe
    while (ip <= limit) {
        uint32_t h = (load32(src + ip) * HASH_MUL) >> (32 - HASH_BITS);
        int32_t cand = table[h];
        table[h] = (int32_t)ip;
        if (cand >= 0 && load32(src + cand) == load32(src + ip) &&
            ip - cand < 65536) {
            // extend match
            int64_t mlen = 4;
            while (ip + mlen < n && src[cand + mlen] == src[ip + mlen])
                mlen++;
            if (ip > lit_start)
                d = emit_literal(d, src + lit_start, ip - lit_start);
            d = emit_copy(d, ip - cand, mlen);
            ip += mlen;
            lit_start = ip;
        } else {
            ip++;
        }
    }
    if (lit_start < n)
        d = emit_literal(d, src + lit_start, n - lit_start);
    return d - dst;
}

// ----------------------------------------------------------- uncompress --
// returns decompressed size, or -1 on malformed input / dst_cap overflow
int64_t gw_snappy_uncompress(const uint8_t* src, int64_t n,
                             uint8_t* dst, int64_t dst_cap) {
    // varint preamble
    uint64_t ulen = 0;
    int shift = 0;
    int64_t ip = 0;
    for (;;) {
        if (ip >= n || shift > 28) return -1;
        uint8_t b = src[ip++];
        ulen |= (uint64_t)(b & 0x7f) << shift;
        if (!(b & 0x80)) break;
        shift += 7;
    }
    if ((int64_t)ulen > dst_cap) return -1;
    int64_t op = 0;
    while (ip < n) {
        uint8_t tag = src[ip++];
        uint32_t kind = tag & 3;
        if (kind == 0) {                        // literal
            int64_t len = (tag >> 2) + 1;
            if (len > 60) {
                int extra = (int)len - 60;
                if (ip + extra > n) return -1;
                len = 0;
                for (int i = 0; i < extra; i++)
                    len |= (int64_t)src[ip + i] << (8 * i);
                len += 1;
                ip += extra;
            }
            if (ip + len > n || op + len > (int64_t)ulen) return -1;
            memcpy(dst + op, src + ip, (size_t)len);
            ip += len;
            op += len;
        } else {                                // copy
            int64_t len;
            int64_t offset;
            if (kind == 1) {
                if (ip >= n) return -1;
                len = ((tag >> 2) & 7) + 4;
                offset = ((int64_t)(tag >> 5) << 8) | src[ip++];
            } else if (kind == 2) {
                if (ip + 2 > n) return -1;
                len = (tag >> 2) + 1;
                offset = (int64_t)src[ip] | ((int64_t)src[ip + 1] << 8);
                ip += 2;
            } else {
                if (ip + 4 > n) return -1;
                len = (tag >> 2) + 1;
                offset = (int64_t)src[ip] | ((int64_t)src[ip + 1] << 8) |
                         ((int64_t)src[ip + 2] << 16) |
                         ((int64_t)src[ip + 3] << 24);
                ip += 4;
            }
            if (offset == 0 || offset > op ||
                op + len > (int64_t)ulen) return -1;
            // byte-by-byte: overlapping copies (offset < len) replicate
            const uint8_t* from = dst + op - offset;
            uint8_t* to = dst + op;
            for (int64_t i = 0; i < len; i++) to[i] = from[i];
            op += len;
        }
    }
    return op == (int64_t)ulen ? op : -1;
}

}  // extern "C"
