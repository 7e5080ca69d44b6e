// Native LZ codec + 64-bit checksum for the gateway data path.
//
// The reference delegates compression to the lz4 C wheel
// (skyplane/gateway/operators/gateway_operator.py:358-361); this is our own
// byte-oriented LZ77 with a 64 KiB window and hash-chain matching, exposed
// through a C ABI for ctypes. Format (little-endian):
//
//   header: magic 'S''L' | version u8 | raw_len u64
//   tokens: ctrl u8 = (lit_count:4 | match_len_minus4:4)
//           lit_count == 15  -> varint extra literal count follows
//           literals bytes
//           if match nibble != 0: offset u16 (1..65535 back), match nibble
//           == 15 -> varint extra match length follows
//   stream ends when raw_len bytes have been reconstructed.
//
// Build: g++ -O3 -shared -fPIC skylz.cpp -o libskydp.so

#include <cstdint>
#include <cstring>
#include <cstdlib>

extern "C" {

static const uint8_t MAGIC0 = 'S', MAGIC1 = 'L', VERSION = 1;
static const int MIN_MATCH = 4;
static const int HASH_BITS = 16;
static const uint32_t WINDOW = 65535;

static inline uint32_t hash4(const uint8_t* p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return (v * 2654435761u) >> (32 - HASH_BITS);
}

static inline size_t write_varint(uint8_t* out, uint64_t v) {
    size_t n = 0;
    while (v >= 0x80) { out[n++] = (uint8_t)(v | 0x80); v >>= 7; }
    out[n++] = (uint8_t)v;
    return n;
}

static inline size_t read_varint(const uint8_t* in, size_t avail, uint64_t* v) {
    uint64_t result = 0; int shift = 0; size_t n = 0;
    while (n < avail && n < 10) {
        uint8_t b = in[n++];
        result |= (uint64_t)(b & 0x7F) << shift;
        if (!(b & 0x80)) { *v = result; return n; }
        shift += 7;
    }
    return 0; // malformed
}

// worst case: header + raw + per-255-literal overhead
uint64_t skylz_max_compressed_size(uint64_t raw_len) {
    // header + raw + token overhead + emit()'s conservative varint headroom
    return 11 + raw_len + raw_len / 255 + 64;
}

// returns compressed size, or 0 on error / insufficient dst capacity
uint64_t skylz_compress(const uint8_t* src, uint64_t src_len, uint8_t* dst, uint64_t dst_cap) {
    if (dst_cap < 11) return 0;
    uint8_t* out = dst;
    *out++ = MAGIC0; *out++ = MAGIC1; *out++ = VERSION;
    memcpy(out, &src_len, 8); out += 8;
    uint8_t* dst_end = dst + dst_cap;

    if (src_len == 0) return (uint64_t)(out - dst);

    // hash table of most recent position per 4-byte hash
    const uint32_t HSIZE = 1u << HASH_BITS;
    int64_t* table = (int64_t*)malloc(HSIZE * sizeof(int64_t));
    if (!table) return 0;
    for (uint32_t i = 0; i < HSIZE; i++) table[i] = -1;

    uint64_t pos = 0, lit_start = 0;

    auto emit = [&](uint64_t lit_count, uint64_t match_len, uint32_t offset) -> bool {
        // space: ctrl + varints (<=20) + literals + offset
        if (out + 1 + 20 + lit_count + 2 > dst_end) return false;
        uint8_t lit_nib = lit_count >= 15 ? 15 : (uint8_t)lit_count;
        uint64_t m = match_len ? match_len - MIN_MATCH : 0;
        uint8_t match_nib = match_len ? (m >= 15 ? 15 : (uint8_t)m) : 0;
        // reserve nibble pattern 0 for "no match" — match_len==MIN_MATCH maps
        // to nibble 1 by storing m+1 when a match exists
        if (match_len) { uint64_t enc = m + 1; match_nib = enc >= 15 ? 15 : (uint8_t)enc; }
        *out++ = (uint8_t)((lit_nib << 4) | match_nib);
        if (lit_nib == 15) out += write_varint(out, lit_count - 15);
        memcpy(out, src + lit_start, lit_count); out += lit_count;
        if (match_len) {
            memcpy(out, &offset, 2); out += 2;
            uint64_t enc = m + 1;
            if (match_nib == 15) out += write_varint(out, enc - 15);
        }
        return true;
    };

    while (pos + MIN_MATCH <= src_len) {
        uint32_t h = hash4(src + pos);
        int64_t cand = table[h];
        table[h] = (int64_t)pos;
        uint64_t match_len = 0; uint32_t offset = 0;
        if (cand >= 0 && pos - (uint64_t)cand <= WINDOW && memcmp(src + cand, src + pos, MIN_MATCH) == 0) {
            uint64_t len = MIN_MATCH;
            uint64_t max_len = src_len - pos;
            while (len < max_len && src[cand + len] == src[pos + len]) len++;
            match_len = len;
            offset = (uint32_t)(pos - (uint64_t)cand);
        }
        if (match_len) {
            if (!emit(pos - lit_start, match_len, offset)) { free(table); return 0; }
            // seed hashes inside the match region (sparse, every 2 bytes)
            uint64_t end = pos + match_len;
            for (uint64_t p2 = pos + 1; p2 + MIN_MATCH <= src_len && p2 < end; p2 += 2)
                table[hash4(src + p2)] = (int64_t)p2;
            pos = end;
            lit_start = pos;
        } else {
            pos++;
        }
    }
    // trailing literals
    if (lit_start < src_len) {
        if (!emit(src_len - lit_start, 0, 0)) { free(table); return 0; }
    }
    free(table);
    return (uint64_t)(out - dst);
}

// returns raw size, or 0 on error
uint64_t skylz_decompressed_size(const uint8_t* src, uint64_t src_len) {
    if (src_len < 11 || src[0] != MAGIC0 || src[1] != MAGIC1 || src[2] != VERSION) return 0;
    uint64_t raw_len;
    memcpy(&raw_len, src + 3, 8);
    return raw_len;
}

uint64_t skylz_decompress(const uint8_t* src, uint64_t src_len, uint8_t* dst, uint64_t dst_cap) {
    uint64_t raw_len = skylz_decompressed_size(src, src_len);
    if (raw_len == 0 && !(src_len >= 11 && src[0] == MAGIC0)) return 0;
    if (dst_cap < raw_len) return 0;
    const uint8_t* in = src + 11;
    const uint8_t* in_end = src + src_len;
    uint64_t out_pos = 0;
    while (out_pos < raw_len) {
        if (in >= in_end) return 0;
        uint8_t ctrl = *in++;
        uint64_t lit = ctrl >> 4;
        uint64_t match_enc = ctrl & 0x0F;
        if (lit == 15) {
            uint64_t extra; size_t n = read_varint(in, (size_t)(in_end - in), &extra);
            if (!n) return 0;
            in += n; lit = 15 + extra;
        }
        if (lit) {
            if (in + lit > in_end || out_pos + lit > raw_len) return 0;
            memcpy(dst + out_pos, in, lit);
            in += lit; out_pos += lit;
        }
        if (match_enc) {
            if (in + 2 > in_end) return 0;
            uint16_t offset;
            memcpy(&offset, in, 2); in += 2;
            uint64_t enc = match_enc;
            if (enc == 15) {
                uint64_t extra; size_t n = read_varint(in, (size_t)(in_end - in), &extra);
                if (!n) return 0;
                in += n; enc = 15 + extra;
            }
            uint64_t match_len = (enc - 1) + MIN_MATCH;
            if (offset == 0 || offset > out_pos || out_pos + match_len > raw_len) return 0;
            // overlapping copy must run forward byte-by-byte
            uint8_t* d = dst + out_pos;
            const uint8_t* s = d - offset;
            for (uint64_t i = 0; i < match_len; i++) d[i] = s[i];
            out_pos += match_len;
        }
    }
    return out_pos;
}

// xxhash-inspired 64-bit checksum (own constants/rounds; not xxhash-compatible)
uint64_t skylz_checksum64(const uint8_t* data, uint64_t len, uint64_t seed) {
    const uint64_t P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL, P3 = 0x165667B19E3779F9ULL;
    uint64_t h = seed ^ (len * P1);
    uint64_t i = 0;
    while (i + 8 <= len) {
        uint64_t k;
        memcpy(&k, data + i, 8);
        k *= P2; k = (k << 31) | (k >> 33); k *= P1;
        h ^= k; h = ((h << 27) | (h >> 37)) * P1 + P3;
        i += 8;
    }
    while (i < len) { h ^= (uint64_t)data[i] * P3; h = ((h << 11) | (h >> 53)) * P1; i++; }
    h ^= h >> 33; h *= P2; h ^= h >> 29; h *= P3; h ^= h >> 32;
    return h;
}

}  // extern "C"
