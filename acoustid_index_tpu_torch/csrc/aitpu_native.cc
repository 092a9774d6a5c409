// The port's copy of acoustid_index_tpu/native/aitpu_native.cc, built by
// acoustid_index_tpu_torch/utils/native.py.
//
// Native host-side codecs for acoustid_index_tpu.
//
// The TPU search path reads raw HBM-resident u32 columns, so compression
// only exists at the storage boundary: segment files, snapshots shipped
// between nodes, and WAL payload scanning.  This plays the role the
// reference's SIMD StreamVByte codec plays on its CPU search path
// (upstream fpindex's src/streamvbyte.zig) — except here decode happens once
// at load, not per query, so the codec optimizes for sequential
// encode/decode bandwidth and compactness, not per-block random access.
//
// Format "dv1" (delta-varint):
//   * hashes are sorted: encode LEB128 varints of successive deltas;
//   * docids are sorted within each equal-hash run: encode the delta from
//     the previous posting when the hash repeats, else the raw value.
//
// Exposed as a plain C ABI for ctypes.  All functions return -1 on bounds
// violations; decode additionally validates that exactly `in_len` bytes
// are consumed.

#include <cstdint>
#include <cstring>

namespace {

inline int64_t put_varint(uint8_t* out, int64_t cap, int64_t pos, uint32_t v) {
    while (v >= 0x80) {
        if (pos >= cap) return -1;
        out[pos++] = static_cast<uint8_t>(v) | 0x80;
        v >>= 7;
    }
    if (pos >= cap) return -1;
    out[pos++] = static_cast<uint8_t>(v);
    return pos;
}

inline int64_t get_varint(const uint8_t* in, int64_t len, int64_t pos, uint32_t* v) {
    uint32_t result = 0;
    int shift = 0;
    while (true) {
        if (pos >= len || shift > 28) return -1;
        uint8_t b = in[pos++];
        result |= static_cast<uint32_t>(b & 0x7F) << shift;
        if (!(b & 0x80)) break;
        shift += 7;
    }
    *v = result;
    return pos;
}

}  // namespace

extern "C" {

// Worst-case output size for n postings (both columns).
int64_t aitpu_encode_bound(int64_t n) { return n * 10 + 16; }

// Encode n sorted (hash, docid) pairs; returns bytes written or -1.
int64_t aitpu_encode_postings(const uint32_t* hashes, const uint32_t* docids,
                              int64_t n, uint8_t* out, int64_t cap) {
    int64_t pos = 0;
    uint32_t prev_hash = 0;
    uint32_t prev_docid = 0;
    for (int64_t i = 0; i < n; i++) {
        uint32_t h = hashes[i];
        uint32_t delta = h - prev_hash;  // sorted: wraps only on bad input
        pos = put_varint(out, cap, pos, delta);
        if (pos < 0) return -1;
        uint32_t d = docids[i];
        uint32_t dv = (i > 0 && delta == 0) ? d - prev_docid : d;
        pos = put_varint(out, cap, pos, dv);
        if (pos < 0) return -1;
        prev_hash = h;
        prev_docid = d;
    }
    return pos;
}

// Decode n pairs from exactly in_len bytes; returns n or -1.
int64_t aitpu_decode_postings(const uint8_t* in, int64_t in_len, int64_t n,
                              uint32_t* hashes, uint32_t* docids) {
    int64_t pos = 0;
    uint32_t prev_hash = 0;
    uint32_t prev_docid = 0;
    for (int64_t i = 0; i < n; i++) {
        uint32_t delta, dv;
        pos = get_varint(in, in_len, pos, &delta);
        if (pos < 0) return -1;
        pos = get_varint(in, in_len, pos, &dv);
        if (pos < 0) return -1;
        uint32_t h = prev_hash + delta;
        uint32_t d = (i > 0 && delta == 0) ? prev_docid + dv : dv;
        hashes[i] = h;
        docids[i] = d;
        prev_hash = h;
        prev_docid = d;
    }
    return pos == in_len ? n : -1;
}

// Sorted u32 column (mentioned-doc ids): plain delta varint.
int64_t aitpu_encode_sorted_u32(const uint32_t* values, int64_t n, uint8_t* out, int64_t cap) {
    int64_t pos = 0;
    uint32_t prev = 0;
    for (int64_t i = 0; i < n; i++) {
        pos = put_varint(out, cap, pos, values[i] - prev);
        if (pos < 0) return -1;
        prev = values[i];
    }
    return pos;
}

int64_t aitpu_decode_sorted_u32(const uint8_t* in, int64_t in_len, int64_t n, uint32_t* values) {
    int64_t pos = 0;
    uint32_t prev = 0;
    for (int64_t i = 0; i < n; i++) {
        uint32_t delta;
        pos = get_varint(in, in_len, pos, &delta);
        if (pos < 0) return -1;
        prev += delta;
        values[i] = prev;
    }
    return pos == in_len ? n : -1;
}

// CRC-32 (zlib polynomial), slice-by-1; used by WAL frame scanning so the
// native scanner never calls back into Python.
namespace {
struct Crc32Table {
    uint32_t t[256];
    Crc32Table() {
        for (uint32_t i = 0; i < 256; i++) {
            uint32_t c = i;
            for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
            t[i] = c;
        }
    }
};
}  // namespace

uint32_t aitpu_crc32(const uint8_t* data, int64_t len, uint32_t seed) {
    // C++11 function-local static: initialization is synchronized, so
    // concurrent WAL replays (MultiIndex.open's thread pool) never observe a
    // half-built table.
    static const Crc32Table table_holder;
    const uint32_t* table = table_holder.t;
    uint32_t crc = seed ^ 0xFFFFFFFFu;
    for (int64_t i = 0; i < len; i++) crc = table[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
    return crc ^ 0xFFFFFFFFu;
}

// Scan framed WAL records ([u32 len][u32 crc][payload]) and return the
// byte length of the valid prefix (torn/corrupt tail recovery).
int64_t aitpu_scan_frames(const uint8_t* data, int64_t len, int64_t max_record) {
    int64_t pos = 0;
    while (pos + 8 <= len) {
        uint32_t rec_len, crc;
        std::memcpy(&rec_len, data + pos, 4);
        std::memcpy(&crc, data + pos + 4, 4);
        if (rec_len == 0 || rec_len > static_cast<uint64_t>(max_record)) break;
        if (pos + 8 + rec_len > len) break;
        if (aitpu_crc32(data + pos + 8, rec_len, 0) != crc) break;
        pos += 8 + rec_len;
    }
    return pos;
}

}  // extern "C"
