// Native packet codec — hot-path byte work for the wire layer.
//
// Reference being rebuilt: the per-record loops in GoWorld's sync pipeline
// (gate batching   components/gate/GateService.go:402-429,
//  dispatcher re-batching components/dispatcher/DispatcherService.go:770-808,
//  game decode      components/game/GameService.go:395-407) and the packet
// framing scan of engine/netutil/PacketConnection.go. The reference does all
// of this in Go per record; here the per-record loops run in C++ over whole
// batches so the Python hosts only touch numpy arrays.
//
// Record layout (little-endian, see goworld_tpu_torch/net/proto.py):
//   sync record:        [16B entity id][f32 x][f32 y][f32 z][f32 yaw] = 32B
//   client sync record: [16B client id][32B sync record]              = 48B
//
// Built at first use by goworld_tpu_torch/native/__init__.py into
// goworld_tpu_torch/_build/ (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstring>

extern "C" {

// Interleave ids (n*16 bytes) and vals (n*4 f32) into out (n*32 bytes).
void encode_sync_records(const char* ids, const float* vals, int32_t n,
                         char* out) {
    for (int32_t i = 0; i < n; ++i) {
        char* rec = out + (size_t)i * 32;
        std::memcpy(rec, ids + (size_t)i * 16, 16);
        std::memcpy(rec + 16, vals + (size_t)i * 4, 16);
    }
}

// Split buf (n*32 bytes) into ids (n*16) and vals (n*4 f32).
void decode_sync_records(const char* buf, int32_t n, char* ids,
                         float* vals) {
    for (int32_t i = 0; i < n; ++i) {
        const char* rec = buf + (size_t)i * 32;
        std::memcpy(ids + (size_t)i * 16, rec, 16);
        std::memcpy(vals + (size_t)i * 4, rec + 16, 16);
    }
}

// Interleave cids (n*16), ids (n*16), vals (n*4 f32) into out (n*48).
void encode_client_sync_records(const char* cids, const char* ids,
                                const float* vals, int32_t n, char* out) {
    for (int32_t i = 0; i < n; ++i) {
        char* rec = out + (size_t)i * 48;
        std::memcpy(rec, cids + (size_t)i * 16, 16);
        std::memcpy(rec + 16, ids + (size_t)i * 16, 16);
        std::memcpy(rec + 32, vals + (size_t)i * 4, 16);
    }
}

void decode_client_sync_records(const char* buf, int32_t n, char* cids,
                                char* ids, float* vals) {
    for (int32_t i = 0; i < n; ++i) {
        const char* rec = buf + (size_t)i * 48;
        std::memcpy(cids + (size_t)i * 16, rec, 16);
        std::memcpy(ids + (size_t)i * 16, rec + 16, 16);
        std::memcpy(vals + (size_t)i * 4, rec + 32, 16);
    }
}

// Scan a receive buffer of length-prefixed frames ([u32 size][payload]).
// Writes up to max_frames (offset, size) pairs of COMPLETE frames into
// offsets/sizes (offset points at the payload, past the prefix). Returns
// the number of complete frames found; *consumed is the byte count covered
// by them (the caller keeps the tail). Returns -1 on a malformed size.
int32_t scan_frames(const char* buf, int64_t len, int64_t max_payload,
                    int64_t* offsets, int64_t* sizes, int32_t max_frames,
                    int64_t* consumed) {
    int32_t count = 0;
    int64_t pos = 0;
    while (count < max_frames && pos + 4 <= len) {
        uint32_t size;
        std::memcpy(&size, buf + pos, 4);  // little-endian hosts only
        if (size < 2 || (int64_t)size > max_payload) return -1;
        if (pos + 4 + (int64_t)size > len) break;
        offsets[count] = pos + 4;
        sizes[count] = (int64_t)size;
        ++count;
        pos += 4 + (int64_t)size;
    }
    *consumed = pos;
    return count;
}

// Route sync records to per-shard compact arrays on the dispatcher/game
// boundary: given each record's routing key (precomputed shard index, -1 to
// drop), produce for each shard the packed record indices.
// counts must be zeroed, capacity = per-shard cap of out_idx rows.
void bucket_by_shard(const int32_t* shard_of, int32_t n, int32_t n_shards,
                     int32_t capacity, int32_t* out_idx, int32_t* counts) {
    for (int32_t i = 0; i < n; ++i) {
        int32_t s = shard_of[i];
        if (s < 0 || s >= n_shards) continue;
        int32_t c = counts[s];
        if (c < capacity) {
            out_idx[(size_t)s * capacity + c] = i;
            counts[s] = c + 1;
        }
    }
}

}  // extern "C"
