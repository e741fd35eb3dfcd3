// Ring decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel kernels/decode_attention.py · decode_attention_fwd
// (body _kernel) of the reference package: one query token per lane against
// that lane's ring-buffer KV cache [b, L, K, hd] (slot = position % L, the
// ring's positions in cache_pos [b, L], -1 = empty), online softmax over
// tiles of the ring, all G query heads of a kv head in one block.
//
// Bound on this card: bytes. A decode step reads each lane's ring K and V
// once and does 4*G*hd operations per row, far under the card's
// operations-per-byte line (gemma3-12b's 4096-slot global ring at 8 lanes
// is 268 MB, 0.080 ms at 3.35 TB/s).
// Design: the body of paged_attend.cuh with no block table: a tile's rows
// are found by pointer arithmetic into the lane's ring instead of a table
// lookup, and a tile is skipped only on what its own cache_pos entries show
// (after a wrap slot 0 may hold the newest position, so nothing is skipped
// by index). Thread blocks over (context split, kv head, lane): a few lanes
// times a few kv heads (recurrentgemma-9b: 8 lanes x 1 kv head) do not fill
// 132 SMs, so the ring is split over blocks and a second small kernel merges
// the splits' (max, sum, weighted sum). f32 CUDA-core arithmetic, no tensor
// cores and no asynchronous copies yet.
#include "paged_attend.cuh"

// Ring positions per tile: about 8192 / hd (64 at most), and never more
// than the ring or the caller's kv_block.
static inline int ring_tile_rows(int hd, int L, int kv_block) {
    int t = 8192 / hd;
    if (t > 64) t = 64;
    if (kv_block > 0 && t > kv_block) t = kv_block;
    if (t > L) t = L;
    return t < 1 ? 1 : t;
}

// How many thread blocks share one (lane, kv head)'s ring: enough for about
// four blocks on each of the card's 132 SMs, at most one per tile and at
// most 32.
extern "C" int ring_decode_splits(int b, int K, int hd, int L, int kv_block) {
    int TR = ring_tile_rows(hd, L, kv_block);
    int tiles = (L + TR - 1) / TR;
    int want = (528 + b * K - 1) / (b * K);
    int n = want < tiles ? want : tiles;
    if (n > 32) n = 32;
    return n < 1 ? 1 : n;
}

// q, o [b, K, G, hd] (q_dtype); k, v [b, L, K, hd] (kv_codec: PA_POOL_F32
// or PA_POOL_BF16); cache_pos [b, L]; positions [b]. Returns a cudaError_t,
// or -1 for a shape the body does not take.
extern "C" int ring_decode_launch(
    const void* q, void* o, const void* k, const void* v,
    const int* cache_pos, const int* positions, int b, int L, int K, int G,
    int hd, int q_dtype, int kv_codec, int window, int chunk, float scale,
    int kv_block, int nsplit, float* part, void* stream) {
    if (kv_codec != PA_POOL_F32 && kv_codec != PA_POOL_BF16) return -1;
    AttendArgs a;
    a.q = q; a.o = o; a.kpool = k; a.vpool = v;
    a.kscale = nullptr; a.vscale = nullptr; a.pool_pos = cache_pos;
    a.tables = nullptr; a.positions = positions; a.bm = nullptr;
    a.bl = nullptr;
    a.b = b; a.C = 1; a.K = K; a.G = G; a.hd = hd; a.bs = L; a.mB = 1;
    a.q_dtype = q_dtype; a.codec = kv_codec; a.window = window;
    a.chunk = chunk;
    a.QR = G;
    a.TR = ring_tile_rows(hd, L, kv_block);
    a.scale = scale;
    a.nsplit = nsplit;
    a.part = part;
    int e = pa_launch(a, (cudaStream_t)stream);
    if (e != 0 || nsplit <= 1) return e;
    paged_merge_kernel<<<dim3(K, b), PA_THREADS, 0, (cudaStream_t)stream>>>(
        part, o, K, G, hd, nsplit, q_dtype);
    return (int)cudaGetLastError();
}
