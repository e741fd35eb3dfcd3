// Ring decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel kernels/decode_attention.py · decode_attention_fwd
// (body _kernel) of the reference package: one query token per lane against
// that lane's ring-buffer KV cache [b, L, K, hd] (slot = position % L, the
// ring's positions in cache_pos [b, L], -1 = empty), all G query heads of a
// kv head (up to 4 at a time) in one block.
//
// Bound on this card: bytes. A decode step reads each lane's ring K and V
// once and does 4*G*hd operations per row, far under the card's
// operations-per-byte line: gemma3-12b's 4096-slot global ring at 8 lanes,
// 8 kv heads, hd 256 is 268,697,632 bytes (0.080 ms at 3.35 TB/s) for 0.54
// GFLOP.
// Design: the streaming body of decode_stream.cuh. Rows go from device
// memory straight into registers, 16 bytes a lane, the K and V rows of
// several ring positions in flight per lane group before any is used (4
// positions, 4 KB a warp, at hd 256 in bf16); the softmax state lives in
// registers, one per lane group, combined in a fixed order at the end of
// the block. A position is read only if its own cache_pos entry is visible.
// Thread blocks over (context split, kv head x query-row group, lane): a few
// lanes times a few kv heads do not fill 132 SMs, so the ring is split over
// blocks (about eight blocks of four warps on each SM) and a second small
// kernel merges the splits' (max, sum, weighted sum) in split order.
#include "decode_stream.cuh"

#define RD_POOL_F32 0            // the wrapper's codes of the ring's dtype
#define RD_POOL_BF16 1
#define RD_TARGET_BLOCKS 1056    // 8 blocks of 4 warps on each of 132 SMs
#define RD_MAX_SPLITS 32

// Ring positions per tile, the unit a split covers: 64, and never more than
// the ring or the caller's kv_block.
static inline int rd_tile_rows(int L, int kv_block) {
    int t = 64;
    if (kv_block > 0 && t > kv_block) t = kv_block;
    if (t > L) t = L;
    return t < 1 ? 1 : t;
}

// How many thread blocks share one (lane, kv head)'s ring: enough for about
// RD_TARGET_BLOCKS blocks, at least two tiles each (a block's fixed costs,
// the query rows' load and the combine, against its share of the ring) and
// at most RD_MAX_SPLITS, with no split left empty.
extern "C" int ring_decode_splits(int b, int K, int hd, int L, int kv_block) {
    (void)hd;
    if (b < 1 || K < 1 || L < 1) return 1;
    const int TR = rd_tile_rows(L, kv_block);
    const int tiles = (L + TR - 1) / TR;
    long long want = (RD_TARGET_BLOCKS + (long long)b * K - 1)
                   / ((long long)b * K);
    if (want > RD_MAX_SPLITS) want = RD_MAX_SPLITS;
    if (want > (tiles + 1) / 2) want = (tiles + 1) / 2;
    if (want < 1) want = 1;
    const int per = (int)((tiles + want - 1) / want);
    return (tiles + per - 1) / per;
}

// q, o [b, K, G, hd] (q_dtype); k, v [b, L, K, hd] (kv_codec: RD_POOL_F32
// or RD_POOL_BF16); cache_pos [b, L]; positions [b]; part [b, K, nsplit, G,
// hd + 2] when nsplit > 1. Returns a cudaError_t, or -1 for a shape the
// body does not take.
extern "C" int ring_decode_launch(
    const void* q, void* o, const void* k, const void* v,
    const int* cache_pos, const int* positions, int b, int L, int K, int G,
    int hd, int q_dtype, int kv_codec, int window, int chunk, float scale,
    int kv_block, int nsplit, float* part, void* stream) {
    if (kv_codec != RD_POOL_F32 && kv_codec != RD_POOL_BF16) return -1;
    if (L < 1 || nsplit < 1) return -1;
    const int TR = rd_tile_rows(L, kv_block);
    const int tiles = (L + TR - 1) / TR;
    StreamArgs a;
    a.q = q; a.o = o; a.k = k; a.v = v;
    a.cache_pos = cache_pos; a.positions = positions; a.part = part;
    a.b = b; a.L = L; a.K = K; a.G = G; a.hd = hd; a.q_dtype = q_dtype;
    a.window = window; a.chunk = chunk; a.scale = scale;
    a.nsplit = nsplit;
    a.span = (tiles + nsplit - 1) / nsplit * TR;
    a.n_gg = 1; a.lpr = 1; a.vec = 0;          // set by ds_launch
    return ds_launch(a, kv_codec == RD_POOL_F32, (cudaStream_t)stream);
}
