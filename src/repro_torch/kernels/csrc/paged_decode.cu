// Paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel kernels/decode_attention.py · paged_decode_attention_fwd
// (body _paged_kernel) of the reference package: one query token per lane
// against a shared KV block pool through per-lane block tables, online
// softmax over the lane's logical blocks, int8 / packed-int4 dequantisation
// after the load, optional per-block (max, sumexp) for the retention signal.
//
// Bound on this card: bytes. A decode step reads every mapped K and V row
// of the lane once (codes + scales) and does 4*G*hd operations per row, far
// under the card's operations-per-byte line.
// Design: thread blocks over (context split, kv head, lane), each walking
// its share of the table row in tiles (paged_attend.cuh); the TPU kernel's
// sequential grid axis over blocks is the loop inside the block, its VMEM
// scratch the registers and shared memory of that block. A few lanes times
// a few kv heads do not fill 132 SMs and one block's walk is a chain of
// load latencies, so the context is split over blocks and a second small
// kernel merges the splits' (max, sum, weighted sum). f32 CUDA-core
// arithmetic, no tensor cores yet.
#include "paged_attend.cuh"

// How many thread blocks share one (lane, kv head)'s context: enough for
// about four blocks on each of the card's 132 SMs, at most one per tile and
// at most 32.
extern "C" int paged_decode_splits(int b, int K, int hd, int bs, int mB) {
    int TR = pa_tile_rows(hd, bs);
    int tiles = (mB * bs + TR - 1) / TR;
    int want = (528 + b * K - 1) / (b * K);
    int n = want < tiles ? want : tiles;
    if (n > 32) n = 32;
    return n < 1 ? 1 : n;
}

extern "C" int paged_decode_launch(
    const void* q, void* o, const void* kpool, const void* vpool,
    const float* kscale, const float* vscale, const int* pool_pos,
    const int* tables, const int* positions, float* bm, float* bl,
    int b, int K, int G, int hd, int bs, int mB, int q_dtype, int codec,
    int window, int chunk, float scale, int nsplit, float* part,
    void* stream) {
    AttendArgs a;
    a.q = q; a.o = o; a.kpool = kpool; a.vpool = vpool;
    a.kscale = kscale; a.vscale = vscale; a.pool_pos = pool_pos;
    a.tables = tables; a.positions = positions; a.bm = bm; a.bl = bl;
    a.b = b; a.C = 1; a.K = K; a.G = G; a.hd = hd; a.bs = bs; a.mB = mB;
    a.q_dtype = q_dtype; a.codec = codec; a.window = window; a.chunk = chunk;
    a.QR = G;
    a.TR = pa_tile_rows(hd, bs);
    a.scale = scale;
    a.nsplit = nsplit;
    a.part = part;
    int e = pa_launch(a, (cudaStream_t)stream);
    if (e != 0 || nsplit <= 1) return e;
    paged_merge_kernel<<<dim3(K, b), PA_THREADS, 0, (cudaStream_t)stream>>>(
        part, o, K, G, hd, nsplit, q_dtype);
    return (int)cudaGetLastError();
}
