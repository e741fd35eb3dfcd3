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
// under the card's operations-per-byte line: mistral-nemo-12b's 8 lanes of
// 130 blocks of 16 in bf16 are 68,260,864 bytes (0.020 ms at 3.35 TB/s),
// in int8 35,294,720 (0.011 ms).
// Design: the streaming body of decode_stream.cuh (paged_stream_kernel), the
// ring decode kernel's with the rows' addresses from the block table. Rows
// go from device memory straight into registers, 16 bytes a lane whatever
// the codec (16 int8 or 32 int4 codes a lane, so fewer lanes read a row),
// the K and V rows of several positions in flight per lane group before any
// is used; codes are decoded in registers, K's row scale applied to the f32
// score and V's folded into the weight. One online softmax per lane group,
// combined in a fixed order at the end of the block. Thread blocks over
// (context split, kv head x query-row group, lane): the context is split
// over blocks in whole pool blocks, as many as the card keeps resident at
// once (one wave: a block's walk is short, its start and end cost a few
// round trips to memory, and a grid of several waves ends on a partial
// one), and a second small kernel merges the splits in split order. With
// the block mass asked for, a lane group walks whole pool blocks and writes
// each block's (max, sumexp) from its own reduction: no atomics anywhere.
#include "decode_stream.cuh"

// How many thread blocks share one (lane, kv head)'s context (dsp_splits).
extern "C" int paged_decode_splits(int b, int K, int G, int hd, int bs,
                                   int mB, int codec, int mass) {
    PagedStreamArgs a = {};
    a.b = b; a.K = K; a.G = G; a.hd = hd; a.bs = bs; a.mB = mB;
    return dsp_splits(a, codec, mass != 0);
}

// q, o [b, K, G, hd] (q_dtype); pools [n_blocks, bs, K, hd stored] (codec:
// DS_CODEC_*); scales [n_blocks, bs, K] for codes; pool_pos [n_blocks, bs];
// tables [b, mB]; positions [b]; bm, bl [b, mB, K, G] or null; part [b, K,
// nsplit, G, hd + 2] when nsplit > 1. Returns a cudaError_t, or -1 for a
// shape the body does not take.
extern "C" int paged_decode_launch(
    const void* q, void* o, const void* kpool, const void* vpool,
    const float* kscale, const float* vscale, const int* pool_pos,
    const int* tables, const int* positions, float* bm, float* bl,
    int b, int K, int G, int hd, int bs, int mB, int q_dtype, int codec,
    int window, int chunk, float scale, int nsplit, float* part,
    void* stream) {
    PagedStreamArgs a;
    a.q = q; a.o = o; a.kpool = kpool; a.vpool = vpool;
    a.kscale = kscale; a.vscale = vscale; a.pool_pos = pool_pos;
    a.tables = tables; a.positions = positions; a.bm = bm; a.bl = bl;
    a.part = part;
    a.b = b; a.K = K; a.G = G; a.hd = hd; a.bs = bs; a.mB = mB;
    a.q_dtype = q_dtype; a.window = window; a.chunk = chunk; a.scale = scale;
    a.nsplit = nsplit;
    a.span = 0; a.n_gg = 1; a.lpr = 1; a.vec = 0;   // set by dsp_launch
    if (codec >= DS_CODEC_INT8 && (!kscale || !vscale)) return -1;
    return dsp_launch(a, codec, (cudaStream_t)stream);
}
