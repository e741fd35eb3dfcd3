// Paged flash-prefill for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel kernels/prefill_attention.py · paged_prefill_attention_fwd
// (body _prefill_kernel) of the reference package: write a prompt chunk into
// the paged KV pool through the block tables (per-row absmax quantisation,
// nibble packing) and flash-attend the chunk's queries over history + chunk
// against the post-write pool.
//
// Bound on this card: operations at serving shapes (C = 256 queries against
// up to thousands of positions: 4*C*G*hd operations per position and kv head
// against 2*hd stored values), bytes only for short contexts.
// Design: two kernels launched in order on one stream. (a) write: one thread
// block per chunk row encodes and stores that row's K and V for every kv
// head; padding rows and rows whose logical block is unmapped write nothing.
// (b) attend: grid over (query tile, kv head, lane) reading the post-write
// pool with the tiled online softmax of paged_attend.cuh. The split is what
// makes within-chunk causality safe when a lane's queries span several
// thread blocks: no tile can read a slot another block has yet to write.
// The TPU kernel's one-hot merge matmul and sequential block axis are gone.
#include "paged_attend.cuh"

struct WriteArgs {
    const void* knew;        // [b, C, K, hd]
    const void* vnew;
    void* kpool;             // [n_blocks, bs, K, hd_stored]
    void* vpool;
    float* kscale;           // [n_blocks, bs, K] or null
    float* vscale;
    int* pool_pos;           // [n_blocks, bs]
    const int* tables;       // [b, mB]
    const int* positions;    // [b, C]
    int b, C, K, hd, bs, mB;
    int in_dtype, codec;
};

__device__ __forceinline__ float block_max(float v, float* red) {
    v = pa_warp_max(v);
    int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();                 // red may still be read from last use
    if (lane == 0) red[warp] = v;
    __syncthreads();
    float r = red[0];
    for (int w = 1; w < PA_THREADS / 32; ++w) r = fmaxf(r, red[w]);
    return r;
}

// Encode one row (hd values of one token and kv head) into the pool.
// scale = absmax / qmax and code = rint(x / max(scale, 1e-30)), both by
// IEEE division and round-half-to-even, exactly as the plain version.
__device__ void write_row(const void* src, size_t src_off, void* pool,
                          float* scales, size_t row, int hd, int in_dtype,
                          int codec, float* red) {
    const int tid = threadIdx.x;
    if (codec == PA_POOL_F32 || codec == PA_POOL_BF16) {
        for (int h = tid; h < hd; h += PA_THREADS) {
            float x = pa_load(src, src_off + h, in_dtype);
            if (codec == PA_POOL_BF16)
                ((__nv_bfloat16*)pool)[row * hd + h] = __float2bfloat16(x);
            else
                ((float*)pool)[row * hd + h] = x;
        }
        return;
    }
    float amax = 0.f;
    for (int h = tid; h < hd; h += PA_THREADS)
        amax = fmaxf(amax, fabsf(pa_load(src, src_off + h, in_dtype)));
    amax = block_max(amax, red);
    const float qmax = (codec == PA_POOL_INT8) ? 127.f : 7.f;
    const float scale = __fdiv_rn(amax, qmax);
    const float den = fmaxf(scale, 1e-30f);
    if (tid == 0) scales[row] = scale;
    if (codec == PA_POOL_INT8) {
        for (int h = tid; h < hd; h += PA_THREADS) {
            float x = pa_load(src, src_off + h, in_dtype);
            float c = fminf(fmaxf(rintf(__fdiv_rn(x, den)), -qmax), qmax);
            ((int8_t*)pool)[row * hd + h] = (int8_t)(int)c;
        }
    } else {
        int half = hd / 2;
        for (int j = tid; j < half; j += PA_THREADS) {
            float x0 = pa_load(src, src_off + 2 * j, in_dtype);
            float x1 = pa_load(src, src_off + 2 * j + 1, in_dtype);
            float c0 = fminf(fmaxf(rintf(__fdiv_rn(x0, den)), -qmax), qmax);
            float c1 = fminf(fmaxf(rintf(__fdiv_rn(x1, den)), -qmax), qmax);
            unsigned lo = (unsigned)((int)c0 + 8), hi = (unsigned)((int)c1 + 8);
            ((uint8_t*)pool)[row * (size_t)half + j] = (uint8_t)(lo | (hi << 4));
        }
    }
}

__global__ void __launch_bounds__(PA_THREADS)
paged_write_kernel(WriteArgs a) {
    __shared__ float red[PA_THREADS / 32];
    const int c = blockIdx.x, bi = blockIdx.y;
    const int pos = a.positions[(size_t)bi * a.C + c];
    if (pos < 0) return;                         // padding row
    const int lb = pos / a.bs;
    if (lb >= a.mB) return;                      // outside the table
    const int ent = a.tables[(size_t)bi * a.mB + lb];
    if (ent < 0) return;                         // logical block unmapped
    const size_t slot = (size_t)ent * a.bs + (pos % a.bs);
    if (threadIdx.x == 0) a.pool_pos[slot] = pos;  // no head axis: once
    for (int kh = 0; kh < a.K; ++kh) {
        size_t src = (((size_t)bi * a.C + c) * a.K + kh) * a.hd;
        size_t row = slot * a.K + kh;
        write_row(a.knew, src, a.kpool, a.kscale, row, a.hd, a.in_dtype,
                  a.codec, red);
        write_row(a.vnew, src, a.vpool, a.vscale, row, a.hd, a.in_dtype,
                  a.codec, red);
    }
}

extern "C" int paged_prefill_launch(
    const void* q, const void* knew, const void* vnew, void* o,
    void* kpool, void* vpool, float* kscale, float* vscale, int* pool_pos,
    const int* tables, const int* positions,
    int b, int C, int K, int G, int hd, int bs, int mB, int q_dtype,
    int codec, int window, int chunk, float scale, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    WriteArgs w;
    w.knew = knew; w.vnew = vnew; w.kpool = kpool; w.vpool = vpool;
    w.kscale = kscale; w.vscale = vscale; w.pool_pos = pool_pos;
    w.tables = tables; w.positions = positions;
    w.b = b; w.C = C; w.K = K; w.hd = hd; w.bs = bs; w.mB = mB;
    w.in_dtype = q_dtype; w.codec = codec;
    paged_write_kernel<<<dim3(C, b), PA_THREADS, 0, st>>>(w);
    int e = (int)cudaGetLastError();
    if (e != 0) return e;

    AttendArgs a;
    a.q = q; a.o = o; a.kpool = kpool; a.vpool = vpool;
    a.kscale = kscale; a.vscale = vscale; a.pool_pos = pool_pos;
    a.tables = tables; a.positions = positions; a.bm = nullptr; a.bl = nullptr;
    a.b = b; a.C = C; a.K = K; a.G = G; a.hd = hd; a.bs = bs; a.mB = mB;
    a.q_dtype = q_dtype; a.codec = codec; a.window = window; a.chunk = chunk;
    int M = C * G;
    int qr = 8192 / hd;
    if (qr > 64) qr = 64;
    if (qr > M) qr = M;
    if (qr < 1) qr = 1;
    a.QR = qr;
    a.TR = pa_tile_rows(hd, bs);
    a.scale = scale;
    a.nsplit = 1;
    a.part = nullptr;
    return pa_launch(a, st);
}
