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
// pool. The split is what makes within-chunk causality safe when a lane's
// queries span several thread blocks: no tile can read a slot another block
// has yet to write. The TPU kernel's one-hot merge matmul and sequential
// block axis are gone.
//
// The attend half has two bodies, chosen by the query's dtype and the pool's
// codec alone (never by the context), and the entry point reports which ran:
//
// bf16 queries over a bf16, int8 or int4 pool, hd a multiple of 8 up to 256:
// the tensor-core body (paged_prefill_tc_kernel), B4's flash forward with
// its K/V rows gathered through the lane's block table. One block of 8 warps
// serves 128 query rows of one (lane, kv head), row m = (chunk token m / G,
// group member m % G), so every K/V tile is read once per G heads; each warp
// owns 16 rows. The lane's logical rows are walked in tiles of BN pool
// positions, independent of the block size (a tile spans several pool
// blocks, or part of one); the walk is worked out once from the rows' own
// positions (pool_pos through the table: live / fully visible / holes),
// never from the tile's index. Tiles go through a two-stage cp.async ring,
// 16 bytes a copy (8 or 4 where a row of codes is shorter); each tile's
// physical slots are looked up two tiles ahead and its positions and scales
// one tile ahead, so no copy waits on the table. Codes (int8 -127..127, int4
// -8..7) are exact in bf16: the raw codes land in a staging tile and are
// converted in shared memory into the bf16 tile ldmatrix reads. S = Q . K^T
// by mma.sync m16n8k16 in f32; K's row scale multiplies the f32 product
// column, then 1/sqrt(hd); the online softmax over a row's four lanes;
// O += P . V with P split into bf16 hi + lo (B4's rounding), V's row scale
// folded into P in f32 before the split (p * vscale). Unassigned table
// entries and unwritten slots (position -1) are masked and their rows
// zeroed before they reach a product. No [chunk, context] matrix and no fp
// copy of a quantised pool reaches device memory.
//
// f32 queries, an f32 pool, or a width the tensor cores do not take: the
// CUDA-core body of paged_attend.cuh, f32 throughout (f32 parity at 1e-4
// excludes bf16 products).
#include "mma_tile.cuh"
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

// ---- bf16 queries: the tensor-core body ------------------------------------

#define PT_WARPS 8
#define PT_THREADS (PT_WARPS * 32)
#define PT_ROWS (PT_WARPS * 16)      // query rows a block serves

struct TcArgs {
    const __nv_bfloat16* q;  // [b, C, K, G, hd]
    __nv_bfloat16* o;        // [b, C, K, G, hd]
    const void* kpool;       // [n_blocks, bs, K, hd stored]
    const void* vpool;
    const float* kscale;     // [n_blocks, bs, K] (codes) or null
    const float* vscale;
    const int* pool_pos;     // [n_blocks, bs]
    const int* tables;       // [b, mB]
    const int* positions;    // [b, C]
    int b, C, K, G, hd, bs, mB;
    int codec;               // PA_POOL_BF16 | PA_POOL_INT8 | PA_POOL_INT4
    int window, chunk;       // 0 = none
    float scale;             // 1 / sqrt(hd)
};

// Bytes a staged row of codes takes in shared memory (16-byte aligned rows).
__host__ __device__ inline int pt_raw_ld(int hd, int codec) {
    return (pa_row_bytes(hd, codec) + 15) & ~15;
}

// The K/V region: bf16 pool k_s[2][BN][LD], v_s[2][BN][LD]; codes k_s[BN]
// [LD], v_s[BN][LD] (converted) then the staged codes rk_s[2][BN][raw],
// rv_s[2][BN][raw].
__host__ __device__ inline size_t pt_kv_bytes(int hdp, int bn, int hd,
                                              int codec) {
    const size_t tile = (size_t)bn * MT_LD(hdp) * 2;
    if (codec == PA_POOL_BF16) return 4 * tile;
    return 2 * tile + 4 * (size_t)bn * pt_raw_ld(hd, codec);
}

// q_s[PT_ROWS][LD] (bf16), the K/V region, then per stage and tile row the
// physical slot, position and (codes) the two row scales: ph_s, kp_s, sk_s,
// sv_s [2][BN]; then the walk's flags fl_s[ntile].
__host__ __device__ inline size_t pt_smem_bytes(int hdp, int bn, int hd,
                                                int codec, int ntile) {
    return (size_t)PT_ROWS * MT_LD(hdp) * 2 + pt_kv_bytes(hdp, bn, hd, codec)
         + 32 * (size_t)bn + ntile;
}

// cp.async of ch = 16, 8 or 4 bytes (zeros when !pred; src still valid).
__device__ __forceinline__ void pt_cp(void* dst, const void* src, int ch,
                                      bool pred) {
    const uint32_t d = mt_smem_addr(dst);
    const int n = pred ? ch : 0;
    if (ch == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     ::"r"(d), "l"(src), "r"(n));
    else if (ch == 8)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                     ::"r"(d), "l"(src), "r"(n));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     ::"r"(d), "l"(src), "r"(n));
}

// Eight codes (int8 bytes, or int4 nibbles low first, stored + 8) as eight
// bf16 values, exactly.
__device__ __forceinline__ uint4 pt_codes8(const unsigned char* src,
                                           int codec) {
    float f[8];
    if (codec == PA_POOL_INT8) {
        const uint2 w = *(const uint2*)src;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            f[k] = (float)(int8_t)((w.x >> (8 * k)) & 0xffu);
            f[4 + k] = (float)(int8_t)((w.y >> (8 * k)) & 0xffu);
        }
    } else {
        const uint32_t w = *(const uint32_t*)src;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const uint32_t byte = (w >> (8 * k)) & 0xffu;
            f[2 * k] = (float)((int)(byte & 0xFu) - 8);
            f[2 * k + 1] = (float)((int)(byte >> 4) - 8);
        }
    }
    return make_uint4(mt_pack(f[0], f[1]), mt_pack(f[2], f[3]),
                      mt_pack(f[4], f[5]), mt_pack(f[6], f[7]));
}

// MINB blocks an SM (two: at most 128 registers a thread).
template <int HDP, int BN, int MINB>
__global__ void __launch_bounds__(PT_THREADS, MINB)
paged_prefill_tc_kernel(TcArgs a) {
    constexpr int LD = MT_LD(HDP), NT = HDP / 8, ST = BN / 8;
    constexpr int RPL = BN / 32;               // tile rows a lane, schedule
    extern __shared__ float4 smem4[];
    unsigned char* sm = (unsigned char*)smem4;
    const bool direct = a.codec == PA_POOL_BF16;
    const int hd = a.hd, G = a.G, K = a.K, C = a.C, bs = a.bs;
    const int M = C * G, nrows = a.mB * bs;
    const int rb = pa_row_bytes(hd, a.codec), rld = pt_raw_ld(hd, a.codec);
    const int ch = (rb & 15) == 0 ? 16 : (rb & 7) == 0 ? 8 : 4;
    __nv_bfloat16* q_s = (__nv_bfloat16*)sm;
    unsigned char* kv = sm + (size_t)PT_ROWS * LD * 2;
    __nv_bfloat16* k_s = (__nv_bfloat16*)kv;
    __nv_bfloat16* v_s = k_s + (direct ? 2 : 1) * BN * LD;
    unsigned char* rk_s = (unsigned char*)(v_s + (direct ? 2 : 1) * BN * LD);
    unsigned char* rv_s = rk_s + 2 * BN * rld;
    int* ph_s = (int*)(kv + pt_kv_bytes(HDP, BN, hd, a.codec));
    int* kp_s = ph_s + 2 * BN;
    float* sk_s = (float*)(kp_s + 2 * BN);
    float* sv_s = sk_s + 2 * BN;
    unsigned char* fl_s = (unsigned char*)(sv_s + 2 * BN);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    // the last query tiles first: they see the most positions
    const int m0 = ((int)gridDim.x - 1 - (int)blockIdx.x) * PT_ROWS;
    const int kh = blockIdx.y, bi = blockIdx.z;
    const int* tbl = a.tables + (size_t)bi * a.mB;
    const int* qpos = a.positions + (size_t)bi * C;

    // ---- query rows (zeros past M), the k padding of every tile
    mt_copy_rows(q_s, LD, a.q, PT_ROWS, hd, [&](int ml) -> long long {
        const int m = m0 + ml;
        if (m >= M) return -1;
        const int c = m / G;
        return ((((long long)bi * C + c) * K + kh) * G + (m - c * G)) * hd;
    }, tid, PT_THREADS);
    mt_cp_commit();
    if (HDP > hd) {
        mt_zero_cols(q_s, LD, PT_ROWS, hd, HDP, tid, PT_THREADS);
        mt_zero_cols(k_s, LD, (direct ? 4 : 2) * BN, hd, HDP, tid,
                     PT_THREADS);                       // k and v
    }
    // this thread's rows: g and g + 8 of the warp's 16
    int qp[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int m = m0 + warp * 16 + g + 8 * i;
        qp[i] = m < M ? qpos[m / G] : -1;
    }
    const bool warp_live = m0 + warp * 16 < M;
    const int c_lo = m0 / G, c_hi = (min(m0 + PT_ROWS, M) - 1) / G;
    const MtSpan qs = mt_span(qpos + c_lo, c_hi - c_lo + 1, lane);

    // physical slot of row r of tile j (-1: past the table or unassigned)
    auto phys = [&](int j, int r) -> int {
        const int R = j * BN + r;
        if (r >= BN || R >= nrows) return -1;
        const int e = tbl[R / bs];
        return e < 0 ? -1 : e * bs + (R - (R / bs) * bs);
    };

    // ---- the walk over the tiles, from the rows' own positions: a warp a
    // tile, four tiles' loads in flight
    const int ntile = qs.hi >= 0 ? (nrows + BN - 1) / BN : 0;
    for (int j0 = warp * 4; j0 < ntile; j0 += PT_WARPS * 4) {
        int slot[4][RPL], cp[4][RPL];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int i = 0; i < RPL; ++i)
                slot[u][i] = j0 + u < ntile ? phys(j0 + u, lane + 32 * i)
                                            : -1;
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int i = 0; i < RPL; ++i)
                cp[u][i] = slot[u][i] >= 0 ? a.pool_pos[slot[u][i]] : -1;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            int lo = 0x7fffffff, hi = -1, bad = 0;
#pragma unroll
            for (int i = 0; i < RPL; ++i) {
                if (cp[u][i] >= 0) {
                    lo = min(lo, cp[u][i]);
                    hi = max(hi, cp[u][i]);
                } else {
                    bad = 1;
                }
            }
            MtSpan ks;
            ks.lo = mt_warp_min(lo);
            ks.hi = mt_warp_max(hi);
            ks.all = !__any_sync(0xffffffffu, bad);
            unsigned char f = ks.all ? 0 : MT_HOLES;
            if (mt_live(qs, ks, a.window, a.chunk))
                f |= MT_LIVE | (mt_full(qs, ks, a.window, a.chunk) ? MT_FULL
                                                                   : 0);
            if (lane == 0 && j0 + u < ntile) fl_s[j0 + u] = f;
        }
    }
    __syncthreads();

    // K and V rows of the tile whose slots are in ph_s[st] into stage st:
    // bf16 rows straight into the tiles, codes into the staging tiles
    auto load = [&](int st) {
        const int* ph = ph_s + st * BN;
        if (direct) {
            auto off = [&](int r) -> long long {
                return ph[r] < 0 ? -1 : ((long long)ph[r] * K + kh) * hd;
            };
            mt_copy_rows(k_s + st * BN * LD, LD,
                         (const __nv_bfloat16*)a.kpool, BN, hd, off, tid,
                         PT_THREADS);
            mt_copy_rows(v_s + st * BN * LD, LD,
                         (const __nv_bfloat16*)a.vpool, BN, hd, off, tid,
                         PT_THREADS);
            return;
        }
        const int nch = rb / ch;
        for (int i = tid; i < BN * nch; i += PT_THREADS) {
            const int r = i / nch, c = i - r * nch;
            const long long o = ph[r] < 0 ? 0
                : ((long long)ph[r] * K + kh) * rb + (long long)c * ch;
            const size_t d = ((size_t)st * BN + r) * rld + (size_t)c * ch;
            pt_cp(rk_s + d, (const unsigned char*)a.kpool + o, ch, ph[r] >= 0);
            pt_cp(rv_s + d, (const unsigned char*)a.vpool + o, ch, ph[r] >= 0);
        }
    };

    int cur = mt_next(fl_s, 0, ntile);
    const int nxt0 = cur < ntile ? mt_next(fl_s, cur + 1, ntile) : ntile;
    if (tid < BN) {
        ph_s[tid] = cur < ntile ? phys(cur, tid) : -1;
        ph_s[BN + tid] = nxt0 < ntile ? phys(nxt0, tid) : -1;
    }
    __syncthreads();
    if (cur < ntile) {
        load(0);
        if (tid < BN) {
            const int ph = ph_s[tid];
            const int kp = ph >= 0 ? a.pool_pos[ph] : -1;
            kp_s[tid] = kp;
            sk_s[tid] = (!direct && kp >= 0) ? a.kscale[(size_t)ph * K + kh]
                                             : 0.f;
            sv_s[tid] = (!direct && kp >= 0) ? a.vscale[(size_t)ph * K + kh]
                                             : 0.f;
        }
    }
    mt_cp_commit();

    float o[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m[2] = {PA_NEG_INF, PA_NEG_INF}, l[2] = {0.f, 0.f};
    for (int st = 0; cur < ntile; st ^= 1) {
        const int nxt = mt_next(fl_s, cur + 1, ntile);
        const int nx2 = nxt < ntile ? mt_next(fl_s, nxt + 1, ntile) : ntile;
        // the next tile's copies (its slots were looked up a round ago),
        // its positions and scales into registers, and the slots of the
        // tile after it: all in flight while this tile is computed
        int kp_n = -1;
        float sk_n = 0.f, sv_n = 0.f;
        if (nxt < ntile) {
            load(st ^ 1);
            const int ph = tid < BN ? ph_s[(st ^ 1) * BN + tid] : -1;
            if (ph >= 0) {
                kp_n = a.pool_pos[ph];
                if (!direct) {
                    sk_n = a.kscale[(size_t)ph * K + kh];
                    sv_n = a.vscale[(size_t)ph * K + kh];
                }
            }
        }
        const int ph_n2 = (tid < BN && nx2 < ntile) ? phys(nx2, tid) : -1;
        mt_cp_commit();
        mt_cp_wait<1>();             // Q and this tile have landed
        __syncthreads();
        const int* kps = kp_s + st * BN;
        const float* sks = sk_s + st * BN;
        const float* svs = sv_s + st * BN;
        const unsigned char f = fl_s[cur];
        const __nv_bfloat16 *ks, *vs;
        if (direct) {
            ks = k_s + st * BN * LD;
            vs = v_s + st * BN * LD;
            if (f & MT_HOLES) {      // unassigned or unwritten slots
                mt_zero_holes(k_s + st * BN * LD, LD, kps, BN, HDP, tid,
                              PT_THREADS);
                mt_zero_holes(v_s + st * BN * LD, LD, kps, BN, HDP, tid,
                              PT_THREADS);
                __syncthreads();
            }
        } else {
            // codes -> bf16 tiles, eight a thread at a time; rows with no
            // position become zeros
            const int units = hd >> 3;
            const int ub = a.codec == PA_POOL_INT8 ? 8 : 4;
            for (int i = tid; i < 2 * BN * units; i += PT_THREADS) {
                const int which = i / (BN * units);
                const int rem = i - which * BN * units;
                const int r = rem / units, u = rem - r * units;
                const unsigned char* src = (which ? rv_s : rk_s)
                    + ((size_t)st * BN + r) * rld + u * ub;
                uint4 w = make_uint4(0u, 0u, 0u, 0u);
                if (kps[r] >= 0) w = pt_codes8(src, a.codec);
                *(uint4*)((which ? v_s : k_s) + r * LD + u * 8) = w;
            }
            __syncthreads();
            ks = k_s;
            vs = v_s;
        }
        const bool full = f & MT_FULL;
        if (warp_live) {
            // ---- S = Q . K^T
            float s[ST][4];
#pragma unroll
            for (int j = 0; j < ST; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
            for (int kc = 0; kc < HDP / 16; ++kc) {
                uint32_t af[4];
                mt_frag_a(af, q_s, LD, warp * 16, kc * 16, lane);
#pragma unroll
                for (int np = 0; np < BN / 16; ++np) {
                    uint32_t bf[4];
                    mt_frag_b(bf, ks, LD, np * 16, kc * 16, lane);
                    mt_mma(s[2 * np], af, bf);
                    mt_mma(s[2 * np + 1], af, bf + 2);
                }
            }
            // ---- K's row scale, 1/sqrt(hd), mask, online softmax
            float mx[2] = {PA_NEG_INF, PA_NEG_INF};
#pragma unroll
            for (int j = 0; j < ST; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int i = e >> 1, col = j * 8 + 2 * t4 + (e & 1);
                    float x = direct ? s[j][e] * a.scale
                                     : (s[j][e] * sks[col]) * a.scale;
                    if (!full) {
                        const int kp = kps[col];
                        bool vis = kp >= 0 && kp <= qp[i];
                        if (a.window > 0) vis = vis && kp > qp[i] - a.window;
                        if (a.chunk > 0)
                            vis = vis && kp / a.chunk == qp[i] / a.chunk;
                        if (!vis) x = PA_NEG_INF;
                    }
                    s[j][e] = x;
                    mx[i] = fmaxf(mx[i], x);
                }
            float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
                mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
                const float m_new = fmaxf(m[i], mx[i]);
                corr[i] = expf(m[i] - m_new);    // both -1e30 -> 1
                m[i] = m_new;
            }
#pragma unroll
            for (int j = 0; j < ST; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int i = e >> 1;
                    const float x = s[j][e];
                    const float p = (x > -1e29f) ? expf(x - m[i]) : 0.f;
                    rs[i] += p;
                    // V's row scale in the weight, f32, before the split
                    s[j][e] = direct ? p : p * svs[j * 8 + 2 * t4 + (e & 1)];
                }
#pragma unroll
            for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                o[n][0] *= corr[0];
                o[n][1] *= corr[0];
                o[n][2] *= corr[1];
                o[n][3] *= corr[1];
            }
            // ---- O += P . V, P as bf16 hi + lo
#pragma unroll
            for (int kk = 0; kk < BN / 16; ++kk) {
                uint32_t hi[4], lo[4];
                mt_c_to_a(s, kk, hi, lo);
#pragma unroll
                for (int np = 0; np < HDP / 16; ++np) {
                    uint32_t bf[4];
                    mt_frag_b_t(bf, vs, LD, kk * 16, np * 16, lane);
                    mt_mma(o[2 * np], hi, bf);
                    mt_mma(o[2 * np], lo, bf);
                    mt_mma(o[2 * np + 1], hi, bf + 2);
                    mt_mma(o[2 * np + 1], lo, bf + 2);
                }
            }
        }
        if (tid < BN) {
            if (nxt < ntile) {
                const int s2 = (st ^ 1) * BN + tid;
                kp_s[s2] = kp_n;
                sk_s[s2] = kp_n >= 0 ? sk_n : 0.f;
                sv_s[s2] = kp_n >= 0 ? sv_n : 0.f;
            }
            ph_s[st * BN + tid] = ph_n2;   // its copies were issued
        }
        __syncthreads();             // this stage is refilled next round
        cur = nxt;
    }
    mt_cp_wait<0>();

    // ---- finalise: a row that saw nothing gives 0
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        const int mr = m0 + warp * 16 + g + 8 * i;
        if (mr >= M) continue;
        const int c = mr / G;
        const size_t row = (((size_t)bi * C + c) * K + kh) * G + (mr - c * G);
        const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            const int col = n * 8 + 2 * t4;
            if (col < hd)
                *(uint32_t*)(a.o + row * hd + col) =
                    mt_pack(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
        }
    }
}

template <int HDP, int BN, int MINB>
static int pt_launch(const TcArgs& a, dim3 grid, cudaStream_t stream) {
    const int ntile = (a.mB * a.bs + BN - 1) / BN;
    const size_t smem = pt_smem_bytes(HDP, BN, a.hd, a.codec, ntile);
    if (smem > 227 * 1024) return -1;
    // the attribute is raised only past the largest size this instantiation
    // has launched at, not on every launch (a host call per layer and chunk)
    static size_t allowed = 0;
    if (smem > allowed) {
        cudaError_t e = cudaFuncSetAttribute(
            paged_prefill_tc_kernel<HDP, BN, MINB>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        allowed = smem;
    }
    paged_prefill_tc_kernel<HDP, BN, MINB><<<grid, PT_THREADS, smem,
                                              stream>>>(a);
    return (int)cudaGetLastError();
}

// B4's tile widths: 64 positions to hd 96 (two blocks an SM), 32 at 112 /
// 128 (two blocks an SM: 64 would spill), 64 above (one block an SM). At hd
// 128, a grid that gives no SM a second block (a chunk call of one or two
// lanes: 64 or 128 blocks on 132 SMs) takes 64-position tiles at one block
// an SM instead: half the tiles, barriers and table lookups, the SM's
// registers to one block. On the H100 each was the faster of the two on
// its side of that line.
static int pt_dispatch(const TcArgs& a, cudaStream_t st) {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    dim3 g((a.C * a.G + PT_ROWS - 1) / PT_ROWS, a.K, a.b);
    switch (mt_hdp(a.hd)) {
    case 16: return pt_launch<16, 64, 2>(a, g, st);
    case 32: return pt_launch<32, 64, 2>(a, g, st);
    case 48: return pt_launch<48, 64, 2>(a, g, st);
    case 64: return pt_launch<64, 64, 2>(a, g, st);
    case 80: return pt_launch<80, 64, 2>(a, g, st);
    case 96: return pt_launch<96, 64, 2>(a, g, st);
    case 112: return pt_launch<112, 32, 2>(a, g, st);
    case 128:
        if ((long long)g.x * g.y * g.z <= sms)
            return pt_launch<128, 64, 1>(a, g, st);
        return pt_launch<128, 32, 2>(a, g, st);
    case 160: return pt_launch<160, 64, 1>(a, g, st);
    case 192: return pt_launch<192, 64, 1>(a, g, st);
    case 224: return pt_launch<224, 64, 1>(a, g, st);
    case 256: return pt_launch<256, 64, 1>(a, g, st);
    default: return -1;
    }
}

// The body a launch takes: 1 (tensor cores) for bf16 queries over a bf16,
// int8 or int4 pool at a head width mt_hdp takes, else 0 (CUDA cores).
static int paged_prefill_body(int q_dtype, int codec, int hd) {
    return q_dtype == PA_BF16 && codec != PA_POOL_F32 && mt_hdp(hd) != 0;
}

// Returns a cudaError_t, -1 when the shape is not supported, or -2 when the
// tensor-core body would run on pool leaves not 16-byte aligned (it copies
// rows 16 bytes at a time); *body is set to the attend body that ran
// (paged_prefill_body).
extern "C" int paged_prefill_launch(
    const void* q, const void* knew, const void* vnew, void* o,
    void* kpool, void* vpool, float* kscale, float* vscale, int* pool_pos,
    const int* tables, const int* positions,
    int b, int C, int K, int G, int hd, int bs, int mB, int q_dtype,
    int codec, int window, int chunk, float scale, int* body, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    *body = paged_prefill_body(q_dtype, codec, hd);
    if (*body && (((uintptr_t)kpool | (uintptr_t)vpool) & 15)) return -2;
    WriteArgs w;
    w.knew = knew; w.vnew = vnew; w.kpool = kpool; w.vpool = vpool;
    w.kscale = kscale; w.vscale = vscale; w.pool_pos = pool_pos;
    w.tables = tables; w.positions = positions;
    w.b = b; w.C = C; w.K = K; w.hd = hd; w.bs = bs; w.mB = mB;
    w.in_dtype = q_dtype; w.codec = codec;
    paged_write_kernel<<<dim3(C, b), PA_THREADS, 0, st>>>(w);
    int e = (int)cudaGetLastError();
    if (e != 0) return e;

    if (*body) {
        TcArgs t;
        t.q = (const __nv_bfloat16*)q; t.o = (__nv_bfloat16*)o;
        t.kpool = kpool; t.vpool = vpool; t.kscale = kscale;
        t.vscale = vscale; t.pool_pos = pool_pos; t.tables = tables;
        t.positions = positions;
        t.b = b; t.C = C; t.K = K; t.G = G; t.hd = hd; t.bs = bs; t.mB = mB;
        t.codec = codec; t.window = window; t.chunk = chunk; t.scale = scale;
        return pt_dispatch(t, st);
    }
    AttendArgs a;
    a.q = q; a.o = o; a.kpool = kpool; a.vpool = vpool;
    a.kscale = kscale; a.vscale = vscale; a.pool_pos = pool_pos;
    a.tables = tables; a.positions = positions;
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
    return pa_launch(a, st);
}
