// Decode attention streamed from device memory into registers: the body of
// the ring decode kernel (one query token per lane against that lane's ring
// of K/V rows [b, L, K, hd], slot = position % L, cache_pos [b, L]) and,
// below it, of the paged decode kernel (the same walk with each row's
// address from a block table, int8 / int4 codes decoded in registers, the
// optional per-block mass).
//
// The function is bound by bytes: each visible ring row is read once and
// costs 4 * G * hd operations. So the body keeps loads in flight and never
// stages a row in shared memory:
//   - a row of hd elements is read by a group of LPR lanes (the power of two
//     at or above hd / 8), each lane taking 8 consecutive elements with one
//     16-byte load (two for an f32 ring): one warp covers a bf16 row of 256
//     elements, two rows of 128, four of 64;
//   - every lane group keeps its own online softmax (running max, sum and
//     p.V for GG query rows, all in registers) and walks the block's ring
//     positions U at a time, issuing the K and V loads of all U positions
//     before it touches any of them (U x 2 x 16 bytes a lane in flight);
//   - scores are reduced over the group's lanes by shuffles, so every lane
//     of a group holds the same score, max and weights;
//   - a position is loaded only if its own cache_pos entry is visible to the
//     query (a ring that has wrapped is not in position order: nothing is
//     skipped by index); -1 is an empty slot, a query position < 0 an inert
//     lane, which sees nothing and gives exact zeros;
//   - at the end the block's lane groups are combined in shared memory in a
//     fixed order (no atomics), into the output or, when the ring is split
//     over blocks, into a partial state (sum, max, denominator) that
//     ds_merge_kernel folds, again in a fixed order.
// f32 arithmetic on f32 / bf16 rings and queries, IEEE (no fast math);
// masked scores -1e30, denominator max(l, 1e-30). The block's shared memory
// (positions staged per page, the combine buffer) stays under 48 KB, so no
// ring launch needs a dynamic shared-memory attribute.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define DS_WARPS 4
#define DS_THREADS (32 * DS_WARPS)
#define DS_EPL 8                 // elements of a row one lane owns
#define DS_PAGE 1024             // ring positions staged in shared memory
#define DS_NEG_INF (-1e30f)
#define DS_GG_MAX 4              // query rows a block carries
#define DS_MERGE_MAX 64          // splits the merge takes
#define DS_BF16 1

struct StreamArgs {
    const void* q;               // [b, K, G, hd]
    void* o;                     // [b, K, G, hd], q's dtype
    const void* k;               // [b, L, K, hd]
    const void* v;
    const int* cache_pos;        // [b, L], -1 = empty
    const int* positions;        // [b], < 0 = inert
    float* part;                 // [b, K, nsplit, G, hd + 2] when nsplit > 1
    int b, L, K, G, hd, q_dtype;
    int window, chunk;           // 0 = none
    float scale;                 // 1 / sqrt(hd)
    int nsplit, span;            // blocks a ring is split over, positions each
    int n_gg;                    // blocks over a kv head's G query rows
    int lpr;                     // lanes a row: power of two, hd <= 8 lpr
    int vec;                     // rows 16-byte aligned: vector loads
};

__device__ __forceinline__ bool ds_visible(int cpos, int qpos, int window,
                                           int chunk) {
    bool m = (cpos >= 0) && (qpos >= 0) && (cpos <= qpos);
    if (window > 0) m = m && (cpos > qpos - window);
    if (chunk > 0) m = m && ((cpos / chunk) == (qpos / chunk));
    return m;
}

__device__ __forceinline__ float ds_load(const void* p, size_t i, int dt) {
    if (dt == DS_BF16) return __bfloat162float(((const __nv_bfloat16*)p)[i]);
    return ((const float*)p)[i];
}

__device__ __forceinline__ void ds_store(void* p, size_t i, int dt, float x) {
    if (dt == DS_BF16) ((__nv_bfloat16*)p)[i] = __float2bfloat16(x);
    else ((float*)p)[i] = x;
}

// A lane's 8 elements e0.. of ring row `row` as raw words (zeros past hd, or
// when `on` is false: then nothing is read).
template <bool F32>
__device__ __forceinline__ void ds_fetch(const void* base, size_t row,
                                         int hd, int e0, bool vec, bool on,
                                         uint4* r) {
    constexpr int CPL = F32 ? 2 : 1;
#pragma unroll
    for (int j = 0; j < CPL; ++j) r[j] = make_uint4(0u, 0u, 0u, 0u);
    if (!on || e0 >= hd) return;
    if constexpr (F32) {
        const float* p = (const float*)base + row * hd + e0;
        if (vec) {
            r[0] = __ldg((const uint4*)p);
            if (e0 + 4 < hd) r[1] = __ldg((const uint4*)(p + 4));
        } else {
            uint32_t x[8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
                x[i] = (e0 + i < hd) ? __float_as_uint(__ldg(p + i)) : 0u;
            r[0] = make_uint4(x[0], x[1], x[2], x[3]);
            r[1] = make_uint4(x[4], x[5], x[6], x[7]);
        }
    } else {
        const unsigned short* p = (const unsigned short*)base + row * hd + e0;
        if (vec) {
            r[0] = __ldg((const uint4*)p);
        } else {
            uint32_t x[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                uint32_t lo = (e0 + 2 * i < hd) ? __ldg(p + 2 * i) : 0u;
                uint32_t hi = (e0 + 2 * i + 1 < hd) ? __ldg(p + 2 * i + 1)
                                                    : 0u;
                x[i] = lo | (hi << 16);
            }
            r[0] = make_uint4(x[0], x[1], x[2], x[3]);
        }
    }
}

template <bool F32>
__device__ __forceinline__ void ds_unpack(const uint4* r, float* f) {
    if constexpr (F32) {
        f[0] = __uint_as_float(r[0].x); f[1] = __uint_as_float(r[0].y);
        f[2] = __uint_as_float(r[0].z); f[3] = __uint_as_float(r[0].w);
        f[4] = __uint_as_float(r[1].x); f[5] = __uint_as_float(r[1].y);
        f[6] = __uint_as_float(r[1].z); f[7] = __uint_as_float(r[1].w);
    } else {
        const uint32_t w[4] = {r[0].x, r[0].y, r[0].z, r[0].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            f[2 * i] = __uint_as_float(w[i] << 16);
            f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        }
    }
}

// Ring positions a lane group has in flight: four (two on an f32 ring with
// four query rows, for registers). Eight, tried at gemma3-12b's rings on
// the H100, was no faster at the global ring and slower at the local one:
// the registers it takes cost blocks an SM.
template <int GG, bool F32>
__host__ __device__ constexpr int ds_steps() {
    return (F32 && GG == 4) ? 2 : 4;
}

// Shared memory of the combine: [lane groups][GG][hd + 2] floats.
__host__ __device__ inline size_t ds_smem_bytes(int hd, int lpr, int GG) {
    return (size_t)DS_WARPS * (32 / lpr) * GG * (hd + 2) * sizeof(float);
}

// The block's lane groups combined in group order: each group's (acc, m, l)
// of GG query rows into shared memory st_s [groups][GG][hd + 2], then one
// thread an output element folds them into query row g0 + g of (bi, kh),
// or, when the context is split over blocks, into the split's partial
// state part [b, K, nsplit, G, hd + 2] (sum, max, denominator).
template <int GG, int EPL>
__device__ __forceinline__ void ds_combine(
    float* st_s, const float (&acc)[GG][EPL], const float* m, const float* l,
    int grp, int ngrp, int lr, int e0, int hd, int G, int K, int g0, int bi,
    int kh, int split, int nsplit, float* part, void* o, int q_dtype) {
    const int hs = hd + 2;
#pragma unroll
    for (int g = 0; g < GG; ++g) {
        float* r = st_s + ((size_t)grp * GG + g) * hs;
#pragma unroll
        for (int e = 0; e < EPL; ++e)
            if (e0 + e < hd) r[e0 + e] = acc[g][e];
        if (lr == 0) {
            r[hd] = m[g];
            r[hd + 1] = l[g];
        }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < GG * hd; idx += DS_THREADS) {
        const int g = idx / hd, h = idx - g * hd, gq = g0 + g;
        if (gq >= G) continue;
        float M = DS_NEG_INF;
        for (int j = 0; j < ngrp; ++j)
            M = fmaxf(M, st_s[((size_t)j * GG + g) * hs + hd]);
        float num = 0.f, den = 0.f;
        for (int j = 0; j < ngrp; ++j) {
            const float* r = st_s + ((size_t)j * GG + g) * hs;
            const float w = expf(r[hd] - M);
            num = fmaf(r[h], w, num);
            den = fmaf(r[hd + 1], w, den);
        }
        if (nsplit > 1) {
            float* pr = part
                + ((((size_t)bi * K + kh) * nsplit + split) * G + gq) * hs;
            pr[h] = num;
            if (h == 0) {
                pr[hd] = M;
                pr[hd + 1] = den;
            }
        } else {
            // a lane that saw nothing: num = 0, den = 0 -> exact zeros
            ds_store(o, (((size_t)bi * K + kh) * G + gq) * hd + h, q_dtype,
                     num / fmaxf(den, 1e-30f));
        }
    }
}

// Grid (split, kv head x query-row group, lane); DS_THREADS threads.
template <int GG, bool F32>
__global__ void __launch_bounds__(DS_THREADS)
ring_stream_kernel(StreamArgs a) {
    constexpr int CPL = F32 ? 2 : 1;
    constexpr int U = ds_steps<GG, F32>();
    extern __shared__ float4 smem4[];
    float* st_s = (float*)smem4;
    __shared__ int cp_s[DS_PAGE];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int lpr = a.lpr, rpw = 32 / lpr;
    const int rg = lane / lpr, lr = lane - rg * lpr;
    const int grp = warp * rpw + rg, ngrp = DS_WARPS * rpw;
    const int e0 = lr * DS_EPL;
    const int split = blockIdx.x;
    const int kh = blockIdx.y / a.n_gg;
    const int g0 = (blockIdx.y - kh * a.n_gg) * GG;
    const int bi = blockIdx.z;
    const int hd = a.hd, K = a.K, G = a.G, L = a.L;
    const int qpos = a.positions[bi];
    const bool vec = a.vec != 0;

    // ---- the query rows, pre-scaled by 1/sqrt(hd), in registers
    float qr[GG][DS_EPL];
#pragma unroll
    for (int g = 0; g < GG; ++g)
#pragma unroll
        for (int e = 0; e < DS_EPL; ++e) {
            const int h = e0 + e, gq = g0 + g;
            qr[g][e] = (gq < G && h < hd)
                ? ds_load(a.q, (((size_t)bi * K + kh) * G + gq) * hd + h,
                          a.q_dtype) * a.scale
                : 0.f;
        }
    float m[GG], l[GG], acc[GG][DS_EPL];
#pragma unroll
    for (int g = 0; g < GG; ++g) {
        m[g] = DS_NEG_INF;
        l[g] = 0.f;
#pragma unroll
        for (int e = 0; e < DS_EPL; ++e) acc[g][e] = 0.f;
    }

    const int t_begin = (int)min((long long)split * a.span, (long long)L);
    const int t_end = (int)min((long long)t_begin + a.span, (long long)L);
    for (int p0 = t_begin; p0 < t_end; p0 += DS_PAGE) {
        const int pn = min(DS_PAGE, t_end - p0);
        __syncthreads();                       // the last page is consumed
        for (int i = tid; i < pn; i += DS_THREADS)
            cp_s[i] = a.cache_pos[(size_t)bi * L + p0 + i];
        __syncthreads();
        if (qpos < 0) continue;                // inert: nothing is visible
        // the warp's groups take positions w0 + rg + u * ngrp; the loop
        // bound is the warp's, so its shuffles see all 32 lanes
        for (int w0 = warp * rpw; w0 < pn; w0 += ngrp * U) {
            uint4 kr[U][CPL], vr[U][CPL];
            bool vis[U];
            bool any = false;
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int i = w0 + rg + u * ngrp;
                vis[u] = (i < pn) && ds_visible(cp_s[i], qpos, a.window,
                                                a.chunk);
                const size_t row = ((size_t)bi * L + p0 + i) * K + kh;
                ds_fetch<F32>(a.k, row, hd, e0, vec, vis[u], kr[u]);
                ds_fetch<F32>(a.v, row, hd, e0, vec, vis[u], vr[u]);
                any |= vis[u];
            }
            if (!__any_sync(0xffffffffu, any)) continue;
            // ---- scores: this lane's 8 products, then the group's sum
            float s[U][GG];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                float kf[DS_EPL];
                ds_unpack<F32>(kr[u], kf);
#pragma unroll
                for (int g = 0; g < GG; ++g) {
                    float d = 0.f;
#pragma unroll
                    for (int e = 0; e < DS_EPL; ++e)
                        d = fmaf(qr[g][e], kf[e], d);
                    s[u][g] = d;
                }
            }
            for (int o = lpr >> 1; o > 0; o >>= 1)
#pragma unroll
                for (int u = 0; u < U; ++u)
#pragma unroll
                    for (int g = 0; g < GG; ++g)
                        s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], o);
            // ---- online softmax over the U positions (s becomes p)
#pragma unroll
            for (int g = 0; g < GG; ++g) {
                float mx = m[g];
#pragma unroll
                for (int u = 0; u < U; ++u)
                    if (vis[u]) mx = fmaxf(mx, s[u][g]);
                const float corr = expf(m[g] - mx);   // both -1e30 -> 1
                float ps = 0.f;
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    const float p = vis[u] ? expf(s[u][g] - mx) : 0.f;
                    s[u][g] = p;
                    ps += p;
                }
                l[g] = l[g] * corr + ps;
                m[g] = mx;
#pragma unroll
                for (int e = 0; e < DS_EPL; ++e) acc[g][e] *= corr;
            }
            // ---- acc += p . V
#pragma unroll
            for (int u = 0; u < U; ++u) {
                float vf[DS_EPL];
                ds_unpack<F32>(vr[u], vf);
#pragma unroll
                for (int g = 0; g < GG; ++g)
#pragma unroll
                    for (int e = 0; e < DS_EPL; ++e)
                        acc[g][e] = fmaf(s[u][g], vf[e], acc[g][e]);
            }
        }
    }

    ds_combine<GG, DS_EPL>(st_s, acc, m, l, grp, ngrp, lr, e0, hd, G, K,
                           g0, bi, kh, split, a.nsplit, a.part, a.o,
                           a.q_dtype);
}

// Merge of the splits' partial states: grid (G, K, b), a thread per output
// element of the row, splits in order. o = sum_s acc_s e^(m_s - M) /
// max(sum_s l_s e^(m_s - M), 1e-30). One warp works out the splits'
// weights e^(m_s - M) and the denominator (a lane per split, reduced by
// shuffles in a fixed order) into shared memory first.
__global__ void __launch_bounds__(DS_THREADS)
ds_merge_kernel(const float* part, void* o, int K, int G, int hd, int nsplit,
                int o_dtype) {
    __shared__ float w_s[DS_MERGE_MAX];
    __shared__ float den_s;
    const int g = blockIdx.x, kh = blockIdx.y, bi = blockIdx.z, hs = hd + 2;
    const float* base = part + (((size_t)bi * K + kh) * nsplit * G + g) * hs;
    const size_t stride = (size_t)G * hs;        // from one split to the next
    if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        float m[2], l[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int sp = lane + 32 * i;
            m[i] = sp < nsplit ? base[sp * stride + hd] : DS_NEG_INF;
            l[i] = sp < nsplit ? base[sp * stride + hd + 1] : 0.f;
        }
        float M = fmaxf(m[0], m[1]);
        for (int off = 16; off > 0; off >>= 1)
            M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
        float den = 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int sp = lane + 32 * i;
            if (sp < nsplit) {
                const float w = expf(m[i] - M);
                w_s[sp] = w;
                den = fmaf(l[i], w, den);
            }
        }
        for (int off = 16; off > 0; off >>= 1)
            den += __shfl_xor_sync(0xffffffffu, den, off);
        if (lane == 0) den_s = fmaxf(den, 1e-30f);
    }
    __syncthreads();
    for (int h = threadIdx.x; h < hd; h += DS_THREADS) {
        float num = 0.f;
#pragma unroll 8
        for (int sp = 0; sp < nsplit; ++sp)
            num = fmaf(base[sp * stride + h], w_s[sp], num);
        ds_store(o, (((size_t)bi * K + kh) * G + g) * hd + h, o_dtype,
                 num / den_s);
    }
}

template <int GG, bool F32>
static int ds_launch_t(const StreamArgs& a, cudaStream_t stream) {
    dim3 grid(a.nsplit, a.K * a.n_gg, a.b);
    ring_stream_kernel<GG, F32><<<grid, DS_THREADS,
                                  ds_smem_bytes(a.hd, a.lpr, GG), stream>>>(a);
    return (int)cudaGetLastError();
}

// Fills in the lane layout (lpr, vec) and the query-row groups (n_gg),
// launches the body and, for a split ring, the merge. Returns a
// cudaError_t, or -1 for a shape the body does not take.
static int ds_launch(StreamArgs a, bool f32_ring, cudaStream_t stream) {
    if (a.b < 1 || a.L < 1 || a.K < 1 || a.G < 1 || a.hd < 1 || a.hd > 256
            || a.nsplit < 1 || a.nsplit > DS_MERGE_MAX || a.span < 1
            || (a.nsplit > 1 && !a.part))
        return -1;
    int lpr = 1;
    while (lpr * DS_EPL < a.hd) lpr *= 2;
    a.lpr = lpr;
    const int GG = a.G == 1 ? 1 : a.G == 2 ? 2 : DS_GG_MAX;
    a.n_gg = (a.G + GG - 1) / GG;
    if ((long long)a.K * a.n_gg > 65535 || a.b > 65535 || a.G > 65535)
        return -1;
    a.vec = (a.hd % (f32_ring ? 4 : 8) == 0)
         && ((uintptr_t)a.k % 16 == 0) && ((uintptr_t)a.v % 16 == 0);
    int e;
    if (f32_ring) {
        e = GG == 1 ? ds_launch_t<1, true>(a, stream)
          : GG == 2 ? ds_launch_t<2, true>(a, stream)
                    : ds_launch_t<4, true>(a, stream);
    } else {
        e = GG == 1 ? ds_launch_t<1, false>(a, stream)
          : GG == 2 ? ds_launch_t<2, false>(a, stream)
                    : ds_launch_t<4, false>(a, stream);
    }
    if (e != 0 || a.nsplit <= 1) return e;
    ds_merge_kernel<<<dim3(a.G, a.K, a.b), DS_THREADS, 0, stream>>>(
        a.part, a.o, a.K, a.G, a.hd, a.nsplit, a.q_dtype);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The paged variant: one query token per lane against a block pool shared by
// every lane, [n_blocks, bs, K, hd] (f32, bf16, int8 codes, or int4 codes
// packed two a byte, low nibble first, stored + 8; codes with one f32 scale
// a row [n_blocks, bs, K]), reached through the lane's block table [b, mB]
// (-1 = unassigned). Logical row R of lane bi is physical slot
// table[bi][R / bs] * bs + R % bs; its position is pool_pos at that slot
// (-1 = unwritten). The walk is the ring kernel's, with four differences:
//   - each page of positions stages the rows' physical slots beside their
//     positions (an unassigned entry stages -1 and is never read);
//   - a lane reads 16 bytes of a row a load whatever the codec: 8 bf16 or
//     f32 elements (two loads for f32), 16 int8 codes, 32 int4 codes, so a
//     row of codes is read by fewer lanes; the codes are decoded in
//     registers after the load, K's row scale applied to the f32 product
//     and V's folded into the weight p (l sums p itself);
//   - one lane of a group works out each position's exponentials, shared
//     by shuffles (issuing the next positions' loads before consuming the
//     last, tried on the H100, took registers that cost a block an SM and
//     was slower);
//   - with the per-block mass asked for (bm, bl [b, mB, K, G]), a lane group
//     walks whole pool blocks instead of positions strided over groups and
//     keeps the block's own (max, sumexp) beside its running softmax,
//     written when the block ends. Splits and pages hold whole pool blocks.
// ---------------------------------------------------------------------------

#define DS_CODEC_F32 0               // the wrapper's codes of the pool's dtype
#define DS_CODEC_BF16 1
#define DS_CODEC_INT8 2
#define DS_CODEC_INT4 3
#define DS_TILE 64                   // positions a split is counted in
#define DS_MAX_SPLITS 32             // as the ring kernel's

struct PagedStreamArgs {
    const void* q;               // [b, K, G, hd]
    void* o;                     // [b, K, G, hd], q's dtype
    const void* kpool;           // [n_blocks, bs, K, hd stored]
    const void* vpool;
    const float* kscale;         // [n_blocks, bs, K] (codes) or null
    const float* vscale;
    const int* pool_pos;         // [n_blocks, bs], -1 = unwritten
    const int* tables;           // [b, mB], -1 = unassigned
    const int* positions;        // [b], < 0 = inert
    float* bm;                   // [b, mB, K, G] or null: per-block max
    float* bl;                   //   and sum of e^(s - max)
    float* part;                 // [b, K, nsplit, G, hd + 2] when nsplit > 1
    int b, K, G, hd, bs, mB, q_dtype;
    int window, chunk;           // 0 = none
    float scale;                 // 1 / sqrt(hd)
    int nsplit, span;            // splits; logical rows each (whole blocks)
    int n_gg, lpr, vec;          // as StreamArgs
};

// Elements of a row one lane owns (one 16-byte load; two for f32).
template <int CODEC>
__host__ __device__ constexpr int dsp_epl() {
    return CODEC == DS_CODEC_INT8 ? 16 : CODEC == DS_CODEC_INT4 ? 32 : 8;
}

// Query rows a block carries: four, two for codes (16 or 32 elements a
// lane: at four its query rows and sums take registers that keep blocks,
// and so loads in flight, off the SM; reading the rows once more for the
// second pair of query rows, mostly from L2, costs less).
template <int CODEC>
__host__ __device__ constexpr int dsp_gg_max() {
    return CODEC >= DS_CODEC_INT8 ? 2 : DS_GG_MAX;
}

// Positions a lane group has in flight: four, two where a lane's query rows
// and sums take 128 registers or more.
template <int GG, int CODEC>
__host__ __device__ constexpr int dsp_steps() {
    return GG * dsp_epl<CODEC>() >= 64 || (CODEC == DS_CODEC_F32 && GG == 4)
        ? 2 : 4;
}

// A lane's 16 bytes of codes at elements e0.. of row `row` (zeros past hd,
// or when `on` is false: then nothing is read).
template <int CODEC>
__device__ __forceinline__ void dsp_fetch(const void* base, size_t row,
                                          int hd, int e0, bool vec, bool on,
                                          uint4* r) {
    if constexpr (CODEC == DS_CODEC_F32 || CODEC == DS_CODEC_BF16) {
        ds_fetch<CODEC == DS_CODEC_F32>(base, row, hd, e0, vec, on, r);
    } else {
        r[0] = make_uint4(0u, 0u, 0u, 0u);
        if (!on || e0 >= hd) return;
        constexpr int EPB = CODEC == DS_CODEC_INT8 ? 1 : 2;  // codes a byte
        const size_t rb = (size_t)hd / EPB;
        const uint8_t* p = (const uint8_t*)base + row * rb + e0 / EPB;
        if (vec) {
            r[0] = __ldg((const uint4*)p);
        } else {
            uint32_t x[4] = {0u, 0u, 0u, 0u};
#pragma unroll
            for (int i = 0; i < 16; ++i)
                if (e0 + EPB * i < hd)
                    x[i >> 2] |= (uint32_t)__ldg(p + i) << (8 * (i & 3));
            r[0] = make_uint4(x[0], x[1], x[2], x[3]);
        }
    }
}

// The lane's EPL elements as floats: values for f32 / bf16, codes (int8
// -127..127, int4 -8..7) for the quantised codecs. A code c becomes the
// low mantissa bits of 2^23 (biased to c + 128, or the stored nibble c +
// 8) less 2^23 and the bias: exact, a byte permute or a mask and one add,
// where an integer-to-float conversion issues at a fraction of their rate.
template <int CODEC>
__device__ __forceinline__ void dsp_unpack(const uint4* r, float* f) {
    if constexpr (CODEC == DS_CODEC_F32 || CODEC == DS_CODEC_BF16) {
        ds_unpack<CODEC == DS_CODEC_F32>(r, f);
    } else {
        const uint32_t w[4] = {r[0].x, r[0].y, r[0].z, r[0].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            if constexpr (CODEC == DS_CODEC_INT8) {
                const uint32_t x = w[i] ^ 0x80808080u;   // c + 128 a byte
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    f[4 * i + k] = __uint_as_float(__byte_perm(
                        x, 0x4B000000u, 0x7440u | k)) - 8388736.f;
            } else {
#pragma unroll
                for (int k = 0; k < 8; ++k)
                    f[8 * i + k] = __uint_as_float(
                        0x4B000000u | ((w[i] >> (4 * k)) & 0xFu)) - 8388616.f;
            }
        }
    }
}

// Grid (split, kv head x query-row group, lane); DS_THREADS threads. MASS:
// the per-block (max, sumexp) is asked for.
template <int GG, int CODEC, bool MASS>
__global__ void __launch_bounds__(DS_THREADS)
paged_stream_kernel(PagedStreamArgs a) {
    constexpr int EPL = dsp_epl<CODEC>();
    constexpr int CPL = CODEC == DS_CODEC_F32 ? 2 : 1;
    constexpr int U = dsp_steps<GG, CODEC>();
    constexpr bool QUANT = CODEC >= DS_CODEC_INT8;
    extern __shared__ float4 smem4[];
    float* st_s = (float*)smem4;
    __shared__ int row_s[DS_PAGE];       // physical slot, -1 = unassigned
    __shared__ int cp_s[DS_PAGE];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int lpr = a.lpr, rpw = 32 / lpr;
    const int rg = lane / lpr, lr = lane - rg * lpr;
    const int grp = warp * rpw + rg, ngrp = DS_WARPS * rpw;
    const int e0 = lr * EPL;
    const int split = blockIdx.x;
    const int kh = blockIdx.y / a.n_gg;
    const int g0 = (blockIdx.y - kh * a.n_gg) * GG;
    const int bi = blockIdx.z;
    const int hd = a.hd, K = a.K, G = a.G, bs = a.bs;
    const int qpos = a.positions[bi];
    const bool vec = a.vec != 0;

    // ---- the query rows, pre-scaled by 1/sqrt(hd), in registers
    float qr[GG][EPL];
#pragma unroll
    for (int g = 0; g < GG; ++g)
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
            const int h = e0 + e, gq = g0 + g;
            qr[g][e] = (gq < G && h < hd)
                ? ds_load(a.q, (((size_t)bi * K + kh) * G + gq) * hd + h,
                          a.q_dtype) * a.scale
                : 0.f;
        }
    float m[GG], l[GG], acc[GG][EPL];
    float bmx[MASS ? GG : 1], bsm[MASS ? GG : 1];   // the pool block's
#pragma unroll
    for (int g = 0; g < GG; ++g) {
        m[g] = DS_NEG_INF;
        l[g] = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
    }

    // U positions of the page, i_u = i0 + u * stride (those < lim), into
    // the group's softmax; every lane of the warp takes part (shuffles)
    auto step = [&](int i0, int stride, int lim) {
        uint4 kr[U][CPL], vr[U][CPL];
        float ks[U], vs[U];
        bool vis[U];
        bool any = false;
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int i = i0 + u * stride;
            vis[u] = i < lim
                    && ds_visible(cp_s[i], qpos, a.window, a.chunk);
            const size_t row = vis[u] ? (size_t)row_s[i] * K + kh : 0;
            dsp_fetch<CODEC>(a.kpool, row, hd, e0, vec, vis[u], kr[u]);
            dsp_fetch<CODEC>(a.vpool, row, hd, e0, vec, vis[u], vr[u]);
            ks[u] = QUANT && vis[u] ? __ldg(a.kscale + row) : 1.f;
            vs[u] = QUANT && vis[u] ? __ldg(a.vscale + row) : 1.f;
            any |= vis[u];
        }
        if (!__any_sync(0xffffffffu, any)) return;
        // ---- scores: this lane's products, the group's sum, K's scale
        float s[U][GG];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            float kf[EPL];
            dsp_unpack<CODEC>(kr[u], kf);
#pragma unroll
            for (int g = 0; g < GG; ++g) {
                float d = 0.f;
#pragma unroll
                for (int e = 0; e < EPL; ++e) d = fmaf(qr[g][e], kf[e], d);
                s[u][g] = d;
            }
        }
        for (int o = lpr >> 1; o > 0; o >>= 1)
#pragma unroll
            for (int u = 0; u < U; ++u)
#pragma unroll
                for (int g = 0; g < GG; ++g)
                    s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], o);
        if constexpr (QUANT) {
#pragma unroll
            for (int u = 0; u < U; ++u)
#pragma unroll
                for (int g = 0; g < GG; ++g) s[u][g] *= ks[u];
        }
        // ---- e^(s - ref[g]) of the U positions (0 where not visible),
        // one position a lane: lane lr of the group works out position
        // lr % U for its GG rows and the group shares them, U x GG
        // shuffles for U x GG exponentials; groups of fewer than U lanes
        // work out all of them
        auto weights = [&](const float* ref, float (&w)[U][GG]) {
            if (lpr >= U) {
                const int um = lr & (U - 1);
                float e[GG];
#pragma unroll
                for (int g = 0; g < GG; ++g) {
                    float sv = s[0][g];
                    bool vv = vis[0];
#pragma unroll
                    for (int u = 1; u < U; ++u)
                        if (um == u) {
                            sv = s[u][g];
                            vv = vis[u];
                        }
                    e[g] = vv ? expf(sv - ref[g]) : 0.f;
                }
#pragma unroll
                for (int u = 0; u < U; ++u)
#pragma unroll
                    for (int g = 0; g < GG; ++g)
                        w[u][g] = __shfl_sync(0xffffffffu, e[g], u, lpr);
            } else {
#pragma unroll
                for (int u = 0; u < U; ++u)
#pragma unroll
                    for (int g = 0; g < GG; ++g)
                        w[u][g] = vis[u] ? expf(s[u][g] - ref[g]) : 0.f;
            }
        };
        // the rows' new maxima against `base`
        auto maxima = [&](const float* base, float* mx) {
#pragma unroll
            for (int g = 0; g < GG; ++g) {
                mx[g] = base[g];
#pragma unroll
                for (int u = 0; u < U; ++u)
                    if (vis[u]) mx[g] = fmaxf(mx[g], s[u][g]);
            }
        };
        float mx[GG], p[U][GG];
        // ---- the block's own (max, sumexp)
        if constexpr (MASS) {
            maxima(bmx, mx);
            weights(mx, p);
#pragma unroll
            for (int g = 0; g < GG; ++g) {
                float ps = 0.f;
#pragma unroll
                for (int u = 0; u < U; ++u) ps += p[u][g];
                bsm[g] = bsm[g] * expf(bmx[g] - mx[g]) + ps;
                bmx[g] = mx[g];
            }
        }
        maxima(m, mx);
        weights(mx, p);
        // ---- the running softmax (s becomes the weight times V's scale)
#pragma unroll
        for (int g = 0; g < GG; ++g) {
            const float corr = expf(m[g] - mx[g]);   // both -1e30 -> 1
            float ps = 0.f;
#pragma unroll
            for (int u = 0; u < U; ++u) {
                s[u][g] = p[u][g] * vs[u];
                ps += p[u][g];
            }
            l[g] = l[g] * corr + ps;
            m[g] = mx[g];
#pragma unroll
            for (int e = 0; e < EPL; ++e) acc[g][e] *= corr;
        }
        // ---- acc += p . V
#pragma unroll
        for (int u = 0; u < U; ++u) {
            float vf[EPL];
            dsp_unpack<CODEC>(vr[u], vf);
#pragma unroll
            for (int g = 0; g < GG; ++g)
#pragma unroll
                for (int e = 0; e < EPL; ++e)
                    acc[g][e] = fmaf(s[u][g], vf[e], acc[g][e]);
        }
    };

    const int nrows = a.mB * bs;
    const int page = (DS_PAGE / bs) * bs;     // whole pool blocks
    const int* tbl = a.tables + (size_t)bi * a.mB;
    const int t_begin = (int)min((long long)split * a.span, (long long)nrows);
    const int t_end = (int)min((long long)t_begin + a.span, (long long)nrows);
    for (int p0 = t_begin; p0 < t_end; p0 += page) {
        const int pn = min(page, t_end - p0);
        __syncthreads();                       // the last page is consumed
        for (int i = tid; i < pn; i += DS_THREADS) {
            const int R = p0 + i, e = tbl[R / bs];
            const int row = e >= 0 ? e * bs + (R - (R / bs) * bs) : -1;
            row_s[i] = row;
            cp_s[i] = row >= 0 ? a.pool_pos[row] : -1;
        }
        __syncthreads();
        if (qpos < 0) continue;                // inert: nothing is visible
        if constexpr (!MASS) {
            // the warp's groups take positions w0 + rg + u * ngrp; the loop
            // bound is the warp's, so its shuffles see all 32 lanes
            for (int w0 = warp * rpw; w0 < pn; w0 += ngrp * U)
                step(w0 + rg, ngrp, pn);
        } else {
            // group j of the warp's takes pool block kb + rg of the page,
            // U positions at a time, and writes the block's mass at its end
            const int nblk = pn / bs;
            for (int kb = warp * rpw; kb < nblk; kb += ngrp) {
                const int j = kb + rg;
                const bool own = j < nblk;
#pragma unroll
                for (int g = 0; g < GG; ++g) {
                    bmx[g] = DS_NEG_INF;
                    bsm[g] = 0.f;
                }
                for (int off = 0; off < bs; off += U)
                    step(j * bs + off, 1, own ? (j + 1) * bs : 0);
                if (own && lr == 0) {
                    const size_t jb = (size_t)bi * a.mB + (p0 / bs + j);
#pragma unroll
                    for (int g = 0; g < GG; ++g)
                        if (g0 + g < G) {
                            const size_t off = (jb * K + kh) * G + g0 + g;
                            a.bm[off] = bmx[g];
                            a.bl[off] = bsm[g];
                        }
                }
            }
        }
    }
    ds_combine<GG, EPL>(st_s, acc, m, l, grp, ngrp, lr, e0, hd, G, K, g0,
                        bi, kh, split, a.nsplit, a.part, a.o, a.q_dtype);
}

// Logical rows a split is counted in: DS_TILE rounded down to whole pool
// blocks, or one block where a block is larger.
static inline int dsp_tile_rows(int bs) {
    return bs <= DS_TILE ? (DS_TILE / bs) * bs : bs;
}

// Blocks of one instantiation an SM keeps resident at `dyn` bytes of
// dynamic shared memory, asked of the runtime once per (instantiation,
// dyn).
template <int GG, int CODEC, bool MASS>
static int dsp_resident(size_t dyn) {
    static size_t seen[8];
    static int got[8], n = 0;
    for (int i = 0; i < n; ++i)
        if (seen[i] == dyn) return got[i];
    int r = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &r, paged_stream_kernel<GG, CODEC, MASS>, DS_THREADS, dyn)
            != cudaSuccess || r < 1)
        r = 1;
    if (n < 8) {
        seen[n] = dyn;
        got[n++] = r;
    }
    return r;
}

// Launches the instantiation, or with `resident` set only reports its
// blocks an SM.
template <int GG, int CODEC, bool MASS>
static int dsp_launch_m(const PagedStreamArgs& a, int* resident,
                        cudaStream_t stream) {
    // the combine's buffer, dynamic, beside the page's 8 KB of slots and
    // positions: above 48 KB in all only for int8 at hd 16
    const size_t dyn = ds_smem_bytes(a.hd, a.lpr, GG);
    if (dyn + 2 * DS_PAGE * sizeof(int) > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            paged_stream_kernel<GG, CODEC, MASS>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
        if (e != cudaSuccess) return (int)e;
    }
    if (resident) {
        *resident = dsp_resident<GG, CODEC, MASS>(dyn);
        return 0;
    }
    dim3 grid(a.nsplit, a.K * a.n_gg, a.b);
    paged_stream_kernel<GG, CODEC, MASS><<<grid, DS_THREADS, dyn, stream>>>(
        a);
    return (int)cudaGetLastError();
}

template <int GG, int CODEC>
static int dsp_launch_t(const PagedStreamArgs& a, bool mass, int* resident,
                        cudaStream_t stream) {
    return mass ? dsp_launch_m<GG, CODEC, true>(a, resident, stream)
                : dsp_launch_m<GG, CODEC, false>(a, resident, stream);
}

// Fills in the lane layout (lpr, n_gg, vec) and launches (see
// dsp_launch_m).
template <int CODEC>
static int dsp_launch_c(PagedStreamArgs& a, bool mass, int* resident,
                        cudaStream_t stream) {
    constexpr int EPL = dsp_epl<CODEC>();
    int lpr = 1;
    while (lpr * EPL < a.hd) lpr *= 2;
    a.lpr = lpr;
    const int GG = a.G == 1 ? 1 : a.G == 2 ? 2 : dsp_gg_max<CODEC>();
    a.n_gg = (a.G + GG - 1) / GG;
    if ((long long)a.K * a.n_gg > 65535 || a.b > 65535) return -1;
    // vector loads: 16-byte aligned rows of whole 16-byte pieces a lane
    a.vec = (a.hd % (CODEC == DS_CODEC_F32 ? 4 : EPL) == 0)
         && ((uintptr_t)a.kpool % 16 == 0) && ((uintptr_t)a.vpool % 16 == 0);
    if (GG == 1) return dsp_launch_t<1, CODEC>(a, mass, resident, stream);
    if (GG == 2) return dsp_launch_t<2, CODEC>(a, mass, resident, stream);
    if constexpr (dsp_gg_max<CODEC>() == 4)
        return dsp_launch_t<4, CODEC>(a, mass, resident, stream);
    return -1;
}

static bool dsp_takes(const PagedStreamArgs& a, int codec) {
    return a.b >= 1 && a.K >= 1 && a.G >= 1 && a.hd >= 1 && a.hd <= 256
        && a.bs >= 1 && a.bs <= DS_PAGE && a.mB >= 1
        && codec >= DS_CODEC_F32 && codec <= DS_CODEC_INT4
        && !(codec == DS_CODEC_INT4 && a.hd % 2);
}

static int dsp_dispatch(PagedStreamArgs& a, int codec, bool mass,
                        int* resident, cudaStream_t stream) {
    switch (codec) {
    case DS_CODEC_F32:
        return dsp_launch_c<DS_CODEC_F32>(a, mass, resident, stream);
    case DS_CODEC_BF16:
        return dsp_launch_c<DS_CODEC_BF16>(a, mass, resident, stream);
    case DS_CODEC_INT8:
        return dsp_launch_c<DS_CODEC_INT8>(a, mass, resident, stream);
    default:
        return dsp_launch_c<DS_CODEC_INT4>(a, mass, resident, stream);
    }
}

// How many thread blocks share one (lane, kv head)'s context: as many as
// keep every block of the grid resident at once (the card's SMs times the
// blocks the instantiation keeps on one: its registers decide), at least
// two tiles a split, at most DS_MAX_SPLITS, none left empty. A grid of
// more than one wave of these short-lived blocks ends on a partial wave,
// and the ring kernel's fixed target of 1056 blocks (eight an SM)
// overshoots where an SM holds two or three of them.
static int dsp_splits(PagedStreamArgs a, int codec, bool mass) {
    if (!dsp_takes(a, codec)) return 1;
    int res = 0;
    if (dsp_dispatch(a, codec, mass, &res, nullptr) != 0 || res < 1) res = 1;
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
                != cudaSuccess || sms < 1)
            sms = 1;
    }
    const int TR = dsp_tile_rows(a.bs);
    const long long tiles = ((long long)a.mB * a.bs + TR - 1) / TR;
    long long want = (long long)sms * res
                   / ((long long)a.b * a.K * a.n_gg);
    if (want > DS_MAX_SPLITS) want = DS_MAX_SPLITS;
    if (want > (tiles + 1) / 2) want = (tiles + 1) / 2;
    if (want < 1) want = 1;
    const long long per = (tiles + want - 1) / want;
    return (int)((tiles + per - 1) / per);
}

// Fills in the lane layout and the split span, launches the body and, for a
// split context, the merge. Returns a cudaError_t, or -1 for a shape the
// body does not take.
static int dsp_launch(PagedStreamArgs a, int codec, cudaStream_t stream) {
    if (!dsp_takes(a, codec) || a.nsplit < 1 || a.nsplit > DS_MERGE_MAX
            || (a.nsplit > 1 && !a.part))
        return -1;
    const int TR = dsp_tile_rows(a.bs);
    const long long tiles = ((long long)a.mB * a.bs + TR - 1) / TR;
    a.span = (int)((tiles + a.nsplit - 1) / a.nsplit * TR);
    const int e = dsp_dispatch(a, codec, a.bm != nullptr, nullptr, stream);
    if (e != 0 || a.nsplit <= 1) return e;
    ds_merge_kernel<<<dim3(a.G, a.K, a.b), DS_THREADS, 0, stream>>>(
        a.part, a.o, a.K, a.G, a.hd, a.nsplit, a.q_dtype);
    return (int)cudaGetLastError();
}
