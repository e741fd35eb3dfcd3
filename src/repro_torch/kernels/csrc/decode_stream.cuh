// Decode attention streamed from device memory into registers: the body of
// the ring decode kernel (one query token per lane against that lane's ring
// of K/V rows [b, L, K, hd], slot = position % L, cache_pos [b, L]).
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
// launch needs a dynamic shared-memory attribute.
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

    // ---- combine the block's lane groups, in group order
    const int hs = hd + 2;
#pragma unroll
    for (int g = 0; g < GG; ++g) {
        float* r = st_s + ((size_t)grp * GG + g) * hs;
#pragma unroll
        for (int e = 0; e < DS_EPL; ++e)
            if (e0 + e < hd) r[e0 + e] = acc[g][e];
        if (lr == 0) {
            r[hd] = m[g];
            r[hd + 1] = l[g];
        }
    }
    __syncthreads();
    for (int idx = tid; idx < GG * hd; idx += DS_THREADS) {
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
        if (a.nsplit > 1) {
            float* pr = a.part
                + ((((size_t)bi * K + kh) * a.nsplit + split) * G + gq) * hs;
            pr[h] = num;
            if (h == 0) {
                pr[hd] = M;
                pr[hd + 1] = den;
            }
        } else {
            // a lane that saw nothing: num = 0, den = 0 -> exact zeros
            ds_store(a.o, (((size_t)bi * K + kh) * G + gq) * hd + h,
                     a.q_dtype, num / fmaxf(den, 1e-30f));
        }
    }
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
