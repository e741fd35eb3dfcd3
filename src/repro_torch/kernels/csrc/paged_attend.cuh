// Tiled online-softmax attention through a paged KV pool on the CUDA cores:
// the attend half of the paged prefill kernel for f32 queries, f32 pools and
// head widths its tensor-core body does not take (a chunk of query tokens
// per lane). Its tile loader and helpers also serve the flash forward's f32
// body.
//
// One thread block (128 threads) owns QR query rows of one (lane, kv head):
// row m of the head's C*G rows is (chunk token m / G, group member m % G).
// It walks the lane's block-table row in tiles of TR pool positions (a whole
// number of pool blocks, or exactly one), and per tile:
//   1. loads K rows through the table into shared memory, 16 bytes a thread
//      and several loads in flight, dequantising int8 / packed-int4 codes
//      with their per-row scale after the load;
//   2. scores the QR x TR tile (4 x 8 outputs a thread where the tile is
//      large), masked by position (causal, >= 0, window, chunk) to -1e30,
//      and skips the tile if nothing in it is visible;
//   3. reloads the same shared buffer with the V rows while one warp per
//      query row updates the running (max, sum) in f32;
//   4. rescales and accumulates p.V into registers (NACC floats a thread,
//      each thread owning HPT columns of the head for a set of rows).
// Tiles are skipped only on what their own positions show, never on their
// index. Nothing of size [rows, context] and no fp copy of a quantised pool
// ever reaches device memory. Everything is f32 on CUDA cores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PA_THREADS 128
#define PA_NEG_INF (-1e30f)
#define PA_LOADS 4           // 16-byte loads a thread keeps in flight

// element types of q / k_new / v_new / o
#define PA_F32 0
#define PA_BF16 1
// pool codecs
#define PA_POOL_F32 0
#define PA_POOL_BF16 1
#define PA_POOL_INT8 2
#define PA_POOL_INT4 3

struct AttendArgs {
    const void* q;           // [b, C, K, G, hd]
    void* o;                 // [b, C, K, G, hd]
    const void* kpool;       // [n_blocks, bs, K, hd_stored]
    const void* vpool;
    const float* kscale;     // [n_blocks, bs, K] or null
    const float* vscale;
    const int* pool_pos;     // [n_blocks, bs]
    const int* tables;       // [b, mB]
    const int* positions;    // [b, C]
    int b, C, K, G, hd, bs, mB;
    int q_dtype, codec;
    int window, chunk;       // 0 = none
    int QR, TR;              // query rows per block, pool positions per tile
    float scale;             // 1 / sqrt(hd)
};

__device__ __forceinline__ float pa_load(const void* p, size_t i, int dt) {
    if (dt == PA_BF16) return __bfloat162float(((const __nv_bfloat16*)p)[i]);
    return ((const float*)p)[i];
}

__device__ __forceinline__ void pa_store(void* p, size_t i, int dt, float v) {
    if (dt == PA_BF16) ((__nv_bfloat16*)p)[i] = __float2bfloat16(v);
    else ((float*)p)[i] = v;
}

// One stored element of a pool row: `row` is the flat (block, slot, head)
// index, h the element within the head. Codes are dequantised in f32.
__device__ __forceinline__ float pa_pool_load(const void* pool,
                                              const float* scales,
                                              size_t row, int h, int hd,
                                              int codec) {
    if (codec == PA_POOL_BF16)
        return __bfloat162float(((const __nv_bfloat16*)pool)[row * hd + h]);
    if (codec == PA_POOL_F32) return ((const float*)pool)[row * hd + h];
    if (codec == PA_POOL_INT8)
        return (float)((const int8_t*)pool)[row * hd + h] * scales[row];
    // packed int4: low nibble = even element, offset +8
    uint8_t byte = ((const uint8_t*)pool)[row * (size_t)(hd / 2) + (h >> 1)];
    int nib = (h & 1) ? (byte >> 4) : (byte & 0xF);
    return (float)(nib - 8) * scales[row];
}

__host__ __device__ inline int pa_row_bytes(int hd, int codec) {
    if (codec == PA_POOL_F32) return hd * 4;
    if (codec == PA_POOL_BF16) return hd * 2;
    if (codec == PA_POOL_INT8) return hd;
    return hd / 2;
}

// Decode one 16-byte piece of a pool row into floats at dst.
__device__ __forceinline__ void pa_decode16(uint4 v, float sc, int codec,
                                            float* dst) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    if (codec == PA_POOL_F32) {
#pragma unroll
        for (int i = 0; i < 4; ++i) dst[i] = __uint_as_float(w[i]);
    } else if (codec == PA_POOL_BF16) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            dst[2 * i] = __uint_as_float(w[i] << 16);
            dst[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        }
    } else if (codec == PA_POOL_INT8) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int k = 0; k < 4; ++k)
                dst[4 * i + k] =
                    (float)(int8_t)((w[i] >> (8 * k)) & 0xffu) * sc;
    } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                uint32_t byte = (w[i] >> (8 * k)) & 0xffu;
                dst[8 * i + 2 * k] = (float)((int)(byte & 0xFu) - 8) * sc;
                dst[8 * i + 2 * k + 1] = (float)((int)(byte >> 4) - 8) * sc;
            }
    }
}

// Rows of one tile from the pool (K or V) into kv_s[TR][hp], f32. Only rows
// that hold a position (cp_s >= 0) are read; the others become zeros.
__device__ __forceinline__ void pa_load_tile(
    const void* pool, const float* scales, const int* row_s, const int* cp_s,
    float* kv_s, int TR, int hd, int hp, int K, int kh, int codec, int tid) {
    const int rb = pa_row_bytes(hd, codec);
    if ((rb & 15) == 0) {
        const int vpr = rb >> 4;              // 16-byte pieces per row
        const int epv = hd / vpr;             // elements per piece
        const int total = TR * vpr;
        const bool quant = codec >= PA_POOL_INT8;
        for (int base = tid; base < total; base += PA_THREADS * PA_LOADS) {
            uint4 v[PA_LOADS];
            float sc[PA_LOADS];
            int dst[PA_LOADS];
#pragma unroll
            for (int u = 0; u < PA_LOADS; ++u) {
                int idx = base + u * PA_THREADS;
                v[u] = make_uint4(0u, 0u, 0u, 0u);
                sc[u] = 0.f;
                dst[u] = -1;
                if (idx < total) {
                    int r = idx / vpr, vi = idx - r * vpr;
                    dst[u] = r * hp + vi * epv;
                    if (cp_s[r] >= 0) {
                        size_t row = (size_t)row_s[r] * K + kh;
                        v[u] = ((const uint4*)pool)[row * vpr + vi];
                        sc[u] = quant ? scales[row] : 1.f;
                    } else {
                        dst[u] = -2 - dst[u];      // zeros, not a decode
                    }
                }
            }
#pragma unroll
            for (int u = 0; u < PA_LOADS; ++u) {
                if (dst[u] >= 0) {
                    pa_decode16(v[u], sc[u], codec, kv_s + dst[u]);
                } else if (dst[u] < -1) {
                    float* d = kv_s + (-2 - dst[u]);
                    for (int i = 0; i < epv; ++i) d[i] = 0.f;
                }
            }
        }
    } else {
        for (int idx = tid; idx < TR * hd; idx += PA_THREADS) {
            int r = idx / hd, h = idx - r * hd;
            float v = 0.f;
            if (cp_s[r] >= 0)
                v = pa_pool_load(pool, scales, (size_t)row_s[r] * K + kh, h,
                                 hd, codec);
            kv_s[r * hp + h] = v;
        }
    }
}

__device__ __forceinline__ bool pa_visible(int cpos, int qpos, int window,
                                           int chunk) {
    bool m = (cpos >= 0) && (qpos >= 0) && (cpos <= qpos);
    if (window > 0) m = m && (cpos > qpos - window);
    if (chunk > 0) m = m && ((cpos / chunk) == (qpos / chunk));
    return m;
}

__device__ __forceinline__ float pa_warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float pa_warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__host__ __device__ inline int pa_up4(int n) { return (n + 3) & ~3; }

// Shared memory, in floats: s_s[QR][SS] (first: 16-byte aligned rows),
// kv_s[TRP][hd+4], q_s[QR][hd+1], m_s[QR], l_s[QR], corr_s[QR], then ints
// qp_s[QR], cp_s[TR], row_s[TR]. SS and TRP are TR rounded up to 4.
__host__ __device__ inline size_t pa_smem_bytes(int QR, int TR, int hd) {
    size_t trp = pa_up4(TR);
    size_t f = (size_t)QR * trp + trp * (hd + 4) + (size_t)QR * (hd + 1)
             + 3 * (size_t)QR;
    size_t i = (size_t)QR + 2 * (size_t)TR;
    return (f + i) * 4;
}

// The accumulators of a thread: HPT columns h = h0 + 128 c of the head for
// rows ml = rg + RG i. For hd >= 128 every thread owns column tid (and
// tid + 128) of every row; for hd < 128 the threads split into RG = 128 / hd
// row groups.
struct PaOwner {
    int RG, RPT, rg, h0;
    bool active;
};

__device__ __forceinline__ PaOwner pa_owner(int hd, int QR, int tid) {
    PaOwner w;
    if (hd >= PA_THREADS) {
        w.RG = 1; w.rg = 0; w.h0 = tid; w.active = true;
    } else {
        w.RG = PA_THREADS / hd;
        w.rg = tid / hd;
        w.h0 = tid - w.rg * hd;
        w.active = w.rg < w.RG;
    }
    w.RPT = (QR + w.RG - 1) / w.RG;
    return w;
}

template <int NACC, int HPT>
__global__ void __launch_bounds__(PA_THREADS)
paged_attend_kernel(AttendArgs a) {
    extern __shared__ float4 smem4[];
    float* smem = (float*)smem4;
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int hd = a.hd, bs = a.bs, G = a.G, K = a.K, C = a.C;
    const int QR = a.QR, TR = a.TR;
    const int TRP = pa_up4(TR), SS = TRP;
    const int M = C * G;
    const int m0 = blockIdx.x * QR;
    const int kh = blockIdx.y;
    const int bi = blockIdx.z;
    const int hp = hd + 4, qp = hd + 1;
    constexpr int RMAX = NACC / HPT;

    float* s_s = smem;
    float* kv_s = s_s + (size_t)QR * SS;
    float* q_s = kv_s + (size_t)TRP * hp;
    float* m_s = q_s + (size_t)QR * qp;
    float* l_s = m_s + QR;
    float* corr_s = l_s + QR;
    int* qp_s = (int*)(corr_s + QR);
    int* cp_s = qp_s + QR;
    int* row_s = cp_s + TR;      // flat pool row (block*bs + slot), -1 = none

    // ---- query tile, pre-scaled by 1/sqrt(hd); rows past M are inert
    for (int idx = tid; idx < QR * hd; idx += PA_THREADS) {
        int ml = idx / hd, h = idx - ml * hd;
        int m = m0 + ml;
        float v = 0.f;
        if (m < M) {
            int c = m / G, g = m - c * G;
            size_t off = ((((size_t)bi * C + c) * K + kh) * G + g) * hd + h;
            v = pa_load(a.q, off, a.q_dtype) * a.scale;
        }
        q_s[ml * qp + h] = v;
    }
    for (int ml = tid; ml < QR; ml += PA_THREADS) {
        int m = m0 + ml;
        qp_s[ml] = (m < M) ? a.positions[(size_t)bi * C + m / G] : -1;
        m_s[ml] = PA_NEG_INF;
        l_s[ml] = 0.f;
        corr_s[ml] = 1.f;
    }
    // padding the 4-wide p.V loop reads: rows TR..TRP of kv_s, columns
    // TR..SS of s_s; nothing else ever writes them
    for (int idx = tid; idx < (TRP - TR) * hp; idx += PA_THREADS)
        kv_s[(size_t)TR * hp + idx] = 0.f;
    for (int idx = tid; idx < QR * (SS - TR); idx += PA_THREADS) {
        int ml = idx / (SS - TR);
        s_s[ml * SS + TR + (idx - ml * (SS - TR))] = 0.f;
    }
    const PaOwner own = pa_owner(hd, QR, tid);
    float acc[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
    __syncthreads();

    const int total_rows = a.mB * bs;
    const int* tbl = a.tables + (size_t)bi * a.mB;

    for (int t0 = 0; t0 < total_rows; t0 += TR) {
        // ---- which pool rows this tile holds, and their positions
        for (int r = tid; r < TR; r += PA_THREADS) {
            int R = t0 + r;
            int row = -1, cp = -1;
            if (R < total_rows) {
                int ent = tbl[R / bs];
                if (ent >= 0) {
                    row = ent * bs + (R % bs);
                    cp = a.pool_pos[row];
                }
            }
            row_s[r] = row;
            cp_s[r] = cp;
        }
        __syncthreads();
        // ---- K rows
        pa_load_tile(a.kpool, a.kscale, row_s, cp_s, kv_s, TR, hd, hp, K, kh,
                     a.codec, tid);
        __syncthreads();
        // ---- scores, masked by position
        int any = 0;
        if (QR >= 16) {
            // 4 query rows x 8 pool rows a thread: rows ml = 4 ty + i and
            // r = tx + TXN j, which keeps both shared-memory reads free of
            // bank conflicts
            const int TXN = (TR + 7) / 8, TYN = (QR + 3) / 4;
            for (int t = tid; t < TXN * TYN; t += PA_THREADS) {
                const int ty = t / TXN, tx = t - ty * TXN;
                unsigned vis = 0u;
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        int ml = 4 * ty + i, r = tx + TXN * j;
                        if (ml < QR && r < TR &&
                            pa_visible(cp_s[r], qp_s[ml], a.window, a.chunk))
                            vis |= 1u << (8 * i + j);
                    }
                float d[4][8];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 8; ++j) d[i][j] = 0.f;
                if (vis) {
                    any = 1;
                    const float* qrow[4];
                    const float* krow[8];
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        qrow[i] = q_s + min(4 * ty + i, QR - 1) * qp;
#pragma unroll
                    for (int j = 0; j < 8; ++j)
                        krow[j] = kv_s + min(tx + TXN * j, TR - 1) * hp;
                    for (int h = 0; h < hd; ++h) {
                        float qv[4], kv[8];
#pragma unroll
                        for (int i = 0; i < 4; ++i) qv[i] = qrow[i][h];
#pragma unroll
                        for (int j = 0; j < 8; ++j) kv[j] = krow[j][h];
#pragma unroll
                        for (int i = 0; i < 4; ++i)
#pragma unroll
                            for (int j = 0; j < 8; ++j)
                                d[i][j] = fmaf(qv[i], kv[j], d[i][j]);
                    }
                }
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        int ml = 4 * ty + i, r = tx + TXN * j;
                        if (ml < QR && r < TR)
                            s_s[ml * SS + r] = ((vis >> (8 * i + j)) & 1u)
                                                   ? d[i][j] : PA_NEG_INF;
                    }
            }
        } else {
            // few query rows (a short chunk): one output a thread at a
            // time; the walk over h starts at a per-row offset so that
            // neighbouring rows hit different banks
            for (int idx = tid; idx < QR * TR; idx += PA_THREADS) {
                int ml = idx / TR, r = idx - ml * TR;
                float s = PA_NEG_INF;
                if (pa_visible(cp_s[r], qp_s[ml], a.window, a.chunk)) {
                    const float* qrow = q_s + ml * qp;
                    const float* krow = kv_s + r * hp;
                    int h = r % hd;
                    float d = 0.f;
                    for (int n = 0; n < hd; ++n) {
                        d = fmaf(qrow[h], krow[h], d);
                        h = (h + 1 == hd) ? 0 : h + 1;
                    }
                    s = d;
                    any = 1;
                }
                s_s[ml * SS + r] = s;
            }
        }
        any = __syncthreads_or(any);
        if (!any) continue;                      // nothing visible: a no-op
        // ---- V rows into the buffer K just left
        pa_load_tile(a.vpool, a.vscale, row_s, cp_s, kv_s, TR, hd, hp, K, kh,
                     a.codec, tid);
        // ---- per-row online softmax, one warp per query row
        for (int ml = warp; ml < QR; ml += PA_THREADS / 32) {
            float* srow = s_s + ml * SS;
            float mx = PA_NEG_INF;
            for (int r = lane; r < TR; r += 32) mx = fmaxf(mx, srow[r]);
            mx = pa_warp_max(mx);
            float m_prev = m_s[ml];
            float m_new = fmaxf(m_prev, mx);
            float sum = 0.f;
            for (int r = lane; r < TR; r += 32) {
                float s = srow[r];
                float p = (s > -1e29f) ? expf(s - m_new) : 0.f;
                srow[r] = p;
                sum += p;
            }
            sum = pa_warp_sum(sum);
            if (lane == 0) {
                float corr = expf(m_prev - m_new);   // both -1e30 -> 1
                l_s[ml] = l_s[ml] * corr + sum;
                corr_s[ml] = corr;
                m_s[ml] = m_new;
            }
        }
        __syncthreads();
        // ---- acc = acc * corr + p . V, four pool rows at a time
        if (own.active) {
#pragma unroll
            for (int i = 0; i < RMAX; ++i) {
                int ml = own.rg + own.RG * i;
                if (i < own.RPT && ml < QR) {
                    float cr = corr_s[ml];
#pragma unroll
                    for (int c = 0; c < HPT; ++c) acc[c * RMAX + i] *= cr;
                }
            }
            for (int r4 = 0; r4 < TRP; r4 += 4) {
                float v[HPT][4];
#pragma unroll
                for (int c = 0; c < HPT; ++c) {
                    int h = own.h0 + c * PA_THREADS;
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        v[c][j] = (h < hd) ? kv_s[(r4 + j) * hp + h] : 0.f;
                }
#pragma unroll
                for (int i = 0; i < RMAX; ++i) {
                    int ml = own.rg + own.RG * i;
                    if (i < own.RPT && ml < QR) {
                        float4 p = *(const float4*)(s_s + ml * SS + r4);
#pragma unroll
                        for (int c = 0; c < HPT; ++c) {
                            float t = acc[c * RMAX + i];
                            t = fmaf(p.x, v[c][0], t);
                            t = fmaf(p.y, v[c][1], t);
                            t = fmaf(p.z, v[c][2], t);
                            t = fmaf(p.w, v[c][3], t);
                            acc[c * RMAX + i] = t;
                        }
                    }
                }
            }
        }
        __syncthreads();
    }

    // ---- finalise: a row that saw nothing (inert lane, padding) gives 0
    if (own.active) {
#pragma unroll
        for (int i = 0; i < RMAX; ++i) {
            int ml = own.rg + own.RG * i;
            int m = m0 + ml;
            if (i < own.RPT && ml < QR && m < M) {
                int c_tok = m / G, g = m - c_tok * G;
                size_t base = ((((size_t)bi * C + c_tok) * K + kh) * G + g)
                            * hd;
                float inv = 1.f / fmaxf(l_s[ml], 1e-30f);
#pragma unroll
                for (int c = 0; c < HPT; ++c) {
                    int h = own.h0 + c * PA_THREADS;
                    if (h < hd)
                        pa_store(a.o, base + h, a.q_dtype,
                                 acc[c * RMAX + i] * inv);
                }
            }
        }
    }
}

// Tile shape for (hd, bs) and the launch itself. Returns a cudaError_t.
static inline int pa_tile_rows(int hd, int bs) {
    int target = 8192 / hd;
    if (target > 64) target = 64;
    if (target < 1) target = 1;
    return (bs <= target) ? (target / bs) * bs : bs;
}

template <int NACC, int HPT>
static int pa_launch_n(const AttendArgs& a, dim3 grid, size_t smem,
                       cudaStream_t stream) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attend_kernel<NACC, HPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    paged_attend_kernel<NACC, HPT><<<grid, PA_THREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

// -1: shape not supported (too many accumulators or too much shared memory)
static int pa_launch(AttendArgs a, cudaStream_t stream) {
    int M = a.C * a.G;
    dim3 grid((M + a.QR - 1) / a.QR, a.K, a.b);
    size_t smem = pa_smem_bytes(a.QR, a.TR, a.hd);
    if (smem > 227 * 1024) return -1;
    int hpt = (a.hd + PA_THREADS - 1) / PA_THREADS;
    int rg = (a.hd >= PA_THREADS) ? 1 : PA_THREADS / a.hd;
    int rpt = (a.QR + rg - 1) / rg;
    // a few accumulator counts only: each instantiation costs build time
    if (hpt == 1) {
        if (rpt <= 4) return pa_launch_n<4, 1>(a, grid, smem, stream);
        if (rpt <= 16) return pa_launch_n<16, 1>(a, grid, smem, stream);
        if (rpt <= 64) return pa_launch_n<64, 1>(a, grid, smem, stream);
        return -1;
    }
    if (hpt == 2) {
        if (rpt <= 2) return pa_launch_n<4, 2>(a, grid, smem, stream);
        if (rpt <= 8) return pa_launch_n<16, 2>(a, grid, smem, stream);
        if (rpt <= 32) return pa_launch_n<64, 2>(a, grid, smem, stream);
        return -1;
    }
    return -1;
}
