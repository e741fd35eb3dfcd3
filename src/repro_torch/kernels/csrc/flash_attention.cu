// Flash attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel kernels/flash_attention.py · flash_attention_fwd
// (body _kernel) of the reference package: GQA online-softmax attention of
// q [b, sq, K*G, hd] over k/v [b, sk, K, hd] (query head h reads kv head
// h / G) under the position mask (kpos <= qpos) & (kpos >= 0), with the
// optional sliding window (kpos > qpos - window) and chunk (kpos / chunk ==
// qpos / chunk); f32 arithmetic on bf16 or f32 inputs, scale 1/sqrt(hd),
// masked scores -1e30 with p = 0, out = acc / max(l, 1e-30) in q's dtype and
// optionally lse = m + log(max(l, 1e-30)) in f32.
//
// Bound on this card: operations for prompts above a few hundred positions
// (4 * hd operations per visible (query, key) pair and query head, against
// 2 * hd stored values per key row and kv head), bytes for short prompts.
// Design: one thread block (128 threads) per (tile of QT query positions,
// kv head, batch row) serves all G query heads of that kv head (QR = QT * G
// rows, row m = (position m / G, head m % G)), so every K/V tile is read
// from device memory once per G heads. It walks k/v in tiles of TK
// positions: K rows into shared memory with 16-byte loads, several in
// flight; a 4 x 8 register tile of scores a thread; the online softmax
// (max, sum) one warp per row; V rows into the buffer K just left; p.V into
// registers. Tiles are skipped from the positions themselves: a tile whose
// valid kpos span lies wholly above the block's largest qpos, or outside
// every row's window or chunk, is never loaded, so positions need not equal
// indices (the TPU kernel assumes they do). Any sq, sk: the last tiles are
// bounds-checked. CUDA cores in f32: no tensor cores, no asynchronous copies
// yet.
#include <limits.h>

#include "paged_attend.cuh"

struct FlashArgs {
    const void* q;           // [b, sq, K * G, hd]
    const void* k;           // [b, sk, K, hd]
    const void* v;
    void* o;                 // [b, sq, K * G, hd]
    float* lse;              // [b, sq, K * G] or null
    const int* qpos;         // [b, sq]
    const int* kpos;         // [b, sk]
    int b, sq, sk, K, G, hd;
    int dtype;               // PA_F32 | PA_BF16, of q, k, v and o
    int window, chunk;       // 0 = none
    int QT, QR, TK;          // query positions and rows per block, keys per tile
    float scale;             // 1 / sqrt(hd)
};

template <int NACC, int HPT>
__global__ void __launch_bounds__(PA_THREADS)
flash_fwd_kernel(FlashArgs a) {
    extern __shared__ float4 smem4[];
    float* smem = (float*)smem4;
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int hd = a.hd, G = a.G, K = a.K, H = a.K * a.G;
    const int QR = a.QR, TK = a.TK;
    const int TKP = pa_up4(TK), SS = TKP;
    const int t0 = blockIdx.x * a.QT;
    const int kh = blockIdx.y;
    const int bi = blockIdx.z;
    const int hp = hd + 4, qp = hd + 1;
    const int codec = (a.dtype == PA_BF16) ? PA_POOL_BF16 : PA_POOL_F32;
    constexpr int RMAX = NACC / HPT;

    float* s_s = smem;
    float* kv_s = s_s + (size_t)QR * SS;
    float* q_s = kv_s + (size_t)TKP * hp;
    float* m_s = q_s + (size_t)QR * qp;
    float* l_s = m_s + QR;
    float* corr_s = l_s + QR;
    int* qp_s = (int*)(corr_s + QR);
    int* cp_s = qp_s + QR;
    int* row_s = cp_s + TK;      // flat key row (bi * sk + key index)
    int* bnd_s = row_s + TK;     // min, max of valid qpos; of valid kpos

    // ---- query rows, pre-scaled by 1/sqrt(hd); rows past sq are inert
    for (int idx = tid; idx < QR * hd; idx += PA_THREADS) {
        int ml = idx / hd, h = idx - ml * hd;
        int t = t0 + ml / G, g = ml - (ml / G) * G;
        float val = 0.f;
        if (t < a.sq) {
            size_t off = (((size_t)bi * a.sq + t) * H + kh * G + g) * hd + h;
            val = pa_load(a.q, off, a.dtype) * a.scale;
        }
        q_s[ml * qp + h] = val;
    }
    if (tid == 0) {
        bnd_s[0] = INT_MAX;
        bnd_s[1] = -1;
    }
    for (int ml = tid; ml < QR; ml += PA_THREADS) {
        int t = t0 + ml / G;
        qp_s[ml] = (t < a.sq) ? a.qpos[(size_t)bi * a.sq + t] : -1;
        m_s[ml] = PA_NEG_INF;
        l_s[ml] = 0.f;
        corr_s[ml] = 1.f;
    }
    // padding the 4-wide p.V loop reads: rows TK..TKP of kv_s, columns
    // TK..SS of s_s; nothing else ever writes them
    for (int idx = tid; idx < (TKP - TK) * hp; idx += PA_THREADS)
        kv_s[(size_t)TK * hp + idx] = 0.f;
    for (int idx = tid; idx < QR * (SS - TK); idx += PA_THREADS) {
        int ml = idx / (SS - TK);
        s_s[ml * SS + TK + (idx - ml * (SS - TK))] = 0.f;
    }
    const PaOwner own = pa_owner(hd, QR, tid);
    float acc[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
    __syncthreads();
    for (int ml = tid; ml < QR; ml += PA_THREADS) {
        if (qp_s[ml] >= 0) {
            atomicMin(&bnd_s[0], qp_s[ml]);
            atomicMax(&bnd_s[1], qp_s[ml]);
        }
    }
    __syncthreads();
    const int qmin = bnd_s[0], qmax = bnd_s[1];   // qmax < 0: no live row

    for (int k0 = 0; k0 < a.sk && qmax >= 0; k0 += TK) {
        // ---- this tile's key positions and the span of the valid ones
        if (tid == 0) {
            bnd_s[2] = INT_MAX;
            bnd_s[3] = -1;
        }
        __syncthreads();
        for (int r = tid; r < TK; r += PA_THREADS) {
            int j = k0 + r;
            int cp = (j < a.sk) ? a.kpos[(size_t)bi * a.sk + j] : -1;
            cp_s[r] = cp;
            row_s[r] = bi * a.sk + j;
            if (cp >= 0) {
                atomicMin(&bnd_s[2], cp);
                atomicMax(&bnd_s[3], cp);
            }
        }
        __syncthreads();
        const int kmin = bnd_s[2], kmax = bnd_s[3];
        bool live = kmax >= 0 && kmin <= qmax;
        if (a.window > 0) live = live && kmax > qmin - a.window;
        if (a.chunk > 0)
            live = live && kmax / a.chunk >= qmin / a.chunk
                        && kmin / a.chunk <= qmax / a.chunk;
        __syncthreads();             // bnd_s is rewritten by the next tile
        if (!live) continue;
        // ---- K rows
        pa_load_tile(a.k, nullptr, row_s, cp_s, kv_s, TK, hd, hp, K, kh,
                     codec, tid);
        __syncthreads();
        // ---- scores, 4 query rows x 8 keys a thread: rows ml = 4 ty + i
        // and keys r = tx + TXN j keep both shared-memory reads free of
        // bank conflicts
        int any = 0;
        const int TXN = (TK + 7) / 8, TYN = (QR + 3) / 4;
        for (int t = tid; t < TXN * TYN; t += PA_THREADS) {
            const int ty = t / TXN, tx = t - ty * TXN;
            unsigned vis = 0u;
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    int ml = 4 * ty + i, r = tx + TXN * j;
                    if (ml < QR && r < TK &&
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
                    krow[j] = kv_s + min(tx + TXN * j, TK - 1) * hp;
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
                    if (ml < QR && r < TK)
                        s_s[ml * SS + r] = ((vis >> (8 * i + j)) & 1u)
                                               ? d[i][j] : PA_NEG_INF;
                }
        }
        any = __syncthreads_or(any);
        if (!any) continue;          // nothing visible: a no-op
        // ---- V rows into the buffer K just left
        pa_load_tile(a.v, nullptr, row_s, cp_s, kv_s, TK, hd, hp, K, kh,
                     codec, tid);
        // ---- per-row online softmax, one warp per query row
        for (int ml = warp; ml < QR; ml += PA_THREADS / 32) {
            float* srow = s_s + ml * SS;
            float mx = PA_NEG_INF;
            for (int r = lane; r < TK; r += 32) mx = fmaxf(mx, srow[r]);
            mx = pa_warp_max(mx);
            float m_prev = m_s[ml];
            float m_new = fmaxf(m_prev, mx);
            float sum = 0.f;
            for (int r = lane; r < TK; r += 32) {
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
        // ---- acc = acc * corr + p . V, four keys at a time
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
            for (int r4 = 0; r4 < TKP; r4 += 4) {
                float vv[HPT][4];
#pragma unroll
                for (int c = 0; c < HPT; ++c) {
                    int h = own.h0 + c * PA_THREADS;
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        vv[c][j] = (h < hd) ? kv_s[(r4 + j) * hp + h] : 0.f;
                }
#pragma unroll
                for (int i = 0; i < RMAX; ++i) {
                    int ml = own.rg + own.RG * i;
                    if (i < own.RPT && ml < QR) {
                        float4 p = *(const float4*)(s_s + ml * SS + r4);
#pragma unroll
                        for (int c = 0; c < HPT; ++c) {
                            float t = acc[c * RMAX + i];
                            t = fmaf(p.x, vv[c][0], t);
                            t = fmaf(p.y, vv[c][1], t);
                            t = fmaf(p.z, vv[c][2], t);
                            t = fmaf(p.w, vv[c][3], t);
                            acc[c * RMAX + i] = t;
                        }
                    }
                }
            }
        }
        __syncthreads();
    }

    // ---- finalise: a row that saw nothing gives 0 (and lse -1e30)
    if (own.active) {
#pragma unroll
        for (int i = 0; i < RMAX; ++i) {
            int ml = own.rg + own.RG * i;
            int t = t0 + ml / G;
            if (i < own.RPT && ml < QR && t < a.sq) {
                int g = ml - (ml / G) * G;
                size_t base = (((size_t)bi * a.sq + t) * H + kh * G + g) * hd;
                float inv = 1.f / fmaxf(l_s[ml], 1e-30f);
#pragma unroll
                for (int c = 0; c < HPT; ++c) {
                    int h = own.h0 + c * PA_THREADS;
                    if (h < hd)
                        pa_store(a.o, base + h, a.dtype,
                                 acc[c * RMAX + i] * inv);
                }
            }
        }
    }
    if (a.lse != nullptr) {
        for (int ml = tid; ml < QR; ml += PA_THREADS) {
            int t = t0 + ml / G, g = ml - (ml / G) * G;
            if (t < a.sq)
                a.lse[((size_t)bi * a.sq + t) * H + kh * G + g] =
                    m_s[ml] + logf(fmaxf(l_s[ml], 1e-30f));
        }
    }
}

template <int NACC, int HPT>
static int fa_launch_n(const FlashArgs& a, dim3 grid, size_t smem,
                       cudaStream_t stream) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<NACC, HPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    flash_fwd_kernel<NACC, HPT><<<grid, PA_THREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

// Returns a cudaError_t, or -1 when the shape is not supported (too many
// accumulators or too much shared memory).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, float* lse,
    const int* qpos, const int* kpos, int b, int sq, int sk, int K, int G,
    int hd, int dtype, int window, int chunk, float scale, void* stream) {
    FlashArgs a;
    a.q = q; a.k = k; a.v = v; a.o = o; a.lse = lse;
    a.qpos = qpos; a.kpos = kpos;
    a.b = b; a.sq = sq; a.sk = sk; a.K = K; a.G = G; a.hd = hd;
    a.dtype = dtype; a.window = window; a.chunk = chunk; a.scale = scale;
    // rows a block serves and keys a tile holds: 64 at hd 128 (as the
    // paged kernels), fewer above so that the accumulators fit
    int rows = 8192 / hd;
    if (rows > 64) rows = 64;
    if (hd > PA_THREADS && rows > 32) rows = 32;
    if (rows < 1) rows = 1;
    int qt = rows / G;
    if (qt < 1) qt = 1;
    if (qt > sq) qt = sq;
    a.QT = qt;
    a.QR = qt * G;
    a.TK = rows;
    dim3 grid((sq + qt - 1) / qt, K, b);
    size_t smem = pa_smem_bytes(a.QR, a.TK, hd) + 4 * sizeof(int);
    if (smem > 227 * 1024) return -1;
    int hpt = (hd + PA_THREADS - 1) / PA_THREADS;
    int rg = (hd >= PA_THREADS) ? 1 : PA_THREADS / hd;
    int rpt = (a.QR + rg - 1) / rg;
    cudaStream_t st = (cudaStream_t)stream;
    if (hpt == 1) {
        if (rpt <= 4) return fa_launch_n<4, 1>(a, grid, smem, st);
        if (rpt <= 16) return fa_launch_n<16, 1>(a, grid, smem, st);
        if (rpt <= 64) return fa_launch_n<64, 1>(a, grid, smem, st);
        return -1;
    }
    if (hpt == 2) {
        if (rpt <= 8) return fa_launch_n<16, 2>(a, grid, smem, st);
        if (rpt <= 32) return fa_launch_n<64, 2>(a, grid, smem, st);
        return -1;
    }
    return -1;
}
