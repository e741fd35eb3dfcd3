// Flash attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels kernels/flash_attention_bwd.py · _dq_kernel and
// _dkv_kernel (flash_attention_bwd) of the reference package: dQ, dK, dV of
// GQA attention of q [b, sq, K*G, hd] over k/v [b, sk, K, hd] (query head h
// reads kv head h / G) under the position mask (kpos <= qpos) & (kpos >= 0),
// with the optional sliding window (kpos > qpos - window) and chunk
// (kpos / chunk == qpos / chunk). Nothing of size [sq, sk] reaches device
// memory: both kernels recompute p = exp(s - lse) from the forward's saved
// row log-sum-exp, with s = (q / sqrt(hd)) . k, and take D = rowsum(dO * O)
// (computed before the launch, as the reference computes it outside its
// pallas_call):
//   dv = p^T dO,  ds = p * (dO v^T - D),  dq = ds k / sqrt(hd),
//   dk = ds^T q / sqrt(hd).
// f32 arithmetic on bf16 or f32 inputs; outputs in the inputs' dtype. A
// pair that is not visible has p = 0, so a row that sees nothing (lse =
// -1e30 from the forward) and a padded row (pos -1) get zero gradients.
//
// GQA is taken natively: dK/dV are per KV head, summed inside the kernel
// over the G query heads that share it (the reference repeats K/V to H heads
// and sums afterwards).
//
// Bound on this card: operations (2 * hd per visible pair and query head
// for each of the five products s, dO v^T, dv, dq, dk) above a few hundred
// positions. Design, the reference's two-kernel schedule, deterministic (no
// atomics on the outputs):
//   dQ kernel: one block (256 threads) per (tile of QT query positions, kv
//     head, batch row), all G heads of the kv head as QR = QT * G rows;
//     walks K/V in tiles of TK keys, dq accumulated in shared memory (f32).
//   dK/dV kernel: one block per (tile of TK keys, kv head, batch row); walks
//     the query tiles, dk and dv accumulated in shared memory (f32).
// Each step: the tile's rows into shared memory in f32; s and dO v^T as a
// 4 x 4 register tile of (row, key) pairs a thread, p and ds stored to
// shared memory; then the accumulating products as a 4 x RN register tile
// of outputs a thread. Tiles are skipped from the positions themselves
// (never the indices), as the forward kernel does, so any sq, sk and any
// positions work; the last tiles are bounds-checked. CUDA cores in f32: no
// tensor cores, no asynchronous copies yet.
#include <limits.h>

#include "paged_attend.cuh"

#define BW_THREADS 256

struct BwdArgs {
    const void* q;           // [b, sq, K * G, hd]
    const void* k;           // [b, sk, K, hd]
    const void* v;
    const void* dout;        // [b, sq, K * G, hd]
    const float* lse;        // [b, sq, K * G]
    const float* dvec;       // [b, sq, K * G]: D = rowsum(dO * O)
    const int* qpos;         // [b, sq]
    const int* kpos;         // [b, sk]
    void* dq;                // [b, sq, K * G, hd]
    void* dk;                // [b, sk, K, hd]
    void* dv;
    int b, sq, sk, K, G, hd;
    int dtype;               // PA_F32 | PA_BF16, of every tensor but lse, D
    int window, chunk;       // 0 = none
    int QT, QR, TK;          // query positions and rows per tile, keys per tile
    float scale;             // 1 / sqrt(hd)
};

// Float offsets of the shared buffers (rows padded to an odd stride, which
// keeps the column reads of both products free of bank conflicts); the int
// buffers qp_s[QR], cp_s[TK], bnd_s[4] follow the floats.
struct BwLayout {
    int q, dO, k, v, p, ds, acc, acc2, lse, dvec, nf;
};

__host__ __device__ inline BwLayout bw_layout(int QR, int TK, int hd,
                                              bool dkv) {
    BwLayout L;
    const int ld = hd + 1;
    int o = 0;
    L.q = o; o += QR * ld;
    L.dO = o; o += QR * ld;
    L.k = o; o += TK * ld;
    L.v = o; o += TK * ld;
    if (dkv) {               // p and ds by key row: [TK][QR + 1]
        L.p = o; o += TK * (QR + 1);
        L.ds = o; o += TK * (QR + 1);
        L.acc = o; o += TK * hd;     // dk
        L.acc2 = o; o += TK * hd;    // dv
    } else {                 // ds by query row: [QR][TK + 1]
        L.p = -1;
        L.ds = o; o += QR * (TK + 1);
        L.acc = o; o += QR * hd;     // dq
        L.acc2 = -1;
    }
    L.lse = o; o += QR;
    L.dvec = o; o += QR;
    L.nf = o;
    return L;
}

__host__ __device__ inline size_t bw_smem_bytes(int QR, int TK, int hd,
                                                bool dkv) {
    return ((size_t)bw_layout(QR, TK, hd, dkv).nf + QR + TK + 4) * 4;
}

// Query-side rows ml < QR of the tile at position t0 (position t0 + ml / G,
// head kh * G + ml % G) of a [b, sq, H, hd] tensor, times mul, into
// dst[ml * (hd + 1) + h]; rows past sq are zeros.
__device__ __forceinline__ void bw_load_q(const void* src, float* dst,
                                          const BwdArgs& a, int bi, int t0,
                                          int kh, float mul) {
    const int hd = a.hd, G = a.G, H = a.K * a.G;
    for (int idx = threadIdx.x; idx < a.QR * hd; idx += BW_THREADS) {
        int ml = idx / hd, h = idx - ml * hd;
        int t = t0 + ml / G, g = ml - (ml / G) * G;
        float val = 0.f;
        if (t < a.sq)
            val = pa_load(src, (((size_t)bi * a.sq + t) * H + kh * G + g) * hd
                                   + h, a.dtype) * mul;
        dst[ml * (hd + 1) + h] = val;
    }
}

// Key rows r < TK of the tile at key k0 (kv head kh) of a [b, sk, K, hd]
// tensor into dst[r * (hd + 1) + h]; keys past sk or at position -1
// (cp_s[r] < 0) are zeros.
__device__ __forceinline__ void bw_load_k(const void* src, float* dst,
                                          const int* cp_s, const BwdArgs& a,
                                          int bi, int k0, int kh) {
    const int hd = a.hd;
    for (int idx = threadIdx.x; idx < a.TK * hd; idx += BW_THREADS) {
        int r = idx / hd, h = idx - r * hd;
        float val = 0.f;
        if (cp_s[r] >= 0)
            val = pa_load(src, (((size_t)bi * a.sk + k0 + r) * a.K + kh) * hd
                                   + h, a.dtype);
        dst[r * (hd + 1) + h] = val;
    }
}

// Positions of the query rows of the tile at t0 (-1 past sq) into qp_s, and
// the span of the valid ones into bnd[0] (min), bnd[1] (max; -1 = none).
// Starts and ends with a barrier.
__device__ __forceinline__ void bw_query_positions(int* qp_s, int* bnd,
                                                   const BwdArgs& a, int bi,
                                                   int t0) {
    if (threadIdx.x == 0) {
        bnd[0] = INT_MAX;
        bnd[1] = -1;
    }
    __syncthreads();
    for (int ml = threadIdx.x; ml < a.QR; ml += BW_THREADS) {
        int t = t0 + ml / a.G;
        int p = (t < a.sq) ? a.qpos[(size_t)bi * a.sq + t] : -1;
        qp_s[ml] = p;
        if (p >= 0) {
            atomicMin(&bnd[0], p);
            atomicMax(&bnd[1], p);
        }
    }
    __syncthreads();
}

// The same for the keys of the tile at k0, into cp_s and bnd[2], bnd[3].
__device__ __forceinline__ void bw_key_positions(int* cp_s, int* bnd,
                                                 const BwdArgs& a, int bi,
                                                 int k0) {
    if (threadIdx.x == 0) {
        bnd[2] = INT_MAX;
        bnd[3] = -1;
    }
    __syncthreads();
    for (int r = threadIdx.x; r < a.TK; r += BW_THREADS) {
        int j = k0 + r;
        int p = (j < a.sk) ? a.kpos[(size_t)bi * a.sk + j] : -1;
        cp_s[r] = p;
        if (p >= 0) {
            atomicMin(&bnd[2], p);
            atomicMax(&bnd[3], p);
        }
    }
    __syncthreads();
}

// Whether a (query tile, key tile) pair can hold a visible pair, from the
// spans of their valid positions.
__device__ __forceinline__ bool bw_live(const int* bnd, int window,
                                        int chunk) {
    const int qmin = bnd[0], qmax = bnd[1], kmin = bnd[2], kmax = bnd[3];
    bool live = qmax >= 0 && kmax >= 0 && kmin <= qmax;
    if (window > 0) live = live && kmax > qmin - window;
    if (chunk > 0)
        live = live && kmax / chunk >= qmin / chunk
                    && kmin / chunk <= qmax / chunk;
    return live;
}

// p = exp(s - lse) and ds = p * (dO . v - D) of the QR x TK tile, s = q . k
// (q pre-scaled); both 0 where the pair is not visible. Element (ml, r)
// goes to [ml * sm + r * sk] of p_out (if not null) and ds_out. Returns,
// block-wide (a barrier), whether any pair of the tile was visible.
__device__ __forceinline__ int bw_scores(
    const float* q_s, const float* do_s, const float* k_s, const float* v_s,
    const float* lse_s, const float* d_s, const int* qp_s, const int* cp_s,
    float* p_out, float* ds_out, int sm, int sk, const BwdArgs& a) {
    const int QR = a.QR, TK = a.TK, hd = a.hd, ld = hd + 1;
    const int TXN = (TK + 3) / 4, TYN = (QR + 3) / 4;
    int any = 0;
    for (int t = threadIdx.x; t < TXN * TYN; t += BW_THREADS) {
        const int ty = t / TXN, tx = t - ty * TXN;
        unsigned vis = 0u;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                int ml = 4 * ty + i, r = tx + TXN * j;
                if (ml < QR && r < TK &&
                    pa_visible(cp_s[r], qp_s[ml], a.window, a.chunk))
                    vis |= 1u << (4 * i + j);
            }
        float s[4][4], e[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = e[i][j] = 0.f;
        if (vis) {
            any = 1;
            const float* qr[4];
            const float* dr[4];
            const float* kr[4];
            const float* vr[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                int ml = min(4 * ty + i, QR - 1);
                qr[i] = q_s + ml * ld;
                dr[i] = do_s + ml * ld;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                int r = min(tx + TXN * j, TK - 1);
                kr[j] = k_s + r * ld;
                vr[j] = v_s + r * ld;
            }
            for (int h = 0; h < hd; ++h) {
                float qv[4], dv[4], kv[4], vv[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    qv[i] = qr[i][h];
                    dv[i] = dr[i][h];
                }
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    kv[j] = kr[j][h];
                    vv[j] = vr[j][h];
                }
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
                        e[i][j] = fmaf(dv[i], vv[j], e[i][j]);
                    }
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                int ml = 4 * ty + i, r = tx + TXN * j;
                if (ml < QR && r < TK) {
                    float p = 0.f, ds = 0.f;
                    if ((vis >> (4 * i + j)) & 1u) {
                        p = expf(s[i][j] - lse_s[ml]);
                        ds = p * (e[i][j] - d_s[ml]);
                    }
                    if (p_out != nullptr) p_out[ml * sm + r * sk] = p;
                    ds_out[ml * sm + r * sk] = ds;
                }
            }
    }
    return __syncthreads_or(any);
}

// C[m * ldc + n] += sum over kk < Kd of A[m * lda + kk] * B[kk * ldb + n],
// for m < M <= 64 and n < N <= 16 * RN, C in shared memory. Thread (ty =
// tid / 16, tx = tid % 16) owns rows ty + 16 i and columns tx + 16 j, so no
// two threads write one element.
template <int RN>
__device__ __forceinline__ void bw_mm(const float* A, int lda, const float* B,
                                      int ldb, float* C, int ldc, int M,
                                      int N, int Kd) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
    float acc[4][RN];
    const float* ar[4];
    int nc[RN];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        ar[i] = A + min(ty + 16 * i, M - 1) * lda;
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < RN; ++j) nc[j] = min(tx + 16 * j, N - 1);
#pragma unroll 4
    for (int kk = 0; kk < Kd; ++kk) {
        float av[4], bv[RN];
        const float* br = B + kk * ldb;
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = ar[i][kk];
#pragma unroll
        for (int j = 0; j < RN; ++j) bv[j] = br[nc[j]];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < RN; ++j)
                acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) {
            int m = ty + 16 * i, n = tx + 16 * j;
            if (m < M && n < N) C[m * ldc + n] += acc[i][j];
        }
}

// Per-row lse and D of the query rows of the tile at t0 (0 past sq).
__device__ __forceinline__ void bw_load_rows(float* lse_s, float* d_s,
                                             const BwdArgs& a, int bi,
                                             int t0, int kh) {
    const int H = a.K * a.G;
    for (int ml = threadIdx.x; ml < a.QR; ml += BW_THREADS) {
        int t = t0 + ml / a.G, g = ml - (ml / a.G) * a.G;
        float l = 0.f, d = 0.f;
        if (t < a.sq) {
            size_t o = ((size_t)bi * a.sq + t) * H + kh * a.G + g;
            l = a.lse[o];
            d = a.dvec[o];
        }
        lse_s[ml] = l;
        d_s[ml] = d;
    }
}

template <int RN>
__global__ void __launch_bounds__(BW_THREADS)
flash_bwd_dq_kernel(BwdArgs a) {
    extern __shared__ float4 smem4[];
    float* sm = (float*)smem4;
    const int hd = a.hd, QR = a.QR, TK = a.TK, G = a.G, H = a.K * a.G;
    const BwLayout L = bw_layout(QR, TK, hd, false);
    float* q_s = sm + L.q;
    float* do_s = sm + L.dO;
    float* k_s = sm + L.k;
    float* v_s = sm + L.v;
    float* ds_s = sm + L.ds;
    float* acc_s = sm + L.acc;
    float* lse_s = sm + L.lse;
    float* d_s = sm + L.dvec;
    int* qp_s = (int*)(sm + L.nf);
    int* cp_s = qp_s + QR;
    int* bnd = cp_s + TK;
    const int t0 = blockIdx.x * a.QT, kh = blockIdx.y, bi = blockIdx.z;

    bw_load_q(a.q, q_s, a, bi, t0, kh, a.scale);
    bw_load_q(a.dout, do_s, a, bi, t0, kh, 1.f);
    bw_load_rows(lse_s, d_s, a, bi, t0, kh);
    for (int idx = threadIdx.x; idx < QR * hd; idx += BW_THREADS)
        acc_s[idx] = 0.f;
    bw_query_positions(qp_s, bnd, a, bi, t0);
    const bool rows_live = bnd[1] >= 0;

    for (int k0 = 0; k0 < a.sk && rows_live; k0 += TK) {
        bw_key_positions(cp_s, bnd, a, bi, k0);
        const bool live = bw_live(bnd, a.window, a.chunk);
        __syncthreads();             // bnd is rewritten by the next tile
        if (!live) continue;
        bw_load_k(a.k, k_s, cp_s, a, bi, k0, kh);
        bw_load_k(a.v, v_s, cp_s, a, bi, k0, kh);
        __syncthreads();
        if (!bw_scores(q_s, do_s, k_s, v_s, lse_s, d_s, qp_s, cp_s, nullptr,
                       ds_s, TK + 1, 1, a))
            continue;                // nothing visible: a no-op
        bw_mm<RN>(ds_s, TK + 1, k_s, hd + 1, acc_s, hd, QR, hd, TK);
        __syncthreads();
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < QR * hd; idx += BW_THREADS) {
        int ml = idx / hd, h = idx - ml * hd;
        int t = t0 + ml / G, g = ml - (ml / G) * G;
        if (t < a.sq)
            pa_store(a.dq, (((size_t)bi * a.sq + t) * H + kh * G + g) * hd + h,
                     a.dtype, acc_s[idx] * a.scale);
    }
}

template <int RN>
__global__ void __launch_bounds__(BW_THREADS)
flash_bwd_dkv_kernel(BwdArgs a) {
    extern __shared__ float4 smem4[];
    float* sm = (float*)smem4;
    const int hd = a.hd, QR = a.QR, TK = a.TK;
    const BwLayout L = bw_layout(QR, TK, hd, true);
    float* q_s = sm + L.q;
    float* do_s = sm + L.dO;
    float* k_s = sm + L.k;
    float* v_s = sm + L.v;
    float* p_s = sm + L.p;
    float* ds_s = sm + L.ds;
    float* dk_s = sm + L.acc;
    float* dv_s = sm + L.acc2;
    float* lse_s = sm + L.lse;
    float* d_s = sm + L.dvec;
    int* qp_s = (int*)(sm + L.nf);
    int* cp_s = qp_s + QR;
    int* bnd = cp_s + TK;
    const int k0 = blockIdx.x * TK, kh = blockIdx.y, bi = blockIdx.z;

    for (int idx = threadIdx.x; idx < TK * hd; idx += BW_THREADS) {
        dk_s[idx] = 0.f;
        dv_s[idx] = 0.f;
    }
    bw_key_positions(cp_s, bnd, a, bi, k0);
    const bool keys_live = bnd[3] >= 0;
    if (keys_live) {
        bw_load_k(a.k, k_s, cp_s, a, bi, k0, kh);
        bw_load_k(a.v, v_s, cp_s, a, bi, k0, kh);
    }

    for (int t0 = 0; t0 < a.sq && keys_live; t0 += a.QT) {
        bw_query_positions(qp_s, bnd, a, bi, t0);
        const bool live = bw_live(bnd, a.window, a.chunk);
        __syncthreads();             // bnd is rewritten by the next tile
        if (!live) continue;
        bw_load_q(a.q, q_s, a, bi, t0, kh, a.scale);
        bw_load_q(a.dout, do_s, a, bi, t0, kh, 1.f);
        bw_load_rows(lse_s, d_s, a, bi, t0, kh);
        __syncthreads();
        if (!bw_scores(q_s, do_s, k_s, v_s, lse_s, d_s, qp_s, cp_s, p_s, ds_s,
                       1, QR + 1, a))
            continue;                // nothing visible: a no-op
        // q was pre-scaled at load, so ds^T q already carries 1/sqrt(hd)
        bw_mm<RN>(p_s, QR + 1, do_s, hd + 1, dv_s, hd, TK, hd, QR);
        bw_mm<RN>(ds_s, QR + 1, q_s, hd + 1, dk_s, hd, TK, hd, QR);
        __syncthreads();
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < TK * hd; idx += BW_THREADS) {
        int r = idx / hd, h = idx - r * hd;
        if (k0 + r < a.sk) {
            size_t o = (((size_t)bi * a.sk + k0 + r) * a.K + kh) * hd + h;
            pa_store(a.dk, o, a.dtype, dk_s[idx]);
            pa_store(a.dv, o, a.dtype, dv_s[idx]);
        }
    }
}

// Tiles of one kernel: about 64 query rows (a whole number of positions'
// G heads) and 64 keys, halved until the shared memory fits a block.
// Returns false when no tiling fits (more than 64 rows for one position).
static bool bw_tiles(BwdArgs& a, bool dkv) {
    int rows = 64, tk = 64;
    for (;;) {
        int qt = rows / a.G;
        if (qt < 1) qt = 1;
        if (qt > a.sq) qt = a.sq;
        if (qt * a.G > 64) return false;
        if (bw_smem_bytes(qt * a.G, tk, a.hd, dkv) <= 227 * 1024) {
            a.QT = qt;
            a.QR = qt * a.G;
            a.TK = tk;
            return true;
        }
        if (rows > a.G && rows > 16) rows /= 2;
        else if (tk > 16) tk /= 2;
        else return false;
    }
}

template <int RN>
static int bw_launch(BwdArgs aq, BwdArgs akv, cudaStream_t st) {
    size_t sq_bytes = bw_smem_bytes(aq.QR, aq.TK, aq.hd, false);
    size_t skv_bytes = bw_smem_bytes(akv.QR, akv.TK, akv.hd, true);
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<RN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sq_bytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<RN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)skv_bytes);
    if (e != cudaSuccess) return (int)e;
    dim3 gq((aq.sq + aq.QT - 1) / aq.QT, aq.K, aq.b);
    flash_bwd_dq_kernel<RN><<<gq, BW_THREADS, sq_bytes, st>>>(aq);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    dim3 gkv((akv.sk + akv.TK - 1) / akv.TK, akv.K, akv.b);
    flash_bwd_dkv_kernel<RN><<<gkv, BW_THREADS, skv_bytes, st>>>(akv);
    return (int)cudaGetLastError();
}

// Returns a cudaError_t, or -1 when the shape is not supported (head_dim
// above 256, or more than 64 query heads per kv head).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* dvec, const int* qpos, const int* kpos,
    void* dq, void* dk, void* dv, int b, int sq, int sk, int K, int G,
    int hd, int dtype, int window, int chunk, float scale, void* stream) {
    BwdArgs a;
    a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.dvec = dvec;
    a.qpos = qpos; a.kpos = kpos; a.dq = dq; a.dk = dk; a.dv = dv;
    a.b = b; a.sq = sq; a.sk = sk; a.K = K; a.G = G; a.hd = hd;
    a.dtype = dtype; a.window = window; a.chunk = chunk; a.scale = scale;
    BwdArgs aq = a, akv = a;
    if (!bw_tiles(aq, false) || !bw_tiles(akv, true)) return -1;
    cudaStream_t st = (cudaStream_t)stream;
    if (hd <= 32) return bw_launch<2>(aq, akv, st);
    if (hd <= 64) return bw_launch<4>(aq, akv, st);
    if (hd <= 80) return bw_launch<5>(aq, akv, st);
    if (hd <= 128) return bw_launch<8>(aq, akv, st);
    if (hd <= 256) return bw_launch<16>(aq, akv, st);
    return -1;
}
