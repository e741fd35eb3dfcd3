// Flash attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels kernels/flash_attention_bwd.py · _dq_kernel and
// _dkv_kernel (flash_attention_bwd) of the reference package: dQ, dK, dV of
// GQA attention of q [b, sq, K*G, hd] over k/v [b, sk, K, hd] (query head h
// reads kv head h / G) under the position mask (kpos <= qpos) & (kpos >= 0),
// with the optional sliding window (kpos > qpos - window) and chunk
// (kpos / chunk == qpos / chunk). Nothing of size [sq, sk] reaches device
// memory: both kernels recompute p = exp(s - lse) from the forward's saved
// row log-sum-exp, with s = (q . k) / sqrt(hd), and take D = rowsum(dO * O)
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
// for each of the products) above a few hundred positions. Both bodies keep
// the reference's deterministic two-kernel schedule (no atomics on the
// outputs; a dQ accumulated across key tiles in one pass would need them):
// a dQ kernel, one block per tile of query rows walking the key tiles, and
// a dK/dV kernel, one block per tile of keys walking the query tiles. Two
// bodies, chosen by dtype alone; the entry point reports which one ran.
//
// bf16 inputs: the tensor-core bodies (flash_bwd_dq_tc_kernel,
// flash_bwd_dkv_tc_kernel), 8 warps a block, mma.sync m16n8k16 (bf16 in,
// f32 out) for every product, the walk over the streamed tiles worked out
// once a block from the positions, the tiles through a two-stage cp.async
// ring in shared memory, the mask from the positions in registers; two
// blocks an SM up to hd 96.
//   dQ: 128 G-packed query rows a block, 16 a warp (as the forward): S =
//     Q K^T and dP = dO V^T in registers, P and dS elementwise there, dQ +=
//     dS K with dS fed from the accumulators as A fragments.
//   dK/dV: 16 keys a warp (a warp pair splits the head dimension above
//     128), walking tiles of 32 G-packed query rows: S^T = K Q^T and
//     dP^T = V dO^T are computed transposed, so P^T and dS^T come out of
//     the accumulators as the A fragments of dV += P^T dO and dK += dS^T Q:
//     no transpose through shared memory.
//   P and dS go into their products as bf16 hi + lo halves (one bf16
//   rounding would carry 2^-9 of each into dq, dk and dv, above the bf16
//   tolerance: tests/test_torch_flash_rounding.py); 1/sqrt(hd) is applied
//   to the f32 products, never to q before a rounding. The head dimension is
//   padded with zeros to a multiple of 16 (of 32 above 128) in shared
//   memory; hd must be a multiple of 8.
//
// f32 inputs: the CUDA-core bodies (flash_bwd_dq_kernel,
// flash_bwd_dkv_kernel), f32 throughout (f32 parity at 1e-4 of the value
// excludes TF32 products): 256 threads a block, the tile's rows in shared
// memory in f32, s and dO v^T as a 4 x 4 register tile of (row, key) pairs
// a thread, p and ds stored to shared memory, then the accumulating
// products as a 4 x RN register tile of outputs a thread.
//
// Tiles are skipped from the positions themselves (never the indices), as
// the forward kernel does, so any sq, sk and any positions work; the last
// tiles are bounds-checked.
#include <limits.h>

#include "mma_tile.cuh"
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

// ---- bf16: the tensor-core bodies -----------------------------------------

#define BT_WARPS 8
#define BT_THREADS (BT_WARPS * 32)
#define BT_QROWS (BT_WARPS * 16)     // query rows of a dQ block

// dQ: q_s, do_s [BT_QROWS][LD]; k_s, v_s [2][BN][LD] (bf16); kp_s [2][BN]
// (int); then the walk's flags fl_s[ntile]
static constexpr size_t bt_dq_smem(int hdp, int bn) {
    return 2 * (2 * (size_t)BT_QROWS + 4 * bn) * MT_LD(hdp) + 8 * (size_t)bn;
}

// Two blocks an SM up to hd 96 (32-key tiles), as the forward.
template <int HDP, int BN>
__global__ void __launch_bounds__(BT_THREADS, HDP <= 96 ? 2 : 1)
flash_bwd_dq_tc_kernel(BwdArgs a) {
    constexpr int LD = MT_LD(HDP), NT = HDP / 8, ST = BN / 8;
    extern __shared__ float4 smem4[];
    __nv_bfloat16* q_s = (__nv_bfloat16*)smem4;
    __nv_bfloat16* do_s = q_s + BT_QROWS * LD;
    __nv_bfloat16* k_s = do_s + BT_QROWS * LD;
    __nv_bfloat16* v_s = k_s + 2 * BN * LD;
    int* kp_s = (int*)(v_s + 2 * BN * LD);
    unsigned char* fl_s = (unsigned char*)(kp_s + 2 * BN);
    const __nv_bfloat16* kg = (const __nv_bfloat16*)a.k;
    const __nv_bfloat16* vg = (const __nv_bfloat16*)a.v;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int hd = a.hd, G = a.G, K = a.K, H = K * G, QR = a.QR;
    // the last query tiles first: under a causal mask they see the most
    // keys, and a wave that ends on them leaves the card idle
    const int t0 = ((int)gridDim.x - 1 - (int)blockIdx.x) * a.QT;
    const int kh = blockIdx.y, bi = blockIdx.z;
    const int* kpos = a.kpos + (size_t)bi * a.sk;

    auto qoff = [&](int ml) -> long long {
        const int t = t0 + ml / G;
        if (ml >= QR || t >= a.sq) return -1;
        return (((long long)bi * a.sq + t) * H + kh * G + ml % G) * hd;
    };
    mt_copy_rows(q_s, LD, (const __nv_bfloat16*)a.q, BT_QROWS, hd, qoff, tid,
                 BT_THREADS);
    mt_copy_rows(do_s, LD, (const __nv_bfloat16*)a.dout, BT_QROWS, hd, qoff,
                 tid, BT_THREADS);
    mt_cp_commit();
    if (HDP > hd) {
        mt_zero_cols(q_s, LD, 2 * BT_QROWS, hd, HDP, tid, BT_THREADS);
        mt_zero_cols(k_s, LD, 4 * BN, hd, HDP, tid, BT_THREADS);
    }
    int qp[2];
    float lse[2], dd[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int ml = warp * 16 + g + 8 * i, t = t0 + ml / G;
        const bool ok = ml < QR && t < a.sq;
        const size_t row = ((size_t)bi * a.sq + t) * H + kh * G + ml % G;
        qp[i] = ok ? a.qpos[(size_t)bi * a.sq + t] : -1;
        lse[i] = ok ? a.lse[row] : 0.f;
        dd[i] = ok ? a.dvec[row] : 0.f;
    }
    const bool warp_live = warp * 16 < QR && t0 + warp * 16 / G < a.sq;
    const MtSpan qs = mt_span(a.qpos + (size_t)bi * a.sq + t0,
                              min(a.QT, a.sq - t0), lane);
    const int ntile = qs.hi >= 0 ? (a.sk + BN - 1) / BN : 0;
    mt_schedule(fl_s, kpos, a.sk, BN, ntile, qs, true, a.window, a.chunk,
                tid, BT_THREADS);
    __syncthreads();
    auto load = [&](int j, int st) {
        const int k0 = j * BN;
        auto off = [&](int r) -> long long {
            if (k0 + r >= a.sk) return -1;
            return (((long long)bi * a.sk + k0 + r) * K + kh) * hd;
        };
        mt_copy_rows(k_s + st * BN * LD, LD, kg, BN, hd, off, tid,
                     BT_THREADS);
        mt_copy_rows(v_s + st * BN * LD, LD, vg, BN, hd, off, tid,
                     BT_THREADS);
    };
    auto key_pos = [&](int j) -> int {
        const int key = j * BN + tid;
        return (tid < BN && key < a.sk) ? kpos[key] : -1;
    };

    float dq[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
        dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
    int cur = mt_next(fl_s, 0, ntile);
    if (cur < ntile) {
        load(cur, 0);
        if (tid < BN) kp_s[tid] = key_pos(cur);
    }
    mt_cp_commit();
    for (int st = 0; cur < ntile; st ^= 1) {
        const int nxt = mt_next(fl_s, cur + 1, ntile);
        int kp_next = -1;
        if (nxt < ntile) {
            load(nxt, st ^ 1);
            kp_next = key_pos(nxt);
        }
        mt_cp_commit();
        mt_cp_wait<1>();
        __syncthreads();
        const __nv_bfloat16* ks = k_s + st * BN * LD;
        const __nv_bfloat16* vs = v_s + st * BN * LD;
        const int* kps = kp_s + st * BN;
        const unsigned char f = fl_s[cur];
        if (f & MT_HOLES) {
            mt_zero_holes(k_s + st * BN * LD, LD, kps, BN, HDP, tid,
                          BT_THREADS);
            mt_zero_holes(v_s + st * BN * LD, LD, kps, BN, HDP, tid,
                          BT_THREADS);
            __syncthreads();
        }
        const bool full = f & MT_FULL;
        if (warp_live) {
            // ---- S = Q K^T, dP = dO V^T
            float s[ST][4], dp[ST][4];
#pragma unroll
            for (int j = 0; j < ST; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
            for (int kc = 0; kc < HDP / 16; ++kc) {
                uint32_t aq[4], ad[4];
                mt_frag_a(aq, q_s, LD, warp * 16, kc * 16, lane);
                mt_frag_a(ad, do_s, LD, warp * 16, kc * 16, lane);
#pragma unroll
                for (int np = 0; np < BN / 16; ++np) {
                    uint32_t bk[4], bv[4];
                    mt_frag_b(bk, ks, LD, np * 16, kc * 16, lane);
                    mt_frag_b(bv, vs, LD, np * 16, kc * 16, lane);
                    mt_mma(s[2 * np], aq, bk);
                    mt_mma(s[2 * np + 1], aq, bk + 2);
                    mt_mma(dp[2 * np], ad, bv);
                    mt_mma(dp[2 * np + 1], ad, bv + 2);
                }
            }
            // ---- p = exp(s - lse) where visible, ds = p (dp - D), into s
#pragma unroll
            for (int j = 0; j < ST; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int i = e >> 1;
                    bool vis = true;
                    if (!full) {
                        const int kp = kps[j * 8 + 2 * t4 + (e & 1)];
                        vis = kp >= 0 && kp <= qp[i];
                        if (a.window > 0) vis = vis && kp > qp[i] - a.window;
                        if (a.chunk > 0)
                            vis = vis && kp / a.chunk == qp[i] / a.chunk;
                    }
                    const float p = vis ? expf(s[j][e] * a.scale - lse[i])
                                        : 0.f;
                    s[j][e] = p * (dp[j][e] - dd[i]);
                }
            // ---- dQ += dS K (dS as bf16 hi + lo)
#pragma unroll
            for (int kk = 0; kk < BN / 16; ++kk) {
                uint32_t hi[4], lo[4];
                mt_c_to_a(s, kk, hi, lo);
#pragma unroll
                for (int np = 0; np < HDP / 16; ++np) {
                    uint32_t bf[4];
                    mt_frag_b_t(bf, ks, LD, kk * 16, np * 16, lane);
                    mt_mma(dq[2 * np], hi, bf);
                    mt_mma(dq[2 * np], lo, bf);
                    mt_mma(dq[2 * np + 1], hi, bf + 2);
                    mt_mma(dq[2 * np + 1], lo, bf + 2);
                }
            }
        }
        if (nxt < ntile && tid < BN) kp_s[(st ^ 1) * BN + tid] = kp_next;
        __syncthreads();
        cur = nxt;
    }
    mt_cp_wait<0>();

    __nv_bfloat16* dqg = (__nv_bfloat16*)a.dq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int ml = warp * 16 + g + 8 * i, t = t0 + ml / G;
        if (ml >= QR || t >= a.sq) continue;
        const size_t row = ((size_t)bi * a.sq + t) * H + kh * G + ml % G;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            const int c = n * 8 + 2 * t4;
            if (c < hd)
                *(uint32_t*)(dqg + row * hd + c) = mt_pack(
                    dq[n][2 * i] * a.scale, dq[n][2 * i + 1] * a.scale);
        }
    }
}

// dK/dV: k_s, v_s [BN][LD]; q_s, do_s [2][BM][LD] (bf16); then qp_s [2][BM]
// (int), lse_s, d_s [2][BM] (float) and the walk's flags fl_s[ntile]
static constexpr size_t bt_dkv_smem(int hdp, int bn, int bm) {
    return 2 * (2 * (size_t)bn + 4 * bm) * MT_LD(hdp) + 24 * (size_t)bm;
}

// HS warps share a slice of 16 keys, each owning HDP / HS columns of its dK
// and dV (HS = 2 halves the accumulators above hd 128, at the cost of S and
// dP computed by both); BM query rows a tile. Two blocks an SM up to hd
// 96, as the forward.
template <int HDP, int HS, int BM>
__global__ void __launch_bounds__(BT_THREADS, HDP <= 96 ? 2 : 1)
flash_bwd_dkv_tc_kernel(BwdArgs a) {
    constexpr int LD = MT_LD(HDP), BN = 16 * BT_WARPS / HS;
    constexpr int HW = HDP / HS, NT = HW / 8, ST = BM / 8;
    extern __shared__ float4 smem4[];
    __nv_bfloat16* k_s = (__nv_bfloat16*)smem4;
    __nv_bfloat16* v_s = k_s + BN * LD;
    __nv_bfloat16* q_s = v_s + BN * LD;
    __nv_bfloat16* do_s = q_s + 2 * BM * LD;
    int* qp_s = (int*)(do_s + 2 * BM * LD);
    float* lse_s = (float*)(qp_s + 2 * BM);
    float* d_s = lse_s + 2 * BM;
    unsigned char* fl_s = (unsigned char*)(d_s + 2 * BM);
    const __nv_bfloat16* qg = (const __nv_bfloat16*)a.q;
    const __nv_bfloat16* dog = (const __nv_bfloat16*)a.dout;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int hd = a.hd, G = a.G, K = a.K, H = K * G, QR = a.QR, QT = a.QT;
    const int kw = warp / HS, c0 = (warp % HS) * HW;
    const int k0 = blockIdx.x * BN, kh = blockIdx.y, bi = blockIdx.z;
    const int* kpos = a.kpos + (size_t)bi * a.sk;
    const int* qpos = a.qpos + (size_t)bi * a.sq;

    mt_copy_rows(k_s, LD, (const __nv_bfloat16*)a.k, BN, hd,
                 [&](int r) -> long long {
        if (k0 + r >= a.sk) return -1;
        return (((long long)bi * a.sk + k0 + r) * K + kh) * hd;
    }, tid, BT_THREADS);
    mt_copy_rows(v_s, LD, (const __nv_bfloat16*)a.v, BN, hd,
                 [&](int r) -> long long {
        if (k0 + r >= a.sk) return -1;
        return (((long long)bi * a.sk + k0 + r) * K + kh) * hd;
    }, tid, BT_THREADS);
    mt_cp_commit();
    if (HDP > hd)                    // k, v and both stages of q, do
        mt_zero_cols(k_s, LD, 2 * BN + 4 * BM, hd, HDP, tid, BT_THREADS);
    // this thread's keys: g and g + 8 of the warp's 16
    int kp[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int key = k0 + kw * 16 + g + 8 * i;
        kp[i] = key < a.sk ? kpos[key] : -1;
    }
    const MtSpan ks = mt_span(kpos + k0, min(BN, a.sk - k0), lane);
    const bool warp_live = k0 + kw * 16 < a.sk;
    const int ntile = ks.hi >= 0 ? (a.sq + QT - 1) / QT : 0;
    mt_schedule(fl_s, qpos, a.sq, QT, ntile, ks, false, a.window, a.chunk,
                tid, BT_THREADS);
    __syncthreads();
    // rows past QR or sq are inert: zeros, and lse 1e30 so that p = 0 even
    // where the mask is skipped
    auto load = [&](int j, int st) {
        const int t0 = j * QT;
        auto off = [&](int ml) -> long long {
            const int t = t0 + ml / G;
            if (ml >= QR || t >= a.sq) return -1;
            return (((long long)bi * a.sq + t) * H + kh * G + ml % G) * hd;
        };
        mt_copy_rows(q_s + st * BM * LD, LD, qg, BM, hd, off, tid,
                     BT_THREADS);
        mt_copy_rows(do_s + st * BM * LD, LD, dog, BM, hd, off, tid,
                     BT_THREADS);
    };
    // a tile's row data (position, lse, D), a row a thread, fetched a round
    // before it is stored
    struct Rows {
        int p;
        float l, d;
    };
    auto rows_of = [&](int j) -> Rows {
        const int ml = tid, t = j * QT + ml / G;
        Rows r = {-1, 1e30f, 0.f};
        if (ml < BM && ml < QR && t < a.sq) {
            const size_t o = ((size_t)bi * a.sq + t) * H + kh * G + ml % G;
            r.p = qpos[t];
            r.l = a.lse[o];
            r.d = a.dvec[o];
        }
        return r;
    };
    auto put_rows = [&](const Rows& r, int st) {
        if (tid < BM) {
            qp_s[st * BM + tid] = r.p;
            lse_s[st * BM + tid] = r.l;
            d_s[st * BM + tid] = r.d;
        }
    };

    float dk[NT][4], dv[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
    int cur = mt_next(fl_s, 0, ntile);
    if (cur < ntile) {
        load(cur, 0);
        put_rows(rows_of(cur), 0);
    }
    mt_cp_commit();
    bool first = true;
    for (int st = 0; cur < ntile; st ^= 1) {
        const int nxt = mt_next(fl_s, cur + 1, ntile);
        Rows r_next = {-1, 1e30f, 0.f};
        if (nxt < ntile) {
            load(nxt, st ^ 1);
            r_next = rows_of(nxt);
        }
        mt_cp_commit();
        mt_cp_wait<1>();             // K, V and this tile have landed
        __syncthreads();
        if (!ks.all && first) {      // first round: zero padded key rows
            for (int i = tid; i < BN * HDP; i += BT_THREADS) {
                const int r = i / HDP, key = k0 + r;
                if (key < a.sk && kpos[key] < 0) {
                    k_s[r * LD + i - r * HDP] = __float2bfloat16(0.f);
                    v_s[r * LD + i - r * HDP] = __float2bfloat16(0.f);
                }
            }
            __syncthreads();
        }
        first = false;
        const bool full = fl_s[cur] & MT_FULL;
        if (warp_live) {
            const __nv_bfloat16* qt = q_s + st * BM * LD;
            const __nv_bfloat16* dot = do_s + st * BM * LD;
            const int* qps = qp_s + st * BM;
            const float* ls = lse_s + st * BM;
            const float* dds = d_s + st * BM;
            // ---- S^T = K Q^T, dP^T = V dO^T (keys x query rows)
            float s[ST][4], dp[ST][4];
#pragma unroll
            for (int j = 0; j < ST; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
            for (int c = 0; c < HDP / 16; ++c) {
                uint32_t ak[4], av[4];
                mt_frag_a(ak, k_s, LD, kw * 16, c * 16, lane);
                mt_frag_a(av, v_s, LD, kw * 16, c * 16, lane);
#pragma unroll
                for (int np = 0; np < BM / 16; ++np) {
                    uint32_t bq[4], bd[4];
                    mt_frag_b(bq, qt, LD, np * 16, c * 16, lane);
                    mt_frag_b(bd, dot, LD, np * 16, c * 16, lane);
                    mt_mma(s[2 * np], ak, bq);
                    mt_mma(s[2 * np + 1], ak, bq + 2);
                    mt_mma(dp[2 * np], av, bd);
                    mt_mma(dp[2 * np + 1], av, bd + 2);
                }
            }
            // ---- p^T where visible (into s), ds^T = p^T (dp^T - D) (into dp)
#pragma unroll
            for (int j = 0; j < ST; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int i = e >> 1, col = j * 8 + 2 * t4 + (e & 1);
                    bool vis = true;
                    if (!full) {
                        const int q = qps[col];
                        vis = kp[i] >= 0 && kp[i] <= q;
                        if (a.window > 0) vis = vis && kp[i] > q - a.window;
                        if (a.chunk > 0)
                            vis = vis && kp[i] / a.chunk == q / a.chunk;
                    }
                    const float p = vis ? expf(s[j][e] * a.scale - ls[col])
                                        : 0.f;
                    s[j][e] = p;
                    dp[j][e] = p * (dp[j][e] - dds[col]);
                }
            // ---- dV += P^T dO, then dK += dS^T Q (hi + lo halves; one
            // pass each, so that P is dead before dS's fragments live)
#pragma unroll
            for (int kk = 0; kk < BM / 16; ++kk) {
                uint32_t hi[4], lo[4];
                mt_c_to_a(s, kk, hi, lo);
#pragma unroll
                for (int np = 0; np < HW / 16; ++np) {
                    uint32_t bf[4];
                    mt_frag_b_t(bf, dot, LD, kk * 16, c0 + np * 16, lane);
                    mt_mma(dv[2 * np], hi, bf);
                    mt_mma(dv[2 * np], lo, bf);
                    mt_mma(dv[2 * np + 1], hi, bf + 2);
                    mt_mma(dv[2 * np + 1], lo, bf + 2);
                }
            }
#pragma unroll
            for (int kk = 0; kk < BM / 16; ++kk) {
                uint32_t hi[4], lo[4];
                mt_c_to_a(dp, kk, hi, lo);
#pragma unroll
                for (int np = 0; np < HW / 16; ++np) {
                    uint32_t bf[4];
                    mt_frag_b_t(bf, qt, LD, kk * 16, c0 + np * 16, lane);
                    mt_mma(dk[2 * np], hi, bf);
                    mt_mma(dk[2 * np], lo, bf);
                    mt_mma(dk[2 * np + 1], hi, bf + 2);
                    mt_mma(dk[2 * np + 1], lo, bf + 2);
                }
            }
        }
        if (nxt < ntile) put_rows(r_next, st ^ 1);
        __syncthreads();
        cur = nxt;
    }
    mt_cp_wait<0>();

    __nv_bfloat16* dkg = (__nv_bfloat16*)a.dk;
    __nv_bfloat16* dvg = (__nv_bfloat16*)a.dv;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int key = k0 + kw * 16 + g + 8 * i;
        if (key >= a.sk) continue;
        const size_t row = ((size_t)bi * a.sk + key) * K + kh;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            const int c = c0 + n * 8 + 2 * t4;
            if (c < hd) {
                *(uint32_t*)(dkg + row * hd + c) = mt_pack(
                    dk[n][2 * i] * a.scale, dk[n][2 * i + 1] * a.scale);
                *(uint32_t*)(dvg + row * hd + c) =
                    mt_pack(dv[n][2 * i], dv[n][2 * i + 1]);
            }
        }
    }
}

template <int HDP, int BN, int HS, int BM>
static int bt_launch(BwdArgs a, cudaStream_t st) {
    constexpr int KBN = 16 * BT_WARPS / HS;
    static_assert(bt_dq_smem(HDP, BN) <= 227 * 1024 &&
                  bt_dkv_smem(HDP, KBN, BM) <= 227 * 1024,
                  "shared memory of one block");
    if (a.G > BM) return -1;
    const int qt_kv = BM / a.G < a.sq ? BM / a.G : a.sq;
    const size_t sq_bytes = bt_dq_smem(HDP, BN) + (a.sk + BN - 1) / BN;
    const size_t skv_bytes =
        bt_dkv_smem(HDP, KBN, BM) + (a.sq + qt_kv - 1) / qt_kv;
    if (sq_bytes > 227 * 1024 || skv_bytes > 227 * 1024) return -1;
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_tc_kernel<HDP, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sq_bytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(
        flash_bwd_dkv_tc_kernel<HDP, HS, BM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)skv_bytes);
    if (e != cudaSuccess) return (int)e;
    BwdArgs aq = a, akv = a;
    aq.QT = BT_QROWS / a.G < a.sq ? BT_QROWS / a.G : a.sq;
    aq.QR = aq.QT * a.G;
    akv.QT = qt_kv;
    akv.QR = akv.QT * a.G;
    akv.TK = KBN;
    dim3 gq((a.sq + aq.QT - 1) / aq.QT, a.K, a.b);
    flash_bwd_dq_tc_kernel<HDP, BN><<<gq, BT_THREADS, sq_bytes, st>>>(aq);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    dim3 gkv((a.sk + KBN - 1) / KBN, a.K, a.b);
    flash_bwd_dkv_tc_kernel<HDP, HS, BM>
        <<<gkv, BT_THREADS, skv_bytes, st>>>(akv);
    return (int)cudaGetLastError();
}

// dQ: keys a tile; dK/dV: warps a key slice and query rows a tile, as the
// registers allow (accumulators: 4 * HDP / HS floats a thread; two blocks
// an SM up to hd 96)
static int bt_dispatch(const BwdArgs& a, cudaStream_t st) {
    switch (mt_hdp(a.hd)) {
    case 16: return bt_launch<16, 32, 1, 32>(a, st);
    case 32: return bt_launch<32, 32, 1, 32>(a, st);
    case 48: return bt_launch<48, 32, 1, 32>(a, st);
    case 64: return bt_launch<64, 32, 1, 32>(a, st);
    case 80: return bt_launch<80, 32, 1, 32>(a, st);
    case 96: return bt_launch<96, 32, 1, 32>(a, st);
    case 112: return bt_launch<112, 64, 1, 32>(a, st);
    case 128: return bt_launch<128, 64, 1, 32>(a, st);
    case 160: return bt_launch<160, 32, 2, 32>(a, st);
    case 192: return bt_launch<192, 32, 2, 32>(a, st);
    case 224: return bt_launch<224, 32, 2, 32>(a, st);
    case 256: return bt_launch<256, 32, 2, 32>(a, st);
    default: return -1;
    }
}

// Returns a cudaError_t, or -1 when the shape is not supported (head_dim
// above 256, or more than 64 query heads per kv head; bf16: head_dim not a
// multiple of 8, or more query heads per kv head than the dK/dV kernel's
// tile of BM = 32 query rows holds). *body is set to the body the dtype
// chose: 1 tensor cores (bf16), 0 CUDA cores (f32).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* dvec, const int* qpos, const int* kpos,
    void* dq, void* dk, void* dv, int b, int sq, int sk, int K, int G,
    int hd, int dtype, int window, int chunk, float scale, int* body,
    void* stream) {
    BwdArgs a;
    a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.dvec = dvec;
    a.qpos = qpos; a.kpos = kpos; a.dq = dq; a.dk = dk; a.dv = dv;
    a.b = b; a.sq = sq; a.sk = sk; a.K = K; a.G = G; a.hd = hd;
    a.dtype = dtype; a.window = window; a.chunk = chunk; a.scale = scale;
    *body = dtype == PA_BF16 ? 1 : 0;
    if (dtype == PA_BF16) return bt_dispatch(a, (cudaStream_t)stream);
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
