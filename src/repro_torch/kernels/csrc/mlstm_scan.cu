// Chunked mLSTM scan for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel kernels/mlstm_scan.py · mlstm_scan_fwd (body
// _kernel) of the reference package, and computes what its blocked form
// ops._mlstm_chunked_jnp computes: over folded heads bh, q, k [bh, s, dk] and
// v [bh, s, dv] (f32 or bf16), gates i, f [bh, s] (f32), an f32 state
// (C [dk, dv], n [dk], m) carried across chunks of c positions. Per chunk,
// with g = cumsum(log_sigmoid(f)):
//   m_t   = max(m + g_t, max_{u<=t} (g_t - g_u + i_u))
//   w_tu  = exp(g_t - g_u + i_u - m_t) for u <= t, else 0
//   out_t = (e_t q_t C + sum_u (q_t.k_u) w_tu v_u)
//           / max(|e_t q_t.n + sum_u (q_t.k_u) w_tu|, exp(-m_t)),
//           e_t = exp(m + g_t - m_t), q pre-scaled by 1/sqrt(dk)
//   C    <- e_c C + sum_u k_u a_u v_u, n <- e_c n + sum_u k_u a_u,
//   m    <- m_c, with a_u = w_(c-1)u and e_c = e_(c-1).
//
// Bound on this card: operations. At xlstm-1.3b's serving shape (32 folded
// heads x 256 positions, dk = dv = 1024, chunk 128) the function needs 38.7
// GFLOP of f32 arithmetic (0.58 ms at 67 TFLOP/s) against 336 MB of bytes
// (0.10 ms at 3.35 TB/s); nine tenths of the operations are q C and the C
// update, whose [dk, dv] operand is the f32 state. The bf16 body runs them
// on the tensor cores, where at their rate the bytes would bound it; the
// yardstick stays the function's f32 arithmetic, as the reference computes
// it.
//
// Design. The stabiliser chain m depends only on the gates and m0, never on
// C or n, so everything but the state products is a function of one chunk's
// inputs and the scalar m entering it. Two kernels:
//   1. pass 1, grid (row tile of 32, chunk, folded head): every block runs
//      the m chain over the earlier chunks from the gates alone (a parallel
//      scan for g, a block max per chunk), then its chunk's m_t, e_t, a_u
//      and decay, and its 32 rows of the weighted scores
//      sw = (q k^T) o w (u <= t) with their row sums. The last row tile also
//      writes the per-position vectors and sum_u k_u a_u. All of it goes to
//      a scratch record per (head, chunk) that the wrapper allocates (4.6 MB
//      at the serving shape, L2-resident). q k^T is computed once per (head,
//      chunk): 2.1 of the 38.7 GFLOP.
//   2. pass 2, grid (32-column tile of dv, folded head): a block keeps its
//      [dk, 32] tile of C (128 KB at dk = 1024) and n in shared memory and
//      loops over the chunks, one block of 8 warps an SM (the tile and the
//      staging ring fill the SM's shared memory; a 16-column tile would
//      let two blocks in but read every q and k from L2 twice as often,
//      so the ring keeps the next tiles in flight instead): (A) q C and
//      q.n, (B) the output tile e_t qC + sw v over the record's scores,
//      (C) C <- decay C + k^T (a v).
// Two bodies each, chosen by the input: bf16 with dk % 8 == 0 (the serving
// path) on the tensor cores (mlstm_chunk_tc_kernel, mlstm_state_tc_kernel,
// below), everything else on the CUDA cores in f32 (mlstm_chunk_kernel,
// mlstm_state_kernel: 4 x 4 register tiles, slices of q, k and the scores
// fetched into registers one ahead). The launch reports which ran.
// IEEE math throughout (no fast-math intrinsics): padded steps rely on
// log_sigmoid(1e4) == 0 and exp(-1e30 - m) == 0, a fresh state on
// m = -1e30, and a row that saw only padding on exp(1e30) = inf in the
// denominator, which gives out = 0. No atomics: every sum has one order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tile.cuh"

#define ML_F32 0
#define ML_BF16 1
#define ML_THREADS 256
#define ML_CMAX 128              // longest chunk
#define ML_RT 32                 // score rows of a pass-1 block
#define ML_KS 32                 // slice of dk (or of positions) staged
#define ML_BP (ML_CMAX + 4)      // row stride of a staged slice
#define ML_TV 32                 // dv columns a pass-2 block owns
#define ML_KB 128                // dk rows of one pass of the C update
#define ML_DKMAX 1024            // widest dk: its state tile fits a block
#define ML_SMEM_MAX 232448       // a block's shared memory on sm_90

struct MlArgs {
    const void* q;               // [bh, s, dk]
    const void* k;               // [bh, s, dk]
    const void* v;               // [bh, s, dv]
    const float* ig;             // [bh, s]
    const float* fg;             // [bh, s]
    const float* C0;             // [bh, dk, dv]
    const float* n0;             // [bh, dk]
    const float* m0;             // [bh]
    void* out;                   // [bh, s, dv], dtype of v
    float* C;                    // [bh, dk, dv]
    float* n;                    // [bh, dk]
    float* m;                    // [bh]
    float* work;                 // [bh, s / chunk] records (ml_rec)
    int bh, s, dk, dv, chunk;
    float scale;                 // 1 / sqrt(dk)
};

// The scratch record of one (folded head, chunk), offsets in floats.
struct MlRec {
    size_t sw;                   // [c, cw] weighted scores, 0 above u = t
    int cw;                      // sw's row stride: c rounded up to 4
    size_t mt;                   // [c] stabiliser m_t
    size_t e;                    // [c] exp(m + g_t - m_t)
    size_t qnr;                  // [c] row sums of sw
    size_t a;                    // [c] a_u of the state update
    size_t dec;                  // decay e_(c-1)
    size_t kas;                  // [dk] sum_u k_u a_u
    size_t size;
};

__host__ __device__ inline size_t ml_up4(size_t n) { return (n + 3) & ~(size_t)3; }

__host__ __device__ inline MlRec ml_rec(int c, int dk) {
    MlRec r;
    size_t o = 0;
    r.cw = (int)ml_up4(c);
    r.sw = o; o = ml_up4(o + (size_t)c * r.cw);
    r.mt = o; o += c;
    r.e = o; o += c;
    r.qnr = o; o += c;
    r.a = o; o += c;
    r.dec = o; o = ml_up4(o + 1);
    r.kas = o; o = ml_up4(o + dk);
    r.size = o;
    return r;
}

// The stored element type of q, k, v, and its value in f32.
template <bool BF> struct MlElem { typedef float T; };
template <> struct MlElem<true> { typedef unsigned short T; };

template <bool BF>
__device__ __forceinline__ float ml_f(typename MlElem<BF>::T x) {
    if constexpr (BF) return __uint_as_float((unsigned)x << 16);
    else return x;
}

__device__ __forceinline__ void ml_store(void* p, size_t i, bool bf, float x) {
    if (bf) ((__nv_bfloat16*)p)[i] = __float2bfloat16_rn(x);
    else ((float*)p)[i] = x;
}

// log_sigmoid as the reference computes it: min(x, 0) - log1p(exp(-|x|));
// exactly 0 at x = 1e4 (a padded step's forget gate)
__device__ __forceinline__ float ml_log_sigmoid(float x) {
    return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// g_s = cumsum(log_sigmoid(f)) and i_s over the chunk's c positions from
// flat row `row`: a scan within each warp, then the earlier warps' totals.
__device__ __forceinline__ void ml_gates(const MlArgs& a, size_t row, int c,
                                         float* g_s, float* i_s,
                                         float* tot_s) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    float x = (tid < c) ? ml_log_sigmoid(a.fg[row + tid]) : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) tot_s[warp] = x;
    __syncthreads();
    float p = 0.f;
    for (int w = 0; w < warp; ++w) p += tot_s[w];
    if (tid < c) {
        g_s[tid] = x + p;
        i_s[tid] = a.ig[row + tid];
    }
    __syncthreads();
}

__device__ __forceinline__ float ml_block_max(float x, float* red_s) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    if (lane == 0) red_s[warp] = x;
    __syncthreads();
    float r = red_s[0];
    for (int w = 1; w < ML_THREADS / 32; ++w) r = fmaxf(r, red_s[w]);
    __syncthreads();
    return r;
}

// Every global load below is unconditional, from an index clamped to a
// valid one (the chunk's first element) where the element lies outside the
// shape; the value is masked after it arrives. A thread so keeps all its
// loads of a slice in flight at once, where a load guarded by a branch and
// used inside it would wait for each in turn.

// ---- pass 1: what does not depend on the state, once per (head, chunk)
//
// Grid (row tile of ML_RT, chunk, folded head). A block's shared vectors:
struct MlGates {
    float g[ML_CMAX], i[ML_CMAX], mt[ML_CMAX], a[ML_CMAX];
    float red[ML_THREADS / 32];
};

// The m chain over the chunks before ci (gates only), then chunk ci's g,
// i, m_t and a_u into G; the block of the last row tile also writes the
// record's m_t, e_t, a_u and decay, and m after the last chunk.
__device__ __forceinline__ void ml_chunk_gates(const MlArgs& a, MlGates& G,
                                               float* rec, const MlRec& R,
                                               bool last) {
    const int tid = threadIdx.x;
    const int ci = blockIdx.y, bi = blockIdx.z;
    const int c = a.chunk, nc = a.s / c;
    float m = a.m0[bi];
    for (int j = 0; j < ci; ++j) {
        ml_gates(a, (size_t)bi * a.s + (size_t)j * c, c, G.g, G.i, G.red);
        const float ge = G.g[c - 1];
        float x = (tid < c) ? (ge - G.g[tid]) + G.i[tid] : -INFINITY;
        x = ml_block_max(x, G.red);
        m = fmaxf(m + ge, x);
    }
    ml_gates(a, (size_t)bi * a.s + (size_t)ci * c, c, G.g, G.i, G.red);
    const float m_prev = m;
    if (tid < c) {
        const float gt = G.g[tid];
        float mi = -1e30f;
        for (int u = 0; u <= tid; ++u)
            mi = fmaxf(mi, (gt - G.g[u]) + G.i[u]);
        G.mt[tid] = fmaxf(m_prev + gt, mi);
    }
    __syncthreads();
    const float ge = G.g[c - 1], mn = G.mt[c - 1];
    if (tid < c) {
        const float au = expf(((ge - G.g[tid]) + G.i[tid]) - mn);
        G.a[tid] = au;
        if (last) {
            rec[R.mt + tid] = G.mt[tid];
            rec[R.e + tid] = expf((m_prev + G.g[tid]) - G.mt[tid]);
            rec[R.a + tid] = au;
        }
    }
    if (last && tid == 0) {
        rec[R.dec] = expf((m_prev + ge) - mn);
        if (ci == nc - 1) a.m[bi] = mn;
    }
    __syncthreads();
}

// sc_s holds the block's scaled scores q k^T (rows r0.., columns < c):
// weight them (u <= t), write them and their row sums to the record.
__device__ __forceinline__ void ml_chunk_weights(const MlArgs& a,
                                                 const MlGates& G,
                                                 float (*sc_s)[ML_CMAX + 1],
                                                 float* rec, const MlRec& R,
                                                 int r0) {
    const int tid = threadIdx.x, c = a.chunk;
    for (int idx = tid; idx < ML_RT * ML_CMAX; idx += ML_THREADS) {
        const int tl = idx >> 7, u = idx & (ML_CMAX - 1), t = r0 + tl;
        if (t >= c || u >= R.cw) continue;
        float x = 0.f;                         // zeros past c pad the row
        if (u <= t)
            x = sc_s[tl][u] * expf(((G.g[t] - G.g[u]) + G.i[u]) - G.mt[t]);
        rec[R.sw + (size_t)t * R.cw + u] = x;
        if (u < c) sc_s[tl][u] = x;
    }
    __syncthreads();
    if (tid < ML_RT && r0 + tid < c) {
        float x = 0.f;
        for (int u = 0; u < c; ++u) x += sc_s[tid][u];
        rec[R.qnr + r0 + tid] = x;
    }
}

// The CUDA-core body: scores in 4 x 4 register tiles (rows 4 ty + i,
// columns tx + 32 j), dk in slices fetched one ahead; the last tile also
// sums k a (warp w over positions 16 w.., in order).
template <bool BF>
__global__ void __launch_bounds__(ML_THREADS)
mlstm_chunk_kernel(MlArgs a) {
    typedef typename MlElem<BF>::T T;
    constexpr int NQ = ML_RT * ML_KS / ML_THREADS;     // 4 q loads a thread
    constexpr int NK = ML_CMAX * ML_KS / ML_THREADS;   // 16 k loads
    __shared__ MlGates G;
    __shared__ __align__(16) float q_s[ML_KS][ML_RT + 4];   // [k][t]
    __shared__ __align__(16) float k_s[ML_KS][ML_BP];       // [k][u]
    __shared__ float sc_s[ML_RT][ML_CMAX + 1];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int r0 = blockIdx.x * ML_RT, ci = blockIdx.y, bi = blockIdx.z;
    const int c = a.chunk, dk = a.dk, nc = a.s / c;
    const bool last = blockIdx.x == gridDim.x - 1;
    const MlRec R = ml_rec(c, dk);
    float* rec = a.work + ((size_t)bi * nc + ci) * R.size;
    const size_t row0 = (size_t)bi * a.s + (size_t)ci * c;
    const T* Q = (const T*)a.q;
    const T* Kp = (const T*)a.k;
    ml_chunk_gates(a, G, rec, R, last);

    const int ucount = min(c, r0 + ML_RT);     // columns any row here sees
    const int ty = warp, tx = lane;
    T qp[NQ], kp[NK];
    auto fetch = [&](int k0) {
        const bool col = k0 + lane < dk;
#pragma unroll
        for (int r = 0; r < NQ; ++r) {
            const int t = r0 + warp + 8 * r;
            qp[r] = Q[(col && t < c) ? (row0 + t) * dk + k0 + lane : row0 * dk];
        }
#pragma unroll
        for (int r = 0; r < NK; ++r) {
            const int u = warp + 8 * r;
            kp[r] = Kp[(col && u < ucount) ? (row0 + u) * dk + k0 + lane
                                           : row0 * dk];
        }
    };
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    fetch(0);
    for (int k0 = 0; k0 < dk; k0 += ML_KS) {
        const bool col = k0 + lane < dk;
        __syncthreads();                       // the last slice is consumed
        if (last && k0 > 0 && tid < ML_KS) {
            // k a summed over the previous slice's positions, warps in order
            float x = 0.f;
            for (int w = 0; w < ML_THREADS / 32; ++w) x += sc_s[w][tid];
            rec[R.kas + k0 - ML_KS + tid] = x;
        }
#pragma unroll
        for (int r = 0; r < NQ; ++r) {
            const int t = warp + 8 * r;
            q_s[lane][t] = (col && r0 + t < c) ? ml_f<BF>(qp[r]) * a.scale
                                               : 0.f;
        }
#pragma unroll
        for (int r = 0; r < NK; ++r) {
            const int u = warp + 8 * r;
            k_s[lane][u] = (col && u < ucount) ? ml_f<BF>(kp[r]) : 0.f;
        }
        __syncthreads();
        if (k0 + ML_KS < dk) fetch(k0 + ML_KS);
#pragma unroll 8
        for (int kk = 0; kk < ML_KS; ++kk) {
            const float4 qa = *(const float4*)&q_s[kk][4 * ty];
            const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
            float kb[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) kb[j] = k_s[kk][tx + 32 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = fmaf(qv[i], kb[j], acc[i][j]);
        }
        if (last) {
            // this warp's 16 positions of column k0 + lane; the partial
            // waits in sc_s (free until the scores) for the next barrier
            float x = 0.f;
            for (int u = 16 * warp; u < min(c, 16 * warp + 16); ++u)
                x = fmaf(k_s[lane][u], G.a[u], x);
            sc_s[warp][lane] = x;
        }
    }
    __syncthreads();
    if (last && tid < ML_KS) {
        const int k0 = (dk - 1) / ML_KS * ML_KS;
        float x = 0.f;
        for (int w = 0; w < ML_THREADS / 32; ++w) x += sc_s[w][tid];
        if (k0 + tid < dk) rec[R.kas + k0 + tid] = x;
    }
    __syncthreads();                           // sc_s is free again
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc_s[4 * ty + i][tx + 32 * j] = acc[i][j];
    __syncthreads();
    ml_chunk_weights(a, G, sc_s, rec, R, r0);
}

// The tensor-core body (bf16, dk % 8 == 0): the block's 32 rows of q and
// the chunk's k rows staged as bf16 tiles of 32 columns of dk with
// cp.async, two in flight; a warp owns 16 rows x 32 columns of the scores
// (mma.sync m16n8k16, f32 accumulators: products of bf16 values are exact),
// scaled by 1/sqrt(dk) after the product.
#define ML_PTS 32                // dk columns of a pass-1 tile
#define ML_PLD MT_LD(ML_PTS)     // its row stride (bf16)
__global__ void __launch_bounds__(ML_THREADS)
mlstm_chunk_tc_kernel(MlArgs a) {
    __shared__ MlGates G;
    __shared__ __align__(16) __nv_bfloat16 qt_s[2][ML_RT][ML_PLD];
    __shared__ __align__(16) __nv_bfloat16 kt_s[2][ML_CMAX][ML_PLD];
    __shared__ float sc_s[ML_RT][ML_CMAX + 1];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int r0 = blockIdx.x * ML_RT, ci = blockIdx.y, bi = blockIdx.z;
    const int c = a.chunk, dk = a.dk, nc = a.s / c;
    const bool last = blockIdx.x == gridDim.x - 1;
    const MlRec R = ml_rec(c, dk);
    float* rec = a.work + ((size_t)bi * nc + ci) * R.size;
    const size_t row0 = (size_t)bi * a.s + (size_t)ci * c;
    const __nv_bfloat16* Q = (const __nv_bfloat16*)a.q;
    const __nv_bfloat16* Kp = (const __nv_bfloat16*)a.k;
    const int ucount = min(c, r0 + ML_RT);     // columns any row here sees

    // tile j: q rows r0.. and k rows 0..ucount-1, columns 32 j.. (zeros
    // past the rows and dk)
    auto stage = [&](int j) {
        const int c0 = j * ML_PTS, b = j & 1;
        for (int i = tid; i < (ML_RT + ML_CMAX) * (ML_PTS / 8);
             i += ML_THREADS) {
            const int row = i >> 2, cc = (i & 3) << 3;
            const bool qrow = row < ML_RT;
            const int r = qrow ? row : row - ML_RT;
            const bool on = (qrow ? r0 + r < c : r < ucount) && c0 + cc < dk;
            const size_t src = (qrow ? row0 + r0 + r : row0 + r) * dk + c0
                             + cc;
            __nv_bfloat16* dst = qrow ? &qt_s[b][r][cc] : &kt_s[b][r][cc];
            mt_cp16(dst, (qrow ? Q : Kp) + (on ? src : row0 * dk), on);
        }
        mt_cp_commit();
    };
    stage(0);                                  // in flight over the gates
    ml_chunk_gates(a, G, rec, R, last);

    const int mi = warp & 1, nq = warp >> 1;   // rows 16 mi.., cols 32 nq..
    const bool live = 32 * nq < ucount;
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[j][x] = 0.f;
    const int nt = (dk + ML_PTS - 1) / ML_PTS;
    for (int j = 0; j < nt; ++j) {
        if (j + 1 < nt) {
            stage(j + 1);
            mt_cp_wait<1>();
        } else {
            mt_cp_wait<0>();
        }
        __syncthreads();                       // tile j is in
        const int b = j & 1;
        if (live) {
#pragma unroll
            for (int ks = 0; ks < ML_PTS / 16; ++ks) {
                uint32_t af[4], bf[4];
                mt_frag_a(af, &qt_s[b][0][0], ML_PLD, 16 * mi, 16 * ks,
                          lane);
#pragma unroll
                for (int n2 = 0; n2 < 2; ++n2) {
                    mt_frag_b(bf, &kt_s[b][0][0], ML_PLD, 32 * nq + 16 * n2,
                              16 * ks, lane);
                    mt_mma(acc[2 * n2], af, bf);
                    mt_mma(acc[2 * n2 + 1], af, bf + 2);
                }
            }
        }
        if (last) {
            // sum_u k a of the tile's 32 columns: warp w over positions
            // 16 w.., the partials reduced in order after the loop
            float x = 0.f;
            for (int u = 16 * warp; u < min(c, 16 * warp + 16); ++u)
                x = fmaf(__bfloat162float(kt_s[b][u][lane]), G.a[u], x);
            sc_s[warp][lane] = x;
        }
        __syncthreads();                       // tile j is consumed
        if (last && tid < ML_PTS && j * ML_PTS + tid < dk) {
            float x = 0.f;
            for (int w = 0; w < ML_THREADS / 32; ++w) x += sc_s[w][tid];
            rec[R.kas + j * ML_PTS + tid] = x;
        }
        __syncthreads();
    }
    // scores: C fragment rows 16 mi + g (+ 8), columns 32 nq + 8 j + 2 t
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int u = 32 * nq + 8 * j + 2 * t4;
        sc_s[16 * mi + g][u] = acc[j][0] * a.scale;
        sc_s[16 * mi + g][u + 1] = acc[j][1] * a.scale;
        sc_s[16 * mi + g + 8][u] = acc[j][2] * a.scale;
        sc_s[16 * mi + g + 8][u + 1] = acc[j][3] * a.scale;
    }
    __syncthreads();
    ml_chunk_weights(a, G, sc_s, rec, R, r0);
}

// Shared memory of pass 2, in floats: C tile [DKP][TV], n [DKP], a staged
// slice [KS][BP], the v tile [CMAX][TV], four per-position vectors.
__host__ __device__ inline int ml_dkp(int dk) {
    return (dk + ML_KB - 1) / ML_KB * ML_KB;
}

static size_t ml_state_floats(int dk) {
    const size_t dkp = ml_dkp(dk);
    return dkp * ML_TV + dkp + (size_t)ML_KS * ML_BP
         + (size_t)ML_CMAX * ML_TV + 4 * ML_CMAX;
}

// ---- pass 2: the state, one [dk, 32] column tile of C a block
template <bool BF>
__global__ void __launch_bounds__(ML_THREADS, 1)
mlstm_state_kernel(MlArgs a) {
    typedef typename MlElem<BF>::T T;
    constexpr int NPRE = ML_KS * ML_CMAX / ML_THREADS;   // 16 loads a slice
    extern __shared__ float4 smem4[];
    float* smem = (float*)smem4;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int ty = tid >> 3, tx = tid & 7;     // register tile owner
    const int v0 = blockIdx.x * ML_TV, bi = blockIdx.y;
    const int dk = a.dk, dv = a.dv, c = a.chunk, nc = a.s / c;
    const int nv = min(ML_TV, dv - v0);        // live columns of the tile
    const int dkp = ml_dkp(dk);
    const MlRec R = ml_rec(c, dk);
    const T* Q = (const T*)a.q;
    const T* Kp = (const T*)a.k;
    const T* V = (const T*)a.v;

    float* C_s = smem;                         // [dkp][TV]
    float* n_s = C_s + (size_t)dkp * ML_TV;    // [dkp]
    float* b_s = n_s + dkp;                    // [KS][BP] staged slice
    float* v_s = b_s + ML_KS * ML_BP;          // [CMAX][TV]
    float* e_s = v_s + ML_CMAX * ML_TV;        // exp(m + g_t - m_t)
    float* mt_s = e_s + ML_CMAX;               // m_t
    float* qnr_s = mt_s + ML_CMAX;             // row sums of sw
    float* a_s = qnr_s + ML_CMAX;              // a_u

    // ---- the carried state's tile: rows kk = warp + 8 r, column lane
    const size_t cbase = (size_t)bi * dk * dv;
    for (int k0 = 0; k0 < dkp; k0 += 8 * NPRE) {
        float x[NPRE];
#pragma unroll
        for (int r = 0; r < NPRE; ++r) {
            const int kk = k0 + warp + 8 * r;
            x[r] = a.C0[(kk < dk && lane < nv)
                        ? cbase + (size_t)kk * dv + v0 + lane : cbase];
        }
#pragma unroll
        for (int r = 0; r < NPRE; ++r) {
            const int kk = k0 + warp + 8 * r;
            if (kk < dkp) C_s[kk * ML_TV + lane] =
                (kk < dk && lane < nv) ? x[r] : 0.f;
        }
    }
    for (int kk = tid; kk < dkp; kk += ML_THREADS)
        n_s[kk] = (kk < dk) ? a.n0[(size_t)bi * dk + kk] : 0.f;

    T pre[NPRE];
    float prf[NPRE];
    for (int ci = 0; ci < nc; ++ci) {
        const float* rec = a.work + ((size_t)bi * nc + ci) * R.size;
        const size_t row0 = (size_t)bi * a.s + (size_t)ci * c;
        const size_t zero = row0 * dk;         // a valid index of q and k

        // ---- the chunk's v tile and per-position vectors
        T vp[NPRE];
#pragma unroll
        for (int r = 0; r < NPRE; ++r) {
            const int u = warp + 8 * r;
            vp[r] = V[(u < c && lane < nv) ? (row0 + u) * dv + v0 + lane
                                           : row0 * dv];
        }
        // e, m_t, row sums, a: entry j = tid + 256 r of e_s..a_s
        float vec[4 * ML_CMAX / ML_THREADS];
#pragma unroll
        for (int r = 0; r < 4 * ML_CMAX / ML_THREADS; ++r) {
            const int j = tid + ML_THREADS * r, t = j & (ML_CMAX - 1);
            const int w = j >> 7;
            const size_t off = w == 0 ? R.e : w == 1 ? R.mt : w == 2 ? R.qnr
                                                                     : R.a;
            vec[r] = rec[off + (t < c ? t : 0)];
        }
        const float decay = rec[R.dec];
        __syncthreads();                       // the last chunk is done
#pragma unroll
        for (int r = 0; r < NPRE; ++r) {
            const int u = warp + 8 * r;
            v_s[u * ML_TV + lane] = (u < c && lane < nv) ? ml_f<BF>(vp[r])
                                                         : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4 * ML_CMAX / ML_THREADS; ++r) {
            const int j = tid + ML_THREADS * r;
            e_s[j] = ((j & (ML_CMAX - 1)) < c) ? vec[r] : 0.f;
        }

        // ---- (A) q C and q.n, q pre-scaled, dk in slices of KS:
        // b_s[kk][t] = q[t][k0 + kk], rows t = warp + 8 r, kk = lane
        auto fetch_q = [&](int k0) {
            const bool col = k0 + lane < dk;
#pragma unroll
            for (int r = 0; r < NPRE; ++r) {
                const int t = warp + 8 * r;
                pre[r] = Q[(col && t < c) ? (row0 + t) * dk + k0 + lane
                                          : zero];
            }
        };
        float acc[4][4], qn[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            qn[i] = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        }
        fetch_q(0);
        for (int k0 = 0; k0 < dk; k0 += ML_KS) {
            const bool col = k0 + lane < dk;
            __syncthreads();                   // b_s is free
#pragma unroll
            for (int r = 0; r < NPRE; ++r) {
                const int t = warp + 8 * r;
                b_s[lane * ML_BP + t] = (col && t < c)
                    ? ml_f<BF>(pre[r]) * a.scale : 0.f;
            }
            __syncthreads();
            if (k0 + ML_KS < dk) fetch_q(k0 + ML_KS);
#pragma unroll 8
            for (int kk = 0; kk < ML_KS; ++kk) {
                const float4 qa = *(const float4*)&b_s[kk * ML_BP + 4 * ty];
                const float4 cb =
                    *(const float4*)&C_s[(k0 + kk) * ML_TV + 4 * tx];
                const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
                const float cv[4] = {cb.x, cb.y, cb.z, cb.w};
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        acc[i][j] = fmaf(qv[i], cv[j], acc[i][j]);
            }
            // q.n: the 8 threads of a row tile share the slice's columns
#pragma unroll
            for (int j = 0; j < ML_KS / 8; ++j) {
                const int kk = tx + 8 * j;
                const float nk = n_s[k0 + kk];
                const float4 qa = *(const float4*)&b_s[kk * ML_BP + 4 * ty];
                qn[0] = fmaf(qa.x, nk, qn[0]);
                qn[1] = fmaf(qa.y, nk, qn[1]);
                qn[2] = fmaf(qa.z, nk, qn[2]);
                qn[3] = fmaf(qa.w, nk, qn[3]);
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int o = 1; o < 8; o <<= 1)
                qn[i] += __shfl_xor_sync(0xffffffffu, qn[i], o);
            const float e = e_s[4 * ty + i];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] *= e;
        }

        // ---- (B) + sw v over the record's scores, positions in slices:
        // b_s[uu][t] = sw[t][u0 + uu], rows t = warp + 8 r, uu = lane
        auto fetch_sw = [&](int u0) {
            const bool col = u0 + lane < c;
#pragma unroll
            for (int r = 0; r < NPRE; ++r) {
                const int t = warp + 8 * r;
                prf[r] = rec[R.sw + ((col && t < c)
                                     ? (size_t)t * R.cw + u0 + lane : 0)];
            }
        };
        fetch_sw(0);
        for (int u0 = 0; u0 < c; u0 += ML_KS) {
            const bool col = u0 + lane < c;
            __syncthreads();
#pragma unroll
            for (int r = 0; r < NPRE; ++r) {
                const int t = warp + 8 * r;
                b_s[lane * ML_BP + t] = (col && t < c) ? prf[r] : 0.f;
            }
            __syncthreads();
            if (u0 + ML_KS < c) fetch_sw(u0 + ML_KS);
#pragma unroll 8
            for (int uu = 0; uu < ML_KS; ++uu) {
                const float4 sa = *(const float4*)&b_s[uu * ML_BP + 4 * ty];
                const float4 vb =
                    *(const float4*)&v_s[(u0 + uu) * ML_TV + 4 * tx];
                const float sv[4] = {sa.x, sa.y, sa.z, sa.w};
                const float vv[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        acc[i][j] = fmaf(sv[i], vv[j], acc[i][j]);
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int t = 4 * ty + i;
            if (t >= c) continue;
            const float qnt = e_s[t] * qn[i] + qnr_s[t];
            const float den = fmaxf(fabsf(qnt), expf(-mt_s[t]));
            const size_t ob = (row0 + t) * dv + v0;
#pragma unroll
            for (int j = 0; j < 4; ++j)
                if (4 * tx + j < nv)
                    ml_store(a.out, ob + 4 * tx + j, BF, acc[i][j] / den);
        }

        // ---- (C) C <- decay C + (k a)^T v, in passes of KB rows of dk,
        // positions in slices: b_s[uu][kk] = k[u0 + uu][kb + kk] a_(u0 + uu),
        // positions uu = tid / KB + 2 r, columns kk = tid % KB
        const int nu = (c + ML_KS - 1) / ML_KS;
        const int nslice = (dk + ML_KB - 1) / ML_KB * nu;
        const int kc = tid & (ML_KB - 1), uq = tid >> 7;
        auto fetch_ka = [&](int sl) {
            const int kb = sl / nu * ML_KB, u0 = sl % nu * ML_KS;
            const bool col = kb + kc < dk;
#pragma unroll
            for (int r = 0; r < NPRE; ++r) {
                const int u = u0 + uq + 2 * r;
                pre[r] = Kp[(col && u < c) ? (row0 + u) * dk + kb + kc
                                           : zero];
            }
        };
        float cacc[4][4];
        fetch_ka(0);
        for (int sl = 0; sl < nslice; ++sl) {
            const int kb = sl / nu * ML_KB, u0 = sl % nu * ML_KS;
            const bool col = kb + kc < dk;
            if (u0 == 0) {
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) cacc[i][j] = 0.f;
            }
            __syncthreads();
#pragma unroll
            for (int r = 0; r < NPRE; ++r) {
                const int uu = uq + 2 * r, u = u0 + uu;
                b_s[uu * ML_BP + kc] = (col && u < c)
                    ? ml_f<BF>(pre[r]) * a_s[u] : 0.f;
            }
            __syncthreads();
            if (sl + 1 < nslice) fetch_ka(sl + 1);
#pragma unroll 8
            for (int uu = 0; uu < ML_KS; ++uu) {
                const float4 ka = *(const float4*)&b_s[uu * ML_BP + 4 * ty];
                const float4 vb =
                    *(const float4*)&v_s[(u0 + uu) * ML_TV + 4 * tx];
                const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
                const float vv[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        cacc[i][j] = fmaf(kv[i], vv[j], cacc[i][j]);
            }
            if (u0 + ML_KS >= c) {             // the pass is complete
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    float* cp = &C_s[(kb + 4 * ty + i) * ML_TV + 4 * tx];
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        cp[j] = decay * cp[j] + cacc[i][j];
                }
            }
        }
        for (int kk = tid; kk < dk; kk += ML_THREADS)
            n_s[kk] = decay * n_s[kk] + rec[R.kas + kk];
    }

    __syncthreads();
    for (int idx = tid; idx < dk * ML_TV; idx += ML_THREADS) {
        const int kk = idx / ML_TV, vv = idx - kk * ML_TV;
        if (vv < nv) a.C[cbase + (size_t)kk * dv + v0 + vv] = C_s[idx];
    }
    if (blockIdx.x == 0) {
        for (int kk = tid; kk < dk; kk += ML_THREADS)
            a.n[(size_t)bi * dk + kk] = n_s[kk];
    }
}

// ---- pass 2, bf16 inputs: the state products on the tensor cores
//
// mma.sync m16n8k16 (bf16 in, f32 accumulators) for the three products of a
// chunk, the f32 operand of each split into bf16 hi + lo halves (two
// products on one exact bf16 operand; about 2^-17 of the value is lost):
//   (A) q C:       A = q (bf16, staged with cp.async), B = C hi / lo;
//   (B) sw v:      A = sw hi / lo (the record's f32 scores), B = v (bf16);
//   (C) k^T (a v): A = k^T (bf16, the staged k tile through ldmatrix.trans),
//                  B = (a_u v) hi / lo, split once a chunk.
// 1/sqrt(dk) scales the f32 products q C and q.n (not q: a bf16 q times
// the scale is no longer a bf16 value). q and k tiles of 64 columns of dk
// go through a ring of three buffers: the copies of the next two are in
// flight while the warps multiply on this one. C stays f32 in shared
// memory, its rows XOR-swizzled
// (column bits 3-4 flipped by bits 1-2 of the row) so that the B-fragment
// reads of (A) hit 32 banks.
#define ML_TS 64                 // dk columns of a staged q or k tile
#define ML_SLD MT_LD(ML_TS)      // its row stride (bf16)
#define ML_VLD MT_LD(ML_TV)      // row stride of the bf16 v tiles
#define ML_NST 3                 // staged q / k tiles (or sw slices)
#define ML_WLD 24                // row stride of a staged f32 slice of sw

__host__ __device__ inline int ml_dkp_tc(int dk) {
    return (dk + ML_TS - 1) / ML_TS * ML_TS;
}

__device__ __forceinline__ int ml_cswz(int k, int v) {
    return k * ML_TV + (v ^ (((k >> 1) & 3) << 3));
}

static size_t ml_state_tc_bytes(int dk) {
    const size_t dkp = ml_dkp_tc(dk);
    return (dkp * ML_TV + dkp) * 4                      // C, n
         + (size_t)ML_NST * ML_CMAX * ML_SLD * 2        // q / k tiles
         + (size_t)3 * ML_CMAX * ML_VLD * 2             // v, (a v) hi, lo
         + (size_t)5 * ML_CMAX * 4;                     // per-position
}

// Copies rows 0..127 (zeros from row c on), columns c0..c0+63 (zeros from
// dk on; dk % 8 == 0) of a [.., dk] bf16 matrix from flat row row0 into a
// staged tile [128][ML_SLD], 16 bytes a copy.
__device__ __forceinline__ void ml_stage(__nv_bfloat16* dst,
                                         const __nv_bfloat16* src,
                                         size_t row0, int c, int dk, int c0,
                                         int tid) {
#pragma unroll
    for (int r = 0; r < ML_CMAX * ML_TS / 8 / ML_THREADS; ++r) {
        const int i = tid + ML_THREADS * r;
        const int t = i >> 3, cc = (i & 7) << 3;
        const bool on = t < c && c0 + cc < dk;
        mt_cp16(dst + t * ML_SLD + cc,
                src + (on ? (row0 + t) * dk + c0 + cc : row0 * dk), on);
    }
    mt_cp_commit();
}

// Before tile j of nt is used: issue tile j + 2 into the buffer tile j - 1
// left, then wait until tile j has landed (two later ones may still fly).
__device__ __forceinline__ void ml_wait_tiles(__nv_bfloat16* st_s,
                                              const __nv_bfloat16* src,
                                              size_t row0, int c, int dk,
                                              int j, int nt, int tid) {
    if (j + 2 < nt) {
        ml_stage(st_s + ((j + 2) % ML_NST) * ML_CMAX * ML_SLD, src, row0, c,
                 dk, (j + 2) * ML_TS, tid);
        mt_cp_wait<2>();
    } else if (j + 1 < nt) {
        mt_cp_wait<1>();
    } else {
        mt_cp_wait<0>();
    }
}

__global__ void __launch_bounds__(ML_THREADS, 1)
mlstm_state_tc_kernel(MlArgs a) {
    extern __shared__ float4 smem4[];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;    // fragment row / column pair
    const int v0 = blockIdx.x * ML_TV, bi = blockIdx.y;
    const int dk = a.dk, dv = a.dv, c = a.chunk, nc = a.s / c;
    const int nv = min(ML_TV, dv - v0);
    const int dkp = ml_dkp_tc(dk);
    const MlRec R = ml_rec(c, dk);
    const __nv_bfloat16* Q = (const __nv_bfloat16*)a.q;
    const __nv_bfloat16* Kp = (const __nv_bfloat16*)a.k;
    const unsigned short* V = (const unsigned short*)a.v;

    float* C_s = (float*)smem4;                          // [dkp][TV], swz
    float* n_s = C_s + (size_t)dkp * ML_TV;              // [dkp]
    __nv_bfloat16* st_s = (__nv_bfloat16*)(n_s + dkp);   // [NST][128][SLD]
    __nv_bfloat16* vb_s = st_s + ML_NST * ML_CMAX * ML_SLD;   // [128][VLD]
    __nv_bfloat16* vh_s = vb_s + ML_CMAX * ML_VLD;       // (a v) hi
    __nv_bfloat16* vl_s = vh_s + ML_CMAX * ML_VLD;       // (a v) lo
    float* e_s = (float*)(vl_s + ML_CMAX * ML_VLD);      // e_t
    float* mt_s = e_s + ML_CMAX;                         // m_t
    float* qnr_s = mt_s + ML_CMAX;                       // row sums of sw
    float* a_s = qnr_s + ML_CMAX;                        // a_u
    float* qn_s = a_s + ML_CMAX;                         // q_t . n

    // ---- the carried state's tile, copied in 16-byte pieces (rows of dv
    // floats 16-byte aligned), or rows kk = warp + 8 r, column lane
    const size_t cbase = (size_t)bi * dk * dv;
    const bool cvec = dv % 4 == 0 && ((uintptr_t)a.C0 & 15) == 0
                   && ((uintptr_t)a.C & 15) == 0;
    if (cvec) {
        for (int i = tid; i < dkp * (ML_TV / 4); i += ML_THREADS) {
            const int kk = i >> 3, cc = (i & 7) << 2;
            const bool on = kk < dk && cc < nv;
            mt_cp16(C_s + ml_cswz(kk, cc),
                    a.C0 + (on ? cbase + (size_t)kk * dv + v0 + cc : cbase),
                    on);
        }
        mt_cp_commit();                        // waited for with q tile 0
    } else {
        for (int k0 = 0; k0 < dkp; k0 += 128) {
            float x[16];
#pragma unroll
            for (int r = 0; r < 16; ++r) {
                const int kk = k0 + warp + 8 * r;
                x[r] = a.C0[(kk < dk && lane < nv)
                            ? cbase + (size_t)kk * dv + v0 + lane : cbase];
            }
#pragma unroll
            for (int r = 0; r < 16; ++r) {
                const int kk = k0 + warp + 8 * r;
                if (kk < dkp)
                    C_s[ml_cswz(kk, lane)] =
                        (kk < dk && lane < nv) ? x[r] : 0.f;
            }
        }
    }
    for (int kk = tid; kk < dkp; kk += ML_THREADS)
        n_s[kk] = (kk < dk) ? a.n0[(size_t)bi * dk + kk] : 0.f;

    // a chunk's v tile (rows u = warp + 8 r, column lane), per-position
    // vectors and decay, fetched a chunk ahead
    unsigned short vp[16];
    float vec[4 * ML_CMAX / ML_THREADS], dec_next = 0.f;
    auto fetch_v = [&](int ci) {
        const float* rec = a.work + ((size_t)bi * nc + ci) * R.size;
        const size_t row0 = (size_t)bi * a.s + (size_t)ci * c;
#pragma unroll
        for (int r = 0; r < 16; ++r) {
            const int u = warp + 8 * r;
            vp[r] = V[(u < c && lane < nv) ? (row0 + u) * dv + v0 + lane
                                           : row0 * dv];
        }
#pragma unroll
        for (int r = 0; r < 4 * ML_CMAX / ML_THREADS; ++r) {
            const int j = tid + ML_THREADS * r, t = j & (ML_CMAX - 1);
            const int w = j >> 7;
            const size_t off = w == 0 ? R.e : w == 1 ? R.mt : w == 2 ? R.qnr
                                                                     : R.a;
            vec[r] = rec[off + (t < c ? t : 0)];
        }
        dec_next = rec[R.dec];
    };
    fetch_v(0);

    // warp tiles: (A), (B) rows 64 wm + 16 mi.. (mi < 4), columns 8 wn..;
    // (C) rows 16 (warp & 3).. of a staged k tile, columns 16 (warp >> 2)..
    const int wm = warp >> 2, wn = warp & 3;
    for (int ci = 0; ci < nc; ++ci) {
        const float* rec = a.work + ((size_t)bi * nc + ci) * R.size;
        const size_t row0 = (size_t)bi * a.s + (size_t)ci * c;
        const int nt = dkp / ML_TS;
        __syncthreads();                       // the last chunk is done
        ml_stage(st_s, Q, row0, c, dk, 0, tid);   // q tiles 0, 1 in flight
        if (nt > 1)
            ml_stage(st_s + ML_CMAX * ML_SLD, Q, row0, c, dk, ML_TS, tid);

        // ---- v, (a v) hi / lo, the per-position vectors
#pragma unroll
        for (int r = 0; r < 4 * ML_CMAX / ML_THREADS; ++r) {
            const int j = tid + ML_THREADS * r;
            e_s[j] = ((j & (ML_CMAX - 1)) < c) ? vec[r] : 0.f;   // .. a_s
        }
        const float decay = dec_next;
        __syncthreads();                       // a_s is in
#pragma unroll
        for (int r = 0; r < 16; ++r) {
            const int u = warp + 8 * r;
            const bool on = u < c && lane < nv;
            const float x = on ? __uint_as_float((unsigned)vp[r] << 16) : 0.f;
            const float av = x * a_s[u];
            const __nv_bfloat16 h = __float2bfloat16_rn(av);
            vb_s[u * ML_VLD + lane] = __float2bfloat16_rn(x);
            vh_s[u * ML_VLD + lane] = h;
            vl_s[u * ML_VLD + lane] =
                __float2bfloat16_rn(av - __bfloat162float(h));
        }
        if (ci + 1 < nc) fetch_v(ci + 1);      // in flight over this chunk

        // ---- (A) q C (unscaled) on the tensor cores, q.n on CUDA cores
        float acc[4][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[mi][j] = 0.f;
        float qn = 0.f;                        // row tid / 2, half tid % 2
        for (int j = 0; j < nt; ++j) {
            const int k0 = j * ML_TS;
            ml_wait_tiles(st_s, Q, row0, c, dk, j, nt, tid);
            __syncthreads();                   // tile j (and v, a v) in
            const __nv_bfloat16* qt = st_s + (j % ML_NST) * ML_CMAX * ML_SLD;
#pragma unroll
            for (int ks = 0; ks < ML_TS / 16; ++ks) {
                const int kr = k0 + 16 * ks + 2 * t4, n = 8 * wn + g;
                uint32_t bh[2], bl[2];
                mt_split(C_s[ml_cswz(kr, n)], C_s[ml_cswz(kr + 1, n)],
                         bh[0], bl[0]);
                mt_split(C_s[ml_cswz(kr + 8, n)], C_s[ml_cswz(kr + 9, n)],
                         bh[1], bl[1]);
#pragma unroll
                for (int mi = 0; mi < 4; ++mi) {
                    uint32_t af[4];
                    mt_frag_a(af, qt, ML_SLD, 64 * wm + 16 * mi, 16 * ks,
                              lane);
                    mt_mma(acc[mi], af, bh);
                    mt_mma(acc[mi], af, bl);
                }
            }
            {
                const __nv_bfloat16* qr = qt + (tid >> 1) * ML_SLD
                                        + 32 * (tid & 1);
                const float* nr = n_s + k0 + 32 * (tid & 1);
#pragma unroll 8
                for (int kk = 0; kk < 32; kk += 2) {
                    const float2 qq = __bfloat1622float2(
                        *(const __nv_bfloat162*)(qr + kk));
                    qn = fmaf(qq.x, nr[kk], qn);
                    qn = fmaf(qq.y, nr[kk + 1], qn);
                }
            }
            __syncthreads();                   // tile j is consumed
        }
        qn += __shfl_xor_sync(0xffffffffu, qn, 1);
        if ((tid & 1) == 0) qn_s[tid >> 1] = qn * a.scale;
        // num = e_t (q C) scale: rows 64 wm + 16 mi + g (+ 8)
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
            const int r = 64 * wm + 16 * mi + g;
            const float e0 = e_s[r], e1 = e_s[r + 8];
            acc[mi][0] = (acc[mi][0] * a.scale) * e0;
            acc[mi][1] = (acc[mi][1] * a.scale) * e0;
            acc[mi][2] = (acc[mi][2] * a.scale) * e1;
            acc[mi][3] = (acc[mi][3] * a.scale) * e1;
        }

        // ---- (B) + sw v: slices of 16 positions of the record's scores
        // (rows of cw floats, 16-byte aligned) through the ring of staged
        // buffers, the A fragments split into hi / lo halves
        const int nsl = (c + 15) / 16;
        auto stage_sw = [&](int sl) {
            float* dst = (float*)(st_s + (sl % ML_NST) * ML_CMAX * ML_SLD);
            const int u0 = 16 * sl;
            for (int i = tid; i < ML_CMAX * 4; i += ML_THREADS) {
                const int t = i >> 2, cc = (i & 3) << 2;
                const bool on = t < c && u0 + cc < R.cw;
                mt_cp16(dst + t * ML_WLD + cc,
                        rec + R.sw + (on ? (size_t)t * R.cw + u0 + cc : 0),
                        on);
            }
            mt_cp_commit();
        };
        stage_sw(0);
        if (nsl > 1) stage_sw(1);
        for (int sl = 0; sl < nsl; ++sl) {
            if (sl + 2 < nsl) {
                stage_sw(sl + 2);
                mt_cp_wait<2>();
            } else if (sl + 1 < nsl) {
                mt_cp_wait<1>();
            } else {
                mt_cp_wait<0>();
            }
            __syncthreads();                   // slice sl is in
            const float* ws =
                (const float*)(st_s + (sl % ML_NST) * ML_CMAX * ML_SLD);
            uint32_t bv[4];
            mt_frag_b_t(bv, vb_s, ML_VLD, 16 * sl, 16 * (wn >> 1), lane);
            const uint32_t* b = bv + 2 * (wn & 1);
#pragma unroll
            for (int mi = 0; mi < 4; ++mi) {
                const float* w0 = ws + (64 * wm + 16 * mi + g) * ML_WLD
                                + 2 * t4;
                const float* w1 = w0 + 8 * ML_WLD;
                uint32_t ah[4], al[4];
                mt_split(w0[0], w0[1], ah[0], al[0]);
                mt_split(w1[0], w1[1], ah[1], al[1]);
                mt_split(w0[8], w0[9], ah[2], al[2]);
                mt_split(w1[8], w1[9], ah[3], al[3]);
                mt_mma(acc[mi], ah, b);
                mt_mma(acc[mi], al, b);
            }
            __syncthreads();                   // slice sl is consumed
        }

        // ---- (C)'s first two k tiles go in flight behind the output
        ml_stage(st_s, Kp, row0, c, dk, 0, tid);
        if (nt > 1)
            ml_stage(st_s + ML_CMAX * ML_SLD, Kp, row0, c, dk, ML_TS, tid);

        // ---- out = num / max(|e q.n + row sum|, exp(-m_t))
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const int t = 64 * wm + 16 * mi + g + 8 * hf;
                if (t >= c) continue;
                const float qnt = e_s[t] * qn_s[t] + qnr_s[t];
                const float den = fmaxf(fabsf(qnt), expf(-mt_s[t]));
                const int vv = 8 * wn + 2 * t4;
                const size_t ob = (row0 + t) * dv + v0 + vv;
                if (vv < nv)
                    ml_store(a.out, ob, true, acc[mi][2 * hf] / den);
                if (vv + 1 < nv)
                    ml_store(a.out, ob + 1, true, acc[mi][2 * hf + 1] / den);
            }

        // ---- (C) C <- decay C + k^T (a v), k in tiles of 64 columns
        const int mt_ = warp & 3, nh = warp >> 2;
        const int nks = (c + 15) / 16;
        for (int j = 0; j < nt; ++j) {
            const int kb = j * ML_TS;
            ml_wait_tiles(st_s, Kp, row0, c, dk, j, nt, tid);
            __syncthreads();
            const __nv_bfloat16* kt = st_s + (j % ML_NST) * ML_CMAX * ML_SLD;
            float ca[2][4];
#pragma unroll
            for (int n2 = 0; n2 < 2; ++n2)
#pragma unroll
                for (int x = 0; x < 4; ++x) ca[n2][x] = 0.f;
            for (int ks = 0; ks < nks; ++ks) {
                uint32_t af[4], bh4[4], bl4[4];
                // A = k^T: rows (dk) 16 mt_.., k (positions) 16 ks..
                mt_ldsm4_t(af, kt + (16 * ks + (lane & 7) + ((lane >> 4) << 3))
                                   * ML_SLD + 16 * mt_
                                   + (((lane >> 3) & 1) << 3));
                mt_frag_b_t(bh4, vh_s, ML_VLD, 16 * ks, 16 * nh, lane);
                mt_frag_b_t(bl4, vl_s, ML_VLD, 16 * ks, 16 * nh, lane);
#pragma unroll
                for (int n2 = 0; n2 < 2; ++n2) {
                    mt_mma(ca[n2], af, bh4 + 2 * n2);
                    mt_mma(ca[n2], af, bl4 + 2 * n2);
                }
            }
#pragma unroll
            for (int n2 = 0; n2 < 2; ++n2)
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    const int kr = kb + 16 * mt_ + g + 8 * hf;
                    const int vv = 16 * nh + 8 * n2 + 2 * t4;
                    float2* cp = (float2*)&C_s[ml_cswz(kr, vv)];
                    float2 cv = *cp;
                    cv.x = decay * cv.x + ca[n2][2 * hf];
                    cv.y = decay * cv.y + ca[n2][2 * hf + 1];
                    *cp = cv;
                }
            __syncthreads();                   // tile j is consumed
        }
        for (int kk = tid; kk < dk; kk += ML_THREADS)
            n_s[kk] = decay * n_s[kk] + rec[R.kas + kk];
    }

    __syncthreads();
    if (cvec) {
        for (int i = tid; i < dk * (ML_TV / 4); i += ML_THREADS) {
            const int kk = i >> 3, cc = (i & 7) << 2;
            if (cc < nv)
                *(float4*)&a.C[cbase + (size_t)kk * dv + v0 + cc] =
                    *(const float4*)&C_s[ml_cswz(kk, cc)];
        }
    } else {
        for (int idx = tid; idx < dk * ML_TV; idx += ML_THREADS) {
            const int kk = idx / ML_TV, vv = idx - kk * ML_TV;
            if (vv < nv)
                a.C[cbase + (size_t)kk * dv + v0 + vv] = C_s[ml_cswz(kk, vv)];
        }
    }
    if (blockIdx.x == 0) {
        for (int kk = tid; kk < dk; kk += ML_THREADS)
            a.n[(size_t)bi * dk + kk] = n_s[kk];
    }
}

static bool ml_shape_ok(int bh, int s, int dk, int dv, int chunk) {
    return bh >= 1 && s >= 1 && dk >= 1 && dk <= ML_DKMAX && dv >= 1
        && chunk >= 1 && chunk <= ML_CMAX && s % chunk == 0
        && s / chunk <= 65535 && bh <= 65535;
}

// Floats of the scratch the wrapper allocates for mlstm_scan_launch, or -1
// for a shape the kernels do not take.
extern "C" long long mlstm_scan_work_floats(int bh, int s, int dk, int dv,
                                            int chunk) {
    if (!ml_shape_ok(bh, s, dk, dv, chunk)) return -1;
    return (long long)bh * (s / chunk) * (long long)ml_rec(chunk, dk).size;
}

// Returns a cudaError_t, or -1 when the shape is not supported (a chunk that
// does not divide s or exceeds ML_CMAX, or dk above ML_DKMAX). `work` holds
// mlstm_scan_work_floats(...) floats. *body is set to the body that ran: 1
// the tensor cores (bf16 with dk % 8 == 0 and 16-byte aligned q and k), 0
// the CUDA cores.
extern "C" int mlstm_scan_launch(
    const void* q, const void* k, const void* v, const float* ig,
    const float* fg, const float* C0, const float* n0, const float* m0,
    void* out, float* C, float* n, float* m, float* work, int bh, int s,
    int dk, int dv, int chunk, int dtype, float scale, int* body,
    void* stream) {
    if (!ml_shape_ok(bh, s, dk, dv, chunk) || work == nullptr
            || (dtype != ML_F32 && dtype != ML_BF16))
        return -1;
    const bool tc = dtype == ML_BF16 && dk % 8 == 0
                 && (uintptr_t)q % 16 == 0 && (uintptr_t)k % 16 == 0;
    *body = tc ? 1 : 0;
    const size_t smem = tc ? ml_state_tc_bytes(dk)
                           : ml_state_floats(dk) * sizeof(float);
    if (smem > ML_SMEM_MAX) return -1;
    // the dynamic shared-memory limits, set once per device for the widest
    // state tile
    static bool attr_set[64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 0 || dev >= 64) return -1;
    if (!attr_set[dev]) {
        const int most = (int)(ml_state_floats(ML_DKMAX) * sizeof(float));
        e = cudaFuncSetAttribute(mlstm_state_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 most);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(
                mlstm_state_kernel<false>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, most);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(
                mlstm_state_tc_kernel,
                cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)ml_state_tc_bytes(ML_DKMAX));
        if (e != cudaSuccess) return (int)e;
        attr_set[dev] = true;
    }
    MlArgs a;
    a.q = q; a.k = k; a.v = v; a.ig = ig; a.fg = fg;
    a.C0 = C0; a.n0 = n0; a.m0 = m0;
    a.out = out; a.C = C; a.n = n; a.m = m; a.work = work;
    a.bh = bh; a.s = s; a.dk = dk; a.dv = dv; a.chunk = chunk;
    a.scale = scale;
    cudaStream_t st = (cudaStream_t)stream;
    const dim3 g1((chunk + ML_RT - 1) / ML_RT, s / chunk, bh);
    const dim3 g2((dv + ML_TV - 1) / ML_TV, bh);
    if (tc) {
        mlstm_chunk_tc_kernel<<<g1, ML_THREADS, 0, st>>>(a);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        mlstm_state_tc_kernel<<<g2, ML_THREADS, smem, st>>>(a);
    } else if (dtype == ML_BF16) {
        mlstm_chunk_kernel<true><<<g1, ML_THREADS, 0, st>>>(a);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        mlstm_state_kernel<true><<<g2, ML_THREADS, smem, st>>>(a);
    } else {
        mlstm_chunk_kernel<false><<<g1, ML_THREADS, 0, st>>>(a);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        mlstm_state_kernel<false><<<g2, ML_THREADS, smem, st>>>(a);
    }
    return (int)cudaGetLastError();
}
