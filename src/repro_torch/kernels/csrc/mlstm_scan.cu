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
// Bound on this card: bytes at the serving shape (the f32 state is read and
// written once per call: 8 MiB per folded head at dk = dv = 1024).
// Design. The TPU kernel holds a head's whole C in VMEM over its sequential
// chunk axis; 4 MiB does not fit a block's shared memory. So a block owns one
// head and a tile of TV = 32 columns of dv (grid bh x ceil(dv / 32)) and
// keeps its [dk, 32] slice of C (128 KB at dk = 1024) in shared memory for
// the whole scan, looping over the chunks itself. What does not depend on the
// tile (the stabiliser m_t, the decay matrix w, q k^T, q.n, the n update)
// every block recomputes, so the result is exact; q k^T is the redundant
// work (ceil(dv / 32) times per head). Per chunk: (A) stream q and k over dk
// in slices of 16 into shared memory, accumulating the [c, c] scores (an
// 8 x 8 register tile a thread), q C for the tile and q.n; (B) weight the
// scores by w into shared memory; (C) the output tile; (D) the C and n
// update, k a streamed again in slices of 64 through the score buffer. CUDA
// cores in f32, no tensor cores. IEEE math throughout (no fast-math
// intrinsics): padded steps rely on log_sigmoid(1e4) == 0 and
// exp(-1e30 - m) == 0, a fresh state on m = -1e30, and a row that saw only
// padding on exp(1e30) = inf in the denominator, which gives out = 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#define ML_F32 0
#define ML_BF16 1
#define ML_THREADS 256
#define ML_CMAX 128              // longest chunk
#define ML_TV 32                 // dv columns a block owns
#define ML_DKS 16                // dk slice of q and k in phase A
#define ML_DKD 64                // dk slice of k * a in phase D
#define ML_CP (ML_CMAX + 1)      // row stride of the transposed slices
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
    int bh, s, dk, dv, chunk, dtype;
    float scale;                 // 1 / sqrt(dk)
};

__device__ __forceinline__ float ml_load(const void* p, size_t i, int dt) {
    if (dt == ML_BF16) return __bfloat162float(((const __nv_bfloat16*)p)[i]);
    return ((const float*)p)[i];
}

__device__ __forceinline__ void ml_store(void* p, size_t i, int dt, float x) {
    if (dt == ML_BF16) ((__nv_bfloat16*)p)[i] = __float2bfloat16_rn(x);
    else ((float*)p)[i] = x;
}

// log_sigmoid as the reference computes it: min(x, 0) - log1p(exp(-|x|));
// exactly 0 at x = 1e4 (a padded step's forget gate)
__device__ __forceinline__ float ml_log_sigmoid(float x) {
    return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

static size_t ml_smem_floats(int dk) {
    return (size_t)dk * ML_TV + dk            // C tile, n
        + (size_t)ML_CMAX * ML_CMAX            // weighted scores / k*a slices
        + 2 * ML_DKS * ML_CP                   // q, k slices / v tile
        + 8 * ML_CMAX;                         // per-position vectors, m
}

__global__ void __launch_bounds__(ML_THREADS, 1)
mlstm_scan_kernel(MlArgs a) {
    extern __shared__ float4 smem4[];
    float* smem = (float*)smem4;
    const int tid = threadIdx.x;
    const int ty = tid >> 4, tx = tid & 15;      // score tile owner
    const int warp = tid >> 5, lane = tid & 31;
    const int bi = blockIdx.x;
    const int v0 = blockIdx.y * ML_TV;
    const int dk = a.dk, dv = a.dv, c = a.chunk;
    const int nv = min(ML_TV, dv - v0);          // live columns of the tile

    float* C_s = smem;                           // [dk][TV]
    float* n_s = C_s + (size_t)dk * ML_TV;       // [dk]
    float* sw_s = n_s + dk;                      // [CMAX][CMAX] (B, C); k*a (D)
    float* st_s = sw_s + ML_CMAX * ML_CMAX;      // q, k slices (A); v tile (C, D)
    float* g_s = st_s + 2 * ML_DKS * ML_CP;      // cumulative log forget gate
    float* i_s = g_s + ML_CMAX;                  // input gate
    float* mt_s = i_s + ML_CMAX;                 // stabiliser m_t
    float* e_s = mt_s + ML_CMAX;                 // exp(m + g_t - m_t)
    float* qni_s = e_s + ML_CMAX;                // q_t . n (carried state)
    float* qnr_s = qni_s + ML_CMAX;              // sum_u of weighted scores
    float* a_s = qnr_s + ML_CMAX;                // a_u of the state update
    float* m_s = a_s + ML_CMAX;                  // carried m

    const size_t cbase = (size_t)bi * dk * dv;
    for (int idx = tid; idx < dk * ML_TV; idx += ML_THREADS) {
        int kk = idx / ML_TV, vv = idx - kk * ML_TV;
        C_s[idx] = (vv < nv) ? a.C0[cbase + (size_t)kk * dv + v0 + vv] : 0.f;
    }
    for (int kk = tid; kk < dk; kk += ML_THREADS)
        n_s[kk] = a.n0[(size_t)bi * dk + kk];
    if (tid == 0) m_s[0] = a.m0[bi];
    __syncthreads();

    const int nc = a.s / c;
    for (int ci = 0; ci < nc; ++ci) {
        const size_t row0 = (size_t)bi * a.s + (size_t)ci * c;
        const float m_prev = m_s[0];

        // ---- gates: g = cumsum(log_sigmoid(f)), m_t, e_t, a_u
        for (int t = tid; t < c; t += ML_THREADS) {
            i_s[t] = a.ig[row0 + t];
            g_s[t] = ml_log_sigmoid(a.fg[row0 + t]);
        }
        __syncthreads();
        if (tid == 0) {
            float acc = 0.f;
            for (int t = 0; t < c; ++t) {
                acc += g_s[t];
                g_s[t] = acc;
            }
        }
        __syncthreads();
        for (int t = tid; t < c; t += ML_THREADS) {
            const float gt = g_s[t];
            float mi = -1e30f;
            for (int u = 0; u <= t; ++u)
                mi = fmaxf(mi, (gt - g_s[u]) + i_s[u]);
            const float mt = fmaxf(m_prev + gt, mi);
            mt_s[t] = mt;
            e_s[t] = expf((m_prev + gt) - mt);
        }
        __syncthreads();
        {
            const float ge = g_s[c - 1], mn = mt_s[c - 1];
            for (int u = tid; u < c; u += ML_THREADS)
                a_s[u] = expf(((ge - g_s[u]) + i_s[u]) - mn);
        }

        // ---- (A) scores q k^T, q C (this tile), q.n; dk in slices
        float sacc[8][8];
        float qc[8][2];
        float qn = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
            for (int j = 0; j < 8; ++j) sacc[i][j] = 0.f;
            qc[i][0] = 0.f;
            qc[i][1] = 0.f;
        }
        float* qT = st_s;                        // [DKS][CP], q pre-scaled
        float* kT = st_s + ML_DKS * ML_CP;       // [DKS][CP]
        for (int k0 = 0; k0 < dk; k0 += ML_DKS) {
            __syncthreads();                     // the last slice is consumed
            for (int idx = tid; idx < c * ML_DKS; idx += ML_THREADS) {
                int t = idx / ML_DKS, kk = idx - t * ML_DKS;
                float qv = 0.f, kv = 0.f;
                if (k0 + kk < dk) {
                    size_t off = (row0 + t) * dk + k0 + kk;
                    qv = ml_load(a.q, off, a.dtype) * a.scale;
                    kv = ml_load(a.k, off, a.dtype);
                }
                qT[kk * ML_CP + t] = qv;
                kT[kk * ML_CP + t] = kv;
            }
            __syncthreads();
            const int kn = min(ML_DKS, dk - k0);
            for (int kk = 0; kk < kn; ++kk) {
                float qa[8], kb[8];
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    qa[i] = qT[kk * ML_CP + ty + 16 * i];
                    kb[i] = kT[kk * ML_CP + tx + 16 * i];
                }
                const float c0 = C_s[(k0 + kk) * ML_TV + tx];
                const float c1 = C_s[(k0 + kk) * ML_TV + tx + 16];
#pragma unroll
                for (int i = 0; i < 8; ++i) {
#pragma unroll
                    for (int j = 0; j < 8; ++j)
                        sacc[i][j] = fmaf(qa[i], kb[j], sacc[i][j]);
                    qc[i][0] = fmaf(qa[i], c0, qc[i][0]);
                    qc[i][1] = fmaf(qa[i], c1, qc[i][1]);
                }
            }
            if (tid < c) {
                for (int kk = 0; kk < kn; ++kk)
                    qn = fmaf(qT[kk * ML_CP + tid], n_s[k0 + kk], qn);
            }
        }

        // ---- (B) weighted scores sw = (q k^T) * w, rows t, columns u <= t
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int t = ty + 16 * i;
            if (t < c) {
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const int u = tx + 16 * j;
                    if (u <= t) {
                        float w = expf(((g_s[t] - g_s[u]) + i_s[u]) - mt_s[t]);
                        sw_s[t * ML_CMAX + u] = sacc[i][j] * w;
                    }
                }
            }
        }
        __syncthreads();                         // sw written; slices free

        // ---- (C) the output tile
        float* v_s = st_s;                       // [CMAX][TV]
        for (int idx = tid; idx < c * ML_TV; idx += ML_THREADS) {
            int u = idx / ML_TV, vv = idx - u * ML_TV;
            v_s[idx] = (vv < nv)
                ? ml_load(a.v, (row0 + u) * dv + v0 + vv, a.dtype) : 0.f;
        }
        if (tid < c) {
            float acc = 0.f;
            for (int u = 0; u <= tid; ++u) acc += sw_s[tid * ML_CMAX + u];
            qnr_s[tid] = acc;
            qni_s[tid] = qn;
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int t = ty + 16 * i;
            if (t < c) {
                float o0 = 0.f, o1 = 0.f;
                for (int u = 0; u <= t; ++u) {
                    const float sw = sw_s[t * ML_CMAX + u];
                    o0 = fmaf(sw, v_s[u * ML_TV + tx], o0);
                    o1 = fmaf(sw, v_s[u * ML_TV + tx + 16], o1);
                }
                const float e = e_s[t];
                const float qnt = e * qni_s[t] + qnr_s[t];
                const float den = fmaxf(fabsf(qnt), expf(-mt_s[t]));
                const size_t ob = (row0 + t) * dv + v0;
                if (tx < nv) ml_store(a.out, ob + tx, a.dtype,
                                      (e * qc[i][0] + o0) / den);
                if (tx + 16 < nv) ml_store(a.out, ob + tx + 16, a.dtype,
                                           (e * qc[i][1] + o1) / den);
            }
        }
        __syncthreads();                         // sw read; its buffer free

        // ---- (D) state update: C, n <- e_c (C, n) + sum_u (k_u a_u) (v_u, 1)
        const float decay = e_s[c - 1];
        float* kaT = sw_s;                       // [DKD][CP]
        for (int k0 = 0; k0 < dk; k0 += ML_DKD) {
            for (int idx = tid; idx < c * ML_DKD; idx += ML_THREADS) {
                int u = idx / ML_DKD, kk = idx - u * ML_DKD;
                kaT[kk * ML_CP + u] = (k0 + kk < dk)
                    ? ml_load(a.k, (row0 + u) * dk + k0 + kk, a.dtype) * a_s[u]
                    : 0.f;
            }
            __syncthreads();
#pragma unroll
            for (int j = 0; j < ML_DKD / 8; ++j) {
                const int kk = warp + 8 * j;
                if (k0 + kk < dk) {
                    float acc = 0.f;
                    for (int u = 0; u < c; ++u)
                        acc = fmaf(kaT[kk * ML_CP + u], v_s[u * ML_TV + lane],
                                   acc);
                    float* cp = &C_s[(k0 + kk) * ML_TV + lane];
                    *cp = decay * *cp + acc;
                }
            }
            if (tid < ML_DKD && k0 + tid < dk) {
                float acc = 0.f;
                for (int u = 0; u < c; ++u) acc += kaT[tid * ML_CP + u];
                n_s[k0 + tid] = decay * n_s[k0 + tid] + acc;
            }
            __syncthreads();
        }
        if (tid == 0) m_s[0] = mt_s[c - 1];
        __syncthreads();
    }

    for (int idx = tid; idx < dk * ML_TV; idx += ML_THREADS) {
        int kk = idx / ML_TV, vv = idx - kk * ML_TV;
        if (vv < nv) a.C[cbase + (size_t)kk * dv + v0 + vv] = C_s[idx];
    }
    if (blockIdx.y == 0) {
        for (int kk = tid; kk < dk; kk += ML_THREADS)
            a.n[(size_t)bi * dk + kk] = n_s[kk];
        if (tid == 0) a.m[bi] = m_s[0];
    }
}

// Returns a cudaError_t, or -1 when the shape is not supported (a chunk that
// does not divide s or exceeds ML_CMAX, or a state tile too large for shared
// memory).
extern "C" int mlstm_scan_launch(
    const void* q, const void* k, const void* v, const float* ig,
    const float* fg, const float* C0, const float* n0, const float* m0,
    void* out, float* C, float* n, float* m, int bh, int s, int dk, int dv,
    int chunk, int dtype, float scale, void* stream) {
    if (bh < 1 || s < 1 || dk < 1 || dv < 1 || chunk < 1
            || chunk > ML_CMAX || s % chunk)
        return -1;
    const size_t smem = ml_smem_floats(dk) * sizeof(float);
    if (smem > ML_SMEM_MAX || (dv + ML_TV - 1) / ML_TV > 65535) return -1;
    MlArgs a;
    a.q = q; a.k = k; a.v = v; a.ig = ig; a.fg = fg;
    a.C0 = C0; a.n0 = n0; a.m0 = m0;
    a.out = out; a.C = C; a.n = n; a.m = m;
    a.bh = bh; a.s = s; a.dk = dk; a.dv = dv; a.chunk = chunk;
    a.dtype = dtype; a.scale = scale;
    cudaError_t e = cudaFuncSetAttribute(
        mlstm_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(bh, (dv + ML_TV - 1) / ML_TV);
    mlstm_scan_kernel<<<grid, ML_THREADS, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
