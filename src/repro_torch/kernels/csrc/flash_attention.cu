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
// Two bodies, chosen by dtype alone (never by shape); the entry point
// reports which one ran.
//
// bf16 inputs: the tensor-core body (flash_fwd_tc_kernel). One block of 8
// warps per (tile of 128 / G query positions, kv head, batch row) serves
// all G query heads of that kv head as 128 rows (row m = (position m / G,
// head m % G)), so every K/V tile is read from device memory once per G
// heads; each warp owns 16 rows (two blocks an SM up to hd 128; the last
// query tiles, which see the most keys, start first). The block works out
// its walk over the K/V tiles once, from the positions, into shared
// memory; the tiles of BN keys go through a two-stage cp.async ring (the
// next live tile loads while this one is computed). Per tile and warp: S = Q . K^T by mma.sync
// m16n8k16 (bf16 in, f32 out; 1/sqrt(hd) applied to the f32 product, never
// to q before its rounding), the mask from the positions in registers, the
// online softmax reduced over the four lanes that share a row (shuffles),
// and O += P . V by mma.sync with P split into bf16 hi + lo halves: P
// rounded once to bf16 would carry 2^-9 of each weight into the output,
// above the bf16 tolerance (tests/test_torch_flash_rounding.py). The head
// dimension is padded with zeros to HDP (a multiple of 16, of 32 above
// 128) in shared memory; hd must be a multiple of 8 (16-byte rows).
//
// f32 inputs: the CUDA-core body (flash_fwd_kernel), f32 throughout (f32
// parity at 1e-4 excludes TF32 products): one block (128 threads) per
// (tile of QT query positions, kv head, batch row), K/V tiles in shared
// memory in f32, a 4 x 8 register tile of scores a thread, the online
// softmax one warp per row, p.V into registers.
//
// Both skip tiles from the positions themselves, never from indices: a tile
// whose valid kpos span lies wholly above the block's largest qpos, or
// outside every row's window or chunk, is never loaded, so positions need
// not equal indices (the TPU kernel assumes they do); the tensor-core body
// also skips the per-element mask on a tile every row sees whole. Any sq,
// sk: the last tiles are bounds-checked.
#include <limits.h>

#include "mma_tile.cuh"
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

// ---- bf16: the tensor-core body --------------------------------------------

#define FT_WARPS 8
#define FT_THREADS (FT_WARPS * 32)
#define FT_ROWS (FT_WARPS * 16)      // query rows a block serves

// q_s[FT_ROWS][LD], k_s[2][BN][LD], v_s[2][BN][LD] (bf16), kp_s[2][BN]
// (int: the tiles' key positions), then the walk's flags fl_s[ntile]
static constexpr size_t ft_smem_bytes(int hdp, int bn) {
    return 2 * ((size_t)FT_ROWS + 4 * bn) * MT_LD(hdp) + 8 * (size_t)bn;
}

// Two blocks an SM up to hd 128 (at most 128 registers a thread: 64-key
// tiles to hd 96, 32-key tiles above), one above: with a single block of
// 8 warps an SM, the SM idles at every barrier of the block.
template <int HDP, int BN>
__global__ void __launch_bounds__(FT_THREADS, HDP <= 128 ? 2 : 1)
flash_fwd_tc_kernel(FlashArgs a) {
    constexpr int LD = MT_LD(HDP), NT = HDP / 8, ST = BN / 8;
    extern __shared__ float4 smem4[];
    __nv_bfloat16* q_s = (__nv_bfloat16*)smem4;
    __nv_bfloat16* k_s = q_s + FT_ROWS * LD;
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

    // ---- query rows (zeros past QR and sq), the k padding of every tile
    mt_copy_rows(q_s, LD, (const __nv_bfloat16*)a.q, FT_ROWS, hd,
                 [&](int ml) -> long long {
        const int t = t0 + ml / G;
        if (ml >= QR || t >= a.sq) return -1;
        return (((long long)bi * a.sq + t) * H + kh * G + ml % G) * hd;
    }, tid, FT_THREADS);
    mt_cp_commit();
    if (HDP > hd) {
        mt_zero_cols(q_s, LD, FT_ROWS, hd, HDP, tid, FT_THREADS);
        mt_zero_cols(k_s, LD, 4 * BN, hd, HDP, tid, FT_THREADS);  // k and v
    }
    // this thread's rows: g and g + 8 of the warp's 16
    int qp[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int ml = warp * 16 + g + 8 * i, t = t0 + ml / G;
        qp[i] = (ml < QR && t < a.sq) ? a.qpos[(size_t)bi * a.sq + t] : -1;
    }
    const bool warp_live = warp * 16 < QR && t0 + warp * 16 / G < a.sq;
    const MtSpan qs = mt_span(a.qpos + (size_t)bi * a.sq + t0,
                              min(a.QT, a.sq - t0), lane);
    // ---- the walk over the key tiles, from the positions alone
    const int ntile = qs.hi >= 0 ? (a.sk + BN - 1) / BN : 0;
    mt_schedule(fl_s, kpos, a.sk, BN, ntile, qs, true, a.window, a.chunk,
                tid, FT_THREADS);
    __syncthreads();

    // K and V rows of tile j into stage st (zeros past sk); the tile's key
    // positions go to kp_s a round later, out of the copy's way
    auto load = [&](int j, int st) {
        const int k0 = j * BN;
        auto off = [&](int r) -> long long {
            if (k0 + r >= a.sk) return -1;
            return (((long long)bi * a.sk + k0 + r) * K + kh) * hd;
        };
        mt_copy_rows(k_s + st * BN * LD, LD, kg, BN, hd, off, tid,
                     FT_THREADS);
        mt_copy_rows(v_s + st * BN * LD, LD, vg, BN, hd, off, tid,
                     FT_THREADS);
    };
    auto key_pos = [&](int j) -> int {
        const int key = j * BN + tid;
        return (tid < BN && key < a.sk) ? kpos[key] : -1;
    };

    float o[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m[2] = {PA_NEG_INF, PA_NEG_INF}, l[2] = {0.f, 0.f};
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
        mt_cp_wait<1>();             // Q and this tile have landed
        __syncthreads();
        const __nv_bfloat16* ks = k_s + st * BN * LD;
        const __nv_bfloat16* vs = v_s + st * BN * LD;
        const int* kps = kp_s + st * BN;
        const unsigned char f = fl_s[cur];
        if (f & MT_HOLES) {          // rare: padded keys inside sk
            mt_zero_holes(k_s + st * BN * LD, LD, kps, BN, HDP, tid,
                          FT_THREADS);
            mt_zero_holes(v_s + st * BN * LD, LD, kps, BN, HDP, tid,
                          FT_THREADS);
            __syncthreads();
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
            // ---- scale, mask, online softmax (a row's four lanes)
            float mx[2] = {PA_NEG_INF, PA_NEG_INF};
#pragma unroll
            for (int j = 0; j < ST; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int i = e >> 1;
                    float x = s[j][e] * a.scale;
                    if (!full) {
                        const int kp = kps[j * 8 + 2 * t4 + (e & 1)];
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
                    s[j][e] = p;
                    rs[i] += p;
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
        if (nxt < ntile && tid < BN) kp_s[(st ^ 1) * BN + tid] = kp_next;
        __syncthreads();             // this stage is refilled next round
        cur = nxt;
    }
    mt_cp_wait<0>();

    // ---- finalise: a row that saw nothing gives 0 (and lse -1e30)
    __nv_bfloat16* og = (__nv_bfloat16*)a.o;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        const int ml = warp * 16 + g + 8 * i, t = t0 + ml / G;
        if (ml >= QR || t >= a.sq) continue;
        const size_t row = ((size_t)bi * a.sq + t) * H + kh * G + ml % G;
        const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            const int c = n * 8 + 2 * t4;
            if (c < hd)
                *(uint32_t*)(og + row * hd + c) =
                    mt_pack(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
        }
        if (t4 == 0 && a.lse != nullptr)
            a.lse[row] = m[i] + logf(fmaxf(l[i], 1e-30f));
    }
}

template <int HDP, int BN>
static int ft_launch(const FlashArgs& a, cudaStream_t stream) {
    static_assert(ft_smem_bytes(HDP, BN) <= 227 * 1024,
                  "shared memory of one block");
    const size_t smem = ft_smem_bytes(HDP, BN) + (a.sk + BN - 1) / BN;
    if (smem > 227 * 1024) return -1;
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_tc_kernel<HDP, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((a.sq + a.QT - 1) / a.QT, a.K, a.b);
    flash_fwd_tc_kernel<HDP, BN><<<grid, FT_THREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

static int ft_dispatch(FlashArgs a, cudaStream_t st) {
    if (a.G > FT_ROWS) return -1;
    int qt = FT_ROWS / a.G;
    if (qt > a.sq) qt = a.sq;
    a.QT = qt;
    a.QR = qt * a.G;
    switch (mt_hdp(a.hd)) {
    case 16: return ft_launch<16, 64>(a, st);
    case 32: return ft_launch<32, 64>(a, st);
    case 48: return ft_launch<48, 64>(a, st);
    case 64: return ft_launch<64, 64>(a, st);
    case 80: return ft_launch<80, 64>(a, st);
    case 96: return ft_launch<96, 64>(a, st);
    case 112: return ft_launch<112, 32>(a, st);
    case 128: return ft_launch<128, 32>(a, st);
    case 160: return ft_launch<160, 64>(a, st);
    case 192: return ft_launch<192, 64>(a, st);
    case 224: return ft_launch<224, 64>(a, st);
    case 256: return ft_launch<256, 64>(a, st);
    default: return -1;
    }
}

// Returns a cudaError_t, or -1 when the shape is not supported (bf16: hd
// not a multiple of 8 or above 256, or more than 128 query heads per kv
// head; f32: too many accumulators or too much shared memory). *body is
// set to the body the dtype chose: 1 tensor cores (bf16), 0 CUDA cores
// (f32).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, float* lse,
    const int* qpos, const int* kpos, int b, int sq, int sk, int K, int G,
    int hd, int dtype, int window, int chunk, float scale, int* body,
    void* stream) {
    FlashArgs a;
    a.q = q; a.k = k; a.v = v; a.o = o; a.lse = lse;
    a.qpos = qpos; a.kpos = kpos;
    a.b = b; a.sq = sq; a.sk = sk; a.K = K; a.G = G; a.hd = hd;
    a.dtype = dtype; a.window = window; a.chunk = chunk; a.scale = scale;
    *body = dtype == PA_BF16 ? 1 : 0;
    if (dtype == PA_BF16) return ft_dispatch(a, (cudaStream_t)stream);
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
