// bf16 tensor-core building blocks for Hopper (sm_90a) shared by the flash
// attention forward and backward kernels: warp-level mma.sync m16n8k16 with
// f32 accumulators, ldmatrix (and .trans) fragment loads, cp.async 16-byte
// copies with commit / wait groups, and the padded shared-memory row layout
// that keeps ldmatrix free of bank conflicts.
//
// Fragments of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16 x 16 row-major, 4 x u32 (bf16 pairs): (g, 2t..), (g + 8, 2t..),
//     (g, 2t + 8..), (g + 8, 2t + 8..)
//   B 16 x 8 (k x n), 2 x u32: (k = 2t.., n = g), (k = 2t + 8.., n = g)
//   C 16 x 8 f32, 4 floats: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
// The C fragments of two neighbouring n-tiles are, packed to bf16 pairs,
// the A fragment of one k-chunk of 16: a product's scores feed the next
// product from registers.
//
// Shared tiles are row-major bf16 [rows][MT_LD(width)]: width (a multiple
// of 16) plus 8 elements, so consecutive rows start 16 * odd bytes apart and
// the eight row addresses of one 8 x 8 ldmatrix fall in eight different
// bank groups.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MT_PAD 8

__host__ __device__ constexpr int MT_LD(int width) { return width + MT_PAD; }

// The width a head dimension is padded to in shared memory: a multiple of
// 16 up to 128, of 32 above (so that half of it is still a multiple of
// 16); 0 where the tensor-core bodies do not take it (hd not a multiple of
// 8, or above 256).
static inline int mt_hdp(int hd) {
    if (hd < 8 || hd % 8 || hd > 256) return 0;
    return hd <= 128 ? (hd + 15) / 16 * 16 : (hd + 31) / 32 * 32;
}

// d += a . b, bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mt_mma(float* d, const uint32_t* a,
                                       const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t mt_smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8.
__device__ __forceinline__ void mt_ldsm4(uint32_t* r, const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(mt_smem_addr(p)));
}

__device__ __forceinline__ void mt_ldsm4_t(uint32_t* r, const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
        "{%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(mt_smem_addr(p)));
}

// Row-major tile s (leading dimension ld), 16 x 16 block at (r0, c0):
//   mt_frag_a:   the A fragment (rows r0.., k = columns c0..);
//   mt_frag_b_t: with rows as k and columns as n, the B fragments of the
//                n-tiles c0 and c0 + 8 ({r[0], r[1]}, {r[2], r[3]});
//   mt_frag_b:   with rows as n and columns as k, the B fragments of the
//                n-tiles r0 and r0 + 8.
__device__ __forceinline__ void mt_frag_a(uint32_t* r,
                                          const __nv_bfloat16* s, int ld,
                                          int r0, int c0, int lane) {
    mt_ldsm4(r, s + (r0 + (lane & 15)) * ld + c0 + ((lane >> 4) << 3));
}

__device__ __forceinline__ void mt_frag_b_t(uint32_t* r,
                                            const __nv_bfloat16* s, int ld,
                                            int r0, int c0, int lane) {
    mt_ldsm4_t(r, s + (r0 + (lane & 15)) * ld + c0 + ((lane >> 4) << 3));
}

__device__ __forceinline__ void mt_frag_b(uint32_t* r,
                                          const __nv_bfloat16* s, int ld,
                                          int r0, int c0, int lane) {
    mt_ldsm4(r, s + (r0 + (lane & 7) + ((lane >> 4) << 3)) * ld + c0 +
                    (((lane >> 3) & 1) << 3));
}

// bf16 pair (x0 in the low half, as the fragments order them).
__device__ __forceinline__ uint32_t mt_pack(float x0, float x1) {
    __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    return *reinterpret_cast<uint32_t*>(&h);
}

// x = hi + lo to about 2^-17 of x: hi = bf16(x), lo = bf16(x - hi). A
// product of both halves carries an f32 operand into the tensor cores at
// twice the cost of one bf16 product.
__device__ __forceinline__ void mt_split(float x0, float x1, uint32_t& hi,
                                         uint32_t& lo) {
    __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    float2 hf = __bfloat1622float2(h);
    __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
    hi = *reinterpret_cast<uint32_t*>(&h);
    lo = *reinterpret_cast<uint32_t*>(&l);
}

// The A fragments (hi and lo halves) of k-chunk kk from the C fragments c
// of n-tiles 2 kk and 2 kk + 1.
__device__ __forceinline__ void mt_c_to_a(float (*c)[4], int kk,
                                          uint32_t* hi, uint32_t* lo) {
    mt_split(c[2 * kk][0], c[2 * kk][1], hi[0], lo[0]);
    mt_split(c[2 * kk][2], c[2 * kk][3], hi[1], lo[1]);
    mt_split(c[2 * kk + 1][0], c[2 * kk + 1][1], hi[2], lo[2]);
    mt_split(c[2 * kk + 1][2], c[2 * kk + 1][3], hi[3], lo[3]);
}

// 16 bytes global -> shared, bypassing L1; zeros when !pred (nothing is
// read then, but src must still be a valid address).
__device__ __forceinline__ void mt_cp16(void* dst, const void* src,
                                        bool pred) {
    asm volatile(
        "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
            mt_smem_addr(dst)),
        "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void mt_cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void mt_cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies rows r < rows of hd bf16 values (hd % 8 == 0) into the tile dst
// [rows][ld] with cp.async, row r from src + off(r) (elements), or zeros
// where off(r) < 0; columns hd.. of dst are left as they are.
template <class Off>
__device__ __forceinline__ void mt_copy_rows(__nv_bfloat16* dst, int ld,
                                             const __nv_bfloat16* src,
                                             int rows, int hd, Off off,
                                             int tid, int nthreads) {
    const int ch = hd >> 3;
    for (int i = tid; i < rows * ch; i += nthreads) {
        const int r = i / ch, c = i - r * ch;
        const long long o = off(r);
        mt_cp16(dst + r * ld + c * 8, src + (o < 0 ? 0 : o) + c * 8, o >= 0);
    }
}

// Zeros columns hd..width of a tile [rows][ld] (the k padding of a head
// dimension that is no multiple of 16).
__device__ __forceinline__ void mt_zero_cols(__nv_bfloat16* s, int ld,
                                             int rows, int hd, int width,
                                             int tid, int nthreads) {
    const int w = width - hd;
    for (int i = tid; i < rows * w; i += nthreads) {
        const int r = i / w;
        s[r * ld + hd + (i - r * w)] = __float2bfloat16(0.f);
    }
}

__device__ __forceinline__ int mt_warp_min(int v) {
    for (int o = 16; o > 0; o >>= 1)
        v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ int mt_warp_max(int v) {
    for (int o = 16; o > 0; o >>= 1)
        v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// The span of the valid (>= 0) values among n positions pos[i] (i < n),
// reduced over the warp: {min, max (-1: none), whether every one of them
// is valid}. Every lane gets the same answer.
struct MtSpan {
    int lo, hi;
    bool all;
};

__device__ __forceinline__ MtSpan mt_span(const int* pos, int n, int lane) {
    int lo = 0x7fffffff, hi = -1, bad = 0;
    for (int i = lane; i < n; i += 32) {
        const int p = pos[i];
        if (p >= 0) {
            lo = min(lo, p);
            hi = max(hi, p);
        } else {
            bad = 1;
        }
    }
    MtSpan s;
    s.lo = mt_warp_min(lo);
    s.hi = mt_warp_max(hi);
    s.all = !__any_sync(0xffffffffu, bad);
    return s;
}

// Whether a tile of queries with valid positions in q and one of keys in k
// can hold a visible pair (causal, window, chunk), and whether every pair
// of the two is visible (then the per-element mask can be skipped).
__device__ __forceinline__ bool mt_live(MtSpan q, MtSpan k, int window,
                                        int chunk) {
    bool live = q.hi >= 0 && k.hi >= 0 && k.lo <= q.hi;
    if (window > 0) live = live && k.hi > q.lo - window;
    if (chunk > 0)
        live = live && k.hi / chunk >= q.lo / chunk
                    && k.lo / chunk <= q.hi / chunk;
    return live;
}

__device__ __forceinline__ bool mt_full(MtSpan q, MtSpan k, int window,
                                        int chunk) {
    bool full = q.all && k.all && q.hi >= 0 && k.hi >= 0 && k.hi <= q.lo;
    if (window > 0) full = full && k.lo > q.hi - window;
    if (chunk > 0)
        full = full && k.lo / chunk == q.hi / chunk
                    && k.hi / chunk == q.lo / chunk;
    return full;
}

// A block's walk over ntile tiles of `len` entries of pos[0..npos) (the
// last one cut at npos), against the fixed span of the other side: per tile
// MT_LIVE (it can hold a visible pair), MT_FULL (every pair is visible: no
// per-element mask) and MT_HOLES (an entry at position -1). Key tiles
// (walk_keys) are full only when complete: a missing key would count. One
// thread a tile, its entries read in one run of independent loads, so the
// walk itself waits on device memory once, not once a tile.
#define MT_LIVE 1
#define MT_FULL 2
#define MT_HOLES 4

__device__ __forceinline__ void mt_schedule(unsigned char* fl,
                                            const int* pos, int npos,
                                            int len, int ntile, MtSpan fixed,
                                            bool walk_keys, int window,
                                            int chunk, int tid,
                                            int nthreads) {
    for (int j = tid; j < ntile; j += nthreads) {
        const int a = j * len, b = min(a + len, npos);
        MtSpan s = {0x7fffffff, -1, true};
        for (int i = a; i < b; ++i) {
            const int p = pos[i];
            if (p >= 0) {
                s.lo = min(s.lo, p);
                s.hi = max(s.hi, p);
            } else {
                s.all = false;
            }
        }
        unsigned char f = s.all ? 0 : MT_HOLES;
        if (walk_keys) {
            s.all = s.all && b - a == len;
            if (mt_live(fixed, s, window, chunk))
                f |= MT_LIVE | (mt_full(fixed, s, window, chunk) ? MT_FULL : 0);
        } else if (mt_live(s, fixed, window, chunk)) {
            f |= MT_LIVE | (mt_full(s, fixed, window, chunk) ? MT_FULL : 0);
        }
        fl[j] = f;
    }
}

// The next live tile at or after j (ntile: none).
__device__ __forceinline__ int mt_next(const unsigned char* fl, int j,
                                       int ntile) {
    while (j < ntile && !(fl[j] & MT_LIVE)) ++j;
    return j;
}

// Zeros the rows r < rows of a tile [rows][ld] (width columns) whose
// position pos_s[r] is -1: a padded row that holds no finite value must not
// reach a product, even with weight 0.
__device__ __forceinline__ void mt_zero_holes(__nv_bfloat16* s, int ld,
                                              const int* pos_s, int rows,
                                              int width, int tid,
                                              int nthreads) {
    for (int i = tid; i < rows * width; i += nthreads) {
        const int r = i / width;
        if (pos_s[r] < 0) s[r * ld + (i - r * width)] = __float2bfloat16(0.f);
    }
}
