"""Chunked mLSTM scan: wrapper of the CUDA kernels, and the plain PyTorch
version.

Replaces the TPU kernel kernels/mlstm_scan.py · mlstm_scan_fwd of the
reference package: the chunkwise-parallel mLSTM over folded heads, an f32
state (C [dk, dv], n [dk], m) carried across chunks, within a chunk the
log-space stabilised decay matrix weighting q kᵀ. At the serving shape (32
folded heads x 256 positions, dk = dv = 1024) the function is bound by its
f32 operations, nine tenths of them the products with the state. The
stabiliser chain m depends on the gates alone, so a first kernel computes
once per (head, chunk) everything but the state products (m_t, the decay
weights, the weighted scores (q kᵀ) o w and their row sums) into a scratch
record this wrapper allocates; a second holds a 1024 x 32 f32 column tile
of C in shared memory per thread block (grid: dv tile x folded head) and
loops over the chunks (csrc/mlstm_scan.cu). bf16 inputs run the state
products on the tensor cores (the f32 operand split into bf16 hi + lo
halves), f32 inputs on the CUDA cores; the launch reports which body ran
(`last_body`).

The wrapper launches the kernels for CUDA tensors and raises if it cannot;
it takes the plain version only for tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import build

SOURCE = "mlstm_scan.cu"

NEG_INF = -1e30
# the longest chunk the kernels take: their tiles span 128 positions
CHUNK_MAX = 128
# the widest dk whose [dk, 32] f32 state tile fits in a block's shared memory
DK_MAX = 1024

# calls of mlstm_scan_fwd that launched the CUDA kernels (two launches a
# call, counted once; nothing else counts): a run can show that its path
# went through them
launches = 0
# the body the last launch ran, as the C entry point reports it
BODIES = {0: "cuda-core f32", 1: "tensor-core bf16"}
last_body = None

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_fn = None


def _bound():
    global _fn
    if _fn is None:
        lib = build.library(SOURCE)
        fn = lib.mlstm_scan_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 13 + [i] * 6 + [ctypes.c_float, p, p]
        fn.restype = ctypes.c_int
        lib.mlstm_scan_work_floats.argtypes = [i] * 5
        lib.mlstm_scan_work_floats.restype = ctypes.c_longlong
        _fn = (fn, lib.mlstm_scan_work_floats)
    return _fn


def chunk_of(chunk: int, s: int) -> int:
    """The chunk a scan of s positions runs at: min(chunk, s), which must
    divide s (the reference package asserts the same)."""
    c = min(int(chunk), s)
    if c < 1 or s % c:
        raise ValueError(f"mLSTM scan of {s} positions at chunk {c}: the "
                         "chunk must divide the sequence")
    return c


def _initial(initial, bh, dk, dv, device):
    """(C0 [bh,dk,dv], n0 [bh,dk], m0 [bh]) in f32: `initial` (m0 [bh, 1])
    or a fresh state (m0 = -1e30, not 0: the stabiliser of an empty scan)."""
    if initial is None:
        return (torch.zeros((bh, dk, dv), dtype=torch.float32, device=device),
                torch.zeros((bh, dk), dtype=torch.float32, device=device),
                torch.full((bh,), NEG_INF, dtype=torch.float32,
                           device=device))
    C0, n0, m0 = (t.float() for t in initial)
    return C0, n0, m0.reshape(bh)


def mlstm_scan_plain(q, k, v, i_gate, f_gate, *, chunk: int = 128,
                     initial=None):
    """The plain PyTorch version, a loop over chunks in f32 (the reference
    package's blocked form, ops._mlstm_chunked_jnp). Same arguments and
    results as mlstm_scan_fwd."""
    bh, s, dk = q.shape
    dv = v.shape[-1]
    c = chunk_of(chunk, s)
    nc = s // c
    dev = q.device
    scale = float(1.0 / np.sqrt(dk))
    tri = torch.ones((c, c), dtype=torch.bool, device=dev).tril()
    qs = q.float().reshape(bh, nc, c, dk) * scale
    ks = k.float().reshape(bh, nc, c, dk)
    vs = v.float().reshape(bh, nc, c, dv)
    igs = i_gate.float().reshape(bh, nc, c)
    fgs = f_gate.float().reshape(bh, nc, c)
    C, n, m = _initial(initial, bh, dk, dv, dev)
    outs = []
    for ci in range(nc):
        qc, kc, vc, ic = qs[:, ci], ks[:, ci], vs[:, ci], igs[:, ci]
        g = torch.cumsum(F.logsigmoid(fgs[:, ci]), dim=-1)       # [bh, c]
        dmat = g[:, :, None] - g[:, None, :] + ic[:, None, :]
        dmat = torch.where(tri, dmat, NEG_INF)
        m_t = torch.maximum(m[:, None] + g, dmat.amax(dim=-1))
        w = torch.where(tri, torch.exp(dmat - m_t[..., None]), 0.0)
        sc = torch.einsum("btk,bsk->bts", qc, kc) * w
        out_intra = torch.einsum("bts,bsv->btv", sc, vc)
        qn_intra = sc.sum(dim=-1)
        inter = torch.exp(m[:, None] + g - m_t)
        qC = torch.einsum("btk,bkv->btv", qc, C)
        qn_inter = torch.einsum("btk,bk->bt", qc, n)
        num = inter[..., None] * qC + out_intra
        qn = inter * qn_inter + qn_intra
        den = torch.maximum(qn.abs(), torch.exp(-m_t))
        outs.append(num / den[..., None])
        g_end = g[:, -1]
        m_new = torch.maximum(m + g_end,
                              (g_end[:, None] - g + ic).amax(dim=-1))
        a = torch.exp(g_end[:, None] - g + ic - m_new[:, None])
        decay = torch.exp(m + g_end - m_new)
        ka = kc * a[..., None]
        C = decay[:, None, None] * C + torch.einsum("bsk,bsv->bkv", ka, vc)
        n = decay[:, None] * n + ka.sum(dim=1)
        m = m_new
    out = torch.stack(outs, dim=1).reshape(bh, s, dv).to(v.dtype)
    return out, (C, n, m[:, None])


def mlstm_scan_fwd(q, k, v, i_gate, f_gate, *, chunk: int = 128,
                   initial=None):
    """Chunked mLSTM over folded heads. q, k [bh, s, dk]; v [bh, s, dv]
    (f32 or bf16, one dtype); i_gate/f_gate [bh, s] (taken in f32);
    `initial` optionally seeds the carried state (C0 [bh, dk, dv], n0
    [bh, dk], m0 [bh, 1]), as a mid-prompt chunk of serving chunked
    prefill does; None starts fresh. Returns (out [bh, s, dv] in v's dtype,
    (C [bh, dk, dv], n [bh, dk], m [bh, 1]) in f32), new tensors.

    min(chunk, s) must divide s (ValueError otherwise). CUDA tensors go to
    the CUDA kernel (built at first use; a failed build or launch raises,
    as do chunks above CHUNK_MAX and dk above DK_MAX); CPU tensors to the
    plain version."""
    if not q.is_cuda:
        return mlstm_scan_plain(q, k, v, i_gate, f_gate, chunk=chunk,
                                initial=initial)
    global launches, last_body
    bh, s, dk = q.shape
    dv = v.shape[-1]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: one "
                        "of float32, bfloat16 for all three")
    if tuple(k.shape) != (bh, s, dk) or tuple(v.shape[:2]) != (bh, s) \
            or v.dim() != 3:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: want [bh, s, dk] and [bh, s, dv]")
    if tuple(i_gate.shape) != (bh, s) or tuple(f_gate.shape) != (bh, s):
        raise ValueError("gates must be [bh, s]")
    if bh == 0 or s == 0 or dk == 0 or dv == 0:
        raise ValueError(f"empty scan: bh={bh}, s={s}, dk={dk}, dv={dv}")
    c = chunk_of(chunk, s)
    if c > CHUNK_MAX or dk > DK_MAX:
        raise ValueError(f"chunk {c} > {CHUNK_MAX} or dk {dk} > {DK_MAX}: "
                         "not supported by the kernel")
    C0, n0, m0 = _initial(initial, bh, dk, dv, q.device)
    if tuple(C0.shape) != (bh, dk, dv) or tuple(n0.shape) != (bh, dk):
        raise ValueError("initial must be (C0 [bh, dk, dv], n0 [bh, dk], "
                         "m0 [bh, 1])")
    ins = [t.contiguous() for t in (q, k, v, i_gate.float(), f_gate.float(),
                                    C0, n0, m0)]
    for t in ins[1:]:
        if t.device != q.device:
            raise ValueError(f"an input lies on {t.device}, q on {q.device}")
    out = torch.empty((bh, s, dv), dtype=v.dtype, device=q.device)
    C = torch.empty((bh, dk, dv), dtype=torch.float32, device=q.device)
    n = torch.empty((bh, dk), dtype=torch.float32, device=q.device)
    m = torch.empty((bh,), dtype=torch.float32, device=q.device)
    launch, work_floats = _bound()
    nwork = int(work_floats(bh, s, dk, dv, c))
    if nwork < 0:
        raise ValueError(f"mLSTM scan of q {tuple(q.shape)}, v "
                         f"{tuple(v.shape)}, chunk {c}: not supported by "
                         "the kernel")
    # the per-(head, chunk) records the first kernel leaves to the second
    work = torch.empty((nwork,), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    body = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        rc = launch(*(build.ptr(t) for t in ins + [out, C, n, m, work]),
                    bh, s, dk, dv, c, _DTYPES[q.dtype],
                    ctypes.c_float(1.0 / np.sqrt(dk)), ctypes.byref(body),
                    ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"mlstm_scan_launch failed (code {rc}; -1 = shape not "
            f"supported) for q {tuple(q.shape)}, v {tuple(v.shape)}, chunk "
            f"{c}")
    launches += 1
    last_body = BODIES[body.value]
    return out, (C, n, m[:, None])
