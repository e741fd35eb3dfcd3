"""Shared helpers of the tests/test_torch_*.py parity tests: seeded numpy
inputs handed to both the reference (JAX, on the CPU) package and the
PyTorch port, and conversions between the two."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, pool_from_jax

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def to_np(x):
    """A JAX array as numpy; bf16 goes through float32 (exact)."""
    if x.dtype == jnp.bfloat16:
        return np.asarray(x.astype(jnp.float32))
    return np.asarray(x)


def t_np(t):
    """A torch tensor as numpy; bf16 goes through float32 (exact)."""
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


def tree_np(tree):
    return jax.tree.map(to_np, tree)


def model_pair(arch="mistral-nemo-12b", seed=1, depth=None):
    """(cfg_jax, params_jax, cfg_torch, params_torch): one random reduced
    model on both sides, the port's weights converted from the reference
    package's."""
    from repro.configs.base import depth_variant as jdv
    from repro_torch.configs.base import depth_variant as tdv
    cj, ct = jax_get_config(arch).reduced(), get_config(arch).reduced()
    if depth is not None:
        cj, ct = jdv(cj, depth), tdv(ct, depth)
    pj = jax_init_params(jax.random.PRNGKey(seed), cj)
    pt = params_from_jax(tree_np(pj), ct, "cpu")
    return cj, pj, ct, pt


def paged_case(seed, *, b, K, G, hd, bs, lens, m_blocks, n_blocks,
               dtype="float32", quant="none", shuffle=True):
    """A filled paged pool as numpy: lane i holds positions 0..lens[i]-1 in
    ceil(lens[i]/bs) physical blocks drawn from 1..n_blocks-1 (block 0 is
    left as scratch), tables [b, m_blocks] padded with -1. The pool is
    filled by the reference package's own chunk writer, so codes and scales
    are the reference's. Returns a dict of numpy arrays."""
    from repro.models import attention as JA
    rng = np.random.default_rng(seed)
    L = max(max(lens), 1)
    k = rng.standard_normal((b, L, K, hd)).astype(np.float32)
    v = rng.standard_normal((b, L, K, hd)).astype(np.float32)
    ids = np.arange(1, n_blocks)
    if shuffle:
        rng.shuffle(ids)
    tables = np.full((b, m_blocks), -1, np.int32)
    nxt = 0
    for i, n in enumerate(lens):
        nb = -(-n // bs)
        tables[i, :nb] = ids[nxt:nxt + nb]
        nxt += nb
    pos = np.full((b, L), -1, np.int32)
    for i, n in enumerate(lens):
        pos[i, :n] = np.arange(n)
    jdt = JDT[dtype]
    if quant == "none":
        cache = {"kb": jnp.zeros((n_blocks, bs, K, hd), jdt),
                 "vb": jnp.zeros((n_blocks, bs, K, hd), jdt)}
    else:
        qdt = jnp.int8 if quant == "int8" else jnp.uint8
        qhd = hd if quant == "int8" else hd // 2
        cache = {"kb": jnp.zeros((n_blocks, bs, K, qhd), qdt),
                 "vb": jnp.zeros((n_blocks, bs, K, qhd), qdt),
                 "ks": jnp.zeros((n_blocks, bs, K), jnp.float32),
                 "vs": jnp.zeros((n_blocks, bs, K), jnp.float32)}
    cache["pos"] = jnp.full((n_blocks, bs), -1, jnp.int32)
    cache = JA._paged_write_chunk(cache, jnp.asarray(tables),
                                  jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                                  jnp.asarray(pos))
    out = {n: to_np(a) for n, a in cache.items()}
    out["tables"] = tables
    out["lens"] = np.asarray(lens, np.int32)
    return out


def pool_tensors(case, dtype="float32"):
    """The pool leaves of a paged_case as torch tensors (fresh copies),
    through the port's own hand-over function."""
    leaves = {n: case[n] for n in ("kb", "vb", "ks", "vs", "pos")
              if n in case}
    return pool_from_jax(leaves, "cpu", fp_dtype=TDT[dtype])


def pool_jax(case, dtype="float32"):
    out = {}
    for n in ("kb", "vb", "ks", "vs", "pos"):
        if n not in case:
            continue
        a = jnp.asarray(case[n])
        if n in ("kb", "vb") and case[n].dtype.kind == "f":
            a = a.astype(JDT[dtype])
        out[n] = a
    return out


def ulp_diff_f32(a, b):
    """Distance in float32 units in the last place, elementwise."""
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ai - bi)
