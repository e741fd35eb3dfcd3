"""The port's models/model.py and runtime/serve_step.py against the
reference package's: logits of a chunk and of a decode step with converted
bf16 weights, and the paged pool's leaves."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ModelSettings as JMS, apply as japply
from repro.models.attention import AttnSettings as JAS
from repro.runtime import serve_step as JSS
from repro_torch.models import ModelSettings, apply, init_params
from repro_torch.models.attention import AttnSettings
from repro_torch.runtime import serve_step as SS

from _torch_parity import model_pair, t_np, to_np

ATOL = 5e-2     # f32 logits of a bf16 model: bf16 roundings through 2 layers


def _check_logits(lt, lj):
    lt, lj = np.asarray(lt, np.float32), np.asarray(lj, np.float32)
    np.testing.assert_allclose(lt, lj, atol=ATOL, rtol=0)
    top2 = np.sort(lj, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > ATOL
    assert decided.any()
    np.testing.assert_array_equal(lt.argmax(-1)[decided],
                                  lj.argmax(-1)[decided])


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("backend", ["kernel", "naive"])
def test_apply_chunk_then_decode_logits(quant, backend):
    cj, pj, ct, pt = model_pair(depth=2)
    assert ct.n_layers == 2 and ct.repeats == 2
    bs, n_blocks, context, b, C = 4, 9, 16, 2, 8
    pool_j = JSS.init_paged_pool(cj, b, n_blocks, bs, context, kv_quant=quant)
    pool_t = SS.init_paged_pool(ct, b, n_blocks, bs, context, kv_quant=quant,
                                device="cpu")
    jset = JMS(attn=JAS(backend="pallas" if backend == "kernel" else "naive"),
               build_cache=True)
    tset = ModelSettings(attn=AttnSettings(backend=backend))
    rng = np.random.default_rng(4)
    toks = rng.integers(2, cj.vocab_size, (b, C)).astype(np.int32)
    pos = np.full((b, C), -1, np.int32)
    pos[0] = np.arange(C)
    pos[1, :5] = np.arange(5)
    tables = np.asarray([[1, 2, 3, -1], [4, 5, -1, -1]], np.int32)
    lj, pool_j, _ = japply(pj, cj, jnp.asarray(toks),
                           positions=jnp.asarray(pos), cache=pool_j,
                           settings=jset, context=context,
                           block_tables=jnp.asarray(tables))
    lt, pool_t2, _ = apply(pt, ct, torch.from_numpy(toks),
                           positions=torch.from_numpy(pos), cache=pool_t,
                           settings=tset, context=context,
                           block_tables=torch.from_numpy(tables))
    assert pool_t2 is pool_t and lt.dtype == torch.float32
    valid = pos >= 0
    _check_logits(lt.numpy()[valid], np.asarray(lj)[valid])
    # head_rows: only each row's last valid position through the head
    lt_last, _, _ = apply(pt, ct, torch.from_numpy(toks),
                          positions=torch.from_numpy(pos),
                          cache=SS.init_paged_pool(ct, b, n_blocks, bs,
                                                   context, kv_quant=quant,
                                                   device="cpu"),
                          settings=tset, context=context,
                          block_tables=torch.from_numpy(tables),
                          head_rows=torch.tensor([7, 4]))
    np.testing.assert_allclose(lt_last[:, 0].numpy(),
                               lt.numpy()[[0, 1], [7, 4]], atol=1e-5, rtol=0)

    # ---- one decode step on top of the chunk
    tok1 = rng.integers(2, cj.vocab_size, (b, 1)).astype(np.int32)
    pos1 = np.asarray([8, 5], np.int32)
    lj1, _, _ = japply(pj, cj, jnp.asarray(tok1), positions=jnp.asarray(pos1),
                       cache=pool_j, decode=True, settings=jset,
                       context=context, block_tables=jnp.asarray(tables))
    lt1, _, _ = apply(pt, ct, torch.from_numpy(tok1),
                      positions=torch.from_numpy(pos1), cache=pool_t,
                      decode=True, settings=tset, context=context,
                      block_tables=torch.from_numpy(tables))
    _check_logits(lt1.numpy(), np.asarray(lj1))


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_init_paged_pool_leaves_equal(quant):
    cj, _, ct, _ = model_pair(depth=2)
    pj = JSS.init_paged_pool(cj, 3, 7, 4, 16, kv_quant=quant)
    pt = SS.init_paged_pool(ct, 3, 7, 4, 16, kv_quant=quant, device="cpu")
    assert len(pt["units"]) == len(pj["units"]) == 1 and pt["tail"] == []
    leaves_j, leaves_t = pj["units"][0], pt["units"][0]
    assert sorted(leaves_j) == sorted(leaves_t)
    for n, a in leaves_j.items():
        t = leaves_t[n]
        assert tuple(t.shape) == tuple(a.shape), n
        assert str(t.dtype).replace("torch.", "") == str(a.dtype), n
        np.testing.assert_array_equal(t_np(t), to_np(a))
    assert SS.pool_block_size(pt) == JSS.pool_block_size(pj) == 4
    with pytest.raises(ValueError):
        SS.init_paged_pool(ct, 3, 7, 4, 18, device="cpu")


def test_pool_operations_in_place():
    _, _, ct, _ = model_pair(depth=2)
    pool = SS.init_paged_pool(ct, 2, 6, 4, 16, device="cpu")
    leaf = pool["units"][0]
    leaf["pos"][:, 2] = 5
    leaf["pos"][:, 3] = 6
    leaf["kb"][:, 3] = 1.0
    out = SS.reset_pool_blocks(pool, torch.tensor([2, 0], dtype=torch.int32))
    assert out is pool
    assert int(leaf["pos"][:, 2].max()) == -1 and int(leaf["pos"][0, 3, 0]) == 6
    sub = SS.gather_pool_lanes(pool, torch.tensor([1, 2]))
    assert sub["units"][0]["kb"] is leaf["kb"]     # shared, not copied
    assert SS.scatter_pool_lanes(pool, sub, torch.tensor([1, 2]))[
        "units"][0]["kb"] is leaf["kb"]
    SS.clear_pool(pool)
    assert int(leaf["pos"].max()) == -1 and float(leaf["kb"].abs().sum()) == 0


def test_init_params_layout_and_device_rule():
    cj, pj, ct, pt = model_pair(depth=2)
    gen = torch.Generator(device="cpu").manual_seed(0)
    mine = init_params(gen, ct, device="cpu")
    flat_j = jax.tree_util.tree_leaves_with_path(pj)
    names = {jax.tree_util.keystr(p): a for p, a in flat_j}

    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from walk(v, f"{prefix}['{k}']")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from walk(v, f"{prefix}[{i}]")
        else:
            yield prefix, tree

    got = dict(walk(mine))
    assert sorted(got) == sorted(names)
    for n, t in got.items():
        assert tuple(t.shape) == tuple(names[n].shape), n
        assert t.dtype == torch.bfloat16, n
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            init_params(gen, ct)                  # default device is CUDA
        with pytest.raises(RuntimeError, match="cuda"):
            SS.init_paged_pool(ct, 2, 6, 4, 16)


def test_unported_paths_raise_by_name():
    from repro_torch.configs import get_config
    _, _, ct, pt = model_pair()
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="flash_attention_fwd"):
        apply(pt, ct, toks)
    gen = torch.Generator(device="cpu").manual_seed(0)
    with pytest.raises(NotImplementedError, match="recurrent"):
        init_params(gen, get_config("xlstm-1.3b").reduced(), device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        init_params(gen, get_config("mixtral-8x7b").reduced(), device="cpu")
    with pytest.raises(NotImplementedError, match="ring/slot"):
        SS.init_paged_pool(get_config("gemma3-12b").reduced(), 2, 6, 4, 16,
                           device="cpu")


def test_convert_device_rule():
    """The hand-over functions default to CUDA like every entry point and
    take the CPU only when asked."""
    from repro_torch.convert import params_from_jax, pool_from_jax
    tree = {"w": np.ones((2, 3), np.float32), "i": np.arange(3, dtype=np.int32)}
    got = params_from_jax(tree, "bfloat16", device="cpu")
    assert got["w"].dtype == torch.bfloat16 and got["i"].dtype == torch.int32
    pool = pool_from_jax({"units": [{"kb": np.ones((2, 4, 1, 2), np.float32),
                                     "pos": np.full((2, 4), -1, np.int32)}],
                          "tail": []}, device="cpu")
    assert pool["units"][0]["kb"].dtype == torch.bfloat16
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            params_from_jax(tree)
        with pytest.raises(RuntimeError, match="cuda"):
            pool_from_jax({"units": [], "tail": []})
