"""The two-pass decomposition of the mLSTM scan kernel (csrc/mlstm_scan.cu),
transcribed in PyTorch and held on the CPU against the reference package's
scan kernel (kernels/mlstm_scan.py, mlstm_scan_fwd in interpret mode):

- pass 1, once per (folded head, chunk), from the chunk's own inputs and
  the stabiliser m entering it, which is worked out from the gates and m0
  alone: m_t, e_t, a_u, the decay, the weighted scores sw = (q k^T) o w
  (u <= t) with their row sums, and sum_u k_u a_u;
- pass 2, per 32-column tile of dv, the state products over the chunks:
  q C and q.n, out = (e q C + sw v) / den, C <- decay C + k^T (a v),
  n <- decay n + sum_u k a.

1/sqrt(dk) scales the f32 products (q k^T, q C, q.n), as the kernels'
tensor-core bodies apply it, and not q. The bf16 body's rounding is
modelled too: bf16 q, k, v; each f32 operand of a tensor-core product (C
in q C, sw in sw v, a v in the C update) split into bf16 hi + lo halves;
products exact, sums in f32. Tolerances: f32 1e-4 of the value plus 1e-4
of the tensor's largest |value| (phase 2's RTOL_ML; the reference kernel
test's own is 1e-4); bf16 out within 1e-3 + 2^-7 of its value (phase 2's
TOL_BF16, RTOL_BF16), the f32 state within RTOL_ML."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.mlstm_scan import mlstm_scan_fwd as jax_scan

NEG_INF = -1e30
RTOL_ML = 1e-4
TOL_BF16, RTOL_BF16 = 1e-3, 2.0 ** -7
TV = 32                                   # dv columns of a pass-2 tile


def _bf(x):
    return x.to(torch.bfloat16).float()


def _operand(x, split):
    """An f32 operand as a product takes it: as it is (None), as the
    tensor-core body feeds it ("hilo": bf16 hi + lo), or rounded once to
    bf16 ("hi")."""
    if split is None:
        return x
    hi = _bf(x)
    return hi + _bf(x - hi) if split == "hilo" else hi


def _gates(ig, fg, m0, c):
    """Per chunk, from the gates and m0 alone: g, m_t, e_t, a_u, the decay
    and the m entering the chunk ([bh, nc, c] / [bh, nc])."""
    bh, s = ig.shape
    nc = s // c
    m = m0.clone()
    out = {k: [] for k in ("g", "mt", "e", "a", "decay", "m_in")}
    tri = torch.ones((c, c), dtype=torch.bool).tril()
    for ci in range(nc):
        ic = ig[:, ci * c:(ci + 1) * c]
        g = torch.cumsum(F.logsigmoid(fg[:, ci * c:(ci + 1) * c]), dim=-1)
        dmat = torch.where(tri, g[:, :, None] - g[:, None, :] + ic[:, None],
                           torch.full((1,), NEG_INF))
        mt = torch.maximum(m[:, None] + g, dmat.amax(-1))
        mn = mt[:, -1]
        out["g"].append(g)
        out["mt"].append(mt)
        out["e"].append(torch.exp(m[:, None] + g - mt))
        out["a"].append(torch.exp(g[:, -1:] - g + ic - mn[:, None]))
        out["decay"].append(torch.exp(m + g[:, -1] - mn))
        out["m_in"].append(m)
        m = mn
    return {k: torch.stack(v, 1) for k, v in out.items()}, m


def pass1(q, k, ig, fg, m0, c, scale):
    """What the first kernel leaves in the scratch record of each (head,
    chunk): sw [bh, nc, c, c], its row sums, sum_u k a [bh, nc, dk], and
    the per-position vectors; and m after the scan."""
    bh, s, dk = q.shape
    nc = s // c
    G, m_end = _gates(ig, fg, m0, c)
    qc, kc = q.reshape(bh, nc, c, dk), k.reshape(bh, nc, c, dk)
    tri = torch.ones((c, c), dtype=torch.bool).tril()
    sc = torch.einsum("bntk,bnuk->bntu", qc, kc) * scale
    g, mt = G["g"], G["mt"]
    w = torch.exp(g[..., :, None] - g[..., None, :] + ig.reshape(bh, nc, c)
                  [..., None, :] - mt[..., None])
    sw = torch.where(tri, sc * w, torch.zeros(()))
    kas = (kc * G["a"][..., None]).sum(2)
    return dict(G, sw=sw, qnr=sw.sum(-1), kas=kas), m_end


def pass2(q, k, v, rec, C0, n0, c, scale, split=None):
    """The second kernel: per 32-column tile of dv, C, n and the output
    over the chunks."""
    bh, s, dk = q.shape
    dv = v.shape[-1]
    nc = s // c
    qc, kc = q.reshape(bh, nc, c, dk), k.reshape(bh, nc, c, dk)
    vc = v.reshape(bh, nc, c, dv)
    out = torch.empty((bh, nc, c, dv))
    C = C0.clone()
    n = n0.clone()
    for v0 in range(0, dv, TV):
        Ct = C[..., v0:v0 + TV].clone()
        nt = n0.clone()
        for ci in range(nc):
            e, mt, a = rec["e"][:, ci], rec["mt"][:, ci], rec["a"][:, ci]
            qC = torch.einsum("btk,bkv->btv", qc[:, ci],
                              _operand(Ct, split)) * scale
            qn = torch.einsum("btk,bk->bt", qc[:, ci], nt) * scale
            num = e[..., None] * qC + torch.einsum(
                "btu,buv->btv", _operand(rec["sw"][:, ci], split),
                vc[:, ci, :, v0:v0 + TV])
            den = torch.maximum((e * qn + rec["qnr"][:, ci]).abs(),
                                torch.exp(-mt))
            out[:, ci, :, v0:v0 + TV] = num / den[..., None]
            av = a[..., None] * vc[:, ci, :, v0:v0 + TV]
            Ct = rec["decay"][:, ci, None, None] * Ct + torch.einsum(
                "buk,buv->bkv", kc[:, ci], _operand(av, split))
            nt = rec["decay"][:, ci, None] * nt + rec["kas"][:, ci]
        C[..., v0:v0 + TV] = Ct
        n = nt
    return out.reshape(bh, s, dv), C, n


def twopass(q, k, v, ig, fg, *, chunk, initial=None, split=None):
    """Both passes: (out, (C, n, m [bh, 1])), all f32."""
    bh, s, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk, s)
    scale = float(1.0 / np.sqrt(dk))
    if initial is None:
        C0, n0 = torch.zeros((bh, dk, dv)), torch.zeros((bh, dk))
        m0 = torch.full((bh,), NEG_INF)
    else:
        C0, n0, m0 = initial[0], initial[1], initial[2].reshape(bh)
    rec, m = pass1(q, k, ig, fg, m0, c, scale)
    out, C, n = pass2(q, k, v, rec, C0, n0, c, scale, split)
    return out, (C, n, m[:, None])


def _case(seed, bh, s, dk, dv, *, initial=False, fresh=(), pad_tail=0,
          pad_rows=(), bf16=False):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((bh, s, dk)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((bh, s, dk)) * 0.5).astype(np.float32)
    v = rng.standard_normal((bh, s, dv)).astype(np.float32)
    ig = rng.standard_normal((bh, s)).astype(np.float32)
    fg = (rng.standard_normal((bh, s)) + 2.0).astype(np.float32)
    if pad_tail:
        ig[:, s - pad_tail:], fg[:, s - pad_tail:] = NEG_INF, 1e4
    for r in pad_rows:
        ig[r], fg[r] = NEG_INF, 1e4
    if bf16:
        q, k, v = (_bf(torch.from_numpy(x)).numpy() for x in (q, k, v))
    init = None
    if initial:
        C0 = rng.standard_normal((bh, dk, dv)).astype(np.float32)
        n0 = np.abs(rng.standard_normal((bh, dk))).astype(np.float32)
        m0 = rng.standard_normal((bh, 1)).astype(np.float32)
        for r in fresh:
            C0[r], n0[r], m0[r] = 0.0, 0.0, NEG_INF
        init = (C0, n0, m0)
    return (q, k, v, ig, fg), init


def _reference(arrs, chunk, init):
    out, st = jax_scan(*(jnp.asarray(a) for a in arrs), chunk=chunk,
                       interpret=True,
                       initial=None if init is None else tuple(
                           jnp.asarray(x) for x in init))
    return [np.array(out)] + [np.array(x) for x in st]


def _mine(arrs, chunk, init, split=None):
    t = [torch.from_numpy(a) for a in arrs]
    it = None if init is None else tuple(torch.from_numpy(x) for x in init)
    out, st = twopass(*t, chunk=chunk, initial=it, split=split)
    return [out.numpy()] + [x.numpy() for x in st]


def _close_rel(got, want, name):
    """Within RTOL_ML of the value plus RTOL_ML of the row's largest
    |value| (phase 2's check_rel)."""
    head = np.abs(want).reshape(want.shape[0], -1).max(1)
    head = head.reshape((-1,) + (1,) * (want.ndim - 1))
    np.testing.assert_array_less(np.abs(got - want),
                                 RTOL_ML * (np.abs(want) + head) + 1e-30,
                                 err_msg=name)


# (seed, bh, s, dk, dv, chunk, case options): dk != dv, several chunks, a
# chunk of 96 (three score tiles), a single chunk of 9, the initial carry,
# fresh rows, padded tails and padding-only rows, dv not a multiple of 32
CASES = {
    "fresh 4 chunks dk16 dv24": (1, 2, 128, 16, 24, 32, {}),
    "initial dk8 dv40 2 chunks": (2, 3, 64, 8, 40, 32, dict(initial=True)),
    "fresh rows padded tail c96": (3, 3, 192, 20, 36, 96,
                                   dict(initial=True, fresh=(1,),
                                        pad_tail=11)),
    "padding-only rows": (4, 3, 32, 16, 16, 16,
                          dict(initial=True, fresh=(2,), pad_rows=(1, 2))),
    "one chunk of 9": (5, 2, 9, 12, 70, 128, dict(initial=True)),
}


@pytest.fixture(scope="module")
def references():
    """The reference kernel's results of every case, computed once."""
    out = {}
    for name, (seed, bh, s, dk, dv, chunk, kw) in CASES.items():
        arrs, init = _case(seed, bh, s, dk, dv, **kw)
        out[name] = (arrs, init, chunk, _reference(arrs, chunk, init))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_passes_equal_the_reference_scan(name, references):
    arrs, init, chunk, want = references[name]
    got = _mine(arrs, chunk, init)
    for g, w, nm in zip(got, want, ("out", "C", "n", "m")):
        assert g.shape == w.shape, nm
        _close_rel(g, w, nm)
    kw = CASES[name][-1]
    for r in kw.get("pad_rows", ()):
        if r in kw.get("fresh", ()):
            # a padding-only row from a fresh state: exp(1e30) = inf in the
            # denominator gives exact zeros, on both sides
            assert np.all(got[0][r] == 0.0) and np.all(want[0][r] == 0.0)


def test_m_chain_needs_only_the_gates(references):
    """The m the chunks carry, from the gates and m0 alone, equals the m
    the reference's scan ends with when q, k and v are replaced by other
    values (they do not enter it); m entering each chunk is the m out of
    the one before."""
    arrs, init, chunk, _ = references["initial dk8 dv40 2 chunks"]
    G, m_end = _gates(torch.from_numpy(arrs[3]), torch.from_numpy(arrs[4]),
                      torch.from_numpy(init[2]).reshape(-1), chunk)
    rng = np.random.default_rng(70)
    other = [rng.standard_normal(a.shape).astype(np.float32)
             for a in arrs[:3]]
    want = _reference(other + list(arrs[3:]), chunk, init)
    np.testing.assert_allclose(m_end.numpy(), want[3][:, 0], rtol=1e-6)
    np.testing.assert_array_equal(G["m_in"][:, 1], G["mt"][:, 0, -1])


@pytest.mark.parametrize("dk", [16, 20, 1024])
def test_scaling_the_product_instead_of_q(dk):
    """(q k^T) / sqrt(dk), as the tensor-core bodies scale, against
    (q / sqrt(dk)) k^T, as the reference does: equal bit for bit where the
    scale is a power of two (dk = 16, 1024: exact in any order), within a
    few f32 units otherwise."""
    rng = np.random.default_rng(dk)
    q = _bf(torch.from_numpy(rng.standard_normal((64, dk), np.float32)))
    k = _bf(torch.from_numpy(rng.standard_normal((64, dk), np.float32)))
    scale = float(1.0 / np.sqrt(dk))
    after = (q @ k.T) * scale
    before = (q * scale) @ k.T
    if dk in (16, 1024):
        assert torch.equal(after, before)
    else:
        np.testing.assert_allclose(after.numpy(), before.numpy(),
                                   rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def bf16_case():
    """A carried state over bf16 inputs (chunk 64, two chunks) and the
    reference kernel's result for it, computed once."""
    arrs, init = _case(8, 3, 128, 32, 40, initial=True, fresh=(1,),
                       pad_tail=9, bf16=True)
    return arrs, init, _reference(arrs, 64, init)


def test_tensor_core_rounding_within_phase_two_bounds(bf16_case):
    """The bf16 body's rounding: bf16 q, k, v, every f32 operand of a
    tensor-core product split into hi + lo halves. out (rounded to bf16 on
    both sides) within phase 2's bf16 bound, the state within RTOL_ML."""
    arrs, init, want = bf16_case
    got = _mine(arrs, 64, init, split="hilo")
    o_got = _bf(torch.from_numpy(got[0])).numpy()
    o_want = _bf(torch.from_numpy(want[0])).numpy()
    np.testing.assert_allclose(o_got, o_want, atol=TOL_BF16, rtol=RTOL_BF16)
    for g, w, nm in zip(got[1:], want[1:], ("C", "n", "m")):
        _close_rel(g, w, nm)


def test_hi_lo_split_is_needed_for_the_state(bf16_case):
    """With the f32 operands rounded once to bf16 (no lo half), the C
    update leaves phase 2's RTOL_ML bound on the carried state: the split
    is what keeps the tensor-core body inside it."""
    arrs, init, want = bf16_case
    head = np.abs(want[1]).reshape(want[1].shape[0], -1).max(1)
    bound = RTOL_ML * (np.abs(want[1]) + head[:, None, None])
    C_hilo = _mine(arrs, 64, init, split="hilo")[1]
    C_hi = _mine(arrs, 64, init, split="hi")[1]
    assert (np.abs(C_hilo - want[1]) <= bound).all()
    assert (np.abs(C_hi - want[1]) > bound).any()
