"""Edge cases of the tensor-core flash kernel and the segmented dequant fold,
on the card.

Marked ``gpu``: they skip without a CUDA card (the ``card`` fixture decides,
never the import) and run on the H100 with
``python -m pytest -q -m gpu tests/test_torch_kernel_edges_gpu.py``.

- flash attention, bf16 (``csrc/flash_attention_sm90.cu``) against the fp32
  plain version of the same inputs, per element within one bf16 ulp
  (rtol 2^-7, atol 1e-5, ``chip_smoke.py``'s tolerance): Tq not a multiple
  of the 128-query tile, Tq != Tk with ``q_offset``, windows that cross key
  tiles, hd 32 and 64, and B * Hq large enough that the heaviest-first grid
  runs many waves;
- the dequant-accumulate fold (``csrc/lbgm_dequant_accum.cu``) against its
  plain version bit for bit (``torch.equal``): indices at SEG - 1, SEG and
  block - 1, one-row leaves with block < SEG, every client on one position,
  a NaN phantom client;
- the RWKV6 scan (``csrc/rwkv6_scan.cu``: the tensor-core prefill kernel
  and the T = 1 decode kernel) against its chunked plain version at rtol =
  atol = 1e-4, output and final state (``chip_smoke.py``'s tolerance), and
  against the per-step recurrence at 1e-3 where that applies: T = 1, 63,
  64, 65, 129 and 4096 (chunk edges, a short last chunk), hd 32, B * H = 1
  and 8 * 40, a random state, decays that reach the exp(-cum) clamp and go
  far past it; the state updated in place (``state_out=state0``) equals the
  fresh state bit for bit;
- the value-order sparse decision past its shared-memory sort (kb = 16385,
  32768, 65536: the keys sorted in a global scratch buffer by tiles and
  merge passes) against its plain version exactly, with ties, all-zero rows
  and rows with fewer nonzeros than kb.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import lbgm_sparse as ks  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rs  # noqa: E402

RTOL_BF16, ATOL_BF16 = 2.0 ** -7, 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    return torch.device("cuda")


# (B, Tq, Tk, Hq, Hkv, hd, causal, window, q_offset)
FLASH_EDGES = [
    (2, 129, 129, 4, 2, 128, True, None, 0),     # one row into a 2nd q tile
    (2, 300, 300, 16, 8, 128, True, None, 0),    # Tq % 128 != 0
    (2, 130, 700, 16, 8, 128, True, None, 570),  # Tq != Tk, q_offset
    (2, 100, 300, 16, 8, 128, True, 150, 200),   # offset and window
    (1, 200, 200, 8, 8, 64, True, 150, 0),       # window across tiles
    (3, 257, 257, 12, 4, 128, True, 200, 0),
    (2, 300, 300, 4, 2, 32, True, 130, 0),       # hd 32
    (2, 260, 260, 4, 1, 64, True, None, 0),      # hd 64, GQA 4
    (2, 64, 65, 4, 2, 64, False, None, 0),       # one key past a tile
    (2, 1, 1, 4, 2, 32, True, None, 0),
    (8, 640, 640, 32, 8, 64, True, None, 0),     # 1,280 CTAs: many waves
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_EDGES)
def test_flash_bf16_edges(card, case):
    B, Tq, Tk, Hq, Hkv, hd, causal, window, off = case
    rng = np.random.RandomState(sum(case[:6]))
    q, k, v = (torch.from_numpy(rng.randn(B, T, H, hd).astype(np.float32))
               .bfloat16().to(card)
               for T, H in ((Tq, Hq), (Tk, Hkv), (Tk, Hkv)))
    got = fa.flash_attention(q, k, v, causal=causal, window=window,
                             q_offset=off)
    want = ref.flash_attention_gqa_ref(q.float(), k.float(), v.float(),
                                       causal=causal, window=window,
                                       q_offset=off)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want, rtol=RTOL_BF16,
                               atol=ATOL_BF16)


def _dequant_inputs(rng, C, nb, block, kb, qdtype, kind):
    """CPU inputs; ``kind``: "edges" puts SEG - 1, SEG, block - 1 and 0 (in
    the row) first in every client's indices, "one" puts every client on
    one position (kb = 1), "phantom" gives client 1 w = 0, a NaN gscale
    and NaN values (fp8)."""
    seg = ks.DEQUANT_SEG
    acc = torch.from_numpy(rng.randn(nb, block).astype(np.float32))
    w = torch.from_numpy(rng.rand(C).astype(np.float32)) / C
    gscale = torch.from_numpy(rng.rand(C).astype(np.float32) * 2 - 0.5)
    keys = rng.rand(C, nb, block)
    if kind == "edges":
        for pos in (seg - 1, seg, block - 1, 0):
            if pos < block:
                keys[..., pos] = -1.0
    if kind == "one":
        keys[:] = keys[:1]
    idx = torch.from_numpy(np.argsort(keys, -1)[..., :kb].astype(np.int32))
    if qdtype == torch.int8:
        qv = torch.from_numpy(rng.randint(-127, 128, (C, nb, kb))
                              .astype(np.int8))
    else:
        qv = torch.from_numpy(np.clip(rng.randn(C, nb, kb) * 100, -448, 448)
                              .astype(np.float32)).to(qdtype)
    scale = torch.ldexp(torch.ones(C, nb, 1), torch.from_numpy(
        rng.randint(-20, 2, (C, nb, 1))))
    if kind == "phantom":
        w[1], gscale[1] = 0.0, float("nan")
        if qdtype != torch.int8:
            qv[1] = torch.full((nb, kb), float("nan")).to(qdtype)
    return acc, w, gscale, idx, qv, scale


# (C, nb, block, kb, kind)
DEQUANT_EDGES = [
    (10, 2, 8193, 5, "edges"),     # SEG - 1, SEG, block - 1; 3 segments
    (10, 1, 4096, 3, "edges"),     # block == SEG: SEG lies outside the row
    (10, 3, 4097, 4, "edges"),     # a one-float last segment
    (10, 1, 100, 7, "edges"),      # one-row leaf, block < SEG
    (10, 1, 10, 1, "one"),         # every client on one position
    (10, 3, 9000, 1, "one"),
    (10, 16, 65536, 627, "phantom"),
    (4, 1, 1000, 37, "phantom"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("qdtype", ["int8", "float8_e4m3fn"])
@pytest.mark.parametrize("case", DEQUANT_EDGES)
def test_dequant_edges_bit_equal(card, case, qdtype):
    C, nb, block, kb, kind = case
    qdt = getattr(torch, qdtype)
    rng = np.random.RandomState(C * block + kb)
    cpu = _dequant_inputs(rng, C, nb, block, kb, qdt, kind)
    dev = [t.to(card) for t in cpu]
    got = ks.lbgm_dequant_accum(dev[0].clone(), *dev[1:])
    plain_card = ref.lbgm_dequant_accum_ref(dev[0].clone(), *dev[1:])
    plain_cpu = ref.lbgm_dequant_accum_ref(cpu[0].clone(), *cpu[1:])
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, plain_card)
    assert torch.equal(got.cpu(), plain_cpu)


# ------------------------------------------------------------ RWKV6 scan

SCAN_TOL_CHUNKED, SCAN_TOL_STEPWISE = 1e-4, 1e-3


def _scan_inputs(rng, B, T, H, hd, decay, state):
    """``mild``: -0.7 sigmoid(N), never at the clamp; ``model``: about -1 a
    step, at the clamp from step 60 of a chunk; ``strong``: about -2 a
    step, past it from step 30 (-cum up to 128)."""
    r, k, v = (rng.randn(B, T, H, hd).astype(np.float32) * 0.5
               for _ in range(3))
    z = rng.randn(B, T, H, hd)
    logw = {"mild": -0.7 / (1 + np.exp(-z)), "model": -np.exp(0.04 * z),
            "strong": -2 * np.exp(0.04 * z)}[decay].astype(np.float32)
    u = (rng.randn(H, hd) * 0.5).astype(np.float32)
    s0 = (np.zeros((B, H, hd, hd), np.float32) if state == "zeros"
          else (rng.randn(B, H, hd, hd) * 0.5).astype(np.float32))
    return [torch.from_numpy(a) for a in (r, k, v, logw, u, s0)]


# (B, T, H, hd, decay, state)
SCAN_EDGES = [
    (8, 1, 40, 64, "model", "random"),     # decode: B * H = 320
    (1, 1, 1, 64, "model", "random"),      # B * H = 1
    (3, 1, 5, 32, "strong", "random"),
    (2, 63, 4, 64, "mild", "zeros"),       # one short chunk
    (2, 64, 4, 64, "mild", "zeros"),       # one full chunk
    (2, 65, 4, 64, "model", "random"),     # a one-row last chunk
    (2, 129, 4, 32, "mild", "zeros"),      # hd 32, a one-row last chunk
    (2, 129, 4, 32, "strong", "random"),
    (8, 65, 40, 64, "model", "random"),    # prefill at B * H = 320
    (1, 4096, 1, 64, "model", "zeros"),    # B * H = 1, 64 chunks
    (2, 4096, 40, 64, "strong", "random"),
    (1, 4096, 2, 32, "model", "random"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", SCAN_EDGES, ids=str)
def test_scan_edges(card, case):
    B, T, H, hd, decay, state = case
    rng = np.random.RandomState(B * 1000 + T + hd)
    cpu = _scan_inputs(rng, B, T, H, hd, decay, state)
    r, k, v, lw, u, s0 = (t.to(card) for t in cpu)
    out, st = rs.rwkv6_scan(r, k, v, lw, u, s0)
    ro, rst = ref.rwkv6_chunked_ref(r, k, v, lw, u, s0, min(64, T))
    torch.cuda.synchronize()
    assert out.shape == r.shape and st.shape == s0.shape
    assert torch.isfinite(out).all() and torch.isfinite(st).all()
    tol = SCAN_TOL_CHUNKED
    torch.testing.assert_close(out, ro, rtol=tol, atol=tol)
    torch.testing.assert_close(st, rst, rtol=tol, atol=tol)
    if T <= 256 and state == "zeros" and decay == "mild":
        flat = lambda a: a.permute(0, 2, 1, 3).reshape(B * H, T, hd)
        step = ref.rwkv6_scan_ref(flat(r), flat(k), flat(v), flat(lw),
                                  u.repeat(B, 1))
        step = step.reshape(B, H, T, hd).permute(0, 2, 1, 3)
        torch.testing.assert_close(out, step, rtol=SCAN_TOL_STEPWISE,
                                   atol=SCAN_TOL_STEPWISE)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 65])
def test_scan_state_in_place_equals_fresh_state(card, T):
    rng = np.random.RandomState(T)
    r, k, v, lw, u, s0 = (t.to(card) for t in _scan_inputs(
        rng, 8, T, 40, 64, "model", "random"))
    out, st = rs.rwkv6_scan(r, k, v, lw, u, s0)
    cache = s0.clone()
    out2, st2 = rs.rwkv6_scan(r, k, v, lw, u, cache, state_out=cache)
    torch.cuda.synchronize()
    assert st2.data_ptr() == cache.data_ptr()
    assert torch.equal(out, out2) and torch.equal(st, cache)


# ----------------------------------------- value order past 16384 keys

# (B, nb, block, kb, kind)
DECISION_EDGES = [
    (2, 2, 65536, 16385, "normal"),   # one key past the shared-memory sort
    (2, 2, 65536, 32768, "ties"),     # few magnitudes: the index decides
    (1, 3, 65536, 65536, "normal"),   # the whole row
    (2, 2, 65536, 20000, "zeros"),    # all-zero rows
    (2, 2, 40000, 30000, "sparse"),   # fewer nonzeros than kb
    (1, 2, 65536, 65536, "ties"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECISION_EDGES, ids=str)
def test_value_order_decision_past_the_shared_sort(card, case, dtype):
    B, nb, block, kb, kind = case
    rng = np.random.RandomState(kb + block)
    x = rng.randn(B, nb, block).astype(np.float32)
    if kind == "ties":
        x = np.round(x * 2) / 2
    elif kind == "zeros":
        x[:] = 0.0
    elif kind == "sparse":
        x = np.where(rng.rand(B, nb, block) < 0.001, x, 0.0)
    blocks = torch.from_numpy(x.astype(np.float32)).to(
        getattr(torch, dtype)).to(card)
    idx = torch.from_numpy(np.argsort(rng.rand(B, nb, block), -1)[..., :kb]
                           .astype(np.int32)).to(card)
    gg, gath, ti, tv = ks.lbgm_sparse_decision_batched(blocks, idx)
    rgg, rgath, rti, rtv = ref.lbgm_sparse_decision_ref(blocks, idx)
    torch.cuda.synchronize()
    assert torch.equal(ti, rti)
    assert torch.equal(tv, rtv) and torch.equal(gath, rgath)
    torch.testing.assert_close(gg, rgg, rtol=1e-5, atol=0)
