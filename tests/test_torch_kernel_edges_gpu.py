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
  runs many waves; then, bf16 and fp32 (the CUDA-core kernel of
  ``csrc/flash_attention.cu``, rtol = atol = 2e-4), head dim 256 at
  recurrentgemma-2b's 10 query heads over 1 kv head (T = 1, 100, 129, a
  2,048-key window, non-causal 100 x 300) and the head maps of yi-34b
  (56/8), deepseek-67b (64/8), mistral-large (96/8) and qwen2-vl (12/2);
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
  and rows with fewer nonzeros than kb;
- the decision's clusters on flat leaves (``csrc/lbgm_sparse_decision.cu``)
  against its plain version exactly, both orders, fp32 and bf16: the FCN's
  four leaves, the cluster's slice edges, ties across CTAs, a size that is
  not a multiple of 4, partly live rows with fewer nonzeros than kb, kb = 1
  and kb = block, an all-zero live row; the flat form equal to the padded
  layout and a second call to the first, bit for bit; value order with
  each placement of the kept keys forced (ranks or rank 0's bitonic sort);
- the projection's leaf table (``csrc/lbgm_projection.cu``): one call equal
  to the left-to-right sum of one-leaf calls bit for bit, with misaligned
  leaves and more leaves than one launch's table.
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


# (B, Tq, Tk, Hq, Hkv, hd, causal, window): head dim 256 (recurrentgemma's
# local attention) and the zoo's head maps
FLASH_ZOO = [
    (2, 1, 1, 10, 1, 256, True, None),
    (2, 100, 100, 10, 1, 256, True, None),
    (2, 129, 129, 10, 1, 256, True, 2048),
    (1, 2200, 2200, 10, 1, 256, True, 2048),      # the window masks
    (2, 100, 300, 10, 1, 256, False, None),
    (2, 257, 257, 56, 8, 128, True, None),        # yi-34b: groups of 7
    (2, 200, 200, 64, 8, 128, True, None),        # deepseek-67b
    (2, 129, 129, 96, 8, 128, True, None),        # mistral-large: 12
    (2, 300, 300, 12, 2, 128, True, None),        # qwen2-vl: 6
    (2, 257, 257, 48, 8, 128, True, 4096),        # mixtral: 6
    (2, 257, 257, 40, 8, 128, True, None),        # llama4: 5
]
FLASH_TOL_FP32 = 2e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", FLASH_ZOO)
def test_flash_zoo_head_dims_and_maps(card, case, dtype):
    B, Tq, Tk, Hq, Hkv, hd, causal, window = case
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(sum(case[:6]))
    q, k, v = (torch.from_numpy(rng.randn(B, T, H, hd).astype(np.float32))
               .to(dt).to(card)
               for T, H in ((Tq, Hq), (Tk, Hkv), (Tk, Hkv)))
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_gqa_ref(q.float(), k.float(), v.float(),
                                       causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == q.shape
    assert torch.isfinite(got).all()
    tol = (dict(rtol=RTOL_BF16, atol=ATOL_BF16) if dt == torch.bfloat16
           else dict(rtol=FLASH_TOL_FP32, atol=FLASH_TOL_FP32))
    torch.testing.assert_close(got.float(), want, **tol)


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


# ------------------------------------ the decision's clusters, flat leaves

def _decision_case(rng, B, size, block, kb, kind):
    """A flat leaf (B, size) of ``kind``, its nb (rounded up to 16 past one
    row, as the engine's layout), and idx (B, nb, kb)."""
    nb = -(-size // block)
    nb = -(-nb // 16) * 16 if nb > 1 else nb
    x = rng.randn(B, size).astype(np.float32)
    if kind == "ties":
        x = np.round(x * 2) / 2
    elif kind == "zero_row":          # client 0's first row all zero
        x[0, :block] = 0.0
    elif kind == "sparse":            # fewer nonzeros than kb in a row
        x = np.where(rng.rand(B, size) < 0.002, x, 0.0)
    elif kind == "slice_edges":       # the largest at the cluster's edges
        for e in range(8192, block, 8192):
            for p in (e - 1, e):
                if p < size:
                    x[:, p] = 50.0 + p / block
    elif kind == "dense_zeros":       # zeros few enough to be gathered
        x = np.where(rng.rand(B, size) < 0.06, 0.0, x)
    elif kind == "straddle":          # one magnitude across CTA slices
        x = np.where(rng.rand(B, size) < 0.03, 1.0, 0.0)
        x[:, ::4096] = -1.0
    idx = np.argsort(rng.rand(B, nb, block), -1)[..., :kb]
    return x.astype(np.float32), idx.astype(np.int32), nb


# (B, size, block, kb, kind)
CLUSTER_EDGES = [
    (10, 100352, 65536, 627, "normal"),    # fc1/w at a chunk of 10
    (10, 1280, 1280, 128, "normal"),       # fc2/w: a cluster of 1
    (10, 128, 128, 12, "normal"),          # fc1/b
    (10, 10, 10, 1, "normal"),             # fc2/b: 40-byte rows
    (3, 100353, 65536, 627, "normal"),     # size % 4 != 0: ragged slices
    (2, 70001, 65536, 2000, "ties"),
    (2, 131072, 65536, 900, "slice_edges"),
    (2, 131072, 65536, 700, "straddle"),   # ties across CTAs
    (2, 65536 + 100, 65536, 300, "sparse"),  # virtual zeros fill the row
    (2, 65536 + 5, 65536, 40, "normal"),   # 5 live elements, kb > 5
    (2, 131072, 65536, 1, "normal"),       # kb = 1
    (2, 65536, 65536, 65536, "ties"),      # kb = block
    (2, 36864, 36864, 3686, "zero_row"),   # CNN conv3/w: 5 CTAs
    (1, 8193, 8193, 77, "straddle"),       # a cluster of 2, one past 8192
    # kb past the nonzeros: the threshold is 0, and the zeros, 100 of them
    # virtual, are few enough for rank 0 to gather
    (1, 131072 - 100, 65536, 62000, "dense_zeros"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("two_pass", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CLUSTER_EDGES, ids=str)
def test_decision_clusters_match_plain(card, case, dtype, two_pass):
    """The flat-leaf decision on the card against its plain version: the
    index sets and orders exactly, the values exactly, ||g||^2 to rtol
    1e-5; the flat form equals the zero-padded layout bit for bit, and a
    second call (the per-client tickets reset) the first."""
    B, size, block, kb, kind = case
    rng = np.random.RandomState(size + kb)
    x, idx, nb = _decision_case(rng, B, size, block, kb, kind)
    g = torch.from_numpy(x).to(getattr(torch, dtype)).to(card)
    ti_ = torch.from_numpy(idx).to(card)
    got = ks.lbgm_sparse_decision_batched(g, ti_, two_pass, block=block)
    fn = (ref.lbgm_sparse_decision_two_pass_ref if two_pass
          else ref.lbgm_sparse_decision_ref)
    want = fn(g, ti_, block=block)
    padded = ks.lbgm_sparse_decision_batched(
        ref.flat_to_blocks(g, nb, block).contiguous(), ti_, two_pass)
    again = ks.lbgm_sparse_decision_batched(g, ti_, two_pass, block=block)
    torch.cuda.synchronize()
    assert torch.equal(got[2], want[2])
    assert torch.equal(got[3], want[3]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
    for a, b, c in zip(got, padded, again):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.gpu
@pytest.mark.parametrize("placement", ["rank", "sort"])
@pytest.mark.parametrize("case", [c for c in CLUSTER_EDGES
                                  if c[3] <= 16384], ids=str)
def test_value_order_placements_match_plain(card, case, placement):
    """Value order with each placement of a row's kept keys forced (ranks
    counted in every CTA of the cluster, or rank 0's bitonic sort) against
    the plain version exactly, on the cluster edge cases."""
    B, size, block, kb, kind = case
    rng = np.random.RandomState(size + kb + 1)
    x, idx, nb = _decision_case(rng, B, size, block, kb, kind)
    g = torch.from_numpy(x).to(card)
    ti_ = torch.from_numpy(idx).to(card)
    ks.set_placement(placement)
    try:
        got = ks.lbgm_sparse_decision_batched(g, ti_, block=block)
    finally:
        ks.set_placement("rule")
    want = ref.lbgm_sparse_decision_ref(g, ti_, block=block)
    torch.cuda.synchronize()
    assert torch.equal(got[2], want[2])
    assert torch.equal(got[3], want[3]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)


# ---------------------------------------- the projection's leaf table

def _leaves(rng, B, ns, dtype, card, misaligned=False):
    out = []
    for n in ns:
        if misaligned:   # contiguous views one element past an alignment
            flat = torch.from_numpy(rng.randn(B * n + 1).astype(np.float32))
            t = flat.to(dtype).to(card)[1:].view(B, n)
        else:
            t = torch.from_numpy(rng.randn(B, n).astype(np.float32)).to(
                dtype).to(card)
        out.append(t)
    return out


# (B, leaf lengths, misaligned)
PROJ_TABLES = [
    (10, (128, 100352, 10, 1280), False),          # the FCN, sorted keys
    (10, (800, 32, 18432, 64, 36864, 64, 31360, 10, 1, 4096), False),
    (3, (17, 4097, 100352, 5), True),              # no 16-byte loads
    (2, tuple(range(1, 140, 2)), False),           # 70 leaves: 2 launches
    (1, (100352,), False),                         # the unbatched form
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PROJ_TABLES, ids=str)
def test_projection_leaf_table_equals_per_leaf_calls(card, case, dtype):
    """One call over a leaf table equals, bit for bit, the left-to-right
    sum of one-leaf calls, and a second call the first; both hold against
    the plain version to 1e-5 of the sum of |terms|."""
    from repro_torch.kernels import lbgm_projection as kp
    B, ns, misaligned = case
    rng = np.random.RandomState(len(ns) + B)
    dt = getattr(torch, dtype)
    gs = _leaves(rng, B, ns, dt, card, misaligned)
    ls = _leaves(rng, B, ns, dt, card, misaligned)
    got = kp.lbgm_projection_leaves(gs, ls)
    again = kp.lbgm_projection_leaves(gs, ls)
    want = None
    for g, l in zip(gs, ls):
        part = kp.lbgm_projection_batched(g, l)
        want = part if want is None else tuple(
            a + b for a, b in zip(want, part))
    plain = kp.lbgm_projection_leaves([g.cpu() for g in gs],
                                      [l.cpu() for l in ls])
    scale = kp.lbgm_projection_leaves([g.abs().cpu() for g in gs],
                                      [l.abs().cpu() for l in ls])
    torch.cuda.synchronize()
    for a, w, c, p, s in zip(got, want, again, plain, scale):
        assert torch.equal(a, w) and torch.equal(a, c)
        assert bool(((a.cpu() - p).abs() <= 1e-5 * s + 1e-30).all())
