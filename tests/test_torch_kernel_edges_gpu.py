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
  a NaN phantom client.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import lbgm_sparse as ks  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

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
