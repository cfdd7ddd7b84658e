"""The port's one-card ``launch/specs``, ``analysis/roofline`` and
``launch/dryrun`` against the JAX package's, on the CPU.

- Specs: the meta tensors of ``abstract_params``, ``abstract_train_state``
  (K = 16) and ``abstract_decode_state`` (``decode_32k``) carry the shapes
  and dtypes of JAX's ``jax.eval_shape`` results, leaf by leaf, for the ten
  assigned archs at full width, with no storage; the batch specs of every
  input shape equal JAX's. The port's host-side counters are Python ints
  (``step``, ``pos``) where JAX keeps int32 scalars.
- Roofline: ``model_flops`` equals JAX's exactly; the four collectives of
  ``tests/test_infra.py``'s HLO snippet, given as records, move what JAX's
  parser finds in the text, kind by kind; the terms are right under the
  H100 constants.
- Dryrun: the counted FLOPs of one reduced arch per kind lie within 1% of
  the closed form (2 x matmul params x tokens, plus the T x T attention
  products and the LM head; training: the matmuls and the head x 3,
  flash's plain backward over the causal band of each block of query
  rows, the CE chunks' recomputed head and the LBGM terms counted from
  shapes); whisper skips
  ``long_500k``; full-width qwen3-1.7b at ``decode_32k`` does not fit one
  card (its 128 x 32768 bf16 cache is 451 GiB).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.analysis import roofline as jrl  # noqa: E402
from repro.configs import active_param_count as jactive  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.launch import specs as jsp  # noqa: E402
from repro_torch.analysis import roofline as rl  # noqa: E402
from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES,  # noqa: E402
                                 active_param_count, get_config)
from repro_torch.kernels.flash_attention import Q_BLOCK  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import specs as sp  # noqa: E402
from test_infra import HLO_SNIPPET  # noqa: E402


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = v
    return out


def _same_leaves(got, want, counters=()):
    """Meta tensors against ShapeDtypeStructs, leaf by leaf; ``counters``
    are the port's Python ints standing for JAX's int32 scalars."""
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if k in counters:
            assert g == 0 and w.shape == () and w.dtype == jnp.int32, k
            continue
        assert g.device.type == "meta", k
        assert tuple(g.shape) == w.shape, (k, g.shape, w.shape)
        assert str(g.dtype).split(".")[-1] == str(w.dtype), (k, g.dtype,
                                                             w.dtype)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_abstract_states_match_jax(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    _same_leaves(sp.abstract_params(cfg)[0], jsp.abstract_params(jcfg)[0])
    _same_leaves(sp.abstract_train_state(cfg, 16)[0],
                 jsp.abstract_train_state(jcfg, 16)[0], counters=("step",))
    shape = INPUT_SHAPES["decode_32k"]
    _same_leaves(sp.abstract_decode_state(cfg, shape.global_batch,
                                          shape.seq_len)[0],
                 jsp.abstract_decode_state(jcfg, shape.global_batch,
                                           shape.seq_len)[0],
                 counters=("pos",))
    for name, shape in INPUT_SHAPES.items():
        if shape.kind == "train":
            _same_leaves(sp.train_batch_specs(cfg, shape, 16),
                         jsp.train_batch_specs(jcfg, shape, 16))
        elif shape.kind == "prefill":
            _same_leaves(sp.prefill_batch_specs(cfg, shape),
                         jsp.prefill_batch_specs(jcfg, shape))
        else:
            _same_leaves({"t": sp.decode_token_spec(shape)},
                         {"t": jsp.decode_token_spec(shape)})


def test_model_flops_equal_jax():
    for arch in ASSIGNED_ARCHS:
        cfg, jcfg = get_config(arch), jget(arch)
        n = active_param_count(cfg)
        assert n == jactive(jcfg)
        for shape in INPUT_SHAPES.values():
            assert rl.model_flops(cfg, shape, n) == jrl.model_flops(
                jcfg, shape, n)


def test_collective_records_move_what_the_hlo_parser_finds():
    want = jrl.collective_bytes(HLO_SNIPPET)
    records = [("all-reduce", rl.shape_bytes("f32", (1024, 256)), 16),
               ("all-gather", rl.shape_bytes("bf16", (512, 128)), 16),
               ("reduce-scatter", rl.shape_bytes("f32", (64,)), 4),
               ("collective-permute", rl.shape_bytes("f32", (32, 32)), 2)]
    got = rl.collective_bytes(records)
    for k in (*rl.COLLECTIVE_OPS, "count", "total"):
        assert got[k] == want[k], k
    assert rl.collective_bytes([("all-reduce", 1 << 20, 1)])["total"] == 0
    with pytest.raises(ValueError):
        rl.collective_bytes([("broadcast", 8, 2)])


def test_report_terms_under_h100_constants():
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.LINK_BW) == (989e12, 3.35e12,
                                                      450e9)
    rep = rl.build_report("a", "s", "m", 4,
                          {"flops": 989e12, "bytes accessed": 6.7e12},
                          [("collective-permute", int(450e9) // 2, 2)],
                          model_flops_global=989e12 * 4 * 0.25)
    assert rep.compute_s == pytest.approx(1.0)
    assert rep.memory_s == pytest.approx(2.0)
    assert rep.collective_s == pytest.approx(0.5)
    assert rep.dominant == "memory"
    assert rep.useful_flops_ratio == pytest.approx(0.25)
    row = rep.row()
    assert row == jrl.RooflineReport(
        "a", "s", "m", 4, 989e12, 6.7e12, 225e9, 989e12).row() | {
        k: row[k] for k in ("compute_s", "memory_s", "collective_s",
                            "dominant")}


def _flash_backward(B, nq, hd, T):
    """Flash's plain backward (``flash_attention_backward``), causal: per
    block of query rows (the largest divisor of T up to ``Q_BLOCK``), 5
    products of 2 hd flops (s, dp, dq, dk, dv) per query row and key of
    the band the block sees."""
    qb = Q_BLOCK
    while T % qb:
        qb -= 1
    pairs = sum(qb * (i0 + qb) for i0 in range(0, T, qb))
    return 10 * hd * B * nq * pairs


def _closed_form(cfg, shape):
    """FLOPs of a step of a dense attention decoder, from its shapes: 2 x
    matmul params x tokens, the T x T products (q.k and p.v, every
    score), the LM head; training: the matmuls and the head x 3, flash's
    forward and its plain backward, the head again (each CE chunk is
    recomputed) and dryrun's stated LBGM terms."""
    d, hd, ff, V = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff, \
        cfg.vocab_size
    nq, nkv, L = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    per_layer = d * nq * hd * 2 + 2 * d * nkv * hd + 3 * d * ff
    B, T = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return 2 * per_layer * L * B + 4 * B * nq * T * hd * L + 2 * d * V * B
    tokens = B * T
    mm = 2 * per_layer * L * tokens
    attn = 4 * B * nq * T * T * hd * L
    if shape.kind == "prefill":
        return mm + attn + 2 * d * V * B
    head = 2 * d * V * tokens
    n = sum(p.numel() for p in sp.abstract_params(cfg)[0].values())
    lbgm = (6 * n + n + n) + 3 * n     # dense store, K = 1
    return (3 * (mm + head) + attn + _flash_backward(B, nq, hd, T) * L
            + head + lbgm)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_dryrun_counts_the_closed_form(shape):
    cfg = get_config("qwen3-1.7b").reduced()
    row = dryrun.lower_pair("qwen3-1.7b", shape, cfg_override=cfg)
    assert row["status"] == "ok" and row["chips"] == 1
    want = _closed_form(cfg, INPUT_SHAPES[shape])
    assert abs(row["hlo_flops_per_dev"] / want - 1) < 0.01, (
        row["hlo_flops_per_dev"], want)
    assert row["compute_s"] == row["hlo_flops_per_dev"] / rl.PEAK_FLOPS
    assert row["collective_s"] == 0 and row["fits_one_card"]


def test_dryrun_skips_and_fits():
    row = dryrun.lower_pair("whisper-base", "long_500k")
    assert row["status"] == "skipped" and "long_500k" in row["reason"]
    row = dryrun.lower_pair("qwen3-1.7b", "decode_32k")
    cache = 2 * 28 * 128 * 32768 * 8 * 128 * 2
    assert row["arg_bytes"] >= cache
    assert row["fits_one_card"] is False
    assert row["hbm_per_device_gb"] == pytest.approx(
        row["arg_bytes"] / 2 ** 30)
