"""LBGM federated rounds of the LMs: the port's ``"lm"`` component and
``"markov"`` dataset against the JAX package's, on the CPU.

Reduced qwen3-1.7b and rwkv6-3b (``reduced()``: 2 layers, d 128, vocab
512, fp32) on ``markov`` data (seq_len 32, ``iid`` partition), 3 rounds of
``FLEngine`` in both packages from the JAX package's params (carried
across with ``build_experiment(params=...)``): the vmap scheduler with the
dense store, the chunked one with a zero-weight padded chunk (K=7, chunk
4), the top-k store at k_frac 0.1 at a delta where scalar rounds occur,
top-k under the int8 codec (round to nearest), ``sample_frac`` 0.5, the
dense store under the top-K compressor with error feedback, and bf16
leaves (the arch override ``dtype="bfloat16"``). The port runs an LM's
clients one after another under ``torch.autograd`` (the component marks
its loss ``CLIENT_LOOP``); the JAX engine vmaps them.

fp32: the ``EXACT`` fields equal, loss rtol 1e-5, final params rtol 1e-4 /
atol 1e-6 (rwkv6: atol 1e-5, see ``CASES``), no client's sin² within 1e-5
of delta; behind the int8 wire or the top-K compressor at most 1e-3 of a
leaf's elements may sit off by a rounding or selection tie, each within
1e-3 (``TIE_FRACTION``, ``TIE_ATOL``). bf16: the same exact
fields, loss rtol 2e-2, final params within 2e-2 relative L2, no sin²
within 1e-3 of delta. Measured here: bf16 losses within 5e-5 relative and
params within 4e-4 relative L2 (the models' bf16 arithmetic differs: XLA
keeps excess precision between ops, torch rounds each op). With bf16
leaves an index-coded wire (int8, fp8, delta_idx) prices the top-k index
sets, which such model-level differences move by a byte or two, so the
bf16 cases ship raw indices; :func:`test_bf16_leaves_through_the_fl_layers`
holds the stores and codecs themselves on identical bf16 gradients,
where the index sets and bytes are equal.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.comm import wire as jw  # noqa: E402
from repro.core import lbgm as jl  # noqa: E402
from repro.fed import experiment as jexp  # noqa: E402
from repro_torch.comm import wire as tw  # noqa: E402
from repro_torch.core import lbgm as tl  # noqa: E402
from repro_torch.fed import engine as teng_mod  # noqa: E402
from repro_torch.fed import experiment as texp  # noqa: E402
from repro_torch.models.common import params_from_numpy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EXACT = ("uplink_floats", "frac_scalar", "wire_bytes", "savings",
         "total_uplink", "vanilla_uplink", "total_wire_bytes",
         "wire_savings")
TOL = {"float32": dict(loss_rtol=1e-5, margin=1e-5),
       "bfloat16": dict(loss_rtol=2e-2, params_rel_l2=2e-2, margin=1e-3)}
PARAM_TOL = {"qwen3-1.7b": dict(rtol=1e-4, atol=1e-6),
             "rwkv6-3b": dict(rtol=1e-4, atol=1e-5)}
#: behind a lossy or selecting uplink (the int8 codec's rounding, the
#: top-K compressor's selection) a gradient difference of ~1e-6 moves a
#: value across a rounding or selection tie: at most TIE_FRACTION of a
#: leaf's elements may sit off PARAM_TOL, each by at most TIE_ATOL
#: (measured, int8: at most 11 of 65536 elements of a leaf, by up to
#: 3.3e-4, about a quantization step of the row times lr, carried
#: through the later rounds; top-K with error feedback: 2, by 1.2e-4)
TIE_FRACTION = 1e-3
TIE_ATOL = 1e-3
TOPK = {"lbg_variant": "topk", "lbg_kw": {"k_frac": 0.1}}
BF16 = {"dtype": "bfloat16"}

#: case -> (arch, FLConfig overrides, arch overrides). rwkv6's gradients
#: agree with JAX's to ~1.3e-5 of their max (qwen3's to ~1.6e-6: the
#: scan's chunked sums, held at rtol 1e-4 / atol 1e-5 in
#: test_torch_train_kernels.py), so its params are held at atol 1e-5, and
#: it runs the dense store at lr 0.005: at lr 0.05 its first rounds move
#: embed rows by up to 0.065 and each tau = 2 local step amplifies those
#: differences (measured: 2.5e-6, 1.5e-5, 5.2e-4 abs on embed after
#: rounds 1-3), and a top-k selection near a tie keeps another index
#: (rwkv6 top-k int8, round 2: 317198 wire bytes against JAX's 317199).
#: Its gradients are near orthogonal across clients (sin² 0.98-1.0),
#: hence delta 0.995.
CASES = {
    "rwkv6-vmap-dense": ("rwkv6-3b", dict(delta_threshold=0.995,
                                          lr=0.005), {}),
    # K=7 in chunks of 4: one zero-weight pad client (K=3 at chunk_size 2
    # clamps to chunks of 1, a divisor of K, and pads nothing)
    "qwen3-chunked-dense-pad": ("qwen3-1.7b", dict(
        num_clients=7, scheduler="chunked", chunk_size=4,
        delta_threshold=0.8), {}),
    "qwen3-chunked-topk": ("qwen3-1.7b", dict(
        TOPK, num_clients=4, scheduler="chunked", chunk_size=2,
        delta_threshold=0.9), {}),
    "qwen3-topk-int8": ("qwen3-1.7b", dict(
        TOPK, delta_threshold=0.9, codec="int8",
        codec_kw={"stochastic": False}), {}),
    "qwen3-sampled": ("qwen3-1.7b", dict(
        num_clients=4, sample_frac=0.5, delta_threshold=0.8), {}),
    "qwen3-dense-topk-ef": ("qwen3-1.7b", dict(
        compressor="topk", compressor_kw={"k_frac": 0.1},
        error_feedback=True, delta_threshold=0.9), {}),
    # bf16 leaves, and the repaired fault: error feedback's fp32 residual
    # widens a bf16 gradient, and the dense bank holds it in fp32
    # (ROADMAP §3). The vmap scheduler: the JAX chunked scheduler refuses
    # the bank's change of dtype in its scan carry
    "qwen3-bf16-dense-topk-ef": ("qwen3-1.7b", dict(
        compressor="topk", compressor_kw={"k_frac": 0.1},
        error_feedback=True, delta_threshold=0.9), BF16),
}


def lm_spec(arch, rounds=3, model_kw=None, **fl):
    base = dict(num_clients=3, tau=2, lr=0.05, batch_size=2, seed=0,
                delta_threshold=0.6)
    base.update(fl)
    return {"name": "fl-lm", "model": {"name": "lm",
                                       "kw": {"arch": arch,
                                              **(model_kw or {})}},
            "data": {"name": "markov",
                     "kw": {"n": 48, "n_eval": 8, "seq_len": 32}},
            "partition": {"name": "iid", "kw": {}},
            "fl": base, "rounds": rounds,
            "eval": {"every": 0, "final": False, "verbose": False}}


def _np(v):
    return np.asarray(v)


def _assert_agree(case, jh, th, jparams, teng, dtype, arch):
    tol = TOL[dtype]
    assert len(th) == len(jh) == 3
    for r, (a, b) in enumerate(zip(jh, th)):
        for k in EXACT:
            assert a[k] == b[k], (case, r, k, a[k], b[k])
        assert np.isfinite(b["loss"])
        np.testing.assert_allclose(b["loss"], a["loss"],
                                   rtol=tol["loss_rtol"],
                                   err_msg=f"{case} round {r}")
    if teng.cfg.use_lbgm:
        delta = teng.cfg.delta_threshold
        margin = min(float(np.min(np.abs(s - delta)))
                     for s in teng.sin2_history)
        assert margin > tol["margin"], (case, margin)
        assert max(h["frac_scalar"] for h in th) > 0, \
            f"{case}: no recycle round to test"
    if dtype == "float32":
        ties = teng.codec.lossy or teng.cfg.compressor == "topk"
        for k, v in jparams.items():
            t, j = teng.params[k].numpy(), _np(v)
            if ties:
                ptol = PARAM_TOL[arch]
                off = np.abs(t - j) > ptol["atol"] + ptol["rtol"] * np.abs(j)
                assert off.mean() <= TIE_FRACTION, (case, k, int(off.sum()))
                np.testing.assert_allclose(t, j, rtol=0, atol=TIE_ATOL,
                                           err_msg=k)
                t = np.where(off, j, t)
            np.testing.assert_allclose(t, j, err_msg=k, **PARAM_TOL[arch])
    else:
        num = den = 0.0
        for k, v in jparams.items():
            j = _np(v).astype(np.float64)
            t = teng.params[k].double().numpy()
            assert teng.params[k].dtype == torch.bfloat16, k
            num += float(((t - j) ** 2).sum())
            den += float((j ** 2).sum())
        assert (num / den) ** 0.5 <= tol["params_rel_l2"], (case, num, den)


def _run_both(d):
    jeng, _ = jexp.build_experiment(jexp.ExperimentSpec.from_dict(d))
    p0 = {k: _np(v) for k, v in jeng.params.items()}
    teng, _ = texp.build_experiment(texp.ExperimentSpec.from_dict(d),
                                    params=p0, device="cpu")
    assert teng._chunk == jeng._chunk and teng._pad == jeng._pad
    assert teng._sparse_agg == jeng._sparse_agg
    assert type(teng.agg).__name__ == type(jeng.agg).__name__
    jh = jeng.run(d["rounds"])
    th = teng.run(d["rounds"])
    return jeng, teng, jh, th


@pytest.mark.parametrize("case", sorted(CASES))
def test_fl_lm_parity(case):
    arch, fl, model_kw = CASES[case]
    d = lm_spec(arch, model_kw=model_kw, **fl)
    jeng, teng, jh, th = _run_both(d)
    assert getattr(teng.loss_fn, teng_mod.CLIENT_LOOP)
    if "pad" in case:
        assert teng._pad > 0
    dtype = model_kw.get("dtype", "float32")
    _assert_agree(case, jh, th, jeng.params, teng, dtype, arch)
    if teng._use_ef and not teng._sparse_agg:
        for k, v in jeng.lbg.items():
            assert teng.lbg[k].dtype == torch.float32, k
            assert _np(v).dtype == np.float32, k


def test_spec_file_drives_both_packages():
    """examples/specs/qwen3_fl_lm.json (full width, for the card), read as
    it is and cut to the reduced arch with one set of overrides, through
    both packages' ``run_experiment``; its eval policy gives a finite
    held-out loss."""
    with open(ROOT / "examples" / "specs" / "qwen3_fl_lm.json") as f:
        d = json.load(f)
    assert d["model"] == {"name": "lm", "kw": {"arch": "qwen3-1.7b",
                                               "reduced": False}}
    cut = {"model.kw.reduced": True, "data.kw.vocab": 512,
           "data.kw.seq_len": 32, "data.kw.n": 16, "fl.num_clients": 2,
           "rounds": 3}
    jspec = jexp.ExperimentSpec.from_dict(d).with_overrides(cut)
    tspec = texp.ExperimentSpec.from_dict(d).with_overrides(cut)
    assert jspec.to_dict() == tspec.to_dict()
    jeng, _ = jexp.build_experiment(jspec)
    p0 = {k: _np(v) for k, v in jeng.params.items()}
    jres = jexp.run_experiment(jspec)
    tres = texp.run_experiment(tspec, device="cpu", params=p0)
    assert len(tres.history) == len(jres.history) == 3
    for a, b in zip(jres.history, tres.history):
        for k in EXACT:
            assert a[k] == b[k], (k, a[k], b[k])
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
    assert set(tres.final_eval) == {"test_loss"}
    np.testing.assert_allclose(tres.final_eval["test_loss"],
                               jres.final_eval["test_loss"], rtol=1e-5)


def test_remat_gives_the_same_history():
    """Checkpointed blocks (``remat=True``) recompute the same numbers:
    the port's history and params equal the ``remat=False`` run's."""
    runs = []
    for remat in (False, True):
        d = lm_spec("qwen3-1.7b", model_kw={"remat": remat},
                    **dict(TOPK, delta_threshold=0.9))
        eng, _ = texp.build_experiment(texp.ExperimentSpec.from_dict(d),
                                       device="cpu")
        runs.append((eng.run(3), eng.params))
    (h0, p0), (h1, p1) = runs
    assert h0 == h1
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k


def test_markov_dataset_equals_jax():
    for kw in ({}, {"n": 10, "n_eval": 3, "seq_len": 7, "vocab": 151936,
                    "seed": 2, "branching": 3}):
        jtrain, jheld = jexp.DATASETS.get("markov")(**kw)
        ttrain, theld = texp.DATASETS.get("markov")(**kw)
        for j, t in ((jtrain, ttrain), (jheld, theld)):
            assert set(j) == set(t) == {"tokens", "labels"}
            for k in j:
                assert j[k].dtype == t[k].dtype
                np.testing.assert_array_equal(t[k], j[k])


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-3b"])
def test_lm_component_matches_jax(arch):
    """The component's keys, shapes, dtypes and axes are the JAX
    component's; its loss on the JAX params is JAX's."""
    kw = dict(seed=0, arch=arch)
    jp, jloss, jaxes = jexp.MODELS.get("lm")(**kw)
    tp, tloss, taxes = texp.MODELS.get("lm")(**kw, device="cpu")
    assert set(tp) == set(jp) == set(taxes) == set(jaxes)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape, k
        assert tuple(taxes[k]) == tuple(jaxes[k]), k
    toks, labels = jexp.DATASETS.get("markov")(n=2, n_eval=0)[0].values()
    jl_, _ = jloss(jp, {"tokens": jnp.asarray(toks),
                        "labels": jnp.asarray(labels)})
    tl_, _ = tloss(params_from_numpy({k: _np(v) for k, v in jp.items()},
                                     "cpu"),
                   {"tokens": torch.as_tensor(toks),
                    "labels": torch.as_tensor(labels)})
    np.testing.assert_allclose(float(tl_), float(jl_), rtol=1e-5)


def test_key_check_draws_on_the_meta_device(monkeypatch):
    """With ``params`` given, ``build_experiment`` takes the keys from a
    draw on the meta device (no second init), compares the same keys as
    a real draw, and refuses a params dict whose keys differ."""
    from repro_torch.models import transformer
    d = lm_spec("qwen3-1.7b")
    spec = texp.ExperimentSpec.from_dict(d)
    real, _, _ = texp.MODELS.get("lm")(seed=0, arch="qwen3-1.7b",
                                       device="cpu")
    meta, _, _ = texp.MODELS.get("lm")(seed=0, arch="qwen3-1.7b",
                                       device="meta")
    assert set(meta) == set(real)
    for k in real:
        assert meta[k].device.type == "meta"
        assert meta[k].shape == real[k].shape, k
        assert meta[k].dtype == real[k].dtype, k
    for name in ("fcn", "cnn"):
        r, _ = texp.MODELS.get(name)(seed=0)
        m, _ = texp.MODELS.get(name)(seed=0, device="meta")
        assert set(m) == set(r)
        assert all(v.device.type == "meta" for v in m.values())
    seen = []
    real_init = transformer.init_lm

    def spy(gen, cfg, device="cuda"):
        seen.append(torch.device(device).type)
        return real_init(gen, cfg, device=device)
    monkeypatch.setattr(transformer, "init_lm", spy)
    p0 = {k: v.numpy() for k, v in real.items()}
    eng, _ = texp.build_experiment(spec, params=p0, device="cpu")
    assert seen == ["meta"]
    for k, v in real.items():
        assert torch.equal(eng.params[k], v), k
    p0.pop("embed")
    with pytest.raises(ValueError, match="do not match"):
        texp.build_experiment(spec, params=p0, device="cpu")


def test_lm_build_experiment_defaults_to_the_card():
    """An ``lm`` spec's ``build_experiment`` runs on the card by default
    (params drawn there) and raises without one."""
    spec = texp.ExperimentSpec.from_dict(lm_spec("qwen3-1.7b"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            texp.build_experiment(spec)
        with pytest.raises(RuntimeError, match="CUDA card"):
            texp.MODELS.get("lm")(seed=0)
        return
    eng, _ = texp.build_experiment(spec)
    assert all(v.device.type == "cuda" for v in eng.params.values())


# ------------------------------------------ bf16 leaves, layer by layer


def _bf16_stack(rs, C, shapes, base=None, noise=None):
    """(C, ...) bf16 leaves: normal draws, or ``base`` plus draws scaled
    per client by ``noise`` (C,)."""
    out = {}
    for k, s in shapes.items():
        x = rs.randn(C, *s).astype(np.float32)
        if noise is not None:
            x = x * noise.reshape((C,) + (1,) * len(s))
        if base is not None:
            x = x + base[k].astype(np.float32)
        out[k] = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
    return out


def _sorted_payload(idx, val):
    order = np.argsort(idx, -1)
    return (np.take_along_axis(idx, order, -1),
            np.take_along_axis(val, order, -1))


#: bf16 leaves of reduced qwen3's shapes (one block row each, the norm's
#: a 64-float row), plus a leaf of 3 block rows (16 in the layout)
LAYER_SHAPES = {"embed": (512, 128), "blocks/wa_q": (2, 128, 128),
                "blocks/q_norm": (2, 32), "wide": (3, 70000)}


def test_bf16_leaves_through_the_fl_layers():
    """Identical bf16 gradient stacks (C=3, ``LAYER_SHAPES``) through
    both packages' FL layers, two rounds (an empty bank, then the first
    round's): the dense store (the new bank bit for bit and g_tilde within
    a bf16 ulp, bf16; sin² within 1e-5), the top-k store's sparse step
    (kept index sets and values equal), the codecs on its payloads (int8
    and fp8 to nearest, delta_idx: values, scales and bytes equal), the
    dense int8 encoding, and the dense and sparse folds of the
    aggregators (rtol 1e-6)."""
    shapes = LAYER_SHAPES
    rs = np.random.RandomState(0)
    C, kf = 3, 0.1
    g1 = _bf16_stack(rs, C, shapes)
    g2 = _bf16_stack(rs, C, shapes, base=g1,
                     noise=np.array([0.5, 0.8, 2.0], np.float32))
    w = np.array([0.5, 0.3, 0.2], np.float32)
    jb_dense = {k: jnp.zeros((C,) + s, jnp.bfloat16)
                for k, s in shapes.items()}
    tb_dense = {k: torch.zeros((C,) + s, dtype=torch.bfloat16)
                for k, s in shapes.items()}
    proto = jl.init_topk_lbg({k: jnp.zeros(s, jnp.bfloat16)
                              for k, s in shapes.items()}, kf)
    jb = {k: {f: jnp.zeros((C,) + x.shape, x.dtype) for f, x in v.items()}
          for k, v in proto.items()}
    tb = {k: {f: torch.from_numpy(np.array(x)) for f, x in v.items()}
          for k, v in jb.items()}
    jdense = jax.jit(jax.vmap(lambda g, l: jl.lbgm_client_step(g, l, 0.7)))
    jtopk = jax.jit(jax.vmap(lambda g, l: jl.topk_step_core(
        g, l, 0.7, kf, sparse_out=True)))
    jcodecs = {}
    for name in ("int8", "fp8", "delta_idx"):
        kw = {} if name == "delta_idx" else {"stochastic": False}
        jc = jw.CODECS.get(name)(**kw)
        jcodecs[name] = (jax.jit(jax.vmap(
            lambda s, sc, lb, st, jc=jc: jc.encode_sparse(
                (s, sc), lb, st, None))), tw.CODECS.get(name)(**kw))
    jint8 = jw.CODECS.get("int8")(stochastic=False)
    jdense_int8 = jax.jit(jax.vmap(
        lambda t, c: jint8.encode_dense(t, c, None)))
    scalars = []
    for g in (g1, g2):
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        tg = params_from_numpy(g, "cpu")
        # dense store
        jgt, jb_dense, jst = jdense(jg, jb_dense)
        tgt, tb_dense, tst = tl.lbgm_client_step(tg, tb_dense, 0.7,
                                                 fused=True)
        np.testing.assert_allclose(tst.sin2.numpy(), _np(jst.sin2),
                                   rtol=0, atol=1e-5)
        assert np.array_equal(tst.sent_scalar.numpy(), _np(jst.sent_scalar))
        scalars.append(tst.sent_scalar.numpy())
        for k in shapes:
            assert tgt[k].dtype == tb_dense[k].dtype == torch.bfloat16
            np.testing.assert_allclose(
                tgt[k].float().numpy(), _np(jgt[k]).astype(np.float32),
                rtol=1e-2, atol=0, err_msg=k)
            assert torch.equal(tb_dense[k], params_from_numpy(
                {k: _np(jb_dense[k])}, "cpu")[k]), k
        # the dense fold of the bf16 g_tilde
        jacc = {k: jnp.zeros(s, jnp.float32) for k, s in shapes.items()}
        jacc = jax.tree.map(
            lambda a, *gs: a + sum(jnp.where(w[i] > 0, w[i] * gs[i].astype(
                jnp.float32), 0.0) for i in range(C)),
            jacc, *[{k: v[i] for k, v in jgt.items()} for i in range(C)])
        tacc = teng_mod.DenseAggregator().accumulate(
            {k: torch.zeros(s) for k, s in shapes.items()},
            torch.from_numpy(w), tgt)
        for k in shapes:
            np.testing.assert_allclose(tacc[k].numpy(), _np(jacc[k]),
                                       rtol=1e-6, atol=1e-30, err_msg=k)
        # the top-k store's sparse step
        (js, jsc), jb, jts = jtopk(jg, jb)
        (ts, tsc), tb, tts = tl.topk_step_core(tg, tb, 0.7, kf,
                                               sparse_out=True, fused=True)
        assert np.array_equal(tts.sent_scalar.numpy(),
                              _np(jts.sent_scalar))
        np.testing.assert_allclose(tsc.numpy(), _np(jsc), rtol=1e-5)
        for k in shapes:
            a = _sorted_payload(_np(js[k]["idx"]), _np(js[k]["val"]))
            b = _sorted_payload(ts[k]["idx"].numpy(), ts[k]["val"].numpy())
            np.testing.assert_array_equal(b[0], a[0], err_msg=k)
            np.testing.assert_array_equal(b[1], a[1], err_msg=k)
        for name, (jenc, tc) in jcodecs.items():
            jo = jenc(js, jsc, jb, jts)
            to = tc.encode_sparse((ts, tsc), tb, tts, None)
            np.testing.assert_array_equal(to[2].numpy(), _np(jo[2]))
            for k in shapes:
                for f in tc.payload_keys:
                    np.testing.assert_array_equal(
                        to[0][0][k][f].float().numpy(),
                        _np(jo[0][0][k][f]).astype(np.float32),
                        err_msg=(name, k, f))
            if tc.lossy:
                # the quantized payloads' sparse fold (the dequant kernel's
                # plain version on the CPU) against the JAX fold
                tagg = teng_mod.SparseCodecAggregator(
                    {k: torch.zeros(s) for k, s in shapes.items()}, kf)
                tout = tagg.finalize(tagg.accumulate(
                    tagg.init({k: torch.zeros(s) for k, s in
                               shapes.items()}),
                    torch.from_numpy(w), to[0]))
                for k in shapes:
                    want = np.zeros(int(np.prod(shapes[k])), np.float32)
                    nb, block, _ = tl._block_layout(want.size, kf)
                    acc = np.zeros((nb, block), np.float32)
                    for i in range(C):
                        sk = {f: _np(jo[0][0][k][f][i]) for f in
                              ("idx", "val", "scale")}
                        vals = (w[i] * _np(jo[0][1][i])) * (
                            sk["val"].astype(np.float32) * sk["scale"])
                        np.put_along_axis(
                            acc, sk["idx"], np.take_along_axis(
                                acc, sk["idx"], -1) + vals, -1)
                    want = acc.reshape(-1)[:want.size].reshape(shapes[k])
                    np.testing.assert_allclose(tout[k].numpy(), want,
                                               rtol=1e-6, atol=1e-30,
                                               err_msg=(name, k))
        # the dense int8 encoding of the bf16 g_tilde
        tc = tw.CODECS.get("int8")(stochastic=False)
        cost = np.full(C, 7.0, np.float32)
        jo = jdense_int8(jgt, jnp.asarray(cost))
        to = tc.encode_dense(tgt, torch.from_numpy(cost), None)
        np.testing.assert_array_equal(to[1].numpy(), _np(jo[1]))
        for k in shapes:
            np.testing.assert_array_equal(to[0][k].numpy(), _np(jo[0][k]),
                                          err_msg=k)
    # both rounds ran a full and a recycle decision somewhere
    assert not scalars[0].any() and scalars[1].any() and \
        not scalars[1].all()


def test_client_loop_sums_steps_as_jax():
    """The client loop's accumulated gradient over tau = 3 bf16 steps is
    the JAX engine's ``jnp.sum`` over the stacked steps: the steps added in
    fp32 and rounded to bf16 once (which ``jnp.sum`` does for bf16, pinned
    here too); tau = 2 rounds the one add in place, the same bits."""
    from repro_torch.train.trainer import grad_and_loss
    x = jnp.asarray(np.random.RandomState(3).randn(3, 4096),
                    jnp.float32).astype(jnp.bfloat16)
    np.testing.assert_array_equal(
        _np(jnp.sum(x, 0)), _np(x.astype(jnp.float32).sum(0).astype(
            jnp.bfloat16)))
    for tau in (2, 3):
        d = lm_spec("qwen3-1.7b", model_kw=BF16, num_clients=2, tau=tau)
        eng, _ = texp.build_experiment(texp.ExperimentSpec.from_dict(d),
                                       device="cpu")
        batch, _ = eng._stage(eng._sample_batches(np.random.RandomState(1)))
        with torch.no_grad():
            asg, losses = eng._make_client_update()(eng.params, batch)
        for c in range(2):
            p, steps, ls = eng.params, [], []
            for t in range(tau):
                g, loss = grad_and_loss(eng.loss_fn, p,
                                        {k: v[c, t] for k, v in
                                         batch.items()})
                p = {k: p[k] - 0.05 * g[k] for k in p}
                steps.append(g)
                ls.append(loss)
            for k in asg:
                want = sum(s[k].float() for s in steps).to(torch.bfloat16)
                assert asg[k].dtype == torch.bfloat16
                assert torch.equal(asg[k][c], want), (tau, c, k)
            assert float(losses[c]) == float(torch.stack(ls).mean())
