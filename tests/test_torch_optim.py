"""The port's Adam and LR schedules against ``repro.optim``.

The same seeded numpy params and gradients go through
``repro.optim.adam_update`` and ``repro_torch.optim.adam_update`` for a
few steps (fp32 and bf16 params, with and without weight decay); moments,
step count and params agree to rtol 1e-6 (bf16 params: the same bf16
values, or one bf16 ulp apart where the fp32 update rounds differently).
The three schedules agree to rtol 1e-6 over a grid of steps, and
``make_schedule`` resolves the same names and refuses the same typo.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro import optim as jopt  # noqa: E402
from repro_torch import optim as topt  # noqa: E402


def _params(seed, dtype):
    rng = np.random.RandomState(seed)
    p = {"w": rng.randn(5, 7).astype(np.float32),
         "b": rng.randn(7).astype(np.float32)}
    return {k: v.astype(dtype) for k, v in p.items()}


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adam_matches_jax_fp32(wd):
    p = _params(0, np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    js, ts = jopt.adam_init(jp), topt.adam_init(tp)
    rng = np.random.RandomState(1)
    for step in range(4):
        g = {k: rng.randn(*v.shape).astype(np.float32) for k, v in p.items()}
        jp, js = jopt.adam_update(jp, {k: jnp.asarray(v) for k, v in
                                       g.items()}, js, 1e-2,
                                  weight_decay=wd)
        tp, ts = topt.adam_update(tp, {k: torch.from_numpy(v) for k, v in
                                       g.items()}, ts, 1e-2,
                                  weight_decay=wd)
        assert int(ts["t"]) == int(js["t"]) == step + 1
        assert ts["t"].dtype == torch.int32
        for k in p:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
            for mom in ("m", "v"):
                np.testing.assert_allclose(
                    ts[mom][k].numpy(), np.asarray(js[mom][k]), rtol=1e-6,
                    atol=1e-9, err_msg=f"{mom} {k}")
                assert ts[mom][k].dtype == torch.float32


def test_adam_keeps_bf16_params_in_bf16():
    p32 = _params(2, np.float32)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p32.items()}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p32.items()}
    js, ts = jopt.adam_init(jp), topt.adam_init(tp)
    rng = np.random.RandomState(3)
    for _ in range(3):
        g = {k: rng.randn(*v.shape).astype(np.float32)
             for k, v in p32.items()}
        jp, js = jopt.adam_update(
            jp, {k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()},
            js, 1e-2)
        tp, ts = topt.adam_update(
            tp, {k: torch.from_numpy(v).to(torch.bfloat16)
                 for k, v in g.items()}, ts, 1e-2)
    for k in p32:
        assert tp[k].dtype == torch.bfloat16
        t = tp[k].float().numpy()
        j = np.asarray(jp[k].astype(jnp.float32))
        # one bf16 ulp (2^-8 relative) where the fp32 update rounds apart
        np.testing.assert_allclose(t, j, rtol=2 ** -7, err_msg=k)
        assert (t != j).mean() <= 0.05, k


@pytest.mark.parametrize("name,kw", [
    ("constant", {}), ("cosine", {"warmup": 10}),
    ("cosine", {"warmup": 0, "floor": 0.1}), ("corollary1", {"tau": 4})])
def test_schedules_match_jax(name, kw):
    js = jopt.make_schedule(name, 0.3, total_steps=100, **kw)
    ts = topt.make_schedule(name, 0.3, total_steps=100, **kw)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        j, t = np.asarray(js(step)), ts(step)
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-6,
                                   err_msg=f"{name} {step}")
    # a step given as a tensor, as a training loop holds it
    np.testing.assert_allclose(
        ts(torch.tensor(7)).numpy(), np.asarray(js(jnp.asarray(7))),
        rtol=1e-6)


def test_make_schedule_refuses_unknown_names():
    for mod in (jopt.schedules, topt.schedules):
        with pytest.raises(ValueError, match="linear"):
            mod.make_schedule("linear", 0.1)
    assert topt.constant is topt.schedules.constant
    assert topt.cosine is topt.schedules.cosine
