"""The paper's FCN and CNN in both packages from the same weights.

The JAX package's initial params carry across verbatim
(``params_from_numpy``: names, HWIO conv weights and the NHWC-flattened
``fc/w`` unchanged); logits, loss and per-leaf gradients of the port's
``classifier_loss`` must match ``repro.models.smallnets.classifier_loss``
on the same numpy batch. Tolerance: fp32, rtol 1e-4 / atol 1e-5 (the
conv and matmul sums run in other orders; the CNN's loss and grads are
taken through four convolutions).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers, and spinning
# OpenMP threads would starve the other workers' threads
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import smallnets as jsn  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import smallnets as tsn  # noqa: E402
from repro_torch.models.common import params_from_numpy  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
ARCHS = {"paper-fcn": ("init_fcn", "apply_fcn"),
         "paper-cnn": ("init_cnn", "apply_cnn")}


def _setup(arch, seed=0, B=6):
    init, apply = ARCHS[arch]
    jcfg, tcfg = jget(arch), tget(arch)
    jp, _ = getattr(jsn, init)(jax.random.PRNGKey(seed), jcfg)
    np_params = {k: np.asarray(v) for k, v in jp.items()}
    rng = np.random.RandomState(seed)
    x = rng.randn(B, 28, 28, 1).astype(np.float32)
    y = rng.randint(0, 10, size=B).astype(np.int32)
    return (jcfg, tcfg, getattr(jsn, apply), getattr(tsn, apply), np_params,
            x, y)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_published_widths_and_layouts(arch):
    init = ARCHS[arch][0]
    jp, _ = getattr(jsn, init)(jax.random.PRNGKey(0), jget(arch))
    tp, _ = getattr(tsn, init)(torch.Generator().manual_seed(0), tget(arch))
    assert list(tp) == list(jp)               # insertion order too
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape, k
    n = sum(int(v.numel()) for v in tp.values())
    assert n == {"paper-fcn": 101770, "paper-cnn": 96362}[arch]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_logits_loss_and_grads_match(arch):
    jcfg, tcfg, japply, tapply, np_params, x, y = _setup(arch)
    jparams = {k: jnp.asarray(v) for k, v in np_params.items()}
    tparams = params_from_numpy(np_params, "cpu")
    jlog = japply(jparams, jcfg, jnp.asarray(x))
    tlog = tapply(tparams, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)

    def jloss(p):
        return jsn.classifier_loss(japply, p, jcfg, jnp.asarray(x),
                                   jnp.asarray(y))
    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)

    def tloss(p):
        loss, m = tsn.classifier_loss(tapply, p, tcfg, torch.from_numpy(x),
                                      torch.from_numpy(y))
        return loss, m
    tg, (tl, tm) = torch.func.grad_and_value(tloss, has_aux=True)(tparams)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    assert float(tm["acc"]) == float(jm["acc"])
    assert sorted(tg) == sorted(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   err_msg=k, **TOL)


def test_vmapped_grads_match_per_client():
    """The engine's client batching: vmap(grad) over stacked per-client
    params and batches equals one grad per client."""
    _, tcfg, _, tapply, np_params, x, y = _setup("paper-cnn", B=4)
    p = params_from_numpy(np_params, "cpu")

    def loss(pp, b):
        return tsn.classifier_loss(tapply, pp, tcfg, b["x"], b["y"])[0]
    C = 2
    stack = {k: torch.stack([v, v * 0.9]) for k, v in p.items()}
    xb = torch.from_numpy(np.stack([x, x[::-1].copy()]))
    yb = torch.from_numpy(np.stack([y, y[::-1].copy()]))
    g = torch.func.vmap(torch.func.grad(loss))(stack, {"x": xb, "y": yb})
    for c in range(C):
        one = torch.func.grad(loss)({k: v[c] for k, v in stack.items()},
                                    {"x": xb[c], "y": yb[c]})
        for k in one:
            np.testing.assert_allclose(g[k][c].numpy(), one[k].numpy(),
                                       rtol=1e-5, atol=1e-6)
