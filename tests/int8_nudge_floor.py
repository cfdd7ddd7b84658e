"""The floor of stochastic int8 at d_model 704: how far a one-ulp nudge of
the initial params moves each package's own 3-round history.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/int8_nudge_floor.py

The spec is ``test_torch_sharded_ranks.py``'s FCN (d_model 704, K=10,
chunks of 5, sample_frac 0.5, top-k at k_frac 0.1, delta 0.85) on the
chunked scheduler with the int8 codec's default stochastic rounding,
3 rounds, from the JAX package's params. The script runs

* the port against the JAX package;
* the JAX package against itself with every initial param moved one ulp
  towards +inf, then towards -inf;
* the port against itself with the same two nudges;

and prints, per pair, whether the EXACT fields agree, the loss's largest
relative difference over the rounds, and per leaf the elements off the
params tolerance (atol 1e-6 + rtol 1e-4 · |ref|) and the largest absolute
difference. ``tests/test_torch_codec_engine.py`` holds the port against
the JAX package at twice the larger floor (:data:`INT8_D704_TOL`), and
``tests/test_torch_sharded_ranks.py`` its (2, 2) mesh.
"""
import json

import numpy as np

ROUNDS = 3
EXACT = ("uplink_floats", "frac_scalar", "wire_bytes")

#: twice the larger floor this script measured (the JAX package nudged
#: towards -inf parted 1,821 of fc1/w's 551,936 elements, by up to
#: 2.93e-4, and its loss by 4.17e-6; the port nudged towards +inf 1,814,
#: by up to 2.93e-4, and 3.91e-6; the port against the JAX package 1,760,
#: 2.93e-4 and 3.21e-6): the fraction of a leaf's elements off rtol 1e-4
#: / atol 1e-6, the largest difference of any element, the loss's rtol
INT8_D704_TOL = {"fraction": 2 * 1821 / 551936, "atol": 2 * 2.93e-4,
                 "loss_rtol": 2 * 4.17e-6}


def assert_at_int8_floor(case, t, j):
    """Params ``t`` against ``j`` at :data:`INT8_D704_TOL`."""
    diff = np.abs(t - j)
    off = diff > 1e-6 + 1e-4 * np.abs(j)
    assert off.mean() <= INT8_D704_TOL["fraction"], (case, int(off.sum()))
    assert diff.max(initial=0.0) <= INT8_D704_TOL["atol"], (case,
                                                           diff.max())


def d704_spec(rounds=ROUNDS, **fl):
    base = dict(lbg_variant="topk", lbg_kw={"k_frac": 0.1}, num_clients=10,
                tau=2, lr=0.05, batch_size=16, seed=0, delta_threshold=0.85,
                scheduler="chunked", chunk_size=6, sample_frac=0.5,
                codec="int8")
    base.update(fl)
    return {"name": "w704", "model": {"name": "fcn",
                                      "kw": {"d_model": 704}},
            "data": {"name": "mixture",
                     "kw": {"n": 600, "n_eval": 50, "seed": 0}},
            "partition": {"name": "iid", "kw": {"seed": 0}},
            "fl": base, "rounds": rounds,
            "eval": {"every": 0, "final": False, "verbose": False}}


def nudge(params, sign):
    """Every element one ulp towards ``sign`` · inf."""
    return {k: np.nextafter(v, np.float32(sign * np.inf)).astype(v.dtype)
            for k, v in params.items()}


def parted(ref, got):
    """``(loss rel, {leaf: (off, size, max abs)})`` of two ``(history,
    params)`` runs, and whether their EXACT fields agree."""
    (ha, pa), (hb, pb) = ref, got
    exact = all(a[k] == b[k] for a, b in zip(ha, hb) for k in EXACT)
    loss = max(abs(a["loss"] - b["loss"]) / abs(a["loss"])
               for a, b in zip(ha, hb))
    leaves = {}
    for k in sorted(pa):
        diff = np.abs(pb[k] - pa[k])
        off = diff > 1e-6 + 1e-4 * np.abs(pa[k])
        leaves[k] = (int(off.sum()), int(off.size),
                     float(diff[off].max(initial=0.0)))
    return exact, loss, leaves


def jax_run(d, p0):
    import jax.numpy as jnp
    from repro.fed import experiment as jexp
    eng, _ = jexp.build_experiment(jexp.ExperimentSpec.from_dict(d))
    eng.params = {k: jnp.asarray(v) for k, v in p0.items()}
    rng = np.random.RandomState(d["fl"]["seed"] + 1)
    hist = [eng.run_round(rng) for _ in range(d["rounds"])]
    return hist, {k: np.asarray(v) for k, v in eng.params.items()}


def port_run(d, p0):
    from repro_torch.fed import experiment as texp
    eng, _ = texp.build_experiment(texp.ExperimentSpec.from_dict(d),
                                   params=p0, device="cpu")
    rng = np.random.RandomState(d["fl"]["seed"] + 1)
    hist = [eng.run_round(rng) for _ in range(d["rounds"])]
    return hist, {k: v.numpy() for k, v in eng.params.items()}


def jax_params(d):
    from repro.fed import experiment as jexp
    eng, _ = jexp.build_experiment(jexp.ExperimentSpec.from_dict(d))
    return {k: np.asarray(v) for k, v in eng.params.items()}


def main():
    d = d704_spec()
    p0 = jax_params(d)
    j, t = jax_run(d, p0), port_run(d, p0)
    pairs = {"port vs jax": (j, t)}
    for s in (+1, -1):
        pairs[f"jax vs jax{s:+d}ulp"] = (j, jax_run(d, nudge(p0, s)))
        pairs[f"port vs port{s:+d}ulp"] = (t, port_run(d, nudge(p0, s)))
    for tag, (a, b) in pairs.items():
        exact, loss, leaves = parted(a, b)
        print(json.dumps({"pair": tag, "exact": exact, "loss_rel": loss,
                          "leaves": leaves}))


if __name__ == "__main__":
    main()
