"""The lp rung's price step, contracted or not (ROADMAP Queue 3 item 1).

``solve_lp_rounding``'s subgradient step ``lam <- max(lam + eta * (ax -
1), 0)`` rounds once when it is contracted into a fused multiply-add
(the port's form, ``solver/dual.py: price_step``) and twice when it is
not; XLA on the CPU may compile the reference's either way.  numpy
models of the whole price loop in both forms (:func:`model_prices`)
find seeded instances whose prices differ, and the greedy rounding of
both then decides the picks.

* ``price_step`` is the contracted model, bit for bit, on inputs where
  the two forms differ: this pins the port's form.
* On seeded instances whose prices differ between the forms, the
  port's picks equal the reference's ``solve_lp_rounding``'s and both
  models'.  No instance found so far picks differently, so which form
  the reference compiles stays open.

Run as a script for the bounded search (seconds, first seed):

    PYTHONPATH=. python tests/test_torch_price_step.py 600 0
"""

import sys
import time

import numpy as np
import pytest
import torch

from repic_tpu_torch.ops.solver import solve_greedy, solve_lp_rounding
from repic_tpu_torch.solver.dual import objective_sum, price_step

f32 = np.float32
#: the first ten of the 22 seeds of :func:`instance` below 12,461 whose
#: two price forms differ (``search(...)`` from seed 0)
DIFFERING_SEEDS = (862, 1156, 1354, 2197, 2200, 2459, 3268, 3612, 3688,
                   3901)


def instance(seed):
    """A seeded packing: K = 2-5 vertices per clique out of V = 6-59,
    C = 8-119 cliques, weights uniform, on a 1/7 grid or from four
    values (ties), about a tenth of the rows invalid."""
    rng = np.random.default_rng(seed)
    k = int(rng.integers(2, 6))
    v = int(rng.integers(6, 60))
    c = int(rng.integers(8, 120))
    mv = np.stack([rng.choice(v, k, replace=False)
                   for _ in range(c)]).astype(np.int32)
    if seed % 3 == 0:
        w = rng.uniform(0.1, 1.0, c).astype(f32)
    elif seed % 3 == 1:
        w = (rng.integers(1, 6, c) / 7.0).astype(f32)
    else:
        w = rng.choice(f32([0.3, 0.31, 0.7, 0.9]), c).astype(f32)
    valid = rng.uniform(size=c) > 0.1
    return mv, w, valid, v


def _gather_sum(lam, mv):
    g = lam[mv[:, 0]]
    for s in range(1, mv.shape[1]):
        g = (g + lam[mv[:, s]]).astype(f32)
    return g


def model_step(lam, eta, ax, contracted):
    """One price step in float32: one rounding (contracted) or two."""
    d = (ax - f32(1)).astype(f32)
    if contracted:
        new = (lam.astype(np.float64)
               + np.float64(eta) * d.astype(np.float64)).astype(f32)
    else:
        new = (lam + (eta * d).astype(f32)).astype(f32)
    return np.maximum(new, f32(0))


def model_prices(mv, w, valid, v, contracted, num_iters=150):
    """The reference's price loop in numpy: the final and the averaged
    prices."""
    c, k = mv.shape
    wv = np.where(valid, w, f32(0)).astype(f32)
    eta0 = max(f32(wv.max()) if c else f32(0), f32(1e-6))
    half = num_iters // 2
    lam = np.zeros(v, f32)
    lam_sum = np.zeros(v, f32)
    tgt = np.where(valid[:, None], mv, v).reshape(-1)
    for t in range(num_iters):
        x = ((wv - _gather_sum(lam, mv)).astype(f32) > 0) & valid
        ax = np.zeros(v + 1, f32)
        np.add.at(ax, tgt, np.repeat(x, k).astype(f32))
        eta = f32(f32(eta0) / f32(1.0 + t))
        lam = model_step(lam, eta, ax[:v], contracted)
        if t >= half:
            lam_sum = (lam_sum + lam).astype(f32)
    return lam, (lam_sum / f32(max(num_iters - half, 1))).astype(f32)


def model_picks(mv, w, valid, v, lam, lam_avg):
    """The rounding of ``solve_lp_rounding`` from given prices: greedy
    by weight, by each price vector's reduced costs, the best kept."""
    tmv = torch.from_numpy(mv.astype(np.int64))[None]
    tw, tv = torch.from_numpy(w)[None], torch.from_numpy(valid)[None]
    zero = torch.zeros((), dtype=torch.float32)
    wv = torch.where(tv, tw, zero)
    best = solve_greedy(tmv, tw, tv, v)
    best_val = objective_sum(torch.where(best, wv, zero))
    for prices in (lam, lam_avg):
        reduced = wv - torch.from_numpy(_gather_sum(prices, mv))[None]
        cand = solve_greedy(
            tmv, torch.where(tv, reduced, torch.full_like(reduced, -1.0)),
            tv, v)
        cand_val = objective_sum(torch.where(cand, wv, zero))
        best = torch.where((cand_val > best_val)[:, None], cand, best)
        best_val = torch.maximum(cand_val, best_val)
    return best[0].numpy()


def test_price_step_is_the_contracted_form():
    """Float32 steps where one and two roundings differ: the port's
    ``price_step`` rounds once."""
    rng = np.random.default_rng(3)
    lam = rng.uniform(0, 2, (64, 512)).astype(f32)
    eta = rng.uniform(0.001, 1, 64).astype(f32)
    ax = rng.integers(0, 9, (64, 512)).astype(f32)
    got = price_step(torch.from_numpy(lam), torch.from_numpy(eta),
                     torch.from_numpy(ax)).numpy()
    fused = model_step(lam, eta[:, None], ax, True)
    split = model_step(lam, eta[:, None], ax, False)
    assert (fused != split).sum() > 100
    np.testing.assert_array_equal(got, fused)


@pytest.mark.parametrize("seed", DIFFERING_SEEDS)
def test_differing_prices_pick_as_the_reference(seed):
    from repic_tpu.ops.solver import solve_lp_rounding as jax_lp

    mv, w, valid, v = instance(seed)
    fused = model_prices(mv, w, valid, v, True)
    split = model_prices(mv, w, valid, v, False)
    assert not all(np.array_equal(a, b) for a, b in zip(fused, split))
    picks = [model_picks(mv, w, valid, v, *p) for p in (fused, split)]
    got = solve_lp_rounding(torch.from_numpy(mv)[None],
                            torch.from_numpy(w)[None],
                            torch.from_numpy(valid)[None], v)[0].numpy()
    want = np.asarray(jax_lp(mv, w, valid, v))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(picks[0], got)
    np.testing.assert_array_equal(picks[1], got)


def search(seconds: float, seed: int = 0) -> dict:
    """Seeded instances from ``seed`` on for ``seconds``: how many had
    prices that differ between the forms, and which of those picked
    differently."""
    t0 = time.time()
    differ, picks_differ = [], []
    while time.time() - t0 < seconds:
        mv, w, valid, v = instance(seed)
        fused = model_prices(mv, w, valid, v, True)
        split = model_prices(mv, w, valid, v, False)
        if not all(np.array_equal(a, b) for a, b in zip(fused, split)):
            differ.append(seed)
            if not np.array_equal(model_picks(mv, w, valid, v, *fused),
                                  model_picks(mv, w, valid, v, *split)):
                picks_differ.append(seed)
        seed += 1
    return {"searched_to": seed, "prices_differ": differ,
            "picks_differ": picks_differ}


if __name__ == "__main__":
    print(search(float(sys.argv[1]), int(sys.argv[2]) if len(sys.argv) > 2
                 else 0))
