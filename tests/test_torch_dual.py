"""The port's packing solvers against the JAX package's.

``solve_greedy`` and ``solve_dual_decomposition`` get the same seeded
packings as the reference (vmapped there, batched here).  Picks,
dual-ascent iterations, convergence flags and repair counts must be
exact; the duality-gap certificate is a float32 diagnostic that no
decision reads, held within 1e-5.  Weights rounded to one decimal make
large tie classes, which both sides must break toward the lower clique
index.  Packings whose rounding candidates differ by about one float32
rounding (``near_tie_packings``) pin the order of the objective sums:
the port must pick as the reference does, where float64 sums would pick
otherwise on some of them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repic_tpu.ops import solver as jsolver
from repic_tpu.solver import dual as jdual
from repic_tpu_torch.ops import solver as tsolver
from repic_tpu_torch.solver import dual as tdual
from repic_tpu_torch.utils.synthetic import near_tie_packings
from torch_port_common import n, t

BATCH = 6
CASES = [
    # (C, K, V, ties)
    (40, 2, 32, False),
    (120, 3, 64, False),
    (120, 3, 64, True),
    (200, 4, 96, False),
    (96, 5, 40, True),
]


def _packings(c, k, v, ties, seed):
    rng = np.random.default_rng(seed)
    mv = rng.integers(0, v, (BATCH, c, k)).astype(np.int32)
    w = rng.uniform(0.1, 1.0, (BATCH, c)).astype(np.float32)
    if ties:
        w = np.round(w, 1).astype(np.float32)
    valid = rng.uniform(size=(BATCH, c)) > 0.2
    # row 0 is conflict-free (every vertex in at most one clique): its
    # prices never move and its ascent stops after one step, while the
    # other rows run on, so the batch must freeze it in place
    mv[0] = np.arange(c * k).reshape(c, k) % v
    valid[0] &= np.arange(c) < v // k
    return mv, w, valid


@functools.partial(jax.jit, static_argnums=3)
def _j_greedy(mv, w, valid, v):
    return jax.vmap(lambda a, b, c: jsolver.solve_greedy(a, b, c, v))(
        mv, w, valid
    )


@functools.partial(jax.jit, static_argnums=3)
def _j_dual(mv, w, valid, v):
    return jax.vmap(
        lambda a, b, c: jdual.solve_dual_decomposition(a, b, c, v)
    )(mv, w, valid)


@pytest.mark.parametrize("c,k,v,ties", CASES)
def test_solve_greedy_matches_reference(c, k, v, ties):
    mv, w, valid = _packings(c, k, v, ties, seed=c + k)
    want = n(_j_greedy(mv, w, valid, v))
    got = n(tsolver.solve_greedy(t(mv), t(w), t(valid), v))
    np.testing.assert_array_equal(got, want)
    assert got.any()


@pytest.mark.parametrize("c,k,v,ties", CASES)
def test_solve_dual_decomposition_matches_reference(c, k, v, ties):
    mv, w, valid = _packings(c, k, v, ties, seed=10 * c + k)
    want = _j_dual(mv, w, valid, v)
    got = tdual.solve_dual_decomposition(t(mv), t(w), t(valid), v)
    np.testing.assert_array_equal(n(got.picked), n(want.picked))
    np.testing.assert_array_equal(n(got.iterations), n(want.iterations))
    np.testing.assert_array_equal(n(got.converged), n(want.converged))
    np.testing.assert_array_equal(n(got.repairs), n(want.repairs))
    np.testing.assert_allclose(n(got.gap), n(want.gap), atol=1e-5)
    assert n(got.iterations)[0] == 1 and n(got.iterations)[1:].max() > 1


@pytest.mark.parametrize("c", [5, 32, 33, 100, 1024, 5000])
def test_objective_sum_matches_reference_reduction(c):
    rng = np.random.default_rng(c)
    x = (rng.uniform(0.0, 1.0, (4, c)) * (rng.uniform(size=(4, c)) < 0.6))
    x = x.astype(np.float32)
    want = jax.jit(lambda a: jnp.sum(a, axis=-1))(x)
    got = tdual.objective_sum(t(x))
    np.testing.assert_array_equal(n(got), n(want))


def _float64_objective(x):
    return x.double().sum(-1).float()


@pytest.mark.parametrize("gadgets,background,seed", [(1, 60, 0), (2, 200, 1)])
def test_near_tie_picks_match_reference(gadgets, background, seed,
                                        monkeypatch):
    mv, w, valid, v = near_tie_packings(32, gadgets, background, seed)
    want = n(_j_dual(mv, w, valid, v).picked)
    got = n(tdual.solve_lp_device(t(mv), t(w), t(valid), v))
    np.testing.assert_array_equal(got, want)
    # these ties are close enough that exact (float64) objective sums
    # pick another candidate than the reference on some packings
    monkeypatch.setattr(tdual, "objective_sum", _float64_objective)
    f64 = n(tdual.solve_lp_device(t(mv), t(w), t(valid), v))
    assert (f64 != want).any(axis=1).sum() >= 1


def test_solve_lp_device_is_the_picks():
    mv, w, valid = _packings(64, 3, 48, False, seed=3)
    stats = tdual.solve_dual_decomposition(t(mv), t(w), t(valid), 48)
    picks = tdual.solve_lp_device(t(mv), t(w), t(valid), 48)
    np.testing.assert_array_equal(n(picks), n(stats.picked))


def test_picks_are_feasible_packings():
    mv, w, valid = _packings(200, 4, 96, True, seed=5)
    for picks in (
        tsolver.solve_greedy(t(mv), t(w), t(valid), 96),
        tdual.solve_lp_device(t(mv), t(w), t(valid), 96),
    ):
        p = n(picks)
        assert not (p & ~valid).any()
        for b in range(BATCH):
            used = [u for row in mv[b][p[b]] for u in set(row.tolist())]
            assert len(used) == len(set(used))


def test_pack_cliques_for_solver_matches_reference():
    rng = np.random.default_rng(0)
    member_idx = rng.integers(0, 50, (30, 3)).astype(np.int32)
    valid = rng.uniform(size=30) > 0.3
    want, nv_want = jsolver.pack_cliques_for_solver(
        jnp.asarray(member_idx), jnp.asarray(valid), 50
    )
    got, nv = tsolver.pack_cliques_for_solver(
        t(member_idx)[None], t(valid)[None], 50
    )
    assert nv == nv_want == 150
    np.testing.assert_array_equal(n(got)[0], n(want))
