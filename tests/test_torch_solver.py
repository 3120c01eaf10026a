"""The port's lp and exact rungs and its host ladder against the JAX
package's.

* ``solve_lp_rounding``: picks exact (tolerance 0) against the
  reference on its chains, random conflict soups, near-tie packings,
  batched (vmapped) and empty inputs; never worse than greedy.
* ``solve_exact_py`` and the native ``solve_exact``: the optimum of
  brute force, picks identical to each other and to the reference's
  oracle, the deep chain, empty input, negative ids rejected, the
  budget.
* ``solve_host_ladder``: the same picks and rung as the reference's,
  degrading exact -> lp -> greedy.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repic_tpu.ops import solver as jsolver
from repic_tpu.runtime import ladder as jladder
from repic_tpu_torch import native
from repic_tpu_torch.ops import solver as tsolver
from repic_tpu_torch.runtime import ladder as tladder
from repic_tpu_torch.utils.synthetic import near_tie_packings
from torch_port_common import n, t


def random_instance(rng, n_cliques, k, n_vertices):
    mv = rng.integers(0, n_vertices, size=(n_cliques, k)).astype(np.int32)
    w = rng.uniform(0.01, 1.0, size=n_cliques).astype(np.float32)
    return mv, w


def brute_force_value(member_vertex, w):
    best = -1.0
    for bits in itertools.product([0, 1], repeat=len(w)):
        used, ok, val = set(), True, 0.0
        for c in range(len(w)):
            if bits[c]:
                verts = set(int(v) for v in member_vertex[c])
                if used & verts:
                    ok = False
                    break
                used |= verts
                val += w[c]
        if ok and val > best:
            best = val
    return best


def _j_lp(mv, w, valid, v):
    return n(jax.jit(
        lambda a, b, c: jsolver.solve_lp_rounding(a, b, c, v)
    )(mv, w, valid))


CHAIN3 = (np.array([[0, 1, 2], [2, 3, 4], [4, 5, 6]], np.int32),
          np.array([0.6, 1.0, 0.6], np.float32), 7)
CHAIN5 = (np.array([[0, 1, 2], [2, 3, 4], [4, 5, 6], [6, 7, 8],
                    [8, 9, 10]], np.int32),
          np.array([1.0, 1.1, 1.0, 1.1, 1.0], np.float32), 11)


@pytest.mark.parametrize("case", [CHAIN3, CHAIN5], ids=["chain3", "chain5"])
def test_lp_rounding_chains_match_reference(case):
    mv, w, v = case
    valid = np.ones(len(w), bool)
    got = n(tsolver.solve_lp_rounding(t(mv)[None], t(w)[None],
                                      t(valid)[None], v))[0]
    np.testing.assert_array_equal(got, _j_lp(mv, w, valid, v))
    # pricing recovers the optimum where greedy takes the middles
    assert np.isclose(w[got].sum(), brute_force_value(mv, w))


@pytest.mark.parametrize("c,k,v,seed", [
    (40, 3, 25, 0), (14, 3, 12, 1), (300, 4, 120, 2), (400, 2, 60, 3),
    (1000, 5, 300, 4),
])
def test_lp_rounding_random_matches_reference(c, k, v, seed):
    rng = np.random.default_rng(seed)
    for _ in range(4):
        mv, w = random_instance(rng, c, k, v)
        valid = rng.uniform(size=c) > 0.1
        got = n(tsolver.solve_lp_rounding(t(mv)[None], t(w)[None],
                                          t(valid)[None], v))[0]
        np.testing.assert_array_equal(got, _j_lp(mv, w, valid, v))
        g = n(tsolver.solve_greedy(t(mv)[None], t(w)[None],
                                   t(valid)[None], v))[0]
        assert not (got & ~valid).any()
        assert w[got].sum() >= w[g].sum() - 1e-6


@pytest.mark.parametrize("gadgets,background,seed", [(1, 60, 0), (2, 200, 1)])
def test_lp_rounding_batched_near_ties_match_reference(gadgets, background,
                                                       seed):
    """A batch of near-tie packings against the vmapped reference."""
    mv, w, valid, v = near_tie_packings(16, gadgets, background, seed)
    want = n(jax.jit(jax.vmap(
        lambda a, b, c: jsolver.solve_lp_rounding(a, b, c, v)
    ))(mv, w, valid))
    got = n(tsolver.solve_lp_rounding(t(mv), t(w), t(valid), v))
    np.testing.assert_array_equal(got, want)


def test_lp_rounding_empty_and_all_invalid():
    mv = np.zeros((2, 0, 3), np.int32)
    got = tsolver.solve_lp_rounding(t(mv), t(np.zeros((2, 0), np.float32)),
                                    t(np.zeros((2, 0), bool)), 9)
    assert got.shape == (2, 0)
    mv, w = random_instance(np.random.default_rng(5), 20, 3, 15)
    got = n(tsolver.solve_lp_rounding(t(mv)[None], t(w)[None],
                                      t(np.zeros((1, 20), bool)), 15))
    assert not got.any()


def test_exact_matches_brute_force(rng):
    for _ in range(8):
        mv, w = random_instance(rng, 12, 3, 10)
        w = w.astype(np.float64)
        best = brute_force_value(mv, w)
        for got in (tsolver.solve_exact_py(mv, w),
                    tsolver.solve_exact(mv, w)):
            np.testing.assert_allclose(w[got].sum(), best, rtol=1e-9)


@pytest.mark.parametrize("c,k,v,seed", [(40, 3, 30, 0), (120, 3, 300, 1),
                                        (80, 4, 300, 2)])
def test_native_and_python_exact_pick_the_same(c, k, v, seed):
    """The native core, the port's oracle and the reference's oracle
    give identical picks (the same branching order and ties)."""
    rng = np.random.default_rng(seed)
    for _ in range(3):
        mv, w = random_instance(rng, c, k, v)
        w = w.astype(np.float64)
        want = jsolver.solve_exact_py(mv, w)
        np.testing.assert_array_equal(tsolver.solve_exact_py(mv, w), want)
        np.testing.assert_array_equal(tsolver.solve_exact(mv, w), want)


def test_exact_chain_empty_and_negative_ids():
    mv, w, _ = CHAIN3
    got = tsolver.solve_exact(mv, w.astype(np.float64))
    assert list(got) == [True, False, True]
    empty = tsolver.solve_exact(np.zeros((0, 3), np.int32), np.zeros(0))
    assert empty.shape == (0,)
    with pytest.raises(ValueError):
        tsolver.solve_exact(np.array([[0, -1, 2]], np.int32),
                            np.array([1.0]))


def test_native_deep_chain():
    """One 30,000-clique chain: the iterative search reaches depth
    30,000 and picks every other clique."""
    size = 30_000
    mv = np.stack([np.arange(size), np.arange(size) + 1,
                   np.arange(size) + size + 10], axis=1).astype(np.int32)
    got = native.solve_exact_native(mv, np.ones(size), node_limit=500_000)
    assert got.sum() == (size + 1) // 2


def test_node_limit_fallback_is_logged():
    rng = np.random.default_rng(3)
    mv, w = random_instance(rng, 40, 3, 12)
    logs = {}
    for name, fn in (("native", tsolver.solve_exact),
                     ("python", tsolver.solve_exact_py)):
        log: list = []
        fn(mv, w.astype(np.float64), node_limit=3, fallback_log=log)
        logs[name] = log
    assert logs["native"] and logs["python"]


def test_budget_raises():
    mv, w = random_instance(np.random.default_rng(4), 60, 3, 40)
    with pytest.raises(tsolver.SolverBudgetExceeded):
        tsolver.solve_exact(mv, w.astype(np.float64), budget_s=-1.0)


@pytest.mark.parametrize("solver,budget", [
    ("exact", None), ("exact", 0.0), ("exact", -1.0), ("lp", None),
    ("lp_device", None), ("greedy", None),
])
def test_host_ladder_matches_reference(solver, budget):
    """Same picks and the same rung; an exhausted budget degrades
    exact -> lp."""
    rng = np.random.default_rng(11)
    mv, w = random_instance(rng, 80, 3, 50)
    want, used_want = jladder.solve_host_ladder(
        mv, w, 50, solver=solver, budget_s=budget)
    got, used = tladder.solve_host_ladder(
        mv, w, 50, solver=solver, budget_s=budget, device="cpu")
    assert used == used_want
    np.testing.assert_array_equal(got, n(want))
    if budget is not None and budget < 0:
        assert used == "lp"


def test_host_ladder_degrades_to_greedy(monkeypatch):
    """The lp rung failing too leaves greedy, which always ends."""
    def broke(*a, **k):
        raise tsolver.SolverBudgetExceeded("test")

    monkeypatch.setattr(tsolver, "solve_lp_rounding", broke)
    mv, w = random_instance(np.random.default_rng(12), 50, 3, 30)
    got, used = tladder.solve_host_ladder(mv, w, 30, budget_s=-1.0,
                                          device="cpu")
    assert used == "greedy"
    want = n(jsolver.solve_greedy(jnp.asarray(mv), jnp.asarray(w),
                                  jnp.ones(50, bool), 30))
    np.testing.assert_array_equal(got, want)


def test_host_ladder_node_limit_rung_and_empty():
    mv, w = random_instance(np.random.default_rng(3), 40, 3, 12)
    _, used = tladder.solve_host_ladder(mv, w, 12, node_limit=3,
                                        device="cpu")
    _, used_want = jladder.solve_host_ladder(mv, w, 12, node_limit=3)
    assert used == used_want == "exact_fallback"
    picked, used = tladder.solve_host_ladder(
        np.zeros((0, 3), np.int32), np.zeros(0, np.float32), 5,
        device="cpu")
    assert picked.shape == (0,) and used == "exact"


@pytest.mark.parametrize("age,stopped,fenced", [
    (None, False, False), (1.0, False, False), (99.0, False, False),
    (1.0, True, False), (1.0, True, True),
])
def test_host_rung_matches_reference(age, stopped, fenced):
    assert tladder.host_rung(age, 10.0, stopped=stopped, fenced=fenced) \
        == jladder.host_rung(age, 10.0, stopped=stopped, fenced=fenced)


def test_native_and_python_exact_at_scale():
    """Five thousand cliques in 250 loosely coupled clusters (the
    dense-micrograph shape): the native core and the Python oracle
    pick the same, feasibly."""
    rng = np.random.default_rng(0)
    mv = np.concatenate([
        rng.integers(30 * c, 30 * c + 25, size=(20, 3)) for c in range(250)
    ]).astype(np.int32)
    w = rng.uniform(0.01, 1.0, size=len(mv))
    got = tsolver.solve_exact(mv, w)
    np.testing.assert_array_equal(got, tsolver.solve_exact_py(mv, w))
    used = [v for row in mv[got] for v in set(row.tolist())]
    assert len(used) == len(set(used))


@pytest.mark.parametrize("length", [33, 4097, 100_000])
def test_objective_sum_matches_1d_reference_sum(length):
    """The unbatched lp solves (striped, run_ilp) sum a 1-D objective:
    XLA's CPU program reduces it in the order of a row sum."""
    from repic_tpu_torch.solver.dual import objective_sum

    rng = np.random.default_rng(length)
    x = (rng.uniform(0, 1, length)
         * (rng.uniform(size=length) > 0.5)).astype(np.float32)
    want = n(jax.jit(lambda a: jnp.sum(a))(x))
    got = n(objective_sum(t(x)[None]))[0]
    assert got.view(np.uint32) == want.view(np.uint32)
