"""The staged ``lp_device`` program's dual ascent around its kernel
(CPU): the dispatch, the residency chooser of the ascent kernel, and
the step count of a launch, read after the chunk's fetch.

On a CPU tensor the ascent is the plain loop, bit for bit, at any
clique width, and launches nothing; the kernel itself runs only on the
card, at any width too (``tests/test_torch_cuda.py``).  The chooser
places a packing from V, C and K alone: every clique in shared memory
while it fits, then the cliques past it in a global slice, then the
vertex state too.
"""

import threading


import numpy as np
import pytest
import torch

from repic_tpu_torch.ops import megakernel as tmk
from repic_tpu_torch.solver import dual as tdual
from repic_tpu_torch.telemetry import probes as tprobes

LIMIT = tmk.SMEM_LIMIT


def _inputs(m, c, k, v, seed=0):
    rng = np.random.default_rng(seed)
    mv = torch.from_numpy(rng.integers(0, v, (m, c, k)).astype(np.int32))
    w = torch.from_numpy(rng.uniform(0.1, 1.0, (m, c)).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=(m, c)) < 0.8)
    return mv, w, valid


def _bits(x):
    return x.numpy().view(np.int32)


def _same_bits(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("c,k,v", [(40, 2, 32), (120, 3, 64), (96, 5, 40)])
def test_cpu_ascent_is_the_plain_loop_and_launches_nothing(c, k, v):
    args = _inputs(3, c, k, v, seed=c)
    before = dict(tmk.LAUNCHES), dict(tmk.ASCENT_RESIDENCY)
    want = tdual.dual_ascent_plain(*args, v)
    _same_bits(tdual.run_dual_ascent(*args, v), want)
    _same_bits(tmk.dual_ascent(*args, v), want)
    assert (dict(tmk.LAUNCHES), dict(tmk.ASCENT_RESIDENCY)) == before


@pytest.mark.parametrize("c,k,v", [(40, 2, 32), (200, 4, 96), (96, 5, 40)])
def test_cpu_solve_is_the_plain_solve(c, k, v):
    args = _inputs(4, c, k, v, seed=k)
    got = tdual.solve_dual_decomposition(*args, v)
    want = tdual.solve_dual_decomposition_plain(*args, v)
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name).numpy(), name)


def test_plain_loop_counts_a_sync_per_test_and_a_step_per_trip():
    mv, w, valid = _inputs(3, 120, 3, 64)
    syncs0, steps0 = tprobes.chunk_counts()
    t = tdual.dual_ascent_plain(mv, w, valid, 64, tol=0.05)[2]
    syncs1, steps1 = tprobes.chunk_counts()
    trips = int(t.max())
    assert 0 < trips < tdual.DEFAULT_NUM_ITERS
    assert (syncs1 - syncs0, steps1 - steps0) == (trips + 1, trips)


def test_rows_stop_at_their_own_step():
    """A row whose prices settle stops and is frozen while the others
    step on: the per-row steps and deltas of the batched loop."""
    mv, w, valid = _inputs(4, 300, 3, 80, seed=5)
    valid[0] = False          # nothing to price: settles at once
    lam, lam_avg, t, delta = tdual.dual_ascent_plain(mv, w, valid, 80,
                                                     tol=0.05)
    assert int(t[0]) == 1 and float(delta[0]) == 0.0
    assert len(set(t.tolist())) > 1
    stopped = t < tdual.DEFAULT_NUM_ITERS
    assert bool((delta[stopped] <= 0.05).all())


@pytest.mark.parametrize("k", [1, 6, 8, 9])
def test_cpu_ascent_at_any_width_is_the_plain_loop(k):
    args = _inputs(2, 60, k, 48, seed=k)
    launches = dict(tmk.LAUNCHES)
    _same_bits(tdual.run_dual_ascent(*args, 48),
               tdual.dual_ascent_plain(*args, 48))
    assert dict(tmk.LAUNCHES) == launches


def test_k7_runs_the_plain_loop():
    """On the CPU; on the card the kernel takes K = 7 at run time."""
    args = _inputs(2, 50, 7, 40)
    _same_bits(tdual.run_dual_ascent(*args, 40),
               tdual.dual_ascent_plain(*args, 40))


def test_cpu_ascent_takes_int64_ids():
    mv, w, valid = _inputs(2, 80, 3, 40, seed=3)
    _same_bits(tdual.run_dual_ascent(mv.long(), w, valid, 40),
               tdual.dual_ascent_plain(mv, w, valid, 40))


def _largest_shared(v, k):
    c = 0
    while tmk.ascent_smem_bytes(v, k, c + 1, True) <= LIMIT:
        c += 1
    return c


@pytest.mark.parametrize("v,k", [(3840, 5), (1024, 3), (64, 2),
                                 (17000, 5)])
def test_residency_is_shared_to_the_limit_then_split(v, k):
    c = _largest_shared(v, k)
    assert tmk.ascent_residency(v, c, k) == ("shared", c)
    for c2 in (c + 1, 4 * c):
        kind, n_near = tmk.ascent_residency(v, c2, k)
        assert kind == "split" and 0 < n_near <= c
        assert tmk.ascent_smem_bytes(v, k, n_near, True) <= LIMIT
        # within a few cliques of all that fit
        assert tmk.ascent_smem_bytes(v, k, n_near + 5, True) > LIMIT


def test_residency_is_global_once_the_state_leaves_shared_memory():
    # V x 12 B (each array 16-byte aligned) against the limit
    v = max(v for v in range(19000, 19400)
            if 3 * ((4 * v + 15) // 16 * 16) <= LIMIT)
    kind, n_near = tmk.ascent_residency(v, 10_000, 5)
    assert kind == "split" and n_near < 10_000
    kind, n_near = tmk.ascent_residency(v + 1, 20_000, 5)
    assert kind == "global" and 0 < n_near < 20_000
    assert tmk.ascent_smem_bytes(v + 1, 5, n_near, False) <= LIMIT
    assert tmk.ascent_smem_bytes(v + 1, 5, n_near + 5, False) > LIMIT
    # a small packing keeps every clique in shared memory all the same
    assert tmk.ascent_residency(v + 1, 256, 3) == ("global", 256)


def test_residency_stages_32_bit_ids_past_65535_vertices():
    assert tmk.ascent_smem_bytes(70_000, 3, 100, False) == \
        (100 * 3 * 4 + 15) // 16 * 16 + 400
    assert tmk.ascent_smem_bytes(65_535, 3, 100, False) == \
        (100 * 3 * 2 + 15) // 16 * 16 + 400
    kind, n_near = tmk.ascent_residency(70_000, 100_000, 3)
    assert kind == "global" and n_near == (LIMIT - 30) // 16


@pytest.mark.parametrize("k", [7, 9])
def test_residency_places_any_width(k):
    """Widths past kernel 3's take the same chooser: 2-byte ids and a
    weight a clique past the state."""
    c = _largest_shared(3840, k)
    assert tmk.ascent_residency(3840, c, k) == ("shared", c)
    assert tmk.ascent_residency(3840, 4 * c, k)[0] == "split"
    assert tmk.ascent_smem_bytes(3840, k, c, True) <= LIMIT \
        < tmk.ascent_smem_bytes(3840, k, c + 1, True)


@pytest.mark.parametrize("c", [24_576, 32_768])
def test_the_k5_chunk_splits(c):
    """K = 5, V = 3,840 (5 x 768): the state (46 KB) and 13,236
    cliques in shared memory, the rest in the global slice."""
    assert tmk.ascent_residency(3840, c, 5) == ("split", 13_236)


def test_deferred_steps_count_at_the_next_read():
    """The steps of an ascent kernel in a chunk count at the chunk's
    next read of the counts (after its packed fetch), as the most
    steps of any micrograph of its launch, and once; the read is one
    host sync."""
    syncs0, steps0 = tprobes.chunk_counts(first=True)
    tprobes.defer_ascent_steps(torch.tensor([3, 200, 7], dtype=torch.int32))
    tprobes.defer_ascent_steps(torch.tensor([5, 9], dtype=torch.int32))
    assert tprobes.chunk_counts() == (syncs0 + 1, steps0 + 209)
    assert tprobes.chunk_counts() == (syncs0 + 1, steps0 + 209)


def test_steps_outside_a_chunk_are_not_kept():
    """A launch outside a chunk (the runtime ladder's rung, a contract
    probe) keeps nothing and reads nothing."""
    tprobes.chunk_counts()
    before = tprobes.chunk_counts()
    tprobes.defer_ascent_steps(torch.tensor([50], dtype=torch.int32))
    assert tprobes._deferred.steps is None
    assert tprobes.chunk_counts() == before


def test_a_chunk_keeps_only_its_own_threads_steps():
    """Another thread's chunk neither sees nor reads this thread's
    launches."""
    syncs0, steps0 = tprobes.chunk_counts(first=True)

    def other():
        tprobes.chunk_counts(first=True)
        tprobes.defer_ascent_steps(torch.tensor([11], dtype=torch.int32))
        tprobes.chunk_counts()

    tprobes.defer_ascent_steps(torch.tensor([4], dtype=torch.int32))
    th = threading.Thread(target=other)
    th.start()
    th.join()
    assert tprobes.chunk_counts() == (syncs0 + 2, steps0 + 15)
