"""The RT5xx pass re-derived for the port's launch sites, against the
reference's.

A launch site of the port is a function that binds a hand-written
kernel through ``_build.load`` (the kernels' wrappers).  Each JAX
snippet of ``tests/test_analysis_cost.py`` for RT502 and RT512 (a
jitted program) has a torch snippet with the same line layout (a
kernel wrapper), and the same rule fires at the same line in each
package; noqa, ``select``, the rule table, the clean tree and the
pass's non-vacuity are held too.  RT501, RT503 and RT511 are not
ported (no jit, no traced shapes; kernel 3's shared memory is checked
at run time).
"""

import os
import textwrap

import pytest
from torch_analysis_twin import paired

from repic_tpu.analysis.cost import run_cost as jax_cost
from repic_tpu_torch.analysis.cost import COST_RULES, cost_summary, run_cost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREE = os.path.join(ROOT, "repic_tpu_torch")


def _run(pkg, path, select=None):
    return (jax_cost if pkg == "jax" else run_cost)([path], select=select)


#: the launching callee: a jitted program, a kernel wrapper
SOLVE = {
    "jax": """
        import jax

        @jax.jit
        def solve(x):
            return x
        """,
    "port": """
        from repic_tpu_torch import _build

        # a kernel wrapper: binds csrc/dual.cu and launches it
        def solve(x):
            return _build.load("dual").fused_dual_solve(x)
        """,
}

PAIRS = {
    "rt502_loop_fetch_feeds_a_launch": ("""
        def per_item(items, x):
            out = []
            for it in items:
                y = solve(x).item()
                out.append(solve(y))
            return out
        """, "RT502", [10], ".item()"),
    "rt502_clean_when_the_fetch_never_feeds_a_launch": ("""
        def collect(items, x):
            out = []
            for it in items:
                out.append(solve(x).item())
            return out
        """, "RT502", [], None),
    "rt502_cpu_fetch_feeds_a_launch": ("""
        def per_item(items, x):
            out = []
            for it in items:
                y = solve(x).tolist()
                out.append(solve(y))
            return out
        """, "RT502", [10], ".tolist()"),
}


def _pair(body):
    return {pkg: textwrap.dedent(SOLVE[pkg]) + "\n"
            + textwrap.dedent(body).lstrip("\n") for pkg in SOLVE}


@pytest.mark.parametrize("case", sorted(PAIRS))
def test_rule_fires_at_the_same_line_in_both(case, tmp_path):
    body, rule, lines, part = PAIRS[case]
    found = paired(_pair(body), tmp_path, _run)
    for pkg in ("jax", "port"):
        hits = [f for f in found[pkg] if f.rule == rule]
        assert [f.line for f in hits] == lines, (pkg, found[pkg])
        if part:
            assert part in hits[0].message


def test_rt502_interprocedural_through_a_builder(tmp_path):
    """The fetch feeds a plain function that only TRANSITIVELY
    launches (the escalation loop's shape)."""
    pair = {
        "jax": """
            import jax
            import numpy as np

            def build(n):
                return jax.jit(lambda x: x)

            def escalate(x):
                n = 4
                while True:
                    fn = build(n)
                    probe = np.asarray(x)
                    n = int(probe.max())
                    fn2 = build(n)
                    break
                return fn2
            """,
        "port": """
            import numpy as np
            from repic_tpu_torch import _build

            def build(n):
                return _build.load("cliques")

            def escalate(x):
                n = 4
                while True:
                    fn = build(n)
                    probe = np.asarray(x)
                    n = int(probe.max())
                    fn2 = build(n)
                    break
                return fn2
            """,
    }
    found = paired(pair, tmp_path, _run)
    for pkg in ("jax", "port"):
        assert [f.line for f in found[pkg] if f.rule == "RT502"] == [11], pkg


BUDGETED = {
    "jax": """
        import jax
        from repic_tpu.analysis.contracts import Contract, checked

        @jax.jit
        def prog1(x):
            return x

        @jax.jit
        def prog2(x):
            return x

        @checked(Contract(args={}, returns={}, dispatch_budget=%d))
        def entry(x):
            return prog2(prog1(x))
        """,
    "port": """
        from repic_tpu_torch import _build
        from repic_tpu_torch.analysis.contracts import Contract, checked

        # kernel 2's wrapper
        def prog1(x):
            return _build.load("cliques").fused_clique_count(x)

        # kernel 3's wrapper
        def prog2(x):
            return _build.load("dual").fused_dual_solve(x)

        @checked(Contract(args={}, returns={}, dispatch_budget=%d))
        def entry(x):
            return prog2(prog1(x))
        """,
}


def _budgeted(budget, noqa=False):
    out = {}
    for pkg, src in BUDGETED.items():
        src = src % budget
        if noqa:
            src = src.replace(f"dispatch_budget={budget}))",
                              f"dispatch_budget={budget}))  "
                              "# repic: noqa[RT512]")
        out[pkg] = src
    return out


def test_rt512_fires_when_reachable_launches_exceed_budget(tmp_path):
    found = paired(_budgeted(1), tmp_path, _run)
    for pkg in ("jax", "port"):
        hits = [f for f in found[pkg] if f.rule == "RT512"]
        assert [f.line for f in hits] == [13], pkg
        assert "dispatch_budget=1" in hits[0].message
        assert "prog1" in hits[0].message


def test_rt512_clean_within_budget(tmp_path):
    found = paired(_budgeted(2), tmp_path, _run)
    assert found == {"jax": [], "port": []}


def test_rt512_noqa_on_the_decorator_line_suppresses(tmp_path):
    found = paired(_budgeted(1, noqa=True), tmp_path, _run)
    assert found == {"jax": [], "port": []}


def test_select_filters_to_one_rule(tmp_path):
    pair = _pair(PAIRS["rt502_loop_fetch_feeds_a_launch"][0])
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        d.mkdir()
        (d / "a.py").write_text(pair[pkg])
        (d / "b.py").write_text(textwrap.dedent(_budgeted(1)[pkg]))
        assert {f.rule for f in _run(pkg, str(d))} == {"RT502", "RT512"}
        assert {f.rule for f in _run(pkg, str(d), select={"RT512"})} == {
            "RT512"}


def test_cost_rules_registered():
    assert set(COST_RULES) == {"RT502", "RT512"}


@pytest.fixture(scope="module")
def port_program():
    """The port's program, built once for this file."""
    from repic_tpu_torch.analysis import cost
    from repic_tpu_torch.analysis.concurrency import build_program

    built = build_program([TREE])
    mp = pytest.MonkeyPatch()
    mp.setattr(cost, "build_program", lambda paths: (
        built if list(paths) == [TREE] else build_program(paths)))
    yield built
    mp.undo()


def test_real_tree_is_clean(port_program):
    findings = run_cost([TREE])
    assert not findings, "\n".join(
        f"{f.path}:{f.line}: {f.rule} {f.message}" for f in findings
    )


def test_real_tree_non_vacuity(port_program):
    """A refactor that renamed ``_build.load`` or ``@checked`` would
    silently blind this pass; pin what it sees: the four kernel
    wrappers' launch sites, the 13 entries, the three budgets."""
    got = cost_summary([TREE])
    assert got["launch_sites"] == 4
    assert got["launch_functions"] >= 4
    assert got["checked_entries"] == 13
    assert got["budgeted_entries"] == 3
    assert got["dispatch_reaching"] >= 10


def test_real_budgets_count_the_kernels_they_reach(port_program):
    """The staged chunk entry reaches all three kernels (within its 5);
    each fused wrapper reaches its own (within its 3)."""
    from repic_tpu_torch.analysis.concurrency import _FnWalker
    from repic_tpu_torch.analysis.cost import (
        _build_ctx,
        _load_sites,
    )
    from repic_tpu_torch.analysis.spmd import _closure_from

    program, _errors = port_program
    walkers = {id(fn): _FnWalker(program, fn) for fn in program.functions}
    ctx = _build_ctx(program, walkers)
    reached = {}
    for fn, budget, _node in ctx.budgeted:
        sites = {r.qual for r, _c in _closure_from(program, [fn]).values()
                 if _load_sites(r)}
        reached[fn.qual.rsplit(".", 1)[-1]] = (budget, sites)
    ops = "repic_tpu_torch.ops."
    assert reached == {
        "consensus_one": (5, {
            ops + "iou_pallas.topk_neighbors",
            ops + "megakernel.fused_clique_candidates",
            ops + "megakernel.fused_dual_solve"}),
        "fused_clique_candidates": (3, {
            ops + "megakernel.fused_clique_candidates"}),
        "fused_dual_solve": (3, {ops + "megakernel.fused_dual_solve"}),
    }


def test_rt502_sees_a_conditional_choice_of_program(tmp_path):
    """The escalation loop's shape: ``program = a if cond else b``, a
    fetch of its output sizing the next call of it."""
    p = tmp_path / "mod.py"
    p.write_text(textwrap.dedent("""
        from repic_tpu_torch import _build

        def fused(x, d):
            return _build.load("cliques")

        def staged(x, d):
            return _build.load("neighbors")

        def batch(x, gang):
            program = staged if gang else fused
            d = 4
            while True:
                out = program(x, d)
                packed = out.cpu().numpy()
                d = int(packed.max())
                if d > 8:
                    continue
                return out
        """).lstrip("\n"))
    found = [f for f in run_cost([str(p)]) if f.rule == "RT502"]
    assert [f.line for f in found] == [14]
    assert "fused" in found[0].message or "staged" in found[0].message
