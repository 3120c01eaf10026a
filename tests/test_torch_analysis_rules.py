"""The port's per-file rule pack (RT004, RT201-RT204) against the
reference's.

* The RT2xx cases, the noqa machinery (decorator lines, continuation
  lines) and the engine's error contract are free of JAX idiom: they
  run as twins of ``tests/test_analysis_rules.py`` (the reference's
  assertions hold for both packages, and both find the same (rule,
  line, column) set).
* RT004 is re-derived for torch: each JAX snippet of the reference has
  a torch snippet with the same line layout (a ``@checked`` entry or a
  kernel wrapper in place of ``jax.jit``, ``.item()`` and ``.cpu()``
  beside ``float()``), and the same rule fires at the same line in
  each package.
* The port's own: the RT2xx scope is the package named exactly, RT203
  reads the port's journal enum, and RT004 knows CUDA tensors and
  ``torch.cuda.synchronize()``.
"""

import textwrap

import pytest
from torch_analysis_twin import assert_same, run_recorded

from repic_tpu.analysis import analyze_source as jax_analyze
from repic_tpu_torch.analysis import analyze_source
from repic_tpu_torch.analysis.rules import journal_statuses

FILE = "test_analysis_rules.py"
RT2XX = ("RT201", "RT202", "RT203", "RT204")
RECORD = ("analyze_source",)


def _src(s: str) -> str:
    return textwrap.dedent(s).strip("\n") + "\n"


# -- twins of the reference's JAX-free cases -------------------------


@pytest.mark.parametrize("rule_id", RT2XX)
@pytest.mark.parametrize("name", [
    "test_positive_fires_at_line",
    "test_negative_is_clean",
    "test_noqa_suppresses_the_flagged_line",
    "test_blanket_noqa_suppresses",
    "test_rt2xx_apply_only_inside_the_package",
])
def test_rt2xx_case_holds_for_both_packages(name, rule_id, tmp_path):
    assert_same(run_recorded(FILE, name, tmp_path, RECORD,
                             args=(rule_id,)))


@pytest.mark.parametrize("name", [
    "test_syntax_error_is_reported_not_raised",
    "test_rt201_exempts_runtime_atomic_itself",
    "test_rt202_start_run_without_finally_fires",
    "test_rt202_start_run_with_finally_is_clean",
    "test_rt203_variable_status_is_not_guessed",
    "test_decorator_noqa_suppresses_def_line_finding",
    "test_decorator_noqa_for_other_rule_does_not_suppress",
    "test_decorator_blanket_noqa_suppresses_def_line_finding",
    "test_noqa_on_closing_paren_suppresses_multiline_call",
    "test_noqa_on_any_continuation_line_suppresses_the_call",
    "test_continuation_noqa_for_other_rule_does_not_suppress",
    "test_continuation_noqa_does_not_leak_to_later_lines",
])
def test_case_holds_for_both_packages(name, tmp_path):
    assert_same(run_recorded(FILE, name, tmp_path, RECORD))


def test_missing_path_is_an_error_not_a_green_gate(tmp_path):
    # the case imports run_paths inside itself: its assertions are the
    # comparison (an RT000 error finding for the missing path)
    run_recorded(FILE, "test_missing_path_is_an_error_not_a_green_gate",
                 tmp_path, ())


# -- RT004, re-derived: the JAX idiom and the torch idiom --------------

#: case -> (jax positive, torch positive, line, jax negative, torch
#: negative): a jitted callee against a @checked entry, and a jitted
#: wrapper against a kernel wrapper imported from another module
RT004 = {
    "jit": (
        """
        import jax

        @jax.jit
        def step(x):
            return x * 2

        def run(xs):
            total = 0.0
            for x in xs:
                y = step(x)
                total += float(y)
            return total
        """,
        """
        from repic_tpu_torch.analysis.contracts import checked

        @checked(CONTRACT)
        def step(x):
            return x * 2

        def run(xs):
            total = 0.0
            for x in xs:
                y = step(x)
                total += float(y)
            return total
        """,
        11,
        """
        import jax

        @jax.jit
        def step(x):
            return x * 2

        def run(xs):
            ys = []
            for i, x in enumerate(xs):
                y = step(x)
                ys.append(y)
                if i % 10 == 0:
                    print(float(y))
            return ys
        """,
        """
        from repic_tpu_torch.analysis.contracts import checked

        @checked(CONTRACT)
        def step(x):
            return x * 2

        def run(xs):
            ys = []
            for i, x in enumerate(xs):
                y = step(x)
                ys.append(y)
                if i % 10 == 0:
                    print(float(y))
            return ys
        """,
    ),
    "wrapper": (
        """
        import jax

        solve = jax.jit(lambda mv, w: w)

        def run(batches):
            out = []
            for mv, w in batches:
                picked = solve(mv, w)
                out.append(picked.item())
            return out
        """,
        """
        from repic_tpu_torch.ops.megakernel import fused_dual_solve

        solve = fused_dual_solve

        def run(batches):
            out = []
            for mv, w in batches:
                picked = fused_dual_solve(mv, w, w > 0, 8)
                out.append(picked.cpu())
            return out
        """,
        9,
        """
        import jax

        solve = jax.jit(lambda mv, w: w)

        def run(batches):
            out = []
            for mv, w in batches:
                out.append(solve(mv, w))
            return [o.item() for o in out]
        """,
        """
        from repic_tpu_torch.ops.megakernel import fused_dual_solve

        solve = fused_dual_solve

        def run(batches):
            out = []
            for mv, w in batches:
                out.append(fused_dual_solve(mv, w, w > 0, 8))
            return [o.cpu() for o in out]
        """,
    ),
}


def _hits(pkg, source, rule="RT004", select=None):
    analyze = jax_analyze if pkg == "jax" else analyze_source
    root = "repic_tpu" if pkg == "jax" else "repic_tpu_torch"
    return [f for f in analyze(source, f"{root}/x.py", select=select)
            if f.rule == rule]


@pytest.mark.parametrize("case", sorted(RT004))
def test_rt004_positive_fires_at_the_same_line(case):
    jpos, tpos, line, _, _ = RT004[case]
    assert _src(jpos).count("\n") == _src(tpos).count("\n")
    for pkg, src in (("jax", jpos), ("port", tpos)):
        hits = _hits(pkg, _src(src))
        assert [h.line for h in hits] == [line], (pkg, hits)


@pytest.mark.parametrize("case", sorted(RT004))
def test_rt004_negative_is_clean_in_both(case):
    _, _, _, jneg, tneg = RT004[case]
    assert _src(jneg).count("\n") == _src(tneg).count("\n")
    assert _hits("jax", _src(jneg)) == []
    assert _hits("port", _src(tneg)) == []


@pytest.mark.parametrize("blanket", [False, True], ids=["id", "blanket"])
@pytest.mark.parametrize("case", sorted(RT004))
def test_rt004_noqa_suppresses_in_both(case, blanket):
    jpos, tpos, line, _, _ = RT004[case]
    tag = "  # repic: noqa" if blanket else "  # repic: noqa[RT004]"
    for pkg, src in (("jax", jpos), ("port", tpos)):
        lines = _src(src).splitlines()
        lines[line - 1] += tag
        assert _hits(pkg, "\n".join(lines) + "\n") == []


def _positive(rule_id, pkg):
    """(source, line) of ``rule_id``'s positive snippet for ``pkg``."""
    if rule_id == "RT004":
        jpos, tpos, line, _, _ = RT004["jit"]
        return _src(jpos if pkg == "jax" else tpos), line
    from torch_twin import load_twin

    source, line, _ = load_twin(FILE, pkg).CASES[rule_id]
    return _src(source), line


@pytest.mark.parametrize("rule_id", ("RT004",) + RT2XX)
def test_noqa_for_other_rule_does_not_suppress(rule_id):
    for pkg in ("jax", "port"):
        source, line = _positive(rule_id, pkg)
        lines = source.splitlines()
        lines[line - 1] += "  # repic: noqa[RT999]"
        hits = _hits(pkg, "\n".join(lines) + "\n", rule_id)
        assert [h.line for h in hits] == [line], (pkg, rule_id)


@pytest.mark.parametrize("rule_id", ("RT004",) + RT2XX)
def test_select_filters_rules(rule_id):
    other = "RT201" if rule_id != "RT201" else "RT204"
    for pkg in ("jax", "port"):
        source, _ = _positive(rule_id, pkg)
        assert _hits(pkg, source, rule_id, select={other}) == []
        assert _hits(pkg, source, rule_id, select={rule_id})


@pytest.mark.parametrize("sync", ["item", "cpu"])
def test_rt004_flags_sync_in_while_test(sync):
    jax_src = _src(
        """
        import jax

        @jax.jit
        def loss(x):
            return x * 0.5

        def fit(x):
            while float(loss(x)) > 0.1:
                x = x * 0.9
            return x
        """
    )
    port_src = _src(
        f"""
        from repic_tpu_torch.analysis.contracts import checked

        @checked(CONTRACT)
        def loss(x):
            return x * 0.5

        def fit(x):
            while loss(x).{sync}() > 0.1:
                x = x * 0.9
            return x
        """
    )
    assert [h.line for h in _hits("jax", jax_src)] == [8]
    assert [h.line for h in _hits("port", port_src)] == [8]


# -- the port's own ----------------------------------------------------


def test_rt004_knows_cuda_tensors_and_device_syncs():
    src = _src(
        """
        import torch

        def poll(xs):
            out = []
            for x in xs:
                t = x.cuda()
                out.append(t.sum().item())
                torch.cuda.synchronize()
                z = torch.zeros(4, device="cuda")
                if len(out) % 10 == 0:
                    print(z.tolist())
            return out
        """
    )
    assert [h.line for h in _hits("port", src)] == [7, 8]
    assert "synchronize" in _hits("port", src)[1].message


def test_rt004_is_quiet_on_host_loops():
    src = _src(
        """
        import numpy as np
        import torch

        def host(xs):
            total = 0.0
            for x in xs:
                total += float(np.asarray(x).sum())
                total += torch.tensor(x).item()
            return total
        """
    )
    assert _hits("port", src) == []


@pytest.mark.parametrize("rule_id", RT2XX)
def test_rt2xx_scope_is_the_package_named_exactly(rule_id):
    """A file under ``repic_tpu/`` is not in the port's project, and a
    file under ``repic_tpu_torch/`` is not in the reference's."""
    from torch_twin import load_twin

    source, _, _ = load_twin(FILE, "jax").CASES[rule_id]
    src = _src(source).replace("repic_tpu.telemetry",
                               "repic_tpu_torch.telemetry")
    assert [f for f in analyze_source(src, f"repic_tpu_torch/{rule_id}.py")
            if f.rule == rule_id]
    for path in (f"repic_tpu/{rule_id}.py", f"repic_tpu_torchx/{rule_id}.py",
                 f"tests/{rule_id}.py", "chip_smoke.py"):
        assert not [f for f in analyze_source(src, path)
                    if f.rule == rule_id], path
    ref_src = _src(source)
    assert not [f for f in jax_analyze(ref_src, f"repic_tpu_torch/{rule_id}.py")
                if f.rule == rule_id]


def test_rt203_reads_the_ports_journal_enum():
    from repic_tpu_torch.runtime import journal

    want = {v for k, v in vars(journal).items() if k.startswith("STATUS_")}
    assert journal_statuses() == frozenset(want)
    assert journal.DONE_STATUSES <= journal_statuses()
    src = _src(
        """
        def finish(journal, name):
            journal.record(name, "done")
            journal.record(name, "skipped")
        """
    )
    hits = [f for f in analyze_source(src, "repic_tpu_torch/x.py")
            if f.rule == "RT203"]
    assert [h.line for h in hits] == [2]


def test_rt204_exempts_the_ports_command_modules():
    src = _src(
        """
        def add_arguments(parser):
            pass


        def main(args):
            print(args)
        """
    )
    assert not [f for f in analyze_source(src, "repic_tpu_torch/commands/x.py")
                if f.rule == "RT204"]
