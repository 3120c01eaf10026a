"""The contract checker (``check``: RT101/RT102 and the kernel probes
RT423/RT425) re-derived for torch, against the reference's.

* RT101/RT102 cases of ``tests/test_analysis_semantic.py`` are paired:
  each JAX module (``jax.numpy``) has a torch module with the same line
  layout, and the same rule fires at the same line in each package.
  The reference checks with ``jax.eval_shape``; the port runs the entry
  on ``meta`` tensors, or -- where it reads values -- on seeded inputs
  on ``device``, and the report names the route.
* The skip, CLI and missing-path cases are free of JAX idiom and run as
  twins.
* The kernel probes: RT425 holds each kernel wrapper against its
  contract's reference over every rung (here, on the CPU, the wrapper's
  plain version), and a planted divergence fires naming the entry and
  the rung; without a card, ``--device cuda`` is a finding.
* The port's own tree checks clean: 12 entries, none skipped.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch
from torch_analysis_twin import assert_same, paired, run_recorded

from repic_tpu.analysis.semantic import run_check as jax_check
from repic_tpu_torch.analysis import contracts
from repic_tpu_torch.analysis.kernels import KERNEL_RULES, run_kernel_checks
from repic_tpu_torch.analysis.semantic import run_check

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILE = "test_analysis_semantic.py"
HEADER = {
    "jax": """
        import jax
        import jax.numpy as jnp

        from repic_tpu.analysis.contracts import Contract, checked, spec
        """,
    "port": """
        import torch
        import torch.nn.functional as F

        from repic_tpu_torch.analysis.contracts import Contract, checked, spec
        """,
}
KERNEL_ENTRIES = (
    "repic_tpu_torch.ops.iou_pallas.pallas_topk_neighbors",
    "repic_tpu_torch.ops.megakernel.fused_clique_candidates",
    "repic_tpu_torch.ops.megakernel.fused_dual_solve",
    "repic_tpu_torch.ops.megakernel.dual_ascent",
)


def _module(pkg, body):
    return (textwrap.dedent(HEADER[pkg]).lstrip("\n")
            + textwrap.dedent(body[pkg] if isinstance(body, dict) else body)
            .strip("\n") + "\n")


def _check(pkg, path):
    return (jax_check([path]) if pkg == "jax"
            else run_check([path], device="cpu"))


#: case -> (body: one source or {pkg: source}, rule, lines, {pkg: parts})
CASES = {
    "rt101_shape_mismatch": ({
        "jax": """
            @checked(Contract(
                args={"x": spec("N 2")},
                returns=spec("N 2"),
                dims={"N": 4},
            ))
            def widen(x):
                return jnp.concatenate([x, x], axis=1)
            """,
        "port": """
            @checked(Contract(
                args={"x": spec("N 2")},
                returns=spec("N 2"),
                dims={"N": 4},
            ))
            def widen(x):
                return torch.cat([x, x], dim=1)
            """,
    }, "RT101", [5], {"jax": ("(4, 4)", "(4, 2)"),
                      "port": ("(4, 4)", "(4, 2)")}),
    "rt101_dtype_mismatch": ("""
        @checked(Contract(
            args={"x": spec("N")},
            returns=spec("N", "int32"),
            dims={"N": 4},
        ))
        def ident(x):
            return x
        """, "RT101", [5], {"jax": ("dtype",), "port": ("dtype",)}),
    "rt101_failure_is_a_finding": ("""
        @checked(Contract(
            args={"x": spec("N 2"), "y": spec("M 3")},
            dims={"N": 4, "M": 5},
        ))
        def add(x, y):
            return x + y
        """, "RT101", [5], {"jax": ("trace failed",),
                            "port": ("failed under the declared",)}),
    "rt101_clean_contract_is_silent": ({
        "jax": """
            @checked(Contract(
                args={"x": spec("N 2"), "m": spec("N", "bool")},
                returns=spec("N 2"),
                dims={"N": 4},
            ))
            def masked(x, m):
                return jnp.where(m[:, None], x, 0.0)
            """,
        "port": """
            @checked(Contract(
                args={"x": spec("N 2"), "m": spec("N", "bool")},
                returns=spec("N 2"),
                dims={"N": 4},
            ))
            def masked(x, m):
                return torch.where(m[:, None], x, 0.0)
            """,
    }, "RT101", [], {}),
    "noqa_on_checked_decorator_suppresses": ({
        "jax": """
            @checked(Contract(  # repic: noqa[RT101]
                args={"x": spec("N 2")},
                returns=spec("N 2"),
                dims={"N": 4},
            ))
            def widen(x):
                return jnp.concatenate([x, x], axis=1)
            """,
        "port": """
            @checked(Contract(  # repic: noqa[RT101]
                args={"x": spec("N 2")},
                returns=spec("N 2"),
                dims={"N": 4},
            ))
            def widen(x):
                return torch.cat([x, x], dim=1)
            """,
    }, "RT101", [], {}),
    "rt102_unknown_axis_fires": ("""
        @checked(Contract(
            args={"x": spec("N 2")},
            dims={"N": 4},
            pspecs={"x": ("bogus_axis",)},
        ))
        def f(x):
            return x
        """, "RT102", [5], {"jax": ("bogus_axis",),
                            "port": ("bogus_axis",)}),
    "rt102_contract_mesh_axes_extend_the_known_set": ("""
        @checked(Contract(
            args={"x": spec("N 2")},
            dims={"N": 4},
            pspecs={"x": ("stripes", None)},
            mesh_axes=("stripes",),
        ))
        def f(x):
            return x
        """, "RT102", [], {}),
    "rt102_project_axis_is_known": ("""
        @checked(Contract(
            args={"x": spec("N 2")},
            dims={"N": 4},
            pspecs={"x": ("micrographs",)},
        ))
        def f(x):
            return x
        """, "RT102", [], {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rule_fires_at_the_same_line_in_both(case, tmp_path):
    body, rule, lines, parts = CASES[case]
    pair = {pkg: _module(pkg, body) for pkg in ("jax", "port")}
    reports = paired(pair, tmp_path, _check, name=f"{case}.py")
    for pkg in ("jax", "port"):
        hits = [f for f in reports[pkg].findings if f.rule == rule]
        assert [f.line for f in hits] == lines, (pkg, reports[pkg].findings)
        for part in parts.get(pkg, ()):
            assert part in hits[0].message, (pkg, hits[0].message)
        assert len(reports[pkg].checked) == 1 and not reports[pkg].skipped


@pytest.mark.parametrize("name", [
    "test_import_error_is_a_structured_skip",
    "test_cli_degraded_mode_no_traceback",
    "test_missing_path_is_an_error_not_a_green_gate",
])
def test_case_holds_for_both_packages(name, tmp_path):
    assert_same(run_recorded(FILE, name, tmp_path, ("run_check",)))


def test_cli_json_format(tmp_path):
    body = """
        @checked(Contract(
            args={"x": spec("N 2")},
            returns=spec("N 3"),
            dims={"N": 4},
        ))
        def f(x):
            return x
        """
    for pkg, mod, extra in (("jax", "repic_tpu.main", ()),
                            ("port", "repic_tpu_torch.main",
                             ("--device", "cpu"))):
        path = tmp_path / f"json_{pkg}.py"
        path.write_text(_module(pkg, body))
        proc = subprocess.run(
            [sys.executable, "-m", mod, "check", str(path), "--format",
             "json", *extra],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
            env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert proc.returncode == 1, proc.stdout + proc.stderr
        data = json.loads(proc.stdout)
        assert data["checked"] and data["skipped"] == []
        (finding,) = data["findings"]
        assert finding["rule"] == "RT101" and finding["line"] == 5
        assert {"severity", "message", "hint", "path", "line"} <= set(
            finding)
    assert data["device"] == "cpu"
    assert data["checked"][0]["route"] == "meta"


# -- the port's own routes --------------------------------------------


def _write_port(tmp_path, name, body):
    path = tmp_path / name
    path.write_text(_module("port", body))
    return str(path)


def test_value_reading_entry_runs_concrete_and_says_why(tmp_path):
    path = _write_port(tmp_path, "reads.py", """
        @checked(Contract(
            args={"x": spec("N 2")},
            returns=spec("K"),
            dims={"N": 4, "K": 3},
        ))
        def first_k(x):
            k = int((x.sum() * 0 + 3).item())
            return torch.zeros(k)
        """)
    report = run_check([path], device="cpu")
    assert report.findings == [] and report.skipped == []
    (rec,) = report.checked
    assert rec["route"] == "concrete"
    assert "meta" in rec["meta_error"]


def test_concrete_route_without_a_card_is_a_finding(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = _write_port(tmp_path, "reads_cuda.py", """
        @checked(Contract(
            args={"x": spec("N 2")},
            dims={"N": 4},
        ))
        def total(x):
            return x.sum().item()
        """)
    report = run_check([path], device="cuda")
    (f,) = report.findings
    assert f.rule == "RT101" and "--device cpu" in f.message
    assert report.skipped == []


def test_batch_axis_is_prepended_to_the_specs(tmp_path):
    path = _write_port(tmp_path, "batched.py", """
        @checked(Contract(
            args={"x": spec("N 2"), "s": spec("")},
            returns=(spec("N"), spec("")),
            dims={"N": 4},
            batch=3,
        ))
        def norms(x, s):
            assert x.shape == (3, 4, 2) and s.shape == ()
            return x.sum(-1) * s, x.sum((1, 2))
        """)
    report = run_check([path], device="cpu")
    assert report.findings == [], [f.format() for f in report.findings]


def test_example_contract_with_a_returns_callable(tmp_path):
    path = _write_port(tmp_path, "example.py", """
        def _example():
            return torch.zeros(5, 2), 3

        @checked(Contract(
            example=_example,
            returns=lambda inputs: spec((inputs[1], 2)),
        ))
        def head(x, k):
            return x[:k + 1]
        """)
    report = run_check([path], device="cpu")
    (f,) = report.findings
    assert f.rule == "RT101" and "(4, 2)" in f.message and "(3, 2)" in f.message


# -- the kernel probes -------------------------------------------------


def _entry(name):
    import importlib

    importlib.import_module(name.rsplit(".", 1)[0])
    return contracts.registry()[name]


@pytest.mark.parametrize("name", KERNEL_ENTRIES)
def test_rt425_holds_each_plain_version_over_every_rung(name):
    entry = _entry(name)
    findings = []
    run_kernel_checks(entry, "k.py", findings, lambda r: True,
                      device="cpu")
    assert findings == [], [f.format() for f in findings]


def _perturbed(entry):
    """The entry with its contract's reference disturbed on the last
    rung's shapes only."""
    kc = entry.contract.kernel
    last = dict(kc.ladder[-1])

    def bad_ref(*args, **kw):
        out = kc.reference(*args, **kw)
        first = next(a for a in args if isinstance(a, torch.Tensor))
        if tuple(first.shape) != tuple(
                kc.make_inputs(dict(last))[0][0].shape):
            return out
        out = list(out) if isinstance(out, (tuple, list)) else [out]
        leaf = out[0]
        out[0] = (~leaf if leaf.dtype == torch.bool else leaf + 1)
        return tuple(out) if len(out) > 1 else out[0]

    return dataclasses.replace(entry, contract=dataclasses.replace(
        entry.contract, kernel=dataclasses.replace(kc, reference=bad_ref)))


@pytest.mark.parametrize("name", KERNEL_ENTRIES)
def test_rt425_planted_divergence_names_the_entry_and_rung(name):
    entry = _perturbed(_entry(name))
    findings = []
    run_kernel_checks(entry, "k.py", findings, lambda r: r == "RT425",
                      device="cpu")
    last = dict(entry.contract.kernel.ladder[-1])
    assert [f.rule for f in findings] == ["RT425"], findings
    assert entry.name in findings[0].message
    assert f"rung {last}" in findings[0].message


def test_rt423_and_rt425_fire_in_both_packages():
    """The reference's case, paired: the kernel-1 entry's reference
    perturbed, each package's probe fires RT425."""
    import repic_tpu.ops.iou_pallas  # noqa: F401  (registration)
    from repic_tpu.analysis import contracts as jcontracts
    from repic_tpu.analysis.kernels import (
        run_kernel_checks as jax_kernel_checks,
    )

    jentry = jcontracts.registry()[
        "repic_tpu.ops.iou_pallas.pallas_topk_neighbors"]
    jkc = jentry.contract.kernel

    def jbad(*a):
        v, i, c = jkc.reference(*a)
        return v + 0.5, i, c

    jbroken = dataclasses.replace(jentry, contract=dataclasses.replace(
        jentry.contract, kernel=dataclasses.replace(
            jkc, reference=jbad, ladder=(jkc.ladder[-1],))))
    jfound, jskipped = [], []
    jax_kernel_checks(jbroken, "iou_pallas.py", jfound, jskipped,
                      lambda r: r in ("RT423", "RT425"))
    entry = _entry(KERNEL_ENTRIES[0])
    kc = entry.contract.kernel

    def bad(*a):
        v, i, c = kc.reference(*a)
        return v + 0.5, i, c

    broken = dataclasses.replace(entry, contract=dataclasses.replace(
        entry.contract, kernel=dataclasses.replace(
            kc, reference=bad, ladder=(kc.ladder[-1],))))
    found = []
    run_kernel_checks(broken, "iou_pallas.py", found,
                      lambda r: r in KERNEL_RULES, device="cpu")
    assert {f.rule for f in jfound} == {f.rule for f in found} == {"RT425"}
    assert jskipped == []


def test_rt423_fires_on_a_structure_mismatch():
    entry = _entry(KERNEL_ENTRIES[2])
    kc = entry.contract.kernel
    broken = dataclasses.replace(entry, contract=dataclasses.replace(
        entry.contract, kernel=dataclasses.replace(
            kc, reference=lambda *a: kc.reference(*a).to(torch.int32))))
    findings = []
    run_kernel_checks(broken, "k.py", findings, lambda r: r == "RT423",
                      device="cpu")
    assert [f.rule for f in findings] == ["RT423"]
    assert "int32" in findings[0].message


def test_kernel_probes_without_a_card_are_findings(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    findings = []
    run_kernel_checks(_entry(KERNEL_ENTRIES[1]), "k.py", findings,
                      lambda r: True, device="cuda")
    assert [f.rule for f in findings] == ["RT423", "RT425"]
    assert all("--device cpu" in f.message for f in findings)


# -- the real tree -----------------------------------------------------


@pytest.fixture(scope="module")
def tree_report():
    return run_check([os.path.join(ROOT, "repic_tpu_torch")], device="cpu")


def test_port_checks_clean_with_every_entry_and_no_skip(tree_report):
    assert tree_report.findings == [], "\n".join(
        f.format(show_hint=True) for f in tree_report.findings)
    assert tree_report.skipped == []
    routes = {c["entry"]: c["route"] for c in tree_report.checked}
    assert len(routes) == 13
    for expected in (
        "repic_tpu_torch.pipeline.consensus.consensus_one",
        "repic_tpu_torch.ops.solver.solve_greedy",
        "repic_tpu_torch.ops.solver.solve_lp_rounding",
        "repic_tpu_torch.ops.iou.pairwise_iou_matrix",
        "repic_tpu_torch.models.infer.score_micrograph_patches",
        "repic_tpu_torch.models.train.train_step",
    ) + KERNEL_ENTRIES:
        assert expected in routes, routes
    # the kernel wrappers launch (or, on the CPU, run their plain
    # version): never on meta tensors
    assert {routes[k] for k in KERNEL_ENTRIES} == {"concrete"}
    assert routes["repic_tpu_torch.ops.iou.pairwise_iou_matrix"] == "meta"
