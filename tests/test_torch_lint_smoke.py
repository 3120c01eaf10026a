"""Smoke tests of the port's ``lint`` and ``check`` entry points.

The argument surface is pinned as the reference's is
(``tests/test_lint_smoke.py``): the JAX-free cases -- help texts, the
clean-tree JSON and SARIF, the RT3xx pack, ``--select`` enabling its
pass, an unknown rule a usage error -- run as twins through ``python
-m repic_tpu_torch.main`` and ``python -m repic_tpu_torch.analysis``.
The rest is re-derived: the JSON and SARIF field contracts on a planted
RT201 (the same finding in both packages), the rule table of the port's
packs only, ``--select`` of a rule with no subject in the port failing
loudly with its reason, and the linter importing no torch.
"""

import json
import os
import subprocess
import sys

import pytest
from torch_analysis_twin import run_recorded

from repic_tpu_torch.analysis.engine import NOT_PORTED

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILE = "test_lint_smoke.py"
PORT_RULES = ("RT004", "RT201", "RT202", "RT203", "RT204", "RT301",
              "RT302", "RT303", "RT304", "RT305", "RT401", "RT402",
              "RT404", "RT502", "RT512", "RT101", "RT102", "RT423",
              "RT425")


def _run(args, timeout=120):
    return subprocess.run([sys.executable] + args, cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("name", [
    "test_lint_help_exits_zero",
    "test_module_entry_help_exits_zero",
    "test_json_format_on_clean_tree",
    "test_sarif_format_on_clean_tree",
    "test_lint_help_documents_concurrency_and_sarif",
    "test_list_rules_covers_the_concurrency_pack",
    "test_selecting_an_rt3xx_rule_enables_the_pass",
    "test_check_help_exits_zero",
    "test_lint_help_documents_deep_mode",
    "test_unknown_select_is_a_usage_error",
    "test_lint_help_documents_spmd_mode",
    "test_lint_help_documents_cost_mode",
])
def test_case_holds_for_both_packages(name, tmp_path):
    run_recorded(FILE, name, tmp_path, ())


_DIRTY = (
    "import os\n"
    "\n"
    "\n"
    "def save(path):\n"
    "    with open(path, 'w') as f:\n"
    "        f.write('x')\n"
)


def _dirty(tmp_path, pkg):
    root = "repic_tpu" if pkg == "jax" else "repic_tpu_torch"
    d = tmp_path / pkg / root
    d.mkdir(parents=True)
    bad = d / "dirty.py"
    bad.write_text(_DIRTY)
    return bad


def _module(pkg):
    return "repic_tpu.analysis" if pkg == "jax" else "repic_tpu_torch.analysis"


def test_json_format_carries_machine_readable_fields(tmp_path):
    got = {}
    for pkg in ("jax", "port"):
        bad = _dirty(tmp_path, pkg)
        proc = _run(["-m", _module(pkg), str(bad), "--format", "json"])
        assert proc.returncode == 1, proc.stdout + proc.stderr
        (f,) = json.loads(proc.stdout)
        assert set(f) == {"rule", "severity", "message", "hint", "path",
                          "line", "col"}
        assert f["path"] == str(bad) and f["message"] and f["hint"]
        got[pkg] = (f["rule"], f["severity"], f["line"], f["col"])
    assert got["port"] == got["jax"] == ("RT201", "error", 5, 9)


def test_sarif_format_carries_code_scanning_fields(tmp_path):
    bad = _dirty(tmp_path, "port")
    proc = _run(["-m", "repic_tpu_torch.analysis", str(bad), "--format",
                 "sarif", "--concurrency", "--spmd", "--cost"])
    assert proc.returncode == 1, proc.stdout + proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["version"] == "2.1.0"
    assert doc["$schema"].endswith("sarif-schema-2.1.0.json")
    run = doc["runs"][0]
    driver = run["tool"]["driver"]
    assert driver["name"] == "repic-tpu-lint" and driver["version"]
    rules = driver["rules"]
    by_id = {r["id"]: r for r in rules}
    # the rule table holds the port's packs and nothing else
    assert set(by_id) == {"RT000", *PORT_RULES}
    for rule_id in PORT_RULES:
        r = by_id[rule_id]
        assert r["shortDescription"]["text"] and r["help"]["text"]
        assert r["defaultConfiguration"]["level"] in ("error", "warning")
    (res,) = run["results"]
    assert res["ruleId"] == "RT201"
    assert rules[res["ruleIndex"]]["id"] == "RT201"
    assert res["level"] == "error" and res["message"]["text"]
    loc = res["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"].endswith("dirty.py")
    assert loc["region"] == {"startLine": 5, "startColumn": 10}


def test_list_rules_covers_the_ports_packs_only():
    proc = _run(["-m", "repic_tpu_torch.analysis", "--list-rules"])
    assert proc.returncode == 0, proc.stderr[-2000:]
    listed = {line.split()[0] for line in proc.stdout.splitlines()}
    assert listed == set(PORT_RULES)


@pytest.mark.parametrize("rule_id,source,flag", [
    ("RT401", "import torch.distributed as dist\n\n\ndef f(x):\n"
              "    if dist.get_rank() == 0:\n        dist.all_reduce(x)\n"
              "    return x\n", "--spmd"),
    ("RT502", "import numpy as np\nfrom repic_tpu_torch import _build\n\n\n"
              "def solve(x):\n    return _build.load('dual')\n\n\n"
              "def loop(xs, x):\n    for _ in xs:\n"
              "        x = solve(np.asarray(x).item())\n    return x\n",
     "--cost"),
])
def test_selecting_a_rule_enables_its_pass(rule_id, source, flag, tmp_path):
    """--select RT401 (RT502) without --spmd (--cost) still runs the
    whole-program pass: a select that silently no-ops reads green."""
    bad = tmp_path / "mod.py"
    bad.write_text(source)
    proc = _run(["-m", "repic_tpu_torch.analysis", str(bad), "--select",
                 rule_id])
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert rule_id in proc.stdout
    proc = _run(["-m", "repic_tpu_torch.analysis", str(bad), flag,
                 "--format", "sarif"])
    doc = json.loads(proc.stdout)
    assert any(r["ruleId"] == rule_id for r in doc["runs"][0]["results"])


@pytest.mark.parametrize("rule_id", sorted(NOT_PORTED))
def test_selecting_an_unported_rule_fails_and_names_it(rule_id):
    """A reference rule with no subject in the port is never a silent
    green: lint --select exits non-zero with the rule and its reason."""
    from repic_tpu_torch import main

    with pytest.raises(SystemExit) as exc:
        main.main(["lint", "--select", f"RT004,{rule_id}", "x.py"])
    assert exc.value.code not in (0, None)
    assert rule_id in str(exc.value.code)
    assert NOT_PORTED[rule_id] in str(exc.value.code)


@pytest.mark.parametrize("cmd", ["lint", "check"])
def test_unported_select_through_the_cli_process(cmd):
    extra = ["--device", "cpu"] if cmd == "check" else []
    proc = _run(["-m", "repic_tpu_torch", cmd, "--select", "RT421", *extra])
    assert proc.returncode != 0
    assert "RT421 is not ported" in proc.stderr
    assert "csrc/*.cu" in proc.stderr


def test_check_select_redirects_cost_rules():
    proc = _run(["-m", "repic_tpu_torch.main", "check", "--select",
                 "RT512", "--list-entries", "--device", "cpu"],
                timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "lint --cost" in proc.stderr


def test_linter_imports_no_torch():
    """Every static pass -- the per-file rules, RT3xx, RT40x, RT5xx, the
    SARIF table -- runs where torch is not installed."""
    code = (
        "import sys\n"
        "import repic_tpu_torch.analysis\n"
        "from repic_tpu_torch.analysis import run_paths, run_concurrency\n"
        "from repic_tpu_torch.analysis.spmd import run_spmd\n"
        "from repic_tpu_torch.analysis.cost import run_cost\n"
        "from repic_tpu_torch.analysis.sarif import render_sarif\n"
        "from repic_tpu_torch.analysis import cli, check_cli\n"
        "run_paths([]); run_concurrency([]); run_spmd([]); run_cost([])\n"
        "render_sarif([])\n"
        "bad = [m for m in ('torch', 'numpy', 'jax') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr[-2000:]
