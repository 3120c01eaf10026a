"""The lint and check gates on the port itself, and a planted violation
of every ported rule.

``python -m repic_tpu_torch lint repic_tpu_torch --concurrency --spmd
--cost`` exiting 0 without importing torch, and ``python -m
repic_tpu_torch check repic_tpu_torch --device cpu`` checking every
``@checked`` entry with none skipped and nothing found, are the static
layer's acceptance gates: a new finding is a real regression or a rule
false positive, and either needs a human decision (a fix, or a
``# repic: noqa[RTxxx]`` with its reason).  The planted tree pins the
other half: each ported rule fails the gate, at its line, through the
CLI a user calls.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest
from torch_analysis_twin import assert_same, run_recorded

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout=300):
    return subprocess.run([sys.executable] + args, cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


def test_package_is_lint_clean(tmp_path):
    """The reference's case, for each package's own tree."""
    assert_same(run_recorded("test_analysis_selfcheck.py",
                             "test_package_is_lint_clean", tmp_path,
                             ("run_paths",)))


def test_self_clean_gate_exits_zero_without_torch():
    code = (
        "import sys\n"
        "from repic_tpu_torch import main\n"
        "try:\n"
        "    rc = main.main(['lint', 'repic_tpu_torch', '--concurrency',"
        " '--spmd', '--cost', '--statistics'])\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "print('RC', rc, 'torch' in sys.modules)\n"
    )
    proc = _run(["-c", code])
    assert proc.stdout.strip().splitlines()[-1] == "RC 0 False", (
        proc.stdout[-4000:] + proc.stderr[-2000:])


def test_check_gate_on_the_cpu_checks_every_entry():
    proc = _run(["-m", "repic_tpu_torch", "check", "repic_tpu_torch",
                 "--device", "cpu"])
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]
    assert proc.stdout.splitlines()[-1] == (
        "checked 13 entry point(s) on cpu, skipped 0, found 0 issue(s)")


def test_lint_deep_on_the_cpu_runs_the_kernel_probes():
    proc = _run(["-m", "repic_tpu_torch", "lint", "repic_tpu_torch/ops",
                 "--deep", "--device", "cpu", "--format", "json"])
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]
    assert "check: 7 entry point(s) on cpu, skipped 0" in proc.stderr
    assert json.loads(proc.stdout) == []


def test_lint_deep_without_a_card_names_device_cpu():
    """``--deep`` runs on the card unless the caller asks for the CPU:
    with no card its kernel probes are findings, never a quiet CPU run."""
    proc = subprocess.run(
        [sys.executable, "-m", "repic_tpu_torch", "lint",
         "repic_tpu_torch/ops", "--deep", "--format", "json"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 1, proc.stdout[-4000:] + proc.stderr[-2000:]
    assert "check: 7 entry point(s) on cuda, skipped 0" in proc.stderr
    found = json.loads(proc.stdout)
    probes = {(f["rule"], f["message"].split("(")[0]) for f in found
              if f["rule"] in ("RT423", "RT425")}
    assert probes == {(rule, entry) for rule in ("RT423", "RT425")
                      for entry in ("pallas_topk_neighbors",
                                    "fused_clique_candidates",
                                    "fused_dual_solve", "dual_ascent")}
    assert all("--device cpu" in f["message"] for f in found)


#: rule -> (file under the planted package, source); the line that must
#: fire ends in ``# <-``
PLANTED = {
    "RT004": ("rt004.py", """
        from repic_tpu_torch.ops.megakernel import fused_dual_solve

        def run(batches):
            out = []
            for mv, w in batches:
                picked = fused_dual_solve(mv, w, w > 0, 8)
                out.append(picked.sum().item())  # <-
            return out
        """),
    "RT201": ("rt201.py", """
        def save(path):
            with open(path, "wt") as f:  # <-
                f.write("x")
        """),
    "RT202": ("rt202.py", """
        from repic_tpu_torch.telemetry import events

        def load(xs):
            s = events.span("load", n=len(xs))  # <-
            return s
        """),
    "RT203": ("rt203.py", """
        def finish(journal, name):
            journal.record(name, "OK")  # <-
        """),
    "RT204": ("rt204.py", """
        def note(x):
            print(x)  # <-
        """),
    "RT301": ("rt301.py", """
        import threading

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self._items = []

            def add(self, x):
                with self._lock:
                    self._items.append(x)

            def reset(self):
                self._items = []  # <-
        """),
    "RT302": ("rt302.py", """
        import threading

        A = threading.Lock()
        B = threading.Lock()

        def ab():
            with A:
                with B:  # <-
                    pass

        def ba():
            with B:
                with A:
                    pass
        """),
    "RT303": ("rt303.py", """
        import threading
        import time

        LOCK = threading.Lock()

        def f():
            with LOCK:
                time.sleep(1.0)  # <-
        """),
    "RT304": ("rt304.py", """
        import threading

        def start(work):
            t = threading.Thread(target=work)  # <-
            t.start()
            return t
        """),
    "RT305": ("rt305.py", """
        import signal
        import threading

        LOCK = threading.Lock()

        def handler(signum, frame):
            with LOCK:  # <-
                pass

        def install():
            signal.signal(signal.SIGTERM, handler)
        """),
    "RT401": ("rt401.py", """
        import torch.distributed as dist

        def step(x):
            if dist.get_rank() == 0:  # <-
                dist.all_reduce(x)
            return x
        """),
    "RT402": ("rt402.py", """
        import torch.distributed as dist

        def step(x, flag):
            if flag:  # <-
                dist.all_reduce(x)
                dist.barrier()
            else:
                dist.barrier()
                dist.all_reduce(x)
            return x
        """),
    "RT404": ("parallel/gang.py", """
        def run(journal, epoch):
            journal.record_event("start", gang_epoch=epoch)
            journal.record_event("oops")  # <-
        """),
    "RT502": ("rt502.py", """
        from repic_tpu_torch import _build

        def solve(x):
            return _build.load("dual").fused_dual_solve(x)

        def per_item(items, x):
            out = []
            for it in items:
                y = solve(x).item()  # <-
                out.append(solve(y))
            return out
        """),
    "RT512": ("rt512.py", """
        from repic_tpu_torch import _build
        from repic_tpu_torch.analysis.contracts import Contract, checked

        def one(x):
            return _build.load("cliques")

        def two(x):
            return _build.load("dual")

        @checked(Contract(dispatch_budget=1))
        def entry(x):  # <-
            return two(one(x))
        """),
}


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    """Every planted file under one ``repic_tpu_torch/`` tree, linted
    once through the CLI with every static pass on."""
    root = tmp_path_factory.mktemp("planted") / "repic_tpu_torch"
    where = {}
    for rule, (name, source) in PLANTED.items():
        path = root / name
        path.parent.mkdir(parents=True, exist_ok=True)
        text = textwrap.dedent(source).lstrip("\n")
        path.write_text(text)
        line = next(i for i, t in enumerate(text.splitlines(), 1)
                    if t.endswith("# <-"))
        where[rule] = (str(path), line)
    proc = _run(["-m", "repic_tpu_torch", "lint", str(root),
                 "--concurrency", "--spmd", "--cost", "--format", "json"])
    assert proc.returncode == 1, proc.stdout + proc.stderr
    return where, json.loads(proc.stdout)


@pytest.mark.parametrize("rule", sorted(PLANTED))
def test_planted_violation_fails_the_gate_at_its_line(rule, planted):
    where, findings = planted
    got = {(f["path"], f["line"]) for f in findings if f["rule"] == rule}
    assert where[rule] in got, (rule, where[rule], got)


def test_planted_tree_fires_nothing_unplanted(planted):
    where, findings = planted
    assert {f["rule"] for f in findings} == set(PLANTED)


def test_planted_rt004_via_the_module_entry(tmp_path):
    """The reference's planted-violation case, for the port's rule:
    ``python -m repic_tpu_torch.analysis`` fails with the rule and the
    line."""
    scratch = tmp_path / "scratch_violation.py"
    scratch.write_text(textwrap.dedent(PLANTED["RT004"][1]).lstrip("\n"))
    proc = _run(["-m", "repic_tpu_torch.analysis", str(scratch)],
                timeout=120)
    assert proc.returncode != 0, proc.stdout
    assert "RT004" in proc.stdout
    assert f"{scratch}:7:" in proc.stdout
