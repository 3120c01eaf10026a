"""The RT40x pass re-derived for ``torch.distributed``, against the
reference's.

* RT401 and RT402 are re-derived: each JAX snippet of
  ``tests/test_analysis_spmd.py`` (``jax.process_index()``,
  ``jax.lax.psum``) has a torch snippet with the same line layout
  (``dist.get_rank()``, ``dist.all_reduce``), and the same rule fires
  at the same line in each package.
* RT404 (untagged gang journal writes), its continuation-line noqa and
  the missing-path contract are free of JAX idiom and run as twins.
* The port's own: its gang dispatch points count as collectives, the
  tree is clean and the pass sees its collectives and its gang.
"""

import os

import pytest
from torch_analysis_twin import assert_same, paired, run_recorded

from repic_tpu.analysis.spmd import run_spmd as jax_spmd
from repic_tpu_torch.analysis.kernels import KERNEL_RULES
from repic_tpu_torch.analysis.spmd import SPMD_RULES, run_spmd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILE = "test_analysis_spmd.py"
#: the port's kernels module has no Pallas plan types
SUBS = (("from repic_tpu_torch.analysis.kernels import (\n"
         "    BlockPlan,\n    KERNEL_RULES,\n    KernelContract,\n"
         "    KernelPlan,\n    run_kernel_checks,\n)\n",
         "from repic_tpu_torch.analysis.kernels import (\n"
         "    KERNEL_RULES,\n    KernelContract,\n    run_kernel_checks,\n"
         ")\n"),)


def _run(pkg, path, select=None):
    return (jax_spmd if pkg == "jax" else run_spmd)([path], select=select)


def _lines(found, rule):
    return sorted(f.line for f in found if f.rule == rule)


#: case -> ({"jax": source, "port": source}, rule, lines, message parts)
PAIRS = {
    "rt401_rank_guard": ({
        "jax": """
            import jax

            def step(x):
                if jax.process_index() == 0:
                    x = jax.lax.psum(x, "i")
                return x
            """,
        "port": """
            import torch.distributed as dist

            def step(x):
                if dist.get_rank() == 0:
                    dist.all_reduce(x)
                return x
            """,
    }, "RT401", [4], {"jax": ("process_index", "psum"),
                      "port": ("get_rank", "all_reduce")}),
    "rt401_env_early_exit": ({
        "jax": """
            import os

            import jax

            def step(x):
                if os.getenv("ROLE") == "skip":
                    return x
                return jax.lax.all_gather(x, "i")
            """,
        "port": """
            import os

            import torch.distributed as dist

            def step(x, out):
                if os.getenv("ROLE") == "skip":
                    return x
                return dist.all_gather(out, x)
            """,
    }, "RT401", [6], {"jax": ("all_gather",), "port": ("all_gather",)}),
    "rt401_unsorted_listing": ({
        "jax": """
            import os

            import jax

            def step(x):
                names = os.listdir("/data")
                if names[0] == "a":
                    x = jax.lax.psum(x, "i")
                return x
            """,
        "port": """
            import os

            import torch.distributed as dist

            def step(x):
                names = os.listdir("/data")
                if names[0] == "a":
                    dist.barrier()
                return x
            """,
    }, "RT401", [7], {"jax": ("listdir",), "port": ("listdir", "barrier")}),
    "rt401_clean_sorted_and_per_rank_work": ({
        "jax": """
            import os

            import jax

            def uniform_guard(x):
                names = sorted(os.listdir("/data"))
                if names[0] == "a":
                    x = jax.lax.psum(x, "i")
                return x

            def per_host_load(x):
                if jax.process_index() == 0:
                    with open("/tmp/meta") as f:
                        f.read()
                return x
            """,
        "port": """
            import os

            import torch.distributed as dist

            def uniform_guard(x):
                names = sorted(os.listdir("/data"))
                if names[0] == "a":
                    dist.all_reduce(x)
                return x

            def per_rank_load(x):
                if dist.get_rank() == 0:
                    with open("/tmp/meta") as f:
                        f.read()
                return x
            """,
    }, "RT401", [], {}),
    "rt401_noqa_on_the_if_line": ({
        "jax": """
            import jax

            def step(x):
                if jax.process_index() == 0:  # repic: noqa[RT401]
                    x = jax.lax.psum(x, "i")
                return x
            """,
        "port": """
            import torch.distributed as dist

            def step(x):
                if dist.get_rank() == 0:  # repic: noqa[RT401]
                    dist.all_reduce(x)
                return x
            """,
    }, "RT401", [], {}),
    "rt402_mismatched_order": ({
        "jax": """
            import jax

            def step(x, flag):
                if flag:
                    x = jax.lax.psum(x, "i")
                    x = jax.lax.all_gather(x, "i")
                else:
                    x = jax.lax.all_gather(x, "i")
                    x = jax.lax.psum(x, "i")
                return x
            """,
        "port": """
            import torch.distributed as dist

            def step(x, flag):
                if flag:
                    dist.all_reduce(x)
                    dist.broadcast(x, 0)
                else:
                    dist.broadcast(x, 0)
                    dist.all_reduce(x)
                return x
            """,
    }, "RT402", [4], {"jax": ("psum", "all_gather"),
                      "port": ("all_reduce", "broadcast")}),
    "rt402_clean_same_order_and_disjoint": ({
        "jax": """
            import jax

            def same_order(x, flag):
                if flag:
                    x = jax.lax.psum(x, "i")
                    x = jax.lax.all_gather(x, "i")
                else:
                    x = jax.lax.psum(x, "i")
                    x = jax.lax.all_gather(x, "i")
                return x

            def disjoint(x, flag):
                if flag:
                    x = jax.lax.psum(x, "i")
                else:
                    x = jax.lax.all_gather(x, "i")
                return x
            """,
        "port": """
            import torch.distributed as dist

            def same_order(x, flag):
                if flag:
                    dist.all_reduce(x)
                    dist.broadcast(x, 0)
                else:
                    dist.all_reduce(x)
                    dist.broadcast(x, 0)
                return x

            def disjoint(x, flag):
                if flag:
                    dist.all_reduce(x)
                else:
                    dist.broadcast(x, 0)
                return x
            """,
    }, "RT402", [], {}),
}


@pytest.mark.parametrize("case", sorted(PAIRS))
def test_rule_fires_at_the_same_line_in_both(case, tmp_path):
    pair, rule, lines, parts = PAIRS[case]
    found = paired(pair, tmp_path, _run)
    for pkg in ("jax", "port"):
        assert _lines(found[pkg], rule) == lines, (pkg, found[pkg])
        hits = [f for f in found[pkg] if f.rule == rule]
        for part in parts.get(pkg, ()):
            assert part in hits[0].message, (pkg, part, hits[0].message)


def test_rt402_resolves_through_parallel_init_reexport(tmp_path):
    """The collective hides two modules away behind a package
    re-export, the shape of the port's gang -> parallel ->
    distributed chain."""
    for pkg, coll, gather in (
            ("jax", 'jax.lax.psum(x, "i")', 'x = jax.lax.all_gather(x, "i")'),
            ("port", "dist.all_reduce(x)", "dist.broadcast(x, 0)")):
        imp = "import jax" if pkg == "jax" else (
            "import torch.distributed as dist")
        root = tmp_path / pkg / "proj"
        (root / "parallel").mkdir(parents=True)
        (root / "parallel" / "__init__.py").write_text(
            "from proj.parallel.distributed import sync_all\n")
        (root / "parallel" / "distributed.py").write_text(
            f"{imp}\n\ndef sync_all(x):\n    return {coll}\n")
        (root / "gang.py").write_text(
            f"{imp}\n\nfrom proj.parallel import sync_all\n\n"
            "def step(x, flag):\n    if flag:\n        x = sync_all(x)\n"
            f"        {gather}\n    else:\n        {gather}\n"
            "        x = sync_all(x)\n    return x\n")
        found = [f for f in _run(pkg, str(root)) if f.rule == "RT402"]
        assert [f.line for f in found] == [6], pkg
        assert ("psum" if pkg == "jax" else "all_reduce") in found[0].message


def test_select_filters_to_the_named_rule(tmp_path):
    pair = {pkg: PAIRS["rt401_rank_guard"][0][pkg]
            + PAIRS["rt402_mismatched_order"][0][pkg].split("\n", 2)[2]
            for pkg in ("jax", "port")}
    found = paired(pair, tmp_path,
                   lambda pkg, p: _run(pkg, p, select={"RT402"}))
    for pkg in ("jax", "port"):
        assert {f.rule for f in found[pkg]} == {"RT402"}, pkg
    assert [f.line for f in found["jax"]] == [f.line for f in found["port"]]


@pytest.mark.parametrize("name", [
    "test_rt404_fires_on_untagged_record_event",
    "test_rt404_skips_kwargs_forwarding_and_non_gang_modules",
    "test_rt404_noqa_suppresses_on_a_continuation_line",
    "test_missing_path_is_an_rt000_finding",
])
def test_case_holds_for_both_packages(name, tmp_path):
    assert_same(run_recorded(FILE, name, tmp_path, ("run_spmd",),
                             subs=SUBS))


@pytest.mark.parametrize("point", [
    "init_gang_group", "gang_all_reduce_max", "assemble_global_batch"])
def test_the_gangs_dispatch_points_are_collectives(point, tmp_path):
    """A rank-divergent guard on one of the port's gang dispatch points
    fires RT401: every rank must reach them together."""
    p = tmp_path / "mod.py"
    p.write_text(
        "from repic_tpu_torch.parallel import distributed as pd\n"
        "from repic_tpu_torch.parallel.distributed import runtime_identity"
        "\n\n\ndef step(x):\n"
        "    if runtime_identity()[2] == 0:\n"
        f"        pd.{point}(x)\n"
        "    return x\n")
    found = [f for f in run_spmd([str(p)]) if f.rule == "RT401"]
    assert [f.line for f in found] == [6]
    assert point in found[0].message and "runtime_identity" in found[0].message


@pytest.fixture(scope="module")
def port_tree():
    """The port's program, built once for this file."""
    from repic_tpu_torch.analysis import spmd
    from repic_tpu_torch.analysis.concurrency import (
        _FnWalker,
        build_program,
    )

    tree = os.path.join(ROOT, "repic_tpu_torch")
    program, errors = build_program([tree])
    mp = pytest.MonkeyPatch()
    mp.setattr(spmd, "build_program", lambda paths: (
        (program, errors) if list(paths) == [tree] else build_program(paths)))
    walkers = {id(fn): _FnWalker(program, fn) for fn in program.functions}
    yield tree, program, errors, walkers
    mp.undo()


def test_repo_tree_is_spmd_clean_and_pass_is_not_vacuous(port_tree):
    from repic_tpu_torch.analysis.spmd import (
        _collective_reach,
        _direct_collectives,
        _gang_modules,
    )

    tree, program, errors, walkers = port_tree
    assert errors == []
    assert run_spmd([tree]) == []
    direct = {id(fn): _direct_collectives(walkers[id(fn)])
              for fn in program.functions}
    names = {n for ds in direct.values() for n, _line in ds}
    assert {"init_process_group", "destroy_process_group"} <= names, names
    reach = _collective_reach(program, direct)
    quals = {program_fn.qual for program_fn in program.functions
             if id(program_fn) in reach}
    assert any(q.endswith("gang.GangSupervisor.reduce_probes")
               or ".gang." in q for q in quals), sorted(quals)[:20]
    assert [m.name for m in _gang_modules(program)] == [
        "repic_tpu_torch.parallel.gang"]


def test_rule_tables_are_the_ported_rules():
    assert set(SPMD_RULES) == {"RT401", "RT402", "RT404"}
    assert set(KERNEL_RULES) == {"RT423", "RT425"}
