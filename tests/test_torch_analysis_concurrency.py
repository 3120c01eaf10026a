"""The RT3xx whole-program concurrency pass against both packages.

The pass lints Python threads and is free of JAX idiom, so the port
carries it whole: every case of ``tests/test_analysis_concurrency.py``
runs as a twin (``tests/torch_analysis_twin.py``) -- the reference's
assertions hold for ``repic_tpu.analysis.concurrency`` on its sources
and for ``repic_tpu_torch.analysis.concurrency`` on the same sources
renamed, and the two report the same (rule, line, column) findings.
The three real-tree cases run over each package's own tree (the port's
self-clean gate, its lock graph, its threads and handlers); each
package's program is built once for this file.
"""

import importlib

import pytest
from torch_analysis_twin import assert_same, run_recorded
from torch_twin import case_names, load_twin

FILE = "test_analysis_concurrency.py"
REAL_TREE = ("test_package_is_concurrency_clean",
             "test_real_tree_lock_graph_is_not_vacuous",
             "test_real_tree_program_model_sees_the_threaded_layer")


@pytest.fixture(scope="module")
def one_build_per_tree():
    """Each package's ``build_program`` memoized for this file: the
    three real-tree cases share one parse of each tree."""
    import repic_tpu.analysis.concurrency as jc
    import repic_tpu_torch.analysis.concurrency as tc

    mp = pytest.MonkeyPatch()
    for mod in (jc, tc):
        cache: dict = {}

        def build(paths, _orig=mod.build_program, _cache=cache):
            key = tuple(paths)
            if key not in _cache:
                _cache[key] = _orig(paths)
            return _cache[key]

        mp.setattr(mod, "build_program", build)
    yield
    mp.undo()


@pytest.mark.parametrize("name", case_names(FILE, skip=REAL_TREE))
def test_case_holds_for_both_packages(name, tmp_path):
    assert_same(run_recorded(FILE, name, tmp_path, ("run_concurrency",)))


@pytest.mark.parametrize("name", REAL_TREE)
def test_real_tree_case_holds_for_both_packages(name, one_build_per_tree):
    for pkg, root in (("jax", "repic_tpu"), ("port", "repic_tpu_torch")):
        mod = load_twin(FILE, pkg)
        conc = importlib.import_module(f"{root}.analysis.concurrency")
        # the twin bound build_program by name: route it through the
        # memoized build (run_concurrency and lock_graph already read
        # the module's)
        saved = mod.build_program
        mod.build_program = conc.build_program
        try:
            getattr(mod, name)()
        finally:
            mod.build_program = saved
