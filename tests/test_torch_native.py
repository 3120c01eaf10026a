"""The port's native BOX parser against its line loop.

``read_box`` reads through ``native/boxparse.cpp`` unless the parser
declines the file; then the line loop does.  Every float is bitwise
the line loop's (strtod per token) on every BOX file under
``examples/10017`` and ``tests/fixtures``, and on hand-made files:
a header, 2 to 6 columns, ``nan``, negative confidences (sigmoid),
CR and CRLF line ends, blank lines.  Files the parser must decline
(a second header, a one-token row, a bad token, PEP 515 underscores)
reach the loop, which reads or refuses them as it always did.  The
library lands under ``build/``, never inside the package.
"""

import glob
import os

import numpy as np
import pytest

from repic_tpu_torch import native
from repic_tpu_torch.utils import box_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOX_FILES = sorted(
    glob.glob(os.path.join(REPO, "examples", "10017", "*", "*.box"))
    + glob.glob(os.path.join(REPO, "tests", "fixtures", "**", "*.box"),
                recursive=True)
)


def _same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x.view(np.uint32), y.view(np.uint32))


def test_every_repo_box_file_bitwise_equal():
    assert len(BOX_FILES) >= 36
    for path in BOX_FILES:
        with open(path, "rb") as f:
            assert native.parse_box_native(f.read()) is not None, path
        _same(box_io.read_box(path), box_io._read_box_slow(path))


CASES = {
    "header": "x y w h score\n10.5 20.25 180 180 0.9\n3 4 180 180 0.5\n",
    "two_cols": "1.5 2.5\n3.25 4.125\n",
    "three_cols": "1 2 3\n4 5 6\n",
    "four_cols": "1 2 180 180\n4 5 180 180\n",
    "six_cols": "1 2 180 180 0.7 extra\n3 4 180 180 0.2 more\n",
    "nan": "1 2 180 180 nan\n3 4 180 180 0.5\n",
    "negative": "1 2 180 180 -1.5\n3 4 180 180 2.25\n",
    "crlf": "1 2 180 180 0.5\r\n3 4 180 180 0.25\r\n",
    "cr": "1 2 180 180 0.5\r3 4 180 180 0.25\r",
    "blank_lines": "\n\n1 2 180 180 0.5\n\n3 4 180 180 0.25\n\n",
    "exponents": "1e2 2.5E-1 1.8e+02 180 1e-30\n0.1 0.2 0.3 0.4 0.7\n",
    "empty": "",
}
DECLINED = {
    "second_header": ("x y\nz w\n1 2\n", ValueError),
    "one_token_row": ("1 2 180 180 0.5\n7\n", IndexError),
    "bad_token": ("1 2 180 180 0.5\n3 abc 180 180 0.5\n", ValueError),
    "underscores": ("1_000 2 180 180 0.5\n", None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_hand_made_files_bitwise_equal(tmp_path, case):
    path = tmp_path / "m.box"
    path.write_bytes(CASES[case].encode())
    assert native.parse_box_native(CASES[case].encode()) is not None
    got = box_io.read_box(str(path))
    _same(got, box_io._read_box_slow(str(path)))
    if case == "negative":
        assert (got.conf > 0).all() and (got.conf < 1).all()


@pytest.mark.parametrize("case", list(DECLINED))
def test_declined_files_reach_the_line_loop(tmp_path, case):
    text, error = DECLINED[case]
    assert native.parse_box_native(text.encode()) is None
    path = tmp_path / "m.box"
    path.write_bytes(text.encode())
    if error is None:
        _same(box_io.read_box(str(path)), box_io._read_box_slow(str(path)))
    else:
        with pytest.raises(box_io.BoxParseError) as e:
            box_io.read_box(str(path))
        assert isinstance(e.value.__cause__, error)


def test_build_lands_outside_the_package():
    native._boxparse()
    native._setpack()
    pkg = os.path.join(REPO, "repic_tpu_torch")
    assert native.BUILD_DIR == os.path.join(REPO, "build", "repic_tpu_torch")
    built = [f for f in glob.glob(os.path.join(pkg, "**", "*"),
                                  recursive=True)
             if f.endswith((".so", ".o"))]
    assert not built, built
    assert glob.glob(os.path.join(native.BUILD_DIR, "libboxparse_*.so"))


@pytest.mark.parametrize("fault", ["no_compiler", "bad_source"])
def test_failed_build_raises(monkeypatch, tmp_path, fault):
    """A missing compiler or a source that does not compile raises; the
    line loop does not quietly take over."""
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    if fault == "no_compiler":
        monkeypatch.setattr(native.shutil, "which", lambda name: None)
        match = "g\\+\\+ not found"
    else:
        src = tmp_path / "src"
        src.mkdir()
        (src / "boxparse.cpp").write_text("this is not C++\n")
        monkeypatch.setattr(native, "_HERE", str(src))
        match = "g\\+\\+ failed for native/boxparse.cpp"
    path = tmp_path / "m.box"
    path.write_text("1 2 180 180 0.5\n")
    with pytest.raises(RuntimeError, match=match):
        box_io.read_box(str(path))
