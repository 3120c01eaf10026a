"""The port's ``convert`` against the JAX package's, on the CPU: the cases
of ``tests/test_coords.py`` (tables equal to the reference's DataFrames:
columns, dtype kinds, values; written files byte for byte), every
conversion chain of examples/10017 against the committed JAX digests,
and seeded numeric tokens of 6 to 17 significant digits."""

import json
import math
import os

import numpy as np
import pytest

from repic_tpu.utils import coords as J
from repic_tpu_torch.utils import coords as T
from repic_tpu_torch.utils import table
from repic_tpu_torch.utils.synthetic import output_digests

HERE = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(os.path.dirname(HERE), "examples", "10017")
DIGESTS = os.path.join(HERE, "golden", "torch_port_utilities_digests.json")
BOX_BODY = "10\t20\t180\t180\t0.5\n30\t40\t180\t180\t0.9\n"
STAR_BODY = (
    "data_\n\nloop_\n"
    "_rlnCoordinateX #1\n_rlnCoordinateY #2\n"
    "_rlnAutopickFigureOfMerit #3\n_rlnMicrographName #4\n"
    "100.0\t110.0\t0.7\tmic1.mrc\n"
    "200.0\t210.0\t0.8\tmic2.mrc\n"
    "300.0\t310.0\t0.9\tmic1.mrc\n"
)


def _write(p, text):
    p.write_text(text)
    return str(p)


def _kind(dtype) -> str:
    k = np.dtype(dtype).kind if not hasattr(dtype, "na_value") else "O"
    return "O" if k in "OUS" else k


def _same(got, want):
    """A port table equals a reference DataFrame."""
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in want.columns:
        g, w = got[c], want[c]
        assert _kind(g.dtype) == _kind(w.dtype), (c, g.dtype, w.dtype)
        for a, b in zip(g.tolist(), w.tolist()):
            if isinstance(b, float) and math.isnan(b):
                assert isinstance(a, float) and math.isnan(a), (c, a)
            else:
                assert a == b and type(a) is type(b), (c, a, b)


def _both(paths, *args, **kw):
    kw.setdefault("quiet", True)
    got, want = (T.convert(paths, *args, **kw), J.convert(paths, *args, **kw))
    assert list(got) == list(want)
    for k in want:
        _same(got[k], want[k])
    return got


def _bytes(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


def _write_both(tmp_path, paths, *args, **kw):
    kw.update(quiet=True, force=True)
    T.convert(paths, *args, out_dir=str(tmp_path / "t"), **kw)
    J.convert(paths, *args, out_dir=str(tmp_path / "j"), **kw)
    got, want = _bytes(tmp_path / "t"), _bytes(tmp_path / "j")
    assert got == want and want
    return got


def test_box_to_star_and_back(tmp_path):
    src = _write(tmp_path / "a.box", BOX_BODY)
    got = _both([src], "box", "star")
    assert next(iter(got.values()))["x"].tolist() == [100.0, 120.0]
    _write_both(tmp_path, [src], "box", "star")


def test_star_to_box_with_boxsize(tmp_path):
    src = _write(tmp_path / "a.star", STAR_BODY)
    _both([src], "star", "box", boxsize=180)
    _write_both(tmp_path, [src], "star", "box", boxsize=180)


def test_star_skips_optics_block(tmp_path):
    src = _write(tmp_path / "a.star", (
        "data_optics\n\nloop_\n_rlnVoltage #1\n300.0\n\n"
        "data_particles\n\nloop_\n"
        "_rlnCoordinateX #1\n_rlnCoordinateY #2\n5.0\t6.0\n"))
    got = T.read_star(src)
    assert got.columns == ["_rlnCoordinateX", "_rlnCoordinateY"]
    _same(got, J.read_star(src))


def test_cbox_footer_and_no_shift(tmp_path):
    src = _write(tmp_path / "a.cbox", (
        "data_cryolo\n\nloop_\n_CoordinateX #1\n"
        "10 20 0 180 180 0 0 0 0.8\n30 40 0 180 180 0 0 0 0.6\n"
        "data_cryolo_include\nfoo\n"))
    _same(T.read_tsv_like(src), J.read_tsv_like(src))
    for out in ("box", "star"):
        _both([src], "cbox", out)
    _write_both(tmp_path, [src], "cbox", "box")


def test_tsv_to_box_with_rounding(tmp_path):
    src = _write(tmp_path / "a.tsv", "100.4\t110.6\t0.3\n")
    got = _both([src], "tsv", "box", boxsize=100, round_to=0)
    assert next(iter(got.values()))["y"].tolist() == [61]


@pytest.mark.parametrize("body", [
    "0\t0\t10\t10\t-4\n0\t0\t10\t10\t2\n0\t0\t10\t10\t8\n",
    "0\t0\t10\t10\t0.4\n0\t0\t10\t10\t0.9\n",
    "0\t0\t10\t10\t3\n0\t0\t10\t10\t3\n",
])
def test_norm_conf(tmp_path, body):
    src = _write(tmp_path / "a.box", body)
    _both([src], "box", "box", norm_conf=(0.0, 1.0))
    _write_both(tmp_path, [src], "box", "box", norm_conf=(0.0, 1.0))


def test_require_conf_and_in_cols(tmp_path):
    src = _write(tmp_path / "a.tsv", "10\t20\n")
    _both([src], "tsv", "box", boxsize=10, require_conf=1.0)
    src = _write(tmp_path / "b.tsv", "0.9\t10\t20\n")
    _both([src], "tsv", "box", boxsize=10,
          in_cols=("1", "2", "auto", "auto", "0", "auto"))
    _both([src], "tsv", "box", boxsize=10,
          in_cols=("1", "2", "none", "none", "none", "none"))


def test_single_out_and_multi_out(tmp_path):
    a = _write(tmp_path / "a.box", "10\t20\t8\t8\t0.5\n")
    b = _write(tmp_path / "b.box", "30.5\t40\t8\t8\t0.6\n1\t2\t3\t4\n")
    _both([a, b], "box", "box", single_out=True)
    _write_both(tmp_path / "s", [a, b], "box", "box", single_out=True)
    # an empty file still turns the int columns into float64
    c = _write(tmp_path / "c.box", "")
    _both([a, c], "box", "box", single_out=True)
    _write_both(tmp_path / "e", [a, c], "box", "box", single_out=True)
    s1 = _write(tmp_path / "s1.star", STAR_BODY)
    s2 = _write(tmp_path / "s2.star", STAR_BODY.split("100.0")[0])
    for out in ("box", "star"):
        _both([s1, s2], "star", out, boxsize=100, single_out=True)
        _both([s2, s1], "star", out, boxsize=100, multi_out=True)
    src = _write(tmp_path / "all.star", STAR_BODY)
    _both([src], "star", "box", boxsize=100, multi_out=True)
    got = _write_both(tmp_path / "m", [src], "star", "box", boxsize=100,
                      multi_out=True)
    assert sorted(got) == ["mic1.box", "mic2.box"]


def test_headers_suffix_and_column_order(tmp_path):
    src = _write(tmp_path / "a.box", BOX_BODY)
    _write_both(tmp_path, [src], "box", "tsv", include_header=True,
                suffix="_x", out_col_order=("conf", "y", "x", "w", "h",
                                            "name"))


@pytest.mark.parametrize("body", [
    "", "\n\n", "x y w h\n", "image_name x_coord y_coord score\n",
    "data_cryolo\n\nloop_\n_CoordinateX #1\n_CoordinateY #2\n",
    "1 2 3 4 nan\n5 6 7 8 0.5\n", "1 2 3 4 abc\n5 6 7 8 0.5\n",
    "  1\t2 3 4 5\r\n6 7 8 9 10\r\n", "1 2 3 4 inf\n1e5 2E-3 .5 5. -0\n",
    "99999999999999999999 1 2 3 4\n",
])
def test_odd_inputs(tmp_path, body):
    src = _write(tmp_path / "a.box", body)
    _same(T.read_tsv_like(src), J.read_tsv_like(src))
    _write_both(tmp_path, [src], "box", "box")


def test_ragged_input_is_fatal_in_both(tmp_path, capsys):
    src = _write(tmp_path / "a.box", "1 2 3\n1 2 3 4\n")
    for mod in (T, J):
        with pytest.raises(SystemExit):
            mod.convert([src], "box", "box", quiet=True)
    out = capsys.readouterr().out
    assert out.count("Expected 3 fields in line 2, saw 4") == 2


def test_overwrite_requires_force(tmp_path):
    src = _write(tmp_path / "a.box", BOX_BODY)
    T.convert([src], "box", "star", out_dir=str(tmp_path / "o"),
              force=True, quiet=True)
    with pytest.raises(SystemExit):
        T.convert([src], "box", "star", out_dir=str(tmp_path / "o"),
                  quiet=True)


def test_cs_reader(tmp_path):
    rows = []
    for i, (fx, fy) in enumerate([(0.25, 0.5), (0.75, 0.1)]):
        rows.append((0, 0, 0, np.array([64, 64]), 0, 0, 0, 0,
                     f"mic{i}.mrc".encode(), np.array([1000, 2000]), fx, fy))
    arr = np.empty(2, dtype=object)
    arr[:] = rows
    path = str(tmp_path / "p.cs")
    np.save(path, arr, allow_pickle=True)
    _same(T.read_cs(path + ".npy"), J.read_cs(path + ".npy"))
    _both([path + ".npy"], "cs", "box", boxsize=64)


def test_cli_registered_and_golden_convert(tmp_path):
    from repic_tpu_torch.main import build_parser

    args = build_parser().parse_args(
        ["convert", "in.box", "outdir", "-f", "box", "-t", "star"])
    assert args.in_fmt == "box"
    golden = os.path.join(HERE, "golden", "convert")
    stem = "Falcon_2012_06_12-14_33_35_0"
    src = os.path.join(EXAMPLES, "topaz", f"{stem}.box")
    for in_fmt, out_fmt, ext, source in (
        ("box", "star", ".star", src),
        ("box", "tsv", ".tsv", src),
        ("star", "box", ".box", os.path.join(golden, f"{stem}.star")),
    ):
        out = tmp_path / f"{in_fmt}_to_{out_fmt}"
        T.convert([source], in_fmt, out_fmt, boxsize=180, out_dir=str(out),
                  quiet=True, force=True)
        assert (out / f"{stem}{ext}").read_text() == open(
            os.path.join(golden, f"{stem}{ext}")).read()


@pytest.mark.parametrize("picker", ["crYOLO", "deepPicker", "topaz"])
def test_10017_chains_match_the_jax_digests(tmp_path, picker):
    """Every chain ``chip_smoke.py`` runs on the card, through the CLI,
    against ``tests/golden/torch_port_utilities_digests.json``."""
    from repic_tpu_torch.main import main as cli
    from tests.golden.make_torch_port_golden import CONVERT_CHAINS

    with open(DIGESTS) as f:
        want = json.load(f)["convert"]
    for in_fmt, out_fmt in CONVERT_CHAINS:
        src = (os.path.join(EXAMPLES, picker) if in_fmt == "box" else
               str(tmp_path / f"box_{in_fmt}"))
        files = sorted(os.path.join(src, f) for f in os.listdir(src)
                       if f.endswith("." + in_fmt))
        out = str(tmp_path / f"{in_fmt}_{out_fmt}")
        cli(["convert", *files, out, "-f", in_fmt, "-t", out_fmt,
             "-b", "180", "--quiet"])
        assert output_digests(out, ("." + out_fmt,)) == want[
            f"{picker}/{in_fmt}_{out_fmt}"], (in_fmt, out_fmt)


def _tokens(rng, n):
    out = []
    for _ in range(n):
        nd = int(rng.integers(6, 18))
        digits = "".join(str(d) for d in rng.integers(0, 10, nd))
        digits = str(rng.integers(1, 10)) + digits[1:]
        k = int(rng.integers(0, nd + 1))
        form = int(rng.integers(0, 4))
        if form == 0:
            t = digits[:k] + "." + digits[k:]
        elif form == 1:
            t = "0." + "0" * int(rng.integers(0, 4)) + digits
        elif form == 2:
            t = f"{digits[0]}.{digits[1:]}e{int(rng.integers(-30, 30))}"
        else:
            t = digits[:k] + "." + digits[k:] if k else "." + digits
        out.append(("-" if rng.random() < 0.3 else "") + t)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_seeded_tokens_give_the_reference_bytes(tmp_path, seed):
    """6-17 significant digits in every column: box -> box prints the
    parsed floats (pandas' C parser, not Python's ``float``, which
    differs on about 9% of these tokens), box -> star adds w/2."""
    rng = np.random.default_rng(seed)
    toks = _tokens(rng, 2000)
    assert sum(table.parse_float(t) != float(t) for t in toks) > 10
    lines = ["\t".join(toks[i:i + 5]) for i in range(0, len(toks), 5)]
    src = _write(tmp_path / "tok.box", "\n".join(lines) + "\n")
    for out_fmt in ("box", "star", "tsv"):
        _write_both(tmp_path / out_fmt, [src], "box", out_fmt)


def test_parse_float_matches_pandas_on_seeded_tokens():
    import io

    import pandas as pd

    toks = _tokens(np.random.default_rng(11), 20000)
    col = pd.read_csv(io.StringIO("\n".join(toks) + "\n"), sep=r"\s+",
                      header=None)[0].to_numpy()
    got = np.array([table.parse_float(t) for t in toks])
    np.testing.assert_array_equal(got, col)
