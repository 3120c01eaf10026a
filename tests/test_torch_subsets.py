"""The port's MRC I/O and ``build_subsets`` against the JAX package's, on
the CPU: the cases of ``tests/test_mrc_subsets.py`` (files byte for
byte, splits equal), and the committed JAX digest of the split."""

import json
import os

import numpy as np
import pytest

from repic_tpu.main import build_parser as jax_parser
from repic_tpu.utils import mrc as jmrc
from repic_tpu.utils import subsets as jsub
from repic_tpu_torch.main import build_parser
from repic_tpu_torch.utils import mrc as tmrc
from repic_tpu_torch.utils import subsets as tsub
from repic_tpu_torch.utils.synthetic import (
    subsets_membership,
    write_subsets_fixture,
)

HERE = os.path.dirname(os.path.abspath(__file__))
DIGESTS = os.path.join(HERE, "golden", "torch_port_utilities_digests.json")


@pytest.mark.parametrize("shape", [(48, 64), (2, 4, 6), (1, 3, 5)])
def test_mrc_write_read_equals_jax(tmp_path, shape):
    data = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    tmrc.write_mrc(str(tmp_path / "t.mrc"), data)
    jmrc.write_mrc(str(tmp_path / "j.mrc"), data)
    assert (tmp_path / "t.mrc").read_bytes() == (
        tmp_path / "j.mrc").read_bytes()
    got = tmrc.read_mrc(str(tmp_path / "j.mrc"))
    np.testing.assert_array_equal(got, jmrc.read_mrc(str(tmp_path / "t.mrc")))
    assert tmrc.read_header(str(tmp_path / "t.mrc")) == tuple(
        jmrc.read_header(str(tmp_path / "t.mrc")))


def test_mrc_modes_extended_header_and_garbage(tmp_path):
    img = np.arange(12, dtype="<i2").reshape(3, 4)
    header = np.zeros(256, dtype="<i4")
    header[0:4] = (4, 3, 1, 1)
    header[53] = 0x00004444
    path = str(tmp_path / "i16.mrc")
    with open(path, "wb") as f:
        f.write(header.tobytes())
        f.write(img.tobytes())
    np.testing.assert_array_equal(tmrc.read_mrc(path), img)
    header[3], header[23] = 2, 128
    header[0:3] = (2, 2, 1)
    path = str(tmp_path / "ext.mrc")
    with open(path, "wb") as f:
        f.write(header.tobytes())
        f.write(b"\xaa" * 128)
        f.write(np.ones((2, 2), "<f4").tobytes())
    np.testing.assert_array_equal(tmrc.read_mrc(path), np.ones((2, 2)))
    bad = str(tmp_path / "bad.mrc")
    with open(bad, "wb") as f:
        f.write(b"not an mrc file")
    with pytest.raises(tmrc.MrcError):
        tmrc.read_header(bad)
    assert not tmrc.is_single_frame_micrograph(bad)
    tmrc.write_mrc(str(tmp_path / "v.mrc"), np.zeros((3, 4, 4), np.float32))
    assert not tmrc.is_single_frame_micrograph(str(tmp_path / "v.mrc"))


def _fake_data(n, seed=1):
    rng = np.random.default_rng(seed)
    return [(f"mic_{i:03d}.mrc", float(d))
            for i, d in enumerate(rng.uniform(1e4, 4e4, n))]


@pytest.mark.parametrize("n,ignore_test", [(30, False), (50, False),
                                           (60, False), (30, True)])
def test_split_equals_jax(n, ignore_test):
    data = _fake_data(n)
    assert tsub.tertile_split(data) == jsub.tertile_split(data)
    assert tsub.calc_subsets(n) == jsub.calc_subsets(n)
    got = tsub.split_dataset(data, ignore_test=ignore_test, seed=3)
    assert got == jsub.split_dataset(data, ignore_test=ignore_test, seed=3)


@pytest.mark.parametrize("flags", [[], ["--ignore_test"]])
def test_cli_matches_jax_and_the_digest(tmp_path, flags):
    with open(DIGESTS) as f:
        want = json.load(f)["build_subsets"][
            "ignore_test" if flags else "default"]
    membership = {}
    for tag, parser in (("t", build_parser), ("j", jax_parser)):
        defocus, box_dir, mrc_dir = write_subsets_fixture(
            str(tmp_path / tag))
        out = str(tmp_path / tag / "out")
        args = parser().parse_args(
            ["build_subsets", defocus, box_dir, mrc_dir, out, *flags])
        (args._module.main if tag == "t" else args.func)(args)
        membership[tag] = subsets_membership(out)
    assert membership["t"] == membership["j"] == want


def test_cli_fallback_scan_without_defocus(tmp_path, capsys):
    box_dir, mrc_dir = tmp_path / "box", tmp_path / "mrc"
    box_dir.mkdir(), mrc_dir.mkdir()
    for i in range(12):
        tmrc.write_mrc(str(mrc_dir / f"m{i}.mrc"), np.zeros((4, 4),
                                                            np.float32))
    (mrc_dir / "junk.txt").write_text("nope")
    args = build_parser().parse_args(
        ["build_subsets", str(tmp_path / "missing.txt"), str(box_dir),
         str(mrc_dir), str(tmp_path / "out"), "--ignore_test"])
    args._module.main(args)
    assert "12 valid MRC files found" in capsys.readouterr().out
    assert (tmp_path / "out" / "train").is_dir()
