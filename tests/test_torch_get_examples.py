"""The port's ``get_examples`` with ``urlopen`` mocked (the cases of
``tests/test_cli.py``): no test reaches the network."""

import hashlib
import io
import os

import pytest

from repic_tpu_torch.commands import get_examples
from repic_tpu_torch.main import main as cli_main


def _fake_urlopen(payload: bytes, length=None):
    class FakeResponse(io.BytesIO):
        headers = ({} if length is False else
                   {"Content-Length": str(len(payload) if length is None
                                          else length)})

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    return lambda url, timeout=None: FakeResponse(payload)


def test_offline_fails_cleanly(tmp_path, monkeypatch):
    def no_net(url, timeout=None):
        raise OSError("no route to host")

    monkeypatch.setattr(get_examples.urllib.request, "urlopen", no_net)
    with pytest.raises(SystemExit) as e:
        cli_main(["get_examples", str(tmp_path / "ex")])
    assert "download failed" in str(e.value)
    assert [f for f in os.listdir(tmp_path / "ex")
            if not f.endswith(".part")] == []


def test_skips_existing(tmp_path, monkeypatch, capsys):
    ex = tmp_path / "ex"
    ex.mkdir()
    for stem in get_examples.FILE_STEMS:
        for ext in (".mrc", ".box"):
            (ex / (stem + ext)).write_bytes(b"x")

    def boom(url, timeout=None):
        raise AssertionError("unexpected download")

    monkeypatch.setattr(get_examples.urllib.request, "urlopen", boom)
    cli_main(["get_examples", str(ex)])
    assert f"skipped {2 * len(get_examples.FILE_STEMS)} existing" in (
        capsys.readouterr().out)


@pytest.mark.parametrize("payload,length,match", [
    (b"short", 100, "truncated"),
    (b"", False, "empty"),
])
def test_rejects_bad_downloads(tmp_path, monkeypatch, payload, length,
                               match):
    monkeypatch.setattr(get_examples.urllib.request, "urlopen",
                        _fake_urlopen(payload, length))
    with pytest.raises(get_examples.IntegrityError, match=match):
        get_examples._fetch("https://example/x.mrc",
                            str(tmp_path / "x.mrc"), 5.0)
    assert not (tmp_path / "x.mrc").exists()


def test_accepts_matching_length_and_rejects_pin_mismatch(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(get_examples.urllib.request, "urlopen",
                        _fake_urlopen(b"hello"))
    n, digest = get_examples._fetch("https://example/x.box",
                                    str(tmp_path / "x.box"), 5.0)
    assert n == 5 and (tmp_path / "x.box").read_bytes() == b"hello"
    assert digest == hashlib.sha256(b"hello").hexdigest()
    assert get_examples.BUCKET.startswith("https://")
    pinned = hashlib.sha256(b"good!").hexdigest()
    with pytest.raises(get_examples.IntegrityError, match="sha256"):
        get_examples._fetch("https://example/y.box",
                            str(tmp_path / "y.box"), 5.0, pinned=pinned)
    assert not (tmp_path / "y.box").exists()


def test_update_manifest_pins_then_verifies(tmp_path, monkeypatch):
    manifest = tmp_path / "manifest.json"
    ex = tmp_path / "ex"
    monkeypatch.setattr(get_examples.urllib.request, "urlopen",
                        _fake_urlopen(b"data1"))
    cli_main(["get_examples", str(ex), "--manifest", str(manifest),
              "--update_manifest"])
    pinned = get_examples.load_manifest(str(manifest))
    assert pinned[get_examples.FILE_STEMS[0] + ".mrc"] == hashlib.sha256(
        b"data1").hexdigest()
    assert len(pinned) == 2 * len(get_examples.FILE_STEMS)
    monkeypatch.setattr(get_examples.urllib.request, "urlopen",
                        _fake_urlopen(b"data2"))
    with pytest.raises(SystemExit, match="sha256"):
        cli_main(["get_examples", str(ex), "--force", "--manifest",
                  str(manifest)])


def test_corrupt_manifest_fails_closed(tmp_path):
    bad = tmp_path / "m.json"
    bad.write_text("{not json")
    with pytest.raises(get_examples.IntegrityError, match="corrupt"):
        get_examples.load_manifest(str(bad))
    assert get_examples.load_manifest(str(tmp_path / "none.json")) == {}


def test_shipped_manifest_is_the_reference_one():
    from repic_tpu.commands import get_examples as ref

    with open(get_examples.MANIFEST_PATH) as a, open(ref.MANIFEST_PATH) as b:
        assert a.read() == b.read()
    assert get_examples.FILE_STEMS == ref.FILE_STEMS
