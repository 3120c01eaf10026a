"""Fetch the EMPIAR-10057 example set (host code, no device).

Downloads 32 T20S proteasome micrographs plus normative particle BOX
files from the REPIC public S3 bucket, for use with ``iter_pick``,
with urllib over HTTPS and two integrity layers:

- **Truncation defense**: received bytes must be non-empty and match
  the Content-Length the server declares, else the transfer is
  rejected (HTTPS itself provides transport tamper resistance).
- **Content pinning**: each file's SHA-256 is checked against the
  manifest ``examples_sha256.json`` next to this module.  Entries are
  pinned trust-on-first-use: ``--update_manifest`` records the digest
  of each verified download; later fetches of a pinned file must
  match exactly or the download is rejected.  The shipped manifest
  starts empty rather than carrying digests nobody verified.

Resumable (existing non-empty files are skipped unless ``--force``)
and degrades with a clear message in offline environments.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import urllib.error
import urllib.request

name = "get_examples"

BUCKET = "https://org.gersteinlab.repic.s3.amazonaws.com/example_data_10057"

MANIFEST_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "examples_sha256.json"
)

# the 32 EMPIAR-10057 micrograph stems
FILE_STEMS = (
    "Jul21_17_36_51 Jul21_17_39_03 Jul21_17_52_20 Jul21_17_56_42 "
    "Jul21_18_05_31 Jul21_18_38_48 Jul21_19_35_51 Jul21_19_38_03 "
    "Jul21_19_54_12 Jul21_19_56_25 Jul21_20_23_38 Jul21_20_39_19 "
    "Jul21_20_45_56 Jul21_20_50_20 Jul21_20_57_21 Jul21_21_24_01 "
    "Jul21_21_57_27 Jul21_22_04_08 Jul21_22_15_09 Jul21_22_37_22 "
    "Jul21_23_02_48 Jul21_23_05_02 Jul21_23_13_57 Jul21_23_16_09 "
    "Jul21_23_22_39 Jul21_23_24_50 Jul22_00_07_03 Jul22_00_13_45 "
    "Jul22_00_35_04 Jul22_00_37_23 Jul22_00_41_50 Jul22_00_52_53"
).split()


def add_arguments(parser) -> None:
    parser.add_argument(
        "out_dir", help="output directory (created if missing)"
    )
    parser.add_argument(
        "--timeout", type=float, default=60.0,
        help="per-file download timeout (seconds)",
    )
    parser.add_argument(
        "--force", action="store_true",
        help="re-download files that already exist",
    )
    parser.add_argument(
        "--manifest", default=MANIFEST_PATH,
        help="SHA-256 manifest path (JSON: filename -> hex digest)",
    )
    parser.add_argument(
        "--update_manifest", action="store_true",
        help="pin the SHA-256 of each verified download into the "
        "manifest (trust-on-first-use)",
    )


class IntegrityError(OSError):
    """Downloaded bytes do not match what was declared or pinned."""


def load_manifest(path: str) -> dict:
    """Load the digest manifest; absent file -> no pins (empty dict).

    A manifest that exists but cannot be parsed fails CLOSED (raises
    IntegrityError): silently dropping the pins would disable the
    integrity layer exactly when something has tampered with it."""
    try:
        with open(path) as f:
            m = json.load(f)
    except FileNotFoundError:
        return {}
    except (OSError, ValueError) as e:
        raise IntegrityError(
            f"manifest {path} exists but is unreadable/corrupt ({e}); "
            "refusing to continue without its pins — fix or delete it"
        )
    if not isinstance(m, dict):
        raise IntegrityError(
            f"manifest {path} is not a JSON object; fix or delete it"
        )
    return m


def save_manifest(path: str, manifest: dict) -> None:
    tmp = path + ".part"
    with open(tmp, "wt") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def _fetch(
    url: str, dst: str, timeout: float, pinned: str | None = None
) -> tuple[int, str]:
    """Download ``url`` to ``dst``; return (nbytes, sha256 hex)."""
    with urllib.request.urlopen(url, timeout=timeout) as r:
        declared = r.headers.get("Content-Length")
        data = r.read()
    if not data:
        raise IntegrityError(f"empty response for {url}")
    try:
        expected = int(declared) if declared is not None else None
    except ValueError:  # non-numeric header from a proxy/portal
        expected = None
    if expected is not None and len(data) != expected:
        raise IntegrityError(
            f"truncated download for {url}: got {len(data)} bytes, "
            f"server declared {declared}"
        )
    digest = hashlib.sha256(data).hexdigest()
    if pinned is not None and digest != pinned:
        raise IntegrityError(
            f"sha256 mismatch for {url}: got {digest}, "
            f"manifest pins {pinned}"
        )
    tmp = dst + ".part"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, dst)
    return len(data), digest


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def main(args) -> None:
    os.makedirs(args.out_dir, exist_ok=True)
    manifest_path = getattr(args, "manifest", MANIFEST_PATH)
    try:
        manifest = load_manifest(manifest_path)
    except IntegrityError as e:
        sys.exit(f"error: {e}")
    update = getattr(args, "update_manifest", False)
    done = skipped = redownloaded = 0
    dirty = False
    try:
        for stem in FILE_STEMS:
            for ext in (".mrc", ".box"):
                fname = stem + ext
                dst = os.path.join(args.out_dir, fname)
                pinned = manifest.get(fname)
                if (
                    not getattr(args, "force", False)
                    and os.path.exists(dst)
                    and os.path.getsize(dst) > 0
                ):
                    # the resume path honors pins too: an existing
                    # file whose digest mismatches is re-downloaded,
                    # not silently trusted
                    if pinned is None or _file_sha256(dst) == pinned:
                        skipped += 1
                        continue
                    print(
                        f"{fname}: existing file does not match its "
                        "pinned sha256 — re-downloading"
                    )
                    redownloaded += 1
                url = f"{BUCKET}/{fname}"
                try:
                    nbytes, digest = _fetch(
                        url, dst, args.timeout, pinned
                    )
                except (urllib.error.URLError, OSError) as e:
                    sys.exit(
                        f"error: download failed for {url}: {e}\n"
                        "(this environment may have no network access "
                        "— fetch the EMPIAR-10057 example set from "
                        "the REPIC S3 bucket on a connected machine "
                        f"and copy it into {args.out_dir})"
                    )
                if update and manifest.get(fname) != digest:
                    manifest[fname] = digest
                    dirty = True
                done += 1
                print(f"{fname}\t{nbytes} bytes\tsha256:{digest[:16]}…")
    finally:
        # persist partial pins even when a later download fails —
        # digests already verified must survive a flaky connection
        if dirty:
            save_manifest(manifest_path, manifest)
            print(
                f"pinned {len(manifest)} digests into {manifest_path}"
            )
    print(
        f"downloaded {done} files, skipped {skipped} existing"
        + (
            f", re-downloaded {redownloaded} pin-mismatched"
            if redownloaded
            else ""
        )
    )


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    add_arguments(parser)
    main(parser.parse_args())
