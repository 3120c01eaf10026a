"""Shared pieces of the serve tests of the PyTorch port: the same
submissions through the JAX package's daemon (``use_mesh: false``, the
CPU) and the port's (``device="cpu"``), and their outcomes projected by
:func:`repic_tpu_torch.utils.synthetic.job_view` /
:func:`~repic_tpu_torch.utils.synthetic.serve_journal_view`.

A scenario is a function of a package name (``"jax"`` or ``"port"``)
that reaches every module through :func:`mods`, so one body drives
both daemons; :func:`both` runs it for each from the same process
state.  Every HTTP call times out within seconds, every daemon is
drained on the way out, and every subprocess is killed in ``finally``.
"""

import contextlib
import importlib
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np

from repic_tpu_torch.utils.synthetic import (
    job_view,
    journal_view,
    serve_journal_view,
    trace_view,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "mini10017")
EXAMPLES = os.path.join(REPO, "examples", "10017")
SUBMIT = {
    "in_dir": FIXTURE,
    "box_size": 180,
    "options": {"use_mesh": False},
}
TERMINAL = (
    "finished", "failed", "cancelled", "deadline_exceeded",
    "quarantined",
)
PKGS = ("jax", "port")
ROOTS = {"jax": "repic_tpu", "port": "repic_tpu_torch"}
#: the megakernel's interpret-mode switch of the JAX package
FORCE_ENV = "REPIC_TPU_MEGAKERNEL_FORCE"
#: phase 11a's jobs on examples/10017: setting -> request options
SERVE_SETTINGS = {
    "lp_device_fused": {"use_mesh": False, "solver": "lp_device_fused"},
    "lp_device_pallas": {"use_mesh": False, "solver": "lp_device",
                         "use_pallas": True},
    "lp_device": {"use_mesh": False, "solver": "lp_device"},
}
#: phase 11a's warmup buckets
SERVE_WARMUP_BUCKETS = [(3, 1024)]


def mods(pkg: str) -> SimpleNamespace:
    """The serve stack of one package, by role."""
    root = ROOTS[pkg]

    def m(name):
        return importlib.import_module(f"{root}.{name}")

    return SimpleNamespace(
        daemon=m("serve.daemon"), jobs=m("serve.jobs"),
        batcher=m("serve.batcher"), tenancy=m("serve.tenancy"),
        autoscale=m("serve.autoscale"), engine=m("pipeline.engine"),
        consensus=m("pipeline.consensus"), faults=m("runtime.faults"),
        journal=m("runtime.journal"), compilecache=m(
            "runtime.compilecache"),
        telemetry=m("telemetry"), server=m("telemetry.server"),
        box_io=m("utils.box_io"),
    )


def fresh(pkg: str) -> None:
    """The process state a new daemon process starts from: no
    escalation memo, no seen program signature, no compile-cache
    directory."""
    c = mods(pkg).consensus
    c._LAST_GOOD_CONFIG.clear()
    c._RECENT_REQUIREMENTS.clear()
    c._PROGRAM_SIGNATURES.clear()
    cc = mods(pkg).compilecache
    cc._enabled_dir = None
    cc._seen.clear()


def both(scenario, *args, **kwargs):
    """``(scenario("jax", ...), scenario("port", ...))``, each from
    :func:`fresh` state, the JAX megakernel in interpret mode."""
    out = []
    for pkg in PKGS:
        fresh(pkg)
        old = os.environ.get(FORCE_ENV)
        os.environ[FORCE_ENV] = "1"
        try:
            out.append(scenario(pkg, *args, **kwargs))
        finally:
            if old is None:
                os.environ.pop(FORCE_ENV, None)
            else:
                os.environ[FORCE_ENV] = old
    return tuple(out)


def new_daemon(pkg: str, work_dir: str, **kw):
    """A ``ConsensusDaemon`` of ``pkg`` (not started); the port's on
    the CPU."""
    if pkg == "port":
        kw.setdefault("device", "cpu")
    return mods(pkg).daemon.ConsensusDaemon(work_dir, **kw)


@contextlib.contextmanager
def running(pkg: str, work_dir: str, **kw):
    """A started daemon, drained on the way out."""
    kw.setdefault("port", 0)
    d = new_daemon(pkg, work_dir, **kw).start()
    try:
        yield d
    finally:
        if not d.queue.draining:
            d.drain()
        elif d.server._httpd is not None:
            d.finish_drain()


def req(port, method, path, body=None, key=None, timeout=10,
        raw=None):
    """One HTTP call: ``(status, headers, text)``; ``raw`` bytes go
    as the body verbatim."""
    data = raw if raw is not None else (
        json.dumps(body).encode() if body is not None else None
    )
    r = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method, data=data
    )
    if key is not None:
        r.add_header("Authorization", f"Bearer {key}")
    try:
        with urllib.request.urlopen(r, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


def wait_terminal(port, job_id, timeout=60, key=None):
    deadline = time.time() + timeout
    while time.time() < deadline:
        code, _, body = req(port, "GET", f"/v1/jobs/{job_id}", key=key)
        assert code == 200, body
        doc = json.loads(body)
        if doc["state"] in TERMINAL:
            return doc
        time.sleep(0.02)
    raise AssertionError(f"job {job_id} never became terminal")


def wait_ready(port, timeout=60):
    deadline = time.time() + timeout
    while req(port, "GET", "/healthz/ready")[0] != 200:
        assert time.time() < deadline, "never became ready"
        time.sleep(0.05)


def submit(port, body=None, key=None):
    """POST /v1/jobs; returns ``(code, headers, doc)``."""
    code, headers, text = req(port, "POST", "/v1/jobs",
                              SUBMIT if body is None else body, key=key)
    return code, headers, json.loads(text)


def run_job(port, body=None, key=None, timeout=60):
    """Submit (202 expected) and poll to a terminal state."""
    code, _, doc = submit(port, body, key=key)
    assert code == 202, doc
    return wait_terminal(port, doc["id"], timeout=timeout, key=key)


def job_dir_view(job_dir: str) -> dict:
    """A job's output directory as two daemons compare it: the BOX
    bytes, the manifest with its clock zeroed, the run journal and the
    trace projected, and the file set."""
    import re

    files = sorted(os.listdir(job_dir))
    boxes = {}
    for f in files:
        if f.endswith(".box"):
            with open(os.path.join(job_dir, f)) as fh:
                boxes[f] = fh.read()
    with open(os.path.join(job_dir, "_manifest.json")) as fh:
        manifest = re.sub(r'"created": [0-9.e+-]+', '"created": 0',
                          fh.read())
    return {"files": files, "boxes": boxes, "manifest": manifest,
            "journal": journal_view(job_dir),
            "trace": trace_view(job_dir)}


def counter(pkg: str, name: str, **labels) -> float:
    return mods(pkg).telemetry.counter(name).value(**labels)


def make_picker_dir(root, mics, particles=50, seed=3, prefix="mic"):
    """A 3-picker BOX directory whose pickers agree (one base point
    set, small per-picker jitter): real consensus work with stable
    low capacities across jobs."""
    from repic_tpu_torch.utils import box_io

    rng = np.random.default_rng(seed)
    root = str(root)
    base = {
        i: rng.uniform(0, 6000, (particles, 2)).astype(np.float32)
        for i in range(mics)
    }
    for p in ("alpha", "beta", "gamma"):
        os.makedirs(os.path.join(root, p), exist_ok=True)
        for i in range(mics):
            xy = base[i] + rng.normal(
                0, 3.0, (particles, 2)
            ).astype(np.float32)
            conf = rng.uniform(0.5, 1.0, particles).astype(np.float32)
            box_io.write_box(
                os.path.join(root, p, f"{prefix}_{i:03d}.box"),
                xy, conf, 180,
            )
    return root


# -- daemons as processes --------------------------------------------


def spawn(pkg: str, wd: str, env_extra=None, extra_args=(),
          warmup=False, timeout=60, device="cpu"):
    """``serve WD --port 0`` of ``pkg`` as a child process (the port's
    on ``device``, its own default when None); returns ``(proc,
    port)`` once ``_serve.json`` names it.  ``REPIC_TPU_FAULTS`` comes
    from ``env_extra`` only."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               REPIC_TPU_NO_CONFIG_CACHE="1", PYTHONPATH=REPO)
    env.pop("REPIC_TPU_FAULTS", None)
    env.update(env_extra or {})
    if pkg == "jax":
        cmd = [sys.executable, "-m", "repic_tpu.main", "serve", wd]
    else:
        cmd = [sys.executable, "-m", "repic_tpu_torch", "serve", wd,
               *(() if device is None else ("--device", device))]
    cmd += ["--port", "0", *(() if warmup else ("--no-warmup",)),
            *extra_args]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    info_path = os.path.join(wd, "_serve.json")
    deadline = time.time() + timeout
    try:
        while time.time() < deadline:
            if proc.poll() is not None:
                raise AssertionError(
                    "daemon died at startup:\n" + proc.communicate()[0])
            try:
                with open(info_path) as f:
                    info = json.load(f)
                if info.get("pid") == proc.pid:
                    return proc, info["port"]
            except (OSError, ValueError):
                pass
            time.sleep(0.05)
    except BaseException:
        stop(proc)
        raise
    stop(proc)
    raise AssertionError("daemon never wrote _serve.json")


def stop(proc, sig=signal.SIGTERM, timeout=30) -> int:
    """Signal ``proc`` (if alive) and reap it, killing it past
    ``timeout``; returns its exit code."""
    if proc.poll() is None:
        proc.send_signal(sig)
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
    proc.communicate()
    return proc.returncode


def artifact_digests(port, job_id, key=None) -> dict:
    """Every artifact of a job fetched over HTTP: name -> sha256."""
    import hashlib

    code, _, body = req(port, "GET", f"/v1/jobs/{job_id}/artifacts",
                        key=key)
    assert code == 200, body
    out = {}
    for name in json.loads(body)["artifacts"]:
        code, _, text = req(port, "GET",
                            f"/v1/jobs/{job_id}/artifacts/{name}", key=key)
        assert code == 200, text
        out[name] = hashlib.sha256(text.encode()).hexdigest()
    return out


def serve_10017(pkg: str, work_dir: str) -> dict:
    """Phase 11a's submissions on the CPU: a daemon with warmup and
    :data:`SERVE_WARMUP_BUCKETS`, examples/10017 once per
    :data:`SERVE_SETTINGS` entry, one after another; per setting the
    artifacts' sha256 (fetched over HTTP), the job document and the run
    journal projected (paths relative to the repository)."""
    out = {}
    with running(pkg, work_dir, warmup=True,
                 warmup_buckets=SERVE_WARMUP_BUCKETS) as d:
        port = d.server.port
        wait_ready(port, timeout=120)
        for setting, options in SERVE_SETTINGS.items():
            body = {"in_dir": EXAMPLES, "box_size": 180,
                    "options": options}
            doc = run_job(port, body, timeout=300)
            assert doc["state"] == "finished", doc
            out[setting] = {
                "artifacts": artifact_digests(port, doc["id"]),
                "job": job_view(doc, REPO),
                "journal": journal_view(d.job_dir(doc["id"])),
            }
    out["serve_journal"] = serve_journal_view(work_dir, REPO)
    return out

