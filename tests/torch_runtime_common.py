"""Shared pieces of the runtime tests of the PyTorch port: one seeded
directory, one fault plan, through both packages, and the comparison
of the two output directories.  Imports JAX (lazily): the card-only
tests use ``torch_port_common`` instead."""

import os
import re

from repic_tpu_torch.utils.synthetic import (
    JOURNAL_ERROR_KEYS,
    journal_view,
    trace_view,
)

#: the retry policy of the reference runtime tests (fast backoff)
FAST_POLICY = dict(max_retries=1, backoff_base_s=0.001, backoff_cap_s=0.002)


def run_port_dir(in_dir, out_dir, box_size, plan=(), policy=None,
                 clear_memo=True, telemetry=False, **kw):
    """The port's ``run_consensus_dir`` on the CPU under ``plan`` (its
    own fault harness), the escalation memo cleared as a new process
    has it (unless ``clear_memo`` is False), its telemetry switched as
    :func:`run_jax_dir` switches the reference's (off by default).
    Returns ``(stats, fired log)``; an exception propagates."""
    from repic_tpu_torch.pipeline import consensus
    from repic_tpu_torch.runtime import faults
    from repic_tpu_torch.runtime.ladder import RetryPolicy
    from repic_tpu_torch.telemetry import metrics

    if clear_memo:
        consensus._LAST_GOOD_CONFIG.clear()
        consensus._RECENT_REQUIREMENTS.clear()
    was = metrics.enabled()
    metrics.set_enabled(telemetry)
    try:
        with faults.fault_plan(*plan):
            stats = consensus.run_consensus_dir(
                in_dir, out_dir, box_size, device="cpu",
                retry_policy=RetryPolicy(**policy) if policy else None,
                **kw)
            return stats, sorted(faults.fired_log())
    finally:
        metrics.set_enabled(was)


def run_jax_dir(in_dir, out_dir, box_size, plan=(), policy=None,
                clear_memo=True, telemetry=False, **kw):
    """``repic_tpu``'s ``run_consensus_dir(use_mesh=False)`` on the CPU
    under ``plan`` (its fault harness), telemetry off unless asked, the
    memo cleared, the megakernel forced into interpret mode for
    ``lp_device_fused``.  Returns ``(stats, fired log)``; an exception
    propagates."""
    from repic_tpu.pipeline import consensus
    from repic_tpu.runtime import faults
    from repic_tpu.runtime.ladder import RetryPolicy
    from repic_tpu.telemetry import metrics

    if clear_memo:
        consensus._LAST_GOOD_CONFIG.clear()
        consensus._RECENT_REQUIREMENTS.clear()
    force = "REPIC_TPU_MEGAKERNEL_FORCE"
    old_force = os.environ.get(force)
    if kw.get("solver") == "lp_device_fused":
        os.environ[force] = "1"
    was = metrics.enabled()
    metrics.set_enabled(telemetry)
    try:
        with faults.fault_plan(*plan):
            stats = consensus.run_consensus_dir(
                in_dir, out_dir, box_size, use_mesh=False,
                retry_policy=RetryPolicy(**policy) if policy else None,
                **kw)
            return stats, sorted(faults.fired_log())
    finally:
        metrics.set_enabled(was)
        if old_force is None:
            os.environ.pop(force, None)
        else:
            os.environ[force] = old_force


def _project_error(err):
    return None if err is None else {k: err.get(k) for k in JOURNAL_ERROR_KEYS}


def stats_view(stats):
    """The run statistics compared across packages."""
    return {
        "quarantined": {n: _project_error(i)
                        for n, i in stats["quarantined"].items()},
        "resumed": stats["resumed"],
        "journal": stats.get("journal"),
        "particle_counts": stats.get("particle_counts"),
    }


def dir_bytes(out_dir):
    """Every file of an output directory by name: the bytes, the
    manifest's ``created`` clock set to 0, ``_trace.jsonl`` projected by
    :func:`trace_view` (record kinds and segment names in order, ids and
    clocks dropped, no compile segments after the first chunk's), and
    no ``_journal.jsonl`` (compared by :func:`journal_view`)."""
    out = {}
    for f in sorted(os.listdir(out_dir)):
        if f == "_journal.jsonl":
            continue
        if f == "_trace.jsonl":
            out[f] = trace_view(out_dir, late_compile=False)
            continue
        with open(os.path.join(out_dir, f), "rb") as fh:
            data = fh.read()
        if f == "consensus_runtime.tsv":
            # stage seconds are clocks: the stage names are compared
            data = b"".join(line.split(b"\t")[0] + b"\n"
                            for line in data.splitlines())
        if f == "_manifest.json":
            data = re.sub(rb'"created": [0-9.e+-]+', b'"created": 0', data)
        out[f] = data
    return out


def assert_same_run(port, jax):
    """``port`` and ``jax``: ``(out_dir, stats)`` of the same scenario.
    The file sets, BOX/TSV and manifest bytes, the journal projection
    and the statistics' runtime keys are equal."""
    (p_dir, p_stats), (j_dir, j_stats) = port, jax
    got, want = dir_bytes(p_dir), dir_bytes(j_dir)
    assert sorted(got) == sorted(want)
    diff = [f for f in want if got[f] != want[f]]
    assert not diff, f"files differ: {diff}"
    assert journal_view(p_dir) == journal_view(j_dir)
    if p_stats is not None:
        assert stats_view(p_stats) == stats_view(j_stats)
