"""Stage timing for ``consensus_runtime.tsv``.

:class:`StageTimer` keeps named wall-clock stages and writes them as
the reference's ``stage<TAB>seconds`` rows (:func:`write_runtime_tsv`,
the port's copy of ``repic_tpu.telemetry.sinks.write_runtime_tsv``).
The reference's spans, events and profiler traces are the telemetry
layer, not ported yet.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from repic_tpu_torch.runtime.atomic import atomic_write


@dataclass
class StageTimer:
    """Named ``(label, seconds)`` stages, in run order."""

    stages: list = field(default_factory=list)

    def write_tsv(self, out_dir: str, name: str = "runtime.tsv") -> str:
        return write_runtime_tsv(out_dir, self.stages, name=name)


def write_runtime_tsv(out_dir: str, stages,
                      name: str = "runtime.tsv") -> str:
    """``stage<TAB>seconds`` rows, one per ``(label, seconds)`` in
    order (a repeated label stays a row of its own); returns the
    path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with atomic_write(path) as f:
        for label, secs in stages:
            f.write(f"{label}\t{secs:.6f}\n")
    return path
