"""consensus.compact_ms_per_mic: the program's ``consensus_compact`` range
(the compaction to the clique capacity and the packing of vertex ids for
the solver), timed on the device's clock while the profiler records,
summed over the traced window's chunks, per micrograph."""

from portbench import reports


def read(ctx):
    return reports.stage_ms_per_mic(ctx, "consensus_compact")
