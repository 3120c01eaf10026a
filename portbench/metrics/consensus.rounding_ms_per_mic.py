"""consensus.rounding_ms_per_mic: the program's ``consensus_rounding``
range (the three-candidate rounding, the repair and both greedy solves),
timed on the device's clock while the profiler records, summed over the
traced window's chunks, per micrograph."""

from portbench import reports


def read(ctx):
    return reports.stage_ms_per_mic(ctx, "consensus_rounding")
