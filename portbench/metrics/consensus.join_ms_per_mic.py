"""consensus.join_ms_per_mic: the program's ``consensus_join`` range (the
clique assembly: the products or the staged join), timed on the device's
clock while the profiler records, summed over the traced window's
chunks, per micrograph."""

from portbench import reports


def read(ctx):
    return reports.stage_ms_per_mic(ctx, "consensus_join")
