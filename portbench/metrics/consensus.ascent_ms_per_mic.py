"""consensus.ascent_ms_per_mic: the program's ``consensus_ascent`` range
(the lp_device dual ascent, its set-up and its loop), timed on the
device's clock while the profiler records, summed over the traced
window's chunks, per micrograph."""

from portbench import reports


def read(ctx):
    return reports.stage_ms_per_mic(ctx, "consensus_ascent")
