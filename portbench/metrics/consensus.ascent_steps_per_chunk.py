"""consensus.ascent_steps_per_chunk: the program's count of trips of
the lp_device dual ascent in each traced chunk (rejected attempts
included), averaged over the traced window's chunks."""

from portbench import reports


def read(ctx):
    return reports.mean_per_chunk(ctx, "ascent_steps")
