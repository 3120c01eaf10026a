"""consensus.attempts_per_chunk: the program's count of attempts of
each traced chunk, 1 plus its capacity escalations, averaged over the
traced window's chunks."""

from portbench import reports


def read(ctx):
    return reports.mean_per_chunk(ctx, "attempts")
