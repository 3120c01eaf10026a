"""consensus.host_syncs_per_chunk: the program's count of blocking
device-to-host reads of each traced chunk (the first-visit probes,
each test of the ascent's and the greedy rounds' loops, the
compactions' boolean-mask selects, the packed fetch; rejected
attempts included), averaged over the traced window's chunks."""

from portbench import reports


def read(ctx):
    return reports.mean_per_chunk(ctx, "host_syncs")
