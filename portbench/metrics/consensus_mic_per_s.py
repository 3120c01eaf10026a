"""consensus_mic_per_s: micrographs through consensus (neighbour search
to picks, the packed result fetched to the host) over all the window's
time."""


def read(ctx):
    w = ctx["window"]
    if ctx["kind"] != "consensus" or not w:
        return None
    return w["units"] / w["seconds"]
