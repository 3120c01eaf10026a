"""pick.peaks_ms_per_mic: the benchmark's span around the peak step
(``picks_from_score_map``: local maxima, plateaus, suppression),
synchronised with the card, per micrograph of the traced window."""


def read(ctx):
    s = ctx["counters"].get("spans", {}).get("portbench.peaks")
    if ctx["kind"] != "pick" or not s:
        return None
    return 1e3 * sum(s) / len(s)
