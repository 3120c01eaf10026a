"""pick.score_ms_per_mic: the benchmark's span around the scoring call
(``score_micrograph_patches`` / ``_fcn``), synchronised with the card,
per micrograph of the traced window."""


def read(ctx):
    s = ctx["counters"].get("spans", {}).get("portbench.score")
    if ctx["kind"] != "pick" or not s:
        return None
    return 1e3 * sum(s) / len(s)
