"""consensus.dispatches_per_chunk: the program's own count of kernel
launches and fetches of each accepted chunk
(``consume_dispatch_report()["dispatches"]``), averaged over the traced
window's chunks."""


def read(ctx):
    d = ctx["counters"].get("dispatches") if ctx["kind"] == "consensus" \
        else None
    if not d:
        return None
    return sum(d) / len(d)
