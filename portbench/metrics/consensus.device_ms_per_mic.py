"""consensus.device_ms_per_mic: the device's busy time (kernels and
copies, from the profiler) inside the traced window, per micrograph."""


def read(ctx):
    t = ctx["trace"]
    if ctx["kind"] != "consensus" or not t or not t["units"]:
        return None
    if t["busy_s"] <= 0:
        return None
    return t["busy_s"] * 1e3 / t["units"]
