"""pick.mfu: the conv stack's FLOPs per micrograph, counted from the
architecture's and the window grid's shapes, times the traced window's
micrographs, over its host seconds, as a share of the card's float32
peak (67 TFLOP/s: the picker runs cuDNN without TF32)."""

from portbench import work


def read(ctx):
    t, w = ctx["trace"], ctx.get("work")
    if ctx["kind"] != "pick" or not t or not w or t["window_s"] <= 0:
        return None
    return work.share_of_peak(w["flops_per_unit"] * t["units"],
                              t["window_s"], w["dtype"])
