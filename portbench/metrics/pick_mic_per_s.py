"""pick_mic_per_s: micrographs picked (preprocessing, CNN scoring,
peaks) over all the window's time."""


def read(ctx):
    w = ctx["window"]
    if ctx["kind"] != "pick" or not w:
        return None
    return w["units"] / w["seconds"]
