"""Picker traffic: whole micrographs through the program's
``pick_micrograph``, the entry of ``pick``.

Set-up makes the configuration's micrographs (raw float32 arrays, as
an MRC read gives them) and the deep architecture's weights from the
seed, and picks every micrograph once.  A step picks the next
micrograph.  The benchmark's own spans wrap the two halves the entry
calls, the scoring and the peak step; with tracing on they synchronise
with the card and record their time.  The check, after the window,
runs the plain reference on a sample of the micrographs the window
finished, drawn from the seed, with the one of the most picks among
them.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import compare, synth, work
from portbench.reference import picker as ref_picker


def make_weights(seed: int, device) -> dict:
    """The deep architecture's parameter tree (HWIO conv kernels,
    ``(in, out)`` dense kernels, float32, numpy leaves, as the entry
    takes them), drawn on ``device`` in one call: every kernel a normal
    truncated at two deviations, of deviation ``sqrt(1 / fan_in) /
    0.8796``, every bias zero (flax's default initialisation)."""
    import torch

    shapes = []
    cin = 1
    for i, (k, f) in enumerate(ref_picker.CONV):
        shapes.append((("backbone", f"conv{i + 1}"), (k, k, cin, f)))
        cin = f
    flat = 4 * cin
    shapes += [(("fc1",), (flat, 128)), (("fc2",), (128, 2))]
    sizes = [int(np.prod(s)) for _, s in shapes]
    g = torch.Generator(device=device)
    g.manual_seed(abs(int(seed)) % (1 << 63))
    z = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(z, 0.0, 1.0, -2.0, 2.0, generator=g)
    z = z.cpu().numpy()
    tree: dict = {}
    off = 0
    for (path, shape), n in zip(shapes, sizes):
        fan_in = int(np.prod(shape[:-1]))
        std = np.float32((1.0 / fan_in) ** 0.5 / 0.87962566103423978)
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node["kernel"] = (z[off:off + n] * std).reshape(shape)
        node["bias"] = np.zeros(shape[-1], np.float32)
        off += n
    return tree


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        self.mode = traffic["mode"]
        self.dtype = traffic.get("dtype", "float32")
        self.pc = config["picker"]
        self.images, self.maps, self.picks = [], {}, {}
        self.turn = 0
        self.tracing = False
        self.spans = {"portbench.score": [], "portbench.peaks": []}
        self._patched = []

    # -- set-up -----------------------------------------------------
    def setup(self):
        rng = np.random.default_rng(synth.rng_seed(self.seed, 0))
        for _ in range(self.pc["micrographs"]):
            img, _ = synth.micrograph(
                rng, size=self.config["micrograph_px"],
                box=self.pc["blob_box"], particles=tuple(self.pc["blobs"]))
            self.images.append(img)
        self.params = make_weights(self.seed, self.device)
        self._wrap()
        for _ in range(len(self.images)):
            self.step()
        self.turn = 0
        for v in self.spans.values():
            v.clear()

    def _wrap(self):
        """Wrap the entry's two halves in the benchmark's spans; they
        also keep each score map for the check."""
        import torch

        from repic_tpu_torch.models import infer

        cell = self

        def spanned(name, fn, keep):
            def wrapper(*args, **kw):
                if not cell.tracing:
                    out = fn(*args, **kw)
                else:
                    with torch.profiler.record_function(name):
                        t0 = time.perf_counter()
                        out = fn(*args, **kw)
                        if cell.device != "cpu":
                            torch.cuda.synchronize()
                        cell.spans[name].append(time.perf_counter() - t0)
                if keep:
                    cell.maps[cell.current] = out
                return out
            return wrapper

        score = ("score_micrograph_fcn" if self.mode == "fcn"
                 else "score_micrograph_patches")
        for attr, name, keep in ((score, "portbench.score", True),
                                 ("picks_from_score_map",
                                  "portbench.peaks", False)):
            orig = getattr(infer, attr)
            self._patched.append((attr, orig))
            setattr(infer, attr, spanned(name, orig, keep))

    # -- the timed step ---------------------------------------------
    @property
    def cycle(self) -> int:
        """Steps of one pass over the inputs."""
        return len(self.images)

    def step(self) -> int:
        from repic_tpu_torch.models.infer import pick_micrograph

        i = self.turn % len(self.images)
        self.turn += 1
        self.current = i
        self.picks[i] = pick_micrograph(
            self.params, self.images[i], self.pc["particle_size"],
            mode=self.mode, step=self.pc["step"], arch=self.pc["arch"],
            dtype=self.dtype, device=self.device)
        return 1

    def work(self) -> dict:
        return {"flops_per_unit": work.pick_flops(
            self.config["micrograph_px"], self.pc["particle_size"],
            self.mode, self.pc["step"]), "dtype": "float32"}

    def counters(self) -> dict:
        return {"spans": {k: list(v) for k, v in self.spans.items()}}

    # -- the check --------------------------------------------------
    def sample(self) -> list[int]:
        rng = np.random.default_rng(synth.rng_seed(self.seed, 1))
        done = sorted(self.picks)
        n = min(self.traffic.get("check_micrographs", 2), len(done))
        out = [done[int(j)] for j in rng.choice(len(done), n, replace=False)]
        most = max(done, key=lambda i: len(self.picks[i]))
        if most not in out:
            out.append(most)
        return out

    def cell_px(self) -> float:
        step = self.pc["step"]
        if self.mode == "fcn":
            patch = int(self.pc["particle_size"] / ref_picker.BIN)
            scale = ref_picker.PATCH / patch
            step = max(1, int(round(step * scale))) / scale
        return step * ref_picker.BIN

    def reference(self, i: int):
        smap = ref_picker.score_map(
            self.images[i], self.params, self.pc["particle_size"],
            mode=self.mode, step=self.pc["step"], device=self.device)
        return smap, ref_picker.peaks(smap, self.pc["particle_size"],
                                      mode=self.mode, step=self.pc["step"])

    def numbers(self, program_outputs=None) -> dict:
        """The run's numbers: the kept score maps and picks (or
        ``program_outputs``, ``{i: (map, picks)}``) against the
        reference."""
        per = []
        for i in self.sample():
            if program_outputs is not None:
                pmap, ppicks = program_outputs[i]
            else:
                pmap, ppicks = self.maps[i], self.picks[i]
            pmap = pmap.float().cpu().numpy() if hasattr(pmap, "cpu") \
                else np.asarray(pmap)
            rmap, rpicks = self.reference(i)
            per.append(compare.pick_numbers(pmap, rmap, ppicks[:, :2],
                                            rpicks[:, :2], self.cell_px()))
        return compare.fold_pick(per)

    def control_numbers(self) -> dict:
        """The control's numbers: the program's own bfloat16 path on the
        same micrographs and weights, one pass."""
        ctl = Cell(self.config, dict(self.traffic, dtype="bfloat16"),
                   self.seed, self.device)
        ctl.setup()
        for _ in range(len(ctl.images)):
            ctl.step()
        ctl.release()
        return ctl.numbers()

    def release(self):
        """Unwrap the entry, keep the maps on the host and drop the
        program's device state before the reference runs."""
        import gc

        from repic_tpu_torch.models import infer

        for attr, orig in self._patched:
            setattr(infer, attr, orig)
        self._patched.clear()
        self.maps = {i: m.float().cpu().numpy() for i, m in self.maps.items()}
        gc.collect()
        if self.device != "cpu":
            import torch

            torch.cuda.empty_cache()
