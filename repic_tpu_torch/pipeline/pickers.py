"""Picker adapters for the iterative ensemble loop (the port of
``repic_tpu.pipeline.pickers``).  Each picker is an object with two
methods:

    predict(mrc_dir, out_box_dir)   -> write one BOX file per mrc
    fit(train_mrc, train_box, val_mrc, val_box, model_out)

* :class:`BuiltinPicker` -- the port's CNN picker, in this process on
  its ``device`` (``cuda`` unless asked for the CPU): ``predict``
  through :func:`repic_tpu_torch.models.infer.pick_micrograph`, ``fit``
  through :mod:`repic_tpu_torch.models.data` and
  :mod:`repic_tpu_torch.models.train`.  Ensemble diversity comes from
  three filter pyramids (deep/wide/slim) and distinct seeds.
* :class:`ExternalPicker` subclasses -- subprocess adapters for
  SPHIRE-crYOLO, DeepPicker and Topaz: ``conda run -n ENV`` command
  lines (no shell), their outputs converted to BOX files, a failing
  command raised as :class:`PickerError` with its log kept.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import subprocess
import warnings
from dataclasses import dataclass, field

import numpy as np

from repic_tpu_torch import telemetry
from repic_tpu_torch.runtime.atomic import atomic_write
from repic_tpu_torch.telemetry import events as tlm_events
from repic_tpu_torch.utils.box_io import read_box, write_box, write_empty_box

# Per-host picker telemetry
_PICKED_PARTICLES = telemetry.counter(
    "repic_picker_particles_total",
    "particles written by picker adapters on this host",
)
_PICKED_MICROGRAPHS = telemetry.counter(
    "repic_picker_micrographs_total",
    "micrographs processed by picker adapters "
    "(status=ok|empty|quarantined)",
)
_PICKER_LAST_TOTAL = telemetry.gauge(
    "repic_picker_last_run_particles",
    "particle count of the most recent predict() sweep per picker",
)


class PickerError(RuntimeError):
    pass


def _stem(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def _mrcs(mrc_dir: str) -> list:
    return sorted(glob.glob(os.path.join(mrc_dir, "*.mrc")))


@dataclass
class BuiltinPicker:
    """The port's CNN picker as an ensemble member."""

    name: str
    particle_size: int
    seed: int = 1234
    batch_size: int = 64
    max_epochs: int = 200
    model_path: str | None = None  # current checkpoint
    threshold: float = 0.0
    mode: str = "patch"
    arch: str = "deep"  # cnn.ARCHS filter pyramid
    # "bfloat16": scoring and training compute in bfloat16 (parameters
    # and checkpoints stay float32)
    compute_dtype: str = "float32"
    # lenient=True: a micrograph whose read or pick fails gets an empty
    # BOX file and a warning instead of failing the round
    lenient: bool = False
    device: str | None = None  # cuda unless asked for the CPU

    def predict(self, mrc_dir: str, out_box_dir: str) -> int:
        """Pick every micrograph; returns the particles written."""
        from repic_tpu_torch.models.checkpoint import load_checkpoint
        from repic_tpu_torch.models.infer import pick_micrograph
        from repic_tpu_torch.pipeline.consensus import resolve_device
        from repic_tpu_torch.runtime import faults
        from repic_tpu_torch.utils import mrc as mrc_io

        if not self.model_path:
            raise PickerError(
                f"{self.name}: no model available — provide an initial "
                "checkpoint or run in semi-automatic mode "
                "(round 0 needs either a pre-trained model or seed labels)"
            )
        device = resolve_device(self.device)
        params, meta = load_checkpoint(self.model_path)
        os.makedirs(out_box_dir, exist_ok=True)
        total = 0
        for path in _mrcs(mrc_dir):
            stem = _stem(path)
            out = os.path.join(out_box_dir, stem + ".box")
            try:
                with tlm_events.span("pick_micrograph", picker=self.name,
                                     micrograph=stem):
                    faults.inject("io", path)
                    raw = mrc_io.read_mrc(path).astype(np.float32)
                    if raw.ndim == 3:
                        raw = raw[0]
                    coords = pick_micrograph(
                        params,
                        raw,
                        self.particle_size,
                        mode=self.mode,
                        norm=meta.get("patch_norm", "reference"),
                        arch=meta.get("arch", self.arch),
                        dtype=self.compute_dtype,
                        device=device,
                    )
            except (OSError, ValueError) as e:
                if not self.lenient:
                    raise PickerError(
                        f"{self.name}: failed to pick {path}: "
                        f"{type(e).__name__}: {e}"
                    ) from e
                warnings.warn(
                    f"{self.name}: quarantined micrograph {stem} "
                    f"(empty BOX written): {type(e).__name__}: {e}",
                    RuntimeWarning,
                    stacklevel=2,
                )
                _PICKED_MICROGRAPHS.inc(picker=self.name,
                                        status="quarantined")
                write_empty_box(out)
                continue
            coords = coords[coords[:, 2] >= self.threshold]
            if len(coords) == 0:
                write_empty_box(out)
            else:
                write_box(
                    out,
                    coords[:, :2] - self.particle_size / 2,
                    coords[:, 2],
                    self.particle_size,
                )
            _PICKED_MICROGRAPHS.inc(
                picker=self.name, status="ok" if len(coords) else "empty")
            _PICKED_PARTICLES.inc(len(coords), picker=self.name)
            total += len(coords)
        _PICKER_LAST_TOTAL.set(total, picker=self.name)
        return total

    def fit(self, train_mrc: str, train_box: str, val_mrc: str,
            val_box: str, model_out: str) -> None:
        from repic_tpu_torch.models.checkpoint import (
            load_checkpoint,
            save_checkpoint,
        )
        from repic_tpu_torch.models.data import load_dataset
        from repic_tpu_torch.models.train import TrainConfig, fit
        from repic_tpu_torch.pipeline.consensus import resolve_device

        device = resolve_device(self.device)
        train_data, train_labels = load_dataset(
            train_mrc, train_box, self.particle_size, seed=self.seed,
            device=device)
        val_data, val_labels = load_dataset(
            val_mrc, val_box, self.particle_size, seed=self.seed + 1,
            device=device)
        init_params = None
        if self.model_path and os.path.exists(self.model_path):
            # each round retrains from the previous round's model
            init_params, _ = load_checkpoint(self.model_path)
        with tlm_events.span("picker_fit", picker=self.name):
            result = fit(
                train_data,
                train_labels,
                val_data,
                val_labels,
                TrainConfig(
                    batch_size=self.batch_size,
                    max_epochs=self.max_epochs,
                    seed=self.seed,
                    verbose=False,
                    compute_dtype=self.compute_dtype,
                ),
                init_params=init_params,
                arch=self.arch,
                device=device,
            )
        save_checkpoint(
            model_out,
            result.params,
            {
                "particle_size": self.particle_size,
                "patch_norm": "reference",
                "best_val_error": result.best_val_error,
                "picker": self.name,
                "arch": self.arch,
            },
        )
        self.model_path = model_out


@dataclass
class ExternalPicker:
    """Base of the conda-environment subprocess pickers: subclasses
    give the command lines, this base runs them as ``conda run -n ENV
    cmd...`` and keeps their output as a log."""

    name: str
    conda_env: str
    particle_size: int
    extra_env: dict = field(default_factory=dict)

    def predict(self, mrc_dir, out_box_dir):
        raise PickerError(
            f"{self.name}: external picker execution requires a "
            f"configured conda environment ({self.conda_env!r}); use a "
            "subclass with command templates or set the env to "
            "'builtin' for the in-framework picker"
        )

    def fit(self, *a, **k):
        raise PickerError(f"{self.name}: see predict()")

    def _run(self, cmd: list[str], log_path: str | None = None) -> None:
        if shutil.which("conda") is None:
            raise PickerError(
                f"{self.name}: conda not available for env "
                f"{self.conda_env!r}"
            )
        full = ["conda", "run", "-n", self.conda_env] + cmd
        env = dict(os.environ, **{
            k: str(v) for k, v in self.extra_env.items()
        })
        out = subprocess.run(full, capture_output=True, text=True, env=env)
        if log_path:
            with atomic_write(log_path) as f:
                f.write(out.stdout)
                f.write(out.stderr)
        if out.returncode != 0:
            raise PickerError(
                f"{self.name}: command failed ({out.returncode}): "
                f"{' '.join(cmd)}\n{out.stderr[-2000:]}"
            )


@dataclass
class CryoloPicker(ExternalPicker):
    """SPHIRE-crYOLO adapter."""

    model_path: str | None = None

    def _write_config(self, path, work, train=None):
        """crYOLO config JSON with the LOWPASS filter at cutoff 0.1."""
        cfg = {
            "model": {
                "architecture": "PhosaurusNet",
                "input_size": 1024,
                "anchors": [self.particle_size, self.particle_size],
                "max_box_per_image": 700,
                "filter": [0.1, os.path.join(work, "filtered_tmp")],
            }
        }
        if train:
            train_mrc, train_box, val_mrc, val_box, model_out = train
            cfg["train"] = {
                "train_image_folder": train_mrc,
                "train_annot_folder": train_box,
                "train_times": 1,
                "batch_size": 2,
                "learning_rate": 1e-4,
                "nb_epoch": 200,
                "saved_weights_name": model_out,
            }
            cfg["valid"] = {
                "valid_image_folder": val_mrc,
                "valid_annot_folder": val_box,
            }
        with atomic_write(path) as f:
            json.dump(cfg, f, indent=2)

    def predict_cmd(self, mrc_dir, out_dir, config_json):
        # threshold 0.0, write empty outputs
        return [
            "cryolo_predict.py",
            "-c", config_json,
            "-w", self.model_path or "",
            "-i", mrc_dir,
            "-o", out_dir,
            "-t", "0.0",
            "--write_empty",
        ]

    def fit_cmd(self, config_json):
        # early stop 32, warm restart 5, seed 1
        return [
            "cryolo_train.py",
            "-c", config_json,
            "-w", "5",
            "-e", "32",
            "--seed", "1",
        ]

    def predict(self, mrc_dir, out_box_dir) -> int:
        if not self.model_path:
            raise PickerError("cryolo: no model weights configured")
        os.makedirs(out_box_dir, exist_ok=True)
        work = os.path.join(out_box_dir, "_cryolo_work")
        os.makedirs(work, exist_ok=True)
        config_json = os.path.join(work, "config.json")
        self._write_config(config_json, work)
        self._run(
            self.predict_cmd(mrc_dir, work, config_json),
            log_path=os.path.join(out_box_dir, "cryolo_predict.log"),
        )
        # crYOLO writes CBOX files under <out>/CBOX
        return _convert_predictions_to_box(
            os.path.join(work, "CBOX"), "cbox", out_box_dir,
            self.particle_size, mrc_dir,
        )

    def fit(self, train_mrc, train_box, val_mrc, val_box, model_out):
        work = os.path.dirname(os.path.abspath(model_out))
        os.makedirs(work, exist_ok=True)
        config_json = os.path.join(work, "cryolo_train_config.json")
        self._write_config(
            config_json, work,
            train=(train_mrc, train_box, val_mrc, val_box, model_out),
        )
        self._run(
            self.fit_cmd(config_json),
            log_path=os.path.join(work, "cryolo_train.log"),
        )
        self.model_path = model_out


@dataclass
class DeepPickerExternal(ExternalPicker):
    """DeepPicker adapter."""

    deep_dir: str | None = None  # DeepPicker source checkout
    model_path: str | None = None
    batch_size: int = 1000

    def predict_cmd(self, mrc_dir, out_dir):
        # the patched autoPick.py at threshold 0.0
        return [
            "python",
            os.path.join(self.deep_dir or ".", "autoPick.py"),
            "--inputDir", mrc_dir,
            "--pre_trained_model", self.model_path or "",
            "--particle_size", str(self.particle_size),
            "--outputDir", out_dir,
            "--threshold", "0.0",
        ]

    def fit_cmd(self, train_dir, val_dir, model_out):
        # retrain type 1 from the previous model
        return [
            "python",
            os.path.join(self.deep_dir or ".", "train.py"),
            "--train_type", "1",
            "--train_inputDir", train_dir,
            "--validation_inputDir", val_dir,
            "--particle_size", str(self.particle_size),
            "--model_retrain",
            "--model_load_file", self.model_path or "",
            "--model_save_file", model_out,
            "--batch_size", str(self.batch_size),
        ]

    def predict(self, mrc_dir, out_box_dir) -> int:
        if not self.deep_dir:
            raise PickerError(
                "deep: set deep_dir to the DeepPicker checkout "
                "(iter_config --deep_dir)"
            )
        if not self.model_path:
            raise PickerError("deep: no model weights configured")
        os.makedirs(out_box_dir, exist_ok=True)
        work = os.path.join(out_box_dir, "_deep_work")
        os.makedirs(work, exist_ok=True)
        self._run(
            self.predict_cmd(mrc_dir, work),
            log_path=os.path.join(out_box_dir, "deep_predict.log"),
        )
        # autoPick writes one STAR per micrograph
        return _convert_predictions_to_box(
            work, "star", out_box_dir, self.particle_size, mrc_dir,
        )

    def fit(self, train_mrc, train_box, val_mrc, val_box, model_out):
        # DeepPicker trains from STAR labels with the micrographs
        # symlinked beside them
        work = os.path.dirname(os.path.abspath(model_out))
        train_dir = _stage_star_labels(
            train_mrc, train_box, os.path.join(work, "deep_train"))
        val_dir = _stage_star_labels(
            val_mrc, val_box, os.path.join(work, "deep_val"))
        self._run(
            self.fit_cmd(train_dir, val_dir, model_out),
            log_path=os.path.join(work, "deep_train.log"),
        )
        self.model_path = model_out


@dataclass
class TopazPicker(ExternalPicker):
    """Topaz adapter."""

    scale: int = 4
    radius: int = 8
    model_path: str | None = None
    balance: float | None = None  # minibatch balance feedback

    expected_particles: int = 0

    def preprocess_cmd(self, mrc_dir, down_dir):
        # downsample the micrographs by the scale
        return [
            "topaz", "preprocess",
            "-s", str(self.scale),
            "-o", down_dir,
        ] + sorted(
            os.path.join(mrc_dir, f)
            for f in os.listdir(mrc_dir)
            if f.endswith(".mrc")
        )

    def predict_cmd(self, down_dir, out_file):
        # no shell: the downsampled files are listed, not globbed
        cmd = ["topaz", "extract", "-r", str(self.radius)]
        if self.model_path:
            cmd += ["-m", self.model_path]
        cmd += ["-o", out_file]
        cmd += sorted(
            os.path.join(down_dir, f)
            for f in os.listdir(down_dir)
            if f.endswith(".mrc")
        )
        return cmd

    def fit_cmd(self, train_dir, targets, model_out, expected):
        # expected particles x1.25 and the measured minibatch balance
        cmd = [
            "topaz", "train",
            "--train-images", train_dir,
            "--train-targets", targets,
            "--num-particles", str(int(expected * 1.25)),
            "--save-prefix", model_out,
        ]
        if self.balance is not None:
            cmd += ["--minibatch-balance", f"{self.balance:.6f}"]
        return cmd

    def predict(self, mrc_dir, out_box_dir) -> int:
        os.makedirs(out_box_dir, exist_ok=True)
        work = os.path.join(out_box_dir, "_topaz_work")
        down = os.path.join(work, "down")
        os.makedirs(down, exist_ok=True)
        self._run(
            self.preprocess_cmd(mrc_dir, down),
            log_path=os.path.join(out_box_dir, "topaz_preprocess.log"),
        )
        out_tsv = os.path.join(work, "extracted.txt")
        self._run(
            self.predict_cmd(down, out_tsv),
            log_path=os.path.join(out_box_dir, "topaz_extract.log"),
        )
        # one extraction table -> per-micrograph BOX files on the
        # original grid, empty placeholders for the rest
        return _topaz_tsv_to_box(
            out_tsv, out_box_dir, self.particle_size, self.scale, mrc_dir,
        )

    def fit(self, train_mrc, train_box, val_mrc, val_box, model_out):
        work = os.path.dirname(os.path.abspath(model_out))
        down = os.path.join(work, "topaz_train_down")
        os.makedirs(down, exist_ok=True)
        self._run(
            self.preprocess_cmd(train_mrc, down),
            log_path=os.path.join(work, "topaz_preprocess.log"),
        )
        targets = os.path.join(work, "topaz_targets.txt")
        expected = _box_dir_to_topaz_tsv(
            train_box, targets, self.particle_size, self.scale)
        self._run(
            self.fit_cmd(down, targets, model_out,
                         self.expected_particles or expected),
            log_path=os.path.join(work, "topaz_train.log"),
        )
        self.model_path = model_out


def _empty_for_the_rest(mrc_dir, out_box_dir, produced) -> None:
    for mrc in _mrcs(mrc_dir):
        if _stem(mrc) not in produced:
            write_empty_box(os.path.join(out_box_dir, _stem(mrc) + ".box"))


def _convert_predictions_to_box(
    pred_dir, in_fmt, out_box_dir, box_size, mrc_dir
) -> int:
    """Per-micrograph picker outputs (CBOX or STAR) to BOX files, with
    empty placeholders for micrographs without output."""
    from repic_tpu_torch.utils import coords as coords_mod

    paths = sorted(glob.glob(os.path.join(pred_dir, f"*.{in_fmt}")))
    total = 0
    produced = set()
    if paths:
        tables = coords_mod.convert(
            paths, in_fmt, "box", boxsize=box_size, quiet=True)
        for path, t in tables.items():
            stem = _stem(path)
            produced.add(stem)
            out = os.path.join(out_box_dir, stem + ".box")
            if len(t) == 0:
                write_empty_box(out)
                continue
            conf = (np.asarray(t["conf"], float) if "conf" in t
                    else [1.0] * len(t))
            write_box(out, t.to_numpy(["x", "y"], float), conf, box_size)
            total += len(t)
    _empty_for_the_rest(mrc_dir, out_box_dir, produced)
    return total


def _stage_star_labels(mrc_dir, box_dir, out_dir) -> str:
    """DeepPicker's training layout: STAR labels with the micrographs
    symlinked beside them."""
    from repic_tpu_torch.utils import coords as coords_mod

    os.makedirs(out_dir, exist_ok=True)
    boxes = sorted(glob.glob(os.path.join(box_dir, "*.box")))
    if boxes:
        coords_mod.convert(boxes, "box", "star", out_dir=out_dir,
                           quiet=True, force=True)
    for mrc in _mrcs(mrc_dir):
        link = os.path.join(out_dir, os.path.basename(mrc))
        if os.path.islink(link) or os.path.exists(link):
            os.unlink(link)
        os.symlink(os.path.abspath(mrc), link)
    return out_dir


def _topaz_tsv_to_box(tsv_path, out_box_dir, box_size, scale, mrc_dir) -> int:
    """Split a topaz extraction table (``image_name x_coord y_coord
    score`` on the downsampled grid) into per-micrograph BOX files on
    the original grid: coordinates times ``scale``, centre to corner,
    empty placeholders for the micrographs it does not name."""
    from repic_tpu_torch.utils.table import group_by, read_tab_table

    os.makedirs(out_box_dir, exist_ok=True)
    produced = set()
    total = 0
    if os.path.exists(tsv_path) and os.path.getsize(tsv_path) > 0:
        t = read_tab_table(tsv_path)
        cols = {str(c).lower(): c for c in t.columns}
        name_c = cols.get("image_name", t.columns[0])
        for stem, grp in group_by(t, name_c):
            stem = str(stem)
            produced.add(stem)
            xy = grp.to_numpy([cols.get("x_coord", "x_coord"),
                               cols.get("y_coord", "y_coord")], float)
            xy = xy * scale - box_size / 2.0
            conf = (np.asarray(grp[cols["score"]], float)
                    if "score" in cols else np.ones(len(grp)))
            write_box(os.path.join(out_box_dir, stem + ".box"),
                      xy, conf, box_size)
            total += len(grp)
    _empty_for_the_rest(mrc_dir, out_box_dir, produced)
    return total


def _box_dir_to_topaz_tsv(box_dir, out_tsv, box_size, scale) -> int:
    """BOX labels -> a topaz training-target table on the downsampled
    grid (corner to centre, divided by ``scale``).  Returns the mean
    particle count per micrograph, at least 1 when there are any."""
    rows = []
    files = sorted(glob.glob(os.path.join(box_dir, "*.box")))
    for f in files:
        stem = _stem(f)
        bs = read_box(f)
        for (x, y) in bs.xy:
            cx = (float(x) + box_size / 2.0) / scale
            cy = (float(y) + box_size / 2.0) / scale
            rows.append((stem, int(round(cx)), int(round(cy))))
    with atomic_write(out_tsv) as f:
        f.write("image_name\tx_coord\ty_coord\n")
        for stem, x, y in rows:
            f.write(f"{stem}\t{x}\t{y}\n")
    mean = int(round(len(rows) / max(len(files), 1)))
    return max(mean, 1) if rows else 0


def build_pickers(config: dict) -> list:
    """The picker ensemble of an ``iter_config`` dict: environments set
    to ``"builtin"`` become :class:`BuiltinPicker` (deep/wide/slim by
    slot, seeds ``1234 + 1111 * i``), anything else the slot's external
    adapter."""
    particle_size = int(config["box_size"])
    pickers = []
    specs = [
        ("cryolo", config.get("cryolo_env", "builtin")),
        ("deep", config.get("deep_env", "builtin")),
        ("topaz", config.get("topaz_env", "builtin")),
    ]
    for i, (pname, env) in enumerate(specs):
        if env == "builtin":
            # each builtin picker takes its own <name>_model slot; the
            # cryolo_model slot doubles as a shared initial checkpoint
            # for the whole builtin ensemble, but only when it is itself
            # a repic-tpu checkpoint (in mixed configs it may be a
            # SPHIRE-crYOLO .h5)
            init = config.get(f"{pname}_model")
            if not init:
                shared = config.get("cryolo_model") or ""
                if shared.endswith(".rptpu"):
                    init = shared
            model = init if init and init != "builtin" else None
            default_arch = ("deep", "wide", "slim")[i % 3]
            pickers.append(
                BuiltinPicker(
                    name=pname,
                    particle_size=particle_size,
                    seed=1234 + 1111 * i,
                    model_path=model,
                    arch=config.get(f"{pname}_arch", default_arch),
                    compute_dtype=config.get("compute_dtype", "float32"),
                )
            )
        elif pname == "cryolo":
            pickers.append(
                CryoloPicker(
                    name=pname,
                    conda_env=env,
                    particle_size=particle_size,
                    model_path=config.get("cryolo_model"),
                )
            )
        elif pname == "topaz":
            pickers.append(
                TopazPicker(
                    name=pname,
                    conda_env=env,
                    particle_size=particle_size,
                    scale=int(config.get("topaz_scale", 4)),
                    radius=int(config.get("topaz_rad", 8)),
                )
            )
        else:
            pickers.append(
                DeepPickerExternal(
                    name=pname,
                    conda_env=env,
                    particle_size=particle_size,
                    deep_dir=config.get("deep_dir"),
                    model_path=config.get("deep_model"),
                    batch_size=int(config.get("deep_batch_size", 1000)),
                )
            )
    return pickers
