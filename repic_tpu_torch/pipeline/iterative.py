"""Iterative ensemble particle picking -- the orchestrator (the port of
``repic_tpu.pipeline.iterative``):

    Step 1  build defocus-stratified train/val/test splits
    Step 2  round 0: every picker predicts every split and the consensus
            of their picks is built per split; in semi-automatic mode
            round 0 is a sampled fraction of manual labels instead
    Step 3  rounds 1..N: retrain each picker on the previous round's
            consensus train labels, re-predict, re-build the consensus

Each stage logs to ``iter_pick.log``; ``state.json`` is written after
every completed round, and a rerun of the same configuration resumes
after the last one whose consensus directories still exist.  The
measured positive fraction feeds balance-aware pickers (Topaz).  The
builtin pickers and the consensus run on ``device`` (``cuda`` unless
the caller asks for the CPU).
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import time
from dataclasses import dataclass, field

import numpy as np

from repic_tpu_torch.pipeline import pickers as pickers_mod
from repic_tpu_torch.pipeline.consensus import run_consensus_dir
from repic_tpu_torch.telemetry import events as tlm_events
from repic_tpu_torch.utils.box_io import read_box, write_box

_log = tlm_events.get_logger("iter_pick")

SPLITS = ("train", "val", "test")


@dataclass
class IterativeState:
    """Mutable per-run state carried across rounds."""

    out_dir: str
    rounds: list = field(default_factory=list)
    balance: float | None = None  # measured positive fraction
    fingerprint: dict | None = None  # run parameters, guards resume

    def log(self, msg: str) -> None:
        stamp = time.strftime("%Y-%m-%d %H:%M:%S")
        line = f"[{stamp}] {msg}"
        _log.info(msg)
        with open(os.path.join(self.out_dir, "iter_pick.log"), "at") as f:
            f.write(line + "\n")

    def save(self) -> None:
        """Publish ``state.json`` atomically (after every completed
        round, so a crashed run resumes instead of retraining)."""
        path = os.path.join(self.out_dir, "state.json")
        tmp = path + ".tmp"
        with open(tmp, "wt") as f:
            json.dump(
                {
                    "rounds": self.rounds,
                    "balance": self.balance,
                    "fingerprint": self.fingerprint,
                },
                f,
                indent=2,
            )
        os.replace(tmp, path)


def _run_fingerprint(
    config, train_size, seed, semi_auto,
    manual_label_dir, semi_auto_fraction,
) -> dict:
    """The parameters that must match for an on-disk run to be
    resumable: anything that changes splits, labels, or geometry."""
    return {
        "data_dir": os.path.abspath(str(config["data_dir"])),
        "box_size": int(config["box_size"]),
        "train_size": int(train_size),
        "seed": int(seed),
        "semi_auto": bool(semi_auto),
        "manual_label_dir": (
            os.path.abspath(manual_label_dir) if manual_label_dir else None
        ),
        "semi_auto_fraction": float(semi_auto_fraction),
        "exp_particles": int(config.get("exp_particles", 0)),
    }


def _load_resume_state(state: IterativeState) -> int:
    """Load ``state.json`` of a previous run of the same configuration;
    returns the number of completed rounds whose consensus outputs
    still exist (0 = start from scratch).  A fingerprint mismatch is
    logged and the run restarts."""
    path = os.path.join(state.out_dir, "state.json")
    try:
        with open(path) as f:
            prev = json.load(f)
    except (OSError, ValueError):
        return 0
    if prev.get("fingerprint") != state.fingerprint:
        state.log(
            "state.json found but run parameters differ "
            "(data_dir/box_size/train_size/seed/semi_auto); "
            "starting from round 0"
        )
        return 0
    rounds = prev.get("rounds") or []
    usable = 0
    for rec in rounds:
        if all(
            os.path.isdir(d) for d in rec.get("consensus", {}).values()
        ) and len(rec.get("consensus", {})) == len(SPLITS):
            usable += 1
        else:
            break
    if usable:
        state.rounds = rounds[:usable]
        # the balance measured after the round resumed from, not the
        # previous run's last value
        state.balance = rounds[usable - 1].get(
            "balance", prev.get("balance"))
    return usable


def _stem(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def build_splits(
    data_dir: str,
    out_dir: str,
    *,
    train_size: int = 100,
    seed: int = 0,
) -> dict:
    """Split the micrographs into train/val/test symlink trees under
    ``out_dir/data``: defocus-stratified tertile sampling when a
    ``defocus*.t*`` table is present, else a seeded uniform split (20%
    train, up to 6 val, the rest test); ``train_size`` keeps that
    percentage of the training split.  Returns ``{split: mrc_dir}``."""
    from repic_tpu_torch.utils import subsets as subsets_mod

    mrcs = sorted(glob.glob(os.path.join(data_dir, "*.mrc")))
    if not mrcs:
        raise FileNotFoundError(f"no .mrc files in {data_dir}")

    defocus_files = sorted(glob.glob(os.path.join(data_dir, "defocus*.t*")))
    if defocus_files:
        # the table's names may or may not carry .mrc: keyed by stem
        defocus = {
            _stem(fname): d
            for fname, d in subsets_mod.parse_defocus_file(defocus_files[0])
        }
        data = [(m, defocus.get(_stem(m), 0.0)) for m in mrcs]
        train, val, test, _ = subsets_mod.split_dataset(data, seed=seed)
        train_files = [f for f, _ in train]
        val_files = [f for f, _ in val]
        test_files = [f for f, _ in test]
    else:
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(mrcs))
        n_train = max(int(round(0.2 * len(mrcs))), 1)
        n_val = min(max(len(mrcs) - n_train - 1, 1), 6)
        train_files = [mrcs[i] for i in order[:n_train]]
        val_files = [mrcs[i] for i in order[n_train:n_train + n_val]]
        test_files = [mrcs[i] for i in order[n_train + n_val:]]

    if train_size < 100:
        keep = max(int(round(len(train_files) * train_size / 100.0)), 1)
        train_files = train_files[:keep]

    split_dirs = {}
    for split, files in (
        ("train", train_files),
        ("val", val_files),
        ("test", test_files),
    ):
        d = os.path.join(out_dir, "data", split)
        # rebuilt from scratch: no stale link from an earlier run
        if os.path.isdir(d):
            shutil.rmtree(d)
        os.makedirs(d)
        for f in files:
            os.symlink(os.path.abspath(f),
                       os.path.join(d, os.path.basename(f)))
        split_dirs[split] = d
    return split_dirs


def seed_round0_from_manual(
    manual_dir: str,
    split_dirs: dict,
    round_dir: str,
    *,
    fraction: float = 0.01,
    seed: int = 0,
    box_size: int | None = None,
) -> dict:
    """Semi-automatic round 0: a sampled ``fraction`` of each
    micrograph's manual labels as the initial consensus.  Returns
    ``{split: consensus_box_dir}``."""
    rng = np.random.default_rng(seed)
    out = {}
    for split, mrc_dir in split_dirs.items():
        cdir = os.path.join(round_dir, "consensus", split)
        os.makedirs(cdir, exist_ok=True)
        for mrc_path in sorted(glob.glob(os.path.join(mrc_dir, "*.mrc"))):
            stem = _stem(mrc_path)
            src = os.path.join(manual_dir, stem + ".box")
            if not os.path.exists(src):
                continue
            bs = read_box(src)
            if len(bs.xy) == 0:
                continue
            n = max(int(round(len(bs.xy) * fraction)), 1)
            idx = rng.permutation(len(bs.xy))[:n]
            size = box_size or int(bs.wh[0][0])
            write_box(
                os.path.join(cdir, stem + ".box"),
                np.asarray(bs.xy, float)[idx],
                np.asarray(bs.conf, float)[idx],
                size,
            )
        out[split] = cdir
    return out


def predict_round(
    pickers: list,
    split_dirs: dict,
    round_dir: str,
    state: IterativeState,
) -> dict:
    """Every picker predicts every split.  Returns ``{split:
    predictions_dir}``, each holding one subdirectory per picker (the
    consensus input's layout)."""
    pred_dirs = {}
    for split, mrc_dir in split_dirs.items():
        pdir = os.path.join(round_dir, "predictions", split)
        # no stale BOX file from an earlier run may reach the consensus
        if os.path.isdir(pdir):
            shutil.rmtree(pdir)
        for picker in pickers:
            t0 = time.time()
            n = picker.predict(mrc_dir, os.path.join(pdir, picker.name))
            state.log(
                f"predict {picker.name}/{split}: {n} particles "
                f"({time.time() - t0:.1f}s)"
            )
        pred_dirs[split] = pdir
    return pred_dirs


def consensus_round(
    pred_dirs: dict,
    round_dir: str,
    box_size: int,
    state: IterativeState,
    *,
    num_particles: int | None = None,
    strict: bool = False,
    device=None,
) -> dict:
    """The consensus per split, on ``device``; returns ``{split:
    consensus_dir}``.  Runs under the fault-tolerant runtime with
    ``resume=True`` (an interrupted round continues from its journal)
    and, unless ``strict``, quarantines a micrograph with a bad BOX
    file instead of failing the round; quarantines go to the log."""
    out = {}
    for split, pdir in pred_dirs.items():
        cdir = os.path.join(round_dir, "consensus", split)
        t0 = time.time()
        stats = run_consensus_dir(
            pdir,
            cdir,
            box_size,
            num_particles=num_particles,
            resume=True,
            strict=strict,
            device=device,
        )
        state.log(
            f"consensus/{split}: {stats.get('num_cliques', 0)} "
            f"cliques over {stats['micrographs']} micrographs "
            f"({time.time() - t0:.1f}s)"
        )
        if stats.get("quarantined"):
            state.log(
                f"consensus/{split}: QUARANTINED "
                f"{sorted(stats['quarantined'])} "
                "(see _journal.jsonl in the consensus dir)"
            )
        out[split] = cdir
    return out


def measure_balance(consensus_dir: str, exp_particles: int) -> float | None:
    """Measured positive fraction: the mean consensus particles per
    micrograph over the expected count."""
    files = glob.glob(os.path.join(consensus_dir, "*.box"))
    if not files or exp_particles <= 0:
        return None
    counts = [len(read_box(f).xy) for f in files]
    return float(np.mean(counts)) / float(exp_particles)


def run_iterative(
    config: dict,
    num_iter: int,
    train_size: int,
    out_dir: str,
    *,
    semi_auto: bool = False,
    manual_label_dir: str | None = None,
    semi_auto_fraction: float = 0.01,
    score_gt_dir: str | None = None,
    seed: int = 0,
    picker_overrides: dict | None = None,
    resume: bool = True,
    strict: bool = False,
    device=None,
) -> IterativeState:
    """The full iterative ensemble pipeline.

    Args:
        config: dict from ``iter_config`` (data_dir, box_size,
            exp_particles, picker envs/models).
        num_iter: number of retraining rounds.
        train_size: training-subset percentage 1|25|50|100.
        semi_auto: seed round 0 from sampled manual labels instead of
            pre-trained picker predictions.
        manual_label_dir: BOX labels for semi_auto.
        semi_auto_fraction: fraction of manual labels sampled for the
            round-0 seed.
        score_gt_dir: if set, score every consensus stage against these
            ground-truth BOX files.
        picker_overrides: attribute overrides applied to every picker
            adapter (e.g. ``{"max_epochs": 5}`` for fast runs).
        resume: continue a previous run of the same configuration from
            its last completed round.
        strict: fail fast on bad inputs in the consensus stages instead
            of quarantining.
        device: where the builtin pickers, the consensus and the
            scoring run (``cuda`` unless the caller asks for the CPU).
    """
    os.makedirs(out_dir, exist_ok=True)
    state = IterativeState(out_dir=out_dir)
    state.fingerprint = _run_fingerprint(
        config, train_size, seed, semi_auto,
        manual_label_dir, semi_auto_fraction,
    )
    done_rounds = _load_resume_state(state) if resume else 0
    box_size = int(config["box_size"])
    exp_particles = int(config.get("exp_particles", 0))

    pickers = pickers_mod.build_pickers(config)
    overrides = dict(picker_overrides or {})
    if device is not None:
        overrides.setdefault("device", str(device))
    for k, v in overrides.items():
        for p in pickers:
            if hasattr(p, k):
                setattr(p, k, v)
    state.log(
        f"pickers: {', '.join(p.name for p in pickers)} "
        f"(box {box_size}, {num_iter} rounds, train {train_size}%)"
    )

    split_dirs = build_splits(
        config["data_dir"], out_dir, train_size=train_size, seed=seed)
    for s in SPLITS:
        n = len(glob.glob(os.path.join(split_dirs[s], "*.mrc")))
        state.log(f"split {s}: {n} micrographs")

    if done_rounds:
        # resume: skip the completed rounds, restore the picker models
        # and the balance of the last one
        last = done_rounds - 1
        state.log(
            f"resuming: rounds 0..{last} already complete "
            f"({len(state.rounds)} recorded in state.json)"
        )
        if last >= 1:
            models_dir = os.path.join(out_dir, f"round_{last}", "models")
            for picker in pickers:
                mpath = os.path.join(models_dir, f"{picker.name}.rptpu")
                if os.path.exists(mpath):
                    picker.model_path = mpath
                    state.log(f"resume: {picker.name} model <- {mpath}")
        if state.balance is not None:
            for p in pickers:
                if hasattr(p, "balance"):
                    p.balance = state.balance

    # round 0
    if not done_rounds:
        round_dir = os.path.join(out_dir, "round_0")
        os.makedirs(round_dir, exist_ok=True)
        if semi_auto:
            if not manual_label_dir:
                raise ValueError("semi_auto requires manual_label_dir")
            consensus_dirs = seed_round0_from_manual(
                manual_label_dir,
                split_dirs,
                round_dir,
                fraction=semi_auto_fraction,
                seed=seed,
                box_size=box_size,
            )
            state.log("round 0 seeded from sampled manual labels (semi-auto)")
        else:
            pred_dirs = predict_round(pickers, split_dirs, round_dir, state)
            consensus_dirs = consensus_round(
                pred_dirs, round_dir, box_size, state,
                num_particles=exp_particles or None, strict=strict,
                device=device,
            )
        _finish_round(
            state, pickers, consensus_dirs, round_dir,
            exp_particles, score_gt_dir, "round_0", device,
        )

    # rounds 1..N: fit -> predict -> consensus
    for it in range(max(1, done_rounds), num_iter + 1):
        prev = state.rounds[-1]["consensus"]
        round_dir = os.path.join(out_dir, f"round_{it}")
        models_dir = os.path.join(round_dir, "models")
        os.makedirs(models_dir, exist_ok=True)
        for picker in pickers:
            t0 = time.time()
            picker.fit(
                split_dirs["train"],
                prev["train"],
                split_dirs["val"],
                prev["val"],
                os.path.join(models_dir, f"{picker.name}.rptpu"),
            )
            state.log(f"round {it} fit {picker.name} "
                      f"({time.time() - t0:.1f}s)")
        pred_dirs = predict_round(pickers, split_dirs, round_dir, state)
        consensus_dirs = consensus_round(
            pred_dirs, round_dir, box_size, state,
            num_particles=exp_particles or None, strict=strict,
            device=device,
        )
        _finish_round(
            state, pickers, consensus_dirs, round_dir,
            exp_particles, score_gt_dir, f"round_{it}", device,
        )

    state.save()
    state.log("iterative picking complete")
    return state


def _finish_round(
    state, pickers, consensus_dirs, round_dir,
    exp_particles, score_gt_dir, tag, device=None,
):
    """Bookkeeping after a round's consensus: measure the positive
    fraction and hand it to balance-aware pickers, score against the
    ground truth, record the round and save the state."""
    state.balance = measure_balance(consensus_dirs["train"], exp_particles)
    if state.balance is not None:
        state.log(f"{tag} positive fraction: {state.balance:.4f}")
        for p in pickers:
            if hasattr(p, "balance"):
                p.balance = state.balance
    _score_stage(state, consensus_dirs, score_gt_dir, tag, device)
    state.rounds.append({
        "dir": round_dir,
        "consensus": consensus_dirs,
        "balance": state.balance,
    })
    state.save()  # this round survives a crash


def _score_stage(state, consensus_dirs, gt_dir, tag, device=None):
    """Score each split's consensus against the ground truth, when one
    is given (``particle_set_comp.tsv`` in the consensus directory)."""
    if not gt_dir:
        return
    from repic_tpu_torch.utils.scoring import (
        score_box_files,
        write_scores_tsv,
    )

    for split, cdir in consensus_dirs.items():
        gt = sorted(glob.glob(os.path.join(gt_dir, "*.box")))
        picked = sorted(glob.glob(os.path.join(cdir, "*.box")))
        if not gt or not picked:
            continue
        try:
            rows = score_box_files(gt, picked, device=device)
        except AssertionError:
            continue  # no matched pairs for this split
        out = write_scores_tsv(rows, cdir)
        mean_f1 = float(np.mean([r[3] for r in rows])) if rows else 0.0
        state.log(f"score {tag}/{split}: mean F1 {mean_f1:.3f} -> {out}")
