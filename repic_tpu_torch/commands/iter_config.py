"""Write the iterative loop's configuration (``iter_config.json``).

Validates the paths and picker environments, then serializes the
parameters for ``iter_pick``.  Picker environments are checked only
where conda is installed: an environment set to ``builtin`` is the
port's own CNN picker (deep/wide/slim by slot), and DeepPicker's file
layout is checked only when an external DeepPicker directory is given.
"""

import json
import os
import shutil
import subprocess

name = "iter_config"

ENV_DEFAULTS = {"cryolo": "cryolo", "deep": "deep", "topaz": "topaz"}
BUILTIN = "builtin"

# the expected files of an external DeepPicker installation
EXPECTED_DEEP_FILES = [
    "autoPicker.py",
    "autoPick.py",
    "dataLoader.py",
    "deepModel.py",
    "starReader.py",
    "train.py",
]


def add_arguments(parser):
    parser.add_argument(
        "data_dir", help="path to directory containing training data"
    )
    parser.add_argument(
        "box_size", type=int, help="particle detection box size (pixels)"
    )
    parser.add_argument(
        "exp_particles", type=int, help="number of expected particles"
    )
    parser.add_argument(
        "cryolo_model",
        help="path to LOWPASS SPHIRE-crYOLO model, or 'builtin'",
    )
    parser.add_argument(
        "deep_dir", help="path to DeepPicker scripts, or 'builtin'"
    )
    parser.add_argument("topaz_scale", type=int, help="Topaz scale value")
    parser.add_argument(
        "topaz_rad", type=int, help="Topaz particle radius (pixels)"
    )
    for picker, default in ENV_DEFAULTS.items():
        parser.add_argument(
            f"--{picker}_env",
            type=str,
            default=default,
            help=f"conda env for {picker} (or 'builtin' for the "
            "port's own CNN picker)",
        )
    parser.add_argument(
        "--out_file_path",
        type=str,
        default="iter_config.json",
        help="path for created config file",
    )
    parser.add_argument(
        "--bf16",
        action="store_true",
        help="builtin pickers only: bfloat16 conv/matmul compute for "
        "training and scoring (checkpoints stay float32) -- written as "
        "compute_dtype in the config",
    )


def _conda_envs():
    if shutil.which("conda") is None:
        return None
    try:
        out = subprocess.check_output(["conda", "info", "--envs"],
                                      text=True)
    except subprocess.CalledProcessError:
        return None
    envs = []
    for line in out.strip().split("\n"):
        if line.startswith(("#", " ")):
            continue
        envs.append(line.split()[0])
    return envs


def main(args):
    print("Validating config parameters")
    assert os.path.exists(args.data_dir), (
        f"Error - training data directory does not exist: {args.data_dir}"
    )
    if args.cryolo_model != BUILTIN:
        assert os.path.exists(args.cryolo_model), (
            f"Error - provided SPHIRE-crYOLO model not found: "
            f"{args.cryolo_model}"
        )
    if args.deep_dir != BUILTIN:
        assert os.path.exists(args.deep_dir), (
            f"Error - DeepPicker directory does not exist: {args.deep_dir}"
        )
        missing = [
            f
            for f in EXPECTED_DEEP_FILES
            if not os.path.exists(os.path.join(args.deep_dir, f))
        ]
        assert not missing, (
            f"Error - DeepPicker file(s) are missing: {', '.join(missing)}"
        )

    wanted = {args.cryolo_env, args.deep_env, args.topaz_env} - {BUILTIN}
    if wanted:
        envs = _conda_envs()
        if envs is None:
            print(
                "WARN: conda not available - skipping environment "
                f"validation for: {', '.join(sorted(wanted))}"
            )
        else:
            missing = wanted - set(envs)
            assert not missing, (
                f"Error - Conda environment(s) not found: "
                f"{', '.join(sorted(missing))}"
            )

    params = {
        k: v
        for k, v in vars(args).items()
        if k not in (
            "command", "func", "out_file_path", "platform", "bf16",
            "_module",
        )
    }
    params["compute_dtype"] = "bfloat16" if args.bf16 else "float32"
    print(f"Writing config file to {args.out_file_path}")
    from repic_tpu_torch.runtime.atomic import atomic_write

    with atomic_write(args.out_file_path) as o:
        json.dump(params, o, indent=4)


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser()
    add_arguments(parser)
    main(parser.parse_args())
