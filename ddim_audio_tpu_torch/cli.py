"""Command line of the port (the counterpart of the JAX package's
``main.py``): train, resume, test, sample.

    python -m ddim_audio_tpu_torch --config audio.yml --doc <run> --ni \\
        [--resume_training]                       # train
    python -m ddim_audio_tpu_torch --config audio.yml --doc <run> --test
    python -m ddim_audio_tpu_torch --config audio.yml --doc <run> --ni \\
        --sample --timesteps 100 [--sequence K | --interpolation] \\
        [--sample_type ddpm_noisy] [--eta e]

Same flags, same run-dir layout (checkpoints, ``config.yml`` and
``stdout.txt`` in ``<exp>/logs/<doc>``, samples in
``<exp>/image_samples/<image_folder>``), same overwrite rule (``--ni``
overwrites without asking; ``--resume_training`` keeps the folder) and exit
code 1 on a failed run. ``--device`` (default ``cuda``) is the port's own
flag.

Under a launcher (``WORLD_SIZE`` > 1) every rank joins the process group
first (``parallel.multihost.initialize``: ``cuda:LOCAL_RANK`` and NCCL, or
gloo with ``--device cpu``), and ``config.parallel`` {dp, sp} lays the
ranks out; rank 0 alone writes the run folder, its logs and the samples:

    python -m torch.distributed.run --nproc_per_node 2 \\
        -m ddim_audio_tpu_torch --config audio.yml --doc <run> --ni ...
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import sys
import traceback

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m ddim_audio_tpu_torch",
                                     description=__doc__)
    parser.add_argument("--config", type=str, required=True,
                        help="Path to the config file")
    parser.add_argument("--seed", type=int, default=1234, help="Random seed")
    parser.add_argument("--exp", type=str, default="exp",
                        help="Path for saving running related data.")
    parser.add_argument("--doc", type=str, required=True,
                        help="A string for documentation purpose. "
                        "Will be the name of the log folder.")
    parser.add_argument("--comment", type=str, default="",
                        help="A string for experiment comment")
    parser.add_argument("--verbose", type=str, default="info",
                        help="Verbose level: info | debug | warning | critical")
    parser.add_argument("--test", action="store_true",
                        help="Whether to test the model")
    parser.add_argument("--sample", action="store_true",
                        help="Whether to produce samples from the model")
    parser.add_argument("--fid", action="store_true")
    parser.add_argument("--interpolation", action="store_true")
    parser.add_argument("--resume_training", action="store_true",
                        help="Whether to resume training")
    parser.add_argument("-i", "--image_folder", type=str, default="images",
                        help="The folder name of samples")
    parser.add_argument("--ni", action="store_true",
                        help="No interaction. Suitable for Slurm Job launcher")
    parser.add_argument("--use_pretrained", action="store_true")
    parser.add_argument("--sample_type", type=str, default="generalized",
                        help="sampling approach (generalized or ddpm_noisy)")
    parser.add_argument("--skip_type", type=str, default="uniform",
                        help="skip according to (uniform or quadratic)")
    parser.add_argument("--timesteps", type=int, default=1000,
                        help="number of steps involved")
    parser.add_argument("--eta", type=float, default=0.0,
                        help="eta used to control the variances of sigma")
    parser.add_argument("--sequence", type=int, default=None,
                        help="while sample the sequence, number of "
                        "intermediates in each case")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (cuda unless the CPU is asked for)")
    return parser


def parse_args_and_config(argv=None, *, writer: bool = True):
    """(args, config). Only a ``writer`` (rank 0, or a plain process)
    clears and creates folders and writes ``config.yml`` and the log file;
    the other ranks log warnings and errors to the console alone."""
    from .config import dump_config, load_config

    args = build_parser().parse_args(argv)
    args.log_path = os.path.join(args.exp, "logs", args.doc)

    cfg_path = args.config
    if not os.path.exists(cfg_path):
        cfg_path = os.path.join("configs", args.config)
    config = load_config(cfg_path)
    tb_path = os.path.join(args.exp, "tensorboard", args.doc)

    if not writer:
        config.tb_logger = None
        _setup_logging(args, file_log=False, level="warning")
        if args.sample:
            args.image_folder = os.path.join(args.exp, "image_samples",
                                             args.image_folder)
    elif not args.test and not args.sample:
        if not args.resume_training:
            if os.path.exists(args.log_path):
                overwrite = args.ni or _ask(
                    "Folder already exists. Overwrite? (Y/N)")
                if not overwrite:
                    print("Folder exists. Program halted.")
                    sys.exit(0)
                shutil.rmtree(args.log_path)
                if os.path.exists(tb_path):
                    shutil.rmtree(tb_path)
            os.makedirs(args.log_path)
            dump_config(config, os.path.join(args.log_path, "config.yml"))
        try:
            import torch.utils.tensorboard as tb

            config.tb_logger = tb.SummaryWriter(log_dir=tb_path)
        except Exception:  # tensorboard is optional; metrics still hit the log
            config.tb_logger = None
        _setup_logging(args, file_log=True)
    else:
        _setup_logging(args, file_log=False)
        if args.sample:
            _prepare_image_folder(args)
    np.random.seed(args.seed)
    return args, config


def _prepare_image_folder(args):
    os.makedirs(os.path.join(args.exp, "image_samples"), exist_ok=True)
    args.image_folder = os.path.join(args.exp, "image_samples",
                                     args.image_folder)
    if not os.path.exists(args.image_folder):
        os.makedirs(args.image_folder)
    elif not (args.fid or args.interpolation):
        overwrite = args.ni or _ask(
            f"Image folder {args.image_folder} already exists. "
            "Overwrite? (Y/N)")
        if overwrite:
            shutil.rmtree(args.image_folder)
            os.makedirs(args.image_folder)
        else:
            print("Output image folder exists. Program halted.")
            sys.exit(0)


def _ask(prompt):
    return input(prompt).upper() == "Y"


def _setup_logging(args, *, file_log, level=None):
    level = getattr(logging, (level or args.verbose).upper(), None)
    if not isinstance(level, int):
        raise ValueError("level {} not supported".format(args.verbose))
    formatter = logging.Formatter(
        "%(levelname)s - %(filename)s - %(asctime)s - %(message)s")
    handlers = [logging.StreamHandler()]
    if file_log:
        handlers.append(logging.FileHandler(
            os.path.join(args.log_path, "stdout.txt")))
    logger = logging.getLogger()
    for handler in handlers:
        handler.setFormatter(formatter)
        logger.addHandler(handler)
    logger.setLevel(level)


def main(argv=None) -> int:
    from .parallel import multihost

    device = build_parser().parse_args(argv).device
    if multihost.launched():
        device = multihost.initialize(
            device=None if device == "cuda" else device)
    try:
        return _run(argv, device, writer=multihost.world_rank() == 0)
    finally:
        if multihost.launched():
            multihost.finalize()


def _run(argv, device, *, writer: bool) -> int:
    args, config = parse_args_and_config(argv, writer=writer)
    logging.info("Writing log file to {}".format(args.log_path))
    logging.info("Exp instance id = {}".format(os.getpid()))
    logging.info("Exp comment = {}".format(args.comment))

    from .runners.diffusion_runner import Diffusion

    try:
        runner = Diffusion(args, config, device=device)
        logging.info("Using device: {}".format(runner.device))
        if args.sample:
            runner.sample()
        elif args.test:
            runner.test()
        else:
            runner.train()
    except Exception:
        logging.error(traceback.format_exc())
        return 1
    return 0
