"""Train and evaluate disentangled VAEs with PyTorch on a CUDA GPU.

`python -m disvae_tpu_torch <name> ...`: the parser and flags of
disvae_tpu/cli.py (option groups, experiment names, the `-x` INI layering
Common_<dataset> -> Common_<loss> -> [<loss>_<dataset>] over the defaults
of disvae_tpu/hyperparam.ini; a named experiment's INI values win over
explicit flags, e.g. `-x btcvae_celeba` trains 200 epochs whatever `-e`
says) and both branches:

* training (without `--is-eval-only`): a fresh (or, with `--resume`,
  reused) `results/<name>/`, a seeded loader and init, the Trainer
  (train_losses.log, model-<e>.pt, train_state.pt), then `model.pt` and
  `specs.json` with every resolved flag;
* evaluation: `test_losses.log` and, with `--is-metrics`, `metrics.log` +
  `metric_helpers.pth`.

The flags whose paths wait for later slices raise NotImplementedError
naming ROADMAP.md: `--fast-metrics`, `--model-parallel` > 1, and training
without `--no-viz-gif` (the per-epoch gif needs the visualization slice).

The device is CUDA unless `--no-cuda` asks for the CPU; without a GPU
and without `--no-cuda` the CLI raises rather than run on the CPU. The
init, the training noise and the MIG/AAM sample draws are seeded from
`--seed` (the JAX CLI splits a PRNG key instead, so the two CLIs draw
different numbers from one seed).
"""

import argparse
import logging
import os
import sys
import time

import torch

from disvae_tpu_torch.data.datasets import (DATASETS, get_dataloaders,
                                            get_img_size)
from disvae_tpu_torch.models.vae import MODELS, init_specific_model
from disvae_tpu_torch.ops.losses import LOSSES, RECON_DIST, get_loss_f
from disvae_tpu_torch.ops.precision import PRECISIONS, configure
from disvae_tpu_torch.train.evaluate import Evaluator
from disvae_tpu_torch.train.trainer import Trainer
from disvae_tpu_torch.utils.helpers import (FormatterNoDuplicate,
                                            create_safe_directory,
                                            derive_seeds, get_config_section,
                                            get_n_param, set_seed,
                                            update_namespace_)
from disvae_tpu_torch.utils.modelIO import (load_metadata, load_model,
                                            save_model)

# The experiment config is the JAX package's file, read (not imported).
CONFIG_FILE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "disvae_tpu", "hyperparam.ini")
RES_DIR = "results"
LOG_LEVELS = ["CRITICAL", "ERROR", "WARNING", "INFO", "DEBUG", "NOTSET"]
ADDITIONAL_EXP = ["custom", "debug", "best_celeba", "best_dsprites"]
EXPERIMENTS = ADDITIONAL_EXP + ["{}_{}".format(loss, data)
                                for loss in LOSSES
                                for data in DATASETS]
_GIF = ("The per-epoch training gif is not ported yet (ROADMAP.md, Queue 2: "
        "visualization); train with --no-viz-gif.")


def parse_arguments(args_to_parse):
    """Parse CLI arguments, then overlay the chosen experiment's INI layers."""
    default_config = get_config_section([CONFIG_FILE], "Custom")

    description = ("PyTorch/CUDA implementation and evaluation of "
                   "disentangled Variational AutoEncoders and metrics.")
    parser = argparse.ArgumentParser(description=description,
                                     formatter_class=FormatterNoDuplicate)

    general = parser.add_argument_group('General options')
    general.add_argument('name', type=str,
                         help="Run name; artifacts are read from and written to results/<name>/.")
    general.add_argument('-L', '--log-level', help="Verbosity of the stderr logger.",
                         default=default_config['log_level'],
                         choices=[l.lower() for l in LOG_LEVELS] + LOG_LEVELS)
    general.add_argument('--no-progress-bar', action='store_true',
                         default=default_config['no_progress_bar'],
                         help='Turn off the progress bar.')
    general.add_argument('--no-cuda', action='store_true',
                         default=default_config['no_cuda'],
                         help='Run on the CPU. Without it a CUDA device is '
                              'required.')
    general.add_argument('-s', '--seed', type=int,
                         default=default_config['seed'],
                         help='Base seed; set `seed = None` in '
                              'hyperparam.ini to draw one from the clock.')
    general.add_argument('--precision', default="highest",
                         choices=PRECISIONS,
                         help='float32 matmul/conv policy: highest (TF32 '
                              'off), high (TF32), default (bf16 autocast).')
    general.add_argument('--resume', action='store_true', default=False,
                         help='Resume training from results/<name>/'
                              'train_state.pt.')
    general.add_argument('--profile', action='store_true', default=False,
                         help='Write a torch.profiler chrome trace of the '
                              'training run to results/<name>/profile/.')
    general.add_argument('--debug-nans', action='store_true', default=False,
                         help='Error out on the first NaN in a backward '
                              '(autograd anomaly detection).')
    general.add_argument('--model-parallel', type=int, default=1,
                         help='Devices per tensor-parallel group (not '
                              'ported yet; only 1 is accepted).')
    general.add_argument('--no-mesh', action='store_true', default=False,
                         help='Run single-device (the port always does).')
    general.add_argument('--resident-data', default='auto',
                         choices=['auto', 'always', 'never'],
                         help='Device-resident training feed: "auto" '
                              'when the wire-format dataset fits the '
                              'budget, "always", or "never" (stream '
                              'batches). Evaluation streams.')
    general.add_argument('--no-viz-gif', action='store_true', default=False,
                         help='Skip the per-epoch traversal gif (not '
                              'ported yet: training requires this flag).')

    training = parser.add_argument_group('Training specific options')
    training.add_argument('--checkpoint-every', type=int,
                          default=default_config['checkpoint_every'],
                          help='Epoch interval between model-<i> snapshots.')
    training.add_argument('-d', '--dataset',
                          default=default_config['dataset'], choices=DATASETS,
                          help="Which registered dataset to train on.")
    training.add_argument('-x', '--experiment',
                          default=default_config['experiment'],
                          choices=EXPERIMENTS,
                          help='Named experiment whose INI sections overlay the '
                               'other flags (anything but `custom` wins).')
    training.add_argument('-e', '--epochs', type=int,
                          default=default_config['epochs'],
                          help='How many passes over the training set.')
    training.add_argument('-b', '--batch-size', type=int,
                          default=default_config['batch_size'],
                          help='Images per optimizer step.')
    training.add_argument('--lr', type=float, default=default_config['lr'],
                          help='Adam step size for the VAE parameters.')

    model = parser.add_argument_group('Model specific options')
    model.add_argument('-m', '--model-type',
                       default=default_config['model'], choices=MODELS,
                       help='Architecture family for the encoder/decoder pair.')
    model.add_argument('-z', '--latent-dim', type=int,
                       default=default_config['latent_dim'],
                       help='Size of the latent code z.')
    model.add_argument('-l', '--loss',
                       default=default_config['loss'], choices=LOSSES,
                       help="Objective used to train the VAE.")
    model.add_argument('-r', '--rec-dist',
                       default=default_config['rec_dist'], choices=RECON_DIST,
                       help="Per-pixel reconstruction likelihood family.")
    model.add_argument('-a', '--reg-anneal', type=float,
                       default=default_config['reg_anneal'],
                       help="Steps over which the regularizer weight ramps "
                            "linearly from 0 to its final value.")

    betaH = parser.add_argument_group('BetaH specific parameters')
    betaH.add_argument('--betaH-B', type=float,
                       default=default_config['betaH_B'],
                       help="KL coefficient (the Higgins et al. beta).")

    betaB = parser.add_argument_group('BetaB specific parameters')
    betaB.add_argument('--betaB-initC', type=float,
                       default=default_config['betaB_initC'],
                       help="Capacity C at step 0.")
    betaB.add_argument('--betaB-finC', type=float,
                       default=default_config['betaB_finC'],
                       help="Capacity C after annealing completes.")
    betaB.add_argument('--betaB-G', type=float,
                       default=default_config['betaB_G'],
                       help="Coefficient on |KL - C| (the Burgess et al. gamma).")

    factor = parser.add_argument_group('factor VAE specific parameters')
    factor.add_argument('--factor-G', type=float,
                        default=default_config['factor_G'],
                        help="Coefficient on the adversarial TC estimate (Kim & Mnih gamma).")
    factor.add_argument('--lr-disc', type=float,
                        default=default_config['lr_disc'],
                        help='Adam step size for the FactorVAE discriminator.')

    btcvae = parser.add_argument_group('beta-tcvae specific parameters')
    btcvae.add_argument('--btcvae-A', type=float,
                        default=default_config['btcvae_A'],
                        help="Coefficient on the index-code mutual information (Chen et al. alpha).")
    btcvae.add_argument('--btcvae-G', type=float,
                        default=default_config['btcvae_G'],
                        help="Coefficient on the dimension-wise KL (Chen et al. gamma).")
    btcvae.add_argument('--btcvae-B', type=float,
                        default=default_config['btcvae_B'],
                        help="Coefficient on the total correlation (Chen et al. beta).")

    evaluation = parser.add_argument_group('Evaluation specific options')
    evaluation.add_argument('--is-eval-only', action='store_true',
                            default=default_config['is_eval_only'],
                            help='Skip training; run evaluation on the saved model '
                                 'in results/<name>/.')
    evaluation.add_argument('--is-metrics', action='store_true',
                            default=default_config['is_metrics'],
                            help="Also compute MIG/AAM (needs ground-truth factors, "
                                 "i.e. dsprites).")
    evaluation.add_argument('--no-test', action='store_true',
                            default=default_config['no_test'],
                            help="Skip the test-loss pass.")
    evaluation.add_argument('--eval-batchsize', type=int,
                            default=default_config['eval_batchsize'],
                            help='Images per device call during evaluation.')
    evaluation.add_argument('--corrected-mig', action='store_true',
                            default=False,
                            help='Compute MIG/AAM with the mathematically '
                                 'correct sample handling instead of '
                                 'reproducing the reference estimator\'s '
                                 'sample-scrambling quirk (which dilutes '
                                 'MIG by more than 10x).')
    evaluation.add_argument('--fast-metrics', action='store_true',
                            default=False,
                            help='Approximate bf16 entropy estimator (not '
                                 'ported yet; raises).')

    args = parser.parse_args(args_to_parse)
    if args.experiment != 'custom':
        if args.experiment not in ADDITIONAL_EXP:
            # layering: Common_<dataset> then Common_<loss>
            loss, dataset = args.experiment.split("_")
            update_namespace_(args, get_config_section(
                [CONFIG_FILE], "Common_{}".format(dataset)))
            update_namespace_(args, get_config_section(
                [CONFIG_FILE], "Common_{}".format(loss)))
        try:
            update_namespace_(args, get_config_section([CONFIG_FILE],
                                                       args.experiment))
        except KeyError as e:
            if args.experiment in ADDITIONAL_EXP:
                raise e
    return args


def _device(args):
    if args.no_cuda:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("No CUDA device is visible; pass --no-cuda to "
                           "evaluate on the CPU.")
    return torch.device("cuda")


def main(args):
    """Run the CLI. Returns (trainer, evaluator): the Trainer that ran
    (None with --is-eval-only; its `epoch_stats` hold each epoch's mean
    loss and images/sec) and the Evaluator (None when neither test losses
    nor metrics were asked for; its `last_metrics_timings` hold the
    encode/entropy phase seconds)."""
    formatter = logging.Formatter(
        '%(asctime)s %(levelname)s - %(funcName)s: %(message)s', "%H:%M:%S")
    logger = logging.getLogger(__name__)
    logger.setLevel(args.log_level.upper())
    stream = logging.StreamHandler()
    stream.setLevel(args.log_level.upper())
    stream.setFormatter(formatter)
    logger.addHandler(stream)

    if not args.is_eval_only and not args.no_viz_gif:
        raise NotImplementedError(_GIF)
    if args.fast_metrics:
        raise NotImplementedError("--fast-metrics is not ported yet "
                                  "(ROADMAP.md, Queue 2).")
    if args.model_parallel != 1:
        raise NotImplementedError("--model-parallel is not ported yet "
                                  "(ROADMAP.md, Queue 2).")

    configure(args.precision)
    device = _device(args)
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    set_seed(args.seed)
    metrics_seed = (args.seed if args.seed is not None
                    else int(time.time()) & 0x7FFFFFFF)
    init_seed, train_seed = derive_seeds(args.seed, 2)

    exp_dir = os.path.join(RES_DIR, args.name)
    logger.info("Root directory for saving and loading experiments: {}"
                .format(exp_dir))

    trainer = evaluator = None
    if not args.is_eval_only:
        if args.resume:
            os.makedirs(exp_dir, exist_ok=True)
        else:
            create_safe_directory(exp_dir, logger=logger)

        if args.loss == "factor":
            logger.info("FactorVAE consumes two half-batches per iteration; "
                        "doubling batch size and epoch count so each epoch "
                        "sees the dataset the same number of times.")
            args.batch_size *= 2
            args.epochs *= 2

        train_loader = get_dataloaders(args.dataset,
                                       batch_size=args.batch_size,
                                       logger=logger, seed=args.seed)
        logger.info("Train {} with {} samples".format(
            args.dataset, len(train_loader.dataset)))

        args.img_size = get_img_size(args.dataset)
        model = init_specific_model(
            args.model_type, args.img_size, args.latent_dim,
            generator=torch.Generator().manual_seed(init_seed),
            device=device)
        logger.info('Num parameters in model: {}'.format(get_n_param(model)))
        loss_f = get_loss_f(args.loss,
                            n_data=len(train_loader.dataset),
                            device=device,
                            **vars(args))
        trainer = Trainer(model, loss_f, lr=args.lr,
                          seed=train_seed,
                          logger=logger,
                          save_dir=exp_dir,
                          is_progress_bar=not args.no_progress_bar,
                          resident=args.resident_data,
                          resume=args.resume,
                          skip_tiny_tail=True)
        if args.profile:
            profile_dir = os.path.join(exp_dir, "profile")
            os.makedirs(profile_dir, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=activities) as prof:
                trainer(train_loader,
                        epochs=args.epochs,
                        checkpoint_every=args.checkpoint_every)
            path = os.path.join(profile_dir, "trace.json")
            prof.export_chrome_trace(path)
            logger.info("Profiler trace written to {}".format(path))
        else:
            trainer(train_loader,
                    epochs=args.epochs,
                    checkpoint_every=args.checkpoint_every)

        # the final model plus the full resolved config
        save_model(trainer.model, exp_dir, metadata=vars(args))

    if args.is_metrics or not args.no_test:
        model = load_model(exp_dir, device=device)
        metadata = load_metadata(exp_dir)
        test_loader = get_dataloaders(metadata["dataset"],
                                      batch_size=args.eval_batchsize,
                                      shuffle=False,
                                      logger=logger)
        loss_f = get_loss_f(args.loss,
                            n_data=len(test_loader.dataset),
                            device=device,
                            **vars(args))
        evaluator = Evaluator(model, loss_f,
                              logger=logger,
                              save_dir=exp_dir,
                              scramble_quirk=not args.corrected_mig,
                              metrics_seed=metrics_seed)
        evaluator(test_loader, is_metrics=args.is_metrics,
                  is_losses=not args.no_test)
    return trainer, evaluator


def cli():
    """Body of `python -m disvae_tpu_torch`."""
    main(parse_arguments(sys.argv[1:]))


if __name__ == '__main__':
    cli()
