"""Train and evaluate disentangled VAEs with PyTorch on a CUDA GPU.

`python -m disvae_tpu_torch <name> ...`: the parser and flags of
disvae_tpu/cli.py (option groups, experiment names, the `-x` INI layering
Common_<dataset> -> Common_<loss> -> [<loss>_<dataset>] over the defaults
of disvae_tpu/hyperparam.ini; a named experiment's INI values win over
explicit flags, e.g. `-x btcvae_celeba` trains 200 epochs whatever `-e`
says) and both branches:

* training (without `--is-eval-only`): a fresh (or, with `--resume`,
  reused) `results/<name>/`, a seeded loader and init, the Trainer
  (train_losses.log, model-<e>.pt, train_state.pt and, unless
  `--no-viz-gif`, training.gif with one prior-traversal frame per epoch),
  then `model.pt` and `specs.json` with every resolved flag;
* evaluation: `test_losses.log` and, with `--is-metrics`, `metrics.log` +
  `metric_helpers.pth` (`--fast-metrics`: the bf16 entropy estimator).
  The metrics encode reuses the training run's device-resident upload
  when both cover the same images; otherwise it streams, unless
  `--resident-data always` uploads the dataset for it.

Data parallelism: `torchrun --nproc_per_node N -m disvae_tpu_torch
<name> ...` runs one rank per GPU (`cuda:LOCAL_RANK`, NCCL; gloo with
`--no-cuda`). Whenever a process group is up and `--no-mesh` is not
given, world size 1 included, the run is data-parallel: `-b` is the
global batch and each rank feeds its B/W rows (a host-sliced loader), the
steps compute the loss at the global batch (parallel/mesh.py), the eval
splits its encode and entropy sweeps over the ranks, and rank 0 alone
writes `results/<name>/`. `--model-parallel M` lays the W ranks out as W/M
data ranks of M model ranks each: the ranks of one model group feed the
same B/(W/M) rows and hold the FactorVAE discriminator column-parallel
(tensor parallelism; `train_state.pt` keeps it whole, so `--resume` works
at any M). W must divide by M, and M > 1 without a process group raises
ValueError. At M = 1 the discriminator stays replicated, as in the JAX
CLI.

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
import torch.distributed as dist

from disvae_tpu_torch.data.datasets import (DATASETS, get_dataloaders,
                                            get_img_size)
from disvae_tpu_torch.models.vae import (MODELS, derived_latent_dim,
                                         init_specific_model)
from disvae_tpu_torch.ops.losses import LOSSES, RECON_DIST, get_loss_f
from disvae_tpu_torch.ops.precision import PRECISIONS, configure
from disvae_tpu_torch.parallel import distributed
from disvae_tpu_torch.parallel.distributed import barrier, is_writer
from disvae_tpu_torch.parallel.mesh import create_mesh
from disvae_tpu_torch.train.evaluate import Evaluator
from disvae_tpu_torch.train.trainer import Trainer
from disvae_tpu_torch.utils.helpers import (FormatterNoDuplicate,
                                            create_safe_directory,
                                            derive_seeds, get_config_section,
                                            get_device, get_n_param, set_seed,
                                            update_namespace_)
from disvae_tpu_torch.utils.modelIO import (load_metadata, load_model,
                                            save_model)
from disvae_tpu_torch.utils.visualize import GifTraversalsTraining

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
                              'off), high (TF32), default (JAX\'s TPU '
                              'default: bf16-rounded operands, float32 '
                              'sums and activations).')
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
                         help='Ranks per tensor-parallel group (the '
                              'mesh\'s "model" axis; FactorVAE '
                              'discriminator only). The world size must '
                              'divide by it.')
    general.add_argument('--no-mesh', action='store_true', default=False,
                         help='Train single-device even under a process '
                              'group of one rank (data parallelism over '
                              'every rank is otherwise the default).')
    general.add_argument('--resident-data', default='auto',
                         choices=['auto', 'always', 'never'],
                         help='Device-resident feed: "auto" trains from '
                              'an upload when the wire-format dataset fits '
                              'the budget and lets the metrics encode reuse '
                              'it, "always" uploads for training and for an '
                              'eval-only encode, "never" streams batches.')
    general.add_argument('--no-viz-gif', action='store_true', default=False,
                         help='Skip the per-epoch traversal gif '
                              '(results/<name>/training.gif).')

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
    # None until the experiment's layers are read: AutoencoderKL derives it
    model.add_argument('-z', '--latent-dim', type=int, default=None,
                       help='Size of the latent code z (default {}; '
                            'AutoencoderKL: 4 * H/8 * W/8 of the dataset\'s '
                            'images, and no other).'.format(
                                default_config['latent_dim']))
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
                            help='Approximate bf16 entropy estimator for '
                                 'exploratory sweeps (about 2e-2 absolute '
                                 'log-density error; not for parity gates).')

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
    derived = derived_latent_dim(args.model_type,
                                 get_img_size(args.dataset))
    if args.latent_dim is None:
        args.latent_dim = (default_config['latent_dim'] if derived is None
                           else derived)
    elif derived is not None and args.latent_dim != derived:
        parser.error("{} on {} takes latent dimension {}, not {}".format(
            args.model_type, args.dataset, derived, args.latent_dim))
    return args


def build_trainer(args, device, exp_dir, seeds, mesh=None, model=None):
    """The training loader and Trainer of a run of `args` (FactorVAE's
    batch and epoch doubling is applied to `args`): `model` is trained when
    given, else the init drawn from `seeds` = (init seed, train seed).
    Returns (train_loader, trainer)."""
    logger = logging.getLogger(__name__)  # `main` sets its level and handler
    init_seed, train_seed = seeds
    if args.loss == "factor":
        logger.info("FactorVAE consumes two half-batches per iteration; "
                    "doubling batch size and epoch count so each epoch "
                    "sees the dataset the same number of times.")
        args.batch_size *= 2
        args.epochs *= 2

    # each rank feeds only its share of every global batch; the
    # (seed, epoch)-keyed permutation is the same on every rank
    host_slice = pad_global_to = None
    if mesh is not None:
        host_slice = (mesh.data_rank, mesh.data_size)
        pad_global_to = mesh.data_size
    train_loader = get_dataloaders(args.dataset,
                                   batch_size=args.batch_size,
                                   logger=logger, seed=args.seed,
                                   host_slice=host_slice,
                                   pad_global_to=pad_global_to)
    logger.info("Train {} with {} samples".format(
        args.dataset, len(train_loader.dataset)))

    args.img_size = get_img_size(args.dataset)
    if model is None:
        model = init_specific_model(
            args.model_type, args.img_size, args.latent_dim,
            generator=torch.Generator().manual_seed(init_seed),
            device=device)
    logger.info('Num parameters in model: {}'.format(get_n_param(model)))
    # The writer rank renders the training gif. Every rank holds a full
    # replica of the model on its own GPU, so the frame is a local
    # computation: JAX's _LocalDeviceGif, which re-homes mesh-committed
    # params onto one device, has no counterpart here.
    gif_visualizer = None
    if is_writer() and not args.no_viz_gif:
        gif_visualizer = GifTraversalsTraining(model, args.dataset,
                                               exp_dir)
    loss_f = get_loss_f(args.loss,
                        n_data=len(train_loader.dataset),
                        device=device,
                        **vars(args))
    trainer = Trainer(model, loss_f, lr=args.lr,
                      seed=train_seed,
                      logger=logger,
                      save_dir=exp_dir,
                      is_progress_bar=not args.no_progress_bar,
                      gif_visualizer=gif_visualizer,
                      resident=args.resident_data,
                      resume=args.resume,
                      skip_tiny_tail=True,
                      mesh=mesh)
    return train_loader, trainer


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

    # The process group first: it picks this rank's GPU. Data parallelism
    # is the default whenever a group is up, world size 1 included, so
    # `torchrun --nproc_per_node 1` runs every collective of the path.
    distributed.initialize(cuda=not args.no_cuda)
    mesh = None
    if args.no_mesh:
        if dist.is_initialized() and dist.get_world_size() > 1:
            # without the mesh there are no collectives: each rank would
            # silently train its own model on its own rows
            raise ValueError("--no-mesh is not valid on a multi-rank run: "
                             "host-sliced feeding only makes sense as the "
                             "feed of a data-parallel mesh.")
    elif dist.is_initialized() or args.model_parallel > 1:
        # without a group, model_parallel > 1 raises JAX's ValueError (one
        # device does not divide by it)
        mesh = create_mesh(model_parallel=args.model_parallel)
        logger.info("Data-parallel mesh: rank {} of {} (backend {})"
                    .format(mesh.rank, mesh.size, dist.get_backend()))
        if mesh.model_size > 1:
            logger.info("Tensor-parallel discriminator: {} data x {} model "
                        "ranks; this rank is data {} model {}".format(
                            mesh.data_size, mesh.model_size,
                            mesh.data_rank, mesh.model_rank))
        if args.seed is None:
                # every rank must draw the same init, noise and shuffles
                seed = [int(time.time()) & 0x7FFFFFFF]
                dist.broadcast_object_list(seed, src=0)
                args.seed = seed[0]

    configure(args.precision)
    device = get_device(args.no_cuda)
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
        # rank 0 owns the results dir (archive then create happens once);
        # the other ranks wait until it exists
        if is_writer():
            if args.resume:
                os.makedirs(exp_dir, exist_ok=True)
            else:
                create_safe_directory(exp_dir, logger=logger)
        barrier("disvae:results-dir")

        train_loader, trainer = build_trainer(
            args, device, exp_dir, (init_seed, train_seed), mesh=mesh)
        if args.profile and is_writer():
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
        if is_writer():
            save_model(trainer.model, exp_dir, metadata=vars(args))
        barrier("disvae:model-saved")

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
        # The metrics encode reuses the training run's resident upload when
        # the eval loader covers the same image set (the wire bytes are a
        # function of the dataset class, its root and its images).
        eval_resident = args.resident_data
        if (trainer is not None and trainer.resident_data is not None
                and type(test_loader.dataset) is type(train_loader.dataset)
                and len(test_loader.dataset) == len(train_loader.dataset)
                and getattr(test_loader.dataset, "root", None)
                == getattr(train_loader.dataset, "root", None)):
            logger.info("Evaluator reuses the training run's resident "
                        "dataset upload.")
            eval_resident = trainer.resident_data
        evaluator = Evaluator(model, loss_f,
                              logger=logger,
                              save_dir=exp_dir,
                              scramble_quirk=not args.corrected_mig,
                              metrics_seed=metrics_seed,
                              fast_entropies=args.fast_metrics,
                              resident=eval_resident,
                              mesh=mesh)
        evaluator(test_loader, is_metrics=args.is_metrics,
                  is_losses=not args.no_test)

    # no rank exits while another still has collective work in flight
    barrier("disvae:end")
    return trainer, evaluator


def cli():
    """Body of `python -m disvae_tpu_torch` (and of each torchrun rank)."""
    try:
        main(parse_arguments(sys.argv[1:]))
    finally:
        distributed.shutdown()


if __name__ == '__main__':
    cli()
