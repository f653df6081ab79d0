"""Render plots from a trained `results/<name>/` directory with PyTorch.

    python -m disvae_tpu_torch.cli_viz <name> all [--is-posterior]
        [--is-show-loss] [-s SEED] [--no-cuda]

Counterpart of disvae_tpu/cli_viz.py: the same flags, plot names and
dispatch, plus `--no-cuda`. It reads the port's `model.pt` or the JAX
package's `model.npz` (utils/modelIO.py) and writes PNG and GIF files
itself (utils/viz_helpers.py: no PIL, imageio or pandas). The device is
CUDA unless `--no-cuda` asks for the CPU; without a GPU and without
`--no-cuda` it raises. Plots render under the `highest` precision policy,
which makes cuDNN's transposed convs deterministic.
"""

import argparse
import os
import sys
from timeit import default_timer

from disvae_tpu_torch.cli import RES_DIR
from disvae_tpu_torch.ops.precision import configure
from disvae_tpu_torch.utils.helpers import (FormatterNoDuplicate,
                                            check_bounds, get_device,
                                            set_seed)
from disvae_tpu_torch.utils.modelIO import load_metadata, load_model
from disvae_tpu_torch.utils.visualize import Visualizer
from disvae_tpu_torch.utils.viz_helpers import get_samples

PLOT_TYPES = ['generate-samples', 'data-samples', 'reconstruct', "traversals",
              'reconstruct-traverse', "gif-traversals", "all"]


def parse_arguments(args_to_parse):
    description = "CLI for plotting using pretrained models of `disvae`"
    parser = argparse.ArgumentParser(description=description,
                                     formatter_class=FormatterNoDuplicate)

    parser.add_argument('name', type=str,
                        help="Run whose results/<name>/ directory holds the trained model.")
    parser.add_argument("plots", type=str, nargs='+', choices=PLOT_TYPES,
                        help="Plots to render. `generate-samples`: decode "
                             "draws from the prior. `data-samples`: show raw "
                             "dataset images. `reconstruct`: originals on the "
                             "top half, their reconstructions below. "
                             "`traversals`: one row per (KL-ranked) latent "
                             "dimension, swept across ncols values. "
                             "`reconstruct-traverse`: originals, then "
                             "reconstructions, then the traversal rows. "
                             "`gif-traversals`: animated per-image posterior "
                             "sweeps arranged in a grid. `all`: everything.")
    parser.add_argument('-s', '--seed', type=int, default=None,
                        help='Base PRNG seed; `None` draws from the clock.')
    parser.add_argument('-r', '--n-rows', type=int, default=6,
                        help='Grid rows (where the plot is a grid).')
    parser.add_argument('-c', '--n-cols', type=int, default=7,
                        help='Grid columns (where the plot is a grid).')
    parser.add_argument('-t', '--max-traversal', default=2,
                        type=lambda v: check_bounds(v, lb=0, is_inclusive=False,
                                                    type=float,
                                                    name="max-traversal"),
                        help='Half-width of each (symmetric) latent sweep: an '
                             'absolute offset when >= 0.5, otherwise a '
                             'Gaussian quantile.')
    parser.add_argument('-i', '--idcs', type=int, nargs='+', default=[],
                        help='Dataset indices pinned to the front of the '
                             'sample batch.')
    parser.add_argument('-u', '--upsample-factor', default=1,
                        type=lambda v: check_bounds(v, lb=1, is_inclusive=True,
                                                    type=int,
                                                    name="upsample-factor"),
                        help='Integer pixel-replication factor applied before '
                             'grid assembly.')
    parser.add_argument('--is-show-loss', action='store_true',
                        help='Annotate rows with their per-dimension KL.')
    parser.add_argument('--is-posterior', action='store_true',
                        help='Sweep around an encoded image instead of the prior mean.')
    parser.add_argument('--no-cuda', action='store_true',
                        help='Render on the CPU. Without it a CUDA device is '
                             'required.')
    return parser.parse_args(args_to_parse)


def main(args):
    """Render the plots. Returns {plot type: seconds}, each from the start
    of its render to its file written."""
    device = get_device(args.no_cuda)
    configure("highest")
    set_seed(args.seed)
    model_dir = os.path.join(RES_DIR, args.name)
    meta_data = load_metadata(model_dir)
    model = load_model(model_dir, device=device)
    dataset = meta_data['dataset']
    viz = Visualizer(model=model,
                     model_dir=model_dir,
                     dataset=dataset,
                     max_traversal=args.max_traversal,
                     loss_of_interest='kl_loss_',
                     upsample_factor=args.upsample_factor)
    size = (args.n_rows, args.n_cols)
    num_samples = args.n_cols * args.n_rows
    samples = get_samples(dataset, num_samples, idcs=args.idcs)

    plots = args.plots
    if "all" in plots:
        plots = [p for p in PLOT_TYPES if p != "all"]

    # one thunk per plot type (traversals takes ONE image, and only in
    # posterior mode)
    dispatch = {
        'generate-samples': lambda: viz.generate_samples(size=size),
        'data-samples': lambda: viz.data_samples(samples, size=size),
        'reconstruct': lambda: viz.reconstruct(samples, size=size),
        'traversals': lambda: viz.traversals(
            data=samples[0:1] if args.is_posterior else None,
            n_per_latent=args.n_cols, n_latents=args.n_rows,
            is_reorder_latents=True),
        'reconstruct-traverse': lambda: viz.reconstruct_traverse(
            samples, is_posterior=args.is_posterior, n_latents=args.n_rows,
            n_per_latent=args.n_cols, is_show_text=args.is_show_loss),
        'gif-traversals': lambda: viz.gif_traversals(
            samples[:args.n_cols], n_latents=args.n_rows),
    }
    seconds = {}
    for plot_type in plots:
        t0 = default_timer()
        dispatch[plot_type]()
        seconds[plot_type] = default_timer() - t0
    return seconds


def cli():
    """Body of `python -m disvae_tpu_torch.cli_viz`."""
    main(parse_arguments(sys.argv[1:]))


if __name__ == '__main__':
    cli()
