"""Latent-space visualization: samples, reconstructions, traversals, GIFs.

Counterpart of disvae_tpu/utils/visualize.py (`Visualizer`,
`GifTraversalsTraining`), with the same constructor arguments (the
`nn.Module` holds its own weights, so there is no `params`), methods,
filenames and geometry. Each plot is one batched decode on the model's
device and the posterior gif one encode plus one decode; encodes and
decodes run in eval mode under `torch.no_grad()`, leave the model in the
mode they found it in, and copy to the host once per plot. Under the
``default`` precision policy they run in the model's own bf16 autocast.

The prior draws of `generate_samples` come from a CPU `torch.Generator`
seeded with `np.random.randint(0, 2**31)`, the numpy draw the JAX
constructor makes, so both packages consume the numpy stream alike (the
draws themselves differ from `jax.random`). Traversal ranges (Gaussian
quantiles, `scipy.stats.norm.ppf`) are computed on the host.

Filenames are contract (read back by bin scripts and users):
samples.png, data_samples.png, reconstruct.png, prior_/posterior_
traversals.png, reconstruct_traverse.png, posterior_traversals.gif,
training.gif.
"""

import contextlib
import os

import numpy as np
import torch
from scipy import stats

from disvae_tpu_torch.data.datasets import get_background
from disvae_tpu_torch.utils.viz_helpers import (FPS_GIF, add_labels,
                                                concatenate_pad,
                                                make_grid_img, mimsave,
                                                read_loss_from_file,
                                                save_image,
                                                sort_list_by_other, write_png)

TRAIN_FILE = "train_losses.log"
GIF_FILE = "training.gif"
PLOT_NAMES = dict(generate_samples="samples.png",
                  data_samples="data_samples.png",
                  reconstruct="reconstruct.png",
                  traversals="traversals.png",
                  reconstruct_traverse="reconstruct_traverse.png",
                  gif_traversals="posterior_traversals.gif")


class Visualizer:
    """Renders plots for a trained VAE (an nn.Module on its device).

    `max_traversal` >= 0.5 is an absolute displacement, < 0.5 a quantile of
    the (prior or posterior) Gaussian; `loss_of_interest` orders latent rows
    by per-dimension KL read back from train_losses.log.
    """

    def __init__(self, model, dataset, model_dir,
                 save_images=True,
                 loss_of_interest=None,
                 display_loss_per_dim=False,
                 max_traversal=0.475,
                 upsample_factor=1):
        self.model = model
        self.latent_dim = model.latent_dim
        self.max_traversal = max_traversal
        self.save_images = save_images
        self.model_dir = model_dir
        self.dataset = dataset
        self.upsample_factor = int(upsample_factor)
        self.losses = None
        if loss_of_interest is not None:
            self.losses = read_loss_from_file(
                os.path.join(model_dir, TRAIN_FILE), loss_of_interest)
        self._prior_gen = torch.Generator().manual_seed(
            int(np.random.randint(0, 2 ** 31)))

    @contextlib.contextmanager
    def _eval(self):
        """Eval mode and no_grad on the model; yields its device and puts
        the model back in the mode it was in."""
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                yield next(self.model.parameters()).device
        finally:
            self.model.train(was_training)

    def _get_traversal_range(self, mean=0, std=1):
        """Symmetric (-x, x) traversal range, absolute or quantile-based."""
        max_traversal = self.max_traversal
        if max_traversal < 0.5:
            max_traversal = (1 - 2 * max_traversal) / 2
            max_traversal = stats.norm.ppf(max_traversal, loc=mean, scale=std)
        return (-1 * max_traversal, max_traversal)

    def _posterior_stats(self, data):
        """Encode a batch; (mean, logvar) on the host, one copy."""
        with self._eval() as device:
            mean, logvar = self.model.encode(
                torch.tensor(np.asarray(data, np.float32), device=device))
            out = torch.cat([mean, logvar], dim=-1).cpu().numpy()
        return out[:, :self.latent_dim], out[:, self.latent_dim:]

    def _traverse_line(self, idx, n_samples, stats=None):
        """(n_samples, latent_dim) latents traversing dimension `idx`.
        `stats` is a host-side (mean_row, logvar_row) pair for posterior
        traversals, None for prior."""
        if stats is None:
            samples = np.zeros((n_samples, self.latent_dim), np.float32)
            traversals = np.linspace(*self._get_traversal_range(),
                                     num=n_samples)
        else:
            post_mean, post_logvar = stats
            # viz runs the model in eval mode: latent = posterior mean
            samples = np.tile(post_mean, (n_samples, 1))
            mean_idx = float(post_mean[idx])
            std_idx = float(np.exp(post_logvar[idx] / 2))
            traversals = np.linspace(
                *self._get_traversal_range(mean=mean_idx, std=std_idx),
                num=n_samples)
        samples[:, idx] = traversals
        return samples

    def _upsample(self, imgs):
        if self.upsample_factor == 1:
            return imgs
        k = self.upsample_factor
        return np.repeat(np.repeat(imgs, k, axis=1), k, axis=2)

    def _save_or_return(self, to_plot, size, filename,
                        is_force_return=False):
        """Grid-assemble; save to PNG or return the uint8 HWC array."""
        to_plot = self._upsample(np.asarray(to_plot))
        if size[0] * size[1] != to_plot.shape[0]:
            raise ValueError("Wrong size {} for datashape {}".format(
                size, to_plot.shape))
        kwargs = dict(nrow=size[1],
                      pad_value=(1 - get_background(self.dataset)))
        if self.save_images and not is_force_return:
            save_image(to_plot, os.path.join(self.model_dir, filename),
                       **kwargs)
        else:
            return make_grid_img(to_plot, **kwargs)

    def _decode_latents(self, latent_samples):
        with self._eval() as device:
            return self.model.decode(torch.tensor(
                np.asarray(latent_samples, np.float32),
                device=device)).cpu().numpy()

    def generate_samples(self, size=(8, 8)):
        """Decode random prior samples."""
        prior_samples = torch.randn((size[0] * size[1], self.latent_dim),
                                    generator=self._prior_gen)
        generated = self._decode_latents(prior_samples.numpy())
        return self._save_or_return(generated, size,
                                    PLOT_NAMES["generate_samples"])

    def data_samples(self, data, size=(8, 8)):
        """Plot dataset samples."""
        data = np.asarray(data)[:size[0] * size[1]]
        return self._save_or_return(data, size, PLOT_NAMES["data_samples"])

    def reconstruct(self, data, size=(8, 8), is_original=True,
                    is_force_return=False):
        """Top half originals, bottom half reconstructions (eval forward:
        z = posterior mean)."""
        if is_original:
            if size[0] % 2 != 0:
                raise ValueError("Should be even number of rows when showing "
                                 "originals not {}".format(size[0]))
            n_samples = size[0] // 2 * size[1]
        else:
            n_samples = size[0] * size[1]
        originals = np.asarray(data)[:n_samples]
        with self._eval() as device:
            recs, _, _ = self.model(torch.tensor(
                np.asarray(originals, np.float32), device=device))
            recs = recs.cpu().numpy()
        to_plot = (np.concatenate([originals, recs]) if is_original else recs)
        return self._save_or_return(to_plot, size, PLOT_NAMES["reconstruct"],
                                    is_force_return=is_force_return)

    def _traversal_latents(self, stats, n_per_latent):
        """(latent_dim * n_per_latent, latent_dim) traversal latents for one
        image's posterior stats (or the prior when stats is None)."""
        return np.concatenate([self._traverse_line(dim, n_per_latent,
                                                   stats=stats)
                               for dim in range(self.latent_dim)], axis=0)

    def _arrange_traversal(self, decoded, n_per_latent, n_latents,
                           is_reorder_latents):
        if is_reorder_latents:
            n_images, *other_shape = decoded.shape
            n_rows = n_images // n_per_latent
            decoded = decoded.reshape(n_rows, n_per_latent, *other_shape)
            decoded = np.stack(sort_list_by_other(list(decoded), self.losses))
            decoded = decoded.reshape(n_images, *other_shape)
        return decoded[:n_per_latent * n_latents]

    def traversals(self, data=None, is_reorder_latents=False, n_per_latent=8,
                   n_latents=None, is_force_return=False):
        """Rows = latent dimensions (optionally KL-ordered), columns = a
        traversal of that dimension; one batched decode."""
        n_latents = n_latents if n_latents is not None else self.latent_dim
        stats = None
        if data is not None:
            if data.shape[0] > 1:
                raise ValueError("Every value should be sampled from the same "
                                 "posterior, but {} datapoints given."
                                 .format(data.shape[0]))
            mean, logvar = self._posterior_stats(data)
            stats = (mean[0], logvar[0])
        decoded = self._decode_latents(
            self._traversal_latents(stats, n_per_latent))
        decoded = self._arrange_traversal(decoded, n_per_latent, n_latents,
                                          is_reorder_latents)
        size = (n_latents, n_per_latent)
        sampling_type = "prior" if data is None else "posterior"
        filename = "{}_{}".format(sampling_type, PLOT_NAMES["traversals"])
        return self._save_or_return(decoded, size, filename,
                                    is_force_return=is_force_return)

    def reconstruct_traverse(self, data, is_posterior=True, n_per_latent=8,
                             n_latents=None, is_show_text=False):
        """First row originals, second reconstructions, then KL-sorted
        traversals."""
        n_latents = n_latents if n_latents is not None else self.latent_dim
        reconstructions = self.reconstruct(data[:2 * n_per_latent],
                                           size=(2, n_per_latent),
                                           is_force_return=True)
        traversals = self.traversals(
            data=data[0:1] if is_posterior else None,
            is_reorder_latents=True,
            n_per_latent=n_per_latent,
            n_latents=n_latents,
            is_force_return=True)
        concatenated = np.concatenate((reconstructions, traversals), axis=0)
        if is_show_text:
            losses = sorted(self.losses, reverse=True)[:n_latents]
            labels = ["orig", "recon"] + ["KL={:.4f}".format(l)
                                          for l in losses]
            concatenated = add_labels(concatenated, labels)
        write_png(os.path.join(self.model_dir,
                               PLOT_NAMES["reconstruct_traverse"]),
                  concatenated)

    def gif_traversals(self, data, n_latents=None, n_per_gif=15):
        """Grid of animated posterior traversals: rows latent dims, columns
        images; frames sweep the traversal. Returns the frames as written
        (before the GIF palette)."""
        n_images, _, width_col, _ = data.shape
        width_col = int(width_col * self.upsample_factor)
        n_latents = n_latents if n_latents is not None else self.latent_dim

        # one encode over all images and one decode over every frame's
        # latents (n_images * latent_dim * n_per_gif)
        means, logvars = self._posterior_stats(data)
        per_img = self.latent_dim * n_per_gif
        latents = np.concatenate(
            [self._traversal_latents((means[i], logvars[i]), n_per_gif)
             for i in range(n_images)], axis=0)
        decoded_all = self._decode_latents(latents)

        all_cols = [[] for _ in range(n_per_gif)]
        for i in range(n_images):
            decoded = self._arrange_traversal(
                decoded_all[i * per_img:(i + 1) * per_img], n_per_gif,
                n_latents, is_reorder_latents=True)
            grid = self._save_or_return(decoded, (n_latents, n_per_gif),
                                        None, is_force_return=True)
            height, width, c = grid.shape
            padding_width = (width - width_col * n_per_gif) // (n_per_gif + 1)
            for j in range(n_per_gif):
                base = (j + 1) * padding_width + j * width_col
                all_cols[j].append(grid[:, base:base + width_col, :])

        pad_values = (1 - get_background(self.dataset)) * 255
        all_cols = [concatenate_pad(cols, pad_size=2, pad_values=pad_values,
                                    axis=1) for cols in all_cols]
        mimsave(os.path.join(self.model_dir, PLOT_NAMES["gif_traversals"]),
                all_cols, fps=FPS_GIF)
        return all_cols


class GifTraversalsTraining:
    """Collects one prior-traversal frame per epoch and writes training.gif
    at the end. Called by the Trainer with the model after each epoch; the
    frame leaves the model's mode, weights and generators as it found
    them."""

    def __init__(self, model, dataset, model_dir, is_reorder_latents=False,
                 n_per_latent=10, n_latents=None, **kwargs):
        self.save_filename = os.path.join(model_dir, GIF_FILE)
        self.visualizer = Visualizer(model, dataset, model_dir,
                                     save_images=False, **kwargs)
        self.images = []
        self.is_reorder_latents = is_reorder_latents
        self.n_per_latent = n_per_latent
        self.n_latents = (n_latents if n_latents is not None
                          else model.latent_dim)

    def __call__(self, model):
        self.visualizer.model = model
        img_grid = self.visualizer.traversals(
            data=None,
            is_reorder_latents=self.is_reorder_latents,
            n_per_latent=self.n_per_latent,
            n_latents=self.n_latents)
        self.images.append(img_grid)

    def save_reset(self):
        if not self.images:
            return
        mimsave(self.save_filename, self.images, fps=FPS_GIF)
        self.images = []
