"""Evaluation: test losses and MIG / AAM disentanglement metrics.

Counterpart of disvae_tpu/train/evaluate.py (`Evaluator`, :61-529). The
entropy estimates run on the model's device: the full-dataset encode stays
there, and both entropy paths (the marginal H[z] and the per-factor
conditional H[z|v]) call `ops.log_qz.log_qz`, the hand-written CUDA kernel
on a GPU and its plain PyTorch version on the CPU.

Reference quirks kept, as in the JAX package:
* `compute_losses` returns inside the first batch iteration, so "test
  losses" are first-batch values divided by the number of batches.
* In eval mode latent "samples" are the posterior means.
* FactorVAE test losses use a freshly initialized discriminator.
* The entropy samples are reshaped (S, D) -> (D, S) without a transpose
  (`scramble_quirk=True`, the default); MIG only matches the reference
  with it. `scramble_quirk=False` takes the transpose.
* The sample draws come from `np.random.RandomState(metrics_seed)` in the
  JAX evaluator's order (marginal first, then each factor's slices), so
  equal seeds give equal draws in both packages.

The metrics encode reads the dataset from the device when it is resident
(`resident`, as the JAX evaluator's `_use_resident` / `_slice_resident`):
the wire-format images are on the device once (the Trainer's upload handed
in, or data/resident.py under "always") and each encode batch is a slice
of them, decompressed on the device as the streamed batches are, so the
results are bit-identical to streaming. Unlike the JAX evaluator, "auto"
builds no upload of its own: on the H100 a single eval's upload costs
more than the streamed feed it replaces (PERF.md), so only a handed-in
upload is worth reading. `fast_entropies` takes the bf16 estimator
`ops.log_qz.log_qz_fast` instead of `log_qz` (`--fast-metrics`).

Under a data-parallel mesh (`mesh`, disvae_tpu evaluate.py:130-186) the
metrics encode is split over the data axis, as JAX's `batch_sharding`
(P("data")) splits it: each data rank encodes its contiguous N/W rows
(the ranks of one model group the same rows) and the (N, D) mu and logvar
are all-gathered. Each entropy sweep's samples
are split too: every rank draws the same sample indices in the JAX
evaluator's order, evaluates its S/W of them against all M mixture
components, and one all-reduce per sweep sums the float64 (L, D)
partials. The first-batch test-loss pass is not split (every rank
computes the same numbers), and rank 0 alone writes the files.
"""

import logging
import math
import os
from timeit import default_timer

import numpy as np
import torch

from disvae_tpu_torch.data.resident import ResidentData, wire_shape
from disvae_tpu_torch.models.discriminator import Discriminator
from disvae_tpu_torch.ops.log_qz import log_qz, log_qz_fast
from disvae_tpu_torch.ops.losses import coef_vector
from disvae_tpu_torch.parallel.distributed import is_writer
from disvae_tpu_torch.parallel.mesh import all_reduce_sum, gather_rows
from disvae_tpu_torch.train.steps import _decompress_batch, make_eval_step
from disvae_tpu_torch.utils.modelIO import save_metadata

TEST_LOSSES_FILE = "test_losses.log"
METRICS_FILENAME = "metrics.log"
METRIC_HELPERS_FILE = "metric_helpers.pth"

# Sample chunk of one log_qz call, as in the JAX evaluator.
_SAMPLE_CHUNK = 2000


class Evaluator:
    """Evaluate a trained VAE (an nn.Module on its device) under a loss.

    `resident` is a prebuilt `ResidentData` of the same images (the
    Trainer's upload), "always" (upload the dataset for the metrics
    encode), or "auto", "never" or None (stream the batches).
    `fast_entropies` selects the bf16 entropy estimator. `mesh` splits
    the metrics encode and the entropy sweeps over its ranks.
    """

    def __init__(self, model, loss_f,
                 logger=logging.getLogger(__name__),
                 save_dir="results",
                 scramble_quirk=True,
                 metrics_seed=None,
                 fast_entropies=False,
                 resident="auto",
                 mesh=None):
        self.model = model.eval()
        self.mesh = mesh
        self.device = next(model.parameters()).device
        self.loss_f = loss_f
        self.logger = logger
        self.save_dir = save_dir
        self.scramble_quirk = scramble_quirk
        self.fast_entropies = fast_entropies
        if resident is None or isinstance(resident, str):
            if resident not in (None, "auto", "always", "never"):
                raise ValueError("resident: {!r}".format(resident))
            self._build_upload, self._prebuilt = resident == "always", None
        else:
            self._build_upload, self._prebuilt = False, resident
        self._resident = None
        self._resident_ds = None  # the dataset `_resident` holds
        self._np_rng = np.random.RandomState(
            0 if metrics_seed is None else metrics_seed)
        disc = None
        if loss_f.needs_discriminator:
            # FactorVAE test losses use a freshly initialized
            # discriminator: the reference rebuilds the loss for the eval
            # phase and never keeps the trained one (main.py:237-240)
            disc = Discriminator(latent_dim=loss_f.latent_dim,
                                 generator=torch.Generator().manual_seed(
                                     0 if metrics_seed is None
                                     else metrics_seed))
            disc = disc.to(self.device).eval()
        self._eval_step = make_eval_step(model, loss_f, disc=disc)
        self._loss_coefs = coef_vector(loss_f, device=self.device)
        self.logger.info("Testing Device: {}".format(self.device))

    def _to_device(self, batch):
        return torch.from_numpy(np.asarray(batch)).to(self.device)

    def _use_resident(self, dataloader):
        """Adopt the prebuilt upload, or build one under "always", for this
        loader. Only an unshuffled loader over a dataset with a wire format
        reads in the device order; an upload is keyed on the dataset's
        identity."""
        ds = getattr(dataloader, "dataset", None)
        if ds is None or getattr(dataloader, "shuffle", False) \
                or not hasattr(ds, "get_batch_raw"):
            return False
        if ds is self._resident_ds:
            return True
        if self._prebuilt is not None and self._resident_ds is None:
            # adopted for the first loader whose size and wire shape match;
            # the caller vouches for the images
            if self._prebuilt.n != len(ds):
                return False
            expected, got = wire_shape(ds), tuple(self._prebuilt.wire.shape)
            if got != expected:
                raise ValueError(
                    "Prebuilt resident upload has wire shape {} but this "
                    "loader's dataset would pack to {}: it was built from "
                    "another dataset or wire format.".format(got, expected))
            if self._prebuilt.wire.device != self.device:
                raise ValueError("Prebuilt resident upload is on {}, the "
                                 "model on {}".format(
                                     self._prebuilt.wire.device,
                                     self.device))
            self._resident, self._resident_ds = self._prebuilt, ds
            return True
        if not self._build_upload:
            return False
        self._resident = ResidentData.maybe(ds, self.device,
                                            limit_bytes=float("inf"))
        if self._resident is None:
            return False
        self._resident_ds = ds
        self.logger.info("Metrics encode: device-resident dataset feed (one "
                         "upload; batches are slices).")
        return True

    def __call__(self, data_loader, is_metrics=False, is_losses=True):
        start = default_timer()
        metrics, losses = None, None
        if is_metrics:
            self.logger.info("Computing metrics...")
            metrics = self.compute_metrics(data_loader)
            self.logger.info("Metrics: {}".format(metrics))
            if is_writer():
                save_metadata(metrics, self.save_dir,
                              filename=METRICS_FILENAME)
        if is_losses:
            self.logger.info("Computing losses...")
            losses = self.compute_losses(data_loader)
            self.logger.info("Losses: {}".format(losses))
            if is_writer():
                save_metadata(losses, self.save_dir,
                              filename=TEST_LOSSES_FILE)
        self.logger.info("Finished evaluating after {:.1f} min.".format(
            (default_timer() - start) / 60))
        return metrics, losses

    def compute_losses(self, dataloader):
        """Test losses: first-batch values / n_batches (reference quirk).
        An empty loader yields an empty dict."""
        n_batches = len(dataloader)
        for data, _ in dataloader:
            metrics = self._eval_step(self._to_device(data), self._loss_coefs)
            keys = sorted(metrics)
            vals = torch.stack([metrics[k] for k in keys]).cpu().numpy()
            return {k: float(v) / n_batches for k, v in zip(keys, vals)}
        self.logger.warning("compute_losses: empty data loader.")
        return {}

    # ------------------------------------------------------------------
    # MIG / AAM
    # ------------------------------------------------------------------

    def compute_metrics(self, dataloader):
        """MIG and AAM over a dataset with known factor structure."""
        lat_sizes = getattr(dataloader.dataset, "lat_sizes", None)
        lat_names = getattr(dataloader.dataset, "lat_names", None)
        if lat_sizes is not None:
            lat_sizes = np.asarray(lat_sizes)
        if lat_sizes is None or lat_names is None:
            raise ValueError(
                "Dataset needs to have known true factors of variations to "
                "compute the metric. This does not seem to be the case for "
                "{}".format(type(dataloader.dataset).__name__))
        if len(dataloader.dataset) != int(np.prod(lat_sizes)):
            raise ValueError(
                "{} holds {} images, not the {} of its factor lattice {}"
                .format(type(dataloader.dataset).__name__,
                        len(dataloader.dataset), int(np.prod(lat_sizes)),
                        lat_sizes.tolist()))

        self.logger.info("Computing the empirical distribution q(z|x).")
        t0 = default_timer()
        raw_before = getattr(dataloader, "raw", None)
        try:
            if raw_before is not None and hasattr(dataloader.dataset,
                                                  "get_batch_raw"):
                # full-dataset encode: ship wire-format batches (bitpacked
                # for binary datasets); the encode decompresses on device
                dataloader.raw = True
            samples_zCx, params_zCx = self._compute_q_zCx(dataloader)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        finally:
            if raw_before is not None:
                dataloader.raw = raw_before
        t_encode = default_timer() - t0

        self.logger.info("Estimating the marginal entropy.")
        t1 = default_timer()
        H_z = self._estimate_latent_entropies(samples_zCx, params_zCx)
        H_zCv = self._estimate_H_zCv(samples_zCx, params_zCx, lat_sizes,
                                     lat_names)
        t_entropy = default_timer() - t1
        # both entropy results are host numpy by here, so both phases end
        # synchronized with the device
        self.last_metrics_timings = {"encode_seconds": t_encode,
                                     "entropy_seconds": t_entropy,
                                     "total_seconds": default_timer() - t0}

        # I[z_j; v_k] = H[z_j] - H[z_j | v_k]
        mut_info = -H_zCv + H_z[None, :]
        sorted_mut_info = np.clip(np.sort(mut_info, axis=1)[:, ::-1], 0, None)

        metric_helpers = {"marginal_entropies": H_z, "cond_entropies": H_zCv}
        mig = self._mutual_information_gap(sorted_mut_info, lat_sizes,
                                           storer=metric_helpers)
        aam = self._axis_aligned_metric(sorted_mut_info,
                                        storer=metric_helpers)
        metrics = {"MIG": float(mig), "AAM": float(aam)}
        if is_writer():
            self._save_metric_helpers(metric_helpers)
        self.last_metrics_internals = metric_helpers
        return metrics

    def _save_metric_helpers(self, metric_helpers):
        """Persist intermediates as `metric_helpers.pth` (torch format, as
        the reference's tooling reads)."""
        torch.save({k: torch.as_tensor(np.asarray(v))
                    for k, v in metric_helpers.items()},
                   os.path.join(self.save_dir, METRIC_HELPERS_FILE))

    def _mutual_information_gap(self, sorted_mut_info, lat_sizes,
                                storer=None):
        """MIG = mean_k (I_1k - I_2k) / H(v_k), H(v_k) = log |V_k|."""
        delta = sorted_mut_info[:, 0] - sorted_mut_info[:, 1]
        H_v = np.log(lat_sizes.astype(np.float64))
        mig_k = delta / H_v
        mig = mig_k.mean()
        if storer is not None:
            storer["mig_k"] = mig_k
            storer["mig"] = mig
        return mig

    def _axis_aligned_metric(self, sorted_mut_info, storer=None):
        """AAM = mean_k clamp(I_1k - sum_{j>1} I_jk, 0) / I_1k, NaN -> 0."""
        numerator = np.clip(sorted_mut_info[:, 0]
                            - sorted_mut_info[:, 1:].sum(axis=1), 0, None)
        with np.errstate(divide="ignore", invalid="ignore"):
            aam_k = numerator / sorted_mut_info[:, 0]
        aam_k[np.isnan(aam_k)] = 0
        aam = aam_k.mean()
        if storer is not None:
            storer["aam_k"] = aam_k
            storer["aam"] = aam
        return aam

    @torch.no_grad()
    def _compute_q_zCx(self, dataloader):
        """Encode the entire dataset on the device. Returns (samples (N, D),
        (mu, logvar)); in eval mode samples == mu. Under a mesh each rank
        encodes its contiguous share of the rows, in batches of the
        loader's size, and the shares are gathered."""
        ds, B = dataloader.dataset, dataloader.batch_size
        n = len(ds)
        if getattr(dataloader, "drop_last", False):
            n -= n % B
        lo, hi, share = 0, n, n
        if self.mesh is not None:
            if getattr(dataloader, "shuffle", False):
                raise ValueError("the split metrics encode reads the rows "
                                 "in dataset order: pass an unshuffled "
                                 "loader")
            share = -(-n // self.mesh.data_size)
            lo = min(n, self.mesh.data_rank * share)
            hi = min(n, lo + share)
        if self._use_resident(dataloader):
            wire = self._resident.wire
            batches = (wire[i:min(i + B, hi)] for i in range(lo, hi, B))
        elif self.mesh is None:
            batches = (self._to_device(x) for x, _ in dataloader)
        else:
            get = ds.get_batch_raw if getattr(dataloader, "raw", False) \
                else ds.get_batch
            batches = (self._to_device(get(np.arange(i, min(i + B, hi)))[0])
                       for i in range(lo, hi, B))
        D = self.model.latent_dim
        mus, logvars = [], []
        for x in batches:
            batch = _decompress_batch(x, self.model.img_size)
            mu, logvar = self.model.encode(batch)
            mus.append(mu)
            logvars.append(logvar)
        if self.mesh is not None:
            # each share padded to `share` rows (a rank may hold none),
            # gathered in rank order, then cut back to the n rows
            stats = torch.zeros((share, 2 * D), device=self.device)
            if mus:
                stats[:hi - lo] = torch.cat([torch.cat(mus),
                                             torch.cat(logvars)], 1)
            mu, logvar = gather_rows(stats, self.mesh)[:n].split(D, 1)
            return mu.contiguous(), (mu.contiguous(), logvar.contiguous())
        mu = torch.cat(mus)
        logvar = torch.cat(logvars)
        return mu, (mu, logvar)

    def _estimate_latent_entropies(self, samples_zCx, params_zCx,
                                   n_samples=10000):
        """H(z_j) = E_q(z_j)[-log q(z_j)] by Monte Carlo, q(z) the mixture
        over the encoded dataset. Returns (D,) float64."""
        M, D = samples_zCx.shape
        S = min(n_samples, M)
        idx = self._np_rng.permutation(M)[:S]
        selected = samples_zCx[torch.from_numpy(idx).to(self.device)]
        if self.scramble_quirk:
            # the reference's .view(latent_dim, n_samples): row-major
            # reshape, NOT a transpose
            values = selected.reshape(D, S)
        else:
            values = selected.T
        mu, logvar = params_zCx
        H = self._entropy_sweep(values[None], mu[None].contiguous(),
                                logvar[None].contiguous(), M, S)
        return H[0]

    def _estimate_H_zCv(self, samples_zCx, params_zCx, lat_sizes, lat_names):
        """Conditional entropies H[z|v]: one batched estimate per factor,
        the `lat_size` slices of a factor as a leading L axis."""
        D = samples_zCx.shape[-1]
        mu, logvar = params_zCx
        N = int(np.prod(lat_sizes))
        lattice = np.arange(N).reshape(lat_sizes)
        H_zCv = np.zeros((len(lat_sizes), D), np.float64)
        for k, (lat_size, lat_name) in enumerate(zip(lat_sizes, lat_names)):
            self.logger.info(
                "Estimating conditional entropies over the %s values of %s.",
                lat_size, lat_name)
            # (lat_size, N / lat_size) gather plan: slice i of factor k
            flat = torch.from_numpy(np.moveaxis(lattice, k, 0)
                                    .reshape(lat_size, -1)).to(self.device)
            H_k = self._estimate_latent_entropies_batched(
                samples_zCx[flat], (mu[flat], logvar[flat]))  # (L, D)
            H_zCv[k] = H_k.mean(axis=0)
        return H_zCv

    def _estimate_latent_entropies_batched(self, samples_zCx, params_zCx,
                                           n_samples=10000):
        """Batched _estimate_latent_entropies over a leading axis L of
        independent mixtures. Returns (L, D) float64."""
        L, M, D = samples_zCx.shape
        S = min(n_samples, M)
        idx = np.stack([self._np_rng.permutation(M)[:S] for _ in range(L)])
        idx = torch.from_numpy(idx).to(self.device)
        selected = torch.gather(samples_zCx, 1,
                                idx[:, :, None].expand(L, S, D))
        if self.scramble_quirk:
            values = selected.reshape(L, D, S)  # row-major, as the reference
        else:
            values = selected.transpose(1, 2)
        mu, logvar = params_zCx
        return self._entropy_sweep(values, mu.contiguous(),
                                   logvar.contiguous(), M, S)

    def _entropy_sweep(self, values, mu, logvar, M, S):
        """-mean_s (log q(values) - log M) per (l, d), one log_qz (or
        log_qz_fast) call per sample chunk. values (L, D, S), mu/logvar
        (L, M, D). Under a mesh each rank takes its contiguous S/W of the
        samples and one all-reduce sums the float64 partials."""
        log_M = math.log(M)
        lo, hi = 0, S
        if self.mesh is not None:
            lo = S * self.mesh.data_rank // self.mesh.data_size
            hi = S * (self.mesh.data_rank + 1) // self.mesh.data_size
        H = np.zeros(values.shape[:2], np.float64)
        for s0 in range(lo, hi, _SAMPLE_CHUNK):
            v = values[:, :, s0:min(s0 + _SAMPLE_CHUNK, hi)].contiguous()
            lq = (log_qz_fast if self.fast_entropies else log_qz)(
                v, mu, logvar)  # (L, D, s_chunk)
            H += (log_M - lq.double()).sum(dim=2).cpu().numpy()
        if self.mesh is not None:
            H = all_reduce_sum(torch.from_numpy(H).to(self.device),
                               self.mesh).cpu().numpy()
        return H / S
