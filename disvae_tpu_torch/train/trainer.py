"""Training orchestration: epoch loop, metric recording, checkpointing.

Counterpart of disvae_tpu/train/trainer.py (reference
disvae/training.py:17-196). The reference syncs with the device on every
iteration (`loss.item()`); here each step leaves one packed metric vector
on the device, an epoch's vectors are copied to the host once, and with
the resident feed that copy is read only after the next epoch has been
dispatched, so the host does not hold the device back.

Artifacts as the JAX package writes them: `train_losses.log` is CSV
`Epoch,Loss,Value` with one row per (epoch, metric), averaged over the
steps where `step % 50 == 1` (the reference's record_loss_every gate);
`model-<epoch>.pt` every `checkpoint_every` epochs; `train_state.pt`, the
full training state for a bit-exact `--resume`, written atomically.
"""

import logging
import os
import signal
from timeit import default_timer

import numpy as np
import torch

from disvae_tpu_torch.data.prefetch import DevicePrefetcher
from disvae_tpu_torch.data.resident import DEFAULT_LIMIT_BYTES, ResidentData
from disvae_tpu_torch.models.discriminator import Discriminator
from disvae_tpu_torch.ops.losses import RECORD_LOSS_EVERY, metric_key_order
from disvae_tpu_torch.train.state import create_train_state
from disvae_tpu_torch.train.steps import (make_disc_optimizer,
                                          make_optimizer,
                                          make_resident_multi_train_step,
                                          make_train_step, stack_metrics)
from disvae_tpu_torch.utils.helpers import derive_seeds
from disvae_tpu_torch.utils.modelIO import save_model

TRAIN_LOSSES_LOGFILE = "train_losses.log"
CKPT_FILE = "train_state.pt"

_NO_DATASET = object()  # sentinel distinct from any dataset (incl. None)


def _pack_metrics(rows):
    """Concatenate per-step (n_keys,) and per-super-step (K, n_keys) metric
    rows into one (n_rows, n_keys) tensor and start its copy to the host.
    Returns (n_rows, fetch), where fetch() waits for the copy and returns
    the numpy array, or None for no rows."""
    if not rows:
        return None
    packed = torch.cat([r if r.dim() == 2 else r[None] for r in rows])
    if packed.device.type != "cuda":
        return packed.shape[0], packed.numpy
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def fetch():
        done.synchronize()
        return host.numpy()
    return packed.shape[0], fetch


class Trainer:
    """Drives training of a VAE (an nn.Module on its device) under a loss.

    Parameters
    ----------
    model : disvae_tpu_torch.models.vae.VAE
    loss_f : loss config from disvae_tpu_torch.ops.losses
    lr : float
        Adam learning rate (torch-default betas/eps).
    seed : int or None
        Seeds the generator of the training noise (on the model's device)
        and, for FactorVAE, the discriminator's init; None draws fresh
        entropy.
    save_dir : str
    gif_visualizer : callable(model) or None
        Called after every epoch to append a frame; `save_reset()` at the
        end.
    steps_per_dispatch : int
        Steps per resident super-step call; the batch order is the
        epoch's either way.
    resident : "auto", "always" or "never"
        Device-resident dataset feed (data/resident.py): "auto" when the
        wire-format dataset fits DEFAULT_LIMIT_BYTES.
    pipeline_epochs : bool
        With the resident feed, read epoch N's metrics only after epoch
        N+1 was dispatched. The numbers are the same either way.
    skip_tiny_tail : bool
        A ragged final batch of ONE sample is undefined for FactorVAE and
        btcvae with MSS; by default the Trainer raises ValueError as the
        reference fails there, True (the CLI's setting) skips it with a
        warning.
    """

    def __init__(self, model, loss_f, lr, seed=None,
                 logger=logging.getLogger(__name__),
                 save_dir="results",
                 gif_visualizer=None,
                 is_progress_bar=True,
                 steps_per_dispatch=16,
                 resident="auto",
                 resume=False,
                 pipeline_epochs=True,
                 skip_tiny_tail=False):
        self.loss_f = loss_f
        self.save_dir = save_dir
        self.logger = logger
        self.is_progress_bar = is_progress_bar
        self.gif_visualizer = gif_visualizer
        self.steps_per_dispatch = max(1, int(steps_per_dispatch))
        self.pipeline_epochs = bool(pipeline_epochs)
        self.skip_tiny_tail = bool(skip_tiny_tail)
        self.resident_policy = resident
        self.device = next(model.parameters()).device
        self._start_epoch = 0
        # {"epoch", "loss", "images_per_sec"} as logged, one per epoch
        self.epoch_stats = []

        train_seed, disc_seed = derive_seeds(seed, 2)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(train_seed)
        disc = disc_optimizer = None
        if loss_f.needs_discriminator:
            disc = Discriminator(
                latent_dim=loss_f.latent_dim,
                generator=torch.Generator().manual_seed(disc_seed))
            disc = disc.to(self.device)
            disc_optimizer = make_disc_optimizer(disc.parameters(), loss_f)
        self.state = create_train_state(
            model, make_optimizer(model.parameters(), lr), generator,
            disc=disc, disc_optimizer=disc_optimizer, loss_cfg=loss_f)
        self.metric_keys = metric_key_order(loss_f.name, model.latent_dim)
        self._train_step = make_train_step(loss_f)
        self._resident_step = make_resident_multi_train_step(
            loss_f, self.metric_keys)
        self._resident = None
        self._resident_ds = _NO_DATASET  # identity key of the cached feed
        if resume:
            self.load_checkpoint()
        # The log keeps only rows strictly before the resume epoch: after a
        # hard kill it may hold rows of epochs that will run again.
        self.losses_logger = LossesLogger(
            os.path.join(save_dir, TRAIN_LOSSES_LOGFILE),
            resume_from_epoch=self._start_epoch if resume else None)
        self.logger.info("Training Device: {}".format(self.device))

    @property
    def model(self):
        return self.state.model

    @property
    def resident_data(self):
        """The device-resident upload of the last training set, or None."""
        return self._resident

    # ------------------------------------------------------------------
    # checkpoint / resume (full training state, atomic)
    # ------------------------------------------------------------------

    def save_checkpoint(self, epoch):
        payload = {"next_epoch": epoch + 1, "state": self.state.state_dict()}
        path = os.path.join(self.save_dir, CKPT_FILE)
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)

    def load_checkpoint(self):
        """Restore the state from save_dir; returns the epoch to resume at
        (0 when no checkpoint exists). The loss coefficients stay those of
        this Trainer's loss config (what specs.json records)."""
        path = os.path.join(self.save_dir, CKPT_FILE)
        if not os.path.isfile(path):
            return 0
        # on the CPU: load_state_dict moves each tensor to its parameter's
        # device, and Adam's step counts stay host-side
        payload = torch.load(path, map_location="cpu", weights_only=True)
        self.state.load_state_dict(payload["state"])
        self._start_epoch = int(payload["next_epoch"])
        self.logger.info("Resuming from checkpoint at epoch {}."
                         .format(self._start_epoch))
        return self._start_epoch

    def __call__(self, data_loader, epochs=10, checkpoint_every=10):
        start = default_timer()
        n_images = 0
        start_epoch = self._start_epoch
        if start_epoch and hasattr(data_loader, "_epoch"):
            # a resumed run draws the shuffles it would have drawn: the
            # loader's permutation is keyed by (seed, epoch counter)
            data_loader._epoch = max(data_loader._epoch, start_epoch)

        # The ragged tail's size is static (len(dataset) mod batch), so the
        # tiny-tail contract is checked before any step runs.
        bs = getattr(data_loader, "batch_size", None)
        n_ds = len(getattr(data_loader, "dataset", []) or [])
        if (bs and n_ds and n_ds % bs == 1
                and not getattr(data_loader, "drop_last", False)
                and not self.skip_tiny_tail):
            self._skip_tiny_tail(1)  # raises for the affected losses

        # On SIGTERM/SIGINT: finish the epoch, checkpoint the full state,
        # stop; the run then resumes exactly with --resume.
        stop = {"flag": False}

        def _request_stop(signum, frame):
            self.logger.warning(
                "Signal %s received: checkpointing at epoch end.", signum)
            stop["flag"] = True

        old_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old_handlers[sig] = signal.signal(sig, _request_stop)
            except ValueError:  # not in the main thread
                pass

        use_pipeline = self.pipeline_epochs and self._use_resident(data_loader)
        pending = None  # (epoch, packed metrics, base_step), unread
        self._epoch_anchor = default_timer()

        def _log_epoch(p_epoch, mean_epoch_loss, storer):
            now = default_timer()
            epoch_dt = now - self._epoch_anchor
            self._epoch_anchor = now
            rate = len(data_loader.dataset) / max(epoch_dt, 1e-9)
            self.epoch_stats.append(dict(epoch=p_epoch, loss=mean_epoch_loss,
                                         images_per_sec=rate))
            self.logger.info(
                "Epoch: {} Average loss per image: {:.2f} "
                "({:.0f} images/sec)".format(p_epoch + 1, mean_epoch_loss,
                                             rate))
            self.losses_logger.log(p_epoch, storer)

        def _finish_epoch(pend):
            p_epoch, packed, base_step = pend
            _log_epoch(p_epoch, *self._reduce_epoch_metrics(packed,
                                                            base_step))

        try:
            for epoch in range(start_epoch, epochs):
                if use_pipeline:
                    packed, base_step = self._dispatch_epoch_resident(
                        data_loader)
                    if pending is not None:
                        _finish_epoch(pending)
                    pending = (epoch, packed, base_step)
                else:
                    _log_epoch(epoch, *self._train_epoch(data_loader, epoch))
                n_images += len(data_loader.dataset)

                # what reads the state (gif frame, checkpoint) waits for the
                # device anyway, and the CSV must stay ahead of checkpoints
                # (resume truncates rows >= the checkpoint epoch)
                if pending is not None and (
                        self.gif_visualizer is not None
                        or epoch % checkpoint_every == 0
                        or stop["flag"] or epoch == epochs - 1):
                    _finish_epoch(pending)
                    pending = None

                if self.gif_visualizer is not None:
                    self.gif_visualizer(self.model)

                if epoch % checkpoint_every == 0:
                    save_model(self.model, self.save_dir,
                               filename="model-{}.pt".format(epoch))
                    self.save_checkpoint(epoch)

                if stop["flag"]:
                    if pending is not None:  # signal after the flush gate
                        _finish_epoch(pending)
                        pending = None
                    self.save_checkpoint(epoch)
                    self.logger.warning("Stopped by signal after epoch %d; "
                                        "resume with --resume.", epoch)
                    break

                if pending is None:
                    # epoch timing restarts after end-of-epoch host work
                    self._epoch_anchor = default_timer()
            if pending is not None:
                _finish_epoch(pending)
        finally:
            for sig, h in old_handlers.items():
                signal.signal(sig, h if h is not None else signal.SIG_DFL)

        if self.gif_visualizer is not None:
            self.gif_visualizer.save_reset()

        delta_time = (default_timer() - start) / 60
        self.logger.info("Finished training after {:.1f} min.".format(
            delta_time))
        if delta_time > 0:
            self.logger.info("Throughput: {:.0f} images/sec.".format(
                n_images / (delta_time * 60)))

    def _skip_tiny_tail(self, true_n):
        """A ragged final batch of ONE sample: FactorVAE's two half-batches
        would be empty (reference losses.py:246-251 crashes there), and
        btcvae's MSS weights divide by M = B - 1 = 0 (reference
        math.py:54-73). Raise ValueError like the reference, or with
        `skip_tiny_tail` skip the batch with a warning. Returns True when
        the batch is skipped."""
        if int(true_n) >= 2:
            return False
        if self.loss_f.needs_discriminator:
            why = ("FactorVAE needs two half-batches per step; a final "
                   "batch of {} sample(s) has an empty half (the reference "
                   "crashes here too)".format(int(true_n)))
        elif self.loss_f.name == "btcvae" and getattr(self.loss_f, "is_mss",
                                                      False):
            why = ("btcvae MSS importance weights are undefined for a "
                   "single sample (M = B-1 = 0; the reference errors on it)")
        else:
            return False
        fix = ("Pick a batch size with a tail of >= 2 (dataset mod batch) "
               "to train on every sample")
        if not self.skip_tiny_tail:
            raise ValueError(
                "{}. {}, or pass skip_tiny_tail=True to drop the tail "
                "batch with a warning.".format(why, fix))
        self.logger.warning("Skipping a final batch of %d sample(s): %s. "
                            "%s.", int(true_n), why, fix)
        return True

    # ------------------------------------------------------------------
    # device-resident feed
    # ------------------------------------------------------------------

    def _use_resident(self, data_loader):
        if self.resident_policy == "never":
            return False
        ds = getattr(data_loader, "dataset", None)
        if ds is not self._resident_ds:
            # keyed on the dataset's identity: a loader over another
            # dataset never gathers out of the old upload
            self._resident_ds = ds
            self._resident = None
            limit = (float("inf") if self.resident_policy == "always"
                     else DEFAULT_LIMIT_BYTES)
            if ds is not None:
                self._resident = ResidentData.maybe(ds, self.device,
                                                    limit_bytes=limit)
            if self._resident is not None:
                self.logger.info("Using the device-resident dataset feed (one "
                                 "upload; epochs copy only the "
                                 "permutation).")
        return self._resident is not None

    def _dispatch_epoch_resident(self, data_loader):
        """Enqueue one epoch fed from the device: the full batches in
        super-steps of `steps_per_dispatch`, then the ragged tail, in the
        loader's epoch order (the streaming feed's). Returns the packed
        metrics (their host copy already started) and the base step."""
        base_step = self.state.step
        wire = self._resident.wire
        B = data_loader.batch_size
        order = data_loader.epoch_order()
        n = len(order)
        if getattr(data_loader, "drop_last", False):
            n -= n % B
        n_full = n // B
        rem = n - n_full * B
        rows = []
        if n_full:
            idx = torch.from_numpy(order[:n_full * B].astype(np.int64)
                                   .reshape(n_full, B)).to(self.device)
            k = self.steps_per_dispatch
            for k0 in range(0, n_full, k):
                rows.append(self._resident_step(self.state, wire,
                                                idx[k0:k0 + k]))
        if rem and self._skip_tiny_tail(rem):
            rem = 0
        if rem:
            tail = torch.from_numpy(order[n_full * B:n].astype(np.int64))
            batch = wire.index_select(0, tail.to(self.device))
            rows.append(stack_metrics(self._train_step(self.state, batch),
                                      self.metric_keys))
        return _pack_metrics(rows), base_step

    def _train_epoch(self, data_loader, epoch):
        """One epoch. Returns (mean loss over all steps, storer dict of
        means over the recorded steps)."""
        if self._use_resident(data_loader):
            return self._reduce_epoch_metrics(
                *self._dispatch_epoch_resident(data_loader))

        base_step = self.state.step
        rows = []
        raw_before = getattr(data_loader, "raw", None)
        try:
            if raw_before is not None and hasattr(data_loader.dataset,
                                                  "get_batch_raw"):
                # stream the uint8 wire format: 4x fewer bytes to copy; the
                # step decompresses on the device
                data_loader.raw = True
            iterator = DevicePrefetcher(data_loader, self.device)
            if self.is_progress_bar:
                from tqdm import tqdm
                iterator = tqdm(iterator, desc="Epoch {}".format(epoch + 1),
                                leave=False, total=len(data_loader))
            for batch in iterator:
                if self._skip_tiny_tail(batch.shape[0]):
                    continue
                rows.append(stack_metrics(self._train_step(self.state,
                                                           batch),
                                          self.metric_keys))
        finally:
            if raw_before is not None:
                data_loader.raw = raw_before
        return self._reduce_epoch_metrics(_pack_metrics(rows), base_step)

    def _reduce_epoch_metrics(self, packed, base_step):
        """Read one epoch's packed metrics from the host (one device ->
        host copy per epoch), apply the record-every-50 gate, and return
        (mean epoch loss, storer of the recorded steps' means)."""
        if packed is None:
            return float("nan"), {}
        all_metrics = packed[1]()
        steps = base_step + 1 + np.arange(all_metrics.shape[0])
        recorded = (steps % RECORD_LOSS_EVERY) == 1
        loss_idx = self.metric_keys.index("loss")
        mean_epoch_loss = float(all_metrics[:, loss_idx].mean())
        storer = {}
        if recorded.any():
            means = all_metrics[recorded].mean(axis=0)
            storer = {k: float(means[i])
                      for i, k in enumerate(self.metric_keys)}
        return mean_epoch_loss, storer


class LossesLogger:
    """CSV metric log in the reference's `train_losses.log` format
    (training.py:167-196): header `Epoch,Loss,Value`, one row per (epoch,
    key, mean over the recorded steps).

    `resume_from_epoch=None` (a fresh run) replaces any existing file. With
    `resume_from_epoch=e`, rows with Epoch >= e are dropped, so a run
    restarted from an older checkpoint leaves no duplicate rows; e=0
    (resume asked for, no checkpoint found) starts a fresh log."""

    def __init__(self, file_path_name, resume_from_epoch=None):
        self.path = file_path_name
        os.makedirs(os.path.dirname(file_path_name) or ".", exist_ok=True)
        if resume_from_epoch is not None and resume_from_epoch > 0 \
                and os.path.isfile(file_path_name):
            with open(file_path_name) as f:
                lines = f.readlines()
            kept = [ln for ln in lines[1:]
                    if ln.strip()
                    and int(ln.split(",", 1)[0]) < resume_from_epoch]
            with open(self.path, "w") as f:
                f.write("Epoch,Loss,Value\n")
                f.writelines(kept)
            return
        with open(self.path, "w") as f:
            f.write("Epoch,Loss,Value\n")

    def log(self, epoch, storer):
        with open(self.path, "a") as f:
            for k, v in storer.items():
                f.write("{},{},{}\n".format(epoch, k, v))
