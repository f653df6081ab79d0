"""Training orchestration: epoch loop, metric recording, checkpointing.

Counterpart of disvae_tpu/train/trainer.py (reference
disvae/training.py:17-196). The reference syncs with the device on every
iteration (`loss.item()`); here each step leaves one packed metric vector
on the device, an epoch's vectors are copied to the host once, and with
the resident feed that copy is read only after the next epoch has been
dispatched, so the host does not hold the device back. On the card, the
resident feed's super-steps of `steps_per_dispatch` steps replay as one
CUDA graph each after an eager first one, as JAX runs them as one scanned
program (train/steps.py GraphedSuperStep).

Artifacts as the JAX package writes them: `train_losses.log` is CSV
`Epoch,Loss,Value` with one row per (epoch, metric), averaged over the
steps where `step % 50 == 1` (the reference's record_loss_every gate);
`model-<epoch>.pt` every `checkpoint_every` epochs; `train_state.pt`, the
full training state for a bit-exact `--resume`, written atomically.

Data parallelism (disvae_tpu trainer.py, `mesh=`): every rank runs the
Trainer on its rows of each global batch (parallel/mesh.py), holds the
same replicated state, and logs the same global metrics; rank 0 alone
writes the log and the checkpoints, which every rank reads on `--resume`.
With a model axis larger than 1 the ranks of one model group feed the same
rows and hold the FactorVAE discriminator in shards; the checkpoint holds
it whole.
A global batch that does not divide the data axis (the ragged tail, or
every batch when the batch size does not divide it) is padded and takes
the mask-aware padded step.
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
from disvae_tpu_torch.parallel.distributed import is_writer
from disvae_tpu_torch.parallel.mesh import pad_to_multiple, shard_batch
from disvae_tpu_torch.train.state import create_train_state
from disvae_tpu_torch.train.steps import (GraphedSuperStep,
                                          make_disc_optimizer,
                                          make_optimizer,
                                          make_padded_train_step,
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
    mesh : parallel.mesh.Mesh or None
        Data parallelism: the steps run on this rank's rows of each global
        batch with their collectives over the mesh. The loader yields
        either this rank's share (`host_slice`; the Trainer sets
        `pad_global_to` to the data axis when it is unset) or the global
        batches, of which the prefetcher takes this rank's share.
    cuda_graph : bool
        On a CUDA device with the resident feed and no mesh, replay each
        super-step of `steps_per_dispatch` steps as one CUDA graph
        (train/steps.py GraphedSuperStep); the first super-step runs
        eagerly. False keeps every step eager (the card tests' reference).
        The CPU, the streamed feed and the mesh path are eager either way
        (train/steps.py make_resident_multi_train_step decides).
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
                 skip_tiny_tail=False,
                 mesh=None,
                 cuda_graph=True):
        self.loss_f = loss_f
        self.save_dir = save_dir
        self.logger = logger
        self.is_progress_bar = is_progress_bar
        self.gif_visualizer = gif_visualizer
        self.steps_per_dispatch = max(1, int(steps_per_dispatch))
        self.pipeline_epochs = bool(pipeline_epochs)
        self.skip_tiny_tail = bool(skip_tiny_tail)
        self.resident_policy = resident
        self.mesh = mesh
        self.device = next(model.parameters()).device
        self._start_epoch = 0
        # {"epoch", "loss", "images_per_sec"} as logged, and the epoch's
        # step calls ("dispatches"), one per epoch
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
        # with a model axis larger than 1 these calls shard the
        # discriminator (tensor parallelism) before any checkpoint loads
        self._train_step = make_train_step(loss_f, mesh=mesh,
                                           state=self.state)
        self._padded_step = make_padded_train_step(loss_f, mesh=mesh,
                                                   state=self.state)
        self._resident_step = make_resident_multi_train_step(
            loss_f, self.metric_keys, mesh=mesh, state=self.state,
            graph_steps=self.steps_per_dispatch if cuda_graph else None)
        self._warned_batch_pad = False
        self._resident = None
        self._resident_ds = _NO_DATASET  # identity key of the cached feed
        if resume:
            self.load_checkpoint()
        # Rank 0 alone writes artifacts (every rank holds the same state);
        # every rank read the checkpoint above.
        self._is_writer = is_writer()
        # The log keeps only rows strictly before the resume epoch: after a
        # hard kill it may hold rows of epochs that will run again.
        self.losses_logger = None
        if self._is_writer:
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
        """Every rank calls this: a tensor-parallel state gathers the whole
        discriminator over each model group; rank 0 alone writes."""
        state = self.state.state_dict()
        if not self._is_writer:
            return
        payload = {"next_epoch": epoch + 1, "state": state}
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
        # device (a capturable Adam's step counts too)
        payload = torch.load(path, map_location="cpu", weights_only=True)
        self.state.load_state_dict(payload["state"])
        # Adam's state tensors were replaced: a captured graph would still
        # update the old ones, so the next super-steps capture again
        if isinstance(self._resident_step, GraphedSuperStep):
            self._resident_step.reset()
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
            self.epoch_stats.append(dict(
                epoch=p_epoch, loss=mean_epoch_loss, images_per_sec=rate,
                dispatches=self._n_dispatches(data_loader)))
            self.logger.info(
                "Epoch: {} Average loss per image: {:.2f} "
                "({:.0f} images/sec)".format(p_epoch + 1, mean_epoch_loss,
                                             rate))
            if self.losses_logger is not None:
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
                    if self._is_writer:
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

    def _data_axis(self):
        return 1 if self.mesh is None else self.mesh.data_size

    def _n_dispatches(self, data_loader):
        """Step calls one epoch makes (disvae_tpu trainer.py
        `_n_dispatches`): on the resident feed, full batches go
        `steps_per_dispatch` to a super-step, one by one when the batch
        size does not divide the data axis, and a ragged tail singly;
        streamed, one call per batch."""
        n_batches = len(data_loader)
        if self._resident is None:
            return n_batches
        B = data_loader.batch_size
        if B % self._data_axis():
            return n_batches  # every batch takes the padded step
        n = len(data_loader.dataset)
        ragged = bool(n % B and not getattr(data_loader, "drop_last",
                                            False))
        n_full = n_batches - ragged
        return -(-n_full // self.steps_per_dispatch) + ragged

    def _warn_batch_pad(self, batch_size):
        axis = self._data_axis()
        if batch_size % axis and not self._warned_batch_pad:
            self._warned_batch_pad = True
            self.logger.warning(
                "batch_size={} is not divisible by the data axis ({}): "
                "EVERY step takes the padded masked path and the resident "
                "feed's K-step super-steps are off. Pick a batch size "
                "divisible by {} for full throughput.".format(
                    batch_size, axis, axis))

    def _batch_step(self, batch, n_valid):
        """One train step on this rank's rows; the padded step when the
        global batch was padded. Returns the packed metrics."""
        if n_valid is None:
            metrics = self._train_step(self.state, batch)
        else:
            metrics = self._padded_step(self.state, batch, n_valid)
        return stack_metrics(metrics, self.metric_keys)

    def _resident_batch(self, wire, idx):
        """One global batch of dataset indices from the resident upload:
        padded to the data-axis multiple by repeating the first index (as
        `pad_to_multiple` pads a streamed batch), then this rank's share
        gathered on the device."""
        n_valid = None
        if self.mesh is not None:
            idx, true_n = pad_to_multiple(idx, self.mesh.data_size)
            if len(idx) != true_n:
                n_valid = true_n
            idx = shard_batch(idx, self.mesh)
        idx = torch.from_numpy(idx.astype(np.int64)).to(self.device)
        return self._batch_step(wire.index_select(0, idx), n_valid)

    def _dispatch_epoch_resident(self, data_loader):
        """Enqueue one epoch fed from the device: the full batches in
        super-steps of `steps_per_dispatch`, then the ragged tail, in the
        loader's epoch order (the streaming feed's). Under a mesh each rank
        takes its columns of every global batch. Returns the packed
        metrics (their host copy already started) and the base step."""
        base_step = self.state.step
        wire = self._resident.wire
        B = data_loader.batch_size
        self._warn_batch_pad(B)
        order = data_loader.epoch_order()
        n = len(order)
        if getattr(data_loader, "drop_last", False):
            n -= n % B
        n_full = n // B
        rem = n - n_full * B
        rows = []
        if n_full and B % self._data_axis() == 0:
            idx = order[:n_full * B].reshape(n_full, B)
            if self.mesh is not None:  # this rank's columns
                idx = np.ascontiguousarray(shard_batch(idx.T, self.mesh).T)
            idx = torch.from_numpy(idx.astype(np.int64)).to(self.device)
            k = self.steps_per_dispatch
            for k0 in range(0, n_full, k):
                rows.append(self._resident_step(self.state, wire,
                                                idx[k0:k0 + k]))
        else:
            rows.extend(self._resident_batch(wire, order[i * B:(i + 1) * B])
                        for i in range(n_full))
        if rem and self._skip_tiny_tail(rem):
            rem = 0
        if rem:
            rows.append(self._resident_batch(wire, order[n_full * B:n]))
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
        if self.mesh is not None:
            self._warn_batch_pad(data_loader.batch_size)
            if getattr(data_loader, "host_slice", None) is not None \
                    and getattr(data_loader, "pad_global_to", None) is None:
                # equal shares of every (padded) global batch, so that
                # every rank steps on equally shaped batches
                if self.mesh.data_size % data_loader.host_slice[1]:
                    raise ValueError(
                        "data axis ({}) must be divisible by the loader's "
                        "host count ({})".format(self.mesh.data_size,
                                                 data_loader.host_slice[1]))
                data_loader.pad_global_to = self.mesh.data_size
        try:
            if raw_before is not None and hasattr(data_loader.dataset,
                                                  "get_batch_raw"):
                # stream the uint8 wire format: 4x fewer bytes to copy; the
                # step decompresses on the device
                data_loader.raw = True
            iterator = DevicePrefetcher(data_loader, self.device,
                                        mesh=self.mesh)
            if self.is_progress_bar:
                from tqdm import tqdm
                iterator = tqdm(iterator, desc="Epoch {}".format(epoch + 1),
                                leave=False,
                                total=self._n_dispatches(data_loader))
            for batch, n_valid in iterator:
                true_n = (batch.shape[0] * self._data_axis()
                          if n_valid is None else n_valid)
                if self._skip_tiny_tail(true_n):
                    continue
                rows.append(self._batch_step(batch, n_valid))
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
