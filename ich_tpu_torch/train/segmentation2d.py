"""2.5D U-Net segmentation trainer (counterpart of
:class:`ich_tpu.train.segmentation2d.UNet2D`).

``train``: the host permutation of each epoch is replayed from
``np.random.default_rng(seed)`` (so a resumed run sees the same batches),
batches are gathered on the device from a ``device_cache``d dataset, and
each step augments on the device, runs the net in train mode, takes the
loss, backward and an Adam step. The step's key (``fit``'s, as the JAX
loop folds it) splits into the augmentation's key and dropout's, whose
draws equal the JAX package's (dropout's masks are flax's, drawn by the
keyed dropout kernel). ``evaluate`` counts each
slice's TN/FP/FN/TP on the device and writes the JAX package's CSVs (the
columns, index and row order of pandas' ``to_csv``) and ``<vol>/<slice>.bmp``
predictions. The net is in eval mode except while it trains.

``segment_volume`` runs one whole volume on the device, step for step as
the JAX package's ``_segvol_body``: rot90 -> window -> linear resize to the
net's input -> the net over slice batches -> threshold at 0.5 -> nearest
resize back (in the rotated frame) -> rot90 back -> uint8 x255.
``segment_volumes`` keeps up to ``pipeline_depth`` volumes queued on the
device before it fetches the oldest result.

Under ``torch.profiler`` a train step shows as side-by-side ranges:
``keys`` (its keys split and handed to the Dropouts), ``augment``, ``net``
(the forward, with the keyed ``dropout`` ranges inside), ``loss`` and
``backward``; a served volume ends in ``fetch`` (the wait for its work and
the copy to the host) and ``finish`` (x255 and the NIfTI write).

With ``mesh=`` (an :class:`ich_tpu_torch.parallel.Mesh`) the trainer is
data-parallel as the JAX package's jit-sharded one is: every rank holds
the replicated net, replays the same host plan and gathers each global
batch on its device, draws the augmentation for the global batch from the
step's key and keeps its slice, draws its rows of the global batch's
dropout masks, normalises with the global batch's BatchNorm statistics
and averages the gradients before Adam, so world N computes world 1's
step; ``batch_size`` is the global batch. ``evaluate`` runs on every rank
and only rank 0 writes files; with
more than one rank, ``segment_volumes`` of same-shaped volumes runs one
volume per rank (:func:`ich_tpu_torch.parallel.volume_parallel_map`).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from datetime import timedelta
from functools import partial
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ich_tpu_torch.data import nifti
from ich_tpu_torch.data.bmp import save_bmp_gray
from ich_tpu_torch.data.table import write_csv
from ich_tpu_torch.data.core import SliceDataset2D, batch_indices
from ich_tpu_torch.models.layers import set_dropout_keys, sync_batch_norm
from ich_tpu_torch.ops import ct
from ich_tpu_torch.ops import losses as _losses  # noqa: F401  (registers LOSSES)
from ich_tpu_torch.ops.metrics import batch_binary_confusion_matrix, dice_from_counts
from ich_tpu_torch.parallel.mesh import replicate, shard_batch
from ich_tpu_torch.parallel.sharded_inference import volume_parallel_map
from ich_tpu_torch.train import checkpoint as ckpt
from ich_tpu_torch.train.loop import fit
from ich_tpu_torch.train.state import TrainState, make_optimizer, make_schedule
from ich_tpu_torch.utils import rng
from ich_tpu_torch.utils.config import LOSSES, TRAINERS
from ich_tpu_torch.utils.logging import print_progressbar, save_json
from ich_tpu_torch.utils.pipeline import fetch_pipelined

logger = logging.getLogger(__name__)

SLICE_COLUMNS = ("volID", "slice", "label", "TP", "TN", "FP", "FN", "pred_fn", "Dice")


def resolve_device(device: str | torch.device) -> torch.device:
    """``torch.device(device)``; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but torch.cuda.is_available() is False")
    return dev


def _resolve_loss(loss_fn, loss_fn_kwargs) -> Callable:
    if isinstance(loss_fn, str):
        return LOSSES.build(loss_fn, **(loss_fn_kwargs or {}))
    if callable(loss_fn) and loss_fn_kwargs:
        return partial(loss_fn, **loss_fn_kwargs)
    return loss_fn


def _with_channels(spatial_ndim: int, *xs: torch.Tensor):
    """Batched tensors without a channel axis, (B, H, W) or (B, D, H, W),
    get one last: (B, H, W, 1) or (B, D, H, W, 1)."""
    return tuple(x[..., None] if x.dim() == 1 + spatial_ndim else x for x in xs)


@contextlib.contextmanager
def eval_mode(net: nn.Module):
    """``net`` in eval mode inside the block, its previous mode restored
    after."""
    was_training = net.training
    net.eval()
    try:
        yield
    finally:
        net.train(was_training)


def data_parallel(net: nn.Module, mesh) -> nn.Module:
    """``net`` with its weights broadcast from rank 0 of ``mesh`` and its
    BatchNorms synced over it; unchanged without a mesh."""
    if mesh is not None:
        sync_batch_norm(replicate(net, mesh), mesh)
    return net


def volume_table(cols: Dict[str, Sequence], sums: Sequence[str]) -> Tuple[np.ndarray, dict]:
    """Per-slice columns (``volID``, ``label`` and the count columns
    ``sums``) aggregated per volume as pandas' ``groupby("volID")`` does:
    the sorted volume ids and, per volume, the max label, the sums and the
    smoothed Dice."""
    vol_ids, inv = np.unique(np.asarray(cols["volID"], dtype=np.int64), return_inverse=True)
    vol = {"label": np.zeros(len(vol_ids), np.int64)}
    np.maximum.at(vol["label"], inv, np.asarray(cols["label"], dtype=np.int64))
    for k in sums:
        vol[k] = np.bincount(inv, weights=np.asarray(cols[k], np.float64), minlength=len(vol_ids))
    vol["Dice"] = dice_from_counts(vol["TP"], vol["FP"], vol["FN"])
    return vol_ids, vol


def write_score_csvs(out_dir: str, cols: Dict[str, Sequence], slice_columns: Sequence[str],
                     sums: Sequence[str]) -> Tuple[np.ndarray, dict]:
    """``slice_prediction_scores.csv`` (a leading index, then
    ``slice_columns``) and ``volume_prediction_scores.csv`` (``volID``,
    ``label``, ``sums``, ``Dice``) as the JAX package's pandas frames write
    them; returns :func:`volume_table`."""
    arrs = {c: np.asarray(cols[c]) for c in slice_columns}
    n = len(arrs[slice_columns[0]])
    write_csv(os.path.join(out_dir, "slice_prediction_scores.csv"), ("",) + tuple(slice_columns),
              ([i] + [arrs[c][i].item() for c in slice_columns] for i in range(n)))
    vol_ids, vol = volume_table(cols, sums)
    vcols = ("label",) + tuple(sums) + ("Dice",)
    write_csv(os.path.join(out_dir, "volume_prediction_scores.csv"), ("volID",) + vcols,
              ([v.item()] + [vol[c][i].item() for c in vcols] for i, v in enumerate(vol_ids)))
    return vol_ids, vol


class UNet2D:
    """Train and evaluate a 2D segmentation network slice-wise; score (H,
    W, Z) volumes. The constructor takes the JAX trainer's arguments;
    ``num_workers`` is accepted for the configs and unused (there are no
    host workers). With a ``mesh`` the trainer runs on the mesh's device
    and ``device`` is not used."""

    _spatial_ndim = 2  # 3 in the volumetric subclass

    def __init__(
        self,
        unet: nn.Module,
        n_epoch: int = 150,
        batch_size: int = 16,
        lr: float = 1e-3,
        lr_scheduler: str = "ExponentialLR",
        lr_scheduler_kwargs: Optional[dict] = None,
        loss_fn="BinaryDiceLoss",
        loss_fn_kwargs: Optional[dict] = None,
        weight_decay: float = 1e-6,
        augment_fn: Optional[Callable] = None,
        seed: int = 0,
        print_progress: bool = False,
        checkpoint_freq: int = 10,
        num_workers: int = 0,
        device: str | torch.device = "cuda",
        mesh=None,
    ):
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.unet = data_parallel(unet.to(self.device).eval(), mesh)
        self.n_epoch = n_epoch
        self.batch_size = batch_size
        self.lr = lr
        self.lr_scheduler = lr_scheduler
        self.lr_scheduler_kwargs = dict(lr_scheduler_kwargs or {"gamma": 0.95})
        self.loss = _resolve_loss(loss_fn, dict(loss_fn_kwargs or {"reduction": "mean"}))
        self.weight_decay = weight_decay
        self.augment_fn = augment_fn
        self.seed = seed
        self.print_progress = print_progress
        self.checkpoint_freq = checkpoint_freq

        self.state: Optional[TrainState] = None
        self._state_steps: Optional[int] = None  # steps_per_epoch of the schedule
        self.outputs = {
            "train": {"time": None, "evolution": None},
            "eval": {"time": None, "dice": {"all": None, "positive": None}},
        }

    # -- training -------------------------------------------------------------

    def _train_state(self, steps_per_epoch: int) -> TrainState:
        """The optimizer and schedule, built anew (the step count kept) when
        the epoch length changes: the schedules decay per epoch."""
        if self.state is None or self._state_steps != steps_per_epoch:
            self.state = TrainState(
                self.unet,
                make_optimizer(self.unet.parameters(), self.lr, weight_decay=self.weight_decay),
                make_schedule(self.lr_scheduler, self.lr, steps_per_epoch,
                              **self.lr_scheduler_kwargs),
                self.state.step if self.state is not None else 0,
                self.mesh,
            )
            self._state_steps = steps_per_epoch
        return self.state

    @property
    def _writes(self) -> bool:
        """Whether this process writes files: rank 0 of a mesh, or alone."""
        return self.mesh is None or self.mesh.rank == 0

    def _to_device(self, arr) -> torch.Tensor:
        """A host array or CPU tensor on the device."""
        t = torch.as_tensor(arr)
        if self.device.type == "cuda":
            # pinned + non_blocking: the copy does not wait for queued work
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _batches(self, dataset: SliceDataset2D, plan: np.ndarray):
        """(images, masks) per row of the (steps, batch) index ``plan``, on
        the device: gathered there from a device-cached dataset, else
        gathered on the host and copied."""
        images, masks = dataset.images, dataset.masks
        if isinstance(images, torch.Tensor):
            plan_dev = self._to_device(plan.astype(np.int64))
            for b in range(len(plan)):
                yield images.index_select(0, plan_dev[b]), masks.index_select(0, plan_dev[b])
        else:
            for idx in plan:
                yield self._to_device(images[idx]), self._to_device(masks[idx])

    def _train_step(self, state: TrainState, batch, key: torch.Tensor) -> torch.Tensor:
        return self._step(state, *batch, key)

    def _step(self, state: TrainState, images: torch.Tensor, masks: torch.Tensor,
              key: torch.Tensor) -> torch.Tensor:
        """One step from ``key``: ``aug_key, drop_key = split(key)``, as the
        JAX train step splits it (``augment_fn(aug_key, images, masks)``),
        then :meth:`_update`."""
        with torch.profiler.record_function("keys"):
            aug_key, drop_key = rng.split(key)
        augment = None
        if self.augment_fn is not None:
            augment = lambda im, mk: self.augment_fn(aug_key, im, mk)  # noqa: E731
        return self._update(state, images, masks, augment, drop_key)

    def _update(self, state: TrainState, images: torch.Tensor, masks: torch.Tensor,
                augment: Optional[Callable], drop_key: torch.Tensor) -> torch.Tensor:
        """One step on a (B, *spatial[, 1]) batch: the channel axis added,
        ``augment(images, masks)``, dropout drawn from ``drop_key``, the net
        in its current mode (channels moved first for it and back), the
        loss, backward and Adam; returns the loss. Under a mesh the batch
        is the global one: it is augmented whole, then this rank keeps its
        slice, and the loss returned is the slice's (``fit`` averages it
        over the ranks)."""
        images, masks = _with_channels(self._spatial_ndim, images, masks)
        if augment is not None:
            with torch.profiler.record_function("augment"):
                images, masks = augment(images, masks)
        if self.mesh is not None:
            images, masks = shard_batch((images, masks), self.mesh)
        with torch.profiler.record_function("keys"):
            set_dropout_keys(state.model, drop_key, self.mesh)
        with torch.profiler.record_function("net"):
            pred = state.model(images.movedim(-1, 1)).movedim(1, -1)
        with torch.profiler.record_function("loss"):
            loss = self.loss(pred, masks)
        state.optimizer.zero_grad(set_to_none=True)
        with torch.profiler.record_function("backward"):
            loss.backward()
        state.apply_gradients()
        return loss.detach()

    def train(
        self,
        dataset: SliceDataset2D,
        valid_dataset: Optional[SliceDataset2D] = None,
        checkpoint_path: Optional[str] = None,
    ) -> None:
        n = len(dataset)
        steps_per_epoch = max(1, int(np.ceil(n / self.batch_size)))
        state = self._train_state(steps_per_epoch)

        host_rng = np.random.default_rng(self.seed)
        drawn = [0]  # permutations consumed so far

        def batches_fn(epoch):
            # replay the host RNG so that shuffles stay the same across a
            # resume: epoch e always takes the (e+1)-th permutation of the seed
            while drawn[0] < epoch:
                host_rng.permutation(n)
                drawn[0] += 1
            drawn[0] += 1
            plan = np.stack(list(batch_indices(n, self.batch_size, shuffle=True, rng=host_rng)))
            self.unet.train()
            for b, batch in enumerate(self._batches(dataset, plan)):
                if self.print_progress:
                    print_progressbar(b, steps_per_epoch, name="\t\tTrain Batch", erase=True)
                yield batch

        def epoch_hook(state, epoch, mean_losses, epoch_time):
            mean_loss = float(mean_losses) if mean_losses is not None else 0.0
            valid_str = ""
            v_all = v_pos = None
            if valid_dataset is not None:
                self.evaluate(valid_dataset, print_to_logger=False, save_path=None)
                v_all = self.outputs["eval"]["dice"]["all"]
                v_pos = self.outputs["eval"]["dice"]["positive"]
                valid_str = (
                    f"| Valid Dice: {v_all:.5f} | Valid Dice (Positive Slices): {v_pos:.5f} "
                )
            logger.info(
                "\t| Epoch: %03d/%03d | Train time: %s | Train Loss: %.6f %s|",
                epoch + 1, self.n_epoch,
                timedelta(seconds=int(epoch_time)), mean_loss, valid_str,
            )
            return [epoch + 1, mean_loss, v_all, v_pos]

        try:
            history, wall = fit(
                state, self._train_step, batches_fn, self.n_epoch, epoch_hook, seed=self.seed,
                checkpoint_path=checkpoint_path, checkpoint_freq=self.checkpoint_freq,
                name="U-Net 2.5D", mesh=self.mesh,
            )
        finally:
            self.unet.eval()
            set_dropout_keys(self.unet, None)
        self.outputs["train"]["time"] = wall
        self.outputs["train"]["evolution"] = history

    # -- evaluation -----------------------------------------------------------

    @torch.inference_mode()
    def _eval_batch(self, images: torch.Tensor, masks: torch.Tensor, return_pred: bool):
        """(5, B) float32 rows TN, FP, FN, TP, label, and the (B, H, W)
        uint8 {0, 1} prediction if ``return_pred``."""
        images, masks = _with_channels(self._spatial_ndim, images, masks)
        pred = self.unet(images.movedim(-1, 1)).movedim(1, -1)
        pred_bin = (pred >= 0.5).to(torch.float32)
        tn, fp, fn, tp = batch_binary_confusion_matrix(pred_bin, masks)
        label = (masks.reshape(masks.shape[0], -1).amax(dim=1) > 0).to(torch.float32)
        counts = torch.stack([tn, fp, fn, tp, label])
        if return_pred:
            return counts, pred_bin[..., 0].to(torch.uint8)
        return (counts,)

    def evaluate(
        self,
        dataset: SliceDataset2D,
        print_to_logger: bool = True,
        save_path: Optional[str] = None,
    ) -> Dict[str, np.ndarray]:
        """Per-slice confusion counts on the device; slice and volume Dice;
        with ``save_path``, ``slice_prediction_scores.csv``,
        ``volume_prediction_scores.csv`` and ``<vol>/<slice>.bmp`` as the
        JAX package (and the reference, ``UNet2D.py:183-270``) writes them.
        Fills ``outputs["eval"]`` (the positive Dice is NaN when no volume
        is positive, as pandas' mean of nothing) and returns the per-slice
        rows as a dict of numpy columns (``SLICE_COLUMNS``)."""
        n = len(dataset)
        start_time = time.time()
        if print_to_logger:
            logger.info("Start evaluating the U-Net 2.5D.")
        return_pred = save_path is not None
        # every batch has batch_size rows; the wrapped tail's duplicates are
        # dropped below
        plan = np.stack(list(batch_indices(n, self.batch_size, shuffle=False, pad_wrap=True)))
        rows = {k: [] for k in SLICE_COLUMNS[:-1]}
        with eval_mode(self.unet):
            fetched = fetch_pipelined(
                (self._eval_batch(x, y, return_pred) for x, y in self._batches(dataset, plan)),
                depth=8, fetch=lambda out: tuple(o.cpu().numpy() for o in out))

            for b, (idx, out) in enumerate(zip(plan, fetched)):
                valid = min(len(idx), n - b * self.batch_size)
                tn, fp, fn, tp, label = out[0]
                for j in range(valid):
                    vid, snb = int(dataset.vol_ids[idx[j]]), int(dataset.slice_nbrs[idx[j]])
                    pred_fn = "-"
                    if return_pred:
                        pred_fn = f"{vid}/{snb}.bmp"
                        if self._writes:
                            os.makedirs(os.path.join(save_path, f"{vid}"), exist_ok=True)
                            save_bmp_gray(os.path.join(save_path, pred_fn),
                                          out[1][j] * np.uint8(255))
                    rows["volID"].append(vid)
                    rows["slice"].append(snb)
                    rows["label"].append(int(label[j]))
                    rows["TP"].append(float(tp[j]))
                    rows["TN"].append(float(tn[j]))
                    rows["FP"].append(float(fp[j]))
                    rows["FN"].append(float(fn[j]))
                    rows["pred_fn"].append(pred_fn)
                if self.print_progress:
                    print_progressbar(b, len(plan), name="\t\tEvaluation Batch", erase=True)

        cols = {k: np.asarray(v, dtype=np.float64 if k in ("TP", "TN", "FP", "FN") else None)
                for k, v in rows.items()}
        cols["Dice"] = dice_from_counts(cols["TP"], cols["FP"], cols["FN"])
        sums = ("TP", "TN", "FP", "FN")
        if save_path and self._writes:
            _, vol = write_score_csvs(save_path, cols, SLICE_COLUMNS, sums)
        else:
            _, vol = volume_table(cols, sums)

        pos = vol["label"] == 1
        avg_all = float(np.mean(vol["Dice"]))
        avg_ich = float(np.mean(vol["Dice"][pos])) if pos.any() else float("nan")
        self.outputs["eval"]["time"] = time.time() - start_time
        self.outputs["eval"]["dice"] = {"all": avg_all, "positive": avg_ich}
        if print_to_logger:
            logger.info("Evaluation time: %s", timedelta(seconds=int(self.outputs["eval"]["time"])))
            logger.info("Evaluation Dice: %.5f.", avg_all)
            logger.info("Evaluation Dice (Positive only): %.5f.", avg_ich)
        return cols

    # -- full-volume inference ----------------------------------------------

    def _segment(self, vol: torch.Tensor, input_size: Tuple[int, int],
                 window: Optional[Tuple[float, float]]) -> torch.Tensor:
        """(H, W, Zp) raw volume on the device, Zp a multiple of the batch
        size -> (H, W, Zp) uint8 {0, 1} mask on the device; the net runs in
        eval mode, whatever mode it was left in."""
        h, w, z_pad = vol.shape
        x = torch.rot90(vol, 1, dims=(0, 1))  # 90 deg ccw
        if window is not None:
            x = ct.window_ct(x, window[0], window[1], (0.0, 1.0))
        x = ct.resize(x, (input_size[0], input_size[1], z_pad), order=1)
        x = x.permute(2, 0, 1).unsqueeze(1).contiguous()  # (Zp, 1, h, w)
        with eval_mode(self.unet):
            pred = torch.cat([
                (self.unet(xb) >= 0.5).to(torch.uint8)[:, 0]
                for xb in x.split(self.batch_size)
            ])  # (Zp, h, w)
        pred = pred.permute(1, 2, 0)  # (h, w, Zp)
        # still in the rot90 frame: resize to the rotated dims (W, H) so the
        # rotate-back lands on the input's (H, W)
        pred = ct.resize_nearest(pred, (w, h, z_pad))
        return torch.rot90(pred, 1, dims=(1, 0))

    def _enqueue(self, vol_data: np.ndarray, input_size, window) -> torch.Tensor:
        """Pad z to a multiple of the batch size, copy to the device and
        queue the volume's work; returns the (H, W, Z) device mask."""
        vol_data = np.asarray(vol_data, dtype=np.float32)
        h, w, z = vol_data.shape
        z_pad = -(-z // self.batch_size) * self.batch_size
        vol = torch.zeros((h, w, z_pad), dtype=torch.float32)
        vol[:, :, :z] = torch.from_numpy(vol_data)
        vol = self._to_device(vol)
        with torch.inference_mode():
            return self._segment(vol, tuple(input_size), window)[:, :, :z]

    @staticmethod
    def _fetch(mask: torch.Tensor) -> np.ndarray:
        """A device mask as a host array: the wait for its queued work and
        the copy."""
        with torch.profiler.record_function("fetch"):
            return mask.cpu().numpy()

    def _finish(self, mask: np.ndarray, affine, save_fn) -> np.ndarray:
        """The uint8 {0, 255} mask of a fetched {0, 1} mask, written as
        NIfTI to ``save_fn`` (by rank 0 only on a mesh)."""
        with torch.profiler.record_function("finish"):
            pred = mask * np.uint8(255)
            if save_fn and self._writes:
                nifti.save(save_fn, pred, affine if affine is not None else np.eye(4))
            return pred

    def _segment_all(self, enqueue: Callable[[np.ndarray], torch.Tensor], volumes, affines,
                     save_fns, return_preds: bool, pipeline_depth: int):
        """``segment_volumes`` of both trainers over ``enqueue(volume)``, the
        {0, 1} device mask of one volume: up to ``pipeline_depth`` volumes
        queued on the device before the oldest mask is fetched (``volumes``
        consumed lazily); on a mesh of more than one rank, same-shaped
        volumes one per rank (:func:`ich_tpu_torch.parallel.
        volume_parallel_map`), every rank getting every mask."""
        if self.mesh is not None and self.mesh.size > 1:
            volumes = [np.asarray(v, dtype=np.float32) for v in volumes]
        if (self.mesh is not None and self.mesh.size > 1 and len(volumes) > 1
                and all(v.shape == volumes[0].shape for v in volumes)):
            masks = volume_parallel_map(enqueue, volumes, self.mesh)
        else:
            masks = fetch_pipelined((enqueue(v) for v in volumes), depth=max(1, pipeline_depth),
                                    fetch=self._fetch)
        preds: List[np.ndarray] = []
        for i, m in enumerate(masks):
            pred = self._finish(m, affines[i] if affines is not None else None,
                                save_fns[i] if save_fns is not None else None)
            if return_preds:
                preds.append(pred)
        return preds if return_preds else None

    def segment_volume(
        self,
        vol_data: np.ndarray,
        affine: Optional[np.ndarray] = None,
        save_fn: Optional[str] = None,
        window: Optional[Tuple[float, float]] = None,
        input_size: Tuple[int, int] = (256, 256),
        return_pred: bool = False,
    ):
        """Segment every slice of an (H, W, Z) volume. Returns a uint8
        {0, 255} volume if ``return_pred``; optionally writes NIfTI."""
        pred = self._finish(self._fetch(self._enqueue(vol_data, input_size, window)), affine,
                            save_fn)
        if return_pred:
            return pred

    segement_volume = segment_volume  # the reference's name

    def segment_volumes(
        self,
        volumes: Iterable[np.ndarray],
        affines: Optional[Sequence] = None,
        save_fns: Optional[Sequence[Optional[str]]] = None,
        window: Optional[Tuple[float, float]] = None,
        input_size: Tuple[int, int] = (256, 256),
        return_preds: bool = False,
        pipeline_depth: int = 4,
    ):
        """Pipelined multi-volume segmentation: up to ``pipeline_depth``
        volumes are queued on the device before the oldest result is
        fetched, so the device does not idle between volumes while its
        memory stays bounded. ``volumes`` is consumed lazily, except on a
        mesh of more than one rank, where same-shaped volumes go one per
        rank (:func:`ich_tpu_torch.parallel.volume_parallel_map`) and every
        rank returns every mask; only rank 0 writes files."""
        return self._segment_all(lambda v: self._enqueue(v, input_size, window), volumes,
                                 affines, save_fns, return_preds, pipeline_depth)

    # -- weights --------------------------------------------------------------

    def get_state_dict(self) -> Dict[str, torch.Tensor]:
        return self.unet.state_dict()

    def save_model(self, export_fn: str) -> None:
        ckpt.save_params(export_fn, self.unet.state_dict())

    def load_model(self, import_fn: str, image_shape: Tuple[int, ...] = (256, 256)) -> None:
        """Load weights written by :meth:`save_model`. ``image_shape`` is the
        JAX API's (its trainer builds its state from an example input); the
        port's net holds its parameters from construction, so it is
        accepted and not used."""
        self.unet.load_state_dict(ckpt.load_params(import_fn))

    def transfer_weights(self, source_state_dict: Dict[str, torch.Tensor],
                         verbose: bool = False) -> List[str]:
        """Key-intersection transfer from another model's ``state_dict``
        (reference ``UNet2D.py:316-337``); returns the keys moved. The port's
        net holds its parameters from construction, so the transfer applies
        at once where the JAX trainer defers it until its state exists."""
        src = {k: torch.as_tensor(v) for k, v in source_state_dict.items()}
        new, moved = ckpt.transfer_weights(self.unet.state_dict(), src, verbose)
        self.unet.load_state_dict(new)
        return moved

    def save_outputs(self, export_fn: str) -> None:
        save_json(export_fn, self.outputs)


TRAINERS.add("UNet2D", UNet2D)
