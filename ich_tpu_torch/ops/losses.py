"""Objective functions (counterpart of :mod:`ich_tpu.ops.losses`).

Ported: the segmentation losses (``binary_dice_loss``, ``tversky_loss``,
``combo_loss``), DiscountedL1, the caller of the EDT kernel, the
contrastive losses of SSL pretraining (``info_nce_loss``,
``local_info_nce_loss`` with ``sample_region_cells``) and the
reconstruction losses (``mse_loss``, ``l1_loss``) and the classifier
losses (``softmax_cross_entropy``, ``weighted_bce_with_logits``), the
SN-PatchGAN's hinge losses (``hinge_d_loss``, ``hinge_g_loss``), the
autoencoder's gradient-difference loss (``gdl_loss``) and FCDD's
hypersphere loss (``hsc_loss``). Layout is NHWC, as in
the JAX package, and every loss computes in float32. The ``LOSSES``
registry carries them under the reference's class names.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ich_tpu_torch.ops.distance import distance_to_set
from ich_tpu_torch.parallel.mesh import all_gather
from ich_tpu_torch.utils import rng
from ich_tpu_torch.utils.config import LOSSES


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return torch.mean(x)
    if reduction == "sum":
        return torch.sum(x)
    if reduction == "none":
        return x
    raise ValueError(f"Unsupported reduction {reduction!r}")


def _batch_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over all non-batch axes."""
    return torch.sum(x.reshape(x.shape[0], -1), dim=1)


def binary_dice_loss(
    pred: torch.Tensor,
    mask: torch.Tensor,
    reduction: str = "mean",
    p: int = 2,
    alpha: float = 1.0,
    eps: float = 1.0,
) -> torch.Tensor:
    """1 - (2*sum(pred*mask)+eps)/(sum(pred^p)+sum(mask^p)+eps) per sample,
    multiplied by ``alpha`` where the mask is empty (reference
    ``LossFunctions.py:14-63``; alpha applied at ``:56``)."""
    pred = pred.to(torch.float32)
    mask = mask.to(torch.float32)
    inter = _batch_sum(pred * mask)
    union = _batch_sum(pred**p) + _batch_sum(mask**p)
    dl = 1.0 - (2.0 * inter + eps) / (union + eps)
    dl = torch.where(_batch_sum(mask) > 0, dl, alpha * dl)
    return _reduce(dl, reduction)


def tversky_loss(
    pred: torch.Tensor,
    mask: torch.Tensor,
    alpha: float = 1.0,
    beta: float = 0.5,
    gamma: float = 0.5,
    reduction: str = "mean",
    eps: float = 1.0,
) -> torch.Tensor:
    """1 - (TP+eps)/(TP + beta*FN + gamma*FP + eps), with the empty-mask
    alpha (reference ``LossFunctions.py:65-114``)."""
    pred = pred.to(torch.float32)
    mask = mask.to(torch.float32)
    tp = _batch_sum(pred * mask)
    fp = _batch_sum(pred * (1.0 - mask))
    fn = _batch_sum((1.0 - pred) * mask)
    tl = 1.0 - (tp + eps) / (tp + beta * fn + gamma * fp + eps)
    tl = torch.where(_batch_sum(mask) > 0, tl, alpha * tl)
    return _reduce(tl, reduction)


def combo_loss(
    pred: torch.Tensor,
    mask: torch.Tensor,
    alpha: float = 0.5,
    beta: float = 0.5,
    reduction: str = "mean",
    p: int = 1,
) -> torch.Tensor:
    """alpha * beta-weighted BCE (summed per sample) + (1-alpha) * Dice
    (Asgari et al.; reference ``LossFunctions.py:116-166``). ``pred`` is a
    probability (post-sigmoid)."""
    pred = pred.to(torch.float32)
    mask = mask.to(torch.float32)
    dice = binary_dice_loss(pred, mask, reduction="none", p=p)
    bce = -_batch_sum(
        beta * mask * torch.log(pred + 1e-14)
        + (1.0 - beta) * (1.0 - mask) * torch.log(1.0 - pred + 1e-14)
    )
    return _reduce(alpha * bce + (1.0 - alpha) * dice, reduction)


def discounted_l1_loss(
    rec: torch.Tensor,
    im: torch.Tensor,
    mask: torch.Tensor,
    gamma: float = 0.99,
    reduction: str = "mean",
) -> torch.Tensor:
    """Discounted L1 (Yu et al. 2018): L1 on the masked region, weighted
    ``gamma**dist`` where dist is the euclidean distance of each masked pixel
    to the nearest border pixel (border = 3x3 dilation of the mask minus the
    mask); weight 0 outside the mask. ``rec``/``im`` (B, H, W, C), ``mask``
    (B, H, W, 1)."""
    rec = rec.to(torch.float32)
    im = im.to(torch.float32)
    m2d = mask.to(torch.float32)[..., 0]  # (B, H, W)
    # max_pool2d pads with -inf, as reduce_window "SAME" does in JAX
    dil = F.max_pool2d(m2d[:, None], kernel_size=3, stride=1, padding=1)[:, 0]
    border = dil - m2d
    dist = distance_to_set(border)  # (B, H, W)
    weight = torch.pow(gamma, dist) * m2d
    l1 = torch.abs(rec - im) * weight[..., None]
    return _reduce(l1, reduction)


def _nt_xent(p: torch.Tensor, n: int, tau: float) -> torch.Tensor:
    """NT-Xent over the (..., 2n, D) embeddings ``p``, row i's positive the
    row n away: cosine similarities over ``tau``, the diagonal masked to
    float32's lowest value, ``logsumexp`` minus the positive, averaged."""
    p = p.to(torch.float32)
    pn = p / torch.clamp(torch.linalg.vector_norm(p, dim=-1, keepdim=True), min=1e-8)
    sim = pn @ pn.transpose(-1, -2) / tau
    idx = torch.arange(2 * n, device=p.device)
    pos_idx = torch.where(idx < n, idx + n, idx - n)
    pos = sim[..., idx, pos_idx]
    eye = torch.eye(2 * n, dtype=torch.bool, device=p.device)
    logz = torch.logsumexp(sim.masked_fill(eye, torch.finfo(torch.float32).min), dim=-1)
    return torch.mean(logz - pos)


def info_nce_loss(z1: torch.Tensor, z2: torch.Tensor, tau: float = 0.5,
                  mesh=None) -> torch.Tensor:
    """SimCLR NT-Xent (reference ``LossFunctions.py:168-230``). z1, z2: (N,
    D) two views; each of the 2N embeddings has its counterpart view as
    positive and every other embedding in its denominator. The mean over
    the 2N anchors, the reference's ``CrossEntropyLoss(reduction='sum') /
    (2N)``.

    With a ``mesh`` (:class:`ich_tpu_torch.parallel.Mesh`), each rank's
    rows are gathered over the mesh with gradient first, so that the
    negatives span the global batch and every rank computes the global
    loss. The gather's backward sums what every rank's loss sends to this
    rank's rows; after the trainer's gradient mean over the ranks the
    parameter gradient is the global loss's, so the loss is not divided
    again."""
    if mesh is not None:
        z1, z2 = all_gather(torch.cat([z1, z2], dim=1), mesh).split(z1.shape[1], dim=1)
    return _nt_xent(torch.cat([z1, z2], dim=0), z1.shape[0], tau)


def sample_region_cells(key: torch.Tensor, batch: int, grid_cells: int,
                        n_region: int) -> torch.Tensor:
    """``n_region`` distinct cells of ``grid_cells`` per batch element, the
    JAX package's draw: the first entries of ``permutation(split(key,
    batch)[i], grid_cells)``. int64 (batch, n_region) on the host."""
    return rng.permutation(rng.split(key, batch), grid_cells)[:, :n_region]


def local_info_nce_loss(
    f1: torch.Tensor,
    f2: torch.Tensor,
    key: Optional[torch.Tensor],
    tau: float = 0.5,
    K: int = 3,
    n_region: int = 13,
    cells: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Chaitanya-2020 local contrastive loss (reference
    ``LossFunctions.py:232-341``), batched. f1, f2: (B, H, W, C) feature
    maps of the two views. Each map is cut into its grid of KxK cells (the
    bottom and right strips that do not fill a cell dropped), ``n_region``
    cells are picked per batch element (the same in both views; drawn from
    ``key`` unless ``cells`` (B, n_region) is given), each flattened to
    K*K*C in (y, x, C) order, and an NT-Xent runs over the 2 * n_region
    regions within each batch element."""
    b, h, w, c = f1.shape
    gh, gw = h // K, w // K
    if gh * gw < n_region:
        raise ValueError(
            f"local_info_nce_loss: feature grid {gh}x{gw} has fewer cells "
            f"than n_region={n_region}; shrink n_region or K.")
    if cells is None:
        cells = sample_region_cells(key, b, gh * gw, n_region)
    cells = cells.to(f1.device)

    def regions(f):
        f = f[:, : gh * K, : gw * K, :]
        f = f.reshape(b, gh, K, gw, K, c).permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, K * K * c)
        return torch.gather(f, 1, cells[:, :, None].expand(b, n_region, K * K * c))

    return _nt_xent(torch.cat([regions(f1), regions(f2)], dim=1), n_region, tau)


def mse_loss(pred: torch.Tensor, target: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    return _reduce((pred.to(torch.float32) - target.to(torch.float32)) ** 2, reduction)


def l1_loss(pred: torch.Tensor, target: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    return _reduce(torch.abs(pred.to(torch.float32) - target.to(torch.float32)), reduction)


def weighted_bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                             pos_weight: float = 1.0) -> torch.Tensor:
    """Binary cross entropy on logits with the positive term weighted by
    ``pos_weight``, averaged over every element (the multilabel
    classifier's loss)."""
    logits = logits.to(torch.float32)
    labels = labels.to(torch.float32)
    return -torch.mean(pos_weight * labels * F.logsigmoid(logits)
                       + (1.0 - labels) * F.logsigmoid(-logits))


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          class_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross entropy of (B, K) logits against (B,) integer labels, softmax
    applied once; with ``class_weights`` (K,), each sample's term weighted
    by its class's weight and the sum divided by the sum of the weights
    used (at least 1e-8)."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    labels = labels.to(torch.long)
    nll = -torch.gather(logp, 1, labels[:, None])[:, 0]
    if class_weights is None:
        return torch.mean(nll)
    w = torch.as_tensor(class_weights, dtype=torch.float32, device=nll.device)[labels]
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1e-8)


def hinge_d_loss(d_real: torch.Tensor, d_fake: torch.Tensor) -> torch.Tensor:
    """SN-PatchGAN discriminator hinge loss (reference ``SNPatchGAN.py:168``):
    mean(relu(1 - D(real))) + mean(relu(1 + D(fake)))."""
    return (torch.mean(F.relu(1.0 - d_real.to(torch.float32)))
            + torch.mean(F.relu(1.0 + d_fake.to(torch.float32))))


def hinge_g_loss(d_fake: torch.Tensor) -> torch.Tensor:
    """Generator hinge term: -mean(D(fake)) (reference ``SNPatchGAN.py:185``)."""
    return -torch.mean(d_fake.to(torch.float32))


def gdl_loss(im: torch.Tensor, rec: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    """Gradient-difference loss (reference ``LossFunctions.py:411-448``):
    forward differences along H and W, zero-padded on the leading edge, of
    the channel sum (the reference's channel-repeated 3x3 kernels), their
    absolute values compared between ``im`` and ``rec`` and summed over
    (H, W) per sample. NHWC input."""

    def grads(x):
        s = torch.sum(x.to(torch.float32), dim=-1)  # (B, H, W)
        gh = s - F.pad(s, (1, 0))[:, :, :-1]  # d/dW
        gv = s - F.pad(s, (0, 0, 1, 0))[:, :-1, :]  # d/dH
        return torch.abs(gh), torch.abs(gv)

    ih, iv = grads(im)
    rh, rv = grads(rec)
    return _reduce(torch.sum(torch.abs(ih - rh) + torch.abs(iv - rv), dim=(1, 2)), reduction)


def hsc_loss(x: torch.Tensor, y: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    """FCDD's pseudo-Huber hypersphere loss (reference
    ``LossFunctions.py:450-470``): per sample the mean of ``sqrt(x^2 + 1) -
    1`` over the score map ``x`` (B, ...); a sample with label ``y == 1``
    (an anomaly) takes ``-log(1 - exp(-a) + 1e-31)`` of it instead."""
    x = x.to(torch.float32)
    a = torch.mean((torch.sqrt(x * x + 1.0) - 1.0).reshape(x.shape[0], -1), dim=-1)
    y = torch.as_tensor(y, device=a.device)
    loss = torch.where(y == 1, -torch.log(1.0 - torch.exp(-a) + 1e-31), a)
    return _reduce(loss, reduction)


def _factory(fn: Callable, **defaults) -> Callable:
    def make(**kwargs):
        cfg = {**defaults, **kwargs}
        cfg.pop("device", None)  # reference configs carry torch device strings
        return functools.partial(fn, **cfg)

    return make


LOSSES.add("BinaryDiceLoss", _factory(binary_dice_loss))
LOSSES.add("TverskyLoss", _factory(tversky_loss))
LOSSES.add("ComboLoss", _factory(combo_loss))
LOSSES.add("InfoNCELoss",
           lambda set_size=None, tau=0.5, **kw: functools.partial(info_nce_loss, tau=tau))
LOSSES.add("LocalInfoNCELoss", lambda tau=0.5, K=3, n_region=13, **kw: functools.partial(
    local_info_nce_loss, tau=tau, K=K, n_region=n_region))
LOSSES.add("DiscountedL1", _factory(discounted_l1_loss))
LOSSES.add("GDL", lambda reduction="mean", **kw: functools.partial(gdl_loss, reduction=reduction))
LOSSES.add("HSCLoss", _factory(hsc_loss))
LOSSES.add("MSELoss", _factory(mse_loss))
LOSSES.add("L1Loss", _factory(l1_loss))
# torch loss names used by the classification-pretraining configs
LOSSES.add("CrossEntropyLoss", lambda weight=None, **kw: functools.partial(
    softmax_cross_entropy,
    class_weights=torch.as_tensor(weight, dtype=torch.float32) if weight is not None else None))
LOSSES.add("BCEWithLogitsLoss", lambda pos_weight=1.0, **kw: functools.partial(
    weighted_bce_with_logits,
    pos_weight=float(pos_weight[0] if isinstance(pos_weight, (list, tuple)) else pos_weight)))
