"""Loss functions of the supervised trainers, channel-last.

Counterpart of `atomai_tpu/losses_metrics/losses.py:19-155`. The logits
keep the JAX package's channel-last layout (N, ..., C), so each loss takes
what its JAX counterpart takes; the trainer permutes the Unet's NCHW
output once. Segmentation targets are float masks (N, H, W) for one class
and integer masks (N, H, W) for several; regression targets are float
tensors.

Under a data mesh a rank holds its block of the batch. A loss that is a
mean of per-element terms is then the mean of the ranks' losses, which
the trainers take; the two that are not (``dice_loss`` sums over the
batch, ``focal_loss`` modulates the mean cross-entropy) reduce over the
global batch themselves (``core.mesh.batch_sum``) and say so with
``batch_global = True``.
"""

from typing import Any, Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F

from ..core.mesh import batch_sum, split_mean


def _bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                     reduction: str = "mean") -> torch.Tensor:
    """Numerically stable binary cross-entropy with logits."""
    loss = (torch.clamp(logits, min=0.0) - logits * labels +
            torch.log1p(torch.exp(-torch.abs(logits))))
    if reduction == "mean":
        return loss.mean()
    return loss


def focal_loss(prediction: torch.Tensor, labels: torch.Tensor,
               alpha: float = 0.5, gamma: float = 2.0,
               with_logits: bool = True) -> torch.Tensor:
    """Focal loss (arXiv:1708.02002) with the JAX package's quirk: the
    modulating factor applies to the *mean* cross-entropy, not per pixel
    (`atomai_tpu/losses_metrics/losses.py:29-43`)."""
    if prediction.ndim == labels.ndim + 1:
        prediction = prediction[..., 0]
    if with_logits:
        per_el = _bce_with_logits(prediction, labels, reduction="none")
    else:
        eps = 1e-12
        per_el = -(labels * torch.log(prediction + eps) +
                   (1 - labels) * torch.log(1 - prediction + eps))
    ce = split_mean(per_el.mean())
    pt = torch.exp(-ce)
    return alpha * (1 - pt) ** gamma * ce


def dice_loss(logits: torch.Tensor, labels: torch.Tensor,
              eps: float = 1e-7) -> torch.Tensor:
    """Sørensen–Dice loss, channel-last; one class is scored as the pair
    [foreground, background]."""
    num_classes = logits.shape[-1]
    if num_classes == 1:
        # [fg, bg] one-hot against [sigmoid, 1 - sigmoid]
        true_1_hot = F.one_hot(labels.long(), 2).flip(-1).to(logits.dtype)
        pos = torch.sigmoid(logits[..., 0])
        probas = torch.stack([pos, 1.0 - pos], dim=-1)
    else:
        true_1_hot = F.one_hot(labels.long(), num_classes).to(logits.dtype)
        probas = torch.softmax(logits, dim=-1)
    reduce_dims = tuple(range(probas.ndim - 1))
    intersection = batch_sum(probas * true_1_hot, reduce_dims)
    cardinality = batch_sum(probas + true_1_hot, reduce_dims)
    dice = torch.mean(2.0 * intersection / (cardinality + eps))
    return 1.0 - dice


focal_loss.batch_global = dice_loss.batch_global = True


def ce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy with integer labels (channel-last)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long().unsqueeze(-1)).mean()


def nll_loss(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Negative log-likelihood over log-probabilities (channel-last)."""
    return -log_probs.gather(-1, labels.long().unsqueeze(-1)).mean()


def mse_loss(prediction: torch.Tensor, target: torch.Tensor
             ) -> torch.Tensor:
    if prediction.ndim == target.ndim + 1 and prediction.shape[-1] == 1:
        prediction = prediction[..., 0]
    return torch.mean((prediction - target) ** 2)


def multitask_loss(outputs: Sequence[torch.Tensor],
                   labels: Sequence[torch.Tensor],
                   loss_fn: Callable = nll_loss,
                   weights: Optional[Sequence[float]] = None
                   ) -> torch.Tensor:
    """Weighted sum of per-task losses."""
    if weights is None:
        weights = [1.0] * len(outputs)
    if len(weights) != len(outputs):
        raise ValueError("The length of weights must match the number of "
                         "outputs")
    total = 0.0
    for w, o, lab in zip(weights, outputs, labels):
        total = total + w * loss_fn(o, lab)
    return total


class MultiTaskLoss:
    """Class-style multitask loss (``MultiTaskLoss(n)(outputs, labels)``)."""

    def __init__(self, num_tasks: int, loss_fn: Callable = nll_loss,
                 weights: Optional[Sequence[float]] = None):
        if weights is not None and len(weights) != num_tasks:
            raise ValueError("The length of weights must match num_tasks")
        self.num_tasks = num_tasks
        self.loss_fn = loss_fn
        self.weights = weights

    def __call__(self, outputs, labels):
        return multitask_loss(outputs, labels, self.loss_fn, self.weights)


def _bce_one_class(logits: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
    if logits.shape[-1] == 1 and logits.ndim == labels.ndim + 1:
        logits = logits[..., 0]
    return _bce_with_logits(logits, labels)


def select_loss(loss: Union[str, Callable],
                nb_classes: Optional[Any] = None, **kwargs: Any
                ) -> Callable:
    """String -> criterion(logits, targets) (counterpart of
    `atomai_tpu/losses_metrics/losses.py:114-155`); "ce" is
    binary cross-entropy with logits for one class."""
    if callable(loss):
        return loss
    if loss in ("ce", "multitask_nll", "multitask_ce") and nb_classes is None:
        raise ValueError("For cross-entropy loss function, you must "
                         "specify the number of classes")
    if loss == "dice":
        return dice_loss
    if loss == "focal":
        return focal_loss
    if loss == "ce":
        return _bce_one_class if nb_classes == 1 else ce_loss
    if loss == "nll":
        return nll_loss
    if loss in ("multitask_nll", "multitask_ce"):
        if not isinstance(nb_classes, (list, tuple)):
            raise ValueError("Provide number of classes for each task as "
                             "a list")
        fn = nll_loss if loss == "multitask_nll" else ce_loss
        return MultiTaskLoss(len(nb_classes), fn, kwargs.get("weights"))
    if loss == "mse":
        return mse_loss
    raise NotImplementedError(
        "Select Dice loss ('dice'), focal loss ('focal'), cross-entropy "
        "loss ('ce'), mean-squared error ('mse'), multitask loss "
        "('multitask_nll'/'multitask_ce') or pass a custom loss function")
