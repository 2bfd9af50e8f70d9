"""Accuracy metrics, computed on the tensors' device.

Counterpart of `atomai_tpu/losses_metrics/metrics.py:13-63`: mean IoU from
a confusion histogram of the whole batch, with no host round trip, so the
trainer can score each cycle without waiting. The histogram is an integer
``index_add_`` into a fixed number of bins: ``torch.bincount`` on a CUDA
tensor copies the input's maximum to the host to size its output, which
would stall every cycle.
"""

import torch


def iou_score(true: torch.Tensor, pred_logits: torch.Tensor,
              activation: bool = True, thresh: float = 0.5
              ) -> torch.Tensor:
    """Mean Jaccard index over classes, as a 0-d tensor.

    Args:
        true: ground truth (N, H, W): integer labels or a float binary mask.
        pred_logits: model output (N, H, W, C), channel-last.
        activation: apply softmax (C > 1) or sigmoid (C == 1) first.
        thresh: binarisation threshold of the one-class case.
    """
    nb = pred_logits.shape[-1]
    if nb > 1:
        probs = torch.softmax(pred_logits, dim=-1) if activation \
            else pred_logits
        pred = torch.argmax(probs, dim=-1)
        n_cls = nb
    else:
        probs = torch.sigmoid(pred_logits[..., 0]) if activation \
            else pred_logits[..., 0]
        pred = (probs > thresh).long()
        n_cls = 2
    true = true.long()
    valid_px = (true >= 0) & (true < n_cls)
    idx = torch.where(valid_px, n_cls * true + pred,
                      torch.full_like(true, n_cls * n_cls))
    idx = idx.reshape(-1)
    hist = torch.zeros(n_cls * n_cls + 1, dtype=torch.long,
                       device=idx.device).index_add_(0, idx,
                                                     torch.ones_like(idx))
    hist = hist[:n_cls * n_cls].reshape(n_cls, n_cls).float()
    inter = torch.diagonal(hist)
    union = hist.sum(1) + hist.sum(0) - inter
    jcd = inter / (union + 1e-10)
    valid = union > 0
    return torch.where(valid, jcd, torch.zeros_like(jcd)).sum() / \
        torch.clamp(valid.sum(), min=1)


class IoU:
    """Object-style wrapper: ``IoU(true, pred).evaluate()`` -> float."""

    def __init__(self, true: torch.Tensor, pred: torch.Tensor,
                 activation: bool = True, thresh: float = 0.5):
        self.true = true
        self.pred = pred
        self.activation = activation
        self.thresh = thresh

    def evaluate(self) -> float:
        return float(iou_score(self.true, self.pred, self.activation,
                               self.thresh))
