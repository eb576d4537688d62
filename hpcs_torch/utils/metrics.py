"""Classification metrics of logits against labels, on the logits' device."""
import torch


def accuracy_top1(logits, labels):
    return torch.mean((torch.argmax(logits, dim=-1) == labels).float())


def multiclass_jaccard(logits, labels, num_class):
    """Macro-averaged IoU over the classes present in the prediction or the
    target (classes absent from both are left out of the mean)."""
    preds = torch.argmax(logits, dim=-1)
    labels = labels.long()
    ones = torch.ones_like(labels, dtype=torch.float32)
    zeros = torch.zeros(num_class, device=logits.device)
    inter = zeros.index_add(0, labels, (preds == labels).float())
    union = zeros.index_add(0, labels, ones) + zeros.index_add(0, preds, ones) - inter
    present = union > 0
    iou = torch.where(present, inter / torch.clamp(union, min=1e-12), 0.0)
    return torch.sum(iou) / torch.clamp(torch.sum(present), min=1)
