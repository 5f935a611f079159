"""Sequence-chunked cross-entropy, as ``repro/models/loss.py``.

With a 151,936-word vocabulary the (B, S, V) fp32 logits of a 4k-token
batch would take gigabytes, so the loss walks the sequence in chunks:
logits -> logsumexp -> gold logit per chunk.
"""
from __future__ import annotations

import torch


def chunked_cross_entropy(h, w, labels, *, chunk: int = 512):
    """h: (B,S,d); w: (d,V); labels: (B,S) int, negative = masked.
    Returns (mean_loss, num_target_tokens), both fp32 scalars."""
    B, S, _ = h.shape
    c = min(chunk, S)
    if S % c:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {c}")
    loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for s0 in range(0, S, c):
        hc, lc = h[:, s0:s0 + c], labels[:, s0:s0 + c]
        logits = (hc @ w).to(torch.float32)                   # (B,c,V)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc.clamp(min=0).long()[..., None])[..., 0]
        mask = (lc >= 0).to(torch.float32)
        loss_sum = loss_sum + ((lse - gold) * mask).sum()
        cnt = cnt + mask.sum()
    return loss_sum / cnt.clamp(min=1.0), cnt


def full_cross_entropy(logits, labels):
    """Reference for tests: logits (B,S,V), labels (B,S)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    return ((lse - gold) * mask).sum() / mask.sum().clamp(min=1.0)
