"""Parallel-client FFT round, as ``repro/fl/parallel.py``: K selected
clients' local updates and the paper's Eq.-7 β-weighted aggregation in one
call.  Connection failures enter as β_i = 0 (Prop. 1's per-round view): a
failed client's update is masked, not branched on.

The JAX package vmaps the K local updates over a mesh's data axis; the port
runs them in a loop on one device, and folds each client's delta into one
fp32 accumulator per leaf as it goes, so K updated copies of the model are
never live at once.  The fold is Eq. 7 in delta form, exactly as the JAX
package computes it: w̄ = w_g + Σ_k β_k·bf16(w_k − w_g), the deltas rounded
to bf16 and the sum taken in fp32, then cast to the param's dtype.
"""
from __future__ import annotations

import torch

from repro_torch.launch.train import check_trainable, value_and_grad
from repro_torch.tree import tree_flatten, tree_unflatten


def make_fft_round_step(cfg, *, lr: float = 1e-3, loss_chunk: int = 512):
    """Returns fft_round(params, tokens (K,b,S), labels (K,b,S), beta (K,))
    -> (new_global_params, weighted_loss): one SGD step per client from
    ``params``, then the β-weighted fold.  β from FedAuto's QP (Module 2)
    with failed clients already zeroed, Σβ = 1."""
    check_trainable(cfg)

    def fft_round(params, tokens, labels, beta):
        leaves, spec = tree_flatten(params)
        beta = torch.as_tensor(beta, dtype=torch.float32,
                               device=leaves[0].device)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for k in range(tokens.shape[0]):
            loss, grads = value_and_grad(cfg, params, tokens[k], labels[k],
                                         loss_chunk=loss_chunk)
            with torch.no_grad():
                for a, p, g in zip(acc, leaves, tree_flatten(grads)[0]):
                    w = p.to(torch.float32)
                    client = (w - lr * g.to(torch.float32)).to(p.dtype)
                    delta = (client.to(torch.float32) - w).to(torch.bfloat16)
                    a.add_(beta[k] * delta.to(torch.float32))
                loss_sum = loss_sum + loss * beta[k]
            del grads
        with torch.no_grad():
            new = [(p.to(torch.float32) + a).to(p.dtype)
                   for p, a in zip(leaves, acc)]
        return tree_unflatten(spec, new), loss_sum

    return fft_round
