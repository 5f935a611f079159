"""PyTorch/CUDA port of the FedAuto reproduction (``repro``).

The package mirrors ``repro``'s module layout (``kernels``, ``models``,
``core``, ``fl``, ``fl.comm``, ``fl.server``, ``data``, ``obs``, ``launch``)
and runs in PyTorch the federated fine-tuning round (LoRA included) under
the synchronous, async and buffered servers, the scenario worlds and the
adaptive codec controller, LLM training, and the forward and serving of
every architecture of the JAX zoo (dense GQA, the Mamba2 hybrid, xLSTM,
MoE, MLA, the encoder-decoder and the VLM prefix), with every Pallas
kernel of ``repro`` rewritten as a hand-written CUDA kernel for Hopper
(``sm_90a``).

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; nothing falls back to the CPU on its own.  It imports
``torch`` and ``numpy`` only.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device on a machine without
    one (callers that want the CPU say so with ``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available on this machine; pass "
                           "device='cpu' to run on the CPU")
    return dev
