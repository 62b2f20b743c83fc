"""PyTorch + CUDA port of the Hermes reproduction (``src/repro`` is the
untouched JAX reference).

This slice runs the synchronous Level-B Hermes LM round: pod-stacked local
training of the dense GQA LM, the z-score gate, and the gated loss-weighted
merge over the ``none``/``fp16``/``int4`` wire formats.  The four wire
kernels (int4 pack, unpack, packed dequant-merge and the fp32 merge) are
hand-written CUDA for ``sm_90a`` under ``kernels/csrc``; every one has a
plain PyTorch version beside it that CPU tensors take.
"""
import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller asks
    for the CPU explicitly.  A CUDA request without a card raises; there
    is no silent fallback to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev
