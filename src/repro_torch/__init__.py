"""PyTorch + CUDA port of the Hermes reproduction (``src/repro`` is the
untouched JAX reference).

The port runs the Level-B Hermes LM round (pod-stacked local training of
the dense GQA LM, the z-score gate, and the gated loss-weighted merge over
the ``none`` / ``fp16`` / ``int8`` / ``int4`` wires, synchronous or async)
and serving (prefill and greedy decode of the dense LMs, of the MoE LMs
with Multi-head Latent Attention, of RWKV6 and of the RecurrentGemma
hybrid; ``launch/steps.py`` builds the train, prefill and decode steps),
and checks itself with a static analyzer
(``analysis/``, ``launch/analyze.py``: a tile lint over the kernels'
launch specs and sources, a host-sync guard over the round loop).  Its
kernels are hand-written CUDA for ``sm_90a`` under ``kernels/csrc``:
the wire kernels (``wire_kernels.cu``), flash attention, WKV6 and the
RG-LRU (``model_kernels.cu``), and the analyzer's mis-tiled copy
(``fixture_kernels.cu``); every one has a plain PyTorch version beside
it that CPU tensors take.
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
