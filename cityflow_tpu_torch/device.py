"""Device choice of the port's entry points."""

import torch


def resolve_device(device=None) -> torch.device:
    """None means "cuda". Without a CUDA device that raises unless the
    caller asked for the CPU: an entry point never moves to the CPU on
    its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cityflow_tpu_torch: CUDA is not available; pass device='cpu' "
            "to run the plain PyTorch path on the CPU")
    return dev
