"""Hand-written CUDA kernels of the ring step (sources in csrc/), each with
its wrapper, its plain PyTorch version and its launch counter:

  K1 gather_rows   one-hot exchanges as exact gathers
  K2 cross_caps    Cross::canPass over each link's crosses
  K3 car_follow    isr_speed + min_chain, fused
  K4 ring_commit   shift-out + append of both rings, all channels

A wrapper runs the kernel on CUDA tensors and the plain version on CPU
tensors; the library is built at first use (kernels/_lib.py).
"""

from cityflow_tpu_torch.kernels import (
    car_follow, cross_caps, gather_rows, ring_commit)

MODULES = {"gather_rows": gather_rows, "cross_caps": cross_caps,
           "car_follow": car_follow, "ring_commit": ring_commit}


def reset_launches():
    for m in MODULES.values():
        m.launches = 0


def launch_counts():
    return {name: m.launches for name, m in MODULES.items()}
