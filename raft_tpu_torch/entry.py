"""The port's single-card entry point, the counterpart of
``__graft_entry__.py``'s ``entry()``: RAFT-large's test-mode forward with
random weights and an example input.

    from raft_tpu_torch.entry import entry
    fn, args = entry()              # on the card; entry("cpu") on the CPU
    flow_up = fn(*args)             # (1, 96, 128, 2)
"""

from __future__ import annotations

import torch

from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.evaluate import resolve_device, use_float32_math
from raft_tpu_torch.models.raft import RAFT


def entry(device=None):
    """Return ``(fn, example_args)``: ``fn(image1, image2)`` runs
    RAFT-large (``iters=12``, weights from ``torch.manual_seed(0)``) in
    test mode and returns ``flow_up``; the example is a (1, 96, 128, 3)
    pair of zeros. On the CUDA card unless ``device`` says otherwise."""
    device = resolve_device(device)
    if device.type == "cuda":
        use_float32_math()
    torch.manual_seed(0)
    model = RAFT(RAFTConfig(iters=12)).to(device).eval()
    image1 = torch.zeros(1, 96, 128, 3, device=device)
    image2 = torch.zeros(1, 96, 128, 3, device=device)

    def fn(img1, img2):
        with torch.inference_mode():
            return model(img1, img2, alternate_corr=device.type == "cuda")[1]

    return fn, (image1, image2)
