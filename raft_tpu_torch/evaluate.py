"""Inference and validation, the counterpart of ``raft_tpu/evaluate.py``'s
``FlowPredictor``, ``load_predictor``, golden fixture and CLI, for RAFT-large
and the sparse-keypoint family (``SparseRAFT``).

Inputs and outputs are numpy HWC arrays, as in the JAX package. Every entry
point runs on the CUDA card unless the caller passes ``device="cpu"``;
without a card and without that request it raises. On the card, TF32 is
turned off for convolutions and matmuls so the port computes in float32
like the reference.

Run the golden checks on the card (add ``--device cpu`` for the CPU):
    python -m raft_tpu_torch.evaluate --model assets/golden/weights.npz \
        --dataset golden
    python -m raft_tpu_torch.evaluate --model_family sparse \
        --model assets/golden/sparse_tiny.npz --dataset golden
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
from typing import Dict, Optional

import numpy as np
import torch

from raft_tpu_torch.config import OursConfig, RAFTConfig
from raft_tpu_torch.data import frame_utils
from raft_tpu_torch.models.ours import SparseRAFT
from raft_tpu_torch.models.raft import RAFT
from raft_tpu_torch.models.update import UPDATE_IMPLS
from raft_tpu_torch.weights import load_npz

ASSETS_DIR = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                      "assets")
SPARSE_GOLDEN = osp.join(ASSETS_DIR, "golden", "sparse_tiny.npz")
MODEL_FAMILIES = ("raft", "sparse")


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else the CUDA card; raises when neither is
    there (the port never falls back to the CPU on its own)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


def use_float32_math() -> None:
    """Turn TF32 off for cuDNN convolutions (on by default) and CUDA
    matmuls, so float32 stays float32 as in the reference."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


class FlowPredictor:
    """Test-mode forward of RAFT or ``SparseRAFT`` on one device.

    Args:
      model: a :class:`raft_tpu_torch.models.raft.RAFT` or
        :class:`raft_tpu_torch.models.ours.SparseRAFT` with its weights.
      iters: refinement iterations (``SparseRAFT`` takes and ignores it).
      batch_size: frames per forward in :func:`_predict_dataset` (1 by
        default).
      device: ``"cuda"``/``"cpu"``/a ``torch.device``; None means the card.
      corr_impl: ``"auto"`` (or None) runs the on-demand correlation (the
        CUDA kernel) on the card and the all-pairs pyramid on the CPU;
        ``"fixed"`` uses ``model.config.alternate_corr`` as given. The
        engine depends on the device, not the image shape: PyTorch runs
        eagerly, so there is no per-shape executable to keep.
      update_impl: ``"step"`` (default) runs each refine iteration as one
        launch of the step kernel; ``"chain"`` runs the motion kernel and
        then the GRU kernel (the counterpart of ``RAFT_STEP_PALLAS=auto``
        and ``=0``). On the CPU both run the plain versions.

    ``SparseRAFT`` runs with its config's correlation engine and refuses
    both levers; it pads nothing, as in JAX.
    """

    def __init__(self, model, iters: int = 32,
                 batch_size: Optional[int] = None, device=None,
                 corr_impl: Optional[str] = None, update_impl: str = "step"):
        self.sparse = isinstance(model, SparseRAFT)
        if self.sparse and (corr_impl is not None or update_impl != "step"):
            raise ValueError("alternate_corr, corr_impl and update_impl "
                             "apply to the canonical RAFT family only; the "
                             "sparse family is built from its own config")
        corr_impl = "auto" if corr_impl is None else corr_impl
        if corr_impl not in ("fixed", "auto"):
            raise ValueError(f"corr_impl must be 'fixed' or 'auto', "
                             f"got {corr_impl!r}")
        if update_impl not in UPDATE_IMPLS:
            raise ValueError(f"update_impl must be one of {UPDATE_IMPLS}, "
                             f"got {update_impl!r}")
        if iters < 1:
            raise ValueError(f"iters must be >= 1, got {iters}")
        batch_size = 1 if batch_size is None else batch_size
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            use_float32_math()
        self.model = model.to(self.device).eval()
        self.iters = iters
        self.batch_size = batch_size
        self.update_impl = update_impl
        if not self.sparse:
            self.alternate_corr = (self.device.type == "cuda"
                                   if corr_impl == "auto"
                                   else model.config.alternate_corr)

    def predict_batch(self, images1: np.ndarray, images2: np.ndarray):
        """(B, H, W, 3) stacks in [0, 255] (float32 or uint8), H and W
        multiples of 8 -> ``(flow_low (B, H/8, W/8, 2), flow_up
        (B, H, W, 2))`` numpy float32."""
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        with torch.inference_mode():
            if self.sparse:
                low, up = self.model(put(images1), put(images2),
                                     iters=self.iters, test_mode=True)
            else:
                low, up = self.model(put(images1), put(images2),
                                     iters=self.iters,
                                     alternate_corr=self.alternate_corr,
                                     update_impl=self.update_impl)
            return low.cpu().numpy(), up.cpu().numpy()

    def __call__(self, image1: np.ndarray, image2: np.ndarray):
        """One (H, W, 3) pair -> ``(flow_low, flow_up)``."""
        low, up = self.predict_batch(image1[None], image2[None])
        return low[0], up[0]


def _predict_dataset(predictor: FlowPredictor, dataset):
    """Yield ``(idx, sample, flow_up)`` per element (frames already a
    multiple of 8), in batches of ``predictor.batch_size`` grouped by
    shape; a short batch is filled by repeating its last frame."""
    bs = predictor.batch_size

    def flush(batch):
        i1 = np.stack([sample[0] for _, sample in batch])
        i2 = np.stack([sample[1] for _, sample in batch])
        if len(batch) < bs:
            reps = bs - len(batch)
            i1 = np.concatenate([i1, np.repeat(i1[-1:], reps, 0)])
            i2 = np.concatenate([i2, np.repeat(i2[-1:], reps, 0)])
        _, up = predictor.predict_batch(i1, i2)
        for j, (idx, sample) in enumerate(batch):
            yield idx, sample, up[j]

    buckets: Dict = {}
    for idx in range(len(dataset)):
        sample = dataset[idx]
        shape = sample[0].shape
        buckets.setdefault(shape, []).append((idx, sample))
        if len(buckets[shape]) == bs:
            yield from flush(buckets.pop(shape))
    for batch in buckets.values():
        yield from flush(batch)


def _epe_map(flow: np.ndarray, flow_gt: np.ndarray) -> np.ndarray:
    return np.sqrt(np.sum((flow - flow_gt) ** 2, axis=-1))


class _GoldenFixture:
    """The repo's golden fixtures (``assets/``): item ``idx`` is
    ``(image1, image2, flow_gt, flow_golden)``, where ``flow_golden`` is the
    canonical torch RAFT's output with the fixture weights."""

    def __init__(self, root: str):
        self.frames = osp.join(root, "demo-frames")
        self.golden = osp.join(root, "golden")
        with open(osp.join(self.golden, "manifest.json")) as f:
            self.manifest = json.load(f)
        self.pairs = self.manifest["pairs"]

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx):
        pair = self.pairs[idx]
        img1 = np.asarray(frame_utils.read_gen(
            osp.join(self.frames, pair["frame1"])), np.float32)
        img2 = np.asarray(frame_utils.read_gen(
            osp.join(self.frames, pair["frame2"])), np.float32)
        gt = frame_utils.read_flo(
            osp.join(self.golden, f"flow_gt_{idx:02d}.flo"))
        golden = np.load(osp.join(self.golden, f"flow_golden_{idx:02d}.npy"))
        return img1, img2, gt, golden


def validate_golden(predictor: FlowPredictor, root=None) -> Dict[str, float]:
    """RAFT-large against the committed goldens: ``golden_parity_epe``
    (against the stored canonical torch outputs, float noise when right)
    and ``golden_gt_epe`` (against the exact synthetic ground truth)."""
    fixture = _GoldenFixture(root or ASSETS_DIR)
    want = fixture.manifest["iters"]
    if predictor.iters != want:
        print(f"WARNING: golden outputs recorded at iters={want}, "
              f"predictor runs iters={predictor.iters}; parity EPE is "
              f"only meaningful at the recorded count")
    parity, gt_epes = [], []
    for _, sample, flow in _predict_dataset(predictor, fixture):
        parity.append(float(_epe_map(flow, sample[3]).mean()))
        gt_epes.append(float(_epe_map(flow, sample[2]).mean()))
    results = {"golden_parity_epe": float(np.mean(parity)),
               "golden_gt_epe": float(np.mean(gt_epes))}
    print(f"Validation Golden[large]: parity EPE "
          f"{results['golden_parity_epe']:.6f}, "
          f"GT EPE {results['golden_gt_epe']:.4f}")
    return results


def validate_sparse_golden(predictor: FlowPredictor,
                           path: str = SPARSE_GOLDEN) -> Dict[str, float]:
    """``SparseRAFT`` against the JAX package on the fixture's seeded pair:
    ``sparse_parity_epe``, the mean end-point distance of the predictor's
    flow from JAX's (float noise when the predictor holds the fixture's
    weights)."""
    with np.load(path) as z:
        img1, img2 = (z[k].astype(np.float32) for k in ("image1", "image2"))
        want = z["flow_up"]
    _, flow = predictor(img1, img2)
    results = {"sparse_parity_epe": float(_epe_map(flow, want).mean())}
    print(f"Validation Golden[sparse]: parity EPE "
          f"{results['sparse_parity_epe']:.6f}")
    return results


def load_sparse_npz(path: str, config: Optional[OursConfig] = None):
    """``(config, state dict)`` from a ``.npz`` archive of ``SparseRAFT``:
    either a state dict as ``weights.state_dict_to_npz`` writes it (the
    config is ``config``, else ``OursConfig()``), or an archive that also
    names its config, whose weights are the entries ``weights.<key>`` and
    whose ``config`` entry holds the config's fields as JSON (the layout
    of ``assets/golden/sparse_tiny.npz``)."""
    with np.load(path) as z:
        if "config" not in z.files:
            return config or OursConfig(), load_npz(path)
        cfg = OursConfig(**json.loads(str(z["config"])))
        state = {k[len("weights."):]: torch.from_numpy(
            np.asarray(z[k], np.float32))
            for k in z.files if k.startswith("weights.")}
    if config is not None and config != cfg:
        raise ValueError(f"{path} holds the config {cfg}, not {config}")
    return cfg, state


def load_predictor(model_path: str, iters: int = 32,
                   alternate_corr: bool = False,
                   corr_impl: Optional[str] = None,
                   device=None, update_impl: str = "step",
                   model_family: str = "raft",
                   config: Optional[OursConfig] = None,
                   seed: int = 0) -> FlowPredictor:
    """A :class:`FlowPredictor` for RAFT-large from a torch-named ``.npz``
    archive. ``corr_impl=None`` means ``"auto"``, or ``"fixed"`` when
    ``alternate_corr`` asks for an engine explicitly.

    ``model_family="sparse"`` builds ``SparseRAFT(config)`` (default
    ``OursConfig()``) with random weights from ``seed`` for
    ``model_path="random"`` (no sparse-family weights are published), or
    with the weights of a ``.npz`` archive (``load_sparse_npz``). The RAFT
    levers ``alternate_corr``, ``corr_impl`` and ``update_impl`` refuse a
    sparse request (in :class:`FlowPredictor`)."""
    if model_family not in MODEL_FAMILIES:
        raise ValueError(f"model_family must be one of {MODEL_FAMILIES}, "
                         f"got {model_family!r}")
    if corr_impl is None and alternate_corr:
        corr_impl = "fixed"
    if model_family == "sparse":
        if model_path == "random":
            model = SparseRAFT(config or OursConfig())
            model.init_weights(torch.Generator().manual_seed(seed))
        elif model_path.endswith(".npz"):
            cfg, state = load_sparse_npz(model_path, config)
            model = SparseRAFT(cfg)
            model.load_state_dict(state)
        else:
            raise ValueError("the sparse family loads 'random' or a .npz "
                             f"archive (got {model_path!r})")
        return FlowPredictor(model, iters=iters, device=device,
                             corr_impl=corr_impl, update_impl=update_impl)
    if config is not None:
        raise ValueError("config is the sparse family's OursConfig")
    if not model_path.endswith(".npz"):
        raise ValueError("the port loads torch-named .npz archives only "
                         f"(got {model_path!r})")
    model = RAFT(RAFTConfig(alternate_corr=alternate_corr))
    model.load_state_dict(load_npz(model_path))
    return FlowPredictor(model, iters=iters, device=device,
                         corr_impl=corr_impl, update_impl=update_impl)


def main(argv=None) -> Dict[str, float]:
    parser = argparse.ArgumentParser(
        description="Validate RAFT-large or the sparse family with the "
                    "PyTorch port.")
    parser.add_argument("--model", required=True,
                        help="torch-named .npz weights ('random' for the "
                             "sparse family)")
    parser.add_argument("--model_family", default="raft",
                        choices=list(MODEL_FAMILIES),
                        help="raft: the goldens of assets/golden; sparse: "
                             "the JAX-made fixture sparse_tiny.npz")
    parser.add_argument("--dataset", required=True, choices=["golden"])
    parser.add_argument("--iters", type=int, default=12,
                        help="refinement iterations (the goldens are "
                             "recorded at 12)")
    parser.add_argument("--alternate_corr", action="store_true")
    parser.add_argument("--corr_impl", default=None,
                        choices=["fixed", "auto"])
    parser.add_argument("--update_impl", default="step",
                        choices=list(UPDATE_IMPLS),
                        help="refine iteration: one step-kernel launch "
                             "(default) or the motion then GRU kernels")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.model_family == "sparse":
        return validate_sparse_golden(load_predictor(
            args.model, model_family="sparse", device=args.device))
    predictor = load_predictor(args.model, iters=args.iters,
                               alternate_corr=args.alternate_corr,
                               corr_impl=args.corr_impl,
                               device=args.device,
                               update_impl=args.update_impl)
    return validate_golden(predictor)


if __name__ == "__main__":
    main()
