"""Inference and validation, the counterpart of ``raft_tpu/evaluate.py``'s
``FlowPredictor`` (with its serving entry points: per-request iterations
and early exit, warm start, the stream's encode and refine, the
step-granular refine), ``load_predictor``, golden fixtures, validators and
CLI, for RAFT-large, RAFT-small and the sparse-keypoint family
(``SparseRAFT``).

Inputs and outputs are numpy HWC arrays, as in the JAX package. Every entry
point runs on the CUDA card unless the caller passes ``device="cpu"``;
without a card and without that request it raises. On the card, TF32 is
turned off for convolutions and matmuls so the port computes in float32
like the reference.

Run the golden checks on the card (add ``--device cpu`` for the CPU;
``--mixed_precision`` runs RAFT-large under the bf16 policy, whose goldens
sit in the band of ``assets/golden/cpu_reference.json``):
    python -m raft_tpu_torch.evaluate --model assets/golden/weights.npz \
        --dataset golden
    python -m raft_tpu_torch.evaluate --small \
        --model assets/golden/weights_small.npz --dataset golden_small
    python -m raft_tpu_torch.evaluate --model_family sparse \
        --model assets/golden/sparse_tiny.npz --dataset golden
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.config import OursConfig, RAFTConfig
from raft_tpu_torch.data import frame_utils
from raft_tpu_torch.models.ours import SparseRAFT
from raft_tpu_torch.models.raft import RAFT, scatter_carry
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
      warm_iters: iterations of a warm stream frame
        (:meth:`refine_dispatch` with ``warm=True``); None means ``iters``.
      early_exit: ``(tol, patience)`` for the explicit-``iters`` path of
        :meth:`dispatch_batch` and the step-granular refine
        (:meth:`step_dispatch`), as ``RAFT.forward``'s.

    ``SparseRAFT`` runs with its config's correlation engine and refuses
    both levers and the canonical family's serving entry points; it pads
    nothing, as in JAX.

    The ``*_dispatch`` methods return device tensors without waiting for
    the card (CUDA's queue is the counterpart of JAX's asynchronous
    dispatch); the caller syncs when it reads them. The JAX predictor's
    compile cache, its keys, ``donate_images`` and its mesh paths have no
    meaning in eager PyTorch and are left out; sharded evaluation is not
    ported (ROADMAP.md).
    """

    def __init__(self, model, iters: int = 32,
                 batch_size: Optional[int] = None, device=None,
                 corr_impl: Optional[str] = None, update_impl: str = "step",
                 warm_iters: Optional[int] = None,
                 early_exit: Optional[Tuple[float, int]] = None):
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
        if warm_iters is not None and warm_iters < 1:
            raise ValueError(f"warm_iters must be >= 1, got {warm_iters}")
        if early_exit is not None:
            tol, patience = early_exit
            if not tol > 0.0:
                raise ValueError(f"early_exit tol must be > 0, got {tol}")
            if int(patience) < 1:
                raise ValueError(
                    f"early_exit patience must be >= 1, got {patience}")
            early_exit = (float(tol), int(patience))
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            use_float32_math()
        self.model = model.to(self.device).eval()
        self.iters = iters
        self.batch_size = batch_size
        self.update_impl = update_impl
        self.warm_iters = warm_iters
        self.early_exit = early_exit
        if not self.sparse:
            self.alternate_corr = (self.device.type == "cuda"
                                   if corr_impl == "auto"
                                   else model.config.alternate_corr)

    def _put(self, a) -> torch.Tensor:
        """A numpy array or tensor on the predictor's device."""
        if not torch.is_tensor(a):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(self.device)

    def _forward(self, images1, images2, **kwargs):
        with torch.inference_mode():
            if self.sparse:
                return self.model(self._put(images1), self._put(images2),
                                  iters=self.iters, test_mode=True)
            return self.model(
                self._put(images1),
                None if images2 is None else self._put(images2),
                alternate_corr=self.alternate_corr,
                update_impl=self.update_impl, **kwargs)

    def dispatch_batch(self, images1, images2, iters: Optional[int] = None):
        """(B, H, W, 3) stacks in [0, 255] (float32 or uint8), H and W
        multiples of 8 -> ``(flow_low (B, H/8, W/8, 2), flow_up (B, H, W,
        2))`` device tensors, without waiting for the card.

        ``iters``: this call's iteration count (None: ``self.iters``).
        With an explicit count and the predictor's ``early_exit`` set, the
        masked refine runs and a third tensor (B,) int32 holds each
        sample's iterations used."""
        if iters is None:
            return self._forward(images1, images2, iters=self.iters)
        if self.sparse:
            raise ValueError("per-request iters applies to the canonical "
                             "RAFT family only")
        if int(iters) < 1:
            raise ValueError(f"iters must be >= 1, got {iters}")
        return self._forward(images1, images2, iters=int(iters),
                             early_exit=self.early_exit)

    def predict_batch(self, images1, images2):
        """The blocking :meth:`dispatch_batch`: numpy float32 ``(flow_low,
        flow_up)``."""
        low, up = self.dispatch_batch(images1, images2)
        return low.cpu().numpy(), up.cpu().numpy()

    def __call__(self, image1: np.ndarray, image2: np.ndarray,
                 flow_init: Optional[np.ndarray] = None):
        """One (H, W, 3) pair -> ``(flow_low, flow_up)`` numpy;
        ``flow_init`` (H/8, W/8, 2) warm-starts the refinement."""
        if flow_init is None:
            low, up = self.predict_batch(image1[None], image2[None])
            return low[0], up[0]
        self._require_raft("warm-start")
        low, up = self._forward(image1[None], image2[None], iters=self.iters,
                                flow_init=self._put(flow_init)[None])
        return low[0].cpu().numpy(), up[0].cpu().numpy()

    # -- streams: encode each frame once, refine from cached maps ----------

    def _require_raft(self, what: str) -> None:
        if self.sparse:
            raise ValueError(f"the {what} path applies to the canonical "
                             "RAFT family only")

    def encode_dispatch(self, images) -> torch.Tensor:
        """``fnet`` alone: (B, H, W, 3) -> (B, H/8, W/8, C) device tensor.
        In a stream, frame t's map is pair t's ``fmap2`` and pair t+1's
        ``fmap1``."""
        self._require_raft("streaming encode")
        with torch.inference_mode():
            return self.model.encode_features(self._put(images))

    def refine_dispatch(self, images1, fmap1, fmap2, flow_init=None,
                        warm: bool = False, iters: Optional[int] = None):
        """The forward from encoded maps: (B, H, W, 3) first images (the
        context encoder's input) and (B, H/8, W/8, C) maps -> ``(flow_low,
        flow_up)`` device tensors. ``warm=True`` requires ``flow_init``
        (B, H/8, W/8, 2) and runs ``warm_iters`` (``iters`` when unset);
        a cold refine takes no ``flow_init``. ``iters`` overrides the
        count of a warm refine only."""
        self._require_raft("streaming refine")
        if warm and flow_init is None:
            raise ValueError("warm refine requires flow_init")
        if not warm and flow_init is not None:
            raise ValueError("cold refine takes no flow_init (warm=True "
                             "selects the warm refine)")
        if iters is not None and not warm:
            raise ValueError("per-request iters applies to warm refine "
                             "only; cold pairs keep the cold policy")
        if iters is not None and int(iters) < 1:
            raise ValueError(f"iters must be >= 1, got {iters}")
        if iters is None:
            iters = self.warm_iters if warm and self.warm_iters else self.iters
        return self._forward(
            images1, None, iters=int(iters), fmap1=self._put(fmap1),
            fmap2=self._put(fmap2),
            flow_init=None if flow_init is None else self._put(flow_init))

    # -- step-granular refine (continuous batching) ------------------------

    def step_carry_dispatch(self, images1, images2) -> dict:
        """A slot table over ``(slots, H, W, 3)`` stacks: ``refine_init``
        at full width, the carry of :meth:`step_dispatch`."""
        self._require_raft("continuous bootstrap")
        with torch.inference_mode():
            return self.model.refine_init(self._put(images1),
                                          self._put(images2),
                                          alternate_corr=self.alternate_corr)

    def step_admit_dispatch(self, images1, images2, idx, carry) -> dict:
        """Admit ``m`` requests, (m, H, W, 3) stacks, into slot rows
        ``idx`` of ``carry``: their ``refine_init`` scattered into a new
        carry (``scatter_carry``)."""
        self._require_raft("continuous admit")
        with torch.inference_mode():
            fresh = self.model.refine_init(self._put(images1),
                                           self._put(images2),
                                           alternate_corr=self.alternate_corr)
            return scatter_carry(carry, fresh, _host_ints(idx),
                                 int(carry["net"].shape[0]))

    def step_dispatch(self, carry: dict, remaining, steps: int):
        """``steps`` masked iterations over every slot; ``remaining``
        (slots,) is each slot's budget of mask-free iterations still owed,
        from the host. Slots out of budget (or early-exited, with the
        predictor's ``early_exit``) are frozen. Returns ``(carry',
        remaining')`` device values."""
        self._require_raft("continuous step")
        if int(steps) < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        with torch.inference_mode():
            return self.model.refine_chunk(carry, _host_ints(remaining),
                                           int(steps),
                                           self.early_exit, self.update_impl)

    def step_finalize_dispatch(self, carry: dict):
        """The mask-computing final iteration over every slot: ``(flow_low,
        flow_up)`` device tensors at the slot width; ``carry`` stays as it
        is for the slots still stepping. A request's ``k-1`` chunked
        iterations and this call give ``dispatch_batch(iters=k)``'s flow."""
        self._require_raft("continuous finalize")
        with torch.inference_mode():
            return self.model.refine_finalize(carry, self.update_impl)


def _host_ints(a) -> torch.Tensor:
    """A sequence or array of integers, or a tensor, as a tensor."""
    return a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))


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
    canonical torch RAFT's output with the fixture weights. ``variant``:
    "large" or "small", each with its own weights and golden outputs."""

    def __init__(self, root: str, variant: str = "large"):
        self.frames = osp.join(root, "demo-frames")
        self.golden = osp.join(root, "golden")
        with open(osp.join(self.golden, "manifest.json")) as f:
            self.manifest = json.load(f)
        if variant == "large":
            self.prefix, self.pairs = "flow_golden", self.manifest["pairs"]
        else:
            sub = self.manifest[variant]
            self.prefix, self.pairs = sub["prefix"], sub["pairs"]

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
        golden = np.load(osp.join(self.golden,
                                  f"{self.prefix}_{idx:02d}.npy"))
        return img1, img2, gt, golden


def validate_golden(predictor: FlowPredictor, root=None,
                    variant: str = "large") -> Dict[str, float]:
    """RAFT against the committed goldens of its size (``variant``
    "large" or "small"): ``golden_parity_epe`` (against the stored
    canonical torch outputs, float noise when right) and ``golden_gt_epe``
    (against the exact synthetic ground truth); the small variant's keys
    are ``golden_small_*``."""
    cfg = getattr(predictor.model, "config", None)
    if cfg is not None and hasattr(cfg, "small") and bool(
            cfg.small) != (variant == "small"):
        raise ValueError(
            f"golden variant {variant!r} vs model small={cfg.small}: the "
            "goldens are recorded per model size (use golden_small with "
            "the small model)")
    fixture = _GoldenFixture(root or ASSETS_DIR, variant)
    want = fixture.manifest["iters"]
    if predictor.iters != want:
        print(f"WARNING: golden outputs recorded at iters={want}, "
              f"predictor runs iters={predictor.iters}; parity EPE is "
              f"only meaningful at the recorded count")
    parity, gt_epes = [], []
    for _, sample, flow in _predict_dataset(predictor, fixture):
        parity.append(float(_epe_map(flow, sample[3]).mean()))
        gt_epes.append(float(_epe_map(flow, sample[2]).mean()))
    key = "golden" if variant == "large" else f"golden_{variant}"
    results = {f"{key}_parity_epe": float(np.mean(parity)),
               f"{key}_gt_epe": float(np.mean(gt_epes))}
    print(f"Validation Golden[{variant}]: parity EPE "
          f"{results[f'{key}_parity_epe']:.6f}, "
          f"GT EPE {results[f'{key}_gt_epe']:.4f}")
    return results


def validate_golden_small(predictor: FlowPredictor,
                          root=None) -> Dict[str, float]:
    """RAFT-small against its goldens; the predictor holds
    ``RAFT(RAFTConfig(small=True))`` with ``assets/golden/weights_small.npz``."""
    return validate_golden(predictor, root=root, variant="small")


_VALIDATORS = {"golden": validate_golden,
               "golden_small": validate_golden_small}


def run_validation(predictor: FlowPredictor, names) -> Dict[str, float]:
    """The validators of ``names`` (keys of ``_VALIDATORS``), results
    merged."""
    results: Dict[str, float] = {}
    for name in names:
        results.update(_VALIDATORS[name](predictor))
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


def load_torch_state(path: str) -> Dict[str, torch.Tensor]:
    """A torch ``.pth``/``.pt`` checkpoint of the reference as a state dict
    in float32: loaded on the CPU with ``weights_only=True``, a ``"model"``
    entry unwrapped, DataParallel's ``module.`` prefix stripped (as
    ``raft_tpu/utils/torch_convert.py`` reads them)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "model" in state:
        state = state["model"]
    return {(k[len("module."):] if k.startswith("module.") else k):
            (v.float() if v.is_floating_point() else v)
            for k, v in state.items()}


def load_predictor(model_path: str, iters: int = 32,
                   alternate_corr: bool = False,
                   corr_impl: Optional[str] = None,
                   device=None, update_impl: str = "step",
                   model_family: str = "raft",
                   config: Optional[OursConfig] = None,
                   seed: int = 0, small: bool = False,
                   mixed_precision: bool = False,
                   corr_dtype: Optional[str] = None) -> FlowPredictor:
    """A :class:`FlowPredictor` for RAFT-large, or RAFT-small with
    ``small=True``, from torch-named weights: a ``.npz`` archive or a
    reference ``.pth``/``.pt`` checkpoint (``load_torch_state``). An orbax
    run directory of the JAX package is refused: reading it needs JAX.
    ``corr_impl=None`` means ``"auto"``, or ``"fixed"`` when
    ``alternate_corr`` or ``corr_dtype`` asks for an engine or a storage
    explicitly. ``mixed_precision`` builds RAFT-large under the bf16 policy
    and ``corr_dtype`` ("float32", "bfloat16" or "auto") sets the all-pairs
    pyramid's storage (``RAFTConfig``); both take the same float32
    weights.

    ``model_family="sparse"`` builds ``SparseRAFT(config)`` (default
    ``OursConfig()``) with random weights from ``seed`` for
    ``model_path="random"`` (no sparse-family weights are published), or
    with the weights of a ``.npz`` archive (``load_sparse_npz``). The RAFT
    levers ``small``, ``alternate_corr``, ``corr_impl`` and
    ``update_impl`` refuse a sparse request."""
    if model_family not in MODEL_FAMILIES:
        raise ValueError(f"model_family must be one of {MODEL_FAMILIES}, "
                         f"got {model_family!r}")
    if corr_impl is None and (alternate_corr or corr_dtype is not None):
        corr_impl = "fixed"
    if model_family == "sparse":
        if small or corr_dtype is not None:
            raise ValueError("small and corr_dtype apply to the canonical "
                             "RAFT family only")
        if mixed_precision:
            raise NotImplementedError("the sparse family's bf16 policy is "
                                      "not ported yet (ROADMAP.md)")
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
    if model_path.endswith(".npz"):
        state = load_npz(model_path)
    elif model_path.endswith((".pth", ".pt")):
        state = load_torch_state(model_path)
    elif osp.isdir(model_path):
        raise ValueError(f"{model_path} is a directory: an orbax run "
                         "directory of the JAX package needs JAX to read; "
                         "the port loads torch-named .npz, .pth or .pt "
                         "weights")
    else:
        raise ValueError("the port loads torch-named .npz, .pth or .pt "
                         f"weights (got {model_path!r})")
    model = RAFT(RAFTConfig(small=small, alternate_corr=alternate_corr,
                            mixed_precision=mixed_precision,
                            corr_dtype=corr_dtype or "auto"))
    model.load_state_dict(state)
    return FlowPredictor(model, iters=iters, device=device,
                         corr_impl=corr_impl, update_impl=update_impl)


def main(argv=None) -> Dict[str, float]:
    parser = argparse.ArgumentParser(
        description="Validate RAFT-large, RAFT-small or the sparse family "
                    "with the PyTorch port.")
    parser.add_argument("--model", required=True,
                        help="torch-named .npz, .pth or .pt weights "
                             "('random' for the sparse family)")
    parser.add_argument("--model_family", default="raft",
                        choices=list(MODEL_FAMILIES),
                        help="raft: the goldens of assets/golden; sparse: "
                             "the JAX-made fixture sparse_tiny.npz")
    parser.add_argument("--dataset", required=True, choices=list(_VALIDATORS))
    parser.add_argument("--small", action="store_true",
                        help="RAFT-small (with --dataset golden_small)")
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
    parser.add_argument("--mixed_precision", action="store_true",
                        help="RAFT-large under the bf16 policy (bfloat16 "
                             "encoders, lookup and update block)")
    parser.add_argument("--corr_dtype", default=None,
                        choices=["float32", "bfloat16", "auto"],
                        help="storage dtype of the all-pairs pyramid "
                             "(pins corr_impl='fixed')")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.dataset == "golden_small" and not args.small:
        parser.error("--dataset golden_small compares against RAFT-small "
                     "goldens; pass --small (and the small weights)")
    if args.dataset == "golden" and args.small:
        parser.error("--dataset golden compares against RAFT-large "
                     "goldens; use --dataset golden_small for --small")
    if args.model_family == "sparse":
        if args.small:
            parser.error("--small applies to the canonical RAFT family only")
        return validate_sparse_golden(load_predictor(
            args.model, model_family="sparse", device=args.device))
    predictor = load_predictor(args.model, iters=args.iters,
                               alternate_corr=args.alternate_corr,
                               corr_impl=args.corr_impl,
                               device=args.device,
                               update_impl=args.update_impl,
                               small=args.small,
                               mixed_precision=args.mixed_precision,
                               corr_dtype=args.corr_dtype)
    return run_validation(predictor, [args.dataset])


if __name__ == "__main__":
    main()
