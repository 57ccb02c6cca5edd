"""Canonical RAFT, large and small, the counterpart of
``raft_tpu/models/raft.py``'s ``RAFT`` and its step-granular refine
functions: inference (its ``test_mode=True``), the serving entry points
and the training forward.

Images in [0, 255] NHWC; both go through ``fnet`` in one pass (batch
concatenation), ``cnet`` splits into the tanh hidden state and the ReLU
context. In test mode, ``iters - 1`` refinement iterations without the mask
head and one final iteration with it, whose mask drives the convex 8x
upsampling (RAFT-small has no mask head and upsamples with ``upflow8``).
In training (``train=True``) every iteration runs the mask head (none in
RAFT-small) and upsamples, the coordinates are detached at the start of
each iteration, and the stacked predictions come back for
``sequence_loss``.

RAFT-large on the card runs each iteration as one launch of the step
kernel (``ops/step_cuda.py``) after the lookup, or, with
``update_impl="chain"``, the motion kernel followed by the GRU kernel;
every kernel is differentiable. RAFT-small's update block is cuDNN
convolutions (the reference has no kernel for it either); its lookup, at
radius 3, is the corr kernel. The correlation engine is the materialised
all-pairs pyramid or the on-demand lookup (``alternate_corr``), whose CUDA
path is the kernels of ``ops/corr_cuda.py``.

Mixed precision (``RAFTConfig.mixed_precision``, RAFT-large and
RAFT-small): the encoders and the update block compute in bfloat16 with
float32 parameters, in inference and in training, on either
``update_impl``; the correlation payload follows
``RAFTConfig.corr_storage`` (the all-pairs pyramid's storage) and
``corr_mxu`` (the on-demand lookup's products, which emits bfloat16
windows), each resolved for inference or training as in the JAX package;
coordinates, flow, the upsampled predictions and the early exit's norms
stay float32, and every output comes back float32. On the card a training
forward runs the bf16 corr kernel and the bf16 step kernel (or the bf16
motion and GRU kernels), and their backwards (the bf16 corr backward
kernel, the bfloat16 recompute of the update kernels) give the float32
parameters their gradients.

Serving: ``early_exit=(tol, patience)`` freezes each sample once its
low-res update has stayed small; ``encode_features`` and the
``fmap1``/``fmap2`` arguments let a stream encode each frame once;
``refine_init``, ``scatter_carry``, ``refine_chunk`` and
``refine_finalize`` drive the refinement in chunks over a table of slots
(continuous batching). The early-exit state stays on the device: no
iteration reads anything back to the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.models.corr import (alternate_lookup, build_corr_pyramid,
                                        build_feature_pyramid, pyramid_lookup)
from raft_tpu_torch.models.extractor import BasicEncoder, SmallEncoder
from raft_tpu_torch.models.normalize import normalize_image
from raft_tpu_torch.models.update import BasicUpdateBlock, SmallUpdateBlock
from raft_tpu_torch.ops.sampling import convex_upsample, coords_grid, upflow8


def _upsample(flow_low: torch.Tensor, mask) -> torch.Tensor:
    """Convex upsampling by the mask head's logits, or ``upflow8`` where
    there is no mask head (RAFT-small)."""
    return upflow8(flow_low) if mask is None else convex_upsample(flow_low,
                                                                  mask)


def _delta_norm(delta: torch.Tensor) -> torch.Tensor:
    """Per-sample mean L2 norm of a low-res update (B, H, W, 2) -> (B,):
    the early exit's convergence signal."""
    d = delta.float()
    return torch.sqrt((d * d).sum(-1).mean(dim=(1, 2)))


def _freeze(keep: torch.Tensor, old: torch.Tensor,
            new: torch.Tensor) -> torch.Tensor:
    """``old`` where the per-sample flag ``keep`` (B,) is set, else
    ``new``."""
    return torch.where(keep.view(-1, *([1] * (old.dim() - 1))), old, new)


class RAFT(nn.Module):
    """RAFT-large or RAFT-small (``config.small``); float32, or under the
    bf16 mixed-precision policy (``config.mixed_precision``)."""

    def __init__(self, config: RAFTConfig = RAFTConfig()):
        super().__init__()
        if config.normalized_coords:
            raise ValueError("normalized_coords is not supported by the "
                             "canonical RAFT path")
        self.config = config
        self.compute_dtype = getattr(torch, config.compute_dtype)
        win = 2 * config.radius + 1
        corr_channels = config.corr_levels * win * win
        if config.small:
            self.fnet = SmallEncoder(128, "instance", config.dropout)
            self.cnet = SmallEncoder(config.hdim + config.cdim, "none",
                                     config.dropout)
            self.update_block = SmallUpdateBlock(config.hdim, config.cdim,
                                                 corr_channels)
        else:
            self.fnet = BasicEncoder(config.fnet_dim, "instance",
                                     config.dropout)
            self.cnet = BasicEncoder(config.hdim + config.cdim, "batch",
                                     config.dropout)
            self.update_block = BasicUpdateBlock(config.hdim, config.cdim,
                                                 corr_channels)

    # -- the prologue: encoders, correlation state, context ---------------

    def encode_features(self, image: torch.Tensor) -> torch.Tensor:
        """``fnet`` alone, inference mode: (B, H, W, 3) in [0, 255] ->
        (B, H/8, W/8, C). A stream encodes each frame once and hands the
        maps to ``forward``'s ``fmap1``/``fmap2``. Instance norm is per
        sample, so this equals ``forward``'s two-image pass up to float
        summation order."""
        return self.fnet(normalize_image(image, self.compute_dtype), False)

    def _prologue(self, image1, image2, fmap1, fmap2, alternate_corr,
                  norm_train: bool, inference: bool):
        """Encoders, correlation payload and context: ``(payload, net,
        inp, coords0)``. The payload is the all-pairs pyramid, a tuple of
        levels (B*H8*W8, h, w) stored in ``corr_storage(inference)``, or
        for the on-demand engine ``(fmap1, pooled fmap2 levels)`` in the
        compute dtype, as in the JAX package."""
        cfg = self.config
        if (fmap1 is None) != (fmap2 is None):
            raise ValueError("fmap1 and fmap2 must be given together")
        if alternate_corr is None:
            alternate_corr = cfg.alternate_corr
        image1 = normalize_image(image1, self.compute_dtype)
        with record_function("raft.encoders"):
            if fmap1 is None:
                fmap1, fmap2 = self.fnet(
                    torch.cat([image1,
                               normalize_image(image2, self.compute_dtype)]),
                    norm_train).chunk(2)
            else:
                fmap1 = fmap1.to(self.compute_dtype)
                fmap2 = fmap2.to(self.compute_dtype)
            cnet = self.cnet(image1, norm_train)
        if alternate_corr:
            payload = (fmap1.contiguous(),
                       build_feature_pyramid(fmap2, cfg.corr_levels))
        else:
            payload = build_corr_pyramid(fmap1, fmap2, cfg.corr_levels,
                                         cfg.corr_scale,
                                         cfg.corr_storage(inference))
        net = torch.tanh(cnet[..., :cfg.hdim]).contiguous()
        inp = torch.relu(cnet[..., cfg.hdim:]).contiguous()
        B, H8, W8, _ = fmap1.shape
        return payload, net, inp, coords_grid(B, H8, W8, device=fmap1.device)

    def _lookup(self, payload, coords: torch.Tensor,
                inference: bool = True) -> torch.Tensor:
        """The windowed lookup at ``coords`` through the engine that built
        ``payload`` (see ``_prologue``), in the compute dtype. The on-demand
        lookup multiplies in ``corr_mxu(inference)``."""
        cfg = self.config
        if len(payload) == 2 and isinstance(payload[1], tuple):
            return alternate_lookup(payload[0], payload[1],
                                    coords.contiguous(), cfg.radius,
                                    cfg.corr_scale,
                                    mxu_dtype=cfg.corr_mxu(inference),
                                    out_dtype=self.compute_dtype)
        return pyramid_lookup(payload, coords,
                              cfg.radius).to(self.compute_dtype)

    def _iteration(self, payload, net, inp, coords0, coords1, last: bool,
                   update_impl: str, inference: bool = True):
        """One refinement iteration: ``(net, mask or None, delta_flow)``;
        the mask head runs only when ``last``. The update block takes the
        flow in the compute dtype; the mask and delta come back float32."""
        net, mask, delta = self.update_block(
            net, inp, self._lookup(payload, coords1, inference),
            (coords1 - coords0).to(self.compute_dtype),
            compute_mask=True if last else None, update_impl=update_impl)
        return net, None if mask is None else mask.float(), delta.float()

    # -- the whole forward ------------------------------------------------

    def forward(self, image1: torch.Tensor, image2: Optional[torch.Tensor],
                iters: Optional[int] = None,
                flow_init: Optional[torch.Tensor] = None,
                alternate_corr: Optional[bool] = None,
                update_impl: str = "step", train: bool = False,
                freeze_bn: bool = False,
                fmap1: Optional[torch.Tensor] = None,
                fmap2: Optional[torch.Tensor] = None,
                early_exit: Optional[Tuple[float, int]] = None):
        """``image1``/``image2`` (B, H, W, 3) in [0, 255]; ``flow_init``
        (B, H/8, W/8, 2) or None; ``alternate_corr`` overrides the config's
        engine; ``update_impl`` picks the refine iteration's kernels
        (``BasicUpdateBlock.forward``). Returns ``(flow_low (B, H/8, W/8,
        2), flow_up (B, H, W, 2))``, or with ``train=True`` every
        iteration's upsampled flow stacked as (iters, B, H, W, 2).
        ``train`` also normalises ``cnet`` with batch statistics and updates
        its running ones, unless ``freeze_bn`` keeps them fixed (the
        reference's freeze after the chairs stage).

        ``fmap1``/``fmap2``: feature maps from ``encode_features`` (both or
        neither); with them ``fnet`` does not run and ``image2`` may be
        None.

        ``early_exit=(tol, patience)`` (test mode only): a sample whose
        mean low-res update norm has stayed below ``tol`` for ``patience``
        iterations in a row is frozen from the next iteration on. Every
        iteration still runs for the whole batch. The return gains
        ``iters_used`` (B,) int32, the iterations each sample consumed,
        the final mask-computing one included.
        """
        cfg = self.config
        iters = cfg.iters if iters is None else iters
        if iters < 1:
            raise ValueError(f"iters must be >= 1, got {iters}")
        if early_exit is not None and train:
            raise ValueError("early_exit is a test-mode-only knob")
        payload, net, inp, coords0 = self._prologue(
            image1, image2, fmap1, fmap2, alternate_corr,
            train and not freeze_bn, not train)
        coords1 = coords0 if flow_init is None else coords0 + flow_init

        if train:
            predictions = []
            for _ in range(iters):
                coords1 = coords1.detach()
                net, mask, delta_flow = self._iteration(
                    payload, net, inp, coords0, coords1, True, update_impl,
                    inference=False)
                coords1 = coords1 + delta_flow
                predictions.append(_upsample(coords1 - coords0, mask))
            return torch.stack(predictions)

        if early_exit is not None:
            tol, patience = early_exit
            B = net.shape[0]
            consec = torch.zeros(B, dtype=torch.int32, device=net.device)
            done = torch.zeros(B, dtype=torch.bool, device=net.device)
            used = torch.zeros_like(consec)
        for _ in range(iters - 1):
            net_new, _, delta_flow = self._iteration(
                payload, net, inp, coords0, coords1, False, update_impl)
            coords_new = coords1 + delta_flow
            if early_exit is None:
                net, coords1 = net_new, coords_new
                continue
            below = _delta_norm(delta_flow) < tol
            consec = torch.where(done, consec,
                                 torch.where(below, consec + 1, 0))
            # freeze on the previous done flag: the iteration on which a
            # sample converges still applies its update
            net = _freeze(done, net, net_new)
            coords1 = _freeze(done, coords1, coords_new)
            used = used + (~done).int()
            done = done | (consec >= patience)
        net, mask, delta_flow = self._iteration(
            payload, net, inp, coords0, coords1, True, update_impl)
        flow_low = coords1 + delta_flow - coords0
        flow_up = _upsample(flow_low, mask)
        if early_exit is None:
            return flow_low, flow_up
        return flow_low, flow_up, used + 1

    # -- the step-granular refine (continuous batching) ---------------------

    def refine_init(self, image1: torch.Tensor,
                    image2: Optional[torch.Tensor] = None,
                    fmap1: Optional[torch.Tensor] = None,
                    fmap2: Optional[torch.Tensor] = None,
                    flow_init: Optional[torch.Tensor] = None,
                    alternate_corr: Optional[bool] = None) -> dict:
        """The refinement loop's prologue (inference) as a carry of
        tensors, the slot table of the step-granular scheduler, with the
        JAX package's keys: ``net``, ``inp``, ``coords0``, ``coords1``,
        ``corr`` (the engine's payload, see ``_prologue``), and the
        per-slot early-exit state ``consec``, ``done``, ``used`` (zeros)."""
        payload, net, inp, coords0 = self._prologue(
            image1, image2, fmap1, fmap2, alternate_corr, False, True)
        B = net.shape[0]
        zeros = torch.zeros(B, dtype=torch.int32, device=net.device)
        return {"net": net, "inp": inp, "coords0": coords0,
                "coords1": (coords0 if flow_init is None
                            else coords0 + flow_init),
                "corr": payload, "consec": zeros,
                "done": torch.zeros(B, dtype=torch.bool, device=net.device),
                "used": zeros.clone()}

    def refine_chunk(self, carry: dict, remaining: torch.Tensor, steps: int,
                     early_exit: Optional[Tuple[float, int]] = None,
                     update_impl: str = "step"):
        """``steps`` masked refinement iterations over every slot of
        ``carry``. ``remaining`` (slots,) int32 is each slot's budget of
        mask-free iterations still owed (a request at ``iters=k`` owes
        ``k-1`` and then one ``refine_finalize``). A slot is active while
        it has budget and is not done; the update is computed for every
        slot and applied to the active ones only. Returns ``(carry',
        remaining')``; ``carry`` itself is not changed.

        The order is the JAX package's: ``active = ~done & (rem > 0)``,
        ``consec`` on this iteration's update, freeze, tick ``used`` and
        ``rem``, then ``done``."""
        net, coords1 = carry["net"], carry["coords1"]
        consec, done, used = carry["consec"], carry["done"], carry["used"]
        rem = remaining.to(device=net.device, dtype=torch.int32)
        for _ in range(int(steps)):
            net_new, _, delta_flow = self._iteration(
                carry["corr"], net, carry["inp"], carry["coords0"], coords1,
                False, update_impl)
            active = ~done & (rem > 0)
            if early_exit is not None:
                below = _delta_norm(delta_flow) < early_exit[0]
                consec = torch.where(active,
                                     torch.where(below, consec + 1, 0),
                                     consec)
            net = _freeze(~active, net, net_new)
            coords1 = _freeze(~active, coords1, coords1 + delta_flow)
            tick = active.int()
            used = used + tick
            rem = rem - tick
            if early_exit is not None:
                done = done | (active & (consec >= early_exit[1]))
        return dict(carry, net=net, coords1=coords1, consec=consec,
                    done=done, used=used), rem

    def refine_finalize(self, carry: dict, update_impl: str = "step"):
        """The mask-computing final iteration over every slot; ``carry``
        is not changed. Returns ``(flow_low, flow_up)`` at the slot width.
        ``k-1`` chunked iterations and this call reproduce ``forward`` at
        ``iters=k``; ``iters_used = carry["used"] + 1``."""
        _, mask, delta_flow = self._iteration(
            carry["corr"], carry["net"], carry["inp"], carry["coords0"],
            carry["coords1"], True, update_impl)
        flow_low = carry["coords1"] + delta_flow - carry["coords0"]
        return flow_low, _upsample(flow_low, mask)


def scatter_carry(full: dict, fresh: dict, idx: torch.Tensor,
                  slots: int) -> dict:
    """``full`` (a ``slots``-wide carry) with rows ``idx`` of every leaf
    replaced by ``fresh`` (a ``refine_init`` carry over ``len(idx)``
    samples); ``full`` itself is not changed. The all-pairs pyramid's
    levels fold the slot with the feature rows, (slots*H8*W8, h, w): they
    are viewed as (slots, H8*W8, h, w) first. Repeated indices (a padded
    admission repeats its last request) write equal values."""
    idx = idx.to(device=full["net"].device, dtype=torch.long)

    def scatter(f, n):
        if isinstance(f, tuple):
            return tuple(scatter(a, b) for a, b in zip(f, n))
        per = f.shape[0] // slots
        rows = f.reshape(slots, per, *f.shape[1:])
        new = n.reshape(len(idx), per, *n.shape[1:]).to(f.dtype)
        return rows.index_copy(0, idx, new).reshape(f.shape)

    return {k: scatter(full[k], fresh[k]) for k in full}
