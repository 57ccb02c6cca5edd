"""Weights for the port: the torch-named ``.npz`` archives (read and
written), the inverse of ``raft_tpu/utils/torch_convert.py`` (JAX
variables -> this port's state dict) for RAFT, and the same for the sparse
family's ``SparseRAFT``, so that both packages can run the same weights."""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def load_npz(path: str) -> Dict[str, torch.Tensor]:
    """A torch-keyed ``.npz`` archive (e.g. ``assets/golden/weights.npz``)
    as a state dict. Archives may store fp16-rounded values; the port
    computes in float32, so every value is cast to it."""
    with np.load(path) as archive:
        return {k: torch.from_numpy(np.asarray(archive[k], np.float32))
                for k in archive.files}


def _torch_scope(path) -> list:
    """Flax scope names -> torch module path (without the leaf)."""
    out = []
    for name in path:
        m = re.fullmatch(r"(layer\d+)_(\d+)", name)
        if m:
            out += [m.group(1), m.group(2)]
        elif name == "update":
            continue            # the refinement scan's scope
        elif name == "mask_conv1":
            out += ["mask", "0"]
        elif name == "mask_conv2":
            out += ["mask", "2"]
        elif name == "downsample":
            out += ["downsample", "0"]
        elif name == "n":
            continue            # the Norm wrapper's inner module
        else:
            out.append(name)
    return out


def _leaves(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``{'params', ['batch_stats']}`` (nested dicts of arrays) of
    RAFT-large or RAFT-small -> this port's state dict: conv kernels HWIO
    -> OIHW, norm ``scale``/``bias`` -> ``weight``/``bias``, batch
    statistics -> ``running_mean``/``running_var`` (with
    ``num_batches_tracked`` = 0), and the shortcut's norm of every strided
    block (``norm3`` of a residual block, ``norm4`` of a bottleneck block)
    also under ``downsample.1``, where torch registers it twice. The small
    model's scopes (``ConvGRU``, ``BottleneckBlock``,
    ``SmallMotionEncoder``) carry their torch names as they are."""
    state: Dict[str, torch.Tensor] = {}
    for path, v in _leaves(variables.get("params", {})):
        scope, leaf = _torch_scope(path[:-1]), path[-1]
        if leaf == "kernel" and v.ndim == 4:
            state[".".join(scope + ["weight"])] = torch.from_numpy(
                np.ascontiguousarray(v.transpose(3, 2, 0, 1)))
        elif leaf == "scale":
            state[".".join(scope + ["weight"])] = torch.from_numpy(v.copy())
        elif leaf == "bias":
            state[".".join(scope + ["bias"])] = torch.from_numpy(v.copy())
        else:
            raise ValueError(f"unhandled flax leaf {'/'.join(path)} "
                             f"with shape {v.shape}")
    for path, v in _leaves(variables.get("batch_stats", {})):
        scope, leaf = _torch_scope(path[:-1]), path[-1]
        names = {"mean": "running_mean", "var": "running_var"}
        if leaf not in names:
            raise ValueError(f"unhandled batch statistic {'/'.join(path)}")
        state[".".join(scope + [names[leaf]])] = torch.from_numpy(v.copy())
        counter = ".".join(scope + ["num_batches_tracked"])
        state[counter] = torch.tensor(0, dtype=torch.long)
    _alias_shortcut_norms(state)
    return {k: v.float() if v.is_floating_point() else v
            for k, v in state.items()}


def _alias_shortcut_norms(state: Dict[str, torch.Tensor]) -> None:
    """Enter the shortcut's norm of every strided block also under
    ``downsample.1``: ``norm3`` of a residual block, ``norm4`` of a
    bottleneck block (one with a ``conv3``, whose ``norm3`` is on the main
    branch)."""
    for key in list(state):
        m = re.fullmatch(r"(|.*\.)norm([34])\.(\w+)", key)
        if m is None:
            continue
        block, n, leaf = m.groups()
        if n == ("4" if f"{block}conv3.weight" in state else "3"):
            state[f"{block}downsample.1.{leaf}"] = state[key]


_SPARSE_TABLES = ("row_pos_embed", "col_pos_embed", "lvl_pos_embed",
                  "img_pos_embed", "query_embed")


def _sparse_scope(path) -> list:
    """Flax scope names of ``raft_tpu.models.ours.SparseRAFT`` -> the port's
    module path: ``name_<i>`` is item i of the list ``name``; the
    auto-named ``Dense_<i>`` and ``GroupNorm_<i>`` are level i's
    ``input_proj`` (Linear, GroupNorm); the Norm wrapper's ``n`` and a
    residual block's ``downsample`` follow RAFT's rules."""
    out = []
    for name in path:
        auto = re.fullmatch(r"(Dense|GroupNorm)_(\d+)", name)
        item = re.fullmatch(r"(.+)_(\d+)", name)
        if auto:
            out += ["input_proj", auto.group(2),
                    "0" if auto.group(1) == "Dense" else "1"]
        elif item:
            out += [item.group(1), item.group(2)]
        elif name == "downsample":
            out += ["downsample", "0"]
        elif name != "n":
            out.append(name)
    return out


def sparse_state_dict_from_flax(variables: Mapping
                                ) -> Dict[str, torch.Tensor]:
    """JAX ``SparseRAFT`` variables ``{'params', 'batch_stats'}`` (nested
    dicts of arrays) -> the port's ``SparseRAFT`` state dict: conv kernels
    HWIO -> OIHW, Dense kernels (in, out) -> Linear (out, in), the
    self-attention's per-head kernels (in, heads, hd) and (heads, hd, out)
    -> Linear weights and its (heads, hd) biases flattened, norm ``scale``
    -> ``weight``, the top-level tables as they are, batch statistics ->
    ``running_mean``/``running_var`` (``num_batches_tracked`` = 0), every
    ``norm3`` also under ``downsample.1``. Raises on a leaf it has no rule
    for; ``load_state_dict(strict=True)`` catches a key left unfilled."""
    state: Dict[str, torch.Tensor] = {}

    def put(scope, leaf, v):
        state[".".join(scope + [leaf])] = torch.from_numpy(
            np.array(v, dtype=np.float32, order="C"))

    for path, v in _leaves(variables.get("params", {})):
        scope, leaf = _sparse_scope(path[:-1]), path[-1]
        if len(path) == 1 and leaf in _SPARSE_TABLES:
            put([], leaf, v)
        elif leaf == "kernel" and v.ndim == 4:
            put(scope, "weight", v.transpose(3, 2, 0, 1))
        elif leaf == "kernel" and v.ndim == 2:
            put(scope, "weight", v.T)
        elif leaf == "kernel" and v.ndim == 3 and path[-2] == "out":
            put(scope, "weight", v.reshape(-1, v.shape[-1]).T)
        elif leaf == "kernel" and v.ndim == 3 and path[-2] in (
                "query", "key", "value"):
            put(scope, "weight", v.reshape(v.shape[0], -1).T)
        elif leaf == "bias" and len(path) > 1:
            put(scope, "bias", v.reshape(-1))
        elif leaf == "scale" and len(path) > 1:
            put(scope, "weight", v)
        else:
            raise ValueError(f"unhandled flax leaf {'/'.join(path)} "
                             f"with shape {v.shape}")
    for path, v in _leaves(variables.get("batch_stats", {})):
        scope, leaf = _sparse_scope(path[:-1]), path[-1]
        names = {"mean": "running_mean", "var": "running_var"}
        if leaf not in names:
            raise ValueError(f"unhandled batch statistic {'/'.join(path)}")
        put(scope, names[leaf], v)
        state[".".join(scope + ["num_batches_tracked"])] = torch.tensor(
            0, dtype=torch.long)
    for key in [k for k in state if ".norm3." in k]:
        state[key.replace(".norm3.", ".downsample.1.")] = state[key]
    return state


def state_dict_to_npz(state_dict: Mapping[str, torch.Tensor],
                      path: str) -> None:
    """Save a state dict as a torch-keyed ``.npz`` archive that
    ``load_npz`` reads back: every entry under its own key (parameters,
    batch-norm running statistics and ``num_batches_tracked``), as float32
    (the counter as int64)."""
    np.savez(path, **{k: v.detach().cpu().numpy()
                      for k, v in state_dict.items()})
