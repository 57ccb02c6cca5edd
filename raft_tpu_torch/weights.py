"""Weights for the port: the torch-named ``.npz`` archives (read and
written), and the inverse of ``raft_tpu/utils/torch_convert.py`` (JAX
variables -> this port's state dict), so that both packages can run the
same weights."""

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
    """JAX ``{'params', ['batch_stats']}`` (nested dicts of arrays) -> this
    port's state dict: conv kernels HWIO -> OIHW, norm ``scale``/``bias`` ->
    ``weight``/``bias``, batch statistics -> ``running_mean``/
    ``running_var`` (with ``num_batches_tracked`` = 0), and every ``norm3``
    entry also under ``downsample.1``, where torch registers it twice."""
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
    for key in [k for k in state if ".norm3." in k]:
        state[key.replace(".norm3.", ".downsample.1.")] = state[key]
    return {k: v.float() if v.is_floating_point() else v
            for k, v in state.items()}


def state_dict_to_npz(state_dict: Mapping[str, torch.Tensor],
                      path: str) -> None:
    """Save a state dict as a torch-keyed ``.npz`` archive that
    ``load_npz`` reads back: every entry under its own key (parameters,
    batch-norm running statistics and ``num_batches_tracked``), as float32
    (the counter as int64)."""
    np.savez(path, **{k: v.detach().cpu().numpy()
                      for k, v in state_dict.items()})
