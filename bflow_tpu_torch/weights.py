"""Weights from the JAX package's flax variables to the port's state_dict.

The inverse of bflow_tpu/importer/torch_ckpt.py, on plain nested dicts of
numpy arrays (``params`` and ``batch_stats``), so this module needs no
JAX. Rules:

  * conv kernels HWIO -> OIHW; biases copied;
  * the Norm wrapper (``BatchNorm_0`` / ``GroupNorm_0``) is unwrapped;
    ``scale`` -> ``weight``, batch stats ``mean`` -> ``running_mean`` and
    ``var`` -> ``running_var`` (``num_batches_tracked`` starts at 0);
  * ``layerN_K`` -> ``layerN.K``, ``ds_conv``/``ds_norm`` ->
    ``downsample.0``/``downsample.1``, ``mask_K`` -> ``mask.K``.

It is strict: an unknown leaf raises, and given a target state_dict, so
does a missing or extra key or a shape mismatch.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

_NORM_WRAPPERS = ("BatchNorm_0", "GroupNorm_0")
_LAYER = re.compile(r"^(layer\d+)_(\d+)$")
_MASK = re.compile(r"^mask_(\d+)$")


def _leaves(tree: Mapping[str, Any], prefix=()) -> Iterator[Tuple[tuple, Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _module_name(mods: Tuple[str, ...]) -> Tuple[str, bool]:
    """flax module path -> (torch module path, is a norm)."""
    out = []
    is_norm = False
    for i, m in enumerate(mods):
        if m in _NORM_WRAPPERS:
            parent = mods[i - 1] if i else ""
            if i != len(mods) - 1 or not (parent.startswith("norm")
                                          or parent == "ds_norm"):
                raise KeyError(f"unexpected norm wrapper at {mods}")
            is_norm = True
            continue
        layer, mask = _LAYER.match(m), _MASK.match(m)
        if layer:
            out.append(f"{layer.group(1)}.{layer.group(2)}")
        elif m == "ds_conv":
            out.append("downsample.0")
        elif m == "ds_norm":
            out.append("downsample.1")
        elif mask:
            out.append(f"mask.{mask.group(1)}")
        else:
            out.append(m)
    return ".".join(out), is_norm


def state_dict_from_jax(
    variables: Mapping[str, Any],
    target: Optional[Mapping[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """flax variables {'params': ..., 'batch_stats': ...} -> the port's
    state_dict (f32 tensors on the CPU). With ``target`` (a port
    state_dict), the key sets and shapes must match it exactly."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unknown variable collections {sorted(unknown)}")
    sd: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(variables["params"]):
        mod, is_norm = _module_name(path[:-1])
        leaf = path[-1]
        arr = np.asarray(value, np.float32)
        if leaf == "kernel" and not is_norm:
            if arr.ndim != 4:
                raise ValueError(f"kernel at {path} is not HWIO: {arr.shape}")
            name, arr = "weight", arr.transpose(3, 2, 0, 1)
        elif leaf == "scale" and is_norm:
            name = "weight"
        elif leaf == "bias":
            name = "bias"
        else:
            raise KeyError(f"unknown param leaf {path}")
        sd[f"{mod}.{name}"] = torch.from_numpy(np.array(arr, order="C"))
    for path, value in _leaves(variables.get("batch_stats", {})):
        mod, is_norm = _module_name(path[:-1])
        names = {"mean": "running_mean", "var": "running_var"}
        if not is_norm or path[-1] not in names:
            raise KeyError(f"unknown batch_stats leaf {path}")
        sd[f"{mod}.{names[path[-1]]}"] = torch.from_numpy(
            np.array(value, np.float32))
        sd[f"{mod}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    if target is not None:
        missing = sorted(set(target) - set(sd))
        extra = sorted(set(sd) - set(target))
        if missing or extra:
            raise ValueError(f"state_dict mismatch: missing={missing[:8]} "
                             f"extra={extra[:8]}")
        for k, v in sd.items():
            if tuple(v.shape) != tuple(target[k].shape):
                raise ValueError(f"shape mismatch at {k}: {tuple(v.shape)} "
                                 f"vs {tuple(target[k].shape)}")
    return sd


def load_jax_variables(model: torch.nn.Module,
                       variables: Mapping[str, Any]) -> torch.nn.Module:
    """Load flax variables into a port module in place (strict)."""
    model.load_state_dict(state_dict_from_jax(variables, model.state_dict()))
    return model


def _flax_module_path(torch_mod: str) -> Tuple[str, ...]:
    """torch module path -> flax module path (the inverse of
    _module_name, without the norm wrapper)."""
    parts = torch_mod.split(".")
    out = []
    i = 0
    while i < len(parts):
        m = parts[i]
        nxt = parts[i + 1] if i + 1 < len(parts) else None
        if m.startswith("layer") and nxt is not None and nxt.isdigit():
            out.append(f"{m}_{nxt}")
            i += 2
        elif m == "downsample" and nxt in ("0", "1"):
            out.append("ds_conv" if nxt == "0" else "ds_norm")
            i += 2
        elif m == "mask" and nxt is not None and nxt.isdigit():
            out.append(f"mask_{nxt}")
            i += 2
        else:
            out.append(m)
            i += 1
    return tuple(out)


def jax_variables_from_state_dict(
    sd: Mapping[str, torch.Tensor],
) -> Dict[str, Dict[str, Any]]:
    """The port's state_dict -> flax variables {'params', 'batch_stats'}
    as nested dicts of f32 numpy arrays: the inverse of
    state_dict_from_jax. A norm with running statistics is a BatchNorm,
    one without a GroupNorm; ``num_batches_tracked`` has no flax
    counterpart and is dropped."""
    batch_norms = {k.rsplit(".", 1)[0] for k in sd
                   if k.endswith(".running_mean")}
    out: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}

    def put(collection, path, value):
        node = out[collection]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value

    for key, value in sd.items():
        mod, leaf = key.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        arr = value.detach().float().cpu().numpy()
        path = _flax_module_path(mod)
        is_norm = path[-1].startswith("norm") or path[-1] == "ds_norm"
        if is_norm:
            wrapper = "BatchNorm_0" if mod in batch_norms else "GroupNorm_0"
            names = {"weight": ("params", "scale"),
                     "bias": ("params", "bias"),
                     "running_mean": ("batch_stats", "mean"),
                     "running_var": ("batch_stats", "var")}
            if leaf not in names:
                raise KeyError(f"unknown norm leaf {key}")
            collection, name = names[leaf]
            put(collection, path + (wrapper, name), arr)
        elif leaf == "weight":
            if arr.ndim != 4:
                raise ValueError(f"{key} is not OIHW: {arr.shape}")
            put("params", path + ("kernel",), np.ascontiguousarray(
                arr.transpose(2, 3, 1, 0)))
        elif leaf == "bias":
            put("params", path + ("bias",), arr)
        else:
            raise KeyError(f"unknown state_dict leaf {key}")
    if not out["batch_stats"]:
        del out["batch_stats"]
    return out
