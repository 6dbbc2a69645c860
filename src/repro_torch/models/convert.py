"""Carry parameters between the reference's pytree and the port.

The reference keeps a model's parameters as a nested dict with the
layers stacked on a leading axis (``params["layers"]["attn"]["wq"]`` is
``(L, D, H, Dh)``; the hybrid stacks its pattern groups,
``params["groups"]["b0_rec"]``, beside unstacked ``tail{t}`` blocks).
:func:`params_from_reference` takes that tree as numpy arrays and returns
the port's model (:class:`Transformer` for the dense, MoE, VLM and audio
families, :class:`Mamba2` or :class:`RecurrentGemma`) with the same values;
:func:`params_to_reference` gives the tree back.
:func:`train_state_from_reference` does the same for a whole training
state (parameters, AdamW's ``m`` and ``v``, the step), and
:func:`train_state_to_reference` back.  The tests use them to run both
packages on one set of weights, or from one training state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.torch_device import DEFAULT_DEVICE, resolve_device
from . import common as cm
from .config import ModelConfig
from .mamba2 import Mamba2
from .model import model_spec
from .rglru import RecurrentGemma
from .transformer import Transformer

_CLASSES = {"dense": Transformer, "moe": Transformer, "vlm": Transformer,
            "audio": Transformer, "ssm": Mamba2, "hybrid": RecurrentGemma}


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes arrays: via float32
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def params_from_reference(cfg: ModelConfig, tree, *, device=DEFAULT_DEVICE):
    """The port's parameters from the reference's tree (nested dicts of
    numpy arrays, stacked axes first).  Raises ``ValueError`` when a leaf
    is missing or its shape differs from the config's spec."""
    dev = resolve_device(device)
    out: dict = {}
    for path, p in cm.spec_leaves(model_spec(cfg)):
        node = tree
        for key in path:
            if key not in node:
                raise ValueError(f"reference tree has no {'/'.join(path)}")
            node = node[key]
        if tuple(np.shape(node)) != p.shape:
            raise ValueError(f"{'/'.join(path)}: shape {np.shape(node)}, "
                             f"expected {p.shape}")
        dst = out
        for key in path[:-1]:
            dst = dst.setdefault(key, {})
        dst[path[-1]] = _tensor(node, dev)
    return model_from_tree(cfg, out)


def model_from_tree(cfg: ModelConfig, tree: dict):
    """The family's module (:class:`Transformer`, :class:`Mamba2` or
    :class:`RecurrentGemma`) over a reference-layout tree of tensors; its
    parameters are views of the tree's leaves, no copy."""
    if cfg.family not in _CLASSES:
        raise ValueError(f"unknown family {cfg.family!r}")
    return _CLASSES[cfg.family](cfg, tree)


def _tree(cfg: ModelConfig, tree, dev) -> dict:
    """A reference-layout tree of numpy leaves as tensors on ``dev``, in
    the spec's key order."""
    return params_from_reference(cfg, tree, device=dev).param_tree()


def train_state_from_reference(cfg: ModelConfig, state, *,
                               device=DEFAULT_DEVICE):
    """The port's :class:`repro_torch.train.TrainState` from the
    reference's (a ``TrainState`` or a ``{"step", "params", "opt"}``
    dict, leaves as numpy arrays): the same parameters (trainable), ``m``,
    ``v`` (float32) and step."""
    from repro_torch.train import TrainState
    get = (state.get if isinstance(state, dict)
           else lambda k: getattr(state, k))
    dev = resolve_device(device)
    opt = get("opt")
    return TrainState.of(params_from_reference(cfg, get("params"),
                                               device=dev),
                         step=int(np.asarray(get("step"))),
                         opt={"m": _tree(cfg, opt["m"], dev),
                              "v": _tree(cfg, opt["v"], dev)})


def train_state_to_reference(state) -> dict:
    """``{"step", "params", "opt": {"m", "v"}}`` of a port training state
    as the reference's numpy trees (the step an int32)."""
    def host(node):
        if isinstance(node, dict):
            return {k: host(v) for k, v in node.items()}
        t = node.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return {"step": np.asarray(state.step, np.int32),
            "params": host(state.params.param_tree()),
            "opt": {"m": host(state.opt["m"]), "v": host(state.opt["v"])}}


def params_to_reference(params) -> dict:
    """The reference's tree layout (numpy, stacked axes first) of a port
    model's parameters."""
    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def to_host(node):
        if isinstance(node, dict):
            return {k: to_host(v) for k, v in node.items()}
        return host(node)

    return to_host(params.param_tree())
