"""Train step: loss -> gradients -> AdamW, with optional microbatch
gradient accumulation.

The port of ``repro.train.step`` for one card.  :class:`TrainState`
holds the step count, the model (``params``: a :class:`Transformer`,
:class:`Mamba2` or :class:`RecurrentGemma` whose parameters are
trainable) and the optimizer state ``opt = {"m", "v"}`` (float32 trees
in the reference's layout).  ``train_step(state, batch)`` takes the
gradient of :func:`repro_torch.models.loss_fn` by autograd into stacked
buffers (:func:`repro_torch.models.bind_grads`), then runs
:func:`repro_torch.optim.adamw_update`, which updates the parameters
and ``opt`` in place; it returns the state with ``step + 1`` and the
metrics ``loss``, ``nll``, ``aux``, ``grad_norm`` and ``lr`` (0-d
tensors).  On a card every family's gradient runs hand-written backward
kernels: attention (D 16-256, with windows) and RMSNorm, and for the
ssm and hybrid families the SSD scan's and the linear recurrence's.
:func:`state_spec` and :func:`state_logical_axes` give the state's
shapes (on the ``meta`` device) and logical axes in the reference's
stacked layout, for the dry run (:mod:`repro_torch.launch.dryrun`).
A rank-local state (:mod:`repro_torch.distributed.rank_local`: each rank
holds its blocks of ``params``, ``m`` and ``v``) runs the same step: its
parameters read as the gathered global tensors, its gradients land in
block-sized buffers, and its global norm sums across ranks.  It also
computes only its rows of the batch: the step takes the global batch, as
the reference's ``jit`` does, cuts this rank's rows on the host before
the copy to the device (``Layout.row_cut``: a microbatch's sanitized
specs over the mesh's data axes), runs the forward and backward under
that :func:`repro_torch.distributed.ctx.row_cut` (the gathers' backwards
sum the gradient over the row axes, ``rank_local.sum_rows`` the leaves
held whole), and returns ``loss``, ``nll`` and ``aux`` as the global
means.  Microbatches split the rank's rows: the rank takes its block of
each of the reference's microbatches (the global batch's consecutive
slices), so slice i of every rank makes up the reference's microbatch i
and an MoE routes each one over the same tokens.  Where the layout cuts
weights over ``model`` (attention heads, MLP columns, the vocabulary,
the RG-LRU's channels: ``Layout.model_cut``), the step also runs under
that :func:`repro_torch.distributed.ctx.model_cut`, and a rank computes
only its blocks of those products
(:mod:`repro_torch.distributed.tensor_parallel`), its rows still cut
over the data axes.  A one-rank state, or one whose microbatches no axis
of more than one rank cuts and whose layout cuts nothing over
``model``, runs as on one card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch import models as M
from repro_torch.core.torch_device import DEFAULT_DEVICE
from repro_torch.models import common as cm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state
from repro_torch.utils.tree import tree_flatten, tree_leaves


@dataclasses.dataclass
class TrainState:
    step: int
    params: nn.Module
    opt: dict

    @staticmethod
    def create(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               *, device=DEFAULT_DEVICE,
               weight_std: Optional[float] = None) -> "TrainState":
        """A random init (``generator``, on the device, defaults to seed 0;
        ``weight_std``: see :func:`repro_torch.models.init_params`) at
        step 0 with zero ``m`` and ``v``."""
        return TrainState.of(M.init_params(cfg, generator, device=device,
                                           weight_std=weight_std))

    @staticmethod
    def of(params: nn.Module, step: int = 0,
           opt: Optional[dict] = None) -> "TrainState":
        """The state of a model: its parameters made trainable, ``opt``
        zeros unless given."""
        params.requires_grad_(True)
        if opt is None:
            opt = init_opt_state(params.param_tree())
        return TrainState(step=int(step), params=params, opt=opt)

    def load(self, tree) -> "TrainState":
        """Copies a restored checkpoint tree (``{"params", "opt",
        "step"}`` of numpy arrays, bfloat16 leaves as 2-byte words) into
        this state's tensors in place; returns the state.  A rank-local
        state takes its blocks of the global leaves (copies)."""
        from repro_torch.distributed import rank_local
        from repro_torch.distributed.mesh import cut
        dst, _ = tree_flatten({"params": self.params.param_tree(),
                               "opt": self.opt})
        src, _ = tree_flatten({"params": tree["params"], "opt": tree["opt"]})
        if len(src) != len(dst):
            raise ValueError(f"checkpoint has {len(src)} leaves, the state "
                             f"{len(dst)}")
        layout = rank_local.layout_of(self.params)
        specs = ([None] * len(dst) if layout is None else
                 rank_local.spec_leaves(
                     {"params": self.params.param_tree(), "opt": self.opt},
                     {"params": layout.specs.params,
                      "opt": layout.specs.opt}))
        with torch.no_grad():
            for d, s, spec in zip(dst, src, specs):
                a = np.asarray(s)
                t = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                     if a.dtype.kind == "V" else torch.from_numpy(a))
                d.copy_(t.reshape(d.shape) if spec is None else
                        cut(layout.mesh, t, spec))
        self.step = int(np.asarray(tree["step"]))
        return self

    def tree(self) -> dict:
        """``{"params", "opt", "step"}`` as the reference's checkpoints
        hold them (the parameter and state tensors themselves, the step a
        numpy int32).  A rank-local state's tensors are its blocks: save
        it with :func:`repro_torch.distributed.rank_local.save`."""
        return {"params": self.params.param_tree(), "opt": self.opt,
                "step": np.asarray(self.step, np.int32)}


def _spec_tree(cfg: ModelConfig, dtype: torch.dtype) -> dict:
    out: dict = {}
    for path, p in cm.spec_leaves(M.model_spec(cfg)):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.empty(p.shape, dtype=dtype, device="meta")
    return out


def state_spec(cfg: ModelConfig) -> TrainState:
    """The :class:`TrainState`'s shapes and dtypes with no allocation:
    ``params`` (in ``cfg.param_dtype``) and ``opt = {"m", "v"}`` (float32)
    as trees of tensors on the ``meta`` device in the reference's stacked
    layout (not a module), and ``step`` a 0-d int32 meta tensor, as the
    reference's ``ShapeDtypeStruct`` skeleton."""
    return TrainState(
        step=torch.empty((), dtype=torch.int32, device="meta"),
        params=_spec_tree(cfg, cm.torch_dtype(cfg.param_dtype)),
        opt={"m": _spec_tree(cfg, torch.float32),
             "v": _spec_tree(cfg, torch.float32)})


def state_logical_axes(cfg: ModelConfig) -> TrainState:
    """The logical axes of :func:`state_spec`'s trees (``step`` None)."""
    axes = M.logical_axes(cfg)
    return TrainState(step=None, params=axes, opt={"m": axes, "v": axes})


def _device_batch(batch: dict, device, cut=None,
                  microbatches: int = 1) -> dict:
    """The batch on ``device``; under a row cut only this rank's rows of
    each of the ``microbatches`` slices, in slice order, cut where the
    batch lies (on the host for numpy arrays) before the copy."""
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        if cut is not None:
            # (microbatches, rows, ...): this rank's block of each slice
            v = v.reshape((microbatches, -1) + tuple(v.shape[1:]))
            v = cut.take(v.movedim(1, 0)).movedim(0, 1)
            v = v.reshape((-1,) + tuple(v.shape[2:]))
        out[k] = v.to(device)
    return out


def gradients(cfg: ModelConfig, state: TrainState, batch, *,
              microbatches: int = 1) -> tuple:
    """The step's backward: ``(metrics, grads)``, ``grads`` the gradient
    of :func:`repro_torch.models.loss_fn` in stacked buffers
    (:func:`repro_torch.models.bind_grads`: blocks for a rank-local
    state, summed over the row axes), ``metrics`` its ``loss``, ``nll``
    and ``aux`` (the global means); the parameters' ``.grad`` are freed.
    ``batch`` and ``microbatches`` as :func:`make_train_step` takes
    them."""
    from repro_torch.distributed import ctx as dctx
    from repro_torch.distributed import rank_local
    model = state.params
    device = next(model.parameters()).device
    layout = rank_local.layout_of(model)
    cut = (None if layout is None
           else layout.row_cut(cfg, batch, microbatches))
    tp = None if layout is None else layout.model_cut()
    if cut is not None and tp is not None and set(cut.rows) & set(tp.axes):
        raise ValueError(f"the rows are cut over {cut.rows} and the "
                         f"weights over {tp.axes}: a model cut's ranks "
                         f"must share their rows")
    batch = _device_batch(batch, device, cut, microbatches)
    grads = M.bind_grads(cfg, model)
    try:
        with dctx.row_cut(cut), dctx.model_cut(tp):
            loss, metrics = _backward(cfg, model, batch, grads, microbatches)
        rank_local.sum_rows(grads, layout, cut)
    finally:
        for p in model.parameters():      # the buffers stay in grads
            p.grad = None
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["loss"] = loss.detach()
    if cut is not None:
        # the global means: one all-reduce of the three over the rows
        keys = ("loss", "nll", "aux")
        means = cut.mean(torch.stack([metrics[k] for k in keys]))
        metrics.update(zip(keys, means.unbind()))
    return metrics, grads


def _backward(cfg, model, batch, grads, microbatches: int) -> tuple:
    """The loss's backward into ``grads``: ``(loss, metrics)``, the
    microbatches' gradients accumulated and scaled."""
    if microbatches > 1:
        b = next(iter(batch.values())).shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} does not split into "
                             f"{microbatches} microbatches")
        n = b // microbatches
        loss_sum = 0.0
        for i in range(microbatches):
            loss, metrics = M.loss_fn(
                cfg, model,
                {k: v[i * n:(i + 1) * n] for k, v in batch.items()})
            loss.backward()
            loss_sum = loss_sum + loss.detach()
        inv = 1.0 / microbatches
        for g in tree_leaves(grads):
            g.mul_(inv)
        return loss_sum * inv, metrics
    loss, metrics = M.loss_fn(cfg, model, batch)
    loss.backward()
    return loss, metrics


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    *, microbatches: int = 1):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` is ``{"tokens": (B, S)}`` (numpy or tensors; moved to the
    model's device), the global batch; a rank-local state computes its
    rows of it (see the module docstring).  ``microbatches > 1`` splits
    the (rank's) batch dim into that many slices (it must divide evenly),
    runs a backward for each, accumulating the gradients (float32 for
    float32 parameters) in the stacked buffers, scales them by ``1 /
    microbatches`` and keeps the last slice's metrics and the mean loss,
    as the reference's ``lax.scan`` does (:func:`gradients`).
    """
    from repro_torch.distributed import rank_local

    def train_step(state: TrainState, batch):
        metrics, grads = gradients(cfg, state, batch,
                                   microbatches=microbatches)
        try:
            layout = rank_local.layout_of(state.params)
            gnorm = (None if layout is None
                     else rank_local.global_norm(grads, layout))
            _, opt, opt_metrics = adamw_update(
                opt_cfg, state.params.param_tree(), grads, state.opt,
                state.step, gnorm=gnorm)
        finally:
            # free the buffers at once, even where something keeps this
            # frame alive
            del grads
        metrics.update(opt_metrics)
        return TrainState(step=state.step + 1, params=state.params,
                          opt=opt), metrics

    return train_step
