"""Dense / MoE / VLM / audio decoder-only transformer: forward, prefill
and decode.

The port of ``repro.models.transformer`` for the dense family (tinyllama,
qwen3-4b/8b, llama3-405b), the MoE family (qwen2-moe-a2.7b, arctic-480b;
the FFN half is :func:`repro_torch.models.moe.moe_block`), the VLM
backbone (internvl2-26b: stub patch embeddings projected over the first
positions, :func:`repro_torch.models.common.apply_frontend`) and the
audio backbone (musicgen-large: (B, S, Cb) codebook tokens, their
embeddings summed, one output head a codebook).
:class:`Transformer` holds the parameters,
one :class:`DecoderLayer` per layer, and layers run in a Python loop
(:func:`repro_torch.models.common.stacked_apply`, with the reference's
rematerialisation when a gradient is recorded).  The functions
:func:`forward`, :func:`train_forward`, :func:`prefill` and
:func:`decode_step` take the config explicitly, so one set of weights
serves configs that differ only in ``kernel_impl`` or ``dtype``.
Under Megatron's sequence parallelism (``cfg.seq_parallel`` under a
model cut, :func:`repro_torch.distributed.tensor_parallel
.sequence_parallel`) the residual stream between the sublayers is the
rank's block of the sequence; a decode step runs without it.
Decoding writes the KV cache in place.  Parameters are frozen
(``requires_grad=False``) for serving; ``params.requires_grad_(True)``
makes them trainable (``repro_torch.train.TrainState`` does), and their
gradients then land in the stacked buffers that
:func:`repro_torch.models.model.bind_grads` gives them.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.core.torch_device import DEFAULT_DEVICE, resolve_device
from . import common as cm
from .config import ModelConfig
from .moe import moe_block, moe_spec


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------
def layer_spec(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    spec = {
        "ln1": cm.P((D,), ("embed",), "zeros"),
        "attn": cm.attn_spec(cfg),
        "ln2": cm.P((D,), ("embed",), "zeros"),
    }
    if cfg.moe_num_experts:
        spec["moe"] = moe_spec(cfg)
        if cfg.moe_dense_parallel:
            spec["dense_mlp"] = cm.mlp_spec(cfg)
    else:
        spec["mlp"] = cm.mlp_spec(cfg)
    return spec


def model_spec(cfg: ModelConfig) -> dict:
    return {
        "embed": cm.embed_spec(cfg),
        "layers": cm.stack_spec(layer_spec(cfg), cfg.num_layers),
    }


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------
def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class DecoderLayer(nn.Module):
    """One pre-norm decoder layer: attention then the FFN half (a SwiGLU
    MLP, or for MoE configs the routed experts with the shared expert or
    the parallel dense MLP), each with a residual.  ``p`` is the layer's
    parameter dict (reference layout).  ``routing``, when set to a list,
    receives the :class:`repro_torch.models.moe.Routing` of every MoE
    call of this layer."""

    def __init__(self, p: dict):
        super().__init__()
        self.ln1 = _frozen(p["ln1"])
        self.attn = nn.ParameterDict({k: _frozen(v)
                                      for k, v in p["attn"].items()})
        self.ln2 = _frozen(p["ln2"])
        for name in ("mlp", "dense_mlp"):
            if name in p:
                setattr(self, name, nn.ParameterDict(
                    {k: _frozen(v) for k, v in p[name].items()}))
        if "moe" in p:
            self.moe = cm.ParamTree(p["moe"])
        self.routing: Optional[list] = None

    def ffn(self, cfg: ModelConfig, x):
        """The FFN half on the normed input: ``(out, aux)``, aux None for
        a dense layer."""
        if cfg.moe_num_experts:
            return moe_block(cfg, {"moe": self.moe,
                                   "dense_mlp": getattr(self, "dense_mlp",
                                                        None)},
                             x, record=self.routing)
        return cm.mlp(self.mlp, x, cfg.d_ff), None

    def forward(self, cfg: ModelConfig, x, positions):
        """``(x, aux)``: the layer's output and its MoE aux loss (None for
        a dense layer)."""
        x = cm.constrain_act(x, cfg)
        h = cm.attention(cfg, self.attn, cm.block_norm(cfg, self.ln1, x),
                         positions, window=cfg.window)
        x = x + h
        h, aux = self.ffn(cfg, cm.block_norm(cfg, self.ln2, x))
        return x + h, aux

    def prefill(self, cfg: ModelConfig, x, positions):
        """:meth:`forward` that also returns the layer's keys and values,
        head-major ``(B, K, S, Dh)``, every key head (the cache holds them
        all)."""
        h, kh, vh = cm.attend(cfg, self.attn,
                              cm.block_norm(cfg, self.ln1, x), positions,
                              window=cfg.window)
        x = x + h
        x = x + self.ffn(cfg, cm.block_norm(cfg, self.ln2, x))[0]
        return x, kh, vh

    def decode(self, cfg: ModelConfig, x, cache_k, cache_v, pos: int):
        """One token; writes this layer's ``(B, K, S, Dh)`` cache in place."""
        h, _, _ = cm.attention_decode(cfg, self.attn,
                                      cm.rmsnorm(cfg, self.ln1, x), cache_k,
                                      cache_v, pos, window=cfg.window)
        x = x + h
        return x + self.ffn(cfg, cm.rmsnorm(cfg, self.ln2, x))[0]

    def reference_tree(self) -> dict:
        """This layer's parameters in the reference's layout."""
        tree = {"ln1": self.ln1, "ln2": self.ln2,
                "attn": dict(self.attn.items())}
        for name in ("mlp", "dense_mlp"):
            if hasattr(self, name):
                tree[name] = dict(getattr(self, name).items())
        if hasattr(self, "moe"):
            tree["moe"] = self.moe.tree()
        return tree


class Transformer(nn.Module):
    """The transformer's parameters: ``embed`` (embedding, final norm, LM
    head, and the VLM's ``patch_proj`` or the audio model's
    ``codebook_embed`` and ``codebook_head``) and ``layers``, built from a
    reference-layout tree (layers stacked on a leading axis; each layer's
    tensors are views of it)."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        if cfg.family not in ("dense", "moe", "vlm", "audio"):
            raise ValueError(f"family {cfg.family!r} is not a transformer")
        self.embed = nn.ParameterDict({k: _frozen(v)
                                       for k, v in tree["embed"].items()})
        stacked = tree["layers"]

        def layer(i, node):
            return ({k: layer(i, v) for k, v in node.items()}
                    if isinstance(node, dict) else node[i])

        self.layers = nn.ModuleList(DecoderLayer(layer(i, stacked))
                                    for i in range(cfg.num_layers))
        self._tree = tree

    def param_tree(self) -> dict:
        """The parameters in the reference's layout, layers stacked: the
        tensors this module's parameters are views of (no copy; updating
        one updates the other)."""
        return self._tree


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------
def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _hidden(cfg: ModelConfig, params: Transformer, tokens, frontend_inputs,
            layer_fn):
    """The final-normed hidden states of the layers run by ``layer_fn(x,
    layer, positions) -> (x, y)``, and the ys: the rank's block of the
    sequence under sequence parallelism."""
    from repro_torch.distributed import tensor_parallel as tpar
    x = cm.embed_tokens(cfg, params.embed, tokens, cm.torch_dtype(cfg.dtype))
    x = cm.apply_frontend(cfg, params.embed, x, frontend_inputs)
    sp = tpar.seq_cut()
    s = x.shape[1] * (sp.n if sp is not None else 1)
    positions = _positions(x.shape[0], s, x.device)
    x, ys = cm.stacked_apply(
        cfg, lambda x, layer: layer_fn(x, layer, positions), x,
        params.layers)
    return cm.block_norm(cfg, params.embed["final_norm"], x), ys


def train_forward(cfg: ModelConfig, params: Transformer, tokens,
                  frontend_inputs=None):
    """:func:`forward` that autograd records (the same maths; the layers
    rematerialised per ``cfg.remat`` when a gradient is recorded)."""
    from repro_torch.distributed import tensor_parallel as tpar
    with tpar.sequence_parallel(cfg, tokens.shape[1]):
        x, auxs = _hidden(cfg, params, tokens, frontend_inputs,
                          lambda x, layer, pos: layer(cfg, x, pos))
        auxs = [a for a in auxs if a is not None]
        aux = torch.stack(auxs).sum() if auxs else 0.0
        return cm.lm_logits(cfg, params.embed, x), aux


def forward(cfg: ModelConfig, params: Transformer, tokens,
            frontend_inputs=None):
    """tokens: (B, S) integer, or (B, S, Cb) for audio -> (float32 logits
    (B, S, V) or (B, S, Cb, V), aux): aux is the layers' summed MoE
    load-balancing loss (a float32 scalar tensor), 0.0 for a dense model.
    ``frontend_inputs``: the VLM's (B, num_patches, D) patch embeddings.
    Runs under ``torch.inference_mode()``."""
    with torch.inference_mode():
        return train_forward(cfg, params, tokens, frontend_inputs)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                *, device=DEFAULT_DEVICE,
                weight_std: Optional[float] = None) -> Transformer:
    """Random init from the spec tree, in ``cfg.param_dtype``, on
    ``device``; ``generator`` (on that device) defaults to seed 0.
    ``weight_std``: every ``normal`` weight N(0, weight_std) instead of
    the reference's fan-in rule (:meth:`repro_torch.models.common.P.initialize`)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    tree = cm.init_from_spec(model_spec(cfg), generator,
                             cm.torch_dtype(cfg.param_dtype), dev,
                             weight_std)
    return Transformer(cfg, tree)


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------
def cache_len(cfg: ModelConfig, max_seq: int) -> int:
    """Cache slots per layer: windowed models keep a rolling window."""
    return min(max_seq, cfg.window) if cfg.window else max_seq


def logical_axes(cfg: ModelConfig):
    return cm.axes_from_spec(model_spec(cfg))


def cache_logical_axes(cfg: ModelConfig):
    axes = ("layers", "batch", "kv_heads", "cache_seq", "head_dim")
    return {"k": axes, "v": axes}


def cache_spec(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """:func:`init_cache`'s shapes and dtypes with no allocation: the same
    tree of tensors on the ``meta`` device."""
    return init_cache(cfg, batch, max_seq, device="meta")


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device=DEFAULT_DEVICE, seq_blocks: int = 1) -> dict:
    """Zero KV cache ``{"k", "v"}``, each (L, B, K, S, Dh) in
    ``cfg.dtype``; ``seq_blocks``: the number of blocks its slots are cut
    into (a rank's block of a seq-sharded cache: S / seq_blocks slots)."""
    n = cache_len(cfg, max_seq)
    if n % seq_blocks:
        raise ValueError(f"{n} cache slots do not cut into {seq_blocks} "
                         f"blocks")
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, n // seq_blocks,
             cfg.head_dim)
    dev = resolve_device(device)
    dtype = cm.torch_dtype(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def prefill(cfg: ModelConfig, params: Transformer, tokens, max_seq: int,
            frontend_inputs=None):
    """Run the full prompt (tokens as :func:`forward` takes them, and the
    VLM's ``frontend_inputs``); returns (last logits (B, 1, V), or (B, 1,
    Cb, V) for audio, cache).  Each layer's keys and values fill the
    first S cache slots (zeros after), or, when the cache is shorter than
    the prompt, it keeps the last ones.  Under a
    :class:`repro_torch.distributed.ctx.RowCut` whose ``seq`` cuts the
    slots, the cache returned is this rank's block of them.  Under
    sequence parallelism the hidden states are gathered before the
    head."""
    from repro_torch.distributed import tensor_parallel as tpar
    from repro_torch.distributed.ctx import current_cut
    from repro_torch.distributed.mesh import axis_index
    cut = current_cut()
    seq = cut.seq if cut is not None else ()
    layers = iter(range(cfg.num_layers))
    with torch.inference_mode():
        b = tokens.shape[0]
        blocks = cut.mesh.extent(seq) if seq else 1
        cache = init_cache(cfg, b, max_seq, device=tokens.device,
                           seq_blocks=blocks)
        s_loc = cache["k"].shape[3]
        first = axis_index(cut.mesh, seq) * s_loc if seq else 0

        def layer_fn(x, layer, positions):
            # the global slots [lo, hi) of this rank's block that the
            # prompt fills: slot j holds the key of position s - n + j
            i, s = next(layers), positions.shape[1]
            n = min(cache_len(cfg, max_seq), s)
            lo, hi = first, min(first + s_loc, n)
            x, kh, vh = layer.prefill(cfg, x, positions)
            if lo < hi:
                cache["k"][i, :, :, :hi - lo] = kh[:, :, s - n + lo:s - n + hi]
                cache["v"][i, :, :, :hi - lo] = vh[:, :, s - n + lo:s - n + hi]
            return x, None

        with tpar.sequence_parallel(cfg, tokens.shape[1]):
            x, _ = _hidden(cfg, params, tokens, frontend_inputs, layer_fn)
            x = tpar.enter(None, x)
        return cm.lm_logits(cfg, params.embed, x[:, -1:]), cache


def decode_step(cfg: ModelConfig, params: Transformer, cache: dict, tokens,
                pos):
    """One decode step.  tokens: (B,), or (B, Cb) for audio; pos: the
    position written.  Returns (logits (B, V) or (B, Cb, V), cache), the
    cache updated in place."""
    pos = int(pos)
    with torch.inference_mode():
        x = cm.embed_tokens(cfg, params.embed, tokens[:, None],
                            cm.torch_dtype(cfg.dtype))
        for i, layer in enumerate(params.layers):
            x = layer.decode(cfg, x, cache["k"][i], cache["v"][i], pos)
        x = cm.block_norm(cfg, params.embed["final_norm"], x)
        return cm.lm_logits(cfg, params.embed, x)[:, 0], cache
