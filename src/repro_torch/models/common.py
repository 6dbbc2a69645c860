"""Shared model components: parameter specs, initializers, attention,
MLP, RoPE, norms.

The port of ``repro.models.common`` for one card.  A module is described
by a spec tree of :class:`P` entries (shape, logical axes, init); the
same spec gives the initialised parameters and the exact parameter
counts.  The layer functions take their parameters as mappings of
tensors (``dict`` or ``nn.ParameterDict``); weights are held in the
config's ``param_dtype`` and cast to the activations' dtype at use, as
in the reference.  Norms go through :func:`repro_torch.kernels.ops.rmsnorm`
and full-sequence attention through
:func:`repro_torch.kernels.ops.attention` (the CUDA kernels on a card).
:func:`stacked_apply` runs a stack of layers with the reference's
two-level rematerialisation (``torch.utils.checkpoint``) when a gradient
is being recorded.  A float64 model (the arbiter of the kernels' float32
gradients) computes RoPE and its logits in float64.  Where a weight
holds a rank's block of its heads, columns or vocabulary (a rank-local
model under a :class:`repro_torch.distributed.ctx.ModelCut`), the layer
computes that block (:mod:`repro_torch.distributed.tensor_parallel`),
and under Megatron's sequence parallelism the residual stream is the
rank's block of the sequence: each sublayer enters through
``tensor_parallel.enter`` and leaves through ``tensor_parallel.leave``,
and the norms on the stream (:func:`block_norm`) take their weights
through ``copy_in``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch._guards import detect_fake_mode
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import compute_dtype
from .config import ModelConfig

#: The reference's ``kernel_impl`` names, as the port's ``impl``.
_IMPL_OF = {"xla": "torch", "interpret": "torch", "pallas": "cuda"}


def kernel_impl(cfg: ModelConfig) -> str:
    """``cfg.kernel_impl`` as an ``impl`` of :mod:`repro_torch.kernels.ops`:
    the reference's oracle (``xla``) and interpret modes become the plain
    versions, ``pallas`` the CUDA kernels; ``auto``, ``cuda`` and
    ``torch`` pass through."""
    return _IMPL_OF.get(cfg.kernel_impl, cfg.kernel_impl)


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` / ... as a :class:`torch.dtype`."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


@dataclasses.dataclass(frozen=True)
class P:
    """Parameter spec: shape, logical axes (one name per dim), init."""

    shape: tuple
    axes: tuple
    init: str = "normal"      # normal | zeros | ones | const_std
    scale: float = 1.0

    def initialize(self, generator: torch.Generator, dtype: torch.dtype,
                   device, weight_std: Optional[float] = None
                   ) -> torch.Tensor:
        """Draw the parameter.  ``weight_std`` replaces the fan-in rule of
        the ``normal`` weights by one standard deviation (as a published
        checkpoint's ``initializer_range``)."""
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        if self.init == "const_std":
            std = self.scale
        elif weight_std is not None:
            std = weight_std
        else:
            # the reference's rule: fan_in is shape[-2] for every weight of
            # two or more dims (the heads axis of a (D, H, Dh) projection)
            fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
            std = self.scale / np.sqrt(max(fan_in, 1))
        t = torch.randn(self.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return t.mul_(float(std)).to(dtype)


def spec_leaves(spec, prefix=()):
    """``(path, P)`` pairs of a spec tree, in the reference's leaf order
    (dict keys sorted, as ``jax.tree.flatten`` orders them)."""
    if isinstance(spec, P):
        yield prefix, spec
        return
    for key in sorted(spec):
        yield from spec_leaves(spec[key], prefix + (key,))


def init_from_spec(spec, generator: torch.Generator, dtype: torch.dtype,
                   device, weight_std: Optional[float] = None) -> dict:
    """A nested dict of tensors shaped like ``spec``, drawn leaf by leaf
    from ``generator`` (``weight_std``: see :meth:`P.initialize`)."""
    out: dict = {}
    for path, p in spec_leaves(spec):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = p.initialize(generator, dtype, device, weight_std)
    return out


def axes_from_spec(spec):
    """The tree of logical axis tuples of a spec tree: the shape of the
    spec, each ``P`` replaced by its ``axes`` (flattened in
    :func:`spec_leaves`' order)."""
    if isinstance(spec, P):
        return spec.axes
    return {k: axes_from_spec(v) for k, v in spec.items()}


def stack_spec(spec, n: int, axis_name: str = "layers"):
    """Prepend a stacked dimension to every param in a spec tree."""
    if isinstance(spec, P):
        return P((n,) + spec.shape, (axis_name,) + spec.axes, spec.init,
                 spec.scale)
    return {k: stack_spec(v, n, axis_name) for k, v in spec.items()}


class ParamTree(nn.Module):
    """A nested dict of tensors held as frozen parameters, keyed as in the
    reference's tree: ``node["key"]`` is a tensor or a sub-tree."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, ParamTree(value))
            else:
                self.register_parameter(
                    key, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def tree(self) -> dict:
        """The nested dict of tensors back."""
        out: dict = dict(self.named_parameters(recurse=False))
        out.update({k: m.tree() for k, m in self.named_children()})
        return out


def index_tree(tree: dict, i: int) -> dict:
    """Entry ``i`` of every leaf of a tree stacked on its first axis
    (views, not copies)."""
    return {k: index_tree(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------
def rmsnorm(cfg: ModelConfig, w, x):
    return kops.rmsnorm(x, w, eps=cfg.rms_eps, impl=kernel_impl(cfg))


def block_norm(cfg: ModelConfig, w, x):
    """A norm on the residual stream: :func:`rmsnorm`; under sequence
    parallelism the rank normalises its block of positions, so its
    gradient of the weight is a partial sum (``copy_in`` over the
    sequence's cut)."""
    return rmsnorm(cfg, tpar.copy_in(tpar.seq_cut(), w), x)


def rmsnorm_cut(cfg: ModelConfig, tp, w, x, width: int):
    """:func:`rmsnorm` of rows whose ``width`` columns are cut over the
    model cut ``tp`` (``x`` and ``w`` the rank's columns): each row's sum
    of squares summed over the cut (a ``psum`` at the ``"tp"`` site),
    :func:`repro_torch.kernels.ops.rmsnorm_cut`; ``tp`` None: the whole
    row's :func:`rmsnorm`."""
    if tp is None:
        return rmsnorm(cfg, w, x)
    from repro_torch.distributed.comm import psum

    def reduce(t):
        return psum(tp.mesh, t, tp.axes, site=tpar.SITE)
    return kops.rmsnorm_cut(x, w, reduce, width=width, eps=cfg.rms_eps,
                            impl=kernel_impl(cfg))


def held_width(mod, name: str, dim: int) -> int:
    """The width along ``dim`` that a read of ``mod``'s parameter
    ``name`` gives, without reading it (a read of a rank-local parameter
    gathers it): its block grown by the axes its parametrization gathers
    that dim over."""
    from torch.nn.utils import parametrize
    if not parametrize.is_parametrized(mod, name):
        return mod[name].shape[dim]
    g = getattr(mod.parametrizations, name)
    spec = g[0].spec
    grow = g[0].mesh.extent(spec[dim]) if len(spec) > dim and spec[dim] \
        else 1
    return g.original.shape[dim] * grow


@functools.lru_cache(maxsize=None)
def _rope_freqs_np(dh: int, theta: float) -> np.ndarray:
    """The reference's float32 RoPE frequencies, computed in numpy."""
    half = dh // 2
    return np.asarray(
        1.0 / (theta ** (np.arange(0, half, dtype=np.float32) * 2.0 / dh)),
        np.float32)


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(dh: int, theta: float,
                   device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_rope_freqs_np(dh, theta)).to(device)


def _rope_freqs(dh: int, theta: float, device: torch.device) -> torch.Tensor:
    """The RoPE frequencies on ``device``.  Real tensors are kept per
    device: a host-to-device copy on every call waits for the stream and
    stalls the launch queue twice a layer.  Under a fake mode (the dry
    run's trace) the tensor is made anew: a fake tensor kept past its
    trace would poison every later call, real or fake."""
    if detect_fake_mode() is not None:
        return torch.from_numpy(_rope_freqs_np(dh, theta)).to(device)
    return _rope_freqs_on(dh, theta, device)


def rope(x, positions, theta: float):
    """x: (..., T, H, Dh); positions: (..., T)."""
    half = x.shape[-1] // 2
    ct = compute_dtype(x)
    freqs = _rope_freqs(x.shape[-1], float(theta), x.device).to(ct)
    ang = positions[..., None].to(ct) * freqs           # (..., T, half)
    cos = torch.cos(ang)[..., None, :]                  # (..., T, 1, half)
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].to(ct), x[..., half:].to(ct)
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# -- attention ----------------------------------------------------------------
def attn_spec(cfg: ModelConfig) -> dict:
    D, H, K, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    spec = {
        "wq": P((D, H, Dh), ("embed", "heads", "head_dim")),
        "wk": P((D, K, Dh), ("embed", "kv_heads", "head_dim")),
        "wv": P((D, K, Dh), ("embed", "kv_heads", "head_dim")),
        "wo": P((H, Dh, D), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        spec["q_norm"] = P((Dh,), ("head_dim",), "zeros")
        spec["k_norm"] = P((Dh,), ("head_dim",), "zeros")
    return spec


def attn_qkv(cfg: ModelConfig, p, x, positions, tp=None, wq=None):
    """q, k, v (B, S, heads, Dh) of ``x``, q on the heads ``p["wq"]``
    holds (``wq``: that tensor, where the caller has read it already: a
    rank-local weight is gathered at each read).  Under a model cut
    ``tp`` (the heads cut, :mod:`repro_torch.distributed.tensor_parallel`)
    the input and the weights the rank applies whole (``wk``, ``wv``,
    the norms) come in through ``copy_in``: each rank's gradient of them
    is a partial sum over its heads.  Under sequence parallelism the
    input is the rank's block of the sequence, gathered here
    (``tensor_parallel.enter``)."""
    x = tpar.enter(tp, x)
    wq = p["wq"] if wq is None else wq
    q = torch.einsum("bsd,dhk->bshk", x, wq.to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x,
                     tpar.copy_in(tp, p["wk"]).to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x,
                     tpar.copy_in(tp, p["wv"]).to(x.dtype))
    if cfg.qk_norm:
        # The reference pins its plain op here (impl="xla"); the port runs
        # the RMSNorm kernel on the (B*S*H, Dh) rows, the same function.
        q = rmsnorm(cfg, tpar.copy_in(tp, p["q_norm"]), q)
        k = rmsnorm(cfg, tpar.copy_in(tp, p["k_norm"]), k)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _ring_mesh(cfg: ModelConfig, seq: int, window):
    """The mesh that ring attention runs on, as the reference dispatches
    it: ``cfg.ring_attention`` set, no window, a sharding context current
    with a ``"model"`` axis, and ``seq`` dividing by it; else None."""
    if not cfg.ring_attention or window is not None:
        return None
    from repro_torch.distributed import ctx as dctx
    c = dctx.current()
    if c is None or "model" not in c[0].axis_names \
            or seq % c[0].shape["model"]:
        return None
    return c[0]


def full_attention(cfg: ModelConfig, qh, kh, vh, *, window=None):
    """Head-major full-sequence attention core: the query heads ``qh``
    (B, Hl, S, Dh), every head (Hl = H) or, under a model cut, this
    rank's block of them, against every key and value head ``kh`` /
    ``vh`` (B, K, S, Dh) -> (B, Hl, S, Dh).

    Dispatch, as the reference's: ring attention (sequence-parallel over
    the context mesh's ``"model"`` axis, :func:`_ring_mesh`): on global
    heads :func:`repro_torch.distributed.ring_attention.ring_attention`,
    on a block of them ``ring_attention_heads``, which trades the heads
    for sequence blocks and back; otherwise the flash-attention kernel
    (on a card) or its plain version, on the key heads the query heads
    use (:func:`repro_torch.distributed.tensor_parallel.kv_heads`)."""
    hl = qh.shape[1]
    tp = tpar.split(hl, cfg.num_heads)
    mesh = _ring_mesh(cfg, qh.shape[2], window)
    if mesh is not None:
        from repro_torch.distributed import ring_attention as ra
        data_axes = tuple(a for a in ("pod", "data")
                          if a in mesh.axis_names)
        if tp is None:
            return ra.ring_attention(mesh, qh, kh, vh, causal=True,
                                     batch_axes=data_axes)
        if tp.axes != ("model",):
            raise ValueError(f"ring attention runs over 'model', the query "
                             f"heads are cut over {tp.axes}")
        return ra.ring_attention_heads(mesh, qh, kh, vh, causal=True,
                                       batch_axes=data_axes)
    rep = cfg.num_heads // cfg.num_kv_heads
    return kops.attention(qh, tpar.kv_heads(kh, tp, hl, rep),
                          tpar.kv_heads(vh, tp, hl, rep), causal=True,
                          window=window, impl=kernel_impl(cfg))


def attend(cfg: ModelConfig, p, x, positions, *, window=None):
    """Full-sequence attention of ``x`` (B, S, D) on the query heads
    ``p["wq"]`` holds: ``(out (B, S, D), keys, values)``, the keys and
    values head-major ``(B, K, S, Dh)``, every key head.  Under a model
    cut (the heads cut over ``model``) the rank attends with its query
    heads (:func:`full_attention`: the key heads they use, or under ring
    attention every head on its sequence block), and ``wo``'s row
    product is summed over the cut (``reduce_out``)."""
    wq = p["wq"]
    tp = tpar.split(wq.shape[1], cfg.num_heads)
    q, k, v = attn_qkv(cfg, p, x, positions, tp, wq)
    kh, vh = k.movedim(2, 1), v.movedim(2, 1)
    out = full_attention(cfg, q.movedim(2, 1), kh, vh, window=window)
    out = out.movedim(1, 2)                   # (B, S, H, Dh)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return tpar.leave(tp, out), kh, vh


def attention(cfg: ModelConfig, p, x, positions, *, window=None):
    """Full-sequence (prefill/forward) attention.  x: (B, S, D)."""
    return attend(cfg, p, x, positions, window=window)[0]


def attention_decode(cfg: ModelConfig, p, x, cache_k, cache_v, pos: int, *,
                     window=None):
    """Single-token decode.  x: (B, 1, D); cache_{k,v}: (B, K, S, Dh);
    ``pos``: current position (tokens written so far).

    Returns (out, cache_k, cache_v).  Unlike the reference, the new key
    and value are written into the given cache tensors in place (the
    reference donates the cache buffer to the same effect).  Windowed
    attention keeps a rolling buffer: the slot is ``pos % window`` and key
    positions are reconstructed for the mask.

    Under a :class:`repro_torch.distributed.ctx.RowCut` whose ``seq``
    cuts the cache's slots (the reference's seq-sharded cache, as GSPMD
    partitions it), the cache is this rank's block of slots: the new key
    and value go only to the rank that owns the slot, and the attention
    is flash-decoding's partial softmax over the block, combined over
    ``seq`` (:func:`repro_torch.distributed.flash_decode.combine`).

    Under a model cut (the query heads cut over ``model``), the rank
    computes its query heads and every key and value head (the cache
    holds them all).  With the slots cut too, each rank needs every
    query head against its block of slots: the query heads are
    all-gathered over the cut, combined over ``seq``, and the rank keeps
    its heads' rows of the result; without, it attends its heads over
    the whole cache.  ``wo``'s row product is summed over the cut.
    """
    from repro_torch.distributed.ctx import current_cut
    cut = current_cut()
    seq = cut.seq if cut is not None else ()
    b = x.shape[0]
    H, K, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    wq = p["wq"]
    hl = wq.shape[1]
    tp = tpar.split(hl, H)
    rep = H // K
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = attn_qkv(cfg, p, x, positions, tp, wq)
    s_loc = cache_k.shape[2]
    first, s = 0, s_loc
    if seq:
        from repro_torch.distributed.mesh import axis_index
        first = axis_index(cut.mesh, seq) * s_loc
        s = s_loc * cut.mesh.extent(seq)
    slot = pos % s if window is not None else pos
    slot_w = min(max(slot, 0), s - 1)  # lax.dynamic_update_slice clamps
    if first <= slot_w < first + s_loc:       # this rank's slot
        cache_k[:, :, slot_w - first] = k[:, 0].to(cache_k.dtype)
        cache_v[:, :, slot_w - first] = v[:, 0].to(cache_v.dtype)
    kpos = first + torch.arange(s_loc, device=x.device)
    if window is None:
        valid = kpos <= pos
    else:
        age = (slot - kpos) % s
        abs_pos = pos - age
        valid = (abs_pos >= 0) & (abs_pos > pos - window)
    # Grouped-query attention without repeating the KV heads: q heads as
    # (B, K, rep, Dh) against the (B, K, S, Dh) cache; float32 logits and
    # accumulation (the reference's preferred_element_type).
    if seq:
        from repro_torch.distributed.flash_decode import combine
        qg = tpar.gather_heads(tp, q, 2).reshape(b, K, rep, Dh)
        out = combine(cut.mesh, qg, cache_k, cache_v, valid[None], seq,
                      site="rows")
        out = out.reshape(b, 1, H, Dh).narrow(
            2, tp.index * hl if tp is not None else 0, hl)
    else:
        ck = tpar.kv_heads(cache_k, tp, hl, rep)
        cv = tpar.kv_heads(cache_v, tp, hl, rep)
        kl = ck.shape[1]
        qg = q.reshape(b, kl, hl // kl, Dh)
        logits = torch.einsum("bkrd,bksd->bkrs", qg.float(), ck.float())
        logits = logits / math.sqrt(cfg.head_dim)
        logits = torch.where(valid, logits, -1e30)
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bkrs,bksd->bkrd", w.to(cv.dtype).float(),
                           cv.float())
        out = out.reshape(b, 1, hl, Dh)
    out = torch.einsum("bshk,hkd->bsd", out.to(x.dtype),
                       p["wo"].to(x.dtype))
    return tpar.reduce_out(tp, out), cache_k, cache_v


# -- MLP ---------------------------------------------------------------------
def mlp_spec(cfg: ModelConfig, d_ff: Optional[int] = None) -> dict:
    D = cfg.d_model
    Fh = d_ff if d_ff is not None else cfg.d_ff
    return {
        "w_gate": P((D, Fh), ("embed", "mlp")),
        "w_up": P((D, Fh), ("embed", "mlp")),
        "w_down": P((Fh, D), ("mlp", "embed")),
    }


def mlp(p, x, width: Optional[int] = None):
    """The SwiGLU MLP of ``x``.  ``width``: its hidden width; where
    ``p`` holds a block of its columns (the ``mlp`` axis cut over
    ``model``) the input comes in through ``copy_in`` and the down
    product is summed over the cut (under sequence parallelism ``x`` is
    the rank's block of the sequence: ``tensor_parallel.enter`` /
    ``leave``).  None: the width ``p`` holds."""
    w_gate = p["w_gate"]
    tp = tpar.split(w_gate.shape[1],
                    w_gate.shape[1] if width is None else width)
    x = tpar.enter(tp, x)
    g = x @ w_gate.to(x.dtype)
    u = x @ p["w_up"].to(x.dtype)
    return tpar.leave(tp, (F.silu(g) * u) @ p["w_down"].to(x.dtype))


# -- embeddings / head -------------------------------------------------------
def embed_spec(cfg: ModelConfig) -> dict:
    spec = {
        "embedding": P((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                       "const_std", scale=0.02),
        "final_norm": P((cfg.d_model,), ("embed",), "zeros"),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = P((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    if cfg.num_codebooks > 1:
        spec["codebook_embed"] = P(
            (cfg.num_codebooks - 1, cfg.vocab_size, cfg.d_model),
            ("codebooks", "vocab", "embed"), "const_std", scale=0.02)
        spec["codebook_head"] = P(
            (cfg.num_codebooks - 1, cfg.d_model, cfg.vocab_size),
            ("codebooks", "embed", "vocab"))
    if cfg.frontend == "vision_stub":
        spec["patch_proj"] = P((cfg.d_model, cfg.d_model),
                               ("embed_in", "embed"))
    return spec


def embed_tokens(cfg: ModelConfig, p, tokens, dtype):
    """tokens: (B, S), or (B, S, Cb) for audio -> (B, S, D).  Audio sums
    the first codebook's embedding and each further codebook's, in
    codebook order and in the parameters' dtype, then casts, as the
    reference does.  Where the table holds a block of the vocabulary's
    rows (cut over ``model``), each rank looks up the tokens in its
    block, sums its codebooks' rows, and the sum over the cut is the
    lookup (``reduce_out``).  Under sequence parallelism the result is
    the rank's block of the sequence: the ranks' lookups
    reduce-scattered, or, with the vocabulary whole, the block of the
    lookup (``tensor_parallel.leave``)."""
    table = p["embedding"]
    tp = tpar.split(table.shape[0], cfg.vocab_size)
    if tp is not None:
        if cfg.num_codebooks > 1:
            x = tpar.embed(tp, table, tokens[..., 0])
            extra = p["codebook_embed"]
            for c in range(cfg.num_codebooks - 1):
                x = x + tpar.embed(tp, extra[c], tokens[..., c + 1])
        else:
            x = tpar.embed(tp, table, tokens)
        return tpar.leave(tp, x).to(dtype)
    if cfg.num_codebooks > 1:
        x = table[tokens[..., 0]]
        for c in range(cfg.num_codebooks - 1):
            x = x + p["codebook_embed"][c][tokens[..., c + 1]]
    else:
        x = table[tokens]
    return tpar.leave(None, x).to(dtype)


def lm_logits(cfg: ModelConfig, p, x):
    """x: (B, S, D) -> float32 (B, S, V), or (B, S, Cb, V) for audio: the
    main head's logits, then each codebook head's (float64 for a float64
    x).  Where the head holds a block of the vocabulary's columns (cut
    over ``model``), the logits are this rank's block of them, its input
    in through ``copy_in``; under sequence parallelism ``x`` is the
    rank's block of the sequence, gathered first
    (``tensor_parallel.enter``)."""
    head = p["embedding"].T if cfg.tie_embeddings else p["lm_head"]
    x = tpar.enter(tpar.split(head.shape[-1], cfg.vocab_size), x)
    logits = x @ head.to(x.dtype)
    if cfg.num_codebooks > 1:
        extra = torch.einsum("bsd,cdv->bscv", x,
                             p["codebook_head"].to(x.dtype))
        logits = torch.cat([logits[:, :, None, :], extra], dim=2)
    if cfg.logits_softcap:
        cap = cfg.logits_softcap
        logits = torch.tanh(logits / cap) * cap
    return logits.to(compute_dtype(logits))


def apply_frontend(cfg: ModelConfig, p, x, frontend_inputs):
    """Splice the VLM's stub patch embeddings into the token embeddings.

    vision_stub: ``frontend_inputs`` is (B, num_patches, D) precomputed
    patch embeddings; they are projected through ``patch_proj`` in
    ``x.dtype`` and overwrite the first ``num_patches`` positions, as the
    reference's concatenate does (a prompt shorter than the patches comes
    out as long as the patches, as there).  Other frontends, or no
    inputs, leave ``x`` as it is.  Under sequence parallelism ``x`` is
    the rank's block of the sequence: the whole is gathered, spliced and
    cut again.
    """
    if cfg.frontend == "vision_stub" and frontend_inputs is not None:
        x = tpar.enter(None, x)
        patches = torch.einsum("bpe,ed->bpd", frontend_inputs.to(x.dtype),
                               p["patch_proj"].to(x.dtype))
        x = torch.cat([patches, x[:, patches.shape[1]:]], dim=1)
        x = tpar.leave(None, x)
    return x


def constrain_act(x, cfg: "ModelConfig | None" = None):
    """Pin the residual stream sharding: batch-sharded, and with
    ``cfg.seq_parallel`` the sequence dim over the model axis
    (Megatron-SP).  A hint, resolved under a sharding context
    (:func:`repro_torch.distributed.ctx.constrain`); the values pass
    unchanged.  What cuts the compute is elsewhere: a rank holds only its
    rows of the batch under a :class:`repro_torch.distributed.ctx
    .RowCut`; between the layers' column and row products the residual
    stream is whole over ``model``, or, with ``cfg.seq_parallel`` under a
    model cut (``tensor_parallel.sequence_parallel``), the rank's block
    of the sequence, gathered into each sublayer and reduce-scattered
    out of it (:mod:`repro_torch.distributed.tensor_parallel`)."""
    from repro_torch.distributed.ctx import constrain
    seq_axis = "seq_sp" if (cfg is not None and cfg.seq_parallel) else "seq"
    return constrain(x, ("batch", seq_axis, "act_embed"))


# ---------------------------------------------------------------------------
# Rematerialisation
# ---------------------------------------------------------------------------
def _auto_block(n_layers: int) -> int:
    """Largest divisor of n_layers not exceeding ~sqrt(n_layers)."""
    limit = int(np.ceil(np.sqrt(n_layers))) + 1
    best = 1
    for k in range(1, limit + 1):
        if n_layers % k == 0:
            best = k
    return best


def remat_policy(cfg: ModelConfig) -> Optional[str]:
    """What a checkpointed region keeps for the backward: None (no remat)
    or ``"full"``: ``torch.utils.checkpoint`` keeps the region's inputs
    only, as JAX's ``nothing_saveable``.  ``dots_saveable`` maps to
    ``"full"`` too: keeping the matmul outputs faithfully needs a
    selective-checkpoint policy over every product op, and on one card
    the recompute it saves is not worth that code."""
    return None if cfg.remat == "none" else "full"


def _remat_on(cfg: ModelConfig) -> bool:
    return remat_policy(cfg) is not None and torch.is_grad_enabled()


def _checkpoint(fn, *args):
    """``torch.utils.checkpoint`` of ``fn(*args)`` whose recompute runs
    under the forward's sharding context, row cut and model cut: the
    autograd engine recomputes a CUDA tensor's region on a device thread
    of its own, which starts with an empty Python context (no
    :func:`axis_rules`, so no ring attention or expert parallelism, and
    other shapes; no :func:`row_cut`, so a local routing; no
    :func:`model_cut`, so no block of the weights to compute on)."""
    from repro_torch.distributed import ctx as dctx
    snap = dctx.snapshot()
    if all(c is None for c in snap):
        return checkpoint(fn, *args, use_reentrant=False)

    def under_rules(*a):
        with dctx.restored(snap):
            return fn(*a)
    return checkpoint(under_rules, *args, use_reentrant=False)


def maybe_checkpoint(cfg: ModelConfig, fn):
    """``fn`` checkpointed (recomputed in the backward) when remat is on
    and a gradient is being recorded, else ``fn`` itself."""
    if not _remat_on(cfg):
        return fn
    return functools.partial(_checkpoint, fn)


def stacked_apply(cfg: ModelConfig, body, x, layers):
    """Apply ``body(x, layer) -> (x, y)`` over ``layers`` in order;
    returns ``(x, [y, ...])``.

    With remat on and a gradient being recorded, the reference's
    two-level schedule: each layer is checkpointed, and so is each block
    of ``cfg.remat_block`` layers (auto ~sqrt(L), when it divides L), so
    the backward keeps L / k block inputs plus k layer inputs (see
    :func:`layer_forward_runs` for the recompute it costs).  Otherwise
    (serving, remat ``none``) a plain loop.
    """
    def run(fn, x, seq):
        ys = []
        for layer in seq:
            x, y = fn(x, layer)
            ys.append(y)
        return x, ys

    if not _remat_on(cfg):
        return run(body, x, layers)
    inner = maybe_checkpoint(cfg, body)
    n = len(layers)
    block = cfg.remat_block or _auto_block(n)
    if block <= 1 or n % block:
        return run(inner, x, layers)
    ys = []
    for i0 in range(0, n, block):
        x, yb = _checkpoint(run, inner, x, layers[i0:i0 + block])
        ys.extend(yb)
    return x, ys


def layer_forward_runs(cfg: ModelConfig, n_layers: int) -> int:
    """How many layer forwards :func:`stacked_apply` runs in one training
    step over ``n_layers`` layers (the forward and its recomputes): n
    without remat; 2n with layer checkpoints only; 3n - n / k with blocks
    of k.  ``torch.utils.checkpoint`` stops a recompute once it holds
    every tensor the backward needs, so a block's recompute does not rerun
    its last layer (whose own checkpoint keeps only its input); the
    reference's ``jax.checkpoint`` reruns it (3n)."""
    if cfg.remat == "none":
        return n_layers
    block = cfg.remat_block or _auto_block(n_layers)
    if block <= 1 or n_layers % block:
        return 2 * n_layers
    return 3 * n_layers - n_layers // block


# Last: the distributed package imports the models (expert parallelism),
# which import this module.
from repro_torch.distributed import tensor_parallel as tpar  # noqa: E402
