"""Mamba2 (state-space duality / SSD) decoder: forward, prefill and decode.

The port of ``repro.models.mamba2`` (mamba2-370m).  A fused input
projection emits (z, x, B, C, dt); (x, B, C) pass through a causal
depthwise conv; the SSD scan (:func:`repro_torch.kernels.ops.ssd_scan`,
the CUDA ``ssd_chunk_scan`` kernel on a card) evolves the (heads,
headdim, state) recurrence; the output is gate-normalised
(``RMSNorm(y * silu(z))``, the RMSNorm kernel) and projected back.

Decode keeps O(1) state per layer, a (conv_width - 1) conv tail and the
(H, P, N) SSM state, and runs the reference's per-step einsum form (no
kernel but the norms).  ``decode_step`` returns a new cache; it does not
write the given one.  ``prefill`` returns the reference's zeroed cache
(``repro.models.model.prefill``), so decoding after a prompt starts from
a blank state, as in the reference.

Where the rules cut ``"ssm_inner"`` over ``model`` and the extent divides
the heads (:func:`repro_torch.distributed.tensor_parallel.local_names`),
a rank computes its ``H / n`` heads (:func:`mamba_layer`): ``out_proj``
and the gated norm's weight are read as its blocks (whole heads), while
``in_proj`` and the conv, whose blocks mix z, x, B, C and dt, are read
whole and the rank's columns sliced from them (its heads' z, x and dt,
B and C of its groups); the gated norm sums its squares over the cut
(:func:`repro_torch.models.common.rmsnorm_cut`) and ``out_proj`` is a row
product summed over it.  Its decode cache holds its heads' state and its
heads' conv tail, B's and C's channels whole.  Under Megatron's sequence
parallelism the residual stream between the layers is the rank's block
of the sequence.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.torch_device import DEFAULT_DEVICE, resolve_device
from repro_torch.distributed import tensor_parallel as tpar
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from . import common as cm
from .config import ModelConfig
from .specs import mamba2_model_spec as model_spec


def _dims(cfg: ModelConfig):
    di = cfg.d_inner
    nh = cfg.ssm_heads
    g, n = cfg.ssm_groups, cfg.ssm_state
    return di, nh, g, n, di + 2 * g * n


class Mamba2(nn.Module):
    """The Mamba2 model's parameters: ``embed`` and one :class:`ParamTree`
    per layer, views of the reference's stacked ``layers``."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        if cfg.family != "ssm":
            raise ValueError(f"Mamba2 holds the ssm family, not "
                             f"{cfg.family!r}")
        self.embed = cm.ParamTree(tree["embed"])
        self.layers = nn.ModuleList(
            cm.ParamTree(cm.index_tree(tree["layers"], i))
            for i in range(cfg.num_layers))
        self._tree = tree

    def param_tree(self) -> dict:
        """The parameters in the reference's layout, layers stacked: the
        tensors this module's parameters are views of (no copy)."""
        return self._tree


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                *, device=DEFAULT_DEVICE,
                weight_std: Optional[float] = None) -> Mamba2:
    """Random init from the spec tree, in ``cfg.param_dtype``, on
    ``device``; ``generator`` (on that device) defaults to seed 0.
    ``weight_std``: every ``normal`` weight N(0, weight_std) instead of
    the reference's fan-in rule (:meth:`repro_torch.models.common.P.initialize`)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    return Mamba2(cfg, cm.init_from_spec(model_spec(cfg), generator,
                                         cm.torch_dtype(cfg.param_dtype),
                                         dev, weight_std))


def causal_conv(xbc, w, b):
    """Depthwise causal conv.  xbc: (B, S, C); w: (W, C).  The per-tap sum
    runs in the activations' dtype, in the reference's order."""
    wdt = w.to(xbc.dtype)
    width, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = sum(pad[:, i:i + s, :] * wdt[i] for i in range(width))
    return out + b.to(xbc.dtype)


def _groups(cfg: ModelConfig, h0: int, hl: int) -> tuple:
    """``(first group, groups)`` that the heads ``h0 .. h0 + hl`` read B
    and C of: whole groups, or the one group they lie in."""
    nh, g = cfg.ssm_heads, cfg.ssm_groups
    hpg = nh // g
    if hl % hpg == 0:
        return h0 // hpg, hl // hpg
    if hpg % hl == 0:
        return h0 // hpg, 1
    raise ValueError(f"{hl} heads a rank of {nh} in {g} groups: neither "
                     f"whole groups nor within one")


class Heads:
    """The heads a rank computes: ``tp`` (the model cut, None for every
    head), the first head ``h0`` and ``hl`` heads, the first group ``g0``
    and ``gl`` groups of B and C."""

    def __init__(self, cfg: ModelConfig, tp, hl: int):
        self.cfg, self.tp, self.hl = cfg, tp, hl
        self.h0 = tp.index * hl if tp is not None else 0
        self.g0, self.gl = _groups(cfg, self.h0, hl)

    def proj_columns(self) -> list:
        """``(start, width)`` of ``in_proj``'s columns of these heads: z,
        x, B, C, dt."""
        cfg, p, n = self.cfg, self.cfg.ssm_headdim, self.cfg.ssm_state
        di, gn = cfg.d_inner, cfg.ssm_groups * n
        return [(self.h0 * p, self.hl * p), (di + self.h0 * p, self.hl * p),
                (2 * di + self.g0 * n, self.gl * n),
                (2 * di + gn + self.g0 * n, self.gl * n),
                (2 * di + 2 * gn + self.h0, self.hl)]

    def conv_columns(self) -> list:
        """``(start, width)`` of the conv's channels of these heads: x, B,
        C."""
        cfg, p, n = self.cfg, self.cfg.ssm_headdim, self.cfg.ssm_state
        di, gn = cfg.d_inner, cfg.ssm_groups * n
        return [(self.h0 * p, self.hl * p), (di + self.g0 * n, self.gl * n),
                (di + gn + self.g0 * n, self.gl * n)]

    def take(self, w, cols=None):
        """This rank's part of a weight it reads whole (in through
        ``copy_in``: its gradient is a partial sum): the columns ``cols``
        of its last dim, or its heads of a ``(H,)`` vector."""
        if self.tp is None:
            return w
        w = tpar.copy_in(self.tp, w)
        if cols is None:
            return w.narrow(0, self.h0, self.hl)
        return torch.cat([w.narrow(-1, a, k) for a, k in cols], dim=-1)

    def widths(self) -> list:
        """The widths of z, x, B, C and dt on these heads."""
        p, n = self.cfg.ssm_headdim, self.cfg.ssm_state
        return [self.hl * p, self.hl * p, self.gl * n, self.gl * n, self.hl]


def heads_of(cfg: ModelConfig, out_proj) -> Heads:
    """The heads a rank computes from ``out_proj`` as it reads (its rows
    whole heads: the rank's block where the rules cut them)."""
    local = out_proj.shape[0]
    return Heads(cfg, tpar.split(local, cfg.d_inner),
                 local // cfg.ssm_headdim)


def mamba_layer(cfg: ModelConfig, p, x):
    """x: (B, S, D) -> (B, S, D), on the rank's heads (:class:`Heads`):
    under a model cut the input comes in through
    ``tensor_parallel.enter`` and ``out_proj``'s row product leaves
    through ``tensor_parallel.leave``; under sequence parallelism ``x``
    is the rank's block of the sequence."""
    n = cfg.ssm_state
    x = cm.constrain_act(x, cfg)
    out_proj = p["out_proj"]
    hd = heads_of(cfg, out_proj)
    hl, gl = hd.hl, hd.gl
    xn = tpar.enter(hd.tp, cm.block_norm(cfg, p["ln"], x))
    b, s, _ = xn.shape
    proj = xn @ hd.take(p["in_proj"], hd.proj_columns()).to(x.dtype)
    z, xs, bmat, cmat, dt_raw = torch.split(proj, hd.widths(), dim=-1)
    xbc = torch.cat([xs, bmat, cmat], dim=-1)
    cols = hd.conv_columns()
    xbc = F.silu(causal_conv(xbc, hd.take(p["conv_w"], cols),
                             hd.take(p["conv_b"], cols)))
    xs, bmat, cmat = torch.split(xbc, [hl * cfg.ssm_headdim, gl * n, gl * n],
                                 dim=-1)
    xh = xs.reshape(b, s, hl, cfg.ssm_headdim)
    bh = bmat.reshape(b, s, gl, n)
    ch = cmat.reshape(b, s, gl, n)
    ct = kref.compute_dtype(x)       # float32; float64 for a float64 model
    dt = F.softplus(dt_raw.to(ct) + hd.take(p["dt_bias"]).to(ct))
    a = -torch.exp(hd.take(p["a_log"]).to(ct))
    # Pad S to a chunk multiple with zero steps (the reference pads for its
    # kernel only; dt = 0 leaves the state as it is, so no value changes).
    pad = (-s) % cfg.ssm_chunk
    if pad:
        xh_p = F.pad(xh, (0, 0, 0, 0, 0, pad))
        bh = F.pad(bh, (0, 0, 0, 0, 0, pad))
        ch = F.pad(ch, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    else:
        xh_p = xh
    y, _ = kops.ssd_scan(xh_p, dt, a, bh, ch, chunk=cfg.ssm_chunk,
                         impl=cm.kernel_impl(cfg))
    y = y[:, :s]
    y = y + xh * hd.take(p["d_skip"]).to(y.dtype)[None, None, :, None]
    y = y.reshape(b, s, hl * cfg.ssm_headdim)
    y = cm.rmsnorm_cut(cfg, hd.tp, p["norm"], y * F.silu(z), cfg.d_inner)
    return x + tpar.leave(hd.tp, y @ out_proj.to(x.dtype))


def _hidden(cfg: ModelConfig, params: Mamba2, tokens):
    x = cm.embed_tokens(cfg, params.embed, tokens, cm.torch_dtype(cfg.dtype))
    x, _ = cm.stacked_apply(cfg, lambda x, p: (mamba_layer(cfg, p, x), None),
                            x, params.layers)
    return cm.block_norm(cfg, params.embed["final_norm"], x)


def train_forward(cfg: ModelConfig, params: Mamba2, tokens,
                  frontend_inputs=None):
    """:func:`forward` that autograd records (layers rematerialised per
    ``cfg.remat``).  On a card the SSD scan's gradient runs the
    ``ssd_chunk_scan`` backward kernels (``ops.ssd_scan``'s Function), the
    norms' the RMSNorm backward kernel; the padded steps' gradients stop
    at ``F.pad`` (dt = 0 there, so they add nothing to dA)."""
    with tpar.sequence_parallel(cfg, tokens.shape[1]):
        return cm.lm_logits(cfg, params.embed,
                            _hidden(cfg, params, tokens)), 0.0


def forward(cfg: ModelConfig, params: Mamba2, tokens, frontend_inputs=None):
    """tokens: (B, S) integer -> (float32 logits (B, S, V), aux 0.0)."""
    with torch.inference_mode():
        return train_forward(cfg, params, tokens, frontend_inputs)


def logical_axes(cfg: ModelConfig):
    return cm.axes_from_spec(model_spec(cfg))


# ---------------------------------------------------------------------------
# Serving: O(1) recurrent state
# ---------------------------------------------------------------------------
def cache_logical_axes(cfg: ModelConfig):
    return {
        "conv": ("layers", "batch", "conv", "ssm_inner"),
        "ssm": ("layers", "batch", "ssm_heads", "head_dim", "ssm_state"),
    }


def cache_spec(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """:func:`init_cache`'s shapes and dtypes with no allocation: the same
    tree of tensors on the ``meta`` device."""
    return init_cache(cfg, batch, max_seq, device="meta")


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device=DEFAULT_DEVICE, heads_blocks: int = 1) -> dict:
    """Zero decode state: ``conv`` (L, B, W - 1, conv_dim) in ``cfg.dtype``
    and ``ssm`` (L, B, H, P, N) in float32 (``max_seq`` is unused).
    ``heads_blocks``: the number of blocks the heads are cut into (a
    rank's heads under a model cut): ``ssm`` (L, B, H / n, P, N) and
    ``conv`` the tail of its heads' x channels and of its groups' B and C
    channels, a cut of the port's own (the reference keeps the heads
    whole)."""
    _, nh, _, n, conv_dim = _dims(cfg)
    if heads_blocks > 1:
        hl = nh // heads_blocks
        gl = _groups(cfg, 0, hl)[1]
        nh, conv_dim = hl, hl * cfg.ssm_headdim + 2 * gl * n
    dev = resolve_device(device)
    L = cfg.num_layers
    return {
        "conv": torch.zeros((L, batch, cfg.conv_width - 1, conv_dim),
                            dtype=cm.torch_dtype(cfg.dtype), device=dev),
        "ssm": torch.zeros((L, batch, nh, cfg.ssm_headdim, n),
                           dtype=torch.float32, device=dev),
    }


def heads_blocks(cfg: ModelConfig, params: Mamba2) -> int:
    """The number of blocks a rank's heads are of the whole: 1, or the
    model cut's extent where ``out_proj`` holds a block of them (read
    without gathering it)."""
    tp = tpar.split(cm.held_width(params.layers[0], "out_proj", 0),
                    cfg.d_inner)
    return 1 if tp is None else tp.n


def prefill(cfg: ModelConfig, params: Mamba2, tokens, max_seq: int,
            frontend_inputs=None):
    """Run the prompt; returns (last logits (B, 1, V), the reference's
    zeroed cache ``init_cache(cfg, B, S)``, of the rank's heads under a
    model cut)."""
    with torch.inference_mode():
        with tpar.sequence_parallel(cfg, tokens.shape[1]):
            x = tpar.enter(None, _hidden(cfg, params, tokens))
        return (cm.lm_logits(cfg, params.embed, x[:, -1:]),
                init_cache(cfg, tokens.shape[0], tokens.shape[1],
                           device=tokens.device,
                           heads_blocks=heads_blocks(cfg, params)))


def _layer_decode(cfg: ModelConfig, p, h, conv_st, ssm_st):
    """One token through a layer on the rank's heads (:class:`Heads`):
    ``conv_st`` and ``ssm_st`` hold their conv tail and state."""
    n = cfg.ssm_state
    b = h.shape[0]
    out_proj = p["out_proj"]
    hd = heads_of(cfg, out_proj)
    hl, gl = hd.hl, hd.gl
    xn = cm.rmsnorm(cfg, p["ln"], h)
    proj = xn @ hd.take(p["in_proj"], hd.proj_columns()).to(h.dtype)
    z, xs, bmat, cmat, dt_raw = torch.split(proj, hd.widths(), dim=-1)
    xbc = torch.cat([xs, bmat, cmat], dim=-1)[:, 0]          # (B, C)
    hist = torch.cat([conv_st, xbc[:, None, :]], dim=1)
    cols = hd.conv_columns()
    conv_out = (torch.einsum("bwc,wc->bc", hist,
                             hd.take(p["conv_w"], cols).to(h.dtype))
                + hd.take(p["conv_b"], cols).to(h.dtype))
    conv_out = F.silu(conv_out)
    x1, b1, c1 = torch.split(conv_out, [hl * cfg.ssm_headdim, gl * n,
                                        gl * n], dim=-1)
    xh = x1.reshape(b, hl, cfg.ssm_headdim)
    bh = b1.reshape(b, gl, n).repeat_interleave(hl // gl, dim=1)
    ch = c1.reshape(b, gl, n).repeat_interleave(hl // gl, dim=1)
    dt = F.softplus(dt_raw[:, 0].float() + hd.take(p["dt_bias"]).float())
    a = -torch.exp(hd.take(p["a_log"]).float())
    decay = torch.exp(dt * a)[..., None, None]
    ssm_new = ssm_st * decay + torch.einsum(
        "bhp,bhn->bhpn", (xh * dt[..., None]).float(), bh.float())
    y = torch.einsum("bhpn,bhn->bhp", ssm_new, ch.float())
    y = y.to(h.dtype) + xh * hd.take(p["d_skip"]).to(h.dtype)[None, :, None]
    y = y.reshape(b, 1, hl * cfg.ssm_headdim)
    y = cm.rmsnorm_cut(cfg, hd.tp, p["norm"], y * F.silu(z), cfg.d_inner)
    h = h + tpar.reduce_out(hd.tp, y @ out_proj.to(h.dtype))
    return h, hist[:, 1:].to(conv_st.dtype), ssm_new


def decode_step(cfg: ModelConfig, params: Mamba2, cache: dict, tokens, pos):
    """One token for the whole stack.  tokens: (B,); ``pos`` is unused (the
    state is position-free).  Returns (logits (B, V), new cache)."""
    del pos
    with torch.inference_mode():
        x = cm.embed_tokens(cfg, params.embed, tokens[:, None],
                            cm.torch_dtype(cfg.dtype))
        convs, ssms = [], []
        for i, p in enumerate(params.layers):
            x, conv, ssm = _layer_decode(cfg, p, x, cache["conv"][i],
                                         cache["ssm"][i])
            convs.append(conv)
            ssms.append(ssm)
        x = cm.rmsnorm(cfg, params.embed["final_norm"], x)
        return (cm.lm_logits(cfg, params.embed, x)[:, 0],
                {"conv": torch.stack(convs), "ssm": torch.stack(ssms)})
