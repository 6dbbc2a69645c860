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
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.torch_device import DEFAULT_DEVICE, resolve_device
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


def _split_proj(cfg: ModelConfig, proj):
    di, nh, g, n, _ = _dims(cfg)
    return torch.split(proj, [di, di, g * n, g * n, nh], dim=-1)


def mamba_layer(cfg: ModelConfig, p, x):
    """x: (B, S, D) -> (B, S, D)."""
    b, s, _ = x.shape
    di, nh, g, n, _ = _dims(cfg)
    x = cm.constrain_act(x, cfg)
    xn = cm.rmsnorm(cfg, p["ln"], x)
    proj = xn @ p["in_proj"].to(x.dtype)
    z, xs, bmat, cmat, dt_raw = _split_proj(cfg, proj)
    xbc = torch.cat([xs, bmat, cmat], dim=-1)
    xbc = F.silu(causal_conv(xbc, p["conv_w"], p["conv_b"]))
    xs, bmat, cmat = torch.split(xbc, [di, g * n, g * n], dim=-1)
    xh = xs.reshape(b, s, nh, cfg.ssm_headdim)
    bh = bmat.reshape(b, s, g, n)
    ch = cmat.reshape(b, s, g, n)
    ct = kref.compute_dtype(x)       # float32; float64 for a float64 model
    dt = F.softplus(dt_raw.to(ct) + p["dt_bias"].to(ct))
    a = -torch.exp(p["a_log"].to(ct))
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
    y = y + xh * p["d_skip"].to(y.dtype)[None, None, :, None]
    y = y.reshape(b, s, di)
    y = cm.rmsnorm(cfg, p["norm"], y * F.silu(z))
    return x + y @ p["out_proj"].to(x.dtype)


def _hidden(cfg: ModelConfig, params: Mamba2, tokens):
    x = cm.embed_tokens(cfg, params.embed, tokens, cm.torch_dtype(cfg.dtype))
    x, _ = cm.stacked_apply(cfg, lambda x, p: (mamba_layer(cfg, p, x), None),
                            x, params.layers)
    return cm.rmsnorm(cfg, params.embed["final_norm"], x)


def train_forward(cfg: ModelConfig, params: Mamba2, tokens,
                  frontend_inputs=None):
    """:func:`forward` that autograd records (layers rematerialised per
    ``cfg.remat``).  On a card the SSD scan's gradient runs the
    ``ssd_chunk_scan`` backward kernels (``ops.ssd_scan``'s Function), the
    norms' the RMSNorm backward kernel; the padded steps' gradients stop
    at ``F.pad`` (dt = 0 there, so they add nothing to dA)."""
    return cm.lm_logits(cfg, params.embed, _hidden(cfg, params, tokens)), 0.0


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
               device=DEFAULT_DEVICE) -> dict:
    """Zero decode state: ``conv`` (L, B, W - 1, conv_dim) in ``cfg.dtype``
    and ``ssm`` (L, B, H, P, N) in float32 (``max_seq`` is unused)."""
    di, nh, g, n, conv_dim = _dims(cfg)
    dev = resolve_device(device)
    L = cfg.num_layers
    return {
        "conv": torch.zeros((L, batch, cfg.conv_width - 1, conv_dim),
                            dtype=cm.torch_dtype(cfg.dtype), device=dev),
        "ssm": torch.zeros((L, batch, nh, cfg.ssm_headdim, n),
                           dtype=torch.float32, device=dev),
    }


def prefill(cfg: ModelConfig, params: Mamba2, tokens, max_seq: int,
            frontend_inputs=None):
    """Run the prompt; returns (last logits (B, 1, V), the reference's
    zeroed cache ``init_cache(cfg, B, S)``)."""
    with torch.inference_mode():
        x = _hidden(cfg, params, tokens)
        return (cm.lm_logits(cfg, params.embed, x[:, -1:]),
                init_cache(cfg, tokens.shape[0], tokens.shape[1],
                           device=tokens.device))


def _layer_decode(cfg: ModelConfig, p, h, conv_st, ssm_st):
    di, nh, g, n, _ = _dims(cfg)
    b = h.shape[0]
    xn = cm.rmsnorm(cfg, p["ln"], h)
    proj = xn @ p["in_proj"].to(h.dtype)
    z, xs, bmat, cmat, dt_raw = _split_proj(cfg, proj)
    xbc = torch.cat([xs, bmat, cmat], dim=-1)[:, 0]          # (B, C)
    hist = torch.cat([conv_st, xbc[:, None, :]], dim=1)
    conv_out = (torch.einsum("bwc,wc->bc", hist, p["conv_w"].to(h.dtype))
                + p["conv_b"].to(h.dtype))
    conv_out = F.silu(conv_out)
    x1, b1, c1 = torch.split(conv_out, [di, g * n, g * n], dim=-1)
    xh = x1.reshape(b, nh, cfg.ssm_headdim)
    bh = b1.reshape(b, g, n).repeat_interleave(nh // g, dim=1)
    ch = c1.reshape(b, g, n).repeat_interleave(nh // g, dim=1)
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())
    decay = torch.exp(dt * a)[..., None, None]
    ssm_new = ssm_st * decay + torch.einsum(
        "bhp,bhn->bhpn", (xh * dt[..., None]).float(), bh.float())
    y = torch.einsum("bhpn,bhn->bhp", ssm_new, ch.float())
    y = y.to(h.dtype) + xh * p["d_skip"].to(h.dtype)[None, :, None]
    y = y.reshape(b, 1, di)
    y = cm.rmsnorm(cfg, p["norm"], y * F.silu(z))
    h = h + y @ p["out_proj"].to(h.dtype)
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
