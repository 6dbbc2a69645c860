"""Expert-parallel MoE dispatch by explicit all-to-all.

The port of ``repro.distributed.moe_parallel``, the classic EP schedule:
tokens stay sharded over the data axes; each rank routes its *local*
tokens into an (E, local_cap, D) buffer (the routing of
:func:`repro_torch.models.moe.route_logits`: the stable top-k tie order
and the stable sort by expert of ``moe_ffn``), one tiled all-to-all
over the expert axis re-bins it to (E/m, m*local_cap, D) so each model
rank holds only its experts' tokens, the expert FFN runs locally, and
the reverse all-to-all returns outputs to their source rank, where the
combine adds each token's contributions.

The expert weights come in either of two forms, told apart by their
leading dim: the global tensors (every expert), which the ``shard_map``
cuts to the rank's experts, or the rank's own block of ``(E/m, ...)``
rows, as a rank-local state holds them where the rules cut ``experts``
over ``model`` (:func:`repro_torch.distributed.tensor_parallel
.local_names`): computed on as they are, and their gradient is that
block's, neither gathered nor summed over ``model``.

Wire bytes a layer = 2 x tokens_exchanged x D, independent of E.
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch.models import moe
from repro_torch.models.config import ModelConfig

from . import comm
from .mesh import Mesh, shard_map
from .sharding import PartitionSpec as PS
from .tensor_parallel import split


def _local_dispatch(cfg: ModelConfig, router_logits, xf, cap: int):
    """Route local tokens: ``(buf, routing, aux)``, buf the (E_padded, cap,
    D) expert buffer and routing the :class:`repro_torch.models.moe
    .Routing` the combine needs (the reference's ``(slot, tok_s, gate_s,
    valid)`` are its ``slot``, ``order // k``, ``gate_vals`` in sorted
    order and ``valid``)."""
    r, aux = moe.route_logits(cfg, router_logits, cap)
    et = cfg.moe_num_experts + cfg.moe_expert_pad
    return moe.dispatch(r, xf, et), r, aux


def moe_ffn_ep(cfg: ModelConfig, mesh: Mesh, p, x, *,
               model_axis: str = "model", data_axes=("data",),
               record: Optional[list] = None):
    """Expert-parallel MoE FFN.  x: (B, S, D), global, computed with B
    sharded over ``data_axes`` and the experts (``p['w_*']``'s leading
    dim) over ``model_axis``: ``p['w_*']`` global, or this rank's block
    of ``(E + pad) / m`` experts under a
    :class:`repro_torch.distributed.ctx.ModelCut` over ``model_axis``.
    Returns (y, aux) like
    :func:`repro_torch.models.moe.moe_ffn`; ``record``, when a list,
    receives this rank's routing of its local tokens.  Where this rank
    holds only its rows of the batch already (a
    :class:`repro_torch.distributed.ctx.RowCut` on ``mesh``), x and y are
    those rows: not cut again, not gathered back; the capacity a rank is
    the same, its tokens' (the reference's per-shard capacity), and aux
    still the mean over the data ranks.
    """
    from .ctx import local_axes
    local = local_axes(mesh)
    b, s, d = x.shape
    m = mesh.shape[model_axis]
    e = cfg.moe_num_experts
    et = e + cfg.moe_expert_pad
    if et % m:
        raise ValueError(f"experts {e} + pad {cfg.moe_expert_pad} must "
                         f"divide EP degree {m}: set moe_expert_pad")
    # each read of a rank-local weight gathers it: read each once
    w_gate, w_up, w_down = p["w_gate"], p["w_up"], p["w_down"]
    rows = w_gate.shape[0]
    if rows == et:
        held = ()
    else:
        tp = split(rows, et)
        if tp.axes != (model_axis,):
            raise ValueError(f"the experts are a block over {tp.axes}, "
                             f"expert parallelism runs over {model_axis!r}")
        held = (model_axis,)
    ba = tuple(a for a in data_axes if a in mesh.axis_names)
    cut_here = tuple(a for a in ba if a not in local)
    t_local = b * s // math.prod(mesh.shape[a] for a in cut_here)
    cap_local = max(int(math.ceil(t_local * cfg.moe_top_k / e
                                  * cfg.moe_capacity_factor)), 8)
    b_spec = (cut_here[0] if len(cut_here) == 1 else
              (cut_here if cut_here else None))

    def body(x_l, router_l, wg_l, wu_l, wd_l):
        bl, sl, dl = x_l.shape
        xf = x_l.reshape(bl * sl, dl)
        logits = xf.float() @ router_l
        buf, r, aux = _local_dispatch(cfg, logits, xf, cap_local)
        if record is not None:
            record.append(r)
        # (E, cap, D) -> exchange the expert dim over the model ranks:
        # each keeps E/m experts and gains m x cap tokens for them
        buf = comm.all_to_all(mesh, buf, model_axis, 0, 1)
        out = moe.experts({"w_gate": wg_l, "w_up": wu_l, "w_down": wd_l},
                          buf)
        out = comm.all_to_all(mesh, out, model_axis, 1, 0)
        y = moe.undispatch(out, r)
        aux = comm.pmean(mesh, aux, ba) if ba else aux   # a mean over ranks
        return y.reshape(bl, sl, dl), aux

    return shard_map(
        body, mesh,
        in_specs=(PS(b_spec), PS(), PS(model_axis), PS(model_axis),
                  PS(model_axis)),
        out_specs=(PS(b_spec), PS()), local=local,
        held=((), (), held, held, held),
    )(x, p["router"].float(), w_gate, w_up, w_down)
