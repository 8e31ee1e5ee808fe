"""Tensor parallelism for the SDXL UNet over the mesh's 'model' axis.

Counterpart of latentblending_tpu/parallel/tp.py. Data parallelism over
sibling stems (mesh.py) is the primary strategy; TP is the secondary axis
for latency-bound configurations (SDXL-base 1024², few stems). The
transformer blocks, which carry most of SDXL's FLOPs, are sharded
Megatron-style:

  attn*.to_q/to_k/to_v, ff.net.0.proj  → column-parallel (output features
                                          sharded: whole attention heads)
  attn*.to_out.0, ff.net.2             → row-parallel (input features
                                          sharded; the partial outputs are
                                          summed over the model group)

Everything else (convs, norms, embeddings, proj_in/proj_out) stays
replicated. XLA inserts the row-parallel psum from sharding propagation;
here shard_unet_params swaps the matching nn.Linear modules in place for
ones that hold this rank's slice, and the row-parallel ones all-reduce.

Where the JAX rule differs: it shards to_q/to_k/to_v whenever the output
dimension divides n_model, even through a head, and XLA then reshards.
The port shards an attention block only where its head count divides
n_model (whole heads on every rank), and otherwise replicates the block
with the JAX rule's warning and strict raise. At SDXL's shapes (5, 10 and
20 heads; d=64) and n_model=2 the two rules agree everywhere but at the
5-head level, which has no transformer blocks in SDXL.
"""
from __future__ import annotations

import os
import re
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from latentblending_tpu_torch.models.layers import Attention
from latentblending_tpu_torch.parallel.mesh import Mesh
from latentblending_tpu_torch.utils import get_logger

log = get_logger(__name__)

# (state-dict key regex, (kind, sharded dim of the torch [out, in] weight))
# — first match wins. The JAX rules of latentblending_tpu/parallel/tp.py:31-39
# under the port's HF names.
_UNET_TP_RULES: list[tuple[str, tuple[str, int]]] = [
    # column-parallel: shard output features over 'model'
    (r".*\.attn\d\.(to_q|to_k|to_v)\.weight$", ("column", 0)),
    (r".*\.ff\.net\.0\.proj\.weight$", ("column", 0)),
    (r".*\.ff\.net\.0\.proj\.bias$", ("column", 0)),
    # row-parallel: shard input features; the outputs are summed over 'model'
    (r".*\.attn\d\.to_out\.0\.weight$", ("row", 1)),
    (r".*\.ff\.net\.2\.weight$", ("row", 1)),
]


def _owner(unet: nn.Module, key: str) -> nn.Module:
    """The Attention or FeedForward block a rule-matching key lives in."""
    return unet.get_submodule(re.match(r"(.*?\.(attn\d|ff))\.", key).group(1))


def _split_size(owner: nn.Module) -> int:
    """The count the model axis must divide: whole heads of an attention
    block, the GEGLU inner width of a feed-forward."""
    return owner.heads if isinstance(owner, Attention) else owner.net[2].in_features


def unet_tp_specs(unet: nn.Module, mesh: Mesh, strict: Optional[bool] = None) -> dict:
    """{state-dict key: (kind, dim) or None (replicated)} for the UNet's
    parameters: the TP rules and a replicated default
    (latentblending_tpu/parallel/tp.py:42-81). `unet` may live on the meta
    device.

    A parameter that matches a rule but whose block does not split into
    whole heads (attention) or equal GEGLU halves (feed-forward) over
    mesh.shape['model'] falls back to replicated, loudly: one warning per
    (rule, size). With strict=True (or LB_TP_STRICT=1) the fallback
    raises ValueError instead."""
    if strict is None:
        strict = os.environ.get("LB_TP_STRICT", "0") == "1"
    n_model = mesh.shape["model"]
    out = {}
    warned: set[tuple[str, int]] = set()
    for key, _ in unet.named_parameters():
        spec = None
        for pattern, rule in _UNET_TP_RULES:
            if re.match(pattern, key):
                owner = _owner(unet, key)
                size = _split_size(owner)
                if size % n_model == 0:
                    spec = rule
                else:
                    what = "heads" if isinstance(owner, Attention) else "inner width"
                    msg = (f"TP rule {pattern!r} matched {key} but its block's {what} ({size}) does not divide "
                           f"model axis ({n_model}) — falling back to REPLICATED")
                    if strict:
                        raise ValueError(msg)
                    if (pattern, size) not in warned:
                        warned.add((pattern, size))
                        log.warning(msg)
                break
        out[key] = spec
    return out


class RowParallelLinear(nn.Module):
    """nn.Linear with its input features sharded over the model group: the
    partial product x @ W_localᵀ, summed over the group in float32, then
    the bias, once. `weight` and `bias` keep nn.Linear's names."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor], mesh: Mesh):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)
        self.mesh = mesh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.mesh.all_reduce(F.linear(x, self.weight).float(), self.mesh.model_group)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)


def _column(lin: nn.Linear, rows: torch.Tensor) -> nn.Linear:
    """A Linear holding the output rows `rows` of `lin` (weight and bias)."""
    out = nn.Linear(lin.in_features, len(rows), bias=lin.bias is not None, device="meta")
    out.weight = nn.Parameter(lin.weight.detach()[rows].contiguous(), requires_grad=False)
    if lin.bias is not None:
        out.bias = nn.Parameter(lin.bias.detach()[rows].contiguous(), requires_grad=False)
    return out


def _row(lin: nn.Linear, cols: torch.Tensor, mesh: Mesh) -> RowParallelLinear:
    bias = None if lin.bias is None else lin.bias.detach()
    return RowParallelLinear(lin.weight.detach()[:, cols].contiguous(), bias, mesh)


def _slice(n: int, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous 1/n_model of range(n)."""
    k = n // mesh.shape["model"]
    return torch.arange(mesh.model_index * k, (mesh.model_index + 1) * k)


@torch.no_grad()
def shard_unet_params(unet: nn.Module, mesh: Mesh) -> nn.Module:
    """Apply the TP rules in place (latentblending_tpu/parallel/tp.py:84-91):
    each Attention and FeedForward block whose parameters unet_tp_specs
    shards keeps only this rank's slice, and each sharded Attention's
    `heads` becomes its local count. Blocks the specs replicate stay as
    they are. Returns the module."""
    specs = unet_tp_specs(unet, mesh)
    owners = {id(o): o for o in (_owner(unet, key) for key, spec in specs.items() if spec is not None)}
    for owner in owners.values():
        if isinstance(owner, Attention):
            cols = _slice(owner.heads * owner.dim_head, mesh)
            owner.to_q, owner.to_k, owner.to_v = (_column(m, cols) for m in (owner.to_q, owner.to_k, owner.to_v))
            owner.to_out[0] = _row(owner.to_out[0], cols, mesh)
            owner.heads //= mesh.shape["model"]
        else:
            geglu = owner.net[0]
            inner = owner.net[2].in_features
            local = _slice(inner, mesh)
            # GEGLU's proj gives [h | gate] and forward() takes chunk(2):
            # a contiguous split of its 2·inner outputs would hand rank 0 all
            # of h and rank 1 all of gate. Each rank keeps its slice of h AND
            # the same slice of gate, so the local chunk(2) pairs them up.
            geglu.proj = _column(geglu.proj, torch.cat([local, local + inner]))
            owner.net[2] = _row(owner.net[2], local, mesh)
    return unet
