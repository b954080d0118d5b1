"""Roofline terms for the dry run, with the H100's figures.

Port of ``src/repro/launch/roofline.py`` (``RooflineTerms``,
``roofline_terms``, ``model_flops`` and ``CollectiveStats``).  Three
terms per (arch, shape, mesh), all in seconds:

    compute    = FLOPs_per_card / peak FLOP/s
    memory     = bytes_per_card / HBM bandwidth
    collective = collective_bytes_per_card / interconnect bandwidth

The reference's ``collective_bytes`` parses XLA's HLO text, which the
port never produces; ``launch/cost.py`` counts the collectives from the
placements instead.

Hardware model (NVIDIA H100 SXM5 80 GB, per card, from NVIDIA's data
sheet):

* 989e12 bf16 FLOP/s dense tensor-core peak (the sparse figure is twice
  that);
* 3.35e12 B/s HBM3;
* NVLink 4: 900e9 B/s per card summed over both directions, 450e9 B/s
  each way, within one 8-card node;
* across nodes: one 400 Gb/s NDR InfiniBand NIC per card, 50e9 B/s each
  way.  A 16-wide mesh axis spans two 8-card nodes and the 256- and
  512-card production meshes span 32 and 64 nodes, so every axis of
  them crosses nodes: the collective term divides by the per-card
  InfiniBand rate (``LINK_BW``), one direction, as the reference
  divides by one ICI link's rate; the NVLink figure is not used.
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12          # bf16 dense FLOP/s per card
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 400e9 / 8          # bytes/s per card, one direction, InfiniBand


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict[str, int]
    count_by_kind: dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())


@dataclasses.dataclass
class RooflineTerms:
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes_per_chip: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops_total: float
    useful_flops_ratio: float          # MODEL_FLOPS / (FLOPs * chips)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def roofline_terms(cost: dict, coll: CollectiveStats, n_chips: int,
                   model_flops_total: float) -> RooflineTerms:
    """cost: ``{"flops", "bytes accessed"}`` of one card; the figures
    are the module's (``PEAK_FLOPS``, ``HBM_BW``, ``LINK_BW``)."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    cbytes = float(coll.total_bytes)
    compute_s = flops / PEAK_FLOPS
    memory_s = byts / HBM_BW
    collective_s = cbytes / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    total = flops * n_chips
    return RooflineTerms(
        flops_per_chip=flops,
        bytes_per_chip=byts,
        collective_bytes_per_chip=cbytes,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bottleneck=bottleneck,
        model_flops_total=model_flops_total,
        useful_flops_ratio=(model_flops_total / total if total else 0.0),
    )


# ----------------------------------------------------------------------
# MODEL_FLOPS: 6*N*D (train) / 2*N*D (inference) + attention terms
# ----------------------------------------------------------------------
def model_flops(cfg, shape) -> float:
    """Useful FLOPs for one step of this cell (active params for MoE:
    ``cfg.active_param_count()``, the port's exact count; the
    reference's count leaves a few leaves out, ROADMAP §C)."""
    n_active = cfg.active_param_count()
    b, s = shape.global_batch, shape.seq_len
    n_attn = sum(1 for i in range(cfg.n_layers) if cfg.layer_is_attn(i))
    hd, h = cfg.head_dim, cfg.n_heads
    if shape.kind == "train":
        tokens = b * s
        mm = 6.0 * n_active * tokens
        attn = n_attn * 3 * 2 * 2 * b * s * s * h * hd * 0.5  # causal, fwd+bwd
    elif shape.kind == "prefill":
        tokens = b * s
        mm = 2.0 * n_active * tokens
        attn = n_attn * 2 * 2 * b * s * s * h * hd * 0.5
    else:  # decode: one token against an s-long context
        tokens = b
        mm = 2.0 * n_active * tokens
        attn = n_attn * 2 * 2 * b * s * h * hd
    if cfg.family == "ssm" or cfg.ssm is not None:
        # linear-attention state updates: ~6 flops per (head, dk, dv) elem
        n_lin = cfg.n_layers - n_attn
        if cfg.rwkv is not None:
            dk = dv = cfg.rwkv.head_dim
            heads = cfg.d_model // dk
        else:
            dk = cfg.ssm.d_state
            dv = cfg.ssm.head_dim
            heads = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
        per_tok = 6.0 * heads * dk * dv
        mult = 3.0 if shape.kind == "train" else 1.0
        n_tok = b if shape.kind == "decode" else b * s
        attn += n_lin * per_tok * n_tok * mult
    return mm + attn
