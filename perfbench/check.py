"""What decides ``correct``: the served tokens against the plain reference.

Once the window has closed, a sample of the requests it finished, drawn
from the seed and always holding the longest, is run through the
reference once each, teacher-forced over its prompt and its served
tokens.  For every served token the gap by which the reference's logit
of that token lies below the reference's best at that position is read;
the widest gap over the sample is the number compared with the
configuration's limit.  A greedy server that computes what the
configuration states picks the reference's best or a token within its
rounding of it.

The control (``gaps(..., control=True)``) reads, at the same positions, the gap
of the token that the reference computed one precision lower puts first.
"""
from __future__ import annotations

import numpy as np
import torch

from .reference.model import served_logits

#: the control's activation type: the step below the served bf16
CONTROL_ACT = "float8_e4m3fn"


def sample(logs, w0: float, w1: float, seed: int, n: int) -> list:
    """Up to ``n`` requests finished in the window (all finished ones if
    none finished in it): the longest, and a draw from the seed."""
    done = [g for g in logs if g.done is not None and g.done <= w1
            and len(g.tokens) == g.max_new]
    inside = [g for g in done if g.done > w0] or done
    if not inside:
        return []
    longest = max(inside, key=lambda g: (len(g.prompt) + len(g.tokens),
                                         -g.uid))
    rest = [g for g in inside if g is not longest]
    rng = np.random.default_rng([int(seed), 2])
    pick = sorted(rng.choice(len(rest), size=min(n - 1, len(rest)),
                             replace=False).tolist()) if rest else []
    return [longest] + [rest[i] for i in pick]


def statistics(g: torch.Tensor) -> dict[str, float]:
    """The numbers read from a run's gaps: the widest, and the mean over
    every served token (each token's gap is 0 where it is the reference's
    best, so the mean weighs how often and how far the tokens part)."""
    if not g.numel():
        return {"max_logit_gap": float("inf"), "mean_logit_gap": float("inf")}
    return {"max_logit_gap": float(g.max()), "mean_logit_gap": float(g.mean())}


def _inputs(picked):
    seqs = [g.prompt + g.tokens[:-1] for g in picked]
    starts = [len(g.prompt) - 1 for g in picked]
    return seqs, starts


def gaps(shape, quant, weights, picked, *, control: bool = False) -> dict:
    """``{"served": ...}``: per served token of ``picked``, the
    reference's best logit minus its logit of the served token; with
    ``control``, also ``"control"``: the same gap of the token the fp8
    control puts first at each of those positions.  f32 tensors on the
    weights' device."""
    seqs, starts = _inputs(picked)
    ref = served_logits(shape, quant, weights, seqs, starts, act=shape.dtype)
    best = [r.max(dim=-1).values for r in ref]
    out = {"served": torch.cat([
        b - r.gather(1, torch.as_tensor(g.tokens, dtype=torch.int64,
                                        device=r.device)[:, None])[:, 0]
        for g, r, b in zip(picked, ref, best)])}
    if control:
        low = served_logits(shape, quant, weights, seqs, starts,
                            act=CONTROL_ACT)
        out["control"] = torch.cat([
            b - r.gather(1, c.argmax(dim=-1, keepdim=True))[:, 0]
            for r, c, b in zip(ref, low, best)])
    return out
