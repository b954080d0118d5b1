"""End-to-end example (the paper's kind: serving/data movement): serve a
small LM with batched requests where the decode-step weights are
int-quantized, Iris-organized, and dequantized on load by the CUDA
matmul kernels — dense bf16 weights never exist in memory.

Port of the reference's ``examples/packed_serving.py``.  Reports per-token
weight-streaming bytes vs the bf16 and padded-int baselines (the
memory-roofline win of the paper's technique), plus the Iris layout
metrics of the per-layer stream bundles.  On the card ``api.pack_tree``
packs with ``pack_layout_fused``; int2/4/8 serve through the lane-packed
``packed_matmul``, every other width stream-direct through
``stream_matmul``; the packed checkpoint restores with
``decode_layout_fused``.  ``--device cpu`` runs the kernels' plain
PyTorch versions instead.

Run:  PYTHONPATH=src python -m repro_torch.examples.packed_serving
      [--bits 8] [--device cpu]
"""
from __future__ import annotations

import argparse
import pathlib
import tempfile
import time

import numpy as np
import torch

from repro_torch import api
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.models.quantized import (
    bytes_per_token_report,
    packed_decode_step,
)
from repro_torch.pytree import flatten
from repro_torch.quant import QuantSpec

#: the reference's bundle width (bits a bus cycle) for this example
M = 512
MAX_SEQ = 64


def config():
    """The reference example's reduced smollm-135m."""
    return get_config("smollm-135m").reduced(
        n_layers=4, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
        vocab_size=512, head_dim=64)


def pack_section(cfg, params, bits: int, device) -> api.PackedTree:
    """Quantize, plan and pack ``params`` on ``device`` through the front
    door; print the tree's summary and the bytes per decode token."""
    spec = QuantSpec(bits=bits, group_size=64)
    print(f"=== Quantize + pack ({bits}-bit, model {cfg.name} "
          f"reduced) ===")
    # the one front door: quantize -> plan -> pack, one call, one pytree
    pp = api.pack_tree(cfg, params, spec, m=M, device=device)
    print(pp.summary())
    rep = bytes_per_token_report(cfg, pp)
    print(f"weight stream per decode token: packed={rep['packed_MiB']:.2f} "
          f"MiB  padded-int={rep['padded_int_MiB']:.2f} MiB  "
          f"bf16={rep['bf16_MiB']:.2f} MiB")
    print(f"reduction vs bf16: {rep['bf16_MiB']/rep['packed_MiB']:.2f}x")
    return pp


def layout_section(cfg, spec: QuantSpec) -> None:
    """The layer stack's plan line (host planning only)."""
    print("\n=== Iris stream layout per layer (repro_torch.api façade) ===")
    stack = api.plan_layer_stack(cfg, spec, m=M)
    hom = api.compare(stack.problem, strategies=("homogeneous",))
    print(f"B_eff={stack.b_eff:.4f} "
          f"L_max={stack.plans[0].metrics.l_max} "
          f"(homogeneous: {hom['homogeneous'].l_max}); "
          f"decode units={stack.plans[0].decode_plan.n_units}; "
          f"{stack.n_layers} layers from {stack.scheduler_runs} "
          f"scheduler run(s)")


def generate(step, state: dict, toks: torch.Tensor, new_tokens: int
             ) -> list[list[int]]:
    """Greedy generation: ``new_tokens`` calls of ``step(state, toks) ->
    (logits, state)``, each feeding back its argmax.  Returns each row's
    tokens."""
    outs = [[] for _ in range(toks.shape[0])]
    for _ in range(new_tokens):
        logits, state = step(state, toks)
        toks = logits.argmax(-1).to(torch.int32)
        for i, t in enumerate(toks.tolist()):
            outs[i].append(t)
    return outs


def checkpoint_section(pp) -> bool:
    """Save the tree as a packed checkpoint and restore it on the tree's
    device; returns whether every stream, view, scale and unquantized
    leaf came back bit-identical."""
    print("\n=== Packed checkpoint (the HBM stream is the checkpoint) ===")
    with tempfile.TemporaryDirectory() as td:
        mgr = CheckpointManager(td, keep_n=1)
        path = mgr.save_packed(0, pp)
        pt2, _ = mgr.restore_packed(device=pp.device)
        same = torch.equal(pp.streams, pt2.streams) and all(
            torch.equal(getattr(pp, part)[k], getattr(pt2, part)[k])
            for part in ("packed", "scales") for k in getattr(pp, part))
        same = same and all(torch.equal(a, b) for a, b in zip(
            flatten(pp.other), flatten(pt2.other)))
        size = sum(f.stat().st_size for f in pathlib.Path(path).iterdir())
        print(f"restore bit-identical={same} layout={pt2.provenance} "
              f"on-disk={size/2**20:.2f} MiB")
    return same


def run(bits: int = 8, batch: int = 4, new_tokens: int = 8, device=None,
        params=None) -> dict:
    """The example at ``bits``: pack, plan line, ``batch`` greedy requests
    of ``new_tokens`` through the packed decode step, the packed
    checkpoint, and top-1 agreement of one packed step with the dense
    ``Model.decode_step``.  ``params`` (on ``device``) are the model's,
    else drawn from a generator seeded 0.  Returns the tokens, the
    restore's equality and the agreement."""
    device = resolve_device(device)
    cfg = config()
    model = Model(cfg, remat="none")
    if params is None:
        params = model.init(torch.Generator(device=device).manual_seed(0),
                            device=device)
    pp = pack_section(cfg, params, bits, device)
    layout_section(cfg, pp.spec)

    print("\n=== Batched generation (packed decode path) ===")
    state = model.init_decode_state(batch, max_seq=MAX_SEQ, device=device)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, batch),
                           dtype=torch.int32, device=device)
    t0 = time.perf_counter()
    outs = generate(lambda st, t: packed_decode_step(cfg, pp, st, t),
                    state, toks, new_tokens)
    dt = time.perf_counter() - t0
    for i, o in enumerate(outs):
        print(f"request {i}: {o}")
    where = (f"CUDA kernels on {torch.cuda.get_device_name(device)}"
             if device.type == "cuda"
             else "plain PyTorch versions on the CPU")
    print(f"\n{batch * new_tokens} tokens in {dt:.1f}s ({where})")

    same = checkpoint_section(pp)

    # cross-check against the dense path for the first step (each on a
    # fresh state: the dense step writes its caches in place)
    t = torch.as_tensor(rng.integers(0, cfg.vocab_size, batch),
                        dtype=torch.int32, device=device)
    dlog, _ = model.decode_step(
        params, model.init_decode_state(batch, MAX_SEQ, device=device), t)
    qlog, _ = packed_decode_step(
        cfg, pp, model.init_decode_state(batch, MAX_SEQ, device=device), t)
    agree = float((dlog.argmax(-1) == qlog.argmax(-1)).float().mean())
    print(f"top-1 agreement packed vs dense: {agree:.0%}  [OK]")
    return {"cfg": cfg, "params": params, "tree": pp, "first": toks,
            "tokens": outs, "restore_same": same, "agreement": agree}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    return run(args.bits, args.batch, args.new_tokens, args.device)


if __name__ == "__main__":
    main()
