#!/usr/bin/env python3
"""How far RWKV-6's two bf16 paths drift from f32, by depth.

    python3 tools/rwkv_bf16_drift.py                  # on a CUDA card
    PYTHONPATH=src python tools/rwkv_bf16_drift.py --reference

Card mode: rwkv6-3b at full width (seeded weights, ``bonus_u``, ``mix``
and ``decay_w0`` seeded as ``chip_smoke.py`` seeds them), the first
1, 2, 4, 8, 16 and 32 layers.  Two prompts of 16 tokens go through the
prefill (``recurrent_scan``) and teacher-forced decode steps
(``recurrent_step``) in bf16, and through both again with the same
weights widened to f32.  Prints per depth the bf16 decode-vs-prefill
gap, each bf16 path's distance from the f32 logits of the same path,
the f32 gap and the greedy argmax agreement of each bf16 path with f32.

``--reference`` (on the CPU, with JAX): reduced rwkv6-3b at 8 layers,
and at 4 layers of d_model 512 with heads of 64; the reference's
weights, their constant leaves seeded as ``tests/_torch_families.py``
seeds them, go to the port.  Prints the reference's own bf16
decode-vs-prefill gap beside the port's on the same weights.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

T = 16


def paths(cfg, params, toks, device):
    """(prefill logits, decode logits) of ``toks``, both f32 tensors."""
    import torch

    from repro_torch.models.model import Model

    model = Model(cfg)
    par, _, _ = model.forward(params, {"tokens": toks})
    state = model.init_decode_state(toks.shape[0], 64, device=device)
    seq = []
    for i in range(toks.shape[1]):
        lg, state = model.decode_step(params, state, toks[:, i])
        seq.append(lg)
    return par.float(), torch.stack(seq, 1).float()


def first_layers(params, n: int) -> dict:
    def cut(node):
        if isinstance(node, dict):
            return {k: cut(v) for k, v in node.items()}
        return node[:n]

    return {**params, "blocks": [cut(sub) for sub in params["blocks"]]}


def card() -> None:
    import torch

    import chip_smoke
    from repro_torch.configs import RWKV6_3B
    from repro_torch.models.params import init_params

    if not torch.cuda.is_available():
        raise SystemExit("card mode needs a CUDA device (or --reference)")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"card: {chip_smoke.card_line()}")
    cfg = RWKV6_3B
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    chip_smoke.seed_rwkv(params, dev)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        1, cfg.vocab_size, (2, T))).to(dev)
    depths = (1, 2, 4, 8, 16, 32)
    bf16 = {n: paths(dataclasses.replace(cfg, n_layers=n),
                     first_layers(params, n), toks, dev) for n in depths}
    chip_smoke.widen_f32(params)
    for n in depths:
        fp, fd = paths(dataclasses.replace(cfg, n_layers=n, dtype="float32"),
                       first_layers(params, n), toks, dev)
        bp, bd = bf16[n]
        print(f"n_layers {n:2d}: bf16 |decode - prefill| "
              f"{float((bd - bp).abs().max()):.4g}; bf16 prefill vs f32 "
              f"{float((bp - fp).abs().max()):.4g}; bf16 decode vs f32 "
              f"{float((bd - fd).abs().max()):.4g}; f32 |decode - prefill| "
              f"{float((fd - fp).abs().max()):.3g}; largest logit "
              f"{float(fp.abs().max()):.4g}; greedy argmax equal to f32: "
              f"bf16 prefill {int((bp.argmax(-1) == fp.argmax(-1)).sum())}"
              f"/{bp.shape[0] * T}, bf16 decode "
              f"{int((bd.argmax(-1) == fd.argmax(-1)).sum())}"
              f"/{bd.shape[0] * T}")


def reference() -> None:
    import jax
    import jax.numpy as jnp
    import torch

    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_families import seeded
    from repro.configs import get_config
    from repro.models.model import Model as RefModel
    from repro_torch import configs as port_configs
    from repro_torch.models.params import params_from_jax

    wide = dict(n_layers=4, d_model=512, n_heads=8, n_kv_heads=8,
                head_dim=64, d_ff=1792)
    for kw in (dict(n_layers=8), wide):
        rcfg = get_config("rwkv6-3b").reduced(**kw)
        pcfg = port_configs.RWKV6_3B.reduced(**kw)
        if "head_dim" in kw:
            rcfg, pcfg = (dataclasses.replace(c, rwkv=dataclasses.replace(
                c.rwkv, head_dim=64, decay_lora=64)) for c in (rcfg, pcfg))
        np_params = seeded(jax.tree.map(np.asarray, RefModel(
            rcfg, remat="none").init(jax.random.PRNGKey(0))))
        jp = jax.tree.map(jnp.asarray, np_params)
        toks = np.random.default_rng(3).integers(
            0, rcfg.vocab_size, (2, T)).astype(np.int32)
        ref = RefModel(rcfg, remat="none")
        rpar = np.asarray(jax.jit(ref.forward)(
            jp, {"tokens": jnp.asarray(toks)})[0].astype(jnp.float32))
        state, step, seq = ref.init_decode_state(2, 64), \
            jax.jit(ref.decode_step), []
        for i in range(T):
            lg, state = step(jp, state, jnp.asarray(toks[:, i]), None)
            seq.append(np.asarray(lg.astype(jnp.float32)))
        rdec = np.stack(seq, 1)
        ppar, pdec = (t.numpy() for t in paths(
            pcfg, params_from_jax(np_params, device="cpu"),
            torch.from_numpy(toks), "cpu"))
        print(f"{kw}: bf16 |decode - prefill| reference "
              f"{np.abs(rdec - rpar).max():.4g}, port "
              f"{np.abs(pdec - ppar).max():.4g}; port vs reference: prefill "
              f"{np.abs(ppar - rpar).max():.4g}, decode "
              f"{np.abs(pdec - rdec).max():.4g}; largest logit "
              f"{np.abs(rpar).max():.4g}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reference", action="store_true",
                    help="compare with the JAX reference on the CPU")
    args = ap.parse_args()
    reference() if args.reference else card()
    return 0


if __name__ == "__main__":
    sys.exit(main())
