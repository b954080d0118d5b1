"""The encoder-decoder family (whisper-medium) on the port against the
reference.

Reduced whisper-medium (2 decoder and 2 encoder layers, d_model 128, 4
heads of 32, 32 encoder frames, LayerNorm, biases, sinusoidal positions).
The reference's weights, every bias and LayerNorm bias drawn from a
seed, go to the port through ``params_from_jax``
(``tests/_torch_families.py``); frames are seeded numpy arrays.  No
kernel is on this path: the attention is the plain ``flash_attention``
in both packages.

Tolerances: the sinusoidal table, ``encode``, ``cross_kv`` and
``cross_attention_block`` in float32 within ``BLOCK_TOL`` = 1e-5 (rtol =
atol); the model's logits as ``_torch_families`` states (f32 1e-4, bf16
4 ulps of the largest logit); decode == prefill in f32 at the
reference's 1e-3.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from _torch_families import (  # noqa: E402
    B,
    DECODE_PREFILL_TOL,
    DECODE_STEPS,
    MAX_SEQ,
    assert_init_tree_matches,
    cfgs,
    close,
    engine_tokens_match,
    models,
    to_np,
    tokens,
)

from repro.models import attention as rattn  # noqa: E402
from repro.models.layers import (  # noqa: E402
    sinusoidal_positions as ref_sinusoidal,
)
from repro.models.model import Model as RefModel  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    build_prefill_step,
    build_serve_step,
)
from repro_torch.models import attention as pattn  # noqa: E402
from repro_torch.models.layers import sinusoidal_positions  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.transformer import period_template  # noqa: E402

ARCH = "whisper-medium"
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _frames(cfg, seed=5):
    return _x((B, cfg.encoder.n_ctx, cfg.d_model), seed)


@pytest.fixture(scope="module")
def f32_model():
    return models(ARCH, "float32")


# ----------------------------------------------------------------------
# configs and parameters
# ----------------------------------------------------------------------
def test_config_and_reduced_config_equal_reference():
    from repro.configs import get_config

    full = port_configs.WHISPER_MEDIUM
    assert dataclasses.asdict(full) == dataclasses.asdict(get_config(ARCH))
    assert port_configs.get_config(ARCH) is full
    rcfg, pcfg = cfgs(ARCH, "bfloat16")
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(rcfg)
    assert (pcfg.encoder.n_layers, pcfg.encoder.n_ctx) == (2, 32)
    assert [s.cross for s in period_template(pcfg)] == [True]


def test_init_params_tree_and_param_count():
    """The decoder's blocks with ``cross`` and ``norm_cross``, and the
    ``encoder`` subtree with its blocks and final norm."""
    assert_init_tree_matches(*cfgs(ARCH, "bfloat16"))
    assert port_configs.WHISPER_MEDIUM.param_count() == 1_013_176_320


# ----------------------------------------------------------------------
# positions, encoder, cross-attention
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n,d", [(32, 128), (448, 1024), (1500, 1024)])
def test_sinusoidal_positions_match_reference(n, d):
    got = sinusoidal_positions(n, d)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    np.testing.assert_allclose(got.numpy(), to_np(ref_sinusoidal(n, d)),
                               **BLOCK_TOL)


def test_encode_matches_reference(f32_model):
    rcfg, pcfg, params, _, pp = f32_model
    frames = _frames(rcfg)
    want = RefModel(rcfg, remat="none").encode(params, jnp.asarray(frames))
    got = Model(pcfg).encode(pp, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), to_np(want), **BLOCK_TOL)


def test_cross_kv_and_cross_attention_block_match_reference(f32_model):
    """Layer 0's cross K/V of a memory and its cross-attention, from the
    memory and from precomputed K/V; ``attention_block`` without a causal
    mask."""
    rcfg, pcfg, params, np_params, pp = f32_model
    rp = jax.tree.map(lambda a: a[0], params["blocks"][0]["cross"])
    tp = {k: v[0] for k, v in pp["blocks"][0]["cross"].items()}
    mem, x = _x((B, 32, 128), 6), _x((B, 5, 128), 7)
    rk, rv = rattn.cross_kv(rcfg, rp, jnp.asarray(mem))
    pk, pv = pattn.cross_kv(pcfg, tp, torch.from_numpy(mem))
    for g, w in ((pk, rk), (pv, rv)):
        np.testing.assert_allclose(g.numpy(), to_np(w), **BLOCK_TOL)
    want = rattn.cross_attention_block(rcfg, rp, jnp.asarray(x),
                                       memory=jnp.asarray(mem))
    for got in (pattn.cross_attention_block(pcfg, tp, torch.from_numpy(x),
                                            memory=torch.from_numpy(mem)),
                pattn.cross_attention_block(pcfg, tp, torch.from_numpy(x),
                                            kv=(pk, pv))):
        np.testing.assert_allclose(got.numpy(), to_np(want), **BLOCK_TOL)
    sp = jax.tree.map(lambda a: a[0], params["blocks"][0]["attn"])
    ap = {k: v[0] for k, v in pp["blocks"][0]["attn"].items()}
    pos = np.broadcast_to(np.arange(5)[None], (B, 5)).copy()
    want = rattn.attention_block(rcfg, sp, jnp.asarray(x), jnp.asarray(pos),
                                 None, causal=False)
    got = pattn.attention_block(pcfg, ap, torch.from_numpy(x),
                                torch.from_numpy(pos), None, causal=False)
    np.testing.assert_allclose(got.numpy(), to_np(want), **BLOCK_TOL)


def test_precompute_cross_kv_matches_reference(f32_model):
    rcfg, pcfg, params, _, pp = f32_model
    mem = _x((B, 32, 128), 6)
    rk, rv = RefModel(rcfg, remat="none").precompute_cross_kv(
        params, jnp.asarray(mem))
    pk, pv = Model(pcfg).precompute_cross_kv(pp, torch.from_numpy(mem))
    assert pk.shape == rk.shape == (rcfg.n_layers, B, 32, rcfg.n_kv_heads,
                                    rcfg.head_dim)
    for g, w in ((pk, rk), (pv, rv)):
        np.testing.assert_allclose(g.numpy(), to_np(w), **BLOCK_TOL)


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref_runs():
    """Per dtype: the reference's prefill logits and caches over tokens
    and frames, and its logits over DECODE_STEPS teacher-forced steps
    with the frames' cross K/V."""
    cache = {}

    def get(dtype):
        if dtype not in cache:
            rcfg, pcfg, params, _, pp = models(ARCH, dtype)
            model = RefModel(rcfg, remat="none")
            toks, frames = tokens(rcfg.vocab_size), _frames(rcfg)
            logits, _, caches = jax.jit(
                lambda p, b: model.forward(p, b, collect_cache=True))(
                    params, {"tokens": jnp.asarray(toks),
                             "frames": jnp.asarray(frames)})
            mem = jax.jit(model.encode)(params, jnp.asarray(frames))
            ckv = model.precompute_cross_kv(params, mem)
            state = model.init_decode_state(B, MAX_SEQ)
            step = jax.jit(model.decode_step)
            steps = []
            for i in range(DECODE_STEPS):
                lg, state = step(params, state, jnp.asarray(toks[:, i]), ckv)
                steps.append(to_np(lg))
            cache[dtype] = dict(
                pcfg=pcfg, pp=pp, toks=toks, frames=frames,
                logits=to_np(logits),
                caches=[(to_np(k), to_np(v)) for k, v in caches],
                steps=np.stack(steps, axis=1))
        return cache[dtype]

    return get


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_and_caches_match_reference(ref_runs, dtype):
    r = ref_runs(dtype)
    logits, caches = build_prefill_step(r["pcfg"])(
        r["pp"], {"tokens": torch.from_numpy(r["toks"]),
                  "frames": torch.from_numpy(r["frames"])})
    assert logits.dtype == getattr(torch, dtype)
    close(logits, r["logits"], dtype)
    assert len(caches) == len(r["caches"]) == 1
    for (pk, pv), (rk, rv) in zip(caches, r["caches"]):
        close(pk, rk, dtype)
        close(pv, rv, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_with_cross_kv_match_reference(ref_runs, dtype):
    """DECODE_STEPS teacher-forced steps through ``build_serve_step`` with
    ``precompute_cross_kv`` of the encoded frames."""
    r = ref_runs(dtype)
    model = Model(r["pcfg"])
    ckv = model.precompute_cross_kv(
        r["pp"], model.encode(r["pp"], torch.from_numpy(r["frames"])))
    step = build_serve_step(r["pcfg"])
    state = model.init_decode_state(B, MAX_SEQ, device="cpu")
    got = []
    for i in range(DECODE_STEPS):
        lg, state = step(r["pp"], state, torch.from_numpy(r["toks"][:, i]),
                         ckv)
        got.append(to_np(lg))
    close(np.stack(got, axis=1), r["steps"], dtype)
    assert (state["pos"].numpy() == DECODE_STEPS).all()


def test_decode_without_cross_kv_matches_reference(f32_model):
    """Without ``cross_kv`` the decoder skips its cross-attention, as the
    reference's does (the engine's ``DenseAdapter`` steps so)."""
    rcfg, pcfg, params, _, pp = f32_model
    toks = tokens(rcfg.vocab_size, (B, 3), 4)
    ref = RefModel(rcfg, remat="none")
    rs = ref.init_decode_state(B, MAX_SEQ)
    ps = Model(pcfg).init_decode_state(B, MAX_SEQ, device="cpu")
    for i in range(3):
        rl, rs = ref.decode_step(params, rs, jnp.asarray(toks[:, i]))
        pl, ps = Model(pcfg).decode_step(pp, ps, torch.from_numpy(toks[:, i]))
        close(pl, rl, "float32")


def test_port_decode_matches_prefill_f32(f32_model):
    """The port's prefill (encoder memory, flash cross-attention) and its
    decode steps over the memory's precomputed cross K/V, at the
    reference's own bound."""
    _, pcfg, _, _, pp = f32_model
    model = Model(pcfg)
    toks = torch.from_numpy(tokens(pcfg.vocab_size, (B, DECODE_STEPS), 3))
    frames = torch.from_numpy(_frames(pcfg, 8))
    par, _, _ = model.forward(pp, {"tokens": toks, "frames": frames})
    ckv = model.precompute_cross_kv(pp, model.encode(pp, frames))
    state = model.init_decode_state(B, MAX_SEQ, device="cpu")
    seq = []
    for i in range(DECODE_STEPS):
        lg, state = model.decode_step(pp, state, toks[:, i], ckv)
        seq.append(lg)
    torch.testing.assert_close(torch.stack(seq, dim=1), par,
                               **DECODE_PREFILL_TOL)


def test_engine_dense_adapter_greedy_tokens_match_reference(f32_model):
    rcfg, pcfg, params, _, pp = f32_model
    engine_tokens_match(rcfg, pcfg, params, pp)


def test_serve_cli_whisper_completes(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                "--requests", "3", "--batch-size", "2", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "serving path: dense (encdec, 2 layers" in out
    assert "completed=3/3" in out
