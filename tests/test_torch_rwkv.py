"""RWKV-6 (rwkv6-3b) on the port against the reference.

Reduced rwkv6-3b (2 layers, d_model 128, 4 heads of 32, decay LoRA 16).
The reference's weights, with ``bonus_u``, ``mix`` and ``decay_w0`` (and
every bias) drawn from a seed, go to the port through
``params_from_jax`` (``tests/_torch_families.py``).  Both packages run
the time mix over their plain ``recurrent_scan`` / ``recurrent_step`` in
rwkv mode; no kernel is on this path.

Tolerances: each mix and step in float32 within ``MIX_TOL`` = 1e-5
(rtol = atol; the two packages take the same sums in other orders);
the model's logits as ``_torch_families`` states (f32 1e-4, bf16 4 ulps
of the largest logit); decode == prefill in f32 at the reference's 1e-3.
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
    S,
    assert_init_tree_matches,
    cfgs,
    close,
    engine_tokens_match,
    models,
    seeded,
    to_np,
    tokens,
)

from repro.models import rwkv as rrwkv  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.engine import DenseAdapter  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    build_prefill_step,
    build_serve_step,
)
from repro_torch.models import rwkv as prwkv  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import params_from_jax  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    forward_stack,
    period_template,
)

ARCH = "rwkv6-3b"
MIX_TOL = dict(rtol=1e-5, atol=1e-5)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


@pytest.fixture(scope="module")
def sub():
    """One time mix and one channel mix of the reduced config (f32), the
    reference's init with its constant leaves seeded."""
    rcfg, pcfg = cfgs(ARCH)
    tp = seeded(jax.tree.map(np.asarray, rrwkv.init_rwkv_time_mix(
        jax.random.PRNGKey(3), rcfg)), seed=11)
    cp = seeded(jax.tree.map(np.asarray, rrwkv.init_rwkv_channel_mix(
        jax.random.PRNGKey(4), rcfg)), seed=12)
    return rcfg, pcfg, tp, cp


@pytest.fixture(scope="module")
def f32_model():
    return models(ARCH, "float32")


# ----------------------------------------------------------------------
# configs and parameters
# ----------------------------------------------------------------------
def test_config_and_reduced_config_equal_reference():
    from repro.configs import get_config

    full = port_configs.RWKV6_3B
    assert dataclasses.asdict(full) == dataclasses.asdict(get_config(ARCH))
    assert port_configs.get_config(ARCH) is full
    rcfg, pcfg = cfgs(ARCH, "bfloat16")
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(rcfg)
    assert pcfg.rwkv.head_dim == 32 and pcfg.rwkv.decay_lora == 16
    assert [s.mixer for s in period_template(pcfg)] == ["rwkv"]


def test_init_params_tree_and_param_count():
    assert_init_tree_matches(*cfgs(ARCH, "bfloat16"))
    full = port_configs.RWKV6_3B
    assert full.param_count() == 2_863_434_240


def test_seeded_constants_reach_the_port(f32_model):
    """The constant inits are replaced: a dropped term would show."""
    _, _, _, np_params, pp = f32_model
    p = pp["blocks"][0]["rwkv_t"]
    for key in ("bonus_u", "mix", "decay_w0"):
        assert p[key].dtype == torch.float32
        assert float(p[key].std()) > 0.1, key
    assert torch.equal(p["mix"], torch.from_numpy(
        np_params["blocks"][0]["rwkv_t"]["mix"]))


# ----------------------------------------------------------------------
# the mixes
# ----------------------------------------------------------------------
@pytest.mark.parametrize("with_prev", [False, True])
def test_token_shift_and_decay_log_match_reference(sub, with_prev):
    _, _, tp, _ = sub
    x = _x((B, 7, 128))
    prev = _x((B, 128), seed=2) if with_prev else None
    want = rrwkv._token_shift(jnp.asarray(x),
                              None if prev is None else jnp.asarray(prev))
    got = prwkv._token_shift(torch.from_numpy(x),
                             None if prev is None else torch.from_numpy(prev))
    assert np.array_equal(got.numpy(), to_np(want))
    pp = params_from_jax(tp, device="cpu")
    np.testing.assert_allclose(
        prwkv._decay_log(pp, torch.from_numpy(x)).numpy(),
        to_np(rrwkv._decay_log(jax.tree.map(jnp.asarray, tp),
                               jnp.asarray(x))), **MIX_TOL)


@pytest.mark.parametrize("streamed", [False, True])
def test_time_mix_matches_reference(sub, streamed):
    """``apply_rwkv_time_mix`` over T=20 (not a multiple of the scan's
    chunk): the output, the final state and the last x; ``streamed``
    carries a previous shift and state in."""
    rcfg, pcfg, tp, _ = sub
    x = _x((B, 20, 128))
    prev = _x((B, 128), seed=2) if streamed else None
    s0 = _x((B, 4, 32, 32), seed=3) if streamed else None
    ry, rs, rl = rrwkv.apply_rwkv_time_mix(
        rcfg, jax.tree.map(jnp.asarray, tp), jnp.asarray(x),
        None if prev is None else jnp.asarray(prev),
        None if s0 is None else jnp.asarray(s0))
    py, ps, pl = prwkv.apply_rwkv_time_mix(
        pcfg, params_from_jax(tp, device="cpu"), torch.from_numpy(x),
        None if prev is None else torch.from_numpy(prev),
        None if s0 is None else torch.from_numpy(s0))
    for got, want in ((py, ry), (ps, rs), (pl, rl)):
        np.testing.assert_allclose(to_np(got), to_np(want), **MIX_TOL)
    assert ps.dtype == torch.float32


def test_time_mix_step_matches_reference(sub):
    rcfg, pcfg, tp, _ = sub
    x, sh, s0 = _x((B, 128)), _x((B, 128), seed=2), _x((B, 4, 32, 32), 3)
    want = rrwkv.apply_rwkv_time_mix_step(
        rcfg, jax.tree.map(jnp.asarray, tp), *map(jnp.asarray, (x, sh, s0)))
    got = prwkv.apply_rwkv_time_mix_step(
        pcfg, params_from_jax(tp, device="cpu"),
        *map(torch.from_numpy, (x, sh, s0)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), to_np(w), **MIX_TOL)


@pytest.mark.parametrize("with_prev", [False, True])
def test_channel_mix_and_step_match_reference(sub, with_prev):
    rcfg, pcfg, _, cp = sub
    rp, pp = jax.tree.map(jnp.asarray, cp), params_from_jax(cp, device="cpu")
    x = _x((B, 9, 128))
    prev = _x((B, 128), seed=2) if with_prev else None
    want = rrwkv.apply_rwkv_channel_mix(
        rcfg, rp, jnp.asarray(x), None if prev is None else jnp.asarray(prev))
    got = prwkv.apply_rwkv_channel_mix(
        pcfg, pp, torch.from_numpy(x),
        None if prev is None else torch.from_numpy(prev))
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), to_np(w), **MIX_TOL)
    sh = _x((B, 128), seed=4)
    want = rrwkv.apply_rwkv_channel_mix_step(rcfg, rp, jnp.asarray(x[:, 0]),
                                             jnp.asarray(sh))
    got = prwkv.apply_rwkv_channel_mix_step(pcfg, pp,
                                            torch.from_numpy(x[:, 0]),
                                            torch.from_numpy(sh))
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), to_np(w), **MIX_TOL)


def test_forward_stack_matches_reference(f32_model):
    from repro.models.transformer import forward_stack as ref_stack

    rcfg, pcfg, params, _, pp = f32_model
    x = _x((B, S, 128))
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).copy()
    rx, raux, rc = ref_stack(rcfg, params["blocks"], jnp.asarray(x),
                             jnp.asarray(pos), collect_cache=True,
                             remat="none")
    px, paux, pc = forward_stack(pcfg, pp["blocks"], torch.from_numpy(x),
                                 torch.from_numpy(pos), collect_cache=True)
    np.testing.assert_allclose(px.numpy(), to_np(rx), rtol=1e-4, atol=1e-4)
    assert float(paux) == float(raux) == 0.0
    assert pc == () and len(rc) == 0          # attention-free: no KV cache


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref_runs():
    """Per dtype: the reference's prefill logits and its logits and state
    over DECODE_STEPS teacher-forced steps."""
    cache = {}

    def get(dtype):
        if dtype not in cache:
            rcfg, pcfg, params, np_params, pp = models(ARCH, dtype)
            model = RefModel(rcfg, remat="none")
            toks = tokens(rcfg.vocab_size)
            logits, _, _ = jax.jit(model.forward)(
                params, {"tokens": jnp.asarray(toks)})
            state = model.init_decode_state(B, MAX_SEQ)
            step = jax.jit(model.decode_step)
            steps = []
            for i in range(DECODE_STEPS):
                lg, state = step(params, state, jnp.asarray(toks[:, i]),
                                 None)
                steps.append(to_np(lg))
            cache[dtype] = dict(pcfg=pcfg, pp=pp, toks=toks,
                                logits=to_np(logits),
                                steps=np.stack(steps, axis=1), state=state)
        return cache[dtype]

    return get


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_reference(ref_runs, dtype):
    r = ref_runs(dtype)
    logits, caches = build_prefill_step(r["pcfg"])(
        r["pp"], {"tokens": torch.from_numpy(r["toks"])})
    assert logits.dtype == getattr(torch, dtype) and caches == ()
    close(logits, r["logits"], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_reference(ref_runs, dtype):
    """DECODE_STEPS teacher-forced steps through ``build_serve_step``:
    logits per step, and in f32 the final RWKV state and shifts."""
    r = ref_runs(dtype)
    step = build_serve_step(r["pcfg"])
    state = Model(r["pcfg"]).init_decode_state(B, MAX_SEQ, device="cpu")
    got = []
    for i in range(DECODE_STEPS):
        lg, state = step(r["pp"], state, torch.from_numpy(r["toks"][:, i]))
        got.append(to_np(lg))
    close(np.stack(got, axis=1), r["steps"], dtype)
    assert (state["pos"].numpy() == DECODE_STEPS).all()
    if dtype == "float32":
        for key in ("rwkv", "shift_t", "shift_c"):
            np.testing.assert_allclose(state[key].numpy(),
                                       to_np(r["state"][key]), rtol=1e-4,
                                       atol=1e-4)


def test_init_decode_state_matches_reference():
    rcfg, pcfg = cfgs(ARCH, "bfloat16")
    ours = Model(pcfg).init_decode_state(3, 24, device="cpu")
    ref = RefModel(rcfg).init_decode_state(3, 24)
    assert sorted(ours) == sorted(ref) == ["pos", "rwkv", "shift_c",
                                           "shift_t"]
    for key, v in ref.items():
        assert tuple(ours[key].shape) == v.shape, key
        assert str(ours[key].dtype).split(".")[-1] == v.dtype.name, key
        assert not ours[key].any()


def test_port_decode_matches_prefill_f32(f32_model):
    """The port's prefill (``recurrent_scan``) and its decode steps
    (``recurrent_step``) at the reference's own bound."""
    _, pcfg, _, _, pp = f32_model
    model = Model(pcfg)
    toks = torch.from_numpy(tokens(pcfg.vocab_size, (B, DECODE_STEPS), 3))
    par, _, _ = model.forward(pp, {"tokens": toks})
    state = model.init_decode_state(B, MAX_SEQ, device="cpu")
    seq = []
    for i in range(DECODE_STEPS):
        lg, state = model.decode_step(pp, state, toks[:, i])
        seq.append(lg)
    torch.testing.assert_close(torch.stack(seq, dim=1), par,
                               **DECODE_PREFILL_TOL)


def test_engine_dense_adapter_greedy_tokens_match_reference(f32_model):
    rcfg, pcfg, params, _, pp = f32_model
    engine_tokens_match(rcfg, pcfg, params, pp)


def test_reset_slot_zeroes_the_slot_rwkv_rows(f32_model):
    _, pcfg, _, _, pp = f32_model
    adapter = DenseAdapter(Model(pcfg), pp)
    state = adapter.init_state(3, 8)
    for key in ("rwkv", "shift_t", "shift_c"):
        state[key].fill_(1.0)
    state["pos"].fill_(5)
    adapter.reset_slot(state, 1)
    for key in ("rwkv", "shift_t", "shift_c"):
        assert not state[key][:, 1].any(), key
        assert state[key][:, 0].all() and state[key][:, 2].all(), key
    assert state["pos"].tolist() == [5, 0, 5]


def test_serve_cli_rwkv_completes(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                "--requests", "3", "--batch-size", "2", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "serving path: dense (ssm, 2 layers" in out
    assert "completed=3/3" in out
