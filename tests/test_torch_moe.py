"""The port's MoE sublayer (``repro_torch.models.moe``) and the MoE
models against the reference.

Reduced moonshot-v1-16b-a3b (8 experts top-2 on every layer), reduced
arctic-480b (the same with Arctic's dense residual MLP) and reduced
jamba-1.5-large-398b with its MoE sublayers, cut to one period as in
``tests/test_torch_model.py`` (``n_layers=8``: 7 Mamba sublayers and 1
attention sublayer, the MoE FFN on every second).  The reference's ``init_moe`` / ``Model.init``
weights go to the port through ``params_from_jax``; activations and
token ids are made with numpy from a seed.

Tolerances:
* float32: ``F32_TOL`` rtol = atol = 1e-4 on ``y``, logits and caches
  (the ``F32_TOL`` of ``tests/test_torch_model.py``); the aux loss within
  ``AUX_ATOL`` = 1e-6 (an f32 mean of probabilities, ~1).
* the discrete routing, bit for bit: the top-k experts of every token and
  the ``keep`` masks (slot < capacity) equal the reference's, also at a
  capacity small enough that tokens drop.
* bfloat16, one MoE sublayer on the same inputs: within ``BF16_ULPS`` = 2
  bf16 ulps of the largest output element, the sublayer rule of
  ``tests/test_torch_model.py``.
* bfloat16 forward: within ``MODEL_BF16_ULPS`` = 4 bf16 ulps of the
  largest logit for the 2-layer configs (as ``tests/test_torch_biased.py``
  holds the dense ones), and ``JAMBA_BF16_ATOL`` = 0.5 of
  ``tests/test_torch_model.py`` for jamba's 8 sublayers.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.engine import DenseAdapter as RefDenseAdapter  # noqa: E402
from repro.engine import Engine as RefEngine  # noqa: E402
from repro.engine import EngineConfig as RefEngineConfig  # noqa: E402
from repro.engine import EngineRequest as RefRequest  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    DenseAdapter,
    Engine,
    EngineConfig,
    EngineRequest,
)
from repro_torch.launch.steps import build_prefill_step  # noqa: E402
from repro_torch.models import moe as pmoe  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import init_params, params_from_jax  # noqa: E402
from repro_torch.models.transformer import period_template  # noqa: E402

F32_TOL = dict(rtol=1e-4, atol=1e-4)
AUX_ATOL = 1e-6
BF16_ULPS = 2
MODEL_BF16_ULPS = 4
JAMBA_BF16_ATOL = 0.5
B, S, DECODE_STEPS, MAX_SEQ = 2, 16, 8, 32
#: a capacity factor at which some experts overflow (capacity 2 of 16
#: tokens x top-2 over 8 experts)
DROP_CF = 0.5

CASES = {
    "moonshot": ("moonshot-v1-16b-a3b", port_configs.MOONSHOT_V1_16B_A3B, {}),
    "arctic": ("arctic-480b", port_configs.ARCTIC_480B, {}),
    "jamba": ("jamba-1.5-large-398b", port_configs.JAMBA_1_5_LARGE,
              dict(n_layers=8)),
}


def _cfgs(name, dtype="float32", **kw):
    arch, pcfg, base = CASES[name]
    rcfg = dataclasses.replace(get_config(arch).reduced(**base),
                               dtype=dtype)
    pcfg = dataclasses.replace(pcfg.reduced(**base), dtype=dtype)
    if kw:
        rcfg = dataclasses.replace(
            rcfg, moe=dataclasses.replace(rcfg.moe, **kw))
        pcfg = dataclasses.replace(
            pcfg, moe=dataclasses.replace(pcfg.moe, **kw))
    return rcfg, pcfg


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _sublayer(name, dtype="float32", seed=3, **kw):
    """Configs, the reference's MoE params, the port's copy and x."""
    rcfg, pcfg = _cfgs(name, dtype, **kw)
    p = rmoe.init_moe(jax.random.PRNGKey(seed), rcfg)
    return rcfg, pcfg, p, params_from_jax(jax.tree.map(np.asarray, p),
                                          device="cpu"), \
        _x((B, S, rcfg.d_model), seed)


def _ref_keep(rcfg, p, x):
    """The reference's top-k choice and keep mask, by its own steps
    (``src/repro/models/moe.py:75-89``)."""
    moe = rcfg.moe
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x.astype(jnp.float32),
                                      p["router"]), axis=-1)
    _, choice = jax.lax.top_k(probs, moe.top_k)
    flat = jax.nn.one_hot(choice, moe.n_experts, dtype=jnp.int32).reshape(
        x.shape[0], -1, moe.n_experts)
    slot = jnp.sum((jnp.cumsum(flat, axis=1) - 1) * flat, axis=-1)
    return np.asarray(choice), np.asarray(slot < rmoe.moe_capacity(
        x.shape[1], rcfg))


# ----------------------------------------------------------------------
# the sublayer
# ----------------------------------------------------------------------
@pytest.mark.parametrize("cf", [None, DROP_CF], ids=["capacity", "drops"])
@pytest.mark.parametrize("name", list(CASES))
def test_apply_moe_matches_reference(name, cf):
    kw = {} if cf is None else {"capacity_factor": cf}
    rcfg, pcfg, p, pp, x = _sublayer(name, **kw)
    ry, raux = rmoe.apply_moe(rcfg, p, jnp.asarray(x))
    py, paux = pmoe.apply_moe(pcfg, pp, torch.from_numpy(x))
    assert py.dtype == torch.float32 and paux.dtype == torch.float32
    np.testing.assert_allclose(py.numpy(), _np(ry), **F32_TOL)
    assert abs(float(paux) - float(raux)) <= AUX_ATOL
    assert pmoe.moe_capacity(S, pcfg) == rmoe.moe_capacity(S, rcfg)
    r_choice, r_keep = _ref_keep(rcfg, p, jnp.asarray(x))
    _, _, choice = pmoe.route(pcfg, torch.from_numpy(x), pp["router"])
    _, _, keep, _ = pmoe.dispatch(pcfg, choice, S)
    assert np.array_equal(choice.numpy(), r_choice)
    assert np.array_equal(keep.numpy(), r_keep.reshape(B, -1))
    if cf is not None:
        assert not keep.all()                  # the overflow path ran


@pytest.mark.parametrize("name", list(CASES))
def test_apply_moe_bf16_matches_reference(name):
    rcfg, pcfg, p, pp, x = _sublayer(name, "bfloat16")
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ry, _ = rmoe.apply_moe(rcfg, p, xb)
    py, _ = pmoe.apply_moe(pcfg, pp, torch.from_numpy(x).to(torch.bfloat16))
    assert py.dtype == torch.bfloat16
    want = _np(ry)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(py.float().numpy() - want).max() <= BF16_ULPS * ulp


@pytest.mark.parametrize("name", list(CASES))
def test_apply_moe_reference_matches_reference_oracle(name):
    rcfg, pcfg, p, pp, x = _sublayer(name)
    want = rmoe.apply_moe_reference(rcfg, p, jnp.asarray(x))
    got = pmoe.apply_moe_reference(pcfg, pp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **F32_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_apply_moe_equals_its_oracle_at_ample_capacity(name):
    """With capacity for every token (capacity factor E / k), dispatch
    drops nothing and equals the dense oracle."""
    _, pcfg = _cfgs(name)
    ample = pcfg.moe.n_experts / pcfg.moe.top_k
    _, pcfg, _, pp, x = _sublayer(name, capacity_factor=ample)
    assert pmoe.moe_capacity(S, pcfg) == S
    y, _ = pmoe.apply_moe(pcfg, pp, torch.from_numpy(x))
    torch.testing.assert_close(
        y, pmoe.apply_moe_reference(pcfg, pp, torch.from_numpy(x)),
        **F32_TOL)


def test_routing_ties_go_to_the_lower_expert():
    """Equal router probabilities: the top-k are the lowest expert ids,
    as ``lax.top_k`` orders them."""
    _, pcfg = _cfgs("moonshot")
    x = torch.zeros((1, 3, pcfg.d_model))
    router = torch.zeros((pcfg.d_model, pcfg.moe.n_experts))
    _, gates, choice = pmoe.route(pcfg, x, router)
    _, rchoice = jax.lax.top_k(jnp.full((1, 3, pcfg.moe.n_experts), 0.125),
                               pcfg.moe.top_k)
    assert choice.tolist() == np.asarray(rchoice).tolist() \
        == [[[0, 1]] * 3]
    assert torch.equal(gates, torch.full_like(gates, 0.5))


def test_init_moe_draws_from_the_generator():
    _, pcfg = _cfgs("arctic", "bfloat16")
    a = pmoe.init_moe(torch.Generator().manual_seed(5), pcfg, lead=(2,))
    b = pmoe.init_moe(torch.Generator().manual_seed(5), pcfg, lead=(2,))
    c = pmoe.init_moe(torch.Generator().manual_seed(6), pcfg, lead=(2,))
    e, d, f = pcfg.moe.n_experts, pcfg.d_model, pcfg.moe.d_expert
    assert a["router"].shape == (2, d, e) and a["router"].dtype == \
        torch.float32
    assert a["w_gate"].shape == a["w_up"].shape == (2, e, d, f)
    assert a["w_down"].shape == (2, e, f, d)
    assert a["w_down"].dtype == torch.bfloat16
    assert a["dense"]["w_gate"].shape == (2, d, pcfg.moe.dense_residual_ff)
    assert torch.equal(a["w_up"], b["w_up"])
    assert not torch.equal(a["w_up"], c["w_up"])


# ----------------------------------------------------------------------
# the models
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def runs():
    """Per (case, dtype): the reference's weights, prefill logits, aux and
    caches, and its logits over DECODE_STEPS teacher-forced steps."""
    cache = {}

    def get(name, dtype):
        if (name, dtype) not in cache:
            rcfg, pcfg = _cfgs(name, dtype)
            model = RefModel(rcfg, remat="none")
            params = model.init(jax.random.PRNGKey(0))
            toks = np.random.default_rng(1).integers(
                0, rcfg.vocab_size, (B, S)).astype(np.int32)
            logits, aux, caches = jax.jit(
                lambda p, b: model.forward(p, b, collect_cache=True))(
                    params, {"tokens": jnp.asarray(toks)})
            state = model.init_decode_state(B, MAX_SEQ)
            step = jax.jit(model.decode_step)
            steps = []
            for i in range(DECODE_STEPS):
                lg, state = step(params, state, jnp.asarray(toks[:, i]),
                                 None)
                steps.append(_np(lg))
            cache[name, dtype] = dict(
                rcfg=rcfg, pcfg=pcfg, params=params,
                np_params=jax.tree.map(np.asarray, params), toks=toks,
                logits=_np(logits), aux=float(aux),
                caches=[(_np(k), _np(v)) for k, v in caches],
                steps=np.stack(steps, axis=1))
        return cache[name, dtype]

    return get


def _close(got, want, name, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    elif name == "jamba":
        np.testing.assert_allclose(got, want, rtol=0, atol=JAMBA_BF16_ATOL)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert np.abs(got - want).max() <= MODEL_BF16_ULPS * ulp


@pytest.mark.parametrize("name", list(CASES))
def test_moe_tree_structure_and_param_count(runs, name):
    r = runs(name, "bfloat16")
    pcfg = r["pcfg"]
    assert any(s.ffn == "moe" for s in period_template(pcfg))
    ours = init_params(pcfg, torch.Generator().manual_seed(0), device="cpu")
    n = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(r["params"]):
        node = ours
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).split(".")[-1] == leaf.dtype.name, path
        n += leaf.size
    assert pcfg.param_count() == n
    assert pcfg.active_param_count() == r["rcfg"].active_param_count() \
        + n - r["rcfg"].param_count()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_moe_forward_logits_aux_and_caches_match_reference(runs, name,
                                                           dtype):
    r = runs(name, dtype)
    pp = params_from_jax(r["np_params"], device="cpu")
    logits, aux, caches = Model(r["pcfg"]).forward(
        pp, {"tokens": torch.from_numpy(r["toks"])}, collect_cache=True)
    assert logits.dtype == getattr(torch, dtype)
    _close(logits.float().numpy(), r["logits"], name, dtype)
    assert aux.dtype == torch.float32 and float(aux) > 0
    if dtype == "float32":          # a sum over the MoE sublayers
        n_moe = sum(r["pcfg"].layer_is_moe(i)
                    for i in range(r["pcfg"].n_layers))
        assert abs(float(aux) - r["aux"]) <= AUX_ATOL * n_moe
    for (pk, pv), (rk, rv) in zip(caches, r["caches"]):
        _close(pk.float().numpy(), rk, name, dtype)
        _close(pv.float().numpy(), rv, name, dtype)
    pre, _ = build_prefill_step(r["pcfg"])(
        pp, {"tokens": torch.from_numpy(r["toks"])})
    assert torch.equal(pre, logits)


@pytest.mark.parametrize("name", list(CASES))
def test_moe_decode_steps_match_reference(runs, name):
    r = runs(name, "float32")
    pp = params_from_jax(r["np_params"], device="cpu")
    model = Model(r["pcfg"])
    state = model.init_decode_state(B, MAX_SEQ, device="cpu")
    got = []
    for i in range(DECODE_STEPS):
        lg, state = model.decode_step(pp, state,
                                      torch.from_numpy(r["toks"][:, i]))
        got.append(lg.numpy())
    np.testing.assert_allclose(np.stack(got, axis=1), r["steps"], **F32_TOL)


def test_engine_dense_adapter_moonshot_greedy_tokens_match_reference(runs):
    """Engine(DenseAdapter) on reduced moonshot in float32, batch 2, 5
    requests: the greedy tokens equal the reference engine's."""
    r = runs("moonshot", "float32")
    ref = RefEngine(RefDenseAdapter(RefModel(r["rcfg"], remat="none"),
                                    r["params"]),
                    RefEngineConfig(batch_size=2, max_seq=MAX_SEQ,
                                    max_backlog=None))
    ours = Engine(DenseAdapter(Model(r["pcfg"]),
                               params_from_jax(r["np_params"],
                                               device="cpu")),
                  EngineConfig(batch_size=2, max_seq=MAX_SEQ,
                               max_backlog=None))
    outs = []
    for eng, cls in ((ref, RefRequest), (ours, EngineRequest)):
        rng = np.random.default_rng(0)
        reqs = [cls(uid=uid, prompt=rng.integers(
            1, r["rcfg"].vocab_size, int(rng.integers(2, 6))).tolist(),
            max_new_tokens=4) for uid in range(5)]
        for req in reqs:
            eng.submit(req)
        stats = eng.run_until_drained(max_steps=200)
        assert stats.completed == len(reqs)
        outs.append([req.generated for req in reqs])
    assert outs[0] == outs[1]
    assert ours.completion_order == ref.completion_order
