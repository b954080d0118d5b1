"""Shared pieces of the family parity tests (``test_torch_vlm.py``,
``test_torch_rwkv.py``, ``test_torch_encdec.py``).

Each family's reduced config (``cfg.reduced()``: 2 layers, d_model 128)
is built by both packages.  The reference's ``Model.init`` weights are
made, then every leaf whose init is a constant under which a dropped
term could not show (biases, LayerNorm biases, RWKV's ``bonus_u``,
``mix`` and ``decay_w0``) is overwritten with seeded values made with
numpy; both packages get the same numpy tree (the port through
``params_from_jax``).

Tolerances, the ones ``tests/test_torch_biased.py`` states:
* float32: ``F32_TOL`` rtol = atol = 1e-4 on logits and caches.
* bfloat16, the whole reduced model: within ``MODEL_BF16_ULPS`` = 4 bf16
  ulps of the largest logit.
* decode == prefill in float32: the reference's own bound, 1e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config
from repro.engine import DenseAdapter as RefDenseAdapter
from repro.engine import Engine as RefEngine
from repro.engine import EngineConfig as RefEngineConfig
from repro.engine import EngineRequest as RefRequest
from repro.models.model import Model as RefModel
from repro_torch import configs as port_configs
from repro_torch.engine import (
    DenseAdapter,
    Engine,
    EngineConfig,
    EngineRequest,
)
from repro_torch.models.model import Model
from repro_torch.models.params import init_params, params_from_jax

F32_TOL = dict(rtol=1e-4, atol=1e-4)
MODEL_BF16_ULPS = 4
DECODE_PREFILL_TOL = dict(rtol=1e-3, atol=1e-3)
B, S, DECODE_STEPS, MAX_SEQ = 2, 16, 8, 32
BIAS_KEYS = ("bias", "bq", "bk", "bv", "bo", "b_gate", "b_up", "b_down")


def _draw(rng, key: str, shape) -> np.ndarray:
    if key in BIAS_KEYS:
        return rng.standard_normal(shape) * 0.2
    if key == "bonus_u":
        return rng.standard_normal(shape) * 0.5
    if key == "mix":
        return rng.uniform(0.0, 1.0, shape)
    return -2.0 + rng.standard_normal(shape) * 0.5     # decay_w0


SEEDED_KEYS = BIAS_KEYS + ("bonus_u", "mix", "decay_w0")


def seeded(np_tree, seed: int = 7):
    """``np_tree`` with every leaf of ``SEEDED_KEYS`` drawn anew from
    ``seed`` in its dtype, in sorted key order."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: _draw(rng, k, np.shape(v)).astype(np.asarray(v).dtype)
                    if k in SEEDED_KEYS and not isinstance(v, (dict, list))
                    else walk(v) for k, v in sorted(node.items())}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return node

    return walk(np_tree)


def cfgs(arch: str, dtype: str = "float32", **kw):
    """(reference config, port config), reduced, in ``dtype``."""
    rcfg = dataclasses.replace(get_config(arch).reduced(**kw), dtype=dtype)
    pcfg = dataclasses.replace(port_configs.get_config(arch).reduced(**kw),
                               dtype=dtype)
    return rcfg, pcfg


def models(arch: str, dtype: str = "float32", **kw):
    """(rcfg, pcfg, reference params, numpy params, port params): the
    reference's init with its constant leaves seeded."""
    rcfg, pcfg = cfgs(arch, dtype, **kw)
    params = RefModel(rcfg, remat="none").init(jax.random.PRNGKey(0))
    np_params = seeded(jax.tree.map(np.asarray, params))
    return (rcfg, pcfg, jax.tree.map(jnp.asarray, np_params), np_params,
            params_from_jax(np_params, device="cpu"))


def to_np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x) \
            .cpu().numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def leaves(tree, prefix=""):
    """(path, leaf) in ``jax.tree_util``'s order: sorted keys, list
    order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, v in enumerate(tree)
                for leaf in leaves(v, f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tree)]


def close(got, want, dtype: str) -> None:
    """The stated tolerance of ``dtype``: f32 ``F32_TOL``; bf16 within
    ``MODEL_BF16_ULPS`` bf16 ulps of the largest element."""
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert np.abs(got - want).max() <= MODEL_BF16_ULPS * ulp


def tokens(vocab: int, shape=(B, S), seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


def assert_init_tree_matches(rcfg, pcfg) -> None:
    """``init_params`` builds the reference's tree (leaf paths, shapes
    and dtypes), and ``param_count`` counts it."""
    want = jax.tree_util.tree_leaves_with_path(jax.eval_shape(
        RefModel(rcfg, remat="none").init, jax.random.PRNGKey(0)))
    got = leaves(init_params(pcfg, torch.Generator().manual_seed(0),
                             device="cpu"))
    assert [p for p, _ in got] == ["/".join(
        str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        for path, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).split(".")[-1] == w.dtype.name, path
    assert pcfg.param_count() == sum(int(np.prod(w.shape)) for _, w in want)


def requests(cls, vocab: int, n: int = 5, max_new: int = 4, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [cls(uid=uid, prompt=rng.integers(1, vocab,
                                             int(rng.integers(2, 6))).tolist(),
                max_new_tokens=max_new) for uid in range(n)]


def engine_tokens_match(rcfg, pcfg, params, pp) -> None:
    """``Engine(DenseAdapter)``, batch 2, 5 requests (slots reused, idle
    rows stepping with token 0): the greedy tokens, admission and
    completion orders equal the reference engine's."""
    ref = RefEngine(RefDenseAdapter(RefModel(rcfg, remat="none"), params),
                    RefEngineConfig(batch_size=2, max_seq=MAX_SEQ,
                                    max_backlog=None))
    ours = Engine(DenseAdapter(Model(pcfg), pp),
                  EngineConfig(batch_size=2, max_seq=MAX_SEQ,
                               max_backlog=None))
    outs = []
    for eng, cls in ((ref, RefRequest), (ours, EngineRequest)):
        reqs = requests(cls, rcfg.vocab_size)
        for req in reqs:
            eng.submit(req)
        stats = eng.run_until_drained(max_steps=200)
        assert stats.completed == len(reqs)
        outs.append([req.generated for req in reqs])
    assert outs[0] == outs[1]
    assert ours.admission_order == ref.admission_order
    assert ours.completion_order == ref.completion_order
