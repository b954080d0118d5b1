"""LayerNorm and biased dense configs on the port's packed path, and the
unquantized path of the dense configs, against the reference.

Reduced stablelm-3b (LayerNorm, ``use_bias``), reduced
command-r-plus-104b (LayerNorm, no bias) and reduced smollm-135m with
``norm="layernorm"``; the unquantized path also takes reduced
mistral-large-123b.  The reference's ``Model.init`` weights are made, and
then every bias leaf (``bq`` ... ``b_down``) and every LayerNorm bias is
overwritten with seeded nonzero values made with numpy (the inits are
zeros, under which a dropped bias could not show).  Both packages get the
same numpy tree.  The reference runs its Pallas kernels in interpret mode;
the port runs on the CPU, where each kernel takes its plain version.

Tolerances:
* packed decode logits: ``LOGIT_ATOL`` of ``tests/test_torch_serving.py``
  (a few bf16 ulps of |logit| <= ~2); greedy tokens equal.
* stream bytes, bias and norm leaves, kernel views and checkpoint files:
  bit for bit.
* unquantized path, float32: ``F32_TOL`` rtol = atol = 1e-4 of
  ``tests/test_torch_model.py``.  bfloat16: that file's ulp rule (within
  so many bf16 ulps of the largest element), with ``MODEL_BF16_ULPS`` = 4
  for the whole model where one sublayer is held at 2: two layers, the
  final norm and the unembedding each round to bf16, and the two
  packages sum their products in other orders.  Measured on the CPU over
  three token seeds: 0.9-2.2 ulps of |logit| <= 4.3.
"""
import dataclasses
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from test_torch_serving import LOGIT_ATOL  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro.checkpoint.checkpoint import CheckpointManager as RefMgr  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core.iris import LayoutCache as RefCache  # noqa: E402
from repro.kvcache import PackedKVCache as RefKV  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.models.quantized import packed_decode_step as ref_step  # noqa: E402
from repro.quant import QuantSpec as RefSpec  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core.iris import LayoutCache as PortCache  # noqa: E402
from repro_torch.kvcache import PackedKVCache as PortKV  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    build_prefill_step,
    build_serve_step,
)
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import init_params, params_from_jax  # noqa: E402
from repro_torch.models.quantized import (  # noqa: E402
    bytes_per_token_report,
    init_decode_state,
    packed_decode_step,
)
from repro_torch.quant import QuantSpec  # noqa: E402
from repro_torch.tree import pack_tree, unpack_streams  # noqa: E402

F32_TOL = dict(rtol=1e-4, atol=1e-4)
MODEL_BF16_ULPS = 4
MAX_SEQ = 32
B, S, DECODE_STEPS = 2, 16, 8
BIAS_KEYS = ("bias", "bq", "bk", "bv", "bo", "b_gate", "b_up", "b_down")
#: std of the seeded biases: large enough to move every logit
BIAS_STD = 0.2

CASES = {
    "stablelm": ("stablelm-3b", port_configs.STABLELM_3B, {}),
    "command_r": ("command-r-plus-104b", port_configs.COMMAND_R_PLUS_104B,
                  {}),
    "smollm_ln": ("smollm-135m", port_configs.SMOLLM_135M,
                  dict(norm="layernorm")),
    "mistral": ("mistral-large-123b", port_configs.MISTRAL_LARGE_123B, {}),
}
PACKED = ("stablelm", "command_r", "smollm_ln")


def _cfgs(name, dtype="bfloat16"):
    arch, pcfg, kw = CASES[name]
    rcfg = dataclasses.replace(get_config(arch).reduced(**kw), dtype=dtype)
    return rcfg, dataclasses.replace(pcfg.reduced(**kw), dtype=dtype)


def seeded_biases(np_tree, seed: int = 7):
    """``np_tree`` with every bias leaf (attention, MLP and LayerNorm)
    replaced by seeded nonzero values of its dtype, in key order."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: (rng.standard_normal(np.shape(v)) * BIAS_STD)
                    .astype(np.asarray(v).dtype)
                    if k in BIAS_KEYS and not isinstance(v, (dict, list))
                    else walk(v) for k, v in sorted(node.items())}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return node

    return walk(np_tree)


@pytest.fixture(scope="module")
def models():
    """Per (case, dtype): the configs, the reference's params (biases
    seeded) and the same tree as numpy arrays."""
    cache = {}

    def get(name, dtype="bfloat16"):
        if (name, dtype) not in cache:
            rcfg, pcfg = _cfgs(name, dtype)
            params = RefModel(rcfg, remat="none").init(jax.random.PRNGKey(0))
            np_params = seeded_biases(jax.tree.map(np.asarray, params))
            cache[name, dtype] = (rcfg, pcfg, jax.tree.map(jnp.asarray,
                                                           np_params),
                                  np_params)
        return cache[name, dtype]

    return get


@pytest.fixture(scope="module")
def trees(models):
    cache = {}

    def get(name, bits):
        if (name, bits) not in cache:
            rcfg, pcfg, params, np_params = models(name)
            rt = ref_api.pack_tree(rcfg, params,
                                   RefSpec(bits=bits, group_size=32),
                                   cache=RefCache())
            pt = pack_tree(pcfg, params_from_jax(np_params, device="cpu"),
                           QuantSpec(bits=bits, group_size=32),
                           cache=PortCache(), device="cpu")
            cache[name, bits] = (rt, pt)
        return cache[name, bits]

    return get


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x) \
            .cpu().numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _leaves(tree, prefix=""):
    """(path, leaf) in ``jax.tree_util``'s order: sorted keys, list
    order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, v in enumerate(tree)
                for leaf in _leaves(v, f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tree)]


# ----------------------------------------------------------------------
# configs
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", list(CASES))
def test_config_fields_equal_reference(name):
    arch, pcfg, _ = CASES[name]
    ref = get_config(arch)
    for f in dataclasses.fields(pcfg):
        assert getattr(pcfg, f.name) == getattr(ref, f.name), (name, f.name)
    assert port_configs.get_config(arch) is pcfg


def test_shapes_and_shape_cells_equal_reference():
    from repro.configs import SHAPES as RSHAPES
    from repro.configs import shape_cells as ref_cells

    assert {k: dataclasses.asdict(v) for k, v in
            port_configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in RSHAPES.items()}
    for arch in port_configs.ARCH_IDS:
        assert [c.name for c in port_configs.shape_cells(arch)] == \
            [c.name for c in ref_cells(arch)], arch
    with pytest.raises(KeyError):
        port_configs.get_config("no-such-arch")


@pytest.mark.parametrize("name", list(CASES))
def test_init_params_tree_and_param_count(models, name):
    """``init_params`` builds the reference's tree (keys, shapes, dtypes)
    and ``param_count`` counts it, biases and LayerNorm biases
    included."""
    _, pcfg, params, _ = models(name)
    ours = init_params(pcfg, torch.Generator().manual_seed(0), device="cpu")
    want = jax.tree_util.tree_leaves_with_path(params)
    got = _leaves(ours)
    assert [p for p, _ in got] == ["/".join(
        str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        for path, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == w.dtype.name
    assert pcfg.param_count() == sum(w.size for _, w in want)


# ----------------------------------------------------------------------
# the packed path
# ----------------------------------------------------------------------
@pytest.mark.parametrize("bits", [3, 4])
@pytest.mark.parametrize("name", PACKED)
def test_biased_pack_tree_matches_reference(trees, name, bits):
    """Streams, manifest, scales and kernel views bit for bit; every leaf
    of ``other`` (embedding, norms with their biases, the dense biases)
    equal to the reference's, under the same keys."""
    rt, pt = trees(name, bits)
    assert np.array_equal(pt.streams.numpy(), np.asarray(rt.streams))
    assert pt.manifest.to_json_dict() == rt.manifest.to_json_dict()
    for key, s in rt.scales.items():
        assert np.array_equal(_bits(pt.scales[key]), _bits(s)), key
    assert sorted(pt.packed) == sorted(rt.packed)
    for key, v in rt.packed.items():
        assert np.array_equal(pt.packed[key].numpy().view(np.uint32),
                              np.asarray(v)), key
    got, want = _leaves(pt.other), _leaves(rt.other)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert str(g.dtype).split(".")[-1] == np.asarray(w).dtype.name, path
        assert np.array_equal(_bits(g), _bits(w)), path
    paths = {p for p, _ in got}
    assert {"norm1/bias", "norm2/bias", "final_norm/bias"} <= paths
    biased = {f"{s}/{b}" for s, b in (
        ("attn", "bq"), ("attn", "bk"), ("attn", "bv"), ("attn", "bo"),
        ("mlp", "b_gate"), ("mlp", "b_up"), ("mlp", "b_down"))}
    assert biased & paths == (biased if name == "stablelm" else set())
    assert all(np.any(_bits(g)) for p, g in got if p.endswith("bias")
               or p.split("/")[-1] in BIAS_KEYS)


def _ref_state(cfg, bits):
    state = RefModel(cfg, remat="none").init_decode_state(B, MAX_SEQ)
    state["packed_kv"] = RefKV.create(cfg, bits=bits, page_tokens=8,
                                      n_slots=B, max_seq=MAX_SEQ,
                                      cache=RefCache())
    return state


def _port_state(cfg, bits):
    state = init_decode_state(cfg, B, MAX_SEQ, kv="packed", device="cpu")
    state["packed_kv"] = PortKV.create(cfg, bits=bits, page_tokens=8,
                                       n_slots=B, max_seq=MAX_SEQ,
                                       cache=PortCache(), device="cpu")
    return state


def _decode_both(models, trees, name, bits, steps=DECODE_STEPS):
    """Two forced prompt tokens then ``steps`` greedy steps in both
    packages, packed KV; yields each step's (port, reference) logits."""
    rcfg, pcfg, _, _ = models(name)
    rt, pt = trees(name, bits)
    rs, ps = _ref_state(rcfg, bits), _port_state(pcfg, bits)
    prompt = [[17, 301], [250, 3]]
    tok = np.asarray([p[0] for p in prompt], np.int32)
    for step in range(steps + 2):
        rl, rs = ref_step(rcfg, rt, rs, jnp.asarray(tok), interpret=True,
                          kv="packed")
        pl, ps = packed_decode_step(pcfg, pt, ps, torch.from_numpy(tok),
                                    kv="packed")
        rl = np.asarray(rl).astype(np.float32)
        pl = pl.float().numpy()
        yield step, pl, rl
        tok = np.asarray([p[1] for p in prompt], np.int32) if step == 0 \
            else pl.argmax(-1).astype(np.int32)
    assert np.array_equal(ps["packed_kv"].host_pages(),
                          np.asarray(rs["packed_kv"].pages))


@pytest.mark.parametrize("bits", [3, 4])
@pytest.mark.parametrize("name", PACKED)
def test_biased_packed_decode_matches_reference(models, trees, name, bits):
    """int3 serves stream-direct (``stream_matmul``), int4 through the
    lane-packed views (``packed_matmul``), in both packages."""
    _, pcfg, _, _ = models(name)
    for step, pl, rl in _decode_both(models, trees, name, bits):
        assert pl.shape == rl.shape == (B, pcfg.vocab_size)
        np.testing.assert_allclose(pl, rl, rtol=0, atol=LOGIT_ATOL)
        if step > 0:
            assert np.array_equal(pl.argmax(-1), rl.argmax(-1)), step


def test_c3_layernorm_bias_reaches_packed_decode(models, trees):
    """C3: ``packed_decode_step`` takes each layer's whole norm dict.  A
    LayerNorm config decodes packed, its logits agree with the
    reference's, and zeroing the norm biases moves them (so the biases
    are read)."""
    rcfg, pcfg, _, _ = models("smollm_ln")
    rt, pt = trees("smollm_ln", 4)
    tok = np.asarray([17, 250], np.int32)
    rl, _ = ref_step(rcfg, rt, _ref_state(rcfg, 4), jnp.asarray(tok),
                     interpret=True, kv="packed")
    pl, _ = packed_decode_step(pcfg, pt, _port_state(pcfg, 4),
                               torch.from_numpy(tok), kv="packed")
    np.testing.assert_allclose(pl.float().numpy(),
                               np.asarray(rl).astype(np.float32), rtol=0,
                               atol=LOGIT_ATOL)
    saved = {k: pt.other[k]["bias"] for k in ("norm1", "norm2")}
    try:
        for k in saved:
            pt.other[k]["bias"] = torch.zeros_like(saved[k])
        zl, _ = packed_decode_step(pcfg, pt, _port_state(pcfg, 4),
                                   torch.from_numpy(tok), kv="packed")
    finally:
        for k, v in saved.items():
            pt.other[k]["bias"] = v
    assert float((zl.float() - pl.float()).abs().max()) > 10 * LOGIT_ATOL


@pytest.mark.parametrize("bits", [3, 4])
@pytest.mark.parametrize("name", PACKED)
def test_biased_save_packed_files_equal_reference(tmp_path, trees, name,
                                                  bits):
    rt, pt = trees(name, bits)
    CheckpointManager(tmp_path / "port").save_packed(0, pt, {"tag": bits})
    RefMgr(tmp_path / "ref").save_packed(0, rt, {"tag": bits})
    step = "step_00000000"
    port = {p.name: p.read_bytes()
            for p in sorted((tmp_path / "port" / step).iterdir())}
    ref = {p.name: p.read_bytes()
           for p in sorted((tmp_path / "ref" / step).iterdir())}
    assert sorted(port) == sorted(ref)
    for fname in ref:
        if fname.endswith(".npy"):
            assert port[fname] == ref[fname], fname
    pm, rm = (json.loads(d["manifest.json"]) for d in (port, ref))
    assert pm.pop("treedef") is None
    rm.pop("treedef")
    assert pm == rm
    assert any(p.startswith("other/attn/") for p in pm["paths"]) == \
        (name == "stablelm")


@pytest.mark.parametrize("bits", [3, 4])
@pytest.mark.parametrize("name", PACKED)
def test_biased_tree_verifies_and_round_trips(tmp_path, models, trees, name,
                                              bits):
    """``PackedTree.verify`` passes; ``unpack_streams`` and a checkpoint's
    ``restore_packed`` rebuild the tree with its bias and norm leaves,
    and decode from either is bit-equal to the original's."""
    _, pcfg, _, _ = models(name)
    _, pt = trees(name, bits)
    assert pt.verify().ok
    back = unpack_streams(pt.manifest, pt.streams, pt.other, device="cpu")
    mgr = CheckpointManager(tmp_path)
    mgr.save_packed(0, pt)
    restored, _ = mgr.restore_packed(0, device="cpu")
    tok = torch.tensor([17, 250])
    want, _ = packed_decode_step(pcfg, pt, _port_state(pcfg, bits), tok,
                                 kv="packed")
    for got_tree in (back, restored):
        for key, v in pt.scales.items():
            assert torch.equal(got_tree.scales[key].view(torch.int16),
                               v.view(torch.int16)), key
        assert sorted(got_tree.packed) == sorted(pt.packed)
        for key, v in pt.packed.items():
            assert torch.equal(got_tree.packed[key], v), key
        got_leaves, want_leaves = _leaves(got_tree.other), _leaves(pt.other)
        assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
        for (path, g), (_, w) in zip(got_leaves, want_leaves):
            assert g.dtype == w.dtype and np.array_equal(_bits(g), _bits(w)), \
                path
        got, _ = packed_decode_step(pcfg, got_tree,
                                    _port_state(pcfg, bits), tok,
                                    kv="packed")
        assert torch.equal(got, want)


@pytest.mark.parametrize("bits", [3, 4])
def test_biased_bytes_per_token_report_matches_reference(models, trees,
                                                         bits):
    from repro.models.quantized import bytes_per_token_report as ref_report

    rcfg, pcfg, _, _ = models("stablelm")
    rt, pt = trees("stablelm", bits)
    assert bytes_per_token_report(pcfg, pt) == ref_report(rcfg, rt)


def test_serve_cli_stablelm_packed_completes(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "stablelm-3b", "--reduced", "--packed",
                "--bits", "3", "--device", "cpu", "--requests", "3",
                "--batch-size", "2", "--max-new", "3", "--max-seq", "32"])
    out = capsys.readouterr().out
    assert "serving path: stream-direct (int3), packed int3 KV" in out
    assert "completed=3/3" in out


# ----------------------------------------------------------------------
# the unquantized path
# ----------------------------------------------------------------------
def _close(got: np.ndarray, want: np.ndarray, dtype: str) -> None:
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert np.abs(got - want).max() <= MODEL_BF16_ULPS * ulp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["stablelm", "command_r", "mistral"])
def test_dense_config_forward_and_decode_match_reference(models, name,
                                                         dtype):
    """``Model.forward`` (logits, aux 0, caches) and ``DECODE_STEPS``
    teacher-forced ``decode_step`` logits against the reference's."""
    rcfg, pcfg, params, np_params = models(name, dtype)
    toks = np.random.default_rng(1).integers(0, rcfg.vocab_size, (B, S)) \
        .astype(np.int32)
    ref = RefModel(rcfg, remat="none")
    rlog, raux, rcache = ref.forward(params, {"tokens": jnp.asarray(toks)},
                                     collect_cache=True)
    pp = params_from_jax(np_params, device="cpu")
    plog, paux, pcache = Model(pcfg).forward(
        pp, {"tokens": torch.from_numpy(toks)}, collect_cache=True)
    assert plog.dtype == getattr(torch, dtype)
    _close(plog.float().numpy(), np.asarray(rlog.astype(jnp.float32)), dtype)
    assert float(paux) == float(raux) == 0.0
    for (pk, pv), (rk, rv) in zip(pcache, rcache):
        _close(pk.float().numpy(), np.asarray(rk.astype(jnp.float32)), dtype)
        _close(pv.float().numpy(), np.asarray(rv.astype(jnp.float32)), dtype)
    pre, _ = build_prefill_step(pcfg)(pp, {"tokens": torch.from_numpy(toks)})
    assert torch.equal(pre, plog)
    rstate = ref.init_decode_state(B, MAX_SEQ)
    pstate = Model(pcfg).init_decode_state(B, MAX_SEQ, device="cpu")
    step = build_serve_step(pcfg)
    for i in range(DECODE_STEPS):
        rl, rstate = ref.decode_step(params, rstate, jnp.asarray(toks[:, i]))
        pl, pstate = step(pp, pstate, torch.from_numpy(toks[:, i]))
        _close(pl.float().numpy(), np.asarray(rl.astype(jnp.float32)), dtype)
