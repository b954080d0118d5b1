"""The VLM family (qwen2-vl-2b) on the port against the reference: M-RoPE,
the unquantized model, and the packed path it shares with the dense
family; also the ten configs and ``quantizable`` on each.

Reduced qwen2-vl-2b (2 layers, d_model 128, 4 / 2 heads of 32, tied,
biased, M-RoPE sections rescaled to (4, 6, 6)).  The reference's weights,
every bias drawn from a seed, go to the port through ``params_from_jax``
(``tests/_torch_families.py``).  On the packed path the reference runs
its Pallas kernels in interpret mode; the port runs on the CPU, where
each kernel takes its plain version.

Tolerances: ``apply_rope`` in float32 within ``ROPE_TOL`` = 1e-6 (rtol
= atol: the same f32 products); the model's logits as
``_torch_families`` states (f32 1e-4, bf16 4 ulps of the largest
logit); decode == prefill in f32 at the reference's 1e-3; packed decode
logits within ``LOGIT_ATOL`` of ``tests/test_torch_serving.py`` with
greedy tokens equal; streams, scales, views and ``other`` leaves bit for
bit.
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
    bits,
    cfgs,
    close,
    engine_tokens_match,
    leaves,
    models,
    to_np,
    tokens,
)
from test_torch_serving import LOGIT_ATOL  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro.configs import ARCH_IDS as REF_ARCH_IDS  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core.iris import LayoutCache as RefCache  # noqa: E402
from repro.kvcache import PackedKVCache as RefKV  # noqa: E402
from repro.models.layers import apply_rope as ref_rope  # noqa: E402
from repro.models.layers import rope_freqs as ref_rope_freqs  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.models.quantized import packed_decode_step as ref_step  # noqa: E402
from repro.models.quantized import quantizable as ref_quantizable  # noqa: E402
from repro.quant import QuantSpec as RefSpec  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.core.iris import LayoutCache as PortCache  # noqa: E402
from repro_torch.kvcache import PackedKVCache as PortKV  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    build_prefill_step,
    build_serve_step,
)
from repro_torch.models.layers import apply_rope, rope_freqs  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.quantized import (  # noqa: E402
    init_decode_state,
    packed_decode_step,
    quantizable,
)
from repro_torch.quant import QuantSpec  # noqa: E402
from repro_torch.tree import pack_tree  # noqa: E402

ARCH = "qwen2-vl-2b"
ROPE_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def f32_model():
    return models(ARCH, "float32")


# ----------------------------------------------------------------------
# configs
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_every_config_equals_reference(arch):
    """The port registers the reference's ten configs, each field (nested
    ones included) equal, and so are their reduced configs."""
    assert port_configs.ARCH_IDS == REF_ARCH_IDS
    ours, ref = port_configs.get_config(arch), get_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert dataclasses.asdict(ours.reduced()) == \
        dataclasses.asdict(ref.reduced())


def test_quantizable_equals_reference_on_all_ten_configs():
    for arch in REF_ARCH_IDS:
        for ours, ref in ((port_configs.get_config(arch), get_config(arch)),
                          (port_configs.get_config(arch).reduced(),
                           get_config(arch).reduced())):
            assert quantizable(ours) == ref_quantizable(ref), arch
    assert quantizable(port_configs.QWEN2_VL_2B)


def test_reduced_mrope_sections_equal_reference():
    """``reduced()`` rescales (16, 24, 24) of head_dim 128 to the reduced
    head_dim's 16 channels, as the reference does."""
    for kw in ({}, dict(n_layers=4), dict(d_model=256)):
        ours = port_configs.QWEN2_VL_2B.reduced(**kw).mrope_sections
        assert ours == get_config(ARCH).reduced(**kw).mrope_sections
    assert port_configs.QWEN2_VL_2B.reduced().mrope_sections == (4, 6, 6)
    assert sum(port_configs.QWEN2_VL_2B.mrope_sections) == 128 // 2


def test_init_params_tree_and_param_count():
    assert_init_tree_matches(*cfgs(ARCH, "bfloat16"))
    assert port_configs.QWEN2_VL_2B.param_count() == 1_544_302_080


# ----------------------------------------------------------------------
# M-RoPE
# ----------------------------------------------------------------------
@pytest.mark.parametrize("full", [False, True])
def test_apply_rope_mrope_distinct_positions_match_reference(full):
    """(B, S, 3) positions whose three streams differ: only this input
    tells M-RoPE from RoPE (text positions make them equal)."""
    rcfg = get_config(ARCH) if full else get_config(ARCH).reduced()
    pcfg = port_configs.QWEN2_VL_2B if full \
        else port_configs.QWEN2_VL_2B.reduced()
    rng = np.random.default_rng(23)
    x = rng.standard_normal((B, 9, 3, pcfg.head_dim)).astype(np.float32)
    pos = rng.integers(0, 4096, (B, 9, 3)).astype(np.int32)
    assert (pos[..., 0] != pos[..., 1]).any() and \
        (pos[..., 1] != pos[..., 2]).any()
    want = ref_rope(jnp.asarray(x), jnp.asarray(pos), ref_rope_freqs(rcfg),
                    rcfg.mrope_sections)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                     rope_freqs(pcfg), pcfg.mrope_sections)
    np.testing.assert_allclose(got.numpy(), to_np(want), **ROPE_TOL)
    # each section reads its own stream: plain RoPE of stream 0 differs
    plain = apply_rope(torch.from_numpy(x), torch.from_numpy(pos[..., 0]),
                       rope_freqs(pcfg))
    assert float((plain - got).abs().max()) > 0.1
    # text positions, (B, S) or three equal streams: M-RoPE is RoPE
    text = np.broadcast_to(np.arange(9)[None], (B, 9)).copy()
    for p in (torch.from_numpy(text),
              torch.from_numpy(np.repeat(text[..., None], 3, axis=-1))):
        assert torch.equal(
            apply_rope(torch.from_numpy(x), p, rope_freqs(pcfg),
                       pcfg.mrope_sections),
            apply_rope(torch.from_numpy(x), torch.from_numpy(text),
                       rope_freqs(pcfg)))


def test_apply_rope_refuses_sections_of_another_width():
    pcfg = port_configs.QWEN2_VL_2B.reduced()
    with pytest.raises(ValueError, match="sum"):
        apply_rope(torch.zeros((1, 2, 1, 32)), torch.zeros((1, 2, 3)),
                   rope_freqs(pcfg), (4, 6, 7))


# ----------------------------------------------------------------------
# the unquantized model
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref_runs():
    cache = {}

    def get(dtype):
        if dtype not in cache:
            rcfg, pcfg, params, _, pp = models(ARCH, dtype)
            model = RefModel(rcfg, remat="none")
            toks = tokens(rcfg.vocab_size)
            logits, _, caches = jax.jit(
                lambda p, b: model.forward(p, b, collect_cache=True))(
                    params, {"tokens": jnp.asarray(toks)})
            state = model.init_decode_state(B, MAX_SEQ)
            step = jax.jit(model.decode_step)
            steps = []
            for i in range(DECODE_STEPS):
                lg, state = step(params, state, jnp.asarray(toks[:, i]), None)
                steps.append(to_np(lg))
            cache[dtype] = dict(
                pcfg=pcfg, pp=pp, toks=toks, logits=to_np(logits),
                caches=[(to_np(k), to_np(v)) for k, v in caches],
                steps=np.stack(steps, axis=1))
        return cache[dtype]

    return get


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_and_caches_match_reference(ref_runs, dtype):
    r = ref_runs(dtype)
    logits, caches = build_prefill_step(r["pcfg"])(
        r["pp"], {"tokens": torch.from_numpy(r["toks"])})
    assert logits.dtype == getattr(torch, dtype)
    close(logits, r["logits"], dtype)
    for (pk, pv), (rk, rv) in zip(caches, r["caches"]):
        close(pk, rk, dtype)
        close(pv, rv, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_reference(ref_runs, dtype):
    r = ref_runs(dtype)
    step = build_serve_step(r["pcfg"])
    state = Model(r["pcfg"]).init_decode_state(B, MAX_SEQ, device="cpu")
    got = []
    for i in range(DECODE_STEPS):
        lg, state = step(r["pp"], state, torch.from_numpy(r["toks"][:, i]))
        got.append(to_np(lg))
    close(np.stack(got, axis=1), r["steps"], dtype)


def test_port_decode_matches_prefill_f32(f32_model):
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


# ----------------------------------------------------------------------
# the packed path
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def trees():
    rcfg, pcfg, params, np_params, _ = models(ARCH, "bfloat16")
    cache = {}

    def get(nbits):
        if nbits not in cache:
            from repro_torch.models.params import params_from_jax

            rt = ref_api.pack_tree(rcfg, params,
                                   RefSpec(bits=nbits, group_size=32),
                                   cache=RefCache())
            pt = pack_tree(pcfg, params_from_jax(np_params, device="cpu"),
                           QuantSpec(bits=nbits, group_size=32),
                           cache=PortCache(), device="cpu")
            cache[nbits] = (rcfg, pcfg, rt, pt)
        return cache[nbits]

    return get


@pytest.mark.parametrize("nbits", [3, 4])
def test_pack_tree_matches_reference(trees, nbits):
    """Streams, manifest, scales and kernel views bit for bit; every leaf
    of ``other`` (the tied embedding, norms and the seven seeded biases)
    equal to the reference's under the same keys."""
    _, _, rt, pt = trees(nbits)
    assert np.array_equal(pt.streams.numpy(), np.asarray(rt.streams))
    assert pt.manifest.to_json_dict() == rt.manifest.to_json_dict()
    for key, s in rt.scales.items():
        assert np.array_equal(bits(pt.scales[key]), bits(s)), key
    assert sorted(pt.packed) == sorted(rt.packed)
    for key, v in rt.packed.items():
        assert np.array_equal(pt.packed[key].numpy().view(np.uint32),
                              np.asarray(v)), key
    got, want = leaves(pt.other), leaves(rt.other)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert str(g.dtype).split(".")[-1] == np.asarray(w).dtype.name, path
        assert np.array_equal(bits(g), bits(w)), path
    paths = {p for p, _ in got}
    assert {"attn/bq", "attn/bk", "attn/bv", "attn/bo", "mlp/b_gate",
            "mlp/b_up", "mlp/b_down"} <= paths
    assert "unembed" not in paths                      # tied


@pytest.mark.parametrize("nbits", [3, 4])
def test_packed_decode_matches_reference(trees, nbits):
    """Two forced prompt tokens, then DECODE_STEPS greedy steps with a
    packed KV cache in both packages: logits within ``LOGIT_ATOL``, the
    greedy tokens equal and the KV pages equal.  int3 serves
    stream-direct, int4 through the lane-packed views."""
    rcfg, pcfg, rt, pt = trees(nbits)
    rs = RefModel(rcfg, remat="none").init_decode_state(B, MAX_SEQ)
    rs["packed_kv"] = RefKV.create(rcfg, bits=nbits, page_tokens=8,
                                   n_slots=B, max_seq=MAX_SEQ,
                                   cache=RefCache())
    ps = init_decode_state(pcfg, B, MAX_SEQ, kv="packed", device="cpu")
    ps["packed_kv"] = PortKV.create(pcfg, bits=nbits, page_tokens=8,
                                    n_slots=B, max_seq=MAX_SEQ,
                                    cache=PortCache(), device="cpu")
    prompt = [[17, 301], [250, 3]]
    tok = np.asarray([p[0] for p in prompt], np.int32)
    for step in range(DECODE_STEPS + 2):
        rl, rs = ref_step(rcfg, rt, rs, jnp.asarray(tok), interpret=True,
                          kv="packed")
        pl, ps = packed_decode_step(pcfg, pt, ps, torch.from_numpy(tok),
                                    kv="packed")
        rl, pl = np.asarray(rl).astype(np.float32), pl.float().numpy()
        assert pl.shape == rl.shape == (B, pcfg.vocab_size)
        np.testing.assert_allclose(pl, rl, rtol=0, atol=LOGIT_ATOL)
        if step > 0:
            assert np.array_equal(pl.argmax(-1), rl.argmax(-1)), step
        tok = np.asarray([p[1] for p in prompt], np.int32) if step == 0 \
            else pl.argmax(-1).astype(np.int32)
    assert np.array_equal(ps["packed_kv"].host_pages(),
                          np.asarray(rs["packed_kv"].pages))


def test_serve_cli_qwen2_vl_packed_completes(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", ARCH, "--reduced", "--packed", "--bits", "3",
                "--device", "cpu", "--requests", "3", "--batch-size", "2",
                "--max-new", "3", "--max-seq", "32"])
    out = capsys.readouterr().out
    assert "serving path: stream-direct (int3), packed int3 KV" in out
    assert "completed=3/3" in out
