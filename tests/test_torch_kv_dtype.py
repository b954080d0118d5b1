"""The fp8 KV cache (``kv_cache_dtype="float8_e5m2"``) and the two
quantization helpers of ``repro.quant.qtypes`` against the reference.

* fp8: the recipe of the reference's
  ``tests/test_codegen_and_roofline.py::TestKVCacheDtype`` (reduced
  smollm, 2 rows, greedy dense decode), the reference's
  ``Model(cfg).init(PRNGKey(0))`` parameters carried across.  The port's
  cache is ``torch.float8_e5m2``; at every step its fp8 logits are within
  ``FP8_ULPS`` bf16 ulps of the reference's fp8 logits (both cast the
  model-dtype K/V to fp8 on write and back on read) and its greedy
  tokens equal the reference's; the port's fp8 logits stay within the
  reference's bar of its bf16 logits.
* ``quant_error_bound`` for every width and group, and
  ``codes_as_numpy_elements`` of seeded ``QuantizedTensor``s at int2-8,
  equal to the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

#: bf16 ulps of the largest |logit| the port's fp8 logits may differ
#: from the reference's by (the two run other bf16 summation orders)
FP8_ULPS = 2
STEPS = 5


def _ulp(x: float) -> float:
    """One bf16 ulp at magnitude ``x``."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.fixture(scope="module")
def fp8_runs():
    """(reference logits, port logits, reference tokens, port tokens,
    the port's cache dtype), each by kv dtype, over ``STEPS`` steps."""
    from repro.configs import get_config
    from repro.models.model import Model as RefModel
    from repro_torch import configs as pc
    from repro_torch.models.model import Model
    from repro_torch.models.params import params_from_jax

    kw = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
              vocab_size=64, head_dim=32)
    rcfg = get_config("smollm-135m").reduced(**kw)
    pcfg = pc.SMOLLM_135M.reduced(**kw)
    params = RefModel(rcfg, remat="none").init(jax.random.PRNGKey(0))
    pparams = params_from_jax(jax.tree.map(np.asarray, params),
                              device="cpu")
    out = {}
    for kv in ("", "float8_e5m2"):
        rm = RefModel(dataclasses.replace(rcfg, kv_cache_dtype=kv),
                      remat="none")
        pm = Model(dataclasses.replace(pcfg, kv_cache_dtype=kv),
                   remat="none")
        rs, ps = rm.init_decode_state(2, 16), pm.init_decode_state(
            2, 16, device="cpu")
        step = jax.jit(rm.decode_step)
        rt = jnp.array([3, 5], jnp.int32)
        pt = torch.tensor([3, 5], dtype=torch.int32)
        runs = {"ref": [], "port": [], "ref_tok": [], "port_tok": [],
                "dtype": ps["k_cache"].dtype}
        for _ in range(STEPS):
            rl, rs = step(params, rs, rt, None)
            pl, ps = pm.decode_step(pparams, ps, pt)
            rt = jnp.argmax(rl, -1).astype(jnp.int32)
            pt = pl.argmax(-1).to(torch.int32)
            runs["ref"].append(np.asarray(rl, np.float32))
            runs["port"].append(pl.float().numpy())
            runs["ref_tok"].append(np.asarray(rt).tolist())
            runs["port_tok"].append(pt.tolist())
        out[kv or "bfloat16"] = runs
    return out


def test_fp8_cache_dtype(fp8_runs):
    assert fp8_runs["float8_e5m2"]["dtype"] == torch.float8_e5m2
    assert fp8_runs["bfloat16"]["dtype"] == torch.bfloat16


@pytest.mark.parametrize("kv", ["float8_e5m2", "bfloat16"])
def test_decode_logits_and_tokens_match_reference(fp8_runs, kv):
    runs = fp8_runs[kv]
    for ref, port in zip(runs["ref"], runs["port"]):
        tol = FP8_ULPS * _ulp(float(np.abs(ref).max()))
        assert np.abs(port - ref).max() <= tol
    assert runs["port_tok"] == runs["ref_tok"]


def test_fp8_tracks_bf16_within_the_reference_bar(fp8_runs):
    """The reference's bar between its bf16 and fp8 logits, on the
    port's, at every step."""
    for a, b in zip(fp8_runs["bfloat16"]["port"],
                    fp8_runs["float8_e5m2"]["port"]):
        assert np.abs(a - b).max() < 0.35 * np.abs(a).max() + 0.5


def test_quant_error_bound_matches_reference():
    from repro.quant import QuantSpec as RefSpec
    from repro.quant.qtypes import quant_error_bound as ref_bound
    from repro_torch.quant import QuantSpec, quant_error_bound

    for bits in range(2, 9):
        for group in (32, 64, 128):
            assert quant_error_bound(QuantSpec(bits=bits, group_size=group)) \
                == ref_bound(RefSpec(bits=bits, group_size=group))


@pytest.mark.parametrize("bits", range(2, 9))
def test_codes_as_numpy_elements_matches_reference(bits):
    from repro.quant import QuantSpec as RefSpec
    from repro.quant import quantize as ref_quantize
    from repro.quant.qtypes import codes_as_numpy_elements as ref_codes
    from repro_torch.quant import QuantSpec, codes_as_numpy_elements, quantize

    w = np.random.default_rng(bits).standard_normal((128, 48), np.float32)
    got = codes_as_numpy_elements(quantize(torch.from_numpy(w),
                                           QuantSpec(bits=bits,
                                                     group_size=32)))
    want = ref_codes(ref_quantize(jnp.asarray(w),
                                  RefSpec(bits=bits, group_size=32)))
    assert got.dtype == want.dtype == np.uint64
    assert np.array_equal(got, want)
