"""The port's optimizer and gradient compression against the reference's
(``src/repro/optim``).

Trees are numpy draws from a seed, shaped as the reduced configs'
parameter trees, handed to both packages.  The reference runs jitted,
as its train step runs it, and for the compressor also eagerly.

Tolerances:
* ``lr_schedule``: within 2 f32 ulps of the jitted reference (the
  cosine's last bit), and equal at the end of warm-up and past the end.
* ``global_norm``: within ``NORM_RTOL`` = 4e-6 relative (361088
  squares summed in another order: measured 0 to 1 ulp over f32
  leaves, 1.4e-6 over bf16 leaves).
* ``adamw_update`` against the jitted reference, leaf by leaf: f32
  leaves within ``F32_ULPS`` = 4 ulps of the leaf's largest entry, bf16
  leaves within ``BF16_ULPS`` = 1 bf16 ulp of it.  XLA fuses the jitted
  update into FMAs (``b1 * m + (1 - b1) * g``, ``p - lr * delta``),
  which round once where the port rounds twice, and the clip scale
  carries ``global_norm``'s error into every entry (measured: f32
  parameters 2 ulps, f32 moments 3 ulps of the leaf's largest entry
  with bf16 gradients; bf16 parameters and moments 0.5 ulp).
* ``GradCompressor``: codes, scales, residuals and the decompressed
  gradients bit-identical to the jitted reference (``amax / 127.0`` is
  a multiply by the f32 reciprocal there, and in the port); against the
  eager reference, which divides, the scales may differ in the last bit
  and nothing else.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from _torch_families import cfgs, leaves  # noqa: E402

from repro.models.model import Model as RefModel  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro.optim.compression import GradCompressor as RefCompressor  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.models.params import params_from_jax  # noqa: E402
from repro_torch.optim import adamw as padamw  # noqa: E402
from repro_torch.optim.compression import GradCompressor  # noqa: E402
from repro_torch.pytree import flatten, leaf_paths  # noqa: E402

NORM_RTOL = 4e-6
F32_ULPS, BF16_ULPS = 4, 1


def _np_tree(arch: str = "smollm-135m", seed: int = 0, scale: float = 1.0,
             dtype=np.float32):
    """A tree of the reduced config's structure and shapes, drawn from
    ``seed``."""
    rcfg, _ = cfgs(arch)
    shapes = jax.eval_shape(RefModel(rcfg, remat="none").init,
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (scale * rng.standard_normal(s.shape))
                        .astype(dtype), shapes)


def _to_port(np_tree):
    return params_from_jax(np_tree, device="cpu")


def _bf16(np_tree):
    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                        np_tree)


def _assert_leaf_close(got: torch.Tensor, want, path: str = "") -> None:
    """Within ``F32_ULPS`` / ``BF16_ULPS`` ulps (of the leaf's dtype) of
    the leaf's largest entry."""
    w = np.asarray(want)
    bf16 = w.dtype.name == "bfloat16"
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32), path
    w = w.astype(np.float32)
    g = got.float().numpy()
    largest = np.abs(w).max()
    ulp = 0.0 if largest == 0 else \
        2.0 ** (np.floor(np.log2(largest)) - (7 if bf16 else 23))
    assert np.abs(g - w).max() <= (BF16_ULPS if bf16 else F32_ULPS) * ulp, \
        (path, np.abs(g - w).max(), ulp)


@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 11, 37, 64, 99, 100, 250])
def test_lr_schedule_matches_reference(step):
    cfg = dict(lr=3e-3, warmup_steps=10, total_steps=100)
    want = np.asarray(jax.jit(
        lambda s: radamw.lr_schedule(radamw.AdamWConfig(**cfg), s))(
        jnp.asarray(step, jnp.int32)))
    got = padamw.lr_schedule(padamw.AdamWConfig(**cfg),
                             torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=2)
    if step == 10 or step >= 100:
        assert float(got) == float(want)
    if step >= 100:
        assert float(got) == np.float32(3e-3 * 0.1)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decay_mask_matches_reference(arch):
    rcfg, pcfg = cfgs(arch)
    shapes = jax.eval_shape(RefModel(rcfg, remat="none").init,
                            jax.random.PRNGKey(0))
    want = [radamw._decay_mask(path, leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(shapes)[0]]
    pp = _to_port(jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                               shapes))
    got = [padamw._decay_mask(path, leaf)
           for path, leaf in zip(leaf_paths(pp), flatten(pp))]
    assert got == want
    assert True in got and False in got
    if pcfg.use_bias:           # stacked (P, N) biases are decayed
        paths = dict(zip(leaf_paths(pp), got))
        assert paths["blocks/0/attn/bq"]


def test_global_norm_matches_reference():
    tree = _np_tree(seed=1, scale=0.01)
    want = np.asarray(jax.jit(radamw.global_norm)(tree))
    got = padamw.global_norm(_to_port(tree))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) / float(want) - 1) <= NORM_RTOL
    bf16 = _bf16(tree)
    got = padamw.global_norm(_to_port(bf16))
    want = np.asarray(jax.jit(radamw.global_norm)(bf16))
    assert abs(float(got) / float(want) - 1) <= NORM_RTOL


def _adamw_case(param_dtype, moment_dtype: str, seed: int):
    params = _np_tree(seed=seed, scale=0.05)
    grads = _np_tree(seed=seed + 1, scale=0.01)
    m = _np_tree(seed=seed + 2, scale=0.001)
    v = jax.tree.map(np.abs, _np_tree(seed=seed + 3, scale=1e-5))
    if param_dtype == "bfloat16":
        params, grads = _bf16(params), _bf16(grads)
    if moment_dtype == "bfloat16":
        m, v = _bf16(m), _bf16(v)
    return params, grads, m, v


@pytest.mark.parametrize("param_dtype,moment_dtype,step", [
    ("float32", "float32", 0), ("float32", "float32", 57),
    ("bfloat16", "float32", 3), ("bfloat16", "bfloat16", 20),
    ("float32", "bfloat16", 11)])
def test_adamw_update_matches_reference(param_dtype, moment_dtype, step):
    params, grads, m, v = _adamw_case(param_dtype, moment_dtype, step)
    kw = dict(lr=1e-2, warmup_steps=10, total_steps=100, clip_norm=0.5)
    ref_opt = {"m": m, "v": v, "step": jnp.asarray(step, jnp.int32)}
    rp, ro, rmet = jax.jit(lambda g, o, p: radamw.adamw_update(
        radamw.AdamWConfig(**kw), g, o, p))(grads, ref_opt, params)
    opt = {"m": _to_port(m), "v": _to_port(v),
           "step": torch.tensor(step, dtype=torch.int32)}
    pp, pg = _to_port(params), _to_port(grads)
    before = [t.clone() for t in flatten(pp)]
    np_, no, met = padamw.adamw_update(padamw.AdamWConfig(**kw), pg, opt,
                                       pp)
    assert all(torch.equal(a, b) for a, b in zip(flatten(pp), before))
    assert int(no["step"]) == step + 1 and no["step"].dtype == torch.int32
    assert abs(float(met["grad_norm"]) / float(rmet["grad_norm"]) - 1) \
        <= NORM_RTOL
    np.testing.assert_array_max_ulp(met["lr"].numpy(), np.asarray(rmet["lr"]),
                                    maxulp=2)
    for (path, w), g in zip(leaves(rp), flatten(np_)):
        _assert_leaf_close(g, w, path)
    for key in ("m", "v"):
        for (path, w), g in zip(leaves(ro[key]), flatten(no[key])):
            _assert_leaf_close(g, w, path)


def test_init_opt_state_matches_reference():
    tree = _np_tree(seed=4)
    for dt in ("float32", "bfloat16"):
        want = radamw.init_opt_state(tree, dt)
        got = padamw.init_opt_state(_to_port(tree), dt)
        assert got["step"].dtype == torch.int32 and got["step"].shape == ()
        for key in ("m", "v"):
            for (path, w), g in zip(leaves(want[key]), flatten(got[key])):
                assert tuple(g.shape) == w.shape and not g.any(), path
                assert str(g.dtype).endswith(dt), path


def _grads_with_edges(seed: int) -> dict:
    """Leaves whose sizes leave padded tails at every block, an all-zero
    leaf, a leaf whose first block is zero, one of tiny and one of huge
    values, and a bf16 leaf."""
    rng = np.random.default_rng(seed)
    zero_head = rng.standard_normal(300).astype(np.float32)
    zero_head[:256] = 0.0
    return {
        "a": rng.standard_normal((7, 45)).astype(np.float32),
        "b": {"c": (rng.standard_normal(1000) * 1e-6).astype(np.float32),
              "d": np.zeros((3, 5), np.float32)},
        "e": [zero_head, (rng.standard_normal(33) * 1e4)
              .astype(np.float32)],
        "f": np.asarray(jnp.asarray(rng.standard_normal((4, 70)),
                                    jnp.bfloat16)),
    }


def _bits(x) -> np.ndarray:
    """The bit patterns of a reference array."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _tbits(t: torch.Tensor) -> np.ndarray:
    """The bit patterns of a port tensor."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    a = t.numpy()
    return a.view(np.uint32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("block", [32, 64, 256])
def test_compressor_bit_identical_to_jitted_reference(block):
    ref, port = RefCompressor(block), GradCompressor(block)
    grads = _grads_with_edges(block)
    ef = jax.tree.map(lambda g: (np.random.default_rng(9).standard_normal(
        np.shape(g)) * 1e-3).astype(np.float32), grads)
    want_deq, want_ef = jax.jit(ref.compress_decompress)(grads, ef)
    got_deq, got_ef = port.compress_decompress(_to_port(grads),
                                               _to_port(ef))
    for (path, w), g in zip(leaves(want_deq), flatten(got_deq)):
        assert np.array_equal(_tbits(g), _bits(w)), path
    for (path, w), g in zip(leaves(want_ef), flatten(got_ef)):
        assert g.dtype == torch.float32
        assert np.array_equal(_tbits(g), _bits(w)), path
    # codes and scales of each leaf
    for (path, g32), pg in zip(leaves(grads), flatten(_to_port(grads))):
        rq, rs = jax.jit(lambda a: ref._quantize(a)[:2])(jnp.asarray(g32))
        q, s, n = port._quantize(pg)
        assert n == pg.numel() and q.dtype == torch.int8
        assert np.array_equal(q.numpy(), np.asarray(rq)), path
        assert np.array_equal(_tbits(s), _bits(rs)), path
        deq = port._dequantize(q, s, n, pg.shape)
        rdeq = ref._dequantize(rq, rs, n, g32.shape)
        assert np.array_equal(_tbits(deq), _bits(rdeq)), path


@pytest.mark.parametrize("block", [32, 256])
def test_compressor_against_eager_reference(block):
    """The eager reference divides by 127: scales within 1 f32 ulp of the
    port's, codes equal wherever its scale equals the port's."""
    ref, port = RefCompressor(block), GradCompressor(block)
    for _, g in leaves(_grads_with_edges(block + 1)):
        g = np.asarray(g, np.float32)
        rq, rs, _ = ref._quantize(jnp.asarray(g))
        q, s, _ = port._quantize(torch.from_numpy(g))
        np.testing.assert_array_max_ulp(s.numpy(), np.asarray(rs), maxulp=1)
        same = (s.numpy() == np.asarray(rs))[:, 0]
        assert np.array_equal(q.numpy()[same], np.asarray(rq)[same])


def test_compressor_state_and_wire_bytes():
    grads = _grads_with_edges(5)
    for block in (32, 64, 256):
        ref, port = RefCompressor(block), GradCompressor(block)
        pg = _to_port(grads)
        assert port.wire_bytes(pg) == ref.wire_bytes(grads)
        state = port.init_state(pg)
        for (path, w), g in zip(leaves(ref.init_state(grads)),
                                flatten(state)):
            assert g.dtype == torch.float32 and not g.any(), path
            assert tuple(g.shape) == np.shape(w), path


def test_error_feedback_carries_over_steps():
    """Three rounds with the residual carried: the jitted reference's
    decompressed gradients and residuals, bit for bit."""
    ref, port = RefCompressor(64), GradCompressor(64)
    grads = [_grads_with_edges(20 + i) for i in range(3)]
    ref_ef = jax.tree.map(lambda g: np.zeros(np.shape(g), np.float32),
                          grads[0])
    ef = port.init_state(_to_port(grads[0]))
    step = jax.jit(ref.compress_decompress)
    for g in grads:
        rdeq, ref_ef = step(g, ref_ef)
        deq, ef = port.compress_decompress(_to_port(g), ef)
        for (path, w), t in zip(leaves(ref_ef), flatten(ef)):
            assert np.array_equal(_tbits(t), _bits(w)), path
        for (path, w), t in zip(leaves(rdeq), flatten(deq)):
            assert np.array_equal(_tbits(t), _bits(w)), path
