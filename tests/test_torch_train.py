"""The port's training path against the reference: ``Model.loss`` and its
gradients for every family, remat, the ``ssd_scan`` gradient and
``build_train_step``.

Reduced configs (``cfg.reduced()``: 2 layers, d_model 128; jamba
``moe=None, n_layers=8``, one period of 7 Mamba sublayers and 1
attention sublayer), the reference's ``Model.init`` weights with every
constant-init leaf (biases, LayerNorm biases, RWKV's ``bonus_u`` /
``mix`` / ``decay_w0``) seeded (``tests/_torch_families.py``), carried to
the port with ``params_from_jax``.  Tokens, labels, masks and frames are
numpy draws from a seed.  The reference's gradient is
``jax.value_and_grad(Model.loss)`` (jitted); the port's is
``torch.autograd.grad`` over every leaf, on the CPU (``ssd_scan`` runs
its plain version there, through its autograd Function).

Tolerances:
* f32 loss: within ``LOSS_RTOL`` = 1e-5 relative.
* f32 gradients, leaf by leaf: within ``GRAD_RTOL`` = 1e-4 of the leaf's
  largest entry, plus ``GRAD_FLOOR`` = 1e-7 absolute.  The floor is for
  gradients that are zero in exact arithmetic, which both packages give
  as f32 roundoff of ~1e-9: a key bias ``bk`` does not move the softmax
  (it adds ``q . bk`` to every score of a query).
* bf16 loss (reduced smollm, bf16 weights): ``BF16_LOSS_RTOL`` = 2e-3
  relative (2 layers of bf16 rounding in two orders of summation;
  measured 0 to 4e-4).
* remat ``"full"`` / ``"dots"`` against ``"none"`` on the CPU: equal bit
  for bit (the recompute runs the same kernels on the same inputs).
* ``build_train_step`` against the reference's jitted step over 8 steps
  (reduced smollm, f32): losses within ``STEP_LOSS_RTOL`` = 1e-5,
  ``grad_norm`` within ``STEP_NORM_RTOL`` = 1e-5 relative; ``lr``
  within 2 f32 ulps (the cosine's last bit; measured 0 or 1);
  parameters within ``STEP_PARAM_ATOL`` = 2e-4 absolute, and all but
  ``STEP_PARAM_OUTLIERS`` = 16 entries within ``STEP_PARAM_CLOSE`` =
  1e-5.  An entry whose gradient is within f32 roundoff of 0 can take
  another Adam direction (its first update is ``g / (|g| + eps)``):
  measured 6.8e-5 at 5 of the 361088 entries (peak lr 1e-2), the rest
  within 1e-5.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from _torch_families import cfgs, leaves, models, to_np  # noqa: E402

from repro.launch.steps import build_train_step as ref_build  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.optim.adamw import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.optim.adamw import init_opt_state as ref_init_opt  # noqa: E402
from repro_torch.kernels import linear_scan as ls  # noqa: E402
from repro_torch.launch.steps import build_train_step  # noqa: E402
from repro_torch.models import mamba as pmamba  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import params_from_jax  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.pytree import flatten, tree_map, unflatten  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-7
BF16_LOSS_RTOL = 2e-3
STEP_LOSS_RTOL = STEP_NORM_RTOL = 1e-5
STEP_PARAM_ATOL, STEP_PARAM_CLOSE, STEP_PARAM_OUTLIERS = 2e-4, 1e-5, 16
B, S = 2, 16

FAMILIES = {
    "smollm": ("smollm-135m", {}),
    "stablelm": ("stablelm-3b", {}),
    "jamba": ("jamba-1.5-large-398b", dict(moe=None, n_layers=8)),
    "moonshot": ("moonshot-v1-16b-a3b", {}),
    "rwkv": ("rwkv6-3b", {}),
    "whisper": ("whisper-medium", {}),
    "qwen2_vl": ("qwen2-vl-2b", {}),
}


def _batch(cfg, seed: int = 3, mask: bool = False) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.encoder is not None:
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder.n_ctx, cfg.d_model)).astype(np.float32)
    if mask:
        batch["loss_mask"] = (rng.random((B, S)) < 0.6).astype(np.float32)
    return batch


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _ref_loss_grads(rcfg, params, batch):
    loss, grads = jax.jit(jax.value_and_grad(
        RefModel(rcfg, remat="none").loss))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), [np.asarray(g, np.float32)
                         for _, g in leaves(grads)]


def _port_loss_grads(pcfg, pp, batch, remat: str = "full"):
    """The port's loss and every leaf's gradient (in ``leaves`` order)."""
    ls_ = [p.detach().requires_grad_(True) for p in flatten(pp)]
    loss = Model(pcfg, remat=remat).loss(unflatten(pp, ls_),
                                         _torch_batch(batch))
    grads = torch.autograd.grad(loss, ls_, allow_unused=True)
    return loss, [torch.zeros_like(p) if g is None else g
                  for p, g in zip(ls_, grads)]


def _assert_grads_close(paths, got, want) -> None:
    for path, g, w in zip(paths, got, want):
        g = to_np(g)
        assert g.shape == w.shape, path
        err = np.abs(g - w).max()
        assert err <= GRAD_RTOL * np.abs(w).max() + GRAD_FLOOR, \
            (path, err, np.abs(w).max())


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_grads_match_reference(family):
    arch, kw = FAMILIES[family]
    rcfg, pcfg, params, _, pp = models(arch, **kw)
    batch = _batch(rcfg)
    want_loss, want = _ref_loss_grads(rcfg, params, batch)
    loss, got = _port_loss_grads(pcfg, pp, batch)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(float(loss) / want_loss - 1) <= LOSS_RTOL
    if pcfg.moe is not None:                  # the aux term is in the loss
        _, aux, _ = Model(pcfg).forward(pp, _torch_batch(batch))
        assert float(aux) > 0
    _assert_grads_close([p for p, _ in leaves(pp)], got, want)


def test_loss_mask_matches_reference():
    rcfg, pcfg, params, _, pp = models("smollm-135m")
    batch = _batch(rcfg, mask=True)
    assert 0 < batch["loss_mask"].sum() < batch["loss_mask"].size
    want_loss, want = _ref_loss_grads(rcfg, params, batch)
    loss, got = _port_loss_grads(pcfg, pp, batch)
    assert abs(float(loss) / want_loss - 1) <= LOSS_RTOL
    _assert_grads_close([p for p, _ in leaves(pp)], got, want)
    # an all-zero mask divides by 1: the loss is the aux term, 0 here
    batch["loss_mask"] = np.zeros_like(batch["loss_mask"])
    assert float(Model(pcfg).loss(pp, _torch_batch(batch))) == 0.0


def test_bf16_loss_matches_reference():
    rcfg, pcfg, params, _, pp = models("smollm-135m", dtype="bfloat16")
    batch = _batch(rcfg)
    want = float(RefModel(rcfg, remat="none").loss(
        params, {k: jnp.asarray(v) for k, v in batch.items()}))
    got = Model(pcfg).loss(pp, _torch_batch(batch))
    assert got.dtype == torch.float32
    assert abs(float(got) / want - 1) <= BF16_LOSS_RTOL


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("family", ["jamba", "moonshot"])
def test_remat_policies_equal_bit_for_bit(family, remat):
    """Through the ``ssd_scan`` Function (jamba) and MoE's accumulating
    ``index_put_`` (moonshot)."""
    arch, kw = FAMILIES[family]
    _, pcfg, _, _, pp = models(arch, **kw)
    batch = _batch(pcfg)
    want_loss, want = _port_loss_grads(pcfg, pp, batch, remat="none")
    loss, got = _port_loss_grads(pcfg, pp, batch, remat=remat)
    assert torch.equal(loss, want_loss)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_remat_dots_saves_the_weight_products():
    """The backward's weight products (``aten.mm``, the forward's
    recompute included) counted under each policy: "dots" recomputes no
    ``mm`` (as "none"); "full" recomputes a layer's q, k, v, o, gate and
    up products, and not the down product, whose output no backward
    reads (the recompute stops once it has what the backward needs)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMM(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func in (torch.ops.aten.mm.default,
                               torch.ops.aten.addmm.default)
            return func(*args, **(kwargs or {}))

    _, pcfg = cfgs("smollm-135m")
    pp = Model(pcfg).init(torch.Generator().manual_seed(0), device="cpu")
    batch = _torch_batch(_batch(pcfg))
    counts = {}
    for remat in ("full", "dots", "none"):
        leaves_ = [p.detach().requires_grad_(True) for p in flatten(pp)]
        loss = Model(pcfg, remat=remat).loss(unflatten(pp, leaves_), batch)
        with CountMM() as mode:
            torch.autograd.grad(loss, leaves_)
        counts[remat] = mode.n
    per_layer = 6
    assert counts["dots"] == counts["none"]
    assert counts["full"] == counts["none"] + per_layer * pcfg.n_layers


def test_unknown_remat_policy_raises():
    _, pcfg = cfgs("smollm-135m")
    pp = Model(pcfg).init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="unknown remat policy"):
        Model(pcfg, remat="everything").loss(pp, _torch_batch(_batch(pcfg)))


def test_serve_path_unchanged_by_remat(monkeypatch):
    """Without a backward nothing is wrapped: the forward gives the same
    bits and the same ``ssd_scan`` calls under every policy, with grad
    disabled and with grad enabled over parameters that need none (as
    ``build_prefill_step`` runs)."""
    _, pcfg, _, _, pp = models("jamba-1.5-large-398b", moe=None,
                               n_layers=8)
    calls = []

    def counted(*args, **kwargs):
        calls.append(torch.is_grad_enabled())
        return ls.ssd_scan(*args, **kwargs)

    monkeypatch.setattr(pmamba, "ssd_scan", counted)
    batch = {"tokens": torch.from_numpy(_batch(pcfg)["tokens"])}
    outs = {}
    for remat in ("full", "dots", "none"):
        for grad in (False, True):
            calls.clear()
            with torch.set_grad_enabled(grad):
                logits, _, caches = Model(pcfg, remat=remat).forward(
                    pp, batch, collect_cache=True)
            assert logits.grad_fn is None
            assert calls == [grad] * 7
            outs[remat, grad] = (logits, caches)
    base_logits, base_caches = outs["none", False]
    for logits, caches in outs.values():
        assert torch.equal(logits, base_logits)
        assert all(torch.equal(a, b) for a, b in
                   zip(flatten(caches), flatten(base_caches)))


@pytest.mark.parametrize("return_state", [False, True])
def test_ssd_scan_function_grad_equals_plain_autograd(return_state):
    """The Function's backward (a recompute of ``ssd_scan_plain``) against
    autograd straight through ``ssd_scan_plain``: bit for bit, with
    ``state0``, a ragged T and, with ``return_state``, a gradient through
    the final state."""
    rng = np.random.default_rng(11)
    b, t, h, dk, dv = 2, 45, 3, 16, 8

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    arrays = [draw(b, t, h, dk), draw(b, t, h, dk), draw(b, t, h, dv),
              -np.log1p(np.exp(draw(b, t, h))), draw(b, h, dk, dv)]
    weights = (torch.from_numpy(draw(b, t, h, dv)),
               torch.from_numpy(draw(b, h, dk, dv)))
    results = []
    for fn in (ls.ssd_scan, ls.ssd_scan_plain):
        xs = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
        out = fn(*xs[:4], chunk=16, state0=xs[4],
                 return_state=return_state)
        if return_state:
            out, final = out
            loss = (out * weights[0]).sum() + (final * weights[1]).sum()
        else:
            loss = (out * weights[0]).sum()
        if fn is ls.ssd_scan:
            assert type(out.grad_fn).__name__ == "_SSDScanBackward"
        results.append(torch.autograd.grad(loss, xs))
    for got, want in zip(*results):
        assert torch.equal(got, want)
        assert torch.isfinite(got).all() and got.abs().max() > 0


def test_ssd_scan_grad_only_for_inputs_that_need_it():
    rng = np.random.default_rng(12)
    q, k = (torch.from_numpy(rng.standard_normal((1, 8, 2, 4))
                             .astype(np.float32)) for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((1, 8, 2, 4))
                         .astype(np.float32)).requires_grad_(True)
    logw = -torch.rand(1, 8, 2)
    out = ls.ssd_scan(q, k, v, logw)
    (gv,) = torch.autograd.grad(out.sum(), [v])
    want = torch.autograd.grad(ls.ssd_scan_plain(q, k, v, logw).sum(), [v])
    assert torch.equal(gv, want[0])


def _smollm_f32_state():
    rcfg, pcfg, params, np_params, _ = models("smollm-135m")
    ref_state = {"params": params, "opt": ref_init_opt(params)}
    pp = params_from_jax(np_params, device="cpu")
    return rcfg, pcfg, ref_state, {"params": pp, "opt": init_opt_state(pp)}


def test_train_step_matches_reference_over_8_steps():
    from repro.data.pipeline import SyntheticLMPipeline

    rcfg, pcfg, ref_state, state = _smollm_f32_state()
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=8)
    ref_step = jax.jit(ref_build(rcfg, RefAdamWConfig(**kw)))
    step = build_train_step(pcfg, AdamWConfig(**kw))
    pipe = SyntheticLMPipeline(rcfg.vocab_size, 32, 4, seed=0)
    for i in range(8):
        batch = pipe.next_batch()
        ref_state, rm = ref_step(ref_state, {k: jnp.asarray(v)
                                             for k, v in batch.items()})
        state, m = step(state, _torch_batch(batch))
        assert abs(float(m["loss"]) / float(rm["loss"]) - 1) \
            <= STEP_LOSS_RTOL, i
        assert abs(float(m["grad_norm"]) / float(rm["grad_norm"]) - 1) \
            <= STEP_NORM_RTOL, i
        np.testing.assert_array_max_ulp(
            np.float32(m["lr"]), np.asarray(rm["lr"]), maxulp=2)
        assert int(state["opt"]["step"]) == i + 1
        outliers = 0
        for (path, w), g in zip(leaves(ref_state["params"]),
                                flatten(state["params"])):
            err = np.abs(to_np(g) - np.asarray(w))
            assert err.max() <= STEP_PARAM_ATOL, (i, path, err.max())
            outliers += int((err > STEP_PARAM_CLOSE).sum())
        assert outliers <= STEP_PARAM_OUTLIERS, (i, outliers)


def test_nonfinite_loss_leaves_state_unchanged():
    _, pcfg, _, state = _smollm_f32_state()
    state["params"]["embed"][3, 0] = float("nan")
    before = tree_map(torch.clone, state)
    batch = _torch_batch(_batch(pcfg))
    batch["tokens"][0, 0] = 3
    new, m = build_train_step(pcfg)(state, batch)
    assert not np.isfinite(float(m["loss"]))
    assert new["params"]["blocks"][0]["attn"]["wq"].data_ptr() != \
        state["params"]["blocks"][0]["attn"]["wq"].data_ptr()
    for got, want in zip(flatten(state), flatten(before)):
        assert torch.equal(got.view(torch.int32) if got.is_floating_point()
                           else got,
                           want.view(torch.int32) if want.is_floating_point()
                           else want)


def test_train_step_leaves_bf16_params_bf16():
    _, pcfg = cfgs("smollm-135m", "bfloat16")
    gen = torch.Generator().manual_seed(0)
    pp = Model(pcfg).init(gen, device="cpu")
    state = {"params": pp, "opt": init_opt_state(pp, "bfloat16")}
    step = build_train_step(pcfg, AdamWConfig(lr=1e-2, warmup_steps=1))
    new, m = step(state, _torch_batch(_batch(pcfg)))
    assert np.isfinite(float(m["loss"]))
    for got, want in zip(flatten(new), flatten(state)):
        assert got.dtype == want.dtype and got.shape == want.shape
    assert new["opt"]["m"]["embed"].dtype == torch.bfloat16
    assert int(new["opt"]["step"]) == 1
    # a step of ~lr = 1e-2 moves every bf16 leaf
    assert all(not torch.equal(a, b) for a, b in
               zip(flatten(new["params"]), flatten(pp)))


def test_train_step_equal_under_every_remat():
    _, pcfg = cfgs("smollm-135m")
    pcfg = dataclasses.replace(pcfg, n_layers=4)
    pp = Model(pcfg).init(torch.Generator().manual_seed(1), device="cpu")
    state = {"params": pp, "opt": init_opt_state(pp)}
    batch = _torch_batch(_batch(pcfg))
    outs = [build_train_step(pcfg, remat=r)(state, batch)
            for r in ("full", "dots", "none")]
    for new, m in outs[:2]:
        assert torch.equal(m["loss"], outs[2][1]["loss"])
        for a, b in zip(flatten(new), flatten(outs[2][0])):
            assert torch.equal(a, b)
