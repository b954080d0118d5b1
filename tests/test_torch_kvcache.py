"""The port's packed KV cache against the reference ``repro.kvcache``.

Tables are held ``np.array_equal``; page words bit-identical after the
same append / reset / evict walk; the plain ``stream_attention`` within
``atol=1e-2`` of the reference Pallas kernel (interpret mode), since the
output is bf16 and the f32 sums run in another order.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.iris import LayoutCache as RefCache  # noqa: E402
from repro.kvcache import PackedKVCache as RefKV  # noqa: E402
from repro.kvcache import append_tables as ref_append_tables  # noqa: E402
from repro.kvcache.kernels import stream_attention_cache as ref_att  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.core.iris import LayoutCache as PortCache  # noqa: E402
from repro_torch.kvcache import PackedKVCache as PortKV  # noqa: E402
from repro_torch.kvcache import append_tables as port_append_tables  # noqa: E402
from repro_torch.kvcache.stream_attention import (  # noqa: E402
    stream_attention_cache as port_att,
)

ATT_ATOL = 1e-2


def _cfgs(**kw):
    base = dict(n_layers=2, d_model=40, n_heads=4, n_kv_heads=2, d_ff=64,
                vocab_size=64)
    base.update(kw)
    return (get_config("smollm-135m").reduced(**base),
            port_configs.SMOLLM_135M.reduced(**base))


def _pair(bits, hd, *, heads=(4, 2), n_slots=3, max_seq=8, page_tokens=4):
    h, hkv = heads
    rcfg, pcfg = _cfgs(n_heads=h, n_kv_heads=hkv, head_dim=hd,
                       d_model=h * hd)
    ref = RefKV.create(rcfg, bits=bits, page_tokens=page_tokens,
                       n_slots=n_slots, max_seq=max_seq, cache=RefCache())
    port = PortKV.create(pcfg, bits=bits, page_tokens=page_tokens,
                         n_slots=n_slots, max_seq=max_seq, cache=PortCache(),
                         device="cpu")
    return ref, port


def _pages_equal(ref, port):
    return np.array_equal(np.asarray(ref.pages), port.host_pages())


@pytest.mark.parametrize("bits,hd", [(3, 5), (4, 64), (8, 4)])
def test_manifest_and_tables_match_reference(bits, hd):
    ref, port = _pair(bits, hd)
    assert port.manifest.to_json_dict() == ref.manifest.to_json_dict()
    rt = ref_append_tables(ref.program(), page_tokens=4,
                           logical=ref.manifest.logical())
    pt = port_append_tables(port.program(), page_tokens=4,
                            logical=port.manifest.logical())
    assert rt.K == pt.K
    for name in ("src", "scode", "tok", "maskbits"):
        assert np.array_equal(getattr(pt, name), getattr(rt, name)), name
    assert (pt.piece_base, pt.per_token, pt.logical) \
        == (rt.piece_base, rt.per_token, rt.logical)
    rf, pf = ref.stream_tables(), port.stream_tables()
    assert sorted(rf) == sorted(pf)
    for name in rf:
        assert np.array_equal(pf[name], np.asarray(rf[name])), name


def _walk_ops(seed, n_slots=3):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(14):
        r = rng.random()
        if r < 0.15:
            ops.append(("reset", int(rng.integers(0, n_slots))))
        elif r < 0.25:
            ops.append(("evict", sorted(set(
                int(x) for x in rng.integers(0, n_slots, size=2)))))
        else:
            ops.append(("append", sorted(set(
                int(x) for x in rng.integers(0, n_slots, size=2)))))
    return ops


def _run_walk(ref, port, ops, seed, layer):
    """Apply ``ops`` to both caches with the same numpy-made K/V."""
    rng = np.random.default_rng(seed + 100)
    man = port.manifest
    clock = [0] * man.n_slots
    for op, arg in ops:
        if op in ("reset", "evict"):
            ref = getattr(ref, op)(arg)
            getattr(port, op)(arg)
            for s in np.atleast_1d(arg):
                clock[int(s)] = 0
            continue
        slots = [s for s in arg if clock[s] < man.smax]
        if not slots:
            continue
        shape = (len(slots), man.n_kv_heads, man.head_dim)
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        pos = np.asarray([clock[s] for s in slots], np.int32)
        ref = ref.append(jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                         jnp.asarray(slots, jnp.int32), layer=layer)
        port.append(torch.from_numpy(k), torch.from_numpy(v),
                    torch.from_numpy(pos), torch.tensor(slots), layer=layer)
        for s in slots:
            clock[s] += 1
    return ref, port, clock


@pytest.mark.parametrize("bits,hd,seed", [(3, 5, 0), (4, 6, 1), (8, 4, 2),
                                          (3, 64, 3), (5, 8, 4)])
def test_page_words_bit_identical_after_walk(bits, hd, seed):
    ref, port = _pair(bits, hd)
    ref, port, _ = _run_walk(ref, port, _walk_ops(seed), seed, layer=1)
    assert _pages_equal(ref, port)
    rk, rv = ref.dense_kv(1)
    pk, pv = port.dense_kv(1)
    assert np.array_equal(pk.numpy(), np.asarray(rk))
    assert np.array_equal(pv.numpy(), np.asarray(rv))


def test_append_overwrite_and_reset_in_place():
    ref, port = _pair(3, 8, n_slots=2)
    rng = np.random.default_rng(5)
    for _ in range(2):                        # same position twice
        k = rng.standard_normal((1, 2, 8)).astype(np.float32)
        v = rng.standard_normal((1, 2, 8)).astype(np.float32)
        ref = ref.append(jnp.asarray(k), jnp.asarray(v), jnp.asarray([2]),
                         jnp.asarray([1]), layer=0)
        out = port.append(torch.from_numpy(k), torch.from_numpy(v),
                          torch.tensor([2]), torch.tensor([1]), layer=0)
        assert out is port
        assert _pages_equal(ref, port)
    assert port.reset(1) is port and not port.pages.any()


@pytest.mark.parametrize("bits,heads,hd", [(3, (4, 2), 6), (4, (4, 4), 5),
                                           (8, (6, 2), 4), (3, (9, 3), 64),
                                           # rep 12: mistral-large-123b's
                                           # and command-r-plus-104b's GQA
                                           (3, (24, 2), 8), (4, (12, 1), 16)])
def test_stream_attention_plain_matches_pallas_interpret(bits, heads, hd):
    h, _ = heads
    ref, port = _pair(bits, hd, heads=heads, max_seq=12)
    ops = [("append", [0, 1, 2])] * 6 + [("append", [0])] * 3
    ref, port, clock = _run_walk(ref, port, ops, bits + hd, layer=0)
    pos = np.asarray([c - 1 for c in clock], np.int32)       # ragged
    q = np.asarray(jnp.asarray(np.random.default_rng(hd).standard_normal(
        (3, 1, h, hd)), jnp.bfloat16))
    slots = np.arange(3, dtype=np.int32)
    want = np.asarray(ref_att(ref, jnp.asarray(q), jnp.asarray(pos),
                              jnp.asarray(slots), layer=0,
                              interpret=True)).astype(np.float32)
    qt = torch.from_numpy(q.view(np.int16).copy()).view(torch.bfloat16)
    got = port_att(port, qt, torch.from_numpy(pos),
                   torch.from_numpy(slots), layer=0)
    assert got.dtype == torch.bfloat16 and got.shape == (3, 1, h, hd)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=ATT_ATOL)


def test_stream_attention_reads_selected_rows():
    """Attending through ``slot_ids`` equals attending over the same rows
    gathered up front (the kernel reads pages through slot ids)."""
    _, port = _pair(4, 8, n_slots=3)
    rng = np.random.default_rng(3)
    for t in range(5):
        k = torch.from_numpy(rng.standard_normal((3, 2, 8)).astype(np.float32))
        port.append(k, -k, torch.full((3,), t), torch.arange(3), layer=0)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 8)).astype(
        np.float32)).to(torch.bfloat16)
    pos = torch.tensor([4, 2])
    a = port_att(port, q, pos, torch.tensor([2, 0]), layer=0)
    from repro_torch.models.attention import decode_attention

    kf, vf = port.dense_kv(0, torch.tensor([2, 0]))
    assert torch.equal(a, decode_attention(q, kf, vf, pos))
