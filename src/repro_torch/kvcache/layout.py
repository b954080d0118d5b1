"""Iris-planned KV-cache stream layouts: per-page bundles and tables.

Own copy of ``src/repro/kvcache/layout.py`` (numpy): :func:`kv_bundle`,
:func:`plan_kv_stack` (routed through the port's
:func:`~repro_torch.plan.plan_layer_stack`), :func:`append_tables`,
:func:`page_stream_tables` and :func:`full_stream_tables`.  Tables are
memoized on the lowered program (``ExecProgram.tables``), shared across
layout-cache rebinds.

A slot's cache is a sequence of fixed ``page_tokens`` token pages, each
packed with the same per-page layout.  The layout problem depends only on
``(page_tokens, n_kv_heads, head_dim, bits, m)``, never on sequence
length, so it is planned once and appends never re-plan.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.exec_plan import ExecProgram, pack_kernel_tables
from ..core.iris import DEFAULT_CACHE
from ..plan import BundleTensor, plan_layer_stack


def kv_bundle(cfg, bits: int, page_tokens: int) -> list[BundleTensor]:
    """The Iris bundle for one KV-cache token page: codes quantized per
    head vector (one bf16 scale per (token, head)); K feeds the score
    matmul before V feeds the output, hence two dataflow stages."""
    if not 2 <= bits <= 8:
        raise ValueError(f"kv bits must be in [2, 8], got {bits}")
    if page_tokens <= 0:
        raise ValueError(f"page_tokens must be positive, got {page_tokens}")
    hkv, hd = int(cfg.n_kv_heads), int(cfg.head_dim)
    n_codes = page_tokens * hkv * hd
    n_scales = page_tokens * hkv
    return [
        BundleTensor("kv/k", bits, n_codes, 0),
        BundleTensor("kv/k_scales", 16, n_scales, 0),
        BundleTensor("kv/v", bits, n_codes, 1),
        BundleTensor("kv/v_scales", 16, n_scales, 1),
    ]


def plan_kv_stack(cfg, *, bits: int, page_tokens: int,
                  n_layers: int | None = None, m: int = 512,
                  mode: str = "auto", cache=None):
    """Plan the per-page KV layout for every layer of a model: one
    scheduler run (zero on a warm cache) plus ``n_layers - 1`` hits."""
    if cache is None:
        cache = DEFAULT_CACHE
    return plan_layer_stack(
        cfg, None, m=m, n_layers=n_layers, mode=mode, cache=cache,
        bundle=kv_bundle(cfg, bits, page_tokens))


@dataclasses.dataclass(eq=False)
class AppendTables:
    """Per-word contribution tables for the token-masked page pack.

    All tables are ``(c_max, words32, K)``; ``src`` indexes a flat
    piece-order vector with a zero sentinel at index 0, ``scode >= 0``
    shifts left / ``< 0`` right, ``tok`` is the in-page token owning the
    contribution (-1 = never written), ``maskbits`` the u32 bit mask the
    shifted contribution covers.
    """

    K: int
    src: np.ndarray          # int32
    scode: np.ndarray        # int32
    tok: np.ndarray          # int32
    maskbits: np.ndarray     # uint32
    piece_base: tuple[int, ...]
    per_token: tuple[int, ...]   # pieces per token, per array
    logical: tuple[int, ...]     # logical pieces per array (pre-padding)


def append_tables(prog: ExecProgram, *, page_tokens: int,
                  logical: tuple[int, ...]) -> AppendTables:
    """Derive (and memoize) the append pack tables for one page layout.

    ``logical`` gives each array's bundle element count; padding pieces
    beyond it get token -1 and are never written.
    """
    key = ("kv_append", page_tokens, tuple(logical))
    cached = prog.tables.get(key)
    if cached is not None:
        return cached
    n_arr = len(prog.piece_depths)
    if len(logical) != n_arr:
        raise ValueError(
            f"logical has {len(logical)} entries for {n_arr} arrays")
    for i, n in enumerate(logical):
        if n % page_tokens:
            raise ValueError(
                f"array {i}: {n} elements not divisible by "
                f"page_tokens={page_tokens}")
        if n > prog.piece_depths[i]:
            raise ValueError(
                f"array {i}: {n} logical elements exceed the program's "
                f"{prog.piece_depths[i]} pieces")
    src_t, sc_t, k = pack_kernel_tables(prog)
    w32 = prog.words32
    src = src_t.reshape(prog.c_max, w32, k).astype(np.int32)
    scode = sc_t.reshape(prog.c_max, w32, k).astype(np.int32)

    base = np.asarray(prog.piece_base, dtype=np.int64)
    per_token = tuple(n // page_tokens for n in logical)
    piece = src.astype(np.int64) - 1                       # -1 = empty
    arr_of = np.clip(np.searchsorted(base[1:], piece, side="right"),
                     0, n_arr - 1)
    local = piece - base[arr_of]
    widths = np.asarray(prog.elem_widths, dtype=np.int64)[arr_of]
    ones = (np.uint64(1) << widths.astype(np.uint64)) - np.uint64(1)
    sc64 = scode.astype(np.int64)
    shifted = np.where(sc64 >= 0,
                       ones << np.maximum(sc64, 0).astype(np.uint64),
                       ones >> np.maximum(-sc64, 0).astype(np.uint64))
    maskbits = np.where(src > 0, shifted & np.uint64(0xFFFFFFFF),
                        np.uint64(0)).astype(np.uint32)

    pt = np.asarray(per_token, dtype=np.int64)[arr_of]
    in_range = (src > 0) & (local < np.asarray(logical)[arr_of])
    tok = np.where(in_range & (pt > 0), local // np.maximum(pt, 1), -1)
    maskbits = np.where(tok >= 0, maskbits, np.uint32(0))
    tables = AppendTables(
        K=k, src=src, scode=scode, tok=tok.astype(np.int32),
        maskbits=maskbits,
        piece_base=tuple(int(b) for b in base),
        per_token=per_token,
        logical=tuple(int(x) for x in logical),
    )
    prog.tables[key] = tables
    return tables


def page_bit_stride(prog: ExecProgram) -> int:
    """Bits one packed page occupies in the flattened u32 word view."""
    return prog.c_max * prog.words32 * 32


def page_stream_tables(prog: ExecProgram, *, page_tokens: int,
                       n_kv_heads: int, head_dim: int
                       ) -> dict[str, np.ndarray]:
    """Per-page bit-offset tables of every logical KV element:
    ``k`` / ``v`` ``(page_tokens, n_kv_heads, head_dim)`` uint32, scales
    ``(page_tokens, n_kv_heads)`` uint32."""
    key = ("kv_page_tabs", page_tokens, n_kv_heads, head_dim)
    cached = prog.tables.get(key)
    if cached is not None:
        return cached
    n_codes = page_tokens * n_kv_heads * head_dim
    n_scales = page_tokens * n_kv_heads
    tabs = {
        "k": prog.stream_bit_offsets(0)[:n_codes].reshape(
            page_tokens, n_kv_heads, head_dim),
        "k_scales": prog.stream_bit_offsets(1)[:n_scales].reshape(
            page_tokens, n_kv_heads),
        "v": prog.stream_bit_offsets(2)[:n_codes].reshape(
            page_tokens, n_kv_heads, head_dim),
        "v_scales": prog.stream_bit_offsets(3)[:n_scales].reshape(
            page_tokens, n_kv_heads),
    }
    prog.tables[key] = tabs
    return tabs


def full_stream_tables(prog: ExecProgram, *, page_tokens: int,
                       n_kv_heads: int, head_dim: int, n_pages: int
                       ) -> dict[str, np.ndarray]:
    """Page tables broadcast over ``n_pages`` along the token axis: token
    ``s`` lives in page ``s // page_tokens`` at its per-page offset plus
    the page's bit stride."""
    key = ("kv_full_tabs", page_tokens, n_kv_heads, head_dim, n_pages)
    cached = prog.tables.get(key)
    if cached is not None:
        return cached
    page = page_stream_tables(prog, page_tokens=page_tokens,
                              n_kv_heads=n_kv_heads, head_dim=head_dim)
    stride = page_bit_stride(prog)
    if n_pages * stride > (1 << 32):
        raise ValueError(
            f"{n_pages} pages x {stride} bits exceed the 2^32-bit "
            "addressing range of the uint32 stream tables")
    offs = (np.arange(n_pages, dtype=np.int64) * stride)
    full = {}
    for name, tab in page.items():
        t = tab.astype(np.int64)[None] + offs.reshape(
            (n_pages,) + (1,) * tab.ndim)
        full[name] = t.reshape((n_pages * page_tokens,) + tab.shape[1:]) \
            .astype(np.uint32)
    prog.tables[key] = full
    return full
