"""Compiled execution plans: lower a :class:`Layout` once into flat tables.

Own copy of ``src/repro/core/exec_plan.py`` for the port, trimmed to the
serving path: :func:`lower_exec` and :class:`ExecProgram` (with
``buffer_words32`` and ``stream_bit_offsets``), the host pack
:func:`pack_compiled`, the stream-direct operand tables
(:class:`StreamTables`, :func:`stream_matmul_tables`) and the gather-only
contribution tables :func:`pack_kernel_tables` that the KV-cache append
path derives its write tables from.  The fused-decode slot table
(``KernelTable``) and the host unpack stay in the reference.

Bit conventions: bus cycle = one row of ``m`` bits, element LSB at its
bit offset, rows little-endian in bytes.  The uint64 word views rely on
the host being little-endian.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .layout import Layout

#: Piece widths above this cannot be extracted with one u32 funnel shift.
KERNEL_MAX_WIDTH = 32


@dataclasses.dataclass(eq=False)
class ExecProgram:
    """A lowered layout: flat destination tables plus the pack program.

    All tables are in *global piece order* (arrays concatenated in
    problem order, each array's pieces in element order).
    """

    m: int
    c_max: int
    row_bytes: int
    wpr: int                             # uint64 words per row
    words32: int                         # uint32 words per row
    elem_widths: tuple[int, ...]         # piece width per array
    piece_depths: tuple[int, ...]        # pieces per array
    piece_base: tuple[int, ...]          # prefix sums, len n_arrays + 1
    word: np.ndarray                     # int[P] dest uint64-word index
    shift: np.ndarray                    # uint8[P] bit shift within word
    # pack program: contribution vector cv = [each piece's shifted lo
    # part (piece order), hi parts of word-straddling pieces]; each rank
    # layer ORs every word's (r+1)-th contribution into place
    hi_tabs: tuple[tuple[np.ndarray, np.ndarray], ...]
    hi_base: tuple[int, ...]
    pack_layers: tuple[tuple[np.ndarray, np.ndarray], ...]
    n_contribs: int
    #: memo of tables derived from this program (pack tables, KV append
    #: and read tables), shared by every rebind of the layout
    tables: dict = dataclasses.field(default_factory=dict)

    @property
    def n_pieces(self) -> int:
        return self.piece_base[-1]

    def pack_indexed(self, data: list[np.ndarray]) -> np.ndarray:
        """Pack per-array piece vectors into the ``(c_max, m/8)`` buffer."""
        flat = np.zeros(self.c_max * self.wpr, dtype=np.uint64)
        n = self.n_pieces
        if len(self.pack_layers) == 1 and self.n_contribs == n:
            for i, a in enumerate(data):
                sl = slice(self.piece_base[i], self.piece_base[i + 1])
                flat[self.word[sl]] = a << self.shift[sl]
        else:
            cv = np.empty(self.n_contribs, dtype=np.uint64)
            for i, a in enumerate(data):
                sl = slice(self.piece_base[i], self.piece_base[i + 1])
                np.left_shift(a, self.shift[sl], out=cv[sl])
                loc, shr = self.hi_tabs[i]
                if loc.shape[0]:
                    cv[n + self.hi_base[i]:n + self.hi_base[i + 1]] = \
                        a[loc] >> shr
            sel0, words0 = self.pack_layers[0]
            flat[words0] = cv[sel0]      # rank 0 covers every used word
            for sel, words in self.pack_layers[1:]:
                flat[words] |= cv[sel]
        return flat.view(np.uint8).reshape(
            self.c_max, self.wpr * 8)[:, :self.row_bytes]

    def buffer_words32(self, buf: np.ndarray) -> np.ndarray:
        """(c_max, m/8) uint8 rows -> (c_max, words32) uint32 rows."""
        if buf.shape != (self.c_max, self.row_bytes):
            raise ValueError(
                f"buffer shape {buf.shape} != "
                f"({self.c_max}, {self.row_bytes})"
            )
        padded = np.zeros((self.c_max, self.words32 * 4), dtype=np.uint8)
        padded[:, :self.row_bytes] = np.asarray(buf, dtype=np.uint8)
        return padded.view(np.uint32)

    def stream_bit_offsets(self, i: int) -> np.ndarray:
        """Global bit offset of each of array ``i``'s pieces, in the
        flattened :meth:`buffer_words32` view (uint32, validated against
        the 2^32-bit addressing range)."""
        lo, hi = self.piece_base[i], self.piece_base[i + 1]
        w = self.word[lo:hi].astype(np.int64)
        row, w_in_row = np.divmod(w, self.wpr)
        gbit = (row * (self.words32 * 32)
                + w_in_row * 64 + self.shift[lo:hi].astype(np.int64))
        if gbit.size and int(gbit.max()) + self.elem_widths[i] > (1 << 32):
            raise ValueError(
                "stream exceeds the 2^32-bit addressing range of the "
                "uint32 stream tables"
            )
        return gbit.astype(np.uint32)


@dataclasses.dataclass(eq=False)
class StreamTables:
    """Per-matmul operand tables for the stream-direct kernel.

    ``w_tab[kk, nn]`` / ``s_tab[gg, nn]`` hold the *global bit offset*
    (u32-word view, :meth:`ExecProgram.stream_bit_offsets`) of weight
    code ``(kk, nn)`` and scale ``(gg, nn)`` inside the packed stream.
    """

    bits: int
    group_size: int
    w_tab: np.ndarray            # (K, N) uint32
    s_tab: np.ndarray            # (K // group_size, N) uint32


def stream_matmul_tables(layout: Layout, weights: int | str,
                         shape: tuple[int, int], *,
                         scales: int | str, group_size: int,
                         elem_widths: tuple[int, ...] | None = None,
                         program: ExecProgram | None = None,
                         ) -> StreamTables:
    """Build :class:`StreamTables` for one ``(K, N)`` weight matrix whose
    row-major codes and bf16 scale patterns live in the named arrays."""
    prog = program if program is not None \
        else lower_exec(layout, elem_widths)
    names = [a.name for a in layout.problem.arrays]

    def _resolve(ref) -> int:
        if isinstance(ref, str):
            if ref not in names:
                raise KeyError(f"no array named {ref!r}")
            return names.index(ref)
        return int(ref)

    wi, si = _resolve(weights), _resolve(scales)
    k, n = shape
    bits = prog.elem_widths[wi]
    if bits > KERNEL_MAX_WIDTH:
        raise ValueError(
            f"weight piece width {bits} > {KERNEL_MAX_WIDTH}; "
            "stream-direct extraction is u32-register based"
        )
    if prog.elem_widths[si] != 16:
        raise ValueError(
            f"scale piece width {prog.elem_widths[si]} != 16 (bf16)"
        )
    if k % group_size:
        raise ValueError(f"K={k} not divisible by group_size={group_size}")
    if k * n > prog.piece_depths[wi]:
        raise ValueError(
            f"shape {shape} needs {k * n} weight pieces, array has "
            f"{prog.piece_depths[wi]}"
        )
    g = k // group_size
    if g * n > prog.piece_depths[si]:
        raise ValueError(
            f"shape {shape} needs {g * n} scale pieces, array has "
            f"{prog.piece_depths[si]}"
        )
    w_tab = prog.stream_bit_offsets(wi)[:k * n].reshape(k, n)
    s_tab = prog.stream_bit_offsets(si)[:g * n].reshape(g, n)
    return StreamTables(bits=bits, group_size=group_size,
                        w_tab=w_tab, s_tab=s_tab)


# ----------------------------------------------------------------------
# lowering
# ----------------------------------------------------------------------
def lower_exec(layout: Layout,
               elem_widths: tuple[int, ...] | None = None) -> ExecProgram:
    """Lower ``layout`` into an :class:`ExecProgram` (memoized per layout,
    keyed by the piece widths; ``None`` lowers at element granularity)."""
    prob = layout.problem
    if elem_widths is None:
        key = tuple(a.width for a in prob.arrays)
    else:
        key = tuple(int(w) for w in elem_widths)
        if len(key) != len(prob.arrays):
            raise ValueError(
                f"elem_widths has {len(key)} entries for "
                f"{len(prob.arrays)} arrays"
            )
    cache = layout._exec_cache
    prog = cache.get(key)
    if prog is None:
        prog = _lower(layout, key)
        cache[key] = prog
    return prog


def _lower(layout: Layout, elem_widths: tuple[int, ...]) -> ExecProgram:
    prob = layout.problem
    if prob.m % 8 != 0:
        raise ValueError(f"bus width {prob.m} is not byte-aligned")
    for a, ew in zip(prob.arrays, elem_widths):
        if ew <= 0 or a.width % ew:
            raise ValueError(
                f"{a.name}: piece width {ew} does not divide width {a.width}"
            )
        if ew > 64:
            raise ValueError(
                f"{a.name}: piece width {ew} > 64; lower at a finer "
                "granularity (e.g. the bundle's element width)"
            )
    row_bytes = prob.m // 8
    wpr = -(-row_bytes // 8)
    c_max = layout.c_max
    subs = [a.width // ew for a, ew in zip(prob.arrays, elem_widths)]
    piece_depths = tuple(a.depth * s for a, s in zip(prob.arrays, subs))
    piece_base = (0, *np.cumsum(piece_depths).tolist())
    n_pieces = piece_base[-1]

    word = np.empty(n_pieces, dtype=np.int64)
    shift = np.empty(n_pieces, dtype=np.uint8)
    for iv in layout.intervals():
        rows = np.arange(iv.start_cycle, iv.start_cycle + iv.n_cycles)
        for (a, off, n), base in zip(iv.slots, iv.elem_base):
            w_elem, ew, s = prob.arrays[a].width, elem_widths[a], subs[a]
            # piece (c, k, j): cycle c, lane k, sub-element j
            c = np.arange(iv.n_cycles)[:, None, None]
            k = np.arange(n)[None, :, None]
            j = np.arange(s)[None, None, :]
            pid = piece_base[a] + (base + c * n + k) * s + j
            bits = off + k * w_elem + j * ew          # (1, n, s)
            word[pid] = rows[:, None, None] * wpr + (bits >> 6)
            shift[pid] = (bits & 63).astype(np.uint8)

    ewv = np.empty(n_pieces, dtype=np.int64)
    for i, ew in enumerate(elem_widths):
        ewv[piece_base[i]:piece_base[i + 1]] = ew
    hi_sel = np.flatnonzero(shift.astype(np.int64) + ewv > 64)

    # contribution order: [lo (piece order), hi (piece order)]; sort by
    # destination word and group by rank within each word
    cw = np.concatenate([word, word[hi_sel] + 1])
    n_contribs = cw.shape[0]
    perm = np.argsort(cw, kind="stable")
    sw = cw[perm]
    new_seg = np.concatenate([[True], sw[1:] != sw[:-1]])
    seg_starts = np.flatnonzero(new_seg)
    rank = np.arange(n_contribs) - seg_starts[np.cumsum(new_seg) - 1]
    n_words = c_max * wpr
    idx_t = np.int32 \
        if max(n_words, n_contribs) < (1 << 31) else np.int64
    layers = []
    for r in range(int(rank.max()) + 1 if rank.size else 0):
        sel = rank == r
        layers.append((perm[sel].astype(idx_t), sw[sel].astype(idx_t)))
    hi_tabs = []
    hi_base = [0]
    for i in range(len(prob.arrays)):
        mask = (hi_sel >= piece_base[i]) & (hi_sel < piece_base[i + 1])
        loc = (hi_sel[mask] - piece_base[i]).astype(idx_t)
        shr = (64 - shift[hi_sel[mask]].astype(np.int64)).astype(np.uint8)
        hi_tabs.append((loc, shr))
        hi_base.append(hi_base[-1] + loc.shape[0])

    return ExecProgram(
        m=prob.m, c_max=c_max, row_bytes=row_bytes, wpr=wpr,
        words32=-(-row_bytes // 4),
        elem_widths=elem_widths, piece_depths=piece_depths,
        piece_base=piece_base, word=word.astype(idx_t),
        shift=shift, hi_tabs=tuple(hi_tabs), hi_base=tuple(hi_base),
        pack_layers=tuple(layers), n_contribs=n_contribs,
    )


def pack_compiled(layout: Layout, arrays: dict[str, np.ndarray], *,
                  elem_widths: tuple[int, ...] | None = None,
                  program: ExecProgram | None = None) -> np.ndarray:
    """Vectorized host pack of per-array piece codes into the unified
    ``(c_max, m/8)`` uint8 buffer."""
    prog = program if program is not None \
        else lower_exec(layout, elem_widths)
    data: list[np.ndarray] = []
    for i, spec in enumerate(layout.problem.arrays):
        if spec.name not in arrays:
            raise KeyError(f"missing array {spec.name!r}")
        a = np.asarray(arrays[spec.name]).reshape(-1)
        if a.dtype != np.uint64:
            a = a.astype(np.uint64)
        if a.shape[0] != prog.piece_depths[i]:
            raise ValueError(
                f"{spec.name}: expected {prog.piece_depths[i]} elements, "
                f"got {a.shape[0]}"
            )
        ew = prog.elem_widths[i]
        if ew < 64 and (a >> np.uint64(ew)).any():
            raise ValueError(f"{spec.name}: codes overflow {ew} bits")
        data.append(a)
    return prog.pack_indexed(data)


def pack_kernel_tables(prog: ExecProgram,
                       ) -> tuple[np.ndarray, np.ndarray, int]:
    """Gather-only contribution tables over the u32 word view.

    For every destination u32 word (``words32`` per row) the <= K source
    pieces (arrays with piece width <= 32) that contribute to it and the
    shift each needs.  Returns ``(src, scode, K)``: ``(c_max,
    words32 * K)`` int32 tables, ``src`` indexing a flat piece-order
    vector with a zero sentinel at index 0 (piece ``p`` stored as
    ``p + 1``), ``scode >= 0`` shift left, ``< 0`` shift right (the hi
    part of a u32-straddling piece).  Memoized on the program.
    """
    key = ("pack_tables",)
    cached = prog.tables.get(key)
    if cached is not None:
        return cached
    w32 = prog.words32
    kernel_arrays = [i for i, ew in enumerate(prog.elem_widths)
                     if ew <= KERNEL_MAX_WIDTH]
    if not kernel_arrays:
        empty = (np.zeros((prog.c_max, 0), dtype=np.int32),
                 np.zeros((prog.c_max, 0), dtype=np.int32), 1)
        prog.tables[key] = empty
        return empty
    ids = np.concatenate([
        np.arange(prog.piece_base[i], prog.piece_base[i + 1])
        for i in kernel_arrays])
    word = prog.word[ids].astype(np.int64)
    rows = word // prog.wpr
    bit = (word - rows * prog.wpr) * 64 + prog.shift[ids].astype(np.int64)
    widths = np.empty(ids.shape[0], dtype=np.int64)
    for i in kernel_arrays:
        sel = (ids >= prog.piece_base[i]) & (ids < prog.piece_base[i + 1])
        widths[sel] = prog.elem_widths[i]
    w0 = bit >> 5
    sh = bit & 31
    strad = sh + widths > 32
    gw = np.concatenate([rows * w32 + w0, (rows * w32 + w0 + 1)[strad]])
    src = np.concatenate([ids, ids[strad]])
    sc = np.concatenate([sh, sh[strad] - 32])
    order = np.argsort(gw, kind="stable")
    gw, src, sc = gw[order], src[order], sc[order]
    new_seg = np.concatenate([[True], gw[1:] != gw[:-1]])
    seg_starts = np.flatnonzero(new_seg)
    rank = np.arange(gw.shape[0]) - seg_starts[np.cumsum(new_seg) - 1]
    k = int(rank.max()) + 1 if rank.size else 1
    src_t = np.zeros(prog.c_max * w32 * k, dtype=np.int32)
    sc_t = np.zeros(prog.c_max * w32 * k, dtype=np.int32)
    src_t[gw * k + rank] = src + 1          # 0 = empty slot sentinel
    sc_t[gw * k + rank] = sc
    tables = (src_t.reshape(prog.c_max, w32 * k),
              sc_t.reshape(prog.c_max, w32 * k), k)
    prog.tables[key] = tables
    return tables
