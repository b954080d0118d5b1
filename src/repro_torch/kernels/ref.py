"""Plain PyTorch versions of the port's kernels, and the word type.

Own port of ``src/repro/kernels/ref.py``: the funnel-shift
:func:`extract`, :func:`stream_matmul_ref` and :func:`packed_matmul_ref`
(both keeping the reference's K-block accumulation order),
:func:`stream_kv_ref`, the plain versions of the layout kernels:
:func:`decode_fused_ref` (one ``(row, lane)`` slot-table entry at a
time), :func:`decode_pieces_ref` (one piece descriptor at a time),
:func:`decode_slot_ref`, :func:`decode_units_ref` (every unit of a
decode plan), :func:`pack_fused_ref` (gather, shift
and OR over the K contributions of each word) and :func:`pack_runs_plain`
(every piece of a run table shifted into its words), and
:func:`ssd_scan_plain`
(the chunked closed form of ``src/repro/kernels/linear_scan.py:42-70``).  They run on any device;
the kernel wrappers call them only for CPU tensors, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.

**Word type.**  PyTorch on the CPU has no shifts or comparisons for
``torch.uint32``, and ``int32 >>`` sign-extends.  So packed stream and
page words, and the uint32 bit-offset tables, are stored as
``torch.int32`` tensors holding the same bits (numpy ``.view(np.int32)``).
The plain versions widen them to int64 and mask with ``& 0xFFFFFFFF``;
the CUDA kernels reinterpret them as ``const uint32_t*``.  Bit-offset
tables must stay below 2^31 (one layer's int3 stream is ~12.4 Mbit):
:func:`table_tensor` checks this.
"""
from __future__ import annotations

import numpy as np
import torch

U32 = 0xFFFFFFFF


def words_tensor(words_u32: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy words -> int32 tensor with the same bits."""
    arr = np.ascontiguousarray(words_u32, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(arr.copy()).to(device)


def table_tensor(tab_u32: np.ndarray, device) -> torch.Tensor:
    """uint32 bit-offset table -> int32 tensor; raises if an offset does
    not fit int32 (the kernels index with signed 32-bit offsets)."""
    tab = np.asarray(tab_u32, dtype=np.uint32)
    if tab.size and int(tab.max()) >= (1 << 31):
        raise ValueError(
            f"bit offset {int(tab.max())} does not fit int32: the stream "
            "is too long for the port's int32 offset tables")
    return torch.from_numpy(np.ascontiguousarray(tab).view(np.int32)
                            .copy()).to(device)


def to_int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same low bits."""
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def bf16_bits_to_f32(pat: torch.Tensor) -> torch.Tensor:
    """bf16 bit patterns (int64 in [0, 2^16)) -> their f32 values."""
    return to_int32_bits(pat << 16).view(torch.float32)


def extract(words: torch.Tensor, tab: torch.Tensor, width: int
            ) -> torch.Tensor:
    """Funnel-shift ``width``-bit fields out of int32-stored u32 words.

    ``words``: ``(W,)`` or ``(B, W)`` (the gather runs per row); ``tab``:
    global bit offsets of any shape.  Returns int64 fields of shape
    ``tab.shape`` (or ``(B,) + tab.shape``).  The second word read is
    clamped to the last word; its bits land above ``width`` there.
    """
    flat = words.to(torch.int64) & U32
    t = tab.reshape(-1).to(torch.int64) & U32
    wi = t >> 5
    sh = t & 31
    last = flat.shape[-1] - 1
    lo = flat[..., wi] >> sh
    hi = flat[..., torch.clamp(wi + 1, max=last)] << ((32 - sh) & 63)
    v = torch.where(sh > 0, lo | hi, lo) & ((1 << width) - 1)
    return v.reshape(flat.shape[:-1] + tab.shape)


def _dequant_dot(x: torch.Tensor, codes: torch.Tensor,
                 scales: torch.Tensor, *, bits: int, group_size: int,
                 block_k: int) -> torch.Tensor:
    """``x @ ((codes - 2^(bits-1)) * scales)`` with (K, N) codes and
    (K / group_size, N) f32 scales, accumulated over K blocks of
    ``block_k`` in order (the reference kernels' K-grid order)."""
    k, n = codes.shape
    wq = codes.to(torch.float32) - float(1 << (bits - 1))
    wf = (wq.reshape(k // group_size, group_size, n)
          * scales[:, None, :]).reshape(k, n)
    bk = min(block_k, k)
    bk = -(-bk // group_size) * group_size
    xf = x.to(torch.float32)
    acc = torch.zeros((x.shape[0], n), dtype=torch.float32, device=x.device)
    for kk in range(0, k, bk):
        acc = acc + xf[:, kk:kk + bk] @ wf[kk:kk + bk]
    return acc


def stream_matmul_ref(x: torch.Tensor, words: torch.Tensor,
                      w_tab: torch.Tensor, s_tab: torch.Tensor, *,
                      bits: int, group_size: int,
                      block_k: int = 512) -> torch.Tensor:
    """Plain version of ``stream_matmul``: table decode, dequantize, then
    a dot accumulated over K blocks of ``block_k`` in order."""
    codes = extract(words, w_tab, bits)
    scales = bf16_bits_to_f32(extract(words, s_tab, 16))
    return _dequant_dot(x, codes, scales, bits=bits, group_size=group_size,
                        block_k=block_k)


def unpack_lanes(w_packed: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., K / lanes, N) int32-stored lane-packed u32 words -> (..., K, N)
    int64 codes, lanes = 32 / bits (lane ``l`` of word ``r`` is code
    ``r * lanes + l``, LSB first)."""
    lanes = 32 // bits
    w = w_packed.to(torch.int64) & U32
    shifts = torch.arange(lanes, device=w.device).reshape(lanes, 1) * bits
    codes = (w.unsqueeze(-2) >> shifts) & ((1 << bits) - 1)
    *lead, kw, _, n = codes.shape
    return codes.reshape(*lead, kw * lanes, n)


def packed_matmul_ref(x: torch.Tensor, w_packed: torch.Tensor,
                      scales: torch.Tensor, *, bits: int, group_size: int,
                      block_k: int = 512) -> torch.Tensor:
    """Plain version of ``packed_matmul``: unpack the lane-packed codes,
    dequantize with the group scales, then the same K-blocked dot as
    :func:`stream_matmul_ref` (so the two paths agree bit for bit)."""
    return _dequant_dot(x, unpack_lanes(w_packed, bits),
                        scales.to(torch.float32), bits=bits,
                        group_size=group_size, block_k=block_k)


def decode_fused_ref(words: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """Plain version of the fused decode kernel.

    ``words``: ``(R, W)`` int32-stored u32 bus rows; ``tab``: ``(R, L)``
    slot table, ``bit_offset | width << 20`` per ``(row, lane)`` (0 = an
    empty lane).  Each entry funnel-shifts its field out of two words of
    its own row (the second clamped to the row's last word) and masks it
    to ``width`` bits.  Returns the ``(R, L)`` int32-stored u32 grid.
    """
    x = words.to(torch.int64) & U32
    t = tab.to(torch.int64) & U32
    off = t & ((1 << 20) - 1)
    width = t >> 20
    w0 = off >> 5
    sh = off & 31
    lo = torch.gather(x, 1, w0)
    hi = torch.gather(x, 1, torch.clamp(w0 + 1, max=x.shape[1] - 1))
    v = (lo >> sh) | torch.where(sh > 0, hi << (32 - sh),
                                 torch.zeros_like(hi))
    return to_int32_bits(v & ((1 << width) - 1))


def decode_slot_ref(rows: torch.Tensor, offsets: torch.Tensor,
                    width: int) -> torch.Tensor:
    """Plain version of ``decode_slot``: ``len(offsets)`` fields of
    ``width`` bits at fixed bit offsets from each of the ``(n_rows, W)``
    int32-stored u32 rows.  Returns ``(n_rows * lanes,)`` int32 codes in
    stream order (row-major)."""
    x = rows.to(torch.int64) & U32
    off = offsets.to(device=x.device, dtype=torch.int64)
    w0 = off >> 5
    sh = off & 31
    lo = x[:, w0] >> sh
    hi = x[:, torch.clamp(w0 + 1, max=x.shape[1] - 1)] << (32 - sh)
    v = torch.where((sh > 0) & (sh + width > 32), lo | hi, lo)
    return to_int32_bits(v & ((1 << width) - 1)).reshape(-1)


def _row_fields(x: torch.Tensor, row: torch.Tensor, off: torch.Tensor,
                width: torch.Tensor) -> torch.Tensor:
    """Fields of per-field ``width`` (0-32) at bit ``off`` of row ``row``
    of the ``(R, W)`` int64 words ``x``, as ``extract_bits`` takes them:
    word indices clamped to the row's last word, bits above ``width``
    dropped."""
    last = x.shape[1] - 1
    w0 = torch.clamp(off >> 5, max=last)
    sh = off & 31
    lo = x[row, w0] >> sh
    hi = x[row, torch.clamp(w0 + 1, max=last)] << ((32 - sh) & 63)
    v = torch.where(sh > 0, lo | hi, lo)
    return v & ((1 << width) - 1)


def decode_pieces_ref(words: torch.Tensor, desc: torch.Tensor
                      ) -> torch.Tensor:
    """Plain version of the direct fused decode kernel.

    ``words``: the ``(R, W)`` int32-stored u32 bus rows; ``desc``: one
    descriptor per piece, ``global bit offset << 6 | (width - 1)`` with
    the offset into the flattened rows and a width of 1-64, as int32
    holding u32 bits or as int64.  A piece wider than 32 bits is its low
    32 bits at the offset and the rest 32 bits further on.  Returns the
    ``(P,)`` int64 pieces (a 64-bit piece keeps its top bit in the
    sign).
    """
    x = (words.to(torch.int64) & U32).reshape(1, -1)
    d = desc.to(torch.int64)
    if desc.dtype == torch.int32:
        d = d & U32
    off, width = d >> 6, (d & 63) + 1
    row = torch.zeros_like(off)
    lo = _row_fields(x, row, off, torch.clamp(width, max=32))
    hi = _row_fields(x, row, off + 32, torch.clamp(width - 32, min=0))
    return lo | (hi << 32)


def decode_units_ref(words: torch.Tensor, units: torch.Tensor,
                     prefix: torch.Tensor, n_out: int) -> torch.Tensor:
    """Plain version of the whole-plan per-slot decode kernel.

    ``words``: ``(R, W)`` int32-stored u32 bus rows; ``units``: ``(U,
    8)`` int32 rows ``(row0, lanes, first, pitch, width, kind, base,
    n_cycles)``; ``prefix``: the ``(U + 1,)`` prefix sums of the units' field
    counts.  Field ``j`` of a unit is lane ``j % lanes`` of row ``row0 +
    j // lanes``, ``width`` bits at ``first + lane * pitch``: kind 0
    stores it as element ``base + j`` of the int64 output, kind 1 / 2 as
    that element's low / high u32 word.  Elements no unit covers read 0.
    """
    out = torch.zeros(n_out, dtype=torch.int64, device=words.device)
    n_fields = int(prefix[-1])
    if n_fields == 0:
        return out
    x = words.to(torch.int64) & U32
    u, p = units.to(torch.int64), prefix.to(torch.int64)
    uid = torch.repeat_interleave(
        torch.arange(u.shape[0], device=words.device), p.diff())
    j = torch.arange(n_fields, device=words.device) - p[uid]
    lanes = u[uid, 1]
    r = j // lanes
    off = u[uid, 2] + (j - r * lanes) * u[uid, 3]
    v = _row_fields(x, u[uid, 0] + r, off, u[uid, 4])
    kind, elem = u[uid, 5], u[uid, 6] + j
    whole = kind == 0
    out[elem[whole]] = v[whole]
    out32 = out.view(torch.int32)
    half = ~whole
    out32[2 * elem[half] + kind[half] - 1] = to_int32_bits(v[half])
    return out


def pack_fused_ref(flat: torch.Tensor, src: torch.Tensor,
                   scode: torch.Tensor) -> torch.Tensor:
    """Plain version of the fused pack kernel.

    ``flat``: ``(P + 1,)`` int32-stored u32 pieces with a 0 sentinel at
    index 0; ``src`` / ``scode``: ``(K, n_words)`` int32, the k-th
    contribution to each destination word (source index into ``flat``;
    shift left by ``scode >= 0``, right by ``-scode``).  Returns the
    ``(n_words,)`` int32-stored u32 words: the OR over the K shifted
    pieces.
    """
    v = flat.to(torch.int64)[src.to(torch.int64)] & U32
    c = scode.to(torch.int64)
    parts = torch.where(c >= 0, v << c.clamp(min=0),
                        v >> (-c).clamp(min=0)) & U32
    out = torch.zeros(src.shape[1:], dtype=torch.int64, device=src.device)
    for part in parts:
        out |= part
    return to_int32_bits(out)


def pack_runs_plain(runs: torch.Tensor, streams: list[torch.Tensor],
                    n_rows: int, words32: int) -> torch.Tensor:
    """Plain version of the run-table pack kernel.

    ``runs``: ``(R, 6)`` int32 rows ``(array, first piece, row, first bit,
    width, count)``: ``count`` consecutive pieces of ``streams[array]``
    from its element ``first`` on, each ``width`` (1-64) bits, side by
    side in bus row ``row`` from bit ``first bit`` on.  A piece is its
    element as ``.to(torch.int64)`` gives it, masked to its width; an
    element index past its stream's end reads 0.  Returns the ``(n_rows,
    words32)`` int32-stored u32 rows: the OR of every piece shifted into
    place.
    """
    dev = runs.device
    out = torch.zeros(n_rows * words32, dtype=torch.int64, device=dev)
    r = runs.to(torch.int64)
    counts = r[:, 5]
    total = int(counts.sum()) if r.shape[0] else 0
    if total == 0:
        return to_int32_bits(out).reshape(n_rows, words32)
    rid = torch.repeat_interleave(torch.arange(r.shape[0], device=dev),
                                  counts)
    k = torch.arange(total, device=dev) - (counts.cumsum(0) - counts)[rid]
    arr, idx, width = r[rid, 0], r[rid, 1] + k, r[rid, 4]
    gbit = r[rid, 2] * (words32 * 32) + r[rid, 3] + k * width
    v = torch.zeros(total, dtype=torch.int64, device=dev)
    for i, s in enumerate(streams):
        s = s.reshape(-1).to(device=dev, dtype=torch.int64)
        sel = torch.nonzero((arr == i) & (idx < s.shape[0])).reshape(-1)
        v[sel] = s[idx[sel]]
    v &= torch.where(width >= 64, -1, (1 << width.clamp(max=63)) - 1)
    # as two u32 fields: the low 32 bits at the piece's bit, the rest 32
    # bits further on; each field lands in one word or straddles two
    field = torch.cat([v & U32, (v >> 32) & U32])
    at = torch.cat([gbit, gbit + 32])
    sh = at & 31
    dest = torch.cat([at >> 5, (at >> 5) + 1])
    part = torch.cat([(field << sh) & U32,
                      torch.where(sh > 0, field >> (32 - sh), 0)])
    keep = part != 0
    dest, part = dest[keep], part[keep]
    # OR the parts of each word together, one rank of the word at a time
    dest, order = torch.sort(dest, stable=True)
    part = part[order]
    first = torch.ones_like(dest, dtype=torch.bool)
    first[1:] = dest[1:] != dest[:-1]
    starts = torch.nonzero(first).reshape(-1)
    rank = torch.arange(dest.shape[0], device=dev) \
        - starts[torch.cumsum(first, 0) - 1]
    for j in range(int(rank.max()) + 1 if rank.numel() else 0):
        sel = rank == j
        out[dest[sel]] |= part[sel]
    return to_int32_bits(out).reshape(n_rows, words32)


def dequant_fields(codes: torch.Tensor, sc16: torch.Tensor, bits: int
                   ) -> torch.Tensor:
    """``(codes - 2^(bits-1)) * bf16(scale)`` with one scale per vector
    (the last dimension of ``codes``)."""
    bias = float(1 << (bits - 1))
    return (codes.to(torch.float32) - bias) * bf16_bits_to_f32(sc16)[..., None]


def stream_kv_ref(words: torch.Tensor, tabs: dict, *, bits: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dequantized f32 K and V from packed KV page words.

    ``words``: one slot's ``(W,)`` words or ``(B, W)`` rows; ``tabs``: the
    full-sequence tables (``k``/``v``: ``(smax, Hkv, hd)``, scales
    ``(smax, Hkv)``) as int32 tensors.  Returns ``(..., smax, Hkv, hd)``.
    """
    def one(code_tab, scale_tab):
        return dequant_fields(extract(words, code_tab, bits),
                              extract(words, scale_tab, 16), bits)

    return (one(tabs["k"], tabs["k_scales"]),
            one(tabs["v"], tabs["v_scales"]))


def ssd_scan_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   logw: torch.Tensor, *, chunk: int = 128,
                   state0: torch.Tensor | None = None,
                   return_state: bool = False):
    """The scalar-decay linear-attention scan in the chunked closed form
    of the reference's ``_ssd_kernel``, all (batch, head) pairs at once,
    chunk after chunk, in f32.  Per C-token chunk, with
    ``L = cumsum(logw)``::

        o     = (q * e^L) @ S_in + tril(q k^T * e^{L_t - L_i}) @ v
        S_out = e^{L_C} S_in + (k * e^{L_C - L})^T @ v

    The exponent is masked to ``-inf`` above the diagonal *before* the
    exponential (the reference masks after it, where ``e^{L_t - L_i}``
    with ``i > t`` can overflow).  T is padded to a multiple of ``chunk``
    with zero q/k/v and zero ``logw`` (decay 1: the state is unchanged),
    and the output sliced back.

    q/k: (B, T, H, dk), v: (B, T, H, dv), logw: (B, T, H) (<= 0),
    state0: (B, H, dk, dv) or None (zeros).  Returns out (B, T, H, dv) in
    q's dtype, and with ``return_state`` also the final state (B, H, dk,
    dv) f32.
    """
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    pad = -t % chunk
    f32 = torch.float32

    def heads(a):                                   # (B, H, Tp, d)
        a = a.to(f32).transpose(1, 2)
        return torch.nn.functional.pad(a, (0, 0, 0, pad)) if pad else a

    qh, kh, vh = heads(q), heads(k), heads(v)
    wh = torch.nn.functional.pad(logw.to(f32).transpose(1, 2), (0, pad))
    s = torch.zeros((b, h, dk, dv), dtype=f32, device=q.device) \
        if state0 is None else state0.to(f32)
    keep = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=q.device).tril()
    outs = []
    for c0 in range(0, t + pad, chunk):
        qc, kc = qh[:, :, c0:c0 + chunk], kh[:, :, c0:c0 + chunk]
        vc = vh[:, :, c0:c0 + chunk]
        el = torch.cumsum(wh[:, :, c0:c0 + chunk], dim=-1)   # (B, H, C)
        o = (qc * torch.exp(el)[..., None]) @ s
        diff = torch.where(keep, el[..., :, None] - el[..., None, :],
                           -torch.inf)
        o = o + ((qc @ kc.transpose(-1, -2)) * torch.exp(diff)) @ vc
        outs.append(o)
        last = el[..., -1:]
        s = torch.exp(last)[..., None] * s + (
            kc * torch.exp(last - el)[..., None]).transpose(-1, -2) @ vc
    out = torch.cat(outs, dim=2)[:, :, :t].transpose(1, 2).to(q.dtype)
    return (out, s) if return_state else out
