"""PackedKVCache: a mutable Iris-planned KV stream in PyTorch.

Port of ``src/repro/kvcache/cache.py``.  Storage is one int32 tensor
``pages[n_layers, n_slots, n_pages, c_max, words32]`` holding the u32
page words (see ``kernels/ref.py`` on the word type); each
``(c_max, words32)`` block is one token page packed with the per-page
layout of :mod:`repro_torch.kvcache.layout`.  :class:`KVManifest` has the
reference's JSON.

``append`` is plain torch ops (it is not a Pallas kernel in the
reference either): quantize, place the token's codes in a sparse piece
vector, gather/shift/OR them through the token-masked append tables, and
read-modify-write ``new = (old & ~mask) | value``.  Where the reference
rebuilds the whole page buffer functionally (``pages.at[layer].set``),
the port writes ``pages[layer, slot_ids, page]`` **in place**: ``append``,
``reset`` and ``evict`` mutate this cache and return it.  ``verify``
runs the static analyzer's KV-cache passes on a host copy of the pages.
"""
from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import torch

from ..core.exec_plan import lower_exec
from ..core.iris import DEFAULT_CACHE, schedule
from ..device import resolve_device
from ..kernels.ref import (
    U32,
    dequant_fields,
    stream_kv_ref,
    table_tensor,
    to_int32_bits,
)
from ..plan import BundleTensor, bundle_problem
from .layout import append_tables, full_stream_tables, plan_kv_stack

__all__ = ["KVManifest", "PackedKVCache", "quantize_kv", "dequantize_kv"]


def quantize_kv(x: torch.Tensor, bits: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``x: (..., head_dim)`` float -> (codes int64, bf16 scale pattern
    int64): symmetric per head vector, biased codes, amax/qmax scale in
    f32 stored as bf16.  Bit for bit the reference's arithmetic as its
    decode step runs it (eagerly, so ``amax / qmax`` is a true division,
    unlike the jitted weight quantizer in :mod:`repro_torch.quant`)."""
    qmax = float(2 ** (bits - 1) - 1)
    bias = float(2 ** (bits - 1))
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -qmax, qmax)
    codes = (q + bias).to(torch.int64)
    sc16 = scale.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF
    return codes, sc16


def dequantize_kv(codes: torch.Tensor, sc16: torch.Tensor, bits: int
                  ) -> torch.Tensor:
    """Inverse of :func:`quantize_kv` against the *stored* bf16 scale."""
    return dequant_fields(codes, sc16, bits)


def signature_string(problem) -> str:
    """JSON-canonical form of ``problem.canonical_signature()``."""
    return json.dumps(problem.canonical_signature())


@dataclasses.dataclass(frozen=True)
class KVManifest:
    """Frozen description of a packed KV cache: geometry + layout identity
    (the reference's ``KVManifest``, same JSON)."""

    bits: int
    page_tokens: int
    n_kv_heads: int
    head_dim: int
    n_layers: int
    n_slots: int
    n_pages: int
    m: int
    mode: str
    c_max: int
    row_bytes: int
    words32: int
    bundle: tuple[tuple[str, int, int, int], ...]
    signature: str

    @property
    def smax(self) -> int:
        return self.n_pages * self.page_tokens

    def bundle_tensors(self) -> list[BundleTensor]:
        return [BundleTensor(*t) for t in self.bundle]

    def elem_widths(self) -> tuple[int, ...]:
        return tuple(t[1] for t in self.bundle)

    def logical(self) -> tuple[int, ...]:
        return tuple(t[2] for t in self.bundle)

    def problem(self):
        return bundle_problem(self.bundle_tensors(), m=self.m)

    def resolve_layout(self, cache=DEFAULT_CACHE):
        """(layout, provenance) — cache hit or verified scheduler rerun."""
        prob = self.problem()
        if signature_string(prob) != self.signature:
            raise ValueError(
                "KV manifest signature mismatch: the manifest does not "
                "describe this scheduling instance")
        if cache is not None:
            lay = cache.lookup(prob)
            if lay is not None:
                return lay, "cache-hit"
        lay = schedule(prob, mode=self.mode, cache=None)
        if cache is not None:
            cache.insert(prob, False, lay)
        return lay, "manifest"

    def to_json_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["bundle"] = [list(t) for t in self.bundle]
        return d

    @classmethod
    def from_json_dict(cls, d: dict) -> "KVManifest":
        d = dict(d)
        d["bundle"] = tuple(
            (str(n), int(w), int(e), int(s)) for n, w, e, s in d["bundle"])
        for k in ("bits", "page_tokens", "n_kv_heads", "head_dim",
                  "n_layers", "n_slots", "n_pages", "m", "c_max",
                  "row_bytes", "words32"):
            d[k] = int(d[k])
        return cls(**d)


class PackedKVCache:
    """Paged Iris-packed KV cache for ``n_slots`` continuous-batching rows."""

    def __init__(self, pages: torch.Tensor, manifest: KVManifest,
                 provenance: str = "created") -> None:
        self.pages = pages
        self.manifest = manifest
        self.provenance = provenance
        self._layout = None
        self._program = None
        self._dev: dict = {}
        self.plan_stats: dict[str, int] = {}

    @classmethod
    def create(cls, cfg, *, bits: int, page_tokens: int, n_slots: int,
               max_seq: int, n_layers: int | None = None, m: int = 512,
               mode: str = "auto", cache=None,
               device=None) -> "PackedKVCache":
        """Plan (through the shared layer-stack planner) and allocate
        zeroed pages on ``device`` (``"cuda"`` unless given)."""
        device = resolve_device(device)
        stack = plan_kv_stack(cfg, bits=bits, page_tokens=page_tokens,
                              n_layers=n_layers, m=m, mode=mode,
                              cache=cache)
        prog = stack.exec_program()
        nl = stack.n_layers
        n_pages = max(1, math.ceil(max_seq / page_tokens))
        manifest = KVManifest(
            bits=bits, page_tokens=page_tokens,
            n_kv_heads=int(cfg.n_kv_heads), head_dim=int(cfg.head_dim),
            n_layers=nl, n_slots=int(n_slots), n_pages=int(n_pages),
            m=int(m), mode=str(mode), c_max=int(prog.c_max),
            row_bytes=int(prog.row_bytes), words32=int(prog.words32),
            bundle=tuple((b.name, b.width_bits, b.n_elems, b.stage)
                         for b in stack.bundle),
            signature=signature_string(stack.problem),
        )
        pages = torch.zeros((nl, n_slots, n_pages, prog.c_max,
                             prog.words32), dtype=torch.int32, device=device)
        obj = cls(pages, manifest, provenance=stack.provenance)
        obj._layout = stack.layout
        obj._program = prog
        obj.plan_stats = {"scheduler_runs": stack.scheduler_runs,
                          "cache_hits": stack.cache_hits}
        return obj

    # -- lazy layout / program ------------------------------------------
    @property
    def layout(self):
        if self._layout is None:
            self._layout, self.provenance = self.manifest.resolve_layout()
        return self._layout

    def program(self):
        if self._program is None:
            self._program = lower_exec(self.layout,
                                       self.manifest.elem_widths())
        return self._program

    # -- geometry -------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.pages.device

    @property
    def n_slots(self) -> int:
        return self.manifest.n_slots

    @property
    def smax(self) -> int:
        return self.manifest.smax

    @property
    def bits(self) -> int:
        return self.manifest.bits

    # -- write path -----------------------------------------------------
    def _append_tables(self) -> dict:
        """The append tables as device tensors (built once per cache)."""
        dev = self._dev.get("append")
        if dev is None:
            man = self.manifest
            tabs = append_tables(self.program(), page_tokens=man.page_tokens,
                                 logical=man.logical())
            scode = tabs.scode.astype(np.int64)

            def put(a):
                return torch.from_numpy(np.ascontiguousarray(
                    a, dtype=np.int64)).to(self.device)

            dev = {"K": tabs.K, "shape": tabs.src.shape,
                   "base": tabs.piece_base, "per_tok": tabs.per_token,
                   "src": put(tabs.src.reshape(-1)),
                   "sl": put(np.maximum(scode, 0)),
                   "sr": put(np.maximum(-scode, 0)),
                   "left": torch.from_numpy(scode >= 0).to(self.device),
                   "tok": put(tabs.tok),
                   "maskbits": put(tabs.maskbits)}
            self._dev["append"] = dev
        return dev

    def append(self, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor,
               slot_ids: torch.Tensor, *, layer: int) -> "PackedKVCache":
        """Write one token per active slot into layer ``layer``, in place.

        ``k`` / ``v``: ``(b, n_kv_heads, head_dim)`` float (post-rope);
        ``pos``: ``(b,)`` positions being written; ``slot_ids``: ``(b,)``
        distinct cache rows.  The planner is never consulted.
        """
        man = self.manifest
        t = self._append_tables()
        kcodes, ks16 = quantize_kv(k, man.bits)
        vcodes, vs16 = quantize_kv(v, man.bits)
        b = kcodes.shape[0]
        pos = pos.to(device=self.device, dtype=torch.int64)
        slot_ids = slot_ids.to(device=self.device, dtype=torch.int64)
        t_in = pos % man.page_tokens
        page = pos // man.page_tokens
        n_flat = self.program().n_pieces + 1
        flat = torch.zeros((b, n_flat), dtype=torch.int64, device=self.device)
        for ai, vals in enumerate((kcodes, ks16, vcodes, vs16)):
            per = t["per_tok"][ai]
            start = 1 + t["base"][ai] + t_in * per
            idx = start[:, None] + torch.arange(per, device=self.device)
            flat.scatter_(1, idx, vals.reshape(b, -1))
        vals = flat[:, t["src"]].reshape((b,) + t["shape"])
        shifted = torch.where(t["left"], (vals << t["sl"]) & U32,
                              vals >> t["sr"])
        sel = t["tok"][None] == t_in[:, None, None, None]
        contrib = torch.where(sel, shifted, 0)
        maskc = torch.where(sel, t["maskbits"][None], 0)
        value = contrib[..., 0]
        mask = maskc[..., 0]
        for j in range(1, t["K"]):                     # K is tiny
            value = value | contrib[..., j]
            mask = mask | maskc[..., j]
        old = self.pages[layer, slot_ids, page].to(torch.int64) & U32
        new = (old & ~mask) | value
        self.pages[layer, slot_ids, page] = to_int32_bits(new)
        return self

    # -- slot lifecycle -------------------------------------------------
    def reset(self, slot_ids) -> "PackedKVCache":
        """Zero the given slot(s) across every layer and page, in place."""
        slots = torch.atleast_1d(torch.as_tensor(slot_ids, dtype=torch.int64))
        self.pages[:, slots.to(self.device)] = 0
        return self

    def evict(self, slot_ids) -> "PackedKVCache":
        """Continuous-batching eviction: alias of :meth:`reset`."""
        return self.reset(slot_ids)

    # -- read path ------------------------------------------------------
    def layer_words(self, layer: int) -> torch.Tensor:
        """Layer ``layer``'s pages as a ``(n_slots, W)`` view (no copy)."""
        return self.pages[layer].reshape(self.n_slots, -1)

    def slot_words(self, layer: int, slot_ids=None) -> torch.Tensor:
        """Flat word stream per selected slot: ``(b, W)``."""
        words = self.layer_words(layer)
        if slot_ids is not None:
            words = words[torch.as_tensor(slot_ids, device=self.device)
                          .to(torch.int64)]
        return words

    def stream_tables(self) -> dict[str, np.ndarray]:
        """Full-sequence bit-offset tables over a slot's pages (uint32)."""
        man = self.manifest
        return full_stream_tables(
            self.program(), page_tokens=man.page_tokens,
            n_kv_heads=man.n_kv_heads, head_dim=man.head_dim,
            n_pages=man.n_pages)

    def device_stream_tables(self) -> dict[str, torch.Tensor]:
        """:meth:`stream_tables` as int32 tensors on the cache's device."""
        dev = self._dev.get("read")
        if dev is None:
            dev = {k: table_tensor(v, self.device)
                   for k, v in self.stream_tables().items()}
            self._dev["read"] = dev
        return dev

    def dense_kv(self, layer: int, slot_ids=None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """Dequantized f32 ``(b, smax, n_kv_heads, head_dim)`` K and V —
        the values the attention kernel dequantizes in registers."""
        return stream_kv_ref(self.slot_words(layer, slot_ids),
                             self.device_stream_tables(), bits=self.bits)

    def host_pages(self) -> np.ndarray:
        """The pages as host uint32 words."""
        return self.pages.cpu().numpy().view(np.uint32)

    def verify(self, **kw):
        """Run :func:`repro_torch.analysis.verify_kvcache` over this cache
        (on one host copy of its pages); returns the report."""
        from .. import analysis  # lazy

        return analysis.verify_kvcache(self, **kw)
