"""``PackedTree``: a parameter tree in Iris-packed form, over PyTorch tensors.

Port of ``src/repro/tree.py:100-420, 446-649``.  :func:`pack_tree`
quantizes every large weight matrix of the uniform decoder stack, plans
the per-layer Iris stream layout once through
:func:`repro_torch.plan.plan_layer_stack` (N-1 cache hits for the rest of
the stack), packs one unified stream per layer with the fused pack kernel
on the tree's device (:func:`~repro_torch.kernels.layout_pack.pack_pieces`;
its plain version on the CPU) and returns a :class:`PackedTree`.
:func:`unpack_streams` is the inverse: it rebinds the layout without
scheduling and rebuilds scales and kernel views from the stream bytes,
decoded by the fused decode kernel on the tree's device.
:class:`LayoutManifest` has the reference's JSON.  ``PackedTree.verify``
runs the static analyzer (:mod:`repro_torch.analysis`) over the tree, and
``PackedTree.host_stream_words`` hands a layer's stream to the
:class:`~repro_torch.engine.streams.StreamUploader` from pinned host
memory.

Two weight paths serve a tree, as in the reference.  Lane-packable
widths (``bits`` in ``SUPPORTED_BITS`` = 2, 4, 8) get lane-packed kernel
views (``PackedTree.packed``) that ``packed_matmul`` reads; every width
serves **stream-direct**, the matmuls gathering codes and scales straight
out of each layer's stream (``stream_matmul``).  On one tree the two
give the same bits.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch
import torch.nn.functional as F

from .core.exec_plan import (
    ExecProgram,
    StreamTables,
    lower_exec,
    stream_matmul_tables,
)
from .core.iris import DEFAULT_CACHE, LayoutCache
from .core.layout import Layout
from .core.task import LayoutProblem
from .device import resolve_device
from .kernels.layout_decode import decode_layout_fused
from .kernels.layout_pack import pack_pieces
from .kernels.packed_matmul import SUPPORTED_BITS
from .kernels.ref import table_tensor
from .kernels.stream_matmul import stream_matmul, stream_matmul_plain
from .plan import BundleTensor, bundle_problem, plan_layer_stack
from .quant import QuantSpec, bits16, from_bits16, pack_codes_u32, quantize

__all__ = ["LayoutManifest", "PackedTree", "pack_tree", "unpack_streams"]

#: weight names quantized in a dense decoder sublayer (bundle order)
_QUANT_NAMES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

#: bundle tensor name -> quantized param key
_BUNDLE_TO_PARAM = {
    "wq": "attn/wq", "wk": "attn/wk", "wv": "attn/wv", "wo": "attn/wo",
    "w_gate": "mlp/w_gate", "w_up": "mlp/w_up", "w_down": "mlp/w_down",
}

#: bundle norm slot -> other key
_BUNDLE_NORMS = {"attn_norm": "norm1", "mlp_norm": "norm2"}


def _to_tuple(x):
    """Recursively freeze lists (JSON round-trip) into hashable tuples."""
    if isinstance(x, (list, tuple)):
        return tuple(_to_tuple(v) for v in x)
    return x


@dataclasses.dataclass(frozen=True)
class LayoutManifest:
    """Static description of how a :class:`PackedTree` is laid out: the
    bundle, the problem's content signature and the layout's count runs,
    enough to rebind the layout without scheduling."""

    arch: str
    spec: QuantSpec
    shapes: tuple[tuple[str, tuple[int, int]], ...]  # quantized name -> (K, N)
    n_layers: int
    m: int
    c_max: int
    row_bytes: int
    bundle: tuple[BundleTensor, ...]
    signature: tuple                     # LayoutProblem.canonical_signature()
    intervals: tuple                     # Layout.count_intervals
    strategy: str = "iris"

    def problem(self) -> LayoutProblem:
        return bundle_problem(list(self.bundle), m=self.m)

    def elem_widths(self) -> tuple[int, ...]:
        return tuple(b.width_bits for b in self.bundle)

    def resolve_layout(self, cache: LayoutCache | None = DEFAULT_CACHE,
                       ) -> tuple[Layout, str]:
        """The layout this manifest describes, without scheduling:
        ``(layout, "cache-hit" | "manifest")``."""
        prob = self.problem()
        if prob.canonical_signature() != self.signature:
            raise ValueError(
                "manifest signature does not match its bundle problem — "
                "manifest is corrupt or from an incompatible version"
            )
        use_cache = cache is not None and self.strategy == "iris"
        if use_cache:
            hit = cache.lookup(prob)
            if hit is not None:
                return hit, "cache-hit"
        lay = Layout.from_count_intervals(prob, self.intervals)
        lay.validate()
        if use_cache:
            cache.insert(prob, False, lay)
        return lay, "manifest"

    def to_json_dict(self) -> dict:
        return {
            "arch": self.arch,
            "spec": dataclasses.asdict(self.spec),
            "shapes": [[n, list(s)] for n, s in self.shapes],
            "n_layers": self.n_layers,
            "m": self.m,
            "c_max": self.c_max,
            "row_bytes": self.row_bytes,
            "bundle": [dataclasses.asdict(b) for b in self.bundle],
            "signature": self.signature,
            "intervals": self.intervals,
            "strategy": self.strategy,
        }

    @staticmethod
    def from_json_dict(d: dict) -> "LayoutManifest":
        return LayoutManifest(
            arch=d["arch"],
            spec=QuantSpec(**d["spec"]),
            shapes=tuple((n, tuple(s)) for n, s in d["shapes"]),
            n_layers=int(d["n_layers"]),
            m=int(d["m"]),
            c_max=int(d["c_max"]),
            row_bytes=int(d["row_bytes"]),
            bundle=tuple(BundleTensor(**b) for b in d["bundle"]),
            signature=_to_tuple(d["signature"]),
            intervals=_to_tuple(d["intervals"]),
            strategy=d["strategy"],
        )

    def to_json(self) -> str:
        return json.dumps(self.to_json_dict())

    @staticmethod
    def from_json(text: str) -> "LayoutManifest":
        return LayoutManifest.from_json_dict(json.loads(text))


class PackedTree:
    """Iris-packed parameters: per-layer stream buffers plus what stays
    dense.

    ``packed``: per quantized key the ``(n_layers, K*bits/32, N)``
    lane-packed u32 kernel views (int32 bits) read by ``packed_matmul``,
    or empty for widths that do not lane-pack; ``streams``:
    ``(n_layers, c_max, m/8)`` uint8, the unified stream per layer (codes
    + scale bit patterns + norm scale slots, interleaved by the
    scheduler); ``scales``: per quantized key the ``(n_layers, K/g, N)``
    bf16 group scales; ``other``: embedding, norms (LayerNorm biases
    included) and, for a ``use_bias`` config, the dense biases under
    ``"attn/bq"`` ... ``"mlp/b_down"``.
    """

    def __init__(self, packed: dict, scales: dict, other: dict,
                 streams: torch.Tensor, manifest: LayoutManifest, *,
                 provenance: str = "scheduled") -> None:
        self.packed = packed
        self.scales = scales
        self.other = other
        self.streams = streams
        self.manifest = manifest
        self.provenance = provenance
        self._layout: Layout | None = None
        self._program: ExecProgram | None = None
        self._stream_tabs: dict = {}
        self._device_tabs: dict = {}
        self._words: torch.Tensor | None = None
        self._host_words: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.streams.device

    def gathered(self) -> "PackedTree":
        """This tree, every leaf a plain tensor on this rank.  The packed
        decode step's kernels read whole layer streams and kernel views
        through ctypes, so a placed tree (``launch.sharding.place``) is
        served whole: the first call gathers each placed leaf (an
        explicit gather; on a one-card mesh a view, no copy) and the
        tree keeps the whole values in place of its shards, so no rank
        holds both."""
        from .models.shard_utils import is_dtensor, local
        from .pytree import flatten, tree_map

        leaves = [self.streams, *self.packed.values(),
                  *self.scales.values(), *flatten(self.other)]
        if any(is_dtensor(t) for t in leaves):
            self.packed = {k: local(v) for k, v in self.packed.items()}
            self.scales = {k: local(v) for k, v in self.scales.items()}
            self.other = tree_map(local, self.other)
            self.streams = local(self.streams)
            self._words = self._host_words = None
        return self

    @property
    def spec(self) -> QuantSpec:
        return self.manifest.spec

    @property
    def shapes(self) -> dict[str, tuple[int, int]]:
        return dict(self.manifest.shapes)

    @property
    def n_layers(self) -> int:
        return self.manifest.n_layers

    def other_bytes(self) -> int:
        def size(x):
            if isinstance(x, dict):
                return sum(size(v) for v in x.values())
            return x.numel() * x.element_size()
        return size(self.other)

    def hbm_bytes(self) -> int:
        """Serving footprint: stream buffers, kernel views and dense
        leaves."""
        views = sum(v.numel() * 4 for v in self.packed.values())
        return self.stream_bytes + views + self.other_bytes()

    @property
    def stream_bytes(self) -> int:
        """Total bytes of the unified per-layer Iris stream buffers."""
        return self.manifest.n_layers * self.manifest.c_max \
            * self.manifest.row_bytes

    # -- layout / program handles ---------------------------------------
    def layout(self, cache: LayoutCache | None = DEFAULT_CACHE) -> Layout:
        """The per-layer stream :class:`Layout` (never re-scheduled)."""
        if self._layout is None:
            self._layout, self.provenance = self.manifest.resolve_layout(cache)
        return self._layout

    def exec_program(self, cache: LayoutCache | None = DEFAULT_CACHE,
                     ) -> ExecProgram:
        """Compiled pack program at bundle-element granularity."""
        if self._program is None:
            self._program = lower_exec(self.layout(cache),
                                       elem_widths=self.manifest.elem_widths())
        return self._program

    # -- stream-direct matmul -------------------------------------------
    def stream_tables(self, key: str) -> StreamTables:
        """Bit-offset tables for quantized param ``key`` ("attn/wq", ...),
        shared by every layer (one layout signature)."""
        tabs = self._stream_tabs.get(key)
        if tabs is None:
            shapes = dict(self.manifest.shapes)
            if key not in shapes:
                raise KeyError(
                    f"{key!r} is not a quantized tensor; have "
                    f"{sorted(shapes)}"
                )
            bname = key.split("/", 1)[1]
            tabs = stream_matmul_tables(
                self.layout(), bname, shapes[key],
                scales=f"{bname}_scales",
                group_size=self.manifest.spec.group_size,
                program=self.exec_program())
            self._stream_tabs[key] = tabs
        return tabs

    def device_tables(self, key: str) -> tuple[torch.Tensor, torch.Tensor]:
        """``(w_tab, s_tab)`` of ``key`` as int32 tensors on the device."""
        dev = self._device_tabs.get(key)
        if dev is None:
            tabs = self.stream_tables(key)
            dev = (table_tensor(tabs.w_tab, self.device),
                   table_tensor(tabs.s_tab, self.device))
            self._device_tabs[key] = dev
        return dev

    def stream_words(self) -> torch.Tensor:
        """Every layer's stream as flat u32 words: ``(n_layers, W)`` int32
        on the tree's device (built once, each row padded to whole
        words)."""
        if self._words is None:
            prog = self.exec_program()
            pad = prog.words32 * 4 - prog.row_bytes
            self._words = F.pad(self.streams, (0, pad)).contiguous() \
                .view(torch.int32).reshape(self.n_layers, -1)
        return self._words

    def layer_stream_words(self, layer: int) -> torch.Tensor:
        return self.stream_words()[layer]

    def host_stream_words(self, layer: int) -> torch.Tensor:
        """Layer ``layer``'s stream as flat host u32 words (int32 bits,
        ``prog.buffer_words32``): the upload side of
        :meth:`layer_stream_words`, read by the
        :class:`~repro_torch.engine.streams.StreamUploader`.  The first
        call copies every layer's stream from the tree's device once and
        keeps the words, in pinned memory when the tree lives on the card
        (so uploads can run asynchronously)."""
        if self._host_words is None:
            prog = self.exec_program()
            host = self.streams.cpu().numpy()
            words = torch.from_numpy(np.stack([
                prog.buffer_words32(host[la]).reshape(-1)
                for la in range(self.n_layers)]).view(np.int32))
            self._host_words = words.pin_memory() \
                if self.device.type == "cuda" else words
        return self._host_words[layer]

    def matmul_direct(self, x: torch.Tensor, key: str, layer: int, *,
                      words: torch.Tensor | None = None,
                      plain: bool = False) -> torch.Tensor:
        """``x @ dequant(key)`` gathered straight from layer ``layer``'s
        packed stream.  ``plain=True`` runs the kernel's plain version on
        the tree's device (the comparison ``chip_smoke.py`` makes)."""
        tabs = self.stream_tables(key)
        w_tab, s_tab = self.device_tables(key)
        if words is None:
            words = self.layer_stream_words(layer)
        fn = stream_matmul_plain if plain else stream_matmul
        return fn(x, words, w_tab, s_tab, bits=tabs.bits,
                  group_size=tabs.group_size)

    def verify(self, *, raise_on_error: bool = True, passes=None):
        """Statically verify this tree before serving or checkpointing.

        Runs the :mod:`repro_torch.analysis` pass set over the manifest,
        the layout it rebinds, the lowered tables and the stream buffers
        (one host copy).  Returns the report; with ``raise_on_error=True``
        (default) any error-severity finding raises
        :class:`~repro_torch.analysis.AnalysisError`.
        """
        from .analysis import verify_tree  # lazy: off the serving import path

        report = verify_tree(self, passes=passes)
        return report.raise_if_errors() if raise_on_error else report

    def summary(self) -> str:
        """One-line report: B_eff, buffer bytes, provenance."""
        man = self.manifest
        prob = man.problem()
        b_eff = prob.p_tot / (man.c_max * man.m)
        return (
            f"PackedTree[{man.arch}] int{man.spec.bits}/g{man.spec.group_size}"
            f" layers={man.n_layers} strategy={man.strategy}"
            f" B_eff={b_eff:.4f} stream={self.stream_bytes / 2**20:.2f} MiB"
            f" hbm={self.hbm_bytes() / 2**20:.2f} MiB"
            f" device={self.device} cache={self.provenance}"
        )

    def __repr__(self) -> str:
        return f"<{self.summary()}>"


def _layer_pieces(bundle, codes, scales16, norms16, layer: int
                  ) -> list[torch.Tensor]:
    """One layer's element streams in bundle order (codes, scale and norm
    bit patterns), on their device."""
    out = []
    for b in bundle:
        if b.name in _BUNDLE_NORMS:
            out.append(norms16[b.name][layer])
        elif b.name.endswith("_scales"):
            out.append(scales16[b.name[:-len("_scales")]][layer])
        else:
            out.append(codes[_BUNDLE_TO_PARAM[b.name]][layer])
    return out


def pack_tree(cfg, params: dict, spec: QuantSpec, *, m: int = 4096,
              cache: LayoutCache | None = DEFAULT_CACHE,
              with_kernel_views: bool | None = None,
              device=None) -> PackedTree:
    """Quantize + plan + pack a dense decoder's parameters in one call.

    Quantization and the pack run on ``device`` (``"cuda"`` unless
    given), one pack-kernel launch per layer; the bytes are those of the
    host pack :func:`~repro_torch.core.exec_plan.pack_compiled`.
    ``with_kernel_views=None`` builds the lane-packed views exactly when
    the width lane-packs (``bits`` in ``SUPPORTED_BITS``); ``True`` for
    another width raises.
    """
    from .models.quantized import quantizable

    lane_packable = spec.bits in SUPPORTED_BITS
    if with_kernel_views is None:
        with_kernel_views = lane_packable
    if with_kernel_views and not lane_packable:
        raise ValueError(
            f"lane-packed kernel views need bits in "
            f"{sorted(SUPPORTED_BITS)}; got {spec.bits}: serve it "
            "stream-direct (with_kernel_views=False)")
    if not quantizable(cfg):
        raise NotImplementedError(
            f"pack_tree covers archs of one attn -> mlp sublayer (the "
            f"dense family, qwen2-vl); {cfg.name} is not")
    if spec.scale_dtype not in ("bfloat16", "float16"):
        raise ValueError(
            f"stream packing stores 16-bit scale slots; scale_dtype "
            f"{spec.scale_dtype!r} is not 16-bit")
    device = resolve_device(device)
    blocks = params["blocks"][0]
    codes: dict[str, torch.Tensor] = {}   # param key -> (L, K*N) codes
    packed: dict[str, torch.Tensor] = {}
    scales: dict[str, torch.Tensor] = {}
    shapes: dict[str, tuple[int, int]] = {}
    other = {
        "embed": params["embed"].to(device),
        "final_norm": {k: v.to(device)
                       for k, v in params["final_norm"].items()},
        "norm1": {k: v.to(device) for k, v in blocks["norm1"].items()},
        "norm2": {k: v.to(device) for k, v in blocks["norm2"].items()},
    }
    if "unembed" in params:
        other["unembed"] = params["unembed"].to(device)
    for sub in ("attn", "mlp"):
        for name, w in blocks[sub].items():
            if name not in _QUANT_NAMES:
                other[f"{sub}/{name}"] = w.to(device)   # biases stay dense
                continue
            k = f"{sub}/{name}"
            qt = quantize(w.to(device), spec)
            if with_kernel_views:
                packed[k] = pack_codes_u32(qt.codes, spec.bits)
            scales[k] = qt.scales
            shapes[k] = (int(w.shape[1]), int(w.shape[2]))
            codes[k] = qt.codes.reshape(qt.codes.shape[0], -1)

    stack = plan_layer_stack(cfg, spec, m=m, cache=cache)
    lay = stack.layout
    manifest = LayoutManifest(
        arch=cfg.name,
        spec=spec,
        shapes=tuple(sorted(shapes.items())),
        n_layers=stack.n_layers,
        m=m,
        c_max=lay.c_max,
        row_bytes=m // 8,
        bundle=stack.bundle,
        signature=lay.problem.canonical_signature(),
        intervals=lay.count_intervals,
    )

    prog = stack.exec_program()

    def bits16_rows(x: torch.Tensor) -> torch.Tensor:
        return bits16(x).reshape(x.shape[0], -1)

    scales16 = {k.split("/", 1)[1]: bits16_rows(v) for k, v in scales.items()}
    norms16 = {name: bits16_rows(other[key]["scale"])
               for name, key in _BUNDLE_NORMS.items()}
    streams = torch.stack([
        pack_pieces(prog, _layer_pieces(stack.bundle, codes, scales16,
                                        norms16, layer))
        for layer in range(stack.n_layers)])

    pt = PackedTree(packed=packed, scales=scales, other=other,
                    streams=streams, manifest=manifest,
                    provenance=stack.provenance)
    pt._layout = lay
    pt._program = prog
    return pt


def unpack_streams(manifest: LayoutManifest, streams, other: dict, *,
                   cache: LayoutCache | None = DEFAULT_CACHE,
                   device=None) -> PackedTree:
    """Rebuild a :class:`PackedTree` from its stream buffers.

    The layout is rebound from ``cache`` or rebuilt from the manifest's
    count runs (the scheduler never runs).  Each layer stream is decoded
    by the fused decode kernel on ``device`` (``"cuda"`` unless given;
    one launch per layer), and the scales and, for lane-packable widths,
    the kernel views are rebuilt there from the decoded pieces, bit for
    bit.  ``streams`` is the ``(n_layers, c_max, m/8)`` uint8 array
    (numpy or tensor).
    """
    device = resolve_device(device)
    lay, provenance = manifest.resolve_layout(cache)
    prog = lower_exec(lay, elem_widths=manifest.elem_widths())
    streams = torch.as_tensor(streams, dtype=torch.uint8).to(device)
    n_layers = manifest.n_layers
    if streams.shape[0] != n_layers:
        raise ValueError(
            f"streams has {streams.shape[0]} layers, manifest says "
            f"{n_layers}")
    spec = manifest.spec
    g = spec.group_size
    per_layer = [decode_layout_fused(lay, streams[la], program=prog)
                 for la in range(n_layers)]
    packed: dict[str, torch.Tensor] = {}
    scales: dict[str, torch.Tensor] = {}
    for key, (kk, nn) in manifest.shapes:
        bname = key.split("/", 1)[1]
        pat = torch.stack([per_layer[la][f"{bname}_scales"][:(kk // g) * nn]
                           for la in range(n_layers)])
        scales[key] = from_bits16(pat, spec.scale_dtype).reshape(
            n_layers, kk // g, nn)
        if spec.bits in SUPPORTED_BITS:
            layer_codes = torch.stack([per_layer[la][bname][:kk * nn]
                                       for la in range(n_layers)])
            packed[key] = pack_codes_u32(
                layer_codes.reshape(n_layers, kk, nn), spec.bits)
    pt = PackedTree(packed=packed, scales=scales, other=other,
                    streams=streams.clone(), manifest=manifest,
                    provenance=provenance)
    pt._layout = lay
    pt._program = prog
    return pt
