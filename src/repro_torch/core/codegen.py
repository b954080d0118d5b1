"""Code generation from a :class:`Layout` (paper §5).

Own copy of ``src/repro/core/codegen.py`` for the port, whole.

Three artifacts, mirroring the paper's pipeline:

* **Host-side organization** (paper Listing 1): :func:`pack_arrays` packs the
  input arrays into the unified layout buffer.  Vectorized per
  (interval, slot) with numpy — the analogue of the generated C `pack()`
  (one statement per slot, a ``for`` loop per multi-cycle interval).
  :func:`emit_c_pack` additionally emits the literal C function for
  inspection/tests.
* **Accelerator-side decoding** (paper Listing 2): :func:`decode_plan`
  produces the static per-interval slot tables the per-slot decode
  kernel (``repro_torch.kernels.layout_decode.decode_units``, every unit
  in one launch) runs over, and :func:`unpack_arrays` is the pure-numpy
  oracle of that kernel.
* **FIFO/staging report**: sizes the decode module's per-array staging
  (paper: shift-register write ports), from ``Layout.fifo_depths``.

Bit conventions: bus cycle = one row of ``m`` bits; element LSB at
``bit_offset``; rows stored little-endian in bytes (bit *b* of a row lives
in byte ``b >> 3`` at in-byte position ``b & 7``) — matching the shifts an
``ap_uint<m>.range(hi, lo)`` performs in the paper's HLS module.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .layout import Layout
from .task import LayoutProblem


# ----------------------------------------------------------------------
# packing (host side)
# ----------------------------------------------------------------------
def pack_arrays(layout: Layout, arrays: dict[str, np.ndarray]) -> np.ndarray:
    """Pack per-array element codes into the unified layout buffer.

    ``arrays[name]`` holds ``depth`` unsigned element codes (any integer
    dtype; values must fit in the array's declared bitwidth).  Returns a
    ``(c_max, m // 8)`` uint8 buffer.  Requires ``m % 8 == 0`` and
    element widths <= 64.
    """
    prob = layout.problem
    if prob.m % 8 != 0:
        raise ValueError(f"bus width {prob.m} is not byte-aligned")
    row_bytes = prob.m // 8
    # 8 spare bytes so 64-bit scatter windows never clip at the row edge
    buf = np.zeros((layout.c_max, row_bytes + 9), dtype=np.uint8)

    data: list[np.ndarray] = []
    for i, spec in enumerate(prob.arrays):
        if spec.name not in arrays:
            raise KeyError(f"missing array {spec.name!r}")
        a = np.asarray(arrays[spec.name]).reshape(-1).astype(np.uint64)
        if a.shape[0] != spec.depth:
            raise ValueError(
                f"{spec.name}: expected {spec.depth} elements, got {a.shape[0]}"
            )
        if spec.width > 64:
            raise ValueError(f"{spec.name}: width {spec.width} > 64 unsupported")
        if spec.width < 64 and (a >> np.uint64(spec.width)).any():
            raise ValueError(f"{spec.name}: codes overflow {spec.width} bits")
        data.append(a)

    for iv in layout.intervals():
        rows = slice(iv.start_cycle, iv.start_cycle + iv.n_cycles)
        for (array, off, n), base in zip(iv.slots, iv.elem_base):
            w = prob.arrays[array].width
            elems = data[array][base:base + n * iv.n_cycles]
            elems = elems.reshape(iv.n_cycles, n)
            for k in range(n):
                _scatter_bits(buf[rows], elems[:, k], off + k * w, w)
    return buf[:, :row_bytes]


def _scatter_bits(rows: np.ndarray, vals: np.ndarray, bit_off: int,
                  width: int) -> None:
    """OR ``width``-bit values into byte rows at ``bit_off`` (LSB-first)."""
    byte_lo = bit_off >> 3
    shift = bit_off & 7
    lo = (vals << np.uint64(shift)).astype(np.uint64)
    if shift:
        hi = (vals >> np.uint64(64 - shift)).astype(np.uint64)
    else:
        hi = np.zeros_like(vals)
    lo_bytes = lo.view(np.uint8).reshape(vals.shape[0], 8)
    if lo_bytes.base is not None and not lo.flags.c_contiguous:  # pragma: no cover
        lo_bytes = np.ascontiguousarray(lo).view(np.uint8).reshape(-1, 8)
    rows[:, byte_lo:byte_lo + 8] |= lo_bytes
    rows[:, byte_lo + 8] |= hi.astype(np.uint8)


def unpack_arrays(layout: Layout, buf: np.ndarray) -> dict[str, np.ndarray]:
    """Inverse of :func:`pack_arrays` — the oracle for the decode kernel."""
    prob = layout.problem
    row_bytes = prob.m // 8
    if buf.shape != (layout.c_max, row_bytes):
        raise ValueError(
            f"buffer shape {buf.shape} != ({layout.c_max}, {row_bytes})"
        )
    padded = np.zeros((layout.c_max, row_bytes + 9), dtype=np.uint8)
    padded[:, :row_bytes] = buf
    out = {
        a.name: np.zeros(a.depth, dtype=np.uint64) for a in prob.arrays
    }
    for iv in layout.intervals():
        rows = padded[iv.start_cycle:iv.start_cycle + iv.n_cycles]
        for (array, off, n), base in zip(iv.slots, iv.elem_base):
            spec = prob.arrays[array]
            w = spec.width
            vals = np.empty((iv.n_cycles, n), dtype=np.uint64)
            for k in range(n):
                vals[:, k] = _gather_bits(rows, off + k * w, w)
            out[spec.name][base:base + n * iv.n_cycles] = vals.reshape(-1)
    return out


def _gather_bits(rows: np.ndarray, bit_off: int, width: int) -> np.ndarray:
    byte_lo = bit_off >> 3
    shift = bit_off & 7
    window = np.ascontiguousarray(rows[:, byte_lo:byte_lo + 8])
    lo = window.view(np.uint64).reshape(-1) >> np.uint64(shift)
    if shift:
        hi = rows[:, byte_lo + 8].astype(np.uint64) << np.uint64(64 - shift)
        lo = lo | hi
    if width < 64:
        lo = lo & np.uint64((1 << width) - 1)
    return lo


# ----------------------------------------------------------------------
# decode plan (accelerator side)
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SlotPlan:
    """One (interval, slot) decode unit — fully static, kernel-ready."""

    array: int          # index into problem.arrays
    name: str
    width: int          # element bits
    start_cycle: int    # first bus cycle of the interval
    n_cycles: int       # cycles in the interval
    bit_offset: int     # LSB offset of lane 0 within the bus row
    lanes: int          # elements per cycle
    elem_base: int      # index of the first element decoded by this unit


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """Static decode program: the paper's Listing 2 as a table.

    ``slots`` are ordered by start_cycle (stream order).  ``fifo_depths``
    and ``write_ports`` size the decode module's staging memories.
    """

    m: int
    c_max: int
    slots: tuple[SlotPlan, ...]
    fifo_depths: dict[str, int]
    write_ports: dict[str, int]

    @property
    def n_units(self) -> int:
        return len(self.slots)


def decode_plan(layout: Layout) -> DecodePlan:
    prob = layout.problem
    slots: list[SlotPlan] = []
    for iv in layout.intervals():
        for (array, off, n), base in zip(iv.slots, iv.elem_base):
            spec = prob.arrays[array]
            slots.append(
                SlotPlan(
                    array=array,
                    name=spec.name,
                    width=spec.width,
                    start_cycle=iv.start_cycle,
                    n_cycles=iv.n_cycles,
                    bit_offset=off,
                    lanes=n,
                    elem_base=base,
                )
            )
    fifo = {a.name: d for a, d in zip(prob.arrays, layout.fifo_depths())}
    ports = {
        a.name: p for a, p in zip(prob.arrays, layout.max_concurrent_elems())
    }
    return DecodePlan(
        m=prob.m,
        c_max=layout.c_max,
        slots=tuple(sorted(slots, key=lambda s: (s.start_cycle, s.bit_offset))),
        fifo_depths=fifo,
        write_ports=ports,
    )


# ----------------------------------------------------------------------
# literal C emission (paper Listing 1 / Listing 2 artifacts)
# ----------------------------------------------------------------------
def emit_c_pack(layout: Layout, word_bits: int = 64) -> str:
    """Emit the host-side C pack() function in the style of Listing 1."""
    prob = layout.problem
    args = ", ".join(f"const uint64_t* {a.name}" for a in prob.arrays)
    lines = [
        f"// auto-generated by Iris: m={prob.m}, C_max={layout.c_max}",
        f"void pack({args}, uint8_t* out) {{",
    ]
    for a in prob.arrays:
        lines.append(
            f"  // {a.name}: W={a.width}, D={a.depth}, d={a.due}"
        )
    for iv in layout.intervals():
        who = ", ".join(
            f"{prob.arrays[s[0]].name}x{s[2]}" for s in iv.slots
        )
        hdr = (
            f"  // cycles {iv.start_cycle}..{iv.start_cycle + iv.n_cycles - 1}"
            f" : {who}"
        )
        lines.append(hdr)
        body = []
        for (array, off, n), _base in zip(iv.slots, iv.elem_base):
            spec = prob.arrays[array]
            for k in range(n):
                bit = off + k * spec.width
                body.append(
                    f"    put_bits(out, t*{prob.m} + {bit}, "
                    f"(*{spec.name}++) & {_mask_lit(spec.width)}, {spec.width});"
                )
        if iv.n_cycles > 1:
            lines.append(
                f"  for (unsigned t = {iv.start_cycle}; "
                f"t < {iv.start_cycle + iv.n_cycles}; t++) {{"
            )
            lines.extend(body)
            lines.append("  }")
        else:
            lines.append(f"  {{ unsigned t = {iv.start_cycle};")
            lines.extend(body)
            lines.append("  }")
    lines.append("}")
    return "\n".join(lines)


def emit_c_decode(layout: Layout) -> str:
    """Emit the accelerator-side read module in the style of Listing 2."""
    prob = layout.problem
    plan = decode_plan(layout)
    streams = ", ".join(
        f"hls::stream<ap_uint<{a.width}>>& data{a.name}" for a in prob.arrays
    )
    lines = [
        f"#define BUSWIDTH {prob.m}",
    ]
    for name, depth in plan.fifo_depths.items():
        lines.append(f"#define {name}_FIFO_DEPTH {max(1, depth)}")
    lines += [
        f"void read_data(ap_uint<BUSWIDTH>* in_buf, {streams}) {{",
        f"  ap_uint<BUSWIDTH> elem;",
        f"  for (unsigned t = 0; t < {plan.c_max}; t++) {{",
        "#pragma HLS pipeline II=1",
        "    elem = in_buf[t];",
    ]
    first = True
    for iv in layout.intervals():
        lo, hi = iv.start_cycle, iv.start_cycle + iv.n_cycles - 1
        cond = f"t == {lo}" if lo == hi else f"t >= {lo} && t <= {hi}"
        kw = "if" if first else "} else if"
        first = False
        lines.append(f"    {kw} ({cond}) {{")
        for (array, off, n), _base in zip(iv.slots, iv.elem_base):
            spec = prob.arrays[array]
            for k in range(n):
                b0 = off + k * spec.width
                lines.append(
                    f"      data{spec.name} << elem.range("
                    f"{b0 + spec.width - 1}, {b0});"
                )
        lines.append("    ")
    lines += ["    }", "  }", "}"]
    return "\n".join(lines)


def _mask_lit(width: int) -> str:
    return hex((1 << width) - 1)


def random_codes(problem: LayoutProblem, seed: int = 0) -> dict[str, np.ndarray]:
    """Random element codes respecting each array's bitwidth (test helper)."""
    rng = np.random.default_rng(seed)
    out = {}
    for a in problem.arrays:
        if a.width == 64:
            vals = rng.integers(0, 1 << 63, size=a.depth, dtype=np.uint64)
        else:
            vals = rng.integers(0, 1 << a.width, size=a.depth,
                                dtype=np.uint64)
        out[a.name] = vals
    return out
