"""Mutation harness: seeded corruptions the analyzer must catch.

Own copy of ``src/repro/analysis/mutations.py`` for the port: the same
twelve classes, each mapped to the same rule ids.

The analyzer's soundness claim is falsifiable: for each corruption class
below there is a mutator that plants exactly that defect into a copy of
a lowered :class:`~repro_torch.core.exec_plan.ExecProgram` or a packed
checkpoint's (manifest, streams, digest) triple, and a registry entry
naming the rule(s) that must fire as **error** findings.  The test suite
(``tests/test_torch_analysis.py``) runs every class and asserts detection —
if a pass is weakened, the corresponding mutation goes green-on-garbage
and the test fails.

Program-table classes (mutate the lowered tables in place):

=================  ====================================================
``overlap``        two pieces claim the same destination bits
``oob-word``       a destination word index outside the buffer
``wrong-shift``    a shift that pushes a piece past the bus row into
                   the u64-pack row padding (the row-seam defect)
``kernel-width``   a slot-table width field > 32 (funnel-illegal)
``kernel-oob``     a slot-table bit offset past the bus row
``gather-dup``     two gather lanes decoding from the same grid slot
=================  ====================================================

Checkpoint classes (mutate manifest dict / stream bytes / digest):

====================  =================================================
``coverage-gap``      count-intervals drop elements of one array
``signature-tamper``  manifest signature no longer matches its bundle
``truncated-stream``  stream buffer short of manifest byte-lengths
``stream-bit-flip``   one flipped stream bit (content digest mismatch)
``cmax-skew``         manifest c_max disagrees with intervals/streams
``shape-skew``        a tensor shape exceeding its scheduled capacity
====================  =================================================

All mutators return **copies**; the input program/manifest/streams are
never modified (programs are memoized on their layout).
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

from ..core.exec_plan import _TAB_WIDTH_SHIFT, ExecProgram, KernelTable

#: program-table corruption class -> rule ids, at least one of which
#: must appear as an ERROR finding
PROGRAM_MUTATIONS: dict[str, tuple[str, ...]] = {
    "overlap": ("program/overlap",),
    "oob-word": ("program/oob-word",),
    "wrong-shift": ("program/row-seam",),
    "kernel-width": ("kernel/width",),
    "kernel-oob": ("kernel/oob",),
    "gather-dup": ("kernel/gather-dup",),
}

#: checkpoint corruption class -> rule ids (same contract)
CHECKPOINT_MUTATIONS: dict[str, tuple[str, ...]] = {
    "coverage-gap": ("manifest/intervals",),
    "signature-tamper": ("manifest/signature",),
    "truncated-stream": ("manifest/stream-shape",),
    "stream-bit-flip": ("manifest/stream-digest",),
    "cmax-skew": ("manifest/c-max", "manifest/stream-shape"),
    "shape-skew": ("manifest/shapes",),
}


def _copy_program(prog: ExecProgram) -> ExecProgram:
    """Replace the mutable tables with fresh copies (cheap, targeted)."""
    kt = prog.kernel
    return dataclasses.replace(
        prog,
        word=prog.word.copy(),
        shift=prog.shift.copy(),
        kernel=KernelTable(
            words32=kt.words32, lanes=kt.lanes, tab=kt.tab.copy(),
            gathers=tuple((i, g.copy()) for i, g in kt.gathers)),
        tables={},
    )


def _pick_piece(prog: ExecProgram, *, min_width: int = 1,
                min_depth: int = 1) -> int:
    """Piece index of the widest array meeting the constraints."""
    best, best_w = -1, -1
    for i, ew in enumerate(prog.elem_widths):
        if ew >= min_width and prog.piece_depths[i] >= min_depth \
                and ew > best_w:
            best, best_w = i, ew
    if best < 0:
        raise ValueError(
            f"no array with width >= {min_width} and depth >= {min_depth}"
        )
    return prog.piece_base[best]


def corrupt_program(prog: ExecProgram, kind: str) -> ExecProgram:
    """Return a copy of ``prog`` with corruption class ``kind`` planted."""
    if kind not in PROGRAM_MUTATIONS:
        raise KeyError(
            f"unknown program mutation {kind!r}; "
            f"have {sorted(PROGRAM_MUTATIONS)}"
        )
    mut = _copy_program(prog)
    if kind == "overlap":
        j = _pick_piece(prog, min_depth=2)
        mut.word[j + 1] = mut.word[j]
        mut.shift[j + 1] = mut.shift[j]
    elif kind == "oob-word":
        j = _pick_piece(prog)
        mut.word[j] = prog.c_max * prog.wpr + 3
    elif kind == "wrong-shift":
        # park the piece at the very last bit of its row: bit_in_row
        # becomes wpr*64 - 1 >= m - 1, so width >= 2 crosses the seam
        j = _pick_piece(prog, min_width=2)
        row = int(mut.word[j]) // prog.wpr
        mut.word[j] = row * prog.wpr + (prog.wpr - 1)
        mut.shift[j] = 63
    elif kind == "kernel-width":
        r, c = _first_slot(mut.kernel)
        off = int(mut.kernel.tab[r, c]) & ((1 << _TAB_WIDTH_SHIFT) - 1)
        mut.kernel.tab[r, c] = np.uint32(off | (33 << _TAB_WIDTH_SHIFT))
    elif kind == "kernel-oob":
        r, c = _first_slot(mut.kernel)
        w = int(mut.kernel.tab[r, c]) >> _TAB_WIDTH_SHIFT
        mut.kernel.tab[r, c] = np.uint32(prog.m | (w << _TAB_WIDTH_SHIFT))
    elif kind == "gather-dup":
        for _i, g in mut.kernel.gathers:
            if g.shape[0] >= 2:
                g[1] = g[0]
                break
        else:
            raise ValueError("no gather with >= 2 lanes to duplicate")
    return mut


def _first_slot(kt: KernelTable) -> tuple[int, int]:
    rows, cols = np.nonzero(kt.tab)
    if not rows.size:
        raise ValueError("kernel table has no occupied slots")
    return int(rows[0]), int(cols[0])


def corrupt_checkpoint(manifest_dict: dict, streams: np.ndarray,
                       digest: str, kind: str,
                       ) -> tuple[dict, np.ndarray, str]:
    """Plant checkpoint corruption ``kind``; returns fresh
    ``(manifest_dict, streams, digest)`` (inputs untouched)."""
    if kind not in CHECKPOINT_MUTATIONS:
        raise KeyError(
            f"unknown checkpoint mutation {kind!r}; "
            f"have {sorted(CHECKPOINT_MUTATIONS)}"
        )
    # JSON round-trip: deep copy + normalize tuples to mutable lists
    # (exactly the form a checkpoint stores the manifest in)
    d = json.loads(json.dumps(manifest_dict))
    streams = np.array(streams)
    if kind == "coverage-gap":
        for iv in d["intervals"]:
            counts = iv[1]
            if counts:
                counts[-1] = [counts[-1][0], counts[-1][1] - 1]
                break
    elif kind == "signature-tamper":
        d["signature"] = [d["signature"][0] + 8, *d["signature"][1:]]
    elif kind == "truncated-stream":
        streams = streams[:, :, :-4]
    elif kind == "stream-bit-flip":
        streams.flat[0] ^= np.uint8(1)
    elif kind == "cmax-skew":
        d["c_max"] += 1
    elif kind == "shape-skew":
        name, (k, n) = d["shapes"][0]
        d["shapes"][0] = [name, [k * 2, n]]
    return d, streams, digest
