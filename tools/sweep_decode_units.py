#!/usr/bin/env python3
"""Sweep the launch shape of the per-slot decode kernel on one card.

    python3 tools/sweep_decode_units.py

Decodes the front door's layer problem (one smollm-135m layer's 7 int3
matrices and their bf16 scale patterns as 14 element arrays, m 4096,
2170 units) with ``decode_units_u32`` of ``csrc/layout_decode.cu`` at
several grids (blocks an SM, so fields a block), each against the plain
version, and prints the device time of each (``torch.profiler``) and
the wrapper's own choice.  Needs one CUDA card.
"""
from __future__ import annotations

import ctypes
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import chip_smoke as cs              # puts ROOT/src on the path
    import torch

    if not torch.cuda.is_available():
        print("sweep_decode_units: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import api
    from repro_torch.configs import SMOLLM_135M
    from repro_torch.kernels import build
    from repro_torch.kernels import layout_decode as ld

    print(f"card: {cs.card_line()}")
    dev = torch.device("cuda")
    specs = []
    for name, (k, n) in cs.layer_mats(SMOLLM_135M).items():
        specs += [(name, 3, k * n, 0), (f"{name}_scales", 16, k * n // 32, 0)]
    pl = api.plan(api.make_problem(4096, specs), cache=None)
    buf = torch.from_numpy(pl.pack(api.random_codes(pl.problem, seed=0))) \
        .to(dev)
    rows = ld.rows_u32(buf)
    table = ld.device_unit_table(pl.decode_plan, pl.problem, dev)
    want = ld.decode_units_plain(rows, table)
    fn = build.function("layout_decode", "decode_units_u32",
                        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                         ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    n_units, n_fields = table.units.shape[0], table.n_fields
    sms = build.device_sms(dev)
    out = torch.empty_like(want)

    def launch(chunk):
        rc = fn(rows.data_ptr(), rows.shape[1], table.units.data_ptr(),
                table.prefix.data_ptr(), n_units, out.data_ptr(), n_fields,
                chunk, build.stream_handle(dev))
        build.check_launch("decode_units", rc)

    print(f"{n_units} units, {n_fields} fields, {sms} SMs")
    for per_sm in (2, 4, 8, 16, 32):
        blocks = min(-(-n_fields // 256), sms * per_sm)
        chunk = -(-n_fields // (blocks * 256)) * 256
        out.zero_()
        launch(chunk)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"{per_sm} blocks an SM: differs from the "
                                 "plain version")
        dms = cs.device_ms(lambda c=chunk: launch(c), "decode_units_kernel")
        print(f"decode_units {per_sm:2d} blocks an SM (chunk {chunk}): "
              f"device {cs.fmt_ms(dms)} ms")
    dms = cs.device_ms(lambda: ld.decode_units(rows, table),
                       "decode_units_kernel")
    print(f"decode_units as the wrapper launches it: device "
          f"{cs.fmt_ms(dms)} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
