#!/usr/bin/env python3
"""Where the time of the ``ssd_scan`` CUDA kernel goes, on a card.

    python3 tools/ablate_ssd_scan.py        # needs one CUDA card and nvcc

Builds ``src/repro_torch/csrc/ssd_scan.cu`` as it is and in variants with
one step of the chunk loop cut out (the kernel's header names the steps
a-d), and times each, CUDA events around 20 back-to-back launches, at
jamba's prefill shape (bf16, B=2, T=1024, H=256, dk=dv=64) and the launch
shape ``scan_launch`` picks.  A variant's output is wrong by design; the
difference of its time from the whole kernel's is what the step costs
where nothing overlaps it.
"""
import ctypes
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import linear_scan as ls  # noqa: E402

#: step cut out -> the source edits that cut it
VARIANTS = {
    "whole kernel": [],
    "without b (scores, (k W)^T)": [
        ("for (int u = warp; u < nb * (nb + 1) / 2; u += WARPS)",
         "for (int u = warp; u < 0; u += WARPS)"),
        ("x < dkp * C / 2;", "x < 0;")],
    "without c (the output)": [
        ("const int n2 = (dvs + 31) / 32;", "const int n2 = 0;")],
    "without d (the state update)": [
        ("    if (ns3 > 0) {\n      const float dec",
         "    if (ns3 < 0) {\n      const float dec")],
    "without the output stores": [
        ("if (tt < T_len && c < dvw)",
         "if (tt < T_len && c < dvw && d[s][e] == 12345.f)")],
    "copies, v^T and L only (b, c, d cut)": [
        ("for (int u = warp; u < nb * (nb + 1) / 2; u += WARPS)",
         "for (int u = warp; u < 0; u += WARPS)"),
        ("x < dkp * C / 2;", "x < 0;"),
        ("const int n2 = (dvs + 31) / 32;", "const int n2 = 0;"),
        ("    if (ns3 > 0) {\n      const float dec",
         "    if (ns3 < 0) {\n      const float dec")],
}


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_ssd_scan: no CUDA device", file=sys.stderr)
        return 2
    src = (build.CSRC / "ssd_scan.cu").read_text()
    out_dir = build.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise AssertionError(f"{name}: {old!r} not in ssd_scan.cu")
            text = text.replace(old, new)
        cu = out_dir / f"v{i}.cu"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(cu.with_suffix(".so")), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), cu.with_suffix(".so"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    b, t, h, dk, dv = 2, 1024, 256, 64, 64
    q, k, v = ((0.5 * torch.randn((b, t, h, d), generator=gen, device=dev))
               .to(torch.bfloat16) for d in (dk, dk, dv))
    logw = -torch.nn.functional.softplus(
        0.5 * torch.randn((b, t, h), generator=gen, device=dev))
    out = torch.empty((b, t, h, dv), dtype=torch.bfloat16, device=dev)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *logw.stride())
    tile, dvs, _ = ls.scan_launch(b, h, dk, dv, 2)
    stream = torch.cuda.current_stream().cuda_stream
    print(f"ssd_scan ablation, bf16 B={b} T={t} H={h} dk={dk} dv={dv}, "
          f"tile {tile}, dv slice {dvs} ({torch.cuda.get_device_name(0)})")
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(lib)).ssd_scan
        fn.argtypes = ls._ARGTYPES
        fn.restype = ctypes.c_int

        def call():
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                    None, out.data_ptr(), None, b, t, h, dk, dv, tile, dvs,
                    ctypes.addressof(strides), 1, stream)
            if rc != 0:
                raise RuntimeError(f"{name}: cudaError {rc}")

        for _ in range(3):
            call()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(20):
            call()
        end.record()
        torch.cuda.synchronize()
        print(f"  {name:38s} {start.elapsed_time(end) / 20:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
