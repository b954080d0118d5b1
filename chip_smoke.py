#!/usr/bin/env python3
"""On-card smoke check of the PyTorch / H100 port (``src/repro_torch``).

    python3 chip_smoke.py            # needs one CUDA card

1. Prints the card (``nvidia-smi`` name and power limit), torch and CUDA.
2. Builds every CUDA kernel of the port from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, in parallel) and prints the build time.
3. Packs smollm-135m at full width and depth (30 layers, seeded random
   weights) into int3 Iris streams, then holds ``stream_matmul`` and
   ``stream_attention`` against their plain PyTorch versions on the card
   at the main path's shapes (as in the first slice), each timed back to
   back (CUDA events) and by its device time per launch
   (``torch.profiler``, which leaves out the host's cost of a launch),
   the library yardstick likewise.
   ``stream_attention`` also at smollm's published context, smax 2048,
   with ``pos`` at 2047, at a split edge and one past it, and at 0; and at
   mistral-large-123b's attention (96 query heads over 8 KV heads, 12 a
   KV head, head_dim 128; B=4) at smax 256 and 2048, beside SDPA.
4. Front door at full width: ``repro_torch.api.plan`` of one smollm layer
   as 14 element arrays (int3 codes and bf16 scale patterns of the 7
   matrices, taken from layer 0 of the int3 tree), C_max 3025.  The
   ``cuda`` pack is byte-equal to the ``numpy`` pack; the ``cuda`` fused
   and per-slot decodes equal the ``numpy`` decode and the input codes,
   one launch each (the per-slot one covers the plan's 2170 units).
   Then ``compare(PAPER_EXAMPLE)`` (C_max 19/13/13/9) and ``cuda`` round
   trips of ``PAPER_EXAMPLE`` and ``INV_HELMHOLTZ`` (three 64-bit arrays,
   two u32 fields a piece), every array through the kernels, launches
   pack / fused / per-slot (1, 1, 1).
5. int4 pack on the card: ``pack_tree`` at full width and depth packs
   each layer with one ``pack_layout_fused`` launch (``pack_pieces``, as
   the int3 pack of step 3 does: 60 launches in all); 30/30 layer streams
   byte-equal to the host ``pack_compiled`` of the quantized pieces.
6. Whole-stack restore: ``unpack_streams`` of the int3 and the int4 tree
   (one ``decode_layout_fused`` launch per layer) rebuilds scales (and
   the int4 views) equal to the tree's; each layer's decode equals the
   host ``unpack_indexed``, the quantized codes and the scale patterns.
   Prints the restore's wall ms and its device ms (every device event of
   a profiler window over the call).
7. Each new kernel against its plain version at the main path's shapes:
   ``packed_matmul`` (the 7 int4 matrices of a layer at M=4, the served
   batch),
   ``pack_layout_fused`` (the whole ``pack_pieces`` call on one int3 and
   one int4 layer, with the pieces as ``pack_tree`` handed them over: one
   kernel in its profiler window, held against ``pack_runs_plain``,
   ``pack_words`` and the layer's stream; beside it ``pack_words``, the
   TPU kernel's form, held against its plain version), ``decode_layout_fused`` (the
   whole call on one int3 and one int4 layer: one kernel in its profiler
   window; beside it ``decode_grid``, the TPU kernel's grid, held against
   ``decode_grid_plain``) and
   ``decode_slot`` (the front door's whole per-slot decode, one launch
   over 2170 units, and a sample of one-unit ``decode_slot`` calls).  Prints
   max errors and times: the kernel back to back and its device time per
   launch, its plain version, one PyTorch library call of the same
   function where there is one (never used by the port, its device time
   beside it), and the least time the card could take (bytes over
   3.35 TB/s or FLOPs over the peak of the unit the kernel runs them on:
   67 TFLOP/s f32 CUDA cores, 989 TFLOP/s bf16 tensor cores).  Tables
   that all layers of a stack share are counted once per stack (spread
   over the layers); the cold figure (tables read on every call) is
   printed beside it.
8. Serves int4 and int3: 8 teacher-forced ragged decode steps through the
   kernels, each against the same step through the plain versions over
   the KV pages the kernels' step wrote (and, for int4, against the
   stream-direct weights on the same state, bit for bit), then ``Engine``
   with ``PackedAdapter(kv="packed")``, batch 4, max_seq 256, 8 requests
   of 16 new tokens.  Launch counters are zeroed just before each path
   and read just after: int4 serving launches ``packed_matmul`` 7 x 30
   times per step and ``stream_matmul`` never; int3 the reverse.
   After the int3 serve, the checkpoint phase
   (:func:`checkpoint_phase`): an int3 ``PackedKVCache`` (batch 4,
   max_seq 256) after 8 teacher-forced ragged decode steps is saved with
   the int3 tree (``CheckpointManager.save_packed(..., kv=...)``: bytes
   and wall s), verified on the host (``verify_packed``: ``ok``, with the
   ``kvcache`` pass; wall s) and restored on the card (``restore_packed``:
   30 ``decode_layout_fused`` launches, counted; streams, scales and
   unquantized leaves equal to the tree's, bit for bit; wall ms and the
   device ms of a profiler window over the call, split into memory
   copies and the rest, beside ``unpack_streams`` of the resident tree;
   ``restore_kv``: pages equal, provenance ``"checkpoint"``).  4 more
   decode steps from the original state and from the restored tree and
   cache give bit-equal logits.  The int4 tree is saved and restored
   without KV (views equal) and 2 decode steps through ``packed_matmul``
   from each, on fresh int4 caches, are bit-equal.  A flipped stream
   bit and a truncated stream on disk are refused with ``AnalysisError``
   under ``manifest/stream-digest`` and ``manifest/stream-shape``.  The
   restored int3 tree then serves the 8 prompts through a
   ``StreamUploader`` (``completed=8/8``, tokens equal to the resident
   serve's, 210 ``stream_matmul`` and 30 ``stream_attention`` launches a
   step, one sync fetch) three times, in turns with three serves from
   its resident streams; a profiled window of 4 steps through the
   uploader; and the 30 layers' uploads on the side stream, timed with
   CUDA events against the bytes over 64 GB/s (PCIe Gen5 x16, one
   direction, by the data sheet).
   Then a ``torch.profiler`` window over 4 steady engine steps of each,
   int3 and int4.
9. Frees the smollm trees, then jamba-1.5-large-398b at its full widths,
   cut to one period (``n_layers`` 72 -> 8: 7 Mamba sublayers and 1 GQA
   attention sublayer) and ``moe=None``, a memory cut (every sublayer
   takes the dense MLP of d_ff 24576; the period's four MoE sublayers,
   77 GB, would not fit one card beside the rest): 10.77 B seeded random
   bf16 parameters, 21.5 GB.
   ``ssd_scan`` against its plain version on the layer-0 Mamba inputs of
   the real prefill (bf16, B=2, T=1024, H=256, dk=dv=64), on a ragged
   f32 case (T=1000, ``state0``, final state) and at Mamba-2's d_state
   128 (dk=128, dv=64, bf16, seeded inputs); ``build_prefill_step`` at
   B=2, T=1024 (7 ``ssd_scan`` launches, counted); teacher-forced decode
   of 2 prompts of 16 tokens through ``build_serve_step`` against the
   prefill's logits, in bf16 (stated tolerance) and, with the same
   weights widened to f32, at the reference's 1e-3 with greedy argmax
   equal at every position; ``Engine(DenseAdapter)`` with 8 requests,
   batch 4, max_seq 256, 8 new tokens each, against the decode step's
   bytes bound.  Peak device memory is printed for each jamba phase.
10. stablelm-3b at full width and depth (32 layers, d_model 2560, 32/32
    heads of 80, d_ff 6912, vocab 50304, LayerNorm, biased projections,
    untied; 2.80 B seeded parameters with seeded nonzero biases and norm
    biases), :func:`run_packed`: ``pack_tree`` at int3 and at int4 on the
    card (32 ``pack_layout_fused`` launches each, counted; the bias and
    norm-bias leaves carried dense) and layer 0's whole ``pack_pieces``
    of each against ``pack_runs_plain``; ``stream_matmul`` (int3) and
    ``packed_matmul`` (int4) on one layer's 7 matrices at M=4 and
    ``stream_attention`` at B=4, 32/32 heads of 80, smax 256, each against
    its plain version and beside its library call and bound; the 8-step
    ragged decode check of each tree (int4 also packed == stream bit for
    bit); the int4 and int3 serves (batch 4, 8 requests of 16 new tokens,
    224 matmul and 32 ``stream_attention`` launches a step, counted); a
    profiled window of 4 int3 steps.
11. moonshot-v1-16b-a3b at full width (d_model 2048, 16/16 heads of 128,
    64 experts top-6 of d_expert 1408, vocab 163840), cut to 8 layers:
    the prefill at B=2, T=1024 (finite logits and aux; the share of
    tokens over capacity by layer), layer 0's ``apply_moe`` against
    ``apply_moe_reference`` in bf16 at ample capacity, decode == prefill
    in bf16 at ample capacity, and ``Engine(DenseAdapter)`` with 8
    requests of 8 new tokens against the bytes of every expert.
12. qwen2-vl-2b at full width and depth (28 layers, d_model 1536, 12/2
    heads of 128, rep 6, d_ff 8960, tied vocab 151936, RMSNorm, biased
    projections, M-RoPE sections (16, 24, 24); 1.54 B seeded parameters,
    biases seeded nonzero): everything of step 10 at its shapes (K and N
    from 1536, 256 and 8960; 28 pack launches a width; 196 matmul and 28
    ``stream_attention`` launches a serve step).
13. rwkv6-3b at full width and depth (32 layers, d_model 2560, 40
    time-mix heads of 64, d_ff 8960, vocab 65536; 2.86 B seeded
    parameters, ``bonus_u``, ``mix`` and ``decay_w0`` seeded away from
    their constant inits): the prefill at B=2, T=1024; decode == prefill
    in bf16 (1.5: ``RWKV_BF16_ATOL``) and, the same weights widened, in
    f32 (1e-3, greedy
    argmax equal at every position); ``Engine(DenseAdapter)`` with 8
    requests of 8 new tokens against its bytes bound.  No kernel of the
    port is on this path: the time mix's decay is per channel, and the
    reference runs it through its plain scan too.
14. whisper-medium at full width and depth (24 encoder and 24 decoder
    layers, d_model 1024, 16 heads of 64, d_ff 4096, vocab 51865,
    LayerNorm, biases; 1.01 B seeded parameters, biases seeded nonzero):
    ``encode`` of B=2 seeded frame embeddings (1500 x 1024, the audio
    front end's stub); the prefill over tokens and frames at T=448, the
    decoder's context; decode over ``precompute_cross_kv`` == prefill in
    bf16 and f32 as in step 13; ``Engine(DenseAdapter)`` (without cross
    K/V, as the reference's adapter steps it) with 8 requests of 8 new
    tokens.  No kernel of the port is on this path.
15. Training (:func:`run_train`).  ``train smollm-135m``: smollm-135m
    at full width and depth (bf16 parameters, f32 moments, remat
    "full") through ``run_training`` and ``build_train_step``, the train
    CLI's path: B=8, S=1024, the synthetic pipeline at seed 0,
    ``AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=40)``, 40 steps
    with a checkpoint every 10 in a temporary directory and one
    simulated node failure at step 25 (``restarts == 1``, 45 steps run,
    steps 20-24 replayed from the step-20 checkpoint and held against
    the first run's losses; every loss finite; the last five below the
    first); ms per step, tokens/s, peak memory, model FLOPs per step and
    their share of the bf16 dense peak, then a profiler window of two
    steps.  ``train step card == cpu``: one step of smollm-135m at full
    width, f32 weights, B=2, S=128, on the card and on the CPU from the
    same parameters and batch (no kernel of the port on this path).
    ``train jamba (ssd_scan gradient)``: reduced jamba (``moe=None``, 8
    layers) in f32, one ``Model.loss`` and gradient of every leaf on the
    card (the forward through the ``ssd_scan`` kernel, its launches
    counted; the backward through the scan's autograd Function) against
    the CPU's, and against the card with the plain scan.
16. The planner (:func:`planner_phase`, after the smollm phases), at
    smollm-135m's full width: ``schedule_many`` of its layer bundles at
    bits 2-8, group 32, each over 30 layers, with a pool of 4 after CUDA
    is initialised (its fallback warning an error), serially and cold:
    the same count runs, equal stats, wall seconds of each; warm starts
    chained off the int5 problem (one array re-specified, inserted,
    deleted), each == a cold run, 3 counted; a ``LayoutCache`` disk round
    trip (1 disk hit) and a tampered entry (1 disk reject, a correct
    re-plan); the layout explorer's four tables; then at int5, int6 and
    int7 one layer bundle through the stream-direct path: ``pack_bundle``
    on the host, ``pack_layout_fused`` of its padded pieces on the card
    == that buffer, ``decode_layout_fused`` == the data, ``stream_words``
    on the card, ``LayerStackPlan.matmul_direct`` of the 7 matrices at
    M=4 within 1e-5 / 1e-4 of the plain version and bit-equal to
    ``Plan.matmul_direct`` of the uint8 rows (1 + 1 + 14 launches a
    width, counted), each layer's 7 matmuls timed as the B1 lines are.
    In the checkpoint phase, after the int3 serve, ``page_rows_u8`` of
    one KV page == its slice of ``host_pages()`` and ``stream_bytes()``
    == the pages' bytes (``planner kv`` line).
17. The distributed substrate (:func:`distributed_phase`, after the
    training): a one-rank NCCL group (a ``FileStore`` in a temporary
    directory) and a (1, 1) ``("data", "model")`` ``DeviceMesh``.
    smollm-135m's full-width train state placed by
    ``param_shardings(fsdp=True)`` / ``opt_state_shardings`` takes 3
    sharded train steps at B=8, S=1024 beside 3 unsharded steps from the
    same state and batches (losses within ``SHARDED_LOSS_RTOL``; ms per
    step of each: DTensor's host overhead); the int3 smollm
    ``PackedTree`` placed by ``packed_tree_shardings`` serves 8 requests
    through ``Engine(PackedAdapter)`` with greedy tokens equal to the
    unplaced serve's (``stream_matmul`` and ``stream_attention``
    launches counted into the ``kernels`` line); ``reshard_live`` of the
    placed train state onto a (1,) mesh, bit-equal, with ms and GB;
    ``CheckpointManager.restore(..., shardings=)`` of a train checkpoint
    onto the mesh, bit-equal; ``pipeline_forward`` with one stage ==
    the plain stage loop; the jamba train step of step 15's size placed
    on the mesh against the unplaced step, 2 steps each, losses within
    ``SHARDED_LOSS_RTOL``, the placed Mamba scans through the
    ``ssd_scan`` kernel (28 launches, counted into the ``kernels``
    line).  The group is destroyed at the end of the phase.
18. The dry run (:func:`dryrun_phase`): ``launch.dryrun.run_cell`` of
    smollm-135m at the measured training shape (B=8, S=1024, one card):
    counted FLOPs beside ``train_flops``, counted bytes per card
    (argument + temp) beside the measured step's peak memory, the
    roofline bound beside the measured ms per step; then every
    (arch x shape) cell of ``shape_cells`` on the (16, 16) production
    mesh, counted on the host over a process pool, one line a cell; any
    cell not ``ok`` fails the run.
19. The examples (:func:`examples_phase`), each through its ``main`` on
    the card: ``quickstart`` (its ``cuda`` decode one
    ``decode_layout_fused`` launch, its tiny training run's loss
    dropping); ``packed_serving`` at ``--bits`` 8, 4 and 3 (per width:
    ``api.pack_tree`` one ``pack_layout_fused`` launch a layer, the
    restore one ``decode_layout_fused`` launch a layer and bit-identical,
    7 ``packed_matmul`` (int8, int4) or ``stream_matmul`` (int3) launches
    a layer a step; the packed tokens equal to the plain versions' on
    the card, printed beside the dense ``Model.decode_step``'s tokens);
    ``train_lm`` at its small preset's 300 steps (the example asserts
    its learning bar), then its ``--preset full`` recipe (smollm-135m at
    full width and depth) for 30 steps: finite losses, ms per step, peak
    GB.  Launches counted into the ``kernels`` line.
20. ``fp8 kv`` (:func:`fp8_kv_phase`): smollm-135m at full width and
    depth, bf16, batch 4, 16 greedy dense decode steps from the same
    parameters with a bf16 and a float8_e5m2 cache: logits within the
    reference's bar (``0.35 max|bf16| + 0.5``), the fp8 cache exactly
    half the bytes, ms per step of each.
21. Prints each phase's wall seconds, one JSON ``serve`` line (ms per
    step of the packed serves of stablelm-3b and qwen2-vl-2b, and of the
    unquantized serves of moonshot, rwkv6-3b and whisper-medium), one
    JSON ``checkpoint`` line (the checkpoint phase's figures), one JSON
    ``planner`` line (the planner phase's wall seconds and counts), one
    JSON ``train`` line (the training phases' figures) and one
    JSON ``kernels`` line (seven kernels, each with its ``device_ms``;
    the matmuls and ``stream_attention`` also with
    ``library_device_ms``; B1-B4 with a ``stablelm`` and a ``qwen2_vl``
    entry holding that path's row and launches; B1 with a
    ``stream_direct`` entry, its row and launches at int5-7;
    ``stream_attention`` with its smax-2048 and rep-12 points,
    ``ssd_scan`` with its dk=128 point; ``pack_layout_fused``'s launches
    include stablelm's 64, qwen2-vl's 56 and the planner's 3, as
    ``decode_layout_fused``'s the planner's 3; ``ssd_scan``'s the
    training phase's; ``stream_matmul``, ``stream_attention`` and
    ``pack_layout_fused``'s the distributed phase's, ``ssd_scan``'s its
    placed jamba steps'; ``stream_matmul``, ``packed_matmul``,
    ``pack_layout_fused`` and ``decode_layout_fused``'s the examples'
    under ``examples_launches``), one JSON
    ``distributed`` line (the distributed and dry-run phases' figures),
    one JSON ``examples`` line (the examples' and the fp8 case's
    figures), the card line again, and last ``{"ok": true,
    "device": {...}}``.

Any failed check raises, and the script exits non-zero without the last
line.  Without a CUDA device it exits 2; run alone, outside the
repository, it cannot import the port and fails.
"""
from __future__ import annotations

import contextlib
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM data-sheet peaks (NVIDIA: 3.35 TB/s HBM3, 67 TFLOP/s f32 on
#: CUDA cores, 989 TFLOP/s bf16 on tensor cores)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12
#: PCIe Gen5 x16, one direction, by the data sheet: the host->device
#: upload's bound
PCIE_BYTES_PER_S = 64e9

MM_KEYS = ("attn/wq", "attn/wk", "attn/wv", "attn/wo",
           "mlp/w_gate", "mlp/w_up", "mlp/w_down")
#: stream_matmul: kernel vs plain (f32 sums in another order)
MM_RTOL, MM_ATOL = 1e-4, 1e-4
#: stream_attention: kernel vs plain.  bf16 output of f32 sums taken in
#: another order: one bf16 ulp of the element (2^-7 relative at most),
#: plus a floor for elements near 0
ATT_RTOL, ATT_ATOL = 2.0 ** -7, 1e-4
#: decode logits, kernels vs plain versions: bf16 logits after 30 layers
#: of bf16 residual adds; in bf16 ulps of the largest logit
LOGIT_ULPS = 4
DECODE_STEPS = 8
#: rows of a decode step's matmuls: the serve phases' batch
SERVE_M = 4
#: rows of the benchmark's served steps (64 closed-loop clients): the
#: matmuls' second timed M, one block of 64 rows
WIDE_M = 64
#: the front door's layer problem plans to this C_max (by d_model; the
#: reference planner gives the same), B_eff 0.9997 at full width
FRONT_DOOR_C_MAX = {576: 3025}
#: ssd_scan kernel vs plain: f32 inputs, f32 sums in another order (the
#: reference's own chunked-vs-recurrent bound); bf16 output, one bf16 ulp
#: of the element plus a floor for elements near 0
SCAN_F32_TOL = dict(rtol=2e-4, atol=2e-4)
SCAN_BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-3)
#: jamba decode vs prefill logits.  bf16: |logit| <= ~5 in bf16 (one ulp
#: is 2^-5 at 4); eight sublayers of bf16 rounding move the two paths
#: apart by 0.227-0.291 at the reduced width and 0.242 / 0.203 at d_model
#: 1024 / 2048 in CPU rehearsals (the reference's own two paths: 0.219 at
#: the reduced width), so 0.5; top-2 margins below one ulp are common
#: among 65536 bf16 logits, so greedy agreement is required in f32.  f32
#: (the same weights widened): the reference's own bound, 1e-3.
DECODE_BF16_ATOL = 0.5
DECODE_F32_TOL = dict(rtol=1e-3, atol=1e-3)
#: rwkv6-3b decode vs prefill logits in bf16, 32 layers.  Each of the
#: two bf16 paths drifts from the f32 logits of the same weights by
#: ~0.04 a layer (``tools/rwkv_bf16_drift.py`` on an H100: 0.045-0.048
#: at 1 layer, 0.33-0.34 at 8, 0.67-0.70 at 16, 1.40-1.43 at 32), and the
#: two differ by 0.22, 0.51 and 1.09 at 8, 16 and 32 layers; the
#: reference's own two bf16 paths differ as the port's do
#: (``--reference``: 0.30 against 0.27 at 8 reduced layers).  So 1.5,
#: where jamba's 8 sublayers take 0.5; the f32 check (1e-3, greedy argmax
#: at every position) is the gate on the algorithm.
RWKV_BF16_ATOL = 1.5
#: jamba prefill shape (the ssd_scan kernel line is timed here); also
#: moonshot's and rwkv6-3b's
PREFILL_B, PREFILL_T = 2, 1024
#: whisper-medium's decoder context (``max_target_positions`` of
#: ``openai/whisper-medium``): its prefill's T
WHISPER_T = 448


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean ms per call, CUDA events around ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_window(fn, kernel: str | None, iters: int
                   ) -> tuple[float, int, set[str], float] | None:
    """``torch.profiler`` over ``iters`` back-to-back calls of ``fn``
    after a warm-up step of as many: the device time (us), the count and
    the names of the device events whose name contains ``kernel`` (every
    device event when None), and the device time (us) of the memory
    copies (``Memcpy``) among them.  A window in which the profiler
    recorded no device time is taken again once; None if it stays
    empty."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(2):
        # the active step's events, taken before the profiler clears them
        ready = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: ready.append(p.key_averages())
                     ) as prof:
            for _ in range(2):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        events = [e for e in ready[0]
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and (kernel is None or kernel in e.key)]
        key = "self_device_time_total" if events and hasattr(
            events[0], "self_device_time_total") else "self_cuda_time_total"
        total = sum(getattr(e, key) for e in events)
        if total > 0:
            return (total, sum(e.count for e in events),
                    {e.key for e in events},
                    sum(getattr(e, key) for e in events
                        if "Memcpy" in e.key))
        print(f"device_ms: the profiler recorded no device time of "
              f"{kernel or 'the call'}; once more")
    return None


def device_ms(fn, kernel: str | None, iters: int = 30,
              per_call: int = 1) -> float | None:
    """Device time per call of the CUDA kernel whose name contains
    ``kernel`` (of every kernel ``fn`` launches when ``kernel`` is None):
    ``torch.profiler``'s device time over ``iters`` back-to-back calls,
    divided by the launches it recorded over ``per_call``, the launches
    of one call (by ``iters`` for None).  Unlike :func:`time_ms` it
    leaves out the host's cost of each launch.  None where the profiler
    recorded no device time (printed, never 0)."""
    window = _device_window(fn, kernel, iters)
    if window is None:
        return None
    total, n = window[:2]
    if kernel is None:
        n = iters * per_call
    elif n != iters * per_call:
        print(f"device_ms: the profiler recorded {n} of {iters * per_call} "
              f"launches of {kernel}")
    return total / (n / per_call) / 1e3


def device_call(fn, iters: int = 30) -> tuple[float | None, float | None]:
    """Device time (ms) of one call of ``fn``, summed over every device
    event of the profiler window, and the device events (kernels and
    copies) per call."""
    window = _device_window(fn, None, iters)
    if window is None:
        return None, None
    return window[0] / iters / 1e3, window[1] / iters


def one_kernel_ms(fn, kernel: str, what: str, iters: int = 30
                  ) -> float | None:
    """Device time (ms) of one call of ``fn``, which must run on the
    device the one kernel whose name contains ``kernel`` and nothing
    else: every device event of the profiler window is that kernel, at
    most one a call.  The profiler may drop a few activity records from a
    window (28 of 30 calls' kernels seen on an H100), so the time is the
    mean of the launches it kept; the caller's launch counter checks that
    each call launches once."""
    window = _device_window(fn, None, iters)
    if window is None:
        return None
    total, n, names = window[:3]
    if n > iters or any(kernel not in k for k in names):
        raise AssertionError(f"{what}: {n} device events over {iters} calls "
                             f"({sorted(names)}), expected one {kernel} a "
                             "call and nothing else")
    if n != iters:
        print(f"{what}: the profiler recorded {n} of {iters} launches")
    return total / n / 1e3


def fmt_ms(ms: float | None) -> str:
    return "not recorded" if ms is None else f"{ms:.4f}"


def add_ms(a: float | None, b: float | None) -> float | None:
    return None if a is None or b is None else a + b


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    tb, tf = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


def wide_matmul(what: str, key: str, fn, plain, mod, kernel: str, k: int,
                n: int, weight_bytes: float, rng, dev) -> dict:
    """``fn``, an (M, K) -> (M, N) weight matmul, at M = WIDE_M (one block
    of 64 rows): within MM_RTOL / MM_ATOL of ``plain``, its plain version,
    and bit-equal to the rows of its calls on 8-row slices of x; one
    launch and one weight pass (``mod.launches``, ``mod.weight_passes``)
    a call.  Then timed back to back and on the device, beside the plain
    version and ``torch.matmul`` on the dequantized W.  The bound counts
    x, ``weight_bytes`` and the f32 output once, and 2*M*K*N FLOPs."""
    import torch

    from repro_torch.kernels.stream_matmul import matmul_launch

    m = WIDE_M
    x = torch.from_numpy(rng.standard_normal((m, k), np.float32)).to(dev)
    before = (mod.launches, mod.weight_passes)
    got = fn(x)
    passes = (mod.launches - before[0], mod.weight_passes - before[1])
    want = plain(x)
    rows = torch.cat([fn(x[i:i + 8]) for i in range(0, m, 8)])
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=MM_RTOL, atol=MM_ATOL):
        raise AssertionError(f"{what} {key} M={m}: max |err| {err:.3g}")
    if not torch.equal(got, rows):
        raise AssertionError(f"{what} {key} M={m} differs from its 8-row "
                             f"calls")
    if passes != (1, -(-m // 64)):
        raise AssertionError(f"{what} {key} M={m}: {passes[0]} launches, "
                             f"{passes[1]} weight passes")
    dense = plain(torch.eye(k, device=dev))
    ms = time_ms(lambda: fn(x))
    dms = device_ms(lambda: fn(x), kernel)
    pms = time_ms(lambda: plain(x), iters=5)
    lms = time_ms(lambda: torch.matmul(x, dense))
    ldms = device_ms(lambda: torch.matmul(x, dense), None)
    del dense
    nbytes = x.numel() * 4 + weight_bytes + m * n * 4
    flops = 2 * m * k * n
    bms, by = bound_ms(nbytes, flops)
    print(f"{what} {key:11s} K={k:5d} N={n:5d} M={m}: kernel {ms:.4f} ms "
          f"(device {fmt_ms(dms)} ms, grid {matmul_launch(m, k, n)[1]}, "
          f"{passes[1]} weight pass)  plain {pms:.4f} ms  library(matmul of "
          f"dequantized W) {lms:.4f} ms (device {fmt_ms(ldms)} ms)  bound "
          f"{bms:.5f} ms ({by})  max|err| {err:.3g}  == its 8-row calls")
    return {"ms": ms, "device_ms": dms, "plain_ms": pms, "library_ms": lms,
            "library_device_ms": ldms, "weight_passes": passes[1],
            "bytes": nbytes, "flops": flops}


def wide_layer(what: str, wide: list[dict], layer: dict) -> dict:
    """Print one layer's 7 matmuls at M = WIDE_M beside the same at
    SERVE_M (``layer``: its ms, device ms and bound ms); returns the
    WIDE_M figures."""
    tot = {key: sum(w[key] for w in wide) for key in
           ("ms", "plain_ms", "library_ms", "weight_passes")}
    for key in ("device_ms", "library_device_ms"):
        tot[key] = None if any(w[key] is None for w in wide) else sum(
            w[key] for w in wide)
    bms, by = bound_ms(sum(w["bytes"] for w in wide),
                       sum(w["flops"] for w in wide))
    dms = tot["device_ms"]
    print(f"{what}, one layer's 7 matmuls at M={WIDE_M}: kernel "
          f"{tot['ms']:.4f} ms back to back (device {fmt_ms(dms)} ms, "
          f"{fmt_ms(dms and dms / 7)} ms per launch, "
          f"{tot['weight_passes']} weight passes)  plain "
          f"{tot['plain_ms']:.4f} ms  library {tot['library_ms']:.4f} ms "
          f"(device {fmt_ms(tot['library_device_ms'])} ms)  bound "
          f"{bms:.5f} ms ({by}); at M={SERVE_M}: kernel {layer['ms']:.4f} "
          f"ms (device {fmt_ms(layer['device_ms'])} ms)  bound "
          f"{layer['bound_ms']:.5f} ms")
    return {"m": WIDE_M, **tot, "bound_ms": bms, "bound_by": by}


def check_stream_matmul(tree, rng, dev) -> dict:
    """Each of the 7 matrices at M in {1, 4, 8} plus one ragged shape;
    timed at M=4, the served batch.  The bound counts the offset tables
    once per decode step, over the tree's layers, as the main path and
    the timed repeats read them."""
    import torch

    from repro_torch.core.exec_plan import (
        lower_exec,
        pack_compiled,
        stream_matmul_tables,
    )
    from repro_torch.core.iris import schedule
    from repro_torch.core.util import pad_bundle_elements
    from repro_torch.kernels import stream_matmul as sm
    from repro_torch.kernels.ref import table_tensor, words_tensor
    from repro_torch.plan import BundleTensor, bundle_problem
    from repro_torch.quant import QuantSpec, bits16, quantize

    words = tree.layer_stream_words(0)
    bits, g = tree.spec.bits, tree.spec.group_size
    n_layers = tree.n_layers
    max_err = 0.0
    layer = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
             "library_ms": 0.0, "library_device_ms": 0.0, "bytes": 0,
             "table_bytes": 0, "flops": 0}
    wide = []
    for key in MM_KEYS:
        w_tab, s_tab = tree.device_tables(key)
        k, n = w_tab.shape
        wide.append(wide_matmul(
            "stream_matmul", key, lambda x, w_tab=w_tab, s_tab=s_tab:
            sm.stream_matmul(x, words, w_tab, s_tab, bits=bits,
                             group_size=g),
            lambda x, w_tab=w_tab, s_tab=s_tab: sm.stream_matmul_plain(
                x, words, w_tab, s_tab, bits=bits, group_size=g), sm,
            "stream_matmul_kernel", k, n,
            -(-k * n * bits // 8) + s_tab.numel() * 2
            + (w_tab.numel() + s_tab.numel()) * 4 / n_layers, rng, dev))
        for m in (1, 4, 8):
            x = torch.from_numpy(rng.standard_normal((m, k), np.float32)).to(dev)
            got = sm.stream_matmul(x, words, w_tab, s_tab, bits=bits,
                                   group_size=g)
            want = sm.stream_matmul_plain(x, words, w_tab, s_tab, bits=bits,
                                          group_size=g)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            if not torch.allclose(got, want, rtol=MM_RTOL, atol=MM_ATOL):
                raise AssertionError(
                    f"stream_matmul {key} M={m}: max |err| {err:.3g}")
            if m != SERVE_M:
                continue
            dense = sm.stream_matmul_plain(
                torch.eye(k, device=dev), words, w_tab, s_tab, bits=bits,
                group_size=g)
            ms = time_ms(lambda: sm.stream_matmul(
                x, words, w_tab, s_tab, bits=bits, group_size=g))
            dms = device_ms(lambda: sm.stream_matmul(
                x, words, w_tab, s_tab, bits=bits, group_size=g),
                "stream_matmul_kernel")
            pms = time_ms(lambda: sm.stream_matmul_plain(
                x, words, w_tab, s_tab, bits=bits, group_size=g), iters=5)
            lms = time_ms(lambda: torch.matmul(x, dense))
            ldms = device_ms(lambda: torch.matmul(x, dense), None)
            # the tables serve every layer: read once per decode step
            tab_bytes = (w_tab.numel() + s_tab.numel()) * 4
            nbytes = (x.numel() * 4 + -(-k * n * bits // 8)
                      + s_tab.numel() * 2 + m * n * 4)
            flops = 2 * m * k * n
            bms, _ = bound_ms(nbytes + tab_bytes / n_layers, flops)
            print(f"stream_matmul {key:11s} K={k:5d} N={n:5d} M={m}: "
                  f"kernel {ms:.4f} ms (device {fmt_ms(dms)} ms, grid "
                  f"{sm.matmul_launch(m, k, n)[1]})  plain {pms:.4f} ms  "
                  f"library(matmul of dequantized W) {lms:.4f} ms (device "
                  f"{fmt_ms(ldms)} ms)  bound {bms:.5f} ms  max|err| "
                  f"{err:.3g}")
            layer["ms"] += ms
            layer["device_ms"] = add_ms(layer["device_ms"], dms)
            layer["library_device_ms"] = add_ms(
                layer["library_device_ms"], ldms)
            layer["plain_ms"] += pms
            layer["library_ms"] += lms
            layer["bytes"] += nbytes
            layer["table_bytes"] += tab_bytes
            layer["flops"] += flops
    # one ragged shape on its own int5 stream: K, N, M all off the tiles
    k, n, m, gg, rb = 96, 77, 3, 32, 5
    spec = QuantSpec(bits=rb, group_size=gg)
    wr = torch.from_numpy(rng.standard_normal((k, n), np.float32)).to(dev)
    qt = quantize(wr, spec)
    bundle = [BundleTensor("w", rb, k * n, 1),
              BundleTensor("w_scales", 16, (k // gg) * n, 1)]
    prob = bundle_problem(bundle, m=512)
    lay = schedule(prob)
    prog = lower_exec(lay, elem_widths=(rb, 16))
    data = {"w": qt.codes.cpu().numpy().reshape(-1),
            "w_scales": bits16(qt.scales).cpu().numpy().reshape(-1)}
    buf = pack_compiled(lay, pad_bundle_elements(prob, prog, data),
                        program=prog)
    tabs = stream_matmul_tables(lay, "w", (k, n), scales="w_scales",
                                group_size=gg, program=prog)
    rw = words_tensor(prog.buffer_words32(buf).reshape(-1), dev)
    rwt, rst = table_tensor(tabs.w_tab, dev), table_tensor(tabs.s_tab, dev)
    x = torch.from_numpy(rng.standard_normal((m, k), np.float32)).to(dev)
    got = sm.stream_matmul(x, rw, rwt, rst, bits=rb, group_size=gg)
    want = sm.stream_matmul_plain(x, rw, rwt, rst, bits=rb, group_size=gg)
    err = float((got - want).abs().max())
    max_err = max(max_err, err)
    if not torch.allclose(got, want, rtol=MM_RTOL, atol=MM_ATOL):
        raise AssertionError(f"stream_matmul ragged: max |err| {err:.3g}")
    print(f"stream_matmul ragged int{rb} K={k} N={n} M={m}: "
          f"max|err| {err:.3g}")
    # every layer shares the tables (one layout), which fit the 50 MB L2:
    # a decode step reads them from HBM once, for all its layers
    step_bytes = layer["bytes"] + layer["table_bytes"] / n_layers
    bms, by = bound_ms(step_bytes, layer["flops"])
    cold, cold_by = bound_ms(layer["bytes"] + layer["table_bytes"],
                             layer["flops"])
    print(f"stream_matmul, one layer's 7 matmuls at M={SERVE_M}: kernel "
          f"{layer['ms']:.4f} ms back to back (device "
          f"{fmt_ms(layer['device_ms'])} ms, "
          f"{fmt_ms(layer['device_ms'] and layer['device_ms'] / 7)} ms per "
          f"launch)  plain "
          f"{layer['plain_ms']:.4f} ms  library {layer['library_ms']:.4f} "
          f"ms (device {fmt_ms(layer['library_device_ms'])} ms)  bound "
          f"{bms:.5f} ms "
          f"({by}; {step_bytes:.0f} B with the {layer['table_bytes']} B "
          f"of tables over {n_layers} layers, {layer['flops']} f32 FLOPs); "
          f"cold-L2 bound {cold:.5f} ms ({cold_by}; tables read on every "
          f"call)")
    return {"max_abs_err": max_err, "ms": layer["ms"],
            "device_ms": layer["device_ms"],
            "plain_ms": layer["plain_ms"], "bound_ms": bms, "bound_by": by,
            "library_ms": layer["library_ms"],
            "library_device_ms": layer["library_device_ms"],
            "wide": wide_layer("stream_matmul", wide,
                               {**layer, "bound_ms": bms})}


def check_stream_attention(cfg, rng, dev, smax: int = 256,
                           pos: list[int] | None = None) -> dict:
    """B=4, H=9, Hkv=3, hd=64, int3, ragged positions (by default
    255/191/127/63 at smax 256, the first slice's shape)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kvcache import PackedKVCache
    from repro_torch.kvcache import stream_attention as sa

    b, bits = 4, 3
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kvc = PackedKVCache.create(cfg, bits=bits, page_tokens=8, n_slots=b,
                               max_seq=smax, n_layers=1, device=dev)
    slots = torch.arange(b, device=dev)
    for t in range(smax):
        k = torch.from_numpy(rng.standard_normal((b, hkv, hd), np.float32))
        v = torch.from_numpy(rng.standard_normal((b, hkv, hd), np.float32))
        kvc.append(k.to(dev), v.to(dev), torch.full((b,), t, device=dev),
                   slots, layer=0)
    pos = torch.tensor(pos or [255, 191, 127, 63], device=dev)
    q = torch.from_numpy(rng.standard_normal((b, 1, h, hd), np.float32)) \
        .to(dev).to(torch.bfloat16)
    words = kvc.layer_words(0)
    tabs = kvc.device_stream_tables()
    args = (words, slots, q, pos, tabs["k"], tabs["k_scales"], tabs["v"],
            tabs["v_scales"])
    got = sa.stream_attention(*args, bits=bits)
    want = sa.stream_attention_plain(*args, bits=bits)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), rtol=ATT_RTOL,
                          atol=ATT_ATOL):
        raise AssertionError(f"stream_attention smax={smax}: max |err| "
                             f"{err:.3g}")
    ms = time_ms(lambda: sa.stream_attention(*args, bits=bits))
    dms = device_ms(lambda: sa.stream_attention(*args, bits=bits),
                    "stream_attention_kernel")
    pms = time_ms(lambda: sa.stream_attention_plain(*args, bits=bits),
                  iters=5)
    kf, vf = kvc.dense_kv(0, slots)
    kd = kf.repeat_interleave(h // hkv, dim=2).transpose(1, 2) \
        .to(torch.bfloat16)
    vd = vf.repeat_interleave(h // hkv, dim=2).transpose(1, 2) \
        .to(torch.bfloat16)
    mask = torch.arange(smax, device=dev)[None, None, None, :] \
        <= pos[:, None, None, None]
    qd = q.transpose(1, 2)
    lms = time_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask))
    ldms = device_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask), None)
    n_tok = pos.cpu().numpy().astype(np.int64) + 1
    # the K/V offset tables serve every layer: read once per decode step
    tab_bytes = int(n_tok.max()) * hkv * (hd + 1) * 4 * 2
    nbytes = (q.numel() * 2 + b * 8 + q.numel() * 2
              + int(n_tok.sum()) * hkv * (-(-hd * bits // 8) + 2) * 2)
    flops = int(n_tok.sum()) * h * hd * 4
    bms, by = bound_ms(nbytes + tab_bytes / cfg.n_layers, flops)
    cold, cold_by = bound_ms(nbytes + tab_bytes, flops)
    splits, tpb, smem = sa.attention_launch(b, hkv, h // hkv, hd, smax)
    print(f"stream_attention B={b} smax={smax} H={h} Hkv={hkv} hd={hd} "
          f"int{bits} pos={pos.tolist()} (grid {b}x{hkv}x{splits}, {tpb} "
          f"tokens a block, {smem} B shared): kernel {ms:.4f} ms back to "
          f"back (device {fmt_ms(dms)} ms)  plain {pms:.4f} ms  "
          f"library(sdpa on "
          f"dense_kv) {lms:.4f} ms (device {fmt_ms(ldms)} ms)  bound "
          f"{bms:.6f} ms ({by}; {tab_bytes} B "
          f"of tables over {cfg.n_layers} layers); cold-L2 bound "
          f"{cold:.6f} ms ({cold_by})  max|err| {err:.3g}")
    return {"max_abs_err": err, "ms": ms, "device_ms": dms, "plain_ms": pms,
            "bound_ms": bms, "bound_by": by, "library_ms": lms,
            "library_device_ms": ldms}


def check_long_attention(cfg, rng, dev) -> dict:
    """``stream_attention`` at smollm-135m's published context (2048,
    ``max_position_embeddings`` of ``HuggingFaceTB/SmolLM-135M``), int3,
    B=4, with ``pos`` at 2047, at a split edge (the last token of a
    block), one past it (the first of the next), and at 0."""
    from repro_torch.kvcache import stream_attention as sa

    smax = 2048
    splits, tpb, _ = sa.attention_launch(
        4, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim, smax)
    edge = (splits // 2) * tpb - 1
    return check_stream_attention(cfg, rng, dev, smax=smax,
                                  pos=[smax - 1, edge, edge + 1, 0])


def mistral_attention_config():
    """The attention of mistral-large-123b (HF
    ``mistralai/Mistral-Large-Instruct-2407``: 88 layers, d_model 12288,
    96 query heads over 8 KV heads of head_dim 128, so 12 query heads per
    KV head), on smollm's config class: only the attention's widths and
    the layer count (the tables' sharing) are read."""
    import dataclasses

    from repro_torch.configs import SMOLLM_135M

    return dataclasses.replace(SMOLLM_135M, name="mistral-large-123b",
                               n_layers=88, d_model=12288, n_heads=96,
                               n_kv_heads=8, head_dim=128)


def check_rep12_attention(dev) -> dict:
    """``stream_attention`` at 12 query heads per KV head (mistral-large-
    123b's attention, B=4, int3) at smax 256 and 2048, against the plain
    version and timed beside SDPA; at 2048 with ``pos`` at a split edge
    and one past it."""
    from repro_torch.kvcache import stream_attention as sa

    cfg = mistral_attention_config()
    rows = {"smax_256": check_stream_attention(
        cfg, np.random.default_rng(12), dev, smax=256)}
    splits, tpb, _ = sa.attention_launch(
        4, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim, 2048)
    edge = (splits // 2) * tpb - 1
    rows["smax_2048"] = check_stream_attention(
        cfg, np.random.default_rng(2049), dev, smax=2048,
        pos=[2047, edge, edge + 1, 0])
    return rows


def decode_check(cfg, tree, rng, dev, kv_bits: int) -> None:
    """``DECODE_STEPS`` teacher-forced decode steps through the kernels.
    Each step is also taken through the plain versions over the packed KV
    pages that the kernels' step wrote (the plain step appends nothing),
    and the two steps' logits must agree within ``LOGIT_ULPS`` bf16 ulps
    of the largest logit.  Slot i joins at step i, so rows, M and
    positions are ragged and attention runs over up to ``DECODE_STEPS``
    cached tokens.  A tree with lane-packed views serves through
    ``packed_matmul``; its step is also taken with the stream-direct
    weights (``stream_matmul``) over the same pages, and the logits must
    be equal bit for bit (the two kernels sum in one order).

    A further run takes the same tokens through the plain versions on a
    cache of its own.  How far it drifts from the kernels' run is
    printed, not checked: a last-bit difference in an f32 sum can move an
    int-N KV code by a whole step, and later steps attend over it."""
    import copy

    import torch

    from repro_torch.engine import PackedAdapter
    from repro_torch.models.quantized import packed_decode_step

    def read_only(state, pos):
        # layer l's step appends before it attends, and reads no later
        # layer, so the pages after the kernels' step serve it unchanged
        kvc = copy.copy(state["packed_kv"])
        kvc.append = lambda *args, **kwargs: None
        return {"pos": pos, "packed_kv": kvc}

    b = 4
    adapter = PackedAdapter(cfg, tree, kv="packed", kv_bits=kv_bits)
    toks = rng.integers(1, cfg.vocab_size, (DECODE_STEPS, b))
    state = adapter.init_state(b, 256)
    free = adapter.init_state(b, 256)
    ulps, drift, top, worst, bad, unequal = [], 0.0, 0, 0.0, [], []
    for t in range(DECODE_STEPS):
        active = [i for i in range(b) if t >= i]
        slots = torch.tensor(active, device=dev)
        tok = torch.as_tensor(toks[t, active], device=dev)
        pos = state["pos"]
        got, state = packed_decode_step(cfg, tree, state, tok,
                                        slot_ids=slots, kv="packed")
        want, _ = packed_decode_step(cfg, tree, read_only(state, pos), tok,
                                     slot_ids=slots, kv="packed", plain=True)
        if tree.packed:
            streamed, _ = packed_decode_step(
                cfg, tree, read_only(state, pos), tok, slot_ids=slots,
                kv="packed", weights="stream")
            if not torch.equal(got, streamed):
                unequal.append(t)
        alone, free = packed_decode_step(cfg, tree, free, tok,
                                         slot_ids=slots, kv="packed",
                                         plain=True)
        got, want = got.float(), want.float()
        if got.shape != (len(active), cfg.vocab_size) \
                or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"step {t}: logits malformed {got.shape}")
        largest = float(want.abs().max())
        ulp = 2.0 ** (np.floor(np.log2(largest)) - 7)
        err = float((got - want).abs().max())
        ulps.append(float(err / ulp))
        if err > LOGIT_ULPS * ulp:
            bad.append(t)
        drift = max(drift, float((got - alone.float()).abs().max()))
        top += int((got.argmax(-1) == want.argmax(-1)).sum())
        worst = max(worst, largest)
    n_rows = sum(min(t + 1, b) for t in range(DECODE_STEPS))
    pages, free_pages = state["packed_kv"].pages, free["packed_kv"].pages
    name = f"int{tree.spec.bits} weights, int{kv_bits} KV"
    print(f"decode ({name}), {DECODE_STEPS} ragged steps, kernels vs plain "
          f"versions over the same KV pages: max|dlogit| per step in bf16 "
          f"ulps of its largest logit {[round(u, 3) for u in ulps]} "
          f"(tolerance {LOGIT_ULPS}; largest logit {worst:.4g}); same "
          f"top-1 in {top}/{n_rows} rows")
    if tree.packed:
        print(f"decode ({name}): weights='packed' (packed_matmul) vs "
              f"weights='stream' (stream_matmul) over the same pages: "
              f"{DECODE_STEPS - len(unequal)}/{DECODE_STEPS} steps "
              f"bit-equal")
    print(f"decode ({name}), plain versions on a cache of their own: "
          f"max|dlogit| {drift:.4g} from the kernels' run; "
          f"{int((pages != free_pages).sum())} of {pages.numel()} KV page "
          f"words differ")
    if bad:
        raise AssertionError(f"decode steps {bad}: logits beyond "
                             f"{LOGIT_ULPS} bf16 ulps of the plain run")
    if unequal:
        raise AssertionError(f"decode steps {unequal}: packed and stream "
                             f"weights differ")


def serve(cfg, tree, prompts, kv_bits: int, per_step: dict,
          uploader=None, label: str = "") -> tuple[dict, list, float]:
    """A main path: Engine over PackedAdapter(kv='packed'), counted.
    ``per_step`` is each kernel's launches per engine step; ``uploader``
    (a ``StreamUploader``) serves the layer streams through it; ``label``
    follows the line's name.  Returns the launches, each request's
    greedy tokens and the ms per step."""
    import torch

    from repro_torch.engine import (
        Engine,
        EngineConfig,
        EngineRequest,
        PackedAdapter,
    )
    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.kernels import stream_matmul as sm
    from repro_torch.kvcache import stream_attention as sa

    engine = Engine(PackedAdapter(cfg, tree, kv="packed", kv_bits=kv_bits,
                                  weights="auto", uploader=uploader),
                    EngineConfig(batch_size=4, max_seq=256,
                                 max_backlog=None))
    requests = [EngineRequest(uid=uid, prompt=prompt, max_new_tokens=16)
                for uid, prompt in enumerate(prompts)]
    for req in requests:
        engine.submit(req)
    torch.cuda.synchronize()
    sm.launches = 0
    sa.launches = 0
    pm.launches = 0
    t0 = time.perf_counter()
    stats = engine.run_until_drained(max_steps=2000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"stream_matmul": sm.launches, "stream_attention": sa.launches,
              "packed_matmul": pm.launches}
    print(f"serve int{tree.spec.bits} weights / int{kv_bits} KV{label}: "
          f"completed={stats.completed}/{len(prompts)} "
          f"steps={stats.steps} tokens={stats.tokens_generated} "
          f"wall={wall:.3f} s tokens/s={stats.tokens_generated / wall:.2f} "
          f"ms/decode step={wall / max(1, stats.steps) * 1e3:.3f} "
          f"launches={counts}")
    if stats.completed != len(prompts):
        raise AssertionError(f"completed {stats.completed}/{len(prompts)}")
    for name, n in counts.items():
        if n != per_step.get(name, 0) * stats.steps:
            raise AssertionError(
                f"{name}: {n} launches in {stats.steps} steps, expected "
                f"{per_step.get(name, 0)} per step")
    for req in requests:
        if len(req.generated) != 16 or not all(
                0 <= t < cfg.vocab_size for t in req.generated):
            raise AssertionError(f"request {req.uid}: bad tokens "
                                 f"{req.generated}")
    return (counts, [req.generated for req in requests],
            wall / max(1, stats.steps) * 1e3)


def same_bits(a, b) -> bool:
    """Equal shapes, dtypes and bits (bf16 compared as its int16 bits)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


def same_leaves(got, want) -> bool:
    """Two trees of dicts and tensors equal key for key, bit for bit."""
    if isinstance(want, dict):
        return sorted(got) == sorted(want) and all(
            same_leaves(got[k], v) for k, v in want.items())
    return same_bits(got, want)


def same_tree(got, tree) -> bool:
    """A restored tree's streams, scales, views and unquantized leaves
    equal the saved tree's, bit for bit."""
    return all(same_leaves(getattr(got, k), getattr(tree, k))
               for k in ("streams", "scales", "packed", "other"))


def counted_restore(mgr, step: int, dev):
    """``restore_packed`` with the decode launches counted from 0 just
    before it and read just after: (tree, launches, wall ms)."""
    import torch

    from repro_torch.kernels import layout_decode as ld

    torch.cuda.synchronize()
    ld.fused_launches = 0
    t0 = time.perf_counter()
    got, _ = mgr.restore_packed(step, device=dev)
    torch.cuda.synchronize()
    return got, ld.fused_launches, (time.perf_counter() - t0) * 1e3


def device_parts(fn, iters: int = 1
                 ) -> tuple[float | None, float | None, float | None]:
    """Device time (ms) of one call of ``fn`` from one profiler window:
    every device event, the memory copies among them, and the device
    events a call.  Nones where the profiler recorded no device time."""
    window = _device_window(fn, None, iters)
    if window is None:
        return None, None, None
    total, n, _, copies = window
    return total / iters / 1e3, copies / iters / 1e3, n / iters


def decode_steps(cfg, tree, state, toks, ragged: bool = False
                 ) -> tuple[list, dict]:
    """Teacher-forced packed-KV decode steps through the kernels, one a
    row of ``toks`` (``ragged``: slot i joins at step i, as in
    :func:`decode_check`): the logits of each step and the state after
    the last."""
    import torch

    from repro_torch.models.quantized import packed_decode_step

    out = []
    for t, row in enumerate(toks):
        active = [i for i in range(len(row)) if t >= i or not ragged]
        logits, state = packed_decode_step(
            cfg, tree, state, torch.as_tensor(row[active], device=tree.device),
            slot_ids=torch.tensor(active, device=tree.device), kv="packed")
        out.append(logits)
    return out, state


def refused(mgr, step: int, rule: str, dev) -> str:
    """``restore_packed`` of a corrupted checkpoint must raise
    ``AnalysisError`` naming ``rule``: the refusal, rendered."""
    from repro_torch.analysis import AnalysisError

    try:
        mgr.restore_packed(step, device=dev)
    except AnalysisError as e:
        if rule not in e.report.rule_ids():
            raise AssertionError(f"refused, but not under {rule}: {e}") \
                from None
        return next(f.render() for f in e.report.errors if f.rule_id == rule)
    raise AssertionError(f"a checkpoint that breaks {rule} was restored")


def checkpoint_phase(cfg, tree3, tree4, prompts, dev, resident) -> dict:
    """Save -> verify -> restore on the card -> decode on and serve.

    A packed int3 KV cache (batch 4, max_seq 256) after 8 teacher-forced
    ragged steps through the kernels is saved with the int3 tree
    (``save_packed(..., kv=...)``), verified (``verify_packed``: ``ok``,
    with the ``kvcache`` pass) and restored on the card
    (``restore_packed``: 30 ``decode_layout_fused`` launches; streams,
    scales and unquantized leaves equal to the tree's; ``restore_kv``:
    pages equal, provenance ``"checkpoint"``).  4 more decode steps from
    the original state and from the restored tree and cache give equal
    logits, bit for bit.  The int4 tree is saved and restored without KV
    (views equal) and 2 steps through ``packed_matmul`` from each, on
    fresh int4 caches, are equal bit for bit.  A flipped stream bit and
    a truncated stream on disk are refused under
    ``manifest/stream-digest`` and ``manifest/stream-shape``.  Last the
    restored int3 tree serves the serve phase's 8 prompts through a
    ``StreamUploader`` (tokens equal to the resident serve's ``resident``
    tokens, 210 + 30 launches a step), three times in turns with three
    serves from its resident streams, then a profiled window of 4 steps
    through the uploader; and the 30 layers' uploads, back
    to back on the uploader's side stream, are timed against their PCIe
    bound.  Returns the figures."""
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.engine import (
        Engine,
        EngineConfig,
        PackedAdapter,
        StreamUploader,
    )
    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.tree import unpack_streams

    rng = np.random.default_rng(20)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="iris-ckpt-"))
    try:
        mgr = CheckpointManager(tmp, keep_n=0)
        b = 4
        adapter = PackedAdapter(cfg, tree3, kv="packed", kv_bits=3)
        state = adapter.init_state(b, 256)
        toks = rng.integers(1, cfg.vocab_size, (DECODE_STEPS + 4, b))
        _, state = decode_steps(cfg, tree3, state, toks[:DECODE_STEPS],
                                ragged=True)
        cache = state["packed_kv"]
        torch.cuda.synchronize()
        kv_extras(cache)
        t0 = time.perf_counter()
        path = pathlib.Path(mgr.save_packed(1, tree3, {"decode_steps":
                                                       DECODE_STEPS},
                                            kv=cache))
        save_s = time.perf_counter() - t0
        n_bytes = sum(f.stat().st_size for f in path.iterdir())
        print(f"checkpoint save: int3 tree + int3 KV cache (batch {b}, "
              f"max_seq 256, after {DECODE_STEPS} ragged decode steps): "
              f"{n_bytes} bytes in {len(list(path.iterdir()))} files, "
              f"{save_s:.3f} s wall")
        t0 = time.perf_counter()
        report = mgr.verify_packed(1)
        verify_s = time.perf_counter() - t0
        print(f"checkpoint verify: ok={report.ok} passes={report.passes} "
              f"errors={len(report.errors)} warnings={len(report.warnings)}"
              f"; {verify_s:.3f} s wall")
        if not report.ok or "kvcache" not in report.passes:
            raise AssertionError(report.render())

        restored3, launches3, wall3 = counted_restore(mgr, 1, dev)
        equal3 = same_tree(restored3, tree3)
        dms, cms, events = device_parts(
            lambda: mgr.restore_packed(1, device=dev))
        ums, _ = device_call(
            lambda: unpack_streams(tree3.manifest, tree3.streams,
                                   tree3.other, device=dev), iters=2)
        rest_ms = None if dms is None else dms - cms
        print(f"checkpoint restore int3: restore_packed ({restored3.provenance}"
              f") {wall3:.1f} ms wall, device {fmt_ms(dms)} ms over "
              f"{events} device events, of which memory copies "
              f"{fmt_ms(cms)} ms and the rest {fmt_ms(rest_ms)} ms "
              f"(unpack_streams of the resident tree {fmt_ms(ums)} ms); "
              f"{launches3} decode_layout_fused launches; streams, scales "
              f"and unquantized leaves equal to the saved tree's: {equal3}")
        if launches3 != tree3.n_layers or not equal3:
            raise AssertionError("restore int3 differs from the saved tree")
        kv = mgr.restore_kv(1, device=dev)
        provenance = kv.provenance
        pages_equal = torch.equal(kv.pages, cache.pages)
        print(f"checkpoint restore_kv: provenance={provenance} pages "
              f"{tuple(kv.pages.shape)} equal to the cache's: {pages_equal}")
        if provenance != "checkpoint" or not pages_equal:
            raise AssertionError("restore_kv differs from the cache")

        rest = {"pos": state["pos"].clone(), "packed_kv": kv}
        want, state = decode_steps(cfg, tree3, state, toks[DECODE_STEPS:])
        got, rest = decode_steps(cfg, restored3, rest, toks[DECODE_STEPS:])
        on3 = sum(torch.equal(g, w) for g, w in zip(got, want))
        print(f"checkpoint decode on: {on3}/{len(want)} steps from the "
              f"restored tree and cache bit-equal to the original's")
        if on3 != len(want):
            raise AssertionError("decode after restore differs")

        mgr.save_packed(2, tree4)
        restored4, launches4, wall4 = counted_restore(mgr, 2, dev)
        equal4 = same_tree(restored4, tree4)
        views4 = sorted(restored4.packed) == sorted(tree4.packed) and all(
            torch.equal(restored4.packed[k], v)
            for k, v in tree4.packed.items())
        logits4 = []
        pm.launches = 0
        for t4 in (tree4, restored4):
            ad4 = PackedAdapter(cfg, t4, kv="packed", kv_bits=4)
            out, _ = decode_steps(cfg, t4, ad4.init_state(b, 256), toks[:2])
            logits4.append(out)
        on4 = sum(torch.equal(g, w) for g, w in zip(*logits4))
        print(f"checkpoint restore int4 (no KV): {wall4:.1f} ms wall, "
              f"{launches4} decode_layout_fused launches; tree equal "
              f"{equal4}, lane-packed views equal {views4}; 2 decode steps "
              f"through packed_matmul ({pm.launches} launches) from the "
              f"restored and the original tree: {on4}/2 bit-equal")
        if launches4 != tree4.n_layers or not (equal4 and views4) \
                or on4 != 2 or pm.launches != 2 * 2 * 7 * cfg.n_layers:
            raise AssertionError("restore int4 differs from the tree")
        del restored4

        meta = json.loads((path / "manifest.json").read_text())
        stream_file = f"arr_{meta['paths'].index('streams'):05d}.npy"
        refusals = {}
        for step, rule in ((3, "manifest/stream-digest"),
                           (4, "manifest/stream-shape")):
            bad = tmp / f"step_{step:08d}"
            shutil.copytree(path, bad)
            arr = np.load(bad / stream_file)
            if step == 3:
                arr.flat[12345] ^= np.uint8(0x10)
            else:
                arr = arr[:, :-1]
            np.save(bad / stream_file, arr)
            refusals[rule] = refused(mgr, step, rule, dev)
            what = "a flipped bit" if step == 3 else "a truncated stream"
            print(f"checkpoint refused ({what}): {refusals[rule]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the restored tree served through an uploader and from its resident
    # streams in turns (U R R U U R): one serve's ms per step moves with
    # the host's load by more than the uploader's cost
    per_step = {"stream_attention": cfg.n_layers,
                "stream_matmul": 7 * cfg.n_layers}
    ms_up, ms_res, stats, tokens_equal = [], [], [], True
    for through in (True, False, False, True, True, False):
        up = StreamUploader(restored3) if through else None
        counts, tokens, ms = serve(
            cfg, restored3, prompts, 3, per_step, uploader=up,
            label=" (restored tree, through the StreamUploader)" if through
            else " (restored tree, resident streams)")
        tokens_equal = tokens_equal and tokens == resident[0]
        if through:
            up.close()
            ms_up.append(ms)
            stats.append(up.stats())
            side = up.stream
        else:
            ms_res.append(ms)
    profile_steps(Engine(PackedAdapter(cfg, restored3, kv="packed",
                                       kv_bits=3,
                                       uploader=StreamUploader(restored3)),
                         EngineConfig(batch_size=4, max_seq=256,
                                      max_backlog=None)),
                  prompts, "int3 weights / int3 KV, restored, through the "
                  "StreamUploader")
    # the uploader's copies, one a layer from its pinned words, back to
    # back on its side stream into buffers allocated beforehand: the host
    # enqueues a copy faster than the card runs it, so the events time
    # the copies and not the host
    words = [restored3.host_stream_words(la)
             for la in range(restored3.n_layers)]
    bufs = [torch.empty_like(w, device=dev) for w in words]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(side):
        start.record(side)
        for buf, w in zip(bufs, words):
            buf.copy_(w, non_blocking=True)
        end.record(side)
    torch.cuda.synchronize()
    upload_ms = start.elapsed_time(end) / len(words)
    layer_bytes = words[0].numel() * words[0].element_size()
    bound = layer_bytes / PCIE_BYTES_PER_S * 1e3
    del bufs
    print(f"serve through the StreamUploader: tokens equal to the resident "
          f"int3 serve's: {tokens_equal}; ms/decode step through the "
          f"uploader {[round(x, 3) for x in ms_up]}, median "
          f"{np.median(ms_up):.3f}; from the restored tree's resident "
          f"streams {[round(x, 3) for x in ms_res]}, median "
          f"{np.median(ms_res):.3f} (the original tree's serve "
          f"{resident[1]:.3f}); uploader {stats[0]}; "
          f"{stats[0]['bytes_uploaded'] / max(1, stats[0]['uploads']):.0f} "
          f"bytes an upload; one layer's upload on the side stream "
          f"{upload_ms:.4f} ms, bound {bound:.4f} ms ({layer_bytes} bytes "
          f"at {PCIE_BYTES_PER_S / 1e9:.0f} GB/s, PCIe Gen5 x16 one "
          f"direction by the data sheet)")
    if not tokens_equal or any(st["sync_fetches"] != 1 for st in stats):
        raise AssertionError("uploader serve differs from the resident "
                             f"serve (uploader counters {stats})")
    return {"save_bytes": n_bytes, "save_s": save_s, "verify_s": verify_s,
            "verify_passes": report.passes,
            "restore_int3_wall_ms": wall3, "restore_int3_device_ms": dms,
            "restore_int3_copy_ms": cms, "restore_int3_rest_ms": rest_ms,
            "unpack_int3_device_ms": ums,
            "restore_int3_decode_launches": launches3,
            "restore_int4_wall_ms": wall4,
            "restore_int4_decode_launches": launches4,
            "kv_provenance": provenance, "kv_pages_equal": pages_equal,
            "decode_on_bit_equal": f"{on3}/{len(want)}",
            "int4_decode_bit_equal": f"{on4}/2",
            "refused": sorted(refusals),
            "uploader_serve_launches": counts,
            "uploader_tokens_equal": tokens_equal,
            "uploader_ms_per_step": ms_up,
            "restored_resident_ms_per_step": ms_res,
            "resident_ms_per_step": resident[1],
            "uploader_stats": stats[0], "upload_ms_per_layer": upload_ms,
            "upload_bound_ms": bound}


def layer_mats(cfg) -> dict[str, tuple[int, int]]:
    """(K, N) of each quantized matrix of a layer, by bundle name."""
    d, f = cfg.d_model, cfg.d_ff
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    return {"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wo": (q, d),
            "w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}


def host_pieces(tree, layer: int) -> dict[str, np.ndarray]:
    """Host unpack of one layer stream: bundle name -> uint64 pieces."""
    prog = tree.exec_program()
    names = [a.name for a in tree.layout().problem.arrays]
    out = prog.unpack_indexed(tree.streams[layer].cpu().numpy())
    return {names[i]: v for i, v in out.items()}


def n_units(dplan) -> int:
    """Units of the per-slot decode of a plan: one per slot, two for a
    slot wider than 32 bits (its low and high u32 fields)."""
    return dplan.n_units + sum(s.width > 32 for s in dplan.slots)


def front_door(cfg, tree3, dev):
    """``api.plan`` of one smollm layer as 14 element arrays (the codes
    and scale patterns of layer 0 of the int3 tree); numpy / cuda pack
    and numpy / cuda fused / cuda per-slot decode must agree with each
    other and with the codes; each decode is one launch.  Then the
    paper's example and the inverse Helmholtz problem.  Returns the plan,
    its packed buffer and the per-slot path's launches."""
    import torch

    from repro_torch import api
    from repro_torch.kernels import layout_decode as ld
    from repro_torch.kernels import layout_pack as lp

    g = tree3.spec.group_size
    mats = layer_mats(cfg)
    specs = []
    for name, (k, n) in mats.items():
        specs += [(name, 3, k * n, 0), (f"{name}_scales", 16, k * n // g, 0)]
    t0 = time.perf_counter()
    pl = api.plan(api.make_problem(4096, specs), cache=None)
    prog, dplan = pl.exec_program, pl.decode_plan
    plan_s = time.perf_counter() - t0
    pieces = host_pieces(tree3, 0)
    codes = {}
    for name, (k, n) in mats.items():
        codes[name] = pieces[name][:k * n]
        codes[f"{name}_scales"] = pieces[f"{name}_scales"][:k * n // g]
    print(f"front door: {pl.summary()}; {dplan.n_units} decode slots "
          f"(widest {max(s.width for s in dplan.slots)} bits), "
          f"{prog.kernel.lanes} fused-decode lanes, {prog.n_pieces} pieces; "
          f"planned and lowered in {plan_s:.2f} s")
    if pl.metrics.c_max != FRONT_DOOR_C_MAX.get(cfg.d_model):
        raise AssertionError(f"front door C_max {pl.metrics.c_max} != "
                             f"{FRONT_DOOR_C_MAX.get(cfg.d_model)}")
    torch.cuda.synchronize()
    lp.launches = ld.fused_launches = ld.slot_launches = 0
    host = pl.pack(codes)
    buf = pl.pack(codes, backend="cuda", device=dev)
    want = pl.decode(host)
    fused = pl.decode(buf, backend="cuda", device=dev)
    per_slot = pl.decode(buf, backend="cuda", fused=False, device=dev)
    torch.cuda.synchronize()
    counts = {"pack_layout_fused": lp.launches,
              "decode_layout_fused": ld.fused_launches,
              "decode_slot": ld.slot_launches}
    if not np.array_equal(buf, host):
        raise AssertionError("front door: cuda pack != numpy pack")
    for what, out in (("numpy", want), ("cuda fused", fused),
                      ("cuda per-slot", per_slot)):
        bad = [k for k in codes if not np.array_equal(out[k], codes[k])]
        if bad:
            raise AssertionError(f"front door {what} decode differs: {bad}")
    if counts != {"pack_layout_fused": 1, "decode_layout_fused": 1,
                  "decode_slot": 1}:
        raise AssertionError(f"front door launches {counts}")
    print(f"front door: cuda pack == numpy pack ({buf.nbytes} B); numpy, "
          f"cuda fused and cuda per-slot decodes == the layer's codes "
          f"({len(codes)} arrays); launches {counts}; the per-slot launch "
          f"covers {n_units(dplan)} units")
    cmp = api.compare(api.PAPER_EXAMPLE, cache=None)
    print("compare(PAPER_EXAMPLE): " + "; ".join(
        f"{k} C_max={v.c_max} L_max={v.l_max} B_eff={v.efficiency:.4f}"
        for k, v in cmp.items()))
    if [cmp[k].c_max for k in ("naive", "homogeneous", "hls_padded",
                               "iris")] != [19, 13, 13, 9]:
        raise AssertionError("compare(PAPER_EXAMPLE) C_max != 19/13/13/9")
    for name, prob in (("PAPER_EXAMPLE", api.PAPER_EXAMPLE),
                       ("INV_HELMHOLTZ", api.INV_HELMHOLTZ)):
        p2 = api.plan(prob, cache=None)
        c2 = api.random_codes(prob, seed=0)
        torch.cuda.synchronize()
        lp.launches = ld.fused_launches = ld.slot_launches = 0
        b2 = p2.pack(c2, backend="cuda", device=dev)
        outs = [p2.decode(b2, backend="cuda", device=dev),
                p2.decode(b2, backend="cuda", fused=False, device=dev)]
        torch.cuda.synchronize()
        got = (lp.launches, ld.fused_launches, ld.slot_launches)
        if not np.array_equal(b2, p2.pack(c2)) or not all(
                np.array_equal(o[k], c2[k]) for o in outs for k in c2):
            raise AssertionError(f"{name}: cuda round trip failed")
        if got != (1, 1, 1):
            raise AssertionError(f"{name}: launches {got}, expected "
                                 f"(1, 1, 1)")
        print(f"{name}: cuda pack == numpy pack; cuda fused and per-slot "
              f"decodes == codes; {len(p2.exec_program.host_arrays)} of "
              f"{len(prob.arrays)} arrays wider than 32 bits, on the "
              f"kernels as two u32 fields; launches pack/fused/per-slot "
              f"{got}, the per-slot launch covering "
              f"{n_units(p2.decode_plan)} units")
    return pl, buf, counts["decode_slot"]


def quantized(params, spec) -> dict:
    """Each quantized matrix of the stack, by tree key: ``quantize`` of
    the dense weights (codes (L, K, N), scales (L, K/g, N))."""
    from repro_torch.quant import quantize

    blocks = params["blocks"][0]
    return {key: quantize(blocks[key.split("/")[0]][key.split("/")[1]],
                          spec) for key in MM_KEYS}


def host_pack(tree, params, qts, layer: int) -> np.ndarray:
    """Layer ``layer``'s stream packed on the host by ``pack_compiled``
    from the quantized codes, scale and norm bit patterns."""
    from repro_torch.core.exec_plan import pack_compiled
    from repro_torch.core.util import pad_bundle_elements
    from repro_torch.quant import bits16

    blocks = params["blocks"][0]
    norms = {"attn_norm": "norm1", "mlp_norm": "norm2"}
    data = {}
    for b in tree.manifest.bundle:
        if b.name in norms:
            v = bits16(blocks[norms[b.name]]["scale"][layer])
        else:
            name = b.name.removesuffix("_scales")
            key = next(k for k in MM_KEYS if k.endswith("/" + name))
            v = qts[key].codes[layer] if name == b.name \
                else bits16(qts[key].scales[layer])
        data[b.name] = v.reshape(-1).cpu().numpy()
    prog, lay = tree.exec_program(), tree.layout()
    return pack_compiled(lay, pad_bundle_elements(lay.problem, prog, data),
                         program=prog)


def counted_pack_tree(cfg, params, spec, dev) -> tuple:
    """``pack_tree`` with the pack launches counted from 0 just before it
    and read just after, and layer 0's pieces kept as ``pack_tree`` hands
    them to ``pack_pieces``.  Returns the tree, the launches and those
    pieces."""
    import torch

    from repro_torch import tree as tree_mod
    from repro_torch.kernels import layout_pack as lp

    handed = []
    real = tree_mod.pack_pieces

    def keep(prog, streams):
        if not handed:
            handed.extend(streams)
        return real(prog, streams)

    tree_mod.pack_pieces = keep
    try:
        torch.cuda.synchronize()
        lp.launches = 0
        tree = tree_mod.pack_tree(cfg, params, spec, device=dev)
        torch.cuda.synchronize()
        launches = lp.launches
    finally:
        tree_mod.pack_pieces = real
    return tree, launches, handed


def int4_pack(cfg, params, dev):
    """``pack_tree(int4/g32)`` at full width and depth, one
    ``pack_layout_fused`` launch per layer: every layer stream byte-equal
    to the host ``pack_compiled`` of the quantized pieces.  Returns the
    tree, its quantized matrices, the pack launches and layer 0's pieces
    as ``pack_tree`` handed them over."""
    from repro_torch.quant import QuantSpec

    spec = QuantSpec(bits=4, group_size=32)
    t0 = time.perf_counter()
    tree, launches, handed = counted_pack_tree(cfg, params, spec, dev)
    t_cuda = time.perf_counter() - t0
    qts = quantized(params, spec)
    t0 = time.perf_counter()
    same = sum(np.array_equal(tree.streams[la].cpu().numpy(),
                              host_pack(tree, params, qts, la))
               for la in range(tree.n_layers))
    t_host = time.perf_counter() - t0
    print(f"pack int4: {tree.summary()}; pack_tree {t_cuda:.2f} s "
          f"({launches} pack_layout_fused launches); host pack_compiled "
          f"{t_host:.2f} s; {same}/{tree.n_layers} layer streams byte-equal")
    if same != tree.n_layers or launches != tree.n_layers:
        raise AssertionError("int4 pack_tree differs from the host pack")
    return tree, qts, launches, handed


def stack_decode(trees, dev) -> int:
    """The restore path: ``unpack_streams`` of each tree (one
    ``decode_layout_fused`` launch per layer, counted) rebuilds scales and
    views equal to the tree's.  Then each layer's decode is held against
    the host unpack, the quantized codes and the bf16 scale patterns (for
    a tree with lane-packed views, also the views against
    ``pack_codes_u32`` of the decoded codes).  ``trees``: ``(tree,
    quantized matrices)`` pairs.  Returns the restore's launches."""
    import torch

    from repro_torch.kernels import layout_decode as ld
    from repro_torch.quant import bits16, pack_codes_u32
    from repro_torch.tree import unpack_streams

    launches = 0
    for tree, qts in trees:
        prog, lay = tree.exec_program(), tree.layout()
        g = tree.spec.group_size
        torch.cuda.synchronize()
        ld.fused_launches = 0
        t0 = time.perf_counter()
        back = unpack_streams(tree.manifest, tree.streams, tree.other,
                              device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        n_dec = ld.fused_launches
        launches += n_dec
        restore_dms, restore_events = device_call(
            lambda: unpack_streams(tree.manifest, tree.streams, tree.other,
                                   device=dev), iters=2)
        rebuilt = all(torch.equal(back.scales[k].view(torch.int16),
                                  v.view(torch.int16))
                      for k, v in tree.scales.items()) and \
            sorted(back.packed) == sorted(tree.packed) and \
            all(torch.equal(back.packed[k], v) for k, v in tree.packed.items())
        bad, views_ok = [], 0
        for la in range(tree.n_layers):
            out = ld.decode_layout_fused(lay, tree.streams[la], program=prog)
            host = host_pieces(tree, la)
            for name, v in host.items():
                if not np.array_equal(out[name].cpu().numpy()
                                      .astype(np.uint64), v):
                    bad.append((la, name, "host unpack"))
            views = True
            for key, (k, n) in tree.shapes.items():
                b = key.split("/")[1]
                codes = out[b][:k * n].reshape(k, n)
                if not torch.equal(codes, qts[key].codes[la].to(torch.int64)):
                    bad.append((la, b, "codes"))
                pat = bits16(qts[key].scales[la]).reshape(-1)
                if not torch.equal(out[f"{b}_scales"][:k * n // g],
                                   pat.to(torch.int64)):
                    bad.append((la, b, "scales"))
                if tree.packed and not torch.equal(
                        pack_codes_u32(codes, tree.spec.bits),
                        tree.packed[key][la]):
                    views = False
            views_ok += views
        views_note = (f"; kernel views == pack_codes_u32(decoded codes) in "
                      f"{views_ok}/{tree.n_layers} layers") \
            if tree.packed else ""
        print(f"restore int{tree.spec.bits}: unpack_streams "
              f"({back.provenance}) of {tree.n_layers} layers in "
              f"{restore_s * 1e3:.1f} ms wall, device "
              f"{fmt_ms(restore_dms)} ms over {restore_events} device "
              f"events ({n_dec} decode_layout_fused launches) rebuilds "
              f"scales{' and views' if tree.packed else ''}"
              f" equal to the tree's: {rebuilt}; "
              f"{tree.n_layers - len({b[0] for b in bad})}/{tree.n_layers} "
              f"layer decodes equal to the host unpack, the quantized codes "
              f"and the scale patterns{views_note}")
        if bad or not rebuilt or n_dec != tree.n_layers or (
                tree.packed and views_ok != tree.n_layers):
            raise AssertionError(f"restore int{tree.spec.bits}: "
                                 f"{bad[:5]} rebuilt={rebuilt}")
    return launches


def check_packed_matmul(tree, rng, dev) -> dict:
    """Each of the 7 int4 matrices at M in {1, 4, 8} against the plain
    version, and bit-equal to ``stream_matmul`` over the same layer's
    stream; timed at M=4, the served batch; plus one ragged shape."""
    import torch

    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.quant import QuantSpec, pack_codes_u32, quantize

    from repro_torch.kernels.stream_matmul import matmul_launch

    bits, g = tree.spec.bits, tree.spec.group_size
    max_err = 0.0
    layer = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
             "library_device_ms": 0.0, "bytes": 0, "flops": 0}
    wide = []
    for key in MM_KEYS:
        pw, sc = tree.packed[key][0], tree.scales[key][0]
        k, n = sc.shape[0] * g, sc.shape[1]
        wide.append(wide_matmul(
            "packed_matmul", key, lambda x, pw=pw, sc=sc:
            pm.packed_matmul(x, pw, sc, bits=bits, group_size=g),
            lambda x, pw=pw, sc=sc: pm.packed_matmul_plain(
                x, pw, sc, bits=bits, group_size=g), pm,
            "packed_matmul_kernel", k, n, pw.numel() * 4 + sc.numel() * 2,
            rng, dev))
        for m in (1, 4, 8):
            x = torch.from_numpy(rng.standard_normal((m, k), np.float32)).to(dev)
            got = pm.packed_matmul(x, pw, sc, bits=bits, group_size=g)
            want = pm.packed_matmul_plain(x, pw, sc, bits=bits, group_size=g)
            streamed = tree.matmul_direct(x, key, 0)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            if not torch.allclose(got, want, rtol=MM_RTOL, atol=MM_ATOL):
                raise AssertionError(
                    f"packed_matmul {key} M={m}: max |err| {err:.3g}")
            if not torch.equal(got, streamed):
                raise AssertionError(f"packed_matmul {key} M={m} differs "
                                     f"from stream_matmul")
            if m != SERVE_M:
                continue
            dense = pm.packed_matmul_plain(torch.eye(k, device=dev), pw, sc,
                                           bits=bits, group_size=g)
            ms = time_ms(lambda: pm.packed_matmul(x, pw, sc, bits=bits,
                                                  group_size=g))
            dms = device_ms(lambda: pm.packed_matmul(
                x, pw, sc, bits=bits, group_size=g), "packed_matmul_kernel")
            pms = time_ms(lambda: pm.packed_matmul_plain(
                x, pw, sc, bits=bits, group_size=g), iters=5)
            lms = time_ms(lambda: torch.matmul(x, dense))
            ldms = device_ms(lambda: torch.matmul(x, dense), None)
            nbytes = (x.numel() * 4 + pw.numel() * 4 + sc.numel() * 2
                      + m * n * 4)
            flops = 2 * m * k * n
            bms, _ = bound_ms(nbytes, flops)
            print(f"packed_matmul {key:11s} K={k:5d} N={n:5d} M={m}: "
                  f"kernel {ms:.4f} ms (device {fmt_ms(dms)} ms, grid "
                  f"{matmul_launch(m, k, n)[1]})  plain {pms:.4f} ms  "
                  f"library(matmul of dequantized W) {lms:.4f} ms (device "
                  f"{fmt_ms(ldms)} ms)  bound {bms:.5f} ms  max|err| "
                  f"{err:.3g}")
            layer["ms"] += ms
            layer["device_ms"] = add_ms(layer["device_ms"], dms)
            layer["plain_ms"] += pms
            layer["library_ms"] += lms
            layer["library_device_ms"] = add_ms(
                layer["library_device_ms"], ldms)
            layer["bytes"] += nbytes
            layer["flops"] += flops
    # one ragged shape: N and M off the tiles
    k, n, m = 96, 77, 3
    w = torch.from_numpy(rng.standard_normal((k, n), np.float32)).to(dev)
    qt = quantize(w, QuantSpec(bits=bits, group_size=g))
    pw = pack_codes_u32(qt.codes, bits)
    x = torch.from_numpy(rng.standard_normal((m, k), np.float32)).to(dev)
    got = pm.packed_matmul(x, pw, qt.scales, bits=bits, group_size=g)
    want = pm.packed_matmul_plain(x, pw, qt.scales, bits=bits, group_size=g)
    err = float((got - want).abs().max())
    max_err = max(max_err, err)
    if not torch.allclose(got, want, rtol=MM_RTOL, atol=MM_ATOL):
        raise AssertionError(f"packed_matmul ragged: max |err| {err:.3g}")
    bms, by = bound_ms(layer["bytes"], layer["flops"])
    print(f"packed_matmul ragged int{bits} K={k} N={n} M={m}: max|err| "
          f"{err:.3g}")
    print(f"packed_matmul, one layer's 7 matmuls at M={SERVE_M}: kernel "
          f"{layer['ms']:.4f} ms back to back (device "
          f"{fmt_ms(layer['device_ms'])} ms, "
          f"{fmt_ms(layer['device_ms'] and layer['device_ms'] / 7)} ms per "
          f"launch)  plain {layer['plain_ms']:.4f} ms  library "
          f"{layer['library_ms']:.4f} ms (device "
          f"{fmt_ms(layer['library_device_ms'])} ms)  bound {bms:.5f} ms "
          f"({by}; "
          f"{layer['bytes']} B, {layer['flops']} f32 FLOPs); bit-equal to "
          f"stream_matmul on every matrix")
    return {"max_abs_err": max_err, "ms": layer["ms"],
            "device_ms": layer["device_ms"],
            "plain_ms": layer["plain_ms"], "bound_ms": bms, "bound_by": by,
            "library_ms": layer["library_ms"],
            "library_device_ms": layer["library_device_ms"],
            "wide": wide_layer("packed_matmul", wide,
                               {**layer, "bound_ms": bms})}


def pack_words_flat(prog, pieces: dict) -> np.ndarray:
    """``pack_words``' flat u32 stream of a layer's pieces (the host
    unpack): a zero sentinel, every piece's low 32 bits in piece order,
    then the high halves of the pieces wider than 32 bits."""
    n = len(prog.piece_depths)
    low = [pieces[i] for i in range(n)]
    high = [pieces[i] >> np.uint64(32) for i in prog.host_arrays]
    return np.concatenate([np.zeros(1, np.uint64), *low, *high]) \
        .astype(np.uint32)


def check_pack_kernel(packs, dev) -> dict:
    """The whole ``pack_pieces`` of layer 0 of each tree (one
    ``pack_runs`` launch), from the pieces as ``pack_tree`` handed them
    over, against ``pack_runs_plain``, ``pack_words`` (the TPU kernel's
    form, over the flat u32 stream of the same pieces) and the layer's
    stream; timed back to back and on the device (every device event of
    the call's profiler window, which must hold one kernel).  Beside it
    ``pack_words``, held against its plain version.  The run table (and
    ``pack_words``' contribution tables) serve every layer: the bound
    counts them once per stack.  ``packs``: ``(tree, pieces)`` pairs.
    Returns the int4 tree's row."""
    import torch

    from repro_torch.kernels import layout_pack as lp
    from repro_torch.kernels.ref import words_tensor

    rows = {}
    for tree, streams in packs:
        prog = tree.exec_program()
        bits = tree.spec.bits
        table = lp.device_pack_runs(prog, dev)
        got = lp.pack_pieces(prog, streams)
        plain = lp.pack_runs_plain(table.runs, streams, prog.c_max,
                                   prog.words32)
        flat_t = words_tensor(
            pack_words_flat(prog, prog.unpack_indexed(
                tree.streams[0].cpu().numpy())), dev)
        src, scode = lp.device_pack_tables(prog, dev)
        words = lp.pack_words(flat_t, src, scode)
        torch.cuda.synchronize()
        if not torch.equal(got, tree.streams[0]) \
                or not torch.equal(lp.pack_runs(table, streams), plain) \
                or not torch.equal(words, plain.reshape(-1)):
            raise AssertionError(f"pack_layout_fused int{bits}: pack_pieces "
                                 "differs from pack_runs_plain, pack_words "
                                 "or the layer's stream")
        if not torch.equal(words, lp.pack_words_plain(flat_t, src, scode)):
            raise AssertionError("pack_words differs from its plain version")

        def call():
            lp.pack_pieces(prog, streams)

        before = lp.launches
        call()
        if lp.launches != before + 1:
            raise AssertionError(f"pack_pieces: {lp.launches - before} "
                                 "launches a call, expected 1")
        ms = time_ms(call)
        dms = one_kernel_ms(call, "pack_runs_kernel",
                            f"pack_layout_fused int{bits}")
        kms = device_ms(lambda: lp.pack_runs(table, streams),
                        "pack_runs_kernel")
        pms = time_ms(lambda: lp.pack_runs_plain(
            table.runs, streams, prog.c_max, prog.words32), iters=3)
        in_bytes = sum(s.numel() * s.element_size() for s in streams)
        out_bytes = got.numel()
        tab_bytes = (table.runs.numel() + table.row_start.numel()) * 4
        nbytes = in_bytes + prog.c_max * prog.words32 * 4
        bms, by = bound_ms(nbytes + tab_bytes / tree.n_layers, 0)
        cold, cold_by = bound_ms(nbytes + tab_bytes, 0)
        print(f"pack_layout_fused int{bits} layer (whole pack_pieces call): "
              f"{prog.n_pieces} pieces of {len(streams)} arrays "
              f"({', '.join(sorted({str(s.dtype) for s in streams}))}), "
              f"{table.runs.shape[0]} runs, {out_bytes} B out: {ms:.4f} ms "
              f"(device {fmt_ms(dms)} ms, 1 kernel a call; the kernel "
              f"{fmt_ms(kms)} ms)  plain {pms:.4f} ms  library none  "
              f"bound {bms:.6f} ms ({by}; {in_bytes} B of arrays as stored "
              f"+ {prog.c_max * prog.words32 * 4} B out, with the "
              f"{tab_bytes} B run table over {tree.n_layers} layers); "
              f"cold-L2 bound {cold:.6f} ms ({cold_by})  max|err| 0")
        wms = time_ms(lambda: lp.pack_words(flat_t, src, scode))
        wdms = device_ms(lambda: lp.pack_words(flat_t, src, scode),
                         "pack_fused_kernel")
        wtab = (src.numel() + scode.numel()) * 4
        wbytes = flat_t.numel() * 4 + words.numel() * 4
        wbms, _ = bound_ms(wbytes + wtab / tree.n_layers, 0)
        print(f"pack_words int{bits} layer (the TPU kernel's form): "
              f"K={src.shape[0]}, {words.numel()} words: kernel {wms:.4f} ms "
              f"(device {fmt_ms(wdms)} ms)  bound {wbms:.6f} ms (bytes; "
              f"{wbytes} B with the {wtab} B of tables over {tree.n_layers} "
              f"layers)  == plain")
        rows[bits] = {"max_abs_err": 0.0, "ms": ms, "device_ms": dms,
                      "kernel_device_ms": kms, "plain_ms": pms,
                      "bound_ms": bms, "bound_by": by, "cold_bound_ms": cold,
                      "library_ms": None,
                      "pack_words": {"ms": wms, "device_ms": wdms,
                                     "bound_ms": wbms}}
    return rows[4]


def check_decode_kernel(trees, dev) -> dict:
    """The whole ``decode_layout_fused`` of one layer of each tree (one
    ``decode_pieces`` launch), against the plain version and against the
    TPU kernel's form (``decode_grid_plain``, then the gather and the
    halves joined); timed back to back and on the device (every kernel of
    the call's profiler window, which must hold one), with the
    ``decode_grid`` kernel beside it, held against ``decode_grid_plain``.
    The descriptors (and the grid's
    slot table) serve every layer: the bound counts them once per stack.
    Returns the first tree's row."""
    import torch

    from repro_torch.kernels import layout_decode as ld
    from repro_torch.kernels.ref import U32

    rows = []
    for tree in trees:
        prog, lay = tree.exec_program(), tree.layout()
        buf = tree.streams[0]
        words = tree.layer_stream_words(0).reshape(prog.c_max, prog.words32)
        desc = ld.device_piece_table(prog, dev)
        got = ld.decode_pieces(words, desc)
        tab, flat = ld.device_decode_tables(prog, dev)
        fields = ld.decode_grid_plain(words, tab).reshape(-1)[flat] \
            .to(torch.int64) & U32
        grid_way = fields[:prog.n_pieces].clone()
        hi = prog.n_pieces
        for i in prog.host_arrays:
            lo, n = prog.piece_base[i], prog.piece_depths[i]
            grid_way[lo:lo + n] |= fields[hi:hi + n] << 32
            hi += n
        whole = ld.decode_layout_fused(lay, buf, program=prog)
        grid = ld.decode_grid(words, tab)
        torch.cuda.synchronize()
        if not torch.equal(got, ld.decode_pieces_plain(words, desc)) \
                or not torch.equal(got, grid_way) \
                or not torch.equal(got, torch.cat(list(whole.values()))):
            raise AssertionError("decode_layout_fused differs from its "
                                 "plain version or the grid's gather")
        if not torch.equal(grid, ld.decode_grid_plain(words, tab)):
            raise AssertionError("decode_grid differs from its plain "
                                 "version")

        def call():
            ld.decode_layout_fused(lay, buf, program=prog)

        before = ld.fused_launches
        call()
        if ld.fused_launches != before + 1:
            raise AssertionError("decode_layout_fused: "
                                 f"{ld.fused_launches - before} launches a "
                                 "call, expected 1")
        ms = time_ms(call)
        dms = one_kernel_ms(call, "decode_pieces_kernel",
                            f"decode_layout_fused int{tree.spec.bits}")
        kms = device_ms(lambda: ld.decode_pieces(words, desc),
                        "decode_pieces_kernel")
        pms = time_ms(lambda: ld.decode_pieces_plain(words, desc), iters=5)
        desc_bytes = desc.numel() * desc.element_size()
        nbytes = words.numel() * 4 + got.numel() * 8
        bms, by = bound_ms(nbytes + desc_bytes / tree.n_layers, 0)
        cold, cold_by = bound_ms(nbytes + desc_bytes, 0)
        gms = time_ms(lambda: ld.decode_grid(words, tab))
        gdms = device_ms(lambda: ld.decode_grid(words, tab),
                         "decode_grid_kernel")
        gbytes = words.numel() * 4 + tab.numel() * 4
        gbms, _ = bound_ms(gbytes + tab.numel() * 4 / tree.n_layers, 0)
        print(f"decode_layout_fused int{tree.spec.bits} layer (whole call): "
              f"{got.numel()} pieces of {len(prog.piece_depths)} arrays "
              f"into int64: {ms:.4f} ms (device {fmt_ms(dms)} ms, "
              f"1 kernel a call; the kernel {fmt_ms(kms)} ms)  "
              f"plain {pms:.4f} ms  library none  bound {bms:.6f} ms ({by}; "
              f"{nbytes} B with the {desc_bytes} B of descriptors over "
              f"{tree.n_layers} layers); cold-L2 bound {cold:.6f} ms "
              f"({cold_by})  max|err| 0")
        print(f"decode_grid int{tree.spec.bits} layer (the TPU kernel's "
              f"grid): {prog.c_max} x {tab.shape[1]} entries: kernel "
              f"{gms:.4f} ms (device {fmt_ms(gdms)} ms)  bound {gbms:.6f} ms "
              f"(bytes, the grid written as int32)  == plain")
        rows.append({"max_abs_err": 0.0, "ms": ms, "device_ms": dms,
                     "kernel_device_ms": kms, "plain_ms": pms,
                     "bound_ms": bms, "bound_by": by, "cold_bound_ms": cold,
                     "library_ms": None,
                     "grid": {"ms": gms, "device_ms": gdms,
                              "bound_ms": gbms}})
    return rows[0]


def check_decode_slot(pl, buf, dev) -> dict:
    """The front door's whole per-slot decode (``decode_layout(fused=
    False)``: every unit of the plan in one ``decode_units`` launch)
    against the plain version, timed back to back and on the device
    (every kernel of its profiler window, which must hold one); then a
    sample of the units, one ``decode_slot`` call each, against
    ``decode_slot_plain``."""
    import torch

    from repro_torch.kernels import layout_decode as ld
    from repro_torch.kernels.ops import buffer_to_u32, decode_layout

    plan = pl.decode_plan
    dbuf = torch.from_numpy(buf).to(dev)
    rows = ld.rows_u32(dbuf)
    table = ld.device_unit_table(plan, pl.problem, dev)
    got = ld.decode_units(rows, table)
    torch.cuda.synchronize()
    if not torch.equal(got, ld.decode_units_plain(rows, table)):
        raise AssertionError("decode_units differs from its plain version")

    def call():
        decode_layout(pl.layout, dbuf, plan=plan, fused=False)

    before = ld.slot_launches
    call()
    if ld.slot_launches != before + 1:
        raise AssertionError(f"the per-slot decode: "
                             f"{ld.slot_launches - before} launches a call, "
                             "expected 1")
    ms = time_ms(call)
    dms = one_kernel_ms(call, "decode_units_kernel", "the per-slot decode")
    kms = device_ms(lambda: ld.decode_units(rows, table),
                    "decode_units_kernel")
    pms = time_ms(lambda: ld.decode_units_plain(rows, table), iters=3,
                  warmup=1)
    words = buffer_to_u32(dbuf)
    sample = plan.slots[::max(1, len(plan.slots) // 50)]
    for s in sample:
        offs = torch.tensor([s.bit_offset + j * s.width
                             for j in range(s.lanes)], dtype=torch.int32,
                            device=dev)
        slab = words[s.start_cycle:s.start_cycle + s.n_cycles]
        w = min(s.width, 32)
        if not torch.equal(ld.decode_slot(slab, offs, w),
                           ld.decode_slot_plain(slab, offs, w)):
            raise AssertionError("decode_slot differs from its plain "
                                 "version")
    tab_bytes = table.units.numel() * 4 + table.prefix.numel() * 4
    nbytes = dbuf.numel() + tab_bytes + got.numel() * 8
    bms, by = bound_ms(nbytes, 0)
    print(f"decode_slot, the front door's whole per-slot decode: "
          f"{table.units.shape[0]} units, {table.n_fields} codes into int64 "
          f"in 1 launch: {ms:.4f} ms (device {fmt_ms(dms)} ms, 1 kernel "
          f"a call; the kernel {fmt_ms(kms)} ms)  plain "
          f"{pms:.4f} ms  library none  bound {bms:.6f} ms ({by}; {nbytes} "
          f"B)  max|err| 0; {len(sample)} one-unit decode_slot calls == "
          f"plain")
    return {"max_abs_err": 0.0, "ms": ms, "device_ms": dms,
            "kernel_device_ms": kms, "plain_ms": pms, "bound_ms": bms,
            "bound_by": by, "library_ms": None}


def profile_steps(engine, prompts, label: str, n_steps: int = 4) -> None:
    """``torch.profiler`` over a few steady steps of ``engine`` (4 of
    ``prompts``, 64 new tokens each): time by operator, and the device's
    busy share of the window's wall time."""
    from repro_torch.engine import EngineRequest

    for uid, prompt in enumerate(prompts[:4]):
        engine.submit(EngineRequest(uid=uid, prompt=prompt,
                                    max_new_tokens=64))
    for _ in range(3):
        engine.step()
    profile_window(engine.step, label, n_steps)


def profile_window(step, label: str, n_steps: int) -> dict:
    """``torch.profiler`` over ``n_steps`` calls of ``step``: prints the
    time by operator and the device's busy share of the window's wall
    time; returns the window's wall ms, device-busy ms and the device
    ms of its ten longest device operations."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    key = "self_device_time_total" if hasattr(events[0],
                                              "self_device_time_total") \
        else "self_cuda_time_total"
    # device-side rows only (kernels, memcpy/memset): the aten rows repeat
    # the time of the kernels they launched
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(getattr(e, key) for e in dev)
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    print(f"profile ({label}): {n_steps} steps in {wall * 1e3:.2f} ms wall "
          f"(profiler on); device busy {dev_us / 1e3:.2f} ms "
          f"({dev_us / 1e4 / wall:.1f}% of wall); "
          f"{launches / n_steps:.0f} kernel launches per step")
    print(events.table(sort_by="self_cpu_time_total", row_limit=18,
                       max_name_column_width=48))
    print(events.table(sort_by=key, row_limit=12, max_name_column_width=48))
    top = sorted(dev, key=lambda e: -getattr(e, key))[:10]
    return {"wall_ms": wall * 1e3, "device_busy_ms": dev_us / 1e3,
            "top_device_ms": {e.key[:80]: getattr(e, key) / 1e3
                              for e in top}}


def jamba_config():
    """jamba-1.5-large-398b at its full widths, cut to fit one card:
    returns (config, the cuts as text)."""
    import dataclasses

    from repro_torch.configs import JAMBA_1_5_LARGE

    cfg = dataclasses.replace(JAMBA_1_5_LARGE, n_layers=8, moe=None)
    cuts = ("n_layers 72 -> 8 (one period: 7 Mamba + 1 GQA attention "
            "sublayer); moe -> None, a memory cut (the port runs MoE "
            "sublayers, moonshot-v1-16b-a3b's below; here every sublayer "
            f"takes the dense MLP of d_ff {cfg.d_ff}: the period's 4 MoE "
            "sublayers, 16 experts x 3 x 8192 x 24576 bf16 = 19.3 GB each, "
            "77 GB, would not fit one card beside the rest)")
    return cfg, cuts


def param_leaves(tree):
    """(container, key, tensor) for every leaf of a parameter tree."""
    stack = [tree]
    while stack:
        node = stack.pop()
        for key, val in list(node.items() if isinstance(node, dict)
                             else enumerate(node)):
            if isinstance(val, (dict, list)):
                stack.append(val)
            else:
                yield node, key, val


def mem_gb() -> float:
    import torch

    return torch.cuda.max_memory_allocated() / 1e9


def scan_bound(q, v, out) -> tuple[float, str, float, int]:
    """Least time of one ssd_scan call as the kernel computes it (tensor
    cores): q/k/v/logw read once and the output written once, against its
    FLOPs with the masked triangle skipped (2 C(C+1)/2 (dk + dv) for the
    scores and their product with v, 2 C dk dv each for the carried
    state's read and update, per chunk of the kernel's tile C) at the bf16
    tensor-core peak.  Returns it, what bounds it, the f32 CUDA-core
    figure (the bound of the first design) and the tile."""
    from repro_torch.kernels.linear_scan import scan_launch

    b, t, h, dk = q.shape
    dv = v.shape[-1]
    c = scan_launch(b, h, dk, dv, q.element_size())[0]
    n_chunks = -(-t // c)
    nbytes = (2 * q.numel() * q.element_size() + v.numel() * v.element_size()
              + b * t * h * 4 + out.numel() * out.element_size())
    flops = b * h * n_chunks * (c * (c + 1) * (dk + dv) + 4 * c * dk * dv)
    tb, tt = nbytes / HBM_BYTES_PER_S, flops / BF16_TC_FLOPS
    f32 = max(tb, flops / F32_FLOPS) * 1e3
    return max(tb, tt) * 1e3, "bytes" if tb >= tt else "operations", f32, c


def sweep_scan_launch(q, k, v, logw, want) -> None:
    """Every (tile, dv slice) launch shape of ``ssd_scan`` whose block fits
    at these inputs, each held against the plain output ``want`` and timed
    back to back: the evidence for the shape ``scan_launch`` picks."""
    import torch

    from repro_torch.kernels import linear_scan as ls

    b, _, h, dk = q.shape
    dv = v.shape[-1]
    orig = ls.scan_launch
    pick = orig(b, h, dk, dv, q.element_size())
    times = []
    try:
        for tile in (64, 32, 16):
            for dvs in (64, 32, 16):
                smem = ls.scan_smem(tile, dvs, dk, q.element_size())
                strips = dvs // 16 * -(-dk // 64)
                if dvs > -(-dv // 16) * 16 or strips > 8 \
                        or smem > ls.MAX_SMEM:
                    continue
                ls.scan_launch = lambda *a, s=(tile, dvs, smem): s
                got = ls.ssd_scan(q, k, v, logw)
                torch.cuda.synchronize()
                if not torch.allclose(got.float(), want.float(),
                                      **SCAN_BF16_TOL):
                    raise AssertionError(f"ssd_scan tile {tile} dv slice "
                                         f"{dvs} differs from plain")
                ms = time_ms(lambda: ls.ssd_scan(q, k, v, logw), iters=10)
                times.append(f"{tile}/{dvs} {ms:.4f}")
    finally:
        ls.scan_launch = orig
    print(f"ssd_scan launch shapes at B={b} H={h} dk={dk} dv={dv} "
          f"{q.dtype} (tile/dv slice ms; picked {pick[0]}/{pick[1]}): "
          + ", ".join(times))


def check_ssd_scan(cfg, params, toks, rng, dev) -> dict:
    """The kernel against its plain version on the layer-0 Mamba inputs of
    the real prefill (bf16, timed) and on a ragged f32 case (T=1000 of
    the same inputs, widened, with a random state0 and the final state)."""
    import torch

    from repro_torch.kernels import linear_scan as ls
    from repro_torch.models.layers import apply_norm
    from repro_torch.models.mamba import _ssm_inputs
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import period_params

    p0 = period_params(params["blocks"][0], 0)
    h = apply_norm(cfg, p0["norm1"], Model(cfg)._embed(params, toks))
    _, _, bk, cq, v, log_a = _ssm_inputs(cfg, p0["mamba"], h)
    got = ls.ssd_scan(cq, bk, v, log_a)
    want = ls.ssd_scan_plain(cq, bk, v, log_a)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if got.dtype != cq.dtype or not torch.isfinite(got).all() or \
            not torch.allclose(got.float(), want.float(), **SCAN_BF16_TOL):
        raise AssertionError(f"ssd_scan bf16 prefill inputs: max |err| "
                             f"{err:.3g}")
    t_r = 1000
    args32 = [a[:, :t_r].float() for a in (cq, bk, v)] + [log_a[:, :t_r]]
    s0 = torch.from_numpy(rng.standard_normal(
        (cq.shape[0], cq.shape[2], cq.shape[3], v.shape[3]),
        np.float32)).to(dev)
    g32, gs = ls.ssd_scan(*args32, state0=s0, return_state=True)
    w32, ws = ls.ssd_scan_plain(*args32, state0=s0, return_state=True)
    torch.cuda.synchronize()
    err32 = max(float((g32 - w32).abs().max()), float((gs - ws).abs().max()))
    if not (torch.allclose(g32, w32, **SCAN_F32_TOL)
            and torch.allclose(gs, ws, **SCAN_F32_TOL)):
        raise AssertionError(f"ssd_scan ragged f32: max |err| {err32:.3g}")
    sweep_scan_launch(cq, bk, v, log_a, want)
    ms = time_ms(lambda: ls.ssd_scan(cq, bk, v, log_a), iters=20)
    dms = device_ms(lambda: ls.ssd_scan(cq, bk, v, log_a), "ssd_scan_kernel",
                    iters=20)
    pms = time_ms(lambda: ls.ssd_scan_plain(cq, bk, v, log_a), iters=5)
    bms, by, f32, tile = scan_bound(cq, v, got)
    b, t, hh, dk = cq.shape
    _, dvs, smem = ls.scan_launch(b, hh, dk, v.shape[-1], cq.element_size())
    print(f"ssd_scan bf16 B={b} T={t} H={hh} dk={dk} dv={v.shape[-1]} "
          f"(layer-0 Mamba inputs of the prefill; tile {tile}, dv slice "
          f"{dvs}, {b * hh * -(-v.shape[-1] // dvs)} blocks of {smem} B): "
          f"kernel {ms:.4f} ms (device {fmt_ms(dms)} ms)  plain {pms:.4f} ms  "
          f"library none  bound {bms:.4f} ms ({by}, tensor cores; f32 "
          f"CUDA-core figure {f32:.4f} ms)  max|err| {err:.3g} (largest "
          f"|output| {float(want.float().abs().max()):.4g}); ragged f32 "
          f"T={t_r} with state0: max|err| (output, final state) "
          f"{err32:.3g} (largest |final state| {float(ws.abs().max()):.4g})")
    return {"max_abs_err": max(err, err32), "ms": ms, "device_ms": dms,
            "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": None}


def check_wide_scan(dev) -> dict:
    """``ssd_scan`` at Mamba-2's head widths (Dao & Gu, arXiv:2405.21060:
    d_state 128, head_dim 64), bf16, B=2, T=1024, H=256, seeded random
    inputs made on the card, against the plain version and timed."""
    import torch

    from repro_torch.kernels import linear_scan as ls

    b, t, h, dk, dv = PREFILL_B, PREFILL_T, 256, 128, 64
    gen = torch.Generator(device=dev).manual_seed(128)
    q, k = (0.5 * torch.randn((b, t, h, dk), generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    v = (0.5 * torch.randn((b, t, h, dv), generator=gen, device=dev)) \
        .to(torch.bfloat16)
    logw = -torch.nn.functional.softplus(
        0.5 * torch.randn((b, t, h), generator=gen, device=dev))
    got = ls.ssd_scan(q, k, v, logw)
    want = ls.ssd_scan_plain(q, k, v, logw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if not torch.isfinite(got).all() or \
            not torch.allclose(got.float(), want.float(), **SCAN_BF16_TOL):
        raise AssertionError(f"ssd_scan dk={dk} dv={dv}: max |err| "
                             f"{err:.3g}")
    ms = time_ms(lambda: ls.ssd_scan(q, k, v, logw), iters=20)
    dms = device_ms(lambda: ls.ssd_scan(q, k, v, logw), "ssd_scan_kernel",
                    iters=20)
    pms = time_ms(lambda: ls.ssd_scan_plain(q, k, v, logw), iters=3)
    bms, by, f32, tile = scan_bound(q, v, got)
    _, dvs, smem = ls.scan_launch(b, h, dk, dv, q.element_size())
    print(f"ssd_scan bf16 B={b} T={t} H={h} dk={dk} dv={dv} (Mamba-2's "
          f"d_state 128 x head_dim 64; tile {tile}, dv slice {dvs}, "
          f"{b * h * -(-dv // dvs)} blocks of {smem} B): kernel {ms:.4f} ms "
          f"(device {fmt_ms(dms)} ms)  plain {pms:.4f} ms  library none  "
          f"bound "
          f"{bms:.4f} ms ({by}, tensor cores; f32 CUDA-core figure "
          f"{f32:.4f} ms)  max|err| {err:.3g} (largest |output| "
          f"{float(want.float().abs().max()):.4g})")
    return {"max_abs_err": err, "ms": ms, "device_ms": dms, "plain_ms": pms,
            "bound_ms": bms, "bound_by": by, "library_ms": None}


def prefill_jamba(cfg, params, toks) -> int:
    """The main path's prefill: ``build_prefill_step`` at (B, T), with the
    ``ssd_scan`` launches counted.  Returns them."""
    import torch

    from repro_torch.kernels import linear_scan as ls
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models.transformer import n_periods, period_template

    step = build_prefill_step(cfg)
    torch.cuda.synchronize()
    ls.launches = 0
    t0 = time.perf_counter()
    logits, caches = step(params, {"tokens": toks})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ls.launches
    b, t = toks.shape
    n_mamba = n_periods(cfg) * sum(s.mixer == "mamba"
                                   for s in period_template(cfg))
    finite = bool(torch.isfinite(logits).all())
    shapes = [tuple(k.shape) for k, _ in caches]
    print(f"prefill jamba B={b} T={t}: logits {tuple(logits.shape)} "
          f"{logits.dtype} finite={finite}; attention caches (k, v) "
          f"{shapes}; ssd_scan launches {launches}; {wall * 1e3:.1f} ms "
          f"wall (first call); peak device memory {mem_gb():.2f} GB")
    want = (n_periods(cfg), b, t, cfg.n_kv_heads, cfg.head_dim)
    if logits.shape != (b, t, cfg.vocab_size) or not finite or \
            shapes != [want] or launches != n_mamba:
        raise AssertionError(f"prefill jamba: launches {launches} (expected "
                             f"{n_mamba}), caches {shapes}, finite {finite}")
    return launches


def decode_vs_prefill(cfg, params, toks, tol: dict, what: str,
                      frames=None) -> None:
    """Teacher-forced decode (``build_serve_step``: ``recurrent_step``,
    decode attention) against the prefill's logits (``ssd_scan`` or the
    RWKV scan, flash attention) over the same tokens.  An encoder-decoder
    prefills over ``frames`` and decodes over their cross K/V
    (``precompute_cross_kv`` of ``encode``).  Every logit within ``tol``;
    in f32 also the greedy argmax at every position."""
    import torch

    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.models.model import Model

    b, t = toks.shape
    batch, cross_kv = {"tokens": toks}, None
    if frames is not None:
        batch["frames"] = frames
        model = Model(cfg)
        cross_kv = model.precompute_cross_kv(params,
                                             model.encode(params, frames))
    par, _ = build_prefill_step(cfg)(params, batch)
    step = build_serve_step(cfg)
    state = Model(cfg).init_decode_state(b, 256, device=toks.device)
    seq = []
    for i in range(t):
        lg, state = step(params, state, toks[:, i], cross_kv)
        seq.append(lg)
    seq = torch.stack(seq, dim=1).float()
    par = par.float()
    err = float((seq - par).abs().max())
    top2 = par.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    agree = seq.argmax(-1) == par.argmax(-1)
    ok_tol = torch.allclose(seq, par, **tol)
    strict = cfg.dtype == "float32"
    print(f"decode == prefill ({what}), {b} prompts x {t} tokens: max "
          f"|dlogit| {err:.4g} (tolerance rtol {tol['rtol']} atol "
          f"{tol['atol']}; largest logit {float(par.abs().max()):.4g}); "
          f"greedy argmax equal at {int(agree.sum())}/{agree.numel()} "
          f"positions (prefill top-2 margins where not: "
          f"{[round(float(m), 5) for m in margin[~agree]]}; smallest margin "
          f"{float(margin.min()):.4g}); peak device memory {mem_gb():.2f} GB")
    if not ok_tol or (strict and not bool(agree.all())):
        raise AssertionError(f"decode != prefill ({what})")


def serve_dense(cfg, params, rng, label: str = "jamba") -> dict:
    """The unquantized serving path: Engine(DenseAdapter), 8 requests,
    batch 4, max_seq 256, prompts of 2-5 tokens, 8 new tokens each; ms per
    step against the decode step's bytes bound.  A step reads every
    weight of the decoder's blocks (for a MoE model every expert: the
    per-row capacity dispatch fills a slot of each; an encoder-decoder's
    cross-attention is skipped without cross K/V, as in the reference,
    and its encoder does not run), the final norm, the unembedding and 4
    rows of an untied embedding, and reads and writes the recurrent state
    (Mamba's, RWKV's) where there is one; the KV cache is left out, so
    this is a lower bound."""
    import torch

    from repro_torch.engine import (
        DenseAdapter,
        Engine,
        EngineConfig,
        EngineRequest,
    )
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.models.model import Model

    model = Model(cfg)
    engine = Engine(DenseAdapter(model, params),
                    EngineConfig(batch_size=4, max_seq=256,
                                 max_backlog=None))
    requests = [EngineRequest(uid=uid, prompt=rng.integers(
        1, cfg.vocab_size, int(rng.integers(2, 6))).tolist(),
        max_new_tokens=8) for uid in range(8)]
    for req in requests:
        engine.submit(req)
    torch.cuda.synchronize()
    ls.launches = 0
    t0 = time.perf_counter()
    stats = engine.run_until_drained(max_steps=500)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    def nbytes(tree) -> int:
        return sum(x.numel() * x.element_size()
                   for _, _, x in param_leaves(tree))

    emb = params["embed"]
    blocks = [{k: v for k, v in sub.items()
               if k not in ("cross", "norm_cross")}
              for sub in params["blocks"]]
    w_bytes = nbytes(blocks) + nbytes(params["final_norm"]) + (
        nbytes([emb]) if cfg.tie_embeddings
        else nbytes([params["unembed"]]) + 4 * cfg.d_model
        * emb.element_size())
    ssm = engine.state.get("ssm")
    state_bytes = sum(engine.state[k].numel() * engine.state[k]
                      .element_size() for k in ("ssm", "rwkv", "shift_t",
                                                "shift_c")
                      if k in engine.state)
    step_bytes = w_bytes + 2 * state_bytes
    bms = step_bytes / HBM_BYTES_PER_S * 1e3
    per_step = wall / max(1, stats.steps) * 1e3
    print(f"serve {label} (dense): completed={stats.completed}/"
          f"{len(requests)} steps={stats.steps} "
          f"tokens={stats.tokens_generated} wall={wall:.3f} s "
          f"tokens/s={stats.tokens_generated / wall:.2f} ms/decode step="
          f"{per_step:.3f} (bound {bms:.3f} ms: {step_bytes / 1e9:.2f} GB "
          f"at 3.35 TB/s, {per_step / bms:.1f}x)"
          + ("" if ssm is None else f"; ssd_scan launches {ls.launches}")
          + f"; peak device memory {mem_gb():.2f} GB")
    if stats.completed != len(requests):
        raise AssertionError(f"completed {stats.completed}/{len(requests)}")
    for req in requests:
        if len(req.generated) != 8 or not all(
                0 <= t < cfg.vocab_size for t in req.generated):
            raise AssertionError(f"request {req.uid}: bad tokens "
                                 f"{req.generated}")
    return {"ms_per_step": per_step, "bound_ms": bms,
            "tokens_per_s": stats.tokens_generated / wall}


def run_jamba(cfg, cuts: str, dev) -> tuple[dict, int]:
    """The hybrid slice at ``cfg``: weights, the ssd_scan kernel line, the
    prefill (counted), decode == prefill in bf16 and f32, and the dense
    serve.  Returns the kernel's row and its prefill launches."""
    import dataclasses

    import torch

    from repro_torch.engine import DenseAdapter, Engine, EngineConfig
    from repro_torch.models.model import Model
    from repro_torch.models.params import init_params

    rng = np.random.default_rng(1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for _, _, x in param_leaves(params))
    n_bytes = sum(x.numel() * x.element_size()
                  for _, _, x in param_leaves(params))
    print(f"jamba weights: {cfg.name} at d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV heads, SSM "
          f"{cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim} heads of "
          f"{cfg.ssm.d_state} x {cfg.ssm.head_dim}, vocab {cfg.vocab_size}; "
          f"cuts: {cuts}; {n_params / 1e9:.4f} B parameters "
          f"(param_count {cfg.param_count() / 1e9:.4f} B), "
          f"{n_bytes / 1e9:.3f} GB, seeded in "
          f"{time.perf_counter() - t0:.2f} s; peak device memory "
          f"{mem_gb():.2f} GB")
    if n_params != cfg.param_count():
        raise AssertionError("parameter tree != param_count()")
    toks = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (PREFILL_B, PREFILL_T))).to(dev)
    row = check_ssd_scan(cfg, params, toks, rng, dev)
    row["dk128_dv64"] = check_wide_scan(dev)
    launches = prefill_jamba(cfg, params, toks)
    short = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 16))).to(dev)
    decode_vs_prefill(cfg, params, short,
                      dict(rtol=0.0, atol=DECODE_BF16_ATOL), "bf16")
    serve_dense(cfg, params, rng)
    prompts = [rng.integers(1, cfg.vocab_size, int(rng.integers(2, 6)))
               .tolist() for _ in range(4)]
    profile_steps(Engine(DenseAdapter(Model(cfg), params),
                         EngineConfig(batch_size=4, max_seq=256,
                                      max_backlog=None)),
                  prompts, "jamba dense bf16")
    widen_f32(params)
    decode_vs_prefill(dataclasses.replace(cfg, dtype="float32"), params,
                      short, DECODE_F32_TOL, "f32, the same weights")
    return row, launches


#: bias leaves of a parameter tree: the attention's and MLP's biases of a
#: ``use_bias`` config and the LayerNorm biases
BIAS_KEYS = ("bias", "bq", "bk", "bv", "bo", "b_gate", "b_up", "b_down")
#: std of the seeded biases (their inits are zeros, under which a dropped
#: bias could not show)
BIAS_STD = 0.2
#: apply_moe against apply_moe_reference in bf16 at ample capacity: the
#: same per-expert products (other GEMM shapes, so other f32 summation
#: orders), each rounded to bf16 before the gated sum; in bf16 ulps of the
#: largest |y|
MOE_BF16_ULPS = 4


def seed_biases(params, dev) -> int:
    """Every bias leaf of ``params`` drawn anew, N(0, BIAS_STD) in its
    dtype, from a seeded generator on ``dev``.  Returns their count."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(22)
    n = 0
    for node, key, val in param_leaves(params):
        if key in BIAS_KEYS:
            node[key] = (BIAS_STD * torch.randn(
                val.shape, generator=gen, device=dev)).to(val.dtype)
            n += val.numel()
    return n


def check_pack_layer(packs, dev) -> dict:
    """Layer 0's whole ``pack_pieces`` call of each tree at a wide
    config's shapes (one ``pack_runs`` launch), from the pieces as
    ``pack_tree`` handed them over, against ``pack_runs_plain`` and the
    layer's stream; timed back to back and on the device (the call's
    profiler window must hold one kernel).  The bound is
    :func:`check_pack_kernel`'s: the arrays as stored and the stream out,
    the run table once per stack.  ``packs``: ``(tree, pieces)`` pairs.
    Returns the int4 tree's row with the int3 row under ``"int3"``."""
    import torch

    from repro_torch.kernels import layout_pack as lp
    from repro_torch.kernels.ref import pack_runs_plain

    rows = {}
    for tree, streams in packs:
        prog = tree.exec_program()
        bits = tree.spec.bits
        table = lp.device_pack_runs(prog, dev)

        def call():
            return lp.pack_pieces(prog, streams)

        before = lp.launches
        got = call()
        plain = pack_runs_plain(table.runs, streams, prog.c_max,
                                prog.words32)
        torch.cuda.synchronize()
        if lp.launches != before + 1:
            raise AssertionError(f"pack_pieces: {lp.launches - before} "
                                 "launches a call, expected 1")
        if not torch.equal(got, tree.streams[0]) or not torch.equal(
                lp.pack_runs(table, streams), plain):
            raise AssertionError(f"pack_layout_fused int{bits} "
                                 f"{tree.manifest.arch}: "
                                 "pack_pieces differs from pack_runs_plain "
                                 "or the layer's stream")
        del plain
        ms = time_ms(call, iters=10)
        dms = one_kernel_ms(call, "pack_runs_kernel",
                            f"pack_layout_fused int{bits}", iters=10)
        pms = time_ms(lambda: pack_runs_plain(
            table.runs, streams, prog.c_max, prog.words32), iters=1,
            warmup=1)
        in_bytes = sum(s.numel() * s.element_size() for s in streams)
        out_bytes = prog.c_max * prog.words32 * 4
        tab_bytes = (table.runs.numel() + table.row_start.numel()) * 4
        bms, by = bound_ms(in_bytes + out_bytes + tab_bytes / tree.n_layers,
                           0)
        cold, _ = bound_ms(in_bytes + out_bytes + tab_bytes, 0)
        print(f"pack_layout_fused int{bits} {tree.manifest.arch} layer "
              f"(whole pack_pieces call): {prog.n_pieces} pieces of "
              f"{len(streams)} "
              f"arrays, {table.runs.shape[0]} runs: {ms:.4f} ms (device "
              f"{fmt_ms(dms)} ms, 1 kernel a call)  plain {pms:.4f} ms  "
              f"library none  bound {bms:.6f} ms ({by}; {in_bytes} B of "
              f"arrays as stored + {out_bytes} B out, with the {tab_bytes} B "
              f"run table over {tree.n_layers} layers); cold-L2 bound "
              f"{cold:.6f} ms  max|err| 0")
        rows[bits] = {"max_abs_err": 0.0, "ms": ms, "device_ms": dms,
                      "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                      "cold_bound_ms": cold, "library_ms": None}
    return {**rows[4], "int3": rows[3]}


def run_packed(cfg, dev, seed: int) -> tuple[dict, dict]:
    """A config of one ``attn -> mlp`` sublayer at full width and depth
    (stablelm-3b: LayerNorm and biased; qwen2-vl-2b: RMSNorm, biased,
    tied, GQA rep 6, M-RoPE) served from Iris streams: seeded weights
    with seeded biases; ``pack_tree`` at int3 and int4 on the card (one
    ``pack_layout_fused`` launch a layer, counted) and layer 0's pack
    against its plain version; the matmul and attention kernels at its
    shapes beside their library calls; the 8-step ragged decode check of
    each tree; both packed serves (counted); a profiled window of the
    int3 serve.  Returns the kernel rows of its path and their
    launches."""
    import torch

    from repro_torch.engine import Engine, EngineConfig, PackedAdapter
    from repro_torch.models.params import init_params
    from repro_torch.quant import QuantSpec

    rng = np.random.default_rng(seed)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    n_bias = seed_biases(params, dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for _, _, x in param_leaves(params))
    n_bytes = sum(x.numel() * x.element_size()
                  for _, _, x in param_leaves(params))
    print(f"{cfg.name} weights: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.norm}, use_bias={cfg.use_bias}, "
          f"{'tied' if cfg.tie_embeddings else 'untied'}, rope_theta "
          f"{cfg.rope_theta:g}, mrope_sections {cfg.mrope_sections}: "
          f"{n_params / 1e9:.4f} B parameters (param_count "
          f"{cfg.param_count() / 1e9:.4f} B), {n_bytes / 1e9:.3f} GB, "
          f"{n_bias} of them seeded biases (std {BIAS_STD}), in "
          f"{time.perf_counter() - t0:.2f} s; peak device memory "
          f"{mem_gb():.2f} GB")
    if n_params != cfg.param_count():
        raise AssertionError("parameter tree != param_count()")
    norms = ("norm1", "norm2") if cfg.norm == "layernorm" else ()
    trees, pieces, packs = {}, {}, 0
    for bits in (3, 4):
        t0 = time.perf_counter()
        tree, launches, pieces[bits] = counted_pack_tree(
            cfg, params, QuantSpec(bits=bits, group_size=32), dev)
        biases = sorted(k for k in tree.other if "/" in k)
        same = all(torch.equal(tree.other[k], params["blocks"][0][
            k.split("/")[0]][k.split("/")[1]]) for k in biases) and all(
            torch.equal(tree.other[n]["bias"], params["blocks"][0][n]["bias"])
            for n in norms)
        print(f"pack {cfg.name} int{bits}: {tree.summary()}; C_max "
              f"{tree.manifest.c_max}; pack_tree "
              f"{time.perf_counter() - t0:.2f} s wall with the host's "
              f"planning and lowering ({launches} pack_layout_fused "
              f"launches); dense leaves {biases}"
              f"{' and the norm biases' if norms else ''} equal to the "
              f"weights': {same}")
        if launches != cfg.n_layers or not same or len(biases) != 7:
            raise AssertionError(f"pack {cfg.name} int{bits}: {launches} "
                                 f"launches, biases {biases}, equal {same}")
        trees[bits] = tree
        packs += launches
    del params
    tree3, tree4 = trees[3], trees[4]
    tree3.stream_words()
    rows = {"stream_matmul": check_stream_matmul(tree3, rng, dev),
            "packed_matmul": check_packed_matmul(tree4, rng, dev),
            "stream_attention": check_stream_attention(cfg, rng, dev),
            "pack_layout_fused": check_pack_layer(
                ((tree3, pieces[3]), (tree4, pieces[4])), dev)}
    del pieces
    prompts = [rng.integers(1, cfg.vocab_size,
                            int(rng.integers(2, 6))).tolist()
               for _ in range(8)]
    per_layer = {"stream_attention": cfg.n_layers}
    decode_check(cfg, tree4, rng, dev, kv_bits=4)
    counts4, _, ms4 = serve(cfg, tree4, prompts, 4,
                            {**per_layer, "packed_matmul": 7 * cfg.n_layers},
                            label=f" ({cfg.name})")
    decode_check(cfg, tree3, rng, dev, kv_bits=3)
    counts3, _, ms3 = serve(cfg, tree3, prompts, 3,
                            {**per_layer, "stream_matmul": 7 * cfg.n_layers},
                            label=f" ({cfg.name})")
    profile_steps(Engine(PackedAdapter(cfg, tree3, kv="packed", kv_bits=3),
                         EngineConfig(batch_size=4, max_seq=256,
                                      max_backlog=None)),
                  prompts, f"{cfg.name} int3 weights / int3 KV")
    print(f"{cfg.name} per decode step: packed int3 {ms3:.3f} ms, int4 "
          f"{ms4:.3f} ms; peak device memory {mem_gb():.2f} GB")
    launches = {"stream_matmul": counts3["stream_matmul"],
                "stream_attention": counts3["stream_attention"],
                "packed_matmul": counts4["packed_matmul"],
                "pack_layout_fused": packs}
    return rows, {**launches, "ms_per_step": {"int3": ms3, "int4": ms4}}


def moonshot_config():
    """moonshot-v1-16b-a3b at its full widths, cut in depth to fit the
    card beside the prefill: returns (config, the cuts as text)."""
    import dataclasses

    from repro_torch.configs import MOONSHOT_V1_16B_A3B

    cfg = dataclasses.replace(MOONSHOT_V1_16B_A3B, n_layers=8)
    cuts = ("n_layers 48 -> 8 (64 experts x 3 x 2048 x 1408 bf16 = 1.1 GB "
            "a layer; the depth is cut to keep the whole run well inside "
            "its time limit)")
    return cfg, cuts


def moe_drops(cfg, params, toks) -> list[float]:
    """The prefill's share of (token, choice) pairs over capacity, per MoE
    sublayer, read from the dispatch as the forward runs."""
    from repro_torch.models import moe

    shares = []
    real = moe.dispatch

    def counted(*args):
        out = real(*args)
        shares.append(float(1.0 - out[2].float().mean()))
        return out

    moe.dispatch = counted
    try:
        from repro_torch.models.model import Model

        Model(cfg).forward(params, {"tokens": toks})
    finally:
        moe.dispatch = real
    return shares


def check_moe_layer(cfg, params, dev) -> None:
    """Layer 0's ``apply_moe`` against ``apply_moe_reference`` in bf16 at
    ample capacity (capacity factor E / k: no token dropped), on seeded
    inputs, B=2, T=256."""
    import torch

    from repro_torch.models import moe
    from repro_torch.models.transformer import period_params

    p0 = period_params(params["blocks"][0], 0)["moe"]
    gen = torch.Generator(device=dev).manual_seed(64)
    x = torch.randn((2, 256, cfg.d_model), generator=gen, device=dev) \
        .to(torch.bfloat16)
    got, aux = moe.apply_moe(cfg, p0, x)
    want = moe.apply_moe_reference(cfg, p0, x)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    largest = float(want.float().abs().max())
    ulp = 2.0 ** (np.floor(np.log2(largest)) - 7)
    ms = time_ms(lambda: moe.apply_moe(cfg, p0, x), iters=10)
    oms = time_ms(lambda: moe.apply_moe_reference(cfg, p0, x), iters=3)
    print(f"apply_moe {cfg.name} layer 0, bf16 B=2 T=256, capacity "
          f"{moe.moe_capacity(256, cfg)} of 256 (capacity factor "
          f"{cfg.moe.capacity_factor:.4g}): max|y - oracle| {err:.4g} = "
          f"{err / ulp:.3g} bf16 ulps of the largest |y| {largest:.4g} "
          f"(tolerance {MOE_BF16_ULPS}); aux {float(aux):.4f}; {ms:.3f} ms "
          f"back to back, the oracle (every expert for every token) "
          f"{oms:.3f} ms")
    if not torch.isfinite(got).all() or err > MOE_BF16_ULPS * ulp:
        raise AssertionError(f"apply_moe != apply_moe_reference: {err:.4g}")


def run_moonshot(cfg, cuts: str, dev) -> dict:
    """The MoE slice at ``cfg``: seeded weights; the prefill at B=2,
    T=1024 (finite logits and aux, the share of tokens dropped); layer 0's
    ``apply_moe`` against its oracle; decode == prefill in bf16 at ample
    capacity; the unquantized serve against its bytes bound."""
    import dataclasses

    import torch

    from repro_torch.models.model import Model
    from repro_torch.models.moe import moe_capacity
    from repro_torch.models.params import init_params

    rng = np.random.default_rng(5)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for _, _, x in param_leaves(params))
    n_bytes = sum(x.numel() * x.element_size()
                  for _, _, x in param_leaves(params))
    moe = cfg.moe
    print(f"moonshot weights: {cfg.name} at d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, "
          f"{moe.n_experts} experts top-{moe.top_k} of d_expert "
          f"{moe.d_expert} a layer, vocab {cfg.vocab_size}; cuts: {cuts}; "
          f"{n_params / 1e9:.4f} B parameters (param_count "
          f"{cfg.param_count() / 1e9:.4f} B, active "
          f"{cfg.active_param_count() / 1e9:.4f} B), {n_bytes / 1e9:.3f} "
          f"GB, seeded in {time.perf_counter() - t0:.2f} s; peak device "
          f"memory {mem_gb():.2f} GB")
    if n_params != cfg.param_count():
        raise AssertionError("parameter tree != param_count()")
    toks = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (PREFILL_B, PREFILL_T))).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, aux, caches = Model(cfg).forward(params, {"tokens": toks},
                                             collect_cache=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    finite = bool(torch.isfinite(logits).all()) and \
        bool(torch.isfinite(aux))
    shapes = [tuple(k.shape) for k, _ in caches]
    drops = moe_drops(cfg, params, toks)
    print(f"prefill {cfg.name} B={PREFILL_B} T={PREFILL_T} "
          f"(Model.forward): logits {tuple(logits.shape)} {logits.dtype}, "
          f"aux {float(aux):.4f} over {cfg.n_layers} MoE layers (1 a layer "
          f"when the load is even), finite={finite}; caches {shapes}; "
          f"capacity {moe_capacity(PREFILL_T, cfg)} slots an expert a row "
          f"(capacity factor {moe.capacity_factor}): share of (token, "
          f"choice) pairs dropped by layer "
          f"{[round(d, 3) for d in drops]}; {wall * 1e3:.1f} ms wall (first "
          f"call); peak device memory {mem_gb():.2f} GB")
    want = (cfg.n_layers, PREFILL_B, PREFILL_T, cfg.n_kv_heads, cfg.head_dim)
    if logits.shape != (PREFILL_B, PREFILL_T, cfg.vocab_size) or \
            not finite or shapes != [want] or float(aux) <= 0:
        raise AssertionError(f"prefill {cfg.name}: finite {finite}, caches "
                             f"{shapes}, aux {float(aux)}")
    del logits, caches
    ample = dataclasses.replace(cfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.n_experts / moe.top_k))
    check_moe_layer(ample, params, dev)
    short = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 16))).to(dev)
    decode_vs_prefill(ample, params, short,
                      dict(rtol=0.0, atol=DECODE_BF16_ATOL),
                      "bf16, capacity factor E / k: no token dropped")
    return serve_dense(cfg, params, rng, label=cfg.name)


def seed_rwkv(params, dev) -> int:
    """RWKV's constant-init leaves drawn anew from a seeded generator on
    ``dev``, in their f32: ``bonus_u`` N(0, 0.5), ``mix`` U(0, 1),
    ``decay_w0`` -2 + N(0, 0.5) (their inits 0, 0.5 and -2 would hide a
    dropped or misplaced term).  Returns their count."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(23)
    draw = {"bonus_u": lambda sh: 0.5 * torch.randn(sh, generator=gen,
                                                    device=dev),
            "mix": lambda sh: torch.rand(sh, generator=gen, device=dev),
            "decay_w0": lambda sh: -2.0 + 0.5 * torch.randn(
                sh, generator=gen, device=dev)}
    n = 0
    for node, key, val in param_leaves(params):
        if key in draw:
            node[key] = draw[key](val.shape).to(val.dtype)
            n += val.numel()
    return n


def widen_f32(params) -> None:
    """The same weights widened to f32 (exact), leaf by leaf in place."""
    import torch

    torch.cuda.empty_cache()
    for node, key, val in param_leaves(params):
        node[key] = val.float()


def run_rwkv(cfg, dev) -> dict:
    """rwkv6-3b at full width and depth: seeded weights with RWKV's
    constant leaves seeded; the prefill at B=2, T=1024 (its time mix over
    the plain ``recurrent_scan``: no kernel of the port runs on this
    path, as none of the reference's does); decode == prefill in bf16 and,
    the same weights widened, in f32 with the greedy argmax gated; the
    unquantized serve against its bytes bound."""
    import dataclasses

    import torch

    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models.params import init_params

    rng = np.random.default_rng(7)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    n_seeded = seed_rwkv(params, dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for _, _, x in param_leaves(params))
    n_bytes = sum(x.numel() * x.element_size()
                  for _, _, x in param_leaves(params))
    print(f"rwkv weights: {cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.d_model // cfg.rwkv.head_dim} time-mix heads "
          f"of {cfg.rwkv.head_dim}, decay LoRA {cfg.rwkv.decay_lora}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}): {n_params / 1e9:.4f} B "
          f"parameters (param_count {cfg.param_count() / 1e9:.4f} B), "
          f"{n_bytes / 1e9:.3f} GB, {n_seeded} of them bonus_u, mix and "
          f"decay_w0 seeded away from their constant inits, in "
          f"{time.perf_counter() - t0:.2f} s; peak device memory "
          f"{mem_gb():.2f} GB")
    if n_params != cfg.param_count():
        raise AssertionError("parameter tree != param_count()")
    toks = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (PREFILL_B, PREFILL_T))).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = build_prefill_step(cfg)(params, {"tokens": toks})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    finite = bool(torch.isfinite(logits).all())
    print(f"prefill {cfg.name} B={PREFILL_B} T={PREFILL_T} "
          f"(build_prefill_step): logits {tuple(logits.shape)} "
          f"{logits.dtype} finite={finite}; caches {caches} (attention-"
          f"free); {wall * 1e3:.1f} ms wall (first call); peak device "
          f"memory {mem_gb():.2f} GB")
    if logits.shape != (PREFILL_B, PREFILL_T, cfg.vocab_size) or \
            not finite or caches != ():
        raise AssertionError(f"prefill {cfg.name}: finite {finite}")
    del logits
    short = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 16))).to(dev)
    decode_vs_prefill(cfg, params, short,
                      dict(rtol=0.0, atol=RWKV_BF16_ATOL), "bf16")
    out = serve_dense(cfg, params, rng, label=cfg.name)
    widen_f32(params)
    decode_vs_prefill(dataclasses.replace(cfg, dtype="float32"), params,
                      short, DECODE_F32_TOL, "f32, the same weights")
    return {**out, "prefill_ms": wall * 1e3}


def run_whisper(cfg, dev) -> dict:
    """whisper-medium at full width and depth (24 encoder and 24 decoder
    layers): seeded weights with seeded biases and norm biases;
    ``encode`` of B=2 seeded frame embeddings (the audio front end's stub,
    1500 x 1024); the prefill over tokens and frames at T=448, whisper's
    decoder context; decode over ``precompute_cross_kv`` == prefill in
    bf16 and, the same weights widened, in f32 with the greedy argmax
    gated; the unquantized serve (``DenseAdapter`` steps without cross
    K/V, as the reference's does) against its bytes bound.  No kernel of
    the port runs on this path (the reference's attention is its plain
    ``flash_attention``)."""
    import dataclasses

    import torch

    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models.model import Model
    from repro_torch.models.params import init_params

    rng = np.random.default_rng(9)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    n_bias = seed_biases(params, dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for _, _, x in param_leaves(params))
    n_bytes = sum(x.numel() * x.element_size()
                  for _, _, x in param_leaves(params))
    print(f"whisper weights: {cfg.name} ({cfg.encoder.n_layers} encoder + "
          f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.norm}, use_bias="
          f"{cfg.use_bias}, {cfg.encoder.n_ctx} frames): "
          f"{n_params / 1e9:.4f} B parameters (param_count "
          f"{cfg.param_count() / 1e9:.4f} B), {n_bytes / 1e9:.3f} GB, "
          f"{n_bias} of them seeded biases (std {BIAS_STD}), in "
          f"{time.perf_counter() - t0:.2f} s; peak device memory "
          f"{mem_gb():.2f} GB")
    if n_params != cfg.param_count():
        raise AssertionError("parameter tree != param_count()")
    gen = torch.Generator(device=dev).manual_seed(24)
    frames = torch.randn((PREFILL_B, cfg.encoder.n_ctx, cfg.d_model),
                         generator=gen, device=dev)
    model = Model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    memory = model.encode(params, frames)
    torch.cuda.synchronize()
    enc_ms = (time.perf_counter() - t0) * 1e3
    finite = bool(torch.isfinite(memory).all())
    print(f"encode {cfg.name} B={PREFILL_B}: frames {tuple(frames.shape)} "
          f"-> memory {tuple(memory.shape)} {memory.dtype} finite={finite}; "
          f"{enc_ms:.1f} ms wall (first call)")
    if memory.shape != (PREFILL_B, cfg.encoder.n_ctx, cfg.d_model) or \
            not finite:
        raise AssertionError(f"encode {cfg.name}: finite {finite}")
    del memory
    toks = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (PREFILL_B, WHISPER_T))).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = build_prefill_step(cfg)(
        params, {"tokens": toks, "frames": frames})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    finite = bool(torch.isfinite(logits).all())
    shapes = [tuple(k.shape) for k, _ in caches]
    print(f"prefill {cfg.name} B={PREFILL_B} T={WHISPER_T} with frames "
          f"(build_prefill_step: encode, then the decoder with its "
          f"cross-attention): logits {tuple(logits.shape)} {logits.dtype} "
          f"finite={finite}; caches {shapes}; {wall * 1e3:.1f} ms wall "
          f"(first call); peak device memory {mem_gb():.2f} GB")
    want = (cfg.n_layers, PREFILL_B, WHISPER_T, cfg.n_kv_heads, cfg.head_dim)
    if logits.shape != (PREFILL_B, WHISPER_T, cfg.vocab_size) or \
            not finite or shapes != [want]:
        raise AssertionError(f"prefill {cfg.name}: finite {finite}, caches "
                             f"{shapes}")
    del logits, caches
    short = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 16))).to(dev)
    decode_vs_prefill(cfg, params, short,
                      dict(rtol=0.0, atol=DECODE_BF16_ATOL),
                      "bf16, over the frames' cross K/V", frames=frames)
    out = serve_dense(cfg, params, rng, label=cfg.name)
    widen_f32(params)
    decode_vs_prefill(dataclasses.replace(cfg, dtype="float32"), params,
                      short, DECODE_F32_TOL,
                      "f32, the same weights, over the frames' cross K/V",
                      frames=frames)
    return {**out, "encode_ms": enc_ms, "prefill_ms": wall * 1e3}


#: the smollm training cell: the CLI's recipe at B=8, S=1024
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_CKPT, TRAIN_FAIL_AT = 8, 1024, 40, 10, 25
#: replayed steps (20-24, from the step-20 checkpoint) against the first
#: run's losses.  The restored state is the saved one bit for bit, and
#: on an H100 the five replayed losses came out bit-equal too (the
#: embedding's accumulating index_put, the one backward that could add
#: in another order, sorts its indices first); 1e-3 leaves room for an
#: order change without hiding a wrong restore (a step's loss moves by
#: ~0.01-0.1 here)
TRAIN_REPLAY_ATOL = 1e-3
#: train step card == cpu (f32 weights, B=2, S=128): loss and grad_norm
#: relative tolerances; a parameter may differ by up to 2 lr where its
#: gradient is roundoff and AdamW's first, sign-like update takes the
#: other sign, at most TRAIN_PARAM_OUTLIERS of the entries beyond
#: TRAIN_PARAM_CLOSE
TRAIN_LOSS_RTOL, TRAIN_NORM_RTOL = 1e-5, 1e-4
TRAIN_PARAM_CLOSE, TRAIN_PARAM_OUTLIERS = 1e-6, 1e-4


def train_flops(cfg, n_params: int, tokens: int, seq: int) -> float:
    """Model FLOPs of one train step: 6 N per token (forward and
    backward of every weight product; the tied embedding counts once, as
    the unembedding) plus attention's score and value products, 12 L S H
    hd per token over the full S x S square (the port's flash attention
    computes the masked half too).  Remat's recompute is not counted."""
    return (6.0 * n_params * tokens
            + 12.0 * cfg.n_layers * seq * cfg.n_heads * cfg.head_dim
            * tokens)


def train_smollm(cfg, dev, card: str) -> dict:
    """smollm-135m at full width and depth through ``run_training`` and
    ``build_train_step``, the CLI's path: bf16 parameters, f32 moments,
    remat "full", B=8, S=1024, the synthetic pipeline at seed 0,
    ``AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=40)``, a
    checkpoint every 10 steps, and one simulated node failure at step 25
    (restored from step 20: 45 steps run).  Then a profiler window of two
    more steps."""
    import tempfile

    import torch

    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.launch.steps import build_train_step, init_train_state
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train_loop import (
        TrainLoopConfig,
        device_batch,
        run_training,
    )

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt = AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=TRAIN_STEPS)
    step_fn = build_train_step(cfg, opt, remat="full")
    pipe = SyntheticLMPipeline(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=0)
    times: list[float] = []
    last = {}

    def timed(state, batch):
        t0 = time.perf_counter()
        new, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        last["state"] = new
        return new, metrics

    def init():
        return init_train_state(cfg, torch.Generator(device=dev)
                                .manual_seed(0), dev)

    failed = []

    def injector(step):
        if step == TRAIN_FAIL_AT and not failed:
            failed.append(step)
            raise RuntimeError("simulated node failure")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="train_ckpt_") as ckpt:
        rep = run_training(
            timed, init, pipe, ckpt,
            TrainLoopConfig(total_steps=TRAIN_STEPS,
                            ckpt_interval=TRAIN_CKPT),
            fail_injector=injector,
            to_batch=lambda b: device_batch(b, dev))
    wall = time.perf_counter() - t0
    losses = np.asarray(rep.losses)
    n_params = sum(x.numel()
                   for _, _, x in param_leaves(last["state"]["params"]))
    tokens = TRAIN_B * TRAIN_S
    ms = float(np.median(times[3:])) * 1e3
    flops = train_flops(cfg, n_params, tokens, TRAIN_S)
    share = flops / (ms / 1e3) / BF16_TC_FLOPS
    first = losses[TRAIN_CKPT * 2:TRAIN_FAIL_AT]
    replay = losses[TRAIN_FAIL_AT:TRAIN_FAIL_AT + len(first)]
    replay_err = float(np.abs(first - replay).max())
    peak = mem_gb()
    print(f"train smollm-135m (full width and depth: {cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype} parameters, f32 moments, remat full; B={TRAIN_B} "
          f"S={TRAIN_S}; {TRAIN_STEPS} steps, checkpoint every "
          f"{TRAIN_CKPT}, a node failure at step {TRAIN_FAIL_AT}): "
          f"{n_params} parameters; steps_run={rep.steps_run} "
          f"restarts={rep.restarts} resumed_from={rep.resumed_from} "
          f"skipped_nonfinite={rep.skipped_nonfinite} in {wall:.1f} s wall; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean of the last "
          f"five {losses[-5:].mean():.4f})")
    print(f"train smollm-135m replayed steps 20-24: first run "
          f"{np.array2string(first, precision=5)}, replay "
          f"{np.array2string(replay, precision=5)}, max |diff| "
          f"{replay_err:.3g} (gate {TRAIN_REPLAY_ATOL}; step 20 equal: "
          f"{bool(first[0] == replay[0])})")
    print(f"train smollm-135m on {card}: {ms:.2f} ms per step (median of "
          f"{len(times) - 3} after 3 warm-up steps; min "
          f"{min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}), "
          f"{tokens / (ms / 1e3):.0f} tokens/s, peak device memory "
          f"{peak:.2f} GB, model FLOPs per step {flops / 1e12:.3f} T "
          f"(6 N tokens + attention), {100 * share:.2f}% of the bf16 dense "
          f"peak (989 TFLOP/s)")
    print(f"train smollm-135m loss curve: "
          f"{np.array2string(losses[::5], precision=3)}")
    if not np.isfinite(losses).all() or rep.restarts != 1 or \
            rep.steps_run != TRAIN_STEPS + TRAIN_FAIL_AT - 2 * TRAIN_CKPT \
            or not losses[-5:].mean() < losses[0] \
            or replay_err > TRAIN_REPLAY_ATOL:
        raise AssertionError(
            f"train smollm-135m: steps_run {rep.steps_run}, restarts "
            f"{rep.restarts}, first loss {losses[0]}, last five "
            f"{losses[-5:]}, replay error {replay_err}")
    state = last.pop("state")
    batches = [device_batch(pipe.next_batch(), dev) for _ in range(4)]
    holder = {"state": state}

    def one():
        holder["state"], _ = step_fn(holder["state"], batches.pop())

    one()
    one()                              # warm, outside the window
    prof = profile_window(one, "train smollm-135m, 2 steps", 2)
    return {"params": n_params, "steps_run": rep.steps_run,
            "restarts": rep.restarts, "first_loss": float(losses[0]),
            "last5_mean_loss": float(losses[-5:].mean()),
            "replay_max_abs_diff": replay_err, "ms_per_step": ms,
            "tokens_per_s": tokens / (ms / 1e3), "peak_gb": peak,
            "model_tflop_per_step": flops / 1e12,
            "bf16_peak_share": share, "profile_2_steps": prof,
            "card": card}


def train_step_card_vs_cpu(cfg, dev) -> dict:
    """One ``build_train_step`` step of smollm-135m at full width, the
    weights widened to f32, B=2, S=128, on the card and with the port on
    the CPU from the same parameters and batch.  No CUDA kernel of the
    port runs here (smollm has no Mamba sublayer)."""
    import dataclasses

    import torch

    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.launch.steps import build_train_step, init_train_state
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.pytree import flatten, tree_map
    from repro_torch.runtime.train_loop import device_batch

    cfg = dataclasses.replace(cfg, dtype="float32")
    card_state = init_train_state(cfg, torch.Generator(device=dev)
                                  .manual_seed(1), dev)
    cpu_params = tree_map(lambda x: x.cpu(), card_state["params"])
    cpu_state = {"params": cpu_params, "opt": init_opt_state(cpu_params)}
    batch = SyntheticLMPipeline(cfg.vocab_size, 128, 2, seed=1).next_batch()
    opt = AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=TRAIN_STEPS)
    step = build_train_step(cfg, opt, remat="full")
    t0 = time.perf_counter()
    new_card, m_card = step(card_state, device_batch(batch, dev))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    new_cpu, m_cpu = step(cpu_state, device_batch(batch, "cpu"))
    cpu_s = time.perf_counter() - t0
    loss_err = abs(m_card["loss"].item() / m_cpu["loss"].item() - 1)
    norm_err = abs(m_card["grad_norm"].item()
                   / m_cpu["grad_norm"].item() - 1)
    lr = m_cpu["lr"].item()
    worst, outliers, total = 0.0, 0, 0
    for got, want in zip(flatten(new_card["params"]),
                         flatten(new_cpu["params"])):
        err = (got.cpu() - want).abs()
        worst = max(worst, err.max().item())
        outliers += int((err > TRAIN_PARAM_CLOSE).sum())
        total += err.numel()
    print(f"train step card == cpu (smollm-135m at full width, f32 "
          f"weights, B=2 S=128; no kernel of the port on this path): loss "
          f"{m_card['loss'].item():.6f} vs {m_cpu['loss'].item():.6f} "
          f"(rel {loss_err:.3g}, gate {TRAIN_LOSS_RTOL}), grad_norm "
          f"{m_card['grad_norm'].item():.6f} vs "
          f"{m_cpu['grad_norm'].item():.6f} (rel {norm_err:.3g}, gate "
          f"{TRAIN_NORM_RTOL}); parameters: max |diff| {worst:.3g} (gate "
          f"2 lr = {2 * lr:.3g}), {outliers} of {total} entries beyond "
          f"{TRAIN_PARAM_CLOSE} (gate {TRAIN_PARAM_OUTLIERS} of them); "
          f"card {card_s:.2f} s, cpu {cpu_s:.2f} s wall")
    if loss_err > TRAIN_LOSS_RTOL or norm_err > TRAIN_NORM_RTOL or \
            worst > 2 * lr or outliers > TRAIN_PARAM_OUTLIERS * total:
        raise AssertionError("train step card != cpu")
    return {"loss_rel_err": loss_err, "grad_norm_rel_err": norm_err,
            "param_max_abs_diff": worst, "param_outliers": outliers,
            "params": total}


def train_jamba_grad(dev) -> tuple[dict, int]:
    """Reduced jamba (``moe=None``, ``n_layers=8``: 7 Mamba sublayers and
    one attention sublayer, d_model 128) in f32: one ``Model.loss`` and
    ``autograd.grad`` over every leaf on the card, whose forward runs the
    ``ssd_scan`` kernel, against the same on the CPU (``ssd_scan_plain``).
    Returns the figures and the kernel launches of the card's loss and
    gradient (the backward's remat recomputes the forward)."""
    import dataclasses

    import torch

    from repro_torch.configs import JAMBA_1_5_LARGE
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.models import mamba
    from repro_torch.models.model import Model
    from repro_torch.pytree import flatten, leaf_paths, tree_map

    cfg = dataclasses.replace(JAMBA_1_5_LARGE.reduced(moe=None, n_layers=8),
                              dtype="float32")
    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(2),
                             device=dev)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 257))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    paths = leaf_paths(params)

    def loss_and_grads(where, scan=None):
        """(loss, gradients on the host, launches in the forward, in
        all); ``scan`` replaces the Mamba layer's ``ssd_scan``."""
        p = tree_map(lambda x: x.to(where).requires_grad_(True), params)
        b = {k: torch.from_numpy(v).to(where) for k, v in batch.items()}
        kernel_scan = mamba.ssd_scan
        mamba.ssd_scan = scan or kernel_scan
        try:
            ls.launches = 0
            loss = Model(cfg).loss(p, b)
            fwd = ls.launches
            grads = torch.autograd.grad(loss, flatten(p))
            torch.cuda.synchronize()
        finally:
            mamba.ssd_scan = kernel_scan
        return loss.item(), [g.cpu() for g in grads], fwd, ls.launches

    def compare(got, want):
        """(relative loss error, worst Mamba leaf and its error relative
        to its largest entry, worst error of any leaf, zero Mamba
        gradients)."""
        worst_mamba, worst_all, zero = ("", 0.0), 0.0, []
        for path, a, b in zip(paths, got[1], want[1]):
            rel = (a - b).abs().max().item() / max(b.abs().max().item(),
                                                   1e-30)
            worst_all = max(worst_all, rel)
            if "/mamba/" in path:
                worst_mamba = max(worst_mamba, (path, rel),
                                  key=lambda x: x[1])
                if a.abs().max().item() == 0:
                    zero.append(path)
        return abs(got[0] / want[0] - 1), worst_mamba, worst_all, zero

    card = loss_and_grads(dev)
    cpu = loss_and_grads(torch.device("cpu"))
    # the card with the plain scan: what the two devices' other sums
    # account for, beside the kernel's forward
    card_plain = loss_and_grads(dev, ls.ssd_scan_plain)
    fwd, total = card[2:]
    loss_err, (leaf, worst_mamba), worst_all, zero = compare(card, cpu)
    _, (_, plain_mamba), plain_all, _ = compare(card_plain, cpu)
    _, (_, kernel_mamba), _, _ = compare(card, card_plain)
    print(f"train jamba (ssd_scan gradient; {cfg.name} reduced, moe=None, "
          f"n_layers=8, f32, B=2 T=256): ssd_scan launches {fwd} in the "
          f"card's forward, {total} with the backward's recompute; loss "
          f"{card[0]:.6f} vs cpu {cpu[0]:.6f} (rel {loss_err:.3g}, gate "
          f"{TRAIN_LOSS_RTOL}); Mamba leaves' gradients within "
          f"{worst_mamba:.3g} of their largest entry (worst {leaf}; gate "
          f"{SCAN_F32_TOL['rtol']}), every leaf within {worst_all:.3g}; "
          f"zero Mamba gradients: {zero or 'none'}; the card with the "
          f"plain scan against the cpu: Mamba {plain_mamba:.3g}, every "
          f"leaf {plain_all:.3g}; kernel against plain scan on the card: "
          f"Mamba {kernel_mamba:.3g}")
    if fwd <= 0 or card_plain[2] != 0 or zero or \
            loss_err > TRAIN_LOSS_RTOL or \
            worst_mamba > SCAN_F32_TOL["rtol"]:
        raise AssertionError("train jamba: the ssd_scan gradient")
    return ({"ssd_scan_launches_forward": fwd,
             "ssd_scan_launches_loss_and_grad": total,
             "loss_rel_err": loss_err, "mamba_grad_rel_err": worst_mamba,
             "grad_rel_err": worst_all,
             "plain_scan_on_card_mamba_grad_rel_err": plain_mamba,
             "kernel_vs_plain_on_card_mamba_grad_rel_err": kernel_mamba},
            total)


#: the sharded train step's losses against the unsharded step's (bf16
#: weights, the same state and batches; a (1, 1) mesh computes the same
#: products, so only reduction orders may differ)
SHARDED_LOSS_RTOL = 1e-3
DIST_TRAIN_STEPS = 3
JAMBA_DIST_STEPS = 2


def _group(dev):
    """A one-rank process group on a ``FileStore`` in a temporary
    directory (NCCL on a card, gloo on the CPU); returns the directory."""
    import tempfile

    import torch.distributed as dist

    tmp = tempfile.TemporaryDirectory(prefix="dist_store_")
    store = dist.FileStore(f"{tmp.name}/store", 1)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=store, rank=0, world_size=1)
    return tmp


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def distributed_phase(cfg, dev, card: str) -> dict:
    """The distributed substrate on one card (step 17 of the docstring).
    Returns its figures, with the main path's kernel launches under
    ``launches``."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.kernels import layout_pack as lp
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import (
        batch_sharding,
        opt_state_shardings,
        packed_tree_shardings,
        param_shardings,
        place,
    )
    from repro_torch.launch.steps import build_train_step, init_train_state
    from repro_torch.models.params import init_params
    from repro_torch.models.shard_utils import local, use_mesh
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.pytree import flatten
    from repro_torch.quant import QuantSpec
    from repro_torch.runtime.elastic import reshard_live, validate_resharding
    from repro_torch.runtime.pipeline_par import (
        PipelineConfig,
        pipeline_forward,
    )
    from repro_torch.runtime.train_loop import device_batch
    from repro_torch.tree import pack_tree

    figures: dict = {"card": card}
    store = _group(dev)
    try:
        mesh = make_debug_mesh((1, 1), ("data", "model"),
                               device_type=dev.type)
        # --- sharded training against unsharded, from one state ---------
        state = init_train_state(cfg, torch.Generator(device=dev)
                                 .manual_seed(0), dev)
        pipe = SyntheticLMPipeline(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=0)
        batches = [device_batch(pipe.next_batch(), dev)
                   for _ in range(DIST_TRAIN_STEPS)]
        step = build_train_step(cfg, AdamWConfig(lr=3e-3, warmup_steps=10,
                                                 total_steps=TRAIN_STEPS),
                                remat="full")

        def steps(st, bs, placed: bool):
            losses, ms = [], []
            for b in bs:
                _sync(dev)
                t0 = time.perf_counter()
                if placed:
                    with use_mesh(mesh):
                        st, m = step(st, b)
                else:
                    st, m = step(st, b)
                _sync(dev)
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(local(m["loss"])))
            return st, losses, ms

        _, plain_losses, plain_ms = steps(state, batches, False)
        ps_ = param_shardings(state["params"], mesh, fsdp=True)
        rules = {"params": ps_,
                 "opt": opt_state_shardings(state["opt"], ps_, mesh)}
        t0 = time.perf_counter()
        placed = place(state, rules)
        placed_batches = [place(b, batch_sharding(b, mesh))
                          for b in batches]
        place_ms = (time.perf_counter() - t0) * 1e3
        _, losses, ms = steps(placed, placed_batches, True)
        err = max(abs(a - b) for a, b in zip(losses, plain_losses))
        rel = err / max(abs(b) for b in plain_losses)
        print(f"distributed train smollm-135m (full width, B={TRAIN_B} "
              f"S={TRAIN_S}, {DIST_TRAIN_STEPS} steps, state placed by "
              f"param_shardings(fsdp=True) / opt_state_shardings on a "
              f"(1, 1) mesh, placed in {place_ms:.1f} ms): losses "
              f"{[round(x, 6) for x in losses]} vs unsharded "
              f"{[round(x, 6) for x in plain_losses]}, max |diff| "
              f"{err:.3g} (rel {rel:.3g}, gate {SHARDED_LOSS_RTOL}); ms "
              f"per step sharded {[round(x, 1) for x in ms]} vs unsharded "
              f"{[round(x, 1) for x in plain_ms]} (median "
              f"{float(np.median(ms)):.1f} vs "
              f"{float(np.median(plain_ms)):.1f}: DTensor's host overhead "
              f"{float(np.median(ms) - np.median(plain_ms)):.1f} ms)")
        if not rel <= SHARDED_LOSS_RTOL or not np.isfinite(losses).all():
            raise AssertionError(f"sharded losses {losses} against "
                                 f"{plain_losses}")
        figures["train"] = {
            "losses": losses, "unsharded_losses": plain_losses,
            "max_abs_diff": err, "ms_per_step": ms,
            "unsharded_ms_per_step": plain_ms, "place_ms": place_ms}
        # --- reshard onto a (1,) mesh, and restore onto the mesh -------
        mesh1 = make_debug_mesh((1,), ("data",), device_type=dev.type)
        p1 = param_shardings(state["params"], mesh1, fsdp=True)
        rules1 = {"params": p1,
                  "opt": opt_state_shardings(state["opt"], p1, mesh1)}
        nbytes = sum(x.numel() * x.element_size() for x in flatten(state))
        _sync(dev)
        t0 = time.perf_counter()
        moved = reshard_live(placed, rules1)
        _sync(dev)
        reshard_ms = (time.perf_counter() - t0) * 1e3
        validate_resharding(state, moved)
        validate_resharding(placed, moved)
        print(f"distributed reshard_live: the train state "
              f"({nbytes / 1e9:.4f} GB, {len(flatten(state))} leaves) "
              f"(1, 1) -> (1,) mesh in {reshard_ms:.1f} ms, bit-equal: True")
        del moved, placed, placed_batches
        with tempfile.TemporaryDirectory(prefix="dist_ckpt_") as d:
            mgr = CheckpointManager(d)
            mgr.save(7, state)
            t0 = time.perf_counter()
            restored, _ = mgr.restore(state, shardings=rules)
            _sync(dev)
            restore_ms = (time.perf_counter() - t0) * 1e3
            validate_resharding(state, restored)
            kinds = {type(x).__name__ for x in flatten(restored)}
        print(f"distributed restore(shardings=): the train checkpoint "
              f"onto the (1, 1) mesh as {sorted(kinds)} in "
              f"{restore_ms:.1f} ms, bit-equal: True")
        if kinds != {"DTensor"}:
            raise AssertionError(f"restore placed {kinds}")
        figures["reshard"] = {"ms": reshard_ms, "gb": nbytes / 1e9}
        figures["restore_ms"] = restore_ms
        del restored, state
        # --- pipeline with one stage -----------------------------------
        smesh = make_debug_mesh((1,), ("stage",), device_type=dev.type)
        g = torch.Generator(device=dev).manual_seed(5)
        ws = torch.randn((1, 64, 64), generator=g, device=dev) * 0.3
        x = torch.randn((6, 2, 64), generator=g, device=dev)
        out = pipeline_forward(lambda w, a: torch.tanh(a @ w), smesh,
                               PipelineConfig(1, 6), ws, x)
        want = torch.stack([torch.tanh(xi @ ws[0]) for xi in x])
        perr = float((out - want).abs().max())
        print(f"distributed pipeline_forward (1 stage, 6 microbatches of "
              f"(2, 64)) == the plain stage loop: max |diff| {perr:.3g}")
        if perr != 0.0:
            raise AssertionError(f"pipeline: {perr}")
        # --- the placed packed serve -----------------------------------
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        params = init_params(cfg, torch.Generator(device=dev)
                             .manual_seed(0), device=dev)
        lp.launches = 0
        tree = pack_tree(cfg, params, QuantSpec(bits=3, group_size=32),
                         device=dev)
        pack_launches = lp.launches
        del params
        rng = np.random.default_rng(0)
        prompts = [rng.integers(1, cfg.vocab_size,
                                int(rng.integers(2, 6))).tolist()
                   for _ in range(8)]
        per_step = {"stream_attention": cfg.n_layers,
                    "stream_matmul": 7 * cfg.n_layers}
        _, tokens, plain_ms = serve(cfg, tree, prompts, 3, per_step,
                                    label=" (unplaced)")
        pts = place(tree, packed_tree_shardings(tree, mesh))
        with use_mesh(mesh):
            counts, placed_tokens, placed_ms = serve(
                cfg, pts, prompts, 3, per_step,
                label=" (placed by packed_tree_shardings)")
        same = placed_tokens == tokens
        print(f"distributed packed serve: tokens equal to the unplaced "
              f"serve's: {same} (8/8 requests, 16 tokens each); ms per "
              f"step placed {placed_ms:.3f} vs unplaced {plain_ms:.3f}")
        if not same:
            raise AssertionError("placed serve tokens differ")
        figures["serve"] = {"ms_per_step": placed_ms,
                            "unplaced_ms_per_step": plain_ms,
                            "tokens_equal": same}
        del tree, pts
        figures["jamba_train"], scan_launches = placed_jamba_step(mesh, dev)
        figures["launches"] = {"stream_matmul": counts["stream_matmul"],
                               "stream_attention":
                                   counts["stream_attention"],
                               "pack_layout_fused": pack_launches,
                               "ssd_scan": scan_launches}
    finally:
        dist.destroy_process_group()
        store.cleanup()
    if dist.is_initialized():
        raise AssertionError("the process group outlived its phase")
    return figures


def placed_jamba_step(mesh, dev) -> tuple[dict, int]:
    """The jamba train step placed on ``mesh`` against the unplaced step,
    from one state and batch: :func:`train_jamba_grad`'s size (f32,
    ``moe=None``, one period of 7 Mamba sublayers and an attention one,
    d_model 128, B=2, T=256), ``JAMBA_DIST_STEPS`` steps each.  Returns
    the figures and the ``ssd_scan`` launches of the placed steps (the
    Mamba scans, fed this rank's rows as plain tensors, run the kernel:
    7 in a step's forward and 7 in its remat recompute)."""
    import dataclasses

    import torch

    from repro_torch.configs import JAMBA_1_5_LARGE
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.launch.sharding import (
        batch_sharding,
        opt_state_shardings,
        param_shardings,
        place,
    )
    from repro_torch.launch.steps import build_train_step, init_train_state
    from repro_torch.models.shard_utils import local, use_mesh

    cfg = dataclasses.replace(JAMBA_1_5_LARGE.reduced(moe=None, n_layers=8),
                              dtype="float32")
    state = init_train_state(cfg, torch.Generator(device=dev)
                             .manual_seed(2), dev)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 257))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(dev),
             "labels": torch.from_numpy(toks[:, 1:]).to(dev)}
    step = build_train_step(cfg)

    def run(st, b, placed: bool):
        losses, ms = [], []
        for _ in range(JAMBA_DIST_STEPS):
            _sync(dev)
            t0 = time.perf_counter()
            with use_mesh(mesh) if placed else contextlib.nullcontext():
                st, m = step(st, b)
            _sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(local(m["loss"])))
        return losses, ms

    plain_losses, plain_ms = run(state, batch, False)
    ps_ = param_shardings(state["params"], mesh, fsdp=True)
    placed = place(state, {"params": ps_, "opt": opt_state_shardings(
        state["opt"], ps_, mesh)})
    ls.launches = 0
    losses, ms = run(placed, place(batch, batch_sharding(batch, mesh)), True)
    launches = ls.launches
    err = max(abs(a - b) for a, b in zip(losses, plain_losses))
    rel = err / max(abs(b) for b in plain_losses)
    print(f"distributed train jamba ({cfg.name} reduced, moe=None, "
          f"n_layers=8, f32, B=2 T=256, {JAMBA_DIST_STEPS} steps, placed "
          f"on the (1, 1) mesh): losses {[round(x, 6) for x in losses]} vs "
          f"unplaced {[round(x, 6) for x in plain_losses]}, max |diff| "
          f"{err:.3g} (rel {rel:.3g}, gate {SHARDED_LOSS_RTOL}); ssd_scan "
          f"launches {launches} in the placed steps (the scan's autograd "
          f"Function, the kernel forward); ms per step placed "
          f"{[round(x, 1) for x in ms]} vs unplaced "
          f"{[round(x, 1) for x in plain_ms]}")
    want = 14 * JAMBA_DIST_STEPS if dev.type == "cuda" else 0
    if not rel <= SHARDED_LOSS_RTOL or not np.isfinite(losses).all() \
            or launches != want:
        raise AssertionError(f"placed jamba step: losses {losses} against "
                             f"{plain_losses}, {launches} ssd_scan launches")
    return ({"losses": losses, "unplaced_losses": plain_losses,
             "max_abs_diff": err, "ms_per_step": ms,
             "unplaced_ms_per_step": plain_ms,
             "ssd_scan_launches": launches}, launches)


def dryrun_phase(measured: dict, *, cells=None) -> dict:
    """The dry run (step 18 of the docstring), on the host.
    ``measured``: the training phase's smollm-135m figures (ms per step,
    peak GB, model TFLOP); ``cells``: (arch, shape name) pairs, every
    production cell by default."""
    from repro_torch.configs import ARCH_IDS, ShapeConfig, shape_cells
    from repro_torch.launch.dryrun import run_cell, run_cells
    from repro_torch.launch.mesh import AbstractMesh

    out = ROOT / "artifacts" / "torch_dryrun"
    shape = ShapeConfig("train_measured", TRAIN_S, TRAIN_B, "train")
    r = run_cell("smollm-135m", "train_4k", False, out, shape=shape,
                 mesh=AbstractMesh((1, 1), ("data", "model")),
                 tag="measured")
    rt = r["roofline"]
    bound_ms = max(rt["compute_s"], rt["memory_s"],
                   rt["collective_s"]) * 1e3
    counted_gb = r["memory"]["peak_bytes"] / 1e9
    ratio = measured["ms_per_step"] / bound_ms
    print(f"dryrun smollm-135m measured cell (B={TRAIN_B} S={TRAIN_S}, one "
          f"card): counted {r['cost']['flops'] / 1e12:.3f} TFLOP a step "
          f"(train_flops {measured['model_tflop_per_step']:.3f}); counted "
          f"bytes per card {counted_gb:.2f} GB (argument "
          f"{r['memory']['argument_bytes'] / 1e9:.2f} + temp "
          f"{r['memory']['temp_bytes'] / 1e9:.2f}) vs measured peak "
          f"{measured['peak_gb']:.2f} GB; roofline bound {bound_ms:.2f} ms "
          f"({rt['bottleneck']}: compute {rt['compute_s'] * 1e3:.2f} ms, "
          f"memory {rt['memory_s'] * 1e3:.2f} ms over "
          f"{r['cost']['bytes accessed'] / 1e9:.1f} GB counted) vs "
          f"measured {measured['ms_per_step']:.2f} ms a step: "
          f"{ratio:.2f}x the bound")
    cells = cells or [(a, sc.name) for a in ARCH_IDS for sc in shape_cells(a)]
    t0 = time.perf_counter()
    results = run_cells(cells, False, out)
    wall = time.perf_counter() - t0
    bad = []
    for res in results:
        if res["status"] != "ok":
            print(f"dryrun {res['arch']} x {res['shape']} x {res['mesh']}: "
                  f"{res['status']} {res['error'][:300]}")
            bad.append(res)
            continue
        rr = res["roofline"]
        print(f"dryrun {res['arch']} x {res['shape']} x {res['mesh']}: "
              f"{res['status']} peak {res['memory']['peak_bytes'] / 2**30:.2f}"
              f" GiB/card (fits 80 GB: {res['memory']['fits_80gb']}) "
              f"bottleneck={rr['bottleneck']} compute={rr['compute_s']:.3e} s "
              f"memory={rr['memory_s']:.3e} s "
              f"collective={rr['collective_s']:.3e} s")
    print(f"dryrun: {len(results) - len(bad)}/{len(results)} cells ok on "
          f"the (16, 16) mesh, counted in {wall:.1f} s")
    if bad or len(results) != len(cells):
        raise AssertionError(f"dry run: {len(bad)} cells not ok")
    return {"measured_cell": {
                "counted_tflop": r["cost"]["flops"] / 1e12,
                "train_flops_tflop": measured["model_tflop_per_step"],
                "counted_gb": counted_gb,
                "measured_peak_gb": measured["peak_gb"],
                "bound_ms": bound_ms, "bottleneck": rt["bottleneck"],
                "measured_ms": measured["ms_per_step"],
                "measured_over_bound": ratio},
            "cells_ok": len(results), "count_wall_s": wall,
            "bottlenecks": {f"{x['arch']}/{x['shape']}":
                            x["roofline"]["bottleneck"] for x in results}}


#: packed_serving's widths in the examples phase: its default int8 and
#: int4 (lane-packed, ``packed_matmul``), int3 (stream-direct,
#: ``stream_matmul``)
EXAMPLE_BITS = (8, 4, 3)
#: train_lm's ``--preset full`` (smollm-135m at full width and depth),
#: steps on the card at the example's seq 128, batch 8
FULL_PRESET_STEPS = 30
#: the fp8 KV case: smollm-135m, batch, greedy dense decode steps
FP8_B, FP8_STEPS = 4, 16


def _launch_counts() -> dict:
    from repro_torch.kernels import layout_decode as ld
    from repro_torch.kernels import layout_pack as lp
    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.kernels import stream_matmul as sm

    return {"stream_matmul": sm.launches, "packed_matmul": pm.launches,
            "pack_layout_fused": lp.launches,
            "decode_layout_fused": ld.fused_launches}


def _zero_launches() -> None:
    from repro_torch.kernels import layout_decode as ld
    from repro_torch.kernels import layout_pack as lp
    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.kernels import stream_matmul as sm

    sm.launches = pm.launches = lp.launches = ld.fused_launches = 0


def examples_phase(dev, card: str) -> tuple[dict, dict]:
    """The three examples through their ``main`` (step 19 of the
    docstring).  Returns the figures and the kernel launches of the
    examples' runs."""
    import tempfile

    import torch

    from repro_torch.examples import packed_serving, quickstart, train_lm
    from repro_torch.models.model import Model
    from repro_torch.models.quantized import packed_decode_step

    on_card = dev.type == "cuda"
    dev_args = [] if on_card else ["--device", "cpu"]
    figures: dict = {"card": card}
    launches = dict.fromkeys(_launch_counts(), 0)

    def counted(fn, want: dict):
        """``fn()`` with the counters zeroed before and read after; each
        read must be ``want``'s (absent: 0) on the card."""
        _zero_launches()
        out = fn()
        got = _launch_counts()
        if on_card and got != {k: want.get(k, 0) for k in got}:
            raise AssertionError(f"launches {got}, expected {want}")
        for k, n in got.items():
            launches[k] += n
        return out, got

    t0 = time.perf_counter()
    rep, got = counted(lambda: quickstart.main(dev_args),
                       {"decode_layout_fused": 1})
    first, last = sum(rep.losses[:5]) / 5, sum(rep.losses[-5:]) / 5
    figures["quickstart"] = {"s": time.perf_counter() - t0,
                             "loss_first5": first, "loss_last5": last}
    print(f"examples quickstart: {figures['quickstart']['s']:.1f} s; cuda "
          f"decode == numpy decode == codes; launches {got}; loss {first:.3f}"
          f" -> {last:.3f} over {rep.steps_run} steps")
    if not last < first:
        raise AssertionError("quickstart: the loss did not drop")

    for bits in EXAMPLE_BITS:
        t0 = time.perf_counter()
        n = packed_serving.config().n_layers
        # 7 matmuls a layer in each of 8 generation steps and the
        # agreement step; one pack and one restore decode a layer
        mm = "stream_matmul" if bits == 3 else "packed_matmul"
        res, got = counted(
            lambda: packed_serving.main(["--bits", str(bits), *dev_args]),
            {mm: 7 * n * 9, "pack_layout_fused": n,
             "decode_layout_fused": n})
        wall = time.perf_counter() - t0
        cfg, pp, first_toks = res["cfg"], res["tree"], res["first"]
        model = Model(cfg, remat="none")

        def fresh():
            return model.init_decode_state(len(first_toks),
                                           packed_serving.MAX_SEQ,
                                           device=dev)
        plain = packed_serving.generate(
            lambda st, t: packed_decode_step(cfg, pp, st, t, plain=True),
            fresh(), first_toks, 8)
        dense = packed_serving.generate(
            lambda st, t: model.decode_step(res["params"], st, t),
            fresh(), first_toks, 8)
        print(f"examples packed_serving int{bits}: {wall:.1f} s; packed "
              f"tokens {res['tokens']} (== the plain versions' on the "
              f"card: {plain == res['tokens']}); dense tokens {dense} "
              f"(equal: {dense == res['tokens']}); restore bit-identical "
              f"{res['restore_same']}; top-1 agreement "
              f"{res['agreement']:.0%}; launches {got}")
        figures[f"packed_serving_int{bits}"] = {
            "s": wall, "tokens": res["tokens"], "dense_tokens": dense,
            "restore_same": res["restore_same"],
            "agreement": res["agreement"], "launches": got}
        if plain != res["tokens"] or not res["restore_same"]:
            raise AssertionError(f"packed_serving int{bits}")
        del res, pp

    with tempfile.TemporaryDirectory(prefix="train_lm_") as d:
        t0 = time.perf_counter()
        rep = train_lm.main(["--ckpt", f"{d}/small", *dev_args])
        small_s = time.perf_counter() - t0
        figures["train_lm_small"] = {
            "s": small_s, "steps": rep.steps_run,
            "tail_loss": float(np.mean(rep.losses[-10:])),
            "uniform": float(np.log(2048))}
        print(f"examples train_lm (small preset, {rep.steps_run} steps): "
              f"{small_s:.1f} s, tail loss "
              f"{figures['train_lm_small']['tail_loss']:.3f} under the "
              f"bar 0.8 x {float(np.log(2048)):.3f} (the example asserts "
              f"it)")
        figures["train_lm_full"] = train_lm_full(train_lm, f"{d}/full", dev)
    return figures, launches


def train_lm_full(train_lm, ckpt: str, dev) -> dict:
    """train_lm's ``--preset full`` recipe for ``FULL_PRESET_STEPS``
    steps through the example's ``train`` (its learning bar is for 300
    steps of the small preset, so it is reported, not gated), each step
    timed between device syncs."""
    import torch

    cfg = train_lm.config("full", 128)
    ms: list[float] = []
    real = train_lm.build_train_step

    def timed_build(*a, **kw):
        step = real(*a, **kw)

        def timed(state, batch):
            _sync(dev)
            t0 = time.perf_counter()
            out = step(state, batch)
            _sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            return out
        return timed

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    train_lm.build_train_step = timed_build
    try:
        rep = train_lm.train(cfg, FULL_PRESET_STEPS, 128, 8, ckpt, dev)
    finally:
        train_lm.build_train_step = real
    peak = mem_gb() if dev.type == "cuda" else 0.0
    med = float(np.median(ms[1:]))
    tail = float(np.mean(rep.losses[-10:]))
    print(f"examples train_lm --preset full ({cfg.name}, "
          f"{cfg.param_count() / 1e6:.1f}M params, seq 128, batch 8, "
          f"{rep.steps_run} steps): losses {rep.losses[0]:.3f} -> "
          f"{rep.final_loss:.3f} (tail {tail:.3f}; the small preset's bar "
          f"0.8 x {np.log(cfg.vocab_size):.3f} met: "
          f"{tail < 0.8 * np.log(cfg.vocab_size)}); ms per step median "
          f"{med:.1f} (first {ms[0]:.1f}), {8 * 128 / med * 1e3:.0f} "
          f"tokens/s; peak {peak:.2f} GB")
    if rep.steps_run != FULL_PRESET_STEPS or \
            not np.isfinite(rep.losses).all():
        raise AssertionError(f"train_lm full: {rep}")
    return {"steps": rep.steps_run, "losses": rep.losses,
            "ms_per_step": ms, "median_ms": med, "peak_gb": peak}


def fp8_kv_phase(cfg, dev, card: str) -> dict:
    """Greedy dense decode of ``cfg`` (smollm-135m at full width and
    depth, bf16) from one set of parameters and prompts, with a bf16 and
    a float8_e5m2 KV cache (step 20 of the docstring)."""
    import dataclasses

    import torch

    from repro_torch.models.model import Model
    from repro_torch.models.params import init_params

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    first = torch.as_tensor(np.random.default_rng(8).integers(
        1, cfg.vocab_size, FP8_B), dtype=torch.int32, device=dev)
    runs = {}
    for kv in ("bfloat16", "float8_e5m2"):
        model = Model(dataclasses.replace(cfg, kv_cache_dtype=kv),
                      remat="none")
        st = model.init_decode_state(FP8_B, FP8_STEPS, device=dev)
        nbytes = sum(st[k].numel() * st[k].element_size()
                     for k in ("k_cache", "v_cache"))
        toks, logits, ms, t = [], [], [], first
        for _ in range(FP8_STEPS):
            _sync(dev)
            t0 = time.perf_counter()
            lg, st = model.decode_step(params, st, t)
            _sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            t = lg.argmax(-1).to(torch.int32)
            toks.append(t.tolist())
            logits.append(lg.float())
        runs[kv] = {"dtype": str(st["k_cache"].dtype), "bytes": nbytes,
                    "ms": ms, "toks": toks, "logits": logits}
    b16, f8 = runs["bfloat16"], runs["float8_e5m2"]
    diffs = [float((a - b).abs().max()) for a, b in
             zip(b16["logits"], f8["logits"])]
    bars = [0.35 * float(a.abs().max()) + 0.5 for a in b16["logits"]]
    agree = float(np.mean(np.asarray(b16["toks"]) == np.asarray(f8["toks"])))
    med = {k: float(np.median(r["ms"][1:])) for k, r in runs.items()}
    print(f"fp8 kv ({cfg.name}, {cfg.n_layers} layers, bf16 weights, "
          f"B={FP8_B}, {FP8_STEPS} greedy dense decode steps from one "
          f"state): cache {f8['dtype']} {f8['bytes']} B vs {b16['dtype']} "
          f"{b16['bytes']} B (half: {2 * f8['bytes'] == b16['bytes']}); "
          f"max |dlogit| by step up to {max(diffs):.4f} against the "
          f"reference's bar (0.35 max|bf16| + 0.5) of at least "
          f"{min(bars):.3f}; greedy tokens equal {agree:.0%}; ms per step "
          f"(median) fp8 {med['float8_e5m2']:.3f} vs bf16 "
          f"{med['bfloat16']:.3f} ({card})")
    if f8["dtype"] != "torch.float8_e5m2" or 2 * f8["bytes"] != b16["bytes"] \
            or any(d >= b for d, b in zip(diffs, bars)) or not all(
                torch.isfinite(x).all() for x in f8["logits"]):
        raise AssertionError(f"fp8 kv: {diffs} against {bars}")
    return {"cache_bytes": {k: r["bytes"] for k, r in runs.items()},
            "max_abs_dlogit": diffs, "bar": bars, "token_agreement": agree,
            "ms_per_step": {k: r["ms"] for k, r in runs.items()},
            "median_ms": med}


def run_train(dev, card: str) -> tuple[dict, int]:
    """The training phases; returns the ``train`` figures and the
    ``ssd_scan`` launches of the jamba gradient."""
    from repro_torch.configs import SMOLLM_135M

    figures = {"smollm_135m": train_smollm(SMOLLM_135M, dev, card),
               "card_vs_cpu": train_step_card_vs_cpu(SMOLLM_135M, dev)}
    figures["jamba_ssd_scan_grad"], launches = train_jamba_grad(dev)
    return figures, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import (
        QWEN2_VL_2B,
        RWKV6_3B,
        SMOLLM_135M,
        STABLELM_3B,
        WHISPER_MEDIUM,
    )
    from repro_torch.kernels import build

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    times = build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s wall "
          f"({', '.join(f'{k} {v:.2f} s' for k, v in times.items())})")
    for name in build.KERNELS:
        for line in build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    dev = torch.device("cuda")
    phases = {}
    t0 = time.perf_counter()
    kernels, ckpt = run(SMOLLM_135M, dev)
    phases["smollm-135m"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    planner, direct = planner_phase(SMOLLM_135M, dev)
    phases["planner"] = time.perf_counter() - t0
    for k in kernels:
        if k["name"] == "stream_matmul":
            k["stream_direct"] = direct
        elif k["name"] in ("pack_layout_fused", "decode_layout_fused"):
            k["launches"] += sum(row["launches"][k["name"]]
                                 for row in direct.values())
    torch.cuda.empty_cache()       # the smollm trees are gone with run()
    t0 = time.perf_counter()
    cfg, cuts = jamba_config()
    row, launches = run_jamba(cfg, cuts, dev)
    phases["jamba-1.5-large-398b"] = time.perf_counter() - t0
    kernels.append({"name": "ssd_scan", "route": "cuda",
                    "source": "src/repro_torch/csrc/ssd_scan.cu",
                    "replaces": "src/repro/kernels/linear_scan.py:92",
                    "launches": launches, **row})
    torch.cuda.empty_cache()       # jamba's weights are gone with run_jamba()
    by_name = {k["name"]: k for k in kernels}
    served = {}

    def packed_phase(pcfg, key: str, seed: int) -> None:
        t0 = time.perf_counter()
        rows, paths = run_packed(pcfg, dev, seed)
        phases[pcfg.name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        for name, row in rows.items():
            by_name[name][key] = {**row, "launches": paths[name]}
        by_name["pack_layout_fused"]["launches"] += \
            paths["pack_layout_fused"]
        served[pcfg.name.replace("-", "_").replace(".", "_")] = \
            paths["ms_per_step"]

    packed_phase(STABLELM_3B, "stablelm", 3)
    t0 = time.perf_counter()
    cfg, cuts = moonshot_config()
    served["moonshot_v1_16b_a3b"] = run_moonshot(cfg, cuts, dev)
    phases["moonshot-v1-16b-a3b"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    packed_phase(QWEN2_VL_2B, "qwen2_vl", 11)
    for fcfg, fn in ((RWKV6_3B, run_rwkv), (WHISPER_MEDIUM, run_whisper)):
        t0 = time.perf_counter()
        served[fcfg.name.replace("-", "_")] = fn(fcfg, dev)
        phases[fcfg.name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train, train_launches = run_train(dev, card)
    phases["train"] = time.perf_counter() - t0
    by_name["ssd_scan"]["launches"] += train_launches
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    distributed = distributed_phase(SMOLLM_135M, dev, card)
    phases["distributed"] = time.perf_counter() - t0
    for name, n in distributed["launches"].items():
        by_name[name]["launches"] += n
        by_name[name]["distributed_launches"] = n
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    distributed["dryrun"] = dryrun_phase(train["smollm_135m"])
    phases["dryrun"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    examples, ex_launches = examples_phase(dev, card)
    phases["examples"] = time.perf_counter() - t0
    for name, n in ex_launches.items():
        by_name[name]["launches"] += n
        by_name[name]["examples_launches"] = n
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    examples["fp8_kv"] = fp8_kv_phase(SMOLLM_135M, dev, card)
    phases["fp8 kv"] = time.perf_counter() - t0
    print("phases (wall s): " + ", ".join(f"{k} {v:.1f}"
                                          for k, v in phases.items()))
    print(json.dumps({"serve": served}))
    print(json.dumps({"checkpoint": ckpt}))
    print(json.dumps({"planner": planner}))
    print(json.dumps({"train": train}))
    print(json.dumps({"distributed": distributed}))
    print(json.dumps({"examples": examples}))
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


#: the widths ``matmul_direct`` serves through ``stream_matmul`` in the
#: planner phase: the ones no lane-packed view holds (int3 is served)
PLANNER_BITS = (5, 6, 7)
#: stream-direct matmul against its plain version in the planner phase
DIRECT_TOL = dict(rtol=1e-5, atol=1e-4)


def bundle_layer_problems(cfg, group: int = 32) -> dict:
    """bits -> the layer bundle problem of ``cfg`` at ``bits``, bits 2-8."""
    from repro_torch.plan import bundle_problem, layer_bundle_spec
    from repro_torch.quant import QuantSpec

    return {bits: bundle_problem(layer_bundle_spec(
        cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
        QuantSpec(bits=bits, group_size=group))) for bits in range(2, 9)}


def planner_pool(cfg) -> dict:
    """``schedule_many`` of the layer bundles at bits 2-8, group 32, each
    repeated over the stack's layers, with a pool of 4 (after CUDA is
    initialised; the pool's fallback warning is an error), serially, and
    cold: the same count runs, and pool and serial stats equal."""
    import warnings

    from repro_torch.core import iris

    probs = bundle_layer_problems(cfg)
    batch = [p for p in probs.values() for _ in range(cfg.n_layers)]
    t0 = time.perf_counter()
    pooled = iris.LayoutCache()
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        got = iris.schedule_many(batch, cache=pooled, workers=4)
    pool_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    serial = iris.LayoutCache()
    want = iris.schedule_many(batch, cache=serial, workers=1)
    serial_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cold = {bits: iris.schedule(p, cache=None, warm_start=False)
            for bits, p in probs.items()}
    cold_s = time.perf_counter() - t0
    cold_runs = [cold[bits].count_intervals for bits in probs
                 for _ in range(cfg.n_layers)]
    if [lay.count_intervals for lay in got] != cold_runs \
            or [lay.count_intervals for lay in want] != cold_runs:
        raise AssertionError("schedule_many: pool, serial and cold runs "
                             "differ")
    if pooled.stats != serial.stats:
        raise AssertionError(f"schedule_many stats: pool {pooled.stats} "
                             f"!= serial {serial.stats}")
    print(f"planner schedule_many: {len(batch)} problems ({len(probs)} "
          f"unique: bits 2-8, group 32, x {cfg.n_layers} layers), pool of "
          f"{iris._effective_workers(4, len(probs))} {pool_s:.3f} s wall, "
          f"serial {serial_s:.3f} s, cold one-by-one {cold_s:.3f} s; "
          f"pool == serial == cold; stats {pooled.stats}; C_max "
          f"{[cold[b].c_max for b in probs]}")
    return {"pool_s": pool_s, "serial_s": serial_s, "cold_s": cold_s,
            "problems": len(batch), "unique": len(probs)}


def planner_warm_and_disk(cfg) -> dict:
    """Chained warm starts off smollm's int5 layer problem (one array
    re-specified, one inserted, one deleted, each off the one before),
    each equal to a cold run; a disk round trip into a fresh cache (one
    disk hit) and a tampered entry (a coverage gap under a fresh digest,
    which only the analysis gate sees: one ``disk_rejects``, then a
    correct re-plan)."""
    import shutil
    import tempfile
    import warnings

    from repro_torch.core import iris
    from repro_torch.core.task import ArraySpec, LayoutProblem

    base = bundle_layer_problems(cfg)[5]
    arrays = list(base.arrays)
    sub = list(arrays)
    a = sub[0]                                       # attn_norm
    sub[0] = ArraySpec(a.name, a.width, a.depth + 3, a.due, a.max_lanes)
    ins = list(sub)
    ins.insert(8, ArraySpec("wo_bias", arrays[7].width, 50, arrays[7].due))
    dele = [x for x in ins if x.name != "wk_scales"]
    chain = [LayoutProblem(m=base.m, arrays=tuple(x))
             for x in (sub, ins, dele)]
    cache = iris.LayoutCache()
    iris.schedule(base, cache=cache)
    t0 = time.perf_counter()
    warm = [iris.schedule(p, cache=cache) for p in chain]
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cold = [iris.schedule(p, cache=None, warm_start=False) for p in chain]
    cold_s = time.perf_counter() - t0
    if [w.count_intervals for w in warm] != \
            [c.count_intervals for c in cold]:
        raise AssertionError("warm-started layouts differ from cold runs")
    if cache.warm_starts != len(chain):
        raise AssertionError(f"warm_starts {cache.warm_starts} != "
                             f"{len(chain)}")
    print(f"planner warm starts: sub / ins / del chained off smollm's int5 "
          f"layer problem, {cache.warm_starts} warm starts, each == a cold "
          f"run; warm {warm_s:.3f} s, cold {cold_s:.3f} s; stats "
          f"{cache.stats}")
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="iris-layouts-"))
    try:
        lay = iris.schedule(base, cache=iris.LayoutCache(cache_dir=tmp))
        reader = iris.LayoutCache(cache_dir=tmp)
        hit = reader.lookup(base)
        if hit is None or hit.count_intervals != lay.count_intervals \
                or reader.disk_hits != 1:
            raise AssertionError(f"disk round trip: {reader.stats}")
        (path,) = tmp.glob("*.json")
        obj = json.loads(path.read_text())
        counts = obj["payload"]["intervals"][0][1]
        counts[-1][1] -= 1                          # a coverage gap
        obj["sha256"] = iris.LayoutCache._payload_digest(obj["payload"])
        path.write_text(json.dumps(obj))
        tampered = iris.LayoutCache(cache_dir=tmp)
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always", RuntimeWarning)
            again = iris.schedule(base, cache=tampered)
        if tampered.disk_rejects != 1 or \
                again.count_intervals != lay.count_intervals:
            raise AssertionError(f"tampered entry: {tampered.stats}")
        print(f"planner disk tier: round trip into a fresh cache "
              f"{reader.stats['disk_hits']} disk hit; a tampered entry "
              f"(coverage gap, fresh digest): {tampered.disk_rejects} "
              f"disk reject ({str(seen[0].message)[:70]}...), re-planned "
              f"== the original; stats {tampered.stats}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"warm_starts": cache.warm_starts, "warm_s": warm_s,
            "warm_cold_s": cold_s, "disk_hits": reader.disk_hits,
            "disk_rejects": tampered.disk_rejects}


def bundle_data(bundle, rng) -> dict[str, np.ndarray]:
    """Seeded codes for the weights, bf16 patterns of positive scales
    and of norm values for the rest (uint64, one per element)."""
    data = {}
    for b in bundle:
        if b.width_bits == 16:
            vals = rng.uniform(0.01, 0.1, b.n_elems) \
                if b.name.endswith("_scales") \
                else rng.standard_normal(b.n_elems)
            data[b.name] = (vals.astype(np.float32).view(np.uint32)
                            >> np.uint32(16)).astype(np.uint64)
        else:
            data[b.name] = rng.integers(0, 1 << b.width_bits, b.n_elems,
                                        dtype=np.uint64)
    return data


def stream_direct(cfg, bits: int, rng, dev) -> dict:
    """One smollm layer bundle at ``bits`` (group 32) through the
    stream-direct path on the card: ``pack_bundle`` on the host;
    ``pack_layout_fused`` of the same padded pieces on the card (B4) ==
    that buffer; ``decode_layout_fused`` on the card (B5) == the data;
    ``stream_words`` on the card; ``LayerStackPlan.matmul_direct`` of
    the 7 matrices at x (4, K) within ``DIRECT_TOL`` of the plain
    version and bit-equal to ``Plan.matmul_direct`` of the uint8 rows.
    Launches are counted from 0 just before the path and read just
    after; then the 7 matmuls are timed."""
    import torch

    from repro_torch.api import plan_layer_stack
    from repro_torch.core.iris import LayoutCache
    from repro_torch.core.util import pad_bundle_elements
    from repro_torch.kernels import layout_decode as ld
    from repro_torch.kernels import layout_pack as lp
    from repro_torch.kernels import stream_matmul as sm
    from repro_torch.kernels.ref import table_tensor
    from repro_torch.plan import pack_bundle
    from repro_torch.quant import QuantSpec

    cache = LayoutCache()
    stack = plan_layer_stack(cfg, QuantSpec(bits=bits, group_size=32),
                             n_layers=1, cache=cache)
    data = bundle_data(stack.bundle, rng)
    t0 = time.perf_counter()
    host = pack_bundle(list(stack.bundle), data=data, cache=cache)
    host_s = time.perf_counter() - t0
    lay, prog, ew = stack.layout, stack.exec_program(), stack.elem_widths
    pieces = pad_bundle_elements(stack.problem, prog, data)
    mats = layer_mats(cfg)
    xs = {name: torch.from_numpy(rng.standard_normal(
        (SERVE_M, k), np.float32)).to(dev) for name, (k, n) in mats.items()}
    torch.cuda.synchronize()
    lp.launches = ld.fused_launches = sm.launches = 0
    packed = lp.pack_layout_fused(lay, pieces, elem_widths=ew, device=dev)
    decoded = ld.decode_layout_fused(lay, torch.from_numpy(packed).to(dev),
                                     elem_widths=ew)
    words = sm.stream_words(prog, torch.from_numpy(host.buffer).to(dev))
    got = {name: stack.matmul_direct(x, words, name, mats[name])
           for name, x in xs.items()}
    via_rows = {name: stack.plans[0].matmul_direct(
        x, host.buffer, name, mats[name], scales=f"{name}_scales",
        group_size=32, elem_widths=ew) for name, x in xs.items()}
    torch.cuda.synchronize()
    launches = {"pack_layout_fused": lp.launches,
                "decode_layout_fused": ld.fused_launches,
                "stream_matmul": sm.launches}
    if launches != {"pack_layout_fused": 1, "decode_layout_fused": 1,
                    "stream_matmul": 2 * len(mats)}:
        raise AssertionError(f"int{bits} stream-direct launches {launches}")
    if not np.array_equal(packed, host.buffer):
        raise AssertionError(f"int{bits}: the card's pack != pack_bundle")
    for i, spec in enumerate(lay.problem.arrays):
        if not np.array_equal(decoded[spec.name].cpu().numpy(),
                              pieces[spec.name].view(np.int64)):
            raise AssertionError(f"int{bits}: decode of {spec.name} != "
                                 "the data")
    if not np.array_equal(words.cpu().numpy().view(np.uint32),
                          prog.buffer_words32(host.buffer).reshape(-1)):
        raise AssertionError(f"int{bits}: stream_words on the card != host")
    row = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "library_device_ms": 0.0, "bytes": 0, "flops": 0}
    max_err = 0.0
    for name, (k, n) in mats.items():
        x = xs[name]
        tabs = stack.stream_tables(name, (k, n))
        w_tab, s_tab = (table_tensor(tabs.w_tab, dev),
                        table_tensor(tabs.s_tab, dev))
        want = sm.stream_matmul_plain(x, words, w_tab, s_tab, bits=bits,
                                      group_size=32)
        err = float((got[name] - want).abs().max())
        max_err = max(max_err, err)
        if not torch.allclose(got[name], want, **DIRECT_TOL):
            raise AssertionError(f"matmul_direct int{bits} {name}: max "
                                 f"|err| {err:.3g}")
        if not torch.equal(got[name], via_rows[name]):
            raise AssertionError(f"matmul_direct int{bits} {name}: words "
                                 "!= uint8 rows")

        def kernel():
            return sm.stream_matmul(x, words, w_tab, s_tab, bits=bits,
                                    group_size=32)

        dense = sm.stream_matmul_plain(torch.eye(k, device=dev), words,
                                       w_tab, s_tab, bits=bits,
                                       group_size=32)
        row["ms"] += time_ms(kernel)
        row["device_ms"] = add_ms(row["device_ms"],
                                  device_ms(kernel, "stream_matmul_kernel"))
        row["plain_ms"] += time_ms(lambda: sm.stream_matmul_plain(
            x, words, w_tab, s_tab, bits=bits, group_size=32), iters=5)
        row["library_ms"] += time_ms(lambda: torch.matmul(x, dense))
        row["library_device_ms"] = add_ms(
            row["library_device_ms"],
            device_ms(lambda: torch.matmul(x, dense), None))
        # codes, scales and both offset tables as each call reads them
        row["bytes"] += (x.numel() * 4 + -(-k * n * bits // 8)
                         + s_tab.numel() * 2
                         + (w_tab.numel() + s_tab.numel()) * 4
                         + SERVE_M * n * 4)
        row["flops"] += 2 * SERVE_M * k * n
    bms, by = bound_ms(row["bytes"], row["flops"])
    print(f"planner matmul_direct int{bits}: C_max {lay.c_max}, "
          f"pack_bundle {host_s:.3f} s on the host; the card's "
          f"pack_layout_fused == its buffer, decode_layout_fused == the "
          f"data, stream_words == the host words; 7 matmuls at M={SERVE_M} "
          f"== plain (max|err| {max_err:.3g}) and == Plan.matmul_direct of "
          f"the uint8 rows; launches {launches}; one layer: kernel "
          f"{row['ms']:.4f} ms (device {fmt_ms(row['device_ms'])} ms)  "
          f"plain {row['plain_ms']:.4f} ms  library(matmul of dequantized "
          f"W) {row['library_ms']:.4f} ms (device "
          f"{fmt_ms(row['library_device_ms'])} ms)  bound {bms:.5f} ms "
          f"({by}; {row['bytes']} B with the tables as read)")
    return {"launches": launches, "max_abs_err": max_err, "ms": row["ms"],
            "device_ms": row["device_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": bms, "bound_by": by,
            "library_ms": row["library_ms"],
            "library_device_ms": row["library_device_ms"]}


def planner_phase(cfg, dev) -> tuple[dict, dict]:
    """The planner service at smollm's full width: :func:`planner_pool`,
    :func:`planner_warm_and_disk`, the layout explorer's four tables,
    and :func:`stream_direct` at ``PLANNER_BITS``.  Returns the planner
    figures and the stream-direct rows by width."""
    from repro_torch.examples import layout_explorer

    figures = planner_pool(cfg)
    figures.update(planner_warm_and_disk(cfg))
    print(f"planner dse: the layout explorer for {cfg.name} (paper "
          "Figs. 3-5, Tables 7 and 6, the serving-stream DSE)")
    t0 = time.perf_counter()
    layout_explorer.main(["--arch", cfg.name])
    figures["dse_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(25)
    rows = {f"int{bits}": stream_direct(cfg, bits, rng, dev)
            for bits in PLANNER_BITS}
    return figures, rows


def kv_extras(cache) -> None:
    """``page_rows_u8`` of one page == its slice of ``host_pages()``, and
    ``stream_bytes()`` == the pages' bytes."""
    man = cache.manifest
    layer, slot, page = cache.n_layers - 1, cache.n_slots - 1, 0
    rows = cache.page_rows_u8(layer, slot, page)
    want = cache.host_pages()[layer, slot, page].view(np.uint8).reshape(
        man.c_max, -1)[:, :man.row_bytes]
    if not np.array_equal(rows, want):
        raise AssertionError("page_rows_u8 != host_pages()")
    if cache.stream_bytes() != cache.pages.numel() * 4:
        raise AssertionError("stream_bytes() != the pages' bytes")
    print(f"planner kv: page_rows_u8({layer}, {slot}, {page}) {rows.shape} "
          f"== host_pages(); stream_bytes() {cache.stream_bytes()} over "
          f"{cache.n_layers} layers x {cache.n_slots} slots x "
          f"{cache.n_pages} pages")


def run(cfg, dev) -> tuple[list[dict], dict]:
    """Every smollm phase after the build, on ``cfg`` (smollm-135m at full
    width and depth from :func:`main`); returns the ``kernels`` rows of
    its six kernels and the checkpoint phase's figures."""
    import torch

    from repro_torch.engine import Engine, EngineConfig, PackedAdapter
    from repro_torch.models.params import init_params
    from repro_torch.quant import QuantSpec

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    tree, pack3_launches, pieces3 = counted_pack_tree(
        cfg, params, QuantSpec(bits=3, group_size=32), dev)
    tree.stream_words()
    torch.cuda.synchronize()
    print(f"pack int3: {tree.summary()} in {time.perf_counter() - t0:.2f} s "
          f"({pack3_launches} pack_layout_fused launches)")

    rows = {"stream_matmul": check_stream_matmul(tree, rng, dev),
            "stream_attention": check_stream_attention(cfg, rng, dev)}
    # its own generator: the later phases draw what they drew before
    rows["stream_attention"]["smax_2048"] = check_long_attention(
        cfg, np.random.default_rng(2048), dev)
    rows["stream_attention"]["rep12"] = check_rep12_attention(dev)
    pl, buf, slot_launches = front_door(cfg, tree, dev)
    tree4, qts4, pack4_launches, pieces4 = int4_pack(cfg, params, dev)
    if pack3_launches != tree.n_layers:
        raise AssertionError(f"int3 pack_tree: {pack3_launches} pack "
                             f"launches, expected {tree.n_layers}")
    decode_launches = stack_decode(
        ((tree, quantized(params, tree.spec)), (tree4, qts4)), dev)
    del params
    rows["packed_matmul"] = check_packed_matmul(tree4, rng, dev)
    rows["pack_layout_fused"] = check_pack_kernel(
        ((tree, pieces3), (tree4, pieces4)), dev)
    rows["decode_layout_fused"] = check_decode_kernel((tree, tree4), dev)
    rows["decode_slot"] = check_decode_slot(pl, buf, dev)

    prompts = [rng.integers(1, cfg.vocab_size,
                            int(rng.integers(2, 6))).tolist()
               for _ in range(8)]
    per_layer = {"stream_attention": cfg.n_layers}
    decode_check(cfg, tree4, rng, dev, kv_bits=4)
    counts4, _, _ = serve(cfg, tree4, prompts, 4,
                          {**per_layer, "packed_matmul": 7 * cfg.n_layers})
    decode_check(cfg, tree, rng, dev, kv_bits=3)
    counts3, tokens3, ms3 = serve(
        cfg, tree, prompts, 3,
        {**per_layer, "stream_matmul": 7 * cfg.n_layers})
    ckpt = checkpoint_phase(cfg, tree, tree4, prompts, dev,
                            (tokens3, ms3))
    profile_steps(Engine(PackedAdapter(cfg, tree, kv="packed", kv_bits=3),
                         EngineConfig(batch_size=4, max_seq=256,
                                      max_backlog=None)),
                  prompts, "int3 weights / int3 KV")
    profile_steps(Engine(PackedAdapter(cfg, tree4, kv="packed", kv_bits=4),
                         EngineConfig(batch_size=4, max_seq=256,
                                      max_backlog=None)),
                  prompts, "int4 weights / int4 KV")

    launches = {"stream_matmul": counts3["stream_matmul"],
                "stream_attention": counts3["stream_attention"],
                "packed_matmul": counts4["packed_matmul"],
                "pack_layout_fused": pack3_launches + pack4_launches,
                "decode_layout_fused": decode_launches,
                "decode_slot": slot_launches}
    meta = {
        "stream_matmul": ("src/repro_torch/csrc/stream_matmul.cu",
                          "src/repro/kernels/stream_matmul.py:183"),
        "stream_attention": ("src/repro_torch/csrc/stream_attention.cu",
                             "src/repro/kvcache/kernels/"
                             "stream_attention.py:99"),
        "packed_matmul": ("src/repro_torch/csrc/packed_matmul.cu",
                          "src/repro/kernels/packed_matmul.py:128"),
        "pack_layout_fused": ("src/repro_torch/csrc/layout_pack.cu",
                              "src/repro/kernels/layout_pack.py:125"),
        "decode_layout_fused": ("src/repro_torch/csrc/layout_decode.cu",
                                "src/repro/kernels/layout_decode.py:135"),
        "decode_slot": ("src/repro_torch/csrc/layout_decode.cu",
                        "src/repro/kernels/layout_decode.py:234"),
    }
    kernels = []
    for name, row in rows.items():
        src, replaces = meta[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        **row})
    return kernels, ckpt


if __name__ == "__main__":
    sys.exit(main())
