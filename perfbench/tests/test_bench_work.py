"""The work counts behind the rooflines and ``step_mfu``, against figures
worked by hand from stablelm-3b's shapes."""
import json
import pathlib

import pytest

from perfbench import peaks, spec
from perfbench.metrics import (
    packed_matmul_roofline,
    stream_attention_roofline,
    stream_matmul_roofline,
    step_mfu,
)
from perfbench.record import RunRecord, StepRecord, TraceRecord

ROOT = pathlib.Path(__file__).resolve().parents[2]
CONF = json.loads((ROOT / "perfbench/configs/stablelm-3b-int3.json")
                  .read_text())
SHAPE = spec.ModelShape.from_config(CONF)
Q3 = {"weight_bits": 3, "group_size": 32, "kv_bits": 3}

# stablelm-3b: 4 projections of 2560 x 2560 and 3 of 2560 x 6912 a layer
WEIGHTS = 32 * (4 * 2560 * 2560 + 3 * 2560 * 6912)      # 2,537,553,920
CODES = WEIGHTS * 3 // 8                                  # 951,582,720 B
SCALES = WEIGHTS // 32 * 2                                # 158,597,120 B
UNEMBED = 2560 * 50304 * 2                                # 257,556,480 B


def test_shapes_by_hand():
    assert WEIGHTS == 2_537_553_920
    assert sum(k * n for _, k, n in SHAPE.linears()) * 32 == WEIGHTS
    assert CODES + SCALES == 1_110_179_840                # the ~1.1 GB


def test_b1_launch_by_hand():
    flops, nbytes = stream_matmul_roofline.launch_work(16, 2560, 6912, 3, 32)
    assert flops == 2 * 16 * 2560 * 6912 == 566_231_040
    # codes + bf16 scales + x and out in bf16
    assert nbytes == 6_635_520 + 1_105_920 + 81_920 + 221_184 == 8_044_544


def test_b3_layer_by_hand():
    flops, nbytes = stream_attention_roofline.layer_work(SHAPE, 3, 16, 1600)
    assert flops == 4 * 1600 * 32 * 80 == 16_384_000
    # each token: 32 KV heads x (K and V: 80 int3 codes + a bf16 scale)
    assert nbytes == 1600 * 32 * 64 + 2 * 2 * 16 * 32 * 80 == 3_440_640


def test_step_by_hand():
    flops, nbytes = step_mfu.step_work(SHAPE, Q3, 16, 1600)
    kv = 32 * 1600 * 32 * 64
    assert nbytes == CODES + SCALES + UNEMBED + 16 * 2560 * 2 + kv \
        == 1_472_675_840
    assert flops == 2 * 16 * WEIGHTS + 2 * 16 * 2560 * 50304 \
        + 32 * 4 * 1600 * 32 * 80
    # bytes bound the step: ~0.44 ms
    assert peaks.bound_s(flops, nbytes) * 1e3 == pytest.approx(0.43960, rel=1e-4)


def _run(weight_path: str, kernel: str, dev_s: float) -> RunRecord:
    steps = [StepRecord(t0=0.0, rows=16, kv_tokens=1600, tokens=16)
             for _ in range(4)]
    tr = TraceRecord(window_s=1.0, steps=steps,
                     device=[(f"void {kernel}_kernel(float const*)", 0.0,
                              dev_s)],
                     launches=4 * 4600, idle_by_host={})
    return RunRecord(shape=SHAPE, quant={**Q3, "weight_path": weight_path},
                     mix={}, setup_s=1.0, w0=0.0, w1=0.1, steps=steps,
                     requests=[], trace=tr)


def test_roofline_is_bound_over_time():
    bound = 4 * stream_matmul_roofline.step_bound_s(SHAPE, Q3, 16)
    run = _run("stream", "stream_matmul", bound)
    assert stream_matmul_roofline.read(run) == pytest.approx(100.0)
    assert packed_matmul_roofline.read(run) is None   # B2 did not run
    run = _run("stream", "stream_matmul", 4 * bound)
    assert stream_matmul_roofline.read(run) == pytest.approx(25.0)


def test_counts_ignore_tables_and_views():
    """The counts read shapes only: the served layout (stream-direct with
    its offset tables, or lane-packed views) changes nothing, and B2's
    launch is counted exactly as B1's."""
    b = stream_matmul_roofline.step_bound_s(SHAPE, Q3, 16)
    a = _run("stream", "stream_matmul", b)
    c = _run("lane_packed", "packed_matmul", b)
    assert stream_matmul_roofline.read(a) == packed_matmul_roofline.read(c)
    assert step_mfu.read(a) == step_mfu.read(c)
    for mod in (stream_matmul_roofline, packed_matmul_roofline,
                stream_attention_roofline, step_mfu):
        text = pathlib.Path(mod.__file__).read_text()
        for word in ("repro_torch", "w_tab", "s_tab", "stream_tables",
                     "device_tables", ".packed["):
            assert word not in text, (mod.__name__, word)
