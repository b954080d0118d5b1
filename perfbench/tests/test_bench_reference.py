"""The plain reference against the program, at a reduced size of each
configuration, with the program's logits taken from the benchmark's own
sampler as the served path hands them over.

The reference computes in f32 and keeps activations in bf16 where the
configuration keeps them; the program hands out bf16 logits.  So the
logits the sampler sees lie within one bf16 rounding (2^-8 of their
size) of the reference's, and every served token is the reference's best
or within one bf16 step of it.  The one exception is a request in which
a key or value, one bf16 step apart on the two sides after two summation
orders, lies at a rounding boundary of its int-N code: the code differs,
and every later logit of that request moves by more than a rounding (on
the reduced stablelm at seed 2, one request of twelve reads 2.0%, and
with int8 KV the same request agrees).  At most one request in ten may
be such a one; its served tokens are still held to the reference's best.
"""
import pytest
import torch

from perfbench.tests.tiny import TINY, served_readings, tiny_config, tiny_mix

#: one bf16 rounding of a logit, as a share of its size (at least 1)
BF16_ROUNDING = 2.0 ** -8


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("base", sorted(TINY))
def test_program_logits_are_the_references(base, seed):
    r = served_readings(tiny_config(base, **TINY[base]), tiny_mix(compare=12),
                        seed, steps=60, capture=True)
    assert r["tokens"] >= 50
    apart = 0
    for prog, ref in zip(r["program"], r["reference"]):
        assert prog.shape == ref.shape
        rel = (prog - ref).abs() / ref.abs().clamp_min(1.0)
        apart += float(rel.max()) > BF16_ROUNDING * 1.01
        best = ref.max(dim=-1).values
        served = ref.gather(1, prog.argmax(dim=-1, keepdim=True))[:, 0]
        assert torch.all(best - served <= 2 * BF16_ROUNDING
                         * best.abs().clamp_min(1.0))
    assert apart <= len(r["program"]) // 10
