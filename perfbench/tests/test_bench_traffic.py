"""The traffic mixes: what the generator serves from each file, and the
derivation of a mix from its public trace."""
import json
import math
import pathlib

import pytest

from perfbench.traffic import RequestSource

ROOT = pathlib.Path(__file__).resolve().parents[2]
MIXES = sorted(p.stem for p in (ROOT / "perfbench/traffic").glob("*.json"))


def _mix(name: str) -> dict:
    return json.loads((ROOT / f"perfbench/traffic/{name}.json").read_text())


def _draw(mix: dict, seed: int, n: int = 300) -> list:
    src = RequestSource(mix, 50304, seed)
    return [src.next(first=i < mix["clients"]) for i in range(n)]


@pytest.mark.parametrize("name", MIXES)
def test_requests_fit_the_cache(name):
    mix = _mix(name)
    assert mix["prompt_tokens"]["max"] + mix["output_tokens"]["max"] \
        <= mix["max_seq"]
    for prompt, max_new in _draw(mix, 2**31 + 5):
        assert mix["prompt_tokens"]["min"] <= len(prompt) \
            <= mix["prompt_tokens"]["max"]
        assert 1 <= max_new <= mix["output_tokens"]["max"]


@pytest.mark.parametrize("name", MIXES)
def test_seed_draws_ids_and_order_as_the_mix_says(name):
    mix = _mix(name)
    a, b = _draw(mix, 2**31 + 11), _draw(mix, 2**31 + 12)
    sizes = [[(len(p), o) for p, o in r] for r in (a, b)]
    assert [p for p, _ in a] != [p for p, _ in b]
    if mix.get("order_seed") is not None:
        assert sizes[0] == sizes[1]
    else:
        assert sizes[0] != sizes[1]
    assert _draw(mix, 2**31 + 11) == a


@pytest.mark.parametrize("name", [m for m in MIXES if "trace" in _mix(m)])
def test_lengths_follow_the_trace(name):
    mix = _mix(name)
    trace = mix["trace"]
    for side in ("prompt_tokens", "output_tokens"):
        got, src = mix[side], trace[side]
        assert got["median"] == round(src["median"] * trace["scale"])
        sigma = math.sqrt(2 * math.log(src["mean"] / src["median"]))
        assert got["sigma"] == pytest.approx(sigma, abs=0.005)
    # prompts longer than answers, as in the trace
    assert mix["prompt_tokens"]["median"] > mix["output_tokens"]["median"]
