"""Where the benchmark's data lives, and how a name finds its file.

``BENCHMARK.json`` at the checkout's root names the cells; a cell names
a configuration (its ``file`` in the ``configs`` entry), a traffic mix
(``perfbench/traffic/<traffic>.json``) and, through the metric entries,
one reader per metric (``perfbench/metrics/<metric>.py``).  Nothing here
knows a particular cell: a later cell is new files and new entries.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import pathlib

#: the checkout's root (this file is ``<root>/perfbench/spec.py``)
ROOT = pathlib.Path(__file__).resolve().parent.parent


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in bench['workloads']]}")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def load_config(root: pathlib.Path, bench: dict, name: str) -> dict:
    return json.loads((root / config_entry(bench, name)["file"]).read_text())


def load_traffic(root: pathlib.Path, name: str) -> dict:
    return json.loads((root / "perfbench" / "traffic" / f"{name}.json")
                      .read_text())


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``kind`` ("end_to_end" or "per_layer") metrics a cell reports:
    those that list it under ``workloads``, and those without the key
    (a per-layer metric without it goes wherever its ``moves`` does)."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]}
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def reader(root: pathlib.Path, metric: str):
    """The module that reads ``metric``: ``perfbench/metrics/<metric>.py``,
    loaded from its file (a metric's name may hold ``.`` and ``-``)."""
    path = root / "perfbench" / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {metric!r} at {path}")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric:{metric}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(f"no reader for metric {metric!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass(frozen=True)
class ModelShape:
    """The sizes and equations of one configuration file, in the
    benchmark's own terms (the reference, the weights and the work counts
    read these; the program gets its own config built from them)."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    norm: str
    norm_eps: float
    act: str
    rope_theta: float
    rotary_dim: int
    mrope_section: tuple[int, ...] | None
    tie_word_embeddings: bool
    linear_bias: bool
    embedding_multiplier: float
    dtype: str

    @classmethod
    def from_config(cls, conf: dict) -> "ModelShape":
        d, h = conf["hidden_size"], conf["num_attention_heads"]
        hd = conf.get("head_dim") or d // h
        eps = conf.get("layer_norm_eps", conf.get("rms_norm_eps"))
        rope = conf.get("rope_scaling") or {}
        mrope = rope.get("mrope_section")
        return cls(
            name=conf["name"], n_layers=conf["num_hidden_layers"],
            d_model=d, n_heads=h, n_kv_heads=conf["num_key_value_heads"],
            head_dim=hd, d_ff=conf["intermediate_size"],
            vocab_size=conf["vocab_size"], norm=conf["norm"],
            norm_eps=float(eps), act=conf["hidden_act"],
            rope_theta=float(conf["rope_theta"]),
            rotary_dim=int(round(hd * conf.get("partial_rotary_factor", 1.0))),
            mrope_section=tuple(mrope) if mrope else None,
            tie_word_embeddings=bool(conf["tie_word_embeddings"]),
            linear_bias=bool(conf["linear_bias"]),
            embedding_multiplier=float(conf["embedding_multiplier"]),
            dtype=conf["torch_dtype"])

    def linears(self) -> list[tuple[str, int, int]]:
        """The seven projections of a layer: ``(name, K, N)``."""
        d, f = self.d_model, self.d_ff
        q, kv = self.n_heads * self.head_dim, self.n_kv_heads * self.head_dim
        return [("wq", d, q), ("wk", d, kv), ("wv", d, kv), ("wo", q, d),
                ("w_gate", d, f), ("w_up", d, f), ("w_down", f, d)]

    def embedding_is_sqrt_d(self) -> bool:
        """Whether the multiplier is ``sqrt(hidden_size)`` rounded to the
        model's type, as the program multiplies."""
        import torch

        kept = torch.tensor(math.sqrt(self.d_model),
                            dtype=getattr(torch, self.dtype)).item()
        return self.embedding_multiplier == kept
