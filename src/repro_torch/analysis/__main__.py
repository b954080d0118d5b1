"""``python -m repro_torch.analysis`` — the layout verifier CLI.

Own copy of ``src/repro/analysis/__main__.py`` for the port.  Three
subcommands:

* ``gate`` — every registered strategy x the shared problem suite
  (:mod:`repro_torch.analysis.suite`), with a JSON report as the
  artifact.  Exit 1 on any error finding.
* ``config ARCH`` — verify the per-layer stream layout a model config
  plans (e.g. ``python -m repro_torch.analysis config smollm-135m
  --bits 4``).
* ``ckpt ROOT`` — verify a packed checkpoint on disk (manifest vs
  intervals vs stream bytes vs content digest, and its KV pages when it
  holds them) **without** restoring it.  No subcommand needs a card.

All subcommands print a findings report (``--min-severity`` filters)
and support ``--json PATH`` for the machine-readable artifact.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from . import Report, Severity, verify_layout
from .suite import GATE_PROBLEMS


def _severity(name: str) -> Severity:
    try:
        return Severity[name.upper()]
    except KeyError:
        raise argparse.ArgumentTypeError(
            f"unknown severity {name!r}; use info|warning|error"
        ) from None


def _emit(reports: list[Report], json_path: str | None,
          min_severity: Severity) -> int:
    ok = all(r.ok for r in reports)
    for r in reports:
        print(r.render(min_severity))
    n_err = sum(len(r.errors) for r in reports)
    n_warn = sum(len(r.warnings) for r in reports)
    print(f"== {len(reports)} report(s): "
          f"{'OK' if ok else 'FAIL'} ({n_err} error(s), "
          f"{n_warn} warning(s))")
    if json_path:
        payload = {
            "ok": ok,
            "n_reports": len(reports),
            "n_errors": n_err,
            "n_warnings": n_warn,
            "reports": [r.to_json_dict() for r in reports],
        }
        pathlib.Path(json_path).write_text(json.dumps(payload, indent=2))
        print(f"wrote {json_path}")
    return 0 if ok else 1


def _cmd_gate(args: argparse.Namespace) -> int:
    from ..api import STRATEGIES, plan

    names = args.strategies or STRATEGIES.names()
    reports = []
    for prob in GATE_PROBLEMS:
        tag = "/".join(a.name for a in prob.arrays) + f"@m={prob.m}"
        for strategy in names:
            lay = plan(prob, strategy, cache=None).layout
            reports.append(verify_layout(
                lay, subject=f"{strategy}:{tag}"))
    return _emit(reports, args.json, args.min_severity)


def _cmd_config(args: argparse.Namespace) -> int:
    from ..api import plan
    from ..configs import get_config
    from ..core.exec_plan import lower_exec
    from ..plan import plan_layer_stack
    from ..quant import QuantSpec

    cfg = get_config(args.arch)
    spec = QuantSpec(bits=args.bits, group_size=args.group_size)
    stack = plan_layer_stack(cfg, spec, m=args.m, n_layers=args.layers,
                             cache=None)
    layout = stack.layout if args.strategy == "iris" else \
        plan(stack.problem, args.strategy, cache=None).layout
    ew = tuple(b.width_bits for b in stack.bundle)
    report = verify_layout(
        layout, program=lower_exec(layout, elem_widths=ew),
        subject=f"{args.arch}:int{args.bits}/g{args.group_size}"
                f":{args.strategy}")
    return _emit([report], args.json, args.min_severity)


def _cmd_ckpt(args: argparse.Namespace) -> int:
    from ..checkpoint import CheckpointManager

    mgr = CheckpointManager(args.root)
    report = mgr.verify_packed(args.step)
    return _emit([report], args.json, args.min_severity)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static layout verifier and bandwidth lint")
    ap.add_argument("--json", help="write the JSON report artifact here")
    ap.add_argument("--min-severity", type=_severity,
                    default=Severity.WARNING,
                    help="lowest severity to print (info|warning|error)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gate", help="every strategy x the problem suite")
    g.add_argument("--strategies", nargs="*", default=None,
                   help="strategy names (default: whole registry)")
    g.set_defaults(fn=_cmd_gate)

    c = sub.add_parser("config", help="verify a model config's layout")
    c.add_argument("arch", help="config name, e.g. smollm-135m")
    c.add_argument("--bits", type=int, default=4)
    c.add_argument("--group-size", type=int, default=64)
    c.add_argument("--m", type=int, default=4096)
    c.add_argument("--layers", type=int, default=None)
    c.add_argument("--strategy", default="iris")
    c.set_defaults(fn=_cmd_config)

    k = sub.add_parser("ckpt", help="verify a packed checkpoint on disk")
    k.add_argument("root", help="checkpoint root directory")
    k.add_argument("--step", type=int, default=None)
    k.set_defaults(fn=_cmd_ckpt)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
