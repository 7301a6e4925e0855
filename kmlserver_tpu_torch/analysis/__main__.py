"""kmls-verify CLI for the port — run the project-invariant static
analyzer over ``kmlserver_tpu_torch/``.

Usage (from the repo root)::

    python -m kmlserver_tpu_torch.analysis                 # all eleven checkers
    python -m kmlserver_tpu_torch.analysis --checker knobs --checker loopblock
    python -m kmlserver_tpu_torch.analysis --json          # machine-readable
    python -m kmlserver_tpu_torch.analysis --write-baseline  # accept current findings

Exit codes: 0 = clean (no non-baselined findings), 1 = findings, 2 =
usage/internal error — the counterpart of the reference's
``scripts/kmls_verify.py``, with the same flags. See the README's "Static
invariants (port)" for what each checker enforces and how suppressions
work (inline ``# kmls-verify: allow[<checker>]`` pragma, or a pinned entry
in kmlserver_tpu_torch/analysis/baseline.json — prefer fixing the
finding).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import AnalysisConfig, load_baseline, run_analysis, write_baseline
from .core import all_checkers, load_baseline_entries

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_BASELINE = os.path.join("kmlserver_tpu_torch", "analysis", "baseline.json")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m kmlserver_tpu_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "--root", default=_REPO_ROOT, help="repo root (default: auto)"
    )
    parser.add_argument(
        "--baseline",
        default=None,
        help=f"suppression file (default: <root>/{DEFAULT_BASELINE})",
    )
    parser.add_argument(
        "--checker",
        action="append",
        choices=sorted(all_checkers()),
        help="run only these checkers (repeatable; default: all)",
    )
    parser.add_argument(
        "--write-baseline",
        action="store_true",
        help="accept every current finding into the baseline file",
    )
    parser.add_argument(
        "--json", action="store_true", help="JSON output instead of text"
    )
    args = parser.parse_args(argv)

    root = os.path.abspath(args.root)
    baseline_path = args.baseline or os.path.join(root, DEFAULT_BASELINE)
    baseline = load_baseline(baseline_path)
    try:
        result = run_analysis(
            root,
            AnalysisConfig(),
            checkers=args.checker,
            baseline=baseline,
        )
    except ValueError as exc:
        print(f"kmls-verify: {exc}", file=sys.stderr)
        return 2

    new = result["findings"]
    if args.write_baseline:
        # with a --checker subset, carry the UNSELECTED checkers' pins
        # over verbatim — a partial run must not un-pin what it didn't
        # even look at
        keep = []
        if args.checker:
            selected = set(args.checker)
            keep = [
                e
                for e in load_baseline_entries(baseline_path)
                if e["fingerprint"].split("::", 1)[0] not in selected
            ]
        write_baseline(
            baseline_path, new + result["baselined"], keep_entries=keep
        )
        print(
            f"kmls-verify: baseline written to {baseline_path} "
            f"({len(new) + len(result['baselined']) + len(keep)} pinned "
            "finding(s))"
        )
        return 0

    if args.json:
        print(
            json.dumps(
                {
                    key: [f.__dict__ for f in result[key]]
                    for key in ("findings", "baselined", "suppressed")
                },
                indent=1,
            )
        )
    else:
        for finding in new:
            print(finding.render())
        print(
            f"kmls-verify: {len(new)} new finding(s), "
            f"{len(result['baselined'])} baselined, "
            f"{len(result['suppressed'])} pragma-suppressed"
        )
        if new:
            print(
                "Fix the findings, or (rarely) suppress: inline "
                "`# kmls-verify: allow[<checker>]` on the flagged line, "
                "or pin in kmlserver_tpu_torch/analysis/baseline.json "
                "(see README 'Static invariants (port)').",
                file=sys.stderr,
            )
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
