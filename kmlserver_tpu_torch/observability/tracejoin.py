"""Merge client replay records with server trace spans — counterpart of
``scripts/kmls_tracejoin.py``, run as
``python -m kmlserver_tpu_torch.observability.tracejoin``.

The serving front ends echo ``X-KMLS-Trace`` on every response while the
recorder is armed, and ``GET /debug/traces`` serves the retained spans
(tail-based: shed/degraded/error + slowest-N + a sampled slice). The
replay harness's :class:`~kmlserver_tpu_torch.serving.replay.ClientTraceLog`
is the client half: one JSONL record per echoed id with send/recv wall
clocks. This tool joins the two halves on the trace id into ONE
per-request timeline:

    client_send ──▶ [server: queue span, device span, ...] ──▶ client_recv

and derives the number neither side can compute alone:
``client_overhead_ms = client RTT − server-observed duration`` — the
wire + loadgen + front-end-parse slice of every request, which is what
separates "the server got slow" from "the path to the server got slow".

Inputs:
  --client PATH        ClientTraceLog JSONL (bench replay / --trace-log)
  --traces PATH|URL    /debug/traces JSON: a saved file, or a live
                       http(s) URL to fetch (loopback-only endpoint —
                       run this next to the pod, e.g. kubectl exec)

Output: one JSON object per joined request on stdout (a JSONL timeline,
newest last), and a summary line on stderr. Retention is tail-based by
design, so most client records have no server half — the summary names
both counts; ``--all`` also emits client-only records (server: null).

Exit codes: 0 = joined at least one request, 1 = nothing joined,
2 = bad input.
"""

from __future__ import annotations

import argparse
import json
import sys


def load_client_records(path: str) -> list[dict]:
    records = []
    with open(path, "r", encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError as exc:
                raise SystemExit(
                    f"{path}:{lineno}: not JSON ({exc})"
                ) from exc
            if "trace_id" in rec:
                records.append(rec)
    return records


def load_server_traces(source: str) -> list[dict]:
    """``/debug/traces`` payload from a file or a live URL → trace list."""
    if source.startswith(("http://", "https://")):
        import urllib.request

        with urllib.request.urlopen(source, timeout=10) as resp:
            payload = json.load(resp)
    else:
        with open(source, "r", encoding="utf-8") as fh:
            payload = json.load(fh)
    if isinstance(payload, dict):
        traces = payload.get("traces", [])
    elif isinstance(payload, list):  # already a bare trace list
        traces = payload
    else:
        raise SystemExit(f"{source}: not a /debug/traces payload")
    return [t for t in traces if isinstance(t, dict) and t.get("trace_id")]


def join_timeline(client: dict, server: dict | None) -> dict:
    """One per-request timeline record. All times are wall-clock unix
    seconds except spans, which stay relative to the server's request
    start (the recorder's own convention)."""
    out = {
        "trace_id": client["trace_id"],
        "client": {
            "send_unix": client.get("client_send_unix"),
            "recv_unix": client.get("client_recv_unix"),
            "rtt_ms": client.get("client_rtt_ms"),
            "status": client.get("status"),
        },
        "server": None,
    }
    if server is not None:
        attrs = server.get("attrs", {})
        out["server"] = {
            "status": server.get("status"),
            "start_unix": server.get("start_unix"),
            "duration_ms": server.get("duration_ms"),
            "attrs": attrs,
            "spans": server.get("spans", []),
        }
        # the hedge outcome (won/lost/cancelled) and the forwarded
        # deadline budget ride span attrs: lift them to first-class
        # fields so a jq over the timeline can split hedged tails from
        # plain ones without knowing the attr names
        if isinstance(attrs, dict):
            if "hedged" in attrs:
                out["hedged"] = attrs["hedged"]
            if "deadline_budget_ms" in attrs:
                out["deadline_budget_ms"] = attrs["deadline_budget_ms"]
        rtt = client.get("client_rtt_ms")
        dur = server.get("duration_ms")
        if rtt is not None and dur is not None:
            # wire + loadgen queue + front-end parse: the slice between
            # what the client saw and what the server's recorder saw
            out["client_overhead_ms"] = round(rtt - dur, 4)
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--client", required=True, help="ClientTraceLog JSONL")
    parser.add_argument(
        "--traces", required=True,
        help="/debug/traces JSON file, or a live URL to fetch it from",
    )
    parser.add_argument(
        "--all", action="store_true",
        help="also emit client records with no retained server trace",
    )
    args = parser.parse_args(argv)

    try:
        client_records = load_client_records(args.client)
        server_traces = load_server_traces(args.traces)
    except OSError as exc:
        print(f"kmls-tracejoin: {exc}", file=sys.stderr)
        return 2

    # newest retained trace wins a duplicated id (a client re-sending an
    # id is driving the propagation path on purpose)
    by_id = {t["trace_id"]: t for t in server_traces}
    joined = 0
    hedged = 0
    for rec in client_records:
        server = by_id.get(rec["trace_id"])
        if server is None and not args.all:
            continue
        timeline = join_timeline(rec, server)
        print(json.dumps(timeline))
        if server is not None:
            joined += 1
            if timeline.get("hedged") is not None:
                hedged += 1
    print(
        f"kmls-tracejoin: {joined}/{len(client_records)} client records "
        f"joined against {len(server_traces)} retained server traces"
        + (f", {hedged} hedged" if hedged else "")
        + ("" if joined or not client_records else
           " (tail-based retention keeps only shed/degraded/error/"
           "slowest-N + a sampled slice — raise KMLS_TRACE_SAMPLE or "
           "drive a tail to retain more)"),
        file=sys.stderr,
    )
    return 0 if joined else 1


if __name__ == "__main__":
    sys.exit(main())
