"""The controls: the reference put in the program's place, one step below
the precision the configuration states, read by the same check. A control
has to come out as not correct; its readings set the upper end of each
limit (``PERF.md`` has them).

- mine cells: the bitset drawn with its compare ``u < q`` in bfloat16
  instead of float32 (the draw is float32), on the rows the check
  compares, against the reference's float32 rows → ``bitset_words_differ``;
- serving cells: every embedding similarity computed as TF32 does (the
  factors rounded to TF32, summed in float32) instead of float32 with TF32
  off, for the requests of the window's own draw, judged by the check →
  ``score_gap`` and ``exact_mismatches``.

``python3 -m kmls_bench.control --workload <cell> --seeds s1,s2,s3``
prints one JSON line per seed. It runs on the card where
there is one; it needs no server and no window.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from . import publication, traffic as traffic_gen
from .cells import subseed
from .cells.mine import check_rows
from .reference import mine as ref_mine
from .reference import serve as ref_serve


def mine_control(config: dict, traffic: dict, seed: int, device) -> dict:
    shape = ref_mine.workload(config["deployment"])
    rows = check_rows(shape["candidates"], int(traffic["check_rows"]), seed)
    gen_seed = subseed(seed, "mine", 0) % (1 << 31)
    want = ref_mine.bitset_rows(gen_seed, rows, shape, device=device)
    got = ref_mine.bitset_rows(gen_seed, rows, shape, device=device, compare_dtype=torch.bfloat16)
    return {"bitset_words_differ": int((want != got).sum())}


def serve_control(config: dict, traffic: dict, seed: int, device, *, requests: int,
                  seconds: float = 30.0) -> dict:
    pub = publication.draw(config, subseed(seed, "publication"))
    _, _, load = traffic_gen.window_requests(traffic, pub["names"], seed, seconds)
    pick = np.random.default_rng(subseed(seed, "check")).choice(
        len(load), size=min(requests, len(load)), replace=False)
    serving = config["serving"]
    kw = dict(k_best=int(serving["k_best"]), weight=float(serving["blend_weight"]),
              max_seeds=int(serving["max_seed_tracks"]),
              tol=float(config["check"]["tie_tolerance"]), device=device)
    reference = ref_serve.Reference(pub, precision="float64", **kw)
    control = ref_serve.Reference(pub, precision="tf32", **kw)
    gap, exact = 0.0, 0
    for i in pick.tolist():
        served = control.answer(load[i])["names"]
        g, mismatch = ref_serve.judge(reference.answer(load[i]), served)
        gap, exact = max(gap, g), exact + int(mismatch)
    return {"score_gap": gap, "exact_mismatches": exact, "requests": len(pick)}


def main(argv=None) -> int:
    from .run import load_cell

    parser = argparse.ArgumentParser(prog="python3 -m kmls_bench.control")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    args = parser.parse_args(argv)
    spec = load_cell(args.workload)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in (int(s) for s in args.seeds.split(",")):
        if spec["config"]["driver"] == "mine":
            out = mine_control(spec["config"], spec["traffic"], seed, device)
        else:
            out = serve_control(spec["config"], spec["traffic"], seed, device,
                                requests=int(spec["traffic"]["check_sample"]))
        print(json.dumps({"workload": args.workload, "seed": seed, "device": str(device), **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
