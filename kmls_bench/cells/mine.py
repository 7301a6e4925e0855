"""The mining cells: whole config-4 mines back to back on the card.

A mine is the three calls of ``mining/config4.py --device-gen``: the
device-born bitset (``data/device_synthetic.device_synthetic_bitset`` →
the ``bernoulli_bits`` kernel), the pair count
(``ops/popcount.popcount_pair_counts_padded``, the popcount kernel) and
the emission (``ops/rules.mine_rules_from_counts``). Mine ``i`` of a run
draws its bitset under its own seed from ``(seed, i)``, so nothing
carries over from one mine to the next. Set-up builds the kernels and
runs one mine under a seed of its own; the window then runs mines until
``seconds`` have passed, the last one to its end.

The check: one mine of the window, picked from the seed among the first
``keep_choices``, is kept whole. On ``check_rows`` rows drawn from the
seed (and always the most popular track and the last candidate), the
reference redraws the bitset from the seed alone, counts the pairs among
those rows from its own redraw alone (the ``rows × rows`` block), counts
each row against every column from the program's bitset, and emits the
rules from those counts; each stage is compared exactly.
"""

from __future__ import annotations

import time

import numpy as np

from ..reference import mine as ref
from . import subseed


def _mine(dev, cfg: dict, gen_seed: int, spans: dict):
    import torch

    from kmlserver_tpu_torch.data.device_synthetic import device_synthetic_bitset
    from kmlserver_tpu_torch.ops import popcount as pc
    from kmlserver_tpu_torch.ops import rules
    from kmlserver_tpu_torch.ops.support import min_count_for

    rf = torch.profiler.record_function
    p, k_max = int(cfg["playlists"]), int(cfg["k_max"])
    with rf("kmls_bench:gen"):
        bitset, f, _ = device_synthetic_bitset(
            p, int(cfg["tracks"]), int(cfg["rows"]), min_count_for(float(cfg["min_support"]), p),
            zipf_exponent=float(cfg["zipf_s"]), seed=gen_seed, device=dev)
    with rf("kmls_bench:count"):
        counts = pc.popcount_pair_counts_padded(bitset)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t = time.perf_counter()
    with rf("kmls_bench:emit"):
        mined = rules.mine_rules_from_counts(
            counts, n_playlists=p, min_support=float(cfg["min_support"]), k_max=k_max,
            n_total_songs=int(cfg["tracks"]))
    spans.setdefault("emit_s", []).append(time.perf_counter() - t)
    spans.setdefault("mine_dims", []).append({"f": f, "p": p})
    return bitset, counts, mined, f


def run(*, config: dict, traffic: dict, seed: int, seconds: float, trace: bool, device: str,
        t_start: float) -> dict:
    import torch

    from . import device_info, prime_profiler, profile_window

    cfg = config["deployment"]
    dev = torch.device(device)
    if dev.type == "cuda":
        from kmlserver_tpu_torch.ops import bernoulli
        from kmlserver_tpu_torch.ops import popcount as pc

        torch.cuda.init()
        bernoulli.kernel_lib()
        pc.kernel_lib()
    if trace:
        prime_profiler(dev)
    warm: dict = {}
    for w in range(int(traffic["warm_mines"])):
        _mine(dev, cfg, subseed(seed, "warm", w) % (1 << 31), warm)
    setup_s = time.perf_counter() - t_start

    keep_at = subseed(seed, "keep") % int(traffic["keep_choices"])
    spans: dict = {}
    kept = None
    with profile_window(trace, dev) as prof:
        t0 = time.perf_counter()
        i = 0
        while True:
            gen_seed = subseed(seed, "mine", i) % (1 << 31)
            out = _mine(dev, cfg, gen_seed, spans)
            if i == keep_at or kept is None:
                kept = (gen_seed, *out)
            del out
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
    info = device_info(dev)
    checks = check(config, traffic, seed, kept)
    return {
        "attempted": i, "failed": 0,
        "e2e": {"mine_s": window_s / i, "setup_s": setup_s},
        "layer": {"trace": prof.trace, "spans": spans, "device_kind": info["kind"]},
        "device": info, "checks": checks,
    }


def check_rows(f: int, n: int, seed: int) -> np.ndarray:
    """The rows the check compares: the most popular track, the last
    candidate and ``n - 2`` others drawn from the seed."""
    rng = np.random.default_rng(subseed(seed, "rows"))
    picks = rng.choice(max(f, 1), size=min(max(n - 2, 0), f), replace=False)
    return np.unique(np.concatenate([[0, f - 1], picks]).astype(np.int64))


def check(config: dict, traffic: dict, seed: int, kept) -> dict:
    """Compare the kept mine with the reference → ``{name: (value, limit)}``
    (limits from the configuration)."""
    import torch

    cfg = config["deployment"]
    gen_seed, bitset, counts, mined, f = kept
    shape = ref.workload(cfg)
    rows = check_rows(shape["candidates"], int(traffic["check_rows"]), seed)
    if f != shape["candidates"] or tuple(bitset.shape) != (shape["v_pad"], shape["w_pad"]):
        words = block = bits = entries = float(len(rows) * shape["w_pad"])
    else:
        idx = torch.as_tensor(rows, device=bitset.device)
        want = ref.bitset_rows(gen_seed, rows, shape, device=bitset.device)
        words = int((bitset[idx] != want).sum())
        c_block = ref.count_rows(want, list(range(len(rows))))
        block = int((counts[idx][:, idx].to(torch.int64) != c_block).sum())
        del want, c_block
        c_ref = ref.count_rows(bitset, rows)
        bits = int((counts[idx].to(torch.int64) != c_ref).sum())
        emitted = ref.emit_rows(c_ref.cpu().numpy(), rows, min_count=shape["min_count"],
                                k_max=shape["k_max"], n_playlists=shape["playlists"])
        entries = int(
            (mined.rule_ids[rows] != emitted["rule_ids"]).sum()
            + (mined.rule_counts[rows] != emitted["rule_counts"]).sum()
            + (mined.rule_confs[rows] != emitted["rule_confs"]).sum()
            + (mined.item_counts[rows] != emitted["item_counts"]).sum()
            + (mined.row_valid_counts[rows] != emitted["row_valid"]).sum())
    limits = config["limits"]
    return {"bitset_words_differ": (words, limits["bitset_words_differ"]),
            "block_entries_differ": (block, limits["block_entries_differ"]),
            "count_entries_differ": (bits, limits["count_entries_differ"]),
            "rule_entries_differ": (entries, limits["rule_entries_differ"])}
