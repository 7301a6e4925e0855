"""The embed cells: config 4's embed phase retrained back to back on the card.

A rotation is what the job's ``embed`` phase does at config 4, fed by the
device-born catalog: the whole catalog's event list
(``data/device_synthetic.device_synthetic_events``: the candidate head's
bitset, its set bits, the tail's geometric gaps) and the pipeline's call
``mining/als.train_embeddings`` with the configuration's ALS knobs, whose
``auto`` storage picks the compressed form at this size: the host init, two
CSR orderings, the sweeps' segment sums (``ops/csrc/segsum.cu``), the
loss, the copy back. Rotation ``i`` draws its events and its init under
seeds of its own from ``(seed, i)``. Set-up builds the kernels, makes the
catalog's vocabulary once and runs one rotation under a seed of its own;
the window then runs rotations until ``seconds`` have passed, the last one
to its end.

The checks: one rotation of the window, picked from the seed among the
first ``keep_choices``, is kept whole (its events, its payload and what
``train_embeddings(keep=)`` holds). Against the reference
(``reference/embed.py``):

- ``event_entries_differ``: the playlists of ``check_tracks`` tracks
  (always 0, 1, 2, the last candidate, the first track past it and the
  last track; the rest drawn from the seed, half from the head and half
  from the tail) redrawn from the seed alone, against the kept list's;
  plus every pair of neighbours out of (track, playlist) order;
- ``segsum_bits_differ``: the last sweep's ``X F`` on ``check_users``
  playlists (always the first and the last) and ``Xᵀ U`` on the check
  tracks, against the in-order float32 sums of the kept factors;
- ``gram_rel_gap``: the last sweep's two Gramians against float64 ones
  from the same factors, the largest entry gap over its Cauchy-Schwarz
  scale ``sqrt(G_ii G_jj)``;
- ``solve_residual``: the last sweep's solved rows of those playlists and
  tracks against float64 Gramians and right-hand sides,
  ``‖x G − r‖ / ‖r‖``, the larger half;
- ``loss_rel_gap``: the payload's loss against the float64 loss of the
  kept final factors;
- ``init_bits_differ``: the kept init (drawn on the card) against numpy's
  draw from the rotation's seed (:func:`reference.embed.init32`), bit for
  bit;
- ``train_rel_gap``: the kept final factors against the whole training
  redone in float64 over the kept events, from the init redrawn from the
  rotation's seed (:func:`reference.embed.train64`), ``‖got − want‖ /
  ‖want‖``, the larger of users and items: the state each sweep hands the
  next, the sweep count and the init;
- ``payload_bits_differ``: the payload's item factors against the kept
  final item factors normalized (:func:`reference.embed.normalize32`),
  bit for bit;
- ``repeat_bits_differ``: the kept events trained again under the same
  seed, the item factors compared bit for bit (and the loss).
"""

from __future__ import annotations

import time

import numpy as np

from ..reference import embed as ref
from . import subseed


def _als_config(cfg: dict):
    from kmlserver_tpu_torch.config import MiningConfig

    return MiningConfig(als_rank=int(cfg["rank"]), als_iters=int(cfg["iters"]),
                        als_reg=float(cfg["reg"]), als_sparse=str(cfg["sparse"]),
                        hbm_budget_bytes=int(cfg["hbm_budget_bytes"]))


def rotation(dev, config: dict, vocab, gen_seed: int, als_seed: int, keep: dict | None = None):
    """One rotation → ``(baskets, payload)``: the device-born events, then
    the embed phase's training over them."""
    from kmlserver_tpu_torch.data.device_synthetic import device_synthetic_events
    from kmlserver_tpu_torch.mining import als
    from kmlserver_tpu_torch.mining.vocab import Baskets
    from kmlserver_tpu_torch.ops.support import min_count_for

    cfg = config["deployment"]
    p = int(cfg["playlists"])
    rows, tracks = device_synthetic_events(
        p, int(cfg["tracks"]), int(cfg["rows"]), min_count_for(float(cfg["min_support"]), p),
        zipf_exponent=float(cfg["zipf_s"]), seed=gen_seed, device=dev)
    baskets = Baskets(playlist_rows=rows, track_ids=tracks, n_playlists=p, vocab=vocab)
    payload = als.train_embeddings(baskets, _als_config(config["als"]), seed=als_seed, device=dev,
                                   keep=keep)
    return baskets, payload


def seeds(seed: int, i) -> tuple[int, int]:
    """Rotation ``i``'s generator seed (the bitset's 31 bits) and init seed."""
    return subseed(seed, "events", i) % (1 << 31), subseed(seed, "init", i)


def run(*, config: dict, traffic: dict, seed: int, seconds: float, trace: bool, device: str,
        t_start: float) -> dict:
    import torch

    # a program without the device-born event list stops here, before any work
    from kmlserver_tpu_torch.data.device_synthetic import device_synthetic_events  # noqa: F401
    from kmlserver_tpu_torch.mining.vocab import Vocab
    from kmlserver_tpu_torch.ops import events, normals, segsum

    from . import device_info, prime_profiler, profile_window

    dev = torch.device(device)
    if dev.type == "cuda":
        from kmlserver_tpu_torch.ops import bernoulli

        torch.cuda.init()
        bernoulli.kernel_lib()
        events.kernel_lib()
        normals.kernel_lib()
        segsum.kernel_lib()
    if trace:
        prime_profiler(dev)
    v = int(config["deployment"]["tracks"])
    names = [f"track_{t:07d}" for t in range(v)]
    vocab = Vocab(names=names, index={n: t for t, n in enumerate(names)})
    for w in range(int(traffic["warm_trainings"])):
        rotation(dev, config, vocab, *seeds(seed, ("warm", w)))
    setup_s = time.perf_counter() - t_start

    keep_at = subseed(seed, "keep") % int(traffic["keep_choices"])
    kept = None
    launches0 = dict(segsum.LAUNCHES, **events.LAUNCHES, **normals.LAUNCHES)
    storages, nnzs = set(), []
    with profile_window(trace, dev) as prof:
        t0 = time.perf_counter()
        i = 0
        while True:
            if i == keep_at:
                kept = None  # the first rotation's, kept in case the window ends first
            gen_seed, als_seed = seeds(seed, i)
            keep = {} if kept is None else None
            baskets, payload = rotation(dev, config, vocab, gen_seed, als_seed, keep)
            storages.add(payload["storage"])
            nnzs.append(payload["nnz"])
            if keep is not None:
                kept = {"gen_seed": gen_seed, "als_seed": als_seed, "baskets": baskets,
                        "payload": payload, "keep": keep}
            del baskets, payload
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
    info = device_info(dev)
    launches = {k: (dict(segsum.LAUNCHES, **events.LAUNCHES, **normals.LAUNCHES)[k] - n) / i
                for k, n in launches0.items()}
    check_s: dict = {}
    checks = check(config, traffic, seed, kept, dev, check_s)
    return {
        "attempted": i, "failed": 0,
        "e2e": {"mine_s": window_s / i, "setup_s": setup_s},
        "layer": {"trace": prof.trace, "device_kind": info["kind"]},
        "device": info, "checks": checks,
        "notes": {"rotations": i, "storage": sorted(storages), "nnz": nnzs,
                  "launches_per_rotation": launches, "kept_rotation": keep_at,
                  "check_s": check_s},
    }


def check_tracks(f: int, v: int, n: int, seed: int) -> list[int]:
    """The tracks the event and item checks compare: 0, 1, 2, the last
    candidate, the first track past it and the last track, then others
    drawn from the seed, half between 2 and the last candidate and half
    between the first tail track and the last."""
    rng = np.random.default_rng(subseed(seed, "tracks"))
    fixed = sorted({0, 1, 2, f - 1, f, v - 1} & set(range(v)))
    rest = max(n - len(fixed), 0)
    head = 3 + rng.choice(max(f - 4, 1), size=min(rest // 2, max(f - 4, 0)), replace=False)
    tail = f + 1 + rng.choice(max(v - f - 2, 1), size=min(rest - len(head), max(v - f - 2, 0)),
                              replace=False)
    return sorted(set(fixed) | set(head.tolist()) | set(tail.tolist()))


def check_users(p: int, n: int, seed: int) -> list[int]:
    """The playlists the user-side check compares: the first, the last and
    others drawn from the seed."""
    rng = np.random.default_rng(subseed(seed, "users"))
    picks = 1 + rng.choice(max(p - 2, 1), size=min(max(n - 2, 0), max(p - 2, 0)), replace=False)
    return sorted({0, p - 1} | set(picks.tolist()))


def _bits_differ(a, b) -> int:
    import torch

    a = torch.as_tensor(a).contiguous()
    b = torch.as_tensor(b).to(a.device).contiguous()
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    return int((a.view(torch.int32) != b.view(torch.int32)).sum())


def _out_of_order(rows, tracks, p: int, chunk: int = 1 << 26) -> int:
    """Neighbours not strictly increasing by (track, playlist)."""
    bad = 0
    for lo in range(0, max(rows.shape[0] - 1, 0), chunk):
        hi = min(lo + chunk + 1, rows.shape[0])
        key = tracks[lo:hi].long() * p + rows[lo:hi].long()
        bad += int((key[1:] <= key[:-1]).sum())
    return bad


def _gram_gap(got, want) -> float:
    """The largest gap of a Gramian's entry from the float64 one, over the
    entry's Cauchy-Schwarz scale ``sqrt(want_ii · want_jj)``."""
    import torch

    scale = torch.sqrt(torch.outer(torch.diagonal(want), torch.diagonal(want)))
    return float(((got.to(torch.float64) - want).abs() / scale).max())


def observe(config: dict, traffic: dict, seed: int, kept: dict, dev,
            times: dict | None = None) -> dict:
    """Every check's reading of the kept rotation but the repeat (``times``
    gets each stage's host seconds)."""
    import torch

    times = {} if times is None else times
    t = time.perf_counter()

    def lap(name):
        nonlocal t
        now = time.perf_counter()
        times[name] = now - t
        t = now

    cfg = config["deployment"]
    reg = float(config["als"]["reg"])
    shape = ref.workload(cfg)
    p, v, f = shape["playlists"], shape["tracks"], shape["candidates"]
    rows, tracks = kept["baskets"].playlist_rows, kept["baskets"].track_ids
    k = kept["keep"]
    t_check = check_tracks(f, v, int(traffic["check_tracks"]), seed)
    u_check = check_users(p, int(traffic["check_users"]), seed)

    want = ref.event_tracks(kept["gen_seed"], t_check, shape, device=dev)
    bounds = torch.searchsorted(tracks, torch.tensor(t_check + [t + 1 for t in t_check],
                                                     dtype=tracks.dtype, device=tracks.device))
    lo, hi = bounds[:len(t_check)].tolist(), bounds[len(t_check):].tolist()
    item_lists, entries = [], _out_of_order(rows, tracks, p)
    for track, a, b in zip(t_check, lo, hi):
        got = rows[a:b].long()
        item_lists.append(got)
        w = want[track].to(got.device)
        if got.shape != w.shape or not torch.equal(got, w):
            entries += int((~torch.isin(got, w)).sum() + (~torch.isin(w, got)).sum())
    user_lists = [tracks[(rows == u).nonzero().flatten()].long() for u in u_check]
    lap("events")

    u_idx = torch.tensor(u_check, device=dev)
    t_idx = torch.tensor(t_check, device=dev)
    sums = (_bits_differ(k["rhs_users"][u_idx].cpu(),
                         ref.sequential_segment_rows(k["item_in"], user_lists))
            + _bits_differ(k["rhs_items"][t_idx].cpu(),
                           ref.sequential_segment_rows(k["user_out"], item_lists)))
    lap("segsum")
    g_item64, g_user64 = ref.gram64(k["item_in"], reg), ref.gram64(k["user_out"], reg)
    gram = max(_gram_gap(k["g_item"], g_item64), _gram_gap(k["g_user"], g_user64))
    solve = max(
        ref.solve_residual64(k["user_out"][u_idx], g_item64,
                             ref.segment_rows64(k["item_in"], user_lists)),
        ref.solve_residual64(k["item_out"][t_idx], g_user64,
                             ref.segment_rows64(k["user_out"], item_lists)))
    lap("gram_solve")
    want_loss = ref.loss64(rows, tracks, k["user_out"], k["item_out"], reg)
    loss = abs(kept["payload"]["final_loss"] - want_loss) / abs(want_loss)
    lap("loss")
    als_cfg = config["als"]
    user0, item0 = ref.init32(kept["als_seed"], p, v, int(als_cfg["rank"]))
    init = _bits_differ(k["user_init"], user0) + _bits_differ(k["item_init"], item0)
    del user0
    lap("init")
    want = ref.train64(rows, tracks, p, v, int(als_cfg["rank"]), int(als_cfg["iters"]), reg,
                       kept["als_seed"], item_init=item0)
    train = max(ref.rel_gap64(k["user_out"], want["user"]),
                ref.rel_gap64(k["item_out"], want["item"]))
    del want
    lap("train")
    payload = _bits_differ(kept["payload"]["item_factors"],
                           ref.normalize32(k["item_out"].cpu().numpy()))
    lap("payload")
    return {"event_entries_differ": entries, "segsum_bits_differ": sums, "gram_rel_gap": gram,
            "solve_residual": solve, "loss_rel_gap": loss, "init_bits_differ": init,
            "train_rel_gap": train, "payload_bits_differ": payload}


def check(config: dict, traffic: dict, seed: int, kept, dev, times: dict | None = None) -> dict:
    """Compare the kept rotation with the reference → ``{name: (value,
    limit)}`` (limits from the configuration; ``times`` gets each stage's
    host seconds)."""
    from kmlserver_tpu_torch.mining import als

    limits = config["limits"]
    names = ("event_entries_differ", "segsum_bits_differ", "gram_rel_gap", "solve_residual",
             "loss_rel_gap", "init_bits_differ", "train_rel_gap", "payload_bits_differ",
             "repeat_bits_differ")
    if kept is None or kept["payload"].get("storage") != "sparse" or not kept["keep"]:
        # nothing kept to compare: every check fails, with a finite reading
        # the result line's JSON can carry
        return {n: (float(1 << 53), limits[n]) for n in names}
    times = {} if times is None else times
    out = observe(config, traffic, seed, kept, dev, times)
    t = time.perf_counter()
    again = als.train_embeddings(kept["baskets"], _als_config(config["als"]),
                                 seed=kept["als_seed"], device=dev)
    times["repeat"] = time.perf_counter() - t
    first = kept["payload"]
    out["repeat_bits_differ"] = (_bits_differ(first["item_factors"], again["item_factors"])
                                 + int(first["final_loss"] != again["final_loss"]))
    return {n: (out[n], limits[n]) for n in names}
