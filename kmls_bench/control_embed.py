"""The embed cells' controls: the kept rotation trained one step below the
precision the configuration states, read by the cell's own check
(``cells/embed.observe``). A control has to come out as not correct; its
readings set the upper end of each limit (``PERF.md`` has them).

- ``tf32``: the training with TF32 on for its products (the sweeps'
  Gramians and the loss's), where the configuration states TF32 off;
- ``bf16``: every factor row the training gathers (the sweeps' segment
  sums, the loss's cross term) rounded to bfloat16 first, where the
  configuration states float32.

``python3 -m kmls_bench.control_embed --workload <cell> --seeds s1,s2
[--controls tf32,bf16]`` prints one JSON line per seed and control, on the
card where there is one. Each trains rotation 0 of the seed's window.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch

from .cells import embed as cell


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


@contextlib.contextmanager
def control(name: str):
    """The program with ``name``'s lower precision inside."""
    from kmlserver_tpu_torch.mining import als

    if name == "tf32":
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
        return
    if name != "bf16":
        raise ValueError(f"no control {name!r}")
    segment_sum, loss = als.segment_sum, als._sparse_als_loss

    def rounded_loss(rows, cols, user_f, item_f, reg):
        return loss(rows, cols, user_f.as_subclass(_RoundedRows),
                    item_f.as_subclass(_RoundedRows), reg).as_subclass(torch.Tensor)

    als.segment_sum = lambda mat, csr: segment_sum(_bf16(mat), csr)
    als._sparse_als_loss = rounded_loss
    try:
        yield
    finally:
        als.segment_sum, als._sparse_als_loss = segment_sum, loss


class _RoundedRows(torch.Tensor):
    """A factor matrix whose gathered rows (``mat[index]``) come out
    rounded to bfloat16; every other operation is the plain tensor's."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        out = super().__torch_function__(func, types, args, kwargs or {})
        if func is torch.Tensor.__getitem__ and isinstance(args[1], torch.Tensor):
            out = _bf16(out.as_subclass(torch.Tensor)).as_subclass(cls)
        return out


def embed_control(config: dict, traffic: dict, seed: int, device, name: str) -> dict:
    from kmlserver_tpu_torch.mining.vocab import Vocab

    v = int(config["deployment"]["tracks"])
    names = [f"track_{t:07d}" for t in range(v)]
    vocab = Vocab(names=names, index={n: t for t, n in enumerate(names)})
    gen_seed, als_seed = cell.seeds(seed, 0)
    keep: dict = {}
    t = time.perf_counter()
    with control(name):
        baskets, payload = cell.rotation(device, config, vocab, gen_seed, als_seed, keep)
    train_s = time.perf_counter() - t
    kept = {"gen_seed": gen_seed, "als_seed": als_seed, "baskets": baskets, "payload": payload,
            "keep": keep}
    times: dict = {"train": train_s}
    out = cell.observe(config, traffic, seed, kept, device, times)
    return {**out, "seconds": times}


def main(argv=None) -> int:
    from .run import load_cell

    parser = argparse.ArgumentParser(prog="python3 -m kmls_bench.control_embed")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--controls", default="tf32,bf16")
    args = parser.parse_args(argv)
    spec = load_cell(args.workload)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in (int(s) for s in args.seeds.split(",")):
        for name in args.controls.split(","):
            out = embed_control(spec["config"], spec["traffic"], seed, device, name)
            print(json.dumps({"workload": args.workload, "seed": seed, "control": name,
                              "device": str(device), **out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
