"""The ALS init's standard normals on the card — the port's CUDA kernels
``ops/csrc/normals.cu``.

The training's init is numpy's host draw: ``default_rng(seed)``'s float64
standard normals, users' ``(p, rank)`` rows then items' ``(v, rank)``, one
stream, each rounded by :func:`round_rows`. At config 4 that is 352M
values on one host core. :func:`init_rows` draws the same values on the
card, bit for bit, from the same stream:

- **the stream** is PCG64 (a 128-bit LCG, ``state ← state·MULT + inc``,
  the XSL-RR output of each new state); :func:`pcg64_start` reads the
  seeded state from numpy, so numpy's seeding stays the one in use;
- **the values** are numpy's ziggurat (``random_standard_normal``) over
  numpy's own tables (:func:`tables`, copied from
  ``numpy/random/src/distributions/ziggurat_constants.h``). Raw ``t``
  starts an attempt that uses 1 raw (accepted at once), 2 (the wedge,
  accepted or not) or ``1 + 2k`` (the tail, ``k`` pairs of uniforms);
  the stream's attempts are the chain ``t → t + used(t)`` from raw 0.

The kernels give each thread a chunk of :data:`CHUNK` raws and cut the
chain at barriers (a raw no attempt in the :data:`WINDOW` raws below it
jumps over), so each chunk is walked alone; a count pass, a cumulative
sum and a write pass place every value. The card's ``exp`` and ``log1p``
are not the host's: a comparison whose two sides lie within ``1e-14`` of
each other, or an attempt longer than the window, makes :func:`init_rows`
return None, and the caller draws on the host. A tail value (about one
value in 4,000) is finished on the host with its ``math.log1p``.

The plain versions (:func:`standard_normal_plain`, the chain walked
whole or chunk by chunk as the kernels walk it) are numpy and Python over
numpy's raw stream, and equal ``Generator.standard_normal`` bit for bit.
"""

from __future__ import annotations

import base64
import ctypes
import math
from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

# launches of the CUDA kernels, counted by the wrapper where it launches:
# the count pass and the write pass of each draw
LAUNCHES = {"normals": 0}

CHUNK = 512  # raws a thread walks
WINDOW = 32  # raws below a barrier its test looks at; the longest attempt trusted

MULT = (0x2360ED051FC65DA4 << 64) | 0x4385DF649FCCF645  # PCG64's multiplier
NOR_R = float.fromhex("0x1.d3bb48209ad33p+1")  # numpy's ziggurat_nor_r
NEG_NOR_INV_R = float.fromhex("-0x1.183aa6c20e8c1p-2")  # -ziggurat_nor_inv_r

_M64 = (1 << 64) - 1
_M128 = (1 << 128) - 1
_MANTISSA = (1 << 52) - 1
_SIGN_BIT = 62  # a tail record's slot carries the value's sign here
_SLOT_MASK = (1 << _SIGN_BIT) - 1


def round_rows(values: np.ndarray, rank: int) -> np.ndarray:
    """The init's rounding of float64 normals: float32, over ``sqrt(rank)``
    (in numpy's promotion of a float32 array and a float64 scalar), then
    float32."""
    return (values.astype(np.float32) / np.sqrt(rank)).astype(np.float32)


def divides_in_float64(rank: int) -> bool:
    """Whether :func:`round_rows` divides in float64 (numpy ≥ 2) or
    float32 (numpy 1's value-based promotion)."""
    return (np.ones(1, np.float32) / np.sqrt(rank)).dtype == np.float64


def pcg64_start(seed: int) -> tuple[int, int]:
    """``default_rng(seed)``'s PCG64 state and increment (128-bit ints)."""
    st = np.random.PCG64(seed).state["state"]
    return int(st["state"]), int(st["inc"])


def pcg64_raw_plain(state: int, inc: int, n: int) -> list[int]:
    """The first ``n`` raws of PCG64 from ``(state, inc)``, in Python ints:
    the kernels' step and output."""
    out = []
    for _ in range(n):
        state = (state * MULT + inc) & _M128
        x = ((state >> 64) ^ state) & _M64
        rot = state >> 122
        out.append(((x >> rot) | (x << ((64 - rot) & 63))) & _M64)
    return out


@lru_cache(maxsize=None)
def tables() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """numpy's ziggurat tables ``(ki, wi, fi)``: uint64, float64, float64,
    256 layers each."""
    raw = base64.b64decode("".join(_TABLES_B64))
    fi = np.frombuffer(raw[:2048], "<f8").copy()
    wi = np.frombuffer(raw[2048:4096], "<f8").copy()
    ki = np.frombuffer(raw[4096:], "<u8").copy()
    return ki, wi, fi


def _uniform(raw: int) -> float:
    return (raw >> 11) * (1.0 / 9007199254740992.0)


def attempts_plain(raws: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The attempt each of raws ``[0, n)`` would start → ``(used, emit,
    value)``: raws it reads, whether it gives a value, and the value.
    ``raws`` (uint64) runs far enough past ``n`` for the last attempts."""
    ki, wi, fi = tables()
    r = raws[:n]
    idx = (r & np.uint64(0xFF)).astype(np.int64)
    rr = r >> np.uint64(8)
    rabs = (rr >> np.uint64(1)) & np.uint64(_MANTISSA)
    value = rabs.astype(np.float64) * wi[idx]
    value = np.where((rr & np.uint64(1)).astype(bool), -value, value)
    emit = rabs < ki[idx]
    used = np.ones(n, np.int64)
    for t in np.flatnonzero(~emit).tolist():
        i, x = int(idx[t]), float(value[t])
        if i == 0:
            s = t + 1
            while True:
                xx = NEG_NOR_INV_R * math.log1p(-_uniform(int(raws[s])))
                yy = -math.log1p(-_uniform(int(raws[s + 1])))
                s += 2
                if yy + yy > xx * xx:
                    break
            v = NOR_R + xx
            value[t] = -v if (int(rabs[t]) >> 8) & 1 else v
            used[t], emit[t] = s - t, True
        else:
            u = _uniform(int(raws[t + 1]))
            lhs = (float(fi[i - 1]) - float(fi[i])) * u + float(fi[i])
            used[t], emit[t] = 2, lhs < math.exp(-0.5 * x * x)
    return used, emit, value


def chain_plain(used: np.ndarray, n: int) -> np.ndarray:
    """The attempts the stream makes from raw 0 (the chain ``t → t +
    used[t]``) below ``n``, in order."""
    special = np.flatnonzero(used != 1)
    starts, s = [], 0
    while s < n:
        k = int(np.searchsorted(special, s))
        nxt = int(special[k]) if k < special.shape[0] else n
        starts.append(np.arange(s, min(nxt, n)))
        if nxt >= n:
            break
        starts.append(np.array([nxt]))
        s = nxt + int(used[nxt])
    return np.concatenate(starts) if starts else np.zeros(0, np.int64)


def barrier_plain(used: np.ndarray, lo: int, window: int) -> int:
    """The kernels' barrier: the first raw ``s ≥ lo`` that no attempt at a
    raw in ``[s - window, s)`` jumps over (an attempt longer than the
    window counts as the window)."""
    s, reach = max(lo - window, 0), 0
    while not (s >= lo and reach <= s):
        reach = max(reach, s + min(int(used[s]), window))
        s += 1
    return s


def chunked_chain_plain(used: np.ndarray, n_chunks: int, chunk: int,
                        window: int) -> tuple[np.ndarray, bool]:
    """The kernels' walk: chunk ``j`` walks the chain from the barrier at or
    past ``j·chunk`` to the one at or past ``(j+1)·chunk`` → ``(starts,
    sound)``; ``sound`` is False where an attempt on a walk is longer than
    the window or a walk misses its barrier (the kernels' status)."""
    starts, sound = [], True
    for j in range(n_chunks):
        s, stop = barrier_plain(used, j * chunk, window), barrier_plain(used, (j + 1) * chunk,
                                                                          window)
        while s < stop:
            starts.append(s)
            sound &= int(used[s]) <= window
            s += int(used[s])
        sound &= s == stop
    return np.asarray(starts, np.int64), sound


def standard_normal_plain(seed: int, n: int, *, chunk: int | None = None,
                          window: int = WINDOW) -> np.ndarray:
    """``default_rng(seed).standard_normal(n)`` from the raw stream and the
    tables: the chain walked whole, or (``chunk``) chunk by chunk as the
    kernels walk it."""
    positions = n + n // 16 + 1024
    chunks = -(-positions // (chunk or positions))
    ahead = chunks * (chunk or positions) + 8 * window  # the last barrier's search
    raws = np.random.PCG64(seed).random_raw(ahead + 256)
    used, emit, value = attempts_plain(raws, ahead)
    if chunk is None:
        starts = chain_plain(used, positions)
    else:
        starts, sound = chunked_chain_plain(used, chunks, chunk, window)
        if not sound:
            raise ValueError("an attempt longer than the window: the kernels would decline")
    out = value[starts[emit[starts]]]
    if out.shape[0] < n:
        raise ValueError(f"{positions} raws gave {out.shape[0]} values, fewer than {n}")
    return out[:n]


@lru_cache(maxsize=None)
def _device_tables(device: torch.device) -> tuple[torch.Tensor, ...]:
    ki, wi, fi = tables()
    return (torch.from_numpy(ki.view(np.int64)).to(device), torch.from_numpy(wi).to(device),
            torch.from_numpy(fi).to(device))


def _launch(fn, what: str, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def init_rows(seed: int, rows: Sequence[int], rank: int,
              device: torch.device) -> tuple[torch.Tensor, torch.Tensor] | None:
    """``default_rng(seed)``'s first ``(rows[0] + rows[1])·rank`` standard
    normals drawn on the CUDA ``device``, rounded by :func:`round_rows`, as
    float32 ``(rows[0], rank)`` then ``(rows[1], rank)`` tensors — or None
    where the kernels decline (see the module's docstring): the caller then
    draws on the host."""
    n_split, n_out = rows[0] * rank, (rows[0] + rows[1]) * rank
    outs = tuple(torch.empty((r, rank), dtype=torch.float32, device=device) for r in rows)
    state, inc = pcg64_start(seed)
    chunks = -(-(n_out + n_out // 32 + (1 << 16)) // CHUNK)  # ~1.022 raws a value
    stream_args = (state >> 64, state & _M64, inc >> 64, inc & _M64, chunks, CHUNK, WINDOW)
    ki, wi, fi = _device_tables(device)
    counts = torch.empty(chunks, dtype=torch.int64, device=device)
    tails = torch.empty(chunks, dtype=torch.int64, device=device)
    status = torch.zeros(1, dtype=torch.int32, device=device)
    lib = kernel_lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _launch(lib.kmls_normals_count, "normals count", *stream_args, ki.data_ptr(),
                wi.data_ptr(), fi.data_ptr(), counts.data_ptr(), tails.data_ptr(),
                status.data_ptr(), stream)
        LAUNCHES["normals"] += 1
        ends, tail_ends = torch.cumsum(counts, 0), torch.cumsum(tails, 0)
        total, n_tail, bad = torch.stack(
            [ends[-1], tail_ends[-1], status[0].to(torch.int64)]).tolist()
        if bad or total < n_out:
            return None
        first, tail_first = ends - counts, tail_ends - tails
        slot = torch.full((max(n_tail, 1),), -1, dtype=torch.int64, device=device)
        u1 = torch.empty(max(n_tail, 1), dtype=torch.float64, device=device)
        root = float(np.sqrt(rank))
        _launch(lib.kmls_normals_write, "normals write", *stream_args, ki.data_ptr(),
                wi.data_ptr(), fi.data_ptr(), first.data_ptr(), tail_first.data_ptr(),
                n_out, n_split, outs[0].data_ptr(),
                outs[1].data_ptr(), int(divides_in_float64(rank)), root,
                float(np.float32(root)), slot.data_ptr(), u1.data_ptr(), stream)
        LAUNCHES["normals"] += 1
    _finish_tails(outs, slot.cpu().numpy(), u1.cpu().numpy(), n_split, n_out, rank)
    return outs


def _finish_tails(outs, slot: np.ndarray, u1: np.ndarray, n_split: int, n_out: int,
                  rank: int) -> None:
    """Write the tail values, finished with the host's ``math.log1p``,
    into their slots (a record's slot is -1 where its chunk wrote none)."""
    keep = (slot >= 0) & ((slot & _SLOT_MASK) < n_out)
    slot, u1 = slot[keep], u1[keep]
    if slot.shape[0] == 0:
        return
    v = np.array([NOR_R + NEG_NOR_INV_R * math.log1p(-u) for u in u1.tolist()])
    v = np.where((slot >> _SIGN_BIT) & 1 == 1, -v, v)
    at = torch.from_numpy(slot & _SLOT_MASK)
    vals = torch.from_numpy(round_rows(v, rank))
    first = at < n_split
    outs[0].view(-1)[at[first].to(outs[0].device)] = vals[first].to(outs[0].device)
    outs[1].view(-1)[(at[~first] - n_split).to(outs[1].device)] = vals[~first].to(outs[1].device)


def kernel_lib() -> ctypes.CDLL:
    from . import cuda_build

    lib = cuda_build.load("normals")
    if lib.kmls_normals_count.argtypes is None:
        ptr, i64, u64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint64, ctypes.c_int
        stream_args = [u64, u64, u64, u64, i64, i32, i32, ptr, ptr, ptr]
        lib.kmls_normals_count.argtypes = stream_args + [ptr, ptr, ptr, ptr]
        lib.kmls_normals_write.argtypes = stream_args + [
            ptr, ptr, i64, i64, ptr, ptr, i32, ctypes.c_double, ctypes.c_float, ptr, ptr, ptr]
        for fn in (lib.kmls_normals_count, lib.kmls_normals_write):
            fn.restype = ctypes.c_int
    return lib


# numpy's ziggurat tables, little-endian: fi_double (256 float64), wi_double
# (256 float64), ki_double (256 uint64), as numpy/random/src/distributions/
# ziggurat_constants.h defines them (sha256 e3811c13...5da48cd1c)
_TABLES_B64 = (
    "AAAAAAAA8D+H8HnJakTvPxWpbFtUt+4/d/An4BE/7j+V3gSnb9PtP/K8VwaScO0/3BmheEkU7T/r"
    "LaeoM73sP394qc5eauw/6rru2Rwb7D+C3OFO687rP1L1jzplhes/EN00gjo+6z+i6Gw/KvnqPwQl"
    "evH+teo/4clQ1Yt06j8Pr/X9qjTqP9gfZe479uk/gQYkjSK56T/BemFXRn3pP0d6G8KRQuk/T3Ex"
    "vfEI6T+oCuZPVdDoPwLfukitmOg/rLw3/Oth6D9uz1YPBSzoP8viIEvt9uc/WGicd5rC5z/VsKA8"
    "A4/nP1bYcAcfXOc/Em0/9OUp5z/ueuq6UPjmP4laY55Yx+Y/KjtRXveW5j8j45IqJ2fmPxgMVZji"
    "N+Y/ZSaAmCQJ5j9q/0pv6NrlP4lcyKwpreU/j41MJuR/5T9Gno3wE1PlP9VsZVq1JuU/Z7Yg6MT6"
    "5D/ATklPP8/kP3hS3HIhpOQ/ElDfX2h55D95NklKEU/kP+NfNYoZJeQ/gltYmX774z+jMa8QPtLj"
    "Pw7NYqZVqeM/1QDaK8OA4z/pUPWLhFjjPzU6cMmXMOM/7zhk/foI4z/uO+pVrOHiP0qV1xSquuI/"
    "Fc2TjvKT4j/tBAUphG3iP4TbkFpdR+I/8vcvqXwh4j8glpKp4PvhP2mZVP6H1uE/EdE/V3Gx4T9Q"
    "PJtwm4zhP9o5hhIFaOE/nKleEK1D4T84HzFIkh/hPxNZMqKz++A/oEJBEBDY4D+u2XCNprTgP4Fd"
    "mR12keA/NjzwzH1u4D8uP6avvEvgPyqCi+ExKeA/xMq4hdwG4D+hvXuMd8nfP8oAqaedhd8/83ov"
    "yylC3z+Vj35xGv/eP1QfvSBuvN4/xcNOaiN63j+Fm1/qODjePwk6dket9t0/sVYLMn+13T8z3iZk"
    "rXTdP4AQAqE2NN0/bVuutBn03D9IqMBzVbTcP8fXALvodNw/uCwdb9I13D8XamF8EffbP5Ftcdak"
    "uNs/GxMHeIt62z/KMbNixDzbP1KFoZ5O/9o/nlpfOinC2j+A2KRKU4XaP03AIOrLSNo/PoRGOZIM"
    "2j/fkx5epdDZP8bAGIQEldk/k5/g265Z2T8XyzObox7ZPxXxufzh49g/iJHeP2mp2D+2WqyoOG/Y"
    "P9kNqn9PNdg/Edm4Ea371z+wFPSvUMLXP+tSkq85idc/7bHHaWdQ1z9MYak72RfXP6pMEoaO39Y/"
    "Id6IrYan1j/iyyUawW/WPxXlezc9ONY/yNKAdPoA1j9EwnZD+MnVP77u1hk2k9U/AAE9cLNc1T/t"
    "O1PCbybVP5Jtv45q8NQ/opwQV6O61D/Uaq2fGYXUP/4kw+/MT9Q/GXo10bwa1D/b0o7Q6OXTP65D"
    "8XxQsdM/eRMIaPN80z+e0fkl0UjTPy/2Wk3pFNM/Zgchdzvh0j/dP5Y+x63SPx6xTUGMetI/id4X"
    "H4pH0j+ezPd5wBTSPxaBGPYu4tE/UPDCOdWv0T/oVFTtsn3RP2fuNLvHS9E/IyTPTxMa0T/ECYdZ"
    "lejQP9pCsohNt9A/NkOQjzuG0D/Z6UIiX1XQP350x/a3JNA/xZPfiYvozz81MriMEIjPP9KY6Wz+"
    "J88/RJzJpFTIzj/dPCiyEmnOP4RxRRY4Cs4/CpDHVcSrzT9PUbL4tk3NP8xvXooP8Mw/U99xmc2S"
    "zD9Hndi38DXMP6EYvnp42cs/qjGHemR9yz860cxStCHLPwcYV6Jnxso/fiYZC35ryj89fi0y9xDK"
    "P1r+0r/Stsk/J3xqXxBdyT9p+nS/rwPJP1uBkpGwqsg/OJqBihJSyD91cR9i1fnHPyOjaNP4occ/"
    "prV6nHxKxz8WR5Z+YPPGP1zyIT6knMY/nPGtokdGxj/5g/h2SvDFP2wd84ismsU/NWjIqW1FxT/B"
    "H+OtjfDEPy3O9WwMnMQ/1XUDwulHxD+uMWmLJfTDP+7X6Kq/oMM/iKu0BbhNwz9lKnyEDvvCPxoH"
    "ehPDqMI/t16DotVWwj80PBglRgXCP0J9dZIUtME/Yy2o5UBjwT+5bqIdyxLBP7oJUj2zwsA/hb+4"
    "S/lywD8qfQZUnSPAPywia8s+qb8/HA5SKf8Lvz9LpZrye2++P4/odmG1070/5ZG9uas4vT8KdDtJ"
    "X568PxUQC2jQBLw/M+LyeP9ruz8z9srp7NO6P4Zi6jOZPLo/GVud3ASmuT+roKR1MBC5P1Iov50c"
    "e7g/1u8+Acrmtz92EapaOVO3P0xKaXNrwLY/GE2FJGEutj+kZnRXG521P64r+gabDLU/EyIbQOF8"
    "tD+GmiYj7+2zP3A+2eTFX7M/ETGbz2bSsj+RDd1E00WyP32Jl74MurE/nRfy0BQvsT8llhUs7aSw"
    "P5fkMJ6XG7A/NW5sKywmrz+BUbJH1RauP2Lxrf4uCa0/LCooDz79qz9wXziQB/OqP2NVKfmQ6qk/"
    "q7VoKuDjqD8eJ693+96nP2TQmLPp26Y/1K3yPLLapT9dJxEOXdukP8vumM7y3aM/l/Q96Hzioj+8"
    "ah+fBemhPxGAli6Y8aA/xKUY14H4nz91jILbGhKePxoJzYMZMJw/+OsiTp9Smj8KwQC20XmYP4K/"
    "C/TapZY/ZLD78urWlD8TXquNOA2TPxIwYDQDSZE/Sd1yTyoVjz+sj08njaSLP3ikjQ0EQYg/4M8a"
    "QpbrhD+SL5UpkqWBPzdo7Phg4Xw/XbgM2aiedj/9sbADH4pwP2ewwUOfX2U/D/e5tgWmVD952RV4"
    "O0nPPMb2/eMLjYs8tFssPK9QkjxhO0Q4uXyVPAynL+j8AZg8vNBMLgwjmjz3YTgvTQCcPHRydFov"
    "rJ08w9VMLUgynzytu44nMk2gPENdAjsF9aA8dzZBl6aSoTz1GnqPoieiPIDYYzgutaI89ZFXwD88"
    "ozwvsaLBnr2jPFWb/43vOaQ8p/49NruxpDx00xpidSWlPJbOB6eAlaU86n7ZzzECpjw9fKNh0mum"
    "PHAFAJKi0qY8pvhG09o2pzx3KrMQrZinPEP1Rq1F+Kc8dwpDU8xVqDyadnueZLGoPJjPTqkuC6k8"
    "6h4sgkdjqTxGxTiOybmpPCynpNzMDqo8Wc13bWdiqjwwFhBurbSqPJxsE22xBas8KXpCh4RVqzw6"
    "n1KONqSrPDKCvyrW8as8805Z+XA+rDxhOzKlE4qsPIsmcv7J1Kw8SLeADp8erTwQH+QpnWetPMO4"
    "IwDOr608U3bxqTr3rTz+7dK16z2uPABvejPpg648zoL5vTrJrjwmYvCE5w2vPIj22FT2Ua88rteH"
    "nm2VrzysLvp9U9ivPOw0QuBWDbA8mo859UAusDz8pRae6k6wPBCgcltWb7A8C/RxkIaPsDwTYbyE"
    "fa+wPH/MS2Y9z7A8awgWS8jusDzuFZUyIA6xPL4PMQdHLbE8QZGOnz5MsTweIMS/CGuxPDTaeBqn"
    "ibE8iG3uURuosTzLKvj4ZsaxPC7U4JOL5LE8n6BAmYoCsjzpxsRyZSCyPB/D6X0dPrI8+2upDLRb"
    "sjx/0x1mKnmyPBvXGceBlrI82i64YruzsjxTuOFi2NCyPI6py+jZ7bI810huDcEKszwwufThjiez"
    "PKFeJnBERLM81VLKuuJgszxqWAW+an2zPGSysm/dmbM8Az24vzu2szzgHVaYhtKzPINact6+7rM8"
    "dJ7gceUKtDxddKYt+ya0PKQwPOgAQ7Q8XcfKc/detDw2w2ae33q0PC+PSDK6lrQ8XUEC9oeytDzc"
    "EbOsSc60PAWmOBYA6rQ8YlVe76sFtTxaiwryTSG1PE9matXmPLU8yLIbTndYtTx4X1UOAHS1PBSF"
    "DsaBj7U8WRskI/2qtTw9c33Rcsa1PNOML3vj4bU8OF6fyE/9tTzDH6NguBi2PKKwougdNLY8Cya3"
    "BIFPtjxylslX4mq2PDcxsYNChrY8sbJQKaKhtjy7Q7PoAb22PFLTKGFi2LY8VPhhMcTztjzraIv3"
    "Jw+3PMYUaVGOKrc83O5w3PdFtzwfc+U1ZWG3PEn07/rWfLc8k726yE2YtzwJFIs8yrO3PPsi2/NM"
    "z7c8595zjNbqtzwf6oakZwa4PHaGyNoAIrg8FZ+JzqI9uDy99dEfTlm4PMV+em8Ddbg8LfdHX8OQ"
    "uDxDwAWSjqy4PJwMoatlyLg8J2pEUUnkuDyPtXMpOgC5PEeDKNw4HLk8/ArvEkY4uTyKogN5YlS5"
    "PO7VcLuOcLk8MSouicuMuTy/mT+TGam5PCzZ1Yx5xbk8EXRvK+zhuTxK0vomcv65PJI2+TkMG7o8"
    "W8iiIbs3ujyIuwuef1S6PKSpSnJacbo8PTGgZEyOujwI8Z8+Vqu6PM71Ws14yLo8NrOL4bTlujwa"
    "ocNPCwO7PFuYmvB8ILs8AAzgoAo+uzwDPc5BtVu7PCeJP7l9ebs8PPfl8WSXuzxuJYXba7W7PKLA"
    "LmuT07s8g66Bm9zxuzygFuxsSBC8PC168OXXLrw8HA1uE4xNvDwFh+wIZmy8PBem6+Bmi7w8q6I2"
    "vY+qvDyQ1jvH4cm8PDfgaDBe6bw8bo+LMgYJvTwg7zcQ2yi9PEfGMxXeSL08I/HnlhBpvTyl+9f0"
    "c4m9PHBuIJkJqr08Dkn8+NLKvTw3LlKV0eu9PBzSSfsGDb489kbqxHQuvjyI0cGZHFC+PCX+ly8A"
    "cr48Cr8qSyGUvjwIb/fAgba+PDqnEHYj2b48qewBYQj8vjwhU8KKMh+/PG1Ntw+kQr88aAHJIF9m"
    "vzyCl4kEZoq/PL8icRi7rr88hecv0mDTvzwL9hjBWfi/PHWg00fUDsA8R8mPAqghwDyrAqmDqTTA"
    "PMf1Pk7aR8A8frOt9jtbwDxoJqcj0G7APBcuY4+YgsA8VKLoCJeWwDzEwHF1zarAPEjU7tE9v8A8"
    "MD2qNOrTwDyTZRHP1OjAPLafpu///cA8QXAgBG4TwTw1XbubISnBPG0JxGkdP8E8Oy5gSGRVwTzz"
    "7p07+WvBPGES0nTfgsE8rOtOVhqawTyOL393rbHBPJSmcamcycE8Oa7k++vhwTwB2eLCn/rBPIHM"
    "BJ28E8I87tNvekctwjwknKykRUfCPOBYdse8YcI8Llmo+rJ8wjx4DnfNLpjCPFIKKlM3tMI8l9uW"
    "MdTQwjz1eKmxDe7CPO6uVtLsC8M8o6RoXnsqwzyjEq4FxEnDPECoM3rSacM8CkFWkrOKwzz6iK5w"
    "dazDPKYEF7Mnz8M8dfRgqtvywzza5bmcpBfEPJReVBWYPcQ8FTqnRM5kxDy8Q5x1Yo3EPCdaa51z"
    "t8Q8AonNDSXjxDxBrOlTnxDFPEJ+OlIRQMU8G+RKqbFxxTzZjXGLwKXFPP7QOiSK3MU8TB6Gz2kW"
    "xjzqagB7zlPGPMPln75AlcY8MuIJjWvbxjw0el/wKCfHPHMGCVaVecc8jM7W9C3Uxzw08ikFAznI"
    "PBR8qr8Pq8g8lkRvlOAuyTyrV0AB7svJPFp3lHjcj8o8sf14OB+YyzwzrQmCtDvNPGrvJYA98w4A"
    "AAAAAAAAAACoxvuYvggMAEKBvfpUow0A6u7BfvZRDgB+99PpVbIOALnKfoFL7w4AqkT6CkcZDwAY"
    "y/9h7TcPAFwlYZVGTw8AlqMb5KVhDwCkllN1enAPAJpEKOyyfA8A01djDPGGDwDeJYNXpo8PANrQ"
    "Tccklw8ACfXbB6mdDwB0+oH1YKMPAPhLW95vqA8A3FTTYPGsDwAPuRhn+7APAMZ0U42ftA8Ad/5m"
    "I+y3DwAO5aHp7LoPAO0LBJ2rvQ8AV2z/YDDADwBIojcQgsIPANFb4nqmxA8AMe56l6LGDwCkliip"
    "esgPAIXeS14yyg8AGiMC6czLDwDEOfgSTc0PAJnsj021zg8AMMkdvwfQDwDmxNZNRtEPAFD04qhy"
    "0g8AHsnwT47TDwB4tJCZmtQPAFMPkriY1Q8A7JmOwInWDwAy6MipbtcPAOgIe1RI2A8AjCytixfZ"
    "DwDSracH3dkPAIxeEHCZ2g8AIC7AXU3bDwDQ/Ftc+dsPAH2aueud3A8AnXIYgTvdDwCQLzSI0t0P"
    "AGSfNmRj3g8ATlGNcO7eDwAutKYBdN8PAEDtmWX03w8A8iS85G/gDwBYoiXC5uAPAEy4KDxZ4Q8A"
    "mT+8jMfhDwCqHNvpMeIPAJEb2oWY4g8AhkG1j/viDwBKjVUzW+MPACoA0Jm34w8Af62e6RDkDwA0"
    "d9RGZ+QPAFwJTNO65A8AJJXSrgvlDwB4vE73WeUPABIS5Mil5Q8AiYYTPu/lDwB4ENlvNuYPAHjV"
    "xnV75g8AqhEeZr7mDwDy9OVV/+YPAAKnAFk+5w8AOZ4+gnvnDwCicHDjtucPAENCd43w5w8AjPBT"
    "kCjoDwA6FzX7XugPAGQIhNyT6A8AvM7wQcfoDwD2Tn04+egPAB2bh8wp6Q8A6ojTCVnpDwCimpP7"
    "hukPAGZIcayz6Q8A1baUJt/pDwB85qtzCeoPAKRm8Zwy6g8ALJUyq1rqDwAadNWmgeoPAPAc3pen"
    "6g8AINnzhczqDwA85mV48OoPABPsL3YT6w8ASir+hTXrDwC0YjGuVusPAPqE4vR26w8AFCDmX5br"
    "DwB8nc/0tOsPANBJ9LjS6w8APi5use/rDwDovR7jC+wPABVasVIn7A8A06+dBELsDwCW8Sn9W+wP"
    "APTubEB17A8AtAxQ0o3sDwASH5G2pewPAP4nxPC87A8AFftUhNPsDwCzyIh06ewPALeRf8T+7A8A"
    "KIU1dxPtDwADSYSPJ+0PAEwvJBA77Q8Ablit+03tDwDdw5hUYO0PAOhPQR1y7Q8AgqnkV4PtDwDI"
    "LKQGlO0PAAS3hSuk7Q8AtGp0yLPtDwBSZkHfwu0PAFJupHHR7Q8A04o8gd/tDwCAmZAP7e0PABTU"
    "Dx767Q8AxEsSrgbuDwAGWtnAEu4PAOAGkFce7g8AJGVLcynuDwC85AoVNO4PADybuD0+7g8A9IIp"
    "7kfuDwCGsB0nUe4PAEF/QOlZ7g8ALrQoNWLuDwDxl1gLau4PAHoHPmxx7g8AgnsyWHjuDwC6BnvP"
    "fu4PALJKSNKE7g8AQ2O2YIruDwBRyMx6j+4PANolfiCU7g8A6imoUZjuDwBcSBMOnO4PAPRzclWf"
    "7g8ArsxiJ6LuDwCsQmuDpO4PAHEt/Gim7g8A+tZu16fuDwAK+gTOqO4PADsz6Eup7g8AEGQpUKnu"
    "DwBeB8DZqO4PAFR2ieen7g8AJB1IeKbuDwCDnqKKpO4PANrkIh2i7g8AJCA1Lp/uDwAurya8m+4P"
    "AOTyJMWX7g8AOgo8R5PuDwAWdVVAju4PAHqcNq6I7g8A/T1/joLuDwCIuKfee+4PAP83/5t07g8A"
    "Xr2pw2zuDwB+AJ5SZO4PAIgoo0Vb7g8AtldOmVHuDwDPBgBKR+4PAFAs4VM87g8A2CrgsjDuDwAF"
    "gq1iJO4PAFo8uF4X7g8ARxQqognuDwDMSeMn++0PAGwhdurr7Q8AfgQi5NvtDwDTOc4Oy+0PAPQs"
    "BGS57Q8AyTjp3KbtDwCN6Tdyk+0PADaoOBx/7Q8AK8C50mntDwAArgaNU+0PACKk3kE87Q8A2C9q"
    "5yPtDwBE5i9zCu0PADT+B9rv7A8AuLcOENTsDwC0bpUIt+wPAMEwEraY7A8AeKkNCnnsDwD+MQ/1"
    "V+wPAGLJhmY17A8ANbO0TBHsDwDQb46U6+sPAJK2oCnE6w8A3Azu9ZrrDwBChcnhb+sPAJ4frdNC"
    "6w8ASy0LsBPrDwDpAhpZ4uoPAFcima6u6g8AJuOOjXjqDwDlc/3PP+oPAPbZjUwE6g8AO1Yv1sXp"
    "DwCkR6k7hOkPAChHHUc/6Q8A1sV2vfboDwDm6MRdqugPAOqxeuBZ6A8AQKmQ9gToDwDAM4JIq+cP"
    "AKVqH3VM5w8AAqIqEOjmDwDYq7agfeYPAH4wOJ8M5g8AQvc4c5TlDwCAcpdwFOUPAFj0NtSL5A8A"
    "Nx79v/njDwCcse41XeMPAP7kLxK14g8AV1WZAwDiDwAUg3iCPOEPALBn7sRo4A8AqnErsILfDwCq"
    "/n7Fh94PAP07xgl13Q8AE78p5UbcDwCCAi74+NoPAHW6suGF2Q8ABM9I7+bXDwALZb2tE9YPABLw"
    "4kkB1A8ArMe0p6HRDwCeH3YE4s4PALIRXtioyw8AIi3NbtLHDwDtIh4vK8MPADq4wIFlvQ8ANFQA"
    "xAa2DwB0KCpYQKwPAJhFAR6Xng8A/B2kSPqJDwAsMPD3xWYPAEocM0taGg8A"
)
