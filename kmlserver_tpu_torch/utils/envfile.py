"""Minimal ``.env`` loader.

The reference loads local-dev defaults with python-dotenv (reference:
machine-learning/main.py:17-20, rest_api/app/main.py:31-33); that package is
not part of this image, so this is a small from-scratch parser with the same
observable behavior we rely on: ``KEY=VALUE`` lines, ``#`` comments, optional
``export`` prefix, single/double quote stripping, and *no override* of
variables already present in the process environment (dotenv's default).
"""

from __future__ import annotations

import os


def parse_env_line(line: str) -> tuple[str, str] | None:
    line = line.strip()
    if not line or line.startswith("#"):
        return None
    if line.startswith("export "):
        line = line[len("export "):].lstrip()
    if "=" not in line:
        return None
    key, _, value = line.partition("=")
    key = key.strip()
    if not key or any(c.isspace() for c in key):
        return None
    value = value.strip()
    if value and value[0] in ("'", '"'):
        # quoted value: ends at the matching close quote; anything after
        # (e.g. an inline comment) is discarded
        close = value.find(value[0], 1)
        if close != -1:
            value = value[1:close]
    else:
        hash_pos = value.find(" #")
        if hash_pos != -1:
            value = value[:hash_pos].rstrip()
    return key, value


def load_dotenv(path: str | os.PathLike = ".env", *, override: bool = False) -> dict[str, str]:
    """Load ``path`` into ``os.environ``. Returns the parsed mapping."""
    parsed: dict[str, str] = {}
    try:
        with open(path, "r", encoding="utf-8") as fh:
            for raw in fh:
                kv = parse_env_line(raw)
                if kv is None:
                    continue
                parsed[kv[0]] = kv[1]
    except FileNotFoundError:
        return parsed
    for key, value in parsed.items():
        if override or key not in os.environ:
            os.environ[key] = value
    return parsed
