"""Timestamps in the reference's format.

The reference prints America/Sao_Paulo wall-clock timestamps around every job
phase via pytz (reference: machine-learning/main.py:414-418). pytz is not in
this image; stdlib ``zoneinfo`` provides the same zone. A fixed UTC-3 fallback
covers environments without tzdata (Brazil abolished DST in 2019, so the
offset is constant for current dates).
"""

from __future__ import annotations

import datetime

try:
    from zoneinfo import ZoneInfo

    _SAO_PAULO: datetime.tzinfo = ZoneInfo("America/Sao_Paulo")
except Exception:  # pragma: no cover - tzdata missing
    _SAO_PAULO = datetime.timezone(datetime.timedelta(hours=-3), name="-03")

TIME_FORMAT = "%Y-%m-%d %H:%M:%S"


def now_sao_paulo() -> datetime.datetime:
    return datetime.datetime.now(_SAO_PAULO)


def get_current_time_str() -> str:
    """Equivalent of the reference's ``get_current_time_str`` (main.py:414-418)."""
    return now_sao_paulo().strftime(TIME_FORMAT)


def get_current_time_str_precise() -> str:
    """Microsecond-resolution variant used for the invalidation token: two
    mining runs inside the same wall-clock second must still produce distinct
    tokens, or the API's content-comparison staleness check
    (reference: rest_api/app/main.py:82-97) would miss the second reload."""
    return now_sao_paulo().strftime(TIME_FORMAT + ".%f")
