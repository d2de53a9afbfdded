"""Minimal 5-field cron schedule parser for the CronJob controller.

The counterpart of `kubernetes_tpu/utils/cron.py`, stdlib only: the same
parsing and the same next fire times.

reference: the cronjob controller depends on robfig/cron
(pkg/controller/cronjob/utils.go); this covers the standard syntax that
controller accepts: *, */step, lists, ranges, and the @hourly-style macros.
"""

from __future__ import annotations

from datetime import datetime, timedelta, timezone
from typing import Set, Tuple

_MACROS = {
    "@yearly": "0 0 1 1 *",
    "@annually": "0 0 1 1 *",
    "@monthly": "0 0 1 * *",
    "@weekly": "0 0 * * 0",
    "@daily": "0 0 * * *",
    "@midnight": "0 0 * * *",
    "@hourly": "0 * * * *",
}

_BOUNDS = ((0, 59), (0, 23), (1, 31), (1, 12), (0, 7))  # dow 7 = Sunday alias


def _parse_field(field: str, lo: int, hi: int) -> Set[int]:
    out: Set[int] = set()
    for part in field.split(","):
        step = 1
        has_step = "/" in part
        if has_step:
            part, step_s = part.split("/", 1)
            step = int(step_s)
            if step <= 0:
                raise ValueError(f"invalid step {step}")
        if part in ("*", ""):
            start, end = lo, hi
        elif "-" in part:
            a, b = part.split("-", 1)
            start, end = int(a), int(b)
        else:
            start = end = int(part)
            if has_step:
                # robfig/cron: N/step means the range N..hi stepped (for any
                # step value, including 1), not just {N}
                end = hi
        if not (lo <= start <= hi and lo <= end <= hi and start <= end):
            raise ValueError(f"field value out of range: {part!r} not in [{lo},{hi}]")
        out.update(range(start, end + 1, step))
    return out


class CronSchedule:
    def __init__(self, expr: str, tz: str = ""):
        expr = expr.strip()
        expr = _MACROS.get(expr, expr)
        fields = expr.split()
        if len(fields) != 5:
            raise ValueError(f"cron expression needs 5 fields, got {expr!r}")
        self.tz = timezone.utc
        if tz:
            # IANA zone (CronJob spec.timeZone; cronjob_controllerv2.go uses
            # time.LoadLocation) — schedule fields are evaluated in this zone
            from zoneinfo import ZoneInfo

            try:
                self.tz = ZoneInfo(tz)
            except Exception as e:
                raise ValueError(f"unknown timeZone {tz!r}") from e
        self.minutes, self.hours, self.dom, self.months, self.dow = (
            _parse_field(f, lo, hi) for f, (lo, hi) in zip(fields, _BOUNDS))
        if 7 in self.dow:  # 7 is an alias for Sunday (robfig/cron)
            self.dow = (self.dow - {7}) | {0}
        # day-of-month/day-of-week OR semantics when both are restricted
        self._dom_star = fields[2] == "*"
        self._dow_star = fields[4] == "*"

    def _day_matches(self, dt: datetime) -> bool:
        dom_ok = dt.day in self.dom
        dow_ok = dt.weekday() in self._to_cron_dow()
        if self._dom_star and self._dow_star:
            return True
        if self._dom_star:
            return dow_ok
        if self._dow_star:
            return dom_ok
        return dom_ok or dow_ok

    def _to_cron_dow(self) -> Set[int]:
        # cron: 0=Sunday; python weekday(): 0=Monday
        return {(d - 1) % 7 for d in self.dow}

    def matches(self, ts: float) -> bool:
        dt = datetime.fromtimestamp(ts, tz=self.tz)
        return (dt.minute in self.minutes and dt.hour in self.hours
                and dt.month in self.months and self._day_matches(dt))

    def next_after(self, ts: float, horizon_days: int = 366) -> float:
        """First scheduled time strictly after ts (cron.Next).

        The cursor advances in UTC — timedelta arithmetic on a zoned datetime
        silently drops the DST fold and can step BACKWARDS across fall-back
        (violating "strictly after"); only field matching happens in the
        schedule's zone. Spring-forward times that don't exist locally are
        skipped (the wall clock never shows them); during fall-back the
        repeated local hour can fire on both passes.
        """
        cur = datetime.fromtimestamp(ts, tz=timezone.utc)
        cur = cur.replace(second=0, microsecond=0) + timedelta(minutes=1)
        end = cur + timedelta(days=horizon_days)
        while cur < end:
            local = cur.astimezone(self.tz)
            if (local.month not in self.months
                    or not self._day_matches(local)
                    or local.hour not in self.hours):
                # jump to the next LOCAL hour start: offsets are whole
                # minutes, so adding (60 - local.minute) lands on :00
                cur += timedelta(minutes=60 - local.minute)
                continue
            if local.minute in self.minutes:
                return cur.timestamp()
            cur += timedelta(minutes=1)
        raise ValueError("no cron occurrence within horizon")

    def times_between(self, start: float, end: float) -> Tuple[float, ...]:
        """All scheduled times in (start, end] (getRecentUnmetScheduleTimes)."""
        out = []
        t = start
        while True:
            t = self.next_after(t)
            if t > end:
                break
            out.append(t)
            if len(out) > 1000:  # runaway guard (cronjob_controllerv2.go:100s cap)
                break
        return tuple(out)
