"""Per-IP connection rate limiting.

Capability match for the reference's ``ConnectionMonitor`` (p2p/monitor.py:
sliding-minute attempt counter, 600 s block after 5 attempts/min,
smart_node.py:247-250).
"""

from __future__ import annotations

import time
from collections import deque


class RateLimiter:
    def __init__(self, max_per_minute: int = 5, block_s: float = 600.0):
        self.max_per_minute = max_per_minute
        self.block_s = block_s
        self._attempts: dict[str, deque[float]] = {}
        self._blocked_until: dict[str, float] = {}

    def allow(self, ip: str) -> bool:
        """Record an attempt from ``ip``; False if it is rate-limited."""
        now = time.monotonic()
        self._gc(now)
        until = self._blocked_until.get(ip)
        if until is not None:
            if now < until:
                return False
            del self._blocked_until[ip]
        dq = self._attempts.setdefault(ip, deque())
        while dq and now - dq[0] > 60.0:
            dq.popleft()
        dq.append(now)
        if len(dq) > self.max_per_minute:
            self._blocked_until[ip] = now + self.block_s
            return False
        return True

    def _gc(self, now: float) -> None:
        """Drop idle IPs so the tables don't grow with unique source count
        for the process lifetime."""
        stale = [
            ip for ip, dq in self._attempts.items() if not dq or now - dq[-1] > 120.0
        ]
        for ip in stale:
            del self._attempts[ip]
        expired = [ip for ip, t in self._blocked_until.items() if now >= t]
        for ip in expired:
            del self._blocked_until[ip]

    def is_blocked(self, ip: str) -> bool:
        until = self._blocked_until.get(ip)
        return until is not None and time.monotonic() < until

    def unblock(self, ip: str) -> None:
        self._blocked_until.pop(ip, None)
        self._attempts.pop(ip, None)


__all__ = ["RateLimiter"]
