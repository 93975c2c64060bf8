"""Calendar date record matching the reference Date class (date.h/.cpp).

Parses "YYYY-MM-DD..." prefixes (e.g. "2010-03-24T03:10:22Z"), compares by
(year, month, day), serializes as three uint32 values (day, month, year),
and renders as ``year-month-day`` without zero padding (date.cpp:5-10).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Date:
    day: int = 0
    month: int = 0
    year: int = 0

    @classmethod
    def parse(cls, s: str) -> "Date":
        if len(s) < 10:
            raise ValueError(f"malformed date string: {s!r}")
        if (
            not s[0:4].isdigit()
            or s[4] != "-"
            or not s[5:7].isdigit()
            or s[7] != "-"
            or not s[8:10].isdigit()
        ):
            raise ValueError(f"malformed date string: {s!r}")
        return cls(day=int(s[8:10]), month=int(s[5:7]), year=int(s[0:4]))

    @property
    def is_valid(self) -> bool:
        return self.year != 0 and self.month != 0 and self.day != 0

    def _key(self) -> tuple[int, int, int]:
        return (self.year, self.month, self.day)

    def __lt__(self, other: "Date") -> bool:
        return self._key() < other._key()

    def __le__(self, other: "Date") -> bool:
        return self._key() <= other._key()

    def __gt__(self, other: "Date") -> bool:
        return self._key() > other._key()

    def __ge__(self, other: "Date") -> bool:
        return self._key() >= other._key()

    def __str__(self) -> str:
        return f"{self.year}-{self.month}-{self.day}"
