"""Profiling database: reusable, shareable op-level measurements.

Schema (JSON on disk):

    {
      "version": 1,
      "platforms": {
        "<platform>": {
          "meta": {"library": "jax-0.8.2", ...calibration constants...},
          "ops": {
            "<op_family>": [
               {"args": {"m":128,"k":256,...}, "flops":..., "bytes":...,
                "mean_s":..., "std_s":..., "n": 20},
               ...
            ]
          }
        }
      }
    }

The paper's "different users can easily contribute their profiling results on
their hardware platforms" maps to :meth:`ProfileDB.merge` — measurement lists
are unioned per (platform, op, args) with the higher-sample entry winning.
"""
from __future__ import annotations

import json
import os
import tempfile
import zlib
from dataclasses import dataclass
from typing import Optional


def _canon_value(v):
    """Canonicalize one args value so keys survive producer round-trips.

    numpy scalars (what a sweep harness naturally produces) become native
    Python, and integral floats become ints (a JSON writer elsewhere may
    serialize ``1024.0``) — so ``{"per_device_bytes": np.int64(4096)}``
    and the reloaded ``{"per_device_bytes": 4096}`` key identically.
    """
    if hasattr(v, "item"):
        v = v.item()
    if isinstance(v, float) and v.is_integer():
        return int(v)
    return v


def _args_key(args: dict) -> tuple:
    return tuple(sorted((str(k), _canon_value(v)) for k, v in args.items()))


def args_digest(args: dict) -> int:
    """Stable 31-bit digest of an args dict.

    crc32 over the canonical key repr — identical across processes and
    hash salts (the same guarantee the estimator's fit seeding relies on;
    Python's ``hash()`` is salted per process and must never key anything
    that two processes compare)."""
    return zlib.crc32(repr(_args_key(args)).encode("utf-8")) % 2**31


@dataclass
class ProfileEntry:
    args: dict
    mean_s: float
    std_s: float
    n: int = 1
    flops: float = 0.0
    bytes: float = 0.0

    def to_json(self) -> dict:
        return {
            "args": self.args,
            "mean_s": self.mean_s,
            "std_s": self.std_s,
            "n": self.n,
            "flops": self.flops,
            "bytes": self.bytes,
        }

    @staticmethod
    def from_json(d: dict) -> "ProfileEntry":
        return ProfileEntry(
            args=dict(d["args"]),
            mean_s=float(d["mean_s"]),
            std_s=float(d.get("std_s", 0.0)),
            n=int(d.get("n", 1)),
            flops=float(d.get("flops", 0.0)),
            bytes=float(d.get("bytes", 0.0)),
        )


class ProfileDB:
    def __init__(self):
        self._data: dict[str, dict] = {}  # platform -> {"meta":…, "ops": {...}}

    # -- access ---------------------------------------------------------------

    def platform(self, name: str) -> dict:
        return self._data.setdefault(name, {"meta": {}, "ops": {}})

    def meta(self, platform: str) -> dict:
        return self.platform(platform)["meta"]

    def add(self, platform: str, op: str, entry: ProfileEntry) -> None:
        ops = self.platform(platform)["ops"]
        entries = ops.setdefault(op, [])
        key = _args_key(entry.args)
        for i, e in enumerate(entries):
            if _args_key(e.args) == key:
                if entry.n >= e.n:
                    entries[i] = entry
                return
        entries.append(entry)

    def lookup(self, platform: str, op: str, args: dict) -> Optional[ProfileEntry]:
        entries = self.platform(platform)["ops"].get(op, [])
        key = _args_key(args)
        for e in entries:
            if _args_key(e.args) == key:
                return e
        return None

    def entries(self, platform: str, op: str) -> list[ProfileEntry]:
        return list(self.platform(platform)["ops"].get(op, []))

    def op_families(self, platform: str) -> list[str]:
        return sorted(self.platform(platform)["ops"])

    def platforms(self) -> list[str]:
        return sorted(self._data)

    def merge(self, other: "ProfileDB") -> None:
        """Union another user's contributed measurements into this DB.

        Conflict policy (asserted in tests/test_estimator_db.py): two
        entries with the same canonical ``_args_key`` keep the one with the
        higher sample count ``n``; on a tie the incoming entry wins (the
        contributor re-measured — prefer fresh)."""
        for plat, pdata in other._data.items():
            self.meta(plat).update(pdata.get("meta", {}))
            for op, entries in pdata.get("ops", {}).items():
                for e in entries:
                    self.add(plat, op, e)

    def __len__(self) -> int:
        return sum(
            len(es)
            for p in self._data.values()
            for es in p.get("ops", {}).values()
        )

    # -- persistence ------------------------------------------------------------

    def to_json(self) -> dict:
        return {
            "version": 1,
            "platforms": {
                p: {
                    "meta": d.get("meta", {}),
                    "ops": {
                        op: [e.to_json() for e in es]
                        for op, es in d.get("ops", {}).items()
                    },
                }
                for p, d in self._data.items()
            },
        }

    def save(self, path: str) -> None:
        """Atomic write (tmp + rename) so readers never see a torn file."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(os.path.abspath(path)), suffix=".tmp"
        )
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.to_json(), f)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    @staticmethod
    def load(path: str) -> "ProfileDB":
        db = ProfileDB()
        with open(path) as f:
            raw = json.load(f)
        for plat, pdata in raw.get("platforms", {}).items():
            db.meta(plat).update(pdata.get("meta", {}))
            for op, entries in pdata.get("ops", {}).items():
                for e in entries:
                    db.add(plat, op, ProfileEntry.from_json(e))
        return db

    @staticmethod
    def load_or_empty(path: str) -> "ProfileDB":
        if path and os.path.exists(path):
            return ProfileDB.load(path)
        return ProfileDB()
