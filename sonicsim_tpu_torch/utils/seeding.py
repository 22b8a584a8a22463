"""Process-stable seeding (a copy of the JAX package's ``utils/seeding.py``).

Python's ``hash()`` of str/bytes is randomized per process
(PYTHONHASHSEED), so seeds derived from scene/mixture names with it are
not reproducible across runs. ``stable_seed`` derives them from a keyed
cryptographic digest instead, which keeps generation resume and replay
deterministic.
"""

from __future__ import annotations

import hashlib


def stable_seed(*parts) -> int:
    """Deterministic 31-bit seed from arbitrary repr-able parts."""
    digest = hashlib.blake2s(repr(parts).encode("utf-8")).digest()
    return int.from_bytes(digest[:4], "little") % (2**31)
