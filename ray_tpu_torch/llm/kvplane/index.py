"""Content-stable prefix keys (port of the key half of
ray_tpu/llm/kvplane/index.py).

``stable_hash`` is blake2b over a domain salt and the prefix's tokens as
little-endian int32 bytes, so every process derives the same key for the
same tokens (Python's builtin ``hash()`` is salted per process). The
bytes are identical to ray_tpu's, so the two packages share one key
space: a key minted by either names the same prefix in the other.
"""

from __future__ import annotations

import hashlib

import numpy as np

# domain salt: a kvplane key never collides with another use of blake2b
# over the same token bytes
_SALT = b"rt-kvplane-v1:"
_TOKEN_BYTES = 4  # tokens hash as little-endian int32


def token_bytes(token_ids) -> bytes:
    """Canonical byte encoding of a token sequence (int32 little-endian)."""
    return np.asarray(token_ids, dtype="<i4").tobytes()


def stable_hash(token_ids) -> bytes:
    """Content-stable 128-bit key (blake2b digest) of a token sequence or
    of ``token_bytes`` output. Consumers still verify a hit token for
    token before trusting it."""
    buf = token_ids if isinstance(token_ids, (bytes, bytearray, memoryview)) else token_bytes(token_ids)
    return hashlib.blake2b(_SALT + bytes(buf), digest_size=16).digest()


def prefix_key(buf: bytes, n: int) -> bytes:
    """Key of the first ``n`` tokens of a ``token_bytes`` buffer."""
    return stable_hash(buf[: _TOKEN_BYTES * n])
