"""End-to-end chunk encryption (AES-256-GCM).

Reference parity: NaCl SecretBox E2EE with a client-generated key distributed
over SSH (skyplane/api/dataplane.py:206, gateway_operator.py:362-364,
gateway_receiver.py:191-195). This implementation uses AES-GCM from the
``cryptography`` package (hardware-accelerated on gateway VMs) with a random
96-bit nonce prepended to each sealed payload.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

from skyplane_tpu_torch.exceptions import SkyplaneTpuException

NONCE_BYTES = 12
KEY_BYTES = 32


def generate_key() -> bytes:
    return os.urandom(KEY_BYTES)


class ChunkCipher:
    def __init__(self, key: bytes):
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM

        if len(key) != KEY_BYTES:
            raise SkyplaneTpuException(f"E2EE key must be {KEY_BYTES} bytes, got {len(key)}")
        self._aead = AESGCM(key)

    def seal(self, plaintext: bytes) -> bytes:
        nonce = os.urandom(NONCE_BYTES)
        return nonce + self._aead.encrypt(nonce, plaintext, None)

    def open(self, sealed: bytes) -> bytes:
        from cryptography.exceptions import InvalidTag

        if len(sealed) < NONCE_BYTES + 16:
            raise SkyplaneTpuException("sealed payload too short")
        try:
            return self._aead.decrypt(sealed[:NONCE_BYTES], sealed[NONCE_BYTES:], None)
        except InvalidTag as e:
            raise SkyplaneTpuException("E2EE authentication failed (wrong key or corrupted payload)") from e


def load_key_file(path) -> Optional[bytes]:
    p = Path(path)
    if not p.exists():
        return None
    key = p.read_bytes()
    if len(key) != KEY_BYTES:
        raise SkyplaneTpuException(f"E2EE key file {p} has wrong length {len(key)}")
    return key
