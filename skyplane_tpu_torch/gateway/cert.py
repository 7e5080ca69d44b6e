"""Self-signed TLS certificate generation for receiver sockets.

Reference parity: skyplane/gateway/cert.py:5-21 (RSA-4096 via pyOpenSSL).
Uses the ``cryptography`` package; EC P-256 keys (faster handshakes than
RSA-4096 at equivalent security — the cert is only a channel cipher bootstrap,
identity comes from the control plane).
"""

from __future__ import annotations

import datetime
from pathlib import Path
from typing import Tuple


def generate_self_signed_certificate(common_name: str, cert_path, key_path) -> Tuple[Path, Path]:
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=7))
        .sign(key, hashes.SHA256())
    )
    cert_path, key_path = Path(cert_path), Path(key_path)
    cert_path.parent.mkdir(parents=True, exist_ok=True)
    cert_path.write_bytes(cert.public_bytes(serialization.Encoding.PEM))
    key_path.write_bytes(
        key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption(),
        )
    )
    return cert_path, key_path
