"""Self-signed certificate helper for wire-client TLS tests.

Generates an in-memory RSA key + X.509 cert with SANs for 127.0.0.1 and
localhost so the client's default-verification path (hostname + chain)
exercises for real against the fake server — the reference covers this
surface with dockerized Postgres + sslmode=require (SURVEY §4.2).

Copy of the reference's `etl_tpu/testing/tls.py`.
"""

from __future__ import annotations

import datetime as dt
import ipaddress


def make_self_signed_cert() -> tuple[bytes, bytes]:
    """(cert_pem, key_pem) for CN=etl-fake-pg, SAN 127.0.0.1/localhost."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "etl-fake-pg")])
    now = dt.datetime.now(dt.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - dt.timedelta(minutes=5))
        .not_valid_after(now + dt.timedelta(days=1))
        .add_extension(x509.SubjectAlternativeName([
            x509.IPAddress(ipaddress.IPv4Address("127.0.0.1")),
            x509.DNSName("localhost"),
        ]), critical=False)
        .sign(key, hashes.SHA256())
    )
    cert_pem = cert.public_bytes(serialization.Encoding.PEM)
    key_pem = key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.TraditionalOpenSSL,
        serialization.NoEncryption())
    return cert_pem, key_pem
