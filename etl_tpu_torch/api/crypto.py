"""Config encryption at rest.

Reference parity: etl-api encrypted source/destination configs
(crates/etl-api/src/configs/encryption.rs) — AES-256-GCM with random
nonces, key from configuration, plus key-id tagging so keys can rotate
(the reference ships an encryption-key rotation xtask).

When the `cryptography` package is not installed (minimal CI images),
the cipher degrades to a pure-stdlib authenticated scheme with the SAME
interface and envelope shape: SHA-256 counter-mode keystream +
truncated HMAC-SHA-256 tag (encrypt-then-MAC, constant-time compare).
Envelopes are self-consistent within one backend — a deployment must
not mix backends over the same database, so which backend is live is
exported as `CIPHER_BACKEND` and logged by the API at startup."""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
from dataclasses import dataclass

from ..models.errors import ErrorKind, EtlError

try:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM

    CIPHER_BACKEND = "aes-256-gcm"
except ImportError:  # minimal image: stdlib fallback, same interface
    class AESGCM:  # type: ignore[no-redef]
        """Drop-in stand-in for cryptography's AESGCM: SHA-256-CTR
        keystream XOR + 16-byte HMAC-SHA-256 tag appended to the
        ciphertext (the same ct||tag layout AES-GCM emits), so the
        envelope format and every call site stay identical."""

        _TAG_LEN = 16

        def __init__(self, key: bytes):
            if len(key) != 32:
                raise ValueError("key must be 32 bytes")
            self._key = key

        @staticmethod
        def generate_key(bit_length: int) -> bytes:
            if bit_length != 256:
                raise ValueError("only 256-bit keys are supported")
            return os.urandom(32)

        def _keystream(self, nonce: bytes, n: int) -> bytes:
            out = bytearray()
            counter = 0
            while len(out) < n:
                out += hashlib.sha256(
                    b"etl-ks|" + self._key + b"|" + nonce + b"|"
                    + counter.to_bytes(8, "big")).digest()
                counter += 1
            return bytes(out[:n])

        def _tag(self, nonce: bytes, ct: bytes,
                 aad: "bytes | None") -> bytes:
            return hmac.new(
                self._key,
                b"etl-tag|" + nonce + b"|" + (aad or b"") + b"|" + ct,
                hashlib.sha256).digest()[:self._TAG_LEN]

        def encrypt(self, nonce: bytes, data: bytes,
                    aad: "bytes | None") -> bytes:
            ct = bytes(a ^ b for a, b in
                       zip(data, self._keystream(nonce, len(data))))
            return ct + self._tag(nonce, ct, aad)

        def decrypt(self, nonce: bytes, data: bytes,
                    aad: "bytes | None") -> bytes:
            if len(data) < self._TAG_LEN:
                raise ValueError("ciphertext too short")
            ct, tag = data[:-self._TAG_LEN], data[-self._TAG_LEN:]
            if not hmac.compare_digest(tag, self._tag(nonce, ct, aad)):
                raise ValueError("authentication tag mismatch")
            return bytes(a ^ b for a, b in
                         zip(ct, self._keystream(nonce, len(ct))))

    CIPHER_BACKEND = "stdlib-hmac-ctr"

    import logging

    # loud by design: a production image missing the `cryptography`
    # wheel silently changing the at-rest cipher would be a security
    # posture change nobody asked for — and envelopes written by the
    # two backends are mutually undecryptable, so adding the wheel
    # later strands every stored config. CI/test images are the
    # intended audience of this fallback.
    logging.getLogger("etl_tpu_torch.api.crypto").warning(
        "cryptography not installed: config encryption degraded to the "
        "stdlib HMAC-CTR fallback (CIPHER_BACKEND=%s); envelopes are "
        "NOT interchangeable with the AES-256-GCM backend — install "
        "`cryptography` for production deployments", CIPHER_BACKEND)


@dataclass(frozen=True)
class EncryptionKey:
    key_id: int
    key: bytes  # 32 bytes

    @classmethod
    def generate(cls, key_id: int = 0) -> "EncryptionKey":
        return cls(key_id, AESGCM.generate_key(256))

    @classmethod
    def from_base64(cls, key_id: int, b64: str) -> "EncryptionKey":
        raw = base64.b64decode(b64)
        if len(raw) != 32:
            raise EtlError(ErrorKind.CONFIG_INVALID,
                           "encryption key must be 32 bytes")
        return cls(key_id, raw)


class ConfigCipher:
    """Encrypt/decrypt JSON config documents; supports multiple keys for
    rotation (encrypt with the primary, decrypt with any known key)."""

    def __init__(self, primary: EncryptionKey,
                 others: list[EncryptionKey] | None = None):
        self._keys = {primary.key_id: primary}
        for k in others or []:
            self._keys[k.key_id] = k
        self._primary = primary

    def encrypt(self, doc: dict) -> str:
        nonce = os.urandom(12)
        ct = AESGCM(self._primary.key).encrypt(
            nonce, json.dumps(doc).encode(), None)
        envelope = {
            "key_id": self._primary.key_id,
            "nonce": base64.b64encode(nonce).decode(),
            "ciphertext": base64.b64encode(ct).decode(),
        }
        return json.dumps(envelope)

    def decrypt(self, raw: str) -> dict:
        try:
            env = json.loads(raw)
            key = self._keys.get(env["key_id"])
            if key is None:
                raise EtlError(ErrorKind.CONFIG_INVALID,
                               f"unknown encryption key id {env['key_id']}")
            pt = AESGCM(key.key).decrypt(
                base64.b64decode(env["nonce"]),
                base64.b64decode(env["ciphertext"]), None)
            return json.loads(pt)
        except EtlError:
            raise
        except Exception as e:
            raise EtlError(ErrorKind.CONFIG_INVALID,
                           f"config decryption failed: {type(e).__name__}")

    def rotate(self, raw: str) -> str:
        """Re-encrypt an envelope under the primary key (xtask parity)."""
        return self.encrypt(self.decrypt(raw))
