"""Token verification for the session auth gate.

The reference verifies a Google id token via ``OAuth2Client.verifyIdToken``
and keys the session on the account email (``wss/func/auth.js:14-19``).
Two verifiers share that ``token -> user id or None`` contract:

* **HS256 shared-secret** (:func:`verify_token`) — offline/dev path, no key
  distribution needed;
* **RS256 + JWKS** (:class:`JwksVerifier`) — the Google id-token shape:
  ``kid`` header → JWKS key lookup, RSASSA-PKCS1-v1_5/SHA-256 signature
  (verified with pure-Python modular exponentiation — the public operation
  needs no crypto library), then ``iss``/``aud``/``exp``/``nbf`` claims.
  The JWKS source is injectable (a dict, or a fetch callable hitting
  ``https://www.googleapis.com/oauth2/v3/certs`` in deployment) so the
  verifier is fully offline-testable against local keypairs.

``SessionRegistry`` consumes either through the same authenticator hook.

A copy of ``imagined_speech_translation_tpu.runtime.auth`` (the port
imports nothing of the JAX package); ``tests/test_torch_runtime.py``
holds the copy to the original.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import hmac
import json
import time
from typing import Awaitable, Callable


def _b64url_decode(part: str) -> bytes:
    pad = "=" * (-len(part) % 4)
    return base64.urlsafe_b64decode(part + pad)


def _b64url_encode(raw: bytes) -> str:
    return base64.urlsafe_b64encode(raw).decode().rstrip("=")


def sign_token(
    claims: dict, secret: str | bytes, *, ttl_s: int | None = 3600
) -> str:
    """Mint an HS256 compact JWT (test/dev helper; the phone app normally
    brings a provider-issued token)."""
    secret = secret.encode() if isinstance(secret, str) else secret
    header = {"alg": "HS256", "typ": "JWT"}
    payload = dict(claims)
    if ttl_s is not None and "exp" not in payload:
        payload["exp"] = int(time.time()) + ttl_s
    signing_input = (
        _b64url_encode(json.dumps(header, separators=(",", ":")).encode())
        + "."
        + _b64url_encode(json.dumps(payload, separators=(",", ":")).encode())
    )
    sig = hmac.new(secret, signing_input.encode(), hashlib.sha256).digest()
    return signing_input + "." + _b64url_encode(sig)


def verify_token(
    token: str, secret: str | bytes, *, audience: str | None = None,
    now: float | None = None,
) -> dict | None:
    """Verify an HS256 compact JWT; returns the claims dict or None.

    Checks: structure, alg pinning (HS256 only — no ``none`` downgrade),
    signature (constant-time), ``exp``/``nbf`` windows, optional ``aud``.
    """
    secret = secret.encode() if isinstance(secret, str) else secret
    parts = token.split(".")
    if len(parts) != 3:
        return None
    try:
        header = json.loads(_b64url_decode(parts[0]))
        payload = json.loads(_b64url_decode(parts[1]))
        sig = _b64url_decode(parts[2])
    except (ValueError, json.JSONDecodeError):
        return None
    if not isinstance(header, dict) or header.get("alg") != "HS256":
        return None
    if not isinstance(payload, dict):
        return None  # validly-signed but non-object claims: reject, not raise
    expected = hmac.new(
        secret, f"{parts[0]}.{parts[1]}".encode(), hashlib.sha256
    ).digest()
    if not hmac.compare_digest(sig, expected):
        return None
    t = time.time() if now is None else now
    try:
        if "exp" in payload and t >= float(payload["exp"]):
            return None
        if "nbf" in payload and t < float(payload["nbf"]):
            return None
    except (TypeError, ValueError):
        return None  # non-numeric exp/nbf: malformed -> reject
    if audience is not None and payload.get("aud") != audience:
        return None
    return payload


# ---------------------------------------------------------------------------
# RS256 / JWKS (the Google id-token path, wss/func/auth.js:14-19)
# ---------------------------------------------------------------------------

# DER-encoded DigestInfo prefix for SHA-256 (RFC 8017 §9.2 note 1)
_SHA256_DIGESTINFO = bytes.fromhex(
    "3031300d060960864801650304020105000420"
)


def _rsassa_pkcs1_v15_sha256_verify(
    n: int, e: int, message: bytes, sig: bytes
) -> bool:
    """RSASSA-PKCS1-v1_5 verification per RFC 8017 §8.2.2.

    The public-key operation is one modular exponentiation; the recovered
    encoding must be exactly ``00 01 FF..FF 00 || DigestInfo || H(m)`` with
    at least 8 bytes of ``FF`` padding (full re-encode comparison — no
    lenient parsing, which is where historic forgery bugs lived)."""
    k = (n.bit_length() + 7) // 8
    if len(sig) != k:
        return False
    s = int.from_bytes(sig, "big")
    if s >= n:
        return False
    em = pow(s, e, n).to_bytes(k, "big")
    h = hashlib.sha256(message).digest()
    t = _SHA256_DIGESTINFO + h
    ps_len = k - len(t) - 3
    if ps_len < 8:
        return False
    expected = b"\x00\x01" + b"\xff" * ps_len + b"\x00" + t
    return hmac.compare_digest(em, expected)


def _jwk_to_rsa(jwk: dict) -> tuple[int, int] | None:
    """(n, e) from an RSA JWK; None if it isn't a usable RS256 key."""
    if jwk.get("kty") != "RSA":
        return None
    if jwk.get("use") not in (None, "sig"):
        return None
    try:
        n = int.from_bytes(_b64url_decode(jwk["n"]), "big")
        e = int.from_bytes(_b64url_decode(jwk["e"]), "big")
    except (KeyError, ValueError):
        return None
    if n <= 0 or e <= 0:
        return None
    return n, e


class JwksVerifier:
    """RS256 id-token verifier against a JWKS key set.

    ``jwks`` is either the key-set dict (``{"keys": [...]}``) or a zero-arg
    callable returning one (called lazily; re-called once on an unknown
    ``kid`` to pick up rotated keys, mirroring how Google rotates its
    signing certs).

    ``verify(token)`` pins ``alg=RS256`` (no ``none``/HS256 downgrade — a
    JWKS ``n`` used as an HMAC secret is the classic confusion attack),
    resolves the header ``kid``, checks the signature and the
    ``iss``/``aud``/``exp``/``nbf`` claims, and returns the claims dict or
    None.
    """

    def __init__(
        self,
        jwks: dict | Callable[[], dict],
        *,
        issuer: str | tuple[str, ...] | None = None,
        audience: str | None = None,
        refresh_min_interval: float = 60.0,
    ):
        self._jwks = jwks
        self._cache: dict[str, tuple[int, int]] | None = None
        # time of the last rotation refetch that STILL missed the kid —
        # an unauthenticated client spraying bogus kids must not turn into
        # one upstream HTTPS fetch per bad token (remote stall /
        # amplification); successful rotations are never throttled
        self._last_miss = float("-inf")
        self.refresh_min_interval = refresh_min_interval
        self.issuer = (issuer,) if isinstance(issuer, str) else issuer
        self.audience = audience

    def _keys(self, *, refresh: bool = False) -> dict[str, tuple[int, int]]:
        if self._cache is None or refresh:
            raw = self._jwks() if callable(self._jwks) else self._jwks
            cache = {}
            for jwk in raw.get("keys", []):
                key = _jwk_to_rsa(jwk)
                if key is not None and "kid" in jwk:
                    cache[jwk["kid"]] = key
            self._cache = cache
        return self._cache

    def verify(self, token: str, *, now: float | None = None) -> dict | None:
        parts = token.split(".")
        if len(parts) != 3:
            return None
        try:
            header = json.loads(_b64url_decode(parts[0]))
            payload = json.loads(_b64url_decode(parts[1]))
            sig = _b64url_decode(parts[2])
        except (ValueError, json.JSONDecodeError):
            return None
        if not isinstance(header, dict) or header.get("alg") != "RS256":
            return None
        if not isinstance(payload, dict):
            return None
        kid = header.get("kid")
        if not isinstance(kid, str):
            return None
        keys = self._keys()
        if kid not in keys and callable(self._jwks):
            # rotated key set — but back off after a refetch that still
            # missed, so bogus-kid spray costs at most one upstream fetch
            # per refresh_min_interval (a real rotation retried after the
            # window verifies normally)
            if (
                time.monotonic() - self._last_miss
                >= self.refresh_min_interval
            ):
                keys = self._keys(refresh=True)
                if kid not in keys:
                    self._last_miss = time.monotonic()
        if kid not in keys:
            return None
        n, e = keys[kid]
        msg = f"{parts[0]}.{parts[1]}".encode()
        if not _rsassa_pkcs1_v15_sha256_verify(n, e, msg, sig):
            return None
        t = time.time() if now is None else now
        try:
            if "exp" not in payload or t >= float(payload["exp"]):
                return None  # id tokens MUST expire
            if "nbf" in payload and t < float(payload["nbf"]):
                return None
            if "iat" in payload:
                float(payload["iat"])
        except (TypeError, ValueError):
            return None
        if self.issuer is not None and payload.get("iss") not in self.issuer:
            return None
        if self.audience is not None:
            aud = payload.get("aud")
            auds = aud if isinstance(aud, list) else [aud]
            if self.audience not in auds:
                return None
        return payload


GOOGLE_JWKS_URL = "https://www.googleapis.com/oauth2/v3/certs"
GOOGLE_ISSUERS = ("https://accounts.google.com", "accounts.google.com")


def make_google_verifier(
    client_id: str,
    fetch_jwks: Callable[[], dict] | None = None,
) -> JwksVerifier:
    """Google id-token verifier (the reference's ``verifyIdToken`` shape):
    RS256 against Google's JWKS, issuer pinned to accounts.google.com,
    audience = the OAuth client id.  ``fetch_jwks`` is injectable; the
    default hits :data:`GOOGLE_JWKS_URL` with urllib."""
    if fetch_jwks is None:
        def fetch_jwks() -> dict:  # pragma: no cover - network path
            import urllib.request

            with urllib.request.urlopen(GOOGLE_JWKS_URL, timeout=30) as r:
                return json.loads(r.read())

    return JwksVerifier(
        fetch_jwks, issuer=GOOGLE_ISSUERS, audience=client_id
    )


def make_token_authenticator(
    secret: str | bytes | None = None,
    *,
    audience: str | None = None,
    verifier: JwksVerifier | None = None,
) -> Callable[[str], Awaitable[str | None]]:
    """Authenticator for ``SessionRegistry``: verified token -> user id
    (``email`` claim first, like the reference, else ``sub``).

    Pass ``secret`` for the HS256 dev path or ``verifier`` for RS256/JWKS
    (exactly one)."""
    if (secret is None) == (verifier is None):
        raise ValueError("pass exactly one of secret= or verifier=")

    async def authenticate(token: str) -> str | None:
        if verifier is not None:
            # verify() may fetch/rotate JWKS over HTTPS (and does RSA math);
            # keep the event loop free — a cold cache or slow upstream must
            # not stall every other websocket session
            claims = await asyncio.to_thread(verifier.verify, token)
        else:
            claims = verify_token(token, secret, audience=audience)
        if claims is None:
            return None
        return claims.get("email") or claims.get("sub")

    return authenticate
