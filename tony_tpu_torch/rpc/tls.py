"""Per-job TLS for the control-plane RPC — the transport-security half of
the reference's ClientToAM story.

The PyTorch port's copy of ``tony_tpu/rpc/tls.py``.

Reference: ApplicationMaster.java:484-504 builds a ClientToAMTokenSecret-
Manager and hands Hadoop RPC a SASL-wrapped transport;
security/TokenCache.java:22-78 distributes the credentials. The rebuild's
HMAC frames (wire.py) already carry the integrity half; this module adds
confidentiality: the CLIENT mints a self-signed per-job certificate into
the job dir at staging time (openssl subprocess — stdlib-only code), the
coordinator serves TLS with it, and every peer (client, agents) verifies
the certificate by SHA-256 fingerprint carried in the job's env — no CA,
no hostname checks, exactly one key pair per job, dead with the job dir.
"""

from __future__ import annotations

import base64
import hashlib
import logging
import os
import subprocess

log = logging.getLogger(__name__)

CERT_FILE = "tls-cert.pem"
KEY_FILE = "tls-key.pem"


class TlsError(RuntimeError):
    pass


def mint_self_signed(job_dir: str, cn: str) -> tuple[str, str]:
    """Write <job_dir>/tls-cert.pem + tls-key.pem (idempotent); returns
    their paths. RSA-2048, 7-day validity — a job outliving that has
    bigger problems."""
    cert = os.path.join(job_dir, CERT_FILE)
    key = os.path.join(job_dir, KEY_FILE)
    if os.path.exists(cert) and os.path.exists(key):
        return cert, key
    os.makedirs(job_dir, exist_ok=True)
    try:
        subprocess.run(
            ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
             "-keyout", key, "-out", cert, "-days", "7",
             "-subj", f"/CN={cn}"],
            check=True, capture_output=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        raise TlsError(
            f"could not mint the per-job TLS cert (is openssl installed?): "
            f"{e} {detail.decode(errors='replace')[-200:]}") from e
    os.chmod(key, 0o600)
    return cert, key


def cert_fingerprint(cert_path: str) -> str:
    """SHA-256 over the DER certificate — what peers pin (env-carried)."""
    with open(cert_path, "rb") as f:
        pem = f.read()
    try:
        body = pem.split(b"-----BEGIN CERTIFICATE-----")[1] \
            .split(b"-----END CERTIFICATE-----")[0]
        der = base64.b64decode(b"".join(body.split()))
    except (IndexError, ValueError) as e:
        raise TlsError(f"unparseable certificate {cert_path}: {e}") from e
    return hashlib.sha256(der).hexdigest()


def server_context(cert_path: str, key_path: str):
    import ssl

    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert_path, key_path)
    return ctx


def client_wrap(sock, fingerprint: str):
    """Wrap + pin: self-signed means no chain to verify — the pinned
    fingerprint IS the trust anchor, so CERT_NONE here is not 'insecure',
    it just moves verification to the explicit digest compare."""
    import ssl

    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    import hmac

    wrapped = ctx.wrap_socket(sock)
    der = wrapped.getpeercert(binary_form=True)
    got = hashlib.sha256(der or b"").hexdigest()
    if not der or not hmac.compare_digest(got, fingerprint):
        wrapped.close()
        raise ConnectionError(
            f"TLS certificate fingerprint mismatch (got {got[:16]}..., "
            f"pinned {fingerprint[:16]}...) — wrong or impostor coordinator")
    return wrapped
