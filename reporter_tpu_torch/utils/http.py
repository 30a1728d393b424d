"""HTTP egress with retries + legacy AWS v2 S3 signing, stdlib only.

The port of ``reporter_tpu/utils/http.py``, itself the equivalent of the
reference's HttpClient (HttpClient.java): POST/PUT with 3 attempts and a
10 s socket timeout (HttpClient.java:80-88), errors swallowed and logged
with None returned (:95-98), and hand-rolled HMAC-SHA1 "AWS
key:signature" authorization for S3 PUTs (:34-58) so tile egress needs
no AWS SDK.

Retries sleep on a capped exponential schedule, and a ``Retry-After``
header on 429/503 overrides it. See :func:`retry_delay` /
:func:`parse_retry_after`.

One departure from the JAX package: :func:`egress_tile` takes the S3
credentials as an argument (``credentials=(key, secret)``, passed down
from ``TileSink(..., credentials=)``) instead of reading
``AWS_ACCESS_KEY_ID``/``AWS_SECRET_ACCESS_KEY``: the port reads no
environment. boto3, when installed, still reads its own credential
chain. Without boto3 and without credentials a bucket egress fails
closed.
"""
from __future__ import annotations

import base64
import email.utils
import hashlib
import hmac
import logging
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Mapping, Optional, Tuple

logger = logging.getLogger("reporter_tpu_torch.http")

ATTEMPTS = 3           # reference: HttpClient.java:88
CONNECT_TIMEOUT = 1.0  # reference: HttpClient.java:81
SOCKET_TIMEOUT = 10.0  # reference: HttpClient.java:83

# retry schedule: exponential backoff with a cap
BACKOFF_BASE_S = 0.5   # first retry delay; doubles each attempt
BACKOFF_CAP_S = 30.0
RETRY_AFTER_CAP_S = 60.0  # never trust a server to park us for longer


def parse_retry_after(value: Optional[str],
                      now: Optional[float] = None) -> Optional[float]:
    """Parse a ``Retry-After`` header: delta-seconds or an HTTP-date
    (RFC 9110 §10.2.3). Returns seconds to wait, or None if absent or
    unparseable. ``now`` overrides the clock (tests)."""
    if value is None:
        return None
    value = value.strip()
    try:
        return max(0.0, float(value))
    except ValueError:
        pass
    try:
        when = email.utils.parsedate_to_datetime(value)
    except (TypeError, ValueError):
        return None
    if when is None:
        return None
    now = time.time() if now is None else now
    return max(0.0, when.timestamp() - now)


def retry_delay(attempt: int,
                retry_after: Optional[float] = None) -> float:
    """Seconds to sleep before retry number ``attempt`` (0-based): the
    server's ``Retry-After`` when present (capped at
    ``RETRY_AFTER_CAP_S``), else exponential backoff from
    ``BACKOFF_BASE_S`` capped at ``BACKOFF_CAP_S``."""
    if retry_after is not None:
        return min(retry_after, RETRY_AFTER_CAP_S)
    return min(BACKOFF_BASE_S * (2.0 ** attempt), BACKOFF_CAP_S)


def aws_signature(sign_me: str, secret: str) -> str:
    """Base64(HMAC-SHA1(secret, sign_me)) (reference: HttpClient.java:34-40)."""
    mac = hmac.new(secret.encode(), sign_me.encode(), hashlib.sha1)
    return base64.b64encode(mac.digest()).decode()


def _do(method: str, url: str, body: bytes,
        headers: Mapping[str, str]) -> Optional[str]:
    """Issue the request with up to ATTEMPTS tries; swallow-and-log failure
    (reference: HttpClient.java:74-103). Returns the response body or None."""
    last = None
    for attempt in range(ATTEMPTS):
        retry_after = None
        try:
            req = urllib.request.Request(url, data=body, method=method,
                                         headers=dict(headers))
            # urllib has one deadline knob; the socket timeout bounds the
            # connect phase too
            with urllib.request.urlopen(req, timeout=SOCKET_TIMEOUT) as resp:
                return resp.read().decode()
        except urllib.error.HTTPError as e:
            # the server answered; 4xx (except throttling) won't improve
            # on retry. 429/503 may carry Retry-After: honour it
            last = e
            try:
                e.read()
            except Exception:
                pass
            if e.code < 500 and e.code != 429:
                break
            if e.code in (429, 503):
                retry_after = parse_retry_after(
                    e.headers.get("Retry-After") if e.headers else None)
        except Exception as e:
            last = e
        if attempt + 1 < ATTEMPTS:
            time.sleep(retry_delay(attempt, retry_after))
    logger.error("After %d attempts couldn't %s to %s -> %s",
                 ATTEMPTS, method, url, last)
    return None


def post(url: str, body: str,
         content_type: str = "text/plain;charset=utf-8",
         headers: Optional[Mapping[str, str]] = None) -> Optional[str]:
    h = {"Content-Type": content_type}
    h.update(headers or {})
    return _do("POST", url, body.encode(), h)


def put(url: str, body: str,
        content_type: str = "text/plain;charset=utf-8",
        headers: Optional[Mapping[str, str]] = None) -> Optional[str]:
    h = {"Content-Type": content_type}
    h.update(headers or {})
    return _do("PUT", url, body.encode(), h)


def aws_put(url: str, location: str, body: str, key: str, secret: str,
            content_type: str = "text/plain;charset=utf-8",
            date: Optional[str] = None) -> Optional[str]:
    """Signed S3 PUT of ``body`` to ``{url}/{location}``.

    ``url`` is a virtual-hosted bucket endpoint like
    ``https://bucket.s3.amazonaws.com`` with an optional key prefix path;
    the bucket is the first label of the host and the canonical resource
    is ``/bucket/<prefix>/<location>`` (reference: HttpClient.java:44-58).
    ``date`` overrides the RFC-1123 GMT timestamp (tests only).
    """
    parsed = urllib.parse.urlsplit(url)
    host = parsed.netloc
    bucket = (parsed.hostname or "").split(".")[0]
    prefix = parsed.path.strip("/")
    full_key = f"{prefix}/{location}" if prefix else location
    if date is None:
        date = email.utils.formatdate(usegmt=True)
    resource = f"/{bucket}/{full_key}"
    sign_me = f"PUT\n\n{content_type}\n{date}\n{resource}"
    headers = {
        "Host": host,
        "Date": date,
        "Authorization": f"AWS {key}:{aws_signature(sign_me, secret)}",
    }
    return put(f"{parsed.scheme}://{host}/{full_key}", body,
               content_type=content_type, headers=headers)


def is_aws_host(dest: str) -> bool:
    host = urllib.parse.urlsplit(dest).hostname or ""
    return host == "amazonaws.com" or host.endswith(".amazonaws.com")


def egress_tile(dest: str, key_path: str, payload: str,
                credentials: Optional[Tuple[str, str]] = None) -> bool:
    """Tile egress routing (reference: AnonymisingProcessor.java:177-220):
    an AWS bucket endpoint goes through boto3 when installed (SigV4, its
    own credential chain), else a hand-rolled legacy-signed PUT with
    ``credentials`` (access key, secret), failing closed without them;
    any other http(s) endpoint gets a plain POST. Returns success."""
    if is_aws_host(dest):
        parsed = urllib.parse.urlsplit(dest)
        bucket = (parsed.hostname or "").split(".")[0]
        prefix = parsed.path.strip("/")
        key = f"{prefix}/{key_path}" if prefix else key_path
        try:
            import boto3  # gated: not in every deployment
        except ImportError:
            boto3 = None
        if boto3 is not None:
            try:
                boto3.client("s3").put_object(Bucket=bucket, Key=key,
                                              Body=payload.encode())
                return True
            except Exception as e:
                logger.error("boto3 put_object to %s/%s failed: %s",
                             bucket, key, e)
                return False
        access, secret = credentials or (None, None)
        if not access or not secret:
            logger.error("bucket destination %s needs boto3 or "
                         "credentials=(access key, secret)", dest)
            return False
        return aws_put(dest, key_path, payload, access, secret) is not None
    return post(dest.rstrip("/") + "/" + key_path, payload) is not None
