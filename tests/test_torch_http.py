"""The port's HTTP egress (``reporter_tpu_torch/utils/http.py``) against
the JAX package's: retries, swallow-and-log, the backoff schedule and
the AWS v2 signature, each case of the JAX package's
``tests/test_http.py``; signatures and canonical headers compared with
the JAX package's on the same inputs. One deliberate divergence: the
S3 credentials are an argument (``egress_tile(credentials=)``,
``TileSink(credentials=)``), never the environment."""
import base64
import hashlib
import hmac
import http.server
import threading

import pytest

from reporter_tpu.utils import http as jax_http
from reporter_tpu_torch.utils import http as rhttp


@pytest.fixture
def server():
    """Local HTTP server recording requests; scriptable status codes."""
    state = {"requests": [], "codes": [], "headers": []}

    class Handler(http.server.BaseHTTPRequestHandler):
        def _handle(self):
            length = int(self.headers.get("Content-Length", 0))
            state["requests"].append({
                "method": self.command,
                "path": self.path,
                "headers": dict(self.headers),
                "body": self.rfile.read(length).decode(),
            })
            code = state["codes"].pop(0) if state["codes"] else 200
            extra = state["headers"].pop(0) if state["headers"] else {}
            self.send_response(code)
            body = b"ok" if code == 200 else b"err"
            self.send_header("Content-Length", str(len(body)))
            for k, v in extra.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        do_POST = do_PUT = _handle

        def log_message(self, fmt, *args):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    state["url"] = f"http://127.0.0.1:{httpd.server_port}"
    yield state
    httpd.shutdown()


class TestRetries:
    def test_post_ok(self, server):
        assert rhttp.post(server["url"] + "/x", "hello") == "ok"
        (req,) = server["requests"]
        assert req["method"] == "POST" and req["body"] == "hello"
        assert req["headers"]["Content-Type"] == "text/plain;charset=utf-8"

    def test_5xx_retried_then_succeeds(self, server, monkeypatch):
        monkeypatch.setattr(rhttp.time, "sleep", lambda s: None)
        server["codes"] = [500, 502]
        assert rhttp.put(server["url"] + "/x", "v") == "ok"
        assert len(server["requests"]) == 3

    def test_4xx_not_retried(self, server, monkeypatch):
        monkeypatch.setattr(rhttp.time, "sleep", lambda s: None)
        server["codes"] = [403]
        assert rhttp.post(server["url"] + "/x", "v") is None
        assert len(server["requests"]) == 1

    def test_connection_refused_swallowed(self, monkeypatch):
        # reference: HttpClient.java:95-98 — errors swallowed, null returned
        monkeypatch.setattr(rhttp.time, "sleep", lambda s: None)
        assert rhttp.post("http://127.0.0.1:9/x", "v") is None


class TestBackoffSchedule:
    """The retry schedule, driven by a fake clock (no real sleeping)."""

    def _sleeps(self, monkeypatch):
        slept = []
        monkeypatch.setattr(rhttp.time, "sleep", slept.append)
        return slept

    def test_exponential_schedule_on_5xx(self, server, monkeypatch):
        slept = self._sleeps(monkeypatch)
        server["codes"] = [500, 502, 500]
        assert rhttp.post(server["url"] + "/x", "v") is None
        # ATTEMPTS=3 -> two sleeps, doubling from BACKOFF_BASE_S
        assert slept == [rhttp.BACKOFF_BASE_S, rhttp.BACKOFF_BASE_S * 2]

    def test_backoff_is_capped(self):
        assert rhttp.retry_delay(50) == rhttp.BACKOFF_CAP_S
        assert rhttp.retry_delay(0) == rhttp.BACKOFF_BASE_S

    def test_429_honours_retry_after_seconds(self, server, monkeypatch):
        slept = self._sleeps(monkeypatch)
        server["codes"] = [429]
        server["headers"] = [{"Retry-After": "7"}]
        assert rhttp.post(server["url"] + "/x", "v") == "ok"
        assert slept == [7.0]

    def test_503_honours_retry_after(self, server, monkeypatch):
        slept = self._sleeps(monkeypatch)
        server["codes"] = [503]
        server["headers"] = [{"Retry-After": "2"}]
        assert rhttp.post(server["url"] + "/x", "v") == "ok"
        assert slept == [2.0]

    def test_retry_after_capped(self, server, monkeypatch):
        slept = self._sleeps(monkeypatch)
        server["codes"] = [429]
        server["headers"] = [{"Retry-After": "86400"}]
        assert rhttp.post(server["url"] + "/x", "v") == "ok"
        assert slept == [rhttp.RETRY_AFTER_CAP_S]

    def test_429_without_header_backs_off_exponentially(self, server,
                                                        monkeypatch):
        slept = self._sleeps(monkeypatch)
        server["codes"] = [429, 429]
        assert rhttp.post(server["url"] + "/x", "v") == "ok"
        assert slept == [rhttp.BACKOFF_BASE_S, rhttp.BACKOFF_BASE_S * 2]

    def test_parse_retry_after_http_date(self):
        # an HTTP-date is relative to the (injected) clock
        now = 1700000000.0
        date = rhttp.email.utils.formatdate(now + 42, usegmt=True)
        got = rhttp.parse_retry_after(date, now=now)
        assert got == pytest.approx(42.0, abs=1.0)

    def test_parse_retry_after_past_date_clamps_to_zero(self):
        now = 1700000000.0
        date = rhttp.email.utils.formatdate(now - 500, usegmt=True)
        assert rhttp.parse_retry_after(date, now=now) == 0.0

    def test_parse_retry_after_garbage_is_none(self):
        assert rhttp.parse_retry_after(None) is None
        assert rhttp.parse_retry_after("soon") is None


class TestAwsSigning:
    def test_signature_is_hmac_sha1_base64(self):
        expected = base64.b64encode(
            hmac.new(b"secret", b"sign me", hashlib.sha1).digest()).decode()
        assert rhttp.aws_signature("sign me", "secret") == expected
        assert rhttp.aws_signature("PUT\n\nx", "k") == \
            jax_http.aws_signature("PUT\n\nx", "k")

    def test_aws_put_canonical_headers(self, monkeypatch):
        # reference: HttpClient.java:44-58 — resource is /bucket/<key>,
        # string-to-sign is PUT\n\n{type}\n{date}\n{resource}
        captured = {}
        ref = {}

        def fake_put(url, body, content_type=None, headers=None):
            captured.update(url=url, body=body, headers=headers)
            return "ok"

        monkeypatch.setattr(rhttp, "put", fake_put)
        monkeypatch.setattr(jax_http, "put", lambda url, body, content_type
                            =None, headers=None: ref.update(
                                url=url, body=body, headers=headers) or "ok")
        jax_http.aws_put("https://speeds.s3.amazonaws.com", "t/1/2/tile.csv",
                         "payload", "AKID", "secret",
                         date="Tue, 27 Mar 2007 21:15:45 +0000")
        date = "Tue, 27 Mar 2007 21:15:45 +0000"
        assert rhttp.aws_put("https://speeds.s3.amazonaws.com",
                             "t/1/2/tile.csv", "payload",
                             "AKID", "secret", date=date) == "ok"
        assert captured["url"] == \
            "https://speeds.s3.amazonaws.com/t/1/2/tile.csv"
        assert captured["headers"]["Host"] == "speeds.s3.amazonaws.com"
        assert captured["headers"]["Date"] == date
        sign_me = ("PUT\n\ntext/plain;charset=utf-8\n" + date
                   + "\n/speeds/t/1/2/tile.csv")
        assert captured["headers"]["Authorization"] == \
            "AWS AKID:" + rhttp.aws_signature(sign_me, "secret")
        assert captured == ref

    def test_aws_put_with_key_prefix(self, monkeypatch):
        # a path on the bucket URL is a key prefix, not part of the host
        captured = {}

        def fake_put(url, body, content_type=None, headers=None):
            captured.update(url=url, headers=headers)
            return "ok"

        monkeypatch.setattr(rhttp, "put", fake_put)
        date = "Tue, 27 Mar 2007 21:15:45 +0000"
        rhttp.aws_put("https://speeds.s3.amazonaws.com/manila/v1",
                      "tile.csv", "p", "AKID", "secret", date=date)
        assert captured["url"] == \
            "https://speeds.s3.amazonaws.com/manila/v1/tile.csv"
        assert captured["headers"]["Host"] == "speeds.s3.amazonaws.com"
        sign_me = ("PUT\n\ntext/plain;charset=utf-8\n" + date
                   + "\n/speeds/manila/v1/tile.csv")
        assert captured["headers"]["Authorization"] == \
            "AWS AKID:" + rhttp.aws_signature(sign_me, "secret")


class TestEgressTile:
    def test_plain_http_routes_to_post(self, server):
        assert rhttp.egress_tile(server["url"], "1_2/0/3/src.abc", "csv")
        (req,) = server["requests"]
        assert req["method"] == "POST"
        assert req["path"] == "/1_2/0/3/src.abc"

    def test_aws_host_routes_to_signed_put(self, monkeypatch):
        calls = {}
        monkeypatch.setattr(
            rhttp, "aws_put",
            lambda url, key, body, a, s, **kw: calls.update(
                url=url, key=key, creds=(a, s)) or "ok")
        assert rhttp.egress_tile("https://b.s3.amazonaws.com", "k/t.csv", "p",
                                 credentials=("AKID", "sec"))
        assert calls == {"url": "https://b.s3.amazonaws.com",
                         "key": "k/t.csv", "creds": ("AKID", "sec")}

    def test_aws_host_without_creds_fails_closed(self, monkeypatch):
        # the environment's keys are never read: without credentials=
        # (and without boto3) a bucket egress fails closed
        monkeypatch.setenv("AWS_ACCESS_KEY_ID", "AKID")
        monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "sec")
        called = []
        monkeypatch.setattr(rhttp, "aws_put",
                            lambda *a, **kw: called.append(a) or "ok")
        assert not rhttp.egress_tile("https://b.s3.amazonaws.com", "k", "p")
        assert not rhttp.egress_tile("https://b.s3.amazonaws.com", "k", "p",
                                     credentials=("AKID", ""))
        assert called == []

    def test_aws_host_matching(self):
        assert rhttp.is_aws_host("https://b.s3.amazonaws.com")
        assert rhttp.is_aws_host("https://b.s3.amazonaws.com:443/prefix")
        assert not rhttp.is_aws_host("https://my-amazonaws.com")
        assert not rhttp.is_aws_host("http://127.0.0.1:8080")

    def test_tile_sink_http_uses_egress(self, server):
        from reporter_tpu_torch.streaming.anonymiser import TileSink
        sink = TileSink(server["url"])
        assert sink.store("1_2/0/3", "src.abc", "csv,data") is True
        (req,) = server["requests"]
        assert req["method"] == "POST"
        assert req["path"] == "/1_2/0/3/src.abc"
        assert req["body"] == "csv,data"

    def test_tile_sink_passes_its_credentials(self, monkeypatch, tmp_path):
        from reporter_tpu_torch.streaming.anonymiser import TileSink
        calls = []
        monkeypatch.setattr(rhttp, "aws_put",
                            lambda url, key, body, a, s, **kw:
                            calls.append((key, a, s)) or "ok")
        sink = TileSink("https://b.s3.amazonaws.com/p",
                        deadletter=str(tmp_path / "dl"),
                        credentials=("AK", "SK"))
        assert sink.store("1_2/0/3", "src.e00000000", "csv") is True
        assert calls == [("1_2/0/3/src.e00000000", "AK", "SK")]
        # without credentials the tile fails closed into the spool
        sink = TileSink("https://b.s3.amazonaws.com/p",
                        deadletter=str(tmp_path / "dl"))
        assert sink.store("1_2/0/3", "src.e00000001", "csv") is False
        assert (tmp_path / "dl" / "1_2" / "0" / "3"
                / "src.e00000001").read_text() == "csv"
