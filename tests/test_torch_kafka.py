"""The port's stream transport (``reporter_tpu_torch/streaming/broker.py``)
against an in-process fake ``kafka`` module, as the JAX package's
``tests/test_kafka.py`` does (no client is installed): producer keying
and serialization, consumer decode, per-uuid order across partitions,
the clean refusal without a client, and the worker reading its raw
topic through ``--bootstrap``. Each case runs both packages' brokers on
the same messages. The JAX package's uuid-filter composition cases wait
for the port's multi-host layer.
"""
import sys
import types

import pytest

from reporter_tpu.streaming import broker as jax_broker
from reporter_tpu_torch.streaming import broker as broker_mod


@pytest.fixture(autouse=True)
def _worker_globals():
    """A worker registers its spool roots and flight-recorder directory
    process-wide (both packages'); every test leaves them unregistered."""
    yield
    from reporter_tpu.obs import flightrec as jax_flightrec
    from reporter_tpu.utils import spool as jax_spool
    from reporter_tpu_torch.obs import flightrec
    from reporter_tpu_torch.utils import spool
    for mod in (spool, jax_spool):
        mod.set_tile_dir(None)
        mod.set_trace_dir(None)
    for mod in (flightrec, jax_flightrec):
        mod.set_dump_dir(None)


class _FakeCluster:
    """Shared topic -> partitions -> messages store with group assignment."""

    def __init__(self, n_partitions=4):
        self.n_partitions = n_partitions
        self.topics = {}

    def partitions(self, topic):
        return self.topics.setdefault(
            topic, [[] for _ in range(self.n_partitions)])

    def publish(self, topic, key: bytes, value: bytes):
        part = (hash(key) if key else 0) % self.n_partitions
        self.partitions(topic)[part].append((key, value))


class _Msg:
    __slots__ = ("key", "value")

    def __init__(self, key, value):
        self.key = key
        self.value = value


def _install_fake_kafka(monkeypatch, cluster):
    groups = {}  # (group, topic) -> next member index

    class FakeProducer:
        def __init__(self, bootstrap_servers=None, key_serializer=None,
                     value_serializer=None):
            self.key_serializer = key_serializer or (lambda k: k)
            self.value_serializer = value_serializer or (lambda v: v)

        def send(self, topic, key=None, value=None):
            cluster.publish(topic, self.key_serializer(key),
                            self.value_serializer(value))

    class FakeConsumer:
        """Static round-robin partition assignment per (group, topic):
        member M of N gets partitions p where p % N == M. N is fixed at
        2 for the tests (set via cluster.group_size)."""

        def __init__(self, topic, bootstrap_servers=None, group_id=None):
            n_members = getattr(cluster, "group_size", 1)
            member = groups.setdefault((group_id, topic), 0)
            groups[(group_id, topic)] = member + 1
            parts = cluster.partitions(topic)
            self._msgs = []
            for p in range(len(parts)):
                if p % n_members == member % n_members:
                    self._msgs.extend(_Msg(k, v) for k, v in parts[p])

        def __iter__(self):
            return iter(self._msgs)

    fake = types.ModuleType("kafka")
    fake.KafkaProducer = FakeProducer
    fake.KafkaConsumer = FakeConsumer
    monkeypatch.setitem(sys.modules, "kafka", fake)
    return fake


@pytest.mark.parametrize("mod", [jax_broker, broker_mod])
def test_broker_produce_consume_roundtrip(monkeypatch, mod):
    cluster = _FakeCluster()
    _install_fake_kafka(monkeypatch, cluster)
    b = mod.KafkaBroker("fake:9092")
    b.produce("raw", "veh-1", b"hello")
    b.produce("raw", "veh-1", b"world")
    got = list(b.consume("raw"))
    assert got == [("veh-1", b"hello"), ("veh-1", b"world")]
    assert mod.kafka_available()


@pytest.mark.parametrize("mod", [jax_broker, broker_mod])
def test_broker_preserves_per_uuid_order_across_partitions(monkeypatch,
                                                           mod):
    cluster = _FakeCluster(n_partitions=4)
    _install_fake_kafka(monkeypatch, cluster)
    b = mod.KafkaBroker("fake:9092")
    uuids = [f"veh-{i}" for i in range(8)]
    for seq in range(5):
        for u in uuids:
            b.produce("raw", u, f"{u}:{seq}".encode())
    # same key -> same partition, so per-uuid sequence order survives
    seen = {}
    for key, value in b.consume("raw"):
        seq = int(value.decode().split(":")[1])
        assert seq == seen.get(key, -1) + 1, f"{key} out of order"
        seen[key] = seq
    assert set(seen) == set(uuids) and all(v == 4 for v in seen.values())


def test_kafka_unavailable_raises_cleanly(monkeypatch):
    monkeypatch.setitem(sys.modules, "kafka", None)
    assert not broker_mod.kafka_available()
    with pytest.raises(RuntimeError, match="kafka-python is not installed"):
        broker_mod.KafkaBroker("fake:9092")


def test_in_memory_broker_equals_the_jax_packages():
    got = []
    for mod in (jax_broker, broker_mod):
        b = mod.InMemoryBroker()
        for i in range(5):
            b.produce("raw", f"veh-{i % 2}", f"m{i}".encode())
        b.produce("segments", "1 2", b"s")
        got.append((list(b.consume("raw", timeout=0.01)),
                    list(b.consume("segments", timeout=0.01)),
                    list(b.consume("raw", timeout=0.01))))
    assert got[0] == got[1]
    assert got[1][0][0] == ("veh-0", b"m0") and got[1][2] == []


def test_worker_reads_its_raw_topic_through_bootstrap(monkeypatch,
                                                      tmp_path):
    """Probes published to the fake cluster's ``raw`` topic, keyed by
    uuid, through ``main --bootstrap`` on the CPU: the same tiles as
    the same probes replayed from a file."""
    from reporter_tpu_torch.streaming import worker
    from reporter_tpu_torch.synth import build_grid_city, generate_trace
    import numpy as np
    city = build_grid_city(rows=8, cols=8, spacing_m=200.0, seed=3)
    graph = str(tmp_path / "city.npz")
    city.save(graph)
    rng = np.random.default_rng(5)
    lines = []
    for i in range(3):
        tr = None
        while tr is None:
            tr = generate_trace(city, f"veh-{i}", rng, noise_m=3.0,
                                sample_period_s=5.0, min_route_edges=8,
                                start_time=1_500_000_000 + 7 * i)
        lines += [f"{tr.uuid}|{p['lat']}|{p['lon']}|{p['time']}|5"
                  for p in tr.points]
    # one partition: the topic's order is the file's
    cluster = _FakeCluster(n_partitions=1)
    _install_fake_kafka(monkeypatch, cluster)
    producer = broker_mod.KafkaBroker("fake:9092")
    for line in lines:
        producer.produce("raw", line.split("|")[0], line.encode())
    stream = tmp_path / "stream.txt"
    stream.write_text("\n".join(lines) + "\n")
    common = ["-f", r",sv,\|,0,1,2,3,4", "--graph", graph, "-p", "1",
              "-q", "3600", "-i", "1000000000", "-s", "k", "-r", "0,1,2",
              "-x", "0,1,2", "--device", "cpu",
              "--report-flush-interval", "0"]
    trees = []
    for name, source in (("file", ["--input", str(stream)]),
                         ("kafka", ["-b", "fake:9092", "-t", "raw,out"])):
        out = tmp_path / name
        assert worker.main(common + ["-o", str(out)] + source) == 0
        trees.append({str(p.relative_to(out)): p.read_bytes()
                      for p in out.rglob("*") if p.is_file()
                      and ".deadletter" not in p.parts})
    assert trees[0] == trees[1] and trees[0]
