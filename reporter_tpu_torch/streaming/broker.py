"""Stream transport adapters (the port of ``reporter_tpu/streaming/broker.py``).

The reference's backbone is Kafka topics between processors
(reference: Reporter.java:156-181). Here the topology runs in one process
with an in-memory broker by default (every stage co-located with the
device), while a Kafka adapter (gated on the client library being
installed) preserves the reference's deployment shape: ``raw`` in,
formatted/segment topics through, for multi-worker scale-out partitioned
by uuid so per-uuid point order is preserved (reference: tests/circle.sh:58,
README "Kafka stream configuration").
"""
from __future__ import annotations

import queue
from typing import Iterator, Optional


class InMemoryBroker:
    """Topic -> queue map; single-process stand-in for Kafka."""

    def __init__(self):
        self.topics: dict[str, queue.Queue] = {}

    def topic(self, name: str) -> queue.Queue:
        return self.topics.setdefault(name, queue.Queue())

    def produce(self, topic: str, key, value) -> None:
        self.topic(topic).put((key, value))

    def consume(self, topic: str, timeout: Optional[float] = None
                ) -> Iterator[tuple]:
        q = self.topic(topic)
        while True:
            try:
                yield q.get(timeout=timeout)
            except queue.Empty:
                return


def kafka_available() -> bool:
    try:
        import kafka  # noqa: F401
        return True
    except ImportError:
        return False


class KafkaBroker:
    """Thin wrapper over kafka-python, keyed by uuid so partition order
    matches the reference's requirement. Only constructible when the
    client library is installed."""

    def __init__(self, bootstrap: str):
        if not kafka_available():
            raise RuntimeError(
                "kafka-python is not installed in this environment; "
                "use InMemoryBroker or install the client")
        from kafka import KafkaConsumer, KafkaProducer  # type: ignore
        self._producer_cls = KafkaProducer
        self._consumer_cls = KafkaConsumer
        self.bootstrap = bootstrap
        self._producer = None

    def producer(self):
        if self._producer is None:
            self._producer = self._producer_cls(
                bootstrap_servers=self.bootstrap,
                key_serializer=lambda k: k.encode() if k else None,
                value_serializer=lambda v: v)
        return self._producer

    def produce(self, topic: str, key: str, value: bytes) -> None:
        self.producer().send(topic, key=key, value=value)

    def consume(self, topic: str, group: str = "reporter"):
        consumer = self._consumer_cls(
            topic, bootstrap_servers=self.bootstrap, group_id=group)
        for msg in consumer:
            yield msg.key.decode() if msg.key else None, msg.value
