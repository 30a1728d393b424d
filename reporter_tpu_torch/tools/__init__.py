"""Operational CLIs: replay producer, debug consumer, tile tooling, the
synthetic-trace generator, the accuracy gate and the datastore CLI.

The port of ``reporter_tpu/tools/`` (the reference's ops scripts
py/cat_to_kafka.py, py/make_requests.sh, py/get_tiles.py +
py/download_tiles.sh, PrintConsumer.java), run as commands of
``python -m reporter_tpu_torch``.
"""
