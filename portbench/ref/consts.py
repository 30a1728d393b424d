"""The decode's constants, as the port states them
(``reporter_tpu_torch/matcher/hmm.py``, ``matcher/matcher.py``)."""

NEG_INF = -1.0e30
NORMAL, RESTART, SKIP = 0, 1, 2
#: route distances at or above this are "no route within the bound"
UNREACHABLE_THRESHOLD = 0.5e9
#: the largest finite distance the float16 wire carries
WIRE_MAX_M = 4.096e3
#: the padding buckets of the decode (``matcher/batchpad.py``)
LENGTH_BUCKETS = (16, 64, 256, 1024)
#: the spatial index's cell (``matcher/matcher.py`` GRID_CELL_M)
GRID_CELL_M = 75.0
