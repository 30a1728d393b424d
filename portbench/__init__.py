"""The benchmark of reporter_tpu_torch: ``python3 -m portbench --workload
<cell> --seed <n> --seconds <s> --trace <0|1>`` (see README.md)."""
