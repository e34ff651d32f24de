"""The benchmark of ``video_super_resolution_tpu_torch`` on one H100.

    python3 -m vsr_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of the root ``BENCHMARK.json`` once and prints one JSON line.
Everything a cell needs is found by name: its configuration in
``configs/<config>.json`` (whose ``reference`` names the architecture's
plain reference, ``reference/<reference>.py``), its traffic in
``traffic/<traffic>.json`` (whose ``kind`` names the driver module
``kinds/<kind>.py``), the limits of its correctness check in
``limits/<cell>.json`` and each per-layer metric's reader in
``metrics/<metric>.py``. The yardstick (the plain reference in
``reference/``, the content generators, the trace reduction and the
roofline arithmetic) imports nothing of the port; only the kind modules
call the port's entry points.
"""
