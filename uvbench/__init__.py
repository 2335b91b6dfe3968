"""The benchmark of ``ultravox_torch`` on an NVIDIA H100.

``python3 uvbench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` from the root of a checkout runs one cell of ``BENCHMARK.json`` and
prints one JSON result line. Everything that belongs to one cell, model
configuration, traffic mix or metric is a file of its own under this
folder, found by the name ``BENCHMARK.json`` gives it:

- ``workloads/<cell>.json``: the entry that drives the program and its
  settings (engine options, batch, the correctness sample);
- ``configs/<config>.json``: the model's published sizes, what was cut and
  what was assumed;
- ``traffic/<mix>.json``: the parameters of a traffic mix, read by the
  one general generator (``traffic.py``);
- ``metrics/<metric>.py``: one reader per metric, ``read(run)`` returning a
  number or None;
- ``entries/<entry>.py``: the code that runs the program (``serve``).

The yardstick lives here too: the plain float32 reference under
``reference/`` (it imports nothing of the program), the operation and byte
counts (``work.py``), the table of peaks (``peaks.py``) and the reduction
of a profiler trace (``trace.py``).
"""
