"""portbench: the benchmark of ``voltools_tpu_torch`` on an NVIDIA H100.

One command runs one cell once (``python3 portbench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>``).  Everything a cell is
made of is data found by name: ``configs/<config>.json`` (the deployment),
``traffic/<traffic>.json`` (the call stream and the driver that issues it),
``cells/<cell>.json`` (the limits of the correctness comparison),
``drivers/<driver>.py`` (one per kind of call loop) and
``metrics/<metric>.py`` (one reader per metric).  ``reference/`` is the
plain reference that decides ``correct``; ``roofline/`` the least work of
each function at the published peaks.  Nothing here imports JAX or the JAX
package; the reference imports nothing of the port.
"""
