"""portbench: the end-to-end benchmark of rtwc_tpu_torch on one CUDA card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own (configs/, traffic/, metrics/), found by
the names in BENCHMARK.json; drivers/ holds one module a traffic kind and
readers/ one module a kind of per-layer reading. reference/ is the plain
PyTorch / NumPy reference that decides `correct`; it imports nothing of
the port.
"""
